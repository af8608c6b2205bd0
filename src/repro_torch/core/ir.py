"""The "affine dialect": loop trees with constant bounds + affine accesses.

Mirrors the paper's input language (C lowered through Polygeist into the MLIR
affine dialect with HLS pragmas preserved as attributes):

  * ``pipeline``       -> Loop.pipeline / Loop.ii (target initiation interval)
  * ``unroll``         -> Loop.unroll (complete unrolling, done by normalize())
  * ``bind_storage``   -> ArrayDecl.kind / ports
  * ``array_partition``-> ArrayDecl.partition (complete partitioning of dims)
  * ``interface``      -> ArrayDecl.is_arg + port latencies
  * ``bind_op``        -> Program.op_delays (external Verilog IP latencies)

The default op latencies are the paper's: fp add/sub 5 cycles, fp mul 4,
loads/stores 1 cycle (§3.1 / Fig. 3).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Optional, Union

# ---------------------------------------------------------------------------
# Affine expressions over loop induction variables
# ---------------------------------------------------------------------------


class AffExpr:
    """Affine expression: sum(coeff_i * iv_i) + const, integer coefficients."""

    __slots__ = ("coeffs", "const")

    def __init__(self, coeffs: Optional[dict[str, int]] = None, const: int = 0):
        self.coeffs = {k: int(v) for k, v in (coeffs or {}).items() if v != 0}
        self.const = int(const)

    # -- algebra ----------------------------------------------------------
    def __add__(self, other) -> "AffExpr":
        other = aff(other)
        co = dict(self.coeffs)
        for k, v in other.coeffs.items():
            co[k] = co.get(k, 0) + v
        return AffExpr(co, self.const + other.const)

    __radd__ = __add__

    def __sub__(self, other) -> "AffExpr":
        return self + aff(other) * (-1)

    def __rsub__(self, other) -> "AffExpr":
        return aff(other) + self * (-1)

    def __mul__(self, k: int) -> "AffExpr":
        k = int(k)
        return AffExpr({n: c * k for n, c in self.coeffs.items()}, self.const * k)

    __rmul__ = __mul__

    # -- utilities ---------------------------------------------------------
    def subst(self, name: str, value: Union[int, "AffExpr"]) -> "AffExpr":
        if name not in self.coeffs:
            return self
        co = dict(self.coeffs)
        c = co.pop(name)
        return AffExpr(co, self.const) + aff(value) * c

    def is_const(self) -> bool:
        return not self.coeffs

    def __eq__(self, other):
        if not isinstance(other, AffExpr):
            return NotImplemented
        return self.coeffs == other.coeffs and self.const == other.const

    def __hash__(self):
        return hash((tuple(sorted(self.coeffs.items())), self.const))

    def __repr__(self):
        parts = [f"{c}*{n}" if c != 1 else n for n, c in sorted(self.coeffs.items())]
        if self.const or not parts:
            parts.append(str(self.const))
        return "+".join(parts).replace("+-", "-")

    def eval(self, env: dict[str, int]) -> int:
        return self.const + sum(c * env[n] for n, c in self.coeffs.items())

    def interval(self, bounds: dict[str, tuple[int, int]]) -> tuple[int, int]:
        """Tight [lo, hi] range of the expression when each variable ranges
        over the inclusive interval ``bounds[name]`` — exact for affine
        expressions over independent variables.  Raises ``KeyError`` for a
        variable with no bound (callers report it as an unbound iv)."""
        lo = hi = self.const
        for n, c in self.coeffs.items():
            a, b = bounds[n]
            lo += c * (a if c > 0 else b)
            hi += c * (b if c > 0 else a)
        return lo, hi


def aff(x: Union[int, str, AffExpr]) -> AffExpr:
    if isinstance(x, AffExpr):
        return x
    if isinstance(x, str):
        return AffExpr({x: 1}, 0)
    return AffExpr({}, int(x))


def iv(name: str) -> AffExpr:
    return AffExpr({name: 1}, 0)


# ---------------------------------------------------------------------------
# Arrays (bind_storage / array_partition / interface pragmas)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ArrayDecl:
    name: str
    shape: tuple[int, ...]
    # "bram": block RAM.  "reg": registers / fully-partitioned LUT RAM
    # (no port conflicts).
    kind: str = "bram"
    # port kinds, e.g. ("w", "r") = simple dual port; ("rw", "rw") = true dual
    # port; more entries model replicated BRAMs (costed in the resource model).
    ports: tuple[str, ...] = ("w", "r")
    partition: tuple[int, ...] = ()  # dims completely partitioned (banking)
    rd_latency: int = 1
    wr_latency: int = 1
    is_arg: bool = False  # function argument (Vitis dataflow cannot touch these)
    elem_bits: int = 32

    def num_elems(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def read_ports(self) -> list[int]:
        return [i for i, p in enumerate(self.ports) if "r" in p]

    def write_ports(self) -> list[int]:
        return [i for i, p in enumerate(self.ports) if "w" in p]


# ---------------------------------------------------------------------------
# Ops and loops
# ---------------------------------------------------------------------------

_uid = itertools.count()


@dataclass
class Op:
    result: Optional[str] = None
    uid: int = field(default_factory=lambda: next(_uid))


@dataclass
class ConstOp(Op):
    value: float = 0.0


@dataclass
class LoadOp(Op):
    array: str = ""
    index: tuple[AffExpr, ...] = ()
    port: int = -1  # assigned by scheduler


@dataclass
class StoreOp(Op):
    array: str = ""
    index: tuple[AffExpr, ...] = ()
    value: str = ""  # ssa name
    port: int = -1


@dataclass
class ArithOp(Op):
    fn: str = "add"  # add|sub|mul|div|... (latency from Program.op_delays)
    args: tuple[str, ...] = ()


@dataclass
class Loop:
    ivname: str = ""
    lb: int = 0
    ub: int = 0  # exclusive
    body: list = field(default_factory=list)
    pipeline: bool = True
    ii: Optional[int] = None  # target II (pragma); None -> autotuned
    unroll: bool = False
    # Top-level nests emitted by one shift-and-peel fusion share a group id:
    # the peel nests are the SAME guarded datapath as the fused core (the IR
    # just lacks conditionals), so the resource model costs the group once.
    fuse_group: Optional[int] = None
    # True for prologue/epilogue loops peeled off a shifted fusion — their
    # ops replicate (a subrange of) the fused core's and run on its datapath.
    peel: bool = False
    # Set by LoopTile on the OUTER loop of a strip pair: the inner block
    # size.  Marks the nest as explicitly tiled, which is what lets the
    # resource model cost nest-local intermediates at their tile-window
    # footprint (a streamed line buffer) instead of the full array.
    tile_block: Optional[int] = None
    uid: int = field(default_factory=lambda: next(_uid))

    @property
    def trip(self) -> int:
        return self.ub - self.lb

    def sub_loops(self) -> list["Loop"]:
        return [it for it in self.body if isinstance(it, Loop)]

    def body_ops(self) -> list:
        return [it for it in self.body if not isinstance(it, Loop)]


# The paper's latency model (Fig. 3 / §3.1, Xilinx FP IP via bind_op).
# "exp" is not in the paper's benchmark set; 12 cycles matches the deep
# iterative fp units (div) of the same IP family — the tracing frontend
# emits it for softmax / decay math.
DEFAULT_OP_DELAYS = {
    "add": 5,
    "sub": 5,
    "mul": 4,
    "div": 12,
    "min": 1,
    "max": 1,
    "cmp": 1,
    "exp": 12,
    "const": 0,
}


@dataclass
class Program:
    name: str
    arrays: dict[str, ArrayDecl] = field(default_factory=dict)
    body: list = field(default_factory=list)  # list[Loop|Op]
    op_delays: dict[str, int] = field(default_factory=lambda: dict(DEFAULT_OP_DELAYS))

    # -- traversal helpers --------------------------------------------------
    def walk(self):
        """Yield (node, ancestors) where ancestors is the list of enclosing
        Loops outermost-first, for every op/loop in program order."""

        def rec(items, anc):
            for it in items:
                yield it, list(anc)
                if isinstance(it, Loop):
                    yield from rec(it.body, anc + [it])

        yield from rec(self.body, [])

    def loops(self):
        return [n for n, _ in self.walk() if isinstance(n, Loop)]

    def mem_ops(self):
        return [(n, a) for n, a in self.walk() if isinstance(n, (LoadOp, StoreOp))]

    def op_latency(self, op) -> int:
        if isinstance(op, LoadOp):
            return self.arrays[op.array].rd_latency
        if isinstance(op, StoreOp):
            return self.arrays[op.array].wr_latency
        if isinstance(op, ArithOp):
            return self.op_delays[op.fn]
        if isinstance(op, ConstOp):
            return 0
        if isinstance(op, Loop):
            return 0
        raise TypeError(op)


# ---------------------------------------------------------------------------
# Builder (the "C frontend": gives benchmarks a compact construction API)
# ---------------------------------------------------------------------------


class ProgramBuilder:
    def __init__(self, name: str, op_delays: Optional[dict[str, int]] = None):
        self.program = Program(name)
        if op_delays:
            self.program.op_delays.update(op_delays)
        self._stack: list[list] = [self.program.body]
        self._ssa = itertools.count()

    # arrays ---------------------------------------------------------------
    def array(self, name: str, shape: tuple[int, ...], **kw) -> str:
        self.program.arrays[name] = ArrayDecl(name=name, shape=tuple(shape), **kw)
        return name

    # scoping ---------------------------------------------------------------
    class _LoopCtx:
        def __init__(self, builder, loop):
            self.builder = builder
            self.loop = loop

        def __enter__(self):
            self.builder._stack.append(self.loop.body)
            return iv(self.loop.ivname)

        def __exit__(self, *a):
            self.builder._stack.pop()

    def loop(self, ivname: str, lb: int, ub: int, *, pipeline: bool = True,
             ii: Optional[int] = None, unroll: bool = False):
        lp = Loop(ivname=ivname, lb=lb, ub=ub, pipeline=pipeline, ii=ii,
                  unroll=unroll)
        self._stack[-1].append(lp)
        return self._LoopCtx(self, lp)

    # ops --------------------------------------------------------------------
    def _name(self, prefix="v"):
        return f"%{prefix}{next(self._ssa)}"

    def const(self, value: float) -> str:
        op = ConstOp(result=self._name("c"), value=float(value))
        self._stack[-1].append(op)
        return op.result

    def load(self, array: str, *index) -> str:
        idx = tuple(aff(i) for i in index)
        op = LoadOp(result=self._name("ld"), array=array, index=idx)
        self._stack[-1].append(op)
        return op.result

    def store(self, array: str, value: str, *index) -> None:
        idx = tuple(aff(i) for i in index)
        self._stack[-1].append(StoreOp(array=array, index=idx, value=value))

    def arith(self, fn: str, *args: str) -> str:
        op = ArithOp(result=self._name(fn[0]), fn=fn, args=tuple(args))
        self._stack[-1].append(op)
        return op.result

    def add(self, a, b):
        return self.arith("add", a, b)

    def sub(self, a, b):
        return self.arith("sub", a, b)

    def mul(self, a, b):
        return self.arith("mul", a, b)

    def div(self, a, b):
        return self.arith("div", a, b)

    def sum_tree(self, vals: list[str]) -> str:
        """Balanced adder tree (shorter critical path than a chain)."""
        vals = list(vals)
        while len(vals) > 1:
            nxt = []
            for i in range(0, len(vals) - 1, 2):
                nxt.append(self.add(vals[i], vals[i + 1]))
            if len(vals) % 2:
                nxt.append(vals[-1])
            vals = nxt
        return vals[0]

    def build(self) -> Program:
        return normalize(self.program)


# ---------------------------------------------------------------------------
# Normalization: complete unrolling (the paper's only supported unroll mode)
# ---------------------------------------------------------------------------


def _clone_item(item, env: dict[str, int], ssa_map: dict[str, str], fresh):
    """Deep-copy an op/loop substituting unrolled ivs and renaming SSA."""
    if isinstance(item, Loop):
        new = Loop(ivname=item.ivname, lb=item.lb, ub=item.ub,
                   pipeline=item.pipeline, ii=item.ii, unroll=item.unroll)
        new.body = [_clone_item(ch, env, ssa_map, fresh) for ch in item.body]
        return new
    if isinstance(item, ConstOp):
        r = fresh(item.result)
        ssa_map[item.result] = r
        return ConstOp(result=r, value=item.value)
    if isinstance(item, LoadOp):
        r = fresh(item.result)
        ssa_map[item.result] = r
        idx = tuple(_subst_env(e, env) for e in item.index)
        return LoadOp(result=r, array=item.array, index=idx)
    if isinstance(item, StoreOp):
        idx = tuple(_subst_env(e, env) for e in item.index)
        return StoreOp(array=item.array, index=idx,
                       value=ssa_map.get(item.value, item.value))
    if isinstance(item, ArithOp):
        r = fresh(item.result)
        ssa_map[item.result] = r
        return ArithOp(result=r, fn=item.fn,
                       args=tuple(ssa_map.get(a, a) for a in item.args))
    raise TypeError(item)


def _subst_env(e: AffExpr, env: dict[str, int]) -> AffExpr:
    for k, v in env.items():
        e = e.subst(k, v)
    return e


def normalize(p: Program) -> Program:
    """Expand all ``unroll`` loops; returns the same Program mutated."""
    counter = itertools.count()

    def fresh(old: str) -> str:
        return f"{old}_u{next(counter)}"

    def expand(items):
        out = []
        for it in items:
            if isinstance(it, Loop):
                it.body = expand(it.body)
                if not it.unroll and it.lb != 0:
                    raise ValueError(
                        f"non-unrolled loop {it.ivname} must start at 0 "
                        "(normalize bounds in the frontend)")
                if it.unroll:
                    for val in range(it.lb, it.ub):
                        env = {it.ivname: val}
                        ssa_map: dict[str, str] = {}
                        for ch in it.body:
                            out.append(_clone_item(ch, env, ssa_map, fresh))
                else:
                    out.append(it)
            else:
                out.append(it)
        return out

    p.body = expand(p.body)
    return p


# ---------------------------------------------------------------------------
# Program-order keys (for happens-before)
# ---------------------------------------------------------------------------


def position_keys(p: Program) -> dict[int, tuple[int, ...]]:
    """Map op/loop uid -> tuple of child indices from the root ("syntactic
    position").  Lexicographic comparison of the suffixes after the common
    ancestor region gives static program order."""
    keys: dict[int, tuple[int, ...]] = {}

    def rec(items, prefix):
        for idx, it in enumerate(items):
            keys[it.uid] = prefix + (idx,)
            if isinstance(it, Loop):
                rec(it.body, prefix + (idx,))

    rec(p.body, ())
    return keys


# ---------------------------------------------------------------------------
# The loop-nest contract: one classifier, consulted by every layer
# ---------------------------------------------------------------------------
#
# Historically each layer re-derived (and silently assumed) the program's
# nest structure: dataflow rejected multi-chain tasks in `_access_sequence`,
# transforms returned None from `_perfect_chain`, codegen hand-rolled its own
# depth/reduction checks.  `nest_shape` is now the single source of truth:
# it names every shape the IR can express — perfect nests, imperfect nests
# (ops alongside a sub-loop), multi-loop tasks (sequential sub-loops under
# one task), reduction carries (arrays a task both reads and writes) — and
# downstream layers decide what they support in terms of this vocabulary.

#: TaskShape.kind values, from most to least restrictive.
TASK_KINDS = ("perfect", "imperfect", "multi_loop", "ops")


@dataclass(frozen=True)
class TaskShape:
    """Structural classification of one top-level item (a "task")."""

    index: int                 # position in Program.body
    kind: str                  # one of TASK_KINDS
    depth: int                 # max loop depth under the task (0 for bare ops)
    #: every root->innermost loop chain, as loop-uid tuples in program order;
    #: a perfect nest has exactly one, sequential sub-loops contribute more.
    chains: tuple[tuple[int, ...], ...]
    #: uids of "loose" ops — ops whose enclosing body also holds a sub-loop
    #: (i.e. not in an innermost body); nonempty marks the nest imperfect.
    loose_ops: tuple[int, ...]
    #: arrays the task both loads and stores (reduction / recurrence carries).
    reductions: tuple[str, ...]

    @property
    def is_perfect(self) -> bool:
        return self.kind == "perfect"

    @property
    def multi_chain(self) -> bool:
        return len(self.chains) > 1


@dataclass(frozen=True)
class NestShape:
    """`nest_shape(p)` result: per-task shapes plus whole-program views."""

    tasks: tuple[TaskShape, ...]

    @property
    def kinds(self) -> tuple[str, ...]:
        return tuple(t.kind for t in self.tasks)

    @property
    def all_perfect(self) -> bool:
        return all(t.is_perfect for t in self.tasks)

    @property
    def max_depth(self) -> int:
        return max((t.depth for t in self.tasks), default=0)

    def task(self, index: int) -> TaskShape:
        return self.tasks[index]


def _classify_task(index: int, item) -> TaskShape:
    if not isinstance(item, Loop):
        return TaskShape(index=index, kind="ops", depth=0, chains=(),
                         loose_ops=(item.uid,), reductions=())
    chains: list[tuple[int, ...]] = []
    loose: list[int] = []
    loaded: set[str] = set()
    stored: set[str] = set()
    depth = 0

    def rec(loop: Loop, path: tuple[int, ...]):
        nonlocal depth
        path = path + (loop.uid,)
        depth = max(depth, len(path))
        subs = loop.sub_loops()
        ops = loop.body_ops()
        for op in ops:
            if isinstance(op, LoadOp):
                loaded.add(op.array)
            elif isinstance(op, StoreOp):
                stored.add(op.array)
            if subs:
                loose.append(op.uid)
        if not subs:
            chains.append(path)
        for sub in subs:
            rec(sub, path)

    rec(item, ())
    kind = ("multi_loop" if len(chains) > 1
            else "imperfect" if loose else "perfect")
    return TaskShape(index=index, kind=kind, depth=depth,
                     chains=tuple(chains), loose_ops=tuple(loose),
                     reductions=tuple(sorted(loaded & stored)))


def nest_shape(p: Program) -> NestShape:
    """Classify every top-level task of ``p`` (the loop-nest contract).

    This is the ONE place nest structure is derived; `dataflow`,
    `transforms`, `codegen` and the tracing frontend all consult it instead
    of re-deriving (or silently assuming) the shape locally.
    """
    return NestShape(tasks=tuple(_classify_task(i, it)
                                 for i, it in enumerate(p.body)))
