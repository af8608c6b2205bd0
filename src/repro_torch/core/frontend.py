"""PyTorch tracing frontend: build Program IR from PyTorch functions.

``trace(fn, *example_tensors)`` runs ``torch.fx.symbolic_trace`` on a
shape-specialized PyTorch function, runs the graph once on the examples
(``torch.fx.passes.shape_prop.ShapeProp``) for every node's shape, and
interprets the graph into the affine dialect: every tensor op becomes one
perfect loop nest storing a fresh intermediate array; pure layout ops
(broadcast, transpose/``.T``, ``unsqueeze``/``squeeze``, slicing and
indexing, reshapes that only insert or drop size-1 dims) become *views* —
affine re-indexings that never materialize — and :func:`scan` becomes a
recurrence loop whose carry lives in a time-indexed state array
(``C[t+1] = f(C[t], xs[t])``), so a traced scan is exactly the multi-loop
task shape ``ir.nest_shape`` reports as ``multi_loop``.

Reductions (``sum``/``amax``/``amin``, ``@``/``matmul`` contractions) are
unrolled into left-fold op chains — the element order ``sequential_exec``
uses — which keeps the differential check tight:
``TracedProgram.validate()`` runs the traced Program through
``sim.sequential_exec`` and the original function in float64 on the CPU on
the same inputs and compares at ``rtol=1e-12``.

The frontend is deliberately narrow: the supported op set is the one the
bundled programs need (wkv6 recurrence, separable conv block, softmax
attention).  Anything else raises the structured
:class:`errors.UntraceableFunction` naming the offending op, so callers
widen the function instead of string-matching a trace dump.  Constant
tensors a function builds (``torch.zeros(...)``) are lifted to the scalar
they hold; a constant with distinct elements is refused (pass it as an
argument).

The graphs are PyTorch's Python-level FX graphs (``operator.mul``,
``getitem``, ``call_method sum``), not the aten-level graphs of
``make_fx``/``torch.export``, whose decompositions change between PyTorch
versions.  The IR equals what the JAX package's frontend builds from the
same function written in JAX: same nests, arrays and iv names.
"""
from __future__ import annotations

import inspect
import itertools
import math
import operator
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.fx
from torch.fx.node import map_arg
from torch.fx.passes.shape_prop import ShapeProp

from .errors import UntraceableFunction
from .ir import AffExpr, Program, ProgramBuilder, aff

#: widest reduction/contraction the tracer will unroll into an op chain.
MAX_UNROLL = 256

# fx targets (functions for call_function, names for call_method) -> IR op
_ELT2 = {operator.add: "add", torch.add: "add", "add": "add",
         operator.sub: "sub", torch.sub: "sub", "sub": "sub",
         operator.mul: "mul", torch.mul: "mul", "mul": "mul",
         operator.truediv: "div", torch.div: "div", torch.true_divide: "div",
         "div": "div", "true_divide": "div",
         torch.maximum: "max", "maximum": "max",
         torch.minimum: "min", "minimum": "min"}
_ELT1 = {torch.exp: "exp", "exp": "exp",
         operator.neg: "neg", torch.neg: "neg", "neg": "neg"}
_POW = {operator.pow, torch.pow, "pow"}
_REDUCE = {torch.sum: "add", "sum": "add", torch.amax: "max", "amax": "max",
           torch.amin: "min", "amin": "min"}
_MATMUL = {operator.matmul, torch.matmul, "matmul", torch.mm, "mm"}
_IDENTITY = {"contiguous", "float", "double", "to", "type_as", "detach",
             torch.clone, "clone"}
_FILL = {torch.zeros: 0.0, torch.zeros_like: 0.0, "new_zeros": 0.0,
         torch.ones: 1.0, torch.ones_like: 1.0, "new_ones": 1.0}
_FULL = {torch.full: 1, torch.full_like: 1, "new_full": 2}  # value's arg
_INFO_ATTRS = {"dtype", "shape", "device", "ndim"}
_INFO_METHODS = {"size", "dim"}
_PYFOLD = {"add": lambda a, b: a + b, "sub": lambda a, b: a - b,
           "mul": lambda a, b: a * b, "div": lambda a, b: a / b,
           "max": max, "min": min, "exp": math.exp, "neg": lambda a: -a}

# storage preset for every traced array (same dual-read BRAM banking the
# hand-built benchmarks use, so DSE moves see familiar resource tradeoffs)
_STORAGE = dict(kind="bram", ports=("w", "r", "r", "r"), partition=(0,))


class _Info:
    """A node's non-tensor value (``x.dtype``, ``x.shape``): it only feeds
    constant constructors, which the tracer lifts to scalars anyway."""


_INFO = _Info()


# ---------------------------------------------------------------------------
# scan: PyTorch's counterpart of lax.scan
# ---------------------------------------------------------------------------


def _leaves(x) -> list:
    return list(x) if isinstance(x, (tuple, list)) else [x]


def _proxy_cells(step: Callable) -> list:
    """The closure cells of ``step`` that hold traced values: they are the
    scan's constants (``lax.scan``'s ``num_consts``)."""
    return [c for c in (step.__closure__ or ())
            if isinstance(c.cell_contents, torch.fx.Proxy)]


def _bound(cells, values, fn, *args):
    """``fn(*args)`` with the closure ``cells`` bound to ``values``."""
    saved = [c.cell_contents for c in cells]
    try:
        for c, v in zip(cells, values):
            c.cell_contents = v
        return fn(*args)
    finally:
        for c, v in zip(cells, saved):
            c.cell_contents = v


def scan(step: Callable, init, xs):
    """``lax.scan`` for PyTorch: ``carry, y = step(carry, x)`` for each
    ``x`` along the leading dim of ``xs`` (a tensor or a tuple of tensors);
    returns ``(final carry, ys stacked along a new leading dim)``.

    Run eagerly, it is a plain loop.  Under ``torch.fx.symbolic_trace`` it
    is ONE graph node: ``torch.fx.wrap`` cannot carry ``step`` (a function
    is no FX argument), so ``scan`` builds its node itself, with ``step``
    kept on the node's target for :func:`trace`, which traces it once on
    per-step shapes into the recurrence loop.  Tensors ``step`` closes over
    become the node's constant arguments."""
    cells = _proxy_cells(step)
    consts = [c.cell_contents for c in cells]
    proxies = [v for v in _leaves(init) + _leaves(xs) + consts
               if isinstance(v, torch.fx.Proxy)]
    if proxies:
        def scan_op(init, xs, consts):
            # the node's eager run (ShapeProp, GraphModule calls): the
            # cells hold this trace's proxies, so rebind them to values
            return _bound(cells, consts, scan, step, init, xs)

        scan_op.__name__ = "scan"
        scan_op.step, scan_op.cells = step, cells
        out = proxies[0].tracer.create_proxy(
            "call_function", scan_op, (init, xs, tuple(consts)), {})
        return out[0], out[1]
    steps = _leaves(xs)
    carry, ys = init, []
    for t in range(steps[0].shape[0]):
        x = tuple(v[t] for v in steps) if isinstance(xs, (tuple, list)) \
            else xs[t]
        carry, y = step(carry, x)
        ys.append(y)
    if isinstance(ys[0], (tuple, list)):
        return carry, tuple(torch.stack(list(c)) for c in zip(*ys))
    return carry, torch.stack(ys)


# ---------------------------------------------------------------------------
# The tracer
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class _Val:
    """A traced tensor value: an IR array plus an affine view.

    ``spec`` has one entry per ARRAY dim: either an :class:`AffExpr`
    (context-fixed index — a scan iv, a constant) or ``(dim, coef, const)``
    mapping the value's logical ``dim`` onto the array dim as
    ``coef * iv + const``.  Layout ops only rewrite ``spec``."""

    array: str
    shape: tuple  # logical shape (may be () for scalars)
    spec: tuple


def _shape_of(node) -> tuple:
    tm = node.meta.get("tensor_meta") if isinstance(node, torch.fx.Node) \
        else None
    return tuple(int(s) for s in tm.shape) if tm is not None else ()


def _op_name(node) -> str:
    t = node.target
    return t if isinstance(t, str) else getattr(t, "__name__", str(t))


class _Tracer:
    def __init__(self, name: str):
        self.b = ProgramBuilder(name)
        self._ivn = itertools.count()
        self._arrn = itertools.count()
        # open scan context: list of (time AffExpr, extent)
        self.prefix: list = []
        self.fn_name = name

    # -- plumbing -----------------------------------------------------------
    def _die(self, op: str, detail: str = ""):
        raise UntraceableFunction(self.fn_name, op, detail)

    def _iv(self, stem: str = "i") -> str:
        return f"{stem}{next(self._ivn)}"

    def _new_array(self, full_shape, is_arg=False, name=None) -> str:
        name = name if name is not None else f"t{next(self._arrn)}"
        self.b.array(name, tuple(int(x) for x in full_shape),
                     is_arg=is_arg, **_STORAGE)
        return name

    def _spec(self, lead: tuple, shape: tuple) -> tuple:
        ents = list(lead)
        ents += [(d, 1, 0) for d in range(len(shape))] if shape else [aff(0)]
        return tuple(ents)

    def _load(self, val: _Val, els: Sequence[AffExpr]) -> str:
        idx = []
        for ent in val.spec:
            if isinstance(ent, AffExpr):
                idx.append(ent)
            else:
                d, coef, const = ent
                idx.append(els[d] * coef + const)
        return self.b.load(val.array, *idx)

    def _bload(self, v, els, out_shape) -> str:
        """Load ``v`` at the nest point ``els``, numpy-broadcasting
        size-1 value dims (and scalars) against ``out_shape``."""
        if isinstance(v, float):
            return self.b.const(v)
        if not v.shape:
            return self._load(v, [])
        if len(v.shape) != len(out_shape):
            self._die("broadcast", f"rank {len(v.shape)} operand against "
                                   f"rank {len(out_shape)} result")
        adj = [aff(0) if v.shape[k] == 1 and out_shape[k] != 1 else els[k]
               for k in range(len(v.shape))]
        return self._load(v, adj)

    def _emit_nest(self, shape, body_fn, *, store_arr=None,
                   store_lead=(), pre_drop=0) -> _Val:
        """One perfect nest over ``shape`` inside the open scan prefix;
        ``body_fn(els) -> ssa`` computes the element, which is stored into
        ``store_arr`` (fresh intermediate when None).  ``pre_drop`` drops
        that many innermost prefix dims from the store index — used when
        ``store_lead`` itself supplies the time index (carry store-back)."""
        shape = tuple(int(s) for s in shape)
        loop_shape = shape or (1,)
        pre = tuple(e for e, _ in self.prefix)
        if pre_drop:
            pre = pre[:len(pre) - pre_drop]
        if store_arr is None:
            full = tuple(n for _, n in self.prefix) + loop_shape
            store_arr = self._new_array(full)
        ctxs, ivs = [], []
        for n in loop_shape:
            ctx = self.b.loop(self._iv(), 0, n)
            ivs.append(ctx.__enter__())
            ctxs.append(ctx)
        val = body_fn(ivs if shape else [])
        self.b.store(store_arr, val, *(pre + tuple(store_lead) + tuple(ivs)))
        for ctx in reversed(ctxs):
            ctx.__exit__()
        return _Val(store_arr, shape, self._spec(pre + tuple(store_lead),
                                                 shape))

    # -- graph interpretation -----------------------------------------------
    def _lift_const(self, c) -> float:
        """A constant tensor as the scalar it holds (a broadcast literal)."""
        a = np.asarray(c.detach().cpu() if isinstance(c, torch.Tensor)
                       else c, dtype=np.float64)
        if a.size >= 1 and np.all(a == a.reshape(-1)[0]):
            return float(a.reshape(-1)[0])
        self._die("constant", f"array constant of shape {a.shape} "
                              "(pass it as a function argument)")

    def run(self, gm: torch.fx.GraphModule, invals) -> list:
        """Interpret ``gm``'s graph (shapes already propagated) on
        ``invals``; returns the flat list of its outputs."""
        env: dict = {}
        args = iter(invals)
        for node in gm.graph.nodes:
            if node.op == "placeholder":
                env[node] = next(args)
            elif node.op == "get_attr":
                env[node] = self._lift_const(
                    operator.attrgetter(node.target)(gm))
            elif node.op == "output":
                return _leaves(map_arg(node.args[0], env.__getitem__))
            else:
                env[node] = self._node(node, env)
        raise AssertionError("graph without an output node")

    def _node(self, node, env):
        t = node.target
        args = map_arg(node.args, env.__getitem__)
        kwargs = map_arg(node.kwargs, env.__getitem__)
        name = _op_name(node)
        if getattr(t, "__name__", None) == "scan" and hasattr(t, "step"):
            return self._scan(node, *args)
        if t is getattr and args[1] in _INFO_ATTRS or t in _INFO_METHODS:
            return _INFO
        if t in _FILL:
            return _FILL[t]
        if t in _FULL:
            v = kwargs.get("fill_value", args[_FULL[t]]
                           if len(args) > _FULL[t] else None)
            if not isinstance(v, (int, float)):
                self._die(name, "fill value is not a Python number")
            return float(v)
        if t in _IDENTITY:
            return args[0]
        if t is operator.getitem and args[0] is _INFO:
            return _INFO
        if t is operator.getitem and isinstance(args[0], (tuple, list)):
            return args[0][args[1]]          # a tuple result (scan's)
        if any(a is _INFO for a in args):
            self._die(name, "operand computed from a tensor's shape or dtype")
        out_shape = _shape_of(node)
        if t in _ELT2 or t in _ELT1 or t in _POW:
            if kwargs:
                self._die(name, f"keyword arguments {sorted(kwargs)}")
            prim = ("integer_pow" if t in _POW
                    else _ELT2.get(t) or _ELT1[t])
            vals = [float(a) if isinstance(a, (int, float)) else a
                    for a in args]
            if all(isinstance(v, float) for v in vals) and prim in _PYFOLD:
                return _PYFOLD[prim](*vals)
            return self._elementwise(prim, vals, out_shape)
        if t in _REDUCE:
            return self._reduce(name, _REDUCE[t], args, kwargs, out_shape)
        if t in _MATMUL:
            return self._dot(args[0], args[1], out_shape)
        if t is operator.getitem:
            return self._getitem(args[0], args[1], out_shape)
        if t is getattr and args[1] == "T" or t in ("t", torch.t):
            v = args[0]
            return self._transpose(v, tuple(reversed(range(len(v.shape)))),
                                   out_shape)
        if t in ("transpose", torch.transpose):
            v, d0, d1 = args[0], *(a % len(args[0].shape) for a in args[1:3])
            perm = list(range(len(v.shape)))
            perm[d0], perm[d1] = perm[d1], perm[d0]
            return self._transpose(v, tuple(perm), out_shape)
        if t in ("permute", torch.permute):
            dims = args[1] if len(args) == 2 and isinstance(
                args[1], (tuple, list)) else args[1:]
            return self._transpose(args[0], tuple(dims), out_shape)
        if t in ("unsqueeze", torch.unsqueeze, "squeeze", torch.squeeze,
                 "reshape", torch.reshape, "view"):
            return self._reshape(args[0], out_shape)
        if t in ("expand", "expand_as", "broadcast_to", torch.broadcast_to):
            return self._expand(args[0], out_shape)
        self._die(name)

    # -- compute ops --------------------------------------------------------
    def _align_rank(self, v, rank: int):
        """Numpy rank promotion: prepend size-1 dims (a broadcast view)."""
        if isinstance(v, float) or not v.shape or len(v.shape) == rank:
            return v
        lead = rank - len(v.shape)
        return self._broadcast(v, tuple(range(lead, rank)),
                               (1,) * lead + v.shape)

    def _elementwise(self, prim, invals, out_shape) -> _Val:
        invals = [self._align_rank(v, len(out_shape)) for v in invals]

        def body(els):
            if prim == "neg":
                z = self.b.const(0.0)
                return self.b.sub(z, self._bload(invals[0], els, out_shape))
            if prim == "integer_pow":
                y = invals[1]
                if not float(y).is_integer() or y < 1:
                    self._die("pow", f"exponent {y}")
                x = self._bload(invals[0], els, out_shape)
                acc = x
                for _ in range(int(y) - 1):
                    acc = self.b.mul(acc, x)
                return acc
            args = [self._bload(v, els, out_shape) for v in invals]
            return self.b.arith(prim, *args)

        return self._emit_nest(out_shape, body)

    def _reduce(self, name, fn, args, kwargs, out_shape) -> _Val:
        v = args[0]
        if isinstance(v, float):
            self._die(name, "reduction of a constant")
        dim = kwargs.get("dim", kwargs.get("axis",
                                           args[1] if len(args) > 1 else None))
        keep = kwargs.get("keepdim", kwargs.get(
            "keepdims", args[2] if len(args) > 2 else False))
        if kwargs.get("dtype") is not None:
            self._die(name, "dtype argument")
        if dim is None or dim == ():
            axes = tuple(range(len(v.shape)))
        else:
            axes = tuple(sorted(int(d) % len(v.shape) for d in
                                (dim if isinstance(dim, (tuple, list))
                                 else (dim,))))
        extents = [v.shape[a] for a in axes]
        count = math.prod(extents)
        if count > MAX_UNROLL:
            self._die(name, f"reduction of {count} elements exceeds the "
                            f"unroll budget ({MAX_UNROLL})")
        red_shape = tuple(n for d, n in enumerate(v.shape) if d not in axes)

        def body(els):
            terms = []
            for combo in itertools.product(*[range(n) for n in extents]):
                full, free = [], iter(els)
                for k in range(len(v.shape)):
                    full.append(aff(combo[axes.index(k)]) if k in axes
                                else next(free))
                terms.append(self._load(v, full))
            acc = terms[0]  # left fold: sequential_exec's element order
            for t in terms[1:]:
                acc = self.b.arith(fn, acc, t)
            return acc

        out = self._emit_nest(red_shape, body)
        return self._reshape(out, out_shape) if keep else out

    def _dot(self, a, b, out_shape) -> _Val:
        if isinstance(a, float) or isinstance(b, float):
            self._die("matmul", "contraction with a constant operand")
        if not (1 <= len(a.shape) <= 2 and 1 <= len(b.shape) <= 2):
            self._die("matmul", f"{a.shape} @ {b.shape} (batched or scalar "
                                "contraction)")
        lc0, rc0 = len(a.shape) - 1, 0
        K = a.shape[lc0]
        if K > MAX_UNROLL:
            self._die("matmul", f"contraction of {K} elements exceeds "
                                f"the unroll budget ({MAX_UNROLL})")
        lf = [d for d in range(len(a.shape)) if d != lc0]
        rf = [d for d in range(len(b.shape)) if d != rc0]

        def body(els):
            acc = None
            for k in range(K):
                fa = [None] * len(a.shape)
                fa[lc0] = aff(k)
                for i, d in enumerate(lf):
                    fa[d] = els[i]
                fb = [None] * len(b.shape)
                fb[rc0] = aff(k)
                for j, d in enumerate(rf):
                    fb[d] = els[len(lf) + j]
                term = self.b.mul(self._load(a, fa), self._load(b, fb))
                acc = term if acc is None else self.b.add(acc, term)
            return acc

        return self._emit_nest(out_shape, body)

    # -- layout ops (views: spec rewrites, no code) -------------------------
    def _broadcast(self, v, bd: tuple, out_shape):
        if isinstance(v, float):
            return v
        ents = []
        for ent in v.spec:
            if isinstance(ent, AffExpr):
                ents.append(ent)
            else:
                d, coef, const = ent
                if v.shape[d] == 1 and out_shape[bd[d]] != 1:
                    ents.append(aff(const))  # stretched dim: index pins to 0
                else:
                    ents.append((bd[d], coef, const))
        return _Val(v.array, tuple(out_shape), tuple(ents))

    def _expand(self, v, out_shape):
        v = self._align_rank(v, len(out_shape))
        if isinstance(v, float) or not v.shape:
            return v
        return self._broadcast(v, tuple(range(len(out_shape))), out_shape)

    def _transpose(self, v, perm: tuple, out_shape):
        if isinstance(v, float):
            return v
        perm = tuple(int(x) % max(len(v.shape), 1) for x in perm)
        inv = {d: j for j, d in enumerate(perm)}
        ents = [ent if isinstance(ent, AffExpr)
                else (inv[ent[0]], ent[1], ent[2]) for ent in v.spec]
        return _Val(v.array, out_shape, tuple(ents))

    def _reshape(self, v, out_shape):
        if isinstance(v, float):
            return v
        old_nz = [d for d in range(len(v.shape)) if v.shape[d] != 1]
        new_nz = [d for d in range(len(out_shape)) if out_shape[d] != 1]
        if [v.shape[d] for d in old_nz] != [out_shape[d] for d in new_nz]:
            self._die("reshape", f"{v.shape} -> {out_shape} (only inserting/"
                                 "removing size-1 dims is traceable)")
        remap = dict(zip(old_nz, new_nz))
        ents = []
        for ent in v.spec:
            if isinstance(ent, AffExpr):
                ents.append(ent)
            elif ent[0] in remap:
                ents.append((remap[ent[0]], ent[1], ent[2]))
            else:  # a size-1 dim: always index its constant offset
                ents.append(aff(ent[2]))
        return _Val(v.array, tuple(out_shape), tuple(ents))

    def _getitem(self, v, index, out_shape):
        """Basic indexing as a view: ``None`` inserts a size-1 dim, an int
        pins a dim, a slice with a positive step strides it."""
        if isinstance(v, float):
            return v
        items = list(index) if isinstance(index, tuple) else [index]
        if any(not isinstance(x, (int, slice, type(None), type(Ellipsis)))
               or isinstance(x, bool) for x in items):
            self._die("getitem", f"index {index!r} (only ints, slices, None "
                                 "and ... are traceable)")
        n_idx = sum(x is not None and x is not Ellipsis for x in items)
        if Ellipsis in items:
            k = items.index(Ellipsis)
            items[k:k + 1] = [slice(None)] * (len(v.shape) - n_idx)
        items += [slice(None)] * (len(v.shape)
                                  - sum(x is not None for x in items))
        # per source dim: ("pin", index) or ("keep", new dim, step, start)
        plan, new_dim, src = {}, 0, 0
        for x in items:
            if x is None:
                new_dim += 1
                continue
            n = v.shape[src]
            if isinstance(x, int):
                plan[src] = ("pin", x % n)
            else:
                start, _, step = x.indices(n)
                if step < 1:
                    self._die("getitem", f"negative step in {index!r}")
                plan[src] = ("keep", new_dim, step, start)
                new_dim += 1
            src += 1
        ents = []
        for ent in v.spec:
            if isinstance(ent, AffExpr):
                ents.append(ent)
                continue
            d, coef, const = ent
            p = plan[d]
            if p[0] == "pin":
                ents.append(aff(const + coef * p[1]))
            else:
                _, nd, step, start = p
                ents.append((nd, coef * step, const + coef * start))
        return _Val(v.array, tuple(out_shape), tuple(ents))

    # -- scan: the recurrence loop ------------------------------------------
    def _scan(self, node, init, xs, consts) -> tuple:
        op = node.target
        inits, xs_l, consts = _leaves(init), _leaves(xs), list(consts)
        if any(isinstance(x, float) for x in xs_l):
            self._die("scan", "scanned-over constant input")
        init_nodes, xs_nodes = _leaves(node.args[0]), _leaves(node.args[1])
        carry_shapes = [_shape_of(n) for n in init_nodes]
        x_shapes = [_shape_of(n)[1:] for n in xs_nodes]
        k_shapes = [_shape_of(n) for n in node.args[2]]
        T = _shape_of(xs_nodes[0])[0]
        n_c, n_x = len(inits), len(xs_l)

        # the step on flat positional arguments, traced once at per-step
        # shapes; the constant cells are bound to this trace's placeholders
        def call(cs, xv, ks):
            carry = tuple(cs) if isinstance(init, (tuple, list)) else cs[0]
            x = tuple(xv) if isinstance(xs, (tuple, list)) else xv[0]
            return _bound(op.cells, ks, op.step, carry, x)

        names = ([f"c{i}" for i in range(n_c)] + [f"x{i}" for i in range(n_x)]
                 + [f"k{i}" for i in range(len(consts))])

        def group(prefix):
            g = [n for n in names if n[0] == prefix]
            return "(" + "".join(f"{n}, " for n in g) + ")"

        src = (f"def step({', '.join(names)}):\n"
               f"    return call({group('c')}, {group('x')}, {group('k')})\n")
        ns = {"call": call}
        exec(compile(src, f"<scan step of {self.fn_name}>", "exec"), ns)
        gm = torch.fx.symbolic_trace(ns["step"])
        ShapeProp(gm).propagate(*[torch.zeros(s) for s in
                                  carry_shapes + x_shapes + k_shapes])

        pre_exprs = tuple(e for e, _ in self.prefix)
        pre_exts = tuple(n for _, n in self.prefix)
        carries = []  # (array, logical shape)
        for v, shp in zip(inits, carry_shapes):
            cname = self._new_array(pre_exts + (T + 1,) + (shp or (1,)))
            self._emit_nest(shp,
                            lambda els, v=v, s=shp: self._bload(v, els, s),
                            store_arr=cname, store_lead=(aff(0),))
            carries.append((cname, shp))

        ctx = self.b.loop(self._iv("t"), 0, T)
        t = ctx.__enter__()
        self.prefix.append((t, T))
        try:
            benv = [_Val(cname, shp, self._spec(pre_exprs + (t,), shp))
                    for cname, shp in carries]
            benv += [self._bind_time(x, t) for x in xs_l]
            benv += consts
            bouts = self.run(gm, benv)
            if len(bouts) != 2 or len(_leaves(bouts[0])) != n_c:
                self._die("scan", "step must return (carry, y) with the "
                                  "carry's structure")
            new_carries, ys = _leaves(bouts[0]), _leaves(bouts[1])
            for (cname, shp), nv in zip(carries, new_carries):
                self._emit_nest(shp,
                                lambda els, v=nv, s=shp:
                                self._bload(v, els, s),
                                store_arr=cname, store_lead=(t + 1,),
                                pre_drop=1)
            y_arrays = []
            for y in ys:
                shp = () if isinstance(y, float) else y.shape
                fresh = (not isinstance(y, float)
                         and y.spec == self._spec(pre_exprs + (t,), shp))
                if fresh:  # already a per-step intermediate: reuse in place
                    y_arrays.append((y.array, shp))
                else:
                    yv = self._emit_nest(
                        shp, lambda els, v=y, s=shp: self._bload(v, els, s))
                    y_arrays.append((yv.array, shp))
        finally:
            self.prefix.pop()
            ctx.__exit__()

        outs_c = [_Val(cname, shp, self._spec(pre_exprs + (aff(T),), shp))
                  for cname, shp in carries]
        outs_y = [_Val(yarr, (T,) + shp, self._spec(pre_exprs, (T,) + shp))
                  for yarr, shp in y_arrays]
        carry = tuple(outs_c) if isinstance(init, (tuple, list)) else outs_c[0]
        y_out = (tuple(outs_y) if isinstance(bouts[1], (tuple, list))
                 else outs_y[0])
        return carry, y_out

    def _bind_time(self, val, t: AffExpr):
        """Bind a scanned input's leading (time) dim to the loop iv."""
        ents = []
        for ent in val.spec:
            if isinstance(ent, AffExpr):
                ents.append(ent)
            elif ent[0] == 0:
                ents.append(t * ent[1] + ent[2])
            else:
                ents.append((ent[0] - 1, ent[1], ent[2]))
        return _Val(val.array, val.shape[1:], tuple(ents))


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


@dataclass
class TracedProgram:
    """A Program built by tracing ``fn`` plus the differential-check hooks.

    ``program`` is ordinary affine IR — feed it straight to ``hls.compile``.
    ``in_names``/``out_names`` name the arrays bound to the function's
    arguments and (copied) outputs; ``in_shapes``/``out_shapes`` keep the
    original tensor shapes (scalars are stored as shape-(1,) arrays)."""

    program: Program
    fn: Callable
    in_names: tuple
    out_names: tuple
    in_shapes: tuple
    out_shapes: tuple

    def validate(self, seed: int = 0, rtol: float = 1e-12) -> float:
        """Differential check: run the traced Program through
        ``sim.sequential_exec`` and ``fn`` (float64, on the CPU) on the same
        inputs; returns the max relative error, raising AssertionError past
        ``rtol``."""
        from . import sim

        inputs = sim.make_inputs(self.program, seed=seed)
        got = sim.sequential_exec(self.program, inputs)
        args = [torch.from_numpy(np.asarray(inputs[n], np.float64)
                                 .reshape(s).copy())
                for n, s in zip(self.in_names, self.in_shapes)]
        with torch.no_grad():
            want = _leaves(self.fn(*args))
        worst = 0.0
        for name, shape, w in zip(self.out_names, self.out_shapes, want):
            g = np.asarray(got[name], np.float64).reshape(shape)
            w = np.asarray(w, np.float64)
            err = np.max(np.abs(g - w) / np.maximum(np.abs(w), 1e-300))
            worst = max(worst, float(err))
            if not np.allclose(g, w, rtol=rtol, atol=0):
                raise AssertionError(
                    f"traced '{self.program.name}' diverges from its source "
                    f"function on '{name}': max rel err {err:.3e} > {rtol:g}")
        return worst

    def lint(self):
        """Static findings on the traced IR (``analysis.lint``) — catches
        what :meth:`validate` cannot: accesses that only leave their array
        on inputs the differential seed never exercises, dead stores the
        simulator silently performs, and multi-writer hazards masked by
        sequential execution order."""
        from .analysis import lint
        return lint(self.program)


def trace(fn: Callable, *example_args, name: Optional[str] = None,
          in_names: Optional[Sequence[str]] = None,
          out_names: Optional[Sequence[str]] = None) -> TracedProgram:
    """Trace ``fn`` on ``example_args`` (tensors or numpy arrays; only
    their shapes matter) into a :class:`TracedProgram`."""
    name = name or getattr(fn, "__name__", "traced")
    examples = [torch.as_tensor(np.asarray(a)) if not isinstance(
        a, torch.Tensor) else a for a in example_args]
    gm = torch.fx.symbolic_trace(fn)
    ShapeProp(gm).propagate(*examples)
    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    if in_names is None:
        try:
            in_names = list(inspect.signature(fn).parameters)
        except (TypeError, ValueError):
            in_names = []
    in_names = list(in_names)
    if len(in_names) != len(placeholders):
        in_names = [f"x{i}" for i in range(len(placeholders))]
    tr = _Tracer(name)
    invals, in_shapes = [], []
    for argname, ex in zip(in_names, examples):
        shp = tuple(int(s) for s in ex.shape)
        tr._new_array(shp or (1,), is_arg=True, name=argname)
        invals.append(_Val(argname, shp, tr._spec((), shp)))
        in_shapes.append(shp)
    outs = tr.run(gm, invals)
    if out_names is None:
        out_names = [f"out{i}" for i in range(len(outs))] \
            if len(outs) > 1 else ["out"]
    out_shapes = []
    for oname, val in zip(out_names, outs):
        shp = () if isinstance(val, float) else val.shape
        tr._new_array((tuple(shp) or (1,)), is_arg=True, name=oname)
        tr._emit_nest(shp, lambda els, v=val, s=shp: tr._bload(v, els, s),
                      store_arr=oname)
        out_shapes.append(tuple(shp))
    return TracedProgram(program=tr.b.build(), fn=fn,
                         in_names=tuple(in_names),
                         out_names=tuple(out_names),
                         in_shapes=tuple(in_shapes),
                         out_shapes=tuple(out_shapes))


# ---------------------------------------------------------------------------
# The bundled programs, written in PyTorch (single head, tiny shapes)
# ---------------------------------------------------------------------------


def wkv6_program(T: int = 4, D: int = 4) -> TracedProgram:
    """Single-head RWKV-6 WKV recurrence (the ``wkv6_ref`` math with
    B=H=1): a :func:`scan` over tokens carrying the (D, D) state."""

    def wkv6_head(r, k, v, w, u):
        def step(s, xs):
            rt, kt, vt, wt = xs                       # (D,)
            kv = kt[:, None] * vt[None, :]            # (D, D)
            out = ((s + u[:, None] * kv) * rt[:, None]).sum(dim=0)
            s1 = s * wt[:, None] + kv
            return s1, out

        s0 = torch.zeros((D, D), dtype=r.dtype)
        _, outs = scan(step, s0, (r, k, v, w))
        return outs

    ex = [torch.zeros(T, D)] * 4 + [torch.zeros(D)]
    return trace(wkv6_head, *ex, name=f"traced_wkv6_t{T}d{D}")


def conv_block_program(H: int = 8, W: int = 8) -> TracedProgram:
    """Separable 3x3 conv block (the ``stencil_pipeline_ref`` math): a row
    pass then a column pass — the paper's Fig. 1 chain, traced."""

    def conv_block(img, wx, wy):
        bx = (img[:, 0:W - 2] * wx[0] + img[:, 1:W - 1] * wx[1]
              + img[:, 2:W] * wx[2])
        return (bx[0:H - 2, :] * wy[0] + bx[1:H - 1, :] * wy[1]
                + bx[2:H, :] * wy[2])

    ex = [torch.zeros(H, W), torch.zeros(3), torch.zeros(3)]
    return trace(conv_block, *ex, name=f"traced_conv_h{H}w{W}")


def attention_program(T: int = 4, D: int = 4) -> TracedProgram:
    """Single-head softmax attention (the ``flash_attention_ref`` math,
    non-causal, B=H=1): two matmuls around a max/sum softmax."""

    def attention(q, k, v):
        s = (q @ k.T) * (D ** -0.5)
        m = s.amax(dim=1, keepdim=True)
        e = torch.exp(s - m)
        z = e.sum(dim=1, keepdim=True)
        return (e / z) @ v

    ex = [torch.zeros(T, D)] * 3
    return trace(attention, *ex, name=f"traced_attention_t{T}d{D}")
