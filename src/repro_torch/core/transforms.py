"""Pass-based program transforms (DESIGN.md §6).

The compile path used to be a hard-coded 3-step flow with exactly one ad-hoc
transform (``to_spsc``, hand-rolled inside ``dataflow.py``).  HIDA-style
dataflow HLS compilers get their leverage from a *transform + DSE* layer
above the scheduler; this module is that layer's transform half.

A ``Pass`` is a pure function ``Program -> Program`` (the input is never
mutated) with a semantics-preservation obligation: for every pass ``T``,

    sequential_exec(p, x) == sequential_exec(T(p), x)    for all inputs x

restricted to the arrays of ``p`` (a pass may introduce fresh arrays — e.g.
``ToSPSC``'s copies — but those must be dead on entry).  ``PassManager``
optionally discharges the obligation by differential execution after every
pass (``verify=True``); the DSE driver (``autotune.explore``) runs every
candidate pipeline under that mode.

Transforms:

  * ``Normalize``             — expand ``unroll``-marked loops (ir.normalize
                                as a pass; the builder already runs it).
  * ``LoopUnroll(factor)``    — partial unroll: strip-mine by ``factor`` and
                                inline the inner copies.  Execution order is
                                unchanged, so semantics are preserved by
                                construction.
  * ``LoopTile(sizes)``       — strip-mine named loops into outer/inner
                                pairs (order-preserving tiling; profitable
                                as a phase-ordering knob for the scheduler's
                                occupancy constraint).
  * ``ArrayPartition(dims)``  — rewrite ``ArrayDecl.partition``/``ports`` so
                                the scheduler's port pseudo-dependences see
                                banked parallelism.  Pure metadata.
  * ``FuseProducerConsumer``  — merge adjacent top-level nests when an
                                exact ILP legality check proves no
                                dependence is reversed; mismatched bounds
                                fuse by SHIFTING the consumer by the
                                per-level max dependence distance and
                                PEELING the iterations outside the shifted
                                intersection (DESIGN.md §6 shift-and-peel).
  * ``ToSPSC``                — the paper's §5.2 benchmark transformation
                                (migrated here from ``dataflow.py``).
"""
from __future__ import annotations

import copy
import itertools
import math
import time
from dataclasses import dataclass, replace as dc_replace
from typing import Callable, Optional, Sequence

import numpy as np

from . import faults
from .ilp import solve_ilp
from .ir import (AffExpr, ArithOp, ConstOp, LoadOp, Loop, Program, StoreOp,
                 aff, iv, nest_shape, normalize)


# ---------------------------------------------------------------------------
# Cloning / substitution helpers
# ---------------------------------------------------------------------------


def clone_program(p: Program) -> Program:
    """Deep copy without the interpreter's per-instance def cache (it maps
    SSA names to op *objects* and would go stale under rewriting)."""
    q = copy.deepcopy(p)
    q.__dict__.pop("_def_cache", None)
    return q


class _Namer:
    """Fresh-name factory for SSA values and ivs cloned by a transform."""

    def __init__(self, tag: str):
        self.tag = tag
        self._n = itertools.count()

    def __call__(self, old: str) -> str:
        return f"{old}_{self.tag}{next(self._n)}"


def _subst_all(e: AffExpr, sub: dict[str, AffExpr]) -> AffExpr:
    for k, v in sub.items():
        e = e.subst(k, v)
    return e


def _clone_body(items, sub: dict[str, AffExpr], ssa: dict[str, str],
                namer: _Namer) -> list:
    """Deep-copy ops/loops applying the affine substitution ``sub`` to
    indices, renaming cloned loop ivs and SSA results via ``namer``."""
    out = []
    for it in items:
        if isinstance(it, Loop):
            sub2 = dict(sub)
            new_iv = namer(it.ivname)
            sub2[it.ivname] = iv(new_iv)
            lp = Loop(ivname=new_iv, lb=it.lb, ub=it.ub, pipeline=it.pipeline,
                      ii=it.ii, unroll=it.unroll)
            lp.body = _clone_body(it.body, sub2, ssa, namer)
            out.append(lp)
        elif isinstance(it, ConstOp):
            r = namer(it.result)
            ssa[it.result] = r
            out.append(ConstOp(result=r, value=it.value))
        elif isinstance(it, LoadOp):
            r = namer(it.result)
            ssa[it.result] = r
            out.append(LoadOp(result=r, array=it.array,
                              index=tuple(_subst_all(e, sub) for e in it.index)))
        elif isinstance(it, StoreOp):
            out.append(StoreOp(array=it.array,
                               index=tuple(_subst_all(e, sub) for e in it.index),
                               value=ssa.get(it.value, it.value)))
        elif isinstance(it, ArithOp):
            r = namer(it.result)
            ssa[it.result] = r
            out.append(ArithOp(result=r, fn=it.fn,
                               args=tuple(ssa.get(a, a) for a in it.args)))
        else:
            raise TypeError(it)
    return out


def _rewrite_indices(items, sub: dict[str, AffExpr]) -> None:
    """In-place affine substitution on every access index below ``items``."""
    for it in items:
        if isinstance(it, Loop):
            _rewrite_indices(it.body, sub)
        elif isinstance(it, (LoadOp, StoreOp)):
            it.index = tuple(_subst_all(e, sub) for e in it.index)


# ---------------------------------------------------------------------------
# Pass / PassManager
# ---------------------------------------------------------------------------


class TransformError(ValueError):
    """A pass was asked to do something it cannot do soundly."""


class PassVerificationError(AssertionError):
    """Differential execution found a semantics change."""


class Pass:
    """A semantics-preserving program transform.

    Contract (DESIGN.md §6): ``apply`` is pure — it never mutates its input
    (clone first, rewrite the clone) — and the output must be sequentially
    equivalent to the input on the input's arrays.  A pass that does not
    apply (no matching loops, illegal fusion, ...) returns an unchanged
    program rather than raising, so pipelines compose.

    Every pass also has a *textual* identity for the ``hls.compile`` front
    end (``pipeline_parse``): ``tag`` is its name in the pipeline string
    syntax, ``params()`` returns the constructor parameters that differ
    from the defaults (what the printer emits inside ``{...}``), and
    ``build(params)`` reconstructs the pass from parsed parameters.  The
    round-trip obligation is ``build(parse(print(p))).signature() ==
    p.signature()``.
    """

    name: str = "pass"
    tag: str = "pass"

    def apply(self, p: Program) -> Program:
        raise NotImplementedError

    def __call__(self, p: Program) -> Program:
        return self.apply(p)

    def params(self) -> dict:
        """Textual-syntax parameters (non-default only), printable order."""
        return {}

    @classmethod
    def build(cls, params: dict) -> "Pass":
        """Construct from parsed textual parameters; raises TransformError
        on unknown or ill-typed keys (pipeline_parse wraps it with source
        positions)."""
        if params:
            raise TransformError(
                f"pass '{cls.tag}' takes no parameters, got {sorted(params)}")
        return cls()

    def signature(self) -> tuple:
        """(tag, canonicalized params) — the round-trip identity."""
        return (self.tag, tuple(sorted(
            (k, tuple(v) if isinstance(v, (list, tuple)) else v)
            for k, v in self.params().items())))

    def __repr__(self):
        return f"<{type(self).__name__} {self.name}>"


def _param_tuple(v, kind, what: str) -> tuple:
    """Normalize a parsed parameter value (scalar or list) to a tuple of
    ``kind``, raising TransformError with a helpful message otherwise."""
    items = list(v) if isinstance(v, (list, tuple)) else [v]
    out = []
    for it in items:
        if kind is int and isinstance(it, bool):
            raise TransformError(f"{what}: expected int, got {it!r}")
        if not isinstance(it, kind):
            raise TransformError(f"{what}: expected {kind.__name__}, "
                                 f"got {it!r}")
        out.append(it)
    return tuple(out)


def _param_scalar(v, kind, what: str):
    if isinstance(v, (list, tuple)):
        raise TransformError(f"{what}: expected one {kind.__name__}, "
                             f"got a list {v!r}")
    if kind is int and isinstance(v, bool):
        raise TransformError(f"{what}: expected int, got {v!r}")
    if kind is float and isinstance(v, int) and not isinstance(v, bool):
        v = float(v)
    if not isinstance(v, kind):
        raise TransformError(f"{what}: expected {kind.__name__}, got {v!r}")
    return v


@dataclass
class PassReport:
    name: str
    changed: bool
    seconds: float


def _fingerprint(p: Program) -> str:
    """Deep textual snapshot of a program (ops, loops, arrays)."""
    return repr([(type(n).__name__, vars(n)) for n, _ in p.walk()]) + \
        repr(sorted(p.arrays.items()))


class PassManager:
    """Run a pipeline of passes, optionally verifying each one.

    ``verify=True`` discharges every pass's preservation obligation by
    differential execution (``differential_check``) and raises
    ``PassVerificationError`` naming the offending pass on mismatch.  It
    also enforces the purity half of the contract: a pass that mutates its
    input in place (and would therefore dodge the differential oracle by
    returning the same corrupted object) is caught by a pre/post
    fingerprint comparison.
    """

    def __init__(self, passes: Sequence[Pass], *, verify: bool = False,
                 seeds: Sequence[int] = (0,)):
        self.passes = list(passes)
        self.verify = verify
        self.seeds = tuple(seeds)
        self.reports: list[PassReport] = []

    def run(self, p: Program) -> Program:
        self.reports = []
        cur = p
        for ps in self.passes:
            t0 = time.perf_counter()
            before = _fingerprint(cur) if self.verify else None
            nxt = ps.apply(cur)
            if self.verify:
                if _fingerprint(cur) != before:
                    raise PassVerificationError(
                        f"pass '{ps.name}' mutated its input program "
                        "(passes must clone, then rewrite the clone)")
                if nxt is not cur:  # identical object == proven no-op
                    try:
                        differential_check(cur, nxt, seeds=self.seeds)
                    except AssertionError as e:
                        raise PassVerificationError(
                            f"pass '{ps.name}' changed program semantics: {e}"
                        ) from e
            self.reports.append(PassReport(
                name=ps.name, changed=nxt is not cur,
                seconds=time.perf_counter() - t0))
            cur = nxt
        return cur

    def describe(self) -> str:
        return " | ".join(ps.name for ps in self.passes)


def differential_check(p: Program, q: Program,
                       seeds: Sequence[int] = (0,)) -> None:
    """Assert sequential equivalence of ``q`` to ``p`` on ``p``'s arrays.

    Fresh arrays introduced by ``q`` (e.g. SPSC copies) get independent
    random contents — a sound transform must treat them as dead on entry.
    """
    from .sim import make_inputs, sequential_exec

    for name, arr in p.arrays.items():
        if name not in q.arrays:
            raise AssertionError(f"array {name} disappeared")
        if tuple(q.arrays[name].shape) != tuple(arr.shape):
            raise AssertionError(f"array {name} changed shape")
    for seed in seeds:
        base = make_inputs(p, seed)
        extra = make_inputs(q, seed + 7919)
        qin = {**extra, **{k: v.copy() for k, v in base.items()}}
        out_p = sequential_exec(p, base)
        out_q = sequential_exec(q, qin)
        for k in out_p:
            if not np.allclose(out_p[k], out_q[k], rtol=1e-12, atol=0):
                raise AssertionError(f"array {k} differs (seed {seed})")


# ---------------------------------------------------------------------------
# Normalize
# ---------------------------------------------------------------------------


class Normalize(Pass):
    """``ir.normalize`` (complete expansion of ``unroll``-marked loops) as a
    pure pass, plus — with ``sink=True``, the default — canonicalization of
    loop-adjacent ops: every maximal run of ops that sits beside a loop
    (bare ops in ``Program.body``, or ops next to a sub-loop inside a loop
    body — an imperfect nest per ``ir.nest_shape``) is sunk into a fresh
    trip-1 *sink nest*, so downstream layers meet ops only at innermost
    loop bodies.  A run whose SSA results are consumed outside the run
    cannot be sunk (a loop body opens a fresh value scope) and is left in
    place; ``nest_shape`` then still reports the task as imperfect.
    Idempotent; the builder already normalizes unrolls, so this mostly
    guards hand-built and frontend-traced Programs entering the pipeline."""

    tag = "normalize"

    def __init__(self, sink: bool = True):
        self.sink = bool(sink)
        self.name = "normalize" if self.sink else "normalize(nosink)"

    def params(self) -> dict:
        return {} if self.sink else {"sink": False}

    @classmethod
    def build(cls, params: dict) -> "Normalize":
        p = dict(params)
        kw: dict = {}
        if "sink" in p:
            kw["sink"] = _param_scalar(p.pop("sink"), bool, "normalize sink")
        if p:
            raise TransformError(
                f"normalize: unknown parameter(s) {sorted(p)} (valid: sink)")
        return cls(**kw)

    @staticmethod
    def _op_uses(op) -> list[str]:
        if isinstance(op, ArithOp):
            return list(op.args)
        if isinstance(op, StoreOp):
            return [op.value]
        return []

    def _sink_runs(self, p: Program) -> bool:
        """Sink loop-adjacent op runs into trip-1 nests in place; returns
        whether anything changed."""
        uses: dict[str, int] = {}
        for node, _ in p.walk():
            if not isinstance(node, Loop):
                for a in self._op_uses(node):
                    uses[a] = uses.get(a, 0) + 1
        taken = {l.ivname for l in p.loops()}
        fresh_ids = itertools.count()

        def fresh() -> str:
            while True:
                nm = f"sink{next(fresh_ids)}"
                if nm not in taken:
                    taken.add(nm)
                    return nm

        changed = False

        def rework(items: list, top: bool) -> list:
            nonlocal changed
            if not top and not any(isinstance(it, Loop) for it in items):
                return items  # innermost body: nothing is loop-adjacent
            out: list = []
            run: list = []

            def close():
                nonlocal changed
                if not run:
                    return
                defs = {op.result for op in run
                        if getattr(op, "result", None) is not None}
                inrun: dict[str, int] = {}
                for op in run:
                    for a in self._op_uses(op):
                        inrun[a] = inrun.get(a, 0) + 1
                if any(uses.get(d, 0) != inrun.get(d, 0) for d in defs):
                    out.extend(run)  # results escape the run: cannot sink
                else:
                    nest = Loop(ivname=fresh(), lb=0, ub=1)
                    nest.body = list(run)
                    out.append(nest)
                    changed = True
                run.clear()

            for it in items:
                if isinstance(it, Loop):
                    close()
                    it.body = rework(it.body, False)
                    out.append(it)
                else:
                    run.append(it)
            close()
            return out

        p.body = rework(p.body, True)
        return changed

    def apply(self, p: Program) -> Program:
        q = clone_program(p)
        any_change = False
        if any(l.unroll for l in q.loops()):
            q = normalize(q)
            any_change = True
        if self.sink and self._sink_runs(q):
            any_change = True
        return q if any_change else p


# ---------------------------------------------------------------------------
# LoopUnroll (partial unroll by a factor)
# ---------------------------------------------------------------------------


class LoopUnroll(Pass):
    """Partial unroll: strip-mine a loop by ``factor`` and inline the inner
    copies, so the loop body holds ``factor`` consecutive iterations.

    Targets ``ivs`` (names) or, by default, every *innermost* loop whose trip
    count the factor divides.  Iterations execute in the original order, so
    sequential semantics are preserved by construction; the payoff is that
    the parent's occupancy floor (II_outer >= trip_inner * II_inner) drops
    when the scheduler finds an II below ``factor`` * old_II for the widened
    body — spending datapath resources (DSP) for latency.
    """

    tag = "unroll"

    def __init__(self, factor: int, ivs: Optional[Sequence[str]] = None):
        if factor < 2:
            raise TransformError(f"unroll factor must be >= 2, got {factor}")
        self.factor = factor
        self.ivs = None if ivs is None else set(ivs)
        self.name = f"unroll(x{factor}" + \
            (f",{','.join(sorted(self.ivs))})" if self.ivs else ")")

    def params(self) -> dict:
        d: dict = {"factor": self.factor}
        if self.ivs is not None:
            d["ivs"] = tuple(sorted(self.ivs))
        return d

    @classmethod
    def build(cls, params: dict) -> "LoopUnroll":
        p = dict(params)
        if "factor" not in p:
            raise TransformError("unroll requires factor=<int>")
        factor = _param_scalar(p.pop("factor"), int, "unroll factor")
        ivs = p.pop("ivs", None)
        if ivs is not None:
            ivs = _param_tuple(ivs, str, "unroll ivs")
        if p:
            raise TransformError(
                f"unroll: unknown parameter(s) {sorted(p)} "
                "(valid: factor, ivs)")
        return cls(factor, ivs)

    def _eligible(self, loop: Loop) -> bool:
        if loop.unroll or loop.trip % self.factor or loop.lb != 0:
            return False
        if loop.ii is not None:
            # an explicit II pragma (e.g. an interface rate) is stated for
            # THIS loop's body; the widened body would silently drop it
            return False
        if self.ivs is not None:
            return loop.ivname in self.ivs
        return not any(isinstance(ch, Loop) for ch in loop.body)  # innermost

    def apply(self, p: Program) -> Program:
        if not any(self._eligible(l) for l in p.loops()):
            return p
        q = clone_program(p)
        namer = _Namer("u")

        def rec(items):
            out = []
            for it in items:
                if not isinstance(it, Loop):
                    out.append(it)
                    continue
                it.body = rec(it.body)
                if self._eligible(it):
                    f = self.factor
                    body = []
                    for k in range(f):
                        # original iv value = f*iv_new + k
                        sub = {it.ivname: aff(it.ivname) * f + k}
                        ssa: dict[str, str] = {}
                        body.extend(_clone_body(it.body, sub, ssa, namer))
                    nl = Loop(ivname=it.ivname, lb=0, ub=it.trip // f,
                              pipeline=it.pipeline, ii=None,
                              fuse_group=it.fuse_group, peel=it.peel,
                              tile_block=it.tile_block)
                    nl.body = body
                    out.append(nl)
                else:
                    out.append(it)
            return out

        q.body = rec(q.body)
        return q


# ---------------------------------------------------------------------------
# LoopTile (order-preserving strip-mining)
# ---------------------------------------------------------------------------


class LoopTile(Pass):
    """Strip-mine loops: ``for i in [0, N)`` becomes
    ``for i_t in [0, N/s): for i_b in [0, s): i = s*i_t + i_b``.

    ``sizes`` is either a mapping ``iv name -> block size`` or a positional
    sequence of block sizes applied to the top-level loop nests in program
    order (the textual syntax ``tile{sizes=8,8}``).  The dynamic execution
    order is untouched (this is tiling without interchange), so semantics
    are preserved by construction.  Loops whose trip the size does not
    divide are left alone.  The outer loop of each strip pair is marked
    ``Loop.tile_block`` so the resource model can cost nest-local
    intermediates at their streamed tile-window footprint (DESIGN.md §6).
    """

    tag = "tile"

    def __init__(self, sizes):
        if isinstance(sizes, dict):
            if not sizes or any(s < 2 for s in sizes.values()):
                raise TransformError(f"tile sizes must be >= 2: {sizes}")
            self.sizes: Optional[dict[str, int]] = dict(sizes)
            self.seq: Optional[tuple[int, ...]] = None
            self.name = "tile(" + ",".join(
                f"{k}:{v}" for k, v in sorted(self.sizes.items())) + ")"
        else:
            seq = tuple(sizes)
            if not seq or any(not isinstance(s, int) or s < 2 for s in seq):
                raise TransformError(f"tile sizes must be ints >= 2: {sizes}")
            self.sizes = None
            self.seq = seq
            self.name = "tile(" + ",".join(map(str, seq)) + ")"

    def params(self) -> dict:
        if self.seq is not None:
            return {"sizes": self.seq}
        return dict(sorted(self.sizes.items()))

    @classmethod
    def build(cls, params: dict) -> "LoopTile":
        if not params:
            raise TransformError(
                "tile requires sizes=<ints> (positional, applied to "
                "top-level loops in order) or <iv>=<int> pairs")
        if "sizes" in params:
            extra = sorted(set(params) - {"sizes"})
            if extra:
                raise TransformError(
                    f"tile: cannot mix sizes= with named loops {extra}")
            return cls(_param_tuple(params["sizes"], int, "tile sizes"))
        return cls({k: _param_scalar(v, int, f"tile size for loop '{k}'")
                    for k, v in params.items()})

    def _resolved(self, p: Program) -> dict[str, int]:
        """The effective iv -> size map (positional sizes bind to top-level
        loops in program order at apply time)."""
        if self.sizes is not None:
            return self.sizes
        tops = [it for it in p.body if isinstance(it, Loop)]
        return {l.ivname: s for l, s in zip(tops, self.seq)}

    @staticmethod
    def _eligible(loop: Loop, sizes: dict[str, int]) -> bool:
        s = sizes.get(loop.ivname)
        return (s is not None and not loop.unroll and loop.lb == 0
                and loop.trip % s == 0 and loop.trip // s >= 2)

    def apply(self, p: Program) -> Program:
        sizes = self._resolved(p)
        if not any(self._eligible(l, sizes) for l in p.loops()):
            return p
        q = clone_program(p)

        def rec(items):
            out = []
            for it in items:
                if not isinstance(it, Loop):
                    out.append(it)
                    continue
                it.body = rec(it.body)
                if self._eligible(it, sizes):
                    s = sizes[it.ivname]
                    ot, ib = f"{it.ivname}_t", f"{it.ivname}_b"
                    _rewrite_indices(it.body, {it.ivname: aff(ot) * s + aff(ib)})
                    inner = Loop(ivname=ib, lb=0, ub=s, pipeline=it.pipeline,
                                 ii=it.ii)
                    inner.body = it.body
                    outer = Loop(ivname=ot, lb=0, ub=it.trip // s,
                                 pipeline=it.pipeline, ii=None,
                                 fuse_group=it.fuse_group, peel=it.peel,
                                 tile_block=s)
                    outer.body = [inner]
                    out.append(outer)
                else:
                    out.append(it)
            return out

        q.body = rec(q.body)
        return q


# ---------------------------------------------------------------------------
# ArrayPartition
# ---------------------------------------------------------------------------


class ArrayPartition(Pass):
    """Rewrite ``ArrayDecl.partition`` (and optionally ``ports``) so the
    scheduler's port pseudo-dependences can exploit banked parallelism.

    ``dims=None`` means complete partitioning (every dim banked — the
    paper's supported ``array_partition`` mode); ``arrays=None`` targets
    every array that is not already fully partitioned.  Purely metadata:
    sequential semantics are unaffected, only the dependence analysis and
    the resource model see the change (BRAM -> FF migration).
    """

    tag = "partition"

    def __init__(self, arrays: Optional[Sequence[str]] = None,
                 dims: Optional[Sequence[int]] = None,
                 ports: Optional[Sequence[str]] = None):
        self.arrays = None if arrays is None else tuple(arrays)
        self.dims = None if dims is None else tuple(dims)
        self.ports = None if ports is None else tuple(ports)
        tgt = "*" if self.arrays is None else ",".join(self.arrays)
        dd = "full" if self.dims is None else ",".join(map(str, self.dims))
        self.name = f"partition({tgt};dims={dd})"

    def params(self) -> dict:
        d: dict = {}
        if self.arrays is not None:
            d["arrays"] = self.arrays
        if self.dims is not None:
            d["dims"] = self.dims
        if self.ports is not None:
            d["ports"] = self.ports
        return d

    @classmethod
    def build(cls, params: dict) -> "ArrayPartition":
        p = dict(params)
        arrays = p.pop("arrays", None)
        if arrays is not None:
            arrays = _param_tuple(arrays, str, "partition arrays")
        dims = p.pop("dims", None)
        if dims is not None:
            dims = _param_tuple(dims, int, "partition dims")
        ports = p.pop("ports", None)
        if ports is not None:
            ports = _param_tuple(ports, str, "partition ports")
        if p:
            raise TransformError(
                f"partition: unknown parameter(s) {sorted(p)} "
                "(valid: arrays, dims, ports)")
        return cls(arrays, dims, ports)

    def apply(self, p: Program) -> Program:
        todo = {}
        for name, arr in p.arrays.items():
            if self.arrays is not None and name not in self.arrays:
                continue
            dims = tuple(range(len(arr.shape))) if self.dims is None else \
                tuple(d for d in self.dims if d < len(arr.shape))
            new_ports = self.ports or arr.ports
            if tuple(arr.partition) == dims and tuple(arr.ports) == tuple(new_ports):
                continue
            if arr.kind == "reg":
                continue  # already port-free registers
            todo[name] = (dims, tuple(new_ports))
        if not todo:
            return p
        q = clone_program(p)
        for name, (dims, ports) in todo.items():
            q.arrays[name] = dc_replace(q.arrays[name], partition=dims,
                                        ports=ports)
        return q


# ---------------------------------------------------------------------------
# FuseProducerConsumer
# ---------------------------------------------------------------------------


def _perfect_chain(item) -> Optional[tuple[list[Loop], list]]:
    """(loops outermost-first, innermost body) for a perfect nest, else None.

    Structural companion to ``ir.nest_shape``: returns None exactly for the
    tasks the classifier reports as non-``perfect`` (fusion consults the
    classifier first and uses this helper only to extract the chain)."""
    if not isinstance(item, Loop):
        return None
    loops = [item]
    body = item.body
    while True:
        inner = [ch for ch in body if isinstance(ch, Loop)]
        if not inner:
            return loops, body
        if len(inner) != 1 or len(body) != 1:
            return None  # non-perfect: ops alongside a loop / sibling loops
        loops.append(inner[0])
        body = inner[0].body


def _mem_ops_of(items) -> list:
    out = []
    for it in items:
        if isinstance(it, Loop):
            out.extend(_mem_ops_of(it.body))
        elif isinstance(it, (LoadOp, StoreOp)):
            out.append(it)
    return out


def _fusion_hazard(opA, opB, loopsA: list[Loop], loopsB: list[Loop],
                   shift: Optional[Sequence[int]] = None) -> bool:
    """Exact legality core.  ``opA`` (from the first nest) and ``opB`` (from
    the second) touch the same array and at least one writes.  In the
    original program every dynamic instance of ``opA`` precedes every
    instance of ``opB``; after fusion (with the consumer shifted by
    ``shift``, default zero) instance ``va`` of A executes at fused position
    ``va`` and instance ``vb`` of B at ``vb + shift``, A's body first at
    ties.  The fusion is illegal iff

        exists va, vb :  addr_A(va) == addr_B(vb)  and  va >lex vb + shift

    Decided exactly with one small feasibility ILP per lexicographic carry
    level.
    """
    d = len(loopsA)
    n = 2 * d
    sh = [0] * d if shift is None else list(shift)
    col_a = {l.ivname: i for i, l in enumerate(loopsA)}
    col_b = {l.ivname: d + i for i, l in enumerate(loopsB)}

    A_eq_addr, b_eq_addr = [], []
    for dim in range(len(opA.index)):
        ea, eb = opA.index[dim], opB.index[dim]
        row = np.zeros(n)
        for nm, c in ea.coeffs.items():
            row[col_a[nm]] += c
        for nm, c in eb.coeffs.items():
            row[col_b[nm]] -= c
        A_eq_addr.append(row)
        b_eq_addr.append(float(eb.const - ea.const))

    bounds = [(l.lb, l.ub - 1) for l in loopsA] + \
             [(l.lb, l.ub - 1) for l in loopsB]
    c = np.zeros(n)

    for lvl in range(d):  # va >lex vb + shift carried at level lvl
        A_eq = list(A_eq_addr)
        b_eq = list(b_eq_addr)
        for k in range(lvl):
            row = np.zeros(n)
            row[k], row[d + k] = 1.0, -1.0
            A_eq.append(row)
            b_eq.append(float(sh[k]))  # va_k == vb_k + shift_k
        row = np.zeros(n)  # (vb_lvl + shift_lvl) - va_lvl <= -1
        row[d + lvl], row[lvl] = 1.0, -1.0
        res = solve_ilp(c, np.asarray([row]), np.asarray([-1.0 - sh[lvl]]),
                        np.asarray(A_eq), np.asarray(b_eq), bounds=bounds)
        if res.status == "feasible":
            # c == 0: any integral point — truncated search or not — is a
            # concrete witness of the hazard
            return True
        if res.ok:
            return True
        if res.status == "infeasible":
            continue
        if not res.truncated:
            raise RuntimeError(
                f"fusion legality ILP unresolved ({res.status}) for "
                f"{opA!r} / {opB!r}")
        # truncated with no witness either way: conservatively report a
        # hazard, which refuses (or shifts) the fusion — legal, suboptimal
        faults.note("fusion-hazard-degraded", status=res.status,
                    src=repr(opA), snk=repr(opB), level=lvl)
        return True
    return False


def _max_dep_distance(opA, opB, loopsA: list[Loop], loopsB: list[Loop],
                      level: int,
                      fixed: Sequence[tuple[int, int]] = ()) -> Optional[int]:
    """max(va[level] - vb[level]) over address-matching instance pairs of
    ``opA``/``opB`` — the per-level dependence distance that a legal
    consumer shift must cover.  ``fixed`` pins earlier levels' distances
    (``va[k] - vb[k] == d_k``), which is how the lexicographic maximization
    proceeds level by level.  Returns None when the accesses never alias
    under the pinned prefix (no constraint).  Solved closed-form via the
    deps.py separable solver whenever the address system decomposes;
    genuinely coupled systems fall back to the branch-and-bound ILP.
    Raises TransformError when neither resolves.
    """
    from .deps import _FALLBACK as _SEP_FALLBACK, _solve_separable

    nx, ny = len(loopsA), len(loopsB)
    # minimize -(va_level - vb_level)  ==  maximize the distance
    vars: dict = {}
    for i, l in enumerate(loopsA):
        vars[("x", i)] = (l.lb, l.ub - 1, -1 if i == level else 0)
    for j, l in enumerate(loopsB):
        vars[("y", j)] = (l.lb, l.ub - 1, 1 if j == level else 0)
    col_a = {l.ivname: ("x", i) for i, l in enumerate(loopsA)}
    col_b = {l.ivname: ("y", j) for j, l in enumerate(loopsB)}
    rows = []
    for dim in range(len(opA.index)):
        ea, eb = opA.index[dim], opB.index[dim]
        coeffs: dict = {}
        for nm, c in ea.coeffs.items():
            k = col_a[nm]
            coeffs[k] = coeffs.get(k, 0) + c
        for nm, c in eb.coeffs.items():
            k = col_b[nm]
            coeffs[k] = coeffs.get(k, 0) - c
        rows.append(({k: v for k, v in coeffs.items() if v},
                     eb.const - ea.const))
    for lvl, dist in fixed:  # va[lvl] - vb[lvl] == dist
        rows.append(({("x", lvl): 1, ("y", lvl): -1}, dist))
    r = _solve_separable(vars, rows)
    if r is None:
        return None
    if r is not _SEP_FALLBACK:
        return -r

    # coupled system: exact branch-and-bound fallback
    n = nx + ny
    c = np.zeros(n)
    c[level] = -1.0
    c[nx + level] = 1.0
    A_eq, b_eq = [], []
    for coeffs, rhs in rows:
        row = np.zeros(n)
        for (side, k), v in coeffs.items():
            row[k if side == "x" else nx + k] = v
        A_eq.append(row)
        b_eq.append(float(rhs))
    bounds = [(l.lb, l.ub - 1) for l in loopsA] + \
             [(l.lb, l.ub - 1) for l in loopsB]
    res = solve_ilp(c, None, None, np.asarray(A_eq), np.asarray(b_eq),
                    bounds=bounds)
    if res.ok:
        return int(round(-res.fun))
    if res.status == "infeasible":
        return None
    if res.truncated:
        # maximizing the distance as min(-dist): -bound upper-bounds the
        # true maximum, so a shift covering it still covers every real
        # dependence — a legal, possibly over-shifted fusion.  With no root
        # bound at all, the box bound over the level's variable ranges
        # serves the same role.
        if res.bound is not None:
            dist = int(math.ceil(-res.bound - 1e-9))
        else:
            dist = (loopsA[level].ub - 1) - loopsB[level].lb
        faults.note("dep-distance-degraded", status=res.status,
                    distance_bound=dist, src=repr(opA), snk=repr(opB))
        return dist
    raise TransformError(
        f"dependence-distance ILP unresolved ({res.status}) for "
        f"{opA!r} / {opB!r}")


_FUSE_GROUP_IDS = itertools.count(1)


class FuseProducerConsumer(Pass):
    """Fuse adjacent top-level producer/consumer nests, shifting and peeling
    the consumer when the bounds do not match (DESIGN.md §6).

    Candidates: two adjacent top-level *perfect* nests with identical depth
    where the first writes an array the second reads.  Legality is decided
    exactly (``_fusion_hazard``): for every access pair on a shared array
    with at least one write, no dynamic dependence may be reversed by
    fusing.  When the zero-shift fusion is illegal or the bounds differ,
    the pass computes the LEXICOGRAPHIC-minimum legal consumer shift — the
    lex-maximum dependence-distance vector over all conflicting pairs,
    maximized level by level with earlier levels pinned
    (``_max_dep_distance``, closed form via the deps.py separable solver)
    — peels the iterations falling outside the shifted intersection of
    bounds into prologue/epilogue nests, and emits the fused core over the
    intersection.  Correlated distances (a large inner distance occurring
    only with a smaller outer one) therefore no longer inflate the shift
    the way per-level componentwise maxima did; inner shift components may
    even be negative (B-side head peels).  Fusions whose core would cover
    less than ``min_core_fraction`` of the smaller nest at any level (e.g.
    a dependence distance growing with the problem size — no finite shift)
    are refused.  The pass fuses greedily until a fixpoint, so a pointwise
    chain (e.g. unsharp's sharpen+mask) collapses into one nest the
    scheduler can pipeline with a single II.
    """

    tag = "fuse"

    def __init__(self, max_fusions: Optional[int] = None, *,
                 enable_shift: bool = True,
                 min_core_fraction: float = 0.5):
        self.max_fusions = max_fusions
        self.enable_shift = enable_shift
        self.min_core_fraction = min_core_fraction
        self.name = "fuse" if enable_shift else "fuse(noshift)"

    def params(self) -> dict:
        d: dict = {}
        if self.max_fusions is not None:
            d["max_fusions"] = self.max_fusions
        if not self.enable_shift:
            d["shift"] = False
        if self.min_core_fraction != 0.5:
            d["min_core_fraction"] = self.min_core_fraction
        return d

    @classmethod
    def build(cls, params: dict) -> "FuseProducerConsumer":
        p = dict(params)
        kw: dict = {}
        if "shift" in p:
            kw["enable_shift"] = _param_scalar(p.pop("shift"), bool,
                                               "fuse shift")
        if "min_core_fraction" in p:
            kw["min_core_fraction"] = _param_scalar(
                p.pop("min_core_fraction"), float, "fuse min_core_fraction")
        max_fusions = None
        if "max_fusions" in p:
            max_fusions = _param_scalar(p.pop("max_fusions"), int,
                                        "fuse max_fusions")
        if p:
            raise TransformError(
                f"fuse: unknown parameter(s) {sorted(p)} "
                "(valid: shift, min_core_fraction, max_fusions)")
        return cls(max_fusions, **kw)

    # -- candidate test -----------------------------------------------------
    def _candidate(self, a, b):
        """(loopsA, loopsB, conflicting pairs) or None (not producer/consumer
        perfect nests of equal depth)."""
        ca, cb = _perfect_chain(a), _perfect_chain(b)
        if ca is None or cb is None:
            return None
        loopsA, _ = ca
        loopsB, _ = cb
        if len(loopsA) != len(loopsB):
            return None
        opsA, opsB = _mem_ops_of([a]), _mem_ops_of([b])
        wrote = {op.array for op in opsA if isinstance(op, StoreOp)}
        read_b = {op.array for op in opsB if isinstance(op, LoadOp)}
        if not (wrote & read_b):
            return None  # not a producer/consumer pair
        pairs = [(oa, ob) for oa in opsA for ob in opsB
                 if oa.array == ob.array and
                 (isinstance(oa, StoreOp) or isinstance(ob, StoreOp))]
        return loopsA, loopsB, pairs

    def _lexmax_distance(self, oa, ob, loopsA, loopsB) -> Optional[tuple]:
        """The lexicographically maximal dependence-distance vector
        ``va - vb`` over address-matching instance pairs, computed level by
        level: maximize the level's distance with every earlier level
        pinned at its (already maximal) value.  None when the accesses
        never alias."""
        d = len(loopsA)
        vec: list[int] = []
        for lvl in range(d):
            dist = _max_dep_distance(oa, ob, loopsA, loopsB, lvl,
                                     fixed=tuple(enumerate(vec)))
            if dist is None:
                if lvl == 0:
                    return None  # no aliasing at all
                raise TransformError(
                    f"lexmax distance infeasible at level {lvl} under its "
                    f"own attained prefix {vec} ({oa!r} / {ob!r})")
            vec.append(dist)
        return tuple(vec)

    def _shift_for(self, loopsA, loopsB, pairs) -> Optional[list[int]]:
        """The lexicographic-minimum legal consumer shift, or None when
        fusion stays illegal / undecidable.

        Legality is ``va <=lex vb + sigma`` for every aliasing pair, i.e.
        ``sigma >=lex`` every dependence-distance vector — the minimum such
        sigma (lex order is total) is the lex-maximum distance vector over
        all pairs.  Unlike the componentwise per-level maxima this never
        overshoots correlated distances (e.g. a pair whose big inner
        distance only occurs alongside a smaller outer one), so inner
        components may come out negative (consumer runs ahead at that
        level); ``_build`` peels the corresponding B-side head.  A hazard
        at zero shift guarantees some distance ``>lex 0``, so the leading
        component is always nonnegative."""
        d = len(loopsA)
        try:
            if not any(_fusion_hazard(oa, ob, loopsA, loopsB)
                       for oa, ob in pairs):
                return [0] * d  # zero shift already legal
            if not self.enable_shift:
                return None
            best: Optional[tuple] = None
            for oa, ob in pairs:
                vec = self._lexmax_distance(oa, ob, loopsA, loopsB)
                if vec is not None and (best is None or vec > best):
                    best = vec
            if best is None:
                return None
            shift = list(best)
            # re-verify the exact shifted hazard ILP before fusing
            if any(_fusion_hazard(oa, ob, loopsA, loopsB, shift)
                   for oa, ob in pairs):
                return None
            return shift
        except (TransformError, RuntimeError):
            return None  # undecided legality: never fuse on a guess

    def _profitable(self, loopsA, loopsB, shift) -> bool:
        """Refuse degenerate fusions: the shifted intersection (the fused
        core) must cover >= min_core_fraction of the smaller nest at every
        level — a shift that eats the whole iteration space (a dependence
        distance scaling with the bounds, i.e. backward-flowing) fails."""
        for la, lb_, s in zip(loopsA, loopsB, shift):
            lo = max(la.lb, lb_.lb + s)
            hi = min(la.ub, lb_.ub + s)
            if hi - lo < 1:
                return False
            if hi - lo < self.min_core_fraction * min(la.trip, lb_.trip):
                return False
        return True

    # -- construction -------------------------------------------------------
    def _fuse(self, a: Loop, b: Loop, namer: _Namer) -> Loop:
        """Zero-shift, equal-bounds fusion: splice B's body into A's."""
        loopsA, bodyA = _perfect_chain(a)
        loopsB, bodyB = _perfect_chain(b)
        # the B->A iv renaming must be SIMULTANEOUS: with crossed names
        # (B's outer called like A's inner), sequential substitution would
        # chain j->i->j.  Route through fresh temporaries instead.
        tmp = {lb.ivname: iv(f"__fuse_tmp{k}") for k, lb in enumerate(loopsB)}
        ssa: dict[str, str] = {}
        cloned = _clone_body(bodyB, tmp, ssa, namer)
        _rewrite_indices(cloned, {f"__fuse_tmp{k}": iv(la.ivname)
                                  for k, la in enumerate(loopsA)})
        bodyA.extend(cloned)
        return a

    def _peel(self, loops, level, lo, hi, sub, namer, peels) -> Loop:
        """Clone loops[level:] with the level loop restricted to [lo, hi),
        rebased to start at 0 (the scheduler's latency accounting assumes
        lb == 0)."""
        src = loops[level]
        piv = namer(src.ivname)
        lp = Loop(ivname=piv, lb=0, ub=hi - lo, pipeline=src.pipeline,
                  ii=src.ii, peel=True)
        s2 = dict(sub)
        s2[src.ivname] = aff(piv) + lo
        lp.body = _clone_body(src.body, s2, {}, namer)
        peels.append(lp)
        return lp

    def _build(self, loopsA, loopsB, shift, level, subA, subB, namer, peels):
        """Emit the fused region for levels >= ``level``: head peels (the
        iterations before the shifted intersection), the fused core over the
        intersection, then tail peels — recursively per level, so inner-level
        bound mismatches peel *inside* the core loop's body."""
        d = len(loopsA)
        if level == d:
            return _clone_body(loopsA[-1].body, subA, {}, namer) + \
                _clone_body(loopsB[-1].body, subB, {}, namer)
        la, lb_ = loopsA[level], loopsB[level]
        s = shift[level]
        lo = max(la.lb, lb_.lb + s)
        hi = min(la.ub, lb_.ub + s)
        assert hi > lo, "empty core must be rejected by _profitable"
        out = []
        if la.lb < lo:        # A-only head (consumer shifted right)
            out.append(self._peel(loopsA, level, la.lb, lo, subA, namer,
                                  peels))
        if lb_.lb + s < lo:   # B-only head (negative shift; defensive)
            out.append(self._peel(loopsB, level, lb_.lb, lo - s, subB, namer,
                                  peels))
        civ = namer(la.ivname)
        core = Loop(ivname=civ, lb=0, ub=hi - lo,
                    pipeline=la.pipeline and lb_.pipeline)
        sA = dict(subA)
        sA[la.ivname] = aff(civ) + lo
        sB = dict(subB)
        sB[lb_.ivname] = aff(civ) + (lo - s)
        core.body = self._build(loopsA, loopsB, shift, level + 1, sA, sB,
                                namer, peels)
        out.append(core)
        if hi < la.ub:        # A-only tail (producer ranges further)
            out.append(self._peel(loopsA, level, hi, la.ub, subA, namer,
                                  peels))
        if hi - s < lb_.ub:   # B-only tail (shifted consumer ranges further)
            out.append(self._peel(loopsB, level, hi - s, lb_.ub, subB, namer,
                                  peels))
        return out

    def apply(self, p: Program) -> Program:
        q = clone_program(p)
        namer = _Namer("f")
        fused = 0
        changed = True
        any_change = False
        peeled: set[int] = set()   # uids of peel nests: never re-fused
        log: list[dict] = list(getattr(q, "_fusion_log", []))
        while changed and (self.max_fusions is None or fused < self.max_fusions):
            changed = False
            # one contract check, one place: only tasks the classifier calls
            # perfect are fusion candidates — imperfect / multi-loop tasks
            # elsewhere in the program never block fusing a legal pair
            shape = nest_shape(q)
            for i in range(len(q.body) - 1):
                a, b = q.body[i], q.body[i + 1]
                if not (isinstance(a, Loop) and isinstance(b, Loop)):
                    continue
                if not (shape.task(i).is_perfect and
                        shape.task(i + 1).is_perfect):
                    continue
                if a.uid in peeled or b.uid in peeled:
                    continue
                cand = self._candidate(a, b)
                if cand is None:
                    continue
                loopsA, loopsB, pairs = cand
                shift = self._shift_for(loopsA, loopsB, pairs)
                if shift is None:
                    continue
                arrays = sorted({oa.array for oa, _ in pairs})
                equal_bounds = all((x.lb, x.ub) == (y.lb, y.ub)
                                   for x, y in zip(loopsA, loopsB))
                old_groups = {g for g in (a.fuse_group, b.fuse_group)
                              if g is not None}
                if equal_bounds and not any(shift):
                    q.body[i:i + 2] = [self._fuse(a, b, namer)]
                    new_items = [q.body[i]]
                    n_peels = 0
                else:
                    if any(l.ii is not None for l in loopsA + loopsB):
                        continue  # a merged nest would drop the II pragma
                    if not self._profitable(loopsA, loopsB, shift):
                        continue
                    peels: list[Loop] = []
                    new_items = self._build(loopsA, loopsB, shift, 0,
                                            {}, {}, namer, peels)
                    peeled.update(lp.uid for lp in peels)
                    n_peels = len(peels)
                    q.body[i:i + 2] = new_items
                # peel nests share the fused core's datapath (resource model)
                group = min(old_groups) if old_groups else \
                    next(_FUSE_GROUP_IDS)
                for it in new_items:
                    it.fuse_group = group
                for it in q.body:
                    if isinstance(it, Loop) and it.fuse_group in old_groups:
                        it.fuse_group = group
                log.append({"arrays": arrays, "shift": list(shift),
                            "peels": n_peels,
                            "core_trips": [min(x.ub, y.ub + s) -
                                           max(x.lb, y.lb + s)
                                           for x, y, s in
                                           zip(loopsA, loopsB, shift)]})
                fused += 1
                changed = any_change = True
                break
        if not any_change:
            return p
        q._fusion_log = log
        return q


# ---------------------------------------------------------------------------
# ToSPSC (migrated from dataflow.py — the paper's §5.2 transformation)
# ---------------------------------------------------------------------------


def _top_tasks(p: Program) -> list[Loop]:
    ts = []
    for item in p.body:
        if not isinstance(item, Loop):
            raise TransformError(
                "to_spsc expects top-level loop nests only")
        ts.append(item)
    return ts


def _task_mem_ops(task: Loop) -> list:
    return _mem_ops_of([task])


def _spsc_targets(p: Program) -> list[tuple[str, set[int], list[int]]]:
    """(array, writer tasks, external consumer tasks) for every array the
    SPSC conversion applies to."""
    tasks = _top_tasks(p)
    writers: dict[str, set[int]] = {}
    readers: dict[str, set[int]] = {}
    for ti, t in enumerate(tasks):
        for op in _task_mem_ops(t):
            d = writers if isinstance(op, StoreOp) else readers
            d.setdefault(op.array, set()).add(ti)
    out = []
    for name in sorted(set(writers) | set(readers)):
        ws = writers.get(name, set())
        rs = sorted(readers.get(name, set()) - ws)
        if len(ws) > 1 or len(rs) <= 1:
            continue
        if ws and p.arrays[name].is_arg:
            continue  # written function argument: cannot be duplicated (2mm)
        if ws and any(rt < tuple(ws)[0] for rt in rs):
            # a consumer running BEFORE the producer reads the array's
            # initial contents — its copy nest (inserted after the producer)
            # could not feed it; such an array is no dataflow channel at all
            continue
        out.append((name, ws, rs))
    return out


def to_spsc(p: Program) -> Program:
    """Insert copy loops so every intermediate array has exactly one consumer
    task, duplicating arrays as the paper did for unsharp/harris/flow.
    Returns ``p`` unchanged (same object) when nothing applies."""
    if not _spsc_targets(p):
        return p
    p = clone_program(p)
    tasks = _top_tasks(p)
    fresh = [0]

    insertions: list[tuple[int, Loop]] = []
    for name, ws, rs in _spsc_targets(p):
        arr = p.arrays[name]
        dups = []
        for k, rt in enumerate(rs):
            dup = f"{name}_cp{k}"
            p.arrays[dup] = dc_replace(arr, name=dup, is_arg=False)
            dups.append(dup)
            # retarget this consumer task's loads
            for op in _task_mem_ops(tasks[rt]):
                if isinstance(op, LoadOp) and op.array == name:
                    op.array = dup
        # build the copy nest: reads `name` row-major, writes all duplicates
        fresh[0] += 1
        tag = f"cp{fresh[0]}"
        H, W = arr.shape[0], arr.shape[1] if len(arr.shape) > 1 else 1
        li = Loop(ivname=f"{tag}i", lb=0, ub=H)
        lj = Loop(ivname=f"{tag}j", lb=0, ub=W)
        li.body = [lj]
        ld = LoadOp(result=f"%{tag}v", array=name,
                    index=(iv(f"{tag}i"), iv(f"{tag}j"))[: len(arr.shape)])
        lj.body = [ld] + [
            StoreOp(array=d, index=(iv(f"{tag}i"), iv(f"{tag}j"))[: len(arr.shape)],
                    value=ld.result) for d in dups]
        # read-only inputs get their copy nest at the top of the function
        insertions.append((tuple(ws)[0] if ws else -1, li))

    # insert copy nests right after their producer task (stable program order)
    for wtask, nest in sorted(insertions, key=lambda x: -x[0]):
        p.body.insert(wtask + 1, nest)
    return p


class ToSPSC(Pass):
    """``to_spsc`` as a pass (multi-consumer arrays become SPSC chains)."""

    name = "to_spsc"
    tag = "spsc"

    def apply(self, p: Program) -> Program:
        return to_spsc(p)


# ---------------------------------------------------------------------------
# Registries (the DSE driver, the pipeline parser and tests iterate these)
# ---------------------------------------------------------------------------

TRANSFORMS: dict[str, Callable[..., Pass]] = {
    "normalize": Normalize,
    "loop_unroll": LoopUnroll,
    "loop_tile": LoopTile,
    "array_partition": ArrayPartition,
    "fuse_producer_consumer": FuseProducerConsumer,
    "to_spsc": ToSPSC,
}

# Textual pipeline syntax (pipeline_parse): tag -> Pass class.  Every class
# implements params()/build() so a pipeline string round-trips through
# parse_pipeline/print_pipeline.
PASS_TAGS: dict[str, type] = {
    cls.tag: cls
    for cls in (Normalize, LoopUnroll, LoopTile, ArrayPartition,
                FuseProducerConsumer, ToSPSC)
}
