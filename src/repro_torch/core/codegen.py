"""CUDA codegen backend: lower a scheduled ``Program`` to a kernel for Hopper.

After the DSE picks a design point, this module turns it into an executable
CUDA C++ kernel for ``sm_90a`` (DESIGN.md §10 describes the lowering
contract, which the port keeps).

* **streamed** ("Mode A") — for single-sink producer-consumer chains of
  perfect depth-2 nests (the paper's Fig. 1 shape).  The sink's row loop is
  strip-mined into ``T = ceil(Rout/block_rows)`` row tiles; every producer
  stage is recomputed per tile over exactly the *window* of its rows the
  later stages consume.  Windows are derived by propagating
  ``rows [a*t+b, a*t+b+sz)`` triples backward through the chain, which
  generalizes the shift-and-peel fusion analysis: a producer's window
  overhang ``sz - a`` IS the fusion's row shift (the shared-memory line
  buffer halo) whenever the DSE fused that edge.  Intermediates live in
  the block's dynamic shared memory — they never reach device memory.

  - ``buffering="double"`` launches a grid of ``T`` blocks, one tile each;
    the card overlaps one block's loads with another's compute.
  - ``buffering="single"`` launches one block that walks the ``T`` tiles
    in order — one window, serialized refill/compute/store.  It is the
    measurable baseline the gridded variant must beat.

  Both entry points live in one emitted ``.cu`` per program and dtype and
  share the tile body, so the two bufferings agree bit for bit.

* **whole-array** ("Mode B") — the generic fallback for the programs the
  streamed contract rejects only *softly* (multi-store nests, strided or
  transposed stores, reads of unwritten regions, several sinks,
  reduction-carrying nests).  Every array is a whole buffer in device
  memory; each nest is one ``__global__`` over its domain, one thread per
  point, launched in program order on one stream (stream order is the
  barrier between nests).  A stored array starts as a copy of its input,
  so uncovered elements keep their initial values, exactly like
  ``sim.sequential_exec``; the copy is skipped where the nest's stores
  cover the whole array between them.  Partial, strided and transposed
  accesses are plain index arithmetic.  Canonical accumulations (``two_mm``) fold the reduction iv
  per thread in program order, which matches the sequential rounding bit
  for bit.  Two stores of one nest to one array run in one thread where
  the lowering proves their elements disjoint, else one launch per store
  in op order (the later store wins on overlap, as in the reference).

Programs outside both contracts (multi-chain tasks, imperfect nests, loose
top-level ops, non-canonical reductions — the shape vocabulary is
``ir.nest_shape``) raise the structured :class:`UnlowerableProgram`
carrying machine-readable :class:`NestContractViolation` entries;
``CompileResult.emit_cuda`` records the rejection (with its violation
codes) in ``diagnostics``.

The nest extraction and the streamed planner are the reference's,
unchanged, so windows, halos, padding and violation codes equal it by
construction; only the emitter is new, and a streamed block size that
shrinks where its windows would not fit one block's shared memory.  The
kernel is emitted as *source text* (``CudaKernel.source``, the debuggable
artifact) and built with ``nvcc`` at its first launch.  Arithmetic uses
the round-to-nearest intrinsics (``__fmul_rn``...), so nothing is
contracted into an FMA and the kernel repeats the plain version's rounding exactly.  Beside each kernel
sits its plain version (``streamed_plain`` walks the same tile plan,
``whole_plain`` the same nests, vectorized over each domain, in PyTorch);
a kernel runs it only for tensors that lie on the CPU.
"""
from __future__ import annotations

import collections
import ctypes
import math
import re
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from .. import _cuda
from .errors import NestContractViolation, UnlowerableProgram
from .ir import (AffExpr, ArithOp, ConstOp, LoadOp, Loop, Program, StoreOp,
                 nest_shape)

DEFAULT_BLOCK_ROWS = 8

# op -> (float, double) CUDA expression; the _rn intrinsics forbid FMA
# contraction so every op rounds once, as in the plain version
_ARITH_FMT = {
    "add": ("__fadd_rn({}, {})", "__dadd_rn({}, {})"),
    "sub": ("__fsub_rn({}, {})", "__dsub_rn({}, {})"),
    "mul": ("__fmul_rn({}, {})", "__dmul_rn({}, {})"),
    "div": ("__fdiv_rn({}, {})", "__ddiv_rn({}, {})"),
    "min": ("fminf({}, {})", "fmin({}, {})"),
    "max": ("fmaxf({}, {})", "fmax({}, {})"),
    "cmp": ("(({}) > ({}) ? 1.0f : 0.0f)", "(({}) > ({}) ? 1.0 : 0.0)"),
}

_TORCH_FNS = {
    "add": torch.add,
    "sub": torch.sub,
    "mul": torch.mul,
    "div": torch.div,
    "min": torch.minimum,
    "max": torch.maximum,
    "cmp": lambda a, b: (a > b).to(a.dtype),
}

_CTYPES = {"float32": "float", "float64": "double"}
_TORCH_DTYPES = {"float32": torch.float32, "float64": torch.float64}

# threads per block: the gridded kernel runs many blocks per SM; the
# single-block baseline gets the most threads a block may have
_THREADS = {"double": 256, "single": 1024}

# launches per "program/buffering/dtype", counted where the kernel launches
LAUNCHES: collections.Counter = collections.Counter()


def _ident(name: str) -> str:
    return re.sub(r"\W", "_", name)


def _vname(ssa: str) -> str:
    return "v_" + _ident(ssa.lstrip("%"))


# ---------------------------------------------------------------------------
# Nest extraction + the hard (mode-independent) contract
# ---------------------------------------------------------------------------


@dataclass
class _Access:
    """One affine access, separability-checked: per array dim at most one
    induction variable, ``coef * iv + const`` with coef >= 1, const >= 0."""

    array: str
    dims: list[tuple[Optional[str], int, int]]  # (iv | None, coef, const)


@dataclass
class _Nest:
    loop: Loop
    ivs: list[str]
    trips: list[int]
    ops: list  # innermost body, program order
    loads: list[tuple[LoadOp, _Access]] = field(default_factory=list)
    stores: list[tuple[StoreOp, _Access]] = field(default_factory=list)
    # reduction carry (canonical accumulation): the innermost iv is absent
    # from the store index, and every load of the stored array matches the
    # store address exactly — ``dst[outs] = f(dst[outs], inputs[.., red..])``
    red_iv: Optional[str] = None
    red_loads: tuple = ()  # uids of the carried-accumulator loads


def _hard(hard: list, code: str, detail: str) -> None:
    hard.append(NestContractViolation(code, "codegen", detail))


def _classify_access(nest_ivs, index, arr_shape, what, tag, hard):
    dims = []
    seen_ivs: set = set()
    if len(index) != len(arr_shape):
        _hard(hard, "rank-mismatch",
              f"nest '{tag}': {what} rank {len(index)} != array rank "
              f"{len(arr_shape)}")
        return None
    if len(arr_shape) > 2:
        _hard(hard, "rank",
              f"nest '{tag}': {what} of a rank-{len(arr_shape)} array "
              "(only 1-D/2-D arrays lower)")
        return None
    for e in index:
        e = e if isinstance(e, AffExpr) else AffExpr({}, int(e))
        if len(e.coeffs) > 1:
            _hard(hard, "non-separable",
                  f"nest '{tag}': non-separable {what} index {e!r}")
            return None
        if e.const < 0:
            _hard(hard, "negative-offset",
                  f"nest '{tag}': negative {what} offset {e!r}")
            return None
        if e.coeffs:
            (ivn, coef), = e.coeffs.items()
            if ivn not in nest_ivs:
                _hard(hard, "unknown-iv",
                      f"nest '{tag}': {what} uses unknown iv '{ivn}'")
                return None
            if coef < 1:
                _hard(hard, "negative-stride",
                      f"nest '{tag}': negative-stride {what} {e!r}")
                return None
            if ivn in seen_ivs:
                _hard(hard, "diagonal-access",
                      f"nest '{tag}': iv '{ivn}' in two {what} dims "
                      "(diagonal access)")
                return None
            seen_ivs.add(ivn)
            dims.append((ivn, coef, e.const))
        else:
            dims.append((None, 0, e.const))
    return dims


def _extract_nests(p: Program) -> tuple[list[_Nest], list]:
    hard: list = []
    nests: list[_Nest] = []
    shape = nest_shape(p)
    for ti, item in enumerate(p.body):
        ts = shape.task(ti)
        # one contract check, one place: the structural gate is the
        # ir.nest_shape classifier, not an ad-hoc re-traversal
        if ts.kind == "ops":
            _hard(hard, "top-level-ops",
                  "top-level op outside any loop nest "
                  "(run transforms.Normalize to sink loose ops)")
            continue
        if ts.kind == "imperfect":
            _hard(hard, "imperfect-nest",
                  f"nest '{item.ivname}': imperfect nest (ops mixed with an "
                  "inner loop; run transforms.Normalize to sink them)")
            continue
        if ts.kind == "multi_loop":
            _hard(hard, "multi-chain",
                  f"nest '{item.ivname}': multiple inner loops at one level "
                  "(multi-chain tasks have no single vectorized domain)")
            continue
        ivs, trips, cur = [], [], item
        ops, chain_ok = None, True
        while True:
            if cur.lb != 0:
                _hard(hard, "non-zero-lb",
                      f"nest '{item.ivname}': non-zero lower bound")
                chain_ok = False
                break
            ivs.append(cur.ivname)
            trips.append(cur.trip)
            inner = [x for x in cur.body if isinstance(x, Loop)]
            if inner:
                cur = inner[0]
                continue
            ops = cur.body
            break
        if not chain_ok:
            continue
        nest = _Nest(loop=item, ivs=ivs, trips=trips, ops=ops)
        ok = True
        red_stores = []  # stores whose index omits the innermost iv
        for op in ops:
            if isinstance(op, LoadOp):
                dims = _classify_access(set(ivs), op.index,
                                        p.arrays[op.array].shape, "load",
                                        item.ivname, hard)
                if dims is None:
                    ok = False
                    break
                nest.loads.append((op, _Access(op.array, dims)))
            elif isinstance(op, StoreOp):
                dims = _classify_access(set(ivs), op.index,
                                        p.arrays[op.array].shape, "store",
                                        item.ivname, hard)
                if dims is None:
                    ok = False
                    break
                used = [d[0] for d in dims if d[0] is not None]
                if (sorted(used) == sorted(ivs[:-1]) and len(ivs) >= 2
                        and len(used) == len(dims)):
                    # reduction-carrying store: every iv but the innermost
                    red_stores.append(op)
                elif sorted(used) != sorted(ivs) or len(used) != len(dims):
                    _hard(hard, "store-shape",
                          f"nest '{item.ivname}': store to '{op.array}' "
                          "must use every nest iv (or every iv but the "
                          "innermost reduction iv) in exactly one dim "
                          "(no constant dims)")
                    ok = False
                    break
                nest.stores.append((op, _Access(op.array, dims)))
            elif isinstance(op, ArithOp):
                if op.fn not in _ARITH_FMT:
                    _hard(hard, "unsupported-op",
                          f"nest '{item.ivname}': unsupported op '{op.fn}'")
                    ok = False
                    break
            elif not isinstance(op, ConstOp):
                _hard(hard, "unsupported-node",
                      f"nest '{item.ivname}': unsupported IR node "
                      f"{type(op).__name__}")
                ok = False
                break
        if not ok:
            continue
        if red_stores:
            # canonical accumulation: ONE reduction store, and every load
            # of the carried array matches the store address exactly, so
            # the nest is a left fold over the innermost iv —
            # dst[outs] = f(dst[outs], inputs[.., red, ..]) per step
            if len(nest.stores) != 1:
                _hard(hard, "reduction",
                      f"nest '{item.ivname}': reduction with "
                      f"{len(nest.stores)} stores (only single-store "
                      "accumulations lower)")
                continue
            sop, sacc = nest.stores[0]
            carried = [(op_, a) for op_, a in nest.loads
                       if a.array == sacc.array]
            if not carried or any(a.dims != sacc.dims for _, a in carried):
                _hard(hard, "reduction",
                      f"nest '{item.ivname}': reduction — reads "
                      f"'{sacc.array}' it also writes at a different "
                      "address (non-canonical carried accumulation)")
                continue
            nest.red_iv = ivs[-1]
            nest.red_loads = tuple(op_.uid for op_, _ in carried)
        rd = {a.array for _, a in nest.loads}
        wr = {a.array for _, a in nest.stores}
        for arr in sorted(rd & wr):
            if nest.red_iv is not None and arr == nest.stores[0][1].array:
                continue  # the canonical carry, handled above
            _hard(hard, "reduction",
                  f"nest '{item.ivname}': reduction — reads '{arr}' it "
                  "also writes (carried accumulation outside the "
                  "canonical innermost-axis pattern has no lowering)")
            ok = False
        if ok:
            nests.append(nest)
    writers: dict[str, str] = {}
    for nest in nests:
        for _, acc in nest.stores:
            prev = writers.get(acc.array)
            if prev is not None and prev != nest.loop.ivname:
                _hard(hard, "multi-writer",
                      f"array '{acc.array}' written by two nests "
                      f"('{prev}', '{nest.loop.ivname}')")
            writers[acc.array] = nest.loop.ivname
    return nests, hard


# ---------------------------------------------------------------------------
# Mode A: the streamed (grid + window) plan
# ---------------------------------------------------------------------------


@dataclass
class _StagePlan:
    nest: _Nest
    out: str                    # produced array
    r0: int                     # store row/col offsets into the array
    c0: int
    win_a: int = 0              # domain rows [a*t+b, a*t+b+sz) per grid step
    win_b: int = 0
    win_sz: int = 0


@dataclass
class _StreamPlan:
    stages: list[_StagePlan]
    sink: _StagePlan
    block_rows: int
    grid: int                   # T
    inputs: list[str]           # arrays read from refs (not stage-produced)
    pad_rows: dict[str, int]    # input array -> trailing edge-pad rows
    halo: dict[str, int]        # produced array -> window overhang (sz - a)


def _plan_streamed(p: Program, nests: list[_Nest],
                   block_rows: int) -> tuple[Optional[_StreamPlan], list[str]]:
    soft: list[str] = []
    stages: list[_StagePlan] = []
    for nest in nests:
        tag = nest.loop.ivname
        if nest.red_iv is not None:
            soft.append(f"nest '{tag}': streamed mode does not pipeline "
                        "reduction-carrying nests (whole-array fallback)")
            return None, soft
        if len(nest.ivs) != 2:
            soft.append(f"nest '{tag}': streamed mode needs depth-2 nests")
            return None, soft
        if len(nest.stores) != 1:
            soft.append(f"nest '{tag}': streamed mode needs exactly one "
                        f"store ({len(nest.stores)} found)")
            return None, soft
        _, acc = nest.stores[0]
        (iv0, c0_, r_off), (iv1, c1_, c_off) = acc.dims
        if (iv0, c0_) != (nest.ivs[0], 1) or (iv1, c1_) != (nest.ivs[1], 1):
            soft.append(f"nest '{tag}': store to '{acc.array}' is strided or "
                        "transposed")
            return None, soft
        stages.append(_StagePlan(nest=nest, out=acc.array, r0=r_off,
                                 c0=c_off))
    if not stages:
        soft.append("no loop nests")
        return None, soft
    produced = {s.out: i for i, s in enumerate(stages)}
    # loads: row dim must carry the outer iv; col dim the inner iv or const
    for si, s in enumerate(stages):
        tag = s.nest.loop.ivname
        for _, acc in s.nest.loads:
            if len(acc.dims) != 2:
                soft.append(f"nest '{tag}': streamed mode needs 2-D loads "
                            f"('{acc.array}' is {len(acc.dims)}-D)")
                return None, soft
            (riv, _, _), (civ, _, _) = acc.dims
            if riv != s.nest.ivs[0] or civ not in (s.nest.ivs[1], None):
                soft.append(f"nest '{tag}': load of '{acc.array}' is "
                            "transposed or row-constant")
                return None, soft
            if acc.array in produced and produced[acc.array] >= si:
                soft.append(f"nest '{tag}': reads '{acc.array}' before its "
                            "producer runs (initial-value read)")
                return None, soft
    sinks = [s for s in stages
             if not any(acc.array == s.out
                        for t in stages for _, acc in t.nest.loads)]
    if len(sinks) != 1:
        soft.append("streamed mode needs a unique sink stage "
                    f"({len(sinks)} found: {[s.out for s in sinks]})")
        return None, soft
    sink = sinks[0]
    shape = p.arrays[sink.out].shape
    if (sink.r0, sink.c0) != (0, 0) or tuple(sink.nest.trips) != shape:
        soft.append(f"sink nest '{sink.nest.loop.ivname}' does not fully "
                    f"cover '{sink.out}'")
        return None, soft
    # coverage: every stage-to-stage read stays inside the producer's
    # written box (else the read would see initial values -> Mode B)
    for s in stages:
        for _, acc in s.nest.loads:
            if acc.array not in produced:
                continue
            prod = stages[produced[acc.array]]
            (riv, rc, rk), (civ, cc, ck) = acc.dims
            rmax = rc * (s.nest.trips[0] - 1) + rk
            cmax = (cc * (s.nest.trips[1] - 1) + ck) if civ else ck
            if not (rk >= prod.r0 and ck >= prod.c0
                    and rmax < prod.r0 + prod.nest.trips[0]
                    and cmax < prod.c0 + prod.nest.trips[1]):
                soft.append(f"nest '{s.nest.loop.ivname}': load of "
                            f"'{acc.array}' reads outside the producer's "
                            "written box")
                return None, soft
    # backward window propagation: sink computes [B*t, B*t+B)
    rout = sink.nest.trips[0]
    B = max(1, min(block_rows, rout))
    sink.win_a, sink.win_b, sink.win_sz = B, 0, B
    halo: dict[str, int] = {}
    for s in reversed(stages):
        if s is sink:
            continue
        reqs = []  # (consumer stage, row coef, row const)
        for c in stages:
            for _, acc in c.nest.loads:
                if acc.array == s.out:
                    reqs.append((c, acc.dims[0][1], acc.dims[0][2]))
        # the unique-sink check already ran: a non-sink stage has consumers,
        # and they are later stages whose windows are already resolved
        assert reqs, s.out
        rates = {rc * c.win_a for c, rc, _ in reqs}
        if len(rates) > 1:
            soft.append(f"consumers of '{s.out}' advance at incompatible "
                        f"row rates {sorted(rates)}")
            return None, soft
        a = rates.pop()
        lo = min(rc * c.win_b + rk for c, rc, rk in reqs) - s.r0
        hi = max(rc * (c.win_b + c.win_sz - 1) + rk
                 for c, rc, rk in reqs) - s.r0
        if lo < 0:
            soft.append(f"window of '{s.out}' starts before its domain "
                        f"(offset {lo})")
            return None, soft
        s.win_a, s.win_b, s.win_sz = a, lo, hi - lo + 1
        halo[s.out] = s.win_sz - s.win_a
    T = -(-rout // B)
    # trailing edge-padding so the last (possibly partial) tile's input
    # reads stay in bounds; padded rows only feed output rows >= Rout,
    # which the host wrapper trims
    pad_rows: dict[str, int] = {}
    inputs: list[str] = []
    for s in stages:
        for _, acc in s.nest.loads:
            if acc.array in produced:
                continue
            if acc.array not in inputs:
                inputs.append(acc.array)
            rc, rk = acc.dims[0][1], acc.dims[0][2]
            need = rc * (s.win_a * (T - 1) + s.win_b + s.win_sz - 1) + rk
            over = need - (p.arrays[acc.array].shape[0] - 1)
            if over > 0:
                pad_rows[acc.array] = max(pad_rows.get(acc.array, 0), over)
    return _StreamPlan(stages=stages, sink=sink, block_rows=B, grid=T,
                       inputs=inputs, pad_rows=pad_rows, halo=halo), soft


# ---------------------------------------------------------------------------
# Source emission helpers
# ---------------------------------------------------------------------------


def _lit(v: float, dtype: str) -> str:
    """A constant as a literal of the kernel's type: a bare double literal
    next to a ``float`` would promote the op to double, and the f32 kernel
    would no longer round as the plain version (which rounds the constant
    to the tensor's dtype) does."""
    x = float(np.float32(v)) if dtype == "float32" else float(v)
    if not math.isfinite(x):
        raise ValueError(f"constant {v!r} is not finite in {dtype}")
    return f"({x!r}f)" if dtype == "float32" else f"({x!r})"


def _affine(var: str, coef: int, const: int) -> str:
    if coef == 0:
        return str(const)
    term = var if coef == 1 else f"{coef} * {var}"
    return term if const == 0 else f"{term} + {const}"


def _smem_layout(plan: _StreamPlan) -> tuple[dict[str, int], int]:
    """Element offset of each non-sink stage's window in the block's
    dynamic shared memory, and the total element count."""
    offs, total = {}, 0
    for s in plan.stages:
        if s is not plan.sink:
            offs[s.out] = total
            total += s.win_sz * s.nest.trips[1]
    return offs, total


def _emit_streamed(p: Program, plan: _StreamPlan,
                   dtype: str) -> tuple[str, dict]:
    B, T = plan.block_rows, plan.grid
    sink = plan.sink
    cout = p.arrays[sink.out].shape[1]
    rout = sink.nest.trips[0]
    produced = {s.out: s for s in plan.stages}
    fi = 0 if dtype == "float32" else 1
    offs, smem_elems = _smem_layout(plan)

    body = [f"real* w_{_ident(a)} = smem + {o};" for a, o in offs.items()]
    for s in plan.stages:
        tag = s.nest.loop.ivname
        csz = s.nest.trips[1]
        if s is sink:
            body.append(f"// stage {tag} (sink): '{s.out}' rows "
                        f"[{B}*t, +{B}) -> device memory")
            body.append(f"const int nrows = min({B}, {rout} - {B} * t);")
            body.append(f"for (int e = threadIdx.x; e < nrows * {csz}; "
                        "e += blockDim.x) {")
        else:
            body.append(f"// stage {tag}: '{s.out}' domain rows "
                        f"[{s.win_a}*t+{s.win_b}, +{s.win_sz}) -> shared "
                        "memory")
            body.append(f"for (int e = threadIdx.x; e < {s.win_sz * csz}; "
                        "e += blockDim.x) {")
        inner = [f"const int r = e / {csz}, c = e % {csz};",
                 f"const int i = {_affine('t', s.win_a, s.win_b)} + r;"
                 "  // domain row"]
        names: dict[str, str] = {}
        for op in s.nest.ops:
            if isinstance(op, ConstOp):
                names[op.result] = _lit(op.value, dtype)
            elif isinstance(op, LoadOp):
                acc = next(a for o, a in s.nest.loads if o is op)
                (_, rc, rk), (civ, cc, ck) = acc.dims
                if acc.array in produced:
                    # window-relative: the t terms cancel (the planner
                    # proved rc * consumer rate == producer rate)
                    prod = produced[acc.array]
                    rel = rc * s.win_b + rk - prod.r0 - prod.win_b
                    row = _affine("r", rc, rel)
                    col = (_affine("c", cc, ck - prod.c0) if civ
                           else str(ck - prod.c0))
                    expr = (f"w_{_ident(acc.array)}[({row}) * "
                            f"{prod.nest.trips[1]} + {col}]")
                else:
                    h, w = p.arrays[acc.array].shape
                    row = _affine("i", rc, rk)
                    if acc.array in plan.pad_rows:
                        # clamping the row is the reference's edge padding
                        row = f"min({row}, {h - 1})"
                    col = _affine("c", cc, ck) if civ else str(ck)
                    expr = (f"x_{_ident(acc.array)}[(size_t)({row}) * {w}"
                            f" + {col}]")
                names[op.result] = _vname(op.result)
                inner.append(f"const real {names[op.result]} = {expr};")
            elif isinstance(op, ArithOp):
                names[op.result] = _vname(op.result)
                inner.append(f"const real {names[op.result]} = "
                             + _ARITH_FMT[op.fn][fi].format(
                                 *(names[a] for a in op.args)) + ";")
            elif isinstance(op, StoreOp):
                val = names[op.value]
                if s is sink:
                    inner.append(f"o_{_ident(s.out)}[(size_t)i * {cout} + c]"
                                 f" = {val};")
                else:
                    inner.append(f"w_{_ident(s.out)}[e] = {val};")
        body += ["    " + x for x in inner]
        body.append("}")
        if s is not sink:
            body.append("__syncthreads();")

    ins = [f"const real* __restrict__ x_{_ident(a)}" for a in plan.inputs]
    outp = f"real* __restrict__ o_{_ident(sink.out)}"
    args = [f"x_{_ident(a)}" for a in plan.inputs] + [f"o_{_ident(sink.out)}"]
    cargs = ([f"const void* x_{_ident(a)}" for a in plan.inputs]
             + [f"void* o_{_ident(sink.out)}", "void* stream"])
    casts = ([f"(const real*)x_{_ident(a)}" for a in plan.inputs]
             + [f"(real*)o_{_ident(sink.out)}"])
    lines = [
        "// Generated by repro_torch.core.codegen — do not edit.",
        f"// program '{p.name}': streamed (Mode A), block_rows={B}, "
        f"grid={T}, {dtype}.",
        "// Replaces the Pallas kernel that repro.core.codegen._emit_streamed"
        " emits.",
        "// Bound: device memory (a few flops per byte: each input read "
        "once, the sink",
        "// written once).  Design: every producer window lives in dynamic "
        "shared memory",
        "// and never reaches device memory; a tile recomputes its halo rows "
        "instead of",
        "// reading them back.  Neighbouring threads take neighbouring "
        "columns, so loads",
        "// and stores coalesce.  The _rn intrinsics round every op once, as "
        "the plain",
        "// version does, so the two agree bit for bit.",
        "#include <cuda_runtime.h>",
        "",
        f"typedef {_CTYPES[dtype]} real;",
        f"constexpr int SMEM_BYTES = {smem_elems} * (int)sizeof(real);",
        "",
        "__device__ __forceinline__ void tile(int t, "
        + ", ".join(ins + [outp, "real* smem"]) + ") {",
    ]
    lines += ["    " + b for b in body]
    lines += [
        "}",
        "",
        f"__global__ void __launch_bounds__({_THREADS['double']}) "
        "streamed_double(" + ", ".join(ins + [outp]) + ") {",
        "    extern __shared__ __align__(16) unsigned char smem_raw[];",
        "    tile(blockIdx.x, " + ", ".join(args)
        + ", reinterpret_cast<real*>(smem_raw));",
        "}",
        "",
        f"__global__ void __launch_bounds__({_THREADS['single']}) "
        "streamed_single(" + ", ".join(ins + [outp]) + ") {",
        "    extern __shared__ __align__(16) unsigned char smem_raw[];",
        f"    for (int t = 0; t < {T}; ++t) {{",
        "        tile(t, " + ", ".join(args)
        + ", reinterpret_cast<real*>(smem_raw));",
        "        __syncthreads();  // the next tile overwrites the windows",
        "    }",
        "}",
        "",
    ]
    for buf, blocks in (("double", T), ("single", 1)):
        lines += [
            f'extern "C" int launch_{buf}(' + ", ".join(cargs) + ") {",
            "    if (SMEM_BYTES > 48 * 1024) {",
            f"        cudaError_t err = cudaFuncSetAttribute(streamed_{buf}, "
            "cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);",
            "        if (err != cudaSuccess) return (int)err;",
            "    }",
            f"    streamed_{buf}<<<{blocks}, {_THREADS[buf]}, SMEM_BYTES, "
            "(cudaStream_t)stream>>>(" + ", ".join(casts) + ");",
            "    return (int)cudaGetLastError();",
            "}",
            "",
        ]
    lines += [
        'extern "C" const char* repro_error_string(int e) {',
        "    return cudaGetErrorString((cudaError_t)e);",
        "}",
    ]
    meta = {"mode": "streamed", "grid": (T,), "block_rows": B,
            "halo": dict(plan.halo), "outputs": (sink.out,),
            "vmem_window_elems": {s.out: s.win_sz * s.nest.trips[1]
                                  for s in plan.stages if s is not sink},
            "smem_bytes": smem_elems * (4 if dtype == "float32" else 8),
            "nest_launches": 1}
    return "\n".join(lines) + "\n", meta


# ---------------------------------------------------------------------------
# The plain version: the same plan, tile by tile, in PyTorch
# ---------------------------------------------------------------------------


def streamed_plain(p: Program, plan: _StreamPlan,
                   xs: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """K2's plain version: walk the grid tile by tile, compute every stage's
    window with one PyTorch op per IR op, edge-pad the inputs, trim the
    output.  Same windows, halo and op order as the kernel, so it agrees
    with the kernel bit for bit on the card and with ``sim.
    sequential_exec`` in float64."""
    B, T = plan.block_rows, plan.grid
    sink = plan.sink
    cout = p.arrays[sink.out].shape[1]
    rout = sink.nest.trips[0]
    produced = {s.out: s for s in plan.stages}
    some = next(iter(xs.values()))
    dtype, dev = some.dtype, some.device
    padded = {}
    for a in plan.inputs:
        x, pad = xs[a], plan.pad_rows.get(a, 0)
        padded[a] = torch.cat([x, x[-1:].expand(pad, -1)]) if pad else x
    consts: dict[float, torch.Tensor] = {}
    out = torch.empty((T * B, cout), dtype=dtype, device=dev)
    for t in range(T):
        win: dict[str, torch.Tensor] = {}
        for s in plan.stages:
            csz = s.nest.trips[1]
            names: dict[str, torch.Tensor] = {}
            val = None
            for op in s.nest.ops:
                if isinstance(op, ConstOp):
                    if op.value not in consts:
                        consts[op.value] = torch.tensor(op.value, dtype=dtype,
                                                        device=dev)
                    names[op.result] = consts[op.value]
                elif isinstance(op, LoadOp):
                    acc = next(a for o, a in s.nest.loads if o is op)
                    (_, rc, rk), (civ, cc, ck) = acc.dims
                    if acc.array in produced:
                        prod = produced[acc.array]
                        src = win[acc.array]
                        r0 = rc * s.win_b + rk - prod.r0 - prod.win_b
                        c0 = ck - prod.c0
                    else:
                        src = padded[acc.array]
                        r0 = rc * (s.win_a * t + s.win_b) + rk
                        c0 = ck
                    rsel = slice(r0, r0 + rc * (s.win_sz - 1) + 1, rc)
                    csel = (slice(c0, c0 + cc * (csz - 1) + 1, cc) if civ
                            else slice(c0, c0 + 1))
                    names[op.result] = src[rsel, csel]
                elif isinstance(op, ArithOp):
                    names[op.result] = _TORCH_FNS[op.fn](
                        *(names[a] for a in op.args))
                elif isinstance(op, StoreOp):
                    val = names[op.value]
            if s is sink:
                out[B * t:B * t + B] = val.expand(B, cout)
            else:
                win[s.out] = val.expand(s.win_sz, csz)
    return {sink.out: out[:rout]}


# ---------------------------------------------------------------------------
# Mode B: the whole-array plan
# ---------------------------------------------------------------------------


@dataclass
class _WholePlan:
    nests: list[_Nest]
    stored: list[str]           # every stored array, first-store order
    writer: dict[str, int]      # stored array -> index of its (one) nest
    copied: list[str]           # stored arrays their stores do not cover
    inputs: list[str]           # arrays the kernel reads, program order
    groups: list[list]          # per nest: its stores, grouped per launch


def _covers(p: Program, nest: _Nest, accs: list[_Access]) -> bool:
    """The stores ``accs`` of one nest to one array write every element of
    it together.  A store uses each outer iv in exactly one dim (the
    extractor's ``store-shape`` rule), so it writes the product of its
    dims' index progressions; stores that differ in at most one dim write
    the shared dims' product times the union of the differing dim's
    (``dus``: rows ``2i`` and ``2i + 1`` of ``uy``).  Stores differing in
    more dims count as not covering."""
    trip = dict(zip(nest.ivs, nest.trips))
    shape = p.arrays[accs[0].array].shape
    dims = [{acc.dims[d] for acc in accs} for d in range(len(shape))]
    if sum(len(ds) > 1 for ds in dims) > 1:
        return False
    return all({k + c * t for ivn, c, k in ds for t in range(trip[ivn])}
               == set(range(extent)) for ds, extent in zip(dims, shape))


def _disjoint(a: _Access, b: _Access) -> bool:
    """Two stores of one nest provably write disjoint elements: some dim
    steps both by the same coefficient from offsets that differ modulo it
    (``dus``: rows ``2i`` and ``2i + 1``)."""
    return any(ca == cb and (ka - kb) % ca != 0
               for (_, ca, ka), (_, cb, kb) in zip(a.dims, b.dims))


def _plan_whole(p: Program, nests: list[_Nest]) -> _WholePlan:
    stored: list[str] = []
    writer: dict[str, int] = {}
    full: set = set()
    groups = []
    for ni, nest in enumerate(nests):
        sts = [acc for _, acc in nest.stores]
        for acc in sts:
            if acc.array not in writer:
                stored.append(acc.array)
                writer[acc.array] = ni
        for a in {acc.array for acc in sts}:
            if _covers(p, nest, [acc for acc in sts if acc.array == a]):
                full.add(a)
        overlap = any(x.array == y.array and not _disjoint(x, y)
                      for i, x in enumerate(sts) for y in sts[i + 1:])
        # stores that may overlap run one launch each, in op order, so the
        # later store wins as it does in the reference
        groups.append([[s] for s in nest.stores] if overlap
                      else [list(nest.stores)])
    copied = [a for a in stored if a not in full]
    read = set(copied)
    for ni, nest in enumerate(nests):
        for _, acc in nest.loads:
            if writer.get(acc.array, ni) >= ni:
                read.add(acc.array)   # the input's value (incl. the carry)
    return _WholePlan(nests=nests, stored=stored, writer=writer,
                      copied=copied, inputs=[a for a in p.arrays if a in read],
                      groups=groups)


def _load_src(plan: _WholePlan, ni: int, array: str) -> str:
    """Where nest ``ni`` reads ``array``: the output buffer once its writer
    nest has run, else the input (a stored array's value before its writer
    runs, and a reduction's carry start, are its input's)."""
    return "o" if plan.writer.get(array, ni) < ni else "x"


def _c_index(acc: _Access, shape: tuple, var: dict) -> str:
    terms = [_affine(var[ivn], c, k) if ivn is not None else str(k)
             for ivn, c, k in acc.dims]
    if len(terms) == 1:
        return terms[0]
    return f"(size_t)({terms[0]}) * {shape[1]} + ({terms[1]})"


_WHOLE_THREADS = 256


def _emit_whole_cuda(p: Program, plan: _WholePlan,
                     dtype: str) -> tuple[str, dict]:
    fi = 0 if dtype == "float32" else 1
    lines = [
        "// Generated by repro_torch.core.codegen — do not edit.",
        f"// program '{p.name}': whole-array (Mode B), {dtype}.",
        "// Replaces the Pallas kernel that repro.core.codegen._emit_whole "
        "emits.",
        "// Bound: device memory for the elementwise nests (each array read "
        "once and",
        "// written once), arithmetic for a reduction nest.  Design: one "
        "__global__ per",
        "// nest (per store where two stores of a nest may overlap), one "
        "thread per point",
        "// of its domain, launched in program order on one stream; every "
        "array lives",
        "// in device memory, the L2 keeps a producer's output near its "
        "consumer.",
        "// A reduction folds its innermost iv per thread in program order.  "
        "The _rn",
        "// intrinsics round every op once, as the plain version does, so "
        "the two agree",
        "// bit for bit.",
        "#include <cuda_runtime.h>",
        "",
        f"typedef {_CTYPES[dtype]} real;",
        "",
    ]
    launches = []   # (kernel, domain points, parameters, written ones)
    for ni, nest in enumerate(plan.nests):
        var = {ivn: f"iv_{_ident(ivn)}" for ivn in nest.ivs}
        outer = nest.ivs[:-1] if nest.red_iv is not None else nest.ivs
        trips = nest.trips[:len(outer)]
        npts = math.prod(trips)
        for gi, group in enumerate(plan.groups[ni]):
            kname = f"nest{ni}_{_ident(nest.loop.ivname)}"
            if len(plan.groups[ni]) > 1:
                kname += f"_store{gi}"
            mine = {op.uid for op, _ in group}
            ptrs: list[str] = []        # kernel parameters, in order
            written: set = set()

            def ptr(kind: str, array: str, store: bool = False) -> str:
                name = f"{kind}_{_ident(array)}"
                if name not in ptrs:
                    ptrs.append(name)
                if store:
                    written.add(name)
                return name

            body = []   # the point's ivs from its flat index, then the ops
            for k, ivn in enumerate(outer):
                rest = math.prod(trips[k + 1:])
                idx = "pt" if rest == 1 else f"pt / {rest}"
                if k > 0:
                    idx = f"({idx}) % {trips[k]}"
                body.append(f"const int {var[ivn]} = (int)({idx});")
            names: dict[str, str] = {}
            inner = []
            red = nest.red_iv is not None
            for op in nest.ops:
                if isinstance(op, ConstOp):
                    names[op.result] = _lit(op.value, dtype)
                elif isinstance(op, LoadOp):
                    if red and op.uid in nest.red_loads:
                        names[op.result] = "acc"
                        continue
                    acc = next(a for o, a in nest.loads if o is op)
                    src = ptr(_load_src(plan, ni, acc.array), acc.array)
                    names[op.result] = _vname(op.result)
                    inner.append(
                        f"const real {names[op.result]} = {src}["
                        + _c_index(acc, p.arrays[acc.array].shape, var)
                        + "];")
                elif isinstance(op, ArithOp):
                    names[op.result] = _vname(op.result)
                    inner.append(f"const real {names[op.result]} = "
                                 + _ARITH_FMT[op.fn][fi].format(
                                     *(names[a] for a in op.args)) + ";")
                elif isinstance(op, StoreOp):
                    if red:
                        inner.append(f"acc = {names[op.value]};")
                    elif op.uid in mine:
                        acc = next(a for o, a in nest.stores if o is op)
                        inner.append(
                            f"{ptr('o', acc.array, store=True)}["
                            + _c_index(acc, p.arrays[acc.array].shape, var)
                            + f"] = {names[op.value]};")
            if red:
                _, sacc = nest.stores[0]
                at = _c_index(sacc, p.arrays[sacc.array].shape, var)
                rv = var[nest.red_iv]
                body.append(f"real acc = {ptr('x', sacc.array)}[{at}];"
                            "  // the carry starts at the input's value")
                body.append(f"for (int {rv} = 0; {rv} < {nest.trips[-1]}; "
                            f"++{rv}) {{")
                body += ["    " + x for x in inner]
                body.append("}")
                body.append(f"{ptr('o', sacc.array, store=True)}[{at}] = "
                            "acc;")
            else:
                body += inner
            params = [("real* " if n in written else "const real* ")
                      + f"__restrict__ {n}" for n in ptrs]
            what = (f"reduction over '{nest.red_iv}' ({nest.trips[-1]} "
                    "steps), " if red else "")
            lines.append(f"// nest {nest.loop.ivname}: {what}domain "
                         f"{tuple(trips)}")
            lines.append(f"__global__ void __launch_bounds__({_WHOLE_THREADS})"
                         f" {kname}(" + ", ".join(params) + ") {")
            lines.append("    for (long long pt = (long long)blockIdx.x * "
                         "blockDim.x + threadIdx.x;")
            lines.append(f"         pt < {npts}LL; pt += (long long)gridDim.x"
                         " * blockDim.x) {")
            lines += ["        " + b for b in body]
            lines += ["    }", "}", ""]
            launches.append((kname, npts, ptrs, written))

    esz = 4 if dtype == "float32" else 8
    cargs = ([f"const void* x_{_ident(a)}" for a in plan.inputs]
             + [f"void* o_{_ident(a)}" for a in plan.stored]
             + ["void* stream"])
    lines += [
        'extern "C" int launch_whole(' + ", ".join(cargs) + ") {",
        "    cudaStream_t s = (cudaStream_t)stream;",
        "    cudaError_t err;",
    ]
    for a in plan.copied:
        nbytes = math.prod(p.arrays[a].shape) * esz
        lines += [
            f"    // '{a}': its stores do not cover it; uncovered elements "
            "keep the input's values",
            f"    err = cudaMemcpyAsync(o_{_ident(a)}, x_{_ident(a)}, "
            f"{nbytes}, cudaMemcpyDeviceToDevice, s);",
            "    if (err != cudaSuccess) return (int)err;",
        ]
    for kname, npts, ptrs, written in launches:
        blocks = max(1, min(-(-npts // _WHOLE_THREADS), 2 ** 31 - 1))
        casts = [("(real*)" if n in written else "(const real*)") + n
                 for n in ptrs]
        lines += [
            f"    {kname}<<<{blocks}, {_WHOLE_THREADS}, 0, s>>>("
            + ", ".join(casts) + ");",
            "    err = cudaGetLastError();",
            "    if (err != cudaSuccess) return (int)err;",
        ]
    lines += [
        "    return 0;",
        "}",
        "",
        'extern "C" const char* repro_error_string(int e) {',
        "    return cudaGetErrorString((cudaError_t)e);",
        "}",
    ]
    meta = {"mode": "whole", "grid": (), "block_rows": None, "halo": {},
            "outputs": tuple(plan.stored), "vmem_window_elems": {},
            "smem_bytes": 0, "nest_launches": len(launches)}
    return "\n".join(lines) + "\n", meta


def _domain_view(src: torch.Tensor, acc: _Access, ivs: list[str],
                 trips: list[int], fixed: dict) -> torch.Tensor:
    """``src`` read at ``acc`` over the domain of ``ivs``: strided slices per
    array dim, axes permuted into iv order, size 1 where an iv is absent;
    ``fixed`` pins ivs (the reduction iv) to one value."""
    ivpos = {ivn: k for k, ivn in enumerate(ivs)}
    sel, axes = [], []
    for ivn, c, k in acc.dims:
        if ivn is None:
            sel.append(k)
        elif ivn in fixed:
            sel.append(c * fixed[ivn] + k)
        else:
            n = trips[ivpos[ivn]]
            sel.append(slice(k, k + c * (n - 1) + 1, c))
            axes.append(ivpos[ivn])
    t = src[tuple(sel)]
    t = t.permute(sorted(range(len(axes)), key=axes.__getitem__))
    return t.reshape([trips[k] if k in axes else 1
                      for k in range(len(ivs))])


def _store_view(val: torch.Tensor, acc: _Access, ivs: list[str],
                trips: list[int]) -> tuple:
    """(destination slices, value) of a store: the value broadcast over the
    domain and permuted into the array's dim order."""
    ivpos = {ivn: k for k, ivn in enumerate(ivs)}
    sel = tuple(slice(k, k + c * (trips[ivpos[ivn]] - 1) + 1, c)
                for ivn, c, k in acc.dims)
    v = val.expand(trips).permute([ivpos[ivn] for ivn, _, _ in acc.dims])
    return sel, v


def whole_plain(p: Program, plan: _WholePlan,
                arrays: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """K3's plain version: the nests in program order, each vectorized over
    its domain with one PyTorch op per IR op (strided slices for loads and
    stores, a Python loop over a reduction iv).  It reads and writes the
    same buffers as the kernel, so it agrees with it bit for bit on the card
    and with ``sim.sequential_exec`` in float64.  ``arrays`` holds the
    arrays the kernel reads (``CudaKernel.inputs``); ``plan`` is the one the
    kernel was emitted from."""
    some = arrays[plan.inputs[0]] if plan.inputs else None
    dtype = some.dtype if some is not None else torch.float64
    dev = some.device if some is not None else torch.device("cpu")
    out = {a: (arrays[a].clone() if a in plan.copied
               else torch.empty(p.arrays[a].shape, dtype=dtype, device=dev))
           for a in plan.stored}
    consts: dict[float, torch.Tensor] = {}

    def const(v: float) -> torch.Tensor:
        if v not in consts:
            consts[v] = torch.tensor(v, dtype=dtype, device=dev)
        return consts[v]

    for ni, nest in enumerate(plan.nests):
        red = nest.red_iv is not None
        outer = nest.ivs[:-1] if red else nest.ivs
        trips = nest.trips[:len(outer)]

        def evaluate(fixed, carry=None):
            names: dict[str, torch.Tensor] = {}
            stores = []
            for op in nest.ops:
                if isinstance(op, ConstOp):
                    names[op.result] = const(op.value)
                elif isinstance(op, LoadOp):
                    if red and op.uid in nest.red_loads:
                        names[op.result] = carry
                        continue
                    acc = next(a for o, a in nest.loads if o is op)
                    src = (out if _load_src(plan, ni, acc.array) == "o"
                           else arrays)[acc.array]
                    names[op.result] = _domain_view(src, acc, outer, trips,
                                                    fixed)
                elif isinstance(op, ArithOp):
                    names[op.result] = _TORCH_FNS[op.fn](
                        *(names[a] for a in op.args))
                elif isinstance(op, StoreOp):
                    acc = next(a for o, a in nest.stores if o is op)
                    stores.append((acc, names[op.value]))
            return stores

        if red:
            (_, sacc), = nest.stores
            acc = _domain_view(arrays[sacc.array], sacc, outer, trips, {})
            for k in range(nest.trips[-1]):
                (_, val), = evaluate({nest.red_iv: k}, acc)
                acc = val.expand(trips)
            stores = [(sacc, acc)]
        else:
            stores = evaluate({})
        for acc, val in stores:          # op order: the later store wins
            sel, v = _store_view(val, acc, outer, trips)
            out[acc.array][sel] = v
    return out


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


@dataclass
class CudaKernel:
    """An executable lowering of a Program.

    ``fn(arrays, device=None) -> dict`` maps input arrays (by name, the
    same dict ``sim.make_inputs`` produces, as numpy arrays or tensors) to
    the produced output tensors.  It launches the CUDA kernel on the card;
    it runs the plain version only for tensors on the CPU or
    ``device="cpu"``.  ``source`` is the emitted CUDA C++ text — the
    debuggable artifact, built with nvcc at the first launch.
    """

    program_name: str
    mode: str                       # "streamed" | "whole"
    buffering: str                  # "double" | "single" | "whole"
    source: str
    fn: Callable
    outputs: tuple
    grid: tuple
    block_rows: Optional[int]
    halo: dict = field(default_factory=dict)
    vmem_window_elems: dict = field(default_factory=dict)  # shared memory
    soft_reasons: list = field(default_factory=list)
    modeled_latency: Optional[int] = None
    point_desc: Optional[str] = None
    fusion_shifts: list = field(default_factory=list)
    dtype: str = "float32"
    inputs: tuple = ()              # the arrays the kernel reads
    smem_bytes: int = 0
    nest_launches: int = 1          # CUDA launches per call
    plain: Optional[Callable] = field(default=None, repr=False)

    def __call__(self, arrays, device=None):
        return self.fn(arrays, device=device)

    @property
    def lib_name(self) -> str:
        return f"{self.mode}_{_ident(self.program_name)}_{self.dtype}"

    @property
    def launch_key(self) -> str:
        """This kernel's entry in ``LAUNCHES``."""
        return f"{self.program_name}/{self.buffering}/{self.dtype}"


def _runner(k: CudaKernel, p: Program, out_shapes: dict, plain_fn: Callable):
    """``k``'s call (kernel on the card, plain version on the CPU) and its
    plain version on any device.  ``plain_fn(xs)`` maps the input tensors
    by name to the outputs; the kernel's C entry ``launch_<buffering>``
    takes the inputs' pointers, then the outputs', then the stream."""
    tdtype = _TORCH_DTYPES[k.dtype]
    bound: list = []    # [library, entry point] once loaded

    def inputs(arrays, device):
        missing = [a for a in k.inputs if a not in arrays]
        if missing:
            raise KeyError(f"{p.name}: missing input arrays {missing}")
        dev = _cuda.resolve_device([arrays[a] for a in k.inputs], device)
        return dev, {a: _cuda.as_input(arrays[a], tdtype, dev,
                                       p.arrays[a].shape, f"{p.name}:{a}")
                     for a in k.inputs}

    def run(arrays, device=None):
        dev, xs = inputs(arrays, device)
        if dev.type == "cpu":
            return plain_fn(xs)
        if k.smem_bytes > _cuda.MAX_SMEM_BYTES:
            raise RuntimeError(
                f"{p.name}: the windows need {k.smem_bytes} bytes of shared "
                f"memory, more than the {_cuda.MAX_SMEM_BYTES} a block has")
        if not bound:
            lib = _cuda.load(k.lib_name, k.source)
            nargs = len(xs) + len(out_shapes) + 1
            bound[:] = [lib, _cuda.entry(lib, f"launch_{k.buffering}",
                                         [ctypes.c_void_p] * nargs)]
        lib, launch = bound
        outs = {a: torch.empty(shape, dtype=tdtype, device=dev)
                for a, shape in out_shapes.items()}
        with torch.cuda.device(dev):
            rc = launch(*[x.data_ptr() for x in xs.values()],
                        *[o.data_ptr() for o in outs.values()],
                        _cuda.current_stream(dev))
        _cuda.check(lib, rc, f"{p.name} {k.mode}/{k.buffering}")
        LAUNCHES[k.launch_key] += 1
        return outs

    def plain(arrays, device=None):
        return plain_fn(inputs(arrays, device)[1])

    return run, plain


def _fit_shared_memory(p: Program, nests: list[_Nest], plan: _StreamPlan,
                       soft: list[str], dtype: str) -> _StreamPlan:
    """``plan`` at the largest block size up to its own whose windows fit
    one block's shared memory; a smaller block size is recorded in
    ``soft``.  A plan that does not fit even at one row is kept as it is,
    and its launch refuses."""
    esz = 4 if dtype == "float32" else 8

    def need(pl: _StreamPlan) -> int:
        return _smem_layout(pl)[1] * esz

    fitted = plan
    while need(fitted) > _cuda.MAX_SMEM_BYTES and fitted.block_rows > 1:
        fitted, _ = _plan_streamed(p, nests, fitted.block_rows - 1)
    if fitted is plan or need(fitted) > _cuda.MAX_SMEM_BYTES:
        return plan
    soft.append(f"block_rows {plan.block_rows} -> {fitted.block_rows}: the "
                f"windows need {need(plan)} bytes of shared memory at "
                f"{plan.block_rows} rows, more than the "
                f"{_cuda.MAX_SMEM_BYTES} a block has")
    return fitted


def lower_program(p: Program, *, block_rows: Optional[int] = None,
                  buffering: str = "double",
                  dtype: str = "float32") -> CudaKernel:
    """Lower ``p`` to a CUDA kernel (streamed if the chain contract holds,
    whole-array otherwise, where ``buffering`` does not apply and reads
    ``"whole"``); raises :class:`UnlowerableProgram` when the program is
    outside both contracts.  A streamed kernel takes the largest block size
    up to ``block_rows`` whose windows fit one block's shared memory, and
    says so in ``soft_reasons`` when that is smaller."""
    if buffering not in ("double", "single"):
        raise ValueError("buffering must be 'double' or 'single', "
                         f"got {buffering!r}")
    if dtype not in _CTYPES:
        raise ValueError(f"dtype must be one of {sorted(_CTYPES)}, "
                         f"got {dtype!r}")
    # A program whose affine accesses can leave their arrays has no faithful
    # kernel — an out-of-bounds index reads or writes memory the program
    # does not own.  The linter proves the bounds (or the violation)
    # statically; other lint findings stay warnings, but OOB is a hard
    # refusal here.
    from .analysis import lint as _lint
    oob = [d for d in _lint(p) if d.code in ("oob-read", "oob-write")]
    if oob:
        raise UnlowerableProgram(p.name, [
            NestContractViolation(d.code, "codegen",
                                  f"{d.where}: {d.detail}") for d in oob])
    nests, hard = _extract_nests(p)
    if hard:
        raise UnlowerableProgram(p.name, hard)
    if not nests:
        raise UnlowerableProgram(p.name, [NestContractViolation(
            "empty", "codegen", "program has no loop nests")])
    plan, soft = _plan_streamed(p, nests, block_rows or DEFAULT_BLOCK_ROWS)
    if plan is not None:
        plan = _fit_shared_memory(p, nests, plan, soft, dtype)
        src, meta = _emit_streamed(p, plan, dtype)
        inputs = plan.inputs
        out_shapes = {plan.sink.out: (plan.sink.nest.trips[0],
                                      p.arrays[plan.sink.out].shape[1])}

        def plain_fn(xs):
            return streamed_plain(p, plan, xs)
    else:
        wplan = _plan_whole(p, nests)
        src, meta = _emit_whole_cuda(p, wplan, dtype)
        buffering = "whole"
        inputs = wplan.inputs
        out_shapes = {a: p.arrays[a].shape for a in wplan.stored}

        def plain_fn(xs):
            return whole_plain(p, wplan, xs)
    k = CudaKernel(program_name=p.name, mode=meta["mode"],
                   buffering=buffering, source=src, fn=None,
                   outputs=meta["outputs"], grid=meta["grid"],
                   block_rows=meta["block_rows"], halo=meta["halo"],
                   vmem_window_elems=meta["vmem_window_elems"],
                   soft_reasons=soft, dtype=dtype, inputs=tuple(inputs),
                   smem_bytes=meta["smem_bytes"],
                   nest_launches=meta["nest_launches"])
    k.fn, k.plain = _runner(k, p, out_shapes, plain_fn)
    return k


def _point_block_rows(point) -> Optional[int]:
    """block_rows from a design point: the tile pass marks the outer strip
    loop with ``tile_block``; fall back to the LoopTile pass config."""
    blocks = [l.tile_block for l in point.program.loops()
              if getattr(l, "tile_block", None)]
    if blocks:
        return max(blocks)
    from .transforms import LoopTile
    sizes = []
    for ps in point.passes:
        if isinstance(ps, LoopTile):
            sz = ps.seq if ps.seq is not None else tuple(ps.sizes.values())
            sizes.extend(sz)
    return max(sizes) if sizes else None


def emit_cuda(result, point=None, *, buffering: str = "double",
              block_rows: Optional[int] = None,
              dtype: str = "float32") -> CudaKernel:
    """Lower a ``CompileResult`` design point (default: ``result.best``) to
    an executable CUDA kernel.  The tile pass supplies ``block_rows``, the
    fusion log rides along as ``kernel.fusion_shifts`` (the streamed
    window's ``halo`` generalizes the fusion row shift).  Unlowerable
    programs raise :class:`UnlowerableProgram` *and* record a
    ``codegen-unlowerable`` diagnostic on the result."""
    point = point if point is not None else result.best
    if block_rows is None:
        block_rows = _point_block_rows(point)
    try:
        k = lower_program(result.program, block_rows=block_rows,
                          buffering=buffering, dtype=dtype)
    except UnlowerableProgram as e:
        result.diagnostics.append({
            "kind": "codegen-unlowerable", "program": e.program_name,
            "reasons": list(e.reasons),
            "codes": [v.code for v in e.violations]})
        raise
    k.modeled_latency = point.latency
    k.point_desc = point.desc
    k.fusion_shifts = [dict(x) for x in
                       getattr(point.program, "_fusion_log", [])]
    return k
