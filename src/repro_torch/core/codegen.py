"""CUDA codegen backend: lower a scheduled ``Program`` to a kernel for Hopper.

After the DSE picks a design point, this module turns it into an executable
CUDA C++ kernel for ``sm_90a`` (DESIGN.md §10 describes the lowering
contract, which the port keeps).

* **streamed** ("Mode A") — for single-sink producer-consumer chains of
  perfect depth-2 nests (the paper's Fig. 1 shape).  The sink's row loop is
  strip-mined into ``T = ceil(Rout/block_rows)`` row tiles; every producer
  stage computes, per tile, exactly the *window* of its rows the later
  stages consume.  Windows are derived by propagating ``rows [a*t+b,
  a*t+b+sz)`` triples backward through the chain, which generalizes the
  shift-and-peel fusion analysis: a producer's window overhang ``sz - a``
  IS the fusion's row shift (the line buffer's halo) whenever the DSE
  fused that edge.  Intermediates live in the block's shared memory or its
  registers — they never reach device memory.  On the card each row tile
  is cut into ``U`` column tiles as well (the reference tiles rows only),
  column windows derived backward the same way.

  The kernel is the paper's line buffer.  A block walks a run of
  ``CudaKernel.run`` row tiles down one column tile (launch grid: runs x
  column tiles).  Each producer a later stage reads keeps a ring of its
  window's rows in shared memory (``CudaKernel.ring_rows``): a run's first
  tile computes the whole window, each later tile only its ``a`` new rows,
  over the oldest, so the halo rows are computed once a run, not once a
  tile.  Inputs arrive in rings of their own by ``cp.async``, the next
  tile's rows issued before the current tile computes.  Stages that share
  a window and read each other only at their own point form a phase: one
  thread computes all of them for a strip of rows by ``V`` columns, the
  ones no later phase reads in registers only, loading each distinct tap
  once for all the strip's points.  What bounds it is device memory, with
  the SM's issue slots close behind (every op rounds on its own: no FMA).

  - ``buffering="double"`` launches the grid of runs; the card overlaps
    one block's loads with another's compute, and each block its next
    tile's loads with its own.
  - ``buffering="single"`` launches one block that walks every run in
    order — the measurable baseline the gridded variant must beat.

  Both entry points live in one emitted ``.cu`` per program and dtype and
  share the walk, so the two bufferings agree bit for bit.

* **whole-array** ("Mode B") — the generic fallback for the programs the
  streamed contract rejects only *softly* (multi-store nests, strided or
  transposed stores, reads of unwritten regions, several sinks,
  reduction-carrying nests).  Every array is a whole buffer in device
  memory; launches run in program order on one stream (stream order is
  the barrier between them).  A program-order run of elementwise nests
  over one domain shares a ``__global__``, one thread per point, where
  every read of an array the run writes is at the point where the same
  thread wrote it: the value is forwarded in a register, and every
  stored array is still written (``CudaKernel.launch_nests``).  A stored
  array starts as a copy of its input, so uncovered elements keep their
  initial values, exactly like ``sim.sequential_exec``; the copy is
  skipped where the nest's stores cover the whole array between them.
  Partial, strided and transposed accesses are plain index arithmetic.
  Canonical accumulations fold the reduction iv in program order, which
  matches the sequential rounding bit for bit: with two outer ivs
  (``two_mm``) tiled, a block per output tile and k chunks staged in
  shared memory by double-buffered ``cp.async`` (an operand whose rows run
  along k through 16-byte loads into registers, stored transposed)
  (``CudaKernel.tiled_reductions``), else per thread.  Two stores of one
  nest to one array run in one thread where the lowering proves their
  elements disjoint, else one launch per store in op order (the later
  store wins on overlap, as in the reference).

Programs outside both contracts (multi-chain tasks, imperfect nests, loose
top-level ops, non-canonical reductions — the shape vocabulary is
``ir.nest_shape``) raise the structured :class:`UnlowerableProgram`
carrying machine-readable :class:`NestContractViolation` entries;
``CompileResult.emit_cuda`` records the rejection (with its violation
codes) in ``diagnostics``.

The nest extraction and the streamed planner are the reference's,
unchanged, so windows, halos, padding and violation codes equal it by
construction; only the emitter is new, with the column tiles and the runs,
and a streamed block size that shrinks where its rings would not fit one
block's shared memory even at the narrowest column tile.  The
kernel is emitted as *source text* (``CudaKernel.source``, the debuggable
artifact) and built with ``nvcc`` at its first launch.  Arithmetic uses
the round-to-nearest intrinsics (``__fmul_rn``...), so nothing is
contracted into an FMA and the kernel repeats the plain version's
rounding exactly.  Beside each kernel sits its plain version
(``streamed_plain`` walks the same runs and rings, ``whole_plain`` the same
launches, chunks and tails, vectorized over each domain, in PyTorch); a
kernel runs it only for tensors that lie on the CPU.
"""
from __future__ import annotations

import collections
import ctypes
import functools
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


@dataclass
class _ColPlan:
    """The card's column tiling of a streamed plan (the reference tiles rows
    only): a block owns sink rows ``[B*t, B*t+B)`` and sink columns
    ``[cw*u, cw*u+cw)``; each stage computes the domain columns
    ``[ca*u+cb, ca*u+cb+csz)`` of its window (``cols[out] = (ca, cb,
    csz)``), derived backward through the chain as the planner derives
    rows, so each block computes its producers' column overhang (their
    row halo once a run).  ``pad_cols`` edge-pads an input's columns for
    the last, ragged column tile, as ``pad_rows`` does its rows."""

    cw: int
    tiles: int                                # U, column tiles
    cols: dict[str, tuple[int, int, int]]     # stage out -> (ca, cb, csz)
    pad_cols: dict[str, int]


# column tiles tried, widest first; the narrowest decides whether a block
# size fits at all
_COL_TILES = (1024, 512, 256, 128, 64, 32)
# shared memory per block (its rings) the column tile aims under: three
# blocks an SM.  On an H100 at n=4096 the widest tile under it came within
# 6 % of the fastest tile, run and depth swept for every streamed program;
# harris ran 17 % behind a Tensor.copy_ of its input, the others within
# 8 % (PERF.md, K2 sweep)
_SMEM_TARGET = 64 * 1024
# row tiles a block walks down its column tile (R), the one place it is
# set: a run computes its producers' halo rows once, so a longer run
# wastes less, and a shorter one leaves more blocks to fill the 132 SMs.
# On an H100 at n=4096 runs of 16 (256-512 blocks) were the fastest for
# five of the six streamed programs, 4 % behind runs of 8 for conv_pool;
# runs of 32 were 9-31 % slower (PERF.md, K2 sweep)
_RUN_TILES = 16
# tiles of input rows a block keeps in flight ahead of the one it
# computes: one is double buffering; two or three were slower for five of
# the six streamed programs at n=4096 (more shared memory for bytes the
# card already streams at a copy's rate; PERF.md, K2 sweep)
_AHEAD = 1
# rows of a thread's strip, at most: a strip reads each tap of its
# footprint once into a register for all its points, so a taller strip
# reads fewer taps a point and holds more registers
_STRIP_ROWS = 4
# threads a block has at most; below it, as many as one tile's strips
_MAX_THREADS = 512


def _plan_columns(p: Program, plan: _StreamPlan, cw: int) -> _ColPlan:
    """Column windows for sink tiles ``cw`` wide.  A chain whose consumers
    read a producer at a constant column or at incompatible column rates
    takes one full-width tile (each window its producer's whole domain
    width, the reference's layout)."""
    sink = plan.sink
    cout = p.arrays[sink.out].shape[1]
    full = _ColPlan(cw=cout, tiles=1, pad_cols={},
                    cols={s.out: (0, 0, s.nest.trips[1]) if s is not sink
                          else (cout, 0, cout) for s in plan.stages})
    cw = min(cw, cout)
    U = -(-cout // cw)
    cols = {sink.out: (cw, 0, cw)}
    for s in reversed(plan.stages):
        if s is sink:
            continue
        reqs = []       # (consumer's column window, col coef, col const)
        for c in plan.stages:
            for _, acc in c.nest.loads:
                if acc.array == s.out:
                    civ, cc, ck = acc.dims[1]
                    if civ is None:
                        return full
                    reqs.append((cols[c.out], cc, ck))
        rates = {cc * ca for (ca, _, _), cc, _ in reqs}
        if len(rates) > 1:
            return full
        lo = min(cc * cb + ck for (_, cb, _), cc, ck in reqs) - s.c0
        hi = max(cc * (cb + csz - 1) + ck
                 for (_, cb, csz), cc, ck in reqs) - s.c0
        cols[s.out] = (rates.pop(), lo, hi - lo + 1)
    pad_cols: dict[str, int] = {}
    produced = {s.out for s in plan.stages}
    for s in plan.stages:
        ca, cb, csz = cols[s.out]
        for _, acc in s.nest.loads:
            civ, cc, ck = acc.dims[1]
            if acc.array in produced or civ is None:
                continue
            over = (cc * (ca * (U - 1) + cb + csz - 1) + ck
                    - (p.arrays[acc.array].shape[1] - 1))
            if over > 0:
                pad_cols[acc.array] = max(pad_cols.get(acc.array, 0), over)
    return _ColPlan(cw=cw, tiles=U, cols=cols, pad_cols=pad_cols)


@dataclass
class _Block:
    """Rows ``[lo, lo + n)`` of a phase's window, cut into strips of ``h``
    rows: ``tx`` threads take its column groups, ``ty`` its strips."""

    lo: int
    n: int
    h: int
    tx: int = 1
    ty: int = 1


@dataclass
class _Phase:
    """Stages that share one window and read each other only at their own
    point: one thread computes all of them for its strip, between two
    barriers.  ``regs`` are the stages no later phase reads: they live in
    registers only."""

    stages: list
    win: tuple                          # (a, b, sz): rows [a*t+b, +sz)
    cols: tuple                         # (ca, cb, csz)
    pw: int = 0                         # columns computed: csz rounded to V
    regs: set = field(default_factory=set)
    first: Optional[_Block] = None      # the halo rows: a run's first tile
    every: Optional[_Block] = None      # the rows each tile adds


@dataclass
class _Ring:
    """Rows of an array in the block's shared memory: a producer's window
    (``rows`` = its ``win_sz``) or a staged input's window plus the new
    rows of the ``_AHEAD`` tiles after it.  Tile t's window starts at
    domain row ``a*t + b``; domain row d lives in slot ``d % rows``,
    element k of a row at ``off + slot * stride + k``.  A staged input's
    window columns are ``[ca*u + cb, +cols)``."""

    rows: int
    stride: int
    a: int
    b: int
    size: int
    off: int = 0
    ca: int = 0
    cb: int = 0
    cols: int = 0


@dataclass
class _Walk:
    """The card's schedule of a streamed plan: a block walks ``run`` row
    tiles of one column tile; its phases, their rings and staged inputs."""

    run: int
    ahead: int                          # tiles of input rows in flight
    vec: int                            # V: columns a thread takes
    threads: int
    phases: list
    where: dict                         # stage out -> phase index
    rings: dict                         # array -> _Ring
    staged: list                        # inputs staged through a ring
    smem_elems: int


def _esize(dtype: str) -> int:
    return 4 if dtype == "float32" else 8


def _pointwise(s: _StagePlan, acc: _Access, prod: _StagePlan,
               cols: _ColPlan) -> bool:
    """``s`` reads ``prod`` only at its own point (window-relative)."""
    (_, rc, rk), (civ, cc, ck) = acc.dims
    return (civ is not None and rc == cc == 1
            and s.win_b + rk - prod.r0 - prod.win_b == 0
            and cols.cols[s.out][1] + ck - prod.c0
            - cols.cols[prod.out][1] == 0)


def _strip_rows(n: int) -> int:
    """The largest divisor of ``n`` up to ``_STRIP_ROWS``: strips never
    overrun the rows they cut."""
    return max(h for h in range(1, min(n, _STRIP_ROWS) + 1) if n % h == 0)


def _input_window(plan: _StreamPlan, cols: _ColPlan, x: str):
    """``(a, b, rows, ca, cb, columns)`` of input ``x``'s window per tile
    (rows ``[a*t + b, +rows)``, columns ``[ca*u + cb, +columns)``), the
    union of its reads; None where its readers advance at different
    rates."""
    rates, crates, rlo, rhi, clo, chi = set(), set(), [], [], [], []
    for s in plan.stages:
        ca, cb, csz = cols.cols[s.out]
        for _, acc in s.nest.loads:
            if acc.array != x:
                continue
            (_, rc, rk), (civ, cc, ck) = acc.dims
            rates.add(rc * s.win_a)
            rlo.append(rc * s.win_b + rk)
            rhi.append(rc * (s.win_b + s.win_sz - 1) + rk)
            if civ:
                crates.add(cc * ca if cols.tiles > 1 else 0)
                clo.append(cc * cb + ck)
                chi.append(cc * (cb + csz - 1) + ck)
            else:
                crates.add(0)
                clo.append(ck)
                chi.append(ck)
    if len(rates) > 1 or len(crates) > 1:
        return None
    return (rates.pop(), min(rlo), max(rhi) - min(rlo) + 1, crates.pop(),
            min(clo), max(chi) - min(clo) + 1)


def _read_col(s: _StagePlan, acc: _Access, cols: _ColPlan,
              produced: dict, ring: _Ring) -> int:
    """Window-relative column that ``s``'s column 0 reads through ``acc``
    (its column c reads ``cc * c`` past it; a constant column: that one)."""
    civ, cc, ck = acc.dims[1]
    base = cc * cols.cols[s.out][1] if civ else 0
    if acc.array in produced:
        prod = produced[acc.array]
        return base + ck - prod.c0 - cols.cols[prod.out][1]
    return base + ck - ring.cb


def _read_row(s: _StagePlan, acc: _Access, produced: dict,
              ring: _Ring) -> int:
    """Window-relative row that ``s``'s window row 0 reads through ``acc``
    (its row r reads ``rc * r`` past it)."""
    _, rc, rk = acc.dims[0]
    if acc.array in produced:
        prod = produced[acc.array]
        return rc * s.win_b + rk - prod.r0 - prod.win_b
    return rc * s.win_b + rk - ring.b


def _plan_walk(p: Program, plan: _StreamPlan, cols: _ColPlan,
               dtype: str) -> _Walk:
    """Phases, rings, threads and shared memory of ``plan`` walked by
    runs of row tiles on the card."""
    V = 16 // _esize(dtype)
    produced = {s.out: s for s in plan.stages}
    phases: list[_Phase] = []
    where: dict[str, int] = {}
    for s in plan.stages:
        win = (s.win_a, s.win_b, s.win_sz)
        cur = phases[-1] if phases else None
        if (cur is not None and cur.win == win
                and cur.cols == cols.cols[s.out]
                and all(_pointwise(s, acc, produced[acc.array], cols)
                        for _, acc in s.nest.loads
                        if where.get(acc.array) == len(phases) - 1)):
            cur.stages.append(s)
        else:
            phases.append(_Phase(stages=[s], win=win, cols=cols.cols[s.out]))
        where[s.out] = len(phases) - 1
    readers: dict[str, list] = {s.out: [] for s in plan.stages}
    for c in plan.stages:
        for _, acc in c.nest.loads:
            if acc.array in readers:
                readers[acc.array].append(c)
    for ph in phases:
        a, _, sz = ph.win
        ph.pw = -(-ph.cols[2] // V) * V
        ph.regs = {s.out for s in ph.stages if s is not plan.sink
                   and all(where[c.out] == where[s.out]
                           for c in readers[s.out])}
        new = min(a, sz)
        ph.every = _Block(sz - new, new, _strip_rows(new))
        if sz > new:
            ph.first = _Block(0, sz - new, _strip_rows(sz - new))
    items = max(ph.every.n // ph.every.h * (ph.pw // V) for ph in phases)
    threads = min(_MAX_THREADS, max(32, -(-items // 32) * 32))
    for ph in phases:
        for blk in (ph.first, ph.every):
            if blk is not None:
                blk.tx = min(ph.pw // V, threads)
                blk.ty = max(1, min(blk.n // blk.h, threads // blk.tx))
    rings: dict[str, _Ring] = {}
    for ph in phases:
        for s in ph.stages:
            if s is not plan.sink and s.out not in ph.regs:
                rings[s.out] = _Ring(rows=s.win_sz, stride=ph.pw, a=s.win_a,
                                     b=s.win_b, size=s.win_sz)
    staged = []
    for x in plan.inputs:
        w = _input_window(plan, cols, x)
        if w is not None:
            ia, ib, isz, ica, icb, icsz = w
            rings[x] = _Ring(rows=isz + _AHEAD * ia, stride=icsz, a=ia,
                             b=ib, size=isz, ca=ica, cb=icb, cols=icsz)
            staged.append(x)
    # a ring row holds every column its readers touch: a strip loads the
    # aligned V-column chunks covering its taps
    for ph in phases:
        for s in ph.stages:
            for _, acc in s.nest.loads:
                ring = rings.get(acc.array)
                if ring is None or where.get(acc.array) == where[s.out]:
                    continue
                civ, cc, _ = acc.dims[1]
                crel = _read_col(s, acc, cols, produced, ring)
                top = (cc * (ph.pw - V) + ((cc * (V - 1) + crel) // V + 1) * V
                       if civ else crel + 1)
                ring.stride = max(ring.stride, top)
    total = 0
    for ring in rings.values():
        ring.stride = -(-ring.stride // V) * V
        ring.off = total
        total += ring.rows * ring.stride
    return _Walk(run=max(1, min(_RUN_TILES, plan.grid)), ahead=_AHEAD,
                 vec=V, threads=threads, phases=phases, where=where,
                 rings=rings, staged=staged, smem_elems=total)


def _smem_need(p: Program, plan: _StreamPlan, cols: _ColPlan,
               dtype: str) -> int:
    return _plan_walk(p, plan, cols, dtype).smem_elems * _esize(dtype)


def _choose_columns(p: Program, plan: _StreamPlan,
                    dtype: str) -> tuple[_ColPlan, _Walk]:
    """The widest of ``_COL_TILES`` whose rings fit ``_SMEM_TARGET``, or
    the narrowest, with its walk."""
    for cw in _COL_TILES:
        cols = _plan_columns(p, plan, cw)
        walk = _plan_walk(p, plan, cols, dtype)
        if walk.smem_elems * _esize(dtype) <= _SMEM_TARGET:
            break
    return cols, walk


def _emit_block(p: Program, plan: _StreamPlan, cols: _ColPlan, walk: _Walk,
                pi: int, blk: _Block, dtype: str) -> list[str]:
    """One row block of phase ``pi``: each thread walks its strips of
    ``blk.h`` rows by ``V`` columns.  A strip's body is straight-line code
    in which every distinct tap, chunk load and operation appears once (the
    offsets are constants), so a tap read by several of its points is
    loaded once into a register; each point's ops still run in IR order
    and round as the plain version's do."""
    ph = walk.phases[pi]
    V, sink = walk.vec, plan.sink
    fi = 0 if dtype == "float32" else 1
    vtype = "float4" if dtype == "float32" else "double2"
    comp = "xyzw"
    produced = {s.out: s for s in plan.stages}
    a, b, _ = ph.win
    ca, cb, _ = ph.cols
    cout = p.arrays[sink.out].shape[1]

    def access(s, acc, h, v):
        X = acc.array
        (_, rc, rk), (civ, cc, ck) = acc.dims
        if walk.where.get(X) == pi:
            return "reg", (X, h, v), None
        ring = walk.rings.get(X)
        if ring is None:
            return "global", (X, rc, rc * h + rk, cc, cc * v + ck, civ), None
        row = rc * h + _read_row(s, acc, produced, ring)
        crel = _read_col(s, acc, cols, produced, ring)
        if civ:
            x = cc * v + crel
            return "chunk", (X, rc, row, cc, x // V), x % V
        return "abs", (X, rc, row, crel), None

    uses: dict = collections.defaultdict(set)
    for h in range(blk.h):
        for v in range(V):
            for s in ph.stages:
                for _, acc in s.nest.loads:
                    kind, key, e = access(s, acc, h, v)
                    if kind == "chunk":
                        uses[key].add(e)
    body: list[str] = []
    memo: dict = {}
    regs: dict = {}
    count = [0]
    direct = [False]        # an input read from device memory

    def fresh(prefix):
        count[0] += 1
        return f"{prefix}{count[0]}"

    def slot(X, rc, row):
        key = ("slot", X, rc, row)
        if key not in memo:
            rows = walk.rings[X].rows
            nm = memo[key] = fresh("s")
            body.append(f"int {nm} = b_{_ident(X)} + "
                        f"{_affine('r0', rc, row)};")
            body.append(f"if ({nm} >= {rows}) {nm} -= {rows};")
        return memo[key]

    def load(s, acc, h, v):
        kind, key, e = access(s, acc, h, v)
        if kind == "reg":
            return regs[key]
        vector = kind == "chunk" and len(uses[key]) > 1
        if key not in memo:
            nm = memo[key] = fresh("q")
            if kind == "global":
                direct[0] = True
                X, rc, roff, cc, coff, civ = key
                hh, ww = p.arrays[X].shape
                row = _affine("gi", rc, roff)
                if X in plan.pad_rows:
                    row = f"min({row}, {hh - 1})"
                col = _affine("gj", cc, coff) if civ else str(coff)
                if civ and X in cols.pad_cols:
                    col = f"min({col}, {ww - 1})"
                body.append(f"const real {nm} = __ldg(x_{_ident(X)} + "
                            f"(size_t)({row}) * {ww} + {col});")
            else:
                X, rc, row = key[:3]
                ring = walk.rings[X]
                base = f"r_{_ident(X)} + {slot(X, rc, row)} * {ring.stride}"
                if kind == "abs":
                    body.append(f"const real {nm} = ({base})[{key[3]}];")
                elif vector:
                    body.append(f"const {vtype} {nm} = *reinterpret_cast<"
                                f"const {vtype}*>({base} + "
                                f"{_affine('c0', key[3], V * key[4])});")
                else:
                    body.append(f"const real {nm} = ({base})["
                                f"{_affine('c0', key[3], V * key[4] + e)}];")
        return f"{memo[key]}.{comp[e]}" if vector else memo[key]

    for h in range(blk.h):
        row_vals: dict = collections.defaultdict(list)
        for v in range(V):
            for s in ph.stages:
                names: dict[str, str] = {}
                for op in s.nest.ops:
                    if isinstance(op, ConstOp):
                        names[op.result] = _lit(op.value, dtype)
                    elif isinstance(op, LoadOp):
                        acc = next(x for o, x in s.nest.loads if o is op)
                        names[op.result] = load(s, acc, h, v)
                    elif isinstance(op, ArithOp):
                        args = tuple(names[x] for x in op.args)
                        key = ("op", op.fn, args)
                        if key not in memo:
                            memo[key] = fresh("v")
                            body.append(f"const real {memo[key]} = "
                                        + _ARITH_FMT[op.fn][fi].format(*args)
                                        + ";")
                        names[op.result] = memo[key]
                    elif isinstance(op, StoreOp):
                        regs[(s.out, h, v)] = names[op.value]
                        row_vals[s.out].append(names[op.value])
        for s in ph.stages:
            vals = row_vals[s.out]
            if s.out in ph.regs:
                continue
            if s is not sink:
                ring = walk.rings[s.out]
                body.append(f"*reinterpret_cast<{vtype}*>(r_{_ident(s.out)} "
                            f"+ {slot(s.out, 1, h)} * {ring.stride} + c0) = "
                            f"make_{vtype}(" + ", ".join(vals) + ");")
                continue
            o = f"o_{_ident(s.out)}"
            body.append(f"if (r0 + {h} < nrows) {{")
            body.append(f"    const size_t o = (size_t)({_affine('t', a, b)}"
                        f" + r0 + {h}) * {cout} + {cols.cw} * u + c0;")
            if cout % V == 0 and cols.cw % V == 0:
                # rows and column tiles keep V-column groups 16-byte aligned
                body.append(f"    if (c0 < ncols) *reinterpret_cast<{vtype}*>"
                            f"({o} + o) = make_{vtype}(" + ", ".join(vals)
                            + ");")
            else:
                body += [f"    if (c0 + {v} < ncols) {o}[o + {v}] = "
                         f"{vals[v]};" for v in range(V)]
            body.append("}")
    head = [f"// window rows [{blk.lo}, {blk.lo + blk.n}) in strips of "
            f"{blk.h} rows x {V} columns, {blk.tx} x {blk.ty} threads",
            f"if (ty{blk.tx} < {blk.ty}) {{",
            f"    for (int r0 = {blk.lo} + {blk.h} * ty{blk.tx}; r0 < "
            f"{blk.lo + blk.n}; r0 += {blk.h * blk.ty}) {{",
            f"        for (int c0 = {V} * tx{blk.tx}; c0 < {ph.pw}; "
            f"c0 += {V * blk.tx}) {{"]
    if direct[0]:
        head.append(f"            const int gi = {_affine('t', a, b)} + r0, "
                    f"gj = {_affine('u', ca, cb)} + c0;")
    return head + ["            " + x for x in body] + ["        }", "    }",
                                                        "}"]


_STREAM_CP_ASYNC = r"""// ---- cp.async
// Copy `src_bytes` (0..N) bytes from src to shared memory at dst and fill
// the rest of the N with zeros, asynchronously (dst and src N-aligned).
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    if constexpr (N == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                     :: "r"(d), "l"(src), "n"(N), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most N of this thread's latest groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory"); }
// ---- end cp.async

// Copy `bytes` (up to `valid` of them real, zeros after) from src to dst in
// pieces of N, the lanes of a warp taking every 32nd piece.
template <int N>
__device__ __forceinline__ void copy_row(char* dst, const char* src, int bytes, int valid, int lane) {
    for (int j = N * lane; j < bytes; j += 32 * N) {
        const int vb = min(max(valid - j, 0), N);
        cp_async<N>(dst + j, vb ? src + j : src, vb);
    }
}
"""


def _emit_stage_input(p: Program, x: str, ring: _Ring, threads: int,
                      dtype: str) -> list[str]:
    """``stage_<x>``: start the copies of rows ``[lo, lo + n)`` of a tile's
    window of input ``x`` into its ring, a warp a row, in the widest pieces
    the row's first address allows (16, 8 or 4 bytes: an odd row stride
    leaves every other row 8-byte aligned), zeros past the array's edge."""
    h, w = p.arrays[x].shape
    E = _esize(dtype)
    pieces = (16, 8, 4) if E == 4 else (16, 8)
    lines = [
        f"__device__ __forceinline__ void stage_{_ident(x)}(const real* "
        "__restrict__ x, real* ring, int d0, int slot0, int col0, int lo, "
        "int n) {",
        "    const int lane = threadIdx.x & 31;",
        f"    for (int k = threadIdx.x >> 5; k < n; k += {threads // 32}) {{",
        "        const int d = d0 + lo + k;",
        "        int sl = slot0 + lo + k;",
        f"        if (sl >= {ring.rows}) sl -= {ring.rows};",
        f"        char* dst = reinterpret_cast<char*>(ring + sl * "
        f"{ring.stride});",
        f"        const char* src = reinterpret_cast<const char*>(x + "
        f"(size_t)min(d, {h - 1}) * {w} + col0);",
        f"        const int valid = d < {h} ? max(0, min({w} - col0, "
        f"{ring.cols})) * {E} : 0;",
        "        const unsigned al = (unsigned)(size_t)src & 15u;",
        "        const int bytes = al ? (int)(al & (0u - al)) : 16;",
    ]
    for i, n in enumerate(pieces):
        cond = (f"if (bytes == {n}) " if i == 0 else "else "
                if i == len(pieces) - 1 else f"else if (bytes == {n}) ")
        lines.append(f"        {cond}copy_row<{n}>(dst, src, "
                     f"{ring.cols * E}, valid, lane);")
    lines += ["    }", "}", ""]
    return lines


def _emit_streamed(p: Program, plan: _StreamPlan, cols: _ColPlan,
                   walk: _Walk, dtype: str) -> tuple[str, dict]:
    B, T = plan.block_rows, plan.grid
    CW, U = cols.cw, cols.tiles
    R, NT = walk.run, walk.threads
    runs = -(-T // R)
    sink = plan.sink
    cout = p.arrays[sink.out].shape[1]
    rout = sink.nest.trips[0]
    E = _esize(dtype)

    body = [f"real* const r_{_ident(a)} = smem + {r.off};"
            for a, r in walk.rings.items()]
    body += [f"const int t0 = run * {R}, t1 = min(t0 + {R}, {T});",
             f"const int ncols = min({CW}, {cout} - {CW} * u);"]
    txs = sorted({blk.tx for ph in walk.phases
                  for blk in (ph.first, ph.every) if blk is not None})
    body += [f"const int tx{tx} = threadIdx.x % {tx}, ty{tx} = threadIdx.x "
             f"/ {tx};" for tx in txs]
    body += [f"int b_{_ident(a)} = ({_affine('t0', r.a, r.b)}) % {r.rows};"
             for a, r in walk.rings.items()]
    col0 = {x: f"{_affine('u', walk.rings[x].ca, walk.rings[x].cb)}"
            for x in walk.staged}
    body.append("__syncthreads();  // this block's last walk is done with "
                "the rings")
    D = walk.ahead

    def stage_new(tile_expr, k):
        """Start the copies of the new input rows of tile ``t + k`` (k
        tiles past the one whose ring base ``b_x`` holds)."""
        out = []
        for x in walk.staged:
            r = walk.rings[x]
            new = min(r.a, r.size)
            out += [f"{{ int nb = b_{_ident(x)} + {k * r.a % r.rows};",
                    f"  if (nb >= {r.rows}) nb -= {r.rows};",
                    f"  stage_{_ident(x)}(x_{_ident(x)}, r_{_ident(x)}, "
                    f"{_affine(tile_expr, r.a, r.b)}, nb, {col0[x]}, "
                    f"{r.size - new}, {new}); }}"]
        return out

    body.append("// the first tile's whole input windows"
                + (f", then the new rows of the {D - 1} after it"
                   if D > 1 else ""))
    body += [f"stage_{_ident(x)}(x_{_ident(x)}, r_{_ident(x)}, "
             f"{_affine('t0', walk.rings[x].a, walk.rings[x].b)}, "
             f"b_{_ident(x)}, {col0[x]}, 0, {walk.rings[x].size});"
             for x in walk.staged]
    body.append("cp_async_commit();")
    for k in range(1, D):
        body.append(f"if (t0 + {k} < t1) {{")
        body += ["    " + x for x in stage_new(f"(t0 + {k})", k)]
        body += ["}", "cp_async_commit();"]
    tile = [f"cp_async_wait<{D - 1}>();",
            "__syncthreads();  // tile t's input rows have landed; tile t-1 "
            "is done with every ring"]
    if walk.staged:
        tile.append(f"if (t + {D} < t1) {{  // new input rows {D} tiles "
                    "ahead, in flight while this tile computes")
        tile += ["    " + x for x in stage_new(f"(t + {D})", D)]
        tile.append("}")
    tile.append("cp_async_commit();")
    for pi, ph in enumerate(walk.phases):
        names = ", ".join(f"'{s.out}'" + (" (registers)" if s.out in ph.regs
                                          else "") for s in ph.stages)
        a, b_, sz = ph.win
        ca, cb, csz = ph.cols
        tile.append(f"// phase {pi}: {names}; domain rows [{a}*t+{b_}, "
                    f"+{sz}), columns [{ca}*u+{cb}, +{csz})")
        if plan.sink in ph.stages:
            tile.append(f"const int nrows = min({B}, {rout} - {B} * t);")
        if ph.first is not None:
            tile.append("if (t == t0) {  // the halo rows, once a run")
            tile += ["    " + x for x in _emit_block(p, plan, cols, walk, pi,
                                                     ph.first, dtype)]
            tile.append("}")
        tile.append("{")
        tile += ["    " + x for x in _emit_block(p, plan, cols, walk, pi,
                                                 ph.every, dtype)]
        tile.append("}")
        if pi < len(walk.phases) - 1:
            tile.append("__syncthreads();")
    for a_, r in walk.rings.items():
        if r.a % r.rows:
            tile += [f"b_{_ident(a_)} += {r.a % r.rows};",
                     f"if (b_{_ident(a_)} >= {r.rows}) b_{_ident(a_)} -= "
                     f"{r.rows};"]
    body.append(f"for (int t = t0; t < t1; ++t) {{")
    body += ["    " + x for x in tile] + ["}"]

    ins = [f"const real* __restrict__ x_{_ident(a)}" for a in plan.inputs]
    outp = f"real* __restrict__ o_{_ident(sink.out)}"
    args = [f"x_{_ident(a)}" for a in plan.inputs] + [f"o_{_ident(sink.out)}"]
    cargs = ([f"const void* x_{_ident(a)}" for a in plan.inputs]
             + [f"void* o_{_ident(sink.out)}", "void* stream"])
    casts = ([f"(const real*)x_{_ident(a)}" for a in plan.inputs]
             + [f"(real*)o_{_ident(sink.out)}"])
    rings = "; ".join(f"{a} {r.rows} rows" for a, r in walk.rings.items())
    lines = [
        "// Generated by repro_torch.core.codegen — do not edit.",
        f"// program '{p.name}': streamed (Mode A), block_rows={B}, {T} row "
        f"tiles in runs of {R} x {U} column tiles of {CW}, {dtype}, {NT} "
        "threads.",
        "// Replaces the Pallas kernel that repro.core.codegen._emit_streamed"
        " emits.",
        "// Bound: device memory (each input read once, the sink written "
        "once), and close",
        "// behind it the SM's issue slots: every op rounds on its own (the "
        "_rn intrinsics,",
        "// no FMA), so the arithmetic alone takes most of the bytes' time.",
        "// Design: the paper's line buffer.  A block walks a run of row "
        "tiles of one",
        "// column tile top to bottom.  Each producer keeps a ring of its "
        "window's rows in",
        "// shared memory: a run's first tile computes the whole window, "
        "each later tile",
        "// only its new rows, over the oldest, so halo rows are computed "
        "once a run.",
        "// Inputs arrive in rings of their own by cp.async (L1 bypassed), "
        "the next tile's",
        "// rows issued before this tile computes.  A thread computes a "
        "strip of rows by",
        "// V columns of a phase, loading each distinct tap once into a "
        "register for all",
        "// its points; stages read only at their own point are computed in "
        "registers by",
        "// the thread of their producer, with no ring and no barrier.  "
        "Each point's ops",
        "// run in IR order, rounding as the plain version's do, so the two "
        "agree bit for",
        f"// bit.  Rings: {rings}.",
        "#include <cuda_runtime.h>",
        "",
        f"typedef {_CTYPES[dtype]} real;",
        f"constexpr int SMEM_BYTES = {walk.smem_elems * E};",
        "",
        _STREAM_CP_ASYNC,
    ]
    for x in walk.staged:
        lines += _emit_stage_input(p, x, walk.rings[x], NT, dtype)
    lines += [
        "__device__ __forceinline__ void walk(const int run, const int u, "
        + ", ".join(ins + [outp, "real* __restrict__ smem"]) + ") {",
    ]
    lines += ["    " + x for x in body]
    lines += [
        "}",
        "",
        f"__global__ void __launch_bounds__({NT}) "
        "streamed_double(" + ", ".join(ins + [outp]) + ") {",
        "    extern __shared__ __align__(16) unsigned char smem_raw[];",
        "    walk(blockIdx.y, blockIdx.x, " + ", ".join(args)
        + ", reinterpret_cast<real*>(smem_raw));",
        "}",
        "",
        "// the serial baseline: one block walks every run in order",
        f"__global__ void __launch_bounds__({NT}) "
        "streamed_single(" + ", ".join(ins + [outp]) + ") {",
        "    extern __shared__ __align__(16) unsigned char smem_raw[];",
        f"    for (int run = 0; run < {runs}; ++run)",
        f"        for (int u = 0; u < {U}; ++u)",
        "            walk(run, u, " + ", ".join(args)
        + ", reinterpret_cast<real*>(smem_raw));",
        "}",
        "",
    ]
    for buf, grid in (("double", f"dim3({U}, {runs})"), ("single", "1")):
        lines += [
            f'extern "C" int launch_{buf}(' + ", ".join(cargs) + ") {",
            "    if (SMEM_BYTES > 48 * 1024) {",
            f"        cudaError_t err = cudaFuncSetAttribute(streamed_{buf}, "
            "cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);",
            "        if (err != cudaSuccess) return (int)err;",
            "    }",
            f"    streamed_{buf}<<<{grid}, {NT}, SMEM_BYTES, "
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
            "smem_bytes": walk.smem_elems * E, "col_tile": CW,
            "launch_grid": (runs, U), "run": R, "threads": NT,
            "ring_rows": {a: r.rows for a, r in walk.rings.items()
                          if a not in walk.staged},
            "nest_launches": 1,
            "launch_nests": (tuple(s.nest.loop.ivname for s in plan.stages),),
            "tiled_reductions": ()}
    return "\n".join(lines) + "\n", meta


# ---------------------------------------------------------------------------
# The plain version: the same runs and rings, in PyTorch
# ---------------------------------------------------------------------------


def _edge_pad(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    if rows:
        x = torch.cat([x, x[-1:].expand(rows, -1)])
    if cols:
        x = torch.cat([x, x[:, -1:].expand(-1, cols)], dim=1)
    return x.contiguous()


def streamed_plain(p: Program, plan: _StreamPlan, cols: _ColPlan, run: int,
                   xs: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """K2's plain version: the kernel's schedule, all column tiles at once
    (a ring is held as (rows, column tiles, columns)).  It walks runs of
    ``run`` row tiles; every stage keeps a ring of its window's rows, domain
    row d in slot ``d % win_sz``: a run's first tile computes the whole
    window, a later tile only its new rows, into the slots the kernel uses,
    one PyTorch op per IR op.  Inputs are edge-padded, the output trimmed.
    Same windows, halos and op order as the kernel, so it agrees with the
    kernel bit for bit on the card and with ``sim.sequential_exec`` in
    float64."""
    B, T = plan.block_rows, plan.grid
    CW, U = cols.cw, cols.tiles
    sink = plan.sink
    cout = p.arrays[sink.out].shape[1]
    rout = sink.nest.trips[0]
    produced = {s.out: s for s in plan.stages}
    some = next(iter(xs.values()))
    dtype, dev = some.dtype, some.device
    padded = {a: _edge_pad(xs[a], plan.pad_rows.get(a, 0),
                           cols.pad_cols.get(a, 0)) for a in plan.inputs}
    consts: dict[float, torch.Tensor] = {}
    rings = {s.out: torch.empty((s.win_sz, U, cols.cols[s.out][2]),
                                dtype=dtype, device=dev)
             for s in plan.stages if s is not sink}
    out = torch.empty((T * B, U * CW), dtype=dtype, device=dev)

    idx: dict[tuple, torch.Tensor] = {}

    def slots(s, t, lo, n):
        """Ring slots of window rows [lo, lo + n) of stage s at tile t (a
        window starts at one of win_sz slots: each index built once)."""
        key = (s.out, (s.win_a * t + s.win_b + lo) % s.win_sz, n)
        if key not in idx:
            idx[key] = (torch.arange(key[1], key[1] + n, device=dev)
                        % s.win_sz)
        return idx[key]

    for t0 in range(0, T, run):
        for t in range(t0, min(t0 + run, T)):
            win: dict[str, torch.Tensor] = {}   # a ring in window order
            for s in plan.stages:
                ca, cb, csz = cols.cols[s.out]
                lo = 0 if t == t0 else s.win_sz - min(s.win_a, s.win_sz)
                n = s.win_sz - lo
                names: dict[str, torch.Tensor] = {}
                val = None
                for op in s.nest.ops:
                    if isinstance(op, ConstOp):
                        if op.value not in consts:
                            consts[op.value] = torch.tensor(
                                op.value, dtype=dtype, device=dev)
                        names[op.result] = consts[op.value]
                    elif isinstance(op, LoadOp):
                        acc = next(a for o, a in s.nest.loads if o is op)
                        (_, rc, rk), (civ, cc, ck) = acc.dims
                        if acc.array in produced:
                            prod = produced[acc.array]
                            if acc.array not in win:
                                win[acc.array] = rings[acc.array][
                                    slots(prod, t, 0, prod.win_sz)]
                            r0 = (rc * (s.win_b + lo) + rk - prod.r0
                                  - prod.win_b)
                            c0 = ((cc * cb if civ else 0) + ck - prod.c0
                                  - cols.cols[prod.out][1])
                            csel = (slice(c0, c0 + cc * (csz - 1) + 1, cc)
                                    if civ else slice(c0, c0 + 1))
                            names[op.result] = win[acc.array][
                                r0:r0 + rc * (n - 1) + 1:rc, :, csel]
                        else:
                            src = padded[acc.array]
                            r0 = rc * (s.win_a * t + s.win_b + lo) + rk
                            rs = src.stride(0)
                            if civ:
                                # (rows, column tiles, columns): column c of
                                # tile u reads cc * (ca*u + cb + c) + ck
                                names[op.result] = src.as_strided(
                                    (n, U, csz), (rc * rs, cc * ca, cc),
                                    src.storage_offset() + r0 * rs
                                    + cc * cb + ck)
                            else:
                                names[op.result] = src[
                                    r0:r0 + rc * (n - 1) + 1:rc,
                                    ck:ck + 1][:, None]
                    elif isinstance(op, ArithOp):
                        names[op.result] = _TORCH_FNS[op.fn](
                            *(names[a] for a in op.args))
                    elif isinstance(op, StoreOp):
                        val = names[op.value]
                if s is sink:
                    out[B * t:B * t + B] = val.expand(B, U, CW).reshape(
                        B, U * CW)
                else:
                    rings[s.out][slots(s, t, lo, n)] = val.expand(n, U, csz)
    return {sink.out: out[:rout, :cout]}


# ---------------------------------------------------------------------------
# Mode B: the whole-array plan
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class _Tile:
    """A reduction nest's tiled form: a block owns a ``bm`` x ``bn`` tile of
    the output domain and each of its threads a ``tm`` x ``tn`` micro-tile;
    the block walks the reduction iv in chunks of ``bk``."""

    bm: int
    bn: int
    bk: int
    tm: int
    tn: int


# 16 x 16 threads either way; a float64 accumulator takes two registers.
# k chunks of 16 halve the barriers per k step against 8 (faster on the
# H100, PERF.md)
_TILES = {"float32": _Tile(128, 128, 16, 8, 8),
          "float64": _Tile(64, 64, 16, 4, 4)}
# a staged row's padding: keeps rows 16-byte aligned and a warp's
# transposing copies on distinct banks
_TILE_PAD = {"float32": 4, "float64": 2}
_STATIC_SMEM = 48 * 1024


@dataclass
class _Launch:
    """One ``__global__`` of a whole-array kernel: the nests it runs
    (indices into the plan's nests, program order), the uids of the stores
    it writes, and the tiled form of a reduction nest where it has one."""

    nests: list
    stores: set
    tile: Optional[_Tile] = None


@dataclass
class _WholePlan:
    nests: list[_Nest]
    stored: list[str]           # every stored array, first-store order
    writer: dict[str, int]      # stored array -> index of its (one) nest
    copied: list[str]           # stored arrays their stores do not cover
    inputs: list[str]           # arrays the kernel reads, program order
    launches: list[_Launch]     # in program order


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


def _at(nest: _Nest, acc: _Access) -> tuple:
    """The element ``acc`` addresses, with the nest's ivs renamed by
    position: nests that share a launch share each point of its domain, so
    two accesses of theirs meet on one element where these agree."""
    return (acc.array, *((None if ivn is None else nest.ivs.index(ivn), c, k)
                         for ivn, c, k in acc.dims))


def _joins(nests: list[_Nest], group: list[int], ni: int) -> bool:
    """Nest ``ni`` (elementwise, its stores disjoint) may run in the launch
    of the nests ``group``: the same domain, every read of an array the
    group writes at the point where the same thread wrote it (so the value
    is forwarded in a register), and no array it writes read by the group
    at another point."""
    nest = nests[ni]
    if nest.trips != nests[group[0]].trips:
        return False
    written: dict[str, set] = collections.defaultdict(set)
    for g in group:
        for _, acc in nests[g].stores:
            written[acc.array].add(_at(nests[g], acc))
    if any(acc.array in written and _at(nest, acc) not in written[acc.array]
           for _, acc in nest.loads):
        return False
    mine: dict[str, set] = collections.defaultdict(set)
    for _, acc in nest.stores:
        mine[acc.array].add(_at(nest, acc))
    return not any(acc.array in mine and _at(nests[g], acc)
                   not in mine[acc.array]
                   for g in group for _, acc in nests[g].loads)


def _staged(nest: _Nest) -> dict:
    """A reduction nest's loads that depend on its reduction iv ``k``,
    once per element they address: ``(array, dims) -> kind``.  A tiled
    block stages each per k chunk: ``"i"`` (k and the first outer iv, as
    ``[k][i]``), ``"j"`` (k and the second, as ``[k][j]``) or ``"k"`` (k
    alone).  Rank <= 2 and one iv per dim leave no other kind."""
    i, j, k = nest.ivs
    out: dict = {}
    for op, acc in nest.loads:
        used = {d[0] for d in acc.dims}
        if op.uid in nest.red_loads or k not in used:
            continue
        out.setdefault((acc.array, tuple(acc.dims)),
                       "i" if i in used else "j" if j in used else "k")
    return out


def _stage_elems(t: _Tile, kind: str, dtype: str) -> int:
    """One buffer of a staged load, in elements (padded rows)."""
    return t.bk * (1 if kind == "k"
                   else (t.bm if kind == "i" else t.bn) + _TILE_PAD[dtype])


def _tiling(nest: _Nest, dtype: str) -> Optional[_Tile]:
    """The tiled form of a reduction nest with two outer ivs, where its
    staged loads, double-buffered, fit a block's static shared memory; None
    keeps the per-point fold."""
    if nest.red_iv is None or len(nest.ivs) != 3:
        return None
    t = _TILES[dtype]
    esz = 4 if dtype == "float32" else 8
    if sum(2 * _stage_elems(t, kind, dtype) * esz
           for kind in _staged(nest).values()) > _STATIC_SMEM:
        return None
    return t


def _plan_whole(p: Program, nests: list[_Nest], dtype: str) -> _WholePlan:
    stored: list[str] = []
    writer: dict[str, int] = {}
    full: set = set()
    launches: list[_Launch] = []
    group: Optional[_Launch] = None     # the open group of elementwise nests
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
        uids = {op.uid for op, _ in nest.stores}
        if (nest.red_iv is None and not overlap and group is not None
                and _joins(nests, group.nests, ni)):
            group.nests.append(ni)
            group.stores |= uids
            continue
        group = None
        if nest.red_iv is not None:
            launches.append(_Launch([ni], uids, _tiling(nest, dtype)))
        elif overlap:
            # stores that may overlap run one launch each, in op order, so
            # the later store wins as it does in the reference
            launches += [_Launch([ni], {op.uid}) for op, _ in nest.stores]
        else:
            group = _Launch([ni], uids)
            launches.append(group)
    copied = [a for a in stored if a not in full]
    read = set(copied)
    for ni, nest in enumerate(nests):
        for _, acc in nest.loads:
            if writer.get(acc.array, ni) >= ni:
                read.add(acc.array)   # the input's value (incl. the carry)
    return _WholePlan(nests=nests, stored=stored, writer=writer,
                      copied=copied, inputs=[a for a in p.arrays if a in read],
                      launches=launches)


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

_CP_ASYNC = """\
// cp.async: a copy from device to shared memory that runs beside the
// arithmetic; nbytes below the copy's size fills the rest with zeros (0
// reads nothing)
__device__ __forceinline__ void cp_async_elem(real* dst, const real* src,
                                              int nbytes) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], ESZ, %2;\\n"
                 :: "r"(s), "l"(src), "r"(nbytes) : "memory");
}
__device__ __forceinline__ void cp_async_16(real* dst, const real* src,
                                            int nbytes) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\\n"
                 :: "r"(s), "l"(src), "r"(nbytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\\n" :: "n"(N) : "memory");
}
"""


class _Params:
    """A kernel's pointer parameters, in first-use order, and which of them
    it writes."""

    def __init__(self):
        self.names: list[str] = []
        self.written: set = set()

    def __call__(self, kind: str, array: str, store: bool = False) -> str:
        name = f"{kind}_{_ident(array)}"
        if name not in self.names:
            self.names.append(name)
        if store:
            self.written.add(name)
        return name

    def decl(self) -> str:
        return ", ".join(("real* " if n in self.written else "const real* ")
                         + f"__restrict__ {n}" for n in self.names)


def _decode_point(ivs: list[str], trips: list[int], var: dict) -> list[str]:
    """The ivs of flat point ``pt`` of a domain, row-major."""
    out = []
    for k, ivn in enumerate(ivs):
        rest = math.prod(trips[k + 1:])
        idx = "pt" if rest == 1 else f"pt / {rest}"
        if k > 0:
            idx = f"({idx}) % {trips[k]}"
        out.append(f"const int {var[ivn]} = (int)({idx});")
    return out




def _point_ops(nest: _Nest, dtype: str, pre: str, load: Callable,
               store: Callable) -> list[str]:
    """The nest's ops as C statements for one point, arithmetic values named
    with the prefix ``pre``.  ``load(op, acc)`` gives a load's value as
    ``(expression, declarations)``, ``store(op, acc, value)`` a store's
    statements."""
    fi = 0 if dtype == "float32" else 1
    accs = {o.uid: a for o, a in nest.loads + nest.stores}
    names: dict[str, str] = {}
    out = []
    for op in nest.ops:
        if isinstance(op, ConstOp):
            names[op.result] = _lit(op.value, dtype)
        elif isinstance(op, LoadOp):
            names[op.result], decl = load(op, accs[op.uid])
            out += decl
        elif isinstance(op, ArithOp):
            names[op.result] = pre + _vname(op.result)
            out.append(f"const real {names[op.result]} = "
                       + _ARITH_FMT[op.fn][fi].format(
                           *(names[a] for a in op.args)) + ";")
        elif isinstance(op, StoreOp):
            out += store(op, accs[op.uid], names[op.value])
    return out


def _group_body(p: Program, plan: _WholePlan, launch: _Launch, dtype: str,
                ptr: _Params) -> list[str]:
    """One point of a launch's elementwise nests, in program order.  A read
    of an array that an earlier nest of the launch wrote (at this point: the
    grouping rule) takes the stored value from its register."""
    trips = plan.nests[launch.nests[0]].trips
    fwd: dict[tuple, str] = {}    # _at of a store -> the value it stored
    body = []
    for ni in launch.nests:
        nest = plan.nests[ni]
        pre = f"n{ni}_"
        var = {ivn: f"{pre}iv_{_ident(ivn)}" for ivn in nest.ivs}

        def load(op, acc, nest=nest, ni=ni, var=var, pre=pre):
            at = _at(nest, acc)
            if at in fwd:
                return fwd[at], []
            name = pre + _vname(op.result)
            src = ptr(_load_src(plan, ni, acc.array), acc.array)
            return name, [f"const real {name} = {src}["
                          + _c_index(acc, p.arrays[acc.array].shape, var)
                          + "];"]

        def store(op, acc, value, nest=nest, var=var):
            if op.uid not in launch.stores:
                return []
            fwd[_at(nest, acc)] = value
            return [f"{ptr('o', acc.array, store=True)}["
                    + _c_index(acc, p.arrays[acc.array].shape, var)
                    + f"] = {value};"]

        if len(launch.nests) > 1:
            body.append(f"// nest {nest.loop.ivname}")
        body += _decode_point(nest.ivs, trips, var)
        body += _point_ops(nest, dtype, pre, load, store)
    return body


def _reduction_body(p: Program, plan: _WholePlan, ni: int, dtype: str,
                    ptr: _Params) -> list[str]:
    """One point of a reduction nest's per-point form: the thread folds the
    reduction iv from the input's value, in program order."""
    nest = plan.nests[ni]
    var = {ivn: f"iv_{_ident(ivn)}" for ivn in nest.ivs}

    def load(op, acc):
        if op.uid in nest.red_loads:
            return "acc", []
        name = _vname(op.result)
        src = ptr(_load_src(plan, ni, acc.array), acc.array)
        return name, [f"const real {name} = {src}["
                      + _c_index(acc, p.arrays[acc.array].shape, var) + "];"]

    inner = _point_ops(nest, dtype, "", load,
                       lambda op, acc, value: [f"acc = {value};"])
    (_, sacc), = nest.stores
    at = _c_index(sacc, p.arrays[sacc.array].shape, var)
    rv = var[nest.red_iv]
    return _decode_point(nest.ivs[:-1], nest.trips[:-1], var) + [
        f"real acc = {ptr('x', sacc.array)}[{at}];"
        "  // the carry starts at the input's value",
        f"for (int {rv} = 0; {rv} < {nest.trips[-1]}; ++{rv}) {{",
        *("    " + x for x in inner),
        "}",
        f"{ptr('o', sacc.array, store=True)}[{at}] = acc;"]


def _tiled_kernel(p: Program, plan: _WholePlan, ni: int, t: _Tile,
                  dtype: str, kname: str,
                  ptr: _Params) -> tuple[list[str], int, int]:
    """A reduction nest's tiled ``__global__``: (its text, blocks, bytes of
    shared memory).  Block b owns output tile (b / tiles across, b % tiles
    across); thread (ty, tx) of 16 x 16 owns rows ``ty * V + {0..V-1}`` of
    each half of the tile's rows, likewise columns (V = tm / 2: one 128-bit
    shared load per half).  k walks in chunks of ``t.bk``: each
    k-dependent load's chunk is copied to shared memory with cp.async, the
    next chunk's copy in flight while this one's arithmetic runs.  A load
    whose rows run along k (``A[i, k]``, staged transposed) is read by
    16-byte loads into registers before the chunk's arithmetic instead and
    stored transposed after it.  Loads that do not depend on k are read
    once into registers.  Every point
    folds k in program order with the nest's own ops; points past the
    domain's edge compute on zero-filled copies and are not stored, and
    the last chunk runs only over the k that exist."""
    nest = plan.nests[ni]
    i, j, k = nest.ivs
    M, N, K = nest.trips
    esz = 4 if dtype == "float32" else 8
    ve = 16 // esz                      # elements per 16-byte copy
    V = t.tm // 2
    vt = "float4" if dtype == "float32" else "double2"
    pad = _TILE_PAD[dtype]
    ntj = -(-N // t.bn)
    nch = -(-K // t.bk)
    nfull, tail = divmod(K, t.bk)
    var = {ivn: f"iv_{_ident(ivn)}" for ivn in nest.ivs}
    row = f"i0 + (r / {V}) * {t.bm // 2} + ty * {V} + r % {V}"
    col = f"j0 + (c / {V}) * {t.bn // 2} + tx * {V} + c % {V}"
    staged = _staged(nest)
    sid = {key: f"s{n}" for n, key in enumerate(staged)}
    smem = sum(2 * _stage_elems(t, kind, dtype) * esz
               for kind in staged.values())

    top, stage, a16, fetch, put = [], [], [], [], []
    for key, kind in staged.items():
        array, dims = key
        acc = _Access(array, list(dims))
        s = sid[key]
        src = ptr(_load_src(plan, ni, array), array)
        idx = _c_index(acc, p.arrays[array].shape, var)
        if kind == "k":
            top.append(f"__shared__ __align__(16) real {s}[2][{t.bk}];"
                       f"  // '{array}' at k")
            stage += [
                f"if (tid < {t.bk}) {{",
                f"    const int {var[k]} = kc + tid;",
                f"    const bool ok = {var[k]} < {K};",
                f"    cp_async_elem(&{s}[buf][tid], ok ? &{src}[{idx}] : "
                f"{src}, ok ? {esz} : 0);",
                "}"]
            continue
        x, X, bx, x0 = ((i, M, t.bm, "i0") if kind == "i"
                        else (j, N, t.bn, "j0"))
        top.append(f"__shared__ __align__(16) real {s}[2][{t.bk}]"
                   f"[{bx + pad}];  // '{array}' at k and {kind}, as [k][{kind}]")
        shape = p.arrays[array].shape
        kfast = dims[-1][0] == k
        if (kfast and dims[-1][1] == 1 and dims[-1][2] % ve == 0
                and shape[-1] % ve == 0):
            # rows along k: 16-byte loads (ve k of one x a thread, rows
            # aligned) into registers, held across the chunk's arithmetic
            # and stored transposed after it; elementwise at the edges
            per = t.bk // ve                # loads across a row's chunk
            nv, rest = divmod(t.bk * bx, _WHOLE_THREADS * ve)
            assert nv and not rest, (t, dtype)
            reg = "r_" + s
            a16.append(f"const bool a16_{s} = "
                       f"(reinterpret_cast<size_t>({src}) & 15) == 0;")
            top.append(f"{vt} {reg}[{nv}];  // '{array}': the next chunk")
            comps = "xyzw"[:ve]
            fetch += [
                "#pragma unroll",
                f"for (int v = 0; v < {nv}; ++v) {{",
                f"    const int e = tid + {_WHOLE_THREADS} * v, "
                f"xx = e / {per}, kq = (e % {per}) * {ve};",
                f"    const int {var[k]} = kc + kq, {var[x]} = {x0} + xx;",
                f"    if (a16_{s} && {var[x]} < {X} && {var[k]} + {ve} <= {K}) "
                "{",
                f"        {reg}[v] = *reinterpret_cast<const {vt}*>(&{src}"
                f"[{idx}]);",
                "    } else {",
                *(f"        {reg}[v].{q} = {var[x]} < {X} && {var[k]} + {n} < "
                  f"{K} ? {src}[{idx} + {n}] : (real)0;"
                  for n, q in enumerate(comps)),
                "    }",
                "}"]
            put += [
                "#pragma unroll",
                f"for (int v = 0; v < {nv}; ++v) {{",
                f"    const int e = tid + {_WHOLE_THREADS} * v, "
                f"xx = e / {per}, kq = (e % {per}) * {ve};",
                *(f"    {s}[buf][kq + {n}][xx] = {reg}[v].{q};"
                  for n, q in enumerate(comps)),
                "}"]
            continue
        # consecutive threads copy consecutive addresses of device memory
        kk, xx = ((f"e % {t.bk}", f"e / {t.bk}") if kfast
                  else (f"e / {bx}", f"e % {bx}"))
        elem = [
            f"for (int e = tid; e < {t.bk * bx}; e += {_WHOLE_THREADS}) {{",
            f"    const int kk = {kk}, xx = {xx};",
            f"    const int {var[k]} = kc + kk, {var[x]} = {x0} + xx;",
            f"    const bool ok = {var[k]} < {K} && {var[x]} < {X};",
            f"    cp_async_elem(&{s}[buf][kk][xx], ok ? &{src}[{idx}] : "
            f"{src}, ok ? {esz} : 0);",
            "}"]
        if (not kfast and dims[-1][:2] == (x, 1) and dims[-1][2] % ve == 0
                and shape[-1] % ve == 0):
            # a row of the chunk is contiguous in device memory: 16-byte
            # copies where the array's pointer is 16-byte aligned
            a16.append(f"const bool a16_{s} = "
                       f"(reinterpret_cast<size_t>({src}) & 15) == 0;")
            gx = bx // ve
            stage += [
                f"if (a16_{s}) {{",
                f"    for (int e = tid; e < {t.bk * gx}; e += "
                f"{_WHOLE_THREADS}) {{",
                f"        const int kk = e / {gx}, xx = (e % {gx}) * {ve};",
                f"        const int {var[k]} = kc + kk, {var[x]} = {x0} + xx;",
                f"        const int n = {var[k]} < {K} ? "
                f"max(0, min({ve}, {X} - {var[x]})) : 0;",
                f"        cp_async_16(&{s}[buf][kk][xx], n > 0 ? &{src}[{idx}]"
                f" : {src}, n * {esz});",
                "    }",
                "} else {",
                *("    " + x_ for x_ in elem),
                "}"]
        else:
            stage += elem

    # loads that do not depend on k: once, into registers
    hoist: dict = {}      # (array, dims) -> (name, uses i, uses j)
    uses: dict = {}       # load uid -> its (array, dims)
    for op, acc in nest.loads:
        key = (acc.array, tuple(acc.dims))
        used = {d[0] for d in acc.dims}
        if op.uid in nest.red_loads or key in staged:
            continue
        uses[op.uid] = key
        if key not in hoist:
            hoist[key] = (f"h{len(hoist)}", i in used, j in used)
    (_, sacc), = nest.stores
    at = _c_index(sacc, p.arrays[sacc.array].shape, var)
    ok_ij = f"{var[i]} < {M} && {var[j]} < {N}"
    init_r, init_rc, init_c, decl = [], [], [], []
    for (array, dims), (h, ui, uj) in hoist.items():
        acc = _Access(array, list(dims))
        src = ptr(_load_src(plan, ni, array), array)
        val = f"{src}[{_c_index(acc, p.arrays[array].shape, var)}]"
        if ui and uj:
            decl.append(f"real {h}[{t.tm}][{t.tn}];")
            init_rc.append(f"{h}[r][c] = ok ? {val} : (real)0;")
        elif ui:
            decl.append(f"real {h}[{t.tm}];")
            init_r.append(f"{h}[r] = {var[i]} < {M} ? {val} : (real)0;")
        elif uj:
            decl.append(f"real {h}[{t.tn}];")
            init_c.append(f"{h}[c] = {var[j]} < {N} ? {val} : (real)0;")
        else:
            decl.append(f"const real {h} = {val};")

    def load(op, acc):
        if op.uid in nest.red_loads:
            return "acc[r][c]", []
        key = (acc.array, tuple(acc.dims))
        if key in staged:
            f = "f_" + sid[key]
            return {"i": f + "[r]", "j": f + "[c]", "k": f}[staged[key]], []
        h, ui, uj = hoist[uses[op.uid]]
        return h + ("[r]" if ui else "") + ("[c]" if uj else ""), []

    point = _point_ops(nest, dtype, "", load,
                       lambda op, acc, value: [f"acc[r][c] = {value};"])

    def chunk(kn: int) -> list[str]:
        frags = []
        for key, kind in staged.items():
            s, f = sid[key], "f_" + sid[key]
            if kind == "k":
                frags.append(f"const real {f} = {s}[buf][kk];")
                continue
            th, bx, n = (("ty", t.bm, t.tm) if kind == "i"
                         else ("tx", t.bn, t.tn))
            frags.append(f"real {f}[{n}];")
            for h in range(2):
                frags.append(
                    f"{{ const {vt} q = *reinterpret_cast<const {vt}*>("
                    f"&{s}[buf][kk][{h * bx // 2} + {th} * {V}]); "
                    + " ".join(f"{f}[{h * V + q}] = q.{'xyzw'[q]};"
                               for q in range(V)) + " }")
        return [
            "#pragma unroll",
            f"for (int kk = 0; kk < {kn}; ++kk) {{",
            *("    " + x_ for x_ in frags),
            "    #pragma unroll",
            f"    for (int r = 0; r < {t.tm}; ++r) {{",
            "        #pragma unroll",
            f"        for (int c = 0; c < {t.tn}; ++c) {{",
            *("            " + x_ for x_ in point),
            "        }",
            "    }",
            "}"]

    if tail and nfull:
        compute = ([f"if (ch < {nfull}) {{"] + ["    " + x_ for x_ in chunk(t.bk)]
                   + ["} else {  // the k tail: only the k that exist"]
                   + ["    " + x_ for x_ in chunk(tail)] + ["}"])
    else:
        compute = chunk(tail or t.bk)
    body = [
        *top,
        "const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;",
        f"const int i0 = (int)(blockIdx.x / {ntj}) * {t.bm}, "
        f"j0 = (int)(blockIdx.x % {ntj}) * {t.bn};",
        *a16,
        "auto stage = [&](int kc, int buf) {",
        *("    " + x_ for x_ in stage),
        "    cp_async_commit();",
        "};",
        *(["auto fetch = [&](int kc) {",
           *("    " + x_ for x_ in fetch),
           "};",
           "auto put = [&](int buf) {",
           *("    " + x_ for x_ in put),
           "};"] if fetch else []),
        f"real acc[{t.tm}][{t.tn}];",
        *decl,
        "#pragma unroll",
        f"for (int r = 0; r < {t.tm}; ++r) {{",
        f"    const int {var[i]} = {row};",
        *("    " + x_ for x_ in init_r),
        "    #pragma unroll",
        f"    for (int c = 0; c < {t.tn}; ++c) {{",
        f"        const int {var[j]} = {col};",
        f"        const bool ok = {ok_ij};",
        f"        acc[r][c] = ok ? {ptr('x', sacc.array)}[{at}] : (real)0;"
        "  // the carry starts at the input's value",
        *("        " + x_ for x_ in init_rc),
        "    }",
        "}",
    ]
    if init_c:
        body += ["#pragma unroll",
                 f"for (int c = 0; c < {t.tn}; ++c) {{",
                 f"    const int {var[j]} = {col};",
                 *("    " + x_ for x_ in init_c),
                 "}"]
    if nch:
        body += [
            *(["fetch(0);", "put(0);"] if fetch else []),
            "stage(0, 0);",
            f"for (int ch = 0; ch < {nch}; ++ch) {{",
            "    const int buf = ch & 1;",
            f"    if (ch + 1 < {nch}) {{",
            *([f"        fetch((ch + 1) * {t.bk});"] if fetch else []),
            f"        stage((ch + 1) * {t.bk}, buf ^ 1);",
            "        cp_async_wait<1>();  // this chunk landed, the next "
            "one flies",
            "    } else {",
            "        cp_async_wait<0>();",
            "    }",
            "    __syncthreads();",
            *("    " + x_ for x_ in compute),
            *([f"    if (ch + 1 < {nch}) put(buf ^ 1);  // the next chunk, "
               "from registers"] if fetch else []),
            "    __syncthreads();  // the next copy overwrites this buffer",
            "}"]
    body += [
        "#pragma unroll",
        f"for (int r = 0; r < {t.tm}; ++r) {{",
        f"    const int {var[i]} = {row};",
        "    #pragma unroll",
        f"    for (int c = 0; c < {t.tn}; ++c) {{",
        f"        const int {var[j]} = {col};",
        f"        if ({ok_ij}) {ptr('o', sacc.array, store=True)}[{at}] = "
        "acc[r][c];",
        "    }",
        "}"]
    text = [
        f"// nest {nest.loop.ivname}: reduction over '{k}' ({K} steps), "
        f"domain ({M}, {N}), tiled: {t.bm} x {t.bn} output tiles, "
        f"{t.tm} x {t.tn} a thread, k in chunks of {t.bk}",
        f"__global__ void __launch_bounds__({_WHOLE_THREADS}, 2) "
        f"{kname}({ptr.decl()}) {{",
        *("    " + x_ for x_ in body),
        "}",
        ""]
    return text, -(-M // t.bm) * ntj, smem


def _emit_whole_cuda(p: Program, plan: _WholePlan,
                     dtype: str) -> tuple[str, dict]:
    lines = [
        "// Generated by repro_torch.core.codegen — do not edit.",
        f"// program '{p.name}': whole-array (Mode B), {dtype}.",
        "// Replaces the Pallas kernel that repro.core.codegen._emit_whole "
        "emits.",
        "// Bound: device memory for the elementwise nests (each array read "
        "once and",
        "// written once), arithmetic for a reduction nest.  Design: launches "
        "in program",
        "// order on one stream, every array in device memory.  A run of "
        "elementwise",
        "// nests over one domain shares a __global__, one thread per point; "
        "a value",
        "// one of them stores reaches a later one that reads it at the same "
        "point in",
        "// a register, and every stored array is still written.  A "
        "reduction with two",
        "// outer ivs runs tiled: a block owns an output tile, a thread a "
        "micro-tile,",
        "// and the reduction iv walks in chunks that double-buffered "
        "cp.async copies",
        "// stage in shared memory; other reductions fold per thread.  Each "
        "point folds",
        "// in program order, and the _rn intrinsics round every op once "
        "(no FMA, no",
        "// tensor cores), as the plain version does, so the two agree bit "
        "for bit.",
        "#include <cuda_runtime.h>",
        "",
        f"typedef {_CTYPES[dtype]} real;",
        "",
    ]
    esz = 4 if dtype == "float32" else 8
    if any(launch.tile for launch in plan.launches):
        lines += _CP_ASYNC.replace("ESZ", str(esz)).splitlines() + [""]
    calls = []      # (kernel, blocks, parameters)
    smem = 0
    for launch in plan.launches:
        ni = launch.nests[0]
        nest = plan.nests[ni]
        kname = f"nest{ni}_{_ident(nest.loop.ivname)}"
        if len(launch.nests) > 1:
            kname = f"nests{ni}to{launch.nests[-1]}_{_ident(nest.loop.ivname)}"
        elif len(launch.stores) < len(nest.stores):
            (uid,) = launch.stores
            kname += "_store" + str([op.uid for op, _ in nest.stores]
                                    .index(uid))
        ptr = _Params()
        if launch.tile is not None:
            text, blocks, nbytes = _tiled_kernel(p, plan, ni, launch.tile,
                                                 dtype, kname, ptr)
            lines += text
            smem = max(smem, nbytes)
            calls.append((kname, blocks, ptr))
            continue
        red = nest.red_iv is not None
        trips = nest.trips[:-1] if red else nest.trips
        npts = math.prod(trips)
        body = (_reduction_body(p, plan, ni, dtype, ptr) if red
                else _group_body(p, plan, launch, dtype, ptr))
        if red:
            what = (f"nest {nest.loop.ivname}: reduction over "
                    f"'{nest.red_iv}' ({nest.trips[-1]} steps), folded per "
                    "point")
        else:
            what = "nest" + ("s " if len(launch.nests) > 1 else " ") + \
                ", ".join(plan.nests[n].loop.ivname for n in launch.nests)
        lines += [
            f"// {what}: domain {tuple(trips)}",
            f"__global__ void __launch_bounds__({_WHOLE_THREADS}) "
            f"{kname}({ptr.decl()}) {{",
            "    for (long long pt = (long long)blockIdx.x * blockDim.x + "
            "threadIdx.x;",
            f"         pt < {npts}LL; pt += (long long)gridDim.x * "
            "blockDim.x) {",
            *("        " + b for b in body),
            "    }",
            "}",
            ""]
        calls.append((kname, max(1, min(-(-npts // _WHOLE_THREADS),
                                        2 ** 31 - 1)), ptr))

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
    for kname, blocks, ptr in calls:
        casts = [("(real*)" if n in ptr.written else "(const real*)") + n
                 for n in ptr.names]
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
    name = [n.loop.ivname for n in plan.nests]
    meta = {"mode": "whole", "grid": (), "block_rows": None, "halo": {},
            "outputs": tuple(plan.stored), "vmem_window_elems": {},
            "smem_bytes": smem, "nest_launches": len(calls),
            "launch_nests": tuple(tuple(name[n] for n in launch.nests)
                                  for launch in plan.launches),
            "tiled_reductions": tuple(name[launch.nests[0]]
                                      for launch in plan.launches
                                      if launch.tile is not None)}
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


def _evaluate(nest: _Nest, load: Callable, const: Callable) -> list:
    """The nest's ops over a domain, one PyTorch op per IR op; ``load(op,
    acc)`` gives each load's value.  Returns ``(store op, access, value)``
    per store, in op order."""
    accs = {o.uid: a for o, a in nest.loads + nest.stores}
    names: dict[str, torch.Tensor] = {}
    stores = []
    for op in nest.ops:
        if isinstance(op, ConstOp):
            names[op.result] = const(op.value)
        elif isinstance(op, LoadOp):
            names[op.result] = load(op, accs[op.uid])
        elif isinstance(op, ArithOp):
            names[op.result] = _TORCH_FNS[op.fn](*(names[a] for a in op.args))
        elif isinstance(op, StoreOp):
            stores.append((op, accs[op.uid], names[op.value]))
    return stores


def _pad(v: torch.Tensor, shape: tuple) -> torch.Tensor:
    """``v`` with zeros after its end along each axis, out to ``shape``."""
    if tuple(v.shape) == tuple(shape):
        return v
    z = v.new_zeros(shape)
    z[tuple(slice(0, n) for n in v.shape)] = v
    return z


def _tiled_plain(nest: _Nest, t: _Tile, read: Callable, carry0: torch.Tensor,
                 const: Callable) -> list:
    """A tiled reduction nest as its kernel walks it: every output tile at
    once, the domain padded to whole tiles (points past its edge compute on
    the zeros the kernel's copies fill in, and are not stored); k in chunks
    of ``t.bk``, each k-dependent load's chunk copied out first as the
    kernel stages it, the last chunk only over the k that exist; each point
    folds k in program order.  ``read(acc)`` is the array a load reads,
    ``carry0`` the stored array's input."""
    i, j, k = nest.ivs
    M, N, K = nest.trips
    Mp, Np = -(-M // t.bm) * t.bm, -(-N // t.bn) * t.bn
    staged = _staged(nest)

    def over_tiles(acc: _Access) -> torch.Tensor:
        used = {d[0] for d in acc.dims}
        v = _domain_view(read(acc), acc, [i, j], [M, N], {})
        return _pad(v, (Mp if i in used else 1, Np if j in used else 1))

    (sop, sacc), = nest.stores
    carry = _pad(_domain_view(carry0, sacc, [i, j], [M, N], {}), (Mp, Np))
    hoisted = {op.uid: over_tiles(acc) for op, acc in nest.loads
               if op.uid not in nest.red_loads
               and (acc.array, tuple(acc.dims)) not in staged}
    whole_k = {}
    for key, kind in staged.items():
        acc = _Access(key[0], list(key[1]))
        x, X = (i, M) if kind == "i" else (j, N)
        whole_k[key] = (_domain_view(read(acc), acc, [k], [K], {})
                        if kind == "k" else
                        _domain_view(read(acc), acc, [k, x], [K, X], {}))
    for kc in range(0, K, t.bk):
        kn = min(t.bk, K - kc)
        tiles = {key: _pad(v[kc:kc + kn],
                           (t.bk,) if staged[key] == "k" else
                           (t.bk, Mp if staged[key] == "i" else Np))
                 for key, v in whole_k.items()}
        for kk in range(kn):
            def load(op, acc):
                if op.uid in nest.red_loads:
                    return carry
                key = (acc.array, tuple(acc.dims))
                if key not in tiles:
                    return hoisted[op.uid]
                kind = staged[key]
                return (tiles[key][kk] if kind == "k" else
                        tiles[key][kk].view(-1, 1) if kind == "i" else
                        tiles[key][kk].view(1, -1))

            (_, _, val), = _evaluate(nest, load, const)
            carry = val.expand(Mp, Np)
    return [(sop, sacc, carry[:M, :N])]


def whole_plain(p: Program, plan: _WholePlan,
                arrays: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """K3's plain version: the kernel's launches in order, each nest
    vectorized over its domain with one PyTorch op per IR op (strided
    slices for loads and stores).  A nest of a shared launch takes a value
    an earlier nest of it stored from that nest's result, as the kernel
    forwards it; a tiled reduction walks the kernel's chunks and tail
    (``_tiled_plain``), a per-point one folds its reduction iv in a Python
    loop.  It reads and writes the same buffers as the kernel, so it
    agrees with it bit for bit on the card and with ``sim.
    sequential_exec`` in float64.  ``arrays`` holds the arrays the kernel
    reads (``CudaKernel.inputs``); ``plan`` is the one the kernel was
    emitted from."""
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

    for launch in plan.launches:
        fwd: dict[tuple, torch.Tensor] = {}   # _at of a store -> its value
        for ni in launch.nests:
            nest = plan.nests[ni]
            red = nest.red_iv is not None
            outer = nest.ivs[:-1] if red else nest.ivs
            trips = nest.trips[:len(outer)]

            def read(acc, ni=ni):
                return (out if _load_src(plan, ni, acc.array) == "o"
                        else arrays)[acc.array]

            def point(op, acc, fixed=None, carry=None, nest=nest, outer=outer,
                      trips=trips, read=read):
                """A load over the domain: the carry, a value an earlier
                nest of the launch stored here, or a view of memory."""
                if op.uid in nest.red_loads:
                    return carry
                at = _at(nest, acc)
                if at in fwd:
                    return fwd[at]
                return _domain_view(read(acc), acc, outer, trips, fixed or {})

            if launch.tile is not None:
                (_, sacc), = nest.stores
                stores = _tiled_plain(nest, launch.tile, read,
                                      arrays[sacc.array], const)
            elif red:
                (sop, sacc), = nest.stores
                carry = _domain_view(arrays[sacc.array], sacc, outer, trips,
                                     {})
                for k in range(nest.trips[-1]):
                    (_, _, val), = _evaluate(
                        nest, functools.partial(
                            point, fixed={nest.red_iv: k}, carry=carry),
                        const)
                    carry = val.expand(trips)
                stores = [(sop, sacc, carry)]
            else:
                stores = _evaluate(nest, point, const)
            for op, acc, val in stores:     # op order: the later store wins
                if op.uid in launch.stores:
                    fwd[_at(nest, acc)] = val
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
    smem_bytes: int = 0             # dynamic shared memory per block
    col_tile: Optional[int] = None  # streamed: sink columns per block
    launch_grid: tuple = ()         # streamed: (runs, column tiles)
    run: Optional[int] = None       # streamed: row tiles a block walks
    ring_rows: dict = field(default_factory=dict)  # streamed: stage -> rows
    threads: Optional[int] = None   # streamed: threads per block
    nest_launches: int = 1          # CUDA launches per call
    launch_nests: tuple = ()        # per launch, the nests it runs
    tiled_reductions: tuple = ()    # reduction nests in the tiled form
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
    one block's shared memory at the narrowest column tile (full width
    where the chain cannot be tiled by columns); a smaller block size is
    recorded in ``soft``.  A plan that does not fit even at one row is kept
    as it is, and its launch refuses."""
    def need(pl: _StreamPlan) -> int:
        return _smem_need(p, pl, _plan_columns(p, pl, _COL_TILES[-1]),
                          dtype)

    fitted = plan
    while need(fitted) > _cuda.MAX_SMEM_BYTES and fitted.block_rows > 1:
        fitted, _ = _plan_streamed(p, nests, fitted.block_rows - 1)
    if fitted is plan or need(fitted) > _cuda.MAX_SMEM_BYTES:
        return plan
    soft.append(f"block_rows {plan.block_rows} -> {fitted.block_rows}: the "
                f"windows need {need(plan)} bytes of shared memory at "
                f"{plan.block_rows} rows and the narrowest column tile, more "
                f"than the {_cuda.MAX_SMEM_BYTES} a block has")
    return fitted


def lower_program(p: Program, *, block_rows: Optional[int] = None,
                  buffering: str = "double",
                  dtype: str = "float32") -> CudaKernel:
    """Lower ``p`` to a CUDA kernel (streamed if the chain contract holds,
    whole-array otherwise, where ``buffering`` does not apply and reads
    ``"whole"``); raises :class:`UnlowerableProgram` when the program is
    outside both contracts.  A streamed kernel takes the largest block size
    up to ``block_rows`` whose windows fit one block's shared memory at the
    narrowest column tile, and says so in ``soft_reasons`` when that is
    smaller; its sink tiles are the widest of ``_COL_TILES`` whose windows
    fit ``_SMEM_TARGET``."""
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
        cols, walk = _choose_columns(p, plan, dtype)
        src, meta = _emit_streamed(p, plan, cols, walk, dtype)
        inputs = plan.inputs
        out_shapes = {plan.sink.out: (plan.sink.nest.trips[0],
                                      p.arrays[plan.sink.out].shape[1])}

        def plain_fn(xs):
            return streamed_plain(p, plan, cols, walk.run, xs)
    else:
        wplan = _plan_whole(p, nests, dtype)
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
                   col_tile=meta.get("col_tile"),
                   launch_grid=meta.get("launch_grid", ()),
                   run=meta.get("run"), ring_rows=meta.get("ring_rows", {}),
                   threads=meta.get("threads"),
                   nest_launches=meta["nest_launches"],
                   launch_nests=meta["launch_nests"],
                   tiled_reductions=meta["tiled_reductions"])
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
