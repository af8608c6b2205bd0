"""Model of Vitis HLS ``dataflow`` optimization (the paper's §2 baseline).

Vitis overlaps producer/consumer loop nests *at runtime*: an intermediate
array is replaced by a FIFO when the consumer reads elements in exactly the
producer's write order (single-producer-single-consumer only), else by a
ping-pong buffer which gives **no** overlap within one function invocation.
Arrays accessed through function arguments disqualify the whole region.

We reproduce those semantics with (a) a static read/write-order analysis and
(b) a discrete-event simulation of FIFO stalls at loop-iteration granularity,
using the same per-loop IIs as our scheduler (fair: identical inner-loop
hardware, only the inter-nest mechanism differs).

The paper's §5.2 benchmark transformation (``to_spsc``) now lives in the
pass framework (``transforms.ToSPSC``); the name is re-exported here for
compatibility.

The resource model (Fig. 9) is first-order — Vivado is not available in this
container: BRAM bytes (w/ ping-pong doubling + port replication), FF bits
(shift-register delays, handshake state), LUT proxy (sync logic), DSP count
(fp mul=3/add-sub=2, reused across nests only when they run sequentially).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .errors import NestContractViolation
from .ir import LoadOp, Loop, Program, StoreOp, nest_shape
from .scheduler import Schedule
from .transforms import to_spsc  # noqa: F401  (compatibility re-export)


# ---------------------------------------------------------------------------
# Task/channel analysis
# ---------------------------------------------------------------------------


@dataclass
class Channel:
    array: str
    producer: int          # task index
    consumer: int
    kind: str              # "fifo" | "pingpong"


@dataclass
class DataflowInfo:
    applicable: bool
    reason: str = ""
    channels: list[Channel] = field(default_factory=list)
    #: structured rejection (errors.NestContractViolation) when inapplicable;
    #: ``reason`` stays its string rendering for compat (JSON snapshots).
    diagnostic: Optional[NestContractViolation] = None


def _reject(code: str, detail: str) -> DataflowInfo:
    d = NestContractViolation(code, "dataflow", detail)
    return DataflowInfo(False, reason=detail, diagnostic=d)


def _tasks(p: Program) -> list[Loop]:
    ts = []
    for item in p.body:
        if not isinstance(item, Loop):
            raise ValueError("dataflow model expects top-level loop nests only"
                             " (run transforms.Normalize to sink loose ops)")
        ts.append(item)
    return ts


def _task_accesses(p: Program, task: Loop):
    """All (op, ancestors-within-task) memory ops of a task."""
    out = []

    def rec(items, anc):
        for it in items:
            if isinstance(it, Loop):
                rec(it.body, anc + [it])
            elif isinstance(it, (LoadOp, StoreOp)):
                out.append((it, list(anc)))

    rec(task.body, [task])
    return out


def _subnest_latency(p: Program, s: Schedule, loop: Loop) -> int:
    """Latency of one sub-nest in isolation: max over its ops of the op's
    theta offset from the sub-nest root plus the II-weighted span of the
    loops at-or-below the root (``Schedule.nest_latency`` restricted to an
    arbitrary loop instead of a top-level item)."""
    base = s.theta[loop.uid]
    worst = 0
    for node, anc in p.walk():
        if isinstance(node, Loop):
            continue
        idx = next((i for i, a in enumerate(anc) if a is loop), None)
        if idx is None:
            continue
        span = sum(s.iis[l.uid] * (l.trip - 1) for l in anc[idx:])
        worst = max(worst, s.theta[node.uid] - base + span
                    + p.op_latency(node))
    return worst


def _task_ticks(p: Program, task: Loop, s: Optional[Schedule] = None):
    """Sequential execution points ("ticks") of a task, in program order.

    Returns ``[(static_start, env, ops)]``.  One tick per innermost loop
    iteration of each chain, plus one tick per maximal run of loose ops
    (ops adjacent to a sub-loop — an imperfect nest).  This generalizes the
    old single-counter model: a perfect nest yields exactly its iteration
    space with ``static_start = sum(II_l * iv_l)``; sequential sub-loops
    run back-to-back, each draining fully before its sibling starts (the
    cross-chain sequencing edge of the Vitis model); loose ops advance the
    clock by their summed latency.

    Without a schedule the static starts are all 0 (order-only callers:
    ``_access_sequence``)."""
    ticks: list = []

    def ii_of(l: Loop) -> int:
        return s.iis[l.uid] if s is not None else 0

    def rec(items, env, base) -> int:
        """Emit ticks for one execution of ``items`` starting at ``base``;
        returns the clock after the region completes (drain included)."""
        cur = base
        pending: list = []
        subs_present = any(isinstance(it, Loop) for it in items)

        def flush():
            nonlocal cur
            if pending:
                ticks.append((cur, dict(env), list(pending)))
                if s is not None:
                    cur += sum(p.op_latency(op) for op in pending)
                pending.clear()

        for it in items:
            if isinstance(it, Loop):
                flush()
                for v in range(it.lb, it.ub):
                    env[it.ivname] = v
                    rec(it.body, env, cur + ii_of(it) * (v - it.lb))
                del env[it.ivname]
                cur += _subnest_latency(p, s, it) if s is not None else 0
            else:
                pending.append(it)
        if not subs_present:
            # innermost body: ONE tick per iteration at the II-weighted
            # start (the old model), ops contributing no clock advance
            if pending:
                ticks.append((cur, dict(env), list(pending)))
                pending.clear()
        else:
            flush()
        return cur

    # the task loop itself is part of every chain: passing ``[task]`` (not
    # ``task.body``) makes the root iv enumerate like any other loop
    rec([task], {}, 0)
    return ticks


def _access_sequence(p: Program, task: Loop, array: str, want_write: bool):
    """Sequential (iteration_counter, address) sequence of a task's accesses
    to ``array``.  The iteration counter is the task-wide tick index: the
    flattened innermost index of a perfect nest, and the program-order tick
    of the generalized traversal for multi-loop / imperfect tasks (per-chain
    FIFO order plus cross-chain sequencing)."""
    seq = []
    for q, (_, env, ops) in enumerate(_task_ticks(p, task)):
        for op in ops:
            if not isinstance(op, (LoadOp, StoreOp)) or op.array != array:
                continue
            if isinstance(op, StoreOp) != want_write:
                continue
            seq.append((q, tuple(e.eval(env) for e in op.index)))
    return seq


def analyze_dataflow(p: Program) -> DataflowInfo:
    shape = nest_shape(p)
    for t in shape.tasks:
        if t.kind == "ops":
            return _reject(
                "top-level-ops",
                f"task {t.index} is a bare op, not a loop nest (run "
                "transforms.Normalize to sink loose ops into nests)")
    tasks = _tasks(p)
    # NOTE: multi-loop and imperfect tasks are modeled, not rejected — the
    # generalized tick traversal gives every task a well-defined flattened
    # access order (per-chain FIFO orders + cross-chain sequencing edges).
    # array -> (writer task ids, reader task ids)
    writers: dict[str, set[int]] = {}
    readers: dict[str, set[int]] = {}
    for ti, t in enumerate(tasks):
        for op, _ in _task_accesses(p, t):
            d = writers if isinstance(op, StoreOp) else readers
            d.setdefault(op.array, set()).add(ti)
    channels = []
    for name in p.arrays:
        ws = writers.get(name, set())
        rs_all = readers.get(name, set())
        # every channel in a Vitis dataflow region must be SPSC — including
        # function-argument inputs fanning out to several processes
        if len(ws) > 1:
            return _reject("multi-producer", f"{name} has multiple producers")
        if len(rs_all - ws) > 1:
            return _reject("multi-consumer", f"{name} has multiple consumers")
        cross = {(w, r) for w in ws for r in rs_all if w != r}
        if not cross:
            continue
        arr = p.arrays[name]
        if arr.is_arg:
            return _reject("arg-intermediate",
                           f"intermediate {name} is a function argument")
        (wtask,) = ws
        (rtask,) = tuple(rs_all - ws)
        if rtask < wtask:
            # the consumer runs BEFORE the producer in program order: it
            # reads the array's initial contents, which no channel process
            # network can feed — the region is not a dataflow pipeline
            return _reject(
                "consumer-first",
                f"{name} consumer (task {rtask}) precedes its "
                f"producer (task {wtask})")
        wseq = [a for _, a in _access_sequence(p, tasks[wtask], name, True)]
        rseq = [a for _, a in _access_sequence(p, tasks[rtask], name, False)]
        kind = "fifo" if wseq == rseq else "pingpong"
        channels.append(Channel(name, wtask, rtask, kind))
    return DataflowInfo(True, channels=channels)


# ---------------------------------------------------------------------------
# Discrete-event latency model
# ---------------------------------------------------------------------------


def vitis_dataflow_latency(p: Program, s: Schedule) -> tuple[int, DataflowInfo]:
    """Latency (cycles) of the function under Vitis dataflow semantics.

    Falls back to sequential nest execution when dataflow is inapplicable."""
    info = analyze_dataflow(p)
    if not info.applicable:
        return s.sequential_nests_latency(), info

    tasks = _tasks(p)
    shape = nest_shape(p)
    n = len(tasks)
    # static per-tick times within each task (no stalls).  For a perfect
    # nest the ticks are exactly the flattened iteration space with start
    # sum(II_l * iv_l) — the original single-counter model; generalized
    # shapes additionally serialize sibling sub-loops (drain between
    # chains) and advance past loose ops.
    static_times: list[list[int]] = []
    tails: list[int] = []
    for t in tasks:
        times = ([t0 for t0, _, _ in _task_ticks(p, t, s)]
                 if _task_accesses(p, t) else [])
        static_times.append(times)
        tails.append(s.nest_latency(t) - (len(times) and
                                          (times[-1] - times[0]) or 0))

    # channel bookkeeping
    in_chan: dict[int, list[Channel]] = {i: [] for i in range(n)}
    for ch in info.channels:
        in_chan[ch.consumer].append(ch)

    start: list[list[int]] = [None] * n  # actual iteration start times
    completion: list[int] = [0] * n

    def write_times(ti: int, array: str):
        seq = _access_sequence(p, tasks[ti], array, True)
        wr = p.arrays[array].wr_latency
        # offset of the store inside one tick.  Perfect nests anchor at the
        # task root (original model); generalized shapes anchor at the
        # store's chain root, because the cross-chain serialization is
        # already part of the static tick base (anchoring at the task root
        # would double-count the drain of earlier sibling chains).
        perfect = shape.task(ti).kind == "perfect"
        offs = {}
        for op, anc in _task_accesses(p, tasks[ti]):
            if isinstance(op, StoreOp) and op.array == array:
                anchor = tasks[ti] if perfect or len(anc) < 2 else anc[1]
                offs[op.uid] = s.theta[op.uid] - s.theta[anchor.uid]
        off = min(offs.values()) if offs else 0
        return [start[ti][q] + off + wr for q, _ in seq]

    order = sorted(range(n), key=lambda ti: ti)  # program order is topological
    for ti in order:
        times = static_times[ti]
        ready_full = 0
        fifo_need: list[tuple[list[int], list[int]]] = []  # (per-iter ready,)
        for ch in in_chan[ti]:
            if ch.kind == "pingpong":
                ready_full = max(ready_full, completion[ch.producer])
            else:
                wt = write_times(ch.producer, ch.array)
                rseq = _access_sequence(p, tasks[ti], ch.array, False)
                per_iter: dict[int, int] = {}
                for tok, (q, _) in enumerate(rseq):
                    per_iter[q] = max(per_iter.get(q, 0), wt[tok])
                fifo_need.append(per_iter)
        st = []
        cur = ready_full
        for q in range(len(times)):
            t0 = cur if q == 0 else st[-1] + (times[q] - times[q - 1])
            need = max((d.get(q, 0) for d in fifo_need), default=0)
            st.append(max(t0, need, ready_full))
        start[ti] = st
        completion[ti] = (st[-1] + tails[ti]) if st else 0
    return max(completion), info


# ---------------------------------------------------------------------------
# Resource model (Fig. 9)
# ---------------------------------------------------------------------------

_DSP = {"mul": 3, "add": 2, "sub": 2, "div": 0, "min": 0, "max": 0, "cmp": 0,
        # exp: iterative fp unit built from mul/add stages (~7 DSPs on
        # UltraScale+); emitted only by the tracing frontend, outside the
        # paper's Fig. 9 benchmark set
        "exp": 7}

RESOURCE_KEYS = ("bram_bytes", "ff_bits", "lut", "dsp")


class ResourceVector(dict):
    """Typed resource vector — the four Fig. 9 axes with helpers.

    A ``dict`` subclass (fixed keys ``bram_bytes``/``ff_bits``/``lut``/
    ``dsp``) so existing consumers — JSON serialization, ``res["dsp"]``
    lookups, equality against plain dicts — keep working unchanged, while
    the DSE layer gets attribute access, capacity checks and dominance.
    """

    KEYS = RESOURCE_KEYS

    def __init__(self, bram_bytes: float = 0.0, ff_bits: float = 0.0,
                 lut: float = 0.0, dsp: float = 0.0):
        super().__init__(bram_bytes=float(bram_bytes), ff_bits=float(ff_bits),
                         lut=float(lut), dsp=float(dsp))

    bram_bytes = property(lambda self: self["bram_bytes"])
    ff_bits = property(lambda self: self["ff_bits"])
    lut = property(lambda self: self["lut"])
    dsp = property(lambda self: self["dsp"])

    def as_tuple(self, keys=KEYS) -> tuple[float, ...]:
        return tuple(self[k] for k in keys)

    def fits(self, caps: Optional[dict]) -> bool:
        """True when every capped resource is within its ceiling."""
        return not self.violations(caps)

    def violations(self, caps: Optional[dict]) -> list[str]:
        """Human-readable list of exceeded capacities (empty = fits)."""
        out = []
        for k, v in (caps or {}).items():
            if self.get(k, 0.0) > v + 1e-9:
                out.append(f"{k} {self[k]:g} > {v:g}")
        return out

    def dominates(self, other: dict, tol: float = 1e-9) -> bool:
        """<= on every axis and < on at least one (Pareto dominance over
        the resource axes only; the DSE adds latency as a fifth axis)."""
        le = all(self[k] <= other[k] + tol for k in self.KEYS)
        lt = any(self[k] < other[k] - tol for k in self.KEYS)
        return le and lt


# -- tile-local (streamed line-buffer) footprints ---------------------------


def _top_groups(p: Program) -> list[list]:
    """Top-level items grouped by ``fuse_group`` (a shift-and-peel fusion's
    peel nests + core are ONE hardware nest); singleton groups otherwise."""
    groups: dict = {}
    order: list = []
    for item in p.body:
        g = item.fuse_group if isinstance(item, Loop) else None
        key = ("g", g) if g is not None else ("i", id(item))
        if key not in groups:
            groups[key] = []
            order.append(key)
        groups[key].append(item)
    return [groups[k] for k in order]


def tile_window_elems(p: Program, *, buffers: int = 1) -> dict[str, int]:
    """array -> streamed-window element count for nest-local intermediates
    of explicitly tiled nests (DESIGN.md §6).

    ``buffers`` multiplies each window for multi-buffered (ping-pong)
    codegen footprints: ``codegen.lower_program(buffering="double")``
    overlaps tile ``t+1``'s refill with tile ``t``'s compute, which costs
    ``buffers=2`` copies of every window.  The default (1) is the cost
    model the §6 golden frontiers are pinned against — resource-aware DSE
    keeps using it; only codegen footprint reporting passes ``buffers=2``.

    An intermediate array (``is_arg=False``) whose every access lives in a
    single top-level group whose core nest was strip-mined by ``LoopTile``
    (outermost loop carries ``Loop.tile_block``) never needs full-array
    storage: one outer-tile iteration touches only a bounded window of
    addresses (block rows + stencil halo — exactly the shared-memory line buffer
    the CUDA kernel allocates), and the buffer is reused across tiles.  The
    window is, per dim, the extent of the access indices over the inner ivs
    with the outer tile iv fixed; that requires every access to agree on
    the outer iv's coefficient (otherwise the window drifts per tile and we
    conservatively keep the full array).
    """
    groups = _top_groups(p)
    # array -> set of group indices it is accessed from
    where: dict[str, set[int]] = {}
    acc_by_group: list[list] = []
    for gi, items in enumerate(groups):
        accs = []
        for item in items:
            if isinstance(item, Loop):
                accs.extend(_task_accesses(p, item))
        acc_by_group.append(accs)
        for op, _ in accs:
            where.setdefault(op.array, set()).add(gi)

    out: dict[str, int] = {}
    for name, gis in where.items():
        arr = p.arrays[name]
        if arr.is_arg or len(gis) != 1:
            continue
        (gi,) = gis
        core = [it for it in groups[gi]
                if isinstance(it, Loop) and not it.peel]
        if len(core) != 1 or core[0].tile_block is None:
            continue
        outer_iv = core[0].ivname
        accs = [(op, anc) for op, anc in acc_by_group[gi]
                if op.array == name and not any(l.peel for l in anc)]
        if not accs:
            continue  # only peel nests touch it: window undefined, keep full
        window = 1
        ok = True
        for d in range(len(arr.shape)):
            coeffs0 = {e0.coeffs.get(outer_iv, 0)
                       for e0 in (op.index[d] for op, _ in accs)}
            if len(coeffs0) != 1:
                ok = False  # accesses disagree on the tile stride
                break
            los, his = [], []
            for op, anc in accs:
                e = op.index[d]
                lo = hi = e.const
                for ivn, c in e.coeffs.items():
                    if ivn == outer_iv:
                        continue
                    loop = next(l for l in anc if l.ivname == ivn)
                    lo += min(c * loop.lb, c * (loop.ub - 1))
                    hi += max(c * loop.lb, c * (loop.ub - 1))
                los.append(lo)
                his.append(hi)
            extent = max(his) - min(los) + 1
            window *= max(1, min(extent, arr.shape[d]))
        if ok and window < arr.num_elems():
            out[name] = window * max(1, int(buffers))
    return out


def resources(p: Program, s: Schedule, mode: str) -> ResourceVector:
    """mode: 'ours' | 'vitis_seq' (no dataflow) | 'vitis_dataflow'."""
    from .ir import ArithOp

    bram_bytes = 0.0
    ff_bits = 0.0
    lut = 0.0
    window = tile_window_elems(p)
    for arr in p.arrays.values():
        bits = window.get(arr.name, arr.num_elems()) * arr.elem_bits
        fully_part = arr.kind == "reg" or len(arr.partition) == len(arr.shape)
        if fully_part:
            ff_bits += bits
        else:
            repl = max(1, -(-len(arr.ports) // 2))  # BRAM = 2 physical ports
            bram_bytes += bits / 8 * repl

    # tile control: block counters + line-buffer rotation per tiled nest
    for l in p.loops():
        if l.tile_block is not None:
            ff_bits += 64
            lut += 32

    # fp datapath units.  Loops peeled off a shift-and-peel fusion
    # (``Loop.peel``) replicate a subrange of the fused core's body: in
    # hardware they are the same guarded datapath (the IR just lacks
    # conditionals), so their ops are not counted again.  Top-level nests of
    # one fusion additionally share a ``fuse_group`` and are costed once at
    # the group's widest member.
    per_nest_dsp = []
    group_dsp: dict[int, float] = {}
    for item in p.body:
        cnt = 0
        def rec(items):
            nonlocal cnt
            for it in items:
                if isinstance(it, Loop):
                    if not it.peel:
                        rec(it.body)
                elif isinstance(it, ArithOp):
                    cnt += _DSP.get(it.fn, 0)
        if isinstance(item, Loop) and not item.peel:
            rec(item.body)
        g = item.fuse_group if isinstance(item, Loop) else None
        if g is None:
            per_nest_dsp.append(cnt)
        else:
            group_dsp[g] = max(group_dsp.get(g, 0), cnt)
    per_nest_dsp.extend(group_dsp.values())
    dsp = max(per_nest_dsp, default=0) if mode == "vitis_seq" else sum(per_nest_dsp)

    # shift-register delays (ours and Vitis pay comparable pipeline registers;
    # our scheduler explicitly minimizes them — §4.3)
    ff_bits += s.delay_register_bits()

    if mode == "vitis_dataflow":
        info = analyze_dataflow(p)
        if info.applicable:
            for ch in info.channels:
                arr = p.arrays[ch.array]
                bits = arr.num_elems() * arr.elem_bits
                if ch.kind == "pingpong":
                    # double buffering duplicates the storage
                    if arr.kind == "reg" or len(arr.partition) == len(arr.shape):
                        ff_bits += bits
                    else:
                        bram_bytes += bits / 8
                    lut += 180
                    ff_bits += 100
                else:
                    ff_bits += 2 * arr.elem_bits + 70  # FIFO regs + handshake
                    lut += 120
    return ResourceVector(bram_bytes=bram_bytes, ff_bits=ff_bits, lut=lut,
                          dsp=dsp)
