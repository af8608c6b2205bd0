"""The paper's auto-tuner (§3.1) + the resource-aware DSE driver.

Auto-tuner: binary search for the smallest feasible II of every loop that
lacks a programmer-specified ``pipeline`` II.

Feasibility of an II assignment = the scheduling system admits a solution
(Bellman-Ford finds no positive cycle) and loop-counter occupancy holds.
Loops are tuned innermost-first.  Each probe is incremental (DESIGN.md §5):
DepAnalysis enumerated the conflicting pairs once and caches each pair's
edge on the IIs of the loops in its iteration vectors, so a probe that
moves one loop's II only re-solves the dependences touching that loop —
and those via the closed-form fast path, not branch-and-bound.

DSE (``pareto_explore``, DESIGN.md §6): the scheduler finds the best
schedule for a *fixed* program, but the paper's headline wins depend on
program shape.  The search layer explores semantics-preserving transform
pipelines (fuse / partition / unroll / tile from ``transforms``), compiles
every candidate through the incremental scheduler, and maintains a
dominance-pruned archive over the objective space (latency, BRAM, DSP, FF)
— the Fig. 9 trade-off curve — expanded frontier-first rather than by
single-best hill climbing.  The declarative entry point is
``repro_torch.core.hls.compile`` (api.py).
"""
from __future__ import annotations

import heapq
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence, Union

from . import faults
from .cache import (CacheStore, fingerprint, get_store, pack_schedule,
                    unpack_schedule)
from .deps import DepAnalysis
from .errors import CompileError, ScheduleInfeasible
from .ir import Loop, Program
from .scheduler import Schedule, check_loop_occupancy, feasible, schedule
from .transforms import (ArrayPartition, FuseProducerConsumer, LoopTile,
                         LoopUnroll, Pass, PassManager, TransformError)


def _loops_with_depth(p: Program) -> list[tuple[Loop, int]]:
    return [(n, len(anc)) for n, anc in p.walk() if isinstance(n, Loop)]


def _seq_ii_bound(p: Program, loop: Loop) -> int:
    """A conservative (sequential-execution) II upper bound, bottom-up."""
    total = 1
    for item in loop.body:
        if isinstance(item, Loop):
            total += item.trip * _seq_ii_bound(p, item)
        else:
            total += p.op_latency(item)
    return total


def _occupancy_floor(loop: Loop, iis: dict[int, int]) -> int:
    lo = 1
    for item in loop.body:
        if isinstance(item, Loop):
            lo = max(lo, item.trip * iis[item.uid])
    return lo


def autotune(p: Program, dep: Optional[DepAnalysis] = None,
             verbose: bool = False) -> dict[int, int]:
    """Return loop uid -> II (programmer-specified IIs respected)."""
    dep = dep or DepAnalysis(p)
    loops = _loops_with_depth(p)
    iis: dict[int, int] = {}
    tunable: list[Loop] = []
    for loop, _ in loops:
        if loop.ii is not None:
            iis[loop.uid] = loop.ii
        else:
            iis[loop.uid] = _seq_ii_bound(p, loop)
            tunable.append(loop)

    # innermost-first (deepest), then program order
    depth = {l.uid: d for l, d in loops}
    tunable.sort(key=lambda l: -depth[l.uid])

    for loop in tunable:
        lo = _occupancy_floor(loop, iis)
        hi = max(lo, iis[loop.uid])

        def probe(ii: int) -> bool:
            iis[loop.uid] = ii
            return feasible(p, iis, dep)

        # ensure hi feasible (double if the conservative bound still fails,
        # e.g. due to cross-nest port serialization pressure)
        guard = 0
        while not probe(hi) and guard < 8:
            hi *= 2
            guard += 1
        best = hi
        while lo <= hi:
            mid = (lo + hi) // 2
            if probe(mid):
                best = mid
                hi = mid - 1
            else:
                lo = mid + 1
        iis[loop.uid] = best
        if verbose:
            print(f"  autotune: loop {loop.ivname} II={best}")

    if not check_loop_occupancy(p, iis) or not feasible(p, iis, dep):
        # unreachable on an exact analysis (the binary search only accepts
        # feasible probes); conservative degraded dependence bounds can in
        # principle leave no feasible II — fail honestly, never return a
        # schedule that was not proven feasible
        raise ScheduleInfeasible(
            "autotuned IIs are not feasible"
            + (" (degraded dependence bounds)" if getattr(
                dep, "degradations", None) else ""))
    return iis


def compile_program(p: Program, verbose: bool = False) -> Schedule:
    """Full pipeline: dependence analysis -> II autotune -> scheduling ILP."""
    dep = DepAnalysis(p)
    iis = autotune(p, dep, verbose=verbose)
    s = schedule(p, iis, dep)
    if not s.feasible:
        raise ScheduleInfeasible("scheduling failed for autotuned IIs")
    return s


# ---------------------------------------------------------------------------
# Design-space exploration (DESIGN.md §6): candidates + objective space
# ---------------------------------------------------------------------------

# The objective space of the Pareto search: scheduled latency plus the
# Fig. 9 resource axes the paper trades it against.
PARETO_METRICS = ("latency", "bram_bytes", "dsp", "ff_bits")


@dataclass
class DSECandidate:
    """One explored design point: a transform pipeline + its compiled
    schedule, resource vector and search status.  (Exported from the
    declarative front end as ``hls.DesignPoint``.)"""

    desc: str                     # human-readable pipeline description
    passes: tuple[Pass, ...]
    program: Program
    schedule: Schedule
    latency: int
    res: dict[str, float]         # dataflow.resources(program, schedule, mode)
    within_budget: bool
    status: str = ""              # "baseline" | "frontier" | "dominated by
    #                               <desc>" | "over budget: <violations>"
    cached: bool = False          # rehydrated from the persistent cache
    # "degraded" when a truncated solver forced conservative bounds anywhere
    # in this candidate's transform legality checks or schedule (DESIGN.md §9)
    provenance: str = "exact"
    diags: tuple = field(default=(), repr=False, compare=False)
    _obj: Optional[tuple] = field(default=None, repr=False, compare=False)

    def metric(self, key: str) -> float:
        return float(self.latency) if key == "latency" else float(self.res[key])

    def objectives(self, keys: Sequence[str] = PARETO_METRICS) -> tuple:
        # latency/res are fixed at construction, so the default objective
        # tuple is computed once — every archive dominance check used to
        # recompute it (part of the O(n^2 log n) requeue hot spot)
        if keys is PARETO_METRICS:
            if self._obj is None:
                self._obj = tuple(self.metric(k) for k in keys)
            return self._obj
        return tuple(self.metric(k) for k in keys)


def dominates(u: Sequence[float], v: Sequence[float],
              tol: float = 1e-9) -> bool:
    """Pareto dominance: <= on every axis, < on at least one."""
    return all(a <= b + tol for a, b in zip(u, v)) and \
        any(a < b - tol for a, b in zip(u, v))


@dataclass
class DSEResult:
    """Legacy result shape of the deprecated ``explore`` shim (the
    declarative path returns ``hls.CompileResult``).  ``frontier`` and
    ``rejections`` are populated by the Pareto engine underneath."""

    baseline: DSECandidate
    best: DSECandidate
    candidates: list[DSECandidate] = field(default_factory=list)
    budget: dict[str, float] = field(default_factory=dict)
    frontier: list[DSECandidate] = field(default_factory=list)
    rejections: list[tuple[str, str]] = field(default_factory=list)

    @property
    def speedup(self) -> float:
        """baseline latency / best latency; 1.0 for degenerate (zero-cycle)
        baselines so an empty or fully-rejected search never divides by
        zero — check ``rejections`` / ``explain()`` for why."""
        if self.best.latency <= 0 or self.baseline.latency <= 0:
            return 1.0
        return self.baseline.latency / self.best.latency

    def table(self) -> list[tuple[str, int, float, float, bool]]:
        """(desc, latency, bram_bytes, dsp, within_budget) rows, best first."""
        rows = [(c.desc, c.latency, c.res["bram_bytes"], c.res["dsp"],
                 c.within_budget) for c in self.candidates]
        rows.sort(key=lambda r: (not r[4], r[1], r[2], r[3]))
        return rows

    def explain(self) -> str:
        """Per-candidate accept/reject report (see CompileResult.explain)."""
        lines = []
        for c in self.candidates:
            lines.append(
                f"{c.desc}: latency={c.latency} "
                + " ".join(f"{k}={c.res[k]:g}" for k in
                           ("bram_bytes", "dsp", "ff_bits"))
                + f" [{c.status or ('ok' if c.within_budget else 'over budget')}]")
        for desc, reason in self.rejections:
            if not any(c.desc == desc for c in self.candidates):
                lines.append(f"{desc}: [{reason}]")
        return "\n".join(lines)


def _budget_key(res: dict[str, float], budget: dict[str, float]) -> bool:
    return all(res.get(k, 0.0) <= v + 1e-9 for k, v in budget.items())


def _unroll_factors_for(p: Program, factors: Sequence[int]) -> list[int]:
    """Factors that partially unroll at least one innermost loop."""
    out = []
    inner = [l for l in p.loops()
             if not any(isinstance(ch, Loop) for ch in l.body)]
    for f in factors:
        if any(l.trip % f == 0 and l.trip // f >= 1 and not l.unroll
               for l in inner):
            out.append(f)
    return out


def _tile_moves(p: Program, sizes: Sequence[int]) -> list[LoopTile]:
    """One tiling move per size, strip-mining every top-level loop it
    divides (order-preserving, so always legal)."""
    moves = []
    tops = [it for it in p.body if isinstance(it, Loop)
            and it.tile_block is None]  # don't re-strip an existing tile
    for s in sizes:
        cfg = {l.ivname: s for l in tops if l.trip % s == 0 and l.trip // s >= 2}
        if cfg:
            moves.append(LoopTile(cfg))
    return moves


def _pipeline_text(passes: Sequence[Pass]) -> Optional[str]:
    """The textual form of ``passes`` for cache keys, or None when a pass
    falls outside the textual grammar (then the candidate is uncacheable)."""
    from .pipeline_parse import print_pipeline
    try:
        return print_pipeline(list(passes))
    except Exception:
        return None


def _candidate_key(p: Program, all_passes: Sequence[Pass], mode: str,
                   incremental: bool, n_new: int) -> Optional[str]:
    """Persistent-cache key of one candidate measurement: the program
    fingerprint x full pipeline text x resource mode, plus the no-op
    detection flavor (it decides whether the entry means None)."""
    text = _pipeline_text(all_passes)
    if text is None:
        return None
    return fingerprint(p, pipeline=text, mode=mode,
                       extra=f"cand;inc={int(bool(incremental))};new={n_new}")


def _rehydrate_candidate(entry: dict, p: Program, desc: str,
                         passes: Sequence[Pass], start: Program,
                         base_passes: Sequence[Pass], verify: bool,
                         incremental: bool) -> Optional[DSECandidate]:
    """Rebuild a DSECandidate from a cache entry by re-applying the passes
    (cheap: no differential check) and unpacking the stored schedule onto
    the result.  Raises ValueError when the entry does not fit this program
    — the caller then treats it as a miss and recompiles."""
    from .dataflow import ResourceVector

    if entry.get("noop"):
        return None
    if verify and not entry.get("verified"):
        raise ValueError("cached entry was never differentially verified")
    pm = PassManager(passes, verify=False)
    q = pm.run(start)
    if passes and (q is start or
                   (incremental and not pm.reports[-1].changed)):
        raise ValueError("cached entry disagrees: pass application no-ops")
    s = unpack_schedule(q, entry["schedule"])
    return DSECandidate(
        desc=desc or "baseline", passes=tuple(base_passes) + tuple(passes),
        program=q, schedule=s, latency=int(entry["latency"]),
        res=ResourceVector(**entry["res"]), within_budget=True, cached=True)


def _probe_candidate_cache(store: Optional[CacheStore], key: Optional[str],
                           p: Program, desc: str, passes: Sequence[Pass],
                           start: Program, base_passes: Sequence[Pass],
                           verify: bool, incremental: bool):
    """(hit, candidate_or_None).  Never compiles; a stale or unverified
    entry reads as a miss."""
    if store is None or key is None:
        return False, None
    entry = store.get(key)
    if entry is None:
        return False, None
    try:
        return True, _rehydrate_candidate(entry, p, desc, passes, start,
                                          base_passes, verify, incremental)
    except (ValueError, KeyError, TypeError):
        return False, None


def _degrading(events: Sequence[dict]) -> bool:
    return any(e.get("kind") in faults.DEGRADING_KINDS for e in events)


def dedupe_diagnostics(entries: Sequence[dict]) -> list[dict]:
    """Collapse repeated identical diagnostics across DSE candidates.

    Two entries are "identical" when every field except the reporting
    ``candidate`` (and any prior ``count``) matches — e.g. the same solver
    gap on the same (src, snk, carry) site resurfacing in every candidate
    that re-analyzes the nest.  The first occurrence is kept (stable
    order) and gains a ``count`` when it swallowed duplicates, so
    ``explain()`` and machine consumers see each distinct fact once."""
    out: list[dict] = []
    index: dict[tuple, int] = {}
    for e in entries:
        key = tuple(sorted((k, repr(v)) for k, v in e.items()
                           if k not in ("candidate", "count")))
        i = index.get(key)
        if i is None:
            index[key] = len(out)
            out.append(dict(e))
        else:
            out[i]["count"] = (out[i].get("count") or 1) + \
                (e.get("count") or 1)
    return out


def _store_candidate(store: Optional[CacheStore], key: Optional[str],
                     c: Optional[DSECandidate], verify: bool) -> None:
    if store is None or key is None:
        return
    if c is not None and c.provenance != "exact":
        return  # degraded measurements must never poison the cache
    if c is None:
        store.put(key, {"noop": True})
        return
    store.put(key, {"noop": False, "verified": bool(verify),
                    "latency": int(c.latency),
                    "res": {k: float(v) for k, v in c.res.items()},
                    "schedule": pack_schedule(c.schedule)})


def measure_candidate(p: Program, desc: str, passes: Sequence[Pass], *,
                      base: Optional[Program] = None,
                      base_passes: Sequence[Pass] = (),
                      verify: bool = True, seeds: Sequence[int] = (0,),
                      mode: str = "ours",
                      incremental: bool = True,
                      store: Optional[CacheStore] = None
                      ) -> Optional[DSECandidate]:
    """Apply ``passes`` on top of ``base`` (an already-verified
    intermediate, default the original program ``p``), compile, and cost.
    Incremental composition does not re-apply and re-verify the whole
    pipeline prefix — equivalence to ``p`` is transitive through the
    verified base.

    Returns None for a no-op: under ``incremental=True`` (the DSE's
    one-move-at-a-time composition) when the NEWEST move applied nothing —
    the result would duplicate an already-measured candidate; under
    ``incremental=False`` (a caller-specified fixed pipeline) only when
    the WHOLE pipeline applied nothing — a fixed pipeline whose last pass
    happens not to fire must still yield the earlier passes' design.

    ``store`` enables the persistent compile cache: a usable entry skips
    the differential check and the scheduling ILP entirely (passes are
    still re-applied, unverified — equivalence was discharged when the
    entry was created, and the entry says so via its ``verified`` flag)."""
    from .dataflow import resources

    start = base if base is not None else p
    key = None
    if store is not None:
        key = _candidate_key(p, tuple(base_passes) + tuple(passes), mode,
                             incremental, len(tuple(passes)))
        hit, c = _probe_candidate_cache(store, key, p, desc, passes, start,
                                        base_passes, verify, incremental)
        if hit:
            return c
    ev0 = faults.event_count()  # degradations recorded while measuring
    pm = PassManager(passes, verify=verify, seeds=seeds)
    q = pm.run(start)
    if passes and (q is start or
                   (incremental and not pm.reports[-1].changed)):
        if not _degrading(faults.events_since(ev0)):
            # a *degraded* no-op verdict (e.g. a conservatively refused
            # fusion) must not be persisted as the pipeline's truth
            _store_candidate(store, key, None, verify)
        return None
    s = compile_program(q)
    res = resources(q, s, mode)
    diags = tuple(faults.events_since(ev0))
    prov = ("degraded"
            if s.provenance == "degraded" or _degrading(diags) else "exact")
    c = DSECandidate(
        desc=desc or "baseline", passes=tuple(base_passes) + tuple(passes),
        program=q, schedule=s, latency=s.completion_time(), res=res,
        within_budget=True, provenance=prov, diags=diags)
    _store_candidate(store, key, c, verify)
    return c


def validate_candidate(c: DSECandidate, seeds: Sequence[int] = (0,)) -> None:
    """Brute-force oracles for a DSE winner: ``validate_schedule`` plus
    ``timed_exec`` vs ``sequential_exec`` (small programs only — this
    enumerates dynamic instances).  Raises AssertionError explicitly so the
    check survives ``python -O``."""
    from .sim import (make_inputs, sequential_exec, timed_exec,
                      validate_schedule)
    violations = validate_schedule(c.program, c.schedule)
    if violations:
        raise AssertionError(
            f"DSE winner '{c.desc}' fails validate_schedule: "
            f"{violations[:5]}")
    import numpy as np
    inp = make_inputs(c.program, seeds[0])
    got = timed_exec(c.program, c.schedule, inp)
    want = sequential_exec(c.program, inp)
    for k in want:
        if not np.allclose(got[k], want[k], rtol=1e-12, atol=0):
            raise AssertionError(
                f"DSE winner '{c.desc}': timed_exec differs from "
                f"sequential_exec on array {k}")


# Move families the search can draw from (SearchConfig.moves selects a
# subset — e.g. the CUDA stencil sweep excludes "partition", a knob the
# kernel's shared-memory line buffer cannot express).
MOVE_FAMILIES = ("fuse", "partition", "unroll", "tile")


def _single_moves(p: Program, families: Sequence[str],
                  unroll_factors: Sequence[int],
                  tile_sizes: Sequence[int]) -> list[tuple[str, Pass]]:
    moves: list[tuple[str, Pass]] = []
    unknown = set(families) - set(MOVE_FAMILIES)
    if unknown:
        raise ValueError(f"unknown move families {sorted(unknown)}; "
                         f"valid: {MOVE_FAMILIES}")
    if "fuse" in families:
        # shift-and-peel fusion (mismatched bounds fuse too) plus the
        # equal-bounds-only variant: peeling trades prologue nests for core
        # overlap, which is not always the latency winner — enumerate both
        moves += [("fuse", FuseProducerConsumer()),
                  ("fuse(noshift)", FuseProducerConsumer(enable_shift=False))]
    if "partition" in families:
        moves.append(("partition", ArrayPartition()))
    if "unroll" in families:
        moves += [(f"unroll(x{f})", LoopUnroll(f))
                  for f in _unroll_factors_for(p, unroll_factors)]
    if "tile" in families:
        moves += [(t.name, t) for t in _tile_moves(p, tile_sizes)]
    return moves


# ---------------------------------------------------------------------------
# Expansion-base selection: hypervolume contribution + lazy-invalidation queue
# ---------------------------------------------------------------------------


def _hv(points: Sequence[tuple], ref: tuple) -> float:
    """Exact hypervolume (minimization) of the union of boxes ``[p, ref]``
    by recursive dimension sweeping — fine for the DSE's <= ~16-point,
    4-axis archives.  Points not strictly below ``ref`` contribute nothing."""
    pts = sorted(p for p in points if all(x < r for x, r in zip(p, ref)))
    if not pts:
        return 0.0
    if len(ref) == 1:
        return ref[0] - pts[0][0]
    vol = 0.0
    for i, p in enumerate(pts):
        hi = pts[i + 1][0] if i + 1 < len(pts) else ref[0]
        if hi > p[0]:
            vol += (hi - p[0]) * _hv([q[1:] for q in pts[:i + 1]], ref[1:])
    return vol


def _hv_contributions(archive: Sequence[DSECandidate]) -> dict[int, float]:
    """id(candidate) -> hypervolume contribution over the archive-normalized
    objective space (each axis scaled to the archive's [min, max] span, ref
    1.1 per axis, so no axis's units dominate and frontier extremes always
    contribute)."""
    if not archive:
        return {}
    objs = [a.objectives() for a in archive]
    lo = [min(col) for col in zip(*objs)]
    hi = [max(col) for col in zip(*objs)]
    span = [h - l if h > l else 1.0 for l, h in zip(lo, hi)]
    pts = [tuple((x - l) / s for x, l, s in zip(o, lo, span)) for o in objs]
    ref = tuple(1.1 for _ in lo)
    total = _hv(pts, ref)
    return {id(a): total - _hv(pts[:i] + pts[i + 1:], ref)
            for i, a in enumerate(archive)}


class _ExpansionQueue:
    """Unexpanded archive members, pending frontier expansion.

    Replaces the sort-every-iteration list (O(n^2 log n) across a run) with
    a heap for the classic lowest-latency-first selector, or a live list
    scanned by hypervolume contribution for ``selector="hv"``.  Dominated
    members are invalidated *lazily*: ``insert`` only flips their status
    and ``pop`` skips them — no O(n) ``list.remove`` on the hot path."""

    SELECTORS = ("latency", "hv")

    def __init__(self, selector: str = "latency"):
        if selector not in self.SELECTORS:
            raise ValueError(f"unknown selector {selector!r}; "
                             f"valid: {self.SELECTORS}")
        self.selector = selector
        self._heap: list[tuple] = []
        self._live: list[DSECandidate] = []
        self._n = 0                      # insertion order = tie break

    def push(self, c: DSECandidate) -> None:
        self._n += 1
        if self.selector == "latency":
            heapq.heappush(self._heap,
                           (c.latency, c.res["bram_bytes"], self._n, c))
        else:
            self._live.append(c)

    @staticmethod
    def _stale(c: DSECandidate) -> bool:
        return c.status.startswith("dominated")

    def pop(self, archive: Sequence[DSECandidate]) -> Optional[DSECandidate]:
        if self.selector == "latency":
            while self._heap:
                *_, c = heapq.heappop(self._heap)
                if not self._stale(c):
                    return c
            return None
        self._live = [c for c in self._live if not self._stale(c)]
        if not self._live:
            return None
        contrib = _hv_contributions(archive)
        best_i, best_v = 0, None
        for i, c in enumerate(self._live):
            # an over-budget root is the only queued member outside the
            # archive — it must be expanded first (it is the only base)
            v = contrib.get(id(c), float("inf"))
            if best_v is None or v > best_v + 1e-12:
                best_i, best_v = i, v
        return self._live.pop(best_i)


def _macro_moves(base_program: Program, families: Sequence[str],
                 unroll_factors: Sequence[int],
                 tile_sizes: Sequence[int]) -> list[tuple[str, list[Pass]]]:
    """Composite single-step moves: fuse the chain, then immediately tile or
    unroll the *fused* nests — "fuse>tile{...}" / "fuse>unroll(xF)".  A
    fuse+tile frontier point then costs ONE compile instead of two expansion
    waves, which is what reaches deep pipelines within a tight
    ``max_candidates`` cap.  The tile/unroll knobs are derived from a cheap
    structural probe of the fused program (pass application only, no
    scheduling): fused loop names are deterministic per apply, so the real
    measurement reproduces them."""
    if "fuse" not in families:
        return []
    try:
        fused = FuseProducerConsumer().apply(base_program)
    except TransformError:
        return []
    if fused is base_program:
        return []
    out: list[tuple[str, list[Pass]]] = []
    if "tile" in families:
        out += [(f"fuse>{t.name}", [FuseProducerConsumer(), t])
                for t in _tile_moves(fused, tile_sizes)]
    if "unroll" in families:
        out += [(f"fuse>unroll(x{f})", [FuseProducerConsumer(), LoopUnroll(f)])
                for f in _unroll_factors_for(fused, unroll_factors)]
    return out


# ---------------------------------------------------------------------------
# Parallel wave measurement (ProcessPoolExecutor fan-out)
# ---------------------------------------------------------------------------


def _bump_uid_counter(p: Program) -> None:
    """Make the process-local uid counter safe after unpickling a program:
    nodes a worker creates must not collide with the program's existing
    uids (a spawn-start worker's counter begins at 0)."""
    import itertools

    from . import ir
    top = max((n.uid for n, _ in p.walk()), default=-1)
    nxt = next(ir._uid)
    ir._uid = itertools.count(max(top + 1, nxt + 1))


def _measure_worker(payload: tuple):
    """Pool entry point for one cold candidate measurement.  Workers never
    touch the persistent store — the parent owns cache probing/writing, so
    the on-disk state is single-writer per explore call.  Returns
    ``(candidate_or_None, worker_events)`` so degradations behind a None
    (no-op) verdict still reach the parent."""
    program, desc, passes, base_passes, verify, seeds, mode, attempt = payload
    faults.worker_fault_point(desc, attempt)
    _bump_uid_counter(program)
    ev0 = faults.event_count()
    c = measure_candidate(program, desc, passes, base_passes=base_passes,
                          verify=verify, seeds=seeds, mode=mode)
    return c, tuple(faults.events_since(ev0))


_PENDING = object()     # serial-mode placeholder: measure lazily at replay
_IN_PROCESS = object()  # supervisor verdict: measure in the parent process

WORKER_RETRIES = 2        # faults per candidate before quarantine
WORKER_BACKOFF_S = 0.05   # base of the capped exponential retry backoff
WORKER_BACKOFF_CAP_S = 1.0
POOL_REBUILD_CAP = 6      # pool rebuilds per explore before serial fallback


class _WorkerFault:
    """Replay sentinel: this candidate was quarantined after repeated worker
    faults — recorded in ``rejected`` with a ``worker-fault`` reason, never
    counted as a compile."""

    __slots__ = ("reason",)

    def __init__(self, reason: str):
        self.reason = reason


class _CompileFailed:
    """Replay sentinel: the candidate failed deterministically inside the
    worker (TransformError / CompileError) — the same verdict the serial
    engine reaches, so serial and parallel runs stay bit-identical."""

    __slots__ = ("error",)

    def __init__(self, error: str):
        self.error = error


class _PoolSupervisor:
    """Owns the DSE ProcessPoolExecutor (DESIGN.md §9): per-candidate
    deadlines on ``Future.result``, capped exponential-backoff retries for
    transient faults, hard pool rebuilds on hang/breakage, and quarantine
    after ``WORKER_RETRIES`` strikes.  Created immediately before the
    explore loop's ``try`` and closed in its ``finally`` with
    ``shutdown(cancel_futures=True)``, so a raising insert/selector can't
    leak worker processes."""

    def __init__(self, jobs: int, deadline_s: Optional[float]):
        self.jobs = int(jobs)
        self.deadline_s = deadline_s
        self.rebuilds = 0
        self.events: list[dict] = []
        self.pool = self._make()

    def _make(self):
        try:
            import concurrent.futures as cf
            return cf.ProcessPoolExecutor(max_workers=self.jobs)
        except Exception:
            return None

    def note(self, kind: str, **info) -> None:
        self.events.append({"kind": kind, **info})

    def submit(self, payload):
        if self.pool is None:
            return None
        try:
            return self.pool.submit(_measure_worker, payload)
        except Exception:
            return None

    def rebuild(self) -> None:
        """Tear the (hung or broken) pool down hard and start fresh.  A
        hung worker ignores ``shutdown``, so its process is terminated."""
        self.rebuilds += 1
        old, self.pool = self.pool, None
        if old is not None:
            procs = []
            try:
                procs = list(getattr(old, "_processes", {}).values())
            except Exception:
                pass
            try:
                old.shutdown(wait=False, cancel_futures=True)
            except Exception:
                pass
            for proc in procs:
                try:
                    proc.terminate()
                except Exception:
                    pass
        if self.rebuilds <= POOL_REBUILD_CAP:
            self.pool = self._make()
        else:
            self.note("pool-disabled", rebuilds=self.rebuilds)

    def close(self) -> None:
        if self.pool is not None:
            try:
                self.pool.shutdown(wait=False, cancel_futures=True)
            except Exception:
                pass
            self.pool = None

    def collect(self, fut, make_payload, desc: str) -> tuple:
        """Supervise one candidate's future to a verdict.

        Returns ``("ok", (candidate, worker_events))``,
        ``("quarantine", reason)``, ``("compile-error", message)``, or
        ``("fallback", None)`` (pool unusable: measure in-process)."""
        import concurrent.futures as cf
        from concurrent.futures.process import BrokenProcessPool

        strikes = 0
        attempt = 0
        resubmits = 0
        while True:
            if fut is None:
                return ("fallback", None)
            try:
                return ("ok", fut.result(timeout=self.deadline_s))
            except (TransformError, CompileError) as e:
                return ("compile-error", str(e))
            except cf.CancelledError:
                # collateral of a pool rebuild triggered by a sibling —
                # resubmit the same attempt, no strike
                resubmits += 1
                if resubmits > 2 * POOL_REBUILD_CAP:
                    return ("fallback", None)
                fut = self.submit(make_payload(attempt))
                continue
            except cf.TimeoutError:
                strikes += 1
                self.note("worker-hang", candidate=desc, attempt=attempt,
                          deadline_s=self.deadline_s)
                self.rebuild()
            except BrokenProcessPool:
                strikes += 1
                self.note("pool-broken", candidate=desc, attempt=attempt)
                self.rebuild()
            except BaseException as e:
                strikes += 1
                self.note("worker-crash", candidate=desc, attempt=attempt,
                          error=repr(e))
            if strikes >= WORKER_RETRIES:
                return ("quarantine",
                        f"worker-fault: quarantined after {strikes} faults")
            attempt += 1
            self.note("worker-retry", candidate=desc, attempt=attempt)
            time.sleep(min(WORKER_BACKOFF_S * (2 ** (attempt - 1)),
                           WORKER_BACKOFF_CAP_S))
            fut = self.submit(make_payload(attempt))


def _measure_wave(wave: list, cur: "DSECandidate", p: Program,
                  sup: Optional[_PoolSupervisor],
                  store: Optional[CacheStore], verify: bool,
                  seeds: Sequence[int], mode: str) -> list:
    """Measure one expansion wave (all moves off one base), aligned with
    ``wave``.

    Serial mode (``sup`` is None) returns ``_PENDING`` placeholders so the
    caller measures each move only after its under-cap check — exactly the
    sequential engine's behavior.  Parallel mode probes the cache first,
    fans the misses out across the supervised pool, and collects each
    result under a per-candidate deadline with retry / pool-rebuild /
    quarantine handling; compiles that land beyond the candidate cap are
    discarded at replay, so the merged archive is bit-identical to a
    serial run — faults or not.  A slot may also hold a ``_WorkerFault``
    (quarantined) or ``_CompileFailed`` (deterministic failure) sentinel
    for the replay loop."""
    if sup is None or sup.pool is None:
        return [_PENDING] * len(wave)
    results: list = [None] * len(wave)
    futs: dict[int, tuple] = {}
    for i, (full, mvs) in enumerate(wave):
        key = None
        if store is not None:
            key = _candidate_key(p, tuple(cur.passes) + tuple(mvs), mode,
                                 True, len(mvs))
            hit, c = _probe_candidate_cache(store, key, p, full, mvs,
                                            cur.program, cur.passes, verify,
                                            True)
            if hit:
                results[i] = c
                continue

        def make_payload(attempt: int, full=full, mvs=mvs) -> tuple:
            return (cur.program, full, list(mvs), tuple(cur.passes),
                    verify, tuple(seeds), mode, attempt)

        futs[i] = (sup.submit(make_payload(0)), key, make_payload)
    for i, (fut, key, make_payload) in futs.items():
        full, mvs = wave[i]
        kind, val = sup.collect(fut, make_payload, full)
        if kind == "ok":
            c, wevents = val
            if c is None and wevents:
                # degradations behind a no-op verdict would otherwise be
                # lost with the worker process
                sup.events.extend({**e, "candidate": full} for e in wevents)
            if not _degrading(wevents):
                _store_candidate(store, key, c, verify)
            results[i] = c
        elif kind == "quarantine":
            results[i] = _WorkerFault(val)
        elif kind == "compile-error":
            results[i] = _CompileFailed(val)
        else:  # pool unusable: fall back to in-process measurement
            results[i] = _PENDING
    return results


@dataclass
class ParetoResult:
    """Output of the Pareto-frontier DSE (wrapped by hls.CompileResult)."""

    baseline: DSECandidate
    frontier: list[DSECandidate]            # feasible + non-dominated
    candidates: list[DSECandidate]          # every compiled design point
    rejected: list[tuple[str, str]]         # (desc, reason) — capacity etc.
    caps: dict[str, float]                  # resolved absolute ceilings
    compiles: int
    # structured failure-handling record (DESIGN.md §9): solver gaps,
    # worker retries/quarantines, pool rebuilds, cache repairs
    diagnostics: list[dict] = field(default_factory=list)
    # "degraded" when any diagnostic may have moved the frontier off the
    # fault-free result; recovered faults (retries, repairs) stay "exact"
    provenance: str = "exact"


def _search_signature(caps, rel_caps, moves, unroll_factors, tile_sizes,
                      max_candidates, verify, seeds, selector,
                      macro_moves) -> str:
    """Every knob that shapes the search trajectory, for the whole-frontier
    cache key.  ``jobs`` is deliberately absent: parallel and serial runs
    are bit-identical by contract, so they share entries."""
    return ("pareto"
            f";moves={','.join(moves)}"
            f";uf={tuple(unroll_factors)};ts={tuple(tile_sizes)}"
            f";max={max_candidates};verify={int(bool(verify))}"
            f";seeds={tuple(seeds)};sel={selector}"
            f";macro={int(bool(macro_moves))}"
            f";caps={sorted((caps or {}).items())}"
            f";rel={sorted((rel_caps or {}).items())}")


def _pack_pareto(r: ParetoResult, verify: bool) -> Optional[dict]:
    """The whole ParetoResult as a JSON blob (None when any candidate's
    pipeline falls outside the textual grammar, or when the result is
    degraded — a faulted frontier must never be replayed as the truth)."""
    if r.provenance != "exact":
        return None
    cand_blobs = []
    for c in r.candidates:
        text = _pipeline_text(c.passes)
        if text is None:
            return None
        cand_blobs.append({
            "desc": c.desc, "pipeline": text, "status": c.status,
            "within_budget": bool(c.within_budget), "latency": int(c.latency),
            "res": {k: float(v) for k, v in c.res.items()},
            "schedule": pack_schedule(c.schedule)})
    idx = {id(c): i for i, c in enumerate(r.candidates)}
    return {"verified": bool(verify),
            "candidates": cand_blobs,
            "frontier": [idx[id(c)] for c in r.frontier],
            "rejected": [list(t) for t in r.rejected],
            "caps": {k: float(v) for k, v in r.caps.items()},
            "compiles": int(r.compiles)}


def _unpack_pareto(blob: dict, p: Program) -> ParetoResult:
    """Rehydrate a cached frontier: re-apply each candidate's pipeline
    (unverified — equivalence was discharged on the cold run) and unpack
    its schedule.  Raises on any structural mismatch (stale entry)."""
    from .dataflow import ResourceVector
    from .pipeline_parse import parse_pipeline

    cands = []
    for cb in blob["candidates"]:
        passes = tuple(parse_pipeline(cb["pipeline"]))
        q = PassManager(passes, verify=False).run(p) if passes else p
        s = unpack_schedule(q, cb["schedule"])
        cands.append(DSECandidate(
            desc=cb["desc"], passes=passes, program=q, schedule=s,
            latency=int(cb["latency"]), res=ResourceVector(**cb["res"]),
            within_budget=bool(cb["within_budget"]), status=cb["status"],
            cached=True))
    if not cands:
        raise ValueError("empty cached frontier")
    return ParetoResult(
        baseline=cands[0],
        frontier=[cands[i] for i in blob["frontier"]],
        candidates=cands,
        rejected=[tuple(t) for t in blob["rejected"]],
        caps=dict(blob["caps"]), compiles=int(blob["compiles"]))


def pareto_explore(p: Program, *,
                   caps: Optional[dict[str, float]] = None,
                   rel_caps: Optional[dict[str, float]] = None,
                   moves: Sequence[str] = MOVE_FAMILIES,
                   unroll_factors: Sequence[int] = (2, 4),
                   tile_sizes: Sequence[int] = (4,),
                   max_candidates: int = 24,
                   verify: bool = True,
                   seeds: Sequence[int] = (0,),
                   mode: str = "ours",
                   selector: str = "latency",
                   macro_moves: bool = False,
                   jobs: int = 1,
                   worker_deadline_s: Optional[float] = 60.0,
                   store: Union[CacheStore, str, None] = "auto",
                   verbose: bool = False) -> ParetoResult:
    """Pareto-frontier DSE over transform pipelines (DESIGN.md §6, §8).

    Maintains a dominance-pruned archive over the objective space
    ``PARETO_METRICS`` = (latency, bram_bytes, dsp, ff_bits) and expands it
    frontier-first: an unexpanded archive member is selected (lowest
    latency for ``selector="latency"``, largest hypervolume contribution
    over baseline-span-normalized objectives for ``selector="hv"``) and
    every applicable single move is appended; children that survive
    capacity checks and dominance pruning join the archive and the
    expansion queue.  The search stops when the archive has no unexpanded
    member or ``max_candidates`` compilations were spent.
    ``macro_moves=True`` additionally offers composite fuse>tile /
    fuse>unroll steps (one compile each).

    ``caps`` are absolute resource ceilings, ``rel_caps`` scale the
    BASELINE's own usage (``{"bram_bytes": 1.0}`` = iso-BRAM); violating
    candidates are recorded (with the violated capacities as their reject
    reason) but never enter the archive.  Dominated candidates stay in
    ``candidates`` with a ``dominated by <desc>`` status — that record is
    what ``CompileResult.explain()`` prints.

    ``jobs > 1`` measures each expansion wave on a *supervised*
    ``ProcessPoolExecutor`` with a deterministic merge: the resulting
    archive is bit-identical to a serial run.  The supervisor bounds each
    candidate by ``worker_deadline_s``, retries transient worker faults
    with capped exponential backoff, rebuilds the pool when it hangs or
    breaks, and quarantines candidates that keep faulting (recorded in
    ``rejected`` with a ``worker-fault`` reason); an unusable pool falls
    back to in-process measurement.  Every recovery action lands in
    ``ParetoResult.diagnostics``.
    ``store`` is the persistent compile cache: ``"auto"`` resolves the
    process store (None when ``REPRO_HLS_CACHE=0``), and both whole
    frontiers and individual candidate measurements are keyed on the
    program fingerprint, so a repeat explore is O(lookup).
    """
    from .dataflow import RESOURCE_KEYS

    if store == "auto":
        store = get_store()
    caps_in = dict(caps or {})
    caps = dict(caps_in)
    unknown = (set(caps) | set(rel_caps or {})) - set(RESOURCE_KEYS)
    if unknown:
        raise ValueError(f"unknown capacity resource(s) {sorted(unknown)}; "
                         f"valid keys: {sorted(RESOURCE_KEYS)}")

    fkey = None
    if store is not None:
        fkey = fingerprint(p, pipeline="", mode=mode, extra=_search_signature(
            caps_in, rel_caps, moves, unroll_factors, tile_sizes,
            max_candidates, verify, seeds, selector, macro_moves))
        blob = store.get(fkey)
        if blob is not None and (blob.get("verified") or not verify):
            try:
                return _unpack_pareto(blob, p)
            except (ValueError, KeyError, TypeError, IndexError):
                pass  # stale entry: recompute (the put below overwrites it)

    repairs0 = store.repairs if store is not None else 0
    extra_events: list[dict] = []  # parent-side events not tied to a candidate

    baseline = measure_candidate(p, "baseline", [], verify=verify,
                                 seeds=seeds, mode=mode, store=store)
    for k, scale in (rel_caps or {}).items():
        ceil = scale * baseline.res[k]
        caps[k] = min(caps.get(k, ceil), ceil)

    def fits(c: DSECandidate) -> list[str]:
        return c.res.violations(caps)

    baseline.within_budget = not fits(baseline)
    baseline.status = "baseline"
    candidates = [baseline]
    rejected: list[tuple[str, str]] = []
    archive: list[DSECandidate] = [baseline] if baseline.within_budget else []
    if not archive:
        rejected.append((baseline.desc,
                         "over budget: " + "; ".join(fits(baseline))))
    equeue = _ExpansionQueue(selector)
    equeue.push(baseline)  # expand even an infeasible root
    seen_descs = {"baseline"}
    compiles = 1
    base_moves = _single_moves(p, moves, unroll_factors, tile_sizes)

    sup = None
    if int(jobs) > 1:
        sup = _PoolSupervisor(int(jobs), worker_deadline_s)
        if sup.pool is None:
            sup = None  # graceful serial fallback

    def insert(c: DSECandidate) -> None:
        """Capacity check + dominance-pruned archive insertion."""
        viol = fits(c)
        if viol:
            c.within_budget = False
            c.status = "over budget: " + "; ".join(viol)
            rejected.append((c.desc, c.status))
            return
        vec = c.objectives()
        for a in archive:
            avec = a.objectives()
            if dominates(avec, vec) or avec == vec:
                c.status = f"dominated by {a.desc}"
                return
        newly_dominated = [a for a in archive
                           if dominates(vec, a.objectives())]
        if newly_dominated:
            for a in newly_dominated:
                # flipping the status is what lazily invalidates the
                # queue entry — no O(n) removal here
                a.status = f"dominated by {c.desc}"
            dead = {id(a) for a in newly_dominated}
            archive[:] = [a for a in archive if id(a) not in dead]
        archive.append(c)
        c.status = "frontier"
        equeue.push(c)

    try:
        while compiles < max_candidates:
            cur = equeue.pop(archive)
            if cur is None:
                break
            base_descs = cur.desc.split(" | ") if cur.passes else []
            # tile moves are re-derived from the expansion base: fusion
            # renames loops, so tiling the *fused* nest (the knob the CUDA
            # kernel layer reads as its block size) is only reachable this way
            level_moves = list(base_moves)
            if "tile" in moves:
                level_moves += [
                    (t.name, t) for t in _tile_moves(cur.program, tile_sizes)
                    if t.name not in {d for d, _ in base_moves}]
            if macro_moves and not any(d.startswith("fuse")
                                       for d in base_descs):
                ev0 = faults.event_count()
                level_moves += _macro_moves(cur.program, moves,
                                            unroll_factors, tile_sizes)
                # the structural fuse probe can itself hit a degraded
                # legality check — capture those events here, they belong
                # to no measured candidate
                extra_events.extend(faults.events_since(ev0))
            wave = []
            for desc, mv in level_moves:
                if desc in base_descs:
                    continue
                full = " | ".join(base_descs + [desc])
                if full in seen_descs:
                    continue
                wave.append((full, [mv] if isinstance(mv, Pass)
                             else list(mv)))
            results = _measure_wave(wave, cur, p, sup, store, verify,
                                    seeds, mode)
            # deterministic merge: replay in submission order with the same
            # cap / no-op / insert logic as the serial engine
            for (full, mvs), c in zip(wave, results):
                if full in seen_descs:
                    continue
                if compiles >= max_candidates:
                    break
                seen_descs.add(full)
                if isinstance(c, _WorkerFault):
                    rejected.append((full, c.reason))
                    extra_events.append({"kind": "worker-quarantine",
                                         "candidate": full,
                                         "reason": c.reason})
                    continue
                if isinstance(c, _CompileFailed):
                    rejected.append((full, f"compile-error: {c.error}"))
                    extra_events.append({"kind": "compile-error",
                                         "candidate": full,
                                         "error": c.error})
                    continue
                if c is _PENDING:
                    ev0 = faults.event_count()
                    try:
                        c = measure_candidate(p, full, mvs, base=cur.program,
                                              base_passes=cur.passes,
                                              verify=verify, seeds=seeds,
                                              mode=mode, store=store)
                    except (TransformError, CompileError) as e:
                        rejected.append((full, f"compile-error: {e}"))
                        extra_events.append({"kind": "compile-error",
                                             "candidate": full,
                                             "error": str(e)})
                        continue
                    if c is None:
                        # keep degradations behind a no-op verdict
                        extra_events.extend(
                            {**e, "candidate": full}
                            for e in faults.events_since(ev0))
                if c is None:
                    continue  # the move applied nothing
                compiles += 1
                candidates.append(c)
                insert(c)
                if verbose:
                    print(f"  dse: {full}: latency={c.latency} "
                          f"res={dict(c.res)} [{c.status}]")
    finally:
        if sup is not None:
            sup.close()

    frontier = sorted(archive, key=lambda c: c.objectives())
    diagnostics: list[dict] = []
    for c in candidates:
        diagnostics.extend({**d, "candidate": c.desc} for d in c.diags)
    diagnostics.extend(extra_events)
    if sup is not None:
        diagnostics.extend(sup.events)
    if store is not None and store.repairs > repairs0:
        diagnostics.append({"kind": "cache-repair",
                            "count": store.repairs - repairs0})
    diagnostics = dedupe_diagnostics(diagnostics)
    degraded = (any(c.provenance != "exact" for c in candidates)
                or _degrading(diagnostics))
    result = ParetoResult(baseline=baseline, frontier=frontier,
                          candidates=candidates, rejected=rejected,
                          caps=caps, compiles=compiles,
                          diagnostics=diagnostics,
                          provenance="degraded" if degraded else "exact")
    if store is not None and fkey is not None:
        blob = _pack_pareto(result, verify)  # None for degraded results
        if blob is not None:
            store.put(fkey, blob)
    return result


# ---------------------------------------------------------------------------
# The pre-Pareto greedy driver, kept verbatim as the no-regression oracle:
# benchmarks/run.py pareto and tests/test_api.py compare every new frontier
# against this single-frontier hill climb's winner.
# ---------------------------------------------------------------------------


def _greedy_explore(p: Program, budget: Optional[dict[str, float]] = None, *,
                    unroll_factors: Sequence[int] = (2, 4),
                    tile_sizes: Sequence[int] = (4,),
                    max_candidates: int = 24,
                    verify: bool = True,
                    validate: bool = False,
                    seeds: Sequence[int] = (0,),
                    verbose: bool = False) -> DSEResult:
    """Greedy single-frontier resource-aware DSE (the old ``explore``).

    ``budget=None`` means iso-resource (baseline BRAM/DSP as ceilings);
    search = every single move, then greedy composition on top of the best
    within-budget candidate, bounded by ``max_candidates`` compilations.
    """
    def measure(desc, passes, base=None, base_passes=()):
        return measure_candidate(p, desc, passes, base=base,
                                 base_passes=base_passes, verify=verify,
                                 seeds=seeds)

    baseline = measure("baseline", [])
    if budget is None:
        budget = {"bram_bytes": baseline.res["bram_bytes"],
                  "dsp": baseline.res["dsp"]}
    budget = dict(budget)
    unknown = set(budget) - set(baseline.res)
    if unknown:
        raise ValueError(
            f"unknown budget resource(s) {sorted(unknown)}; "
            f"valid keys: {sorted(baseline.res)}")
    baseline.within_budget = _budget_key(baseline.res, budget)

    moves = _single_moves(p, MOVE_FAMILIES, unroll_factors, tile_sizes)
    candidates: list[DSECandidate] = [baseline]
    seen_descs = {"baseline"}
    compiles = 1

    def try_pipeline(descs, passes, base=None, base_passes=()):
        nonlocal compiles
        desc = " | ".join(descs)
        if desc in seen_descs or compiles >= max_candidates:
            return None
        seen_descs.add(desc)
        c = measure(desc, passes, base=base, base_passes=base_passes)
        if c is not None:
            compiles += 1  # only actual compilations count against the cap
            c.within_budget = _budget_key(c.res, budget)
            candidates.append(c)
            if verbose:
                print(f"  dse: {desc}: latency={c.latency} res={c.res} "
                      f"{'OK' if c.within_budget else 'OVER-BUDGET'}")
        return c

    for desc, mv in moves:
        try_pipeline([desc], [mv])

    def best_of(cands):
        ok = [c for c in cands if c.within_budget]
        pool = ok or cands
        return min(pool, key=lambda c: (c.latency, c.res["bram_bytes"],
                                        c.res["dsp"], c.res["ff_bits"]))

    frontier = best_of(candidates)
    while compiles < max_candidates:
        base_descs = frontier.desc.split(" | ") if frontier.passes else []
        level_moves = moves + [
            (t.name, t) for t in _tile_moves(frontier.program, tile_sizes)
            if t.name not in {d for d, _ in moves}]
        for desc, mv in level_moves:
            if desc not in base_descs:
                try_pipeline(base_descs + [desc], [mv],
                             base=frontier.program,
                             base_passes=frontier.passes)
        nxt = best_of(candidates)
        if nxt is frontier:
            break
        frontier = nxt

    best = best_of(candidates)
    if validate:
        validate_candidate(best, seeds)
    return DSEResult(baseline=baseline, best=best, candidates=candidates,
                     budget=budget)
