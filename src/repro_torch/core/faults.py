"""Deterministic fault-injection harness (DESIGN.md §9).

The solver (`ilp.solve_ilp`), the DSE pool workers (`autotune._measure_worker`)
and the persistent cache (`cache.CacheStore.get/put`) each consult this module
at well-defined fault points.  An active :class:`FaultPlan` decides — purely
from its seed and the *content* of the fault point, never from wall-clock time
or process identity — whether the fault fires.  That makes chaos runs
reproducible: the same plan against the same workload injects the same faults
regardless of scheduling order, worker count, or which process asks.

Activation is process-transitive: :func:`inject` installs the plan in-process
*and* exports it through ``REPRO_HLS_FAULTS`` so fork/spawn pool workers
observe the same plan.

The module also carries a process-local diagnostics stream (:func:`note`):
degradations, retries, quarantines and cache repairs are recorded here and
surfaced on ``CompileResult.diagnostics``.  Events recorded inside a pool
worker travel back to the parent attached to the measured candidate.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import time
from dataclasses import dataclass
from typing import Iterator, Optional

ENV_VAR = "REPRO_HLS_FAULTS"

#: event kinds that mean "the result may legitimately diverge from a
#: fault-free run" — anything else (retries, repairs, rebuilds) is recovered
#: transparently and must not change the frontier.
DEGRADING_KINDS = frozenset({
    "solver-degraded",
    "fusion-hazard-degraded",
    "dep-distance-degraded",
    "worker-quarantine",
    "compile-error",
    # the static validator could not *prove* the winner safe (truncated
    # emptiness checks, e.g. under injected solver deadlines)
    "validate-unresolved",
})


class InjectedWorkerCrash(RuntimeError):
    """Raised inside a pool worker when the ``worker_crash`` fault fires."""


@dataclass(frozen=True)
class FaultPlan:
    """A seeded, declarative fault schedule.

    Rates are probabilities in [0, 1]; 0 disables a site, 1 always fires.
    ``crash_attempts``/``hang_attempts`` optionally restrict worker faults to
    specific retry attempts (empty = every attempt), which lets tests script
    "fails once, then recovers" deterministically.  ``script`` maps a site
    name to exact per-process call indices and overrides the rate for that
    site entirely.
    """
    seed: int = 0
    solver_timeout: float = 0.0
    worker_crash: float = 0.0
    worker_crash_hard: float = 0.0
    worker_hang: float = 0.0
    cache_corrupt: float = 0.0
    hang_seconds: float = 30.0
    crash_attempts: tuple[int, ...] = ()
    hang_attempts: tuple[int, ...] = ()
    script: tuple[tuple[str, tuple[int, ...]], ...] = ()

    def rate(self, site: str) -> float:
        return float(getattr(self, site, 0.0))

    def to_json(self) -> str:
        return json.dumps({
            "seed": self.seed,
            "solver_timeout": self.solver_timeout,
            "worker_crash": self.worker_crash,
            "worker_crash_hard": self.worker_crash_hard,
            "worker_hang": self.worker_hang,
            "cache_corrupt": self.cache_corrupt,
            "hang_seconds": self.hang_seconds,
            "crash_attempts": list(self.crash_attempts),
            "hang_attempts": list(self.hang_attempts),
            "script": [[s, list(idxs)] for s, idxs in self.script],
        }, separators=(",", ":"))

    @staticmethod
    def from_json(raw: str) -> "FaultPlan":
        d = json.loads(raw)
        return FaultPlan(
            seed=int(d.get("seed", 0)),
            solver_timeout=float(d.get("solver_timeout", 0.0)),
            worker_crash=float(d.get("worker_crash", 0.0)),
            worker_crash_hard=float(d.get("worker_crash_hard", 0.0)),
            worker_hang=float(d.get("worker_hang", 0.0)),
            cache_corrupt=float(d.get("cache_corrupt", 0.0)),
            hang_seconds=float(d.get("hang_seconds", 30.0)),
            crash_attempts=tuple(int(a) for a in d.get("crash_attempts", [])),
            hang_attempts=tuple(int(a) for a in d.get("hang_attempts", [])),
            script=tuple((str(s), tuple(int(i) for i in idxs))
                         for s, idxs in d.get("script", [])),
        )


_ACTIVE: Optional[FaultPlan] = None
_ACTIVE_LOADED = False  # fresh (spawned) processes lazily read ENV_VAR once
_COUNTERS: dict[str, int] = {}
_EVENTS: list[dict] = []
_EVENTS_CAP = 4096


def active() -> Optional[FaultPlan]:
    """The plan in effect for this process, if any."""
    global _ACTIVE, _ACTIVE_LOADED
    if not _ACTIVE_LOADED:
        _ACTIVE_LOADED = True
        raw = os.environ.get(ENV_VAR)
        if raw:
            try:
                _ACTIVE = FaultPlan.from_json(raw)
            except Exception:
                _ACTIVE = None
    return _ACTIVE


@contextlib.contextmanager
def inject(*, seed: int = 0, solver_timeout: float = 0.0,
           worker_crash: float = 0.0, worker_crash_hard: float = 0.0,
           worker_hang: float = 0.0, cache_corrupt: float = 0.0,
           hang_seconds: float = 30.0,
           crash_attempts: tuple[int, ...] = (),
           hang_attempts: tuple[int, ...] = (),
           script: tuple[tuple[str, tuple[int, ...]], ...] = (),
           ) -> Iterator[FaultPlan]:
    """Activate a fault plan for the dynamic extent of the ``with`` block."""
    plan = FaultPlan(seed=seed, solver_timeout=solver_timeout,
                     worker_crash=worker_crash,
                     worker_crash_hard=worker_crash_hard,
                     worker_hang=worker_hang, cache_corrupt=cache_corrupt,
                     hang_seconds=hang_seconds,
                     crash_attempts=tuple(crash_attempts),
                     hang_attempts=tuple(hang_attempts),
                     script=tuple((s, tuple(i)) for s, i in script))
    global _ACTIVE, _ACTIVE_LOADED
    prev, prev_loaded = _ACTIVE, _ACTIVE_LOADED
    prev_env = os.environ.get(ENV_VAR)
    prev_counters = dict(_COUNTERS)
    _ACTIVE, _ACTIVE_LOADED = plan, True
    _COUNTERS.clear()
    os.environ[ENV_VAR] = plan.to_json()
    try:
        yield plan
    finally:
        _ACTIVE, _ACTIVE_LOADED = prev, prev_loaded
        _COUNTERS.clear()
        _COUNTERS.update(prev_counters)
        if prev_env is None:
            os.environ.pop(ENV_VAR, None)
        else:
            os.environ[ENV_VAR] = prev_env


def reset() -> None:
    """Deactivate any plan and clear counters/events (test hygiene)."""
    global _ACTIVE, _ACTIVE_LOADED
    _ACTIVE = None
    _ACTIVE_LOADED = False
    _COUNTERS.clear()
    _EVENTS.clear()


def should_fire(site: str, key: Optional[str] = None) -> bool:
    """Decide whether the fault at ``site`` fires for this consultation.

    With a ``key`` the decision is a pure function of (seed, site, key), so
    identical work items get identical faults in every process.  Without a
    key the per-process call counter stands in.  A ``script`` entry for the
    site overrides the rate with exact call indices.
    """
    plan = active()
    if plan is None:
        return False
    n = _COUNTERS.get(site, 0)
    _COUNTERS[site] = n + 1
    for s, idxs in plan.script:
        if s == site:
            return n in idxs
    rate = plan.rate(site)
    if rate <= 0.0:
        return False
    if rate >= 1.0:
        return True
    tag = key if key is not None else str(n)
    h = hashlib.sha256(f"{plan.seed}|{site}|{tag}".encode()).digest()
    return int.from_bytes(h[:8], "big") / 2.0 ** 64 < rate


def worker_fault_point(desc: str, attempt: int) -> None:
    """Fault point at pool-worker task entry (crash / hard-crash / hang)."""
    plan = active()
    if plan is None:
        return
    key = f"{desc}#a{attempt}"
    if not plan.crash_attempts or attempt in plan.crash_attempts:
        if should_fire("worker_crash_hard", key=key):
            os._exit(3)
        if should_fire("worker_crash", key=key):
            raise InjectedWorkerCrash(
                f"injected worker crash: {desc} (attempt {attempt})")
    if not plan.hang_attempts or attempt in plan.hang_attempts:
        if should_fire("worker_hang", key=key):
            time.sleep(plan.hang_seconds)


def note(kind: str, **info) -> None:
    """Record a diagnostic event in the process-local stream."""
    if len(_EVENTS) >= _EVENTS_CAP:
        del _EVENTS[:_EVENTS_CAP // 2]
    _EVENTS.append({"kind": kind, **info})


def event_count() -> int:
    return len(_EVENTS)


def events_since(mark: int) -> list[dict]:
    return [dict(e) for e in _EVENTS[mark:]]
