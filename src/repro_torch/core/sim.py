"""Reference interpreters + schedule validator.

Three oracles back the correctness story of the scheduler:

1. ``sequential_exec``  — runs the affine program in original program order
   (the semantics the schedule must preserve).
2. ``timed_exec``       — executes every dynamic op instance at its scheduled
   absolute time, with memory writes committing after wr_latency; produces
   the arrays the *hardware* would produce.
3. ``validate_schedule``— brute-force enumeration of dynamic instance pairs:
   every memory dependence must be separated by its delay, and no two
   accesses may share a (array, bank, port) in the same cycle.

Property tests assert timed_exec == sequential_exec and validate_schedule
passes on randomly generated affine programs.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

import numpy as np

from .ir import ArithOp, ConstOp, LoadOp, Loop, Program, StoreOp
from .scheduler import Schedule

_FNS = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "div": lambda a, b: a / b,
    "min": min,
    "max": max,
    "cmp": lambda a, b: float(a > b),
    # unary: the tracing frontend emits these for softmax / decay math
    "exp": lambda a: float(np.exp(np.float64(a))),
}


def make_inputs(p: Program, seed: int = 0) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {name: rng.uniform(0.5, 2.0, size=a.shape).astype(np.float64)
            for name, a in p.arrays.items()}


def sequential_exec(p: Program, arrays: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    mem = {k: v.copy() for k, v in arrays.items()}

    def run(items, env):
        for it in items:
            if isinstance(it, Loop):
                for v in range(it.lb, it.ub):
                    env2 = dict(env)
                    env2[it.ivname] = v
                    run(it.body, env2)
            elif isinstance(it, ConstOp):
                env[it.result] = it.value
            elif isinstance(it, LoadOp):
                idx = tuple(e.eval(env) for e in it.index)
                env[it.result] = mem[it.array][idx]
            elif isinstance(it, StoreOp):
                idx = tuple(e.eval(env) for e in it.index)
                mem[it.array][idx] = env[it.value]
            elif isinstance(it, ArithOp):
                env[it.result] = _FNS[it.fn](*[env[a] for a in it.args])
        return env

    run(p.body, {})
    return mem


# ---------------------------------------------------------------------------
# Dynamic-instance enumeration
# ---------------------------------------------------------------------------


def _instances(p: Program, s: Schedule):
    """Yield (op, env, abs_time, seq_key) for every dynamic op instance."""

    def rec(items, env, anc):
        for pos, it in enumerate(items):
            if isinstance(it, Loop):
                for v in range(it.lb, it.ub):
                    env2 = dict(env)
                    env2[it.ivname] = v
                    yield from rec(it.body, env2, anc + [(it, v, pos)])
            else:
                # matches the dependence-ILP convention T = theta + sum(II*iv)
                t = s.theta[it.uid] + sum(s.iis[l.uid] * v for l, v, _ in anc)
                seq = tuple(x for _, v, ps in anc for x in (ps, v)) + (pos,)
                yield it, env, t, seq

    yield from rec(p.body, {}, [])


def timed_exec(p: Program, s: Schedule,
               arrays: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    mem = {k: v.copy() for k, v in arrays.items()}
    events = sorted(_instances(p, s), key=lambda e: (e[2], e[3]))
    # committed writes: (array, idx) -> list[(commit_time, value)] in commit order
    ssa: dict[tuple, float] = {}  # (ssa name, iteration env key) is implicit:
    # we store values per (op uid, env items of its ancestors) via seq key env.

    # Simpler: evaluate lazily with per-instance env dict carried in events.
    # pending[(arr, idx)] = (commit_times sorted ascending, values) — events
    # are processed in (t, seq) order and every write to one key shares the
    # array's wr_latency, so commits arrive already sorted and appends keep
    # the invariant; a read is then one bisect instead of a linear rescan
    # (the old O(writes) scan per load made large differential tests O(n^2)).
    pending: dict[tuple, tuple[list[int], list[float]]] = {}

    def read_mem(arr, idx, t):
        entry = pending.get((arr, idx))
        if entry is None:
            return mem[arr][idx]
        times, vals = entry
        k = bisect.bisect_right(times, t)
        # ties on commit time: bisect_right lands after the last equal
        # entry, so the most recently issued write wins (same rule as the
        # final-value reduction below)
        return mem[arr][idx] if k == 0 else vals[k - 1]

    # op uid -> ivnames visible at its region (for cross-region SSA lookups)
    ivscope: dict[int, tuple[str, ...]] = {}
    for node, anc in p.walk():
        ivscope[node.uid] = tuple(l.ivname for l in anc)

    values: dict[tuple[int, tuple], float] = {}

    def vkey(op_uid, env):
        return (op_uid, tuple((n, env[n]) for n in ivscope[op_uid]))

    def lookup(name, env):
        d = _def_of(p, name)
        return values[vkey(d.uid, env)]

    for op, env, t, _ in events:
        if isinstance(op, ConstOp):
            values[vkey(op.uid, env)] = op.value
        elif isinstance(op, LoadOp):
            idx = tuple(e.eval(env) for e in op.index)
            values[vkey(op.uid, env)] = read_mem(op.array, idx, t)
        elif isinstance(op, ArithOp):
            args = [lookup(a, env) for a in op.args]
            values[vkey(op.uid, env)] = _FNS[op.fn](*args)
        elif isinstance(op, StoreOp):
            idx = tuple(e.eval(env) for e in op.index)
            v = lookup(op.value, env)
            commit = t + p.arrays[op.array].wr_latency
            times, vals = pending.setdefault((op.array, idx), ([], []))
            if times and commit < times[-1]:  # defensive; see invariant above
                k = bisect.bisect_right(times, commit)
                times.insert(k, commit)
                vals.insert(k, v)
            else:
                times.append(commit)
                vals.append(v)

    for (arr, idx), (times, vals) in pending.items():
        # final value = last committed write (ties: most recently issued)
        mem[arr][idx] = vals[-1]
    return mem


def _def_of(p: Program, name: str):
    # cache lives on the Program instance (id()-keyed caches are unsound:
    # CPython reuses addresses after GC)
    cache = getattr(p, "_def_cache", None)
    if cache is None:
        cache = {}
        for node, _ in p.walk():
            if not isinstance(node, Loop) and node.result is not None:
                cache[node.result] = node
        p._def_cache = cache
    return cache[name]


# ---------------------------------------------------------------------------
# Brute-force validator
# ---------------------------------------------------------------------------


def validate_schedule(p: Program, s: Schedule) -> list[str]:
    """Return a list of violations (empty = valid).  Exponential in program
    size — use on small/reduced programs (tests) only."""
    violations = []
    mem_events = []  # (array, idx, is_write, t, seq, port, uid)
    for op, env, t, seq in _instances(p, s):
        if isinstance(op, (LoadOp, StoreOp)):
            idx = tuple(e.eval(env) for e in op.index)
            mem_events.append((op.array, idx, isinstance(op, StoreOp), t, seq,
                               op.port, op.uid))

    by_addr = defaultdict(list)
    for ev in mem_events:
        by_addr[(ev[0], ev[1])].append(ev)
    for key, evs in by_addr.items():
        evs.sort(key=lambda e: e[4])  # sequential order
        for i in range(len(evs)):
            for j in range(i + 1, len(evs)):
                a, b = evs[i], evs[j]
                if not (a[2] or b[2]):
                    continue
                arr = p.arrays[a[0]]
                if a[2] and not b[2]:
                    delay = arr.wr_latency  # RAW
                else:
                    delay = 1  # WAR / WAW
                if b[3] < a[3] + delay:
                    violations.append(
                        f"dep violation {key}: seq-earlier t={a[3]} "
                        f"(write={a[2]}) vs later t={b[3]} (write={b[2]})")

    # port conflicts: same (array, bank, port) in the same cycle
    by_cycle = defaultdict(list)
    for arr_name, idx, is_w, t, seq, port, uid in mem_events:
        arr = p.arrays[arr_name]
        if arr.kind == "reg":
            continue
        bank = tuple(idx[d] for d in arr.partition)
        by_cycle[(arr_name, bank, port, t)].append(uid)
    for key, uids in by_cycle.items():
        if len(uids) > 1:
            violations.append(f"port conflict on {key[0]} bank={key[1]} "
                              f"port={key[2]} cycle={key[3]}: ops {uids}")
    return violations
