"""Independent static verification: IR linter + schedule translation
validation (DESIGN.md §12).

Two levels, deliberately *outside* the machinery that produces schedules:

**Level 1 — :func:`lint`** is a whole-program IR linter needing no schedule:
affine access bounds vs array shapes (out-of-bounds reads/writes, including
shifted/peeled fusion cores and frontend affine views), use-before-def
across tasks, dead stores / never-read arrays, multi-writer hazards, SSA
scoping, and pragma consistency (tile/partition/unroll/peel markers).  Every
finding is a structured :class:`~repro_torch.core.errors.Diagnostic` — linting
never raises.

**Level 2 — :func:`validate_static`** is a translation validator: given a
``(program, schedule)`` pair it *re-derives* the legality of the (II, theta)
assignment from first principles and checks every conflicting dynamic-
instance pair is separated by its required delay.  Each dependence case
becomes a polyhedral **emptiness check** run directly on the branch-and-
bound :func:`~repro_torch.core.ilp.solve_ilp`:

    exists iteration vectors x (src) and y (snk) with
        loop bounds  AND  address equality  AND  happens-before(case)
        AND  T(snk, y) <= T(src, x) + delay - 1        <- the violation

A feasible point is a concrete counterexample (reported in the verdict); an
infeasible system proves the case safe.  Port/bank conflicts under
``array_partition`` use the same machinery with the address equality
restricted to the partitioned dims and the separation replaced by
equal-time.  The module intentionally shares **nothing** with ``deps.py`` —
no fast-path slack solver, no pair cache, no Access/DepEdge types — so a
bug in the dependence analysis cannot hide itself from the validator (the
only shared substrate is the IR and the generic ILP solver, which deps
itself only trusts as a fallback).

``python -m repro_torch.core.analysis [names... | --all]`` runs the linter (and
optionally the validator) over the benchmark corpus; CI runs it on every
push and fails on any non-pinned error.
"""
from __future__ import annotations

import argparse
import sys
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from .errors import Diagnostic
from .ilp import solve_ilp
from .ir import (AffExpr, ArithOp, LoadOp, Loop, Program, StoreOp,
                 position_keys)

__all__ = ["Diagnostic", "Verdict", "lint", "validate_static",
           "corrupt_schedule", "LINT_CODES", "VALIDATE_CODES",
           "EXPECTED_LINT", "corpus_programs", "main"]


#: Every lint code with a one-line meaning (the DESIGN.md §12 table).
LINT_CODES = {
    "oob-read":       "a load's affine index can exceed the array bounds",
    "oob-write":      "a store's affine index can exceed the array bounds",
    "rank-mismatch":  "access index arity differs from the array rank",
    "unknown-array":  "access names an undeclared array",
    "unbound-iv":     "access index uses a variable no enclosing loop binds",
    "read-uninitialized": "non-arg array is read but never written",
    "use-before-def": "non-arg array's first access in program order is a read",
    "never-read":     "non-arg array is written but never read (dead stores)",
    "unused-array":   "declared array is never accessed",
    "multi-writer":   "array written by several tasks, none of them a carry",
    "nonzero-base":   "non-unrolled loop lower bound != 0 (normalize contract)",
    "empty-loop":     "loop trip count <= 0",
    "bad-ii":         "explicit II pragma < 1",
    "unnormalized-unroll": "unroll marker survived normalization",
    "tile-marker":    "tile_block marker inconsistent with the strip pair",
    "orphan-peel":    "top-level peel loop without a fuse group",
    "partition-dim":  "array_partition names an out-of-range/duplicate dim",
    "missing-port":   "array accessed through a port kind it does not have",
    "undef-ssa":      "op consumes an SSA name with no visible definition",
    "unknown-fn":     "ArithOp.fn has no latency in Program.op_delays",
}

#: Every validator code (all severity "error" — a failed verdict).
VALIDATE_CODES = {
    "missing-ii":     "schedule has no II for a loop",
    "missing-theta":  "schedule has no start offset for an op/loop",
    "infeasible-schedule": "schedule is marked infeasible",
    "occupancy":      "II_outer < trip_inner * II_inner for a nested loop",
    "ssa-order":      "a use starts before its def's latency has elapsed",
    "struct-order":   "an op starts before its enclosing loop",
    "dep-violated":   "a conflicting instance pair runs closer than its delay",
    "port-conflict":  "two same-port same-bank accesses in the same cycle",
    "fuse-no-core":   "a fuse group consists only of peel loops",
    "orphan-peel":    "top-level peel loop without a fuse group",
    "unresolved":     "an emptiness check was truncated (cannot prove safety)",
}

#: Pinned expected lint findings per corpus program (satellite goldens):
#: ``name -> {code, ...}``.  The CLI (and CI) fails on any error-severity
#: finding whose code is not pinned here; pinned codes are reported but
#: accepted.  An empty corpus entry means "must lint clean".
EXPECTED_LINT: dict[str, set] = {}


# ---------------------------------------------------------------------------
# Level 1 — IR linter
# ---------------------------------------------------------------------------


def _iv_bounds(ancestors: Sequence[Loop]) -> dict[str, tuple[int, int]]:
    """Inclusive [lb, ub-1] range per enclosing iv, inner shadowing outer."""
    return {l.ivname: (l.lb, l.ub - 1) for l in ancestors}


def _lint_arrays(p: Program, out: list[Diagnostic]) -> None:
    for arr in p.arrays.values():
        rank = len(arr.shape)
        seen = set()
        for d in arr.partition:
            if not (0 <= d < rank) or d in seen:
                out.append(Diagnostic(
                    "partition-dim", f"{p.name}/{arr.name}", "error",
                    f"partition dim {d} invalid for rank-{rank} array "
                    f"{arr.name} (partition={arr.partition})"))
            seen.add(d)


def _lint_loops(p: Program, out: list[Diagnostic]) -> None:
    top = {id(it) for it in p.body}
    for loop, anc in p.walk():
        if not isinstance(loop, Loop):
            continue
        where = f"{p.name}/loop {loop.ivname}"
        if loop.trip <= 0:
            out.append(Diagnostic("empty-loop", where, "warning",
                                  f"trip count {loop.trip} <= 0 "
                                  f"([{loop.lb}, {loop.ub}))"))
        if not loop.unroll and loop.lb != 0:
            out.append(Diagnostic(
                "nonzero-base", where, "error",
                f"lower bound {loop.lb} != 0 on a non-unrolled loop "
                "(the normalize contract; scheduler latency accounting "
                "assumes rebased loops)"))
        if loop.unroll:
            out.append(Diagnostic(
                "unnormalized-unroll", where, "warning",
                "unroll marker present — normalize() should have expanded "
                "this loop"))
        if loop.ii is not None and loop.ii < 1:
            out.append(Diagnostic("bad-ii", where, "error",
                                  f"explicit II pragma {loop.ii} < 1"))
        if loop.tile_block is not None:
            subs = loop.sub_loops()
            ok = (len(loop.body) == 1 and len(subs) == 1
                  and subs[0].trip == loop.tile_block)
            if not ok:
                out.append(Diagnostic(
                    "tile-marker", where, "error",
                    f"tile_block={loop.tile_block} but the strip pair is "
                    f"gone (body has {len(loop.body)} items, inner trips "
                    f"{[s.trip for s in subs]})"))
        if loop.peel and id(loop) in top and loop.fuse_group is None:
            out.append(Diagnostic(
                "orphan-peel", where, "warning",
                "top-level peel loop carries no fuse_group — its datapath "
                "cannot be shared with a fused core"))


def _lint_accesses(p: Program, out: list[Diagnostic]) -> None:
    for op, anc in p.walk():
        if not isinstance(op, (LoadOp, StoreOp)):
            continue
        what = "load" if isinstance(op, LoadOp) else "store"
        where = f"{p.name}/{op.array}[{what} uid={op.uid}]"
        arr = p.arrays.get(op.array)
        if arr is None:
            out.append(Diagnostic("unknown-array", where, "error",
                                  f"{what} of undeclared array {op.array!r}"))
            continue
        if len(op.index) != len(arr.shape):
            out.append(Diagnostic(
                "rank-mismatch", where, "error",
                f"{what} index rank {len(op.index)} != array rank "
                f"{len(arr.shape)}"))
            continue
        bounds = _iv_bounds(anc)
        for d, e in enumerate(op.index):
            e = e if isinstance(e, AffExpr) else AffExpr({}, int(e))
            missing = [n for n in e.coeffs if n not in bounds]
            if missing:
                out.append(Diagnostic(
                    "unbound-iv", where, "error",
                    f"index dim {d} uses unbound variable(s) {missing} "
                    f"(enclosing ivs: {sorted(bounds)})"))
                continue
            lo, hi = e.interval(bounds)
            if lo < 0 or hi >= arr.shape[d]:
                out.append(Diagnostic(
                    "oob-write" if what == "store" else "oob-read",
                    where, "error",
                    f"index dim {d} = {e!r} ranges [{lo}, {hi}] outside "
                    f"[0, {arr.shape[d]})"))
        if arr.kind != "reg":
            ports = (arr.write_ports() if what == "store"
                     else arr.read_ports())
            if not ports:
                out.append(Diagnostic(
                    "missing-port", where, "error",
                    f"{what} of {arr.name} but ports={arr.ports} has no "
                    f"{'write' if what == 'store' else 'read'} port"))


def _task_index(p: Program) -> dict[int, int]:
    """op/loop uid -> index of its top-level task in ``Program.body``."""
    tix: dict[int, int] = {}
    for i, item in enumerate(p.body):
        tix[item.uid] = i
        if isinstance(item, Loop):
            stack = list(item.body)
            while stack:
                it = stack.pop()
                tix[it.uid] = i
                if isinstance(it, Loop):
                    stack.extend(it.body)
    return tix


def _lint_liveness(p: Program, out: list[Diagnostic]) -> None:
    first: dict[str, str] = {}      # array -> "r" | "w" of first access
    readers: dict[str, set] = {}    # array -> reader task indices
    writers: dict[str, set] = {}    # array -> writer task indices
    tix = _task_index(p)
    for op, _ in p.walk():
        if isinstance(op, LoadOp):
            first.setdefault(op.array, "r")
            readers.setdefault(op.array, set()).add(tix[op.uid])
        elif isinstance(op, StoreOp):
            first.setdefault(op.array, "w")
            writers.setdefault(op.array, set()).add(tix[op.uid])
    for name, arr in p.arrays.items():
        where = f"{p.name}/{name}"
        rs, ws = readers.get(name, set()), writers.get(name, set())
        if not rs and not ws:
            out.append(Diagnostic("unused-array", where, "warning",
                                  f"array {name} is never accessed"))
            continue
        if arr.is_arg:
            pass  # args are externally initialized and externally observed
        elif rs and not ws:
            out.append(Diagnostic(
                "read-uninitialized", where, "error",
                f"non-arg array {name} is read but never written"))
        elif ws and not rs:
            out.append(Diagnostic(
                "never-read", where, "warning",
                f"non-arg array {name} is written but never read "
                "(dead stores)"))
        elif first.get(name) == "r":
            out.append(Diagnostic(
                "use-before-def", where, "warning",
                f"non-arg array {name} is read before its first write in "
                "program order (initial contents are undefined)"))
        # multi-writer: several top-level tasks store the array and none of
        # them also reads it (a read-write task is a recurrence carry, e.g.
        # a scan; fused peel+core groups share one datapath and are exempt)
        if len(ws) > 1 and not (ws & rs):
            groups = set()
            for i in ws:
                item = p.body[i]
                groups.add(item.fuse_group
                           if isinstance(item, Loop) else None)
            if len(groups) > 1 or groups == {None}:
                out.append(Diagnostic(
                    "multi-writer", where, "warning",
                    f"array {name} is written by tasks {sorted(ws)} with no "
                    "carry/fuse relationship (dataflow multi-producer "
                    "hazard)"))


def _lint_ssa(p: Program, out: list[Diagnostic]) -> None:
    def run(items, visible: set):
        for it in items:
            if isinstance(it, Loop):
                run(it.body, set(visible))
                continue
            where = f"{p.name}/op uid={it.uid}"
            uses = list(getattr(it, "args", ()) or ())
            if isinstance(it, StoreOp) and it.value:
                uses.append(it.value)
            for a in uses:
                if a not in visible:
                    out.append(Diagnostic(
                        "undef-ssa", where, "error",
                        f"op consumes SSA name {a!r} with no visible def "
                        "(defined in a sibling scope or not at all)"))
            if isinstance(it, ArithOp) and it.fn not in p.op_delays:
                out.append(Diagnostic(
                    "unknown-fn", where, "error",
                    f"ArithOp fn {it.fn!r} has no latency in op_delays"))
            if it.result is not None:
                visible.add(it.result)

    run(p.body, set())


def lint(program: Program) -> list[Diagnostic]:
    """Run every whole-program check; returns findings in a stable
    severity-first order.  Never raises on malformed programs — every
    problem becomes a :class:`Diagnostic`."""
    out: list[Diagnostic] = []
    _lint_arrays(program, out)
    _lint_loops(program, out)
    _lint_accesses(program, out)
    _lint_liveness(program, out)
    _lint_ssa(program, out)
    return sorted(out, key=Diagnostic.sort_key)


# ---------------------------------------------------------------------------
# Level 2 — schedule translation validation
# ---------------------------------------------------------------------------


@dataclass
class Verdict:
    """Result of :func:`validate_static`.

    ``ok`` is True only when every re-derived constraint was *proved*
    preserved: any violation witness or truncated (unprovable) emptiness
    check makes it False.  ``diagnostics`` carries one entry per problem;
    ``pairs``/``cases``/``ilp_calls`` record how much was checked (the
    interval prefilter resolves most cases without an ILP)."""

    ok: bool
    diagnostics: list[Diagnostic] = field(default_factory=list)
    pairs: int = 0
    cases: int = 0
    ilp_calls: int = 0
    unresolved: int = 0

    @property
    def violations(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics
                if d.severity == "error" and d.code != "unresolved"]

    def as_dicts(self) -> list[dict]:
        return [d.as_dict(kind="validate-static") for d in self.diagnostics]

    def __str__(self) -> str:
        head = ("ok" if self.ok else
                f"FAIL ({len(self.violations)} violations, "
                f"{self.unresolved} unresolved)")
        return (f"{head}: {self.pairs} pairs, {self.cases} cases, "
                f"{self.ilp_calls} ILP emptiness checks")


@dataclass(frozen=True)
class _Acc:
    """One memory access with its iteration context (re-derived locally —
    deliberately not deps.Access)."""

    op: object
    anc: tuple[Loop, ...]
    is_write: bool
    port: int

    @property
    def uid(self):
        return self.op.uid


def _collect(p: Program) -> dict[str, list[_Acc]]:
    """Accesses bucketed per array, ports resolved.

    Ports already assigned on the ops (by a prior scheduling run) are kept —
    they are part of the design being validated.  Unassigned ports (-1) are
    resolved with the documented policy (round-robin over compatible ports
    per array in program order) without mutating the program."""
    rr: dict[tuple[str, str], int] = {}
    by_array: dict[str, list[_Acc]] = {}
    for op, anc in p.walk():
        if not isinstance(op, (LoadOp, StoreOp)):
            continue
        arr = p.arrays[op.array]
        is_write = isinstance(op, StoreOp)
        if arr.kind == "reg":
            port = 0
        elif op.port >= 0:
            port = op.port
        else:
            ports = arr.write_ports() if is_write else arr.read_ports()
            if not ports:
                continue  # lint reports missing-port; nothing to bank-check
            key = (op.array, "w" if is_write else "r")
            k = rr.get(key, 0)
            port = ports[k % len(ports)]
            rr[key] = k + 1
        by_array.setdefault(op.array, []).append(
            _Acc(op=op, anc=tuple(anc), is_write=is_write, port=port))
    return by_array


def _prefix_len(a: tuple[Loop, ...], b: tuple[Loop, ...]) -> int:
    n = 0
    for x, y in zip(a, b):
        if x is not y:
            break
        n += 1
    return n


def _sep_range(X: _Acc, Y: _Acc, carry: Optional[int],
               iis: dict[int, int], theta: dict[int, int],
               want_hi: bool = False) -> tuple[int, int]:
    """Box bounds of T(Y, y) - T(X, x) over the case's iteration region,
    *ignoring address equality* — a sound relaxation used to skip the ILP:
    if even this lower bound reaches the delay, no instance pair of the
    case can violate it."""
    lo = hi = theta[Y.uid] - theta[X.uid]
    pfx = _prefix_len(X.anc, Y.anc)
    for k in range(pfx):
        l = X.anc[k]
        w, span = iis[l.uid], l.trip - 1
        if carry is None or k < carry:
            d_lo = d_hi = 0            # pinned equal
        elif k == carry:
            d_lo, d_hi = 1, span       # iv_src <= iv_snk - 1
        else:
            d_lo, d_hi = -span, span   # free after the carry level
        lo += w * d_lo
        hi += w * d_hi
    for l in X.anc[pfx:]:
        w = iis[l.uid]
        lo -= w * (l.ub - 1)
        hi -= w * l.lb
    for l in Y.anc[pfx:]:
        w = iis[l.uid]
        lo += w * l.lb
        hi += w * (l.ub - 1)
    return lo, hi


def _case_system(X: _Acc, Y: _Acc, carry: Optional[int],
                 eq_dims: Optional[Sequence[int]], arr_index_pairs) \
        -> tuple[list, list, list, list, list]:
    """Shared polyhedron of one happens-before case: loop bounds, address
    equality over ``eq_dims`` (None = every dim), prefix/carry rows.
    Columns are [x_0..x_{nx-1}, y_0..y_{ny-1}]."""
    la, lb_ = X.anc, Y.anc
    nx, n = len(la), len(la) + len(lb_)
    bounds = ([(l.lb, l.ub - 1) for l in la]
              + [(l.lb, l.ub - 1) for l in lb_])
    src_col = {l.ivname: i for i, l in enumerate(la)}
    snk_col = {l.ivname: nx + i for i, l in enumerate(lb_)}
    A_eq, b_eq, A_ub, b_ub = [], [], [], []
    for ex, ey in arr_index_pairs if eq_dims is None else \
            [arr_index_pairs[d] for d in eq_dims]:
        row = np.zeros(n)
        for nm, c in ex.coeffs.items():
            row[src_col[nm]] += c
        for nm, c in ey.coeffs.items():
            row[snk_col[nm]] -= c
        A_eq.append(row)
        b_eq.append(float(ey.const - ex.const))
    pfx = _prefix_len(la, lb_)
    stop = pfx if carry is None else carry
    for k in range(stop):
        row = np.zeros(n)
        row[k], row[nx + k] = 1.0, -1.0
        A_eq.append(row)
        b_eq.append(0.0)
    if carry is not None:
        row = np.zeros(n)
        row[carry], row[nx + carry] = 1.0, -1.0
        A_ub.append(row)
        b_ub.append(-1.0)  # iv_src <= iv_snk - 1
    return bounds, A_eq, b_eq, A_ub, b_ub


def _time_row(X: _Acc, Y: _Acc, iis: dict[int, int]) -> np.ndarray:
    """Coefficients of T(Y, y) - T(X, x) on [x..., y...] (thetas go to the
    right-hand side)."""
    nx, n = len(X.anc), len(X.anc) + len(Y.anc)
    row = np.zeros(n)
    for i, l in enumerate(X.anc):
        row[i] -= iis[l.uid]
    for i, l in enumerate(Y.anc):
        row[nx + i] += iis[l.uid]
    return row


class _Validator:
    def __init__(self, p: Program, s, fail_fast: bool):
        self.p = p
        self.s = s
        self.fail_fast = fail_fast
        self.v = Verdict(ok=True)
        self.pos = position_keys(p)

    def diag(self, code: str, where: str, detail: str) -> None:
        self.v.diagnostics.append(Diagnostic(code, where, "error", detail))
        self.v.ok = False

    @property
    def done(self) -> bool:
        return self.fail_fast and not self.v.ok

    # -- cheap structural re-checks ------------------------------------
    def check_complete(self) -> bool:
        s, p = self.s, self.p
        if not getattr(s, "feasible", True):
            self.diag("infeasible-schedule", p.name,
                      "schedule is marked infeasible")
            return False
        ok = True
        for l in p.loops():
            if s.iis.get(l.uid, 0) < 1:
                self.diag("missing-ii", f"{p.name}/loop {l.ivname}",
                          f"II {s.iis.get(l.uid)!r} missing or < 1")
                ok = False
        for node, _ in p.walk():
            if node.uid not in s.theta:
                self.diag("missing-theta", f"{p.name}/uid={node.uid}",
                          "no start offset in the schedule")
                ok = False
        return ok

    def check_occupancy(self) -> None:
        iis = self.s.iis
        for node, anc in self.p.walk():
            if self.done:
                return
            if isinstance(node, Loop) and anc:
                parent = anc[-1]
                need = node.trip * iis[node.uid]
                if iis[parent.uid] < need:
                    self.diag(
                        "occupancy",
                        f"{self.p.name}/loop {parent.ivname}",
                        f"II {iis[parent.uid]} < trip({node.ivname}) * "
                        f"II({node.ivname}) = {need}: the inner pipeline "
                        "is re-entered before it drains")

    def check_ssa_struct(self) -> None:
        p, theta = self.p, self.s.theta
        defs: dict[str, object] = {}
        for op, anc in p.walk():
            if self.done:
                return
            if anc and theta[op.uid] < theta[anc[-1].uid]:
                self.diag("struct-order", f"{p.name}/uid={op.uid}",
                          f"starts at {theta[op.uid]} before its loop "
                          f"{anc[-1].ivname} at {theta[anc[-1].uid]}")
            if isinstance(op, Loop):
                continue
            uses = list(getattr(op, "args", ()) or ())
            if isinstance(op, StoreOp) and op.value:
                uses.append(op.value)
            for a in uses:
                d = defs.get(a)
                if d is None:
                    continue  # lint's undef-ssa territory
                lat = p.op_latency(d)
                if theta[op.uid] < theta[d.uid] + lat:
                    self.diag(
                        "ssa-order", f"{p.name}/uid={op.uid}",
                        f"use of {a!r} at {theta[op.uid]} before def "
                        f"uid={d.uid} completes at {theta[d.uid]} + {lat}")
            if op.result is not None:
                defs[op.result] = op

    def check_fusion_markers(self) -> None:
        groups: dict[int, list[Loop]] = {}
        for item in self.p.body:
            if isinstance(item, Loop):
                if item.fuse_group is not None:
                    groups.setdefault(item.fuse_group, []).append(item)
                elif item.peel:
                    self.diag("orphan-peel",
                              f"{self.p.name}/loop {item.ivname}",
                              "top-level peel loop without a fuse group")
        for g, members in sorted(groups.items()):
            if all(m.peel for m in members):
                self.diag(
                    "fuse-no-core", f"{self.p.name}/fuse_group {g}",
                    f"group {g} has only peel loops "
                    f"({[m.ivname for m in members]}) — the core they "
                    "replicate is gone")

    # -- the polyhedral emptiness checks -------------------------------
    def _empty(self, X: _Acc, Y: _Acc, carry: Optional[int],
               eq_dims, index_pairs, *, delay: Optional[int]) \
            -> tuple[Optional[bool], Optional[list]]:
        """Is the case's violation region empty?  ``delay=None`` means the
        port equal-time check.  Returns (empty, witness): (True, None) —
        proved safe, (False, x) — concrete counterexample, (None, None) —
        truncated search, safety unproven."""
        iis, theta = self.s.iis, self.s.theta
        lo, hi = _sep_range(X, Y, carry, iis, theta)
        if delay is not None:
            if lo >= delay:
                return True, None
        elif lo > 0 or hi < 0:
            return True, None
        bounds, A_eq, b_eq, A_ub, b_ub = _case_system(
            X, Y, carry, eq_dims, index_pairs)
        trow = _time_row(X, Y, iis)
        dtheta = theta[X.uid] - theta[Y.uid]
        if delay is not None:
            A_ub.append(trow)
            b_ub.append(float(dtheta + delay - 1))
        else:
            A_eq.append(trow)
            b_eq.append(float(dtheta))
        n = len(bounds)
        self.v.ilp_calls += 1
        res = solve_ilp(np.zeros(n),
                        np.asarray(A_ub) if A_ub else None,
                        np.asarray(b_ub) if b_ub else None,
                        np.asarray(A_eq) if A_eq else None,
                        np.asarray(b_eq) if b_eq else None,
                        bounds=bounds)
        if res.status == "infeasible":
            return True, None
        if res.x is not None:
            return False, [int(round(v)) for v in res.x]
        self.v.unresolved += 1
        return None, None

    def _report(self, kind: str, X: _Acc, Y: _Acc, array: str,
                carry: Optional[int], empty: Optional[bool],
                witness, delay: Optional[int]) -> None:
        where = f"{self.p.name}/{array}[{X.uid}->{Y.uid}]"
        case = "loop-independent" if carry is None else f"carry={carry}"
        if empty is False:
            if delay is None:
                self.diag("port-conflict", where,
                          f"port {X.port} accesses uid={X.uid} and "
                          f"uid={Y.uid} collide in one cycle at "
                          f"ivs={witness} ({case})")
            else:
                self.diag("dep-violated", where,
                          f"{kind} separation < {delay} at ivs={witness} "
                          f"({case})")
        elif empty is None:
            self.v.ok = False
            self.v.diagnostics.append(Diagnostic(
                "unresolved", where, "error",
                f"{kind} emptiness check truncated ({case}) — cannot "
                "prove the schedule safe"))

    def check_dependences(self, by_array: dict[str, list[_Acc]]) -> None:
        wr_lat = {n: a.wr_latency for n, a in self.p.arrays.items()}
        for name in sorted(by_array):
            accs = by_array[name]
            for X in accs:
                for Y in accs:
                    if self.done:
                        return
                    if not (X.is_write or Y.is_write):
                        continue
                    if X.is_write and not Y.is_write:
                        kind, delay = "RAW", wr_lat[name]
                    elif not X.is_write and Y.is_write:
                        kind, delay = "WAR", 1
                    else:
                        kind, delay = "WAW", 1
                    index_pairs = list(zip(X.op.index, Y.op.index))
                    pfx = _prefix_len(X.anc, Y.anc)
                    cases: list[Optional[int]] = list(range(pfx))
                    if X.uid != Y.uid and self.pos[X.uid] < self.pos[Y.uid]:
                        cases.append(None)
                    if not cases:
                        continue
                    self.v.pairs += 1
                    for carry in cases:
                        if self.done:
                            return
                        self.v.cases += 1
                        empty, w = self._empty(X, Y, carry, None,
                                               index_pairs, delay=delay)
                        if empty is not True:
                            self._report(kind, X, Y, name, carry, empty, w,
                                         delay)

    def check_ports(self, by_array: dict[str, list[_Acc]]) -> None:
        for name in sorted(by_array):
            arr = self.p.arrays[name]
            if arr.kind == "reg":
                continue
            part = list(arr.partition)
            by_port: dict[int, list[_Acc]] = {}
            for a in by_array[name]:
                by_port.setdefault(a.port, []).append(a)
            for port in sorted(by_port):
                paccs = by_port[port]
                for i, X in enumerate(paccs):
                    for Y in paccs[i:]:
                        if self.done:
                            return
                        index_pairs = list(zip(X.op.index, Y.op.index))
                        if X.uid == Y.uid:
                            # distinct iterations of one op: split on the
                            # first differing level (x <lex y WLOG — a
                            # same-cycle collision is symmetric)
                            cases = list(range(len(X.anc)))
                        else:
                            cases = [None]
                        if not cases:
                            continue
                        self.v.pairs += 1
                        for carry in cases:
                            if self.done:
                                return
                            self.v.cases += 1
                            empty, w = self._empty(X, Y, carry, part,
                                                   index_pairs, delay=None)
                            if empty is not True:
                                self._report("PORT", X, Y, name, carry,
                                             empty, w, None)

    def run(self) -> Verdict:
        if not self.check_complete():
            return self.v
        self.check_fusion_markers()
        self.check_occupancy()
        if not self.done:
            self.check_ssa_struct()
        by_array = _collect(self.p)
        if not self.done:
            self.check_dependences(by_array)
        if not self.done:
            self.check_ports(by_array)
        self.v.diagnostics.sort(key=Diagnostic.sort_key)
        return self.v


def validate_static(program: Program, schedule, *,
                    fail_fast: bool = False) -> Verdict:
    """Independently re-derive and check every constraint the schedule must
    satisfy (DESIGN.md §12): loop occupancy, SSA/structural ordering,
    RAW/WAR/WAW separation per happens-before case (polyhedral emptiness
    checks on :func:`solve_ilp`), port/bank conflicts under
    ``array_partition``, and peel/fuse-group marker consistency.

    ``fail_fast=True`` stops at the first problem (used by mutation tests
    where any rejection suffices); the default scans everything so the
    verdict enumerates every violation."""
    return _Validator(program, schedule, fail_fast).run()


# ---------------------------------------------------------------------------
# Schedule corruption (the mutation-test harness)
# ---------------------------------------------------------------------------


def corrupt_schedule(schedule, rng) -> Optional[tuple[object, dict]]:
    """Produce a schedule that is invalid **by construction**, for mutation-
    testing the validator (a validator that accepts any of these is broken).

    Three mutation families, chosen by ``rng`` (a ``numpy`` Generator):

    * ``theta``: pick a RAW/WAR/WAW/SSA/STRUCT edge and move its sink to
      ``theta[src] + lower - 1 - extra``.  Edge lower bounds are *tight*
      (the minimizing instance pair attains the slack), so undershooting by
      one provably violates the underlying constraint — valid only for
      exact-provenance schedules (degraded edges are conservative).
    * ``ii``: lower one loop's II below its occupancy floor
      ``trip_inner * II_inner`` (guaranteed structurally invalid).
    * ``drop-edge``: remove one memory/SSA edge and recompute the earliest
      schedule from the rest; kept only when the new theta actually
      violates the dropped edge's difference constraint.

    Returns ``(mutant, info)`` or ``None`` when the chosen family has no
    applicable site (caller retries with the next seed)."""
    import dataclasses

    from .scheduler import longest_path

    s = schedule
    if s.provenance != "exact":
        raise ValueError("corrupt_schedule needs an exact-provenance "
                         "schedule (degraded edge bounds are not tight)")
    family = rng.choice(["theta", "ii", "drop-edge"])
    if family == "theta":
        edges = [e for e in s.edges
                 if e.kind in ("RAW", "WAR", "WAW", "SSA", "STRUCT")]
        if not edges:
            return None
        e = edges[rng.integers(len(edges))]
        theta = dict(s.theta)
        theta[e.snk] = theta[e.src] + e.lower - 1 - int(rng.integers(0, 3))
        info = {"family": "theta", "edge": (e.src, e.snk, e.kind, e.lower)}
        return dataclasses.replace(s, theta=theta), info
    if family == "ii":
        floors = {}
        for l in s.program.loops():
            for c in l.sub_loops():
                need = c.trip * s.iis[c.uid]
                floors[l.uid] = max(floors.get(l.uid, 1), need)
        sites = [u for u, f in floors.items() if s.iis[u] >= f > 1]
        if not sites:
            return None
        u = sites[rng.integers(len(sites))]
        iis = dict(s.iis)
        iis[u] = int(rng.integers(1, floors[u]))  # strictly below the floor
        return dataclasses.replace(s, iis=iis), {"family": "ii", "loop": u}
    # drop-edge
    mem = [i for i, e in enumerate(s.edges)
           if e.kind in ("RAW", "WAR", "WAW", "SSA")]
    rng.shuffle(mem)
    nodes = [n for n, _ in s.program.walk()]
    for i in mem:
        e = s.edges[i]
        rest = s.edges[:i] + s.edges[i + 1:]
        theta = longest_path(nodes, rest)
        if theta is None:
            continue
        if theta[e.snk] - theta[e.src] < e.lower:  # actually violates it
            info = {"family": "drop-edge",
                    "edge": (e.src, e.snk, e.kind, e.lower)}
            return dataclasses.replace(s, theta=theta, edges=rest), info
    return None


# ---------------------------------------------------------------------------
# Corpus registry + CLI
# ---------------------------------------------------------------------------


def corpus_programs() -> dict:
    """name -> zero-arg constructor for every corpus program the CLI/CI
    lints: the paper benchmarks, the fusion chains and both figures."""
    from . import programs as P

    reg = dict(P.BENCHMARKS)
    reg.update(P.CHAIN_BENCHMARKS)
    reg["fig1_conv_chain"] = P.fig1_conv_chain
    reg["fig3_conv1d"] = P.fig3_conv1d
    return reg


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.analysis",
        description="IR linter + static schedule validator over the corpus.")
    ap.add_argument("names", nargs="*",
                    help="corpus program names (default/--all: everything)")
    ap.add_argument("--all", action="store_true", dest="all_",
                    help="lint the whole corpus")
    ap.add_argument("--validate", action="store_true",
                    help="also compile each program (empty pipeline) and "
                         "run the static schedule validator on the result")
    ap.add_argument("--codes", action="store_true",
                    help="print the lint/validate code tables and exit")
    args = ap.parse_args(argv)

    if args.codes:
        for title, table in (("lint", LINT_CODES),
                             ("validate", VALIDATE_CODES)):
            print(f"# {title} codes")
            for code, meaning in table.items():
                print(f"  {code:<22} {meaning}")
        return 0

    reg = corpus_programs()
    names = args.names or sorted(reg)
    unknown = [n for n in names if n not in reg]
    if unknown:
        ap.error(f"unknown program(s) {unknown}; known: {sorted(reg)}")

    failures = 0
    for name in names:
        p = reg[name]()
        diags = lint(p)
        pinned = EXPECTED_LINT.get(name, set())
        new_errors = [d for d in diags
                      if d.severity == "error" and d.code not in pinned]
        status = "FAIL" if new_errors else "ok"
        print(f"{name}: {status} ({len(diags)} findings)")
        for d in diags:
            pin = " [pinned]" if d.code in pinned else ""
            print(f"  {d}{pin}")
        failures += bool(new_errors)
        if args.validate:
            from . import api as hls
            r = hls.compile(p, pipeline=())
            v = validate_static(r.program, r.best.schedule)
            print(f"  schedule: {v}")
            failures += not v.ok
    return 1 if failures else 0


if __name__ == "__main__":   # pragma: no cover - exercised via CLI tests
    sys.exit(main())
