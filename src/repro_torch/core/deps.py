"""Dependence analysis: the paper's *memory-dependence ILPs* (§4.1–4.2).

For every ordered pair of conflicting accesses (X source, Y sink) we minimize

    slack = min  ivpart(Y) - ivpart(X)
            s.t. loop bounds, address equality, happens-before

where ``ivpart`` is the II-weighted iteration-vector component of the
schedule time T(op, ivs) = theta_op + sum_l II_l * iv_l.  The scheduling
system then enforces   theta_snk >= theta_src + delay - slack   which makes
T_snk >= T_src + delay hold for *every* conflicting dynamic-instance pair.

Happens-before is handled by lexicographic case-splitting per common-loop
depth (exact, and keeps ILP coefficients small — the paper instead linearizes
sequential time with large strides; both are equivalent for constant bounds).

Port conflicts use the same machinery as pseudo-dependences with the address
equality restricted to completely-partitioned dims (bank equality), exactly
the paper's "assume all operations on the same port have a data dependence".

Fast path (DESIGN.md §4): the dependence ILPs produced by affine programs
with constant bounds are almost always *separable* after two rewrites —
merging the prefix-equal ivs of the happens-before case and switching the
common-suffix ivs to difference variables d_l = iv_snk,l - iv_src,l.  What
remains is a box-constrained integer program whose equality rows nearly
always touch one variable (pin it: divisibility + bounds check) or two
(a 2-var linear Diophantine equation: GCD feasibility, then minimize a
linear objective over an interval of the solution parameter).  These are
solved in closed form; only genuinely coupled systems (a residual component
with >=3 variables or >=3 equations) fall back to branch-and-bound
``solve_ilp``.  A crucial corollary: the *feasible region* of every case is
II-independent (IIs only weight the objective), so pair/case feasibility is
decided once at construction and never re-examined across autotuner probes.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional

import math

import numpy as np

from . import faults
from .ilp import solve_ilp
from .ir import ArrayDecl, LoadOp, Loop, Program, StoreOp, position_keys


@dataclass(frozen=True)
class Access:
    op: object  # LoadOp | StoreOp
    ancestors: tuple[Loop, ...]
    array: ArrayDecl
    is_write: bool
    port: int

    @property
    def uid(self):
        return self.op.uid


@dataclass(frozen=True)
class DepEdge:
    """Constraint theta_snk >= theta_src + lower  (lower = delay - slack)."""

    src: int  # op uid
    snk: int
    lower: int
    kind: str  # RAW | WAR | WAW | PORT | SSA | STRUCT
    array: str = ""


def collect_accesses(p: Program) -> list[Access]:
    """Gather memory accesses and assign ports (simple policy: round-robin
    over compatible ports per array, in program order — writes over write
    ports, reads over read ports).  ``reg`` arrays are fully partitioned
    registers and take no port."""
    rr: dict[tuple[str, str], int] = {}
    out = []
    for op, anc in p.walk():
        if not isinstance(op, (LoadOp, StoreOp)):
            continue
        arr = p.arrays[op.array]
        is_write = isinstance(op, StoreOp)
        if arr.kind == "reg":
            port = 0
        else:
            ports = arr.write_ports() if is_write else arr.read_ports()
            if not ports:
                raise ValueError(
                    f"array {arr.name} has no {'write' if is_write else 'read'} port")
            key = (arr.name, "w" if is_write else "r")
            k = rr.get(key, 0)
            port = ports[k % len(ports)]
            rr[key] = k + 1
        op.port = port
        out.append(Access(op=op, ancestors=tuple(anc), array=arr,
                          is_write=is_write, port=port))
    return out


def _common_prefix_len(a: tuple[Loop, ...], b: tuple[Loop, ...]) -> int:
    n = 0
    for x, y in zip(a, b):
        if x is y:
            n += 1
        else:
            break
    return n


# ---------------------------------------------------------------------------
# Closed-form affine slack solver (the fast path)
# ---------------------------------------------------------------------------

_FALLBACK = object()  # sentinel: case not separable, use the ILP


def _ext_gcd(a: int, b: int) -> tuple[int, int, int]:
    """(g, p, q) with a*p + b*q == g == gcd(a, b) (g >= 0)."""
    old_r, r = a, b
    old_p, p = 1, 0
    old_q, q = 0, 1
    while r:
        quo = old_r // r
        old_r, r = r, old_r - quo * r
        old_p, p = p, old_p - quo * p
        old_q, q = q, old_q - quo * q
    if old_r < 0:
        old_r, old_p, old_q = -old_r, -old_p, -old_q
    return old_r, old_p, old_q


def _ceil_div(a: int, b: int) -> int:
    return -((-a) // b)


def _param_interval(v0: int, s: int, lo: int, hi: int) -> tuple[int, int]:
    """t-range keeping v0 + s*t inside [lo, hi] (s != 0)."""
    if s > 0:
        return _ceil_div(lo - v0, s), (hi - v0) // s
    return _ceil_div(hi - v0, s), (lo - v0) // s


def _min_diophantine_2var(a: int, b: int, e: int,
                          lu: int, hu: int, lv: int, hv: int,
                          cu: int, cv: int):
    """min cu*u + cv*v  s.t.  a*u + b*v == e, u in [lu,hu], v in [lv,hv],
    all integer.  Returns the value or None (infeasible)."""
    g, p, q = _ext_gcd(a, b)
    if e % g:
        return None
    k = e // g
    u0, v0 = p * k, q * k
    su, sv = b // g, -(a // g)
    tlo1, thi1 = _param_interval(u0, su, lu, hu)
    tlo2, thi2 = _param_interval(v0, sv, lv, hv)
    tlo, thi = max(tlo1, tlo2), min(thi1, thi2)
    if tlo > thi:
        return None
    slope = cu * su + cv * sv
    t = tlo if slope >= 0 else thi
    return cu * (u0 + su * t) + cv * (v0 + sv * t)


def _solve_separable(vars: dict, rows: list):
    """min sum c_v * v over integer vars with box bounds and equality rows.

    ``vars``: vid -> (lo, hi, c).  ``rows``: list of (dict vid->coeff, rhs).
    Returns the optimum (int), None (infeasible), or _FALLBACK when a
    residual component is not closed-form solvable.
    """
    for lo, hi, _ in vars.values():
        if lo > hi:
            return None

    fixed: dict = {}
    rows = [(dict(coeffs), rhs) for coeffs, rhs in rows]
    while True:
        nrows = []
        for coeffs, rhs in rows:
            nc = {}
            for v, a in coeffs.items():
                if v in fixed:
                    rhs -= a * fixed[v]
                else:
                    nc[v] = a
            if not nc:
                if rhs != 0:
                    return None
                continue
            nrows.append((nc, rhs))
        rows = nrows
        newly = False
        for coeffs, rhs in rows:
            if len(coeffs) == 1:
                (v, a), = coeffs.items()
                if v in fixed:
                    if a * fixed[v] != rhs:
                        return None
                    continue
                if rhs % a:
                    return None
                val = rhs // a
                lo, hi, _ = vars[v]
                if not (lo <= val <= hi):
                    return None
                fixed[v] = val
                newly = True
        if not newly:
            break

    total = sum(vars[v][2] * val for v, val in fixed.items())

    # connected components over the residual rows (each row now has >= 2
    # vars, singletons were eliminated).  A row bridging two existing
    # components implies >= 4 coupled variables — beyond the closed form —
    # so bail out immediately instead of merging.
    comp: dict = {}
    comp_rows: dict[int, list] = {}
    next_root = 0
    for coeffs, rhs in rows:
        roots = {comp[v] for v in coeffs if v in comp}
        if len(roots) > 1:
            return _FALLBACK
        if roots:
            root = roots.pop()
        else:
            root = next_root
            next_root += 1
        for v in coeffs:
            comp[v] = root
        comp_rows.setdefault(root, []).append((coeffs, rhs))

    for crows in comp_rows.values():
        cvars = sorted({v for coeffs, _ in crows for v in coeffs})
        if len(cvars) != 2:
            return _FALLBACK
        u, v = cvars
        if len(crows) == 2:
            (c1, e1), (c2, e2) = crows
            a1, b1 = c1.get(u, 0), c1.get(v, 0)
            a2, b2 = c2.get(u, 0), c2.get(v, 0)
            det = a1 * b2 - a2 * b1
            if det != 0:
                un, vn = e1 * b2 - e2 * b1, a1 * e2 - a2 * e1
                if un % det or vn % det:
                    return None
                uu, vv = un // det, vn // det
                if not (vars[u][0] <= uu <= vars[u][1] and
                        vars[v][0] <= vv <= vars[v][1]):
                    return None
                total += vars[u][2] * uu + vars[v][2] * vv
                continue
            # proportional LHS: consistent -> one row; else infeasible
            if a1 * e2 != a2 * e1 or b1 * e2 != b2 * e1:
                return None
            crows = [(c1, e1)]
        if len(crows) != 1:
            return _FALLBACK
        coeffs, rhs = crows[0]
        val = _min_diophantine_2var(coeffs[u], coeffs[v], rhs,
                                    vars[u][0], vars[u][1],
                                    vars[v][0], vars[v][1],
                                    vars[u][2], vars[v][2])
        if val is None:
            return None
        total += val

    for v, (lo, hi, c) in vars.items():
        if v in fixed or v in comp:
            continue
        total += c * lo if c >= 0 else c * hi
    return total


def _fast_slack_case(la: tuple[Loop, ...], lb: tuple[Loop, ...], pfx: int,
                     carry_level: Optional[int], rows: list,
                     iis: dict[int, int]):
    """Closed-form solve of one happens-before case.

    ``rows`` are the address-equality rows over columns x_0..x_{nx-1},
    y_0..y_{ny-1} (source / sink iteration vectors).  Returns the minimum
    slack (int), None (case infeasible), or _FALLBACK.
    """
    nx, ny = len(la), len(lb)
    P = carry_level if carry_level is not None else pfx

    nrows = []
    for coeffs, rhs in rows:
        nc = {}
        for k in range(P):  # prefix-equal: x_k == y_k merged into one var
            a = coeffs.get(k, 0) + coeffs.get(nx + k, 0)
            if a:
                nc[("m", k)] = a
        for k in range(P, pfx):  # common suffix: d_k = y_k - x_k
            cx, cy = coeffs.get(k, 0), coeffs.get(nx + k, 0)
            if cx != -cy:
                return _FALLBACK  # not diagonal-coupled; keep the ILP exact
            if cy:
                nc[("d", k)] = cy
        for i in range(pfx, nx):
            a = coeffs.get(i, 0)
            if a:
                nc[("x", i)] = a
        for j in range(pfx, ny):
            a = coeffs.get(nx + j, 0)
            if a:
                nc[("y", j)] = a
        nrows.append((nc, rhs))

    # variable table: vid -> (lo, hi, objective coefficient).
    # Prefix-merged vars contribute 0 to the objective (same loop, same II);
    # difference vars contribute +II_l; split vars keep their signed II.
    vars: dict = {}
    for k in range(P):
        l = la[k]
        vars[("m", k)] = (l.lb, l.ub - 1, 0)
    for k in range(P, pfx):
        l = la[k]
        span = l.ub - 1 - l.lb
        lo = 1 if carry_level is not None and k == carry_level else -span
        vars[("d", k)] = (lo, span, iis[l.uid])
    for i in range(pfx, nx):
        l = la[i]
        vars[("x", i)] = (l.lb, l.ub - 1, -iis[l.uid])
    for j in range(pfx, ny):
        l = lb[j]
        vars[("y", j)] = (l.lb, l.ub - 1, iis[l.uid])

    return _solve_separable(vars, nrows)


# ---------------------------------------------------------------------------


@dataclass
class _Pair:
    """One conflicting-access candidate, fully analyzed at construction."""

    X: Access
    Y: Access
    kind: str       # RAW | WAR | WAW | PORT
    delay: int
    array: str
    rows: list      # address-equality rows (dict col->coeff, rhs)
    cases: list     # feasible happens-before cases: carry levels and/or None
    loop_uids: tuple[int, ...]  # IIs the slack actually depends on


# ---------------------------------------------------------------------------
# Cross-candidate sharing of the data-dependence half of pair enumeration.
#
# DSE candidates that differ only in array METADATA (partition moves, port
# rewrites) have identical iteration spaces and access functions, so their
# RAW/WAR/WAW pair rows and happens-before case feasibility are identical —
# only the PORT pseudo-dependences (whose address rows are restricted to the
# partitioned dims) change.  ``clone_program`` preserves op/loop uids, so
# the shared results are keyed on an iteration-space fingerprint and looked
# up per (src uid, snk uid, kind).
# ---------------------------------------------------------------------------

DATA_PAIR_ENUM_RUNS = 0   # full (uncached) data-pair enumerations (test probe)
DATA_PAIR_CACHE_HITS = 0  # enumerations served from the shared cache
_DATA_PAIR_CACHE: "OrderedDict[str, dict]" = OrderedDict()
_DATA_PAIR_CACHE_MAX = 64


def cache_stats() -> dict:
    """Hit/miss counters and current size of the module-level data-pair
    cache (bounded at ``_DATA_PAIR_CACHE_MAX`` entries with LRU eviction, so
    long-running serving processes don't grow without limit)."""
    return {"hits": DATA_PAIR_CACHE_HITS, "misses": DATA_PAIR_ENUM_RUNS,
            "entries": len(_DATA_PAIR_CACHE),
            "max_entries": _DATA_PAIR_CACHE_MAX}


def iteration_space_key(p: Program) -> str:
    """Fingerprint of everything the data-dependence pairs depend on: loop
    structure/bounds, access functions, program order (walk order), op uids
    (the cache's lookup keys) and access latencies — NOT array partition,
    ports or storage kind (pure metadata for RAW/WAR/WAW)."""
    parts = []
    for node, _ in p.walk():
        if isinstance(node, Loop):
            parts.append(f"L{node.uid}:{node.ivname}:{node.lb}:{node.ub}")
        elif isinstance(node, (LoadOp, StoreOp)):
            arr = p.arrays[node.array]
            tag = "S" if isinstance(node, StoreOp) else "R"
            parts.append(f"{tag}{node.uid}:{node.array}:{node.index!r}:"
                         f"{arr.wr_latency}:{arr.rd_latency}")
    return "|".join(parts)


class DepAnalysis:
    """Memory-dependence analysis, incremental across autotuner II probes.

    Construction enumerates every conflicting-access pair ONCE, builds its
    address-equality rows, and case-splits happens-before — discarding the
    cases (and whole pairs) whose feasible region is empty, which is an
    II-independent property.  ``memory_edges(iis)`` then only re-evaluates
    the objective of the surviving cases, cached per pair on the IIs of the
    loops actually appearing in that pair's iteration vectors, so a binary
    search probing one loop's II recomputes only the edges touching it.
    """

    def __init__(self, p: Program, fastpath: bool = True,
                 crosscheck: bool = False):
        self.p = p
        self.accesses = collect_accesses(p)
        self.pos = position_keys(p)
        self.fastpath = fastpath
        self.crosscheck = crosscheck
        self.fallback_cases = 0   # cases the closed form could not take
        self.fast_cases = 0
        # truncated-solver degradations: each entry records one dependence
        # case whose slack was replaced by a conservative lower bound.  A
        # non-empty list taints every schedule built from this analysis
        # (Schedule.provenance == "degraded").
        self.degradations: list[dict] = []
        self._degraded_keys: set = set()
        self._edge_cache: dict = {}
        self._static_edges: Optional[list[DepEdge]] = None
        self._nodes: Optional[list] = None
        self._pairs: list[_Pair] = self._enumerate_pairs()

    def all_nodes(self) -> list:
        """Every op/loop node, cached (reused across autotuner probes)."""
        if self._nodes is None:
            self._nodes = [n for n, _ in self.p.walk()]
        return self._nodes

    # ------------------------------------------------------------------
    # pair enumeration (once)
    # ------------------------------------------------------------------
    def _address_rows(self, X: Access, Y: Access,
                      eq_dims: Optional[list[int]]) -> list:
        """Equality rows over columns [x_0..x_{nx-1}, y_0..y_{ny-1}]."""
        la, lb = X.ancestors, Y.ancestors
        nx = len(la)
        src_col = {l.ivname: i for i, l in enumerate(la)}
        snk_col = {l.ivname: nx + i for i, l in enumerate(lb)}
        rows = []
        assert X.op.array == Y.op.array  # pairs come from one array's bucket
        dims = range(len(X.array.shape)) if eq_dims is None else eq_dims
        for d in dims:
            ex, ey = X.op.index[d], Y.op.index[d]
            coeffs: dict[int, int] = {}
            for nm, c in ex.coeffs.items():
                col = src_col[nm]
                coeffs[col] = coeffs.get(col, 0) + c
            for nm, c in ey.coeffs.items():
                col = snk_col[nm]
                coeffs[col] = coeffs.get(col, 0) - c
            rows.append(({k: v for k, v in coeffs.items() if v}, ey.const - ex.const))
        return rows

    def _feasible_cases(self, X: Access, Y: Access, rows: list) -> list:
        """Happens-before cases with a non-empty feasible region (an
        II-independent property: IIs only weight the objective)."""
        ones = {l.uid: 1 for l in X.ancestors + Y.ancestors}
        pfx = _common_prefix_len(X.ancestors, Y.ancestors)
        cases = []
        for lvl in range(pfx):
            if self._case_slack(X, Y, lvl, rows, ones) is not None:
                cases.append(lvl)
        px, py = self.pos[X.uid], self.pos[Y.uid]
        if X.uid != Y.uid and px < py:
            if self._case_slack(X, Y, None, rows, ones) is not None:
                cases.append(None)
        return cases

    def _enumerate_pairs(self) -> list[_Pair]:
        global DATA_PAIR_ENUM_RUNS, DATA_PAIR_CACHE_HITS
        pairs = []
        by_array: dict[str, list[Access]] = {}
        for a in self.accesses:
            by_array.setdefault(a.op.array, []).append(a)

        # data-dependence rows/cases are metadata-independent: share them
        # across candidates with the same iteration-space fingerprint
        key = iteration_space_key(self.p)
        shared = _DATA_PAIR_CACHE.get(key)
        if shared is None:
            DATA_PAIR_ENUM_RUNS += 1
            shared = {}
            _DATA_PAIR_CACHE[key] = shared
            while len(_DATA_PAIR_CACHE) > _DATA_PAIR_CACHE_MAX:
                _DATA_PAIR_CACHE.popitem(last=False)
        else:
            DATA_PAIR_CACHE_HITS += 1
            _DATA_PAIR_CACHE.move_to_end(key)

        for name, accs in by_array.items():
            arr = self.p.arrays[name]
            # ---- real data dependences -------------------------------
            for X in accs:
                for Y in accs:
                    if not (X.is_write or Y.is_write):
                        continue
                    if X.is_write and not Y.is_write:
                        kind, delay = "RAW", arr.wr_latency
                    elif not X.is_write and Y.is_write:
                        kind, delay = "WAR", 1
                    else:
                        kind, delay = "WAW", 1
                    ckey = (X.uid, Y.uid, kind)
                    entry = shared.get(ckey)
                    if entry is None:
                        deg0 = len(self.degradations)
                        rows = self._address_rows(X, Y, None)
                        entry = (rows, self._feasible_cases(X, Y, rows))
                        if len(self.degradations) == deg0:
                            # only clean computations enter the shared
                            # cross-candidate cache; a degraded case list
                            # must not poison fault-free analyses
                            shared[ckey] = entry
                    rows, cases = entry
                    if cases:
                        self._append_pair(pairs, X, Y, kind, delay, name,
                                          rows, cases)
            # ---- port pseudo-dependences (metadata-dependent: fresh) ---
            if arr.kind == "reg":
                continue
            by_port: dict[int, list[Access]] = {}
            for a in accs:
                by_port.setdefault(a.port, []).append(a)
            part = list(arr.partition)
            for port, paccs in by_port.items():
                for X in paccs:
                    for Y in paccs:
                        rows = self._address_rows(X, Y, part)
                        cases = self._feasible_cases(X, Y, rows)
                        if cases:
                            self._append_pair(pairs, X, Y, "PORT", 1, name,
                                              rows, cases)
        return pairs

    def _append_pair(self, pairs, X, Y, kind, delay, name, rows, cases):
        uids = tuple(dict.fromkeys(
            [l.uid for l in X.ancestors] + [l.uid for l in Y.ancestors]))
        pairs.append(_Pair(X=X, Y=Y, kind=kind, delay=delay, array=name,
                           rows=rows, cases=cases, loop_uids=uids))

    # ------------------------------------------------------------------
    # per-case slack
    # ------------------------------------------------------------------
    def _case_slack(self, X: Access, Y: Access, carry_level: Optional[int],
                    rows: list, iis: dict[int, int]) -> Optional[int]:
        """Solve one memory-dependence case; None if infeasible (no dep)."""
        la, lb = X.ancestors, Y.ancestors
        pfx = _common_prefix_len(la, lb)
        if self.fastpath:
            val = _fast_slack_case(la, lb, pfx, carry_level, rows, iis)
            if val is not _FALLBACK:
                self.fast_cases += 1
                if self.crosscheck:
                    deg0 = len(self.degradations)
                    ref = self._ilp_case_slack(X, Y, carry_level, rows, iis)
                    if len(self.degradations) > deg0:
                        # the ILP reference itself was truncated: its value
                        # is a bound, not a ground truth to compare against
                        return val
                    if val != ref:
                        raise AssertionError(
                            f"fast-path slack mismatch: {val} != ILP {ref} "
                            f"({X.op} -> {Y.op}, carry={carry_level})")
                return val
            self.fallback_cases += 1
        return self._ilp_case_slack(X, Y, carry_level, rows, iis)

    def _ilp_case_slack(self, X: Access, Y: Access,
                        carry_level: Optional[int], rows: list,
                        iis: dict[int, int]) -> Optional[int]:
        """Reference path: branch-and-bound ILP on the full case system."""
        la, lb = X.ancestors, Y.ancestors
        nx, ny = len(la), len(lb)
        n = nx + ny
        bounds = [(l.lb, l.ub - 1) for l in la] + [(l.lb, l.ub - 1) for l in lb]
        A_eq, b_eq, A_ub, b_ub = [], [], [], []
        for coeffs, rhs in rows:
            row = np.zeros(n)
            for col, c in coeffs.items():
                row[col] = c
            A_eq.append(row)
            b_eq.append(float(rhs))

        pfx = _common_prefix_len(la, lb)
        if carry_level is not None:
            assert carry_level < pfx
            for k in range(carry_level):
                row = np.zeros(n)
                row[k] = 1.0
                row[nx + k] = -1.0
                A_eq.append(row)
                b_eq.append(0.0)
            row = np.zeros(n)
            row[carry_level] = 1.0
            row[nx + carry_level] = -1.0
            A_ub.append(row)
            b_ub.append(-1.0)  # iv_src <= iv_snk - 1
        else:
            # loop-independent: all common ivs equal (caller checked order)
            for k in range(pfx):
                row = np.zeros(n)
                row[k] = 1.0
                row[nx + k] = -1.0
                A_eq.append(row)
                b_eq.append(0.0)

        # objective: min ivpart(Y) - ivpart(X)
        c = np.zeros(n)
        for i, l in enumerate(la):
            c[i] -= iis[l.uid]
        for i, l in enumerate(lb):
            c[nx + i] += iis[l.uid]

        res = solve_ilp(c, np.asarray(A_ub) if A_ub else None,
                        np.asarray(b_ub) if b_ub else None,
                        np.asarray(A_eq) if A_eq else None,
                        np.asarray(b_eq) if b_eq else None,
                        bounds=bounds)
        if res.ok:
            return int(round(res.fun))
        if res.status == "infeasible":
            return None
        if not res.truncated:
            raise RuntimeError(
                f"dependence-case ILP unresolved ({res.status}) for "
                f"{X.op!r} -> {Y.op!r}")
        # Truncated search (deadline / node cap / injected timeout).  Reading
        # it as "no dependence" would unsoundly prune a real edge — case
        # feasibility is decided once at construction — so degrade to a
        # conservative slack instead: any lower bound on the true minimum
        # under-estimates the slack, which *over*-serializes the schedule
        # (edge lower = delay - slack grows).  Sound, possibly suboptimal.
        lb = res.bound
        if lb is None:
            # no root LP bound either: fall back to the box lower bound of
            # the objective over the variable bounds
            lb = sum(cj * (bounds[j][0] if cj > 0 else bounds[j][1])
                     for j, cj in enumerate(c) if cj)
        slack = int(math.floor(lb + 1e-6))
        dkey = (X.uid, Y.uid, carry_level)
        if dkey not in self._degraded_keys:
            self._degraded_keys.add(dkey)
            info = {"src": X.uid, "snk": Y.uid, "carry": carry_level,
                    "status": res.status, "slack_bound": slack,
                    "incumbent": None if res.fun is None else int(round(res.fun)),
                    "gap": res.gap}
            self.degradations.append(info)
            faults.note("solver-degraded", **info)
        return slack

    def _pair_slack(self, pair: _Pair, iis: dict[int, int]) -> Optional[int]:
        """min slack over the pair's feasible happens-before cases."""
        slacks = [self._case_slack(pair.X, pair.Y, lvl, pair.rows, iis)
                  for lvl in pair.cases]
        slacks = [s for s in slacks if s is not None]
        return min(slacks) if slacks else None

    # ------------------------------------------------------------------
    # edges
    # ------------------------------------------------------------------
    def memory_edges(self, iis: dict[int, int]) -> list[DepEdge]:
        edges = []
        cache = self._edge_cache
        for idx, pair in enumerate(self._pairs):
            key = (idx,) + tuple(iis[u] for u in pair.loop_uids)
            edge = cache.get(key, _FALLBACK)
            if edge is _FALLBACK:
                s = self._pair_slack(pair, iis)
                edge = None if s is None else DepEdge(
                    src=pair.X.uid, snk=pair.Y.uid, lower=pair.delay - s,
                    kind=pair.kind, array=pair.array)
                cache[key] = edge
            if edge is not None:
                edges.append(edge)
        return edges

    # ------------------------------------------------------------------
    def ssa_edges(self) -> list[DepEdge]:
        defs: dict[str, object] = {}
        edges = []
        for op, _ in self.p.walk():
            if isinstance(op, Loop):
                continue
            for a in getattr(op, "args", ()) or ():
                if a in defs:
                    d = defs[a]
                    edges.append(DepEdge(src=d.uid, snk=op.uid,
                                         lower=self.p.op_latency(d), kind="SSA"))
            if isinstance(op, StoreOp) and op.value in defs:
                d = defs[op.value]
                edges.append(DepEdge(src=d.uid, snk=op.uid,
                                     lower=self.p.op_latency(d), kind="SSA"))
            if op.result is not None:
                defs[op.result] = op
        return edges

    def struct_edges(self) -> list[DepEdge]:
        edges = []
        for node, anc in self.p.walk():
            if anc:
                edges.append(DepEdge(src=anc[-1].uid, snk=node.uid, lower=0,
                                     kind="STRUCT"))
        return edges

    def static_edges(self) -> list[DepEdge]:
        """SSA + structural edges: II-independent, computed once."""
        if self._static_edges is None:
            self._static_edges = self.ssa_edges() + self.struct_edges()
        return self._static_edges
