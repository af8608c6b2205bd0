"""Self-contained LP / ILP solvers used by the HLS scheduler.

This container ships no scipy/pulp/ortools, so the paper's two ILP classes
(memory-dependence ILPs and the scheduling ILP) are solved with our own
numpy dense-tableau two-phase simplex (Bland's rule, cycle-safe) wrapped in
a depth-first branch-and-bound for integrality.  Problems are small (tens of
variables); the scheduling system itself is solved as a difference-constraint
graph (see scheduler.py) and only falls back to this LP for the
delay-register-minimization objective.
"""
from __future__ import annotations

import hashlib
import math
import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from . import faults

TOL = 1e-7

#: process-wide default wall-clock budget for a single ``solve_ilp`` call,
#: in seconds.  ``None`` (the default) preserves the historical behaviour of
#: running until ``max_nodes``; callers with latency contracts pass
#: ``deadline_s`` explicitly.
DEFAULT_DEADLINE_S: Optional[float] = None


@dataclass
class LPResult:
    status: str  # "optimal" | "infeasible" | "unbounded" | "iteration_limit"
    x: Optional[np.ndarray]
    fun: Optional[float]

    @property
    def ok(self) -> bool:
        return self.status == "optimal"


def _pivot(T: np.ndarray, basis: list[int], row: int, col: int) -> None:
    T[row] = T[row] / T[row, col]
    factor = T[:, col].copy()
    factor[row] = 0.0
    T -= np.outer(factor, T[row])
    # outer-product update can leave tiny residue in the pivot column
    T[:, col] = 0.0
    T[row, col] = 1.0
    basis[row] = col


def _simplex_core(T: np.ndarray, basis: list[int], c_full: np.ndarray,
                  maxiter: int) -> str:
    """Primal simplex on tableau T (m x (n+1), RHS in last column).

    ``basis`` holds the basic column of each row and is updated in place.
    Bland's rule (lowest-index entering / leaving) guarantees termination.
    """
    m, ncols = T.shape
    n = ncols - 1
    for _ in range(maxiter):
        cB = c_full[basis]
        reduced = c_full[:n] - cB @ T[:, :n]
        candidates = np.where(reduced < -TOL)[0]
        if candidates.size == 0:
            return "optimal"
        enter = int(candidates[0])  # Bland: lowest index
        col = T[:, enter]
        pos = np.where(col > TOL)[0]
        if pos.size == 0:
            return "unbounded"
        ratios = T[pos, n] / col[pos]
        best = ratios.min()
        ties = pos[np.where(ratios <= best + 1e-12)[0]]
        # Bland: leave the basic variable with the lowest index
        leave_row = int(ties[np.argmin(np.asarray(basis)[ties])])
        _pivot(T, basis, leave_row, enter)
    return "iteration_limit"


def solve_lp(c: Sequence[float],
             A_ub: Optional[np.ndarray] = None,
             b_ub: Optional[np.ndarray] = None,
             A_eq: Optional[np.ndarray] = None,
             b_eq: Optional[np.ndarray] = None,
             maxiter: int = 50000) -> LPResult:
    """minimize c@x  s.t.  A_ub@x <= b_ub,  A_eq@x == b_eq,  x >= 0."""
    c = np.asarray(c, dtype=np.float64)
    n = c.shape[0]
    rows = []
    rhs = []
    kinds = []  # "ub" | "eq"
    if A_ub is not None and len(A_ub):
        A_ub = np.asarray(A_ub, dtype=np.float64).reshape(-1, n)
        b_ub = np.asarray(b_ub, dtype=np.float64).ravel()
        for i in range(A_ub.shape[0]):
            rows.append(A_ub[i])
            rhs.append(b_ub[i])
            kinds.append("ub")
    if A_eq is not None and len(A_eq):
        A_eq = np.asarray(A_eq, dtype=np.float64).reshape(-1, n)
        b_eq = np.asarray(b_eq, dtype=np.float64).ravel()
        for i in range(A_eq.shape[0]):
            rows.append(A_eq[i])
            rhs.append(b_eq[i])
            kinds.append("eq")
    m = len(rows)
    if m == 0:
        # unconstrained besides x >= 0
        if np.any(c < -TOL):
            return LPResult("unbounded", None, None)
        return LPResult("optimal", np.zeros(n), 0.0)

    A = np.asarray(rows, dtype=np.float64)
    b = np.asarray(rhs, dtype=np.float64)

    # normalize to b >= 0
    n_slack = sum(1 for k in kinds if k == "ub")
    # columns: x (n) | slacks (n_slack) | artificials (<= m) | rhs
    slack_cols = {}
    j = n
    for i, k in enumerate(kinds):
        if k == "ub":
            slack_cols[i] = j
            j += 1
    flipped = b < -TOL
    total_pre_art = n + n_slack
    T = np.zeros((m, total_pre_art + m + 1), dtype=np.float64)
    basis: list[int] = [-1] * m
    art_cols: list[int] = []
    next_art = total_pre_art
    for i in range(m):
        row = A[i].copy()
        bi = b[i]
        sgn = 1.0
        if flipped[i]:
            row = -row
            bi = -bi
            sgn = -1.0
        T[i, :n] = row
        T[i, -1] = bi
        if kinds[i] == "ub":
            T[i, slack_cols[i]] = sgn  # flipped <= becomes >=, slack sign flips
        # does this row have a usable identity column (its slack with +1)?
        if kinds[i] == "ub" and sgn > 0:
            basis[i] = slack_cols[i]
        else:
            T[i, next_art] = 1.0
            basis[i] = next_art
            art_cols.append(next_art)
            next_art += 1
    used_cols = next_art
    T = T[:, list(range(used_cols)) + [T.shape[1] - 1]]
    ncols = T.shape[1] - 1

    if art_cols:
        c1 = np.zeros(ncols)
        for ac in art_cols:
            c1[ac] = 1.0
        status = _simplex_core(T, basis, c1, maxiter)
        if status != "optimal":
            return LPResult(status, None, None)
        obj1 = float(c1[basis] @ T[:, -1])
        if obj1 > 1e-6:
            return LPResult("infeasible", None, None)
        # drive remaining artificials out of the basis
        for i in range(m):
            if basis[i] in art_cols:
                # pivot on any non-artificial column with nonzero entry
                done = False
                for jcol in range(ncols):
                    if jcol in art_cols:
                        continue
                    if abs(T[i, jcol]) > 1e-9:
                        _pivot(T, basis, i, jcol)
                        done = True
                        break
                if not done:
                    # redundant row; harmless — leave artificial at zero
                    pass
        # forbid artificials from re-entering by giving them +inf-ish cost 0 and
        # zeroing their columns
        for ac in art_cols:
            T[:, ac] = 0.0

    c2 = np.zeros(ncols)
    c2[:n] = c
    status = _simplex_core(T, basis, c2, maxiter)
    if status != "optimal":
        return LPResult(status, None, None)
    x = np.zeros(ncols)
    for i in range(m):
        x[basis[i]] = T[i, -1]
    xs = x[:n]
    return LPResult("optimal", xs, float(c @ xs))


@dataclass
class ILPResult:
    """Outcome of a branch-and-bound search.

    Status lattice (DESIGN.md §9):

    - ``"optimal"``    — tree exhausted, or the incumbent meets the root LP
      bound; ``x``/``fun`` are the proven optimum.
    - ``"feasible"``   — search truncated (deadline or node cap) with an
      incumbent in hand; ``fun`` is an upper bound on the optimum, ``bound``
      a lower bound, ``gap = fun - bound`` the optimality gap.
    - ``"timeout"``    — search truncated before any incumbent was found;
      ``bound`` still carries the root LP lower bound when available.
      NOT a verdict about feasibility.
    - ``"infeasible"`` — the fully-explored tree proves no integer point
      satisfies the constraints.
    - ``"unbounded"``  — the relaxation is unbounded below.
    """
    status: str
    x: Optional[np.ndarray]
    fun: Optional[float]
    bound: Optional[float] = None  # best proven lower bound on the optimum
    gap: Optional[float] = None    # fun - bound when both are known
    nodes: int = 0                 # branch-and-bound nodes expanded

    @property
    def ok(self) -> bool:
        return self.status == "optimal"

    @property
    def truncated(self) -> bool:
        """True when the search was cut off before reaching a verdict."""
        return self.status in ("feasible", "timeout")


def _presolve(n: int,
              A_ub: Optional[np.ndarray], b_ub: Optional[np.ndarray],
              A_eq: Optional[np.ndarray], b_eq: Optional[np.ndarray],
              bounds: Sequence[tuple]) -> Optional[tuple]:
    """ILP presolve: singleton-row elimination + interval bound tightening.

    Exploits integrality (floor/ceil on derived bounds).  Returns None when
    infeasibility is proven, else (A_ub, b_ub, A_eq, b_eq, bounds) with rows
    dropped/simplified and bounds tightened.  Fixed variables (lo == hi) are
    substituted out of the rows but kept as columns so indices are stable.
    """
    los = [float(b[0]) for b in bounds]
    his = [math.inf if b[1] is None else float(b[1]) for b in bounds]
    eq = ([] if A_eq is None or not len(A_eq) else
          [(np.array(A_eq[i], dtype=np.float64), float(b_eq[i]))
           for i in range(len(A_eq))])
    ub = ([] if A_ub is None or not len(A_ub) else
          [(np.array(A_ub[i], dtype=np.float64), float(b_ub[i]))
           for i in range(len(A_ub))])

    for _ in range(12):  # tightening passes (fixpoint or cap)
        changed = False
        for rows, is_eq in ((eq, True), (ub, False)):
            kept = []
            for row, rhs in rows:
                nz = np.flatnonzero(np.abs(row) > TOL)
                # substitute fixed variables into the rhs
                fixed = [j for j in nz if his[j] - los[j] < TOL]
                if fixed:
                    for j in fixed:
                        rhs -= row[j] * los[j]
                        row[j] = 0.0
                    nz = np.flatnonzero(np.abs(row) > TOL)
                    changed = True
                if nz.size == 0:
                    if (abs(rhs) > 1e-6) if is_eq else (rhs < -1e-6):
                        return None
                    continue  # trivially satisfied row
                if nz.size == 1:
                    j = int(nz[0])
                    a = row[j]
                    if is_eq:
                        v = rhs / a
                        if abs(v - round(v)) > 1e-6:
                            return None
                        v = round(v)
                        if v < los[j] - TOL or v > his[j] + TOL:
                            return None
                        los[j] = his[j] = v
                    elif a > 0:
                        his[j] = min(his[j], math.floor(rhs / a + 1e-9))
                    else:
                        los[j] = max(los[j], math.ceil(rhs / a - 1e-9))
                    changed = True
                    continue  # row absorbed into the bounds
                # interval-arithmetic tightening of each variable in the row
                act_lo = act_hi = 0.0
                for j in nz:
                    a = row[j]
                    if a > 0:
                        act_lo += a * los[j]
                        act_hi += a * his[j]
                    else:
                        act_lo += a * his[j]
                        act_hi += a * los[j]
                if act_lo > rhs + 1e-6 or (is_eq and act_hi < rhs - 1e-6):
                    return None
                for j in nz:
                    a = row[j]
                    # residual activity of the other terms
                    o_lo = act_lo - (a * los[j] if a > 0 else a * his[j])
                    o_hi = act_hi - (a * his[j] if a > 0 else a * los[j])
                    if not math.isfinite(o_lo):
                        continue
                    if a > 0:
                        new_hi = math.floor((rhs - o_lo) / a + 1e-9)
                        if new_hi < his[j]:
                            his[j] = new_hi
                            changed = True
                        if is_eq and math.isfinite(o_hi):
                            new_lo = math.ceil((rhs - o_hi) / a - 1e-9)
                            if new_lo > los[j]:
                                los[j] = new_lo
                                changed = True
                    else:
                        new_lo = math.ceil((rhs - o_lo) / a - 1e-9)
                        if new_lo > los[j]:
                            los[j] = new_lo
                            changed = True
                        if is_eq and math.isfinite(o_hi):
                            new_hi = math.floor((rhs - o_hi) / a + 1e-9)
                            if new_hi < his[j]:
                                his[j] = new_hi
                                changed = True
                kept.append((row, rhs))
            rows[:] = kept
        if any(los[j] > his[j] + TOL for j in range(n)):
            return None
        if not changed:
            break

    A_eq2 = np.asarray([r for r, _ in eq]) if eq else None
    b_eq2 = np.asarray([b for _, b in eq]) if eq else None
    A_ub2 = np.asarray([r for r, _ in ub]) if ub else None
    b_ub2 = np.asarray([b for _, b in ub]) if ub else None
    bounds2 = [(int(los[j]), None if math.isinf(his[j]) else int(his[j]))
               for j in range(n)]
    return A_ub2, b_ub2, A_eq2, b_eq2, bounds2


def _problem_key(c, A_ub, b_ub, A_eq, b_eq, bounds) -> str:
    """Content digest of a solve_ilp call, for deterministic fault firing."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(c, dtype=np.float64).tobytes())
    for arr in (A_ub, b_ub, A_eq, b_eq):
        h.update(b"|")
        if arr is not None:
            h.update(np.ascontiguousarray(
                np.asarray(arr, dtype=np.float64)).tobytes())
    h.update(repr(list(bounds)).encode())
    return h.hexdigest()[:16]


def solve_ilp(c: Sequence[float],
              A_ub: Optional[np.ndarray] = None,
              b_ub: Optional[np.ndarray] = None,
              A_eq: Optional[np.ndarray] = None,
              b_eq: Optional[np.ndarray] = None,
              bounds: Optional[Sequence[tuple[int, int]]] = None,
              max_nodes: int = 4000,
              deadline_s: Optional[float] = None) -> ILPResult:
    """Minimize c@x over integer x with optional per-variable (lo, hi) bounds.

    Presolve (singleton rows, bound tightening) then branch-and-bound over
    the LP relaxation, exiting early when the root LP is already integral or
    an incumbent matches the root bound.  Variables default to x >= 0; pass
    ``bounds`` to shift/cap them (bounds may be negative; we shift internally).

    ``deadline_s`` is a wall-clock budget (falls back to the module-level
    ``DEFAULT_DEADLINE_S``).  An exceeded budget — like an exceeded
    ``max_nodes`` — yields an *anytime* answer: ``"feasible"`` with the
    incumbent and bound gap, or ``"timeout"`` with just the root bound.
    The root node is always expanded, so a bound is produced whenever the
    relaxation is solvable.
    """
    c = np.asarray(c, dtype=np.float64)
    n = c.shape[0]
    if bounds is None:
        bounds = [(0, None)] * n
    if A_ub is not None and len(A_ub):
        A_ub = np.asarray(A_ub, np.float64).reshape(-1, n)
    if A_eq is not None and len(A_eq):
        A_eq = np.asarray(A_eq, np.float64).reshape(-1, n)
    budget = deadline_s if deadline_s is not None else DEFAULT_DEADLINE_S
    t0 = time.monotonic() if budget is not None else 0.0
    # injected fault: the deadline strikes right after the root LP
    # relaxation — a bound but no incumbent, the tightest truncation a real
    # anytime run can produce (real budgets additionally accept an integral
    # root, which is why the fault path must refuse it: root-integral
    # problems would otherwise never truncate)
    forced_timeout = (faults.active() is not None and faults.should_fire(
        "solver_timeout", key=_problem_key(c, A_ub, b_ub, A_eq, b_eq,
                                           bounds)))
    pre = _presolve(n, A_ub, b_ub, A_eq, b_eq, bounds)
    if pre is None:
        return ILPResult("infeasible", None, None)
    A_ub, b_ub, A_eq, b_eq, bounds = pre
    if all(hi is not None and lo == hi for lo, hi in bounds):
        # presolve fixed every variable; verify any rows it left behind
        x = np.asarray([lo for lo, _ in bounds], dtype=np.int64)
        if A_ub is not None and np.any(A_ub @ x > np.asarray(b_ub) + 1e-6):
            return ILPResult("infeasible", None, None)
        if A_eq is not None and np.any(np.abs(A_eq @ x - np.asarray(b_eq)) > 1e-6):
            return ILPResult("infeasible", None, None)
        return ILPResult("optimal", x, float(c @ x))
    los = np.array([b[0] for b in bounds], dtype=np.float64)
    # shift x = y + lo  =>  y >= 0  (presolve already normalized the arrays)
    A_ub_l = [] if A_ub is None else [A_ub]
    b_ub_l = [] if A_ub is None else [np.asarray(b_ub, np.float64) - A_ub @ los]
    A_eq_s = A_eq
    b_eq_s = None if A_eq is None else np.asarray(b_eq, np.float64) - A_eq @ los
    # upper bounds become rows
    ub_rows = []
    ub_rhs = []
    for i, (lo, hi) in enumerate(bounds):
        if hi is not None:
            r = np.zeros(n)
            r[i] = 1.0
            ub_rows.append(r)
            ub_rhs.append(hi - lo)
    if ub_rows:
        A_ub_l.append(np.asarray(ub_rows))
        b_ub_l.append(np.asarray(ub_rhs, np.float64))
    A0 = np.vstack(A_ub_l) if A_ub_l else None
    b0 = np.concatenate(b_ub_l) if b_ub_l else None

    best_val = math.inf
    best_x: Optional[np.ndarray] = None
    const_shift = float(c @ los)

    stack = [(A0, b0)]
    nodes = 0
    root_bound: Optional[float] = None
    proven = False  # incumbent met the root LP bound: optimal despite stack
    cut = False     # search truncated (deadline or injected fault)
    while stack and nodes < max_nodes:
        if nodes > 0 and budget is not None and \
                time.monotonic() - t0 >= budget:
            cut = True
            break  # deadline: fall through to the anytime summary
        nodes += 1
        A_cur, b_cur = stack.pop()
        res = solve_lp(c, A_cur, b_cur, A_eq_s, b_eq_s)
        if nodes == 1 and res.ok:
            root_bound = res.fun  # LP relaxation bound: proves optimality early
            if forced_timeout:
                cut = True
                break
        if res.status == "unbounded":
            return ILPResult("unbounded", None, None, nodes=nodes)
        if not res.ok:
            continue
        if res.fun is not None and res.fun >= best_val - 1e-9:
            continue  # bound
        x = res.x
        frac_idx = -1
        worst = 0.0
        for i in range(n):
            f = abs(x[i] - round(x[i]))
            if f > 1e-6 and f > worst:
                worst = f
                frac_idx = i
        if frac_idx < 0:
            xi = np.round(x).astype(np.int64)
            val = float(c @ xi)
            if val < best_val:
                best_val = val
                best_x = xi
                if root_bound is not None and best_val <= root_bound + 1e-6:
                    proven = True
                    break  # incumbent meets the root LP bound: optimal
            continue
        lo_branch = math.floor(x[frac_idx])
        # x[frac] <= floor
        r = np.zeros(n)
        r[frac_idx] = 1.0
        A1 = r[None, :] if A_cur is None else np.vstack([A_cur, r])
        b1 = np.array([lo_branch]) if b_cur is None else np.concatenate([b_cur, [lo_branch]])
        # x[frac] >= ceil  ->  -x <= -(ceil)
        A2 = (-r)[None, :] if A_cur is None else np.vstack([A_cur, -r])
        b2 = np.array([-(lo_branch + 1)]) if b_cur is None else np.concatenate(
            [b_cur, [-(lo_branch + 1)]])
        stack.append((A1, b1))
        stack.append((A2, b2))

    # the root LP optimum (plus the shift) is a valid lower bound on the
    # integer optimum for the whole tree
    bound_out = None if root_bound is None else root_bound + const_shift
    if best_x is None:
        if stack or cut:
            # truncated search (deadline, node cap or injected fault) with
            # work left and no incumbent — NOT a verdict about feasibility
            return ILPResult("timeout", None, None, bound=bound_out,
                             nodes=nodes)
        return ILPResult("infeasible", None, None, nodes=nodes)
    fun = best_val + const_shift
    x_out = best_x + los.astype(np.int64)
    if (stack or cut) and not proven:
        # incumbent in hand but the tree was cut off: honest "feasible" with
        # the optimality gap, never a claimed optimum
        gap = None if bound_out is None else max(0.0, fun - bound_out)
        return ILPResult("feasible", x_out, fun, bound=bound_out, gap=gap,
                         nodes=nodes)
    return ILPResult("optimal", x_out, fun, bound=bound_out, gap=0.0,
                     nodes=nodes)


def brute_force_ilp(c, A_ub=None, b_ub=None, A_eq=None, b_eq=None, bounds=None):
    """Exhaustive reference for tests (tiny bounded problems only)."""
    import itertools

    c = np.asarray(c, dtype=np.float64)
    n = len(c)
    assert bounds is not None and all(b[1] is not None for b in bounds)
    best = None
    bx = None
    for pt in itertools.product(*[range(lo, hi + 1) for lo, hi in bounds]):
        x = np.asarray(pt, dtype=np.float64)
        if A_ub is not None and len(A_ub) and np.any(np.asarray(A_ub) @ x > np.asarray(b_ub) + 1e-9):
            continue
        if A_eq is not None and len(A_eq) and np.any(np.abs(np.asarray(A_eq) @ x - np.asarray(b_eq)) > 1e-9):
            continue
        v = float(c @ x)
        if best is None or v < best:
            best = v
            bx = np.asarray(pt, dtype=np.int64)
    if best is None:
        return ILPResult("infeasible", None, None)
    return ILPResult("optimal", bx, best)
