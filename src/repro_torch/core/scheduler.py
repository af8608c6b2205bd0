"""The scheduling ILP (§4) over absolute offsets.

HIR assigns every op a start time *relative to its parent region*; we solve
for the absolute offset theta_op = sum of relative t along the ancestor chain
(with all enclosing ivs = 0).  Every paper constraint then becomes a
difference constraint

    theta_snk - theta_src >= lower

(lower = delay - slack for memory/port dependences, = producer latency for
SSA dependences, = 0 for the structural t >= 0 constraints), i.e. a system
with a totally-unimodular matrix: Bellman-Ford (longest path) gives the exact
integer earliest schedule and feasibility; the paper's §4.3 objective
(minimize shift-register delays) is then optimized by integer coordinate
descent (exact LP via our simplex for small programs).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .deps import DepAnalysis, DepEdge
from .ir import ArithOp, ConstOp, LoadOp, Loop, Program, StoreOp


@dataclass
class Schedule:
    program: Program
    iis: dict[int, int]                 # loop uid -> II
    theta: dict[int, int]               # op uid -> absolute offset
    edges: list[DepEdge]
    feasible: bool = True
    # "exact" when every dependence slack was solved to proven optimality;
    # "degraded" when a truncated solver forced a conservative (sound but
    # possibly over-serialized) bound somewhere — see DESIGN.md §9
    provenance: str = "exact"

    # ------------------------------------------------------------------
    def t(self, op_uid: int, parent_uid: Optional[int]) -> int:
        base = self.theta[parent_uid] if parent_uid is not None else 0
        return self.theta[op_uid] - base

    def _iv_span(self, ancestors) -> int:
        return sum((l.trip - 1) * self.iis[l.uid] for l in ancestors)

    def completion_time(self) -> int:
        worst = 0
        for node, anc in self.program.walk():
            if isinstance(node, Loop):
                continue
            end = self.theta[node.uid] + self._iv_span(anc) + \
                self.program.op_latency(node)
            worst = max(worst, end)
        return worst

    def nest_latency(self, top_item) -> int:
        """Latency of one top-level item in isolation (relative to its start)."""
        base = self.theta[top_item.uid]
        worst = 0
        for node, anc in self.program.walk():
            if isinstance(node, Loop):
                continue
            if not any(a is top_item for a in anc):
                continue
            end = self.theta[node.uid] - base + self._iv_span(anc) + \
                self.program.op_latency(node)
            worst = max(worst, end)
        return worst

    def sequential_nests_latency(self) -> int:
        """The paper's 'loop-only pipelining' baseline: every top-level loop
        nest fully pipelined internally but nests executed back-to-back."""
        total = 0
        for item in self.program.body:
            if isinstance(item, Loop):
                total += self.nest_latency(item)
            else:
                total += self.program.op_latency(item)
        return total

    # -- resource metrics (paper §4.3 / Fig. 9) -------------------------
    def delay_register_bits(self) -> int:
        """Shift-register bits: per SSA def, bits * max delay over its uses."""
        defs = {}
        for node, _ in self.program.walk():
            if not isinstance(node, Loop) and node.result is not None:
                defs[node.result] = node
        per_def: dict[str, int] = {}
        for node, _ in self.program.walk():
            if isinstance(node, Loop):
                continue
            uses = list(getattr(node, "args", ()) or ())
            if isinstance(node, StoreOp):
                uses.append(node.value)
            for u in uses:
                d = defs.get(u)
                if d is None:
                    continue
                delay = self.theta[node.uid] - self.theta[d.uid] - \
                    self.program.op_latency(d)
                per_def[u] = max(per_def.get(u, 0), max(0, delay))
        return 32 * sum(per_def.values())


# ---------------------------------------------------------------------------


def _all_nodes(p: Program):
    return [node for node, _ in p.walk()]


def _parent_map(p: Program) -> dict[int, Optional[int]]:
    pm: dict[int, Optional[int]] = {}
    for node, anc in p.walk():
        pm[node.uid] = anc[-1].uid if anc else None
    return pm


def check_loop_occupancy(p: Program, iis: dict[int, int]) -> bool:
    """Loop-counter non-reentrance: II_outer >= trip_inner * II_inner for a
    directly nested loop (matches Fig. 3: II_i = 14 = 2 * II_j)."""
    for node, anc in p.walk():
        if isinstance(node, Loop) and anc:
            parent = anc[-1]
            if iis[parent.uid] < node.trip * iis[node.uid]:
                return False
    return True


def longest_path(nodes, edges: list[DepEdge]) -> Optional[dict[int, int]]:
    """Earliest schedule via integer Bellman-Ford; None if positive cycle.

    Vectorized: edges become (src, snk, lower) numpy columns sorted by sink;
    each relaxation pass is one gather + segmented max (``reduceat``) instead
    of a Python loop over edges.  Synchronous relaxation reaches the least
    fixpoint in <= |V| passes (optimal walks are simple when no positive
    cycle exists); still changing after that means a positive cycle.
    """
    ids = [n.uid for n in nodes]
    nv = len(ids)
    idx = {u: i for i, u in enumerate(ids)}
    es = [(idx[e.src], idx[e.snk], e.lower) for e in edges
          if e.lower > -10**9]
    if not es:
        return dict.fromkeys(ids, 0)
    arr = np.asarray(es, dtype=np.int64)
    order = np.argsort(arr[:, 1], kind="stable")
    src, snk, low = arr[order, 0], arr[order, 1], arr[order, 2]
    starts = np.flatnonzero(np.r_[True, snk[1:] != snk[:-1]])
    targets = snk[starts]
    theta = np.zeros(nv, dtype=np.int64)
    for _ in range(nv + 1):
        best = np.maximum.reduceat(theta[src] + low, starts)
        cur = theta[targets]
        if np.all(best <= cur):
            return dict(zip(ids, theta.tolist()))
        theta[targets] = np.maximum(cur, best)
    return None  # positive cycle -> infeasible


def _minimize_delays(p: Program, theta: dict[int, int], edges: list[DepEdge],
                     passes: int = 60) -> dict[int, int]:
    """Integer coordinate descent on the §4.3 objective: for each node, move
    it within its feasible interval in the direction that reduces
    (shift-register delays) with Sum(theta) as the tie-break."""
    inc: dict[int, list] = {}
    out: dict[int, list] = {}
    weight: dict[int, int] = {uid: 0 for uid in theta}
    for e in edges:
        out.setdefault(e.src, []).append(e)
        inc.setdefault(e.snk, []).append(e)
        if e.kind == "SSA":
            weight[e.snk] = weight.get(e.snk, 0) + 32   # as a use: earlier is better
            weight[e.src] = weight.get(e.src, 0) - 32   # as a def: later is better
    for uid in weight:
        weight[uid] += 1  # epsilon * sum(theta) tie-break: earlier preferred

    order = [n.uid for n in _all_nodes(p)]
    for _ in range(passes):
        changed = False
        for uid in order:
            lb = 0
            for e in inc.get(uid, ()):  # theta_uid >= theta_src + lower
                lb = max(lb, theta[e.src] + e.lower)
            ub = None
            for e in out.get(uid, ()):  # theta_snk >= theta_uid + lower
                cap = theta[e.snk] - e.lower
                ub = cap if ub is None else min(ub, cap)
            w = weight[uid]
            tgt = theta[uid]
            if w > 0:
                tgt = lb
            elif w < 0 and ub is not None:
                tgt = max(lb, ub)
            if tgt != theta[uid]:
                theta[uid] = tgt
                changed = True
        if not changed:
            break
    return theta


def build_edges(dep: DepAnalysis, iis: dict[int, int]) -> list[DepEdge]:
    """Memory edges are cached per conflicting pair on the IIs of the loops
    in that pair's iteration vectors, so a probe that moves one loop's II
    only recomputes the edges touching that loop; SSA/structural edges are
    II-independent and built once per DepAnalysis."""
    return dep.memory_edges(iis) + dep.static_edges()


def schedule(p: Program, iis: dict[int, int],
             dep: Optional[DepAnalysis] = None,
             minimize_registers: bool = True) -> Schedule:
    dep = dep or DepAnalysis(p)
    nodes = dep.all_nodes()

    def prov() -> str:
        # evaluated at return time: slacks (and hence degradations) are
        # computed lazily while the edges are being built
        return "degraded" if getattr(dep, "degradations", None) else "exact"

    if not check_loop_occupancy(p, iis):
        return Schedule(p, iis, {n.uid: 0 for n in nodes}, [], feasible=False,
                        provenance=prov())
    edges = build_edges(dep, iis)
    theta = longest_path(nodes, edges)
    if theta is None:
        return Schedule(p, iis, {n.uid: 0 for n in nodes}, edges,
                        feasible=False, provenance=prov())
    if minimize_registers:
        theta = _minimize_delays(p, theta, edges)
    return Schedule(p, iis, theta, edges, feasible=True, provenance=prov())


def feasible(p: Program, iis: dict[int, int], dep: DepAnalysis) -> bool:
    if not check_loop_occupancy(p, iis):
        return False
    edges = build_edges(dep, iis)
    return longest_path(dep.all_nodes(), edges) is not None


# ---------------------------------------------------------------------------
# HIR-style pretty printer (Fig. 3b flavour) for demos/debugging
# ---------------------------------------------------------------------------


def emit_hir(s: Schedule) -> str:
    p = s.program
    lines = [f"hir.func @{p.name} at %t {{"]

    def rec(items, parent_uid, depth):
        pad = "  " * depth
        for it in items:
            if isinstance(it, Loop):
                t = s.t(it.uid, parent_uid)
                lines.append(
                    f"{pad}hir.for %{it.ivname} = {it.lb} to {it.ub} "
                    f"at +{t} iter_time(%t{it.ivname}) {{")
                rec(it.body, it.uid, depth + 1)
                lines.append(f"{pad}  hir.next_iter at %t{it.ivname}+{s.iis[it.uid]}"
                             f"  {{II = {s.iis[it.uid]}}}")
                lines.append(f"{pad}}}")
            else:
                t = s.t(it.uid, parent_uid)
                if isinstance(it, LoadOp):
                    desc = f"%{it.result} = hir.load {it.array}[port {it.port}]{list(it.index)}"
                elif isinstance(it, StoreOp):
                    desc = f"hir.store {it.value} to {it.array}[port {it.port}]{list(it.index)}"
                elif isinstance(it, ArithOp):
                    desc = f"%{it.result} = hir.call @{it.fn}_f32{list(it.args)}"
                elif isinstance(it, ConstOp):
                    desc = f"%{it.result} = hir.const {it.value}"
                else:
                    desc = repr(it)
                lines.append(f"{pad}{desc} at +{t}")

    rec(p.body, None, 1)
    lines.append("}")
    return "\n".join(lines)
