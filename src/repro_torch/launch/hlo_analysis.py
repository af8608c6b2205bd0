"""The graph cost analyzer (the port of ``repro.launch.hlo_analysis``).

The reference parses the optimised HLO text XLA compiles for a step.  The
port reads what PyTorch records for one: an aten-level
``torch.fx.GraphModule`` from ``make_fx(fn, tracing_mode="fake")``, whose
nodes carry their results' shapes and dtypes (``node.meta["val"]``).  The
rules are the reference's, node for instruction:

* **Flops.**  Dots count 2 · result · contraction (``mm``, ``addmm``,
  ``bmm``, ``baddbmm``, which ``matmul`` and ``einsum`` become); any other
  op with a formula in ``torch.utils.flop_counter``'s registry counts by
  that formula: the port's kernels (K4 and K5, whose formulas their modules
  register: PERF.md's counts) and the library's convolutions and attention.
  Elementwise ops count nothing, as in the reference.
* **Bytes.**  Every top-level node moves its distinct tensor operands and
  the results that are new (an in-place or ``out`` write counts its buffer
  once).  Free, as the reference's ``_FREE_OPS``: placeholders, constants,
  ``getitem``, views (an op whose schema returns an alias of an input),
  allocations (``empty``) and ``wait_tensor``.  Gathers charge their window
  (twice the result: read and written) and scatters their update (twice),
  as the reference's dynamic-slice and dynamic-update-slice.
* **Collective bytes** by kind, the result bytes of each
  ``_c10d_functional`` collective: ``all_gather_into_tensor`` →
  all-gather, ``all_reduce`` → all-reduce, ``reduce_scatter_tensor`` →
  reduce-scatter, ``all_to_all_single`` → all-to-all (and their
  ``_coalesced`` forms).  ``wait_tensor``, the counterpart of ``-done``,
  is not counted.
* **Trips.**  The subgraphs of higher-order ops are walked: ``scan``'s body
  runs as many times as its inputs' leading dim (recorded in ``trips``),
  a ``while_loop``'s condition and body ``default_trip`` times, any other
  subgraph once.

``peak_live_bytes`` adds what XLA's memory analysis gives the reference
for free: the most bytes of intermediate results alive at once.
"""
from __future__ import annotations

import operator

import torch
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

# contractions: (op, index of the left operand); 2 * result * its last dim
_DOTS = {aten.mm: 0, aten.addmm: 1, aten.bmm: 0, aten.baddbmm: 1}
_COLLECTIVES = {"all_gather_into_tensor": "all-gather",
                "all_reduce": "all-reduce",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_to_all_single": "all-to-all"}
# free besides views: allocations, constants, aliases the schema does not
# declare (``_unsafe_view``; ``wait_tensor`` hands back its input)
_FREE = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
         aten.new_empty_strided, aten.lift_fresh_copy, aten.scalar_tensor,
         aten.arange, aten._unsafe_view}
_ALIASES = {aten._unsafe_view}
# gathers (their window: the result) and scatters (argument index of the
# update)
_GATHERS = {aten.index, aten.index_select, aten.gather, aten.embedding}
_SCATTERS = {aten.index_put: 2, aten.index_put_: 2, aten.scatter: 3,
             aten.scatter_: 3, aten.scatter_add: 3, aten.scatter_add_: 3,
             aten.index_add: 3, aten.index_add_: 3, aten.index_copy: 3,
             aten.index_copy_: 3, aten.slice_scatter: 1,
             aten.select_scatter: 1}


def _tensors(x) -> list:
    """The tensors in a value: a tensor, or a tuple or list of them."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    return []


def nbytes(x) -> int:
    """Bytes of the tensors in a value (a node's ``meta["val"]``)."""
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _val(n):
    return n.meta.get("val") if isinstance(n, torch.fx.Node) else n


def _operands(node) -> list:
    """The node's distinct input nodes that hold tensors, in order."""
    seen = []
    for a in node.all_input_nodes:
        if a not in seen and _tensors(_val(a)):
            seen.append(a)
    return seen


def _packet(node):
    t = node.target
    return t.overloadpacket if isinstance(t, torch._ops.OpOverload) else t


def _aliased(node) -> list:
    """The input nodes a node's result aliases: a view's base, an in-place
    op's written operand, ``getitem``'s tuple, ``wait_tensor``'s input."""
    if node.op != "call_function":
        return []
    t = node.target
    if t is operator.getitem or _packet(node) in _ALIASES or \
            _collective(node) == "wait":
        return [node.args[0]]
    if not isinstance(t, torch._ops.OpOverload):
        return []
    if not any(r.alias_info is not None for r in t._schema.returns):
        return []
    return [v for arg, v in zip(t._schema.arguments, node.args)
            if arg.alias_info is not None and isinstance(v, torch.fx.Node)]


def _is_view(node) -> bool:
    """An op whose result is an alias of an input that it does not write."""
    t = node.target
    if not isinstance(t, torch._ops.OpOverload):
        return False
    rets = [r.alias_info for r in t._schema.returns]
    return bool(rets) and all(a is not None and not a.is_write for a in rets)


def _collective(node):
    """``"wait"``, a collective's kind, or None."""
    t = node.target
    if not isinstance(t, torch._ops.OpOverload) or \
            t.namespace != "_c10d_functional":
        return None
    name = t.overloadpacket.__name__
    if name == "wait_tensor":
        return "wait"
    return _COLLECTIVES.get(name.removesuffix("_coalesced"))


def _subgraphs(gm, node, default_trip: int) -> list:
    """(attribute name, subgraph, trips) of a higher-order op's node."""
    if node.op != "call_function" or not isinstance(
            node.target, torch._ops.HigherOrderOperator):
        return []
    subs = [a for a in node.args if isinstance(a, torch.fx.Node)
            and a.op == "get_attr"]
    name = node.target.name()
    if name == "scan":
        xs = _tensors(_val(node.args[2]) if isinstance(node.args[2], (
            torch.fx.Node)) else [_val(a) for a in node.args[2]])
        trip = int(xs[0].shape[0]) if xs else default_trip
    elif name == "while_loop":
        trip = default_trip
    else:
        trip = 1
    return [(a.target, getattr(gm, a.target), trip) for a in subs]


def node_flops(node) -> int:
    """Flops of one node: 2 · result · contraction for a dot, the
    registered formula for any other op that has one, else 0."""
    if node.op != "call_function":
        return 0
    pk = _packet(node)
    if pk in _DOTS:
        lhs = _val(node.args[_DOTS[pk]])
        return 2 * _val(node).numel() * int(lhs.shape[-1])
    if pk in flop_registry:
        args, kwargs = torch.fx.node.map_arg((node.args, node.kwargs), _val)
        return int(flop_registry[pk](*args, **kwargs, out_val=_val(node)))
    return 0


def node_bytes(node) -> int:
    """Bytes one top-level node moves (the rules in the module's
    docstring)."""
    if node.op != "call_function" or node.target is operator.getitem:
        return 0
    pk = _packet(node)
    if pk in _FREE or _collective(node) == "wait" or _is_view(node) or \
            isinstance(node.target, torch._ops.HigherOrderOperator):
        return 0
    if pk in _GATHERS:
        return 2 * nbytes(_val(node))
    if pk in _SCATTERS:
        return 2 * nbytes(_val(node.args[_SCATTERS[pk]]))
    moved = sum(nbytes(_val(a)) for a in _operands(node))
    if not _aliased(node):
        moved += nbytes(_val(node))
    return moved


def _walk(gm, name: str, mult: int, default_trip: int, out: dict) -> None:
    flops = moved = 0
    coll: dict[str, int] = {}
    for node in gm.graph.nodes:
        flops += node_flops(node)
        moved += node_bytes(node)
        kind = _collective(node)
        if kind not in (None, "wait"):
            coll[kind] = coll.get(kind, 0) + nbytes(_val(node))
        for attr, sub, trip in _subgraphs(gm, node, default_trip):
            qual = attr if name == "entry" else f"{name}.{attr}"
            if trip != 1:
                out["trips"][qual] = trip
            _walk(sub, qual, mult * trip, default_trip, out)
    out["per_comp"][name] = {"mult": mult, "flops": flops, "bytes": moved,
                             "coll": coll}
    out["flops"] += mult * flops
    out["bytes"] += mult * moved
    for k, v in coll.items():
        out["collective_bytes"][k] = out["collective_bytes"].get(k, 0) \
            + mult * v


def analyze(gm: torch.fx.GraphModule, default_trip: int = 1) -> dict:
    """``{"flops", "bytes", "collective_bytes", "trips", "per_comp"}`` of a
    traced step, the reference's keys and meanings: totals over the root
    graph ("entry") and every subgraph times its executions;
    ``collective_bytes`` by kind; ``trips`` the loop bodies' trip counts by
    subgraph; ``per_comp`` each graph's own ``mult``, ``flops``, ``bytes``
    and ``coll``."""
    out = {"flops": 0, "bytes": 0, "collective_bytes": {}, "trips": {},
           "per_comp": {}}
    _walk(gm, "entry", 1, default_trip, out)
    return out


def _lifetimes(gm: torch.fx.GraphModule) -> tuple:
    """(the nodes, each new result's (first, last) node index and bytes,
    the per-node extra of subgraphs' peaks): a node's new result is alive
    from its definition to its last use (through the views, ``getitem``
    and in-place writes that alias it); the arguments (placeholders) and
    the graph's outputs are not counted."""
    nodes = list(gm.graph.nodes)
    owners: dict = {}       # node -> the nodes whose buffers it refers to
    size: dict = {}
    first: dict = {}
    last: dict = {}
    outputs = set()
    for i, n in enumerate(nodes):
        if n.op == "output":
            for a in n.all_input_nodes:
                outputs |= owners.get(a, set())
            continue
        base = _aliased(n)
        if n.op == "placeholder" or n.op == "get_attr":
            owners[n] = set()
        elif base:
            owners[n] = set().union(*(owners.get(b, set()) for b in base))
        else:
            owners[n] = {n}
            size[n] = nbytes(_val(n))
            first[n] = last[n] = i
        for a in n.all_input_nodes:
            for o in owners.get(a, ()):
                last[o] = max(last[o], i)
    extra = [0] * len(nodes)
    for i, n in enumerate(nodes):
        for _, sub, _ in _subgraphs(gm, n, 1):
            extra[i] += peak_live_bytes(sub)
    live = {o: (first[o], last[o], b) for o, b in size.items()
            if o not in outputs}
    return nodes, live, extra


def _peak(gm: torch.fx.GraphModule) -> tuple:
    """(the peak's bytes, the node index where it is reached, the
    lifetimes ``_lifetimes`` gives)."""
    nodes, live, extra = _lifetimes(gm)
    delta = [0] * (len(nodes) + 1)
    for f, last, b in live.values():
        delta[f] += b
        delta[last + 1] -= b
    peak = at = now = 0
    for i in range(len(nodes)):
        now += delta[i]
        if now + extra[i] > peak:
            peak, at = now + extra[i], i
    return peak, at, live


def peak_live_bytes(gm: torch.fx.GraphModule) -> int:
    """The most bytes of intermediate results alive at once: each node's
    new result is alive from its definition to its last use (through the
    views, ``getitem`` and in-place writes that alias it); the arguments
    (placeholders) and the graph's outputs are not counted (XLA's
    ``argument_size`` and ``output_size``).  A higher-order op's node adds
    its subgraphs' own peaks while it runs."""
    return _peak(gm)[0]


def live_at_peak(gm: torch.fx.GraphModule) -> dict:
    """The root graph's results alive at ``peak_live_bytes``' peak, in
    bytes by the op that made them ("all_gather_into_tensor", "mm",
    "where", ...): what the peak is made of."""
    _, at, live = _peak(gm)
    out: dict = {}
    for node, (f, last, b) in live.items():
        if f <= at <= last:
            name = _packet(node)
            name = getattr(name, "__name__", str(name))
            out[name] = out.get(name, 0) + b
    return out
