"""Declarative sharding rules: parameter/optimizer/batch/cache specs (the
port of ``repro.parallel.sharding``).

Scheme (mesh axes ``("pod",) data, model``):
  * FSDP   -- weight matrices shard their *input-feature* dim over "data"
             (and "pod" when present): ZeRO-3-style, all-gathered before use.
  * TP     -- attention heads / FFN columns / MoE experts shard over tp.
  * DP     -- the batch shards over ("pod", "data").
  * SP     -- long-context decode (batch=1) shards KV caches over "data"
             (sequence dimension).

The tables are pure functions of shapes and of the mesh's ``{axis: size}``
(``launch.mesh.mesh_shape``: a ``DeviceMesh``, a ``(shape, names)`` pair or
any object with ``shape`` and ``axis_names``), keyed on the leaf name as the
reference's are.  A spec is a ``P``, one entry a tensor dim: None
(replicated), a mesh axis, or a tuple of axes, major first.

The port's layers are unstacked (``lm.params_from_reference`` takes the
``blocks`` period axis and the encoder's layer axis apart and puts the
dense ``prefix`` first), so a port layer's spec is the reference's spec of
the matching stacked leaf without its leading entry.  That entry is the
None the reference pads the period axis with, except where a rule is
longer than the layer's rank: RWKV's (D, D) ``wk`` and ``wv`` under the
3-entry attention rule, where the reference shards the period axis itself,
which the port does not have.  Both packages keep the rule's last entries.

``placements`` turns a spec into DTensor placements on a ``DeviceMesh``,
and ``local_block`` gives the block of a tensor that a mesh coordinate
holds; both lay out a dim named by several axes major axis first, as JAX's
``NamedSharding`` does.
"""
from __future__ import annotations

from typing import NamedTuple

from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.config import ArchConfig, ShapeConfig
from repro_torch.launch.mesh import mesh_shape


class P(tuple):
    """A partition spec: ``P("data", None, ("pod", "model"))``.  A tuple of
    one axis is that axis, as in JAX."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self):
        return "P" + tuple.__repr__(self)


class NamedSharding(NamedTuple):
    """A spec on a mesh, for ``checkpoint.restore_checkpoint``'s
    ``shardings``."""
    mesh: object
    spec: P


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _fsdp_axis(names):
    return ("pod", "data") if "pod" in names else "data"


def _all_axes(names) -> tuple:
    return tuple(a for a in ("pod", "data", "model") if a in names)


# --- activation constraints --------------------------------------------------
# The reference's model code calls constrain(x, "dp", None, tp, ...) where
# XLA's sharding propagation historically goes wrong.  The port's sharded
# steps compute on plain local tensors, for which constrain() is the
# identity (the tensor-parallel steps place explicit collectives at those
# points instead: ``parallel.tensor_parallel``); a
# DTensor is redistributed.  With no mesh installed constrain() is a no-op.

_CTX_MESH: list = []


class ctx_mesh:
    def __init__(self, mesh, style: str = "tp"):
        self.mesh = mesh
        self.style = style

    def __enter__(self):
        _CTX_MESH.append((self.mesh, self.style))
        return self.mesh

    def __exit__(self, *a):
        _CTX_MESH.pop()


def constrain_spec(shape: tuple, *axes):
    """The spec ``constrain`` lays a tensor of ``shape`` out by under the
    installed mesh and style, or None with no mesh installed.  Tokens: "dp"
    = batch axes; "dpx" = dispatch-batch axes (the G dim of MoE expert
    buffers, without the expert axis); "ep" = expert axis; "model" = TP
    axis (dropped for ZeRO-only styles)."""
    if not _CTX_MESH:
        return None
    mesh, style = _CTX_MESH[-1]
    names = tuple(mesh_shape(mesh))
    all_axes = _all_axes(names)
    nonmodel = tuple(a for a in all_axes if a != "model")

    def res(a):
        if style == "fsdp":
            return {"dp": all_axes, "dpx": all_axes,
                    "ep": None, "model": None}.get(a, a)
        if style == "ep":
            return {"dp": all_axes, "dpx": nonmodel,
                    "ep": "model", "model": None}.get(a, a)
        return {"dp": _fsdp_axis(names), "dpx": _fsdp_axis(names),
                "ep": "model", "model": "model"}.get(a, a)

    return fit_spec(P(*(res(a) for a in axes)), shape, mesh)


def constrain(x, *axes):
    """``x`` laid out by ``constrain_spec``: a DTensor is redistributed; a
    plain tensor, or any tensor with no mesh installed, is returned as it
    is."""
    spec = constrain_spec(tuple(x.shape), *axes)
    if spec is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))


def fit_spec(spec: P, shape: tuple, mesh) -> P:
    """Drop sharding axes that do not divide the corresponding dim (e.g. 8
    KV heads on a 16-way model axis -> replicate the heads instead), the
    minor axes first: every spec is valid for every architecture."""
    sizes = mesh_shape(mesh)
    out = []
    for i, entry in enumerate(spec):
        keep = list(_axes(entry))
        while keep:
            prod = 1
            for a in keep:
                prod *= sizes[a]
            if shape[i] % prod == 0:
                break
            keep.pop()
        out.append(tuple(keep) if len(keep) > 1 else
                   keep[0] if keep else None)
    return P(*out)


# leaf name -> spec of the leaf's own (unstacked) dims
def _rules(fsdp, tp="model"):
    return {
        # embeddings / head
        "embed": P(tp, fsdp),
        "lm_head": P(fsdp, tp),
        "img_proj": P(fsdp, tp),
        # attention
        "wq": P(fsdp, tp, None),
        "wk": P(fsdp, tp, None),
        "wv": P(fsdp, tp, None),
        "wo": P(tp, None, fsdp),
        # MLA
        "wdq": P(fsdp, None),
        "wuq": P(None, tp, None),
        "wdkv": P(fsdp, None),
        "wukv": P(None, tp, None),
        # FFN
        "w_gate": P(fsdp, tp),
        "w_up": P(fsdp, tp),
        "w_down": P(tp, fsdp),
        "router": P(fsdp, None),
        # mamba
        "w_in": P(fsdp, tp),
        "conv_w": P(None, tp),
        "w_bc": P(tp, None),
        "w_dt": P(tp, None),
        "w_dt2": P(None, tp),
        "a_log": P(tp, None),
        "d_skip": P(tp),
        "w_out": P(tp, fsdp),
        # rwkv
        "wr": P(fsdp, tp),
        "ck": P(fsdp, tp),
        "cv": P(tp, fsdp),
        "u_bonus": P(tp),
    }


_MOE_3D = {"w_gate", "w_up", "w_down"}  # (E, D, F)-shaped under "ffn"


def _param_rule(cfg: ArchConfig, mesh):
    """``spec_for(names, shape)``: a parameter's spec from its path's names
    (the leaf's last) and its shape."""
    names = tuple(mesh_shape(mesh))
    if cfg.parallel_style == "fsdp":
        # ZeRO-only: no tensor parallelism; every weight shards its feature
        # dim over ALL mesh axes and the batch spans them too
        fsdp, tp = _all_axes(names), None
    elif cfg.parallel_style == "ep":
        # experts keep the "model" axis (EP); everything else is ZeRO over
        # the data axes only
        fsdp, tp = _fsdp_axis(names), None
    else:
        fsdp, tp = _fsdp_axis(names), "model"
    rules = _rules(fsdp, tp)
    # expert-parallel axis: kept for styles "tp" and "ep"
    ep = "model" if cfg.parallel_style in ("tp", "ep") else None
    # rwkv shares names with attention outputs
    rules["wdecay"] = rules["wg"] = rules["wr"]

    def spec_for(path: tuple, shape: tuple) -> P:
        name = path[-1]
        rank = len(shape)
        base = rules.get(name)
        if name == "wo" and cfg.family == "ssm":
            base = P(tp, fsdp)  # rwkv wo is (D, D)
        if base is None:
            base = P()  # norms, biases, small vectors: replicated
        # MoE expert tensors carry a leading E dim -> EP over "model" (the
        # port's layers are unstacked: the leaf's own rank)
        if name in _MOE_3D and rank >= 3 and "shared" not in path:
            # (E, D, F) / (E, F, D): experts on the EP axis, features on fsdp
            base = P(ep, fsdp, None) if name in ("w_gate", "w_up") \
                else P(ep, None, fsdp)
        pad = rank - len(base)
        if pad < 0:
            base = P(*base[-rank:])
            pad = 0
        return fit_spec(P(*([None] * pad), *base), shape, mesh)

    return spec_for


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples (a ``P`` or
    a ``NamedSharding`` is a leaf); ``path`` holds the keys and indices."""
    if isinstance(tree, (P, NamedSharding)):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def param_specs(cfg: ArchConfig, params_shape, mesh):
    """The spec tree of a parameter tree (``lm.init_params``' layout, e.g.
    ``launch.steps.abstract_params``): leaves need only ``shape``."""
    rule = _param_rule(cfg, mesh)
    return _map_with_path(lambda path, leaf: rule(path, tuple(leaf.shape)),
                          params_shape)


def param_list_specs(cfg: ArchConfig, model, mesh) -> list:
    """The specs of ``model.param_list()``, in its order (``model`` may live
    on the meta device)."""
    rule = _param_rule(cfg, mesh)
    return [rule(tuple(name.split(".")), tuple(p.shape))
            for name, p in model.named_parameters()]


def opt_specs(pspecs):
    return {"m": pspecs, "v": pspecs, "count": P()}


def batch_specs(cfg: ArchConfig, shape: ShapeConfig, mesh):
    sizes = mesh_shape(mesh)
    if cfg.parallel_style in ("fsdp", "ep"):
        axes = _all_axes(sizes)
    else:
        axes = ("pod", "data") if "pod" in sizes else ("data",)
    dp = P(axes)
    total_dp = 1
    for a in axes:
        total_dp *= sizes[a]
    shardable = shape.global_batch % total_dp == 0
    b0 = dp[0] if shardable else None
    from repro_torch.models.api import batch_shapes
    return {k: fit_spec(P(b0, *([None] * (len(shp) - 1))), shp, mesh)
            for k, (shp, _) in batch_shapes(cfg, shape).items()}


def batch_dims(bspecs: dict, mesh) -> set:
    """The indices of the mesh dims a batch laid out by ``bspecs``
    (``batch_specs``) is split over."""
    names = list(mesh_shape(mesh))
    return {names.index(a) for a in _axes(next(iter(bspecs.values()))[0])}


def cache_specs(cfg: ArchConfig, shape: ShapeConfig, mesh, cache_shape):
    """KV/state cache specs of ``lm.init_cache``'s tree (one dict a layer,
    unstacked).  decode_32k shards batch; long_500k (B=1) shards the
    sequence axis of attention caches over "data" (SP)."""
    sizes = mesh_shape(mesh)
    dp = ("pod", "data") if "pod" in sizes else "data"
    total_dp = sizes["data"] * sizes.get("pod", 1)
    batch_ok = shape.global_batch % total_dp == 0

    def spec_for(path, leaf):
        name = path[-1]
        rank = len(leaf.shape)
        if name in ("k", "v", "ckv"):          # (B, Smax, K, hd) / (B,Smax,R)
            if batch_ok:
                # batch over the data axes AND the cache sequence over
                # "model", else a 32k-deep cache leaves the model axis idle
                inner = [dp, "model"] + [None] * (rank - 2)
            else:  # SP: shard the sequence dim
                inner = [None, "data"] + [None] * (rank - 2)
        elif name in ("s", "h"):      # rwkv (B, H, hd, hd), mamba (B, di, N)
            inner = ([dp] + [None] * (rank - 1) if batch_ok else
                     [None, "model"] + [None] * (rank - 2))
        else:
            inner = [dp] + [None] * (rank - 1) if batch_ok else [None] * rank
        return fit_spec(P(*inner), tuple(leaf.shape), mesh)

    return _map_with_path(spec_for, cache_shape)


def named(mesh, spec_tree):
    """Each spec of ``spec_tree`` as a ``NamedSharding`` on ``mesh``."""
    return _map_with_path(lambda _, s: NamedSharding(mesh, s), spec_tree)


# --- specs on a DeviceMesh ----------------------------------------------------


def placements(spec: P, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each mesh
    dim that tensor dim ``d``'s entry names, ``Replicate()`` elsewhere.  A
    dim named by several axes takes them major first, which must be the
    mesh's order."""
    names = tuple(mesh_shape(mesh))
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        idx = [names.index(a) for a in _axes(entry)]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: axes {entry} out of the mesh's order "
                             f"{names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"{spec}: mesh axis {names[i]} used twice")
            out[i] = Shard(d)
    return tuple(out)


def local_block(spec: P, shape: tuple, mesh, coord) -> tuple:
    """The index (one slice a dim) of the block of a ``shape`` tensor laid
    out by ``spec`` that the device at mesh coordinate ``coord`` (a tuple in
    the mesh's axis order, or ``{axis: index}``) holds: a dim named by
    axes (a, b) is cut into size(a) x size(b) blocks, a major; dims past
    the spec's length are whole."""
    sizes = mesh_shape(mesh)
    if not isinstance(coord, dict):
        coord = dict(zip(sizes, coord))
    out = []
    for d, n in enumerate(shape):
        parts, block = 1, 0
        for a in _axes(spec[d] if d < len(spec) else None):
            block = block * sizes[a] + coord[a]
            parts *= sizes[a]
        if n % parts:
            raise ValueError(f"{spec}: dim {d} of {tuple(shape)} does not "
                             f"split into {parts}")
        out.append(slice(block * (n // parts), (block + 1) * (n // parts)))
    return tuple(out)


def shard(full, mesh, spec: P) -> DTensor:
    """``full``, the same tensor on every rank (on any device), as a
    DTensor laid out by ``spec`` on ``mesh``'s device: each rank keeps its
    own block (``local_block``), with no communication."""
    block = full[local_block(spec, tuple(full.shape), mesh,
                             mesh.get_coordinate())]
    return DTensor.from_local(block.to(mesh.device_type).contiguous(), mesh,
                              placements(spec, mesh), run_check=False)
