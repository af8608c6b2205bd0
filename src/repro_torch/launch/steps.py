"""Step builders shared by the trainer and the server (the port of
``repro.launch.steps``).

One device: ``build_train_step(cfg, model)``, ``build_prefill_step(cfg,
model)`` and ``build_decode_step(cfg, model)`` return the step function
alone.  PyTorch runs eagerly, so a step is the plain Python of the
reference's jitted body.

A mesh (``launch.mesh``): ``build_train_step(cfg, shape, mesh)``,
``build_prefill_step(cfg, shape, mesh)``, ``build_decode_step(cfg, shape,
mesh)`` and ``build(cfg, shape, mesh)`` return ``(fn, in_specs, out_specs,
abstract_inputs)`` as the reference's builders do (building joins no
process group: ``mesh`` may be a ``(shape, names)`` spec where only the
specs and abstract inputs are wanted): the specs are
``parallel.sharding``'s (parameters and moments as lists in
``LM.param_list`` order), the abstract inputs tensors on the ``meta``
device (``abstract_params``, ``abstract_opt_state``, ``abstract_cache``,
``api.input_specs``).  The steps take DTensors laid out by those specs
(``shard_list``) and the rank's block of the batch (``local_batch``), and
compute on plain local tensors, so the kernels receive plain CUDA tensors.
Each weight is all-gathered where it is used (``lm.gathering``), as the
reference's scan over stacked layers gathers a layer's slice inside its
loop body: a layer's weights at the layer's entry, inside the function
remat checkpoints (the backward's recompute gathers them again), the
embedding, the head and the final norm where they are read.  A weight
sharded over several mesh axes is gathered in one all-gather over their
flattened group; its gradient, a partial sum over the batch's axes, comes
back to the parameter's own shard in the gather's backward (one
reduce-scatter, or an all-reduce where the weight is replicated), so the
gradients reach their shards layer by layer:

* under the "tp" style (the reference's default) every family's train,
  prefill and decode steps gather the weights over the batch's axes only
  and compute on their model shards (``parallel.tensor_parallel``): the
  "model" axis splits the attention, cross-attention and RWKV heads, the
  FFN and channel-mix columns, Mamba's inner channels, the routed experts,
  PaliGemma's image projection and the vocabulary as the reference's rules
  lay them out, so a rank does its share of the work;
* the "fsdp" and "ep" styles (ZeRO-3) gather each weight whole, one layer
  at a time, and split the batch over every axis.

The decode step keeps each cache tensor in the block ``cache_specs`` gives
the rank: the attention layers attend over the rank's block of the
positions (on "model" where the batch splits over the data axes, on
"data" for one row) and combine the softmax over that axis; RWKV's and
Mamba's states are updated on the rank's heads or channels and made whole
on "model" again.

The dry-run (``launch.dryrun``) traces the step ``build`` returns on
FakeTensors over a fake group of the mesh's size, and its analyzer
(``launch.hlo_analysis``) reads the graph.
"""
from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.config import ArchConfig, ShapeConfig
from repro_torch.models import api, lm
from repro_torch.optim import adamw_init, adamw_update, \
    clip_by_global_norm, cosine_schedule, global_norm_sq
from repro_torch.parallel import sharding, tensor_parallel
from repro_torch.parallel.sharding import P


def abstract_params(cfg: ArchConfig) -> dict:
    """``lm.init_params``' tree on the ``meta`` device: shapes and dtypes,
    nothing drawn."""
    return lm.init_params(cfg, None, "meta")


def abstract_opt_state(cfg: ArchConfig, params_shape: dict) -> dict:
    """``adamw_init`` of ``params_shape`` (a tree as ``abstract_params``),
    its moments in ``LM.param_list`` order."""
    return adamw_init(lm.LM(cfg, params_shape).param_list())


def abstract_cache(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    return lm.init_cache(cfg, shape.global_batch, shape.seq_len, "meta")


# ---------------------------------------------------------------------------
# helpers of the sharded steps
# ---------------------------------------------------------------------------


def _model_specs(cfg: ArchConfig, mesh):
    """(the abstract model, its parameters' dotted names and specs, in
    ``param_list`` order)."""
    model = lm.LM(cfg, abstract_params(cfg))
    names = [n for n, _ in model.named_parameters()]
    return model, names, sharding.param_list_specs(cfg, model, mesh)


def _sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the ranks of ``group`` (``_batch_group``: the
    same on those ranks after) by one all-reduce; ``x`` itself where the
    group is None."""
    if group is None:
        return x
    return funcol.wait_tensor(funcol.all_reduce(x, "sum", group))


def _batch_group(mesh, dims: set):
    """The group over the mesh ``dims`` a batch is split over (their
    flattened group where there are several; made now, as ``_plans``'), or
    None where they hold one rank or ``mesh`` is a spec."""
    sizes = list(sharding.mesh_shape(mesh).values())
    dims = tuple(i for i in sorted(dims) if sizes[i] > 1)
    return _group(mesh, dims) if dims and hasattr(mesh, "get_group") \
        else None


def _sum_everywhere(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` summed over every rank of ``mesh``, which spans the default
    group (``launch.mesh`` builds it so): one all-reduce, none at one
    rank."""
    if mesh.size() == 1:
        return x
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"a mesh of {mesh.size()} ranks in a group of "
                         f"{dist.get_world_size()}")
    return funcol.wait_tensor(funcol.all_reduce(x, "sum", dist.group.WORLD))


def _tensor_parallel(cfg: ArchConfig, mesh) -> bool:
    """Whether ``cfg``'s steps compute on their model shards: the "tp"
    style, on a mesh with a "model" axis (every family).  The "fsdp" and
    "ep" styles are ZeRO-3: a layer's weights are gathered whole for it."""
    return (cfg.parallel_style == "tp"
            and "model" in sharding.mesh_shape(mesh))


def _model_dim(mesh) -> int:
    return list(sharding.mesh_shape(mesh)).index("model")


def _keep_model(place: list, mesh, split: bool) -> list:
    """Each parameter's placements once gathered: under tensor-parallel
    compute (``split``) its shard of the "model" axis kept and every other
    axis replicated, else replicated everywhere (the weight whole)."""
    mi = _model_dim(mesh) if split else -1
    return [tuple(pl[i] if i == mi else Replicate() for i in range(len(pl)))
            for pl in place]


def _partial_on_model(names: list, pspecs: list) -> set:
    """The indices of the kv projections a rank uses only in part: ``wk``
    and ``wv`` whole on "model" (their heads do not divide it) in a layer
    whose ``wq`` splits its heads.  Each rank reads its q heads' kv columns
    alone, so their gradients are partial sums over "model"."""
    spec = dict(zip(names, pspecs))

    def on_model(sp):
        return any("model" in sharding._axes(e) for e in sp)
    return {i for i, n in enumerate(names)
            if n.rsplit(".", 1)[-1] in ("wk", "wv") and not on_model(spec[n])
            and on_model(spec.get(n.rsplit(".", 1)[0] + ".wq", P()))}


class _Plan(NamedTuple):
    """How one weight is gathered and its gradient brought back: the mesh
    dims it is gathered over (in the mesh's order, each of more than one
    rank), the tensor dim each shards, their sizes, the rank's coordinate
    on each and their group; whether its gradient is a partial sum on
    them (reduce-scattered) or whole there (the batch not split: the
    rank's block is cut out); the mesh dims its gradient is summed over
    besides (where the weight is replicated on them) and their group."""
    dims: tuple
    split: tuple
    sizes: tuple
    coord: tuple
    group: object
    partial: bool
    summed: tuple
    sum_group: object


def _group(mesh, dims: tuple):
    """The process group over mesh ``dims``: one axis's, or the flattened
    group of several (its ranks in the mesh's order, major first: the
    order of a tensor dim's blocks sharded over them)."""
    names = list(sharding.mesh_shape(mesh))
    if len(dims) == 1:
        return mesh.get_group(names[dims[0]])
    if len(dims) == len(names) and mesh.size() == dist.get_world_size():
        return dist.group.WORLD      # ``launch.mesh``'s ranks in order
    return mesh[tuple(names[i] for i in dims)]._flatten().get_group()


def _plan(mesh, place: tuple, keep: tuple, grad=None) -> _Plan | None:
    """The plan of a weight laid out by ``place`` and gathered to ``keep``
    (``_keep_model``), whose local gradient has the placements ``grad``
    (partial sums on the batch's axes; None without a backward); None
    where it needs no collective."""
    sizes = list(sharding.mesh_shape(mesh).values())
    dims = tuple(i for i, (p, k) in enumerate(zip(place, keep))
                 if p.is_shard() and not k.is_shard() and sizes[i] > 1)
    summed, on = (), set()
    if grad is not None:
        on = {i for i, g in enumerate(grad)
              if g.is_partial() and sizes[i] > 1}
        if on & set(dims) not in (set(), set(dims)) or any(
                place[i].is_shard() for i in on - set(dims)):
            raise ValueError(f"a weight laid out {place}, gathered to "
                             f"{keep}: its gradient's {grad} do not sum "
                             "back to its shards")
        summed = tuple(sorted(on - set(dims)))
    if not dims and not summed:
        return None
    coord = mesh.get_coordinate()
    return _Plan(dims, tuple(place[i].dim for i in dims),
                 tuple(sizes[i] for i in dims),
                 tuple(coord[i] for i in dims),
                 _group(mesh, dims) if dims else None,
                 bool(on & set(dims)), summed,
                 _group(mesh, summed) if summed else None)


def _plans(mesh, place: list, keep: list, grad: list | None = None):
    """``_plan`` of every weight, its groups made now (every rank builds
    the step, so every rank makes them together), or None where ``mesh``
    is a ``(shape, names)`` spec: such a step is built for its specs and
    abstract inputs alone."""
    if not hasattr(mesh, "get_group"):
        return None
    return [_plan(mesh, pl, kp, None if grad is None else grad[j])
            for j, (pl, kp) in enumerate(zip(place, keep))]


def _blocked(plan: _Plan, shape) -> tuple:
    """A weight of the gathered ``shape`` written with each gathered dim as
    (its mesh dims' sizes, the local size): that shape, and the
    permutation that puts the mesh sizes first, in ``plan.dims``' order
    (the flattened group's rank order), then the local dims."""
    out, at, local = [], {}, []
    for d, n in enumerate(shape):
        parts = [j for j, sd in enumerate(plan.split) if sd == d]
        for j in parts:
            at[j] = len(out)
            out.append(plan.sizes[j])
        local.append(len(out))
        out.append(n // math.prod(plan.sizes[j] for j in parts))
    return out, [at[j] for j in range(len(plan.dims))] + local


def _gather_weight(x, plan: _Plan):
    """The rank's block ``x`` gathered over ``plan.dims`` by one
    all-gather.  Where they all shard one tensor dim, that dim is moved to
    the front of the (local) block first, so the gathered buffer is the
    weight itself, read through a view; else the buffer's blocks are laid
    out in a copy."""
    n = math.prod(plan.sizes)
    one = len(set(plan.split)) == 1
    d = plan.split[0]
    y = funcol.wait_tensor(torch.ops._c10d_functional.all_gather_into_tensor(
        (x.movedim(d, 0) if one else x).contiguous(), n,
        plan.group.group_name))
    if one:
        return y.movedim(0, d)
    full = [x.shape[i] * math.prod(s for s, sd in zip(plan.sizes, plan.split)
                                   if sd == i) for i in range(x.dim())]
    _, perm = _blocked(plan, full)
    back = sorted(range(len(perm)), key=perm.__getitem__)
    return y.view(*plan.sizes, *x.shape).permute(back).reshape(full)


def _reduce_gradient(g, plan: _Plan):
    """The gathered weight's local gradient ``g`` brought to the rank's
    shard: a partial sum reduce-scattered over ``plan.dims`` (one
    collective), or, the same on every rank there, cut to the rank's
    block; then the shard all-reduced over ``plan.summed``."""
    if plan.dims and not plan.partial:     # the same on every rank
        blocked, perm = _blocked(plan, g.shape)
        g = g.reshape(blocked).permute(perm)[plan.coord].contiguous()
    elif plan.dims:
        one = len(set(plan.split)) == 1
        d = plan.split[0]
        if one:
            y = g.movedim(d, 0)
        else:
            blocked, perm = _blocked(plan, g.shape)
            y = g.reshape(blocked).permute(perm).flatten(0, len(plan.dims))
        y = funcol.wait_tensor(
            torch.ops._c10d_functional.reduce_scatter_tensor(
                y.contiguous(), "sum", math.prod(plan.sizes),
                plan.group.group_name))
        g = (y.movedim(0, d) if one else y).contiguous()
    if plan.summed:
        g = funcol.wait_tensor(funcol.all_reduce(g, "sum", plan.sum_group))
    return g


class _GatherWeight(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, plan):
        ctx.plan = plan
        return _gather_weight(w, plan) if plan.dims else w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        return _reduce_gradient(g, ctx.plan), None


def _gathering(local: lm.LM, plans: list):
    """``lm.gathering``'s function for a model over the rank's shards
    (``local``, its ``param_list`` in ``plans``' order): each weight
    through its plan (``_GatherWeight``), or as it is where it needs no
    collective."""
    by_id = {id(p): plan for p, plan in zip(local.param_list(), plans)}

    def use(w):
        plan = by_id[id(w)]
        return w if plan is None else _GatherWeight.apply(w, plan)
    return lm.gathering(use)


def _shards(cfg: ArchConfig, names: list, params: list) -> lm.LM:
    """The model over the rank's local shards of ``params`` (DTensors),
    wrapped, not copied."""
    return lm.LM.from_named(cfg, zip(names, (p.to_local() for p in params)))


def shard_list(tensors, specs, mesh) -> list:
    """Each tensor (the same on every rank: an initialised model's
    ``param_list``, moments) as a DTensor laid out by its spec."""
    return [sharding.shard(t.detach(), mesh, s)
            for t, s in zip(tensors, specs)]


def local_batch(batch: dict, bspecs: dict, mesh, device) -> dict:
    """This rank's block of a global batch (numpy arrays or tensors, the
    same on every rank), as tensors on ``device``."""
    coord = mesh.get_coordinate()
    return {k: torch.as_tensor(v[sharding.local_block(
        bspecs[k], tuple(v.shape), mesh, coord)], device=device)
        for k, v in batch.items()}


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------


def build_train_step(cfg: ArchConfig, model_or_shape, mesh=None):
    """One device (``build_train_step(cfg, model)``): ``train_step(model,
    opt_state, batch) -> {"loss", "grad_norm"}``: the loss, its gradients
    (``torch.autograd.grad``; ``model``'s parameters must require grad),
    global-norm clipping at 1.0, the cosine schedule's rate at the
    optimiser's ``count`` and one AdamW step, which writes the parameters
    and ``opt_state`` in place.  The metrics are 0-d tensors on the model's
    device: the step itself never syncs.

    A mesh (``build_train_step(cfg, shape, mesh)``): ``(train_step,
    in_specs, out_specs, abstract)``; ``train_step(params, opt_state,
    batch)`` takes the parameters and moments as DTensors laid out by
    ``in_specs`` and the rank's block of the batch, and does the same step:
    each weight all-gathered where it is used (a layer's at the layer,
    again in its remat recompute: ``_plan``), the masked sum and token
    count of the loss summed over the batch's mesh axes (the loss is the
    global masked mean), each gradient summed over those axes and cut to
    its parameter's layout in its gather's backward, as soon as the layer
    that used it is through (ranks along an axis the batch is not split
    over hold the same batch and the same gradient, counted once), the
    global norm over every
    element once (each shard's squares taken by one replica, one
    all-reduce over every rank), AdamW on the local shards.  Under
    tensor-parallel compute (``_tensor_parallel``) the weights are gathered
    to their model shards and each rank's gradient is its shard's; a
    weight whole on "model" has the same gradient on every model rank,
    but for the kv projections each rank reads in part
    (``_partial_on_model``), whose gradients are summed over "model" too.
    At one rank it runs the ops of the one-device step in the same
    order."""
    if mesh is None:
        return _train_step(cfg, model_or_shape)
    shape = model_or_shape
    model, names, pspecs = _model_specs(cfg, mesh)
    ospecs = sharding.opt_specs(pspecs)
    bspecs = sharding.batch_specs(cfg, shape, mesh)
    place = [sharding.placements(s, mesh) for s in pspecs]
    dp = sharding.batch_dims(bspecs, mesh)
    n_dims = len(sharding.mesh_shape(mesh))
    split = _tensor_parallel(cfg, mesh)
    keep = _keep_model(place, mesh, split)
    # each gradient: a partial sum over the batch's axes; on "model" its
    # shard, a replica, or a partial sum (the kv projections read in part)
    summed = _partial_on_model(names, pspecs) if split else set()
    mi = _model_dim(mesh) if split else -1
    partial = [tuple(Partial() if i in dp or (i == mi and j in summed)
                     else kp[i] for i in range(n_dims))
               for j, kp in enumerate(keep)]
    plans = _plans(mesh, place, keep, partial)
    batch_group = _batch_group(mesh, dp)

    def train_step(params, opt_state, batch):
        coord = mesh.get_coordinate()
        owned = [all(c == 0 for c, pl in zip(coord, p) if pl == Replicate())
                 for p in place]
        local = _shards(cfg, names, params).requires_grad_(True)
        full = local.param_list()
        with _gathering(local, plans), tensor_parallel.over(mesh) \
                if split else contextlib.nullcontext():
            total, count = lm.loss_terms(cfg, local, batch)
            count = _sum_over(count.detach(), batch_group)
            grads = torch.autograd.grad(total / torch.clamp(count, min=1.0),
                                        full)
        del local, full
        sq = torch.zeros((), device=grads[0].device) + global_norm_sq(
            [g for g, own in zip(grads, owned) if own])
        grads, gnorm = clip_by_global_norm(
            grads, 1.0, total=_sum_everywhere(sq, mesh))
        lr = cosine_schedule(opt_state["count"])
        _, new = adamw_update(
            [p.to_local() for p in params], grads,
            {"m": [m.to_local() for m in opt_state["m"]],
             "v": [v.to_local() for v in opt_state["v"]],
             "count": opt_state["count"]}, lr)
        opt_state["count"] = new["count"]
        loss = _sum_over(total.detach(), batch_group) / torch.clamp(
            count, min=1.0)
        return {"loss": loss, "grad_norm": gnorm}

    in_sh = (pspecs, ospecs, bspecs)
    out_sh = (pspecs, ospecs, {"loss": P(), "grad_norm": P()})
    abstract = (model.param_list(), abstract_opt_state(cfg, abstract_params(
        cfg)), api.input_specs(cfg, shape))
    return train_step, in_sh, out_sh, abstract


def _train_step(cfg: ArchConfig, model: lm.LM):
    params = model.param_list()

    def train_step(model, opt_state, batch):
        loss = lm.loss_fn(cfg, model, batch)
        grads = torch.autograd.grad(loss, params)
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        lr = cosine_schedule(opt_state["count"])
        _, new = adamw_update(params, grads, opt_state, lr)
        opt_state.update(new)
        return {"loss": loss.detach(), "grad_norm": gnorm}

    return train_step


def build_prefill_step(cfg: ArchConfig, model_or_shape, mesh=None):
    """One device: ``prefill_step(model, batch) -> logits``.  A mesh:
    ``(prefill_step, in_specs, out_specs, abstract)``, ``prefill_step(
    params, batch)`` the logits of the rank's block of the batch, each
    layer's weights all-gathered at the layer (under tensor-parallel
    compute, to their model shards, the logits' vocabulary gathered at the
    end)."""
    if mesh is None:
        def prefill_step(model, batch):
            return lm.forward(cfg, model, batch)
        return prefill_step
    shape = model_or_shape
    model, names, pspecs = _model_specs(cfg, mesh)
    bspecs = sharding.batch_specs(cfg, shape, mesh)
    split = _tensor_parallel(cfg, mesh)
    place = [sharding.placements(s, mesh) for s in pspecs]
    keep = _keep_model(place, mesh, split)
    plans = _plans(mesh, place, keep)

    def sharded_prefill_step(params, batch):
        local = _shards(cfg, names, params)
        with _gathering(local, plans), tensor_parallel.over(mesh) \
                if split else contextlib.nullcontext():
            return lm.forward(cfg, local, batch)

    in_sh = (pspecs, bspecs)
    out_sh = P(bspecs["tokens"][0], None, None)   # logits follow the batch
    abstract = (model.param_list(), api.input_specs(cfg, shape))
    return sharded_prefill_step, in_sh, out_sh, abstract


def _sequence_axis(cspecs: dict) -> str | None:
    """The mesh axis ``cache_specs`` lays the attention caches' positions
    over (dim 1 of k, v and ckv), or None (whole, or no such cache)."""
    for c in cspecs["blocks"]:
        for name, spec in c.items():
            if name in ("k", "v", "ckv"):
                axes = sharding._axes(spec[1])
                if len(axes) > 1:
                    raise ValueError(f"{spec}: positions over {axes}")
                return axes[0] if axes else None
    return None


def _laid_out(t, spec, shape: tuple, mesh, model) -> DTensor:
    """A new cache tensor of the rank as a DTensor laid out by ``spec``
    (the global ``shape``): a state computed on the rank's heads or
    channels (``t`` short of its block along one dim) is gathered over
    ``model`` first."""
    block = tuple(s.stop - s.start for s in sharding.local_block(
        spec, shape, mesh, mesh.get_coordinate()))
    short = [d for d, (a, b) in enumerate(zip(t.shape, block)) if a != b]
    if short:
        t = tensor_parallel.gather(t, model, dim=short[0])
    return DTensor.from_local(t, mesh, sharding.placements(spec, mesh))


def build_decode_step(cfg: ArchConfig, model_or_shape, mesh=None):
    """One device: ``serve_step(model, cache, batch) -> (logits, cache)``.
    A mesh: ``(serve_step, in_specs, out_specs, abstract)``;
    ``serve_step(params, cache, batch)`` takes the cache's tensors as
    DTensors laid out by ``cache_specs`` and the rank's block of the batch.
    Nothing of the cache is gathered: each layer reads and writes the
    rank's block (``_sequence_axis``: the positions' axis, installed by
    ``tensor_parallel.sequence_over``).  Under tensor-parallel compute the
    weights are gathered to their model shards (MLA's ``wukv`` whole on
    "model" where the positions lie there: each rank expands its
    positions' latents for every head), products on weights whole on
    "model" split their contraction over it as XLA partitions the
    reference's step (``tensor_parallel.whole_product``), the new states
    are gathered whole on "model" where the cache holds them whole
    (``_laid_out``) and the logits' vocabulary is gathered.  At one rank it
    runs the one-device step's ops."""
    if mesh is None:
        def serve_step(model, cache, batch):
            return lm.decode_step(cfg, model, cache, batch)
        return serve_step
    shape = model_or_shape
    model, names, pspecs = _model_specs(cfg, mesh)
    cshape = abstract_cache(cfg, shape)
    cspecs = sharding.cache_specs(cfg, shape, mesh, cshape)
    bspecs = sharding.batch_specs(cfg, shape, mesh)
    split = _tensor_parallel(cfg, mesh)
    seq = _sequence_axis(cspecs)
    place = [sharding.placements(s, mesh) for s in pspecs]
    keep = _keep_model(place, mesh, split)
    if split and seq == "model":
        whole = _keep_model(place, mesh, False)
        keep = [w if n.endswith(".wukv") else k
                for n, k, w in zip(names, keep, whole)]

    plans = _plans(mesh, place, keep)

    def sharded_serve_step(params, cache, batch):
        local = _shards(cfg, names, params)
        blocks = [{k: t.to_local() for k, t in c.items()}
                  for c in cache["blocks"]]
        with _gathering(local, plans), tensor_parallel.over(
                mesh, rows=True) if split else contextlib.nullcontext(), \
                tensor_parallel.sequence_over(mesh, seq):
            logits, new = lm.decode_step(cfg, local, {"blocks": blocks},
                                         batch)
        ax = tensor_parallel.axis(mesh, "model")
        return logits, {"blocks": [
            {k: _laid_out(t, s[k], tuple(g[k].shape), mesh, ax)
             for k, t in c.items()}
            for c, s, g in zip(new["blocks"], cspecs["blocks"],
                               cshape["blocks"])]}

    in_sh = (pspecs, cspecs, bspecs)
    out_sh = (P(bspecs["token"][0], None, None), cspecs)
    abstract = (model.param_list(), cshape, api.input_specs(cfg, shape))
    return sharded_serve_step, in_sh, out_sh, abstract


def build(cfg: ArchConfig, shape: ShapeConfig, mesh):
    if shape.kind == "train":
        return build_train_step(cfg, shape, mesh)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape, mesh)
    return build_decode_step(cfg, shape, mesh)
