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
The weights are all-gathered before use (the whole model at once):

* under the "tp" style (the reference's default) every family's train,
  prefill and decode steps gather them over the batch's axes only and
  compute on their model shards (``parallel.tensor_parallel``): the
  "model" axis splits the attention, cross-attention and RWKV heads, the
  FFN and channel-mix columns, Mamba's inner channels, the routed experts,
  PaliGemma's image projection and the vocabulary as the reference's rules
  lay them out, so a rank does its share of the work;
* the "fsdp" and "ep" styles gather each weight whole (ZeRO-3), and the
  "model" axis holds replicas of the batch's work.

The decode step keeps each cache tensor in the block ``cache_specs`` gives
the rank: the attention layers attend over the rank's block of the
positions (on "model" where the batch splits over the data axes, on
"data" for one row) and combine the softmax over that axis; RWKV's and
Mamba's states are updated on the rank's heads or channels and made whole
on "model" again.

Per-layer gathering is not ported.  The dry-run (``launch.dryrun``) traces
the step ``build`` returns on FakeTensors over a fake group of the mesh's
size, and its analyzer (``launch.hlo_analysis``) reads the graph.
"""
from __future__ import annotations

import contextlib

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


def _over(dims: set, n: int) -> list:
    """Placements of a tensor pending a sum over mesh ``dims`` (of ``n``)."""
    return [Partial() if i in dims else Replicate() for i in range(n)]


def _sum_over(x: torch.Tensor, mesh, dims: set) -> torch.Tensor:
    """``x`` summed over the ranks along mesh ``dims`` (the same on those
    ranks after); no communication when ``dims`` is empty."""
    return DTensor.from_local(x, mesh, _over(dims, mesh.ndim)).full_tensor()


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
    "ep" styles stay ZeRO-3: their layers run on whole weights."""
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


def _gather(cfg: ArchConfig, names: list, params: list,
            keep: list) -> lm.LM:
    """The model over every weight all-gathered to its placements ``keep``
    (``_keep_model``), as plain tensors."""
    return lm.LM.from_named(cfg, zip(names, (
        p.redistribute(p.device_mesh, pl).to_local()
        for p, pl in zip(params, keep))))


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
    the weights all-gathered, the masked sum and token count of the loss
    summed over the batch's mesh axes (the loss is the global masked mean),
    each gradient summed over those axes and cut to its parameter's layout
    (ranks along an axis the batch is not split over hold the same batch
    and the same gradient, counted once), the global norm over every
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

    def train_step(params, opt_state, batch):
        coord = mesh.get_coordinate()
        owned = [all(c == 0 for c, pl in zip(coord, p) if pl == Replicate())
                 for p in place]
        local = _gather(cfg, names, params, keep).requires_grad_(True)
        full = local.param_list()
        with tensor_parallel.over(mesh) if split else \
                contextlib.nullcontext():
            total, count = lm.loss_terms(cfg, local, batch)
            count = _sum_over(count.detach(), mesh, dp)
            grads = torch.autograd.grad(total / torch.clamp(count, min=1.0),
                                        full)
        del local, full
        grads = [DTensor.from_local(g, mesh, src).redistribute(
            mesh, pl).to_local() for g, src, pl in zip(grads, partial, place)]
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
        loss = _sum_over(total.detach(), mesh, dp) / torch.clamp(count,
                                                                 min=1.0)
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
    params, batch)`` the logits of the rank's block of the batch, from the
    weights all-gathered (under tensor-parallel compute, to their model
    shards, the logits' vocabulary gathered at the end)."""
    if mesh is None:
        def prefill_step(model, batch):
            return lm.forward(cfg, model, batch)
        return prefill_step
    shape = model_or_shape
    model, names, pspecs = _model_specs(cfg, mesh)
    bspecs = sharding.batch_specs(cfg, shape, mesh)
    split = _tensor_parallel(cfg, mesh)
    keep = _keep_model([sharding.placements(s, mesh) for s in pspecs],
                       mesh, split)

    def sharded_prefill_step(params, batch):
        local = _gather(cfg, names, params, keep)
        with tensor_parallel.over(mesh) if split else \
                contextlib.nullcontext():
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

    def sharded_serve_step(params, cache, batch):
        local = _gather(cfg, names, params, keep)
        blocks = [{k: t.to_local() for k, t in c.items()}
                  for c in cache["blocks"]]
        with tensor_parallel.over(mesh, rows=True) if split else \
                contextlib.nullcontext(), \
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
