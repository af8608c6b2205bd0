"""Rank functions for ``tests/test_torch_distributed.py`` and the spawner
that runs them: gloo process groups on the CPU, a ``FileStore`` under the
test's temporary directory for the rendezvous.

This module imports no JAX and nothing of the JAX package: every rank
imports it afresh (spawned), and the JAX side of each comparison is
computed in the test process on the same numpy inputs.  Each rank function
returns a picklable result, saved as ``rank<r>.pt`` beside the store.
"""
import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.launch import mesh as tmesh


def _entry(rank, fn, world, out, args):
    torch.set_num_threads(1)
    tmesh.init_distributed("cpu", rank=rank, world_size=world,
                           store=dist.FileStore(os.path.join(out, "store"),
                                                world))
    try:
        torch.save(fn(rank, out, *args), os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, out: str, *args, deadline: float = 240.0) -> list:
    """Run ``fn(rank, out, *args)`` on ``world`` gloo ranks (started from
    a fork server, one thread each) and return their results in rank order.  A rank that
    raises fails the call with its traceback; ranks still running at the
    deadline are killed and the call raises ``TimeoutError``."""
    os.makedirs(out, exist_ok=True)
    # ranks fork from a server that imported torch and the port once (the
    # test process has JAX's threads: no plain fork), not one import each
    mp.get_context("forkserver").set_forkserver_preload(
        ["torch", "torch.distributed.tensor", "repro_torch.launch.train",
         __name__])
    ctx = mp.start_processes(_entry, args=(fn, world, out, args),
                             nprocs=world, join=False,
                             start_method="forkserver")
    end = time.monotonic() + deadline
    try:
        while not ctx.join(timeout=max(0.0, end - time.monotonic())):
            if time.monotonic() >= end:
                raise TimeoutError(f"{fn.__name__} on {world} ranks: not "
                                   f"done in {deadline} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5)
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------------------
# rank functions
# ---------------------------------------------------------------------------


def several(rank, out, jobs):
    """Each (rank function's name, its arguments) of ``jobs`` in turn, on
    the same ranks: {name: result}.  A name "fn:key" runs ``fn`` (one
    function several times, under keys of their own)."""
    return {name: globals()[name.split(":")[0]](rank, out, *args)
            for name, args in jobs}


def stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def collectives(rank, out, pipe, x, w, grads, layout):
    """On 8 ranks: ``pipelined_forward`` and the gradient of
    ``pipelined_loss`` (over a "stage" axis), ``ag_matmul`` (over "model"),
    ``compressed_psum`` (over "data", noise seeded 0 on every rank),
    ``constrain`` of a replicated DTensor under the "fsdp" style on a
    (2, 2, 2) mesh, and for each (spec, full) of ``layout`` the local
    block ``shard`` keeps there and the one ``distribute_tensor`` keeps
    with ``placements``."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.parallel import collective_matmul, compression
    from repro_torch.parallel import pipeline, sharding
    res = {}
    stages = tmesh.make_mesh((8,), ("stage",), "cpu")
    params = {k: torch.from_numpy(v).requires_grad_()
              for k, v in pipe["params"].items()}
    mbs = torch.from_numpy(pipe["mbs"])
    outs = pipeline.pipelined_forward(stage_fn, params, mbs, stages,
                                      "stage")
    loss = pipeline.pipelined_loss(stage_fn, params, mbs,
                                   torch.zeros_like(mbs), stages, "stage")
    g = torch.autograd.grad(loss, list(params.values()))
    res["pipeline"] = {"outs": outs.detach().numpy(), "loss": loss.item(),
                       "grads": {k: t.numpy() for k, t in zip(params, g)}}
    model = tmesh.make_mesh((8,), ("model",), "cpu")
    m = x.shape[0] // 8
    res["ag_matmul"] = collective_matmul.ag_matmul(
        torch.from_numpy(x[rank * m:(rank + 1) * m]), torch.from_numpy(w),
        model, "model").numpy()
    data = tmesh.make_mesh((8,), ("data",), "cpu")
    res["psum"] = compression.compressed_psum(
        [torch.from_numpy(grads[rank])], data.get_group("data"),
        torch.Generator().manual_seed(0))[0].numpy()
    cube = tmesh.make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    res["coord"] = tuple(cube.get_coordinate())
    full = torch.from_numpy(layout[0][1])
    with sharding.ctx_mesh(cube, "fsdp"):
        spec = sharding.constrain_spec(tuple(full.shape), "dp", None)
        moved = sharding.constrain(distribute_tensor(
            full, cube, [Replicate()] * 3), "dp", None)
    res["constrain"] = (spec, moved.to_local().numpy())
    res["layout"] = []
    for spec, full in layout:
        t = torch.from_numpy(full)
        res["layout"].append((
            sharding.shard(t, cube, spec).to_local().numpy(),
            distribute_tensor(t, cube, sharding.placements(
                spec, cube)).to_local().numpy()))
    return res


def sharded_train(rank, out, cfg, mesh_shape, ckpt_dir, steps, batch, seq):
    """``launch.train.train`` on a (data, model) mesh of ``mesh_shape``,
    resuming from ``ckpt_dir``'s latest checkpoint; returns the losses, the
    gradient norms, the rank's mesh coordinate, the local shapes of its
    parameters and moments and its parameters' local blocks after the
    last step."""
    from repro_torch.launch import train
    mesh = tmesh.make_test_mesh(*mesh_shape, device="cpu")
    r = train.train(cfg, steps=steps, batch=batch, seq=seq,
                    ckpt_dir=ckpt_dir, log_every=1, device="cpu", mesh=mesh)
    return {"losses": r["losses"], "grad_norms": r["grad_norms"],
            "coord": tuple(mesh.get_coordinate()),
            "local": {k: [tuple(t.to_local().shape) for t in ts]
                      for k, ts in (("params", r["params"]),
                                    ("m", r["opt"]["m"]),
                                    ("v", r["opt"]["v"]))},
            "global": [tuple(t.shape) for t in r["params"]],
            "blocks": [t.to_local().detach().numpy() for t in r["params"]]}


def elastic_restore(rank, out, cfg, mesh_shape, ckpt_dir, step):
    """Restore step ``step`` of ``ckpt_dir`` (saved on another mesh) onto a
    (data, model) mesh of ``mesh_shape`` with the rule tables' shardings;
    returns each leaf's local block and the rank's coordinate."""
    from repro_torch import checkpoint
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import lm
    from repro_torch.optim import adamw_init
    from repro_torch.parallel import sharding
    mesh = tmesh.make_test_mesh(*mesh_shape, device="cpu")
    model = lm.LM(cfg, steps_mod.abstract_params(cfg))
    params = [torch.empty(p.shape, dtype=p.dtype) for p in model.param_list()]
    opt = adamw_init(params)
    specs = sharding.param_list_specs(cfg, model, mesh)
    named = sharding.named(mesh, specs)
    rp, ro = checkpoint.restore_checkpoint(
        ckpt_dir, step, (params, opt),
        (named, {"m": named, "v": named, "count": None}))
    return {"coord": tuple(mesh.get_coordinate()), "specs": specs,
            "params": [p.to_local().numpy() for p in rp],
            "m": [t.to_local().numpy() for t in ro["m"]],
            "count": int(ro["count"]),
            "sharded": sum(any(pl.is_shard() for pl in p.placements)
                           for p in rp)}


def prefill_decode(rank, out, cfg, mesh_shape, tree, tokens):
    """The sharded prefill step and 2 decode steps of ``build(cfg, shape,
    mesh)`` on weights given as a full tree (numpy, the port's layout):
    each rank's block of the logits."""
    from repro_torch.config import ShapeConfig
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import lm
    from repro_torch.parallel import sharding
    mesh = tmesh.make_test_mesh(*mesh_shape, device="cpu")
    B, S = tokens.shape
    # the specs are in init_params' order: carry the weights in it
    carried = dict(lm.LM(cfg, _tensors(tree)).named_parameters())
    model = lm.LM.from_named(cfg, [
        (n, carried[n]) for n, _ in lm.LM(
            cfg, steps_mod.abstract_params(cfg)).named_parameters()])
    pre, (pspecs, bspecs), _, _ = steps_mod.build(
        cfg, ShapeConfig("t", "prefill", S, B), mesh)
    params = steps_mod.shard_list(model.param_list(), pspecs, mesh)
    with torch.no_grad():
        logits = pre(params, steps_mod.local_batch({"tokens": tokens},
                                                   bspecs, mesh, "cpu"))
    dshape = ShapeConfig("t", "decode", S, B)
    dec, (_, cspecs, dbspecs), _, _ = steps_mod.build(cfg, dshape, mesh)
    cache = lm.init_cache(cfg, B, S, "cpu")
    cache = {"blocks": [{k: sharding.shard(t, mesh, s[k])
                         for k, t in c.items()}
                        for c, s in zip(cache["blocks"], cspecs["blocks"])]}
    steps = []
    for t in range(2):
        b = {"token": tokens[:, t:t + 1], "pos": np.full((B,), t, np.int32)}
        with torch.no_grad():
            lg, cache = dec(params, cache, steps_mod.local_batch(
                b, dbspecs, mesh, "cpu"))
        steps.append(lg.numpy())
    return {"coord": tuple(mesh.get_coordinate()),
            "prefill": logits.numpy(), "decode": steps,
            "bspec": bspecs["tokens"], "dbspec": dbspecs["token"]}


def sharded_decode(rank, out, cfg, mesh_shape, tree, batches, smax):
    """``build(cfg, shape, mesh)``'s decode step over ``batches`` (numpy
    dicts of the step's inputs, each the whole batch) from a zero cache of
    ``smax`` positions, on weights given as a full tree (numpy, the port's
    layout): each rank's block of each step's logits and its blocks of the
    last cache, with the specs that lay them out."""
    from repro_torch.config import ShapeConfig
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import lm
    from repro_torch.parallel import sharding
    mesh = tmesh.make_test_mesh(*mesh_shape, device="cpu")
    B = batches[0]["token"].shape[0]
    carried = dict(lm.LM(cfg, _tensors(tree)).named_parameters())
    model = lm.LM.from_named(cfg, [
        (n, carried[n]) for n, _ in lm.LM(
            cfg, steps_mod.abstract_params(cfg)).named_parameters()])
    dec, (pspecs, cspecs, bspecs), _, _ = steps_mod.build(
        cfg, ShapeConfig("t", "decode", smax, B), mesh)
    params = steps_mod.shard_list(model.param_list(), pspecs, mesh)
    cache = lm.init_cache(cfg, B, smax, "cpu")
    cache = {"blocks": [{k: sharding.shard(t, mesh, s[k])
                         for k, t in c.items()}
                        for c, s in zip(cache["blocks"], cspecs["blocks"])]}
    logits = []
    for b in batches:
        with torch.no_grad():
            lg, cache = dec(params, cache, steps_mod.local_batch(
                b, bspecs, mesh, "cpu"))
        logits.append(lg.numpy())
    return {"coord": tuple(mesh.get_coordinate()), "logits": logits,
            "bspec": bspecs["token"], "cspecs": cspecs,
            "cache": [{k: t.to_local().numpy() for k, t in c.items()}
                      for c in cache["blocks"]]}


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tensors(v) for v in tree]
    return torch.from_numpy(tree)


def shared_mlp(rank, out, cfg, layer, x):
    """An MoE layer (numpy weights, the port's layout) on a (1, N) mesh
    under ``tensor_parallel.over``: {"whole": its output with every weight
    whole, "split": with the rank's columns (rows of ``w_down``) of the
    shared MLP, as the rule tables lay them out, the routed experts
    whole}.  A case that raises a ValueError gives its message
    instead."""
    from repro_torch.models import layers
    from repro_torch.parallel import tensor_parallel
    mesh = tmesh.make_test_mesh(1, dist.get_world_size(), device="cpu")
    n = dist.get_world_size()

    def block(t, dim):
        size = t.shape[dim] // n
        return t.narrow(dim, rank * size, size)
    whole = _tensors(layer)
    split = {**whole,
             "shared": {"norm": whole["shared"]["norm"],
                        "w_gate": block(whole["shared"]["w_gate"], 1),
                        "w_up": block(whole["shared"]["w_up"], 1),
                        "w_down": block(whole["shared"]["w_down"], 0)}}
    res = {}
    for name, p in (("whole", whole), ("split", split)):
        try:
            with torch.no_grad(), tensor_parallel.over(mesh):
                res[name] = layers.moe_forward(cfg, p, torch.from_numpy(
                    x)).numpy()
        except ValueError as e:
            res[name] = str(e)
    return res


def gradient_order(rank, out, cfg, mesh_shape, seq, batch):
    """One train step of ``build_train_step(cfg, shape, mesh)`` from seed
    0's weights, logging in order when each layer's backward starts (a
    hook on the layer's output, ("layer", its index)) and each weight's
    gradient is brought back to its shard (("reduce", the gathered
    gradient's shape, the mesh dims reduce-scattered over, those
    all-reduced over)).  Returns the log and the layers' count."""
    from repro_torch.config import ShapeConfig
    from repro_torch.data import train_data
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import lm
    from repro_torch.optim import adamw_init
    mesh = tmesh.make_test_mesh(*mesh_shape, device="cpu")
    model = lm.LM.init(cfg, torch.Generator().manual_seed(0), "cpu")
    step, (pspecs, ospecs, bspecs), _, _ = steps_mod.build_train_step(
        cfg, ShapeConfig("t", "train", seq, batch), mesh)
    params = steps_mod.shard_list(model.param_list(), pspecs, mesh)
    opt = adamw_init(model.param_list())
    opt = {"m": steps_mod.shard_list(opt["m"], ospecs["m"], mesh),
           "v": steps_mod.shard_list(opt["v"], ospecs["v"], mesh),
           "count": opt["count"]}
    log, order = [], []
    apply, reduce = lm._apply_layer, steps_mod._reduce_gradient

    def spy_layer(cfg_, spec, p, x, *args):
        y = apply(cfg_, spec, p, x, *args)
        if id(p) not in order:
            order.append(id(p))
        i = order.index(id(p))
        y.register_hook(lambda g: log.append(("layer", i)))
        return y

    def spy_reduce(g, plan):
        log.append(("reduce", tuple(g.shape), plan.dims, plan.summed))
        return reduce(g, plan)
    lm._apply_layer, steps_mod._reduce_gradient = spy_layer, spy_reduce
    try:
        step(params, opt, steps_mod.local_batch(
            train_data(cfg, seq, batch, 0).batch_at(0), bspecs, mesh,
            "cpu"))
    finally:
        lm._apply_layer, steps_mod._reduce_gradient = apply, reduce
    return {"log": log, "layers": len(order)}


def unsplit_train(rank, out, cfg, mesh_shape, steps, batch, seq):
    """``launch.train.train`` from seed 0 on a (data, model) mesh of
    ``mesh_shape`` whose ranks outnumber ``batch``: the batch is not
    split, every rank computes the whole step; its losses and norms."""
    from repro_torch.launch import train
    mesh = tmesh.make_test_mesh(*mesh_shape, device="cpu")
    r = train.train(cfg, steps=steps, batch=batch, seq=seq, log_every=steps,
                    device="cpu", mesh=mesh)
    return {"losses": r["losses"], "grad_norms": r["grad_norms"]}
