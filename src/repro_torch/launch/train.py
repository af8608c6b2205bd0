"""End-to-end training driver (the port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_8b \
        --reduced --steps 200 --batch 8 --seq 256 --ckpt-dir /tmp/ckpt \
        [--device cpu]
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \
        -m repro_torch.launch.train --device cpu --reduced ...

The model trains on the card unless ``--device cpu`` is given.  Parameters
are drawn from a ``torch.Generator`` seeded with ``--seed`` (the reference
draws from ``jax.random``: other numbers), the batches are
``SyntheticLMData``'s (bitwise the reference's; Whisper's and PaliGemma's
with their stub inputs, ``data.train_data``), and a run resumes from the
latest checkpoint in ``--ckpt-dir``: the data stream, the parameters, the
moments and the schedule's count all continue where they stopped.  On the
card the attention (``attn_impl="chunked"``) runs K4 forward and backward,
and RWKV's time mix K5 forward and backward (``--arch rwkv6_3b``).

Under ``torch.distributed.run`` with more than one rank, or with ``mesh=``
given to ``train``, every step runs on a mesh: ``build_mesh`` makes it as
the reference's does, ``(n // gcd(n, 2), gcd(n, 2))`` over ("data",
"model"), on NCCL for the card and gloo for the CPU, and the step is
``steps.build_train_step(cfg, shape, mesh)``'s: parameters and moments
sharded by the rule tables, the batch split over the data axes.  Rank 0
prints and writes the checkpoints.
"""
from __future__ import annotations

import argparse
import math
import os
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint import AsyncCheckpointer, latest_step, \
    restore_checkpoint
from repro_torch.config import ArchConfig, ShapeConfig, get_config
from repro_torch.data import make_train_iterator, train_data
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import steps as steps_mod
from repro_torch.models import lm
from repro_torch.optim import adamw_init
from repro_torch.parallel import sharding
from repro_torch.runtime import StepWatchdog


def build_mesh(device="cuda"):
    """The reference's training mesh over every rank of the default process
    group (joined first when there is none): (n // gcd(n, 2), gcd(n, 2))
    over ("data", "model")."""
    mesh_mod.init_distributed(device)
    n = dist.get_world_size()
    model = math.gcd(n, 2) if n > 1 else 1
    return mesh_mod.make_mesh((n // model, model), ("data", "model"), device)


def train(cfg: ArchConfig, *, steps: int, batch: int, seq: int,
          ckpt_dir: str = "", ckpt_every: int = 50,
          watchdog_s: float = 600.0, log_every: int = 10, seed: int = 0,
          device="cuda", mesh=None) -> dict:
    """Train ``cfg`` up to step ``steps`` (resuming from ``ckpt_dir``'s
    latest checkpoint when there is one), printing the reference's lines.
    The batches are ``data.train_data``'s of ``seed`` (an encoder-decoder's
    and a VLM's with their modality stubs).
    On ``mesh`` (a ``DeviceMesh`` on ``device``'s type; ``build_mesh``'s
    when none is given and ``torch.distributed.run`` started more than one
    rank) every step is the sharded one.  Returns {"losses": per step run,
    "grad_norms": each step's global gradient norm, "step_s": host seconds
    per step (each ends when its loss reaches the host), "params": the
    trained parameters (DTensors on a mesh), "opt": the optimiser state,
    "model": the trained model (None on a mesh)}."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to train on "
                           "the CPU")
    if mesh is None and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        mesh = build_mesh(device)
    if mesh is not None and mesh.device_type != dev.type:
        raise ValueError(f"a {mesh.device_type} mesh for device {dev}")
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = lm.LM.init(cfg, gen, dev).requires_grad_(True)
    params = model.param_list()
    opt = adamw_init(params)
    if mesh is None:
        step_fn = steps_mod.build_train_step(cfg, model)
        shardings = None

        def run(b):
            return step_fn(model, opt, {k: torch.as_tensor(v, device=dev)
                                        for k, v in b.items()})
    else:
        step_fn, (pspecs, ospecs, bspecs), _, _ = steps_mod.build_train_step(
            cfg, ShapeConfig("cli", "train", seq, batch), mesh)
        params = steps_mod.shard_list(params, pspecs, mesh)
        opt = {"m": steps_mod.shard_list(opt["m"], ospecs["m"], mesh),
               "v": steps_mod.shard_list(opt["v"], ospecs["v"], mesh),
               "count": opt["count"]}
        model = None
        shardings = (sharding.named(mesh, pspecs),
                     {"m": sharding.named(mesh, ospecs["m"]),
                      "v": sharding.named(mesh, ospecs["v"]),
                      "count": None})

        def run(b):
            return step_fn(params, opt, steps_mod.local_batch(
                b, bspecs, mesh, dev))
    say = print if mesh is None or dist.get_rank() == 0 else \
        (lambda *a: None)
    start = 0
    ckpt = AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    if ckpt_dir and latest_step(ckpt_dir) is not None:
        start = latest_step(ckpt_dir)
        rparams, ropt = restore_checkpoint(ckpt_dir, start, (params, opt),
                                           shardings)
        if mesh is None:
            with torch.no_grad():
                for p, r in zip(params, rparams):
                    p.copy_(r)
        else:
            params[:] = rparams
        opt.update(ropt)
        say(f"[train] resumed from step {start}")

    ds = train_data(cfg, seq, batch, seed)
    it = make_train_iterator(ds, start_step=start)
    wd = StepWatchdog(watchdog_s,
                      lambda: print("[train] WATCHDOG: step timed out"))
    losses, norms, step_s = [], [], []
    t0 = time.time()
    try:
        for step, host_batch in it:
            if step >= steps:
                break
            wd.start_step()
            ts = time.perf_counter()
            metrics = run(host_batch)
            loss = float(metrics["loss"])
            step_s.append(time.perf_counter() - ts)
            wd.end_step()
            losses.append(loss)
            norms.append(metrics["grad_norm"])   # read after the loop
            if wd.straggling():
                say(f"[train] straggler flag at step {step}")
            if step % log_every == 0:
                dt = time.time() - t0
                say(f"[train] step {step} loss {loss:.4f} "
                    f"({dt / max(1, step - start + 1):.2f}s/step)")
            if ckpt and (step + 1) % ckpt_every == 0:
                ckpt.save(step + 1, (params, opt))
    finally:
        it.close()
        wd.cancel()
    if ckpt:
        ckpt.save(steps, (params, opt))
        ckpt.wait()
    if losses:
        say(f"[train] done: first loss {losses[0]:.4f} "
            f"last loss {losses[-1]:.4f}")
    return {"losses": losses, "grad_norms": [float(n) for n in norms],
            "step_s": step_s, "params": params, "opt": opt, "model": model}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3_8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--watchdog-s", type=float, default=600.0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch, reduced=args.reduced)
    try:
        return train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                     ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                     watchdog_s=args.watchdog_s, log_every=args.log_every,
                     seed=args.seed, device=args.device)["losses"]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
