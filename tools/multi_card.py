"""The port's multi-device path across cards: one rank a card, NCCL (gloo
with ``--device cpu``), started by ``torch.distributed.run``.

    python -m torch.distributed.run --nproc-per-node 4 tools/multi_card.py
    PYTHONPATH=src OMP_NUM_THREADS=1 python -m torch.distributed.run \\
        --nproc-per-node 4 tools/multi_card.py --device cpu --reduced

On N ranks (N even) it checks, and times on the card:

* ``ag_matmul`` over all N ranks (an (N,) "model" mesh), each rank holding
  rows of x, against ``x @ w`` computed whole, and timed beside an
  ``all_gather_into_tensor`` followed by one matmul;
* ``compressed_psum`` over N ranks against the mean (within 2 %) and
  bitwise against a plain emulation of its grid (the leaves all-gathered,
  the same noise);
* ``pipelined_forward`` at S = N stages against ``reference_forward``, and
  the stages' gradients (summed over the ranks) against autograd of the
  reference loss;
* llama3-8b at its published widths cut to ``--layers`` layers (bf16,
  chunked attention, remat "full"; ``--reduced``: the reduced config)
  trained ``--steps`` steps on ``--batch`` x ``--seq`` tokens by
  ``launch.train.train`` on the (data, model) meshes (N // 2, 2) and
  (1, N), the tensor-parallel step: the model axis splits the heads, FFN
  columns and vocabulary; against the one-device step on rank 0 from the
  same weights and batches: the losses (the first steps' learning rates
  are 0 and 3e-6, so the losses differ by rounding alone) within
  LOSS_RTOL, the global gradient norms (which a gradient doubled or
  dropped on the model axis moves, whatever the rate) within NORM_RTOL,
  the ms a step of each, and the (q, k) shapes of every rank's K4 calls; then one more step of each, after a warm-up,
  under ``torch.profiler`` on the card (rank 0): its wall ms, the device's
  busy ms (the union of its kernels' spans) and kernel ms by class
  (NCCL, GEMMs, K4, the rest).

Rank 0 prints the card's name and power limit, one line a check and a
JSON line of every number; a failed check exits non-zero on every rank.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.config import get_config  # noqa: E402
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.config import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import steps as steps_mod  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import layers, lm  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.parallel import collective_matmul, compression  # noqa: E402
from repro_torch.parallel import pipeline  # noqa: E402

# bf16 steps against the one-device step: the losses' relative limit, and
# the gradient norms' by device, at ~4.5x the worst reading (4 H100s at
# full width: 1.09e-4; 4 gloo ranks on the reduced config: 1.76e-3)
LOSS_RTOL = 1e-3
NORM_RTOL = {"cuda": 5e-4, "cpu": 8e-3}


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def time_ms(fn, dev, reps: int) -> float:
    """ms a call: CUDA events over ``reps`` calls after one warm-up (the
    host clock on the CPU); every rank calls, so collectives line up."""
    fn()
    sync(dev)
    dist.barrier()
    if dev.type == "cuda":
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t) * 1e3 / reps


def check(ok: bool, what: str, out: dict) -> None:
    """Every rank agrees on the verdict (a MAX of the failures), rank 0
    prints it; a failure ends every rank non-zero."""
    bad = torch.tensor([0.0 if ok else 1.0])
    if dist.get_backend() == "nccl":
        bad = bad.cuda()
    dist.all_reduce(bad, op=dist.ReduceOp.MAX)
    if dist.get_rank() == 0:
        print(("check: " if bad.item() == 0 else "FAILED: ") + what,
              flush=True)
    if bad.item():
        out["failed"] = what
        raise SystemExit(1)


def collectives(dev, n: int, width: int, rows: int, out: dict) -> None:
    rank = dist.get_rank()
    g = torch.Generator(device=dev).manual_seed(1)     # the same everywhere
    dt = torch.bfloat16 if dev.type == "cuda" else torch.float32
    x = torch.randn((n * rows, width), generator=g, device=dev).to(dt)
    w = (torch.randn((width, width), generator=g, device=dev)
         * width ** -0.5).to(dt)
    ring = mesh_mod.make_mesh((n,), ("model",), dev.type)
    mine = x[rank * rows:(rank + 1) * rows].contiguous()
    got = collective_matmul.ag_matmul(mine, w, ring, "model")
    want = x @ w
    err = ((got.float() - want.float()).abs().max()
           / want.float().abs().max()).item()
    check(err < (2e-2 if dt == torch.bfloat16 else 1e-5),
          f"ag_matmul over {n} ranks ({n * rows} x {width} @ {width} x "
          f"{width}, {dt}) == x @ w within {err:.3g} of its largest entry",
          out)
    full = torch.empty_like(x)

    def gathered():
        dist.all_gather_into_tensor(full, mine, group=ring.get_group("model"))
        return full @ w
    out["ag_matmul"] = {
        "rows": n * rows, "width": width, "dtype": str(dt), "rel_err": err,
        "ring_ms": time_ms(lambda: collective_matmul.ag_matmul(
            mine, w, ring, "model"), dev, 10),
        "gather_then_matmul_ms": time_ms(gathered, dev, 10),
        "matmul_alone_ms": time_ms(lambda: x @ w, dev, 10)}
    # compressed psum: each rank's leaf a row of one draw
    leaves = torch.randn((n, 16, width), generator=g, device=dev) * 1e-3
    red = compression.compressed_psum(
        [leaves[rank]], ring.get_group("model"),
        torch.Generator(device=dev).manual_seed(2))[0]
    scale = (leaves.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-12
             ).amax(dim=0)
    noise = compression.uniform_noise(leaves.shape[1:], torch.Generator(
        device=dev).manual_seed(2))
    q = torch.clamp(torch.round(leaves / scale + noise), -127, 127).to(
        torch.int32)
    emul = q.sum(dim=0).float() * scale / n
    mean = leaves.mean(dim=0)
    rel = ((red - mean).abs().max() / mean.abs().max()).item()
    check(torch.equal(red, emul) and rel < 0.02,
          f"compressed_psum over {n} ranks == its grid's emulation bitwise, "
          f"{rel:.3g} off the mean", out)
    out["compressed_psum_rel_err"] = rel
    # the pipeline at S = n stages
    D, M = 64, 2 * n
    params = {"w": (torch.randn((n, D, D), generator=g, device=dev)
                    * D ** -0.5).requires_grad_(),
              "b": (torch.randn((n, D), generator=g, device=dev) * 0.1
                    ).requires_grad_()}
    mbs = torch.randn((M, 4, D), generator=g, device=dev)

    def stage(p, h):
        return torch.tanh(h @ p["w"] + p["b"])
    loss = pipeline.pipelined_loss(stage, params, mbs, torch.zeros_like(mbs),
                                   ring, "model")
    grads = torch.autograd.grad(loss, list(params.values()))
    for t in grads:
        dist.all_reduce(t)
    ref = torch.mean(torch.square(pipeline.reference_forward(
        stage, params, mbs)))
    want = torch.autograd.grad(ref, list(params.values()))
    gerr = max(((a - b).abs().max() / b.abs().max()).item()
               for a, b in zip(grads, want))
    check(abs(loss.item() - ref.item()) <= 2e-5 * abs(ref.item())
          and gerr < 2e-4,
          f"pipeline at {n} stages, {M} microbatches: loss {loss.item():.6f}"
          f" vs {ref.item():.6f}, gradients within {gerr:.3g} of their "
          "largest entries", out)
    out["pipeline_grad_rel_err"] = gerr
    del x, w, full, got, want


def one_device(cfg, dev, steps: int, batch: int, seq: int) -> dict:
    """The one-device step on this rank, ``steps`` steps from seed 0, as
    ``train.train`` runs it (its mesh-free path)."""
    model = lm.LM.init(cfg, torch.Generator(device=dev).manual_seed(0),
                       dev).requires_grad_(True)
    opt = adamw_init(model.param_list())
    step = steps_mod.build_train_step(cfg, model)
    ds = SyntheticLMData(vocab=cfg.vocab, seq_len=seq, batch=batch, seed=0)
    losses, norms, ms = [], [], []
    for i in range(steps):
        b = ds.batch_at(i)
        t = time.perf_counter()
        m = step(model, opt, {k: torch.as_tensor(v, device=dev)
                              for k, v in b.items()})
        losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t) * 1e3)
        norms.append(float(m["grad_norm"]))
    out = {"losses": losses, "grad_norms": norms, "ms": ms}
    if dev.type == "cuda":
        b = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
        out["profile"] = profile_step(lambda: step(model, opt, b))
    del model, opt
    return out


def kernel_class(name: str) -> str:
    if "nccl" in name.lower():
        return "nccl"
    if re.search(r"gemm|nvjet|xmma|cutlass", name):
        return "gemm"
    return "k4" if re.search(r"\bfa_\w+_kernel", name) else "other"


def profile_step(fn) -> dict:
    """``fn`` (a step) once after a warm-up, under ``torch.profiler``: wall
    ms (host clock, ending at a synchronize), the device's busy ms (the
    union of its kernels' and copies' spans) and their ms by class."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    spans, by = [], collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            by[kernel_class(e.name)] += e.time_range.elapsed_us() / 1e3
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return {"wall_ms": wall, "busy_ms": busy / 1e3,
            "by_class_ms": dict(sorted(by.items()))}


def k4_spy() -> collections.Counter:
    """Counts the (q, k) shapes of every call the attention layer makes to
    K4 (``layers.flash_attention``) from now on."""
    calls: collections.Counter = collections.Counter()
    real = layers.flash_attention

    def spy(q, k, v, **kw):
        calls[f"q{tuple(q.shape)} k{tuple(k.shape)}"] += 1
        return real(q, k, v, **kw)
    layers.flash_attention = spy
    return calls


def sharded(cfg, dev, shape: tuple, args, calls, out: dict) -> dict:
    """``--steps`` steps of ``train.train`` on a (data, model) mesh of
    ``shape``, checked against the one-device losses and gradient norms on
    rank 0; returns the run's record (losses, gradient norms, ms a step,
    every rank's K4 calls)."""
    mesh = mesh_mod.make_mesh(shape, ("data", "model"), args.device)
    calls.clear()
    res = train.train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                      log_every=1, seed=0, device=dev, mesh=mesh)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, dict(calls))
    rec = {"mesh": mesh_mod.describe(mesh), "losses": res["losses"],
           "grad_norms": res["grad_norms"], "ms": [s * 1e3 for s in res["step_s"]], "k4_calls": every}
    if dev.type == "cuda":      # one more step of res's state, profiled
        step, (_, _, bspecs), _, _ = steps_mod.build_train_step(
            cfg, ShapeConfig("multi_card", "train", args.seq, args.batch),
            mesh)
        b = steps_mod.local_batch(SyntheticLMData(
            vocab=cfg.vocab, seq_len=args.seq, batch=args.batch,
            seed=0).batch_at(0), bspecs, mesh, dev)
        rec["profile"] = profile_step(
            lambda: step(res["params"], res["opt"], b))
    worst = {}
    for key in ("losses", "grad_norms"):
        worst[key] = max(abs(a - b) / abs(b) for a, b in zip(
            res[key], out["one_device"][key])) if dist.get_rank() == 0 \
            else 0.0
    rec["rel_err"] = worst
    check(worst["losses"] < LOSS_RTOL
          and worst["grad_norms"] < NORM_RTOL[dev.type],
          f"llama3-8b, {cfg.n_layers} layers, {cfg.dtype}: {args.steps} "
          f"steps on {rec['mesh']} within {worst['losses']:.3g} of the "
          f"one-device losses and {worst['grad_norms']:.3g} of its gradient "
          f"norms; K4 calls a rank {every}", out)
    del res
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=2048)
    args = ap.parse_args(argv)
    dev = mesh_mod.init_distributed(args.device)
    rank, n = dist.get_rank(), dist.get_world_size()
    if n % 2:
        raise SystemExit("an even number of ranks: the mesh is (N // 2, 2)")
    meshes = [(n // 2, 2), (1, n)]
    out = {"ranks": n, "device": str(dev)}
    if rank == 0 and dev.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()
        print("cards: " + " | ".join(card), flush=True)
        out["cards"] = card
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    try:
        width, rows = (4096, 2048) if not args.reduced else (96, 8)
        collectives(dev, n, width, rows, out)
        cfg = (get_config("llama3_8b", reduced=True) if args.reduced else
               get_config("llama3_8b"))
        cfg = dataclasses.replace(cfg, n_layers=args.layers,
                                  attn_impl="chunked")
        calls = k4_spy()
        if rank == 0:
            out["one_device"] = one_device(cfg, dev, args.steps, args.batch,
                                           args.seq)
            out["one_device"]["k4_calls"] = dict(calls)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        dist.barrier()
        out["sharded"] = [sharded(cfg, dev, shape, args, calls, out)
                          for shape in meshes]
        if rank == 0:
            print("train: one-device ms a step "
                  + ", ".join(f"{x:.2f}" for x in out["one_device"]["ms"])
                  + "".join(f"; on {r['mesh']} " + ", ".join(
                      f"{x:.2f}" for x in r["ms"]) for r in out["sharded"]),
                  flush=True)
            for name, r in [("one-device", out["one_device"]),
                            *((r_["mesh"], r_) for r_ in out["sharded"])]:
                if "profile" in r:
                    p = r["profile"]
                    print(f"profile: {name}, rank 0, one step: wall "
                          f"{p['wall_ms']:.2f} ms, device busy "
                          f"{p['busy_ms']:.2f} ms; kernels by class "
                          + ", ".join(f"{k} {v:.2f}" for k, v in
                                      p["by_class_ms"].items()) + " ms",
                          flush=True)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        shape = ShapeConfig("multi_card", "train", args.seq, args.batch)
        out["dryrun"] = {}
        for mshape, r in zip(meshes, out["sharded"]):
            rec = dryrun.dryrun_cell("llama3_8b", shape.name, False, cfg,
                                     shape=shape,
                                     mesh=(mshape, ("data", "model")))
            out["dryrun"][r["mesh"]] = {k: rec[k] for k in (
                "flops_per_device", "hbm_bytes_per_device",
                "collective_bytes_per_device", "memory")}
            print(f"dryrun: the same step on {r['mesh']}: collectives a "
                  "device " + ", ".join(f"{k} {v:,} B" for k, v in sorted(
                      rec["collective_bytes_per_device"].items()))
                  + f"; {rec['flops_per_device']:,} flops, "
                  f"{rec['hbm_bytes_per_device']:,} B of HBM traffic; "
                  "measured ms a step " + ", ".join(
                      f"{x:.2f}" for x in r["ms"]), flush=True)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
