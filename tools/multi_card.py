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
* each model of ``--arch`` (a comma-separated list; default llama3-8b)
  at its published widths cut to ``--layers`` layers by
  ``chip_smoke.cut_config`` (``--dtype``, bf16 by default; remat "full";
  ``--style`` its parallel style, "tp" by default: under "fsdp" and "ep"
  each layer's weights are gathered whole at the layer, and the batch
  splits over every axis, so ``--batch`` should divide the ranks;
  DeepSeek-V2's 2 layers its dense first layer and one MoE layer; Jamba
  on TOKENS' 2 x 256 tokens; ``--reduced``: the reduced configs) trained
  ``--steps`` steps
  on ``--batch`` x ``--seq`` tokens by
  ``launch.train.train`` on the (data, model) meshes (N // 2, 2) and
  (1, N), the tensor-parallel step: the model axis splits the heads, FFN
  and channel-mix columns, Mamba's channels, the routed experts and the
  vocabulary; against
  the one-device step on rank 0 from the same weights and batches (each
  rank's peak memory printed, and with ``--beside`` beside a record of
  the same command run on another tree by ``MULTI_CARD_SRC``): the
  losses (the first steps' learning rates are 0 and 3e-6, so the losses
  differ by rounding alone) within LOSS_RTOL, the global gradient norms
  (which a gradient doubled or dropped on the model axis moves, whatever
  the rate) within NORM_RTOL, the ms a step of each, the one-device
  step's peak memory, and the shapes of every rank's K4 calls ((q, k))
  and K5 calls (r); then one more step of each, after a warm-up, under
  ``torch.profiler`` on the card (rank 0): its wall ms, the device's busy
  ms (the union of its kernels' spans) and kernel ms by class (NCCL,
  GEMMs, K4, K5, the rest).  An MoE's mesh steps route their tokens as
  their own sums give (bf16 sums in another order flip top-k's near ties:
  the count of rank 0's tokens routed otherwise in step 0's first MoE
  layer is printed with the check), and then run again under
  deterministic kernels, each rank fed the routing of its rows from a
  deterministic one-device run (``route_spy``), against the same limits:
  a fault in the split arithmetic shows there, apart from the routing's
  flips and the atomics' order;
* each model of ``--decode`` (the same cuts, in f32) decoded
  DECODE_STEPS steps of DECODE_ROWS rows over ``--decode-len`` positions
  by ``lm.decode_step`` on every card and by the sharded decode step on
  both meshes (the cache in its blocks: positions over "model", each
  rank attending over its own): each rank's logits against its card's
  one-device logits within DECODE_RTOL, ms a step, K4/K5 calls.

Rank 0 prints the card's name and power limit, one line a check and a
JSON line of every number; a failed check is printed where it fails, the
run goes on to its end (each model's numbers are kept), and then rank 0
exits non-zero (the other ranks exit 0 first: ``torch.distributed.run``
would stop rank 0's dry-run records when any other rank failed).
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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the package under test: this checkout's, or another tree's (the parent
# commit unpacked, to hold this tool's numbers beside its)
SRC = os.environ.get("MULTI_CARD_SRC", os.path.join(ROOT, "src"))
sys.path[:0] = [SRC, ROOT]

import chip_smoke  # noqa: E402

from repro_torch.data import train_data  # noqa: E402
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
# (batch, tokens) of a model's train steps where --batch x --seq would not
# fit one card: Jamba's scan keeps (B, S, 16384 channels, 16) f32 tensors
# a step of its log2(256) steps under autograd (the batch divides the
# (N // 2, 2) mesh's data axis)
TOKENS = {"jamba_1_5_large_398b": (2, 256)}
# the decode checks, in f32: DECODE_ROWS rows, DECODE_STEPS steps, the
# logits against one card's within DECODE_RTOL of the largest, ~8x the
# worst reading (4 H100s, all seven models, both meshes: 6.22e-6) and
# ~40x under bf16's rounding of one logit (2 ** -9 of it)
DECODE_ROWS, DECODE_STEPS = 8, 8
DECODE_RTOL = 5e-5


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
    prints it; a failure is listed in ``out["failed"]`` on every rank, for
    ``main`` to end non-zero."""
    bad = torch.tensor([0.0 if ok else 1.0])
    if dist.get_backend() == "nccl":
        bad = bad.cuda()
    dist.all_reduce(bad, op=dist.ReduceOp.MAX)
    if dist.get_rank() == 0:
        print(("check: " if bad.item() == 0 else "FAILED: ") + what,
              flush=True)
    if bad.item():
        out.setdefault("failed", []).append(what)


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


def one_device(cfg, dev, steps: int, batch: int, seq: int,
               routes: dict, profile: bool = True) -> dict:
    """The one-device step on this rank, ``steps`` steps from seed 0, as
    ``train.train`` runs it (its mesh-free path), with its peak memory and
    (``profile``, on the card) one more step profiled; an MoE's routing in
    those steps recorded in ``routes`` (``route_spy``)."""
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    model = lm.LM.init(cfg, torch.Generator(device=dev).manual_seed(0),
                       dev).requires_grad_(True)
    opt = adamw_init(model.param_list())
    step = steps_mod.build_train_step(cfg, model)
    ds = train_data(cfg, seq, batch, 0)
    losses, norms, ms = [], [], []
    routes["mode"] = "record"
    for i in range(steps):
        b = ds.batch_at(i)
        t = time.perf_counter()
        m = step(model, opt, {k: torch.as_tensor(v, device=dev)
                              for k, v in b.items()})
        losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t) * 1e3)
        norms.append(float(m["grad_norm"]))
    routes["mode"] = "off"
    out = {"losses": losses, "grad_norms": norms, "ms": ms}
    if dev.type == "cuda":
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if dev.type == "cuda" and profile:
        b = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
        out["profile"] = profile_step(lambda: step(model, opt, b))
    del model, opt
    return out


def kernel_class(name: str) -> str:
    if "nccl" in name.lower():
        return "nccl"
    if re.search(r"gemm|nvjet|xmma|cutlass", name):
        return "gemm"
    if re.search(r"\bwkv6_\w+_kernel", name):
        return "k5"
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


def kernel_spy() -> collections.Counter:
    """Counts the shapes of every call the layers make to K4
    (``layers.flash_attention``: "k4 q(...) k(...)") and to K5
    (``layers.wkv6_state``: "k5 r(...)") from now on."""
    calls: collections.Counter = collections.Counter()
    k4, k5 = layers.flash_attention, layers.wkv6_state

    def spy4(q, k, v, **kw):
        calls[f"k4 q{tuple(q.shape)} k{tuple(k.shape)}"] += 1
        return k4(q, k, v, **kw)

    def spy5(r, *args, **kw):
        calls[f"k5 r{tuple(r.shape)}"] += 1
        return k5(r, *args, **kw)
    layers.flash_attention, layers.wkv6_state = spy4, spy5
    return calls


def route_spy() -> dict:
    """Wraps ``layers.moe_route`` for the MoE's runs, by ``state["mode"]``:
    "record" keeps each call's expert ids (``gidx``, on the host) in call
    order (the one-device training steps, remat's second forward
    included); "feed" gives the i-th call the i-th record's rows of this
    rank's data shard (``state["rows"]``), so a mesh step routes every
    token as the one-device step did; "compare" routes as is and counts,
    in the first call, the tokens whose set of experts differs from the
    first record's (rank 0's: the others hold none); "off" routes as
    is."""
    state = {"mode": "off", "log": [], "fed": 0, "rows": None,
             "differ": None}
    real = layers.moe_route

    def spy(cfg, p, h, gidx=None):
        mode, log, rows = state["mode"], state["log"], state["rows"]
        if mode == "feed":
            gidx = log[state["fed"]][rows].to(h.device)
            state["fed"] += 1
        r = real(cfg, p, h, gidx)
        if mode == "record":
            log.append(r["gidx"].cpu())
        elif mode == "compare" and state["differ"] is None and log:
            one, mine = log[0][rows].sort(-1).values, r["gidx"].cpu().sort(
                -1).values
            state["differ"] = (int((one != mine).any(-1).sum()),
                               one.shape[0] * one.shape[1])
        return r
    layers.moe_route = spy
    return state


def sharded(cfg, dev, shape: tuple, args, calls, routes, out: dict,
            fed: bool = False) -> dict:
    """``--steps`` steps of ``train.train`` on a (data, model) mesh of
    ``shape``, checked against the one-device losses and gradient norms
    on rank 0 (the model's record ``out``: its "one_device", or fed its
    "one_device_det"; a failed check listed there); returns the
    run's record (losses, gradient norms, ms a step, every rank's K4 and
    K5 calls).  An MoE's run routes as is and counts rank 0's tokens of
    step 0's first MoE layer that went to other experts than one-device;
    ``fed``, it takes the one-device routing instead (``route_spy``; every
    record fed once) and is not profiled."""
    batch, seq = args.batch, args.seq
    mesh = mesh_mod.make_mesh(shape, ("data", "model"), args.device)
    calls.clear()
    if cfg.moe is not None:
        g = batch // shape[0]
        d = mesh.get_coordinate()[0]
        routes.update(mode="feed" if fed else "compare", fed=0,
                      differ=None, rows=slice(d * g, (d + 1) * g))
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    res = train.train(cfg, steps=args.steps, batch=batch, seq=seq,
                      log_every=1, seed=0, device=dev, mesh=mesh)
    routes["mode"] = "off"
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, dict(calls))
    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(peaks, torch.cuda.max_memory_allocated() / 1e9
                           if dev.type == "cuda" else None)
    rec = {"mesh": mesh_mod.describe(mesh), "losses": res["losses"],
           "grad_norms": res["grad_norms"],
           "ms": [s * 1e3 for s in res["step_s"]], "kernel_calls": every,
           "peak_gb": peaks}
    how, routed, all_fed = "", "", True
    if fed:
        all_fed = routes["fed"] == len(routes["log"])
        rec["fed_calls"] = [routes["fed"], len(routes["log"])]
        how = (", deterministic kernels, the one-device routing fed to "
               "every rank ({} of {} MoE calls),").format(*rec["fed_calls"])
    elif routes["differ"] is not None:
        rec["route_differs"] = routes["differ"]
        routed = ("; step 0's first MoE layer routes {} of {} tokens of "
                  "rank 0 to another set of experts").format(
                      *routes["differ"])
    if dev.type == "cuda" and not fed:  # one more step of res's, profiled
        step, (_, _, bspecs), _, _ = steps_mod.build_train_step(
            cfg, ShapeConfig("multi_card", "train", seq, batch), mesh)
        b = steps_mod.local_batch(train_data(cfg, seq, batch, 0).batch_at(0),
                                  bspecs, mesh, dev)
        rec["profile"] = profile_step(
            lambda: step(res["params"], res["opt"], b))
    worst, one = {}, out.get("one_device_det" if fed else "one_device")
    for key in ("losses", "grad_norms"):
        worst[key] = max(abs(a - b) / abs(b) for a, b in zip(
            res[key], one[key])) if dist.get_rank() == 0 \
            else 0.0
    rec["rel_err"] = worst
    check(all_fed and worst["losses"] < LOSS_RTOL
          and worst["grad_norms"] < NORM_RTOL[dev.type],
          f"{cfg.name}, {cfg.n_layers} layers, {cfg.dtype}, {batch} x "
          f"{seq} tokens: {args.steps} steps on {rec['mesh']}{how} within "
          f"{worst['losses']:.3g} of the one-device losses and "
          f"{worst['grad_norms']:.3g} of its gradient norms{routed}; K4/K5 "
          f"calls a rank {every}", out)
    del res
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rec


def model_config(arch: str, args):
    """``arch`` cut to ``--layers`` layers by ``chip_smoke.cut_config``
    (``--reduced``: the reduced config, its experts all kept), in
    ``--dtype``, under the parallel style ``--style``."""
    return dataclasses.replace(chip_smoke.cut_config(
        arch, args.layers, args.reduced), dtype=args.dtype,
        parallel_style=args.style)


def decode_batches(cfg, args, dev) -> list:
    """DECODE_STEPS decode inputs of DECODE_ROWS rows (the same on every
    rank): row r starts at position (r + 1) * L / rows - 4 of the
    L = ``--decode-len`` positions, so the rows cross the blocks' edges of
    either mesh's split of the positions and the last row runs past the
    cache's end (clamped); Whisper's frames drawn each step."""
    g = torch.Generator().manual_seed(5)
    rows, L = DECODE_ROWS, args.decode_len
    start = torch.arange(1, rows + 1, dtype=torch.int32) * (L // rows) - 4
    out = []
    for t in range(DECODE_STEPS):
        b = {"token": torch.randint(0, cfg.vocab, (rows, 1), generator=g,
                                    dtype=torch.int32), "pos": start + t}
        if cfg.family == "encdec":
            b["frames"] = torch.randn((rows, cfg.enc_seq, cfg.d_model),
                                      generator=g).to(getattr(torch,
                                                              cfg.dtype))
        out.append(b)
    return out


def decode_runs(arch: str, dev, meshes, args, calls) -> dict:
    """One model's decode step: ``lm.decode_step`` on every rank's card
    (the same weights from seed 0, the same batches), then the sharded
    decode step (``steps.build``) on each mesh, the cache laid out by its
    specs: each rank's block of every step's logits against its own
    one-card logits, within DECODE_RTOL of their largest (f32); ms a step
    of each (after the first step) and every rank's K4/K5 calls."""
    from repro_torch.parallel import sharding
    cfg = dataclasses.replace(model_config(arch, args), dtype="float32")
    rows, L = DECODE_ROWS, args.decode_len
    model = lm.LM.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    batches = decode_batches(cfg, args, dev)
    cache = lm.init_cache(cfg, rows, L, dev)
    want, ms = [], []
    calls.clear()
    with torch.no_grad():
        for b in batches:
            sync(dev)
            t = time.perf_counter()
            lg, cache = lm.decode_step(cfg, model, cache, b)
            sync(dev)
            ms.append((time.perf_counter() - t) * 1e3)
            want.append(lg)
    rec = {"arch": arch, "rows": rows, "positions": L,
           "one_card_ms": ms, "one_card_calls": dict(calls), "meshes": []}
    del cache
    for shape in meshes:
        mesh = mesh_mod.make_mesh(shape, ("data", "model"), args.device)
        dec, (pspecs, cspecs, bspecs), _, _ = steps_mod.build(
            cfg, ShapeConfig("multi_card", "decode", L, rows), mesh)
        params = steps_mod.shard_list(model.param_list(), pspecs, mesh)
        cache = {"blocks": [{k: sharding.shard(t, mesh, s[k])
                             for k, t in c.items()}
                            for c, s in zip(lm.init_cache(
                                cfg, rows, L, dev)["blocks"],
                                cspecs["blocks"])]}
        calls.clear()
        worst, ms = 0.0, []
        with torch.no_grad():
            for b, w in zip(batches, want):
                sync(dev)
                dist.barrier()
                t = time.perf_counter()
                got, cache = dec(params, cache, steps_mod.local_batch(
                    b, bspecs, mesh, dev))
                sync(dev)
                ms.append((time.perf_counter() - t) * 1e3)
                ix = sharding.local_block(bspecs["token"], tuple(w.shape),
                                          mesh, mesh.get_coordinate())
                worst = max(worst, ((got.float() - w[ix].float()).abs().max()
                                    / w.float().abs().max()).item())
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, dict(calls))
        every_err = [None] * dist.get_world_size()
        dist.all_gather_object(every_err, worst)
        r = {"mesh": mesh_mod.describe(mesh), "ms": ms, "rel_err": every_err,
             "kernel_calls": every}
        rec["meshes"].append(r)
        check(max(every_err) < DECODE_RTOL,
              f"decode {cfg.name}, {cfg.n_layers} layers, {cfg.dtype}, "
              f"{rows} rows over "
              f"{L} positions: {len(batches)} steps on {r['mesh']} within "
              f"{max(every_err):.3g} of one card's logits (largest); "
              f"K4/K5 calls a rank {every}", rec)
        del params, cache
    del model
    if dist.get_rank() == 0:
        print(f"decode: {cfg.name}, {cfg.n_layers} layers, {cfg.dtype}, "
              f"{rows} rows x "
              f"{L} positions: one card ms a step " + ", ".join(
                  f"{x:.2f}" for x in rec["one_card_ms"][1:])
              + "".join(f"; on {r['mesh']} " + ", ".join(
                  f"{x:.2f}" for x in r["ms"][1:]) for r in rec["meshes"]),
              flush=True)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rec


def model_runs(arch: str, dev, meshes, args, calls, routes) -> dict:
    """One model of ``--arch``: the one-device step on rank 0, then the
    mesh steps (``sharded``).  An MoE's then run again under PyTorch's
    deterministic kernels (``torch.use_deterministic_algorithms``; the
    backward of the dispatch gather otherwise adds with atomics, in an
    order that moves a step's norm by up to 3.8e-4 run to run on the
    card): the one-device step once more, its routing recorded and sent
    to every rank, and the mesh steps fed that routing, so that only the
    split arithmetic's rounding is left between them ("fed").  Rank 0
    takes the dry-run records after the group is gone
    (``dryrun_records``)."""
    cfg = model_config(arch, args)
    args = argparse.Namespace(**{**vars(args), **dict(zip(
        ("batch", "seq"), TOKENS.get(arch, (args.batch, args.seq))))})
    rank = dist.get_rank()
    rec = {"arch": arch}
    calls.clear()
    routes.update(mode="off", log=[])
    if rank == 0:
        rec["one_device"] = one_device(cfg, dev, args.steps, args.batch,
                                       args.seq, routes)
        rec["one_device"]["kernel_calls"] = dict(calls)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    dist.barrier()
    rec["sharded"] = [sharded(cfg, dev, shape, args, calls, routes, rec)
                      for shape in meshes]
    if cfg.moe is not None:
        torch.use_deterministic_algorithms(True, warn_only=True)
        routes["log"] = []
        if rank == 0:
            rec["one_device_det"] = one_device(
                cfg, dev, args.steps, args.batch, args.seq, routes,
                profile=False)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        box = [routes["log"]]
        dist.broadcast_object_list(box, src=0)
        routes["log"] = box[0]
        rec["fed"] = [sharded(cfg, dev, shape, args, calls, routes, rec,
                              fed=True) for shape in meshes]
        torch.use_deterministic_algorithms(False)
    routes["log"] = []
    if rank == 0:
        one = rec["one_device"]
        print(f"train: {cfg.name}, {cfg.n_layers} layers"
              + (f", {cfg.moe.n_experts} experts" if cfg.moe else "")
              + f", {args.batch} x {args.seq} tokens: one-device ms a step "
              + ", ".join(f"{x:.2f}" for x in one["ms"])
              + (f" (peak {one['peak_gb']:.2f} GB)" if "peak_gb" in one
                 else "")
              + "".join(f"; on {r['mesh']} " + ", ".join(
                  f"{x:.2f}" for x in r["ms"]) for r in rec["sharded"])
              + (("; deterministic kernels: one-device " + ", ".join(
                  f"{x:.2f}" for x in rec["one_device_det"]["ms"]))
                 if "fed" in rec else "")
              + "".join(f"; on {r['mesh']}, routing fed, " + ", ".join(
                  f"{x:.2f}" for x in r["ms"]) for r in rec.get("fed", [])),
              flush=True)
        for r in rec["sharded"]:
            if r["peak_gb"][0] is not None:
                print(f"memory: {cfg.name}, {cfg.parallel_style}, on "
                      f"{r['mesh']}: peak GB by rank " + ", ".join(
                          f"{x:.3f}" for x in r["peak_gb"]), flush=True)
        for name, r in [("one-device", one),
                        *((r_["mesh"], r_) for r_ in rec["sharded"])]:
            if "profile" in r:
                p = r["profile"]
                print(f"profile: {cfg.name}, {name}, rank 0, one step: wall "
                      f"{p['wall_ms']:.2f} ms, device busy "
                      f"{p['busy_ms']:.2f} ms; kernels by class "
                      + ", ".join(f"{k} {v:.2f}" for k, v in
                                  p["by_class_ms"].items()) + " ms",
                      flush=True)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rec


def dryrun_records(rec: dict, args, meshes) -> None:
    """The dry-run's records of ``rec``'s step on each mesh (rank 0, no
    process group left: the dry-run makes a fake one)."""
    cfg = model_config(rec["arch"], args)
    batch, seq = TOKENS.get(rec["arch"], (args.batch, args.seq))
    shape = ShapeConfig("multi_card", "train", seq, batch)
    rec["dryrun"] = {}
    for mshape, r in zip(meshes, rec["sharded"]):
        d = dryrun.dryrun_cell(rec["arch"], shape.name, False, cfg,
                               shape=shape,
                               mesh=(mshape, ("data", "model")))
        rec["dryrun"][r["mesh"]] = {k: d[k] for k in (
            "flops_per_device", "hbm_bytes_per_device",
            "collective_bytes_per_device", "memory")}
        print(f"dryrun: {cfg.name}, the same step on {r['mesh']}: "
              "collectives a device " + ", ".join(
                  f"{k} {v:,} B" for k, v in sorted(
                      d["collective_bytes_per_device"].items()))
              + f"; {d['flops_per_device']:,} flops, "
              f"{d['hbm_bytes_per_device']:,} B of HBM traffic; "
              "measured ms a step " + ", ".join(
                  f"{x:.2f}" for x in r["ms"]), flush=True)


def peaks_beside(out: dict, path: str) -> None:
    """Each model's mesh runs' peak GB by rank beside those of the record
    at ``path`` (the same command on another tree), matched by model and
    mesh."""
    with open(path) as f:
        other = {(m["arch"], r["mesh"]): r.get("peak_gb")
                 for m in json.load(f)["models"] for r in m["sharded"]}
    for m in out["models"]:
        for r in m["sharded"]:
            was = other.get((m["arch"], r["mesh"]))
            if r["peak_gb"][0] is None or not was or was[0] is None:
                continue
            print(f"memory: {m['arch']} on {r['mesh']}: peak GB by rank "
                  + ", ".join(f"{a:.3f} (was {b:.3f}, {a - b:+.3f})"
                              for a, b in zip(r["peak_gb"], was)),
                  flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arch", default="llama3_8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"],
                    help="the trained models' dtype (f32: the split "
                    "arithmetic's rounding alone, apart from bf16's)")
    ap.add_argument("--decode", default="",
                    help="comma-separated archs whose decode step to check")
    ap.add_argument("--decode-len", type=int, default=4096)
    ap.add_argument("--style", default="tp", choices=["tp", "fsdp", "ep"],
                    help="the trained models' parallel style")
    ap.add_argument("--json", default=None,
                    help="also write rank 0's JSON record to this file")
    ap.add_argument("--beside", default=None,
                    help="a --json record of the same command on another "
                    "tree (MULTI_CARD_SRC): each rank's peak memory "
                    "printed beside its")
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
        calls, routes = kernel_spy(), route_spy()
        out["models"] = [model_runs(arch, dev, meshes, args, calls, routes)
                         for arch in args.arch.split(",") if arch]
        out["decode"] = [decode_runs(arch, dev, meshes, args, calls)
                         for arch in args.decode.split(",") if arch]
    finally:
        dist.destroy_process_group()
    if rank == 0:
        for rec in out["models"]:
            dryrun_records(rec, args, meshes)
        if args.beside:
            peaks_beside(out, args.beside)
        print(json.dumps(out), flush=True)
        if args.json:
            with open(args.json, "w") as f:
                json.dump(out, f)
    failed = out.get("failed", []) + [
        f for rec in out["models"] + out["decode"]
        for f in rec.get("failed", [])]
    if failed and rank == 0:
        print(f"FAILED: {len(failed)} check(s)", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
