"""Time this tree's K1, K2, K4 and K5 calls beside a parent tree's, in one
process on one card, in turns (parent, tree, tree, parent).

    git archive <parent commit> src | tar -x -C build/parent
    PYTHONPATH=src python3 tools/compare_parent.py --parent build/parent/src
    PYTHONPATH=src python3 tools/compare_parent.py --parent build/parent/src \
        --only k1
    PYTHONPATH=src python3 tools/compare_parent.py --parent build/parent/src \
        --only k4
    PYTHONPATH=src python3 tools/compare_parent.py --parent build/parent/src \
        --only k4_bwd
    PYTHONPATH=src python3 tools/compare_parent.py --parent build/parent/src \
        --only k5_bwd
    PYTHONPATH=src python3 tools/compare_parent.py --parent build/parent/src \
        --only k2

Each tree's ``repro_torch`` is imported in turn (``sys.modules`` cleared
between) and builds its kernels under its own root; the parent's is a copy
whose ``torch.library`` operators take another namespace (``renamed``).  Per tree it measures,
on the shapes of this repo's paths (NVIDIA card, f32 matmuls in full
precision):

* the fused stencil (K1) on the 4K UHD frame (2160, 3840) at the DSE's
  (block_rows, halo) = (2, 2), f32 and bf16: the call with a cold L2
  (``chip_smoke.time_cold_ms``) and warm (``chip_smoke.time_ms``), and
  whether it equals the plain version bit for bit;
* the CUDA-core flash attention (K4) at the reduced llama3-8b's
  (2, 6, 256, 16) causal on the layer's GQA views, f32 and bf16: the
  wrapper call (CUDA events) and, from torch.profiler, the device kernels
  one call runs and the attention kernel's own time;
* K4 f32 at gemma-7b's (1, 16, 1024, 256) causal on views (the parent runs
  it on the CUDA cores, this tree on the tensor cores);
* WKV6 (K5): the sequence form at (1, 40, 1024, 64) f32, and the step at
  (4, 40, 1, 64) as each tree's layer calls it (the parent on f32 copies,
  this tree on bf16 views with the state in place);
* the graphed rwkv6-3b decode step at batch 4 (random weights): device
  activities and busy time per step (profiler) and the replay's wall time;
* K4's bf16 forward (``flash_attention``, causal, on views of (B, S,
  heads, hd) tensors) at PaliGemma's q (1, 8, 1024, 256) over one kv head,
  llama3-8b's (1, 32, 4096, 128) over 8, Kimi-K2's (1, 64, 2048, 128) over
  8 and Whisper's (1, 12, 448, 64): the call (CUDA events), each device
  kernel's time (torch.profiler) and, in the same turn,
  ``scaled_dot_product_attention``'s call (``measure_k4``);
* K4's backward (``flash_attention_bwd``, on the tree's own forward output
  and log-sum-exp) at the train path's llama3-8b shape, q (2, 32, 2048,
  128) over 8 kv heads, causal, in bf16; in bf16 also at Kimi-K2's (1, 64,
  2048, 128) over 8, Whisper's (1, 12, 448, 64), not causal, and
  PaliGemma's (1, 8, 1024, 256) over one kv head; in f32 at (1, 32, 2048,
  128), Whisper's and PaliGemma's; at the reduced llama3-8b's (2, 6, 256,
  16) in both dtypes; each on the tree's own ``bwd_route``: the call (CUDA
  events), from torch.profiler each device kernel's time, and the backward
  of ``scaled_dot_product_attention`` and the plain version
  (``flash_attention_bwd_plain`` at the route's tiles) at the same shape
  in the same turn;
* K5's backward (``wkv6_bwd``) at hd 16, 32, 64 and 128 on rwkv6-3b's
  width (2560 = heads x hd), 2 x 256 and 2 x 2048 tokens (the latter at
  hd 64 the train_rwkv path's (2, 40, 2048, 64)), bf16 views of (B, S, D)
  tensors at the time mix's decays, on the tree's own route (a tree
  without ``bwd_route`` walks every token on the CUDA cores): the call
  (CUDA events), from torch.profiler each device kernel's time, and
  whether its gradients equal the parent's bit for bit;
* the host ms a wrapper call takes (its enqueue, the least mean of 20
  calls over 15 windows, the card kept busy meanwhile) of K4's forward on
  each of its three routes and its bf16 backward, K5's sequence form, its step on the
  layer's bf16 views with the state in place and its backward
  (``measure_host``; since K4 and K5 launch through ``torch.library``
  operators, the dispatcher's share of a call shows here).

``--only k2`` measures the streamed kernel (K2) alone: the six streamed
programs at n=4096 in float32 at their design points' block sizes
(``K2_BLOCK_ROWS``, as ``chip_smoke.py`` compiles them), the gridded
kernel's time (CUDA events) and whether it equals the tree's own plain
version bit for bit.

``--only k1`` measures K1 alone, ``--only k4`` K4's bf16 forward alone,
``--only k4_bwd`` K4's backward alone,
``--only k5_bwd`` K5's backward alone, ``--only host`` the wrappers' host
time alone.  Prints one line per tree and turn
and a JSON summary last.
"""
from __future__ import annotations

import argparse
import functools
import inspect
import json
import os
import pathlib
import re
import shutil
import statistics
import sys
import time
import types

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

STEPS = 5          # decode steps under the profiler
REPLAYS = 50       # decode steps timed
# wrapper host time: groups of pairs of windows of calls, each group behind
# a spin of the card that outlasts its windows
HOST_GROUPS, HOST_PAIRS, HOST_CALLS = 10, 4, 10
HOST_SPIN_MS = 100
# K5's backward: head dims, rwkv6-3b's width, and tokens a row (B = 2)
# by shape: "i" the smoke's checks', "ii" the train path's
K5_BWD_HDS = (16, 32, 64, 128)
K5_BWD_D = 2560
K5_BWD_TOKENS = {"i": 256, "ii": 2048}
# the streamed programs and their design points' block sizes at n=8
K2_BLOCK_ROWS = {"blur_chain": 4, "conv_pool": 4, "gradient_harris": 4,
                 "correlated_chain": 4, "unsharp": 4, "harris": 8}


def renamed(src: str, namespace: str) -> str:
    """A copy of the tree whose package lies in ``src`` (under
    build/compare_parent/) whose ``torch.library`` operators are registered
    under ``namespace`` instead of ``repro_torch``: one process registers an
    operator's name once, and both trees' wrappers run through their own
    operators.  Returns the copy's src directory."""
    dst = pathlib.Path(ROOT, "build", "compare_parent", namespace)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(pathlib.Path(src, "repro_torch"), dst / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for py in (dst / "src" / "repro_torch").rglob("*.py"):
        text = py.read_text()
        for old in ('Library("repro_torch"', "torch.ops.repro_torch.",
                    '"repro_torch::'):
            text = text.replace(old, old.replace("repro_torch", namespace))
        py.write_text(text)
    return str(dst / "src")


def load(src: str, namespace: str = "repro_torch") -> types.SimpleNamespace:
    """The ``repro_torch`` modules of the tree whose package lies in ``src``
    (its operators under ``namespace``, ``renamed``, where that differs)."""
    if namespace != "repro_torch":
        src = renamed(src, namespace)
    for name in [m for m in sys.modules
                 if m == "repro_torch" or m.startswith("repro_torch.")]:
        del sys.modules[name]
    sys.path.insert(0, os.path.abspath(src))
    try:
        from repro_torch import config
        from repro_torch.core import analysis  # noqa: F401 (imported lazily)
        from repro_torch.core import codegen, programs, sim
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import stencil_pipeline as sp
        from repro_torch.kernels import wkv6 as wk
        from repro_torch.models import lm
    finally:
        sys.path.pop(0)
    # the tree's modules, put back in sys.modules while it is measured, so
    # an import inside one of its functions finds its own tree's module
    mods = {m: mod for m, mod in sys.modules.items()
            if m == "repro_torch" or m.startswith("repro_torch.")}
    return types.SimpleNamespace(config=config, fa=fa, sp=sp, wk=wk, lm=lm,
                                 codegen=codegen, programs=programs, sim=sim,
                                 modules=mods)


def kernels(acts):
    """The kernels of a profile, without copies and fills."""
    return [(n, us) for n, us in acts
            if not re.search("memcpy|memset", n, re.I)]


def measure_k1(t, dev) -> dict:
    """K1 on the frame, cold and warm, f32 and bf16."""
    import torch

    import chip_smoke as cs
    out = {}
    g = torch.Generator(device=dev).manual_seed(0)
    w = torch.tensor([0.25, 0.5, 0.25], device=dev)
    for dt in (torch.float32, torch.bfloat16):
        x = torch.rand(cs.FRAME, generator=g, device=dev).to(dt)
        call = lambda: t.sp.stencil_pipeline(x, w, w, block_rows=2, halo=2)
        out[f"k1_{dt}"] = {
            "cold_ms": cs.time_cold_ms(call, 25),
            "warm_ms": cs.time_ms(call, 25)[0],
            "equal_plain": torch.equal(call(),
                                       t.sp.stencil_pipeline_plain(x, w, w))}
    return out


def measure_k2(t, dev, plains: dict) -> dict:
    """K2's gridded kernel on each streamed program at n=4096, float32;
    ``plains`` keeps each tree's plain outputs across its turns."""
    import torch

    import chip_smoke as cs
    out = {}
    ctors = {**t.programs.CHAIN_BENCHMARKS, **t.programs.BENCHMARKS}
    for name, br in K2_BLOCK_ROWS.items():
        p = ctors[name](cs.CHAIN_N, storage="bram")
        k = t.codegen.lower_program(p, block_rows=br)
        x = t.sim.make_inputs(p, seed=0)
        xs = {a: torch.as_tensor(x[a], dtype=torch.float32, device=dev)
              for a in k.inputs}
        sink = k.outputs[0]
        if (id(t), name) not in plains:
            plains[id(t), name] = k.plain(xs)[sink]
        out[f"k2_{name}"] = {
            "ms": cs.time_ms(lambda: k(xs), 25)[0],
            "equal_plain": torch.equal(k(xs)[sink], plains[id(t), name]),
            "launch_grid": list(k.launch_grid), "col_tile": k.col_tile,
            "smem_bytes": k.smem_bytes}
        del xs
    return out


def measure(t, dev) -> dict:
    import torch

    import chip_smoke as cs
    out = {}
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    # K4 on the CUDA cores at the reduced llama3-8b's shape
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (randn(2, 256, h, 16, dtype=dt).transpose(1, 2)
                   for h in (6, 2, 2))
        call = lambda: t.fa.flash_attention(q, k, v, causal=True)
        ms = cs.time_ms(call, 25)[0]
        acts, _ = cs.device_kernels(lambda: [call() for _ in range(10)])
        kern = kernels(acts)
        attn = [us for n, us in kern if "fa_kernel" in n]
        out[f"k4_cuda_cores_{dt}"] = {
            "wrapper_ms": ms, "kernels_per_call": len(kern) / 10,
            "kernel_ms": statistics.median(attn) / 1e3 if attn else None,
            "all_kernels_ms_per_call": sum(us for _, us in kern) / 10 / 1e3}
    # K4 f32 at gemma-7b's shape
    q, k, v = (randn(1, 1024, 16, 256).transpose(1, 2) for _ in range(3))
    call = lambda: t.fa.flash_attention(q, k, v, causal=True)
    out["k4_f32_hd256"] = {"route": t.fa.route(torch.float32, 256),
                           "ms": cs.time_ms(call, 10)[0]}
    # K5: the sequence form and the step as the layer calls it
    H, hd = 40, 64
    r, k, v = (randn(1, H, 1024, hd) for _ in range(3))
    w = torch.sigmoid(randn(1, H, 1024, hd)) * 0.5 + 0.45
    u = randn(H, hd) * 0.1
    call = lambda: t.wk.wkv6_state(r, k, v, w, u)
    kern = kernels(cs.device_kernels(call)[0])
    out["k5_sequence"] = {"ms": cs.time_ms(call, 25)[0],
                          "kernels_per_call": len(kern)}
    B, D = 4, H * hd
    s0 = randn(B, H, hd, hd)
    if "out" in inspect.signature(t.wk.wkv6_state).parameters:
        rb, kb, vb = (randn(B, 1, D, dtype=torch.bfloat16) for _ in range(3))
        wb = torch.sigmoid(randn(B, 1, D)) * 0.5 + 0.45
        heads = lambda x: x.view(B, 1, H, hd).transpose(1, 2)
        ob = torch.empty((B, 1, D), dtype=torch.bfloat16, device=dev)
        call = lambda: t.wk.wkv6_state(heads(rb), heads(kb), heads(vb),
                                       heads(wb), u, s0, out=heads(ob),
                                       s_out=s0)
        layout = "bf16 views, state in place"
    else:
        rs, ks, vs = (randn(B, H, 1, hd) for _ in range(3))
        ws = torch.sigmoid(randn(B, H, 1, hd)) * 0.5 + 0.45
        call = lambda: t.wk.wkv6_state(rs, ks, vs, ws, u, s0)
        layout = "f32 contiguous, new state"
    kern = kernels(cs.device_kernels(call)[0])
    out["k5_step"] = {"ms": cs.time_ms(call, 25)[0], "layout": layout,
                      "kernel_ms": kern[0][1] / 1e3 if kern else None}
    return out


def measure_k4(t, dev) -> dict:
    """K4's bf16 forward, causal, at PaliGemma's, llama3-8b's, Kimi-K2's
    and Whisper's shapes, on the tree's own route and blocks, beside sdpa
    (cuDNN's flash attention) on the same inputs."""
    import torch

    import chip_smoke as cs
    out = {}
    g = torch.Generator(device=dev).manual_seed(0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for key, (B, H, Hkv, S, hd) in {
            "bf16_paligemma_3b": (1, 8, 1, 1024, 256),
            "bf16_llama3_8b": (1, 32, 8, 4096, 128),
            "bf16_kimi_k2": (1, 64, 8, 2048, 128),
            "bf16_whisper_small": (1, 12, 12, 448, 64)}.items():
        q, k, v = (torch.randn((B, S, h, hd), generator=g, device=dev)
                   .to(torch.bfloat16).transpose(1, 2) for h in (H, Hkv, Hkv))
        call = lambda: t.fa.flash_attention(q, k, v, causal=True)
        ms = cs.time_ms(call, 20)[0]
        acts, _ = cs.device_kernels(lambda: [call() for _ in range(3)])
        per = {}
        for n, us in kernels(acts):
            name = cs.short_name(n)
            per[name] = per.get(name, 0.0) + us / 3 / 1e3
        (lq, lk, lv), gqa = cs.sdpa_args(q, k, v)
        lib = cs.time_ms(lambda: sdpa(lq, lk, lv, is_causal=True, **gqa),
                         20)[0]
        out[f"k4_{key}"] = {"ms": ms, "kernel_ms": per, "sdpa_ms": lib}
    return out


def measure_k4_bwd(t, dev) -> dict:
    """K4's backward at the train path's shape (bf16), in bf16 also at
    Kimi-K2's (1, 64, 2048, 128) over 8 kv heads, Whisper's (1, 12, 448,
    64), not causal, and PaliGemma's (1, 8, 1024, 256) over one kv head,
    causal; in f32 at llama3-8b's shape (1, 32, 2048, 128) over 8 kv heads,
    causal, at Whisper's and at PaliGemma's; and in both dtypes at hd 16
    (the reduced llama3-8b's (2, 6, 256, 16) over 2 kv heads, causal); each
    beside sdpa's backward and the plain version (its route's tiles) on
    the same inputs."""
    import torch

    import chip_smoke as cs
    out = {}
    g = torch.Generator(device=dev).manual_seed(0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for key, (dt, B, H, Hkv, S, hd, causal) in {
            "bf16_llama3_8b": (torch.bfloat16, 2, 32, 8, 2048, 128, True),
            "bf16_kimi_k2": (torch.bfloat16, 1, 64, 8, 2048, 128, True),
            "bf16_whisper_small": (torch.bfloat16, 1, 12, 12, 448, 64,
                                   False),
            "bf16_paligemma_3b": (torch.bfloat16, 1, 8, 1, 1024, 256, True),
            "f32_llama3_8b": (torch.float32, 1, 32, 8, 2048, 128, True),
            "f32_whisper_small": (torch.float32, 1, 12, 12, 448, 64, False),
            "f32_paligemma_3b": (torch.float32, 1, 8, 1, 1024, 256, True),
            "bf16_hd16": (torch.bfloat16, 2, 6, 2, 256, 16, True),
            "f32_hd16": (torch.float32, 2, 6, 2, 256, 16, True)}.items():
        q, k, v, dout = (torch.randn((B, S, h, hd), generator=g, device=dev)
                         .to(dt).transpose(1, 2) for h in (H, Hkv, Hkv, H))
        kind = t.fa.route(dt, hd)
        blocks = (t.fa.WGMMA_BLOCKS[hd][0] if kind == "wgmma" else
                  t.fa.TF32X3_BLOCKS[hd] if kind == "tf32x3" else
                  t.fa.CUDA_CORE_BLOCKS)
        o, lse = t.fa._run(q, k, v, causal, kind, *blocks, True)
        call = lambda: t.fa.flash_attention_bwd(q, k, v, o, lse, dout,
                                                causal=causal)
        ms = cs.time_ms(call, 10)[0]
        acts, _ = cs.device_kernels(lambda: [call() for _ in range(3)])
        per = {}
        for n, us in kernels(acts):
            name = cs.short_name(n)
            per[name] = per.get(name, 0.0) + us / 3 / 1e3
        (lq, lk, lv), gqa = cs.sdpa_args(q, k, v)
        xs = [x.detach().requires_grad_() for x in (lq, lk, lv)]
        lo = sdpa(*xs, is_causal=causal, **gqa)
        lib = cs.time_ms(lambda: torch.autograd.grad(lo, xs, dout,
                                                     retain_graph=True), 10)[0]
        tq, tk = t.fa.BWD_TILES[t.fa.bwd_route(dt, hd)][hd]
        plain = cs.time_ms(lambda: t.fa.flash_attention_bwd_plain(
            q, k, v, o, lse, dout, causal=causal, block_q=tq, block_k=tk),
            3)[0]
        out[f"k4_bwd_{key}"] = {"ms": ms, "kernel_ms": per, "sdpa_ms": lib,
                                "plain_ms": plain}
    return out


def measure_k5_bwd(t, dev, firsts: dict) -> dict:
    """K5's backward at each of K5_BWD_HDS on rwkv6-3b's width D = 2560
    (H = D / hd heads) at each of K5_BWD_TOKENS (B = 2): r, k, v and the
    output's cotangent bf16 views of (B, S, D) tensors, w the time mix's
    exp(-exp(x - 4)) on x ~ N(0, 1), on the tree's own route (a tree
    without ``bwd_route`` walks every token on the CUDA cores).  The
    call (CUDA events), each device kernel's time (torch.profiler) and
    whether the gradients equal bit for bit those of the first turn that
    ran the shape (``firsts``: the parent's, in the order parent, tree,
    tree, parent)."""
    import torch

    import chip_smoke as cs
    out = {}
    for hd in K5_BWD_HDS:
        for key, S in K5_BWD_TOKENS.items():
            B, H = 2, K5_BWD_D // hd
            g = torch.Generator(device=dev).manual_seed(21)

            def heads(x):
                return x.view(B, S, H, hd).transpose(1, 2)

            def randn(*shape):
                return torch.randn(shape, generator=g, device=dev)
            r, k, v, dout = (heads(randn(B, S, H * hd).to(torch.bfloat16))
                             for _ in range(4))
            w = heads(torch.exp(-torch.exp(randn(B, S, H * hd) - 4.0)))
            u = randn(H, hd) * 0.1

            def call():
                return t.wk.wkv6_bwd(r, k, v, w, u, None, dout)
            got = call()
            first = firsts.setdefault((hd, key), got)
            same = all(torch.equal(a, b) for a, b in zip(got, first))
            ms = cs.time_ms(call, 20)[0]
            acts, _ = cs.device_kernels(lambda: [call() for _ in range(3)])
            per = {}
            for n, us in kernels(acts):
                name = cs.short_name(n)
                per[name] = per.get(name, 0.0) + us / 3 / 1e3
            route = t.wk.bwd_route(hd) if hasattr(t.wk, "bwd_route") \
                else "walk"
            out[f"k5_bwd_hd{hd}_{key}"] = {
                "route": route, "shape": [B, H, S, hd], "ms": ms,
                "kernel_ms": per, "bitwise_first_turn": same}
            del got, r, k, v, w, dout
    return out


def host_calls(t, dev) -> dict:
    """Calls of tree ``t``'s wrappers at the smoke's shapes, by name: K4's
    forward on each route and its bf16 backward, K5's sequence form, its
    step on the layer's bf16 views with the state in place, and its
    backward (inputs from seed 0, the same for every tree)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)
    calls = {}
    for key, (dt, B, H, Hkv, S, hd) in {
            "k4_wgmma": (torch.bfloat16, 2, 32, 8, 2048, 128),
            "k4_tf32x3": (torch.float32, 1, 32, 8, 1024, 128),
            "k4_cuda_cores": (torch.float32, 2, 6, 2, 256, 16)}.items():
        q, k, v, dout = (randn(B, S, h, hd, dtype=dt).transpose(1, 2)
                         for h in (H, Hkv, Hkv, H))
        calls[key] = functools.partial(t.fa.flash_attention, q, k, v,
                                       causal=True)
        if key == "k4_wgmma":
            o, lse = t.fa._run(q, k, v, True, t.fa.route(dt, hd),
                               *t.fa.WGMMA_BLOCKS[hd][0], True)
            calls["k4_bwd_wgmma"] = functools.partial(
                t.fa.flash_attention_bwd, q, k, v, o, lse, dout, causal=True)
    H, hd = 40, 64
    r, k, v = (randn(1, H, 1024, hd) for _ in range(3))
    w = torch.sigmoid(randn(1, H, 1024, hd)) * 0.5 + 0.45
    u = randn(H, hd) * 0.1
    calls["k5_sequence"] = functools.partial(t.wk.wkv6_state, r, k, v, w, u)
    B, D = 4, H * hd
    s0 = randn(B, H, hd, hd)
    rb, kb, vb = (randn(B, 1, D, dtype=torch.bfloat16) for _ in range(3))
    wb = torch.sigmoid(randn(B, 1, D)) * 0.5 + 0.45
    heads = lambda x: x.view(B, 1, H, hd).transpose(1, 2)  # noqa: E731
    ob = torch.empty((B, 1, D), dtype=torch.bfloat16, device=dev)
    calls["k5_step"] = lambda: t.wk.wkv6_state(
        heads(rb), heads(kb), heads(vb), heads(wb), u, s0, out=heads(ob),
        s_out=s0)
    rd, kd, vd, dd = (randn(2, 40, 256, hd, dtype=torch.bfloat16)
                      for _ in range(4))
    wd = torch.sigmoid(randn(2, 40, 256, hd)) * 0.5 + 0.45
    calls["k5_bwd"] = functools.partial(t.wk.wkv6_bwd, rd, kd, vd, wd, u,
                                        None, dd)
    return calls


def measure_host(trees: dict, dev) -> dict:
    """Host ms a wrapper call (``host_calls``) of the parent and the tree,
    in pairs of windows of HOST_CALLS calls each, the two trees' windows
    adjacent (which goes first alternates), HOST_PAIRS pairs after each of
    HOST_GROUPS spin kernels that keep the card busy while the host
    enqueues, so that no call waits for the card.  Returns {wrapper:
    {"parent", "tree": median ms, "diff": the median of the pairs' tree -
    parent ms}}: adjacent windows share the host's state, so the paired
    difference is steadier than either median."""
    import torch

    import chip_smoke as cs
    calls = {name: host_calls(t, dev) for name, t in trees.items()}

    def window(fn):
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        return (time.perf_counter() - t0) / HOST_CALLS * 1e3
    out = {}
    for key in calls["parent"]:
        for name in trees:
            calls[name][key]()
        torch.cuda.synchronize()
        got = {"parent": [], "tree": []}
        for _ in range(HOST_GROUPS):
            torch.cuda._sleep(int(cs.SPIN_CYCLES_PER_MS * HOST_SPIN_MS))
            for j in range(HOST_PAIRS):
                for name in (("parent", "tree") if j % 2 == 0
                             else ("tree", "parent")):
                    got[name].append(window(calls[name][key]))
            torch.cuda.synchronize()
        out[key] = {"parent": statistics.median(got["parent"]),
                    "tree": statistics.median(got["tree"]),
                    "diff": statistics.median(
                        b - a for a, b in zip(got["parent"], got["tree"]))}
    return out


def graph_step(t, dev, model_cache: dict) -> dict:
    """The graphed rwkv6-3b decode step at batch 4 (weights from seed 0)."""
    import torch

    import chip_smoke as cs
    cfg = t.config.get_config("rwkv6_3b")
    with torch.inference_mode():
        model = model_cache.get(id(t))
        if model is None:
            model = model_cache[id(t)] = t.lm.LM.init(
                cfg, torch.Generator(device=dev).manual_seed(0), dev)
        cache = model.init_cache(4, STEPS + REPLAYS + 8)
        graph = t.lm.DecodeGraph(cfg, model, cache)
        tok = torch.ones((4, 1), dtype=torch.int32, device=dev)
        pos = [torch.full((4,), i, dtype=torch.int32, device=dev)
               for i in range(REPLAYS)]
        for p in pos[:3]:
            graph(cache, tok, p)
        acts, _ = cs.device_kernels(
            lambda: [graph(cache, tok, p) for p in pos[:STEPS]])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for p in pos:
            graph(cache, tok, p)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / REPLAYS * 1e3
        del graph, cache
    return {"activities_per_step": len(acts) / STEPS,
            "busy_ms_per_step": sum(us for _, us in acts) / STEPS / 1e3,
            "wall_ms_per_replay": ms}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="the parent tree's src directory")
    ap.add_argument("--tree", default=os.path.join(ROOT, "src"),
                    help="this tree's src directory")
    ap.add_argument("--only", choices=("k1", "k2", "k4", "k4_bwd", "k5_bwd",
                                       "host"),
                    help="measure only this kernel")
    args = ap.parse_args(argv)
    import subprocess

    import torch
    if not torch.cuda.is_available():
        print("compare_parent: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}")
    dev = torch.device("cuda")
    trees = {"parent": load(args.parent, "repro_torch_parent"),
             "tree": load(args.tree)}
    if args.only == "host":
        res = measure_host(trees, dev)
        for key, ms in res.items():
            print(f"host: {key}: parent {ms['parent'] * 1e3:.1f} us, tree "
                  f"{ms['tree'] * 1e3:.1f} us a call (medians); paired "
                  f"difference {ms['diff'] * 1e3:+.1f} us")
        print(json.dumps({"card": card, "host_ms": res}))
        return 0
    results = {"card": card, "parent": [], "tree": []}
    models, plains, firsts = {}, {}, {}
    for name in ("parent", "tree", "tree", "parent"):
        t = trees[name]
        sys.modules.update(t.modules)
        m = measure_k4(t, dev) if args.only == "k4" else \
            measure_k4_bwd(t, dev) if args.only == "k4_bwd" else \
            measure_k5_bwd(t, dev, firsts) if args.only == "k5_bwd" else \
            measure_k2(t, dev, plains) if args.only == "k2" else \
            measure_k1(t, dev)
        if args.only is None:
            m.update(measure(t, dev))
            m.update(measure_k4_bwd(t, dev))
            m.update(measure_k5_bwd(t, dev, firsts))
            m["graph_step"] = graph_step(t, dev, models)
        results[name].append(m)
        print(f"{name}: " + json.dumps(m))
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
