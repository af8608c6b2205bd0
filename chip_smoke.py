"""Drive the port's main paths on one NVIDIA card and hold every kernel on
them against its plain PyTorch version.

    python3 chip_smoke.py

Fifteen paths, each run with the launch counts set to 0 just before it and
read just after:

1. *chains*: ``hls.compile`` schedules each stencil chain of
   ``programs.CHAIN_BENCHMARKS`` at n=8 (the repo's practice: the ILPs are
   sized by the loop bounds); the design point's block size is lowered at
   n=4096 to the generated streamed CUDA kernel (K2, both bufferings; on
   the card a block walks a run of row tiles down a column tile, its
   producers carried as rings of rows) and launched; the hand-written
   fused stencil (K1) runs on a 4K UHD frame with the configuration the DSE
   sweep reads off the generated kernel; it is timed warm and with a cold
   L2 (``time_cold_ms``), and torch.profiler must see one device kernel
   per call.
2. *benchmarks*: the paper's five programs (``programs.BENCHMARKS``)
   compiled at the reference tests' sizes, the best point lowered with
   ``emit_cuda``, then the original program lowered at full width (n=4096,
   ``two_mm`` at m=4096) and launched: ``unsharp`` and ``harris`` through
   K2, ``dus``, ``optical_flow`` and ``two_mm`` through the whole-array
   kernel (K3).
3. *traced*: the tracing frontend's conv block, compiled at 8x8, then the
   same PyTorch function traced at 4098x4098 and launched through K3.
4. *serve*: rwkv6-3b at its full configuration (bf16, random weights from a
   seeded generator) served by ``repro_torch.launch.serve.main`` (batch 4,
   prompt 32, gen 16) and by a ``ContinuousBatcher`` of 4 slots answering
   8 requests; every decode step replays the step's CUDA graph
   (``lm.DecodeGraph``) and every layer's time mix runs the WKV6 step
   kernel (K5) in it, on bf16 views of the layer's activations with the
   state updated in place.  The same requests decoded eagerly must give
   the same ids; the step is timed eager, graph, graph, eager, and its
   device activities are counted beside the PR 16 step's.
5. *prefill*: llama3-8b at its full configuration (bf16, chunked
   attention) runs ``lm.forward`` on 4096 tokens; every layer's attention
   runs the tensor-core flash-attention kernel (K4, ``wgmma``), on views
   of the layer's activations with k and v at their 8 kv heads.
6. *reduced*: llama3-8b cut to its reduced configuration (hd 16) runs
   ``lm.forward`` on 2 x 256 tokens in f32 and in bf16, where every
   layer's attention runs the CUDA-core flash-attention kernel (K4 at the
   head dims the tensor-core kernels do not take) on the layer's GQA
   views, one device kernel a call.
7. *moe_serve*: DeepSeek-V2 at its published widths cut to 3 layers (the
   dense prefix layer + 2 MoE layers; MLA in each, 160 routed experts,
   top-6, 2 shared; bf16, random weights from a seeded generator) served
   by a ``ContinuousBatcher`` of 4 slots answering 8 requests, every step
   a replay of the step's CUDA graph; the same requests eagerly must give
   the same ids; the step is timed beside its weight-read bound, and its
   device busy time read off torch.profiler in the profiling child.  No
   TPU kernel is on this path (the reference's MLA and MoE are einsums and
   gathers), so the graph records no wrapper launch.  The card's MoE
   dispatch tables (expert ids, ranks, kept pairs, source tokens) at 1024
   tokens, with drops, must equal a host loop's from the same router
   logits.
8. *moe_prefill*: Kimi-K2 at its published widths cut to 2 layers (the
   prefix + 1 MoE layer of 384 experts; bf16, chunked attention) runs
   ``lm.forward`` on 2048 tokens; each layer's attention runs the
   tensor-core K4 at a GQA group of 8 (64 q heads over 8 kv heads), on
   views, k and v unrepeated.
9. *hybrid_prefill*: Jamba-1.5-Large at its published widths cut to one
   period of 8 layers (7 Mamba layers and the attention layer at 4; MoE of
   16 experts, top-2, on every other layer; bf16, chunked attention; the
   four MoE layers view one draw of expert weights, ``hybrid_model``) runs
   ``lm.forward`` on 2048 tokens; its attention layer runs the tensor-core
   K4 at a GQA group of 8, the Mamba layers their log-depth scans (timed).
10. *hybrid_serve*: the same model served by a ``ContinuousBatcher`` of 4
   slots answering 8 requests, every step a graph replay (Mamba states in
   the graph's cache; no kernel wrapper on the step), the same requests
   eagerly with the same ids, and a reused slot's Mamba state reset.
11. *encdec_serve*: Whisper-small at full depth and width served by
   ``serve.main`` (frames a static input of the graph; the step encodes
   them again, as the reference's does) graphed and eagerly, the same ids;
   its ``lm.forward`` on 448 decoder tokens with frames runs the
   tensor-core K4 at hd 64 over a ragged last block of q rows.
12. *vlm_prefill*: PaliGemma-3B at full depth and width runs ``lm.forward``
   on 256 patch embeddings + 768 tokens: the tensor-core K4 at hd 256, 8 q
   heads over one kv head; then ``serve.main`` decodes text, graphed.
13. *train*: (a) K4's backward kernels (bf16 at hd 64-256:
   ``csrc/flash_attention_bwd_wgmma.cu`` on the tensor cores; f32 at hd
   64-256: ``csrc/flash_attention_bwd_tf32x3.cu``, the tensor cores in
   3xTF32, hd 256 in kernels of its own; hd 16 and 32 in both dtypes:
   ``csrc/flash_attention_bwd.cu``, one ``mma.sync`` kernel a call;
   through ``flash_attention``'s autograd Function) against autograd of the
   plain version at llama3-8b's q (B, 32, 2048, 128) over 8 kv heads,
   causal, in bf16 (B 2) and f32 (B 1), at hd 64 not causal over 448 rows,
   hd 256 over one kv head and hd 16, each limit shown to reject the
   gradient of a call that lost a kv tile of the dK/dV kernel's, and each
   gradient bitwise the same in a second call; each timed beside sdpa's
   backward; (b) llama3-8b at its published widths cut to 4 of
   its 32 layers (bf16, chunked, remat "full") trained 8 steps on 2 x 2048
   tokens by ``launch.train.train``, the loop of ``python -m
   repro_torch.launch.train``: K4's forward twice a layer a step and its
   backward once, counted by the wrappers and, in the profiling child, by
   the profiler; the loss finite and falling; ms a step, tokens/s, the
   operations bound and peak memory; (c) the same model at 2 layers in f32
   on 1024 tokens: every gradient through K4 equals the dense path's; (d)
   the reduced llama3-8b under ``FaultTolerantLoop`` with a failure
   injected ends bitwise where an uninterrupted run does; the reduced
   rwkv6-3b's loss and every gradient through K5's kernels (f32) equal the
   same model's on the CPU within 2e-4; a loss with grad through K4 at a
   head dim or dtype no kernel takes raises.
14. *train_rwkv*: (a) K5's backward (``csrc/wkv6_bwd_tc.cu``, the
   windows route at every head dim) through ``wkv6_bwd`` against autograd
   of the per-token plain version on 2 x 256 tokens, in f32 and bf16
   views, with and without s0 and a final-state gradient: at rwkv6-3b's
   heads (hd 64) at decays 0.1, 1e-3, 1 and the model's, at its width cut
   into heads of 16, 32 and 128 (hd 128: a cluster of two CTAs) at 1e-3
   and the model's: each gradient within 2e-4 of its largest entry (bf16
   dr, dk, dv within 1e-2), each limit shown to reject the gradient with
   the first chunk's contribution lost and the one with one window's
   cross-window terms dropped (hd 128: and the one with one rank's
   partial sums lost), bitwise the same in a second call; (b) rwkv6-3b at its
   published widths cut to 4 of its 32 layers (bf16, remat "full") trained
   8 steps on 2 x 2048 tokens by ``launch.train.train``: K5's sequence form
   twice a layer a step and its backward (the windows route alone) once,
   counted by the wrappers and, in the profiling child, by the profiler;
   the loss finite and falling; ms a step, tokens/s, the operations bound,
   peak memory and K5's backward's share of the step; (c) the backward
   timed at each head dim on 2 x 256 and 2 x 2048 tokens of rwkv6-3b's
   width (hd 64 on 2 x 2048: the train shape) beside its bounds, its plain
   version, each launch's time, ptxas and its walk's blocks an SM.
15. *sharded*: the multi-device training path on a (1, 1) mesh over NCCL
   (one card; the group's rendezvous a ``FileStore`` in a temporary
   directory): llama3-8b at its published widths cut to 2 layers (bf16,
   chunked, remat "full") trained 3 steps on 2 x 2048 tokens by
   ``launch.train.train`` with ``mesh=`` (parameters and moments DTensors
   laid out by the rule tables, weights gathered to their model shards
   (the tensor-parallel step, over a model axis of one rank), the loss's
   sum and count and every gradient reduced over the mesh) and by the
   one-device
   path from the same weights and batches: losses, parameters and moments
   bitwise equal, and K4's forward and backward launched as often by
   both, by the wrappers here and, in the profiling child, by the
   profiler; the prefill step of ``steps.build(cfg, prefill shape, mesh)``
   bitwise ``lm.forward``; ``ag_matmul``, ``compressed_psum`` and
   ``pipelined_forward`` on card tensors equal to their plain results;
   the mesh's decode step (the cache in the blocks ``cache_specs`` gives,
   nothing of it gathered) over 4 steps bitwise ``lm.decode_step``,
   logits and cache.  Then rwkv6-3b, DeepSeek-V2, Jamba, Whisper and
   PaliGemma (every family's tensor-parallel step) at their published
   widths cut to 2 layers (DeepSeek-V2: its dense first layer and one MoE
   layer of 80 of its 160 routed experts, which fit one card's AdamW;
   Jamba: its period cut to 2 layers, a Mamba layer with an MoE of 2 of
   its 16 experts and the attention layer with an MLP, on 1 x 512 tokens;
   Whisper: 2 encoder layers too; Jamba, Whisper and PaliGemma with
   chunked attention; bf16, remat "full"), trained the same way
   one-device and on the (1, 1) mesh: losses, gradient norms, parameters
   and moments bitwise equal, K4's (Jamba's attention layer, Whisper's
   decoder, PaliGemma at hd 256) and K5's (rwkv6-3b) forward and
   backward launched as often by both and DeepSeek-V2's MLA launching
   neither; each model freed before the next.

K3 must take its redesigned forms: both of ``two_mm``'s reductions tiled
through shared memory, the traced conv block and ``optical_flow`` in 2
launches a call (``K3_LAUNCHES``; the earlier design launched one per
nest, ``K3_LAUNCHES_BEFORE``), which the profiler counts on the card.

Four models, at full width and depth 2 in f32, are held against
themselves (the *equivalence* path): the prefill's last-token logits
against the last of the decode steps' (DeepSeek-V2 with its capacity
factor raised so that the prefill drops no pair, and its MLA prefix layer
alone too); so are Jamba's Mamba layer alone (f32, 1024 tokens),
Whisper-small (f32, every step encoding the frames again) and PaliGemma's
chunked path against its dense one (f32).  K4 in f32 runs the 3xTF32
tensor-core kernel there, at hd 128 (llama3-8b) and hd 256 (gemma-7b); K5
runs its chunk-parallel sequence form in rwkv6-3b's prefill.  So is the
reduced f32 llama3-8b.  Then K4's three kernels and K5 are held against
their plain versions at those shapes (K4 on N(0, 1) inputs and on a peaky
draw whose outputs are O(1), each limit shown to reject a result with one
of the kernel's kv tiles dropped; K5's step on the serve layer's views,
its sequence form in three launches, at decays 0.1, 1e-3 and 1).

Every kernel is built from the sources in the checkout (one nvcc per
source, all at once, into ``build/``).

Lines it prints, in order: the card's name and power limit as nvidia-smi
gives them; each path's compile lines; the build; each path's launch
counts; K1's launch geometry per dtype; one line per check; the dry-run's
records; the total
seconds; one JSON line ``{"kernels": [...]}`` (per kernel: launches on its path, max abs error
against the plain version, times, bound); and last
``{"ok": true, "device": {...}}``.  Any failed build, launch or check
exits non-zero before the result lines.  Needs one card; exits non-zero
without one.
"""
from __future__ import annotations

import atexit
import collections
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))
# hermetic: the compile cache would otherwise persist under $HOME
os.environ["REPRO_HLS_CACHE"] = "0"

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
FP32_FLOP_PER_S = 67e12          # H100 SXM fp32 outside the tensor cores
# fp32 instructions a second: an FMA counts twice in the rate above, a
# separately rounded mul or add (K3's __fmul_rn, __fadd_rn) once
FP32_ISSUE_PER_S = FP32_FLOP_PER_S / 2
FRAME = (2160, 3840)             # 4K UHD: K1's image
CHAIN_N = 4096                   # programs at image size
CHECK_N = 16                     # float64 checks against sequential_exec
CONV_HW = CHAIN_N + 2            # the traced conv block's image
SPIN_CYCLES_PER_MS = 2_000_000   # above the H100's SM clock: spins long
FLUSH_BYTES = 256 << 20          # scratch written before a cold call: 5x L2
K1_PROFILED_CALLS = 5            # K1 calls per dtype, each profiled alone
K3_PROFILED_CALLS = 3            # K3 calls per program, each profiled alone
# compile sizes of the reference tests; harris and optical_flow take the
# stencil sweep's restricted search (the default search costs them ~2.5 min)
BENCH_COMPILE_N = {"unsharp": 8, "harris": 8, "dus": 8, "optical_flow": 6,
                   "two_mm": 6}
RESTRICTED = ("harris", "optical_flow")
CHECK_SIZE = {"two_mm": 8}
# K3's CUDA launches per call: the earlier design's one per nest, and this
# one's (runs of elementwise nests over one domain share a launch)
K3_LAUNCHES_BEFORE = {"dus": 4, "optical_flow": 9, "two_mm": 2,
                      "traced_conv": 11}
K3_LAUNCHES = {"dus": 4, "optical_flow": 2, "two_mm": 2, "traced_conv": 2}
K3_TILED = {"two_mm": ("pi", "ci")}   # reduction nests in the tiled form
K1_REPLACES = "src/repro/kernels/stencil_pipeline.py:42"
K2_REPLACES = "src/repro/core/codegen.py:475"
K3_REPLACES = "src/repro/core/codegen.py:637"
K4_REPLACES = "src/repro/kernels/flash_attention.py:22"
K5_REPLACES = "src/repro/kernels/wkv6.py:21"
BF16_FLOP_PER_S = 989e12         # H100 SXM dense bf16 tensor cores
TF32_FLOP_PER_S = 495e12         # H100 SXM dense TF32 tensor cores
PREFILL_S = 4096                 # llama3-8b prefill tokens (B=1)
EQUIV_S = 1024                   # prefill == decode check, depth 2, f32
EQUIV_ARCHS = ("llama3_8b", "gemma_7b", "rwkv6_3b")
# the MoE family at full width, depth cut (every other field as published):
# DeepSeek-V2 served (the dense prefix layer + 2 MoE layers), held prefill
# == decode at depth 2 in f32, its dispatch tables at MOE_DISPATCH_S tokens;
# Kimi-K2's prefill (the prefix + 1 MoE layer) through K4 at a GQA group of 8
MOE_SERVE_LAYERS = 3
MOE_EQUIV_LAYERS = 2
MOE_DISPATCH_S = 1024
MOE_PREFILL_LAYERS = 2
MOE_PREFILL_S = 2048
# the last families: Jamba at its published widths cut to one period
# (HYBRID_LAYERS; its four MoE layers view one draw of expert weights),
# its prefill on HYBRID_PREFILL_S tokens, its Mamba layer alone in f32 on
# HYBRID_EQUIV_S; Whisper-small's decoder on its text context
# (WHISPER_S); PaliGemma-3B on its 256 patches + VLM_TEXT_S tokens
HYBRID_LAYERS = 8
HYBRID_PREFILL_S = 2048
HYBRID_EQUIV_S = 1024
WHISPER_S = 448
VLM_TEXT_S = 768
# K4's limits against its plain version: both round the same fp32 sums
# once, so bf16 outputs differ by at most an ulp (2^-8 relative)
K4_TOL = {"bfloat16": dict(rtol=1e-2, atol=4e-3),
          "float32": dict(rtol=2e-5, atol=2e-5)}
K4_PEAK_Q = 4.0                  # q's scale in the peaky draw: scores' std 4
K4_DROPPED_TILE = 32             # the kv tile the limits must not miss
REDUCED_B, REDUCED_S = 2, 256    # the CUDA-core K4's path: reduced llama3-8b
K4_CUDA_CORE_PAIRS = ((16, 64), (32, 64), (64, 64))   # blocks timed
K4_PROFILED_CALLS = 5            # CUDA-core K4 calls, each profiled alone
# the shapes K4's entries time sdpa at: (dtype, config, reduced, B, S)
K4_SDPA_SHAPES = {
    "bfloat16/llama3_8b": ("bfloat16", "llama3_8b", False, 1, 4096),
    "float32/llama3_8b": ("float32", "llama3_8b", False, 1, 1024),
    "float32/gemma_7b": ("float32", "gemma_7b", False, 1, 1024),
    "float32/llama3_8b/reduced": ("float32", "llama3_8b", True, 2, 256),
    "bfloat16/llama3_8b/reduced": ("bfloat16", "llama3_8b", True, 2, 256),
    "bfloat16/kimi_k2_1t_a32b": ("bfloat16", "kimi_k2_1t_a32b", False, 1,
                                 MOE_PREFILL_S),
    "bfloat16/jamba_1_5_large_398b": ("bfloat16", "jamba_1_5_large_398b",
                                      False, 1, HYBRID_PREFILL_S),
    "bfloat16/whisper_small": ("bfloat16", "whisper_small", False, 1,
                               WHISPER_S),
    "bfloat16/paligemma_3b": ("bfloat16", "paligemma_3b", False, 1,
                              256 + VLM_TEXT_S)}
# the train path: llama3-8b at its published widths cut to TRAIN_LAYERS of
# 32 layers, bf16, chunked, TRAIN_STEPS steps on TRAIN_B x TRAIN_S tokens
# (ms per step: the median after TRAIN_WARMUP); TRAIN_PROFILED steps
# profiled in the profiling child; chunked == dense gradients at
# TRAIN_GRAD_LAYERS layers in f32 on 1 x TRAIN_GRAD_S tokens, each within
# TRAIN_GRAD_TOL of its largest entry; the reduced model's restart check
TRAIN_LAYERS = 4
TRAIN_B, TRAIN_S = 2, 2048
TRAIN_STEPS, TRAIN_WARMUP, TRAIN_PROFILED = 8, 2, 2
TRAIN_GRAD_LAYERS, TRAIN_GRAD_S = 2, 1024
TRAIN_GRAD_TOL = 1e-4
RESTART_STEPS, RESTART_EVERY, RESTART_FAIL_AT = 6, 2, 3
# K4's backward at llama3-8b's shape: bf16 at the train path's batch, f32
# at 1 (its path, the gradient check, runs 1 x TRAIN_GRAD_S)
K4_BWD_B = {"bfloat16": TRAIN_B, "float32": 1}
# the backward also held and timed, in both dtypes, at the other head dims
# of the tensor-core routes, (B, H, Hkv, S, hd, causal): Whisper-small's 448
# decoder rows, not causal, PaliGemma-3B's 1024 rows over one kv head, and
# a GQA group of 8 at hd 128 (Kimi-K2's q heads, Jamba-1.5-Large's too)
# over 2048 rows, whose bf16 dK/dV walks are wrapped over the SMs
K4_BWD_MORE = {"whisper_small": (1, 12, 12, WHISPER_S, 64, False),
               "paligemma_3b": (1, 8, 1, 1024, 256, True),
               "kimi_k2": (1, 64, 8, 2048, 128, True)}
# backward calls profiled in the profiling child, for each kernel's time
K4_BWD_PROFILED_CALLS = 3
# K4's backward against autograd of the plain version: fp32 sums in
# another order (f32); bf16 gradients rounded once from fp32, the kernel's
# D from the bf16 output (bf16: about an ulp, 2^-8 relative)
K4_BWD_TOL = {"bfloat16": dict(rtol=2e-2, atol=2e-2),
              "float32": dict(rtol=1e-4, atol=1e-4)}
# K4's device kernels by name: the forward kernels' and the backward's;
# each backward route's alone
K4_KERNEL = re.compile(r"\bfa_(wgmma_|wgmma_hd256_|wgmma_hd256_combine_|"
                       r"tf32x3_|tf32x3_hd256_|bwd_\w+_)?kernel")
# the kernels of K4's bf16 route that ptxas must report without a spill:
# the forward's at hd 256 and every backward kernel (D; dK/dV, its sum and
# dQ at hd 64 and 128; hd 256's)
K4_NO_SPILL_KERNELS = (
    "fa_wgmma_hd256_kernel", "fa_wgmma_hd256_combine_kernel",
    "fa_bwd_wgmma_dot_kernel",
    *(f"fa_bwd_wgmma_{k}_kernel<{hd}>" for k in ("dkdv", "sum", "dq")
      for hd in (64, 128)),
    "fa_bwd_wgmma_hd256_dkdv_kernel", "fa_bwd_wgmma_hd256_dq_kernel",
    "fa_bwd_wgmma_hd256_sum_kernel")
# the tensor-core forward's kernels (bf16; at hd 256 the pieces and their
# combine)
K4_WGMMA_FWD = re.compile(r"\bfa_wgmma_(hd256_(combine_)?)?kernel")
K4_BWD_WGMMA = re.compile(r"\bfa_bwd_wgmma_\w+_kernel")
K4_BWD_KERNELS = {"wgmma": K4_BWD_WGMMA,
                  "tf32x3": re.compile(r"\bfa_bwd_tf32x3_\w+_kernel"),
                  "mma": re.compile(r"\bfa_bwd_mma_kernel")}
# what the JAX package differentiates instead (no Pallas backward)
K4_BWD_JAX = ("src/repro/models/layers.py:80 _sdpa and :105 "
              "_sdpa_chunked")
K5_SEQ = 1024                    # K5's long form: rwkv6-3b's (1, 40, S, 64)
K5_CHUNKS = (32, 64, 128)        # the sequence form's chunk lengths timed
# path 14, train_rwkv: rwkv6-3b at its published widths cut to
# TRAIN_RWKV_LAYERS of 32 layers, bf16, remat "full", trained TRAIN_STEPS
# steps on TRAIN_B x TRAIN_S tokens (as path 13(b)); K5's backward held
# against autograd of the per-token plain version at rwkv6-3b's heads on
# K5_BWD_B x K5_BWD_S tokens, at the decays K5_BWD_DECAYS ("model": the
# time mix's exp(-exp(x - 4))), with and without s0 and a final-state
# gradient; each gradient within K5_BWD_TOL of its largest entry (f32; in
# bf16, dr, dk, dv are rounded once from fp32)
TRAIN_RWKV_LAYERS = 4
RWKV_GRAD_S = 256                # path 13(d): the reduced rwkv6-3b's tokens
K5_BWD_B, K5_BWD_S = 2, 256
K5_BWD_DECAYS = (0.1, 1e-3, 1.0, "model")
K5_BWD_TOL = {"float32": {n: 2e-4 for n in ("dr", "dk", "dv", "dw", "du",
                                            "ds0")},
              "bfloat16": {"dr": 1e-2, "dk": 1e-2, "dv": 1e-2, "dw": 2e-4,
                           "du": 2e-4, "ds0": 2e-4}}
K5_BWD_FLOPS = 14                # per state entry and token (K5_BWD_REPLACES)
K5_BWD_REPLACES = ("none: the JAX package differentiates "
                   "src/repro/models/layers.py:527 _wkv_chunk with jax.grad")
K5_BWD_KERNEL = re.compile(r"\bwkv6_bwd_\w+_kernel")
# each backward route's kernels (kernels/wkv6.py bwd_route): the walk is
# the cluster kernel at hd 128
K5_BWD_ROUTE_KERNEL = {
    "windows": re.compile(
        r"\bwkv6_bwd_tc_(local|scan|walk|cluster|du)_kernel")}
K5_BWD_MORE_HDS = (16, 32, 128)  # rwkv6-3b's D cut into heads of these
K5_BWD_MORE_DECAYS = (1e-3, "model")
# the window whose cross-window terms a rejected gradient drops (tokens
# [16 x, 16 x + 16) of the first chunk), and at hd 128 the rank whose
# partial sums one loses
K5_BWD_DROPPED_WINDOW = 1
K5_BWD_LOST_RANK = 1
# the backward's timed shapes: tokens a row (2 rows) of rwkv6-3b's width,
# "i" its checks', "ii" the train path's
K5_BWD_TOKENS = {"i": K5_BWD_S, "ii": TRAIN_S}
K5_FWD_KERNEL = re.compile(r"\bwkv6_(chunk_\w+|step)_kernel")
# path 15, sharded: llama3-8b at its published widths cut to SHARDED_LAYERS
# layers (bf16, chunked), SHARDED_STEPS steps (the cosine warm-up's rate is
# 0 at step 0) on TRAIN_B x TRAIN_S tokens, one-device and on a (1, 1) mesh
SHARDED_LAYERS, SHARDED_STEPS = 2, 3
# path 15's other families, at their published widths cut to SHARDED_LAYERS
# by ``cut_config`` (DeepSeek-V2: its dense first layer and one MoE layer;
# Whisper: as many encoder layers; Jamba: its period cut from 8 layers,
# the attention last), trained as above
SHARDED_FAMILIES = ("rwkv6_3b", "deepseek_v2_236b", "jamba_1_5_large_398b",
                    "whisper_small", "paligemma_3b")
# the routed experts a published MoE keeps when ``cut_config`` cuts it
# (CUT_EXPERTS_DEFAULT where it is not listed): with all 160 of
# DeepSeek-V2's the one-device step ran out of the card's memory in AdamW,
# whose f32 temporaries of the (160, 5120, 1536) expert tensors (5 GB each)
# came on top of 43 GB of bf16 parameters, gradients and moments (tokens
# do not move that peak); Jamba's experts are 0.6 B parameters each, and 2
# of its 16 (top-2) keep its 2 layers at 3.5 B
CUT_EXPERTS = {"jamba_1_5_large_398b": 2}
CUT_EXPERTS_DEFAULT = 80
# (batch, tokens) where TRAIN_B x TRAIN_S would not fit: Jamba's scan
# keeps (B, S, 16384 channels, 16) f32 tensors a step of its log2(256)
# steps under autograd, ~8.6 GB a 256-token chunk a row
SHARDED_TOKENS = {"jamba_1_5_large_398b": (1, 512)}
# the steps path 15 runs the mesh's decode step for, against
# lm.decode_step, row r starting at position SHARDED_DECODE_POS + r
SHARDED_DECODE_STEPS, SHARDED_DECODE_POS = 4, 1021
# the dry-run phase: cells traced on FakeTensors over fake groups, each list
# in a child process of its own, the children started together ("sharded":
# path 15's step on its (1, 1) mesh; "sharded_2x2": the same step on the
# (2, 2) mesh of tools/multi_card.py's four cards; "arch:shape:mesh": a
# production cell of ``repro_torch.launch.dryrun``); a train cell at full
# depth takes ~76 s on the card's machine (rwkv6-3b's ~170 s), a prefill or
# decode cell ~17 s; the children start with the script and trace beside
# the builds and the card's paths, one CPU core each (started before path
# 13, they kept the script waiting 44-133 s after path 15 on the H100's
# 8-core host)
DRYRUN_CELLS = (("sharded", "sharded_2x2", "llama3_8b:decode_32k:single",
                 "llama3_8b:decode_32k:multi"),
                ("llama3_8b:train_4k:single",),
                ("llama3_8b:train_4k:multi",),
                ("llama3_8b:prefill_32k:single",
                 "llama3_8b:prefill_32k:multi"),
                ("rwkv6_3b:train_4k:single",),
                ("llama3_8b:train_4k:single:tuned",))
DRYRUN_TIMEOUT_S = 600
# the reference's records of the tensor-parallel cells (llama3-8b as
# published): TFLOP and temp_size GB a device from
# ``repro.launch.dryrun.dryrun_cell`` on a CPU host with the meshes' axes
# made ``AxisType.Auto`` (JAX 0.9.0's ``jax.make_mesh`` makes them
# ``Explicit``, on which the reference's ``constrain`` raises), held here
# as constants: this script imports no JAX.  The port's flops must land
# within DRYRUN_FLOPS_TOL of them; its temp_size must fall at least
# DRYRUN_TEMP_CUT x from the ZeRO-3 step's (the port before its model axis
# split the work; ROADMAP's table), the reference's being XLA's buffer
# assignment, which a graph's live bytes are not
DRYRUN_REFERENCE = {"llama3_8b:train_4k:single": (270.2, 54.5),
                    "llama3_8b:prefill_32k:single": (134.0, 37.4),
                    "llama3_8b:train_4k:multi": (135.1, 27.3),
                    "llama3_8b:prefill_32k:multi": (67.0, 18.8)}
DRYRUN_ZERO3_TEMP_GB = {"llama3_8b:train_4k:single": 243.0,
                        "llama3_8b:prefill_32k:single": 567.9,
                        "llama3_8b:train_4k:multi": 129.0,
                        "llama3_8b:prefill_32k:multi": 291.4}
DRYRUN_FLOPS_TOL, DRYRUN_TEMP_CUT = 0.05, 4.0
# the tensor-parallel cells' temp_size GB a device when the steps gathered
# every weight before the first layer (this script's dry-run phase then):
# gathering each layer's at the layer may not raise it
DRYRUN_TP_TEMP_GB = {"llama3_8b:train_4k:single": 34.6,
                     "llama3_8b:prefill_32k:single": 38.5,
                     "llama3_8b:train_4k:multi": 18.0,
                     "llama3_8b:prefill_32k:multi": 20.0}
# the tuned cells (``config.tune``: "fsdp", remat "dots"): temp_size GB a
# device at most (the step that gathered the whole model held 155.3), and
# the all-gathered bytes alive at the peak within ``dryrun.gather_bound``
DRYRUN_TUNED_TEMP_GB = {"llama3_8b:train_4k:single:tuned": 40.0}
# llama3-8b's decode_32k on (16, 16): GB all-gathered a device by the step
# that gathered each cache tensor to its rows, whole along the sequence
# (the dry-run's figure for that step); the decode step that attends over
# its own block of the positions must gather DRYRUN_DECODE_CUT x less or
# better
DRYRUN_DECODE_GATHER_GB = {"llama3_8b:decode_32k:single": 51.390}
DRYRUN_DECODE_CUT = 10.0
DRYRUN_BUDGET_S = 120            # the phase's share of the smoke's time
PROFILE_STEPS = 5                # decode steps under the profiler
PROFILE_MARGIN_S = 0.05          # idle card at each end of a profile
# device activities of a graphed rwkv6-3b step before this slice (PR 16's
# chip_smoke run), and how many the WKV step's views and in-place state
# take away at least: 4 copies of r, k, v, w and the state's copy back, in
# each of the 32 layers
PR16_GRAPH_ACTIVITIES = 2158
GRAPH_ACTIVITIES_CUT = 5 * 32
SERVE = dict(batch=4, prompt=32, gen=16, slots=4, requests=8, max_new=16)
# cuBLAS / cuBLASLt GEMM kernels by name, for the prefill paths' device split
GEMM_KERNELS = r"gemm|nvjet|xmma|cutlass"
CODEGEN_SRC = "src/repro_torch/core/codegen.py"
BLUR_W = [1 / 3, 1 / 2, 1 / 3]   # blur_chain's taps
GAUSS = [[0.0625, 0.125, 0.0625], [0.125, 0.25, 0.125],
         [0.0625, 0.125, 0.0625]]  # conv_pool's 3x3 taps


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, reps: int, warmup: int = 2) -> tuple[float, float]:
    """(device ms, host ms) per call of ``fn()``.  Device time is the median
    over ``reps`` calls of a CUDA event pair around each call, after
    warm-up.  A spin kernel queued first, twice as long as it takes the host
    to enqueue every call, keeps the card busy meanwhile, so the calls run
    back to back and the events see device time, not the wrapper's host
    overhead (reported apart as host ms: the enqueue time of one call).
    If the spin has ended before the host enqueued the last call (the host
    ran slower than it measured), the calls are timed again behind a spin
    four times as long, up to 2 s."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    host_ms = (time.perf_counter() - t0) / 3 * 1e3
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    spin_ms = min(2 * reps * host_ms + 1, 2000)
    while True:
        torch.cuda._sleep(int(SPIN_CYCLES_PER_MS * spin_ms))
        spun = torch.cuda.Event()
        spun.record()
        for a, b in ev:
            a.record()
            fn()
            b.record()
        covered = not spun.query()
        torch.cuda.synchronize()
        if covered or spin_ms >= 2000:
            break
        spin_ms = min(4 * spin_ms, 2000)
    return statistics.median(a.elapsed_time(b) for a, b in ev), host_ms


def time_cold_ms(fn, reps: int, read_back: bool = True) -> float:
    """Device ms per call of ``fn()`` with the L2 cold, as a caller handing
    in a fresh image finds it: the median over ``reps`` calls, each
    preceded, outside its CUDA event pair, by a write of a
    ``FLUSH_BYTES`` scratch buffer (five times the H100's 50 MB L2) and a
    read of it, so that the L2 holds only clean scratch lines and the call
    neither finds its inputs there nor pays for writing the scratch back
    (``read_back=False`` leaves it to pay).  A spin kernel queued first
    keeps the card busy while the host enqueues, as in ``time_ms``."""
    import torch
    scratch = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32,
                          device="cuda")

    def flush():
        scratch.fill_(1.0)
        if read_back:
            scratch.sum()
    fn()
    flush()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        flush()
        fn()
    host_ms = (time.perf_counter() - t0) / 3 * 1e3
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(int(SPIN_CYCLES_PER_MS * min(2 * reps * host_ms + 1,
                                                   2000)))
    for a, b in ev:
        flush()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)


def bound(nbytes: int, flops: int) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def stage_flops(p) -> int:
    """Arithmetic the program needs: each nest's ops over its own domain
    (what the function computes, not the halo rows a tile recomputes)."""
    from repro_torch.core.ir import ArithOp, Loop
    total = 0
    for nest in p.body:
        trips, cur = 1, nest
        while isinstance(cur, Loop):
            trips *= cur.trip
            inner = [x for x in cur.body if isinstance(x, Loop)]
            ops = cur.body
            cur = inner[0] if inner else None
        total += trips * sum(isinstance(op, ArithOp) for op in ops)
    return total


def kernel_bytes(p, k) -> int:
    """Each array the kernel must read, read once, plus each output written
    once, in the kernel's dtype."""
    esz = 4 if k.dtype == "float32" else 8
    return esz * sum(math.prod(p.arrays[a].shape)
                     for a in (*k.inputs, *k.outputs))


def ptxas_summary(log: str) -> list:
    """Per kernel of an nvcc -Xptxas -v log: its template arguments (where
    it has them, else its name), registers and bytes spilled."""
    out, name, spill = [], "", ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            m = re.search(r"I((?:Li\d+E|\w)+?)EEv", ln) \
                or re.search(r"I(f|13__nv_bfloat16)Ev", ln)
            grp = m.group(1) if m else ""
            typ = ["f32"] if grp.startswith("f") else \
                ["bf16"] if "bfloat16" in grp else []
            name = ",".join(typ + re.findall(r"L[ib](\d+)", grp))
            plain = re.search(r"'_Z(\d+)(\w+)'", ln)
            if not m and plain:
                name = plain.group(2)[:int(plain.group(1))]
        elif "spill stores" in ln:
            spill = ln.split(",")[1].strip().split(" ")[0]
        elif "Used" in ln and "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            out.append(f"<{name}> {regs} registers, {spill} B spilled"
                       if name else f"{regs} registers, {spill} B spilled")
    return out


def ptxas_kernels(log: str, kernel: str = r"fa_\w+?_kernel") -> list:
    """Per kernel of an nvcc -Xptxas -v log whose name matches ``kernel``,
    by its name and template arguments (f32 / bf16, then the ints):
    registers and bytes spilled."""
    out, name, spill = [], "", ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            # the mangled name: ``kernel`` after its length (a kernel in an
            # anonymous namespace has the source file's path and hashes in
            # front, which may end in digits and "fa_" themselves)
            m = next((c for c in re.finditer(r"(?=(\d+)(" + kernel + "))",
                                             ln)
                      if int(c.group(1)) == len(c.group(2))), None)
            t = m and re.match(r"I(f|13__nv_bfloat16)?((?:Li\d+E)*)E",
                               ln[m.end(2):])
            args = [] if not t or not (t.group(1) or t.group(2)) else (
                ([{"f": "f32"}.get(t.group(1), "bf16")] if t.group(1) else [])
                + re.findall(r"Li(\d+)E", t.group(2)))
            name = "?" if not m else m.group(2) + (
                "<" + ",".join(args) + ">" if args else "")
        elif "spill stores" in ln:
            spill = ln.split(",")[1].strip().split(" ")[0]
        elif "Used" in ln and "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            out.append(f"{name}: {regs} registers, {spill} B spilled")
    return out


def build_log(name: str, source: str) -> str:
    """The nvcc/ptxas log of library ``name``: this process's build's, or
    the one ``_cuda.build_many`` left beside a library built before."""
    from repro_torch import _cuda
    if name in _cuda.BUILD_LOG:
        return _cuda.BUILD_LOG[name][1]
    log = _cuda.library_path(name, source).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def zero_model_counts() -> None:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.models import lm
    fa.LAUNCHES.clear()
    wk.LAUNCHES.clear()
    lm.GRAPH_LAUNCHES.clear()


def model_counts() -> dict:
    """Launches by the kernel wrappers ("k4/...", "k5/...") and by CUDA
    graph replays ("graph/<module>/<key>")."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.models import lm
    return {**{f"k4/{k}": v for k, v in fa.LAUNCHES.items()},
            **{f"k5/{k}": v for k, v in wk.LAUNCHES.items()},
            **{f"graph/{k}": v for k, v in lm.GRAPH_LAUNCHES.items()}}


def device_kernels(fn) -> tuple[list, float]:
    """(device activities [(name, us)], host wall ms) of ``fn()`` under
    torch.profiler; an empty list when the profiler sees no device.

    The card idles ``PROFILE_MARGIN_S`` inside the profiling window before
    ``fn()`` and after it has finished.  The profiler drops device
    activities whose timestamps, mapped to the host's clock, fall outside
    the window, and a kernel's record may reach it after the synchronize
    that waited for the kernel; with no margins it once saw only one of
    ``two_mm``'s two 5.4 ms kernels on the H100."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        time.sleep(PROFILE_MARGIN_S)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        time.sleep(PROFILE_MARGIN_S)
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if getattr(e, "device_type", None) == cuda], wall


def sdpa_args(q, k, v) -> tuple:
    """sdpa's inputs and options for K4's q, k, v: in bf16 as they are,
    kv at its kv heads with ``enable_gqa``; in f32 (sdpa's f32 kernels take
    no GQA) kv repeated to the q heads, all contiguous."""
    import torch
    if q.dtype == torch.bfloat16:
        return (q, k, v), {"enable_gqa": True}
    H = q.shape[1]
    return tuple(x.repeat_interleave(H // x.shape[1], dim=1).contiguous()
                 for x in (q, k, v)), {}


def sdpa_inputs(dev, dtype, cfg, B: int, S: int) -> tuple:
    """``sdpa_args`` on random views of (B, S, heads, hd) tensors of
    ``cfg``'s heads: what ``k4_entry`` times sdpa on, at its shapes."""
    import torch
    q, k, v = (torch.randn((B, S, h, cfg.hd), device=dev).transpose(1, 2)
               .to(dtype) for h in (cfg.n_heads, cfg.n_kv_heads,
                                    cfg.n_kv_heads))
    return sdpa_args(q, k, v)


def profile_main(dev=None) -> int:
    """``chip_smoke.py --profile``: the device's own view of the kernels the
    smoke reads off torch.profiler, in a process that has run nothing else
    (late in a long process the profiler drops records): each K3
    program's calls at full size (``k3_profiles``); the graphed
    decode step of the moe_serve path's DeepSeek-V2 (``moe_step_profile``)
    and of the hybrid_serve path's Jamba (``graph_step_profile``); the
    train path's step (``train_step_profile``), the train_rwkv path's
    (``train_rwkv_step_profile``) and K5's backward at its shape
    (``k5_bwd_profile``); the sharded path's one-device and (1, 1) mesh
    steps (``sharded_step_profile``); K1 on the frame
    at the DSE's configuration, one call a profile, f32 and bf16; the
    CUDA-core K4 at the reduced path's GQA views, one call a profile, f32
    and bf16; one call of K5's sequence form; the kernels sdpa runs at each
    K4 entry's shape, and its backward at the train path's.  Prints one
    JSON line."""
    import torch

    from repro_torch.config import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import stencil_pipeline as sp
    from repro_torch.kernels import wkv6 as wk

    dev = torch.device("cuda") if dev is None else dev
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"k1": {}, "k3": k3_profiles(dev), "k4": {}, "sdpa": {},
           "moe_step": moe_step_profile(dev),
           "train_step": train_step_profile(dev),
           "train_rwkv_step": train_rwkv_step_profile(dev),
           "k5_bwd": k5_bwd_profile(dev)}
    cfg = hybrid_config()
    out["hybrid_step"] = graph_step_profile(cfg, hybrid_model(cfg, dev)[0],
                                            dev)
    w3 = torch.tensor([0.25, 0.5, 0.25], device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.rand(FRAME, device=dev).to(dtype)
        sp.stencil_pipeline(x, w3, w3, block_rows=2, halo=2)
        out["k1"][str(dtype).removeprefix("torch.")] = [
            [[short_name(n_), us] for n_, us in kernel_names(device_kernels(
                lambda: sp.stencil_pipeline(x, w3, w3, block_rows=2,
                                            halo=2))[0])]
            for _ in range(K1_PROFILED_CALLS)]
    small = get_config("llama3_8b", reduced=True)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn((REDUCED_B, REDUCED_S, h, small.hd),
                               device=dev).transpose(1, 2).to(dtype)
                   for h in (small.n_heads, small.n_kv_heads,
                             small.n_kv_heads))
        fa.flash_attention(q, k, v, causal=True)
        calls = [kernel_names(device_kernels(
            lambda: fa.flash_attention(q, k, v, causal=True))[0])
            for _ in range(K4_PROFILED_CALLS)]
        out["k4"][str(dtype).removeprefix("torch.")] = [
            [[short_name(n_), us] for n_, us in c] for c in calls]
    cfg = get_config("rwkv6_3b")
    H, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    r, k, v = (torch.randn((1, H, K5_SEQ, hd), device=dev) for _ in range(3))
    w = torch.sigmoid(torch.randn((1, H, K5_SEQ, hd), device=dev)) * 0.5 \
        + 0.45
    u = torch.randn((H, hd), device=dev) * 0.1
    wk.wkv6_state(r, k, v, w, u)
    out["k5"] = [[short_name(n_), us] for n_, us in kernel_names(
        device_kernels(lambda: wk.wkv6_state(r, k, v, w, u))[0])]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for key, (dt, arch, reduced, B, S) in K4_SDPA_SHAPES.items():
        xs, opt = sdpa_inputs(dev, getattr(torch, dt),
                              get_config(arch, reduced=reduced), B, S)
        sdpa(*xs, is_causal=True, **opt)
        out["sdpa"][key] = sorted({short_name(n_) for n_, _ in
                                   kernel_names(device_kernels(
                                       lambda: sdpa(*xs, is_causal=True,
                                                    **opt))[0])})
    # the kernels of sdpa's backward at K4's backward's timed shape
    out["sdpa_bwd"] = {}
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype).removeprefix("torch.")
        xs, opt = sdpa_inputs(dev, dtype, get_config("llama3_8b"),
                              K4_BWD_B[dt], TRAIN_S)
        xs = [x.detach().requires_grad_() for x in xs]
        o = sdpa(*xs, is_causal=True, **opt)
        g = torch.randn_like(o)

        def bwd():
            torch.autograd.grad(o, xs, g, retain_graph=True)
        bwd()
        out["sdpa_bwd"][dt] = sorted(
            {short_name(n_) for n_, _ in kernel_names(device_kernels(bwd)[0])})
    out["k4_bwd"] = k4_bwd_profiles(dev)
    out["sharded_step"] = sharded_step_profile(dev)
    print(json.dumps(out))
    return 0


def k4_bwd_shapes() -> dict:
    """The backward's cases by key, (B, H, Hkv, S, hd, causal): "<dtype>"
    at llama3-8b's shape (``K4_BWD_B``), "<dtype>/<arch>" at
    ``K4_BWD_MORE``'s and "<dtype>/reduced" at the reduced llama3-8b's hd 16
    (the mma route)."""
    out = {}
    for dt in ("bfloat16", "float32"):
        out[dt] = (K4_BWD_B[dt], 32, 8, TRAIN_S, 128, True)
        out.update({f"{dt}/{a}": s_ for a, s_ in K4_BWD_MORE.items()})
        out[f"{dt}/reduced"] = (REDUCED_B, 6, 2, REDUCED_S, 16, True)
    return out


def k4_forward_blocks(kind: str, hd: int) -> tuple:
    """The (block_q, block_k) K4's forward kernel ``kind`` takes by
    default."""
    from repro_torch.kernels import flash_attention as fa
    return (fa.WGMMA_BLOCKS[hd][0] if kind == "wgmma" else
            fa.TF32X3_BLOCKS[hd] if kind == "tf32x3" else fa.CUDA_CORE_BLOCKS)


def k4_bwd_profiles(dev) -> dict:
    """{key of ``k4_bwd_shapes``: [[[kernel, us], ...] per call]}: the device
    kernels of ``K4_BWD_PROFILED_CALLS`` calls of the backward, each
    profiled alone; and under "sdpa/<key>" (but for llama3-8b's shapes,
    which "sdpa_bwd" holds) the kernels of sdpa's backward there."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    out = {}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for key, (B, H, Hkv, S, hd, causal) in k4_bwd_shapes().items():
        dtype = getattr(torch, key.split("/")[0])
        q, k, v, dout = (torch.randn((B, S, h, hd), device=dev)
                         .to(dtype).transpose(1, 2) for h in (H, Hkv, Hkv, H))
        kind = fa.route(dtype, hd)
        out_, lse = fa._run(q, k, v, causal, kind,
                            *k4_forward_blocks(kind, hd), True)

        def call():
            fa.flash_attention_bwd(q, k, v, out_, lse, dout, causal=causal)
        call()
        out[key] = [[[short_name(n_), us] for n_, us in
                     kernel_names(device_kernels(call)[0])]
                    for _ in range(K4_BWD_PROFILED_CALLS)]
        if "/" not in key:
            continue
        (lq, lk, lv), gqa = sdpa_args(q, k, v)
        xs = [x.detach().requires_grad_() for x in (lq, lk, lv)]
        o = sdpa(*xs, is_causal=causal, **gqa)

        def bwd():
            torch.autograd.grad(o, xs, dout, retain_graph=True)
        bwd()
        out["sdpa/" + key] = sorted(
            {short_name(n_) for n_, _ in kernel_names(device_kernels(bwd)[0])})
    return out


def k3_profiles(dev) -> dict:
    """{program: [[[kernel, us], ...] per call]}: the device kernels of
    ``K3_PROFILED_CALLS`` calls of each whole-array program the smoke runs
    through K3 (``K3_LAUNCHES``), at its full size on ``sim.make_inputs``'
    data, each call profiled alone (no copies or fills)."""
    import torch

    from repro_torch.core import codegen, frontend, programs, sim

    out = {}
    for name in K3_LAUNCHES:
        p = (frontend.conv_block_program(CONV_HW, CONV_HW).program
             if name == "traced_conv"
             else programs.BENCHMARKS[name](CHAIN_N, storage="bram"))
        k = codegen.lower_program(p)
        x = sim.make_inputs(p, seed=0)
        xs = {a: torch.as_tensor(x[a], dtype=torch.float32, device=dev)
              for a in k.inputs}
        k(xs)
        out[name] = [[[short_name(n_), us] for n_, us in kernel_names(
            device_kernels(lambda: k(xs))[0])]
            for _ in range(K3_PROFILED_CALLS)]
        del xs, x
    return out


def profiles() -> dict:
    """``profile_main``'s result, from a child process run to its end."""
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--profile"], capture_output=True, text=True,
                       timeout=600)
    if r.returncode != 0:
        fail(f"the profiling child exited {r.returncode}: "
             f"{r.stderr[-2000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def serve_requests(vocab: int) -> tuple:
    """The batchers' requests: (prompts of 8-32 tokens, their lengths, the
    cache length they need)."""
    import numpy as np
    rng = np.random.default_rng(1)
    lens = rng.integers(8, 33, SERVE["requests"])
    prompts = [rng.integers(2, vocab, n) for n in lens]
    return prompts, lens, int(lens.max()) + SERVE["max_new"] + 1


def run_batcher(cfg, model, prompts, max_len: int, graphed: bool, dev,
                what: str, n_slots: int = SERVE["slots"]) -> tuple:
    """(ids by request, batcher, seconds of its run): a
    ``ContinuousBatcher`` of ``n_slots`` slots answering ``prompts``
    (``SERVE["max_new"]`` tokens each), every step a replay of the step's
    CUDA graph (``lm.DecodeGraph``) or, not ``graphed``, the eager step.
    Fails unless every request completes."""
    import torch

    from repro_torch.models import lm
    from repro_torch.runtime.serving import ContinuousBatcher, Request

    with torch.inference_mode():
        b = ContinuousBatcher(
            None, lambda n: model.init_cache(n, max_len),
            n_slots=n_slots, eos=1, max_len=max_len, device=dev)
        b.decode_fn = lm.DecodeGraph(cfg, model, b.cache) if graphed \
            else (lambda c, t, p: model.decode_step(
                c, {"token": t, "pos": p}))
        for i, pr in enumerate(prompts):
            b.submit(Request(rid=i, prompt=pr, max_new=SERVE["max_new"]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b.run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    if len(b.completed) != len(prompts) or \
            not all(r.done for r in b.completed):
        fail(f"{what} batcher ({'graph' if graphed else 'eager'}) completed "
             f"{len(b.completed)} of {len(prompts)} requests")
    return {r.rid: r.output for r in b.completed}, b, secs


def step_times(cfg, model, prompts, max_len: int, ids: dict, dev,
               what: str) -> dict:
    """ms per batcher step, eager and graphed, timed eager, graph, graph,
    eager; every run must give the main run's ``ids``."""
    times = {"eager": [], "graph": []}
    for mode in ("eager", "graph", "graph", "eager"):
        got, bm, sec = run_batcher(cfg, model, prompts, max_len,
                                   mode == "graph", dev, what)
        if got != ids:
            fail(f"{what} batcher ({mode}): ids differ from the graphed "
                 f"main run's: {got} vs {ids}")
        times[mode].append(sec / bm.steps * 1e3)
    return times


def step_weight_bytes(model, slots: int) -> int:
    """The bytes a decode step of ``slots`` rows reads at least: every
    parameter but the embedding (views of one tensor counted at every use)
    and the slots' embedding rows."""
    weights = sum(p.numel() * p.element_size()
                  for name, p in model.named_parameters() if name != "embed")
    return weights + slots * model.cfg.d_model * model.embed.element_size()


def serve_path(dev) -> dict:
    """The serve path: ``serve.main`` and a ``ContinuousBatcher`` on
    rwkv6-3b, every decode step a replay of the step's CUDA graph
    (``lm.DecodeGraph``); K5 in every layer of every step.  Then the same
    requests decoded eagerly must give the same ids, and the step is timed
    eager, graph, graph, eager."""
    import numpy as np
    import torch

    from repro_torch.config import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm

    cfg = get_config("rwkv6_3b")
    argv = ["--arch", "rwkv6_3b", "--device", dev.type, "--batch",
            str(SERVE["batch"]), "--prompt-len", str(SERVE["prompt"]),
            "--gen", str(SERVE["gen"])]
    with torch.inference_mode():
        model = lm.LM.init(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    prompts, lens, max_len = serve_requests(cfg.vocab)

    # ---- the main path: graphed serve.main and batcher, counted ----------
    zero_model_counts()
    t0 = time.perf_counter()
    gen = serve.main(argv)
    main_s = time.perf_counter() - t0
    ids, b, _ = run_batcher(cfg, model, prompts, max_len, True, dev, "serve")
    n = model_counts()
    print("serve path launches: " + json.dumps(n, sort_keys=True))
    if gen.shape != (SERVE["batch"], SERVE["gen"]) or \
            not ((gen >= 0) & (gen < cfg.vocab)).all():
        fail(f"serve.main returned ids of shape {gen.shape} outside "
             f"[0, {cfg.vocab})")
    if b.decode_fn.launches_per_replay != {"wkv6/step": cfg.n_layers}:
        fail(f"the decode graph recorded {b.decode_fn.launches_per_replay} "
             f"at capture, expected {cfg.n_layers} K5 step launches")
    replays = SERVE["prompt"] + SERVE["gen"] + b.steps
    # two graphs (serve.main's, the batcher's), each warmed up by eager
    # steps through the wrapper before its capture
    warm = 2 * b.decode_fn.warmup
    want = {"k5/step": cfg.n_layers * warm,
            "graph/wkv6/step": cfg.n_layers * replays}
    if n != want:
        fail(f"serve path launches {n}, expected {want} ({cfg.n_layers} "
             f"layers x ({replays} replayed + {warm} warm-up) steps)")
    launches = n["k5/step"] + n["graph/wkv6/step"]
    print(f"check: K5 launched {launches} times = {cfg.n_layers} layers x "
          f"{replays + warm} decode steps ({replays} graph replays x "
          f"{cfg.n_layers} launches recorded at capture + {warm} eager "
          "warm-up steps); every request completed")

    # ---- the eager step gives the same ids; step times in turns ----------
    eager_gen = serve.main(argv + ["--eager"])
    if not np.array_equal(eager_gen, gen):
        fail(f"serve.main: the graphed ids {gen.tolist()} differ from the "
             f"eager ids {eager_gen.tolist()}")
    times = step_times(cfg, model, prompts, max_len, ids, dev, "serve")
    print(f"check: every token id of serve.main (batch {SERVE['batch']}, "
          f"{SERVE['gen']} tokens) and of all {len(prompts)} batcher "
          "requests is the same eager and graphed")
    new = sum(len(v) for v in ids.values())
    weights = step_weight_bytes(model, SERVE["slots"])
    step_ms = statistics.median(times["graph"])
    eager_ms = statistics.median(times["eager"])

    # where a step's time goes: device activities under the profiler
    nb = SERVE["slots"]
    busy = {}
    with torch.inference_mode():
        cache = model.init_cache(nb, PROFILE_STEPS)
        tok = torch.ones((nb, 1), dtype=torch.int32, device=dev)
        poss = [torch.full((nb,), t, dtype=torch.int32, device=dev)
                for t in range(PROFILE_STEPS)]
        graph = lm.DecodeGraph(cfg, model, cache)
        for mode in ("graph", "eager"):
            def steps_fn():
                for p_ in poss:
                    if mode == "graph":
                        graph(cache, tok, p_)
                    else:
                        model.decode_step(cache, {"token": tok, "pos": p_})
            steps_fn()
            acts, wall = device_kernels(steps_fn)
            if not acts:
                fail(f"serve ({mode}): the profiler saw no device activity")
            k5 = [us for name, us in acts if "wkv6" in name]
            if mode == "graph" and len(k5) != cfg.n_layers * PROFILE_STEPS:
                fail(f"serve: the profiler saw {len(k5)} WKV6 kernels in "
                     f"{PROFILE_STEPS} graph replays, expected "
                     f"{cfg.n_layers} a step")
            busy[mode] = sum(us for _, us in acts) / 1e3 / PROFILE_STEPS
            ref_ms = step_ms if mode == "graph" else eager_ms
            per_step = len(acts) / PROFILE_STEPS
            if mode == "graph":
                activities = per_step
                if per_step > PR16_GRAPH_ACTIVITIES - GRAPH_ACTIVITIES_CUT:
                    fail(f"serve: {per_step:.0f} device activities per "
                         f"graphed step, PR 16's step had "
                         f"{PR16_GRAPH_ACTIVITIES}; the layer's copies "
                         f"around K5 should take {GRAPH_ACTIVITIES_CUT} "
                         "or more away")
            print(f"serve: per {mode} decode step (batch {nb}, profiled "
                  f"over {PROFILE_STEPS} steps): "
                  f"{per_step:.0f} device activities"
                  + (f" (PR 16's graphed step: {PR16_GRAPH_ACTIVITIES})"
                     if mode == "graph" else "") + ", "
                  f"{len(k5) / PROFILE_STEPS:.0f} of them WKV6 kernels "
                  f"({sum(k5) / 1e3 / PROFILE_STEPS:.3f} ms); device busy "
                  f"{busy[mode]:.3f} ms of the batcher's {ref_ms:.3f} ms "
                  f"step: idle share {1 - busy[mode] / ref_ms:.3f} "
                  f"(profiled wall {wall / PROFILE_STEPS:.3f} ms per step)")
    print(f"serve: serve.main batch {SERVE['batch']} prompt "
          f"{SERVE['prompt']} gen {SERVE['gen']} in {main_s:.2f} s; "
          f"batcher {len(ids)}/{len(prompts)} requests completed "
          f"(prompts {lens.min()}-{lens.max()}, max_new "
          f"{SERVE['max_new']}) in {b.steps} steps: graphed step "
          f"{step_ms:.3f} ms ({', '.join(f'{t:.3f}' for t in times['graph'])}"
          f"), eager step {eager_ms:.3f} ms ("
          f"{', '.join(f'{t:.3f}' for t in times['eager'])}; timed eager, "
          f"graph, graph, eager), {new / (step_ms * b.steps / 1e3):.1f} "
          f"tokens/s graphed; idle share {1 - busy['graph'] / step_ms:.3f} "
          f"graphed, {1 - busy['eager'] / eager_ms:.3f} eager "
          f"(weight-read bound {weights / HBM_BYTES_PER_S * 1e3:.3f} ms "
          f"for {weights} B per step)")
    return {"launches": launches, "steps": replays + warm,
            "batcher_steps": b.steps, "ms_per_step": step_ms,
            "eager_ms_per_step": eager_ms, "weight_bytes": weights,
            "device_busy_ms": busy["graph"],
            "graph_activities": activities}


def k4_prefill(cfg, S: int, what: str, dev, model=None,
               extra=None) -> dict:
    """``lm.forward`` of ``cfg`` (bf16, chunked attention; ``model``, or
    random weights from seed 0 on the card) on 1 x S tokens and the
    batch's ``extra`` inputs (Whisper's frames, PaliGemma's patches),
    counted: the tensor-core K4 once an attention layer, handed q at its
    heads and k, v at the kv heads as views of the layer's (B, S, heads,
    hd) activations (``_repeat_kv`` never repeats), the logits of the S
    text tokens finite; then timed (median of 3) and profiled once, the
    device time split into K4, the GEMMs and the rest.  Prints the path's
    lines under ``what``."""
    import numpy as np
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layers, lm

    seen, repeats, lengths = [], [], []
    k4, repeat_kv = layers.flash_attention, layers._repeat_kv

    def k4_spy(q, k, v, **kw):
        seen.append((q.shape[1], k.shape[1],
                     all(t.transpose(1, 2).is_contiguous()
                         for t in (q, k, v))))
        lengths.append((q.shape[2], k.shape[2]))
        return k4(q, k, v, **kw)

    def repeat_spy(t, n_rep):
        if n_rep > 1:
            repeats.append(n_rep)
        return repeat_kv(t, n_rep)
    n_attn = sum(mix == "attn" for mix, _ in lm.layer_specs(cfg))
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        if model is None:
            model = lm.LM.init(
                cfg, torch.Generator(device=dev).manual_seed(0), dev)
        n_params = sum(p.numel() for p in model.parameters())
        tokens = torch.as_tensor(np.random.default_rng(2).integers(
            0, cfg.vocab, (1, S)), dtype=torch.int32, device=dev)
        batch = {"tokens": tokens, **(extra or {})}
        layers.flash_attention, layers._repeat_kv = k4_spy, repeat_spy
        try:
            zero_model_counts()
            logits = lm.forward(cfg, model, batch)
            torch.cuda.synchronize()
            n = model_counts()
        finally:
            layers.flash_attention, layers._repeat_kv = k4, repeat_kv
        print(f"{what} path launches: " + json.dumps(n, sort_keys=True))
        # kernels a call at the positions attention runs over (PaliGemma:
        # the patches and the text)
        per_call = fa.fwd_launches(torch.bfloat16, cfg.hd, 1, cfg.n_heads,
                                   cfg.n_kv_heads, *lengths[0])
        if n != {"k4/wgmma/bfloat16": n_attn * per_call}:
            fail(f"{what} launches {n}, expected {n_attn} x {per_call} "
                 f"tensor-core K4 kernels per forward ({per_call} a call, "
                 "one call an attention layer)")
        want = [(cfg.n_heads, cfg.n_kv_heads, True)] * n_attn
        if repeats or seen != want:
            fail(f"{what}: K4 got (q heads, kv heads, views) {set(seen)} "
                 f"and _repeat_kv repeated {len(repeats)} times; expected "
                 f"{want[0]}, no repeat")
        print(f"check: {what}: each of the {n_attn} attention layers handed "
              f"K4 q at {cfg.n_heads} heads and k, v at {cfg.n_kv_heads} (a "
              f"GQA group of {cfg.n_heads // cfg.n_kv_heads}) as views of "
              "its (B, S, heads, hd) activations; _repeat_kv repeated 0 "
              "times")
        if tuple(logits.shape) != (1, S, cfg.vocab) or \
                not torch.isfinite(logits).all():
            fail(f"{what} logits of shape {tuple(logits.shape)} are not "
                 "finite")
        del logits
        reps = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lm.forward(cfg, model, batch)
            torch.cuda.synchronize()
            reps.append((time.perf_counter() - t0) * 1e3)
        acts, wall = device_kernels(lambda: lm.forward(cfg, model, batch))
    fwd_ms = statistics.median(reps)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{what}: {cfg.name} full width, {cfg.n_layers} layers, bf16 "
          f"({n_params} parameters): forward on 1x{S} tokens {fwd_ms:.1f} "
          f"ms (median of 3: {', '.join(f'{t:.1f}' for t in reps)}); "
          f"logits finite; {n['k4/wgmma/bfloat16']} K4 kernels per "
          f"forward ({n_attn} calls x {per_call}); peak memory "
          f"{peak:.1f} GiB")
    split = {}
    if acts:
        busy = sum(us for _, us in acts) / 1e3
        k4_ms = sum(us for name, us in acts if K4_WGMMA_FWD.search(name)) \
            / 1e3
        gemm_ms = sum(us for name, us in acts if not K4_WGMMA_FWD.search(
            name) and re.search(GEMM_KERNELS, name, re.I)) / 1e3
        split = {"busy_ms": busy, "k4_ms": k4_ms, "gemm_ms": gemm_ms,
                 "activities": len(acts), "wall_ms": wall}
        print(f"{what}: profiled forward: {len(acts)} device activities, "
              f"device busy {busy:.1f} ms of {wall:.1f} ms wall; K4 "
              f"{k4_ms:.2f} ms ({k4_ms / busy:.3f} of busy), GEMMs "
              f"{gemm_ms:.1f} ms, the rest {busy - k4_ms - gemm_ms:.1f} ms")
        print(f"{what}: forward {fwd_ms:.1f} ms on 1x{S} tokens, K4's "
              f"kernels {k4_ms:.3f} ms of its device time "
              f"({k4_ms / busy:.2%} of busy, {k4_ms / fwd_ms:.2%} of the "
              f"forward's ms)")
    else:
        print(f"{what}: the profiler saw no device activity: device time "
              "by kernel not measured")
    return {"launches": n["k4/wgmma/bfloat16"], "forward_ms": fwd_ms,
            "kernels_per_call": per_call,
            "cfg": cfg, "peak_gib": peak, **split}


def prefill_path(dev) -> dict:
    """The prefill path: llama3-8b's ``lm.forward`` on 4096 tokens; K4 in
    every layer."""
    from repro_torch.config import get_config

    cfg = dataclasses.replace(get_config("llama3_8b"), attn_impl="chunked")
    return k4_prefill(cfg, PREFILL_S, "prefill", dev)


def equivalence(dev) -> dict:
    """prefill == decode, last token, full width, depth 2, f32: llama3-8b
    and gemma-7b (K4 f32 on the tf32x3 kernel, hd 128 and 256) and rwkv6-3b
    (K5's sequence form in the prefill, its step in the decode).  Returns
    each model's launch counts, zeroed just before it."""
    import numpy as np
    import torch

    from repro_torch.config import get_config
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.models import lm

    counts = {}
    for arch in EQUIV_ARCHS:
        cfg = dataclasses.replace(get_config(arch), n_layers=2,
                                  dtype="float32", attn_impl="chunked")
        zero_model_counts()
        with torch.inference_mode():
            model = lm.LM.init(
                cfg, torch.Generator(device=dev).manual_seed(3), dev)
            tokens = torch.as_tensor(np.random.default_rng(4).integers(
                0, cfg.vocab, (1, EQUIV_S)), dtype=torch.int32,
                device=dev)
            full = lm.forward(cfg, model, {"tokens": tokens})
            cache = model.init_cache(1, EQUIV_S)
            pos = torch.zeros((1,), dtype=torch.int32, device=dev)
            for t in range(EQUIV_S):
                logits, cache = model.decode_step(
                    cache, {"token": tokens[:, t:t + 1], "pos": pos + t})
        torch.cuda.synchronize()
        n = counts[arch] = model_counts()
        print(f"equivalence launches ({arch}): "
              + json.dumps(n, sort_keys=True))
        want = ({"k5/sequence": wk.SEQUENCE_LAUNCHES * cfg.n_layers,
                 "k5/step": cfg.n_layers * EQUIV_S}
                if cfg.family == "ssm" else
                {"k4/tf32x3/float32": cfg.n_layers})
        if n != want:
            fail(f"{arch}: launches {n}, expected {want}")
        try:
            torch.testing.assert_close(logits[:, 0], full[:, -1],
                                       rtol=2e-3, atol=2e-3)
        except AssertionError as e:
            fail(f"{arch}: prefill and decode disagree on the last "
                 f"token: {e}")
        err = (logits[:, 0] - full[:, -1]).abs().max().item()
        hd = cfg.rwkv_head_dim if cfg.family == "ssm" else cfg.hd
        print(f"check: {arch} full width (hd {hd}), depth 2, f32: prefill "
              f"== decode on the last of {EQUIV_S} tokens (max |diff| "
              f"{err:.3g}, rtol/atol 2e-3)")
        del model, full, cache
        torch.cuda.empty_cache()
    return counts


def reduced_path(dev) -> dict:
    """The CUDA-core K4's path: reduced llama3-8b (2 layers, 6 heads, 2 kv
    heads, hd 16) runs ``lm.forward`` on REDUCED_B x REDUCED_S tokens in f32
    and in bf16, every layer's attention on the CUDA-core kernel; the f32
    prefill's last-token logits against the last decode step's."""
    import numpy as np
    import torch

    from repro_torch.config import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import lm

    launches = {}
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(get_config("llama3_8b", reduced=True),
                                  dtype=dtype, attn_impl="chunked")
        if fa.route(getattr(torch, dtype), cfg.hd) != "cuda_cores":
            fail(f"reduced llama3-8b {dtype} at hd {cfg.hd} does not take "
                 "the CUDA-core K4")
        with torch.inference_mode():
            model = lm.LM.init(
                cfg, torch.Generator(device=dev).manual_seed(6), dev)
            tokens = torch.as_tensor(np.random.default_rng(7).integers(
                0, cfg.vocab, (REDUCED_B, REDUCED_S)), dtype=torch.int32,
                device=dev)
            zero_model_counts()
            full = lm.forward(cfg, model, {"tokens": tokens})
            torch.cuda.synchronize()
            n = model_counts()
            key = f"k4/cuda_cores/{dtype}"
            print(f"reduced path launches ({dtype}): "
                  + json.dumps(n, sort_keys=True))
            if n != {key: cfg.n_layers}:
                fail(f"reduced llama3-8b {dtype}: launches {n}, expected "
                     f"{cfg.n_layers} CUDA-core K4 launches per forward")
            launches[key] = n[key]
            if tuple(full.shape) != (REDUCED_B, REDUCED_S, cfg.vocab) or \
                    not torch.isfinite(full).all():
                fail(f"reduced llama3-8b {dtype}: logits of shape "
                     f"{tuple(full.shape)} are not finite")
            print(f"check: reduced llama3-8b {dtype}: logits of shape "
                  f"{tuple(full.shape)} finite; {n[key]} CUDA-core K4 "
                  "launches per forward")
            if dtype != "float32":
                continue
            cache = model.init_cache(REDUCED_B, REDUCED_S)
            pos = torch.zeros((REDUCED_B,), dtype=torch.int32, device=dev)
            for t in range(REDUCED_S):
                logits, cache = model.decode_step(
                    cache, {"token": tokens[:, t:t + 1], "pos": pos + t})
        try:
            torch.testing.assert_close(logits[:, 0], full[:, -1],
                                       rtol=2e-3, atol=2e-3)
        except AssertionError as e:
            fail(f"reduced llama3-8b f32: prefill and decode disagree on "
                 f"the last token: {e}")
        err = (logits[:, 0] - full[:, -1]).abs().max().item()
        print(f"check: reduced llama3-8b f32: prefill (CUDA-core K4) == "
              f"decode on the last of {REDUCED_S} tokens (max |diff| "
              f"{err:.3g}, rtol/atol 2e-3)")
    return {"launches": launches,
            "cfg": get_config("llama3_8b", reduced=True)}


def moe_config(arch: str, n_layers: int, **kw):
    """``arch`` at its published configuration, cut to ``n_layers``."""
    from repro_torch.config import get_config
    return dataclasses.replace(get_config(arch), n_layers=n_layers, **kw)


def moe_step_profile(dev) -> dict:
    """The moe_serve path's graphed decode step (DeepSeek-V2, full width,
    ``MOE_SERVE_LAYERS`` layers, ``SERVE["slots"]`` slots over a cache of
    the batcher's length) under torch.profiler: device busy ms, activities
    and profiled wall ms per step, over ``PROFILE_STEPS`` replays, and the
    device ms per step of the kernels that take the most."""
    import torch

    from repro_torch.models import lm

    cfg = moe_config("deepseek_v2_236b", MOE_SERVE_LAYERS)
    with torch.inference_mode():
        model = lm.LM.init(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    return graph_step_profile(cfg, model, dev)


def graph_step_profile(cfg, model, dev) -> dict:
    """The graphed decode step of ``model`` (``SERVE["slots"]`` slots over a
    cache of the batcher's length) under torch.profiler: device busy ms,
    activities and profiled wall ms per step, over ``PROFILE_STEPS``
    replays, and the device ms per step of the kernels that take the
    most.  Frees the model."""
    import torch

    from repro_torch.models import lm

    nb = SERVE["slots"]
    with torch.inference_mode():
        cache = model.init_cache(nb, serve_requests(cfg.vocab)[2])
        graph = lm.DecodeGraph(cfg, model, cache)
        tok = torch.ones((nb, 1), dtype=torch.int32, device=dev)
        poss = [torch.full((nb,), t, dtype=torch.int32, device=dev)
                for t in range(PROFILE_STEPS)]

        def steps():
            for p_ in poss:
                graph(cache, tok, p_)
        steps()
        acts, wall = device_kernels(steps)
    del graph, cache, model
    torch.cuda.empty_cache()
    by_kernel = collections.Counter()
    for name, us in acts:
        by_kernel[short_name(name)[:60]] += us / 1e3 / PROFILE_STEPS
    return {"busy_ms": sum(us for _, us in acts) / 1e3 / PROFILE_STEPS,
            "activities": len(acts) / PROFILE_STEPS,
            "wall_ms": wall / PROFILE_STEPS,
            "top_ms": by_kernel.most_common(6)}


def dispatch_oracle(logits, K: int, C: int) -> dict:
    """The MoE's dispatch tables computed on the host by a loop: each
    token's K experts of highest router logit (the softmax keeps their
    order; ties to the lower id), then each (t, k) in (t, k) order takes
    the next of its expert's C slots, or is dropped once they are taken."""
    import numpy as np
    G, Tg, E = logits.shape
    gidx = np.argsort(-logits, axis=-1, kind="stable")[..., :K]
    posc = np.zeros((G, Tg, K), np.int64)
    src = np.zeros((G, E * C), np.int64)
    vld = np.zeros((G, E * C), bool)
    for g in range(G):
        count = np.zeros(E, np.int64)
        for t in range(Tg):
            for k in range(K):
                e = gidx[g, t, k]
                posc[g, t, k] = count[e]
                if count[e] < C:
                    src[g, e * C + count[e]] = t
                    vld[g, e * C + count[e]] = True
                count[e] += 1
    return {"gidx": gidx, "posc": posc, "keep": posc < C, "src": src,
            "vld": vld}


def moe_serve_path(dev, prof: dict) -> dict:
    """The moe_serve path: DeepSeek-V2 at full width cut to
    ``MOE_SERVE_LAYERS`` layers (MLA in each, the dense prefix layer's MLP,
    then the capacity-routed MoE), bf16: a ``ContinuousBatcher`` of 4
    slots answers 8 requests, every step a replay of the step's CUDA graph;
    the same requests eagerly must give the same ids, and the step is
    timed eager, graph, graph, eager.  No TPU kernel is on this path, so
    the graph records no wrapper launch.  Then the card's dispatch tables
    of the first MoE layer at ``MOE_DISPATCH_S`` tokens, with drops, are
    held against ``dispatch_oracle``."""
    import numpy as np
    import torch

    from repro_torch.models import layers, lm

    cfg = moe_config("deepseek_v2_236b", MOE_SERVE_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.inference_mode():
        model = lm.LM.init(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    specs = lm.layer_specs(cfg)
    if specs != [("mla", "mlp")] + [("mla", "moe")] * (MOE_SERVE_LAYERS - 1):
        fail(f"moe_serve: DeepSeek-V2's layers {specs}")
    prompts, lens, max_len = serve_requests(cfg.vocab)

    # ---- the main path: the graphed batcher, counted ----------------------
    zero_model_counts()
    ids, b, _ = run_batcher(cfg, model, prompts, max_len, True, dev,
                            "moe_serve")
    n = model_counts()
    print("moe_serve path launches: " + json.dumps(n, sort_keys=True))
    if n or b.decode_fn.launches_per_replay:
        fail(f"moe_serve: the path launched {n} and its graph recorded "
             f"{b.decode_fn.launches_per_replay}; no kernel wrapper is on "
             "it")
    if b.decode_fn.replays != b.steps:
        fail(f"moe_serve: {b.decode_fn.replays} graph replays for "
             f"{b.steps} batcher steps")
    print(f"check: moe_serve: all {len(prompts)} requests completed in "
          f"{b.steps} steps, each a replay of the decode graph; the graph "
          "recorded 0 kernel-wrapper launches")
    times = step_times(cfg, model, prompts, max_len, ids, dev, "moe_serve")
    print(f"check: moe_serve: every token id of all {len(prompts)} requests "
          "is the same eager and graphed")
    new = sum(len(v) for v in ids.values())
    weights = step_weight_bytes(model, SERVE["slots"])
    bound_ms = weights / HBM_BYTES_PER_S * 1e3
    step_ms = statistics.median(times["graph"])
    eager_ms = statistics.median(times["eager"])
    busy = prof["moe_step"]["busy_ms"]
    print(f"moe_serve: DeepSeek-V2 full width, {cfg.n_layers} layers, bf16 "
          f"({sum(p.numel() for p in model.parameters())} parameters, "
          f"built in {init_s:.1f} s): batcher {len(ids)}/{len(prompts)} "
          f"requests (prompts {lens.min()}-{lens.max()}, max_new "
          f"{SERVE['max_new']}) in {b.steps} steps: graphed step "
          f"{step_ms:.3f} ms ({', '.join(f'{t:.3f}' for t in times['graph'])}"
          f"), eager step {eager_ms:.3f} ms ("
          f"{', '.join(f'{t:.3f}' for t in times['eager'])}; timed eager, "
          f"graph, graph, eager), {new / (step_ms * b.steps / 1e3):.1f} "
          f"tokens/s graphed; weight-read bound {bound_ms:.3f} ms for "
          f"{weights} B per step (graphed step / bound "
          f"{step_ms / bound_ms:.3f}); device busy {busy:.3f} ms of the "
          f"graphed step over {prof['moe_step']['activities']:.0f} "
          f"activities (profiled in a fresh child, wall "
          f"{prof['moe_step']['wall_ms']:.3f} ms a step): idle share "
          f"{1 - busy / step_ms:.3f}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; device ms "
          "a step by kernel: "
          + "; ".join(f"{n_} {ms:.3f}" for n_, ms in
                      prof["moe_step"]["top_ms"]))

    # ---- the dispatch tables on the card against the host's loop ----------
    blk = model.blocks[1]["ffn"]
    g = torch.Generator(device=dev).manual_seed(8)
    with torch.inference_mode():
        x = torch.randn((1, MOE_DISPATCH_S, cfg.d_model), generator=g,
                        device=dev).to(torch.bfloat16)
        r = layers.moe_route(cfg, blk, layers.rms_norm(x, blk["norm"],
                                                       cfg.norm_eps))
        torch.cuda.synchronize()
    C = r["C"]
    want = dispatch_oracle(r["logits"].cpu().numpy(), cfg.moe.top_k, C)
    for key in ("gidx", "posc", "keep", "src", "vld"):
        got = (r[key] != 0 if key == "vld" else r[key]).cpu().numpy()
        if not np.array_equal(got, want[key]):
            bad = int((got != want[key]).sum())
            fail(f"moe dispatch: '{key}' on the card differs from the host "
                 f"loop's in {bad} entries")
    dropped = int((~want["keep"]).sum())
    if dropped == 0:
        fail(f"moe dispatch: no pair dropped at {MOE_DISPATCH_S} tokens, C "
             f"{C}: the check must see drops")
    load = np.bincount(want["gidx"].ravel(), minlength=cfg.moe.n_experts)
    print(f"check: moe dispatch: DeepSeek-V2's first MoE layer at full "
          f"width on {MOE_DISPATCH_S} tokens (C {C} slots an expert, "
          f"{cfg.moe.n_experts} experts, top-{cfg.moe.top_k}): expert ids, "
          f"ranks, kept pairs and slot tables on the card == the host "
          f"loop's from the same f32 router logits; {dropped} of "
          f"{want['keep'].size} pairs dropped (expert loads "
          f"{load.min()}-{load.max()})")
    del model
    return {"ms_per_step": step_ms, "eager_ms_per_step": eager_ms,
            "bound_ms": bound_ms, "weight_bytes": weights,
            "steps": b.steps, "idle_share": 1 - busy / step_ms,
            "dropped": dropped}


def moe_equivalence(dev) -> dict:
    """prefill == decode on the last token for DeepSeek-V2 at full width,
    depth ``MOE_EQUIV_LAYERS`` (the MLA prefix layer + 1 MoE layer), f32,
    on ``EQUIV_S`` tokens, the capacity factor raised so that the prefill
    drops no pair (``C >= S``; the reference's prefill and decode differ
    wherever it drops one), which is checked; and the MLA prefix layer's
    last-token output, prefill against decode, alone."""
    import numpy as np
    import torch

    from repro_torch.models import layers, lm

    base = moe_config("deepseek_v2_236b", MOE_EQUIV_LAYERS, dtype="float32")
    mc = base.moe
    cf = mc.n_experts / mc.top_k * 1.01
    cfg = dataclasses.replace(
        base, moe=dataclasses.replace(mc, capacity_factor=cf))
    C = layers.moe_capacity(cfg, EQUIV_S)
    if C < EQUIV_S:
        fail(f"moe equivalence: capacity {C} < {EQUIV_S} tokens at factor "
             f"{cf}")
    kept = []
    route = layers.moe_route

    def route_spy(*a, **kw):
        r = route(*a, **kw)
        kept.append(r["keep"])
        return r
    zero_model_counts()
    with torch.inference_mode():
        model = lm.LM.init(cfg, torch.Generator(device=dev).manual_seed(3),
                           dev)
        tokens = torch.as_tensor(np.random.default_rng(4).integers(
            0, cfg.vocab, (1, EQUIV_S)), dtype=torch.int32, device=dev)
        layers.moe_route = route_spy
        try:
            full = lm.forward(cfg, model, {"tokens": tokens})
        finally:
            layers.moe_route = route
        if len(kept) != 1 or not bool(kept[0].all()):
            fail(f"moe equivalence: the prefill dropped "
                 f"{sum(int((~k).sum()) for k in kept)} pairs")
        cache = model.init_cache(1, EQUIV_S)
        pos = torch.zeros((1,), dtype=torch.int32, device=dev)
        for t in range(EQUIV_S):
            logits, cache = model.decode_step(
                cache, {"token": tokens[:, t:t + 1], "pos": pos + t})
        # the MLA prefix layer alone, on the embedded tokens
        mix = model.blocks[0]["mix"]
        x = model.embed[tokens]
        y_full = layers.mla_forward(cfg, mix, x, None)
        c1 = layers.init_mla_cache(cfg, 1, EQUIV_S, torch.float32, dev)
        for t in range(EQUIV_S):
            y, c1 = layers.mla_decode(cfg, mix, x[:, t:t + 1], c1, pos + t)
    torch.cuda.synchronize()
    n = model_counts()
    print("moe equivalence launches: " + json.dumps(n, sort_keys=True))
    if n:
        fail(f"moe equivalence: launches {n}; no kernel wrapper is on it")
    errs = {}
    for what, a, b_ in (("logits", logits[:, 0], full[:, -1]),
                        ("mla", y[:, 0], y_full[:, -1])):
        try:
            torch.testing.assert_close(a, b_, rtol=2e-3, atol=2e-3)
        except AssertionError as e:
            fail(f"deepseek_v2_236b: prefill and decode disagree on the "
                 f"last token ({what}): {e}")
        errs[what] = (a - b_).abs().max().item()
    print(f"check: deepseek_v2_236b full width, depth {cfg.n_layers}, f32, "
          f"capacity factor {cf:.4g} (C {C} >= {EQUIV_S}; the prefill "
          f"dropped no pair): prefill == decode on the last of {EQUIV_S} "
          f"tokens (max |diff| {errs['logits']:.3g}), and the MLA prefix "
          f"layer's last-token output alone (max |diff| {errs['mla']:.3g}),"
          " rtol/atol 2e-3")
    del model, full, cache, c1
    torch.cuda.empty_cache()
    return {"capacity": C, "errors": errs}


def moe_prefill_path(dev) -> dict:
    """The moe_prefill path: Kimi-K2 at full width cut to
    ``MOE_PREFILL_LAYERS`` layers (GQA 64 q heads over 8 kv heads at hd
    128, the dense prefix layer's MLP, the capacity-routed MoE of 384
    experts), bf16, chunked attention: ``lm.forward`` on 1 x
    ``MOE_PREFILL_S`` tokens; the tensor-core K4 in every layer, at a GQA
    group of 8, on views of the layer's activations."""
    cfg = moe_config("kimi_k2_1t_a32b", MOE_PREFILL_LAYERS,
                     attn_impl="chunked")
    return k4_prefill(cfg, MOE_PREFILL_S, "moe_prefill", dev)


def hybrid_config():
    """Jamba-1.5-Large at its published widths cut to one period
    (``HYBRID_LAYERS``), bf16, chunked attention."""
    return moe_config("jamba_1_5_large_398b", HYBRID_LAYERS,
                      attn_impl="chunked")


def hybrid_model(cfg, dev) -> tuple:
    """(Jamba's ``lm.LM``, its unique parameter bytes), its parameters
    assembled here from ``layers.init_*`` (seed 0) because four MoE layers'
    experts (3 x 16 x 8192 x 24576 bf16, 19.33 GB each) and the rest do not
    fit one card: the first MoE layer's ``w_gate``, ``w_up`` and ``w_down``
    are one draw that every MoE layer views; routers, norms and every
    other weight are drawn per layer.  Each layer still reads its experts
    from device memory (19.33 GB, ~390x the L2) at every use."""
    import torch

    from repro_torch.models import layers, lm

    g = torch.Generator(device=dev).manual_seed(0)
    dt = layers._dt(cfg)
    D, V, E = cfg.d_model, cfg.vocab, cfg.moe.n_experts
    with torch.inference_mode():
        params = {"embed": layers._normal(g, (V, D), 0.02, dt, dev),
                  "final_norm": torch.ones((D,), dtype=dt, device=dev),
                  "lm_head": layers._normal(g, (D, V), D ** -0.5, dt, dev)}
        experts, blocks = None, []
        for mix, ffn in lm.layer_specs(cfg):
            init_mix = layers.init_attn if mix == "attn" else \
                layers.init_mamba
            layer = {"mix": init_mix(cfg, g, dev)}
            if ffn == "mlp":
                layer["ffn"] = layers.init_mlp(cfg, g, dev)
            elif experts is None:
                layer["ffn"] = layers.init_moe(cfg, g, dev)
                experts = {k: layer["ffn"][k]
                           for k in ("w_gate", "w_up", "w_down")}
            else:
                layer["ffn"] = {
                    "norm": torch.ones((D,), dtype=dt, device=dev),
                    "router": layers._normal(g, (D, E), D ** -0.5,
                                             torch.float32, dev),
                    **experts}
            blocks.append(layer)
        params["blocks"] = blocks
        model = lm.LM(cfg, params)
    unique = {p.data_ptr(): p.numel() * p.element_size()
              for p in model.parameters()}
    return model, sum(unique.values())


def hybrid_paths(dev, prof: dict) -> dict:
    """The hybrid_prefill and hybrid_serve paths on one Jamba model
    (``hybrid_model``, ~32.5 GB), then ``hybrid_equivalence``."""
    import torch

    from repro_torch.models import lm

    cfg = hybrid_config()
    specs = lm.layer_specs(cfg)
    if [m for m, _ in specs] != ["mamba"] * 4 + ["attn"] + ["mamba"] * 3 \
            or [f for _, f in specs] != ["moe", "mlp"] * 4:
        fail(f"hybrid: Jamba's period {specs}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, unique = hybrid_model(cfg, dev)
    torch.cuda.synchronize()
    print(f"hybrid: {cfg.name} full width, {cfg.n_layers} layers (one "
          f"period: 7 Mamba + attention at 4; 4 MoE + 4 MLP), bf16, built "
          f"in {time.perf_counter() - t0:.1f} s: "
          f"{sum(p.numel() for p in model.parameters())} parameters as the "
          f"layers use them, {unique} B unique (the 4 MoE layers view one "
          "draw of expert weights)")
    out = {"prefill": hybrid_prefill_path(dev, model),
           "serve": hybrid_serve_path(dev, model, prof)}
    del model
    torch.cuda.empty_cache()
    out["equivalence"] = hybrid_equivalence(dev)
    return out


def hybrid_prefill_path(dev, model) -> dict:
    """The hybrid_prefill path: Jamba's ``lm.forward`` on 1 x
    ``HYBRID_PREFILL_S`` tokens through ``k4_prefill`` (K4 once, in the
    attention layer, at a GQA group of 8); then one more forward with CUDA
    events around every call of the Mamba layers' core (the short conv,
    the dt/B/C projections, the scan and its readout) and of the scan
    alone: their device ms."""
    import numpy as np
    import torch

    from repro_torch.models import layers, lm

    cfg = model.cfg
    out = k4_prefill(cfg, HYBRID_PREFILL_S, "hybrid_prefill", dev,
                     model=model)
    spans = {"core": [], "scan": []}
    originals = {"core": layers._mamba_core, "scan": layers._linear_scan}

    def timed(kind):
        def run(*a, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            r = originals[kind](*a, **kw)
            ev[1].record()
            spans[kind].append(ev)
            return r
        return run
    tokens = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, (1, HYBRID_PREFILL_S)), dtype=torch.int32, device=dev)
    layers._mamba_core, layers._linear_scan = timed("core"), timed("scan")
    try:
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lm.forward(cfg, model, {"tokens": tokens})
            torch.cuda.synchronize()
            fwd = (time.perf_counter() - t0) * 1e3
    finally:
        layers._mamba_core = originals["core"]
        layers._linear_scan = originals["scan"]
    ms = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in spans.items()}
    n_core = len(spans["core"])
    n_mamba = sum(mix == "mamba" for mix, _ in lm.layer_specs(cfg))
    print(f"hybrid_prefill: the Mamba layers' core {ms['core']:.1f} ms in "
          f"{n_core} calls ({n_mamba} layers x {n_core // n_mamba} chunks), "
          f"of which the scan {ms['scan']:.1f} ms (CUDA events around each "
          f"call, in a forward of {fwd:.1f} ms wall)")
    return {**out, "mamba_core_ms": ms["core"], "scan_ms": ms["scan"],
            "mamba_calls": n_core}


def hybrid_serve_path(dev, model, prof: dict) -> dict:
    """The hybrid_serve path: a ``ContinuousBatcher`` of 4 slots answers 8
    requests on Jamba, every step a replay of the step's CUDA graph (Mamba
    states, attention cache and MoE dispatch in it; no kernel wrapper:
    the step's attention is plain ``_sdpa`` over the cache); the same
    requests eagerly must give the same ids, timed eager, graph, graph,
    eager, beside the step's weight-read bound; then one slot answering two
    requests in turn must give the second the ids it gets alone (the
    admission reset zeroes the slot's Mamba state under the graph)."""
    import torch

    cfg = model.cfg
    prompts, lens, max_len = serve_requests(cfg.vocab)
    zero_model_counts()
    ids, b, _ = run_batcher(cfg, model, prompts, max_len, True, dev,
                            "hybrid_serve")
    n = model_counts()
    print("hybrid_serve path launches: " + json.dumps(n, sort_keys=True))
    if n or b.decode_fn.launches_per_replay:
        fail(f"hybrid_serve: the path launched {n} and its graph recorded "
             f"{b.decode_fn.launches_per_replay}; no kernel wrapper is on "
             "it")
    if b.decode_fn.replays != b.steps:
        fail(f"hybrid_serve: {b.decode_fn.replays} graph replays for "
             f"{b.steps} batcher steps")
    times = step_times(cfg, model, prompts, max_len, ids, dev, "hybrid_serve")
    print(f"check: hybrid_serve: all {len(prompts)} requests completed in "
          f"{b.steps} steps, each a replay of the decode graph; every token "
          "id the same eager and graphed")
    pair = run_batcher(cfg, model, prompts[:2], max_len, True, dev,
                       "hybrid_serve (one slot, two requests)", n_slots=1)[0]
    alone = run_batcher(cfg, model, prompts[1:2], max_len, True, dev,
                        "hybrid_serve (one slot, one request)", n_slots=1)[0]
    if pair[1] != alone[0]:
        fail(f"hybrid_serve: request 1 after request 0 in one slot gave "
             f"{pair[1]}, alone {alone[0]}: the slot's Mamba state was not "
             "reset")
    print(f"check: hybrid_serve: one slot, request 1 served after request 0 "
          f"gives the ids it gets alone ({len(alone[0])} tokens): the "
          "reused slot's Mamba state starts at zero")
    new = sum(len(v) for v in ids.values())
    weights = step_weight_bytes(model, SERVE["slots"])
    bound_ms = weights / HBM_BYTES_PER_S * 1e3
    step_ms = statistics.median(times["graph"])
    eager_ms = statistics.median(times["eager"])
    st = prof["hybrid_step"]
    print(f"hybrid_serve: Jamba full width, {cfg.n_layers} layers, bf16: "
          f"batcher {len(ids)}/{len(prompts)} requests (prompts "
          f"{lens.min()}-{lens.max()}, max_new {SERVE['max_new']}) in "
          f"{b.steps} steps: graphed step {step_ms:.3f} ms ("
          f"{', '.join(f'{t:.3f}' for t in times['graph'])}), eager step "
          f"{eager_ms:.3f} ms ({', '.join(f'{t:.3f}' for t in times['eager'])}"
          f"; timed eager, graph, graph, eager), "
          f"{new / (step_ms * b.steps / 1e3):.1f} tokens/s graphed; "
          f"weight-read bound {bound_ms:.3f} ms for {weights} B per step "
          f"(graphed step / bound {step_ms / bound_ms:.3f}); device busy "
          f"{st['busy_ms']:.3f} ms of the graphed step over "
          f"{st['activities']:.0f} activities (profiled in a fresh child, "
          f"wall {st['wall_ms']:.3f} ms a step): idle share "
          f"{1 - st['busy_ms'] / step_ms:.3f}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; device ms "
          "a step by kernel: "
          + "; ".join(f"{n_} {ms:.3f}" for n_, ms in st["top_ms"]))
    return {"ms_per_step": step_ms, "eager_ms_per_step": eager_ms,
            "bound_ms": bound_ms, "weight_bytes": weights, "steps": b.steps,
            "idle_share": 1 - st["busy_ms"] / step_ms}


def hybrid_equivalence(dev) -> dict:
    """Jamba's Mamba layer alone at full width in f32 (a whole f32 period
    does not fit): ``mamba_forward`` on ``HYBRID_EQUIV_S`` tokens (chunks of
    256, log-depth scans) against as many chained ``mamba_decode`` steps,
    on the last token at 2e-3."""
    import torch

    from repro_torch.models import layers

    cfg = dataclasses.replace(hybrid_config(), dtype="float32")
    g = torch.Generator(device=dev).manual_seed(3)
    zero_model_counts()
    with torch.inference_mode():
        p = layers.init_mamba(cfg, g, dev)
        x = torch.randn((1, HYBRID_EQUIV_S, cfg.d_model), generator=g,
                        device=dev)
        full = layers.mamba_forward(cfg, p, x)
        cache = layers.init_mamba_cache(cfg, 1, torch.float32, dev)
        ys = []
        for t in range(HYBRID_EQUIV_S):
            y, cache = layers.mamba_decode(cfg, p, x[:, t:t + 1], cache)
            ys.append(y)
        dec = torch.cat(ys, dim=1)
    torch.cuda.synchronize()
    n = model_counts()
    if n:
        fail(f"hybrid equivalence: launches {n}; no kernel wrapper is on it")
    try:
        torch.testing.assert_close(dec[:, -1], full[:, -1], rtol=2e-3,
                                   atol=2e-3)
    except AssertionError as e:
        fail(f"Jamba's Mamba layer: prefill and decode disagree on the last "
             f"token: {e}")
    err = (dec[:, -1] - full[:, -1]).abs().max().item()
    err_all = (dec - full).abs().max().item()
    print(f"check: Jamba's Mamba layer full width (di {2 * cfg.d_model}, "
          f"d_state {cfg.mamba_d_state}), f32: prefill (chunks of 256) == "
          f"{HYBRID_EQUIV_S} chained decode steps on the last token (max "
          f"|diff| {err:.3g}, rtol/atol 2e-3; over every token {err_all:.3g})")
    del p, x, full, dec
    torch.cuda.empty_cache()
    return {"error": err, "error_all": err_all}


def encdec_step_flops(cfg, B: int) -> int:
    """Operations of one Whisper decode step of B rows: the encoder over B
    x enc_seq frames (projections, scores and values, the 2-matrix MLP),
    each decoder layer's cross-attention keys and values over them, and
    the decoder's and the head's products for the B new tokens."""
    D, F, T, V = cfg.d_model, cfg.d_ff, cfg.enc_seq, cfg.vocab
    enc = cfg.n_enc_layers * (2 * B * T * (4 * D * D + 2 * D * F)
                              + 4 * B * T * T * D)
    cross_kv = cfg.n_layers * 2 * B * T * 2 * D * D
    dec = cfg.n_layers * 2 * B * (6 * D * D + 2 * D * F) + 2 * B * D * V
    return enc + cross_kv + dec


def encdec_serve_path(dev) -> dict:
    """The encdec_serve path: ``serve.main --arch whisper_small`` (batch 4,
    prompt 32, gen 16; frames drawn after the prompts, as the reference
    does) graphed and eagerly, the same ids; no kernel wrapper is on its
    decode step.  Then the step is timed (wall, graphed and eager; device,
    graphed) beside the encoder alone: each step encodes the 1500 frames
    again through 12 layers, as the reference's does."""
    import numpy as np
    import torch

    from repro_torch.config import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm

    cfg = get_config("whisper_small")
    argv = ["--arch", "whisper_small", "--device", dev.type, "--batch",
            str(SERVE["batch"]), "--prompt-len", str(SERVE["prompt"]),
            "--gen", str(SERVE["gen"])]
    zero_model_counts()
    t0 = time.perf_counter()
    gen = serve.main(argv)
    main_s = time.perf_counter() - t0
    n = model_counts()
    print("encdec_serve path launches: " + json.dumps(n, sort_keys=True))
    if n:
        fail(f"encdec_serve: the path launched {n}; no kernel wrapper is on "
             "Whisper's decode step")
    if gen.shape != (SERVE["batch"], SERVE["gen"]) or \
            not ((gen >= 0) & (gen < cfg.vocab)).all():
        fail(f"encdec_serve: serve.main returned ids of shape {gen.shape} "
             f"outside [0, {cfg.vocab})")
    eager = serve.main(argv + ["--eager"])
    if not np.array_equal(eager, gen):
        fail(f"encdec_serve: the graphed ids {gen.tolist()} differ from the "
             f"eager ids {eager.tolist()}")
    print(f"check: encdec_serve: serve.main whisper_small (batch "
          f"{SERVE['batch']}, prompt {SERVE['prompt']}, gen {SERVE['gen']}, "
          "frames a static input of the graph): every token id the same "
          "eager and graphed")
    B = SERVE["batch"]
    with torch.inference_mode():
        model = lm.LM.init(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
        prompts, extra = serve.draw_inputs(cfg, B, SERVE["prompt"], 0, dev)
        cache = model.init_cache(B, SERVE["prompt"] + SERVE["gen"])
        graph = lm.DecodeGraph(cfg, model, cache, extra)
        tok = prompts[:, :1]
        pos = torch.zeros((B,), dtype=torch.int32, device=dev)

        def wall_ms(fn, reps=10):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / reps

        def graphed():
            graph(cache, tok, pos, **extra)

        def eager_step():
            lm.decode_step(cfg, model, cache,
                           {"token": tok, "pos": pos, **extra})
        step_ms, eager_ms = wall_ms(graphed), wall_ms(eager_step)
        step_dev = time_ms(graphed, 10)[0]
        enc_dev = time_ms(lambda: lm.encode(cfg, model, extra["frames"]),
                          10)[0]
        weights = step_weight_bytes(model, B) \
            + extra["frames"].numel() * extra["frames"].element_size()
    flops = encdec_step_flops(cfg, B)
    b_ms, b_by = max((weights / HBM_BYTES_PER_S * 1e3, "bytes"),
                     (flops / BF16_FLOP_PER_S * 1e3, "operations"))
    print(f"encdec_serve: Whisper-small full depth and width (12 + 12 "
          f"layers, bf16, {sum(p.numel() for p in model.parameters())} "
          f"parameters): serve.main in {main_s:.2f} s; a decode step of "
          f"batch {B} {step_ms:.3f} ms wall graphed ({step_dev:.3f} ms on the "
          f"device), {eager_ms:.3f} ms eager; the encoder over {B} x "
          f"{cfg.enc_seq} frames alone {enc_dev:.3f} ms on the device, "
          f"{enc_dev / step_dev:.3f} of the graphed step; bound {b_ms:.3f} ms "
          f"by {b_by} ({flops} operations on the bf16 tensor cores, "
          f"{weights} B)")
    del graph, cache, model
    torch.cuda.empty_cache()
    return {"ms_per_step": step_ms, "device_ms_per_step": step_dev,
            "eager_ms_per_step": eager_ms, "encode_ms": enc_dev,
            "bound_ms": b_ms}


def encdec_prefill_path(dev) -> dict:
    """Whisper-small's ``lm.forward`` on ``WHISPER_S`` decoder tokens and 1
    x 1500 frames, chunked attention: K4 bf16 at hd 64 in each decoder
    layer's self attention (448 = 3.5 blocks of 128 q rows: a ragged last
    block); the encoder's and the cross attention stay plain ``_sdpa``."""
    import torch

    from repro_torch.config import get_config

    cfg = dataclasses.replace(get_config("whisper_small"),
                              attn_impl="chunked")
    g = torch.Generator(device=dev).manual_seed(4)
    frames = torch.randn((1, cfg.enc_seq, cfg.d_model), generator=g,
                         device=dev).to(torch.bfloat16)
    return k4_prefill(cfg, WHISPER_S, "encdec_prefill", dev,
                      extra={"frames": frames})


def encdec_equivalence(dev) -> dict:
    """Whisper-small at full depth and width in f32 (chunked: K4 f32 at hd
    64 in the prefill): the last of ``WHISPER_S`` decode steps, each
    encoding the frames again, against the prefill's last token at 2e-3,
    the reference's own ``test_whisper_decode_matches_teacher_forcing``."""
    import numpy as np
    import torch

    from repro_torch.config import get_config
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_config("whisper_small"), dtype="float32",
                              attn_impl="chunked")
    g = torch.Generator(device=dev).manual_seed(5)
    zero_model_counts()
    with torch.inference_mode():
        model = lm.LM.init(cfg, g, dev)
        tokens = torch.as_tensor(np.random.default_rng(6).integers(
            0, cfg.vocab, (1, WHISPER_S)), dtype=torch.int32, device=dev)
        frames = torch.randn((1, cfg.enc_seq, cfg.d_model), generator=g,
                             device=dev)
        full = lm.forward(cfg, model, {"tokens": tokens, "frames": frames})
        cache = model.init_cache(1, WHISPER_S)
        pos = torch.zeros((1,), dtype=torch.int32, device=dev)
        for t in range(WHISPER_S):
            logits, cache = model.decode_step(
                cache, {"token": tokens[:, t:t + 1], "pos": pos + t,
                        "frames": frames})
    torch.cuda.synchronize()
    n = model_counts()
    print("encdec equivalence launches: " + json.dumps(n, sort_keys=True))
    if n != {"k4/tf32x3/float32": cfg.n_layers}:
        fail(f"encdec equivalence: launches {n}, expected {cfg.n_layers} "
             "K4 f32 launches in the prefill")
    try:
        torch.testing.assert_close(logits[:, 0], full[:, -1], rtol=2e-3,
                                   atol=2e-3)
    except AssertionError as e:
        fail(f"whisper_small: prefill and decode disagree on the last "
             f"token: {e}")
    err = (logits[:, 0] - full[:, -1]).abs().max().item()
    print(f"check: whisper_small full depth and width, f32: prefill (K4 f32 "
          f"at hd 64) == decode on the last of {WHISPER_S} tokens, the "
          f"frames encoded at every step (max |diff| {err:.3g}, rtol/atol "
          "2e-3)")
    del model, full, cache
    torch.cuda.empty_cache()
    return {"error": err}


def vlm_paths(dev) -> dict:
    """The vlm_prefill path: PaliGemma-3B's ``lm.forward`` on 256 patch
    embeddings + ``VLM_TEXT_S`` tokens (bf16, chunked: K4 bf16 at hd 256
    over 1024 positions, 8 q heads over one kv head); its text logits in
    f32 against the same model's dense path (plain ``_sdpa``) at 2e-3; and
    ``serve.main --arch paligemma_3b`` graphed once (text-only decoding,
    as in the reference)."""
    import numpy as np
    import torch

    from repro_torch.config import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_config("paligemma_3b"),
                              attn_impl="chunked")
    g = torch.Generator(device=dev).manual_seed(7)
    patches = torch.randn((1, cfg.n_img_tokens, cfg.d_model), generator=g,
                          device=dev)
    out = k4_prefill(cfg, VLM_TEXT_S, "vlm_prefill", dev,
                     extra={"patches": patches.to(torch.bfloat16)})
    torch.cuda.empty_cache()

    c32 = dataclasses.replace(cfg, dtype="float32")
    zero_model_counts()
    with torch.inference_mode():
        model = lm.LM.init(c32, g, dev)
        tokens = torch.as_tensor(np.random.default_rng(8).integers(
            0, cfg.vocab, (1, VLM_TEXT_S)), dtype=torch.int32, device=dev)
        batch = {"tokens": tokens, "patches": patches}
        chunked = lm.forward(c32, model, batch)
        torch.cuda.synchronize()
        n = model_counts()
        dense = lm.forward(dataclasses.replace(c32, attn_impl="dense"),
                           model, batch)
    print("vlm equivalence launches: " + json.dumps(n, sort_keys=True))
    if n != {"k4/tf32x3/float32": cfg.n_layers}:
        fail(f"vlm equivalence: launches {n}, expected {cfg.n_layers} K4 "
             "f32 launches in the chunked forward")
    if tuple(chunked.shape) != (1, VLM_TEXT_S, cfg.vocab):
        fail(f"vlm: logits of shape {tuple(chunked.shape)}, expected the "
             f"{VLM_TEXT_S} text positions only")
    try:
        torch.testing.assert_close(chunked, dense, rtol=2e-3, atol=2e-3)
    except AssertionError as e:
        fail(f"paligemma_3b: the chunked path (K4 f32) and the dense path "
             f"disagree on the text logits: {e}")
    err = (chunked - dense).abs().max().item()
    print(f"check: paligemma_3b full depth and width, f32, {cfg.n_img_tokens}"
          f" patches + {VLM_TEXT_S} tokens: text logits of the chunked path "
          f"(K4 f32 at hd 256, one kv head) == the dense path's (plain "
          f"_sdpa) (max |diff| {err:.3g}, rtol/atol 2e-3)")
    del model, chunked, dense
    torch.cuda.empty_cache()

    argv = ["--arch", "paligemma_3b", "--device", dev.type, "--batch",
            str(SERVE["batch"]), "--prompt-len", str(SERVE["prompt"]),
            "--gen", str(SERVE["gen"])]
    zero_model_counts()
    t0 = time.perf_counter()
    gen = serve.main(argv)
    secs = time.perf_counter() - t0
    n = model_counts()
    if n or gen.shape != (SERVE["batch"], SERVE["gen"]) or \
            not ((gen >= 0) & (gen < cfg.vocab)).all():
        fail(f"vlm serve: serve.main launched {n} and returned ids of shape "
             f"{gen.shape}")
    print(f"check: vlm serve: serve.main paligemma_3b (batch "
          f"{SERVE['batch']}, prompt {SERVE['prompt']}, gen {SERVE['gen']}) "
          f"graphed, text only: ids in [0, {cfg.vocab}) in {secs:.2f} s")
    return {**out, "equivalence_error": err}


def k4_entries(dev, prefill_launches: int, equiv: dict, reduced: dict,
               prof: dict, moe_prefill: dict, family_paths: list) -> list:
    """K4's three kernels against their plain versions at their paths'
    shapes, timed: the tensor-core kernel (bf16) at the prefill's (and, in
    the same entry under "kimi_k2", at the moe_prefill path's GQA group of
    8), the tf32x3 kernel (f32) at the equivalence path's (llama3-8b at hd
    128, gemma-7b at hd 256), the CUDA-core kernel (f32 and bf16) at the
    reduced path's; then the tensor-core kernel at each of
    ``family_paths``' shapes ((path, k4_prefill's result, positions, the
    key of K4_SDPA_SHAPES), an entry each: Jamba's group of 8, Whisper's hd 64 over a ragged last
    block, PaliGemma's hd 256 over one kv head); each on views of (B, S,
    heads, hd) tensors as the layer hands them over, k and v at their kv
    heads."""
    import torch

    from repro_torch.config import get_config

    llama, gemma, small = (get_config("llama3_8b"), get_config("gemma_7b"),
                           reduced["cfg"])
    n = reduced["launches"]
    # dtype, config, batch, S of the checks, S timed, launches, path, the
    # key of K4_SDPA_SHAPES
    cases = [
        (torch.bfloat16, llama, 1, PREFILL_S, PREFILL_S, prefill_launches,
         "prefill", "bfloat16/llama3_8b"),
        (torch.float32, llama, 1, PREFILL_S, EQUIV_S,
         equiv["llama3_8b"].get("k4/tf32x3/float32", 0),
         "equivalence (llama3-8b)", "float32/llama3_8b"),
        (torch.float32, gemma, 1, EQUIV_S, EQUIV_S,
         equiv["gemma_7b"].get("k4/tf32x3/float32", 0),
         "equivalence (gemma-7b)", "float32/gemma_7b"),
        (torch.float32, small, REDUCED_B, REDUCED_S, REDUCED_S,
         n.get("k4/cuda_cores/float32", 0), "reduced",
         "float32/llama3_8b/reduced"),
        (torch.bfloat16, small, REDUCED_B, REDUCED_S, REDUCED_S,
         n.get("k4/cuda_cores/bfloat16", 0), "reduced",
         "bfloat16/llama3_8b/reduced")]
    entries = [k4_entry(dev, *c, prof) for c in cases]
    kimi = k4_entry(dev, torch.bfloat16, moe_prefill["cfg"], 1,
                    MOE_PREFILL_S, MOE_PREFILL_S, moe_prefill["launches"],
                    "moe_prefill", "bfloat16/kimi_k2_1t_a32b", prof)
    entries[0]["kimi_k2"] = {k: v for k, v in kimi.items()
                             if k not in ("name", "route", "source",
                                          "replaces")}
    for path, res, S, sdpa_key in family_paths:
        entries.append(k4_entry(dev, torch.bfloat16, res["cfg"], 1, S, S,
                                res["launches"], path, sdpa_key, prof,
                                tag=path))
    return entries


def kernel_names(acts) -> list:
    """Device kernels of a profile (no copies or fills), by name."""
    return [(n_, us) for n_, us in acts
            if not re.search("memcpy|memset", n_, re.I)]


def short_name(name: str) -> str:
    """A kernel's name without its namespace and argument list."""
    return re.sub(r"\(anonymous namespace\)::", "", name).split("(")[0][:80]


def k4_entry(dev, dtype, cfg, B: int, S_check: int, S: int, launches: int,
             path: str, sdpa_key: str, prof: dict, tag: str = "") -> dict:
    """One K4 kernel held against its plain version (both draws, causal and
    not, its block pairs; the limit shown to reject a dropped kv tile) and
    timed, causal, at S tokens, beside sdpa (the backend it picked read off
    the profiler).  The CUDA-core kernel's calls are profiled too (one
    device kernel each, its own time); at f32 hd 256 the CUDA-core kernel
    is timed beside the tf32x3 kernel the route takes.  ``tag`` (the path)
    goes into the entry's name where another entry has its kernel, dtype
    and hd."""
    import torch

    from repro_torch import _cuda
    from repro_torch.kernels import flash_attention as fa

    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = str(dtype).removeprefix("torch.")
    tol = K4_TOL[dt]
    kind = fa.route(dtype, hd)
    lib = {"wgmma": fa.WGMMA_LIB_NAME, "tf32x3": fa.TF32X3_LIB_NAME,
           "cuda_cores": fa.LIB_NAME}[kind]
    source = f"src/repro_torch/csrc/{lib}.cu"
    ptxas = ptxas_summary(_cuda.BUILD_LOG.get(lib, (0, ""))[1])
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # bf16 at hd 256: the split kernels, held against the plain version
    # on the same split schedule
    split = kind == "wgmma" and fa.split_route(dtype, hd)
    if kind == "wgmma":
        blocks = fa.WGMMA_BLOCKS[hd][0]
        # every pair the kernel takes, block_q > block_k among them (R2)
        cases = [(True, *blocks), (False, *blocks)] + \
            [(True, *b) for b in fa.WGMMA_BLOCKS[hd][1:]]
    elif kind == "tf32x3":
        blocks = fa.TF32X3_BLOCKS[hd]
        cases = [(True, *blocks), (False, *blocks)]
    else:
        blocks = fa.CUDA_CORE_BLOCKS
        cases = [(True, *blocks), (False, *blocks), (True, 64, 64)]
    g = torch.Generator(device=dev).manual_seed(5)
    base = [torch.randn((B, S_check, h, hd), generator=g,
                        device=dev).transpose(1, 2) for h in (H, Hkv, Hkv)]
    # "randn": N(0, 1) scores, outputs ~0.03 (averages over many keys);
    # "peaky": q scaled by K4_PEAK_Q, a few keys dominate each row and the
    # outputs are O(1), so a key the kernel loses moves them by O(1)
    draws = {"randn": base,
             "peaky": [base[0] * K4_PEAK_Q, base[1], base[2]]}
    errs = {}
    for draw, xs in draws.items():
        q, k, v = (x.to(dtype) for x in xs)
        for causal, bq, bk in cases:
            got = fa.flash_attention(q, k, v, causal=causal,
                                     block_q=bq, block_k=bk)
            want = fa.flash_attention_plain(q, k, v, causal=causal,
                                            block_q=bq, block_k=bk,
                                            split=split)
            err = (got.float() - want.float()).abs().max().item()
            errs[f"{draw}/{'causal' if causal else 'full'}/{bq}x{bk}"] = err
            try:
                torch.testing.assert_close(got.float(), want.float(), **tol)
            except AssertionError as e:
                fail(f"K4 {kind} {dt} {draw} causal={causal} ({bq}, {bk}) "
                     f"differs from its plain version: {e}")
            print(f"check: K4 {kind} {dt} {draw} q {tuple(q.shape)} kv "
                  f"{tuple(k.shape)} causal={causal} blocks ({bq}, {bk})"
                  f" == plain within rtol {tol['rtol']}, atol "
                  f"{tol['atol']} (max |diff| {err:.3g}, max |plain| "
                  f"{want.float().abs().max().item():.3g})")
            if not causal:
                whole = want
        # the limit must reject a non-causal result that lost one of the
        # kernel's own kv tiles (block_k keys)
        w = blocks[1]
        t = min(K4_DROPPED_TILE, S_check // w - 2)
        keep = torch.cat([torch.arange(t * w), torch.arange(
            (t + 1) * w, S_check)]).to(dev)
        dropped = fa.flash_attention_plain(
            q, k[:, :, keep], v[:, :, keep], causal=False,
            block_q=blocks[0], block_k=blocks[1], split=split)
        lost = (dropped.float() - whole.float()).abs().max().item()
        try:
            torch.testing.assert_close(dropped.float(), whole.float(), **tol)
        except AssertionError:
            print(f"check: K4 {kind} {dt} {draw}: that limit rejects the "
                  f"non-causal result with kv tile {t} of {S_check // w} "
                  f"({w} keys) dropped (max |diff| {lost:.3g})")
        else:
            fail(f"K4 {kind} {dt} {draw}: rtol {tol['rtol']}, atol "
                 f"{tol['atol']} accepts a result with kv tile {t} ({w} "
                 f"keys) dropped (max |diff| {lost:.3g})")
    q, k, v = (x.to(dtype)[:, :, :S] for x in base)
    if launches < 1:
        fail(f"K4 {kind} {dt} was not launched on its path ({path})")
    bq, bk = blocks if split else (min(blocks[0], S), min(blocks[1], S))
    got = fa.flash_attention(q, k, v, causal=True)
    want = fa.flash_attention_plain(q, k, v, causal=True, block_q=bq,
                                    block_k=bk, split=split)
    err = (got.float() - want.float()).abs().max().item()
    try:
        torch.testing.assert_close(got.float(), want.float(), **tol)
    except AssertionError as e:
        fail(f"K4 {kind} {dt} causal at S={S} differs from its plain "
             f"version: {e}")
    esz = q.element_size()
    # q and the output at H heads, k and v at theirs, each once
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * esz
    flops = 4 * hd * (S * (S + 1) // 2) * H * B
    # the bound of the units that do the products: wgmma one bf16 pass on
    # the tensor cores; tf32x3 three TF32 passes on the tensor cores (and,
    # printed beside it, the same flops once on the fp32 CUDA cores); the
    # CUDA-core kernel the flops on the fp32 CUDA cores
    fp32_ms = flops / FP32_FLOP_PER_S * 1e3
    tf = {"wgmma": flops / BF16_FLOP_PER_S * 1e3,
          "tf32x3": 3 * flops / TF32_FLOP_PER_S * 1e3,
          "cuda_cores": fp32_ms}[kind]
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    b_ms, b_by = (tb, "bytes") if tb >= tf else (tf, "operations")
    ms, host_ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=True),
                          10)
    plain_ms = time_ms(lambda: fa.flash_attention_plain(
        q, k, v, causal=True, block_q=bq, block_k=bk, split=split), 3)[0]
    by_blocks, extra = {}, {}
    if split:
        # the grid: pairs of 64-row units cut into pieces (a block each)
        sp = fa.fwd_split(B, H, Hkv, S, S, True)
        lengths = [e - a for _, a, e, _ in sp.pieces] or list(sp.walks)
        extra["grid"] = {"blocks": sp.blocks, "sms": fa.SMS,
                         "longest_tiles": max(lengths),
                         "mean_tiles": sum(sp.walks) / sp.blocks,
                         "cut_items": len(sp.sums), "slots": sp.slots}
        extra["kernels_per_call"] = fa.fwd_launches(dtype, hd, B, H, Hkv, S)
        print(f"grid: K4 {kind} {dt} hd {hd} q ({B}, {H}, {S}, {hd}) kv "
              f"{Hkv} heads, causal: {sp.blocks} blocks on the card's "
              f"{fa.SMS} SMs, one wave; pieces of {min(lengths)} to "
              f"{max(lengths)} kv tiles of {fa.SPLIT_BK} keys (mean "
              f"{extra['grid']['mean_tiles']:.2f}), {len(sp.sums)} walks cut "
              f"into {sp.slots} partials; {extra['kernels_per_call']} "
              "kernels a call")
        if not 128 <= sp.blocks <= fa.SMS:
            fail(f"K4 {kind} {dt} hd {hd}: {sp.blocks} blocks, not one wave "
                 f"of at least 128 on {fa.SMS} SMs")
    if kind == "wgmma":
        # every pair the kernel takes, timed: the default is the faster
        for pq, pk in fa.WGMMA_BLOCKS[hd]:
            by_blocks[f"{pq}x{pk}"] = time_ms(
                lambda: fa.flash_attention(q, k, v, causal=True,
                                           block_q=pq, block_k=pk), 10)[0]
    elif kind == "cuda_cores":
        # q blocks of 16, 32, 64 rows: the default is the fastest measured
        for pq, pk in K4_CUDA_CORE_PAIRS:
            by_blocks[f"{pq}x{pk}"] = time_ms(
                lambda: fa.flash_attention(q, k, v, causal=True,
                                           block_q=pq, block_k=pk), 25)[0]
        # the device's own count and time of the kernel in a call (one call
        # a profile, in the profiling child; the profiler may drop a
        # record, never add one)
        calls = prof["k4"][dt]
        seen = [len(c) for c in calls]
        times = [us for c in calls for n_, us in c if "fa_kernel" in n_]
        if max(seen) != 1 or len(times) != sum(seen):
            fail(f"K4 {kind} {dt}: calls on the layer's views ran the device "
                 f"kernels {calls}; the design runs the attention kernel "
                 "alone, once a call")
        extra["kernel_ms"] = statistics.median(times) / 1e3
        extra["kernels_per_call"] = max(seen)
        extra["kernels_seen_per_call"] = seen
        print(f"check: K4 {kind} {dt}: {len(calls)} calls on the layer's "
              f"views, each profiled alone: the attention kernel and no "
              f"other device kernel (kernels seen per call {seen}); the "
              f"kernel {extra['kernel_ms']:.4f} ms (median), the wrapper "
              f"call {ms:.4f} ms")
    if by_blocks:
        print(f"time: K4 {kind} {dt} by blocks: " + ", ".join(
            f"{b} {t:.4f} ms" for b, t in by_blocks.items()))
    lib_in, gqa = sdpa_args(q, k, v)
    lib_ms = time_ms(lambda: sdpa(*lib_in, is_causal=True, **gqa), 10)[0]
    lib_err = (sdpa(*lib_in, is_causal=True, **gqa).float()
               - want.float()).abs().max().item()
    lib_kernels = prof["sdpa"][sdpa_key]
    print(f"time: K4 {kind} {dt} causal q ({B}, {H}, {S}, {hd}) kv "
          f"{tuple(k.shape)}: {ms:.4f} ms on the card (bound {b_ms:.4f} "
          f"ms by {b_by}"
          + (", three TF32 passes; "
             f"{max(tb, fp32_ms):.4f} ms on the fp32 CUDA cores"
             if kind == "tf32x3" else "")
          + f"; plain {plain_ms:.3f} ms; sdpa {lib_ms:.4f} ms, kernels "
          + ", ".join(lib_kernels) + "); ptxas " + " | ".join(ptxas))
    return {
        "name": f"flash_attention_{kind}[{dt}, hd {hd}"
                + (f", {tag}]" if tag else "]"), "route": "cuda",
        "source": source, "replaces": K4_REPLACES, "launches": launches,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        "library": "torch.nn.functional.scaled_dot_product_attention"
                   f"({'enable_gqa=True' if gqa else 'kv repeated'}, "
                   f"timed only; max |sdpa - plain| {lib_err:.3g})",
        "library_kernels": lib_kernels, "host_ms": host_ms,
        "bytes": nbytes, "flops": flops, "shape": [B, H, S, hd],
        "kv_shape": list(k.shape), "layout": "views of (B, S, heads, hd)",
        "causal": True, "blocks": list(blocks), "tolerance": tol,
        "check_errors": errs, "ms_by_blocks": by_blocks, **extra,
        "ptxas": ptxas, "path": path}


def k5_entries(dev, serve_launches: int, equiv: dict, prof: dict) -> list:
    """K5 against its per-token plain version at rwkv6-3b's shapes, timed:
    the sequence form (three launches) at the equivalence path's f32
    (1, 40, 1024, 64), and the step as the serve path's layer runs it (bf16
    views of its (B, 1, D) activations, the output into a bf16 view, the
    state updated in place) from a random state; then the sequence form at
    decays 0.1, 1e-3 and 1.0."""
    import torch

    from repro_torch.config import get_config
    from repro_torch.kernels import wkv6 as wk

    cfg = get_config("rwkv6_3b")
    H, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    D = H * hd
    g = torch.Generator(device=dev).manual_seed(6)
    tol = dict(rtol=2e-4, atol=2e-4)

    def inputs(B, S, dtype=torch.float32, w=None):
        """r, k, v (dtype), w (f32), as (B, H, S, hd) views of (B, S, D)
        tensors (contiguous (B, H, S, hd) when S > 1 and f32), and u."""
        def heads(t):
            return t.view(B, S, H, hd).transpose(1, 2)
        views = dtype != torch.float32
        shape = (B, S, D) if views else (B, H, S, hd)
        r, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
                   for _ in range(3))
        ww = torch.sigmoid(torch.randn(shape, generator=g, device=dev)) \
            * 0.5 + 0.45 if w is None else torch.full(shape, w, device=dev)
        u = torch.randn((H, hd), generator=g, device=dev) * 0.1
        xs = [heads(t) for t in (r, k, v, ww)] if views else [r, k, v, ww]
        return xs, u

    out = []
    # the sequence form, f32, as the prefill runs it
    xs, u = inputs(1, K5_SEQ)
    got, got_s = wk.wkv6_state(*xs, u)
    want, want_s = wk.wkv6_plain(*xs, u)
    err = max((got - want).abs().max().item(),
              (got_s - want_s).abs().max().item())
    try:
        torch.testing.assert_close(got, want, **tol)
        torch.testing.assert_close(got_s, want_s, **tol)
    except AssertionError as e:
        fail(f"K5 sequence differs from its plain version: {e}")
    # the device's own view of one call (in the profiling child): the
    # three phases' kernels, each once, and nothing else
    kern = prof["k5"]
    names = [m_.group(1) for n_, _ in kern for m_ in
             [re.search(r"wkv6_chunk_(state|scan|out)_kernel", n_)] if m_]
    if len(names) != len(kern) or sorted(names) != sorted(set(names)):
        fail("K5 sequence: one call ran the kernels " + ", ".join(
            n_ for n_, _ in kern) + "; the design launches its three phases"
             " once each")
    print(f"check: K5 sequence (1, {H}, {K5_SEQ}, {hd}) == plain within 2e-4,"
          f" output and final state (max |diff| {err:.3g}); the profiler "
          f"sees {len(kern)} of its {wk.SEQUENCE_LAUNCHES} kernels in one "
          f"call, no other: " + ", ".join(
              f"{nm} {us:.1f} us" for nm, (_, us) in zip(names, kern)))
    launches = equiv["rwkv6_3b"].get("k5/sequence", 0)
    if launches < 1:
        fail("K5 sequence was not launched on its path")
    nbytes = 4 * (5 * xs[0].numel() + u.numel() + H * hd * hd)
    flops = 5 * H * K5_SEQ * hd * hd
    b_ms, b_by = bound(nbytes, flops)
    ms, host_ms = time_ms(lambda: wk.wkv6_state(*xs, u), 25)
    by_chunk = {c: time_ms(lambda: wk.wkv6_state(*xs, u, chunk=c), 25)[0]
                for c in K5_CHUNKS}
    plain_ms = time_ms(lambda: wk.wkv6_plain(*xs, u), 3)[0]
    out.append({
        "name": "wkv6[sequence]", "route": "cuda",
        "source": "src/repro_torch/csrc/wkv6.cu", "replaces": K5_REPLACES,
        "launches": launches,
        "launches_per_call": wk.SEQUENCE_LAUNCHES,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "library": "no PyTorch call computes it", "host_ms": host_ms,
        "bytes": nbytes, "flops": flops, "shape": [1, H, K5_SEQ, hd],
        "chunk": wk.CHUNK, "ms_by_chunk": by_chunk,
        "kernel_us": [[nm, us] for nm, (_, us) in zip(names, kern)],
        "path": "equivalence (rwkv6-3b)"})
    print(f"time: K5 sequence (1, {H}, {K5_SEQ}, {hd}), chunks of "
          f"{wk.CHUNK}, {wk.SEQUENCE_LAUNCHES} launches: {ms:.4f} ms on the card, "
          f"{host_ms:.4f} ms host per call (bound {b_ms:.4f} ms by {b_by}; "
          f"plain {plain_ms:.3f} ms); by chunk: " + ", ".join(
              f"{c} {t:.4f} ms" for c, t in by_chunk.items()))

    # the step as the serve path's layer runs it
    B = SERVE["batch"]
    xs, u = inputs(B, 1, torch.bfloat16)
    s0 = torch.randn((B, H, hd, hd), generator=g, device=dev)
    o = torch.empty((B, 1, D), dtype=torch.bfloat16, device=dev)
    ov = o.view(B, 1, H, hd).transpose(1, 2)
    state = s0.clone()
    wk.wkv6_state(*xs, u, state, out=ov, s_out=state)
    want, want_s = wk.wkv6_plain(*(x.float() for x in xs), u, s0)
    err_s = (state - want_s).abs().max().item()
    err_o = (ov.float() - want.to(torch.bfloat16).float()).abs().max().item()
    try:
        torch.testing.assert_close(state, want_s, **tol)
        torch.testing.assert_close(ov.float(),
                                   want.to(torch.bfloat16).float(),
                                   **K4_TOL["bfloat16"])
    except AssertionError as e:
        fail(f"K5 step (bf16 views, in place) differs from its plain "
             f"version: {e}")
    # and at f32 on contiguous tensors, within 2e-4 on both
    xf, uf = inputs(B, 1)
    gf, gf_s = wk.wkv6_state(*xf, uf, s0)
    wf, wf_s = wk.wkv6_plain(*xf, uf, s0)
    err_f = max((gf - wf).abs().max().item(),
                (gf_s - wf_s).abs().max().item())
    try:
        torch.testing.assert_close(gf, wf, **tol)
        torch.testing.assert_close(gf_s, wf_s, **tol)
    except AssertionError as e:
        fail(f"K5 step (f32) differs from its plain version: {e}")
    print(f"check: K5 step ({B}, {H}, 1, {hd}) from a random state: bf16 "
          f"views of (B, 1, D), output into a bf16 view, state in place: "
          f"state == plain within 2e-4 (max |diff| {err_s:.3g}), output == "
          f"plain rounded to bf16 within rtol 1e-2, atol 4e-3 (max |diff| "
          f"{err_o:.3g}); f32 contiguous: == plain within 2e-4 (max |diff| "
          f"{err_f:.3g})")
    if serve_launches < 1:
        fail("K5 step was not launched on its path")
    # r, k, v and the output in bf16, w and u in f32, the state read and
    # written in f32
    nbytes = (2 * 4 * B * H * hd + 4 * B * H * hd + 4 * H * hd
              + 2 * 4 * B * H * hd * hd)
    flops = 5 * B * H * hd * hd
    b_ms, b_by = bound(nbytes, flops)

    def step():
        wk.wkv6_state(*xs, u, state, out=ov, s_out=state)
    ms, host_ms = time_ms(step, 25)
    plain_ms = time_ms(lambda: wk.wkv6_plain(*(x.float() for x in xs), u,
                                             s0), 3)[0]
    out.append({
        "name": "wkv6[step]", "route": "cuda",
        "source": "src/repro_torch/csrc/wkv6.cu", "replaces": K5_REPLACES,
        "launches": serve_launches, "launches_per_call": 1,
        "max_abs_err": max(err_s, err_o), "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "library": "no PyTorch call computes it", "host_ms": host_ms,
        "bytes": nbytes, "flops": flops, "shape": [B, H, 1, hd],
        "layout": "bf16 views of (B, 1, D), state in place", "path": "serve"})
    print(f"time: K5 step ({B}, {H}, 1, {hd}), bf16 views, state in place: "
          f"{ms:.4f} ms on the card, {host_ms:.4f} ms host per call (bound "
          f"{b_ms:.4f} ms by {b_by}; plain {plain_ms:.3f} ms)")

    for w in (0.1, 1e-3, 1.0):
        xs, u = inputs(1, K5_SEQ, w=w)
        got, got_s = wk.wkv6_state(*xs, u)
        if not (torch.isfinite(got).all() and torch.isfinite(got_s).all()):
            fail(f"K5 at w = {w} is not finite")
        want, want_s = wk.wkv6_plain(*xs, u)
        diff = max((got - want).abs().max().item(),
                   (got_s - want_s).abs().max().item())
        if w < 1.0:
            try:
                torch.testing.assert_close(got, want, **tol)
                torch.testing.assert_close(got_s, want_s, **tol)
            except AssertionError as e:
                fail(f"K5 at w = {w} differs from its plain version: {e}")
            print(f"check: K5 (1, {H}, {K5_SEQ}, {hd}) at w = {w}: output "
                  f"and state finite and == plain within 2e-4 (max |diff| "
                  f"{diff:.3g})")
            continue
        # nothing decays: the state sums all 1024 tokens (entries ~100,
        # outputs ~1000), where the f32 plain version's own rounding is
        # larger than 2e-4; both are held against the recurrence in f64,
        # the kernel within 2e-4 or the plain version's own distance from
        # it, whichever is larger
        exact, exact_s = wk.wkv6_plain(*(x.double() for x in xs), u.double())
        errs = {name: ((a.double() - b).abs().max().item(),
                       (c.double() - d).abs().max().item())
                for name, a, b, c, d in (("kernel", got, exact, got_s, exact_s),
                                         ("plain", want, exact, want_s, exact_s))}
        for a, ref, lim in ((got, exact, errs["plain"][0]),
                            (got_s, exact_s, errs["plain"][1])):
            try:
                torch.testing.assert_close(a.double(), ref, rtol=2e-4,
                                           atol=max(2e-4, lim))
            except AssertionError as e:
                fail(f"K5 at w = 1 is further from the f64 recurrence than "
                     f"2e-4 and than the f32 plain version "
                     f"{errs['plain']}: {e}")
        print(f"check: K5 (1, {H}, {K5_SEQ}, {hd}) at w = 1.0: output and "
              f"state finite; max |out| {exact.abs().max().item():.4g}; "
              f"against the f64 recurrence the kernel is off by "
              f"{errs['kernel'][0]:.3g} (output) and {errs['kernel'][1]:.3g}"
              f" (state), the f32 plain version by {errs['plain'][0]:.3g} "
              f"and {errs['plain'][1]:.3g}: within 2e-4 or the plain "
              f"version's own error (kernel - plain {diff:.3g})")
        k5_w1 = {"kernel_vs_f64": errs["kernel"], "plain_vs_f64": errs["plain"]}
    out[0]["w1_errors"] = k5_w1
    return out


# ---------------------------------------------------------------------------
# path 13, train: K4's backward kernel, llama3-8b trained at full width,
# chunked == dense gradients, restart == uninterrupted
# ---------------------------------------------------------------------------


def train_config(**kw):
    """llama3-8b as published, cut to TRAIN_LAYERS of its 32 layers, with
    chunked attention (``kw`` replaced too)."""
    from repro_torch.config import get_config
    return dataclasses.replace(get_config("llama3_8b"), **{
        "n_layers": TRAIN_LAYERS, "attn_impl": "chunked", **kw})


def train_kernel_class(name: str) -> str:
    """Where a training step's device activity goes: K4's forward or
    backward, a cuBLAS GEMM, the loss's (log-)softmax, or the rest (the
    optimiser's and the layers' elementwise passes, copies)."""
    if K4_KERNEL.search(name):
        return "k4_bwd" if "fa_bwd" in name else "k4_fwd"
    if re.search(GEMM_KERNELS, name):
        return "gemm"
    return "softmax" if re.search("softmax", name, re.I) else "rest"


def train_step_profile(dev) -> dict:
    """The train path's model (``train_config``, bf16) in the profiling
    child, after a warm-up step: "k4", [[(kernel, us)] per step], K4's
    device kernels in each of TRAIN_PROFILED steps, each profiled alone;
    "split_ms", the device ms a step by ``train_kernel_class``; "phases_ms",
    a step's two halves by CUDA events: the loss and its gradients, then
    clipping, the schedule and AdamW."""
    import torch

    from repro_torch.data import SyntheticLMData
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import lm
    from repro_torch.optim import (adamw_init, adamw_update,
                                   clip_by_global_norm, cosine_schedule)

    cfg = train_config()
    model = lm.LM.init(cfg, torch.Generator(device=dev).manual_seed(0),
                       dev).requires_grad_(True)
    opt = adamw_init(model.param_list())
    step = steps_mod.build_train_step(cfg, model)
    ds = SyntheticLMData(vocab=cfg.vocab, seq_len=TRAIN_S, batch=TRAIN_B)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in ds.batch_at(0).items()}
    step(model, opt, batch)
    k4, split, walls = [], collections.Counter(), []
    for _ in range(TRAIN_PROFILED):
        acts, wall = device_kernels(lambda: step(model, opt, batch))
        k4.append([[short_name(n_), us] for n_, us in kernel_names(acts)
                   if K4_KERNEL.search(n_)])
        for n_, us in acts:
            split[train_kernel_class(n_)] += us / 1e3 / TRAIN_PROFILED
        walls.append(wall)
    params = model.param_list()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    ev[0].record()
    grads = torch.autograd.grad(lm.loss_fn(cfg, model, batch), params)
    ev[1].record()
    grads, _ = clip_by_global_norm(grads, 1.0)
    adamw_update(params, grads, opt, cosine_schedule(opt["count"]))
    ev[2].record()
    torch.cuda.synchronize()
    phases = {"loss_and_grads": ev[0].elapsed_time(ev[1]),
              "clip_and_adamw": ev[1].elapsed_time(ev[2])}
    del model, opt, params, grads
    torch.cuda.empty_cache()
    return {"k4": k4, "split_ms": dict(split), "phases_ms": phases,
            "profiled_wall_ms": walls}


def k4_bwd_case(dev, dtype, B: int, H: int, Hkv: int, S: int, hd: int,
                causal: bool, seed: int) -> dict:
    """K4's backward (the kernels of ``bwd_route``, through
    ``flash_attention``'s autograd Function, forward kernel and all)
    against autograd of ``flash_attention_plain`` on the same views of (B,
    S, heads, hd) tensors, a second backward bitwise the first, and the
    limit shown to reject the gradient of a call that lost one of the dK/dV
    kernel's kv tiles.  Returns the errors, the backward's launches and the
    inputs for timing."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    dt = str(dtype).removeprefix("torch.")
    tol = K4_BWD_TOL[dt]
    g = torch.Generator(device=dev).manual_seed(seed)
    base = [torch.randn((B, S, h, hd), generator=g, device=dev).to(dtype)
            .requires_grad_() for h in (H, Hkv, Hkv)]
    dout = torch.randn((B, S, H, hd), generator=g, device=dev).to(dtype) \
        .transpose(1, 2)
    q, k, v = (t.transpose(1, 2) for t in base)
    fa.LAUNCHES.clear()
    out = fa.flash_attention(q, k, v, causal=causal)
    got = torch.autograd.grad(out, base, dout, retain_graph=True)
    torch.cuda.synchronize()
    n = dict(fa.LAUNCHES)
    kind = fa.bwd_route(dtype, hd)
    want_n = {f"{fa.route(dtype, hd)}/{dt}": fa.fwd_launches(
                  dtype, hd, B, H, Hkv, S, S, causal),
              f"bwd/{dt}": fa.bwd_launches(dtype, hd, B, H, Hkv, S, S,
                                           causal)}
    if n != want_n:
        fail(f"K4 bwd {dt} hd {hd}: launches {n}, expected {want_n}")
    again = torch.autograd.grad(out, base, dout)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"K4 bwd {dt} q ({B}, {H}, {S}, {hd}) kv {Hkv}: a second "
             "backward on the same inputs differs from the first")
    tq, tk = fa.BWD_TILES[kind][hd]
    bq, bk = min(tq, S), min(tk, S)
    # bf16 at hd 256: autograd of the forward's plain version on its split
    # schedule (its blocks, WGMMA_BLOCKS[256][0])
    split = fa.split_route(dtype, hd)
    fwd_blocks = fa.WGMMA_BLOCKS[hd][0] if split else (bq, bk)

    def plain_grads(keep=None):
        ref = [t.detach().requires_grad_() for t in base]
        kk, vv = ref[1], ref[2]
        if keep is not None:
            kk, vv = kk[:, keep], vv[:, keep]
        o = fa.flash_attention_plain(ref[0].transpose(1, 2),
                                     kk.transpose(1, 2), vv.transpose(1, 2),
                                     causal=causal, block_q=fwd_blocks[0],
                                     block_k=fwd_blocks[1], split=split)
        return torch.autograd.grad(o, ref, dout)

    want = plain_grads()
    errs, scale = {}, {}
    for name, a, b, x in zip(("dq", "dk", "dv"), got, want, base):
        if a.dtype != dtype or a.shape != x.shape:
            fail(f"K4 bwd {dt} hd {hd}: {name} is {a.dtype} "
                 f"{tuple(a.shape)}, its input {x.dtype} {tuple(x.shape)}")
        errs[name] = (a.float() - b.float()).abs().max().item()
        scale[name] = b.float().abs().max().item()
        try:
            torch.testing.assert_close(a.float(), b.float(), **tol)
        except AssertionError as e:
            fail(f"K4 bwd {dt} q ({B}, {H}, {S}, {hd}) kv {Hkv} "
                 f"causal={causal}: {name} differs from autograd of the "
                 f"plain version: {e}")
    # the limit must reject a gradient that lost one kv tile (bk keys) of
    # the kernel's: dq without its keys, dk and dv zero there
    t = max(0, min(K4_DROPPED_TILE, S // bk - 2))
    keep = torch.cat([torch.arange(t * bk), torch.arange((t + 1) * bk, S)]
                     ).to(dev)
    rejected = False
    for a, b in zip(plain_grads(keep), want):
        try:
            torch.testing.assert_close(a.float(), b.float(), **tol)
        except AssertionError:
            rejected = True
    if not rejected:
        fail(f"K4 bwd {dt} hd {hd}: rtol {tol['rtol']}, atol {tol['atol']}"
             f" accepts the gradient with kv tile {t} ({bk} keys) dropped")
    print(f"check: K4 bwd {dt} q ({B}, {H}, {S}, {hd}) kv {Hkv} heads, "
          f"causal={causal}, views, route {kind}: dq, dk, dv == autograd of "
          f"the plain version within rtol {tol['rtol']}, atol {tol['atol']} "
          f"and bitwise the same in a second call (max "
          f"|diff| " + ", ".join(f"{k_} {e:.3g} of {scale[k_]:.3g}"
                                 for k_, e in errs.items())
          + f"); the limit rejects the gradient with kv tile {t} of "
          f"{-(-S // bk)} ({bk} keys) dropped; launches {n}")
    return {"errs": errs, "q": q.detach(), "k": k.detach(),
            "v": v.detach(), "out": out.detach(), "dout": dout,
            "tol": tol, "causal": causal, "launches": n[f"bwd/{dt}"]}


def k4_bwd_checks(dev) -> dict:
    """Part (a) of the train path: K4's backward at each of
    ``k4_bwd_shapes``: llama3-8b's shape (q (B, 32, 2048, 128) over 8 kv
    heads, causal; bf16 at the train path's batch of 2, f32 at 1), hd 64 not
    causal over a ragged last block of 448 rows, hd 256 over one kv head, a
    GQA group of 8 at hd 128 over 2048 rows and hd 16, in both dtypes.
    Returns every case by its key, for timing."""
    import torch

    out = {}
    for key, shape in k4_bwd_shapes().items():
        dt = key.split("/")[0]
        seed = 11 + [k_ for k_ in k4_bwd_shapes() if
                     k_.split("/")[0] == dt].index(key)
        out[key] = k4_bwd_case(dev, getattr(torch, dt), *shape, seed)
        torch.cuda.empty_cache()
    return out


def k4_bwd_entries(dev, cases: dict, launches: dict, prof: dict) -> list:
    """The backward's ``kernels`` entries, one a case of ``k4_bwd_checks``
    (llama3-8b's shape, Whisper's, PaliGemma's, Kimi-K2's GQA 8 and hd 16,
    in both dtypes),
    each on its ``bwd_route`` beside its plain version and
    scaled_dot_product_attention's backward; ``launches`` by dtype from the
    path that ran it (bf16: the full-width training run; f32: the chunked
    == dense gradients; the other shapes: their check's call); each kernel
    timed apart off the profiler, and sdpa's backward kernels read off it,
    in the profiling child.  The bound is the card's peak for the inputs'
    type (bf16: one tensor-core pass; f32: three TF32 passes, as K4's f32
    forward is bounded); the same flops on the fp32 CUDA cores are printed
    beside it."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    sdpa = torch.nn.functional.scaled_dot_product_attention
    libs = {"mma": (fa.BWD_LIB_NAME, fa.bwd_kernel_source()),
            "wgmma": (fa.WGMMA_BWD_LIB_NAME, fa.wgmma_bwd_kernel_source()),
            "tf32x3": (fa.TF32X3_BWD_LIB_NAME, fa.tf32x3_bwd_kernel_source())}
    ptxas = {kind: (ptxas_summary if kind == "mma" else ptxas_kernels)(
        build_log(*lib)) for kind, lib in libs.items()}
    smem = {}
    for kind, launcher, fn in (
            ("wgmma", fa._wgmma_bwd_launcher, "flash_attention_bwd_wgmma_smem"),
            ("tf32x3", fa._tf32x3_bwd_launcher,
             "flash_attention_bwd_tf32x3_smem")):
        query = getattr(launcher()[0], fn)
        smem[kind] = {f"{w}<{hd}>": query(hd, i) for hd in fa.BWD_TILES[kind]
                      for i, w in enumerate(("dkdv", "dq"))}
    srcs = {"wgmma": "src/repro_torch/csrc/flash_attention_bwd_wgmma.cu",
            "tf32x3": "src/repro_torch/csrc/flash_attention_bwd_tf32x3.cu",
            "mma": "src/repro_torch/csrc/flash_attention_bwd.cu"}
    entries = []
    for key, c in cases.items():
        q, k, v, out, dout = c["q"], c["k"], c["v"], c["out"], c["dout"]
        causal = c["causal"]
        B, H, S, hd = q.shape
        Hkv = k.shape[1]
        dt = key.split("/")[0]
        kind = fa.bwd_route(q.dtype, hd)
        n = launches[key] if key in launches else c["launches"]
        if n < 1:
            fail(f"K4 bwd {key} was not launched on its path")
        fwd = fa.route(q.dtype, hd)
        lse = fa._run(q, k, v, causal, fwd, *k4_forward_blocks(fwd, hd),
                      True)[1]
        tq, tk = fa.BWD_TILES[kind][hd]
        # bf16: the plain version on the kernels' own schedule
        split = kind == "wgmma"
        ms, host_ms = time_ms(lambda: fa.flash_attention_bwd(
            q, k, v, out, lse, dout, causal=causal), 10)
        plain_ms = time_ms(lambda: fa.flash_attention_bwd_plain(
            q, k, v, out, lse, dout, causal=causal,
            block_q=tq if split else min(tq, S),
            block_k=tk if split else min(tk, S), split=split), 3)[0]
        per_call = fa.bwd_launches(q.dtype, hd, B, H, Hkv, S, S, causal)
        grid = {}
        if split and hd != 256:
            # the dK/dV kernel's kv tiles of 128 keys, their walks wrapped
            # over the SMs where they are fewer
            sp = fa.dkdv_wrap(B, H, Hkv, S, S, causal)
            steps = sp.block_steps()
            grid["dkdv"] = {"blocks": sp.blocks, "longest_steps": max(steps),
                            "mean_steps": sum(sp.walks) / fa.SMS,
                            "cut_items": len(sp.sums), "slots": sp.slots}
            g_ = grid["dkdv"]
            print(f"grid: K4 bwd {dt} q ({B}, {H}, {S}, {hd}) kv {Hkv} "
                  f"heads: dkdv {g_['blocks']} blocks, the longest "
                  f"{g_['longest_steps']} steps (the SMs' mean "
                  f"{g_['mean_steps']:.2f}), {g_['cut_items']} kv tiles cut "
                  f"into {g_['slots']} partials")
            if key.endswith("kimi_k2") and (
                    sp.blocks > fa.SMS
                    or g_["longest_steps"] > 1.1 * g_["mean_steps"]):
                fail(f"K4 bwd {key}: dK/dV grid {g_}, not within 1.1x of "
                     f"the mean on {fa.SMS} SMs")
        elif split:
            # the dK/dV grid (kv tiles of 64 keys over heads x q tiles) and
            # the dQ grid (pairs of 64-row units over 32-key steps), cut
            for what, sp in (("dkdv", fa.dkdv_split(B, H, Hkv, S, S, causal)),
                             ("dq", fa.dq_split(B, H, Hkv, S, S, causal))):
                lengths = [e - a for _, a, e, _ in sp.pieces] or list(sp.walks)
                grid[what] = {"blocks": sp.blocks, "longest_steps":
                              max(lengths), "mean_steps":
                              sum(sp.walks) / sp.blocks,
                              "cut_items": len(sp.sums), "slots": sp.slots}
            print(f"grid: K4 bwd {dt} q ({B}, {H}, {S}, {hd}) kv {Hkv} "
                  f"heads: " + "; ".join(
                      f"{w} {g_['blocks']} blocks on {fa.SMS} SMs, pieces "
                      f"up to {g_['longest_steps']} steps (mean "
                      f"{g_['mean_steps']:.2f}), {g_['slots']} partials"
                      for w, g_ in grid.items()))
            if key.endswith("paligemma_3b") and not all(
                    128 <= g_["blocks"] <= fa.SMS for g_ in grid.values()):
                fail(f"K4 bwd {key}: grids {grid}, not one wave of at "
                     f"least 128 blocks on {fa.SMS} SMs")
        kept = (S * (S + 1) // 2 if causal else S * S) * B * H
        flops = 10 * hd * kept           # 2.5 x the forward's 4 hd a score
        esz = q.element_size()
        # q, out, dout, dq at H heads, k, v, dk, dv at Hkv; lse in fp32
        nbytes = (4 * q.numel() + 4 * k.numel()) * esz + B * H * S * 4
        op_ms = (flops / BF16_FLOP_PER_S if dt == "bfloat16"
                 else 3 * flops / TF32_FLOP_PER_S) * 1e3
        b_ms, b_by = max((nbytes / HBM_BYTES_PER_S * 1e3, "bytes"),
                         (op_ms, "operations"))
        cc_ms = flops / FP32_FLOP_PER_S * 1e3
        (lq, lk, lv), gqa = sdpa_args(*(t.detach().requires_grad_()
                                        for t in (q, k, v)))
        lq, lk, lv = (t.detach().requires_grad_() for t in (lq, lk, lv))
        lo = sdpa(lq, lk, lv, is_causal=causal, **gqa)
        lib_ms = time_ms(lambda: torch.autograd.grad(
            lo, (lq, lk, lv), dout, retain_graph=True), 10)[0]
        lib_kernels = (prof["sdpa_bwd"][dt] if "/" not in key
                       else prof["k4_bwd"]["sdpa/" + key])
        # each kernel's device time, the median over the profiled calls
        calls = prof["k4_bwd"][key]
        split_ms = {}
        for name in sorted({n_ for c_ in calls for n_, _ in c_}):
            split_ms[name] = statistics.median(
                sum(us for n_, us in c_ if n_ == name) for c_ in calls) / 1e3
        if not all(K4_BWD_KERNELS[kind].search(n_) for n_ in split_ms):
            fail(f"K4 bwd {key}: the profiled calls ran {split_ms}, not the "
                 f"{kind} backward's kernels alone")
        px = [p_ for p_ in ptxas[kind] if kind != "mma"
              or ("bf16" in p_) == (dt == "bfloat16")]
        print(f"time: K4 bwd {dt} q ({B}, {H}, {S}, {hd}) kv {Hkv} heads, "
              f"causal={causal}, route {kind}: {ms:.4f} ms on the card "
              f"(bound {b_ms:.4f} ms by {b_by}, "
              f"{'bf16' if dt == 'bfloat16' else '3xTF32'} on the tensor "
              f"cores; {b_ms / ms:.1%}; on the fp32 CUDA cores the same "
              f"flops {cc_ms:.4f} ms, {cc_ms / ms:.1%}); by kernel "
              f"(profiler) " + ", ".join(f"{n_} {v_:.4f} ms" for n_, v_ in
                                         split_ms.items())
              + f"; plain {plain_ms:.3f} ms; sdpa's backward {lib_ms:.4f} "
              f"ms ({lib_ms / ms:.2f}x this), kernels "
              + ", ".join(lib_kernels) + "; "
              f"launches on its path {n} ({per_call} a call); ptxas "
              + " | ".join(px)
              + (f"; dynamic shared memory {smem[kind]}" if kind in smem
                 else ""))
        entries.append({
            "name": f"flash_attention_bwd_{kind}[{dt}, hd {hd}"
                    + (f", {key.split('/')[1]}]" if "/" in key else "]"),
            "route": "cuda", "source": srcs[kind], "replaces": K4_REPLACES,
            "replaces_note": "no Pallas backward: the JAX package "
                             "differentiates its attention with jax.grad "
                             f"({K4_BWD_JAX})",
            "launches": n, "max_abs_err": max(c["errs"].values()),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms,
            "cuda_core_bound_ms": cc_ms, "kernel_ms": split_ms,
            "library": "backward of torch.nn.functional."
                       "scaled_dot_product_attention("
                       f"{'enable_gqa=True' if gqa else 'kv repeated'}), "
                       "timed only",
            "library_kernels": lib_kernels, "host_ms": host_ms,
            "bytes": nbytes, "flops": flops, "causal": causal,
            "shape": [B, H, S, hd], "kv_shape": list(k.shape),
            "kernels_per_call": per_call, "grid": grid,
            "bwd_route": kind, "tiles": [tq, tk],
            "tolerance": c["tol"], "check_errors": c["errs"],
            "ptxas": px, "smem": smem.get(kind),
            "path": "train" if "/" not in key else "train (check)"})
    return entries


def train_path(dev, prof: dict) -> dict:
    """Part (b): llama3-8b at its published widths cut to TRAIN_LAYERS
    layers (bf16, chunked attention, remat "full") trained TRAIN_STEPS steps
    on TRAIN_B x TRAIN_S tokens of ``SyntheticLMData`` by
    ``launch.train.train``, the loop ``python -m repro_torch.launch.train``
    runs; K4's forward twice a layer a step (remat), its backward once."""
    import torch

    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train
    from repro_torch.models import lm

    cfg = train_config()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_model_counts()
    t0 = time.perf_counter()
    res = train.train(cfg, steps=TRAIN_STEPS, batch=TRAIN_B, seq=TRAIN_S,
                      log_every=1, seed=0, device=dev)
    secs = time.perf_counter() - t0
    n = model_counts()
    peak = torch.cuda.max_memory_allocated()
    print("train path launches: " + json.dumps(n, sort_keys=True))
    bwd_call = fa.bwd_launches(torch.bfloat16, cfg.hd, TRAIN_B, cfg.n_heads,
                               cfg.n_kv_heads, TRAIN_S)
    fwd_call = fa.fwd_launches(torch.bfloat16, cfg.hd, TRAIN_B, cfg.n_heads,
                               cfg.n_kv_heads, TRAIN_S)
    per_step = {"k4/wgmma/bfloat16": 2 * cfg.n_layers * fwd_call,
                "k4/bwd/bfloat16": bwd_call * cfg.n_layers}
    want = {k: TRAIN_STEPS * v for k, v in per_step.items()}
    if n != want:
        fail(f"train path launches {n}, expected {want} ({TRAIN_STEPS} "
             f"steps x {per_step})")
    tprof = prof["train_step"]
    seen = [collections.Counter("bwd" if "fa_bwd" in n_ else "fwd"
                                for n_, _ in s) for s in tprof["k4"]]
    most = {"fwd": max(s["fwd"] for s in seen),
            "bwd": max(s["bwd"] for s in seen)}
    if most != {"fwd": per_step["k4/wgmma/bfloat16"],
                "bwd": per_step["k4/bwd/bfloat16"]}:
        fail(f"train path: the profiling child saw K4 kernels {seen} in its "
             f"profiled steps, expected {per_step} a step")
    # bf16 at hd 128: the backward is the tensor-core route's alone
    bwd_names = sorted({n_ for s in tprof["k4"] for n_, _ in s
                        if "fa_bwd" in n_})
    if fa.bwd_route(torch.bfloat16, cfg.hd) != "wgmma" or not all(
            K4_BWD_WGMMA.search(n_) for n_ in bwd_names):
        fail(f"train path: the step's backward ran {bwd_names}, not the "
             "tensor-core backward's kernels (fa_bwd_wgmma_*) alone")
    losses = res["losses"]
    if not all(math.isfinite(x) for x in losses) or not \
            losses[-1] < losses[0]:
        fail(f"train path: losses {losses} are not finite and falling")
    # the trained model on the first step's batch again (no noise from
    # other batches: the first step's rate is 0, so losses[0] is the
    # initial model's loss on it)
    b0 = {k: torch.as_tensor(v, device=dev) for k, v in SyntheticLMData(
        vocab=cfg.vocab, seq_len=TRAIN_S, batch=TRAIN_B, seed=0
    ).batch_at(0).items()}
    with torch.no_grad():
        again = lm.loss_fn(cfg, res["model"], b0).item()
    if not again < losses[0]:
        fail(f"train path: the trained model's loss on the first step's "
             f"batch is {again}, the initial model's {losses[0]}")
    n_params = sum(p.numel() for p in res["model"].param_list())
    # the embedding is a gather, no product: 6 flops a token for every
    # other parameter (the lm head, untied in llama3, is a product)
    gathered = 0 if cfg.tie_embeddings else res["model"].embed.numel()
    tokens = TRAIN_B * TRAIN_S
    ms = statistics.median(res["step_s"][TRAIN_WARMUP:]) * 1e3
    kept = TRAIN_S * (TRAIN_S + 1) // 2 * TRAIN_B * cfg.n_heads
    k4_flops = cfg.n_layers * (4 + 10) * cfg.hd * kept   # forward + bwd
    flops = 6 * (n_params - gathered) * tokens + k4_flops
    b_ms = flops / BF16_FLOP_PER_S * 1e3
    print(f"train: llama3-8b full width, {cfg.n_layers} of 32 layers, "
          f"{n_params:,} parameters, bf16, chunked, remat {cfg.remat}: "
          f"{TRAIN_STEPS} steps on {TRAIN_B} x {TRAIN_S} tokens in "
          f"{secs:.1f} s; {ms:.2f} ms a step (median after {TRAIN_WARMUP} "
          f"warm-up; " + ", ".join(f"{s * 1e3:.1f}" for s in res["step_s"])
          + f"), {tokens / ms * 1e3:.0f} tokens/s; operations bound "
          f"{b_ms:.2f} ms ({flops / 1e12:.2f} TFLOP: 6 x "
          f"{n_params - gathered:,} parameters (the {gathered:,}-entry "
          f"embedding, a gather, left out) x tokens + K4 "
          f"{k4_flops / 1e12:.3f}, at 989 TFLOP/s), "
          f"{b_ms / ms:.1%} of it; peak memory {peak / 2**30:.1f} GiB; "
          f"losses " + ", ".join(f"{x:.4f}" for x in losses)
          + f"; on the first step's batch {losses[0]:.4f} before, "
          f"{again:.4f} after")
    split = tprof["split_ms"]
    busy = sum(split.values())
    print(f"train: where a step goes (profiling child, {TRAIN_PROFILED} "
          f"steps): device busy {busy:.2f} ms of the profiled wall "
          + ", ".join(f"{w:.2f}" for w in tprof["profiled_wall_ms"])
          + " ms; " + ", ".join(f"{k} {v:.2f} ms ({v / busy:.0%})" for k, v
                                 in sorted(split.items(), key=lambda kv:
                                           -kv[1]))
          + "; by CUDA events: loss and gradients "
          f"{tprof['phases_ms']['loss_and_grads']:.2f} ms, clipping and "
          f"AdamW {tprof['phases_ms']['clip_and_adamw']:.2f} ms")
    print(f"check: train: every loss finite, the last ({losses[-1]:.4f}) "
          f"below the first ({losses[0]:.4f}); on the first step's batch "
          f"the trained model's loss {again:.4f} below the initial "
          f"{losses[0]:.4f}; K4 launches per step "
          f"{per_step} by the wrappers, {most} most seen by the profiler in "
          f"the profiling child's steps; the backward's kernels "
          + ", ".join(bwd_names))
    del res
    torch.cuda.empty_cache()
    return {"launches": n["k4/bwd/bfloat16"], "ms_per_step": ms,
            "bound_ms": b_ms, "peak_bytes": peak, "losses": losses,
            "first_batch_after": again, "split_ms": split}


def remat_memory(dev) -> dict:
    """F6's reading: the train path's cut (TRAIN_LAYERS layers, TRAIN_B x
    TRAIN_S tokens, one model) through the train step's loss and
    gradients (``lm.loss_fn``, ``torch.autograd.grad``) under remat
    "dots" and "full", with K4 (chunked) and with the plain ``_sdpa``
    (dense, its f32 scores materialised): each run's
    ``max_memory_allocated`` above what was allocated before it (the
    weights).  "dots" keeps the layers' plain matrix products from the
    forward (``remat_saved_bytes``) and recomputes the rest: its peak may
    exceed "full"'s by those products, not by the softmax's score-sized
    tensors (three (B, H, S, S) tensors a layer, which a dense step that
    kept them would add)."""
    import torch

    from repro_torch.data import SyntheticLMData
    from repro_torch.models import lm
    cfg = train_config()
    torch.cuda.empty_cache()
    model = lm.LM.init(cfg, torch.Generator(device=dev).manual_seed(0),
                       dev).requires_grad_(True)
    params = model.param_list()
    batch = {k: torch.as_tensor(v, device=dev) for k, v in SyntheticLMData(
        vocab=cfg.vocab, seq_len=TRAIN_S, batch=TRAIN_B, seed=0
    ).batch_at(0).items()}
    peaks = {}
    for impl in ("chunked", "dense"):
        for remat in ("dots", "full"):
            run = train_config(attn_impl=impl, remat=remat)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            loss = lm.loss_fn(run, model, batch)
            grads = torch.autograd.grad(loss, params)
            torch.cuda.synchronize()
            peaks[f"{impl}/{remat}"] = torch.cuda.max_memory_allocated() \
                - base
            if not math.isfinite(loss.item()):
                fail(f"remat memory: {impl} {remat}: loss {loss.item()}")
            del loss, grads
    del model, params, batch
    torch.cuda.empty_cache()
    saved = remat_saved_bytes(cfg, TRAIN_B * TRAIN_S)
    scores = 3 * TRAIN_B * cfg.n_heads * TRAIN_S * TRAIN_S * 4 \
        * cfg.n_layers
    gb = 1e9
    print("train: peak memory by remat (F6's reading; llama3-8b, "
          f"{cfg.n_layers} layers, {TRAIN_B} x {TRAIN_S} tokens, the loss "
          "and its gradients above the weights): "
          + ", ".join(f"{k} {v / gb:.3f} GB" for k, v in peaks.items())
          + f"; the plain products \"dots\" saves {saved / gb:.3f} GB, "
          f"the dense softmax's score-sized tensors {scores / gb:.3f} GB")
    for impl in ("chunked", "dense"):
        extra = peaks[f"{impl}/dots"] - peaks[f"{impl}/full"]
        if extra > 2 * saved:
            fail(f"remat memory: {impl}: \"dots\" peaks {extra / gb:.3f} GB "
                 f"over \"full\", more than twice the {saved / gb:.3f} GB of "
                 "plain products it saves")
    print(f"check: train: remat \"dots\" peaks within twice its saved "
          f"products ({2 * saved / gb:.3f} GB) of \"full\" with K4 and with "
          "the dense softmax: no score-sized tensor kept")
    return peaks


def remat_saved_bytes(cfg, tokens: int) -> int:
    """The bytes of the plain matrix products remat "dots" keeps from a
    dense llama's forward: each layer's q, k, v, o, gate, up and down
    projections' outputs over ``tokens`` tokens, in the model's dtype."""
    cols = 2 * cfg.n_heads * cfg.hd + 2 * cfg.n_kv_heads * cfg.hd \
        + 2 * cfg.d_ff + cfg.d_model
    return cfg.n_layers * tokens * cols * 2


def train_grad_equivalence(dev) -> dict:
    """Part (c): llama3-8b at full width, TRAIN_GRAD_LAYERS layers, f32, on
    1 x TRAIN_GRAD_S tokens: the gradient of every parameter through K4
    (the tf32x3 forward and the backward of ``bwd_route``, the 3xTF32 one
    at hd 128) against the dense ``_sdpa`` path's, each within
    TRAIN_GRAD_TOL of its largest entry; the chunked gradient runs under
    the profiler, and every backward kernel it sees must be its route's.
    Returns the backward's launches."""
    import torch

    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import lm

    grads = {}
    for impl in ("dense", "chunked"):
        cfg = train_config(n_layers=TRAIN_GRAD_LAYERS, dtype="float32",
                           attn_impl=impl)
        model = lm.LM.init(cfg, torch.Generator(device=dev).manual_seed(7),
                           dev).requires_grad_(True)
        batch = SyntheticLMData(vocab=cfg.vocab, seq_len=TRAIN_GRAD_S,
                                batch=1, seed=8).batch_at(0)
        zero_model_counts()
        loss = lm.loss_fn(cfg, model, {k: torch.as_tensor(v, device=dev)
                                       for k, v in batch.items()})
        got = []

        def grad():
            got.append(torch.autograd.grad(loss, model.param_list()))
        if impl == "chunked":
            acts = device_kernels(grad)[0]
        else:
            grad()
        grads[impl] = (loss.item(), got[0])
        torch.cuda.synchronize()
        n = model_counts()
        want = {} if impl == "dense" else {
            "k4/tf32x3/float32": 2 * cfg.n_layers,
            "k4/bwd/float32": fa.bwd_launches(
                torch.float32, cfg.hd, 1, cfg.n_heads, cfg.n_kv_heads,
                TRAIN_GRAD_S) * cfg.n_layers}
        if n != want:
            fail(f"chunked == dense gradients ({impl}): launches {n}, "
                 f"expected {want}")
        del model
    # the profiler may drop a record, never add one: every backward kernel
    # it saw must be the route's
    kind = fa.bwd_route(torch.float32, cfg.hd)
    bwd_names = sorted({short_name(n_) for n_, _ in kernel_names(acts)
                        if "fa_bwd" in n_})
    if not bwd_names or not all(K4_BWD_KERNELS[kind].search(n_)
                                for n_ in bwd_names):
        fail(f"chunked == dense: the chunked gradient's backward ran "
             f"{bwd_names} (profiler), not the {kind} backward's kernels "
             "alone")
    worst = 0.0
    for i, (a, b) in enumerate(zip(grads["chunked"][1], grads["dense"][1])):
        rel = ((a - b).abs().max() / b.abs().max()).item()
        worst = max(worst, rel)
        if not rel <= TRAIN_GRAD_TOL:
            fail(f"chunked == dense: gradient {i} {tuple(b.shape)} differs "
                 f"by {rel:.3g} of its largest entry (limit "
                 f"{TRAIN_GRAD_TOL})")
    dl = abs(grads["chunked"][0] - grads["dense"][0])
    print(f"check: llama3-8b full width, {TRAIN_GRAD_LAYERS} layers, f32, "
          f"1 x {TRAIN_GRAD_S} tokens: every gradient through K4 (tf32x3 "
          f"forward, the {kind} backward) == the dense path's within "
          f"{TRAIN_GRAD_TOL} of its largest entry (worst "
          f"{worst:.3g} over {len(grads['dense'][1])} tensors); loss "
          f"{grads['chunked'][0]:.6f} vs {grads['dense'][0]:.6f} (|diff| "
          f"{dl:.3g}); launches {n}; the backward's kernels (profiler) "
          + ", ".join(bwd_names))
    del grads
    torch.cuda.empty_cache()
    return {"launches": n["k4/bwd/float32"]}


def restart_check(dev, tmp: str) -> None:
    """Part (d): the reduced llama3-8b (bf16, chunked: the CUDA-core K4 and
    the mma backward kernel at hd 16) trained RESTART_STEPS steps under
    ``FaultTolerantLoop`` with a failure injected at step RESTART_FAIL_AT
    and a checkpoint every RESTART_EVERY steps ends with parameters and
    moments bitwise those of an uninterrupted run; then the reduced
    rwkv6-3b's gradients on the card equal the CPU's
    (``rwkv_card_equals_cpu``), and K4 at a head dim or dtype no kernel
    takes must raise with grad enabled."""
    import torch

    from repro_torch.config import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import lm
    from repro_torch.optim import adamw_init
    from repro_torch.runtime import FaultTolerantLoop

    cfg = dataclasses.replace(get_config("llama3_8b", reduced=True),
                              attn_impl="chunked")
    ds = SyntheticLMData(vocab=cfg.vocab, seq_len=REDUCED_S,
                         batch=REDUCED_B, seed=9)
    model = lm.LM.init(cfg, torch.Generator(device=dev).manual_seed(9),
                       dev).requires_grad_(True)
    own = model.param_list()
    step = steps_mod.build_train_step(cfg, model)

    def make_state():
        m = lm.LM.init(cfg, torch.Generator(device=dev).manual_seed(9), dev)
        params = [p.detach() for p in m.param_list()]
        return {"params": params, "opt": adamw_init(params)}

    def step_fn(state, i):
        with torch.no_grad():
            for p, s in zip(own, state["params"]):
                if p is not s:
                    p.copy_(s)
        step(model, state["opt"], {k: torch.as_tensor(v, device=dev)
                                   for k, v in ds.batch_at(i).items()})
        return {"params": own, "opt": state["opt"]}

    finals, logs = {}, {}
    for run, inject in (("restarted", {RESTART_FAIL_AT: RuntimeError(
            "injected node loss")}), ("uninterrupted", {})):
        loop = FaultTolerantLoop(os.path.join(tmp, run), make_state, step_fn,
                                 ckpt_every=RESTART_EVERY, inject=inject)
        state, logs[run] = loop.run(RESTART_STEPS)
        finals[run] = [t.detach().clone() for t in (
            *state["params"], *state["opt"]["m"], *state["opt"]["v"],
            state["opt"]["count"])]
    if logs["restarted"]["restarts"] != 1:
        fail(f"restart check: log {logs['restarted']}, expected 1 restart")
    same = [torch.equal(a, b) for a, b in zip(finals["restarted"],
                                              finals["uninterrupted"])]
    if not all(same):
        fail(f"restart check: {same.count(False)} of {len(same)} tensors "
             "differ from the uninterrupted run's")
    print(f"check: reduced llama3-8b (hd 16, bf16, chunked) under "
          f"FaultTolerantLoop, {RESTART_STEPS} steps, a checkpoint every "
          f"{RESTART_EVERY}, failure injected at step {RESTART_FAIL_AT}: "
          f"{logs['restarted']}; all {len(same)} parameters, moments and "
          f"the count bitwise those of an uninterrupted run")
    rwkv_card_equals_cpu(dev)
    # no path detaches: K4 at what no kernel takes raises with grad enabled
    raised = []
    for hd, dtype in ((48, torch.bfloat16), (64, torch.float16)):
        q = torch.randn((1, 2, 64, hd), device=dev, dtype=dtype,
                        requires_grad=True)
        try:
            fa.flash_attention(q, q, q, causal=True).sum().backward()
        except ValueError as e:
            raised.append(f"K4 hd {hd} {dtype}: {e}")
    if len(raised) != 2:
        fail(f"with grad on the card, only these raised: {raised}")
    print("check: with grad on the card, each raises: " + "; ".join(raised))


def rwkv_card_equals_cpu(dev) -> None:
    """The reduced rwkv6-3b (f32, hd 64) on 2 x RWKV_GRAD_S tokens: the loss
    and every gradient on the card (K5's sequence form twice a layer, its
    backward kernel once) equal the same model's on the CPU (the plain
    versions, the backward's on the kernel's chunks), each within the f32
    limit of K5's backward (2e-4) of its largest entry."""
    import torch

    from repro_torch.config import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_config("rwkv6_3b", reduced=True),
                              dtype="float32")
    params = lm.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    batch = SyntheticLMData(vocab=cfg.vocab, seq_len=RWKV_GRAD_S, batch=2,
                            seed=1).batch_at(0)
    res = {}
    for where in ("cpu", dev):
        model = lm.LM(cfg, params).to(where).requires_grad_(True)
        zero_model_counts()
        loss = lm.loss_fn(cfg, model, {k: torch.as_tensor(v, device=where)
                                       for k, v in batch.items()})
        res[str(where)] = (loss.item(), [g.cpu() for g in torch.autograd.grad(
            loss, model.param_list())])
    n = model_counts()
    bwd_key = "k5/" + wk.BWD_COUNT[wk.bwd_route(cfg.rwkv_head_dim)]
    want = {"k5/sequence": 2 * wk.SEQUENCE_LAUNCHES * cfg.n_layers,
            bwd_key: wk.BWD_LAUNCHES * cfg.n_layers}
    if n != want:
        fail(f"reduced rwkv6-3b on the card: launches {n}, expected {want}")
    (lc, gc), (lg, gg) = res["cpu"], res[str(dev)]
    tol = K5_BWD_TOL["float32"]["dr"]
    worst = 0.0
    for i, (a, b) in enumerate(zip(gg, gc)):
        rel = ((a - b).abs().max() / b.abs().max()).item()
        worst = max(worst, rel)
        if not rel <= tol:
            fail(f"reduced rwkv6-3b: gradient {i} {tuple(b.shape)} on the "
                 f"card differs from the CPU's by {rel:.3g} of its largest "
                 f"entry (limit {tol})")
    if not abs(lg - lc) <= tol * abs(lc):
        fail(f"reduced rwkv6-3b: loss {lg} on the card, {lc} on the CPU")
    print(f"check: reduced rwkv6-3b (hd 64, f32) on 2 x {RWKV_GRAD_S} "
          f"tokens: loss {lg:.6f} on the card, {lc:.6f} on the CPU; every "
          f"gradient through K5's kernels == the CPU's (plain versions) "
          f"within {tol} of its largest entry (worst {worst:.3g} over "
          f"{len(gc)} tensors); launches {n}")


# ---------------------------------------------------------------------------
# path 14, train_rwkv: K5's backward kernel, rwkv6-3b trained at full width
# ---------------------------------------------------------------------------


def train_rwkv_config(**kw):
    """rwkv6-3b as published, cut to TRAIN_RWKV_LAYERS of its 32 layers
    (``kw`` replaced too)."""
    from repro_torch.config import get_config
    return dataclasses.replace(get_config("rwkv6_3b"), **{
        "n_layers": TRAIN_RWKV_LAYERS, **kw})


def rwkv_kernel_class(name: str) -> str:
    """Where an RWKV training step's device activity goes: K5's backward or
    forward, a cuBLAS GEMM, the loss's (log-)softmax, or the rest."""
    if K5_BWD_KERNEL.search(name):
        return "k5_bwd"
    if K5_FWD_KERNEL.search(name):
        return "k5_fwd"
    if re.search(GEMM_KERNELS, name):
        return "gemm"
    return "softmax" if re.search("softmax", name, re.I) else "rest"


def train_rwkv_step_profile(dev) -> dict:
    """The train_rwkv path's model (``train_rwkv_config``, bf16) in the
    profiling child, after a warm-up step: "k5", [[(kernel, us)] per step],
    K5's device kernels in each of TRAIN_PROFILED steps, each profiled
    alone; "split_ms", the device ms a step by ``rwkv_kernel_class``."""
    import torch

    from repro_torch.data import SyntheticLMData
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import lm
    from repro_torch.optim import adamw_init

    cfg = train_rwkv_config()
    model = lm.LM.init(cfg, torch.Generator(device=dev).manual_seed(0),
                       dev).requires_grad_(True)
    opt = adamw_init(model.param_list())
    step = steps_mod.build_train_step(cfg, model)
    ds = SyntheticLMData(vocab=cfg.vocab, seq_len=TRAIN_S, batch=TRAIN_B)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in ds.batch_at(0).items()}
    step(model, opt, batch)
    k5, split, walls = [], collections.Counter(), []
    for _ in range(TRAIN_PROFILED):
        acts, wall = device_kernels(lambda: step(model, opt, batch))
        k5.append([[short_name(n_), us] for n_, us in kernel_names(acts)
                   if rwkv_kernel_class(n_).startswith("k5")])
        for n_, us in acts:
            split[rwkv_kernel_class(n_)] += us / 1e3 / TRAIN_PROFILED
        walls.append(wall)
    del model, opt
    torch.cuda.empty_cache()
    return {"k5": k5, "split_ms": dict(split), "profiled_wall_ms": walls}


def k5_bwd_inputs(dev, B: int, S: int, dtype, w, with_state: bool,
                  seed: int, hd: int = 0) -> tuple:
    """At rwkv6-3b's heads (``hd``: its D cut into heads of hd instead): r,
    k, v (``dtype``) and w (f32) as (B, H, S, hd) views of (B, S, D)
    tensors, u, s0 (or None), the output's cotangent (``dtype``, a view
    likewise) and the final state's (or None).  ``w``: a constant, or
    "model", the time mix's exp(-exp(x - 4)) on x ~ N(0, 1)."""
    import torch

    from repro_torch.config import get_config

    cfg = get_config("rwkv6_3b")
    hd = hd or cfg.rwkv_head_dim
    H = cfg.d_model // hd
    D = H * hd
    g = torch.Generator(device=dev).manual_seed(seed)

    def heads(t):
        return t.view(B, S, H, hd).transpose(1, 2)

    def randn(shape):
        return torch.randn(shape, generator=g, device=dev)
    r, k, v, dout = (heads(randn((B, S, D)).to(dtype)) for _ in range(4))
    ww = torch.exp(-torch.exp(randn((B, S, D)) - 4.0)) if w == "model" \
        else torch.full((B, S, D), w, device=dev)
    u = randn((H, hd)) * 0.1
    s0 = randn((B, H, hd, hd)) if with_state else None
    ds = randn((B, H, hd, hd)) if with_state else None
    return [r, k, v, heads(ww)], u, s0, dout, ds


def k5_bwd_case(dev, dtype, w, with_state: bool, seed: int,
                hd: int = 0) -> dict:
    """K5's backward on rwkv6-3b's heads (``hd``: its D at that head dim)
    on K5_BWD_B x K5_BWD_S tokens, bf16 or f32 views, against autograd of
    the per-token ``wkv6_plain``; a second call bitwise the first; the
    launches of its route (``wkv6.bwd_route``); each gradient finite and
    within K5_BWD_TOL of its largest entry, and each limit shown to reject
    the gradient of a call that lost the first chunk's contribution (its
    tokens' output cotangent dropped), each of dr, dk, dv and dw the
    gradient of a call that dropped the cross-window terms of window
    K5_BWD_DROPPED_WINDOW of the first chunk (its tokens' gradients those
    of the window alone, from a zero state and no gradient past it; du and
    ds0 take no cross-window product) and, where a cluster's ranks split
    the state (hd 128), the gradient of a call that lost rank
    K5_BWD_LOST_RANK's partial sums (``wkv6_bwd_windowed_plain``'s
    ``lose_rank``)."""
    import torch

    from repro_torch.kernels import wkv6 as wk

    dt = str(dtype).removeprefix("torch.")
    xs, u, s0, dout, ds = k5_bwd_inputs(dev, K5_BWD_B, K5_BWD_S, dtype, w,
                                        with_state, seed, hd)
    hd = xs[0].shape[-1]
    route = wk.bwd_route(hd)
    wk.LAUNCHES.clear()
    got = wk.wkv6_bwd(*xs, u, s0, dout, ds)
    again = wk.wkv6_bwd(*xs, u, s0, dout, ds)
    torch.cuda.synchronize()
    n = dict(wk.LAUNCHES)
    what = (f"K5 bwd [{route}] {dt} ({K5_BWD_B}, {xs[0].shape[1]}, "
            f"{K5_BWD_S}, {hd}) w={w} "
            f"{'with' if with_state else 'without'} s0 and ds_fin")
    if n != {wk.BWD_COUNT[route]: 2 * wk.BWD_LAUNCHES}:
        fail(f"{what}: launches {n}, expected {2 * wk.BWD_LAUNCHES} under "
             f"{wk.BWD_COUNT[route]!r}")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"{what}: a second call on the same inputs differs from the "
             "first")
    chunk = wk.BWD_CHUNK[hd]

    def plain_grads(drop: bool):
        ins = [t.detach().float().requires_grad_() for t in (*xs, u)]
        if with_state:
            ins.append(s0.detach().clone().requires_grad_())
        o, s_ = wk.wkv6_plain(*ins[:5], ins[5] if with_state else None)
        d = dout.float().clone()
        if drop:
            d[:, :, :chunk] = 0
        outs, cots = ([o, s_], [d, ds]) if with_state else ([o], [d])
        return torch.autograd.grad(outs, ins, cots)

    def window_alone(want):
        """``want`` with window K5_BWD_DROPPED_WINDOW's dr, dk, dv, dw those
        of its tokens run alone: its cross-window terms dropped."""
        lo = K5_BWD_DROPPED_WINDOW * wk.BWD_WINDOW
        hi = lo + wk.BWD_WINDOW
        ins = [t.detach()[:, :, lo:hi].float().requires_grad_() for t in xs]
        o, _ = wk.wkv6_plain(*ins, u.detach())
        alone = torch.autograd.grad([o], ins, [dout[:, :, lo:hi].float()])
        out = [g.clone() for g in want[:4]]
        for g, a in zip(out, alone):
            g[:, :, lo:hi] = a
        return out

    names = ("dr", "dk", "dv", "dw", "du", "ds0")
    tol = K5_BWD_TOL[dt]
    want = plain_grads(False)
    errs, scale = {}, {}
    for name, a, b, x in zip(names, got, want, (*xs, u, s0)):
        if a.dtype != x.dtype or a.shape != x.shape:
            fail(f"{what}: {name} is {a.dtype} {tuple(a.shape)}, its input "
                 f"{x.dtype} {tuple(x.shape)}")
        if not torch.isfinite(a).all():
            fail(f"{what}: {name} is not finite")
        errs[name] = (a.float() - b).abs().max().item()
        scale[name] = b.abs().max().item()
        if not errs[name] <= tol[name] * scale[name]:
            fail(f"{what}: {name} differs from autograd of the plain version"
                 f" by {errs[name]:.3g}, over {tol[name]} of its largest "
                 f"entry {scale[name]:.3g}")
    for name, a, b in zip(names, plain_grads(True), want):
        if (a - b).abs().max().item() <= tol[name] * scale[name]:
            fail(f"{what}: the limit {tol[name]} on {name} accepts the "
                 f"gradient with the first chunk ({chunk} tokens) lost")
    gaps = {}
    for name, a, b in zip(names, window_alone(want), want):
        gaps[name] = (a - b).abs().max().item()
        if gaps[name] <= tol[name] * scale[name]:
            fail(f"{what}: the limit {tol[name]} on {name} accepts the "
                 f"gradient with window {K5_BWD_DROPPED_WINDOW}'s "
                 "cross-window terms dropped")
    dropped = (f"; each limit on dr, dk, dv, dw rejects the gradient with "
               f"window {K5_BWD_DROPPED_WINDOW}'s cross-window terms "
               f"dropped (max |diff| " + ", ".join(
                   f"{k_} {v_:.3g}" for k_, v_ in gaps.items()) + ")")
    if wk.BWD_RANKS[hd] > 1:
        lost = wk.wkv6_bwd_windowed_plain(
            *(t.detach() for t in xs), u.detach(), s0, dout, ds, chunk,
            lose_rank=K5_BWD_LOST_RANK)
        gaps = {}
        for name, a, b in list(zip(names, lost, want))[:4]:
            gaps[name] = (a - b).abs().max().item()
            if gaps[name] <= tol[name] * scale[name]:
                fail(f"{what}: the limit {tol[name]} on {name} accepts the "
                     f"gradient with rank {K5_BWD_LOST_RANK}'s partial sums "
                     "lost")
        dropped += (f"; each limit on dr, dk, dv, dw rejects the gradient "
                    f"with rank {K5_BWD_LOST_RANK} of {wk.BWD_RANKS[hd]}'s "
                    f"partial sums lost (max |diff| " + ", ".join(
                        f"{k_} {v_:.3g}" for k_, v_ in gaps.items()) + ")")
    print(f"check: {what}, views: every gradient == autograd of the plain "
          f"version within its limit of its largest entry and bitwise the "
          f"same in a second call (max |diff| "
          + ", ".join(f"{k_} {e:.3g} of {scale[k_]:.3g} (limit "
                      f"{tol[k_]})" for k_, e in errs.items())
          + f"); each limit rejects the gradient with the first chunk of "
          f"{chunk} tokens lost{dropped}; launches {n}")
    return {"errs": errs, "scale": scale, "route": route, "hd": hd}


def k5_bwd_checks(dev) -> dict:
    """Path 14's kernel checks: ``k5_bwd_case`` in f32 and bf16, with and
    without s0 and a final-state gradient, at rwkv6-3b's heads at each of
    K5_BWD_DECAYS, and at its width in heads of K5_BWD_MORE_HDS at
    K5_BWD_MORE_DECAYS."""
    import torch

    cases = [(64, dt, w, st) for dt in ("float32", "bfloat16")
             for w in K5_BWD_DECAYS for st in (False, True)]
    cases += [(hd, dt, w, st) for hd in K5_BWD_MORE_HDS
              for dt in ("float32", "bfloat16")
              for w in K5_BWD_MORE_DECAYS for st in (False, True)]
    out = {}
    for i, (hd, dt, w, st) in enumerate(cases):
        out[f"hd{hd}/{dt}/{w}/{'state' if st else 'none'}"] = k5_bwd_case(
            dev, getattr(torch, dt), w, st, seed=40 + i, hd=hd)
        torch.cuda.empty_cache()
    return out


def k5_bwd_profile(dev) -> dict:
    """{"hd<hd>/<shape>": [[(kernel, us)] per call]}: K5's backward at each
    head dim on each of K5_BWD_TOKENS (``k5_bwd_timed_inputs``),
    K4_BWD_PROFILED_CALLS calls, each profiled alone."""
    from repro_torch.kernels import wkv6 as wk

    out = {}
    for hd in (64, *K5_BWD_MORE_HDS):
        for key in K5_BWD_TOKENS:
            xs, u, _, dout, _ = k5_bwd_timed_inputs(dev, hd, key)
            wk.wkv6_bwd(*xs, u, None, dout)
            out[f"hd{hd}/{key}"] = [
                [[short_name(n_), us] for n_, us in kernel_names(
                    device_kernels(lambda: wk.wkv6_bwd(*xs, u, None,
                                                       dout))[0])]
                for _ in range(K4_BWD_PROFILED_CALLS)]
            del xs, dout
    return out


def k5_bwd_timed_inputs(dev, hd: int, key: str) -> tuple:
    """``k5_bwd_inputs`` at the timed shape ``key`` of K5_BWD_TOKENS (2
    rows of rwkv6-3b's width in heads of ``hd``): bf16 views, the model's
    decays, no s0 or final-state gradient (seed 21: the train shape's
    inputs at hd 64 are those timed before)."""
    import torch
    return k5_bwd_inputs(dev, TRAIN_B, K5_BWD_TOKENS[key], torch.bfloat16,
                         "model", False, seed=21, hd=hd)


def train_rwkv_path(dev, prof: dict) -> dict:
    """Path 14: rwkv6-3b at its published widths cut to TRAIN_RWKV_LAYERS
    layers (bf16, remat "full") trained TRAIN_STEPS steps on TRAIN_B x
    TRAIN_S tokens of ``SyntheticLMData`` by ``launch.train.train``; every
    layer's time mix runs K5's sequence form twice a step (remat) and its
    backward once."""
    import torch

    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.launch import train
    from repro_torch.models import lm

    cfg = train_rwkv_config()
    hd = cfg.rwkv_head_dim
    H = cfg.d_model // hd
    L = cfg.n_layers
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()     # earlier paths' tensors
    zero_model_counts()
    t0 = time.perf_counter()
    res = train.train(cfg, steps=TRAIN_STEPS, batch=TRAIN_B, seq=TRAIN_S,
                      log_every=1, seed=0, device=dev)
    secs = time.perf_counter() - t0
    n = model_counts()
    peak = torch.cuda.max_memory_allocated()
    print("train_rwkv path launches: " + json.dumps(n, sort_keys=True))
    route = wk.bwd_route(hd)
    bwd_key = "k5/" + wk.BWD_COUNT[route]
    per_step = {"k5/sequence": 2 * wk.SEQUENCE_LAUNCHES * L,
                bwd_key: wk.BWD_LAUNCHES * L}
    want = {k: TRAIN_STEPS * v for k, v in per_step.items()}
    if n != want:
        fail(f"train_rwkv path launches {n}, expected {want} ({TRAIN_STEPS} "
             f"steps x {per_step})")
    tprof = prof["train_rwkv_step"]
    seen = [collections.Counter(rwkv_kernel_class(n_) for n_, _ in s)
            for s in tprof["k5"]]
    most = {c: max(s[c] for s in seen) for c in ("k5_fwd", "k5_bwd")}
    if most != {"k5_fwd": per_step["k5/sequence"],
                "k5_bwd": per_step[bwd_key]}:
        fail(f"train_rwkv path: the profiling child saw K5 kernels {seen} in "
             f"its profiled steps, expected {per_step} a step")
    bwd_names = sorted({n_ for s in tprof["k5"] for n_, _ in s
                        if K5_BWD_KERNEL.search(n_)})
    ran = {K5_BWD_ROUTE_KERNEL[route].search(n_).group(1)
           for n_ in bwd_names if K5_BWD_ROUTE_KERNEL[route].search(n_)}
    if len(ran) != wk.BWD_LAUNCHES or len(ran) != len(bwd_names):
        fail(f"train_rwkv path: the step's backward ran {bwd_names}, not "
             f"the {wk.BWD_LAUNCHES} kernels of its {route} route alone")
    losses = res["losses"]
    if not all(math.isfinite(x) for x in losses) or not \
            losses[-1] < losses[0]:
        fail(f"train_rwkv path: losses {losses} are not finite and falling")
    b0 = {k: torch.as_tensor(v, device=dev) for k, v in SyntheticLMData(
        vocab=cfg.vocab, seq_len=TRAIN_S, batch=TRAIN_B, seed=0
    ).batch_at(0).items()}
    with torch.no_grad():
        again = lm.loss_fn(cfg, res["model"], b0).item()
    if not again < losses[0]:
        fail(f"train_rwkv path: the trained model's loss on the first "
             f"step's batch is {again}, the initial model's {losses[0]}")
    n_params = sum(p.numel() for p in res["model"].param_list())
    gathered = 0 if cfg.tie_embeddings else res["model"].embed.numel()
    tokens = TRAIN_B * TRAIN_S
    ms = statistics.median(res["step_s"][TRAIN_WARMUP:]) * 1e3
    # K5 on the fp32 CUDA cores: the forward's 5 flops per state entry and
    # token twice (remat), the backward's K5_BWD_FLOPS once
    k5_flops = L * (2 * 5 + K5_BWD_FLOPS) * tokens * H * hd * hd
    gemm_flops = 6 * (n_params - gathered) * tokens
    b_ms = (gemm_flops / BF16_FLOP_PER_S + k5_flops / FP32_FLOP_PER_S) * 1e3
    split = tprof["split_ms"]
    busy = sum(split.values())
    share = split.get("k5_bwd", 0.0) / busy
    print(f"train_rwkv: rwkv6-3b full width, {L} of 32 layers, "
          f"{n_params:,} parameters, bf16, remat {cfg.remat}: {TRAIN_STEPS} "
          f"steps on {TRAIN_B} x {TRAIN_S} tokens in {secs:.1f} s; "
          f"{ms:.2f} ms a step (median after {TRAIN_WARMUP} warm-up; "
          + ", ".join(f"{x * 1e3:.1f}" for x in res["step_s"])
          + f"), {tokens / ms * 1e3:.0f} tokens/s; operations bound "
          f"{b_ms:.2f} ms (6 x {n_params - gathered:,} parameters (the "
          f"{gathered:,}-entry embedding, a gather, left out) x tokens = "
          f"{gemm_flops / 1e12:.2f} TFLOP at 989 TFLOP/s, + K5 "
          f"{k5_flops / 1e12:.3f} TFLOP at 67 TFLOP/s on the fp32 CUDA "
          f"cores), {b_ms / ms:.1%} of it; peak memory "
          f"{peak / 2**30:.1f} GiB ({held / 2**30:.1f} GiB of it held by "
          f"earlier paths' tensors when the path began); losses "
          + ", ".join(f"{x:.4f}" for x in losses)
          + f"; on the first step's batch {losses[0]:.4f} before, "
          f"{again:.4f} after")
    print(f"train_rwkv: where a step goes (profiling child, {TRAIN_PROFILED} "
          f"steps): device busy {busy:.2f} ms of the profiled wall "
          + ", ".join(f"{x:.2f}" for x in tprof["profiled_wall_ms"])
          + " ms; " + ", ".join(f"{k} {v:.2f} ms ({v / busy:.0%})" for k, v
                                 in sorted(split.items(), key=lambda kv:
                                           -kv[1]))
          + f"; K5's backward {share:.1%} of the device busy time")
    print(f"check: train_rwkv: every loss finite, the last "
          f"({losses[-1]:.4f}) below the first ({losses[0]:.4f}); on the "
          f"first step's batch the trained model's loss {again:.4f} below "
          f"the initial {losses[0]:.4f}; K5 launches per step {per_step} by "
          f"the wrappers, kernels {most} most seen by the profiler in the "
          f"profiling child's steps; the backward's kernels "
          + ", ".join(bwd_names) + f" (its {route} route alone)")
    del res
    torch.cuda.empty_cache()
    return {"launches": n[bwd_key], "ms_per_step": ms, "bound_ms": b_ms,
            "peak_bytes": peak, "losses": losses, "first_batch_after": again,
            "split_ms": split, "k5_bwd_share": share}


def k5_bwd_entries(dev, cases: dict, launches: int, prof: dict) -> list:
    """The backward's ``kernels`` entries, one a head dim and timed shape
    (``k5_bwd_timed_inputs``: rwkv6-3b's width on K5_BWD_TOKENS tokens a
    row; hd 64 on the "ii" shape is the train_rwkv path's): each held
    against its plain version (``wkv6_bwd_windowed_plain``) and timed
    beside it; each kernel's device time off the profiler in the profiling
    child; the walk's registers and spills (ptxas) and blocks an SM.
    ``launches``: hd 64's from the path, every other head dim's from its
    checks.  The bound: r, k, v, dout and w read once, dr, dk, dv, dw, du
    and ds0 written once; K5_BWD_FLOPS per state entry and token at the
    rate of the units that do the hd^2 work, three TF32 passes on the
    tensor cores (the fp32 CUDA cores' bound beside it)."""
    import torch

    from repro_torch.kernels import wkv6 as wk

    if launches < 1:
        fail("K5 bwd was not launched on its path")
    route = wk.bwd_route(64)
    px = ptxas_kernels(build_log(wk.BWD_TC_LIB_NAME,
                                 wk.bwd_tc_kernel_source()),
                       r"wkv6_bwd_tc_\w+?_kernel")
    spilled = [x for x in px if not x.endswith(" 0 B spilled")]
    if not px or spilled:
        fail(f"K5 bwd: ptxas reports {spilled or 'no kernel'} (every "
             "instantiation must spill 0 B)")
    print(f"check: K5 bwd: every instantiation of {wk.BWD_TC_LIB_NAME} "
          f"spills 0 B (ptxas): " + " | ".join(px))
    tol = K5_BWD_TOL["bfloat16"]
    entries = []
    for hd in (64, *K5_BWD_MORE_HDS):
        blocks = wk.walk_blocks_per_sm(hd, torch.bfloat16)
        walk_px = [x for x in px if re.match(
            rf"wkv6_bwd_tc_(walk|cluster)_kernel<bf16,{hd}>", x)]
        hd_cases = {k: c for k, c in cases.items() if c["hd"] == hd}
        n_calls = launches if hd == 64 else \
            sum(2 * wk.BWD_LAUNCHES for _ in hd_cases)
        for key in K5_BWD_TOKENS:
            if hd == 64 and key == "i":
                continue                # hd 64's checks' shape: its checks
            xs, u, _, dout, _ = k5_bwd_timed_inputs(dev, hd, key)
            B, H, S, _ = xs[0].shape
            D = H * hd
            chunk = wk.BWD_CHUNK[hd]
            got = wk.wkv6_bwd(*xs, u, None, dout)
            want = wk.wkv6_bwd_windowed_plain(*xs, u, None, dout, None,
                                              chunk)
            errs = {}
            for name, a, b in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got,
                                  want):
                errs[name] = (a.float() - b).abs().max().item()
                if not errs[name] <= tol[name] * b.abs().max().item():
                    fail(f"K5 bwd hd {hd} ({B}, {H}, {S}, {hd}): {name} "
                         f"differs from the plain version by "
                         f"{errs[name]:.3g}")
            del got, want
            torch.cuda.empty_cache()
            ms, host_ms = time_ms(lambda: wk.wkv6_bwd(*xs, u, None, dout), 10)
            plain_ms = time_ms(lambda: wk.wkv6_bwd_windowed_plain(
                *xs, u, None, dout, None, chunk), 2, warmup=1)[0]
            torch.cuda.empty_cache()
            # r, k, v, dout read and dr, dk, dv written in bf16; w read and
            # dw written in f32; u, du and ds0 in f32
            nbytes = (7 * 2 + 2 * 4) * B * S * D + 2 * 4 * H * hd \
                + 4 * B * H * hd * hd
            flops = K5_BWD_FLOPS * B * H * S * hd * hd
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            tc_ms = 3 * flops / TF32_FLOP_PER_S * 1e3
            cc_ms = flops / FP32_FLOP_PER_S * 1e3
            b_ms, b_by = (bytes_ms, "bytes") if bytes_ms >= tc_ms else \
                (tc_ms, "operations")
            calls = prof["k5_bwd"][f"hd{hd}/{key}"]
            split_ms = {}
            for name in sorted({n_ for c_ in calls for n_, _ in c_}):
                split_ms[name] = statistics.median(
                    sum(us for n_, us in c_ if n_ == name) for c_ in calls) \
                    / 1e3
            if len(split_ms) != wk.BWD_LAUNCHES or not all(
                    K5_BWD_ROUTE_KERNEL[route].search(n_) for n_ in split_ms):
                fail(f"K5 bwd hd {hd}: the profiled calls ran {split_ms}, "
                     f"not the {wk.BWD_LAUNCHES} kernels of its {route} "
                     "route")
            worst = max(max(c["errs"].values()) for c in hd_cases.values())
            where = "the train_rwkv path" if hd == 64 else \
                f"its {len(hd_cases)} checks' calls"
            print(f"time: K5 bwd [{route}] bf16 ({B}, {H}, {S}, {hd}), "
                  f"views, the model's decays, chunks of {chunk}"
                  + (f" over a cluster of {wk.BWD_RANKS[hd]} CTAs"
                     if wk.BWD_RANKS[hd] > 1 else "")
                  + f": {ms:.4f} ms on the card, {host_ms:.4f} ms host per "
                  f"call (bound {b_ms:.4f} ms by {b_by}: {nbytes / 1e6:.1f} "
                  f"MB at 3.35 TB/s {bytes_ms:.4f} ms, {flops / 1e9:.2f} "
                  f"GFLOP in three TF32 passes at 495 TFLOP/s {tc_ms:.4f} "
                  f"ms; {b_ms / ms:.1%}; on the fp32 CUDA cores "
                  f"{cc_ms:.4f} ms, {cc_ms / ms:.1%}); by kernel (profiler) "
                  + ", ".join(f"{n_} {v_:.4f} ms" for n_, v_ in
                              split_ms.items())
                  + f"; plain {plain_ms:.3f} ms; no PyTorch call computes "
                  f"it; launches on {where} {n_calls} ({wk.BWD_LAUNCHES} a "
                  f"call); against the plain version here (max |diff|) "
                  + ", ".join(f"{k_} {e:.3g}" for k_, e in errs.items())
                  + f"; the walk {blocks} block(s) an SM; ptxas "
                  + " | ".join(walk_px))
            entries.append({
                "name": f"wkv6_bwd[{route}]" + ("" if hd == 64 else
                                                f"[hd {hd}, {key}]"),
                "route": "cuda",
                "source": "src/repro_torch/csrc/wkv6_bwd_tc.cu",
                "replaces": K5_BWD_REPLACES, "launches": n_calls,
                "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                "library": "no PyTorch call computes it", "host_ms": host_ms,
                "cuda_core_bound_ms": cc_ms, "bytes": nbytes, "flops": flops,
                "shape": [B, H, S, hd], "chunk": chunk,
                "window": wk.BWD_WINDOW, "ranks": wk.BWD_RANKS[hd],
                "launches_per_call": wk.BWD_LAUNCHES,
                "kernel_ms": split_ms, "timed_shape_errors": errs,
                "check_errors": {k: c["errs"] for k, c in hd_cases.items()},
                "tolerance": K5_BWD_TOL, "ptxas": px,
                "walk_blocks_per_sm": blocks,
                "path": "train_rwkv" if hd == 64 else "train_rwkv checks"})
            del xs, dout
    return entries


def sharded_config():
    """The sharded path's model: ``train_config`` at SHARDED_LAYERS."""
    return train_config(n_layers=SHARDED_LAYERS)


def sharded_mesh(dev, tmp: str):
    """The (1, 1) ("data", "model") mesh over this one process: NCCL on the
    card (gloo for CPU rehearsals), the rendezvous a FileStore in
    ``tmp``."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_mod
    mesh_mod.init_distributed(dev.type, rank=0, world_size=1,
                              store=dist.FileStore(os.path.join(tmp, "store"),
                                                   1))
    return mesh_mod.make_test_mesh(1, 1, device=dev.type)


def sharded_step_profile(dev) -> dict:
    """The sharded path's model in the profiling child: for the one-device
    step and the (1, 1) mesh's, after a warm-up step each, K4's wrapper
    launches in one step ("launches") and the K4 kernels the profiler sees
    in another ("k4")."""
    import torch
    import torch.distributed as dist

    from repro_torch.config import ShapeConfig
    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import lm
    from repro_torch.optim import adamw_init

    cfg = sharded_config()
    host = SyntheticLMData(vocab=cfg.vocab, seq_len=TRAIN_S,
                           batch=TRAIN_B).batch_at(0)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in host.items()}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        mesh = sharded_mesh(dev, tmp)
        try:
            model = lm.LM.init(cfg, torch.Generator(device=dev).manual_seed(
                0), dev).requires_grad_(True)
            opt = adamw_init(model.param_list())
            single = steps_mod.build_train_step(cfg, model)
            step, (pspecs, ospecs, bspecs), _, _ = \
                steps_mod.build_train_step(cfg, ShapeConfig(
                    "sharded", "train", TRAIN_S, TRAIN_B), mesh)
            fresh = adamw_init(model.param_list())
            params = steps_mod.shard_list(model.param_list(), pspecs, mesh)
            sopt = {"m": steps_mod.shard_list(fresh["m"], ospecs["m"], mesh),
                    "v": steps_mod.shard_list(fresh["v"], ospecs["v"], mesh),
                    "count": fresh["count"]}
            runs = {"single": lambda: single(model, opt, batch),
                    "sharded": lambda: step(params, sopt,
                                            steps_mod.local_batch(
                                                host, bspecs, mesh, dev))}
            for name, fn in runs.items():
                fn()
                torch.cuda.synchronize()
                fa.LAUNCHES.clear()
                fn()
                torch.cuda.synchronize()
                launches = {f"k4/{k}": v for k, v in fa.LAUNCHES.items()}
                acts, _ = device_kernels(fn)
                out[name] = {"launches": launches, "k4": [
                    short_name(n_) for n_, _ in kernel_names(acts)
                    if K4_KERNEL.search(n_)]}
            del model, opt, params, sopt, fresh
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    return out


def sharded_path(dev, prof: dict, card: str) -> dict:
    """Path 15: the one-device trainer and the (1, 1) mesh's from the same
    seed, SHARDED_STEPS steps each, bitwise the same; K4's launches the same
    (here and in the profiling child); the mesh's prefill step bitwise
    ``lm.forward`` and its decode step ``lm.decode_step``
    (``sharded_decode``); the collective helpers on card tensors; the same
    llama3-8b under the "fsdp" style; then SHARDED_FAMILIES' training
    checks.  Returns the ms of each run's
    steps, by run ("single", "sharded")."""
    import torch
    import torch.distributed as dist

    from repro_torch.config import ShapeConfig
    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import lm

    cfg = sharded_config()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        mesh = sharded_mesh(dev, tmp)
        try:
            fwd_call = fa.fwd_launches(torch.bfloat16, cfg.hd, TRAIN_B,
                                       cfg.n_heads, cfg.n_kv_heads, TRAIN_S)
            runs = sharded_train(dev, mesh, cfg, sharded_launches(cfg), card,
                                 keep=True)
            one, many, ms = runs["single"], runs["sharded"], runs["ms"]
            sp_ = prof["sharded_step"]
            seen = {k: collections.Counter("bwd" if "fa_bwd" in n_ else "fwd"
                                           for n_ in v["k4"])
                    for k, v in sp_.items()}
            if sp_["single"]["launches"] != sp_["sharded"]["launches"] or \
                    seen["single"] != seen["sharded"] or not seen["single"]:
                fail(f"sharded path: the profiling child's K4 launches "
                     f"{ {k: v['launches'] for k, v in sp_.items()} }, K4 "
                     f"kernels seen {seen}: the two steps must match")
            print(f"check: sharded: the profiling child's step: launches "
                  f"{sp_['sharded']['launches']} on both, K4 kernels seen "
                  f"{dict(seen['sharded'])} on both")
            # the prefill step the builders make for the mesh
            tokens = SyntheticLMData(vocab=cfg.vocab, seq_len=TRAIN_S,
                                     batch=TRAIN_B, seed=3).batch_at(0)[
                                         "tokens"]
            pre, (_, bspecs), _, _ = steps_mod.build(
                cfg, ShapeConfig("sharded", "prefill", TRAIN_S, TRAIN_B),
                mesh)
            with torch.no_grad():
                zero_model_counts()
                got = pre(many["params"], steps_mod.local_batch(
                    {"tokens": tokens}, bspecs, mesh, dev))
                torch.cuda.synchronize()
                n_pre = model_counts()
                want = lm.forward(cfg, one["model"], {
                    "tokens": torch.as_tensor(tokens, device=dev)})
            if not torch.equal(got, want):
                fail("sharded path: the mesh's prefill step differs from "
                     f"lm.forward (max {(got - want).abs().max().item()})")
            if n_pre != {"k4/wgmma/bfloat16": cfg.n_layers * fwd_call}:
                fail(f"sharded path: the mesh's prefill launched {n_pre}")
            del got, want
            torch.cuda.empty_cache()
            print(f"check: sharded: the prefill step of steps.build(cfg, "
                  f"prefill {TRAIN_B} x {TRAIN_S}, mesh) == lm.forward "
                  f"bitwise; launches {n_pre}")
            sharded_decode(dev, mesh, cfg, one["model"], many["params"])
            del runs, one, many
            torch.cuda.empty_cache()
            sharded_helpers(dev, mesh, cfg)
            # the ZeRO-3 style: each layer's weights gathered at the layer
            # (nothing to gather at one rank: the one-device step's ops)
            fsdp = dataclasses.replace(cfg, parallel_style="fsdp")
            sharded_train(dev, mesh, fsdp, sharded_launches(fsdp), card)
            for arch in SHARDED_FAMILIES:
                fcfg = cut_config(arch, SHARDED_LAYERS)
                b_, s_ = SHARDED_TOKENS.get(arch, (TRAIN_B, TRAIN_S))
                sharded_train(dev, mesh, fcfg, sharded_launches(fcfg, b_, s_),
                              card, tokens=(b_, s_))
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    return ms


def cut_config(arch: str, layers: int, reduced: bool = False):
    """``arch`` at its published widths (or ``reduced``) cut to ``layers``
    layers (Whisper's encoder too; Jamba's period to ``layers``, its
    attention last, so that a Mamba layer with its MoE and the attention
    layer with its MLP remain) and, published with routed experts, to
    CUT_EXPERTS of them; chunked attention (K4) but for the MLA of
    DeepSeek-V2 and Kimi-K2, which takes none.  Path 15 and
    ``tools/multi_card.py`` train and decode these cuts."""
    from repro_torch.config import get_config
    cfg = dataclasses.replace(get_config(arch, reduced=reduced),
                              n_layers=layers)
    if cfg.family == "encdec":
        cfg = dataclasses.replace(cfg, n_enc_layers=layers)
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, period=layers,
                                  attn_positions=(layers - 1,))
    if cfg.family in ("dense", "hybrid", "encdec", "vlm"):
        cfg = dataclasses.replace(cfg, attn_impl="chunked")
    if cfg.moe is not None and not reduced:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=CUT_EXPERTS.get(arch, CUT_EXPERTS_DEFAULT)))
    return cfg


def sharded_launches(cfg, batch: int = TRAIN_B, seq: int = TRAIN_S) -> dict:
    """The kernel launches SHARDED_STEPS training steps of ``cfg`` on
    ``batch`` x ``seq`` tokens make: K4's forward twice a causal
    attention layer a step (the forward and its remat) and its backward
    once (llama3-8b, Jamba's attention layer, Whisper's decoder layers,
    whose encoder and cross attention take the plain ``_sdpa`` as the
    reference's, PaliGemma over its image and text positions); K5's
    sequence form twice a layer a step and its backward once (rwkv6-3b);
    none for DeepSeek-V2, whose MLA takes no kernel."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.models import lm
    if cfg.family == "ssm":
        n = SHARDED_STEPS * cfg.n_layers
        return {"k5/sequence": 2 * n * wk.SEQUENCE_LAUNCHES,
                f"k5/{wk.BWD_COUNT[wk.bwd_route(cfg.rwkv_head_dim)]}":
                    n * wk.BWD_LAUNCHES}
    n = SHARDED_STEPS * sum(mix == "attn" for mix, _ in lm.layer_specs(cfg))
    if not n or cfg.attn_impl != "chunked":
        return {}
    shape = (torch.bfloat16, cfg.hd, batch, cfg.n_heads, cfg.n_kv_heads, seq)
    return {"k4/wgmma/bfloat16": 2 * n * fa.fwd_launches(*shape),
            "k4/bwd/bfloat16": n * fa.bwd_launches(*shape)}


def sharded_decode(dev, mesh, cfg, model, params) -> None:
    """The mesh's decode step (``steps.build(cfg, decode shape, mesh)``)
    over SHARDED_DECODE_STEPS steps, the cache laid out by its specs,
    against ``lm.decode_step`` of the same weights (``model``, one-device;
    ``params``, the mesh's): every step's logits and the last cache
    bitwise, row r from position SHARDED_DECODE_POS + r; neither
    launches a kernel (the decode step's attention reads its cache
    without K4)."""
    import torch

    from repro_torch.config import ShapeConfig
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import lm
    from repro_torch.parallel import sharding
    g = torch.Generator().manual_seed(4)
    dec, (_, cspecs, bspecs), _, _ = steps_mod.build(
        cfg, ShapeConfig("sharded", "decode", TRAIN_S, TRAIN_B), mesh)
    one = lm.init_cache(cfg, TRAIN_B, TRAIN_S, dev)
    cache = {"blocks": [{k: sharding.shard(t.clone(), mesh, s[k])
                         for k, t in c.items()}
                        for c, s in zip(one["blocks"], cspecs["blocks"])]}
    zero_model_counts()
    with torch.no_grad():
        for t in range(SHARDED_DECODE_STEPS):
            host = {"token": torch.randint(0, cfg.vocab, (TRAIN_B, 1),
                                           generator=g, dtype=torch.int32),
                    "pos": torch.arange(TRAIN_B, dtype=torch.int32)
                    + SHARDED_DECODE_POS + t}
            got, cache = dec(params, cache, steps_mod.local_batch(
                host, bspecs, mesh, dev))
            want, one = lm.decode_step(cfg, model, one, host)
            if not torch.equal(got, want):
                fail(f"sharded path: the mesh's decode step {t} differs "
                     f"from lm.decode_step (max "
                     f"{(got - want).abs().max().item()})")
    torch.cuda.synchronize()
    n = model_counts()
    for c, w in zip(cache["blocks"], one["blocks"]):
        for k, t in c.items():
            if not torch.equal(t.to_local(), w[k]):
                fail(f"sharded path: the mesh's decode cache {k} differs "
                     "from lm.decode_step's")
    if n:
        fail(f"sharded path: the decode steps launched {n}")
    print(f"check: sharded: {SHARDED_DECODE_STEPS} steps of the decode step "
          f"of steps.build(cfg, decode {TRAIN_B} x {TRAIN_S}, mesh), the "
          f"cache in its blocks (positions from {SHARDED_DECODE_POS} up), "
          "== lm.decode_step bitwise, logits and cache; no kernel "
          "launched")


def sharded_train(dev, mesh, cfg, want: dict, card: str,
                  keep: bool = False, tokens: tuple = (TRAIN_B, TRAIN_S)
                  ) -> dict:

    """Path 15's training check for one model: ``cfg`` trained
    SHARDED_STEPS steps one-device and on the (1, 1) ``mesh`` from the
    same seed: losses, gradient norms, parameters, moments and the
    optimiser's count bitwise the same (the one-device run's copied to
    the host while the mesh's runs), ``want`` launched by both.  An MoE's
    runs take PyTorch's deterministic kernels
    (``torch.use_deterministic_algorithms``): the backward of its dispatch
    gather adds each token's slots with atomics on the card, in an order
    that differs from run to run, one-device too.  Returns the ms of each
    run's steps by run ("ms": {"single", "sharded"}) and, ``keep``, both
    runs' results under "single" and "sharded"; without it each run is
    freed before the next.  ``tokens``: (batch, sequence)."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import train

    def local(t):
        return (t.to_local() if hasattr(t, "to_local") else t).detach()
    runs, out, host, differ = {}, {}, [], []
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(cfg.moe is not None or
                                       deterministic, warn_only=True)
    for name, where in (("single", None), ("sharded", mesh)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_model_counts()
        res = train.train(cfg, steps=SHARDED_STEPS, batch=tokens[0],
                          seq=tokens[1], log_every=SHARDED_STEPS, seed=0,
                          device=dev, mesh=where)
        torch.cuda.synchronize()
        got = [local(t) for t in (*res["params"], *res["opt"]["m"],
                                  *res["opt"]["v"], res["opt"]["count"])]
        if where is None:
            host = [t.cpu() for t in got]
        else:
            differ = [i for i, (a, b) in enumerate(zip(host, got))
                      if not torch.equal(a.to(dev), b)]
        runs[name] = {"losses": res["losses"],
                      "grad_norms": res["grad_norms"],
                      "ms": [x * 1e3 for x in res["step_s"]],
                      "launches": model_counts(),
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "tensors": len(got)}
        if keep:
            out[name] = res
        del res, got
    torch.use_deterministic_algorithms(deterministic)
    del host
    torch.cuda.empty_cache()
    one, many = runs["single"], runs["sharded"]
    print(f"sharded path launches, {cfg.name}: " + json.dumps(
        {k: v["launches"] for k, v in runs.items()}, sort_keys=True))
    if one["launches"] != want or many["launches"] != want:
        fail(f"sharded path: {cfg.name}: launches "
             f"{ {k: v['launches'] for k, v in runs.items()} }; both "
             f"runs must launch {want}")
    if one["losses"] != many["losses"] or \
            one["grad_norms"] != many["grad_norms"]:
        fail(f"sharded path: {cfg.name}: losses {many['losses']} and "
             f"norms {many['grad_norms']} on the mesh, "
             f"{one['losses']} and {one['grad_norms']} on one device")
    if differ:
        fail(f"sharded path: {cfg.name}: {len(differ)} of "
             f"{one['tensors']} parameters, moments and the count differ "
             f"from the one-device run's (first {differ[:5]})")
    what = (f", {cfg.moe.n_experts} experts" if cfg.moe else "") + (
        f", {cfg.attn_impl}" if cfg.family == "dense" else "")
    print(f"sharded: {cfg.name} full width, {cfg.n_layers} layers{what}, "
          f"bf16, remat {cfg.remat}, {tokens[0]} x {tokens[1]} tokens; "
          f"{SHARDED_STEPS} steps one-device (ms "
          + ", ".join(f"{x:.2f}" for x in one["ms"])
          + f"; peak {one['peak_gb']:.2f} GB) and on "
          f"{mesh_mod.describe(mesh)} over {dist.get_backend()} "
          "(ms " + ", ".join(f"{x:.2f}" for x in many["ms"])
          + f"; peak {many['peak_gb']:.2f} GB); last step sharded / "
          f"one-device {many['ms'][-1] / one['ms'][-1]:.3f}; card {card}")
    print(f"check: sharded: {cfg.name}: losses "
          + ", ".join(f"{x:.6f}" for x in one["losses"])
          + f", gradient norms and all {one['tensors']} parameters, moments "
          f"and the count bitwise the one-device run's; launches "
          f"{want or 'none'} on both")
    out["ms"] = {k: v["ms"] for k, v in runs.items()}
    return out


def sharded_helpers(dev, mesh, cfg) -> None:
    """The collective helpers at one rank, on card tensors: ``ag_matmul``
    == the plain product, ``compressed_psum`` == its grid's plain value
    (quantize, sum of one, divide by 1), ``pipelined_forward`` ==
    ``reference_forward``, all bitwise."""
    import torch

    from repro_torch.parallel import collective_matmul, compression, pipeline
    g = torch.Generator(device=dev).manual_seed(1)
    D = cfg.d_model
    x = torch.randn((TRAIN_S, D), generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn((D, D), generator=g, device=dev) * D ** -0.5).to(
        torch.bfloat16)
    if not torch.equal(collective_matmul.ag_matmul(x, w, mesh, "model"),
                       x @ w):
        fail("sharded path: ag_matmul at one rank differs from x @ w")
    grads = [torch.randn((cfg.n_heads, D), generator=g, device=dev) * 1e-3,
             torch.randn((D,), generator=g, device=dev).to(torch.bfloat16)]
    got = compression.compressed_psum(grads, mesh.get_group("data"),
                                      torch.Generator(device=dev)
                                      .manual_seed(2))
    noise = torch.Generator(device=dev).manual_seed(2)
    worst = 0.0
    for leaf, out in zip(grads, got):
        q, sc = compression.quantize_int8(leaf.float(), noise)
        plain = (q.to(torch.int32).float() * sc / 1).to(leaf.dtype)
        if not torch.equal(out, plain):
            fail("sharded path: compressed_psum at one rank differs from "
                 "its grid's plain value")
        worst = max(worst, ((out.float() - leaf.float()).abs().max()
                            / leaf.float().abs().max()).item())
    if not worst < 0.02:
        fail(f"sharded path: compressed_psum is {worst:.3g} off the leaf")
    S_, M_ = mesh.size(0), 6
    params = {"w": torch.randn((S_, D, D), generator=g, device=dev)
              * D ** -0.5, "b": torch.randn((S_, D), generator=g,
                                            device=dev) * 0.1}
    mbs = torch.randn((M_, 8, D), generator=g, device=dev)

    def stage(p, x_):
        return torch.tanh(x_ @ p["w"] + p["b"])
    with torch.no_grad():
        out = pipeline.pipelined_forward(stage, params, mbs, mesh, "data")
        ref = pipeline.reference_forward(stage, params, mbs)
    if not torch.equal(out, ref):
        fail("sharded path: pipelined_forward at one stage differs from "
             "reference_forward")
    print(f"check: sharded: at one rank on card tensors, ag_matmul "
          f"({TRAIN_S} x {D} @ {D} x {D}, bf16) == x @ w, compressed_psum "
          f"== its grid's plain value (within {worst:.3g} of the leaf), "
          f"pipelined_forward ({M_} microbatches) == reference_forward, "
          "all bitwise")


def dryrun_cell(cell: str) -> dict:
    """One of DRYRUN_CELLS traced by ``repro_torch.launch.dryrun``: its
    record; path 15's cells also give their K4 nodes (forward, backward)
    and the parameters the operations bound counts."""
    import torch  # noqa: F401  (the dry-run's device follows its build)

    from repro_torch.config import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import lm

    t0 = time.perf_counter()
    if cell.endswith(":tuned"):
        from repro_torch.config import SHAPES, get_config, tune
        from repro_torch.launch import hlo_analysis
        from repro_torch.launch import mesh as mesh_mod
        arch, shape, mesh, _ = cell.split(":")
        multi = mesh == "multi"
        cfg = tune(get_config(arch), SHAPES[shape], 512 if multi else 256)
        with dryrun.dryrun_mesh(*mesh_mod.production_mesh_spec(multi)) as m:
            traced = dryrun.trace_step(cfg, SHAPES[shape], m)
            rec = dryrun.record(arch, shape, mesh, cfg, SHAPES[shape], m,
                                traced)
            rec["gather_bound"] = dryrun.gather_bound(cfg, m)
        live = hlo_analysis.live_at_peak(traced.gm)
        rec["live_gathers"] = live.get("all_gather_into_tensor", 0)
        rec["style"] = [cfg.parallel_style, cfg.remat]
    elif not cell.startswith("sharded"):
        arch, shape, mesh = cell.split(":")
        rec = dryrun.dryrun_cell(arch, shape, mesh == "multi")
    else:
        cfg = sharded_config()
        shape = ShapeConfig(cell, "train", TRAIN_S, TRAIN_B)
        n = 1 if cell == "sharded" else 2
        with dryrun.dryrun_mesh((n, n), ("data", "model")) as m:
            traced = dryrun.trace_step(cfg, shape, m)
            rec = dryrun.record("llama3_8b", cell, f"{n}x{n}", cfg, shape,
                                m, traced)
        ops = collections.Counter(str(n_.target)
                                  for n_ in traced.gm.graph.nodes)
        rec["k4_nodes"] = {
            "fwd": ops["repro_torch.flash_attention.default"]
            + ops["repro_torch.flash_attention_lse.default"],
            "bwd": ops["repro_torch.flash_attention_bwd.default"]}
        model = lm.LM(cfg, steps_mod.abstract_params(cfg))
        rec["params"] = sum(p.numel() for p in model.param_list())
        rec["gathered"] = 0 if cfg.tie_embeddings else model.embed.numel()
    rec["seconds"] = time.perf_counter() - t0
    return rec


def dryrun_main(cells) -> int:
    """``chip_smoke.py --dryrun CELL...``: each cell traced in turn on
    FakeTensors over a fake group of its mesh's size (``dryrun_cell``), in
    a process that holds no other group, at the lowest CPU priority (the
    children trace beside the card's timed paths, whose host-bound numbers
    they must not move); prints one JSON line, the records by cell."""
    os.nice(19)
    print(json.dumps({c: dryrun_cell(c) for c in cells}))
    return 0


def rwkv_cell_flops(cfg, shape, data: int, model: int) -> tuple:
    """(the matrix products' flops, K5's) a device of ``cfg``'s train step
    on a (data, model) mesh whose model axis splits the projections, the
    channel mix and the vocabulary but not the heads (rwkv6-3b's 40 on
    16): a layer's six D x D products and ``ck`` run forward, again under
    remat "full", and for both gradients (8 flops a weight and token),
    ``cv``, whose output the backward does not read, is not recomputed
    (6), the head 6; K5's forward twice and its backward, 5 + 5 + 14
    flops a state entry and token, on every head of the rank's batch."""
    D, F, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    tokens = shape.global_batch * shape.seq_len // (data * model)
    mm = (L * (48 * D * D + 14 * D * F) + 6 * cfg.vocab * D) * tokens
    k5 = L * 24 * shape.global_batch // data * cfg.d_model \
        * cfg.rwkv_head_dim * shape.seq_len
    return mm, k5


def rwkv_cell_check(rec: dict) -> None:
    """rwkv6-3b's train_4k on (16, 16), the "ssm" family's tensor-parallel
    step: its flops a device are ``rwkv_cell_flops``' count exactly.  That
    count is the port's own, from the layer's shapes: no figure of the
    reference's compiled step is held for this cell, so the check holds
    the graph to the split the layer means to make, not to the
    reference."""
    from repro_torch.config import SHAPES, get_config
    cfg, shape = get_config("rwkv6_3b"), SHAPES["train_4k"]
    mm, k5 = rwkv_cell_flops(cfg, shape, 16, 16)
    got = rec["flops_per_device"]
    zero3 = (mm * 16 + k5) / 1e12     # the model axis replicating all
    print(f"dryrun: rwkv6_3b:train_4k:single tensor-parallel: "
          f"{got / 1e12:.3f} TFLOP a device, the count {(mm + k5) / 1e12:.3f}"
          f" ({mm / 1e12:.3f} of products split 256 ways, {k5 / 1e12:.3f} "
          f"of K5 split over the data axis alone; the ZeRO-3 step's "
          f"{zero3:.3f}), temp_size {rec['memory']['temp_size'] / 1e9:.1f} "
          "GB")
    if got != mm + k5:
        fail(f"dryrun: rwkv6_3b:train_4k:single: {got} flops a device, "
             f"the count {mm + k5}")
    print("check: dryrun: rwkv6_3b:train_4k:single's flops a device are "
          "the port's own tensor-parallel count exactly (not a figure of "
          "the reference's compiled step)")


def dryrun_start(cells) -> list:
    """A ``--dryrun`` child for each list of ``cells``, started now:
    [(the process, its cells)].  Each is killed at exit, should a check
    end the script before ``dryrun_phase`` collects it."""
    out = [(subprocess.Popen([sys.executable, os.path.abspath(__file__),
                              "--dryrun", *c], stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True), c)
           for c in cells]
    for p_, _ in out:
        atexit.register(p_.kill)
    return out


def dryrun_phase(prof: dict, sharded_ms: dict, card: str,
                 procs: list) -> None:
    """The dry-run: DRYRUN_CELLS traced in the children ``procs``
    (``dryrun_start``), started together as the script does (the fake
    group shares no process with path 15's NCCL group).  (a) path 15's
    (1, 1) cell: its K4 nodes times the kernels a call launches equal the
    profiling child's launches of the same step on the card, its graph's
    flops ``FlopCounterMode``'s; its flops against PERF.md's operations
    bound, and the time the graph predicts beside the step's measured ms;
    (b) the production cells' records, memory beside the card's, the
    tensor-parallel train and prefill cells against the reference's flops
    and the ZeRO-3 step's temp_size (``DRYRUN_REFERENCE``), and the decode
    cell's all-gathered bytes against the step's that gathered its cache
    (``DRYRUN_DECODE_GATHER_GB``); (c) the phase's seconds."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    t0 = time.perf_counter()
    recs = {}
    try:
        for p_, cells in procs:
            out, err = p_.communicate(timeout=DRYRUN_TIMEOUT_S)
            if p_.returncode != 0:
                fail(f"dryrun: the child tracing {cells} exited "
                     f"{p_.returncode}: {err[-3000:]}")
            recs.update(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p_, _ in procs:
            p_.kill()
            p_.wait()
    wall = time.perf_counter() - t0
    cfg = sharded_config()
    for cell in ("sharded", "sharded_2x2"):
        rec = recs[cell]
        if rec["flops_per_device"] != rec["entry_cost_analysis"]["flops"]:
            fail(f"dryrun: {cell}: the graph counts "
                 f"{rec['flops_per_device']} flops, FlopCounterMode "
                 f"{rec['entry_cost_analysis']['flops']}")
    rec = recs["sharded"]
    per_call = fa.bwd_launches(torch.bfloat16, cfg.hd, TRAIN_B, cfg.n_heads,
                               cfg.n_kv_heads, TRAIN_S)
    fwd_call = fa.fwd_launches(torch.bfloat16, cfg.hd, TRAIN_B, cfg.n_heads,
                               cfg.n_kv_heads, TRAIN_S)
    graph = {"k4/wgmma/bfloat16": rec["k4_nodes"]["fwd"] * fwd_call,
             "k4/bwd/bfloat16": rec["k4_nodes"]["bwd"] * per_call}
    card_launches = prof["sharded_step"]["sharded"]["launches"]
    if graph != card_launches:
        fail(f"dryrun: the sharded step's graph holds K4 nodes "
             f"{rec['k4_nodes']} ({graph} launches at {fwd_call} a forward "
             f"and {per_call} a backward call); the profiling child's step "
             f"launched {card_launches}")
    kept = TRAIN_S * (TRAIN_S + 1) // 2 * TRAIN_B * cfg.n_heads
    bound = 6 * (rec["params"] - rec["gathered"]) * TRAIN_B * TRAIN_S \
        + cfg.n_layers * (4 + 10) * cfg.hd * kept
    flops, nbytes = rec["flops_per_device"], rec["hbm_bytes_per_device"]
    predicted = max(flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
    measured = sharded_ms["sharded"][-1]
    print(f"dryrun: sharded (path 15's cell: llama3-8b full width, "
          f"{cfg.n_layers} layers, {TRAIN_B} x {TRAIN_S} tokens, (1, 1) "
          f"mesh) traced in {rec['compile_seconds']} s: "
          f"{flops / 1e12:.4f} TFLOP (FlopCounterMode the same), "
          f"{flops / bound:.4f} x PERF.md's operations bound "
          f"{bound / 1e12:.4f} TFLOP (6 x {rec['params'] - rec['gathered']:,}"
          f" parameters x {TRAIN_B * TRAIN_S} tokens + K4's); "
          f"{nbytes / 1e9:.3f} GB moved; predicted "
          f"max({flops / BF16_FLOP_PER_S * 1e3:.3f} ms at 989 TFLOP/s, "
          f"{nbytes / HBM_BYTES_PER_S * 1e3:.3f} ms at 3.35 TB/s) = "
          f"{predicted:.3f} ms a step, measured {measured:.2f} ms "
          f"({measured / predicted:.2f} x); card {card}")
    print(f"check: dryrun: the sharded step's graph holds "
          f"{rec['k4_nodes']['fwd']} K4 forward and "
          f"{rec['k4_nodes']['bwd']} backward nodes: {graph} launches at "
          f"{fwd_call} kernels a forward and {per_call} a backward call, "
          f"as the profiling child "
          f"counted on the card; its flops == FlopCounterMode's")
    gb, mem = 1e9, torch.cuda.get_device_properties(0).total_memory
    for cell, rec in recs.items():
        coll = ", ".join(f"{k} {v / gb:.3f}" for k, v in sorted(
            rec["collective_bytes_per_device"].items()))
        m = rec["memory"]
        print(f"dryrun: {cell} on {rec['n_devices']} devices: "
              f"{rec['flops_per_device'] / 1e12:.3f} TFLOP, "
              f"{rec['hbm_bytes_per_device'] / gb:.3f} GB HBM, collectives "
              f"({coll or 'none'}) GB a device; argument_size "
              f"{m['argument_size'] / gb:.3f} GB, temp_size "
              f"{m['temp_size'] / gb:.3f} GB, the card's "
              f"{mem / gb:.1f} GB; traced in {rec['compile_seconds']} s "
              f"({rec['seconds']:.1f} s with the analysis)")
        print("dryrun record: " + json.dumps({k: v for k, v in rec.items()
                                               if k != "seconds"}))
        if cell not in DRYRUN_REFERENCE:
            continue
        want_tf, want_gb = DRYRUN_REFERENCE[cell]
        tf, temp = rec["flops_per_device"] / 1e12, m["temp_size"] / gb
        coll = rec["collective_bytes_per_device"]
        print(f"dryrun: {cell} tensor-parallel: {tf:.1f} TFLOP a device "
              f"against the reference's {want_tf} ({tf / want_tf:.4f} x); "
              + ", ".join(f"{k} {coll.get(k, 0) / gb:.3f} GB" for k in (
                  "all-gather", "all-reduce", "reduce-scatter"))
              + f"; temp_size {temp:.1f} GB against the reference's "
              f"{want_gb} and the ZeRO-3 step's {DRYRUN_ZERO3_TEMP_GB[cell]} "
              f"({DRYRUN_ZERO3_TEMP_GB[cell] / temp:.2f} x less)")
        if abs(tf / want_tf - 1) > DRYRUN_FLOPS_TOL:
            fail(f"dryrun: {cell}: {tf:.1f} TFLOP a device, the reference's "
                 f"{want_tf} (limit {DRYRUN_FLOPS_TOL:.0%})")
        if temp * DRYRUN_TEMP_CUT > DRYRUN_ZERO3_TEMP_GB[cell]:
            fail(f"dryrun: {cell}: temp_size {temp:.1f} GB, not "
                 f"{DRYRUN_TEMP_CUT} x under the ZeRO-3 step's "
                 f"{DRYRUN_ZERO3_TEMP_GB[cell]}")
        if temp > DRYRUN_TP_TEMP_GB[cell]:
            fail(f"dryrun: {cell}: temp_size {temp:.1f} GB, above the "
                 f"{DRYRUN_TP_TEMP_GB[cell]} of the step that gathered the "
                 "whole model")
    print(f"check: dryrun: llama3-8b's train_4k and prefill_32k on (16, 16) "
          f"and (2, 16, 16) within {DRYRUN_FLOPS_TOL:.0%} of the reference's "
          f"flops a device, temp_size {DRYRUN_TEMP_CUT} x or more under the "
          "ZeRO-3 step's and not above the whole-model gather's "
          + ", ".join(f"{v}" for v in DRYRUN_TP_TEMP_GB.values()) + " GB")
    for cell, most in DRYRUN_TUNED_TEMP_GB.items():
        rec = recs[cell]
        temp = rec["memory"]["temp_size"] / gb
        print(f"dryrun: {cell} ({', '.join(rec['style'])}): temp_size "
              f"{temp:.3f} GB (at most {most}); all-gathered bytes alive at "
              f"the peak {rec['live_gathers'] / gb:.3f} GB, two layers' and "
              f"those outside the layers {rec['gather_bound'] / gb:.3f} GB")
        if temp > most:
            fail(f"dryrun: {cell}: temp_size {temp:.1f} GB, above {most}")
        if rec["live_gathers"] > rec["gather_bound"]:
            fail(f"dryrun: {cell}: {rec['live_gathers']} all-gathered bytes "
                 f"alive at the peak, above two layers' and the rest's "
                 f"{rec['gather_bound']}")
    print("check: dryrun: the tuned cells' temp_size within "
          + ", ".join(f"{k} {v} GB" for k, v in DRYRUN_TUNED_TEMP_GB.items())
          + "; their live all-gathers at the peak within two layers' "
          "weights and those outside the layers")
    for cell, before in DRYRUN_DECODE_GATHER_GB.items():
        got = recs[cell]["collective_bytes_per_device"].get(
            "all-gather", 0) / gb
        if got * DRYRUN_DECODE_CUT > before:
            fail(f"dryrun: {cell}: {got:.3f} GB all-gathered a device, not "
                 f"{DRYRUN_DECODE_CUT} x under the {before} GB of the step "
                 "that gathered its cache")
        print(f"check: dryrun: {cell}: {got:.3f} GB all-gathered a device "
              f"(no cache tensor), {before / got:.1f} x under the {before} "
              "GB of the step that gathered its cache")
    rwkv_cell_check(recs["rwkv6_3b:train_4k:single"])
    print(f"dryrun: {len(recs)} cells in {len(procs)} children, "
          f"{wall:.1f} s waited for them after path 15 (budget "
          f"{DRYRUN_BUDGET_S} s)")


def main() -> int:
    started = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    import numpy as np

    from repro_torch import _cuda
    from repro_torch.core import codegen, frontend, hls, programs, sim
    from repro_torch.kernels import stencil_pipeline as sp

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    dryruns = dryrun_start(DRYRUN_CELLS)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- compile and lower every path ---------------------------------------
    t0 = time.perf_counter()
    cfg = sp._stencil_codegen_config()
    src = sp.stencil_config_source()
    if (cfg, src) != ((2, 2), "dse"):
        fail(f"stencil config {cfg} from {src}, expected (2, 2) from dse")
    print(f"config: K1 (block_rows, halo) = {cfg} from {src}")
    streamed = {}  # name -> (program, double, single, block_rows, path)
    whole = {}     # name -> (program, kernel, path)
    for name, mk in programs.CHAIN_BENCHMARKS.items():
        r = hls.compile(mk(8, storage="bram"))
        br = r.emit_cuda().block_rows
        big = mk(CHAIN_N, storage="bram")
        streamed[name] = (big, codegen.lower_program(big, block_rows=br),
                          codegen.lower_program(big, block_rows=br,
                                                buffering="single"),
                          br, "chains")
        print(f"compile: {name} n=8 best '{r.best.desc}' -> block_rows {br},"
              f" halo {streamed[name][1].halo}")
    for name, mk in programs.BENCHMARKS.items():
        n = BENCH_COMPILE_N[name]
        spec = sp.restricted_spec(hls) if name in RESTRICTED else {}
        tc = time.perf_counter()
        r = hls.compile(mk(n, storage="bram"), **spec)
        k = r.emit_cuda()
        secs = time.perf_counter() - tc
        big = mk(CHAIN_N, storage="bram")
        how = "restricted search" if spec else "default search"
        if k.mode == "streamed":
            # the point's block size; the lowering shrinks it where the
            # windows would not fit shared memory at this width
            kd, ks = (codegen.lower_program(big, block_rows=k.block_rows,
                                            buffering=b)
                      for b in ("double", "single"))
            streamed[name] = (big, kd, ks, kd.block_rows, "benchmarks")
            if kd.block_rows != k.block_rows:
                fail(f"K2 {name}: the design point's block_rows "
                     f"{k.block_rows} shrank to {kd.block_rows} at n="
                     f"{CHAIN_N}: {kd.soft_reasons}")
            print(f"compile: {name} n={n} ({how}, {secs:.1f} s) best "
                  f"'{r.best.desc}' -> streamed, block_rows {k.block_rows}; "
                  f"at n={CHAIN_N}: {kd.block_rows} "
                  f"({'; '.join(kd.soft_reasons) or 'fits'})")
        else:
            kb = codegen.lower_program(big)
            whole[name] = (big, kb, "benchmarks")
            print(f"compile: {name} n={n} ({how}, {secs:.1f} s) best "
                  f"'{r.best.desc}' -> whole, {kb.nest_launches} nest "
                  f"launches, outputs {list(kb.outputs)}")
    tc = time.perf_counter()
    r = hls.compile(frontend.conv_block_program(8, 8).program)
    k = r.emit_cuda()
    traced = frontend.conv_block_program(CONV_HW, CONV_HW)
    kb = codegen.lower_program(traced.program)
    if k.mode != "whole" or kb.mode != "whole":
        fail(f"traced conv block lowers to {k.mode}/{kb.mode}, not whole")
    whole["traced_conv"] = (traced.program, kb, "traced")
    print(f"compile: traced conv block 8x8 ({time.perf_counter() - tc:.1f} "
          f"s) best '{r.best.desc}' -> whole; traced at {CONV_HW}x{CONV_HW}: "
          f"{len(traced.program.body)} nests, {len(traced.program.arrays)} "
          "arrays")
    for name, (p, k, _) in whole.items():
        if k.tiled_reductions != K3_TILED.get(name, ()):
            fail(f"K3 {name}: tiled reductions {k.tiled_reductions}, "
                 f"expected {K3_TILED.get(name, ())}")
        if k.nest_launches != K3_LAUNCHES[name]:
            fail(f"K3 {name}: {k.nest_launches} launches per call "
                 f"{k.launch_nests}, expected {K3_LAUNCHES[name]}")
    checks = {name: mk(CHECK_N, storage="bram")
              for name, mk in {**programs.CHAIN_BENCHMARKS,
                               **programs.BENCHMARKS}.items()}
    checks["two_mm"] = programs.two_mm(CHECK_SIZE["two_mm"])
    checks["traced_conv"] = frontend.conv_block_program(10, 10).program
    compile_s = time.perf_counter() - t0

    f64 = {}
    for name, p in checks.items():
        br = streamed[name][3] if name in streamed else None
        f64[name] = [codegen.lower_program(p, block_rows=br, buffering=b,
                                           dtype="float64")
                     for b in (("double", "single") if name in streamed
                               else ("double",))]
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import wkv6 as wk
    sources = {sp.LIB_NAME: sp.kernel_source(), **fa.kernel_sources(),
               wk.LIB_NAME: wk.kernel_source(),
               wk.BWD_TC_LIB_NAME: wk.bwd_tc_kernel_source()}
    for k in ([s[1] for s in streamed.values()]
              + [w[1] for w in whole.values()]
              + [ks[0] for ks in f64.values()]):
        sources[k.lib_name] = k.source
    t0 = time.perf_counter()
    _cuda.build_many(sources)
    print(f"build: {len(sources)} sources, one nvcc each in parallel, "
          f"{time.perf_counter() - t0:.1f} s (compile {compile_s:.1f} s)")
    for name, (secs, log) in sorted(_cuda.BUILD_LOG.items()):
        print(f"  {name}: {secs:.1f} s; " + " | ".join(ptxas_summary(log)))
    # K4's bf16 kernels by ptxas (the split forward and its combine at hd
    # 256, every backward kernel): none may spill
    seen = {}
    for lib in (fa.WGMMA_LIB_NAME, fa.WGMMA_BWD_LIB_NAME):
        for ln in ptxas_kernels(build_log(lib, sources[lib])):
            if "hd256" in ln or lib == fa.WGMMA_BWD_LIB_NAME:
                seen[ln.split(":")[0]] = ln
                print(f"build: {lib}: {ln}")
    if sorted(seen) != sorted(K4_NO_SPILL_KERNELS):
        fail(f"build: ptxas reported the bf16 kernels {sorted(seen)}, "
             f"expected {sorted(K4_NO_SPILL_KERNELS)}")
    spilled = [ln for ln in seen.values() if not ln.endswith(" 0 B spilled")]
    if spilled:
        fail(f"build: K4's bf16 kernels spill: {spilled}")
    # ptxas's notes that it serialised a kernel's wgmma (registers short)
    for lib in (fa.WGMMA_LIB_NAME, fa.WGMMA_BWD_LIB_NAME):
        for ln in build_log(lib, sources[lib]).splitlines():
            if "C7512" in ln:
                print(f"build: {lib}: ptxas: {ln.strip()}")
    t0 = time.perf_counter()
    prof = profiles()
    print(f"profile: a child process read K1's, K3's, K4's, K5's, sdpa's, "
          f"the MoE step's, Jamba's step's, the train steps', K5's "
          f"backward's and the sharded path's device kernels off "
          f"torch.profiler in "
          f"{time.perf_counter() - t0:.1f} s")

    # ---- the paths: counts from 0, launch, counts read ---------------------
    rng = np.random.default_rng(0)
    frame = rng.uniform(0.0, 1.0, size=FRAME).astype(np.float32)
    img = {"float32": torch.as_tensor(frame, device=dev)}
    img["bfloat16"] = img["float32"].to(torch.bfloat16)
    wx = torch.tensor([0.25, 0.5, 0.25], device=dev)
    wy = torch.tensor([0.25, 0.5, 0.25], device=dev)
    xs = {}        # name -> the kernel's input tensors on the card
    for name, (p, k, *_) in {**streamed, **whole}.items():
        x = sim.make_inputs(p, seed=0)
        xs[name] = {a: torch.as_tensor(x[a], dtype=torch.float32,
                                       device=dev) for a in k.inputs}
    launches, outs, k1_out = {}, {}, {}
    for path in ("chains", "benchmarks", "traced"):
        sp.LAUNCHES.clear()
        codegen.LAUNCHES.clear()
        if path == "chains":
            k1_out = {dt: sp.stencil_pipeline(x, wx, wy)
                      for dt, x in img.items()}
        for name, (p, kd, ks, br, pth) in streamed.items():
            if pth == path:
                outs[name] = (kd(xs[name]), ks(xs[name]))
        for name, (p, k, pth) in whole.items():
            if pth == path:
                outs[name] = k(xs[name])
        torch.cuda.synchronize()
        launches[path] = {
            **{f"k1/{k}": v for k, v in sp.LAUNCHES.items()},
            **{f"{'k3' if k.split('/')[1] == 'whole' else 'k2'}/{k}": v
               for k, v in codegen.LAUNCHES.items()}}
        print(f"{path} path launches: "
              + json.dumps(launches[path], sort_keys=True))

    entries = []
    # ---- K1 against its plain version, timed ------------------------------
    H, W = FRAME
    for dt, x in img.items():
        n = launches["chains"].get(f"k1/{dt}", 0)
        if n < 1:
            fail(f"K1 {dt} was not launched on the main path")
        plain = sp.stencil_pipeline_plain(x, wx, wy)
        got = k1_out[dt]
        err = (got.float() - plain.float()).abs().max().item()
        if not torch.equal(got, plain):
            fail(f"K1 {dt} differs from its plain version (max {err})")
        esz = x.element_size()
        nbytes = (H * W + (H - 2) * (W - 2)) * esz + 6 * 4
        flops = 5 * H * (W - 2) + 5 * (H - 2) * (W - 2)
        b_ms, b_by = bound(nbytes, flops)
        wx2 = wx.to(x.dtype).view(1, 1, 1, 3)
        wy2 = wy.to(x.dtype).view(1, 1, 3, 1)
        x4 = x.view(1, 1, H, W)

        def library():
            return torch.nn.functional.conv2d(
                torch.nn.functional.conv2d(x4, wx2), wy2)
        lib_err = (library()[0, 0].float() - plain.float()).abs().max().item()
        ms, host_ms = time_ms(lambda: sp.stencil_pipeline(x, wx, wy), 25)
        cold_ms = time_cold_ms(lambda: sp.stencil_pipeline(x, wx, wy), 25)
        # the device's own count of K1's kernels per call, one call a
        # profile in the profiling child (which may drop a record, never
        # add one)
        calls = prof["k1"][dt]
        seen = [len(c) for c in calls]
        if max(seen) != 1 or any("stencil_walk_kernel" not in n_
                                 for c in calls for n_, _ in c):
            fail(f"K1 {dt}: calls on the frame ran the device kernels "
                 f"{calls}; the design runs the walk kernel alone, once a "
                 "call")
        g = sp.launch_geometry(H, W, x.dtype, *cfg)
        ptxas = [p_ for p_ in ptxas_summary(
            _cuda.BUILD_LOG.get(sp.LIB_NAME, (0, ""))[1])
            if p_.startswith(f"<{'f32' if esz == 4 else 'bf16'}>")]
        print(f"geometry: K1 {dt} {H}x{W} at {cfg}: grid {list(g.grid)} "
              f"(strips x runs, {g.grid[0] * g.grid[1]} blocks), strip "
              f"{g.strip} columns, run {g.run} rows, {g.threads} threads, "
              f"{g.vec} columns a thread, {sp.RING_ROWS} rows in flight, "
              f"{g.smem} B shared; ptxas " + " | ".join(ptxas))
        entry = {
            "name": f"stencil_pipeline[{dt}]", "route": "cuda",
            "source": "src/repro_torch/csrc/stencil_pipeline.cu",
            "replaces": K1_REPLACES, "launches": n, "max_abs_err": err,
            "ms": ms, "cold_ms": cold_ms,
            "plain_ms": time_ms(
                lambda: sp.stencil_pipeline_plain(x, wx, wy), 25)[0],
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(library, 25)[0],
            "library_cold_ms": time_cold_ms(library, 25), "host_ms": host_ms,
            "bytes": nbytes, "shape": [H, W], "config": list(cfg),
            "kernels_seen_per_call": seen, "grid": list(g.grid),
            "run": g.run, "threads": g.threads, "smem_bytes": g.smem,
            "ptxas": ptxas}
        entries.append(entry)
        print(f"check: K1 {dt} {H}x{W} == plain bitwise; one device kernel a "
              f"call (seen per profiled call {seen}); {cold_ms:.4f} ms on the "
              f"card with a cold L2 ({b_ms / cold_ms:.0%} of the bound "
              f"{b_ms:.4f} ms), {ms:.4f} ms warm, {host_ms:.4f} ms host per "
              f"call (conv2d pair {entry['library_cold_ms']:.4f} ms cold, "
              f"{entry['library_ms']:.4f} ms warm, max |conv2d - plain| "
              f"{lib_err:.3g})")

    # ---- K2 per program: kernel vs plain, double == single, timed ---------
    def k2_library(name, x):
        """One PyTorch call per stage computing the chain, where there is
        one (timed only; cuDNN sums in another order)."""
        F = torch.nn.functional
        if name == "blur_chain":
            w = torch.tensor(BLUR_W, device=dev)
            x4 = x["img"][None, None]
            return lambda: F.conv2d(F.conv2d(x4, w.view(1, 1, 1, 3)),
                                    w.view(1, 1, 3, 1))[0, 0]
        if name == "conv_pool":
            g = torch.tensor(GAUSS, device=dev).view(1, 1, 3, 3)
            x4 = x["img"][None, None]
            return lambda: F.max_pool2d(F.conv2d(x4, g), 2)[0, 0]
        return None

    for name, (p, kd, ks, br, path) in streamed.items():
        x = xs[name]
        plain = kd.plain(x)
        od, os_ = outs[name]
        sink = kd.outputs[0]
        if not torch.equal(od[sink], os_[sink]):
            fail(f"K2 {name}: double and single buffering differ")
        nbytes = kernel_bytes(p, kd)
        b_ms, b_by = bound(nbytes, stage_flops(p))
        plain_ms = time_ms(lambda: kd.plain(x), 3, warmup=1)[0]
        # stage_flops counts every op of every point once, no FMA: the
        # issue slots that alone would take (the kernel reuses shared
        # products across a strip's points, so it issues fewer)
        ceil_ms = stage_flops(p) / FP32_ISSUE_PER_S * 1e3
        ptxas = [x_ for x_ in ptxas_summary(
            _cuda.BUILD_LOG.get(kd.lib_name, (0, ""))[1])
            if "streamed_double" in x_]
        lib = k2_library(name, x)
        lib_ms, lib_note = None, "no PyTorch call computes it"
        if lib is not None:
            lib_ms = time_ms(lib, 25)[0]
            lib_note = (f"max |library - plain| "
                        f"{(lib() - plain[sink]).abs().max().item():.3g}")
        for k, out in ((kd, od), (ks, os_)):
            n = launches[path].get(f"k2/{k.launch_key}", 0)
            if n < 1:
                fail(f"K2 {k.launch_key} was not launched on its path")
            err = (out[sink] - plain[sink]).abs().max().item()
            if not torch.equal(out[sink], plain[sink]):
                fail(f"K2 {k.launch_key} differs from its plain version "
                     f"(max {err})")
            ms, host_ms = time_ms(lambda: k(x),
                                  25 if k.buffering == "double" else 5)
            entries.append({
                "name": f"streamed[{name}/{k.buffering}]", "route": "cuda",
                "source": CODEGEN_SRC, "replaces": K2_REPLACES,
                "launches": n, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": lib_ms, "library": lib_note,
                "host_ms": host_ms, "bytes": nbytes,
                "issue_ceiling_ms": ceil_ms, "share": b_ms / ms,
                "shape": list(p.arrays[sink].shape), "block_rows": br,
                "grid": list(k.grid), "col_tile": k.col_tile,
                "launch_grid": list(k.launch_grid), "run": k.run,
                "ring_rows": k.ring_rows, "threads": k.threads,
                "smem_bytes": k.smem_bytes, "ptxas": ptxas})
        print(f"check: K2 {name} n={CHAIN_N} double == single == plain "
              f"bitwise; block_rows {kd.block_rows}, column tile "
              f"{kd.col_tile}, runs of {kd.run} row tiles, "
              f"{kd.launch_grid[0]} x {kd.launch_grid[1]} blocks of "
              f"{kd.threads} threads, rings {kd.ring_rows} rows, "
              f"{kd.smem_bytes} B shared memory per block; ptxas "
              + " | ".join(ptxas) + f"; double {entries[-2]['ms']:.4f} ms "
              f"({b_ms / entries[-2]['ms']:.0%} of the bound {b_ms:.4f} ms "
              f"by {b_by}; issue ceiling {ceil_ms:.4f} ms), single "
              f"{entries[-1]['ms']:.4f} ms (library "
              f"{lib_ms if lib_ms is None else round(lib_ms, 4)} ms, "
              f"{lib_note})")
        if name == "blur_chain":
            # the hand-written golden on the same image and weights
            w = torch.tensor(BLUR_W, device=dev)

            def golden():
                return sp.stencil_pipeline(x["img"], w, w,
                                           block_rows=cfg[0], halo=cfg[1])
            if not torch.equal(golden(), od[sink]):
                err = (golden() - od[sink]).abs().max().item()
                fail(f"K2 blur_chain differs from K1 (max {err})")
            k1_ms = time_ms(golden, 25)[0]
            entries[-2]["k1_ms"] = k1_ms
            print(f"check: K2 blur_chain == K1 bitwise on the same image; K1 "
                  f"takes {k1_ms:.4f} ms there warm, K2 "
                  f"{entries[-2]['ms']:.4f} ms "
                  f"({entries[-2]['ms'] / k1_ms:.2f}x)")

    # ---- K3 per program: kernel vs plain (NaN-aware), timed ---------------
    for name, (p, k, path) in whole.items():
        x = xs[name]
        n = launches[path].get(f"k3/{k.launch_key}", 0)
        if n < 1:
            fail(f"K3 {k.launch_key} was not launched on its path")
        got = outs[name]
        plain = k.plain(x)
        err, nans = 0.0, 0
        for a in k.outputs:
            try:
                torch.testing.assert_close(got[a], plain[a], rtol=0, atol=0,
                                           equal_nan=True)
            except AssertionError as e:
                fail(f"K3 {name}: '{a}' differs from its plain version: {e}")
            d = (got[a] - plain[a]).abs().nan_to_num(0.0)
            err = max(err, d.max().item())
            nans += int(got[a].isnan().sum().item())
        nbytes = kernel_bytes(p, k)
        b_ms, b_by = bound(nbytes, stage_flops(p))
        slow = name == "two_mm"
        ms, host_ms = time_ms(lambda: k(x), 3 if slow else 10, warmup=1)
        # the device's own count of a call's kernels, and their times, from
        # the profiling child (which may drop a record, never add one)
        calls = prof["k3"][name]
        seen = [len(c) for c in calls]
        kern = max(calls, key=len)
        if not kern:
            fail(f"K3 {name}: torch.profiler saw no kernel in {len(calls)} "
                 "calls, so its launches were not counted")
        if max(seen) != k.nest_launches:
            fail(f"K3 {name}: the profiler saw {seen} kernels in its "
                 f"profiled calls, the design launches {k.nest_launches} "
                 f"{list(k.launch_nests)}; seen: "
                 + ", ".join(f"{n_} {us:.1f} us" for n_, us in kern))
        ptxas = ptxas_summary(_cuda.BUILD_LOG.get(k.lib_name, (0, ""))[1])
        ceil_ms = stage_flops(p) / FP32_ISSUE_PER_S * 1e3
        print(f"launches: K3 {name}: {K3_LAUNCHES_BEFORE[name]} per call "
              f"before, {len(kern)} now (seen by the profiler in the "
              f"profiling child; per profiled call {seen}), nests per "
              f"launch {list(k.launch_nests)}; tiled "
              f"{list(k.tiled_reductions)}; ptxas " + " | ".join(ptxas)
              + "; device us per kernel "
              + ", ".join(f"{n_} {us:.1f}" for n_, us in kern))
        plain_ms = time_ms(lambda: k.plain(x), 1 if slow else 3,
                           warmup=0 if slow else 1)[0]
        lib_ms, lib_note = None, "no PyTorch call computes it"
        if name == "two_mm":
            def library():
                tmp = torch.addmm(x["tmp"], x["A"], x["B"])
                return tmp, torch.addmm(x["D"], tmp, x["C"])
            lib_ms = time_ms(library, 10)[0]
            rel = ((library()[1] - got["D"]).abs().max()
                   / got["D"].abs().max()).item()
            lib_note = ("torch.addmm pair, TF32 off; max |addmm - kernel| / "
                        f"max |kernel| {rel:.3g} on D (cuBLAS sums in "
                        "another order)")
        elif name == "traced_conv":
            x4 = x["img"][None, None]

            def library():
                return torch.nn.functional.conv2d(
                    torch.nn.functional.conv2d(x4, x["wx"].view(1, 1, 1, 3)),
                    x["wy"].view(1, 1, 3, 1))
            lib_ms = time_ms(library, 25)[0]
            diff = (library()[0, 0] - got["out"]).abs().max().item()
            lib_note = ("conv2d pair, TF32 off; max |conv2d - kernel| "
                        f"{diff:.3g}")
        entries.append({
            "name": f"whole[{name}]", "route": "cuda", "source": CODEGEN_SRC,
            "replaces": K3_REPLACES, "launches": n, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms, "library": lib_note,
            "host_ms": host_ms, "bytes": nbytes,
            "launches_per_call": len(kern), "kernels_seen_per_call": seen,
            "launch_nests": [list(g) for g in k.launch_nests],
            "tiled_reductions": list(k.tiled_reductions), "ptxas": ptxas,
            "kernel_us": kern,
            "nans": nans, "outputs": list(k.outputs),
            "shape": list(p.arrays[k.outputs[-1]].shape)})
        ceil = (f"; {ceil_ms:.4f} ms with every op rounded on its own, no "
                "FMA" if name == "two_mm" else "")
        print(f"check: K3 {name} == plain bitwise (NaN-aware, {nans} NaN) "
              f"on {len(k.outputs)} outputs; {ms:.4f} ms on the card in "
              f"{k.nest_launches} launches (bound {b_ms:.4f} ms by "
              f"{b_by}{ceil}; plain {plain_ms:.4f} ms; library "
              f"{lib_ms if lib_ms is None else round(lib_ms, 4)} ms, "
              f"{lib_note})")
    # the traced conv block is K1's function: same image, same weights
    x = xs["traced_conv"]
    golden = sp.stencil_pipeline(x["img"], x["wx"], x["wy"],
                                 block_rows=cfg[0], halo=cfg[1])
    if not torch.equal(golden, outs["traced_conv"]["out"]):
        err = (golden - outs["traced_conv"]["out"]).abs().max().item()
        fail(f"K3 traced conv block differs from K1 (max {err})")
    k1_ms = time_ms(lambda: sp.stencil_pipeline(
        x["img"], x["wx"], x["wy"], block_rows=cfg[0], halo=cfg[1]), 25)[0]
    entry = next(e for e in entries if e["name"] == "whole[traced_conv]")
    entry["k1_ms"] = k1_ms
    print(f"check: K3 traced conv block {CONV_HW}x{CONV_HW} == K1 bitwise on "
          f"the same image and weights; K1 takes {k1_ms:.4f} ms there, K3 "
          f"{entry['ms']:.4f} ms")

    # ---- float64 against the sequential oracle ----------------------------
    for name, ks in f64.items():
        p = checks[name]
        x = sim.make_inputs(p, seed=1)
        want = sim.sequential_exec(p, x)
        for k in ks:
            got = k(x)
            for a in k.outputs:
                np.testing.assert_allclose(
                    got[a].cpu().numpy(), want[a], rtol=1e-12, atol=0,
                    err_msg=f"{name}/{k.buffering}/{a}")
        shape = "x".join(map(str, p.arrays[ks[0].outputs[-1]].shape))
        print(f"check: {'K2' if ks[0].mode == 'streamed' else 'K3'} {name} "
              f"({shape} output) float64 == sequential_exec (rtol 1e-12), "
              + ("both bufferings" if len(ks) == 2 else
                 f"all {len(ks[0].outputs)} outputs"))

    # ---- the model paths: serve (K5), prefill (K4), their checks ----------
    served = serve_path(dev)
    torch.cuda.empty_cache()
    prefilled = prefill_path(dev)
    torch.cuda.empty_cache()
    equiv = equivalence(dev)
    reduced = reduced_path(dev)
    # ---- the MoE family: DeepSeek-V2 served, held; Kimi-K2's prefill ------
    moe_serve_path(dev, prof)
    torch.cuda.empty_cache()
    moe_equivalence(dev)
    moe_prefilled = moe_prefill_path(dev)
    torch.cuda.empty_cache()
    # ---- the last families: Jamba, Whisper, PaliGemma ---------------------
    hybrid = hybrid_paths(dev, prof)
    encdec_serve_path(dev)
    encdec = encdec_prefill_path(dev)
    torch.cuda.empty_cache()
    encdec_equivalence(dev)
    vlm = vlm_paths(dev)
    torch.cuda.empty_cache()
    # ---- path 13, train: K4's backward, llama3-8b trained, restarts ------
    bwd_cases = k4_bwd_checks(dev)
    trained = train_path(dev, prof)
    remat_memory(dev)
    grad_eq = train_grad_equivalence(dev)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as tmp:
        restart_check(dev, tmp)
    torch.cuda.empty_cache()
    # ---- path 14, train_rwkv: K5's backward, rwkv6-3b trained --------------
    k5_bwd_cases = k5_bwd_checks(dev)
    rwkv_trained = train_rwkv_path(dev, prof)
    # ---- path 15, sharded: the multi-device training path at one rank ------
    sharded_ms = sharded_path(dev, prof, card)
    # ---- the dry-run: path 15's cell and production cells on fake groups --
    dryrun_phase(prof, sharded_ms, card, dryruns)
    entries += k4_entries(
        dev, prefilled["launches"], equiv, reduced, prof, moe_prefilled,
        [("hybrid_prefill", hybrid["prefill"], HYBRID_PREFILL_S,
          "bfloat16/jamba_1_5_large_398b"),
         ("encdec_prefill", encdec, WHISPER_S, "bfloat16/whisper_small"),
         ("vlm_prefill", vlm, vlm["cfg"].n_img_tokens + VLM_TEXT_S,
          "bfloat16/paligemma_3b")])
    entries += k5_entries(dev, served["launches"], equiv, prof)
    entries += k4_bwd_entries(dev, bwd_cases, {
        "bfloat16": trained["launches"], "float32": grad_eq["launches"]},
        prof)
    entries += k5_bwd_entries(dev, k5_bwd_cases, rwkv_trained["launches"],
                              prof)

    print(f"total: {time.perf_counter() - started:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(profile_main() if sys.argv[1:] == ["--profile"] else
             dryrun_main(sys.argv[2:]) if sys.argv[1:2] == ["--dryrun"] else
             main())
