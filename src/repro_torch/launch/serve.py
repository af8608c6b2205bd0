"""Batched serving launcher: prefill a batch of prompts, then decode N tokens
with the KV/state caches produced by the prefill.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6_3b \
        --reduced --batch 4 --prompt-len 32 --gen 16 [--device cpu] [--eager]

``--arch`` names any of the ten configurations (``llama3_8b``,
``deepseek_v2_236b``, ``rwkv6_3b``, ``whisper_small``, ``paligemma_3b``,
...); the full MoE and hybrid models do not fit one card, so take them
``--reduced`` (or cut their depth, as ``chip_smoke.py`` does).  Whisper's
decode steps take frame embeddings, drawn after the prompts from the same
generator as the reference draws them; PaliGemma decodes text only, as in
the reference.  The model runs on the card unless ``--device cpu`` is
given.  On the card
every decode step replays one CUDA graph (``lm.DecodeGraph``), as the
reference's decode step is one ``jax.jit`` program; ``--eager`` runs the
step op by op instead (the graph's yardstick).  The CPU has no graphs, so
``--device cpu`` runs eagerly.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.config import get_config
from repro_torch.models import lm


def prefill_into_cache(cfg, model, tokens, cache, step=None):
    """Feed prompt tokens one at a time (teacher-forced) to build the cache.
    (A production server uses the batched prefill kernel; this exercises the
    same decode step the server runs.)  ``step(cache, token, pos) ->
    (logits, cache)`` is that step, ``lm.decode_step`` when None.  Returns
    (cache, last logits)."""
    step = step or _eager_step(cfg, model)
    B, S = tokens.shape
    logits = torch.zeros((B, 1, cfg.vocab), device=model.device)
    for t in range(S):
        logits, cache = step(cache, tokens[:, t:t + 1],
                             torch.full((B,), t, dtype=torch.int32,
                                        device=model.device))
    return cache, logits


def _eager_step(cfg, model, extra=None):
    """The eager step; ``extra`` holds the batch's other inputs (an encdec
    step's ``frames``)."""
    def step(cache, token, pos):
        return lm.decode_step(cfg, model, cache,
                              {"token": token, "pos": pos, **(extra or {})})
    return step


def draw_inputs(cfg, B: int, prompt_len: int, seed: int, device):
    """(prompts (B, prompt_len) int32, extra inputs of every step) from
    ``np.random.default_rng(seed)`` in the reference's order: the prompts,
    then (encdec) the frames (B, enc_seq, D) in the model's dtype."""
    rng = np.random.default_rng(seed)
    prompts = torch.as_tensor(rng.integers(2, cfg.vocab, (B, prompt_len)),
                              dtype=torch.int32, device=device)
    extra = {}
    if cfg.family == "encdec":
        extra["frames"] = torch.as_tensor(
            rng.normal(size=(B, cfg.enc_seq, cfg.d_model)),
            dtype=getattr(torch, cfg.dtype), device=device)
    return prompts, extra


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6_3b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--eager", action="store_true",
                    help="on the card, run the decode step op by op instead "
                         "of replaying its CUDA graph")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to serve on "
                           "the CPU")
    B = args.batch
    Smax = args.prompt_len + args.gen
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    with torch.inference_mode():
        model = lm.LM.init(cfg, gen, dev)
        cache = model.init_cache(B, Smax)
        prompts, extra = draw_inputs(cfg, B, args.prompt_len, args.seed, dev)

        step = _eager_step(cfg, model, extra)
        if dev.type == "cuda" and not args.eager:
            graph = lm.DecodeGraph(cfg, model, cache, extra)

            def step(cache, token, pos):
                return graph(cache, token, pos, **extra)

        _sync(dev)
        t0 = time.time()
        # prefill (token-by-token through the same decode path)
        cache, logits = prefill_into_cache(cfg, model, prompts, cache, step)
        _sync(dev)
        print(f"[serve] prefill {args.prompt_len} tokens: "
              f"{time.time() - t0:.2f}s")

        # greedy decode
        out = []
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        t0 = time.time()
        for i in range(args.gen):
            pos = torch.full((B,), args.prompt_len + i, dtype=torch.int32,
                             device=dev)
            logits, cache = step(cache, tok, pos)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
            out.append(tok[:, 0].cpu().numpy())
        dt = time.time() - t0
    gen_ids = np.stack(out, axis=1)
    print(f"[serve] generated {args.gen} tokens x {B} seqs in {dt:.2f}s "
          f"({args.gen * B / dt:.1f} tok/s)")
    print("[serve] sample:", gen_ids[0][:16].tolist())
    return gen_ids


if __name__ == "__main__":
    main()
