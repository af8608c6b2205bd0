"""End-to-end training driver (the port of ``repro.launch.train``, one
device).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_8b \
        --reduced --steps 200 --batch 8 --seq 256 --ckpt-dir /tmp/ckpt \
        [--device cpu]

The model trains on the card unless ``--device cpu`` is given.  Parameters
are drawn from a ``torch.Generator`` seeded with ``--seed`` (the reference
draws from ``jax.random``: other numbers), the batches are
``SyntheticLMData``'s (bitwise the reference's), and a run resumes from the
latest checkpoint in ``--ckpt-dir``: the data stream, the parameters, the
moments and the schedule's count all continue where they stopped.  On the
card the attention (``attn_impl="chunked"``) runs K4 forward and backward,
and RWKV's time mix K5 forward and backward (``--arch rwkv6_3b``).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import AsyncCheckpointer, latest_step, \
    restore_checkpoint
from repro_torch.config import ArchConfig, get_config
from repro_torch.data import SyntheticLMData, make_train_iterator
from repro_torch.launch import steps as steps_mod
from repro_torch.models import lm
from repro_torch.optim import adamw_init
from repro_torch.runtime import StepWatchdog


def train(cfg: ArchConfig, *, steps: int, batch: int, seq: int,
          ckpt_dir: str = "", ckpt_every: int = 50,
          watchdog_s: float = 600.0, log_every: int = 10, seed: int = 0,
          device="cuda") -> dict:
    """Train ``cfg`` up to step ``steps`` (resuming from ``ckpt_dir``'s
    latest checkpoint when there is one), printing the reference's lines.
    Returns {"losses": per step run, "step_s": host seconds per step (each
    ends when its loss reaches the host), "model": the trained model}."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to train on "
                           "the CPU")
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = lm.LM.init(cfg, gen, dev).requires_grad_(True)
    params = model.param_list()
    opt = adamw_init(params)
    step_fn = steps_mod.build_train_step(cfg, model)
    start = 0
    ckpt = AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    if ckpt_dir and latest_step(ckpt_dir) is not None:
        start = latest_step(ckpt_dir)
        rparams, opt = restore_checkpoint(ckpt_dir, start, (params, opt))
        with torch.no_grad():
            for p, r in zip(params, rparams):
                p.copy_(r)
        print(f"[train] resumed from step {start}")

    ds = SyntheticLMData(vocab=cfg.vocab, seq_len=seq, batch=batch,
                         seed=seed)
    it = make_train_iterator(ds, start_step=start)
    wd = StepWatchdog(watchdog_s,
                      lambda: print("[train] WATCHDOG: step timed out"))
    losses, step_s = [], []
    t0 = time.time()
    try:
        for step, host_batch in it:
            if step >= steps:
                break
            wd.start_step()
            ts = time.perf_counter()
            b = {k: torch.as_tensor(v, device=dev)
                 for k, v in host_batch.items()}
            metrics = step_fn(model, opt, b)
            loss = float(metrics["loss"])
            step_s.append(time.perf_counter() - ts)
            wd.end_step()
            losses.append(loss)
            if wd.straggling():
                print(f"[train] straggler flag at step {step}")
            if step % log_every == 0:
                dt = time.time() - t0
                print(f"[train] step {step} loss {loss:.4f} "
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
        print(f"[train] done: first loss {losses[0]:.4f} "
              f"last loss {losses[-1]:.4f}")
    return {"losses": losses, "step_s": step_s, "model": model}


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
    return train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                 ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                 watchdog_s=args.watchdog_s, log_every=args.log_every,
                 seed=args.seed, device=args.device)["losses"]


if __name__ == "__main__":
    main()
