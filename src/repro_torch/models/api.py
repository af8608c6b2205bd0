"""Batch shapes, abstract inputs and random batches for every (arch x
shape), with the JAX package's draws.

``make_batch`` draws from ``np.random.default_rng(seed)`` in the order the
reference does, so both packages build equal batches, for every family
(``lm`` runs all of them).  ``input_specs`` is the batch as tensors on the
``meta`` device, the counterpart of the reference's ``jax.ShapeDtypeStruct``
view: the step builders (``launch.steps.build``) return it as their
abstract inputs, and the dry-run (``launch.dryrun``) traces each cell on
FakeTensors of its shapes.  The modality frontends are stubs as in the
reference: whisper gets frame embeddings (B, enc_seq, D), paligemma patch
embeddings (B, n_img_tokens, D)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.config import ArchConfig, ShapeConfig


def batch_shapes(cfg: ArchConfig, shape: ShapeConfig) -> dict[str, tuple]:
    B, S = shape.global_batch, shape.seq_len
    dt = cfg.dtype
    if shape.kind in ("train", "prefill"):
        n_txt = S - cfg.n_img_tokens if cfg.family == "vlm" else S
        d = {"tokens": ((B, n_txt), "int32")}
        if shape.kind == "train":
            d["labels"] = ((B, n_txt), "int32")
            d["mask"] = ((B, n_txt), "float32")
        if cfg.family == "encdec":
            d["frames"] = ((B, cfg.enc_seq, cfg.d_model), dt)
        if cfg.family == "vlm":
            d["patches"] = ((B, cfg.n_img_tokens, cfg.d_model), dt)
        return d
    # decode: one new token against a seq_len-deep cache
    d = {"token": ((B, 1), "int32"), "pos": ((B,), "int32")}
    if cfg.family == "encdec":
        d["frames"] = ((B, cfg.enc_seq, cfg.d_model), dt)
    return d


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """``batch_shapes`` as empty tensors on the ``meta`` device, in their
    dtypes: the batch's shapes with no storage."""
    return {k: torch.empty(shp, dtype=getattr(torch, dt), device="meta")
            for k, (shp, dt) in batch_shapes(cfg, shape).items()}


def make_batch(cfg: ArchConfig, shape: ShapeConfig, seed: int = 0,
               device="cuda"):
    """Concrete random batch as tensors on ``device``."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, (shp, dt) in batch_shapes(cfg, shape).items():
        if dt == "int32":
            hi = cfg.vocab if k in ("tokens", "labels", "token") \
                else shape.seq_len - 1
            if k == "pos":
                out[k] = torch.full(shp, shape.seq_len - 1, dtype=torch.int32,
                                    device=device)
            else:
                out[k] = torch.as_tensor(rng.integers(0, hi, size=shp),
                                         dtype=torch.int32, device=device)
        else:
            out[k] = torch.as_tensor(rng.normal(0, 1, size=shp),
                                     dtype=getattr(torch, dt), device=device)
    return out
