"""int8 gradient compression for data-parallel reduction (the port of
``repro.parallel.compression``).

Block-wise symmetric quantization (block = last dim) with an fp32 scale per
block; the payloads are reduced as int32, as the reference's are.
Unbiasedness comes from stochastic rounding: uniform noise in [-0.5, 0.5)
added before rounding half to even (``torch.round``, as ``jnp.round``).
The noise is drawn from a ``torch.Generator``; ``quantize_int8_noise``
takes it as a tensor, so the tests hold the port's grid bitwise to the
reference's on ``jax.random.uniform``'s draw.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist


def _scale(x: torch.Tensor) -> torch.Tensor:
    return x.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-12


def _round(y: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(y + noise), -127, 127).to(torch.int8)


def uniform_noise(shape, generator: torch.Generator) -> torch.Tensor:
    """U[-0.5, 0.5) in fp32 from ``generator``, on its device."""
    return torch.rand(shape, generator=generator,
                      device=generator.device) - 0.5


def quantize_int8_noise(x: torch.Tensor, noise: torch.Tensor):
    """(int8 payload, fp32 scale (..., 1)) of fp32 ``x`` with the rounding
    noise given."""
    scale = _scale(x)
    return _round(x / scale, noise), scale.float()


def quantize_int8(x: torch.Tensor, generator: torch.Generator):
    """``quantize_int8_noise`` with noise drawn from ``generator``."""
    return quantize_int8_noise(x, uniform_noise(x.shape, generator))


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(grads: Sequence[torch.Tensor], group,
                    generator: torch.Generator) -> list:
    """The mean over ``group`` of each gradient, reduced in int8 with
    per-leaf blockwise scales: the scales are all-reduced by MAX first so
    every rank uses one grid, the int8 payloads are summed as int32, and the
    sum is divided by the group's size.  Returns the leaves in their dtypes.

    Every rank must draw the same noise, as the reference's replicated key
    does: seed ``generator`` with one seed on every rank (the noise is
    drawn from it leaf by leaf, in order)."""
    n = dist.get_world_size(group)
    out = []
    for leaf in grads:
        x = leaf.float()
        scale = _scale(x)
        dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
        q = _round(x / scale, uniform_noise(x.shape, generator))
        acc = q.to(torch.int32)
        dist.all_reduce(acc, group=group)
        out.append((acc.float() * scale / n).to(leaf.dtype))
    return out
