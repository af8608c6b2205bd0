"""Public wrappers for the port's kernels, with the JAX package's signatures
(``repro.kernels.ops``).

``device`` takes the place of the JAX wrappers' ``interpret``: a kernel
runs on the card, its plain PyTorch version for tensors on the CPU (or with
``device="cpu"``).  ``stencil_pipeline`` and its configuration helper are
re-exported from ``repro_torch.kernels.stencil_pipeline`` and
``flash_attention`` from ``repro_torch.kernels.flash_attention``, which
own the single implementations.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.stencil_pipeline import (ilp_halo_rows,
                                                  stencil_pipeline)
from repro_torch.kernels.wkv6 import wkv6_state

__all__ = ["flash_attention", "stencil_pipeline", "ilp_halo_rows", "wkv6",
           "wkv6_state"]


def wkv6(r, k, v, w, u, *, chunk=64, device: Optional[str] = None):
    """r, k, v, w: (B, H, S, hd); w is the per-token decay in (0, 1);
    u: (H, hd).  Returns out (B, H, S, hd).  ``chunk`` is the chunk length
    of the sequence form (the port's schedule never divides by the decay,
    so unlike the TPU kernel's it needs no ``S % chunk == 0`` and changes
    the result only by rounding).  ``wkv6_state`` also takes an initial
    state and returns the final one."""
    return wkv6_state(r, k, v, w, u, chunk=chunk, device=device)[0]
