"""RWKV-6 (Finch) WKV recurrence as a CUDA kernel for Hopper (K5).

The TPU kernel (``repro.kernels.wkv6``) walks the sequence in chunks and
evaluates each chunk in the parallel (linear-attention) form so the MXU sees
matrix products.  That form divides by the cumulative decay and overflows
fp32 for strong decays.  The card's kernel, ``csrc/wkv6.cu``, is the
published RWKV CUDA form instead: one block per (batch, head), one thread
per value column, the column of the hd x hd state in registers, tokens in
order.  It stays finite for every decay in (0, 1] and also serves the
one-token decode step (S = 1) with a carried state.

``wkv6_plain`` beside it is the plain PyTorch version, the same per-token
recurrence; the wrapper runs it only for tensors on the CPU.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional

import torch

from .. import _cuda

SOURCE = _cuda.CSRC_DIR / "wkv6.cu"
LIB_NAME = "wkv6"
HEAD_DIMS = (16, 32, 64, 128)   # the kernel's instantiations

# launches by form: "step" (S == 1, the decode step) or "sequence" (S > 1),
# counted at the launch
LAUNCHES: collections.Counter = collections.Counter()


@functools.lru_cache(maxsize=None)
def kernel_source() -> str:
    return SOURCE.read_text()


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = _cuda.load(LIB_NAME, kernel_source())
    return lib, _cuda.entry(lib, "wkv6_f32", [ctypes.c_void_p] * 8
                            + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def wkv6_plain(r, k, v, w, u, s0=None):
    """The plain PyTorch version: the kernel's per-token recurrence in f32.
    Returns (out (B,H,S,hd), final state (B,H,hd,hd))."""
    B, H, S, hd = r.shape
    s = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device) \
        if s0 is None else s0
    ub = u[:, :, None]                                       # (H, hd, 1)
    out = torch.empty_like(r)
    for t in range(S):
        kv = k[:, :, t, :, None] * v[:, :, t, None, :]       # (B,H,hd,hd)
        out[:, :, t] = (r[:, :, t, :, None] * (s + ub * kv)).sum(dim=2)
        s = s * w[:, :, t, :, None] + kv
    return out, s


def wkv6_state(r, k, v, w, u, s0=None, *, device: Optional[str] = None):
    """r, k, v, w: (B, H, S, hd) float32, w the per-token decay in (0, 1];
    u: (H, hd) float32; s0: (B, H, hd, hd) float32 initial state, zeros when
    None.  Returns (out (B, H, S, hd), final state (B, H, hd, hd)), both
    float32.  ``device`` defaults to where the tensors lie (the card for
    numpy input): the kernel runs on the card, the plain version on the
    CPU."""
    dev = _cuda.resolve_device([x for x in (r, k, v, w, u, s0)
                                if x is not None], device)
    if getattr(r, "ndim", 0) != 4:
        raise ValueError(f"r: shape {tuple(getattr(r, 'shape', ()))}, kernel "
                         "takes (B, H, S, hd)")
    B, H, S, hd = r.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"wkv6: head dim {hd} not supported; the kernel "
                         f"takes hd in {HEAD_DIMS}")
    f32 = torch.float32
    r, k, v, w = (_cuda.as_input(x, f32, dev, (B, H, S, hd), n)
                  for x, n in ((r, "r"), (k, "k"), (v, "v"), (w, "w")))
    u = _cuda.as_input(u, f32, dev, (H, hd), "u")
    if s0 is not None:
        s0 = _cuda.as_input(s0, f32, dev, (B, H, hd, hd), "s0")
    if dev.type == "cpu":
        return wkv6_plain(r, k, v, w, u, s0)
    lib, launch = _launcher()
    out = torch.empty((B, H, S, hd), dtype=f32, device=dev)
    s_fin = torch.empty((B, H, hd, hd), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        rc = launch(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                    u.data_ptr(), None if s0 is None else s0.data_ptr(),
                    out.data_ptr(), s_fin.data_ptr(), B, H, S, hd,
                    _cuda.current_stream(dev))
    _cuda.check(lib, rc, "wkv6")
    LAUNCHES["step" if S == 1 else "sequence"] += 1
    return out, s_fin
