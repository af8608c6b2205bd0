"""RWKV-6 (Finch) WKV recurrence as CUDA kernels for Hopper (K5).

The TPU kernel (``repro.kernels.wkv6``) walks the sequence in chunks and
evaluates each chunk in the parallel (linear-attention) form so the MXU sees
matrix products.  That form divides by the cumulative decay and overflows
fp32 for strong decays.  The card's kernels, ``csrc/wkv6.cu``, never
divide:

* the step (S = 1, the decode step): one block per (batch, head), one
  thread per column of the hd x hd state, held in registers;
* the sequence (S > 1): a chunk-parallel schedule in three launches: each
  chunk's own state contribution from zero and its decay product, in
  parallel over (batch, head, chunk); the chunks' starting states in order,
  ``S <- diag(prod w) S + local``; each chunk's tokens walked again from
  its starting state for the outputs.  It multiplies only by w in (0, 1]
  and products of it, so it stays finite for every decay.

Both read r, k, v (float32 or bfloat16) and w (float32) through their
strides, such as the (B, H, S, hd) views of a layer's (B, S, D)
activations, write the output in r's dtype (rounded once from fp32) into a
given view or a new tensor, and write the final state into a given buffer
or a new one; the buffer may be the initial state itself (an in-place
update).

``wkv6_plain`` is the plain per-token recurrence, independent of the
kernels' schedule; ``wkv6_chunked_plain`` walks the chunk schedule's three
phases in PyTorch, and the wrapper runs it for tensors on the CPU.
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
HEAD_DIMS = (16, 32, 64, 128)   # the kernels' instantiations
CHUNK = 64                      # tokens per chunk of the sequence form
SEQUENCE_LAUNCHES = 3           # launches per call of the sequence form
_ENTRY = {torch.float32: "wkv6_f32", torch.bfloat16: "wkv6_bf16"}

# launches by form: "step" (S == 1, the decode step) or "sequence" (S > 1,
# three per call), counted at the launch
LAUNCHES: collections.Counter = collections.Counter()


@functools.lru_cache(maxsize=None)
def kernel_source() -> str:
    return SOURCE.read_text()


@functools.lru_cache(maxsize=None)
def _launcher(dtype: torch.dtype):
    lib = _cuda.load(LIB_NAME, kernel_source())
    return lib, _cuda.entry(lib, _ENTRY[dtype], [ctypes.c_void_p] * 11
                            + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def wkv6_plain(r, k, v, w, u, s0=None):
    """The plain PyTorch version: the per-token recurrence in f32.
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


def wkv6_chunked_plain(r, k, v, w, u, s0=None, chunk: int = CHUNK):
    """The kernels' chunk schedule in PyTorch, f32: (1) every chunk's state
    contribution from zero and its decay product, (2) the chunks' starting
    states in order, (3) every chunk's tokens walked from its starting
    state.  A ragged last chunk is padded with tokens that leave the state
    as it is (k = v = 0, w = 1).  Returns (out (B,H,S,hd), final state)."""
    B, H, S, hd = r.shape
    nc = -(-S // chunk)
    pad = nc * chunk - S

    def chunks(x, fill):          # (B, H, nc, C, hd)
        x = torch.cat([x, x.new_full((B, H, pad, hd), fill)], dim=2) \
            if pad else x
        return x.reshape(B, H, nc, chunk, hd)
    rc, kc, vc, wc = (chunks(x, f) for x, f in ((r, 0.0), (k, 0.0),
                                               (v, 0.0), (w, 1.0)))
    # (1) local contributions L and decay products P of every chunk
    L = torch.zeros((B, H, nc, hd, hd), dtype=torch.float32, device=r.device)
    P = torch.ones((B, H, nc, hd), dtype=torch.float32, device=r.device)
    for j in range(chunk):
        L = L * wc[:, :, :, j, :, None] \
            + kc[:, :, :, j, :, None] * vc[:, :, :, j, None, :]
        P = P * wc[:, :, :, j]
    # (2) starting states, chunk after chunk
    s = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device) \
        if s0 is None else s0
    starts = []
    for c in range(nc):
        starts.append(s)
        s = P[:, :, c, :, None] * s + L[:, :, c]
    # (3) every chunk's outputs from its starting state
    st = torch.stack(starts, dim=2)                          # (B,H,nc,hd,hd)
    ub = u[:, None, :, None]                                 # (H,1,hd,1)
    out = torch.empty((B, H, nc, chunk, hd), dtype=torch.float32,
                      device=r.device)
    for j in range(chunk):
        kv = kc[:, :, :, j, :, None] * vc[:, :, :, j, None, :]
        out[:, :, :, j] = (rc[:, :, :, j, :, None] * (st + ub * kv)).sum(3)
        st = st * wc[:, :, :, j, :, None] + kv
    return out.reshape(B, H, nc * chunk, hd)[:, :, :S], s


def _token_strides(t: torch.Tensor, what: str) -> list[int]:
    """(batch, head, token) element strides of a (B, H, S, hd) view whose
    last dim is unit-stride; raises otherwise."""
    if t.stride(-1) != 1 and t.shape[-1] > 1:
        raise ValueError(f"{what}: last dim has stride {t.stride(-1)}; the "
                         "kernel reads it unit-stride")
    return [t.stride(d) for d in range(3)]


def _state(t, dev, shape, what: str) -> torch.Tensor:
    """A (B, H, hd, hd) f32 state the kernels read or write 16 bytes at a
    time: contiguous, 16-byte aligned."""
    t = _cuda.as_input(t, torch.float32, dev, shape, what)
    if dev.type == "cuda" and t.data_ptr() % 16:
        raise ValueError(f"{what}: data is not 16-byte aligned")
    return t


def wkv6_state(r, k, v, w, u, s0=None, *, out=None, s_out=None,
               chunk: int = CHUNK, device: Optional[str] = None):
    """r, k, v: (B, H, S, hd), all float32 or all bfloat16; w: (B, H, S, hd)
    float32, the per-token decay in (0, 1]; u: (H, hd) float32; s0: (B, H,
    hd, hd) float32 initial state, zeros when None.  r, k, v, w may be views
    whose last dim is unit-stride (a layer's (B, S, D) activations viewed as
    (B, H, S, hd)).

    Returns (out (B, H, S, hd) in r's dtype, rounded once from fp32; final
    state (B, H, hd, hd) float32).  ``out``, when given, is written (any
    view of r's dtype with a unit-stride last dim); ``s_out``, when given,
    receives the final state and may be ``s0`` itself.  S = 1 runs the step
    kernel, S > 1 the chunk schedule in chunks of ``chunk`` tokens (three
    launches).  ``device`` defaults to where the tensors lie (the card for
    numpy input): the kernels run on the card, the chunk schedule's plain
    version on the CPU.  The plain version is differentiable by autograd;
    the kernels are not yet: on the card, a call with grad enabled and an
    input that requires grad raises ``NotImplementedError``."""
    dev = _cuda.resolve_device([x for x in (r, k, v, w, u, s0, out, s_out)
                                if x is not None], device)
    if getattr(r, "ndim", 0) != 4:
        raise ValueError(f"r: shape {tuple(getattr(r, 'shape', ()))}, kernel "
                         "takes (B, H, S, hd)")
    B, H, S, hd = r.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"wkv6: head dim {hd} not supported; the kernel "
                         f"takes hd in {HEAD_DIMS}")
    dtype = r.dtype if isinstance(r, torch.Tensor) else torch.float32
    if dtype not in _ENTRY:
        raise ValueError(f"wkv6: dtype {dtype}, kernels take float32 or "
                         "bfloat16")
    if chunk < 1:
        raise ValueError(f"wkv6: chunk {chunk} must be positive")
    shape = (B, H, S, hd)
    r, k, v = (_cuda.as_input(x, dtype, dev, shape, n, contiguous=False)
               for x, n in ((r, "r"), (k, "k"), (v, "v")))
    w = _cuda.as_input(w, torch.float32, dev, shape, "w", contiguous=False)
    u = _cuda.as_input(u, torch.float32, dev, (H, hd), "u")
    if s0 is not None:
        s0 = _state(s0, dev, (B, H, hd, hd), "s0")
    if out is None:
        out = torch.empty(shape, dtype=dtype, device=dev)
    out = _cuda.as_input(out, dtype, dev, shape, "out", contiguous=False)
    s_out = torch.empty((B, H, hd, hd), dtype=torch.float32, device=dev) \
        if s_out is None else _state(s_out, dev, (B, H, hd, hd), "s_out")
    strides = [_token_strides(t, n) for t, n in ((r, "r"), (k, "k"),
                                                 (v, "v"), (w, "w"),
                                                 (out, "out"))]
    chunk = min(chunk, S)
    if dev.type == "cuda" and torch.is_grad_enabled() and any(
            isinstance(x, torch.Tensor) and x.requires_grad
            for x in (r, k, v, w, u, s0)):
        raise NotImplementedError(
            "wkv6: the kernels have no backward yet (ROADMAP queue 1: K5's "
            "backward kernel, RWKV training on the card); a loss through "
            "wkv6_state on the card cannot be differentiated")
    if dev.type == "cpu":
        o, s = wkv6_chunked_plain(r.float(), k.float(), v.float(), w, u, s0,
                                  chunk)
        out.copy_(o)
        s_out.copy_(s)
        return out, s_out
    nc = -(-S // chunk)
    if S > 1:
        Ls = torch.empty((B * H * nc * hd * hd,), dtype=torch.float32,
                         device=dev)
        Ps = torch.empty((B * H * nc * hd,), dtype=torch.float32, device=dev)
    lib, launch = _launcher(dtype)
    st = (ctypes.c_longlong * 15)(*(s for t in strides for s in t))
    with torch.cuda.device(dev):
        rc = launch(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                    u.data_ptr(), None if s0 is None else s0.data_ptr(),
                    out.data_ptr(), s_out.data_ptr(),
                    Ls.data_ptr() if S > 1 else None,
                    Ps.data_ptr() if S > 1 else None, ctypes.addressof(st),
                    B, H, S, hd, chunk, _cuda.current_stream(dev))
    _cuda.check(lib, rc, "wkv6")
    if S == 1:
        LAUNCHES["step"] += 1
    else:
        LAUNCHES["sequence"] += SEQUENCE_LAUNCHES
    return out, s_out
