"""Flash attention (forward) as a CUDA kernel for Hopper (K4).

The TPU kernel (``repro.kernels.flash_attention``) walks a (B*H, S/block_q)
grid and streams kv blocks through VMEM with online softmax.  The card's
kernel, ``csrc/flash_attention.cu``, keeps that schedule: one block of 8
warps per (b*h, q block), K and V tiles staged through shared memory, the
running max, denominator and fp32 accumulator in registers, on the CUDA
cores.  Its causal loop ends at the kv block that holds the q block's last
row, ``((qi+1)*block_q - 1)//block_k + 1`` blocks, where the TPU kernel's
``(qi*block_q)//block_k + 1`` drops blocks when ``block_q > block_k``.

``flash_attention_plain`` beside it walks the same block schedule in
PyTorch (all q blocks at once, kv blocks in order, the same causal bound),
so the CPU tests hold the tiling math, unequal blocks included, against the
oracle; the wrapper runs it only for tensors on the CPU.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional

import torch

from .. import _cuda

SOURCE = _cuda.CSRC_DIR / "flash_attention.cu"
LIB_NAME = "flash_attention"
HEAD_DIMS = (16, 32, 64, 128, 256)   # the kernel's instantiations
MAX_BLOCK = 64                       # most q rows / kv keys of one CUDA block
NEG_INF = -1e30
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}

# launches per input dtype ("float32" / "bfloat16"), counted at the launch
LAUNCHES: collections.Counter = collections.Counter()


@functools.lru_cache(maxsize=None)
def kernel_source() -> str:
    return SOURCE.read_text()


@functools.lru_cache(maxsize=None)
def _launcher(dtype: torch.dtype):
    lib = _cuda.load(LIB_NAME, kernel_source())
    return lib, _cuda.entry(lib, _ENTRY[dtype], [ctypes.c_void_p] * 4
                            + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                    ctypes.c_void_p])


def kv_blocks(S: int, Sk: int, block_q: int, block_k: int,
              causal: bool) -> list[int]:
    """kv blocks each q block walks: all of them, or (causal) up to the
    one that holds the q block's last row."""
    nq, nk = -(-S // block_q), -(-Sk // block_k)
    if not causal:
        return [nk] * nq
    return [min(nk, (min((qi + 1) * block_q, S) - 1) // block_k + 1)
            for qi in range(nq)]


def flash_attention_plain(q, k, v, *, causal: bool, block_q: int,
                          block_k: int):
    """The plain PyTorch version: the kernel's block schedule with online
    softmax in fp32, every q block at once, kv blocks in order; a q block
    takes a kv block's update only while it is within its causal bound."""
    B, H, S, hd = q.shape
    Sk = k.shape[2]
    nq, nk = -(-S // block_q), -(-Sk // block_k)
    dev = q.device
    qf = torch.zeros((B, H, nq * block_q, hd), dtype=torch.float32,
                     device=dev)
    qf[:, :, :S] = q.float() * hd ** -0.5
    qf = qf.view(B, H, nq, block_q, hd)
    kf = torch.zeros((B, H, nk * block_k, hd), dtype=torch.float32,
                     device=dev)
    vf = torch.zeros_like(kf)
    kf[:, :, :Sk], vf[:, :, :Sk] = k.float(), v.float()
    qpos = torch.arange(nq * block_q, device=dev).view(nq, block_q, 1)
    walks = torch.tensor(kv_blocks(S, Sk, block_q, block_k, causal),
                         device=dev)
    acc = torch.zeros((B, H, nq, block_q, hd), dtype=torch.float32,
                      device=dev)
    m = torch.full((B, H, nq, block_q), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros_like(m)
    for j in range(nk):
        kb = kf[:, :, j * block_k:(j + 1) * block_k]
        vb = vf[:, :, j * block_k:(j + 1) * block_k]
        s = torch.einsum("bhnqd,bhkd->bhnqk", qf, kb)
        kpos = j * block_k + torch.arange(block_k, device=dev)
        ok = kpos < Sk
        if causal:
            ok = ok & (qpos >= kpos)
        s = torch.where(ok, s, NEG_INF)
        m1 = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m1[..., None])
        alpha = torch.exp(m - m1)
        l1 = l * alpha + p.sum(dim=-1)
        acc1 = acc * alpha[..., None] + torch.einsum("bhnqk,bhkd->bhnqd", p, vb)
        on = (j < walks).view(nq, 1)
        acc = torch.where(on[..., None], acc1, acc)
        m, l = torch.where(on, m1, m), torch.where(on, l1, l)
    out = acc / (l[..., None] + 1e-30)
    return out.reshape(B, H, nq * block_q, hd)[:, :, :S].to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True,
                    block_q: int = MAX_BLOCK, block_k: int = MAX_BLOCK,
                    device: Optional[str] = None):
    """q: (B, H, S, hd); k, v: (B, H, Sk, hd), all float32 or all bfloat16.
    Returns (B, H, S, hd) in q's dtype.  ``block_q``/``block_k`` are cut to
    S/Sk as in the TPU wrapper and must then be at most 64: the TPU's
    default is 128 (the MXU's width), but a CUDA block here holds at most
    64 q rows and 64 keys (hd=256 then fills 213 KB of shared memory).  A
    ragged last block is masked.  ``device`` defaults to where the
    tensors lie (the card for numpy input): the kernel runs on the card,
    the plain version on the CPU."""
    dev = _cuda.resolve_device([q, k, v], device)
    if getattr(q, "ndim", 0) != 4 or getattr(k, "ndim", 0) != 4:
        raise ValueError("flash_attention: q, k, v must be (B, H, S, hd)")
    B, H, S, hd = q.shape
    Sk = k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not supported; the "
                         f"kernel takes hd in {HEAD_DIMS}")
    dtype = q.dtype if isinstance(q, torch.Tensor) else torch.float32
    if dtype not in _ENTRY:
        raise ValueError(f"flash_attention: dtype {dtype}, kernel takes "
                         "float32 or bfloat16")
    q = _cuda.as_input(q, dtype, dev, (B, H, S, hd), "q")
    k = _cuda.as_input(k, dtype, dev, (B, H, Sk, hd), "k")
    v = _cuda.as_input(v, dtype, dev, (B, H, Sk, hd), "v")
    block_q, block_k = min(block_q, S), min(block_k, Sk)
    if not (1 <= block_q <= MAX_BLOCK and 1 <= block_k <= MAX_BLOCK):
        raise ValueError(f"flash_attention: blocks ({block_q}, {block_k}) "
                         f"must lie in 1..{MAX_BLOCK}")
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, block_q=block_q,
                                     block_k=block_k)
    lib, launch = _launcher(dtype)
    out = torch.empty((B, H, S, hd), dtype=dtype, device=dev)
    with torch.cuda.device(dev):
        rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    B * H, S, Sk, hd, block_q, block_k, int(causal),
                    hd ** -0.5, _cuda.current_stream(dev))
    _cuda.check(lib, rc, "flash_attention")
    LAUNCHES[str(dtype).removeprefix("torch.")] += 1
    return out
