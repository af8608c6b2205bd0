"""Plain PyTorch oracles for the port's kernels (the correctness ground
truth), written as the JAX package's pure-jnp oracles are."""
from __future__ import annotations

import torch


def flash_attention_ref(q, k, v, causal=True):
    """q,k,v: (B, H, S, hd) -> (B, H, S, hd), fp32 softmax."""
    hd = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * hd ** -0.5
    if causal:
        S = q.shape[2]
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask, s, -torch.inf)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w.to(q.dtype), v)


def stencil_pipeline_ref(img, wx, wy):
    """Fused producer-consumer separable stencil chain (the paper's Fig. 1
    pattern): bx = conv_x(img, wx); out = conv_y(bx, wy).
    img: (H, W); wx, wy: (3,).  'valid' padding: out is (H-2, W-2)."""
    bx = sum(img[:, i:img.shape[1] - 2 + i] * wx[i] for i in range(3))
    out = sum(bx[i:img.shape[0] - 2 + i, :] * wy[i] for i in range(3))
    return out


def wkv6_ref(r, k, v, w, u, s0=None):
    """RWKV-6 data-dependent-decay recurrence, sequential reference.
    r,k,v,w: (B, H, S, hd); u: (H, hd); s0: (B, H, hd, hd) initial state,
    zeros by default.  Returns (out, final_state).

       S_t = diag(w_t) S_{t-1} + k_t^T v_t
       o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
    """
    B, H, S, hd = r.shape
    s = torch.zeros((B, H, hd, hd), dtype=r.dtype, device=r.device) \
        if s0 is None else s0
    outs = []
    for t in range(S):
        rt, kt, vt, wt = (x[:, :, t] for x in (r, k, v, w))   # (B,H,hd)
        kv = kt[..., :, None] * vt[..., None, :]              # (B,H,hd,hd)
        outs.append(torch.einsum("bhd,bhde->bhe", rt, s + u[..., :, None] * kv))
        s = s * wt[..., :, None] + kv
    return torch.stack(outs, dim=2), s
