"""Model layers of every family: dense attention (GQA / MQA), the MoE (with
DeepSeek-V2's MLA), Mamba (Jamba's selective SSM), RWKV-6 and cross
attention (Whisper's decoder), as plain functions over a layer's
parameters (a mapping of name -> tensor, such as the ``nn.ParameterDict``
that ``lm.LM`` holds; the MoE's shared experts are a nested one).

The functions keep the JAX package's layouts at their boundaries
(activations (B, S, D), heads (B, S, H, hd), caches (B, Smax, K, hd), MLA's
compressed cache (B, Smax, kv_lora + rope), expert weights (E, D, F),
Mamba's state (B, di, N) and conv tail (B, kc - 1, di)) and its numerics,
so the tests hold each one against ``repro.models.layers`` on carried
weights.  MLA, the MoE, Mamba's scan and cross attention are plain einsums,
gathers and scans in the reference too, so they stay PyTorch here; every
one has fixed shapes at decode (no host sync), so the decode step captures
as a CUDA graph.  Two layers reach the port's CUDA kernels where the
reference runs the same math in plain JAX:

* ``attn_forward`` with ``cfg.attn_impl == "chunked"`` and ``causal``
  computes ``_sdpa_chunked``'s function with flash attention (K4), which
  reads q, k, v in the layer's layout and k, v with their kv heads;
* ``rwkv_time_mix``, and so ``rwkv_forward`` and ``rwkv_decode``, computes
  ``_wkv_chunk``'s recurrence with the WKV6 kernel (K5), which also returns
  the carried state.

The reference's sharding constraints (``constrain`` calls) become explicit
collectives where tensor-parallel compute runs: every family's sharded
train, prefill and decode steps (``launch.steps``, the "tp" style) install
the mesh's "model" axis (``parallel.tensor_parallel.over``) and call the
layers on the rank's model shards.  Each takes its head counts, widths,
channels or experts from its weights' shapes, and where they are split
marks its split region's entry (``enter``, after the last op on weights
whole on "model", so their gradients come out whole) and its row-split
product's sum (``reduce``) at the reference's ``constrain`` points, so
every rank computes its heads', columns', Mamba channels' or experts'
share.  A sharded decode step also installs the axis its cache's
positions lie on (``tensor_parallel.sequence``): ``attn_decode`` and
``mla_decode`` attend over the rank's block of them.  Elsewhere (one
device, the "fsdp" and "ep" styles) the weights are whole and they run as
before.  The dry-run
(``launch.dryrun``) traces these functions on FakeTensors: on its path
they read no tensor's data on the host (``_sdpa``'s ``.item()`` reads a
constant, which a FakeTensor keeps; ``_is_arange`` runs only for positions
given as a tensor, which the steps never pass).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch._cuda import is_fake
from repro_torch.config import ArchConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.wkv6 import wkv6_state
from repro_torch.parallel import tensor_parallel as tp


def _dt(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# f32 elements ``_normal`` draws at once: a larger tensor is drawn in
# slices of its leading axis, so its f32 draw (Kimi-K2's experts: 22.5 GB)
# is never held beside the cast copy
_DRAW_ELEMS = 1 << 30


def _normal(gen: torch.Generator, shape, scale: float, dtype: torch.dtype,
            device) -> torch.Tensor:
    """N(0, 1) * scale drawn in f32 from ``gen`` on its own device, then
    cast (as the reference draws in f32 and casts with ``astype``); above
    ``_DRAW_ELEMS`` elements, slice by slice of the leading axis.  On the
    ``meta`` device nothing is drawn (``gen`` may be None): the tensor has
    its shape and dtype alone."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    if math.prod(shape) <= _DRAW_ELEMS:
        x = torch.randn(shape, generator=gen, device=gen.device)
        return x.mul_(scale).to(device=device, dtype=dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    step = max(1, _DRAW_ELEMS // math.prod(shape[1:]))
    for i in range(0, shape[0], step):
        part = out[i:i + step]
        part.copy_(torch.randn(part.shape, generator=gen,
                               device=gen.device).mul_(scale))
    return out


# ---------------------------------------------------------------------------
# normalization + rotary
# ---------------------------------------------------------------------------


def rms_norm(x, w, eps=1e-5):
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * w


def rope_freqs(head_dim: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(head_dim: int, theta: float, device: torch.device):
    """rope_freqs in f32 on ``device``, copied there once."""
    return torch.as_tensor(rope_freqs(head_dim, theta), dtype=torch.float32,
                           device=device)


def apply_rope(x, positions, theta):
    """x: (..., S, H, hd); positions: (..., S).  A FakeTensor ``x`` (a
    dry-run's trace) takes a copy of the frequencies of its own, which the
    cache of real ones never keeps."""
    hd = x.shape[-1]
    freqs = _rope_freqs_on.__wrapped__(hd, theta, x.device) \
        if is_fake(x) else _rope_freqs_on(hd, theta, x.device)
    ang = positions[..., :, None].float() * freqs        # (..., S, hd/2)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# dense attention (GQA / MQA) with optional KV cache
# ---------------------------------------------------------------------------


def init_attn(cfg: ArchConfig, gen: torch.Generator, device):
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s = D ** -0.5
    dt = _dt(cfg)
    return {
        "wq": _normal(gen, (D, H, hd), s, dt, device),
        "wk": _normal(gen, (D, K, hd), s, dt, device),
        "wv": _normal(gen, (D, K, hd), s, dt, device),
        "wo": _normal(gen, (H, hd, D), s, dt, device),
        "norm": torch.ones((D,), dtype=dt, device=device),
    }


def _heads_in(h, w):
    """einsum("bsd,dhk->bshk", h, w) as one matrix product."""
    return (h @ w.flatten(1)).unflatten(-1, w.shape[1:])


def _heads_out(o, w):
    """einsum("bshk,hkd->bsd", o, w) as one matrix product."""
    return o.flatten(2) @ w.flatten(0, 1)


def _repeat_kv(k, n_rep):
    """(B,T,K,hd) -> (B,T,K*n_rep,hd), materialized as in the reference."""
    if n_rep == 1:
        return k
    B, T, K, hd = k.shape
    return k[:, :, :, None, :].expand(B, T, K, n_rep, hd) \
        .reshape(B, T, K * n_rep, hd)


def _sdpa(cfg, q, k, v, mask, dtype, sq=None):
    """q: (B,S,H,hd); k,v: (B,T,H,hd); mask broadcastable to (B,H,S,T).

    cfg.scores_bf16 keeps the (S x T) score tensor in bf16 with fp32 row
    sums.  With ``sq`` (a sharded decode step's sequence axis) k, v and
    the mask are the rank's block of the positions: the row max, the row
    sums and the weighted values are all-reduced over ``sq``."""
    hd = q.shape[-1]
    sd = torch.bfloat16 if cfg.scores_bf16 else torch.float32
    # the scale rounded to sd first, as the reference's jnp.asarray(., sd);
    # host scalars, so no copy to the card per call
    scale = torch.tensor(hd ** -0.5, dtype=sd).item()
    scores = torch.einsum("bshd,bthd->bhst", q, k).to(sd) * scale
    scores = torch.where(mask, scores, torch.finfo(sd).min / 2)
    m = scores.amax(dim=-1, keepdim=True)
    if sq is not None:
        m = tp.all_reduce(m, "max", sq)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True, dtype=torch.float32)
    if sq is not None:
        l = tp.all_reduce(l, "sum", sq)
    w = (p / l.to(sd)).to(dtype)
    o = torch.einsum("bhst,bthd->bshd", w, v)
    return o if sq is None else tp.all_reduce(o, "sum", sq)


def _is_arange(positions) -> bool:
    S = positions.shape[-1]
    return torch.equal(positions, torch.arange(
        S, dtype=positions.dtype, device=positions.device).expand_as(positions))


def attn_forward(cfg: ArchConfig, p, x, positions, causal=True):
    """Full-sequence attention (train / prefill). x: (B, S, D); positions:
    (B, S), or None for ``arange(S)`` in every row (what ``lm.embed_inputs``
    gives).

    With ``cfg.attn_impl == "chunked"`` and ``causal`` the scores go through
    flash attention (K4), which masks by token index: positions given as a
    tensor must then be each row's ``arange(S)`` (checked, at the cost of
    one device sync), and the reference's kv-chunk precondition
    ``S % min(attn_chunk, S) == 0`` holds here too.

    The head counts are the weights': under a tensor-parallel step
    (``parallel.tensor_parallel``) ``wq`` and ``wo`` may hold the rank's
    share of the heads, and the layer then computes those heads alone
    (``_local_kv`` picks the kv heads they read) and sums its output over
    the model axis."""
    wq, wk, wv = p["wq"], p["wk"], p["wv"]
    ax = tp.split(wq.shape[1], cfg.n_heads)
    arange = positions is None
    if arange:
        B, S = x.shape[:2]
        positions = torch.arange(S, device=x.device).expand(B, S)
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    if ax is not None:
        # q, k, v split by heads: the reference's constrain of them to heads
        # on "model" (repro/models/layers.py:88-90 dense, :116 chunked)
        h = tp.enter(h, ax)
        wk, wv = (_local_kv(cfg, ax, wq.shape[1], w) for w in (wk, wv))
    q = _heads_in(h, wq)
    k = _heads_in(h, wk)
    v = _heads_in(h, wv)
    H, K = q.shape[2], k.shape[2]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if cfg.attn_impl == "chunked" and causal:
        T = k.shape[1]
        C = min(cfg.attn_chunk, T)
        if T % C:
            raise ValueError(f"chunked attention: {T} tokens are not a "
                             f"multiple of attn_chunk {C}")
        if not (arange or _is_arange(positions)):
            raise ValueError("chunked attention masks by token index: "
                             "positions must be arange(S) in every row")
        # K4 reads the (B, S, heads, hd) activations through their strides
        # and k, v with their K heads: no copy around the call, and its
        # output, laid out as q is, transposes back to (B, S, H, hd) as is
        o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=True)
        o = o.transpose(1, 2)
    else:
        if causal:
            mask = (positions[:, :, None] >= positions[:, None, :])[:, None]
        else:
            B, S = x.shape[:2]
            mask = torch.ones((B, 1, S, S), dtype=torch.bool, device=x.device)
        o = _sdpa(cfg, q, _repeat_kv(k, H // K), _repeat_kv(v, H // K), mask,
                  x.dtype)
    out = _heads_out(o, p["wo"])
    if ax is not None:
        # o split by heads, the reference's constrain of it to "model"
        # (repro/models/layers.py:102 dense, :141 chunked): the row-split
        # wo product summed
        out = tp.reduce(out, ax)
    return x + out


def _local_kv(cfg: ArchConfig, ax, n_q: int, w):
    """The columns of ``w`` (wk or wv, (D, kv heads, hd)) that the rank's
    ``n_q`` q heads read: ``w`` itself where the kv heads are split with
    the q heads; where they are whole (their count does not divide the
    axis: llama3-8b's 8 on 16 ranks), the one kv head of the group the q
    heads lie in."""
    if w.shape[1] * ax.size == cfg.n_kv_heads:
        return w
    return _kv_heads(cfg, ax, n_q, w, 1)


def _kv_heads(cfg: ArchConfig, ax, n_q: int, t, dim: int):
    """The kv heads (dim ``dim`` of ``t``, which holds all
    ``cfg.n_kv_heads``) that the rank's ``n_q`` q heads read: its block
    where the kv heads divide the axis, else the one kv head of the group
    its q heads lie in."""
    K, G = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    if t.shape[dim] != K:
        raise ValueError(f"{t.shape[dim]} of {K} kv heads")
    if K % ax.size == 0:
        return t.narrow(dim, ax.rank * (K // ax.size), K // ax.size)
    if G % n_q:
        raise ValueError(f"{n_q} q heads a rank over {K} kv heads: not "
                         f"within one group")
    return t.narrow(dim, ax.rank * n_q // G, 1)


def _new_kv(cfg: ArchConfig, h, w, ax):
    """A decode step's new keys or values (B, 1, every kv head, hd):
    under a sharded step the rank's kv heads gathered over the model
    axis, or, where ``w`` is whole on it, ``tensor_parallel``'s
    ``whole_product``."""
    if ax is None:
        return _heads_in(h, w)
    if w.shape[1] != cfg.n_kv_heads:
        return tp.gather(_heads_in(h, w), ax, dim=2)
    return tp.whole_product(h, w.flatten(1)).unflatten(-1, w.shape[1:])


def _write_at(c, pos, new, sq):
    """Row b of the cache ``c`` (B, positions, ...) written in place at
    ``pos[b]``, clamped into the cache as ``dynamic_update_slice`` clamps;
    with ``sq`` the cache is the rank's block of the positions, and only
    the rank whose block holds a row's position writes it."""
    B, n = c.shape[:2]
    rows = torch.arange(B, device=c.device)
    if sq is None:
        c[rows, pos.long().clamp(0, n - 1)] = new
        return
    at = pos.long().clamp(0, n * sq.size - 1) - sq.rank * n
    mine = ((at >= 0) & (at < n)).view(B, *[1] * (new.dim() - 1))
    at = at.clamp(0, n - 1)
    c[rows, at] = torch.where(mine, new, c[rows, at])


def _valid(pos, n: int, sq, device):
    """(B, 1, 1, n): which of the cache's ``n`` positions (with ``sq``,
    the rank's block of them) a row at ``pos`` reads."""
    at = torch.arange(n, device=device)
    if sq is not None:
        at = at + sq.rank * n
    return (at[None, :] <= pos[:, None])[:, None, None, :]


def _on_model(ax, sq) -> bool:
    """Whether a sharded decode step's cache positions lie on the axis its
    heads are split over: each rank then attends every head over its
    positions."""
    return ax is not None and sq is not None and sq.name == ax.name


def attn_decode(cfg: ArchConfig, p, x, cache, pos):
    """One-token decode. x: (B, 1, D); cache: {k,v: (B, Smax, K, hd)};
    pos: (B,) current write position.  The cache is written in place (row b
    at ``pos[b]``, clamped into the cache as ``dynamic_update_slice``
    clamps) and returned.

    Under a sharded decode step (no gradient) ``wq``, ``wk``, ``wv`` and
    ``wo`` may hold the rank's heads and the cache the rank's block of the
    positions (``tensor_parallel.sequence``): the rank computes its q heads
    and every kv head's new key and value (``_new_kv``), writes them where
    its block holds ``pos``, and attends over its positions, the softmax
    combined over the sequence's axis (``_sdpa``).  Where that axis is the
    heads' (the batch split over the data axes), it attends every head,
    its q heads gathered, and keeps its own heads' output; elsewhere (one
    row: the positions over "data") its own heads.  The row-split ``wo``
    product is summed over the model axis."""
    wq = p["wq"]
    ax = tp.split(wq.shape[1], cfg.n_heads)
    sq = tp.sequence()
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    q = _heads_in(h, wq)
    k = _new_kv(cfg, h, p["wk"], ax)
    v = _new_kv(cfg, h, p["wv"], ax)
    q = apply_rope(q, pos[:, None], cfg.rope_theta)
    k = apply_rope(k, pos[:, None], cfg.rope_theta)
    ck, cv = cache["k"], cache["v"]
    _write_at(ck, pos, k[:, 0], sq)
    _write_at(cv, pos, v[:, 0], sq)
    valid = _valid(pos, ck.shape[1], sq, x.device)
    Hl = q.shape[2]
    if _on_model(ax, sq):
        q = tp.gather(q, ax, dim=2)
    elif ax is not None:
        ck, cv = (_kv_heads(cfg, ax, Hl, t, 2) for t in (ck, cv))
    H, K = q.shape[2], ck.shape[2]
    o = _sdpa(cfg, q, _repeat_kv(ck, H // K), _repeat_kv(cv, H // K), valid,
              x.dtype, sq)
    if H != Hl:
        o = o.narrow(2, ax.rank * Hl, Hl)
    out = _heads_out(o, p["wo"])
    if ax is not None:
        out = tp.reduce(out, ax)
    return x + out, {"k": cache["k"], "v": cache["v"]}


def init_attn_cache(cfg: ArchConfig, B, Smax, dt, device):
    K, hd = cfg.n_kv_heads, cfg.hd
    return {"k": torch.zeros((B, Smax, K, hd), dtype=dt, device=device),
            "v": torch.zeros((B, Smax, K, hd), dtype=dt, device=device)}


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------


def init_mla(cfg: ArchConfig, gen: torch.Generator, device):
    m = cfg.mla
    D, H = cfg.d_model, cfg.n_heads
    dt = _dt(cfg)
    s = D ** -0.5
    qd = m.nope_head_dim + m.rope_head_dim
    return {
        "wdq": _normal(gen, (D, m.q_lora_rank), s, dt, device),
        "wuq": _normal(gen, (m.q_lora_rank, H, qd), m.q_lora_rank ** -0.5,
                       dt, device),
        "wdkv": _normal(gen, (D, m.kv_lora_rank + m.rope_head_dim), s, dt,
                        device),
        "wukv": _normal(gen, (m.kv_lora_rank, H,
                              m.nope_head_dim + m.v_head_dim),
                        m.kv_lora_rank ** -0.5, dt, device),
        "wo": _normal(gen, (H, m.v_head_dim, D), s, dt, device),
        "norm": torch.ones((D,), dtype=dt, device=device),
    }


def _mla_qkv(cfg, p, h, positions, ax=None):
    """(q_nope, q_rope (B,S,H,.), c_kv (B,S,r), k_rope (B,S,rope_hd)).
    Under a tensor-parallel step (``ax``) the latents, whole on "model",
    enter the split region before ``wuq`` splits their heads (k_rope,
    which every head reads, among them); a decode step splits the down
    projections' contraction (``tensor_parallel.whole_product``)."""
    m = cfg.mla
    cq, ckv = tp.whole_product(h, p["wdq"]), tp.whole_product(h, p["wdkv"])
    if ax is not None:
        cq, ckv = tp.enter(cq, ax), tp.enter(ckv, ax)
    q = _heads_in(cq, p["wuq"])
    q_nope, q_rope = q.split([m.nope_head_dim, m.rope_head_dim], dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv, k_rope = ckv.split([m.kv_lora_rank, m.rope_head_dim], dim=-1)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope[:, :, 0, :]


def _mla_attend(cfg, p, x, q_nope, q_rope, c_kv, k_rope, valid, ax=None,
                sq=None):
    """c_kv: (B, T, r); k_rope: (B, T, rope_hd) shared across heads; valid:
    a mask broadcastable to (B, H, S, T), or None for none.  Under a
    tensor-parallel step (``ax``) the heads are the rank's (``wukv`` and
    ``wo`` split) and the row-split ``wo`` product is summed over the
    axis.  With ``sq`` (a sharded decode step) c_kv and k_rope are the
    rank's block of the positions and the softmax is combined over it:
    where its positions lie on the heads' axis, every head's queries are
    gathered, the latents expanded by ``wukv`` whole (the step gathers it
    so) and the rank's heads of the output kept; elsewhere ``wukv`` is cut
    to the rank's heads."""
    m = cfg.mla
    Hl, wukv = q_nope.shape[2], p["wukv"]
    if _on_model(ax, sq):
        q_nope, q_rope = (tp.gather(t, ax, dim=2) for t in (q_nope, q_rope))
    elif wukv.shape[1] != Hl:
        wukv = wukv.narrow(1, ax.rank * Hl, Hl)
    kv = _heads_in(c_kv, wukv)                            # (B, T, H, e)
    k_nope, v = kv.split([m.nope_head_dim, m.v_head_dim], dim=-1)
    sc = torch.einsum("bshq,bthq->bhst", q_nope, k_nope)
    sc = sc + torch.einsum("bshq,btq->bhst", q_rope, k_rope)
    sc = sc.float() * ((m.nope_head_dim + m.rope_head_dim) ** -0.5)
    if valid is not None:
        sc = torch.where(valid, sc, -1e30)
    if sq is None:
        w = torch.softmax(sc, dim=-1).to(x.dtype)
    else:
        e = torch.exp(sc - tp.all_reduce(sc.amax(dim=-1, keepdim=True),
                                         "max", sq))
        w = (e / tp.all_reduce(e.sum(dim=-1, keepdim=True), "sum",
                               sq)).to(x.dtype)
    o = torch.einsum("bhst,bthv->bshv", w, v)
    if sq is not None:
        o = tp.all_reduce(o, "sum", sq)
    if o.shape[2] != Hl:
        o = o.narrow(2, ax.rank * Hl, Hl)
    out = _heads_out(o, p["wo"])
    if ax is not None:
        # the reference's constrain of kv, q_nope and the scores to heads
        # on "model" (repro/models/layers.py:240-246)
        out = tp.reduce(out, ax)
    return x + out


def mla_forward(cfg: ArchConfig, p, x, positions, causal=True):
    """Full-sequence MLA.  x: (B, S, D); positions: (B, S), or None for
    ``arange(S)`` in every row.  The head count is ``wuq``'s: under a
    tensor-parallel step the rank's share."""
    ax = tp.split(p["wuq"].shape[1], cfg.n_heads)
    if positions is None:
        B, S = x.shape[:2]
        positions = torch.arange(S, device=x.device).expand(B, S)
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(cfg, p, h, positions, ax)
    valid = (positions[:, None, :, None] >= positions[:, None, None, :]) \
        if causal else None
    return _mla_attend(cfg, p, x, q_nope, q_rope, c_kv, k_rope, valid, ax)


def mla_decode(cfg: ArchConfig, p, x, cache, pos):
    """One-token decode.  The cache holds the COMPRESSED latents
    {ckv: (B, Smax, kv_lora + rope_hd)}, not 2*H*hd per token; row b is
    written in place at ``pos[b]`` (clamped into the cache, as
    ``dynamic_update_slice`` clamps) and the cache returned.  Under a
    sharded decode step (no gradient) the heads may be the rank's and the
    cache its block of the positions, as in ``attn_decode``
    (``_mla_attend``)."""
    ax = tp.split(p["wuq"].shape[1], cfg.n_heads)
    sq = tp.sequence()
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    q_nope, q_rope, c_kv_new, k_rope_new = _mla_qkv(cfg, p, h, pos[:, None])
    ck = cache["ckv"]
    _write_at(ck, pos, torch.cat([c_kv_new, k_rope_new], dim=-1)[:, 0], sq)
    c_kv, k_rope = ck.split([cfg.mla.kv_lora_rank, cfg.mla.rope_head_dim],
                            dim=-1)
    valid = _valid(pos, ck.shape[1], sq, x.device)
    out = _mla_attend(cfg, p, x, q_nope, q_rope, c_kv, k_rope, valid, ax, sq)
    return out, {"ckv": ck}


def init_mla_cache(cfg: ArchConfig, B, Smax, dt, device):
    m = cfg.mla
    return {"ckv": torch.zeros((B, Smax, m.kv_lora_rank + m.rope_head_dim),
                               dtype=dt, device=device)}


# ---------------------------------------------------------------------------
# FFN: swiglu / geglu / gelu  + MoE
# ---------------------------------------------------------------------------


def init_mlp(cfg: ArchConfig, gen: torch.Generator, device, d_ff=None):
    D = cfg.d_model
    Fw = d_ff or cfg.d_ff
    dt = _dt(cfg)
    p = {"norm": torch.ones((D,), dtype=dt, device=device),
         "w_up": _normal(gen, (D, Fw), D ** -0.5, dt, device),
         "w_down": _normal(gen, (Fw, D), Fw ** -0.5, dt, device)}
    if cfg.act in ("swiglu", "geglu"):
        p["w_gate"] = _normal(gen, (D, Fw), D ** -0.5, dt, device)
    return p


def mlp_forward(cfg: ArchConfig, p, x, d_ff=None):
    """The FFN of width ``d_ff`` (``cfg.d_ff`` when None; the MoE's shared
    experts pass theirs); under a tensor-parallel step ``w_up``/``w_gate``
    may hold the rank's columns and ``w_down`` its rows (the width split
    over the model axis), the output then summed over the axis."""
    ax = tp.split(p["w_down"].shape[0], d_ff or cfg.d_ff)
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    if ax is not None:
        h = tp.enter(h, ax)
    up = h @ p["w_up"]
    # jax.nn.gelu's default is the tanh approximation
    if cfg.act == "swiglu":
        up = F.silu(h @ p["w_gate"]) * up
    elif cfg.act == "geglu":
        up = F.gelu(h @ p["w_gate"], approximate="tanh") * up
    else:  # gelu (whisper-style 2-matrix MLP)
        up = F.gelu(up, approximate="tanh")
    out = up @ p["w_down"]
    if ax is not None:
        # up split by columns: the reference's constrain of up to "model"
        # (repro/models/layers.py:310); the row-split product summed
        out = tp.reduce(out, ax)
    return x + out


def init_moe(cfg: ArchConfig, gen: torch.Generator, device):
    """The router in f32, the routed experts' weights (E, D, F) / (E, F, D)
    and, with shared experts, one MLP of width ``d_ff * n_shared``."""
    D = cfg.d_model
    mc = cfg.moe
    E, Fw = mc.n_experts, mc.d_ff
    dt = _dt(cfg)
    p = {"norm": torch.ones((D,), dtype=dt, device=device),
         "router": _normal(gen, (D, E), D ** -0.5, torch.float32, device),
         "w_gate": _normal(gen, (E, D, Fw), D ** -0.5, dt, device),
         "w_up": _normal(gen, (E, D, Fw), D ** -0.5, dt, device),
         "w_down": _normal(gen, (E, Fw, D), Fw ** -0.5, dt, device)}
    if mc.n_shared:
        p["shared"] = init_mlp(cfg, gen, device, d_ff=Fw * mc.n_shared)
    return p


def moe_capacity(cfg: ArchConfig, Tg: int) -> int:
    """Slots per expert and group of ``Tg`` tokens, in Python floats as the
    reference computes it."""
    mc = cfg.moe
    return max(1, int(Tg * mc.top_k * mc.capacity_factor / mc.n_experts))


def moe_route(cfg: ArchConfig, p, h, gidx=None) -> dict:
    """The router and the capacity dispatch tables of ``moe_forward`` for
    the normed activations h (G, Tg, D), one group per batch row:

    * ``logits`` (G, Tg, E) f32, ``gval`` / ``gidx`` (G, Tg, K): the top-k
      of the softmax gates, renormalised; a given ``gidx`` routes the
      pairs to those experts instead, its gates read there (two steps held
      to one routing, where their sums' rounding would flip near ties);
    * ``posc`` (G, Tg, K): each (t, k)'s rank among the pairs routed to
      its expert, in (t, k) order (a stable sort of the flat expert ids);
      ``keep`` = ``posc < C``; ``slot`` = ``gidx * C + posc``;
    * ``src`` / ``vld`` (G, E*C): the token each expert slot takes and
      whether a pair filled it (dropped pairs went to an overflow bucket
      ``E*C``, sliced away; its duplicate writes are unordered);
    * ``C``, the capacity.

    Fixed shapes throughout (no ``nonzero``, no boolean indexing, no
    ``.item()``), so a CUDA graph captures it."""
    G, Tg, _ = h.shape
    mc = cfg.moe
    E, K = mc.n_experts, mc.top_k
    dev = h.device
    logits = tp.whole_product(h.float(), p["router"])
    gates = torch.softmax(logits, dim=-1)
    if gidx is None:
        gval, gidx = torch.topk(gates, K, dim=-1)
    else:
        gval = torch.gather(gates, -1, gidx)
    gval = gval / (gval.sum(dim=-1, keepdim=True) + 1e-9)
    C = moe_capacity(cfg, Tg)
    N = Tg * K
    eflat = gidx.reshape(G, N)
    order = torch.argsort(eflat, dim=1, stable=True)
    sorted_e = torch.gather(eflat, 1, order)
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    ranks = torch.arange(N, device=dev)[None, :] - first
    posc = torch.zeros_like(eflat).scatter_(1, order, ranks).reshape(G, Tg, K)
    keep = posc < C
    slot = gidx * C + posc
    flat_slot = torch.where(keep, slot, E * C).reshape(G, N)
    tok = torch.arange(Tg, device=dev).repeat_interleave(K).expand(G, N)
    src = torch.zeros((G, E * C + 1), dtype=torch.int64, device=dev) \
        .scatter_(1, flat_slot, tok)[:, :E * C]
    vld = torch.zeros((G, E * C + 1), dtype=h.dtype, device=dev) \
        .scatter_(1, flat_slot, torch.ones((G, N), dtype=h.dtype,
                                           device=dev))[:, :E * C]
    return {"logits": logits, "gval": gval, "gidx": gidx, "posc": posc,
            "keep": keep, "slot": slot, "src": src, "vld": vld, "C": C}


def moe_forward(cfg: ArchConfig, p, x):
    """Grouped capacity-based top-k MoE with gather/scatter dispatch (one
    group per batch row), the reference's semantics exactly: pairs past an
    expert's capacity are dropped, the rest gathered into (E, C) slots,
    each expert's slots of all groups go through its weights in one
    ``bmm`` against the (E, D, F) tensors as stored, and the outputs are
    gathered back and weighted by the kept gates.  With shared experts the
    shared MLP carries the residual (its own norm); else ``x + out``.

    Under a tensor-parallel step the expert weights may hold the rank's
    E / m experts (expert parallelism over "model", the reference's
    constrain of the expert buffers to "ep", repro/models/layers.py:378,
    382): the routing is computed whole, as on every model rank (the
    router is whole and the ranks hold the same tokens), the rank's
    experts take their slots alone, each (t, k) pair is combined only
    where its expert is the rank's (zeros elsewhere), and the sum over
    the axis gives every pair once.  The normed tokens and the gates enter
    the split region, so the router's gradient comes out whole."""
    B, S, D = x.shape
    mc = cfg.moe
    E, K = mc.n_experts, mc.top_k
    G, Tg = B, S
    El = p["w_gate"].shape[0]
    ax = tp.split(El, E)
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    r = moe_route(cfg, p, h)
    C = r["C"]
    src, vld, slot, gval = r["src"], r["vld"], r["slot"], r["gval"]
    w = r["keep"].to(x.dtype)
    if ax is not None:
        e0 = ax.rank * El
        h, gval = tp.enter(h, ax), tp.enter(gval, ax)
        src, vld = (t[:, e0 * C:(e0 + El) * C] for t in (src, vld))
        slot = slot - e0 * C
        w = w * ((r["gidx"] >= e0) & (r["gidx"] < e0 + El)).to(x.dtype)
    # dispatch: the slots' tokens (the empty ones times 0, as gathered)
    xin = torch.gather(h, 1, src[..., None].expand(G, El * C, D)) \
        * vld[..., None]
    xe = xin.reshape(G, El, C, D).transpose(0, 1).reshape(El, G * C, D)
    mid = F.silu(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    xout = torch.bmm(mid, p["w_down"])                    # (El, G*C, D)
    flat = xout.reshape(El, G, C, D).transpose(0, 1).reshape(G, El * C, D)
    # combine: each (t, k)'s slot back, weighted by its gate if kept
    idx = slot.clamp(0, El * C - 1).reshape(G, Tg * K)
    vals = torch.gather(flat, 1, idx[..., None].expand(G, Tg * K, D)) \
        .reshape(G, Tg, K, D)
    out = (vals * (gval.to(x.dtype) * w)[..., None]).sum(dim=2)
    if ax is not None:
        out = tp.reduce(out, ax)
    if mc.n_shared:
        return mlp_forward(cfg, p["shared"], x, mc.d_ff * mc.n_shared) + out
    return x + out


# ---------------------------------------------------------------------------
# Mamba (selective SSM): chunked, each chunk a log-depth scan
# ---------------------------------------------------------------------------


def init_mamba(cfg: ArchConfig, gen: torch.Generator, device):
    """Jamba's Mamba layer; ``a_log`` and ``d_skip`` are f32 whatever the
    layer's dtype, as in the reference."""
    D = cfg.d_model
    di = cfg.mamba_expand * D
    N = cfg.mamba_d_state
    kc = cfg.mamba_d_conv
    dt_rank = max(1, D // 16)
    dt = _dt(cfg)
    a = torch.arange(1, N + 1, dtype=torch.float32, device=device)
    return {
        "norm": torch.ones((D,), dtype=dt, device=device),
        "w_in": _normal(gen, (D, 2 * di), D ** -0.5, dt, device),
        "conv_w": _normal(gen, (kc, di), kc ** -0.5, dt, device),
        "w_bc": _normal(gen, (di, 2 * N), di ** -0.5, dt, device),
        "w_dt": _normal(gen, (di, dt_rank), di ** -0.5, dt, device),
        "w_dt2": _normal(gen, (dt_rank, di), dt_rank ** -0.5, dt, device),
        "a_log": torch.log(a).expand(di, N).contiguous(),
        "d_skip": torch.ones((di,), dtype=torch.float32, device=device),
        "w_out": _normal(gen, (di, D), di ** -0.5, dt, device),
    }


def _linear_scan(a, b):
    """h_t = a_t * h_{t-1} + b_t along dim 1 from h_{-1} = 0, for f32 decays
    ``a`` and drives ``b`` of shape (B, S, ...): Hillis-Steele's log2(S)
    steps, each combining every position with the one ``d`` before it by
    the reference's associative combine.  Every factor is a decay in
    (0, 1], so nothing overflows (the closed form through exp(-cumsum)
    would, at dt * A down to -16 a token).  Under autograd (training) each
    step is the same arithmetic out of place, as ``out=`` takes no grad."""
    S = a.shape[1]
    grad = torch.is_grad_enabled() and (a.requires_grad or b.requires_grad)
    d = 1
    while d < S:
        if grad:
            nb = torch.cat([b[:, :d], torch.addcmul(b[:, d:], a[:, d:],
                                                    b[:, :-d])], dim=1)
        else:
            nb = torch.empty_like(b)
            nb[:, :d] = b[:, :d]
            torch.addcmul(b[:, d:], a[:, d:], b[:, :-d], out=nb[:, d:])
        if 2 * d < S:
            if grad:
                a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
            else:
                na = torch.empty_like(a)
                na[:, :d] = a[:, :d]
                torch.mul(a[:, d:], a[:, :-d], out=na[:, d:])
                a = na
        b = nb
        d *= 2
    return b


def _row_split(h, w, ax):
    """``h @ w`` where ``w``'s rows (the contraction) are the rank's
    channels under a tensor-parallel step (``ax``): each rank's partial
    product is taken and summed over the axis in f32 and rounded to
    ``h``'s dtype once, as one device's product is.  A Mamba layer's
    ``w_dt`` product feeds exp(dt * A) with |A| up to 16, where partial
    sums rounded to bf16 before the sum moved a step's gradient norm by
    several 1e-3 against one device's."""
    if ax is None:
        return h @ w
    return tp.reduce(h.float() @ w.float(), ax).to(h.dtype)


def _mamba_core(cfg, p, xz, h0, conv_tail, ax=None):
    """xz: (B, S, 2*di); h0: the (B, di, N) f32 state carried in, or None
    for zeros; conv_tail: (B, kc-1, di).  Returns (y (B, S, di) in xz's
    dtype, the state after the last token, the new conv tail).  Under a
    tensor-parallel step (``ax``) di is the rank's channels: the row-split
    ``w_bc`` and ``w_dt`` products are summed over the axis
    (``_row_split``) and enter the split region again (every channel reads
    them)."""
    S = xz.shape[1]
    kc = cfg.mamba_d_conv
    x, z = xz.chunk(2, dim=-1)
    # causal short conv along S (the tail carries it across calls)
    xp = torch.cat([conv_tail, x], dim=1)
    c = sum(xp[:, i:i + S] * p["conv_w"][i] for i in range(kc))
    new_tail = xp[:, S:S + kc - 1]
    c = F.silu(c)
    bc, cw = _row_split(c, p["w_bc"], ax), _row_split(c, p["w_dt"], ax)
    if ax is not None:
        bc, cw = tp.enter(bc, ax), tp.enter(cw, ax)
    Bm, Cm = bc.chunk(2, dim=-1)                          # (B, S, N)
    # the reference's einsum("bsd,dr,re->bse") contracts c @ w_dt first,
    # rounding it to the layer's dtype
    dt_ = F.softplus((cw @ p["w_dt2"]).float())
    A = -torch.exp(p["a_log"])                           # (di, N)
    decay = torch.exp(dt_[..., None] * A)                # (B, S, di, N)
    drive = (dt_ * c.float())[..., None] * Bm[:, :, None, :]
    if h0 is not None:                # h_0 = decay_0 * h0 + drive_0
        drive[:, 0] += decay[:, 0] * h0
    h = _linear_scan(decay, drive)
    y = torch.einsum("bsdn,bsn->bsd", h, Cm.float())
    y = y + p["d_skip"] * c.float()
    y = y.to(xz.dtype) * F.silu(z)
    return y, h[:, -1], new_tail


def _mamba_in(cfg: ArchConfig, p, x):
    """(the layer's ``[x | z]`` (B, S, 2 * channels), the model axis its
    channels are split over or None).  Under a tensor-parallel step
    ``conv_w`` and the other channel-wise weights may hold the rank's
    channels and ``w_in`` its columns: the normed input enters the split
    region and the rank's column block of ``h @ w_in``, half x's channels
    and half z's at a 2-way axis, is exchanged for its own channels of
    each (``tensor_parallel.exchange``), where the reference constrains
    ``xz`` to "model" (repro/models/layers.py:461) and XLA reshards it."""
    ax = tp.split(p["conv_w"].shape[1], cfg.mamba_expand * cfg.d_model)
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    if ax is None:
        return h @ p["w_in"], None
    return tp.exchange(tp.enter(h, ax) @ p["w_in"], ax), ax


def _mamba_out(y, p, ax):
    """The ``w_out`` product, its rows the rank's channels under a
    tensor-parallel step, summed over the axis (``_row_split``)."""
    return _row_split(y, p["w_out"], ax)


def mamba_forward(cfg: ArchConfig, p, x, chunk=256):
    """Full-sequence Mamba, ``chunk`` tokens a scan, the state and conv
    tail carried from chunk to chunk; ``S % min(chunk, S) == 0`` as in the
    reference.  Under a tensor-parallel step each rank runs its channels
    (``_mamba_in``), its scan on (B, S, di / m, N)."""
    B, S, D = x.shape
    xz, ax = _mamba_in(cfg, p, x)
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"mamba: {S} tokens are not a multiple of chunk "
                         f"{chunk}")
    state = None
    tail = torch.zeros((B, cfg.mamba_d_conv - 1, p["conv_w"].shape[1]),
                       dtype=xz.dtype, device=x.device)
    ys = []
    for s0 in range(0, S, chunk):
        y, state, tail = _mamba_core(cfg, p, xz[:, s0:s0 + chunk], state,
                                     tail, ax)
        ys.append(y)
    return x + _mamba_out(torch.cat(ys, dim=1), p, ax)


def mamba_decode(cfg: ArchConfig, p, x, cache):
    """One-token decode; cache = {h: (B, di, N) f32, tail: (B, kc-1, di)},
    returned as new tensors (``lm.decode_step_into`` copies them back).
    Under a sharded decode step the rank runs its channels: a state or
    tail given whole is cut to them, and the new ones are the rank's (the
    step makes them whole where the cache holds them whole)."""
    xz, ax = _mamba_in(cfg, p, x)
    h0, tail = cache["h"], cache["tail"]
    if ax is not None:
        n = p["conv_w"].shape[1]
        if h0.shape[1] != n:
            h0 = h0.narrow(1, ax.rank * n, n)
        if tail.shape[2] != n:
            tail = tail.narrow(2, ax.rank * n, n)
    y, h1, tail1 = _mamba_core(cfg, p, xz, h0, tail, ax)
    return x + _mamba_out(y, p, ax), {"h": h1, "tail": tail1}


def init_mamba_cache(cfg: ArchConfig, B, dt, device):
    di = cfg.mamba_expand * cfg.d_model
    return {"h": torch.zeros((B, di, cfg.mamba_d_state), dtype=torch.float32,
                             device=device),
            "tail": torch.zeros((B, cfg.mamba_d_conv - 1, di), dtype=dt,
                                device=device)}


# ---------------------------------------------------------------------------
# RWKV-6 (Finch): time mix (WKV6) + channel mix
# ---------------------------------------------------------------------------


def init_rwkv(cfg: ArchConfig, gen: torch.Generator, device):
    D = cfg.d_model
    dt = _dt(cfg)
    s = D ** -0.5
    return {
        "norm_a": torch.ones((D,), dtype=dt, device=device),
        "norm_f": torch.ones((D,), dtype=dt, device=device),
        "mix": _normal(gen, (5, D), 0.01, dt, device),
        "wr": _normal(gen, (D, D), s, dt, device),
        "wk": _normal(gen, (D, D), s, dt, device),
        "wv": _normal(gen, (D, D), s, dt, device),
        "wg": _normal(gen, (D, D), s, dt, device),
        "wdecay": _normal(gen, (D, D), 0.01, dt, device),
        "u_bonus": _normal(gen, (D,), 0.1, torch.float32, device),
        "wo": _normal(gen, (D, D), s, dt, device),
        # channel mix
        "ck": _normal(gen, (D, cfg.d_ff), s, dt, device),
        "cv": _normal(gen, (cfg.d_ff, D), cfg.d_ff ** -0.5, dt, device),
        "cmix": _normal(gen, (D,), 0.01, dt, device),
    }


def _token_shift(x, last):
    """shift right by one along S; ``last`` is (B,1,D) carry."""
    return torch.cat([last, x[:, :-1]], dim=1)


def rwkv_time_mix(cfg: ArchConfig, p, x, shift_last, s0, chunk=128,
                  s_out=None):
    """Returns (y, normalized last token (B,1,D), final WKV state).  ``s0``
    is the (B,H,hd,hd) f32 carried state, or None for zeros; the final
    state goes to ``s_out`` when given (which may be ``s0``: an in-place
    update), else to a new tensor.  The WKV6 kernel reads r, k, v, w as
    (B, H, S, hd) views of their (B, S, D) activations and writes its
    output into one in x's dtype; under autograd it returns its output in
    r's layout instead (an in-place write takes no grad), whose (B, S, D)
    view costs no copy either; ``chunk`` only keeps the reference's
    precondition ``S % min(chunk, S) == 0``.

    Under a tensor-parallel step ``wr``, ``wg``, ``wdecay`` and
    ``u_bonus`` may hold the rank's columns and ``wk``, ``wv`` and ``wo``
    its rows: ``_rwkv_split`` then computes the rank's share (a decode
    step's state: its heads')."""
    hd = cfg.rwkv_head_dim
    ax = tp.split(p["wr"].shape[1], x.shape[-1])
    h = rms_norm(x, p["norm_a"], cfg.norm_eps)
    prev = _token_shift(h, shift_last)
    mix = torch.sigmoid(p["mix"])                         # (5, D)
    feats = [h + (prev - h) * mix[i] for i in range(5)]
    if ax is not None:
        return _rwkv_split(cfg, p, x, h, feats, ax, chunk, s0)
    r = feats[0] @ p["wr"]
    k = feats[1] @ p["wk"]
    v = feats[2] @ p["wv"]
    g = F.silu(feats[3] @ p["wg"])
    w = torch.exp(-torch.exp((feats[4] @ p["wdecay"]).float() - 4.0))
    out, s_fin = _wkv(r, k, v, w, p["u_bonus"], s0, hd, chunk, s_out)
    y = x + (out * g) @ p["wo"]
    return y, h[:, -1:], s_fin


def _wkv(r, k, v, w, u, s0, hd: int, chunk: int, s_out=None):
    """K5 over the (B, S, n) activations r, k, v, w (n = H * hd) and the
    bonus u (n,): (its output (B, S, n) in r's dtype, the final state)."""
    B, S, n = r.shape
    H = n // hd
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"rwkv time mix: {S} tokens are not a multiple of "
                         f"chunk {chunk}")

    def heads(t):                  # (B,S,n) -> a (B,H,S,hd) view
        return t.reshape(B, S, H, hd).transpose(1, 2)

    u = u.reshape(H, hd)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (r, k, v, w, u, s0)):
        o, s_fin = wkv6_state(heads(r), heads(k), heads(v), heads(w), u, s0,
                              s_out=s_out)
        return o.transpose(1, 2).reshape(B, S, n), s_fin
    out = torch.empty((B, S, n), dtype=r.dtype, device=r.device)
    _, s_fin = wkv6_state(heads(r), heads(k), heads(v), heads(w), u, s0,
                          out=heads(out), s_out=s_out)
    return out, s_fin


def _rwkv_split(cfg: ArchConfig, p, x, h, feats, ax, chunk: int, s0=None):
    """The time mix of a tensor-parallel step, at the reference's
    constrain of r, k, v, w to heads on "model" (repro/models/
    layers.py:571-574).  Each mixed input enters the split region (the
    mixes before it are whole on "model").  r, g and w are the rank's
    columns (``wr``, ``wg``, ``wdecay``); k and v are the rank's columns
    of a sum of the ranks' row blocks (``wk``, ``wv``: the reference's
    3-entry attention rule cut to its last two), reduce-scattered.  Where
    the rank's columns are not whole heads (rwkv6-3b's 40 heads on 16
    ranks) the reference's ``fit_spec`` makes the heads whole: r, w and u
    are gathered and k and v summed whole, K5 runs every head, and its
    output enters the region again, cut back to the rank's columns.  The
    row-split ``wo`` product is summed over the axis.  A carried state
    ``s0`` (a decode step's, no gradient) given with every head is cut to
    the rank's heads, and the final state is the rank's heads' (every
    head's where K5 runs them all)."""
    n = p["wr"].shape[1]
    cols = slice(ax.rank * n, (ax.rank + 1) * n)
    feats = [tp.enter(f, ax) for f in feats]
    whole = n % cfg.rwkv_head_dim != 0
    to_cols = tp.reduce if whole else tp.reduce_scatter
    r = feats[0] @ p["wr"]
    k = to_cols(feats[1][..., cols] @ p["wk"], ax)
    v = to_cols(feats[2][..., cols] @ p["wv"], ax)
    g = F.silu(feats[3] @ p["wg"])
    w = torch.exp(-torch.exp((feats[4] @ p["wdecay"]).float() - 4.0))
    u = p["u_bonus"]
    if whole:
        r, w, u = (tp.gather(t, ax) for t in (r, w, u))
    elif s0 is not None and s0.shape[1] * cfg.rwkv_head_dim != n:
        hl = n // cfg.rwkv_head_dim
        s0 = s0.narrow(1, ax.rank * hl, hl).contiguous()
    out, s_fin = _wkv(r, k, v, w, u, s0, cfg.rwkv_head_dim, chunk)
    if whole:
        out = tp.enter(out, ax)[..., cols]
    y = x + tp.reduce((out * g) @ p["wo"], ax)
    return y, h[:, -1:], s_fin


def rwkv_channel_mix(cfg: ArchConfig, p, x, shift_last):
    """The channel mix; under a tensor-parallel step ``ck`` may hold the
    rank's columns and ``cv`` its rows (``cfg.d_ff`` split over the model
    axis), the replicated mix entering the split region and the output
    summed over the axis."""
    ax = tp.split(p["ck"].shape[1], cfg.d_ff)
    h = rms_norm(x, p["norm_f"], cfg.norm_eps)
    prev = _token_shift(h, shift_last)
    mixed = h + (prev - h) * torch.sigmoid(p["cmix"])
    if ax is not None:
        mixed = tp.enter(mixed, ax)
    v = torch.square(torch.relu(mixed @ p["ck"])) @ p["cv"]
    if ax is not None:
        v = tp.reduce(v, ax)
    return x + v, h[:, -1:]


def rwkv_forward(cfg: ArchConfig, p, x):
    B, S, D = x.shape
    zero = torch.zeros((B, 1, D), dtype=x.dtype, device=x.device)
    y, _, _ = rwkv_time_mix(cfg, p, x, zero, None)
    y, _ = rwkv_channel_mix(cfg, p, y, zero)
    return y


def rwkv_decode(cfg: ArchConfig, p, x, cache, in_place=False):
    """One-token decode.  The WKV state is returned in a new tensor, or
    (``in_place``) written over ``cache["s"]``, which is then returned."""
    y, sa, s1 = rwkv_time_mix(cfg, p, x, cache["shift_a"], cache["s"],
                              chunk=1, s_out=cache["s"] if in_place else None)
    y, sf = rwkv_channel_mix(cfg, p, y, cache["shift_f"])
    return y, {"shift_a": sa, "shift_f": sf, "s": s1}


def init_rwkv_cache(cfg: ArchConfig, B, dt, device):
    D = cfg.d_model
    hd = cfg.rwkv_head_dim
    H = D // hd
    return {"shift_a": torch.zeros((B, 1, D), dtype=dt, device=device),
            "shift_f": torch.zeros((B, 1, D), dtype=dt, device=device),
            "s": torch.zeros((B, H, hd, hd), dtype=torch.float32,
                             device=device)}


# ---------------------------------------------------------------------------
# cross attention (the Whisper decoder)
# ---------------------------------------------------------------------------


def init_cross_attn(cfg: ArchConfig, gen: torch.Generator, device):
    return init_attn(cfg, gen, device)


def cross_attn_forward(cfg: ArchConfig, p, x, enc_out):
    """x (B, S, D) attends over the encoder's output (B, T, D): no rope,
    all T positions visible, through plain ``_sdpa`` as in the reference
    (the port sends only chunked causal attention to K4).  Under a
    tensor-parallel step ``wq`` and ``wo`` may hold the rank's heads: the
    normed input and the encoder's output enter the split region, the
    rank's q heads read their kv heads (``_local_kv``) and the row-split
    ``wo`` product is summed over the axis."""
    B, S, _ = x.shape
    wq, wk, wv = p["wq"], p["wk"], p["wv"]
    ax = tp.split(wq.shape[1], cfg.n_heads)
    T = enc_out.shape[1]
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    if ax is not None:
        h, enc_out = tp.enter(h, ax), tp.enter(enc_out, ax)
        wk, wv = (_local_kv(cfg, ax, wq.shape[1], w) for w in (wk, wv))
    q = _heads_in(h, wq)
    k = _heads_in(enc_out, wk)
    v = _heads_in(enc_out, wv)
    H, K = q.shape[2], k.shape[2]
    mask = torch.ones((B, 1, S, T), dtype=torch.bool, device=x.device)
    o = _sdpa(cfg, q, _repeat_kv(k, H // K), _repeat_kv(v, H // K), mask,
              x.dtype)
    out = _heads_out(o, p["wo"])
    if ax is not None:
        out = tp.reduce(out, ax)
    return x + out
