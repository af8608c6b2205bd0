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

The gradient: where grad is enabled and r, k, v, w, u or s0 requires grad,
``wkv6_state`` runs as a ``torch.autograd.Function`` (``_WKV``) on either
device.  Its forward is the kernels above; its backward is ``wkv6_bwd``,
four launches on the card of its one route (``bwd_route``: ``"windows"``)
at every head dim, ``csrc/wkv6_bwd_tc.cu``, whose chunks are cut into
windows of ``BWD_WINDOW`` tokens with the products across a window on the
tensor cores (at hd 128 a cluster of ``BWD_RANKS[128]`` CTAs splits the
state's columns).  On the CPU it runs its plain version,
``wkv6_bwd_windowed_plain``; ``wkv6_bwd_chunked_plain``, the per-token
walk over the same chunks, is the oracle of its schedule in the tests.
The JAX package has no Pallas backward for K5:
it differentiates the chunk form (``repro.models.layers._wkv_chunk``) with
``jax.grad``.  The backward walks the reverse recurrence dS_t = diag(w_t)
dS_{t+1} + r_t^T do_t in chunks of ``BWD_CHUNK[hd]`` tokens and needs the
forward state S_t beside dS_{t+1} at every token (dw_t = rowsum(dS_{t+1} *
S_t)).  S_t cannot be rebuilt backwards without dividing by w, so each
chunk's starting state is recomputed (as the forward's phases 1-2 do) and
each chunk's states are rebuilt forward from it; nothing is saved from the
forward but its inputs.

The wrappers check their inputs, then call operators of the ``repro_torch``
namespace (``torch.library``): ``wkv6`` (its schema declares the writes to
``out`` and ``s_out``, which may be ``s0``: the decode graph's state updated
in place) and ``wkv6_bwd``.  The dispatcher runs each operator's CPU
implementation (the plain version) for CPU tensors, its CUDA one (the
launches) for card tensors and its fake one (shapes and dtypes) for
FakeTensors, so the dry-run's traces hold each call as one node, counted by
the formulas registered here: 5 flops a state entry and token forward, 14
backward.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from .. import _cuda

SOURCE = _cuda.CSRC_DIR / "wkv6.cu"
LIB_NAME = "wkv6"
HEAD_DIMS = (16, 32, 64, 128)   # the kernels' instantiations
CHUNK = 64                      # tokens per chunk of the sequence form
SEQUENCE_LAUNCHES = 3           # launches per call of the sequence form
# the backward's chunk by head dim (the windows route holds three window
# starts of a 64-token chunk at hd <= 64; at hd 128 a window start of a
# 32-token chunk), the CTAs of a cluster that split the state's columns
# between them (their partial sums over the columns added rank 0 first),
# and its launches per call
BWD_CHUNK = {16: 64, 32: 64, 64: 64, 128: 32}
BWD_RANKS = {16: 1, 32: 1, 64: 1, 128: 2}
BWD_LAUNCHES = 4
# the tokens of a window of the backward's chunks
BWD_WINDOW = 16
BWD_TC_SOURCE = _cuda.CSRC_DIR / "wkv6_bwd_tc.cu"
BWD_TC_LIB_NAME = "wkv6_bwd_tc"
_ENTRY = {torch.float32: "wkv6_f32", torch.bfloat16: "wkv6_bf16"}
_BWD_TC_ENTRY = {torch.float32: "wkv6_bwd_tc_f32",
                 torch.bfloat16: "wkv6_bwd_tc_bf16"}

# launches by form: "step" (S == 1, the decode step), "sequence" (S > 1,
# three per call) and "bwd_windows" (the backward, four per call), counted
# at the launch
LAUNCHES: collections.Counter = collections.Counter()


@functools.lru_cache(maxsize=None)
def kernel_source() -> str:
    return SOURCE.read_text()


@functools.lru_cache(maxsize=None)
def _launcher(dtype: torch.dtype):
    lib = _cuda.load(LIB_NAME, kernel_source())
    return lib, _cuda.entry(lib, _ENTRY[dtype], [ctypes.c_void_p] * 11
                            + [ctypes.c_int] * 5 + [ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def bwd_tc_kernel_source() -> str:
    return BWD_TC_SOURCE.read_text()


@functools.lru_cache(maxsize=None)
def _bwd_launcher(dtype: torch.dtype):
    lib = _cuda.load(BWD_TC_LIB_NAME, bwd_tc_kernel_source())
    return lib, _cuda.entry(lib, _BWD_TC_ENTRY[dtype], [ctypes.c_void_p] * 19
                            + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def walk_blocks_per_sm(hd: int, dtype: torch.dtype) -> int:
    """The backward's walk (launch 3): its blocks an SM at head dim ``hd``
    as its registers and shared memory allow (CUDA's occupancy calculator,
    on the card)."""
    lib, _ = _bwd_launcher(dtype)
    fn = _cuda.entry(lib, "wkv6_bwd_tc_walk_blocks",
                     [ctypes.c_int, ctypes.c_int,
                      ctypes.POINTER(ctypes.c_int)])
    n = ctypes.c_int(0)
    _cuda.check(lib, fn(hd, int(dtype == torch.bfloat16), ctypes.byref(n)),
                "wkv6 backward: the walk's blocks an SM")
    return n.value


def bwd_route(hd: int) -> str:
    """Which backward runs a call on the card: ``"windows"``
    (``csrc/wkv6_bwd_tc.cu``) at every head dim of ``BWD_CHUNK``."""
    return "windows"


# the LAUNCHES key each backward route counts under
BWD_COUNT = {"windows": "bwd_windows"}


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


def _bwd_chunk_bounds(r, k, v, w, s0, dout, ds_fin, chunk: int):
    """Phases 1-2 of the backward's schedule and of its per-token oracle,
    f32: the inputs cut into chunks
    of ``chunk`` tokens (B, H, nc, C, hd), a ragged last chunk padded as the
    forward pads it; (1) every chunk's state contribution from zero L_c, its
    decay product P_c and its reverse contribution G_c = sum_t diag(prod_{m<t}
    w_m) r_t^T do_t; (2) the chunks' starting states in order and the
    gradient at each chunk's end in reverse, dS <- diag(P_c) dS + G_c from
    ``ds_fin``.  Returns (rc, kc, vc, wc, dc, starts, ends (B, H, nc, hd,
    hd), ds0)."""
    B, H, S, hd = r.shape
    nc = -(-S // chunk)
    pad = nc * chunk - S
    dev = r.device

    def chunks(x, fill):          # (B, H, nc, C, hd), f32
        x = x.float()
        x = torch.cat([x, x.new_full((B, H, pad, hd), fill)], dim=2) \
            if pad else x
        return x.reshape(B, H, nc, chunk, hd)
    rc, kc, vc, wc, dc = (chunks(x, f) for x, f in (
        (r, 0.0), (k, 0.0), (v, 0.0), (w, 1.0), (dout, 0.0)))
    zero = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=dev)
    # (1) local contributions L and G and decay products P of every chunk
    L = torch.zeros((B, H, nc, hd, hd), dtype=torch.float32, device=dev)
    G = torch.zeros_like(L)
    P = torch.ones((B, H, nc, hd), dtype=torch.float32, device=dev)
    for j in range(chunk):
        G = G + (P * rc[:, :, :, j])[..., None] * dc[:, :, :, j, None, :]
        L = L * wc[:, :, :, j, :, None] \
            + kc[:, :, :, j, :, None] * vc[:, :, :, j, None, :]
        P = P * wc[:, :, :, j]
    # (2) starting states in order, the gradient at each chunk's end in
    # reverse
    s = zero if s0 is None else s0.float()
    starts = []
    for c in range(nc):
        starts.append(s)
        s = P[:, :, c, :, None] * s + L[:, :, c]
    ds = zero if ds_fin is None else ds_fin.float()
    ends = [zero] * nc
    for c in reversed(range(nc)):
        ends[c] = ds
        ds = P[:, :, c, :, None] * ds + G[:, :, c]
    return (rc, kc, vc, wc, dc, torch.stack(starts, dim=2),
            torch.stack(ends, dim=2), ds)


def wkv6_bwd_chunked_plain(r, k, v, w, u, s0, dout, ds_fin=None,
                           chunk: int = CHUNK):
    """The per-token walk over the backward's chunks in PyTorch, f32 (the
    oracle the tests hold the windowed schedule to): the gradients of
    ``wkv6_plain``'s (out, final state) given ``dout`` (B, H, S, hd) and
    ``ds_fin`` (B, H, hd, hd, or None for none).  Phases 1-2 as
    ``_bwd_chunk_bounds``; (3) every chunk's states rebuilt forward from
    its start, then its tokens walked back: dr_t = S_t do_t + u k_t
    (v_t.do_t), dk_t = dS_{t+1} v_t + u r_t (v_t.do_t), dv_t = dS_{t+1}^T
    k_t + (r_t.(u k_t)) do_t, dw_t = rowsum(dS_{t+1} * S_t), dS_t =
    diag(w_t) dS_{t+1} + r_t^T do_t.  du sums r_t k_t (v_t.do_t) per
    (batch, chunk), then over both.  Only multiplies by w.  Returns (dr, dk,
    dv, dw (B, H, S, hd), du (H, hd), ds0 (B, H, hd, hd)), all f32."""
    B, H, S, hd = r.shape
    rc, kc, vc, wc, dc, st, dS, ds0 = _bwd_chunk_bounds(
        r, k, v, w, s0, dout, ds_fin, chunk)
    nc = rc.shape[2]
    dev = r.device
    # (3) every chunk's states rebuilt forward, its tokens walked back
    states = []
    for j in range(chunk):
        states.append(st)
        st = st * wc[:, :, :, j, :, None] \
            + kc[:, :, :, j, :, None] * vc[:, :, :, j, None, :]
    uf = u.float()[:, None, :]                               # (H, 1, hd)
    grads = [torch.empty((B, H, nc, chunk, hd), dtype=torch.float32,
                         device=dev) for _ in range(4)]
    dr, dk, dv, dw = grads
    du = torch.zeros((B, H, nc, hd), dtype=torch.float32, device=dev)
    for j in reversed(range(chunk)):
        rj, kj, vj, wj, dj = (x[:, :, :, j] for x in (rc, kc, vc, wc, dc))
        vd = (vj * dj).sum(-1, keepdim=True)                 # v_t . do_t
        dr[:, :, :, j] = (states[j] * dj[..., None, :]).sum(-1) \
            + uf * kj * vd
        dk[:, :, :, j] = (dS * vj[..., None, :]).sum(-1) + uf * rj * vd
        dv[:, :, :, j] = (dS * kj[..., :, None]).sum(-2) \
            + (rj * uf * kj).sum(-1, keepdim=True) * dj
        dw[:, :, :, j] = (dS * states[j]).sum(-1)
        du = du + rj * kj * vd
        dS = dS * wj[..., :, None] + rj[..., :, None] * dj[..., None, :]
    return (*(x.reshape(B, H, nc * chunk, hd)[:, :, :S] for x in grads),
            du.sum(dim=(0, 2)), ds0)


def wkv6_bwd_windowed_plain(r, k, v, w, u, s0, dout, ds_fin=None,
                            chunk: int = CHUNK, window: int = BWD_WINDOW, *,
                            lose_rank: Optional[int] = None):
    """The "windows" backward's schedule in PyTorch, f32: the gradients of
    ``wkv6_bwd_chunked_plain``, with phases 1-2 as ``_bwd_chunk_bounds`` and
    each chunk cut into windows [a, e) of ``window`` tokens.  Within a
    window, A_t = prod_{a<=m<t} w_m, B_t = prod_{t<m<e} w_m and D(t, s) =
    prod_{t<m<s} w_m, each a running product; S_a is the window's starting
    state (from the chunk's by the rank-W updates S <- diag(A_e) S + (K B)^T
    V) and dS_e the gradient at its end (from the chunk's, dS <- diag(A_e) dS
    + (R A)^T dO).  The products across the window (the kernel's tensor-core
    work): Qr = dO S_a^T, Pk = V dS_e^T, Pv = (K B) dS_e, c = V dO^T and
    Rs = rowsum(dS_e * S_a).  Then, token by token with Sdo_t(s) = S_t do_s
    (from Qr, Sdo_{t+1}(s) = w_t Sdo_t(s) + k_t c_ts) and Ge_t =
    rowsum(dS_e * S_t) (from Rs, Ge_{t+1} = w_t Ge_t + k_t Pk_t):
    dr_t = Sdo_t(t) + u k_t c_tt,
    dk_t = B_t Pk_t + sum_{s>t} D(t,s) r_s c_ts + u r_t c_tt,
    dw_t = B_t Ge_t + sum_{s>t} D(t,s) r_s Sdo_t(s),
    dv_t = Pv_t + sum_{s>=t} q_ts do_s, q_ts = sum_i D(t,s) r_s k_t (q_tt =
    sum_i u r_t k_t).  Nothing divides: every factor is a product of
    decays.  ``chunk`` a multiple of ``window``.

    Where ``BWD_RANKS[hd]`` CTAs split the state's columns on the card, the
    sums over the columns (Qr, Pk, c, Rs) and q's over the rows are summed
    as the card sums them: one partial a rank's block of hd / ranks, rank
    0's first.  ``lose_rank``: that rank's partials left out (a gradient
    the checks' limits must reject).  Returns as
    ``wkv6_bwd_chunked_plain``."""
    if chunk % window:
        raise ValueError(f"wkv6 backward: chunk {chunk} is not a multiple "
                         f"of the window {window}")
    B, H, S, hd = r.shape
    ranks = BWD_RANKS.get(hd, 1)
    if lose_rank is not None and (ranks == 1 or not 0 <= lose_rank < ranks):
        raise ValueError(f"wkv6 backward: no rank {lose_rank} to lose at hd "
                         f"{hd} ({ranks} rank(s))")
    blk = hd // ranks

    def ranked(part):
        """The sum over the ranks of ``part(their block)``, rank 0's
        first."""
        parts = [part(slice(q * blk, (q + 1) * blk)) for q in range(ranks)
                 if q != lose_rank]
        out = parts[0]
        for x in parts[1:]:
            out = out + x
        return out
    rc, kc, vc, wc, dc, starts, ends, ds0 = _bwd_chunk_bounds(
        r, k, v, w, s0, dout, ds_fin, chunk)
    nc, nw, W = rc.shape[2], chunk // window, window
    rw, kw, vw, ww, dw_ = (x.reshape(B, H, nc, nw, W, hd)
                           for x in (rc, kc, vc, wc, dc))
    # prefix products A_t (t = 0 .. W) and suffix products B_t
    A = [torch.ones_like(ww[..., 0, :])]
    for t in range(W):
        A.append(A[-1] * ww[..., t, :])
    Bs = [torch.ones_like(ww[..., 0, :])]
    for t in reversed(range(W - 1)):
        Bs.insert(0, Bs[0] * ww[..., t + 1, :])
    Bs = torch.stack(Bs, dim=-2)
    Ae = A[W]                                                # (.., nw, hd)
    KB = kw * Bs
    RA = rw * torch.stack(A[:W], dim=-2)
    # the windows' starting states and end gradients
    Sa = [starts]
    for x in range(nw - 1):
        Sa.append(Ae[..., x, :, None] * Sa[-1]
                  + KB[..., x, :, :].mT @ vw[..., x, :, :])
    dSe = [ends]
    for x in reversed(range(1, nw)):
        dSe.insert(0, Ae[..., x, :, None] * dSe[0]
                   + RA[..., x, :, :].mT @ dw_[..., x, :, :])
    Sa, dSe = torch.stack(Sa, dim=3), torch.stack(dSe, dim=3)
    # the products across each window
    Qr = ranked(lambda j: dw_[..., j] @ Sa[..., j].mT)       # (.., W, hd)
    Pk = ranked(lambda j: vw[..., j] @ dSe[..., j].mT)
    Pv = KB @ dSe
    c = ranked(lambda j: vw[..., j] @ dw_[..., j].mT)        # (.., W, W)
    Ge = ranked(lambda j: (dSe[..., j] * Sa[..., j]).sum(-1))
    # token by token within the window
    uf = u.float()[:, None, None, :]                         # (H,1,1,hd)
    Sdo = Qr.clone()
    dr, dk, dw = (torch.empty_like(rw) for _ in range(3))
    Qm = torch.zeros_like(c)
    for t in range(W):
        rt, kt, wt = rw[..., t, :], kw[..., t, :], ww[..., t, :]
        ctt = c[..., t, t, None]
        dr[..., t, :] = Sdo[..., t, :] + uf * kt * ctt
        dk[..., t, :] = Bs[..., t, :] * Pk[..., t, :] + uf * rt * ctt
        dw[..., t, :] = Bs[..., t, :] * Ge
        Qm[..., t, t] = ranked(lambda i: (uf * rt * kt)[..., i].sum(-1))
        if t + 1 < W:
            # D(t, s) for s = t+1 .. W-1: 1, then running products of w
            D = torch.cat([torch.ones_like(wt[..., None, :]), torch.cumprod(
                ww[..., t + 1:W - 1, :], dim=-2)], dim=-2)
            Z = D * rw[..., t + 1:, :]
            dk[..., t, :] += (Z * c[..., t, t + 1:, None]).sum(-2)
            dw[..., t, :] += (Z * Sdo[..., t + 1:, :]).sum(-2)
            Qm[..., t, t + 1:] = ranked(
                lambda i: (Z[..., i] * kt[..., None, i]).sum(-1))
            Sdo[..., t + 1:, :] = wt[..., None, :] * Sdo[..., t + 1:, :] \
                + kt[..., None, :] * c[..., t, t + 1:, None]
        Ge = wt * Ge + kt * Pk[..., t, :]
    dv = Pv + Qm @ dw_
    du = (rc * kc * (vc * dc).sum(-1, keepdim=True)).sum(dim=(0, 2, 3))
    return (*(x.reshape(B, H, nc * chunk, hd)[:, :, :S]
              for x in (dr, dk, dv, dw)), du, ds0)


def _unit_rows(t: torch.Tensor, what: str) -> None:
    """Raise unless the last dim of ``t`` is unit-stride (or of size 1)."""
    if t.stride(-1) != 1 and t.shape[-1] > 1:
        raise ValueError(f"{what}: last dim has stride {t.stride(-1)}; the "
                         "kernel reads it unit-stride")


def _token_strides(t: torch.Tensor, what: str) -> list[int]:
    """(batch, head, token) element strides of a (B, H, S, hd) view whose
    last dim is unit-stride; raises otherwise."""
    _unit_rows(t, what)
    return [t.stride(d) for d in range(3)]


def _state(t, dev, shape, what: str) -> torch.Tensor:
    """A (B, H, hd, hd) f32 state the kernels read or write 16 bytes at a
    time: contiguous (16-byte aligned: ``_aligned``, at the launch)."""
    return _cuda.as_input(t, torch.float32, dev, shape, what)


def _aligned(t, what: str) -> None:
    """Raise where a state the kernels move 16 bytes at a time is not
    16-byte aligned."""
    if t is not None and t.data_ptr() % 16:
        raise ValueError(f"{what}: data is not 16-byte aligned")


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
    version on the CPU.

    With grad enabled and r, k, v, w, u or s0 requiring grad, the call runs
    as an autograd Function (``_WKV``) whose backward is ``wkv6_bwd``: the
    output then takes r's memory layout (for the layer's views, that of
    its (B, S, D) activations), both outputs are differentiable, and
    ``out=`` and ``s_out=`` are refused (an in-place write takes no
    grad)."""
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
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in (r, k, v, w, u, s0)):
        if out is not None or s_out is not None:
            raise ValueError("wkv6: out= and s_out= are in-place writes, "
                             "which take no grad; with grad enabled the "
                             "outputs are returned")
        return _WKV.apply(r, k, v, w, u, s0, chunk)
    if out is None:
        out = torch.empty(shape, dtype=dtype, device=dev)
    out = _cuda.as_input(out, dtype, dev, shape, "out", contiguous=False)
    s_out = torch.empty((B, H, hd, hd), dtype=torch.float32, device=dev) \
        if s_out is None else _state(s_out, dev, (B, H, hd, hd), "s_out")
    return _run(r, k, v, w, u, s0, out, s_out, chunk)


def _run(r, k, v, w, u, s0, out, s_out, chunk: int):
    """The forward on checked inputs, writing ``out`` and ``s_out``, through
    the operator ``repro_torch::wkv6``: the chunk schedule's plain version
    for CPU tensors (``_fwd_plain``), the step kernel (S = 1) or the
    sequence form's three launches for card tensors (``_fwd_launch``),
    nothing for FakeTensors (the writes are declared in its schema)."""
    for t, n in ((r, "r"), (k, "k"), (v, "v"), (w, "w"), (out, "out")):
        _unit_rows(t, n)
    _FWD(r, k, v, w, u, s0, out, s_out, min(chunk, r.shape[2]))
    return out, s_out


def _fwd_plain(r, k, v, w, u, s0, out, s_out, chunk: int) -> None:
    """The operator's CPU implementation: ``wkv6_chunked_plain``."""
    o, s = wkv6_chunked_plain(r.float(), k.float(), v.float(), w, u, s0,
                              chunk)
    out.copy_(o)
    s_out.copy_(s)


def _fwd_launch(r, k, v, w, u, s0, out, s_out, chunk: int) -> None:
    """The operator's CUDA implementation: the step kernel (S = 1) or the
    sequence form's three launches."""
    dev = r.device
    B, H, S, hd = r.shape
    _aligned(s0, "s0")
    _aligned(s_out, "s_out")
    nc = -(-S // chunk)
    if S > 1:
        Ls = torch.empty((B * H * nc * hd * hd,), dtype=torch.float32,
                         device=dev)
        Ps = torch.empty((B * H * nc * hd,), dtype=torch.float32, device=dev)
    lib, launch = _launcher(r.dtype)
    st = (ctypes.c_longlong * 15)(*(t.stride(d) for t in (r, k, v, w, out)
                                    for d in range(3)))
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


def wkv6_bwd(r, k, v, w, u, s0, dout, ds_fin=None):
    """(dr, dk, dv, dw, du, ds0): the gradients of ``wkv6_state``'s (out,
    final state) with respect to r, k, v, w, u and s0, given ``dout`` (B, H,
    S, hd) and ``ds_fin`` (B, H, hd, hd; None: the final state takes no
    gradient).  r, k, v, dout of one dtype (float32 or bfloat16; views with
    a unit-stride last dim), w, u, s0 (None: zeros) float32, as
    ``wkv6_state`` takes them (it checks them; this function does not, but
    for the head dim and dtype).  dr, dk, dv come in r's dtype (rounded once
    from fp32), dw, du, ds0 in float32; dr, dk, dv and dw take the memory
    layout of their inputs (``torch.empty_like``), so the gradient of a
    layer's (B, H, S, hd) view is a view of a (B, S, D) tensor.  On the card
    the kernel (``csrc/wkv6_bwd_tc.cu``) in ``BWD_LAUNCHES`` launches (chunks
    of ``BWD_CHUNK[hd]``), counted under ``BWD_COUNT["windows"]``; on the
    CPU its plain version, ``wkv6_bwd_windowed_plain``, on the same chunks
    and windows.  A head dim the kernels are not built for raises."""
    B, H, S, hd = r.shape
    dtype = r.dtype
    if hd not in BWD_CHUNK or dtype not in _BWD_TC_ENTRY:
        raise NotImplementedError(
            f"wkv6 backward: no kernel for hd={hd}, {dtype}; the backward "
            f"kernel is built for hd in {tuple(BWD_CHUNK)}, float32 and "
            "bfloat16")
    return _BWD(r, k, v, w, u, s0, dout, ds_fin)


def _bwd_plain(r, k, v, w, u, s0, dout, ds_fin):
    """The backward operator's CPU implementation: the plain version of
    the kernels' schedule, its gradients in the kernels' dtypes and
    layouts."""
    dr, dk, dv = (torch.empty_like(t) for t in (r, k, v))
    dw = torch.empty_like(w)
    got = wkv6_bwd_windowed_plain(r, k, v, w, u, s0, dout, ds_fin,
                                  BWD_CHUNK[r.shape[3]])
    for t, g in zip((dr, dk, dv, dw), got):
        t.copy_(g)
    return dr, dk, dv, dw, got[4], got[5]


def _bwd_launch(r, k, v, w, u, s0, dout, ds_fin):
    """The backward operator's CUDA implementation: its four launches."""
    B, H, S, hd = r.shape
    dtype = r.dtype
    route = bwd_route(hd)
    chunk = BWD_CHUNK[hd]
    dev = r.device
    dr, dk, dv = (torch.empty_like(t) for t in (r, k, v))
    dw = torch.empty_like(w)
    dout = _cuda.unit_rows(dout.to(dtype))
    if ds_fin is not None:
        ds_fin = ds_fin.float().contiguous()
    du = torch.empty((H, hd), dtype=torch.float32, device=dev)
    ds0 = torch.empty((B, H, hd, hd), dtype=torch.float32, device=dev)
    nc = -(-S // chunk)
    # chunk starting states (over L_c), gradients at chunk ends (over G_c),
    # decay products, du's partials per (batch, head, chunk)
    Ls, Gs = (torch.empty((B * H * nc * hd * hd,), dtype=torch.float32,
                          device=dev) for _ in range(2))
    Ps, dup = (torch.empty((B * H * nc * hd,), dtype=torch.float32,
                           device=dev) for _ in range(2))
    strides = [_token_strides(t, n) for t, n in (
        (r, "r"), (k, "k"), (v, "v"), (w, "w"), (dout, "dout"), (dr, "dr"),
        (dk, "dk"), (dv, "dv"), (dw, "dw"))]
    st = (ctypes.c_longlong * 27)(*(s for t in strides for s in t))
    lib, launch = _bwd_launcher(dtype)
    with torch.cuda.device(dev):
        rc = launch(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                    u.data_ptr(), None if s0 is None else s0.data_ptr(),
                    dout.data_ptr(),
                    None if ds_fin is None else ds_fin.data_ptr(),
                    dr.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                    dw.data_ptr(), du.data_ptr(), ds0.data_ptr(),
                    Ls.data_ptr(), Gs.data_ptr(), Ps.data_ptr(),
                    dup.data_ptr(), ctypes.addressof(st), B, H, S, hd, chunk,
                    _cuda.current_stream(dev))
    _cuda.check(lib, rc, f"wkv6 backward ({route})")
    LAUNCHES[BWD_COUNT[route]] += BWD_LAUNCHES
    return dr, dk, dv, dw, du, ds0


# ---------------------------------------------------------------------------
# the operators: the dispatcher picks the implementation by the tensors'
# device, and a FakeTensor takes the fake one (shapes and dtypes alone)
# ---------------------------------------------------------------------------

_cuda.LIB.define("wkv6(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, "
                 "Tensor? s0, Tensor(a!) out, Tensor(b!) s_out, int chunk) "
                 "-> ()")
_cuda.LIB.define("wkv6_bwd(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, "
                 "Tensor? s0, Tensor dout, Tensor? ds_fin) -> (Tensor, "
                 "Tensor, Tensor, Tensor, Tensor, Tensor)")
_cuda.LIB.impl("wkv6", lambda *a: _fwd_plain(*a), "CPU")
_cuda.LIB.impl("wkv6", lambda *a: _fwd_launch(*a), "CUDA")
_cuda.LIB.impl("wkv6_bwd", lambda *a: _bwd_plain(*a), "CPU")
_cuda.LIB.impl("wkv6_bwd", lambda *a: _bwd_launch(*a), "CUDA")


@torch.library.register_fake("repro_torch::wkv6", lib=_cuda.LIB)
def _fwd_fake(r, k, v, w, u, s0, out, s_out, chunk):
    return None


@torch.library.register_fake("repro_torch::wkv6_bwd", lib=_cuda.LIB)
def _bwd_fake(r, k, v, w, u, s0, dout, ds_fin):
    B, H, S, hd = r.shape
    return (torch.empty_like(r), torch.empty_like(k), torch.empty_like(v),
            torch.empty_like(w), u.new_empty((H, hd), dtype=torch.float32),
            u.new_empty((B, H, hd, hd), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.wkv6)
def _fwd_flops(r, *args, **kwargs) -> int:
    """5 a state entry and token (PERF.md)."""
    B, H, S, hd = r
    return 5 * B * H * S * hd * hd


@register_flop_formula(torch.ops.repro_torch.wkv6_bwd)
def _bwd_flops(r, *args, **kwargs) -> int:
    """14 a state entry and token: the state rebuilt 3, dS updated 3, dr,
    dk, dv and dw 2 each."""
    B, H, S, hd = r
    return 14 * B * H * S * hd * hd


_FWD = torch.ops.repro_torch.wkv6.default
_BWD = torch.ops.repro_torch.wkv6_bwd.default


class _WKV(torch.autograd.Function):
    """K5 with its gradient: the forward kernels (the output in r's
    layout), then ``wkv6_bwd``.  Saves the inputs alone: the backward
    recomputes the chunks' starting states."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0, chunk):
        B, H, S, hd = r.shape
        out = torch.empty_like(r)
        s_out = torch.empty((B, H, hd, hd), dtype=torch.float32,
                            device=r.device)
        _run(r, k, v, w, u, s0, out, s_out, chunk)
        ctx.save_for_backward(r, k, v, w, u, s0)
        ctx.set_materialize_grads(False)
        return out, s_out

    @staticmethod
    def backward(ctx, dout, ds_fin):
        r, k, v, w, u, s0 = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(r)
        dr, dk, dv, dw, du, ds0 = wkv6_bwd(r, k, v, w, u, s0, dout, ds_fin)
        return dr, dk, dv, dw, du, None if s0 is None else ds0, None
