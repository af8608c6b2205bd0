"""K4 at bf16 hd 256 (PaliGemma's MQA): the split schedules the card's
kernels walk (``fwd_split``, ``dkdv_split``, ``dq_split``) and the plain
versions that walk them on the CPU, against the JAX package's
``flash_attention_ref`` and ``jax.vjp`` of it.

The same inputs, made with numpy from a seed, go to both packages.  The
schedule tests check that the pieces cover every kept (row, key) pair
exactly once, and no tile whose pairs are all masked.  The CUDA kernels
have no CPU mode: tests/test_torch_cuda.py holds them against these plain
versions on the card.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.ref import flash_attention_ref
from repro_torch.kernels import flash_attention as fa

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
HD = 256


def _inputs(B, H, Hkv, S, Sk, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((B, H, S, HD), (B, Hkv, Sk, HD), (B, Hkv, Sk, HD),
             (B, H, S, HD))]


def _oracle_args(q, k, v, G, causal):
    """The JAX oracle's arguments: k and v repeated to the q heads and,
    causal with more keys than rows, cut to the keys a row can keep."""
    S, Sk = q.shape[2], k.shape[2]
    if causal and Sk > S:
        k, v = k[:, :, :S], v[:, :, :S]
    return q, np.repeat(k, G, axis=1), np.repeat(v, G, axis=1)


# (Hkv, G, S, Sk): groups 1, 2, 8 (and 3: pairs of units that straddle two
# q tiles), ragged lengths, Sk != S both ways
CASES = [(1, 1, 200, 200), (2, 2, 77, 77), (1, 8, 130, 130),
         (1, 3, 136, 136), (1, 2, 100, 260), (2, 1, 150, 90)]


@pytest.mark.parametrize("Hkv,G,S,Sk", CASES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_plain_matches_jax_oracle(Hkv, G, S, Sk, causal, dtype):
    """The forward's plain version on the split schedule (pieces, their
    partials, the fixed-order combine) against ``flash_attention_ref`` at
    2e-5 (f32) and 2e-2 (bf16); causal with fewer keys than rows (no oracle:
    its mask is square) against the block walk's plain version."""
    q, k, v, _ = _inputs(1, G * Hkv, Hkv, S, Sk, seed=S + G)
    td = getattr(torch, dtype)
    xs = [torch.from_numpy(x).to(td) for x in (q, k, v)]
    got = fa.flash_attention_plain(*xs, causal=causal, block_q=128,
                                   block_k=64, split=True)
    if causal and Sk < S:
        want = fa.flash_attention_plain(*xs, causal=True, block_q=128,
                                        block_k=64).float().numpy()
    else:
        jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
        args = _oracle_args(q, k, v, G, causal)
        want = np.asarray(flash_attention_ref(
            *(jnp.asarray(x).astype(jd) for x in args),
            causal=causal).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("Hkv,G,S,Sk", CASES)
@pytest.mark.parametrize("causal", [True, False])
def test_split_bwd_plain_matches_jax_vjp(Hkv, G, S, Sk, causal):
    """The backward's plain version on the split schedules (dK/dV pieces
    over heads x q tiles, dQ pieces over 32-key steps, partials summed in
    slot order) against ``jax.vjp`` of the oracle, k and v repeated and
    their gradients summed back over each group, at the f32 limit of
    ``test_bwd_plain_matches_jax_vjp``; causal with fewer keys than rows
    against the block walk's plain version."""
    q, k, v, g = _inputs(1, G * Hkv, Hkv, S, Sk, seed=7 * G + S)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    o, lse = fa.flash_attention_plain(tq, tk, tv, causal=causal, block_q=128,
                                      block_k=64, return_lse=True, split=True)
    got = fa.flash_attention_bwd_plain(tq, tk, tv, o, lse, tg, causal=causal,
                                       block_q=64, block_k=64, split=True)
    if causal and Sk < S:
        want = [x.numpy() for x in fa.flash_attention_bwd_plain(
            tq, tk, tv, o, lse, tg, causal=True, block_q=64, block_k=64)]
    else:
        cut = min(Sk, S) if causal else Sk

        def f(q_, k_, v_):
            return flash_attention_ref(q_, jnp.repeat(k_, G, axis=1),
                                       jnp.repeat(v_, G, axis=1),
                                       causal=causal)
        out, vjp = jax.vjp(f, q, k[:, :, :cut], v[:, :, :cut])
        np.testing.assert_allclose(o.numpy(), np.asarray(out), rtol=2e-5,
                                   atol=2e-5)
        dq, dk, dv = (np.asarray(x) for x in vjp(jnp.asarray(g)))
        pad = ((0, 0), (0, 0), (0, Sk - cut), (0, 0))
        want = [dq, np.pad(dk, pad), np.pad(dv, pad)]
    for name, a, b in zip("qkv", got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-5, atol=2e-5,
                                   err_msg=f"d{name}")


# ---------------------------------------------------------------------------
# the schedules
# ---------------------------------------------------------------------------


def _keep(S, Sk, causal):
    """(S, Sk) bool: the (row, key) pairs attention keeps."""
    rows, keys = np.arange(S)[:, None], np.arange(Sk)[None, :]
    return (keys <= rows) if causal else np.ones((S, Sk), bool)


def _pair_units(B, H, Hkv, S, x):
    """The (batch, q head, first row) of each unit item ``x`` pairs."""
    G = H // Hkv
    U, npair = fa.pair_units(H, Hkv, S)
    bhk, i = divmod(x, npair)
    b, hk = divmod(bhk, Hkv)
    return [(b, hk * G + u % G, u // G * fa.UNIT_ROWS, u // G)
            for u in (2 * i, 2 * i + 1) if u < U]


def _check_pieces(sp):
    """An item's pieces cut its walk into consecutive ranges, in slot order
    where they write partials; the sums list every cut item once."""
    for it, pieces in enumerate(sp.by_item()):
        assert pieces[0][0] == 0 and pieces[-1][1] == sp.walks[it]
        assert all(a[1] == b[0] for a, b in zip(pieces, pieces[1:]))
    cut = {it for it, _, n in sp.sums}
    assert len(cut) == len(sp.sums)
    slots = sorted(p[3] for p in sp.pieces if p[3] >= 0)
    assert slots == list(range(sp.slots))
    if sp.pieces:
        assert len(sp.pieces) == sp.blocks <= fa.SMS
        assert {p[0] for p in sp.pieces} == set(range(len(sp.walks)))


def _cover_units(sp, B, H, Hkv, S, Sk, causal, bk):
    """(B, H, S, Sk) count of the (row, key) pairs each piece of a pair
    schedule (forward, dQ) computes, and whether a piece walks a tile that
    keeps no pair of its unit."""
    keep = _keep(S, Sk, causal)
    count = np.zeros((B, H, S, Sk), int)
    wasted = False
    for it, pieces in enumerate(sp.by_item()):
        for b, h, r0, p in _pair_units(B, H, Hkv, S, it):
            walk = fa.unit_walk(p, S, Sk, causal, bk)
            rows = slice(r0, min(r0 + fa.UNIT_ROWS, S))
            for a, e in pieces:
                for j in range(a, min(e, walk)):
                    keys = slice(j * bk, min((j + 1) * bk, Sk))
                    tile = keep[rows, keys]
                    wasted |= not tile.any()
                    count[b, h, rows, keys] += tile
    return count, wasted


SHAPES = [(1, 8, 1, 1024, 1024), (1, 8, 1, 200, 200), (2, 3, 1, 136, 72),
          (1, 2, 2, 77, 300), (1, 1, 1, 1, 1), (3, 6, 2, 130, 130)]


@pytest.mark.parametrize("B,H,Hkv,S,Sk", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_split_schedules_cover_every_kept_pair_once(B, H, Hkv, S, Sk,
                                                    causal):
    """The forward's pieces (pairs of 64-row units over 64-key tiles), the
    dK/dV kernel's (64-key tiles over G heads x 64-row q tiles) and the dQ
    kernel's (pairs of units over 32-key steps) compute every kept (row,
    key) pair of every head exactly once and no masked one, and walk no
    tile that keeps nothing (the causal bound ((qi+1) BQ - 1) // BK)."""
    keep = np.broadcast_to(_keep(S, Sk, causal), (B, H, S, Sk))
    for sp, bk in ((fa.fwd_split(B, H, Hkv, S, Sk, causal), fa.SPLIT_BK),
                   (fa.dq_split(B, H, Hkv, S, Sk, causal), fa.SPLIT_BK_DQ)):
        _check_pieces(sp)
        count, wasted = _cover_units(sp, B, H, Hkv, S, Sk, causal, bk)
        assert np.array_equal(count, keep.astype(int)) and not wasted
    sp = fa.dkdv_split(B, H, Hkv, S, Sk, causal)
    _check_pieces(sp)
    G, nq = H // Hkv, -(-S // fa.UNIT_ROWS)
    nk = -(-Sk // fa.SPLIT_BK)
    count = np.zeros((B, H, S, Sk), int)
    base = _keep(S, Sk, causal)
    for it, pieces in enumerate(sp.by_item()):
        bhk, t = divmod(it, nk)
        b, hk = divmod(bhk, Hkv)
        first = min(t, nq) if causal else 0
        per = nq - first
        keys = slice(t * fa.SPLIT_BK, min((t + 1) * fa.SPLIT_BK, Sk))
        for a, e in pieces:
            for step in range(a, e):
                g, qt = divmod(step, per)
                rows = slice((first + qt) * fa.UNIT_ROWS,
                             min((first + qt + 1) * fa.UNIT_ROWS, S))
                tile = base[rows, keys]
                assert tile.any()
                count[b, hk * G + g, rows, keys] += tile
    assert np.array_equal(count, keep.astype(int))


def test_split_fills_the_card_at_paligemma():
    """q (1, 8, 1024, 256) over one kv head, causal: each kernel's grid is
    one wave of 132 blocks, its longest piece within 1.5 x the mean (the
    forward's shortest walks, 1 to 3 tiles, cannot be cut into longer
    pieces); two forward kernels and four backward ones a call.  A grid of
    132 items or more is not cut (no partials, no second kernel)."""
    sps = [f(1, 8, 1, 1024, 1024, True)
           for f in (fa.fwd_split, fa.dkdv_split, fa.dq_split)]
    for sp, longest in zip(sps, (6, 9, 11)):
        lengths = [e - a for _, a, e, _ in sp.pieces]
        assert sp.blocks == fa.SMS
        assert max(lengths) == longest
        assert max(lengths) <= 1.5 * sum(sp.walks) / sp.blocks
        assert sorted(lengths, reverse=True) == lengths   # longest first
    bf = torch.bfloat16
    assert fa.fwd_launches(bf, 256, 1, 8, 1, 1024) == 2
    assert fa.bwd_launches(bf, 256, 1, 8, 1, 1024) == 4
    wide = fa.fwd_split(4, 16, 16, 512, 512, True)
    assert not wide.pieces and not wide.sums and wide.blocks == 4 * 16 * 4
    assert fa.fwd_launches(bf, 256, 4, 16, 16, 512) == 1
    assert fa.bwd_launches(bf, 256, 4, 16, 16, 512) == 3
    # the other routes keep one forward kernel a call
    for dt, hd in ((bf, 64), (bf, 128), (torch.float32, 256), (bf, 16)):
        assert fa.fwd_launches(dt, hd, 1, 8, 1, 1024) == 1


@pytest.mark.parametrize("causal", [True, False])
def test_wrapper_on_the_cpu_runs_the_split_plain(causal):
    """bf16 at hd 256 on CPU tensors: the wrapper's forward is the split
    plain version bitwise, and the autograd Function's gradients are the
    split backward's, on views of (B, S, heads, hd) tensors."""
    rng = np.random.default_rng(3)
    base = [torch.from_numpy(rng.standard_normal((1, 150, n, HD)).astype(
        np.float32)).to(torch.bfloat16).requires_grad_() for n in (4, 2, 2)]
    q, k, v = (t.transpose(1, 2) for t in base)
    out = fa.flash_attention(q, k, v, causal=causal)
    want, lse = fa.flash_attention_plain(q, k, v, causal=causal, block_q=128,
                                         block_k=64, return_lse=True,
                                         split=True)
    assert torch.equal(out, want)
    g = torch.from_numpy(rng.standard_normal(out.shape).astype(
        np.float32)).to(torch.bfloat16)
    got = torch.autograd.grad(out, base, g)
    wants = fa.flash_attention_bwd_plain(q, k, v, want, lse, g, causal=causal,
                                         block_q=64, block_k=64, split=True)
    for a, b in zip(got, wants):
        assert torch.equal(a, b.transpose(1, 2))


def test_split_plain_rejects_other_blocks():
    q = torch.zeros((1, 2, 64, HD))
    with pytest.raises(ValueError, match="split"):
        fa.flash_attention_plain(q, q, q, causal=True, block_q=64,
                                 block_k=64, split=True)
    with pytest.raises(ValueError, match="split"):
        fa.flash_attention_bwd_plain(q, q, q, q, q[..., 0], q, causal=True,
                                     block_q=64, block_k=32, split=True)
