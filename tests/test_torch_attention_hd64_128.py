"""K4's bf16 backward at hd 64 and 128: the dK/dV schedule the card's kernel
walks (``dkdv_wrap``: kv tiles of 128 keys, their walks over the group's q
heads x q tiles of 64 rows wrapped over at most ``SMS`` blocks) and the
plain version that walks it on the CPU, against ``jax.vjp`` of the JAX
package's ``flash_attention_ref``.

The same inputs, made with numpy from a seed, go to both packages.  The
schedule tests check that the pieces cover every kept (row, key) pair of
every head exactly once, walk no step whose tile keeps nothing, and balance
the blocks at the models' shapes.  The CUDA kernels have no CPU mode:
tests/test_torch_cuda.py holds them against this plain version on the card.
"""
import heapq

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.ref import flash_attention_ref
from repro_torch.kernels import flash_attention as fa

FA_TOL = 2e-5        # K4's f32 limit, the JAX suite's
BQ, BK = fa.BWD_TILES["wgmma"][64]
assert fa.BWD_TILES["wgmma"][128] == (BQ, BK)


def _inputs(B, H, Hkv, S, Sk, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((B, H, S, hd), (B, Hkv, Sk, hd), (B, Hkv, Sk, hd),
             (B, H, S, hd))]


# (B, Hkv, G, S, Sk, hd): GQA groups 1, 4 and 8, ragged S, fewer keys than
# rows and more; most of them cut walks (``dkdv_wrap(...).sums``)
CASES = [(1, 2, 1, 200, 200, 64), (1, 1, 4, 300, 300, 128),
         (1, 1, 8, 130, 130, 64), (2, 1, 8, 257, 257, 128),
         (1, 2, 4, 100, 60, 64), (1, 1, 8, 150, 300, 64),
         (1, 2, 8, 77, 77, 128)]


@pytest.mark.parametrize("B,Hkv,G,S,Sk,hd", CASES)
@pytest.mark.parametrize("causal", [True, False])
def test_wrap_bwd_plain_matches_jax_vjp(B, Hkv, G, S, Sk, hd, causal):
    """The backward's plain version on the wrapped schedule (pieces of kv
    tiles' walks, fp32 partials summed in slot order) against ``jax.vjp``
    of the oracle, k and v repeated and their gradients summed back over
    each group, at the f32 limit; causal with fewer keys than rows (the
    oracle's mask is square) against the block walk's plain version."""
    q, k, v, g = _inputs(B, G * Hkv, Hkv, S, Sk, hd, seed=7 * G + S)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    o, lse = fa.flash_attention_plain(tq, tk, tv, causal=causal, block_q=128,
                                      block_k=64, return_lse=True)
    got = fa.flash_attention_bwd_plain(tq, tk, tv, o, lse, tg, causal=causal,
                                       block_q=BQ, block_k=BK, split=True)
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
        np.testing.assert_allclose(o.numpy(), np.asarray(out), rtol=FA_TOL,
                                   atol=FA_TOL)
        dq, dk, dv = (np.asarray(x) for x in vjp(jnp.asarray(g)))
        pad = ((0, 0), (0, 0), (0, Sk - cut), (0, 0))
        want = [dq, np.pad(dk, pad), np.pad(dv, pad)]
    for name, a, b in zip("qkv", got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, rtol=FA_TOL, atol=FA_TOL,
                                   err_msg=f"d{name}")


def test_cases_cut_walks():
    """Most of ``CASES`` exercise the partials: their walks are cut."""
    cut = [c for c in CASES for causal in (True, False)
           if fa.dkdv_wrap(c[0], c[1] * c[2], c[1], c[3], c[4], causal).sums]
    assert len(cut) >= 8


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------


def _keep(S, Sk, causal):
    """(S, Sk) bool: the (row, key) pairs attention keeps."""
    rows, keys = np.arange(S)[:, None], np.arange(Sk)[None, :]
    return (keys <= rows) if causal else np.ones((S, Sk), bool)


def _check_structure(sp):
    """Each item's pieces cut its walk into consecutive ranges, in slot
    order where they write partials; the sums list every cut item once;
    the blocks' pieces are consecutive (``offsets``), at most ``SMS``
    blocks, none longer than the wrap's length T."""
    for it, pieces in enumerate(sp.by_item()):
        assert pieces[0][0] == 0 and pieces[-1][1] == sp.walks[it]
        assert all(a[1] == b[0] for a, b in zip(pieces, pieces[1:]))
    assert len({it for it, _, _ in sp.sums}) == len(sp.sums)
    slots = sorted(p[3] for p in sp.pieces if p[3] >= 0)
    assert slots == list(range(sp.slots))
    if not sp.pieces:
        assert not sp.offsets and not sp.sums
        return
    assert sp.offsets[0] == 0 and sp.offsets[-1] == len(sp.pieces)
    assert all(a < b for a, b in zip(sp.offsets, sp.offsets[1:]))
    assert sp.blocks <= fa.SMS and len(sp.walks) < fa.SMS
    T = max(-(-sum(sp.walks) // fa.SMS), fa.MIN_BIN_STEPS)
    assert max(sp.block_steps()) <= T
    assert {p[0] for p in sp.pieces} == set(range(len(sp.walks)))
    # a cut walk's pieces lie in consecutive blocks
    block_of = {}
    for x, (a, b) in enumerate(zip(sp.offsets, sp.offsets[1:])):
        for p in sp.pieces[a:b]:
            block_of.setdefault(p[0], []).append(x)
    for blocks in block_of.values():
        assert blocks == list(range(blocks[0], blocks[0] + len(blocks)))


SHAPES = [(1, 64, 8, 2048, 2048), (2, 32, 8, 2048, 2048),
          (1, 64, 8, 512, 512), (1, 32, 4, 256, 256), (1, 8, 1, 1024, 1024),
          (1, 12, 12, 448, 448), (2, 3, 1, 136, 72), (1, 2, 2, 77, 300),
          (1, 1, 1, 1, 1), (3, 6, 2, 130, 130), (1, 16, 1, 200, 520)]


@pytest.mark.parametrize("B,H,Hkv,S,Sk", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_wrap_schedule_covers_every_kept_pair_once(B, H, Hkv, S, Sk, causal):
    """The dK/dV kernel's pieces (kv tiles of 128 keys over G heads x q
    tiles of 64 rows, step g per + qt - first) compute every kept (row,
    key) pair of every head exactly once, and walk no step whose tile keeps
    nothing (the walk starts at the q tile that holds the tile's first
    key)."""
    sp = fa.dkdv_wrap(B, H, Hkv, S, Sk, causal)
    _check_structure(sp)
    G, nq, nk = H // Hkv, -(-S // BQ), -(-Sk // BK)
    assert len(sp.walks) == B * Hkv * nk
    base = _keep(S, Sk, causal)
    count = np.zeros((B, H, S, Sk), int)
    for it, pieces in enumerate(sp.by_item()):
        bhk, t = divmod(it, nk)
        b, hk = divmod(bhk, Hkv)
        first = min(t * BK // BQ, nq) if causal else 0
        per = nq - first
        keys = slice(t * BK, min((t + 1) * BK, Sk))
        for a, e in pieces:
            for step in range(a, e):
                g, qt = divmod(step, per)
                rows = slice((first + qt) * BQ, min((first + qt + 1) * BQ, S))
                tile = base[rows, keys]
                assert tile.any()
                count[b, hk * G + g, rows, keys] += tile
    keep = np.broadcast_to(base, (B, H, S, Sk))
    assert np.array_equal(count, keep.astype(int))


def _sm_loads(sp, nk, sms=fa.SMS):
    """Steps each SM walks when the card hands the blocks out in launch
    order, each to the SM that frees first (one block an SM at a time).
    Uncut, block x walks tile (x % (B Hkv)) nk + x // (B Hkv)."""
    if sp.pieces:
        order = sp.block_steps()
    else:
        bhks = len(sp.walks) // nk
        order = [sp.walks[x % bhks * nk + x // bhks]
                 for x in range(len(sp.walks))]
    loads = [0] * sms
    for steps in order:
        heapq.heappush(loads, heapq.heappop(loads) + steps)
    return loads


@pytest.mark.parametrize("shape,nk,bound", [
    # Kimi-K2's and Jamba-1.5-Large's GQA 8 at 2048 rows: 128 kv tiles,
    # walks 256 .. 16 steps, wrapped into 132 blocks of 132
    ((1, 64, 8, 2048, 2048), 16, None),
    # llama3-8b's train shape: 256 tiles, one block each, tile-major
    ((2, 32, 8, 2048, 2048), 16, None),
    # Jamba's on path 15: 32 tiles, walks 64 .. 16; 16 steps a block when
    # each group's q heads were split in 4
    ((1, 64, 8, 512, 512), 4, 16)])
def test_wrap_balances_the_sms(shape, nk, bound):
    """The busiest SM walks within 1.1 x the mean of the card's 132 SMs
    at the GQA-8 and train shapes (the card hands out the blocks in launch
    order), and no more than the schedule it replaces at Jamba's path-15
    shape."""
    B, H, Hkv, S, Sk = shape
    sp = fa.dkdv_wrap(B, H, Hkv, S, Sk, True)
    loads = _sm_loads(sp, nk)
    ideal = sum(sp.walks) / fa.SMS
    assert sum(loads) == sum(sp.walks)
    if bound is None:
        assert max(loads) <= 1.1 * ideal
    else:
        assert max(loads) <= bound
    assert max(sp.block_steps()) <= max(loads)


def test_wrap_cuts_only_short_grids():
    """Grids of ``SMS`` kv tiles or more, and walks within reach of the
    wrap's length (Whisper's 48 tiles of 7 steps, not causal), stay whole:
    one block a tile, no partials, three kernels a call."""
    bf = torch.bfloat16
    for B, H, Hkv, S, causal in ((2, 32, 8, 2048, True),
                                 (1, 12, 12, 448, False),
                                 (4, 32, 32, 1024, False)):
        sp = fa.dkdv_wrap(B, H, Hkv, S, S, causal)
        assert not sp.pieces and not sp.sums and not sp.offsets
        assert sp.blocks == len(sp.walks)
        for hd in (64, 128):
            assert fa.bwd_launches(bf, hd, B, H, Hkv, S, S, causal) == 3
    sp = fa.dkdv_wrap(1, 64, 8, 2048, 2048, True)
    assert sp.blocks == fa.SMS and max(sp.block_steps()) == 132
    assert fa.bwd_launches(bf, 128, 1, 64, 8, 2048) == 4


def test_wrap_walks_lays_walks_end_to_end():
    """``wrap_walks`` on a small list: blocks of T = 4 steps, a walk of no
    steps joining the block where it falls, slots consecutive in walk
    order."""
    sp = fa.wrap_walks((10, 0, 3, 1), sms=5)
    assert sp.offsets == (0, 1, 2, 5, 7)
    assert sp.pieces == ((0, 0, 4, 0), (0, 4, 8, 1), (0, 8, 10, 2),
                         (1, 0, 0, -1), (2, 0, 2, 3), (2, 2, 3, 4),
                         (3, 0, 1, -1))
    assert sp.sums == ((0, 0, 3), (2, 3, 2))
    assert sp.block_steps() == [4, 4, 4, 2]
    assert not fa.wrap_walks((4, 4, 4, 4), sms=5).pieces
    assert not fa.wrap_walks((10, 0, 3, 1), sms=4).pieces   # sms items


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_wrapper_on_the_cpu_runs_the_wrap_plain(hd, causal):
    """bf16 at hd 64/128 on CPU tensors: the autograd Function's gradients
    are the wrapped schedule's plain backward bitwise, on views of (B, S,
    heads, hd) tensors at a GQA group of 8 whose walks are cut."""
    rng = np.random.default_rng(hd)
    base = [torch.from_numpy(rng.standard_normal((1, 200, n, hd)).astype(
        np.float32)).to(torch.bfloat16).requires_grad_() for n in (8, 1, 1)]
    q, k, v = (t.transpose(1, 2) for t in base)
    assert fa.dkdv_wrap(1, 8, 1, 200, 200, causal).sums
    out = fa.flash_attention(q, k, v, causal=causal)
    want, lse = fa.flash_attention_plain(q, k, v, causal=causal, block_q=128,
                                         block_k=64, return_lse=True)
    assert torch.equal(out, want)
    g = torch.from_numpy(rng.standard_normal(out.shape).astype(
        np.float32)).to(torch.bfloat16)
    got = torch.autograd.grad(out, base, g)
    wants = fa.flash_attention_bwd_plain(q, k, v, want, lse, g, causal=causal,
                                         block_q=BQ, block_k=BK, split=True)
    for a, b in zip(got, wants):
        assert torch.equal(a, b.transpose(1, 2))


def test_wrap_plain_rejects_other_tiles():
    q = torch.zeros((1, 2, 64, 64))
    with pytest.raises(ValueError, match="split"):
        fa.flash_attention_bwd_plain(q, q, q, q, q[..., 0], q, causal=True,
                                     block_q=64, block_k=64, split=True)
