"""The port's flash attention (K4): its plain version against the JAX
package's oracle and the reference model's chunked attention, its block
schedule (the causal bound the TPU kernel gets wrong when block_q >
block_k), and the rule that the wrapper runs on the card or raises.

The same inputs, made with numpy from a seed, go to both packages.  The
CUDA kernel has no CPU mode: the tests that launch it are in
tests/test_torch_cuda.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.config import get_config
from repro.kernels import ref as jax_ref
from repro.models import layers as jax_layers
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref as torch_ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.fixture(autouse=True)
def _port_fault_free():
    from repro_torch.core import faults
    faults.reset()
    yield
    faults.reset()


def _qkv(B, H, S, hd, seed=0, Sk=None):
    rng = np.random.default_rng(seed)
    Sk = S if Sk is None else Sk
    return (rng.standard_normal((B, H, S, hd)).astype(np.float32),
            rng.standard_normal((B, H, Sk, hd)).astype(np.float32),
            rng.standard_normal((B, H, Sk, hd)).astype(np.float32))


def _oracle(q, k, v, causal, dtype):
    """repro's flash_attention_ref in ``dtype`` on the same values."""
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    out = jax_ref.flash_attention_ref(*(jnp.asarray(x).astype(jd)
                                        for x in (q, k, v)), causal=causal)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("B,H,S,hd,bq,bk", [
    (1, 2, 128, 64, 64, 64),
    (2, 1, 256, 128, 64, 64),
    (1, 4, 192, 64, 64, 32),      # block_q > block_k (R2)
    (1, 2, 128, 16, 64, 16),      # block_q > block_k, 4x
    (1, 2, 128, 32, 16, 64),      # block_q < block_k
    (1, 1, 64, 256, 32, 32),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_matches_jax_oracle(B, H, S, hd, bq, bk, dtype,
                                                  causal):
    q, k, v = _qkv(B, H, S, hd)
    td = getattr(torch, dtype)
    xs = [torch.from_numpy(x).to(td) for x in (q, k, v)]
    if fa.route(td, hd) != "cuda_cores":
        # the tensor-core kernels walk their own blocks (128 q rows in bf16,
        # 64 x 32 in f32): the plain version walks these blocks itself (the
        # wrapper's are held below)
        got = fa.flash_attention_plain(*xs, causal=causal, block_q=bq,
                                       block_k=bk)
    else:
        got = ops.flash_attention(*xs, causal=causal, block_q=bq, block_k=bk)
    assert got.dtype == td and tuple(got.shape) == (B, H, S, hd)
    np.testing.assert_allclose(got.float().numpy(),
                               _oracle(q, k, v, causal, dtype),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("bq,bk", [(64, 16), (32, 8), (48, 16)])
def test_causal_bound_keeps_every_kv_block(bq, bk):
    """R2: the TPU kernel's bound (qi*bq)//bk + 1 stops before the block
    holding the q block's last row when bq > bk; the port's walks to it."""
    S = 96 if bq == 48 else 128
    walks = fa.kv_blocks(S, S, bq, bk, causal=True)
    tpu = [(qi * bq) // bk + 1 for qi in range(S // bq)]
    need = [((qi + 1) * bq - 1) // bk + 1 for qi in range(S // bq)]
    assert walks == need
    assert any(t < n for t, n in zip(tpu, need))
    q, k, v = _qkv(1, 2, S, 32, seed=3)
    got = fa.flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                   causal=True, block_q=bq, block_k=bk)
    np.testing.assert_allclose(got.numpy(), _oracle(q, k, v, True, "float32"),
                               rtol=2e-5, atol=2e-5)


def test_ragged_blocks_and_cross_lengths():
    """S not a multiple of the blocks: the ragged last tiles are masked."""
    q, k, v = _qkv(1, 2, 100, 64, seed=4)
    got = fa.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                             block_q=64, block_k=32)
    np.testing.assert_allclose(got.numpy(), _oracle(q, k, v, True, "float32"),
                               rtol=2e-5, atol=2e-5)
    q, k, v = _qkv(2, 1, 40, 32, seed=5, Sk=72)
    got = fa.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=False,
                             block_q=16, block_k=32)
    want = jax_ref.flash_attention_ref(*map(jnp.asarray, (q, k, v)),
                                       causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("S,H,hd", [(64, 4, 16), (128, 2, 64), (96, 3, 128)])
def test_flash_attention_matches_model_chunked_attention(S, H, hd):
    """K4 computes the reference layer's _sdpa_chunked on arange positions
    ((B,S,H,hd) layout there, (B,H,S,hd) here)."""
    cfg = dataclasses.replace(get_config("llama3_8b", reduced=True),
                              dtype="float32", attn_impl="chunked",
                              attn_chunk=32)
    B = 2
    q, k, v = _qkv(B, S, H, hd, seed=6)          # (B, S, H, hd)
    pos = jnp.broadcast_to(jnp.arange(S), (B, S))
    want = jax_layers._sdpa_chunked(cfg, *map(jnp.asarray, (q, k, v)), pos,
                                    pos, jnp.float32)
    got = fa.flash_attention(*(torch.from_numpy(x).transpose(1, 2)
                               .contiguous() for x in (q, k, v)), causal=True)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_torch_ref_matches_jax_ref(causal):
    q, k, v = _qkv(2, 2, 48, 32, seed=7)
    got = torch_ref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                        causal=causal)
    np.testing.assert_allclose(got.numpy(), _oracle(q, k, v, causal,
                                                    "float32"),
                               rtol=2e-5, atol=2e-5)


def test_wrapper_rejects_what_the_kernel_cannot_run():
    q, k, v = map(torch.from_numpy, _qkv(1, 1, 64, 48))
    with pytest.raises(ValueError, match="head dim 48"):
        fa.flash_attention(q, k, v)
    q, k, v = map(torch.from_numpy, _qkv(1, 1, 128, 64))
    with pytest.raises(ValueError, match="blocks"):
        fa.flash_attention(q, k, v, block_q=128)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention(q, k, v.double())
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention(q.half(), k.half(), v.half())


def test_wrapper_runs_on_the_card_or_raises():
    q, k, v = _qkv(1, 1, 64, 64)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the rule is tested without one")
    n0 = sum(fa.LAUNCHES.values())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fa.flash_attention(q, k, v)                  # numpy: the card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fa.flash_attention(*map(torch.from_numpy, (q, k, v)), device="cuda")
    got = fa.flash_attention(*map(torch.from_numpy, (q, k, v)), device="cpu")
    assert got.device.type == "cpu"
    assert sum(fa.LAUNCHES.values()) == n0           # the plain version ran


# ---------------------------------------------------------------------------
# grouped-query attention, strided views, the kernels' blocks
# ---------------------------------------------------------------------------


def _gqa(B, H, Hkv, S, hd, seed, Sk=None):
    """q (B, H, S, hd) and k, v (B, Hkv, Sk, hd), numpy f32."""
    rng = np.random.default_rng(seed)
    Sk = S if Sk is None else Sk
    return (rng.standard_normal((B, H, S, hd)).astype(np.float32),
            rng.standard_normal((B, Hkv, Sk, hd)).astype(np.float32),
            rng.standard_normal((B, Hkv, Sk, hd)).astype(np.float32))


def _repeated(k, H):
    """kv heads repeated for their groups of q heads, as the reference's
    _repeat_kv does: q head h reads kv head h // (H / Hkv)."""
    return np.repeat(k, H // k.shape[1], axis=1)


@pytest.mark.parametrize("Hkv", [1, 2, 8])          # 1, H/4, H
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bq,bk", [(128, 128), (128, 64), (64, 32)])
def test_plain_gqa_matches_oracle_on_repeated_kv(Hkv, causal, bq, bk):
    H = 8
    q, k, v = _gqa(1, H, Hkv, 200, 32, seed=10 + Hkv)
    got = fa.flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                   causal=causal, block_q=bq, block_k=bk)
    want = _oracle(q, _repeated(k, H), _repeated(v, H), causal, "float32")
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("hd,Hkv", [(64, 2), (128, 1), (256, 4), (32, 2),
                                    (16, 4)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wrapper_takes_strided_views_and_kv_heads(hd, Hkv, dtype):
    """The layer's (B, S, heads, hd) activations, transposed to (B, heads,
    S, hd) views, with k and v at Hkv heads: the wrapper takes them as they
    are (the tensor-core route reads them through their strides)."""
    B, S, H = 2, 136, 4
    rng = np.random.default_rng(hd + Hkv)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    td = getattr(torch, dtype)
    views = [torch.from_numpy(x).to(td).transpose(1, 2) for x in (q, k, v)]
    assert not views[0].is_contiguous()
    got = fa.flash_attention(*views, causal=True)
    assert tuple(got.shape) == (B, H, S, hd) and got.dtype == td
    q, k, v = (x.transpose(0, 2, 1, 3) for x in (q, k, v))
    want = _oracle(q, _repeated(k, H), _repeated(v, H), True, dtype)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_tensor_core_route_blocks_match_oracle(hd, causal):
    """bf16 at hd 64/128/256 takes the tensor-core kernel's blocks: the
    default, 128 q rows by 64 keys (block_q > block_k, so the causal bound
    of R2 is on the main path), and (128, 128) where it is built, each held
    against the oracle on a ragged length."""
    q, k, v = _gqa(1, 4, 2, 200, hd, seed=hd)
    xs = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    want = _oracle(q, _repeated(k, 4), _repeated(v, 4), causal, "bfloat16")
    assert fa.route(torch.bfloat16, hd) == "wgmma"
    assert fa.route(torch.float32, hd) == "tf32x3"
    for blocks in [{}, *({"block_q": bq, "block_k": bk}
                         for bq, bk in fa.WGMMA_BLOCKS[hd])]:
        got = fa.flash_attention(*xs, causal=causal, **blocks)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                                   atol=2e-2, err_msg=str(blocks))
    assert fa.WGMMA_BLOCKS[hd][0] == (128, 64)


def test_tensor_core_route_rejects_what_it_cannot_run():
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _gqa(1, 4, 2, 128, 64, seed=1))
    with pytest.raises(ValueError, match="blocks"):
        fa.flash_attention(q, k, v, block_q=64, block_k=64)
    with pytest.raises(ValueError, match="blocks"):
        fa.flash_attention(q, k, v, block_q=128, block_k=32)
    with pytest.raises(ValueError, match="kv heads"):
        fa.flash_attention(q, k[:, :1].expand(1, 3, 128, 64), v[:, :1]
                           .expand(1, 3, 128, 64))
    with pytest.raises(ValueError, match="unit-stride"):
        fa.flash_attention(q, k.transpose(2, 3).contiguous().transpose(2, 3),
                           v)
    with pytest.raises(ValueError, match="16 bytes"):
        wide = torch.zeros((1, 2, 128, 68), dtype=torch.bfloat16)
        fa.flash_attention(q, wide[..., :64], v)
    # float32 at hd 64 takes the tf32x3 kernel's own 64 x 32 tiles only
    qf, kf, vf = q.float(), k.float(), v.float()
    for blocks in ({"block_q": 128}, {"block_q": 64, "block_k": 64},
                   {"block_q": 48, "block_k": 20}, {"block_k": 16}):
        with pytest.raises(ValueError, match="blocks"):
            fa.flash_attention(qf, kf, vf, **blocks)
    want = fa.flash_attention_plain(qf, kf, vf, causal=True, block_q=64,
                                    block_k=32)
    for blocks in ({}, {"block_q": 64}, {"block_q": 64, "block_k": 32}):
        torch.testing.assert_close(fa.flash_attention(qf, kf, vf, **blocks),
                                   want, rtol=0, atol=0)


@pytest.mark.parametrize("hd,dtype", [(64, "bfloat16"), (16, "float32")])
def test_attn_forward_gqa_matches_jax_chunked_attention(hd, dtype,
                                                        monkeypatch):
    """The port's attn_forward at reduced llama3-8b (6 heads, 2 kv heads)
    on carried weights against the JAX layer's _sdpa_chunked path: at hd 64
    in bf16 (the tensor-core route, k and v unrepeated) and at the reduced
    config's hd 16 in f32 (the CUDA-core route)."""
    import jax
    from repro_torch.config import get_config as torch_config
    from repro_torch.models import layers as torch_layers
    cfg = dataclasses.replace(get_config("llama3_8b", reduced=True),
                              dtype=dtype, head_dim=hd, attn_impl="chunked",
                              attn_chunk=32)
    tcfg = dataclasses.replace(torch_config("llama3_8b", reduced=True),
                               dtype=dtype, head_dim=hd, attn_impl="chunked",
                               attn_chunk=32)
    assert (cfg.n_heads, cfg.n_kv_heads) == (6, 2)
    B, S = 2, 64
    p = jax.tree.map(np.asarray, jax_layers.init_attn(cfg, jax.random.key(1)))
    x = np.random.default_rng(2).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S))
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = jax_layers.attn_forward(cfg, p, jnp.asarray(x).astype(jd),
                                   jnp.asarray(pos), True)
    td = getattr(torch, dtype)
    tp = {n: torch.from_numpy(np.array(w, np.float32)).to(td)
          for n, w in p.items()}
    seen = []
    real = torch_layers.flash_attention

    def spy(q, k, v, **kw):
        seen.append((k.shape[1], all(t.transpose(1, 2).is_contiguous()
                                     for t in (q, k, v))))
        return real(q, k, v, **kw)
    monkeypatch.setattr(torch_layers, "flash_attention", spy)
    got = torch_layers.attn_forward(tcfg, tp, torch.from_numpy(x).to(td), None)
    # K4 got k and v with their 2 kv heads, as views of the layer's
    # (B, S, heads, hd) activations: no repeat, no copy
    assert seen == [(cfg.n_kv_heads, True)]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=TOL[dtype], atol=TOL[dtype])


# ---------------------------------------------------------------------------
# the route table, and the layer's GQA views at every route's head dims
# ---------------------------------------------------------------------------


def test_route_table():
    """Which kernel takes a call is a function of (dtype, hd) alone: f32 at
    hd 64-256 on the tf32x3 tensor-core kernel (256 included), bf16 at hd
    64-256 on the wgmma kernel, hd 16 and 32 on the CUDA-core kernel."""
    want = {(torch.float32, 16): "cuda_cores", (torch.float32, 32): "cuda_cores",
            (torch.float32, 64): "tf32x3", (torch.float32, 128): "tf32x3",
            (torch.float32, 256): "tf32x3",
            (torch.bfloat16, 16): "cuda_cores",
            (torch.bfloat16, 32): "cuda_cores",
            (torch.bfloat16, 64): "wgmma", (torch.bfloat16, 128): "wgmma",
            (torch.bfloat16, 256): "wgmma"}
    assert {key: fa.route(*key) for key in want} == want
    assert fa.TF32X3_BLOCKS[256] == (64, 16)
    assert fa.CUDA_CORE_BLOCKS == (16, 64)


@pytest.mark.parametrize("hd", [16, 32, 256])
@pytest.mark.parametrize("Hkv", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_wrapper_gqa_views_match_jax_oracle(hd, Hkv, dtype, causal):
    """The wrapper on the .transpose(1, 2) views of (B, S, heads, hd)
    tensors, 6 q heads over Hkv < 6 kv heads, a ragged length, at its
    default blocks: the JAX oracle on kv repeated to 6 heads."""
    B, S, H = 2, 72, 6
    rng = np.random.default_rng(hd + 10 * Hkv)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    td = getattr(torch, dtype)
    views = [torch.from_numpy(x).to(td).transpose(1, 2) for x in (q, k, v)]
    got = fa.flash_attention(*views, causal=causal)
    assert tuple(got.shape) == (B, H, S, hd) and got.dtype == td
    q, k, v = (x.transpose(0, 2, 1, 3) for x in (q, k, v))
    want = _oracle(q, _repeated(k, H), _repeated(v, H), causal, dtype)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL[dtype],
                               atol=TOL[dtype])
