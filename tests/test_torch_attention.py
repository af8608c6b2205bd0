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
    got = ops.flash_attention(*(torch.from_numpy(x).to(td) for x in (q, k, v)),
                              causal=causal, block_q=bq, block_k=bk)
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
                             block_q=64, block_k=48)
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
