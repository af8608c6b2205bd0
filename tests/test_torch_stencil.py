"""The port's fused stencil (K1): its plain version against the JAX
package's oracle, its configuration against the reference's, and the rule
that the wrapper runs on the card or raises.

The same inputs, made with numpy from a seed, go to both packages.  The
CUDA kernel itself has no CPU mode: the tests that launch it are in
tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as jax_ref
from repro_torch.kernels import ref as torch_ref
from repro_torch.kernels import stencil_pipeline as sp

W3 = [0.25, 0.5, 0.25]


@pytest.fixture(autouse=True)
def _port_fault_free():
    from repro_torch.core import faults
    faults.reset()
    yield
    faults.reset()


def _img(H, W, seed=1) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((H, W)).astype(
        np.float32)


def _jax_oracle(img: torch.Tensor) -> np.ndarray:
    """repro's stencil_pipeline_ref in f32 on the same values."""
    w = jnp.asarray(W3, jnp.float32)
    return np.asarray(jax_ref.stencil_pipeline_ref(
        jnp.asarray(img.float().numpy()), w, w))


@pytest.mark.parametrize("H,W,br", [(18, 32, 8), (34, 130, 4), (10, 16, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stencil_pipeline_plain_matches_jax_oracle(H, W, br, dtype):
    td = getattr(torch, dtype)
    img = torch.from_numpy(_img(H, W)).to(td)
    w = torch.tensor(W3, dtype=td)
    got = sp.stencil_pipeline(img, w, w, block_rows=br)   # CPU: plain
    assert got.dtype == td and tuple(got.shape) == (H - 2, W - 2)
    tol = 3e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got.float().numpy(), _jax_oracle(img),
                               rtol=tol, atol=tol)


def test_torch_ref_matches_jax_ref():
    img = torch.from_numpy(_img(34, 130, seed=3))
    got = torch_ref.stencil_pipeline_ref(img, torch.tensor(W3),
                                         torch.tensor(W3))
    np.testing.assert_allclose(got.numpy(), _jax_oracle(img), rtol=1e-5,
                               atol=1e-5)


def test_plain_matches_torch_ref_in_f32():
    img = torch.from_numpy(_img(18, 32, seed=4))
    w = torch.tensor(W3)
    np.testing.assert_allclose(
        sp.stencil_pipeline_plain(img, w, w).numpy(),
        torch_ref.stencil_pipeline_ref(img, w, w).numpy(), rtol=1e-6,
        atol=1e-6)


def test_default_config_from_dse_equals_reference():
    from repro.kernels import stencil_pipeline as jax_sp
    assert sp._stencil_codegen_config() == (2, 2)
    assert sp.stencil_config_source() == "dse"
    assert sp._stencil_codegen_config() == jax_sp._stencil_codegen_config()


def test_ilp_halo_rows_equals_reference():
    from repro.kernels import stencil_pipeline as jax_sp
    assert sp.ilp_halo_rows() == jax_sp.ilp_halo_rows()


def test_rows_not_multiple_of_block_rows_raise():
    img = torch.from_numpy(_img(11, 16))
    w = torch.tensor(W3)
    with pytest.raises(ValueError, match="not a multiple of block_rows"):
        sp.stencil_pipeline(img, w, w, block_rows=2, halo=2)


def test_halo_below_two_raises():
    img = torch.from_numpy(_img(10, 16))
    w = torch.tensor(W3)
    with pytest.raises(ValueError, match="halo"):
        sp.stencil_pipeline(img, w, w, block_rows=4, halo=1)


def test_unsupported_dtype_raises():
    img = torch.from_numpy(_img(10, 16)).double()
    with pytest.raises(ValueError, match="dtype"):
        sp.stencil_pipeline(img, torch.tensor(W3), torch.tensor(W3),
                            block_rows=4, halo=2)


def test_card_requested_without_card_raises(monkeypatch):
    """No path runs on the CPU when the card is asked for and missing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = torch.from_numpy(_img(10, 16))
    w = torch.tensor(W3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sp.stencil_pipeline(img, w, w, block_rows=4, halo=2, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sp.stencil_pipeline(_img(10, 16), np.array(W3, np.float32),
                            np.array(W3, np.float32), block_rows=4, halo=2)
    assert sum(sp.LAUNCHES.values()) == 0


def test_shared_memory_fits_the_block_at_the_default_config():
    br, halo = sp._stencil_codegen_config()
    assert sp.smem_bytes(br, halo) <= 48 * 1024
