"""The port's WKV6 recurrence (K5): its plain versions (the per-token
recurrence and the kernels' chunk schedule) against the JAX package's
sequential oracle and the reference model's chunk form, the carried state,
strong and unit decays (where the reference's chunk form overflows), the
layer's strided bf16 views and an in-place state, and the rule that the
wrapper runs on the card or raises.

The same inputs, made with numpy from a seed, go to both packages.  The
CUDA kernel has no CPU mode: the tests that launch it are in
tests/test_torch_cuda.py.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as jax_ref
from repro.models import layers as jax_layers
from repro_torch.kernels import ops
from repro_torch.kernels import ref as torch_ref
from repro_torch.kernels import wkv6 as wk

TOL = 2e-4


@pytest.fixture(autouse=True)
def _port_fault_free():
    from repro_torch.core import faults
    faults.reset()
    yield
    faults.reset()


def _inputs(B, H, S, hd, seed=0, w=None):
    """r, k, v ~ N(0, 1); w = sigmoid(N(0, 1)) * 0.5 + 0.45 (the JAX
    suite's decays) unless a constant is given; u ~ 0.1 N(0, 1)."""
    rng = np.random.default_rng(seed)
    r, k, v, wz = (rng.standard_normal((B, H, S, hd)).astype(np.float32)
                   for _ in range(4))
    ww = (1 / (1 + np.exp(-wz)) * 0.5 + 0.45).astype(np.float32) \
        if w is None else np.full((B, H, S, hd), w, np.float32)
    u = (rng.standard_normal((H, hd)) * 0.1).astype(np.float32)
    return r, k, v, ww, u


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


@pytest.mark.parametrize("B,H,S,hd", [(1, 2, 128, 64), (2, 1, 256, 32),
                                      (1, 1, 64, 16), (2, 2, 16, 128)])
def test_wkv6_plain_matches_jax_oracle(B, H, S, hd):
    xs = _inputs(B, H, S, hd)
    want, want_s = jax_ref.wkv6_ref(*map(jnp.asarray, xs))
    out, s = wk.wkv6_state(*_t(*xs))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), rtol=TOL,
                               atol=TOL)


def test_carried_state_equals_the_whole_sequence():
    """Two halves with the state carried equal one pass over the whole."""
    xs = _inputs(2, 3, 96, 64, seed=1)
    whole, s_whole = wk.wkv6_state(*_t(*xs))
    a = [x[:, :, :48] for x in xs[:4]]
    b = [x[:, :, 48:] for x in xs[:4]]
    out_a, s_a = wk.wkv6_state(*_t(*a, xs[4]))
    out_b, s_b = wk.wkv6_state(*_t(*b, xs[4]), s0=s_a)
    np.testing.assert_allclose(torch.cat([out_a, out_b], dim=2).numpy(),
                               whole.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(s_b.numpy(), s_whole.numpy(), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("S", [1, 32, 64])
def test_wkv6_matches_model_chunk_form_with_state(S):
    """Where the reference layer's _wkv_chunk is finite, K5's function is
    its function, nonzero initial state included (S=1 is the decode step)."""
    xs = _inputs(1, 2, S, 64, seed=2)
    s0 = np.random.default_rng(3).standard_normal((1, 2, 64, 64)).astype(
        np.float32)
    want, want_s = jax_layers._wkv_chunk(*map(jnp.asarray, (*xs, s0)))
    out, s = wk.wkv6_state(*_t(*xs), s0=torch.from_numpy(s0))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), rtol=TOL,
                               atol=TOL)


def test_strong_decay_stays_finite():
    """R3: at w = 0.1 the chunk form divides by 0.1**t and overflows fp32;
    the token-by-token form stays finite and equals the sequential oracle."""
    xs = _inputs(1, 2, 128, 64, seed=4, w=0.1)
    chunk_out, _ = jax_layers._wkv_chunk(
        *map(jnp.asarray, xs), jnp.zeros((1, 2, 64, 64), jnp.float32))
    assert not np.isfinite(np.asarray(chunk_out)).all()
    out, s = wk.wkv6_state(*_t(*xs))
    assert torch.isfinite(out).all() and torch.isfinite(s).all()
    want, want_s = jax_ref.wkv6_ref(*map(jnp.asarray, xs))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("chunk", [16, 64, 1000])
def test_ops_wkv6_returns_out_whatever_the_chunk(chunk):
    xs = _inputs(1, 2, 64, 32, seed=5)
    got = ops.wkv6(*_t(*xs), chunk=chunk)
    want, _ = jax_ref.wkv6_ref(*map(jnp.asarray, xs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_torch_ref_matches_jax_ref_with_initial_state():
    xs = _inputs(2, 2, 24, 16, seed=6)
    s0 = np.random.default_rng(7).standard_normal((2, 2, 16, 16)).astype(
        np.float32)
    out, s = torch_ref.wkv6_ref(*_t(*xs), s0=torch.from_numpy(s0))
    got, got_s = wk.wkv6_plain(*_t(*xs), s0=torch.from_numpy(s0))
    np.testing.assert_allclose(got.numpy(), out.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_s.numpy(), s.numpy(), rtol=TOL, atol=TOL)
    want, want_s = jax_ref.wkv6_ref(*map(jnp.asarray, xs))
    zero, zero_s = torch_ref.wkv6_ref(*_t(*xs))
    np.testing.assert_allclose(zero.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(zero_s.numpy(), np.asarray(want_s), rtol=TOL,
                               atol=TOL)


def test_wrapper_rejects_what_the_kernel_cannot_run():
    r, k, v, w, u = _t(*_inputs(1, 1, 8, 48))
    with pytest.raises(ValueError, match="head dim 48"):
        wk.wkv6_state(r, k, v, w, u)
    r, k, v, w, u = _t(*_inputs(1, 2, 8, 16))
    with pytest.raises(ValueError, match="dtype"):
        wk.wkv6_state(r.double(), k, v, w, u)
    with pytest.raises(ValueError, match="shape"):
        wk.wkv6_state(r, k, v, w, u[:1])
    with pytest.raises(ValueError, match="s0"):
        wk.wkv6_state(r, k, v, w, u, s0=torch.zeros(1, 2, 16, 8))


def test_wrapper_runs_on_the_card_or_raises():
    xs = _inputs(1, 1, 4, 16)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the rule is tested without one")
    n0 = sum(wk.LAUNCHES.values())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wk.wkv6_state(*xs)                           # numpy: the card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.wkv6(*_t(*xs), device="cuda")
    assert ops.wkv6(*_t(*xs), device="cpu").device.type == "cpu"
    assert sum(wk.LAUNCHES.values()) == n0           # the plain version ran


# ---------------------------------------------------------------------------
# the chunk schedule, the layer's views, the state written in place
# ---------------------------------------------------------------------------

PREFIX = 8      # tokens the oracle walks to make an initial state


@functools.lru_cache(maxsize=None)
def _oracle_case(S, w, with_state):
    """Inputs (B=1, H=2, hd=16) at a constant decay w, an initial state (the
    JAX oracle's state after PREFIX tokens, or None) and the oracle's
    outputs and final state on the S tokens that follow."""
    P = PREFIX if with_state else 0
    xs = _inputs(1, 2, P + S, 16, seed=S, w=w)
    out, s_fin = jax_ref.wkv6_ref(*map(jnp.asarray, xs))
    s0 = None
    if with_state:
        _, s0 = jax_ref.wkv6_ref(*(jnp.asarray(x[:, :, :P]) for x in xs[:4]),
                                 jnp.asarray(xs[4]))
        s0 = np.asarray(s0)
    tail = tuple(x[:, :, P:] for x in xs[:4]) + (xs[4],)
    return tail, s0, np.asarray(out)[:, :, P:], np.asarray(s_fin)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("w", [0.1, 1e-3, 1.0])
@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 200])
def test_chunk_schedule_matches_jax_oracle_and_per_token(S, chunk, w,
                                                         with_state):
    """The kernels' chunk schedule (its plain version), ragged last chunks
    included, against the JAX oracle and the per-token recurrence, finite
    at a strong (0.1), a near-total (1e-3) and no (1.0) decay."""
    xs, s0, want, want_s = _oracle_case(S, w, with_state)
    t = _t(*xs)
    s0t = None if s0 is None else torch.from_numpy(np.array(s0))
    out, s = wk.wkv6_chunked_plain(*t, s0=s0t, chunk=chunk)
    assert torch.isfinite(out).all() and torch.isfinite(s).all()
    np.testing.assert_allclose(out.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(s.numpy(), want_s, rtol=TOL, atol=TOL)
    tok, tok_s = wk.wkv6_plain(*t, s0=s0t)
    np.testing.assert_allclose(out.numpy(), tok.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(s.numpy(), tok_s.numpy(), rtol=TOL, atol=TOL)


def _layer_views(B, S, H, hd, seed):
    """r, k, v (B, S, D) bf16, w (B, S, D) f32 in (0, 1), u, s0, as a
    layer holds them, and the (B, H, S, hd) view of a (B, S, D) tensor."""
    D = H * hd
    rng = np.random.default_rng(seed)
    r, k, v = (torch.from_numpy(rng.standard_normal((B, S, D)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(3))
    w = torch.from_numpy((1 / (1 + np.exp(-rng.standard_normal((B, S, D))))
                          * 0.5 + 0.45).astype(np.float32))
    u = torch.from_numpy((rng.standard_normal((H, hd)) * 0.1).astype(
        np.float32))
    s0 = torch.from_numpy(rng.standard_normal((B, H, hd, hd)).astype(
        np.float32))

    def heads(t):
        return t.view(B, S, H, hd).transpose(1, 2)
    return r, k, v, w, u, s0, heads


@pytest.mark.parametrize("S", [1, 70])
def test_bf16_views_equal_their_f32_copies(S):
    """The layer's bf16 activations, viewed as (B, H, S, hd), and an output
    view of a (B, S, D) bf16 tensor: the result is the f32 computation on
    contiguous copies, its output rounded once to bf16."""
    B, H, hd = 2, 3, 16
    r, k, v, w, u, s0, heads = _layer_views(B, S, H, hd, seed=30 + S)
    out = torch.empty((B, S, H * hd), dtype=torch.bfloat16)
    views = [heads(x) for x in (r, k, v, w)]
    assert S == 1 or not views[0].is_contiguous()
    o, s = wk.wkv6_state(*views, u, s0, out=heads(out), chunk=16)
    assert o.data_ptr() == out.data_ptr() and o.dtype == torch.bfloat16
    want, want_s = wk.wkv6_state(*(x.float().contiguous() for x in views), u,
                                 s0, chunk=16)
    assert want.dtype == torch.float32
    assert torch.equal(out, want.transpose(1, 2).reshape(B, S, H * hd)
                       .to(torch.bfloat16))
    assert torch.equal(s, want_s)


@pytest.mark.parametrize("S", [1, 40])
def test_state_out_may_alias_the_initial_state(S):
    """An in-place update (``s_out`` is ``s0``) gives what a fresh state
    buffer gets, in the caller's tensor."""
    B, H, hd = 2, 2, 32
    r, k, v, w, u, s0, heads = _layer_views(B, S, H, hd, seed=40 + S)
    views = [heads(x) for x in (r, k, v, w)]
    fresh_o, fresh_s = wk.wkv6_state(*views, u, s0.clone(), chunk=16)
    buf = s0.clone()
    o, s = wk.wkv6_state(*views, u, buf, s_out=buf, chunk=16)
    assert s is buf
    assert torch.equal(o, fresh_o) and torch.equal(buf, fresh_s)
    assert not torch.equal(buf, s0)


def test_wrapper_rejects_views_it_cannot_take():
    B, H, S, hd = 1, 2, 16, 16
    r, k, v, w, u = _t(*_inputs(B, H, S, hd))
    with pytest.raises(ValueError, match="k: dtype"):
        wk.wkv6_state(r.bfloat16(), k, v, w, u)
    with pytest.raises(ValueError, match="out: dtype"):
        wk.wkv6_state(r, k, v, w, u, out=torch.empty_like(r).bfloat16())
    with pytest.raises(ValueError, match="s_out: shape"):
        wk.wkv6_state(r, k, v, w, u, s_out=torch.empty(B, H, hd, 8))
    with pytest.raises(ValueError, match="unit-stride"):
        wk.wkv6_state(r.transpose(2, 3), k, v, w, u)    # hd not unit-stride
