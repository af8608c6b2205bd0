"""K5's backward on the CPU: the plain version of the backward kernel's
schedule (``wkv6_bwd_chunked_plain``) and the autograd Function that
``wkv6_state`` runs under grad (``_WKV``), against ``jax.vjp`` of the JAX
package's sequential oracle (``repro.kernels.ref.wkv6_ref``) and of its
model's chunk form (``repro.models.layers._wkv_chunk``, carried state
included), and at strong decays against autograd of the port's per-token
recurrence in float64.

The JAX package has no Pallas backward for K5: it differentiates the chunk
form with ``jax.grad``.  Inputs are made with numpy from a seed and go to
both packages; cotangents fall on the output and on the final state.  A
gradient agrees when its largest error is within 2e-4 (the suite's wkv6
tolerance) of its largest reference entry; bf16 gradients rounded once
from fp32 (dr, dk, dv) within 1e-2.  The CUDA kernel has no CPU mode: its
tests are in tests/test_torch_cuda.py.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ref as jax_ref
from repro.models import layers as jax_layers
from repro_torch.kernels import wkv6 as wk

TOL = 2e-4
BF16_TOL = 1e-2
NAMES = ("dr", "dk", "dv", "dw", "du", "ds0")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain versions and the float64 oracle walk the tokens in many
    small PyTorch ops: run them on one thread, so that a test worker
    beside others never waits on intra-op threads that another worker's
    load has descheduled (with 6 workers on 8 cores that made this
    module's tests ~40x slower than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _port_fault_free():
    from repro_torch.core import faults
    faults.reset()
    yield
    faults.reset()


def _decays(rng, shape, w):
    """The JAX suite's decays (sigmoid(N(0, 1)) * 0.5 + 0.45), a constant,
    or ("model") the time mix's exp(-exp(x - 4)) on x ~ N(0, 1)."""
    if w is None:
        return (1 / (1 + np.exp(-rng.standard_normal(shape))) * 0.5
                + 0.45).astype(np.float32)
    if w == "model":
        return np.exp(-np.exp(rng.standard_normal(shape) - 4.0)).astype(
            np.float32)
    return np.full(shape, w, np.float32)


def _case(B, H, S, hd, seed=0, w=None):
    """r, k, v, w, u, s0, dout, ds_fin as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, H, S, hd)).astype(np.float32)
               for _ in range(3))
    ww = _decays(rng, (B, H, S, hd), w)
    u = (rng.standard_normal((H, hd)) * 0.1).astype(np.float32)
    s0 = rng.standard_normal((B, H, hd, hd)).astype(np.float32)
    dout = rng.standard_normal((B, H, S, hd)).astype(np.float32)
    ds = rng.standard_normal((B, H, hd, hd)).astype(np.float32)
    return r, k, v, ww, u, s0, dout, ds


def _t(*xs):
    return [None if x is None else torch.from_numpy(np.ascontiguousarray(x))
            for x in xs]


def _close(got, want, tol=TOL, msg=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, msg
    err = np.abs(got - want).max()
    scale = max(np.abs(want).max(), 1e-30)
    assert err <= tol * scale, f"{msg}: max error {err:.3g}, limit " \
        f"{tol * scale:.3g} ({tol} of {scale:.3g})"


@functools.lru_cache(maxsize=None)
def _ref_vjp():
    def f(r, k, v, w, u, dout, ds):
        out, vjp = jax.vjp(jax_ref.wkv6_ref, r, k, v, w, u)
        return vjp((dout, ds))
    return jax.jit(f)


def _jax_grads(r, k, v, w, u, dout, ds):
    """(dr, dk, dv, dw, du) of wkv6_ref (zero initial state)."""
    return [np.asarray(g) for g in _ref_vjp()(
        *map(jnp.asarray, (r, k, v, w, u, dout, ds)))]


# ---------------------------------------------------------------------------
# the plain backward and the Function against jax.vjp of the oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w", [None, 0.1, 1e-3, 1.0, "model"])
@pytest.mark.parametrize("chunk", [1, 16, 64])
@pytest.mark.parametrize("S", [1, 63, 64, 200])
@pytest.mark.parametrize("hd", [16, 64])
def test_plain_backward_matches_jax_vjp(hd, S, chunk, w):
    """``wkv6_bwd_chunked_plain`` at chunks of 1, 16 and 64 (ragged last
    chunks) against ``jax.vjp`` of the sequential oracle, with cotangents on
    the output and the final state."""
    r, k, v, ww, u, _, dout, ds = _case(2, 3, S, hd, seed=S + hd, w=w)
    want = _jax_grads(r, k, v, ww, u, dout, ds)
    got = wk.wkv6_bwd_chunked_plain(*_t(r, k, v, ww, u, None, dout, ds),
                                    chunk=chunk)
    for name, g, x in zip(NAMES, got, want):
        assert torch.isfinite(g).all(), name
        _close(g.numpy(), x, msg=name)


@pytest.mark.parametrize("w", [None, 1e-3, "model"])
@pytest.mark.parametrize("S", [1, 63, 200])
@pytest.mark.parametrize("hd", [16, 64])
def test_function_matches_jax_vjp(hd, S, w):
    """``wkv6_state`` with grad on CPU tensors runs ``_WKV``: its output and
    final state carry the Function's grad_fn, and autograd's gradients
    through both equal ``jax.vjp`` of the oracle."""
    r, k, v, ww, u, _, dout, ds = _case(2, 3, S, hd, seed=7 * S + hd, w=w)
    xs = [t.requires_grad_() for t in _t(r, k, v, ww, u)]
    out, s_fin = wk.wkv6_state(*xs)
    assert "WKV" in type(out.grad_fn).__name__
    got = torch.autograd.grad([out, s_fin], xs,
                              [torch.from_numpy(dout), torch.from_numpy(ds)])
    for name, g, x in zip(NAMES, got, _jax_grads(r, k, v, ww, u, dout, ds)):
        _close(g.numpy(), x, msg=name)


def test_function_takes_a_gradient_on_one_output_alone():
    """A loss on the final state alone (the output's gradient is None) or
    on the output alone (the state's)."""
    r, k, v, ww, u, _, dout, ds = _case(1, 2, 40, 16, seed=3)
    zero = np.zeros_like(dout)
    for which in ("state", "out"):
        xs = [t.requires_grad_() for t in _t(r, k, v, ww, u)]
        out, s_fin = wk.wkv6_state(*xs)
        if which == "state":
            got = torch.autograd.grad(s_fin, xs, torch.from_numpy(ds))
            want = _jax_grads(r, k, v, ww, u, zero, ds)
        else:
            got = torch.autograd.grad(out, xs, torch.from_numpy(dout))
            want = _jax_grads(r, k, v, ww, u, dout, np.zeros_like(ds))
        for name, g, x in zip(NAMES, got, want):
            _close(g.numpy(), x, msg=f"{which}: {name}")


# ---------------------------------------------------------------------------
# the initial state: the model's chunk form at mild decays, float64 autograd
# at strong ones
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _chunk_form_vjp(chunk):
    """jax.vjp of a scan of ``_wkv_chunk`` over chunks of ``chunk`` tokens,
    as the reference's time mix walks it, carried state included."""
    def run(r, k, v, w, u, s0):
        B, H, S, hd = r.shape
        split = lambda t: t.reshape(B, H, S // chunk, chunk, hd).transpose(
            2, 0, 1, 3, 4)

        def step(s, args):
            out, s1 = jax_layers._wkv_chunk(*args, u, s)
            return s1, out
        s_fin, outs = jax.lax.scan(step, s0, tuple(map(split, (r, k, v, w))))
        return outs.transpose(1, 2, 0, 3, 4).reshape(B, H, S, hd), s_fin

    def f(r, k, v, w, u, s0, dout, ds):
        _, vjp = jax.vjp(run, r, k, v, w, u, s0)
        return vjp((dout, ds))
    return jax.jit(f)


@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("S", [32, 128])
def test_initial_state_gradient_matches_the_chunk_form(S, hd):
    """With s0 and ds0, at the JAX suite's mild decays, where the
    reference's chunk form (which divides by cumulative decays) is finite:
    every gradient, ds0 included, against ``jax.vjp`` of a scan over
    ``_wkv_chunk``, through the plain backward and through the Function."""
    r, k, v, ww, u, s0, dout, ds = _case(2, 3, S, hd, seed=S + 1)
    want = [np.asarray(g) for g in _chunk_form_vjp(32)(
        *map(jnp.asarray, (r, k, v, ww, u, s0, dout, ds)))]
    got = wk.wkv6_bwd_chunked_plain(*_t(r, k, v, ww, u, s0, dout, ds),
                                    chunk=16)
    for name, g, x in zip(NAMES, got, want):
        _close(g.numpy(), x, msg=f"plain {name}")
    xs = [t.requires_grad_() for t in _t(r, k, v, ww, u, s0)]
    out, s_fin = wk.wkv6_state(*xs)
    got = torch.autograd.grad([out, s_fin], xs,
                              [torch.from_numpy(dout), torch.from_numpy(ds)])
    for name, g, x in zip(NAMES, got, want):
        _close(g.numpy(), x, msg=f"Function {name}")


@pytest.mark.parametrize("w", [0.1, 1e-3, 1.0])
@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize("S", [63, 200])
def test_strong_decays_match_float64_autograd(S, chunk, w):
    """R3: at decays where the reference's chunk form overflows, the plain
    backward (f32, with s0 and ds_fin) against autograd of the per-token
    ``wkv6_plain`` in float64."""
    r, k, v, ww, u, s0, dout, ds = _case(1, 2, S, 16, seed=S + chunk, w=w)
    xs = [t.double().requires_grad_() for t in _t(r, k, v, ww, u, s0)]
    out, s_fin = wk.wkv6_plain(*xs)
    want = torch.autograd.grad([out, s_fin], xs, [
        torch.from_numpy(dout).double(), torch.from_numpy(ds).double()])
    got = wk.wkv6_bwd_chunked_plain(*_t(r, k, v, ww, u, s0, dout, ds),
                                    chunk=chunk)
    for name, g, x in zip(NAMES, got, want):
        assert torch.isfinite(g).all(), name
        _close(g.numpy(), x.numpy(), msg=name)


def test_every_gradient_is_finite_at_the_strongest_decay():
    """w = 1e-3 at chunks of 64 over 200 tokens: nothing divides, so every
    gradient is finite where the reference's chunk form overflows."""
    r, k, v, ww, u, s0, dout, ds = _case(2, 3, 200, 64, seed=9, w=1e-3)
    chunk_out, _ = jax_layers._wkv_chunk(*map(jnp.asarray, (
        r[:, :, :64], k[:, :, :64], v[:, :, :64], ww[:, :, :64], u, s0)))
    assert not np.isfinite(np.asarray(chunk_out)).all()
    got = wk.wkv6_bwd_chunked_plain(*_t(r, k, v, ww, u, s0, dout, ds),
                                    chunk=64)
    for name, g in zip(NAMES, got):
        assert torch.isfinite(g).all(), name
    xs = [t.requires_grad_() for t in _t(r, k, v, ww, u, s0)]
    out, s_fin = wk.wkv6_state(*xs)
    grads = torch.autograd.grad([out, s_fin], xs, [torch.from_numpy(dout),
                                                   torch.from_numpy(ds)])
    assert all(torch.isfinite(g).all() for g in grads)


# ---------------------------------------------------------------------------
# the layer's bf16 views, in-place writes, calls without grad
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", [1, 70])
def test_bf16_views_give_view_gradients(S, with_state):
    """r, k, v (bf16) and w (f32) as the time mix hands them: (B, H, S, hd)
    views of (B, S, D) tensors.  The output takes r's layout; each gradient
    has its input's shape, dtype and layout (a view of a (B, S, D) tensor)
    and equals the gradient of f32 copies of the same inputs within the
    bf16 limit (dr, dk, dv, rounded once) or 2e-4 (dw, du, ds0)."""
    B, H, hd = 2, 3, 16
    D = H * hd
    rng = np.random.default_rng(S)

    def heads(t):
        return t.view(B, S, H, hd).transpose(1, 2)
    base = [torch.from_numpy(rng.standard_normal((B, S, D)).astype(
        np.float32)).to(torch.bfloat16).requires_grad_() for _ in range(3)]
    wb = torch.from_numpy(_decays(rng, (B, S, D), "model")).requires_grad_()
    u = torch.from_numpy((rng.standard_normal((H, hd)) * 0.1).astype(
        np.float32)).requires_grad_()
    s0 = torch.from_numpy(rng.standard_normal((B, H, hd, hd)).astype(
        np.float32)).requires_grad_() if with_state else None
    dout = torch.from_numpy(rng.standard_normal((B, H, S, hd)).astype(
        np.float32))
    ds = torch.from_numpy(rng.standard_normal((B, H, hd, hd)).astype(
        np.float32))
    ins = [*base, wb, u] + ([s0] if with_state else [])
    out, s_fin = wk.wkv6_state(*(heads(t) for t in (*base, wb)), u, s0)
    assert out.dtype == torch.bfloat16
    assert out.transpose(1, 2).is_contiguous()           # r's layout
    got = torch.autograd.grad([out, s_fin], ins,
                              [dout.to(torch.bfloat16), ds])
    ref = [t.detach().float().requires_grad_() for t in ins]
    o32, s32 = wk.wkv6_state(*(heads(t) for t in ref[:4]), ref[4],
                             ref[5] if with_state else None)
    want = torch.autograd.grad([o32, s32], ref, [
        dout.to(torch.bfloat16).float(), ds])
    for name, g, x, t in zip(NAMES, got, want, ins):
        assert g.dtype == t.dtype and g.shape == t.shape, name
        _close(g.float().numpy(), x.numpy(),
               BF16_TOL if name in ("dr", "dk", "dv") else TOL, name)
    # the Function's gradients for the views, before autograd reshapes them
    r, k, v, w = (heads(t.detach()) for t in (*base, wb))
    dr, dk, dv, dw, _, _ = wk.wkv6_bwd(r, k, v, w, u.detach(), None,
                                       dout.to(torch.bfloat16))
    for g, x in zip((dr, dk, dv, dw), (r, k, v, w)):
        assert g.stride() == x.stride() and g.dtype == x.dtype


def test_in_place_writes_under_grad_raise():
    r, k, v, ww, u, s0, _, _ = _t(*_case(1, 2, 8, 16))
    r.requires_grad_()
    with pytest.raises(ValueError, match="out="):
        wk.wkv6_state(r, k, v, ww, u, out=torch.empty_like(r))
    with pytest.raises(ValueError, match="s_out="):
        wk.wkv6_state(r, k, v, ww, u, s0, s_out=s0)
    with torch.no_grad():
        out, _ = wk.wkv6_state(r, k, v, ww, u, s0, out=torch.empty_like(r),
                               s_out=s0)
    assert out.grad_fn is None


def test_no_grad_calls_skip_the_function():
    r, k, v, ww, u, _, _, _ = _t(*_case(1, 2, 16, 16))
    u.requires_grad_()
    with torch.no_grad():
        out, s = wk.wkv6_state(r, k, v, ww, u)
    assert out.grad_fn is None and s.grad_fn is None
    out, s = wk.wkv6_state(r, k, v, ww, u.detach())
    assert out.grad_fn is None and s.grad_fn is None
    out, s = wk.wkv6_state(r, k, v, ww, u)
    assert "WKV" in type(out.grad_fn).__name__


def test_backward_raises_for_a_head_dim_it_is_not_built_for():
    r, k, v, ww, u, s0, dout, _ = _t(*_case(1, 1, 8, 48))
    with pytest.raises(NotImplementedError, match="hd=48"):
        wk.wkv6_bwd(r, k, v, ww, u, None, dout)
