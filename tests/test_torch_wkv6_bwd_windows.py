"""K5's backward on its "windows" route, on the CPU: the plain version of
the route's schedule (``wkv6_bwd_windowed_plain``: chunks cut into windows,
the products across each window, the running products and recurrences
within it; at hd 128 the sums over the state's columns and q's over its
rows taken as partials of two halves, as a cluster of two CTAs takes them
on the card) and the autograd Function (``_WKV``), which runs it for CPU
tensors at every head dim, against ``jax.vjp`` of the JAX package's
sequential oracle (``repro.kernels.ref.wkv6_ref``) and of its model's
chunk form (``repro.models.layers._wkv_chunk``, carried state included),
and at every decay against autograd of the port's per-token recurrence in
float64.

Inputs are made with numpy from a seed and go to both packages.  A
gradient agrees when its largest error is within 2e-4 (the suite's wkv6
tolerance) of its largest reference entry.  The CUDA kernel of the route
(``csrc/wkv6_bwd_tc.cu``) has no CPU mode: its tests are in
tests/test_torch_cuda.py.
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
NAMES = ("dr", "dk", "dv", "dw", "du", "ds0")
DECAYS = [None, 0.1, 1e-3, 1.0, "model"]


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
        _, vjp = jax.vjp(jax_ref.wkv6_ref, r, k, v, w, u)
        return vjp((dout, ds))
    return jax.jit(f)


def _jax_grads(r, k, v, w, u, dout, ds):
    """(dr, dk, dv, dw, du) of wkv6_ref (zero initial state)."""
    return [np.asarray(g) for g in _ref_vjp()(
        *map(jnp.asarray, (r, k, v, w, u, dout, ds)))]


def _f64_grads(r, k, v, ww, u, s0, dout, ds):
    """Autograd of the per-token ``wkv6_plain`` in float64, with s0 and a
    cotangent on the final state."""
    xs = [t.double().requires_grad_() for t in _t(r, k, v, ww, u, s0)]
    out, s_fin = wk.wkv6_plain(*xs)
    return [g.numpy() for g in torch.autograd.grad(
        [out, s_fin], xs, [torch.from_numpy(dout).double(),
                           torch.from_numpy(ds).double()])]


# ---------------------------------------------------------------------------
# the route table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd", wk.HEAD_DIMS)
def test_bwd_route_takes_hd_64_through_the_windows(hd):
    """Every head dim the kernels take, rwkv6-3b's hd 64 among them, runs
    the windows route, counted under "bwd_windows", on chunks of whole
    windows whose columns split evenly over the route's ranks."""
    assert wk.bwd_route(hd) == "windows"
    assert wk.BWD_COUNT == {"windows": "bwd_windows"}
    assert wk.BWD_CHUNK[hd] % wk.BWD_WINDOW == 0
    assert hd % (16 * wk.BWD_RANKS[hd]) == 0
    assert wk.BWD_RANKS[hd] == (2 if hd == 128 else 1)


# ---------------------------------------------------------------------------
# the windowed plain version against the oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_ds", [False, True])
@pytest.mark.parametrize("w", DECAYS)
@pytest.mark.parametrize("S", [1, 63, 64, 200])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_windowed_plain_matches_jax_vjp(hd, S, w, with_ds):
    """``wkv6_bwd_windowed_plain`` (the kernel's chunks, ``BWD_CHUNK[hd]``,
    windows of 16; ragged last chunks and windows) against ``jax.vjp`` of
    the sequential oracle, with a cotangent on the output and, or not, on
    the final state."""
    r, k, v, ww, u, _, dout, ds = _case(2, 3, S, hd, seed=3 * S + hd, w=w)
    if not with_ds:
        ds = np.zeros_like(ds)
    want = _jax_grads(r, k, v, ww, u, dout, ds)
    got = wk.wkv6_bwd_windowed_plain(
        *_t(r, k, v, ww, u, None, dout, ds if with_ds else None),
        chunk=wk.BWD_CHUNK[hd])
    for name, g, x in zip(NAMES, got, want):
        assert torch.isfinite(g).all(), name
        _close(g.numpy(), x, msg=name)


@pytest.mark.parametrize("w", DECAYS)
@pytest.mark.parametrize("S", [1, 63, 64, 200])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_windowed_plain_with_state_matches_float64_autograd(hd, S, w):
    """With s0 and ds_fin, at every decay (R3: the reference's chunk form
    overflows at 0.1 and 1e-3): every gradient, ds0 included, against
    autograd of the per-token recurrence in float64."""
    case = _case(1, 2, S, hd, seed=5 * S + hd, w=w)
    want = _f64_grads(*case)
    got = wk.wkv6_bwd_windowed_plain(*_t(*case), chunk=wk.BWD_CHUNK[hd])
    for name, g, x in zip(NAMES, got, want):
        assert torch.isfinite(g).all(), name
        _close(g.numpy(), x, msg=name)


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
    reference's chunk form is finite: every gradient against ``jax.vjp`` of
    a scan over ``_wkv_chunk``, through the windowed plain version and
    through the Function at hd 64, which runs it."""
    r, k, v, ww, u, s0, dout, ds = _case(2, 3, S, hd, seed=S + 11)
    want = [np.asarray(g) for g in _chunk_form_vjp(32)(
        *map(jnp.asarray, (r, k, v, ww, u, s0, dout, ds)))]
    got = wk.wkv6_bwd_windowed_plain(*_t(r, k, v, ww, u, s0, dout, ds))
    for name, g, x in zip(NAMES, got, want):
        _close(g.numpy(), x, msg=f"plain {name}")
    xs = [t.requires_grad_() for t in _t(r, k, v, ww, u, s0)]
    out, s_fin = wk.wkv6_state(*xs)
    got = torch.autograd.grad([out, s_fin], xs,
                              [torch.from_numpy(dout), torch.from_numpy(ds)])
    for name, g, x in zip(NAMES, got, want):
        _close(g.numpy(), x, msg=f"Function {name}")


@pytest.mark.parametrize("window", [4, 8, 16, 32])
@pytest.mark.parametrize("w", [0.1, 1e-3, "model"])
@pytest.mark.parametrize("S", [63, 200])
def test_windowed_plain_equals_the_chunked_plain(S, w, window):
    """The windows' schedule and the per-token walk's on the same chunks:
    the same gradients within 2e-4 of each largest entry, at windows of 4
    to 32 tokens (the kernel's is ``BWD_WINDOW``)."""
    case = _t(*_case(2, 2, S, 16, seed=S + window, w=w))
    want = wk.wkv6_bwd_chunked_plain(*case, chunk=64)
    got = wk.wkv6_bwd_windowed_plain(*case, chunk=64, window=window)
    for name, g, x in zip(NAMES, got, want):
        _close(g.numpy(), x.numpy(), msg=name)


def test_windowed_plain_refuses_a_chunk_that_is_not_whole_windows():
    with pytest.raises(ValueError, match="window"):
        wk.wkv6_bwd_windowed_plain(*_t(*_case(1, 1, 8, 16)), chunk=24,
                                   window=16)


def test_every_gradient_is_finite_at_the_strongest_decay_and_at_zero():
    """w = 1e-3 over 200 tokens, where the reference's chunk form
    overflows, and w = 0 in one channel (every product through it is 0,
    nothing divides by it): every gradient finite and equal to float64
    autograd of the per-token recurrence."""
    r, k, v, ww, u, s0, dout, ds = _case(2, 3, 200, 64, seed=9, w=1e-3)
    chunk_out, _ = jax_layers._wkv_chunk(*map(jnp.asarray, (
        r[:, :, :64], k[:, :, :64], v[:, :, :64], ww[:, :, :64], u, s0)))
    assert not np.isfinite(np.asarray(chunk_out)).all()
    got = wk.wkv6_bwd_windowed_plain(*_t(r, k, v, ww, u, s0, dout, ds))
    for name, g in zip(NAMES, got):
        assert torch.isfinite(g).all(), name
    r, k, v, ww, u, s0, dout, ds = _case(1, 2, 100, 64, seed=10, w="model")
    ww[:, :, :, 5] = 0.0
    want = _f64_grads(r, k, v, ww, u, s0, dout, ds)
    got = wk.wkv6_bwd_windowed_plain(*_t(r, k, v, ww, u, s0, dout, ds))
    for name, g, x in zip(NAMES, got, want):
        assert torch.isfinite(g).all(), name
        _close(g.numpy(), x, msg=f"w = 0: {name}")


# ---------------------------------------------------------------------------
# the Function runs the windows route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w", [None, 1e-3, "model"])
@pytest.mark.parametrize("S", [1, 63, 200])
def test_function_at_hd_64_runs_the_windowed_plain(S, w, monkeypatch):
    """``wkv6_state`` with grad on CPU tensors at hd 64: its backward
    (``wkv6_bwd``) runs ``wkv6_bwd_windowed_plain`` on the kernel's chunks
    and windows, and autograd's gradients equal ``jax.vjp`` of the
    oracle."""
    calls = []
    real = wk.wkv6_bwd_windowed_plain

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)
    monkeypatch.setattr(wk, "wkv6_bwd_windowed_plain", spy)
    r, k, v, ww, u, _, dout, ds = _case(2, 3, S, 64, seed=13 * S, w=w)
    xs = [t.requires_grad_() for t in _t(r, k, v, ww, u)]
    out, s_fin = wk.wkv6_state(*xs)
    got = torch.autograd.grad([out, s_fin], xs,
                              [torch.from_numpy(dout), torch.from_numpy(ds)])
    assert calls == [(2, 3, S, 64)]
    for name, g, x in zip(NAMES, got, _jax_grads(r, k, v, ww, u, dout, ds)):
        _close(g.numpy(), x, msg=name)


@pytest.mark.parametrize("hd", [16, 32, 128])
def test_function_at_other_head_dims_runs_the_windows(hd, monkeypatch):
    """hd 16, 32 and 128 take the windows route too: the Function's CPU
    backward is the windowed plain version on ``BWD_CHUNK[hd]`` tokens a
    chunk, never the per-token walk's, and its gradients equal ``jax.vjp``
    of the oracle."""
    calls = []
    real = wk.wkv6_bwd_windowed_plain

    def spy(*a, **kw):
        calls.append((a[0].shape, a[8] if len(a) > 8 else kw.get("chunk")))
        return real(*a, **kw)

    def refuse(*a, **kw):
        raise AssertionError(f"the per-token walk's schedule ran at hd {hd}")
    monkeypatch.setattr(wk, "wkv6_bwd_windowed_plain", spy)
    monkeypatch.setattr(wk, "wkv6_bwd_chunked_plain", refuse)
    r, k, v, ww, u, _, dout, ds = _case(1, 2, 40, hd, seed=4)
    xs = [t.requires_grad_() for t in _t(r, k, v, ww, u)]
    out, s_fin = wk.wkv6_state(*xs)
    got = torch.autograd.grad([out, s_fin], xs,
                              [torch.from_numpy(dout), torch.from_numpy(ds)])
    assert calls == [((1, 2, 40, hd), wk.BWD_CHUNK[hd])]
    for name, g, x in zip(NAMES, got, _jax_grads(r, k, v, ww, u, dout, ds)):
        _close(g.numpy(), x, msg=name)


# ---------------------------------------------------------------------------
# hd 128: the sums over the state's columns in two ranks' partials
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w", [0.1, 1e-3, 1.0, "model"])
@pytest.mark.parametrize("S", [33, 200])
def test_rank_partials_equal_the_whole_rows(S, w, monkeypatch):
    """At hd 128 the windowed plain version sums Qr, Pk, c, rowsum(dS_e *
    S_a) and q as two ranks' partials, rank 0's first (``BWD_RANKS``), as
    the card's cluster does: the same gradients as the sums over whole rows
    within f32 rounding (1e-5 of each largest entry)."""
    case = _t(*_case(1, 2, S, 128, seed=S + 17, w=w))
    got = wk.wkv6_bwd_windowed_plain(*case, chunk=wk.BWD_CHUNK[128])
    monkeypatch.setitem(wk.BWD_RANKS, 128, 1)
    want = wk.wkv6_bwd_windowed_plain(*case, chunk=wk.BWD_CHUNK[128])
    for name, g, x in zip(NAMES, got, want):
        _close(g.numpy(), x.numpy(), tol=1e-5, msg=name)


@pytest.mark.parametrize("lost", [0, 1])
def test_a_lost_rank_partial_is_far_outside_the_limit(lost):
    """``lose_rank`` leaves one rank's partials out: dr, dk, dv and dw move
    far beyond the 2e-4 limit the checks hold the card to (so a kernel that
    lost a partial fails them); a head dim without ranks refuses it."""
    case = _t(*_case(1, 2, 64, 128, seed=23, w="model"))
    want = wk.wkv6_bwd_windowed_plain(*case, chunk=32)
    got = wk.wkv6_bwd_windowed_plain(*case, chunk=32, lose_rank=lost)
    for name, g, x in list(zip(NAMES, got, want))[:4]:
        assert (g - x).abs().max() > 100 * TOL * x.abs().max(), name
    with pytest.raises(ValueError, match="rank"):
        wk.wkv6_bwd_windowed_plain(*_t(*_case(1, 1, 8, 64)), lose_rank=0)
