"""The port's hybrid family (Jamba: Mamba layers with one attention layer a
period, MoE on every other layer) against the JAX package's, on the reduced
configuration in f32 at ``test_torch_model.py``'s tolerance: the Mamba
layer (its chunked prefill, its decode with a carried state, a bf16 layer),
the whole 8-layer model's prefill, decode logits and caches, and the
continuous batcher's token ids, a reused slot's Mamba state included.

Weights are drawn by the reference (``jax.random``) and handed across as
numpy arrays; inputs are made with numpy from a seed.  The reduced Jamba is
slow to compile in JAX, so the module builds it once and jits only its
forward and decode step.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import config as jax_config
from repro.models import layers as JL
from repro.models import lm as jax_lm
from repro_torch import config as torch_config
from repro_torch.models import layers as TL
from repro_torch.models import lm as torch_lm
from repro_torch.runtime.serving import ContinuousBatcher, Request, _reset_row

ARCH = "jamba_1_5_large_398b"
TOL = 2e-4
B, S = 2, 32
SMAX = 24


@pytest.fixture(autouse=True)
def _port_fault_free():
    from repro_torch.core import faults
    faults.reset()
    yield
    faults.reset()


def _cfgs(dtype="float32"):
    return (dataclasses.replace(jax_config.get_config(ARCH, reduced=True),
                                dtype=dtype),
            dataclasses.replace(torch_config.get_config(ARCH, reduced=True),
                                dtype=dtype))


def _t(tree):
    """numpy (nested dicts; ml_dtypes' bf16 via f32) -> torch on the CPU."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(torch.as_tensor(got).float()),
                               np.asarray(want, dtype=np.float32), rtol=tol,
                               atol=tol, err_msg=msg)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _mamba(seed=1, dtype="float32"):
    cfg, tcfg = _cfgs(dtype)
    p = JL.init_mamba(cfg, jax.random.key(seed))
    return cfg, tcfg, p, _t(jax.tree.map(np.asarray, p))


@pytest.fixture(scope="module")
def jamba():
    """The reduced Jamba in f32: the reference's parameters, the port's
    model on them, the jitted reference forward and decode step."""
    cfg, tcfg = _cfgs()
    params = jax_lm.init_params(cfg, jax.random.key(0))
    model = torch_lm.LM.from_reference(
        tcfg, jax.tree.map(np.asarray, params), device="cpu")
    fwd = jax.jit(lambda t: jax_lm.forward(cfg, params, {"tokens": t}))
    step = jax.jit(lambda c, t, p: jax_lm.decode_step(
        cfg, params, c, {"token": t, "pos": p}))
    return cfg, tcfg, params, model, fwd, step


# ---------------------------------------------------------------------------
# the Mamba layer
# ---------------------------------------------------------------------------


def test_mamba_params_keep_the_reference_layouts_and_dtypes():
    cfg, tcfg = _cfgs("bfloat16")
    want = jax.tree.map(np.asarray, JL.init_mamba(cfg, jax.random.key(0)))
    got = TL.init_mamba(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert str(got[k].dtype).removeprefix("torch.") == w.dtype.name, k
    # deterministic: equal (a_log up to an ulp of the two libraries' log)
    for k in ("a_log", "d_skip", "norm"):
        _close(got[k], want[k], tol=1e-6, msg=k)


@pytest.mark.parametrize("chunk", [4, 8, 32])
def test_mamba_forward_parity_across_chunks(chunk):
    """chunk < S carries the state and the conv tail over chunk
    boundaries."""
    cfg, tcfg, p, tp = _mamba()
    x = _rand((B, S, cfg.d_model), 2)
    want = JL.mamba_forward(cfg, p, jnp.asarray(x), chunk=chunk)
    got = TL.mamba_forward(tcfg, tp, torch.from_numpy(x), chunk=chunk)
    _close(got, want)


def test_mamba_forward_keeps_the_chunk_precondition():
    cfg, tcfg, p, tp = _mamba()
    x = torch.from_numpy(_rand((1, 12, cfg.d_model), 2))
    with pytest.raises(ValueError, match="chunk"):
        TL.mamba_forward(tcfg, tp, x, chunk=8)


def test_mamba_decode_parity_over_steps():
    """Eight decode steps from a random state and conv tail, the state
    carried by each package: every step's output and cache."""
    cfg, tcfg, p, tp = _mamba(seed=3)
    di = cfg.mamba_expand * cfg.d_model
    jc = {"h": jnp.asarray(_rand((B, di, cfg.mamba_d_state), 4, 0.5)),
          "tail": jnp.asarray(_rand((B, cfg.mamba_d_conv - 1, di), 5))}
    tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
    for t in range(8):
        x = _rand((B, 1, cfg.d_model), 10 + t)
        want, jc = JL.mamba_decode(cfg, p, jnp.asarray(x), jc)
        got, tc = TL.mamba_decode(tcfg, tp, torch.from_numpy(x), tc)
        _close(got, want, msg=f"step {t}")
        for k in ("h", "tail"):
            assert tc[k].dtype == torch.float32
            _close(tc[k], jc[k], msg=f"step {t} {k}")


def test_mamba_forward_matches_chained_decode():
    """The port's prefill (chunked scans) against its decode (one token a
    step, the state carried) on every token."""
    cfg, tcfg, p, tp = _mamba(seed=6)
    x = torch.from_numpy(_rand((B, S, cfg.d_model), 7))
    full = TL.mamba_forward(tcfg, tp, x, chunk=8)
    cache = TL.init_mamba_cache(tcfg, B, torch.float32, "cpu")
    for t in range(S):
        y, cache = TL.mamba_decode(tcfg, tp, x[:, t:t + 1], cache)
        _close(y[:, 0], full[:, t], tol=2e-3, msg=f"token {t}")


def test_mamba_bf16_layer_parity():
    cfg, tcfg, p, tp = _mamba(seed=8, dtype="bfloat16")
    x = _rand((B, S, cfg.d_model), 9)
    want = JL.mamba_forward(cfg, p, jnp.asarray(x, jnp.bfloat16), chunk=8)
    got = TL.mamba_forward(tcfg, tp, torch.from_numpy(x).to(torch.bfloat16),
                           chunk=8)
    assert got.dtype == torch.bfloat16
    _close(got, want, tol=3e-2)
    di = cfg.mamba_expand * cfg.d_model
    jc = JL.init_mamba_cache(cfg, B, jnp.bfloat16)
    tc = TL.init_mamba_cache(tcfg, B, torch.bfloat16, "cpu")
    assert {k: v.dtype for k, v in tc.items()} == \
        {"h": torch.float32, "tail": torch.bfloat16}
    assert tuple(tc["tail"].shape) == (B, cfg.mamba_d_conv - 1, di)
    for t in range(4):
        xd = x[:, t:t + 1]
        want, jc = JL.mamba_decode(cfg, p, jnp.asarray(xd, jnp.bfloat16), jc)
        got, tc = TL.mamba_decode(tcfg, tp,
                                  torch.from_numpy(xd).to(torch.bfloat16), tc)
        _close(got, want, tol=3e-2, msg=f"step {t}")
        _close(tc["h"], jc["h"], tol=3e-2, msg=f"step {t} h")


@pytest.mark.parametrize("S_", [1, 5, 64])
def test_linear_scan_equals_the_recurrence_at_strong_decays(S_):
    """The log-depth scan against the per-token recurrence, decays down to
    exp(-16 * 4): finite where the closed form through exp(-cumsum) is
    not."""
    rng = np.random.default_rng(S_)
    a = torch.from_numpy(np.exp(-16.0 * rng.uniform(0, 4, (2, S_, 3, 4)))
                         .astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, S_, 3, 4))
                         .astype(np.float32))
    got = TL._linear_scan(a, b)
    h = torch.zeros_like(b[:, 0])
    for t in range(S_):
        h = a[:, t] * h + b[:, t]
        torch.testing.assert_close(got[:, t], h, rtol=1e-6, atol=1e-6)
    assert torch.isfinite(got).all()


# ---------------------------------------------------------------------------
# the whole reduced model on carried weights
# ---------------------------------------------------------------------------


def _jax_cache_layers(cfg, cache):
    NP = jax_lm.n_periods(cfg)
    return [{k: np.asarray(v)[i]
             for k, v in cache["blocks"][f"pos{pos}"].items()}
            for i in range(NP) for pos in range(cfg.period)]


def test_layer_specs_and_caches(jamba):
    cfg, tcfg, params, model, fwd, step = jamba
    specs = torch_lm.layer_specs(tcfg)
    assert [m for m, _ in specs] == ["mamba"] * 4 + ["attn"] + ["mamba"] * 3
    assert [f for _, f in specs] == ["moe", "mlp"] * 4
    cache = torch_lm.init_cache(tcfg, B, SMAX, "cpu")
    di = tcfg.mamba_expand * tcfg.d_model
    for (mix, _), c in zip(specs, cache["blocks"]):
        want = ({"k", "v"} if mix == "attn" else {"h", "tail"})
        assert set(c) == want
        if mix == "mamba":
            assert tuple(c["h"].shape) == (B, di, tcfg.mamba_d_state)


def test_whole_model_parity(jamba):
    """forward logits, every decode step's logits and every layer's cache
    (the attention layer's k, v; each Mamba layer's h and tail)."""
    cfg, tcfg, params, model, fwd, step = jamba
    assert len(model.blocks) == cfg.n_layers
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (B, S)).astype(
        np.int32)
    with torch.inference_mode():
        got = torch_lm.forward(tcfg, model, {"tokens": tokens})
    _close(got, fwd(jnp.asarray(tokens)), msg="forward logits")
    jc = jax_lm.init_cache(cfg, B, SMAX)
    tc = torch_lm.init_cache(tcfg, B, SMAX, "cpu")
    for t in range(8):
        tok, pos = tokens[:, t:t + 1], np.full((B,), t, np.int32)
        wl, jc = step(jc, jnp.asarray(tok), jnp.asarray(pos))
        with torch.inference_mode():
            gl, tc = torch_lm.decode_step(tcfg, model, tc,
                                          {"token": tok, "pos": pos})
        _close(gl, wl, msg=f"decode logits, step {t}")
    for li, (g, w) in enumerate(zip(tc["blocks"], _jax_cache_layers(cfg, jc))):
        assert sorted(g) == sorted(w)
        for k in w:
            _close(g[k], w[k], msg=f"layer {li} cache {k}")


def test_decode_matches_prefill_last_token(jamba):
    """The port's prefill against its decode steps, the MoE's capacity
    raised so that the prefill drops no pair (a decode step, at C = 1,
    never drops one; a prefill that drops one computes something else)."""
    cfg, tcfg, params, model, fwd, step = jamba
    mc = tcfg.moe
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        mc, capacity_factor=mc.n_experts / mc.top_k * 1.01))
    assert TL.moe_capacity(tcfg, 16) >= 16
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (B, 16))
    with torch.inference_mode():
        full = torch_lm.forward(tcfg, model, {"tokens": tokens})
        cache = model.init_cache(B, 16)
        for t in range(16):
            logits, cache = torch_lm.decode_step(
                tcfg, model, cache, {"token": tokens[:, t:t + 1],
                                     "pos": np.full((B,), t, np.int32)})
    _close(logits[:, 0], full[:, -1], tol=2e-3)


def test_step_into_keeps_the_mamba_states_in_the_callers_cache(jamba):
    """``decode_step_into`` copies each Mamba layer's new h and tail into
    the caller's tensors (what a CUDA graph and the batcher hold), equal
    to ``decode_step``'s."""
    cfg, tcfg, params, model, fwd, step = jamba
    rng = np.random.default_rng(3)
    cache = model.init_cache(B, SMAX)
    with torch.inference_mode():
        for t in range(3):
            _, cache = model.decode_step(cache, {
                "token": rng.integers(2, cfg.vocab, (B, 1)),
                "pos": np.full((B,), t, np.int32)})
        batch = {"token": rng.integers(2, cfg.vocab, (B, 1)),
                 "pos": np.full((B,), 3, np.int32)}
        want_logits, want = model.decode_step(cache, batch)
        tensors = [dict(c) for c in cache["blocks"]]
        logits, same = torch_lm.decode_step_into(tcfg, model, cache, batch)
    assert same is cache
    torch.testing.assert_close(logits, want_logits, rtol=0, atol=0)
    for c, t, w in zip(cache["blocks"], tensors, want["blocks"]):
        for k in c:
            assert c[k] is t[k]
            torch.testing.assert_close(c[k], w[k], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _requests(vocab, n, prompt_len, max_new, seed):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(2, vocab, size=prompt_len),
                    max_new=max_new) for i in range(n)]


def _jax_alone(cfg, step, req, eos=1, max_len=SMAX):
    """Greedy decoding of one request by the reference from a fresh
    one-slot cache, with the batcher's stopping rule."""
    cache, out, pos = jax_lm.init_cache(cfg, 1, max_len), [], 0
    for t in req.prompt:
        logits, cache = step(cache, jnp.array([[t]], jnp.int32),
                             jnp.array([pos], jnp.int32))
        pos += 1
    while True:
        out.append(int(np.argmax(np.asarray(logits)[0, -1])))
        if len(out) >= req.max_new or out[-1] == eos or pos >= max_len - 1:
            return out
        logits, cache = step(cache, jnp.array([[out[-1]]], jnp.int32),
                             jnp.array([pos], jnp.int32))
        pos += 1


def test_batcher_gives_the_reference_tokens(jamba):
    """Two slots answer five requests, so slots are reused: every request
    gets the tokens the JAX model gives it alone (the JAX batcher carries a
    reused slot's Mamba state over, so its own ids are not the yardstick)."""
    cfg, tcfg, params, model, fwd, step = jamba
    alone = {r.rid: _jax_alone(cfg, step, r)
             for r in _requests(cfg.vocab, 5, 6, 5, seed=0)}

    def decode(cache, tokens, pos):
        with torch.inference_mode():
            return torch_lm.decode_step_into(tcfg, model, cache,
                                             {"token": tokens, "pos": pos})

    b = ContinuousBatcher(decode, lambda n: model.init_cache(n, SMAX),
                          n_slots=2, eos=1, max_len=SMAX, device="cpu")
    for r in _requests(cfg.vocab, 5, 6, 5, seed=0):
        b.submit(r)
    b.run()
    assert len(b.completed) == 5 and max(b.occupancy) == 2
    assert {r.rid: r.output for r in b.completed} == alone


def test_admission_resets_a_reused_slots_mamba_state(jamba):
    """The batcher's reset walks every cache dict: a slot's h and tail go
    back to zeros on admission, the other slot's rows stay."""
    cfg, tcfg, params, model, fwd, step = jamba
    cache = model.init_cache(2, SMAX)
    for c in cache["blocks"]:
        for t in c.values():
            t.fill_(1.0)
    _reset_row(cache, model.init_cache(1, SMAX), 0)
    for c in cache["blocks"]:
        for k, t in c.items():
            assert not t[0].any(), k
            assert bool((t[1] == 1).all()), k


def test_reused_slot_starts_from_a_fresh_state(jamba):
    """One slot answers two requests in turn; the second gets the tokens a
    fresh batcher gives it alone."""
    cfg, tcfg, params, model, fwd, step = jamba

    def decode(cache, tokens, pos):
        with torch.inference_mode():
            return model.decode_step(cache, {"token": tokens, "pos": pos})

    def answer(reqs):
        b = ContinuousBatcher(decode, lambda n: model.init_cache(n, SMAX),
                              n_slots=1, eos=1, max_len=SMAX, device="cpu")
        for r in reqs:
            b.submit(r)
        b.run()
        return b.completed[-1].output

    first, second = _requests(cfg.vocab, 2, 6, 5, seed=2)
    again = _requests(cfg.vocab, 2, 6, 5, seed=2)[1]
    assert answer([first, second]) == answer([again])
