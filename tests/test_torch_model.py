"""The port's model path against the JAX package's: configurations, batches,
every ported layer on carried weights, and the whole model (prefill logits,
decode logits and caches) for the dense and RWKV-6 families, in f32 at
reduced size.

Weights are drawn by the reference (``jax.random``), handed across as numpy
arrays (``lm.params_from_reference``); inputs are made with numpy from a
seed and go to both packages.  On the CPU the layers run K4's and K5's
plain versions.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import config as jax_config
from repro.models import api as jax_api
from repro.models import layers as JL
from repro.models import lm as jax_lm
from repro_torch import config as torch_config
from repro_torch.models import api as torch_api
from repro_torch.models import layers as TL
from repro_torch.models import lm as torch_lm

TOL = 2e-4


@pytest.fixture(autouse=True)
def _port_fault_free():
    from repro_torch.core import faults
    faults.reset()
    yield
    faults.reset()


def _cfg(arch, **kw):
    return dataclasses.replace(jax_config.get_config(arch, reduced=True),
                               dtype="float32", **kw)


def _tcfg(arch, **kw):
    return dataclasses.replace(torch_config.get_config(arch, reduced=True),
                               dtype="float32", **kw)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    """numpy (nested dicts) -> torch on the CPU."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=msg)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# configurations and batches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", jax_config.ARCH_IDS)
def test_config_parity(arch, reduced):
    a = jax_config.get_config(arch, reduced=reduced)
    b = torch_config.get_config(arch, reduced=reduced)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert b.param_count() == a.param_count()
    assert b.active_param_count() == a.active_param_count()
    assert [b.layer_kind(i) for i in range(b.n_layers)] == \
        [a.layer_kind(i) for i in range(a.n_layers)]
    assert [b.is_moe_layer(i) for i in range(b.n_layers)] == \
        [a.is_moe_layer(i) for i in range(a.n_layers)]
    assert (b.hd, b.subquadratic) == (a.hd, a.subquadratic)
    assert dataclasses.asdict(torch_config.tune(b)) == \
        dataclasses.asdict(jax_config.tune(a))


def test_cells_and_shapes_parity():
    assert list(torch_config.all_cells()) == list(jax_config.all_cells())
    assert {k: dataclasses.asdict(v) for k, v in torch_config.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jax_config.SHAPES.items()}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["llama3_8b", "rwkv6_3b"])
def test_make_batch_equal(arch, kind):
    shape_j = jax_config.ShapeConfig("t", kind, 32, 3)
    shape_t = torch_config.ShapeConfig("t", kind, 32, 3)
    a = jax_api.make_batch(jax_config.get_config(arch, reduced=True), shape_j,
                           seed=5)
    b = torch_api.make_batch(torch_config.get_config(arch, reduced=True),
                             shape_t, seed=5, device="cpu")
    assert sorted(a) == sorted(b)
    for k in a:
        assert b[k].device.type == "cpu"
        assert str(b[k].dtype).removeprefix("torch.") == str(a[k].dtype)
        np.testing.assert_array_equal(b[k].numpy(), np.asarray(a[k]))


@pytest.mark.parametrize("arch", torch_config.ARCH_IDS)
def test_every_family_inits_forwards_and_decodes(arch):
    """Every configuration, reduced, on the CPU: ``LM.init``, one forward
    (with frames for encdec, patches for vlm) and one decode step give
    finite logits of the right shape (text positions only for vlm)."""
    cfg = torch_config.get_config(arch, reduced=True)
    model = torch_lm.LM.init(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (B, S))
    batch, extra = {"tokens": tokens}, {}
    if cfg.family == "encdec":
        extra["frames"] = rng.standard_normal((B, cfg.enc_seq, cfg.d_model))
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (B, cfg.n_img_tokens, cfg.d_model))
    with torch.inference_mode():
        logits = model({**batch, **extra})
        step, _ = model.decode_step(model.init_cache(B, S), {
            "token": tokens[:, :1], "pos": np.zeros((B,), np.int32),
            **extra})
    assert tuple(logits.shape) == (B, S, cfg.vocab)
    assert tuple(step.shape) == (B, 1, cfg.vocab)
    assert torch.isfinite(logits).all() and torch.isfinite(step).all()


@pytest.mark.parametrize("arch", ["deepseek_v2_236b", "kimi_k2_1t_a32b"])
def test_moe_families_init_and_count(arch):
    """The MoE family initialises on the CPU: one block per layer, the
    dense prefix first; its parameters but the norm vectors are
    ``cfg.param_count()``, and all of them the reference's leaves."""
    cfg = torch_config.get_config(arch, reduced=True)
    model = torch_lm.LM.init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert len(model.blocks) == cfg.n_layers
    assert "router" not in model.blocks[0]["ffn"]
    assert all("shared" in b["ffn"] for b in model.blocks[1:])
    named = dict(model.named_parameters())
    assert sum(t.numel() for n, t in named.items()
               if not n.endswith("norm")) == cfg.param_count()
    ref = jax_lm.init_params(jax_config.get_config(arch, reduced=True),
                             jax.random.key(0))
    assert sum(t.numel() for t in named.values()) == \
        sum(x.size for x in jax.tree.leaves(ref))
    assert all((t.dtype == torch.float32) == n.endswith("router")
               for n, t in named.items())


# ---------------------------------------------------------------------------
# layers on carried weights
# ---------------------------------------------------------------------------

B, S = 2, 16


@pytest.mark.parametrize("impl,causal", [("dense", True), ("dense", False),
                                         ("chunked", True)])
def test_attn_forward_parity(impl, causal):
    cfg = _cfg("llama3_8b", attn_impl=impl, attn_chunk=8)
    tcfg = _tcfg("llama3_8b", attn_impl=impl, attn_chunk=8)
    p = _np(JL.init_attn(cfg, jax.random.key(1)))
    x = _rand((B, S, cfg.d_model), 2)
    pos = np.broadcast_to(np.arange(S), (B, S))
    want = JL.attn_forward(cfg, p, jnp.asarray(x), jnp.asarray(pos), causal)
    got = TL.attn_forward(tcfg, _t(p), torch.from_numpy(x),
                          torch.from_numpy(pos.copy()), causal)
    _close(got, want)


def test_chunked_attention_keeps_the_reference_preconditions():
    tcfg = _tcfg("llama3_8b", attn_impl="chunked", attn_chunk=12)
    p = _t(_np(JL.init_attn(_cfg("llama3_8b"), jax.random.key(1))))
    x = torch.from_numpy(_rand((B, S, tcfg.d_model), 2))
    pos = torch.arange(S).expand(B, S)
    with pytest.raises(ValueError, match="attn_chunk"):
        TL.attn_forward(tcfg, p, x, pos)
    tcfg = dataclasses.replace(tcfg, attn_chunk=8)
    with pytest.raises(ValueError, match="positions"):
        TL.attn_forward(tcfg, p, x, pos + 1)


@pytest.mark.parametrize("impl", ["dense", "chunked"])
def test_attn_forward_takes_none_for_arange_positions(impl):
    tcfg = _tcfg("llama3_8b", attn_impl=impl, attn_chunk=8)
    p = _t(_np(JL.init_attn(_cfg("llama3_8b"), jax.random.key(1))))
    x = torch.from_numpy(_rand((B, S, tcfg.d_model), 2))
    want = TL.attn_forward(tcfg, p, x, torch.arange(S).expand(B, S))
    torch.testing.assert_close(TL.attn_forward(tcfg, p, x, None), want,
                               rtol=0, atol=0)


def test_prefill_compares_no_positions(monkeypatch):
    """``lm.forward`` hands the layers their arange positions as None, so
    the chunked attention makes no device comparison (on the card, a sync
    per layer)."""
    tcfg = _tcfg("llama3_8b", attn_impl="chunked", attn_chunk=8)
    model = torch_lm.LM.init(tcfg, torch.Generator().manual_seed(0), "cpu")

    def compared(positions):
        raise AssertionError("the positions were compared with an arange")
    monkeypatch.setattr(TL, "_is_arange", compared)
    tokens = np.random.default_rng(1).integers(0, tcfg.vocab, (B, S))
    with torch.inference_mode():
        logits = torch_lm.forward(tcfg, model, {"tokens": tokens})
    assert logits.shape == (B, S, tcfg.vocab)
    assert torch.isfinite(logits).all()


def test_attn_decode_parity():
    cfg, tcfg = _cfg("llama3_8b"), _tcfg("llama3_8b")
    p = _np(JL.init_attn(cfg, jax.random.key(3)))
    Smax, K, hd = 12, cfg.n_kv_heads, cfg.hd
    cache = {"k": _rand((B, Smax, K, hd), 4), "v": _rand((B, Smax, K, hd), 5)}
    x = _rand((B, 1, cfg.d_model), 6)
    pos = np.array([3, 9], np.int32)
    want, wc = JL.attn_decode(cfg, p, jnp.asarray(x),
                              {k: jnp.asarray(v) for k, v in cache.items()},
                              jnp.asarray(pos))
    got, gc = TL.attn_decode(tcfg, _t(p), torch.from_numpy(x), _t(cache),
                             torch.from_numpy(pos))
    _close(got, want)
    for k in ("k", "v"):
        _close(gc[k], wc[k], msg=k)


@pytest.mark.parametrize("arch", ["llama3_8b", "gemma_7b", "whisper_small"])
def test_mlp_forward_parity(arch):
    """swiglu, geglu and gelu."""
    cfg, tcfg = _cfg(arch), _tcfg(arch)
    p = _np(JL.init_mlp(cfg, jax.random.key(7)))
    x = _rand((B, S, cfg.d_model), 8)
    want = JL.mlp_forward(cfg, p, jnp.asarray(x))
    got = TL.mlp_forward(tcfg, _t(p), torch.from_numpy(x))
    _close(got, want)


def _rwkv_setup(seed=9):
    cfg, tcfg = _cfg("rwkv6_3b"), _tcfg("rwkv6_3b")
    p = _np(JL.init_rwkv(cfg, jax.random.key(seed)))
    H, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    return cfg, tcfg, p, H, hd


def test_rwkv_time_mix_parity_with_state():
    cfg, tcfg, p, H, hd = _rwkv_setup()
    x = _rand((B, S, cfg.d_model), 10)
    last = _rand((B, 1, cfg.d_model), 11)
    s0 = _rand((B, H, hd, hd), 12, 0.5)
    want = JL.rwkv_time_mix(cfg, p, *map(jnp.asarray, (x, last, s0)))
    got = TL.rwkv_time_mix(tcfg, _t(p), *map(torch.from_numpy, (x, last, s0)))
    for g, w, what in zip(got, want, ("y", "shift", "state")):
        _close(g, w, msg=what)


def test_rwkv_time_mix_keeps_the_chunk_precondition():
    cfg, tcfg, p, H, hd = _rwkv_setup()
    x = torch.from_numpy(_rand((1, 160, cfg.d_model), 10))
    with pytest.raises(ValueError, match="chunk"):
        TL.rwkv_time_mix(tcfg, _t(p), x, torch.zeros(1, 1, cfg.d_model), None)


def test_rwkv_channel_mix_parity():
    cfg, tcfg, p, H, hd = _rwkv_setup()
    x = _rand((B, S, cfg.d_model), 13)
    last = _rand((B, 1, cfg.d_model), 14)
    want = JL.rwkv_channel_mix(cfg, p, jnp.asarray(x), jnp.asarray(last))
    got = TL.rwkv_channel_mix(tcfg, _t(p), torch.from_numpy(x),
                              torch.from_numpy(last))
    for g, w in zip(got, want):
        _close(g, w)


def test_rwkv_forward_and_decode_parity():
    cfg, tcfg, p, H, hd = _rwkv_setup()
    x = _rand((B, S, cfg.d_model), 15)
    _close(TL.rwkv_forward(tcfg, _t(p), torch.from_numpy(x)),
           JL.rwkv_forward(cfg, p, jnp.asarray(x)))
    cache = {"shift_a": _rand((B, 1, cfg.d_model), 16),
             "shift_f": _rand((B, 1, cfg.d_model), 17),
             "s": _rand((B, H, hd, hd), 18, 0.5)}
    xd = _rand((B, 1, cfg.d_model), 19)
    want, wc = JL.rwkv_decode(cfg, p, jnp.asarray(xd),
                              {k: jnp.asarray(v) for k, v in cache.items()})
    got, gc = TL.rwkv_decode(tcfg, _t(p), torch.from_numpy(xd), _t(cache))
    _close(got, want)
    for k in cache:
        _close(gc[k], wc[k], msg=k)


def test_rwkv_decode_in_place_parity():
    """The in-place decode (the WKV state written over the cache's own
    tensor, as the decode graph runs it) against the JAX layer."""
    cfg, tcfg, p, H, hd = _rwkv_setup(seed=23)
    cache = {"shift_a": _rand((B, 1, cfg.d_model), 24),
             "shift_f": _rand((B, 1, cfg.d_model), 25),
             "s": _rand((B, H, hd, hd), 26, 0.5)}
    xd = _rand((B, 1, cfg.d_model), 27)
    want, wc = JL.rwkv_decode(cfg, p, jnp.asarray(xd),
                              {k: jnp.asarray(v) for k, v in cache.items()})
    tc = _t(cache)
    s = tc["s"]
    got, gc = TL.rwkv_decode(tcfg, _t(p), torch.from_numpy(xd), tc,
                             in_place=True)
    assert gc["s"] is s
    _close(got, want)
    for k in cache:
        _close(gc[k], wc[k], msg=k)


def test_rms_norm_and_rope_parity():
    x = _rand((B, S, 4, 16), 20, 3.0)
    w = _rand((16,), 21)
    _close(TL.rms_norm(torch.from_numpy(x), torch.from_numpy(w)),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(w)))
    pos = np.broadcast_to(np.arange(5, 5 + S), (B, S))
    _close(TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                         10000.0),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))


# ---------------------------------------------------------------------------
# the whole model on carried weights
# ---------------------------------------------------------------------------


def _jax_cache_layers(cfg, cache):
    """The reference's stacked cache as one dict per layer."""
    NP = jax_lm.n_periods(cfg)
    out = []
    for i in range(NP):
        for pos in range(cfg.period):
            out.append({k: np.asarray(v)[i]
                        for k, v in cache["blocks"][f"pos{pos}"].items()})
    return out


@pytest.mark.parametrize("arch,impl", [("llama3_8b", "dense"),
                                       ("llama3_8b", "chunked"),
                                       ("rwkv6_3b", "dense")])
def test_whole_model_parity(arch, impl):
    cfg = _cfg(arch, attn_impl=impl, attn_chunk=8)
    tcfg = _tcfg(arch, attn_impl=impl, attn_chunk=8)
    params = jax_lm.init_params(cfg, jax.random.key(0))
    model = torch_lm.LM.from_reference(tcfg, _np(params), device="cpu")
    assert len(model.blocks) == cfg.n_layers
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (B, S)).astype(
        np.int32)
    want = jax_lm.forward(cfg, params, {"tokens": jnp.asarray(tokens)})
    with torch.inference_mode():
        got = torch_lm.forward(tcfg, model, {"tokens": tokens})
    _close(got, want, msg="forward logits")

    n_steps, Smax = 6, 8
    jc = jax_lm.init_cache(cfg, B, Smax)
    tc = torch_lm.init_cache(tcfg, B, Smax, "cpu")
    for t in range(n_steps):
        batch = {"token": tokens[:, t:t + 1],
                 "pos": np.full((B,), t, np.int32)}
        wl, jc = jax_lm.decode_step(cfg, params, jc,
                                    {k: jnp.asarray(v)
                                     for k, v in batch.items()})
        with torch.inference_mode():
            gl, tc = torch_lm.decode_step(tcfg, model, tc, batch)
        _close(gl, wl, msg=f"decode logits, step {t}")
    for li, (g, w) in enumerate(zip(tc["blocks"], _jax_cache_layers(cfg, jc))):
        assert sorted(g) == sorted(w)
        for k in w:
            _close(g[k], w[k], msg=f"layer {li} cache {k}")


@pytest.mark.parametrize("arch,impl", [("llama3_8b", "chunked"),
                                       ("rwkv6_3b", "dense")])
def test_decode_matches_prefill_last_token(arch, impl):
    """The port's own prefill (K4 / K5 long form) against its decode steps
    (einsum attention over the cache / K5 at S=1), as the reference's
    test_decode_matches_prefill_last_token does."""
    tcfg = _tcfg(arch, attn_impl=impl, attn_chunk=8)
    model = torch_lm.LM.init(tcfg, torch.Generator().manual_seed(1), "cpu")
    tokens = np.random.default_rng(2).integers(0, tcfg.vocab, (B, S))
    with torch.inference_mode():
        full = model({"tokens": tokens})
        cache = model.init_cache(B, S)
        for t in range(S):
            logits, cache = model.decode_step(
                cache, {"token": tokens[:, t:t + 1],
                        "pos": np.full((B,), t, np.int32)})
    _close(logits[:, 0], full[:, -1], tol=2e-3)


def test_init_places_parameters_and_counts_them():
    tcfg = torch_config.get_config("llama3_8b", reduced=True)
    model = torch_lm.LM.init(tcfg, torch.Generator().manual_seed(0), "cpu")
    n = sum(p.numel() for p in model.parameters())
    ref = jax_lm.init_params(jax_config.get_config("llama3_8b", reduced=True),
                             jax.random.key(0))
    assert n == sum(x.size for x in jax.tree.leaves(ref))
    assert all(p.dtype == torch.bfloat16 and not p.requires_grad
               for p in model.parameters())


@pytest.mark.parametrize("impl", ["chunked", "dense"])
def test_gemma_family_at_head_dim_256_parity(impl):
    """A narrow config of gemma-7b's family (GeGLU, tied embeddings) at its
    head dim, 256: forward logits (chunked: K4 f32 on the tf32x3 route's
    64 x 16 tiles) and decode logits and caches against the JAX model on
    carried weights."""
    cfg = _cfg("gemma_7b", head_dim=256, attn_impl=impl, attn_chunk=8)
    tcfg = _tcfg("gemma_7b", head_dim=256, attn_impl=impl, attn_chunk=8)
    assert (tcfg.act, tcfg.hd, tcfg.tie_embeddings) == ("geglu", 256, True)
    params = jax_lm.init_params(cfg, jax.random.key(4))
    model = torch_lm.LM.from_reference(tcfg, _np(params), device="cpu")
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (B, S)).astype(
        np.int32)
    want = jax_lm.forward(cfg, params, {"tokens": jnp.asarray(tokens)})
    with torch.inference_mode():
        got = torch_lm.forward(tcfg, model, {"tokens": tokens})
    _close(got, want, msg="forward logits")
    jc = jax_lm.init_cache(cfg, B, S)
    tc = torch_lm.init_cache(tcfg, B, S, "cpu")
    for t in range(S):
        batch = {"token": tokens[:, t:t + 1],
                 "pos": np.full((B,), t, np.int32)}
        wl, jc = jax_lm.decode_step(cfg, params, jc,
                                    {k: jnp.asarray(v)
                                     for k, v in batch.items()})
        with torch.inference_mode():
            gl, tc = torch_lm.decode_step(tcfg, model, tc, batch)
        _close(gl, wl, msg=f"decode logits, step {t}")
    _close(gl[:, 0], got[:, -1], tol=2e-3, msg="decode == prefill")
    for li, (g, w) in enumerate(zip(tc["blocks"], _jax_cache_layers(cfg, jc))):
        for k in w:
            _close(g[k], w[k], msg=f"layer {li} cache {k}")
