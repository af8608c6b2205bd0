"""The port's encoder-decoder (Whisper) and VLM (PaliGemma) families against
the JAX package's, on the reduced configurations in f32: the encoder and
cross attention, Whisper's forward with frames and its decode step by step
(logits and caches), greedy decoding with frames, PaliGemma's forward with
patches, the counterparts of ``tests/test_encdec_vlm.py``'s checks, and
``serve.main`` on the CPU for both.

Weights are drawn by the reference (``jax.random``) and handed across as
numpy arrays; inputs are made with numpy from a seed.
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
from repro_torch.launch import serve
from repro_torch.models import layers as TL
from repro_torch.models import lm as torch_lm

TOL = 2e-4
B, S = 2, 16


@pytest.fixture(autouse=True)
def _port_fault_free():
    from repro_torch.core import faults
    faults.reset()
    yield
    faults.reset()


def _cfgs(arch, **kw):
    return (dataclasses.replace(jax_config.get_config(arch, reduced=True),
                                dtype="float32", **kw),
            dataclasses.replace(torch_config.get_config(arch, reduced=True),
                                dtype="float32", **kw))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=msg)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _models(arch, seed=0, **kw):
    cfg, tcfg = _cfgs(arch, **kw)
    params = jax_lm.init_params(cfg, jax.random.key(seed))
    model = torch_lm.LM.from_reference(tcfg, _np(params), device="cpu")
    return cfg, tcfg, params, model


def _frames(cfg, seed, n=B):
    return _rand((n, cfg.enc_seq, cfg.d_model), seed)


# ---------------------------------------------------------------------------
# the encoder and cross attention
# ---------------------------------------------------------------------------


def test_encoder_parameters_are_carried_across():
    cfg, tcfg, params, model = _models("whisper_small")
    assert len(model.encoder) == cfg.n_enc_layers
    assert all(set(b) == {"mix", "ffn", "cross"} for b in model.blocks)
    for i, layer in enumerate(model.encoder):
        for part in ("mix", "ffn"):
            for k, t in layer[part].items():
                _close(t.detach(), np.asarray(params["encoder"][part][k])[i],
                       tol=0, msg=f"encoder {i} {part} {k}")
    assert sum(p.numel() for p in model.parameters()) == \
        sum(x.size for x in jax.tree.leaves(params))


def test_encode_parity():
    cfg, tcfg, params, model = _models("whisper_small", seed=1)
    frames = _frames(cfg, 2)
    want = jax_lm.encode(cfg, params, jnp.asarray(frames))
    with torch.inference_mode():
        got = torch_lm.encode(tcfg, model, frames)
    assert tuple(got.shape) == (B, cfg.enc_seq, cfg.d_model)
    _close(got, want)


def test_cross_attn_forward_parity():
    cfg, tcfg = _cfgs("whisper_small")
    p = _np(JL.init_cross_attn(cfg, jax.random.key(3)))
    x = _rand((B, S, cfg.d_model), 4)
    enc = _rand((B, cfg.enc_seq, cfg.d_model), 5)
    want = JL.cross_attn_forward(cfg, p, jnp.asarray(x), jnp.asarray(enc))
    got = TL.cross_attn_forward(tcfg, _t(p), torch.from_numpy(x),
                                torch.from_numpy(enc))
    _close(got, want)


# ---------------------------------------------------------------------------
# Whisper: forward and decode with frames
# ---------------------------------------------------------------------------


def _jax_cache_layers(cfg, cache):
    return [{k: np.asarray(v)[i]
             for k, v in cache["blocks"][f"pos{pos}"].items()}
            for i in range(jax_lm.n_periods(cfg)) for pos in range(cfg.period)]


@pytest.mark.parametrize("impl", ["dense", "chunked"])
def test_whisper_forward_and_decode_parity(impl):
    cfg, tcfg, params, model = _models("whisper_small", seed=6,
                                       attn_impl=impl, attn_chunk=8)
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    frames = _frames(cfg, 8)
    want = jax_lm.forward(cfg, params, {"tokens": jnp.asarray(tokens),
                                        "frames": jnp.asarray(frames)})
    with torch.inference_mode():
        got = torch_lm.forward(tcfg, model, {"tokens": tokens,
                                             "frames": frames})
    _close(got, want, msg="forward logits")
    jc = jax_lm.init_cache(cfg, B, S)
    tc = torch_lm.init_cache(tcfg, B, S, "cpu")
    for t in range(6):
        batch = {"token": tokens[:, t:t + 1],
                 "pos": np.full((B,), t, np.int32), "frames": frames}
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


def test_whisper_decode_matches_teacher_forcing():
    """The reference's own check, on the port: the last decode step's
    logits (frames encoded at every step) against the prefill's."""
    tcfg = dataclasses.replace(torch_config.get_config("whisper_small",
                                                       reduced=True),
                               dtype="float32", attn_impl="chunked")
    model = torch_lm.LM.init(tcfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, tcfg.vocab, (B, 6))
    frames = rng.normal(size=(B, tcfg.enc_seq, tcfg.d_model)).astype(
        np.float32)
    with torch.inference_mode():
        full = model({"tokens": tokens, "frames": frames})
        cache = model.init_cache(B, 6)
        for t in range(6):
            logits, cache = model.decode_step(cache, {
                "token": tokens[:, t:t + 1],
                "pos": np.full((B,), t, np.int32), "frames": frames})
    _close(logits[:, 0], full[:, -1], tol=2e-3)


def test_whisper_greedy_decode_gives_the_reference_ids():
    """On carried weights, the port's greedy decoding with frames (the
    prompt fed token by token through ``serve.prefill_into_cache``, then
    each argmax fed back) gives the JAX ``decode_step``'s token ids."""
    cfg, tcfg, params, model = _models("whisper_small", seed=9)
    rng = np.random.default_rng(10)
    P, G = 5, 6
    prompts = rng.integers(2, cfg.vocab, (B, P)).astype(np.int32)
    frames = _frames(cfg, 11)

    step = jax.jit(lambda c, t, p: jax_lm.decode_step(
        cfg, params, c, {"token": t, "pos": p,
                         "frames": jnp.asarray(frames)}))
    jc = jax_lm.init_cache(cfg, B, P + G)
    for t in range(P):
        logits, jc = step(jc, jnp.asarray(prompts[:, t:t + 1]),
                          jnp.full((B,), t, jnp.int32))
    want = []
    for i in range(G):
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
        want.append(np.asarray(tok[:, 0]))
        logits, jc = step(jc, tok, jnp.full((B,), P + i, jnp.int32))

    extra = {"frames": torch.from_numpy(frames)}
    eager = serve._eager_step(tcfg, model, extra)
    with torch.inference_mode():
        tc, logits = serve.prefill_into_cache(
            tcfg, model, torch.from_numpy(prompts),
            model.init_cache(B, P + G), eager)
        got = []
        for i in range(G):
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
            got.append(tok[:, 0].numpy())
            logits, tc = eager(tc, tok, torch.full((B,), P + i,
                                                   dtype=torch.int32))
    np.testing.assert_array_equal(np.stack(got, 1), np.stack(want, 1))


def test_whisper_encoder_is_used():
    tcfg = dataclasses.replace(torch_config.get_config("whisper_small",
                                                       reduced=True),
                               dtype="float32")
    model = torch_lm.LM.init(tcfg, torch.Generator().manual_seed(1), "cpu")
    tokens = np.zeros((1, 4), np.int64)
    f1 = torch.zeros((1, tcfg.enc_seq, tcfg.d_model))
    with torch.inference_mode():
        l1 = model({"tokens": tokens, "frames": f1})
        l2 = model({"tokens": tokens, "frames": torch.ones_like(f1)})
    assert float((l1 - l2).abs().max()) > 1e-6


# ---------------------------------------------------------------------------
# PaliGemma: the image-patch prefix
# ---------------------------------------------------------------------------


def test_vlm_patches_shift_text_logits():
    tcfg = dataclasses.replace(torch_config.get_config("paligemma_3b",
                                                       reduced=True),
                               dtype="float32")
    model = torch_lm.LM.init(tcfg, torch.Generator().manual_seed(2), "cpu")
    n_txt = 8
    tokens = np.zeros((1, n_txt), np.int64)
    p1 = torch.zeros((1, tcfg.n_img_tokens, tcfg.d_model))
    with torch.inference_mode():
        l1 = model({"tokens": tokens, "patches": p1})
        l2 = model({"tokens": tokens, "patches": torch.ones_like(p1)})
    assert tuple(l1.shape) == (1, n_txt, tcfg.vocab)  # text positions only
    assert float((l1 - l2).abs().max()) > 1e-6


@pytest.mark.parametrize("ref_impl", ["dense", "chunked"])
def test_paligemma_forward_parity(ref_impl):
    """The port's chunked path (K4's plain version on the CPU, over the
    joined patch + text sequence, MQA at one kv head) against the
    reference's dense and chunked paths, text logits only; then decode
    steps (text only, as in the reference) and their caches."""
    cfg, tcfg, params, model = _models("paligemma_3b", seed=3,
                                       attn_impl="chunked", attn_chunk=8)
    cfg = dataclasses.replace(cfg, attn_impl=ref_impl)
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    patches = _rand((B, cfg.n_img_tokens, cfg.d_model), 5)
    want = jax_lm.forward(cfg, params, {"tokens": jnp.asarray(tokens),
                                        "patches": jnp.asarray(patches)})
    with torch.inference_mode():
        got = torch_lm.forward(tcfg, model, {"tokens": tokens,
                                             "patches": patches})
    assert tuple(got.shape) == (B, S, cfg.vocab)
    _close(got, want, msg="forward logits")
    jc = jax_lm.init_cache(cfg, B, S)
    tc = torch_lm.init_cache(tcfg, B, S, "cpu")
    for t in range(4):
        batch = {"token": tokens[:, t:t + 1],
                 "pos": np.full((B,), t, np.int32)}
        wl, jc = jax_lm.decode_step(cfg, params, jc,
                                    {k: jnp.asarray(v)
                                     for k, v in batch.items()})
        with torch.inference_mode():
            gl, tc = torch_lm.decode_step(tcfg, model, tc, batch)
        _close(gl, wl, msg=f"decode logits, step {t}")
    for li, (g, w) in enumerate(zip(tc["blocks"], _jax_cache_layers(cfg, jc))):
        for k in w:
            _close(g[k], w[k], msg=f"layer {li} cache {k}")


def test_img_proj_is_carried_across():
    cfg, tcfg, params, model = _models("paligemma_3b", seed=6)
    _close(model.img_proj.detach(), np.asarray(params["img_proj"]), tol=0)
    assert model.lm_head is None and len(model.encoder) == 0


# ---------------------------------------------------------------------------
# serve.main
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["whisper_small", "paligemma_3b"])
def test_serve_main_runs_on_the_cpu(arch, capsys):
    gen = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--gen", "4"])
    assert gen.shape == (2, 4)
    assert ((gen >= 0) & (gen < torch_config.get_config(
        arch, reduced=True).vocab)).all()
    out = capsys.readouterr().out
    assert "[serve] prefill 8 tokens" in out and "tok/s" in out


def test_serve_draws_frames_after_the_prompts_as_the_reference():
    """``serve.draw_inputs`` takes the prompts and then the frames from one
    ``default_rng(seed)``, in the reference's order
    (``repro.launch.serve.main``): equal prompts, and frames equal to the
    reference's up to the rounding of one cast to bf16."""
    cfg = jax_config.get_config("whisper_small", reduced=True)
    tcfg = torch_config.get_config("whisper_small", reduced=True)
    rng = np.random.default_rng(3)
    prompts = rng.integers(2, cfg.vocab, (2, 8))
    frames = jnp.asarray(rng.normal(size=(2, cfg.enc_seq, cfg.d_model)),
                         cfg.dtype)
    got, extra = serve.draw_inputs(tcfg, 2, 8, 3, "cpu")
    np.testing.assert_array_equal(got.numpy(), prompts)
    assert sorted(extra) == ["frames"]
    assert extra["frames"].dtype == torch.bfloat16
    np.testing.assert_allclose(extra["frames"].float().numpy(),
                               np.asarray(frames, np.float32), rtol=2 ** -8,
                               atol=0)
    assert serve.draw_inputs(torch_config.get_config(
        "paligemma_3b", reduced=True), 2, 8, 3, "cpu")[1] == {}
