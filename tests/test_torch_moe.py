"""The port's MoE family against the JAX package's: the capacity-routed MoE
(routing, capacity drops, dispatch tables and output), DeepSeek-V2's MLA
(prefill and decode, the compressed cache written in place) and the whole
model (the dense prefix layer first) for ``deepseek_v2_236b`` and
``kimi_k2_1t_a32b``, on the reference's ``reduced()`` configs in f32 at the
JAX MoE oracle's tolerance (2e-4), and in bf16 at 3e-2.

Weights are drawn by the reference (``jax.random``) and handed across as
numpy arrays; inputs are made with numpy from a seed.  Expert ids and the
kept pairs are compared exactly: the ids against the reference's own top-k
of its gates, the ranks, kept pairs and slot tables against a numpy loop
that counts each expert's pairs in (token, k) order.
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

TOL = 2e-4          # tests/test_moe_oracle.py's
BF16_TOL = 3e-2
MOE_ARCHS = ["deepseek_v2_236b", "kimi_k2_1t_a32b"]


@pytest.fixture(autouse=True)
def _port_fault_free():
    from repro_torch.core import faults
    faults.reset()
    yield
    faults.reset()


def _cfgs(arch, dtype="float32", **kw):
    """(the reference's config, the port's), reduced, in ``dtype``."""
    return tuple(dataclasses.replace(c.get_config(arch, reduced=True),
                                     dtype=dtype, **kw)
                 for c in (jax_config, torch_config))


def _with_capacity(cfg, cf):
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    """numpy (nested dicts) -> torch on the CPU."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=msg)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def dispatch_oracle(gidx, E, C):
    """(posc, keep, src, vld) of expert ids ``gidx`` (G, Tg, K), by a loop
    that hands each (t, k) the next slot of its expert, in (t, k) order,
    and drops it once the expert's C slots are taken."""
    G, Tg, K = gidx.shape
    posc = np.zeros((G, Tg, K), np.int64)
    src = np.zeros((G, E * C), np.int64)
    vld = np.zeros((G, E * C), np.float32)
    for g in range(G):
        count = np.zeros(E, np.int64)
        for t in range(Tg):
            for k in range(K):
                e = gidx[g, t, k]
                posc[g, t, k] = count[e]
                if count[e] < C:
                    src[g, e * C + count[e]] = t
                    vld[g, e * C + count[e]] = 1.0
                count[e] += 1
    return posc, posc < C, src, vld


def _jax_expert_ids(cfg, p, x):
    """The reference's router on x: its gates' top-k ids and weights."""
    h = JL.rms_norm(jnp.asarray(x), p["norm"], cfg.norm_eps)
    gates = jax.nn.softmax(h.astype(jnp.float32) @ p["router"], axis=-1)
    gval, gidx = jax.lax.top_k(gates, cfg.moe.top_k)
    gval = gval / (jnp.sum(gval, axis=-1, keepdims=True) + 1e-9)
    return np.asarray(gval), np.asarray(gidx)


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

B, S = 2, 64        # C = int(64 * 2 * 1.25 / 8) = 20 slots, 16 pairs a mean


@pytest.mark.parametrize("drops", [True, False])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_parity(arch, drops):
    """Routing exactly (expert ids, ranks, kept pairs, slot tables) and the
    output within 2e-4; with the published capacity factor some pairs are
    dropped, with a raised one (C >= S) none."""
    cfg, tcfg = _cfgs(arch)
    if not drops:
        E, K = cfg.moe.n_experts, cfg.moe.top_k
        cfg, tcfg = (_with_capacity(c, E / K + 0.5) for c in (cfg, tcfg))
    C = TL.moe_capacity(tcfg, S)
    assert C == max(1, int(S * cfg.moe.top_k * cfg.moe.capacity_factor
                           / cfg.moe.n_experts))
    assert (C >= S) == (not drops)
    p = _np(JL.init_moe(cfg, jax.random.key(11)))
    x = _rand((B, S, cfg.d_model), 12)
    want = JL.moe_forward(cfg, p, jnp.asarray(x))
    tp, tx = _t(p), torch.from_numpy(x)
    got = TL.moe_forward(tcfg, tp, tx)
    _close(got, want, msg="moe output")

    r = TL.moe_route(tcfg, tp, TL.rms_norm(tx, tp["norm"], tcfg.norm_eps))
    gval, gidx = _jax_expert_ids(cfg, p, x)
    np.testing.assert_array_equal(r["gidx"].numpy(), gidx)
    _close(r["gval"], gval, msg="gates")
    posc, keep, src, vld = dispatch_oracle(gidx, cfg.moe.n_experts, C)
    assert r["C"] == C
    np.testing.assert_array_equal(r["posc"].numpy(), posc)
    np.testing.assert_array_equal(r["keep"].numpy(), keep)
    np.testing.assert_array_equal(r["src"].numpy(), src)
    np.testing.assert_array_equal(r["vld"].numpy(), vld)
    np.testing.assert_array_equal(
        r["slot"].numpy(), gidx * C + posc)
    assert (not keep.all()) == drops


def test_moe_without_shared_experts_adds_the_residual():
    cfg, tcfg = (dataclasses.replace(
        c, moe=dataclasses.replace(c.moe, n_shared=0))
        for c in _cfgs("deepseek_v2_236b"))
    p = _np(JL.init_moe(cfg, jax.random.key(13)))
    assert "shared" not in p
    x = _rand((B, 16, cfg.d_model), 14)
    _close(TL.moe_forward(tcfg, _t(p), torch.from_numpy(x)),
           JL.moe_forward(cfg, p, jnp.asarray(x)))


def test_moe_dispatch_shapes_do_not_depend_on_the_data():
    """The tables a CUDA graph captures have fixed shapes: two inputs,
    one routing every token to the same experts, give the same shapes."""
    _, tcfg = _cfgs("kimi_k2_1t_a32b")
    p = _t(_np(JL.init_moe(_cfgs("kimi_k2_1t_a32b")[0], jax.random.key(15))))
    x = torch.from_numpy(_rand((B, 32, tcfg.d_model), 16))
    same = x[:, :1].expand_as(x).contiguous()
    r1, r2 = (TL.moe_route(tcfg, p, TL.rms_norm(v, p["norm"])) for v in
              (x, same))
    for k in ("gidx", "posc", "keep", "slot", "src", "vld"):
        assert r1[k].shape == r2[k].shape, k
    C = r2["C"]
    assert r2["keep"].sum().item() == tcfg.moe.top_k * C * B  # C per expert


def test_moe_route_takes_given_expert_ids():
    """``moe_route(..., gidx=)`` routes to the given experts: its own top-k
    fed back gives the same tables bitwise; another routing (each token's
    experts shifted by one) reads the gates there and builds its tables
    as the dispatch oracle does."""
    cfg, tcfg = _cfgs("deepseek_v2_236b")
    p = _t(_np(JL.init_moe(cfg, jax.random.key(17))))
    h = TL.rms_norm(torch.from_numpy(_rand((B, 32, tcfg.d_model), 18)),
                    p["norm"], tcfg.norm_eps)
    own = TL.moe_route(tcfg, p, h)
    fed = TL.moe_route(tcfg, p, h, gidx=own["gidx"])
    for k in ("logits", "gval", "gidx", "posc", "keep", "slot", "src",
              "vld"):
        assert torch.equal(own[k], fed[k]), k
    E = tcfg.moe.n_experts
    other = (own["gidx"] + 1) % E
    r = TL.moe_route(tcfg, p, h, gidx=other)
    gates = torch.softmax(own["logits"], dim=-1).gather(-1, other)
    _close(r["gval"], (gates / (gates.sum(-1, keepdim=True) + 1e-9)).numpy(),
           msg="gates")
    posc, keep, src, vld = dispatch_oracle(other.numpy(), E, r["C"])
    np.testing.assert_array_equal(r["posc"].numpy(), posc)
    np.testing.assert_array_equal(r["keep"].numpy(), keep)
    np.testing.assert_array_equal(r["src"].numpy(), src)
    np.testing.assert_array_equal(r["vld"].numpy(), vld)


def test_normal_draws_large_tensors_in_slices(monkeypatch):
    """Above ``_DRAW_ELEMS`` the draw goes slice by slice of the leading
    axis into the cast tensor; below it, one draw as before."""
    gen = torch.Generator().manual_seed(3)
    want = (torch.randn((6, 5, 4), generator=gen) * 0.5).to(torch.bfloat16)
    gen.manual_seed(3)
    torch.testing.assert_close(
        TL._normal(gen, (6, 5, 4), 0.5, torch.bfloat16, "cpu"), want,
        rtol=0, atol=0)
    monkeypatch.setattr(TL, "_DRAW_ELEMS", 40)     # two rows a draw
    gen.manual_seed(3)
    got = TL._normal(gen, (6, 5, 4), 0.5, torch.bfloat16, "cpu")
    assert got.shape == (6, 5, 4) and got.dtype == torch.bfloat16
    gen.manual_seed(3)
    slices = torch.cat([torch.randn((2, 5, 4), generator=gen) * 0.5
                        for _ in range(3)])
    torch.testing.assert_close(got, slices.to(torch.bfloat16), rtol=0,
                               atol=0)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
def test_mla_forward_parity(causal):
    cfg, tcfg = _cfgs("deepseek_v2_236b")
    p = _np(JL.init_mla(cfg, jax.random.key(21)))
    x = _rand((B, 16, cfg.d_model), 22)
    pos = np.broadcast_to(np.arange(16), (B, 16))
    want = JL.mla_forward(cfg, p, jnp.asarray(x), jnp.asarray(pos), causal)
    got = TL.mla_forward(tcfg, _t(p), torch.from_numpy(x),
                         torch.from_numpy(pos.copy()), causal)
    _close(got, want)
    # positions None: each row's arange, as lm.forward hands them over
    torch.testing.assert_close(
        TL.mla_forward(tcfg, _t(p), torch.from_numpy(x), None, causal), got,
        rtol=0, atol=0)


def test_mla_decode_parity_in_place():
    """One decode step against the JAX layer: the output, and the latent
    cache written in place at each row's position (clamped past the end,
    as ``dynamic_update_slice`` clamps)."""
    cfg, tcfg = _cfgs("deepseek_v2_236b")
    m = cfg.mla
    p = _np(JL.init_mla(cfg, jax.random.key(23)))
    Smax = 12
    cache = {"ckv": _rand((3, Smax, m.kv_lora_rank + m.rope_head_dim), 24)}
    x = _rand((3, 1, cfg.d_model), 25)
    pos = np.array([3, 9, 15], np.int32)
    want, wc = JL.mla_decode(cfg, p, jnp.asarray(x),
                             {"ckv": jnp.asarray(cache["ckv"])},
                             jnp.asarray(pos))
    tc = _t(cache)
    ckv = tc["ckv"]
    got, gc = TL.mla_decode(tcfg, _t(p), torch.from_numpy(x), tc,
                            torch.from_numpy(pos))
    assert gc["ckv"] is ckv
    _close(got, want)
    _close(gc["ckv"], wc["ckv"], msg="latent cache")
    changed = (gc["ckv"].numpy() != cache["ckv"]).any(-1)
    assert changed.sum() == 3 and changed[0, 3] and changed[1, 9] \
        and changed[2, Smax - 1]


def test_mla_cache_is_compressed():
    _, tcfg = _cfgs("deepseek_v2_236b")
    c = TL.init_mla_cache(tcfg, 2, 7, torch.float32, "cpu")
    m = tcfg.mla
    assert list(c) == ["ckv"]
    assert c["ckv"].shape == (2, 7, m.kv_lora_rank + m.rope_head_dim)


# ---------------------------------------------------------------------------
# the whole model on carried weights
# ---------------------------------------------------------------------------


def _jax_cache_layers(cfg, cache):
    """The reference's cache as one dict per layer, the prefix first."""
    out = [{k: np.asarray(v) for k, v in c.items()}
           for c in cache.get("prefix", [])]
    for i in range(jax_lm.n_periods(cfg)):
        for pos in range(cfg.period):
            out.append({k: np.asarray(v)[i]
                        for k, v in cache["blocks"][f"pos{pos}"].items()})
    return out


@pytest.mark.parametrize("arch,impl", [("deepseek_v2_236b", "dense"),
                                       ("kimi_k2_1t_a32b", "dense"),
                                       ("kimi_k2_1t_a32b", "chunked")])
def test_whole_model_parity(arch, impl):
    """Prefill logits, then decode logits step by step and every layer's
    cache, against the JAX model (the prefill at 16 tokens drops pairs in
    both, the same ones)."""
    cfg, tcfg = _cfgs(arch, attn_impl=impl, attn_chunk=8)
    params = jax_lm.init_params(cfg, jax.random.key(0))
    model = torch_lm.LM.from_reference(tcfg, _np(params), device="cpu")
    assert len(model.blocks) == cfg.n_layers
    assert torch_lm.layer_specs(tcfg)[0] == (tcfg.layer_kind(0), "mlp")
    assert all(f == "moe" for _, f in torch_lm.layer_specs(tcfg)[1:])
    Bm, Sm = 2, 16
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (Bm, Sm)) \
        .astype(np.int32)
    want = jax_lm.forward(cfg, params, {"tokens": jnp.asarray(tokens)})
    with torch.inference_mode():
        got = torch_lm.forward(tcfg, model, {"tokens": tokens})
    _close(got, want, msg="forward logits")

    jc = jax_lm.init_cache(cfg, Bm, 8)
    tc = torch_lm.init_cache(tcfg, Bm, 8, "cpu")
    for t in range(6):
        batch = {"token": tokens[:, t:t + 1],
                 "pos": np.full((Bm,), t, np.int32)}
        wl, jc = jax_lm.decode_step(cfg, params, jc,
                                    {k: jnp.asarray(v)
                                     for k, v in batch.items()})
        with torch.inference_mode():
            gl, tc = torch_lm.decode_step(tcfg, model, tc, batch)
        _close(gl, wl, msg=f"decode logits, step {t}")
    layers = _jax_cache_layers(cfg, jc)
    assert len(layers) == len(tc["blocks"])
    for li, (g, w) in enumerate(zip(tc["blocks"], layers)):
        assert sorted(g) == sorted(w)
        for k in w:
            _close(g[k], w[k], msg=f"layer {li} cache {k}")


def _jax_chain(cfg, params, tokens):
    """The reference's layers one by one in bf16: each layer's input, and
    at each MoE layer its expert ids."""
    x = params["embed"][jnp.asarray(tokens)]
    B_, S_ = tokens.shape
    pos = jnp.broadcast_to(jnp.arange(S_), (B_, S_))
    layers = list(params.get("prefix", []))
    for i in range(jax_lm.n_periods(cfg)):
        layers.append(jax.tree.map(lambda a: a[i], params["blocks"]["pos0"]))
    ins, routes = [], {}
    for li, p in enumerate(layers):
        ins.append(x)
        mix = JL.mla_forward if cfg.mla else JL.attn_forward
        x = mix(cfg, p["mix"], x, pos)
        if cfg.is_moe_layer(li):
            routes[li] = _jax_expert_ids(cfg, p["ffn"], x)[1]
            x = JL.moe_forward(cfg, p["ffn"], x)
        else:
            x = JL.mlp_forward(cfg, p["ffn"], x)
    ins.append(x)
    return ins, routes


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_whole_model_bf16_parity(arch, monkeypatch):
    """The published dtype, at 3e-2 against the JAX model, layer by layer:
    every port layer (``lm._apply_layer``) on the reference's input to it
    gives the reference's output, its MoE with the same expert ids, and the
    final norm and head give the reference's logits.

    The logits of the two whole stacks are not compared in bf16: their
    GEMMs sum in different orders (XLA's dot against oneDNN's), an ulp of
    bf16 here and there that the stack carries down to ~3e-2 in the router
    logits, where a near tie may route a token elsewhere and, through the
    capacity ranks, move other tokens' drops (f32 holds the whole stacks,
    ``test_whole_model_parity``)."""
    cfg, tcfg = _cfgs(arch, dtype="bfloat16")
    params = jax_lm.init_params(cfg, jax.random.key(2))
    model = torch_lm.LM.from_reference(tcfg, _np(params), device="cpu")
    assert all(p.dtype in (torch.bfloat16, torch.float32)
               for p in model.parameters())
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (2, 16)) \
        .astype(np.int32)
    ins, routes = _jax_chain(cfg, params, tokens)

    def bf16(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)

    seen = []
    route = TL.moe_route

    def recording(*a, **kw):
        r = route(*a, **kw)
        seen.append(r["gidx"].numpy())
        return r
    monkeypatch.setattr(TL, "moe_route", recording)
    specs = torch_lm.layer_specs(tcfg)
    with torch.inference_mode():
        for li, (spec, blk) in enumerate(zip(specs, model.blocks)):
            seen.clear()
            y = torch_lm._apply_layer(tcfg, spec, blk, bf16(ins[li]), None)
            _close(y.float(), ins[li + 1], tol=BF16_TOL, msg=f"layer {li}")
            assert len(seen) == (li in routes)
            if seen:
                np.testing.assert_array_equal(seen[0], routes[li])
        h = TL.rms_norm(bf16(ins[-1]), model.final_norm, tcfg.norm_eps)
        got = torch_lm.logits_from_hidden(tcfg, model, h)
    want = jax_lm.logits_from_hidden(
        cfg, params, JL.rms_norm(ins[-1], params["final_norm"],
                                 cfg.norm_eps))
    assert got.dtype == torch.float32       # logits_fp32
    _close(got, want, tol=BF16_TOL, msg="logits")
    assert sorted(routes) == [li for li in range(cfg.n_layers)
                              if cfg.is_moe_layer(li)] == [1, 2]


def test_decode_matches_prefill_last_token_without_drops():
    """The port's own prefill against its decode steps, DeepSeek-V2 with
    the capacity raised so that no prefill pair is dropped (a dropped pair
    is the one way the reference's prefill and decode differ)."""
    _, tcfg = _cfgs("deepseek_v2_236b")
    Bm, Sm = 2, 16
    E, K = tcfg.moe.n_experts, tcfg.moe.top_k
    tcfg = _with_capacity(tcfg, E / K + 0.5)
    assert TL.moe_capacity(tcfg, Sm) >= Sm
    model = torch_lm.LM.init(tcfg, torch.Generator().manual_seed(1), "cpu")
    tokens = np.random.default_rng(2).integers(0, tcfg.vocab, (Bm, Sm))
    with torch.inference_mode():
        full = model({"tokens": tokens})
        cache = model.init_cache(Bm, Sm)
        for t in range(Sm):
            logits, cache = model.decode_step(
                cache, {"token": tokens[:, t:t + 1],
                        "pos": np.full((Bm,), t, np.int32)})
    _close(logits[:, 0], full[:, -1], tol=2e-3)


def test_step_into_keeps_the_latent_cache_in_place():
    """``decode_step_into`` (what the decode graph captures) writes the MLA
    latents into the caller's tensors and gives ``decode_step``'s
    logits."""
    _, tcfg = _cfgs("deepseek_v2_236b")
    model = torch_lm.LM.init(tcfg, torch.Generator().manual_seed(4), "cpu")
    batch = {"token": np.array([[5], [7]]), "pos": np.array([0, 2],
                                                            np.int32)}
    a, b = model.init_cache(2, 6), model.init_cache(2, 6)
    ptrs = [c["ckv"].data_ptr() for c in b["blocks"]]
    with torch.inference_mode():
        want, _ = torch_lm.decode_step(tcfg, model, a, batch)
        got, same = torch_lm.decode_step_into(tcfg, model, b, batch)
    assert same is b and [c["ckv"].data_ptr() for c in b["blocks"]] == ptrs
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for ca, cb in zip(a["blocks"], b["blocks"]):
        torch.testing.assert_close(cb["ckv"], ca["ckv"], rtol=0, atol=0)
        assert cb["ckv"][1, 2].abs().sum() > 0
