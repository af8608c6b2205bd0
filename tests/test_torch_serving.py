"""The port's continuous batcher and serving launcher against the JAX
package's: the same token ids on carried weights, slot reuse, and the
launcher's CPU run.  Weights are drawn by the reference and handed across as
numpy arrays; prompts come from numpy seeds."""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from repro.config import get_config as jax_get_config
from repro.models import lm as jax_lm
from repro.runtime.serving import ContinuousBatcher as JaxBatcher
from repro.runtime.serving import Request as JaxRequest
from repro_torch.config import get_config
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.runtime.serving import ContinuousBatcher, Request

SMAX = 48


@pytest.fixture(autouse=True)
def _port_fault_free():
    from repro_torch.core import faults
    faults.reset()
    yield
    faults.reset()


def _models(arch):
    cfg = dataclasses.replace(jax_get_config(arch, reduced=True),
                              dtype="float32")
    tcfg = dataclasses.replace(get_config(arch, reduced=True),
                               dtype="float32")
    params = jax_lm.init_params(cfg, jax.random.key(0))
    model = lm.LM.from_reference(tcfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    return cfg, params, tcfg, model


def _requests(cls, vocab, n, prompt_len, max_new, seed):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(2, vocab, size=prompt_len),
                max_new=max_new) for i in range(n)]


def _alone(decode, init_cache, req, eos, max_len):
    """Greedy decoding of one request from a fresh one-slot cache, with the
    batcher's stopping rule: the tokens the model gives it alone."""
    cache, out, pos = init_cache(1), [], 0
    for t in req.prompt:
        logits, cache = decode(cache, np.array([[t]], np.int32),
                               np.array([pos], np.int32))
        pos += 1
    while True:
        out.append(int(np.argmax(np.asarray(logits)[0, -1])))
        if len(out) >= req.max_new or out[-1] == eos or pos >= max_len - 1:
            return out
        logits, cache = decode(cache, np.array([[out[-1]]], np.int32),
                               np.array([pos], np.int32))
        pos += 1


@pytest.mark.parametrize("arch", ["llama3_8b", "rwkv6_3b",
                                  "deepseek_v2_236b"])
def test_batcher_gives_the_reference_tokens(arch):
    """Every request gets the tokens the JAX model gives it alone, slots
    reused included, with the JAX batcher's steps and occupancy.  The JAX
    batcher's own ids agree for attention (MLA included) only: it does not
    reset a reused slot's recurrent state (ROADMAP, queue 3)."""
    cfg, params, tcfg, model = _models(arch)

    @jax.jit
    def jax_decode(cache, tokens, pos):
        return jax_lm.decode_step(cfg, params, cache,
                                  {"token": tokens, "pos": pos})

    def jax_init(n):
        return jax_lm.init_cache(cfg, n, SMAX)

    ref = JaxBatcher(jax_decode, jax_init, n_slots=2, eos=1, max_len=SMAX)
    for r in _requests(JaxRequest, cfg.vocab, 5, 6, 5, seed=0):
        ref.submit(r)
    ref.run()
    alone = {r.rid: _alone(jax_decode, jax_init, r, 1, SMAX)
             for r in _requests(JaxRequest, cfg.vocab, 5, 6, 5, seed=0)}

    def decode(cache, tokens, pos):
        with torch.inference_mode():
            return lm.decode_step(tcfg, model, cache,
                                  {"token": tokens, "pos": pos})

    port = ContinuousBatcher(decode, lambda n: model.init_cache(n, SMAX),
                             n_slots=2, eos=1, max_len=SMAX, device="cpu")
    for r in _requests(Request, cfg.vocab, 5, 6, 5, seed=0):
        port.submit(r)
    port.run()
    assert len(port.completed) == 5
    assert {r.rid: r.output for r in port.completed} == alone
    if arch != "rwkv6_3b":
        assert alone == {r.rid: r.output for r in ref.completed}
    assert (port.steps, port.occupancy) == (ref.steps, ref.occupancy)


def test_reused_slot_starts_from_a_fresh_state():
    """One slot answers two RWKV requests in turn; the second gets the
    tokens a fresh batcher gives it."""
    _, _, tcfg, model = _models("rwkv6_3b")

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

    first, second = _requests(Request, tcfg.vocab, 2, 6, 5, seed=2)
    again = _requests(Request, tcfg.vocab, 2, 6, 5, seed=2)[1]
    assert answer([first, second]) == answer([again])


def test_slots_are_reused():
    _, _, tcfg, model = _models("llama3_8b")

    def decode(cache, tokens, pos):
        with torch.inference_mode():
            return model.decode_step(cache, {"token": tokens, "pos": pos})

    b = ContinuousBatcher(decode, lambda n: model.init_cache(n, SMAX),
                          n_slots=2, eos=1, max_len=SMAX, device="cpu")
    reqs = _requests(Request, tcfg.vocab, 6, 4, 3, seed=1)
    for r in reqs:
        b.submit(r)
    b.run()
    assert len(b.completed) == 6 and all(r.done for r in b.completed)
    assert max(b.occupancy) == 2
    assert b.steps < sum(len(r.prompt) + r.max_new for r in reqs)


@pytest.mark.parametrize("arch", ["rwkv6_3b", "llama3_8b",
                                  "deepseek_v2_236b", "kimi_k2_1t_a32b"])
def test_serve_main_runs_on_the_cpu(arch, capsys):
    gen = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--gen", "4"])
    assert gen.shape == (2, 4)
    assert ((gen >= 0) & (gen < get_config(arch, reduced=True).vocab)).all()
    out = capsys.readouterr().out
    assert "[serve] prefill 8 tokens" in out and "tok/s" in out


def test_prefill_into_cache_matches_forward():
    tcfg = dataclasses.replace(get_config("rwkv6_3b", reduced=True),
                               dtype="float32")
    model = lm.LM.init(tcfg, torch.Generator().manual_seed(3), "cpu")
    tokens = torch.as_tensor(np.random.default_rng(4).integers(
        2, tcfg.vocab, (2, 8)), dtype=torch.int32)
    with torch.inference_mode():
        _, logits = serve.prefill_into_cache(tcfg, model, tokens,
                                             model.init_cache(2, 8))
        full = model({"tokens": tokens})
    np.testing.assert_allclose(logits[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", ["rwkv6_3b", "llama3_8b",
                                  "deepseek_v2_236b"])
def test_step_writes_states_into_the_callers_cache(arch):
    """``lm.decode_step_into`` (the step a CUDA graph captures) leaves every
    state in the caller's own tensors, RWKV states included, which
    ``decode_step`` replaces: a batcher over it keeps one cache whose
    storage never moves, admission resets included, and every request gets
    the tokens the replacing step gives it."""
    _, _, tcfg, model = _models(arch)

    def answer(step):
        b = ContinuousBatcher(step, lambda n: model.init_cache(n, SMAX),
                              n_slots=2, eos=1, max_len=SMAX, device="cpu")
        cache = b.cache
        ptrs = [t.data_ptr() for c in cache["blocks"] for t in c.values()]
        for r in _requests(Request, tcfg.vocab, 5, 6, 5, seed=3):
            b.submit(r)
        with torch.inference_mode():
            b.run()
        assert len(b.completed) == 5
        moved = [t.data_ptr() for c in b.cache["blocks"]
                 for t in c.values()] != ptrs
        return {r.rid: r.output for r in b.completed}, b.cache is cache, moved

    replaced, same_replaced, _ = answer(
        lambda c, t, p: lm.decode_step(tcfg, model, c,
                                       {"token": t, "pos": p}))
    in_place, same, moved = answer(
        lambda c, t, p: lm.decode_step_into(tcfg, model, c,
                                            {"token": t, "pos": p}))
    assert in_place == replaced
    assert same and not moved
    assert not same_replaced      # decode_step returns a new cache


def _rwkv_step_inputs(B=2):
    """Reduced rwkv6-3b in f32 on carried weights, a cache that has
    decoded three tokens, and the next token's batch."""
    _, _, tcfg, model = _models("rwkv6_3b")
    rng = np.random.default_rng(6)
    cache = model.init_cache(B, SMAX)
    with torch.inference_mode():
        for t in range(3):
            _, cache = lm.decode_step(tcfg, model, cache, {
                "token": rng.integers(2, tcfg.vocab, (B, 1)),
                "pos": np.full((B,), t, np.int32)})
    batch = {"token": rng.integers(2, tcfg.vocab, (B, 1)),
             "pos": np.full((B,), 3, np.int32)}
    return tcfg, model, cache, batch


def test_step_into_updates_wkv_states_in_place_without_a_copy():
    """Under ``decode_step_into`` the WKV kernel writes each RWKV layer's
    new state over the cache's own tensor (the step hands back that very
    tensor, so nothing is copied back), and the logits and states are
    those of ``decode_step``."""
    tcfg, model, cache, batch = _rwkv_step_inputs()
    want_logits, want = lm.decode_step(tcfg, model, cache, batch)
    states = [c["s"] for c in cache["blocks"]]
    ptrs = [s.data_ptr() for s in states]
    with torch.inference_mode():
        logits, new = lm._decode(tcfg, model, cache, batch, in_place=True)
    assert all(n["s"] is s for n, s in zip(new["blocks"], states))
    assert [c["s"].data_ptr() for c in cache["blocks"]] == ptrs
    torch.testing.assert_close(logits, want_logits, rtol=0, atol=0)
    for c, w in zip(cache["blocks"], want["blocks"]):
        torch.testing.assert_close(c["s"], w["s"], rtol=0, atol=0)
    # decode_step_into: the shifts copied in, the states already there
    tcfg, model, cache, batch = _rwkv_step_inputs()
    with torch.inference_mode():
        logits, same = lm.decode_step_into(tcfg, model, cache, batch)
    assert same is cache
    torch.testing.assert_close(logits, want_logits, rtol=0, atol=0)
    for c, w in zip(cache["blocks"], want["blocks"]):
        for name in ("shift_a", "shift_f", "s"):
            torch.testing.assert_close(c[name], w[name], rtol=0, atol=0)


def test_decode_step_leaves_the_callers_rwkv_cache_unchanged():
    """``decode_step`` keeps its contract: the RWKV states and shifts it
    returns are new tensors, and the caller's cache is as it was."""
    tcfg, model, cache, batch = _rwkv_step_inputs()
    before = [{k: t.clone() for k, t in c.items()} for c in cache["blocks"]]
    with torch.inference_mode():
        _, new = lm.decode_step(tcfg, model, cache, batch)
    for c, b, n in zip(cache["blocks"], before, new["blocks"]):
        for name in b:
            assert torch.equal(c[name], b[name])
            assert n[name] is not c[name]
            assert not torch.equal(n[name], b[name])
