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


@pytest.mark.parametrize("arch", ["llama3_8b", "rwkv6_3b"])
def test_batcher_gives_the_reference_tokens(arch):
    """Every request gets the tokens the JAX model gives it alone, slots
    reused included, with the JAX batcher's steps and occupancy.  The JAX
    batcher's own ids agree for attention only: it does not reset a reused
    slot's recurrent state (ROADMAP, queue 3)."""
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
    if arch == "llama3_8b":
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


@pytest.mark.parametrize("arch", ["rwkv6_3b", "llama3_8b"])
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


@pytest.mark.parametrize("arch", ["rwkv6_3b", "llama3_8b"])
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
