"""The port's training path against the JAX package's: the data pipeline,
AdamW and its schedule, checkpoints, the fault-tolerant loop, ``loss_fn``
and every gradient for each model family, whole training steps, the
trainer's resume, and K4's backward (its plain version and the autograd
Function around the kernels) on the CPU.

Weights come from ``repro.models.lm.init_params`` and are carried across as
numpy arrays; inputs are made with numpy from a seed and go to both
packages, in f32 unless stated.  On the CPU the port's layers run K4's and
K5's plain versions, and K4's gradient runs ``flash_attention_bwd_plain``.
"""
import dataclasses
import json
import os
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import config as jax_config
from repro import data as jax_data
from repro import optim as jax_optim
from repro.kernels.ref import flash_attention_ref
from repro.launch import steps as jax_steps
from repro.models import api as jax_api
from repro.models import lm as jax_lm
from repro_torch import checkpoint as tckpt
from repro_torch import config as torch_config
from repro_torch import data as tdata
from repro_torch import optim as topt
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as torch_lm
from repro_torch.runtime import FaultTolerantLoop, StepWatchdog

# loss and gradients: the largest error of a tensor within this share of
# its largest reference entry (f32 through other GEMM and reduction orders)
GRAD_TOL = 1e-4
FA_TOL = 2e-5        # K4's f32 limit, the JAX suite's
B, S = 2, 32


@pytest.fixture(autouse=True)
def _port_fault_free():
    from repro_torch.core import faults
    faults.reset()
    yield
    faults.reset()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(arch, **kw):
    """(JAX config, port config), reduced, f32, with ``kw`` replaced."""
    a = dataclasses.replace(jax_config.get_config(arch, reduced=True),
                            dtype="float32", **kw)
    b = dataclasses.replace(torch_config.get_config(arch, reduced=True),
                            dtype="float32", **kw)
    return a, b


def _rel_close(got, want, tol=GRAD_TOL, msg=""):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, msg
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{msg}: max error {err:.3g}, limit " \
        f"{tol * scale:.3g}"


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,step,host", [(0, 0, 0), (3, 17, 0), (3, 17, 1),
                                            (7, 1000, 3)])
def test_batches_bitwise_the_references(seed, step, host):
    kw = dict(vocab=300, seq_len=40, batch=3, seed=seed, host_id=host,
              n_hosts=4)
    want = jax_data.SyntheticLMData(**kw).batch_at(step)
    got = tdata.SyntheticLMData(**kw).batch_at(step)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_iterator_resumes_mid_stream_and_closes():
    ds = tdata.SyntheticLMData(vocab=100, seq_len=16, batch=2, seed=0)
    ref = jax_data.SyntheticLMData(vocab=100, seq_len=16, batch=2, seed=0)
    it = tdata.make_train_iterator(ds, start_step=5)
    got = [next(it) for _ in range(3)]
    it.close()
    assert [s for s, _ in got] == [5, 6, 7]
    for s, b in got:
        np.testing.assert_array_equal(b["tokens"], ref.batch_at(s)["tokens"])


# ---------------------------------------------------------------------------
# optimiser
# ---------------------------------------------------------------------------

SHAPES = [(6, 5), (7,), (3, 4, 2)]


@pytest.mark.parametrize("pdtype,moments", [("float32", None),
                                            ("bfloat16", None),
                                            ("bfloat16", "float32")])
def test_adamw_and_clipping_match_the_reference(pdtype, moments):
    """Three steps of clip -> cosine_schedule(count) -> adamw_update on the
    same parameters and gradients.  f32 within 1e-6 relative; bf16
    parameters and moments within one bf16 step (the fp32 update may round
    the other way where two libms differ in the last fp32 bit)."""
    rng = np.random.default_rng(0)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[(rng.standard_normal(s) * 3).astype(np.float32) for s in SHAPES]
             for _ in range(3)]
    jdt = jnp.dtype(pdtype)
    jp = [jnp.asarray(p, jdt) for p in p0]
    js = jax_optim.adamw_init(jp, moment_dtype=moments)
    tp = [torch.from_numpy(p).to(getattr(torch, pdtype)) for p in p0]
    ts = topt.adamw_init(tp, moment_dtype=moments)
    for g in grads:
        jg, jn = jax_optim.clip_by_global_norm([jnp.asarray(x, jdt)
                                                for x in g], 1.0)
        tg, tn = topt.clip_by_global_norm(
            [torch.from_numpy(x).to(getattr(torch, pdtype)) for x in g], 1.0)
        np.testing.assert_allclose(tn.item(), float(jn), rtol=1e-6)
        jp, js = jax_optim.adamw_update(
            jp, jg, js, jax_optim.cosine_schedule(js["count"]))
        tp, ts = topt.adamw_update(tp, tg, ts,
                                   topt.cosine_schedule(ts["count"]))
    assert ts["count"].dtype == torch.int32 and int(ts["count"]) == 3
    tol = 1e-6 if pdtype == "float32" else 2 ** -7
    for name, got, want in (("param", tp, jp), ("m", ts["m"], js["m"]),
                            ("v", ts["v"], js["v"])):
        for g_, w_ in zip(got, want):
            assert str(g_.dtype).removeprefix("torch.") == str(w_.dtype)
            np.testing.assert_allclose(g_.float().numpy(),
                                       np.asarray(w_, np.float32),
                                       rtol=tol, atol=1e-30, err_msg=name)


def test_cosine_schedule_across_warmup_and_past_total():
    steps = [0, 1, 50, 99, 100, 101, 5000, 9999, 10000, 20000]
    got = topt.cosine_schedule(torch.tensor(steps, dtype=torch.int32))
    want = jax_optim.cosine_schedule(jnp.asarray(steps, jnp.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert got[-1].item() == pytest.approx(3e-5)       # min_ratio * peak


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _tree():
    g = torch.Generator().manual_seed(0)
    return {"p": [torch.randn(3, 4, generator=g).to(torch.bfloat16),
                  torch.randn(5, generator=g)],
            "opt": {"count": torch.tensor(7, dtype=torch.int32),
                    "m": [torch.randn(3, 4, generator=g).to(torch.bfloat16)]}}


def _flat_equal(a, b):
    la, lb = tckpt.checkpoint._flatten(a), tckpt.checkpoint._flatten(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16
                           else x, y.view(torch.int16)
                           if y.dtype == torch.bfloat16 else y)


def test_checkpoint_roundtrip_bitwise_with_bf16(tmp_path):
    tree = _tree()
    path = tckpt.save_checkpoint(str(tmp_path), 7, tree)
    assert tckpt.latest_step(str(tmp_path)) == 7
    man = json.load(open(os.path.join(path, "manifest.json")))
    assert man["n_leaves"] == 4 and man["step"] == 7
    assert man["dtypes"] == ["int32", "bfloat16", "bfloat16", "float32"]
    with np.load(os.path.join(path, "arrays.npz")) as z:
        assert sorted(z.files) == [f"leaf_{i}" for i in range(4)]
        assert z["leaf_1"].dtype == np.uint16
    out = tckpt.restore_checkpoint(str(tmp_path), 7, tree)
    _flat_equal(out, tree)
    with pytest.raises(ValueError, match="leaves"):
        tckpt.restore_checkpoint(str(tmp_path), 7, {"p": tree["p"]})


def test_checkpoint_prunes_to_three_and_ignores_tmp(tmp_path):
    tree = {"a": torch.zeros(2)}
    for s in (1, 2, 3, 4, 5):
        tckpt.save_checkpoint(str(tmp_path), s, tree)
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert kept == [f"step_{s:08d}" for s in (3, 4, 5)]
    # a write that died before its rename leaves a .tmp: never "latest"
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert tckpt.latest_step(str(tmp_path)) == 5
    tckpt.save_checkpoint(str(tmp_path), 9, {"a": torch.ones(2)})
    assert tckpt.latest_step(str(tmp_path)) == 9
    assert not (tmp_path / "step_00000009.tmp").exists()


def test_async_checkpointer_snapshots_before_returning(tmp_path):
    ck = tckpt.AsyncCheckpointer(str(tmp_path))
    tree = _tree()
    want = {"p": [t.clone() for t in tree["p"]],
            "opt": {k: (v.clone() if k == "count" else [t.clone() for t in v])
                    for k, v in tree["opt"].items()}}
    ck.save(1, tree)
    for t in tree["p"]:
        t.add_(1)                   # training goes on in place
    ck.save(2, tree)                # waits for the first
    ck.wait()
    assert tckpt.latest_step(str(tmp_path)) == 2
    _flat_equal(tckpt.restore_checkpoint(str(tmp_path), 1, tree), want)
    _flat_equal(tckpt.restore_checkpoint(str(tmp_path), 2, tree), tree)


# ---------------------------------------------------------------------------
# the fault-tolerant loop (tests/test_fault_tolerance.py's, on tensors)
# ---------------------------------------------------------------------------


def _mk(counter):
    def make_state():
        return {"x": torch.zeros(4), "step_sum": torch.zeros(())}

    def step_fn(state, step):
        counter.append(step)
        return {"x": state["x"] + step, "step_sum": state["step_sum"] + 1}

    return make_state, step_fn


def test_restart_recovers_and_is_deterministic(tmp_path):
    seen = []
    mk, st = _mk(seen)
    loop = FaultTolerantLoop(str(tmp_path / "a"), mk, st, ckpt_every=5,
                             inject={7: RuntimeError("node lost"),
                                     13: RuntimeError("link down")})
    state, log = loop.run(20)
    assert log["restarts"] == 2
    assert seen.count(5) == 2 and seen.count(10) == 2   # replayed from 5, 10
    clean = FaultTolerantLoop(str(tmp_path / "b"), *(_mk([])), ckpt_every=5)
    state2, _ = clean.run(20)
    assert torch.equal(state["x"], state2["x"])
    assert float(state["step_sum"]) == 20


def test_restart_limit(tmp_path):
    mk, st = _mk([])
    loop = FaultTolerantLoop(
        str(tmp_path / "c"), mk, st, ckpt_every=100, max_restarts=1,
        inject={1: RuntimeError("a"), 2: RuntimeError("b"),
                3: RuntimeError("c")})
    with pytest.raises(RuntimeError):
        loop.run(10)


def test_watchdog_flags_stragglers_and_fires():
    fired = []
    wd = StepWatchdog(100.0, lambda: fired.append(1))
    for _ in range(8):
        wd.start_step()
        wd.end_step()
    assert len(wd.step_times) == 8
    # fixed step times: 8 empty steps of microseconds jitter by more than
    # 2x under a loaded host, which is no straggler
    wd.step_times[:] = [0.01] * 8
    assert not wd.straggling(slack=2.0)
    wd.step_times.append(10.0)  # synthetic straggler
    assert wd.straggling(slack=2.0)
    wd = StepWatchdog(0.01, lambda: fired.append(1))
    wd.start_step()
    wd._timer.join(5)
    assert fired == [1]


# ---------------------------------------------------------------------------
# loss_fn and every gradient, family by family
# ---------------------------------------------------------------------------

# remat "dots" on both sides too: the port saves the plain matrix products
# alone, as the reference's checkpoint_dots_with_no_batch_dims
FAMILIES = [("llama3_8b", {}), ("llama3_8b", {"attn_impl": "chunked"}),
            ("rwkv6_3b", {}), ("deepseek_v2_236b", {}),
            ("jamba_1_5_large_398b", {}), ("whisper_small", {}),
            ("paligemma_3b", {}), ("llama3_8b", {"remat": "dots"}),
            ("llama3_8b", {"attn_impl": "chunked", "remat": "dots"}),
            ("whisper_small", {"remat": "dots"})]
# families whose JAX side (its ``init_params``, the trace and the compile
# of its gradient: ~20 s alone, ~100 s beside 5 busy workers, jitted init
# or not, against the port's ~1 s) a child process computes while the
# tests before them run; the others compute it in the test
PREFETCH = ("jamba_1_5_large_398b",)


def _family_cfgs(arch, kw):
    """``_cfgs`` for the family comparison: an MoE's capacity raised so
    that no pair is dropped (the gradient is then smooth)."""
    jcfg, tcfg = _cfgs(arch, **kw)
    if jcfg.moe:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=8.0))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, capacity_factor=8.0))
    return jcfg, tcfg


def _jax_side(jcfg):
    """(parameters, batch, loss, gradients) of the JAX reference on
    ``jcfg``, as numpy: ``init_params`` from key 1, ``make_batch`` seed 1,
    ``jax.value_and_grad`` of ``loss_fn`` jitted."""
    params = jax_lm.init_params(jcfg, jax.random.key(1))
    shape = jax_config.ShapeConfig("t", "train", S, B)
    batch = _np(jax_api.make_batch(jcfg, shape, seed=1))
    loss, grads = jax.jit(jax.value_and_grad(partial(jax_lm.loss_fn, jcfg)))(
        params, batch)
    return _np((params, batch, loss, grads))


def _prefetch_jax_side(arch):
    return _jax_side(_family_cfgs(arch, {})[0])


@pytest.fixture(scope="module", autouse=True)
def _prefetched(request):
    """{arch: the future of its ``_jax_side``} of the PREFETCH families
    whose test is collected, submitted when the module's first test runs
    to a child process (spawned: this one has threads)."""
    wanted = [a for a in PREFETCH if any(f"match_jax[{a}]" in it.nodeid
                                         for it in request.session.items)]
    if not wanted:
        yield {}
        return
    with ProcessPoolExecutor(1, multiprocessing.get_context("spawn")) as pool:
        yield {a: pool.submit(_prefetch_jax_side, a) for a in wanted}


def _ordered(tcfg, tree):
    """A reference parameter tree (numpy) as the port's ``param_list``."""
    return [t.detach() for t in torch_lm.LM.from_reference(
        tcfg, tree, "cpu").param_list()]


@pytest.mark.parametrize("arch,kw", FAMILIES,
                         ids=[a + ("-" + "-".join(k.values()) if k else "")
                              for a, k in FAMILIES])
def test_loss_and_every_gradient_match_jax(arch, kw, _prefetched):
    jcfg, tcfg = _family_cfgs(arch, kw)
    if arch in _prefetched and not kw:
        params, batch, loss, grads = _prefetched[arch].result()
    else:
        params, batch, loss, grads = _jax_side(jcfg)
    model = torch_lm.LM.from_reference(tcfg, _np(params), "cpu")
    model.requires_grad_(True)
    tl = torch_lm.loss_fn(tcfg, model, {k: torch.from_numpy(np.array(v))
                                        for k, v in batch.items()})
    tg = torch.autograd.grad(tl, model.param_list())
    _rel_close(tl.item(), float(loss), msg="loss")
    want = _ordered(tcfg, _np(grads))
    assert len(tg) == len(want)
    for i, (g, w) in enumerate(zip(tg, want)):
        _rel_close(g.numpy(), w.numpy(), msg=f"gradient {i} {tuple(w.shape)}")


def test_remat_modes_agree_and_full_runs_k4_twice(monkeypatch):
    """"none", "full" and "dots" give the same loss and gradients; under
    "full" each layer's K4 forward runs again in the backward."""
    calls = []
    run = fa._run
    monkeypatch.setattr(fa, "_run", lambda *a: calls.append(a[7]) or run(*a))
    got = {}
    for remat in ("none", "full", "dots"):
        _, tcfg = _cfgs("llama3_8b", attn_impl="chunked", remat=remat)
        model = torch_lm.LM.init(tcfg, torch.Generator().manual_seed(0),
                                 "cpu").requires_grad_(True)
        batch = jax_api.make_batch(_cfgs("llama3_8b")[0],
                                   jax_config.ShapeConfig("t", "train", S, B),
                                   seed=2)
        calls.clear()
        loss = torch_lm.loss_fn(tcfg, model, {k: torch.from_numpy(
            np.array(v)) for k, v in batch.items()})
        grads = torch.autograd.grad(loss, model.param_list())
        got[remat] = (loss, grads)
        # every forward call of K4 under grad asks for the log-sum-exp
        assert calls == [True] * (tcfg.n_layers * (1 if remat == "none"
                                                   else 2))
    for remat in ("full", "dots"):
        torch.testing.assert_close(got[remat][0], got["none"][0], rtol=0,
                                   atol=0)
        for a, b in zip(got[remat][1], got["none"][1]):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# training steps and the trainer
# ---------------------------------------------------------------------------


def test_five_train_steps_match_the_reference():
    """``build_train_step`` against the reference's ``train_step`` (one
    device) on carried weights, for 5 steps of the same batches: the
    losses, and the parameters and moments after the last step."""
    _five_steps_match_the_reference("llama3_8b", attn_impl="chunked")


def test_five_rwkv_train_steps_match_the_reference():
    """The same for the reduced rwkv6-3b, whose time mix takes its gradient
    through K5's autograd Function (the plain backward on the CPU)."""
    _five_steps_match_the_reference("rwkv6_3b")


def _five_steps_match_the_reference(arch, **kw):
    jcfg, tcfg = _cfgs(arch, **kw)
    params = jax_lm.init_params(jcfg, jax.random.key(3))
    opt = jax_optim.adamw_init(params)
    shape = jax_config.ShapeConfig("t", "train", S, B)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    jstep = jax.jit(jax_steps.build_train_step(jcfg, shape, mesh)[0])
    model = torch_lm.LM.from_reference(tcfg, _np(params), "cpu")
    model.requires_grad_(True)
    topt_state = torch_lm.opt_state_from_reference(tcfg, _np(opt), "cpu")
    tstep = tsteps.build_train_step(tcfg, model)
    ds = tdata.SyntheticLMData(vocab=tcfg.vocab, seq_len=S, batch=B, seed=4)
    for step in range(5):
        b = ds.batch_at(step)
        params, opt, jm = jstep(params, opt, b)
        tm = tstep(model, topt_state, {k: torch.from_numpy(v)
                                       for k, v in b.items()})
        _rel_close(tm["loss"].item(), float(jm["loss"]), msg=f"loss {step}")
        _rel_close(tm["grad_norm"].item(), float(jm["grad_norm"]),
                   msg=f"grad norm {step}")
    assert int(topt_state["count"]) == int(opt["count"]) == 5
    want = torch_lm.opt_state_from_reference(tcfg, _np(opt), "cpu")
    for name, got, ref in (
            ("param", [p.detach() for p in model.param_list()],
             _ordered(tcfg, _np(params))),
            ("m", topt_state["m"], want["m"]), ("v", topt_state["v"],
                                                  want["v"])):
        for i, (g, w) in enumerate(zip(got, ref)):
            _rel_close(g.numpy(), w.numpy(), msg=f"{name} {i}")


@pytest.mark.parametrize("arch", ["llama3_8b", "rwkv6_3b"])
def test_prefill_and_decode_builders_match_the_reference(arch):
    """``build_prefill_step`` and ``build_decode_step`` against the
    reference's builders' step functions (one device) on carried weights:
    the prefill's logits, then 3 decode steps from an empty cache, each
    step's logits."""
    jcfg, tcfg = _cfgs(arch)
    params = jax_lm.init_params(jcfg, jax.random.key(5))
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    jpre = jax.jit(jax_steps.build_prefill_step(
        jcfg, jax_config.ShapeConfig("t", "prefill", S, B), mesh)[0])
    jdec = jax.jit(jax_steps.build_decode_step(
        jcfg, jax_config.ShapeConfig("t", "decode", S, B), mesh)[0])
    model = torch_lm.LM.from_reference(tcfg, _np(params), "cpu")
    tpre = tsteps.build_prefill_step(tcfg, model)
    tdec = tsteps.build_decode_step(tcfg, model)
    tokens = np.random.default_rng(6).integers(0, tcfg.vocab, (B, S)
                                               ).astype(np.int32)
    with torch.inference_mode():
        got = tpre(model, {"tokens": torch.from_numpy(tokens)})
    _rel_close(got.numpy(), np.asarray(jpre(params, {"tokens": tokens})),
               msg="prefill logits")
    jcache = jax_lm.init_cache(jcfg, B, S)
    tcache = model.init_cache(B, S)
    for t in range(3):
        tok, pos = tokens[:, t:t + 1], np.full((B,), t, np.int32)
        jl, jcache = jdec(params, jcache, {"token": tok, "pos": pos})
        with torch.inference_mode():
            tl, tcache = tdec(model, tcache, {"token": torch.from_numpy(tok),
                                              "pos": torch.from_numpy(pos)})
        _rel_close(tl.numpy(), np.asarray(jl), msg=f"decode step {t}")


def test_train_main_resumes_as_an_uninterrupted_run(tmp_path, capsys):
    _resumed_equals_uninterrupted(tmp_path, capsys, "llama3_8b")


def test_rwkv_train_main_resumes_as_an_uninterrupted_run(tmp_path, capsys):
    """The reduced rwkv6-3b's 6 steps at the warm-up rate do not lower its
    loss (its steps equal the reference's:
    ``test_five_rwkv_train_steps_match_the_reference``); the resumed run
    must still end where the uninterrupted one does."""
    _resumed_equals_uninterrupted(tmp_path, capsys, "rwkv6_3b", falls=False)


def _resumed_equals_uninterrupted(tmp_path, capsys, arch, falls=True):
    args = ["--arch", arch, "--device", "cpu", "--reduced", "--batch", "2",
            "--seq", "32", "--ckpt-every", "2", "--log-every", "1"]
    full = ttrain.main(args + ["--steps", "6", "--ckpt-dir",
                               str(tmp_path / "a")])
    first = ttrain.main(args + ["--steps", "4", "--ckpt-dir",
                                str(tmp_path / "b")])
    rest = ttrain.main(args + ["--steps", "6", "--ckpt-dir",
                               str(tmp_path / "b")])
    out = capsys.readouterr().out
    assert "[train] resumed from step 4" in out and "[train] done" in out
    assert first + rest == full
    assert all(np.isfinite(full))
    if falls:
        assert full[-1] < full[0]
    cfg = torch_config.get_config(arch, reduced=True)
    like = torch_lm.LM.init(cfg, torch.Generator().manual_seed(0),
                            "cpu").param_list()
    like = ([p.detach() for p in like], topt.adamw_init(like))
    a = tckpt.restore_checkpoint(str(tmp_path / "a"), 6, like)
    b = tckpt.restore_checkpoint(str(tmp_path / "b"), 6, like)
    _flat_equal(a, b)


# ---------------------------------------------------------------------------
# K4's backward
# ---------------------------------------------------------------------------


def _qkv(Bq, H, Hkv, Sq, hd, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(dtype) for s in
            ((Bq, H, Sq, hd), (Bq, Hkv, Sq, hd), (Bq, Hkv, Sq, hd),
             (Bq, H, Sq, hd))]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("blocks", [(16, 16, 16), (32, 16, 16), (16, 48, 16),
                                    (24, 40, 16),
                                    # the tensor-core route's dK/dV tiles
                                    (*fa.BWD_TILES["wgmma"][64], 64),
                                    (*fa.BWD_TILES["wgmma"][128], 128),
                                    (*fa.BWD_TILES["wgmma"][256], 256),
                                    # the tf32x3 route's
                                    (*fa.BWD_TILES["tf32x3"][64], 64),
                                    (*fa.BWD_TILES["tf32x3"][128], 128),
                                    (*fa.BWD_TILES["tf32x3"][256], 256),
                                    # the mma route's (hd 16 and 32)
                                    (*fa.BWD_TILES["mma"][16], 16),
                                    (*fa.BWD_TILES["mma"][32], 32)])
def test_bwd_plain_matches_jax_vjp(blocks, G, causal):
    """``flash_attention_bwd_plain`` on unequal and ragged blocks (block_q,
    block_k, hd; S = 72 at hd 16, else 200: several ragged tiles of the
    tensor-core routes') against ``jax.vjp`` of the oracle (k, v repeated
    to the q heads, their gradients summed back over each group)."""
    bq, bk, hd = blocks
    H, S = 4, 72 if hd == 16 else 200
    q, k, v, g = _qkv(2, H, H // G, S, hd, seed=G)
    out, vjp = jax.vjp(lambda q_, k_, v_: flash_attention_ref(
        q_, jnp.repeat(k_, G, axis=1), jnp.repeat(v_, G, axis=1),
        causal=causal), q, k, v)
    want = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    o, lse = fa.flash_attention_plain(tq, tk, tv, causal=causal,
                                      block_q=bq, block_k=bk,
                                      return_lse=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(out), rtol=FA_TOL,
                               atol=FA_TOL)
    got = fa.flash_attention_bwd_plain(tq, tk, tv, o, lse, torch.from_numpy(g),
                                       causal=causal, block_q=bq, block_k=bk)
    for name, a, b in zip("qkv", got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=FA_TOL,
                                   atol=FA_TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("hd", [16, 32, 48, 64, 128, 256])
def test_bwd_route_by_dtype_and_head_dim(hd, dtype):
    """bf16 at hd 64/128/256 takes the tensor-core backward ("wgmma"), f32
    at hd 64/128/256 the 3xTF32 one ("tf32x3"), hd 16/32 the mma.sync one
    ("mma"); a tensor-core call launches 3 kernels, 4 where its schedule
    cuts a walk (bf16 at hd 64/128: its kv tiles' walks wrapped over the
    SMs; at hd 256: its grids' walks cut into pieces; f32: its groups' q
    heads split, and always at hd 256, whose kernels walk halves of their
    causal walks), the fourth summing the partials; an mma call launches
    1."""
    want = ("wgmma" if dtype == torch.bfloat16 and hd >= 64 else
            "tf32x3" if dtype == torch.float32 and hd >= 64 else
            "mma")
    assert fa.bwd_route(dtype, hd) == want
    if fa.split_route(dtype, hd):
        # bf16 at hd 256 cuts its kernels' walks into pieces
        # (``dkdv_split``, ``dq_split``) where the grids would be under the
        # SMs, and sums their partials in a fourth kernel
        assert fa.bwd_launches(dtype, hd, 2, 32, 8, 2048) == 3
        assert fa.bwd_launches(dtype, hd, 1, 8, 1, 1024) == 4
        assert fa.bwd_launches(dtype, hd, 1, 12, 12, 448, causal=False) == 4
    elif want == "wgmma":
        # the kv tiles' walks wrapped over the SMs (``dkdv_wrap``):
        # llama3-8b's training shape (256 tiles) and Whisper's short walks
        # stay whole; an MQA group over 1024 keys and Kimi-K2's GQA 8 over
        # 2048 cut their walks
        assert fa.bwd_launches(dtype, hd, 2, 32, 8, 2048) == 3
        assert fa.bwd_launches(dtype, hd, 1, 8, 1, 1024) == 4
        assert fa.bwd_launches(dtype, hd, 1, 64, 8, 2048) == 4
        assert fa.bwd_launches(dtype, hd, 1, 12, 12, 448) == 3
        assert fa.bwd_launches(dtype, hd, 1, 12, 12, 448, causal=False) == 3
    elif want != "mma":
        # llama3-8b's training shape fills the card unsplit; an MQA group
        # over 1024 keys (16 kv tiles of 64) splits its 8 q heads
        summed = hd == 256
        assert fa.bwd_split(2, 32, 8, 2048, hd, want) == 1
        assert fa.bwd_launches(dtype, hd, 2, 32, 8, 2048) == 3 + summed
        assert fa.bwd_split(1, 8, 1, 1024, hd, want) == 8
        assert fa.bwd_launches(dtype, hd, 1, 8, 1, 1024) == 4
        assert fa.bwd_split(1, 12, 12, 448, hd, want) == 1
        assert fa.bwd_launches(dtype, hd, 1, 12, 12, 448) == 3 + summed
    elif hd in fa.BWD_TILES["mma"]:
        assert fa.bwd_launches(dtype, hd, 1, 8, 1, 1024) == 1
        assert fa.bwd_launches(dtype, hd, 2, 6, 2, 256) == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 64, 256])
def test_autograd_function_on_views_matches_plain_autograd(hd, dtype):
    """The Function called on CPU tensors (strided views of (B, S, heads,
    hd) activations, GQA 2) against autograd through
    ``flash_attention_plain``: gradients of each input's shape and dtype,
    dk and dv at the kv heads, equal within the dtype's K4 limit."""
    Bq, H, Hkv, Sq = 2, 4, 2, 80
    rng = np.random.default_rng(hd)
    base = [torch.from_numpy(rng.standard_normal((Bq, Sq, n, hd)).astype(
        np.float32)).to(dtype).requires_grad_() for n in (H, Hkv, Hkv)]
    views = [t.transpose(1, 2) for t in base]
    out = fa.flash_attention(*views, causal=True)
    assert out.grad_fn is not None and "Attention" in type(out.grad_fn).__name__
    g = torch.from_numpy(rng.standard_normal(out.shape).astype(
        np.float32)).to(dtype)
    got = torch.autograd.grad(out, base, g)
    ref = [t.detach().float().requires_grad_() for t in base]
    want = torch.autograd.grad(fa.flash_attention_plain(
        *[t.transpose(1, 2) for t in ref], causal=True, block_q=16,
        block_k=16), ref, g.float())
    tol = FA_TOL if dtype == torch.float32 else 2e-2
    for a, b, x in zip(got, want, base):
        assert a.dtype == dtype and a.shape == x.shape
        torch.testing.assert_close(a.float(), b, rtol=tol, atol=tol)


def test_no_grad_calls_skip_the_function():
    q, k, v, _ = (torch.from_numpy(x) for x in _qkv(1, 2, 2, 16, 16, 0))
    q.requires_grad_()
    with torch.no_grad():
        assert fa.flash_attention(q, k, v).grad_fn is None
    assert fa.flash_attention(q.detach(), k, v).grad_fn is None
