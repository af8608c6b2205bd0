"""The port's multi-device path on gloo process groups on the CPU, against
the JAX package's single-process references: the pipeline executor (its
forward and gradients), the ring all-gather matmul, the int8 compressed
all-reduce, the sharded train step of the reduced llama3-8b on (4, 2) and
(2, 2) meshes through ``launch.train.train``, the tensor-parallel train
steps of the reduced llama3-8b (dense and chunked attention, and with 8 q
heads over its 2 kv heads, which a 4-way model axis does not split),
gemma-7b, rwkv6-3b (its 2 heads split on (1, 2) and (2, 2), whole on
(1, 4)), deepseek-v2 (MLA, the experts over "model"), kimi-k2, jamba
(Mamba's channels over "model"), whisper and paligemma on (1, 2), (2, 2)
and (1, 4) meshes and at (1, 1) in this process, the parameters whole on
"model" equal across its ranks, the ZeRO-3 styles ("fsdp" on (1, 4) for
llama3-8b and rwkv6-3b, "ep" on (2, 2) for DeepSeek-V2, "fsdp" over a
batch its ranks do not split), each layer's gradient reduce-scattered to
its shard before the layer below's backward starts, the MoE's shared MLP
at its own width under a model axis, the sharded prefill and decode
steps, every family's
decode step on the rank's block of the cache's positions on (2, 2) and
(1, 4) and at (1, 1), the elastic restore, and the raise where the card
or NCCL is asked for and missing.

The cases spawn their ranks three times in all (``torch_dist_workers.spawn``:
a ``FileStore`` under a temporary directory, one thread a rank, a deadline
after which the ranks are killed): 8 ranks for the collectives and the
(4, 2) step, then 4 for the (2, 2) steps, the (1, 4) step, the restore
onto (2, 2), the prefill and decode steps and every family's decode
runs, then 2 for the (1, 2) steps.  The rank functions import no JAX;
the JAX side is computed here on the same numpy inputs.
"""
import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from repro import config as jax_config
from repro import optim as jax_optim
from repro.launch import steps as jax_steps
from repro.models import lm as jax_lm
from repro.parallel import pipeline as jax_pipeline
from repro_torch import checkpoint as tckpt
from repro_torch import config as torch_config
from repro_torch.data import train_data
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as torch_lm
from repro_torch.optim import adamw_init, cosine_schedule
from repro_torch.parallel import compression as tcompression
from repro_torch.parallel import sharding as tsharding

import torch_dist_workers as workers

S_STAGES, M, D = 8, 12, 32          # the reference suite's pipeline case
B, SEQ, STEPS = 8, 32, 3            # the sharded train step's batches
LOSS_RTOL = 1e-5
SPAWN_TIMEOUT = 300                 # pytest's guard; a spawn's deadline 240


@pytest.fixture(autouse=True)
def _port_fault_free():
    from repro_torch.core import faults
    faults.reset()
    yield
    faults.reset()


# ---------------------------------------------------------------------------
# collectives: pipeline, ag_matmul, compressed psum, layouts (8 ranks)
# ---------------------------------------------------------------------------

LAYOUTS = [((("pod", "data"), "model"), (8, 6)),
           ((None, ("data", "model")), (3, 8)),
           (("model", None, "pod"), (4, 3, 2)),
           ((), (5,))]


def _collective_inputs():
    """The reference suite's inputs (``tests/test_multidevice.py``, drawn
    from the same keys; the stage bias drawn rather than zero), its limits
    being set on them."""
    def normal(key, shape):
        return np.asarray(jax.random.normal(jax.random.key(key), shape))
    pipe = {"params": {"w": normal(0, (S_STAGES, D, D)) * D ** -0.5,
                       "b": normal(5, (S_STAGES, D)) * 0.1},
            "mbs": normal(1, (M, 4, D))}
    rng = np.random.default_rng(0)
    layout = [(tsharding.P(*spec), rng.standard_normal(shape).astype(
        np.float32)) for spec, shape in LAYOUTS]
    return {"pipe": pipe, "x": normal(2, (32, 16)), "w": normal(3, (16, 24)),
            "grads": normal(4, (8, 64)) * np.float32(0.1), "layout": layout}


@pytest.fixture(scope="module")
def collectives(eight_ranks):
    return {**eight_ranks["collectives"],
            "res": [r["collectives"] for r in eight_ranks["ranks"]]}


def _jax_stage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


@pytest.mark.timeout(SPAWN_TIMEOUT)
def test_pipelined_forward_matches_jax_reference(collectives):
    pipe = collectives["pipe"]
    want = np.asarray(jax_pipeline.reference_forward(
        _jax_stage, pipe["params"], pipe["mbs"]))
    for r in collectives["res"]:
        np.testing.assert_allclose(r["pipeline"]["outs"], want, rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.timeout(SPAWN_TIMEOUT)
def test_pipelined_gradients_match_jax_grad(collectives):
    """Each rank's gradient holds its stage's row alone; their sum against
    ``jax.grad`` of the reference loss at the reference suite's limits
    (which reject a gradient counted once a stage)."""
    pipe = collectives["pipe"]
    tgt = jnp.zeros((M, 4, D))
    want = jax.grad(lambda p: jnp.mean(jnp.square(
        jax_pipeline.reference_forward(_jax_stage, p, pipe["mbs"]) - tgt)))(
        pipe["params"])
    for k in ("w", "b"):
        rows = [r["pipeline"]["grads"][k] for r in collectives["res"]]
        for s, g in enumerate(rows):
            others = np.delete(g, s, axis=0)
            assert not others.any(), f"rank {s} wrote other stages' {k}"
        np.testing.assert_allclose(sum(rows), np.asarray(want[k]),
                                   rtol=2e-4, atol=2e-5)


@pytest.mark.timeout(SPAWN_TIMEOUT)
def test_ag_matmul_matches_the_plain_product(collectives):
    want = collectives["x"] @ collectives["w"]
    for r in collectives["res"]:
        np.testing.assert_allclose(r["ag_matmul"], want, rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.timeout(SPAWN_TIMEOUT)
def test_compressed_psum_is_the_mean_on_one_shared_grid(collectives):
    """Within 2 % of the mean (the reference suite's limit), and bitwise a
    numpy emulation: the scales' max over ranks, the same noise on every
    rank, int32 sums, the division by 8."""
    g = collectives["grads"]
    want = g.mean(axis=0)
    noise = tcompression.uniform_noise(
        (64,), torch.Generator().manual_seed(0)).numpy()
    scale = np.max(np.abs(g), axis=-1, keepdims=True) / np.float32(127.0) \
        + np.float32(1e-12)
    scale = scale.max(axis=0)
    q = np.clip(np.round(g / scale + noise), -127, 127).astype(np.int8)
    emul = q.astype(np.int32).sum(axis=0).astype(np.float32) * scale \
        / np.float32(8)
    for r in collectives["res"]:
        err = np.abs(r["psum"] - want).max() / np.abs(want).max()
        assert err < 0.02, err
        np.testing.assert_array_equal(r["psum"], emul)


@pytest.mark.timeout(SPAWN_TIMEOUT)
def test_shard_keeps_the_block_distribute_tensor_keeps(collectives):
    """On (2, 2, 2): ``sharding.shard``'s block (``local_block``, held to
    JAX's device indices in test_torch_sharding) is the one
    ``distribute_tensor`` keeps with ``placements``."""
    mesh = ((2, 2, 2), ("pod", "data", "model"))
    for r in collectives["res"]:
        for (spec, full), (mine, dt) in zip(collectives["layout"],
                                            r["layout"]):
            want = full[tsharding.local_block(spec, full.shape, mesh,
                                              r["coord"])]
            np.testing.assert_array_equal(mine, want)
            np.testing.assert_array_equal(dt, want)


@pytest.mark.timeout(SPAWN_TIMEOUT)
def test_constrain_redistributes_a_dtensor(collectives):
    """Under ``ctx_mesh(mesh, "fsdp")`` "dp" is every axis: a replicated
    (8, 6) DTensor comes back split 8 ways on its rows."""
    full = collectives["layout"][0][1]
    mesh = ((2, 2, 2), ("pod", "data", "model"))
    for r in collectives["res"]:
        spec, local = r["constrain"]
        assert spec == (("pod", "data", "model"), None)
        np.testing.assert_array_equal(local, full[tsharding.local_block(
            spec, full.shape, mesh, r["coord"])])


# ---------------------------------------------------------------------------
# the sharded train step, (4, 2) and (2, 2) fsdp, and the elastic restore
# ---------------------------------------------------------------------------


def _cfgs(arch="llama3_8b", **kw):
    a = dataclasses.replace(jax_config.get_config(arch, reduced=True),
                            dtype="float32", **kw)
    b = dataclasses.replace(torch_config.get_config(arch, reduced=True),
                            dtype="float32", **kw)
    return a, b


def _trainer_order(cfg, tree):
    """The reference's weights ``tree`` (numpy) as tensors in the order of
    the trainer's ``param_list`` (``init_params``' layout; a model carried
    from the reference orders each layer's keys as JAX does)."""
    carried = dict(torch_lm.LM.from_reference(cfg, tree,
                                              "cpu").named_parameters())
    return [carried[n].detach() for n, _ in torch_lm.LM(
        cfg, tsteps.abstract_params(cfg)).named_parameters()]


def _step_zero(cfg, tree, ckpt_dir):
    """A checkpoint at step 0 of the weights ``tree`` (the reference's, as
    numpy) with fresh AdamW state: ``train`` resumes from it."""
    params = _trainer_order(cfg, tree)
    tckpt.save_checkpoint(ckpt_dir, 0, (params, adamw_init(params)))


def _template(cfg):
    params = [torch.empty(p.shape, dtype=p.dtype) for p in
              torch_lm.LM(cfg, tsteps.abstract_params(cfg)).param_list()]
    return params, adamw_init(params)


def _reference(root, arch="llama3_8b", **kw):
    """A reduced model (f32) from the reference's weights: the JAX step's
    3 steps (one device, jitted), the port's one-device trainer's, and the
    step-0 checkpoint both start from, under ``root``."""
    jcfg, tcfg = _cfgs(arch, **kw)
    params = jax_lm.init_params(jcfg, jax.random.key(11))
    tree = jax.tree.map(np.asarray, params)
    _step_zero(tcfg, tree, str(root / "zero"))
    opt = jax_optim.adamw_init(params)
    jstep = jax.jit(jax_steps.build_train_step(
        jcfg, jax_config.ShapeConfig("t", "train", SEQ, B),
        jax.make_mesh((1, 1), ("data", "model")))[0])
    ds = train_data(tcfg, SEQ, B)
    jl, jn = [], []
    for step in range(STEPS):
        params, opt, m = jstep(params, opt, ds.batch_at(step))
        jl.append(float(m["loss"]))
        jn.append(float(m["grad_norm"]))
    one = str(root / "one")
    shutil.copytree(root / "zero", one)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)    # as each rank: the suite's workers share cores
    try:
        single = ttrain.train(tcfg, steps=STEPS, batch=B, seq=SEQ,
                              ckpt_dir=one, device="cpu")
    finally:
        torch.set_num_threads(threads)
    return {"root": root, "tree": tree, "cfg": tcfg,
            "jax": {"losses": jl, "grad_norms": jn, "params":
                    _trainer_order(tcfg, jax.tree.map(np.asarray, params))},
            "single": {"losses": single["losses"],
                       "grad_norms": single["grad_norms"],
                       "params": [p.detach() for p in single["params"]],
                       "m": single["opt"]["m"], "v": single["opt"]["v"]}}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reduced llama3-8b (f32): ``_reference``."""
    return _reference(tmp_path_factory.mktemp("train"))


# the tensor-parallel train steps' models: (arch, config changes) by name
TP_MODELS = {"llama3_8b": ("llama3_8b", {}),
             "llama3_8b-chunked": ("llama3_8b", {"attn_impl": "chunked"}),
             "gemma_7b": ("gemma_7b", {}),
             "llama3_8b-8-heads": ("llama3_8b", {"n_heads": 8}),
             "rwkv6_3b": ("rwkv6_3b", {}),
             "deepseek_v2_236b": ("deepseek_v2_236b", {}),
             "kimi_k2_1t_a32b": ("kimi_k2_1t_a32b", {}),
             "jamba_1_5_large_398b": ("jamba_1_5_large_398b", {}),
             "whisper_small": ("whisper_small", {}),
             "paligemma_3b": ("paligemma_3b", {})}
# the meshes each runs on: (1, 4) splits the 8 q heads 2 a rank, each
# pair reading one of the 2 kv heads, which stay whole on "model"; the
# reduced rwkv6-3b's 2 heads of 64 split on (1, 2) and (2, 2), and are made
# whole on (1, 4) (32 columns a rank); deepseek-v2's 8 experts go 4 or 2 a
# rank, its MLA heads 2 or 1; kimi-k2's 4 q and 2 kv heads 2 and 1 a rank;
# jamba's 128 Mamba channels 64 or 32 a rank (its w_in columns exchanged),
# its 4 experts 2 or 1; whisper's 4 heads (its encoder's and cross
# attention's too) 2 or 1; paligemma's 4 q heads over its one kv head,
# which stays whole, and its image projection's 64 columns 32 or 16
TP_RUNS = [(m, s) for m in list(TP_MODELS)[:3] for s in ((1, 2), (2, 2))] \
    + [("llama3_8b-8-heads", (1, 4))] \
    + [("rwkv6_3b", s) for s in ((1, 2), (2, 2), (1, 4))] \
    + [("deepseek_v2_236b", s) for s in ((1, 2), (2, 2))] \
    + [("kimi_k2_1t_a32b", (2, 2))] \
    + [(m, s) for m in list(TP_MODELS)[7:] for s in ((2, 2), (1, 4))]


# the ZeRO-3 styles beside the (2, 2) "fsdp" run: (model, mesh, style);
# "fsdp" shards every weight and the batch over all four ranks of a
# (1, 4) mesh, "ep" DeepSeek-V2's experts over "model" and its other
# weights over "data", the batch over both; each layer's weights are
# gathered whole at the layer
ZERO_RUNS = [("llama3_8b", (1, 4), "fsdp"), ("rwkv6_3b", (1, 4), "fsdp"),
             ("deepseek_v2_236b", (2, 2), "ep")]
# the gradient-order step: the reduced llama3-8b (f32) at 4 layers,
# "fsdp" on (2, 2)
ORDER_LAYERS = 4
# an "fsdp" step on (2, 2) over a batch of 2 rows, which its 4 ranks do
# not split
UNSPLIT_B = 2


@pytest.fixture(scope="module")
def tp_references(reference, tmp_path_factory):
    """``_reference`` of each of TP_MODELS (the base llama3-8b's is
    ``reference``)."""
    return {name: reference if (arch, kw) == ("llama3_8b", {}) else
            _reference(tmp_path_factory.mktemp(name), arch, **kw)
            for name, (arch, kw) in TP_MODELS.items()}


def _sharded_job(reference, name, mesh_shape, **kw):
    """A ``sharded_train`` job from the step-0 checkpoint, and its run's
    description (``_sharded_run`` completes it)."""
    tcfg = dataclasses.replace(reference["cfg"], **kw)
    ckpt = str(reference["root"] / name)
    shutil.copytree(reference["root"] / "zero", ckpt)
    return (("sharded_train", (tcfg, mesh_shape, ckpt, STEPS, B, SEQ)),
            {"cfg": tcfg, "ckpt": ckpt,
             "mesh": (mesh_shape, ("data", "model"))})


def _sharded_run(run, ranks):
    params, opt = tckpt.restore_checkpoint(run["ckpt"], STEPS,
                                           _template(run["cfg"]))
    return {**run, "ranks": [r["sharded_train"] for r in ranks],
            "params": params, "opt": opt}


@pytest.fixture(scope="module")
def eight_ranks(reference):
    """8 ranks: the collectives, then the (4, 2) step."""
    inputs = _collective_inputs()
    job, run = _sharded_job(reference, "tp_4x2", (4, 2))
    ranks = workers.spawn(workers.several, 8,
                          str(reference["root"] / "eight"), [
                              ("collectives", (inputs["pipe"], inputs["x"],
                                               inputs["w"], inputs["grads"],
                                               inputs["layout"])), job])
    return {"collectives": inputs, "ranks": ranks,
            "run_4x2": _sharded_run(run, ranks)}


@pytest.fixture(scope="module")
def run_4x2(eight_ranks):
    return eight_ranks["run_4x2"]


@pytest.fixture(scope="module")
def four_ranks(reference, run_4x2, tp_references):
    """4 ranks on (2, 2): the "fsdp" step, the (4, 2) run's last checkpoint
    restored with the "fsdp" style's shardings, the prefill and decode
    steps (the "tp" style) on the reference's weights; the tensor-parallel
    steps of TP_RUNS on (2, 2) and (1, 4)."""
    job, run = _sharded_job(reference, "fsdp_2x2", (2, 2),
                            parallel_style="fsdp")
    _, fsdp = _cfgs(parallel_style="fsdp")
    _, tcfg = _cfgs()
    tokens = np.random.default_rng(5).integers(
        0, tcfg.vocab, (4, 16)).astype(np.int32)
    tree = _port_tree(tcfg, reference["tree"])
    tp_jobs, tp_runs = _tp_jobs(tp_references, 4)
    zero_jobs, zero_runs = _zero_jobs(tp_references)
    order_cfg = dataclasses.replace(fsdp, n_layers=ORDER_LAYERS)
    shared = _shared_mlp_case()
    decode = {key: _decode_case(*key) for key in DECODE_RUNS}
    ranks = workers.spawn(workers.several, 4,
                          str(reference["root"] / "four"), [
                              job,
                              ("elastic_restore", (fsdp, (2, 2),
                                                   run_4x2["ckpt"], STEPS)),
                              ("prefill_decode", (tcfg, (2, 2), tree,
                                                  tokens)),
                              ("shared_mlp", shared), *tp_jobs,
                              *zero_jobs,
                              ("gradient_order", (order_cfg, (2, 2), SEQ,
                                                  B)),
                              ("unsplit_train", (fsdp, (2, 2), STEPS,
                                                 UNSPLIT_B, SEQ)),
                              *((f"sharded_decode:{a}:{m}:{b}", (
                                  case["cfg"], m, case["tree"],
                                  case["batches"], DECODE_SMAX))
                                for (a, m, b), case in decode.items())])
    return {"run_2x2": _sharded_run(run, ranks), "tokens": tokens,
            "tree": tree, "cfg": tcfg,
            "restore": [r["elastic_restore"] for r in ranks],
            "prefill": [r["prefill_decode"] for r in ranks],
            "shared_mlp": (shared, [r["shared_mlp"] for r in ranks]),
            "tp": _tp_results(tp_runs, ranks),
            "zero": _tp_results(zero_runs, ranks),
            "order": [r["gradient_order"] for r in ranks],
            "unsplit": (fsdp, [r["unsplit_train"] for r in ranks]),
            "decode": {(a, m, b): (case, [r[f"sharded_decode:{a}:{m}:{b}"]
                                          for r in ranks])
                       for (a, m, b), case in decode.items()}}


def _shared_mlp_case():
    """(config, MoE layer, input) for ``workers.shared_mlp`` on 4 ranks:
    the reduced deepseek-v2 (f32) with its experts 40 wide, so that its
    one shared expert's width times the model axis is ``cfg.d_ff`` (160),
    as DeepSeek-V2's 2 x 1,536 times 4 is its 12,288: the ratio at which
    a whole shared MLP looks like a rank's share of ``cfg.d_ff``."""
    _, cfg = _cfgs("deepseek_v2_236b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           d_ff=40))
    assert cfg.moe.d_ff * cfg.moe.n_shared * 4 == cfg.d_ff
    layer = tlayers.init_moe(cfg, torch.Generator().manual_seed(3), "cpu")
    x = np.random.default_rng(4).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    return cfg, {k: ({n: t.numpy() for n, t in v.items()}
                     if isinstance(v, dict) else v.numpy())
                 for k, v in layer.items()}, x


def _tp_jobs(tp_references, world: int):
    """The ``sharded_train`` jobs of the TP_RUNS on ``world`` ranks (each
    under its own name: ``several`` keys results by name) and their runs'
    descriptions."""
    jobs, runs = [], {}
    for name, shape in TP_RUNS:
        if shape[0] * shape[1] != world:
            continue
        key = f"tp_{name}_{shape[0]}x{shape[1]}"
        (_, args), run = _sharded_job(tp_references[name], key, shape)
        jobs.append((f"sharded_train:{key}", args))
        runs[key] = {**run, "reference": tp_references[name]}
    return jobs, runs


def _zero_jobs(tp_references):
    """The ``sharded_train`` jobs of ZERO_RUNS and their runs'
    descriptions, as ``_tp_jobs``'."""
    jobs, runs = [], {}
    for name, shape, style in ZERO_RUNS:
        key = f"{style}_{name}_{shape[0]}x{shape[1]}"
        (_, args), run = _sharded_job(tp_references[name], key, shape,
                                      parallel_style=style)
        jobs.append((f"sharded_train:{key}", args))
        runs[key] = {**run, "reference": tp_references[name]}
    return jobs, runs


def _tp_results(runs, ranks):
    return {key: _sharded_run(run, [{"sharded_train": r[
        f"sharded_train:{key}"]} for r in ranks])
        for key, run in runs.items()}


@pytest.fixture(scope="module")
def run_2x2(four_ranks):
    return four_ranks["run_2x2"]


@pytest.fixture(scope="module")
def tp_runs(four_ranks, tp_references):
    """Every run of TP_RUNS: those on 4 ranks from ``four_ranks``, those on
    (1, 2) from 2 ranks of their own."""
    jobs, runs = _tp_jobs(tp_references, 2)
    ranks = workers.spawn(workers.several, 2, str(
        tp_references["llama3_8b"]["root"] / "two"), jobs)
    return {**four_ranks["tp"], **_tp_results(runs, ranks)}


def _param_atol():
    """How far one parameter may move apart between two reductions of the
    same gradients: a gradient near zero may change sign across summation
    orders, and AdamW's normalised step |m^ / sqrt(v^)| is then at most
    sqrt(sum_i a_i^2 / c_i) (Cauchy-Schwarz over the moments' weights a_i,
    c_i) in either direction, times each step's rate; plus 1e-7 of
    rounding (parameters are O(1) at most)."""
    b1, b2 = 0.9, 0.95
    total = 0.0
    for step in range(STEPS):
        t = step + 1
        a = [(1 - b1) * b1 ** (t - i) / (1 - b1 ** t) for i in range(1, t + 1)]
        c = [(1 - b2) * b2 ** (t - i) / (1 - b2 ** t) for i in range(1, t + 1)]
        bound = sum(x * x / y for x, y in zip(a, c)) ** 0.5
        total += 2 * float(cosine_schedule(step)) * bound
    return total + 1e-7


# the models whose one-device port's gradient norms drift from the JAX
# step's by more than LOSS_RTOL within STEPS steps (Jamba: its f32
# gradients through Mamba's decays move ~2e-6 relative at step 0 under any
# other order of the sums, the port's scan's or a model axis's, and AdamW's
# normalised steps grow that to 1.4e-5 by step 2): their runs' norms are
# held to JAX's within LOSS_RTOL beyond that drift, step by step
DRIFTING_NORMS = ("jamba-1.5-large-398b",)


def _holds_the_reference(run, reference):
    """Losses and gradient norms (a gradient summed over replicas that
    hold the same batch would double the norm) within 1e-5 of the
    one-device port's and the JAX step's (for DRIFTING_NORMS, the norms
    within 1e-5 beyond the one-device port's own distance from JAX's);
    parameters within ``_param_atol``."""
    single, jax_ = reference["single"], reference["jax"]
    drift = np.abs(np.subtract(single["grad_norms"], jax_["grad_norms"])) \
        / np.abs(jax_["grad_norms"]) \
        if run["cfg"].name in DRIFTING_NORMS else 0.0
    for r in run["ranks"]:
        for want in (single, jax_):
            np.testing.assert_allclose(r["losses"], want["losses"],
                                       rtol=LOSS_RTOL, atol=0)
        np.testing.assert_allclose(r["grad_norms"], single["grad_norms"],
                                   rtol=LOSS_RTOL, atol=0)
        np.testing.assert_array_less(
            np.abs(np.subtract(r["grad_norms"], jax_["grad_norms"])),
            (LOSS_RTOL + drift) * np.abs(jax_["grad_norms"]))
    atol = _param_atol()
    assert 0 < atol < 5e-5
    for want in (reference["single"]["params"], reference["jax"]["params"]):
        for i, (p, w) in enumerate(zip(run["params"], want)):
            torch.testing.assert_close(p, w, rtol=0, atol=atol,
                                       msg=f"parameter {i}")
    assert int(run["opt"]["count"]) == STEPS


def _stores_its_share(run):
    mesh = run["mesh"]
    model = torch_lm.LM(run["cfg"], tsteps.abstract_params(run["cfg"]))
    specs = tsharding.param_list_specs(run["cfg"], model, mesh)
    sharded = 0
    for r in run["ranks"]:
        assert r["global"] == [tuple(p.shape) for p in model.param_list()]
        want = [tuple(s.stop - s.start for s in tsharding.local_block(
            spec, shp, mesh, r["coord"])) for spec, shp in zip(
                specs, r["global"])]
        for k in ("params", "m", "v"):
            assert r["local"][k] == want, k
        sharded = sum(w != g for w, g in zip(want, r["global"]))
    assert sharded >= len(specs) // 2     # most tensors really split


@pytest.mark.timeout(SPAWN_TIMEOUT)
def test_sharded_train_4x2_matches_one_device_and_jax(run_4x2, reference):
    """(4, 2), style "tp": the batch over 4 data ranks, the heads, FFN
    columns and vocabulary over the model axis's 2 ranks."""
    _holds_the_reference(run_4x2, reference)


@pytest.mark.timeout(SPAWN_TIMEOUT)
def test_sharded_train_4x2_stores_only_its_share(run_4x2):
    _stores_its_share(run_4x2)


@pytest.mark.timeout(SPAWN_TIMEOUT)
def test_sharded_train_2x2_fsdp_matches_one_device_and_jax(run_2x2,
                                                           reference):
    """(2, 2), style "fsdp": the batch and every weight over all 4 ranks."""
    _holds_the_reference(run_2x2, reference)


@pytest.mark.timeout(SPAWN_TIMEOUT)
def test_sharded_train_2x2_fsdp_stores_only_its_share(run_2x2):
    _stores_its_share(run_2x2)


@pytest.mark.timeout(SPAWN_TIMEOUT)
@pytest.mark.parametrize("name,shape,style", ZERO_RUNS)
def test_zero3_styles_match_one_device_and_jax(four_ranks, name, shape,
                                              style):
    """Styles "fsdp" on (1, 4) (llama3-8b, rwkv6-3b) and "ep" on (2, 2)
    (DeepSeek-V2, its experts' blocks over both axes gathered in one
    all-gather): every layer's weights gathered whole at the layer, each
    gradient reduce-scattered to its shard in the gather's backward; the
    losses and norms of the one-device port and of the JAX step, the
    parameters within the AdamW bound, each rank storing its share."""
    run = four_ranks["zero"][f"{style}_{name}_{shape[0]}x{shape[1]}"]
    assert run["cfg"].parallel_style == style
    _holds_the_reference(run, run["reference"])
    _stores_its_share(run)


@pytest.mark.timeout(SPAWN_TIMEOUT)
def test_fsdp_with_a_batch_its_ranks_do_not_split(four_ranks):
    """"fsdp" on (2, 2) over 2 rows: the batch is not split, each rank
    computes the whole step, and each gradient, whole on every rank, is
    cut to the rank's shard (no sum): the one-device losses and gradient
    norms within LOSS_RTOL."""
    cfg, ranks = four_ranks["unsplit"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = ttrain.train(cfg, steps=STEPS, batch=UNSPLIT_B, seq=SEQ,
                           log_every=STEPS, device="cpu")
    finally:
        torch.set_num_threads(threads)
    for r in ranks:
        np.testing.assert_allclose(r["losses"], one["losses"],
                                   rtol=LOSS_RTOL, atol=0)
        np.testing.assert_allclose(r["grad_norms"], one["grad_norms"],
                                   rtol=LOSS_RTOL, atol=0)


@pytest.mark.timeout(SPAWN_TIMEOUT)
def test_each_layers_gradient_reaches_its_shard_before_the_next_layer(
        four_ranks):
    """An "fsdp" step on (2, 2) at 4 layers, in the order autograd runs it
    on every rank: the head's gradient is reduce-scattered (and the final
    norm's all-reduced) before the last layer's backward starts; between
    the start of layer i's backward and layer i - 1's, layer i's weights
    are brought back to their shards, all of them (7 reduce-scattered
    over both axes, the 2 norms all-reduced), before any layer below
    runs; the embedding's last.  A step that reduced the gradients after
    the whole backward would log every reduction after layer 0's start."""
    for r in four_ranks["order"]:
        assert r["layers"] == ORDER_LAYERS
        log = r["log"]
        starts = [i for i, e in enumerate(log) if e[0] == "layer"]
        assert [log[i][1] for i in starts] == list(range(ORDER_LAYERS))[
            ::-1]
        bounds = [0, *starts, len(log)]
        groups = [log[a + (a > 0):b] for a, b in zip(bounds, bounds[1:])]
        assert all(e[0] == "reduce" for g in groups for e in g)
        head, *layers = groups
        assert [(e[2], e[3]) for e in head] == [((0, 1), ()), ((), (0, 1))]
        last = layers.pop()
        assert [(e[2], e[3]) for e in last[-1:]] == [((0, 1), ())]
        layers.append(last[:-1])
        for g in layers:
            assert sorted((e[2], e[3]) for e in g) == sorted(
                [((0, 1), ())] * 7 + [((), (0, 1))] * 2)
            assert len({e[1] for e in g}) >= 5


@pytest.mark.timeout(SPAWN_TIMEOUT)
@pytest.mark.parametrize("name,shape", TP_RUNS)
def test_tensor_parallel_train_matches_one_device_and_jax(tp_runs, name,
                                                          shape):
    """Style "tp", the dense family: each rank computes its share of the
    heads, FFN columns and vocabulary, the batch split over "data": the
    losses and gradient norms of the one-device port and of the JAX step,
    the parameters within the AdamW bound."""
    run = tp_runs[f"tp_{name}_{shape[0]}x{shape[1]}"]
    arch, kw = TP_MODELS[name]
    assert run["cfg"] == _cfgs(arch, **kw)[1]   # the named model's own
    _holds_the_reference(run, run["reference"])


@pytest.mark.timeout(SPAWN_TIMEOUT)
@pytest.mark.parametrize("name,shape", TP_RUNS)
def test_tensor_parallel_train_stores_only_its_share(tp_runs, name, shape):
    _stores_its_share(tp_runs[f"tp_{name}_{shape[0]}x{shape[1]}"])


@pytest.mark.timeout(SPAWN_TIMEOUT)
@pytest.mark.parametrize("name,shape", TP_RUNS)
def test_tensor_parallel_train_keeps_model_replicas_equal(tp_runs, name,
                                                          shape):
    """After the steps every parameter whole on "model" (norms, RWKV's
    mixes, MLA's down projections, the router, a weight whose heads do
    not divide the axis) holds the same bits on each rank of a "model"
    row: its gradient was the whole gradient on every rank.  A replicated
    activation entering the split region before the last op on such a
    parameter would leave its gradient a partial sum, and each rank's
    AdamW step then moves it apart."""
    run = tp_runs[f"tp_{name}_{shape[0]}x{shape[1]}"]
    model = torch_lm.LM(run["cfg"], tsteps.abstract_params(run["cfg"]))
    names = [n for n, _ in model.named_parameters()]
    specs = tsharding.param_list_specs(run["cfg"], model, run["mesh"])
    whole = [i for i, sp in enumerate(specs)
             if not any("model" in tsharding._axes(e) for e in sp)]
    assert whole
    rows = {}
    for r in run["ranks"]:
        rows.setdefault(r["coord"][0], []).append(r)
    assert all(len(v) == shape[1] for v in rows.values())
    for ranks in rows.values():
        for i in whole:
            for r in ranks[1:]:
                np.testing.assert_array_equal(
                    r["blocks"][i], ranks[0]["blocks"][i],
                    err_msg=f"{names[i]} on {r['coord']}")


@pytest.mark.timeout(SPAWN_TIMEOUT)
@pytest.mark.parametrize("case", ["whole", "split"])
def test_shared_mlp_takes_its_width_from_the_moe_layer(four_ranks, case):
    """Under a 4-way model axis the MoE layer's shared MLP (40 wide, a
    quarter of ``cfg.d_ff``) gives the one-device output, whole (it is no
    share of ``cfg.d_ff``: summing it over the axis would count it 4 times)
    and split as the rule tables lay it out (10 columns a rank)."""
    (cfg, layer, x), ranks = four_ranks["shared_mlp"]
    with torch.no_grad():
        want = tlayers.moe_forward(cfg, workers._tensors(layer),
                                   torch.from_numpy(x)).numpy()
    for r in ranks:
        got = r[case]
        assert not isinstance(got, str), got
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _one_rank_is_bitwise(reference, tmp_path, style="tp"):
    """At one rank (a (1, 1) gloo mesh in this process) the
    tensor-parallel step (or ``style``'s) runs the one-device step's ops
    in the same order: losses, gradient norms, parameters and moments
    bitwise."""
    cfg = dataclasses.replace(reference["cfg"], parallel_style=style)
    ckpt = str(tmp_path / "ckpt")
    shutil.copytree(reference["root"] / "zero", ckpt)
    tmesh.init_distributed("cpu", rank=0, world_size=1,
                           store=dist.FileStore(str(tmp_path / "store"), 1))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # as the one-device run
    try:
        mesh = tmesh.make_test_mesh(1, 1, device="cpu")
        assert tsteps._tensor_parallel(cfg, mesh) == (style == "tp")
        got = ttrain.train(cfg, steps=STEPS, batch=B, seq=SEQ,
                           ckpt_dir=ckpt, device="cpu", mesh=mesh)
    finally:
        torch.set_num_threads(threads)
        dist.destroy_process_group()
    want = reference["single"]
    assert got["losses"] == want["losses"]
    assert got["grad_norms"] == want["grad_norms"]
    for a, b in zip([*got["params"], *got["opt"]["m"], *got["opt"]["v"]],
                    [*want["params"], *want["m"], *want["v"]]):
        assert torch.equal(a.to_local(), b)


@pytest.mark.timeout(SPAWN_TIMEOUT)
def test_tensor_parallel_train_1x1_is_the_one_device_step_bitwise(
        reference, tmp_path):
    """The reduced llama3-8b: ``_one_rank_is_bitwise``."""
    _one_rank_is_bitwise(reference, tmp_path)


@pytest.mark.timeout(SPAWN_TIMEOUT)
@pytest.mark.parametrize("name,style", [("llama3_8b", "fsdp"),
                                        ("rwkv6_3b", "fsdp"),
                                        ("deepseek_v2_236b", "ep")])
def test_zero3_train_1x1_is_the_one_device_step_bitwise(
        tp_references, tmp_path, name, style):
    """The "fsdp" and "ep" styles at one rank: nothing to gather, the
    one-device step's ops (``_one_rank_is_bitwise``)."""
    _one_rank_is_bitwise(tp_references[name], tmp_path, style)


@pytest.mark.timeout(SPAWN_TIMEOUT)
@pytest.mark.parametrize("name", ["rwkv6_3b", "deepseek_v2_236b",
                                  "kimi_k2_1t_a32b", "jamba_1_5_large_398b",
                                  "whisper_small", "paligemma_3b"])
def test_tensor_parallel_train_1x1_is_bitwise_for_ssm_and_moe(
        tp_references, tmp_path, name):
    """RWKV-6, DeepSeek-V2, Kimi-K2 and the last families (Jamba, Whisper,
    PaliGemma) at one rank: ``_one_rank_is_bitwise``."""
    _one_rank_is_bitwise(tp_references[name], tmp_path)


@pytest.mark.timeout(SPAWN_TIMEOUT)
def test_elastic_restore_from_4x2_onto_2x2_and_one_process(run_4x2,
                                                           four_ranks):
    """The (4, 2) run's last checkpoint restored onto a (2, 2) mesh with
    the "fsdp" style's shardings (each rank's blocks exact) and onto one
    process (every leaf exact)."""
    with np.load(os.path.join(run_4x2["ckpt"], f"step_{STEPS:08d}",
                              "arrays.npz")) as data:
        stored = [data[f"leaf_{i}"] for i in range(len(data.files))]
    n = len(run_4x2["params"])
    # leaves: the parameters, then the moments by key: count, m, v
    params, m = stored[:n], stored[n + 1:2 * n + 1]
    for got, want in zip(run_4x2["params"], params):
        np.testing.assert_array_equal(got.numpy(), want)
    ranks = four_ranks["restore"]
    mesh = ((2, 2), ("data", "model"))
    split = 0
    for r in ranks:
        assert r["count"] == STEPS
        for spec, got, want, gm, wm in zip(r["specs"], r["params"], params,
                                           r["m"], m):
            ix = tsharding.local_block(spec, want.shape, mesh, r["coord"])
            np.testing.assert_array_equal(got, want[ix])
            np.testing.assert_array_equal(gm, wm[ix])
            split += got.shape != want.shape
        assert r["sharded"] > 0
    assert split > 0


# ---------------------------------------------------------------------------
# the sharded prefill and decode steps
# ---------------------------------------------------------------------------


@pytest.mark.timeout(SPAWN_TIMEOUT)
def test_sharded_prefill_and_decode_match_one_device(four_ranks):
    """``build(cfg, shape, mesh)``'s prefill and decode steps on a (2, 2)
    mesh: each rank's block of the logits against the one-device
    ``lm.forward`` and ``lm.decode_step`` on the same weights."""
    tcfg, tokens, tree = (four_ranks[k] for k in ("cfg", "tokens", "tree"))
    ranks = four_ranks["prefill"]
    model = torch_lm.LM(tcfg, workers._tensors(tree))
    with torch.no_grad():
        want = torch_lm.forward(tcfg, model, {"tokens": torch.from_numpy(
            tokens)}).numpy()
        cache = model.init_cache(*tokens.shape)
        dec = []
        for t in range(2):
            lg, cache = torch_lm.decode_step(tcfg, model, cache, {
                "token": torch.from_numpy(tokens[:, t:t + 1]),
                "pos": torch.full((4,), t, dtype=torch.int32)})
            dec.append(lg.numpy())
    mesh = ((2, 2), ("data", "model"))
    for r in ranks:
        ix = tsharding.local_block(r["bspec"], want.shape, mesh, r["coord"])
        assert r["prefill"].shape[0] == 2          # the batch split in two
        np.testing.assert_allclose(r["prefill"], want[ix], rtol=1e-5,
                                   atol=1e-5)
        for got, w in zip(r["decode"], dec):
            ix = tsharding.local_block(r["dbspec"], w.shape, mesh,
                                       r["coord"])
            np.testing.assert_allclose(got, w[ix], rtol=1e-5, atol=1e-5)


# every family's decode step: (arch, mesh, batch); a batch of 4 splits over
# "data" and the cache's 16 positions over "model" (blocks of 8 on (2, 2),
# of 4 on (1, 4)); a batch of one row leaves them on "data" (blocks of 8)
DECODE_ARCHS = ("llama3_8b", "rwkv6_3b", "deepseek_v2_236b",
                "kimi_k2_1t_a32b", "jamba_1_5_large_398b", "whisper_small",
                "paligemma_3b")
DECODE_RUNS = [(a, m, b) for a in DECODE_ARCHS
               for m, b in (((2, 2), 4), ((1, 4), 4), ((2, 2), 1))]
DECODE_SMAX, DECODE_STEPS = 16, 4
# each row's first position: rows 0-2 cross a block edge within the steps
# (8 on both meshes, 4 on (1, 4)), row 3 runs past the cache's end and is
# clamped to its last position; one row crosses 8
DECODE_STARTS = {4: (5, 6, 3, 14), 1: (6,)}


def _decode_case(arch, mesh, rows):
    """The reduced ``arch`` (f32), weights drawn from a seeded generator
    (numpy, the port's layout), and DECODE_STEPS batches of ``rows`` rows
    (frames too for Whisper)."""
    _, cfg = _cfgs(arch)
    tree = _numpy_tree(torch_lm.init_params(
        cfg, torch.Generator().manual_seed(3), "cpu"))
    rng = np.random.default_rng(7)
    batches = []
    for t in range(DECODE_STEPS):
        b = {"token": rng.integers(0, cfg.vocab, (rows, 1)).astype(np.int32),
             "pos": np.asarray(DECODE_STARTS[rows], np.int32) + t}
        if cfg.family == "encdec":
            b["frames"] = rng.standard_normal(
                (rows, cfg.enc_seq, cfg.d_model)).astype(np.float32)
        batches.append(b)
    return {"cfg": cfg, "tree": tree, "batches": batches}


def _one_device_decode(case):
    """``lm.decode_step`` over the case's batches from a zero cache: each
    step's logits and the last cache, as numpy."""
    cfg = case["cfg"]
    model = torch_lm.LM(cfg, workers._tensors(case["tree"]))
    cache = model.init_cache(case["batches"][0]["token"].shape[0],
                             DECODE_SMAX)
    logits = []
    with torch.no_grad():
        for b in case["batches"]:
            lg, cache = torch_lm.decode_step(cfg, model, cache, {
                k: torch.from_numpy(v) for k, v in b.items()})
            logits.append(lg.numpy())
    return logits, [{k: t.numpy() for k, t in c.items()}
                    for c in cache["blocks"]]


@pytest.mark.timeout(SPAWN_TIMEOUT)
@pytest.mark.parametrize("arch,mesh,rows", DECODE_RUNS)
def test_sharded_decode_matches_one_device(four_ranks, arch, mesh, rows):
    """Every family's sharded decode step over DECODE_STEPS steps: each
    rank attends over its block of the cache's positions (on "model" with
    the batch over "data"; on "data" for one row), writes a row's new
    keys where its block holds the row's position (clamped) and updates
    its heads' or channels' states; each rank's block of every step's
    logits and of the last cache, against ``lm.decode_step`` on the same
    weights within 1e-5 (f32) of the tensor's largest entry: the splits
    sum in other orders, and a logit near 0 moves by the rounding of the
    large ones (Jamba's Mamba states carry it from step to step)."""
    case, ranks = four_ranks["decode"][(arch, mesh, rows)]
    want, cache = _one_device_decode(case)
    shape = (mesh, ("data", "model"))

    def close(got, w, what):
        np.testing.assert_allclose(got, w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=what)
    for r in ranks:
        for t, (got, w) in enumerate(zip(r["logits"], want)):
            ix = tsharding.local_block(r["bspec"], w.shape, shape,
                                       r["coord"])
            assert got.shape == w[ix].shape
            close(got, w[ix], f"logits of step {t}")
        for got, spec, w in zip(r["cache"], r["cspecs"]["blocks"], cache):
            for k, t in got.items():
                ix = tsharding.local_block(spec[k], w[k].shape, shape,
                                           r["coord"])
                close(t, w[k][ix], k)


@pytest.mark.timeout(SPAWN_TIMEOUT)
@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_sharded_decode_1x1_is_the_one_device_step_bitwise(tmp_path, arch):
    """At one rank (a (1, 1) gloo mesh in this process) the sharded decode
    step runs the one-device step's ops: every step's logits and the last
    cache bitwise."""
    case = _decode_case(arch, (1, 1), 4)
    want, cache = _one_device_decode(case)
    tmesh.init_distributed("cpu", rank=0, world_size=1,
                           store=dist.FileStore(str(tmp_path / "store"), 1))
    try:
        got = workers.sharded_decode(0, str(tmp_path), case["cfg"], (1, 1),
                                     case["tree"], case["batches"],
                                     DECODE_SMAX)
    finally:
        dist.destroy_process_group()
    for a, b in zip(got["logits"], want):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got["cache"], cache):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy_tree(v) for v in tree]
    return tree.numpy()


def _port_tree(cfg, tree):
    """The reference's weights in the port's layout, as numpy."""
    return _numpy_tree(torch_lm.params_from_reference(cfg, tree, "cpu"))


# ---------------------------------------------------------------------------
# no fallback
# ---------------------------------------------------------------------------


def test_the_card_or_nccl_missing_raises(tmp_path, monkeypatch):
    """Asking for the card without one raises everywhere; with a card
    claimed, NCCL that cannot start raises, and a gloo group is never
    taken for a "cuda" mesh."""
    _, cfg = _cfgs()
    store = lambda n: dist.FileStore(str(tmp_path / n), 1)  # noqa: E731
    if torch.cuda.is_available():
        pytest.skip("a card is present: the raise is for its absence")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.init_distributed("cuda", rank=0, world_size=1,
                               store=store("a"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_test_mesh(1, 1, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.train(cfg, steps=1, batch=2, seq=8, device="cuda")
    assert not dist.is_initialized()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_nccl_available", lambda: True)
    with pytest.raises((RuntimeError, ValueError)):
        tmesh.init_distributed("cuda", rank=0, world_size=1,
                               store=store("b"))
    assert not dist.is_initialized()
    tmesh.init_distributed("cpu", rank=0, world_size=1, store=store("c"))
    try:
        with pytest.raises(RuntimeError, match="runs gloo"):
            tmesh.init_distributed("cuda")
        with pytest.raises(RuntimeError, match="runs gloo"):
            tmesh.make_test_mesh(1, 1, device="cuda")
        mesh = tmesh.make_test_mesh(1, 1, device="cpu")
        with pytest.raises(ValueError, match="cpu mesh"):
            ttrain.train(cfg, steps=1, batch=2, seq=8, device="cuda",
                         mesh=mesh)
    finally:
        dist.destroy_process_group()
