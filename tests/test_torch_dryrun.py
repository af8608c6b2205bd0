"""The port's dry-run (``repro_torch.launch.dryrun``) on reduced
configurations at the meshes (1, 1), (2, 2) and (16, 16), each on a fake
group of its size: the record's keys are the reference's; the analyzer's
flops are ``FlopCounterMode``'s; dense prefills at (1, 1) count the
reference's HLO dot flops exactly; the dense, RWKV-6 and MoE families'
tensor-parallel train and prefill steps split their work over both axes,
their (2, 2) flops equal to the reference's compiled step's, or apart from
it by the terms XLA splits on weights whole on "model"; RWKV-6's heads
made whole where they do not divide the model axis; elsewhere the "model"
axis replicates work and the "data" axis splits it; all-gather bytes and
the arguments' bytes follow the specs; K4 and K5 appear as operator nodes; no
process group is left behind; ``main`` writes, caches, skips and records
failures as the reference's does.  Beside it, the kernels' operators: on
CPU tensors the plain versions bitwise, and the card raised for where there
is none."""
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import config as jax_config
from repro.launch import hlo_analysis as jha
from repro.launch import steps as jax_steps
from repro.models import api as jax_api
from repro.models import lm as jax_lm
from repro_torch.config import ShapeConfig, get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import wkv6 as wk
from repro_torch.launch import dryrun
from repro_torch.launch import steps
from repro_torch.parallel import sharding

# the reference's record (``repro.launch.dryrun.dryrun_cell``), key by key
REFERENCE_KEYS = ["arch", "shape", "mesh", "n_devices", "flops_per_device",
                  "hbm_bytes_per_device", "collective_bytes_per_device",
                  "while_trips", "entry_cost_analysis", "memory",
                  "compile_seconds", "model_params", "active_params",
                  "seq_len", "global_batch", "kind"]
MEMORY_KEYS = ["argument_size", "output_size", "temp_size",
               "generated_code_size"]
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model"))}
CONFIGS = [("llama3_8b", "dense"), ("llama3_8b", "chunked"),
           ("gemma_7b", "dense"), ("gemma_7b", "chunked"),
           ("rwkv6_3b", "dense"), ("deepseek_v2_236b", "dense"),
           ("deepseek_v2_236b", "chunked")]
KINDS = ("train", "prefill", "decode")
S, B = 64, 16                    # tokens, global batch (splits over 16)
CELLS = [(a, i, k, m) for a, i in CONFIGS for k in KINDS for m in MESHES]
# meshes traced for one test each, beside MESHES
MORE_MESHES = {"1x4": ((1, 4), ("data", "model"))}


@pytest.fixture(autouse=True)
def _port_fault_free():
    from repro_torch.core import faults
    faults.reset()
    yield
    faults.reset()
    assert not dist.is_initialized()


def _cfg(arch, impl):
    return dataclasses.replace(get_config(arch, reduced=True),
                               attn_impl=impl)


def _shape(kind):
    return ShapeConfig("t", kind, S, B)


@functools.lru_cache(maxsize=None)
def _cell(arch, impl, kind, mesh):
    """(the record, the port's operator nodes by name) of one cell; the
    fake group gone after."""
    cfg = _cfg(arch, impl)
    with dryrun.dryrun_mesh(*{**MESHES, **MORE_MESHES}[mesh]) as m:
        tr = dryrun.trace_step(cfg, _shape(kind), m)
        rec = dryrun.record(arch, "t", mesh, cfg, _shape(kind), m, tr)
    assert not dist.is_initialized()
    ops = {}
    for n in tr.gm.graph.nodes:
        name = str(n.target)
        if name.startswith("repro_torch."):
            ops[name] = ops.get(name, 0) + 1
    return rec, ops


@pytest.mark.parametrize("arch,impl,kind,mesh", CELLS)
def test_cell_records_the_references_keys_and_torchs_flops(arch, impl, kind,
                                                           mesh):
    rec, _ = _cell(arch, impl, kind, mesh)
    assert list(rec) == REFERENCE_KEYS
    assert list(rec["memory"]) == MEMORY_KEYS
    assert rec["n_devices"] == math.prod(MESHES[mesh][0])
    assert rec["flops_per_device"] > 0
    assert rec["flops_per_device"] == rec["entry_cost_analysis"]["flops"]
    assert rec["hbm_bytes_per_device"] > 0 and rec["memory"]["temp_size"] > 0
    assert (rec["seq_len"], rec["global_batch"], rec["kind"]) == (S, B, kind)
    json.dumps(rec)


@pytest.mark.parametrize("arch", ["llama3_8b", "gemma_7b",
                                  "deepseek_v2_236b"])
def test_dense_prefill_counts_the_references_dot_flops(arch):
    """At (1, 1) the dense prefill's graph holds the reference's matrix
    products: its flops equal the reference analyzer's count of
    ``jax.jit(lm.forward)``'s compiled text on the same reduced config.
    (RWKV is left out: K5 counts by its formula, the reference's chunk
    form by its products.)"""
    jcfg = jax_config.get_config(arch, reduced=True)
    jshape = jax_config.ShapeConfig("t", "prefill", S, B)
    text = jax.jit(lambda p, b: jax_lm.forward(jcfg, p, b)).lower(
        jax_steps.abstract_params(jcfg),
        jax_api.input_specs(jcfg, jshape)).compile().as_text()
    rec, _ = _cell(arch, "dense", "prefill", "1x1")
    assert rec["flops_per_device"] == jha.analyze(text)["flops"]


def _tensor_parallel(arch, kind):
    """Whether the cell's step computes on its model shards: the dense,
    "ssm" and "moe" families' train and prefill steps (style "tp")."""
    return _cfg(arch, "dense").family in ("dense", "ssm", "moe") \
        and kind != "decode"


def _latent_width(cfg) -> int:
    """The columns of MLA's down projections ``wdq`` and ``wdkv``
    together (0 without MLA)."""
    m = cfg.mla
    return m.q_lora_rank + m.kv_lora_rank + m.rope_head_dim if m else 0


def _whole_on_model_flops(cfg, kind, tokens: int) -> int:
    """The flops of the products with weights whole on "model" that a
    tensor-parallel step computes whole on every model rank, on
    ``tokens`` tokens: MLA's ``h @ wdq`` and ``h @ wdkv`` and the
    router's ``h @ router``.  A prefill does each once; a train step four
    times (the forward, again under remat "full", the input's gradient
    and the weight's)."""
    width = sum(_latent_width(cfg) * (cfg.layer_kind(i) == "mla")
                + cfg.moe.n_experts * cfg.is_moe_layer(i)
                for i in range(cfg.n_layers)) if cfg.moe else 0
    return 2 * tokens * cfg.d_model * width * (4 if kind == "train" else 1)


def _xla_model_splits(cfg, kind, tokens: int) -> int:
    """The flops by which the reference's (2, 2) step, as XLA partitions
    it, does less than the port's on a device of ``tokens`` tokens: XLA
    splits work on weights whole on "model" between the two model ranks
    where the port repeats it on each (PERF.md §6).  In a train step half
    of each such weight's gradient (``wdq`` and ``wdkv`` in every MLA
    layer, the router in every MoE layer), and half of the dense prefix
    layer's ``h @ wdq`` and ``h @ wdkv``, which the reference applies
    outside its scan: in its forward (a prefill) and again under remat
    (a train step)."""
    prefix = cfg.dense_prefix_layers * tokens * cfg.d_model \
        * _latent_width(cfg)
    if kind == "prefill":
        return prefix
    n_mla = sum(cfg.layer_kind(i) == "mla" for i in range(cfg.n_layers))
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    return 2 * prefix + tokens * cfg.d_model * (
        n_mla * _latent_width(cfg)
        + (n_moe * cfg.moe.n_experts if cfg.moe else 0))


# the reference's (2, 2) cells: its steps compiled by XLA on 4 host devices
# of a child process (``repro.launch.dryrun`` asks for 512 when imported),
# the mesh's axes ``Auto`` (JAX 0.9.0's ``make_mesh`` makes them
# ``Explicit``, on which the reference's ``constrain`` raises: ROADMAP's
# R6), read by the reference's analyzer
_REFERENCE_2X2 = """
import dataclasses, json, sys
from repro.launch import dryrun
import jax
from jax.sharding import AxisType
from repro import config
from repro.launch import hlo_analysis
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2,
                     devices=jax.devices()[:4])
out = {}
for arch, kind in json.loads(sys.argv[1]):
    cfg = dataclasses.replace(config.get_config(arch, reduced=True),
                              attn_impl="dense")
    shape = config.ShapeConfig("t", kind, %d, %d)
    text = dryrun._compile_cell(cfg, shape, mesh).as_text()
    out[arch + ":" + kind] = hlo_analysis.analyze(text)["flops"]
print(json.dumps(out))
""" % (S, B)
TP_CELLS = [(a, k) for a in ("llama3_8b", "gemma_7b", "deepseek_v2_236b",
                          "kimi_k2_1t_a32b")
            for k in ("train", "prefill")]


@pytest.fixture(scope="session")
def reference_2x2():
    """{"arch:kind": the reference's flops a device} of TP_CELLS on
    (2, 2), from one child process."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(root, "src"))
    done = subprocess.run([sys.executable, "-c", _REFERENCE_2X2,
                           json.dumps(TP_CELLS)], env=env, cwd=root,
                          capture_output=True, text=True, timeout=240)
    assert done.returncode == 0, done.stderr[-3000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


@pytest.mark.timeout(300)
@pytest.mark.parametrize("arch,kind", TP_CELLS)
def test_model_axis_flops_equal_the_references(reference_2x2, arch, kind):
    """The tensor-parallel train and prefill steps at (2, 2): a device's
    flops are the reference's compiled step's (dense attention, which the
    reference's analyzer counts as the port's), exactly for the dense
    family and Kimi-K2's prefill; for DeepSeek-V2 and Kimi-K2's train
    step, apart by exactly the products XLA splits on weights whole on
    "model" (``_xla_model_splits``: the latents' and router's weight
    gradients, DeepSeek-V2's prefix latents)."""
    rec, _ = _cell(arch, "dense", kind, "2x2")
    extra = _xla_model_splits(_cfg(arch, "dense"), kind, B // 2 * S)
    assert extra == 0 or arch in ("deepseek_v2_236b", "kimi_k2_1t_a32b")
    assert rec["flops_per_device"] == reference_2x2[f"{arch}:{kind}"] \
        + extra


@pytest.mark.parametrize("arch,impl,kind", [(a, i, k) for a, i in CONFIGS
                                            for k in KINDS])
def test_data_axis_splits_the_work_model_axis_replicates_it(arch, impl,
                                                           kind):
    """The dense, RWKV-6 and MoE families' train and prefill steps split
    the batch over "data" and the heads, FFN and channel-mix columns,
    experts and vocabulary over "model": at (2, 2) a device does a quarter
    of (1, 1)'s work, but for the products with weights whole on "model"
    (DeepSeek-V2's latent projections and router), which it does half of
    (``_whole_on_model_flops``).  The decode cells gather every weight and
    split the batch over "data" alone, so at (2, 2) a device does half of
    (1, 1)'s work: the decode step does not split its compute over
    "model" yet (ROADMAP's F5)."""
    one, _ = _cell(arch, impl, kind, "1x1")
    four, _ = _cell(arch, impl, kind, "2x2")
    if _tensor_parallel(arch, kind):
        whole = _whole_on_model_flops(_cfg(arch, impl), kind, S * B)
        assert (whole > 0) == (arch == "deepseek_v2_236b")
        assert 4 * four["flops_per_device"] == one["flops_per_device"] \
            + whole
    else:
        assert 2 * four["flops_per_device"] == one["flops_per_device"]


def _sharded_sizes(spec, sizes):
    """The sizes of the mesh axes (of more than one device) ``spec``
    shards over."""
    return [n for a, n in sizes.items() if n > 1
            and any(a in sharding._axes(e) for e in spec)]


@pytest.mark.parametrize("arch,impl,kind,mesh", [
    c for c in CELLS if c[2] in ("train", "prefill")])
def test_all_gather_bytes_follow_the_parameter_specs(arch, impl, kind,
                                                     mesh):
    """Every weight is gathered one mesh axis at a time, each gather's
    result the tensor over the axes gathered so far.  The tensor-parallel
    steps (the dense, RWKV-6 and MoE families) gather over the data axes
    only, keeping each weight's model shard: a weight sharded over "data"
    (n) and "model" (m) moves full / m; the prefill then gathers its
    logits' vocabulary over "model" (the batch's block of them, f32), and
    RWKV-6 its activations (``_rwkv_gathers``).  Nothing else is
    all-gathered in a train or prefill step."""
    cfg = _cfg(arch, impl)
    _, (pspecs, *_), _, abstract = steps.build(cfg, _shape(kind),
                                               MESHES[mesh])
    sizes = dict(zip(MESHES[mesh][1], MESHES[mesh][0]))
    split = _tensor_parallel(arch, kind)
    want = 0
    for p, spec in zip(abstract[0], pspecs):
        ns = _sharded_sizes(spec, sizes)
        full = p.numel() * p.element_size()
        if split:
            model = _sharded_sizes(spec, {"model": sizes["model"]})
            full //= math.prod(model)
            ns = _sharded_sizes(spec, {"data": sizes["data"]})
        want += sum(full // math.prod(ns[:j]) for j in range(len(ns)))
    if split and kind == "prefill" and sizes["model"] > 1:
        want += B // sizes["data"] * S * cfg.vocab * 4
    if split:
        want += _rwkv_gathers(cfg, kind, sizes)
    rec, _ = _cell(arch, impl, kind, mesh)
    assert rec["collective_bytes_per_device"].get("all-gather", 0) == want


def _rwkv_gathers(cfg, kind, sizes) -> int:
    """The bytes of RWKV-6's activations all-gathered over "model" in a
    tensor-parallel step, a device.  Where a rank's columns are whole
    heads, the backward of k's and v's reduce-scatter gathers their
    gradients (a train step); where they are not, each forward (twice in
    a train step: remat "full") gathers r, w (f32) and the bonus u (f32)
    whole, for K5 to run every head."""
    if cfg.family != "ssm" or sizes["model"] == 1:
        return 0
    rows, D = B // sizes["data"] * S, cfg.d_model
    item = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    if D // sizes["model"] % cfg.rwkv_head_dim == 0:
        per = 2 * rows * D * item if kind == "train" else 0
    else:
        per = (rows * D * (item + 4) + D * 4) * (2 if kind == "train" else 1)
    return cfg.n_layers * per


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_rwkv_heads_whole_on_1x4_run_k5_on_every_head(kind):
    """The reduced rwkv6-3b's 2 heads of 64 on a (1, 4) mesh: a rank's 32
    columns are half a head, so the heads are made whole, as the
    reference's ``fit_spec`` makes them.  The projections, the channel mix
    and the logits are a quarter of (1, 1)'s flops; K5's forward (twice in
    a train step) and backward run every head on every rank, their flops
    whole; r, w and u are all-gathered for it."""
    cfg = _cfg("rwkv6_3b", "dense")
    one, ops1 = _cell("rwkv6_3b", "dense", kind, "1x1")
    four, ops4 = _cell("rwkv6_3b", "dense", kind, "1x4")
    assert ops4 == ops1
    calls = {"train": 2 * 5 + 14, "prefill": 5}[kind]
    k5 = cfg.n_layers * calls * B * S * cfg.d_model * cfg.rwkv_head_dim
    assert 4 * (four["flops_per_device"] - k5) == \
        one["flops_per_device"] - k5
    logits = B * S * cfg.vocab * 4 if kind == "prefill" else 0
    assert four["collective_bytes_per_device"]["all-gather"] == logits \
        + _rwkv_gathers(cfg, kind, {"data": 1, "model": 4})


@pytest.mark.parametrize("arch,impl,kind,mesh", CELLS)
def test_argument_size_is_the_local_shards_bytes(arch, impl, kind, mesh):
    """The arguments are the rank's shards of the parameters, moments and
    cache and its block of the batch: each tensor's bytes over the sizes
    of the axes its spec names."""
    cfg = _cfg(arch, impl)
    _, in_specs, _, abstract = steps.build(cfg, _shape(kind), MESHES[mesh])
    sizes = dict(zip(MESHES[mesh][1], MESHES[mesh][0]))
    leaves = []

    def walk(tree, spec):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, spec[k])
        elif isinstance(tree, (list, tuple)):
            for v, s in zip(tree, spec):
                walk(v, s)
        else:
            leaves.append((tree, spec))
    walk(abstract, in_specs)
    want = sum(t.numel() * t.element_size()
               // math.prod(_sharded_sizes(s, sizes)) for t, s in leaves)
    rec, _ = _cell(arch, impl, kind, mesh)
    assert rec["memory"]["argument_size"] == want


@pytest.mark.parametrize("arch,impl,kind", [(a, i, k) for a, i in CONFIGS
                                            for k in KINDS])
def test_the_kernels_are_operator_nodes(arch, impl, kind):
    """Chunked attention is K4's operators (remat "full": the forward again
    in the backward), RWKV's time mix K5's; the decode step's attention
    reads its cache without K4, and MLA (DeepSeek-V2) takes none."""
    L = _cfg(arch, impl).n_layers
    _, ops = _cell(arch, impl, kind, "2x2")
    if arch == "rwkv6_3b":
        want = {"train": {"repro_torch.wkv6.default": 2 * L,
                          "repro_torch.wkv6_bwd.default": L}}.get(
            kind, {"repro_torch.wkv6.default": L})
    elif impl == "chunked" and kind != "decode" and arch != \
            "deepseek_v2_236b":
        want = {"train": {"repro_torch.flash_attention_lse.default": 2 * L,
                          "repro_torch.flash_attention_bwd.default": L},
                "prefill": {"repro_torch.flash_attention.default": L}}[kind]
    else:
        want = {}
    assert ops == want


def test_main_writes_caches_skips_and_records_failures(tmp_path, capsys,
                                                       monkeypatch):
    """``main`` over a results directory, as the reference's: a record
    per cell and mesh, ``[cached]`` on a second run, a ``[skip]`` record
    for a cell the architecture does not take, an ``.err`` file for a cell
    that cannot be traced, and the summary line."""
    real = dryrun.get_config
    monkeypatch.setattr(dryrun, "get_config",
                        lambda a, **k: real(a, reduced=True))
    out = tmp_path / "dryrun"
    dryrun.main(["--arch", "llama3_8b", "--shape", "decode_32k"],
                results=str(out))
    text = capsys.readouterr().out
    assert "dryrun: 2 ok, 0 skipped, 0 failed" in text
    for mesh in ("single", "multi"):
        rec = json.loads((out / f"llama3_8b_decode_32k_{mesh}.json")
                         .read_text())
        assert list(rec) == REFERENCE_KEYS and rec["mesh"] == mesh
        assert rec["n_devices"] == {"single": 256, "multi": 512}[mesh]
    dryrun.main(["--arch", "llama3_8b", "--shape", "decode_32k"],
                results=str(out))
    text = capsys.readouterr().out
    assert text.count("[cached]") == 2 and "2 ok, 0 skipped" in text

    def refuse(*a, **k):
        raise RuntimeError("cannot trace this cell")
    monkeypatch.setattr(dryrun, "trace_step", refuse)
    dryrun.main(["--all", "--arch", "llama3_8b", "--mesh", "single"],
                results=str(out))
    text = capsys.readouterr().out
    assert "[skip]   llama3_8b_long_500k_single" in text
    assert "[FAIL]   llama3_8b_train_4k_single" in text
    assert "dryrun: 1 ok, 1 skipped, 2 failed" in text
    err = json.loads((out / "llama3_8b_train_4k_single.json.err")
                     .read_text())
    assert err["error"] == "RuntimeError: cannot trace this cell"
    assert "skipped" in json.loads((out / "llama3_8b_long_500k_single.json")
                                   .read_text())
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# the operators
# ---------------------------------------------------------------------------


def _gqa(dtype, hd, S_=100, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, h, S_, hd))
                                .astype(np.float32)).to(dtype)
               for h in (4, 2, 2))
    return q, k, v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 64])
def test_k4_operators_on_the_cpu_are_the_plain_versions(dtype, hd):
    """The dispatcher's CPU implementations are the plain versions the
    wrappers ran before: forward (with and without the log-sum-exp) and
    backward, bitwise, on the routes' blocks and tiles."""
    q, k, v = _gqa(dtype, hd)
    kind = fa.route(dtype, hd)
    bq, bk = {"wgmma": fa.WGMMA_BLOCKS.get(hd, [(0, 0)])[0],
              "tf32x3": fa.TF32X3_BLOCKS.get(hd)}.get(
        kind, fa.CUDA_CORE_BLOCKS)
    bq, bk = min(bq, 100), min(bk, 100)
    want, lse = fa.flash_attention_plain(q, k, v, causal=True, block_q=bq,
                                         block_k=bk, return_lse=True)
    got = torch.ops.repro_torch.flash_attention(q, k, v, True, kind, bq, bk)
    got2, lse2 = torch.ops.repro_torch.flash_attention_lse(q, k, v, True,
                                                           kind, bq, bk)
    assert torch.equal(got, want) and torch.equal(got2, want)
    assert torch.equal(lse2, lse)
    assert torch.equal(fa.flash_attention(q, k, v, causal=True), want)
    dout = torch.ones_like(want)
    tq, tk = fa.BWD_TILES[fa.bwd_route(dtype, hd)][hd]
    wants = fa.flash_attention_bwd_plain(q, k, v, want, lse, dout,
                                         causal=True, block_q=tq, block_k=tk)
    gots = torch.ops.repro_torch.flash_attention_bwd(q, k, v, want, lse, dout,
                                                     True)
    for a, b in zip(gots, wants):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("with_state", [False, True])
def test_k5_operators_on_the_cpu_are_the_plain_versions(hd, with_state):
    """K5's forward writes the chunk schedule's plain results into out=
    and s_out= (s_out= may be s0: in place); its backward is its route's
    plain version; both bitwise."""
    rng = np.random.default_rng(1)
    Bw, Hw, Sw = 2, 2, 70
    r, k, v = (torch.from_numpy(rng.standard_normal((Bw, Hw, Sw, hd))
                                .astype(np.float32) * 0.5) for _ in range(3))
    w = torch.from_numpy(rng.uniform(0.5, 1.0, (Bw, Hw, Sw, hd))
                         .astype(np.float32))
    u = torch.from_numpy(rng.standard_normal((Hw, hd)).astype(np.float32))
    s0 = torch.from_numpy(rng.standard_normal((Bw, Hw, hd, hd)).astype(
        np.float32)) if with_state else None
    want_o, want_s = wk.wkv6_chunked_plain(r, k, v, w, u, s0, wk.CHUNK)
    out = torch.empty_like(r)
    s_out = s0.clone() if with_state else torch.empty((Bw, Hw, hd, hd))
    s_in = s_out if with_state else None      # the state updated in place
    torch.ops.repro_torch.wkv6(r, k, v, w, u, s_in, out, s_out, wk.CHUNK)
    assert torch.equal(out, want_o) and torch.equal(s_out, want_s)
    dout = torch.from_numpy(rng.standard_normal((Bw, Hw, Sw, hd)).astype(
        np.float32))
    plain = wk.wkv6_bwd_windowed_plain if wk.bwd_route(hd) == "windows" \
        else wk.wkv6_bwd_chunked_plain
    wants = plain(r, k, v, w, u, s0, dout, None, wk.BWD_CHUNK[hd])
    gots = torch.ops.repro_torch.wkv6_bwd(r, k, v, w, u, s0, dout, None)
    assert len(gots) == 6
    for a, b in zip(gots, wants):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["flash_attention", "flash_attention_lse",
                                  "flash_attention_bwd", "wkv6", "wkv6_bwd"])
def test_operators_have_cpu_cuda_and_fake_implementations(name):
    has = torch._C._dispatch_has_kernel_for_dispatch_key
    for key in ("CPU", "CUDA", "Meta"):
        assert has(f"repro_torch::{name}", key), key


def test_the_card_without_one_still_raises():
    """No fallback: asking for the card where there is none raises, on
    every wrapper, and nothing launches."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the rule is tested without one")
    q, k, v = _gqa(torch.float32, 64)
    n0 = sum(fa.LAUNCHES.values()) + sum(wk.LAUNCHES.values())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fa.flash_attention(q, k, v, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fa.flash_attention(q.numpy(), k.numpy(), v.numpy())
    r = torch.zeros((1, 2, 8, 16))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wk.wkv6_state(r, r, r, r, torch.zeros((2, 16)), device="cuda")
    assert sum(fa.LAUNCHES.values()) + sum(wk.LAUNCHES.values()) == n0
