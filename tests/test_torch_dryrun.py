"""The port's dry-run (``repro_torch.launch.dryrun``) on reduced
configurations at the meshes (1, 1), (2, 2) and (16, 16), each on a fake
group of its size: the record's keys are the reference's; the analyzer's
flops are ``FlopCounterMode``'s; dense prefills at (1, 1) count the
reference's HLO dot flops exactly, and Jamba's train step apart from it by
two named terms (``_one_device_gap``); every family's tensor-parallel
train, prefill and decode steps split their work over both axes, their
(2, 2) flops equal to the reference's compiled step's, or apart from it by
named products (``_xla_model_splits``, ``_one_device_gap``); RWKV-6's
heads made whole where they do not divide the model axis; all-gather
bytes (each weight once where used, a layer's again in a train step's
remat recompute; no cache tensor gathered) and the arguments' bytes
follow the specs; the "fsdp" step gathers each layer's weights where the
reference's compiled scan bodies do; under remat "dots" no score-sized
forward tensor reaches the backward; at every tuned train step's peak
the live all-gathers stay within two layers' weights and those outside
the layers; K4 and K5 appear as operator nodes; no process group is left
behind; ``main`` writes, caches, skips and records failures as the
reference's does.  Beside it, the kernels' operators: on CPU tensors the
plain versions bitwise, and the card raised for where there is none."""
import collections
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import time

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
from repro_torch.config import ShapeConfig, get_config, tune
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import wkv6 as wk
from repro_torch.launch import dryrun
from repro_torch.launch import steps
from repro_torch.models import lm
from repro_torch.launch import hlo_analysis
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import P

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
           ("deepseek_v2_236b", "chunked"),
           ("jamba_1_5_large_398b", "dense"), ("whisper_small", "dense"),
           ("paligemma_3b", "dense")]
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


def _latent_width(cfg) -> int:
    """The columns of MLA's down projections ``wdq`` and ``wdkv``
    together (0 without MLA)."""
    m = cfg.mla
    return m.q_lora_rank + m.kv_lora_rank + m.rope_head_dim if m else 0


def _kv_whole(cfg, m: int) -> bool:
    """Whether the kv projections stay whole on a model axis of ``m``
    (their heads do not divide it: PaliGemma's one kv head)."""
    return cfg.n_kv_heads % m != 0


def _whole_on_model_flops(cfg, kind, tokens: int, m: int = 2) -> int:
    """The flops of the products with weights whole on "model" that a
    tensor-parallel train or prefill step computes whole on every model
    rank, on ``tokens`` tokens: MLA's ``h @ wdq`` and ``h @ wdkv``, the
    router's ``h @ router`` and, where the kv heads do not divide the
    axis, the attention layers' kv projections (``layers._local_kv``).  A
    prefill does each once; a train step four times (the forward, again
    under remat "full", the input's gradient and the weight's).  A decode
    step splits each one's contraction (``tensor_parallel.whole_product``):
    none."""
    if kind == "decode":
        return 0
    width = 0
    for i in range(cfg.n_layers):
        kind_i = cfg.layer_kind(i)
        width += _latent_width(cfg) * (kind_i == "mla")
        width += cfg.moe.n_experts * cfg.is_moe_layer(i) if cfg.moe else 0
        width += 2 * cfg.n_kv_heads * cfg.hd * (
            kind_i == "attn" and _kv_whole(cfg, m))
    return 2 * tokens * cfg.d_model * width * (4 if kind == "train" else 1)


def _xla_model_splits(cfg, kind, tokens: int, m: int = 2) -> int:
    """The flops by which the reference's (2, 2) step, as XLA partitions
    it, does less than the port's on a device of ``tokens`` tokens: XLA
    splits work on weights whole on "model" between the two model ranks
    where the port repeats it on each (PERF.md §6).  In a train step half
    of each such weight's gradient (``wdq`` and ``wdkv`` in every MLA
    layer, the router in every MoE layer: DeepSeek-V2, Kimi-K2, Jamba),
    half of the dense prefix layer's ``h @ wdq`` and ``h @ wdkv``, which
    the reference applies outside its scan: in its forward (a prefill) and
    again under remat (a train step), and half of all four passes of the
    kv projections where their heads do not divide the axis (PaliGemma:
    XLA splits their contraction in the train step, not in the
    prefill)."""
    prefix = cfg.dense_prefix_layers * tokens * cfg.d_model \
        * _latent_width(cfg)
    if kind == "prefill":
        return prefix
    if kind == "decode":
        return 0
    n_mla = sum(cfg.layer_kind(i) == "mla" for i in range(cfg.n_layers))
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    n_kv = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers)) \
        if _kv_whole(cfg, m) else 0
    return 2 * prefix + tokens * cfg.d_model * (
        n_mla * _latent_width(cfg)
        + (n_moe * cfg.moe.n_experts if cfg.moe else 0)
        + n_kv * 4 * 2 * cfg.n_kv_heads * cfg.hd)


def _one_device_gap(cfg, kind, tokens: int, m: int = 1) -> int:
    """The flops by which the port's step counts more than the
    reference's compiled step at (1, 1) (on ``tokens`` tokens a device,
    Mamba's channels and the FFN's columns over a model axis of ``m``),
    product by product; nonzero for Jamba's train step alone:

    * + the backward of Mamba's ``einsum("bsdn,bsn->bsd", h, C)`` into h,
      an outer product of y's gradient and C: autograd makes it a ``bmm``
      with a contraction of 1, counted 2 * tokens * di * N a Mamba layer;
      XLA emits a broadcast multiply, no dot;
    * - under remat "full" the reference's remat unit is a period (8
      layers, ``repro/models/lm.py:171-172``): its backward recomputes
      every MLP layer's ``up @ w_down`` but the period's last, whose
      output nothing in the backward reads; the port checkpoints each
      layer, and ``torch.utils.checkpoint`` stops a layer's recomputation
      at its last saved tensor, so no ``w_down`` product (a layer's last
      op, its output the next checkpoint's saved input) is recomputed."""
    if kind != "train" or cfg.family != "hybrid":
        return 0
    di, specs = cfg.mamba_expand * cfg.d_model // m, lm.layer_specs(cfg)
    outer = sum(mix == "mamba" for mix, _ in specs) * 2 * tokens * di \
        * cfg.mamba_d_state
    if cfg.remat != "full":
        return outer
    period = specs[cfg.dense_prefix_layers:][:cfg.period]
    mlps = sum(ffn == "mlp" for _, ffn in period) \
        - (period[-1][1] == "mlp")
    n_periods = (cfg.n_layers - cfg.dense_prefix_layers) // cfg.period
    return outer - n_periods * mlps * 2 * tokens * (cfg.d_ff // m) \
        * cfg.d_model


# the reference's cells: its steps compiled by XLA on 4 host devices of
# child processes (``repro.launch.dryrun`` asks for 512 when imported), the
# mesh's axes ``Auto`` (JAX 0.9.0's ``make_mesh`` makes them ``Explicit``,
# on which the reference's ``constrain`` raises: ROADMAP's R6), read by the
# reference's analyzer; each cell (arch, kind, data, model, remat or None)
_REFERENCE_CELLS = """
import dataclasses, json, sys
from repro.launch import dryrun
import jax
from jax.sharding import AxisType
from repro import config
from repro.launch import hlo_analysis
out = {}
for arch, kind, d, m, remat in json.loads(sys.argv[1]):
    mesh = jax.make_mesh((d, m), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:d * m])
    cfg = dataclasses.replace(config.get_config(arch, reduced=True),
                              attn_impl="dense")
    if remat:
        cfg = dataclasses.replace(cfg, remat=remat)
    shape = config.ShapeConfig("t", kind, %d, %d)
    text = dryrun._compile_cell(cfg, shape, mesh).as_text()
    out[f"{arch}:{kind}:{d}x{m}:{remat}"] = hlo_analysis.analyze(text)["flops"]
print(json.dumps(out))
""" % (S, B)
# the reference's reduced llama3-8b "fsdp" train step (dense attention,
# remat "full") compiled as ``_REFERENCE_CELLS`` compiles its cells: the
# ``all-gather`` instructions of its HLO text counted by computation (the
# reference's analyzer reports no all-gather bytes for this cell), the trip
# count of each while loop's body, and the entry computation's name
_REFERENCE_GATHERS = r"""
import dataclasses, json, re, sys
from repro.launch import dryrun
import jax
from jax.sharding import AxisType
from repro import config
S, B = json.loads(sys.argv[1])
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2, devices=jax.devices()[:4])
cfg = dataclasses.replace(config.get_config("llama3_8b", reduced=True),
                          attn_impl="dense", parallel_style="fsdp")
text = dryrun._compile_cell(cfg, config.ShapeConfig("t", "train", S, B),
                            mesh).as_text()
gathers, comp, entry = {}, None, None
for line in text.splitlines():
    m = re.match(r"^(ENTRY )?%(\S+) .*\{$", line)
    if m:
        comp = m.group(2)
        entry = comp if m.group(1) else entry
    elif re.search(r"\ball-gather(-start)?\(", line):
        gathers[comp] = gathers.get(comp, 0) + 1
trips = {m.group(1): int(m.group(2)) for m in re.finditer(
    r'while\(.*?body=%(\S+?),.*?"known_trip_count":\{"n":"(\d+)"', text)}
print(json.dumps({"gathers": gathers, "trips": trips, "entry": entry}))
"""
TP_ARCHS = ("llama3_8b", "gemma_7b", "deepseek_v2_236b", "kimi_k2_1t_a32b",
            "jamba_1_5_large_398b", "whisper_small", "paligemma_3b")
TP_CELLS = [(a, k) for a in TP_ARCHS for k in KINDS]
# Jamba's one-device train step under both remat modes
GAP_CELLS = [("jamba_1_5_large_398b", "train", 1, 1, r)
             for r in ("full", "none")]
# the children's share of the cells, the three slowest (Jamba's train
# steps, ~30-50 s each) one a child; a fourth child compiles the "fsdp"
# cell of _REFERENCE_GATHERS, its record under FSDP_GATHERS
_CHILDREN = 3
FSDP_GATHERS = "llama3_8b:train:2x2:fsdp:all-gathers"


@pytest.fixture(scope="session")
def reference_cells():
    """{"arch:kind:dxm:remat": the reference's flops a device} of TP_CELLS
    on (2, 2) and of GAP_CELLS, from ``_CHILDREN`` child processes run
    side by side, and beside them the all-gathers of _REFERENCE_GATHERS'
    cell (under FSDP_GATHERS), all within one deadline of 270 s."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(root, "src"))
    cells = [("jamba_1_5_large_398b", "train", 2, 2, None), *GAP_CELLS] + [
        (a, k, 2, 2, None) for a, k in TP_CELLS
        if (a, k) != ("jamba_1_5_large_398b", "train")]
    children = [subprocess.Popen(
        [sys.executable, "-c", _REFERENCE_CELLS,
         json.dumps(cells[i::_CHILDREN])], env=env, cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(_CHILDREN)] + [subprocess.Popen(
            [sys.executable, "-c", _REFERENCE_GATHERS, json.dumps([S, B])],
            env=env, cwd=root, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)]
    out, deadline = {}, time.monotonic() + 270
    try:
        for i, child in enumerate(children):
            stdout, stderr = child.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            assert child.returncode == 0, stderr[-3000:]
            got = json.loads(stdout.strip().splitlines()[-1])
            out.update(got if i < _CHILDREN else {FSDP_GATHERS: got})
    finally:
        for child in children:
            child.kill()
    return out


@pytest.mark.timeout(300)
@pytest.mark.parametrize("arch,kind", TP_CELLS)
def test_model_axis_flops_equal_the_references(reference_cells, arch, kind):
    """Every family's tensor-parallel train, prefill and decode steps at
    (2, 2): a device's flops are the reference's compiled step's (dense
    attention, which the reference's analyzer counts as the port's),
    exactly but for the products XLA splits on weights whole on "model"
    (``_xla_model_splits``: the latents', router's and PaliGemma's kv
    projections' weight gradients and more, in the train steps,
    DeepSeek-V2's prefix latents) and Jamba's one-device terms at the
    device's share (``_one_device_gap``).  The decode steps equal the
    reference's exactly: their products on weights whole on "model" split
    their contraction as XLA's do."""
    cfg = _cfg(arch, "dense")
    rec, _ = _cell(arch, "dense", kind, "2x2")
    tokens = B // 2 * S
    extra = _xla_model_splits(cfg, kind, tokens) \
        + _one_device_gap(cfg, kind, tokens, 2)
    assert extra == 0 or arch in ("deepseek_v2_236b", "kimi_k2_1t_a32b",
                                  "jamba_1_5_large_398b", "paligemma_3b")
    assert kind != "decode" or extra == 0
    assert rec["flops_per_device"] == \
        reference_cells[f"{arch}:{kind}:2x2:None"] + extra


@pytest.mark.timeout(300)
@pytest.mark.parametrize("remat", ["full", "none"])
def test_jamba_one_device_gap_is_named_product_by_product(reference_cells,
                                                          remat):
    """Jamba's train step at (1, 1) counts the reference's flops plus the
    outer product autograd counts as a dot (+29,360,128 on the reduced
    config at S 64, B 16) and, under remat "full", less the MLP
    down-projections the reference's period-wide remat recomputes and the
    port's per-layer checkpoint does not (-50,331,648):
    ``_one_device_gap``.  Both sides compute the same function; neither
    term is work the port adds or drops."""
    cfg = dataclasses.replace(_cfg("jamba_1_5_large_398b", "dense"),
                              remat=remat)
    with dryrun.dryrun_mesh(*MESHES["1x1"]) as m:
        tr = dryrun.trace_step(cfg, _shape("train"), m)
        rec = dryrun.record("jamba_1_5_large_398b", "t", "1x1", cfg,
                            _shape("train"), m, tr)
    gap = _one_device_gap(cfg, "train", B * S)
    assert gap == {"full": 29360128 - 50331648, "none": 29360128}[remat]
    assert rec["flops_per_device"] == reference_cells[
        f"jamba_1_5_large_398b:train:1x1:{remat}"] + gap


@pytest.mark.parametrize("arch,impl,kind", [(a, i, k) for a, i in CONFIGS
                                            for k in KINDS])
def test_data_axis_splits_the_work_model_axis_replicates_it(arch, impl,
                                                           kind):
    """Every family's train, prefill and decode steps split the batch over
    "data" and the heads, FFN, channel-mix and Mamba columns, experts and
    vocabulary over "model": at (2, 2) a device does a quarter of (1, 1)'s
    work, but for the products with weights whole on "model" that the
    train and prefill steps repeat on each model rank (DeepSeek-V2's
    latent projections and router, Jamba's router, PaliGemma's kv
    projections), which it does half of (``_whole_on_model_flops``).  The
    decode steps split those too, by their contraction, and attend over
    the rank's block of the cache's positions: a quarter exactly."""
    one, _ = _cell(arch, impl, kind, "1x1")
    four, _ = _cell(arch, impl, kind, "2x2")
    whole = _whole_on_model_flops(_cfg(arch, impl), kind, S * B)
    assert (whole > 0) == (arch in ("deepseek_v2_236b",
                                    "jamba_1_5_large_398b", "paligemma_3b")
                           and kind != "decode")
    assert 4 * four["flops_per_device"] == one["flops_per_device"] + whole


def _sharded_sizes(spec, sizes):
    """The sizes of the mesh axes (of more than one device) ``spec``
    shards over."""
    return [n for a, n in sizes.items() if n > 1
            and any(a in sharding._axes(e) for e in spec)]


def _gathers_a_step(cfg, kind, name) -> int:
    """How often a step gathers weight ``name``: where it is used (the
    embedding twice where the head is the embedding; a VLM's image
    projection not in a decode step, which takes no patches), a layer's
    weights once more in a train step's backward, whose remat recompute
    gathers them again as the reference's scan body under
    ``jax.checkpoint`` does."""
    layer = name.split(".")[0] in ("blocks", "encoder")
    uses = 2 if name == "embed" and cfg.tie_embeddings else 1
    if name == "img_proj" and kind == "decode":
        return 0
    again = kind == "train" and cfg.remat != "none" and layer
    return uses * (2 if again else 1)


@pytest.mark.parametrize("arch,impl,kind,mesh", CELLS)
def test_all_gather_bytes_follow_the_parameter_specs(arch, impl, kind,
                                                     mesh):
    """Every weight is gathered in one all-gather over the axes its spec
    shards it over (their flattened group where there are several), its
    result the weight as the step uses it, each time a layer or the model
    reads it (``_gathers_a_step``).  The tensor-parallel steps gather over
    the data axes only, keeping each weight's model shard: a weight
    sharded over "data" (n) and "model" (m) moves full / m (a decode step
    whose cache positions lie on "model" gathers MLA's ``wukv`` whole).
    Beside the weights, only activations are gathered
    (``_activation_gathers``): no cache tensor."""
    cfg = _cfg(arch, impl)
    _, (pspecs, *_), _, abstract = steps.build(cfg, _shape(kind),
                                               MESHES[mesh])
    sizes = dict(zip(MESHES[mesh][1], MESHES[mesh][0]))
    names = [n for n, _ in lm.LM(cfg, steps.abstract_params(
        cfg)).named_parameters()]
    want = 0
    for name, p, spec in zip(names, abstract[0], pspecs):
        full = p.numel() * p.element_size()
        if not (kind == "decode" and name.endswith(".wukv")):
            full //= math.prod(_sharded_sizes(spec, {"model":
                                                     sizes["model"]}))
            spec = P(*(tuple(a for a in sharding._axes(e) if a != "model")
                       or None for e in spec))
        if _sharded_sizes(spec, sizes):
            want += full * _gathers_a_step(cfg, kind, name)
    want += _activation_gathers(cfg, kind, sizes)
    rec, _ = _cell(arch, impl, kind, mesh)
    assert rec["collective_bytes_per_device"].get("all-gather", 0) == want


# a node of this shape marks the forward's end in a traced train step
# (``_marked_trace``)
MARK = (3, 5, 7, 11)


def _marked_trace(monkeypatch, cfg, kind, mesh):
    """(the traced step's nodes, the index of the node that marks the end
    of the forward, the graph's placeholders): ``lm.loss_terms`` makes a
    node of shape MARK after the loss, before the step's backward."""
    terms = lm.loss_terms

    def marked(*args, **kw):
        total, count = terms(*args, **kw)
        total.new_zeros(MARK)
        return total, count
    monkeypatch.setattr(lm, "loss_terms", marked)
    with dryrun.dryrun_mesh(*{**MESHES, **MORE_MESHES}[mesh]) as m:
        tr = dryrun.trace_step(cfg, _shape(kind), m)
    nodes = list(tr.gm.graph.nodes)
    cut = [i for i, n in enumerate(nodes)
           if tuple(getattr(n.meta.get("val"), "shape", ())) == MARK]
    assert len(cut) == 1
    return nodes, cut[0], [n for n in nodes if n.op == "placeholder"]


def _gathered_weights(nodes, cut: int, holders: list, names: list):
    """(forward, backward): Counters of the weights (dotted names) the
    all-gathers before and after ``cut`` gather, each traced back through
    the single-input nodes (views, copies) to the placeholder of its
    shard; the placeholders begin with the parameters in ``names``'
    order."""
    fwd, bwd = collections.Counter(), collections.Counter()
    for i, n in enumerate(nodes):
        if str(n.target) != "_c10d_functional.all_gather_into_tensor." \
                "default":
            continue
        src = n.all_input_nodes[0]
        while src.op != "placeholder" and len(src.all_input_nodes) == 1:
            src = src.all_input_nodes[0]
        at = holders.index(src) if src.op == "placeholder" else None
        name = names[at] if at is not None and at < len(names) else None
        (fwd if i < cut else bwd)[name] += 1
    return fwd, bwd


@pytest.mark.timeout(300)
def test_fsdp_gathers_each_layer_where_the_reference_scan_does(
        reference_cells, monkeypatch):
    """The reference's reduced llama3-8b "fsdp" train step, compiled: every
    all-gather of its HLO but the embedding's and the head's (the entry
    computation's) lies in the forward's and the backward's scan bodies,
    whose trip count is the layer count, the same number in each (7 + 7 +
    2 at 2 layers).  The port's traced step gathers the same pattern:
    each layer's gathered weights (as many as a scan body gathers) once in
    the forward and once in the backward's remat recompute, the embedding
    and the head once, in the forward."""
    ref = reference_cells[FSDP_GATHERS]
    cfg = dataclasses.replace(_cfg("llama3_8b", "dense"),
                              parallel_style="fsdp")
    L = cfg.n_layers
    bodies = {b: n for b, n in ref["gathers"].items()
              if ref["trips"].get(b) == L}
    entry = ref["gathers"].get(ref["entry"], 0)
    assert len(bodies) == 2 and len(set(bodies.values())) == 1
    assert sum(ref["gathers"].values()) == sum(bodies.values()) + entry
    per_body = next(iter(bodies.values()))
    assert (per_body, entry) == (7, 2)
    names = [n for n, _ in lm.LM(cfg, steps.abstract_params(
        cfg)).named_parameters()]
    nodes, cut, holders = _marked_trace(monkeypatch, cfg, "train", "2x2")
    fwd, bwd = _gathered_weights(nodes, cut, holders, names)
    assert None not in fwd and None not in bwd
    for i in range(L):
        mine = {n: c for n, c in fwd.items()
                if n.startswith(f"blocks.{i}.")}
        assert len(mine) == per_body and set(mine.values()) == {1}
        assert {n: c for n, c in bwd.items()
                if n.startswith(f"blocks.{i}.")} == mine
    rest = {n: c for n, c in fwd.items() if not n.startswith("blocks.")}
    assert rest == {"embed": 1, "lm_head": 1} and sum(rest.values()) == entry
    assert all(n.startswith("blocks.") for n in bwd)


# the families with attention scores: dense, MLA, Jamba's attention layer,
# Whisper's self and cross attention, PaliGemma's prefix
SCORE_ARCHS = ("llama3_8b", "gemma_7b", "deepseek_v2_236b",
               "jamba_1_5_large_398b", "whisper_small", "paligemma_3b")


@pytest.mark.parametrize("arch", SCORE_ARCHS)
def test_dots_backward_reads_no_score_sized_forward_tensor(arch,
                                                           monkeypatch):
    """Remat "dots" saves only the plain matrix products, as the
    reference's ``checkpoint_dots_with_no_batch_dims``: in the traced train
    step (dense attention) no (B, H, S, T) tensor made in the forward (the
    scores, the softmax's ``where``, ``exp`` and ``div``, the mask) is read
    after it; the backward recomputes them.  PyTorch's selective
    checkpoint under ``make_fx`` caches every op's result, and its traced
    backward read them (ROADMAP's F6)."""
    cfg = dataclasses.replace(_cfg(arch, "dense"), remat="dots")
    nodes, cut, _ = _marked_trace(monkeypatch, cfg, "train", "1x1")
    at = {n: i for i, n in enumerate(nodes)}
    lengths = {S, S + cfg.n_img_tokens if cfg.family == "vlm" else S,
               cfg.enc_seq if cfg.family == "encdec" else S}
    kept = [n for n in nodes[:cut]
            if isinstance(n.meta.get("val"), torch.Tensor)
            and n.meta["val"].dim() == 4
            and n.meta["val"].shape[0] == B
            and set(n.meta["val"].shape[2:]) <= lengths
            and any(at[u] > cut for u in n.users)]
    assert not kept, [(n.target, tuple(n.meta["val"].shape)) for n in kept]


# every family's train step as ``config.tune`` picks it for 4 devices
# ("fsdp" where the model has no experts, else "tp"; remat "dots"), with
# more layers than two, so that two layers' weights are not all of them
TUNED_ARCHS = ("llama3_8b", "gemma_7b", "rwkv6_3b", "deepseek_v2_236b",
               "kimi_k2_1t_a32b", "jamba_1_5_large_398b", "whisper_small",
               "paligemma_3b")


def _tuned(arch):
    cfg = _cfg(arch, "dense")
    more = {"dense": dict(n_layers=4), "ssm": dict(n_layers=4),
            "vlm": dict(n_layers=4), "encdec": dict(n_layers=4,
                                                    n_enc_layers=4),
            "moe": dict(n_layers=cfg.dense_prefix_layers + 3)}
    cfg = dataclasses.replace(cfg, **more.get(cfg.family, {}))
    return tune(cfg, _shape("train"), n_chips=4)


@pytest.mark.parametrize("arch", TUNED_ARCHS)
def test_live_gathers_at_the_peak_stay_within_two_layers(arch):
    """At the traced train step's peak of live bytes the all-gathered
    weights alive are at most two layers' plus those outside the layers
    (``dryrun.gather_bound``), fewer than the whole model's: each layer's
    weights are gathered at the layer and dropped after it."""
    cfg = _tuned(arch)
    assert cfg.remat == "dots" and cfg.parallel_style == (
        "tp" if cfg.moe else "fsdp")
    with dryrun.dryrun_mesh(*MESHES["2x2"]) as m:
        tr = dryrun.trace_step(cfg, _shape("train"), m)
        bound = dryrun.gather_bound(cfg, m)
        whole = sum(dryrun.gathered_weight_bytes(cfg, m).values())
    live = hlo_analysis.live_at_peak(tr.gm).get("all_gather_into_tensor", 0)
    assert live <= bound < whole, (live, bound, whole)


def _activation_gathers(cfg, kind, sizes) -> int:
    """The bytes of activations a tensor-parallel step all-gathers over
    "model", a device: the prefill's and the decode's logits' vocabulary
    (the batch's block of them, f32), PaliGemma's projected patches,
    RWKV-6's (``_rwkv_gathers``), and in a decode step, whose cache
    positions lie on "model", each attention layer's q heads and its new
    keys and values where their heads split, MLA's q heads, and the new
    RWKV and Mamba states where the heads or channels split
    (``_decode_gathers``)."""
    m = sizes["model"]
    if m == 1:
        return 0
    rows = B // sizes["data"]
    item = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    out = _rwkv_gathers(cfg, kind, sizes)
    if kind != "train":
        n_txt = S - cfg.n_img_tokens if cfg.family == "vlm" else S
        out += rows * (n_txt if kind == "prefill" else 1) * cfg.vocab * 4
    if cfg.family == "vlm" and kind != "decode":
        out += rows * cfg.n_img_tokens * cfg.d_model * item
    if kind == "decode":
        out += _decode_gathers(cfg, rows, m, item)
    return out


def _decode_gathers(cfg, rows: int, m: int, item: int) -> int:
    """The layers' gathers of a decode step on ``rows`` rows a device over
    a model axis of ``m`` that holds the cache's positions."""
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    out = 0
    for i in range(cfg.n_layers):
        kind = cfg.layer_kind(i)
        if kind == "attn" and H % m == 0:
            out += rows * H * hd * item
            out += 2 * rows * K * hd * item if K % m == 0 else 0
        elif kind == "mla" and H % m == 0:
            out += rows * H * (cfg.mla.nope_head_dim
                               + cfg.mla.rope_head_dim) * item
        elif kind == "rwkv" and D // m % cfg.rwkv_head_dim == 0:
            out += rows * D * cfg.rwkv_head_dim * 4
        elif kind == "mamba":
            di = cfg.mamba_expand * D
            out += rows * di * (cfg.mamba_d_state * 4
                                + (cfg.mamba_d_conv - 1) * item)
    return out


def _rwkv_gathers(cfg, kind, sizes) -> int:
    """The bytes of RWKV-6's activations all-gathered over "model" in a
    tensor-parallel step, a device.  Where a rank's columns are whole
    heads, the backward of k's and v's reduce-scatter gathers their
    gradients (a train step); where they are not, each forward (twice in
    a train step: remat "full") gathers r, w (f32) and the bonus u (f32)
    whole, for K5 to run every head (a decode step's one token a row)."""
    if cfg.family != "ssm" or sizes["model"] == 1:
        return 0
    rows = B // sizes["data"] * (1 if kind == "decode" else S)
    D = cfg.d_model
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
    bwd = fa.bwd_route(dtype, hd)
    tq, tk = fa.BWD_TILES[bwd][hd]
    # bf16 walks its kernels' own schedule (``dkdv_wrap`` at hd 64)
    wants = fa.flash_attention_bwd_plain(q, k, v, want, lse, dout,
                                         causal=True, block_q=tq, block_k=tk,
                                         split=bwd == "wgmma")
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
