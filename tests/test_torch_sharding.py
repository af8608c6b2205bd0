"""The port's sharding rule tables, abstract inputs and int8 quantizer
against the JAX package's, with no process group and no devices.

The tables are pure functions of shapes and of the mesh's ``{axis:
size}``, so both packages are asked at the production meshes, (16, 16)
and (2, 16, 16), through duck-typed meshes, for every configuration and
shape and both styles ``config.tune`` picks.  The port's layers are
unstacked: a port layer's spec is the reference's spec of the matching
stacked leaf (``blocks``' period axis, the encoder's layer axis) without
its leading entry, and a dense prefix layer's is the reference's as it
is.  ``local_block`` is held to JAX's ``NamedSharding`` device indices in
a child process with 8 host devices.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import config as jax_config
from repro.launch import steps as jax_steps
from repro.models import api as jax_api
from repro.parallel import compression as jax_compression
from repro.parallel import sharding as jax_sharding
from repro_torch import config as torch_config
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models import api as tapi
from repro_torch.parallel import compression as tcompression
from repro_torch.parallel import sharding as tsharding

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}
STYLES = ("tp", "fsdp")


@pytest.fixture(autouse=True)
def _port_fault_free():
    from repro_torch.core import faults
    faults.reset()
    yield
    faults.reset()


def _duck(mesh):
    shape, names = MESHES[mesh]
    return types.SimpleNamespace(shape=dict(zip(names, shape)),
                                 axis_names=names)


def _cfgs(arch, style):
    return (dataclasses.replace(jax_config.get_config(arch),
                                parallel_style=style),
            dataclasses.replace(torch_config.get_config(arch),
                                parallel_style=style))


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jax_steps.abstract_params(jax_config.get_config(arch))


@functools.lru_cache(maxsize=None)
def _jax_cache(arch, shape):
    return jax_steps.abstract_cache(jax_config.get_config(arch),
                                    jax_config.SHAPES[shape])


def _spec(p):
    """A JAX PartitionSpec (or the port's P) as a plain tuple."""
    return tuple(p)


def _unstacked(cfg, ref, port, what, encoder=None):
    """Compare the port's layer list ``port["blocks"]`` (and ``encoder``)
    with the reference's ``prefix`` / stacked ``blocks`` (``encoder``, or
    the ``encoder`` spec tree given) subtrees of spec trees, leaf by leaf;
    the other top-level leaves as they are.  ``what`` names the tree in
    messages."""
    is_p = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731

    def same(r, t, stacked, path):
        rl = jax.tree_util.tree_leaves_with_path(r, is_leaf=is_p)
        tl = jax.tree_util.tree_leaves_with_path(
            t, is_leaf=lambda x: isinstance(x, tsharding.P))
        assert [jax.tree_util.keystr(k) for k, _ in rl] == \
            [jax.tree_util.keystr(k) for k, _ in tl], (what, path)
        for (k, a), (_, b) in zip(rl, tl):
            want = _spec(a)[1:] if stacked else _spec(a)
            assert _spec(b) == want, (what, path, jax.tree_util.keystr(k),
                                      _spec(a), _spec(b))

    n_pre = cfg.dense_prefix_layers
    assert len(port["blocks"]) == cfg.n_layers
    for i, layer in enumerate(port["blocks"]):
        if i < n_pre:
            same(ref["prefix"][i], layer, False, f"prefix {i}")
        else:
            pos = (i - n_pre) % cfg.period
            same(ref["blocks"][f"pos{pos}"], layer, True, f"layer {i}")
    for i, layer in enumerate(port.get("encoder", [])):
        same(ref["encoder"] if encoder is None else encoder, layer, True,
             f"encoder {i}")
    top = {k for k in port if k not in ("blocks", "encoder")}
    assert top == {k for k in ref if k not in ("prefix", "blocks",
                                               "encoder")}, what
    for k in top:
        assert _spec(port[k]) == _spec(ref[k]), (what, k)


PARAM_CASES = [(a, m, s) for a in jax_config.ARCH_IDS for m in MESHES
               for s in STYLES]


@pytest.mark.parametrize("arch,mesh,style", PARAM_CASES,
                         ids=["-".join(c) for c in PARAM_CASES])
def test_param_and_opt_specs_match_the_reference(arch, mesh, style):
    jcfg, tcfg = _cfgs(arch, style)
    ref = jax_sharding.param_specs(jcfg, _jax_params(arch), _duck(mesh))
    port = tsharding.param_specs(tcfg, tsteps.abstract_params(tcfg),
                                 MESHES[mesh])
    # The reference's expert test (rank - count("blocks") >= 3) takes the
    # encoder's stacked (L, D, F) MLP weights for experts; held at the
    # port's ranks (the stack under "blocks", where the test discounts the
    # layer axis), the encoder's specs are the MLP rule's.
    enc = jax_sharding.param_specs(
        jcfg, {"blocks": _jax_params(arch)["encoder"]}, _duck(mesh)
    )["blocks"] if "encoder" in ref else None
    _unstacked(tcfg, ref, port, "params", enc)
    # the list in param_list order holds the tree's specs by name
    model = tsteps.lm.LM(tcfg, tsteps.abstract_params(tcfg))
    flat = tsharding.param_list_specs(tcfg, model, _duck(mesh))
    names = [n for n, _ in model.named_parameters()]
    assert len(flat) == len(model.param_list())
    for name, spec in zip(names, flat):
        node = port
        for k in name.split("."):
            node = node[int(k)] if k.isdigit() else node[k]
        assert spec == node, name
    ropt = jax_sharding.opt_specs(ref)
    popt = tsharding.opt_specs(port)
    assert _spec(popt["count"]) == _spec(ropt["count"]) == ()
    for k in ("m", "v"):
        _unstacked(tcfg, ropt[k], popt[k], k, enc)


BATCH_CASES = [(a, sh, m, s) for a in jax_config.ARCH_IDS
               for sh in jax_config.SHAPES for m in MESHES for s in STYLES]


@pytest.mark.parametrize("arch,shape,mesh,style", BATCH_CASES,
                         ids=["-".join(c) for c in BATCH_CASES])
def test_batch_and_cache_specs_match_the_reference(arch, shape, mesh,
                                                   style):
    jcfg, tcfg = _cfgs(arch, style)
    jshape = jax_config.SHAPES[shape]
    tshape = torch_config.SHAPES[shape]
    ref = jax_sharding.batch_specs(jcfg, jshape, _duck(mesh))
    port = tsharding.batch_specs(tcfg, tshape, _duck(mesh))
    assert {k: _spec(v) for k, v in port.items()} == \
        {k: _spec(v) for k, v in ref.items()}
    rc = jax_sharding.cache_specs(jcfg, jshape, _duck(mesh),
                                  _jax_cache(arch, shape))
    pc = tsharding.cache_specs(tcfg, tshape, _duck(mesh),
                               tsteps.abstract_cache(tcfg, tshape))
    assert set(pc) == {"blocks"}
    _unstacked(tcfg, rc, pc, "cache")


@pytest.mark.parametrize("arch,shape", [
    (a, sh) for a in jax_config.ARCH_IDS for sh in jax_config.SHAPES])
def test_input_specs_match_the_references_structs(arch, shape):
    want = jax_api.input_specs(jax_config.get_config(arch),
                               jax_config.SHAPES[shape])
    got = tapi.input_specs(torch_config.get_config(arch),
                           torch_config.SHAPES[shape])
    assert list(got) == list(want)
    for k, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == want[k].shape, k
        assert str(t.dtype).removeprefix("torch.") == want[k].dtype.name, k


def test_abstract_params_hold_no_storage_and_match_init_shapes():
    """``abstract_params`` draws nothing: meta tensors with the shapes and
    dtypes a seeded ``init_params`` gives (the reduced configs)."""
    for arch in torch_config.ARCH_IDS:
        cfg = torch_config.get_config(arch, reduced=True)
        meta = tsteps.abstract_params(cfg)
        real = tsteps.lm.init_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu")
        a = jax.tree_util.tree_leaves(meta)
        b = jax.tree_util.tree_leaves(real)
        assert len(a) == len(b), arch
        for x, y in zip(a, b):
            assert x.device.type == "meta"
            assert (x.shape, x.dtype) == (y.shape, y.dtype), arch
        opt = tsteps.abstract_opt_state(cfg, meta)
        assert [m.shape for m in opt["m"]] == [
            p.shape for p in tsteps.lm.LM(cfg, meta).param_list()]


FIT_CASES = [
    (("data", "model"), (32, 8), "pod"),
    (("data", "model"), (8, 6), "pod"),
    ((("pod", "data"), "model"), (48, 24), "multipod"),
    ((("pod", "data"), "model"), (6, 8), "multipod"),
    ((("pod", "data", "model"), None), (1024, 3), "multipod"),
    ((("pod", "data", "model"), None), (96, 3), "multipod"),
    ((None, ("data", "model"), "pod"), (5, 256, 7), "multipod"),
    (("model", None, ("pod", "data")), (8, 3, 2), "multipod"),
]


@pytest.mark.parametrize("spec,shape,mesh", FIT_CASES)
def test_fit_spec_drops_axes_as_the_reference_does(spec, shape, mesh):
    ref = jax_sharding.fit_spec(jax.sharding.PartitionSpec(*spec), shape,
                                _duck(mesh))
    got = tsharding.fit_spec(tsharding.P(*spec), shape, _duck(mesh))
    assert _spec(got) == _spec(ref)


CONSTRAIN_CASES = [
    (("dp", None, "model"), (256, 7, 64)),
    (("dp", None, "model", None), (8, 3, 48, 5)),
    (("dpx", "ep", None, "model"), (64, 160, 5, 32)),
    (("dpx", "ep", None, None), (4, 16, 8, 8)),
    (("dp", "model"), (1, 32)),
    ((None, "data", "model"), (2, 48, 16)),
]


@pytest.mark.parametrize("style", ["tp", "fsdp", "ep"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("axes,shape", CONSTRAIN_CASES)
def test_constrain_spec_resolves_as_the_reference(monkeypatch, style, mesh,
                                                  axes, shape):
    """The reference's ``constrain`` with its constraint call replaced by
    one that returns the spec it was given."""
    monkeypatch.setattr(jax_sharding, "NamedSharding", lambda m, s: s)
    monkeypatch.setattr(jax_sharding, "jax", types.SimpleNamespace(
        lax=types.SimpleNamespace(with_sharding_constraint=lambda x, s: s)))
    x = np.zeros(shape, np.float32)
    with jax_sharding.ctx_mesh(_duck(mesh), style):
        ref = jax_sharding.constrain(x, *axes)
    assert tsharding.constrain_spec(shape, *axes) is None
    with tsharding.ctx_mesh(_duck(mesh), style):
        got = tsharding.constrain_spec(shape, *axes)
        t = torch.zeros(shape)
        assert tsharding.constrain(t, *axes) is t   # plain: unchanged
    assert _spec(got) == _spec(ref)


def test_mesh_views_and_spec_type():
    shape, names = MESHES["multipod"]
    for m in ((shape, names), _duck("multipod")):
        assert tmesh.mesh_shape(m) == {"pod": 2, "data": 16, "model": 16}
        assert tmesh.describe(m) == "mesh{'pod': 2, 'data': 16, 'model': 16}"
    p = tsharding.P(("data",), ("pod", "data"), None)
    assert p == ("data", ("pod", "data"), None)
    assert _spec(jax.sharding.PartitionSpec(("data",), ("pod", "data"),
                                            None)) == p
    import pickle
    assert pickle.loads(pickle.dumps(p)) == p
    assert type(pickle.loads(pickle.dumps(p))) is tsharding.P


@pytest.mark.parametrize("shape", [(8, 64), (3, 5, 128), (1, 7)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantizer_bitwise_the_references_on_its_noise(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 10.0 ** rng.integers(-3, 2)).astype(
        np.float32)
    key = jax.random.key(seed)
    noise = np.asarray(jax.random.uniform(key, x.shape, jnp.float32, -0.5,
                                          0.5))
    rq, rs = jax_compression.quantize_int8(jnp.asarray(x), key)
    tq, ts = tcompression.quantize_int8_noise(torch.from_numpy(x),
                                              torch.from_numpy(noise))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(
        tcompression.dequantize_int8(tq, ts).numpy(),
        np.asarray(jax_compression.dequantize_int8(rq, rs)))


def test_quantizer_draws_its_noise_from_the_generator():
    x = torch.randn(4, 32)
    a = tcompression.quantize_int8(x, torch.Generator().manual_seed(3))
    b = tcompression.quantize_int8_noise(x, tcompression.uniform_noise(
        x.shape, torch.Generator().manual_seed(3)))
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    noise = tcompression.uniform_noise((1000,), torch.Generator())
    assert -0.5 <= noise.min() and noise.max() < 0.5


# the blocks of these specs, on a (2, 2, 2) mesh over 8 host devices
BLOCK_CASES = [
    ((("pod", "data"), "model"), (8, 6)),
    (("model", ("pod", "data")), (6, 8)),
    ((None, ("data", "model")), (3, 8, 5)),
    ((("pod", "data", "model"),), (16, 3)),
    (("data",), (4, 2)),
    ((), (3, 4)),
]

_JAX_BLOCKS = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
out = []
for spec, shape in json.loads(sys.argv[1]):
    spec = P(*[tuple(e) if isinstance(e, list) else e for e in spec])
    idx = NamedSharding(mesh, spec).devices_indices_map(tuple(shape))
    blocks = {}
    for d, ix in idx.items():
        coord = [int(c) for c in np.argwhere(mesh.devices == d)[0]]
        blocks[str(coord)] = [[s.start or 0, s.stop if s.stop is not None
                               else n] for s, n in zip(ix, shape)]
    out.append(blocks)
print(json.dumps(out))
"""


def test_local_block_is_the_block_jax_gives_the_device():
    """``local_block`` against ``NamedSharding.devices_indices_map`` on 8
    host devices (a child process: this one keeps its single device)."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "-c", _JAX_BLOCKS,
                        json.dumps(BLOCK_CASES)], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    mesh = ((2, 2, 2), ("pod", "data", "model"))
    for (spec, shape), blocks in zip(BLOCK_CASES, got):
        assert len(blocks) == 8
        for coord, want in blocks.items():
            ix = tsharding.local_block(tsharding.P(*spec), shape, mesh,
                                       tuple(json.loads(coord)))
            assert [[s.start, s.stop] for s in ix] == want, (spec, coord)


def test_placements_name_each_mesh_dim_once_in_order():
    from torch.distributed.tensor import Replicate, Shard
    mesh = ((2, 2, 2), ("pod", "data", "model"))
    P = tsharding.P
    assert tsharding.placements(P(("pod", "data"), "model"), mesh) == \
        (Shard(0), Shard(0), Shard(1))
    assert tsharding.placements(P(None, "data"), mesh) == \
        (Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError):
        tsharding.placements(P(("data", "pod")), mesh)
    with pytest.raises(ValueError):
        tsharding.placements(P("data", "data"), mesh)
    with pytest.raises(ValueError):
        tsharding.local_block(P("data"), (3,), mesh, (0, 1, 0))


@pytest.mark.parametrize("arch,shape", [
    (a, sh) for a in jax_config.ARCH_IDS for sh in jax_config.SHAPES])
def test_builders_give_the_tables_and_meta_inputs_with_no_group(arch, shape):
    """``steps.build`` on a mesh spec (no process group): its in/out specs
    are the tables' (parameters and moments in ``param_list`` order; the
    tables are held to the reference's above), and its abstract inputs
    live on the meta device in the shapes of ``input_specs`` and the
    abstract model."""
    _, tcfg = _cfgs(arch, "tp")
    mesh = MESHES["multipod"]
    tshape = torch_config.SHAPES[shape]
    _, in_sh, out_sh, abstract = tsteps.build(tcfg, tshape, mesh)
    model = tsteps.lm.LM(tcfg, tsteps.abstract_params(tcfg))
    pspecs = tsharding.param_list_specs(tcfg, model, mesh)
    assert in_sh[0] == pspecs
    assert in_sh[-1] == tsharding.batch_specs(tcfg, tshape, mesh)
    assert [p.shape for p in abstract[0]] == [p.shape for p in
                                              model.param_list()]
    want = tapi.input_specs(tcfg, tshape)
    assert {k: (t.shape, t.dtype) for k, t in abstract[-1].items()} == \
        {k: (t.shape, t.dtype) for k, t in want.items()}
    leaves = jax.tree_util.tree_leaves(abstract)
    assert leaves and all(t.device.type == "meta" for t in leaves)
    if tshape.kind == "train":
        assert in_sh[1] == tsharding.opt_specs(pspecs)
        assert out_sh[:2] == in_sh[:2]
        assert [m.shape for m in abstract[1]["m"]] == [
            p.shape for p in model.param_list()]
    elif tshape.kind == "decode":
        assert in_sh[1] == tsharding.cache_specs(
            tcfg, tshape, mesh, tsteps.abstract_cache(tcfg, tshape))
        assert out_sh[1] == in_sh[1]
