"""The port's PyTorch tracing frontend against the JAX package's.

The same bundled programs, written once in JAX (``repro.core.frontend``)
and once in PyTorch (``repro_torch.core.frontend``), must trace to the same
Program IR: the same task shapes, the same program text, and therefore the
same ``hls.compile`` frontier.  The port's ``validate()`` runs the PyTorch
function in float64 on the CPU against its own ``sim.sequential_exec``
(float64 at rtol=1e-12, as the JAX suite).  Only the reference's tracing is
used here, never its ``validate``, which needs JAX's ``enable_x64``.
"""
import numpy as np
import pytest
import torch

from repro.core import cache as ref_cache
from repro.core import frontend as ref_frontend
from repro.core import hls as ref_hls
from repro.core.ir import nest_shape as ref_nest_shape
from repro_torch.core import cache, codegen, frontend, hls, sim
from repro_torch.core.dataflow import RESOURCE_KEYS
from repro_torch.core.errors import UntraceableFunction
from repro_torch.core.ir import nest_shape
from repro_torch.kernels.stencil_pipeline import restricted_spec

BUNDLED = ("wkv6_program", "conv_block_program", "attention_program")


@pytest.fixture(autouse=True)
def _port_fault_free():
    from repro_torch.core import faults
    faults.reset()
    yield
    faults.reset()


@pytest.fixture(scope="module")
def traced():
    return {name: (getattr(ref_frontend, name)(), getattr(frontend, name)())
            for name in BUNDLED}


def _point(c) -> tuple:
    return (c.desc, c.latency, tuple(c.res[k] for k in RESOURCE_KEYS))


# ---------------------------------------------------------------------------
# the bundled programs trace to the reference's IR
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", BUNDLED)
def test_nest_shape_kinds_equal_reference(name, traced):
    ref, port = traced[name]
    assert nest_shape(port.program).kinds == \
        ref_nest_shape(ref.program).kinds


@pytest.mark.parametrize("name", BUNDLED)
def test_program_text_equals_reference(name, traced):
    ref, port = traced[name]
    assert cache.program_text(port.program) == \
        ref_cache.program_text(ref.program)
    assert (port.in_names, port.out_names) == (ref.in_names, ref.out_names)
    assert (port.in_shapes, port.out_shapes) == (ref.in_shapes,
                                                 ref.out_shapes)
    for a in port.in_names + port.out_names:
        assert port.program.arrays[a].is_arg


@pytest.mark.parametrize("name", BUNDLED)
def test_frontier_equals_reference(name, traced):
    ref, port = traced[name]
    want = ref_hls.compile(ref.program, **restricted_spec(ref_hls))
    got = hls.compile(port.program, **restricted_spec(hls))
    assert [_point(c) for c in got.frontier] == \
        [_point(c) for c in want.frontier]
    assert _point(got.best) == _point(want.best)


@pytest.mark.parametrize("name", BUNDLED)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_validate_against_the_pytorch_function(name, seed, traced):
    assert traced[name][1].validate(seed=seed, rtol=1e-12) <= 1e-12


def test_wkv6_is_a_multi_loop_task(traced):
    assert "multi_loop" in nest_shape(traced["wkv6_program"][1].program).kinds


def test_core_exports():
    from repro_torch.core import TracedProgram, UntraceableFunction as UF
    from repro_torch.core import scan, trace
    assert trace is frontend.trace and TracedProgram is frontend.TracedProgram
    assert scan is frontend.scan and UF is UntraceableFunction


# ---------------------------------------------------------------------------
# the op set and its edges
# ---------------------------------------------------------------------------


def test_scalar_constant_folding():
    """Pure-constant subexpressions fold at trace time, not into nests."""
    def f(x):
        return x * (2.0 * 3.0)

    tp = frontend.trace(f, np.zeros((4,), np.float32))
    assert len(tp.program.body) == 2       # the product, the output copy
    assert tp.validate() <= 1e-12


def test_untraceable_op_raises():
    def f(x):
        return torch.sin(x)

    with pytest.raises(UntraceableFunction, match="sin"):
        frontend.trace(f, torch.zeros(4))


def test_untraceable_reshape_raises():
    def f(x):
        return x.reshape(2, 2)

    with pytest.raises(UntraceableFunction, match="reshape"):
        frontend.trace(f, np.zeros((4,), np.float32))


def test_constant_tensors_lift_to_scalars_or_raise():
    """A uniform constant (``torch.full``, ``torch.zeros``) is the literal
    it holds; a constant with distinct elements is refused."""
    def uniform(x):
        return x * torch.full((3,), 2.5) + torch.zeros(3)

    tp = frontend.trace(uniform, torch.zeros(3))
    assert tp.validate() <= 1e-12

    ramp = torch.arange(3.0)

    def distinct(x):
        return x * ramp

    with pytest.raises(UntraceableFunction, match="constant"):
        frontend.trace(distinct, torch.zeros(3))


def test_views_reductions_and_contractions():
    """Transposes, permutes, ``unsqueeze``/``squeeze``, ``expand``,
    indexing with ``None``/``...``/strides, keepdim reductions, a 1-D
    contraction and an integer power, held against the function."""
    def f(a, b, v):
        c = (a.T @ b).unsqueeze(0).squeeze(0)          # (3, 3)
        d = torch.maximum(c, b.t()[..., :3]) - a[1:, None][0].expand(3, 3)
        e = (-d).permute(1, 0) ** 2
        return (e.sum(), e.amin(dim=0, keepdim=True), v @ a,
                a[::2, 1] / torch.amax(a, dim=(0, 1)))

    tp = frontend.trace(f, torch.zeros(4, 3), torch.zeros(4, 3),
                        torch.zeros(4))
    assert tp.out_shapes == ((), (1, 3), (3,), (2,))
    assert tp.validate(seed=1) <= 1e-12


def test_scan_with_a_tuple_carry_and_a_closure():
    """A scan carrying two states and closing over an argument traces to
    the recurrence loop and matches the eager loop."""
    def f(xs, u):
        def step(c, x):
            a, b = c
            return (a + x * u, b * 0.5 + a), a * b

        c, ys = frontend.scan(step, (torch.zeros(3), torch.ones(3)), xs)
        return c[0], ys

    tp = frontend.trace(f, torch.zeros(5, 3), torch.zeros(3))
    assert "multi_loop" in nest_shape(tp.program).kinds
    assert tp.out_shapes == ((3,), (5, 3))
    assert tp.validate(seed=2) <= 1e-12


def test_scan_eager_is_a_loop():
    xs = torch.arange(12.0).reshape(4, 3)
    carry, ys = frontend.scan(lambda c, x: (c + x, c * x), torch.ones(3), xs)
    want_c, want_y = torch.ones(3), []
    for x in xs:
        want_c, y = want_c + x, want_c * x
        want_y.append(y)
    assert torch.equal(carry, want_c)
    assert torch.equal(ys, torch.stack(want_y))


# ---------------------------------------------------------------------------
# the traced conv block on the card's path: Mode B
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hw", [(8, 8), (10, 13)])
def test_conv_block_lowers_to_whole_and_matches_the_oracle(hw):
    tp = frontend.conv_block_program(*hw)
    k = codegen.lower_program(tp.program, dtype="float64")
    assert k.mode == "whole" and k.nest_launches == 2
    assert k.inputs == ("img", "wx", "wy")
    inputs = sim.make_inputs(tp.program, seed=3)
    want = sim.sequential_exec(tp.program, inputs)
    got = k(inputs, device="cpu")
    for a in k.outputs:
        np.testing.assert_allclose(got[a].numpy(), want[a], rtol=1e-12,
                                   atol=0, err_msg=a)


def test_conv_block_equals_the_stencil_kernel_in_f32():
    """The traced conv block's plain version is K1's, bit for bit."""
    from repro_torch.kernels import stencil_pipeline as sp
    tp = frontend.conv_block_program(12, 20)
    k = codegen.lower_program(tp.program)
    x = {a: torch.from_numpy(v).float()
         for a, v in sim.make_inputs(tp.program, seed=4).items()
         if a in k.inputs}
    got = k(x)["out"]
    assert torch.equal(got, sp.stencil_pipeline_plain(x["img"], x["wx"],
                                                      x["wy"]))
