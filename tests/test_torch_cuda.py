"""The port's CUDA kernels on the card, each against its plain PyTorch
version (and K2 and K3 in float64 against the sequential oracle).

A CUDA kernel has no CPU mode, so every test here is marked
``requires_cuda`` and skips where ``torch.cuda.is_available()`` is false.
The file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m requires_cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import codegen, programs, sim
from repro_torch.kernels import stencil_pipeline as sp

W3 = [0.25, 0.5, 0.25]
CHAINS = sorted(programs.CHAIN_BENCHMARKS)


@pytest.fixture(autouse=True)
def _port_fault_free():
    from repro_torch.core import faults
    faults.reset()
    yield
    faults.reset()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("H,W,br", [(18, 32, 8), (34, 300, 4), (66, 130, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stencil_kernel_equals_plain(cuda_device, H, W, br, dtype):
    img = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (H, W)).astype(np.float32)).to(cuda_device, getattr(torch, dtype))
    w = torch.tensor(W3, device=cuda_device)
    n0 = sp.LAUNCHES[dtype]
    got = sp.stencil_pipeline(img, w, w, block_rows=br, halo=2)
    torch.cuda.synchronize()
    assert sp.LAUNCHES[dtype] == n0 + 1
    assert torch.equal(got, sp.stencil_pipeline_plain(img, w, w))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", CHAINS)
def test_streamed_kernel_equals_plain(cuda_device, name):
    p = programs.CHAIN_BENCHMARKS[name](66, storage="bram")
    inputs = sim.make_inputs(p, seed=0)
    kd = codegen.lower_program(p, block_rows=4)        # partial last tile
    ks = codegen.lower_program(p, block_rows=4, buffering="single")
    xs = {a: torch.as_tensor(inputs[a], dtype=torch.float32,
                             device=cuda_device) for a in kd.inputs}
    od, os_, plain = kd(xs), ks(xs), kd.plain(xs)
    torch.cuda.synchronize()
    for a in kd.outputs:
        assert torch.equal(od[a], plain[a])
        assert torch.equal(os_[a], plain[a])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", CHAINS)
def test_streamed_float64_matches_sequential_exec(cuda_device, name):
    p = programs.CHAIN_BENCHMARKS[name](16, storage="bram")
    inputs = sim.make_inputs(p, seed=1)
    want = sim.sequential_exec(p, inputs)
    k = codegen.lower_program(p, block_rows=4, dtype="float64")
    got = k(inputs)                     # numpy input: runs on the card
    for a in k.outputs:
        assert got[a].is_cuda
        np.testing.assert_allclose(got[a].cpu().numpy(), want[a],
                                   rtol=1e-12, atol=0)


@pytest.mark.requires_cuda
def test_blur_chain_streamed_equals_stencil_kernel(cuda_device):
    p = programs.blur_chain(130)
    img = torch.as_tensor(sim.make_inputs(p, seed=5)["img"],
                          dtype=torch.float32, device=cuda_device)
    got = codegen.lower_program(p, block_rows=2)({"img": img})["by"]
    w = torch.tensor([1 / 3, 1 / 2, 1 / 3], device=cuda_device)
    assert torch.equal(got, sp.stencil_pipeline(img, w, w, block_rows=2,
                                                halo=2))


# ---------------------------------------------------------------------------
# K3: the whole-array kernel
# ---------------------------------------------------------------------------

WHOLE = {"dus": 66, "optical_flow": 65, "two_mm": 33}


def _whole_programs():
    from repro_torch.core import frontend
    progs = {name: programs.BENCHMARKS[name](n, storage="bram")
             for name, n in WHOLE.items()}
    progs["traced_conv"] = frontend.conv_block_program(34, 40).program
    return progs


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", [*sorted(WHOLE), "traced_conv"])
def test_whole_kernel_equals_plain(cuda_device, name):
    p = _whole_programs()[name]
    k = codegen.lower_program(p)
    assert k.mode == "whole"
    inputs = sim.make_inputs(p, seed=0)
    xs = {a: torch.as_tensor(inputs[a], dtype=torch.float32,
                             device=cuda_device) for a in k.inputs}
    n0 = codegen.LAUNCHES[k.launch_key]
    got, plain = k(xs), k.plain(xs)
    torch.cuda.synchronize()
    assert codegen.LAUNCHES[k.launch_key] == n0 + 1
    for a in k.outputs:
        torch.testing.assert_close(got[a], plain[a], rtol=0, atol=0,
                                   equal_nan=True)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", [*sorted(WHOLE), "traced_conv"])
def test_whole_float64_matches_sequential_exec(cuda_device, name):
    from repro_torch.core import frontend
    p = (frontend.conv_block_program(10, 10).program if name == "traced_conv"
         else programs.BENCHMARKS[name](16, storage="bram"))
    inputs = sim.make_inputs(p, seed=1)
    want = sim.sequential_exec(p, inputs)
    k = codegen.lower_program(p, dtype="float64")
    got = k(inputs)                     # numpy input: runs on the card
    for a in k.outputs:
        assert got[a].is_cuda
        np.testing.assert_allclose(got[a].cpu().numpy(), want[a],
                                   rtol=1e-12, atol=0, err_msg=a)


@pytest.mark.requires_cuda
def test_whole_overlapping_stores_follow_op_order(cuda_device):
    """Two stores of one nest that overlap: one launch each, in op order,
    the later store winning, as the plain version (and the reference)."""
    from repro_torch.core.ir import ProgramBuilder
    b = ProgramBuilder("two_store_overlap")
    b.array("x", (64, 48), is_arg=True, ports=("r", "r"))
    b.array("y", (65, 48), is_arg=True, ports=("w",))
    with b.loop("i", 0, 64) as i:
        with b.loop("j", 0, 48) as j:
            a = b.load("x", i, j)
            b.store("y", b.mul(a, b.const(3.0)), i, j)
            b.store("y", b.add(a, b.const(1.0)), i + 1, j)
    k = codegen.lower_program(b.build())
    assert k.nest_launches == 2
    inputs = sim.make_inputs(b.build(), seed=2)
    xs = {a: torch.as_tensor(inputs[a], dtype=torch.float32,
                             device=cuda_device) for a in k.inputs}
    got = k(xs)["y"]
    assert torch.equal(got, k.plain(xs)["y"])
    assert torch.equal(got[1:], xs["x"] + 1.0)


@pytest.mark.requires_cuda
def test_traced_conv_block_equals_stencil_kernel(cuda_device):
    """The traced PyTorch conv block through K3 is K1, bit for bit."""
    from repro_torch.core import frontend
    p = frontend.conv_block_program(66, 300).program
    k = codegen.lower_program(p)
    inputs = sim.make_inputs(p, seed=5)
    xs = {a: torch.as_tensor(inputs[a], dtype=torch.float32,
                             device=cuda_device) for a in k.inputs}
    got = k(xs)["out"]
    assert torch.equal(got, sp.stencil_pipeline(xs["img"], xs["wx"],
                                                xs["wy"], block_rows=2,
                                                halo=2))
