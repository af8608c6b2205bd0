"""The port's CUDA kernels on the card, each against its plain PyTorch
version (and K2 and K3 in float64 against the sequential oracle).

A CUDA kernel has no CPU mode, so every test here is marked
``requires_cuda`` and skips where ``torch.cuda.is_available()`` is false.
The file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m requires_cuda tests/test_torch_cuda.py
"""
import time

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


def _k1_call(img, br, halo):
    """One K1 call on the card: its result and the launches it counted."""
    w = torch.tensor(W3, device=img.device)
    dt = str(img.dtype).removeprefix("torch.")
    n0 = sp.LAUNCHES[dt]
    got = sp.stencil_pipeline(img, w, w, block_rows=br, halo=halo)
    torch.cuda.synchronize()
    return got, sp.LAUNCHES[dt] - n0, sp.stencil_pipeline_plain(img, w, w)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("halo", [2, 3])
@pytest.mark.parametrize("br", [1, 2, 4, 8])
@pytest.mark.parametrize("H", [10, 42])
@pytest.mark.parametrize("W", [3, 4, 5, 130, 131, 4098])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stencil_walk_edge_shapes_equal_plain(cuda_device, dtype, W, H, br,
                                              halo):
    """The walk at one output column, a few, odd row strides, the traced
    conv block's width, one run and ragged runs, halo > 2: bit for bit the
    plain version, one launch a call."""
    img = torch.from_numpy(np.random.default_rng(H * W).standard_normal(
        (H, W)).astype(np.float32)).to(cuda_device, getattr(torch, dtype))
    got, launches, want = _k1_call(img, br, halo)
    assert launches == 1
    assert torch.equal(got, want)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("base", [1, 2, 3, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stencil_walk_on_unaligned_views_equals_plain(cuda_device, dtype,
                                                      base):
    """An image that starts ``base`` elements into its storage: rows read
    in 8-, 4- or 2-byte pieces."""
    H, W = 26, 131
    flat = torch.from_numpy(np.random.default_rng(base).standard_normal(
        H * W + base).astype(np.float32)).to(cuda_device,
                                             getattr(torch, dtype))
    img = flat[base:].view(H, W)
    assert img.data_ptr() % 16 != 0
    got, launches, want = _k1_call(img, 2, 2)
    assert launches == 1
    assert torch.equal(got, want)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stencil_walk_nan_and_inf_equal_plain(cuda_device, dtype):
    """NaN and +-inf go through the walk as through the plain version."""
    x = np.random.default_rng(7).standard_normal((42, 131)).astype(
        np.float32)
    x[1, 2] = np.nan
    x[5, 0] = np.inf
    x[20, 64:70] = -np.inf
    x[41, 130] = np.nan
    img = torch.from_numpy(x).to(cuda_device, getattr(torch, dtype))
    got, launches, want = _k1_call(img, 2, 2)
    assert launches == 1
    assert bool(got.isnan().any()) and bool(got.isinf().any())
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stencil_walk_full_frame_equals_plain(cuda_device, dtype):
    """The 4K UHD frame at the DSE's configuration."""
    img = torch.from_numpy(np.random.default_rng(0).uniform(
        0.0, 1.0, (2160, 3840)).astype(np.float32)).to(
            cuda_device, getattr(torch, dtype))
    got, launches, want = _k1_call(img, *sp._stencil_codegen_config())
    assert launches == 1
    assert torch.equal(got, want)


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


STREAMED = CHAINS + ["harris", "unsharp"]


def _streamed(name, n):
    return {**programs.CHAIN_BENCHMARKS, "harris": programs.harris,
            "unsharp": programs.unsharp}[name](n, storage="bram")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", STREAMED)
@pytest.mark.parametrize("col_tile", [32, 48])
def test_streamed_column_tiles_equal_plain(cuda_device, monkeypatch, name,
                                           col_tile):
    """Column tiles on the card (ragged last row and column tiles; conv_pool
    at column stride 2): double == single == plain, bitwise in f32."""
    monkeypatch.setattr(codegen, "_COL_TILES", (col_tile,))
    p = _streamed(name, 150)
    inputs = sim.make_inputs(p, seed=0)
    kd = codegen.lower_program(p, block_rows=4)
    ks = codegen.lower_program(p, block_rows=4, buffering="single")
    assert kd.launch_grid[1] > 1
    xs = {a: torch.as_tensor(inputs[a], dtype=torch.float32,
                             device=cuda_device) for a in kd.inputs}
    n0 = codegen.LAUNCHES[kd.launch_key]
    od, os_, plain = kd(xs), ks(xs), kd.plain(xs)
    torch.cuda.synchronize()
    assert codegen.LAUNCHES[kd.launch_key] == n0 + 1
    for a in kd.outputs:
        assert torch.equal(od[a], plain[a])
        assert torch.equal(os_[a], plain[a])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", STREAMED)
def test_streamed_column_tiles_float64_match_sequential_exec(cuda_device,
                                                             monkeypatch,
                                                             name):
    monkeypatch.setattr(codegen, "_COL_TILES", (16,))
    p = _streamed(name, 40)
    inputs = sim.make_inputs(p, seed=1)
    want = sim.sequential_exec(p, inputs)
    for buffering in ("double", "single"):
        k = codegen.lower_program(p, block_rows=3, buffering=buffering,
                                  dtype="float64")
        got = k(inputs)                 # numpy input: runs on the card
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


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", STREAMED)
@pytest.mark.parametrize("run", [1, 3])
@pytest.mark.parametrize("ahead", [1, 2])
def test_streamed_ragged_runs_equal_plain(cuda_device, monkeypatch, name,
                                          run, ahead):
    """Blocks walking runs of 1 and 3 row tiles (38 tiles at n=150, 19 for
    conv_pool: the last run ragged) over ragged column tiles of 32, with
    the input rows of 1 or 2 tiles in flight: the rings, their slots and
    the staged input rows, double == single == plain, bitwise in f32."""
    monkeypatch.setattr(codegen, "_RUN_TILES", run)
    monkeypatch.setattr(codegen, "_AHEAD", ahead)
    monkeypatch.setattr(codegen, "_COL_TILES", (32,))
    p = _streamed(name, 150)
    inputs = sim.make_inputs(p, seed=2)
    kd = codegen.lower_program(p, block_rows=4)
    ks = codegen.lower_program(p, block_rows=4, buffering="single")
    assert kd.run == run and (run == 1 or kd.grid[0] % run != 0)
    assert kd.launch_grid == (-(-kd.grid[0] // run), kd.launch_grid[1])
    xs = {a: torch.as_tensor(inputs[a], dtype=torch.float32,
                             device=cuda_device) for a in kd.inputs}
    n0 = codegen.LAUNCHES[kd.launch_key]
    od, os_, plain = kd(xs), ks(xs), kd.plain(xs)
    torch.cuda.synchronize()
    assert codegen.LAUNCHES[kd.launch_key] == n0 + 1
    for a in kd.outputs:
        assert torch.equal(od[a], plain[a])
        assert torch.equal(os_[a], plain[a])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", STREAMED)
@pytest.mark.parametrize("run", [1, 3])
def test_streamed_ragged_runs_float64_match_sequential_exec(
        cuda_device, monkeypatch, name, run):
    monkeypatch.setattr(codegen, "_RUN_TILES", run)
    monkeypatch.setattr(codegen, "_COL_TILES", (16,))
    p = _streamed(name, 40)
    inputs = sim.make_inputs(p, seed=4)
    want = sim.sequential_exec(p, inputs)
    for buffering in ("double", "single"):
        k = codegen.lower_program(p, block_rows=3, buffering=buffering,
                                  dtype="float64")
        assert k.run == run
        got = k(inputs)                 # numpy input: runs on the card
        for a in k.outputs:
            np.testing.assert_allclose(got[a].cpu().numpy(), want[a],
                                       rtol=1e-12, atol=0)


def _mixed_rates(n):
    """img read at row i by bx and at row 2i by the sink: two row rates,
    so the kernel reads it from device memory, not through a ring."""
    from repro_torch.core.ir import ProgramBuilder
    b = ProgramBuilder("mixed_rates")
    b.array("img", (2 * n + 2, n + 2), is_arg=True)
    b.array("bx", (n + 2, n))
    b.array("out", (n, n), is_arg=True)
    with b.loop("bxi", 0, n + 2) as i:
        with b.loop("bxj", 0, n) as j:
            b.store("bx", b.add(b.load("img", i, j), b.load("img", i, j + 2)),
                    i, j)
    with b.loop("oi", 0, n) as i:
        with b.loop("oj", 0, n) as j:
            s = b.add(b.load("bx", i, j), b.load("bx", i + 2, j))
            b.store("out", b.sub(s, b.load("img", i * 2, j + 1)), i, j)
    return b.build()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n,col_tile", [(41, 16), (150, 32)])
def test_streamed_input_at_two_row_rates_equals_plain(cuda_device,
                                                       monkeypatch, n,
                                                       col_tile):
    monkeypatch.setattr(codegen, "_RUN_TILES", 3)
    monkeypatch.setattr(codegen, "_COL_TILES", (col_tile,))
    p = _mixed_rates(n)
    xs = {a: torch.as_tensor(v, dtype=torch.float32, device=cuda_device)
          for a, v in sim.make_inputs(p, seed=7).items() if a == "img"}
    kd = codegen.lower_program(p, block_rows=4)
    ks = codegen.lower_program(p, block_rows=4, buffering="single")
    assert "__ldg(x_img" in kd.source
    plain = kd.plain(xs)["out"]
    assert torch.equal(kd(xs)["out"], plain)
    assert torch.equal(ks(xs)["out"], plain)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("run", [1, 3])
def test_blur_chain_ragged_runs_equal_stencil_kernel(cuda_device,
                                                     monkeypatch, run):
    monkeypatch.setattr(codegen, "_RUN_TILES", run)
    p = programs.blur_chain(134)
    img = torch.as_tensor(sim.make_inputs(p, seed=6)["img"],
                          dtype=torch.float32, device=cuda_device)
    k = codegen.lower_program(p, block_rows=4)
    assert k.run == run and k.grid[0] % 3 != 0
    w = torch.tensor([1 / 3, 1 / 2, 1 / 3], device=cuda_device)
    assert torch.equal(k({"img": img})["by"],
                       sp.stencil_pipeline(img, w, w, block_rows=2, halo=2))


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
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("m", [33, 130, 132, 257])
def test_two_mm_tiled_kernel_equals_plain(cuda_device, m, dtype):
    """The tiled reductions across edge tiles and k tails, bit for bit
    (NaN-aware), in both dtypes.  Rows of a multiple of 16 bytes (132; 130
    in f64) read the (i, k) operand through 16-byte loads into registers,
    the others copy it element by element."""
    p = programs.two_mm(m)
    k = codegen.lower_program(p, dtype=dtype)
    assert k.tiled_reductions == ("pi", "ci")
    inputs = sim.make_inputs(p, seed=m)
    xs = {a: torch.as_tensor(inputs[a], dtype=getattr(torch, dtype),
                             device=cuda_device) for a in k.inputs}
    got, plain = k(xs), k.plain(xs)
    torch.cuda.synchronize()
    for a in k.outputs:
        torch.testing.assert_close(got[a], plain[a], rtol=0, atol=0,
                                   equal_nan=True)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_two_mm_tiled_kernel_reads_unaligned_inputs(cuda_device, dtype):
    """Inputs one element past a 16-byte boundary take the element-wise
    loads and copies in place of the 16-byte ones, bit for bit."""
    m = 132
    p = programs.two_mm(m)
    k = codegen.lower_program(p, dtype=dtype)
    inputs = sim.make_inputs(p, seed=m)
    xs = {}
    for a in k.inputs:
        buf = torch.empty(m * m + 1, dtype=getattr(torch, dtype),
                          device=cuda_device)
        xs[a] = buf[1:].view(m, m)
        xs[a].copy_(torch.as_tensor(inputs[a]))
        assert xs[a].data_ptr() % 16 != 0
    got, plain = k(xs), k.plain(xs)
    torch.cuda.synchronize()
    for a in k.outputs:
        torch.testing.assert_close(got[a], plain[a], rtol=0, atol=0,
                                   equal_nan=True)


K3_LAUNCHES = {"dus": 4, "optical_flow": 2, "two_mm": 2, "traced_conv": 2}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", sorted(K3_LAUNCHES))
def test_whole_kernel_launches_per_call(cuda_device, name):
    """One wrapper call is one count and ``nest_launches`` CUDA kernels,
    as the profiler sees them on the card."""
    p = _whole_programs()[name]
    k = codegen.lower_program(p)
    assert k.nest_launches == len(k.launch_nests) == K3_LAUNCHES[name]
    inputs = sim.make_inputs(p, seed=0)
    xs = {a: torch.as_tensor(inputs[a], dtype=torch.float32,
                             device=cuda_device) for a in k.inputs}
    k(xs)
    torch.cuda.synchronize()
    n0 = codegen.LAUNCHES[k.launch_key]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        # the card idles at both ends of the window, so that no kernel's
        # record falls outside it (as chip_smoke.device_kernels)
        time.sleep(0.05)
        k(xs)
        torch.cuda.synchronize()
        time.sleep(0.05)
    assert codegen.LAUNCHES[k.launch_key] == n0 + 1
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e.name for e in prof.events()
               if getattr(e, "device_type", None) == cuda
               and "memcpy" not in e.name.lower()
               and "memset" not in e.name.lower()]
    assert len(kernels) == K3_LAUNCHES[name], kernels


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


# ---------------------------------------------------------------------------
# K4 (flash attention) and K5 (WKV6), and the model path through them
# ---------------------------------------------------------------------------

# the kernel and its plain version round the same fp32 sums once: bf16
# outputs differ by at most an ulp (2^-8 relative)
FA_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
          torch.bfloat16: dict(rtol=1e-2, atol=4e-3)}


def _randn(shape, seed, device, dtype=torch.float32):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(device, dtype)


# K4 on contiguous inputs: float32 at every head dim (hd 64 and 128 take
# the tf32x3 kernel at its own tiles), bf16 at hd 16 and 32 (the CUDA-core
# kernel; bf16 at hd 64-256 takes the tensor-core kernel, below)
_FA_SHAPES = [
    (1, 2, 128, 64, 64, 64), (2, 1, 256, 128, 64, 64),
    (1, 2, 192, 64, 64, 32),      # block_q > block_k, causal bound (R2)
    (1, 2, 128, 16, 16, 64),      # block_q < block_k
    (1, 1, 100, 32, 64, 48),      # ragged last tiles
    (1, 2, 64, 256, 64, 64)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,H,S,hd,bq,bk,dtype", [
    (*c, dt) for dt in (torch.float32, torch.bfloat16) for c in _FA_SHAPES
    if dt == torch.float32 or c[3] <= 32])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel_equals_plain(cuda_device, B, H, S, hd, bq, bk,
                                             dtype, causal):
    from repro_torch.kernels import flash_attention as fa
    q, k, v = (_randn((B, H, S, hd), s, cuda_device, dtype) for s in range(3))
    key = f"{fa.route(dtype, hd)}/{str(dtype).removeprefix('torch.')}"
    if key.startswith("tf32x3"):
        bq, bk = fa.TF32X3_BLOCKS[hd]         # the only tiles it takes
    n0 = fa.LAUNCHES[key]
    got = fa.flash_attention(q, k, v, causal=causal, block_q=bq, block_k=bk)
    torch.cuda.synchronize()
    assert fa.LAUNCHES[key] == n0 + 1
    want = fa.flash_attention_plain(q, k, v, causal=causal,
                                    block_q=min(bq, S), block_k=min(bk, S))
    torch.testing.assert_close(got.float(), want.float(), **FA_TOL[dtype])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("hd,bq,bk", [(64, 128, 128), (64, 128, 64),
                                      (128, 128, 128), (128, 128, 64),
                                      (256, 128, 64)])
@pytest.mark.parametrize("B,H,Hkv,S,Sk", [
    (1, 2, 2, 256, 256),          # group 1
    (2, 8, 2, 200, 200),          # group 4, ragged last q and kv tiles
    (1, 4, 1, 136, 328)])         # group 4, Sk != S
@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_wgmma_kernel_equals_plain(cuda_device, hd, bq, bk, B,
                                                   H, Hkv, S, Sk, strided,
                                                   causal):
    """The tensor-core kernel (bf16) against its plain version: GQA groups 1
    and 4, ragged lengths, both block pairs (block_q > block_k included),
    and (strided) transposed views of (B, S, heads, hd) tensors."""
    from repro_torch.kernels import flash_attention as fa

    def make(heads, n, seed):
        if strided:
            return _randn((B, n, heads, hd), seed, cuda_device,
                          torch.bfloat16).transpose(1, 2)
        return _randn((B, heads, n, hd), seed, cuda_device, torch.bfloat16)
    q, k, v = make(H, S, 0), make(Hkv, Sk, 1), make(Hkv, Sk, 2)
    n0 = fa.LAUNCHES["wgmma/bfloat16"]
    got = fa.flash_attention(q, k, v, causal=causal, block_q=bq, block_k=bk)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["wgmma/bfloat16"] == n0 + fa.fwd_launches(
        torch.bfloat16, hd, B, H, Hkv, S, Sk, causal)
    assert got.stride() == q.stride()         # the output takes q's layout
    want = fa.flash_attention_plain(q, k, v, causal=causal, block_q=bq,
                                    block_k=bk,
                                    split=fa.split_route(torch.bfloat16, hd))
    torch.testing.assert_close(got.float(), want.float(),
                               **FA_TOL[torch.bfloat16])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("draw", ["randn", "peaky"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_tf32x3_kernel_equals_plain(cuda_device, hd, draw,
                                                    causal):
    """K4 in f32 against its plain version within 2e-5 — the tensor-core
    kernel (3xTF32, wgmma) at hd 64 and 128, the CUDA-core kernel at the
    others: on N(0, 1) inputs and on a peaky draw (q x 4: a few keys
    dominate each row and the outputs are O(1), where TF32's error would
    show first), GQA group 2 on transposed views of (B, S, heads, hd)
    tensors, a ragged last q and kv tile.  The tensor-core kernel at its
    own 64 x 32 tiles (the only blocks it takes), the CUDA-core kernel at
    three block pairs, block_q > block_k and a block_k that is not a
    multiple of 8 among them; the plain version walks the same blocks."""
    from repro_torch.kernels import flash_attention as fa
    B, H, Hkv, S = 2, 4, 2, 136
    q, k, v = (_randn((B, S, h, hd), seed, cuda_device).transpose(1, 2)
               for seed, h in ((0, H), (1, Hkv), (2, Hkv)))
    if draw == "peaky":
        q = q * 4.0
    key = f"{fa.route(torch.float32, hd)}/float32"
    pairs = ([fa.TF32X3_BLOCKS[hd]] if key.startswith("tf32x3")
             else [(64, 64), (64, 32), (48, 20)])
    for bq, bk in pairs:
        n0 = fa.LAUNCHES[key]
        got = fa.flash_attention(q, k, v, causal=causal, block_q=bq,
                                 block_k=bk)
        torch.cuda.synchronize()
        assert fa.LAUNCHES[key] == n0 + 1
        if key.startswith("tf32x3"):          # the output takes q's layout
            assert got.stride() == q.stride()
        want = fa.flash_attention_plain(q, k, v, causal=causal, block_q=bq,
                                        block_k=bk)
        torch.testing.assert_close(got, want, **FA_TOL[torch.float32])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("hd,H,Hkv,S", [
    (64, 12, 12, 448),            # Whisper's decoder: 448 = 3.5 q blocks
    (256, 8, 1, 1024)])           # PaliGemma: MQA, one kv head
@pytest.mark.parametrize("draw", ["randn", "peaky"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_wgmma_at_the_encdec_and_vlm_shapes(cuda_device, hd,
                                                            H, Hkv, S, draw,
                                                            causal):
    """The tensor-core kernel (bf16) at the shapes the Whisper and
    PaliGemma paths hand it, on views of (B, S, heads, hd) tensors: hd 64
    with a ragged last q block, hd 256 with one kv head for all 8 q heads;
    N(0, 1) and peaky draws (q x 4), every block pair it takes."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = (_randn((1, S, h, hd), seed, cuda_device,
                      torch.bfloat16).transpose(1, 2)
               for seed, h in ((0, H), (1, Hkv), (2, Hkv)))
    if draw == "peaky":
        q = q * 4.0
    for bq, bk in fa.WGMMA_BLOCKS[hd]:
        n0 = fa.LAUNCHES["wgmma/bfloat16"]
        got = fa.flash_attention(q, k, v, causal=causal, block_q=bq,
                                 block_k=bk)
        torch.cuda.synchronize()
        assert fa.LAUNCHES["wgmma/bfloat16"] == n0 + fa.fwd_launches(
            torch.bfloat16, hd, 1, H, Hkv, S, S, causal)
        want = fa.flash_attention_plain(
            q, k, v, causal=causal, block_q=bq, block_k=bk,
            split=fa.split_route(torch.bfloat16, hd))
        torch.testing.assert_close(got.float(), want.float(),
                                   **FA_TOL[torch.bfloat16])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,H,S,hd", [(1, 2, 128, 64), (2, 1, 256, 32),
                                      (1, 1, 64, 16), (2, 2, 16, 128),
                                      (4, 40, 1, 64)])
@pytest.mark.parametrize("with_state", [False, True])
def test_wkv6_kernel_equals_plain(cuda_device, B, H, S, hd, with_state):
    from repro_torch.kernels import wkv6 as wk
    r, k, v = (_randn((B, H, S, hd), s, cuda_device) for s in range(3))
    w = torch.sigmoid(_randn((B, H, S, hd), 3, cuda_device)) * 0.5 + 0.45
    u = _randn((H, hd), 4, cuda_device) * 0.1
    s0 = _randn((B, H, hd, hd), 5, cuda_device) if with_state else None
    n0 = sum(wk.LAUNCHES.values())
    out, s = wk.wkv6_state(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    # the step is one launch, the sequence form three
    assert sum(wk.LAUNCHES.values()) == n0 + (
        1 if S == 1 else wk.SEQUENCE_LAUNCHES)
    want, want_s = wk.wkv6_plain(r, k, v, w, u, s0)
    torch.testing.assert_close(out, want, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(s, want_s, rtol=2e-4, atol=2e-4)


@pytest.mark.requires_cuda
def test_wkv6_kernel_strong_decay_is_finite(cuda_device):
    from repro_torch.kernels import wkv6 as wk
    r, k, v = (_randn((1, 2, 128, 64), s, cuda_device) for s in range(3))
    w = torch.full_like(r, 0.1)
    u = _randn((2, 64), 4, cuda_device) * 0.1
    out, s = wk.wkv6_state(r, k, v, w, u)
    assert torch.isfinite(out).all() and torch.isfinite(s).all()
    want, want_s = wk.wkv6_plain(r, k, v, w, u)
    torch.testing.assert_close(out, want, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(s, want_s, rtol=2e-4, atol=2e-4)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("hd", [16, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hkv", [1, 2, 6])
@pytest.mark.parametrize("draw", ["randn", "peaky"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_cuda_core_reads_gqa_views(cuda_device, hd, dtype, Hkv,
                                                   draw, causal):
    """The CUDA-core kernel on the layer's own tensors: .transpose(1, 2)
    views of (B, S, heads, hd), 6 q heads over Hkv kv heads, a ragged
    length, one launch a call, the output in q's layout; its default blocks
    and three other pairs (block_q > block_k, a block_k not a multiple of
    8), each against the plain version walking the same blocks."""
    from repro_torch.kernels import flash_attention as fa
    B, H, S = 2, 6, 200
    q, k, v = (_randn((B, S, h, hd), seed, cuda_device, dtype).transpose(1, 2)
               for seed, h in ((0, H), (1, Hkv), (2, Hkv)))
    if draw == "peaky":
        q = (q.float() * 4.0).to(dtype)
    key = f"cuda_cores/{str(dtype).removeprefix('torch.')}"
    assert fa.route(dtype, hd) == "cuda_cores"
    for bq, bk in [fa.CUDA_CORE_BLOCKS, (64, 64), (32, 48), (48, 20)]:
        n0 = fa.LAUNCHES[key]
        got = fa.flash_attention(q, k, v, causal=causal, block_q=bq,
                                 block_k=bk)
        torch.cuda.synchronize()
        assert fa.LAUNCHES[key] == n0 + 1
        assert got.stride() == q.stride()
        want = fa.flash_attention_plain(q, k, v, causal=causal, block_q=bq,
                                        block_k=bk)
        torch.testing.assert_close(got.float(), want.float(), **FA_TOL[dtype])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("S,Sk,causal", [(100, 300, False), (328, 328, True),
                                         (64, 64, True)])
def test_flash_attention_tf32x3_hd256_cross_lengths(cuda_device, S, Sk,
                                                    causal):
    """f32 at hd 256 on the tensor cores (64 x 16 tiles): kv longer than q,
    ragged q and kv tiles, GQA group 2, against the plain version."""
    from repro_torch.kernels import flash_attention as fa
    q = _randn((1, 4, S, 256), 0, cuda_device)
    k, v = (_randn((1, 2, Sk, 256), s, cuda_device) for s in (1, 2))
    n0 = fa.LAUNCHES["tf32x3/float32"]
    got = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["tf32x3/float32"] == n0 + 1
    want = fa.flash_attention_plain(q, k, v, causal=causal, block_q=64,
                                    block_k=16)
    torch.testing.assert_close(got, want, **FA_TOL[torch.float32])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("S", [2, 63, 64, 65, 1024])
@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize("w", [None, 0.1, 1e-3, 1.0])
def test_wkv6_chunk_schedule_equals_plain(cuda_device, S, chunk, w):
    """The sequence form (three launches, chunks of ``chunk`` tokens, a
    ragged last chunk) against the per-token plain version from a random
    state: finite at every decay, 1.0 included."""
    from repro_torch.kernels import wkv6 as wk
    B, H, hd = 1, 4, 64
    r, k, v = (_randn((B, H, S, hd), s, cuda_device) for s in range(3))
    ww = torch.sigmoid(_randn((B, H, S, hd), 3, cuda_device)) * 0.5 + 0.45 \
        if w is None else torch.full((B, H, S, hd), w, device=cuda_device)
    u = _randn((H, hd), 4, cuda_device) * 0.1
    s0 = _randn((B, H, hd, hd), 5, cuda_device)
    n0 = wk.LAUNCHES["sequence"]
    out, s = wk.wkv6_state(r, k, v, ww, u, s0, chunk=chunk)
    torch.cuda.synchronize()
    assert wk.LAUNCHES["sequence"] == n0 + 3
    assert torch.isfinite(out).all() and torch.isfinite(s).all()
    want, want_s = wk.wkv6_plain(r, k, v, ww, u, s0)
    if w != 1.0:
        torch.testing.assert_close(out, want, rtol=2e-4, atol=2e-4)
        torch.testing.assert_close(s, want_s, rtol=2e-4, atol=2e-4)
        return
    # nothing decays: the f32 plain version's own rounding grows with S
    # past 2e-4, so both are held against the recurrence in f64, the kernel
    # within 2e-4 or the plain version's own distance from it, the larger
    exact, exact_s = wk.wkv6_plain(*(t.double() for t in (r, k, v, ww, u,
                                                          s0)))
    for got, plain, ref in ((out, want, exact), (s, want_s, exact_s)):
        lim = (plain.double() - ref).abs().max().item()
        torch.testing.assert_close(got.double(), ref, rtol=2e-4,
                                   atol=max(2e-4, lim))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("S", [1, 70])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wkv6_reads_layer_views_and_updates_in_place(cuda_device, S, dtype):
    """r, k, v as (B, H, S, hd) views of (B, S, D) activations in their own
    dtype, w an f32 view, the output written into a view of a (B, S, D)
    tensor in that dtype, the state updated in place: against the plain
    version on f32 copies (the output rounded once to the dtype)."""
    from repro_torch.kernels import wkv6 as wk
    B, H, hd = 4, 40, 64
    D = H * hd
    r, k, v = (_randn((B, S, D), s, cuda_device, dtype) for s in range(3))
    w = torch.sigmoid(_randn((B, S, D), 3, cuda_device)) * 0.5 + 0.45
    u = _randn((H, hd), 4, cuda_device) * 0.1
    s0 = _randn((B, H, hd, hd), 5, cuda_device)

    def heads(t):
        return t.view(B, S, H, hd).transpose(1, 2)
    views = [heads(t) for t in (r, k, v, w)]
    want, want_s = wk.wkv6_plain(*(t.float() for t in views), u, s0.clone())
    out = torch.empty((B, S, D), dtype=dtype, device=cuda_device)
    state = s0.clone()
    got, got_s = wk.wkv6_state(*views, u, state, out=heads(out),
                               s_out=state)
    torch.cuda.synchronize()
    assert got_s is state and got.data_ptr() == out.data_ptr()
    torch.testing.assert_close(state, want_s, rtol=2e-4, atol=2e-4)
    tol = dict(rtol=1e-2, atol=4e-3) if dtype == torch.bfloat16 else \
        dict(rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(heads(out).float(), want.to(dtype).float(),
                               **tol)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch", ["llama3_8b", "rwkv6_3b"])
def test_reduced_model_on_the_card_equals_cpu_and_decode(cuda_device, arch):
    """The model path through K4/K5 on the card: f32 logits equal the CPU
    run's (plain versions) on the same weights, and the last decode step's
    logits equal the prefill's last token."""
    import dataclasses
    from repro_torch.config import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.models import lm
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch, reduced=True), dtype="float32",
                              attn_impl="chunked", attn_chunk=16)
    gen = torch.Generator().manual_seed(0)
    params = lm.init_params(cfg, gen, "cpu")
    cpu = lm.LM(cfg, params)
    card = lm.LM(cfg, params).to(cuda_device)
    B, S = 2, 32
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (B, S))
    n0 = sum(fa.LAUNCHES.values()) + sum(wk.LAUNCHES.values())
    # a K4 launch per attention layer, K5's sequence form's three per RWKV
    # layer
    per_layer = wk.SEQUENCE_LAUNCHES if cfg.family == "ssm" else 1
    with torch.inference_mode():
        full = card({"tokens": tokens})
        torch.cuda.synchronize()
        assert sum(fa.LAUNCHES.values()) + sum(wk.LAUNCHES.values()) \
            == n0 + cfg.n_layers * per_layer
        torch.testing.assert_close(full.cpu(), cpu({"tokens": tokens}),
                                   rtol=2e-4, atol=2e-4)
        cache = card.init_cache(B, S)
        for t in range(S):
            logits, cache = card.decode_step(
                cache, {"token": tokens[:, t:t + 1],
                        "pos": np.full((B,), t, np.int32)})
    torch.testing.assert_close(logits[:, 0], full[:, -1], rtol=2e-3,
                               atol=2e-3)


# ---------------------------------------------------------------------------
# the decode step as a CUDA graph (lm.DecodeGraph)
# ---------------------------------------------------------------------------


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch", ["rwkv6_3b", "llama3_8b",
                                  "deepseek_v2_236b", "jamba_1_5_large_398b",
                                  "whisper_small", "paligemma_3b"])
def test_serve_main_graph_gives_the_eager_ids(cuda_device, arch):
    from repro_torch.launch import serve
    from repro_torch.models import lm
    argv = ["--arch", arch, "--reduced", "--batch", "3", "--prompt-len", "6",
            "--gen", "5"]
    eager = serve.main(argv + ["--eager"])
    n0 = sum(lm.GRAPH_LAUNCHES.values())
    graph = serve.main(argv)
    assert (graph == eager).all()
    if arch == "rwkv6_3b":            # K5 ran in every layer of every replay
        assert sum(lm.GRAPH_LAUNCHES.values()) - n0 > 0


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch", ["rwkv6_3b", "llama3_8b",
                                  "deepseek_v2_236b", "kimi_k2_1t_a32b",
                                  "jamba_1_5_large_398b"])
def test_batcher_graph_gives_the_eager_ids(cuda_device, arch):
    """Two slots answer five requests, so slots are reused: the batcher's
    admission reset writes into the graph's static cache between replays."""
    from repro_torch.config import get_config
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.models import lm
    from repro_torch.runtime.serving import ContinuousBatcher, Request
    cfg = get_config(arch, reduced=True)
    smax = 24
    with torch.inference_mode():
        model = lm.LM.init(cfg, torch.Generator(cuda_device).manual_seed(0),
                           cuda_device)

    def answer(graphed):
        b = ContinuousBatcher(None, lambda n: model.init_cache(n, smax),
                              n_slots=2, eos=1, max_len=smax,
                              device=cuda_device)
        if graphed:
            b.decode_fn = lm.DecodeGraph(cfg, model, b.cache)
        else:
            b.decode_fn = lambda c, t, p: model.decode_step(
                c, {"token": t, "pos": p})
        rng = np.random.default_rng(7)
        for i in range(5):
            b.submit(Request(rid=i, prompt=rng.integers(2, cfg.vocab, 6),
                             max_new=5))
        with torch.inference_mode():
            b.run()
        assert len(b.completed) == 5
        return {r.rid: r.output for r in b.completed}, b

    eager, _ = answer(False)
    n0 = wk.LAUNCHES["step"]
    graphed, b = answer(True)
    assert graphed == eager
    g = b.decode_fn
    assert g.replays == b.steps
    if arch == "rwkv6_3b":
        assert g.launches_per_replay == {"wkv6/step": cfg.n_layers}
        # only the warm-up steps launched K5 through its wrapper
        assert wk.LAUNCHES["step"] - n0 == g.warmup * cfg.n_layers
    else:                          # the decode step has no kernel wrapper
        assert g.launches_per_replay == {}


@pytest.mark.requires_cuda
def test_decode_graph_capture_failure_raises(cuda_device, monkeypatch):
    """A step that syncs with the host cannot be captured: the graph
    raises rather than run the step some other way."""
    from repro_torch.config import get_config
    from repro_torch.models import lm
    cfg = get_config("llama3_8b", reduced=True)
    with torch.inference_mode():
        model = lm.LM.init(cfg, torch.Generator(cuda_device).manual_seed(0),
                           cuda_device)
        cache = model.init_cache(2, 8)
    step = lm._decode                  # what decode_step_into runs

    def syncing(*a, **kw):
        logits, c = step(*a, **kw)
        logits.sum().item()            # a host sync: illegal under capture
        return logits, c
    monkeypatch.setattr(lm, "_decode", syncing)
    with pytest.raises(RuntimeError):
        lm.DecodeGraph(cfg, model, cache)


def _batcher_ids(cfg, model, n_slots, reqs, graphed, extra, smax=24):
    """{rid: ids} of a batcher of ``n_slots`` over ``reqs`` ((rid, prompt,
    max_new)), every step a graph replay or eager, ``extra`` the steps'
    other inputs (Whisper's frames, one row a slot)."""
    from repro_torch.models import lm
    from repro_torch.runtime.serving import ContinuousBatcher, Request
    b = ContinuousBatcher(None, lambda n: model.init_cache(n, smax),
                          n_slots=n_slots, eos=1, max_len=smax,
                          device=model.device)
    if graphed:
        b.decode_fn = lm.DecodeGraph(cfg, model, b.cache, extra)
    else:
        b.decode_fn = lambda c, t, p: model.decode_step(
            c, {"token": t, "pos": p, **extra})
    for rid, prompt, max_new in reqs:
        b.submit(Request(rid=rid, prompt=prompt, max_new=max_new))
    with torch.inference_mode():
        b.run()
    assert len(b.completed) == len(reqs)
    return {r.rid: r.output for r in b.completed}


def _frames_for(cfg, n, device):
    if cfg.family != "encdec":
        return {}
    x = np.random.default_rng(5).standard_normal((n, cfg.enc_seq,
                                                  cfg.d_model))
    return {"frames": torch.as_tensor(x, dtype=torch.bfloat16,
                                      device=device)}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch", ["jamba_1_5_large_398b", "whisper_small"])
def test_graphed_batcher_of_the_new_families_gives_the_eager_ids(cuda_device,
                                                                  arch):
    """Reduced Jamba (Mamba states in the graph's cache) and Whisper (its
    frames a static input of the graph): two slots answer five requests
    graphed and eagerly with the same ids; and one slot answering two
    requests in turn gives the second the ids it gets alone, so a reused
    slot's state starts from zeros under the graph too."""
    from repro_torch.config import get_config
    from repro_torch.models import lm
    cfg = get_config(arch, reduced=True)
    with torch.inference_mode():
        model = lm.LM.init(cfg, torch.Generator(cuda_device).manual_seed(0),
                           cuda_device)
    rng = np.random.default_rng(7)
    reqs = [(i, rng.integers(2, cfg.vocab, 6), 5) for i in range(5)]
    extra = _frames_for(cfg, 2, cuda_device)
    assert _batcher_ids(cfg, model, 2, reqs, True, extra) == \
        _batcher_ids(cfg, model, 2, reqs, False, extra)
    one = {k: t[:1] for k, t in extra.items()}
    two = _batcher_ids(cfg, model, 1, reqs[:2], True, one)
    assert two[1] == _batcher_ids(cfg, model, 1, reqs[1:2], True, one)[1]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch", ["jamba_1_5_large_398b", "whisper_small",
                                  "paligemma_3b"])
def test_new_families_on_the_card_equal_cpu(cuda_device, arch):
    """f32 logits of the reduced hybrid, encdec and vlm models on the card
    (the CUDA-core K4 at hd 16 in the chunked attention) equal the CPU
    run's on the same weights, and so do the decode steps'."""
    import dataclasses
    from repro_torch.config import get_config
    from repro_torch.models import lm
    torch.backends.cuda.matmul.allow_tf32 = False
    # attn_chunk 8 divides PaliGemma's 8 patches + 32 tokens
    cfg = dataclasses.replace(get_config(arch, reduced=True), dtype="float32",
                              attn_impl="chunked", attn_chunk=8)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    cpu = lm.LM(cfg, params)
    card = lm.LM(cfg, params).to(cuda_device)
    B, S = 2, 32
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab, (B, S))
    extra = {k: t.float().cpu() for k, t in
             _frames_for(cfg, B, "cpu").items()}
    batch = {"tokens": tokens, **extra}
    if cfg.family == "vlm":
        batch["patches"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32))
    with torch.inference_mode():
        torch.testing.assert_close(card(batch).cpu(), cpu(batch), rtol=2e-4,
                                   atol=2e-4)
        cc, gc = cpu.init_cache(B, 8), card.init_cache(B, 8)
        for t in range(8):
            step = {"token": tokens[:, t:t + 1],
                    "pos": np.full((B,), t, np.int32), **extra}
            want, cc = cpu.decode_step(cc, step)
            got, gc = card.decode_step(gc, step)
            torch.testing.assert_close(got.cpu(), want, rtol=2e-4,
                                       atol=2e-4)


@pytest.mark.requires_cuda
def test_decode_graph_with_frames_capture_failure_raises(cuda_device,
                                                         monkeypatch):
    """A failed capture of an encdec step, frames among its static inputs,
    raises too; a call with an input it was not captured with raises."""
    from repro_torch.config import get_config
    from repro_torch.models import lm
    cfg = get_config("whisper_small", reduced=True)
    with torch.inference_mode():
        model = lm.LM.init(cfg, torch.Generator(cuda_device).manual_seed(0),
                           cuda_device)
        cache = model.init_cache(2, 8)
    extra = _frames_for(cfg, 2, cuda_device)
    graph = lm.DecodeGraph(cfg, model, cache, extra)
    tok = torch.ones((2, 1), dtype=torch.int32, device=cuda_device)
    pos = torch.zeros((2,), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="captured with"):
        graph(cache, tok, pos, patches=extra["frames"])
    step = lm._decode

    def syncing(*a, **kw):
        logits, c = step(*a, **kw)
        logits.sum().item()            # a host sync: illegal under capture
        return logits, c
    monkeypatch.setattr(lm, "_decode", syncing)
    with pytest.raises(RuntimeError):
        lm.DecodeGraph(cfg, model, model.init_cache(2, 8), extra)


# ---------------------------------------------------------------------------
# the MoE family (MLA and the capacity-routed MoE are plain PyTorch; the
# dispatch runs on the card's sort, scatter and gather)
# ---------------------------------------------------------------------------


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch", ["deepseek_v2_236b", "kimi_k2_1t_a32b"])
def test_moe_model_on_the_card_equals_cpu(cuda_device, arch):
    """f32 logits of the reduced MoE models on the card equal the CPU
    run's on the same weights (the prefill drops pairs: the same ones),
    and so do the decode steps'."""
    import dataclasses
    from repro_torch.config import get_config
    from repro_torch.models import lm
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch, reduced=True), dtype="float32",
                              attn_impl="chunked", attn_chunk=16)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    cpu = lm.LM(cfg, params)
    card = lm.LM(cfg, params).to(cuda_device)
    B, S = 2, 32
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (B, S))
    with torch.inference_mode():
        torch.testing.assert_close(card({"tokens": tokens}).cpu(),
                                   cpu({"tokens": tokens}), rtol=2e-4,
                                   atol=2e-4)
        cc, gc = cpu.init_cache(B, 8), card.init_cache(B, 8)
        for t in range(8):
            batch = {"token": tokens[:, t:t + 1],
                     "pos": np.full((B,), t, np.int32)}
            want, cc = cpu.decode_step(cc, batch)
            got, gc = card.decode_step(gc, batch)
            torch.testing.assert_close(got.cpu(), want, rtol=2e-4,
                                       atol=2e-4)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("S", [64, 1024])
def test_moe_route_on_the_card_equals_the_cpu_dispatch(cuda_device, S):
    """The dispatch tables (ranks from the stable sort, kept pairs, slot
    tables) computed on the card from its expert ids equal the CPU's from
    the same ids, with drops (half the published capacity); the ids are
    the top-k of the card's gates."""
    import dataclasses
    from repro_torch.config import get_config
    from repro_torch.models import layers as L
    cfg = get_config("deepseek_v2_236b", reduced=True)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.5))
    p = L.init_moe(cfg, torch.Generator().manual_seed(2), "cpu")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    h = L.rms_norm(x, p["norm"])
    pc = {k: v.to(cuda_device) for k, v in p.items() if k != "shared"}
    with torch.inference_mode():
        r = L.moe_route(cfg, pc, h.to(cuda_device))
    gidx = r["gidx"].cpu()
    assert torch.equal(gidx, torch.topk(torch.softmax(
        r["logits"].cpu(), -1), cfg.moe.top_k, dim=-1)[1])
    # the CPU's tables from the card's ids: route logits that rank them so
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    fake = torch.full((2, S, E), -1e4)
    fake.scatter_(-1, gidx, torch.arange(K, 0, -1, dtype=torch.float32)
                  .expand(2, S, K).contiguous())
    want = L.moe_route(cfg, {"router": torch.eye(E)}, fake)
    assert torch.equal(want["gidx"], gidx)
    for k in ("posc", "keep", "slot", "src", "vld"):
        assert torch.equal(r[k].cpu(), want[k].to(r[k].dtype)), k
    assert not bool(r["keep"].all())


# ---------------------------------------------------------------------------
# K4's backward kernel and training on the card
# ---------------------------------------------------------------------------


def _bwd_inputs(dev, dtype, B, H, Hkv, S, hd, seed):
    """Views of (B, S, heads, hd) tensors for q, k, v, and dout."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((B, S, h, hd)).astype(
        np.float32)).to(dev, dtype).transpose(1, 2) for h in (H, Hkv, Hkv, H))
    return q, k, v, g


def _forward_blocks(fa, kind, hd):
    """The default (block_q, block_k) of K4's forward kernel ``kind``."""
    if kind == "wgmma":
        return fa.WGMMA_BLOCKS[hd][0]
    return fa.TF32X3_BLOCKS[hd] if kind == "tf32x3" else fa.CUDA_CORE_BLOCKS


@pytest.mark.requires_cuda
@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,S,causal", [(2, 4, 2, 100, True),
                                              (1, 4, 1, 77, False),
                                              (1, 8, 8, 130, True)])
def test_flash_attention_bwd_kernel_equals_plain(cuda_device, hd, dtype, B,
                                                 H, Hkv, S, causal):
    """The backward kernels against ``flash_attention_bwd_plain`` on the
    same forward output and log-sum-exp: every head dim, both dtypes (each
    on its ``bwd_route``), GQA 1/2/4, strided views, ragged q and kv tiles;
    ``bwd_launches`` launches a call."""
    from repro_torch.kernels import flash_attention as fa
    dt = getattr(torch, dtype)
    q, k, v, g = _bwd_inputs(cuda_device, dt, B, H, Hkv, S, hd, hd + S)
    kind = fa.route(dt, hd)
    bq, bk = _forward_blocks(fa, kind, hd)
    out, lse = fa._run(q, k, v, causal, kind, bq, bk, True)
    n0 = fa.LAUNCHES[f"bwd/{dtype}"]
    got = fa.flash_attention_bwd(q, k, v, out, lse, g, causal=causal)
    torch.cuda.synchronize()
    assert fa.LAUNCHES[f"bwd/{dtype}"] == n0 + fa.bwd_launches(
        dt, hd, B, H, Hkv, S, S, causal)
    tq, tk = fa.BWD_TILES[fa.bwd_route(dt, hd)][hd]
    split = fa.split_route(dt, hd)
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, g, causal=causal,
                                        block_q=tq if split else min(tq, S),
                                        block_k=tk if split else min(tk, S),
                                        split=split)
    tol = 1e-4 if dtype == "float32" else 2e-2
    for a, b, x in zip(got, want, (q, k, v)):
        assert a.dtype == dt and a.shape == x.shape
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [77, 100, 130])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_flash_attention_bwd_wgmma_equals_plain(cuda_device, hd, G, S,
                                                causal):
    """The tensor-core backward (bf16 at hd 64/128/256) against
    ``flash_attention_bwd_plain`` on its own schedule: GQA groups 1, 2, 4
    and 8, ragged S, causal and not, on transposed views; a second call on
    the same inputs bitwise equal; its launches a call as ``bwd_launches``
    counts them (4 where its schedule cut a walk: hd 64/128 ``dkdv_wrap``,
    hd 256 ``dkdv_split`` or ``dq_split``)."""
    from repro_torch.kernels import flash_attention as fa
    dt = torch.bfloat16
    assert fa.bwd_route(dt, hd) == "wgmma"
    B, Hkv = 1, 2
    H = G * Hkv
    q, k, v, g = _bwd_inputs(cuda_device, dt, B, H, Hkv, S, hd, 7 * G + S)
    out, lse = fa._run(q, k, v, causal, "wgmma", *fa.WGMMA_BLOCKS[hd][0],
                       True)
    fa.LAUNCHES.clear()
    got = fa.flash_attention_bwd(q, k, v, out, lse, g, causal=causal)
    torch.cuda.synchronize()
    tq, tk = fa.BWD_TILES["wgmma"][hd]
    if fa.split_route(dt, hd):
        # hd 256: walks cut into pieces, summed by the fourth kernel
        sums = bool(fa.dkdv_split(B, H, Hkv, S, S, causal).sums
                    or fa.dq_split(B, H, Hkv, S, S, causal).sums)
    else:
        # hd 64/128: the kv tiles' walks wrapped over the SMs, a cut walk's
        # partials summed by the fourth kernel
        sums = bool(fa.dkdv_wrap(B, H, Hkv, S, S, causal).sums)
    assert dict(fa.LAUNCHES) == {"bwd/bfloat16": 3 + sums}
    assert fa.bwd_launches(dt, hd, B, H, Hkv, S, S, causal) == 3 + sums
    again = fa.flash_attention_bwd(q, k, v, out, lse, g, causal=causal)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, g, causal=causal,
                                        block_q=tq, block_k=tk, split=True)
    for a, b, c, x in zip(got, again, want, (q, k, v)):
        assert a.dtype == dt and a.shape == x.shape
        assert torch.equal(a, b)
        torch.testing.assert_close(a.float(), c.float(), rtol=2e-2,
                                   atol=2e-2)


@pytest.mark.requires_cuda
def test_flash_attention_bwd_wgmma_gqa8_equals_plain(cuda_device):
    """Kimi-K2's and Jamba's GQA 8, q (1, 64, 2048, 128) over 8 kv heads,
    causal: the kv tiles' walks (256 down to 16 steps) wrapped into 132
    blocks of at most 132, four kernels; the gradients within 2e-2 of each
    one's largest entry of the plain version on the same schedule, a second
    call bitwise the first."""
    from repro_torch.kernels import flash_attention as fa
    dt, (B, H, Hkv, S, hd) = torch.bfloat16, (1, 64, 8, 2048, 128)
    sp = fa.dkdv_wrap(B, H, Hkv, S, S, True)
    assert sp.blocks == fa.SMS and max(sp.block_steps()) == 132
    q, k, v, g = _bwd_inputs(cuda_device, dt, B, H, Hkv, S, hd, 8)
    out, lse = fa._run(q, k, v, True, "wgmma", *fa.WGMMA_BLOCKS[hd][0], True)
    fa.LAUNCHES.clear()
    got = fa.flash_attention_bwd(q, k, v, out, lse, g, causal=True)
    again = fa.flash_attention_bwd(q, k, v, out, lse, g, causal=True)
    torch.cuda.synchronize()
    assert dict(fa.LAUNCHES) == {"bwd/bfloat16": 2 * 4}
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, g, causal=True,
                                        block_q=64, block_k=128, split=True)
    for a, b, c in zip(got, again, want):
        assert torch.equal(a, b)
        scale = c.float().abs().max().item()
        torch.testing.assert_close(a.float(), c.float(), rtol=2e-2,
                                   atol=2e-2 * max(1.0, scale))


# bf16 at hd 256 (PaliGemma's q (1, 8, 1024, 256) over one kv head and
# small ragged shapes): (B, H, Hkv, S, Sk); the last is wide enough for one
# block an item (no table, no partials)
_HD256_SHAPES = [(1, 8, 1, 1024, 1024), (1, 8, 1, 200, 200),
                 (1, 2, 1, 77, 77), (2, 2, 2, 130, 300), (1, 4, 4, 100, 100),
                 (1, 3, 1, 136, 72), (4, 16, 16, 512, 512)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,H,Hkv,S,Sk", _HD256_SHAPES)
@pytest.mark.parametrize("draw", ["randn", "peaky"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_hd256_equals_plain(cuda_device, B, H, Hkv, S, Sk,
                                            draw, causal):
    """The hd-256 kernels (bf16) against their plain versions on the split
    schedules: the forward (pieces and combine; its lse too) and the
    backward (dK/dV, dQ and the sum), GQA groups 1, 2, 3 and 8, ragged S
    and Sk != S, causal and not, N(0, 1) and peaky draws (q x 4), on views
    of (B, S, heads, hd) tensors; each bitwise the same in a second call;
    launches a call as ``fwd_launches`` and ``bwd_launches`` count them."""
    from repro_torch.kernels import flash_attention as fa
    dt, hd = torch.bfloat16, 256
    q, k, v = (_randn((B, n, h, hd), seed, cuda_device, dt).transpose(1, 2)
               for seed, n, h in ((0, S, H), (1, Sk, Hkv), (2, Sk, Hkv)))
    if draw == "peaky":
        q = (q.float() * 4.0).to(dt)
    fa.LAUNCHES.clear()
    out, lse = fa._run(q, k, v, causal, "wgmma", 128, 64, True)
    torch.cuda.synchronize()
    assert dict(fa.LAUNCHES) == {"wgmma/bfloat16": fa.fwd_launches(
        dt, hd, B, H, Hkv, S, Sk, causal)}
    out2, lse2 = fa._run(q, k, v, causal, "wgmma", 128, 64, True)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    want, wlse = fa.flash_attention_plain(q, k, v, causal=causal, block_q=128,
                                          block_k=64, return_lse=True,
                                          split=True)
    torch.testing.assert_close(out.float(), want.float(),
                               **FA_TOL[torch.bfloat16])
    torch.testing.assert_close(lse, wlse, rtol=1e-5, atol=1e-4)
    g = _randn((B, S, H, hd), 3, cuda_device, dt).transpose(1, 2)
    fa.LAUNCHES.clear()
    got = fa.flash_attention_bwd(q, k, v, out, lse, g, causal=causal)
    torch.cuda.synchronize()
    assert dict(fa.LAUNCHES) == {"bwd/bfloat16": fa.bwd_launches(
        dt, hd, B, H, Hkv, Sk, S, causal)}
    again = fa.flash_attention_bwd(q, k, v, out, lse, g, causal=causal)
    torch.cuda.synchronize()
    wants = fa.flash_attention_bwd_plain(q, k, v, out, lse, g, causal=causal,
                                         block_q=64, block_k=64, split=True)
    for a, b, c, x in zip(got, again, wants, (q, k, v)):
        assert a.dtype == dt and a.shape == x.shape
        assert torch.equal(a, b)
        scale = c.float().abs().max().item()
        torch.testing.assert_close(a.float(), c.float(), rtol=2e-2,
                                   atol=2e-2 * max(1.0, scale))


@pytest.mark.requires_cuda
def test_flash_attention_bwd_wgmma_takes_an_expanded_gradient(cuda_device):
    """A dout with zero strides (``out.sum()`` hands the backward one) is
    copied where TMA cannot read it: the gradients equal the plain
    version's."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v, _ = _bwd_inputs(cuda_device, torch.bfloat16, 2, 4, 2, 100, 128, 9)
    out, lse = fa._run(q, k, v, True, "wgmma", *fa.WGMMA_BLOCKS[128][0],
                       True)
    row = np.random.default_rng(9).standard_normal((1, 1, 1, 128))
    for g in (torch.ones((1, 1, 1, 1), device=cuda_device),
              torch.as_tensor(row, device=cuda_device)):
        g = g.to(torch.bfloat16).expand(out.shape)
        got = fa.flash_attention_bwd(q, k, v, out, lse, g, causal=True)
        want = fa.flash_attention_bwd_plain(q, k, v, out, lse, g,
                                            causal=True, block_q=64,
                                            block_k=100)
        for a, b in zip(got, want):
            torch.testing.assert_close(a.float(), b.float(), rtol=2e-2,
                                       atol=2e-2)


@pytest.mark.requires_cuda
def test_flash_attention_bwd_wgmma_in_a_fresh_thread(cuda_device):
    """The tensor-core backward as the first CUDA work of a new thread (as
    an autograd worker thread may run it): it binds the context that its
    tensor maps' encoding needs, and equals the same call on this thread
    bitwise."""
    import threading
    from repro_torch.kernels import flash_attention as fa
    q, k, v, g = _bwd_inputs(cuda_device, torch.bfloat16, 1, 4, 2, 130, 64, 5)
    out, lse = fa._run(q, k, v, True, "wgmma", *fa.WGMMA_BLOCKS[64][0], True)
    want = fa.flash_attention_bwd(q, k, v, out, lse, g, causal=True)
    torch.cuda.synchronize()
    res = {}

    def run():
        try:
            res["got"] = fa.flash_attention_bwd(q, k, v, out, lse, g,
                                                causal=True)
            torch.cuda.synchronize()
        except Exception as e:      # raised again below, on this thread
            res["err"] = e
    th = threading.Thread(target=run)
    th.start()
    th.join()
    if "err" in res:
        raise res["err"]
    for a, b in zip(res["got"], want):
        assert torch.equal(a, b)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [77, 100, 130])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_attention_bwd_tf32x3_equals_plain(cuda_device, hd, G, S,
                                                 causal):
    """The 3xTF32 backward (f32 at hd 64/128) against
    ``flash_attention_bwd_plain`` on its own dK/dV tiles within K4's f32
    backward limit (1e-4): GQA groups 1, 2, 4 and 8 (the split q heads with
    them), ragged S, causal and not, on transposed views; a second call on
    the same inputs bitwise equal; its launches a call as ``bwd_launches``
    counts them (4 where it splits)."""
    from repro_torch.kernels import flash_attention as fa
    dt = torch.float32
    assert fa.bwd_route(dt, hd) == "tf32x3"
    B, Hkv = 1, 2
    H = G * Hkv
    q, k, v, g = _bwd_inputs(cuda_device, dt, B, H, Hkv, S, hd, 11 * G + S)
    out, lse = fa._run(q, k, v, causal, "tf32x3", *fa.TF32X3_BLOCKS[hd],
                       True)
    fa.LAUNCHES.clear()
    got = fa.flash_attention_bwd(q, k, v, out, lse, g, causal=causal)
    torch.cuda.synchronize()
    split = fa.bwd_split(B, H, Hkv, S, hd, "tf32x3")
    assert dict(fa.LAUNCHES) == {"bwd/float32": 3 + (split > 1)}
    assert fa.bwd_launches(dt, hd, B, H, Hkv, S) == 3 + (split > 1)
    assert split == G        # the unsplit grid has 2 to 6 blocks
    again = fa.flash_attention_bwd(q, k, v, out, lse, g, causal=causal)
    torch.cuda.synchronize()
    tq, tk = fa.BWD_TILES["tf32x3"][hd]
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, g, causal=causal,
                                        block_q=min(tq, S),
                                        block_k=min(tk, S))
    for a, b, c, x in zip(got, again, want, (q, k, v)):
        assert a.dtype == dt and a.shape == x.shape
        assert torch.equal(a, b)
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-4)


@pytest.mark.requires_cuda
def test_flash_attention_bwd_tf32x3_long_chain(cuda_device):
    """The 3xTF32 backward where dK and dV sum their longest chains: a GQA
    group of 8 over 2048 rows, causal, unsplit (8 kv heads fill the card),
    so a block of the first keys sums 16,384 q rows; the tensor cores
    truncate as they accumulate, and each step's product is added rounded
    to nearest, so the gradients stay within 1e-4 of the plain version."""
    from repro_torch.kernels import flash_attention as fa
    dt = torch.float32
    B, H, Hkv, S, hd = 1, 64, 8, 2048, 128
    assert fa.bwd_split(B, H, Hkv, S, hd, "tf32x3") == 1
    q, k, v, g = _bwd_inputs(cuda_device, dt, B, H, Hkv, S, hd, 2048)
    out, lse = fa._run(q, k, v, True, "tf32x3", *fa.TF32X3_BLOCKS[hd], True)
    got = fa.flash_attention_bwd(q, k, v, out, lse, g, causal=True)
    tq, tk = fa.BWD_TILES["tf32x3"][hd]
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, g, causal=True,
                                        block_q=tq, block_k=tk)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.requires_cuda
def test_flash_attention_bwd_tf32x3_takes_an_expanded_gradient(cuda_device):
    """A dout with zero strides: rows the kernel reads through a zero stride
    as they are, a last dim of one element copied; the gradients equal the
    plain version's."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v, _ = _bwd_inputs(cuda_device, torch.float32, 2, 4, 2, 100, 64, 9)
    out, lse = fa._run(q, k, v, True, "tf32x3", *fa.TF32X3_BLOCKS[64], True)
    row = np.random.default_rng(9).standard_normal((1, 1, 1, 64))
    for g in (torch.ones((1, 1, 1, 1), device=cuda_device),
              torch.as_tensor(row, device=cuda_device)):
        g = g.to(torch.float32).expand(out.shape)
        got = fa.flash_attention_bwd(q, k, v, out, lse, g, causal=True)
        want = fa.flash_attention_bwd_plain(q, k, v, out, lse, g,
                                            causal=True, block_q=32,
                                            block_k=64)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.requires_cuda
def test_flash_attention_bwd_tf32x3_in_a_fresh_thread(cuda_device):
    """The 3xTF32 backward as the first CUDA work of a new thread (as an
    autograd worker thread may run it) equals the same call on this thread
    bitwise."""
    import threading
    from repro_torch.kernels import flash_attention as fa
    q, k, v, g = _bwd_inputs(cuda_device, torch.float32, 1, 4, 2, 130, 128, 5)
    out, lse = fa._run(q, k, v, True, "tf32x3", *fa.TF32X3_BLOCKS[128], True)
    want = fa.flash_attention_bwd(q, k, v, out, lse, g, causal=True)
    torch.cuda.synchronize()
    res = {}

    def run():
        try:
            res["got"] = fa.flash_attention_bwd(q, k, v, out, lse, g,
                                                causal=True)
            torch.cuda.synchronize()
        except Exception as e:      # raised again below, on this thread
            res["err"] = e
    th = threading.Thread(target=run)
    th.start()
    th.join()
    if "err" in res:
        raise res["err"]
    for a, b in zip(res["got"], want):
        assert torch.equal(a, b)


def _bwd_against_plain(fa, dt, B, H, Hkv, S, hd, causal, q, k, v, g):
    """One backward call on K4's own forward output: its gradients, a
    second call's, the plain version's on the route's own dK/dV tiles, and
    the launches the call counted."""
    kind = fa.route(dt, hd)
    out, lse = fa._run(q, k, v, causal, kind, *_forward_blocks(fa, kind, hd),
                       True)
    fa.LAUNCHES.clear()
    got = fa.flash_attention_bwd(q, k, v, out, lse, g, causal=causal)
    torch.cuda.synchronize()
    n = dict(fa.LAUNCHES)
    again = fa.flash_attention_bwd(q, k, v, out, lse, g, causal=causal)
    torch.cuda.synchronize()
    tq, tk = fa.BWD_TILES[fa.bwd_route(dt, hd)][hd]
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, g, causal=causal,
                                        block_q=min(tq, S),
                                        block_k=min(tk, S))
    return got, again, want, n


@pytest.mark.requires_cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [77, 100, 130])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
def test_flash_attention_bwd_tf32x3_hd256_equals_plain(cuda_device, G, S,
                                                       causal):
    """The 3xTF32 backward at hd 256 (its own kernels: tile pairs and
    halves of each walk, partials summed in a fixed order) against
    ``flash_attention_bwd_plain`` within K4's f32 backward limit (1e-4):
    GQA groups 1, 2, 4 and 8, ragged S, causal and not, on transposed
    views; a second call bitwise equal; 4 launches a call."""
    from repro_torch.kernels import flash_attention as fa
    dt, hd, B, Hkv = torch.float32, 256, 1, 2
    H = G * Hkv
    assert fa.bwd_route(dt, hd) == "tf32x3"
    q, k, v, g = _bwd_inputs(cuda_device, dt, B, H, Hkv, S, hd, 13 * G + S)
    got, again, want, n = _bwd_against_plain(fa, dt, B, H, Hkv, S, hd,
                                             causal, q, k, v, g)
    assert n == {"bwd/float32": 4} and fa.bwd_launches(dt, hd, B, H, Hkv,
                                                       S) == 4
    for a, b, c, x in zip(got, again, want, (q, k, v)):
        assert a.dtype == dt and a.shape == x.shape
        assert torch.equal(a, b)
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-4)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,H,Hkv", [(1, 8, 1), (1, 64, 8)])
def test_flash_attention_bwd_tf32x3_hd256_long_chain(cuda_device, B, H, Hkv):
    """The 3xTF32 backward at hd 256 over PaliGemma's 1024 rows, causal,
    a GQA group of 8: over one kv head (its q heads split over 8 blocks, as
    on PaliGemma's path) and over 8 kv heads (unsplit), so that a block of
    the first keys sums 8 x 1024 or 1024 q rows a head; within 1e-4 of the
    plain version."""
    from repro_torch.kernels import flash_attention as fa
    dt, S, hd = torch.float32, 1024, 256
    assert fa.bwd_split(B, H, Hkv, S, hd, "tf32x3") == (8 if Hkv == 1 else 1)
    q, k, v, g = _bwd_inputs(cuda_device, dt, B, H, Hkv, S, hd, H)
    got, again, want, _ = _bwd_against_plain(fa, dt, B, H, Hkv, S, hd, True,
                                             q, k, v, g)
    for a, b, c in zip(got, again, want):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-4)


@pytest.mark.requires_cuda
def test_flash_attention_bwd_tf32x3_hd256_takes_an_expanded_gradient(
        cuda_device):
    """A dout with zero strides at hd 256: rows read through a zero stride
    as they are, a last dim of one element copied; the gradients equal the
    plain version's."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v, _ = _bwd_inputs(cuda_device, torch.float32, 2, 4, 2, 100, 256, 9)
    out, lse = fa._run(q, k, v, True, "tf32x3", *fa.TF32X3_BLOCKS[256], True)
    row = np.random.default_rng(9).standard_normal((1, 1, 1, 256))
    tq, tk = fa.BWD_TILES["tf32x3"][256]
    for g in (torch.ones((1, 1, 1, 1), device=cuda_device),
              torch.as_tensor(row, device=cuda_device)):
        g = g.to(torch.float32).expand(out.shape)
        got = fa.flash_attention_bwd(q, k, v, out, lse, g, causal=True)
        want = fa.flash_attention_bwd_plain(q, k, v, out, lse, g,
                                            causal=True, block_q=tq,
                                            block_k=tk)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("hd,dtype", [(256, torch.float32),
                                      (16, torch.float32),
                                      (32, torch.bfloat16)])
def test_flash_attention_bwd_in_a_fresh_thread(cuda_device, hd, dtype):
    """The hd-256 3xTF32 and the mma backward as the first CUDA work of a
    new thread (as an autograd worker thread may run it) equal the same
    call on this thread bitwise."""
    import threading
    from repro_torch.kernels import flash_attention as fa
    q, k, v, g = _bwd_inputs(cuda_device, dtype, 1, 4, 2, 130, hd, 5)
    kind = fa.route(dtype, hd)
    out, lse = fa._run(q, k, v, True, kind, *_forward_blocks(fa, kind, hd),
                       True)
    want = fa.flash_attention_bwd(q, k, v, out, lse, g, causal=True)
    torch.cuda.synchronize()
    res = {}

    def run():
        try:
            res["got"] = fa.flash_attention_bwd(q, k, v, out, lse, g,
                                                causal=True)
            torch.cuda.synchronize()
        except Exception as e:      # raised again below, on this thread
            res["err"] = e
    th = threading.Thread(target=run)
    th.start()
    th.join()
    if "err" in res:
        raise res["err"]
    for a, b in zip(res["got"], want):
        assert torch.equal(a, b)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [77, 100, 130])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("hd", [16, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_bwd_mma_equals_plain(cuda_device, dtype, hd, G, S,
                                              causal):
    """The mma backward (hd 16 and 32; bf16 on m16n8k16, f32 in 3xTF32 on
    m16n8k8; one kernel a call) against ``flash_attention_bwd_plain`` on its
    16 x 16 tiles within K4's backward limits (f32 1e-4, bf16 2e-2): GQA
    groups 1, 2, 4 and 8, ragged S, causal and not, on transposed views; a
    second call bitwise equal."""
    from repro_torch.kernels import flash_attention as fa
    dt = getattr(torch, dtype)
    assert fa.bwd_route(dt, hd) == "mma"
    B, Hkv = 2, 2
    H = G * Hkv
    q, k, v, g = _bwd_inputs(cuda_device, dt, B, H, Hkv, S, hd,
                             17 * G + S + hd)
    got, again, want, n = _bwd_against_plain(fa, dt, B, H, Hkv, S, hd,
                                             causal, q, k, v, g)
    assert n == {f"bwd/{dtype}": 1}
    tol = 1e-4 if dtype == "float32" else 2e-2
    for a, b, c, x in zip(got, again, want, (q, k, v)):
        assert a.dtype == dt and a.shape == x.shape
        assert torch.equal(a, b)
        torch.testing.assert_close(a.float(), c.float(), rtol=tol, atol=tol)


@pytest.mark.requires_cuda
def test_flash_attention_bwd_mma_takes_an_expanded_gradient(cuda_device):
    """The mma backward reads a dout with zero strides as it is (a last dim
    of one element copied); the gradients equal the plain version's."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v, _ = _bwd_inputs(cuda_device, torch.float32, 2, 4, 2, 100, 16, 9)
    out, lse = fa._run(q, k, v, True, "cuda_cores", *fa.CUDA_CORE_BLOCKS,
                       True)
    row = np.random.default_rng(9).standard_normal((1, 1, 1, 16))
    for g in (torch.ones((1, 1, 1, 1), device=cuda_device),
              torch.as_tensor(row, device=cuda_device)):
        g = g.to(torch.float32).expand(out.shape)
        got = fa.flash_attention_bwd(q, k, v, out, lse, g, causal=True)
        want = fa.flash_attention_bwd_plain(q, k, v, out, lse, g,
                                            causal=True, block_q=16,
                                            block_k=16)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_lse_equals_plain(cuda_device, dtype):
    """Each forward kernel's log-sum-exp output equals the plain version's,
    and asking for it leaves the output unchanged."""
    from repro_torch.kernels import flash_attention as fa
    dt = getattr(torch, dtype)
    for hd in (16, 64, 128, 256):
        q, k, v, _ = _bwd_inputs(cuda_device, dt, 1, 4, 2, 200, hd, hd)
        kind = fa.route(dt, hd)
        bq, bk = _forward_blocks(fa, kind, hd)
        out, lse = fa._run(q, k, v, True, kind, bq, bk, True)
        plain, plse = fa.flash_attention_plain(
            q, k, v, causal=True, block_q=bq, block_k=bk, return_lse=True,
            split=kind == "wgmma" and fa.split_route(dt, hd))
        assert torch.equal(out, fa._run(q, k, v, True, kind, bq, bk,
                                        False)[0])
        torch.testing.assert_close(lse, plse, rtol=1e-5, atol=1e-5)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("hd", [16, 64])
def test_chunked_gradients_equal_dense_on_the_card(cuda_device, hd):
    """A gradient step through the reduced llama3-8b (f32; hd 16: the
    CUDA-core K4, hd 64: tf32x3) with chunked attention (K4 forward and
    backward kernels) equals the dense path's: the loss, and every
    gradient within 1e-4 of its largest entry; K4's launches as remat
    "full" runs them (the forward twice a layer)."""
    import dataclasses
    from repro_torch.config import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import lm
    torch.backends.cuda.matmul.allow_tf32 = False
    base = dataclasses.replace(get_config("llama3_8b", reduced=True),
                               dtype="float32", head_dim=hd)
    batch = {k: torch.as_tensor(v, device=cuda_device) for k, v in
             SyntheticLMData(vocab=base.vocab, seq_len=128, batch=2,
                             seed=1).batch_at(0).items()}
    params = lm.init_params(base, torch.Generator().manual_seed(0), "cpu")
    res = {}
    for impl in ("dense", "chunked"):
        cfg = dataclasses.replace(base, attn_impl=impl)
        model = lm.LM(cfg, params).to(cuda_device).requires_grad_(True)
        fa.LAUNCHES.clear()
        loss = lm.loss_fn(cfg, model, batch)
        res[impl] = (loss.item(), torch.autograd.grad(loss,
                                                      model.param_list()))
        torch.cuda.synchronize()
        if impl == "chunked":
            kind = fa.route(torch.float32, hd)
            assert dict(fa.LAUNCHES) == {
                f"{kind}/float32": 2 * cfg.n_layers,
                "bwd/float32": fa.bwd_launches(
                    torch.float32, hd, 2, cfg.n_heads, cfg.n_kv_heads, 128)
                * cfg.n_layers}
    assert res["chunked"][0] == pytest.approx(res["dense"][0], rel=1e-5)
    for a, b in zip(res["chunked"][1], res["dense"][1]):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()


@pytest.mark.requires_cuda
def test_gradients_that_no_kernel_takes_raise(cuda_device):
    """With grad on the card nothing detaches: K4 at a head dim or dtype no
    kernel takes raises, and the backward entry raises for a head dim it is
    not built for.  An RWKV loss, which raised before K5 had a backward
    kernel, trains: its gradients are finite and K5's backward ran once a
    layer."""
    from repro_torch.config import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import lm
    from repro_torch.kernels import wkv6 as wk
    cfg = get_config("rwkv6_3b", reduced=True)
    model = lm.LM.init(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                       cuda_device).requires_grad_(True)
    # inputs from numpy: the default CUDA generator may be left mid-capture
    # by test_decode_graph_capture_failure_raises
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (1, 16)),
                             device=cuda_device)
    # RWKV trains: its loss differentiates through K5's backward kernel
    wk.LAUNCHES.clear()
    loss = lm.loss_fn(cfg, model, {"tokens": tokens, "labels": tokens})
    grads = torch.autograd.grad(loss, model.param_list())
    torch.cuda.synchronize()
    assert all(torch.isfinite(g).all() for g in grads)
    assert wk.LAUNCHES[wk.BWD_COUNT[wk.bwd_route(cfg.rwkv_head_dim)]] \
        == wk.BWD_LAUNCHES * cfg.n_layers
    with torch.no_grad():
        assert torch.isfinite(lm.loss_fn(cfg, model, {"tokens": tokens,
                                                      "labels": tokens}))
    for hd, dt in ((48, torch.bfloat16), (64, torch.float16)):
        q = torch.as_tensor(rng.standard_normal((1, 2, 64, hd)),
                            device=cuda_device, dtype=dt).requires_grad_()
        with pytest.raises(ValueError):
            fa.flash_attention(q, q, q, causal=True)
    x = torch.as_tensor(rng.standard_normal((1, 2, 64, 48)),
                        device=cuda_device, dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="hd=48"):
        fa.flash_attention_bwd(x, x, x, x, x[..., 0], x, causal=True)


# ---------------------------------------------------------------------------
# K5's backward (csrc/wkv6_bwd_tc.cu) through the autograd Function
# ---------------------------------------------------------------------------


def _wkv6_grad_inputs(dev, B, H, S, hd, dtype, w, with_state, seed):
    """r, k, v (dtype) and w (f32) as (B, H, S, hd) views of (B, S, D)
    leaves (contiguous (B, H, S, hd) leaves in f32), u, s0 or None, and
    the cotangents of the output (dtype) and the final state (or None)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    D = H * hd
    views = dtype == torch.bfloat16

    def leaf(x):
        return (x if views else x.view(B, S, H, hd).transpose(1, 2)
                .contiguous()).requires_grad_()
    r, k, v = (leaf(torch.randn((B, S, D), generator=g, device=dev)
                    .to(dtype)) for _ in range(3))
    ww = leaf(torch.full((B, S, D), w, device=dev))
    u = (torch.randn((H, hd), generator=g, device=dev) * 0.1).requires_grad_()
    s0 = torch.randn((B, H, hd, hd), generator=g, device=dev) \
        .requires_grad_() if with_state else None
    dout = torch.randn((B, H, S, hd), generator=g, device=dev).to(dtype)
    ds = torch.randn((B, H, hd, hd), generator=g, device=dev) \
        if with_state else None
    return [r, k, v, ww], u, s0, dout, ds


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("w", [0.1, 1e-3, 1.0])
@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize("S", [1, 63, 64, 200, 1024])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_wkv6_bwd_kernel_equals_plain(cuda_device, hd, S, chunk, w,
                                      with_state, dtype):
    """Gradients through ``wkv6_state``'s Function on the card (the
    forward kernels at chunks of ``chunk``, then the backward kernel) equal
    ``wkv6_bwd_chunked_plain`` on the same inputs, each within 2e-4 of its
    largest entry (bf16: dr, dk, dv, rounded once, within 1e-2), with and
    without s0 and a final-state cotangent; r, k, v and w bf16 views of (B,
    S, D) in bf16; every gradient finite; a second backward bitwise the
    first; the backward's four launches a call, counted under its route
    (``wkv6.bwd_route``: the windows kernel at every head dim, at hd 128 on
    a cluster of two CTAs that split the state's columns)."""
    from repro_torch.kernels import wkv6 as wk
    dt = getattr(torch, dtype)
    leaves, u, s0, dout, ds = _wkv6_grad_inputs(
        cuda_device, 2, 3, S, hd, dt, w, with_state, seed=S + hd)
    views = [t.view(2, S, 3, hd).transpose(1, 2) if t.dim() == 3 else t
             for t in leaves]
    ins = leaves + [u] + ([s0] if with_state else [])
    out, s_fin = wk.wkv6_state(*views, u, s0, chunk=chunk)
    outs, cots = ([out, s_fin], [dout, ds]) if with_state else ([out], [dout])
    wk.LAUNCHES.clear()
    got = torch.autograd.grad(outs, ins, cots, retain_graph=True)
    again = torch.autograd.grad(outs, ins, cots)
    torch.cuda.synchronize()
    assert dict(wk.LAUNCHES) == {wk.BWD_COUNT[wk.bwd_route(hd)]:
                                 2 * wk.BWD_LAUNCHES}
    want = wk.wkv6_bwd_chunked_plain(
        *(t.detach() for t in views), u.detach(),
        None if s0 is None else s0.detach(), dout, ds, wk.BWD_CHUNK[hd])
    names = ("dr", "dk", "dv", "dw", "du", "ds0")
    for name, a, b, c, x in zip(names, got, again, want, ins):
        assert torch.equal(a, b), name
        assert a.dtype == x.dtype and a.shape == x.shape, name
        assert torch.isfinite(a).all(), name
        tol = 1e-2 if dt == torch.bfloat16 and name in ("dr", "dk", "dv") \
            else 2e-4
        if c.shape != a.shape:          # the plain version's (B, H, S, hd)
            c = c.transpose(1, 2).reshape(a.shape)
        err = (a.float() - c).abs().max().item()
        assert err <= tol * c.abs().max().item(), (name, err)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("w", [0.1, 1e-3, 1.0, "model"])
@pytest.mark.parametrize("S", [1, 15, 63, 64, 200, 1024])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_wkv6_bwd_windows_kernel_equals_its_plain(cuda_device, hd, S, w,
                                                  with_state, dtype):
    """The windows route's kernel (``csrc/wkv6_bwd_tc.cu``; at hd 128 a
    cluster of two CTAs) called directly on (B, H, S, hd) views of (B, S,
    D) tensors equals ``wkv6_bwd_windowed_plain`` on the same chunks, each
    gradient within 2e-4 of its largest entry (bf16 dr, dk, dv, rounded
    once, within 1e-2), with and without s0 and a final-state cotangent, at
    decays 0.1, 1e-3, 1 and the time mix's; every gradient finite; a second
    call bitwise the first; its four launches counted under
    "bwd_windows"."""
    from repro_torch.kernels import wkv6 as wk
    dt = getattr(torch, dtype)
    B, H = 2, 3
    g = torch.Generator(device=cuda_device).manual_seed(S + 7)

    def heads(x):
        return x.view(B, S, H, hd).transpose(1, 2)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda_device)
    r, k, v, dout = (heads(randn(B, S, H * hd).to(dt)) for _ in range(4))
    ww = torch.exp(-torch.exp(randn(B, S, H * hd) - 4.0)) if w == "model" \
        else torch.full((B, S, H * hd), w, device=cuda_device)
    ww = heads(ww)
    u = randn(H, hd) * 0.1
    s0 = randn(B, H, hd, hd) if with_state else None
    ds = randn(B, H, hd, hd) if with_state else None
    wk.LAUNCHES.clear()
    got = wk.wkv6_bwd(r, k, v, ww, u, s0, dout, ds)
    again = wk.wkv6_bwd(r, k, v, ww, u, s0, dout, ds)
    torch.cuda.synchronize()
    assert dict(wk.LAUNCHES) == {"bwd_windows": 2 * wk.BWD_LAUNCHES}
    want = wk.wkv6_bwd_windowed_plain(r, k, v, ww, u, s0, dout, ds,
                                      wk.BWD_CHUNK[hd])
    names = ("dr", "dk", "dv", "dw", "du", "ds0")
    for name, a, b, c in zip(names, got, again, want):
        assert torch.equal(a, b), name
        assert torch.isfinite(a).all(), name
        tol = 1e-2 if dt == torch.bfloat16 and name in ("dr", "dk", "dv") \
            else 2e-4
        err = (a.float() - c).abs().max().item()
        assert err <= tol * c.abs().max().item(), (name, err)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_wkv6_bwd_windows_kernel_reads_rows_element_by_element(cuda_device,
                                                               hd, dtype):
    """Rows the kernel cannot load 4 elements at a time (a token stride of
    hd + 1 elements) and a ragged last chunk: the same gradients as the
    plain version."""
    from repro_torch.kernels import wkv6 as wk
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    B, H, S = 1, 2, 100
    r, k, v, dout = (torch.randn((B, H, S, hd + 1), generator=g,
                                 device=cuda_device).to(dt)[..., :hd]
                     for _ in range(4))
    ww = torch.rand((B, H, S, hd + 1), generator=g,
                    device=cuda_device)[..., :hd] * 0.5 + 0.45
    u = torch.randn((H, hd), generator=g, device=cuda_device) * 0.1
    s0 = torch.randn((B, H, hd, hd), generator=g, device=cuda_device)
    got = wk.wkv6_bwd(r, k, v, ww, u, s0, dout)
    want = wk.wkv6_bwd_windowed_plain(r, k, v, ww, u, s0, dout, None,
                                      wk.BWD_CHUNK[hd])
    for name, a, c in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got, want):
        tol = 1e-2 if dt == torch.bfloat16 and name in ("dr", "dk", "dv") \
            else 2e-4
        assert (a.float() - c).abs().max() <= tol * c.abs().max(), name


@pytest.mark.requires_cuda
def test_wkv6_bwd_in_a_fresh_thread(cuda_device):
    """K5's backward launched first by a new thread (as autograd's worker
    thread launches it) equals the same call on this thread bitwise."""
    import threading
    from repro_torch.kernels import wkv6 as wk
    leaves, u, s0, dout, ds = _wkv6_grad_inputs(
        cuda_device, 1, 4, 130, 64, torch.bfloat16, 0.9, True, seed=3)
    xs = [t.detach().view(1, 130, 4, 64).transpose(1, 2) for t in leaves]
    want = wk.wkv6_bwd(*xs, u.detach(), s0.detach(), dout, ds)
    torch.cuda.synchronize()
    res = {}

    def run():
        try:
            res["got"] = wk.wkv6_bwd(*xs, u.detach(), s0.detach(), dout, ds)
            torch.cuda.synchronize()
        except Exception as e:      # raised again below, on this thread
            res["err"] = e
    th = threading.Thread(target=run)
    th.start()
    th.join()
    if "err" in res:
        raise res["err"]
    for a, b in zip(res["got"], want):
        assert torch.equal(a, b)


@pytest.mark.requires_cuda
def test_rwkv_gradients_on_the_card_equal_the_cpus(cuda_device):
    """The reduced rwkv6-3b's loss and every gradient (f32) on the card (K5
    forward and backward kernels) equal the same model's on the CPU (the
    plain versions), each within 2e-4 of its largest entry; K5 ran twice a
    layer forward (remat "full") and once backward."""
    import dataclasses
    from repro_torch.config import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.models import lm
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("rwkv6_3b", reduced=True),
                              dtype="float32")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = SyntheticLMData(vocab=cfg.vocab, seq_len=256, batch=2,
                            seed=1).batch_at(0)
    res = {}
    for dev in ("cpu", cuda_device):
        model = lm.LM(cfg, params).to(dev).requires_grad_(True)
        wk.LAUNCHES.clear()
        loss = lm.loss_fn(cfg, model, {k: torch.as_tensor(v, device=dev)
                                       for k, v in batch.items()})
        res[str(dev)] = (loss.item(), [g.cpu() for g in torch.autograd.grad(
            loss, model.param_list())])
    assert dict(wk.LAUNCHES) == {
        "sequence": 2 * wk.SEQUENCE_LAUNCHES * cfg.n_layers,
        wk.BWD_COUNT[wk.bwd_route(cfg.rwkv_head_dim)]:
            wk.BWD_LAUNCHES * cfg.n_layers}
    (lc, gc), (lg, gg) = res["cpu"], res[str(cuda_device)]
    assert lg == pytest.approx(lc, rel=2e-4)
    for a, b in zip(gg, gc):
        assert (a - b).abs().max() <= 2e-4 * b.abs().max()
