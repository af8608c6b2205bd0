"""The port's codegen backend (K2, the streamed kernel): its plain version
against the JAX package's ``sim.sequential_exec`` oracle, its plan against
the reference ``lower_program``'s, and the emitted CUDA text.

The float64 runs are bit-comparable to the float64 numpy oracle (same DAG,
same order), so equivalence uses rtol=1e-12/atol=0 — anything looser would
let a structurally wrong window or halo slip through as "close enough".
The reference's plan metadata needs no Pallas run, so it is compared
directly.  The CUDA kernel has no CPU mode: the tests that launch it are
in tests/test_torch_cuda.py.
"""
import re

import numpy as np
import pytest
import torch

from repro.core import codegen as ref_codegen
from repro.core import programs as ref_programs
from repro.core import sim as ref_sim
from repro_torch import _cuda
from repro_torch.core import codegen, hls, programs, sim
from repro_torch.core.errors import UnlowerableProgram
from repro_torch.kernels import stencil_pipeline as sp

_STREAMED = sorted([*programs.CHAIN_BENCHMARKS, "unsharp", "harris",
                    "fig1_conv_chain"])


def _mk(pkg, name, n=8):
    ctor = {**pkg.BENCHMARKS, **pkg.CHAIN_BENCHMARKS,
            "fig1_conv_chain": pkg.fig1_conv_chain}[name]
    return ctor(n, storage="bram")


@pytest.fixture(autouse=True)
def _port_fault_free():
    from repro_torch.core import faults
    faults.reset()
    yield
    faults.reset()


def _exact(kernel, name, n=8, seed=0):
    """The port's kernel (plain version, CPU) on the reference's inputs
    equals the reference's sequential oracle exactly."""
    p_ref = _mk(ref_programs, name, n)
    inputs = ref_sim.make_inputs(p_ref, seed=seed)
    want = ref_sim.sequential_exec(p_ref, inputs)
    got = kernel(inputs, device="cpu")
    assert tuple(got) == kernel.outputs
    for a in kernel.outputs:
        np.testing.assert_allclose(got[a].numpy(), want[a], rtol=1e-12,
                                   atol=0, err_msg=a)


# ---------------------------------------------------------------------------
# corpus coverage: every streamed program matches (Mode B: test_torch_whole)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", _STREAMED)
@pytest.mark.parametrize("buffering", ["double", "single"])
def test_streamed_corpus_matches_sequential_exec(name, buffering):
    k = codegen.lower_program(_mk(programs, name), buffering=buffering,
                              dtype="float64")
    assert isinstance(k, codegen.CudaKernel) and k.mode == "streamed"
    assert k.buffering == buffering
    _exact(k, name)


@pytest.mark.parametrize("name", _STREAMED)
@pytest.mark.parametrize("block_rows", [None, 4])
def test_plan_metadata_equals_reference(name, block_rows):
    want = ref_codegen.lower_program(_mk(ref_programs, name),
                                     block_rows=block_rows)
    got = codegen.lower_program(_mk(programs, name), block_rows=block_rows)
    assert want.mode == got.mode == "streamed"
    assert got.grid == want.grid
    assert got.block_rows == want.block_rows
    assert got.halo == want.halo
    assert got.vmem_window_elems == want.vmem_window_elems
    assert got.soft_reasons == want.soft_reasons
    assert got.outputs == want.outputs


@pytest.mark.parametrize("name", _STREAMED)
@pytest.mark.parametrize("col_tile", [7, 16])
@pytest.mark.parametrize("buffering", ["double", "single"])
def test_column_tiles_match_sequential_exec(name, col_tile, buffering,
                                            monkeypatch):
    """The card's column tiles (the reference tiles rows only), walked by
    the plain version tile for tile: at n=40 the last column tile is
    ragged for every program (conv_pool's 20-column sink reads its
    producer at column stride 2), and the last row tile too.  A block walks
    a run of row tiles: the launch grid is (runs, column tiles)."""
    monkeypatch.setattr(codegen, "_COL_TILES", (col_tile,))
    k = codegen.lower_program(_mk(programs, name, 40), block_rows=3,
                              buffering=buffering, dtype="float64")
    cout = k.launch_grid[1] * k.col_tile
    sink = _mk(programs, name, 40).arrays[k.outputs[0]].shape[1]
    assert k.col_tile == col_tile
    assert k.launch_grid[0] == -(-k.grid[0] // k.run)
    assert cout - col_tile < sink < cout          # a ragged last tile
    _exact(k, name, n=40)


def test_column_windows_follow_the_chain_backward():
    """conv_pool's pool tile of 16 columns reads conv at 2j+v: conv's
    window is 32 columns a tile, advancing 32 a tile; blur_chain's bx
    window is the tile's own columns (by reads bx at j) and harris' first
    producers carry the 3x3 sums' two-column overhang."""
    for name, want in (("conv_pool", (32, 0, 32)), ("blur_chain", (16, 0, 16)),
                       ("harris", (16, 0, 18))):
        p = _mk(programs, name, 64)
        plan, _ = codegen._plan_streamed(p, codegen._extract_nests(p)[0], 4)
        cols = codegen._plan_columns(p, plan, 16)
        first = plan.stages[0].out
        assert cols.cols[first] == want, name
        assert cols.cols[plan.sink.out] == (16, 0, 16)


def test_fig3_conv1d_unlowerable():
    """The flipped-kernel 1-D conv reads ``w[i + j]`` — a non-separable
    (two-iv) index codegen rejects with the access named in the reason."""
    with pytest.raises(UnlowerableProgram, match="non-separable"):
        codegen.lower_program(programs.fig3_conv1d(), dtype="float64")


def test_partial_tile_grid_and_result():
    k = codegen.lower_program(programs.blur_chain(10), block_rows=4,
                              dtype="float64")
    ref = ref_codegen.lower_program(ref_programs.blur_chain(10), block_rows=4)
    assert k.grid == ref.grid == (3,)
    assert k.block_rows == 4
    p_ref = ref_programs.blur_chain(10)
    inputs = ref_sim.make_inputs(p_ref, seed=2)
    np.testing.assert_allclose(k(inputs, device="cpu")["by"].numpy(),
                               ref_sim.sequential_exec(p_ref, inputs)["by"],
                               rtol=1e-12, atol=0)


@pytest.mark.parametrize("name", sorted(programs.CHAIN_BENCHMARKS))
def test_double_equals_single_bitwise_f32(name):
    p = programs.CHAIN_BENCHMARKS[name](12, storage="bram")
    inputs = sim.make_inputs(p, seed=0)
    kd = codegen.lower_program(p, block_rows=4)
    ks = codegen.lower_program(p, block_rows=4, buffering="single")
    assert kd.source == ks.source          # one .cu, both entry points
    od, os_ = kd(inputs, device="cpu"), ks(inputs, device="cpu")
    for a in kd.outputs:
        assert od[a].dtype == torch.float32
        assert torch.equal(od[a], os_[a])


def test_blur_chain_equals_hand_written_stencil_bitwise():
    """The generated blur chain is the hand-written K1, bit for bit."""
    p = programs.blur_chain(12)
    img = torch.from_numpy(sim.make_inputs(p, seed=5)["img"]).float()
    got = codegen.lower_program(p, block_rows=4)({"img": img})["by"]
    w = torch.tensor([1 / 3, 1 / 2, 1 / 3])
    assert torch.equal(got, sp.stencil_pipeline_plain(img, w, w))


def test_emit_cuda_from_compile_result():
    r = hls.compile(programs.blur_chain(8, storage="bram"),
                    pipeline="fuse,tile{sizes=4,8}")
    k = r.emit_cuda()
    assert k.modeled_latency == r.best.latency
    assert k.point_desc == r.best.desc
    assert k.halo == {"bx": 2}


def test_emit_cuda_records_unlowerable_diagnostic():
    r = hls.compile(programs.fig3_conv1d(), pipeline=())
    with pytest.raises(UnlowerableProgram):
        r.emit_cuda()
    diag = [d for d in r.diagnostics if d["kind"] == "codegen-unlowerable"]
    assert diag and "non-separable" in diag[0]["codes"]


@pytest.mark.parametrize("dtype,suffix", [("float32", "f"), ("float64", "")])
def test_constants_are_literals_of_the_kernel_type(dtype, suffix):
    """A bare double literal next to a float would promote the product to
    double; every constant of the f32 kernel carries the f suffix."""
    src = codegen.lower_program(programs.blur_chain(8), dtype=dtype).source
    lits = re.findall(r"\((-?\d+\.\d+(?:e[-+]?\d+)?)(f?)\)", src)
    assert lits and all(s == suffix for _, s in lits)
    if dtype == "float32":
        assert "(0.3333333432674408f)" in src   # 1/3 rounded to f32 first
    else:
        assert "(0.3333333333333333)" in src


def test_inputs_are_checked():
    p = programs.blur_chain(8)
    k = codegen.lower_program(p)
    img = torch.zeros(p.arrays["img"].shape, dtype=torch.float64)
    with pytest.raises(ValueError, match="dtype"):
        k({"img": img})
    with pytest.raises(ValueError, match="shape"):
        k({"img": torch.zeros(4, 4)})
    with pytest.raises(KeyError):
        k({})


def test_card_requested_without_card_raises(monkeypatch):
    """No path runs on the CPU when the card is asked for and missing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = programs.blur_chain(8)
    k = codegen.lower_program(p)
    inputs = sim.make_inputs(p, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        k(inputs)                       # numpy input: the card by default
    with pytest.raises(RuntimeError, match="no CUDA device"):
        k({"img": torch.zeros(10, 10)}, device="cuda")
    assert codegen.LAUNCHES[k.launch_key] == 0


def test_windows_beyond_shared_memory_are_reported():
    """With column tiles a block's rings are a strip of the image, so
    harris at 4096 keeps its design point's block size, in runs of
    ``_RUN_TILES`` row tiles.  blur_chain's rings at 4 rows and 512
    columns: bx's window (6 rows) and img's window plus the next tile's 4
    new rows (10 rows of 516: the 514 columns it reads, in whole 16-byte
    chunks).  A block size whose rings do not fit even at the narrowest
    column tile shrinks to the largest that fits and says so.  A chain
    that does not fit at one row keeps its plan, and its launch refuses
    rather than fall back."""
    k = codegen.lower_program(programs.harris(4096))
    assert k.block_rows == codegen.DEFAULT_BLOCK_ROWS
    assert k.soft_reasons == []
    assert k.smem_bytes <= codegen._SMEM_TARGET
    assert k.launch_grid == (-(-k.grid[0] // codegen._RUN_TILES),
                             -(-4096 // k.col_tile))
    blur = codegen.lower_program(programs.blur_chain(4096), block_rows=4)
    assert (blur.col_tile, blur.smem_bytes) == (512,
                                                (6 * 512 + 10 * 516) * 4)
    narrowest = codegen._COL_TILES[-1]
    tall = codegen.lower_program(programs.blur_chain(4096), block_rows=2000)
    # at B rows and 32 columns: bx (B + 2) x 32, img (2B + 2) x 36 floats
    need = lambda B: ((B + 2) * narrowest + (2 * B + 2) * 36) * 4  # noqa
    fit = max(B for B in range(1, 2000)
              if need(B) <= _cuda.MAX_SMEM_BYTES)
    assert tall.block_rows == fit and tall.col_tile == narrowest
    assert tall.soft_reasons == [
        f"block_rows 2000 -> {fit}: the windows need {need(2000)} bytes of "
        "shared memory at 2000 rows and the narrowest column tile, more "
        f"than the {_cuda.MAX_SMEM_BYTES} a block has"]
    assert tall.smem_bytes <= _cuda.MAX_SMEM_BYTES
    # a 1900-tap row blur needs 1900 rows of bx at one output row
    deep = codegen.lower_program(programs.blur_chain(64, taps=1900),
                                 block_rows=1)
    assert deep.block_rows == 1 and deep.soft_reasons == []
    assert deep.smem_bytes > _cuda.MAX_SMEM_BYTES
