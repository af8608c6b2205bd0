"""K2's run and ring walk on the CPU: a block walks a run of row tiles down
its column tile, each producer carried as a ring of its window's rows, so a
run computes its halo rows once.  ``streamed_plain`` walks the kernel's
runs, rings and slots; here it is held against the JAX package's
``sim.sequential_exec`` in float64 (rtol 1e-12: the same DAG in the same
order, so any wrong slot or run boundary shows), with ragged runs and
ragged column tiles.  The geometry the card reads (rings, launch grid,
the stage loops' index arithmetic) is checked on the emitted plan and
source; the kernel itself runs in tests/test_torch_cuda.py.
"""
import re

import numpy as np
import pytest

from repro.core import codegen as ref_codegen
from repro.core import programs as ref_programs
from repro.core import sim as ref_sim
from repro_torch.core import codegen, programs

_STREAMED = sorted([*programs.CHAIN_BENCHMARKS, "unsharp", "harris",
                    "fig1_conv_chain"])


def _mk(pkg, name, n):
    ctor = {**pkg.BENCHMARKS, **pkg.CHAIN_BENCHMARKS,
            "fig1_conv_chain": pkg.fig1_conv_chain}[name]
    return ctor(n, storage="bram")


@pytest.fixture(autouse=True)
def _port_fault_free():
    from repro_torch.core import faults
    faults.reset()
    yield
    faults.reset()


@pytest.mark.parametrize("name", _STREAMED)
@pytest.mark.parametrize("run", [1, 3, 100])
@pytest.mark.parametrize("col_tile", [7, 16])
def test_walk_matches_sequential_exec(name, run, col_tile, monkeypatch):
    """At n=40 and 3-row tiles: 14 row tiles (conv_pool: 7), so runs of 3
    leave a ragged last run, runs of 100 one run over all of them, runs of
    1 a halo recomputed every tile; both column tiles are ragged at the
    right edge."""
    monkeypatch.setattr(codegen, "_RUN_TILES", run)
    monkeypatch.setattr(codegen, "_COL_TILES", (col_tile,))
    p_ref = _mk(ref_programs, name, 40)
    k = codegen.lower_program(_mk(programs, name, 40), block_rows=3,
                              dtype="float64")
    T = k.grid[0]
    assert k.run == min(run, T)
    assert k.launch_grid == (-(-T // k.run), k.launch_grid[1])
    if run == 3:
        assert T % run != 0                         # a ragged last run
    inputs = ref_sim.make_inputs(p_ref, seed=3)
    want = ref_sim.sequential_exec(p_ref, inputs)
    got = k(inputs, device="cpu")
    for a in k.outputs:
        np.testing.assert_allclose(got[a].numpy(), want[a], rtol=1e-12,
                                   atol=0, err_msg=a)


@pytest.mark.parametrize("name", _STREAMED)
def test_ring_rows_are_the_producers_windows(name):
    """Every producer a later phase reads keeps a ring of its window's rows
    (``win_sz`` = its halo + the rows a tile adds); a producer read only at
    its own point by stages of its own window has no ring: its values stay
    in the registers of the thread that computed them."""
    p = _mk(programs, name, 64)
    k = codegen.lower_program(p, block_rows=4)
    plan, _ = codegen._plan_streamed(p, codegen._extract_nests(p)[0], 4)
    for s in plan.stages:
        if s is plan.sink:
            assert s.out not in k.ring_rows
        elif s.out in k.ring_rows:
            assert k.ring_rows[s.out] == s.win_sz
            assert s.win_sz == k.halo[s.out] + s.win_a
        else:
            assert (s.win_a, s.win_b, s.win_sz) == (4, 0, 4)
            assert k.halo[s.out] == 0
    rings = {"blur_chain": ["bx"], "conv_pool": ["conv"],
             "correlated_chain": ["mid"], "fig1_conv_chain": ["convX"],
             "gradient_harris": ["G"], "harris": ["Ix", "Iy"],
             "unsharp": ["bx"]}[name]
    assert sorted(k.ring_rows) == sorted(rings)


@pytest.mark.parametrize("name", _STREAMED)
@pytest.mark.parametrize("run", [1, 3])
def test_runs_keep_the_reference_plan(name, run, monkeypatch):
    """Runs are the card's schedule only: block_rows, halo, the row-tile
    grid and the windows stay the reference's."""
    monkeypatch.setattr(codegen, "_RUN_TILES", run)
    want = ref_codegen.lower_program(_mk(ref_programs, name, 64),
                                     block_rows=4)
    got = codegen.lower_program(_mk(programs, name, 64), block_rows=4)
    assert got.grid == want.grid
    assert got.block_rows == want.block_rows
    assert got.halo == want.halo
    assert got.vmem_window_elems == want.vmem_window_elems
    assert got.run == run


def _tile_loop(src: str) -> str:
    """The body of the walk's loop over row tiles, comments removed."""
    body = src[src.index("for (int t = t0; t < t1; ++t) {"):]
    body = body[:body.index("\n    }\n}\n")]
    return re.sub(r"//[^\n]*", "", body)


@pytest.mark.parametrize("name", _STREAMED)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_stage_loops_have_no_division(name, dtype):
    """Threads are mapped to column groups and strips once a walk; inside
    the tile loop a ring slot is a base plus a constant, wrapped by one
    subtraction, so no element pays a division or a remainder."""
    k = codegen.lower_program(_mk(programs, name, 64), block_rows=4,
                              dtype=dtype)
    loop = _tile_loop(k.source)
    assert "__syncthreads();" in loop and "r0" in loop
    assert not re.search(r"[^/]/[^/]|%", loop), name


@pytest.mark.parametrize("name", _STREAMED)
def test_inputs_are_staged_by_cp_async(name):
    """Each input arrives through a ring of its own filled by cp.async, the
    next tile's rows issued before this tile computes; the emitted source
    launches a (runs, column tiles) grid."""
    k = codegen.lower_program(_mk(programs, name, 64), block_rows=4)
    src = k.source
    assert "cp.async.cg.shared.global" in src
    for x in k.inputs:
        assert f"stage_{x}(" in src
    loop = _tile_loop(src)
    # the next tile's copies start before the first phase computes
    assert loop.index("if (t + 1 < t1)") < loop.index("if (ty")
    assert all(f"stage_{x}(" in loop for x in k.inputs)
    U, runs = k.launch_grid[1], k.launch_grid[0]
    assert f"dim3({U}, {runs})" in src


def _mixed_rates(ir, n):
    """An input read at two row rates: ``bx`` reads img at row i (rate B
    a tile), the sink at row 2i (rate 2B), so img has no one window per
    tile."""
    b = ir.ProgramBuilder("mixed_rates")
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


@pytest.mark.parametrize("run", [1, 3])
def test_input_at_two_row_rates_is_read_directly(run, monkeypatch):
    """An input whose readers advance at different row rates has no ring:
    the kernel reads it from device memory (``__ldg``, rows clamped to the
    array as the reference edge-pads them), and the walk still equals the
    oracle."""
    from repro.core import ir as ref_ir
    from repro_torch.core import ir
    monkeypatch.setattr(codegen, "_RUN_TILES", run)
    monkeypatch.setattr(codegen, "_COL_TILES", (16,))
    k = codegen.lower_program(_mixed_rates(ir, 41), block_rows=4,
                              dtype="float64")
    assert k.mode == "streamed" and k.ring_rows == {"bx": 6}
    assert "__ldg(x_img" in k.source and "stage_img(" not in k.source
    p_ref = _mixed_rates(ref_ir, 41)
    inputs = ref_sim.make_inputs(p_ref, seed=5)
    np.testing.assert_allclose(
        k(inputs, device="cpu")["out"].numpy(),
        ref_sim.sequential_exec(p_ref, inputs)["out"], rtol=1e-12, atol=0)
