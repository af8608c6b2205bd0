"""The port's whole-array lowering (K3, "Mode B"): its plan against the
reference ``lower_program``'s, its plain version against the JAX package's
``sim.sequential_exec`` oracle, and the emitted CUDA text.

The float64 runs are bit-comparable to the float64 numpy oracle (same DAG,
same order; a reduction folds in program order), so equivalence uses
rtol=1e-12/atol=0.  The CUDA kernel has no CPU mode: the tests that launch
it are in tests/test_torch_cuda.py.
"""
import functools
import random
import re

import numpy as np
import pytest
import torch

from repro.core import codegen as ref_codegen
from repro.core import programs as ref_programs
from repro.core import sim as ref_sim
from repro.core.ir import ProgramBuilder as RefBuilder
from repro.core.transforms import (FuseProducerConsumer, LoopTile, Normalize,
                                   PassManager)
from repro_torch.core import codegen, hls, programs
from repro_torch.core.ir import ProgramBuilder

WHOLE_N = {"dus": 8, "optical_flow": 6, "two_mm": 6}


@pytest.fixture(autouse=True)
def _port_fault_free():
    from repro_torch.core import faults
    faults.reset()
    yield
    faults.reset()


def _check_oracle(kernel, p_ref, seed=0, want=None):
    """The port's kernel (plain version, CPU) on the reference's inputs
    equals the reference's sequential oracle (or ``want``) exactly."""
    inputs = ref_sim.make_inputs(p_ref, seed=seed)
    want = want or ref_sim.sequential_exec(p_ref, inputs)
    got = kernel(inputs, device="cpu")
    assert tuple(got) == kernel.outputs
    for a in kernel.outputs:
        assert got[a].dtype == torch.float64
        np.testing.assert_allclose(got[a].numpy(), want[a], rtol=1e-12,
                                   atol=0, err_msg=a)


# ---------------------------------------------------------------------------
# the paper's Mode B programs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(WHOLE_N))
def test_whole_metadata_equals_reference(name):
    n = WHOLE_N[name]
    want = ref_codegen.lower_program(ref_programs.BENCHMARKS[name](
        n, storage="bram"))
    got = codegen.lower_program(programs.BENCHMARKS[name](n, storage="bram"))
    assert want.mode == got.mode == "whole"
    assert want.buffering == got.buffering == "whole"
    assert got.grid == want.grid == ()
    assert got.block_rows is want.block_rows is None
    assert got.halo == want.halo == {}
    assert got.outputs == want.outputs
    assert got.vmem_window_elems == want.vmem_window_elems == {}
    assert got.soft_reasons == want.soft_reasons
    assert got.lib_name == f"whole_{name}_float32"


@pytest.mark.parametrize("name", sorted(WHOLE_N))
@pytest.mark.parametrize("scale", [1, 2])
def test_whole_plain_matches_sequential_exec(name, scale):
    n = WHOLE_N[name] * scale
    k = codegen.lower_program(programs.BENCHMARKS[name](n, storage="bram"),
                              dtype="float64")
    assert k.mode == "whole"
    _check_oracle(k, ref_programs.BENCHMARKS[name](n, storage="bram"),
                  seed=scale)


def test_whole_kernel_reads_only_what_it_needs():
    """Fully covered outputs need no input, also where two stores cover an
    array between them (dus' row and column pairs); a reduction's carry
    starts at its input."""
    dus = codegen.lower_program(programs.dus(8))
    assert dus.inputs == ("img",)
    assert "cudaMemcpyAsync(" not in dus.source
    mm = codegen.lower_program(programs.two_mm(6))
    assert mm.inputs == ("A", "B", "C", "tmp", "D")
    assert "cudaMemcpyAsync(" not in mm.source
    assert mm.nest_launches == 2
    flow = codegen.lower_program(programs.optical_flow(6))
    assert flow.inputs == ("f1", "f2") and flow.nest_launches == 2


def test_emit_cuda_lowers_a_whole_array_design_point():
    r = hls.compile(programs.two_mm(6))
    k = r.emit_cuda(dtype="float64")
    assert k.mode == "whole" and k.buffering == "whole"
    assert k.modeled_latency == r.best.latency
    assert k.point_desc == r.best.desc
    _check_oracle(k, ref_programs.two_mm(6))


@pytest.mark.parametrize("dtype,suffix", [("float32", "f"), ("float64", "")])
def test_whole_constants_are_literals_of_the_kernel_type(dtype, suffix):
    src = codegen.lower_program(programs.dus(8), dtype=dtype).source
    assert f"(0.25{suffix})" in src and f"(0.5{suffix})" in src
    assert ("__fmul_rn" in src) == (dtype == "float32")


# ---------------------------------------------------------------------------
# launches: runs of elementwise nests share one
# ---------------------------------------------------------------------------


def _transposed(B, war: bool):
    """Two nests over one 4x4 domain meeting on one array at transposed
    points: the second reads what the first wrote (``war`` False), or
    writes what the first read (True).  Either splits the launch."""
    b = B("transposed_war" if war else "transposed_raw")
    for a in ("x", "w", "y"):
        b.array(a, (4, 4), is_arg=True, ports=("w", "r"))
    with b.loop("ai", 0, 4) as i:
        with b.loop("aj", 0, 4) as j:
            v = b.load("w", j, i) if war else b.load("x", i, j)
            b.store("y", b.mul(v, b.const(2.0)), i, j)
    with b.loop("bi", 0, 4) as i:
        with b.loop("bj", 0, 4) as j:
            v = b.load("x", i, j) if war else b.load("y", j, i)
            b.store("w" if war else "x", b.add(v, b.const(1.0)), i, j)
    return b.build()


def _program(case, B=ProgramBuilder):
    from repro_torch.core import frontend
    if case.startswith("transposed"):
        return _transposed(B, case.endswith("war"))
    if case.startswith("traced_conv"):
        return frontend.conv_block_program(
            *map(int, case.split("_")[-1].split("x"))).program
    return programs.BENCHMARKS[case](WHOLE_N[case], storage="bram")


GROUPS = {   # program -> the nests of each launch
    "traced_conv_10x10": (("i0", "i2", "i4", "i6", "i8"),
                          ("i10", "i12", "i14", "i16", "i18", "i20")),
    "traced_conv_34x40": (("i0", "i2", "i4", "i6", "i8"),
                          ("i10", "i12", "i14", "i16", "i18", "i20")),
    "optical_flow": (("gxi", "gyi", "gti"),
                     ("sxxi", "syyi", "sxyi", "sxti", "syti", "svi")),
    # each nest reads its producer at a strided point
    "dus": (("dxi",), ("dyi",), ("uyi",), ("uxi",)),
    "two_mm": (("pi",), ("ci",)),
    "transposed_raw": (("ai",), ("bi",)),
    "transposed_war": (("ai",), ("bi",)),
}


@pytest.mark.parametrize("case", sorted(GROUPS))
def test_whole_launch_groups(case):
    k = codegen.lower_program(_program(case), dtype="float64")
    assert k.launch_nests == GROUPS[case]
    assert k.nest_launches == len(GROUPS[case])
    assert k.source.count("__global__ void") == len(GROUPS[case])


@pytest.mark.parametrize("case", ["transposed_raw", "transposed_war"])
def test_transposed_meetings_match_sequential_exec(case):
    k = codegen.lower_program(_program(case), dtype="float64")
    _check_oracle(k, _program(case, RefBuilder), seed=9)


@pytest.mark.parametrize("case", sorted(GROUPS))
def test_whole_group_reads_what_it_writes_only_in_registers(case):
    """Within a launch, every read of an array the launch writes is at the
    point where the same thread wrote it, so no kernel of a launch loads an
    array it stores; held on the plan and on the emitted text."""
    p = _program(case)
    nests, _ = codegen._extract_nests(p)
    plan = codegen._plan_whole(p, nests, "float32")
    for launch in plan.launches:
        written = {codegen._at(nests[n], acc) for n in launch.nests
                   for _, acc in nests[n].stores}
        arrays = {at[0] for at in written}
        for n in launch.nests:
            for op, acc in nests[n].loads:
                if acc.array in arrays and op.uid not in nests[n].red_loads:
                    assert codegen._at(nests[n], acc) in written, \
                        (case, nests[n].loop.ivname, acc)
    src = codegen.lower_program(p).source
    for kernel in src.split("__global__ void")[1:]:
        stored = set(re.findall(r"(?<!const )real\* __restrict__ (o_\w+)",
                                kernel))
        for name in stored:
            assert not re.search(rf"= {name}\[", kernel), (case, name)


def _overlap_between(B):
    """An elementwise nest, a nest whose two stores overlap, then a nest
    reading the first one's output at the same point: the overlapping nest
    closes the group, so the three take four launches."""
    b = B("overlap_between")
    b.array("x", (5, 4), is_arg=True, ports=("r", "r"))
    b.array("y0", (5, 4), is_arg=True, ports=("w", "r"))
    b.array("y1", (6, 4), is_arg=True, ports=("w",))
    b.array("z", (5, 4), is_arg=True, ports=("w",))
    for tag in ("a", "b", "c"):
        with b.loop(f"{tag}i", 0, 5) as i:
            with b.loop(f"{tag}j", 0, 4) as j:
                if tag == "a":
                    b.store("y0", b.mul(b.load("x", i, j), b.const(2.0)), i, j)
                elif tag == "b":
                    a = b.load("x", i, j)
                    b.store("y1", b.mul(a, b.const(3.0)), i, j)
                    b.store("y1", b.add(a, b.const(1.0)), i + 1, j)
                else:
                    b.store("z", b.sub(b.load("y0", i, j), b.load("x", i, j)),
                            i, j)
    return b.build()


def test_overlapping_stores_keep_a_launch_each_between_groups():
    k = codegen.lower_program(_overlap_between(ProgramBuilder),
                              dtype="float64")
    assert k.launch_nests == (("ai",), ("bi",), ("bi",), ("ci",))
    p_ref = _overlap_between(RefBuilder)
    inputs = ref_sim.make_inputs(p_ref, seed=6)
    want = ref_sim.sequential_exec(p_ref, inputs)
    y1 = inputs["y1"].copy()
    y1[0:5] = inputs["x"] * 3.0      # op order: the later store wins
    y1[1:6] = inputs["x"] + 1.0
    _check_oracle(k, p_ref, seed=6, want={**want, "y1": y1})


# ---------------------------------------------------------------------------
# reductions tiled through shared memory
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", [6, 33])
def test_two_mm_tiled_matches_sequential_exec(m):
    """Tile edges (m < the tile) and a k tail (33 = 2 chunks of 16 + 1)."""
    k = codegen.lower_program(programs.two_mm(m), dtype="float64")
    assert k.tiled_reductions == ("pi", "ci")
    _check_oracle(k, ref_programs.two_mm(m), seed=m)


def _left_fold(x, w, carry):
    acc = carry.clone()
    for kk in range(x.shape[1]):
        acc = acc + x[:, kk:kk + 1] * w[kk:kk + 1, :]
    return acc


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("m", [130, 200])
def test_two_mm_tiled_plain_equals_a_direct_left_fold(m, dtype):
    """Two edge tiles and a ragged k chunk (130, 200): the tiled plain
    version against a left fold written out here, bit for bit."""
    tdt = getattr(torch, dtype)
    k = codegen.lower_program(programs.two_mm(m), dtype=dtype)
    assert k.tiled_reductions == ("pi", "ci")
    rng = np.random.default_rng(m)
    x = {a: torch.from_numpy(rng.uniform(-1.0, 1.0, (m, m))).to(tdt)
         for a in k.inputs}
    got = k(x, device="cpu")
    tmp = _left_fold(x["A"], x["B"], x["tmp"])
    assert torch.equal(got["tmp"], tmp)
    assert torch.equal(got["D"], _left_fold(tmp, x["C"], x["D"]))


def _bits(t: torch.Tensor) -> np.ndarray:
    a = t.numpy()
    return a.view(np.int32 if a.dtype == np.float32 else np.int64)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_two_mm_k_tail_keeps_signed_zeros_and_infinities(dtype):
    """m = 11: one full chunk and a tail of 3 k.  The carry is -0.0 and
    row 3 of A is zero against negative B, so its points fold -0.0 + -0.0
    (padding the tail with +0.0 products would give +0.0) but for column 2,
    where B's tail holds a +0.0; an inf in A's tail meets that zero (NaN)
    and nonzeros (inf).  Held bit for bit,
    NaN-aware, against a per-point fold in numpy."""
    m = 11
    npdt = np.float32 if dtype == "float32" else np.float64
    rng = np.random.default_rng(11)
    A = rng.uniform(0.5, 2.0, (m, m)).astype(npdt)
    B = -rng.uniform(0.5, 2.0, (m, m)).astype(npdt)
    C = rng.uniform(0.5, 2.0, (m, m)).astype(npdt)
    A[3] = 0.0
    A[5, 9] = np.inf
    B[9, 2] = 0.0
    xs = {"A": A, "B": B, "C": C, "tmp": np.full((m, m), -0.0, npdt),
          "D": np.full((m, m), -0.0, npdt)}

    def fold(x, w, carry):
        out = carry.copy()
        with np.errstate(invalid="ignore"):
            for i in range(m):
                for j in range(m):
                    acc = carry[i, j]
                    for kk in range(m):
                        acc = npdt(acc + npdt(x[i, kk] * w[kk, j]))
                    out[i, j] = acc
        return out

    tmp = fold(A, B, xs["tmp"])
    want = {"tmp": tmp, "D": fold(tmp, C, xs["D"])}
    assert (tmp[3] == 0).all() and np.signbit(tmp[3]).sum() == m - 1
    assert np.isnan(tmp[5, 2]) and np.isinf(tmp[5]).sum() == m - 1
    k = codegen.lower_program(programs.two_mm(m), dtype=dtype)
    got = k({a: torch.from_numpy(v) for a, v in xs.items()}, device="cpu")
    for a, w in want.items():
        nan = np.isnan(w)
        assert np.array_equal(got[a].isnan().numpy(), nan), a
        assert np.array_equal(_bits(got[a])[~nan], w.view(_bits(got[a]).dtype)
                              [~nan]), a


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_two_mm_kernels_hold_the_tiled_form(dtype):
    """Both nests' kernels stage through a shared-memory tile with cp.async
    and fold with the _rn intrinsics (no FMA).  The (i, k) operand, whose
    rows run along k, comes through 16-byte loads into registers, stored
    transposed after each chunk's arithmetic."""
    k = codegen.lower_program(programs.two_mm(64), dtype=dtype)
    kernels = k.source.split("__global__ void")[1:]
    assert len(kernels) == 2
    rn = "__fmul_rn" if dtype == "float32" else "__dmul_rn"
    vt = "float4" if dtype == "float32" else "double2"
    for text, a in zip(kernels, ("x_A", "o_tmp")):
        assert "__shared__ __align__(16) real s0[2][16]" in text
        assert "cp_async_elem(" in text and "cp_async_wait<1>()" in text
        assert rn in text and "fma" not in text
        assert f"reinterpret_cast<const {vt}*>(&{a}[" in text
        assert "if (ch + 1 < 4) put(buf ^ 1);" in text
    assert "cp.async.cg.shared.global" in k.source
    assert 0 < k.smem_bytes <= 48 * 1024


def _row_sums(B, n: int = 7, taps: int = 5):
    """A reduction with one outer iv: s[i] += x[i, k]."""
    b = B("row_sums")
    b.array("x", (n, taps), is_arg=True, ports=("r", "r"))
    b.array("s", (n,), is_arg=True, ports=("w", "r"))
    with b.loop("i", 0, n) as i:
        with b.loop("k", 0, taps) as k:
            b.store("s", b.add(b.load("s", i), b.load("x", i, k)), i)
    return b.build()


def _wide_reduction(B, taps: int, n: int = 9):
    """A reduction with two outer ivs and ``taps + 1`` staged loads, each
    double-buffered in 16,896 bytes at k chunks of 16 (f32 or f64): three
    do not fit a block's 48 KB of static shared memory, two do."""
    b = B(f"wide_reduction_{taps}")
    b.array("x", (n, n + 6), is_arg=True, ports=("r", "r"))
    b.array("y", (n, n), is_arg=True, ports=("r", "r"))
    b.array("s", (n, n), is_arg=True, ports=("w", "r"))
    with b.loop("i", 0, n) as i:
        with b.loop("j", 0, n) as j:
            with b.loop("k", 0, n) as k:
                v = b.load("s", i, j)
                for t in range(taps):
                    v = b.add(v, b.load("x", i, k + t))
                v = b.add(v, b.load("y", k, j))
                b.store("s", v, i, j)
    return b.build()


@pytest.mark.parametrize("build,dtype,tiled", [
    (_row_sums, "float64", ()), (_row_sums, "float32", ()),
    (functools.partial(_wide_reduction, taps=2), "float32", ()),
    (functools.partial(_wide_reduction, taps=2), "float64", ()),
    (functools.partial(_wide_reduction, taps=1), "float32", ("i",)),
    (functools.partial(_wide_reduction, taps=1), "float64", ("i",)),
])
def test_reductions_outside_the_tiled_form_fold_per_point(build, dtype,
                                                          tiled):
    """One outer iv, or staged copies that would not fit a block's static
    shared memory, keep the per-point fold; tiled or not, the result is the
    sequential one."""
    k = codegen.lower_program(build(ProgramBuilder), dtype=dtype)
    assert k.tiled_reductions == tiled
    assert ("cp_async" in k.source) == bool(tiled)
    assert ("k in chunks of 16" in k.source) == bool(tiled)
    p_ref = build(RefBuilder)
    inputs = ref_sim.make_inputs(p_ref, seed=8)
    want = ref_sim.sequential_exec(p_ref, inputs)
    got = k(inputs, device="cpu")
    for a in k.outputs:
        np.testing.assert_allclose(got[a].numpy(), want[a],
                                   rtol=1e-12 if dtype == "float64" else 1e-6,
                                   atol=0, err_msg=a)


# ---------------------------------------------------------------------------
# two stores of one nest to one array
# ---------------------------------------------------------------------------


def _two_store(B, overlap: bool):
    """One nest writing ``y`` twice: rows ``2i`` and ``2i + 1`` (disjoint,
    dus's parity pattern) or rows ``i`` and ``i + 1`` (overlapping: row
    ``i + 1`` is written by iteration ``i`` twice over)."""
    b = B("two_store_overlap" if overlap else "two_store_parity")
    b.array("x", (5, 4), is_arg=True, ports=("r", "r"))
    b.array("y", (6 if overlap else 10, 4), is_arg=True, ports=("w",))
    with b.loop("i", 0, 5) as i:
        with b.loop("j", 0, 4) as j:
            a = b.load("x", i, j)
            b.store("y", b.mul(a, b.const(3.0)), i if overlap else i * 2, j)
            b.store("y", b.add(a, b.const(1.0)),
                    i + 1 if overlap else i * 2 + 1, j)
    return b.build()


def test_two_disjoint_stores_match_sequential_exec():
    """Disjoint stores: one launch, and the result is the sequential one."""
    k = codegen.lower_program(_two_store(ProgramBuilder, False),
                              dtype="float64")
    assert k.mode == "whole" and k.nest_launches == 1
    _check_oracle(k, _two_store(RefBuilder, False))


def test_two_overlapping_stores_follow_the_reference_op_order():
    """Overlapping stores: one launch per store, in op order, so the later
    store wins over the whole domain — the reference's Mode B order, which
    is not ``sequential_exec``'s iteration order.  Held against a numpy
    rendering of that order."""
    k = codegen.lower_program(_two_store(ProgramBuilder, True),
                              dtype="float64")
    assert k.mode == "whole" and k.nest_launches == 2
    p_ref = _two_store(RefBuilder, True)
    inputs = ref_sim.make_inputs(p_ref, seed=4)
    y = inputs["y"].copy()
    y[0:5] = inputs["x"] * 3.0       # the first store over the domain
    y[1:6] = inputs["x"] + 1.0       # then the second: it wins on overlap
    seq = ref_sim.sequential_exec(p_ref, inputs)["y"]
    assert not np.array_equal(seq, y)          # the two orders differ here
    _check_oracle(k, p_ref, seed=4, want={"y": y})


def _stores(B, name, yshape, trips, where):
    """One nest over ``trips`` storing ``x[i, j] + k`` into ``y`` at
    ``where[k](i, j)`` for each k: the stores that may or may not cover
    ``y`` between them."""
    b = B(name)
    b.array("x", trips, is_arg=True, ports=("r", "r"))
    b.array("y", yshape, is_arg=True, ports=("w",))
    with b.loop("i", 0, trips[0]) as i:
        with b.loop("j", 0, trips[1]) as j:
            a = b.load("x", i, j)
            for k, at in enumerate(where):
                b.store("y", b.add(a, b.const(float(k))), *at(i, j))
    return b.build()


COVER_CASES = {   # name -> (y shape, domain, store indices, covered)
    "transposed": ((6, 4), (4, 6), [lambda i, j: (j, i)], True),
    "half_rows": ((8, 4), (4, 4), [lambda i, j: (i, j)], False),
    "row_pair": ((8, 4), (4, 4), [lambda i, j: (i * 2, j),
                                  lambda i, j: (i * 2 + 1, j)], True),
    "col_pair_short": ((4, 9), (4, 4), [lambda i, j: (i, j * 2),
                                        lambda i, j: (i, j * 2 + 1)], False),
    "checkerboard": ((8, 8), (4, 4), [lambda i, j: (i * 2, j * 2),
                                      lambda i, j: (i * 2 + 1, j * 2 + 1)],
                     False),
}


@pytest.mark.parametrize("case", sorted(COVER_CASES))
def test_initial_values_are_copied_only_where_the_stores_leave_gaps(case):
    """An output starts as a copy of its input exactly where the nest's
    stores leave elements unwritten; either way the result is the
    sequential one."""
    yshape, trips, where, covered = COVER_CASES[case]
    k = codegen.lower_program(_stores(ProgramBuilder, case, yshape, trips,
                                      where), dtype="float64")
    assert k.mode == "whole" and k.outputs == ("y",)
    assert ("y" in k.inputs) == ("cudaMemcpyAsync(" in k.source) \
        == (not covered)
    _check_oracle(k, _stores(RefBuilder, case, yshape, trips, where))


def test_transposed_strided_and_constant_accesses():
    """A transposed store, a strided partial store, a constant-index load,
    a 1-D array and a reduction whose result lands transposed."""
    def build(B):
        b = B("mixed_accesses")
        b.array("a", (4, 6), is_arg=True, ports=("r", "r"))
        b.array("v", (6,), is_arg=True, ports=("r", "r"))
        b.array("t", (6, 4), is_arg=True, ports=("w", "r"))
        b.array("s", (9, 9), is_arg=True, ports=("w", "r"))
        b.array("r", (6, 3), is_arg=True, ports=("w", "r"))
        with b.loop("i", 0, 4) as i:
            with b.loop("j", 0, 6) as j:
                x = b.mul(b.load("a", i, j), b.load("v", j))
                b.store("t", b.sub(x, b.load("a", 2, 3)), j, i)
        with b.loop("p", 0, 3) as p_:
            with b.loop("q", 0, 4) as q:
                b.store("s", b.load("t", q + 1, p_), p_ * 3 + 1, q * 2)
        with b.loop("u", 0, 3) as u:
            with b.loop("w", 0, 6) as w:
                with b.loop("k", 0, 4) as k:
                    acc = b.load("r", w, u)
                    b.store("r", b.add(acc, b.mul(b.load("t", w, k),
                                                  b.load("a", k, u))), w, u)
        return b.build()

    k = codegen.lower_program(build(ProgramBuilder), dtype="float64")
    assert k.mode == "whole" and k.outputs == ("t", "s", "r")
    _check_oracle(k, build(RefBuilder), seed=3)


# ---------------------------------------------------------------------------
# property test: randomized fused/tiled chains (the reference's generator)
# ---------------------------------------------------------------------------


def _random_chain(rng: random.Random, B):
    """A random 2-stage producer-consumer chain: conv-like stage over img
    into bx, then a row-stencil stage into out — random sizes, taps, ops and
    weights; about one in five stores strided (the whole-array fallback).
    ``B`` is the builder class, so both packages build the same program."""
    n = rng.randint(4, 10)
    w = rng.randint(4, 8)
    t1, t2 = rng.randint(1, 3), rng.randint(1, 3)
    ct = rng.randint(1, 2)
    strided = rng.random() < 0.2
    b = B(f"rand_chain_{n}x{w}")
    H1 = n + t2 - 1                       # bx rows stage2 consumes
    b.array("img", (H1 + t1 - 1, w + ct - 1),
            partition=(0,), ports=("w", "r", "r", "r"))
    b.array("bx", (H1, w), partition=(0,), ports=("w", "r", "r", "r"))
    out_shape = (n, 2 * w) if strided else (n, w)
    b.array("out", out_shape, partition=(0,), ports=("w", "r", "r", "r"),
            is_arg=True)
    fns = ["add", "mul", "min", "max", "sub"]

    def combine(vals):
        acc = vals[0]
        for v in vals[1:]:
            acc = b.arith(rng.choice(fns), acc, v)
        return acc

    with b.loop("pi", 0, H1) as i:
        with b.loop("pj", 0, w) as j:
            vals = [b.mul(b.load("img", i + a_, j + c_),
                          b.const(round(rng.uniform(0.25, 1.5), 3)))
                    for a_ in range(t1) for c_ in range(ct)]
            b.store("bx", combine(vals), i, j)
    with b.loop("ci", 0, n) as i:
        with b.loop("cj", 0, w) as j:
            vals = [b.mul(b.load("bx", i + a_, j),
                          b.const(round(rng.uniform(0.25, 1.5), 3)))
                    for a_ in range(t2)]
            if strided:
                b.store("out", combine(vals), i, 2 * j)
            else:
                b.store("out", combine(vals), i, j)
    return b.build()


@pytest.mark.parametrize("seed", range(27))
def test_property_random_chain(seed):
    """27 randomized fused/tiled chains: the port's kernel lowered from the
    original program with the pipeline's tile size matches the reference's
    transformed program under ``sequential_exec`` exactly (float64)."""
    rng = random.Random(1000 + seed)
    p_ref = _random_chain(rng, RefBuilder)
    p = _random_chain(random.Random(1000 + seed), ProgramBuilder)
    passes = [Normalize()]
    if rng.random() < 0.7:
        passes.append(FuseProducerConsumer())
    bs = rng.choice([None, 2, 3, 4])
    if bs is not None:
        passes.append(LoopTile((bs,)))
    q = PassManager(passes, verify=True).run(p_ref)
    k = codegen.lower_program(p, block_rows=bs,
                              buffering=rng.choice(["double", "single"]),
                              dtype="float64")
    assert k.mode == ref_codegen.lower_program(p_ref, block_rows=bs).mode
    inputs = ref_sim.make_inputs(p_ref, seed=seed)
    ref = ref_sim.sequential_exec(q, inputs)
    got = k(inputs, device="cpu")
    for a in k.outputs:
        np.testing.assert_allclose(got[a].numpy(), ref[a], rtol=1e-12,
                                   atol=0, err_msg=f"seed={seed} array={a} "
                                                   f"mode={k.mode}")
