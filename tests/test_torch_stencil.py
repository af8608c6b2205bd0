"""The port's fused stencil (K1): its plain version against the JAX
package's oracle, its configuration against the reference's, and the rule
that the wrapper runs on the card or raises.

The same inputs, made with numpy from a seed, go to both packages.  The
CUDA kernel itself has no CPU mode: the tests that launch it are in
tests/test_torch_cuda.py.  Its schedule is pinned here through a Python
twin of the kernel's walk (``_walk_twin``), run on the geometry the wrapper
passes to the kernel (``launch_geometry``).
"""
import collections
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as jax_ref
from repro_torch.kernels import ref as torch_ref
from repro_torch.kernels import stencil_pipeline as sp

W3 = [0.25, 0.5, 0.25]
FRAME = (2160, 3840)             # the 4K UHD frame chip_smoke.py runs K1 on


@pytest.fixture(autouse=True)
def _port_fault_free():
    from repro_torch.core import faults
    faults.reset()
    yield
    faults.reset()


def _img(H, W, seed=1) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((H, W)).astype(
        np.float32)


def _jax_oracle(img: torch.Tensor) -> np.ndarray:
    """repro's stencil_pipeline_ref in f32 on the same values."""
    w = jnp.asarray(W3, jnp.float32)
    return np.asarray(jax_ref.stencil_pipeline_ref(
        jnp.asarray(img.float().numpy()), w, w))


@functools.lru_cache(maxsize=None)
def _jax_oracle_of(H, W, dtype) -> np.ndarray:
    return _jax_oracle(torch.from_numpy(_img(H, W)).to(getattr(torch, dtype)))


def _access_bytes(addr: int) -> int:
    """The widest access (16, 8, 4 or 2 bytes) a row starting at byte
    ``addr`` allows: the kernel's ``access_bytes``."""
    a = addr & 15
    return a & -a if a else 16


def _walk_twin(img, wx, wy, block_rows, halo, base=0):
    """The kernel's walk, lane by lane (vectorised over the lanes of all
    strips), on the geometry the wrapper launches.  ``base`` is the image's
    offset in elements from a 16-byte boundary.  Returns the output, the
    number of times each output element was written, the reads of each
    input element per run (a lane's own 16 bytes, and apart from them lane
    31's two columns to the right), and the access widths used, {bytes:
    rows}, for loads and stores."""
    H, W = img.shape
    E = img.element_size()
    g = sp.launch_geometry(H, W, img.dtype, block_rows, halo)
    Hout, Wout, V = H - 2, W - 2, g.vec
    strips, runs = g.grid
    flat = img.reshape(-1)
    out = torch.zeros((Hout, Wout), dtype=img.dtype)
    written = torch.zeros((Hout, Wout), dtype=torch.int64)
    reads = []
    widths = {"load": collections.Counter(), "store": collections.Counter()}
    t = torch.arange(strips * g.threads)          # lanes of all strips
    lane = t % 32
    cols = t[:, None] * V + torch.arange(V)       # each lane's columns
    ext_cols = t[:, None] * V + V + torch.arange(2)
    for sy in range(runs):
        o0 = sy * g.run
        r1 = min(o0 + g.run, Hout) + 2
        owner = torch.zeros((H, W), dtype=torch.int64)
        extra = torch.zeros((H, W), dtype=torch.int64)
        carried = collections.deque(maxlen=halo + 1)   # bx rows before r
        for r in range(o0, r1):
            nbytes = _access_bytes((base + r * W) * E)
            assert bool((((base + r * W + cols[:, 0]) * E) % nbytes
                         == 0).all())
            widths["load"][nbytes] += 1
            x = torch.zeros((len(t), V + 2), dtype=torch.float32)
            inside = cols < W
            x[:, :V][inside] = flat[r * W + cols[inside]].float()
            owner[r].index_add_(0, cols[inside],
                                torch.ones(int(inside.sum()),
                                           dtype=torch.int64))
            # columns c+V, c+V+1: the next lane's first two; lane 31 loads
            ext = torch.zeros((len(t), 2), dtype=torch.float32)
            e_in = (ext_cols < W) & (lane == 31)[:, None]
            ext[e_in] = flat[r * W + ext_cols[e_in]].float()
            extra[r].index_add_(0, ext_cols[e_in],
                                torch.ones(int(e_in.sum()),
                                           dtype=torch.int64))
            nxt = torch.roll(x[:, :2], -1, dims=0)
            x[:, V:] = torch.where((lane == 31)[:, None], ext, nxt)
            bx = x[:, 0:V] * wx[0] + x[:, 1:V + 1] * wx[1] \
                + x[:, 2:V + 2] * wx[2]
            if r - o0 >= 2:
                o = carried[-2] * wy[0] + carried[-1] * wy[1] + bx * wy[2]
                ok = cols < Wout
                widths["store"][_access_bytes((r - 2) * Wout * E)] += 1
                out[r - 2, cols[ok]] = o[ok].to(img.dtype)
                written[r - 2, cols[ok]] += 1
            carried.append(bx)
        reads.append((o0, r1, owner, extra))
    return out, written, reads, widths


# W: one output column, a few, a row stride of 8 and 4 bytes mod 16, the
# traced conv block's width; H - 2 = 8 (one run) and 40 (several runs, the
# last shorter where the run does not divide 40: runs of 12 and 16 in f32,
# of 14 and 16 in bf16)
TWIN_W = [3, 4, 5, 130, 131, 4098]
TWIN_H = [10, 42]


@pytest.mark.parametrize("halo", [2, 3])
@pytest.mark.parametrize("br", [1, 2, 4, 8])
@pytest.mark.parametrize("H", TWIN_H)
@pytest.mark.parametrize("W", TWIN_W)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_walk_twin_equals_plain_and_jax_oracle(dtype, W, H, br, halo):
    """The kernel's schedule (strips, runs, carried bx rows, the next
    lane's columns, per-row access widths, ragged edges, halo > 2) gives
    the plain version bit for bit, and the JAX package's oracle within the
    JAX suite's tolerance; every output element is written once, and each
    input row of a run is read once by the lanes that own it."""
    td = getattr(torch, dtype)
    img = torch.from_numpy(_img(H, W)).to(td)
    w = torch.tensor(W3)
    got, written, reads, _ = _walk_twin(img, w, w, br, halo)
    assert torch.equal(got, sp.stencil_pipeline_plain(img, w, w))
    assert bool((written == 1).all())
    g = sp.launch_geometry(H, W, td, br, halo)
    warps = g.grid[0] * g.threads // 32
    covered = g.grid[0] * g.strip        # columns the lanes own
    for o0, r1, owner, extra in reads:
        # the columns past the last lane's own (at most 2) come from its
        # two extra loads; everything else once from its owner
        assert bool((owner[o0:r1, :covered] == 1).all())
        assert bool((owner[o0:r1, covered:] + extra[o0:r1, covered:]
                     == 1).all())
        assert int(owner.sum() + extra.sum()) <= (r1 - o0) * (W + 2 * warps)
    tol = 3e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got.float().numpy(),
                               _jax_oracle_of(H, W, dtype), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("base", [1, 2, 3, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_walk_twin_on_unaligned_images(dtype, base):
    """An image starting ``base`` elements past a 16-byte boundary (a view
    with a storage offset): rows take 8-, 4- or 2-byte accesses, and the
    result is still the plain version's."""
    td = getattr(torch, dtype)
    img = torch.from_numpy(_img(26, 131, seed=base)).to(td)
    w = torch.tensor(W3)
    got, written, _, widths = _walk_twin(img, w, w, 2, 2, base=base)
    assert torch.equal(got, sp.stencil_pipeline_plain(img, w, w))
    assert bool((written == 1).all())
    assert set(widths["load"]) != {16}
    assert min(widths["load"]) >= img.element_size()


@pytest.mark.parametrize("dtype,loads,stores", [
    ("float32", {16: 1}, {16: 1, 8: 1}),
    ("bfloat16", {16: 1}, {16: 1, 8: 1, 4: 2})])
def test_frame_rows_access_widths(dtype, loads, stores):
    """The 4K frame: every input row takes 16-byte loads; output rows of
    3838 columns alternate 16 and 8 bytes in f32 and cycle 16, 4, 8, 4 in
    bf16 (shares of rows per width)."""
    E = getattr(torch, dtype).itemsize
    H, W = FRAME
    lw = collections.Counter(_access_bytes(r * W * E) for r in range(H))
    sw = collections.Counter(_access_bytes(r * (W - 2) * E)
                             for r in range(H - 2))
    assert {b: n / H for b, n in lw.items()} == \
        {b: n / sum(loads.values()) for b, n in loads.items()}
    assert {b: round(n / (H - 2), 2) for b, n in sw.items()} == \
        {b: round(n / sum(stores.values()), 2) for b, n in stores.items()}


def _coverage(H, W, dtype, br, halo):
    g = sp.launch_geometry(H, W, getattr(torch, dtype), br, halo)
    Hout, Wout = H - 2, W - 2
    count = np.zeros((Hout, Wout), np.int64)
    strips, runs = g.grid
    for sy in range(runs):
        for sx in range(strips):
            for t in range(g.threads):
                c = (sx * g.threads + t) * g.vec
                count[sy * g.run:(sy + 1) * g.run, c:c + g.vec] += 1
    return g, count


@pytest.mark.parametrize("halo", [2, 3])
@pytest.mark.parametrize("br", [1, 2, 4, 8])
@pytest.mark.parametrize("H", TWIN_H)
@pytest.mark.parametrize("W", TWIN_W)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_launch_geometry_covers_every_output_once(dtype, W, H, br, halo):
    g, count = _coverage(H, W, dtype, br, halo)
    assert bool((count == 1).all())
    assert g.run % br == 0 and g.threads % 32 == 0
    assert g.strip == g.threads * g.vec and g.vec * getattr(
        torch, dtype).itemsize == 16
    # the last strip and run hold at least one column and row
    assert (g.grid[0] - 1) * g.strip < W - 2
    assert (g.grid[1] - 1) * g.run < H - 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_launch_geometry_covers_the_frame_once(dtype):
    br, halo = sp._stencil_codegen_config()
    g = sp.launch_geometry(*FRAME, getattr(torch, dtype), br, halo)
    Hout, Wout = FRAME[0] - 2, FRAME[1] - 2
    rows = np.zeros(Hout, np.int64)
    for sy in range(g.grid[1]):
        rows[sy * g.run:(sy + 1) * g.run] += 1
    cols = np.zeros(Wout, np.int64)
    for t in range(g.grid[0] * g.threads):
        cols[t * g.vec:(t + 1) * g.vec] += 1
    assert bool((rows == 1).all()) and bool((cols == 1).all())
    assert g.run % br == 0 and g.run >= sp.RUN_ROWS[getattr(torch, dtype)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_frame_grid_gives_two_waves(dtype):
    """At least two blocks for each of the H100's 132 SMs at the frame."""
    g = sp.launch_geometry(*FRAME, getattr(torch, dtype),
                           *sp._stencil_codegen_config())
    assert g.grid[0] * g.grid[1] >= 2 * 132
    assert g.grid[1] <= sp.MAX_GRID_Y


@pytest.mark.parametrize("br,halo", [(1, 2), (2, 2), (8, 3), (1079, 2)])
def test_smem_bytes_within_a_blocks_limit(br, halo):
    from repro_torch import _cuda
    for dtype in (torch.float32, torch.bfloat16):
        g = sp.launch_geometry(2160, 3840, dtype, br, halo)
        assert g.smem == sp.smem_bytes(br, halo) <= _cuda.MAX_SMEM_BYTES
        assert g.smem <= 48 * 1024       # no opt-in to more needed
        assert g.threads == sp.THREADS


@pytest.mark.parametrize("H,W,br", [(18, 32, 8), (34, 130, 4), (10, 16, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stencil_pipeline_plain_matches_jax_oracle(H, W, br, dtype):
    td = getattr(torch, dtype)
    img = torch.from_numpy(_img(H, W)).to(td)
    w = torch.tensor(W3, dtype=td)
    got = sp.stencil_pipeline(img, w, w, block_rows=br)   # CPU: plain
    assert got.dtype == td and tuple(got.shape) == (H - 2, W - 2)
    tol = 3e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got.float().numpy(), _jax_oracle(img),
                               rtol=tol, atol=tol)


def test_torch_ref_matches_jax_ref():
    img = torch.from_numpy(_img(34, 130, seed=3))
    got = torch_ref.stencil_pipeline_ref(img, torch.tensor(W3),
                                         torch.tensor(W3))
    np.testing.assert_allclose(got.numpy(), _jax_oracle(img), rtol=1e-5,
                               atol=1e-5)


def test_plain_matches_torch_ref_in_f32():
    img = torch.from_numpy(_img(18, 32, seed=4))
    w = torch.tensor(W3)
    np.testing.assert_allclose(
        sp.stencil_pipeline_plain(img, w, w).numpy(),
        torch_ref.stencil_pipeline_ref(img, w, w).numpy(), rtol=1e-6,
        atol=1e-6)


def test_default_config_from_dse_equals_reference():
    from repro.kernels import stencil_pipeline as jax_sp
    assert sp._stencil_codegen_config() == (2, 2)
    assert sp.stencil_config_source() == "dse"
    assert sp._stencil_codegen_config() == jax_sp._stencil_codegen_config()


def test_ilp_halo_rows_equals_reference():
    from repro.kernels import stencil_pipeline as jax_sp
    assert sp.ilp_halo_rows() == jax_sp.ilp_halo_rows()


def test_rows_not_multiple_of_block_rows_raise():
    img = torch.from_numpy(_img(11, 16))
    w = torch.tensor(W3)
    with pytest.raises(ValueError, match="not a multiple of block_rows"):
        sp.stencil_pipeline(img, w, w, block_rows=2, halo=2)


def test_halo_below_two_raises():
    img = torch.from_numpy(_img(10, 16))
    w = torch.tensor(W3)
    with pytest.raises(ValueError, match="halo"):
        sp.stencil_pipeline(img, w, w, block_rows=4, halo=1)


def test_unsupported_dtype_raises():
    img = torch.from_numpy(_img(10, 16)).double()
    with pytest.raises(ValueError, match="dtype"):
        sp.stencil_pipeline(img, torch.tensor(W3), torch.tensor(W3),
                            block_rows=4, halo=2)


def test_card_requested_without_card_raises(monkeypatch):
    """No path runs on the CPU when the card is asked for and missing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = torch.from_numpy(_img(10, 16))
    w = torch.tensor(W3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sp.stencil_pipeline(img, w, w, block_rows=4, halo=2, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sp.stencil_pipeline(_img(10, 16), np.array(W3, np.float32),
                            np.array(W3, np.float32), block_rows=4, halo=2)
    assert sum(sp.LAUNCHES.values()) == 0


def test_shared_memory_fits_the_block_at_the_default_config():
    br, halo = sp._stencil_codegen_config()
    assert sp.smem_bytes(br, halo) <= 48 * 1024
