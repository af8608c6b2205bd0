"""Fused producer-consumer stencil chain as a CUDA kernel for Hopper — the
paper's Fig. 1 pattern (two chained convolutions) on the GPU's memory
hierarchy.

The FPGA version overlaps the two loop nests with an ILP-derived slack: the
consumer may start once the producer has written ``halo`` rows.  On the GPU
the same slack *sizes the line buffer*, which the kernel holds in
registers and walks down the image: a block owns a strip of output columns
and a run of output rows; each thread owns 16 bytes of a row (4 columns in
f32, 8 in bf16), takes the two columns to its right from the next lane,
computes its producer row (conv-x) and, once ``halo`` rows are in, emits one
consumer row (conv-y) per input row from the rows it carries — the
intermediate array never touches device memory, and each input row of a run
is read once.  ``block_rows`` is the number of output rows one step of the
walk emits; a run is a whole number of steps.  ``launch_geometry`` and
the constants above it are the one place the grid, strip, run, threads,
rows in flight and shared memory are chosen; the kernel takes them as
arguments or, where they must be known when it compiles, as ``#define``s
that ``kernel_source`` puts before its text.  The kernel is
``csrc/stencil_pipeline.cu``; ``stencil_pipeline_plain`` beside it is the
plain PyTorch version, which the wrapper runs only for tensors on the CPU.

This hand-written kernel is the *golden reference* of the codegen backend:
``repro_torch.core.codegen.lower_program`` generates the same computation
from the ``programs.blur_chain`` IR (bit-exact in float32), and the
block/halo configuration is read off the generated kernel —
``hls.compile`` shift-and-peel-fuses the mismatched-bounds chain, the knee
point of the latency x BRAM Pareto frontier is lowered with
``CompileResult.emit_cuda()``, and the kernel's ``block_rows`` / ``halo``
supply both values (the fusion's row shift IS the halo).  The older fixed
probe (``ilp_halo_rows``) is kept only as the fallback when the sweep finds
no shifted fusion.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools

import numpy as np
import torch

from .. import _cuda

SOURCE = _cuda.CSRC_DIR / "stencil_pipeline.cu"
LIB_NAME = "stencil_pipeline"
_ENTRY = {torch.float32: "stencil_pipeline_f32",
          torch.bfloat16: "stencil_pipeline_bf16"}

# launches per image dtype ("float32" / "bfloat16"), counted at the launch
LAUNCHES: collections.Counter = collections.Counter()

THREADS = 128        # threads per block (4 warps), fewer on narrow images
RING_ROWS = 4        # input rows in flight per thread, in shared memory
# blocks of THREADS an SM is guaranteed to hold: the kernel's launch bounds,
# which leave ptxas 65,536 / (blocks x THREADS) registers a thread
BLOCKS_PER_SM = {torch.float32: 8, torch.bfloat16: 5}
# output rows per run: the fastest measured on the H100 at the 4K frame
# (PERF.md, PR 18); a run re-reads 2 halo rows, mostly from L2
RUN_ROWS = {torch.float32: 10, torch.bfloat16: 14}
MAX_GRID_Y = 65535


@functools.lru_cache(maxsize=None)
def kernel_source() -> str:
    """``csrc/stencil_pipeline.cu`` with the constants it takes from here."""
    return (f"#define K1_THREADS {THREADS}\n#define K1_RING {RING_ROWS}\n"
            f"#define K1_BLOCKS_F32 {BLOCKS_PER_SM[torch.float32]}\n"
            f"#define K1_BLOCKS_BF16 {BLOCKS_PER_SM[torch.bfloat16]}\n"
            + SOURCE.read_text())


@functools.lru_cache(maxsize=None)
def _launcher(dtype: torch.dtype):
    lib = _cuda.load(LIB_NAME, kernel_source())
    return lib, _cuda.entry(lib, _ENTRY[dtype], [ctypes.c_void_p] * 4
                            + [ctypes.c_int] * 9 + [ctypes.c_void_p])


@dataclasses.dataclass(frozen=True)
class Geometry:
    """How ``csrc/stencil_pipeline.cu`` covers one image: ``grid`` blocks
    (strips, runs) of ``threads`` threads; a thread owns ``vec`` columns
    (16 bytes), a block a strip of ``strip`` output columns and a run of
    ``run`` output rows (the last strip and run may be shorter); ``smem``
    bytes of shared memory a block (its ring of rows in flight)."""
    grid: tuple
    strip: int
    run: int
    threads: int
    vec: int
    smem: int


def launch_geometry(H: int, W: int, dtype: torch.dtype, block_rows: int,
                    halo: int) -> Geometry:
    """The launch geometry of an (H, W) image of ``dtype`` at
    ``(block_rows, halo)``: runs of ``RUN_ROWS`` rows rounded up to whole
    steps of ``block_rows`` (longer where the grid's y limit needs it), one
    lane per 16 bytes of a row.  ``halo`` beyond 2 changes nothing: the
    3-tap conv-y reads two carried rows."""
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    Hout, Wout = H - 2, W - 2
    lanes = -(-Wout // vec)
    threads = min(THREADS, 32 * -(-lanes // 32))
    strip = threads * vec
    want = max(RUN_ROWS[dtype], -(-Hout // MAX_GRID_Y))
    run = min(block_rows * -(-want // block_rows), Hout)
    return Geometry(grid=(-(-Wout // strip), -(-Hout // run)), strip=strip,
                    run=run, threads=threads, vec=vec,
                    smem=smem_bytes(block_rows, halo, threads))


def smem_bytes(block_rows: int, halo: int, threads: int = THREADS) -> int:
    """Dynamic shared memory of one block, the same at any configuration:
    the ring of ``RING_ROWS`` rows of 16 bytes a thread, and of 8 bytes a
    warp for lane 31's two extra columns."""
    return RING_ROWS * (threads * 16 + threads // 32 * 8)


def stencil_pipeline_plain(img: torch.Tensor, wx: torch.Tensor,
                           wy: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: conv_y(conv_x(img)) with f32 accumulation
    in the kernel's order, ``(a*w0 + b*w1) + c*w2``, rounded once to the
    image dtype."""
    x = img.float()
    wx, wy = wx.float(), wy.float()
    H, W = x.shape
    Hout, Wout = H - 2, W - 2
    bx = x[:, 0:Wout] * wx[0] + x[:, 1:Wout + 1] * wx[1] \
        + x[:, 2:Wout + 2] * wx[2]
    out = bx[0:Hout] * wy[0] + bx[1:Hout + 1] * wy[1] + bx[2:Hout + 2] * wy[2]
    return out.to(img.dtype)


def _as_image(img, dev: torch.device) -> torch.Tensor:
    t = torch.as_tensor(img, device=dev) if isinstance(img, np.ndarray) \
        else img
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"img: expected a tensor, got {type(img).__name__}")
    if t.device != dev:
        raise ValueError(f"img: on {t.device}, kernel runs on {dev}")
    if t.dtype not in _ENTRY:
        raise ValueError(f"img: dtype {t.dtype}, kernel takes float32 or "
                         "bfloat16")
    if t.dim() != 2 or t.shape[0] < 3 or t.shape[1] < 3:
        raise ValueError(f"img: shape {tuple(t.shape)}, kernel takes (H, W) "
                         "with H, W >= 3")
    if not t.is_contiguous():
        raise ValueError("img: not contiguous")
    return t


def _as_weights(w, dev: torch.device, what: str) -> torch.Tensor:
    if isinstance(w, torch.Tensor) and w.device != dev:
        raise ValueError(f"{what}: on {w.device}, kernel runs on {dev}")
    t = torch.as_tensor(w, device=dev).to(torch.float32).contiguous()
    if tuple(t.shape) != (3,):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, kernel takes (3,)")
    return t


def stencil_pipeline(img, wx, wy, *, block_rows=None, halo=None,
                     device=None):
    """img: (H, W) float32 or bfloat16; wx, wy: (3,).  Returns
    conv_y(conv_x(img)) of shape (H-2, W-2) in img's dtype, computed in one
    fused pass.  ``block_rows``/``halo`` default to the DSE-derived
    configuration (``_stencil_codegen_config``).  ``device`` defaults to the
    device the tensors lie on (the card for numpy input): the kernel runs on
    the card, the plain version on the CPU."""
    if block_rows is None or halo is None:
        dse_rows, dse_halo = _stencil_codegen_config()
        block_rows = dse_rows if block_rows is None else block_rows
        halo = dse_halo if halo is None else halo
    dev = _cuda.resolve_device([img, wx, wy], device)
    img = _as_image(img, dev)
    wx, wy = _as_weights(wx, dev, "wx"), _as_weights(wy, dev, "wy")
    H, W = img.shape
    Hout = H - 2
    block_rows = min(block_rows, Hout)
    if block_rows < 1 or Hout % block_rows:
        raise ValueError(f"output rows {Hout} are not a multiple of "
                         f"block_rows {block_rows}")
    if halo < 2:
        raise ValueError(f"halo {halo} < 2: the 3-tap conv-y needs two rows "
                         "beyond the tile")
    if dev.type == "cpu":
        return stencil_pipeline_plain(img, wx, wy)
    g = launch_geometry(H, W, img.dtype, block_rows, halo)
    lib, launch = _launcher(img.dtype)
    out = torch.empty((Hout, W - 2), dtype=img.dtype, device=dev)
    with torch.cuda.device(dev):
        rc = launch(img.data_ptr(), wx.data_ptr(), wy.data_ptr(),
                    out.data_ptr(), H, W, block_rows, halo, *g.grid,
                    g.threads, g.run, g.smem,
                    _cuda.current_stream(dev))
    _cuda.check(lib, rc, "stencil_pipeline")
    LAUNCHES[str(img.dtype).removeprefix("torch.")] += 1
    return out


@functools.lru_cache()
def ilp_halo_rows(taps: int = 3) -> int:
    """Fallback fixed probe (demoted: the ``emit_cuda`` sweep in
    ``_stencil_codegen_config`` is the primary source): derive the
    line-buffer halo from the paper's memory-dependence
    ILP by scheduling a two-nest conv chain and converting the
    producer->consumer slack into rows (slack = -(halo rows) * II_row).

    The two-nest chain is produced by the pass pipeline rather than built by
    hand: the producer is written as raw accumulation + a pointwise scale
    nest, and ``FuseProducerConsumer`` (equal-bounds mode, with an exact ILP
    legality proof) collapses them into the single producer nest whose RAW
    edges on ``mid`` carry the halo."""
    from repro_torch.core.autotune import compile_program
    from repro_torch.core.ir import ProgramBuilder
    from repro_torch.core.transforms import (FuseProducerConsumer, Normalize,
                                             PassManager)

    n = 8
    b = ProgramBuilder("halo_probe")
    Hm = n + taps - 1
    b.array("img", (n + 2 * (taps - 1), n), partition=(0, 1), ports=("w", "r"))
    b.array("acc", (Hm, n), partition=(0, 1), ports=("w", "r"))
    b.array("mid", (Hm, n), partition=(0, 1), ports=("w", "r"))
    b.array("out", (n, n), partition=(0, 1), ports=("w", "r"))
    # producer, unfused form: accumulate taps, then scale pointwise
    with b.loop("pi", 0, Hm) as i:
        with b.loop("pj", 0, n) as j:
            t = [b.load("img", i + t_, j) for t_ in range(taps)]
            b.store("acc", b.sum_tree(t), i, j)
    with b.loop("si", 0, Hm) as i:
        with b.loop("sj", 0, n) as j:
            b.store("mid", b.mul(b.load("acc", i, j), b.const(1.0 / taps)), i, j)
    # consumer conv over the fused producer's output
    with b.loop("ci", 0, n) as i:
        with b.loop("cj", 0, n) as j:
            t = [b.mul(b.load("mid", i + t_, j), b.const(1.0 / taps))
                 for t_ in range(taps)]
            b.store("out", b.sum_tree(t), i, j)
    # equal-bounds fusion only: the probe MEASURES the cross-nest slack, so
    # the consumer must stay a separate nest (shift fusion would absorb it)
    p = PassManager([Normalize(), FuseProducerConsumer(enable_shift=False)],
                    verify=True).run(b.build())
    assert len(p.body) == 2, "accumulate+scale must fuse into the producer"
    s = compile_program(p)
    prod, _ = p.body
    ii_row = s.iis[prod.uid]
    # the RAW dependence edges on `mid` carry the slack: lower = delay - slack
    # = wr_latency + halo_rows * II_row; the worst edge is the deepest tap.
    worst = max(e.lower for e in s.edges
                if e.kind == "RAW" and e.array == "mid")
    return max(1, -(-(worst - 1) // ii_row))  # ceil


# (taps, n) -> "dse" or "fallback(<reason>)": which path produced the config
# returned by _stencil_codegen_config — tests assert the DSE sweep actually
# ran, so a silently broken sweep cannot hide behind the fallback's values.
_CONFIG_SOURCE: dict[tuple[int, int], str] = {}


def restricted_spec(hls) -> dict:
    """``hls.compile`` keywords of the sweep's restricted search: fusion and
    tiling only, at most 8 candidates, a latency x BRAM frontier.  ``hls``
    is the compiler module the spec is built for (its ``minimize`` and
    ``SearchConfig``), so one policy serves every caller."""
    return dict(objectives=(hls.minimize("latency"), hls.minimize("bram")),
                search=hls.SearchConfig(moves=("fuse", "tile"),
                                        unroll_factors=(), tile_sizes=(2, 4),
                                        max_candidates=8))


def _stencil_dse_sweep(taps: int, n: int) -> tuple[int, int]:
    """Run the hls.compile Pareto sweep, lower the knee point with
    ``emit_cuda``, and read (block_rows, halo) off the generated kernel;
    raises RuntimeError when no frontier point shift-fused bx."""
    from repro_torch.core import hls
    from repro_torch.core.errors import UnlowerableProgram
    from repro_torch.core.programs import blur_chain

    # bram storage so the tile-window footprint term differentiates block
    # sizes; the partition move is excluded — full partitioning is a knob
    # the kernel's shared-memory line buffer cannot express
    p = blur_chain(n, storage="bram", taps=taps)
    r = hls.compile(p, **restricted_spec(hls))

    def row_shift(c):
        for entry in getattr(c.program, "_fusion_log", []):
            if "bx" in entry["arrays"] and entry["shift"][0] > 0:
                return entry["shift"][0]
        return None

    fused = [c for c in r.frontier if row_shift(c) is not None]
    if not fused:
        raise RuntimeError("DSE sweep found no shifted fusion of bx on the "
                           "frontier")
    # knee of the latency x BRAM trade-off among the fused frontier points,
    # lowered to the generated kernel: its window analysis turns the fusion's
    # row shift into the line-buffer halo, and the knee's tiling of the
    # fused row loop into the kernel's row-block size
    knee = r.knee("latency", "bram", among=fused)
    try:
        kern = r.emit_cuda(knee)
    except UnlowerableProgram as e:
        raise RuntimeError(f"knee point unlowerable: {e}") from e
    return kern.block_rows, kern.halo["bx"]


@functools.lru_cache()
def _stencil_codegen_config(taps: int = 3, n: int = 8) -> tuple[int, int]:
    """(block_rows, halo) for ``stencil_pipeline``, read off the generated
    kernel of the DSE knee point.

    ``hls.compile`` explores transform pipelines over the mismatched-bounds
    blur chain; the knee of the latency x BRAM curve among the candidates
    that shift-and-peel fused the intermediate ``bx`` is lowered with
    ``CompileResult.emit_cuda()`` and the kernel reports its own config:
    ``CudaKernel.halo["bx"]`` is the fusion's row shift (the number of
    producer rows the consumer trails by — the line-buffer halo) and
    ``CudaKernel.block_rows`` the knee's tiling of the fused row loop.
    Falls back to the fixed ``ilp_halo_rows`` probe if the sweep yields no
    shifted fusion; ``stencil_config_source`` reports which path produced
    the values.

    Persistence rides the compile cache: ``hls.compile`` stores the whole
    frontier content-addressed (``repro_torch.core.cache``), so a serving
    process pays the sweep once per machine and this function only replays
    a cache hit.  The ``lru_cache`` on top memoizes the in-process lookups;
    cache entries carry the scheduler salt, so a compiler change
    invalidates them and the sweep reruns."""
    try:
        cfg = _stencil_dse_sweep(taps, n)
        _CONFIG_SOURCE[(taps, n)] = "dse"
    except RuntimeError as e:  # demoted fixed-probe fallback
        _CONFIG_SOURCE[(taps, n)] = f"fallback({e})"
        cfg = 8, ilp_halo_rows(taps)
    return cfg


def stencil_config_source(taps: int = 3, n: int = 8) -> str:
    """'dse' when the stencil config values came from the emit_cuda
    sweep, else 'fallback(<reason>)'."""
    _stencil_codegen_config(taps, n)
    return _CONFIG_SOURCE[(taps, n)]
