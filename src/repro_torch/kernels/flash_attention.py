"""Flash attention (forward) as CUDA kernels for Hopper (K4).

The TPU kernel (``repro.kernels.flash_attention``) walks a (B*H, S/block_q)
grid and streams kv blocks through VMEM with online softmax.  The card has
three kernels for it, chosen by dtype and head dim alone (``route``):

* bf16 at hd 64, 128 and 256: ``csrc/flash_attention_wgmma.cu``.  A block
  owns 128 q rows (two consumer warpgroups of 64); its products run on the
  tensor cores (``wgmma``), K and V tiles arrive by TMA through a ring of
  shared-memory stages, and the tensor maps carry each tensor's strides, so
  k and v may have fewer heads than q (grouped-query attention) and every
  input may be a strided view, such as the ``.transpose(1, 2)`` of a
  layer's (B, S, H, hd) activations.  Its (block_q, block_k) pairs are
  ``WGMMA_BLOCKS[hd]``; the first is the default.  hd 256 has kernels of
  its own (``split_route``): a block's two warpgroups take a pair of 64-row
  units (the same rows of two q heads of a GQA group, which share every K
  and V tile), and where the pairs are fewer than the card's ``SMS`` their
  walks are cut into pieces (``fwd_split``) whose fp32 partials a second
  kernel combines in a fixed order: ``fwd_launches`` kernels a call.
* float32 at hd 64, 128 and 256: ``csrc/flash_attention_tf32x3.cu``.  A
  block is one warpgroup of 64 q rows; its products run on the tensor cores
  (``wgmma``) in error-compensated TF32: each fp32 operand is split into a
  TF32 hi and lo part and each product summed as lo*hi + hi*lo + hi*hi,
  which keeps the 2e-5 limit that plain TF32 breaks.  It walks its own
  tiles, 64 q rows by 32 keys, or by 16 at hd 256 where Q's split copies
  fill half of shared memory (``TF32X3_BLOCKS``), and takes no other
  blocks.  It takes any views whose rows are unit-stride and 16-byte
  aligned (others are copied to a contiguous layout first), k and v at
  their kv heads, and writes the output in q's layout.
* float32 and bf16 at hd 16 and 32: ``csrc/flash_attention.cu``, one block
  of 8 warps per (b*h, q block of at most 64 rows) on the CUDA cores (16
  rows by default, ``CUDA_CORE_BLOCKS``).  It reads the views it is given
  through their strides (rows unit-stride), k and v at their kv heads, and
  writes the output in q's layout: one call is one kernel.

All stop a causal q block at the kv block that holds its last row,
``((qi+1)*block_q - 1)//block_k + 1`` blocks, where the TPU kernel's
``(qi*block_q)//block_k + 1`` drops blocks when ``block_q > block_k``.

The gradient: where grad is enabled and q, k or v requires grad,
``flash_attention`` runs as a ``torch.autograd.Function``.  Its forward is
the kernel above, asked also for each row's log-sum-exp (an optional output
of all three; serving calls pass none and run as before); it saves q, k, v
as given (views, k and v at their kv heads), the output and the
log-sum-exp.  Its backward is chosen by dtype and head dim alone
(``bwd_route``), as the forward is:

* bf16 at hd 64, 128 and 256: ``csrc/flash_attention_bwd_wgmma.cu``
  (``"wgmma"``), its products on the tensor cores, every tile fed by TMA
  through an mbarrier ring, GQA and strided views read natively: D, then a
  dK/dV kernel (an item a kv tile of 128 keys, its walk its group's q
  heads x their q tiles, summed in registers), then a dQ kernel that
  recomputes S and dP.  Where the kv tiles are fewer than ``SMS``, their
  walks are laid end to end and wrapped over blocks of equal length
  (``dkdv_wrap``, ``wrap_walks``): a block walks its pieces in turn, and
  the pieces of a cut walk write fp32 partials that a fourth kernel sums
  in a fixed order.  hd 256 has kernels
  of its own: the dK/dV block's warpgroups take dV and dK (P^T handed
  across in shared memory: four products a kept score), the dQ block's a
  pair of units as the forward's, and both grids cut their walks into
  pieces where their items are fewer than ``SMS`` (``dkdv_split``,
  ``dq_split``), the partials summed by a fourth kernel.
* float32 at hd 64, 128 and 256: ``csrc/flash_attention_bwd_tf32x3.cu``
  (``"tf32x3"``), the same three kernels (and the sum where it splits)
  with their products on the tensor cores in error-compensated TF32 as the
  f32 forward's, each fp32 operand split into a hi and a lo part.  Its
  operands are read K-major only, so Q, dout (dK/dV) and K (dQ) are also
  copied transposed; the block's resident operand keeps its hi part in
  registers.  hd 256 has kernels of its own, and always the sum: each
  block walks two tiles over half of each walk.  K and V stay raw in shared
  memory (the tensor cores read a TF32 operand truncated, so the raw rows
  are its hi part) and are A operands split in registers a k-step at a
  time, the products transposed (dV^T = dout^T P, dK^T = Q^T dS, dQ^T =
  K^T dS^T) so that no transposed copy is needed.  It reads views whose
  rows are unit-stride and 16-byte aligned (others are copied first).
* hd 16 and 32 in both dtypes: ``csrc/flash_attention_bwd.cu``
  (``"mma"``), one kernel a call on the tensor cores through ``mma.sync``
  (bf16; f32 in 3xTF32): blocks of 16 keys (dK, dV) and of 16 q rows (dQ)
  in one grid, each block's 8 warps taking its steps in turn, register
  tiles FA2 style, D recomputed where it is needed, the warps' partials
  summed in a fixed order in shared memory.

None uses atomics: a gradient is bitwise the same from call to call.
``bwd_launches`` is the kernels a call launches; ``BWD_TILES[route][hd]``
the dK/dV kernel's (q rows, kv keys) tile, which
``flash_attention_bwd_plain`` walks on the CPU.  The JAX package has no
Pallas backward: it differentiates its attention with ``jax.grad``.

``flash_attention_plain`` beside them walks the same block schedule in
PyTorch (all q blocks at once, kv blocks in order, the same causal bound,
kv heads shared by their groups of q heads), so the CPU tests hold the
tiling math, unequal blocks included, against the oracle; the wrapper runs
it only for tensors on the CPU.  With ``split=True`` it, and
``flash_attention_bwd_plain``, walk the hd-256 kernels' pieces, partials
and fixed-order combines instead.

The wrappers check their inputs and pick the route, then call operators of
the ``repro_torch`` namespace (``torch.library``): ``flash_attention``
(``flash_attention_lse`` with each row's log-sum-exp) and
``flash_attention_bwd``.  The dispatcher runs each operator's CPU
implementation (the plain version) for CPU tensors, its CUDA one (the
launch) for card tensors, and its fake one (the outputs' shapes and dtypes)
for FakeTensors, so the dry-run's traces hold each call as one node, which
``torch.utils.flop_counter`` counts by the formulas registered here: 4 hd a
kept score forward, 10 hd backward (``kept_scores``).
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import heapq
import math
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from .. import _cuda

SOURCE = _cuda.CSRC_DIR / "flash_attention.cu"
LIB_NAME = "flash_attention"
WGMMA_SOURCE = _cuda.CSRC_DIR / "flash_attention_wgmma.cu"
WGMMA_LIB_NAME = "flash_attention_wgmma"
TF32X3_SOURCE = _cuda.CSRC_DIR / "flash_attention_tf32x3.cu"
TF32X3_LIB_NAME = "flash_attention_tf32x3"
BWD_SOURCE = _cuda.CSRC_DIR / "flash_attention_bwd.cu"
BWD_LIB_NAME = "flash_attention_bwd"
WGMMA_BWD_SOURCE = _cuda.CSRC_DIR / "flash_attention_bwd_wgmma.cu"
WGMMA_BWD_LIB_NAME = "flash_attention_bwd_wgmma"
TF32X3_BWD_SOURCE = _cuda.CSRC_DIR / "flash_attention_bwd_tf32x3.cu"
TF32X3_BWD_LIB_NAME = "flash_attention_bwd_tf32x3"
HEAD_DIMS = (16, 32, 64, 128, 256)   # the kernels' instantiations
MAX_BLOCK = 64          # CUDA-core kernel: most q rows / kv keys
# CUDA-core kernel: its default (block_q, block_k); 16-row q blocks put
# more blocks on the card than 64-row ones and were faster at the reduced
# configs' shapes (PERF.md)
CUDA_CORE_BLOCKS = (16, 64)
TF32X3_HEAD_DIMS = (64, 128, 256)
# the tf32x3 kernel's own (q rows, kv keys) tile by head dim
TF32X3_BLOCKS = {64: (64, 32), 128: (64, 32), 256: (64, 16)}
# tensor-core kernel: the (block_q, block_k) pairs it is built for, the
# default first (the faster on the card: at 128 keys ptxas spills P's
# registers); at hd 256 two stages of 128 keys would not fit beside Q
WGMMA_BLOCKS = {64: ((128, 64), (128, 128)),
                128: ((128, 64), (128, 128)),
                256: ((128, 64),)}
# the backward's dK/dV kernel's (q rows, kv keys) tile by route and head
# dim (``Cfg<HD>`` in flash_attention_bwd_wgmma.cu, ``BQ``/``BKV`` and, at
# hd 256, ``BQ256`` in flash_attention_bwd_tf32x3.cu, ``TILE`` in
# flash_attention_bwd.cu); the plain backward walks them on the CPU
BWD_TILES = {"wgmma": {64: (64, 128), 128: (64, 128), 256: (64, 64)},
             "tf32x3": {64: (32, 64), 128: (32, 64), 256: (16, 64)},
             "mma": {16: (16, 16), 32: (16, 16)}}
# kernels a backward call launches: the tensor-core routes D, dK and dV,
# dQ, and one that sums the partials of walks cut over several blocks
# (tf32x3: ``bwd_split`` > 1; bf16 at hd 64/128: ``dkdv_wrap``'s sums);
# "mma" one kernel that computes D where it needs it and sums its warps'
# partials itself
BWD_LAUNCHES = {"wgmma": 3, "tf32x3": 3, "mma": 1}
# the H100 SXM's SMs: a tf32x3 dK/dV grid of fewer blocks has each group's
# q heads split over more blocks, as far as the SMs and G allow; at bf16
# hd 256 a grid of fewer items has their walks cut into pieces until it
# fills this many blocks (``split_walks``); at bf16 hd 64/128 their walks
# are wrapped over at most this many blocks of equal length
# (``wrap_walks``)
SMS = 132
# ``wrap_walks``: no block walks fewer than MIN_BIN_STEPS steps, and the
# walks are cut only where the longest exceeds a block's length T by more
# than WRAP_FACTOR T + WRAP_SLACK (a cut costs its partials' bytes, a
# fourth kernel and a reload of K and V: Whisper's 48 walks of 7 steps
# stay whole)
MIN_BIN_STEPS, WRAP_FACTOR, WRAP_SLACK = 4, 1.25, 4
# bf16 at hd 256 (``split_route``): q rows of a consumer warpgroup's unit,
# keys of a forward and a dK/dV tile, keys of a dQ step
UNIT_ROWS, SPLIT_BK, SPLIT_BK_DQ = 64, 64, 32
NEG_INF = -1e30
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}
_BWD_ENTRY = {torch.float32: "flash_attention_bwd_f32",
              torch.bfloat16: "flash_attention_bwd_bf16"}

# launches per kernel and input dtype ("wgmma/bfloat16", "tf32x3/float32",
# "cuda_cores/float32", "cuda_cores/bfloat16"; the backward's kernels as
# "bwd/<dtype>", ``bwd_launches`` a call), counted at the launch
LAUNCHES: collections.Counter = collections.Counter()


def route(dtype: torch.dtype, hd: int) -> str:
    """Which kernel runs a call: ``"wgmma"`` (bf16 at hd 64-256),
    ``"tf32x3"`` (f32 at hd 64-256) or ``"cuda_cores"`` (hd 16, 32)."""
    if dtype == torch.float32:
        return "tf32x3" if hd in TF32X3_HEAD_DIMS else "cuda_cores"
    return "wgmma" if hd in WGMMA_BLOCKS else "cuda_cores"


def bwd_route(dtype: torch.dtype, hd: int) -> str:
    """Which backward runs a call: ``"wgmma"`` (bf16 at hd 64-256),
    ``"tf32x3"`` (float32 at hd 64-256) or ``"mma"`` (hd 16 and 32, both
    dtypes)."""
    kind = {torch.bfloat16: "wgmma", torch.float32: "tf32x3"}.get(dtype)
    return kind if kind is not None and hd in BWD_TILES[kind] else "mma"


def bwd_split(B: int, H: int, Hkv: int, Sk: int, hd: int,
              kind: str = "tf32x3") -> int:
    """Blocks over which the tf32x3 dK/dV kernel splits each group's H /
    Hkv q heads: the most that divides the group and keeps its grid within
    ``SMS`` blocks (1: no split).  (bf16 wraps its walks instead:
    ``dkdv_wrap``.)"""
    G = H // Hkv
    blocks = B * Hkv * -(-Sk // BWD_TILES[kind][hd][1])
    return max(s for s in range(1, G + 1)
               if G % s == 0 and (s == 1 or blocks * s <= SMS))


def bwd_launches(dtype: torch.dtype, hd: int, B: int, H: int, Hkv: int,
                 Sk: int, S: Optional[int] = None,
                 causal: bool = True) -> int:
    """Kernels one backward call launches on the card (``S`` defaults to
    ``Sk``): on the bf16 route D, dK/dV, dQ and, where a schedule cut a
    walk (hd 64/128: ``dkdv_wrap``; hd 256: ``dkdv_split``, ``dq_split``),
    the sum of the partials."""
    S = Sk if S is None else S
    if split_route(dtype, hd):
        return 3 + bool(dkdv_split(B, H, Hkv, S, Sk, causal).sums
                        or dq_split(B, H, Hkv, S, Sk, causal).sums)
    kind = bwd_route(dtype, hd)
    if kind == "wgmma":
        return 3 + bool(dkdv_wrap(B, H, Hkv, S, Sk, causal).sums)
    return BWD_LAUNCHES[kind] + _bwd_sums(kind, hd,
                                          bwd_split(B, H, Hkv, Sk, hd, kind))


def fwd_launches(dtype: torch.dtype, hd: int, B: int, H: int, Hkv: int,
                 S: int, Sk: Optional[int] = None,
                 causal: bool = True) -> int:
    """Kernels one forward call launches on the card (``Sk`` defaults to
    ``S``): 1, and at bf16 hd 256 a second that combines the pieces of the
    walks it split."""
    if split_route(dtype, hd):
        Sk = S if Sk is None else Sk
        return 1 + bool(fwd_split(B, H, Hkv, S, Sk, causal).sums)
    return 1


# ---------------------------------------------------------------------------
# bf16 at hd 256: items' walks cut into pieces, one block each
# ---------------------------------------------------------------------------


def split_route(dtype: torch.dtype, hd: int) -> bool:
    """Whether a call takes the hd-256 tensor-core kernels, whose grids
    are pieces of walks (``fwd_split``, ``dkdv_split``, ``dq_split``)."""
    return dtype == torch.bfloat16 and hd == 256


@dataclasses.dataclass(frozen=True)
class Split:
    """Items' walks (tiles or steps each) cut into pieces for the blocks.

    ``pieces``: (item, start, stop, slot) in launch order (``split_walks``:
    longest first; ``wrap_walks``: block by block);
    slot -1 where the piece is its item's whole walk, else the fp32
    partial it writes (an item's pieces take consecutive slots in walk
    order).  Empty when there are at least ``SMS`` items: one block an item
    over its whole walk.  ``sums``: (item, first slot, pieces) of each item
    whose walk was cut, which a second kernel sums in slot order.
    ``offsets`` (``wrap_walks``): block x walks pieces offsets[x] ..
    offsets[x + 1] - 1 in turn; empty: a block a piece."""
    walks: tuple
    pieces: tuple
    sums: tuple
    offsets: tuple = ()

    @property
    def slots(self) -> int:
        return sum(n for _, _, n in self.sums)

    @property
    def blocks(self) -> int:
        if self.offsets:
            return len(self.offsets) - 1
        return len(self.pieces) or len(self.walks)

    def block_steps(self) -> list:
        """Each block's steps: its pieces' lengths summed (no pieces: each
        item's walk)."""
        if not self.pieces:
            return list(self.walks)
        ends = self.offsets or range(len(self.pieces) + 1)
        return [sum(e - a for _, a, e, _ in self.pieces[x:y])
                for x, y in zip(ends, ends[1:])]

    def by_item(self) -> list:
        """Each item's (start, stop) pieces in walk order."""
        out = [[(0, w)] for w in self.walks]
        for it, _, n in self.sums:
            out[it] = []
        for it, a, b, slot in sorted(self.pieces, key=lambda p: (p[0], p[1])):
            if slot >= 0:
                out[it].append((a, b))
        return out

    @functools.cached_property
    def c_tables(self):
        """(pieces, sums) as flat C int arrays for the kernels' entries."""
        pieces = [x for p in self.pieces for x in p]
        sums = [x for s in self.sums for x in s]
        return ((ctypes.c_int * max(1, len(pieces)))(*pieces),
                (ctypes.c_int * max(1, len(sums)))(*sums))

    @functools.cached_property
    def c_offsets(self):
        """``offsets`` as a flat C int array."""
        return (ctypes.c_int * max(1, len(self.offsets)))(*self.offsets)


def split_walks(walks: tuple, sms: int = SMS) -> Split:
    """Cut items' walks into pieces until there are ``sms`` of them or
    every piece is one tile: each round cuts the item whose largest piece
    is the longest (the first on ties) into one more piece; an item of n
    pieces over w tiles cuts at k w // n.  ``sms`` items or more: no cut."""
    if len(walks) >= sms:
        return Split(tuple(walks), (), ())
    n = [1] * len(walks)
    heap = [(-w, i) for i, w in enumerate(walks)]
    heapq.heapify(heap)
    for _ in range(sms - len(walks)):
        neg, i = heap[0]
        if -neg <= 1:
            break
        n[i] += 1
        heapq.heapreplace(heap, (-walks[i] // n[i], i))
    pieces, sums, slot = [], [], 0
    for i, (w, c) in enumerate(zip(walks, n)):
        if c > 1:
            sums.append((i, slot, c))
        for k in range(c):
            pieces.append((i, k * w // c, (k + 1) * w // c,
                           slot + k if c > 1 else -1))
        slot += c if c > 1 else 0
    pieces.sort(key=lambda p: (p[1] - p[2], p[0], p[1]))
    return Split(tuple(walks), tuple(pieces), tuple(sums))


def wrap_walks(walks: tuple, sms: int = SMS) -> Split:
    """McNaughton's wrap-around rule: the items' walks laid end to end in
    item order and cut into blocks of T = max(ceil(total / sms),
    ``MIN_BIN_STEPS``) steps, so that no block walks more than T steps and
    a cut walk's pieces lie in consecutive blocks (a walk of no steps joins
    the block where it falls).  ``pieces`` in block order; an item's pieces
    take consecutive slots in walk order.  No cut (one block an item,
    ``pieces`` empty) where there are ``sms`` items or more, where the
    longest walk is within ``WRAP_FACTOR`` T + ``WRAP_SLACK`` steps, or
    where a walk does not fit the kernel's 16-bit table."""
    total, longest = sum(walks), max(walks, default=0)
    T = max(-(-total // sms), MIN_BIN_STEPS)
    if (len(walks) >= sms or longest <= WRAP_FACTOR * T + WRAP_SLACK
            or longest >= 1 << 16):
        return Split(tuple(walks), (), ())
    raw, offsets, fill = [], [0], 0
    for i, w in enumerate(walks):
        a = 0
        while True:
            if fill == T and a < w:
                offsets.append(len(raw))
                fill = 0
            b = min(w, a + T - fill)
            raw.append((i, a, b))
            fill, a = fill + b - a, b
            if a >= w:
                break
    offsets.append(len(raw))
    count = collections.Counter(i for i, _, _ in raw)
    first, sums, slot = {}, [], 0
    for i in sorted(count):
        if count[i] > 1:
            sums.append((i, slot, count[i]))
            first[i] = slot
            slot += count[i]
    pieces, seen = [], collections.Counter()
    for i, a, b in raw:
        pieces.append((i, a, b, first[i] + seen[i] if i in first else -1))
        seen[i] += 1
    return Split(tuple(walks), tuple(pieces), tuple(sums), tuple(offsets))


@functools.lru_cache(maxsize=256)
def dkdv_wrap(B: int, H: int, Hkv: int, S: int, Sk: int,
              causal: bool) -> Split:
    """The bf16 hd-64/128 dK/dV kernel's schedule: items are kv tiles of
    128 keys (item x = (b Hkv + hk) nk + t), each walking G q heads x its
    q tiles of 64 rows from the one that holds its first key (step g per +
    qt - first), wrapped over blocks of equal length (``wrap_walks``).
    Uncut, block x takes item (x % (B Hkv)) nk + x // (B Hkv): tile-major,
    the longest causal walks first."""
    bq, bk = BWD_TILES["wgmma"][64]
    G, nq, nk = H // Hkv, -(-S // bq), -(-Sk // bk)
    walks = [G * (nq - (min(t * bk // bq, nq) if causal else 0))
             for t in range(nk)]
    return wrap_walks(tuple(walks) * (B * Hkv))


def unit_walk(p: int, S: int, Sk: int, causal: bool, bk: int) -> int:
    """Tiles of ``bk`` keys that q rows [64 p, 64 p + 64) walk: all of
    them, or (causal) up to the one that holds the unit's last row."""
    nk = -(-Sk // bk)
    if not causal:
        return nk
    return min(nk, (min(UNIT_ROWS * (p + 1), S) - 1) // bk + 1)


def pair_units(H: int, Hkv: int, S: int) -> tuple[int, int]:
    """(units, pairs) of each (batch, kv head): its G q heads' rows in
    units of 64, unit u = p G + g holding rows [64 p, 64 p + 64) of head g
    of the group, and a block's two warpgroups taking units 2 i and 2 i + 1
    (the second absent where the count is odd)."""
    U = -(-S // UNIT_ROWS) * (H // Hkv)
    return U, -(-U // 2)


def _pair_walks(B, H, Hkv, S, Sk, causal, bk) -> tuple:
    G = H // Hkv
    U, npair = pair_units(H, Hkv, S)
    walks = []
    for i in range(npair):
        w = unit_walk(2 * i // G, S, Sk, causal, bk)
        if 2 * i + 1 < U:
            w = max(w, unit_walk((2 * i + 1) // G, S, Sk, causal, bk))
        walks.append(w)
    return tuple(walks) * (B * Hkv)


@functools.lru_cache(maxsize=256)
def fwd_split(B: int, H: int, Hkv: int, S: int, Sk: int,
              causal: bool) -> Split:
    """The hd-256 forward's pieces: items are pairs of units (item x =
    (b Hkv + hk) pairs + i), each walking its units' tiles of 64 keys."""
    return split_walks(_pair_walks(B, H, Hkv, S, Sk, causal, SPLIT_BK))


@functools.lru_cache(maxsize=256)
def dkdv_split(B: int, H: int, Hkv: int, S: int, Sk: int,
               causal: bool) -> Split:
    """The hd-256 dK/dV kernel's pieces: items are kv tiles of 64 keys
    (item x = (b Hkv + hk) nk + t), each walking G q heads x its q tiles of
    64 rows (step g per + qt - first)."""
    G, nq, nk = H // Hkv, -(-S // UNIT_ROWS), -(-Sk // SPLIT_BK)
    walks = [G * (nq - (min(t, nq) if causal else 0)) for t in range(nk)]
    return split_walks(tuple(walks) * (B * Hkv))


@functools.lru_cache(maxsize=256)
def dq_split(B: int, H: int, Hkv: int, S: int, Sk: int,
             causal: bool) -> Split:
    """The hd-256 dQ kernel's pieces: items are pairs of units, as the
    forward's, each walking its units' steps of 32 keys."""
    return split_walks(_pair_walks(B, H, Hkv, S, Sk, causal, SPLIT_BK_DQ))


def _bwd_sums(kind: str, hd: int, split: int) -> bool:
    """Whether a tf32x3 or mma backward launches a sum kernel: where the
    tf32x3 one splits each group's q heads, and always at f32 hd 256, whose
    dK/dV and dQ kernels each walk halves of their causal walks
    (``_bwd_part_floats``)."""
    return kind == "tf32x3" and (split > 1 or hd == 256)


def _bwd_part_floats(kind: str, hd: int, split: int, B: int, H: int,
                     Hkv: int, S: int, Sk: int) -> int:
    """fp32 scratch for the partials the tf32x3 sum kernel adds: dK's and
    dV's of ``split`` parts of each group's q heads; at hd 256 two parts of
    each (the q halves) and then dQ's two (the kv halves)."""
    if hd == 256:
        return 2 * 2 * split * B * Hkv * Sk * hd + 2 * B * H * S * hd
    return 2 * split * B * Hkv * Sk * hd if split > 1 else 0


@functools.lru_cache(maxsize=None)
def kernel_source() -> str:
    return SOURCE.read_text()


@functools.lru_cache(maxsize=None)
def wgmma_kernel_source() -> str:
    return WGMMA_SOURCE.read_text()


@functools.lru_cache(maxsize=None)
def tf32x3_kernel_source() -> str:
    return TF32X3_SOURCE.read_text()


@functools.lru_cache(maxsize=None)
def bwd_kernel_source() -> str:
    return BWD_SOURCE.read_text()


@functools.lru_cache(maxsize=None)
def wgmma_bwd_kernel_source() -> str:
    return WGMMA_BWD_SOURCE.read_text()


@functools.lru_cache(maxsize=None)
def tf32x3_bwd_kernel_source() -> str:
    return TF32X3_BWD_SOURCE.read_text()


def kernel_sources() -> dict[str, str]:
    """Every kernel's ``name -> source``, for ``_cuda.build_many``."""
    return {LIB_NAME: kernel_source(), WGMMA_LIB_NAME: wgmma_kernel_source(),
            TF32X3_LIB_NAME: tf32x3_kernel_source(),
            BWD_LIB_NAME: bwd_kernel_source(),
            WGMMA_BWD_LIB_NAME: wgmma_bwd_kernel_source(),
            TF32X3_BWD_LIB_NAME: tf32x3_bwd_kernel_source()}


@functools.lru_cache(maxsize=None)
def _launcher(dtype: torch.dtype):
    lib = _cuda.load(LIB_NAME, kernel_source())
    return lib, _cuda.entry(lib, _ENTRY[dtype], [ctypes.c_void_p] * 5
                            + [ctypes.c_int] * 9 + [ctypes.c_float]
                            + [ctypes.c_void_p] * 2)


@functools.lru_cache(maxsize=None)
def _wgmma_launcher():
    lib = _cuda.load(WGMMA_LIB_NAME, wgmma_kernel_source())
    return lib, _cuda.entry(lib, "flash_attention_wgmma_bf16",
                            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                            + [ctypes.c_float] + [ctypes.c_void_p] * 2)


@functools.lru_cache(maxsize=None)
def _wgmma_hd256_launcher():
    lib = _cuda.load(WGMMA_LIB_NAME, wgmma_kernel_source())
    return lib, _cuda.entry(lib, "flash_attention_wgmma_hd256",
                            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                            + [ctypes.c_float]
                            + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _tf32x3_launcher():
    lib = _cuda.load(TF32X3_LIB_NAME, tf32x3_kernel_source())
    return lib, _cuda.entry(lib, "flash_attention_tf32x3",
                            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                            + [ctypes.c_float] + [ctypes.c_void_p] * 2)


@functools.lru_cache(maxsize=None)
def _bwd_launcher(dtype: torch.dtype):
    lib = _cuda.load(BWD_LIB_NAME, bwd_kernel_source())
    return lib, _cuda.entry(lib, _BWD_ENTRY[dtype], [ctypes.c_void_p] * 9
                            + [ctypes.c_int] * 7 + [ctypes.c_float]
                            + [ctypes.c_void_p] * 2)


@functools.lru_cache(maxsize=None)
def _wgmma_bwd_launcher():
    lib = _cuda.load(WGMMA_BWD_LIB_NAME, wgmma_bwd_kernel_source())
    return lib, _cuda.entry(lib, "flash_attention_bwd_wgmma_bf16",
                            [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
                            + [ctypes.c_float]
                            + [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _wgmma_bwd_hd256_launcher():
    lib = _cuda.load(WGMMA_BWD_LIB_NAME, wgmma_bwd_kernel_source())
    return lib, _cuda.entry(lib, "flash_attention_bwd_wgmma_hd256",
                            [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6
                            + [ctypes.c_float]
                            + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                               ctypes.c_int, ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _tf32x3_bwd_launcher():
    lib = _cuda.load(TF32X3_BWD_LIB_NAME, tf32x3_bwd_kernel_source())
    return lib, _cuda.entry(lib, "flash_attention_bwd_tf32x3",
                            [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8
                            + [ctypes.c_float] + [ctypes.c_void_p] * 2)


def kv_blocks(S: int, Sk: int, block_q: int, block_k: int,
              causal: bool) -> list[int]:
    """kv blocks each q block walks: all of them, or (causal) up to the
    one that holds the q block's last row."""
    nq, nk = -(-S // block_q), -(-Sk // block_k)
    if not causal:
        return [nk] * nq
    return [min(nk, (min((qi + 1) * block_q, S) - 1) // block_k + 1)
            for qi in range(nq)]


def flash_attention_plain(q, k, v, *, causal: bool, block_q: int,
                          block_k: int, return_lse: bool = False,
                          split: bool = False):
    """The plain PyTorch version: the kernels' block schedule with online
    softmax in fp32, every q block at once, kv blocks in order; a q block
    takes a kv block's update only while it is within its causal bound.
    k and v may have fewer heads than q; q head h reads kv head
    h // (H / Hkv).  ``return_lse`` also returns each row's log-sum-exp of
    the scaled scores, (B, H, S) fp32, as the kernels write it for the
    backward.  ``split`` walks the hd-256 kernel's schedule instead
    (``fwd_split``; the blocks must be ``WGMMA_BLOCKS[256][0]``)."""
    if split:
        if (block_q, block_k) != WGMMA_BLOCKS[256][0]:
            raise ValueError(f"flash_attention_plain: the split schedule "
                             f"walks {WGMMA_BLOCKS[256][0]} blocks")
        return _split_plain(q, k, v, causal, return_lse)
    B, H, S, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = H // Hkv
    nq, nk = -(-S // block_q), -(-Sk // block_k)
    dev = q.device
    qf = torch.zeros((B, H, nq * block_q, hd), dtype=torch.float32,
                     device=dev)
    qf[:, :, :S] = q.float() * hd ** -0.5
    qf = qf.view(B, Hkv, G, nq, block_q, hd)
    kf = torch.zeros((B, Hkv, nk * block_k, hd), dtype=torch.float32,
                     device=dev)
    vf = torch.zeros_like(kf)
    kf[:, :, :Sk], vf[:, :, :Sk] = k.float(), v.float()
    qpos = torch.arange(nq * block_q, device=dev).view(nq, block_q, 1)
    walks = torch.tensor(kv_blocks(S, Sk, block_q, block_k, causal),
                         device=dev)
    acc = torch.zeros((B, Hkv, G, nq, block_q, hd), dtype=torch.float32,
                      device=dev)
    m = torch.full((B, Hkv, G, nq, block_q), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros_like(m)
    for j in range(nk):
        kb = kf[:, :, j * block_k:(j + 1) * block_k]
        vb = vf[:, :, j * block_k:(j + 1) * block_k]
        s = torch.einsum("bgrnqd,bgkd->bgrnqk", qf, kb)
        kpos = j * block_k + torch.arange(block_k, device=dev)
        ok = kpos < Sk
        if causal:
            ok = ok & (qpos >= kpos)
        s = torch.where(ok, s, NEG_INF)
        m1 = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m1[..., None])
        alpha = torch.exp(m - m1)
        l1 = l * alpha + p.sum(dim=-1)
        acc1 = acc * alpha[..., None] + torch.einsum("bgrnqk,bgkd->bgrnqd",
                                                     p, vb)
        on = (j < walks).view(nq, 1)
        acc = torch.where(on[..., None], acc1, acc)
        m, l = torch.where(on, m1, m), torch.where(on, l1, l)
    out = acc / (l[..., None] + 1e-30)
    out = out.reshape(B, H, nq * block_q, hd)[:, :, :S].to(q.dtype)
    if not return_lse:
        return out
    return out, (m + torch.log(l)).reshape(B, H, nq * block_q)[:, :, :S]


def _to_units(t, Hkv: int, fill: float = 0.0):
    """(B, H, S, ...) -> fp32 (B Hkv, U, 64, ...): each (batch, kv head)'s
    units, unit u = p G + g holding rows [64 p, 64 p + 64) of its head g;
    rows past S are ``fill``."""
    B, H, S = t.shape[:3]
    G, NP = H // Hkv, -(-S // UNIT_ROWS)
    pad = torch.full((B, H, NP * UNIT_ROWS) + t.shape[3:], fill,
                     dtype=torch.float32, device=t.device)
    pad[:, :, :S] = t.float()
    pad = pad.view((B, Hkv, G, NP, UNIT_ROWS) + t.shape[3:]).transpose(2, 3)
    return pad.reshape((B * Hkv, NP * G, UNIT_ROWS) + t.shape[3:])


def _from_units(t, B: int, H: int, S: int):
    """``_to_units``' inverse: (B Hkv, U, 64, ...) -> (B, H, S, ...)."""
    X, U = t.shape[:2]
    Hkv = X // B
    G = H // Hkv
    t = t.reshape((B, Hkv, U // G, G, UNIT_ROWS) + t.shape[3:])
    t = t.transpose(2, 3).reshape((B, H, U // G * UNIT_ROWS) + t.shape[5:])
    return t[:, :, :S]


def _piece_of(sp: Split, X: int, U: int, unit_walks, nk: int, dev):
    """(X, U, nk) int: which piece of its pair's (0, 1, ...) holds each
    unit's tile, -1 past the unit's own walk or where no piece takes it."""
    npair = -(-U // 2)
    out = torch.full((X, U, nk), -1, dtype=torch.long)
    for x, pieces in enumerate(sp.by_item()):
        bhk, i = divmod(x, npair)
        for u in (2 * i, 2 * i + 1):
            if u >= U:
                continue
            for kk, (a, b) in enumerate(pieces):
                out[bhk, u, a:min(b, unit_walks[u])] = kk
    return out.to(dev)


def _split_plain(q, k, v, causal: bool, return_lse: bool):
    """``flash_attention_plain`` on the hd-256 kernel's schedule: each
    unit's walk cut as its pair's (``fwd_split``), each piece's online
    softmax (m, l and the unnormalised output) from its first tile, then
    the pieces combined in walk order: M = max m, w = exp(m - M), out =
    sum(w acc) / (sum(w l) + 1e-30), lse = M + log(sum(w l))."""
    B, H, S, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G, nk, dev = H // Hkv, -(-Sk // SPLIT_BK), q.device
    sp = fwd_split(B, H, Hkv, S, Sk, causal)
    qu = _to_units(q, Hkv) * hd ** -0.5
    X, U = qu.shape[:2]
    walks = [unit_walk(u // G, S, Sk, causal, SPLIT_BK) for u in range(U)]
    owner = _piece_of(sp, X, U, walks, nk, dev)
    P = max(len(p) for p in sp.by_item())
    kf = torch.zeros((B * Hkv, nk * SPLIT_BK, hd), dtype=torch.float32,
                     device=dev)
    vf = torch.zeros_like(kf)
    kf[:, :Sk] = k.float().reshape(B * Hkv, Sk, hd)
    vf[:, :Sk] = v.float().reshape(B * Hkv, Sk, hd)
    qpos = (torch.arange(U, device=dev) // G * UNIT_ROWS)[:, None] \
        + torch.arange(UNIT_ROWS, device=dev)
    # each piece index's running (m, l, unnormalised output), per unit
    acc = [torch.zeros((X, U, UNIT_ROWS, hd), dtype=torch.float32,
                       device=dev) for _ in range(P)]
    m = [torch.full((X, U, UNIT_ROWS), NEG_INF, dtype=torch.float32,
                    device=dev) for _ in range(P)]
    l = [torch.zeros_like(m[0]) for _ in range(P)]
    for j in range(nk):
        cut = slice(j * SPLIT_BK, (j + 1) * SPLIT_BK)
        s = torch.einsum("xurd,xkd->xurk", qu, kf[:, cut])
        kpos = j * SPLIT_BK + torch.arange(SPLIT_BK, device=dev)
        ok = (kpos < Sk) & ((qpos[..., None] >= kpos) if causal else True)
        s = torch.where(ok, s, NEG_INF)
        for kk in range(P):
            on = (owner[:, :, j] == kk)[..., None]
            if not on.any():
                continue
            m1 = torch.maximum(m[kk], s.amax(dim=-1))
            p = torch.exp(s - m1[..., None])
            alpha = torch.exp(m[kk] - m1)
            l[kk] = torch.where(on, l[kk] * alpha + p.sum(dim=-1), l[kk])
            acc[kk] = torch.where(
                on[..., None], acc[kk] * alpha[..., None]
                + torch.einsum("xurk,xkd->xurd", p, vf[:, cut]), acc[kk])
            m[kk] = torch.where(on, m1, m[kk])
    M = torch.stack(m).amax(dim=0)
    num = torch.zeros((X, U, UNIT_ROWS, hd), dtype=torch.float32, device=dev)
    den = torch.zeros((X, U, UNIT_ROWS), dtype=torch.float32, device=dev)
    for kk in range(P):
        w = torch.exp(m[kk] - M)
        den = den + l[kk] * w
        num = num + acc[kk] * w[..., None]
    out = _from_units(num / (den[..., None] + 1e-30), B, H, S).to(q.dtype)
    if not return_lse:
        return out
    return out, _from_units(M + torch.log(den), B, H, S)


def flash_attention_bwd_plain(q, k, v, out, lse, dout, *, causal: bool,
                              block_q: int, block_k: int,
                              split: bool = False):
    """The backward kernel's plain PyTorch version, on its block schedule:
    D = rowsum(dout * out); then kv blocks in order, every q block at once,
    each q block taking a kv block only within its causal bound: P =
    exp(s * scale - lse) (0 where masked), dV_j = P^T dout and dK_j = scale
    dS^T q summed over q blocks and the G q heads of each kv head, dQ +=
    scale dS k_j, with dS = P (dout v^T - D); fp32 throughout, each
    gradient returned in its input's dtype.  ``lse`` is (B, H, S) fp32,
    the forward's row log-sum-exp of the scaled scores.  Returns (dq, dk,
    dv) shaped as q, k, v.  ``split`` walks the bf16 kernels' schedules
    instead, at hd 256 ``dkdv_split`` and ``dq_split``, at hd 64 and 128
    ``dkdv_wrap`` (the tiles must be ``BWD_TILES["wgmma"][hd]``)."""
    if split:
        hd = q.shape[3]
        if (block_q, block_k) != BWD_TILES["wgmma"].get(hd):
            raise ValueError(f"flash_attention_bwd_plain: the split "
                             f"schedules walk {BWD_TILES['wgmma']} tiles "
                             "by head dim")
        if hd == 256:
            return _split_bwd_plain(q, k, v, out, lse, dout, causal)
        return _wrap_bwd_plain(q, k, v, out, lse, dout, causal)
    B, H, S, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = H // Hkv
    nq, nk = -(-S // block_q), -(-Sk // block_k)
    dev = q.device
    scale = torch.tensor(hd ** -0.5, dtype=torch.float32).item()

    def rows(t):            # (B, H, S, ...) -> (B, Hkv, G, nq, block_q, ...)
        pad = torch.zeros((B, H, nq * block_q) + t.shape[3:],
                          dtype=torch.float32, device=dev)
        pad[:, :, :S] = t.float()
        return pad.view((B, Hkv, G, nq, block_q) + t.shape[3:])

    qf, of, gf = rows(q), rows(out), rows(dout)
    lsef = rows(lse)
    D = (gf * of).sum(dim=-1)
    kf = torch.zeros((B, Hkv, nk * block_k, hd), dtype=torch.float32,
                     device=dev)
    vf = torch.zeros_like(kf)
    kf[:, :, :Sk], vf[:, :, :Sk] = k.float(), v.float()
    qpos = torch.arange(nq * block_q, device=dev).view(nq, block_q, 1)
    walks = torch.tensor(kv_blocks(S, Sk, block_q, block_k, causal),
                         device=dev).view(nq, 1, 1)
    dq = torch.zeros_like(qf)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(kf)
    for j in range(nk):
        cut = slice(j * block_k, (j + 1) * block_k)
        kb, vb = kf[:, :, cut], vf[:, :, cut]
        s = torch.einsum("bgrnqd,bgkd->bgrnqk", qf, kb)
        kpos = j * block_k + torch.arange(block_k, device=dev)
        ok = (kpos < Sk) & (qpos < S) & (j < walks)
        if causal:
            ok = ok & (qpos >= kpos)
        p = torch.where(ok, torch.exp(s * scale - lsef[..., None]), 0.0)
        dp = torch.einsum("bgrnqd,bgkd->bgrnqk", gf, vb)
        ds = p * (dp - D[..., None])
        dv[:, :, cut] = torch.einsum("bgrnqk,bgrnqd->bgkd", p, gf)
        dk[:, :, cut] = torch.einsum("bgrnqk,bgrnqd->bgkd", ds, qf) * scale
        dq = dq + torch.einsum("bgrnqk,bgkd->bgrnqd", ds, kb)
    dq = (dq * scale).reshape(B, H, nq * block_q, hd)[:, :, :S]
    return (dq.to(q.dtype), dk[:, :, :Sk].to(k.dtype),
            dv[:, :, :Sk].to(v.dtype))


def _split_bwd_plain(q, k, v, out, lse, dout, causal: bool):
    """``flash_attention_bwd_plain`` on the hd-256 kernels' schedules.
    dK, dV: each kv tile's steps (its G q heads x its q tiles of 64 rows,
    ``dkdv_split``) summed piece by piece, in step order, then the pieces
    in walk order.  dQ: each unit's steps of 32 keys cut as its pair's
    (``dq_split``), each piece summed in step order, then the pieces in
    walk order.  P = exp(s scale - lse) (0 where masked and past S), dS =
    P (dout v^T - D), D = rowsum(dout out)."""
    B, H, S, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G, dev = H // Hkv, q.device
    X = B * Hkv
    scale = torch.tensor(hd ** -0.5, dtype=torch.float32).item()
    nq, nk, nkq = (-(-S // UNIT_ROWS), -(-Sk // SPLIT_BK),
                   -(-Sk // SPLIT_BK_DQ))
    D = (dout.float() * out.float()).sum(dim=-1)
    qu, gu = _to_units(q, Hkv), _to_units(dout, Hkv)
    lu = _to_units(lse, Hkv, math.inf)
    du = _to_units(D, Hkv)
    U = qu.shape[1]
    keys = max(nk * SPLIT_BK, nkq * SPLIT_BK_DQ)
    kf = torch.zeros((X, keys, hd), dtype=torch.float32, device=dev)
    vf = torch.zeros_like(kf)
    kf[:, :Sk] = k.float().reshape(X, Sk, hd)
    vf[:, :Sk] = v.float().reshape(X, Sk, hd)
    qpos = (torch.arange(U, device=dev) // G * UNIT_ROWS)[:, None] \
        + torch.arange(UNIT_ROWS, device=dev)

    def probs(x, u, key0: int, n: int):
        """P and dS of units ``u`` of (b, kv head) x against keys
        [key0, key0 + n): (..., 64 rows, n keys)."""
        kb, vb = kf[x, key0:key0 + n], vf[x, key0:key0 + n]
        kpos = key0 + torch.arange(n, device=dev)
        ok = kpos < Sk
        if causal:
            ok = ok & (qpos[u][..., None] >= kpos)
        s = torch.einsum("...rd,...kd->...rk", qu[x, u], kb)
        p = torch.where(ok, torch.exp(s * scale - lu[x, u][..., None]), 0.0)
        dp = torch.einsum("...rd,...kd->...rk", gu[x, u], vb)
        return p, p * (dp - du[x, u][..., None])

    # dK and dV: unit g of q tile qt is u = qt G + g; step g per + qt - first
    dk = torch.zeros((X, nk * SPLIT_BK, hd), dtype=torch.float32, device=dev)
    dv = torch.zeros_like(dk)
    for it, pieces in enumerate(dkdv_split(B, H, Hkv, S, Sk,
                                           causal).by_item()):
        x, t = divmod(it, nk)
        first = min(t, nq) if causal else 0
        per = nq - first
        if per == 0:
            continue
        u = (torch.arange(first, nq, device=dev)[None, :] * G
             + torch.arange(G, device=dev)[:, None]).reshape(-1)
        p, ds = probs(x, u, t * SPLIT_BK, SPLIT_BK)
        cdv = torch.einsum("srk,srd->skd", p, gu[x, u])
        cdk = torch.einsum("srk,srd->skd", ds, qu[x, u])
        cut = slice(t * SPLIT_BK, (t + 1) * SPLIT_BK)
        for a, b in pieces:
            dv[x, cut] += cdv[a:b].sum(dim=0)
            dk[x, cut] += cdk[a:b].sum(dim=0)
    # dQ: every unit at once, step by step, into its piece's partial
    sp = dq_split(B, H, Hkv, S, Sk, causal)
    walks = [unit_walk(u // G, S, Sk, causal, SPLIT_BK_DQ) for u in range(U)]
    owner = _piece_of(sp, X, U, walks, nkq, dev)
    P = max(len(p) for p in sp.by_item())
    acc = torch.zeros((X, U, P, UNIT_ROWS, hd), dtype=torch.float32,
                      device=dev)
    xs = torch.arange(X, device=dev)[:, None]
    us = torch.arange(U, device=dev)[None, :]
    for j in range(nkq):
        _, ds = probs(xs, us, j * SPLIT_BK_DQ, SPLIT_BK_DQ)
        kb = kf[:, j * SPLIT_BK_DQ:(j + 1) * SPLIT_BK_DQ]
        c = torch.einsum("xurk,xkd->xurd", ds, kb)
        for kk in range(P):
            on = (owner[:, :, j] == kk)[..., None, None]
            acc[:, :, kk] += torch.where(on, c, 0.0)
    dq = torch.zeros((X, U, UNIT_ROWS, hd), dtype=torch.float32, device=dev)
    for kk in range(P):
        dq = dq + acc[:, :, kk]
    dq = _from_units(dq * scale, B, H, S)
    dk, dv = (t[:, :Sk].reshape(B, Hkv, Sk, hd) for t in (dk * scale, dv))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _wrap_bwd_plain(q, k, v, out, lse, dout, causal: bool):
    """``flash_attention_bwd_plain`` on the bf16 hd-64/128 kernels'
    schedule.  dK, dV: each kv tile's steps (its G q heads x its q tiles of
    64 rows, ``dkdv_wrap``) summed piece by piece in step order, then the
    pieces in slot order.  dQ: each q tile of 64 rows summed over kv tiles
    of 64 keys in order (the dQ kernel's steps).  P = exp(s scale - lse)
    (0 where masked and past S), dS = P (dout v^T - D), D = rowsum(dout
    out)."""
    B, H, S, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G, dev = H // Hkv, q.device
    bq, bk = BWD_TILES["wgmma"][hd]
    nq, nk = -(-S // bq), -(-Sk // bk)
    scale = torch.tensor(hd ** -0.5, dtype=torch.float32).item()

    def rows(t, fill=0.0):  # (B, H, S, ...) -> (B, Hkv, G, nq, bq, ...)
        pad = torch.full((B, H, nq * bq) + t.shape[3:], fill,
                         dtype=torch.float32, device=dev)
        pad[:, :, :S] = t.float()
        return pad.view((B, Hkv, G, nq, bq) + t.shape[3:])

    qf, gf = rows(q), rows(dout)
    D = (gf * rows(out)).sum(dim=-1)
    lsef = rows(lse, math.inf)
    kf = torch.zeros((B, Hkv, nk * bk, hd), dtype=torch.float32, device=dev)
    vf = torch.zeros_like(kf)
    kf[:, :, :Sk], vf[:, :, :Sk] = k.float(), v.float()
    qpos = torch.arange(nq * bq, device=dev).view(nq, bq, 1)
    dq = torch.zeros_like(qf)
    # each kv tile's per-step dK and dV: (B, Hkv, G, nq, bk, hd)
    cdk, cdv = [], []
    for j in range(nk):
        cut = slice(j * bk, (j + 1) * bk)
        kpos = j * bk + torch.arange(bk, device=dev)
        ok = kpos < Sk
        if causal:
            ok = ok & (qpos >= kpos)
        s = torch.einsum("bgrnqd,bgkd->bgrnqk", qf, kf[:, :, cut])
        p = torch.where(ok, torch.exp(s * scale - lsef[..., None]), 0.0)
        dp = torch.einsum("bgrnqd,bgkd->bgrnqk", gf, vf[:, :, cut])
        ds = p * (dp - D[..., None])
        cdv.append(torch.einsum("bgrnqk,bgrnqd->bgrnkd", p, gf))
        cdk.append(torch.einsum("bgrnqk,bgrnqd->bgrnkd", ds, qf))
        for h in range(2):     # the dQ kernel's steps of bk / 2 keys
            half = slice(h * bk // 2, (h + 1) * bk // 2)
            dq = dq + torch.einsum("bgrnqk,bgkd->bgrnqd", ds[..., half],
                                   kf[:, :, cut][:, :, half])
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(kf)
    for it, pieces in enumerate(dkdv_wrap(B, H, Hkv, S, Sk,
                                          causal).by_item()):
        bhk, t = divmod(it, nk)
        b, hk = divmod(bhk, Hkv)
        first = min(t * bk // bq, nq) if causal else 0
        # the walk's steps, step g per + qt - first
        steps = [c[t][b, hk, :, first:].reshape((-1, bk, hd))
                 for c in (cdk, cdv)]
        cut = slice(t * bk, (t + 1) * bk)
        for a, e in pieces:
            dk[b, hk, cut] += steps[0][a:e].sum(dim=0)
            dv[b, hk, cut] += steps[1][a:e].sum(dim=0)
    dq = (dq * scale).reshape(B, H, nq * bq, hd)[:, :, :S]
    return (dq.to(q.dtype), (dk[:, :, :Sk] * scale).to(k.dtype),
            dv[:, :, :Sk].to(v.dtype))


def _row_strides(t: torch.Tensor) -> tuple[Optional[list[int]], str]:
    """(batch, head, row) element strides of a (B, H, S, hd) tensor whose
    rows a kernel reads 16 bytes at a time (TMA or ``cp.async``): the last
    dim unit-stride, the tensor and every stride 16-byte aligned; else
    (None, why).  A dim of size 1 is never stepped, so its stride is
    replaced by a valid one."""
    esz = t.element_size()
    if t.stride(-1) != 1:
        return None, (f"last dim has stride {t.stride(-1)}; the kernel reads "
                      "it unit-stride")
    if not _cuda.is_fake(t) and t.data_ptr() % 16:
        return None, "data is not 16-byte aligned"
    out = []
    for d in range(3):
        st = t.stride(d) if t.shape[d] > 1 else math.prod(t.shape[d + 1:])
        if (st * esz) % 16:
            return None, (f"stride {t.stride(d)} of dim {d} is not a "
                          "multiple of 16 bytes")
        out.append(st)
    return out, ""


def _tma_strides(t: torch.Tensor, what: str) -> list[int]:
    """``_row_strides`` of an input of the bf16 tensor-core kernel, which
    TMA reads through its strides; raises where they do not fit."""
    strides, why = _row_strides(t)
    if strides is None:
        raise ValueError(f"{what}: {why}")
    return strides


def _aligned_rows(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a contiguous copy where its rows do not fit 16-byte
    copies (the tf32x3 kernel reads any layout that fits)."""
    return t if _row_strides(t)[0] is not None else t.contiguous()


def flash_attention(q, k, v, *, causal: bool = True,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    device: Optional[str] = None):
    """q: (B, H, S, hd); k, v: (B, Hkv, Sk, hd) with Hkv dividing H (q head
    h reads kv head h // (H / Hkv)), all float32 or all bfloat16.  Returns
    (B, H, S, hd) in q's dtype.

    bf16 at hd 64/128/256 runs the tensor-core kernel: inputs may be any
    views whose last dim is unit-stride and whose strides are 16-byte
    aligned, the output takes q's layout, and (block_q, block_k) must be
    one of ``WGMMA_BLOCKS[hd]`` (default: the first).  float32 at hd
    64/128/256 runs the tf32x3 kernel (any views, the output in q's layout)
    on its own tiles: ``block_q``/``block_k`` must be ``None`` or
    ``TF32X3_BLOCKS[hd]``'s.  hd 16 and 32 run the CUDA-core kernel (any
    views, the output in q's layout; blocks of at most 64, default
    ``CUDA_CORE_BLOCKS``).  Blocks are cut to S/Sk as in the TPU
    wrapper, and a ragged last block is masked.  ``device`` defaults to
    where the tensors lie (the card for numpy input): the kernels run on
    the card, the plain version on the CPU."""
    dev = _cuda.resolve_device([q, k, v], device)
    if any(getattr(x, "ndim", 0) != 4 for x in (q, k, v)):
        raise ValueError("flash_attention: q, k, v must be (B, H, S, hd)")
    B, H, S, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not supported; the "
                         f"kernels take hd in {HEAD_DIMS}")
    if H % Hkv:
        raise ValueError(f"flash_attention: {Hkv} kv heads do not divide "
                         f"{H} q heads")
    dtype = q.dtype if isinstance(q, torch.Tensor) else torch.float32
    if dtype not in _ENTRY:
        raise ValueError(f"flash_attention: dtype {dtype}, kernels take "
                         "float32 or bfloat16")
    q = _cuda.as_input(q, dtype, dev, (B, H, S, hd), "q", contiguous=False)
    k = _cuda.as_input(k, dtype, dev, (B, Hkv, Sk, hd), "k",
                       contiguous=False)
    v = _cuda.as_input(v, dtype, dev, (B, Hkv, Sk, hd), "v",
                       contiguous=False)
    kind = route(dtype, hd)
    if kind == "wgmma":
        pairs = WGMMA_BLOCKS[hd]
        block_q = pairs[0][0] if block_q is None else block_q
        block_k = pairs[0][1] if block_k is None else block_k
        if (block_q, block_k) not in pairs:
            raise ValueError(f"flash_attention: blocks ({block_q}, "
                             f"{block_k}); the tensor-core kernel takes "
                             f"{list(pairs)} at bf16 hd={hd}")
        for t, n in ((q, "q"), (k, "k"), (v, "v")):
            _tma_strides(t, n)
    elif kind == "tf32x3":
        tile = TF32X3_BLOCKS[hd]
        if any(b not in (None, t) for b, t in zip((block_q, block_k), tile)):
            raise ValueError(f"flash_attention: blocks ({block_q}, "
                             f"{block_k}); the tf32x3 kernel walks its own "
                             f"{tile} tiles at f32 hd={hd}")
        block_q, block_k = min(tile[0], S), min(tile[1], Sk)
    else:
        dq, dk = CUDA_CORE_BLOCKS
        block_q = min(dq if block_q is None else block_q, S)
        block_k = min(dk if block_k is None else block_k, Sk)
        if not (1 <= block_q <= MAX_BLOCK and 1 <= block_k <= MAX_BLOCK):
            raise ValueError(f"flash_attention: blocks ({block_q}, {block_k})"
                             f" must lie in 1..{MAX_BLOCK}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Attention.apply(q, k, v, causal, kind, block_q, block_k)
    return _run(q, k, v, causal, kind, block_q, block_k, False)[0]


def _run(q, k, v, causal: bool, kind: str, block_q: int, block_k: int,
         with_lse: bool):
    """The forward on checked inputs: (out, lse or None), through the
    operator ``repro_torch::flash_attention`` (``flash_attention_lse`` when
    ``with_lse``): the plain version for CPU tensors (``_fwd_plain``), the
    kernel of ``kind`` for card tensors (``_fwd_launch``), the outputs'
    shapes alone for FakeTensors."""
    if with_lse:
        return _FWD_LSE(q, k, v, causal, kind, block_q, block_k)
    return _FWD(q, k, v, causal, kind, block_q, block_k), None


def _fwd_plain(q, k, v, causal: bool, kind: str, block_q: int, block_k: int,
               with_lse: bool):
    """The operators' CPU implementation: ``flash_attention_plain`` (on
    the split schedule where the route's kernel splits)."""
    split = kind == "wgmma" and split_route(q.dtype, q.shape[3])
    res = flash_attention_plain(q, k, v, causal=causal, block_q=block_q,
                                block_k=block_k, return_lse=with_lse,
                                split=split)
    return res if with_lse else (res, None)


def _fwd_launch(q, k, v, causal: bool, kind: str, block_q: int, block_k: int,
                with_lse: bool):
    """The operators' CUDA implementation: the kernel of ``kind``, which
    writes the rows' log-sum-exp too when ``with_lse``."""
    dev = q.device
    B, H, S, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    dtype = q.dtype
    lse = torch.empty((B, H, S), dtype=torch.float32, device=dev) \
        if with_lse else None
    lse_ptr = None if lse is None else lse.data_ptr()
    n = 1
    if kind == "wgmma":
        out = torch.empty_like(q)
        st = (ctypes.c_longlong * 12)(*(s for t, n in ((q, "q"), (k, "k"),
                                                       (v, "v"), (out, "out"))
                                        for s in _tma_strides(t, n)))
    if kind == "wgmma" and split_route(dtype, hd):
        sp = fwd_split(B, H, Hkv, S, Sk, causal)
        rows = sp.slots * 2 * UNIT_ROWS
        part_o = torch.empty(rows * hd, dtype=torch.float32, device=dev)
        part_ml = torch.empty(rows * 2, dtype=torch.float32, device=dev)
        lib, launch = _wgmma_hd256_launcher()
        pieces, sums = sp.c_tables
        with torch.cuda.device(dev):
            rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), lse_ptr, part_o.data_ptr(),
                        part_ml.data_ptr(), B, H, Hkv, S, Sk, int(causal),
                        hd ** -0.5, ctypes.addressof(st),
                        ctypes.addressof(pieces), len(sp.pieces),
                        ctypes.addressof(sums), len(sp.sums),
                        _cuda.current_stream(dev))
        n = 1 + bool(sp.sums)
    elif kind == "wgmma":
        lib, launch = _wgmma_launcher()
        with torch.cuda.device(dev):
            rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), lse_ptr, B, H, Hkv, S, Sk, hd,
                        block_k, int(causal), hd ** -0.5,
                        ctypes.addressof(st), _cuda.current_stream(dev))
    elif kind == "tf32x3":
        q, k, v = (_aligned_rows(t) for t in (q, k, v))
        lib, launch = _tf32x3_launcher()
        out = torch.empty_like(q)
        st = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out)
                                        for s in _row_strides(t)[0]))
        with torch.cuda.device(dev):
            rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), lse_ptr, B, H, Hkv, S, Sk, hd,
                        int(causal), hd ** -0.5, ctypes.addressof(st),
                        _cuda.current_stream(dev))
    else:
        q, k, v = (_cuda.unit_rows(t) for t in (q, k, v))
        lib, launch = _launcher(dtype)
        out = torch.empty_like(q)
        st = (ctypes.c_longlong * 12)(*(t.stride(d) for t in (q, k, v, out)
                                        for d in range(3)))
        with torch.cuda.device(dev):
            rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), lse_ptr, B, H, Hkv, S, Sk, hd,
                        block_q, block_k, int(causal), hd ** -0.5,
                        ctypes.addressof(st), _cuda.current_stream(dev))
    _cuda.check(lib, rc, "flash_attention")
    LAUNCHES[f"{kind}/{str(dtype).removeprefix('torch.')}"] += n
    return out, lse


def _tma_rows(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a contiguous copy where TMA cannot read it through its
    strides (``_row_strides``; a dim of more than one entry at stride 0,
    an expanded gradient, is copied too)."""
    ok = _row_strides(t)[0] is not None and all(
        t.stride(d) or t.shape[d] == 1 for d in range(3))
    return t if ok else t.contiguous()


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool):
    """(dq, dk, dv) of ``flash_attention``'s output given its gradient
    ``dout``: q, out, dout (B, H, S, hd), k, v (B, Hkv, Sk, hd), all of one
    dtype (float32 or bfloat16; views), lse (B, H, S) fp32 from the
    forward.  dk and dv are at the kv heads, summed over each group of q
    heads; each gradient has its input's shape and dtype.  On the card the
    backward of ``bwd_route`` (``bwd_launches`` kernels; its dK/dV tile
    ``BWD_TILES[route][hd]``); on the CPU its plain version on the same
    tiles.  A head dim or dtype no backward is built for raises."""
    B, H, S, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    dtype = q.dtype
    kind = bwd_route(dtype, hd)
    if hd not in BWD_TILES[kind] or dtype not in _BWD_ENTRY:
        built = sorted({h for t in BWD_TILES.values() for h in t})
        raise NotImplementedError(
            f"flash_attention backward: no kernel for hd={hd}, {dtype}; the "
            f"backward kernels are built for hd in {tuple(built)}, float32 "
            "and bfloat16 (bwd_route)")
    return _BWD(q, k, v, out, lse, dout.to(dtype), causal)


def _bwd_plain(q, k, v, out, lse, dout, causal: bool):
    """The backward operator's CPU implementation:
    ``flash_attention_bwd_plain`` on ``bwd_route``'s tiles."""
    S, hd, Sk = q.shape[2], q.shape[3], k.shape[2]
    kind = bwd_route(q.dtype, hd)
    bq, bk = BWD_TILES[kind][hd]
    if kind == "wgmma":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                         causal=causal, block_q=bq,
                                         block_k=bk, split=True)
    return flash_attention_bwd_plain(q, k, v, out, lse, dout, causal=causal,
                                     block_q=min(bq, S), block_k=min(bk, Sk))


def _bwd_launch(q, k, v, out, lse, dout, causal: bool):
    """The backward operator's CUDA implementation: the kernels of
    ``bwd_route`` (``bwd_launches`` of them)."""
    B, H, S, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    dtype = q.dtype
    kind = bwd_route(dtype, hd)
    dev = q.device
    lse = lse.float().contiguous()
    if split_route(dtype, hd):
        q, k, v, out, dout = (_tma_rows(t) for t in (q, k, v, out, dout))
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        skv, sq, sums, nsums = _bwd_splits(B, H, Hkv, S, Sk, causal)
        stats = torch.empty(2 * B * H * -(-S // 128) * 128,
                            dtype=torch.float32, device=dev)
        tile = 2 * UNIT_ROWS * hd        # a slot: two 64-row fp32 tiles
        part_kv = torch.empty(max(1, skv.slots * tile), dtype=torch.float32,
                              device=dev)
        part_q = torch.empty(max(1, sq.slots * tile), dtype=torch.float32,
                             device=dev)
        lib, launch = _wgmma_bwd_hd256_launcher()
        st = (ctypes.c_longlong * 24)(*(s for t in (q, k, v, out, dout, dq,
                                                    dk, dv)
                                        for s in _row_strides(t)[0]))
        (kv_pieces, _), (q_pieces, _) = skv.c_tables, sq.c_tables
        with torch.cuda.device(dev):
            rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                        stats.data_ptr(), part_kv.data_ptr(),
                        part_q.data_ptr(), B, H, Hkv, S, Sk, int(causal),
                        hd ** -0.5, ctypes.addressof(st),
                        ctypes.addressof(kv_pieces), len(skv.pieces),
                        ctypes.addressof(q_pieces), len(sq.pieces),
                        ctypes.addressof(sums), nsums,
                        _cuda.current_stream(dev))
        n = 3 + bool(nsums)
    elif kind == "wgmma":
        q, k, v, out, dout = (_tma_rows(t) for t in (q, k, v, out, dout))
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        sp = dkdv_wrap(B, H, Hkv, S, Sk, causal)
        stats = torch.empty(2 * B * H * -(-S // 128) * 128,
                            dtype=torch.float32, device=dev)
        # a slot: dK's and dV's fp32 partials of a kv tile of 128 keys
        tile = 2 * BWD_TILES["wgmma"][hd][1] * hd
        part = torch.empty(sp.slots * tile, dtype=torch.float32,
                           device=dev) if sp.sums else None
        lib, launch = _wgmma_bwd_launcher()
        st = (ctypes.c_longlong * 24)(*(s for t in (q, k, v, out, dout, dq,
                                                    dk, dv)
                                        for s in _row_strides(t)[0]))
        pieces, sums = sp.c_tables
        with torch.cuda.device(dev):
            rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                        stats.data_ptr(),
                        None if part is None else part.data_ptr(), B, H, Hkv,
                        S, Sk, hd, int(causal), hd ** -0.5,
                        ctypes.addressof(st), ctypes.addressof(pieces),
                        len(sp.pieces), ctypes.addressof(sp.c_offsets),
                        len(sp.offsets), ctypes.addressof(sums),
                        len(sp.sums), _cuda.current_stream(dev))
        n = BWD_LAUNCHES[kind] + bool(sp.sums)
    elif kind == "tf32x3":
        # cp.async reads any 16-byte aligned rows
        q, k, v, out, dout = (_aligned_rows(t) for t in (q, k, v, out, dout))
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        split = bwd_split(B, H, Hkv, Sk, hd, kind)
        # each head's lse and D, its rows padded to 128
        stats = torch.empty(2 * B * H * -(-S // 128) * 128,
                            dtype=torch.float32, device=dev)
        nf = _bwd_part_floats(kind, hd, split, B, H, Hkv, S, Sk)
        part = torch.empty(nf, dtype=torch.float32, device=dev) if nf else None
        lib, launch = _tf32x3_bwd_launcher()
        st = (ctypes.c_longlong * 24)(*(s for t in (q, k, v, out, dout, dq,
                                                    dk, dv)
                                        for s in _row_strides(t)[0]))
        with torch.cuda.device(dev):
            rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                        stats.data_ptr(),
                        None if part is None else part.data_ptr(), B, H, Hkv,
                        S, Sk, hd, int(causal), split, hd ** -0.5,
                        ctypes.addressof(st), _cuda.current_stream(dev))
        n = BWD_LAUNCHES[kind] + _bwd_sums(kind, hd, split)
    else:
        q, k, v, out, dout = (_aligned_rows(t) for t in (q, k, v, out, dout))
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        lib, launch = _bwd_launcher(dtype)
        st = (ctypes.c_longlong * 24)(*(s for t in (q, k, v, out, dout, dq,
                                                    dk, dv)
                                        for s in _row_strides(t)[0]))
        with torch.cuda.device(dev):
            rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H,
                        Hkv, S, Sk, hd, int(causal), hd ** -0.5,
                        ctypes.addressof(st), _cuda.current_stream(dev))
        n = BWD_LAUNCHES[kind]
    _cuda.check(lib, rc, "flash_attention backward")
    LAUNCHES[f"bwd/{str(dtype).removeprefix('torch.')}"] += n
    return dq, dk, dv


@functools.lru_cache(maxsize=256)
def _bwd_splits(B: int, H: int, Hkv: int, S: int, Sk: int, causal: bool):
    """(dK/dV split, dQ split, the sum kernel's entries, their count): the
    entries a flat C int array of (item, first slot, pieces, 0) for each
    dK/dV item whose walk was cut, then (item, first slot, pieces, 1) for
    each dQ item's."""
    skv, sq = (dkdv_split(B, H, Hkv, S, Sk, causal),
               dq_split(B, H, Hkv, S, Sk, causal))
    flat = [x for r in [(*e, 0) for e in skv.sums]
            + [(*e, 1) for e in sq.sums] for x in r]
    return skv, sq, (ctypes.c_int * max(1, len(flat)))(*flat), len(flat) // 4


def kept_scores(S: int, Sk: int, causal: bool) -> int:
    """(q row, key) pairs one head's attention keeps: every pair, or
    (causal) key j for row i where j <= i."""
    if not causal:
        return S * Sk
    n = min(S, Sk)
    return n * (n + 1) // 2 + (S - n) * Sk


# ---------------------------------------------------------------------------
# the operators: the dispatcher picks the implementation by the tensors'
# device, and a FakeTensor takes the fake one (shapes and dtypes alone)
# ---------------------------------------------------------------------------

_cuda.LIB.define("flash_attention(Tensor q, Tensor k, Tensor v, bool causal, "
                 "str kind, int block_q, int block_k) -> Tensor")
_cuda.LIB.define("flash_attention_lse(Tensor q, Tensor k, Tensor v, bool "
                 "causal, str kind, int block_q, int block_k) -> "
                 "(Tensor, Tensor)")
_cuda.LIB.define("flash_attention_bwd(Tensor q, Tensor k, Tensor v, Tensor "
                 "out, Tensor lse, Tensor dout, bool causal) -> "
                 "(Tensor, Tensor, Tensor)")
_cuda.LIB.impl("flash_attention", lambda *a: _fwd_plain(*a, False)[0], "CPU")
_cuda.LIB.impl("flash_attention", lambda *a: _fwd_launch(*a, False)[0],
               "CUDA")
_cuda.LIB.impl("flash_attention_lse", lambda *a: _fwd_plain(*a, True), "CPU")
_cuda.LIB.impl("flash_attention_lse", lambda *a: _fwd_launch(*a, True),
               "CUDA")
_cuda.LIB.impl("flash_attention_bwd", lambda *a: _bwd_plain(*a), "CPU")
_cuda.LIB.impl("flash_attention_bwd", lambda *a: _bwd_launch(*a), "CUDA")


@torch.library.register_fake("repro_torch::flash_attention", lib=_cuda.LIB)
def _fwd_fake(q, k, v, causal, kind, block_q, block_k):
    return torch.empty_like(q)


@torch.library.register_fake("repro_torch::flash_attention_lse",
                             lib=_cuda.LIB)
def _fwd_lse_fake(q, k, v, causal, kind, block_q, block_k):
    return torch.empty_like(q), q.new_empty(q.shape[:3], dtype=torch.float32)


@torch.library.register_fake("repro_torch::flash_attention_bwd",
                             lib=_cuda.LIB)
def _bwd_fake(q, k, v, out, lse, dout, causal):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


@register_flop_formula([torch.ops.repro_torch.flash_attention,
                        torch.ops.repro_torch.flash_attention_lse])
def _fwd_flops(q, k, v, causal, *args, **kwargs) -> int:
    """4 hd a kept score (PERF.md: QK^T and PV, two flops a product)."""
    B, H, S, hd = q
    return 4 * hd * kept_scores(S, k[2], causal) * B * H


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _bwd_flops(q, k, v, out, lse, dout, causal, **kwargs) -> int:
    """10 hd a kept score: S and dP recomputed, dV, dK and dQ."""
    B, H, S, hd = q
    return 10 * hd * kept_scores(S, k[2], causal) * B * H


_FWD = torch.ops.repro_torch.flash_attention.default
_FWD_LSE = torch.ops.repro_torch.flash_attention_lse.default
_BWD = torch.ops.repro_torch.flash_attention_bwd.default


class _Attention(torch.autograd.Function):
    """K4 with its gradient: the forward kernel (writing the rows'
    log-sum-exp), then ``flash_attention_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, kind, block_q, block_k):
        out, lse = _run(q, k, v, causal, kind, block_q, block_k, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         causal=ctx.causal)
        return dq, dk, dv, None, None, None, None
