// Flash attention, backward, bf16, on Hopper's tensor cores (wgmma), with
// every tile fed by TMA through a ring of shared-memory stages, and
// grouped-query attention and strided layouts read natively.
//
// Replaces: no TPU kernel.  The JAX package differentiates its attention
// (src/repro/models/layers.py::_sdpa and _sdpa_chunked) with jax.grad and has
// no Pallas VJP; its Pallas forward is
// src/repro/kernels/flash_attention.py::_fa_kernel (line 22).  This is the
// gradient of the port's bf16 forward (flash_attention_wgmma.cu) at head dims
// 64, 128 and 256; f32, and bf16 at hd 16 and 32, stay on
// flash_attention_bwd.cu (the CUDA cores).
//
// What it computes (as flash_attention_bwd.cu): for out = softmax(q k^T *
// scale [+ causal mask]) v over q (B, H, S, hd) and k, v (B, Hkv, Sk, hd)
// (q head h reads kv head h / (H / Hkv)), lse the row log-sum-exp of the
// scaled scores and dout the output's gradient:
//   D_i   = sum_d dout_id out_id
//   P_ij  = exp(q_i . k_j * scale - lse_i)        (0 where masked)
//   dV_j  = sum_i P_ij dout_i
//   dS_ij = P_ij (dout_i . v_j - D_i)
//   dK_j  = scale * sum_i dS_ij q_i
//   dQ_i  = scale * sum_j dS_ij k_j
// with dK and dV summed over the G q heads of each kv head.  Products take
// bf16 operands (q, k, v, dout as given; P and dS rounded to bf16 from fp32)
// and sum in fp32; scores, P, dS and every accumulator are fp32, and each
// gradient is rounded once to bf16.
//
// Bound on Hopper: operations.  Five products of 2*hd flops per kept score
// (S, dP, dV, dK, dQ): at llama3-8b's training shape, q (2, 32, 2048, 128)
// over 8 kv heads, causal, 171.9 GFLOP on 168 MB, 0.174 ms at the bf16
// tensor cores' 989 TFLOP/s.  This design does seven (the dQ kernel
// recomputes S and dP, so that no gradient needs atomics): 0.243 ms.
//
// Design, point by point against the CUDA-core kernel (flash_attention_bwd.cu):
// * Its five products were fp32 FMAs on the CUDA cores.  Here each is a
//   wgmma (m64nNk16, bf16 in, fp32 accumulators in registers).  In the dK/dV
//   kernel the scores are computed transposed, S^T = K Q^T and dP^T = V
//   dout^T (K-major operands, both from shared memory), so that P^T and dS^T
//   come out in the accumulator layout, which is the register layout of
//   wgmma's A operand: dV += P^T dout and dK += dS^T Q then take P^T and dS^T
//   from registers (packed to bf16) and dout and Q MN-major from shared
//   memory.  In the dQ kernel S = Q K^T and dP = dout V^T, and dQ += dS K
//   takes dS from registers and K MN-major.  P and dS never leave registers.
// * It widened tiles to fp32 and loaded them element by element between
//   two __syncthreads().  Here they stay bf16 in the 128-byte swizzle that
//   TMA writes and wgmma reads, and one producer thread issues every load:
//   the dK/dV block's K and V once a piece, then Q, dout and the rows'
//   statistics (lse * log2 e and D, 512 bytes a 64-row tile, one bulk copy)
//   step by step into a ring of stages with a "full" and an "empty"
//   mbarrier each; the dQ block's Q and dout once, then K and V tile by
//   tile.  setmaxnreg asks 240 registers for the consumers.
// * Its dK/dV kernel held 119 KB of fp32 tiles per 64 keys.  Here a dK/dV
//   item is a kv tile of 128 keys (two consumer warpgroups of 64) at hd 64
//   and 128, and its walk is its group's q heads x their q tiles of 64
//   rows.  A dQ block owns 128 q rows (two warpgroups of 64) and walks kv
//   tiles of 64 keys.  hd 256 has kernels of its own (below).
// * The dK/dV kernel's two consumer warpgroups interleave: one forms P^T
//   and dS^T (in one pass, once S^T and dP^T have both retired) while the
//   other's products are on the tensor cores; dV's and dK's products go out
//   together.  Overlapping within a warpgroup as well (P^T beside dP^T's
//   product, dK's beside the next tile's S^T) kept 224 registers a thread
//   live and spilled more: on an H100 at llama3-8b's training shape that
//   kernel took 0.51-0.59 ms against this form's 0.46.  The dQ kernel at
//   hd 64 retires dQ's product under the next tile's S and dP (at hd 128
//   that costs more than it gains: Cfg<HD>::DQ_OVERLAP).
// * Registers: ptxas gives a kernel one register count from its launch
//   bounds, 168 at 384 threads, whatever setmaxnreg asks.  Both kernels
//   fit it with no spill.  The dK/dV kernel's earlier form, which split
//   each group's q heads over blocks, spilled 272 B at hd 128.  A 256-thread
//   form without the producer (thread 0 of a consumer warpgroup issuing the
//   loads) spilled nothing either, but ran slower on an H100 at hd 64 and
//   128: the loader's warpgroup waits for the other's releases, and the
//   two stop interleaving.
// * Balance (flash_attention.dkdv_wrap): a causal walk shrinks with its
//   tile, from G nq steps down to 2 G, and at a GQA group of 8 the 128 kv
//   tiles of q (1, 64, 2048, 128) over 8 kv heads would leave the longest
//   walk (256 steps) twice the mean.  Where the items are fewer than the
//   SMs the host lays their walks end to end and wraps them over at most
//   132 blocks of T steps (McNaughton's rule): a block walks its pieces in
//   turn, and its producer loads a piece's K and V once the consumers have
//   released the last one's, so no block walks more than T.  A cut walk's
//   pieces write fp32 partials that a sum kernel adds in slot order.  Grids
//   of 132 items or more take one block an item, tile-major (the longest
//   causal walks first), which the card hands out as SMs free.
// * No atomics, so every gradient is bitwise the same from call to call:
//   each piece sums its steps in registers and the sum kernel its pieces in
//   slot order.  Four launches a call where a walk was cut, else three: D,
//   dK/dV, dQ.
// * Causal: a dK/dV walk starts at the q tile that holds its first key; a
//   warpgroup whose keys all lie past a tile's last row releases it without
//   computing; only tiles that cross the diagonal are masked.  A dQ block
//   stops at kv tile ((qi+1)*BQ - 1)//BK, the forward's bound.  Rows past S
//   carry lse = +inf in the statistics, so their P is 0 without a mask.
//
// hd 256 (fa_bwd_wgmma_hd256_*), designed around PaliGemma's q (1, 8, 1024,
// 256) over one kv head, where the dK/dV grid was 128 blocks of walks from
// 16 q tiles down to 1, its two warpgroups both computed S^T and dP^T (6
// products of 2 hd a kept score where 4 do), and the dQ grid was 64 blocks:
// * dK/dV: a block owns 64 keys.  Warpgroup 0 computes S^T = K Q^T, P^T and
//   dV += P^T dout; it hands P^T (fp32) to warpgroup 1 through one of two
//   shared buffers; warpgroup 1 computes dP^T = V dout^T, dS^T and dK +=
//   dS^T Q.  Four products a kept score, 128 accumulators a thread each.
//   Its item is a kv tile, whose walk is G q heads x its q tiles of 64 rows.
// * dQ: a block's two warpgroups take a pair of 64-row units, as the hd-256
//   forward's (the same rows of two heads at an even G, reading each K and
//   V step once for both), over steps of 32 keys (two stages of 64 would
//   not fit beside the units' Q and dout; three of 32 do).
// * Both grids: where a kernel's items are fewer than the SMs, the host cuts
//   their walks into pieces of nearly equal length until 132 blocks fill a
//   wave (flash_attention.split_walks); a cut walk's pieces write fp32
//   partials that a sum kernel adds in slot order: 4 launches a call then.
// * No spill: no producer warpgroup (ptxas gives a kernel one register
//   count from its launch bounds, 168 at 384 threads, whatever setmaxnreg
//   asks for); thread 0 of warpgroup 1 issues every load, step jj + ST once
//   it has released step jj, and 256 threads leave 255 registers a thread.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NCONS = 2;                   // consumer warpgroups
constexpr int NTHREADS = (NCONS + 1) * 128;
// setmaxnreg: 128 * 24 + 256 * 240 = 64,512 of the SM's 65,536 registers
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr int MAX_PIECES = 132;            // a launch's table: the H100's SMs
constexpr int CHUNK = 64;                  // bf16 columns per 128-byte row
constexpr int ROW_BYTES = 128;
constexpr int BQ = 64;                     // q rows a dK/dV step takes
constexpr int BQ_DQ = 128;                 // q rows of a dQ block
constexpr int STATS_BYTES = 2 * BQ * 4;    // lse * log2 e, then D, per 64 rows
constexpr int DOT_WARPS = 8;
constexpr int SUM_THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int ENCODE_FAILED = 10000;       // + CUresult of the tensor map

// tiles by head dim: keys of a dK/dV item (BKV), keys of a dQ step (BK),
// the two rings' depths, and whether a dQ step's product retires under the
// next step's S and dP (at hd 128 the registers that takes make ptxas
// serialise every wgmma, and the dQ kernel is faster without it:
// tools/k4_bwd_variants.py times both)
template <int HD> struct Cfg;
template <> struct Cfg<64> {
    static constexpr int BKV = 128, BK = 64, KV_STAGES = 3, Q_STAGES = 4;
    static constexpr bool DQ_OVERLAP = true;
};
template <> struct Cfg<128> {
    static constexpr int BKV = 128, BK = 64, KV_STAGES = 3, Q_STAGES = 4;
    static constexpr bool DQ_OVERLAP = false;
};

// a piece of a dK/dV walk at hd 64/128: kv tile `item`'s steps [start,
// stop); slot -1 where that is its whole walk, else the fp32 partial it
// writes
struct KvPiece { unsigned short item, start, stop; short slot; };
// the blocks' pieces (flash_attention.wrap_walks): block x walks p[first[x]]
// .. p[first[x + 1] - 1] in turn.  n = 0: no table, block x walks one
// whole kv tile, tile-major
struct KvTable {
    int n;
    unsigned short first[MAX_PIECES + 1];
    KvPiece p[2 * MAX_PIECES];
};
// a cut item: its pieces' first slot and count; kind 0 a dK/dV tile, 1 (at
// hd 256) a dQ pair of units
struct SumEntry { short item, slot0, count, kind; };
struct SumTable { int n; SumEntry e[2 * MAX_PIECES]; };

// dK/dV block: K and V (BKV rows), then per stage Q, dout (64 rows) and the
// statistics; every tile 1024-byte aligned (the swizzle's period)
template <int HD>
struct DkdvLayout {
    static constexpr int ST = Cfg<HD>::Q_STAGES;
    static constexpr int KV_BYTES = Cfg<HD>::BKV * HD * 2;
    static constexpr int T_BYTES = BQ * HD * 2;
    static constexpr int K_OFF = 0, V_OFF = KV_BYTES;
    static constexpr int Q_OFF = 2 * KV_BYTES;
    static constexpr int G_OFF = Q_OFF + ST * T_BYTES;
    static constexpr int ST_OFF = G_OFF + ST * T_BYTES;
    static constexpr int BAR_OFF = ST_OFF + ST * STATS_BYTES;
    static constexpr int NBARS = 2 + 2 * ST;
    static constexpr int SMEM = BAR_OFF + NBARS * 8 + 1024;
    static_assert(SMEM <= 232448, "tiles exceed a block's shared memory");
};

// dQ block: Q and dout (128 rows), then per stage K and V (BK rows)
template <int HD>
struct DqLayout {
    static constexpr int ST = Cfg<HD>::KV_STAGES;
    static constexpr int T_BYTES = BQ_DQ * HD * 2;
    static constexpr int KV_BYTES = Cfg<HD>::BK * HD * 2;
    static constexpr int Q_OFF = 0, G_OFF = T_BYTES;
    static constexpr int K_OFF = 2 * T_BYTES;
    static constexpr int V_OFF = K_OFF + ST * KV_BYTES;
    static constexpr int BAR_OFF = V_OFF + ST * KV_BYTES;
    static constexpr int NBARS = 1 + 2 * ST;
    static constexpr int SMEM = BAR_OFF + NBARS * 8 + 1024;
    static_assert(SMEM <= 232448, "tiles exceed a block's shared memory");
};

struct KvStrides {    // element strides (batch, head, row) of dk and dv
    long long dk[3], dv[3];
};

struct RowStrides {   // element strides (batch, head, row)
    long long s[3];
};

// ---- device helpers, as flash_attention_wgmma.cu has them ---------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(bar) : "memory");
}

// returns once the barrier's phase of parity `parity` has completed.  A
// wait is microseconds; one that outlasts 2^34 cycles (about 9 s) is a
// fault of the ring, and traps (the launch fails) rather than hang the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    const long long t0 = clock64();
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
        if (!done && clock64() - t0 > (1ll << 34)) __trap();
    } while (!done);
}

// one box of a 4-D tensor map (coordinates innermost first) into shared
// memory; completion is counted in bytes on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5, %6}], [%2];"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
           "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// `bytes` contiguous bytes (16-byte aligned, a multiple of 16) into shared
// memory; completion is counted on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
           "r"(bar) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4)
         | (uint64_t)((lbo & 0x3FFFF) >> 4) << 16
         | (uint64_t)((sbo & 0x3FFFF) >> 4) << 32
         | (uint64_t)1 << 62;
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// waits until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

template <int N> struct Wgmma;

template <> struct Wgmma<32> {
    // D(64x32, fp32) (+)= A(64x16, smem, K-major) * B(32x16, smem, K-major)^T
    static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a, uint64_t b, int accumulate) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "setp.ne.b32 p, %18, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
            "{"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
            "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
            : "l"(a), "l"(b), "r"(accumulate));
    }
};

template <> struct Wgmma<64> {
    // D(64x64, fp32) (+)= A(64x16, smem, K-major) * B(64x16, smem, K-major)^T
    static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "setp.ne.b32 p, %34, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
            "{"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
            "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
              "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
            : "l"(a), "l"(b), "r"(accumulate));
    }
    // D(64x64, fp32) += A(64x16, registers) * B(16x64, smem, MN-major)
    static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "setp.ne.b32 p, %37, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
            "{"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
            "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
              "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
    }
};

template <> struct Wgmma<128> {
    // D(64x128, fp32) += A(64x16, registers) * B(16x128, smem, MN-major)
    static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "setp.ne.b32 p, %69, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
            "{"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
            "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
            "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
            "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
              "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
              "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
              "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
              "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
              "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
    }
};

template <> struct Wgmma<256> {
    // D(64x256, fp32) += A(64x16, registers) * B(16x256, smem, MN-major)
    static __device__ __forceinline__ void rs(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "setp.ne.b32 p, %133, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
            "{"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
            "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
            "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
            "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
            "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
            "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
            "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
            "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
              "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
              "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
              "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
              "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
              "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
              "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
              "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
              "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
              "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
              "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
              "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
              "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
              "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
    }
};

// a score tile in bf16 as wgmma A fragments: accumulator block n/4 (8
// columns) feeds k-step n/8, whose registers hold (row0, columns 0-7),
// (row0+8, 0-7), (row0, 8-15), (row0+8, 8-15)
template <int N>
__device__ __forceinline__ void pack_a(const float (&sc)[N / 2],
                                       uint32_t (&p)[N / 16][4]) {
#pragma unroll
    for (int n = 0; n < N / 2; n += 2) p[n / 8][(n % 8) / 2] = pack_bf16(sc[n], sc[n + 1]);
}

// (a) the statistics both gradient kernels read, per (b*H + h) and tile of
// 64 q rows: lse * log2 e (+inf past S, so P is 0 there), then D =
// rowsum(dout * out) (0 past S).  One warp per padded row, 16 bytes a lane.
__global__ void __launch_bounds__(DOT_WARPS * 32)
fa_bwd_wgmma_dot_kernel(const __nv_bfloat16* __restrict__ o,
                        const __nv_bfloat16* __restrict__ g,
                        const float* __restrict__ lse,
                        float* __restrict__ stats, RowStrides so,
                        RowStrides sg, int H, int S, int NQ, int hd,
                        long long rows) {
    const long long row = (long long)blockIdx.x * DOT_WARPS + threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (row >= rows) return;
    const int per = NQ * BQ;
    const long long bh = row / per;
    const int r = (int)(row % per), b = (int)(bh / H), h = (int)(bh % H);
    float acc = 0.f;
    if (r < S && lane * 8 < hd) {
        const uint4 a = *reinterpret_cast<const uint4*>(
            o + b * so.s[0] + h * so.s[1] + r * so.s[2] + lane * 8);
        const uint4 c = *reinterpret_cast<const uint4*>(
            g + b * sg.s[0] + h * sg.s[1] + r * sg.s[2] + lane * 8);
        const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* c2 = reinterpret_cast<const __nv_bfloat162*>(&c);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float2 x = __bfloat1622float2(a2[i]), y = __bfloat1622float2(c2[i]);
            acc = fmaf(x.x, y.x, acc);
            acc = fmaf(x.y, y.y, acc);
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
        float* st = stats + (bh * NQ + r / BQ) * 2 * BQ + r % BQ;
        st[0] = r < S ? lse[bh * S + r] * LOG2E : INFINITY;
        st[BQ] = acc;
    }
}

// (b) dK and dV of the block's pieces, each a range of steps of a kv tile's
// walk over its group's q heads x the q tiles of 64 rows that the causal
// bound lets see its keys (step g per + qt - first).  A piece of a whole
// walk (slot -1) writes dk and dv in bf16 through their strides; a cut
// one fp32 partials (slots, 2, BKV, HD), dK's then dV's, for the sum
// kernel.  Consumer warpgroup wg takes keys 64 wg .. 64 wg + 63 of the
// tile.
template <int HD>
__global__ void __launch_bounds__(NTHREADS, 1)
fa_bwd_wgmma_dkdv_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap gmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const float* __restrict__ stats,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv,
                         float* __restrict__ part, KvStrides st, int H,
                         int Hkv, int group, int S, int Sk, int NQ,
                         int causal, float scale_log2, float scale,
                         const __grid_constant__ KvTable tab) {
    using L = DkdvLayout<HD>;
    constexpr int BKV = Cfg<HD>::BKV, ST = L::ST;
    constexpr int AN = HD / 2;             // dK and dV accumulators a thread
    extern __shared__ uint8_t smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023) & ~1023u;
    const uint8_t* gbase = smem_raw + (base - raw);
    const uint32_t sk = base + L::K_OFF, sv = base + L::V_OFF,
                   sq = base + L::Q_OFF, sg = base + L::G_OFF,
                   sst = base + L::ST_OFF, bars = base + L::BAR_OFF;
    // barriers: K and V loaded, and released, a phase a piece each; then
    // per stage full, empty
    const uint32_t kvbar = bars, kvfree = bars + 8;
    auto full = [&](int s) { return bars + 8 * (2 + s); };
    auto empty = [&](int s) { return bars + 8 * (2 + ST + s); };

    const int nk = (Sk + BKV - 1) / BKV, nq = (S + BQ - 1) / BQ;
    const int p0 = tab.n ? tab.first[blockIdx.x] : 0;
    const int np = tab.n ? tab.first[blockIdx.x + 1] - p0 : 1;
    // piece i of the block: its kv tile and steps [i0, i1)
    struct Work { int b, hk, k0, first, per, i0, i1, slot; };
    auto work = [&](int i) {
        int item, i0 = 0, i1 = -1, slot = -1;
        if (tab.n) {
            const KvPiece e = tab.p[p0 + i];
            item = e.item, i0 = e.start, i1 = e.stop, slot = e.slot;
        } else {
            const int bhks = gridDim.x / nk;
            item = blockIdx.x % bhks * nk + blockIdx.x / bhks;
        }
        Work w;
        const int bhk = item / nk;
        w.b = bhk / Hkv, w.hk = bhk % Hkv, w.k0 = item % nk * BKV;
        w.first = causal ? min(w.k0 / BQ, nq) : 0;
        w.per = nq - w.first;
        w.i0 = i0, w.i1 = i1 < 0 ? group * w.per : i1, w.slot = slot;
        return w;
    };

    if (threadIdx.x == 0) {
        mbar_init(kvbar, 1);
        mbar_init(kvfree, NCONS * 128);
        for (int s = 0; s < ST; ++s) {
            mbar_init(full(s), 1);
            mbar_init(empty(s), NCONS * 128);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    // warp-uniform, so that each role is one branch with its own registers
    const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
    if (wg == NCONS) {
        // ---- producer warpgroup: one thread issues every load: per piece,
        // once the consumers have released the last piece's K and V, K and
        // V, then each step (the block's steps counted across its pieces)
        // once its stage is free
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(PRODUCER_REGS));
        if (threadIdx.x == NCONS * 128) {
            for (int i = 0, jj = 0; i < np; ++i) {
                const Work w = work(i);
                if (i > 0) mbar_wait(kvfree, (i - 1) & 1);
                mbar_expect_tx(kvbar, 2 * L::KV_BYTES);
#pragma unroll
                for (int c = 0; c < HD / CHUNK; ++c) {
                    tma_load(sk + c * BKV * ROW_BYTES, &kmap, kvbar, c * CHUNK, w.k0, w.hk, w.b);
                    tma_load(sv + c * BKV * ROW_BYTES, &vmap, kvbar, c * CHUNK, w.k0, w.hk, w.b);
                }
                for (int it = w.i0; it < w.i1; ++it, ++jj) {
                    const int h = w.hk * group + it / w.per, qt = w.first + it % w.per;
                    const int s = jj % ST;
                    mbar_wait(empty(s), ((jj / ST) & 1) ^ 1);
                    mbar_expect_tx(full(s), 2 * L::T_BYTES + STATS_BYTES);
#pragma unroll
                    for (int c = 0; c < HD / CHUNK; ++c) {
                        tma_load(sq + s * L::T_BYTES + c * BQ * ROW_BYTES, &qmap,
                                 full(s), c * CHUNK, qt * BQ, h, w.b);
                        tma_load(sg + s * L::T_BYTES + c * BQ * ROW_BYTES, &gmap,
                                 full(s), c * CHUNK, qt * BQ, h, w.b);
                    }
                    bulk_load(sst + s * STATS_BYTES,
                              stats + ((long long)(w.b * H + h) * NQ + qt) * 2 * BQ,
                              STATS_BYTES, full(s));
                }
            }
        }
        return;
    }
    // ---- consumer warpgroup wg: 64 keys of the tile, all HD head dims -----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(CONSUMER_REGS));
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32, quad = lane % 4;
    const int krow = wg * 64;              // its rows of the K tile
    // S^T = K Q^T, dP^T = V dout^T: K-major operands, 16 columns (32 bytes)
    // a k-step, the next 64-column chunk every 4 steps
    const uint64_t kd = smem_desc(sk + krow * ROW_BYTES, 16, 1024),
                   vd = smem_desc(sv + krow * ROW_BYTES, 16, 1024);
    float dka[AN], dva[AN], sc[32], dp[32];
    uint32_t pa[4][4], pd[4][4];
    for (int i = 0, jj = 0; i < np; ++i) {
        const Work w = work(i);
        const int kw0 = w.k0 + krow;
        const int key0 = kw0 + warp * 16 + lane / 4;  // its keys key0, key0 + 8
#pragma unroll
        for (int n = 0; n < AN; ++n) dka[n] = dva[n] = 0.f;
        mbar_wait(kvbar, i & 1);
        for (int it = w.i0; it < w.i1; ++it, ++jj) {
            const int q0 = (w.first + it % w.per) * BQ, s = jj % ST;
            mbar_wait(full(s), (jj / ST) & 1);
            if (causal && q0 + BQ - 1 < kw0) {
                // every key of this warpgroup lies past every row of the tile
                mbar_arrive(empty(s));
                continue;
            }
            const uint32_t qs = sq + s * L::T_BYTES, gs = sg + s * L::T_BYTES;
            const float* stt = reinterpret_cast<const float*>(
                gbase + L::ST_OFF + s * STATS_BYTES);
            const uint64_t qd = smem_desc(qs, 16, 1024), gd = smem_desc(gs, 16, 1024);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk) {
                const uint32_t off = (kk % 4) * 32;
                Wgmma<64>::ss(sc, kd + (((kk / 4) * BKV * ROW_BYTES + off) >> 4),
                              qd + (((kk / 4) * BQ * ROW_BYTES + off) >> 4), kk > 0);
            }
            wgmma_commit();
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk) {
                const uint32_t off = (kk % 4) * 32;
                Wgmma<64>::ss(dp, vd + (((kk / 4) * BKV * ROW_BYTES + off) >> 4),
                              gd + (((kk / 4) * BQ * ROW_BYTES + off) >> 4), kk > 0);
            }
            wgmma_commit();
            // both retired: P^T and dS^T in one pass.  A thread holds keys
            // key0 (+8) against q rows q0 + 8 (n / 4) + 2 quad + (n & 1)
            wgmma_wait<0>();
            fence_regs(sc);
            fence_regs(dp);
            const bool edge = causal && q0 < kw0 + 63;
#pragma unroll
            for (int n = 0; n < 32; ++n) {
                const int col = (n >> 2) * 8 + 2 * quad + (n & 1);
                float p = ex2(fmaf(sc[n], scale_log2, -stt[col]));
                if (edge && key0 + 8 * ((n >> 1) & 1) > q0 + col) p = 0.f;
                sc[n] = p;
                dp[n] = p * (dp[n] - stt[BQ + col]);
            }
            pack_a<64>(sc, pa);
            pack_a<64>(dp, pd);
            // dV += P^T dout and dK += dS^T Q: dout and Q MN-major (hd
            // contiguous): 16 q rows (2 KB) a k-step, the next 64 head dims
            // 64 rows further
            const uint64_t gm = smem_desc(gs, BQ * ROW_BYTES, 1024),
                           qm = smem_desc(qs, BQ * ROW_BYTES, 1024);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < BQ / 16; ++kk)
                Wgmma<HD>::rs(dva, pa[kk], gm + ((kk * 16 * ROW_BYTES) >> 4));
#pragma unroll
            for (int kk = 0; kk < BQ / 16; ++kk)
                Wgmma<HD>::rs(dka, pd[kk], qm + ((kk * 16 * ROW_BYTES) >> 4));
            wgmma_commit();
            wgmma_wait<0>();
            mbar_arrive(empty(s));
        }
        fence_regs(dka);
        fence_regs(dva);
        // every product on this piece's K and V has retired
        mbar_arrive(kvfree);

        // a thread holds rows key0 + 8 r, head dims 8 j + 2 quad + {0, 1}
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int key = key0 + 8 * r;
            if (key >= Sk) continue;
            if (w.slot >= 0) {
                float* pk = part + (long long)w.slot * 2 * BKV * HD
                          + (long long)(key - w.k0) * HD;
                float* pv = pk + BKV * HD;
#pragma unroll
                for (int j = 0; j < HD / 8; ++j) {
                    const int n = j * 4 + 2 * r, d = j * 8 + 2 * quad;
                    *reinterpret_cast<float2*>(pk + d) = make_float2(dka[n], dka[n + 1]);
                    *reinterpret_cast<float2*>(pv + d) = make_float2(dva[n], dva[n + 1]);
                }
            } else {
                __nv_bfloat16* pk = dk + w.b * st.dk[0] + w.hk * st.dk[1] + key * st.dk[2];
                __nv_bfloat16* pv = dv + w.b * st.dv[0] + w.hk * st.dv[1] + key * st.dv[2];
#pragma unroll
                for (int j = 0; j < HD / 8; ++j) {
                    const int n = j * 4 + 2 * r, d = j * 8 + 2 * quad;
                    *reinterpret_cast<uint32_t*>(pk + d) =
                        pack_bf16(dka[n] * scale, dka[n + 1] * scale);
                    *reinterpret_cast<uint32_t*>(pv + d) = pack_bf16(dva[n], dva[n + 1]);
                }
            }
        }
    }
}

// (c) the cut kv tiles' partials summed in slot order: dK (times scale)
// and dV of each tile's BKV keys.  A thread takes 8 head dims (16 bytes
// out), HD / 8 threads a row; the loads of every piece are independent
template <int HD>
__global__ void __launch_bounds__(SUM_THREADS)
fa_bwd_wgmma_sum_kernel(const float* __restrict__ part,
                        __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, KvStrides st,
                        int Hkv, int Sk, float scale,
                        const __grid_constant__ SumTable tab) {
    constexpr int BKV = Cfg<HD>::BKV, LANES = HD / 8;
    constexpr int ROWS = SUM_THREADS / LANES, BLOCKS = BKV / ROWS;
    const SumEntry e = tab.e[blockIdx.x / (2 * BLOCKS)];
    const int w = blockIdx.x / BLOCKS % 2;               // 0 dK, 1 dV
    const int r = blockIdx.x % BLOCKS * ROWS + threadIdx.x / LANES;
    const int d = threadIdx.x % LANES * 8;
    const int nk = (Sk + BKV - 1) / BKV, bhk = e.item / nk;
    const int key = e.item % nk * BKV + r;
    if (key >= Sk) return;
    const float* src = part + ((long long)e.slot0 * 2 + w) * BKV * HD
                     + (long long)r * HD + d;
    float acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.f;
#pragma unroll 4
    for (int c = 0; c < e.count; ++c) {
        const float4* p = reinterpret_cast<const float4*>(src + (long long)c * 2 * BKV * HD);
        const float4 x = p[0], y = p[1];
        acc[0] += x.x; acc[1] += x.y; acc[2] += x.z; acc[3] += x.w;
        acc[4] += y.x; acc[5] += y.y; acc[6] += y.z; acc[7] += y.w;
    }
    const float m = w ? 1.f : scale;
    uint4 out;
    out.x = pack_bf16(acc[0] * m, acc[1] * m);
    out.y = pack_bf16(acc[2] * m, acc[3] * m);
    out.z = pack_bf16(acc[4] * m, acc[5] * m);
    out.w = pack_bf16(acc[6] * m, acc[7] * m);
    const long long* s3 = w ? st.dv : st.dk;
    __nv_bfloat16* dst = (w ? dv : dk) + bhk / Hkv * s3[0] + bhk % Hkv * s3[1]
                       + key * s3[2] + d;
    *reinterpret_cast<uint4*>(dst) = out;
}

// (d) dQ of one (batch, q head, 128 q rows): walks the kv tiles up to the
// forward's causal bound, S and dP recomputed
template <int HD>
__global__ void __launch_bounds__(NTHREADS, 1)
fa_bwd_wgmma_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap gmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const float* __restrict__ stats,
                       __nv_bfloat16* __restrict__ dq, RowStrides sdq, int H,
                       int group, int S, int Sk, int NQ, int causal,
                       float scale_log2, float scale) {
    using L = DqLayout<HD>;
    constexpr int BK = Cfg<HD>::BK, ST = L::ST;
    constexpr int ON = HD / 2, SN = BK / 2;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
    const uint32_t sq = base + L::Q_OFF, sg = base + L::G_OFF,
                   sk = base + L::K_OFF, sv = base + L::V_OFF,
                   bars = base + L::BAR_OFF;
    // barriers: Q and dout; then per stage full (K and V), empty
    const uint32_t qbar = bars;
    auto full = [&](int s) { return bars + 8 * (1 + s); };
    auto empty = [&](int s) { return bars + 8 * (1 + ST + s); };

    const int bh = blockIdx.x, b = bh / H, h = bh % H, hk = h / group;
    const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ_DQ;   // last q tile first
    int nkv = (Sk + BK - 1) / BK;
    if (causal) nkv = min(nkv, (min(q0 + BQ_DQ, S) - 1) / BK + 1);

    if (threadIdx.x == 0) {
        mbar_init(qbar, 1);
        for (int s = 0; s < ST; ++s) {
            mbar_init(full(s), 1);
            mbar_init(empty(s), NCONS * 128);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
    if (wg == NCONS) {
        // ---- producer warpgroup: one thread issues every TMA load --------
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(PRODUCER_REGS));
        if (threadIdx.x == NCONS * 128) {
            mbar_expect_tx(qbar, 2 * L::T_BYTES);
#pragma unroll
            for (int c = 0; c < HD / CHUNK; ++c)
#pragma unroll
                for (int w = 0; w < NCONS; ++w) {
                    const uint32_t off = c * BQ_DQ * ROW_BYTES + w * BQ * ROW_BYTES;
                    tma_load(sq + off, &qmap, qbar, c * CHUNK, q0 + w * BQ, h, b);
                    tma_load(sg + off, &gmap, qbar, c * CHUNK, q0 + w * BQ, h, b);
                }
            for (int j = 0; j < nkv; ++j) {
                const int s = j % ST;
                mbar_wait(empty(s), ((j / ST) & 1) ^ 1);
                mbar_expect_tx(full(s), 2 * L::KV_BYTES);
#pragma unroll
                for (int c = 0; c < HD / CHUNK; ++c) {
                    tma_load(sk + s * L::KV_BYTES + c * BK * ROW_BYTES, &kmap,
                             full(s), c * CHUNK, j * BK, hk, b);
                    tma_load(sv + s * L::KV_BYTES + c * BK * ROW_BYTES, &vmap,
                             full(s), c * CHUNK, j * BK, hk, b);
                }
            }
        }
    } else {
        // ---- consumer warpgroup wg: q rows q0 + 64 wg .. + 63 ------------
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(CONSUMER_REGS));
        const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32, quad = lane % 4;
        const int first = q0 + wg * BQ;
        const int row0 = first + warp * 16 + lane / 4;   // rows row0, row0 + 8
        const float* stt = stats + ((long long)bh * NQ + first / BQ) * 2 * BQ
                         + warp * 16 + lane / 4;
        const float lse2[2] = {stt[0], stt[8]}, dd[2] = {stt[BQ], stt[BQ + 8]};
        // rows past S have no gradient; tiles past the last row are masked
        const int nkw = first >= S ? 0
                      : causal ? min(nkv, (first + BQ - 1) / BK + 1) : nkv;
        const uint64_t qd = smem_desc(sq + wg * BQ * ROW_BYTES, 16, 1024),
                       gd = smem_desc(sg + wg * BQ * ROW_BYTES, 16, 1024);
        float dqa[ON], sc[SN], dp[SN];
        uint32_t pd[BK / 16][4];
#pragma unroll
        for (int i = 0; i < ON; ++i) dqa[i] = 0.f;
        mbar_wait(qbar, 0);
        int pending = -1;           // the stage whose dQ product is in flight
        for (int j = 0; j < nkw; ++j) {
            const int s = j % ST, k0 = j * BK;
            mbar_wait(full(s), (j / ST) & 1);
            const uint32_t ks = sk + s * L::KV_BYTES, vs = sv + s * L::KV_BYTES;
            const uint64_t kd = smem_desc(ks, 16, 1024), vd = smem_desc(vs, 16, 1024);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk) {
                const uint32_t off = (kk % 4) * 32;
                Wgmma<BK>::ss(sc, qd + (((kk / 4) * BQ_DQ * ROW_BYTES + off) >> 4),
                              kd + (((kk / 4) * BK * ROW_BYTES + off) >> 4), kk > 0);
            }
            wgmma_commit();
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk) {
                const uint32_t off = (kk % 4) * 32;
                Wgmma<BK>::ss(dp, gd + (((kk / 4) * BQ_DQ * ROW_BYTES + off) >> 4),
                              vd + (((kk / 4) * BK * ROW_BYTES + off) >> 4), kk > 0);
            }
            wgmma_commit();
            // S (and the last tile's dQ product) retired; dP in flight
            wgmma_wait<1>();
            fence_regs(sc);
            if (pending >= 0) {
                mbar_arrive(empty(pending));
                pending = -1;
            }
            const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > first);
#pragma unroll
            for (int n = 0; n < SN; ++n) {
                const int i = (n >> 1) & 1;
                const int col = k0 + (n >> 2) * 8 + 2 * quad + (n & 1);
                float p = ex2(fmaf(sc[n], scale_log2, -lse2[i]));
                if (edge && (col >= Sk || (causal && col > row0 + 8 * i))) p = 0.f;
                sc[n] = p;
            }
            wgmma_wait<0>();
            fence_regs(dp);
#pragma unroll
            for (int n = 0; n < SN; ++n) sc[n] *= dp[n] - dd[(n >> 1) & 1];
            pack_a<BK>(sc, pd);
            // dQ += dS K: K MN-major (hd contiguous): 16 keys a k-step, the
            // next 64 head dims BK rows further
            const uint64_t km = smem_desc(ks, BK * ROW_BYTES, 1024);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk)
                Wgmma<HD>::rs(dqa, pd[kk], km + ((kk * 16 * ROW_BYTES) >> 4));
            wgmma_commit();
            if (Cfg<HD>::DQ_OVERLAP) {
                pending = s;
            } else {
                wgmma_wait<0>();
                fence_regs(dqa);
                mbar_arrive(empty(s));
            }
        }
        wgmma_wait<0>();
        fence_regs(dqa);
        if (pending >= 0) mbar_arrive(empty(pending));
        for (int j = nkw; j < nkv; ++j) {
            const int s = j % ST;
            mbar_wait(full(s), (j / ST) & 1);
            mbar_arrive(empty(s));
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int row = row0 + 8 * i;
            if (row >= S) continue;
            __nv_bfloat16* p = dq + b * sdq.s[0] + h * sdq.s[1] + row * sdq.s[2];
#pragma unroll
            for (int j = 0; j < HD / 8; ++j) {
                const int n = j * 4 + 2 * i;
                *reinterpret_cast<uint32_t*>(p + j * 8 + 2 * quad) =
                    pack_bf16(dqa[n] * scale, dqa[n + 1] * scale);
            }
        }
    }
}

// ---------------------------------------------------------------------------
// bf16 at hd 256: pieces of walks, four products a kept score in dK/dV
// ---------------------------------------------------------------------------

constexpr int HD256 = 256;
constexpr int UNIT = 64;                   // q rows of a dQ warpgroup's unit
constexpr int BKV256 = 64, BK256 = 32;     // keys of a dK/dV tile, a dQ step
constexpr int P_BYTES = 64 * 64 * 4;       // P^T of a step, fp32
constexpr int SUM_ROWS = 8;                // rows of a sum block, a warp each
// two consumer warpgroups and no producer: ptxas allocates one register
// count for the whole kernel from its launch bounds (whatever setmaxnreg
// asks for later) and a block's warps in fours, so 256 threads leave 255
// registers a thread where 384 (or 288) leave 168, under the 128
// accumulators of dK, dV or dQ with the scores'
constexpr int NTHREADS256 = NCONS * 128;

// a block's piece of item `item`: steps [start, stop); slot -1 where that
// is the item's whole walk, else the fp32 partial it writes
struct Piece { int item, start, stop, slot; };
// n = 0: no table, block x takes item x's whole walk (dQ: each (batch, kv
// head)'s pairs last-first)
struct PieceTable { int n; Piece p[MAX_PIECES]; };

// dK/dV at hd 256: K and V (64 keys), per stage Q, dout (64 rows) and the
// statistics, then two buffers of P^T handed from the dV warpgroup to the
// dK one
struct Dkdv256 {
    static constexpr int ST = 2;
    static constexpr int KV_BYTES = BKV256 * HD256 * 2;
    static constexpr int T_BYTES = BQ * HD256 * 2;
    static constexpr int K_OFF = 0, V_OFF = KV_BYTES;
    static constexpr int Q_OFF = 2 * KV_BYTES;
    static constexpr int G_OFF = Q_OFF + ST * T_BYTES;
    static constexpr int ST_OFF = G_OFF + ST * T_BYTES;
    static constexpr int P_OFF = ST_OFF + ST * STATS_BYTES;
    static constexpr int BAR_OFF = P_OFF + 2 * P_BYTES;
    static constexpr int NBARS = 1 + 2 * ST + 4;
    static constexpr int SMEM = BAR_OFF + NBARS * 8 + 1024;
    static_assert(SMEM <= 232448, "tiles exceed a block's shared memory");
};

// dQ at hd 256: Q and dout of the pair's two units (128 rows), then per
// stage K and V (32 keys)
struct Dq256 {
    static constexpr int ST = 3;
    static constexpr int T_BYTES = 2 * UNIT * HD256 * 2;
    static constexpr int KV_BYTES = BK256 * HD256 * 2;
    static constexpr int Q_OFF = 0, G_OFF = T_BYTES;
    static constexpr int K_OFF = 2 * T_BYTES;
    static constexpr int V_OFF = K_OFF + ST * KV_BYTES;
    static constexpr int BAR_OFF = V_OFF + ST * KV_BYTES;
    static constexpr int NBARS = 1 + 2 * ST;
    static constexpr int SMEM = BAR_OFF + NBARS * 8 + 1024;
    static_assert(SMEM <= 232448, "tiles exceed a block's shared memory");
};

// steps of 32 keys that q rows [64 p, 64 p + 64) walk
__device__ __forceinline__ int unit_steps(int p, int S, int Sk, int causal) {
    const int nk = (Sk + BK256 - 1) / BK256;
    return causal ? min(nk, (min(UNIT * (p + 1), S) - 1) / BK256 + 1) : nk;
}

// a thread's rows key0 (+ 8) of a 64 x 256 accumulator: bf16 through
// strides (times mult) or, with a slot, fp32 into its partial tile
__device__ __forceinline__ void store_rows(const float (&acc)[128], int key0,
                                           int rows_end, int quad,
                                           float* part_tile, int tile_row0,
                                           __nv_bfloat16* dst0,
                                           long long row_stride, float mult) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int key = key0 + 8 * i;
        if (key >= rows_end) continue;
        if (part_tile != nullptr) {
            float* pp = part_tile + (long long)(key - tile_row0) * HD256;
#pragma unroll
            for (int j = 0; j < HD256 / 8; ++j) {
                const int n = j * 4 + 2 * i;
                *reinterpret_cast<float2*>(pp + j * 8 + 2 * quad) =
                    make_float2(acc[n], acc[n + 1]);
            }
        } else {
            __nv_bfloat16* pp = dst0 + key * row_stride;
#pragma unroll
            for (int j = 0; j < HD256 / 8; ++j) {
                const int n = j * 4 + 2 * i;
                *reinterpret_cast<uint32_t*>(pp + j * 8 + 2 * quad) =
                    pack_bf16(acc[n] * mult, acc[n + 1] * mult);
            }
        }
    }
}

// (b') dK and dV of one piece of a kv tile of 64 keys: steps [start, stop)
// of its walk over the group's q heads, each head's q tiles of 64 rows
// (step g per + qt - first).  Warpgroup 0 computes S^T = K Q^T, P^T and
// dV += P^T dout; it hands P^T (fp32) to warpgroup 1 through one of two
// shared buffers; warpgroup 1 computes dP^T = V dout^T, dS^T = P^T (dP^T -
// D) and dK += dS^T Q.  Four products of 2 hd a kept score, 128 fp32
// accumulators a thread in each.
__global__ void __launch_bounds__(NTHREADS256, 1)
fa_bwd_wgmma_hd256_dkdv_kernel(const __grid_constant__ CUtensorMap qmap,
                               const __grid_constant__ CUtensorMap gmap,
                               const __grid_constant__ CUtensorMap kmap,
                               const __grid_constant__ CUtensorMap vmap,
                               const float* __restrict__ stats,
                               __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv,
                               float* __restrict__ part, KvStrides st, int H,
                               int Hkv, int group, int S, int Sk, int NQ,
                               int causal, float scale_log2, float scale,
                               const __grid_constant__ PieceTable tab) {
    using L = Dkdv256;
    constexpr int HD = HD256, ST = L::ST;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023) & ~1023u;
    uint8_t* gbase = smem_raw + (base - raw);
    const uint32_t sk = base + L::K_OFF, sv = base + L::V_OFF,
                   sq = base + L::Q_OFF, sg = base + L::G_OFF,
                   sst = base + L::ST_OFF, bars = base + L::BAR_OFF;
    // barriers: K and V; per stage full, empty; per P buffer full, empty
    const uint32_t kvbar = bars;
    auto full = [&](int s) { return bars + 8 * (1 + s); };
    auto empty = [&](int s) { return bars + 8 * (1 + ST + s); };
    auto pfull = [&](int s) { return bars + 8 * (1 + 2 * ST + s); };
    auto pempty = [&](int s) { return bars + 8 * (3 + 2 * ST + s); };

    const int nk = (Sk + BKV256 - 1) / BKV256, nq = (S + BQ - 1) / BQ;
    int item = blockIdx.x, i0 = 0, i1 = -1, slot = -1;
    if (tab.n) {
        const Piece pc = tab.p[blockIdx.x];
        item = pc.item, i0 = pc.start, i1 = pc.stop, slot = pc.slot;
    }
    const int bhk = item / nk, tk = item % nk;
    const int b = bhk / Hkv, hk = bhk % Hkv, k0 = tk * BKV256;
    const int first = causal ? min(tk, nq) : 0, per = nq - first;
    if (i1 < 0) i1 = group * per;
    const int steps = i1 - i0;

    if (threadIdx.x == 0) {
        mbar_init(kvbar, 1);
        for (int s = 0; s < ST; ++s) {
            mbar_init(full(s), 1);
            mbar_init(empty(s), NCONS * 128);
        }
        for (int s = 0; s < 2; ++s) {
            mbar_init(pfull(s), 128);
            mbar_init(pempty(s), 128);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    // thread 0 of the dK warpgroup (1), which trails the dV one, issues
    // every load: K and V and the first ST steps, then step jj + ST once it
    // has released step jj, waiting there for warpgroup 0
    const bool loader = threadIdx.x == (NCONS - 1) * 128;
    auto load_step = [&](int jj) {         // step i0 + jj, stage jj % ST
        const int it = i0 + jj, s = jj % ST;
        const int h = hk * group + it / per, qt = first + it % per;
        mbar_wait(empty(s), ((jj / ST) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * L::T_BYTES + STATS_BYTES);
#pragma unroll
        for (int c = 0; c < HD / CHUNK; ++c) {
            tma_load(sq + s * L::T_BYTES + c * BQ * ROW_BYTES, &qmap,
                     full(s), c * CHUNK, qt * BQ, h, b);
            tma_load(sg + s * L::T_BYTES + c * BQ * ROW_BYTES, &gmap,
                     full(s), c * CHUNK, qt * BQ, h, b);
        }
        bulk_load(sst + s * STATS_BYTES,
                  stats + ((long long)(b * H + h) * NQ + qt) * 2 * BQ,
                  STATS_BYTES, full(s));
    };
    if (loader) {
        mbar_expect_tx(kvbar, 2 * L::KV_BYTES);
#pragma unroll
        for (int c = 0; c < HD / CHUNK; ++c) {
            tma_load(sk + c * BKV256 * ROW_BYTES, &kmap, kvbar, c * CHUNK, k0, hk, b);
            tma_load(sv + c * BKV256 * ROW_BYTES, &vmap, kvbar, c * CHUNK, k0, hk, b);
        }
        for (int jj = 0; jj < min(ST, steps); ++jj) load_step(jj);
    }
    __syncwarp();
    const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
    // ---- consumer warpgroups: the tile's 64 keys, dV (0) or dK (1) -------
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32, quad = lane % 4;
    const int key0 = k0 + warp * 16 + lane / 4;       // keys key0, key0 + 8
    float acc[HD / 2], sc[32];
    uint32_t pa[4][4];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    mbar_wait(kvbar, 0);
    // S^T = K Q^T (warpgroup 0) or dP^T = V dout^T (1): K-major operands,
    // the tile's 64 rows of K or V against the stage's 64 rows of Q or dout
    const uint64_t ad = smem_desc(wg == 0 ? sk : sv, 16, 1024);
    for (int jj = 0; jj < steps; ++jj) {
        const int it = i0 + jj, s = jj % ST, pb = jj % 2;
        const int q0 = (first + it % per) * BQ;
        mbar_wait(full(s), (jj / ST) & 1);
        const uint32_t qs = sq + s * L::T_BYTES, gs = sg + s * L::T_BYTES;
        const float* stt = reinterpret_cast<const float*>(
            gbase + L::ST_OFF + s * STATS_BYTES);
        float* pbuf = reinterpret_cast<float*>(gbase + L::P_OFF + pb * P_BYTES);
        const uint64_t bd = smem_desc(wg == 0 ? qs : gs, 16, 1024);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
            const uint32_t off = (kk % 4) * 32;
            Wgmma<64>::ss(sc, ad + (((kk / 4) * BKV256 * ROW_BYTES + off) >> 4),
                          bd + (((kk / 4) * BQ * ROW_BYTES + off) >> 4), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        // a thread holds keys key0 (+8) against q rows q0 + 8 (n / 4) +
        // 2 quad + (n & 1)
        if (wg == 0) {
            const bool edge = causal && q0 < k0 + BKV256 - 1;
#pragma unroll
            for (int n = 0; n < 32; ++n) {
                const int col = (n >> 2) * 8 + 2 * quad + (n & 1);
                float p = ex2(fmaf(sc[n], scale_log2, -stt[col]));
                if (edge && key0 + 8 * ((n >> 1) & 1) > q0 + col) p = 0.f;
                sc[n] = p;
            }
            mbar_wait(pempty(pb), ((jj / 2) & 1) ^ 1);
#pragma unroll
            for (int n = 0; n < 32; ++n) pbuf[n * 128 + t] = sc[n];
            mbar_arrive(pfull(pb));
        } else {
            mbar_wait(pfull(pb), (jj / 2) & 1);
#pragma unroll
            for (int n = 0; n < 32; ++n) {
                const int col = (n >> 2) * 8 + 2 * quad + (n & 1);
                sc[n] = pbuf[n * 128 + t] * (sc[n] - stt[BQ + col]);
            }
            mbar_arrive(pempty(pb));
        }
        pack_a<64>(sc, pa);
        // dV += P^T dout (0) or dK += dS^T Q (1): dout or Q MN-major, 16 q
        // rows (2 KB) a k-step, the next 64 head dims 64 rows further
        const uint64_t md = smem_desc(wg == 0 ? gs : qs, BQ * ROW_BYTES, 1024);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
            Wgmma<HD>::rs(acc, pa[kk], md + ((kk * 16 * ROW_BYTES) >> 4));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        mbar_arrive(empty(s));
        if (loader && jj + ST < steps) load_step(jj + ST);
        __syncwarp();
    }
    // dK's partials (which 0) then dV's (1) of a slot, 64 keys x 256 each
    const long long n_tile = (long long)BKV256 * HD;
    float* pt = slot < 0 ? nullptr : part + ((long long)slot * 2 + (wg == 0)) * n_tile;
    if (wg == 0)
        store_rows(acc, key0, Sk, quad, pt, k0,
                   dv + b * st.dv[0] + hk * st.dv[1], st.dv[2], 1.f);
    else
        store_rows(acc, key0, Sk, quad, pt, k0,
                   dk + b * st.dk[0] + hk * st.dk[1], st.dk[2], scale);
}

// (d') dQ of one piece of a pair of 64-row units (warpgroup w takes unit 2
// i + w: rows [64 p, 64 p + 64) of q head g, u = p G + g): kv steps of 32
// keys [start, stop), each warpgroup within its own unit's causal bound,
// S and dP recomputed; the dQ product of a step retires under the next
// step's S and dP
__global__ void __launch_bounds__(NTHREADS256, 1)
fa_bwd_wgmma_hd256_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap gmap,
                             const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap,
                             const float* __restrict__ stats,
                             __nv_bfloat16* __restrict__ dq,
                             float* __restrict__ part, RowStrides sdq, int H,
                             int Hkv, int group, int S, int Sk, int NQ,
                             int causal, float scale_log2, float scale,
                             const __grid_constant__ PieceTable tab) {
    using L = Dq256;
    constexpr int HD = HD256, BK = BK256, ST = L::ST;
    constexpr int ON = HD / 2, SN = BK / 2;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
    const uint32_t sq = base + L::Q_OFF, sg = base + L::G_OFF,
                   sk = base + L::K_OFF, sv = base + L::V_OFF,
                   bars = base + L::BAR_OFF;
    const uint32_t qbar = bars;
    auto full = [&](int s) { return bars + 8 * (1 + s); };
    auto empty = [&](int s) { return bars + 8 * (1 + ST + s); };

    const int U = (S + UNIT - 1) / UNIT * group, npair = (U + 1) / 2;
    int item, j0 = 0, j1 = -1, slot = -1;
    if (tab.n) {
        const Piece pc = tab.p[blockIdx.x];
        item = pc.item, j0 = pc.start, j1 = pc.stop, slot = pc.slot;
    } else {
        item = blockIdx.x / npair * npair + (npair - 1 - blockIdx.x % npair);
    }
    const int bhk = item / npair, pi = item % npair;
    const int b = bhk / Hkv, hk = bhk % Hkv;
    // warpgroup w's unit 2 i + w: its q head, position tile and walk (0:
    // none)
    auto head = [&](int w) { return hk * group + (2 * pi + w) % group; };
    auto tile = [&](int w) { return (2 * pi + w) / group; };
    auto walk = [&](int w) {
        return 2 * pi + w < U ? unit_steps((2 * pi + w) / group, S, Sk, causal) : 0;
    };
    if (j1 < 0) j1 = max(walk(0), walk(1));
    const int nsteps = j1 - j0;

    if (threadIdx.x == 0) {
        mbar_init(qbar, 1);
        for (int s = 0; s < ST; ++s) {
            mbar_init(full(s), 1);
            mbar_init(empty(s), NCONS * 128);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    // thread 0 of the last warpgroup issues every load: Q and dout of both
    // units and the first ST steps, then step jj + ST once it has released
    // step jj, waiting there for the first warpgroup
    const bool loader = threadIdx.x == (NCONS - 1) * 128;
    auto load_step = [&](int jj) {         // step j0 + jj, stage jj % ST
        const int j = j0 + jj, s = jj % ST;
        mbar_wait(empty(s), ((jj / ST) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * L::KV_BYTES);
#pragma unroll
        for (int c = 0; c < HD / CHUNK; ++c) {
            tma_load(sk + s * L::KV_BYTES + c * BK * ROW_BYTES, &kmap,
                     full(s), c * CHUNK, j * BK, hk, b);
            tma_load(sv + s * L::KV_BYTES + c * BK * ROW_BYTES, &vmap,
                     full(s), c * CHUNK, j * BK, hk, b);
        }
    };
    if (loader) {
        mbar_expect_tx(qbar, ((walk(1) > 0) + 1) * 2 * UNIT * HD * 2);
#pragma unroll
        for (int w = 0; w < NCONS; ++w) {
            if (walk(w) == 0) continue;
#pragma unroll
            for (int c = 0; c < HD / CHUNK; ++c) {
                const uint32_t off = c * 2 * UNIT * ROW_BYTES + w * UNIT * ROW_BYTES;
                tma_load(sq + off, &qmap, qbar, c * CHUNK, tile(w) * UNIT, head(w), b);
                tma_load(sg + off, &gmap, qbar, c * CHUNK, tile(w) * UNIT, head(w), b);
            }
        }
        for (int jj = 0; jj < min(ST, nsteps); ++jj) load_step(jj);
    }
    __syncwarp();
    // a warpgroup's release of step jj; the loader then issues step jj + ST
    auto release = [&](int jj) {
        mbar_arrive(empty(jj % ST));
        if (loader && jj + ST < nsteps) load_step(jj + ST);
    };
    const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
    // ---- consumer warpgroup wg: its unit's 64 rows ------------------------
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32, quad = lane % 4;
    const int h = head(wg), first = tile(wg) * UNIT, nw = walk(wg);
    const int row0 = first + warp * 16 + lane / 4;      // rows row0, row0 + 8
    const float* stt = stats + ((long long)(b * H + h) * NQ + tile(wg)) * 2 * BQ
                     + warp * 16 + lane / 4;
    float lse2[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};
    if (nw > 0) {
        lse2[0] = stt[0], lse2[1] = stt[8];
        dd[0] = stt[BQ], dd[1] = stt[BQ + 8];
    }
    const int ncomp = max(0, min(j1, nw) - j0);   // steps it computes
    const uint64_t qd = smem_desc(sq + wg * UNIT * ROW_BYTES, 16, 1024),
                   gd = smem_desc(sg + wg * UNIT * ROW_BYTES, 16, 1024);
    float dqa[ON], sc[SN], dp[SN];
    uint32_t pd[BK / 16][4];
#pragma unroll
    for (int i = 0; i < ON; ++i) dqa[i] = 0.f;
    mbar_wait(qbar, 0);
    int pending = -1;           // the step whose dQ product is in flight
    for (int jj = 0; jj < ncomp; ++jj) {
        const int s = jj % ST, k0 = (j0 + jj) * BK;
        mbar_wait(full(s), (jj / ST) & 1);
        const uint32_t ks = sk + s * L::KV_BYTES, vs = sv + s * L::KV_BYTES;
        const uint64_t kd = smem_desc(ks, 16, 1024), vd = smem_desc(vs, 16, 1024);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
            const uint32_t off = (kk % 4) * 32;
            Wgmma<BK>::ss(sc, qd + (((kk / 4) * 2 * UNIT * ROW_BYTES + off) >> 4),
                          kd + (((kk / 4) * BK * ROW_BYTES + off) >> 4), kk > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
            const uint32_t off = (kk % 4) * 32;
            Wgmma<BK>::ss(dp, gd + (((kk / 4) * 2 * UNIT * ROW_BYTES + off) >> 4),
                          vd + (((kk / 4) * BK * ROW_BYTES + off) >> 4), kk > 0);
        }
        wgmma_commit();
        // S (and the last step's dQ product) retired; dP in flight
        wgmma_wait<1>();
        fence_regs(sc);
        if (pending >= 0) release(pending);
        __syncwarp();
        const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > first);
#pragma unroll
        for (int n = 0; n < SN; ++n) {
            const int i = (n >> 1) & 1;
            const int col = k0 + (n >> 2) * 8 + 2 * quad + (n & 1);
            float p = ex2(fmaf(sc[n], scale_log2, -lse2[i]));
            if (edge && (col >= Sk || (causal && col > row0 + 8 * i))) p = 0.f;
            sc[n] = p;
        }
        wgmma_wait<0>();
        fence_regs(dp);
#pragma unroll
        for (int n = 0; n < SN; ++n) sc[n] *= dp[n] - dd[(n >> 1) & 1];
        pack_a<BK>(sc, pd);
        // dQ += dS K: K MN-major (hd contiguous): 16 keys a k-step, the
        // next 64 head dims BK rows further
        const uint64_t km = smem_desc(ks, BK * ROW_BYTES, 1024);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
            Wgmma<HD>::rs(dqa, pd[kk], km + ((kk * 16 * ROW_BYTES) >> 4));
        wgmma_commit();
        pending = jj;
    }
    wgmma_wait<0>();
    fence_regs(dqa);
    if (pending >= 0) release(pending);
    __syncwarp();
    for (int jj = ncomp; jj < nsteps; ++jj) {
        mbar_wait(full(jj % ST), (jj / ST) & 1);
        release(jj);
        __syncwarp();
    }
    if (nw == 0) return;
    float* pt = slot < 0 ? nullptr
              : part + ((long long)slot * 2 + wg) * UNIT * HD;
    store_rows(dqa, row0, S, quad, pt, first,
               dq + b * sdq.s[0] + h * sdq.s[1], sdq.s[2], scale);
}

// (c') the cut items' partials summed in slot order: dK (times scale) and
// dV of a kv tile (kind 0), or dQ (times scale) of a unit of a pair (kind
// 1).  A block takes SUM_ROWS rows of a tile, a warp a row, a lane 8 head
// dims (16 bytes out); the lanes' loads of every piece are independent
__global__ void __launch_bounds__(SUM_ROWS * 32)
fa_bwd_wgmma_hd256_sum_kernel(const float* __restrict__ part_kv,
                              const float* __restrict__ part_q,
                              __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv,
                              __nv_bfloat16* __restrict__ dq, KvStrides skv,
                              RowStrides sdq, int H, int Hkv, int group,
                              int S, int Sk, float scale,
                              const __grid_constant__ SumTable tab) {
    constexpr int BLOCKS = 64 / SUM_ROWS;               // blocks a tile
    const SumEntry e = tab.e[blockIdx.x / (2 * BLOCKS)];
    const int w = blockIdx.x / BLOCKS % 2;
    const int r = blockIdx.x % BLOCKS * SUM_ROWS + threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    __nv_bfloat16* dst;
    int row;
    float mult = scale;
    if (e.kind == 0) {
        const int nk = (Sk + BKV256 - 1) / BKV256;
        const int bhk = e.item / nk, b = bhk / Hkv, hk = bhk % Hkv;
        row = e.item % nk * BKV256 + r;
        if (row >= Sk) return;
        const long long* s3 = w ? skv.dv : skv.dk;
        dst = (w ? dv : dk) + b * s3[0] + hk * s3[1] + row * s3[2];
        if (w) mult = 1.f;
    } else {
        const int U = (S + UNIT - 1) / UNIT * group, npair = (U + 1) / 2;
        const int bhk = e.item / npair, u = 2 * (e.item % npair) + w;
        row = u / group * UNIT + r;
        if (u >= U || row >= S) return;
        const int b = bhk / Hkv, h = bhk % Hkv * group + u % group;
        dst = dq + b * sdq.s[0] + h * sdq.s[1] + row * sdq.s[2];
    }
    // a slot holds two 64 x 256 tiles: dK's then dV's, or the two units'
    const float* src = (e.kind == 0 ? part_kv : part_q)
                     + ((long long)e.slot0 * 2 + w) * 64 * HD256
                     + (long long)r * HD256 + lane * 8;
    float acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.f;
#pragma unroll 4
    for (int c = 0; c < e.count; ++c) {
        const float4* p = reinterpret_cast<const float4*>(src + (long long)c * 2 * 64 * HD256);
        const float4 x = p[0], y = p[1];
        acc[0] += x.x; acc[1] += x.y; acc[2] += x.z; acc[3] += x.w;
        acc[4] += y.x; acc[5] += y.y; acc[6] += y.z; acc[7] += y.w;
    }
    uint4 out;
    out.x = pack_bf16(acc[0] * mult, acc[1] * mult);
    out.y = pack_bf16(acc[2] * mult, acc[3] * mult);
    out.z = pack_bf16(acc[4] * mult, acc[5] * mult);
    out.w = pack_bf16(acc[6] * mult, acc[7] * mult);
    *reinterpret_cast<uint4*>(dst + lane * 8) = out;
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q);
#else
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &q);
#endif
        if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// a 4-D map over (hd, rows, heads, batch) with element strides st = (batch,
// head, row); boxes of 64 columns by box_rows rows, 128-byte swizzle; rows
// past the end read as zeros
int encode(CUtensorMap* map, const void* ptr, int hd, int rows, int heads,
           int batch, const long long* st, int box_rows) {
    EncodeTiled fn = encode_fn();
    if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
    const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)rows,
                                (cuuint64_t)heads, (cuuint64_t)batch};
    const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                   (cuuint64_t)st[0] * 2};
    const cuuint32_t box[4] = {CHUNK, (cuuint32_t)box_rows, 1, 1};
    const cuuint32_t estr[4] = {1, 1, 1, 1};
    const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                          const_cast<void*>(ptr), dims, strides, box, estr,
                          CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : ENCODE_FAILED + (int)r;
}

struct Args {
    const void *q, *k, *v, *o, *g;
    const float* lse;
    void *dq, *dk, *dv;
    float *stats, *part;
    int B, H, Hkv, S, Sk, causal;
    float scale;
    const long long* st;     // (batch, head, row) of q, k, v, o, g, dq, dk, dv
    const KvTable* tab;
    const SumTable* sums;
};

template <int HD>
int run(const Args& a, cudaStream_t stream) {
    using C = Cfg<HD>;
    const int G = a.H / a.Hkv, NQ = 2 * ((a.S + BQ_DQ - 1) / BQ_DQ);
    const float sl = a.scale * LOG2E;
    CUtensorMap qm, gm, kvm[2], kqm[2];
    int rc = encode(&qm, a.q, HD, a.S, a.H, a.B, a.st, BQ);
    if (!rc) rc = encode(&gm, a.g, HD, a.S, a.H, a.B, a.st + 12, BQ);
    if (!rc) rc = encode(&kvm[0], a.k, HD, a.Sk, a.Hkv, a.B, a.st + 3, C::BKV);
    if (!rc) rc = encode(&kvm[1], a.v, HD, a.Sk, a.Hkv, a.B, a.st + 6, C::BKV);
    if (!rc) rc = encode(&kqm[0], a.k, HD, a.Sk, a.Hkv, a.B, a.st + 3, C::BK);
    if (!rc) rc = encode(&kqm[1], a.v, HD, a.Sk, a.Hkv, a.B, a.st + 6, C::BK);
    if (rc) return rc;
    RowStrides so, sg, sdq;
    KvStrides skv;
    for (int i = 0; i < 3; ++i) {
        so.s[i] = a.st[9 + i];
        sg.s[i] = a.st[12 + i];
        sdq.s[i] = a.st[15 + i];
        skv.dk[i] = a.st[18 + i];
        skv.dv[i] = a.st[21 + i];
    }
    const long long rows = (long long)a.B * a.H * NQ * BQ;
    fa_bwd_wgmma_dot_kernel<<<(unsigned)((rows + DOT_WARPS - 1) / DOT_WARPS),
                              DOT_WARPS * 32, 0, stream>>>(
        (const __nv_bfloat16*)a.o, (const __nv_bfloat16*)a.g, a.lse, a.stats,
        so, sg, a.H, a.S, NQ, HD, rows);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    constexpr int smem_kv = DkdvLayout<HD>::SMEM;
    err = cudaFuncSetAttribute(fa_bwd_wgmma_dkdv_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
    if (err != cudaSuccess) return (int)err;
    const int nk = (a.Sk + C::BKV - 1) / C::BKV;
    fa_bwd_wgmma_dkdv_kernel<HD><<<a.tab->n ? a.tab->n : a.B * a.Hkv * nk,
                                   NTHREADS, smem_kv, stream>>>(
        qm, gm, kvm[0], kvm[1], a.stats, (__nv_bfloat16*)a.dk,
        (__nv_bfloat16*)a.dv, a.part, skv, a.H, a.Hkv, G, a.S, a.Sk, NQ,
        a.causal, sl, a.scale, *a.tab);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    if (a.sums->n) {
        constexpr int blocks = C::BKV / (SUM_THREADS / (HD / 8));
        fa_bwd_wgmma_sum_kernel<HD><<<2 * blocks * a.sums->n, SUM_THREADS, 0,
                                      stream>>>(
            a.part, (__nv_bfloat16*)a.dk, (__nv_bfloat16*)a.dv, skv, a.Hkv,
            a.Sk, a.scale, *a.sums);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }

    constexpr int smem_q = DqLayout<HD>::SMEM;
    err = cudaFuncSetAttribute(fa_bwd_wgmma_dq_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
    if (err != cudaSuccess) return (int)err;
    const dim3 gq(a.B * a.H, (a.S + BQ_DQ - 1) / BQ_DQ);
    fa_bwd_wgmma_dq_kernel<HD><<<gq, NTHREADS, smem_q, stream>>>(
        qm, gm, kqm[0], kqm[1], a.stats, (__nv_bfloat16*)a.dq, sdq, a.H, G,
        a.S, a.Sk, NQ, a.causal, sl, a.scale);
    return (int)cudaGetLastError();
}

}  // namespace

// q, out, dout, dq (B, H, S, hd); k, v, dk, dv (B, Hkv, Sk, hd), all bf16
// with element strides (batch, head, row) in `strides` (q, k, v, out, dout,
// dq, dk, dv: 24 values), unit-stride rows and 16-byte aligned strides; lse
// (B, H, S) fp32 contiguous; hd 64 or 128.  Scratch, fp32: stats (B*H, NQ,
// 2, 64) with NQ = 2 * ceil(S / 128).  The dK/dV schedule
// (flash_attention.dkdv_wrap): n_pieces (item, start, stop, slot) int
// quadruples in block order and n_offsets block offsets into them (n_offsets
// - 1 blocks; 0: no table, a block a kv tile); sums: nsums (item, first
// slot, count) triples of the cut tiles, whose pieces write part (slots, 2,
// 128, hd) fp32 (null where nsums is 0).  scale is hd^-0.5 as the caller
// rounds it to fp32.  Launches D, dK/dV, dQ and, where nsums > 0, the sum:
// 3 or 4 kernels on `stream`.
extern "C" int flash_attention_bwd_wgmma_bf16(
        const void* q, const void* k, const void* v, const void* o,
        const void* g, const float* lse, void* dq, void* dk, void* dv,
        float* stats, float* part, int B, int H, int Hkv, int S, int Sk,
        int hd, int causal, float scale, const long long* strides,
        const int* pieces, int n_pieces, const int* offsets, int n_offsets,
        const int* sums, int nsums, void* stream) {
    if (B < 1 || H < 1 || Hkv < 1 || H % Hkv || S < 1 || Sk < 1
        || n_pieces < 0 || n_pieces > 2 * MAX_PIECES || n_offsets < 0
        || n_offsets > MAX_PIECES + 1 || n_offsets == 1
        || (n_offsets > 0) != (n_pieces > 0) || nsums < 0
        || nsums > 2 * MAX_PIECES || (nsums > 0) != (part != nullptr))
        return (int)cudaErrorInvalidValue;
    // the tensor maps are encoded by the driver, which needs a current
    // context; a thread whose first CUDA work this is has none yet (an
    // autograd worker thread running this backward first), so bind the
    // current device's primary context, as a runtime launch would
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    KvTable tab;
    tab.n = n_offsets > 0 ? n_offsets - 1 : 0;
    for (int i = 0; i < n_offsets; ++i) {
        if (offsets[i] < 0 || offsets[i] > n_pieces
            || (i > 0 && offsets[i] < offsets[i - 1]))
            return (int)cudaErrorInvalidValue;
        tab.first[i] = (unsigned short)offsets[i];
    }
    for (int i = 0; i < n_pieces; ++i) {
        const int* e = pieces + 4 * i;
        if (e[0] < 0 || e[0] > 0xFFFF || e[1] < 0 || e[2] < e[1]
            || e[2] > 0xFFFF || e[3] < -1 || e[3] > 0x7FFF)
            return (int)cudaErrorInvalidValue;
        tab.p[i] = KvPiece{(unsigned short)e[0], (unsigned short)e[1],
                           (unsigned short)e[2], (short)e[3]};
    }
    SumTable sums_t;
    sums_t.n = nsums;
    for (int i = 0; i < nsums; ++i)
        sums_t.e[i] = SumEntry{(short)sums[3 * i], (short)sums[3 * i + 1],
                               (short)sums[3 * i + 2], 0};
    const Args a{q, k, v, o, g, lse, dq, dk, dv, stats, part, B, H, Hkv, S,
                 Sk, causal, scale, strides, &tab, &sums_t};
    cudaStream_t st = (cudaStream_t)stream;
    switch (hd) {
        case 64: return run<64>(a, st);
        case 128: return run<128>(a, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

// bf16 at hd 256: tensors, strides, lse and stats as
// flash_attention_bwd_wgmma_bf16's.  kv_pieces, q_pieces: the dK/dV and dQ
// kernels' (item, start, stop, slot) int quadruples, a block each (0: a
// block an item, its whole walk); sums: nsums (item, first slot, count,
// kind) quadruples for the sum kernel.  part_kv (slots, 2, 64, 256) and
// part_q (slots, 2, 64, 256) fp32 scratch.  Launches D, dK/dV, dQ and,
// where nsums > 0, the sum: 3 or 4 kernels on `stream`.
extern "C" int flash_attention_bwd_wgmma_hd256(
        const void* q, const void* k, const void* v, const void* o,
        const void* g, const float* lse, void* dq, void* dk, void* dv,
        float* stats, float* part_kv, float* part_q, int B, int H, int Hkv,
        int S, int Sk, int causal, float scale, const long long* strides,
        const int* kv_pieces, int n_kv, const int* q_pieces, int n_q,
        const int* sums, int nsums, void* stream) {
    if (B < 1 || H < 1 || Hkv < 1 || H % Hkv || S < 1 || Sk < 1
        || n_kv < 0 || n_kv > MAX_PIECES || n_q < 0 || n_q > MAX_PIECES
        || nsums < 0 || nsums > 2 * MAX_PIECES)
        return (int)cudaErrorInvalidValue;
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    constexpr int HD = HD256;
    const int G = H / Hkv, NQ = 2 * ((S + BQ_DQ - 1) / BQ_DQ);
    const float sl = scale * LOG2E;
    CUtensorMap qm, gm, km, vm, kqm, vqm;
    int rc = encode(&qm, q, HD, S, H, B, strides, BQ);
    if (!rc) rc = encode(&gm, g, HD, S, H, B, strides + 12, BQ);
    if (!rc) rc = encode(&km, k, HD, Sk, Hkv, B, strides + 3, BKV256);
    if (!rc) rc = encode(&vm, v, HD, Sk, Hkv, B, strides + 6, BKV256);
    if (!rc) rc = encode(&kqm, k, HD, Sk, Hkv, B, strides + 3, BK256);
    if (!rc) rc = encode(&vqm, v, HD, Sk, Hkv, B, strides + 6, BK256);
    if (rc) return rc;
    RowStrides so, sg, sdq;
    KvStrides skv;
    for (int i = 0; i < 3; ++i) {
        so.s[i] = strides[9 + i];
        sg.s[i] = strides[12 + i];
        sdq.s[i] = strides[15 + i];
        skv.dk[i] = strides[18 + i];
        skv.dv[i] = strides[21 + i];
    }
    cudaStream_t stream_ = (cudaStream_t)stream;
    const long long rows = (long long)B * H * NQ * BQ;
    fa_bwd_wgmma_dot_kernel<<<(unsigned)((rows + DOT_WARPS - 1) / DOT_WARPS),
                              DOT_WARPS * 32, 0, stream_>>>(
        (const __nv_bfloat16*)o, (const __nv_bfloat16*)g, lse, stats, so, sg,
        H, S, NQ, HD, rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    PieceTable tab;
    tab.n = n_kv;
    for (int i = 0; i < n_kv; ++i)
        tab.p[i] = Piece{kv_pieces[4 * i], kv_pieces[4 * i + 1],
                         kv_pieces[4 * i + 2], kv_pieces[4 * i + 3]};
    err = cudaFuncSetAttribute(fa_bwd_wgmma_hd256_dkdv_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Dkdv256::SMEM);
    if (err != cudaSuccess) return (int)err;
    const int nk = (Sk + BKV256 - 1) / BKV256;
    fa_bwd_wgmma_hd256_dkdv_kernel<<<n_kv ? n_kv : B * Hkv * nk, NTHREADS256,
                                     Dkdv256::SMEM, stream_>>>(
        qm, gm, km, vm, stats, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv,
        part_kv, skv, H, Hkv, G, S, Sk, NQ, causal, sl, scale, tab);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    tab.n = n_q;
    for (int i = 0; i < n_q; ++i)
        tab.p[i] = Piece{q_pieces[4 * i], q_pieces[4 * i + 1],
                         q_pieces[4 * i + 2], q_pieces[4 * i + 3]};
    err = cudaFuncSetAttribute(fa_bwd_wgmma_hd256_dq_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Dq256::SMEM);
    if (err != cudaSuccess) return (int)err;
    const int U = (S + UNIT - 1) / UNIT * G, npair = (U + 1) / 2;
    fa_bwd_wgmma_hd256_dq_kernel<<<n_q ? n_q : B * Hkv * npair, NTHREADS256,
                                   Dq256::SMEM, stream_>>>(
        qm, gm, kqm, vqm, stats, (__nv_bfloat16*)dq, part_q, sdq, H, Hkv, G,
        S, Sk, NQ, causal, sl, scale, tab);
    err = cudaGetLastError();
    if (err != cudaSuccess || nsums == 0) return (int)err;

    SumTable sums_t;
    sums_t.n = nsums;
    for (int i = 0; i < nsums; ++i)
        sums_t.e[i] = SumEntry{(short)sums[4 * i], (short)sums[4 * i + 1],
                               (short)sums[4 * i + 2], (short)sums[4 * i + 3]};
    fa_bwd_wgmma_hd256_sum_kernel<<<2 * nsums * (64 / SUM_ROWS), SUM_ROWS * 32,
                                    0, stream_>>>(
        part_kv, part_q, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv,
        (__nv_bfloat16*)dq, skv, sdq, H, Hkv, G, S, Sk, scale, sums_t);
    return (int)cudaGetLastError();
}

// the dynamic shared memory of the dK/dV (which 0) or dQ (1) kernel at hd
extern "C" int flash_attention_bwd_wgmma_smem(int hd, int which) {
    switch (hd) {
        case 64: return which ? DqLayout<64>::SMEM : DkdvLayout<64>::SMEM;
        case 128: return which ? DqLayout<128>::SMEM : DkdvLayout<128>::SMEM;
        case 256: return which ? Dq256::SMEM : Dkdv256::SMEM;
        default: return -1;
    }
}

extern "C" const char* repro_error_string(int e) {
    if (e >= ENCODE_FAILED)
        return "cuTensorMapEncodeTiled refused the tensor map (CUresult = "
               "code - 10000)";
    return cudaGetErrorString((cudaError_t)e);
}
