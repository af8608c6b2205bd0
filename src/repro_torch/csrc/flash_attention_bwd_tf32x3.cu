// Flash attention, backward, float32, on Hopper's tensor cores (wgmma)
// through error-compensated TF32 ("3xTF32"), deterministic, with
// grouped-query attention and strided layouts read natively.
//
// Replaces: no TPU kernel.  The JAX package differentiates its attention
// (src/repro/models/layers.py::_sdpa and _sdpa_chunked) with jax.grad and has
// no Pallas VJP; its Pallas forward is
// src/repro/kernels/flash_attention.py::_fa_kernel (line 22).  This is the
// gradient of the port's f32 forward (flash_attention_tf32x3.cu) at head dims
// 64, 128 and 256 (hd 256 in kernels of its own, the last section below);
// hd 16 and 32 run flash_attention_bwd.cu, bf16 at 64-256
// flash_attention_bwd_wgmma.cu.
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
// with dK and dV summed over the G q heads of each kv head; every input,
// score, accumulator and gradient fp32.
//
// Bound on Hopper: operations.  Five products of 2*hd flops per kept score:
// at llama3-8b's q (1, 32, 2048, 128) over 8 kv heads, causal, 85.9 GFLOP on
// 168 MB; in three TF32 passes at 495 TFLOP/s that is 0.521 ms (1.28 ms on
// the fp32 CUDA cores' 67 TFLOP/s).  This design does seven products (the dQ
// kernel recomputes S and dP, so that no gradient needs atomics): 0.729 ms.
//
// Design, point by point:
// * Every product is a wgmma with TF32 operands and fp32 accumulators in
//   registers, in three passes lo*hi + hi*lo + hi*hi, the small terms first,
//   as in flash_attention_tf32x3.cu: x = hi + lo with hi its TF32 part and
//   lo = rna_tf32(x - hi).
// * wgmma reads a 4-byte operand K-major only (it cannot transpose TF32, and
//   neither can TMA).  The scores run transposed in the dK/dV kernel, S^T =
//   K Q^T and dP^T = V dout^T, whose operands are K, V, Q and dout as they
//   lie (hd is the contraction); dV += P^T dout and dK += dS^T Q contract
//   over q rows, so they read dout^T and Q^T ([hd][q rows]).  In the dQ
//   kernel S = Q K^T and dP = dout V^T read the natural tiles and dQ += dS K
//   reads K^T.  Each transposed copy is written during the split, from the
//   same landed tile, 4 rows of one dim a thread into one 16-byte chunk.
// * The block's resident operand (K and V of a dK/dV block, Q and dout of a
//   dQ block) is split once: its hi part into the registers of the
//   warpgroup that reads it, as wgmma A fragments (64 registers a thread at
//   hd 128), its lo part into shared memory.  So the scores' two passes that
//   take A's hi part read only B from shared memory: at 16 q rows a step
//   the first version, which read A's hi and lo from shared memory in all
//   three passes, took 2.98 ms at llama3-8b's shape on an H100, this form
//   2.75.
// * The tensor cores read a TF32 operand truncated to its 19 high bits (on
//   an H100: 1 + 2^-11 + 2^-12 is read as 1, not as rna's 1 + 2^-10).  So a
//   dK/dV step's Q and dout rows land by 16-byte cp.async straight into the
//   swizzle, where they are the hi part of the scores' B operand as they
//   stand; the split writes only their lo part, x minus x truncated, and
//   the transposed copies.  That leaves room for 32 q rows a step at hd 128
//   (m64n32k8 for the scores: half the wgmma instructions a row of
//   m64n16k8's), and the next step's rows load as soon as this step's
//   scores have retired.  A dQ step takes 32 keys at hd 128 through a raw
//   stage loaded one step ahead.  16 rows or keys a step took 2.70 ms,
//   32 took 2.09 (same card, same call).
// * Two warpgroups with their own roles, so that one's softmax and split
//   arithmetic runs while the other's products are on the tensor cores, and
//   no product is computed twice.  dK/dV: warpgroup 0 computes S^T, forms
//   P^T (passed to warpgroup 1 through 8 KB of shared memory and a named
//   barrier) and accumulates dV; warpgroup 1 computes dP^T, forms dS^T and
//   accumulates dK.  dQ: warpgroup 0 computes S and P, warpgroup 1 dP, dS and
//   dQ.  P^T and dS^T come out in the accumulator layout, which is not
//   TF32's A-operand layout: quad shuffles move them (as the forward moves
//   P), and they are split in registers.
// * Accuracy: the tensor cores truncate as they accumulate, and dK and dV
//   sum 8,192 q rows at llama3-8b's shape.  Each step's product goes, 64
//   output dims at a time, to a fresh accumulator that is added to the fp32
//   running sum rounded to nearest; the scores keep their small terms in one
//   accumulator and the hi*hi products in two (half of hd each), added in
//   fp32, as the forward.  The first wgmma of a fresh accumulator takes it
//   as output only, so it holds no register between uses.
// * Shared memory (the `_smem` entry reports it): dK/dV 206,336 bytes at hd
//   128 (K and V lo 128 KB, a q tile's 8 copies 128 KB), 108,032 at hd 64;
//   dQ 205,824 at hd 128 (Q and dout lo 64 KB, a kv tile's 6 copies and its
//   raw rows 128 KB), 107,520 at hd 64.  hd 256 does not fit this form: K's
//   and V's hi parts would take 128 registers each beside 128 of dV or dK,
//   and K and V split in shared memory alone would take 256 KB; it has its
//   own (below).
// * No atomics, so every gradient is bitwise the same from call to call:
//   each dK/dV block sums its q heads in registers; where the grid would be
//   small the wrapper splits each group's q heads over `split` blocks, which
//   write fp32 partials that one more kernel sums in a fixed order.  Four
//   launches a call then, else three: D, dK/dV, dQ.
// * Causal: a dK/dV block starts at the q tile that holds its first key and
//   masks only tiles that cross the diagonal; a dQ block stops at kv tile
//   ((qi+1)*64 - 1)//BK, the forward's bound.  Rows past S carry lse = +inf
//   in the statistics, so their P is 0 without a mask; keys past Sk are
//   zero-filled, masked in dQ and never stored in dK/dV.
//
// hd 256 (fa_bwd_tf32x3_hd256_dkdv_kernel, fa_bwd_tf32x3_hd256_dq_kernel).
// Bound: at PaliGemma's q (1, 8, 1024, 256) over one kv head, causal, the
// five products are 10.7 GFLOP: 0.0651 ms in three TF32 passes at 495
// TFLOP/s.  A row of Q, dout, K or V is 1 KB raw, 2 KB split, so the form
// above cannot hold a 64-key block.  What fits:
// * dK/dV (64 keys): K and V stay raw in shared memory (128 KB), in an XOR
//   layout (16-byte chunk c of row r at c ^ (r % 8)) so that an A
//   fragment's eight rows fall in eight bank groups.  The tensor cores read
//   a TF32 operand truncated, so the raw rows are the hi part; K and V are
//   the A operands of S^T = K Q^T and dP^T = V dout^T, loaded a k-step at a
//   time (two k-steps a group, two register sets), their lo parts made in
//   registers.  A q step is 16 rows: Q's and dout's raw rows land by
//   cp.async in the swizzle (B's hi part), their lo parts go to a second
//   buffer, and the two buffers swap roles each step (the lo buffer is free
//   once the scores retire, so the next rows land there while this step's
//   accumulations run).  The accumulations run transposed, dV^T = dout^T P
//   and dK^T = Q^T dS (M = hd, four m64 chunks; A = dout^T and Q^T loaded
//   from the landed rows, so no transposed copy), with P^T and dS^T as B
//   ([key][q row], hi and lo, 32 KB).  Warpgroup 0 owns dV^T, warpgroup 1
//   dK^T (128 registers each).  230,656 bytes.
// * dQ (64 q rows): Q and dout raw in the XOR layout (128 KB) as the A
//   operands of S = Q K^T and dP = dout V^T; kv steps of 16 keys in two
//   swapping buffers as above; dQ^T = K^T dS^T with dS as B ([q row][key]),
//   each warpgroup two chunks of 64 head dims.  218,112 bytes.
// * Balance: a causal walk's longest tile is 16 times its shortest, so a
//   dK/dV block takes kv tiles j and nk - 1 - j, each over one half of the
//   q steps it keeps, and a dQ block q tiles nqt - 1 - j and j, each over
//   one half of its kv steps: at PaliGemma's shape 128 blocks of 34 steps
//   each, not 128 blocks of up to 64.  Every block writes fp32 partials
//   (dK/dV: 2 split parts a kv tile; dQ: 2 a row), which the sum kernel
//   adds in a fixed order: four launches a call at hd 256.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;              // two warpgroups, one role each
constexpr int BKV = 64;                    // keys of a dK/dV block
constexpr int BQ = 32;                     // q rows of a dK/dV step
constexpr int BQD = 64;                    // q rows of a dQ block
constexpr int BK = 32;                     // keys of a dQ step
constexpr int ROW = 128;                   // bytes of a 128-byte swizzled row
constexpr int STAT_TILE = 64;              // the statistics' rows are padded
constexpr int DOT_WARPS = 8;
constexpr int SUM_THREADS = 256;
constexpr int XCH_BAR = 1;                 // named barrier of the P exchange
constexpr int WG_BAR = 2;                  // + wg: one warpgroup's own barrier
constexpr int DS_BAR = 4;                  // hd 256's dQ: dS written

// dK/dV block: the lo part of K and V of 64 keys (their hi part lives in
// the warpgroups' registers); a q tile's Q and dout rows as cp.async lands
// them, in the swizzle (the tensor cores read a TF32 operand truncated to
// its 19 high bits, so the raw rows are the hi part of the B operands of
// S^T and dP^T), their lo parts, Q^T and dout^T split; the statistics (two
// buffers) and the P^T exchange.  Every tile 1024-byte aligned.
template <int HD>
struct KvLayout {
    static constexpr int KV_BYTES = BKV * HD * 4;      // one copy of K or V
    static constexpr int T_BYTES = BQ * HD * 4;        // one q-side copy
    static constexpr int KL = 0, VL = KV_BYTES;
    static constexpr int QN = 2 * KV_BYTES, QNL = QN + T_BYTES;   // Q rows
    static constexpr int GN = QNL + T_BYTES, GNL = GN + T_BYTES;  // dout rows
    static constexpr int QTH = GNL + T_BYTES, QTL = QTH + T_BYTES; // Q^T
    static constexpr int GTH = QTL + T_BYTES, GTL = GTH + T_BYTES; // dout^T
    static constexpr int STATS = GTL + T_BYTES;        // 2 x (lse[BQ], D[BQ])
    static constexpr int XCH = STATS + 4 * BQ * 4;     // P^T, fp32
    static constexpr int SMEM = XCH + BKV * BQ * 4 + 1024;
    // the raw K and V are staged where the q-side tiles go
    static_assert(STATS - QN >= 2 * KV_BYTES, "no room to stage K and V");
    static_assert(SMEM <= 232448, "tiles exceed a block's shared memory");
};

// dQ block: the lo part of Q and dout of 64 rows (their hi part in
// registers); a kv tile's K and V split, K^T split; the raw K and V rows and
// the P exchange
template <int HD>
struct QLayout {
    static constexpr int Q_BYTES = BQD * HD * 4;       // one copy of Q or dout
    static constexpr int T_BYTES = BK * HD * 4;        // one kv-side copy
    static constexpr int QL = 0, GL = Q_BYTES;
    static constexpr int KH = 2 * Q_BYTES, KL = KH + T_BYTES;
    static constexpr int VH = KL + T_BYTES, VL = VH + T_BYTES;
    static constexpr int KTH = VL + T_BYTES, KTL = KTH + T_BYTES;
    static constexpr int RAW = KTL + T_BYTES;          // raw K, then V
    static constexpr int XCH = RAW + 2 * T_BYTES;      // P, fp32
    static constexpr int SMEM = XCH + BQD * BK * 4 + 1024;
    // the raw Q and dout are staged where the kv-side copies go, beside the
    // raw stage that the first kv tile's loads fill meanwhile
    static_assert(RAW - KH >= 2 * Q_BYTES, "no room to stage Q and dout");
    static_assert(SMEM <= 232448, "tiles exceed a block's shared memory");
};

struct KvStrides {    // element strides (batch, head, row) of dk and dv
    long long dk[3], dv[3];
};

struct RowStrides {   // element strides (batch, head, row)
    long long s[3];
};

// ---- device helpers, as flash_attention_tf32x3.cu has them ---------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src,
                                           bool valid) {
    const int n = valid ? 16 : 0;        // 0 bytes read: the 16 are zeroed
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// rna_tf32: round the 13 low mantissa bits away, to nearest, ties away from
// zero (the same value as cvt.rna.tf32.f32)
__device__ __forceinline__ uint32_t rna_tf32(float x) {
    return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + (what TF32 cannot hold of lo)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
    hi = rna_tf32(x);
    lo = rna_tf32(__fsub_rn(x, __uint_as_float(hi)));
}

__device__ __forceinline__ void st_shared4(uint32_t addr, const uint32_t (&v)[4]) {
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};"
                 :: "r"(addr), "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
                 : "memory");
}

// four consecutive K elements (one 16-byte chunk of the swizzle) into
// their hi and lo copies
__device__ __forceinline__ void split4(const float (&x)[4], uint32_t hi_addr,
                                       uint32_t lo_addr) {
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split(x[i], hi[i], lo[i]);
    st_shared4(hi_addr, hi);
    st_shared4(lo_addr, lo);
}

// byte offset of element (r, k) of a K-major operand of R rows in the
// 128-byte swizzle wgmma reads: slabs of 32 columns, R rows of 128 bytes
// each, the 16-byte chunks of row r permuted by r % 8
template <int R>
__device__ __forceinline__ int tile_off(int r, int k) {
    return (k >> 5) * R * ROW + r * ROW + ((((k & 31) >> 2) ^ (r & 7)) << 4)
           + ((k & 3) << 2);
}

// wgmma shared-memory descriptor of such a tile (8 rows 1024 bytes apart)
__device__ __forceinline__ uint64_t tile_desc(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFF) >> 4)
         | (uint64_t)(16 >> 4) << 16           // leading offset: unused
         | (uint64_t)(1024 >> 4) << 32
         | (uint64_t)1 << 62;
}

// k-step ks (8 columns, 32 bytes) of such a tile, in the descriptor's
// 16-byte units
template <int R>
__device__ __forceinline__ constexpr uint32_t ks_off(int ks) {
    return ((ks / 4) * R * ROW + (ks % 4) * 32) >> 4;
}

// x, which the compiler must take as computed here (not hoisted, not known)
__device__ __forceinline__ uint64_t opaque(uint64_t x) {
    asm volatile("" : "+l"(x));
    return x;
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

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

// the two warpgroups' exchange: the writer arrives, the reader waits
__device__ __forceinline__ void xch_arrive() {
    asm volatile("bar.arrive %0, %1;" :: "n"(XCH_BAR), "n"(NTHREADS) : "memory");
}

__device__ __forceinline__ void xch_wait() {
    asm volatile("bar.sync %0, %1;" :: "n"(XCH_BAR), "n"(NTHREADS) : "memory");
}

// wgmma with TF32 operands: D(64xN, fp32) (+)= A(64x8) * B(Nx8)^T, B from
// shared memory (K-major), A from shared memory (SS) or registers (RS).
// INIT starts a fresh accumulator (D = A B^T), which the compiler then
// takes as written here and not read, so it holds no register before.
template <int N> struct WgmmaSS;
template <int N> struct WgmmaRS;

template <> struct WgmmaSS<32> {
    template <bool INIT>
    static __device__ __forceinline__ void run(float (&d)[16], uint64_t a, uint64_t b) {
        if constexpr (INIT)
            asm volatile(
                "{\n.reg .pred p;\n"
                "setp.ne.b32 p, %18, 0;\n"
                "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
                "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n}\n"
                : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15])
                : "l"(a), "l"(b), "r"(0));
        else
            asm volatile(
                "{\n.reg .pred p;\n"
                "setp.ne.b32 p, %18, 0;\n"
                "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
                "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n}\n"
                : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
                : "l"(a), "l"(b), "r"(1));
    }
};

template <> struct WgmmaRS<16> {
    template <bool INIT>
    static __device__ __forceinline__ void run(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
        if constexpr (INIT)
            asm volatile(
                "{\n.reg .pred p;\n"
                "setp.ne.b32 p, %13, 0;\n"
                "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
                "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
                : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7])
                : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
        else
            asm volatile(
                "{\n.reg .pred p;\n"
                "setp.ne.b32 p, %13, 0;\n"
                "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
                "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
                : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
                : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
    }
};

template <> struct WgmmaRS<32> {
    template <bool INIT>
    static __device__ __forceinline__ void run(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
        if constexpr (INIT)
            asm volatile(
                "{\n.reg .pred p;\n"
                "setp.ne.b32 p, %21, 0;\n"
                "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
                "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
                : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15])
                : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
        else
            asm volatile(
                "{\n.reg .pred p;\n"
                "setp.ne.b32 p, %21, 0;\n"
                "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
                "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
                : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
                : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
    }
};

template <> struct WgmmaRS<64> {
    template <bool INIT>
    static __device__ __forceinline__ void run(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
        if constexpr (INIT)
            asm volatile(
                "{\n.reg .pred p;\n"
                "setp.ne.b32 p, %37, 0;\n"
                "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
                "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
                : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
                : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
        else
            asm volatile(
                "{\n.reg .pred p;\n"
                "setp.ne.b32 p, %37, 0;\n"
                "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
                "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
                : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
                : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
    }
};

// A score tile (64 x N, 3xTF32, fp32): the small terms in `ss`, the hi*hi
// products of the first and second half of hd in `sa`, `sb`.  A (64 rows,
// the block's resident operand) has its hi part in registers (`ah`, A
// fragments of every k-step) and its lo part in shared memory at `al`; B (N
// rows) has both parts there; all K-major over HD columns.  One wgmma group.
template <int N, int HD>
__device__ __forceinline__ void scores(float (&ss)[N / 2], float (&sa)[N / 2],
                                       float (&sb)[N / 2],
                                       const uint32_t (&ah)[HD / 8][4], uint64_t al,
                                       uint64_t bh, uint64_t bl) {
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < HD / 8; ++ks) {
        const uint32_t bo = ks_off<N>(ks);
        if (ks == 0)
            WgmmaSS<N>::template run<true>(ss, al + ks_off<64>(ks), bh + bo);
        else
            WgmmaSS<N>::template run<false>(ss, al + ks_off<64>(ks), bh + bo);
        WgmmaRS<N>::template run<false>(ss, ah[ks], bl + bo);
    }
#pragma unroll
    for (int ks = 0; ks < HD / 8; ++ks) {
        const uint32_t bo = ks_off<N>(ks);
        if (ks == 0)
            WgmmaRS<N>::template run<true>(sa, ah[ks], bh + bo);
        else if (ks < HD / 16)
            WgmmaRS<N>::template run<false>(sa, ah[ks], bh + bo);
        else if (ks == HD / 16)
            WgmmaRS<N>::template run<true>(sb, ah[ks], bh + bo);
        else
            WgmmaRS<N>::template run<false>(sb, ah[ks], bh + bo);
    }
    wgmma_commit();
}

// the hi part of a resident operand (64 rows of HD floats, raw in shared
// memory) as this thread's TF32 A fragments, every k-step: rows 16 warp + g
// (+ 8), columns 8 ks + tg (+ 4)
template <int HD>
__device__ __forceinline__ void load_frags(uint32_t (&f)[HD / 8][4], const float* raw,
                                           int warp, int lane) {
    const float* r0 = raw + (warp * 16 + lane / 4) * HD + lane % 4;
    const float* r8 = r0 + 8 * HD;
#pragma unroll
    for (int ks = 0; ks < HD / 8; ++ks) {
        f[ks][0] = rna_tf32(r0[ks * 8]);
        f[ks][1] = rna_tf32(r8[ks * 8]);
        f[ks][2] = rna_tf32(r0[ks * 8 + 4]);
        f[ks][3] = rna_tf32(r8[ks * 8 + 4]);
    }
}

// a score tile in the accumulator layout (thread: rows g, g + 8; columns
// 8 nb + 2 tg + {0, 1}) as TF32 A fragments, hi and lo: k-step kk holds
// (g, 8kk + tg), (g + 8, .), (g, 8kk + tg + 4), (g + 8, .); element (g, 8kk
// + c) lives in the pair of lane 4g + c/2, so quad shuffles move it
template <int KS>
__device__ __forceinline__ void a_frags(const float (&sc)[4 * KS],
                                        uint32_t (&h)[KS][4], uint32_t (&l)[KS][4],
                                        int lane) {
    const int tg = lane & 3;
    const int srcA = (lane & ~3) | (tg >> 1), srcB = srcA + 2;
    const bool odd = tg & 1;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
        const float* s4 = sc + 4 * kk;
        const float x0 = __shfl_sync(0xffffffffu, s4[0], srcA);
        const float x1 = __shfl_sync(0xffffffffu, s4[1], srcA);
        const float y0 = __shfl_sync(0xffffffffu, s4[2], srcA);
        const float y1 = __shfl_sync(0xffffffffu, s4[3], srcA);
        const float z0 = __shfl_sync(0xffffffffu, s4[0], srcB);
        const float z1 = __shfl_sync(0xffffffffu, s4[1], srcB);
        const float w0 = __shfl_sync(0xffffffffu, s4[2], srcB);
        const float w1 = __shfl_sync(0xffffffffu, s4[3], srcB);
        split(odd ? x1 : x0, h[kk][0], l[kk][0]);
        split(odd ? y1 : y0, h[kk][1], l[kk][1]);
        split(odd ? z1 : z0, h[kk][2], l[kk][2]);
        split(odd ? w1 : w0, h[kk][3], l[kk][3]);
    }
}

// acc += A B^T over K = 8 KS columns, 64 of N at a time, each three
// passes into the fresh accumulator fr, added rounded to nearest: A from
// registers (hi, lo), B (N rows, K-major over 8 KS columns) at descriptors
// bh, bl
template <int N, int KS>
__device__ __forceinline__ void accumulate(float (&acc)[N / 2], float (&fr)[32],
                                           const uint32_t (&h)[KS][4],
                                           const uint32_t (&l)[KS][4],
                                           uint64_t bh, uint64_t bl) {
    constexpr uint32_t CHUNK = 64 * ROW >> 4;    // 64 rows of B
#pragma unroll
    for (int c = 0; c < N / 64; ++c) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
            const uint64_t o = c * CHUNK + ks_off<N>(kk);
            if (kk == 0)
                WgmmaRS<64>::template run<true>(fr, l[kk], bh + o);
            else
                WgmmaRS<64>::template run<false>(fr, l[kk], bh + o);
        }
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
            WgmmaRS<64>::template run<false>(fr, h[kk], bl + c * CHUNK + ks_off<N>(kk));
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
            WgmmaRS<64>::template run<false>(fr, h[kk], bh + c * CHUNK + ks_off<N>(kk));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(fr);
#pragma unroll
        for (int n = 0; n < 32; ++n) acc[c * 32 + n] = __fadd_rn(acc[c * 32 + n], fr[n]);
    }
}

// rows [r0, r0 + R) of one (batch, head) slice (row stride rs, HD floats a
// row) into a raw fp32 stage, rows past n zero-filled; threads tid0.. of
// `nthr`
template <int R, int HD>
__device__ __forceinline__ void load_raw(uint32_t dst, const float* src,
                                         long long rs, int r0, int n, int tid,
                                         int nthr) {
    constexpr int C4 = HD / 4;
    for (int e = tid; e < R * C4; e += nthr) {
        const int r = e / C4, d = (e % C4) * 4, gr = r0 + r;
        const bool ok = gr < n;
        cp_async16(dst + (r * HD + d) * 4, ok ? src + gr * rs + d : src, ok);
    }
}

// a raw tile (R rows of HD floats) into its hi and lo copies, natural (R
// rows, HD columns) at nh, nl (the lo copy alone without HI); and, with TR,
// transposed (HD rows, R columns) at th, tl
template <int R, int HD, bool HI, bool TR>
__device__ __forceinline__ void split_tile(const float* raw, uint32_t nh, uint32_t nl,
                                           uint32_t th, uint32_t tl, int tid) {
    constexpr int C4 = HD / 4, PER = R * C4 / NTHREADS;
    static_assert(R * C4 % NTHREADS == 0, "split work per thread");
#pragma unroll
    for (int i = 0; i < PER; ++i) {
        const int e = i * NTHREADS + tid;
        const int r = e / C4, d = (e % C4) * 4;          // 4 dims of a row
        const float4 x4 = *reinterpret_cast<const float4*>(raw + r * HD + d);
        const float x[4] = {x4.x, x4.y, x4.z, x4.w};
        const int off = tile_off<R>(r, d);
        if constexpr (HI) {
            split4(x, nh + off, nl + off);
        } else {
            uint32_t hi, lo[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) split(x[j], hi, lo[j]);
            st_shared4(nl + off, lo);
        }
    }
    if constexpr (TR) {
#pragma unroll
        for (int i = 0; i < PER; ++i) {
            const int e = i * NTHREADS + tid;
            const int r = (e / HD) * 4, d = e % HD;          // 4 rows of a dim
            const float* p = raw + r * HD + d;
            const float x[4] = {p[0], p[HD], p[2 * HD], p[3 * HD]};
            const int off = tile_off<HD>(d, r);
            split4(x, th + off, tl + off);
        }
    }
}

// a tile of R rows of HD floats as cp.async landed it in the swizzle (at
// `raw`, generic; its hi part as the tensor cores read it, truncated): its
// lo part (x minus x truncated, rounded to TF32) at nl, and the tile
// transposed (HD rows, R columns) split into hi and lo at th, tl
template <int R, int HD>
__device__ __forceinline__ void split_landed(const uint8_t* raw, uint32_t nl,
                                             uint32_t th, uint32_t tl, int tid) {
    constexpr int C4 = HD / 4, PER = R * C4 / NTHREADS;
    static_assert(R * C4 % NTHREADS == 0, "split work per thread");
#pragma unroll
    for (int i = 0; i < PER; ++i) {
        const int e = i * NTHREADS + tid;
        const int off = tile_off<R>(e / C4, (e % C4) * 4);   // 4 dims of a row
        const float4 x4 = *reinterpret_cast<const float4*>(raw + off);
        const float x[4] = {x4.x, x4.y, x4.z, x4.w};
        uint32_t lo[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
            lo[j] = rna_tf32(__fsub_rn(x[j], __uint_as_float(
                __float_as_uint(x[j]) & 0xffffe000u)));
        st_shared4(nl + off, lo);
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
        const int e = i * NTHREADS + tid;
        const int r = (e / HD) * 4, d = e % HD;          // 4 rows of a dim
        float x[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
            x[j] = *reinterpret_cast<const float*>(raw + tile_off<R>(r + j, d));
        const int off = tile_off<HD>(d, r);
        split4(x, th + off, tl + off);
    }
}

// a tile's rows [r0, r0 + R) (row stride rs, HD floats a row) straight into
// the swizzle at dst, rows past n zero-filled; the 128 threads of one
// warpgroup (t = 0..127)
template <int R, int HD>
__device__ __forceinline__ void load_swz(uint32_t dst, const float* src, long long rs,
                                         int r0, int n, int t) {
    constexpr int C4 = HD / 4;
    for (int e = t; e < R * C4; e += 128) {
        const int r = e / C4, d = (e % C4) * 4, gr = r0 + r;
        const bool ok = gr < n;
        cp_async16(dst + tile_off<R>(r, d), ok ? src + gr * rs + d : src, ok);
    }
}

__device__ __forceinline__ void proxy_fence() {
    // generic-proxy writes above are read by wgmma (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// (a) the statistics both gradient kernels read, per (b*H + h) and row
// padded to 64: lse (+inf past S, so P is 0 there), then, B*H*Sp further,
// D = rowsum(dout * out) (0 past S).  One warp per padded row.
__global__ void __launch_bounds__(DOT_WARPS * 32)
fa_bwd_tf32x3_dot_kernel(const float* __restrict__ o, const float* __restrict__ g,
                         const float* __restrict__ lse, float* __restrict__ stats,
                         RowStrides so, RowStrides sg, int H, int S, int Sp,
                         int hd, long long rows) {
    const long long row = (long long)blockIdx.x * DOT_WARPS + threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (row >= rows) return;
    const long long bh = row / Sp;
    const int r = (int)(row % Sp), b = (int)(bh / H), h = (int)(bh % H);
    float acc = 0.f;
    if (r < S) {
        const float* op = o + b * so.s[0] + h * so.s[1] + r * so.s[2];
        const float* gp = g + b * sg.s[0] + h * sg.s[1] + r * sg.s[2];
        for (int c = lane * 4; c < hd; c += 128) {
            const float4 x = *reinterpret_cast<const float4*>(op + c);
            const float4 y = *reinterpret_cast<const float4*>(gp + c);
            acc = fmaf(x.x, y.x, acc);
            acc = fmaf(x.y, y.y, acc);
            acc = fmaf(x.z, y.z, acc);
            acc = fmaf(x.w, y.w, acc);
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
        stats[row] = r < S ? lse[bh * S + r] : INFINITY;
        stats[rows + row] = acc;
    }
}

// (b) dK and dV of one (batch, kv head, part of the group, tile of 64
// keys): walks the part's q heads and, for each, the q tiles of BQ rows that
// the causal bound lets see its keys.  Warpgroup 0: S^T, P^T, dV;
// warpgroup 1: dP^T, dS^T, dK.  part == nullptr: dk and dv through their
// strides; else fp32 partials (split, B*Hkv, Sk, HD), dK's then dV's.
template <int HD>
__global__ void __launch_bounds__(NTHREADS, 1)
fa_bwd_tf32x3_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ g,
                          const float* __restrict__ stats, float* __restrict__ dk,
                          float* __restrict__ dv, float* __restrict__ part,
                          RowStrides sq, RowStrides skk, RowStrides sv,
                          RowStrides sgg, KvStrides st, int H, int Hkv,
                          int group, int split, int S, int Sk, int Sp,
                          long long rows, int causal, float scale) {
    using L = KvLayout<HD>;
    constexpr int NS = BQ / 2, KS = BQ / 8, AN = HD / 2;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t raw0 = smem_u32(smem_raw);
    const uint32_t base = (raw0 + 1023) & ~1023u;
    uint8_t* gbase = smem_raw + (base - raw0);
    float* xch = reinterpret_cast<float*>(gbase + L::XCH);

    const int tid = threadIdx.x;
    const int sp = blockIdx.x % split, bhk = blockIdx.x / split;
    const int b = bhk / Hkv, hk = bhk % Hkv;
    const int k0 = blockIdx.y * BKV;       // tile 0 (the longest walk) first
    const int heads = group / split, h0 = hk * group + sp * heads;
    const int nq = (S + BQ - 1) / BQ;
    const int first = causal ? min(k0 / BQ, nq) : 0;
    const int per = nq - first, steps = heads * per;
    // warp-uniform, so that each role is one branch
    const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
    const int t = tid % 128, warp = t / 32, lane = t % 32, tg = lane % 4;
    const int key0 = k0 + warp * 16 + lane / 4;   // this thread's keys, and + 8

    // step it's Q (wg 0) or dout (wg 1) rows into the swizzle, and (wg 0)
    // its statistics (buffer it & 1)
    auto issue = [&](int it) {
        const int h = h0 + it / per, q0 = (first + it % per) * BQ;
        if (wg == 0) {
            load_swz<BQ, HD>(base + L::QN, q + b * sq.s[0] + h * sq.s[1], sq.s[2],
                             q0, S, t);
            if (t < BQ / 2) {               // BQ / 4 chunks of lse, then of D
                const long long srow = (long long)(b * H + h) * Sp + q0;
                const int c = t % (BQ / 4), which = t / (BQ / 4);
                cp_async16(base + L::STATS + (it & 1) * 2 * BQ * 4 + which * BQ * 4
                           + c * 16, stats + which * rows + srow + c * 4, true);
            }
        } else {
            load_swz<BQ, HD>(base + L::GN, g + b * sgg.s[0] + h * sgg.s[1],
                             sgg.s[2], q0, S, t);
        }
        cp_commit();
    };

    // K and V raw, staged where the q-side tiles go: their lo parts split
    // once, their hi parts into the registers of the warpgroup that reads
    // them
    const float* rawk = reinterpret_cast<const float*>(gbase + L::QN);
    load_raw<BKV, HD>(base + L::QN, k + b * skk.s[0] + hk * skk.s[1], skk.s[2],
                      k0, Sk, tid, NTHREADS);
    load_raw<BKV, HD>(base + L::QN + L::KV_BYTES, v + b * sv.s[0] + hk * sv.s[1],
                      sv.s[2], k0, Sk, tid, NTHREADS);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    split_tile<BKV, HD, false, false>(rawk, 0, base + L::KL, 0, 0, tid);
    split_tile<BKV, HD, false, false>(rawk + BKV * HD, 0, base + L::VL, 0, 0, tid);
    uint32_t ahi[HD / 8][4];                      // K (wg 0) or V (wg 1), hi
    load_frags<HD>(ahi, rawk + wg * BKV * HD, warp, lane);
    float acc[AN], fr[32];                        // dV (wg 0) or dK (wg 1)
#pragma unroll
    for (int i = 0; i < AN; ++i) acc[i] = 0.f;
    __syncthreads();         // the staged K and V read
    if (steps > 0) issue(0);

    for (int it = 0; it < steps; ++it) {
        cp_wait<0>();
        __syncthreads();     // the rows landed; the last step's readers done
        split_landed<BQ, HD>(gbase + L::QN, base + L::QNL, base + L::QTH,
                             base + L::QTL, tid);
        split_landed<BQ, HD>(gbase + L::GN, base + L::GNL, base + L::GTH,
                             base + L::GTL, tid);
        proxy_fence();
        __syncthreads();     // the copies whole
        const int q0 = (first + it % per) * BQ;
        const float* stt = reinterpret_cast<const float*>(
            gbase + L::STATS + (it & 1) * 2 * BQ * 4);
        const bool edge = causal && q0 < k0 + BKV - 1;
        float ss[NS], sa[NS], sb[NS];
        uint32_t fh[KS][4], fl[KS][4];
        // S^T = K Q^T (wg 0) or dP^T = V dout^T (wg 1)
        if (wg == 0)
            scores<BQ, HD>(ss, sa, sb, ahi, opaque(tile_desc(base + L::KL)),
                           opaque(tile_desc(base + L::QN)),
                           opaque(tile_desc(base + L::QNL)));
        else
            scores<BQ, HD>(ss, sa, sb, ahi, opaque(tile_desc(base + L::VL)),
                           opaque(tile_desc(base + L::GN)),
                           opaque(tile_desc(base + L::GNL)));
        wgmma_wait_all();
        fence_regs(ss);
        fence_regs(sa);
        fence_regs(sb);
        // this warpgroup's rows read: the next step's may land there
        asm volatile("bar.sync %0, 128;" :: "r"(WG_BAR + wg) : "memory");
        if (it + 1 < steps) issue(it + 1);
        if (wg == 0) {
            // P^T = exp(S^T scale - lse), to warpgroup 1
#pragma unroll
            for (int n = 0; n < NS; ++n) {
                const int col = (n >> 2) * 8 + 2 * tg + (n & 1);
                const int key = key0 + 8 * ((n >> 1) & 1);
                float p = expf(fmaf(__fadd_rn(__fadd_rn(sa[n], sb[n]), ss[n]),
                                    scale, -stt[col]));
                if (edge && key > q0 + col) p = 0.f;
                ss[n] = p;
            }
#pragma unroll
            for (int n = 0; n < NS; n += 4)
                *reinterpret_cast<float4*>(xch + t * NS + n) =
                    make_float4(ss[n], ss[n + 1], ss[n + 2], ss[n + 3]);
            xch_arrive();
            // dV += P^T dout: dout^T ([hd][q rows]) as B
            a_frags<KS>(ss, fh, fl, lane);
            accumulate<HD, KS>(acc, fr, fh, fl, opaque(tile_desc(base + L::GTH)),
                               opaque(tile_desc(base + L::GTL)));
        } else {
            // dS^T = P^T (dP^T - D)
            xch_wait();
#pragma unroll
            for (int n = 0; n < NS; n += 4) {
                const float4 p = *reinterpret_cast<const float4*>(xch + t * NS + n);
                const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int m = n + i, col = (m >> 2) * 8 + 2 * tg + (m & 1);
                    const float dp = __fadd_rn(__fadd_rn(sa[m], sb[m]), ss[m]);
                    ss[m] = pv[i] * (dp - stt[BQ + col]);
                }
            }
            // dK += dS^T Q: Q^T ([hd][q rows]) as B
            a_frags<KS>(ss, fh, fl, lane);
            accumulate<HD, KS>(acc, fr, fh, fl, opaque(tile_desc(base + L::QTH)),
                               opaque(tile_desc(base + L::QTL)));
        }
    }

    // a thread holds keys key0 + 8 i, head dims 8 j + 2 tg + {0, 1}
    const float mul = wg == 0 || part != nullptr ? 1.f : scale;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int key = key0 + 8 * i;
        if (key >= Sk) continue;
        float* dst;
        if (part != nullptr) {
            const long long n_all = (long long)gridDim.x / split * Sk * HD;
            dst = part + (long long)(1 - wg) * split * n_all
                + ((long long)sp * (gridDim.x / split) + bhk) * Sk * HD
                + (long long)key * HD;
        } else if (wg == 0) {
            dst = dv + b * st.dv[0] + hk * st.dv[1] + key * st.dv[2];
        } else {
            dst = dk + b * st.dk[0] + hk * st.dk[1] + key * st.dk[2];
        }
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
            const int n = j * 4 + 2 * i;
            *reinterpret_cast<float2*>(dst + j * 8 + 2 * tg) =
                make_float2(acc[n] * mul, acc[n + 1] * mul);
        }
    }
}

// (c) with a split group: dK and dV as the partials' sum, taken in part
// order, dK scaled; 4 head dims a thread, dK's elements then dV's.  At hd
// 256 also dQ, the sum of its two partials (nq_all elements each, (B*H, S,
// hd)) scaled, after them; elsewhere nq_all is 0.
__global__ void __launch_bounds__(SUM_THREADS)
fa_bwd_tf32x3_sum_kernel(const float* __restrict__ part, float* __restrict__ dk,
                         float* __restrict__ dv, KvStrides st, int split,
                         int Hkv, int Sk, int hd, long long n_all, float scale,
                         const float* __restrict__ qpart, float* __restrict__ dq,
                         RowStrides sdq, int H, int S, long long nq_all) {
    const long long e = ((long long)blockIdx.x * SUM_THREADS + threadIdx.x) * 4;
    if (e >= 2 * n_all + nq_all) return;
    if (e >= 2 * n_all) {
        const long long f = e - 2 * n_all, r = f / hd, bh = r / S;
        const int d = (int)(f % hd), row = (int)(r % S);
        const int b = (int)(bh / H), h = (int)(bh % H);
        const float4 x = *reinterpret_cast<const float4*>(qpart + f);
        const float4 y = *reinterpret_cast<const float4*>(qpart + nq_all + f);
        float* dst = dq + b * sdq.s[0] + h * sdq.s[1] + row * sdq.s[2] + d;
        *reinterpret_cast<float4*>(dst) = make_float4(
            (x.x + y.x) * scale, (x.y + y.y) * scale, (x.z + y.z) * scale,
            (x.w + y.w) * scale);
        return;
    }
    const int which = e >= n_all;
    const long long f = e - which * n_all;
    const int d = (int)(f % hd);
    const long long r = f / hd;
    const int key = (int)(r % Sk);
    const long long bhk = r / Sk;
    const int b = (int)(bhk / Hkv), hk = (int)(bhk % Hkv);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    const float* src = part + (long long)which * split * n_all + f;
    for (int s = 0; s < split; ++s) {
        const float4 x = *reinterpret_cast<const float4*>(src + s * n_all);
        acc.x += x.x; acc.y += x.y; acc.z += x.z; acc.w += x.w;
    }
    const float m = which ? 1.f : scale;
    const long long* s3 = which ? st.dv : st.dk;
    float* dst = (which ? dv : dk) + b * s3[0] + hk * s3[1] + key * s3[2] + d;
    *reinterpret_cast<float4*>(dst) = make_float4(acc.x * m, acc.y * m, acc.z * m,
                                                  acc.w * m);
}

// (d) dQ of one (batch, q head, 64 q rows): walks the kv tiles of BK keys up
// to the forward's causal bound, S and dP recomputed.  Warpgroup 0: S and
// P; warpgroup 1: dP, dS and dQ.
template <int HD>
__global__ void __launch_bounds__(NTHREADS, 1)
fa_bwd_tf32x3_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ g,
                        const float* __restrict__ stats, float* __restrict__ dq,
                        RowStrides sq, RowStrides skk, RowStrides sv,
                        RowStrides sgg, RowStrides sdq, int H, int group, int S,
                        int Sk, int Sp, long long rows, int causal, float scale) {
    using L = QLayout<HD>;
    constexpr int NS = BK / 2, KS = BK / 8, ON = HD / 2;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t raw0 = smem_u32(smem_raw);
    const uint32_t base = (raw0 + 1023) & ~1023u;
    uint8_t* gbase = smem_raw + (base - raw0);
    const float* rawp = reinterpret_cast<const float*>(gbase + L::RAW);
    float* xch = reinterpret_cast<float*>(gbase + L::XCH);

    const int tid = threadIdx.x;
    const int bh = blockIdx.x, b = bh / H, h = bh % H, hk = h / group;
    const int q0 = (gridDim.y - 1 - blockIdx.y) * BQD;   // last q tile first
    int nkv = (Sk + BK - 1) / BK;
    if (causal) nkv = min(nkv, (min(q0 + BQD, S) - 1) / BK + 1);
    const float* kb = k + b * skk.s[0] + hk * skk.s[1];
    const float* vb = v + b * sv.s[0] + hk * sv.s[1];

    auto issue = [&](int j) {
        load_raw<BK, HD>(base + L::RAW, kb, skk.s[2], j * BK, Sk, tid, NTHREADS);
        load_raw<BK, HD>(base + L::RAW + L::T_BYTES, vb, sv.s[2], j * BK, Sk, tid,
                         NTHREADS);
        cp_commit();
    };

    // Q and dout raw, staged where the kv-side copies go: their lo parts
    // split once, their hi parts into the registers of the warpgroup that
    // reads them
    const float* rawq = reinterpret_cast<const float*>(gbase + L::KH);
    load_raw<BQD, HD>(base + L::KH, q + b * sq.s[0] + h * sq.s[1], sq.s[2], q0,
                      S, tid, NTHREADS);
    load_raw<BQD, HD>(base + L::KH + L::Q_BYTES, g + b * sgg.s[0] + h * sgg.s[1],
                      sgg.s[2], q0, S, tid, NTHREADS);
    cp_commit();
    issue(0);
    cp_wait<1>();
    __syncthreads();
    split_tile<BQD, HD, false, false>(rawq, 0, base + L::QL, 0, 0, tid);
    split_tile<BQD, HD, false, false>(rawq + BQD * HD, 0, base + L::GL, 0, 0, tid);

    const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
    const int t = tid % 128, warp = t / 32, lane = t % 32, tg = lane % 4;
    const int row0 = q0 + warp * 16 + lane / 4;   // this thread's rows, and + 8
    uint32_t ahi[HD / 8][4];                      // Q (wg 0) or dout (wg 1), hi
    load_frags<HD>(ahi, rawq + wg * BQD * HD, warp, lane);
    // wg 0: the rows' lse (+inf past S); wg 1: their D
    const float* srow = stats + wg * rows + (long long)bh * Sp + row0;
    const float stat[2] = {srow[0], srow[8]};
    float acc[ON], fr[32];                        // dQ (wg 1)
#pragma unroll
    for (int i = 0; i < ON; ++i) acc[i] = 0.f;

    for (int j = 0; j < nkv; ++j) {
        cp_wait<0>();
        __syncthreads();     // raw tile landed; the last step's readers done
        split_tile<BK, HD, true, true>(rawp, base + L::KH, base + L::KL,
                                       base + L::KTH, base + L::KTL, tid);
        split_tile<BK, HD, true, false>(rawp + BK * HD, base + L::VH, base + L::VL,
                                        0, 0, tid);
        proxy_fence();
        __syncthreads();     // the copies whole; the raw stage free
        if (j + 1 < nkv) issue(j + 1);
        const int k0 = j * BK;
        float ss[NS], sa[NS], sb[NS];
        // S = Q K^T (wg 0) or dP = dout V^T (wg 1)
        if (wg == 0)
            scores<BK, HD>(ss, sa, sb, ahi, opaque(tile_desc(base + L::QL)),
                           opaque(tile_desc(base + L::KH)),
                           opaque(tile_desc(base + L::KL)));
        else
            scores<BK, HD>(ss, sa, sb, ahi, opaque(tile_desc(base + L::GL)),
                           opaque(tile_desc(base + L::VH)),
                           opaque(tile_desc(base + L::VL)));
        wgmma_wait_all();
        fence_regs(ss);
        fence_regs(sa);
        fence_regs(sb);
        if (wg == 0) {
            // P = exp(S scale - lse), to warpgroup 1
            const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > q0);
#pragma unroll
            for (int n = 0; n < NS; ++n) {
                const int i = (n >> 1) & 1;
                const int col = k0 + (n >> 2) * 8 + 2 * tg + (n & 1);
                float p = expf(fmaf(__fadd_rn(__fadd_rn(sa[n], sb[n]), ss[n]),
                                    scale, -stat[i]));
                if (edge && (col >= Sk || (causal && col > row0 + 8 * i))) p = 0.f;
                ss[n] = p;
            }
#pragma unroll
            for (int n = 0; n < NS; n += 4)
                *reinterpret_cast<float4*>(xch + t * NS + n) =
                    make_float4(ss[n], ss[n + 1], ss[n + 2], ss[n + 3]);
            xch_arrive();
        } else {
            // dS = P (dP - D); dQ += dS K: K^T as B
            xch_wait();
#pragma unroll
            for (int n = 0; n < NS; n += 4) {
                const float4 p = *reinterpret_cast<const float4*>(xch + t * NS + n);
                const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int m = n + i;
                    const float dp = __fadd_rn(__fadd_rn(sa[m], sb[m]), ss[m]);
                    ss[m] = pv[i] * (dp - stat[(m >> 1) & 1]);
                }
            }
            uint32_t fh[KS][4], fl[KS][4];
            a_frags<KS>(ss, fh, fl, lane);
            accumulate<HD, KS>(acc, fr, fh, fl, opaque(tile_desc(base + L::KTH)),
                               opaque(tile_desc(base + L::KTL)));
        }
    }
    if (wg == 0) return;

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int row = row0 + 8 * i;
        if (row >= S) continue;
        float* p = dq + b * sdq.s[0] + h * sdq.s[1] + row * sdq.s[2];
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
            const int n = j * 4 + 2 * i;
            *reinterpret_cast<float2*>(p + j * 8 + 2 * tg) =
                make_float2(acc[n] * scale, acc[n + 1] * scale);
        }
    }
}

// ---------------------------------------------------------------------------
// hd 256: kernels of their own (the header's last section)
// ---------------------------------------------------------------------------

constexpr int HD256 = 256;
constexpr int BQ256 = 16;                  // q rows of a dK/dV step
constexpr int BK256 = 16;                  // keys of a dQ step
// scores256's k-steps a group and small-term accumulators, in the dK/dV
// and the dQ kernel (the faster of the variants timed on an H100)
constexpr int KPG_KV = 2, NL_KV = 1;
constexpr int KPG_Q = 4, NL_Q = 2;

// dK/dV block: K and V of 64 keys raw, in the XOR layout (their hi parts as
// the tensor cores read them, their lo parts made in registers a k-step at
// a time); two buffers of a step's Q and dout rows, one holding the rows as
// cp.async landed them in the swizzle (B's hi part of S^T and dP^T, and the
// source of dK^T's and dV^T's A), the other their lo parts; P^T and dS^T
// ([key][q row], hi and lo: B of dV^T and dK^T, 16 of a swizzled row's 32
// columns); the statistics (two buffers).
struct KvLayout256 {
    static constexpr int KV_BYTES = BKV * HD256 * 4;   // K or V
    static constexpr int T_BYTES = BQ256 * HD256 * 4;  // a step's Q or dout rows
    static constexpr int KR = 0, VR = KV_BYTES;
    static constexpr int BUF = 2 * KV_BYTES;           // two of {Q, dout}
    static constexpr int BUF_BYTES = 2 * T_BYTES;
    static constexpr int X_BYTES = BKV * ROW;          // P^T or dS^T, hi or lo
    static constexpr int PTH = BUF + 2 * BUF_BYTES, PTL = PTH + X_BYTES;
    static constexpr int DTH = PTL + X_BYTES, DTL = DTH + X_BYTES;
    static constexpr int STATS = DTL + X_BYTES;        // 2 x (lse[BQ256], D[BQ256])
    static constexpr int SMEM = STATS + 4 * BQ256 * 4 + 1024;
    static_assert(SMEM <= 232448, "tiles exceed a block's shared memory");
};

// dQ block: Q and dout of 64 rows raw in the XOR layout; two buffers of a
// step's K and V rows (raw in the swizzle, or their lo parts); dS ([q
// row][key], hi and lo: B of dQ^T) and the P exchange.
struct QLayout256 {
    static constexpr int Q_BYTES = BQD * HD256 * 4;    // Q or dout
    static constexpr int T_BYTES = BK256 * HD256 * 4;  // a step's K or V rows
    static constexpr int QR = 0, GR = Q_BYTES;
    static constexpr int BUF = 2 * Q_BYTES;            // two of {K, V}
    static constexpr int BUF_BYTES = 2 * T_BYTES;
    static constexpr int X_BYTES = BQD * ROW;          // dS, hi or lo
    static constexpr int DSH = BUF + 2 * BUF_BYTES, DSL = DSH + X_BYTES;
    static constexpr int XCH = DSL + X_BYTES;          // P, fp32
    static constexpr int SMEM = XCH + BQD * BK256 * 4 + 1024;
    static_assert(SMEM <= 232448, "tiles exceed a block's shared memory");
};

// float offset of element (r, k) of a tile of 256-float rows in the XOR
// layout: 16-byte chunk c of row r at chunk c ^ (r % 8), so that the eight
// rows of an A fragment's column fall in eight bank groups
__device__ __forceinline__ int xor_off(int r, int k) {
    return r * HD256 + ((((k >> 2) ^ (r & 7))) << 2) + (k & 3);
}

// rows [r0, r0 + R) (row stride rs) into the XOR layout at dst, rows past n
// zero-filled; threads tid0.. of `nthr`
template <int R>
__device__ __forceinline__ void load_xor(uint32_t dst, const float* src, long long rs,
                                         int r0, int n, int tid, int nthr) {
    constexpr int C4 = HD256 / 4;
    for (int e = tid; e < R * C4; e += nthr) {
        const int r = e / C4, c = e % C4, gr = r0 + r;
        const bool ok = gr < n;
        cp_async16(dst + (r * HD256 + ((c ^ (r & 7)) << 2)) * 4,
                   ok ? src + gr * rs + c * 4 : src, ok);
    }
}

// x = hi + lo: hi x truncated to TF32 (what the tensor cores read of x),
// lo the rest rounded to TF32
__device__ __forceinline__ void split_trunc(float x, uint32_t& hi, uint32_t& lo) {
    hi = __float_as_uint(x) & 0xffffe000u;
    lo = rna_tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// split() for kernels whose `split` is a parameter
__device__ __forceinline__ void rna_split(float x, uint32_t& hi, uint32_t& lo) {
    split(x, hi, lo);
}

// A fragments, hi and lo, of k-step ks of a 64-row tile in the XOR layout:
// rows 16 warp + g (+ 8), columns 8 ks + tg (+ 4)
__device__ __forceinline__ void frag_xor(const float* t, int ks, int warp, int lane,
                                         uint32_t (&h)[4], uint32_t (&l)[4]) {
    const int r = warp * 16 + lane / 4, c = ks * 8 + lane % 4;
    const float x[4] = {t[xor_off(r, c)], t[xor_off(r + 8, c)],
                        t[xor_off(r, c + 4)], t[xor_off(r + 8, c + 4)]};
#pragma unroll
    for (int i = 0; i < 4; ++i) split_trunc(x[i], h[i], l[i]);
}

// A fragments, hi and lo, of k-step ks of the transpose of a tile of 16
// rows of 256 floats as cp.async landed it in the swizzle (`t`, generic):
// A's rows m0 + 16 warp + g (+ 8) are the tile's columns, A's columns 8 ks
// + tg (+ 4) its rows
__device__ __forceinline__ void frag_tr(const uint8_t* t, int m0, int ks, int warp,
                                        int lane, uint32_t (&h)[4], uint32_t (&l)[4]) {
    const int d = m0 + warp * 16 + lane / 4, r = ks * 8 + lane % 4;
    const float x[4] = {
        *reinterpret_cast<const float*>(t + tile_off<16>(r, d)),
        *reinterpret_cast<const float*>(t + tile_off<16>(r, d + 8)),
        *reinterpret_cast<const float*>(t + tile_off<16>(r + 4, d)),
        *reinterpret_cast<const float*>(t + tile_off<16>(r + 4, d + 8))};
#pragma unroll
    for (int i = 0; i < 4; ++i) split_trunc(x[i], h[i], l[i]);
}

// A score tile (64 x 16, 3xTF32) over 256 columns: A (64 rows) from its
// raw rows in the XOR layout at `a`, split a k-step at a time; B (16 rows)
// hi (raw) and lo in the swizzle at bh, bl.  The small terms (lo*hi, then
// hi*lo) in NL accumulators sl, the hi*hi products of each half of hd in
// sh (one accumulator took 1.5 times the error).  k-steps go in groups of KPG, each group's fragments in one
// of two register sets, so that a group's loads run while the one before
// is on the tensor cores.  The last group is left in flight.
template <int KPG, int NL>
__device__ __forceinline__ void scores256(float (&sl)[NL][8], float (&sh)[2][8],
                                          const float* a, uint64_t bh, uint64_t bl,
                                          int warp, int lane) {
    constexpr int KS = HD256 / 8, CH = KS / 2;
    uint32_t h[2][KPG][4], l[2][KPG][4];
#pragma unroll
    for (int p = 0; p < KS / KPG; ++p) {
        const int s = p & 1;
        if (p >= 2) wgmma_wait<1>();      // group p - 2 retired: its set is free
#pragma unroll
        for (int i = 0; i < KPG; ++i) frag_xor(a, KPG * p + i, warp, lane, h[s][i], l[s][i]);
        wgmma_fence();
#pragma unroll
        for (int i = 0; i < KPG; ++i) {
            const int ks = KPG * p + i;
            const uint32_t bo = ks_off<16>(ks);
            if (ks == 0)
                WgmmaRS<16>::template run<true>(sl[0], l[s][i], bh + bo);
            else
                WgmmaRS<16>::template run<false>(sl[0], l[s][i], bh + bo);
            if (ks == 0 && NL > 1)
                WgmmaRS<16>::template run<true>(sl[NL - 1], h[s][i], bl + bo);
            else
                WgmmaRS<16>::template run<false>(sl[NL - 1], h[s][i], bl + bo);
            if (ks % CH == 0)
                WgmmaRS<16>::template run<true>(sh[ks / CH], h[s][i], bh + bo);
            else
                WgmmaRS<16>::template run<false>(sh[ks / CH], h[s][i], bh + bo);
        }
        wgmma_commit();
    }
}

// a score of scores256, summed: the hi*hi products in order, then the
// small terms
template <int NL>
__device__ __forceinline__ float score_sum(const float (&sl)[NL][8],
                                           const float (&sh)[2][8], int n) {
    const float x = __fadd_rn(sh[0][n], sh[1][n]);
    float y = sl[0][n];
#pragma unroll
    for (int c = 1; c < NL; ++c) y = __fadd_rn(y, sl[c][n]);
    return __fadd_rn(x, y);
}

// acc (NC chunks of 64 rows by 64 columns) += A B^T over 16 columns, for
// A's rows 64 c0 ... : A (row m, column r) is element (r, m) of a tile of
// 16 rows of 256 floats as cp.async landed it (`t`), split here; B (64
// rows, 16 columns) hi and lo at bh, bl.  Each chunk's three passes go to
// the fresh accumulator fr, added to acc rounded to nearest.
template <int NC>
__device__ __forceinline__ void accumulate256(float (&acc)[NC * 32], float (&fr)[32],
                                              const uint8_t* t, int c0, uint64_t bh,
                                              uint64_t bl, int warp, int lane) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
        uint32_t h[2][4], l[2][4];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
            frag_tr(t, 64 * (c0 + c), kk, warp, lane, h[kk], l[kk]);
        wgmma_fence();
        WgmmaRS<64>::template run<true>(fr, l[0], bh + ks_off<64>(0));
        WgmmaRS<64>::template run<false>(fr, l[1], bh + ks_off<64>(1));
        WgmmaRS<64>::template run<false>(fr, h[0], bl + ks_off<64>(0));
        WgmmaRS<64>::template run<false>(fr, h[1], bl + ks_off<64>(1));
        WgmmaRS<64>::template run<false>(fr, h[0], bh + ks_off<64>(0));
        WgmmaRS<64>::template run<false>(fr, h[1], bh + ks_off<64>(1));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(fr);
#pragma unroll
        for (int n = 0; n < 32; ++n) acc[c * 32 + n] = __fadd_rn(acc[c * 32 + n], fr[n]);
    }
}

// the lo parts (x minus x truncated, rounded to TF32) of `bytes` of raw
// rows at `raw` (generic) into the same offsets from `lo`; all threads
__device__ __forceinline__ void split_lo(const uint8_t* raw, uint32_t lo, int bytes,
                                         int tid) {
    for (int e = tid * 16; e < bytes; e += NTHREADS * 16) {
        const float4 x4 = *reinterpret_cast<const float4*>(raw + e);
        const float x[4] = {x4.x, x4.y, x4.z, x4.w};
        uint32_t hi, l4[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) split_trunc(x[j], hi, l4[j]);
        st_shared4(lo + e, l4);
    }
}

// (b) at hd 256: dK and dV partials of one (batch, kv head, part of the
// group) over two tiles of 64 keys, tile `pair` and tile nk - 1 - pair (a
// causal walk's longest and shortest), each over half of the q steps its
// causal bound keeps (z = 0 the first half, 1 the rest), walking the part's
// q heads.  So every block walks about the mean, and the grid is (B * Hkv *
// split, 2 * ceil(nk / 2)).  Warpgroup 0: S^T = K Q^T, P^T, dV^T += dout^T
// P; warpgroup 1: dP^T = V dout^T, dS^T, dK^T += Q^T dS.  Writes fp32
// partials (2, 2 split, B*Hkv, Sk, 256), dK's then dV's, unscaled; part
// 2 sp + z.
__global__ void __launch_bounds__(NTHREADS, 1)
fa_bwd_tf32x3_hd256_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, const float* __restrict__ g,
                                const float* __restrict__ stats, float* __restrict__ part,
                                RowStrides sq, RowStrides skk, RowStrides sv,
                                RowStrides sgg, int H, int Hkv, int group, int split,
                                int S, int Sk, int Sp, long long rows, int causal,
                                float scale) {
    using L = KvLayout256;
    constexpr int NS = BQ256 / 2;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t raw0 = smem_u32(smem_raw);
    const uint32_t base = (raw0 + 1023) & ~1023u;
    uint8_t* gbase = smem_raw + (base - raw0);

    const int tid = threadIdx.x;
    const int sp = blockIdx.x % split, bhk = blockIdx.x / split;
    const int b = bhk / Hkv, hk = bhk % Hkv;
    const int z = blockIdx.y & 1, pair = blockIdx.y >> 1;
    const int nk = (Sk + BKV - 1) / BKV, nq = (S + BQ256 - 1) / BQ256;
    const int heads = group / split, h0 = hk * group + sp * heads;
    const long long n_all = (long long)gridDim.x / split * Sk * HD256;
    const int parts = 2 * split;
    const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
    const int t = tid % 128, warp = t / 32, lane = t % 32, tg = lane % 4;
    const int kl0 = warp * 16 + lane / 4;         // this thread's keys, and + 8
    const float* kv = reinterpret_cast<const float*>(gbase + (wg ? L::VR : L::KR));

#pragma unroll 1
    for (int u = 0; u < 2; ++u) {
        const int tile = u ? nk - 1 - pair : pair;
        if (u && tile == pair) break;
        const int k0 = tile * BKV;
        const int first = causal ? min(k0 / BQ256, nq) : 0, per = nq - first;
        const int half = (per + 1) / 2;
        const int i0 = first + (z ? half : 0), cnt = z ? per - half : half;
        const int steps = heads * cnt;

        // step it's Q (wg 0, with its statistics) or dout (wg 1) rows, raw,
        // into buffer it & 1
        auto issue = [&](int it) {
            const int h = h0 + it / cnt, q0 = (i0 + it % cnt) * BQ256;
            const uint32_t buf = base + L::BUF + (it & 1) * L::BUF_BYTES;
            if (wg == 0) {
                load_swz<BQ256, HD256>(buf, q + b * sq.s[0] + h * sq.s[1], sq.s[2], q0,
                                       S, t);
                if (t < BQ256 / 2) {        // BQ256 / 4 chunks of lse, then of D
                    const long long srow = (long long)(b * H + h) * Sp + q0;
                    const int c = t % (BQ256 / 4), which = t / (BQ256 / 4);
                    cp_async16(base + L::STATS + (it & 1) * 2 * BQ256 * 4
                               + which * BQ256 * 4 + c * 16,
                               stats + which * rows + srow + c * 4, true);
                }
            } else {
                load_swz<BQ256, HD256>(buf + L::T_BYTES,
                                       g + b * sgg.s[0] + h * sgg.s[1], sgg.s[2], q0,
                                       S, t);
            }
            cp_commit();
        };

        load_xor<BKV>(base + L::KR, k + b * skk.s[0] + hk * skk.s[1], skk.s[2], k0,
                      Sk, tid, NTHREADS);
        load_xor<BKV>(base + L::VR, v + b * sv.s[0] + hk * sv.s[1], sv.s[2], k0, Sk,
                      tid, NTHREADS);
        cp_commit();
        if (steps > 0) issue(0);
        float acc[4 * 32], fr[32];                // dV^T (wg 0) or dK^T (wg 1)
#pragma unroll
        for (int i = 0; i < 4 * 32; ++i) acc[i] = 0.f;

        for (int it = 0; it < steps; ++it) {
            const int cur = it & 1;
            const uint32_t rawb = base + L::BUF + cur * L::BUF_BYTES;
            const uint32_t lob = base + L::BUF + (cur ^ 1) * L::BUF_BYTES;
            const uint8_t* rawg = gbase + L::BUF + cur * L::BUF_BYTES;
            cp_wait<0>();
            __syncthreads();     // the rows landed; the last step's readers done
            split_lo(rawg, lob, L::BUF_BYTES, tid);
            proxy_fence();
            __syncthreads();     // the lo parts whole
            const int q0 = (i0 + it % cnt) * BQ256;
            const float* stt = reinterpret_cast<const float*>(
                gbase + L::STATS + cur * 2 * BQ256 * 4);
            const bool edge = causal && q0 < k0 + BKV - 1;
            float sl[NL_KV][8], sh[2][8];
            // S^T = K Q^T (wg 0) or dP^T = V dout^T (wg 1)
            scores256<KPG_KV>(sl, sh, kv, opaque(tile_desc(rawb + wg * L::T_BYTES)),
                      opaque(tile_desc(lob + wg * L::T_BYTES)), warp, lane);
            wgmma_wait_all();
#pragma unroll
            for (int c = 0; c < (int)(sizeof(sl) / sizeof(sl[0])); ++c) fence_regs(sl[c]);
            fence_regs(sh[0]);
            fence_regs(sh[1]);
            // this warpgroup's lo parts read: the next step's rows may land
            // there
            asm volatile("bar.sync %0, 128;" :: "r"(WG_BAR + wg) : "memory");
            if (it + 1 < steps) issue(it + 1);
            if (wg == 0) {
                // P^T = exp(S^T scale - lse), hi and lo: dV^T's B, and for
                // warpgroup 1
#pragma unroll
                for (int n = 0; n < NS; ++n) {
                    const int col = (n >> 2) * 8 + 2 * tg + (n & 1);
                    const int kl = kl0 + 8 * ((n >> 1) & 1);
                    float p = expf(fmaf(score_sum(sl, sh, n), scale, -stt[col]));
                    if (edge && k0 + kl > q0 + col) p = 0.f;
                    uint32_t hi, lo;
                    rna_split(p, hi, lo);
                    const int off = tile_off<64>(kl, col);
                    *reinterpret_cast<uint32_t*>(gbase + L::PTH + off) = hi;
                    *reinterpret_cast<uint32_t*>(gbase + L::PTL + off) = lo;
                }
                proxy_fence();
                xch_arrive();
                asm volatile("bar.sync %0, 128;" :: "r"(WG_BAR) : "memory");
                // dV^T += dout^T P: A from this step's dout rows
                accumulate256<4>(acc, fr, rawg + L::T_BYTES, 0,
                                 opaque(tile_desc(base + L::PTH)),
                                 opaque(tile_desc(base + L::PTL)), warp, lane);
            } else {
                // dS^T = P^T (dP^T - D)
                xch_wait();
#pragma unroll
                for (int n = 0; n < NS; ++n) {
                    const int col = (n >> 2) * 8 + 2 * tg + (n & 1);
                    const int off = tile_off<64>(kl0 + 8 * ((n >> 1) & 1), col);
                    const float p = __fadd_rn(
                        *reinterpret_cast<const float*>(gbase + L::PTH + off),
                        *reinterpret_cast<const float*>(gbase + L::PTL + off));
                    const float ds = p * (score_sum(sl, sh, n) - stt[BQ256 + col]);
                    uint32_t hi, lo;
                    rna_split(ds, hi, lo);
                    *reinterpret_cast<uint32_t*>(gbase + L::DTH + off) = hi;
                    *reinterpret_cast<uint32_t*>(gbase + L::DTL + off) = lo;
                }
                proxy_fence();
                asm volatile("bar.sync %0, 128;" :: "r"(WG_BAR + 1) : "memory");
                // dK^T += Q^T dS: A from this step's Q rows
                accumulate256<4>(acc, fr, rawg, 0, opaque(tile_desc(base + L::DTH)),
                                 opaque(tile_desc(base + L::DTL)), warp, lane);
            }
        }
        cp_wait<0>();

        // a thread holds head dims 64 c + 16 warp + g (+ 8) of keys k0 + 8 n
        // + 2 tg (+ 1)
        float* dst = part + (long long)(1 - wg) * parts * n_all
                   + ((long long)(2 * sp + z) * (gridDim.x / split) + bhk) * Sk * HD256;
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
            for (int n = 0; n < 32; ++n) {
                const int key = k0 + (n >> 2) * 8 + 2 * tg + (n & 1);
                const int d = 64 * c + warp * 16 + lane / 4 + 8 * ((n >> 1) & 1);
                if (key < Sk) dst[(long long)key * HD256 + d] = acc[c * 32 + n];
            }
        __syncthreads();         // K, V and the buffers free for the next tile
    }
}

// (d) at hd 256: dQ partials of one (batch, q head) over two tiles of 64 q
// rows, tile nqt - 1 - pair and tile `pair` (a causal walk's longest and
// shortest), each over half of the kv steps of 16 keys up to the forward's
// causal bound (z = 0 the first half, 1 the rest); the grid is (B * H, 2 *
// ceil(nqt / 2)).  Warpgroup 0: S = Q K^T and P; warpgroup 1: dP = dout V^T
// and dS; each then dQ^T += K^T dS^T for its half of the head dims.  Writes
// fp32 partials (2, B*H, S, 256), unscaled; part z.
__global__ void __launch_bounds__(NTHREADS, 1)
fa_bwd_tf32x3_hd256_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ g,
                              const float* __restrict__ stats, float* __restrict__ qpart,
                              RowStrides sq, RowStrides skk, RowStrides sv,
                              RowStrides sgg, int H, int group, int S, int Sk, int Sp,
                              long long rows, int causal, float scale) {
    using L = QLayout256;
    constexpr int NS = BK256 / 2;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t raw0 = smem_u32(smem_raw);
    const uint32_t base = (raw0 + 1023) & ~1023u;
    uint8_t* gbase = smem_raw + (base - raw0);
    float* xch = reinterpret_cast<float*>(gbase + L::XCH);

    const int tid = threadIdx.x;
    const int bh = blockIdx.x, b = bh / H, h = bh % H, hk = h / group;
    const int z = blockIdx.y & 1, pair = blockIdx.y >> 1;
    const int nqt = (S + BQD - 1) / BQD;
    const float* kb = k + b * skk.s[0] + hk * skk.s[1];
    const float* vb = v + b * sv.s[0] + hk * sv.s[1];
    const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
    const int t = tid % 128, warp = t / 32, lane = t % 32, tg = lane % 4;
    const float* qg = reinterpret_cast<const float*>(gbase + (wg ? L::GR : L::QR));
    const long long nq_all = (long long)gridDim.x * S * HD256;

#pragma unroll 1
    for (int u = 0; u < 2; ++u) {
        const int qt = u ? pair : nqt - 1 - pair;
        if (u && qt == nqt - 1 - pair) break;
        const int q0 = qt * BQD;
        int nkv = (Sk + BK256 - 1) / BK256;
        if (causal) nkv = min(nkv, (min(q0 + BQD, S) - 1) / BK256 + 1);
        const int half = (nkv + 1) / 2;
        const int j0 = z ? half : 0, cnt = z ? nkv - half : half;
        const int row0 = q0 + warp * 16 + lane / 4;   // this thread's rows, + 8

        // step s's K (wg 0) or V (wg 1) rows, raw, into buffer s & 1
        auto issue = [&](int s) {
            const uint32_t buf = base + L::BUF + (s & 1) * L::BUF_BYTES;
            const int r0 = (j0 + s) * BK256;
            if (wg == 0)
                load_swz<BK256, HD256>(buf, kb, skk.s[2], r0, Sk, t);
            else
                load_swz<BK256, HD256>(buf + L::T_BYTES, vb, sv.s[2], r0, Sk, t);
            cp_commit();
        };

        load_xor<BQD>(base + L::QR, q + b * sq.s[0] + h * sq.s[1], sq.s[2], q0, S,
                      tid, NTHREADS);
        load_xor<BQD>(base + L::GR, g + b * sgg.s[0] + h * sgg.s[1], sgg.s[2], q0, S,
                      tid, NTHREADS);
        cp_commit();
        if (cnt > 0) issue(0);
        // wg 0: the rows' lse (+inf past S); wg 1: their D
        const float* srow = stats + wg * rows + (long long)bh * Sp + row0;
        const float stat[2] = {srow[0], srow[8]};
        float acc[2 * 32], fr[32];                // dQ^T, this warpgroup's half
#pragma unroll
        for (int i = 0; i < 2 * 32; ++i) acc[i] = 0.f;

        for (int s = 0; s < cnt; ++s) {
            const int cur = s & 1;
            const uint32_t rawb = base + L::BUF + cur * L::BUF_BYTES;
            const uint32_t lob = base + L::BUF + (cur ^ 1) * L::BUF_BYTES;
            const uint8_t* rawg = gbase + L::BUF + cur * L::BUF_BYTES;
            cp_wait<0>();
            __syncthreads();     // the rows landed; the last step's readers done
            split_lo(rawg, lob, L::BUF_BYTES, tid);
            proxy_fence();
            __syncthreads();     // the lo parts whole
            const int k0 = (j0 + s) * BK256;
            float sl[NL_Q][8], sh[2][8];
            // S = Q K^T (wg 0) or dP = dout V^T (wg 1)
            scores256<KPG_Q>(sl, sh, qg, opaque(tile_desc(rawb + wg * L::T_BYTES)),
                      opaque(tile_desc(lob + wg * L::T_BYTES)), warp, lane);
            wgmma_wait_all();
#pragma unroll
            for (int c = 0; c < (int)(sizeof(sl) / sizeof(sl[0])); ++c) fence_regs(sl[c]);
            fence_regs(sh[0]);
            fence_regs(sh[1]);
            asm volatile("bar.sync %0, 128;" :: "r"(WG_BAR + wg) : "memory");
            if (s + 1 < cnt) issue(s + 1);
            if (wg == 0) {
                // P = exp(S scale - lse), to warpgroup 1
                const bool edge = k0 + BK256 > Sk || (causal && k0 + BK256 - 1 > q0);
                float pv[NS];
#pragma unroll
                for (int n = 0; n < NS; ++n) {
                    const int i = (n >> 1) & 1;
                    const int col = k0 + (n >> 2) * 8 + 2 * tg + (n & 1);
                    float p = expf(fmaf(score_sum(sl, sh, n), scale, -stat[i]));
                    if (edge && (col >= Sk || (causal && col > row0 + 8 * i))) p = 0.f;
                    pv[n] = p;
                }
#pragma unroll
                for (int n = 0; n < NS; n += 4)
                    *reinterpret_cast<float4*>(xch + t * NS + n) =
                        make_float4(pv[n], pv[n + 1], pv[n + 2], pv[n + 3]);
                xch_arrive();
                // dS whole in shared memory (warpgroup 1 arrives there)
                asm volatile("bar.sync %0, %1;" :: "n"(DS_BAR), "n"(NTHREADS) : "memory");
            } else {
                // dS = P (dP - D), hi and lo: dQ^T's B ([q row][key])
                xch_wait();
#pragma unroll
                for (int n = 0; n < NS; n += 4) {
                    const float4 p = *reinterpret_cast<const float4*>(xch + t * NS + n);
                    const float pp[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int m = n + e, i = (m >> 1) & 1;
                        const float ds = pp[e] * (score_sum(sl, sh, m) - stat[i]);
                        uint32_t hi, lo;
                        split(ds, hi, lo);
                        const int off = tile_off<64>(warp * 16 + lane / 4 + 8 * i,
                                                     (m >> 2) * 8 + 2 * tg + (m & 1));
                        *reinterpret_cast<uint32_t*>(gbase + L::DSH + off) = hi;
                        *reinterpret_cast<uint32_t*>(gbase + L::DSL + off) = lo;
                    }
                }
                proxy_fence();
                asm volatile("bar.arrive %0, %1;" :: "n"(DS_BAR), "n"(NTHREADS) : "memory");
                asm volatile("bar.sync %0, 128;" :: "r"(WG_BAR + 1) : "memory");
            }
            // dQ^T += K^T dS^T, this warpgroup's two chunks of 64 head dims: A
            // from this step's K rows
            accumulate256<2>(acc, fr, rawg, 2 * wg, opaque(tile_desc(base + L::DSH)),
                             opaque(tile_desc(base + L::DSL)), warp, lane);
        }
        cp_wait<0>();

        // a thread holds head dims 64 (2 wg + c) + 16 warp + g (+ 8) of rows
        // q0 + 8 n + 2 tg (+ 1)
        float* dst = qpart + z * nq_all + (long long)bh * S * HD256;
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
            for (int n = 0; n < 32; ++n) {
                const int row = q0 + (n >> 2) * 8 + 2 * tg + (n & 1);
                const int d = 64 * (2 * wg + c) + warp * 16 + lane / 4 + 8 * ((n >> 1) & 1);
                if (row < S) dst[(long long)row * HD256 + d] = acc[c * 32 + n];
            }
        __syncthreads();         // Q, dout and the buffers free for the next tile
    }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

struct Args {
    const float *q, *k, *v, *o, *g, *lse;
    float *dq, *dk, *dv, *stats, *part;
    int B, H, Hkv, S, Sk, causal, split;
    float scale;
    const long long* st;     // (batch, head, row) of q, k, v, o, g, dq, dk, dv
};

RowStrides rows_of(const long long* st, int t) {
    RowStrides r;
    for (int i = 0; i < 3; ++i) r.s[i] = st[3 * t + i];
    return r;
}

// a gradient kernel on `stream`, its dynamic shared memory allowed first
template <typename Kernel, typename... Ts>
int launch(Kernel kernel, dim3 grid, int smem, cudaStream_t stream, Ts... args) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, NTHREADS, smem, stream>>>(args...);
    return (int)cudaGetLastError();
}

template <int HD>
int run(const Args& a, cudaStream_t stream) {
    const int G = a.H / a.Hkv;
    const int Sp = (a.S + STAT_TILE - 1) / STAT_TILE * STAT_TILE;
    const long long rows = (long long)a.B * a.H * Sp;
    const RowStrides sq = rows_of(a.st, 0), sk = rows_of(a.st, 1),
                     sv = rows_of(a.st, 2), so = rows_of(a.st, 3),
                     sg = rows_of(a.st, 4), sdq = rows_of(a.st, 5);
    KvStrides skv;
    for (int i = 0; i < 3; ++i) {
        skv.dk[i] = a.st[18 + i];
        skv.dv[i] = a.st[21 + i];
    }
    fa_bwd_tf32x3_dot_kernel<<<(unsigned)((rows + DOT_WARPS - 1) / DOT_WARPS),
                               DOT_WARPS * 32, 0, stream>>>(
        a.o, a.g, a.lse, a.stats, so, sg, a.H, a.S, Sp, HD, rows);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    if constexpr (HD == HD256) {
        // dK/dV over tile pairs and q halves (2 split parts a kv tile), dQ
        // over q-tile pairs and kv halves (2 parts a row), one sum for all
        const int nk = (a.Sk + BKV - 1) / BKV, nqt = (a.S + BQD - 1) / BQD;
        const long long n_all = (long long)a.B * a.Hkv * a.Sk * HD;
        const long long nq_all = (long long)a.B * a.H * a.S * HD;
        float* qpart = a.part + 2 * (2 * a.split) * n_all;
        err = (cudaError_t)launch(
            fa_bwd_tf32x3_hd256_dkdv_kernel,
            dim3(a.B * a.Hkv * a.split, 2 * ((nk + 1) / 2)), KvLayout256::SMEM,
            stream, a.q, a.k, a.v, a.g, a.stats, a.part, sq, sk, sv, sg, a.H,
            a.Hkv, G, a.split, a.S, a.Sk, Sp, rows, a.causal, a.scale);
        if (err != cudaSuccess) return (int)err;
        err = (cudaError_t)launch(
            fa_bwd_tf32x3_hd256_dq_kernel, dim3(a.B * a.H, 2 * ((nqt + 1) / 2)),
            QLayout256::SMEM, stream, a.q, a.k, a.v, a.g, a.stats, qpart, sq, sk,
            sv, sg, a.H, G, a.S, a.Sk, Sp, rows, a.causal, a.scale);
        if (err != cudaSuccess) return (int)err;
        const long long threads = (2 * n_all + nq_all) / 4;
        fa_bwd_tf32x3_sum_kernel<<<(unsigned)((threads + SUM_THREADS - 1) / SUM_THREADS),
                                   SUM_THREADS, 0, stream>>>(
            a.part, a.dk, a.dv, skv, 2 * a.split, a.Hkv, a.Sk, HD, n_all, a.scale,
            qpart, a.dq, sdq, a.H, a.S, nq_all);
        return (int)cudaGetLastError();
    } else {
        const dim3 gkv(a.B * a.Hkv * a.split, (a.Sk + BKV - 1) / BKV);
        err = (cudaError_t)launch(fa_bwd_tf32x3_dkdv_kernel<HD>, gkv,
                                  KvLayout<HD>::SMEM, stream, a.q, a.k, a.v, a.g,
                                  a.stats, a.dk, a.dv,
                                  a.split > 1 ? a.part : nullptr, sq, sk, sv, sg,
                                  skv, a.H, a.Hkv, G, a.split, a.S, a.Sk, Sp, rows,
                                  a.causal, a.scale);
        if (err != cudaSuccess) return (int)err;
        if (a.split > 1) {
            const long long n_all = (long long)a.B * a.Hkv * a.Sk * HD;
            const long long threads = 2 * n_all / 4;
            fa_bwd_tf32x3_sum_kernel<<<(unsigned)((threads + SUM_THREADS - 1) / SUM_THREADS),
                                       SUM_THREADS, 0, stream>>>(
                a.part, a.dk, a.dv, skv, a.split, a.Hkv, a.Sk, HD, n_all, a.scale,
                nullptr, nullptr, RowStrides{}, a.H, a.S, 0);
            err = cudaGetLastError();
            if (err != cudaSuccess) return (int)err;
        }
        return launch(fa_bwd_tf32x3_dq_kernel<HD>,
                      dim3(a.B * a.H, (a.S + BQD - 1) / BQD), QLayout<HD>::SMEM,
                      stream, a.q, a.k, a.v, a.g, a.stats, a.dq, sq, sk, sv, sg,
                      sdq, a.H, G, a.S, a.Sk, Sp, rows, a.causal, a.scale);
    }
}

}  // namespace

// q, out, dout, dq (B, H, S, hd); k, v, dk, dv (B, Hkv, Sk, hd), all float32
// with element strides (batch, head, row) in `strides` (q, k, v, out, dout,
// dq, dk, dv: 24 values), unit-stride rows and 16-byte aligned strides; lse
// (B, H, S) fp32 contiguous; hd 64, 128 or 256.  Scratch, fp32: stats (2, B*H,
// Sp) with Sp = S rounded up to 64; part (2, split, B*Hkv, Sk, hd) when
// split > 1 (split divides H / Hkv), else null; at hd 256 always part (2,
// 2 split, B*Hkv, Sk, 256) then (2, B*H, S, 256).  scale is hd^-0.5 as the
// caller rounds it to fp32.  Launches 3 kernels on `stream`, 4 when split > 1
// or hd is 256.
extern "C" int flash_attention_bwd_tf32x3(
        const float* q, const float* k, const float* v, const float* o,
        const float* g, const float* lse, float* dq, float* dk, float* dv,
        float* stats, float* part, int B, int H, int Hkv, int S, int Sk,
        int hd, int causal, int split, float scale, const long long* strides,
        void* stream) {
    if (B < 1 || H < 1 || Hkv < 1 || H % Hkv || S < 1 || Sk < 1 || split < 1
        || (H / Hkv) % split || (split > 1 || hd == 256) != (part != nullptr))
        return (int)cudaErrorInvalidValue;
    const Args a{q, k, v, o, g, lse, dq, dk, dv, stats, part, B, H, Hkv, S,
                 Sk, causal, split, scale, strides};
    cudaStream_t st = (cudaStream_t)stream;
    switch (hd) {
        case 64: return run<64>(a, st);
        case 128: return run<128>(a, st);
        case 256: return run<256>(a, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

// the dynamic shared memory of the dK/dV (which 0) or dQ (1) kernel at hd
extern "C" int flash_attention_bwd_tf32x3_smem(int hd, int which) {
    switch (hd) {
        case 64: return which ? QLayout<64>::SMEM : KvLayout<64>::SMEM;
        case 128: return which ? QLayout<128>::SMEM : KvLayout<128>::SMEM;
        case 256: return which ? QLayout256::SMEM : KvLayout256::SMEM;
        default: return -1;
    }
}

extern "C" const char* repro_error_string(int e) {
    return cudaGetErrorString((cudaError_t)e);
}
