// Flash attention, forward, bf16, on Hopper's tensor cores (wgmma), with K
// and V fed by TMA through a ring of shared-memory stages, and grouped-query
// attention and strided layouts read natively.
//
// Replaces: src/repro/kernels/flash_attention.py::_fa_kernel (line 22), the
// Pallas TPU kernel launched by flash_attention (grid (B*H, S/block_q)), for
// bf16 inputs at head dims 64, 128 and 256.  f32 inputs, and bf16 at head
// dims 16 and 32, stay on csrc/flash_attention.cu (the CUDA-core kernel).
//
// What it computes: out = softmax(q k^T * hd^-0.5 [+ causal mask]) v for q
// (B, H, S, hd) and k, v (B, Hkv, Sk, hd), q head h reading kv head
// h / (H / Hkv); online softmax with fp32 statistics; the output in bf16.
// Scores are scaled in fp32 after the product (by hd^-0.5 * log2 e, so the
// exponentials are exp2); probabilities are rounded to bf16 for P.V; the
// sum is divided by (l + 1e-30).  Masked scores are -inf: every row keeps
// key 0 (causal) or every key (not), and tile 0 is taken first, so a row's
// running max is finite from its first tile on.
//
// Bound on Hopper: operations.  Causal prefill at q (1, 32, 4096, 128), kv
// (1, 8, 4096, 128) does 4*hd per kept score, 137 GFLOP, on 83.9 MB: about
// 1,640 flops per byte, above the bf16 tensor cores' 295, so its least time
// is 137 GFLOP at 989 TFLOP/s, 0.139 ms.
//
// Design, point by point against the CUDA-core kernel it takes over from
// (csrc/flash_attention.cu):
// * It never touched the tensor cores.  Here S = Q.K^T and O += P.V run on
//   wgmma (bf16 in, fp32 accumulators in registers): m64nBKk16 with Q and
//   K read from shared memory, then m64nHDk16 with P from registers and V
//   from shared memory.
// * Its inner products were bound by shared-memory reads, and P went
//   through shared memory key by key.  wgmma reads its operands from shared
//   memory itself; the softmax works on the score accumulators in registers
//   (row max and sum over a thread's values, then across the quad of lanes
//   that share a row, exp2 with hd^-0.5 * log2 e folded into one FMA), and
//   the scores' accumulator layout is the register layout of wgmma's A
//   operand, so P never leaves registers.
// * It widened K and V to fp32 in shared memory, which capped its blocks
//   at 64 x 64.  Here they stay bf16, in the 128-byte swizzle that TMA
//   writes and wgmma reads (64 columns per swizzled 128-byte row): a block
//   owns 128 q rows, two consumer warpgroups of 64, and walks kv tiles of
//   64 keys (the default at every head dim) or 128 (hd 64 and 128; at hd
//   256 two stages of 128 would not fit beside Q in 227 KB).
// * Its loads were synchronous, between two __syncthreads().  Here one
//   producer thread issues every TMA load: Q once, then K and V tile by
//   tile into a ring of STAGES stages, with a "full" mbarrier per operand
//   (K first, so S starts before V lands) and an "empty" one per operand
//   that the consumers arrive on once they are done with it.  setmaxnreg
//   moves registers from the producer warpgroup to the consumers.  Inside a
//   consumer warpgroup, S_j is issued beside P_{j-1}.V_{j-1}, and the
//   softmax of S_j runs while that product is still on the tensor cores.
// * The layer copied q, k, v around the call (_repeat_kv, three
//   .contiguous(), an output transpose).  Here the tensor maps carry the
//   tensors' own strides (4-D: hd, rows, heads, batch), so q, k, v may be
//   transposed views of (B, S, heads, hd) activations and k, v keep their
//   Hkv heads.  The output leaves through the same kind of map: each
//   warpgroup stages its O in its rows of Q (swizzled) and one thread
//   stores them by TMA, which drops the rows past S.
// Causal blocks stop at kv tile ((qi+1)*BQ - 1)//BK (R2: the TPU kernel's
// (qi*BQ)//BK + 1 drops tiles when BQ > BK, as with the default 128 x 64);
// tiles past it are never loaded, only tiles that cross the diagonal or the
// ragged end are masked, and a warpgroup releases without computing the
// tiles whose keys all lie past its last row.  q tiles are launched
// last-first so the longest start early; the heads that share a kv head
// are launched side by side, so their K and V tiles meet in L2.
//
// hd 256 has kernels of its own (fa_wgmma_hd256_kernel and its combine),
// designed around PaliGemma's q (1, 8, 1024, 256) over one kv head, where
// 128-row blocks gave 64 blocks on 132 SMs with causal walks of 2 to 16
// tiles, and O's 128 fp32 accumulators beside S and P spilled:
// * Units and pairs.  A (batch, kv head)'s G q heads are cut into units of
//   64 rows (unit u = p G + g: rows [64 p, 64 p + 64) of head g), and a
//   block's two warpgroups take units 2 i and 2 i + 1: at an even G the
//   same rows of two heads, which walk the same causal bound and read every
//   K and V tile once for 128 rows.
// * Pieces.  Where the pairs are fewer than the SMs, the host cuts their
//   walks into pieces of nearly equal length until 132 blocks fill one wave
//   (flash_attention.split_walks; the table rides in the kernel's
//   parameters).  A piece over a pair's whole walk writes the output and
//   lse; the others write their unnormalised fp32 O, m and l to a slot, and
//   a second kernel combines each cut walk's slots in order: no atomics,
//   bitwise the same from call to call.
// * No spill.  ptxas gives a kernel one register count, from its launch
//   bounds, whatever setmaxnreg asks for later (a 384-thread block leaves
//   168 a thread), so these kernels have no producer warpgroup: 256
//   threads leave 255.  Thread 0 of the second warpgroup, which trails the
//   first, issues every TMA load, tile jj + 2 once it has released tile jj.
//   Within a warpgroup S_j no longer runs beside P_{j-1} V_{j-1}: O's 128
//   accumulators, S's 32 and P's 16 are the most a thread holds, and the
//   two warpgroups' products and softmax interleave on the SM.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;                    // q rows per block
constexpr int NCONS = 2;                   // consumer warpgroups, 64 rows each
constexpr int NTHREADS = (NCONS + 1) * 128;
constexpr int STAGES = 2;                  // K/V ring depth
// setmaxnreg: 128 * 24 + 256 * 240 = 64,512 of the SM's 65,536 registers
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr int CHUNK = 64;                  // bf16 columns per 128-byte row
constexpr int ROW_BYTES = 128;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int ENCODE_FAILED = 10000;       // + CUresult of the tensor map

template <int HD, int BK>
struct Layout {
    static constexpr int Q_BYTES = BQ * HD * 2;
    static constexpr int KV_BYTES = BK * HD * 2;
    static constexpr int Q_OFF = 0;
    static constexpr int K_OFF = Q_OFF + Q_BYTES;
    static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
    static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
    static constexpr int NBARS = 1 + 4 * STAGES;
    // + 1024: the base is aligned up to the swizzle's 1024-byte period
    static constexpr int SMEM = BAR_OFF + NBARS * 8 + 1024;
    static_assert(SMEM <= 232448, "tiles exceed a block's shared memory");
};

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

// one box from shared memory into a 4-D tensor map, as a bulk group; rows
// past the tensor's end are not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
        " [%0, {%2, %3, %4, %5}], [%1];"
        :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
           "r"(c2), "r"(c3) : "memory");
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
    // D(64x128, fp32) (+)= A(64x16, smem, K-major) * B(128x16, smem, K-major)^T
    static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "setp.ne.b32 p, %66, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
            "{"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
            "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
            "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
            "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
              "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
              "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
              "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
              "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
              "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
            : "l"(a), "l"(b), "r"(accumulate));
    }
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
    // D(64x256, fp32) (+)= A(64x16, smem, K-major) * B(256x16, smem, K-major)^T
    static __device__ __forceinline__ void ss(float (&d)[128], uint64_t a, uint64_t b, int accumulate) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "setp.ne.b32 p, %130, 0;\n"
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
            "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
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
            : "l"(a), "l"(b), "r"(accumulate));
    }
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

// the online softmax of one score tile, in place on its accumulator
// fragments: a thread holds rows row0 and row0 + 8, columns 8 b + 2 quad +
// {0, 1} of every 8-column block b.  Masks where the tile crosses the
// diagonal or the end of the keys, updates the running max m (of raw
// scores) and the thread's share of the denominator l, leaves
// p = exp2(s * scale_log2 - max) in sc and returns in alpha the factor that
// rescales the output accumulated so far.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], bool edge,
                                             int k0, int row0, int quad,
                                             int Sk, int causal,
                                             float scale_log2) {
    if (edge) {
#pragma unroll
        for (int n = 0; n < BK / 2; ++n) {
            const int col = k0 + (n >> 2) * 8 + 2 * quad + (n & 1);
            const int row = row0 + 8 * ((n >> 1) & 1);
            if (col >= Sk || (causal && col > row)) sc[n] = -INFINITY;
        }
    }
    float mx[2] = {m[0], m[1]}, ms[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < BK / 2; ++n) mx[(n >> 1) & 1] = fmaxf(mx[(n >> 1) & 1], sc[n]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        // a row with every key masked so far keeps max -inf and p = 0
        ms[i] = mx[i] == -INFINITY ? 0.f : mx[i] * scale_log2;
        alpha[i] = ex2(m[i] * scale_log2 - ms[i]);
        m[i] = mx[i];
    }
#pragma unroll
    for (int n = 0; n < BK / 2; ++n) {
        sc[n] = ex2(fmaf(sc[n], scale_log2, -ms[(n >> 1) & 1]));
        rs[(n >> 1) & 1] += sc[n];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
}

// P in bf16 as wgmma A fragments: score block n/4 (8 keys) feeds k-step
// n/8, whose registers hold (row0, keys 0-7), (row0+8, 0-7), (row0, 8-15),
// (row0+8, 8-15)
template <int BK>
__device__ __forceinline__ void pack_p(const float (&sc)[BK / 2],
                                       uint32_t (&p)[BK / 16][4]) {
#pragma unroll
    for (int n = 0; n < BK / 2; n += 2) p[n / 8][(n % 8) / 2] = pack_bf16(sc[n], sc[n + 1]);
}

template <int HD, int BK>
__global__ void __launch_bounds__(NTHREADS, 1)
fa_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                const __grid_constant__ CUtensorMap omap,
                float* __restrict__ lse, int H, int group, int S, int Sk,
                int causal, float scale_log2) {
    using L = Layout<HD, BK>;
    constexpr int ON = HD / 2;             // output accumulators per thread
    constexpr int PV_STEPS = BK / 16;      // k16 steps of O += P.V
    extern __shared__ uint8_t smem_raw[];
    const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
    const uint32_t sq = base + L::Q_OFF, sk = base + L::K_OFF,
                   sv = base + L::V_OFF, bars = base + L::BAR_OFF;
    // barriers: Q; then per stage full K, full V, empty K, empty V
    const uint32_t qbar = bars;
    auto full_k = [&](int s) { return bars + 8 * (1 + s); };
    auto full_v = [&](int s) { return bars + 8 * (1 + STAGES + s); };
    auto empty_k = [&](int s) { return bars + 8 * (1 + 2 * STAGES + s); };
    auto empty_v = [&](int s) { return bars + 8 * (1 + 3 * STAGES + s); };

    const int bh = blockIdx.x, b = bh / H, h = bh % H, hk = h / group;
    const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // last q tile first
    int nkv = (Sk + BK - 1) / BK;
    if (causal) nkv = min(nkv, (min(q0 + BQ, S) - 1) / BK + 1);

    if (threadIdx.x == 0) {
        mbar_init(qbar, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full_k(s), 1);
            mbar_init(full_v(s), 1);
            mbar_init(empty_k(s), NCONS * 128);
            mbar_init(empty_v(s), NCONS * 128);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    // warp-uniform, so that each role is one branch with its own registers
    const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
    if (wg == NCONS) {
        // ---- producer warpgroup: one thread issues every TMA load --------
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(PRODUCER_REGS));
        if (threadIdx.x == NCONS * 128) {
            mbar_expect_tx(qbar, L::Q_BYTES);
#pragma unroll
            for (int c = 0; c < HD / CHUNK; ++c)
                tma_load(sq + c * BQ * ROW_BYTES, &qmap, qbar, c * CHUNK, q0,
                         h, b);
            for (int j = 0; j < nkv; ++j) {
                const int s = j % STAGES;
                const uint32_t par = ((j / STAGES) & 1) ^ 1;
                mbar_wait(empty_k(s), par);
                mbar_expect_tx(full_k(s), L::KV_BYTES);
#pragma unroll
                for (int c = 0; c < HD / CHUNK; ++c)
                    tma_load(sk + s * L::KV_BYTES + c * BK * ROW_BYTES, &kmap,
                             full_k(s), c * CHUNK, j * BK, hk, b);
                mbar_wait(empty_v(s), par);
                mbar_expect_tx(full_v(s), L::KV_BYTES);
#pragma unroll
                for (int c = 0; c < HD / CHUNK; ++c)
                    tma_load(sv + s * L::KV_BYTES + c * BK * ROW_BYTES, &vmap,
                             full_v(s), c * CHUNK, j * BK, hk, b);
            }
        }
    } else {
        // ---- consumer warpgroup wg: q rows q0 + 64 wg .. + 63 ------------
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(CONSUMER_REGS));
        const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
        const int first = q0 + wg * 64;
        const int row0 = first + warp * 16 + lane / 4, quad = lane % 4;
        const uint32_t qs = sq + wg * 64 * ROW_BYTES;
        // S = Q.K^T of the tile in stage s: K-major operands, 16 columns
        // (32 bytes) per k-step, the next 64-column chunk every 4 steps
        auto qk = [&](float (&sc)[BK / 2], int s) {
            const uint64_t dq = smem_desc(qs, 16, 1024),
                           dk = smem_desc(sk + s * L::KV_BYTES, 16, 1024);
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk) {
                const uint32_t off = (kk % 4) * 32;
                Wgmma<BK>::ss(sc, dq + (((kk / 4) * BQ * ROW_BYTES + off) >> 4),
                              dk + (((kk / 4) * BK * ROW_BYTES + off) >> 4),
                              kk > 0);
            }
        };
        // O += P.V with V in stage s: V is MN-major (hd contiguous): 16
        // keys (2 KB) per k-step, the next 64 hd columns BK rows further
        auto pv = [&](float (&o)[ON], const uint32_t (&p)[PV_STEPS][4], int s) {
            const uint64_t dv = smem_desc(sv + s * L::KV_BYTES, BK * ROW_BYTES, 1024);
#pragma unroll
            for (int kk = 0; kk < PV_STEPS; ++kk)
                Wgmma<HD>::rs(o, p[kk], dv + ((kk * 16 * ROW_BYTES) >> 4));
        };
        auto edge = [&](int k0) {
            return k0 + BK > Sk || (causal && k0 + BK - 1 > first);
        };
        // the tiles past this warpgroup's last row are masked for all its
        // rows: it waits for them and releases them without computing
        const int nkw = causal ? min(nkv, (first + 63) / BK + 1) : nkv;
        float o[ON], sc[BK / 2], m[2] = {-INFINITY, -INFINITY},
              l[2] = {0.f, 0.f}, alpha[2];
        uint32_t pa[PV_STEPS][4];
#pragma unroll
        for (int i = 0; i < ON; ++i) o[i] = 0.f;
        mbar_wait(qbar, 0);

        // tile 0: S, then its softmax (no output to rescale yet)
        mbar_wait(full_k(0), 0);
        wgmma_fence();
        qk(sc, 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        mbar_arrive(empty_k(0));
        softmax_tile<BK>(sc, m, l, alpha, edge(0), 0, row0, quad, Sk, causal,
                         scale_log2);
        pack_p<BK>(sc, pa);

        // tile j: S_j on the tensor cores beside P_{j-1}.V_{j-1}; the
        // softmax of S_j runs while P_{j-1}.V_{j-1} is still in flight, and
        // its P replaces P_{j-1} once that product has retired
        for (int j = 1; j < nkw; ++j) {
            const int s = j % STAGES, sp = (j - 1) % STAGES;
            mbar_wait(full_k(s), (j / STAGES) & 1);
            wgmma_fence();
            qk(sc, s);
            wgmma_commit();
#pragma unroll
            for (int n = 0; n < ON; ++n) o[n] *= alpha[(n >> 1) & 1];
            mbar_wait(full_v(sp), ((j - 1) / STAGES) & 1);
            wgmma_fence();
            pv(o, pa, sp);
            wgmma_commit();
            wgmma_wait<1>();
            fence_regs(sc);
            mbar_arrive(empty_k(s));
            softmax_tile<BK>(sc, m, l, alpha, edge(j * BK), j * BK, row0,
                             quad, Sk, causal, scale_log2);
            wgmma_wait<0>();
            fence_regs(o);
            mbar_arrive(empty_v(sp));
            pack_p<BK>(sc, pa);
        }
#pragma unroll
        for (int n = 0; n < ON; ++n) o[n] *= alpha[(n >> 1) & 1];
        const int sl = (nkw - 1) % STAGES;
        mbar_wait(full_v(sl), ((nkw - 1) / STAGES) & 1);
        wgmma_fence();
        pv(o, pa, sl);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
        mbar_arrive(empty_v(sl));
        for (int j = nkw; j < nkv; ++j) {
            const int s = j % STAGES;
            mbar_wait(full_k(s), (j / STAGES) & 1);
            mbar_wait(full_v(s), (j / STAGES) & 1);
            mbar_arrive(empty_k(s));
            mbar_arrive(empty_v(s));
        }

        float inv[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            float li = l[i];
            li += __shfl_xor_sync(0xffffffffu, li, 1);
            li += __shfl_xor_sync(0xffffffffu, li, 2);
            inv[i] = 1.f / (li + 1e-30f);
            // the row's log-sum-exp of the scaled scores, for the backward
            const int row = row0 + 8 * i;
            if (lse != nullptr && quad == 0 && row < S)
                lse[(long long)bh * S + row] = (m[i] * scale_log2 + log2f(li)) * LN2;
        }
        // O goes out through this warpgroup's rows of Q, which no product
        // reads any more, in the 128-byte swizzle the output's tensor map
        // takes: TMA writes whole rows and drops those past S
        const int r = warp * 16 + lane / 4;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int rr = r + 8 * i;
#pragma unroll
            for (int jb = 0; jb < HD / 8; ++jb) {
                const int n = jb * 4 + 2 * i;
                const uint32_t dst = qs + (jb / 8) * BQ * ROW_BYTES + rr * ROW_BYTES
                                   + (((jb % 8) ^ (rr % 8)) * 16) + 4 * quad;
                const uint32_t v = pack_bf16(o[n] * inv[i], o[n + 1] * inv[i]);
                asm volatile("st.shared.b32 [%0], %1;" :: "r"(dst), "r"(v) : "memory");
            }
        }
        // the generic-proxy writes above are read by TMA (the async proxy)
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        asm volatile("bar.sync %0, 128;" :: "r"(1 + wg) : "memory");
        if (t == 0) {
#pragma unroll
            for (int c = 0; c < HD / CHUNK; ++c)
                tma_store(&omap, qs + c * BQ * ROW_BYTES, c * CHUNK, first, h, b);
            asm volatile("cp.async.bulk.commit_group;" ::: "memory");
            asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
        }
    }
}

// ---------------------------------------------------------------------------
// bf16 at hd 256: units of 64 rows in pairs, walks cut into pieces
// ---------------------------------------------------------------------------

constexpr int UNIT = 64;                   // q rows of a consumer warpgroup
constexpr int HD256 = 256, BK256 = 64;
constexpr int MAX_PIECES = 132;            // a launch's table: the H100's SMs
constexpr int COMBINE_ROWS = 8;            // rows of a combine block, a warp each
// two consumer warpgroups and no producer: ptxas allocates one register
// count for the whole kernel from its launch bounds (whatever setmaxnreg
// asks for later) and a block's warps in fours, so 256 threads leave 255
// registers a thread where 384 (or 288) leave 168, under O's 128
// accumulators with S's and P's
constexpr int NTHREADS256 = NCONS * 128;

// a block's piece: item (pair of units) `item`, kv tiles [start, stop);
// slot -1 where that is the item's whole walk, else its fp32 partial
struct Piece { int item, start, stop, slot; };
// n = 0: no table, block x takes an item's whole walk (each (batch, kv
// head)'s pairs last-first, so the longest walks start first)
struct PieceTable { int n; Piece p[MAX_PIECES]; };
// an item whose walk was cut: its pieces' first slot and their count
struct SumEntry { short item, slot0, count, pad; };
struct SumTable { int n; SumEntry e[MAX_PIECES]; };

// kv tiles of bk keys that q rows [64 p, 64 p + 64) walk
__device__ __forceinline__ int unit_walk(int p, int S, int Sk, int causal,
                                         int bk) {
    const int nk = (Sk + bk - 1) / bk;
    return causal ? min(nk, (min(UNIT * (p + 1), S) - 1) / bk + 1) : nk;
}

// One piece: the two units of a pair (unit u = p G + g of a (batch, kv
// head) holds rows [64 p, 64 p + 64) of its group's q head g; warpgroup w
// takes unit 2 i + w, which share the kv head and so every K and V tile)
// over kv tiles [start, stop).  A warpgroup computes the tiles within its
// own unit's causal bound and releases the rest.  No S_j beside
// P_{j-1} V_{j-1} within a warpgroup: O's 128 accumulators, S's 32 and P's
// 16 are the most a thread holds; the two warpgroups' products and softmax
// interleave on the SM.  A whole walk (slot -1) writes the bf16 output and
// lse as fa_wgmma_kernel does; a piece writes its unnormalised fp32 O, its
// rows' running max m (raw scores) and denominator l to `slot`.
__global__ void __launch_bounds__(NTHREADS256, 1)
fa_wgmma_hd256_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap omap,
                      float* __restrict__ lse, float* __restrict__ part_o,
                      float* __restrict__ part_ml, int H, int Hkv, int group,
                      int S, int Sk, int causal, float scale_log2,
                      const __grid_constant__ PieceTable tab) {
    using L = Layout<HD256, BK256>;
    constexpr int HD = HD256, BK = BK256;
    constexpr int ON = HD / 2, PV_STEPS = BK / 16;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
    const uint32_t sq = base + L::Q_OFF, sk = base + L::K_OFF,
                   sv = base + L::V_OFF, bars = base + L::BAR_OFF;
    const uint32_t qbar = bars;
    auto full_k = [&](int s) { return bars + 8 * (1 + s); };
    auto full_v = [&](int s) { return bars + 8 * (1 + STAGES + s); };
    auto empty_k = [&](int s) { return bars + 8 * (1 + 2 * STAGES + s); };
    auto empty_v = [&](int s) { return bars + 8 * (1 + 3 * STAGES + s); };

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
    // warpgroup w's unit 2 i + w: its q head, first row and walk (0: none)
    auto head = [&](int w) { return hk * group + (2 * pi + w) % group; };
    auto first_row = [&](int w) { return (2 * pi + w) / group * UNIT; };
    auto walk = [&](int w) {
        return 2 * pi + w < U ? unit_walk((2 * pi + w) / group, S, Sk, causal, BK) : 0;
    };
    if (j1 < 0) j1 = max(walk(0), walk(1));
    const int ntiles = j1 - j0;

    if (threadIdx.x == 0) {
        mbar_init(qbar, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full_k(s), 1);
            mbar_init(full_v(s), 1);
            mbar_init(empty_k(s), NCONS * 128);
            mbar_init(empty_v(s), NCONS * 128);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    // thread 0 of the last warpgroup issues every TMA load: Q and the first
    // STAGES tiles, then tile jj + STAGES once it has released tile jj,
    // waiting there for the first warpgroup, which leads
    const bool loader = threadIdx.x == (NCONS - 1) * 128;
    auto load_kv = [&](int jj) {           // tile j0 + jj, stage jj % STAGES
        const int j = j0 + jj, s = jj % STAGES;
        const uint32_t par = ((jj / STAGES) & 1) ^ 1;
        mbar_wait(empty_k(s), par);
        mbar_expect_tx(full_k(s), L::KV_BYTES);
#pragma unroll
        for (int c = 0; c < HD / CHUNK; ++c)
            tma_load(sk + s * L::KV_BYTES + c * BK * ROW_BYTES, &kmap,
                     full_k(s), c * CHUNK, j * BK, hk, b);
        mbar_wait(empty_v(s), par);
        mbar_expect_tx(full_v(s), L::KV_BYTES);
#pragma unroll
        for (int c = 0; c < HD / CHUNK; ++c)
            tma_load(sv + s * L::KV_BYTES + c * BK * ROW_BYTES, &vmap,
                     full_v(s), c * CHUNK, j * BK, hk, b);
    };
    if (loader) {
        // unit 2 i is always there; unit 2 i + 1 where U allows
        mbar_expect_tx(qbar, ((walk(1) > 0) + 1) * UNIT * HD * 2);
#pragma unroll
        for (int w = 0; w < NCONS; ++w) {
            if (walk(w) == 0) continue;
#pragma unroll
            for (int c = 0; c < HD / CHUNK; ++c)
                tma_load(sq + c * BQ * ROW_BYTES + w * UNIT * ROW_BYTES,
                         &qmap, qbar, c * CHUNK, first_row(w), head(w), b);
        }
        for (int jj = 0; jj < min(STAGES, ntiles); ++jj) load_kv(jj);
    }
    __syncwarp();

    const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
    {
        // ---- consumer warpgroup wg: its unit's 64 rows ---------------------
        const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
        const int h = head(wg), first = first_row(wg), nw = walk(wg);
        const int row0 = first + warp * 16 + lane / 4, quad = lane % 4;
        const uint32_t qs = sq + wg * UNIT * ROW_BYTES;
        auto qk = [&](float (&sc)[BK / 2], int s) {
            const uint64_t dq = smem_desc(qs, 16, 1024),
                           dk = smem_desc(sk + s * L::KV_BYTES, 16, 1024);
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk) {
                const uint32_t off = (kk % 4) * 32;
                Wgmma<BK>::ss(sc, dq + (((kk / 4) * BQ * ROW_BYTES + off) >> 4),
                              dk + (((kk / 4) * BK * ROW_BYTES + off) >> 4),
                              kk > 0);
            }
        };
        auto pv = [&](float (&o)[ON], const uint32_t (&p)[PV_STEPS][4], int s) {
            const uint64_t dv = smem_desc(sv + s * L::KV_BYTES, BK * ROW_BYTES, 1024);
#pragma unroll
            for (int kk = 0; kk < PV_STEPS; ++kk)
                Wgmma<HD>::rs(o, p[kk], dv + ((kk * 16 * ROW_BYTES) >> 4));
        };
        const int jend = min(j1, nw);          // it computes [j0, jend)
        float o[ON], sc[BK / 2], m[2] = {-INFINITY, -INFINITY},
              l[2] = {0.f, 0.f}, alpha[2];
        uint32_t pa[PV_STEPS][4];
#pragma unroll
        for (int i = 0; i < ON; ++i) o[i] = 0.f;
        mbar_wait(qbar, 0);
        for (int jj = 0; jj < ntiles; ++jj) {
            const int j = j0 + jj, s = jj % STAGES;
            const uint32_t par = (jj / STAGES) & 1;
            mbar_wait(full_k(s), par);
            if (j >= jend) {
                // past this unit's causal bound (or no unit): release
                mbar_arrive(empty_k(s));
                mbar_wait(full_v(s), par);
                mbar_arrive(empty_v(s));
            } else {
                wgmma_fence();
                qk(sc, s);
                wgmma_commit();
                wgmma_wait<0>();
                fence_regs(sc);
                mbar_arrive(empty_k(s));
                const int k0 = j * BK;
                const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > first);
                softmax_tile<BK>(sc, m, l, alpha, edge, k0, row0, quad, Sk,
                                 causal, scale_log2);
#pragma unroll
                for (int n = 0; n < ON; ++n) o[n] *= alpha[(n >> 1) & 1];
                pack_p<BK>(sc, pa);
                mbar_wait(full_v(s), par);
                wgmma_fence();
                pv(o, pa, s);
                wgmma_commit();
                wgmma_wait<0>();
                fence_regs(o);
                mbar_arrive(empty_v(s));
            }
            if (loader && jj + STAGES < ntiles) load_kv(jj + STAGES);
            __syncwarp();
        }
        if (nw == 0) return;                   // no unit: nothing to write

        float ls[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            ls[i] = l[i];
            ls[i] += __shfl_xor_sync(0xffffffffu, ls[i], 1);
            ls[i] += __shfl_xor_sync(0xffffffffu, ls[i], 2);
        }
        const int r = warp * 16 + lane / 4;    // rows r, r + 8 of the unit
        if (slot >= 0) {
            // the piece's partial: O unnormalised, then (m, l) a row
            const long long at = ((long long)slot * NCONS + wg) * UNIT;
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                float* po = part_o + (at + r + 8 * i) * HD;
#pragma unroll
                for (int jb = 0; jb < HD / 8; ++jb) {
                    const int n = jb * 4 + 2 * i;
                    *reinterpret_cast<float2*>(po + jb * 8 + 2 * quad) =
                        make_float2(o[n], o[n + 1]);
                }
                if (quad == 0)
                    *reinterpret_cast<float2*>(part_ml + (at + r + 8 * i) * 2) =
                        make_float2(m[i], ls[i]);
            }
            return;
        }
        float inv[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            inv[i] = 1.f / (ls[i] + 1e-30f);
            const int row = row0 + 8 * i;
            if (lse != nullptr && quad == 0 && row < S)
                lse[((long long)b * H + h) * S + row] =
                    (m[i] * scale_log2 + log2f(ls[i])) * LN2;
        }
        // O goes out through this warpgroup's rows of Q, as fa_wgmma_kernel's
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int rr = r + 8 * i;
#pragma unroll
            for (int jb = 0; jb < HD / 8; ++jb) {
                const int n = jb * 4 + 2 * i;
                const uint32_t dst = qs + (jb / 8) * BQ * ROW_BYTES + rr * ROW_BYTES
                                   + (((jb % 8) ^ (rr % 8)) * 16) + 4 * quad;
                const uint32_t v = pack_bf16(o[n] * inv[i], o[n + 1] * inv[i]);
                asm volatile("st.shared.b32 [%0], %1;" :: "r"(dst), "r"(v) : "memory");
            }
        }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        asm volatile("bar.sync %0, 128;" :: "r"(1 + wg) : "memory");
        if (t == 0) {
#pragma unroll
            for (int c = 0; c < HD / CHUNK; ++c)
                tma_store(&omap, qs + c * BQ * ROW_BYTES, c * CHUNK, first, h, b);
            asm volatile("cp.async.bulk.commit_group;" ::: "memory");
            asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
        }
    }
}

// The pieces of each cut item, combined in slot order: M = max m, w_c =
// 2^((m_c - M) scale log2 e), O = sum w_c O_c / (sum w_c l_c + 1e-30), the
// row's lse from M and the sum.  A block takes COMBINE_ROWS rows of a unit
// of an item, a warp a row, a lane 8 head dims (16 bytes of output); the
// lanes' loads of every piece are independent, so they are all in flight
__global__ void __launch_bounds__(COMBINE_ROWS * 32)
fa_wgmma_hd256_combine_kernel(const float* __restrict__ part_o,
                              const float* __restrict__ part_ml,
                              __nv_bfloat16* __restrict__ out,
                              float* __restrict__ lse, long long so0,
                              long long so1, long long so2, int H, int Hkv,
                              int group, int S, float scale_log2,
                              const __grid_constant__ SumTable tab) {
    constexpr int BLOCKS = UNIT / COMBINE_ROWS;      // blocks a unit
    const SumEntry e = tab.e[blockIdx.x / (NCONS * BLOCKS)];
    const int w = blockIdx.x / BLOCKS % NCONS;
    const int U = (S + UNIT - 1) / UNIT * group, npair = (U + 1) / 2;
    const int bhk = e.item / npair, u = 2 * (e.item % npair) + w;
    const int r = blockIdx.x % BLOCKS * COMBINE_ROWS + threadIdx.x / 32;
    const int row = u / group * UNIT + r, lane = threadIdx.x % 32;
    if (u >= U || row >= S) return;
    const int b = bhk / Hkv, h = bhk % Hkv * group + u % group;
    float M = -INFINITY;
    for (int c = 0; c < e.count; ++c)
        M = fmaxf(M, part_ml[(((long long)(e.slot0 + c) * NCONS + w) * UNIT + r) * 2]);
    const float ms = M * scale_log2;
    float sum = 0.f, acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.f;
#pragma unroll 4
    for (int c = 0; c < e.count; ++c) {
        const long long at = ((long long)(e.slot0 + c) * NCONS + w) * UNIT + r;
        const float2 ml = *reinterpret_cast<const float2*>(part_ml + at * 2);
        const float wc = ex2(ml.x * scale_log2 - ms);
        sum += ml.y * wc;
        const float4* src = reinterpret_cast<const float4*>(part_o + at * HD256 + lane * 8);
        const float4 x = src[0], y = src[1];
        acc[0] += x.x * wc; acc[1] += x.y * wc; acc[2] += x.z * wc; acc[3] += x.w * wc;
        acc[4] += y.x * wc; acc[5] += y.y * wc; acc[6] += y.z * wc; acc[7] += y.w * wc;
    }
    const float inv = 1.f / (sum + 1e-30f);
    uint4 v;
    v.x = pack_bf16(acc[0] * inv, acc[1] * inv);
    v.y = pack_bf16(acc[2] * inv, acc[3] * inv);
    v.z = pack_bf16(acc[4] * inv, acc[5] * inv);
    v.w = pack_bf16(acc[6] * inv, acc[7] * inv);
    *reinterpret_cast<uint4*>(out + b * so0 + h * so1 + row * so2 + lane * 8) = v;
    if (lse != nullptr && lane == 0)
        lse[((long long)b * H + h) * S + row] = (ms + log2f(sum)) * LN2;
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
// head, row); boxes of 64 columns by box_rows rows, 128-byte swizzle
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

template <int HD, int BK>
int launch(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
           const CUtensorMap& om, float* lse, int B, int H, int group, int S,
           int Sk, int causal, float scale_log2, cudaStream_t stream) {
    constexpr int smem = Layout<HD, BK>::SMEM;
    cudaError_t err = cudaFuncSetAttribute(
        fa_wgmma_kernel<HD, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(B * H, (S + BQ - 1) / BQ);
    fa_wgmma_kernel<HD, BK><<<grid, NTHREADS, smem, stream>>>(
        qm, km, vm, om, lse, H, group, S, Sk, causal, scale_log2);
    return (int)cudaGetLastError();
}

}  // namespace

// q (B, H, S, hd), k and v (B, Hkv, Sk, hd), out (B, H, S, hd), all bf16,
// each with element strides (batch, head, row) in `strides` (q, k, v, out:
// 12 values) and a unit-stride last dim.  block_k is the kv tile (the q
// tile is 128 rows); scale is hd^-0.5 as the caller rounds it to fp32.
// lse, when not null, receives each row's log-sum-exp of the scaled scores,
// (B, H, S) fp32 contiguous (for the backward kernel).
extern "C" int flash_attention_wgmma_bf16(
        const void* q, const void* k, const void* v, void* out, float* lse,
        int B, int H,
        int Hkv, int S, int Sk, int hd, int block_k, int causal, float scale,
        const long long* strides, void* stream) {
    if (B < 1 || H < 1 || Hkv < 1 || H % Hkv || S < 1 || Sk < 1)
        return (int)cudaErrorInvalidValue;
    CUtensorMap qm, km, vm, om;
    int rc = encode(&qm, q, hd, S, H, B, strides, BQ);
    if (!rc) rc = encode(&km, k, hd, Sk, Hkv, B, strides + 3, block_k);
    if (!rc) rc = encode(&vm, v, hd, Sk, Hkv, B, strides + 6, block_k);
    if (!rc) rc = encode(&om, out, hd, S, H, B, strides + 9, BQ / NCONS);
    if (rc) return rc;
    const float sl = scale * LOG2E;
    const int g = H / Hkv;
    cudaStream_t st = (cudaStream_t)stream;
    if (hd == 64 && block_k == 128)
        return launch<64, 128>(qm, km, vm, om, lse, B, H, g, S, Sk, causal, sl, st);
    if (hd == 64 && block_k == 64)
        return launch<64, 64>(qm, km, vm, om, lse, B, H, g, S, Sk, causal, sl, st);
    if (hd == 128 && block_k == 128)
        return launch<128, 128>(qm, km, vm, om, lse, B, H, g, S, Sk, causal, sl, st);
    if (hd == 128 && block_k == 64)
        return launch<128, 64>(qm, km, vm, om, lse, B, H, g, S, Sk, causal, sl, st);
    return (int)cudaErrorInvalidValue;
}

// bf16 at hd 256: q (B, H, S, 256), k and v (B, Hkv, Sk, 256), out as q,
// strides as flash_attention_wgmma_bf16's; lse as there or null.  pieces:
// npieces (item, start, stop, slot) int quadruples, a block each (npieces
// 0: a block an item, its whole walk); sums: nsums (item, first slot,
// count) triples, the cut items the combine kernel finishes.  part_o
// (slots, 2, 64, 256) and part_ml (slots, 2, 64, 2) fp32 scratch.
// Launches 1 kernel on `stream`, 2 when nsums > 0.
extern "C" int flash_attention_wgmma_hd256(
        const void* q, const void* k, const void* v, void* out, float* lse,
        float* part_o, float* part_ml, int B, int H, int Hkv, int S, int Sk,
        int causal, float scale, const long long* strides, const int* pieces,
        int npieces, const int* sums, int nsums, void* stream) {
    if (B < 1 || H < 1 || Hkv < 1 || H % Hkv || S < 1 || Sk < 1
        || npieces < 0 || npieces > MAX_PIECES || nsums < 0
        || nsums > MAX_PIECES || (nsums > 0 && npieces == 0))
        return (int)cudaErrorInvalidValue;
    CUtensorMap qm, km, vm, om;
    int rc = encode(&qm, q, HD256, S, H, B, strides, UNIT);
    if (!rc) rc = encode(&km, k, HD256, Sk, Hkv, B, strides + 3, BK256);
    if (!rc) rc = encode(&vm, v, HD256, Sk, Hkv, B, strides + 6, BK256);
    if (!rc) rc = encode(&om, out, HD256, S, H, B, strides + 9, UNIT);
    if (rc) return rc;
    const float sl = scale * LOG2E;
    const int G = H / Hkv, U = (S + UNIT - 1) / UNIT * G, npair = (U + 1) / 2;
    cudaStream_t st = (cudaStream_t)stream;
    PieceTable tab;
    tab.n = npieces;
    for (int i = 0; i < npieces; ++i)
        tab.p[i] = Piece{pieces[4 * i], pieces[4 * i + 1], pieces[4 * i + 2],
                         pieces[4 * i + 3]};
    constexpr int smem = Layout<HD256, BK256>::SMEM;
    cudaError_t err = cudaFuncSetAttribute(
        fa_wgmma_hd256_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const unsigned grid = npieces ? npieces : (unsigned)(B * Hkv * npair);
    fa_wgmma_hd256_kernel<<<grid, NTHREADS256, smem, st>>>(
        qm, km, vm, om, lse, part_o, part_ml, H, Hkv, G, S, Sk, causal, sl, tab);
    err = cudaGetLastError();
    if (err != cudaSuccess || nsums == 0) return (int)err;
    SumTable sums_t;
    sums_t.n = nsums;
    for (int i = 0; i < nsums; ++i)
        sums_t.e[i] = SumEntry{(short)sums[3 * i], (short)sums[3 * i + 1],
                               (short)sums[3 * i + 2], 0};
    fa_wgmma_hd256_combine_kernel<<<NCONS * nsums * (UNIT / COMBINE_ROWS),
                                    COMBINE_ROWS * 32, 0, st>>>(
        part_o, part_ml, (__nv_bfloat16*)out, lse, strides[9], strides[10],
        strides[11], H, Hkv, G, S, sl, sums_t);
    return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int e) {
    if (e >= ENCODE_FAILED)
        return "cuTensorMapEncodeTiled refused the tensor map (CUresult = "
               "code - 10000)";
    return cudaGetErrorString((cudaError_t)e);
}
