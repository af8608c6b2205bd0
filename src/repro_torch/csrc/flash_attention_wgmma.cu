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
    if (hd == 256 && block_k == 64)
        return launch<256, 64>(qm, km, vm, om, lse, B, H, g, S, Sk, causal, sl, st);
    return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_error_string(int e) {
    if (e >= ENCODE_FAILED)
        return "cuTensorMapEncodeTiled refused the tensor map (CUresult = "
               "code - 10000)";
    return cudaGetErrorString((cudaError_t)e);
}
