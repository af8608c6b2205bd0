// Flash attention, forward, float32, on Hopper's tensor cores (wgmma)
// through error-compensated TF32 ("3xTF32").
//
// Replaces: src/repro/kernels/flash_attention.py::_fa_kernel (line 22) in
// float32, the Pallas TPU kernel launched by flash_attention (grid (B*H,
// S/block_q)), at head dims 64, 128 and 256 (gemma-7b's); f32 at 16 and 32
// stays on the CUDA-core kernel, csrc/flash_attention.cu.
//
// What it computes: out = softmax(q k^T * hd^-0.5 [+ causal mask]) v over
// (B, H, S, hd) float32 tensors whose k and v may have fewer heads (q head h
// reads kv head h / (H / Hkv)).  q is scaled in fp32 before the product,
// masked scores are -1e30 and the sum is divided by (l + 1e-30), as in the
// TPU kernel and the model's chunked attention.
//
// Bound on Hopper: operations.  Causal at (1, 32, 1024, 128) does 4*hd per
// kept score, 8.6 GFLOP on 67 MB: 0.128 ms on the CUDA cores' 67 TFLOP/s,
// 0.017 ms of TF32 tensor-core time (495 TFLOP/s dense) per product pass.
// Plain TF32 keeps 10 mantissa bits and misses the 2e-5 limit, so each
// operand is split into hi = rna_tf32(x) and lo = rna_tf32(x - hi) and each
// product is lo*hi + hi*lo + hi*hi, the small terms first: three passes,
// 0.052 ms of tensor-core time.  Gemma-7b's (1, 16, 1024, 256) is the same
// 8.6 GFLOP: 0.052 ms again.
//
// Design (hd 64 and 128; hd 256 below): one warpgroup (4 warps) per (b*h,
// 64 q rows); kv tiles of 32 keys.
// * The products run on wgmma (TF32 in, fp32 accumulators): S = Q K^T as
//   m64n32k8 with Q and K read from shared memory, O += P V as m64nHDk8 with
//   P from registers.  On an H100 an mma.sync form of this kernel spent
//   0.1 ms a product pass at the shape above, twice sdpa's whole time.
// * wgmma reads TF32 operands K-major only: rows of Q and K run along hd,
//   which is K; V's run along hd too, which is N, so V is stored transposed.
//   Every operand sits in the 128-byte swizzle wgmma reads (32 floats a
//   row), in a hi and a lo copy.
// * K and V tiles come by 16-byte cp.async into a raw stage; the warpgroup
//   splits each element into its hi and lo copies (V transposed on the
//   way) in one of two buffers, the next tile's while this tile's S runs on
//   the tensor cores, and the copy of the tile after it runs meanwhile.  q
//   is split once.  rna_tf32 is integer arithmetic on the bits (add half of
//   the 13 dropped bits, mask them): the same value as cvt.rna.tf32.f32.
// * Accuracy: the tensor cores truncate each accumulation, which over long
//   chains breaks 2e-5.  S sums its small terms in one accumulator and the
//   hi*hi products in two (half of hd each), added in fp32 rounded to
//   nearest; each tile's P V goes to a fresh accumulator and
//   O = O * alpha + PV is rounded to nearest, as acc*alpha + p@v in the
//   plain version.
// * P: S's accumulator layout is not wgmma's A-operand layout for TF32; P
//   moves by warp shuffles within each quad.
// * Online softmax in fp32 with expf, as the plain version.  A causal block
//   stops at the kv tile that holds its last row; masked tiles past a row's
//   diagonal add exact zeros, so the kernel's 64 x 32 tiles compute the
//   function of any (block_q, block_k) the plain version walks, up to
//   rounding.  Ragged tails are masked and zero-filled; q blocks launch
//   last-first.
//
// hd 256 (fa_tf32x3_hd256_kernel): Q's hi and lo copies alone take 128 KB of
// the 227, and a 32-key tile's split K and V^T take 128 KB more, so the
// layout of the smaller head dims (two split buffers and a raw stage,
// about 449 KB here) cannot be kept.  Kept: Q split once, kv tiles of 16
// keys, one split buffer each for K (32 KB) and V^T (32 KB) and one raw
// stage each for K and V (16 KB each): 225 KB.  With a single buffer the
// split of the next tile cannot run under this tile's products, so the two
// operands take turns instead: V_j is split while S_j runs, K_{j+1} while
// P_j V_j runs, each from a raw stage that cp.async filled a tile ahead.
// V^T's rows hold the tile's 16 keys (64 bytes), in the 64-byte swizzle.
// S is m64n16k8: the hi*hi products in eight accumulators of 32 dims (the
// tensor cores truncate as they accumulate; chains of 4 k-steps) and the
// small terms in two, issued in turn so that independent chains overlap.
// O (64 x 256 in fp32) is 128 registers a thread, so P V runs 64 output
// dims at a time (m64n64k8), each into a fresh accumulator, two in flight.
// wgmma descriptors are built from bases the compiler may not hoist (a
// hoisted constant for each of the S product's 192 operands spilled).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 128;            // one warpgroup
constexpr int BQ = 64;                   // q rows per block
constexpr int BK = 32;                   // keys per kv tile
constexpr int ROW = 128;                 // bytes per swizzled row: 32 floats
constexpr float NEG_INF = -1e30f;

struct Strides {                         // element strides (batch, head, row)
    long long q[3], k[3], v[3], o[3];
};

template <int HD>
struct Layout {
    static constexpr int Q_BYTES = BQ * HD * 4;      // one copy, hi or lo
    static constexpr int T_BYTES = BK * HD * 4;      // one copy of K or V^T
    static constexpr int QH = 0, QL = QH + Q_BYTES;
    // two buffers of a split tile: K hi, K lo, V^T hi, V^T lo
    static constexpr int KV = QL + Q_BYTES, KV_BYTES = 4 * T_BYTES;
    static constexpr int KH = 0, KL = T_BYTES, VH = 2 * T_BYTES,
                         VL = 3 * T_BYTES;            // within a buffer
    static constexpr int RAW = KV + 2 * KV_BYTES;    // K and V, row-major
    // + 1024: the base is aligned up to the swizzle's 1024-byte period
    static constexpr int SMEM = RAW + 2 * T_BYTES + 1024;
    static_assert(SMEM <= 232448, "tiles exceed a block's shared memory");
};

// byte offset of element (r, k) of a K-major operand of R rows in the
// 128-byte swizzle: 32-float slabs of K, R rows of 128 bytes each, the
// 16-byte chunks of row r permuted by r % 8
__device__ __forceinline__ int swz(int r, int k, int R) {
    return (k >> 5) * R * ROW + r * ROW + ((((k & 31) >> 2) ^ (r & 7)) << 4)
           + ((k & 3) << 2);
}

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
// zero (the bits are sign-magnitude, so adding half rounds the magnitude)
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

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFF) >> 4)
         | (uint64_t)(16 >> 4) << 16           // leading offset: unused
         | (uint64_t)(1024 >> 4) << 32         // 8 rows of 128 bytes
         | (uint64_t)1 << 62;
}

// byte offset of element (r, k) of a K-major operand whose rows hold 16
// floats (64 bytes) in the 64-byte swizzle: the 16-byte chunks of row r
// permuted by (r / 2) % 4 (address bits 4-5 xor bits 7-8)
__device__ __forceinline__ int swz64(int r, int k) {
    return r * 64 + ((((k & 15) >> 2) ^ ((r >> 1) & 3)) << 4) + ((k & 3) << 2);
}

// wgmma shared-memory descriptor, 64-byte swizzle
__device__ __forceinline__ uint64_t smem_desc64(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFF) >> 4)
         | (uint64_t)(16 >> 4) << 16           // leading offset: unused
         | (uint64_t)(512 >> 4) << 32          // 8 rows of 64 bytes
         | (uint64_t)2 << 62;
}

// x, which the compiler must take as computed here (not hoisted, not known)
__device__ __forceinline__ uint64_t opaque(uint64_t x) {
    asm volatile("" : "+l"(x));
    return x;
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
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

// keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

template <int N> struct WgmmaSS;
template <int N> struct WgmmaRS;

template <> struct WgmmaSS<16> {
    // D(64x16, fp32) (+)= A(64x8, smem, K-major) * B(16x8, smem, K-major)^T
    static __device__ __forceinline__ void run(float (&d)[8], uint64_t a, uint64_t b, int accumulate) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "setp.ne.b32 p, %10, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
            "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
            : "l"(a), "l"(b), "r"(accumulate));
    }
};

template <> struct WgmmaSS<32> {
    // D(64x32, fp32) (+)= A(64x8, smem, K-major) * B(32x8, smem, K-major)^T
    static __device__ __forceinline__ void run(float (&d)[16], uint64_t a, uint64_t b, int accumulate) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "setp.ne.b32 p, %18, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
            : "l"(a), "l"(b), "r"(accumulate));
    }
};

template <> struct WgmmaRS<64> {
    // D(64x64, fp32) (+)= A(64x8, registers) * B(64x8, smem, K-major)^T
    static __device__ __forceinline__ void run(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int accumulate) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "setp.ne.b32 p, %37, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
              "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
    }
};

template <> struct WgmmaRS<128> {
    // D(64x128, fp32) (+)= A(64x8, registers) * B(128x8, smem, K-major)^T
    static __device__ __forceinline__ void run(float (&d)[64], const uint32_t (&a)[4], uint64_t b, int accumulate) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "setp.ne.b32 p, %69, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
              "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
              "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
              "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
              "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
              "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
    }
};


template <int HD>
__global__ void __launch_bounds__(NTHREADS, 1)
fa_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, Strides st, int H, int G, int S,
                 int Sk, int causal, float scale) {
    using L = Layout<HD>;
    constexpr int C4 = HD / 4;           // 16-byte chunks of a row
    constexpr int ON = HD / 2;           // output accumulators per thread
    extern __shared__ uint8_t smem_raw[];
    const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
    const float* rawp = reinterpret_cast<const float*>(
        smem_raw + (base - smem_u32(smem_raw)) + L::RAW);

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, tg = lane % 4;   // fragment row group, column
    const int bh = blockIdx.x, b = bh / H, h = bh % H, hkv = h / G;
    const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // last q block first
    const float* qp = q + b * st.q[0] + h * st.q[1];
    const float* kp = k + b * st.k[0] + hkv * st.k[1];
    const float* vp = v + b * st.v[0] + hkv * st.v[1];
    float* op = out + b * st.o[0] + h * st.o[1];

    int nkv = (Sk + BK - 1) / BK;
    if (causal) nkv = min(nkv, (min(q0 + BQ, S) - 1) / BK + 1);

    // tile j's K and V rows into the raw stage, keys past Sk zero-filled
    auto issue = [&](int j) {
        const uint32_t dst = base + L::RAW;
        for (int e = tid; e < BK * C4; e += NTHREADS) {
            const int kt = e / C4, d = (e % C4) * 4, gk = j * BK + kt;
            const bool ok = gk < Sk;
            cp_async16(dst + (kt * HD + d) * 4, ok ? kp + gk * st.k[2] + d : kp, ok);
            cp_async16(dst + (BK * HD + kt * HD + d) * 4,
                       ok ? vp + gk * st.v[2] + d : vp, ok);
        }
        cp_commit();
    };
    // the raw tile, landed, into buffer `buf`: K into its hi and lo
    // copies, V transposed into its; then visible to wgmma
    auto split_tile = [&](int buf) {
        cp_wait<0>();
        __syncthreads();                 // every thread's copies landed
        const uint32_t kv = base + L::KV + buf * L::KV_BYTES;
#pragma unroll
        for (int i = 0; i < BK * C4 / NTHREADS; ++i) {
            const int e = i * NTHREADS + tid;
            const int kt = e / C4, d = (e % C4) * 4;      // 4 dims of a key
            const float4 x4 = *reinterpret_cast<const float4*>(rawp + kt * HD + d);
            const float x[4] = {x4.x, x4.y, x4.z, x4.w};
            const int off = swz(kt, d, BK);
            split4(x, kv + L::KH + off, kv + L::KL + off);
        }
#pragma unroll
        for (int i = 0; i < BK * C4 / NTHREADS; ++i) {
            const int e = i * NTHREADS + tid;
            const int kt = (e / HD) * 4, d = e % HD;      // 4 keys of a dim
            const float* rv = rawp + BK * HD + kt * HD + d;
            const float x[4] = {rv[0], rv[HD], rv[2 * HD], rv[3 * HD]};
            const int off = swz(d, kt, HD);
            split4(x, kv + L::VH + off, kv + L::VL + off);
        }
        // the generic-proxy writes above are read by wgmma (the async proxy)
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        __syncthreads();                 // the buffer is whole; raw is free
    };
    issue(0);

    // q, scaled in fp32, split once into its hi and lo copies
#pragma unroll
    for (int i = 0; i < BQ * C4 / NTHREADS; ++i) {
        const int e = i * NTHREADS + tid;
        const int r = e / C4, d = (e % C4) * 4, gr = q0 + r;
        float4 x4 = make_float4(0.f, 0.f, 0.f, 0.f);
        if (gr < S) x4 = *reinterpret_cast<const float4*>(qp + gr * st.q[2] + d);
        const float x[4] = {__fmul_rn(x4.x, scale), __fmul_rn(x4.y, scale),
                            __fmul_rn(x4.z, scale), __fmul_rn(x4.w, scale)};
        const int off = swz(r, d, BQ);
        split4(x, base + L::QH + off, base + L::QL + off);
    }
    split_tile(0);
    if (nkv > 1) issue(1);

    const int row0 = q0 + warp * 16 + g;     // this thread's rows, and + 8
    float o[ON], pv[ON];
#pragma unroll
    for (int i = 0; i < ON; ++i) o[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    const int srcA = (lane & ~3) | (tg >> 1), srcB = srcA + 2;
    const bool odd = tg & 1;

    for (int j = 0; j < nkv; ++j) {
        const uint32_t kv = base + L::KV + (j & 1) * L::KV_BYTES;
        // S = Q K^T: small terms in one accumulator, hi*hi in two halves
        float ss[16], sa[16], sb[16];
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < HD / 8; ++ks) {
            const uint32_t qo = (ks / 4) * BQ * ROW + (ks % 4) * 32;
            const uint32_t ko = (ks / 4) * BK * ROW + (ks % 4) * 32;
            WgmmaSS<32>::run(ss, smem_desc(base + L::QL + qo),
                             smem_desc(kv + L::KH + ko), ks > 0);
            WgmmaSS<32>::run(ss, smem_desc(base + L::QH + qo),
                             smem_desc(kv + L::KL + ko), 1);
        }
#pragma unroll
        for (int ks = 0; ks < HD / 8; ++ks) {
            const uint32_t qo = (ks / 4) * BQ * ROW + (ks % 4) * 32;
            const uint32_t ko = (ks / 4) * BK * ROW + (ks % 4) * 32;
            if (ks < HD / 16)
                WgmmaSS<32>::run(sa, smem_desc(base + L::QH + qo),
                                 smem_desc(kv + L::KH + ko), ks > 0);
            else
                WgmmaSS<32>::run(sb, smem_desc(base + L::QH + qo),
                                 smem_desc(kv + L::KH + ko), ks > HD / 16);
        }
        wgmma_commit();
        // the next tile is split while S runs on the tensor cores; its
        // buffer's last reader, P V of tile j-1, has retired
        if (j + 1 < nkv) {
            split_tile((j + 1) & 1);
            if (j + 2 < nkv) issue(j + 2);
        }
        wgmma_wait_all();
        fence_regs(ss);
        fence_regs(sa);
        fence_regs(sb);

        // mask, then online softmax (rows row0 and row0 + 8)
        const int k0 = j * BK;
        float sc[16], mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int n = 0; n < 16; ++n) {
            sc[n] = __fadd_rn(__fadd_rn(sa[n], sb[n]), ss[n]);
            const int kg = k0 + (n >> 2) * 8 + 2 * tg + (n & 1);
            const int qg = row0 + 8 * ((n >> 1) & 1);
            if (kg >= Sk || (causal && qg < kg)) sc[n] = NEG_INF;
            mx[(n >> 1) & 1] = fmaxf(mx[(n >> 1) & 1], sc[n]);
        }
        float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
            const float m1 = fmaxf(m[i], mx[i]);
            alpha[i] = expf(m[i] - m1);
            m[i] = m1;
        }
#pragma unroll
        for (int n = 0; n < 16; ++n) {
            sc[n] = expf(sc[n] - m[(n >> 1) & 1]);
            sum[(n >> 1) & 1] += sc[n];
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
            sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
            l[i] = l[i] * alpha[i] + sum[i];
        }

        // P as TF32 A fragments: k-step kk holds (g, 8kk + tg), (g + 8, .),
        // (g, 8kk + tg + 4), (g + 8, .); P[g][8kk + c] lives in the score
        // pair of lane 4g + c/2
        uint32_t ph[4][4], pl[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            const float* s4 = sc + 4 * kk;
            const float x0 = __shfl_sync(0xffffffffu, s4[0], srcA);
            const float x1 = __shfl_sync(0xffffffffu, s4[1], srcA);
            const float y0 = __shfl_sync(0xffffffffu, s4[2], srcA);
            const float y1 = __shfl_sync(0xffffffffu, s4[3], srcA);
            const float z0 = __shfl_sync(0xffffffffu, s4[0], srcB);
            const float z1 = __shfl_sync(0xffffffffu, s4[1], srcB);
            const float w0 = __shfl_sync(0xffffffffu, s4[2], srcB);
            const float w1 = __shfl_sync(0xffffffffu, s4[3], srcB);
            split(odd ? x1 : x0, ph[kk][0], pl[kk][0]);
            split(odd ? y1 : y0, ph[kk][1], pl[kk][1]);
            split(odd ? z1 : z0, ph[kk][2], pl[kk][2]);
            split(odd ? w1 : w0, ph[kk][3], pl[kk][3]);
        }

        // this tile's P V, three passes into a fresh accumulator
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
            WgmmaRS<HD>::run(pv, pl[kk], smem_desc(kv + L::VH + kk * 32), kk > 0);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
            WgmmaRS<HD>::run(pv, ph[kk], smem_desc(kv + L::VL + kk * 32), 1);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
            WgmmaRS<HD>::run(pv, ph[kk], smem_desc(kv + L::VH + kk * 32), 1);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(pv);
#pragma unroll
        for (int n = 0; n < ON; ++n)
            o[n] = __fadd_rn(__fmul_rn(o[n], alpha[(n >> 1) & 1]), pv[n]);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int qg = row0 + 8 * i;
        if (qg >= S) continue;
        // the row's log-sum-exp of the scaled scores, for the backward
        if (lse != nullptr && tg == 0) lse[(long long)bh * S + qg] = m[i] + logf(l[i]);
        const float denom = l[i] + 1e-30f;
        float* orow = op + qg * st.o[2] + 2 * tg;
#pragma unroll
        for (int jb = 0; jb < HD / 8; ++jb)
            *reinterpret_cast<float2*>(orow + jb * 8) = make_float2(
                __fdiv_rn(o[4 * jb + 2 * i], denom),
                __fdiv_rn(o[4 * jb + 2 * i + 1], denom));
    }
}

// P (64 x 16 keys, TF32 A fragments in hi and lo) times 64 rows of V^T (64
// output dims; descriptors dvh, dvl of their hi and lo copies, 64-byte
// swizzle): three passes, the small terms first, into the fresh
// accumulator d; one wgmma group
__device__ __forceinline__ void pv_chunk(float (&d)[32], const uint32_t (&ph)[2][4],
                                         const uint32_t (&pl)[2][4], uint64_t dvh,
                                         uint64_t dvl) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
        WgmmaRS<64>::run(d, pl[kk], dvh + kk * 2, kk > 0);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
        WgmmaRS<64>::run(d, ph[kk], dvl + kk * 2, 1);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
        WgmmaRS<64>::run(d, ph[kk], dvh + kk * 2, 1);
    wgmma_commit();
}

// o = o * alpha + pv, each rounded to nearest (rows g and g + 8)
__device__ __forceinline__ void pv_add(float (&o)[32], float (&pv)[32],
                                       const float (&alpha)[2]) {
    fence_regs(pv);
#pragma unroll
    for (int n = 0; n < 32; ++n)
        o[n] = __fadd_rn(__fmul_rn(o[n], alpha[(n >> 1) & 1]), pv[n]);
}

// hd 256 (see the header): 16-key tiles, one split buffer each for K and V^T
struct Layout256 {
    static constexpr int HD = 256, BK = 16;
    static constexpr int Q_BYTES = BQ * HD * 4;      // one copy, hi or lo
    static constexpr int T_BYTES = BK * HD * 4;      // one copy of K or V^T
    static constexpr int QH = 0, QL = Q_BYTES;
    static constexpr int KH = 2 * Q_BYTES, KL = KH + T_BYTES;
    static constexpr int VH = KL + T_BYTES, VL = VH + T_BYTES;
    static constexpr int RAWK = VL + T_BYTES, RAWV = RAWK + T_BYTES;
    static constexpr int SMEM = RAWV + T_BYTES + 1024;
    static_assert(SMEM <= 232448, "tiles exceed a block's shared memory");
};

__global__ void __launch_bounds__(NTHREADS, 1)
fa_tf32x3_hd256_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       float* __restrict__ lse, Strides st, int H, int G, int S,
                       int Sk, int causal, float scale) {
    using L = Layout256;
    constexpr int HD = L::HD, BK = L::BK;
    constexpr int C4 = HD / 4;           // 16-byte chunks of a row
    constexpr int NCH = HD / 64;         // P V in chunks of 64 output dims
    extern __shared__ uint8_t smem_raw[];
    const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
    const float* rawk = reinterpret_cast<const float*>(
        smem_raw + (base - smem_u32(smem_raw)) + L::RAWK);
    const float* rawv = rawk + BK * HD;

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, tg = lane % 4;
    const int bh = blockIdx.x, b = bh / H, h = bh % H, hkv = h / G;
    const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // last q block first
    const float* qp = q + b * st.q[0] + h * st.q[1];
    const float* kp = k + b * st.k[0] + hkv * st.k[1];
    const float* vp = v + b * st.v[0] + hkv * st.v[1];
    float* op = out + b * st.o[0] + h * st.o[1];

    int nkv = (Sk + BK - 1) / BK;
    if (causal) nkv = min(nkv, (min(q0 + BQ, S) - 1) / BK + 1);

    // tile j's rows of K (or V) into their raw stage, keys past Sk zeroed;
    // one cp.async group, empty past the last tile
    auto issue = [&](int j, const float* src, long long rs, int raw) {
        if (j < nkv) {
            for (int e = tid; e < BK * C4; e += NTHREADS) {
                const int kt = e / C4, d = (e % C4) * 4, gk = j * BK + kt;
                const bool ok = gk < Sk;
                cp_async16(base + raw + (kt * HD + d) * 4,
                           ok ? src + gk * rs + d : src, ok);
            }
        }
        cp_commit();
    };
    // the landed raw K into its hi and lo copies (16 rows, 128-byte swizzle)
    auto split_k = [&]() {
#pragma unroll
        for (int i = 0; i < BK * C4 / NTHREADS; ++i) {
            const int e = i * NTHREADS + tid;
            const int kt = e / C4, d = (e % C4) * 4;
            const float4 x4 = *reinterpret_cast<const float4*>(rawk + kt * HD + d);
            const float x[4] = {x4.x, x4.y, x4.z, x4.w};
            const int off = swz(kt, d, BK);
            split4(x, base + L::KH + off, base + L::KL + off);
        }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    };
    // the landed raw V, transposed, into its hi and lo copies (256 rows of
    // 16 keys, 64-byte swizzle)
    auto split_v = [&]() {
#pragma unroll
        for (int i = 0; i < BK * C4 / NTHREADS; ++i) {
            const int e = i * NTHREADS + tid;
            const int kt = (e / HD) * 4, d = e % HD;       // 4 keys of a dim
            const float* rv = rawv + kt * HD + d;
            const float x[4] = {rv[0], rv[HD], rv[2 * HD], rv[3 * HD]};
            const int off = swz64(d, kt);
            split4(x, base + L::VH + off, base + L::VL + off);
        }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    };

    issue(0, kp, st.k[2], L::RAWK);
    issue(0, vp, st.v[2], L::RAWV);
#pragma unroll 4
    for (int i = 0; i < BQ * C4 / NTHREADS; ++i) {
        const int e = i * NTHREADS + tid;
        const int r = e / C4, d = (e % C4) * 4, gr = q0 + r;
        float4 x4 = make_float4(0.f, 0.f, 0.f, 0.f);
        if (gr < S) x4 = *reinterpret_cast<const float4*>(qp + gr * st.q[2] + d);
        const float x[4] = {__fmul_rn(x4.x, scale), __fmul_rn(x4.y, scale),
                            __fmul_rn(x4.z, scale), __fmul_rn(x4.w, scale)};
        const int off = swz(r, d, BQ);
        split4(x, base + L::QH + off, base + L::QL + off);
    }
    cp_wait<0>();
    __syncthreads();
    split_k();
    __syncthreads();                     // K_0 whole; raw K free
    issue(1, kp, st.k[2], L::RAWK);

    const int row0 = q0 + warp * 16 + g;
    float o[NCH][32];
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int n = 0; n < 32; ++n) o[c][n] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    const int srcA = (lane & ~3) | (tg >> 1), srcB = srcA + 2;
    const bool odd = tg & 1;

    for (int j = 0; j < nkv; ++j) {
        // S = Q K^T: the hi*hi products in eight accumulators of 32 dims
        // each (chains of 4 k-steps: the tensor cores truncate as they
        // accumulate, and at hd 256 the hd-128 kernel's chains of 8 left
        // the peaky draw near the limit), the small terms in two, all
        // issued in turn.  Descriptors are built from bases made opaque
        // here, so the compiler does not hoist all 192 into registers.
        float sh[8][8], sl[2][8];
        const uint64_t dqh = opaque(smem_desc(base + L::QH));
        const uint64_t dql = opaque(smem_desc(base + L::QL));
        const uint64_t dkh = opaque(smem_desc(base + L::KH));
        const uint64_t dkl = opaque(smem_desc(base + L::KL));
        wgmma_fence();
#pragma unroll
        for (int m = 0; m < 4; ++m) {
#pragma unroll
            for (int gq = 0; gq < 8; ++gq) {
                const int ks = gq * 4 + m;
                const uint32_t qo = ((ks / 4) * BQ * ROW + (ks % 4) * 32) >> 4;
                const uint32_t ko = ((ks / 4) * BK * ROW + (ks % 4) * 32) >> 4;
                WgmmaSS<16>::run(sh[gq], dqh + qo, dkh + ko, m > 0);
                WgmmaSS<16>::run(sl[gq / 4], dql + qo, dkh + ko,
                                 m > 0 || gq % 4 != 0);
                WgmmaSS<16>::run(sl[gq / 4], dqh + qo, dkl + ko, 1);
            }
        }
        wgmma_commit();
        // V_j is split while S runs; V^T's last reader, P V of tile j-1,
        // has retired (every warp waited for it before the barrier)
        cp_wait<1>();                    // raw V_j landed (raw K_{j+1} may not)
        __syncthreads();
        split_v();
        __syncthreads();                 // V^T_j whole; raw V free
        issue(j + 1, vp, st.v[2], L::RAWV);
        wgmma_wait<0>();
#pragma unroll
        for (int c = 0; c < 8; ++c) fence_regs(sh[c]);
        fence_regs(sl[0]);
        fence_regs(sl[1]);

        // mask, then online softmax (rows row0 and row0 + 8)
        const int k0 = j * BK;
        float sc[8], mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int n = 0; n < 8; ++n) {
            sc[n] = __fadd_rn(
                __fadd_rn(__fadd_rn(__fadd_rn(sh[0][n], sh[1][n]),
                                    __fadd_rn(sh[2][n], sh[3][n])),
                          __fadd_rn(__fadd_rn(sh[4][n], sh[5][n]),
                                    __fadd_rn(sh[6][n], sh[7][n]))),
                __fadd_rn(sl[0][n], sl[1][n]));
            const int kg = k0 + (n >> 2) * 8 + 2 * tg + (n & 1);
            const int qg = row0 + 8 * ((n >> 1) & 1);
            if (kg >= Sk || (causal && qg < kg)) sc[n] = NEG_INF;
            mx[(n >> 1) & 1] = fmaxf(mx[(n >> 1) & 1], sc[n]);
        }
        float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
            const float m1 = fmaxf(m[i], mx[i]);
            alpha[i] = expf(m[i] - m1);
            m[i] = m1;
        }
#pragma unroll
        for (int n = 0; n < 8; ++n) {
            sc[n] = expf(sc[n] - m[(n >> 1) & 1]);
            sum[(n >> 1) & 1] += sc[n];
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
            sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
            l[i] = l[i] * alpha[i] + sum[i];
        }

        // P as TF32 A fragments, as in the kernel above (two k-steps here)
        uint32_t ph[2][4], pl[2][4];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
            const float* s4 = sc + 4 * kk;
            const float x0 = __shfl_sync(0xffffffffu, s4[0], srcA);
            const float x1 = __shfl_sync(0xffffffffu, s4[1], srcA);
            const float y0 = __shfl_sync(0xffffffffu, s4[2], srcA);
            const float y1 = __shfl_sync(0xffffffffu, s4[3], srcA);
            const float z0 = __shfl_sync(0xffffffffu, s4[0], srcB);
            const float z1 = __shfl_sync(0xffffffffu, s4[1], srcB);
            const float w0 = __shfl_sync(0xffffffffu, s4[2], srcB);
            const float w1 = __shfl_sync(0xffffffffu, s4[3], srcB);
            split(odd ? x1 : x0, ph[kk][0], pl[kk][0]);
            split(odd ? y1 : y0, ph[kk][1], pl[kk][1]);
            split(odd ? z1 : z0, ph[kk][2], pl[kk][2]);
            split(odd ? w1 : w0, ph[kk][3], pl[kk][3]);
        }

        // this tile's P V, 64 output dims at a time, each three passes into
        // a fresh accumulator; two chunks in flight
        float pva[32], pvb[32];
        const uint64_t dvh = opaque(smem_desc64(base + L::VH));
        const uint64_t dvl = opaque(smem_desc64(base + L::VL));
        // 64 rows of V^T are 4096 bytes: 256 in the descriptor's units
        pv_chunk(pva, ph, pl, dvh, dvl);               // dims 0..63
        pv_chunk(pvb, ph, pl, dvh + 256, dvl + 256);   // 64..127
        // K_{j+1} is split while P V runs; S_j, K's last reader, has retired
        if (j + 1 < nkv) {
            cp_wait<1>();                // raw K_{j+1} landed (raw V_{j+1} may not)
            __syncthreads();
            split_k();
            __syncthreads();             // K_{j+1} whole; raw K free
        }
        issue(j + 2, kp, st.k[2], L::RAWK);
        wgmma_wait<1>();
        pv_add(o[0], pva, alpha);
        pv_chunk(pva, ph, pl, dvh + 512, dvl + 512);   // 128..191
        wgmma_wait<1>();
        pv_add(o[1], pvb, alpha);
        pv_chunk(pvb, ph, pl, dvh + 768, dvl + 768);   // 192..255
        wgmma_wait<1>();
        pv_add(o[2], pva, alpha);
        wgmma_wait<0>();
        pv_add(o[3], pvb, alpha);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int qg = row0 + 8 * i;
        if (qg >= S) continue;
        // the row's log-sum-exp of the scaled scores, for the backward
        if (lse != nullptr && tg == 0) lse[(long long)bh * S + qg] = m[i] + logf(l[i]);
        const float denom = l[i] + 1e-30f;
        float* orow = op + qg * st.o[2] + 2 * tg;
#pragma unroll
        for (int c = 0; c < NCH; ++c)
#pragma unroll
            for (int jb = 0; jb < 8; ++jb)
                *reinterpret_cast<float2*>(orow + c * 64 + jb * 8) = make_float2(
                    __fdiv_rn(o[c][4 * jb + 2 * i], denom),
                    __fdiv_rn(o[c][4 * jb + 2 * i + 1], denom));
    }
}

int launch256(const void* q, const void* k, const void* v, void* out,
              float* lse, const Strides& st, int B, int H, int Hkv, int S, int Sk,
              int causal, float scale, cudaStream_t stream) {
    constexpr int smem = Layout256::SMEM;
    cudaError_t err = cudaFuncSetAttribute(
        fa_tf32x3_hd256_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(B * H, (S + BQ - 1) / BQ);
    fa_tf32x3_hd256_kernel<<<grid, NTHREADS, smem, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)out, lse, st, H,
        H / Hkv, S, Sk, causal, scale);
    return (int)cudaGetLastError();
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, const Strides& st, int B, int H, int Hkv, int S, int Sk, int causal,
           float scale, cudaStream_t stream) {
    constexpr int smem = Layout<HD>::SMEM;
    cudaError_t err = cudaFuncSetAttribute(
        fa_tf32x3_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(B * H, (S + BQ - 1) / BQ);
    fa_tf32x3_kernel<HD><<<grid, NTHREADS, smem, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)out, lse, st, H,
        H / Hkv, S, Sk, causal, scale);
    return (int)cudaGetLastError();
}

}  // namespace

// q (B, H, S, hd), k and v (B, Hkv, Sk, hd), out (B, H, S, hd), all float32,
// hd 64, 128 or 256; strides: 12 element strides, (batch, head, row) of q, k, v,
// out, every row unit-stride and 16-byte aligned.  scale is hd^-0.5 rounded
// to fp32.  lse, when not null, receives each row's log-sum-exp of the
// scaled scores, (B, H, S) fp32 contiguous (for the backward kernel).
extern "C" int flash_attention_tf32x3(const void* q, const void* k,
                                      const void* v, void* out, float* lse,
                                      int B, int H,
                                      int Hkv, int S, int Sk, int hd,
                                      int causal, float scale,
                                      const long long* strides, void* stream) {
    if (B < 1 || H < 1 || Hkv < 1 || H % Hkv || S < 1 || Sk < 1)
        return (int)cudaErrorInvalidValue;
    Strides st;
    for (int i = 0; i < 3; ++i) {
        st.q[i] = strides[i];
        st.k[i] = strides[3 + i];
        st.v[i] = strides[6 + i];
        st.o[i] = strides[9 + i];
    }
    cudaStream_t s = (cudaStream_t)stream;
    if (hd == 64) return launch<64>(q, k, v, out, lse, st, B, H, Hkv, S, Sk, causal, scale, s);
    if (hd == 128) return launch<128>(q, k, v, out, lse, st, B, H, Hkv, S, Sk, causal, scale, s);
    if (hd == 256) return launch256(q, k, v, out, lse, st, B, H, Hkv, S, Sk, causal, scale, s);
    return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_error_string(int e) {
    return cudaGetErrorString((cudaError_t)e);
}
