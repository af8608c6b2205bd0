// Flash attention, backward (K4's gradient), at head dims 16 and 32, in
// float32 and bf16, on the tensor cores through mma.sync: one kernel a call,
// deterministic.
//
// Replaces: no TPU kernel.  The JAX package differentiates its attention
// (src/repro/models/layers.py::_sdpa and _sdpa_chunked) with jax.grad and has
// no Pallas VJP; its Pallas forward is
// src/repro/kernels/flash_attention.py::_fa_kernel (line 22).  This is the
// gradient of the port's forward kernel at these head dims
// (flash_attention.cu), which writes its rows' log-sum-exp for it when asked.
// The other head dims run flash_attention_bwd_wgmma.cu (bf16) and
// flash_attention_bwd_tf32x3.cu (f32).
//
// What it computes: for out = softmax(q k^T * scale [+ causal mask]) v over
// q (B, H, S, hd) and k, v (B, Hkv, Sk, hd) (q head h reads kv head
// h / (H / Hkv)), lse the row log-sum-exp of the scaled scores and dout the
// output's gradient:
//   D_i   = sum_d dout_id out_id
//   P_ij  = exp(q_i . k_j * scale - lse_i)        (0 where masked)
//   dV_j  = sum_i P_ij dout_i
//   dS_ij = P_ij (dout_i . v_j - D_i)
//   dK_j  = scale * sum_i dS_ij q_i
//   dQ_i  = scale * sum_j dS_ij k_j
// with dK and dV summed over the G q heads of each kv head; sums in fp32,
// each gradient rounded once to its input's type.
//
// Bound on Hopper: neither bytes nor operations.  At the reduced llama3-8b's
// q (2, 6, 256, 16) over 2 kv heads, causal, the gradient is 63 MFLOP on
// about 1 MB: well under a microsecond at either peak.  What takes the time
// is the launch and the longest chain of dependent steps one warp walks; the
// CUDA-core kernel this replaces took 0.097 ms in three launches, its dK/dV
// grid 16 blocks of 64 keys, each walking 3 q heads x 4 q tiles serially
// with block barriers between P, dS and their products.
//
// Design:
// * One launch a call and no atomics.  The grid holds the dK/dV blocks, then
//   the dQ blocks, each on its own tile of 16: a dK/dV block owns 16 keys of
//   one (batch, kv head), a dQ block 16 q rows of one (batch, q head).  A
//   block's 8 warps take its items in turn (item i to warp i % 8): a dK/dV
//   block's items are the (q head of the group, 16-row q step) pairs its
//   causal bound keeps, a dQ block's the 16-key steps up to the forward's
//   bound.  Each warp keeps its own partial gradient in registers; the block
//   sums the 8 partials in warp order through shared memory, so each
//   gradient is bitwise the same from call to call.  At the reduced shape:
//   64 + 192 blocks, and no warp walks more than 6 items.
// * An item is register-resident, FA2 style: S^T and dP^T (dQ: S and dP) as
//   two 16 x 8 accumulator tiles each, their operands loaded straight from
//   the inputs' rows (they stay in L1 across a block's warps); P^T and dS^T
//   in the accumulator layout are the A fragments of dV, dK (dQ) as they
//   stand, and the other operand is read from the rows in the B layout.
// * bf16: mma.sync m16n8k16, fp32 accumulators; P and dS rounded to bf16 for
//   their products, as the wgmma route does.  f32: 3xTF32, mma.sync m16n8k8
//   in three passes lo*hi + hi*lo + hi*hi, each fp32 operand x split into hi
//   = x rounded to TF32 and lo = x - hi rounded; an item's accumulation goes
//   to a fresh accumulator added rounded to nearest.  The accumulator
//   layout holds columns 2tg, 2tg + 1 where TF32's A fragment wants tg,
//   tg + 4: the contraction index is permuted to match, and the B rows read
//   in the same order, so no shuffle moves P or dS.
// * D_i, a 16- or 32-wide dot product, is recomputed where it is needed (two
//   lanes a row, their halves summed), not launched.
// * Masks: rows past S read as zeros and carry lse = +inf, so their P is 0;
//   keys past Sk read as zeros, are masked in dQ and never stored in dK/dV;
//   causal keys past a row are masked.
// * Inputs are read through their (batch, head, row) strides, rows
//   unit-stride and 16-byte aligned (the wrapper copies others); GQA is read
//   natively.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int TILE = 16;           // a block's keys or q rows, and an item's

struct Strides {      // element strides (batch, head, row)
    long long q[3], k[3], v[3], o[3], g[3], dq[3], dk[3], dv[3];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// rows r0 .. r0 + 15 of one (batch, head) slice (row stride rs); rows at or
// past n read as zeros
template <typename T>
struct Rows {
    const T* p;
    long long rs;
    int r0, n;
    __device__ __forceinline__ bool ok(int i) const { return r0 + i < n; }
    __device__ __forceinline__ float at(int i, int d) const {
        return ok(i) ? to_f32(p[(r0 + i) * rs + d]) : 0.f;
    }
    // elements d and d + 1 (d even) of a bf16 row as one word
    __device__ __forceinline__ uint32_t pair(int i, int d) const {
        return ok(i) ? *reinterpret_cast<const uint32_t*>(p + (r0 + i) * rs + d) : 0u;
    }
    // element d of a bf16 row in the low 16 bits
    __device__ __forceinline__ uint32_t half(int i, int d) const {
        return ok(i) ? (uint32_t)*reinterpret_cast<const uint16_t*>(p + (r0 + i) * rs + d)
                     : 0u;
    }
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                 "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
                 : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
    asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                 "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
                 : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

// c (16 x 16, two tiles of 8 columns) = x y^T over HD: row m of x against
// row n of y.  The accumulator layout: c[nb] holds (g, 8 nb + 2 tg),
// (g, + 1), (g + 8, 8 nb + 2 tg), (g + 8, + 1) for lane 4 g + tg.
template <typename T, int HD>
__device__ __forceinline__ void xy_t(float (&c)[2][4], const Rows<T>& x, const Rows<T>& y,
                                     int lane) {
    const int g = lane >> 2, tg = lane & 3;
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[nb][e] = 0.f;
    if constexpr (std::is_same<T, float>::value) {
#pragma unroll
        for (int kc = 0; kc < HD; kc += 8) {
            const float xa[4] = {x.at(g, kc + tg), x.at(g + 8, kc + tg),
                                 x.at(g, kc + tg + 4), x.at(g + 8, kc + tg + 4)};
            uint32_t ah[4], al[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) split(xa[i], ah[i], al[i]);
#pragma unroll
            for (int nb = 0; nb < 2; ++nb) {
                uint32_t bh[2], bl[2];
                split(y.at(8 * nb + g, kc + tg), bh[0], bl[0]);
                split(y.at(8 * nb + g, kc + tg + 4), bh[1], bl[1]);
                mma_tf32(c[nb], al, bh);
                mma_tf32(c[nb], ah, bl);
                mma_tf32(c[nb], ah, bh);
            }
        }
    } else {
#pragma unroll
        for (int kc = 0; kc < HD; kc += 16) {
            const uint32_t a[4] = {x.pair(g, kc + 2 * tg), x.pair(g + 8, kc + 2 * tg),
                                   x.pair(g, kc + 2 * tg + 8),
                                   x.pair(g + 8, kc + 2 * tg + 8)};
#pragma unroll
            for (int nb = 0; nb < 2; ++nb) {
                const uint32_t b[2] = {y.pair(8 * nb + g, kc + 2 * tg),
                                       y.pair(8 * nb + g, kc + 2 * tg + 8)};
                mma_bf16(c[nb], a, b);
            }
        }
    }
}

// acc (16 x HD) += a z: a (16 x 16) in the accumulator layout of xy_t, z
// rows 0 .. 15 of HD.  bf16: a's two tiles are m16n8k16's A fragment as
// they stand.  f32: k-step kk is a's tile kk with fragment column tg read
// from accumulator column 2 tg and tg + 4 from 2 tg + 1, and z's rows in
// that order; each call's product into a fresh accumulator.
template <typename T, int HD>
__device__ __forceinline__ void acc_az(float (&acc)[HD / 8][4], const float (&a)[2][4],
                                       const Rows<T>& z, int lane) {
    const int g = lane >> 2, tg = lane & 3;
    if constexpr (std::is_same<T, float>::value) {
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
            const float av[4] = {a[kk][0], a[kk][2], a[kk][1], a[kk][3]};
#pragma unroll
            for (int i = 0; i < 4; ++i) split(av[i], ah[kk][i], al[kk][i]);
        }
#pragma unroll
        for (int nd = 0; nd < HD / 8; ++nd) {
            const int d = 8 * nd + g;
            uint32_t bh[2][2], bl[2][2];
#pragma unroll
            for (int kk = 0; kk < 2; ++kk) {
                split(z.at(8 * kk + 2 * tg, d), bh[kk][0], bl[kk][0]);
                split(z.at(8 * kk + 2 * tg + 1, d), bh[kk][1], bl[kk][1]);
            }
            float fr[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int kk = 0; kk < 2; ++kk) mma_tf32(fr, al[kk], bh[kk]);
#pragma unroll
            for (int kk = 0; kk < 2; ++kk) mma_tf32(fr, ah[kk], bl[kk]);
#pragma unroll
            for (int kk = 0; kk < 2; ++kk) mma_tf32(fr, ah[kk], bh[kk]);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[nd][e] = __fadd_rn(acc[nd][e], fr[e]);
        }
    } else {
        const uint32_t ap[4] = {pack_bf16(a[0][0], a[0][1]), pack_bf16(a[0][2], a[0][3]),
                                pack_bf16(a[1][0], a[1][1]), pack_bf16(a[1][2], a[1][3])};
#pragma unroll
        for (int nd = 0; nd < HD / 8; ++nd) {
            const int d = 8 * nd + g;
            const uint32_t b[2] = {z.half(2 * tg, d) | z.half(2 * tg + 1, d) << 16,
                                   z.half(2 * tg + 8, d) | z.half(2 * tg + 9, d) << 16};
            mma_bf16(acc[nd], ap, b);
        }
    }
}

// lanes 2 r and 2 r + 1 get row r's lse (+inf past the rows) and D = dout .
// out, each lane summing half the row
template <typename T, int HD>
__device__ __forceinline__ void row_stats(const Rows<T>& gr, const Rows<T>& orow,
                                          const float* lrow, int lane, float& ls,
                                          float& D) {
    const int r = lane >> 1, d0 = (lane & 1) * (HD / 2);
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < HD / 2; ++d) acc = fmaf(gr.at(r, d0 + d), orow.at(r, d0 + d), acc);
    D = acc + __shfl_xor_sync(0xffffffffu, acc, 1);
    ls = gr.ok(r) ? lrow[gr.r0 + r] : INFINITY;
}

// The whole gradient: blocks [0, kv_blocks) dK and dV of 16 keys each,
// the rest dQ of 16 q rows each (see the header).
template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS)
fa_bwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ o,
                  const T* __restrict__ g, const float* __restrict__ lse,
                  T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                  Strides st, int B, int H, int G, int S, int Sk, int causal,
                  float scale, int kv_blocks) {
    constexpr int ND = HD / 8;
    __shared__ float red[NWARPS][2][TILE * HD];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int gq = lane >> 2, tg = lane & 3;
    const int Hkv = H / G, nq = (S + TILE - 1) / TILE;
    float acc[2][ND][4];          // dV, dK; or dQ and nothing
#pragma unroll
    for (int w = 0; w < 2; ++w)
#pragma unroll
        for (int nd = 0; nd < ND; ++nd)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[w][nd][e] = 0.f;
    int nout, rows_ok;
    T* out[2];
    long long rs[2];
    float mul[2];

    if ((int)blockIdx.x < kv_blocks) {
        // dK and dV of keys [k0, k0 + 16) of one (batch, kv head); the
        // first keys, the longest walks, first
        const int bhk = blockIdx.x % (B * Hkv), b = bhk / Hkv, hk = bhk % Hkv;
        const int k0 = blockIdx.x / (B * Hkv) * TILE;
        const Rows<T> kr{k + b * st.k[0] + hk * st.k[1], st.k[2], k0, Sk};
        const Rows<T> vr{v + b * st.v[0] + hk * st.v[1], st.v[2], k0, Sk};
        const int first = causal ? min(k0 / TILE, nq) : 0, per = nq - first;
        for (int it = warp; it < G * per; it += NWARPS) {
            const int h = hk * G + it / per, q0 = (first + it % per) * TILE;
            const Rows<T> qr{q + b * st.q[0] + h * st.q[1], st.q[2], q0, S};
            const Rows<T> gr{g + b * st.g[0] + h * st.g[1], st.g[2], q0, S};
            const Rows<T> orow{o + b * st.o[0] + h * st.o[1], st.o[2], q0, S};
            float ls, Dr;
            row_stats<T, HD>(gr, orow, lse + (long long)(b * H + h) * S, lane, ls, Dr);
            float s[2][4], dp[2][4];
            xy_t<T, HD>(s, kr, qr, lane);          // S^T = K Q^T
            xy_t<T, HD>(dp, vr, gr, lane);         // dP^T = V dout^T
            // P^T and dS^T: keys k0 + g (+ 8), q rows q0 + 8 nb + 2 tg (+ 1)
#pragma unroll
            for (int nb = 0; nb < 2; ++nb)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int col = 8 * nb + 2 * tg + (e & 1);
                    const float l_ = __shfl_sync(0xffffffffu, ls, 2 * col);
                    const float d_ = __shfl_sync(0xffffffffu, Dr, 2 * col);
                    float p = expf(fmaf(s[nb][e], scale, -l_));
                    if (causal && k0 + gq + 8 * (e >> 1) > q0 + col) p = 0.f;
                    s[nb][e] = p;
                    dp[nb][e] = p * (dp[nb][e] - d_);
                }
            acc_az<T, HD>(acc[0], s, gr, lane);     // dV += P^T dout
            acc_az<T, HD>(acc[1], dp, qr, lane);    // dK += dS^T Q
        }
        nout = 2;
        rows_ok = min(TILE, Sk - k0);
        out[0] = dv + b * st.dv[0] + hk * st.dv[1] + k0 * st.dv[2];
        out[1] = dk + b * st.dk[0] + hk * st.dk[1] + k0 * st.dk[2];
        rs[0] = st.dv[2];
        rs[1] = st.dk[2];
        mul[0] = 1.f;
        mul[1] = scale;
    } else {
        // dQ of q rows [q0, q0 + 16) of one (batch, q head); the last rows,
        // the longest walks, first
        const int i = blockIdx.x - kv_blocks, bh = i % (B * H);
        const int b = bh / H, h = bh % H, hk = h / G;
        const int q0 = (nq - 1 - i / (B * H)) * TILE;
        const Rows<T> qr{q + b * st.q[0] + h * st.q[1], st.q[2], q0, S};
        const Rows<T> gr{g + b * st.g[0] + h * st.g[1], st.g[2], q0, S};
        const Rows<T> orow{o + b * st.o[0] + h * st.o[1], st.o[2], q0, S};
        float ls, Dr;
        row_stats<T, HD>(gr, orow, lse + (long long)(b * H + h) * S, lane, ls, Dr);
        // this lane's rows q0 + g and q0 + g + 8
        const float lr[2] = {__shfl_sync(0xffffffffu, ls, 2 * gq),
                             __shfl_sync(0xffffffffu, ls, 2 * (gq + 8))};
        const float dr[2] = {__shfl_sync(0xffffffffu, Dr, 2 * gq),
                             __shfl_sync(0xffffffffu, Dr, 2 * (gq + 8))};
        int nk = (Sk + TILE - 1) / TILE;
        if (causal) nk = min(nk, (min(q0 + TILE, S) - 1) / TILE + 1);
        for (int j = warp; j < nk; j += NWARPS) {
            const int k0 = j * TILE;
            const Rows<T> kr{k + b * st.k[0] + hk * st.k[1], st.k[2], k0, Sk};
            const Rows<T> vr{v + b * st.v[0] + hk * st.v[1], st.v[2], k0, Sk};
            float s[2][4], dp[2][4];
            xy_t<T, HD>(s, qr, kr, lane);          // S = Q K^T
            xy_t<T, HD>(dp, gr, vr, lane);         // dP = dout V^T
#pragma unroll
            for (int nb = 0; nb < 2; ++nb)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int r = e >> 1, key = k0 + 8 * nb + 2 * tg + (e & 1);
                    float p = expf(fmaf(s[nb][e], scale, -lr[r]));
                    if (key >= Sk || (causal && key > q0 + gq + 8 * r)) p = 0.f;
                    dp[nb][e] = p * (dp[nb][e] - dr[r]);
                }
            acc_az<T, HD>(acc[0], dp, kr, lane);    // dQ += dS K
        }
        nout = 1;
        rows_ok = min(TILE, S - q0);
        out[0] = out[1] = dq + b * st.dq[0] + h * st.dq[1] + q0 * st.dq[2];
        rs[0] = rs[1] = st.dq[2];
        mul[0] = mul[1] = scale;
    }

    // the warps' partials, summed in warp order
#pragma unroll
    for (int w = 0; w < 2; ++w)
#pragma unroll
        for (int nd = 0; nd < ND; ++nd)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                red[warp][w][(gq + 8 * (e >> 1)) * HD + 8 * nd + 2 * tg + (e & 1)] =
                    acc[w][nd][e];
    __syncthreads();
    for (int e = threadIdx.x; e < nout * TILE * HD; e += NTHREADS) {
        const int w = e / (TILE * HD), r = e / HD % TILE, d = e % HD;
        float sum = red[0][w][r * HD + d];
#pragma unroll
        for (int i = 1; i < NWARPS; ++i) sum = __fadd_rn(sum, red[i][w][r * HD + d]);
        if (r < rows_ok) store(out[w] + r * rs[w] + d, sum * mul[w]);
    }
}

template <typename T, int HD>
int run(const void* q, const void* k, const void* v, const void* o, const void* g,
        const float* lse, void* dq, void* dk, void* dv, const Strides& st, int B,
        int H, int Hkv, int S, int Sk, int causal, float scale, cudaStream_t s) {
    const int kv_blocks = B * Hkv * ((Sk + TILE - 1) / TILE);
    const int q_blocks = B * H * ((S + TILE - 1) / TILE);
    fa_bwd_mma_kernel<T, HD><<<kv_blocks + q_blocks, NTHREADS, 0, s>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)o, (const T*)g, lse,
        (T*)dq, (T*)dk, (T*)dv, st, B, H, H / Hkv, S, Sk, causal, scale,
        kv_blocks);
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* g, const float* lse, void* dq, void* dk, void* dv,
             int B, int H, int Hkv, int S, int Sk, int hd, int causal, float scale,
             const long long* strides, void* stream) {
    if (B < 1 || H < 1 || Hkv < 1 || H % Hkv || S < 1 || Sk < 1)
        return (int)cudaErrorInvalidValue;
    Strides st;
    long long* dst[8] = {st.q, st.k, st.v, st.o, st.g, st.dq, st.dk, st.dv};
    for (int t = 0; t < 8; ++t)
        for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
    cudaStream_t s = (cudaStream_t)stream;
    switch (hd) {
        case 16: return run<T, 16>(q, k, v, o, g, lse, dq, dk, dv, st, B, H, Hkv, S, Sk, causal, scale, s);
        case 32: return run<T, 32>(q, k, v, o, g, lse, dq, dk, dv, st, B, H, Hkv, S, Sk, causal, scale, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// q, out, dout, dq (B, H, S, hd); k, v, dk, dv (B, Hkv, Sk, hd); lse (B, H,
// S) fp32, contiguous; hd 16 or 32.  strides: 24 element strides, (batch,
// head, row) of q, k, v, out, dout, dq, dk, dv, every row unit-stride and
// 16-byte aligned.  scale is hd^-0.5 as the caller rounds it to fp32.
// Launches one kernel on `stream`.
extern "C" int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                                       const void* o, const void* g, const float* lse,
                                       void* dq, void* dk, void* dv, int B, int H,
                                       int Hkv, int S, int Sk, int hd, int causal,
                                       float scale, const long long* strides,
                                       void* stream) {
    return dispatch<float>(q, k, v, o, g, lse, dq, dk, dv, B, H, Hkv, S, Sk, hd,
                           causal, scale, strides, stream);
}

extern "C" int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                        const void* o, const void* g, const float* lse,
                                        void* dq, void* dk, void* dv, int B, int H,
                                        int Hkv, int S, int Sk, int hd, int causal,
                                        float scale, const long long* strides,
                                        void* stream) {
    return dispatch<__nv_bfloat16>(q, k, v, o, g, lse, dq, dk, dv, B, H, Hkv, S, Sk,
                                   hd, causal, scale, strides, stream);
}

extern "C" const char* repro_error_string(int e) {
    return cudaGetErrorString((cudaError_t)e);
}
