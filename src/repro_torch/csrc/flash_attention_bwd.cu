// Flash attention, backward (K4's gradient), on the CUDA cores.
//
// Replaces: no TPU kernel.  The JAX package differentiates its attention
// (src/repro/models/layers.py::_sdpa and _sdpa_chunked) with jax.grad and has
// no Pallas VJP; its Pallas forward is
// src/repro/kernels/flash_attention.py::_fa_kernel (line 22).  This is the
// gradient of the port's forward kernels (flash_attention.cu,
// flash_attention_wgmma.cu, flash_attention_tf32x3.cu), each of which writes
// its rows' log-sum-exp for it when asked.
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
// with dK and dV summed over the G q heads of each kv head; all in fp32 from
// f32 or bf16 inputs, each gradient rounded once to its input's type.  It
// takes hd 16 and 32 in both dtypes and f32 at hd 256.  The tensor cores
// take the rest: bf16 at hd 64, 128 and 256 runs
// flash_attention_bwd_wgmma.cu, f32 at hd 64 and 128
// flash_attention_bwd_tf32x3.cu (3xTF32).
//
// Bound on Hopper: operations.  The gradient counts 2.5 times the forward's
// 4*hd flops per kept score (S, dP, dV, dK, dQ: five products of 2*hd); at
// PaliGemma's q (1, 8, 1024, 256) over one kv head, causal, that is 10.7
// GFLOP, 0.065 ms in three TF32 passes at 495 TFLOP/s; this kernel runs on
// the fp32 CUDA cores, whose 67 TFLOP/s alone would take 0.16 ms.  It also
// does more work: kernel (c) recomputes S and dP, 7 products of 2*hd per
// score.
//
// Design (a first, simple kernel; the tensor-core kernels took over the
// other head dims):
// * Three kernels a call and no atomics, so the result is deterministic:
//   (a) D, one warp per row; (b) dK and dV, one block per (b, kv head, kv
//   tile of BK keys) that walks the G q heads of its group and, for each, the
//   q tiles of BQ rows the causal bound lets see its keys, recomputing P and
//   dS, with dK and dV in registers; (c) dQ, one block per (b, q head, q
//   tile) that walks the kv tiles up to the forward's bound
//   ((qi+1)*BQ - 1)//BK + 1, with dQ in registers.
// * Tiles sit in fp32 shared memory, loaded element by element through the
//   tensors' (batch, head, row) strides (rows unit-stride): any view, GQA
//   read natively.  Rows are padded by 4 floats, so the 16-byte reads of 8
//   consecutive rows by a quarter warp fall in 8 different bank groups.
// * Products run as register tiles of fp32 FMAs: the scores with a warp's
//   rows against 32 lanes' keys (q and dout rows broadcast), the
//   accumulations with a thread's rows of dK, dV or dQ against 16-byte
//   chunks of the head dim.  P and dS pass through shared memory ([row][key]
//   for (b); dS as [key][row] for (c)).
// * Tiles by head dim (Tile<HD>): 64 x 64 at hd 16 and 32, 32 x 32 at 256,
//   where the four fp32 tiles take 133 KB.
// * Ragged q rows and keys are masked (P = 0) and never stored; a causal kv
//   tile past the last q row gets zero gradients.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <type_traits>

namespace {

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;

struct Strides {      // element strides (batch, head, row)
    long long q[3], k[3], v[3], o[3], g[3], dq[3], dk[3], dv[3];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// (q rows, kv keys) of a tile by head dim
template <int HD> struct Tile;
template <> struct Tile<16> { static constexpr int BQ = 64, BK = 64; };
template <> struct Tile<32> { static constexpr int BQ = 64, BK = 64; };
template <> struct Tile<256> { static constexpr int BQ = 32, BK = 32; };

// the accumulations' thread layout: LPR lanes share a row of the output, 4
// dims each (DV4 chunks of 4 at hd 256); a warp holds 32 / LPR row groups
template <int HD> struct Acc {
    static constexpr int LPR = HD / 4 < 32 ? HD / 4 : 32;
    static constexpr int DV4 = HD / (4 * LPR);
    static constexpr int GROUPS = NWARPS * (32 / LPR);
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

__device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void fma4(float (&acc)[4], float a, const float4& b) {
    acc[0] = fmaf(a, b.x, acc[0]);
    acc[1] = fmaf(a, b.y, acc[1]);
    acc[2] = fmaf(a, b.z, acc[2]);
    acc[3] = fmaf(a, b.w, acc[3]);
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
    return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

// rows [r0, r0 + R) of one (batch, head) slice (row stride rs) into shared
// memory with row stride HD + 4, in fp32; zeros past row n
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* dst, const T* src, long long rs,
                                          int r0, int R, int n) {
    for (int e = threadIdx.x; e < R * HD; e += NTHREADS) {
        const int r = e / HD, d = e % HD, gr = r0 + r;
        dst[r * (HD + 4) + d] = gr < n ? to_f32(src[gr * rs + d]) : 0.f;
    }
}

// P and dS of q rows [q0, q0 + BQ) against keys [k0, k0 + BK): warp w takes
// rows w + 8 i, lane l keys l + 32 j.  TRANSPOSED stores dS as [key][row]
// (stride BQ + 4) and no P; else P and dS as [row][key] (stride BK + 4).
template <int HD, bool TRANSPOSED>
__device__ __forceinline__ void scores(const float* sq, const float* sdo,
                                       const float* sk, const float* sv,
                                       const float* slse, const float* sD,
                                       float* sp, float* sds, int q0, int k0,
                                       int S, int Sk, int causal, float scale) {
    constexpr int BQ = Tile<HD>::BQ, BK = Tile<HD>::BK, P = HD + 4;
    constexpr int RQ = BQ / NWARPS, RK = BK / 32;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    float s[RQ][RK], dp[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < HD; d += 4) {
        float4 kk[RK], vv[RK];
#pragma unroll
        for (int j = 0; j < RK; ++j) {
            kk[j] = ld4(sk + (lane + 32 * j) * P + d);
            vv[j] = ld4(sv + (lane + 32 * j) * P + d);
        }
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
            const float4 qq = ld4(sq + (warp + NWARPS * i) * P + d);
            const float4 gg = ld4(sdo + (warp + NWARPS * i) * P + d);
#pragma unroll
            for (int j = 0; j < RK; ++j) {
                s[i][j] = dot4(qq, kk[j], s[i][j]);
                dp[i][j] = dot4(gg, vv[j], dp[i][j]);
            }
        }
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
        const int r = warp + NWARPS * i, qg = q0 + r;
        const float lse = slse[r], D = sD[r];
#pragma unroll
        for (int j = 0; j < RK; ++j) {
            const int c = lane + 32 * j, kg = k0 + c;
            const bool ok = qg < S && kg < Sk && (!causal || kg <= qg);
            const float p = ok ? expf(fmaf(s[i][j], scale, -lse)) : 0.f;
            const float ds = p * (dp[i][j] - D);
            if (TRANSPOSED) {
                sds[c * (BQ + 4) + r] = ds;
            } else {
                sp[r * (BK + 4) + c] = p;
                sds[r * (BK + 4) + c] = ds;
            }
        }
    }
}

// (a) D = rowsum(dout * out), one warp per row of (B, H, S)
template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS)
fa_bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ g,
                  float* __restrict__ D, Strides st, int H, int S, int rows) {
    const int row = blockIdx.x * NWARPS + threadIdx.x / 32, lane = threadIdx.x % 32;
    if (row >= rows) return;
    const int bh = row / S, r = row % S, b = bh / H, h = bh % H;
    const T* op = o + b * st.o[0] + h * st.o[1] + r * st.o[2];
    const T* gp = g + b * st.g[0] + h * st.g[1] + r * st.g[2];
    float acc = 0.f;
    for (int d = lane; d < HD; d += 32) acc = fmaf(to_f32(op[d]), to_f32(gp[d]), acc);
    acc = warp_sum(acc);
    if (lane == 0) D[row] = acc;
}

// q rows [q0, q0 + BQ) of head h: lse and D into shared memory
template <int BQ>
__device__ __forceinline__ void load_stats(float* slse, float* sD, const float* lse,
                                           const float* D, long long base,
                                           int q0, int S) {
    for (int e = threadIdx.x; e < BQ; e += NTHREADS) {
        const int gr = q0 + e;
        slse[e] = gr < S ? lse[base + gr] : 0.f;
        sD[e] = gr < S ? D[base + gr] : 0.f;
    }
}

// (b) dK and dV of one (batch, kv head, kv tile)
template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS)
fa_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ g,
                   const float* __restrict__ lse, const float* __restrict__ D,
                   T* __restrict__ dk, T* __restrict__ dv, Strides st, int H,
                   int G, int S, int Sk, int causal, float scale) {
    constexpr int BQ = Tile<HD>::BQ, BK = Tile<HD>::BK, P = HD + 4;
    using A = Acc<HD>;
    constexpr int RK2 = BK / A::GROUPS;     // key rows per thread
    static_assert(BK % A::GROUPS == 0, "key rows per thread");
    extern __shared__ float4 smem4[];
    float* sk = reinterpret_cast<float*>(smem4);
    float* sv = sk + BK * P;
    float* sq = sv + BK * P;
    float* sdo = sq + BQ * P;
    float* sp = sdo + BQ * P;
    float* sds = sp + BQ * (BK + 4);
    float* slse = sds + BQ * (BK + 4);
    float* sD = slse + BQ;

    const int Hkv = H / G, b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
    const int k0 = blockIdx.y * BK;
    load_rows<T, HD>(sk, k + b * st.k[0] + hk * st.k[1], st.k[2], k0, BK, Sk);
    load_rows<T, HD>(sv, v + b * st.v[0] + hk * st.v[1], st.v[2], k0, BK, Sk);

    const int lane = threadIdx.x % 32;
    const int grp = (threadIdx.x / 32) * (32 / A::LPR) + lane / A::LPR;
    const int c0 = grp * RK2, dcol = 4 * (lane % A::LPR);
    float dka[RK2][A::DV4][4], dva[RK2][A::DV4][4];
#pragma unroll
    for (int i = 0; i < RK2; ++i)
#pragma unroll
        for (int m = 0; m < A::DV4; ++m)
#pragma unroll
            for (int e = 0; e < 4; ++e) dka[i][m][e] = dva[i][m][e] = 0.f;

    const int nq = (S + BQ - 1) / BQ;
    const int first = causal ? k0 / BQ : 0;
    for (int gi = 0; gi < G; ++gi) {
        const int h = hk * G + gi;
        for (int qb = first; qb < nq; ++qb) {
            const int q0 = qb * BQ;
            __syncthreads();            // the last step's readers are done
            load_rows<T, HD>(sq, q + b * st.q[0] + h * st.q[1], st.q[2], q0, BQ, S);
            load_rows<T, HD>(sdo, g + b * st.g[0] + h * st.g[1], st.g[2], q0, BQ, S);
            load_stats<BQ>(slse, sD, lse, D, (long long)(b * H + h) * S, q0, S);
            __syncthreads();
            scores<HD, false>(sq, sdo, sk, sv, slse, sD, sp, sds, q0, k0, S,
                              Sk, causal, scale);
            __syncthreads();
#pragma unroll 2
            for (int r = 0; r < BQ; ++r) {
                float pv[RK2], dsv[RK2];
                if constexpr (RK2 % 4 == 0) {
#pragma unroll
                    for (int i = 0; i < RK2; i += 4) {
                        const float4 a = ld4(sp + r * (BK + 4) + c0 + i);
                        const float4 c = ld4(sds + r * (BK + 4) + c0 + i);
                        pv[i] = a.x; pv[i + 1] = a.y; pv[i + 2] = a.z; pv[i + 3] = a.w;
                        dsv[i] = c.x; dsv[i + 1] = c.y; dsv[i + 2] = c.z; dsv[i + 3] = c.w;
                    }
                } else {
#pragma unroll
                    for (int i = 0; i < RK2; ++i) {
                        pv[i] = sp[r * (BK + 4) + c0 + i];
                        dsv[i] = sds[r * (BK + 4) + c0 + i];
                    }
                }
#pragma unroll
                for (int m = 0; m < A::DV4; ++m) {
                    const float4 go = ld4(sdo + r * P + dcol + 4 * A::LPR * m);
                    const float4 qv = ld4(sq + r * P + dcol + 4 * A::LPR * m);
#pragma unroll
                    for (int i = 0; i < RK2; ++i) {
                        fma4(dva[i][m], pv[i], go);
                        fma4(dka[i][m], dsv[i], qv);
                    }
                }
            }
        }
    }
    T* dkp = dk + b * st.dk[0] + hk * st.dk[1];
    T* dvp = dv + b * st.dv[0] + hk * st.dv[1];
#pragma unroll
    for (int i = 0; i < RK2; ++i) {
        const int kg = k0 + c0 + i;
        if (kg >= Sk) continue;
#pragma unroll
        for (int m = 0; m < A::DV4; ++m)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int d = dcol + 4 * A::LPR * m + e;
                store(dkp + kg * st.dk[2] + d, dka[i][m][e] * scale);
                store(dvp + kg * st.dv[2] + d, dva[i][m][e]);
            }
    }
}

// (c) dQ of one (batch, q head, q tile)
template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ g,
                 const float* __restrict__ lse, const float* __restrict__ D,
                 T* __restrict__ dq, Strides st, int H, int G, int S, int Sk,
                 int causal, float scale) {
    constexpr int BQ = Tile<HD>::BQ, BK = Tile<HD>::BK, P = HD + 4;
    using A = Acc<HD>;
    constexpr int RQ2 = BQ / A::GROUPS;     // q rows per thread
    static_assert(BQ % A::GROUPS == 0, "q rows per thread");
    extern __shared__ float4 smem4[];
    float* sq = reinterpret_cast<float*>(smem4);
    float* sdo = sq + BQ * P;
    float* sk = sdo + BQ * P;
    float* sv = sk + BK * P;
    float* sdst = sv + BK * P;             // dS as [key][row]
    float* slse = sdst + BK * (BQ + 4);
    float* sD = slse + BQ;

    const int b = blockIdx.x / H, h = blockIdx.x % H, hk = h / G;
    const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // last q tile first
    load_rows<T, HD>(sq, q + b * st.q[0] + h * st.q[1], st.q[2], q0, BQ, S);
    load_rows<T, HD>(sdo, g + b * st.g[0] + h * st.g[1], st.g[2], q0, BQ, S);
    load_stats<BQ>(slse, sD, lse, D, (long long)(b * H + h) * S, q0, S);
    int nkv = (Sk + BK - 1) / BK;
    if (causal) nkv = min(nkv, (min(q0 + BQ, S) - 1) / BK + 1);

    const int lane = threadIdx.x % 32;
    const int grp = (threadIdx.x / 32) * (32 / A::LPR) + lane / A::LPR;
    const int r0 = grp * RQ2, dcol = 4 * (lane % A::LPR);
    float acc[RQ2][A::DV4][4];
#pragma unroll
    for (int i = 0; i < RQ2; ++i)
#pragma unroll
        for (int m = 0; m < A::DV4; ++m)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][m][e] = 0.f;

    const T* kp = k + b * st.k[0] + hk * st.k[1];
    const T* vp = v + b * st.v[0] + hk * st.v[1];
    for (int j = 0; j < nkv; ++j) {
        const int k0 = j * BK;
        __syncthreads();                // the last tile's readers are done
        load_rows<T, HD>(sk, kp, st.k[2], k0, BK, Sk);
        load_rows<T, HD>(sv, vp, st.v[2], k0, BK, Sk);
        __syncthreads();
        scores<HD, true>(sq, sdo, sk, sv, slse, sD, nullptr, sdst, q0, k0, S,
                         Sk, causal, scale);
        __syncthreads();
#pragma unroll 2
        for (int c = 0; c < BK; ++c) {
            float dsv[RQ2];
            if constexpr (RQ2 % 4 == 0) {
#pragma unroll
                for (int i = 0; i < RQ2; i += 4) {
                    const float4 a = ld4(sdst + c * (BQ + 4) + r0 + i);
                    dsv[i] = a.x; dsv[i + 1] = a.y; dsv[i + 2] = a.z; dsv[i + 3] = a.w;
                }
            } else {
#pragma unroll
                for (int i = 0; i < RQ2; ++i) dsv[i] = sdst[c * (BQ + 4) + r0 + i];
            }
#pragma unroll
            for (int m = 0; m < A::DV4; ++m) {
                const float4 kv = ld4(sk + c * P + dcol + 4 * A::LPR * m);
#pragma unroll
                for (int i = 0; i < RQ2; ++i) fma4(acc[i][m], dsv[i], kv);
            }
        }
    }
    T* dqp = dq + b * st.dq[0] + h * st.dq[1];
#pragma unroll
    for (int i = 0; i < RQ2; ++i) {
        const int qg = q0 + r0 + i;
        if (qg >= S) continue;
#pragma unroll
        for (int m = 0; m < A::DV4; ++m)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                store(dqp + qg * st.dq[2] + dcol + 4 * A::LPR * m + e,
                      acc[i][m][e] * scale);
    }
}

template <int HD>
constexpr int dkdv_smem_floats() {
    return 2 * Tile<HD>::BK * (HD + 4) + 2 * Tile<HD>::BQ * (HD + 4)
           + 2 * Tile<HD>::BQ * (Tile<HD>::BK + 4) + 2 * Tile<HD>::BQ;
}

template <int HD>
constexpr int dq_smem_floats() {
    return 2 * Tile<HD>::BQ * (HD + 4) + 2 * Tile<HD>::BK * (HD + 4)
           + Tile<HD>::BK * (Tile<HD>::BQ + 4) + 2 * Tile<HD>::BQ;
}

template <typename T, int HD>
int run(const void* q, const void* k, const void* v, const void* o,
        const void* g, const float* lse, void* dq, void* dk, void* dv,
        float* D, const Strides& st, int B, int H, int Hkv, int S, int Sk,
        int causal, float scale, cudaStream_t s) {
    constexpr int BQ = Tile<HD>::BQ, BK = Tile<HD>::BK;
    constexpr int smem_b = dkdv_smem_floats<HD>() * (int)sizeof(float);
    constexpr int smem_c = dq_smem_floats<HD>() * (int)sizeof(float);
    static_assert(smem_b <= 232448 && smem_c <= 232448, "tiles exceed shared memory");
    const int G = H / Hkv, rows = B * H * S;
    fa_bwd_dot_kernel<T, HD><<<(rows + NWARPS - 1) / NWARPS, NTHREADS, 0, s>>>(
        (const T*)o, (const T*)g, D, st, H, S, rows);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(fa_bwd_dkdv_kernel<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_b);
    if (err != cudaSuccess) return (int)err;
    fa_bwd_dkdv_kernel<T, HD><<<dim3(B * Hkv, (Sk + BK - 1) / BK), NTHREADS, smem_b, s>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)g, lse, D, (T*)dk,
        (T*)dv, st, H, G, S, Sk, causal, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(fa_bwd_dq_kernel<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_c);
    if (err != cudaSuccess) return (int)err;
    fa_bwd_dq_kernel<T, HD><<<dim3(B * H, (S + BQ - 1) / BQ), NTHREADS, smem_c, s>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)g, lse, D, (T*)dq, st,
        H, G, S, Sk, causal, scale);
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* g, const float* lse, void* dq, void* dk, void* dv,
             float* D, int B, int H, int Hkv, int S, int Sk, int hd,
             int causal, float scale, const long long* strides, void* stream) {
    if (B < 1 || H < 1 || Hkv < 1 || H % Hkv || S < 1 || Sk < 1)
        return (int)cudaErrorInvalidValue;
    Strides st;
    long long* dst[8] = {st.q, st.k, st.v, st.o, st.g, st.dq, st.dk, st.dv};
    for (int t = 0; t < 8; ++t)
        for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
    cudaStream_t s = (cudaStream_t)stream;
    switch (hd) {
        case 16: return run<T, 16>(q, k, v, o, g, lse, dq, dk, dv, D, st, B, H, Hkv, S, Sk, causal, scale, s);
        case 32: return run<T, 32>(q, k, v, o, g, lse, dq, dk, dv, D, st, B, H, Hkv, S, Sk, causal, scale, s);
        default: break;
    }
    // bf16 at hd 64-256 runs flash_attention_bwd_wgmma.cu, f32 at hd 64 and
    // 128 flash_attention_bwd_tf32x3.cu
    if constexpr (std::is_same<T, float>::value)
        if (hd == 256)
            return run<T, 256>(q, k, v, o, g, lse, dq, dk, dv, D, st, B, H, Hkv, S, Sk, causal, scale, s);
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, out, dout, dq (B, H, S, hd); k, v, dk, dv (B, Hkv, Sk, hd); lse and the
// scratch D (B, H, S) fp32, contiguous; hd 16, 32 or (f32) 256.  strides:
// 24 element strides, (batch, head, row) of q, k, v, out, dout, dq, dk, dv,
// every row unit-stride.  scale is hd^-0.5 as the caller rounds it to fp32.
// Launches three kernels on `stream`.
extern "C" int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                                       const void* o, const void* g, const float* lse,
                                       void* dq, void* dk, void* dv, float* D, int B,
                                       int H, int Hkv, int S, int Sk, int hd,
                                       int causal, float scale,
                                       const long long* strides, void* stream) {
    return dispatch<float>(q, k, v, o, g, lse, dq, dk, dv, D, B, H, Hkv, S, Sk,
                           hd, causal, scale, strides, stream);
}

extern "C" int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                        const void* o, const void* g, const float* lse,
                                        void* dq, void* dk, void* dv, float* D, int B,
                                        int H, int Hkv, int S, int Sk, int hd,
                                        int causal, float scale,
                                        const long long* strides, void* stream) {
    return dispatch<__nv_bfloat16>(q, k, v, o, g, lse, dq, dk, dv, D, B, H, Hkv,
                                   S, Sk, hd, causal, scale, strides, stream);
}

extern "C" const char* repro_error_string(int e) {
    return cudaGetErrorString((cudaError_t)e);
}
