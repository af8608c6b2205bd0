// Flash attention, forward, causal or not (online softmax, fp32 statistics).
//
// Replaces: src/repro/kernels/flash_attention.py::_fa_kernel, the Pallas TPU
// kernel launched by flash_attention (grid (B*H, S/block_q)), at the head
// dims the tensor-core kernels do not take: f32 at 16, 32 and 256, bf16 at
// 16 and 32 (f32 at 64 and 128 runs flash_attention_tf32x3.cu, bf16 at 64,
// 128 and 256 flash_attention_wgmma.cu).
//
// What it computes: out = softmax(q k^T * hd^-0.5 [+ causal mask]) v over
// (B, H, S, hd) tensors, in fp32 from f32 or bf16 inputs, the output in the
// input's type.  q is scaled in fp32 before the product, masked scores are
// -1e30, and the sum is divided by (l + 1e-30), as in the TPU kernel and
// the model's chunked attention.
//
// Bound on Hopper: operations.  Causal prefill at (1, 32, 4096, 128) does
// 2*2*S^2*hd*H/2 = 137 GFLOP on 134 MB: about 1,000 flops per byte, above
// the tensor cores' 295 flop/byte balance point, so its least time is the
// bf16 tensor-core time (0.14 ms).  This first kernel runs on the CUDA
// cores (67 TFLOP/s fp32: 2.05 ms) and is limited further by shared-memory
// reads in its inner products; tensor cores (wgmma) and TMA are later work.
//
// Design: one block of 8 warps per (b*h, q block of block_q <= 64 rows).
// The scaled q tile stays in shared memory; K and V tiles of block_k <= 64
// keys are staged through shared memory in fp32 (K rows padded to hd+1
// floats so that lanes reading 32 different keys hit 32 banks).  Warp w
// owns rows w, w+8, ..., each lane owns keys lane and lane+32 of the tile
// for the scores and output dims lane, lane+32, ... for the accumulator, so
// the 8 rows' fp32 accumulators, running max m and denominator l live in
// registers.  The probabilities pass from the score layout to the PV
// layout through a per-warp strip of shared memory.  Causal blocks stop at
// kv block ((q0 + block_q - 1) // block_k), the tile that holds the last
// query row (the TPU kernel's (qi*block_q)//block_k + 1 drops tiles when
// block_q > block_k).  A ragged last tile of q or kv is masked.  q blocks
// are launched last-first so the longest causal rows start early.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MAXB = 64;                 // most q rows and kv keys per block
constexpr int RPW = MAXB / NWARPS;       // q rows per warp
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

template <int HD>
constexpr int smem_floats(int bq, int bk) {
    return bq * HD + bk * (HD + 1) + bk * HD + NWARPS * RPW * MAXB;
}

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS)
fa_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out,
          int S, int Sk, int bq, int bk, int causal, float scale) {
    constexpr int DPL = (HD + 31) / 32;  // accumulator dims per lane
    constexpr int KP = HD + 1;           // padded K row
    extern __shared__ float smem[];
    float* sq = smem;                    // bq x HD, scaled q
    float* sk = sq + bq * HD;            // bk x KP
    float* sv = sk + bk * KP;            // bk x HD
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    float* sp = sv + bk * HD + warp * RPW * MAXB;   // this warp's RPW x MAXB

    const int bh = blockIdx.x;
    const int qi = gridDim.y - 1 - blockIdx.y;      // last q block first
    const int q0 = qi * bq;
    const size_t qbase = (size_t)bh * S * HD;
    const size_t kbase = (size_t)bh * Sk * HD;

    for (int e = threadIdx.x; e < bq * HD; e += NTHREADS) {
        const int gr = q0 + e / HD;
        sq[e] = gr < S ? to_f32(q[qbase + (size_t)gr * HD + e % HD]) * scale : 0.f;
    }

    int nkv = (Sk + bk - 1) / bk;
    if (causal) {
        const int last = min(q0 + bq, S) - 1;       // last query row here
        nkv = min(nkv, last / bk + 1);
    }

    // this warp's rows (clamped into the tile; rows past it are not stored)
    const float* qrow[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) qrow[i] = sq + min(i * NWARPS + warp, bq - 1) * HD;
    const float* krow0 = sk + min(lane, bk - 1) * KP;
    const float* krow1 = sk + min(lane + 32, bk - 1) * KP;

    float acc[RPW][DPL], m[RPW], l[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
        m[i] = NEG_INF;
        l[i] = 0.f;
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[i][c] = 0.f;
    }

    for (int j = 0; j < nkv; ++j) {
        const int k0 = j * bk;
        __syncthreads();                 // the previous tile is consumed
        for (int e = threadIdx.x; e < bk * HD; e += NTHREADS) {
            const int kr = e / HD, d = e % HD;
            const int gk = k0 + kr;
            const size_t off = kbase + (size_t)gk * HD + d;
            sk[kr * KP + d] = gk < Sk ? to_f32(k[off]) : 0.f;
            sv[e] = gk < Sk ? to_f32(v[off]) : 0.f;
        }
        __syncthreads();

        float s[RPW][2];
#pragma unroll
        for (int i = 0; i < RPW; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) {
            const float ka = krow0[d], kb = krow1[d];
#pragma unroll
            for (int i = 0; i < RPW; ++i) {
                const float qv = qrow[i][d];
                s[i][0] = fmaf(qv, ka, s[i][0]);
                s[i][1] = fmaf(qv, kb, s[i][1]);
            }
        }

#pragma unroll
        for (int i = 0; i < RPW; ++i) {
            const int qg = q0 + i * NWARPS + warp;
#pragma unroll
            for (int c = 0; c < 2; ++c) {
                const int kt = lane + 32 * c, kg = k0 + kt;
                const bool ok = kt < bk && kg < Sk && (!causal || qg >= kg);
                if (!ok) s[i][c] = NEG_INF;
            }
            const float m1 = fmaxf(m[i], warp_max(fmaxf(s[i][0], s[i][1])));
            const float p0 = expf(s[i][0] - m1), p1 = expf(s[i][1] - m1);
            const float alpha = expf(m[i] - m1);
            l[i] = l[i] * alpha + warp_sum(p0 + p1);
            m[i] = m1;
            sp[i * MAXB + lane] = p0;
            sp[i * MAXB + lane + 32] = p1;
#pragma unroll
            for (int c = 0; c < DPL; ++c) acc[i][c] *= alpha;
        }
        __syncwarp();

        for (int kt = 0; kt < bk; ++kt) {
            float vv[DPL];
#pragma unroll
            for (int c = 0; c < DPL; ++c) {
                const int d = lane + 32 * c;
                vv[c] = d < HD ? sv[kt * HD + d] : 0.f;
            }
#pragma unroll
            for (int i = 0; i < RPW; ++i) {
                const float p = sp[i * MAXB + kt];
#pragma unroll
                for (int c = 0; c < DPL; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
            }
        }
        __syncwarp();                    // sp is rewritten by the next tile
    }

#pragma unroll
    for (int i = 0; i < RPW; ++i) {
        const int row = i * NWARPS + warp, qg = q0 + row;
        if (row >= bq || qg >= S) continue;
        const float denom = l[i] + 1e-30f;
#pragma unroll
        for (int c = 0; c < DPL; ++c) {
            const int d = lane + 32 * c;
            if (d < HD) store(out + qbase + (size_t)qg * HD + d, acc[i][c] / denom);
        }
    }
}

template <typename T, int HD>
static int launch(const void* q, const void* k, const void* v, void* out,
                  int BH, int S, int Sk, int bq, int bk, int causal,
                  float scale, void* stream) {
    const int smem = smem_floats<HD>(bq, bk) * (int)sizeof(float);
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            fa_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return (int)err;
    }
    const dim3 grid(BH, (S + bq - 1) / bq);
    fa_kernel<T, HD><<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)out, S, Sk, bq, bk, causal,
        scale);
    return (int)cudaGetLastError();
}

template <typename T>
static int dispatch(const void* q, const void* k, const void* v, void* out,
                    int BH, int S, int Sk, int hd, int bq, int bk, int causal,
                    float scale, void* stream) {
    if (BH < 1 || S < 1 || Sk < 1 || bq < 1 || bq > MAXB || bk < 1 || bk > MAXB)
        return (int)cudaErrorInvalidValue;
    switch (hd) {
        case 16: return launch<T, 16>(q, k, v, out, BH, S, Sk, bq, bk, causal, scale, stream);
        case 32: return launch<T, 32>(q, k, v, out, BH, S, Sk, bq, bk, causal, scale, stream);
        case 64: return launch<T, 64>(q, k, v, out, BH, S, Sk, bq, bk, causal, scale, stream);
        case 128: return launch<T, 128>(q, k, v, out, BH, S, Sk, bq, bk, causal, scale, stream);
        case 256: return launch<T, 256>(q, k, v, out, BH, S, Sk, bq, bk, causal, scale, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

// scale is hd^-0.5 as the caller rounds it to fp32
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* out, int BH, int S, int Sk, int hd,
                                   int bq, int bk, int causal, float scale,
                                   void* stream) {
    return dispatch<float>(q, k, v, out, BH, S, Sk, hd, bq, bk, causal, scale,
                           stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v,
                                    void* out, int BH, int S, int Sk, int hd,
                                    int bq, int bk, int causal, float scale,
                                    void* stream) {
    return dispatch<__nv_bfloat16>(q, k, v, out, BH, S, Sk, hd, bq, bk, causal,
                                   scale, stream);
}

extern "C" const char* repro_error_string(int e) {
    return cudaGetErrorString((cudaError_t)e);
}
