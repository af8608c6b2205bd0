// Flash attention, forward, causal or not (online softmax, fp32 statistics),
// on the CUDA cores, reading grouped-query attention and strided views as
// they are.
//
// Replaces: src/repro/kernels/flash_attention.py::_fa_kernel (line 22), the
// Pallas TPU kernel launched by flash_attention (grid (B*H, S/block_q)), at
// the head dims the tensor-core kernels do not take: f32 and bf16 at 16 and
// 32 (f32 at 64, 128 and 256 runs flash_attention_tf32x3.cu, bf16 at 64,
// 128 and 256 flash_attention_wgmma.cu).
//
// What it computes: out = softmax(q k^T * hd^-0.5 [+ causal mask]) v for q
// (B, H, S, hd) and k, v (B, Hkv, Sk, hd), q head h reading kv head
// h / (H / Hkv), in fp32 from f32 or bf16 inputs, the output in the input's
// type.  q is scaled in fp32 before the product, masked scores are -1e30,
// and the sum is divided by (l + 1e-30), as in the TPU kernel and the
// model's chunked attention.
//
// Bound on Hopper: at these head dims, launches and latency.  The reduced
// llama3-8b's attention, (2, 6, 256, 16) causal, is 25 MFLOP on 0.5 MB, a
// few microseconds of the card at either rate; what a call costs is its
// launch, and the chain of dependent steps of the block that walks the most
// kv tiles (the last q block of a causal call walks all of them).
//
// Design:
// * One kernel per call on the layer's own tensors.  Each of q, k, v and out
//   comes with its (batch, head, row) element strides (the last dim is
//   unit-stride), so q, k, v may be the .transpose(1, 2) views of the
//   layer's (B, S, heads, hd) activations, and k, v keep their Hkv heads:
//   the wrapper copies and repeats nothing.  The output is written in q's
//   layout.
// * One block of 8 warps per (b*h, q block of block_q rows); warp w owns rows
//   w, w+8, ..., RPW of them (RPW = 2, 4 or 8 by block_q), each lane keys
//   lane and lane+32 of the kv tile for the scores.  Small q blocks (16 rows
//   by default at hd 16/32) put more blocks on the card and shorten each
//   tile's dependent chain; the last q block still walks every tile.
// * K and V tiles of block_k <= 64 keys in fp32 shared memory, K rows padded
//   to hd+1 floats so that lanes reading 32 different keys hit 32 banks,
//   double-buffered: the next tile's loads are in flight in registers while
//   this one is computed, one barrier a tile.
// * P V: the probabilities pass from the score layout to the P V layout
//   through a per-warp strip of shared memory; at hd 16 the two halves of
//   the warp take alternate keys (one output dim each) and are summed once
//   at the end, so no lane idles.
// * Causal blocks stop at kv tile ((q0 + block_q - 1) // block_k), the tile
//   that holds the last query row (the TPU kernel's (qi*block_q)//block_k + 1
//   drops tiles when block_q > block_k).  A ragged last tile of q or kv is
//   masked.  q blocks are launched last-first so the longest causal rows
//   start early, and the q heads that share a kv head side by side.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MAXB = 64;                 // most kv keys per tile
constexpr float NEG_INF = -1e30f;

struct Strides {                         // element strides (batch, head, row)
    long long q[3], k[3], v[3], o[3];
};

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

template <int HD, int RPW>
constexpr int smem_floats(int bq, int bk) {
    return bq * HD + 2 * bk * (2 * HD + 1) + NWARPS * RPW * MAXB;
}

template <typename T, int HD, int RPW>
__global__ void __launch_bounds__(NTHREADS)
fa_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out,
          float* __restrict__ lse, Strides st, int H,
          int G, int S, int Sk, int bq, int bk, int causal, float scale) {
    constexpr int KG = HD < 32 ? 32 / HD : 1;       // key groups of P V
    constexpr int DPL = HD < 32 ? 1 : HD / 32;      // output dims per lane
    constexpr int KP = HD + 1;                      // padded K row
    constexpr int PFN = MAXB * HD / NTHREADS;       // prefetched elements
    extern __shared__ float smem[];
    float* sq = smem;                               // bq x HD, scaled q
    float* sk = sq + bq * HD;                       // 2 x bk x KP
    float* sv = sk + 2 * bk * KP;                   // 2 x bk x HD
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    float* sp = sv + 2 * bk * HD + warp * RPW * MAXB;      // RPW x MAXB

    const int bh = blockIdx.x, b = bh / H, h = bh % H, hkv = h / G;
    const int qi = gridDim.y - 1 - blockIdx.y;      // last q block first
    const int q0 = qi * bq;
    const T* qp = q + b * st.q[0] + h * st.q[1];
    const T* kp = k + b * st.k[0] + hkv * st.k[1];
    const T* vp = v + b * st.v[0] + hkv * st.v[1];
    T* op = out + b * st.o[0] + h * st.o[1];

    for (int e = threadIdx.x; e < bq * HD; e += NTHREADS) {
        const int gr = q0 + e / HD;
        sq[e] = gr < S ? to_f32(qp[gr * st.q[2] + e % HD]) * scale : 0.f;
    }

    int nkv = (Sk + bk - 1) / bk;
    if (causal) {
        const int last = min(q0 + bq, S) - 1;       // last query row here
        nkv = min(nkv, last / bk + 1);
    }

    // tile j's K and V: element e of the tile is key e / HD, dim e % HD
    float kr[PFN], vr[PFN];
    auto fetch = [&](int j) {
#pragma unroll
        for (int i = 0; i < PFN; ++i) {
            const int e = i * NTHREADS + threadIdx.x, gk = j * bk + e / HD;
            const bool ok = e < bk * HD && gk < Sk;
            kr[i] = ok ? to_f32(kp[gk * st.k[2] + e % HD]) : 0.f;
            vr[i] = ok ? to_f32(vp[gk * st.v[2] + e % HD]) : 0.f;
        }
    };
    auto put = [&](int buf) {
#pragma unroll
        for (int i = 0; i < PFN; ++i) {
            const int e = i * NTHREADS + threadIdx.x;
            if (e < bk * HD) {
                sk[buf * bk * KP + (e / HD) * KP + e % HD] = kr[i];
                sv[buf * bk * HD + e] = vr[i];
            }
        }
    };
    fetch(0);
    put(0);

    // this warp's rows (clamped into the tile; rows past it are not stored)
    const float* qrow[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) qrow[i] = sq + min(i * NWARPS + warp, bq - 1) * HD;
    const int d0 = lane % (HD < 32 ? HD : 32), kh = HD < 32 ? lane / HD : 0;

    float acc[RPW][DPL], m[RPW], l[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
        m[i] = NEG_INF;
        l[i] = 0.f;
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[i][c] = 0.f;
    }

    for (int j = 0; j < nkv; ++j) {
        const int k0 = j * bk, buf = j & 1;
        __syncthreads();                 // tile j is whole; the other buffer is free
        if (j + 1 < nkv) fetch(j + 1);   // in flight meanwhile
        const float* tk = sk + buf * bk * KP;
        const float* tv = sv + buf * bk * HD;
        const float* krow0 = tk + min(lane, bk - 1) * KP;
        const float* krow1 = tk + min(lane + 32, bk - 1) * KP;

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

        for (int kt = kh; kt < bk; kt += KG) {
            float vv[DPL];
#pragma unroll
            for (int c = 0; c < DPL; ++c) vv[c] = tv[kt * HD + d0 + 32 * c];
#pragma unroll
            for (int i = 0; i < RPW; ++i) {
                const float p = sp[i * MAXB + kt];
#pragma unroll
                for (int c = 0; c < DPL; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
            }
        }
        __syncwarp();                    // sp is rewritten by the next tile
        if (j + 1 < nkv) put((j + 1) & 1);
    }

    // the key groups' partial sums (hd < 32)
#pragma unroll
    for (int off = HD; off < 32; off <<= 1)
#pragma unroll
        for (int i = 0; i < RPW; ++i)
#pragma unroll
            for (int c = 0; c < DPL; ++c)
                acc[i][c] += __shfl_xor_sync(0xffffffffu, acc[i][c], off);

#pragma unroll
    for (int i = 0; i < RPW; ++i) {
        const int row = i * NWARPS + warp, qg = q0 + row;
        if (row >= bq || qg >= S || kh != 0) continue;
        const float denom = l[i] + 1e-30f;
#pragma unroll
        for (int c = 0; c < DPL; ++c)
            store(op + qg * st.o[2] + d0 + 32 * c, acc[i][c] / denom);
        if (lse != nullptr && lane == 0) lse[(long long)bh * S + qg] = m[i] + logf(l[i]);
    }
}

template <typename T, int HD, int RPW>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, const Strides& st, int B, int H, int Hkv, int S, int Sk, int bq,
           int bk, int causal, float scale, cudaStream_t stream) {
    const int smem = smem_floats<HD, RPW>(bq, bk) * (int)sizeof(float);
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            fa_kernel<T, HD, RPW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            smem);
        if (err != cudaSuccess) return (int)err;
    }
    const dim3 grid(B * H, (S + bq - 1) / bq);
    fa_kernel<T, HD, RPW><<<grid, NTHREADS, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)out, lse, st, H, H / Hkv, S, Sk,
        bq, bk, causal, scale);
    return (int)cudaGetLastError();
}

template <typename T, int HD>
int by_rows(const void* q, const void* k, const void* v, void* out,
            float* lse, const Strides& st, int B, int H, int Hkv, int S, int Sk, int bq,
            int bk, int causal, float scale, cudaStream_t s) {
    if (bq <= 2 * NWARPS)
        return launch<T, HD, 2>(q, k, v, out, lse, st, B, H, Hkv, S, Sk, bq, bk, causal, scale, s);
    if (bq <= 4 * NWARPS)
        return launch<T, HD, 4>(q, k, v, out, lse, st, B, H, Hkv, S, Sk, bq, bk, causal, scale, s);
    return launch<T, HD, 8>(q, k, v, out, lse, st, B, H, Hkv, S, Sk, bq, bk, causal, scale, s);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out,
             float* lse, int B,
             int H, int Hkv, int S, int Sk, int hd, int bq, int bk,
             int causal, float scale, const long long* strides, void* stream) {
    if (B < 1 || H < 1 || Hkv < 1 || H % Hkv || S < 1 || Sk < 1 || bq < 1 ||
        bq > 8 * NWARPS || bk < 1 || bk > MAXB)
        return (int)cudaErrorInvalidValue;
    Strides st;
    for (int i = 0; i < 3; ++i) {
        st.q[i] = strides[i];
        st.k[i] = strides[3 + i];
        st.v[i] = strides[6 + i];
        st.o[i] = strides[9 + i];
    }
    cudaStream_t s = (cudaStream_t)stream;
    switch (hd) {
        case 16: return by_rows<T, 16>(q, k, v, out, lse, st, B, H, Hkv, S, Sk, bq, bk, causal, scale, s);
        case 32: return by_rows<T, 32>(q, k, v, out, lse, st, B, H, Hkv, S, Sk, bq, bk, causal, scale, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// q (B, H, S, hd), k and v (B, Hkv, Sk, hd), out (B, H, S, hd); hd 16 or 32;
// strides: 12 element strides, (batch, head, row) of q,
// k, v, out, every row unit-stride.  scale is hd^-0.5 as the caller rounds
// it to fp32.  lse, when not null, receives each row's log-sum-exp of the
// scaled scores, (B, H, S) fp32 contiguous (for the backward kernel).
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* out, float* lse, int B, int H, int Hkv, int S,
                                   int Sk, int hd, int bq, int bk, int causal,
                                   float scale, const long long* strides,
                                   void* stream) {
    return dispatch<float>(q, k, v, out, lse, B, H, Hkv, S, Sk, hd, bq, bk, causal,
                           scale, strides, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v,
                                    void* out, float* lse, int B, int H, int Hkv, int S,
                                    int Sk, int hd, int bq, int bk, int causal,
                                    float scale, const long long* strides,
                                    void* stream) {
    return dispatch<__nv_bfloat16>(q, k, v, out, lse, B, H, Hkv, S, Sk, hd, bq, bk,
                                   causal, scale, strides, stream);
}

extern "C" const char* repro_error_string(int e) {
    return cudaGetErrorString((cudaError_t)e);
}
