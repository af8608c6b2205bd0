// RWKV-6 (Finch) WKV recurrence: a one-token step kernel for decoding and a
// chunk-parallel schedule for sequences, both reading the model layer's own
// views and writing the output in the layer's type.
//
// Replaces: src/repro/kernels/wkv6.py::_wkv_kernel (line 21), the Pallas TPU
// kernel launched by wkv6 (grid (batch, heads), chunked parallel form).
//
// What it computes, per (batch b, head h), for t = 0 .. S-1:
//     o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
//     S_t = diag(w_t) S_{t-1} + k_t^T v_t
// from S_{-1} = s0 (zeros when no initial state is given), in fp32, and
// returns the outputs (rounded once to the output's type) and the final
// state S_{S-1}.  The TPU kernel does not return the state; the model's
// time mix carries it from prefill into decode.
//
// Inputs: r, k, v (B, H, S, hd) in float32 or bfloat16 and w (B, H, S, hd)
// in float32, each through its own (batch, head, token) element strides
// with the last dim unit-stride, so they may be the (B, S, heads, hd)
// activations of the layer viewed as (B, H, S, hd); u (H, hd) float32; s0
// and the state out (B, H, hd, hd) float32, contiguous and 16-byte aligned.
// The state out may be s0 itself: every thread reads the state entries it
// will overwrite, and only those, before it writes them.
//
// Bound on Hopper: device memory.  The step reads and writes the hd x hd
// state of every head (16 KB each at hd 64) and a few hd-vectors; the
// sequence reads r, k, v, w once and writes the output once, about 5 flops
// per state entry per token: under 1 flop per byte at hd 64.
//
// Step (S = 1): one block per (b, h), one thread per state column, the
// column in registers (each warp reads and writes whole 128-byte rows), the
// token's r, k, w and u staged in shared memory.  (A layout of 4 x 4
// pieces a thread, read with 16-byte accesses and summed by shuffles, was
// slower on an H100: 3.7 us a call at (4, 40, 1, 64), where this layout
// took 3.1 on f32 inputs.)
//
// Sequence (S > 1): the TPU kernel's chunked form divides by the cumulative
// decay (k * exp(-cumsum(log w))) and overflows fp32 for strong decays.  This
// schedule only ever multiplies by w in (0, 1] and products of it, so it
// stays finite for every decay.  Chunks of C tokens, three launches:
//   1. in parallel over (b, h, chunk): the chunk's own contribution to the
//      state from zero, L_c = sum_t (prod_{t' > t} w_t') k_t^T v_t, walked
//      token by token, and its decay product P_c = prod_t w_t;
//   2. over chunks in order, in parallel over (b, h, state entries): the
//      chunk's starting state, S_0 = s0, S_{c+1} = diag(P_c) S_c + L_c,
//      written over L_c; the last is the final state;
//   3. in parallel over (b, h, chunk) again: the chunk's tokens walked from
//      its starting state for the outputs.
// In 1 and 3 a block stages the chunk's rows in shared memory and four
// adjacent lanes share a state column (rows interleaved over them), so a
// token costs hd/4 multiply-adds a thread and two shuffles, with no barrier.
// Tokens past S in the last chunk are masked.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

// tokens a block stages at a time in the chunk form (its shared memory
// stays under 48 KB whatever the chunk length)
template <int HD> constexpr int SUB = HD >= 128 ? 16 : 32;

struct Views {                           // element strides (batch, head, token)
    long long r[3], k[3], v[3], w[3], o[3];
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// ---------------------------------------------------------------------------
// the step: S = 1
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(HD)
wkv6_step_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ u, const float* s0, T* out,
                 float* s_out, Views vw, int H) {
    __shared__ float sr[HD], sk[HD], sw[HD], su[HD];
    const int bh = blockIdx.x, b = bh / H, h = bh % H, e = threadIdx.x;
    const size_t sb = (size_t)bh * HD * HD;
    float col[HD];                        // S[:, e]
#pragma unroll
    for (int i = 0; i < HD; ++i) col[i] = s0 ? s0[sb + i * HD + e] : 0.f;
    sr[e] = ld(r + b * vw.r[0] + h * vw.r[1] + e);
    sk[e] = ld(k + b * vw.k[0] + h * vw.k[1] + e);
    sw[e] = w[b * vw.w[0] + h * vw.w[1] + e];
    su[e] = u[h * HD + e];
    const float ve = ld(v + b * vw.v[0] + h * vw.v[1] + e);
    __syncthreads();
    float o[4] = {0.f, 0.f, 0.f, 0.f};    // four chains of the row sum
#pragma unroll
    for (int i = 0; i < HD; ++i) {
        const float kv = sk[i] * ve;
        o[i & 3] = fmaf(sr[i], fmaf(su[i], kv, col[i]), o[i & 3]);
        col[i] = fmaf(col[i], sw[i], kv);
    }
    st(out + b * vw.o[0] + h * vw.o[1] + e, (o[0] + o[1]) + (o[2] + o[3]));
#pragma unroll
    for (int i = 0; i < HD; ++i) s_out[sb + i * HD + e] = col[i];
}

// ---------------------------------------------------------------------------
// the sequence: three launches over chunks of C tokens
// ---------------------------------------------------------------------------

// stage SUB rows of a (token, hd) view into shared memory as fp32 (rows
// past n zeroed), 4 elements a load where the view's rows allow it
template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<__nv_bfloat16> { using type = uint2; };
__device__ __forceinline__ void widen(float4 x, float* d) {
    d[0] = x.x; d[1] = x.y; d[2] = x.z; d[3] = x.w;
}
__device__ __forceinline__ void widen(uint2 x, float* d) {
    const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) d[i] = __bfloat162float(b[i]);
}

template <typename T, int HD, int NT>
__device__ __forceinline__ void stage(float* dst, const T* src, long long ts,
                                      int n) {
    constexpr int ROWS = SUB<HD>;
    using V = typename Vec4<T>::type;
    if (ts % 4 == 0 && reinterpret_cast<size_t>(src) % sizeof(V) == 0) {
        for (int x = threadIdx.x; x < ROWS * HD / 4; x += NT) {
            const int tt = (4 * x) / HD, d = (4 * x) % HD;
            if (tt < n)
                widen(*reinterpret_cast<const V*>(src + tt * ts + d), dst + 4 * x);
            else
                widen(make_float4(0.f, 0.f, 0.f, 0.f), dst + 4 * x);
        }
    } else {
        for (int x = threadIdx.x; x < ROWS * HD; x += NT) {
            const int tt = x / HD, d = x % HD;
            dst[x] = tt < n ? ld(src + tt * ts + d) : 0.f;
        }
    }
}

__device__ __forceinline__ void unpack(const float* p, float (&x)[4]) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    x[0] = f.x; x[1] = f.y; x[2] = f.z; x[3] = f.w;
}

// 1: L_c and P_c of every chunk, into Ls (B*H, nc, HD, HD) and Ps (B*H, nc,
// HD); a thread owns a 4 x 4 piece of L (4 rows, 4 neighbouring columns),
// so each token is three 16-byte shared loads and 16 multiply-adds
template <typename T, int HD>
__global__ void __launch_bounds__(HD * HD / 16)
wkv6_chunk_state_kernel(const T* __restrict__ k, const T* __restrict__ v,
                        const float* __restrict__ w, float* __restrict__ Ls,
                        float* __restrict__ Ps, Views vw, int H, int S, int C) {
    constexpr int NCG = HD / 4, NT = HD * HD / 16;
    __shared__ __align__(16) float sk[SUB<HD> * HD], sv[SUB<HD> * HD],
        sw[SUB<HD> * HD];
    const int c = blockIdx.x, nc = gridDim.x, bh = blockIdx.y;
    const int b = bh / H, h = bh % H;
    const int t0 = c * C, n = min(C, S - t0);
    const int e0 = 4 * (threadIdx.x % NCG), i0 = 4 * (threadIdx.x / NCG);
    float L[4][4], P[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        P[j] = 1.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) L[j][e] = 0.f;
    }
    for (int t1 = 0; t1 < n; t1 += SUB<HD>) {
        const int m = min(SUB<HD>, n - t1), ta = t0 + t1;
        __syncthreads();                 // the previous rows are consumed
        stage<T, HD, NT>(sk, k + b * vw.k[0] + h * vw.k[1] + ta * vw.k[2], vw.k[2], m);
        stage<T, HD, NT>(sv, v + b * vw.v[0] + h * vw.v[1] + ta * vw.v[2], vw.v[2], m);
        stage<float, HD, NT>(sw, w + b * vw.w[0] + h * vw.w[1] + ta * vw.w[2], vw.w[2], m);
        __syncthreads();
        for (int tt = 0; tt < m; ++tt) {
            float kk[4], ww[4], vv[4];
            unpack(sk + tt * HD + i0, kk);
            unpack(sw + tt * HD + i0, ww);
            unpack(sv + tt * HD + e0, vv);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
#pragma unroll
                for (int e = 0; e < 4; ++e) L[j][e] = fmaf(L[j][e], ww[j], kk[j] * vv[e]);
                P[j] *= ww[j];
            }
        }
    }
    const size_t cb = (size_t)bh * nc + c;
#pragma unroll
    for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float4*>(Ls + cb * HD * HD + (i0 + j) * HD + e0) =
            make_float4(L[j][0], L[j][1], L[j][2], L[j][3]);
    if (e0 == 0)
        *reinterpret_cast<float4*>(Ps + cb * HD + i0) = make_float4(P[0], P[1], P[2], P[3]);
}

// 2: the chunks' starting states over L_c in place, and the final state;
// one thread per 4 neighbouring entries of a head's state, the chunks'
// L and P loaded AHEAD at a time before they are used
template <int HD>
__global__ void __launch_bounds__(256)
wkv6_chunk_scan_kernel(float* __restrict__ Ls, const float* __restrict__ Ps,
                       const float* s0, float* s_out, int nc, int BH) {
    constexpr int Q4 = HD * HD / 4, AHEAD = 8;
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    if (x >= BH * Q4) return;
    const int bh = x / Q4, off = (x % Q4) * 4, i = off / HD;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s0) s = *reinterpret_cast<const float4*>(s0 + (size_t)bh * HD * HD + off);
    for (int c0 = 0; c0 < nc; c0 += AHEAD) {
        float4 Lc[AHEAD];
        float Pc[AHEAD];
#pragma unroll
        for (int d = 0; d < AHEAD; ++d)
            if (c0 + d < nc) {
                const size_t cb = (size_t)bh * nc + c0 + d;
                Lc[d] = *reinterpret_cast<const float4*>(Ls + cb * HD * HD + off);
                Pc[d] = Ps[cb * HD + i];
            }
#pragma unroll
        for (int d = 0; d < AHEAD; ++d)
            if (c0 + d < nc) {
                const size_t cb = (size_t)bh * nc + c0 + d;
                *reinterpret_cast<float4*>(Ls + cb * HD * HD + off) = s;
                s = make_float4(fmaf(Pc[d], s.x, Lc[d].x), fmaf(Pc[d], s.y, Lc[d].y),
                                fmaf(Pc[d], s.z, Lc[d].z), fmaf(Pc[d], s.w, Lc[d].w));
            }
    }
    *reinterpret_cast<float4*>(s_out + (size_t)bh * HD * HD + off) = s;
}

// 3: each chunk's outputs, walked from its starting state.  A thread owns
// RT rows by 4 neighbouring columns; the R3 lanes that share the columns
// are adjacent and hold a slice of the rows each.  Per token a thread reads
// its rows of r, k, w and its 4 values of v with 16-byte shared loads and
// sums the bonus term r.(u*k) over its rows once for its 4 columns; the
// lanes' partial outputs meet by shuffles
template <int HD> constexpr int R3 = HD >= 64 ? 8 : 4;   // lanes per column group

template <typename T, int HD>
__global__ void __launch_bounds__(HD * R3<HD> / 4)
wkv6_chunk_out_kernel(const T* __restrict__ r, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ w,
                      const float* __restrict__ u,
                      const float* __restrict__ starts, T* __restrict__ out,
                      Views vw, int H, int S, int C) {
    constexpr int L = R3<HD>, NT = HD * L / 4, RT = HD / L;
    constexpr unsigned MASK = NT >= 32 ? 0xffffffffu : (1u << (NT & 31)) - 1;
    __shared__ __align__(16) float sr[SUB<HD> * HD], sk[SUB<HD> * HD],
        sv[SUB<HD> * HD], sw[SUB<HD> * HD];
    const int c = blockIdx.x, nc = gridDim.x, bh = blockIdx.y;
    const int b = bh / H, h = bh % H;
    const int t0 = c * C, n = min(C, S - t0);
    const int q = threadIdx.x % L, i0 = q * RT, e0 = 4 * (threadIdx.x / L);
    const size_t base = ((size_t)bh * nc + c) * HD * HD;
    float s[RT][4], ub[RT];
#pragma unroll
    for (int j = 0; j < RT; ++j) {
        unpack(starts + base + (i0 + j) * HD + e0, s[j]);
        ub[j] = u[h * HD + i0 + j];
    }
    for (int t1 = 0; t1 < n; t1 += SUB<HD>) {
        const int m = min(SUB<HD>, n - t1), ta = t0 + t1;
        __syncthreads();                 // the previous rows are consumed
        stage<T, HD, NT>(sr, r + b * vw.r[0] + h * vw.r[1] + ta * vw.r[2], vw.r[2], m);
        stage<T, HD, NT>(sk, k + b * vw.k[0] + h * vw.k[1] + ta * vw.k[2], vw.k[2], m);
        stage<T, HD, NT>(sv, v + b * vw.v[0] + h * vw.v[1] + ta * vw.v[2], vw.v[2], m);
        stage<float, HD, NT>(sw, w + b * vw.w[0] + h * vw.w[1] + ta * vw.w[2], vw.w[2], m);
        __syncthreads();
        T* op = out + b * vw.o[0] + h * vw.o[1] + ta * vw.o[2] + e0;
        for (int tt = 0; tt < m; ++tt) {
            float vv[4], o[4] = {0.f, 0.f, 0.f, 0.f}, bonus = 0.f;
            unpack(sv + tt * HD + e0, vv);
#pragma unroll
            for (int j0 = 0; j0 < RT; j0 += 4) {
                float rr[4], kk[4], ww[4];
                unpack(sr + tt * HD + i0 + j0, rr);
                unpack(sk + tt * HD + i0 + j0, kk);
                unpack(sw + tt * HD + i0 + j0, ww);
#pragma unroll
                for (int mm = 0; mm < 4; ++mm) {
                    const int j = j0 + mm;
                    bonus = fmaf(rr[mm] * ub[j], kk[mm], bonus);
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        o[e] = fmaf(rr[mm], s[j][e], o[e]);
                        s[j][e] = fmaf(s[j][e], ww[mm], kk[mm] * vv[e]);
                    }
                }
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                o[e] = fmaf(bonus, vv[e], o[e]);
#pragma unroll
                for (int off = 1; off < L; off <<= 1)
                    o[e] += __shfl_xor_sync(MASK, o[e], off);
            }
            if (q == 0) {
#pragma unroll
                for (int e = 0; e < 4; ++e) st(op + tt * vw.o[2] + e, o[e]);
            }
        }
    }
}

template <typename T, int HD>
int launch_step(const void* r, const void* k, const void* v, const void* w,
                const void* u, const void* s0, void* out, void* s_out,
                const Views& vw, int B, int H, cudaStream_t stream) {
    wkv6_step_kernel<T, HD><<<B * H, HD, 0, stream>>>(
        (const T*)r, (const T*)k, (const T*)v, (const float*)w,
        (const float*)u, (const float*)s0, (T*)out, (float*)s_out, vw, H);
    return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_chunks(const void* r, const void* k, const void* v, const void* w,
                  const void* u, const void* s0, void* out, void* s_out,
                  void* Ls, void* Ps, const Views& vw, int B, int H, int S,
                  int C, cudaStream_t stream) {
    const int nc = (S + C - 1) / C;
    cudaError_t err;
    const dim3 grid(nc, B * H);
    wkv6_chunk_state_kernel<T, HD><<<grid, HD * HD / 16, 0, stream>>>(
        (const T*)k, (const T*)v, (const float*)w, (float*)Ls, (float*)Ps, vw,
        H, S, C);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const int n4 = B * H * HD * HD / 4;
    wkv6_chunk_scan_kernel<HD><<<(n4 + 255) / 256, 256, 0, stream>>>(
        (float*)Ls, (const float*)Ps, (const float*)s0, (float*)s_out, nc,
        B * H);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    wkv6_chunk_out_kernel<T, HD><<<grid, HD * R3<HD> / 4, 0, stream>>>(
        (const T*)r, (const T*)k, (const T*)v, (const float*)w,
        (const float*)u, (const float*)Ls, (T*)out, vw, H, S, C);
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* s0, void* out, void* s_out, void* Ls,
             void* Ps, const long long* strides, int B, int H, int S, int hd,
             int C, void* stream) {
    if (B < 1 || H < 1 || S < 1 || (S > 1 && C < 1))
        return (int)cudaErrorInvalidValue;
    Views vw;
    for (int i = 0; i < 3; ++i) {
        vw.r[i] = strides[i];
        vw.k[i] = strides[3 + i];
        vw.v[i] = strides[6 + i];
        vw.w[i] = strides[9 + i];
        vw.o[i] = strides[12 + i];
    }
    cudaStream_t s = (cudaStream_t)stream;
#define WKV6_HD(N)                                                             \
    case N:                                                                    \
        return S == 1 ? launch_step<T, N>(r, k, v, w, u, s0, out, s_out, vw,   \
                                          B, H, s)                             \
                      : launch_chunks<T, N>(r, k, v, w, u, s0, out, s_out, Ls, \
                                            Ps, vw, B, H, S, C, s);
    switch (hd) {
        WKV6_HD(16)
        WKV6_HD(32)
        WKV6_HD(64)
        WKV6_HD(128)
        default: return (int)cudaErrorInvalidValue;
    }
#undef WKV6_HD
}

}  // namespace

// r, k, v and out in float32 (wkv6_f32) or bfloat16 (wkv6_bf16), w, u, s0
// and s_out float32.  strides: 15 element strides, (batch, head, token) of
// r, k, v, w, out.  s0 may be null (a zero initial state) and may equal
// s_out.  S = 1 runs the step kernel (one launch; Ls and Ps unused), S > 1
// the chunk schedule (three launches) with Ls (B*H*nc*hd*hd) and Ps
// (B*H*nc*hd) float32 scratch, nc = ceil(S / C).  hd is 16, 32, 64 or 128.
extern "C" int wkv6_f32(const void* r, const void* k, const void* v,
                        const void* w, const void* u, const void* s0,
                        void* out, void* s_out, void* Ls, void* Ps,
                        const long long* strides, int B, int H, int S, int hd,
                        int C, void* stream) {
    return dispatch<float>(r, k, v, w, u, s0, out, s_out, Ls, Ps, strides, B,
                           H, S, hd, C, stream);
}

extern "C" int wkv6_bf16(const void* r, const void* k, const void* v,
                         const void* w, const void* u, const void* s0,
                         void* out, void* s_out, void* Ls, void* Ps,
                         const long long* strides, int B, int H, int S, int hd,
                         int C, void* stream) {
    return dispatch<__nv_bfloat16>(r, k, v, w, u, s0, out, s_out, Ls, Ps,
                                   strides, B, H, S, hd, C, stream);
}

extern "C" const char* repro_error_string(int e) {
    return cudaGetErrorString((cudaError_t)e);
}
