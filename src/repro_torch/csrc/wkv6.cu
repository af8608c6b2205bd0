// RWKV-6 (Finch) WKV recurrence, one token after another.
//
// Replaces: src/repro/kernels/wkv6.py::_wkv_kernel, the Pallas TPU kernel
// launched by wkv6 (grid (batch, heads), chunked parallel form).
//
// What it computes, per (batch b, head h), for t = 0 .. S-1:
//     o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
//     S_t = diag(w_t) S_{t-1} + k_t^T v_t
// from S_{-1} = s0 (zeros when no initial state is given), and returns the
// outputs and the final state S_{S-1}.  The TPU kernel does not return the
// state; the model's time mix carries it from prefill into decode.
//
// Bound on Hopper: device memory.  The function reads r, k, v, w once and
// writes out once (plus the hd x hd state per head): 20 bytes per element
// against about 7 flops per state entry per token, i.e. under 1 flop per
// byte at hd=64.  What actually bounds this simple kernel is latency: the
// recurrence is sequential in t, so one block walks all S tokens of its
// head, and only B*H blocks (40 at rwkv6-3b's batch 1) are in flight.
//
// Design (the published RWKV CUDA form): one block of hd threads per
// (b, h); thread e owns column e of the state, S[:, e], in hd registers.
// Each step stages r_t, k_t, w_t (read by every thread) in shared memory,
// double-buffered so one barrier per token suffices, and loads the next
// token's values into registers before it computes the current one, so
// the device-memory latency overlaps the hd-long inner loop.  Unlike the
// TPU kernel's chunk form, which divides by the cumulative decay
// (k * exp(-cumsum(log w))) and overflows fp32 for strong decays, this form
// only ever multiplies by w_t in (0, 1]: it stays finite for any decay.
#include <cuda_runtime.h>

template <int HD>
__global__ void __launch_bounds__(HD)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ out, float* __restrict__ s_fin, int H, int S) {
    __shared__ float su[HD];
    __shared__ float sbuf[2][3][HD];      // r, k, w of one token, two buffers
    const int bh = blockIdx.x;
    const int e = threadIdx.x;
    const size_t base = (size_t)bh * S * HD;
    const size_t sbase = (size_t)bh * HD * HD;

    float st[HD];                         // S[:, e]
#pragma unroll
    for (int i = 0; i < HD; ++i)
        st[i] = s0 ? s0[sbase + (size_t)i * HD + e] : 0.f;
    su[e] = u[(bh % H) * HD + e];

    float rn = 0.f, kn = 0.f, wn = 0.f, vn = 0.f;
    if (S > 0) {
        rn = r[base + e]; kn = k[base + e]; wn = w[base + e]; vn = v[base + e];
    }
    for (int t = 0; t < S; ++t) {
        const int b = t & 1;
        sbuf[b][0][e] = rn;
        sbuf[b][1][e] = kn;
        sbuf[b][2][e] = wn;
        const float ve = vn;
        if (t + 1 < S) {                  // next token, in flight meanwhile
            const size_t off = base + (size_t)(t + 1) * HD + e;
            rn = r[off]; kn = k[off]; wn = w[off]; vn = v[off];
        }
        __syncthreads();
        float o = 0.f;
#pragma unroll
        for (int i = 0; i < HD; ++i) {
            const float kv = sbuf[b][1][i] * ve;
            o = fmaf(sbuf[b][0][i], fmaf(su[i], kv, st[i]), o);
            st[i] = fmaf(st[i], sbuf[b][2][i], kv);
        }
        out[base + (size_t)t * HD + e] = o;
    }
#pragma unroll
    for (int i = 0; i < HD; ++i)
        s_fin[sbase + (size_t)i * HD + e] = st[i];
}

template <int HD>
static int launch(const void* r, const void* k, const void* v, const void* w,
                  const void* u, const void* s0, void* out, void* s_fin,
                  int B, int H, int S, void* stream) {
    wkv6_kernel<HD><<<B * H, HD, 0, (cudaStream_t)stream>>>(
        (const float*)r, (const float*)k, (const float*)v, (const float*)w,
        (const float*)u, (const float*)s0, (float*)out, (float*)s_fin, H, S);
    return (int)cudaGetLastError();
}

// s0 may be null (a zero initial state); hd is 16, 32, 64 or 128.
extern "C" int wkv6_f32(const void* r, const void* k, const void* v,
                        const void* w, const void* u, const void* s0,
                        void* out, void* s_fin, int B, int H, int S, int hd,
                        void* stream) {
    if (B < 1 || H < 1 || S < 0) return (int)cudaErrorInvalidValue;
    switch (hd) {
        case 16: return launch<16>(r, k, v, w, u, s0, out, s_fin, B, H, S, stream);
        case 32: return launch<32>(r, k, v, w, u, s0, out, s_fin, B, H, S, stream);
        case 64: return launch<64>(r, k, v, w, u, s0, out, s_fin, B, H, S, stream);
        case 128: return launch<128>(r, k, v, w, u, s0, out, s_fin, B, H, S, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" const char* repro_error_string(int e) {
    return cudaGetErrorString((cudaError_t)e);
}
