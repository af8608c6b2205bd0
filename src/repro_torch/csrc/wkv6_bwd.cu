// RWKV-6 (Finch) WKV recurrence, backward: the gradients of the sequence
// form's outputs and final state with respect to r, k, v, w, u and the
// initial state, reading the model layer's own views.
//
// Replaces no TPU kernel: the JAX package has no Pallas backward for WKV6;
// it differentiates its chunk form (src/repro/models/layers.py:527
// _wkv_chunk) with jax.grad.  This kernel is the backward of the card's
// forward (csrc/wkv6.cu), whose schedule never divides by a decay, on the
// "walk" route of kernels/wkv6.py (bwd_route: hd 16, 32 and 128); hd 64
// runs csrc/wkv6_bwd_tc.cu.
//
// What it computes, per (batch b, head h).  The forward is
//     o_t = r_t (S_t + diag(u) k_t^T v_t),  S_{t+1} = diag(w_t) S_t + k_t^T v_t,
// from S_0 = s0.  Given do_t and the final state's gradient ds_fin (zero
// when absent), with dS_T = ds_fin and, for t = T-1 .. 0,
//     dS_t  = diag(w_t) dS_{t+1} + r_t^T do_t
//     dr_t  = S_t do_t + u * k_t (v_t . do_t)
//     dk_t  = dS_{t+1} v_t + u * r_t (v_t . do_t)
//     dv_t  = dS_{t+1}^T k_t + (r_t . (u * k_t)) do_t
//     dw_t  = rowsum(dS_{t+1} * S_t)
//     du    = sum_{b, t} r_t * k_t (v_t . do_t),   ds0 = dS_0.
//
// Inputs: r, k, v, do (B, H, S, hd) in float32 or bfloat16 and w (B, H, S,
// hd) float32, each through its own (batch, head, token) element strides
// with the last dim unit-stride; u (H, hd), s0 and ds_fin (B, H, hd, hd)
// float32, contiguous and 16-byte aligned (either state may be null).
// Outputs dr, dk, dv in the inputs' type (rounded once from fp32) and dw
// float32, through their own strides; du (H, hd) and ds0 float32.
//
// Bound on Hopper: the fp32 CUDA cores.  Per state entry and token the
// backward does about 14 flops (the forward state rebuilt, dS updated, dr,
// dk, dv and dw), against 2-4 bytes a token of every hd-vector read or
// written: ~20 flops per byte at hd 64.
//
// dw_t needs S_t at the token where the reverse walk holds dS_{t+1}.  S_t
// cannot be recovered from S_{t+1} without dividing by w_t (the decays may
// be 1e-3), so states are rebuilt forward.  Four launches, chunks of C
// tokens (Tile<HD>::C):
//   1. in parallel over (b, h, chunk, {forward, reverse}): the chunk's own
//      state contribution from zero L_c = sum_t (prod_{t' > t} w_t') k_t^T
//      v_t and decay product P_c, or its reverse contribution G_c = sum_t
//      (prod_{t' < t} w_t') r_t^T do_t;
//   2. over chunks, in parallel over (b, h, state entries): the chunks'
//      starting states in order, S <- diag(P_c) S + L_c from s0, written
//      over L_c; the gradient at each chunk's end in reverse, dS <-
//      diag(P_c) dS + G_c from ds_fin, written over G_c; the last is ds0;
//   3. in parallel over (b, h, chunk): the chunk's walk.  The chunk's rows
//      of r, k, v, w and do are staged in shared memory once.  A first pass
//      from the chunk's starting state keeps the state at each segment's
//      start (every K tokens) in shared memory; then the segments are
//      taken last first, and in each, windows of W tokens last first: the
//      window's W states are rebuilt in registers from its segment's
//      checkpoint, and its tokens walked back with dS;
//   4. du: the (b, chunk) partials of step 3 summed in a fixed order.
// A thread of step 3 owns one row of the state (and of dS) over CT
// adjacent columns; the NCG lanes of a row are adjacent, so the row sums
// (dr, dk, dw) are shuffles within a warp; dv's column sums are shuffles
// over the warp's rows, then the warps' partials summed in order in shared
// memory.  Sums are reduce-scattered: each shuffle level halves the values
// a lane carries.  Everything multiplies by w in (0, 1] and products of it
// and nothing divides; no atomics, so each gradient is bitwise the same
// from call to call.  Per-token states never leave the SM: device memory
// sees O(tokens * hd + chunks * hd^2).
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

// per head dim: CT columns a thread owns in the walk, W tokens a window,
// K tokens a segment (the checkpoints' spacing), C tokens a chunk
template <int HD> struct Tile;
template <> struct Tile<16> { static constexpr int CT = 8, W = 8, K = 8, C = 64; };
template <> struct Tile<32> { static constexpr int CT = 8, W = 8, K = 8, C = 64; };
template <> struct Tile<128> { static constexpr int CT = 32, W = 1, K = 16, C = 32; };

// the walk's threads: one per (row, column group)
template <int HD> constexpr int WALK_NT = HD * (HD / Tile<HD>::CT);
// tokens a block of step 1 stages at a time
template <int HD> constexpr int SUB = 16;

template <int N> constexpr int LOG2 = 1 + LOG2<N / 2>;
template <> constexpr int LOG2<1> = 0;

struct Views {                 // element strides (batch, head, token)
    long long r[3], k[3], v[3], w[3], d[3], dr[3], dk[3], dv[3], dw[3];
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// stage ROWS rows of a (token, hd) view into shared memory as fp32 (rows
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

template <typename T, int HD, int NT, int ROWS>
__device__ __forceinline__ void stage(float* dst, const T* src, long long ts,
                                      int n) {
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

// Sums c[] over the lanes whose indices differ in the bits HI, HI/2, ...,
// LO.  While a lane carries more than one value, a level halves them: the
// lane keeps the half its bit selects and adds its partner's copy of that
// half; once one is left, a level adds the partner's.  Returns the index of
// the first value the lane keeps: c[0 .. RS_KEPT) are the sums of values
// first + [0, RS_KEPT).  Lanes that differ only in the bits RS_DUP hold the
// same sums.
template <int N, int HI, int LO> constexpr int RS_HALVINGS =
    LOG2<N> < LOG2<HI> - LOG2<LO> + 1 ? LOG2<N> : LOG2<HI> - LOG2<LO> + 1;
template <int N, int HI, int LO> constexpr int RS_KEPT = N >> RS_HALVINGS<N, HI, LO>;
template <int N, int HI, int LO> constexpr int RS_DUP =
    LO * ((1 << (LOG2<HI> - LOG2<LO> + 1 - RS_HALVINGS<N, HI, LO>)) - 1);

template <int N, int HI, int LO>
__device__ __forceinline__ int reduce_scatter(float (&c)[N], int lane) {
    int first = 0;
    int n = N;
#pragma unroll
    for (int off = HI; off >= LO; off >>= 1) {
        if (n > 1) {
            const int half = n / 2;
            const bool up = lane & off;
#pragma unroll
            for (int x = 0; x < N / 2; ++x) {
                if (x < half) {
                    const float keep = up ? c[x + half] : c[x];
                    const float give = up ? c[x] : c[x + half];
                    c[x] = keep + __shfl_xor_sync(0xffffffffu, give, off);
                }
            }
            if (up) first += half;
            n = half;
        } else {
            c[0] += __shfl_xor_sync(0xffffffffu, c[0], off);
        }
    }
    return first;
}

// ---------------------------------------------------------------------------
// 1: L_c and P_c (blockIdx.z == 0) or G_c (blockIdx.z == 1) of every chunk
// ---------------------------------------------------------------------------

// into Ls / Gs (B*H, nc, HD, HD) and Ps (B*H, nc, HD); a thread owns a 4 x 4
// piece (4 rows, 4 neighbouring columns)
template <typename T, int HD>
__global__ void __launch_bounds__(HD * HD / 16)
wkv6_bwd_local_kernel(const T* __restrict__ r, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ w,
                      const T* __restrict__ d, float* __restrict__ Ls,
                      float* __restrict__ Gs, float* __restrict__ Ps, Views vw,
                      int H, int S, int C) {
    constexpr int NCG = HD / 4, NT = HD * HD / 16, ROWS = SUB<HD>;
    __shared__ __align__(16) float sa[ROWS * HD], sb[ROWS * HD], sw[ROWS * HD];
    const int c = blockIdx.x, nc = gridDim.x, bh = blockIdx.y;
    const int b = bh / H, h = bh % H;
    const bool rev = blockIdx.z == 1;    // G_c from r and do, else L_c from k, v
    const T* a = rev ? r : k;
    const T* bb = rev ? d : v;
    const long long a0 = rev ? vw.r[0] : vw.k[0], a1 = rev ? vw.r[1] : vw.k[1],
                    a2 = rev ? vw.r[2] : vw.k[2];
    const long long b0 = rev ? vw.d[0] : vw.v[0], b1 = rev ? vw.d[1] : vw.v[1],
                    b2 = rev ? vw.d[2] : vw.v[2];
    const int t0 = c * C, n = min(C, S - t0);
    const int e0 = 4 * (threadIdx.x % NCG), i0 = 4 * (threadIdx.x / NCG);
    float A[4][4], P[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        P[j] = 1.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) A[j][e] = 0.f;
    }
    for (int t1 = 0; t1 < n; t1 += ROWS) {
        const int m = min(ROWS, n - t1), ta = t0 + t1;
        __syncthreads();                 // the previous rows are consumed
        stage<T, HD, NT, ROWS>(sa, a + b * a0 + h * a1 + ta * a2, a2, m);
        stage<T, HD, NT, ROWS>(sb, bb + b * b0 + h * b1 + ta * b2, b2, m);
        stage<float, HD, NT, ROWS>(sw, w + b * vw.w[0] + h * vw.w[1] + ta * vw.w[2],
                                   vw.w[2], m);
        __syncthreads();
        for (int tt = 0; tt < m; ++tt) {
            float aa[4], ww[4], bv[4];
            unpack(sa + tt * HD + i0, aa);
            unpack(sw + tt * HD + i0, ww);
            unpack(sb + tt * HD + e0, bv);
            if (rev) {
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const float pa = P[j] * aa[j];
#pragma unroll
                    for (int e = 0; e < 4; ++e) A[j][e] = fmaf(pa, bv[e], A[j][e]);
                    P[j] *= ww[j];
                }
            } else {
#pragma unroll
                for (int j = 0; j < 4; ++j) {
#pragma unroll
                    for (int e = 0; e < 4; ++e) A[j][e] = fmaf(A[j][e], ww[j], aa[j] * bv[e]);
                    P[j] *= ww[j];
                }
            }
        }
    }
    const size_t cb = (size_t)bh * nc + c;
    float* out = rev ? Gs : Ls;
#pragma unroll
    for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float4*>(out + cb * HD * HD + (i0 + j) * HD + e0) =
            make_float4(A[j][0], A[j][1], A[j][2], A[j][3]);
    if (!rev && e0 == 0)
        *reinterpret_cast<float4*>(Ps + cb * HD + i0) = make_float4(P[0], P[1], P[2], P[3]);
}

// ---------------------------------------------------------------------------
// 2: the chunks' starting states over L_c, the gradients at their ends over
// G_c, and ds0
// ---------------------------------------------------------------------------

__device__ __forceinline__ float4 decay_add(float p, float4 s, float4 l) {
    return make_float4(fmaf(p, s.x, l.x), fmaf(p, s.y, l.y), fmaf(p, s.z, l.z),
                       fmaf(p, s.w, l.w));
}

// one thread per 4 neighbouring entries of a head's state; each chunk's L
// (G) and P loaded AHEAD at a time before they are used
template <int HD>
__global__ void __launch_bounds__(256)
wkv6_bwd_scan_kernel(float* __restrict__ Ls, float* __restrict__ Gs,
                     const float* __restrict__ Ps, const float* s0,
                     const float* ds_fin, float* __restrict__ ds0, int nc,
                     int BH) {
    constexpr int Q4 = HD * HD / 4, AHEAD = 8;
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    if (x >= BH * Q4) return;
    const int bh = x / Q4, off = (x % Q4) * 4, i = off / HD;
    const size_t sb = (size_t)bh * HD * HD + off;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s0) s = *reinterpret_cast<const float4*>(s0 + sb);
    for (int c0 = 0; c0 < nc; c0 += AHEAD) {
        float4 Lc[AHEAD];
        float Pc[AHEAD];
#pragma unroll
        for (int q = 0; q < AHEAD; ++q)
            if (c0 + q < nc) {
                const size_t cb = (size_t)bh * nc + c0 + q;
                Lc[q] = *reinterpret_cast<const float4*>(Ls + cb * HD * HD + off);
                Pc[q] = Ps[cb * HD + i];
            }
#pragma unroll
        for (int q = 0; q < AHEAD; ++q)
            if (c0 + q < nc) {
                const size_t cb = (size_t)bh * nc + c0 + q;
                *reinterpret_cast<float4*>(Ls + cb * HD * HD + off) = s;
                s = decay_add(Pc[q], s, Lc[q]);
            }
    }
    float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ds_fin) g = *reinterpret_cast<const float4*>(ds_fin + sb);
    for (int c0 = nc - 1; c0 >= 0; c0 -= AHEAD) {
        float4 Gc[AHEAD];
        float Pc[AHEAD];
#pragma unroll
        for (int q = 0; q < AHEAD; ++q)
            if (c0 - q >= 0) {
                const size_t cb = (size_t)bh * nc + c0 - q;
                Gc[q] = *reinterpret_cast<const float4*>(Gs + cb * HD * HD + off);
                Pc[q] = Ps[cb * HD + i];
            }
#pragma unroll
        for (int q = 0; q < AHEAD; ++q)
            if (c0 - q >= 0) {
                const size_t cb = (size_t)bh * nc + c0 - q;
                *reinterpret_cast<float4*>(Gs + cb * HD * HD + off) = g;
                g = decay_add(Pc[q], g, Gc[q]);
            }
    }
    *reinterpret_cast<float4*>(ds0 + sb) = g;
}

// ---------------------------------------------------------------------------
// 3: each chunk walked back
// ---------------------------------------------------------------------------

// the state's row i over CT columns one token on: S <- w_i S + k_i v
template <int HD, int CT>
__device__ __forceinline__ void step(float (&s)[CT], const float* sk,
                                     const float* sv, const float* sw, int tt,
                                     int i, int e0) {
    const float kk = sk[tt * HD + i], ww = sw[tt * HD + i];
#pragma unroll
    for (int x = 0; x < CT; x += 4) {
        float vv[4];
        unpack(sv + tt * HD + e0 + x, vv);
#pragma unroll
        for (int y = 0; y < 4; ++y) s[x + y] = fmaf(s[x + y], ww, kk * vv[y]);
    }
}

template <int CT>
__device__ __forceinline__ void load_row(float (&s)[CT], const float* p) {
#pragma unroll
    for (int x = 0; x < CT; x += 4) {
        float q[4];
        unpack(p + x, q);
#pragma unroll
        for (int y = 0; y < 4; ++y) s[x + y] = q[y];
    }
}

template <int HD>
constexpr size_t WALK_SMEM = sizeof(float) * (
    (size_t)(Tile<HD>::C / Tile<HD>::K - 1) * HD * HD   // checkpoints
    + 5 * Tile<HD>::C * HD                              // r, k, v, w, do rows
    + (WALK_NT<HD> / 32) * Tile<HD>::W * HD             // dv partials
    + 2 * Tile<HD>::C);                                 // v.do, r.(u k)

// The chunk's rows are staged once; the checkpoints are each thread's own
// entries (no barrier between writing and reading them); the one exchange
// between warps, dv's partials, costs two barriers a window.
template <typename T, int HD>
__global__ void __launch_bounds__(WALK_NT<HD>, 1)
wkv6_bwd_walk_kernel(const T* __restrict__ r, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ w,
                     const T* __restrict__ d, const float* __restrict__ u,
                     const float* __restrict__ starts,
                     const float* __restrict__ ends, T* __restrict__ dr,
                     T* __restrict__ dk, T* __restrict__ dv,
                     float* __restrict__ dw, float* __restrict__ du_part,
                     Views vw, int H, int S) {
    constexpr int CT = Tile<HD>::CT, W = Tile<HD>::W, K = Tile<HD>::K,
                  C = Tile<HD>::C, NCG = HD / CT, NT = WALK_NT<HD>,
                  NW = NT / 32, RPW = 32 / NCG, NCK = C / K - 1;
    // row sums over a row's NCG lanes; column sums over a warp's RPW rows
    constexpr int QK = RS_KEPT<4, NCG / 2, 1>, QD = RS_DUP<4, NCG / 2, 1>;
    constexpr int VK = RS_KEPT<CT, 16, NCG>, VD = RS_DUP<CT, 16, NCG>;
    extern __shared__ __align__(16) float smem[];
    float* ck = smem;                              // [NCK][CT][NT]
    float* sr = ck + NCK * HD * HD;                // [C][HD] each
    float* sk = sr + C * HD;
    float* sv = sk + C * HD;
    float* sw = sv + C * HD;
    float* sd = sw + C * HD;
    float* part = sd + C * HD;                     // [NW][W][HD]
    float* svd = part + NW * W * HD;               // [C]
    float* srk = svd + C;                          // [C]
    const int c = blockIdx.x, nc = gridDim.x, bh = blockIdx.y;
    const int b = bh / H, h = bh % H;
    const int t0 = c * C, n = min(C, S - t0);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int cg = lane % NCG, i = warp * RPW + lane / NCG, e0 = cg * CT;
    const float ui = u[h * HD + i];
    const size_t own = ((size_t)bh * nc + c) * HD * HD + (size_t)i * HD + e0;
    stage<T, HD, NT, C>(sr, r + b * vw.r[0] + h * vw.r[1] + t0 * vw.r[2], vw.r[2], n);
    stage<T, HD, NT, C>(sk, k + b * vw.k[0] + h * vw.k[1] + t0 * vw.k[2], vw.k[2], n);
    stage<T, HD, NT, C>(sv, v + b * vw.v[0] + h * vw.v[1] + t0 * vw.v[2], vw.v[2], n);
    stage<float, HD, NT, C>(sw, w + b * vw.w[0] + h * vw.w[1] + t0 * vw.w[2], vw.w[2], n);
    stage<T, HD, NT, C>(sd, d + b * vw.d[0] + h * vw.d[1] + t0 * vw.d[2], vw.d[2], n);
    __syncthreads();
    // each token's v.do and r.(u k), a warp a token
    for (int tt = warp; tt < n; tt += NW) {
        float vd = 0.f, rk = 0.f;
        for (int x = lane; x < HD; x += 32) {
            vd = fmaf(sv[tt * HD + x], sd[tt * HD + x], vd);
            rk = fmaf(sr[tt * HD + x] * u[h * HD + x], sk[tt * HD + x], rk);
        }
#pragma unroll
        for (int off = 16; off >= 1; off >>= 1) {
            vd += __shfl_xor_sync(0xffffffffu, vd, off);
            rk += __shfl_xor_sync(0xffffffffu, rk, off);
        }
        if (lane == 0) {
            svd[tt] = vd;
            srk[tt] = rk;
        }
    }
    // the state at the start of every segment after the first, in this
    // thread's own slots
    const int nseg = (n + K - 1) / K;
    float s[CT];
    load_row(s, starts + own);
    for (int sg = 0; sg + 1 < nseg; ++sg) {
        for (int tt = sg * K; tt < (sg + 1) * K; ++tt)
            step<HD, CT>(s, sk, sv, sw, tt, i, e0);
#pragma unroll
        for (int x = 0; x < CT; ++x) ck[(sg * CT + x) * NT + tid] = s[x];
    }
    __syncthreads();                     // svd and srk are written

    float dS[CT];
    load_row(dS, ends + own);
    float du_acc = 0.f;
    T* drp = dr + b * vw.dr[0] + h * vw.dr[1];
    T* dkp = dk + b * vw.dk[0] + h * vw.dk[1];
    T* dvp = dv + b * vw.dv[0] + h * vw.dv[1];
    float* dwp = dw + b * vw.dw[0] + h * vw.dw[1];
    for (int sg = nseg - 1; sg >= 0; --sg) {
        const int a = sg * K, m = min(K, n - a);   // the segment's tokens
        for (int j0 = ((m - 1) / W) * W; j0 >= 0; j0 -= W) {
            // the window's states, rebuilt from its segment's start
            if (sg == 0) {
                load_row(s, starts + own);
            } else {
#pragma unroll
                for (int x = 0; x < CT; ++x) s[x] = ck[((sg - 1) * CT + x) * NT + tid];
            }
            for (int tt = a; tt < a + j0; ++tt) step<HD, CT>(s, sk, sv, sw, tt, i, e0);
            float win[W][CT];
#pragma unroll
            for (int j = 0; j < W; ++j) {
#pragma unroll
                for (int x = 0; x < CT; ++x) win[j][x] = s[x];
                if (j + 1 < W && j0 + j < m) step<HD, CT>(s, sk, sv, sw, a + j0 + j, i, e0);
            }
#pragma unroll
            for (int j = W - 1; j >= 0; --j) {
                if (j0 + j >= m) continue;   // the same for every thread
                const int tt = a + j0 + j;
                const float rr = sr[tt * HD + i], kk = sk[tt * HD + i],
                            ww = sw[tt * HD + i], vd = svd[tt];
                float q[4] = {0.f, 0.f, 0.f, 0.f}, cc[CT];
#pragma unroll
                for (int x = 0; x < CT; x += 4) {
                    float vv[4], dd[4];
                    unpack(sv + tt * HD + e0 + x, vv);
                    unpack(sd + tt * HD + e0 + x, dd);
#pragma unroll
                    for (int y = 0; y < 4; ++y) {
                        const float g = dS[x + y], sx = win[j][x + y];
                        q[0] = fmaf(sx, dd[y], q[0]);        // (S_t do_t)_i
                        q[1] = fmaf(g, vv[y], q[1]);         // (dS_{t+1} v_t)_i
                        q[2] = fmaf(g, sx, q[2]);            // dw_t[i]
                        cc[x + y] = g * kk;                  // dS_{t+1}^T k_t
                        dS[x + y] = fmaf(g, ww, rr * dd[y]); // dS_t
                    }
                }
                const long long tg = t0 + tt;
                const int qf = reduce_scatter<4, NCG / 2, 1>(q, lane);
                if ((lane & QD) == 0) {
#pragma unroll
                    for (int x = 0; x < QK; ++x) {
                        const int which = qf + x;
                        if (which == 0)
                            st(drp + tg * vw.dr[2] + i, fmaf(ui * kk, vd, q[x]));
                        else if (which == 1)
                            st(dkp + tg * vw.dk[2] + i, fmaf(ui * rr, vd, q[x]));
                        else if (which == 2)
                            dwp[tg * vw.dw[2] + i] = q[x];
                    }
                }
                const int vf = reduce_scatter<CT, 16, NCG>(cc, lane);
                if ((lane & VD) == 0) {
#pragma unroll
                    for (int x = 0; x < VK; ++x)
                        part[(warp * W + j) * HD + e0 + vf + x] = cc[x];
                }
                du_acc = fmaf(rr * kk, vd, du_acc);
            }
            __syncthreads();
            // dv of the window's tokens: the warps' partials in order, and
            // the bonus term
            for (int x = tid; x < W * HD; x += NT) {
                const int j = x / HD, e = x % HD;
                if (j0 + j < m) {
                    const int tt = a + j0 + j;
                    float acc = 0.f;
#pragma unroll
                    for (int q = 0; q < NW; ++q) acc += part[(q * W + j) * HD + e];
                    st(dvp + (t0 + tt) * vw.dv[2] + e,
                       fmaf(srk[tt], sd[tt * HD + e], acc));
                }
            }
            __syncthreads();             // the partials are consumed
        }
    }
    if (cg == 0) du_part[((size_t)bh * nc + c) * HD + i] = du_acc;
}

// ---------------------------------------------------------------------------
// 4: du, the partials of every (batch, chunk) summed in order
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(128)
wkv6_bwd_du_kernel(const float* __restrict__ part, float* __restrict__ du,
                   int B, int H, int nc) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    if (x >= H * HD) return;
    const int h = x / HD, i = x % HD;
    float acc = 0.f;
    for (int b = 0; b < B; ++b)
        for (int c = 0; c < nc; ++c)
            acc += part[(((size_t)b * H + h) * nc + c) * HD + i];
    du[x] = acc;
}

template <typename T, int HD>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, const void* d, const void* ds_fin,
           void* dr, void* dk, void* dv, void* dw, void* du, void* ds0,
           void* Ls, void* Gs, void* Ps, void* du_part, const Views& vw,
           int B, int H, int S, cudaStream_t stream) {
    constexpr int C = Tile<HD>::C;
    const int nc = (S + C - 1) / C;
    cudaError_t err;
    wkv6_bwd_local_kernel<T, HD><<<dim3(nc, B * H, 2), HD * HD / 16, 0, stream>>>(
        (const T*)r, (const T*)k, (const T*)v, (const float*)w, (const T*)d,
        (float*)Ls, (float*)Gs, (float*)Ps, vw, H, S, C);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const int n4 = B * H * HD * HD / 4;
    wkv6_bwd_scan_kernel<HD><<<(n4 + 255) / 256, 256, 0, stream>>>(
        (float*)Ls, (float*)Gs, (const float*)Ps, (const float*)s0,
        (const float*)ds_fin, (float*)ds0, nc, B * H);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    constexpr size_t smem = WALK_SMEM<HD>;
    if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(wkv6_bwd_walk_kernel<T, HD>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    wkv6_bwd_walk_kernel<T, HD><<<dim3(nc, B * H), WALK_NT<HD>, smem, stream>>>(
        (const T*)r, (const T*)k, (const T*)v, (const float*)w, (const T*)d,
        (const float*)u, (const float*)Ls, (const float*)Gs, (T*)dr, (T*)dk,
        (T*)dv, (float*)dw, (float*)du_part, vw, H, S);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    wkv6_bwd_du_kernel<HD><<<(H * HD + 127) / 128, 128, 0, stream>>>(
        (const float*)du_part, (float*)du, B, H, nc);
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* s0, const void* d, const void* ds_fin,
             void* dr, void* dk, void* dv, void* dw, void* du, void* ds0,
             void* Ls, void* Gs, void* Ps, void* du_part,
             const long long* strides, int B, int H, int S, int hd, int C,
             void* stream) {
    if (B < 1 || H < 1 || S < 1) return (int)cudaErrorInvalidValue;
    Views vw;
    long long* dst[9] = {vw.r, vw.k, vw.v, vw.w, vw.d, vw.dr, vw.dk, vw.dv, vw.dw};
    for (int a = 0; a < 9; ++a)
        for (int i = 0; i < 3; ++i) dst[a][i] = strides[3 * a + i];
    cudaStream_t s = (cudaStream_t)stream;
#define WKV6_BWD_HD(N)                                                          \
    case N:                                                                     \
        if (C != Tile<N>::C) return (int)cudaErrorInvalidValue;                 \
        return launch<T, N>(r, k, v, w, u, s0, d, ds_fin, dr, dk, dv, dw, du,   \
                            ds0, Ls, Gs, Ps, du_part, vw, B, H, S, s);
    switch (hd) {
        WKV6_BWD_HD(16)
        WKV6_BWD_HD(32)
        WKV6_BWD_HD(128)
        default: return (int)cudaErrorInvalidValue;
    }
#undef WKV6_BWD_HD
}

}  // namespace

// r, k, v, do and dr, dk, dv in float32 (wkv6_bwd_f32) or bfloat16
// (wkv6_bwd_bf16); w, u, s0, ds_fin, dw, du, ds0 float32.  strides: 27
// element strides, (batch, head, token) of r, k, v, w, do, dr, dk, dv, dw.
// s0 and ds_fin may be null (zeros).  C is the chunk (Tile<hd>::C, else an
// invalid-value error); scratch: Ls and Gs (B*H*nc*hd*hd), Ps and du_part
// (B*H*nc*hd) float32, nc = ceil(S / C).  hd is 16, 32 or 128 (hd 64 runs
// csrc/wkv6_bwd_tc.cu).  Four launches.
extern "C" int wkv6_bwd_f32(const void* r, const void* k, const void* v,
                            const void* w, const void* u, const void* s0,
                            const void* d, const void* ds_fin, void* dr,
                            void* dk, void* dv, void* dw, void* du, void* ds0,
                            void* Ls, void* Gs, void* Ps, void* du_part,
                            const long long* strides, int B, int H, int S,
                            int hd, int C, void* stream) {
    return dispatch<float>(r, k, v, w, u, s0, d, ds_fin, dr, dk, dv, dw, du,
                           ds0, Ls, Gs, Ps, du_part, strides, B, H, S, hd, C,
                           stream);
}

extern "C" int wkv6_bwd_bf16(const void* r, const void* k, const void* v,
                             const void* w, const void* u, const void* s0,
                             const void* d, const void* ds_fin, void* dr,
                             void* dk, void* dv, void* dw, void* du, void* ds0,
                             void* Ls, void* Gs, void* Ps, void* du_part,
                             const long long* strides, int B, int H, int S,
                             int hd, int C, void* stream) {
    return dispatch<__nv_bfloat16>(r, k, v, w, u, s0, d, ds_fin, dr, dk, dv,
                                   dw, du, ds0, Ls, Gs, Ps, du_part, strides, B,
                                   H, S, hd, C, stream);
}

extern "C" const char* repro_error_string(int e) {
    return cudaGetErrorString((cudaError_t)e);
}
