// RWKV-6 (Finch) WKV recurrence, backward at head dims 16, 32, 64 and 128,
// with the products across each window of a chunk on the tensor cores: the
// gradients of the sequence form's outputs and final state with respect to
// r, k, v, w, u and the initial state, reading the model layer's own views.
//
// Replaces no TPU kernel: the JAX package has no Pallas backward for WKV6;
// it differentiates its chunk form (src/repro/models/layers.py:527
// _wkv_chunk) with jax.grad.  This kernel is the backward of the card's
// forward (csrc/wkv6.cu) at every head dim kernels/wkv6.py takes.
//
// What it computes, per (batch b, head h): with the forward o_t = r_t (S_t
// + diag(u) k_t^T v_t), S_{t+1} = diag(w_t) S_t + k_t^T v_t from S_0 = s0,
// and dS_T = ds_fin,
//     dS_t  = diag(w_t) dS_{t+1} + r_t^T do_t
//     dr_t  = S_t do_t + u * k_t (v_t . do_t)
//     dk_t  = dS_{t+1} v_t + u * r_t (v_t . do_t)
//     dv_t  = dS_{t+1}^T k_t + (r_t . (u * k_t)) do_t
//     dw_t  = rowsum(dS_{t+1} * S_t)
//     du    = sum_{b, t} r_t * k_t (v_t . do_t),   ds0 = dS_0.
//
// Bound on Hopper: per state entry and token a per-token walk does about
// 14 flops, which on the fp32 CUDA cores take twice the time of the bytes
// at rwkv6-3b's training shape (2, 40, 2048, 64), and four times at hd 128.
// In three TF32 passes on the tensor cores the same flops take less than
// the bytes at hd 16-64, and 1.6x them at hd 128.  So no head dim walks the
// hd^2 work token by token: it goes on the tensor cores.
//
// The window form.  A chunk of C tokens (its starting state and end
// gradient from launches 1-2) is cut into NWIN windows [a, e) of W = 16
// tokens.  With A_t = prod_{a<=m<t} w_m, B_t = prod_{t<m<e} w_m, D(t, s) =
// prod_{t<m<s} w_m (all products of decays: nothing divides, no exp of a
// negative cumulative log-decay), S_a the window's starting state and dS_e
// its end gradient:
//   on the tensor cores (3xTF32): Qr = dO S_a^T, Pk = V dS_e^T, Pv = (K B)
//     dS_e, c = V dO^T, the rank-W updates S_e = diag(A_e) S_a + (K B)^T V
//     and dS_a = diag(A_e) dS_e + (R A)^T dO, and at the end dv = Pv + Q
//     dO;
//   on the CUDA cores, a lane pair a row i of a window, token by token with
//     Sdo_t(s) = (S_t do_s)_i (Sdo_0 = Qr, Sdo_{t+1}(s) = w_t Sdo_t(s) + k_t
//     c_ts) and Ge_t = rowsum(dS_e * S_t)_i (Ge_0 = rowsum(dS_e * S_a),
//     Ge_{t+1} = w_t Ge_t + k_t Pk_t):
//       dr_t = Sdo_t(t) + u k_t c_tt
//       dk_t = B_t Pk_t + sum_{s>t} D(t,s) r_s c_ts + u r_t c_tt
//       dw_t = B_t Ge_t + sum_{s>t} D(t,s) r_s Sdo_t(s)
//       q_ts = sum_i D(t,s) r_s k_t (s > t), q_tt = sum_i u r_t k_t,
//     the lanes of a pair taking the tokens s of one parity each (D(t, s)
//     stepping by w_s w_{s+1}), q's rows reduced by shuffles within a warp,
//     then its window's warps in order.
// The per-token hd^2 work becomes matrix products with M = 16 or hd; what
// stays on the CUDA cores is O(W hd) a token, recurrences that multiply by
// w only.  The chunk's rows are read from device memory once, the
// gradients staged in shared memory and written 16 bytes a store, and
// per-token states never leave the SM.
//
// Two walks (launch 3), by head dim (Cfg below):
//  * hd 16, 32, 64: one block a chunk of C = 64 tokens, 2 NWIN hd threads.
//    It holds the starts of windows 1-3 (made by one half of the warps
//    while the other forms the first windows' Qr) and carries dS back from
//    the chunk's end.  At hd 64 a block takes the SM's 227 KB; at hd 32
//    (104 KB) two blocks share an SM, at hd 16 (55 KB) four, so one block's
//    loads overlap another's products and row recurrences.
//  * hd 128: the whole state does not fit (at C = 64 the rows take 169 KB,
//    four window states 270 KB).  A column j of the state never mixes with
//    another in S_{t+1} = diag(w_t) S_t + k_t^T v_t or in dS, so a cluster
//    of NR = 2 CTAs (__cluster_dims__) takes a chunk of C = 32 tokens, each
//    CTA the columns [j0, j0 + hd/2) of S and dS and its halves of v and
//    do, and r, k, w whole.  Every sum over j is then a partial in each
//    CTA: Qr, Pk, c and rowsum(dS_e * S_a) (v . do is c's diagonal).  The
//    CTAs read each other's partials through distributed shared memory once
//    the windows are done and add them rank 0 first, never atomically; the
//    per-row walk's rows are split between them (rank r takes rows [r hd/2,
//    (r + 1) hd/2)), so Q, the sum of their q partials, is read across the
//    cluster the same way; dv's columns are each CTA's own.  One window
//    start is held: window 1's is made over the chunk's, which is read again
//    from device memory (L2) for window 0.
//
// mma.sync, not wgmma: TF32 wgmma takes both operands K-major from shared
// memory, and three of the products read the rows or the state transposed
// ((K B)^T V, (R A)^T dO, (K B) dS_e); mma.sync's fragments are loaded by
// each lane from the one layout the rows are staged in.
//
// 3xTF32: an fp32 operand x is split into hi = x rounded to TF32 and lo =
// x - hi rounded; a product is lo*hi + hi*lo + hi*hi, each pass into its
// own accumulator.  A bf16 input widened to fp32 is exact in TF32: it goes
// in as it is and its lo pass is left out.
//
// Four launches: the chunks' local L_c = (K B)^T V, G_c = (R A)^T dO (on
// the tensor cores) and decay products, the scan of chunk boundaries
// (starts forward and end gradients back in threads of their own, writing
// ds0), the walk, and du's partials summed in order.  No atomics: each
// gradient is bitwise the same from call to call.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int W = 16;                   // tokens a window

// The schedule at each head dim.  NR CTAs of a cluster split the state's
// columns (1: no cluster); a CTA holds HH = HD / NR of them, and its walk
// takes HH rows of the per-row recurrences.
template <int HD> struct Cfg {
    static constexpr int NR = HD > 64 ? 2 : 1;
    static constexpr int C = HD > 64 ? 32 : 64;   // tokens a chunk
    static constexpr int NWIN = C / W;
    static constexpr int HH = HD / NR;
    static constexpr int SR = HD + 4;    // row stride (floats) of r, k, w
    static constexpr int SH = HH + 4;    // of v, do and the state's rows
    static constexpr int ROWS = C * SR;  // a chunk's (C, HD) rows
    static constexpr int STATE = HD * SH;          // a CTA's (HD, HH) state
    static constexpr int NT = NWIN * HD;           // step 1: (window, row)
    static constexpr int LW = HD > 64 ? 32 : HD;   // step 1's columns a block
    static constexpr int WT = 2 * NWIN * HH;       // the walk: (window, row, parity)
    static constexpr int NWARP = WT / 32;
    // walk blocks an SM that shared memory allows (launch bounds)
    static constexpr int MINB = HD == 16 ? 4 : HD == 32 ? 2 : 1;
};

template <int N> constexpr int LOG2 = 1 + LOG2<N / 2>;
template <> constexpr int LOG2<1> = 0;

struct Views {                 // element strides (batch, head, token)
    long long r[3], k[3], v[3], w[3], d[3], dr[3], dk[3], dv[3], dw[3];
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

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

// Sums c[] over the lanes whose indices differ in the bits HI, HI/2, ...,
// LO.  While a lane carries more than one value, a level halves them: the
// lane keeps the half its bit selects and adds its partner's copy of that
// half; once one is left, a level adds the partner's.  Returns the index of
// the first value the lane keeps: c[0 .. N >> RS_HALVINGS) are the sums of
// values first + [0, N >> RS_HALVINGS).  Lanes that differ only in the bits
// RS_DUP hold the same sums.
template <int N, int HI, int LO> constexpr int RS_HALVINGS =
    LOG2<N> < LOG2<HI> - LOG2<LO> + 1 ? LOG2<N> : LOG2<HI> - LOG2<LO> + 1;
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
// tensor cores: mma.sync m16n8k8 in 3xTF32
// ---------------------------------------------------------------------------

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

// An operand whose values TF32 holds exactly (a bf16 input widened to fp32)
// goes to the tensor cores as it is, and its lo pass is left out: EX below.

// the A fragment (16 x 8 at k-step k0) of A(m, k), split unless EX
template <bool EX, class FA>
__device__ __forceinline__ void frag_a(uint32_t (&ah)[4], uint32_t (&al)[4], const FA& A,
                                       int k0, int g, int tg) {
    const float x[4] = {A(g, k0 + tg), A(g + 8, k0 + tg), A(g, k0 + tg + 4),
                        A(g + 8, k0 + tg + 4)};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        if (EX) ah[e] = __float_as_uint(x[e]);
        else split(x[e], ah[e], al[e]);
    }
}

// the B fragment (8 x 8 at k-step k0, columns n0) of B(k, n), split unless
// EX
template <bool EX, class FB>
__device__ __forceinline__ void frag_b(uint32_t (&bh)[2], uint32_t (&bl)[2], const FB& B,
                                       int k0, int n0, int g, int tg) {
    const float x[2] = {B(k0 + tg, n0 + g), B(k0 + tg + 4, n0 + g)};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
        if (EX) bh[e] = __float_as_uint(x[e]);
        else split(x[e], bh[e], bl[e]);
    }
}

// one k-step of 3xTF32: the passes into three accumulators (lo*hi, hi*lo,
// hi*hi), so that no pass waits on another; an exact operand's lo pass is
// left out
template <bool EXA, bool EXB>
__device__ __forceinline__ void mma_x3(float (&c)[3][4], const uint32_t (&ah)[4],
                                       const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                       const uint32_t (&bl)[2]) {
    if (!EXA) mma_tf32(c[0], al, bh);
    if (!EXB) mma_tf32(c[1], ah, bl);
    mma_tf32(c[2], ah, bh);
}

// the sum of the three passes, the small ones first
__device__ __forceinline__ void fold_x3(float (&out)[4], const float (&c)[3][4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) out[e] = c[2][e] + (c[0][e] + c[1][e]);
}

// c[nt] (16 x 8, n-tile nt) += A B over K = 8 KS: A(m, k) and B(k, n) read
// an element (m < 16, k < 8 KS, n < 8 NTL).  The accumulator layout: c[nt]
// holds (g, 8 nt + 2 tg), (g, + 1), (g + 8, 8 nt + 2 tg), (g + 8, + 1) for
// lane 4 g + tg.
template <int KS, int NTL, bool EXA, bool EXB, class FA, class FB>
__device__ __forceinline__ void mma3(float (&c)[NTL][4], const FA& A, const FB& B,
                                     int lane) {
    const int g = lane >> 2, tg = lane & 3;
    float acc[NTL][3][4];
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            acc[nt][0][e] = 0.f;
            acc[nt][1][e] = 0.f;
            acc[nt][2][e] = c[nt][e];
        }
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
        uint32_t ah[4], al[4];
        frag_a<EXA>(ah, al, A, 8 * ks, g, tg);
#pragma unroll
        for (int nt = 0; nt < NTL; ++nt) {
            uint32_t bh[2], bl[2];
            frag_b<EXB>(bh, bl, B, 8 * ks, 8 * nt, g, tg);
            mma_x3<EXA, EXB>(acc[nt], ah, al, bh, bl);
        }
    }
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt) fold_x3(c[nt], acc[nt]);
}

// a 16 x 8 accumulator tile into a row-major array at row stride ld
__device__ __forceinline__ void store_tile(float* o, int ld, const float (&c)[4], int lane) {
    const int g = lane >> 2, tg = lane & 3;
    o[g * ld + 2 * tg] = c[0];
    o[g * ld + 2 * tg + 1] = c[1];
    o[(g + 8) * ld + 2 * tg] = c[2];
    o[(g + 8) * ld + 2 * tg + 1] = c[3];
}

// ---------------------------------------------------------------------------
// staging: a chunk's rows and states into shared memory
// ---------------------------------------------------------------------------

// NROW rows of WIDTH elements of a (token, .) view: load() puts a thread's
// share in registers, 4 elements a load, every load of the thread in flight
// at once; store() writes them to shared memory as fp32 at row stride
// STRIDE, rows past n set to fill.  Views whose rows do not allow 4-element
// loads are read element by element in store().
template <typename T, int NROW, int WIDTH, int STRIDE, int NTH>
struct RowBlock {
    using V = typename Vec4<T>::type;
    static constexpr int PER = NROW * WIDTH / 4 / NTH;
    static_assert(PER * 4 * NTH == NROW * WIDTH, "whole loads a thread");
    V buf[PER];
    bool vec;
    __device__ __forceinline__ void load(const T* src, long long ts, int n) {
        vec = ts % 4 == 0 && reinterpret_cast<size_t>(src) % sizeof(V) == 0;
        if (!vec) return;
#pragma unroll
        for (int p = 0; p < PER; ++p) {
            const int x = threadIdx.x + p * NTH, tt = (4 * x) / WIDTH, d = (4 * x) % WIDTH;
            if (tt < n) buf[p] = *reinterpret_cast<const V*>(src + tt * ts + d);
        }
    }
    __device__ __forceinline__ void store(float* dst, const T* src, long long ts, int n,
                                          float fill) {
        if (vec) {
#pragma unroll
            for (int p = 0; p < PER; ++p) {
                const int x = threadIdx.x + p * NTH, tt = (4 * x) / WIDTH, d = (4 * x) % WIDTH;
                float* o = dst + tt * STRIDE + d;
                if (tt < n) {
                    widen(buf[p], o);
                } else {
                    o[0] = fill; o[1] = fill; o[2] = fill; o[3] = fill;
                }
            }
        } else {
            for (int x = threadIdx.x; x < NROW * WIDTH; x += NTH) {
                const int tt = x / WIDTH, d = x % WIDTH;
                dst[tt * STRIDE + d] = tt < n ? ld(src + tt * ts + d) : fill;
            }
        }
    }
};

// r, k, w (HD wide, row stride HD + 4) and the columns [j0, j0 + VW) of v
// and do (row stride SV) of a chunk (n tokens from t0) into shared memory,
// padded with tokens that leave the state as it is (w = 1, the rest 0)
template <typename T, int HD, int CC, int VW, int SV, int NTH>
__device__ __forceinline__ void stage_chunk(float* sr, float* sk, float* sv, float* sw,
                                            float* sd, const T* r, const T* k,
                                            const T* v, const float* w, const T* d,
                                            const Views& vw, int b, int h, int t0,
                                            int n, int j0) {
    constexpr int SR = HD + 4;
    RowBlock<T, CC, HD, SR, NTH> xr, xk;
    RowBlock<T, CC, VW, SV, NTH> xv, xd;
    RowBlock<float, CC, HD, SR, NTH> xw;
    const T* rp = r + b * vw.r[0] + h * vw.r[1] + t0 * vw.r[2];
    const T* kp = k + b * vw.k[0] + h * vw.k[1] + t0 * vw.k[2];
    const T* vp = v + b * vw.v[0] + h * vw.v[1] + t0 * vw.v[2] + j0;
    const float* wp = w + b * vw.w[0] + h * vw.w[1] + t0 * vw.w[2];
    const T* dp = d + b * vw.d[0] + h * vw.d[1] + t0 * vw.d[2] + j0;
    xr.load(rp, vw.r[2], n);
    xk.load(kp, vw.k[2], n);
    xv.load(vp, vw.v[2], n);
    xw.load(wp, vw.w[2], n);
    xd.load(dp, vw.d[2], n);
    xr.store(sr, rp, vw.r[2], n, 0.f);
    xk.store(sk, kp, vw.k[2], n, 0.f);
    xv.store(sv, vp, vw.v[2], n, 0.f);
    xw.store(sw, wp, vw.w[2], n, 1.f);
    xd.store(sd, dp, vw.d[2], n, 0.f);
}

// ---------------------------------------------------------------------------
// 1: L_c, G_c and P_c of every chunk, on the tensor cores
// ---------------------------------------------------------------------------

template <int HD> constexpr size_t LOCAL_SMEM = sizeof(float) * (
    3 * (size_t)Cfg<HD>::ROWS + 2 * Cfg<HD>::C * (Cfg<HD>::LW + 4)
    + Cfg<HD>::NWIN * HD);

// With A_t = prod_{m<t} w_m and B_t = prod_{m>t} w_m over the chunk:
// L_c = (K B)^T V, G_c = (R A)^T dO and P_c = A_C, into Ls / Gs (B*H, nc,
// HD, HD) and Ps (B*H, nc, HD); block z takes the columns [z LW, (z + 1)
// LW) of L_c and G_c.  The chunk's rows are staged once; a thread a
// (window, row) forms K B and R A over K and R in place from its window's
// running products and the other windows' products; then warp q takes rows
// 16 (q % (HD / 16)) of a group of columns.
template <typename T, int HD>
__global__ void __launch_bounds__(Cfg<HD>::NT, 2)
wkv6_bwd_tc_local_kernel(const T* __restrict__ r, const T* __restrict__ k,
                         const T* __restrict__ v, const float* __restrict__ w,
                         const T* __restrict__ d, float* __restrict__ Ls,
                         float* __restrict__ Gs, float* __restrict__ Ps, Views vw,
                         int H, int S) {
    using K = Cfg<HD>;
    constexpr int C = K::C, NWIN = K::NWIN, SR = K::SR, NT = K::NT, LW = K::LW;
    constexpr int SL = LW + 4;
    extern __shared__ __align__(16) float smem[];
    float* sr = smem;
    float* sk = sr + K::ROWS;
    float* sw = sk + K::ROWS;
    float* sv = sw + K::ROWS;           // [C][SL]: the block's columns
    float* sd = sv + C * SL;
    float* qprod = sd + C * SL;         // [NWIN][HD]: each window's product
    const int c = blockIdx.x, nc = gridDim.x, bh = blockIdx.y, j0 = blockIdx.z * LW;
    const int b = bh / H, h = bh % H;
    const int t0 = c * C, n = min(C, S - t0);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int qi = tid / HD, i = tid % HD;
    const size_t cb = (size_t)bh * nc + c;
    constexpr bool EX = sizeof(T) == 2;    // bf16 rows are exact in TF32
    stage_chunk<T, HD, C, LW, SL, NT>(sr, sk, sv, sw, sd, r, k, v, w, d, vw, b, h, t0,
                                      n, j0);
    __syncthreads();
    {
        const int a = qi * W;
        float ww[W], P = 1.f;
#pragma unroll
        for (int t = 0; t < W; ++t) {
            ww[t] = sw[(a + t) * SR + i];
            P *= ww[t];
        }
        qprod[qi * HD + i] = P;
        __syncthreads();
        float A = 1.f, Bp = 1.f;
        for (int q = 0; q < qi; ++q) A *= qprod[q * HD + i];
        for (int q = NWIN - 1; q > qi; --q) Bp *= qprod[q * HD + i];
        if (qi == NWIN - 1 && blockIdx.z == 0) Ps[cb * HD + i] = A * P;
#pragma unroll
        for (int t = 0; t < W; ++t) {
            sr[(a + t) * SR + i] *= A;
            A *= ww[t];
        }
#pragma unroll
        for (int t = W - 1; t >= 0; --t) {
            sk[(a + t) * SR + i] *= Bp;
            Bp *= ww[t];
        }
    }
    __syncthreads();
    constexpr int MT = HD / 16, NW = NT / 32, NTL = LW / 8 / (NW / MT);
    static_assert(NW % MT == 0 && NTL >= 1 && NTL <= 4 && NTL * 8 * (NW / MT) == LW,
                  "step 1's warps tile the block's (HD, LW) outputs");
    const int m0 = 16 * (warp % MT), n0 = 8 * NTL * (warp / MT);
    float acc[2][NTL][4] = {};
#pragma unroll
    for (int which = 0; which < 2; ++which) {
        const float* X = which ? sr : sk;
        const float* Y = which ? sd : sv;
        mma3<C / 8, NTL, false, EX>(acc[which],
                                    [&](int m, int kk) { return X[kk * SR + m0 + m]; },
                                    [&](int kk, int nn) { return Y[kk * SL + n0 + nn]; },
                                    lane);
    }
    __syncthreads();                     // the rows are consumed
    // L_c and G_c through shared memory, out 16 bytes a store
    static_assert(2 * HD * SL <= 3 * K::ROWS + 2 * C * SL, "L and G staged over the rows");
    float* sl = smem;
    float* sg = smem + HD * SL;
#pragma unroll
    for (int which = 0; which < 2; ++which)
#pragma unroll
        for (int nt = 0; nt < NTL; ++nt)
            store_tile((which ? sg : sl) + m0 * SL + n0 + 8 * nt, SL, acc[which][nt], lane);
    __syncthreads();
#pragma unroll
    for (int which = 0; which < 2; ++which) {
        const float* src = which ? sg : sl;
        float* out = (which ? Gs : Ls) + cb * HD * HD + j0;
        for (int x = tid; x < HD * LW / 4; x += NT) {
            const int i4 = (4 * x) / LW, j = (4 * x) % LW;
            *reinterpret_cast<float4*>(out + i4 * HD + j) =
                *reinterpret_cast<const float4*>(src + i4 * SL + j);
        }
    }
}

// ---------------------------------------------------------------------------
// 2: the chunks' starting states over L_c, the gradients at their ends over
// G_c, and ds0
// ---------------------------------------------------------------------------

__device__ __forceinline__ float4 decay_add(float p, float4 s, float4 l) {
    return make_float4(fmaf(p, s.x, l.x), fmaf(p, s.y, l.y), fmaf(p, s.z, l.z),
                       fmaf(p, s.w, l.w));
}

// one thread per 4 neighbouring entries of a head's state, the starts
// (blockIdx.y == 0) and the end gradients (1) in threads of their own;
// each chunk's L (G) and P loaded AHEAD at a time before they are used
template <int HD>
__global__ void __launch_bounds__(256)
wkv6_bwd_tc_scan_kernel(float* __restrict__ Ls, float* __restrict__ Gs,
                        const float* __restrict__ Ps, const float* s0,
                        const float* ds_fin, float* __restrict__ ds0, int nc,
                        int BH) {
    constexpr int Q4 = HD * HD / 4, AHEAD = 16;
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    if (x >= BH * Q4) return;
    const int bh = x / Q4, off = (x % Q4) * 4, i = off / HD;
    const size_t sb = (size_t)bh * HD * HD + off;
    if (blockIdx.y == 1) {
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
        return;
    }
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
}

// ---------------------------------------------------------------------------
// 3: each chunk's windows
// ---------------------------------------------------------------------------

// To <- diag(ae) St + X^T Y over one window's W rows of X (M wide, row
// stride XS) and Y (NC wide, row stride YS), To and St (M, NC) at row
// stride SS (To may be St), by NW warps: the (M, NC) tiles are cut into
// groups of 16 rows by 8 NTL columns, and warp q takes groups q, q + NW,
// ...; each reads its tiles of St as its accumulators and writes them to
// To; no other warp touches them.
template <bool EXB, int NW, int M, int NC, int XS, int YS, int SS>
__device__ __forceinline__ void rank_w_update(float* To, const float* St, const float* X,
                                              const float* Y, const float* ae, int warp,
                                              int lane) {
    constexpr int MT = M / 16, NTALL = NC / 8;
    constexpr int CG = NW >= MT ? NW / MT : 1;
    constexpr int NTL = CG >= NTALL ? 1 : NTALL / CG > 4 ? 4 : NTALL / CG;
    constexpr int NG = MT * (NTALL / NTL);
    const int g = lane >> 2, tg = lane & 3;
    for (int gi = warp; gi < NG; gi += NW) {
        const int m0 = 16 * (gi % MT), n0 = 8 * NTL * (gi / MT);
        const float a0 = ae[m0 + g], a1 = ae[m0 + g + 8];
        float acc[NTL][4];
#pragma unroll
        for (int nt = 0; nt < NTL; ++nt) {
            const float* p0 = St + (m0 + g) * SS + n0 + 8 * nt + 2 * tg;
            const float* p1 = p0 + 8 * SS;
            acc[nt][0] = a0 * p0[0];
            acc[nt][1] = a0 * p0[1];
            acc[nt][2] = a1 * p1[0];
            acc[nt][3] = a1 * p1[1];
        }
        const float* xa = X + m0;
        const float* ya = Y + n0;
        mma3<W / 8, NTL, false, EXB>(acc, [&](int m, int kk) { return xa[kk * XS + m]; },
                                     [&](int kk, int nn) { return ya[kk * YS + nn]; }, lane);
#pragma unroll
        for (int nt = 0; nt < NTL; ++nt) {
            float* p0 = To + (m0 + g) * SS + n0 + 8 * nt + 2 * tg;
            float* p1 = p0 + 8 * SS;
            p0[0] = acc[nt][0];
            p0[1] = acc[nt][1];
            p1[0] = acc[nt][2];
            p1[1] = acc[nt][3];
        }
    }
}

// each window's prefix and suffix products on row i (thread (window wi,
// row i)): R A, K B and A_e
template <int HD>
__device__ __forceinline__ void window_products(float* ra, float* kb, float* ae,
                                                const float* sr, const float* sk,
                                                const float* sw, int wi, int i) {
    constexpr int SR = HD + 4;
    const int a = wi * W;
    float A = 1.f, Bp = 1.f;
#pragma unroll
    for (int t = 0; t < W; ++t) {
        const int x = (a + t) * SR + i;
        ra[x] = sr[x] * A;
        A *= sw[x];
    }
    ae[wi * HD + i] = A;
#pragma unroll
    for (int t = W - 1; t >= 0; --t) {
        const int x = (a + t) * SR + i;
        kb[x] = sk[x] * Bp;
        Bp *= sw[x];
    }
}

// rowsum(dS_e * S_a) over the CTA's HH columns of every row, LPR lanes a
// row, into rs[0 .. HD)
template <int HD, int HH, int NTH>
__device__ __forceinline__ void window_rowsum(float* rs, const float* Ss, const float* dSs,
                                              int tid) {
    constexpr int SH = HH + 4, LPR = NTH / HD, PC = HH / LPR;
    static_assert(LPR * HD == NTH && LPR <= 32 && PC * LPR == HH, "lanes a row");
    const int ii = tid / LPR, q = tid % LPR;
    float acc = 0.f;
#pragma unroll
    for (int j = PC * q; j < PC * q + PC; ++j)
        acc = fmaf(Ss[ii * SH + j], dSs[ii * SH + j], acc);
#pragma unroll
    for (int o = 1; o < LPR; o <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (q == 0) rs[ii] = acc;
}

// Token by token within each window.  Thread (window wi, row i = r0 + il of
// the CTA's HH rows, parity hp): the HH / 16 warps of a window hold its
// rows, sixteen a warp, and each row's two lanes (lane, lane ^ 16) split
// the later tokens s of a token t by parity; the lane of t's parity
// finishes t.  qr, pk (row stride HD + 4) and rs hold the summed products
// at row i; dr, dk and dw go to odr, odk, odw at row stride SO, column il;
// q's partials (a warp's sixteen rows) to qp [NWIN][HH / 16][W][W], du's
// to dus [NWIN][2][HH].  SYNC: odr, odk, odw lie over sr, sk, sw, which are
// read into registers first.
template <int HD, int HH, int SO, bool SYNC>
__device__ __forceinline__ void row_walk(const float* sr, const float* sk, const float* sw,
                                         const float* qr, const float* pk, const float* rs,
                                         const float* cs, const float* u, float* odr,
                                         float* odk, float* odw, float* qp, float* dus,
                                         int h, int r0, int warp, int lane) {
    constexpr int SR = HD + 4, WPW = HH / 16;
    const int wi = warp / WPW, wq = warp % WPW, hp = lane >> 4;
    const int il = 16 * wq + (lane & 15), i = r0 + il, a = wi * W;
    const float ui = u[h * HD + i];
    // kk, ww: every token; rr, sdo: the lane's tokens s = 2 j + hp; w2:
    // w_s w_{s+1}, the step from D(t, s) to D(t, s + 2)
    float kk[W], ww[W], rr[W / 2], sdo[W / 2], w2[W / 2], bt[W];
#pragma unroll
    for (int t = 0; t < W; ++t) {
        const int x = (a + t) * SR + i;
        kk[t] = sk[x];
        ww[t] = sw[x];
    }
#pragma unroll
    for (int j = 0; j < W / 2; ++j) {
        const int x = (a + 2 * j + hp) * SR + i;
        rr[j] = sr[x];
        sdo[j] = qr[x];
        w2[j] = 2 * j + hp + 1 < W ? sw[x] * sw[x + SR] : 1.f;
    }
    if (SYNC) __syncthreads();
    bt[W - 1] = 1.f;
#pragma unroll
    for (int t = W - 2; t >= 0; --t) bt[t] = bt[t + 1] * ww[t + 1];
    float ge = rs[wi * HD + i], du_acc = 0.f;
    const float* cw = cs + wi * W * W;
#pragma unroll
    for (int t = 0; t < W; ++t) {
        const bool own = (t & 1) == hp;             // this lane finishes t
        const float ctt = cw[t * W + t], pkt = pk[(a + t) * SR + i];
        float dkv = 0.f, dwv = 0.f, p[W / 2];
#pragma unroll
        for (int j = 0; j < W / 2; ++j) p[j] = 0.f;
        // own tokens s > t: s = 2 j + hp; D(t, s) = prod_{t<m<s} w_m
        float D = 1.f;
        if (((t + 1) & 1) != hp && t + 1 < W) D = ww[t + 1];
#pragma unroll
        for (int j = 0; j < W / 2; ++j) {
            // unrolled, so this is known for each (t, j): the lanes of
            // one parity skip together
            const int s = 2 * j;
            if (s + 1 <= t) continue;
            const bool mine = hp ? s + 1 > t : s > t;
            if (!mine) continue;
            const int sj = s + hp;
            const float z = D * rr[j], cts = cw[t * W + sj];
            dkv = fmaf(z, cts, dkv);
            dwv = fmaf(z, sdo[j], dwv);
            p[j] = z * kk[t];
            D *= w2[j];
            sdo[j] = fmaf(ww[t], sdo[j], kk[t] * cts);
        }
        dkv += __shfl_xor_sync(0xffffffffu, dkv, 16);
        dwv += __shfl_xor_sync(0xffffffffu, dwv, 16);
        if (own) p[t / 2] = ui * rr[t / 2] * kk[t];
        if (own) {
            const int x = (a + t) * SO + il;
            odr[x] = fmaf(ui * kk[t], ctt, sdo[t / 2]);
            odk[x] = dkv + fmaf(bt[t], pkt, ui * rr[t / 2] * ctt);
            odw[x] = fmaf(bt[t], ge, dwv);
        }
        if (own) du_acc = fmaf(rr[t / 2] * kk[t], ctt, du_acc);
        ge = fmaf(ww[t], ge, kk[t] * pkt);
        // q_ts over the warp's sixteen rows of this parity: only s >= t
        // is read, so late in the window the sums shrink to the last
        // four of a lane's eight
        float* qrow = qp + ((wi * WPW + wq) * W + t) * W + hp;
        if (t < 8) {
            const int first = reduce_scatter<8, 8, 1>(p, lane);
            if ((lane & RS_DUP<8, 8, 1>) == 0) qrow[2 * first] = p[0];
        } else {
            float p4[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) p4[e] = p[4 + e];
            const int first = reduce_scatter<4, 8, 1>(p4, lane);
            if ((lane & RS_DUP<4, 8, 1>) == 0) qrow[2 * (4 + first)] = p4[0];
        }
    }
    dus[(wi * 2 + hp) * HH + il] = du_acc;
}

// dv = Pv + Q dO over Pv (pvs, row stride SV), Q (upper triangular) the
// sum of the q partials of every rank's warps, rank 0's first, each rank's
// warps in order; dO's columns in sd (row stride SV).  Warp q takes the
// (window, 8 columns) tiles q, q + NWARP, ...
template <bool EX, int HH, int NWIN, int NR, int SV, int NWARP>
__device__ __forceinline__ void dv_product(float* pvs, const float* sd,
                                           const float* const (&qps)[NR], int warp,
                                           int lane) {
    constexpr int WPW = HH / 16, NTC = HH / 8;
    const int g = lane >> 2, tg = lane & 3;
    for (int task = warp; task < NWIN * NTC; task += NWARP) {
        const int x = task / NTC, nt = task % NTC;
        const float* da = sd + x * W * SV + 8 * nt;
        float* pe = pvs + x * W * SV + 8 * nt;
        float acc[1][4] = {{pe[g * SV + 2 * tg], pe[g * SV + 2 * tg + 1],
                            pe[(g + 8) * SV + 2 * tg], pe[(g + 8) * SV + 2 * tg + 1]}};
        mma3<W / 8, 1, false, EX>(acc, [&](int m, int kk) {
                           if (kk < m) return 0.f;
                           const int at = (x * WPW * W + m) * W + kk;
                           float q = qps[0][at];
#pragma unroll
                           for (int p = 1; p < WPW; ++p) q += qps[0][at + p * W * W];
#pragma unroll
                           for (int rk = 1; rk < NR; ++rk)
#pragma unroll
                               for (int p = 0; p < WPW; ++p) q += qps[rk][at + p * W * W];
                           return q; },
                       [&](int kk, int nn) { return da[kk * SV + nn]; }, lane);
        store_tile(pe, SV, acc[0], lane);
    }
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
    const __nv_bfloat16 x = __float2bfloat16_rn(a), y = __float2bfloat16_rn(b);
    return (uint32_t)*reinterpret_cast<const uint16_t*>(&x)
           | (uint32_t)*reinterpret_cast<const uint16_t*>(&y) << 16;
}
__device__ __forceinline__ uint4 pack16(const float* p, __nv_bfloat16*) {
    return make_uint4(pack2(p[0], p[1]), pack2(p[2], p[3]), pack2(p[4], p[5]),
                      pack2(p[6], p[7]));
}
__device__ __forceinline__ uint4 pack16(const float* p, float*) {
    return make_uint4(__float_as_uint(p[0]), __float_as_uint(p[1]),
                      __float_as_uint(p[2]), __float_as_uint(p[3]));
}

// n rows of WIDTH columns of a gradient staged in shared memory (fp32 at
// row stride STRIDE) out to a (token, .) view of T through its token stride
// ts, rounded once: 16 bytes a store where the view's rows allow it, else
// element by element
template <typename T, int WIDTH, int STRIDE, int NTH>
__device__ __forceinline__ void write_rows(T* dst, long long ts, const float* src, int n) {
    constexpr int E = 16 / sizeof(T);   // elements a store
    static_assert(WIDTH % E == 0, "whole stores a row");
    if (ts % E == 0 && reinterpret_cast<size_t>(dst) % 16 == 0) {
        for (int x = threadIdx.x; x < n * WIDTH / E; x += NTH) {
            const int tt = x / (WIDTH / E), e = (x % (WIDTH / E)) * E;
            *reinterpret_cast<uint4*>(dst + tt * ts + e) =
                pack16(src + tt * STRIDE + e, static_cast<T*>(nullptr));
        }
    } else {
        for (int x = threadIdx.x; x < n * WIDTH; x += NTH) {
            const int tt = x / WIDTH, e = x % WIDTH;
            st(dst + tt * ts + e, src[tt * STRIDE + e]);
        }
    }
}

// 3a: hd 16, 32, 64, one block a chunk

template <int HD> constexpr size_t WALK_SMEM = sizeof(float) * (
    9 * (size_t)Cfg<HD>::ROWS  // r, k, v, w, do; K B, R A; Qr, Pk
    + 4 * (size_t)Cfg<HD>::STATE  // three window starts, dS
    + Cfg<HD>::NWIN * W * W       // c = V dO^T of each window
    + 2 * Cfg<HD>::NWIN * HD);    // A_e, rowsum(dS_e * S_a)

template <typename T, int HD>
__global__ void __launch_bounds__(Cfg<HD>::WT, Cfg<HD>::MINB)
wkv6_bwd_tc_walk_kernel(const T* __restrict__ r, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ w,
                        const T* __restrict__ d, const float* __restrict__ u,
                        const float* __restrict__ starts,
                        const float* __restrict__ ends, T* __restrict__ dr,
                        T* __restrict__ dk, T* __restrict__ dv,
                        float* __restrict__ dw, float* __restrict__ du_part,
                        Views vw, int H, int S) {
    using K = Cfg<HD>;
    constexpr int C = K::C, NWIN = K::NWIN, SR = K::SR, ROWS = K::ROWS;
    constexpr int STATE = K::STATE, WT = K::WT, NWARP = K::NWARP, HALF = NWARP / 2;
    static_assert(K::NR == 1 && NWIN == 4, "three stored window starts");
    static_assert(WT == 2 * NWIN * HD && HALF == HD / 8, "a walk thread a (window, row, "
                  "parity); half the warps an 8-column tile of Qr or Pv each");
    static_assert(WALK_SMEM<HD> <= 232448, "the walk's shared memory");
    static_assert(NWIN * (HD / 16) * W * W <= ROWS, "q's partials fit over R A");
    static_assert(NWIN * 2 * HD <= ROWS, "du's partials fit over K B");
    static_assert(NWIN * W * SR <= ROWS, "Pv fits over V");
    // dr, dk, dw staged over the window starts where they fit (hd 64), else
    // over r, k, w once the row walk has read them
    constexpr bool OVER_ROWS = STATE < ROWS;
    extern __shared__ __align__(16) float smem[];
    float* sr = smem;                   // [C][SR] each: the chunk's rows
    float* sk = sr + ROWS;
    float* sv = sk + ROWS;
    float* sw = sv + ROWS;              // (padded with 1: the state unchanged)
    float* sd = sw + ROWS;
    float* kb = sd + ROWS;              // k_t * B_t; du's partials once free
    float* ra = kb + ROWS;              // r_t * A_t; q's partials once free
    float* qr = ra + ROWS;              // S_a do_t
    float* pk = qr + ROWS;              // dS_e v_t
    float* S0 = pk + ROWS;              // [HD][SR]: window starts, dS
    float* S1 = S0 + STATE;
    float* S2 = S1 + STATE;
    float* dSs = S2 + STATE;
    float* cs = dSs + STATE;            // [NWIN][W][W]: v_x . do_y
    float* ae = cs + NWIN * W * W;      // [NWIN][HD]: A_e
    float* rs = ae + NWIN * HD;         // [NWIN][HD]: rowsum(dS_e * S_a)
    float* qp = ra;                     // [NWIN][HD / 16][W][W]: q's partials
    float* dus = kb;                    // [NWIN][2][HD]: du's partials
    float* pvs = sv;                    // [C][SR]: Pv, then dv, once V is free
    float* odr = OVER_ROWS ? sr : S0;   // [C][SR]: dr, dk, dw
    float* odk = OVER_ROWS ? sk : S1;
    float* odw = OVER_ROWS ? sw : S2;
    const int c = blockIdx.x, nc = gridDim.x, bh = blockIdx.y;
    const int b = bh / H, h = bh % H;
    const int t0 = c * C, n = min(C, S - t0);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, tg = lane & 3;
    constexpr bool EX = sizeof(T) == 2;         // bf16 rows are exact in TF32
    const size_t cb = ((size_t)bh * nc + c) * HD * HD;
    // the chunk's start, kept in registers until the last window needs it
    // again, and its end gradient
    constexpr int NQ = HD * HD / 4, SP = (NQ + WT - 1) / WT;
    float4 s4[SP];
    {
        float4 e4[SP];
#pragma unroll
        for (int p = 0; p < SP; ++p) {
            const int x = tid + p * WT;
            if (NQ % WT == 0 || x < NQ) {
                s4[p] = *reinterpret_cast<const float4*>(starts + cb + 4 * x);
                e4[p] = *reinterpret_cast<const float4*>(ends + cb + 4 * x);
            }
        }
        stage_chunk<T, HD, C, HD, SR, WT>(sr, sk, sv, sw, sd, r, k, v, w, d, vw, b, h, t0,
                                          n, 0);
#pragma unroll
        for (int p = 0; p < SP; ++p) {
            const int x = tid + p * WT, at = (4 * x / HD) * SR + 4 * x % HD;
            if (NQ % WT == 0 || x < NQ) {
                *reinterpret_cast<float4*>(S0 + at) = s4[p];
                *reinterpret_cast<float4*>(dSs + at) = e4[p];
            }
        }
    }
    __syncthreads();
    if (tid < NWIN * HD) {
        window_products<HD>(ra, kb, ae, sr, sk, sw, tid / HD, tid % HD);
    } else {
        // c = V dO^T of every window: task q (of 2 NWIN) takes window q / 2,
        // columns 8 (q % 2)
        for (int task = warp - HALF; task < 2 * NWIN; task += HALF) {
            const int x = task / 2, nt = task % 2;
            float acc[1][4] = {{0.f, 0.f, 0.f, 0.f}};
            const float* va = sv + x * W * SR;
            const float* da = sd + (x * W + 8 * nt) * SR;
            mma3<HD / 8, 1, EX, EX>(acc, [&](int m, int kk) { return va[m * SR + kk]; },
                                    [&](int kk, int nn) { return da[nn * SR + kk]; }, lane);
            store_tile(cs + x * W * W + 8 * nt, W, acc[0], lane);
        }
    }
    __syncthreads();

    // the windows' starts: S_a(1), S_a(2) in S1, S2, S_a(3) over the chunk's
    // start in S0, by warps HALF .., while warps 0 .. HALF - 1 take columns
    // 8 q of Qr = dO S_a^T of windows 0-2
    const int q8 = warp % HALF;
#pragma unroll
    for (int y = 0; y < NWIN - 1; ++y) {
        const float* from = y == 0 ? S0 : y == 1 ? S1 : S2;
        float* to = y == 0 ? S1 : y == 1 ? S2 : S0;
        if (warp < HALF) {
            float aq[3][4] = {};
            const float* da = sd + y * W * SR;
            const float* sb = from + 8 * q8 * SR;
#pragma unroll
            for (int k0 = 0; k0 < HD; k0 += 8) {
                uint32_t ah[4], al[4], bh[2], bl[2];
                frag_a<EX>(ah, al, [&](int m, int kk) { return da[m * SR + kk]; }, k0, g, tg);
                frag_b<false>(bh, bl, [&](int kk, int nn) { return sb[nn * SR + kk]; }, k0,
                              0, g, tg);
                mma_x3<EX, false>(aq, ah, al, bh, bl);
            }
            float o[4];
            fold_x3(o, aq);
            store_tile(qr + y * W * SR + 8 * q8, SR, o, lane);
        } else {
            rank_w_update<EX, HALF, HD, HD, SR, SR, SR>(to, from, kb + y * W * SR,
                                                        sv + y * W * SR, ae + y * HD,
                                                        warp - HALF, lane);
        }
        __syncthreads();
    }

    // the windows last first, dS_e carried back from the chunk's end.  Warps
    // 0 .. HALF - 1 take columns 8 q of Pk (and of window 3's Qr), warps
    // HALF .. columns 8 (q - HALF) of Pv
    float pv[NWIN][4];
#pragma unroll
    for (int x = NWIN - 1; x >= 0; --x) {
        if (x == 0) {
#pragma unroll
            for (int p = 0; p < SP; ++p) {
                const int y = tid + p * WT;
                if (NQ % WT == 0 || y < NQ)
                    *reinterpret_cast<float4*>(S0 + (4 * y / HD) * SR + 4 * y % HD) = s4[p];
            }
            __syncthreads();
        }
        const float* Ss = x == 2 ? S2 : x == 1 ? S1 : S0;
        if (warp < HALF) {
            // Pk = V dS_e^T, and for the last window Qr = dO S_a^T, in one
            // k-loop
            float aq[3][4] = {}, ak[3][4] = {};
            const float* da = sd + x * W * SR;
            const float* va = sv + x * W * SR;
            const float* sb = Ss + 8 * q8 * SR;
            const float* gb = dSs + 8 * q8 * SR;
#pragma unroll
            for (int k0 = 0; k0 < HD; k0 += 8) {
                uint32_t ah[4], al[4], bh[2], bl[2];
                if (x == NWIN - 1) {
                    frag_a<EX>(ah, al, [&](int m, int kk) { return da[m * SR + kk]; }, k0, g,
                               tg);
                    frag_b<false>(bh, bl, [&](int kk, int nn) { return sb[nn * SR + kk]; },
                                  k0, 0, g, tg);
                    mma_x3<EX, false>(aq, ah, al, bh, bl);
                }
                frag_a<EX>(ah, al, [&](int m, int kk) { return va[m * SR + kk]; }, k0, g, tg);
                frag_b<false>(bh, bl, [&](int kk, int nn) { return gb[nn * SR + kk]; }, k0,
                              0, g, tg);
                mma_x3<EX, false>(ak, ah, al, bh, bl);
            }
            float o[4];
            if (x == NWIN - 1) {
                fold_x3(o, aq);
                store_tile(qr + x * W * SR + 8 * q8, SR, o, lane);
            }
            fold_x3(o, ak);
            store_tile(pk + x * W * SR + 8 * q8, SR, o, lane);
        } else {
            // Pv = (K B) dS_e
            float av[3][4] = {};
            const float* ka = kb + x * W * SR;
            const float* gc = dSs + 8 * q8;
#pragma unroll
            for (int k0 = 0; k0 < HD; k0 += 8) {
                uint32_t ah[4], al[4], bh[2], bl[2];
                frag_a<false>(ah, al, [&](int m, int kk) { return ka[m * SR + kk]; }, k0, g,
                              tg);
                frag_b<false>(bh, bl, [&](int kk, int nn) { return gc[kk * SR + nn]; }, k0,
                              0, g, tg);
                mma_x3<false, false>(av, ah, al, bh, bl);
            }
            fold_x3(pv[x], av);
        }
        window_rowsum<HD, HD, WT>(rs + x * HD, Ss, dSs, tid);
        __syncthreads();
        if (x > 0) {
            rank_w_update<EX, NWARP, HD, HD, SR, SR, SR>(dSs, dSs, ra + x * W * SR,
                                                         sd + x * W * SR, ae + x * HD,
                                                         warp, lane);
            __syncthreads();
        }
    }

    if (warp >= HALF) {
#pragma unroll
        for (int x = 0; x < NWIN; ++x) store_tile(pvs + x * W * SR + 8 * q8, SR, pv[x], lane);
    }

    row_walk<HD, HD, SR, OVER_ROWS>(sr, sk, sw, qr, pk, rs, cs, u, odr, odk, odw, qp, dus,
                                    h, 0, warp, lane);
    __syncthreads();

    const float* const qps[1] = {qp};
    dv_product<EX, HD, NWIN, 1, SR, NWARP>(pvs, sd, qps, warp, lane);
    __syncthreads();
    // the gradients' rows out, 16 bytes a store where their views allow
    write_rows<T, HD, SR, WT>(dr + b * vw.dr[0] + h * vw.dr[1] + t0 * vw.dr[2], vw.dr[2],
                              odr, n);
    write_rows<T, HD, SR, WT>(dk + b * vw.dk[0] + h * vw.dk[1] + t0 * vw.dk[2], vw.dk[2],
                              odk, n);
    write_rows<T, HD, SR, WT>(dv + b * vw.dv[0] + h * vw.dv[1] + t0 * vw.dv[2], vw.dv[2],
                              pvs, n);
    write_rows<float, HD, SR, WT>(dw + b * vw.dw[0] + h * vw.dw[1] + t0 * vw.dw[2],
                                  vw.dw[2], odw, n);
    if (tid < HD) {
        float acc = dus[tid];
#pragma unroll
        for (int x = 1; x < 2 * NWIN; ++x) acc += dus[x * HD + tid];
        du_part[((size_t)bh * nc + c) * HD + tid] = acc;
    }
}

// 3b: hd 128, a cluster of NR CTAs a chunk, each a block of HH columns

template <int HD> constexpr size_t CLUSTER_SMEM = sizeof(float) * (
    7 * (size_t)Cfg<HD>::ROWS        // r, k, w; K B, R A; Qr, Pk partials
    + 2 * (size_t)Cfg<HD>::C * Cfg<HD>::SH  // the CTA's columns of v, do
    + 2 * (size_t)Cfg<HD>::STATE     // a window start, dS
    + 2 * Cfg<HD>::NWIN * W * W      // c's partial, c
    + 2 * Cfg<HD>::NWIN * HD);       // A_e, rowsum(dS_e * S_a)'s partial

template <typename T, int HD>
__global__ void __cluster_dims__(Cfg<HD>::NR, 1, 1) __launch_bounds__(Cfg<HD>::WT, 1)
wkv6_bwd_tc_cluster_kernel(const T* __restrict__ r, const T* __restrict__ k,
                           const T* __restrict__ v, const float* __restrict__ w,
                           const T* __restrict__ d, const float* __restrict__ u,
                           const float* __restrict__ starts,
                           const float* __restrict__ ends, T* __restrict__ dr,
                           T* __restrict__ dk, T* __restrict__ dv,
                           float* __restrict__ dw, float* __restrict__ du_part,
                           Views vw, int H, int S) {
    using K = Cfg<HD>;
    constexpr int C = K::C, NWIN = K::NWIN, NR = K::NR, HH = K::HH, SR = K::SR;
    constexpr int SH = K::SH, ROWS = K::ROWS, WT = K::WT, NWARP = K::NWARP;
    constexpr int QT = HD / 8 / NWARP;  // 8-row tiles of Qr and Pk a warp
    static_assert(NR > 1 && NWIN == 2, "window 1's start over the chunk's");
    static_assert(NWIN * HD % WT == 0 && QT * 8 * NWARP == HD && HH / 8 == NWARP,
                  "threads of (window, row) pairs for the products; a warp QT "
                  "8-row tiles of Qr and Pk and one 8-column tile of Pv");
    static_assert(CLUSTER_SMEM<HD> <= 232448, "the walk's shared memory");
    static_assert(NWIN * (HH / 16) * W * W <= ROWS, "q's partials fit over R A");
    static_assert(NWIN * 2 * HH <= ROWS, "du's partials fit over K B");
    static_assert(3 * C * SH <= K::STATE, "dr, dk, dw fit over the window start");
    cg::cluster_group cl = cg::this_cluster();
    extern __shared__ __align__(16) float smem[];
    float* sr = smem;                   // [C][SR] each: the chunk's rows
    float* sk = sr + ROWS;
    float* sw = sk + ROWS;              // (padded with 1: the state unchanged)
    float* kb = sw + ROWS;              // k_t * B_t; du's partials once free
    float* ra = kb + ROWS;              // r_t * A_t; q's partials once free
    float* qr = ra + ROWS;              // S_a do_t over the CTA's columns
    float* pk = qr + ROWS;              // dS_e v_t likewise
    float* sv = pk + ROWS;              // [C][SH]: the CTA's columns of v, do
    float* sd = sv + C * SH;
    float* Sa = sd + C * SH;            // [HD][SH]: a window start, dS
    float* dSs = Sa + K::STATE;
    float* cp = dSs + K::STATE;         // [NWIN][W][W]: c's partial, then c
    float* cs = cp + NWIN * W * W;
    float* ae = cs + NWIN * W * W;      // [NWIN][HD]: A_e
    float* rs = ae + NWIN * HD;         // [NWIN][HD]: rowsum(dS_e * S_a)'s partial
    float* qp = ra;                     // [NWIN][HH / 16][W][W]: q's partials
    float* dus = kb;                    // [NWIN][2][HH]: du's partials
    float* pvs = sv;                    // [C][SH]: Pv, then dv, once V is free
    float* odr = Sa;                    // [C][SH]: dr, dk, dw of the CTA's rows
    float* odk = odr + C * SH;
    float* odw = odk + C * SH;
    const int rank = (int)cl.block_rank(), j0 = rank * HH;
    const int c = blockIdx.x / NR, nc = gridDim.x / NR, bh = blockIdx.y;
    const int b = bh / H, h = bh % H;
    const int t0 = c * C, n = min(C, S - t0);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, tg = lane & 3;
    constexpr bool EX = sizeof(T) == 2;         // bf16 rows are exact in TF32
    const size_t cb = ((size_t)bh * nc + c) * HD * HD;
    // the CTA's columns of the chunk's start and end gradient
    auto load_state = [&](float* to, const float* from) {
        for (int y = tid; y < HD * HH / 4; y += WT) {
            const int i = 4 * y / HH, jj = 4 * y % HH;
            *reinterpret_cast<float4*>(to + i * SH + jj) =
                *reinterpret_cast<const float4*>(from + cb + i * HD + j0 + jj);
        }
    };
    load_state(Sa, starts);
    load_state(dSs, ends);
    stage_chunk<T, HD, C, HH, SH, WT>(sr, sk, sv, sw, sd, r, k, v, w, d, vw, b, h, t0, n,
                                      j0);
    __syncthreads();
    for (int x = tid; x < NWIN * HD; x += WT) window_products<HD>(ra, kb, ae, sr, sk, sw,
                                                                  x / HD, x % HD);
    __syncthreads();
    // c's partial of every window (warps 0 .. 2 NWIN - 1), then window 1's
    // start over the chunk's (every warp its own tiles)
    if (warp < 2 * NWIN) {
        const int x = warp / 2, nt = warp % 2;
        float acc[1][4] = {{0.f, 0.f, 0.f, 0.f}};
        const float* va = sv + x * W * SH;
        const float* da = sd + (x * W + 8 * nt) * SH;
        mma3<HH / 8, 1, EX, EX>(acc, [&](int m, int kk) { return va[m * SH + kk]; },
                                [&](int kk, int nn) { return da[nn * SH + kk]; }, lane);
        store_tile(cp + x * W * W + 8 * nt, W, acc[0], lane);
    }
    rank_w_update<EX, NWARP, HD, HH, SR, SH, SH>(Sa, Sa, kb, sv, ae, warp, lane);
    __syncthreads();

    // the windows last first, dS_e carried back from the chunk's end: warp q
    // takes rows 8 QT q .. of Qr's and Pk's partials and columns 8 q of Pv
    float pv[NWIN][4];
#pragma unroll
    for (int x = NWIN - 1; x >= 0; --x) {
        if (x < NWIN - 1) {
            load_state(Sa, starts);     // window 0's start: the chunk's
            __syncthreads();
        }
        {
            float aq[QT][3][4] = {}, ak[QT][3][4] = {};
            const float* da = sd + x * W * SH;
            const float* va = sv + x * W * SH;
#pragma unroll
            for (int k0 = 0; k0 < HH; k0 += 8) {
                uint32_t ah[4], al[4], vh[4], vl[4];
                frag_a<EX>(ah, al, [&](int m, int kk) { return da[m * SH + kk]; }, k0, g, tg);
                frag_a<EX>(vh, vl, [&](int m, int kk) { return va[m * SH + kk]; }, k0, g, tg);
#pragma unroll
                for (int nt = 0; nt < QT; ++nt) {
                    const float* sb = Sa + 8 * (QT * warp + nt) * SH;
                    const float* gb = dSs + 8 * (QT * warp + nt) * SH;
                    uint32_t bh[2], bl[2];
                    frag_b<false>(bh, bl, [&](int kk, int nn) { return sb[nn * SH + kk]; },
                                  k0, 0, g, tg);
                    mma_x3<EX, false>(aq[nt], ah, al, bh, bl);
                    frag_b<false>(bh, bl, [&](int kk, int nn) { return gb[nn * SH + kk]; },
                                  k0, 0, g, tg);
                    mma_x3<EX, false>(ak[nt], vh, vl, bh, bl);
                }
            }
#pragma unroll
            for (int nt = 0; nt < QT; ++nt) {
                float o[4];
                fold_x3(o, aq[nt]);
                store_tile(qr + x * W * SR + 8 * (QT * warp + nt), SR, o, lane);
                fold_x3(o, ak[nt]);
                store_tile(pk + x * W * SR + 8 * (QT * warp + nt), SR, o, lane);
            }
            // Pv = (K B) dS_e over the CTA's columns
            float av[3][4] = {};
            const float* ka = kb + x * W * SR;
            const float* gc = dSs + 8 * warp;
#pragma unroll
            for (int k0 = 0; k0 < HD; k0 += 8) {
                uint32_t ah[4], al[4], bh[2], bl[2];
                frag_a<false>(ah, al, [&](int m, int kk) { return ka[m * SR + kk]; }, k0, g,
                              tg);
                frag_b<false>(bh, bl, [&](int kk, int nn) { return gc[kk * SH + nn]; }, k0,
                              0, g, tg);
                mma_x3<false, false>(av, ah, al, bh, bl);
            }
            fold_x3(pv[x], av);
        }
        window_rowsum<HD, HH, WT>(rs + x * HD, Sa, dSs, tid);
        __syncthreads();
        if (x > 0) {
            rank_w_update<EX, NWARP, HD, HH, SR, SH, SH>(dSs, dSs, ra + x * W * SR,
                                                         sd + x * W * SH, ae + x * HD,
                                                         warp, lane);
            __syncthreads();
        }
    }
#pragma unroll
    for (int x = 0; x < NWIN; ++x) store_tile(pvs + x * W * SH + 8 * warp, SH, pv[x], lane);

    // the partials summed over the cluster, rank 0's first: Qr, Pk and the
    // row sums at the CTA's rows (in place: the other ranks read only
    // theirs), c whole
    cl.sync();
    {
        const float* qrs[NR];
        const float* pks[NR];
        const float* rss[NR];
        const float* cps[NR];
#pragma unroll
        for (int rk = 0; rk < NR; ++rk) {
            qrs[rk] = cl.map_shared_rank(qr, rk);
            pks[rk] = cl.map_shared_rank(pk, rk);
            rss[rk] = cl.map_shared_rank(rs, rk);
            cps[rk] = cl.map_shared_rank(cp, rk);
        }
        for (int e = tid; e < C * HH; e += WT) {
            const int at = (e / HH) * SR + j0 + e % HH;
            float a = qrs[0][at], p = pks[0][at];
#pragma unroll
            for (int rk = 1; rk < NR; ++rk) {
                a += qrs[rk][at];
                p += pks[rk][at];
            }
            qr[at] = a;
            pk[at] = p;
        }
        for (int e = tid; e < NWIN * HH; e += WT) {
            const int at = (e / HH) * HD + j0 + e % HH;
            float a = rss[0][at];
#pragma unroll
            for (int rk = 1; rk < NR; ++rk) a += rss[rk][at];
            rs[at] = a;
        }
        for (int e = tid; e < NWIN * W * W; e += WT) {
            float a = cps[0][e];
#pragma unroll
            for (int rk = 1; rk < NR; ++rk) a += cps[rk][e];
            cs[e] = a;
        }
    }
    __syncthreads();

    row_walk<HD, HH, SH, false>(sr, sk, sw, qr, pk, rs, cs, u, odr, odk, odw, qp, dus, h,
                                j0, warp, lane);
    cl.sync();                          // every rank's q partials

    {
        const float* qps[NR];
#pragma unroll
        for (int rk = 0; rk < NR; ++rk) qps[rk] = cl.map_shared_rank(qp, rk);
        dv_product<EX, HH, NWIN, NR, SH, NWARP>(pvs, sd, qps, warp, lane);
    }
    cl.sync();                          // no rank reads another's memory after this
    // the gradients' rows out (the CTA's rows of dr, dk, dw and du, its
    // columns of dv), 16 bytes a store where their views allow
    write_rows<T, HH, SH, WT>(dr + b * vw.dr[0] + h * vw.dr[1] + t0 * vw.dr[2] + j0,
                              vw.dr[2], odr, n);
    write_rows<T, HH, SH, WT>(dk + b * vw.dk[0] + h * vw.dk[1] + t0 * vw.dk[2] + j0,
                              vw.dk[2], odk, n);
    write_rows<T, HH, SH, WT>(dv + b * vw.dv[0] + h * vw.dv[1] + t0 * vw.dv[2] + j0,
                              vw.dv[2], pvs, n);
    write_rows<float, HH, SH, WT>(dw + b * vw.dw[0] + h * vw.dw[1] + t0 * vw.dw[2] + j0,
                                  vw.dw[2], odw, n);
    if (tid < HH) {
        float acc = dus[tid];
#pragma unroll
        for (int x = 1; x < 2 * NWIN; ++x) acc += dus[x * HH + tid];
        du_part[((size_t)bh * nc + c) * HD + j0 + tid] = acc;
    }
}

// ---------------------------------------------------------------------------
// 4: du, the partials of every (batch, chunk) summed in order
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(128)
wkv6_bwd_tc_du_kernel(const float* __restrict__ part, float* __restrict__ du,
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

// the walk of head dim HD: 3a, or 3b where a cluster splits the state
template <typename T, int HD> struct Walk {
    static constexpr size_t smem = Cfg<HD>::NR > 1 ? CLUSTER_SMEM<HD> : WALK_SMEM<HD>;
    static auto kernel() {
        if constexpr (Cfg<HD>::NR > 1) return wkv6_bwd_tc_cluster_kernel<T, HD>;
        else return wkv6_bwd_tc_walk_kernel<T, HD>;
    }
};

template <typename T, int HD>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, const void* d, const void* ds_fin,
           void* dr, void* dk, void* dv, void* dw, void* du, void* ds0,
           void* Ls, void* Gs, void* Ps, void* du_part, const Views& vw,
           int B, int H, int S, cudaStream_t stream) {
    using K = Cfg<HD>;
    const int nc = (S + K::C - 1) / K::C;
    cudaError_t err = cudaFuncSetAttribute(wkv6_bwd_tc_local_kernel<T, HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)LOCAL_SMEM<HD>);
    if (err != cudaSuccess) return (int)err;
    wkv6_bwd_tc_local_kernel<T, HD><<<dim3(nc, B * H, HD / K::LW), K::NT, LOCAL_SMEM<HD>,
                                       stream>>>(
        (const T*)r, (const T*)k, (const T*)v, (const float*)w, (const T*)d,
        (float*)Ls, (float*)Gs, (float*)Ps, vw, H, S);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const int n4 = B * H * HD * HD / 4;
    wkv6_bwd_tc_scan_kernel<HD><<<dim3((n4 + 255) / 256, 2), 256, 0, stream>>>(
        (float*)Ls, (float*)Gs, (const float*)Ps, (const float*)s0,
        (const float*)ds_fin, (float*)ds0, nc, B * H);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const auto walk = Walk<T, HD>::kernel();
    err = cudaFuncSetAttribute(walk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)Walk<T, HD>::smem);
    if (err != cudaSuccess) return (int)err;
    walk<<<dim3(nc * K::NR, B * H), K::WT, Walk<T, HD>::smem, stream>>>(
        (const T*)r, (const T*)k, (const T*)v, (const float*)w, (const T*)d,
        (const float*)u, (const float*)Ls, (const float*)Gs, (T*)dr, (T*)dk,
        (T*)dv, (float*)dw, (float*)du_part, vw, H, S);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    wkv6_bwd_tc_du_kernel<HD><<<(H * HD + 127) / 128, 128, 0, stream>>>(
        (const float*)du_part, (float*)du, B, H, nc);
    return (int)cudaGetLastError();
}

// the walk's blocks an SM, as registers and shared memory allow
template <typename T, int HD>
int walk_blocks(int* blocks) {
    const auto walk = Walk<T, HD>::kernel();
    cudaError_t err = cudaFuncSetAttribute(walk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)Walk<T, HD>::smem);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, walk, Cfg<HD>::WT,
                                                              Walk<T, HD>::smem);
}

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* s0, const void* d, const void* ds_fin,
             void* dr, void* dk, void* dv, void* dw, void* du, void* ds0,
             void* Ls, void* Gs, void* Ps, void* du_part,
             const long long* strides, int B, int H, int S, int hd, int chunk,
             void* stream) {
    if (B < 1 || H < 1 || S < 1) return (int)cudaErrorInvalidValue;
    Views vw;
    long long* dst[9] = {vw.r, vw.k, vw.v, vw.w, vw.d, vw.dr, vw.dk, vw.dv, vw.dw};
    for (int a = 0; a < 9; ++a)
        for (int i = 0; i < 3; ++i) dst[a][i] = strides[3 * a + i];
    const cudaStream_t st = (cudaStream_t)stream;
#define WKV6_BWD_TC_HD(HD_)                                                         \
    if (hd == HD_) {                                                                \
        if (chunk != Cfg<HD_>::C) return (int)cudaErrorInvalidValue;                \
        return launch<T, HD_>(r, k, v, w, u, s0, d, ds_fin, dr, dk, dv, dw, du, ds0, \
                              Ls, Gs, Ps, du_part, vw, B, H, S, st);                \
    }
    WKV6_BWD_TC_HD(16)
    WKV6_BWD_TC_HD(32)
    WKV6_BWD_TC_HD(64)
    WKV6_BWD_TC_HD(128)
#undef WKV6_BWD_TC_HD
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// r, k, v, do and dr, dk, dv in float32 (wkv6_bwd_tc_f32) or bfloat16
// (wkv6_bwd_tc_bf16); w, u, s0, ds_fin, dw, du, ds0 float32.  strides: 27
// element strides, (batch, head, token) of r, k, v, w, do, dr, dk, dv, dw.
// s0 and ds_fin may be null (zeros).  hd 16, 32, 64 or 128 and the chunk
// its Cfg's (64; 32 at hd 128), else an invalid-value error; scratch: Ls
// and Gs (B*H*nc*hd*hd), Ps and du_part (B*H*nc*hd) float32, nc =
// ceil(S / chunk).  Four launches.
extern "C" int wkv6_bwd_tc_f32(const void* r, const void* k, const void* v,
                               const void* w, const void* u, const void* s0,
                               const void* d, const void* ds_fin, void* dr,
                               void* dk, void* dv, void* dw, void* du, void* ds0,
                               void* Ls, void* Gs, void* Ps, void* du_part,
                               const long long* strides, int B, int H, int S,
                               int hd, int chunk, void* stream) {
    return dispatch<float>(r, k, v, w, u, s0, d, ds_fin, dr, dk, dv, dw, du,
                           ds0, Ls, Gs, Ps, du_part, strides, B, H, S, hd, chunk,
                           stream);
}

extern "C" int wkv6_bwd_tc_bf16(const void* r, const void* k, const void* v,
                                const void* w, const void* u, const void* s0,
                                const void* d, const void* ds_fin, void* dr,
                                void* dk, void* dv, void* dw, void* du, void* ds0,
                                void* Ls, void* Gs, void* Ps, void* du_part,
                                const long long* strides, int B, int H, int S,
                                int hd, int chunk, void* stream) {
    return dispatch<__nv_bfloat16>(r, k, v, w, u, s0, d, ds_fin, dr, dk, dv,
                                   dw, du, ds0, Ls, Gs, Ps, du_part, strides, B,
                                   H, S, hd, chunk, stream);
}

// the walk's (launch 3's) blocks an SM at head dim hd (bf16 rows, or f32
// where bf16 == 0), as its registers and shared memory allow; an
// invalid-value error for another head dim
extern "C" int wkv6_bwd_tc_walk_blocks(int hd, int bf16, int* blocks) {
    switch (hd) {
        case 16: return bf16 ? walk_blocks<__nv_bfloat16, 16>(blocks) : walk_blocks<float, 16>(blocks);
        case 32: return bf16 ? walk_blocks<__nv_bfloat16, 32>(blocks) : walk_blocks<float, 32>(blocks);
        case 64: return bf16 ? walk_blocks<__nv_bfloat16, 64>(blocks) : walk_blocks<float, 64>(blocks);
        case 128: return bf16 ? walk_blocks<__nv_bfloat16, 128>(blocks) : walk_blocks<float, 128>(blocks);
        default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" const char* repro_error_string(int e) {
    return cudaGetErrorString((cudaError_t)e);
}
