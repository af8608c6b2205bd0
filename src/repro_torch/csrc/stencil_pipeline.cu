// Fused separable 3x3 blur: the paper's Fig. 1 producer->consumer chain.
//
// Replaces: src/repro/kernels/stencil_pipeline.py::_kernel, the Pallas TPU
// kernel launched by _stencil_call / stencil_pipeline.
//
// What it computes: out = conv_y(conv_x(img)), "valid" on both axes, so an
// (H, W) image gives an (H-2, W-2) output.  bx = conv_x is the producer; it
// lives only in registers and never reaches device memory.
//
// Bound on Hopper: device memory.  The function must read H*W input
// elements and write (H-2)*(W-2) outputs; it does 10 flops per output,
// about 0.1 flop per byte, far below the 20 flop/byte at which the
// H100's fp32 units (67 TFLOP/s) would become the limit at 3.35 TB/s.
//
// Design: the paper's line buffer, walked down the image.  A block owns a
// strip of output columns and a run of output rows (`run`, a multiple of
// block_rows; the last strip and run may be shorter).  Each thread owns V
// neighbouring columns, 16 bytes of a row (4 in f32, 8 in bf16), and walks
// its run's input rows top to bottom: per row it takes its 16 bytes, gets
// the two columns to its right from the next lane (__shfl_down_sync; lane
// 31 copies those two itself), computes its bx row, and once the run's
// first two bx rows are in, emits one output row per input row from the two
// bx rows it carries in registers and the new one.  So each input row of a
// run is read from device memory once; a run re-reads only the two halo
// rows it shares with the run above.  No barrier: a thread reads only what
// it copied itself.
//
// Bytes in flight: each thread keeps a ring of RING rows in shared memory,
// filled by cp.async (16 bytes a copy, L1 bypassed): the copy of row
// r + RING is issued as soon as row r is in registers, so RING rows are
// always on their way.  The loop body is unrolled over the ring.
//
// Alignment: a 16-byte copy needs a 16-byte aligned address, which an odd
// row stride breaks (the frame's 3838-column output rows, the traced conv
// block's 4098-column input).  Every lane's columns start a multiple of 16
// bytes after its row's start, so one row's alignment is the same for the
// whole warp: each row is read and written in pieces of the widest size
// its start address allows, 16, 8, 4 or 2 bytes (a warp-uniform branch;
// cp.async moves at least 4, so a bf16 row that is only 2-byte aligned is
// loaded into registers and stored to the ring).  At the ragged right edge
// a copy reads only the bytes inside the row and fills the rest with zeros;
// outputs there are written one by one; nothing past the image is touched.
//
// The launch geometry (grid, threads, run, shared bytes) is chosen in Python
// (kernels/stencil_pipeline.py::launch_geometry) and passed in; the entry
// points check it against the image before launching.  The arithmetic is
// (a*w0 + b*w1) + c*w2 with the _rn intrinsics, never contracted into an
// FMA, and one rounding to the image dtype, so the result equals the plain
// PyTorch version and the generated streamed kernel for blur_chain bit for
// bit.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

// K1_THREADS, K1_RING, K1_BLOCKS_F32 and K1_BLOCKS_BF16 are defined by the
// wrapper (stencil_pipeline.kernel_source), the one place they are chosen.
#if !defined(K1_THREADS) || !defined(K1_RING) || !defined(K1_BLOCKS_F32) || !defined(K1_BLOCKS_BF16)
#error "build through repro_torch.kernels.stencil_pipeline.kernel_source()"
#endif
constexpr int RING = K1_RING;
// blocks of K1_THREADS an SM is guaranteed to hold: ptxas keeps each thread
// to the registers that leaves
template <typename T> constexpr int kMinBlocks = sizeof(T) == 4 ? K1_BLOCKS_F32 : K1_BLOCKS_BF16;

template <typename T> constexpr int kVec = 16 / (int)sizeof(T);

__device__ __forceinline__ float tap3(float a, float b, float c,
                                      float w0, float w1, float w2) {
    return __fadd_rn(__fadd_rn(__fmul_rn(a, w0), __fmul_rn(b, w1)), __fmul_rn(c, w2));
}

// Element k of the 16 bytes a thread holds (4 words), as f32.
template <typename T> __device__ __forceinline__ float elem(const uint32_t (&w)[4], int k);
template <> __device__ __forceinline__ float elem<float>(const uint32_t (&w)[4], int k) {
    return __uint_as_float(w[k]);
}
template <> __device__ __forceinline__ float elem<__nv_bfloat16>(const uint32_t (&w)[4], int k) {
    const uint32_t u = w[k >> 1];
    return __uint_as_float((k & 1) ? (u & 0xffff0000u) : (u << 16));
}

// One element's bits, widened to a word (f32: the word; bf16: low half).
template <typename T> __device__ __forceinline__ uint32_t load_bits(const T* p);
template <> __device__ __forceinline__ uint32_t load_bits<float>(const float* p) {
    return __ldg(reinterpret_cast<const unsigned int*>(p));
}
template <> __device__ __forceinline__ uint32_t load_bits<__nv_bfloat16>(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
}
// Widest access (bytes, a power of two up to 16) that address p allows.
__device__ __forceinline__ int access_bytes(const void* p) {
    const uint32_t a = (uint32_t)(uintptr_t)p & 15u;
    return a ? (int)(a & (0u - a)) : 16;
}

__device__ __forceinline__ void store16(char* p, const uint32_t (&w)[4], int bytes) {
    if (bytes == 16) {
        *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    } else if (bytes == 8) {
        reinterpret_cast<uint2*>(p)[0] = make_uint2(w[0], w[1]);
        reinterpret_cast<uint2*>(p)[1] = make_uint2(w[2], w[3]);
    } else if (bytes == 4) {
#pragma unroll
        for (int j = 0; j < 4; ++j) reinterpret_cast<uint32_t*>(p)[j] = w[j];
    } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            reinterpret_cast<unsigned short*>(p)[2 * j] = (unsigned short)w[j];
            reinterpret_cast<unsigned short*>(p)[2 * j + 1] = (unsigned short)(w[j] >> 16);
        }
    }
}

// The first `valid` of a thread's V columns at p, element by element, as 4
// words (zeros after).
template <typename T>
__device__ __forceinline__ void load_cols(uint32_t (&w)[4], const T* p, int valid) {
    constexpr int V = kVec<T>;
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = 0;
#pragma unroll
    for (int k = 0; k < V; ++k)
        if (k < valid) {
            const uint32_t b = load_bits<T>(p + k);
            if constexpr (sizeof(T) == 4) w[k] = b;
            else w[k >> 1] |= b << (16 * (k & 1));
        }
}

template <typename T>
__device__ __forceinline__ void store_cols(T* p, const float (&o)[kVec<T>], int valid, int bytes);
template <>
__device__ __forceinline__ void store_cols<float>(float* p, const float (&o)[4], int valid, int bytes) {
    if (valid >= 4) {
        const uint32_t w[4] = {__float_as_uint(o[0]), __float_as_uint(o[1]),
                               __float_as_uint(o[2]), __float_as_uint(o[3])};
        store16(reinterpret_cast<char*>(p), w, bytes);
        return;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
        if (k < valid) p[k] = o[k];
}
template <>
__device__ __forceinline__ void store_cols<__nv_bfloat16>(__nv_bfloat16* p, const float (&o)[8],
                                                          int valid, int bytes) {
    if (valid >= 8) {
        uint32_t w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const __nv_bfloat162 h = __floats2bfloat162_rn(o[2 * j], o[2 * j + 1]);
            w[j] = *reinterpret_cast<const uint32_t*>(&h);
        }
        store16(reinterpret_cast<char*>(p), w, bytes);
        return;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k)
        if (k < valid) p[k] = __float2bfloat16_rn(o[k]);
}

// ---- cp.async
// Copy `src_bytes` (0..N) bytes from src to shared memory at dst and fill
// the rest of the N with zeros, asynchronously (dst and src N-aligned).
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
    const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
    if constexpr (N == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                     :: "r"(d), "l"(src), "n"(N), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory"); }
// ---- end cp.async

__device__ __forceinline__ int clamp_bytes(int b, int n) { return b < 0 ? 0 : (b > n ? n : b); }

// Start the copies of input row r (when the run has it) into the thread's
// ring slot: its 16 bytes in pieces the row's alignment allows (zeros past
// the row's end), and on lane 31 the two columns after them into the
// warp's slot.  Rows only 2-byte aligned (bf16) are below cp.async's 4
// bytes: loaded into registers and stored.
template <typename T>
__device__ __forceinline__ void issue_row(uint4* slot, uint2* eslot, const T* img,
                                          int r, int r1, int W, int c, int lane) {
    constexpr int V = kVec<T>, E = (int)sizeof(T);
    if (r >= r1) return;
    const T* row = img + (size_t)r * W;
    const char* src = reinterpret_cast<const char*>(row + c);
    const char* safe = reinterpret_cast<const char*>(row);   // read no byte
    char* dst = reinterpret_cast<char*>(slot);
    const int bytes = access_bytes(row);
    const int vb = clamp_bytes((W - c) * E, 16);
    if (bytes == 16) {
        cp_async<16>(dst, vb ? src : safe, vb);
    } else if (bytes == 8) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            const int b = clamp_bytes(vb - 8 * j, 8);
            cp_async<8>(dst + 8 * j, b ? src + 8 * j : safe, b);
        }
    } else if (bytes == 4) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int b = clamp_bytes(vb - 4 * j, 4);
            cp_async<4>(dst + 4 * j, b ? src + 4 * j : safe, b);
        }
    } else {
        uint32_t w[4];
        load_cols<T>(w, row + c, W - c);
        *slot = make_uint4(w[0], w[1], w[2], w[3]);
    }
    if (lane == 31) {
        const char* esrc = src + 16;
        char* edst = reinterpret_cast<char*>(eslot);
        const int eb = clamp_bytes((W - c - V) * E, 2 * E);
        if (bytes >= 2 * E) {
            cp_async<2 * E>(edst, eb ? esrc : safe, eb);
        } else if constexpr (E == 4) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int b = clamp_bytes(eb - 4 * j, 4);
                cp_async<4>(edst + 4 * j, b ? esrc + 4 * j : safe, b);
            }
        } else {
            const uint32_t e0 = eb > 0 ? load_bits<T>(row + c + V) : 0u;
            const uint32_t e1 = eb > E ? load_bits<T>(row + c + V + 1) : 0u;
            *reinterpret_cast<uint32_t*>(eslot) = e0 | (e1 << 16);
        }
    }
}

template <typename T>
__global__ void __launch_bounds__(K1_THREADS, kMinBlocks<T>)
stencil_walk_kernel(const T* __restrict__ img, const float* __restrict__ wx,
                    const float* __restrict__ wy, T* __restrict__ out,
                    int H, int W, int run) {
    constexpr int V = kVec<T>;
    const int Hout = H - 2, Wout = W - 2;
    const int lane = threadIdx.x & 31;
    const int c = (blockIdx.x * blockDim.x + threadIdx.x) * V;   // first column
    const int o0 = blockIdx.y * run;                 // the run's first output row
    const int r1 = min(o0 + run, Hout) + 2;          // past its last input row
    const int out_valid = Wout - c;
    const float x0 = wx[0], x1 = wx[1], x2 = wx[2];
    const float y0 = wy[0], y1 = wy[1], y2 = wy[2];

    extern __shared__ uint4 smem[];
    uint4* slot = smem + threadIdx.x;                 // slot s: slot[s * blockDim.x]
    uint2* eslot = reinterpret_cast<uint2*>(smem + RING * blockDim.x) + (threadIdx.x >> 5);
    const int warps = blockDim.x >> 5;
#pragma unroll
    for (int s = 0; s < RING; ++s) {
        issue_row<T>(slot + s * blockDim.x, eslot + s * warps, img, o0 + s, r1, W, c, lane);
        cp_async_commit();
    }

    float b2[V] = {}, b1[V] = {};    // bx rows r-2 and r-1
    for (int base = o0; base < r1; base += RING) {
#pragma unroll
        for (int s = 0; s < RING; ++s) {
            const int r = base + s;
            if (r >= r1) break;                      // uniform over the block
            cp_async_wait<RING - 1>();               // row r has landed
            const uint4 v = slot[s * blockDim.x];
            const uint32_t w[4] = {v.x, v.y, v.z, v.w};
            float x[V + 2];
#pragma unroll
            for (int k = 0; k < V; ++k) x[k] = elem<T>(w, k);
            // columns c+V, c+V+1: the next lane's first two
            if constexpr (sizeof(T) == 4) {
                x[V] = __shfl_down_sync(0xffffffffu, x[0], 1);
                x[V + 1] = __shfl_down_sync(0xffffffffu, x[1], 1);
            } else {
                const uint32_t n = __shfl_down_sync(0xffffffffu, w[0], 1);
                x[V] = __uint_as_float(n << 16);
                x[V + 1] = __uint_as_float(n & 0xffff0000u);
            }
            if (lane == 31) {
                const uint2 e = eslot[s * warps];
                if constexpr (sizeof(T) == 4) {
                    x[V] = __uint_as_float(e.x);
                    x[V + 1] = __uint_as_float(e.y);
                } else {
                    x[V] = __uint_as_float(e.x << 16);
                    x[V + 1] = __uint_as_float(e.x & 0xffff0000u);
                }
            }
            float bx[V];
#pragma unroll
            for (int k = 0; k < V; ++k) bx[k] = tap3(x[k], x[k + 1], x[k + 2], x0, x1, x2);
            // the slot's next row, once this row's values are in registers
            issue_row<T>(slot + s * blockDim.x, eslot + s * warps, img, r + RING, r1, W, c, lane);
            cp_async_commit();
            if (r - o0 >= 2) {
                float o[V];
#pragma unroll
                for (int k = 0; k < V; ++k) o[k] = tap3(b2[k], b1[k], bx[k], y0, y1, y2);
                T* orow = out + (size_t)(r - 2) * Wout;
                if (out_valid > 0)
                    store_cols<T>(orow + c, o, out_valid, access_bytes(orow));
            }
#pragma unroll
            for (int k = 0; k < V; ++k) { b2[k] = b1[k]; b1[k] = bx[k]; }
        }
    }
}

template <typename T>
static int launch(const void* img, const void* wx, const void* wy, void* out,
                  int H, int W, int br, int halo, int strips, int runs,
                  int threads, int run, int smem, void* stream) {
    constexpr int V = kVec<T>;
    const long Hout = H - 2, Wout = W - 2, strip = (long)threads * V;
    if (H < 3 || W < 3 || br < 1 || halo < 2 || Hout % br != 0)
        return (int)cudaErrorInvalidValue;
    // the geometry must cover every output element exactly once
    if (threads < 32 || threads % 32 != 0 || threads > K1_THREADS
        || smem != RING * threads * 16 + RING * (threads / 32) * 8
        || run < 1 || run % br != 0 || runs > 65535
        || strips * strip < Wout || (strips - 1) * strip >= Wout
        || (long)runs * run < Hout || (long)(runs - 1) * run >= Hout)
        return (int)cudaErrorInvalidValue;
    const dim3 grid(strips, runs);
    stencil_walk_kernel<T><<<grid, threads, smem, (cudaStream_t)stream>>>(
        (const T*)img, (const float*)wx, (const float*)wy, (T*)out, H, W, run);
    return (int)cudaGetLastError();
}

extern "C" int stencil_pipeline_f32(const void* img, const void* wx, const void* wy,
                                    void* out, int H, int W, int br, int halo,
                                    int strips, int runs, int threads, int run,
                                    int smem, void* stream) {
    return launch<float>(img, wx, wy, out, H, W, br, halo, strips, runs, threads,
                         run, smem, stream);
}

extern "C" int stencil_pipeline_bf16(const void* img, const void* wx, const void* wy,
                                     void* out, int H, int W, int br, int halo,
                                     int strips, int runs, int threads, int run,
                                     int smem, void* stream) {
    return launch<__nv_bfloat16>(img, wx, wy, out, H, W, br, halo, strips, runs,
                                 threads, run, smem, stream);
}

extern "C" const char* repro_error_string(int e) {
    return cudaGetErrorString((cudaError_t)e);
}
