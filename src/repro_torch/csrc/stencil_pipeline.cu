// Fused separable 3x3 blur: the paper's Fig. 1 producer->consumer chain.
//
// Replaces: src/repro/kernels/stencil_pipeline.py::_kernel, the Pallas TPU
// kernel launched by _stencil_call / stencil_pipeline.
//
// What it computes: out = conv_y(conv_x(img)), "valid" on both axes, so an
// (H, W) image gives an (H-2, W-2) output.  bx = conv_x is the producer; it
// lives only in shared memory and never reaches device memory.
//
// Bound on Hopper: device memory.  The function must read H*W input
// elements and write (H-2)*(W-2) outputs; it does 10 flops per output,
// about 0.1 flop per byte, far below the 20 flop/byte at which the
// H100's fp32 units (67 TFLOP/s) would become the limit at 3.35 TB/s.
//
// Design: one block per (block_rows x TW) output tile.  The block copies its
// (block_rows + halo) x (TW + 2) line window into shared memory once
// (converting bf16 to f32), computes bx for the whole window into shared
// memory, then the block_rows output rows from it.  Neighbouring threads
// touch neighbouring columns, so the loads coalesce; the halo rows a tile
// shares with the next are read twice, mostly from L2.  The arithmetic is
// (a*w0 + b*w1) + c*w2 with the _rn intrinsics, never contracted into an
// FMA, so the result equals the plain PyTorch version and the generated
// streamed kernel for blur_chain bit for bit.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

constexpr int TW = 128;        // output columns per block
constexpr int NTHREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float tap3(float a, float b, float c,
                                      float w0, float w1, float w2) {
    return __fadd_rn(__fadd_rn(__fmul_rn(a, w0), __fmul_rn(b, w1)), __fmul_rn(c, w2));
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
stencil_kernel(const T* __restrict__ img, const float* __restrict__ wx,
               const float* __restrict__ wy, T* __restrict__ out,
               int H, int W, int br, int halo) {
    extern __shared__ float smem[];
    const int wrows = br + halo;
    float* rows = smem;                     // wrows x (TW + 2): the line window
    float* bx = smem + wrows * (TW + 2);    // wrows x TW: the producer stage
    const int Wout = W - 2;
    const int r0 = blockIdx.x * br;         // first output row = first window row
    const int c0 = blockIdx.y * TW;
    const float x0 = wx[0], x1 = wx[1], x2 = wx[2];
    const float y0 = wy[0], y1 = wy[1], y2 = wy[2];

    // rows or columns past the image are never read by a valid output
    for (int e = threadIdx.x; e < wrows * (TW + 2); e += blockDim.x) {
        const int r = e / (TW + 2), c = e % (TW + 2);
        const int gr = r0 + r, gc = c0 + c;
        rows[e] = (gr < H && gc < W) ? to_f32(img[(size_t)gr * W + gc]) : 0.f;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < wrows * TW; e += blockDim.x) {
        const int r = e / TW, c = e % TW;
        const float* p = rows + r * (TW + 2) + c;
        bx[e] = tap3(p[0], p[1], p[2], x0, x1, x2);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < br * TW; e += blockDim.x) {
        const int r = e / TW, c = e % TW;
        const int gc = c0 + c;
        if (gc >= Wout) continue;           // ragged right edge
        const float* q = bx + r * TW + c;
        store(out + (size_t)(r0 + r) * Wout + gc,
              tap3(q[0], q[TW], q[2 * TW], y0, y1, y2));
    }
}

template <typename T>
static int launch(const void* img, const void* wx, const void* wy, void* out,
                  int H, int W, int br, int halo, void* stream) {
    const int Hout = H - 2, Wout = W - 2;
    if (H < 3 || W < 3 || br < 1 || halo < 2 || Hout % br != 0)
        return (int)cudaErrorInvalidValue;
    const int smem = (br + halo) * (2 * TW + 2) * (int)sizeof(float);
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            stencil_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return (int)err;
    }
    const dim3 grid(Hout / br, (Wout + TW - 1) / TW);
    stencil_kernel<T><<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
        (const T*)img, (const float*)wx, (const float*)wy, (T*)out, H, W, br, halo);
    return (int)cudaGetLastError();
}

extern "C" int stencil_pipeline_f32(const void* img, const void* wx, const void* wy,
                                    void* out, int H, int W, int br, int halo,
                                    void* stream) {
    return launch<float>(img, wx, wy, out, H, W, br, halo, stream);
}

extern "C" int stencil_pipeline_bf16(const void* img, const void* wx, const void* wy,
                                     void* out, int H, int W, int br, int halo,
                                     void* stream) {
    return launch<__nv_bfloat16>(img, wx, wy, out, H, W, br, halo, stream);
}

extern "C" const char* repro_error_string(int e) {
    return cudaGetErrorString((cudaError_t)e);
}
