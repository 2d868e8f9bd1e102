// RMSNorm backward (K2) for Hopper (sm_90a), float32, in the form the fused
// RoFormer blocks normalise (xn = x·r·√d·γ, r = rsqrt(max(Σx², 1e-24))):
//   du = dxn·γ·√d,
//   dx = dres + r·du − [Σx² >= 1e-24]·r³·x·Σ(du·x),
//   dγ = Σ_rows dxn·x·r·√d.
//
// The gradient of the norm inside the Pallas TPU kernels _layer_kernel and
// _ff_kernel (audio_separator_tpu/ops/attention_block.py), which the JAX
// package cannot differentiate; dres is the residual's gradient, added here
// so that the block's dx is written once.
//
// What bounds it on the card: bytes. It reads x, dxn, dres and writes dx,
// about 16 bytes a value for 8 operations, far below the ridge point.
// Design: one warp a row (16-byte loads, four values a lane a pass); the
// row's two sums by shuffles; dγ in two stages: each warp adds its rows'
// terms into its own row of shared memory, each block writes its sum to a
// partial row (no atomics, so the result does not depend on the order the
// blocks run in), and a second launch sums the partial rows a column a
// thread.
#include "bwd_common.cuh"

namespace asep {

constexpr int NORM_THREADS = 256;
constexpr int NORM_WARPS = NORM_THREADS / 32;

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

__global__ void __launch_bounds__(NORM_THREADS)
    norm_bwd_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
                    const float* __restrict__ dxn, const float* __restrict__ dres,
                    float* __restrict__ dx, float* __restrict__ partial, int rows, int d) {
    extern __shared__ float acc[];  // (NORM_WARPS, d): each warp's dγ terms
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    float* mine = acc + (size_t)warp * d;
    for (int c = 4 * lane; c < d; c += 128)
        *reinterpret_cast<float4*>(mine + c) = make_float4(0.f, 0.f, 0.f, 0.f);
    const float sd = sqrtf((float)d);
    for (int row = blockIdx.x * NORM_WARPS + warp; row < rows; row += gridDim.x * NORM_WARPS) {
        const size_t o = (size_t)row * d;
        float ssq = 0.f, dot = 0.f;
        for (int c = 4 * lane; c < d; c += 128) {
            const float4 xv = ld4(x + o + c), gv = ld4(dxn + o + c), gm = ld4(gamma + c);
            ssq = fmaf(xv.x, xv.x, fmaf(xv.y, xv.y, fmaf(xv.z, xv.z, fmaf(xv.w, xv.w, ssq))));
            dot += gv.x * gm.x * xv.x + gv.y * gm.y * xv.y + gv.z * gm.z * xv.z + gv.w * gm.w * xv.w;
        }
        ssq = warp_sum(ssq);
        dot = warp_sum(dot) * sd;  // Σ du·x
        const float r = 1.f / sqrtf(fmaxf(ssq, 1e-24f));
        const float corr = ssq >= 1e-24f ? r * r * r * dot : 0.f;
        const float rs = r * sd;
        for (int c = 4 * lane; c < d; c += 128) {
            const float4 xv = ld4(x + o + c), gv = ld4(dxn + o + c), gm = ld4(gamma + c);
            const float4 rv =
                dres != nullptr ? ld4(dres + o + c) : make_float4(0.f, 0.f, 0.f, 0.f);
            float4 out;
            out.x = rv.x + rs * gv.x * gm.x - corr * xv.x;
            out.y = rv.y + rs * gv.y * gm.y - corr * xv.y;
            out.z = rv.z + rs * gv.z * gm.z - corr * xv.z;
            out.w = rv.w + rs * gv.w * gm.w - corr * xv.w;
            *reinterpret_cast<float4*>(dx + o + c) = out;
            float4 a = *reinterpret_cast<float4*>(mine + c);
            a.x = fmaf(gv.x * xv.x, rs, a.x);
            a.y = fmaf(gv.y * xv.y, rs, a.y);
            a.z = fmaf(gv.z * xv.z, rs, a.z);
            a.w = fmaf(gv.w * xv.w, rs, a.w);
            *reinterpret_cast<float4*>(mine + c) = a;
        }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < d; c += NORM_THREADS) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < NORM_WARPS; ++w) s += acc[(size_t)w * d + c];
        partial[(size_t)blockIdx.x * d + c] = s;
    }
}

__global__ void __launch_bounds__(NORM_THREADS)
    norm_bwd_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dgamma,
                           int blocks, int d) {
    const int c = blockIdx.x * NORM_THREADS + threadIdx.x;
    if (c >= d) return;
    float s = 0.f;
    for (int b = 0; b < blocks; ++b) s += partial[(size_t)b * d + c];
    dgamma[c] = s;
}

}  // namespace asep

// x, dxn, dres (or null), dx: (rows, d); gamma, dgamma: (d); partial: (blocks,
// d) scratch, blocks the first launch's grid. float32, contiguous, 16-byte
// aligned, d % 4 == 0. Returns 0 or the first CUDA error.
extern "C" int asep_norm_bwd(const void* x, const void* gamma, const void* dxn,
                             const void* dres, void* dx, void* partial, void* dgamma, int rows,
                             int d, int blocks, void* stream) {
    if (rows < 1 || d < 4 || d % 4 || blocks < 1) return cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = asep::launch_bwd(
        asep::norm_bwd_kernel, dim3(blocks), asep::NORM_THREADS,
        (size_t)asep::NORM_WARPS * d * sizeof(float), s, static_cast<const float*>(x),
        static_cast<const float*>(gamma), static_cast<const float*>(dxn),
        static_cast<const float*>(dres), static_cast<float*>(dx), static_cast<float*>(partial),
        rows, d);
    if (err != cudaSuccess) return err;
    return asep::launch_bwd(asep::norm_bwd_reduce_kernel,
                            dim3((d + asep::NORM_THREADS - 1) / asep::NORM_THREADS),
                            asep::NORM_THREADS, 0, s, static_cast<const float*>(partial),
                            static_cast<float*>(dgamma), blocks, d);
}
