// GELU(erf) backward (K3) for Hopper (sm_90a), with the bias already in pre
// (pre = xn·W1 + b1):
//   dpre = dh ⊙ (Φ(pre) + pre·φ(pre)),   h = pre·Φ(pre),
// Φ(y) = (1 + erf(y/√2))/2, φ(y) = exp(−y²/2)/√(2π). Two forms: float32, and
// bf16 (pre and dh read, dpre and h written as bf16, the bf16 training
// step's), both computing in float32.
//
// The gradient of the feed-forward activation inside the Pallas TPU kernel
// _ff_kernel (audio_separator_tpu/ops/attention_block.py::fused_ff_block),
// which the JAX package cannot differentiate. It also writes h, the
// activation the second product's weight gradient needs, so the forward need
// not keep its (rows, hidden) activation for the backward pass.
//
// What bounds it on the card: bytes (two values read, two written, some
// thirty operations each). Design: one elementwise pass, 16-byte loads and
// stores (four float32 or eight bf16 values a thread), a grid-stride loop.
#include "bwd_common.cuh"

namespace asep {

__device__ __forceinline__ void gelu_grad(float y, float g, float& dpre, float& h) {
    const float cdf = 0.5f * (1.f + erff(y * 0.7071067811865476f));
    const float pdf = expf(-0.5f * y * y) * 0.3989422804014327f;
    dpre = g * fmaf(y, pdf, cdf);
    h = y * cdf;
}

template <typename T>
__global__ void __launch_bounds__(256)
    gelu_bwd_kernel(const T* __restrict__ pre, const T* __restrict__ dh, T* __restrict__ dpre,
                    T* __restrict__ h, long long nv) {
    constexpr int V = VEC<T>;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < nv;
         i += (long long)gridDim.x * blockDim.x) {
        float y[V], g[V], dp[V], hv[V];
        load_vec(pre + i * V, y);
        load_vec(dh + i * V, g);
#pragma unroll
        for (int j = 0; j < V; ++j) gelu_grad(y[j], g[j], dp[j], hv[j]);
        store_vec(dpre + i * V, dp);
        store_vec(h + i * V, hv);
    }
}

template <typename T>
cudaError_t run_gelu_bwd(const void* pre, const void* dh, void* dpre, void* h, long long n,
                         cudaStream_t stream) {
    constexpr int V = VEC<T>;
    if (n < V || n % V) return cudaErrorInvalidValue;
    const long long nv = n / V;
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const long long want = (nv + 255) / 256, cap = (long long)sms * 16;
    return launch_bwd(gelu_bwd_kernel<T>, dim3((unsigned)(want < cap ? want : cap)), 256, 0,
                      stream, static_cast<const T*>(pre), static_cast<const T*>(dh),
                      static_cast<T*>(dpre), static_cast<T*>(h), nv);
}

}  // namespace asep

// dtype: 0 = float32, 1 = bfloat16. pre, dh, dpre, h: n values each,
// contiguous, 16-byte aligned, n a multiple of 4 (float32) or 8 (bf16).
// Returns 0 or the first CUDA error.
extern "C" int asep_gelu_bwd(int dtype, const void* pre, const void* dh, void* dpre, void* h,
                             long long n, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return asep::run_gelu_bwd<float>(pre, dh, dpre, h, n, s);
    if (dtype == 1) return asep::run_gelu_bwd<asep::bf16>(pre, dh, dpre, h, n, s);
    return cudaErrorInvalidValue;
}
