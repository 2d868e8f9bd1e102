// GELU(erf) backward (K3) for Hopper (sm_90a), float32, with the bias
// already in pre (pre = xn·W1 + b1):
//   dpre = dh ⊙ (Φ(pre) + pre·φ(pre)),   h = pre·Φ(pre),
// Φ(y) = (1 + erf(y/√2))/2, φ(y) = exp(−y²/2)/√(2π).
//
// The gradient of the feed-forward activation inside the Pallas TPU kernel
// _ff_kernel (audio_separator_tpu/ops/attention_block.py::fused_ff_block),
// which the JAX package cannot differentiate. It also writes h, the
// activation the second product's weight gradient needs, so the forward need
// not keep its (rows, hidden) activation for the backward pass.
//
// What bounds it on the card: bytes (two values read, two written, some
// thirty operations each). Design: one elementwise pass, 16-byte loads and
// stores, a grid-stride loop.
#include "bwd_common.cuh"

namespace asep {

__device__ __forceinline__ void gelu_grad(float y, float g, float& dpre, float& h) {
    const float cdf = 0.5f * (1.f + erff(y * 0.7071067811865476f));
    const float pdf = expf(-0.5f * y * y) * 0.3989422804014327f;
    dpre = g * fmaf(y, pdf, cdf);
    h = y * cdf;
}

__global__ void __launch_bounds__(256)
    gelu_bwd_kernel(const float4* __restrict__ pre, const float4* __restrict__ dh,
                    float4* __restrict__ dpre, float4* __restrict__ h, long long n4) {
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
         i += (long long)gridDim.x * blockDim.x) {
        const float4 y = pre[i], g = dh[i];
        float4 dp, hv;
        gelu_grad(y.x, g.x, dp.x, hv.x);
        gelu_grad(y.y, g.y, dp.y, hv.y);
        gelu_grad(y.z, g.z, dp.z, hv.z);
        gelu_grad(y.w, g.w, dp.w, hv.w);
        dpre[i] = dp;
        h[i] = hv;
    }
}

}  // namespace asep

// pre, dh, dpre, h: n float32 values each, contiguous, 16-byte aligned,
// n % 4 == 0. Returns 0 or the first CUDA error.
extern "C" int asep_gelu_bwd(const void* pre, const void* dh, void* dpre, void* h, long long n,
                             void* stream) {
    if (n < 4 || n % 4) return cudaErrorInvalidValue;
    const long long n4 = n / 4;
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const long long want = (n4 + 255) / 256, cap = (long long)sms * 16;
    return asep::launch_bwd(asep::gelu_bwd_kernel, dim3((unsigned)(want < cap ? want : cap)), 256,
                            0, static_cast<cudaStream_t>(stream),
                            static_cast<const float4*>(pre), static_cast<const float4*>(dh),
                            static_cast<float4*>(dpre), static_cast<float4*>(h), n4);
}
