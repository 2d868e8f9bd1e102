// RoPE and gate backward (K4) for Hopper (sm_90a), float32: the attention
// block's step from the attention's gradients back to its two products.
//   * RoPE: q_rot = q·cos + rotate_half(q)·sin, and rotate_half's transpose
//     is −rotate_half, so for each pair (2i, 2i+1)
//       dq[2i]   = cos[2i]·g[2i] + sin[2i+1]·g[2i+1],
//       dq[2i+1] = cos[2i+1]·g[2i+1] − sin[2i]·g[2i]
//     (the same for k; v passes through), packed as the QKV product's output
//     dqkv (B, n_pad, 3·heads·64), which is (q|k|v, head, lane) a row;
//   * gate: merged = o·σ(z) and σ' = g(1 − g), so
//       dz = (1 − g)·Σ_lanes(d_merged ⊙ merged) = (1 − g)·Δ,
//     Δ being the row sum the attention backward (attention_bwd.cu) already
//     wrote; nothing is divided by a gate. dz is (B, n_pad, heads).
//
// The gradient of the RoPE and gate steps inside the Pallas TPU kernel
// _layer_kernel (audio_separator_tpu/ops/attention_block.py::
// fused_attention_block), which the JAX package cannot differentiate.
//
// What bounds it on the card: bytes (dq, dk, dv read and dqkv written once,
// a few operations a value). Design: a grid-stride elementwise pass, a
// thread per four lanes (two RoPE pairs) of one (row, q|k|v, head), 16-byte
// loads and stores; neighbouring threads write neighbouring dqkv lanes.
#include "bwd_common.cuh"

namespace asep {

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

__global__ void __launch_bounds__(256)
    rope_gate_bwd_kernel(const float* __restrict__ dq, const float* __restrict__ dk,
                         const float* __restrict__ dv, const float* __restrict__ cos_t,
                         const float* __restrict__ sin_t, const float* __restrict__ delta,
                         const float* __restrict__ gates, float* __restrict__ dqkv,
                         float* __restrict__ dz, int batch, int n_pad, int heads) {
    const long long total = (long long)batch * n_pad * 3 * heads * 16;
    for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < total;
         t += (long long)gridDim.x * blockDim.x) {
        const int c4 = (int)(t % 16);
        long long rest = t / 16;
        const int head = (int)(rest % heads);
        rest /= heads;
        const int which = (int)(rest % 3);
        const long long row = rest / 3;  // b·n_pad + n
        const int b = (int)(row / n_pad), n = (int)(row % n_pad);
        const long long hrow = ((long long)b * heads + head) * n_pad + n;
        const float* src = which == 0 ? dq : (which == 1 ? dk : dv);
        const float4 g = ld4(src + hrow * 64 + 4 * c4);
        float4 out = g;
        if (which < 2 && cos_t != nullptr) {
            const float4 cs = ld4(cos_t + (long long)n * 64 + 4 * c4);
            const float4 sn = ld4(sin_t + (long long)n * 64 + 4 * c4);
            out.x = cs.x * g.x + sn.y * g.y;
            out.y = cs.y * g.y - sn.x * g.x;
            out.z = cs.z * g.z + sn.w * g.w;
            out.w = cs.w * g.w - sn.z * g.z;
        }
        *reinterpret_cast<float4*>(dqkv + row * 3 * heads * 64 + (which * heads + head) * 64 +
                                   4 * c4) = out;
        if (which == 0 && c4 == 0) dz[row * heads + head] = (1.f - gates[hrow]) * delta[hrow];
    }
}

}  // namespace asep

// dq, dk, dv: (batch·heads, n_pad, 64); cos, sin: (n_pad, 64) or both null
// (no RoPE); delta, gates: (batch·heads, n_pad); dqkv: (batch, n_pad,
// 3·heads·64); dz: (batch, n_pad, heads). float32, contiguous, 16-byte
// aligned. Returns 0 or the first CUDA error.
extern "C" int asep_rope_gate_bwd(const void* dq, const void* dk, const void* dv,
                                  const void* cos_t, const void* sin_t, const void* delta,
                                  const void* gates, void* dqkv, void* dz, int batch, int n_pad,
                                  int heads, void* stream) {
    if (batch < 1 || n_pad < 1 || heads < 1 || (cos_t == nullptr) != (sin_t == nullptr))
        return cudaErrorInvalidValue;
    const long long total = (long long)batch * n_pad * 3 * heads * 16;
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const long long want = (total + 255) / 256, cap = (long long)sms * 16;
    return asep::launch_bwd(
        asep::rope_gate_bwd_kernel, dim3((unsigned)(want < cap ? want : cap)), 256, 0,
        static_cast<cudaStream_t>(stream), static_cast<const float*>(dq),
        static_cast<const float*>(dk), static_cast<const float*>(dv),
        static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
        static_cast<const float*>(delta), static_cast<const float*>(gates),
        static_cast<float*>(dqkv), static_cast<float*>(dz), batch, n_pad, heads);
}
