// RoPE and gate backward (K4) for Hopper (sm_90a): the attention block's
// step from the attention's gradients back to its two products. Two forms:
// float32, and bf16 (dq, dk, dv read and dqkv written as bf16, the bf16
// training step's); the RoPE tables, the gates, Δ and dz are float32 in
// both, as the forward keeps the gates, and the rotation is computed in
// float32.
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
// thread per 16 bytes (four float32 or eight bf16 lanes, two or four RoPE
// pairs) of one (row, q|k|v, head), 16-byte loads and stores; neighbouring
// threads write neighbouring dqkv lanes.
#include "bwd_common.cuh"

namespace asep {

template <typename T>
__global__ void __launch_bounds__(256)
    rope_gate_bwd_kernel(const T* __restrict__ dq, const T* __restrict__ dk,
                         const T* __restrict__ dv, const float* __restrict__ cos_t,
                         const float* __restrict__ sin_t, const float* __restrict__ delta,
                         const float* __restrict__ gates, T* __restrict__ dqkv,
                         float* __restrict__ dz, int batch, int n_pad, int heads) {
    constexpr int V = VEC<T>, PER_HEAD = 64 / V;
    const long long total = (long long)batch * n_pad * 3 * heads * PER_HEAD;
    for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < total;
         t += (long long)gridDim.x * blockDim.x) {
        const int cv = (int)(t % PER_HEAD);
        long long rest = t / PER_HEAD;
        const int head = (int)(rest % heads);
        rest /= heads;
        const int which = (int)(rest % 3);
        const long long row = rest / 3;  // b·n_pad + n
        const int b = (int)(row / n_pad), n = (int)(row % n_pad);
        const long long hrow = ((long long)b * heads + head) * n_pad + n;
        const T* src = which == 0 ? dq : (which == 1 ? dk : dv);
        float g[V], out[V];
        load_vec(src + hrow * 64 + V * cv, g);
#pragma unroll
        for (int i = 0; i < V; ++i) out[i] = g[i];
        if (which < 2 && cos_t != nullptr) {
            float cs[V], sn[V];
            load_f32<V>(cos_t + (long long)n * 64 + V * cv, cs);
            load_f32<V>(sin_t + (long long)n * 64 + V * cv, sn);
#pragma unroll
            for (int i = 0; i < V; i += 2) {
                out[i] = cs[i] * g[i] + sn[i + 1] * g[i + 1];
                out[i + 1] = cs[i + 1] * g[i + 1] - sn[i] * g[i];
            }
        }
        store_vec(dqkv + row * 3 * heads * 64 + (which * heads + head) * 64 + V * cv, out);
        if (which == 0 && cv == 0) dz[row * heads + head] = (1.f - gates[hrow]) * delta[hrow];
    }
}

template <typename T>
cudaError_t run_rope_gate_bwd(const void* dq, const void* dk, const void* dv, const void* cos_t,
                              const void* sin_t, const void* delta, const void* gates,
                              void* dqkv, void* dz, int batch, int n_pad, int heads,
                              cudaStream_t stream) {
    const long long total = (long long)batch * n_pad * 3 * heads * (64 / VEC<T>);
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const long long want = (total + 255) / 256, cap = (long long)sms * 16;
    return launch_bwd(
        rope_gate_bwd_kernel<T>, dim3((unsigned)(want < cap ? want : cap)), 256, 0, stream,
        static_cast<const T*>(dq), static_cast<const T*>(dk), static_cast<const T*>(dv),
        static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
        static_cast<const float*>(delta), static_cast<const float*>(gates),
        static_cast<T*>(dqkv), static_cast<float*>(dz), batch, n_pad, heads);
}

}  // namespace asep

// dtype: 0 = float32, 1 = bfloat16, the type of dq, dk, dv: (batch·heads,
// n_pad, 64) and dqkv: (batch, n_pad, 3·heads·64); cos, sin: (n_pad, 64)
// float32, or both null (no RoPE); delta, gates: (batch·heads, n_pad) and dz:
// (batch, n_pad, heads) float32. Contiguous, 16-byte aligned. Returns 0 or
// the first CUDA error.
extern "C" int asep_rope_gate_bwd(int dtype, const void* dq, const void* dk, const void* dv,
                                  const void* cos_t, const void* sin_t, const void* delta,
                                  const void* gates, void* dqkv, void* dz, int batch, int n_pad,
                                  int heads, void* stream) {
    if (batch < 1 || n_pad < 1 || heads < 1 || (cos_t == nullptr) != (sin_t == nullptr))
        return cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return asep::run_rope_gate_bwd<float>(dq, dk, dv, cos_t, sin_t, delta, gates, dqkv, dz,
                                              batch, n_pad, heads, s);
    if (dtype == 1)
        return asep::run_rope_gate_bwd<asep::bf16>(dq, dk, dv, cos_t, sin_t, delta, gates, dqkv,
                                                   dz, batch, n_pad, heads, s);
    return cudaErrorInvalidValue;
}
