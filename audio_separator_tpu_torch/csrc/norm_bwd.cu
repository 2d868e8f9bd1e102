// RMSNorm backward (K2) for Hopper (sm_90a), in the form the fused RoFormer
// blocks normalise (xn = x·r·√d·γ, r = rsqrt(max(Σx², 1e-24))):
//   du = dxn·γ·√d,
//   dx = dres + r·du − [Σx² >= 1e-24]·r³·x·Σ(du·x),
//   dγ = Σ_rows dxn·x·r·√d.
// Two forms: float32, and bf16 (x, dxn, dres and dx bf16, the bf16 training
// step's); both compute in float32, and dγ is float32 in both.
//
// The gradient of the norm inside the Pallas TPU kernels _layer_kernel and
// _ff_kernel (audio_separator_tpu/ops/attention_block.py), which the JAX
// package cannot differentiate; dres is the residual's gradient, added here
// so that the block's dx is written once.
//
// What bounds it on the card: bytes. It reads x, dxn, dres and writes dx,
// four values a value (16 bytes in float32, 8 in bf16) for 8 operations, far
// below the ridge point. Design: one warp a row (16-byte loads, four float32
// or eight bf16 values a lane a pass); the row's two sums by shuffles; dγ in
// two stages: each warp adds its rows' terms into its own row of shared
// memory, each block writes its sum to a partial row (no atomics, so the
// result does not depend on the order the blocks run in), and a second
// launch sums the partial rows a column a thread.
#include "bwd_common.cuh"

namespace asep {

constexpr int NORM_THREADS = 256;
constexpr int NORM_WARPS = NORM_THREADS / 32;

template <typename T>
__global__ void __launch_bounds__(NORM_THREADS)
    norm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                    const T* __restrict__ dxn, const T* __restrict__ dres, T* __restrict__ dx,
                    float* __restrict__ partial, int rows, int d) {
    constexpr int V = VEC<T>;
    extern __shared__ float acc[];  // (NORM_WARPS, d): each warp's dγ terms
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    float* mine = acc + (size_t)warp * d;
    for (int c = V * lane; c < d; c += 32 * V)
#pragma unroll
        for (int j = 0; j < V; j += 4)
            *reinterpret_cast<float4*>(mine + c + j) = make_float4(0.f, 0.f, 0.f, 0.f);
    const float sd = sqrtf((float)d);
    for (int row = blockIdx.x * NORM_WARPS + warp; row < rows; row += gridDim.x * NORM_WARPS) {
        const size_t o = (size_t)row * d;
        float ssq = 0.f, dot = 0.f;
        for (int c = V * lane; c < d; c += 32 * V) {
            float xv[V], gv[V], gm[V];
            load_vec(x + o + c, xv);
            load_vec(dxn + o + c, gv);
            load_f32<V>(gamma + c, gm);
            float part = 0.f;
#pragma unroll
            for (int i = V - 1; i >= 0; --i) ssq = fmaf(xv[i], xv[i], ssq);
#pragma unroll
            for (int i = 0; i < V; ++i) part += gv[i] * gm[i] * xv[i];
            dot += part;
        }
        ssq = warp_sum(ssq);
        dot = warp_sum(dot) * sd;  // Σ du·x
        const float r = 1.f / sqrtf(fmaxf(ssq, 1e-24f));
        const float corr = ssq >= 1e-24f ? r * r * r * dot : 0.f;
        const float rs = r * sd;
        for (int c = V * lane; c < d; c += 32 * V) {
            float xv[V], gv[V], gm[V], rv[V], out[V], a[V];
            load_vec(x + o + c, xv);
            load_vec(dxn + o + c, gv);
            load_f32<V>(gamma + c, gm);
            load_f32<V>(mine + c, a);
            if (dres != nullptr) {
                load_vec(dres + o + c, rv);
            } else {
#pragma unroll
                for (int i = 0; i < V; ++i) rv[i] = 0.f;
            }
#pragma unroll
            for (int i = 0; i < V; ++i) {
                out[i] = rv[i] + rs * gv[i] * gm[i] - corr * xv[i];
                a[i] = fmaf(gv[i] * xv[i], rs, a[i]);
            }
            store_vec(dx + o + c, out);
#pragma unroll
            for (int j = 0; j < V; j += 4)
                *reinterpret_cast<float4*>(mine + c + j) =
                    make_float4(a[j], a[j + 1], a[j + 2], a[j + 3]);
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

template <typename T>
cudaError_t run_norm_bwd(const void* x, const void* gamma, const void* dxn, const void* dres,
                         void* dx, void* partial, void* dgamma, int rows, int d, int blocks,
                         cudaStream_t s) {
    if (rows < 1 || d < VEC<T> || d % VEC<T> || blocks < 1) return cudaErrorInvalidValue;
    const cudaError_t err = launch_bwd(
        norm_bwd_kernel<T>, dim3(blocks), NORM_THREADS, (size_t)NORM_WARPS * d * sizeof(float),
        s, static_cast<const T*>(x), static_cast<const float*>(gamma),
        static_cast<const T*>(dxn), static_cast<const T*>(dres), static_cast<T*>(dx),
        static_cast<float*>(partial), rows, d);
    if (err != cudaSuccess) return err;
    return launch_bwd(norm_bwd_reduce_kernel, dim3((d + NORM_THREADS - 1) / NORM_THREADS),
                      NORM_THREADS, 0, s, static_cast<const float*>(partial),
                      static_cast<float*>(dgamma), blocks, d);
}

}  // namespace asep

// dtype: 0 = float32, 1 = bfloat16, the type of x, dxn, dres (or null) and dx,
// (rows, d); gamma and dgamma (d) and partial ((blocks, d) scratch, blocks the
// first launch's grid) are float32. Contiguous, 16-byte aligned, d a multiple
// of 4 (float32) or 8 (bf16). Returns 0 or the first CUDA error.
extern "C" int asep_norm_bwd(int dtype, const void* x, const void* gamma, const void* dxn,
                             const void* dres, void* dx, void* partial, void* dgamma, int rows,
                             int d, int blocks, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return asep::run_norm_bwd<float>(x, gamma, dxn, dres, dx, partial, dgamma, rows, d,
                                         blocks, s);
    if (dtype == 1)
        return asep::run_norm_bwd<asep::bf16>(x, gamma, dxn, dres, dx, partial, dgamma, rows, d,
                                              blocks, s);
    return cudaErrorInvalidValue;
}
