// x + FeedForward(rmsnorm(x)) for Hopper (sm_90a):
//   x + GELU_erf(rmsnorm(x)·γ·W1 + b1)·W2 + b2
//
// Replaces the Pallas TPU kernel _ff_kernel behind
// audio_separator_tpu/ops/attention_block.py::fused_ff_block.
//
// What bounds it on the card: the two products (d 512 -> 2048 -> 512 over
// B·n_pad tokens) do about two thousand FLOP per byte of input and output in
// bf16 at the flagship shapes, so it is compute-bound.
//
// Design, as three launches on the caller's stream:
//   1. RMSNorm: xn = rmsnorm(x)·γ rounded to the input type.
//   2. The first GEMM (tiles.cuh: a persistent wgmma pipeline fed by TMA,
//      two consumer warpgroups taking turns so that one's epilogue overlaps
//      the other's products; bf16 reads W1 as it lies through the transpose
//      bit, float32 runs three TF32 products a term on W1's prepared form,
//      gemm_tf32.cuh); the epilogue, on the accumulator registers, adds b1,
//      applies the exact-erf GELU and stores the hidden activation rounded to
//      the input type, as the TPU kernel does. At K = 512 this epilogue, not
//      the product, sets the launch's time in bf16, hence the cheap erf below.
//   3. The second GEMM with the bias and the residual add in its epilogue; with
//      partial set, the product alone (a tensor-parallel shard of the layer
//      over a slice of the hidden columns: its caller adds x, b2 and the other
//      shards' partial products).
// xn and the hidden activation (B·n_pad x hidden) round-trip through device
// memory; keeping the hidden activation on chip is later work.
#include "tiles.cuh"

namespace asep {

// The exact (erf) GELU y·Φ(y), Φ(y) = (1 + erf(y/√2))/2. float32 calls erff.
// For bf16, whose result is rounded to 2^-9 of its size, Φ comes from a
// branch-free rational form of erfc (Abramowitz & Stegun 7.1.26, |error| <=
// 1.5e-7 before the special-function units' last-place errors, some 3e-7 in
// all): u = P(t)·exp(-y²/2)/2 with t = 1/(1 + p·|y|/√2) is Φ(-|y|). It costs a
// third of erff's instructions, and the first product's epilogue is bound by
// them.
template <typename T> __device__ __forceinline__ float gelu(float y) {
    if constexpr (sizeof(T) == 4) {
        return 0.5f * y * (1.f + erff(y * 0.7071067811865476f));
    } else {
        const float t = rcp(fmaf(0.3275911f * 0.7071067811865476f, fabsf(y), 1.f));
        float p = fmaf(0.5f * 1.061405429f, t, 0.5f * -1.453152027f);
        p = fmaf(p, t, 0.5f * 1.421413741f);
        p = fmaf(p, t, 0.5f * -0.284496736f);
        p = fmaf(p, t, 0.5f * 0.254829592f);
        const float u = p * t * ex2(y * y * (-0.5f * LOG2E));
        return fmaf(-fabsf(y), u, fmaxf(y, 0.f));  // y·(1 - u) or y·u by the sign of y
    }
}

// hidden % 64 == 0: every call covers a full run of eight columns.
template <typename T> struct GeluEpi {
    const T* bias;
    T* h;
    int cols;
    struct Pre {};  // the bias is a cache hit, read where it is used
    static constexpr int PREFETCH = 8;
    __device__ Pre prefetch(int, int) const { return {}; }
    __device__ void operator()(const float* row, int c0, int, int grow, int gcol0,
                               const Pre&) const {
        float g[8], bv[8];
        load8_ro(bias + gcol0, bv);
#pragma unroll
        for (int e = 0; e < 8; ++e) g[e] = gelu<T>(row[c0 + e] + bv[e]);
        store8(h + (size_t)grow * cols + gcol0, g);
    }
};

template <typename T>
int run_ff_block(const T* x, const T* norm, const T* w1, const T* b1, const T* w2, const T* b2,
                 T* xn, T* h, T* out, int rows, int d_model, int hidden, bool partial,
                 cudaStream_t stream) {
    cudaError_t err = run_rmsnorm(x, norm, xn, rows, d_model, stream);
    if (err != cudaSuccess) return err;
    const GeluEpi<T> gelu_epi{b1, h, hidden};
    err = run_gemm(static_cast<const T*>(xn), w1, hidden, rows, d_model, gelu_epi, stream);
    if (err != cudaSuccess) return err;
    const ResidualEpi<T> out_epi = partial ? ResidualEpi<T>{nullptr, nullptr, out, d_model}
                                           : ResidualEpi<T>{x, b2, out, d_model};
    return run_gemm(static_cast<const T*>(h), w2, d_model, rows, hidden, out_epi, stream);
}

}  // namespace asep

// dtype: 0 = float32, 1 = bfloat16. rows = B * n_pad; w1 and w2 are the (K, N)
// weights in bf16 and their prepared 3xTF32 forms (2, N, K) in float32
// (ops/tf32.py); xn and h are scratch the caller allocates. partial != 0
// writes h·W2 without b2 (which may be null then) and the residual. Returns 0
// or the first CUDA error.
extern "C" int asep_ff_block(int dtype, const void* x, const void* norm, const void* w1,
                             const void* b1, const void* w2, const void* b2, void* xn, void* h,
                             void* out, int rows, int d_model, int hidden, int partial,
                             void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto run = [&](auto tag) {
        using T = decltype(tag);
        return asep::run_ff_block<T>(
            static_cast<const T*>(x), static_cast<const T*>(norm), static_cast<const T*>(w1),
            static_cast<const T*>(b1), static_cast<const T*>(w2), static_cast<const T*>(b2),
            static_cast<T*>(xn), static_cast<T*>(h), static_cast<T*>(out), rows, d_model,
            hidden, partial != 0, s);
    };
    return dtype == 0 ? run(float{}) : run(asep::bf16{});
}
