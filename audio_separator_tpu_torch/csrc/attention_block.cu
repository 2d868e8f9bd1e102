// x + gated multi-head attention of rmsnorm(x), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _layer_kernel behind
// audio_separator_tpu/ops/attention_block.py::fused_attention_block.
//
// What bounds it on the card: the products. At the flagship shapes (d 512,
// 8 heads x 64, 801 tokens padded to 832 on the time axis, 62 -> 64 on the
// frequency axis) the block does over a thousand FLOP per byte of its input
// and output, far above the H100's ridge point, so it is compute-bound.
//
// Design, as four launches on the caller's stream:
//   1. RMSNorm: xn = rmsnorm(x)·γ rounded to the input type (as the TPU
//      kernel rounds it), so the GEMMs stream their operands untouched.
//   2. A tiled GEMM of xn against [Wqkv | gate_w] (tiles.cuh: wgmma fed by TMA
//      for bf16, FMA tiles for float32). The epilogue rounds qkv to the input
//      type (as the TPU kernel does), applies the interleaved-pair RoPE from
//      the pair partner that sits in the same run of eight columns, rounds
//      again, and writes q, k, v as (B, heads, n_pad, 64); the gate columns
//      become sigmoid(. + gate_b). gate_w is (d, gate_cols) with gate_cols the
//      head count rounded up to a multiple of eight (zero columns), so that
//      its rows are 16-byte multiples for TMA.
//   3. A flash-style attention (tiles.cuh, run_flash, shared with
//      attention.cu): one block per (query tile, head, batch) walks key tiles
//      with an online softmax, so no (n, n) score matrix is stored (an
//      832-key fp32 K and V pair would not fit in shared memory anyway). Key
//      tiles wholly past n_valid are skipped; key columns >= n_valid in the
//      last tile get -1e30. The normalised, gated output is written as merged
//      heads (B, n_pad, heads*64). bf16 runs both products on wgmma with K
//      and V by TMA; float32 runs FMA tiles; in both the scores and the
//      output accumulator stay in registers.
//   4. The output projection GEMM with the residual add in its epilogue.
// The TPU kernel keeps every intermediate in VMEM. Here xn, q, k, v, the
// gates and the merged heads round-trip through device memory between
// launches; fusing the chain is later work.
#include "tiles.cuh"

namespace asep {

template <typename T> struct QkvEpi {
    T* q;
    T* k;
    T* v;
    float* gates;
    const T* gate_b;
    const T* cos_t;  // (n_pad, 64) or nullptr: no RoPE
    const T* sin_t;
    int n_pad, heads;

    struct Pre {};  // the RoPE tables are cache hits, read where they are used
    static constexpr int PREFETCH = 8;
    __device__ Pre prefetch(int, int) const { return {}; }

    // A run of eight columns lies in one head's 64 lanes of q, k or v (3·hd
    // and hd are multiples of 64), and RoPE pairs (c, c^1) lie inside it.
    __device__ void operator()(const float* row, int c0, int count, int grow, int gcol0,
                               const Pre&) const {
        const int hd = heads * 64;
        const int b = grow / n_pad, n = grow % n_pad;
        if (gcol0 < 3 * hd) {
            const int which = gcol0 / hd, rem = gcol0 % hd, head = rem / 64, j0 = rem % 64;
            float val[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) val[e] = rnd<T>(row[c0 + e]);
            if (which < 2 && cos_t != nullptr) {
                // rotate_half: out[2i] = -x[2i+1], out[2i+1] = x[2i].
                float cs[8], sn[8], rot[8];
                load8_ro(cos_t + n * 64 + j0, cs);
                load8_ro(sin_t + n * 64 + j0, sn);
#pragma unroll
                for (int e = 0; e < 8; ++e) rot[e] = (e & 1) ? val[e ^ 1] : -val[e ^ 1];
#pragma unroll
                for (int e = 0; e < 8; ++e) val[e] = rnd<T>(val[e] * cs[e] + rot[e] * sn[e]);
            }
            T* dst = which == 0 ? q : (which == 1 ? k : v);
            store8(dst + (((size_t)b * heads + head) * n_pad + n) * 64 + j0, val);
        } else {
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                const int head = gcol0 + e - 3 * hd;
                if (e < count && head < heads) {
                    const float g = row[c0 + e] + to_f(gate_b[head]);
                    gates[((size_t)b * heads + head) * n_pad + n] = 1.f / (1.f + expf(-g));
                }
            }
        }
    }
};

// The attention launch's Out policy: the gated result as merged heads
// (B, n_pad, heads*64).
template <typename T> struct MergedGatedOut {
    const float* gates;
    T* merged;
    int n_pad, heads;
    __device__ T* row(int bh, int n) const {
        const int b = bh / heads, head = bh % heads;
        return merged + ((size_t)b * n_pad + n) * heads * 64 + head * 64;
    }
    __device__ float gain(int bh, int n) const { return gates[(size_t)bh * n_pad + n]; }
};

template <typename T>
int run_attention_block(const T* x, const T* wqkv, const T* gate_w, const T* gate_b,
                        const T* wo, const T* norm, const T* cos_t, const T* sin_t, T* xn,
                        T* q, T* k, T* v, float* gates, T* merged, T* out, int batch,
                        int n_pad, int d_model, int heads, int n_valid, cudaStream_t stream) {
    const int rows = batch * n_pad, hd = heads * 64;
    cudaError_t err = run_rmsnorm(x, norm, xn, rows, d_model, stream);
    if (err != cudaSuccess) return err;

    const QkvEpi<T> qkv_epi{q, k, v, gates, gate_b, cos_t, sin_t, n_pad, heads};
    err = run_gemm(static_cast<const T*>(xn), wqkv, 3 * hd, gate_w, (heads + 7) / 8 * 8, rows,
                   d_model, qkv_epi, stream);
    if (err != cudaSuccess) return err;

    const MergedGatedOut<T> attn_out{gates, merged, n_pad, heads};
    err = run_flash(static_cast<const T*>(q), static_cast<const T*>(k),
                    static_cast<const T*>(v), attn_out, batch * heads, n_pad, n_valid, 64,
                    0.125f /* 64^-0.5 */, stream);
    if (err != cudaSuccess) return err;

    const ResidualEpi<T> out_epi{x, nullptr, out, d_model};
    return run_gemm(static_cast<const T*>(merged), wo, d_model, static_cast<const T*>(nullptr),
                    0, rows, hd, out_epi, stream);
}

}  // namespace asep

// dtype: 0 = float32, 1 = bfloat16. gate_w has heads rounded up to a multiple
// of eight columns. xn, q, k, v, gates (fp32) and merged are scratch the
// caller allocates. Returns 0 or the first CUDA error.
extern "C" int asep_attention_block(int dtype, const void* x, const void* wqkv,
                                    const void* gate_w, const void* gate_b, const void* wo,
                                    const void* norm, const void* cos_t, const void* sin_t,
                                    void* xn, void* q, void* k, void* v, void* gates,
                                    void* merged, void* out, int batch, int n_pad, int d_model,
                                    int heads, int n_valid, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto run = [&](auto tag) {
        using T = decltype(tag);
        return asep::run_attention_block<T>(
            static_cast<const T*>(x), static_cast<const T*>(wqkv), static_cast<const T*>(gate_w),
            static_cast<const T*>(gate_b), static_cast<const T*>(wo),
            static_cast<const T*>(norm), static_cast<const T*>(cos_t),
            static_cast<const T*>(sin_t), static_cast<T*>(xn), static_cast<T*>(q),
            static_cast<T*>(k), static_cast<T*>(v), static_cast<float*>(gates),
            static_cast<T*>(merged), static_cast<T*>(out), batch, n_pad, d_model, heads,
            n_valid, s);
    };
    return dtype == 0 ? run(float{}) : run(asep::bf16{});
}
