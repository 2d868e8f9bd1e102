// Attention backward (K1) for Hopper (sm_90a), float32:
//   given o = softmax(q·kᵀ·scale, keys >= n_valid masked)·v and dO,
//   dv = Pᵀ·dO,  dS = P ⊙ (dO·vᵀ − Δ),  dq = dS·k·scale,  dk = dSᵀ·q·scale,
//   Δ_i = Σ_c dO_ic·O_ic.
//
// The gradient of the Pallas TPU kernels _fused_attention_kernel
// (audio_separator_tpu/ops/attention.py::_pallas_fused_attention) and of the
// attention inside _layer_kernel (ops/attention_block.py::
// fused_attention_block). The JAX package has no backward kernel (it cannot
// differentiate through pl.pallas_call); this one is held against the
// gradient of the plain version.
//
// Where O and dO come from is the caller's policy:
//   * HeadMajorGrad: o and dO as (batch·head, n, dh), the whole-sequence
//     attention's output and its gradient;
//   * MergedGatedGrad: the attention block's gated merged heads, merged =
//     O·g as (B, n, heads·64), its gradient d_merged and the gates g as
//     (B·heads, n). Then dO = d_merged·g and Δ = Σ d_merged·merged, so
//     nothing is divided by a gate.
//
// What bounds it on the card: the products. A backward pass needs five
// N²·D products (the scores recomputed, dP, dV, dQ, dK) against the
// forward's two, about 2.5 times the forward's 4·N²·D operations over the
// same few N·D bytes: operation-bound. This kernel is the simple form that is
// right first: float32 FMA tiles of 64 x 64 from shared memory (no tensor
// cores: TF32 is not float32), two launches, and no (N, N) matrix stored.
// Each thread keeps a 4 x 4 block of a score tile, or 4 rows x 4 (8 at D
// 128) head lanes of a gradient, in registers and reads its operands as
// 16-byte vectors along the summed axis, so shared memory serves the FMA
// units (scalar loads held them near half their rate):
//   1. attention_bwd_dq_kernel, a block per (batch·head, 64 queries): a first
//      pass over the key tiles recomputes the row log-sum-exp (the forward
//      kernels keep none), a second recomputes P, forms dS and accumulates dQ
//      in registers; it stores the log-sum-exp and Δ for launch 2;
//   2. attention_bwd_dkv_kernel, a block per (batch·head, 64 keys): a pass
//      over the query tiles accumulates dK and dV in registers; key tiles
//      wholly past n_valid write zeros.
// So it does eight N²·D products where five would do; the tensor-core form
// (3xTF32 wgmma, one launch with the scores kept) is later work.
#include "bwd_common.cuh"

namespace asep {

constexpr int BT = 64;            // rows of a query or key tile
constexpr int BWD_THREADS = 256;  // thread (ty, tx), 16 x 16
constexpr int PLD = BT + 4;       // a 64 x 64 tile's padded row in shared memory

struct HeadMajorGrad {
    const float* o;
    const float* dout;
    int n, dh;
    __device__ size_t off(int bh, int r) const { return ((size_t)bh * n + r) * dh; }
    __device__ float gain(int, int) const { return 1.f; }
};

struct MergedGatedGrad {
    const float* o;      // merged (B, n, heads·64)
    const float* dout;   // d_merged, the same layout
    const float* gates;  // (B·heads, n)
    int n, heads;
    __device__ size_t off(int bh, int r) const {
        const int b = bh / heads, h = bh % heads;
        return ((size_t)b * n + r) * heads * 64 + h * 64;
    }
    __device__ float gain(int bh, int r) const { return gates[(size_t)bh * n + r]; }
};

__device__ __forceinline__ float4 lds4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float comp(const float4& v, int i) {
    return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}
__device__ __forceinline__ void fma4(float4& acc, float w, const float4& v) {
    acc.x = fmaf(w, v.x, acc.x);
    acc.y = fmaf(w, v.y, acc.y);
    acc.z = fmaf(w, v.z, acc.z);
    acc.w = fmaf(w, v.w, acc.w);
}

// Rows [r0, r0 + 64) of one head's (n, DH) operand into a tile of rows
// DH + 4 long, by 16-byte vectors; rows past n read as zeros.
template <int DH>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int r0, int n) {
    constexpr int V = DH / 4;
    for (int i = threadIdx.x; i < BT * V; i += BWD_THREADS) {
        const int r = i / V, c = 4 * (i % V);
        *reinterpret_cast<float4*>(dst + r * (DH + 4) + c) =
            r0 + r < n ? *reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * DH + c)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
    }
}

// dO of rows [r0, r0 + 64) into a tile, one warp a row; with DELTA, also Δ
// of each row.
template <int DH, bool DELTA, class G>
__device__ __forceinline__ void load_grad_rows(float* dst, float* delta, const G& g, int bh,
                                               int r0, int n) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int r = warp; r < BT; r += BWD_THREADS / 32) {
        const int row = r0 + r;
        float dot = 0.f;
        if (row < n) {
            const size_t off = g.off(bh, row);
            const float gain = g.gain(bh, row);
            for (int c = lane; c < DH; c += 32) {
                const float d = g.dout[off + c];
                if constexpr (DELTA) dot = fmaf(d, g.o[off + c], dot);
                dst[r * (DH + 4) + c] = d * gain;
            }
        } else {
            for (int c = lane; c < DH; c += 32) dst[r * (DH + 4) + c] = 0.f;
        }
        if constexpr (DELTA) {
            dot = warp_sum(dot);
            if (lane == 0) delta[r] = dot;
        }
    }
}

// s[a][c] = Σ_d A[ty + 16a][d] · B[tx + 16c][d] over two tiles of rows
// DH + 4 long, four d at a time (16-byte loads; the padding puts the eight
// rows a quarter-warp reads on distinct banks).
template <int DH>
__device__ __forceinline__ void tile_dot(float (&s)[4][4], const float* A, const float* B,
                                         int ty, int tx) {
    constexpr int LD = DH + 4;
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
#pragma unroll 2
    for (int d = 0; d < DH; d += 4) {
        float4 av[4], bv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) av[a] = lds4(A + (ty + 16 * a) * LD + d);
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = lds4(B + (tx + 16 * c) * LD + d);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                s[a][c] = fmaf(av[a].x, bv[c].x, s[a][c]);
                s[a][c] = fmaf(av[a].y, bv[c].y, s[a][c]);
                s[a][c] = fmaf(av[a].z, bv[c].z, s[a][c]);
                s[a][c] = fmaf(av[a].w, bv[c].w, s[a][c]);
            }
    }
}

// acc[a][e] += Σ_j W[ty + 16a][j] · X[j][4tx + 64e .. + 3]: W a 64 x 64
// tile (rows PLD long), X a tile of rows DH + 4 long; four j at a time.
template <int DH>
__device__ __forceinline__ void tile_accumulate(float4 (&acc)[4][DH / 64], const float* W,
                                                const float* X, int ty, int tx) {
    constexpr int LD = DH + 4, E = DH / 64;
#pragma unroll 2
    for (int j = 0; j < BT; j += 4) {
        float4 w[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) w[a] = lds4(W + (ty + 16 * a) * PLD + j);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
            for (int e = 0; e < E; ++e) {
                const float4 x = lds4(X + (j + jj) * LD + 4 * tx + 64 * e);
#pragma unroll
                for (int a = 0; a < 4; ++a) fma4(acc[a][e], comp(w[a], jj), x);
            }
    }
}

// Reductions over the 16 threads (tx) of a row: lanes that differ in the low
// four bits.
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
    for (int m = 8; m > 0; m >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, m));
    return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
    for (int m = 8; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
    return v;
}

template <int DH>
constexpr size_t DQ_SMEM_BYTES = (size_t)(4 * BT * (DH + 4) + BT * PLD + BT) * 4;
template <int DH>
constexpr size_t DKV_SMEM_BYTES = (size_t)(4 * BT * (DH + 4) + 2 * BT * PLD + 2 * BT) * 4;

template <int DH, class G>
__global__ void __launch_bounds__(BWD_THREADS)
    attention_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, G g, float* __restrict__ dq,
                            float* __restrict__ lse_out, float* __restrict__ delta_out, int n,
                            int n_valid, float scale) {
    extern __shared__ __align__(16) float smem[];
    constexpr int LD = DH + 4, E = DH / 64;
    float* Qs = smem;
    float* dOs = Qs + BT * LD;
    float* Ks = dOs + BT * LD;
    float* Vs = Ks + BT * LD;
    float* dSs = Vs + BT * LD;  // dS (query, key)
    float* delta_s = dSs + BT * PLD;
    const int bh = blockIdx.x, q0 = blockIdx.y * BT;
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    const size_t base = (size_t)bh * n * DH;

    load_rows<DH>(Qs, q + base, q0, n);
    load_grad_rows<DH, true>(dOs, delta_s, g, bh, q0, n);

    // Pass 1: the row log-sum-exp of the scaled, masked scores.
    float m[4], l[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) m[a] = -INFINITY, l[a] = 0.f;
    for (int k0 = 0; k0 < n_valid; k0 += BT) {
        __syncthreads();  // Q and dO are in; the previous K tile is no longer read
        load_rows<DH>(Ks, k + base, k0, n);
        __syncthreads();
        float s[4][4];
        tile_dot<DH>(s, Qs, Ks, ty, tx);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
            float mx = -INFINITY;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                s[a][c] = k0 + tx + 16 * c < n_valid ? s[a][c] * scale : -INFINITY;
                mx = fmaxf(mx, s[a][c]);
            }
            // Column k0 is valid, so every tile's maximum is finite.
            const float mn = fmaxf(m[a], row_max(mx));
            float sum = 0.f;
#pragma unroll
            for (int c = 0; c < 4; ++c) sum += expf(s[a][c] - mn);
            l[a] = l[a] * expf(m[a] - mn) + row_sum(sum);
            m[a] = mn;
        }
    }
    float lse[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) lse[a] = m[a] + logf(l[a]);

    // Pass 2: P, dS and dQ.
    float4 acc[4][E];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[a][e] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k0 = 0; k0 < n_valid; k0 += BT) {
        __syncthreads();
        load_rows<DH>(Ks, k + base, k0, n);
        load_rows<DH>(Vs, v + base, k0, n);
        __syncthreads();
        float s[4][4], dp[4][4];
        tile_dot<DH>(s, Qs, Ks, ty, tx);
        tile_dot<DH>(dp, dOs, Vs, ty, tx);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
            const int r = ty + 16 * a;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const float p =
                    k0 + tx + 16 * c < n_valid ? expf(s[a][c] * scale - lse[a]) : 0.f;
                dSs[r * PLD + tx + 16 * c] = p * (dp[a][c] - delta_s[r]);
            }
        }
        __syncthreads();
        tile_accumulate<DH>(acc, dSs, Ks, ty, tx);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
        const int r = q0 + ty + 16 * a;
        if (r >= n) continue;
#pragma unroll
        for (int e = 0; e < E; ++e) {
            const float4 o = acc[a][e];
            *reinterpret_cast<float4*>(dq + base + (size_t)r * DH + 4 * tx + 64 * e) =
                make_float4(o.x * scale, o.y * scale, o.z * scale, o.w * scale);
        }
        if (tx == 0) {
            lse_out[(size_t)bh * n + r] = lse[a];
            delta_out[(size_t)bh * n + r] = delta_s[ty + 16 * a];
        }
    }
}

template <int DH, class G>
__global__ void __launch_bounds__(BWD_THREADS)
    attention_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, G g, const float* __restrict__ lse_g,
                             const float* __restrict__ delta_g, float* __restrict__ dk,
                             float* __restrict__ dv, int n, int n_valid, float scale) {
    extern __shared__ __align__(16) float smem[];
    constexpr int LD = DH + 4, E = DH / 64;
    float* Ks = smem;
    float* Vs = Ks + BT * LD;
    float* Qs = Vs + BT * LD;
    float* dOs = Qs + BT * LD;
    float* PTs = dOs + BT * LD;    // P transposed (key, query)
    float* dSTs = PTs + BT * PLD;  // dS transposed (key, query)
    float* lse_s = dSTs + BT * PLD;
    float* delta_s = lse_s + BT;
    const int bh = blockIdx.x, k0 = blockIdx.y * BT;
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    const size_t base = (size_t)bh * n * DH;

    float4 acc_k[4][E], acc_v[4][E];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < E; ++e)
            acc_k[a][e] = acc_v[a][e] = make_float4(0.f, 0.f, 0.f, 0.f);

    if (k0 < n_valid) {  // a key tile wholly past n_valid has no gradient
        load_rows<DH>(Ks, k + base, k0, n);
        load_rows<DH>(Vs, v + base, k0, n);
        for (int q0 = 0; q0 < n; q0 += BT) {
            __syncthreads();  // the previous query tile is no longer read
            load_rows<DH>(Qs, q + base, q0, n);
            load_grad_rows<DH, false>(dOs, nullptr, g, bh, q0, n);
            for (int i = threadIdx.x; i < BT; i += BWD_THREADS) {
                const bool in = q0 + i < n;
                lse_s[i] = in ? lse_g[(size_t)bh * n + q0 + i] : 0.f;
                delta_s[i] = in ? delta_g[(size_t)bh * n + q0 + i] : 0.f;
            }
            __syncthreads();
            // Rows: queries ty + 16a; columns: keys tx + 16c.
            float s[4][4], dp[4][4];
            tile_dot<DH>(s, Qs, Ks, ty, tx);
            tile_dot<DH>(dp, dOs, Vs, ty, tx);
#pragma unroll
            for (int a = 0; a < 4; ++a) {
                const int r = ty + 16 * a;
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const bool live = q0 + r < n && k0 + tx + 16 * c < n_valid;
                    const float p = live ? expf(s[a][c] * scale - lse_s[r]) : 0.f;
                    PTs[(tx + 16 * c) * PLD + r] = p;
                    dSTs[(tx + 16 * c) * PLD + r] = p * (dp[a][c] - delta_s[r]);
                }
            }
            __syncthreads();
            // Rows: keys ty + 16a; columns: head lanes; sums over the queries.
            tile_accumulate<DH>(acc_v, PTs, dOs, ty, tx);
            tile_accumulate<DH>(acc_k, dSTs, Qs, ty, tx);
        }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
        const int r = k0 + ty + 16 * a;
        if (r >= n) continue;
#pragma unroll
        for (int e = 0; e < E; ++e) {
            const size_t o = base + (size_t)r * DH + 4 * tx + 64 * e;
            const float4 gk = acc_k[a][e];
            *reinterpret_cast<float4*>(dk + o) =
                make_float4(gk.x * scale, gk.y * scale, gk.z * scale, gk.w * scale);
            *reinterpret_cast<float4*>(dv + o) = acc_v[a][e];
        }
    }
}

template <int DH, class G>
cudaError_t run_attention_bwd(const float* q, const float* k, const float* v, const G& g,
                              float* dq, float* dk, float* dv, float* lse, float* delta, int bh,
                              int n, int n_valid, float scale, cudaStream_t stream) {
    const dim3 grid(bh, (n + BT - 1) / BT);
    cudaError_t err = launch_bwd(attention_bwd_dq_kernel<DH, G>, grid, BWD_THREADS,
                                 DQ_SMEM_BYTES<DH>, stream, q, k, v, g, dq, lse, delta, n,
                                 n_valid, scale);
    if (err != cudaSuccess) return err;
    return launch_bwd(attention_bwd_dkv_kernel<DH, G>, grid, BWD_THREADS, DKV_SMEM_BYTES<DH>,
                      stream, q, k, v, g, static_cast<const float*>(lse),
                      static_cast<const float*>(delta), dk, dv, n, n_valid, scale);
}

}  // namespace asep

// layout 0: o and dout are (bh, n, dh), dh 64 or 128. layout 1: o and dout are
// the merged heads (bh / heads, n, heads·64), gates (bh, n), dh 64. q, k, v,
// dq, dk, dv are (bh, n, dh); lse and delta (bh, n) are written for the
// second launch (delta is Δ, which the attention block's gate gradient
// reads). All float32, contiguous. Returns 0 or the first CUDA error.
extern "C" int asep_attention_bwd(int layout, const void* q, const void* k, const void* v,
                                  const void* o, const void* dout, const void* gates, void* dq,
                                  void* dk, void* dv, void* lse, void* delta, int bh, int n,
                                  int n_valid, int dh, int heads, float scale, void* stream) {
    if (bh < 1 || n < 1 || n_valid < 1 || n_valid > n) return cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
                *vf = static_cast<const float*>(v);
    float *dqf = static_cast<float*>(dq), *dkf = static_cast<float*>(dk),
          *dvf = static_cast<float*>(dv), *lsef = static_cast<float*>(lse),
          *deltaf = static_cast<float*>(delta);
    if (layout == 1) {
        if (dh != 64 || heads < 1 || bh % heads) return cudaErrorInvalidValue;
        const asep::MergedGatedGrad g{static_cast<const float*>(o),
                                      static_cast<const float*>(dout),
                                      static_cast<const float*>(gates), n, heads};
        return asep::run_attention_bwd<64>(qf, kf, vf, g, dqf, dkf, dvf, lsef, deltaf, bh, n,
                                           n_valid, scale, s);
    }
    const asep::HeadMajorGrad g{static_cast<const float*>(o), static_cast<const float*>(dout),
                                n, dh};
    if (dh == 64)
        return asep::run_attention_bwd<64>(qf, kf, vf, g, dqf, dkf, dvf, lsef, deltaf, bh, n,
                                           n_valid, scale, s);
    if (dh == 128)
        return asep::run_attention_bwd<128>(qf, kf, vf, g, dqf, dkf, dvf, lsef, deltaf, bh, n,
                                            n_valid, scale, s);
    return cudaErrorInvalidValue;
}
