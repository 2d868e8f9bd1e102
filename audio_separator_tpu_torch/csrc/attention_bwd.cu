// Attention backward (K1) for Hopper (sm_90a), float32 (this file) and bf16
// in the gated layout (attention_bwd_bf16.cuh, the bf16 training step's):
//   given o = softmax(q·kᵀ·scale, keys >= n_valid masked)·v and dO,
//   dv = Pᵀ·dO,  dS = P ⊙ (dO·vᵀ − Δ),  dq = dS·k·scale,  dk = dSᵀ·q·scale,
//   Δ_i = Σ_c dO_ic·O_ic.
//
// The gradient of the Pallas TPU kernels _fused_attention_kernel
// (audio_separator_tpu/ops/attention.py:39, via _pallas_fused_attention) and
// of the attention inside _layer_kernel (ops/attention_block.py:35, via
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
//     nothing is divided by a gate. The kernels keep d_merged as it is and
//     apply each query's gate to what it multiplies: the rows of dP and the
//     columns of P before P·d_merged.
//
// What bounds it on the card. Long sequences (n > 64): the products, five
// N²·D products (the scores recomputed, dP, dV, dQ, dK) over a few N·D
// bytes. Short ones (n <= 64, the flagship's frequency axis: 12 816
// sequences of 64 rows): the bytes, q, k, v, O and dO read and dq, dk, dv
// written once, against N²·D products that are only 64 deep.
//
// What the design does about it. Every product runs on the tensor cores as
// 3xTF32 (each operand split into a TF32 head and tail as gemm_tf32.cuh
// does, round_tf32 with ties away; a_hi·b_hi + a_hi·b_lo + a_lo·b_hi summed
// in float32: float32 accuracy, ops/tf32.py has the argument). P and dS are
// the A operand of the products that sum over the sequence straight from the
// accumulator registers: the sum over k runs in the order the accumulator
// layout gives (lane t holds columns 2t and 2t + 1 of each 8, which the A
// fragment takes as k = t and t + 4), and the other operand is read in the
// same order, so no shuffle is needed. Tiles come in by cp.async while
// earlier ones multiply; no float32 atomics, so every result is the same
// from run to run.
//   * n > 64 at D 64 (the flagship's time axis, HTDemucs), two launches on
//     wgmma, two warpgroups a block taking turns at 32-row stages (below,
//     "the two launches on wgmma"):
//     1. attention_bwd_q_wgmma_kernel, a block per (batch·head, 64 queries),
//        Q and dO resident: Δ of its rows; one pass over the key stages
//        computes S and dP and accumulates dQ against each row's running
//        maximum, rescaled as it grows (the forward's online softmax), so
//        the row log-sum-exp comes from the kernel's own 3xTF32 scores (the
//        forward kernels keep none, and P stays consistent with the scores
//        it multiplies); it stores the log-sum-exp and Δ for launch 2;
//     2. attention_bwd_kv_wgmma_kernel, a block per (batch·head, 64 keys),
//        K and V resident: query stages stream through and dK and dV
//        accumulate in registers; key tiles wholly past n_valid write zeros.
//     Seven N²·D products where five would do: dQ could take dS from
//     launch 2 only through float32 atomics. What bounds them is shared
//     memory: wgmma reads both operands from it at every step, three times
//     a 3xTF32 term, besides the splits that write the stage tiles.
//   * n > 64 at D 128 (no main path runs it): two launches on
//     mma.sync.m16n8k8, attention_bwd_q_kernel (a first pass for the
//     log-sum-exp, a second for dQ) and attention_bwd_kv_kernel,
//     blocks of four warps each owning 16 rows of 64, stages of 16 queries.
//     Their fragments are read with plain loads from one padded float32 copy
//     of each tile (rows of DH + 4 floats put the 32 lanes of every fragment
//     load on 32 banks) and split in registers, which takes any operand
//     transposed for free.
//   * n <= 64, one launch on mma.sync, attention_bwd_short_kernel, a block
//     per sequence: q, k, v, dO and (for Δ) O are read once; S, the
//     log-sum-exp, P, dP, dS and dQ with the queries on the warps' rows;
//     (P·g)ᵀ and dSᵀ go to shared memory over K and V, then dK and dV with
//     the keys on the warps' rows: five products.
// The sums over the sequence add each tile's products (at most 64 deep) on
// the FMA pipe: the tensor cores' adder rounds with a bias that a long
// chain builds up (gemm_tf32.cuh).
//
// The bf16 form (attention_bwd_bf16.cuh, gated layout) splits the same way
// but needs no splits: n > 64 two launches on wgmma bf16 with every operand
// brought by TMA into 128-byte swizzled tiles, seven N²·D products (dQ in one
// online pass), each warpgroup owning 64 rows; n <= 64 one launch a sequence
// on mma.sync.m16n8k16, five products, four blocks an SM. Its header gives
// what bounds each path.
#include "bwd_common.cuh"
#include "hopper.cuh"

namespace asep {

constexpr int BT = 64;            // rows of a block's own tile: four warps of 16
constexpr int BWD_THREADS = 128;
constexpr float LOG2E = 1.4426950408889634f;

struct HeadMajorGrad {
    const float* o;
    const float* dout;
    int n, dh;
    __device__ size_t off(int bh, int r) const { return ((size_t)bh * n + r) * dh; }
    __device__ const float* gate(int, int) const { return nullptr; }
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
    __device__ const float* gate(int bh, int r) const { return gates + (size_t)bh * n + r; }
};

// ---------------------------------------------------------------------------
// 3xTF32 on mma.sync.m16n8k8. Fragments (g = lane / 4, t = lane % 4):
//   A 16 x 8: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
//   B 8 x 8:  b0 (k t, n g), b1 (k t + 4, n g);
//   C 16 x 8: c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).

// tf32(x): the float32 nearest to x with 10 mantissa bits, ties away from zero.
__device__ __forceinline__ uint32_t tf32_bits(float x) {
    return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
    hi = tf32_bits(x);
    lo = tf32_bits(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
    mma_tf32(d, ah, bh0, bh1);
    mma_tf32(d, ah, bl0, bl1);
    mma_tf32(d, al, bh0, bh1);
}

// c[j] = A·Bᵀ for this warp's 16 rows of A (from A) against rows 8j .. 8j + 7
// of B (from B), summed over DH: both tiles row-major, rows DH + 4 long.
template <int NT, int DH>
__device__ __forceinline__ void scores(float (&c)[NT][4], const float* A, const float* B, int g,
                                       int t) {
    constexpr int LD = DH + 4;
#pragma unroll
    for (int j = 0; j < NT; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll 2
    for (int k0 = 0; k0 < DH; k0 += 8) {
        uint32_t ah[4], al[4];
        split_tf32(A[g * LD + k0 + t], ah[0], al[0]);
        split_tf32(A[(g + 8) * LD + k0 + t], ah[1], al[1]);
        split_tf32(A[g * LD + k0 + t + 4], ah[2], al[2]);
        split_tf32(A[(g + 8) * LD + k0 + t + 4], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            const float* b = B + (8 * j + g) * LD + k0 + t;
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32(b[0], bh0, bl0);
            split_tf32(b[4], bh1, bl1);
            mma_3xtf32(c[j], ah, al, bh0, bh1, bl0, bl1);
        }
    }
}

// acc += P·X: P this warp's 16 rows x 8·KT columns in the accumulator layout
// (as scores() leaves it), X 8·KT rows x DH, rows DH + 4 long. Lane t's
// columns 2t and 2t + 1 of each 8 are the A fragment's k = t and t + 4, and X
// is read in that order. Each run of 64 output columns sums into `part`
// first (KT·8 deep), added to acc on the FMA pipe.
template <int KT, int DH>
__device__ __forceinline__ void accumulate(float (&acc)[DH / 8][4], const float (&p)[KT][4],
                                           const float* X, int g, int t) {
    constexpr int LD = DH + 4;
#pragma unroll
    for (int c0 = 0; c0 < DH; c0 += 64) {
        float part[8][4];
#pragma unroll
        for (int m = 0; m < 8; ++m) part[m][0] = part[m][1] = part[m][2] = part[m][3] = 0.f;
#pragma unroll
        for (int j = 0; j < KT; ++j) {
            uint32_t ah[4], al[4];
            split_tf32(p[j][0], ah[0], al[0]);
            split_tf32(p[j][2], ah[1], al[1]);
            split_tf32(p[j][1], ah[2], al[2]);
            split_tf32(p[j][3], ah[3], al[3]);
            const float* x = X + (8 * j + 2 * t) * LD + c0 + g;
#pragma unroll
            for (int m = 0; m < 8; ++m) {
                uint32_t bh0, bl0, bh1, bl1;
                split_tf32(x[8 * m], bh0, bl0);
                split_tf32(x[LD + 8 * m], bh1, bl1);
                mma_3xtf32(part[m], ah, al, bh0, bh1, bl0, bl1);
            }
        }
#pragma unroll
        for (int m = 0; m < 8; ++m)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[c0 / 8 + m][e] += part[m][e];
    }
}

template <int DH>
__device__ __forceinline__ void zero(float (&acc)[DH / 8][4]) {
#pragma unroll
    for (int m = 0; m < DH / 8; ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;
}

// Rows r0 + g and r0 + g + 8 of this warp's 16, times `mul`, to dst (rows
// DH long); rows at or past n are not written.
template <int DH>
__device__ __forceinline__ void store_rows(float* dst, const float (&acc)[DH / 8][4], int r0,
                                           int n, float mul, int g, int t) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = r0 + g + 8 * h;
        if (r >= n) continue;
#pragma unroll
        for (int m = 0; m < DH / 8; ++m)
            *reinterpret_cast<float2*>(dst + (size_t)r * DH + 8 * m + 2 * t) =
                make_float2(acc[m][2 * h] * mul, acc[m][2 * h + 1] * mul);
    }
}

// Quad reductions: the four lanes (t) that hold one row of a C fragment.
__device__ __forceinline__ float quad_max(float v) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---------------------------------------------------------------------------
// Loads, by cp.async (16 bytes a thread, rows past n as zeros).

// Rows [r0, r0 + R) of one head's (n, DH) operand into a tile of rows DH + 4.
template <int R, int DH>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int r0, int n) {
    constexpr int V = DH / 4;
    for (int i = threadIdx.x; i < R * V; i += BWD_THREADS) {
        const int r = i / V, c = 4 * (i % V);
        const bool in = r0 + r < n;
        cp_async16(dst + r * (DH + 4) + c, in ? src + (size_t)(r0 + r) * DH + c : src, in);
    }
}

// The same for dO (d_merged of the gated layout) as it is.
template <int R, int DH, class G>
__device__ __forceinline__ void load_grad_rows(float* dst, const G& gr, int bh, int r0, int n) {
    constexpr int V = DH / 4;
    for (int i = threadIdx.x; i < R * V; i += BWD_THREADS) {
        const int r = i / V, c = 4 * (i % V);
        const bool in = r0 + r < n;
        cp_async16(dst + r * (DH + 4) + c, in ? gr.dout + gr.off(bh, r0 + r) + c : gr.dout, in);
    }
}

// The gains of rows [r0, r0 + R): the gates, 1 for the head-major layout,
// 0 past n.
template <int R, class G>
__device__ __forceinline__ void load_gains(float* dst, const G& gr, int bh, int r0, int n) {
    for (int r = threadIdx.x; r < R; r += BWD_THREADS) {
        const float* p = r0 + r < n ? gr.gate(bh, r0 + r) : nullptr;
        if (p != nullptr)
            cp_async4(dst + r, p, true);
        else
            dst[r] = r0 + r < n ? 1.f : 0.f;
    }
}

// Δ of this warp's 16 rows [r0, r0 + 16) from their dO in shared memory
// (rows DH + 4) and O in device memory: lanes over the columns, one warp sum
// a row. Thread (g, t) keeps the rows r0 + g and r0 + g + 8; lane 0 stores
// all 16 to delta_out.
template <int DH, class G>
__device__ __forceinline__ void row_deltas(float (&dlt)[2], const float* dOw, const G& gr, int bh,
                                           int r0, int n, float* delta_out) {
    const int lane = threadIdx.x % 32, g = lane / 4;
    float part[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
        part[r] = 0.f;
        if (r0 + r < n) {
            const float* o = gr.o + gr.off(bh, r0 + r);
#pragma unroll
            for (int c = lane; c < DH; c += 32) part[r] = fmaf(dOw[r * (DH + 4) + c], o[c], part[r]);
        }
    }
#pragma unroll
    for (int r = 0; r < 16; ++r) {
        const float d = warp_sum(part[r]);
        if (r == g) dlt[0] = d;
        if (r == g + 8) dlt[1] = d;
        if (lane == 0 && r0 + r < n) delta_out[(size_t)bh * n + r0 + r] = d;
    }
}

// ---------------------------------------------------------------------------
// The two forms of one tile step, shared by the long and the short path.

// Queries on the rows: this warp's 16 queries (Qw, dOw) against the 64 keys
// of Kt, Vt from k0: P from the log-sum-exp (base 2) of the rows, dS, and dQ
// += dS·K. Returns P and dS (P masked) in p and ds.
template <int DH>
__device__ __forceinline__ void dq_step(float (&acc)[DH / 8][4], float (&p)[8][4],
                                        float (&ds)[8][4], const float* Qw, const float* dOw,
                                        const float* Kt, const float* Vt, const float (&lse2)[2],
                                        const float (&dlt)[2], const float (&gain)[2],
                                        int k0, int n_valid, float c2, int g, int t) {
    scores<8, DH>(p, Qw, Kt, g, t);
    scores<8, DH>(ds, dOw, Vt, g, t);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int h = e >> 1;
            const float pe =
                k0 + 8 * j + 2 * t + (e & 1) < n_valid ? exp2_approx(p[j][e] * c2 - lse2[h]) : 0.f;
            ds[j][e] = pe * (ds[j][e] * gain[h] - dlt[h]);
            p[j][e] = pe;
        }
    accumulate<8, DH>(acc, ds, Kt, g, t);
}

// Keys on the rows: this warp's 16 keys (Kw, Vw; key_in[h] says whether key
// g + 8h of them is below n_valid) against the BQ queries of Qst, dOst from
// q0, with their log-sum-exp (base 2), Δ and gains: dV += (P·g)ᵀ·dO and
// dK += dSᵀ·Q.
template <int BQ, int DH>
__device__ __forceinline__ void dkv_step(float (&dk)[DH / 8][4], float (&dv)[DH / 8][4],
                                         const float* Kw, const float* Vw, const float* Qst,
                                         const float* dOst, const float* lse_s,
                                         const float* delta_s, const float* gain_s,
                                         const bool (&key_in)[2], int q0, int n, float c2, int g,
                                         int t) {
    constexpr int NT = BQ / 8;
    float p[NT][4], ds[NT][4];
    scores<NT, DH>(p, Kw, Qst, g, t);
    scores<NT, DH>(ds, Vw, dOst, g, t);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int col = 8 * j + 2 * t + (e & 1);
            const float pe = key_in[e >> 1] && q0 + col < n
                                 ? exp2_approx(p[j][e] * c2 - lse_s[col])
                                 : 0.f;
            ds[j][e] = pe * (ds[j][e] * gain_s[col] - delta_s[col]);
            p[j][e] = pe * gain_s[col];
        }
    accumulate<NT, DH>(dv, p, dOst, g, t);
    accumulate<NT, DH>(dk, ds, Qst, g, t);
}

// ---------------------------------------------------------------------------
// n > 64 at D 128 (D 64 runs the two launches on wgmma, below), launch 1:
// Δ, the log-sum-exp and dQ.

template <int DH>
constexpr size_t DQ_SMEM_BYTES = (size_t)6 * BT * (DH + 4) * 4;  // Q, dO, two (K, V) stages

template <int DH, class G>
__global__ void __launch_bounds__(BWD_THREADS)
    attention_bwd_q_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, G gr, float* __restrict__ dq,
                            float* __restrict__ lse_out, float* __restrict__ delta_out, int n,
                            int n_valid, float scale) {
    extern __shared__ __align__(16) float smem[];
    constexpr int LD = DH + 4, TILE = BT * LD;
    float* Qs = smem;
    float* dOs = Qs + TILE;
    float* Ks = dOs + TILE;     // two stages
    float* Vs = Ks + 2 * TILE;  // two stages
    const int bh = blockIdx.x, q0 = blockIdx.y * BT;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const size_t base = (size_t)bh * n * DH;
    const float c2 = scale * LOG2E;
    const int nkt = (n_valid + BT - 1) / BT;

    // Items 0 .. nkt - 1 bring K tiles (pass 1), nkt .. 2nkt - 1 K and V
    // (pass 2), each into stage item % 2; a group is committed every item.
    auto prefetch = [&](int it) {
        if (it < 2 * nkt) {
            const int kt = it < nkt ? it : it - nkt;
            load_rows<BT, DH>(Ks + (it & 1) * TILE, k + base, kt * BT, n);
            if (it >= nkt) load_rows<BT, DH>(Vs + (it & 1) * TILE, v + base, kt * BT, n);
        }
        cp_async_commit();
    };
    load_rows<BT, DH>(Qs, q + base, q0, n);
    load_grad_rows<BT, DH>(dOs, gr, bh, q0, n);
    prefetch(0);

    const int r0 = q0 + warp * 16;
    const float* Qw = Qs + warp * 16 * LD;
    const float* dOw = dOs + warp * 16 * LD;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, lse2[2] = {0.f, 0.f};
    float dlt[2] = {0.f, 0.f}, gain[2] = {1.f, 1.f};
    float acc[DH / 8][4];
    zero<DH>(acc);
#pragma unroll 1
    for (int it = 0; it < 2 * nkt; ++it) {
        prefetch(it + 1);
        cp_async_wait<1>();
        __syncthreads();
        if (it == 0) {
            row_deltas<DH>(dlt, dOw, gr, bh, r0, n, delta_out);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const float* gp = r0 + g + 8 * h < n ? gr.gate(bh, r0 + g + 8 * h) : nullptr;
                gain[h] = gp != nullptr ? *gp : 1.f;
            }
        }
        const float* Kt = Ks + (it & 1) * TILE;
        if (it < nkt) {
            // Pass 1: the running maximum and sum of each row (base 2).
            float s[8][4];
            scores<8, DH>(s, Qw, Kt, g, t);
            const int k0 = it * BT;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                float mx = -INFINITY;
#pragma unroll
                for (int j = 0; j < 8; ++j)
#pragma unroll
                    for (int e = 2 * h; e < 2 * h + 2; ++e) {
                        s[j][e] = k0 + 8 * j + 2 * t + (e & 1) < n_valid ? s[j][e] * c2
                                                                         : -INFINITY;
                        mx = fmaxf(mx, s[j][e]);
                    }
                // Key k0 is valid, so every tile's maximum is finite.
                const float mn = fmaxf(m[h], quad_max(mx));
                float sum = 0.f;
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    sum += exp2_approx(s[j][2 * h] - mn) + exp2_approx(s[j][2 * h + 1] - mn);
                l[h] = l[h] * exp2_approx(m[h] - mn) + quad_sum(sum);
                m[h] = mn;
            }
            if (it == nkt - 1) {
                lse2[0] = m[0] + log2f(l[0]);
                lse2[1] = m[1] + log2f(l[1]);
            }
        } else {
            float p[8][4], ds[8][4];
            dq_step<DH>(acc, p, ds, Qw, dOw, Kt, Vs + (it & 1) * TILE, lse2, dlt, gain,
                        (it - nkt) * BT, n_valid, c2, g, t);
        }
        __syncthreads();  // stage it % 2 is free for item it + 2
    }
    store_rows<DH>(dq + base, acc, r0, n, scale, g, t);
    if (t == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
            if (r0 + g + 8 * h < n) lse_out[(size_t)bh * n + r0 + g + 8 * h] = lse2[h];
    }
}

// ---------------------------------------------------------------------------
// n > 64 at D 128, launch 2: dK and dV, K and V resident, the queries
// streamed.

template <int DH>
constexpr int DKV_BQ = 16;  // queries a stage
template <int DH>
constexpr size_t DKV_STAGE_FLOATS = (size_t)2 * DKV_BQ<DH> * (DH + 4) + 3 * DKV_BQ<DH>;
template <int DH>
constexpr size_t DKV_SMEM_BYTES = ((size_t)2 * BT * (DH + 4) + 2 * DKV_STAGE_FLOATS<DH>) * 4;

template <int DH, class G>
__global__ void __launch_bounds__(BWD_THREADS)
    attention_bwd_kv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, G gr, const float* __restrict__ lse_g,
                             const float* __restrict__ delta_g, float* __restrict__ dk,
                             float* __restrict__ dv, int n, int n_valid, float scale) {
    extern __shared__ __align__(16) float smem[];
    constexpr int LD = DH + 4, BQ = DKV_BQ<DH>;
    float* Ks = smem;
    float* Vs = Ks + BT * LD;
    float* stages = Vs + BT * LD;  // two of: Q, dO (BQ rows each), log-sum-exp, Δ, gains
    const int bh = blockIdx.x, k0 = blockIdx.y * BT;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const size_t base = (size_t)bh * n * DH;
    const int r0 = k0 + warp * 16;

    float acc_k[DH / 8][4], acc_v[DH / 8][4];
    zero<DH>(acc_k);
    zero<DH>(acc_v);
    if (k0 < n_valid) {  // a key tile wholly past n_valid has no gradient
        const float c2 = scale * LOG2E;
        const int nqs = (n + BQ - 1) / BQ;
        auto prefetch = [&](int s) {
            if (s < nqs) {
                float* st = stages + (s & 1) * DKV_STAGE_FLOATS<DH>;
                float* vec = st + 2 * BQ * LD;
                const int q0 = s * BQ;
                load_rows<BQ, DH>(st, q + base, q0, n);
                load_grad_rows<BQ, DH>(st + BQ * LD, gr, bh, q0, n);
                for (int i = threadIdx.x; i < 2 * BQ; i += BWD_THREADS) {
                    const int r = i % BQ;
                    const bool in = q0 + r < n;
                    const float* src = i < BQ ? lse_g : delta_g;
                    cp_async4(vec + i, in ? src + (size_t)bh * n + q0 + r : src, in);
                }
                load_gains<BQ>(vec + 2 * BQ, gr, bh, q0, n);
            }
            cp_async_commit();
        };
        load_rows<BT, DH>(Ks, k + base, k0, n);
        load_rows<BT, DH>(Vs, v + base, k0, n);
        prefetch(0);
        const bool key_in[2] = {r0 + g < n_valid, r0 + g + 8 < n_valid};
#pragma unroll 1
        for (int s = 0; s < nqs; ++s) {
            prefetch(s + 1);
            cp_async_wait<1>();
            __syncthreads();
            const float* st = stages + (s & 1) * DKV_STAGE_FLOATS<DH>;
            const float* vec = st + 2 * BQ * LD;
            dkv_step<BQ, DH>(acc_k, acc_v, Ks + warp * 16 * LD, Vs + warp * 16 * LD, st,
                             st + BQ * LD, vec, vec + BQ, vec + 2 * BQ, key_in, s * BQ, n, c2,
                             g, t);
            __syncthreads();  // stage s % 2 is free for stage s + 2
        }
    }
    store_rows<DH>(dk + base, acc_k, r0, n, scale, g, t);
    store_rows<DH>(dv + base, acc_v, r0, n, 1.f, g, t);
}

// ---------------------------------------------------------------------------
// n > 64 at D 64: the two launches on wgmma.
//
// Operand tiles are 128-byte swizzled and K-major, the only form in which
// wgmma reads 32-bit operands: rows of the M or N index, 32 floats of K a
// panel (128 bytes), eight-row groups at 1024 bytes, a tile's panels after
// each other. A block's resident 64 rows (keys for dK and dV, queries for
// dQ) are split into TF32 heads and tails once; each stage of 32 rows of
// the other side is split as it comes, row-major for the products that sum
// over D and transposed (D x 32) for the one that sums over the stage, whose
// A operand (P·g or dS, transposed for dK and dV) comes from the
// accumulator registers. Its k order within each eight is the one the
// accumulator layout gives (lane t holds columns 2t and 2t + 1, taken as
// k = t and t + 4), so the transposed tiles hold their rows in that order.
// Two warpgroups take turns at the stages, each with its own tiles and
// its own half of the sums, so that one multiplies while the other splits;
// the second's sums are added to the first's at the end, in a fixed order.

constexpr int W_THREADS = 256;   // two warpgroups
constexpr int WQ = 32;           // rows a stage
constexpr int RAW_LD = 68;       // padded raw rows of the resident tile
constexpr int W_RES_TILE = BT * 64 * 4;  // 64 rows of 64 floats
constexpr int W_ST_TILE = WQ * 64 * 4;   // 32 x 64 or 64 x 32

template <int R>
__device__ __forceinline__ uint32_t swz(int r, int k) {
    return (k >> 5) * (R * 128) + (r >> 3) * 1024 + (r & 7) * 128 +
           ((((k >> 2) & 7) ^ (r & 7)) << 4) + ((k & 3) << 2);
}

// The position of a stage's row q along K in the transposed tiles.
__device__ __forceinline__ int k_order(int q) {
    return (q & ~7) | ((q & 1) << 2) | ((q & 7) >> 1);
}

__device__ __forceinline__ float4 tf32_head(float4 x) {
    return make_float4(__uint_as_float(tf32_bits(x.x)), __uint_as_float(tf32_bits(x.y)),
                       __uint_as_float(tf32_bits(x.z)), __uint_as_float(tf32_bits(x.w)));
}
__device__ __forceinline__ float4 tf32_tail(float4 x, float4 h) {
    return tf32_head(make_float4(x.x - h.x, x.y - h.y, x.z - h.z, x.w - h.w));
}

// Where column c of raw row r lies: rows of LD floats; rows of 64 (a
// stage's raw rows, unpadded) have their 16-byte chunks swizzled by the row,
// so that the lanes of a warp that read one column of 32 rows hit 32 banks.
template <int LD>
__device__ __forceinline__ int raw_at(int r, int c) {
    return LD == 64 ? r * 64 + ((((c >> 2) ^ r) & 7) << 2) + (c & ~31) + (c & 3) : r * LD + c;
}

// Rows [r0, r0 + R) (row(r) points at row r of 64 floats) into raw rows of
// LD floats by THREADS threads; rows past n as zeros.
template <int R, int LD, int THREADS, class Row>
__device__ __forceinline__ void load_tile(float* dst, Row row, const float* any, int r0, int n,
                                          int tid) {
    for (int i = tid; i < R * 16; i += THREADS) {
        const int r = i >> 4, c = (i & 15) << 2;
        const bool in = r0 + r < n;
        cp_async16(dst + raw_at<LD>(r, c), in ? row(r0 + r) + c : any, in);
    }
}

// R raw rows (LD floats apart) to the heads and tails of an R x 64 K-major tile.
template <int R, int LD, int THREADS>
__device__ __forceinline__ void split_rows(uint8_t* hi, uint8_t* lo, const float* raw, int tid) {
    for (int i = tid; i < R * 16; i += THREADS) {
        const int r = i >> 4, c = (i & 15) << 2;
        const float4 x = *reinterpret_cast<const float4*>(raw + raw_at<LD>(r, c));
        const float4 h = tf32_head(x);
        *reinterpret_cast<float4*>(hi + swz<R>(r, c)) = h;
        *reinterpret_cast<float4*>(lo + swz<R>(r, c)) = tf32_tail(x, h);
    }
}

// A stage's WQ raw rows (64 floats each) to the heads and tails of the
// WQ x 64 tile and of the transposed 64 x WQ one (rows in k_order), by one
// warpgroup: lane q takes row q, warp w columns 16w .. 16w + 15, and every
// store of a warp hits 32 banks.
__device__ __forceinline__ void split_stage(uint8_t* hi, uint8_t* lo, uint8_t* thi, uint8_t* tlo,
                                            const float* raw, int tid) {
    const int w = tid / 32, qr = tid % 32, kq = k_order(qr);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int c = 16 * w + 4 * i;
        const float4 x = *reinterpret_cast<const float4*>(raw + raw_at<64>(qr, c));
        const float4 h = tf32_head(x), l = tf32_tail(x, h);
        *reinterpret_cast<float4*>(hi + swz<WQ>(qr, c)) = h;
        *reinterpret_cast<float4*>(lo + swz<WQ>(qr, c)) = l;
        const float hv[4] = {h.x, h.y, h.z, h.w}, lv[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            *reinterpret_cast<float*>(thi + swz<BT>(c + j, kq)) = hv[j];
            *reinterpret_cast<float*>(tlo + swz<BT>(c + j, kq)) = lv[j];
        }
    }
}

// c = A·Bᵀ, 64 x WQ, D deep: A the resident 64 x 64 tile (heads at ah,
// tails at al), B the stage's WQ x 64 tile (bh, bl). Issued, not waited for.
__device__ __forceinline__ void wgmma_scores(float (&c)[16], uint32_t ah, uint32_t al,
                                             uint32_t bh, uint32_t bl) {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
        const uint32_t ka = (kk >> 2) * (BT * 128) + (kk & 3) * 32;
        const uint32_t kb = (kk >> 2) * (WQ * 128) + (kk & 3) * 32;
        const uint64_t dah = desc_k_major(ah + ka), dbh = desc_k_major(bh + kb);
        wgmma_tf32_ss_n32(c, dah, dbh, 1);
        wgmma_tf32_ss_n32(c, dah, desc_k_major(bl + kb), 1);
        wgmma_tf32_ss_n32(c, desc_k_major(al + ka), dbh, 1);
    }
}

// acc += a·B: a this warp's 16 rows x WQ in the accumulator layout, B a
// transposed tile (64 x WQ, heads at bh, tails at bl): WQ deep on the
// tensor cores, added to acc on the FMA pipe.
__device__ __forceinline__ void wgmma_accumulate(float (&acc)[8][4], const float (&a)[16],
                                                 uint32_t bh, uint32_t bl) {
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        split_tf32(a[4 * j], ah[j][0], al[j][0]);
        split_tf32(a[4 * j + 2], ah[j][1], al[j][1]);
        split_tf32(a[4 * j + 1], ah[j][2], al[j][2]);
        split_tf32(a[4 * j + 3], ah[j][3], al[j][3]);
    }
    float part[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) part[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const uint64_t dbh = desc_k_major(bh + 32 * j);
        wgmma_tf32_rs_n64(part, ah[j], dbh, 1);
        wgmma_tf32_rs_n64(part, ah[j], desc_k_major(bl + 32 * j), 1);
        wgmma_tf32_rs_n64(part, al[j], dbh, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_registers(part);
#pragma unroll
    for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][e] += part[4 * m + e];
}

// The second warpgroup's sums (one or two 64 x 64 accumulators) added to
// the first's through shared memory at red.
__device__ __forceinline__ void add_second_half(float (&a)[8][4], float (&b)[8][4], bool two,
                                                float* red, int wg, int tid) {
    __syncthreads();  // every tile is free
    if (wg == 1) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            red[i * 128 + tid] = a[i / 4][i % 4];
            if (two) red[(32 + i) * 128 + tid] = b[i / 4][i % 4];
        }
    }
    __syncthreads();
    if (wg == 0) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            a[i / 4][i % 4] += red[i * 128 + tid];
            if (two) b[i / 4][i % 4] += red[(32 + i) * 128 + tid];
        }
    }
}

__device__ __forceinline__ uint8_t* align_1024(unsigned char* p) {
    return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                      ~static_cast<uintptr_t>(1023));
}

// Launch 1: Q and dO resident, key stages streamed in one pass: S and dP,
// then dQ += dS·K with P taken against each row's running maximum, as the
// forward's online softmax does, and the sums rescaled when it grows; the
// sum of P divides dQ at the end and gives the log-sum-exp.
constexpr int W_KV_RAW = 2 * WQ * 64;  // a stage's raw K and V rows
constexpr size_t W_Q_SMEM_BYTES =
    1024 + 4 * W_RES_TILE + 12 * W_ST_TILE + (2 * W_KV_RAW + 4 * BT) * 4;

template <class G>
__global__ void __launch_bounds__(W_THREADS, 1)
    attention_bwd_q_wgmma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                 const float* __restrict__ v, G gr, float* __restrict__ dq,
                                 float* __restrict__ lse_out, float* __restrict__ delta_out,
                                 int n, int n_valid, float scale) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    uint8_t* QH = align_1024(smem_raw);
    uint8_t* QL = QH + W_RES_TILE;
    uint8_t* OH = QL + W_RES_TILE;
    uint8_t* OL = OH + W_RES_TILE;
    uint8_t* tiles = OL + W_RES_TILE;  // each warpgroup: K, V (WQ x 64), Kᵀ (64 x WQ)
    const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
    uint8_t* KH = tiles + wg * 6 * W_ST_TILE;
    uint8_t* KL = KH + W_ST_TILE;
    uint8_t* VH = KL + W_ST_TILE;
    uint8_t* VL = VH + W_ST_TILE;
    uint8_t* KTH = VL + W_ST_TILE;
    uint8_t* KTL = KTH + W_ST_TILE;
    float* raw = reinterpret_cast<float*>(tiles + 12 * W_ST_TILE) + wg * W_KV_RAW;
    float* ml = reinterpret_cast<float*>(tiles + 12 * W_ST_TILE) + 2 * W_KV_RAW;  // 2 x 64 x 2
    float* qraw = reinterpret_cast<float*>(tiles);  // at the start, over the stage tiles
    float* oraw = qraw + BT * RAW_LD;
    const int bh = blockIdx.x, q0 = blockIdx.y * BT;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const size_t base = (size_t)bh * n * 64;
    const float c2 = scale * LOG2E;
    const int nkt = (n_valid + WQ - 1) / WQ;
    // A warpgroup takes the key stages kt = wg, wg + 2, ...
    auto prefetch = [&](int kt) {
        if (kt < nkt) {
            load_tile<WQ, 64, 128>(raw, [&](int r) { return k + base + (size_t)r * 64; }, k,
                                   kt * WQ, n, tid);
            load_tile<WQ, 64, 128>(raw + WQ * 64,
                                   [&](int r) { return v + base + (size_t)r * 64; }, v, kt * WQ,
                                   n, tid);
        }
        cp_async_commit();
    };

    load_tile<BT, RAW_LD, W_THREADS>(qraw, [&](int r) { return q + base + (size_t)r * 64; }, q,
                                     q0, n, threadIdx.x);
    load_tile<BT, RAW_LD, W_THREADS>(oraw, [&](int r) { return gr.dout + gr.off(bh, r); },
                                     gr.dout, q0, n, threadIdx.x);
    cp_async_commit();
    prefetch(wg);
    cp_async_wait<1>();
    __syncthreads();
    split_rows<BT, RAW_LD, W_THREADS>(QH, QL, qraw, threadIdx.x);
    split_rows<BT, RAW_LD, W_THREADS>(OH, OL, oraw, threadIdx.x);
    const int r0 = q0 + warp * 16;
    float dlt[2], gain[2];
    row_deltas<64>(dlt, oraw + warp * 16 * RAW_LD, gr, bh, r0, n, delta_out);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const float* gp = r0 + g + 8 * h < n ? gr.gate(bh, r0 + g + 8 * h) : nullptr;
        gain[h] = gp != nullptr ? *gp : 1.f;
    }
    __syncthreads();  // qraw and oraw are read; the tiles are free
    const uint32_t qh = smem_u32(QH), ql = smem_u32(QL), oh = smem_u32(OH), ol = smem_u32(OL),
                   kh = smem_u32(KH), kl = smem_u32(KL), vh = smem_u32(VH), vl = smem_u32(VL);

    // This warpgroup's running maximum (base 2) and sum of each row, and its
    // dQ against that maximum.
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float acc[8][4];
    zero<64>(acc);
#pragma unroll 1
    for (int kt = wg; kt < nkt; kt += 2) {
        cp_async_wait<0>();
        named_barrier_sync(1 + wg, 128);  // its raw stage is in; its tiles are free
        split_stage(KH, KL, KTH, KTL, raw, tid);
        split_rows<WQ, 64, 128>(VH, VL, raw + WQ * 64, tid);
        fence_proxy_async();
        named_barrier_sync(1 + wg, 128);
        prefetch(kt + 2);
        float sc[16], ds[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) sc[i] = ds[i] = 0.f;
        wgmma_fence();
        wgmma_scores(sc, qh, ql, kh, kl);
        wgmma_scores(ds, oh, ol, vh, vl);
        wgmma_commit();
        wgmma_wait<0>();
        fence_registers(sc);
        fence_registers(ds);
        const int k0 = kt * WQ;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            float mx = -INFINITY;
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int e = 2 * h; e < 2 * h + 2; ++e) {
                    sc[4 * j + e] = k0 + 8 * j + 2 * t + (e & 1) < n_valid
                                        ? sc[4 * j + e] * c2
                                        : -INFINITY;
                    mx = fmaxf(mx, sc[4 * j + e]);
                }
            // Key k0 is valid, so every stage's maximum is finite.
            const float mn = fmaxf(m[h], quad_max(mx));
            const float alpha = exp2_approx(m[h] - mn);
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int e = 2 * h; e < 2 * h + 2; ++e) {
                    const int i = 4 * j + e;
                    const float pe = exp2_approx(sc[i] - mn);
                    sum += pe;
                    ds[i] = pe * (ds[i] * gain[h] - dlt[h]);
                }
            l[h] = l[h] * alpha + quad_sum(sum);
            m[h] = mn;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                acc[j][2 * h] *= alpha;
                acc[j][2 * h + 1] *= alpha;
            }
        }
        wgmma_accumulate(acc, ds, smem_u32(KTH), smem_u32(KTL));
    }
    // The two warpgroups' maxima, sums and dQ, merged in one order.
    if (t == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = warp * 16 + g + 8 * h;
            ml[(wg * BT + row) * 2] = m[h];
            ml[(wg * BT + row) * 2 + 1] = l[h];
        }
    }
    __syncthreads();
    float lse2[2], mul[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int row = warp * 16 + g + 8 * h;
        const float m0 = ml[row * 2], l0 = ml[row * 2 + 1];
        const float m1 = ml[(BT + row) * 2], l1 = ml[(BT + row) * 2 + 1];
        const float mm = fmaxf(m0, m1);
        const float a0 = exp2_approx(m0 - mm), a1 = exp2_approx(m1 - mm);
        const float lsum = l0 * a0 + l1 * a1;
        lse2[h] = mm + log2f(lsum);
        mul[h] = (wg == 0 ? a0 : a1) / lsum;  // this half's factor, with 1 / l
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] *= mul[e >> 1];
    add_second_half(acc, acc, false, reinterpret_cast<float*>(tiles), wg, tid);
    if (wg == 0) {
        store_rows<64>(dq + base, acc, r0, n, scale, g, t);
        if (t == 0) {
#pragma unroll
            for (int h = 0; h < 2; ++h)
                if (r0 + g + 8 * h < n) lse_out[(size_t)bh * n + r0 + g + 8 * h] = lse2[h];
        }
    }
}

// Launch 2: K and V resident, query stages streamed: Sᵀ = K·Qᵀ, dPᵀ =
// V·dOᵀ, then dV += (P·g)ᵀ·dO and dK += dSᵀ·Q. Key tiles wholly past
// n_valid write zeros.
constexpr int W_Q_RAW = 2 * WQ * 64;   // a stage's raw Q and dO rows
constexpr int W_VEC = 3 * WQ;          // its log-sum-exp, Δ and gains
constexpr size_t W_KV_SMEM_BYTES =
    1024 + 4 * W_RES_TILE + 16 * W_ST_TILE + (2 * W_Q_RAW + 4 * W_VEC) * 4;

template <class G>
__global__ void __launch_bounds__(W_THREADS, 1)
    attention_bwd_kv_wgmma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                  const float* __restrict__ v, G gr,
                                  const float* __restrict__ lse_g,
                                  const float* __restrict__ delta_g, float* __restrict__ dk,
                                  float* __restrict__ dv, int n, int n_valid, float scale) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    uint8_t* KH = align_1024(smem_raw);
    uint8_t* KL = KH + W_RES_TILE;
    uint8_t* VH = KL + W_RES_TILE;
    uint8_t* VL = VH + W_RES_TILE;
    uint8_t* tiles = VL + W_RES_TILE;  // each warpgroup: Q, dO (WQ x 64), Qᵀ, dOᵀ (64 x WQ)
    const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
    uint8_t* QH = tiles + wg * 8 * W_ST_TILE;
    uint8_t* QL = QH + W_ST_TILE;
    uint8_t* OH = QL + W_ST_TILE;
    uint8_t* OL = OH + W_ST_TILE;
    uint8_t* QTH = OL + W_ST_TILE;
    uint8_t* QTL = QTH + W_ST_TILE;
    uint8_t* OTH = QTL + W_ST_TILE;
    uint8_t* OTL = OTH + W_ST_TILE;
    float* raw = reinterpret_cast<float*>(tiles + 16 * W_ST_TILE) + wg * W_Q_RAW;
    float* vecs = reinterpret_cast<float*>(tiles + 16 * W_ST_TILE) + 2 * W_Q_RAW + wg * 2 * W_VEC;
    const int bh = blockIdx.x, k0 = blockIdx.y * BT;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const size_t base = (size_t)bh * n * 64;
    const int r0 = k0 + warp * 16;

    float acc_k[8][4], acc_v[8][4];
    zero<64>(acc_k);
    zero<64>(acc_v);
    if (k0 < n_valid) {  // a key tile wholly past n_valid has no gradient
        const float c2 = scale * LOG2E;
        const int nqs = (n + WQ - 1) / WQ;
        auto qrow = [&](int r) { return q + base + (size_t)r * 64; };
        auto orow = [&](int r) { return gr.dout + gr.off(bh, r); };
        // A warpgroup takes the stages s = wg, wg + 2, ...; raw rows into
        // raw, the vectors into vecs[(s / 2) % 2].
        auto prefetch = [&](int s) {
            if (s < nqs) {
                const int q0 = s * WQ;
                load_tile<WQ, 64, 128>(raw, qrow, q, q0, n, tid);
                load_tile<WQ, 64, 128>(raw + WQ * 64, orow, gr.dout, q0, n, tid);
                float* vec = vecs + ((s >> 1) & 1) * W_VEC;
                if (tid < 2 * WQ) {
                    const int r = tid % WQ;
                    const bool in = q0 + r < n;
                    const float* src = tid < WQ ? lse_g : delta_g;
                    cp_async4(vec + tid, in ? src + (size_t)bh * n + q0 + r : src, in);
                } else if (tid < 3 * WQ) {
                    const int r = tid - 2 * WQ;
                    const float* gp = q0 + r < n ? gr.gate(bh, q0 + r) : nullptr;
                    if (gp != nullptr)
                        cp_async4(vec + tid, gp, true);
                    else
                        vec[tid] = q0 + r < n ? 1.f : 0.f;
                }
            }
            cp_async_commit();
        };
        // K and V come in raw over the stage tiles and are split once.
        float* kraw = reinterpret_cast<float*>(tiles);
        float* vraw = kraw + BT * RAW_LD;
        load_tile<BT, RAW_LD, W_THREADS>(kraw, [&](int r) { return k + base + (size_t)r * 64; },
                                         k, k0, n, threadIdx.x);
        load_tile<BT, RAW_LD, W_THREADS>(vraw, [&](int r) { return v + base + (size_t)r * 64; },
                                         v, k0, n, threadIdx.x);
        cp_async_commit();
        prefetch(wg);
        cp_async_wait<1>();
        __syncthreads();
        split_rows<BT, RAW_LD, W_THREADS>(KH, KL, kraw, threadIdx.x);
        split_rows<BT, RAW_LD, W_THREADS>(VH, VL, vraw, threadIdx.x);
        __syncthreads();  // kraw and vraw are read; the stage tiles are free
        const bool key_in[2] = {r0 + g < n_valid, r0 + g + 8 < n_valid};
        const uint32_t kh = smem_u32(KH), kl = smem_u32(KL), vh = smem_u32(VH),
                       vl = smem_u32(VL);
#pragma unroll 1
        for (int s = wg; s < nqs; s += 2) {
            cp_async_wait<0>();
            named_barrier_sync(1 + wg, 128);  // its raw stage is in; its tiles are free
            split_stage(QH, QL, QTH, QTL, raw, tid);
            split_stage(OH, OL, OTH, OTL, raw + WQ * 64, tid);
            fence_proxy_async();
            named_barrier_sync(1 + wg, 128);
            const float* vec = vecs + ((s >> 1) & 1) * W_VEC;
            prefetch(s + 2);
            float sT[16], dpT[16];
#pragma unroll
            for (int i = 0; i < 16; ++i) sT[i] = dpT[i] = 0.f;
            wgmma_fence();
            wgmma_scores(sT, kh, kl, smem_u32(QH), smem_u32(QL));
            wgmma_scores(dpT, vh, vl, smem_u32(OH), smem_u32(OL));
            wgmma_commit();
            wgmma_wait<0>();
            fence_registers(sT);
            fence_registers(dpT);
            // (P·g)ᵀ and dSᵀ in place of Sᵀ and dPᵀ.
            const int q0 = s * WQ;
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int col = 8 * j + 2 * t + (e & 1), i = 4 * j + e;
                    const float pe = key_in[e >> 1] && q0 + col < n
                                         ? exp2_approx(sT[i] * c2 - vec[col])
                                         : 0.f;
                    dpT[i] = pe * (dpT[i] * vec[2 * WQ + col] - vec[WQ + col]);
                    sT[i] = pe * vec[2 * WQ + col];
                }
            wgmma_accumulate(acc_v, sT, smem_u32(OTH), smem_u32(OTL));
            wgmma_accumulate(acc_k, dpT, smem_u32(QTH), smem_u32(QTL));
        }
    }
    add_second_half(acc_k, acc_v, true, reinterpret_cast<float*>(tiles), wg, tid);
    if (wg == 0) {
        store_rows<64>(dk + base, acc_k, r0, n, scale, g, t);
        store_rows<64>(dv + base, acc_v, r0, n, 1.f, g, t);
    }
}

// ---------------------------------------------------------------------------
// n <= 64: one launch, a block per sequence.

template <int DH>
constexpr size_t SHORT_SMEM_BYTES = ((size_t)4 * BT * (DH + 4) + BT) * 4;

template <int DH, class G>
__global__ void __launch_bounds__(BWD_THREADS)
    attention_bwd_short_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, G gr, float* __restrict__ dq,
                               float* __restrict__ dk, float* __restrict__ dv,
                               float* __restrict__ lse_out, float* __restrict__ delta_out, int n,
                               int n_valid, float scale) {
    extern __shared__ __align__(16) float smem[];
    constexpr int LD = DH + 4, TILE = BT * LD;
    float* Qs = smem;
    float* dOs = Qs + TILE;
    float* Ks = dOs + TILE;  // then (P·g)ᵀ: rows keys, columns queries
    float* Vs = Ks + TILE;   // then dSᵀ
    float* gain_s = Vs + TILE;
    const int bh = blockIdx.x;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const size_t base = (size_t)bh * n * DH;
    const float c2 = scale * LOG2E;
    const int r0 = warp * 16;

    load_rows<BT, DH>(Qs, q + base, 0, n);
    load_grad_rows<BT, DH>(dOs, gr, bh, 0, n);
    load_rows<BT, DH>(Ks, k + base, 0, n);
    load_rows<BT, DH>(Vs, v + base, 0, n);
    load_gains<BT>(gain_s, gr, bh, 0, n);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // Queries on the rows: the log-sum-exp over the one key tile, P, dS, dQ.
    const float* Qw = Qs + r0 * LD;
    const float* dOw = dOs + r0 * LD;
    float dlt[2], lse2[2];
    const float gain[2] = {gain_s[r0 + g], gain_s[r0 + g + 8]};
    row_deltas<DH>(dlt, dOw, gr, bh, r0, n, delta_out);
    float acc[DH / 8][4];
    zero<DH>(acc);
    {
        float s[8][4];
        scores<8, DH>(s, Qw, Ks, g, t);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            float mx = -INFINITY;
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int e = 2 * h; e < 2 * h + 2; ++e)
                    if (8 * j + 2 * t + (e & 1) < n_valid) mx = fmaxf(mx, s[j][e] * c2);
            mx = quad_max(mx);
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int e = 2 * h; e < 2 * h + 2; ++e)
                    if (8 * j + 2 * t + (e & 1) < n_valid) sum += exp2_approx(s[j][e] * c2 - mx);
            lse2[h] = mx + log2f(quad_sum(sum));
        }
    }
    float p[8][4], ds[8][4];
    dq_step<DH>(acc, p, ds, Qw, dOw, Ks, Vs, lse2, dlt, gain, 0, n_valid, c2, g, t);
    store_rows<DH>(dq + base, acc, r0, n, scale, g, t);
    if (t == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
            if (r0 + g + 8 * h < n) lse_out[(size_t)bh * n + r0 + g + 8 * h] = lse2[h];
    }
    __syncthreads();  // K and V are no longer read
    // (P·g)ᵀ and dSᵀ over K and V; queries past n count nothing.
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int key = 8 * j + 2 * t + (e & 1), qr = r0 + g + 8 * (e >> 1);
            const bool in = qr < n;
            Ks[key * LD + qr] = in ? p[j][e] * gain[e >> 1] : 0.f;
            Vs[key * LD + qr] = in ? ds[j][e] : 0.f;
        }
    __syncthreads();

    // Keys on the rows: dV = (P·g)ᵀ·dO and dK = dSᵀ·Q, their A operand read
    // from shared memory in the accumulator layout accumulate() takes.
    float acc2[DH / 8][4];
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
        const float* W = (pass == 0 ? Ks : Vs) + r0 * LD;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const float2 a = *reinterpret_cast<const float2*>(W + g * LD + 8 * j + 2 * t);
            const float2 b = *reinterpret_cast<const float2*>(W + (g + 8) * LD + 8 * j + 2 * t);
            p[j][0] = a.x, p[j][1] = a.y, p[j][2] = b.x, p[j][3] = b.y;
        }
        zero<DH>(acc2);
        accumulate<8, DH>(acc2, p, pass == 0 ? dOs : Qs, g, t);
        store_rows<DH>((pass == 0 ? dv : dk) + base, acc2, r0, n, pass == 0 ? 1.f : scale, g, t);
    }
}

template <int DH, class G>
cudaError_t run_attention_bwd(const float* q, const float* k, const float* v, const G& gr,
                              float* dq, float* dk, float* dv, float* lse, float* delta, int bh,
                              int n, int n_valid, float scale, cudaStream_t stream) {
    if (n <= BT)
        return launch_bwd(attention_bwd_short_kernel<DH, G>, dim3(bh), BWD_THREADS,
                          SHORT_SMEM_BYTES<DH>, stream, q, k, v, gr, dq, dk, dv, lse, delta, n,
                          n_valid, scale);
    const dim3 grid(bh, (n + BT - 1) / BT);
    const float* lse_in = lse;
    const float* delta_in = delta;
    if constexpr (DH == 64) {
        const cudaError_t err =
            launch_bwd(attention_bwd_q_wgmma_kernel<G>, grid, W_THREADS, W_Q_SMEM_BYTES,
                       stream, q, k, v, gr, dq, lse, delta, n, n_valid, scale);
        if (err != cudaSuccess) return err;
        return launch_bwd(attention_bwd_kv_wgmma_kernel<G>, grid, W_THREADS, W_KV_SMEM_BYTES,
                          stream, q, k, v, gr, lse_in, delta_in, dk, dv, n, n_valid, scale);
    } else {
        const cudaError_t err =
            launch_bwd(attention_bwd_q_kernel<DH, G>, grid, BWD_THREADS, DQ_SMEM_BYTES<DH>,
                       stream, q, k, v, gr, dq, lse, delta, n, n_valid, scale);
        if (err != cudaSuccess) return err;
        return launch_bwd(attention_bwd_kv_kernel<DH, G>, grid, BWD_THREADS, DKV_SMEM_BYTES<DH>,
                          stream, q, k, v, gr, lse_in, delta_in, dk, dv, n, n_valid, scale);
    }
}

}  // namespace asep

#include "attention_bwd_bf16.cuh"

// dtype: 0 = float32, 1 = bfloat16 (layout 1 only). layout 0: o and dout are
// (bh, n, dh), dh 64 or 128. layout 1: o and dout are the merged heads (bh /
// heads, n, heads·64), gates (bh, n), dh 64. q, k, v, dq, dk, dv are (bh, n,
// dh) and, with o and dout, of type dtype; gates float32; lse and delta (bh,
// n) are written, float32: lse is the row log-sum-exp of the scaled scores in
// base 2 (scratch for the second launch), delta is Δ (which the attention
// block's gate gradient reads). Contiguous, 16-byte aligned (bf16: TMA).
// Both types: n <= 64 takes one launch, longer sequences two. Returns 0 or
// the first CUDA error.
extern "C" int asep_attention_bwd(int dtype, int layout, const void* q, const void* k,
                                  const void* v, const void* o, const void* dout,
                                  const void* gates, void* dq, void* dk, void* dv, void* lse,
                                  void* delta, int bh, int n, int n_valid, int dh, int heads,
                                  float scale, void* stream) {
    if (bh < 1 || n < 1 || n_valid < 1 || n_valid > n) return cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 1) {
        if (layout != 1 || dh != 64 || heads < 1 || bh % heads) return cudaErrorInvalidValue;
        using asep::bf16;
        const asep::bwd_bf16::MergedGated g{static_cast<const bf16*>(o),
                                            static_cast<const bf16*>(dout),
                                            static_cast<const float*>(gates), n, heads};
        return asep::bwd_bf16::run(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                   static_cast<const bf16*>(v), g, static_cast<bf16*>(dq),
                                   static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                                   static_cast<float*>(lse), static_cast<float*>(delta), bh, n,
                                   n_valid, scale, s);
    }
    if (dtype != 0) return cudaErrorInvalidValue;
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
