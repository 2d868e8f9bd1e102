// The bf16 form of the attention backward (K1), in the attention block's
// gated layout only (MergedGatedGrad's: merged = O·g and d_merged as (B, n,
// heads·64) bf16, the gates (B·heads, n) float32), for the bf16 training
// step of the RoFormer family. Included by attention_bwd.cu, whose comment
// gives the formulas; the whole-sequence layout has no bf16 form (its only
// caller, HTDemucs training, is float32: ROADMAP C16).
//
// Arithmetic: q, k, v, merged and d_merged are bf16 and go straight onto the
// tensor cores, one bf16 product a term (mma.sync.m16n8k16, float32
// accumulators); the scores, the log-sum-exp, P, Δ and the sums are float32.
// P·g and dS are rounded to bf16 as the A operands of the products that sum
// over the sequence (dV, dQ, dK), as the forward rounds P before its PV
// product; dq, dk and dv are written as bf16, lse and Δ as float32.
//
// What bounds it on the card: at the flagship's time axis (n 832) the
// products, five N²·D products over a few N·D bytes; at its frequency axis
// (n 64) the bytes. Design (a simple kernel first, the float32 form's two
// launches): a block of four warps, each owning 16 of the block's 64 rows,
//   1. attention_bwd_dq_bf16_kernel, a block per (batch·head, 64 queries),
//      Q and d_merged resident (their fragments in registers): Δ of its
//      rows, a first pass over the key tiles for the row log-sum-exp, a
//      second for S, dP, dS and dQ += dS·K;
//   2. attention_bwd_dkv_bf16_kernel, a block per (batch·head, 64 keys), K
//      and V resident: query tiles stream through, Sᵀ and dPᵀ with the keys
//      on the rows, then dV += (P·g)ᵀ·d_merged and dK += dSᵀ·Q; key tiles
//      wholly past n_valid write zeros.
// Tiles of 64 rows come in by cp.async into rows of 72 bf16 (the 32-bit
// fragment loads and ldmatrix's 16-byte rows then hit 32 banks), double
// buffered; S and dP are taken 32 columns at a time, so a warp holds 32
// accumulators each for them and 64 for its outputs. The A operand of each
// sum over the sequence comes straight from the accumulator registers (the
// m16n8k16 C layout of two neighbouring 8-column tiles is the A layout of one
// 16-deep step); its B operand, a tile read transposed, comes by
// ldmatrix.trans.
#pragma once

namespace asep {
namespace bwd_bf16 {

constexpr int ROWS = 64;     // a block's resident rows, and a streamed tile's
constexpr int LDB = 72;      // bf16 a shared-memory row: 64 and 8 of padding
constexpr int TILE = ROWS * LDB;
constexpr int THREADS = 128;  // four warps of 16 rows

struct MergedGated {
    const bf16* o;       // merged (B, n, heads·64)
    const bf16* dout;    // d_merged, the same layout
    const float* gates;  // (B·heads, n)
    int n, heads;
    __device__ size_t off(int bh, int r) const {
        const int b = bh / heads, h = bh % heads;
        return ((size_t)b * n + r) * heads * 64 + h * 64;
    }
};

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

// d += a·b on the tensor cores: A 16 x 16 and B 16 x 8 bf16, C float32.
// Fragments (g = lane / 4, t = lane % 4): A a0 (g, 2t..2t+1), a1 (g + 8, ..),
// a2 (g, 2t+8..), a3 (g + 8, 2t+8..); B b0 (k 2t..2t+1, n g), b1 (k 2t+8..);
// C c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices from shared memory, transposed: lane L gives the
// address of row L % 8 of matrix L / 8, and receives of matrix i the values
// (2t, g) and (2t + 1, g) as stored, the B fragment of a row-major (k, n)
// tile.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p)))
                 : "memory");
}

// The A fragments over all 64 columns (four 16-deep steps) of this warp's
// 16 rows [r, r + 16) of a tile.
__device__ __forceinline__ void frags_a(uint32_t (&a)[4][4], const bf16* tile, int r, int g,
                                        int t) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
        const bf16* p = tile + (r + g) * LDB + 16 * kk + 2 * t;
        a[kk][0] = ld32(p);
        a[kk][1] = ld32(p + 8 * LDB);
        a[kk][2] = ld32(p + 8);
        a[kk][3] = ld32(p + 8 * LDB + 8);
    }
}

// c = A·Bᵀ over 64 columns: A this warp's 16 rows (fragments a), B rows
// [b0, b0 + 32) of a tile: four 8-column accumulator tiles.
__device__ __forceinline__ void scores32(float (&c)[4][4], const uint32_t (&a)[4][4],
                                         const bf16* tile, int b0, int g, int t) {
#pragma unroll
    for (int j = 0; j < 4; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const bf16* p = tile + (b0 + 8 * j + g) * LDB + 16 * kk + 2 * t;
            mma_bf16(c[j], a[kk], ld32(p), ld32(p + 8));
        }
}

// acc += P·X: P this warp's 16 rows x 32 columns in the accumulator layout
// (as scores32 leaves it), rounded here to bf16; X rows [x0, x0 + 32) of a
// row-major tile, 64 columns (eight 8-column output tiles).
__device__ __forceinline__ void accumulate32(float (&acc)[8][4], const float (&p)[4][4],
                                             const bf16* tile, int x0, int lane) {
    const int i = lane / 8, rr = lane % 8;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
        const uint32_t a[4] = {pack_bf16x2(p[2 * kk][0], p[2 * kk][1]),
                               pack_bf16x2(p[2 * kk][2], p[2 * kk][3]),
                               pack_bf16x2(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                               pack_bf16x2(p[2 * kk + 1][2], p[2 * kk + 1][3])};
        const bf16* row = tile + (x0 + 16 * kk + (i & 1) * 8 + rr) * LDB + (i >> 1) * 8;
#pragma unroll
        for (int m2 = 0; m2 < 4; ++m2) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, row + 16 * m2);
            mma_bf16(acc[2 * m2], a, b[0], b[1]);
            mma_bf16(acc[2 * m2 + 1], a, b[2], b[3]);
        }
    }
}

__device__ __forceinline__ void zero8(float (&acc)[8][4]) {
#pragma unroll
    for (int m = 0; m < 8; ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;
}

// Rows r0 + g and r0 + g + 8 of this warp's 16, times `mul`, to dst (rows of
// 64 bf16); rows at or past n are not written.
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[8][4], int r0, int n,
                                           float mul, int g, int t) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = r0 + g + 8 * h;
        if (r >= n) continue;
#pragma unroll
        for (int m = 0; m < 8; ++m)
            *reinterpret_cast<uint32_t*>(dst + (size_t)r * 64 + 8 * m + 2 * t) =
                pack_bf16x2(acc[m][2 * h] * mul, acc[m][2 * h + 1] * mul);
    }
}

// Rows [r0, r0 + 64) (row(r) points at row r of 64 bf16) into a tile by
// cp.async, 16 bytes a thread; rows past n as zeros.
template <class Row>
__device__ __forceinline__ void load_tile(bf16* dst, Row row, const bf16* any, int r0, int n) {
    for (int i = threadIdx.x; i < ROWS * 8; i += THREADS) {
        const int r = i >> 3, c = (i & 7) * 8;
        const bool in = r0 + r < n;
        cp_async16(dst + r * LDB + c, in ? row(r0 + r) + c : any, in);
    }
}

// Launch 1: Δ, the log-sum-exp and dQ, Q and d_merged resident.
constexpr size_t DQ_SMEM_BYTES = (size_t)6 * TILE * sizeof(bf16);  // Q, dO, two (K, V)

__global__ void __launch_bounds__(THREADS)
    attention_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                 const bf16* __restrict__ v, MergedGated gr,
                                 bf16* __restrict__ dq, float* __restrict__ lse_out,
                                 float* __restrict__ delta_out, int n, int n_valid,
                                 float scale) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
    bf16* dOs = Qs + TILE;
    bf16* Ks = dOs + TILE;     // two stages
    bf16* Vs = Ks + 2 * TILE;  // two stages
    const int bh = blockIdx.x, q0 = blockIdx.y * ROWS;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const size_t base = (size_t)bh * n * 64;
    const float c2 = scale * LOG2E;
    const int nkt = (n_valid + ROWS - 1) / ROWS;
    auto krow = [&](int r) { return k + base + (size_t)r * 64; };
    auto vrow = [&](int r) { return v + base + (size_t)r * 64; };
    // Items 0 .. nkt - 1 bring K tiles (pass 1), nkt .. 2nkt - 1 K and V
    // (pass 2), each into stage item % 2; a group is committed every item.
    auto prefetch = [&](int it) {
        if (it < 2 * nkt) {
            const int kt = it < nkt ? it : it - nkt;
            load_tile(Ks + (it & 1) * TILE, krow, k, kt * ROWS, n);
            if (it >= nkt) load_tile(Vs + (it & 1) * TILE, vrow, v, kt * ROWS, n);
        }
        cp_async_commit();
    };
    load_tile(Qs, [&](int r) { return q + base + (size_t)r * 64; }, q, q0, n);
    load_tile(dOs, [&](int r) { return gr.dout + gr.off(bh, r); }, gr.dout, q0, n);
    prefetch(0);

    const int r0 = q0 + warp * 16;
    uint32_t qf[4][4], of[4][4];
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, lse2[2] = {0.f, 0.f};
    float dlt[2] = {0.f, 0.f}, gain[2] = {0.f, 0.f};
    float acc[8][4];
    zero8(acc);
#pragma unroll 1
    for (int it = 0; it < 2 * nkt; ++it) {
        prefetch(it + 1);
        cp_async_wait<1>();
        __syncthreads();
        if (it == 0) {
            frags_a(qf, Qs, warp * 16, g, t);
            frags_a(of, dOs, warp * 16, g, t);
            // Δ of the warp's 16 rows: lanes over the columns, a warp sum a row.
#pragma unroll 1
            for (int rr = 0; rr < 16; ++rr) {
                const int r = r0 + rr;
                float part = 0.f;
                if (r < n) {
                    const float2 d2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                        dOs + (warp * 16 + rr) * LDB + 2 * lane));
                    const float2 o2 = __bfloat1622float2(
                        *reinterpret_cast<const __nv_bfloat162*>(gr.o + gr.off(bh, r) + 2 * lane));
                    part = d2.x * o2.x + d2.y * o2.y;
                }
                const float dsum = warp_sum(part);
                if (rr == g) dlt[0] = dsum;
                if (rr == g + 8) dlt[1] = dsum;
                if (lane == 0 && r < n) delta_out[(size_t)bh * n + r] = dsum;
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = r0 + g + 8 * h;
                gain[h] = r < n ? gr.gates[(size_t)bh * n + r] : 0.f;
            }
        }
        const bool pass2 = it >= nkt;
        const int kt = pass2 ? it - nkt : it;
        const bf16* Kt = Ks + (it & 1) * TILE;
        const bf16* Vt = Vs + (it & 1) * TILE;
#pragma unroll 1
        for (int half = 0; half < 2; ++half) {
            const int kb = kt * ROWS + 32 * half;
            if (kb >= n_valid) break;
            float s[4][4];
            scores32(s, qf, Kt, 32 * half, g, t);
            if (!pass2) {
                // The running maximum and sum of each row (base 2). Key kb
                // is valid, so the maximum is finite.
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    float mx = -INFINITY;
#pragma unroll
                    for (int j = 0; j < 4; ++j)
#pragma unroll
                        for (int e = 2 * h; e < 2 * h + 2; ++e) {
                            s[j][e] = kb + 8 * j + 2 * t + (e & 1) < n_valid ? s[j][e] * c2
                                                                             : -INFINITY;
                            mx = fmaxf(mx, s[j][e]);
                        }
                    const float mn = fmaxf(m[h], quad_max(mx));
                    float sum = 0.f;
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        sum += exp2_approx(s[j][2 * h] - mn) + exp2_approx(s[j][2 * h + 1] - mn);
                    l[h] = l[h] * exp2_approx(m[h] - mn) + quad_sum(sum);
                    m[h] = mn;
                }
            } else {
                float dp[4][4];
                scores32(dp, of, Vt, 32 * half, g, t);
#pragma unroll
                for (int j = 0; j < 4; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int h = e >> 1;
                        const float pe = kb + 8 * j + 2 * t + (e & 1) < n_valid
                                             ? exp2_approx(s[j][e] * c2 - lse2[h])
                                             : 0.f;
                        s[j][e] = pe * (dp[j][e] * gain[h] - dlt[h]);  // dS
                    }
                accumulate32(acc, s, Kt, 32 * half, lane);
            }
        }
        if (it == nkt - 1) {
            lse2[0] = m[0] + log2f(l[0]);
            lse2[1] = m[1] + log2f(l[1]);
        }
        __syncthreads();  // stage it % 2 is free for item it + 2
    }
    store_rows(dq + base, acc, r0, n, scale, g, t);
    if (t == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
            if (r0 + g + 8 * h < n) lse_out[(size_t)bh * n + r0 + g + 8 * h] = lse2[h];
    }
}

// Launch 2: dK and dV, K and V resident, the query tiles streamed with their
// log-sum-exp, Δ and gains.
constexpr int VEC_FLOATS = 3 * ROWS;
constexpr size_t DKV_SMEM_BYTES =
    (size_t)6 * TILE * sizeof(bf16) + (size_t)2 * VEC_FLOATS * sizeof(float);

__global__ void __launch_bounds__(THREADS)
    attention_bwd_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                  const bf16* __restrict__ v, MergedGated gr,
                                  const float* __restrict__ lse_g,
                                  const float* __restrict__ delta_g, bf16* __restrict__ dk,
                                  bf16* __restrict__ dv, int n, int n_valid, float scale) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
    bf16* Vs = Ks + TILE;
    bf16* Qs = Vs + TILE;      // two stages
    bf16* dOs = Qs + 2 * TILE;  // two stages
    float* vecs = reinterpret_cast<float*>(dOs + 2 * TILE);  // two of: lse, Δ, gains
    const int bh = blockIdx.x, k0 = blockIdx.y * ROWS;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const size_t base = (size_t)bh * n * 64;
    const int r0 = k0 + warp * 16;

    float acc_k[8][4], acc_v[8][4];
    zero8(acc_k);
    zero8(acc_v);
    if (k0 < n_valid) {  // a key tile wholly past n_valid has no gradient
        const float c2 = scale * LOG2E;
        const int nqs = (n + ROWS - 1) / ROWS;
        auto prefetch = [&](int s) {
            if (s < nqs) {
                const int qs0 = s * ROWS;
                load_tile(Qs + (s & 1) * TILE, [&](int r) { return q + base + (size_t)r * 64; },
                          q, qs0, n);
                load_tile(dOs + (s & 1) * TILE, [&](int r) { return gr.dout + gr.off(bh, r); },
                          gr.dout, qs0, n);
                float* vec = vecs + (s & 1) * VEC_FLOATS;
                for (int i = threadIdx.x; i < VEC_FLOATS; i += THREADS) {
                    const int which = i / ROWS, r = i % ROWS;
                    const bool in = qs0 + r < n;
                    const float* src = which == 0 ? lse_g : (which == 1 ? delta_g : gr.gates);
                    cp_async4(vec + i, in ? src + (size_t)bh * n + qs0 + r : src, in);
                }
            }
            cp_async_commit();
        };
        load_tile(Ks, [&](int r) { return k + base + (size_t)r * 64; }, k, k0, n);
        load_tile(Vs, [&](int r) { return v + base + (size_t)r * 64; }, v, k0, n);
        prefetch(0);
        const bool key_in[2] = {r0 + g < n_valid, r0 + g + 8 < n_valid};
        uint32_t kf[4][4], vf[4][4];
#pragma unroll 1
        for (int s = 0; s < nqs; ++s) {
            prefetch(s + 1);
            cp_async_wait<1>();
            __syncthreads();
            if (s == 0) {
                frags_a(kf, Ks, warp * 16, g, t);
                frags_a(vf, Vs, warp * 16, g, t);
            }
            const bf16* Qt = Qs + (s & 1) * TILE;
            const bf16* dOt = dOs + (s & 1) * TILE;
            const float* vec = vecs + (s & 1) * VEC_FLOATS;
#pragma unroll 1
            for (int half = 0; half < 2; ++half) {
                if (s * ROWS + 32 * half >= n) break;
                float sT[4][4], dpT[4][4];
                scores32(sT, kf, Qt, 32 * half, g, t);
                scores32(dpT, vf, dOt, 32 * half, g, t);
                // (P·g)ᵀ and dSᵀ in place of Sᵀ and dPᵀ.
#pragma unroll
                for (int j = 0; j < 4; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int col = 32 * half + 8 * j + 2 * t + (e & 1);
                        const float pe = key_in[e >> 1] && s * ROWS + col < n
                                             ? exp2_approx(sT[j][e] * c2 - vec[col])
                                             : 0.f;
                        dpT[j][e] = pe * (dpT[j][e] * vec[2 * ROWS + col] - vec[ROWS + col]);
                        sT[j][e] = pe * vec[2 * ROWS + col];
                    }
                accumulate32(acc_v, sT, dOt, 32 * half, lane);
                accumulate32(acc_k, dpT, Qt, 32 * half, lane);
            }
            __syncthreads();  // stage s % 2 is free for stage s + 2
        }
    }
    store_rows(dk + base, acc_k, r0, n, scale, g, t);
    store_rows(dv + base, acc_v, r0, n, 1.f, g, t);
}

inline cudaError_t run(const bf16* q, const bf16* k, const bf16* v, const MergedGated& gr,
                       bf16* dq, bf16* dk, bf16* dv, float* lse, float* delta, int bh, int n,
                       int n_valid, float scale, cudaStream_t stream) {
    const dim3 grid(bh, (n + ROWS - 1) / ROWS);
    const cudaError_t err =
        launch_bwd(attention_bwd_dq_bf16_kernel, grid, THREADS, DQ_SMEM_BYTES, stream, q, k, v,
                   gr, dq, lse, delta, n, n_valid, scale);
    if (err != cudaSuccess) return err;
    return launch_bwd(attention_bwd_dkv_bf16_kernel, grid, THREADS, DKV_SMEM_BYTES, stream, q,
                      k, v, gr, static_cast<const float*>(lse), static_cast<const float*>(delta),
                      dk, dv, n, n_valid, scale);
}

}  // namespace bwd_bf16
}  // namespace asep
