// The bf16 form of the attention backward (K1), in the attention block's
// gated layout only (MergedGatedGrad's: merged = O·g and d_merged as (B, n,
// heads·64) bf16, the gates (B·heads, n) float32), for the bf16 training
// step of the RoFormer family. Included by attention_bwd.cu, whose comment
// gives the formulas; the whole-sequence layout has no bf16 form (its only
// caller, HTDemucs training, is float32: ROADMAP C16).
//
// Arithmetic: q, k, v, merged and d_merged are bf16 and go straight onto the
// tensor cores, one bf16 product a term (float32 accumulators); the scores,
// the log-sum-exp, P, Δ and the sums are float32. P·g and dS are rounded to
// bf16 as the A operands of the products that sum over the sequence (dV, dQ,
// dK), as the forward rounds P before its PV product; dq, dk and dv are
// written as bf16, lse and Δ as float32.
//
// What bounds it on the card, and what the design does about it:
//   * n > 64 (the flagship's time axis, n 832): the products, five N²·D
//     products over a few N·D bytes. Two launches on wgmma (m64n64k16 bf16),
//     a block of two consumer warpgroups, each owning 64 rows of its own,
//     and one producer warpgroup (setmaxnreg: 40 registers, the consumers
//     232). Tiles of 64 rows come by TMA through three-dimensional tensor
//     maps (rows past n read as zeros, never as the next head's; the merged
//     heads through a (B, n, heads·64) map), 128-byte swizzled, the streamed
//     ones through a ring of stages (mbarriers) that the two consumers share;
//     every product reads its operands from shared memory, or its A operand
//     from registers, with no copy in between:
//     1. attention_bwd_dq_wgmma_bf16_kernel, a block per (batch·head, 128
//        queries), Q and d_merged resident: Δ of its rows from d_merged and
//        merged; one pass over the key tiles computes S and dP and
//        accumulates dQ += dS·K (dS from registers, K read MN-major through
//        the transpose bit) against each row's running maximum, rescaled as
//        it grows; dS is rounded to bf16 unnormalised, and the sum of P
//        divides dQ at the end. It stores the log-sum-exp and Δ;
//     2. attention_bwd_dkv_wgmma_bf16_kernel, a block per (batch·head, 128
//        keys), K and V resident: query tiles stream through with their
//        log-sum-exp, Δ and gains (the producer's other warps load those;
//        queries past n get a log-sum-exp of +inf, so P = 0 there); Sᵀ and
//        dPᵀ, then dV += (P·g)ᵀ·d_merged and dK += dSᵀ·Q with P normalised
//        by the stored log-sum-exp (the plain version's rounding points).
//        Key rows wholly past n_valid write zeros.
//     Seven N²·D products where five would do: dQ could take dS from launch
//     2 only through float32 atomics. Each warpgroup keeps every sum of its
//     rows itself, in one order, so two calls give the same bits. Three
//     choices keep the tensor cores fed: the row blocks of one (batch, head)
//     are neighbours in the grid, so the tiles they all stream come from L2
//     (in (batch·head, row block) order every block read them from device
//     memory: launch 2 took 1.18 ms against 0.79 on an H100 80GB HBM3 at
//     700 W, tools/torch_k1_bench.py); each consumer issues a tile's scores
//     together with the tile before's sums product, as the forward kernel
//     does, and runs its softmax while that product is on the tensor cores;
//     and the two consumers issue in turns (named barriers), so that one's
//     softmax falls on the other's products. What
//     is left between these kernels and the tensor cores' rate is each
//     warpgroup's chain of scores, softmax and product with one block an SM
//     (the registers allow no second), exponentials on the SFU, and each
//     block's start and end.
//   * n <= 64 (the flagship's frequency axis: 12 816 sequences of 64 rows):
//     the bytes, q, k, v, merged and d_merged read and dq, dk, dv written
//     once, against products only 64 deep. One launch,
//     attention_bwd_short_bf16_kernel, a block of four warps per sequence on
//     mma.sync.m16n8k16, each warp owning 16 rows: S, the log-sum-exp, P, dP,
//     dS and dQ with the queries on the warps' rows; (P·g)ᵀ and dSᵀ go to
//     shared memory over K and V, then dV and dK with the keys on the rows:
//     five products. Tiles come in by cp.async into rows of 72 bf16 (the
//     32-bit fragment loads and ldmatrix's 16-byte rows then hit 32 banks);
//     37 KB of shared memory and 128 threads a block let four blocks share
//     an SM, so that one block's loads overlap another's products.
#pragma once

namespace asep {
namespace bwd_bf16 {

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

__device__ __forceinline__ uint32_t ld32(const void* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float2 unpack_bf16x2(uint32_t u) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// ---------------------------------------------------------------------------
// n <= 64: one launch on mma.sync, a block of four warps per sequence.

constexpr int ROWS = 64;     // a sequence's rows at most
constexpr int LDB = 72;      // bf16 a shared-memory row: 64 and 8 of padding
constexpr int TILE = ROWS * LDB;
constexpr int THREADS = 128;  // four warps of 16 rows

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

// acc += A·X over one 16-deep step: A this warp's 16 rows as an m16k16
// fragment, X rows [x0, x0 + 16) of a row-major tile, 64 columns (eight
// 8-column output tiles) read transposed by ldmatrix.
__device__ __forceinline__ void mma_k16(float (&acc)[8][4], const uint32_t (&a)[4],
                                        const bf16* tile, int x0, int lane) {
    const int i = lane / 8, rr = lane % 8;
    const bf16* row = tile + (x0 + (i & 1) * 8 + rr) * LDB + (i >> 1) * 8;
#pragma unroll
    for (int m2 = 0; m2 < 4; ++m2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, row + 16 * m2);
        mma_bf16(acc[2 * m2], a, b[0], b[1]);
        mma_bf16(acc[2 * m2 + 1], a, b[2], b[3]);
    }
}

// acc += P·X: P this warp's 16 rows x 32 columns in the accumulator layout
// (as scores32 leaves it), rounded here to bf16 (the C layout of two
// neighbouring 8-column tiles is the A layout of one 16-deep step); X rows
// [x0, x0 + 32) of a row-major tile.
__device__ __forceinline__ void accumulate32(float (&acc)[8][4], const float (&p)[4][4],
                                             const bf16* tile, int x0, int lane) {
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
        const uint32_t a[4] = {pack_bf16x2(p[2 * kk][0], p[2 * kk][1]),
                               pack_bf16x2(p[2 * kk][2], p[2 * kk][3]),
                               pack_bf16x2(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                               pack_bf16x2(p[2 * kk + 1][2], p[2 * kk + 1][3])};
        mma_k16(acc, a, tile, x0 + 16 * kk, lane);
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

// Rows [0, 64) (row(r) points at row r of 64 bf16) into a tile by cp.async,
// 16 bytes a thread; rows past n as zeros.
template <class Row>
__device__ __forceinline__ void load_tile(bf16* dst, Row row, const bf16* any, int n) {
    for (int i = threadIdx.x; i < ROWS * 8; i += THREADS) {
        const int r = i >> 3, c = (i & 7) * 8;
        const bool in = r < n;
        cp_async16(dst + r * LDB + c, in ? row(r) + c : any, in);
    }
}

constexpr size_t SHORT_SMEM_BYTES = (size_t)4 * TILE * sizeof(bf16) + ROWS * sizeof(float);

__global__ void __launch_bounds__(THREADS, 4)
    attention_bwd_short_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                    const bf16* __restrict__ v, MergedGated gr,
                                    bf16* __restrict__ dq, bf16* __restrict__ dk,
                                    bf16* __restrict__ dv, float* __restrict__ lse_out,
                                    float* __restrict__ delta_out, int n_valid, float scale) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
    bf16* dOs = Qs + TILE;
    bf16* Ks = dOs + TILE;  // then (P·g)ᵀ: rows keys, columns queries
    bf16* Vs = Ks + TILE;   // then dSᵀ
    float* gain_s = reinterpret_cast<float*>(Vs + TILE);
    const int n = gr.n, bh = blockIdx.x;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const size_t base = (size_t)bh * n * 64;
    const float c2 = scale * LOG2E;
    const int r0 = warp * 16;

    load_tile(Qs, [&](int r) { return q + base + (size_t)r * 64; }, q, n);
    load_tile(dOs, [&](int r) { return gr.dout + gr.off(bh, r); }, gr.dout, n);
    load_tile(Ks, [&](int r) { return k + base + (size_t)r * 64; }, k, n);
    load_tile(Vs, [&](int r) { return v + base + (size_t)r * 64; }, v, n);
    for (int r = threadIdx.x; r < ROWS; r += THREADS)
        cp_async4(gain_s + r, r < n ? gr.gates + (size_t)bh * n + r : gr.gates, r < n);
    cp_async_commit();
    // Meanwhile merged, Δ's other operand: the warp's 16 rows, two columns a
    // lane.
    uint32_t o_raw[16];
#pragma unroll
    for (int rr = 0; rr < 16; ++rr)
        o_raw[rr] = r0 + rr < n ? ld32(gr.o + gr.off(bh, r0 + rr) + 2 * lane) : 0u;
    cp_async_wait<0>();
    __syncthreads();

    // Δ of the warp's 16 rows: lanes over the columns, a warp sum a row.
    float dlt[2] = {0.f, 0.f};
#pragma unroll
    for (int rr = 0; rr < 16; ++rr) {
        const float2 d2 = unpack_bf16x2(ld32(dOs + (r0 + rr) * LDB + 2 * lane));
        const float2 o2 = unpack_bf16x2(o_raw[rr]);
        const float dsum = warp_sum(d2.x * o2.x + d2.y * o2.y);
        if (rr == g) dlt[0] = dsum;
        if (rr == g + 8) dlt[1] = dsum;
        if (lane == 0 && r0 + rr < n) delta_out[(size_t)bh * n + r0 + rr] = dsum;
    }

    // Queries on the rows: S and dP over the 64 keys, 32 at a time.
    const float gain[2] = {gain_s[r0 + g], gain_s[r0 + g + 8]};
    float s[2][4][4], dp[2][4][4];
    {
        uint32_t f[4][4];
        frags_a(f, Qs, r0, g, t);
        scores32(s[0], f, Ks, 0, g, t);
        scores32(s[1], f, Ks, 32, g, t);
        frags_a(f, dOs, r0, g, t);
        scores32(dp[0], f, Vs, 0, g, t);
        scores32(dp[1], f, Vs, 32, g, t);
    }
    // The log-sum-exp (base 2) of each row over the valid keys.
    float lse2[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int e = 2 * h; e < 2 * h + 2; ++e) {
                    s[hf][j][e] = 32 * hf + 8 * j + 2 * t + (e & 1) < n_valid ? s[hf][j][e] * c2
                                                                              : -INFINITY;
                    mx = fmaxf(mx, s[hf][j][e]);
                }
        mx = quad_max(mx);
        float sum = 0.f;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
            for (int j = 0; j < 4; ++j)
                sum += exp2_approx(s[hf][j][2 * h] - mx) + exp2_approx(s[hf][j][2 * h + 1] - mx);
        lse2[h] = mx + log2f(quad_sum(sum));
    }
    // P in place of S, dS in place of dP; dQ += dS·K.
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int h = e >> 1;
                const float pe = exp2_approx(s[hf][j][e] - lse2[h]);  // masked keys: 0
                dp[hf][j][e] = pe * (dp[hf][j][e] * gain[h] - dlt[h]);
                s[hf][j][e] = pe;
            }
    float acc[8][4];
    zero8(acc);
    accumulate32(acc, dp[0], Ks, 0, lane);
    accumulate32(acc, dp[1], Ks, 32, lane);
    store_rows(dq + base, acc, r0, n, scale, g, t);
    if (t == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
            if (r0 + g + 8 * h < n) lse_out[(size_t)bh * n + r0 + g + 8 * h] = lse2[h];
    }
    __syncthreads();  // K and V are no longer read
    // (P·g)ᵀ and dSᵀ over K and V, rounded to bf16 as the dQ product rounds
    // dS; queries past n count nothing.
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int key = 32 * hf + 8 * j + 2 * t + (e & 1), qr = r0 + g + 8 * (e >> 1);
                const bool in = qr < n;
                Ks[key * LDB + qr] = __float2bfloat16_rn(in ? s[hf][j][e] * gain[e >> 1] : 0.f);
                Vs[key * LDB + qr] = __float2bfloat16_rn(in ? dp[hf][j][e] : 0.f);
            }
    __syncthreads();
    // Keys on the rows: dV = (P·g)ᵀ·d_merged and dK = dSᵀ·Q.
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
        uint32_t f[4][4];
        frags_a(f, pass == 0 ? Ks : Vs, r0, g, t);
        zero8(acc);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) mma_k16(acc, f[kk], pass == 0 ? dOs : Qs, 16 * kk, lane);
        store_rows((pass == 0 ? dv : dk) + base, acc, r0, n, pass == 0 ? 1.f : scale, g, t);
    }
}

// ---------------------------------------------------------------------------
// n > 64: two launches on wgmma.

constexpr int L_CONSUMERS = 2;                      // warpgroups of 64 rows a block
constexpr int L_ROWS = 64 * L_CONSUMERS;            // a block's resident rows
constexpr int L_THREADS = 128 * (L_CONSUMERS + 1);  // and one producer warpgroup
constexpr int L_STAGES = 4;                         // the ring of streamed tiles
constexpr int TILE_BYTES = 64 * 128;                // 64 rows of 64 bf16, 128-byte swizzled
// Registers a thread after setmaxnreg (the launch gives 168 to every thread).
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

// The 16-byte chunk c of row r of such a tile (1024-byte aligned).
__device__ __forceinline__ const uint8_t* swizzled(const uint8_t* tile, int r, int c) {
    return tile + r * 128 + ((c ^ (r & 7)) << 4);
}

// Σ x·y over eight bf16 pairs.
__device__ __forceinline__ float dot8(uint4 x, uint4 y) {
    const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 a = unpack_bf16x2(xs[i]), b = unpack_bf16x2(ys[i]);
        s = fmaf(a.x, b.x, fmaf(a.y, b.y, s));
    }
    return s;
}

// c = A·Bᵀ, 64 x 64, 64 deep: A and B tiles of 64 rows, K-major, at shared
// addresses a and b. Issued, not waited for.
__device__ __forceinline__ void wgmma_scores(float (&c)[32], uint32_t a, uint32_t b) {
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
        wgmma_ss_n64<0>(c, desc_k_major(a + 32 * kc), desc_k_major(b + 32 * kc), kc != 0);
}

// The A fragments of P (this warpgroup's 64 rows x 64 in the accumulator
// layout), rounded to bf16: two adjacent runs of eight columns are the m16k16
// fragment of a 16-deep step.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4], const float (&p)[32]) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int r = 0; r < 4; ++r) a[c][r] = pack_bf16x2(p[8 * c + 2 * r], p[8 * c + 2 * r + 1]);
}

// acc += P·X: P as pack_a leaves it, X a tile of 64 rows (the sum's index)
// read MN-major through the transpose bit. Issued, not waited for.
__device__ __forceinline__ void wgmma_accumulate(float (&acc)[32], const uint32_t (&a)[4][4],
                                                 uint32_t x) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
        wgmma_rs_n64<1>(acc, a[c], desc_mn_major(x + 2048 * c, TILE_BYTES), 1);
}

// Rows of this warpgroup's 64 from rw (thread: rows 16·warp + g and + 8,
// columns 8j + 2t, + 1), times mul[h], to dst (bh, n, 64); rows at or past n
// are not written.
__device__ __forceinline__ void store_wg_rows(bf16* dst, const float (&acc)[32], int rw, int n,
                                              const float (&mul)[2], int tid) {
    const int lane = tid % 32, g = lane / 4, t = lane % 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = rw + (tid / 32) * 16 + g + 8 * h;
        if (r >= n) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j)
            *reinterpret_cast<uint32_t*>(dst + (size_t)r * 64 + 8 * j + 2 * t) =
                pack_bf16x2(acc[4 * j + 2 * h] * mul[h], acc[4 * j + 2 * h + 1] * mul[h]);
    }
}

// The two consumers issue their products in turns (named barriers 3 and 4,
// the first consumer first), so that one's softmax runs while the other's
// products are on the tensor cores; a lone consumer takes no turns. Made by
// every thread of a consumer warpgroup.
struct Turns {
    bool on;
    int wg;
    __device__ Turns(int active, int wg_) : on(active > 1), wg(wg_) {
        if (on && wg == 1) pass();
    }
    __device__ void take() const {
        if (on) named_barrier_sync(3 + wg, 256);
    }
    __device__ void pass() const {
        if (on) named_barrier_arrive(3 + (wg ^ 1), 256);
    }
};

// Launch 1: Q and d_merged resident, key tiles streamed in one pass: S and
// dP, then dQ += dS·K with P taken against each row's running maximum, as
// the forward's online softmax does, and the sum rescaled when it grows; the
// sum of P divides dQ at the end and gives the log-sum-exp.
constexpr size_t DQ_SMEM_BYTES = 1024 + (size_t)(3 * L_CONSUMERS + 2 * L_STAGES) * TILE_BYTES +
                                 L_ROWS * sizeof(float) + (1 + 2 * L_STAGES) * 8;

__global__ void __launch_bounds__(L_THREADS, 1)
    attention_bwd_dq_wgmma_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                                       const __grid_constant__ CUtensorMap map_k,
                                       const __grid_constant__ CUtensorMap map_v,
                                       const __grid_constant__ CUtensorMap map_o,
                                       const __grid_constant__ CUtensorMap map_do,
                                       MergedGated gr, bf16* __restrict__ dq,
                                       float* __restrict__ lse_out,
                                       float* __restrict__ delta_out, int n_valid, float scale) {
    extern __shared__ unsigned char smem_raw[];
    uint8_t* Qs = align_1024(smem_raw);  // one tile a consumer
    uint8_t* dOs = Qs + L_CONSUMERS * TILE_BYTES;
    uint8_t* Os = dOs + L_CONSUMERS * TILE_BYTES;
    uint8_t* Ks = Os + L_CONSUMERS * TILE_BYTES;  // L_STAGES tiles
    uint8_t* Vs = Ks + L_STAGES * TILE_BYTES;
    float* dls = reinterpret_cast<float*>(Vs + L_STAGES * TILE_BYTES);  // Δ of the block's rows
    uint64_t* q_bar = reinterpret_cast<uint64_t*>(dls + L_ROWS);
    uint64_t* full = q_bar + 1;
    uint64_t* empty = full + L_STAGES;
    // The row blocks of one (batch, head) are neighbours in the grid, so
    // that the tiles they all stream are read from device memory once and
    // from L2 after.
    const int n = gr.n, row_blocks = (n + L_ROWS - 1) / L_ROWS;
    const int bh = blockIdx.x / row_blocks, row0 = (blockIdx.x % row_blocks) * L_ROWS;
    const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
    const int active = min(L_CONSUMERS, (n - row0 + 63) / 64);  // consumers with rows below n
    const int nkt = (n_valid + 63) / 64;

    if (threadIdx.x == 0) {
        mbar_init(q_bar, 1);
        for (int s = 0; s < L_STAGES; ++s) {
            mbar_init(full + s, 1);
            mbar_init(empty + s, 4 * active);  // each consumer warp
        }
        mbar_fence_init();
    }
    __syncthreads();

    if (wg == L_CONSUMERS) {
        reg_dealloc<PRODUCER_REGS>();
        if (tid == 0) {
            const int b = bh / gr.heads, hc = (bh % gr.heads) * 64;
            mbar_arrive_expect_tx(q_bar, 3 * active * TILE_BYTES);
            for (int w = 0; w < active; ++w) {
                const int r = row0 + 64 * w;
                tma_load_3d(Qs + w * TILE_BYTES, &map_q, q_bar, 0, r, bh);
                tma_load_3d(dOs + w * TILE_BYTES, &map_do, q_bar, hc, r, b);
                tma_load_3d(Os + w * TILE_BYTES, &map_o, q_bar, hc, r, b);
            }
            for (int kt = 0; kt < nkt; ++kt) {
                const int s = kt % L_STAGES;
                mbar_wait(empty + s, ((kt / L_STAGES) & 1) ^ 1);
                mbar_arrive_expect_tx(full + s, 2 * TILE_BYTES);
                tma_load_3d(Ks + s * TILE_BYTES, &map_k, full + s, 0, kt * 64, bh);
                tma_load_3d(Vs + s * TILE_BYTES, &map_v, full + s, 0, kt * 64, bh);
            }
        }
    } else if (wg < active) {
        reg_alloc<CONSUMER_REGS>();
        const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
        const int rw = row0 + 64 * wg;  // the warpgroup's first row
        const float c2 = scale * LOG2E;
        mbar_wait(q_bar, 0);
        {
            // Δ of the warpgroup's rows from d_merged and merged: two threads
            // a row, four 16-byte chunks each.
            const int r = tid >> 1, half = tid & 1;
            float part = 0.f;
#pragma unroll
            for (int c = 4 * half; c < 4 * half + 4; ++c)
                part += dot8(*reinterpret_cast<const uint4*>(swizzled(dOs + wg * TILE_BYTES, r, c)),
                             *reinterpret_cast<const uint4*>(swizzled(Os + wg * TILE_BYTES, r, c)));
            part += __shfl_xor_sync(0xffffffffu, part, 1);
            if (half == 0) {
                dls[64 * wg + r] = part;
                if (rw + r < n) delta_out[(size_t)bh * n + rw + r] = part;
            }
        }
        named_barrier_sync(1 + wg, 128);
        float dlt[2], gain[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = warp * 16 + g + 8 * h;
            dlt[h] = dls[64 * wg + r];
            gain[h] = rw + r < n ? gr.gates[(size_t)bh * n + rw + r] : 0.f;
        }
        const uint32_t qa = smem_u32(Qs + wg * TILE_BYTES), oa = smem_u32(dOs + wg * TILE_BYTES);
        // The running maximum (base 2) and sum of each row, and dQ against
        // that maximum.
        float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
        float acc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = 0.f;
        float sc[32], dp[32];
        uint32_t a[4][4];  // dS of the tile before, the A operand of its dQ product
        float alpha[2];
        auto wait_stage = [&](int kt) { mbar_wait(full + kt % L_STAGES, (kt / L_STAGES) & 1); };
        auto issue_scores = [&](int kt) {  // S and dP of tile kt
            const int s = kt % L_STAGES;
            wgmma_fence();
            wgmma_scores(sc, qa, smem_u32(Ks + s * TILE_BYTES));
            wgmma_scores(dp, oa, smem_u32(Vs + s * TILE_BYTES));
            wgmma_commit();
        };
        auto issue_dq = [&](int kt) {  // dQ += dS·K of tile kt
            wgmma_fence();
            wgmma_accumulate(acc, a, smem_u32(Ks + (kt % L_STAGES) * TILE_BYTES));
            wgmma_commit();
        };
        // The online softmax of tile kt on its scores: the running maximum
        // and sum, dS unnormalised in place of dP, and in alpha the factor
        // that the dQ summed so far must be multiplied by. acc is not
        // touched: the tile before's product may still be adding to it.
        auto softmax = [&](int kt) {
            const int k0 = kt * 64;
            if (k0 + 64 > n_valid) {  // the last tile: keys past n_valid count nothing
#pragma unroll
                for (int j = 0; j < 8; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        if (k0 + 8 * j + 2 * t + (e & 1) >= n_valid) sc[4 * j + e] = -INFINITY;
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                float mx = -INFINITY;
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]));
                // Key k0 is valid, so every tile's maximum is finite; the
                // maximum is kept in base-2 units (c2 > 0).
                const float mn = fmaxf(m[h], quad_max(mx) * c2);
                alpha[h] = exp2_approx(m[h] - mn);
                float sum = 0.f;
#pragma unroll
                for (int j = 0; j < 8; ++j)
#pragma unroll
                    for (int e = 2 * h; e < 2 * h + 2; ++e) {
                        const int i = 4 * j + e;
                        const float pe = exp2_approx(fmaf(sc[i], c2, -mn));
                        sum += pe;
                        dp[i] = pe * fmaf(dp[i], gain[h], -dlt[h]);
                    }
                l[h] = l[h] * alpha[h] + quad_sum(sum);
                m[h] = mn;
            }
        };
        // Once the tile before's product is done: the sums rescaled and this
        // tile's dS packed.
        auto rescale_and_pack = [&]() {
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[4 * j + e] *= alpha[e >> 1];
            pack_a(a, dp);
        };
        // Tile kt's scores and tile kt - 1's dQ product are issued together,
        // in this consumer's turn, as the forward kernel issues a tile's
        // scores with the tile before's P·V.
        const Turns turns(active, wg);
        wait_stage(0);
        turns.take();
        issue_scores(0);
        turns.pass();
        wgmma_wait<0>();
        fence_registers(sc);
        fence_registers(dp);
        softmax(0);
        rescale_and_pack();
#pragma unroll 1
        for (int kt = 1; kt < nkt; ++kt) {
            wait_stage(kt);
            turns.take();
            issue_scores(kt);
            issue_dq(kt - 1);
            turns.pass();
            wgmma_wait<1>();  // this tile's scores
            fence_registers(sc);
            fence_registers(dp);
            softmax(kt);
            wgmma_wait<0>();  // the tile before's dQ product: its K stage is free
            fence_registers(acc);
            if (lane == 0) mbar_arrive(empty + (kt - 1) % L_STAGES);
            rescale_and_pack();
        }
        turns.take();
        issue_dq(nkt - 1);
        turns.pass();
        wgmma_wait<0>();
        fence_registers(acc);
        const float mul[2] = {scale / l[0], scale / l[1]};
        store_wg_rows(dq + (size_t)bh * n * 64, acc, rw, n, mul, tid);
        if (t == 0) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = rw + warp * 16 + g + 8 * h;
                if (r < n) lse_out[(size_t)bh * n + r] = m[h] + log2f(l[h]);
            }
        }
    }
}

// Launch 2: K and V resident, query tiles streamed with their log-sum-exp, Δ
// and gains: Sᵀ = K·Qᵀ, dPᵀ = V·d_mergedᵀ, then dV += (P·g)ᵀ·d_merged and
// dK += dSᵀ·Q. Key rows wholly past n_valid write zeros.
constexpr int VEC = 3 * 64;        // a query tile's log-sum-exp, Δ and gains
constexpr int VEC_LOADERS = 96;    // the producer's warps 1-3 load them
constexpr size_t DKV_SMEM_BYTES = 1024 + (size_t)(2 * L_CONSUMERS + 2 * L_STAGES) * TILE_BYTES +
                                  (size_t)L_STAGES * VEC * sizeof(float) + (1 + 2 * L_STAGES) * 8;

__global__ void __launch_bounds__(L_THREADS, 1)
    attention_bwd_dkv_wgmma_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                                        const __grid_constant__ CUtensorMap map_k,
                                        const __grid_constant__ CUtensorMap map_v,
                                        const __grid_constant__ CUtensorMap map_do,
                                        MergedGated gr, const float* __restrict__ lse_g,
                                        const float* __restrict__ delta_g, bf16* __restrict__ dk,
                                        bf16* __restrict__ dv, int n_valid, float scale) {
    extern __shared__ unsigned char smem_raw[];
    uint8_t* Ks = align_1024(smem_raw);  // one tile a consumer
    uint8_t* Vs = Ks + L_CONSUMERS * TILE_BYTES;
    uint8_t* Qs = Vs + L_CONSUMERS * TILE_BYTES;  // L_STAGES tiles
    uint8_t* dOs = Qs + L_STAGES * TILE_BYTES;
    float* vecs = reinterpret_cast<float*>(dOs + L_STAGES * TILE_BYTES);  // L_STAGES x VEC
    uint64_t* kv_bar = reinterpret_cast<uint64_t*>(vecs + L_STAGES * VEC);
    uint64_t* full = kv_bar + 1;
    uint64_t* empty = full + L_STAGES;
    // The row blocks of one (batch, head) are neighbours in the grid, so
    // that the tiles they all stream are read from device memory once and
    // from L2 after.
    const int n = gr.n, row_blocks = (n + L_ROWS - 1) / L_ROWS;
    const int bh = blockIdx.x / row_blocks, row0 = (blockIdx.x % row_blocks) * L_ROWS;
    const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
    const int with_rows = min(L_CONSUMERS, (n - row0 + 63) / 64);
    // Consumers with a key below n_valid; the others' rows only get zeros.
    const int active = max(0, min(with_rows, (n_valid - row0 + 63) / 64));
    const int nqs = (n + 63) / 64;

    if (active > 0) {
        if (threadIdx.x == 0) {
            mbar_init(kv_bar, 1);
            for (int s = 0; s < L_STAGES; ++s) {
                mbar_init(full + s, 1 + VEC_LOADERS);
                mbar_init(empty + s, 4 * active);
            }
            mbar_fence_init();
        }
        __syncthreads();
    }

    if (wg == L_CONSUMERS) {
        reg_dealloc<PRODUCER_REGS>();
        if (active == 0) return;
        if (tid == 0) {
            const int b = bh / gr.heads, hc = (bh % gr.heads) * 64;
            mbar_arrive_expect_tx(kv_bar, 2 * active * TILE_BYTES);
            for (int w = 0; w < active; ++w) {
                tma_load_3d(Ks + w * TILE_BYTES, &map_k, kv_bar, 0, row0 + 64 * w, bh);
                tma_load_3d(Vs + w * TILE_BYTES, &map_v, kv_bar, 0, row0 + 64 * w, bh);
            }
            for (int qt = 0; qt < nqs; ++qt) {
                const int s = qt % L_STAGES;
                mbar_wait(empty + s, ((qt / L_STAGES) & 1) ^ 1);
                mbar_arrive_expect_tx(full + s, 2 * TILE_BYTES);
                tma_load_3d(Qs + s * TILE_BYTES, &map_q, full + s, 0, qt * 64, bh);
                tma_load_3d(dOs + s * TILE_BYTES, &map_do, full + s, hc, qt * 64, b);
            }
        } else if (tid >= 32) {
            for (int qt = 0; qt < nqs; ++qt) {
                const int s = qt % L_STAGES;
                mbar_wait(empty + s, ((qt / L_STAGES) & 1) ^ 1);
                float* vec = vecs + s * VEC;
                for (int i = tid - 32; i < VEC; i += VEC_LOADERS) {
                    const int which = i / 64, r = qt * 64 + i % 64;
                    const float* src = which == 0 ? lse_g : which == 1 ? delta_g : gr.gates;
                    // Queries past n: P = 0 through a log-sum-exp of +inf.
                    vec[i] = r < n ? src[(size_t)bh * n + r] : which == 0 ? INFINITY : 0.f;
                }
                mbar_arrive(full + s);
            }
        }
    } else if (wg < active) {
        reg_alloc<CONSUMER_REGS>();
        const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
        const int rw = row0 + 64 * wg;  // the warpgroup's first key
        const float c2 = scale * LOG2E;
        const bool key_in[2] = {rw + warp * 16 + g < n_valid, rw + warp * 16 + g + 8 < n_valid};
        const uint32_t ka = smem_u32(Ks + wg * TILE_BYTES), va = smem_u32(Vs + wg * TILE_BYTES);
        float acc_k[32], acc_v[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) acc_k[i] = acc_v[i] = 0.f;
        const bool ragged = rw + 64 > n_valid;  // keys past n_valid count nothing
        float sT[32], dpT[32];
        uint32_t ap[4][4], ad[4][4];  // (P·g)ᵀ and dSᵀ of the tile before, as A operands
        auto wait_stage = [&](int qt) { mbar_wait(full + qt % L_STAGES, (qt / L_STAGES) & 1); };
        auto issue_scores = [&](int qt) {  // Sᵀ and dPᵀ of query tile qt
            const int s = qt % L_STAGES;
            wgmma_fence();
            wgmma_scores(sT, ka, smem_u32(Qs + s * TILE_BYTES));
            wgmma_scores(dpT, va, smem_u32(dOs + s * TILE_BYTES));
            wgmma_commit();
        };
        auto issue_dkv = [&](int qt) {  // dV += (P·g)ᵀ·d_merged, dK += dSᵀ·Q of tile qt
            const int s = qt % L_STAGES;
            wgmma_fence();
            wgmma_accumulate(acc_v, ap, smem_u32(dOs + s * TILE_BYTES));
            wgmma_accumulate(acc_k, ad, smem_u32(Qs + s * TILE_BYTES));
            wgmma_commit();
        };
        // (P·g)ᵀ and dSᵀ of tile qt in place of Sᵀ and dPᵀ; queries past n
        // count nothing (the producer gives them a log-sum-exp of +inf).
        auto elementwise = [&](int qt) {
            const float* vec = vecs + (qt % L_STAGES) * VEC;
            if (ragged) {
#pragma unroll
                for (int j = 0; j < 8; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        if (!key_in[e >> 1]) sT[4 * j + e] = -INFINITY;
            }
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int col = 8 * j + 2 * t;
                const float2 lse2 = *reinterpret_cast<const float2*>(vec + col);
                const float2 dl2 = *reinterpret_cast<const float2*>(vec + 64 + col);
                const float2 g2 = *reinterpret_cast<const float2*>(vec + 128 + col);
                const float lse[2] = {lse2.x, lse2.y}, dl[2] = {dl2.x, dl2.y}, gc[2] = {g2.x, g2.y};
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int i = 4 * j + e, c = e & 1;
                    const float pe = exp2_approx(fmaf(sT[i], c2, -lse[c]));
                    dpT[i] = pe * fmaf(dpT[i], gc[c], -dl[c]);
                    sT[i] = pe * gc[c];
                }
            }
        };
        // Tile qt's scores and tile qt - 1's products are issued together,
        // in this consumer's turn, as in launch 1.
        const Turns turns(active, wg);
        mbar_wait(kv_bar, 0);
        wait_stage(0);
        turns.take();
        issue_scores(0);
        turns.pass();
        wgmma_wait<0>();
        fence_registers(sT);
        fence_registers(dpT);
        elementwise(0);
        pack_a(ap, sT);
        pack_a(ad, dpT);
#pragma unroll 1
        for (int qt = 1; qt < nqs; ++qt) {
            wait_stage(qt);
            turns.take();
            issue_scores(qt);
            issue_dkv(qt - 1);
            turns.pass();
            wgmma_wait<1>();  // this tile's scores
            fence_registers(sT);
            fence_registers(dpT);
            elementwise(qt);
            wgmma_wait<0>();  // the tile before's products: its stage is free
            fence_registers(acc_v);
            fence_registers(acc_k);
            if (lane == 0) mbar_arrive(empty + (qt - 1) % L_STAGES);
            pack_a(ap, sT);
            pack_a(ad, dpT);
        }
        turns.take();
        issue_dkv(nqs - 1);
        turns.pass();
        wgmma_wait<0>();
        fence_registers(acc_v);
        fence_registers(acc_k);
        const float one[2] = {1.f, 1.f}, sc2[2] = {scale, scale};
        store_wg_rows(dk + (size_t)bh * n * 64, acc_k, rw, n, sc2, tid);
        store_wg_rows(dv + (size_t)bh * n * 64, acc_v, rw, n, one, tid);
    } else if (wg < with_rows) {
        // Keys wholly past n_valid: no gradient.
        const int rw = row0 + 64 * wg;
        for (int i = tid; i < 64 * 8; i += 128) {
            const int r = rw + i / 8, c = (i % 8) * 8;
            if (r >= n) continue;
            *reinterpret_cast<uint4*>(dk + ((size_t)bh * n + r) * 64 + c) = make_uint4(0, 0, 0, 0);
            *reinterpret_cast<uint4*>(dv + ((size_t)bh * n + r) * 64 + c) = make_uint4(0, 0, 0, 0);
        }
    }
}

inline cudaError_t run(const bf16* q, const bf16* k, const bf16* v, const MergedGated& gr,
                       bf16* dq, bf16* dk, bf16* dv, float* lse, float* delta, int bh, int n,
                       int n_valid, float scale, cudaStream_t stream) {
    if (n <= ROWS)
        return launch_bwd(attention_bwd_short_bf16_kernel, dim3(bh), THREADS, SHORT_SMEM_BYTES,
                          stream, q, k, v, gr, dq, dk, dv, lse, delta, n_valid, scale);
    CUtensorMap map_q, map_k, map_v, map_o, map_do;
    const uint64_t batch = bh / gr.heads;
    cudaError_t err = encode_heads_map(&map_q, q, bh, n, 64, 64);
    if (err == cudaSuccess) err = encode_heads_map(&map_k, k, bh, n, 64, 64);
    if (err == cudaSuccess) err = encode_heads_map(&map_v, v, bh, n, 64, 64);
    if (err == cudaSuccess) err = encode_merged_map(&map_o, gr.o, batch, n, gr.heads, 64);
    if (err == cudaSuccess) err = encode_merged_map(&map_do, gr.dout, batch, n, gr.heads, 64);
    if (err != cudaSuccess) return err;
    const dim3 grid(bh * ((n + L_ROWS - 1) / L_ROWS));
    err = launch_bwd(attention_bwd_dq_wgmma_bf16_kernel, grid, L_THREADS, DQ_SMEM_BYTES, stream,
                     map_q, map_k, map_v, map_o, map_do, gr, dq, lse, delta, n_valid, scale);
    if (err != cudaSuccess) return err;
    return launch_bwd(attention_bwd_dkv_wgmma_bf16_kernel, grid, L_THREADS, DKV_SMEM_BYTES,
                      stream, map_q, map_k, map_v, map_do, gr, static_cast<const float*>(lse),
                      static_cast<const float*>(delta), dk, dv, n_valid, scale);
}

}  // namespace bwd_bf16
}  // namespace asep
