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
//   1. RMSNorm and gates (tiles.cuh, rmsnorm_gates_kernel): xn = rmsnorm(x)·γ
//      rounded to the input type (as the TPU kernel rounds it), and the
//      float32 gates sigmoid(xn·gate_w + gate_b) from the rounded xn, as
//      (B, heads, n_pad). The 8 gate columns are dot products a row pass does
//      for nearly nothing; in the QKV product they took a column tile of 256
//      (128 in float32) of their own.
//   2. The QKV GEMM of xn against Wqkv (tiles.cuh: wgmma fed by TMA in bf16,
//      3xTF32 wgmma in float32). Its epilogue rounds qkv to the input type (as
//      the TPU kernel does), applies the interleaved-pair RoPE, rounds again,
//      and writes q, k, v as (B, heads, n_pad, 64):
//        - bf16: a tile epilogue on the accumulator registers. A 64-row tile
//          lies in one sequence (n_pad % 64 == 0) and its 256 columns are four
//          whole 64-column head boxes, so the batch, position, q/k/v and head
//          are worked out once a box; a RoPE pair (2i, 2i+1) is a pair of
//          adjacent registers of one thread, so the rotation needs no lane
//          exchange, and its cos/sin values (one bf16 pair each per row and
//          pair) are fetched once a tile, before the last products end. Each
//          box goes out through shared memory (stmatrix into a 128-byte-
//          swizzled 64x64 tile) as one TMA store;
//        - float32: a run epilogue (eight consecutive columns of a row).
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

// float32: a run of eight columns lies in one head's 64 lanes of q, k or v
// (3·hd and hd are multiples of 64), and RoPE pairs (c, c^1) lie inside it.
template <typename T> struct QkvEpi {
    T* q;
    T* k;
    T* v;
    const T* cos_t;  // (n_pad, 64) or nullptr: no RoPE
    const T* sin_t;
    int n_pad, heads;

    struct Pre {};  // the RoPE tables are cache hits, read where they are used
    static constexpr int PREFETCH = 8;
    __device__ Pre prefetch(int, int) const { return {}; }

    __device__ void operator()(const float* row, int c0, int, int grow, int gcol0,
                               const Pre&) const {
        const int hd = heads * 64;
        const int b = grow / n_pad, n = grow % n_pad;
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
    }
};

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// bf16: the tile epilogue of the QKV product (see the design above). Thread
// t of the warpgroup holds, for run j (eight columns) of the 256-wide tile and
// row half h, the columns 8j + 2·(t % 4), +1 of row wrow + 8h: a RoPE pair.
struct QkvTileEpi {
    CUtensorMap map_q, map_k, map_v;  // (64, n_pad, B·heads), boxes of 64 x 64 x 1
    const bf16* cos_t;                 // (n_pad, 64) or nullptr: no RoPE
    const bf16* sin_t;
    int n_pad, heads;

    static constexpr int STAGING_BYTES = 64 * 64 * 2;  // one head box a warpgroup
    // cos and sin of this thread's pairs (j) in its two rows (h), bf16x2
    struct Tile {
        uint32_t cs[2][8], sn[2][8];
    };

    __device__ __forceinline__ Tile tile_prefetch(int row0, int wrow, int quad) const {
        Tile t{};
        if (cos_t != nullptr) {
            const int n = row0 % n_pad + wrow;
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    const size_t o = (size_t)(n + 8 * h) * 64 + 8 * j + 2 * quad;
                    t.cs[h][j] = __ldg(reinterpret_cast<const unsigned*>(cos_t + o));
                    t.sn[h][j] = __ldg(reinterpret_cast<const unsigned*>(sin_t + o));
                }
        }
        return t;
    }

    __device__ __forceinline__ void tile(const float (&acc)[G_BN / 2], const Tile& pre, const TileCtx& c) const {
        const int hd = heads * 64, b = c.row0 / n_pad, n0 = c.row0 % n_pad;
        const uint32_t base = smem_u32(c.staging);
        const int l8 = c.lane % 8, m = c.lane / 8;
#pragma unroll
        for (int box = 0; box < G_BN / 64; ++box) {
            if (64 * box >= c.valid) break;
            const int col = c.gcol0 + 64 * box, which = col / hd, head = (col % hd) / 64;
            const bool rot = which < 2 && cos_t != nullptr;
            uint32_t pk[8][2];
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    float x0 = acc[4 * (8 * box + j) + 2 * h], x1 = acc[4 * (8 * box + j) + 2 * h + 1];
                    if (rot) {
                        // qkv rounded, rotated (out[2i] = x[2i]·cos - x[2i+1]·sin,
                        // out[2i+1] = x[2i+1]·cos + x[2i]·sin), rounded again below.
                        x0 = rnd<bf16>(x0);
                        x1 = rnd<bf16>(x1);
                        const float2 cs = unpack_bf16(pre.cs[h][j]), sn = unpack_bf16(pre.sn[h][j]);
                        const float y0 = x0 * cs.x - x1 * sn.x;
                        x1 = x1 * cs.y + x0 * sn.y;
                        x0 = y0;
                    }
                    pk[j][h] = pack_bf16(x0, x1);
                }
            if (c.elected) bulk_wait_read<0>();  // the previous box has left the staging tile
            named_barrier_sync(1 + c.wg, 128);
            // Matrix m of call i is run 2i + m / 2, row half m % 2; lane l gives
            // row l % 8 of matrix l / 8, at its 128-byte-swizzled place.
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int row = c.warp * 16 + 8 * (m & 1) + l8;
                stmatrix_x4(base + row * 128 + (((2 * i + m / 2) ^ l8) << 4), pk[2 * i][0],
                            pk[2 * i][1], pk[2 * i + 1][0], pk[2 * i + 1][1]);
            }
            fence_proxy_async();  // the tile, before the TMA store reads it
            named_barrier_sync(1 + c.wg, 128);
            if (c.elected) {
                tma_store_3d(which == 0 ? &map_q : which == 1 ? &map_k : &map_v, c.staging, 0, n0,
                             b * heads + head);
                bulk_commit();
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
    cudaError_t err = run_rmsnorm_gates(x, norm, gate_w, gate_b, xn, gates, rows, d_model, heads,
                                        n_pad, stream);
    if (err != cudaSuccess) return err;

    if constexpr (sizeof(T) == 2) {
        QkvTileEpi qkv_epi{};
        qkv_epi.cos_t = cos_t;
        qkv_epi.sin_t = sin_t;
        qkv_epi.n_pad = n_pad;
        qkv_epi.heads = heads;
        T* dst[3] = {q, k, v};
        CUtensorMap* maps[3] = {&qkv_epi.map_q, &qkv_epi.map_k, &qkv_epi.map_v};
        for (int i = 0; i < 3; ++i) {
            err = encode_heads_map(maps[i], dst[i], (uint64_t)batch * heads, n_pad, 64, 64);
            if (err != cudaSuccess) return err;
        }
        err = run_gemm(static_cast<const T*>(xn), wqkv, 3 * hd, rows, d_model, qkv_epi, stream);
    } else {
        const QkvEpi<T> qkv_epi{q, k, v, cos_t, sin_t, n_pad, heads};
        err = run_gemm(static_cast<const T*>(xn), wqkv, 3 * hd, rows, d_model, qkv_epi, stream);
    }
    if (err != cudaSuccess) return err;

    const MergedGatedOut<T> attn_out{gates, merged, n_pad, heads};
    err = run_flash(static_cast<const T*>(q), static_cast<const T*>(k),
                    static_cast<const T*>(v), attn_out, batch * heads, n_pad, n_valid, 64,
                    0.125f /* 64^-0.5 */, stream);
    if (err != cudaSuccess) return err;

    const ResidualEpi<T> out_epi{x, nullptr, out, d_model};
    return run_gemm(static_cast<const T*>(merged), wo, d_model, rows, hd, out_epi, stream);
}

}  // namespace asep

// dtype: 0 = float32, 1 = bfloat16. gate_w is (d_model, heads). wqkv and wo
// are the (K, N) weights in bf16 and their prepared 3xTF32 forms (2, N, K) in
// float32 (ops/tf32.py). xn, q, k, v, gates (fp32) and merged are scratch the
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
