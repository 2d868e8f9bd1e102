// Shared building blocks of the fused RoFormer block kernels and of the
// whole-sequence attention (sm_90a).
//
//   * rmsnorm_kernel — xn = x · rsqrt(max(Σx², 1e-24)) · √d · γ, rounded to
//                      the storage type (the TPU kernels' xn), one warp a row;
//     rmsnorm_gates_kernel — the same xn and the attention block's gates
//                      sigmoid(xn·gate_w + gate_b), gate_w in shared memory;
//   * gemm (run_gemm) — C = A·B with a caller-supplied epilogue on the
//                      float32 accumulators, both types on the tensor cores in
//                      one pipeline shape (persistent, warp-specialised,
//                      clusters of two blocks with multicast weights, TMA rings
//                      on mbarriers, two consumer warpgroups taking turns):
//       - bf16: gemm_wgmma_kernel, m64n256k16, the weight read as it lies
//               through wgmma's transpose bit; run epilogues (eight
//               consecutive columns of a row) or a tile epilogue (the
//               accumulator registers as wgmma leaves them);
//       - float32: gemm_tf32x3_kernel (gemm_tf32.cuh), three TF32 products
//               a term (heads and tails of both operands), m64n128k8, the
//               weight in a prepared transposed form;
//   * attention (run_flash) — softmax(q·kᵀ·scale, masked)·v over (batch·head,
//                      rows, 64 or 128) operands with an online softmax over
//                      key tiles; where the result goes, and what it is
//                      multiplied by on the way, is the caller's Out policy:
//       - bf16: flash_wgmma_kernel, both products on wgmma, K and V tiles by
//               TMA, scores, weights and output in registers;
//       - float32, more than 64 rows at 64 wide: flash_tf32x3_kernel, both
//               products on wgmma as 3xTF32, K and V by TMA, split into
//               heads and tails by the producer warpgroup;
//       - float32 otherwise: flash_fma_kernel, register-blocked FMA with the
//               output, the running maximum and the running sum in registers.
//     run_flash serves B1's attention launch (the TPU kernel _layer_kernel,
//     audio_separator_tpu/ops/attention_block.py:35) and B3
//     (_fused_attention_kernel, audio_separator_tpu/ops/attention.py:39); the
//     caller names the kernel (ops/attention.flash_route).
// The Hopper-only PTX (mbarrier, TMA, wgmma, stmatrix, setmaxnreg) is in
// hopper.cuh.
//
// The launch entry points (attention_block.cu, ff_block.cu, attention.cu)
// expose a plain C interface so the library builds without PyTorch's headers and loads with
// ctypes; they return cudaGetLastError() after each launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace asep {

constexpr int THREADS = 256;

using bf16 = __nv_bfloat16;

template <typename T> struct Op;

template <> struct Op<float> {
    __device__ static float to_float(float v) { return v; }
    __device__ static float from_float(float v) { return v; }
};

template <> struct Op<bf16> {
    __device__ static float to_float(bf16 v) { return __bfloat162float(v); }
    __device__ static bf16 from_float(float v) { return __float2bfloat16(v); }
};

template <typename T> __device__ __forceinline__ float to_f(T v) { return Op<T>::to_float(v); }

// Round to the storage type and back: the TPU kernels' .astype(x.dtype) points.
template <typename T> __device__ __forceinline__ float rnd(float v) {
    return Op<T>::to_float(Op<T>::from_float(v));
}

__device__ __forceinline__ void load4(const float* p, float v[4]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

__device__ __forceinline__ void load4(const bf16* p, float v[4]) {
    const uint2 a = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a.y));
    v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}

// Eight consecutive stored elements as they are loaded (one 16-byte access for
// bf16, two for float32; callers keep p 16-byte aligned), through the
// read-only path: for operands that no launch of the kernel writes, so the
// compiler may move the load above earlier stores.
template <typename T> struct Vec8;
template <> struct Vec8<float> { float4 lo, hi; };
template <> struct Vec8<bf16> { uint4 v; };

__device__ __forceinline__ Vec8<float> load_vec8(const float* p) {
    return {__ldg(reinterpret_cast<const float4*>(p)), __ldg(reinterpret_cast<const float4*>(p) + 1)};
}
__device__ __forceinline__ Vec8<bf16> load_vec8(const bf16* p) {
    return {__ldg(reinterpret_cast<const uint4*>(p))};
}
__device__ __forceinline__ void unpack(const Vec8<float>& a, float v[8]) {
    v[0] = a.lo.x; v[1] = a.lo.y; v[2] = a.lo.z; v[3] = a.lo.w;
    v[4] = a.hi.x; v[5] = a.hi.y; v[6] = a.hi.z; v[7] = a.hi.w;
}
__device__ __forceinline__ void unpack(const Vec8<bf16>& a, float v[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a.v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
    }
}
template <typename T> __device__ __forceinline__ void load8_ro(const T* p, float v[8]) {
    unpack(load_vec8(p), v);
}

__device__ __forceinline__ void store8(float* p, const float v[8]) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(bf16* p, const float v[8]) {
    uint4 a;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&a);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = a;
}

// ---------------------------------------------------------------------------
// RMSNorm: one warp per row of d (d % 128 == 0 not needed; d % 4 == 0 is).

template <typename T>
__global__ void __launch_bounds__(THREADS)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ gamma, T* __restrict__ xn,
               int rows, int d) {
    const int row = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (row >= rows) return;
    const T* xr = x + (size_t)row * d;
    float ssq = 0.f;
    for (int c = lane * 4; c < d; c += 128) {
        float v[4];
        load4(xr + c, v);
        ssq += v[0] * v[0] + v[1] * v[1] + v[2] * v[2] + v[3] * v[3];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ssq += __shfl_xor_sync(0xffffffffu, ssq, o);
    const float inv = rsqrtf(fmaxf(ssq, 1e-24f)) * sqrtf((float)d);
    T* out = xn + (size_t)row * d;
    for (int c = lane * 4; c < d; c += 128) {
        float v[4];
        load4(xr + c, v);
#pragma unroll
        for (int i = 0; i < 4; ++i) out[c + i] = Op<T>::from_float(v[i] * inv * to_f(gamma[c + i]));
    }
}

// ---------------------------------------------------------------------------
// RMSNorm with the attention block's gates: xn as rmsnorm_kernel writes it,
// and gates = sigmoid(xn·gate_w + gate_b) in float32 from the rounded xn (where
// the TPU kernel takes them), written (B, heads, n_pad). One warp a row, as in
// rmsnorm_kernel: the launch is bound by its bytes, and it takes many warps
// in flight to keep them moving (a warp with more rows, or with the row kept
// in registers between the two passes, holds more registers, and fewer warps
// fit: both were slower). gate_w sits in shared memory once per block,
// transposed, as [H][d] of the storage type with H the head count rounded up
// to a power of two (zero rows past it): lane l reads columns 4l..4l+3 of a
// head as one load, so a warp's loads fall on distinct banks. The blocks are
// persistent, as many as fit, so gate_w is read from device memory once per
// block and not once per row. Each lane sums its columns' share of the H dot
// products, and one transposing reduction leaves every lane with a whole sum.

// v holds V (a power of two) partial sums on each lane of the warp;
// afterwards v[j], j < max(V / 32, 1), holds the warp's total of element
// lane·V/32 + j (lane·V/32 rounded down: 32/V lanes hold each element when V
// < 32). Each step keeps half of the values and adds the other half from the
// lane `m` away; once one value is left, the steps add it across the lanes.
template <int V> __device__ __forceinline__ void warp_transpose_sum(float (&v)[V], int lane) {
#pragma unroll
    for (int step = 0; step < 5; ++step) {
        const int m = 16 >> step, half = (V >> step) / 2;
        if (half == 0) {
            v[0] += __shfl_xor_sync(0xffffffffu, v[0], m);
            continue;
        }
        const bool upper = lane & m;
#pragma unroll
        for (int i = 0; i < half; ++i) {
            const float send = upper ? v[i] : v[i + half];
            const float keep = upper ? v[i + half] : v[i];
            v[i] = keep + __shfl_xor_sync(0xffffffffu, send, m);
        }
    }
}

template <typename T> __device__ __forceinline__ void store4(T* p, const float v[4]);
template <> __device__ __forceinline__ void store4(float* p, const float v[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <> __device__ __forceinline__ void store4(bf16* p, const float v[4]) {
    uint2 a;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&a);
    h[0] = __floats2bfloat162_rn(v[0], v[1]);
    h[1] = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) = a;
}

template <typename T, int H>
__global__ void __launch_bounds__(THREADS)
rmsnorm_gates_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                     const T* __restrict__ gate_w, const T* __restrict__ gate_b,
                     T* __restrict__ xn, float* __restrict__ gates, int rows, int d, int heads,
                     int n_pad) {
    extern __shared__ __align__(16) unsigned char gw_raw[];
    T* gw = reinterpret_cast<T*>(gw_raw);  // [H][d]
    // gate_w read as it lies, (d, heads), in whole lines; zero rows past heads.
#pragma unroll 4
    for (int i = threadIdx.x; i < d * heads; i += THREADS)
        gw[(i % heads) * d + i / heads] = gate_w[i];
    for (int i = d * heads + threadIdx.x; i < d * H; i += THREADS) gw[i] = Op<T>::from_float(0.f);
    __syncthreads();
    const int lane = threadIdx.x % 32;
    const int warps = gridDim.x * (THREADS / 32);
    for (int row = blockIdx.x * (THREADS / 32) + threadIdx.x / 32; row < rows; row += warps) {
        const T* xr = x + (size_t)row * d;
        float ssq = 0.f;
        for (int c = lane * 4; c < d; c += 128) {
            float v[4];
            load4(xr + c, v);
            ssq += v[0] * v[0] + v[1] * v[1] + v[2] * v[2] + v[3] * v[3];
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) ssq += __shfl_xor_sync(0xffffffffu, ssq, o);
        const float inv = rsqrtf(fmaxf(ssq, 1e-24f)) * sqrtf((float)d);
        float acc[H];
#pragma unroll
        for (int h = 0; h < H; ++h) acc[h] = 0.f;
        for (int c = lane * 4; c < d; c += 128) {
            float v[4], g[4], y[4];
            load4(xr + c, v);
            load4(gamma + c, g);
#pragma unroll
            for (int i = 0; i < 4; ++i) y[i] = rnd<T>(v[i] * inv * g[i]);
            store4(xn + (size_t)row * d + c, y);
#pragma unroll
            for (int h = 0; h < H; ++h) {
                float w[4];
                load4(gw + h * d + c, w);
                acc[h] = fmaf(y[3], w[3], fmaf(y[2], w[2], fmaf(y[1], w[1], fmaf(y[0], w[0], acc[h]))));
            }
        }
        warp_transpose_sum(acc, lane);
#pragma unroll
        for (int j = 0; j < (H >= 32 ? H / 32 : 1); ++j) {
            const int h = lane * H / 32 + j;
            if (lane % (H >= 32 ? 1 : 32 / H) == 0 && h < heads) {
                const float s = acc[j] + to_f(gate_b[h]);
                gates[((size_t)(row / n_pad) * heads + h) * n_pad + row % n_pad] =
                    1.f / (1.f + expf(-s));
            }
        }
    }
}

// ---------------------------------------------------------------------------
// GEMMs. Both compute the output tiles of A·B: A is (M, K) row-major, B has N
// columns (bf16: (K, N) row-major as the weight lies; float32: the prepared
// form (2, N, K), the TF32 heads and tails of Bᵀ, see gemm_tf32.cuh). Rows past
// M and columns past N arrive as zeros (TMA) and are never handed on. Two
// kinds of epilogue functor:
//   * a run epilogue is called once per run of eight output columns with
//     their float32 values in a register array: epi(row, c0, count, grow,
//     gcol0, pre) covers row[c0 .. c0 + count), count <= 8, which is global
//     row grow, columns gcol0 ...; c0 is a multiple of 8; pre is
//     epi.prefetch(grow, gcol0), an Epi::Pre: what the functor reads from
//     device memory for that run, asked for Epi::PREFETCH runs ahead;
//   * a tile epilogue (bf16 only; it has a type Epi::Tile) takes a consumer
//     warpgroup's whole 64-row accumulator tile as it lies in the registers,
//     with Epi::STAGING_BYTES of shared memory of its own (see TileCtx).

template <class E, class = void> struct IsTileEpilogue : std::false_type {};
template <class E> struct IsTileEpilogue<E, std::void_t<typename E::Tile>> : std::true_type {};

// Shared memory of a consumer warpgroup's own for its tile epilogue (a
// variable: nvcc does not let device code call a constexpr host function).
template <class Epi, bool = IsTileEpilogue<Epi>::value> struct Staging {
    static constexpr int bytes = 0;
};
template <class Epi> struct Staging<Epi, true> {
    static constexpr int bytes = Epi::STAGING_BYTES;
};
template <class Epi> constexpr int STAGING_BYTES = Staging<Epi>::bytes;

// What a tile epilogue is told about its tile and its warpgroup.
struct TileCtx {
    int row0, gcol0, valid;  // the tile's first row and column; columns of it inside N
    int wrow, quad, lane, warp, wg;  // this thread's row in the tile, lane % 4, ...
    bool elected;                    // one thread of the warpgroup
    unsigned char* staging;          // this warpgroup's STAGING_BYTES, 1024-byte aligned
};

// bf16: a persistent, warp-specialised wgmma + TMA pipeline. Blocks of three
// warpgroups run in clusters of two. A work item is 128 rows x 256 columns of
// the output (cluster index, + cluster count, ...; the column tiles of one row
// group are neighbours, so A stays in L2); block r of the cluster owns rows
// 64·r .. +63 of it, and inside a block the items alternate between the two
// consumer warpgroups, so that one's epilogue overlaps the other's products:
//   * one thread of the producer warpgroup keeps a ring of G_STAGES stages
//     filled by TMA, item after item: its own 64 A rows as one 64x64 K-major
//     box, and B rows k0.. as four 64x64 MN-major boxes (B is (K, N) row-major
//     and is read through wgmma's transpose bit, so no transposed copy of a
//     weight is ever made). The two blocks need the same B boxes: each loads
//     two of the four and multicasts them into both blocks' rings. Rows past
//     M and columns past N arrive as zeros;
//   * a consumer warpgroup runs its item's stages: m64n256k16 from shared
//     memory into 128 float32 accumulators a thread, one wgmma group a stage,
//     the previous stage released while it runs;
//   * a run epilogue works on the accumulator registers: the four lanes that
//     share a row swap column pairs by shuffles so that each holds eight
//     consecutive columns, and the functor sees those eight as a register
//     array. What the functor reads from device memory for a run (Epi::Pre,
//     loaded by Epi::prefetch) is fetched Epi::PREFETCH runs ahead, the first
//     batch before the last products are waited for. A tile epilogue gets
//     the registers as they are (Epi::tile_prefetch before the wait).
// full[s] counts the TMA bytes of stage s, from both blocks' loads; empty[s]
// takes one arrival from the stage's consumer warpgroup in each block, since
// a multicast load writes into both rings; turn[w] tells warpgroup w that the
// other one has finished the products of the item before.
constexpr int G_WM = 64, G_BN = 256, G_BK = 64, G_STAGES = 5;
constexpr int G_THREADS = 384;
constexpr int G_A_BYTES = G_WM * G_BK * 2;
constexpr int G_PANEL_BYTES = G_BK * 64 * 2;  // 64 k-rows of 64 columns
constexpr int G_STAGE_BYTES = G_A_BYTES + (G_BN / 64) * G_PANEL_BYTES;
template <class Epi> constexpr size_t GEMM_WGMMA_SMEM_BYTES =
    G_STAGES * G_STAGE_BYTES + 2 * STAGING_BYTES<Epi> + 1024 + (2 * G_STAGES + 2) * 8;

// Tiles are 1024-byte aligned for the swizzle; dynamic shared memory is not.
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
    return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

template <bool B> struct Flag { static constexpr bool value = B; };

__device__ __forceinline__ float2 shfl_xor2(float2 v, int mask) {
    return make_float2(__shfl_xor_sync(0xffffffffu, v.x, mask),
                       __shfl_xor_sync(0xffffffffu, v.y, mask));
}

// The four lanes of a quad (lane % 4 = quad) each hold columns 2·quad, +1 of
// four runs of eight columns (x[c], c = 0..3) of one row; afterwards lane
// `quad` holds all eight columns of run `quad` in y.
__device__ __forceinline__ void quad_transpose(const float2 (&x)[4], int quad, float (&y)[8]) {
    const bool odd = quad & 1, hi = quad & 2;
    float2 t[2][2];  // [run pair][lane of the own pair]: run 2b + odd
#pragma unroll
    for (int b = 0; b < 2; ++b) {
        const float2 keep = odd ? x[2 * b + 1] : x[2 * b];
        const float2 recv = shfl_xor2(odd ? x[2 * b] : x[2 * b + 1], 1);
        t[b][0] = odd ? recv : keep;
        t[b][1] = odd ? keep : recv;
    }
    const float2 keep0 = hi ? t[1][0] : t[0][0], keep1 = hi ? t[1][1] : t[0][1];
    const float2 recv0 = shfl_xor2(hi ? t[0][0] : t[1][0], 2);
    const float2 recv1 = shfl_xor2(hi ? t[0][1] : t[1][1], 2);
    const float2 lo0 = hi ? recv0 : keep0, lo1 = hi ? recv1 : keep1;  // from lanes 0, 1
    const float2 hi0 = hi ? keep0 : recv0, hi1 = hi ? keep1 : recv1;  // from lanes 2, 3
    y[0] = lo0.x; y[1] = lo0.y; y[2] = lo1.x; y[3] = lo1.y;
    y[4] = hi0.x; y[5] = hi0.y; y[6] = hi1.x; y[7] = hi1.y;
}

// A run epilogue over a consumer warpgroup's 64 x BN accumulator tile (laid
// out as wgmma's d), shared by both GEMMs. Run r of a thread: row half
// r / (RUNS / 2), columns 8·(4·(r % (RUNS / 2)) + quad) .. +7.
template <int BN, class Epi> struct RunEpilogue {
    static constexpr int RUNS = BN / 16;  // (row half, four-run group) pairs of a thread
    static constexpr int NB = Epi::PREFETCH;
    static_assert(RUNS % NB == 0, "prefetch depth must divide the runs of a thread");
    const Epi epi;  // a copy in registers: pointers and sizes
    int row0, wrow, quad, gcol0, valid, M;
    typename Epi::Pre next[NB];

    __device__ __forceinline__ int run_row(int r) const { return row0 + wrow + 8 * (r / (RUNS / 2)); }
    __device__ __forceinline__ int run_col(int r) const { return 8 * (4 * (r % (RUNS / 2)) + quad); }
    __device__ __forceinline__ bool run_ok(int r) const { return run_row(r) < M && run_col(r) < valid; }

    // The first batch of prefetches, issued before the last products are
    // waited for.
    __device__ __forceinline__ void start(bool inside) {
#pragma unroll
        for (int i = 0; i < NB; ++i)
            if (inside || run_ok(i)) next[i] = epi.prefetch(run_row(i), gcol0 + run_col(i));
    }

    // A tile wholly inside the output (nearly all are) runs without a branch
    // between its runs (GUARDED false), so that their shuffles, loads and
    // arithmetic overlap.
    template <bool GUARDED> __device__ __forceinline__ void run(const float (&acc)[BN / 2]) {
#pragma unroll
        for (int r0 = 0; r0 < RUNS; r0 += NB) {
            typename Epi::Pre cur[NB];
#pragma unroll
            for (int i = 0; i < NB; ++i) cur[i] = next[i];
            if (r0 + NB < RUNS) {
#pragma unroll
                for (int i = 0; i < NB; ++i)
                    if (!GUARDED || run_ok(r0 + NB + i))
                        next[i] = epi.prefetch(run_row(r0 + NB + i), gcol0 + run_col(r0 + NB + i));
            }
#pragma unroll
            for (int i = 0; i < NB; ++i) {
                const int r = r0 + i, h = r / (RUNS / 2), g = r % (RUNS / 2);
                float2 x[4];
#pragma unroll
                for (int c = 0; c < 4; ++c)
                    x[c] = make_float2(acc[4 * (4 * g + c) + 2 * h], acc[4 * (4 * g + c) + 2 * h + 1]);
                float y[8];
                quad_transpose(x, quad, y);
                if (!GUARDED || run_ok(r))
                    epi(y, 0, GUARDED ? min(8, valid - run_col(r)) : 8, run_row(r),
                        gcol0 + run_col(r), cur[i]);
            }
        }
    }
};

template <class Epi>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(G_THREADS, 1)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b, int n_cols, int M, int K,
                  const __grid_constant__ Epi epi) {
    constexpr bool TILE = IsTileEpilogue<Epi>::value;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = align_1024(smem_raw);
    unsigned char* staging = smem + G_STAGES * G_STAGE_BYTES;
    uint64_t* full = reinterpret_cast<uint64_t*>(staging + 2 * STAGING_BYTES<Epi>);
    uint64_t* empty = full + G_STAGES;
    uint64_t* turn = empty + G_STAGES;

    if (threadIdx.x == 0) {
        for (int s = 0; s < G_STAGES; ++s) {
            mbar_init(full + s, 1);
            mbar_init(empty + s, 2);
        }
        mbar_init(turn, 1);
        mbar_init(turn + 1, 1);
        mbar_fence_init();
    }
    cluster_sync();  // both blocks' barriers exist before either is used

    const uint32_t rank = cluster_rank();
    const int n_tiles = (n_cols + G_BN - 1) / G_BN;
    const int total = ((M + 2 * G_WM - 1) / (2 * G_WM)) * n_tiles;
    const int first = blockIdx.x / 2, step = gridDim.x / 2;
    const int k_steps = K / G_BK;
    const int wg = threadIdx.x / 128;

    if (wg == 2) {
        reg_dealloc<40>();
        if (threadIdx.x == 256) {
            uint32_t it = 0;
            for (int t = first; t < total; t += step) {
                const int row0 = (t / n_tiles) * 2 * G_WM + rank * G_WM;
                const int col0 = (t % n_tiles) * G_BN;
                for (int kk = 0; kk < k_steps; ++kk, ++it) {
                    const int s = it % G_STAGES;
                    mbar_wait(empty + s, ((it / G_STAGES) & 1) ^ 1);
                    mbar_arrive_expect_tx(full + s, G_STAGE_BYTES);
                    unsigned char* st = smem + s * G_STAGE_BYTES;
                    tma_load_2d(st, &map_a, full + s, kk * G_BK, row0);
#pragma unroll
                    for (int p = 2 * rank; p < 2 * rank + 2; ++p)
                        tma_load_2d_multicast(st + G_A_BYTES + p * G_PANEL_BYTES, &map_b, full + s,
                                              col0 + 64 * p, kk * G_BK, 3);
                }
            }
        }
        __syncwarp();
        // Each role ends on the cluster barrier: no block leaves while its
        // peer may still multicast into its ring or arrive on its barriers.
        cluster_sync();
    } else {
        reg_alloc<232>();
        const int lane = threadIdx.x % 32, quad = lane % 4;
        const int wrow = ((threadIdx.x % 128) / 32) * 16 + lane / 4;
        const bool elected = threadIdx.x % 128 == 0;
        const uint32_t ring = smem_u32(smem);
        float acc[G_BN / 2];
        int item = 0;
        for (int t = first; t < total; t += step, ++item) {
            if ((item & 1) != wg) continue;
            const int row0 = (t / n_tiles) * 2 * G_WM + rank * G_WM;
            const int col0 = (t % n_tiles) * G_BN;
            const int valid = n_cols - col0;  // columns of this tile inside N

            // The warpgroups take turns at the products: a wait names a phase
            // by its parity alone, so a warpgroup may look at a stage's
            // barrier only once the other one is through with all the
            // stages before its own.
            if (item > 0) mbar_wait(turn + wg, ((item - 1) / 2) & 1);
            uint32_t it = (uint32_t)item * k_steps;
            for (int kk = 0; kk < k_steps; ++kk, ++it) {
                const int s = it % G_STAGES;
                mbar_wait(full + s, (it / G_STAGES) & 1);
                const uint32_t a = ring + s * G_STAGE_BYTES;
                const uint32_t b = a + G_A_BYTES;
                wgmma_fence();
#pragma unroll
                for (int k4 = 0; k4 < G_BK / 16; ++k4)
                    wgmma_ss_n256<1>(acc, desc_k_major(a + k4 * 32),
                                     desc_mn_major(b + k4 * 2048, G_PANEL_BYTES),
                                     (kk | k4) != 0);
                wgmma_commit();
                if (kk > 0) {
                    // The previous stage's group is done once one is pending.
                    wgmma_wait<1>();
                    if (elected) {
                        mbar_arrive(empty + (it - 1) % G_STAGES);
                        mbar_arrive_cluster(empty + (it - 1) % G_STAGES, rank ^ 1);
                    }
                }
            }
            // Wait for the last products, release their stage and hand the
            // turn to the other warpgroup.
            auto finish_products = [&]() {
                wgmma_wait<0>();
                if (elected) {
                    mbar_arrive(empty + (it - 1) % G_STAGES);
                    mbar_arrive_cluster(empty + (it - 1) % G_STAGES, rank ^ 1);
                    mbar_arrive(turn + (wg ^ 1));
                }
                fence_registers(acc);
            };
            if constexpr (TILE) {
                const typename Epi::Tile pre = epi.tile_prefetch(row0, wrow, quad);
                finish_products();
                epi.tile(acc, pre,
                         TileCtx{row0, col0, valid, wrow, quad, lane, (int)(threadIdx.x % 128) / 32,
                                 wg, elected, staging + wg * STAGING_BYTES<Epi>});
            } else {
                const bool inside = row0 + G_WM <= M && valid >= G_BN;
                RunEpilogue<G_BN, Epi> runs{epi, row0, wrow, quad, col0, valid, M};
                runs.start(inside);
                finish_products();
                auto epilogue = [&](auto guarded) {
                    runs.template run<decltype(guarded)::value>(acc);
                };
                if (inside)
                    epilogue(Flag<false>{});
                else
                    epilogue(Flag<true>{});
            }
        }
        if constexpr (TILE) {
            if (elected) bulk_wait<0>();  // the last tile's stores are written
        }
        cluster_sync();
    }
}

#include "gemm_tf32.cuh"

// ---------------------------------------------------------------------------
// Flash-style attention: o = softmax(q·kᵀ·scale, key columns >= n_valid
// masked to -1e30)·v for each (batch, head). q, k, v are (batch·heads, n_rows,
// DH) contiguous, DH = 64 or 128. One block takes a tile of queries of one
// (batch, head) and walks key tiles with an online softmax, so no (n, n) score
// matrix is stored. Key tiles wholly past n_valid are skipped; rows past
// n_rows (the ragged last tile) are read as zeros and never written. The
// softmax runs in base 2 with the scale folded into the exponent: a weight is
// 2^(s·c - m·c), c = scale·log2(e) > 0, one FMA and one ex2 from the raw score s
// and the running maximum m of the raw scores.
//
// The Out policy says where a query row's result goes and what multiplies it:
//     T* row(int bh, int n)        first element of the DH outputs of query n
//     float gain(int bh, int n)    factor applied with the 1/l normalisation

// Queries' results (batch·heads, n_rows, dh) head-major, as the inputs are.
template <typename T> struct HeadMajorOut {
    T* o;
    int n_rows, dh;
    __device__ T* row(int bh, int n) const { return o + ((size_t)bh * n_rows + n) * dh; }
    __device__ float gain(int, int) const { return 1.f; }
};

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// float32 on the FMA units, for sequences of at most 64 rows and for DH 128
// (the flagship's frequency axis, 64 rows of which 62 or 60 valid; no main
// path runs DH 128): flash_tf32x3_kernel below takes the longer ones at DH
// 64. 256 threads as 16 x 16:
// thread (ty, tx) owns query rows ty + 16·i (i < RI) of a tile of 16·RI
// queries, and of every 64-key tile the keys tx + 16·j (j < 4). Its score
// rows are its output rows, so the output accumulator (RI rows x DH/16
// columns: tx·4 .. +3 of every 64), the running maximum and the running sum
// stay in registers across key tiles and the rescale is a register multiply.
// Both products read their operands from row-major tiles as float4 along the
// depth (RI + 4 loads for 16·RI FMAs). Scores never touch shared memory; the
// weights pass through it once, as the first operand of the second product.
// K and V have one buffer each, filled by cp.async while the other product
// runs (V during q·kᵀ and the softmax, the next K during p·v), which leaves
// room for two blocks an SM at DH 64: one's softmax overlaps the other's
// products. Two barriers a key tile.
constexpr int FF_BN = 64;
constexpr int FF_P_LD = FF_BN + 16;  // rows ty, ty + 1 of a warp land 16 banks apart

template <int DH, int RI> constexpr size_t FLASH_FMA_SMEM_BYTES =
    ((16 * RI + 2 * FF_BN) * (DH + 4) + 16 * RI * FF_P_LD) * sizeof(float);

// rows x DH floats from src (row stride DH) into rows of DH + 4; rows >=
// valid_rows become zeros.
template <int DH>
__device__ __forceinline__ void ff_load_tile(float* dst, const float* src, int rows,
                                             int valid_rows) {
    constexpr int CH = DH / 4, LD = DH + 4;
    for (int ch = threadIdx.x; ch < rows * CH; ch += THREADS) {
        const int r = ch / CH, c = (ch % CH) * 4;
        float* d = dst + r * LD + c;
        if (r < valid_rows)
            cp_async16(d, src + (size_t)r * DH + c);
        else
            *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
}

template <int DH, int RI, class Out>
__global__ void __launch_bounds__(THREADS, (DH == 64 ? 2 : 1))
flash_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, Out out, int n_rows, int n_valid, float scale) {
    constexpr int BM = 16 * RI, LD = DH + 4, OG = DH / 64;
    extern __shared__ __align__(128) unsigned char smem_raw[];
    float* Qs = reinterpret_cast<float*>(smem_raw);
    float* Ks = Qs + BM * LD;
    float* Vs = Ks + FF_BN * LD;
    float* Ps = Vs + FF_BN * LD;

    const int q_tiles = (n_rows + BM - 1) / BM;
    const int qt = blockIdx.x % q_tiles;
    const int bh = blockIdx.x / q_tiles;
    const size_t base = (size_t)bh * n_rows * DH;
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    const int key_tiles = (n_valid + FF_BN - 1) / FF_BN;
    const float sl2 = scale * LOG2E;

    ff_load_tile<DH>(Qs, q + base + (size_t)qt * BM * DH, BM, n_rows - qt * BM);
    ff_load_tile<DH>(Ks, k + base, FF_BN, n_rows);
    cp_async_commit();

    float o[RI][4 * OG], m_run[RI], l_run[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
        m_run[i] = -INFINITY;
        l_run[i] = 0.f;
#pragma unroll
        for (int c = 0; c < 4 * OG; ++c) o[i][c] = 0.f;
    }

    for (int kt = 0; kt < key_tiles; ++kt) {
        cp_async_wait<0>();
        // K of tile kt (and Q) has landed for every thread, and every thread
        // is past the second product of tile kt - 1: Vs and Ps are free.
        __syncthreads();
        ff_load_tile<DH>(Vs, v + base + (size_t)kt * FF_BN * DH, FF_BN, n_rows - kt * FF_BN);
        cp_async_commit();

        float s[RI][4];
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
        for (int d = 0; d < DH; d += 4) {
            float4 qv[RI];
#pragma unroll
            for (int i = 0; i < RI; ++i)
                qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * LD + d);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float4 kv = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * LD + d);
#pragma unroll
                for (int i = 0; i < RI; ++i) {
                    s[i][j] = fmaf(qv[i].x, kv.x, s[i][j]);
                    s[i][j] = fmaf(qv[i].y, kv.y, s[i][j]);
                    s[i][j] = fmaf(qv[i].z, kv.z, s[i][j]);
                    s[i][j] = fmaf(qv[i].w, kv.w, s[i][j]);
                }
            }
        }

        if ((kt + 1) * FF_BN > n_valid) {
#pragma unroll
            for (int j = 0; j < 4; ++j)
                if (kt * FF_BN + tx + 16 * j >= n_valid) {
#pragma unroll
                    for (int i = 0; i < RI; ++i) s[i][j] = -1e30f;
                }
        }
#pragma unroll
        for (int i = 0; i < RI; ++i) {
            float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
            for (int w = 8; w > 0; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
            const float m_new = fmaxf(m_run[i], mx);
            const float alpha = ex2((m_run[i] - m_new) * sl2);
            const float ms = m_new * sl2;
            m_run[i] = m_new;
            float lsum = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float p = ex2(fmaf(s[i][j], sl2, -ms));
                lsum += p;
                Ps[(ty + 16 * i) * FF_P_LD + tx + 16 * j] = p;
            }
#pragma unroll
            for (int w = 8; w > 0; w >>= 1) lsum += __shfl_xor_sync(0xffffffffu, lsum, w);
            l_run[i] = l_run[i] * alpha + lsum;
#pragma unroll
            for (int c = 0; c < 4 * OG; ++c) o[i][c] *= alpha;
        }
        cp_async_wait<0>();
        // V of tile kt has landed and Ps is written for every thread, and
        // every thread is past the first product: Ks is free.
        __syncthreads();
        if (kt + 1 < key_tiles) {
            ff_load_tile<DH>(Ks, k + base + (size_t)(kt + 1) * FF_BN * DH, FF_BN,
                             n_rows - (kt + 1) * FF_BN);
            cp_async_commit();
        }

#pragma unroll 2
        for (int key = 0; key < FF_BN; key += 4) {
            float pv[RI][4];
#pragma unroll
            for (int i = 0; i < RI; ++i) load4(Ps + (ty + 16 * i) * FF_P_LD + key, pv[i]);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
#pragma unroll
                for (int g = 0; g < OG; ++g) {
                    float vv[4];
                    load4(Vs + (key + kk) * LD + 64 * g + tx * 4, vv);
#pragma unroll
                    for (int i = 0; i < RI; ++i)
#pragma unroll
                        for (int c = 0; c < 4; ++c)
                            o[i][4 * g + c] = fmaf(pv[i][kk], vv[c], o[i][4 * g + c]);
                }
        }
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
        const int n = qt * BM + ty + 16 * i;
        if (n >= n_rows) continue;
        const float f = out.gain(bh, n) / l_run[i];
        float* dst = out.row(bh, n);
#pragma unroll
        for (int g = 0; g < OG; ++g)
            *reinterpret_cast<float4*>(dst + 64 * g + tx * 4) =
                make_float4(o[i][4 * g] * f, o[i][4 * g + 1] * f, o[i][4 * g + 2] * f,
                            o[i][4 * g + 3] * f);
    }
}

// bf16, on wgmma with TMA-fed operands. A block takes 64·CONSUMERS queries of
// one (batch, head): each consumer warpgroup owns 64 of them (three warpgroups
// at DH 64, two at DH 128, where the output accumulator is twice as wide); one
// thread of the producer warpgroup loads Q once and then keeps a ring of
// (K, V) tiles of 128 keys in flight. Warpgroups whose 64 rows lie wholly past
// n_rows leave at once. Sequences of at most 64 rows get blocks of one
// consumer warpgroup and a ring of two tiles, small enough for two blocks an
// SM: such a block is all latency (loads, one tile, stores), and what hides
// it is another block. The tensor maps are three-dimensional, (dh, row, batch·head), so rows
// past n_rows arrive as zeros instead of the next head's rows. Per key tile and
// warpgroup: S = Q·Kᵀ as m64n128k16 from shared memory (K's rows are the
// K-major second operand as they lie), the online softmax on the accumulators
// (a row lives in the four lanes sharing lane / 4), P = exp2(S - m) rounded to
// bf16 straight into the register first operand of O += P·V, with V read
// MN-major through the transpose bit. S, P, O, the running maximum and sum
// never leave registers. A tile's S is started together with the previous
// tile's P·V and its softmax runs while P·V is still on the tensor cores; the
// warpgroups start their products in turn (named barriers), so that one's
// softmax falls on the others' products.
constexpr int FW_N = 128;
constexpr int FW_PANEL_BYTES = FW_N * 128;  // 128 keys of 64 bf16

template <int DH> constexpr int FW_CONSUMERS = DH == 64 ? 3 : 2;
template <int CONSUMERS> constexpr int FW_STAGES = CONSUMERS == 1 ? 2 : 3;
template <int DH, int CONSUMERS> constexpr size_t FLASH_WGMMA_SMEM_BYTES =
    (DH / 64) * (CONSUMERS * 64 * 128 + 2 * FW_STAGES<CONSUMERS> * FW_PANEL_BYTES) + 1024 +
    (1 + 2 * FW_STAGES<CONSUMERS>) * 8;

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&h);
}

template <int DH, int CONSUMERS, class Out>
__global__ void __launch_bounds__(128 * (CONSUMERS + 1), CONSUMERS == 1 ? 2 : 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v, Out out, int n_rows, int n_valid,
                   float scale) {
    constexpr int BM = 64 * CONSUMERS, STAGES = FW_STAGES<CONSUMERS>;
    // Registers a thread after setmaxnreg: what the block was given at launch
    // (the launch bounds' count for every thread), moved from the producer
    // warpgroup to the consumers.
    constexpr int PRODUCER_REGS = CONSUMERS == 3 ? 32 : 40;
    constexpr int CONSUMER_REGS = CONSUMERS == 3 ? 160 : CONSUMERS == 2 ? 232 : 216;
    constexpr int PANELS = DH / 64, TILE_BYTES = PANELS * FW_PANEL_BYTES;
    constexpr int Q_PANEL_BYTES = BM * 128;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* Qs = align_1024(smem_raw);
    unsigned char* Ks = Qs + PANELS * Q_PANEL_BYTES;
    unsigned char* Vs = Ks + STAGES * TILE_BYTES;
    uint64_t* q_bar = reinterpret_cast<uint64_t*>(Vs + STAGES * TILE_BYTES);
    uint64_t* full = q_bar + 1;
    uint64_t* empty = full + STAGES;

    const int q_tiles = (n_rows + BM - 1) / BM;
    const int qt = blockIdx.x % q_tiles;
    const int bh = blockIdx.x / q_tiles;
    const int key_tiles = (n_valid + FW_N - 1) / FW_N;
    const int wg = threadIdx.x / 128;
    // Warpgroups with rows to compute: the others take no part in anything.
    const int active = min(CONSUMERS, (n_rows - qt * BM + 63) / 64);

    if (threadIdx.x == 0) {
        mbar_init(q_bar, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full + s, 1);
            mbar_init(empty + s, active);
        }
        mbar_fence_init();
    }
    __syncthreads();

    if (wg == CONSUMERS) {
        reg_dealloc<PRODUCER_REGS>();
        if (threadIdx.x == 128 * CONSUMERS) {
            mbar_arrive_expect_tx(q_bar, PANELS * Q_PANEL_BYTES);
#pragma unroll
            for (int p = 0; p < PANELS; ++p)
                tma_load_3d(Qs + p * Q_PANEL_BYTES, &map_q, q_bar, 64 * p, qt * BM, bh);
            for (int kt = 0; kt < key_tiles; ++kt) {
                const int s = kt % STAGES;
                mbar_wait(empty + s, ((kt / STAGES) & 1) ^ 1);
                mbar_arrive_expect_tx(full + s, 2 * TILE_BYTES);
#pragma unroll
                for (int p = 0; p < PANELS; ++p) {
                    tma_load_3d(Ks + s * TILE_BYTES + p * FW_PANEL_BYTES, &map_k, full + s,
                                64 * p, kt * FW_N, bh);
                    tma_load_3d(Vs + s * TILE_BYTES + p * FW_PANEL_BYTES, &map_v, full + s,
                                64 * p, kt * FW_N, bh);
                }
            }
        }
    } else if (wg < active) {
        reg_alloc<CONSUMER_REGS>();
        const int lane = threadIdx.x % 32, quad = lane % 4;
        const int wrow = wg * 64 + ((threadIdx.x % 128) / 32) * 16 + lane / 4;
        const bool elected = threadIdx.x % 128 == 0;
        const uint32_t q_addr = smem_u32(Qs) + wg * 64 * 128;
        const float sl2 = scale * LOG2E;

        float o[DH / 2];  // runs of eight output columns, laid out as wgmma's d
        float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;

        // S = Q·Kᵀ for the key tile in stage s, as one wgmma group.
        auto start_scores = [&](float (&sc)[FW_N / 2], int s) {
            const uint32_t k_addr = smem_u32(Ks) + s * TILE_BYTES;
            wgmma_fence();
#pragma unroll
            for (int kc = 0; kc < DH / 16; ++kc)
                wgmma_ss_n128<0>(sc, desc_k_major(q_addr + (kc / 4) * Q_PANEL_BYTES + (kc % 4) * 32),
                                 desc_k_major(k_addr + (kc / 4) * FW_PANEL_BYTES + (kc % 4) * 32),
                                 kc != 0);
            wgmma_commit();
        };

        // The online softmax of key tile kt on its complete scores, in place:
        // updates the running maximum and sum, leaves the tile's weights in sc
        // and the factor that the output accumulated so far must be multiplied
        // by in alpha.
        auto softmax = [&](float (&sc)[FW_N / 2], int kt, float (&alpha)[2]) {
            if ((kt + 1) * FW_N > n_valid) {
#pragma unroll
                for (int j = 0; j < FW_N / 8; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        if (kt * FW_N + 8 * j + 2 * quad + (e & 1) >= n_valid)
                            sc[4 * j + e] = -1e30f;
            }
            float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
            for (int j = 0; j < FW_N / 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], sc[4 * j + e]);
            // m_run is in score units; the scale is folded into the exponent.
            float ms[2], lsum[2] = {0.f, 0.f};
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
                mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
                const float m_new = fmaxf(m_run[h], mx[h]);
                alpha[h] = ex2((m_run[h] - m_new) * sl2);
                ms[h] = m_new * sl2;
                m_run[h] = m_new;
            }
#pragma unroll
            for (int j = 0; j < FW_N / 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    sc[4 * j + e] = ex2(fmaf(sc[4 * j + e], sl2, -ms[e / 2]));
                    lsum[e / 2] += sc[4 * j + e];
                }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                lsum[h] += __shfl_xor_sync(0xffffffffu, lsum[h], 1);
                lsum[h] += __shfl_xor_sync(0xffffffffu, lsum[h], 2);
                l_run[h] = l_run[h] * alpha[h] + lsum[h];
            }
        };

        // The weights as bf16 first-operand fragments: two adjacent runs of
        // eight keys are the m16k16 fragment of a k16 step.
        uint32_t pa[FW_N / 16][4];
        auto pack_weights = [&](const float (&sc)[FW_N / 2]) {
#pragma unroll
            for (int c = 0; c < FW_N / 16; ++c)
#pragma unroll
                for (int r = 0; r < 4; ++r)
                    pa[c][r] = pack_bf16(sc[8 * c + 2 * r], sc[8 * c + 2 * r + 1]);
        };

        // O += P·V for the key tile in stage s, as one wgmma group.
        auto start_pv = [&](int s) {
            const uint32_t v_addr = smem_u32(Vs) + s * TILE_BYTES;
            wgmma_fence();
#pragma unroll
            for (int c = 0; c < FW_N / 16; ++c) {
                const uint64_t vd = desc_mn_major(v_addr + c * 2048, FW_PANEL_BYTES);
                if constexpr (DH == 64)
                    wgmma_rs_n64<1>(o, pa[c], vd, 1);
                else
                    wgmma_rs_n128<1>(o, pa[c], vd, 1);
            }
            wgmma_commit();
        };

        float sc[FW_N / 2], alpha[2];
        // Warpgroup 0 goes first; each hands the turn to the next.
        if (active > 1 && wg == active - 1) named_barrier_arrive(1, 256);
        mbar_wait(q_bar, 0);
        mbar_wait(full, 0);
        start_scores(sc, 0);
        wgmma_wait<0>();
        fence_registers(sc);
        softmax(sc, 0, alpha);  // nothing accumulated yet: alpha is not used
        pack_weights(sc);
        for (int kt = 1; kt < key_tiles; ++kt) {
            // This tile's scores and the previous tile's P·V are started
            // together; the softmax of the scores then runs while the tensor
            // cores are still busy with P·V. Once that is done the weights'
            // registers are free for this tile's, and the output is rescaled
            // before the next P·V adds to it.
            mbar_wait(full + kt % STAGES, (kt / STAGES) & 1);
            if (active > 1) named_barrier_sync(1 + wg, 256);
            start_scores(sc, kt % STAGES);
            start_pv((kt - 1) % STAGES);
            if (active > 1) named_barrier_arrive(1 + (wg + 1) % active, 256);
            wgmma_wait<1>();
            fence_registers(sc);
            softmax(sc, kt, alpha);
            wgmma_wait<0>();
            fence_registers(o);
            if (elected) mbar_arrive(empty + (kt - 1) % STAGES);
#pragma unroll
            for (int j = 0; j < DH / 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) o[4 * j + e] *= alpha[e / 2];
            pack_weights(sc);
        }
        start_pv((key_tiles - 1) % STAGES);
        wgmma_wait<0>();
        fence_registers(o);

#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int n = qt * BM + wrow + 8 * h;
            if (n >= n_rows) continue;
            const float f = out.gain(bh, n) / l_run[h];
            bf16* dst = out.row(bh, n) + 2 * quad;
#pragma unroll
            for (int j = 0; j < DH / 8; ++j)
                *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
                    __floats2bfloat162_rn(o[4 * j + 2 * h] * f, o[4 * j + 2 * h + 1] * f);
        }
    }
}

// float32 on the tensor cores, for sequences of more than 64 rows at DH 64
// (FLASH_TF32X3; B1's time axis, 832 rows, and B3's 1344 and 2688 rows):
// both products as 3xTF32 on wgmma, each operand split into
// a TF32 head and tail as gemm_tf32.cuh splits them (round_tf32), each term
// a_hi·b_hi + a_hi·b_lo + a_lo·b_hi summed in float32: float32 accuracy
// (ops/tf32.py has the argument). Bound: 4·BH·n_valid²·64 operations at the
// TF32 rate over three, 494.7 / 3 = 165 TFLOP/s (the flagship time axis,
// 1984 sequences of 801 valid keys: 1.98 ms), against 67 on the FMA pipe.
// A block of three warpgroups takes 128 queries of one (batch, head):
//   * one thread of the producer warpgroup keeps a ring of FT_RAW_STAGES raw
//     (K, V) tiles of 64 keys filled by TMA (a three-dimensional map, so rows
//     past n_rows arrive as zeros, never as the next head's);
//   * its other three warps split each raw tile into a stage of the split
//     ring: K's heads and tails at K's own swizzled offsets (the K-major B of
//     S = Q·Kᵀ as it lies), and V's heads and tails transposed, 64 rows of D
//     by 64 keys: TF32 wgmma reads B only K-major and has no transpose bit.
//     The keys of the transposed tiles lie in k_order: P comes to P·V from
//     the accumulator registers, whose lane t holds columns 2t, 2t + 1 of
//     each eight, and the A fragment takes those as k = t and t + 4, so V's
//     rows are permuted in the split instead of P across lanes;
//   * each consumer warpgroup owns 64 queries, kept in registers and split
//     there into the A operand of S for each key tile (m64n64k8, three
//     products a k8 step);
//     the online softmax runs as flash_fma_kernel's (exp2 with scale·log2e,
//     running maximum and sum in registers, -1e30 for key columns >=
//     n_valid); P is split in registers into the A operand of P·V, whose
//     tile sum (64 keys deep: the tensor cores' adder is good to that
//     depth, gemm_tf32.cuh) is added to the rescaled output on the FMA pipe.
// The two consumer warpgroups work at the same key tiles, so one's softmax
// runs while the other's products are on the tensor cores. Warpgroups whose
// 64 rows lie wholly past n_rows leave at once. Every key order is fixed and
// a query row's output comes from one block: no atomics, the same bits from
// run to run.
constexpr int FT_N = 64;                          // keys a tile
constexpr int FT_TILE_BYTES = FT_N * 64 * 4;      // 64 rows of 64 floats: two panels
constexpr int FT_PANEL_BYTES = FT_TILE_BYTES / 2;
// 224 KB of rings; three raw stages took 4.48 ms at the flagship time axis,
// two 4.54 (H100 80GB HBM3, 700 W).
constexpr int FT_RAW_STAGES = 3, FT_STAGES = 2;
constexpr int FT_THREADS = 384;
constexpr int FT_SPLITTERS = 96;                  // warps 9..11 split the tiles
constexpr size_t FLASH_TF32_SMEM_BYTES =
    (2 * FT_RAW_STAGES + 4 * FT_STAGES) * FT_TILE_BYTES + 1024 + 2 * (FT_RAW_STAGES + FT_STAGES) * 8;

__device__ __forceinline__ uint32_t tf32_u32(float x) { return __float_as_uint(round_tf32(x)); }

template <class Out>
__global__ void __launch_bounds__(FT_THREADS, 1)
flash_tf32x3_kernel(const float* __restrict__ q, const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v, Out out, int n_rows, int n_valid,
                    float scale) {
    extern __shared__ unsigned char smem_raw[];
    unsigned char* raw = align_1024(smem_raw);  // a stage: K, V as TMA brings them
    unsigned char* split = raw + 2 * FT_RAW_STAGES * FT_TILE_BYTES;  // K hi, K lo, Vᵀ hi, Vᵀ lo
    uint64_t* raw_full = reinterpret_cast<uint64_t*>(split + 4 * FT_STAGES * FT_TILE_BYTES);
    uint64_t* raw_empty = raw_full + FT_RAW_STAGES;
    uint64_t* split_full = raw_empty + FT_RAW_STAGES;
    uint64_t* split_empty = split_full + FT_STAGES;

    const int q_tiles = (n_rows + 127) / 128;
    const int qt = blockIdx.x % q_tiles;
    const int bh = blockIdx.x / q_tiles;
    const int key_tiles = (n_valid + FT_N - 1) / FT_N;
    const int wg = threadIdx.x / 128;
    const int active = min(2, (n_rows - qt * 128 + 63) / 64);

    if (threadIdx.x == 0) {
        for (int s = 0; s < FT_RAW_STAGES; ++s) {
            mbar_init(raw_full + s, 1);
            mbar_init(raw_empty + s, FT_SPLITTERS);
        }
        for (int s = 0; s < FT_STAGES; ++s) {
            mbar_init(split_full + s, FT_SPLITTERS);
            mbar_init(split_empty + s, active);
        }
        mbar_fence_init();
    }
    __syncthreads();

    if (wg == 2) {
        reg_dealloc<40>();
        if (threadIdx.x == 256) {
            for (int kt = 0; kt < key_tiles; ++kt) {
                const int s = kt % FT_RAW_STAGES;
                mbar_wait(raw_empty + s, ((kt / FT_RAW_STAGES) & 1) ^ 1);
                mbar_arrive_expect_tx(raw_full + s, 2 * FT_TILE_BYTES);
                unsigned char* st = raw + s * 2 * FT_TILE_BYTES;
#pragma unroll
                for (int p = 0; p < 2; ++p) {
                    tma_load_3d(st + p * FT_PANEL_BYTES, &map_k, raw_full + s, 32 * p, kt * FT_N,
                                bh);
                    tma_load_3d(st + FT_TILE_BYTES + p * FT_PANEL_BYTES, &map_v, raw_full + s,
                                32 * p, kt * FT_N, bh);
                }
            }
        } else if (threadIdx.x >= FT_THREADS - FT_SPLITTERS) {
            // A splitter cannot fall two phases behind on either ring: a raw
            // stage is refilled only once every splitter has arrived on its
            // raw_empty, and a split stage only after every splitter's split.
            const int t = threadIdx.x - (FT_THREADS - FT_SPLITTERS);
            const int warp = t / 32, lane = t % 32;
            for (int kt = 0; kt < key_tiles; ++kt) {
                const int r = kt % FT_RAW_STAGES, s = kt % FT_STAGES;
                mbar_wait(split_empty + s, ((kt / FT_STAGES) & 1) ^ 1);
                mbar_wait(raw_full + r, (kt / FT_RAW_STAGES) & 1);
                const unsigned char* kraw = raw + r * 2 * FT_TILE_BYTES;
                const unsigned char* vraw = kraw + FT_TILE_BYTES;
                unsigned char* kh = split + s * 4 * FT_TILE_BYTES;
                unsigned char* kl = kh + FT_TILE_BYTES;
                unsigned char* vh = kl + FT_TILE_BYTES;
                unsigned char* vl = vh + FT_TILE_BYTES;
#pragma unroll 1
                for (int u = 16 * t; u < FT_TILE_BYTES; u += 16 * FT_SPLITTERS) {
                    const float4 x = *reinterpret_cast<const float4*>(kraw + u);
                    const float4 h = make_float4(round_tf32(x.x), round_tf32(x.y), round_tf32(x.z),
                                                 round_tf32(x.w));
                    *reinterpret_cast<float4*>(kh + u) = h;
                    *reinterpret_cast<float4*>(kl + u) =
                        make_float4(round_tf32(x.x - h.x), round_tf32(x.y - h.y),
                                    round_tf32(x.z - h.z), round_tf32(x.w - h.w));
                }
                // V: lane l takes key 32·half + l, a warp four columns of D at
                // a time; the raw reads and the transposed writes of a warp
                // each fall on 32 banks.
#pragma unroll 1
                for (int i = warp; i < 32; i += FT_SPLITTERS / 32) {
                    const int key = 32 * (i >> 4) + lane, c = 4 * (i & 15), kq = k_order(key);
                    const float4 x = *reinterpret_cast<const float4*>(vraw + swz<FT_N>(key, c));
                    const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const float h = round_tf32(xv[j]);
                        *reinterpret_cast<float*>(vh + swz<64>(c + j, kq)) = h;
                        *reinterpret_cast<float*>(vl + swz<64>(c + j, kq)) = round_tf32(xv[j] - h);
                    }
                }
                fence_proxy_async();  // the split tiles, before wgmma reads them
                mbar_arrive(split_full + s);
                mbar_arrive(raw_empty + r);
            }
        }
    } else if (wg < active) {
        reg_alloc<232>();
        const int tid = threadIdx.x % 128, lane = tid % 32, quad = lane % 4;
        const int wrow = (tid / 32) * 16 + lane / 4;  // rows wrow and wrow + 8 of the 64
        const int row0 = qt * 128 + wg * 64;
        const bool elected = tid == 0;
        const float sl2 = scale * LOG2E;

        // Q in the layout of the A fragments of the eight k8 steps over D:
        // qx[4·kk + e] is row wrow + 8·(e & 1), column 8·kk + quad + 4·(e >> 1).
        // Rows past n_rows are zeros. Its heads and tails are made anew for
        // each tile's S, behind a register fence that keeps the compiler from
        // hoisting them out of the loop: with the fragments kept in registers
        // from one tile to the next, ptxas gave their registers to other
        // values, and every S after the first lost its Q tails (about 1e-4 of
        // the output, the same bits in every run).
        float qx[32];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int n = row0 + wrow + 8 * (e & 1);
            const float* src = q + ((size_t)bh * n_rows + n) * 64 + quad + 4 * (e >> 1);
#pragma unroll
            for (int kk = 0; kk < 8; ++kk) qx[4 * kk + e] = n < n_rows ? __ldg(src + 8 * kk) : 0.f;
        }

        float o[32];  // runs of eight output columns, laid out as wgmma's d
        float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 32; ++i) o[i] = 0.f;

        for (int kt = 0; kt < key_tiles; ++kt) {
            const int s = kt % FT_STAGES;
            mbar_wait(split_full + s, (kt / FT_STAGES) & 1);
            const uint32_t kh = smem_u32(split + s * 4 * FT_TILE_BYTES), kl = kh + FT_TILE_BYTES;
            const uint32_t vh = kl + FT_TILE_BYTES, vl = vh + FT_TILE_BYTES;

            // S = Q·Kᵀ over the tile's 64 keys.
            fence_registers(qx);
            uint32_t qh[8][4], ql[8][4];
#pragma unroll
            for (int kk = 0; kk < 8; ++kk)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float h = round_tf32(qx[4 * kk + e]);
                    qh[kk][e] = __float_as_uint(h);
                    ql[kk][e] = tf32_u32(qx[4 * kk + e] - h);
                }
            float sc[32];
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 8; ++kk) {
                const uint32_t off = (kk >> 2) * FT_PANEL_BYTES + (kk & 3) * 32;
                const uint64_t dkh = desc_k_major(kh + off);
                wgmma_tf32_rs_n64(sc, qh[kk], dkh, kk != 0);
                wgmma_tf32_rs_n64(sc, qh[kk], desc_k_major(kl + off), 1);
                wgmma_tf32_rs_n64(sc, ql[kk], dkh, 1);
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_registers(sc);

            // The online softmax: sc[4j + e] is row wrow + 8·(e >> 1), key
            // 8j + 2·quad + (e & 1) of the tile.
            if ((kt + 1) * FT_N > n_valid) {
#pragma unroll
                for (int j = 0; j < 8; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        if (kt * FT_N + 8 * j + 2 * quad + (e & 1) >= n_valid) sc[4 * j + e] = -1e30f;
            }
            float alpha[2], ms[2], lsum[2] = {0.f, 0.f};
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                float mx = -INFINITY;
#pragma unroll
                for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]));
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
                const float m_new = fmaxf(m_run[h], mx);
                alpha[h] = ex2((m_run[h] - m_new) * sl2);
                ms[h] = m_new * sl2;
                m_run[h] = m_new;
            }
            // P, split into the A fragments of P·V: register e of step j is
            // row wrow + 8·(e & 1), position quad + 4·(e >> 1) of the step,
            // which holds key 8j + 2·quad + (e >> 1) (k_order).
            uint32_t ph[8][4], pl[8][4];
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int i = 4 * j + 2 * (e & 1) + (e >> 1);
                    const float p = ex2(fmaf(sc[i], sl2, -ms[e & 1]));
                    lsum[e & 1] += p;
                    const float h = round_tf32(p);
                    ph[j][e] = __float_as_uint(h);
                    pl[j][e] = tf32_u32(p - h);
                }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                lsum[h] += __shfl_xor_sync(0xffffffffu, lsum[h], 1);
                lsum[h] += __shfl_xor_sync(0xffffffffu, lsum[h], 2);
                l_run[h] = l_run[h] * alpha[h] + lsum[h];
            }

            // O = O·alpha + P·V, the tile's sum on the tensor cores.
            float part[32];
            wgmma_fence();
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const uint32_t off = (j >> 2) * FT_PANEL_BYTES + (j & 3) * 32;
                const uint64_t dvh = desc_k_major(vh + off);
                wgmma_tf32_rs_n64(part, ph[j], dvh, j != 0);
                wgmma_tf32_rs_n64(part, ph[j], desc_k_major(vl + off), 1);
                wgmma_tf32_rs_n64(part, pl[j], dvh, 1);
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_registers(part);
            if (elected) mbar_arrive(split_empty + s);
#pragma unroll
            for (int i = 0; i < 32; ++i) o[i] = fmaf(o[i], alpha[(i >> 1) & 1], part[i]);
        }

#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int n = row0 + wrow + 8 * h;
            if (n >= n_rows) continue;
            const float f = out.gain(bh, n) / l_run[h];
            float* dst = out.row(bh, n) + 2 * quad;
#pragma unroll
            for (int j = 0; j < 8; ++j)
                *reinterpret_cast<float2*>(dst + 8 * j) =
                    make_float2(o[4 * j + 2 * h] * f, o[4 * j + 2 * h + 1] * f);
        }
    }
}

// out = x + round(C + bias): the residual epilogue of the output projection
// (bias == nullptr) and of the feed-forward's second product. With x ==
// nullptr too it writes the partial product round(C) alone, neither reading
// nor adding a residual: the row-parallel shard of a tensor-parallel layer,
// whose caller adds the residual, the bias and the other shards' partials.
// Output column tiles are multiples of 8 wide here (d_model % 64 == 0), so
// every call covers a full run of eight.
template <typename T> struct ResidualEpi {
    const T* x;
    const T* bias;
    T* out;
    int cols;
    using Pre = Vec8<T>;  // the residual's eight values (zeros without one)
    static constexpr int PREFETCH = 4;
    __device__ Pre prefetch(int grow, int gcol0) const {
        if (x == nullptr) return Pre{};
        return load_vec8(x + (size_t)grow * cols + gcol0);
    }
    __device__ void operator()(const float* row, int c0, int, int grow, int gcol0,
                               const Pre& pre) const {
        float xv[8], bv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, y[8];
        unpack(pre, xv);
        if (bias != nullptr) load8_ro(bias + gcol0, bv);
#pragma unroll
        for (int e = 0; e < 8; ++e) y[e] = xv[e] + rnd<T>(row[c0 + e] + bv[e]);
        store8(out + (size_t)grow * cols + gcol0, y);
    }
};

template <typename Kernel, typename... Args>
cudaError_t launch_block(Kernel kernel, dim3 grid, int threads, size_t smem,
                         cudaStream_t stream, Args... args) {
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    kernel<<<grid, threads, smem, stream>>>(args...);
    return cudaGetLastError();
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream, Args... args) {
    return launch_block(kernel, grid, THREADS, smem, stream, args...);
}

template <typename T>
cudaError_t run_rmsnorm(const T* x, const T* gamma, T* xn, int rows, int d,
                        cudaStream_t stream) {
    const int per_block = THREADS / 32;
    return launch(rmsnorm_kernel<T>, dim3((rows + per_block - 1) / per_block), 0, stream, x,
                  gamma, xn, rows, d);
}

inline int sm_count() {
    static int count = 0;
    if (count == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    }
    return count;
}

// gates and xn of the attention block: the kernel for the head count rounded
// up to a power of two (heads <= 64), persistent blocks as many as fit.
template <typename T, int H>
cudaError_t run_rmsnorm_gates_h(const T* x, const T* gamma, const T* gate_w, const T* gate_b,
                                T* xn, float* gates, int rows, int d, int heads, int n_pad,
                                cudaStream_t stream) {
    const auto kernel = rmsnorm_gates_kernel<T, H>;
    const size_t smem = (size_t)d * H * sizeof(T);
    if (smem > 48 * 1024) {
        const cudaError_t err =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    int per_sm = 0;
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
    if (err != cudaSuccess) return err;
    const int rows_a_block = THREADS / 32;
    const int blocks = min((rows + rows_a_block - 1) / rows_a_block, max(per_sm, 1) * sm_count());
    return launch_block(kernel, dim3(blocks), THREADS, smem, stream, x, gamma, gate_w, gate_b, xn,
                        gates, rows, d, heads, n_pad);
}

template <typename T>
cudaError_t run_rmsnorm_gates(const T* x, const T* gamma, const T* gate_w, const T* gate_b,
                              T* xn, float* gates, int rows, int d, int heads, int n_pad,
                              cudaStream_t stream) {
#define ASEP_GATES(H)                                                                         \
    if (heads <= H)                                                                           \
        return run_rmsnorm_gates_h<T, H>(x, gamma, gate_w, gate_b, xn, gates, rows, d, heads, \
                                         n_pad, stream);
    ASEP_GATES(1) ASEP_GATES(2) ASEP_GATES(4) ASEP_GATES(8) ASEP_GATES(16) ASEP_GATES(32)
    ASEP_GATES(64)
#undef ASEP_GATES
    return cudaErrorInvalidValue;
}

// C = A·B through the epilogue; M rows, K deep (K % 64 == 0), N columns.
// bf16: B is (K, N) row-major; float32: B is the prepared (2, N, K) form. Both
// need every operand 16-byte aligned with row lengths that are multiples of
// 16 bytes (TMA).
template <typename T, class Epi>
cudaError_t run_gemm(const T* A, const T* B, int n_cols, int M, int K, Epi epi,
                     cudaStream_t stream) {
    if constexpr (sizeof(T) == 2) {
        const int row_groups = (M + 2 * G_WM - 1) / (2 * G_WM);
        CUtensorMap map_a, map_b;
        cudaError_t err = encode_rows_map(&map_a, A, M, K, G_WM);
        if (err != cudaSuccess) return err;
        err = encode_rows_map(&map_b, B, K, n_cols, G_BK);
        if (err != cudaSuccess) return err;
        const int items = row_groups * ((n_cols + G_BN - 1) / G_BN);
        return launch_block(gemm_wgmma_kernel<Epi>, dim3(2 * min(items, sm_count() / 2)),
                            G_THREADS, GEMM_WGMMA_SMEM_BYTES<Epi>, stream, map_a, map_b, n_cols,
                            M, K, epi);
    } else {
        CUtensorMap map_a, map_hi, map_lo;
        cudaError_t err = encode_rows_map_f32(&map_a, A, M, K, G_WM);
        if (err != cudaSuccess) return err;
        err = encode_rows_map_f32(&map_hi, B, n_cols, K, T_BN / T_CLUSTER);
        if (err != cudaSuccess) return err;
        err = encode_rows_map_f32(&map_lo, B + (size_t)n_cols * K, n_cols, K, T_BN / T_CLUSTER);
        if (err != cudaSuccess) return err;
        const int items = ((M + T_CLUSTER * G_WM - 1) / (T_CLUSTER * G_WM)) *
                          ((n_cols + T_BN - 1) / T_BN);
        return launch_block(gemm_tf32x3_kernel<Epi>,
                            dim3(T_CLUSTER * min(items, sm_count() / T_CLUSTER)), G_THREADS,
                            GEMM_TF32_SMEM_BYTES, stream, map_a, map_hi, map_lo, n_cols, M, K, epi);
    }
}

template <int DH, int CONSUMERS, class Out>
cudaError_t run_flash_wgmma(const bf16* q, const bf16* k, const bf16* v, Out out, int bh,
                            int n_rows, int n_valid, float scale, cudaStream_t stream) {
    constexpr int BM = 64 * CONSUMERS;
    CUtensorMap map_q, map_k, map_v;
    cudaError_t err = encode_heads_map(&map_q, q, bh, n_rows, DH, BM);
    if (err != cudaSuccess) return err;
    err = encode_heads_map(&map_k, k, bh, n_rows, DH, FW_N);
    if (err != cudaSuccess) return err;
    err = encode_heads_map(&map_v, v, bh, n_rows, DH, FW_N);
    if (err != cudaSuccess) return err;
    return launch_block(flash_wgmma_kernel<DH, CONSUMERS, Out>,
                        dim3(bh * ((n_rows + BM - 1) / BM)), 128 * (CONSUMERS + 1),
                        FLASH_WGMMA_SMEM_BYTES<DH, CONSUMERS>, stream, map_q, map_k, map_v, out,
                        n_rows, n_valid, scale);
}

template <class Out>
cudaError_t run_flash_tf32x3(const float* q, const float* k, const float* v, Out out, int bh,
                             int n_rows, int n_valid, float scale, cudaStream_t stream) {
    CUtensorMap map_k, map_v;
    cudaError_t err = encode_heads_map_f32(&map_k, k, bh, n_rows, 64, FT_N);
    if (err != cudaSuccess) return err;
    err = encode_heads_map_f32(&map_v, v, bh, n_rows, 64, FT_N);
    if (err != cudaSuccess) return err;
    return launch_block(flash_tf32x3_kernel<Out>, dim3(bh * ((n_rows + 127) / 128)), FT_THREADS,
                        FLASH_TF32_SMEM_BYTES, stream, q, map_k, map_v, out, n_rows, n_valid,
                        scale);
}

// The kernel an attention launch runs, as the caller chose it from the type,
// n_rows and dh (ops/attention.flash_route, which numbers them alike).
enum FlashRoute : int { FLASH_WGMMA = 0, FLASH_FMA = 1, FLASH_TF32X3 = 2 };

// One attention launch over (bh, n_rows, dh) operands, dh 64 or 128; key
// columns >= n_valid are masked. bf16 takes FLASH_WGMMA; float32 takes
// FLASH_TF32X3 (dh 64) or FLASH_FMA.
template <typename T, class Out>
cudaError_t run_flash(const T* q, const T* k, const T* v, Out out, int bh, int n_rows,
                      int n_valid, int dh, float scale, int route, cudaStream_t stream) {
    if constexpr (sizeof(T) == 2) {
        if (route != FLASH_WGMMA) return cudaErrorInvalidValue;
        const bool narrow = n_rows <= 64;  // one consumer warpgroup covers the sequence
        if (dh == 64)
            return narrow ? run_flash_wgmma<64, 1>(q, k, v, out, bh, n_rows, n_valid, scale, stream)
                          : run_flash_wgmma<64, FW_CONSUMERS<64>>(q, k, v, out, bh, n_rows,
                                                                  n_valid, scale, stream);
        return narrow ? run_flash_wgmma<128, 1>(q, k, v, out, bh, n_rows, n_valid, scale, stream)
                      : run_flash_wgmma<128, FW_CONSUMERS<128>>(q, k, v, out, bh, n_rows, n_valid,
                                                                scale, stream);
    } else {
        if (route == FLASH_TF32X3) {
            if (dh != 64) return cudaErrorInvalidValue;
            return run_flash_tf32x3(q, k, v, out, bh, n_rows, n_valid, scale, stream);
        }
        if (route != FLASH_FMA) return cudaErrorInvalidValue;
        if (dh == 128)  // 64 queries a block, one block an SM
            return launch(flash_fma_kernel<128, 4, Out>, dim3(bh * ((n_rows + 63) / 64)),
                          FLASH_FMA_SMEM_BYTES<128, 4>, stream, q, k, v, out, n_rows, n_valid,
                          scale);
        // 16·RI queries a block, two blocks an SM. Every block costs the
        // same, so the launch takes as long as its waves of blocks: take the
        // RI with the least waves x (RI + 2), the 2 standing for what a tile
        // costs beside its FMAs. Short sequences end up at 64 queries a block.
        const int slots = 2 * sm_count();
        int ri = 8, best = 0;
        for (int cand : {8, 7, 6, 4}) {
            const int blocks = bh * ((n_rows + 16 * cand - 1) / (16 * cand));
            const int cost = ((blocks + slots - 1) / slots) * (cand + 2);
            if (best == 0 || cost < best) {
                best = cost;
                ri = cand;
            }
        }
        const dim3 grid(bh * ((n_rows + 16 * ri - 1) / (16 * ri)));
        switch (ri) {
            case 8:
                return launch(flash_fma_kernel<64, 8, Out>, grid, FLASH_FMA_SMEM_BYTES<64, 8>,
                              stream, q, k, v, out, n_rows, n_valid, scale);
            case 7:
                return launch(flash_fma_kernel<64, 7, Out>, grid, FLASH_FMA_SMEM_BYTES<64, 7>,
                              stream, q, k, v, out, n_rows, n_valid, scale);
            case 6:
                return launch(flash_fma_kernel<64, 6, Out>, grid, FLASH_FMA_SMEM_BYTES<64, 6>,
                              stream, q, k, v, out, n_rows, n_valid, scale);
            default:
                return launch(flash_fma_kernel<64, 4, Out>, grid, FLASH_FMA_SMEM_BYTES<64, 4>,
                              stream, q, k, v, out, n_rows, n_valid, scale);
        }
    }
}

}  // namespace asep

extern "C" const char* asep_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
