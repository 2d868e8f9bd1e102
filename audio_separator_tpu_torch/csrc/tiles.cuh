// Shared building blocks of the fused RoFormer block kernels (sm_90a).
//
//   * rmsnorm_kernel — xn = x · rsqrt(max(Σx², 1e-24)) · √d · γ, rounded to
//                      the storage type (the TPU kernels' xn), one warp a row;
//   * gemm (run_gemm) — C = A·[B | B2] with a caller-supplied epilogue that
//                      sees whole fp32 output rows in shared memory:
//       - bf16: 128x128 output tiles, mma.sync m16n8k16 on the tensor cores
//               (fp32 accumulate) with ldmatrix operand loads, operand tiles
//               32 deep fed by a ring of three cp.async stages;
//       - float32: 128x128 output tiles of register-blocked FMA, 8x8 per
//               thread (Hopper has no float32 tensor-core mode other than
//               TF32, which is not float32);
//   * load_tile / FmaAcc — a 64x64 float32 tile into shared memory and the
//                      block-level 64x64x64 FMA product on it, used by the
//                      float32 attention kernel;
//   * ldmatrix / mma_16816 — the bf16 tensor-core building blocks of the bf16
//                      GEMM and the bf16 attention kernel;
//   * flash_fma_kernel / flash_mma_kernel — softmax(q·kᵀ·scale, masked)·v over
//                      (batch·head, rows, 64 or 128) operands with an online
//                      softmax over 64-key tiles, float32 (FMA) and bf16
//                      (tensor cores); where the result goes, and what it is
//                      multiplied by on the way, is the caller's Out policy.
//
// The launch entry points (attention_block.cu, ff_block.cu, attention.cu)
// expose a plain C interface so the library builds without PyTorch's headers and loads with
// ctypes; they return cudaGetLastError() after each launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace asep {

constexpr int TILE = 64;
constexpr int THREADS = 256;
// fp32 tiles (accumulators, scores), rows kept 16-byte aligned.
constexpr int ACC_LD = TILE + 4;
// fp32 operand tiles of the FMA products: an odd stride makes the walks down
// a column hit distinct banks.
constexpr int F_LD = TILE + 1;

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

// Eight consecutive elements, as one 16-byte access for bf16 or two for
// float32 (callers keep p 16-byte aligned).
__device__ __forceinline__ void load8(const float* p, float v[8]) {
    load4(p, v);
    load4(p + 4, v + 4);
}

__device__ __forceinline__ void load8(const bf16* p, float v[8]) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
    }
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
// 64x64 tiles for the float32 attention kernel.

// dst[r][c] = src[r * ld + c] for a 64x64 tile; columns >= valid_cols and
// rows >= valid_rows read 0 (and are never dereferenced).
__device__ void load_tile(float* dst, const float* src, int ld, int valid_cols,
                          int valid_rows = TILE) {
    const bool vec = (ld % 4 == 0) && (reinterpret_cast<uintptr_t>(src) % 16 == 0);
    for (int g = threadIdx.x; g < TILE * TILE / 4; g += THREADS) {
        const int r = g / (TILE / 4), c = (g % (TILE / 4)) * 4;
        const float* p = src + (size_t)r * ld + c;
        float v[4];
        if (r >= valid_rows) {
            v[0] = v[1] = v[2] = v[3] = 0.f;
        } else if (vec && c + 4 <= valid_cols) {
            load4(p, v);
        } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) v[i] = (c + i < valid_cols) ? p[i] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) dst[r * F_LD + c + i] = v[i];
    }
}

// 64x64 float32 accumulator: thread (ty = tid / 16, tx = tid % 16) owns rows
// ty*4 .. ty*4+3 and columns tx, tx+16, tx+32, tx+48 of the tile.
struct FmaAcc {
    float c[4][4];

    __device__ void zero() {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
    }

    // C += A·B (TRANS_B: B is stored [n][k], i.e. C += A·Bᵀ of the stored tile).
    template <bool TRANS_B> __device__ void mma(const float* A, const float* B) {
        constexpr int LD = F_LD;
        const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 4
        for (int k = 0; k < TILE; ++k) {
            float a[4], b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = A[(ty * 4 + i) * LD + k];
#pragma unroll
            for (int j = 0; j < 4; ++j)
                b[j] = TRANS_B ? B[(tx + 16 * j) * LD + k] : B[k * LD + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
        }
    }

    __device__ void store(float* C) const {
        const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) C[(ty * 4 + i) * ACC_LD + tx + 16 * j] = c[i][j];
    }

    __device__ void load(const float* C) {
        const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) c[i][j] = C[(ty * 4 + i) * ACC_LD + tx + 16 * j];
    }
};

// ---------------------------------------------------------------------------
// GEMMs. Both compute the output tile of A·[B | B2]: A is (M, K) row-major,
// B is (K, b_cols), the optional B2 (K, b2_cols) supplies columns b_cols ..
// b_cols + b2_cols. A column tile never straddles B and B2 (b_cols is a
// multiple of the tile width). The epilogue is called once per run of eight
// output columns with their fp32 row in shared memory:
// epi(row, c0, count, grow, gcol0) covers row[c0 .. c0 + count), count <= 8,
// which is global row grow, columns gcol0 ...; c0 is a multiple of 8.

struct ColumnSource {
    const void* src;
    int ld, valid;
};

template <typename T>
__device__ ColumnSource column_source(const T* B, int b_cols, const T* B2, int b2_cols,
                                      int col0, int width) {
    if (col0 < b_cols) return {B + col0, b_cols, min(width, b_cols - col0)};
    return {B2 + (col0 - b_cols), b2_cols, min(width, b2_cols - (col0 - b_cols))};
}

// float32: 128x128 output tile; thread (ty, tx) = (tid / 16, tid % 16) owns
// rows {ty*4 .. +3, 64 + ty*4 .. +3} and columns {tx*4 .. +3, 64 + tx*4 .. +3},
// an 8x8 block of FMA accumulators. Operand tiles are 8 deep, A stored
// k-major so a thread reads its eight rows as two float4; the next tile is
// prefetched into registers while the current one is multiplied.
constexpr int F_BM = 128, F_BN = 128, F_BK = 8;
constexpr int F_C_LD = F_BN + 4;

constexpr size_t gemm_fma_smem_bytes() {
    return F_BM * F_C_LD * sizeof(float);  // the epilogue tile; operands need 16 KB
}
static_assert(2 * F_BK * (F_BM + F_BN) * sizeof(float) <= gemm_fma_smem_bytes(),
              "operand stages must fit in the epilogue tile");

template <class Epi>
__global__ void __launch_bounds__(THREADS)
gemm_fma_kernel(const float* __restrict__ A, const float* __restrict__ B, int b_cols,
                const float* __restrict__ B2, int b2_cols, int M, int K, Epi epi) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    float* As = reinterpret_cast<float*>(smem_raw);  // [2][F_BK][F_BM]
    float* Bs = As + 2 * F_BK * F_BM;                 // [2][F_BK][F_BN]
    float* Cs = reinterpret_cast<float*>(smem_raw);  // after the main loop

    const int row0 = blockIdx.x * F_BM, col0 = blockIdx.y * F_BN;
    const ColumnSource bs = column_source(B, b_cols, B2, b2_cols, col0, F_BN);
    const float* bsrc = static_cast<const float*>(bs.src);
    const bool b_vec = (bs.ld % 4 == 0) && (reinterpret_cast<uintptr_t>(bsrc) % 16 == 0);

    const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
    // Each thread moves one float4 of A (row a_r, depth a_k..+3) and one of B
    // (depth b_k, columns b_c..+3) per tile.
    const int a_r = tid / 2, a_k = (tid % 2) * 4;
    const int b_k = tid / 32, b_c = (tid % 32) * 4;
    const float* a_src = A + (size_t)(row0 + a_r) * K + a_k;
    const bool a_ok = row0 + a_r < M;
    float ra[4], rb[4];

    auto fetch = [&](int k0) {
        if (a_ok) {
            const float4 t = *reinterpret_cast<const float4*>(a_src + k0);
            ra[0] = t.x; ra[1] = t.y; ra[2] = t.z; ra[3] = t.w;
        } else {
            ra[0] = ra[1] = ra[2] = ra[3] = 0.f;
        }
        const float* p = bsrc + (size_t)(k0 + b_k) * bs.ld + b_c;
        if (b_vec && b_c + 4 <= bs.valid) {
            const float4 t = *reinterpret_cast<const float4*>(p);
            rb[0] = t.x; rb[1] = t.y; rb[2] = t.z; rb[3] = t.w;
        } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) rb[i] = (b_c + i < bs.valid) ? p[i] : 0.f;
        }
    };
    auto stash = [&](int st) {
        float* as = As + st * F_BK * F_BM;
#pragma unroll
        for (int i = 0; i < 4; ++i) as[(a_k + i) * F_BM + a_r] = ra[i];
        *reinterpret_cast<float4*>(Bs + st * F_BK * F_BN + b_k * F_BN + b_c) =
            make_float4(rb[0], rb[1], rb[2], rb[3]);
    };

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    const int k_steps = K / F_BK;
    fetch(0);
    stash(0);
    __syncthreads();
    for (int kt = 0; kt < k_steps; ++kt) {
        const int st = kt & 1;
        if (kt + 1 < k_steps) fetch((kt + 1) * F_BK);
        const float* as = As + st * F_BK * F_BM;
        const float* bsm = Bs + st * F_BK * F_BN;
#pragma unroll
        for (int k = 0; k < F_BK; ++k) {
            const float4 a0 = *reinterpret_cast<const float4*>(as + k * F_BM + ty * 4);
            const float4 a1 = *reinterpret_cast<const float4*>(as + k * F_BM + 64 + ty * 4);
            const float4 b0 = *reinterpret_cast<const float4*>(bsm + k * F_BN + tx * 4);
            const float4 b1 = *reinterpret_cast<const float4*>(bsm + k * F_BN + 64 + tx * 4);
            const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        // Stage st ^ 1 was last read before the previous barrier.
        if (kt + 1 < k_steps) stash(st ^ 1);
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        float* row = Cs + ((i < 4 ? 0 : 64) + ty * 4 + (i & 3)) * F_C_LD;
        *reinterpret_cast<float4*>(row + tx * 4) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        *reinterpret_cast<float4*>(row + 64 + tx * 4) =
            make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < F_BM * F_BN / 8; idx += THREADS) {
        const int r = idx / (F_BN / 8), c0 = (idx % (F_BN / 8)) * 8;
        const int count = min(8, bs.valid - c0);
        if (row0 + r < M && count > 0) epi(Cs + r * F_C_LD, c0, count, row0 + r, col0 + c0);
    }
}

// bf16: 128x128 output tile; 8 warps in 2 (rows) x 4 (columns), each 64x32;
// operand tiles 32 deep in a ring of W_STAGES cp.async stages, so two loads
// are in flight while one stage is computed.
constexpr int W_BM = 128, W_BN = 128, W_BK = 32, W_STAGES = 3;
constexpr int W_A_LD = W_BK + 8;   // bf16 elements; rows stay 16-byte aligned
constexpr int W_B_LD = W_BN + 8;
constexpr int W_C_LD = W_BN + 4;   // fp32 epilogue rows
constexpr int W_STAGE = W_BM * W_A_LD + W_BK * W_B_LD;  // bf16 elements per stage

constexpr size_t gemm_mma_smem_bytes() {
    return (W_STAGES * W_STAGE * sizeof(bf16) > W_BM * W_C_LD * sizeof(float))
               ? W_STAGES * W_STAGE * sizeof(bf16)
               : W_BM * W_C_LD * sizeof(float);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One stage: A rows row0.. (rows past M zero), B rows k0.. of the column
// source (columns past `valid`, or a misaligned source, take the scalar path).
__device__ __forceinline__ void mma_load_stage(bf16* stage, const bf16* A, int M, int K,
                                                int row0, int k0, const bf16* bsrc, int bld,
                                                int valid, bool b_vec) {
    bf16* As = stage;
    bf16* Bs = stage + W_BM * W_A_LD;
    for (int ch = threadIdx.x; ch < W_BM * W_BK / 8; ch += THREADS) {
        const int r = ch / (W_BK / 8), c = (ch % (W_BK / 8)) * 8;
        bf16* dst = As + r * W_A_LD + c;
        if (row0 + r < M)
            cp_async16(dst, A + (size_t)(row0 + r) * K + k0 + c);
        else
            *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
    for (int ch = threadIdx.x; ch < W_BK * W_BN / 8; ch += THREADS) {
        const int r = ch / (W_BN / 8), c = (ch % (W_BN / 8)) * 8;
        bf16* dst = Bs + r * W_B_LD + c;
        const bf16* src = bsrc + (size_t)(k0 + r) * bld + c;
        if (b_vec && c + 8 <= valid) {
            cp_async16(dst, src);
        } else {
#pragma unroll
            for (int i = 0; i < 8; ++i) dst[i] = (c + i < valid) ? src[i] : __float2bfloat16(0.f);
        }
    }
}

__device__ __forceinline__ void ldmatrix_x4(unsigned r[4], const bf16* p) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned r[4], const bf16* p) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(s));
}

// c += a·b for one m16n8k16 tile: bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_16816(float c[4], const unsigned a[4], const unsigned b[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Warp tile 64x32 = 4 (m16) x 4 (n8) mma tiles. ldmatrix.x4 hands each lane
// its A fragment (rows lane/4 and +8, k pairs (lane%4)*2 and +8) straight
// from the row-major tile; .trans does the same for B stored [k][n].
template <class Epi>
__global__ void __launch_bounds__(THREADS)
gemm_mma_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B, int b_cols,
                const bf16* __restrict__ B2, int b2_cols, int M, int K, Epi epi) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    bf16* stages = reinterpret_cast<bf16*>(smem_raw);
    float* Cs = reinterpret_cast<float*>(smem_raw);  // after the main loop

    const int row0 = blockIdx.x * W_BM, col0 = blockIdx.y * W_BN;
    const ColumnSource bs = column_source(B, b_cols, B2, b2_cols, col0, W_BN);
    const bf16* bsrc = static_cast<const bf16*>(bs.src);
    const bool b_vec = (bs.ld % 8 == 0) && (reinterpret_cast<uintptr_t>(bsrc) % 16 == 0);

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
    float acc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    const int k_steps = K / W_BK;
#pragma unroll
    for (int s = 0; s < W_STAGES - 1; ++s) {
        if (s < k_steps)
            mma_load_stage(stages + s * W_STAGE, A, M, K, row0, s * W_BK, bsrc, bs.ld,
                            bs.valid, b_vec);
        cp_async_commit();
    }
    for (int kt = 0; kt < k_steps; ++kt) {
        // Stage kt has landed once at most W_STAGES - 2 groups are pending;
        // the barrier also tells every thread that stage kt - 1 is consumed,
        // so its buffer can take step kt + W_STAGES - 1.
        cp_async_wait<W_STAGES - 2>();
        __syncthreads();
        const int next = kt + W_STAGES - 1;
        if (next < k_steps)
            mma_load_stage(stages + (next % W_STAGES) * W_STAGE, A, M, K, row0, next * W_BK,
                            bsrc, bs.ld, bs.valid, b_vec);
        cp_async_commit();
        const bf16* As = stages + (kt % W_STAGES) * W_STAGE;
        const bf16* Bs = As + W_BM * W_A_LD;
#pragma unroll
        for (int kk = 0; kk < W_BK; kk += 16) {
            unsigned a[4][4], b[4][2];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                ldmatrix_x4(a[i], As + (wm + 16 * i + lane % 16) * W_A_LD + kk + (lane / 16) * 8);
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
                unsigned t[4];
                ldmatrix_x4_trans(t, Bs + (kk + lane % 8 + ((lane / 8) % 2) * 8) * W_B_LD + wn +
                                         16 * jj + (lane / 16) * 8);
                b[2 * jj][0] = t[0];
                b[2 * jj][1] = t[1];
                b[2 * jj + 1][0] = t[2];
                b[2 * jj + 1][1] = t[3];
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) mma_16816(acc[i][j], a[i], b[j]);
        }
    }
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int r = wm + 16 * i + lane / 4, c = wn + 8 * j + (lane % 4) * 2;
            *reinterpret_cast<float2*>(Cs + r * W_C_LD + c) = make_float2(acc[i][j][0], acc[i][j][1]);
            *reinterpret_cast<float2*>(Cs + (r + 8) * W_C_LD + c) =
                make_float2(acc[i][j][2], acc[i][j][3]);
        }
    __syncthreads();
    for (int idx = threadIdx.x; idx < W_BM * W_BN / 8; idx += THREADS) {
        const int r = idx / (W_BN / 8), c0 = (idx % (W_BN / 8)) * 8;
        const int count = min(8, bs.valid - c0);
        if (row0 + r < M && count > 0) epi(Cs + r * W_C_LD, c0, count, row0 + r, col0 + c0);
    }
}

// ---------------------------------------------------------------------------
// Flash-style attention: o = softmax(q·kᵀ·scale, key columns >= n_valid
// masked to -1e30)·v for each (batch, head). q, k, v are (batch·heads, n_rows,
// DH) contiguous, DH = 64 or 128. One block takes 64 queries of one (batch,
// head) and walks 64-key tiles with an online softmax, so no (n, n) score
// matrix is stored. Key tiles wholly past n_valid are skipped; rows past
// n_rows (the ragged last tile) are read as zeros and never written.
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

template <int HALVES> constexpr size_t flash_fma_smem_bytes() {
    // Q, K, V operand tiles per 64-wide half, P; the S tile and one O tile per
    // half in fp32; running max and sum.
    return (3 * HALVES + 1) * TILE * F_LD * sizeof(float) +
           (1 + HALVES) * TILE * ACC_LD * sizeof(float) + 2 * TILE * sizeof(float);
}

// float32. blockIdx.x = (batch * heads + head) * q_tiles + q_tile. The head
// dimension is HALVES 64-wide halves: S sums the halves' products, O keeps one
// accumulator tile per half.
template <int HALVES, class Out>
__global__ void __launch_bounds__(THREADS)
flash_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, Out out, int n_rows, int n_valid, float scale) {
    constexpr int LD = F_LD, DH = TILE * HALVES;
    extern __shared__ __align__(128) unsigned char smem_raw[];
    float* Qs = reinterpret_cast<float*>(smem_raw);
    float* Ks = Qs + HALVES * TILE * LD;
    float* Vs = Ks + HALVES * TILE * LD;
    float* Ps = Vs + HALVES * TILE * LD;
    float* Ss = Ps + TILE * LD;
    float* Os = Ss + TILE * ACC_LD;
    float* m_s = Os + HALVES * TILE * ACC_LD;
    float* l_s = m_s + TILE;

    const int q_tiles = (n_rows + TILE - 1) / TILE;
    const int qt = blockIdx.x % q_tiles;
    const int bh = blockIdx.x / q_tiles;  // batch * heads + head
    const size_t base = (size_t)bh * n_rows * DH;

#pragma unroll
    for (int h = 0; h < HALVES; ++h)
        load_tile(Qs + h * TILE * LD, q + base + (size_t)qt * TILE * DH + h * TILE, DH, TILE,
                  n_rows - qt * TILE);
    for (int i = threadIdx.x; i < HALVES * TILE * ACC_LD; i += THREADS) Os[i] = 0.f;
    if (threadIdx.x < TILE) {
        m_s[threadIdx.x] = -INFINITY;
        l_s[threadIdx.x] = 0.f;
    }

    // Softmax work split: 4 threads per query row, columns sub, sub+4, ...
    const int r = threadIdx.x >> 2, sub = threadIdx.x & 3;
    const int key_tiles = (n_valid + TILE - 1) / TILE;
    for (int kt = 0; kt < key_tiles; ++kt) {
        __syncthreads();
#pragma unroll
        for (int h = 0; h < HALVES; ++h) {
            const size_t off = base + (size_t)kt * TILE * DH + h * TILE;
            load_tile(Ks + h * TILE * LD, k + off, DH, TILE, n_rows - kt * TILE);
            load_tile(Vs + h * TILE * LD, v + off, DH, TILE, n_rows - kt * TILE);
        }
        __syncthreads();
        {
            FmaAcc s;
            s.zero();
#pragma unroll
            for (int h = 0; h < HALVES; ++h) s.mma<true>(Qs + h * TILE * LD, Ks + h * TILE * LD);
            s.store(Ss);
        }
        __syncthreads();

        const float m_old = m_s[r];
        float sv[16];
        float mx = -INFINITY;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
            const int c = sub + 4 * i;
            float val = Ss[r * ACC_LD + c] * scale;
            if (kt * TILE + c >= n_valid) val = -1e30f;
            sv[i] = val;
            mx = fmaxf(mx, val);
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_old, mx);
        const float alpha = expf(m_old - m_new);
        float lsum = 0.f;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
            const int c = sub + 4 * i;
            const float p = expf(sv[i] - m_new);
            lsum += p;
            Ps[r * LD + c] = p;
#pragma unroll
            for (int h = 0; h < HALVES; ++h) Os[h * TILE * ACC_LD + r * ACC_LD + c] *= alpha;
        }
        lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
        lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
        if (sub == 0) {
            m_s[r] = m_new;
            l_s[r] = l_s[r] * alpha + lsum;
        }
        __syncthreads();
#pragma unroll
        for (int h = 0; h < HALVES; ++h) {
            FmaAcc o;
            o.load(Os + h * TILE * ACC_LD);
            o.mma<false>(Ps, Vs + h * TILE * LD);
            o.store(Os + h * TILE * ACC_LD);
        }
    }
    __syncthreads();

    for (int idx = threadIdx.x; idx < TILE * DH; idx += THREADS) {
        const int rr = idx / DH, j = idx % DH;
        const int n = qt * TILE + rr;
        if (n < n_rows)
            out.row(bh, n)[j] =
                Os[(j / TILE) * TILE * ACC_LD + rr * ACC_LD + j % TILE] / l_s[rr] * out.gain(bh, n);
    }
}

// bf16 attention with scores and output in registers (FlashAttention-2
// style). A block of 4 warps takes 64 queries of one (batch, head); warp w
// owns query rows 16w .. 16w+15. Per 64-key tile: S = Q·Kᵀ by mma.sync
// (K rows read untransposed by ldmatrix are Kᵀ's column fragments), an online
// softmax on the accumulators (a row lives in the 4 lanes sharing lane/4),
// P = exp(S - m) rounded to bf16 straight into A fragments, O += P·V (V read
// with ldmatrix.trans). K and V tiles are double-buffered with cp.async.
constexpr int FA_WARPS = 4;

// Shared-memory rows are DH + FA_PAD bf16 elements: 16-byte aligned rows
// whose ldmatrix reads are conflict-free (144 and 272 bytes).
constexpr int FA_PAD = 8;

template <int DH> constexpr size_t flash_mma_smem_bytes() {
    return 5 * TILE * (DH + FA_PAD) * sizeof(bf16);
}

// 64 rows of DH from src (row stride DH); rows >= valid_rows become zeros.
template <int DH>
__device__ __forceinline__ void fa_load_tile(bf16* dst, const bf16* src, int valid_rows) {
    constexpr int CH = DH / 8, LD = DH + FA_PAD;
    for (int ch = threadIdx.x; ch < TILE * CH; ch += FA_WARPS * 32) {
        const int r = ch / CH, c = (ch % CH) * 8;
        bf16* d = dst + r * LD + c;
        if (r < valid_rows)
            cp_async16(d, src + (size_t)r * DH + c);
        else
            *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    }
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&h);
}

template <int DH, class Out>
__global__ void __launch_bounds__(FA_WARPS * 32)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, Out out, int n_rows, int n_valid, float scale) {
    constexpr int LD = DH + FA_PAD;
    constexpr int KC = DH / 16;  // 16-deep chunks of the head dimension
    constexpr int OT = DH / 8;   // 8-wide output tiles
    extern __shared__ __align__(128) unsigned char smem_raw[];
    bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
    bf16* Ks = Qs + TILE * LD;      // two stages
    bf16* Vs = Ks + 2 * TILE * LD;  // two stages

    const int q_tiles = (n_rows + TILE - 1) / TILE;
    const int qt = blockIdx.x % q_tiles;
    const int bh = blockIdx.x / q_tiles;
    const size_t base = (size_t)bh * n_rows * DH;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int key_tiles = (n_valid + TILE - 1) / TILE;

    fa_load_tile<DH>(Qs, q + base + (size_t)qt * TILE * DH, n_rows - qt * TILE);
    fa_load_tile<DH>(Ks, k + base, n_rows);
    fa_load_tile<DH>(Vs, v + base, n_rows);
    cp_async_commit();

    unsigned qa[KC][4];  // Q fragments, KC chunks of 16 dims
    float o[OT][4];      // O: OT tiles of 8 dims; [0..1] row lane/4, [2..3] row +8
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < OT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

    for (int kt = 0; kt < key_tiles; ++kt) {
        const int st = kt & 1;
        if (kt + 1 < key_tiles) {
            const size_t off = base + (size_t)(kt + 1) * TILE * DH;
            fa_load_tile<DH>(Ks + (st ^ 1) * TILE * LD, k + off, n_rows - (kt + 1) * TILE);
            fa_load_tile<DH>(Vs + (st ^ 1) * TILE * LD, v + off, n_rows - (kt + 1) * TILE);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        if (kt == 0) {
#pragma unroll
            for (int kc = 0; kc < KC; ++kc)
                ldmatrix_x4(qa[kc], Qs + (warp * 16 + lane % 16) * LD + kc * 16 + (lane / 16) * 8);
        }
        const bf16* Kt = Ks + st * TILE * LD;
        const bf16* Vt = Vs + st * TILE * LD;

        float s[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
        for (int kc = 0; kc < KC; ++kc)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
                unsigned t[4];
                ldmatrix_x4(t, Kt + (jj * 16 + lane % 8 + (lane / 16) * 8) * LD + kc * 16 +
                                   ((lane / 8) % 2) * 8);
                const unsigned b0[2] = {t[0], t[1]}, b1[2] = {t[2], t[3]};
                mma_16816(s[2 * jj], qa[kc], b0);
                mma_16816(s[2 * jj + 1], qa[kc], b1);
            }

        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int key = kt * TILE + 8 * j + (lane % 4) * 2 + (e & 1);
                s[j][e] = key < n_valid ? s[j][e] * scale : -1e30f;
                mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
            }
        float alpha[2], lsum[2] = {0.f, 0.f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
            mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
            const float m_new = fmaxf(m_run[h], mx[h]);
            alpha[h] = expf(m_run[h] - m_new);
            m_run[h] = m_new;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                s[j][e] = expf(s[j][e] - m_run[e / 2]);
                lsum[e / 2] += s[j][e];
            }
#pragma unroll
        for (int j = 0; j < OT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e / 2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            lsum[h] += __shfl_xor_sync(0xffffffffu, lsum[h], 1);
            lsum[h] += __shfl_xor_sync(0xffffffffu, lsum[h], 2);
            l_run[h] = l_run[h] * alpha[h] + lsum[h];
        }

#pragma unroll
        for (int kc = 0; kc < 4; ++kc) {  // 16-key chunks of the tile
            const unsigned pa[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                                    pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                                    pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                                    pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
            for (int jj = 0; jj < OT / 2; ++jj) {
                unsigned t[4];
                ldmatrix_x4_trans(t, Vt + (kc * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD +
                                         jj * 16 + (lane / 16) * 8);
                const unsigned b0[2] = {t[0], t[1]}, b1[2] = {t[2], t[3]};
                mma_16816(o[2 * jj], pa, b0);
                mma_16816(o[2 * jj + 1], pa, b1);
            }
        }
        __syncthreads();
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int n = qt * TILE + warp * 16 + lane / 4 + 8 * h;
        if (n >= n_rows) continue;
        const float f = out.gain(bh, n) / l_run[h];
        bf16* dst = out.row(bh, n) + (lane % 4) * 2;
#pragma unroll
        for (int j = 0; j < OT; ++j)
            *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
                __floats2bfloat162_rn(o[j][2 * h] * f, o[j][2 * h + 1] * f);
    }
}

// out = x + round(C + bias): the residual epilogue of the output projection
// (bias == nullptr) and of the feed-forward's second product.
// Output column tiles are multiples of 8 wide here (d_model % 64 == 0), so
// every call covers a full run of eight.
template <typename T> struct ResidualEpi {
    const T* x;
    const T* bias;
    T* out;
    int cols;
    __device__ void operator()(const float* row, int c0, int, int grow, int gcol0) const {
        const size_t i = (size_t)grow * cols + gcol0;
        float xv[8], y[8];
        load8(x + i, xv);
#pragma unroll
        for (int e = 0; e < 8; ++e)
            y[e] = xv[e] + rnd<T>(row[c0 + e] + (bias != nullptr ? to_f(bias[gcol0 + e]) : 0.f));
        store8(out + i, y);
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

// C = A·[B | B2] through the epilogue; M rows, K deep (K % 64 == 0).
template <typename T, class Epi>
cudaError_t run_gemm(const T* A, const T* B, int b_cols, const T* B2, int b2_cols, int M, int K,
                     Epi epi, cudaStream_t stream) {
    const int cols = b_cols + b2_cols;
    if constexpr (sizeof(T) == 2) {
        return launch(gemm_mma_kernel<Epi>,
                      dim3((M + W_BM - 1) / W_BM, (cols + W_BN - 1) / W_BN),
                      gemm_mma_smem_bytes(), stream, A, B, b_cols, B2, b2_cols, M, K, epi);
    } else {
        return launch(gemm_fma_kernel<Epi>, dim3((M + F_BM - 1) / F_BM, (cols + F_BN - 1) / F_BN),
                      gemm_fma_smem_bytes(), stream, A, B, b_cols, B2, b2_cols, M, K, epi);
    }
}

}  // namespace asep

extern "C" const char* asep_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
