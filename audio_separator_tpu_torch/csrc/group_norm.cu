// GroupNorm with the elementwise step that follows it (GN), for Hopper
// (sm_90a), float32:
//   y = (x − mean_g)·rstd_g·γ_c + β_c,   rstd_g = 1/√(var_g + eps),
// var the biased variance over one sample's group g of channels, then the
// epilogue: none; GELU (erf form, as nn.GELU()); or GLU over the channel
// halves, y_c·σ(y_{c+C/2}), times a per-channel scale (LayerScale) plus a
// residual: the tail of Demucs's DConv, so that x + layer(x) is one pass.
// Channel-first (N, C, L) inputs, a group C/G whole channels (contiguous),
// or channel-last (N, T, C) with one group (the cross-transformer's output
// norm, read and written in its own layout).
//
// New, with no TPU kernel behind it: the JAX package leaves GroupNorm to XLA
// (audio_separator_tpu/models/htdemucs.py). models/htdemucs.py runs every
// GroupNorm of HTDemucs and HDemucs through it in inference.
//
// What bounds it on the card: bytes. PyTorch's GroupNorm gives each (sample,
// group) row one block for its statistics; HTDemucs's time branch and
// transformer have 4 rows of 0.7–8.3 M elements, so 4 blocks walk them while
// 128 SMs idle. Design, two launches:
//  1. moments: each row cut into `splits` chunks (the wrapper picks them from
//     the rows, their length and the SM count: tens of blocks a row when rows
//     are few, one when they are many); a block a chunk reads 16-byte vectors
//     (a scalar head and tail where the chunk's ends are not 16-byte
//     aligned: rows of 85 995 elements), each thread keeps (count, mean, M2),
//     merging a vector of four at a time by Chan's formula, and the block
//     merges its threads in a fixed tree into one partial;
//  2. apply: a block a piece of one sample's output merges that sample's
//     partials in a fixed order (every block of the sample the same order,
//     so the same statistics), folds them with γ and β into y = a_c·x + b_c
//     in shared memory, and writes its piece in 16-byte vectors with the
//     epilogue in registers.
// No atomics: two calls give the same bits.
#include "bwd_common.cuh"

namespace asep {
namespace gn {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_GROUPS = 64;
enum Epilogue { NONE = 0, GELU = 1, GLU = 2 };

// One partial's moments: count, mean and the sum of squared deviations.
struct Moments {
    float mean, m2;
    int n, pad;
};

// Chan et al.'s merge of (nb, mb, m2b) into (n, mean, m2).
__device__ __forceinline__ void chan(int& n, float& mean, float& m2, int nb, float mb,
                                     float m2b) {
    if (nb == 0) return;
    const int nn = n + nb;
    const float wb = (float)nb / (float)nn;
    const float d = mb - mean;
    mean = fmaf(d, wb, mean);
    m2 += m2b + d * d * (float)n * wb;
    n = nn;
}

__device__ __forceinline__ void add4(int& n, float& mean, float& m2, float4 v) {
    const float m = 0.25f * ((v.x + v.y) + (v.z + v.w));
    const float a = v.x - m, b = v.y - m, c = v.z - m, d = v.w - m;
    chan(n, mean, m2, 4, m, (a * a + b * b) + (c * c + d * d));
}

// A fixed tree over the warp: lane 0 ends with the warp's moments.
__device__ __forceinline__ void warp_chan(int& n, float& mean, float& m2) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const int nb = __shfl_down_sync(0xffffffffu, n, off);
        const float mb = __shfl_down_sync(0xffffffffu, mean, off);
        const float m2b = __shfl_down_sync(0xffffffffu, m2, off);
        chan(n, mean, m2, nb, mb, m2b);
    }
}

// Block b: row b / splits, its chunk b % splits of `chunk` elements (a
// multiple of 4; the last may be shorter). Writes part[b].
__global__ void __launch_bounds__(THREADS)
    moments_kernel(const float* __restrict__ x, Moments* __restrict__ part, long long row_len,
                   int splits, long long chunk) {
    const long long row = blockIdx.x / splits;
    const long long start = row * row_len + (blockIdx.x - row * splits) * chunk;
    const long long end = min(start + chunk, (row + 1) * row_len);
    const long long v0 = min((start + 3) & ~3LL, end);  // first 16-byte aligned element
    const long long v1 = v0 + ((end - v0) & ~3LL);
    const int t = threadIdx.x;
    int n = 0;
    float mean = 0.f, m2 = 0.f;
    if (t < v0 - start) chan(n, mean, m2, 1, x[start + t], 0.f);
    if (t < end - v1) chan(n, mean, m2, 1, x[v1 + t], 0.f);
    const float4* v = reinterpret_cast<const float4*>(x + v0);
    const long long nv = (v1 - v0) >> 2;
    long long i = t;
    for (; i + 3 * THREADS < nv; i += 4 * THREADS) {
        float4 q[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) q[u] = __ldg(v + i + u * THREADS);
#pragma unroll
        for (int u = 0; u < 4; ++u) add4(n, mean, m2, q[u]);
    }
    for (; i < nv; i += THREADS) add4(n, mean, m2, __ldg(v + i));

    __shared__ Moments warps[WARPS];
    warp_chan(n, mean, m2);
    if ((t & 31) == 0) warps[t >> 5] = Moments{mean, m2, n, 0};
    __syncthreads();
    if (t == 0) {
        Moments m = warps[0];
        for (int w = 1; w < WARPS; ++w)
            chan(m.n, m.mean, m.m2, warps[w].n, warps[w].mean, warps[w].m2);
        part[blockIdx.x] = m;
    }
}

__device__ __forceinline__ float gelu(float y) {
    return 0.5f * y * (1.f + erff(y * 0.7071067811865476f));
}

// One output value from the raw inputs: xa at channel c, xb at c + c_out
// (GLU's gate, c_out = C/2), r the residual.
template <int EPI>
__device__ __forceinline__ float finish(float xa, float xb, float r, int c, int c_out,
                                        const float* sa, const float* sb, const float* ss,
                                        bool scaled, bool residual) {
    const float y = fmaf(xa, sa[c], sb[c]);
    if (EPI == NONE) return y;
    if (EPI == GELU) return gelu(y);
    const float gate = fmaf(xb, sa[c + c_out], sb[c + c_out]);
    float out = y * (1.f / (1.f + expf(-gate)));
    if (scaled) out *= ss[c];
    return residual ? r + out : out;
}

// Block b: sample b / pieces, its piece b % pieces of `piece` output
// elements (a multiple of 4; the last may be shorter). A sample holds
// C·L input and C_out·L output elements (C_out = C/2 under GLU); channel-
// last samples are (T = L, C).
template <int EPI, bool CL>
__global__ void __launch_bounds__(THREADS)
    apply_kernel(const float* __restrict__ x, const Moments* __restrict__ part,
                 const float* __restrict__ gamma, const float* __restrict__ beta,
                 const float* __restrict__ scale, const float* __restrict__ res,
                 float* __restrict__ out, int C, int G, int L, int splits, int pieces,
                 int piece, float eps) {
    extern __shared__ float smem[];  // a[C], b[C], then scale[C/2] under GLU
    __shared__ float s_mean[MAX_GROUPS], s_rstd[MAX_GROUPS];
    const int sample = blockIdx.x / pieces;
    const int t = threadIdx.x, lane = t & 31;
    for (int g = t >> 5; g < G; g += WARPS) {
        const Moments* p = part + ((long long)sample * G + g) * splits;
        int n = 0;
        float mean = 0.f, m2 = 0.f;
        for (int j = lane; j < splits; j += 32) chan(n, mean, m2, p[j].n, p[j].mean, p[j].m2);
        warp_chan(n, mean, m2);
        if (lane == 0) {
            s_mean[g] = mean;
            s_rstd[g] = 1.f / sqrtf(fmaxf(m2 / (float)n, 0.f) + eps);
        }
    }
    __syncthreads();
    float* sa = smem;
    float* sb = smem + C;
    float* ss = smem + 2 * C;
    const int per_group = C / G;
    for (int c = t; c < C; c += THREADS) {
        const int g = c / per_group;
        const float a = s_rstd[g] * (gamma ? gamma[c] : 1.f);
        sa[c] = a;
        sb[c] = fmaf(-s_mean[g], a, beta ? beta[c] : 0.f);
    }
    const bool scaled = EPI == GLU && scale != nullptr, residual = EPI == GLU && res != nullptr;
    if (scaled)
        for (int c = t; c < C / 2; c += THREADS) ss[c] = scale[c];
    __syncthreads();

    const int c_out = EPI == GLU ? C / 2 : C;
    const int out_len = c_out * L;  // also the gate half's offset under GLU
    const float* xs = x + (long long)sample * C * L;
    float* os = out + (long long)sample * out_len;
    const float* rs = residual ? res + (long long)sample * out_len : nullptr;
    const int lo = (blockIdx.x - sample * pieces) * piece;
    const int hi = min(lo + piece, out_len);
    // Output element i lies at os + i; 16-byte vectors where the flat index is.
    const int skew = (int)(((long long)sample * out_len + lo) & 3);
    const int i0 = min(lo + ((4 - skew) & 3), hi);
    const int i1 = i0 + ((hi - i0) & ~3);
    // Under GLU the inputs of output i lie at xs + i and xs + out_len + i:
    // aligned with the output when a sample's output is a multiple of 4.
    const bool vec_in = EPI != GLU || (out_len & 3) == 0;

    auto channel = [&](int i) { return CL ? (int)((unsigned)i % (unsigned)C)
                                          : (int)((unsigned)i / (unsigned)L); };
    auto one = [&](int i) {
        const int c = channel(i);
        const float xb = EPI == GLU ? xs[out_len + i] : 0.f;
        os[i] = finish<EPI>(xs[i], xb, residual ? rs[i] : 0.f, c, c_out, sa, sb, ss, scaled,
                            residual);
    };
    if (t < i0 - lo) one(lo + t);
    if (t < hi - i1) one(i1 + t);
    for (int i = i0 + 4 * t; i < i1; i += 4 * THREADS) {
        float xa[4], xb[4] = {0.f, 0.f, 0.f, 0.f}, r[4] = {0.f, 0.f, 0.f, 0.f}, y[4];
        if (vec_in) {
            load_f32<4>(xs + i, xa);
            if (EPI == GLU) load_f32<4>(xs + out_len + i, xb);
        } else if (EPI == GLU) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                xa[j] = xs[i + j];
                xb[j] = xs[out_len + i + j];
            }
        }
        if (residual) load_f32<4>(rs + i, r);
        int c = channel(i), l = CL ? 0 : i - c * L;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            y[j] = finish<EPI>(xa[j], xb[j], r[j], c, c_out, sa, sb, ss, scaled, residual);
            if (CL) {
                if (++c == C) c = 0;
            } else if (++l == L) {
                l = 0;
                ++c;
            }
        }
        *reinterpret_cast<float4*>(os + i) = make_float4(y[0], y[1], y[2], y[3]);
    }
}

template <int EPI, bool CL>
cudaError_t run_apply(int samples, int pieces, const float* x, const Moments* part,
                      const float* gamma, const float* beta, const float* scale,
                      const float* res, float* out, int C, int G, int L, int splits,
                      int piece, float eps, cudaStream_t stream) {
    const size_t smem = (size_t)(2 * C + (EPI == GLU ? C / 2 : 0)) * sizeof(float);
    return launch_bwd(apply_kernel<EPI, CL>, dim3((unsigned)samples * pieces), THREADS, smem,
                      stream, x, part, gamma, beta, scale, res, out, C, G, L, splits, pieces,
                      piece, eps);
}

}  // namespace gn
}  // namespace asep

// x (samples, channels, length) channel-first, or (samples, length,
// channels) with channel_last (then groups 1 and no GLU); out (samples,
// channels / 2 under GLU, length), or x's shape; gamma, beta (channels) or
// null; scale (channels / 2) or null and residual (out's shape) or null,
// under GLU only; partials 16 bytes a (row, split), rows = samples · groups.
// All float32, contiguous, 16-byte aligned; channels · length < 2^31.
// epilogue: 0 none, 1 GELU, 2 GLU·scale + residual. Each row's moments come
// from `splits` blocks of `chunk` elements (a multiple of 4), each sample's
// output from `pieces` blocks of `piece` elements (a multiple of 4).
// Returns 0 or the first CUDA error.
extern "C" int asep_group_norm(const void* x, const void* gamma, const void* beta,
                               const void* scale, const void* residual, void* out,
                               void* partials, int samples, int channels, int groups,
                               int length, int channel_last, int epilogue, int splits,
                               long long chunk, int pieces, int piece, float eps,
                               void* stream) {
    using namespace asep::gn;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (samples < 1 || channels < 1 || length < 1 || groups < 1 || groups > MAX_GROUPS ||
        channels % groups || splits < 1 || pieces < 1 || chunk < 4 || chunk % 4 ||
        piece < 4 || piece % 4 || epilogue < NONE || epilogue > GLU ||
        (epilogue == GLU && channels % 2) ||
        (channel_last && (groups != 1 || epilogue == GLU)) ||
        (long long)channels * length >= (1LL << 31) - 4096)
        return cudaErrorInvalidValue;
    const long long row_len = (long long)(channels / groups) * length;
    const long long blocks = (long long)samples * groups * splits;
    if (blocks >= (1LL << 31) || (long long)samples * pieces >= (1LL << 31))
        return cudaErrorInvalidValue;
    auto* part = static_cast<Moments*>(partials);
    const auto* xf = static_cast<const float*>(x);
    const cudaError_t err = asep::launch_bwd(moments_kernel, dim3((unsigned)blocks), THREADS, 0,
                                             s, xf, part, row_len, splits, chunk);
    if (err != cudaSuccess) return err;
    const auto* g = static_cast<const float*>(gamma);
    const auto* b = static_cast<const float*>(beta);
    const auto* sc = static_cast<const float*>(scale);
    const auto* r = static_cast<const float*>(residual);
    auto* o = static_cast<float*>(out);
    if (channel_last)
        return epilogue == GELU
                   ? run_apply<GELU, true>(samples, pieces, xf, part, g, b, sc, r, o, channels,
                                           groups, length, splits, piece, eps, s)
                   : run_apply<NONE, true>(samples, pieces, xf, part, g, b, sc, r, o, channels,
                                           groups, length, splits, piece, eps, s);
    if (epilogue == GLU)
        return run_apply<GLU, false>(samples, pieces, xf, part, g, b, sc, r, o, channels, groups,
                                     length, splits, piece, eps, s);
    if (epilogue == GELU)
        return run_apply<GELU, false>(samples, pieces, xf, part, g, b, sc, r, o, channels,
                                      groups, length, splits, piece, eps, s);
    return run_apply<NONE, false>(samples, pieces, xf, part, g, b, sc, r, o, channels, groups,
                                  length, splits, piece, eps, s);
}
