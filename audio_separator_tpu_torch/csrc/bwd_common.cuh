// Shared helpers of the backward kernels (attention_bwd.cu, norm_bwd.cu,
// gelu_bwd.cu, rope_gate_bwd.cu), each library its own small source that
// builds in seconds, each kernel in a float32 and a bf16 form. Besides plain
// CUDA they use PTX that sm_80 introduced and sm_90a keeps: cp.async (below)
// and, in attention_bwd.cu, the tensor-core products mma.sync.m16n8k8 (TF32)
// and m16n8k16 (bf16) and ldmatrix; attention_bwd.cu also uses Hopper's wgmma
// (TF32 and bf16, its descriptors and fences from hopper.cuh) and, in its bf16
// form, TMA tensor maps, mbarriers and setmaxnreg.
//
// group_norm.cu (Demucs's GroupNorm, a forward kernel) uses the vector loads
// and the launcher too.
//
// Each library exposes a plain C interface (loaded with ctypes, see
// ops/_build.py) whose entry points return cudaGetLastError() after each
// launch, and asep_error_string for the wrapper's message.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace asep {

using bf16 = __nv_bfloat16;

// 16 bytes of T (4 float32 or 8 bf16 values) to and from floats; p is
// 16-byte aligned.
template <typename T> constexpr int VEC = 16 / (int)sizeof(T);

__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
}
__device__ __forceinline__ void load_vec(const bf16* p, float (&v)[8]) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
        v[2 * i] = f.x, v[2 * i + 1] = f.y;
    }
}
__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ void store_vec(bf16* p, const float (&v)[8]) {
    *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                                              pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
}
// V float32 values (V a multiple of 4) from 16-byte aligned p.
template <int V> __device__ __forceinline__ void load_f32(const float* p, float (&v)[V]) {
#pragma unroll
    for (int j = 0; j < V; j += 4) {
        const float4 a = *reinterpret_cast<const float4*>(p + j);
        v[j] = a.x, v[j + 1] = a.y, v[j + 2] = a.z, v[j + 3] = a.w;
    }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
    return v;
}

// 2^x on the special-function unit (two units in the last place); -inf
// gives 0.
__device__ __forceinline__ float exp2_approx(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// cp.async: 16 or 4 bytes from device to shared memory without registers;
// with in = false nothing is read and the bytes are zeros. A thread's copies
// land once it has waited for their commit group, and are seen by the other
// threads after a __syncthreads().
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                 "l"(src), "r"(in ? 16 : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                 "l"(src), "r"(in ? 4 : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's commit groups are still in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename Kernel, typename... Args>
cudaError_t launch_bwd(Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t stream,
                       Args... args) {
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    kernel<<<grid, threads, smem, stream>>>(args...);
    return cudaGetLastError();
}

}  // namespace asep

extern "C" const char* asep_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
