// Shared helpers of the backward kernels (attention_bwd.cu, norm_bwd.cu,
// gelu_bwd.cu, rope_gate_bwd.cu): float32 only, each library its own small
// source that builds in seconds. Besides plain CUDA they use PTX that sm_80
// introduced and sm_90a keeps: cp.async (below) and, in attention_bwd.cu,
// the TF32 tensor-core product mma.sync.m16n8k8; attention_bwd.cu also uses
// Hopper's wgmma (TF32, its descriptors and fences from hopper.cuh), but no
// TMA and no mbarrier.
//
// Each library exposes a plain C interface (loaded with ctypes, see
// ops/_build.py) whose entry points return cudaGetLastError() after each
// launch, and asep_error_string for the wrapper's message.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace asep {

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
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool in) {
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
