// Shared helpers of the backward kernels (attention_bwd.cu, norm_bwd.cu,
// gelu_bwd.cu, rope_gate_bwd.cu): float32 only, plain CUDA (no Hopper-only
// PTX), so each library builds in seconds.
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
