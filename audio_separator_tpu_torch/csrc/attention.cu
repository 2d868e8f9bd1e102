// Whole-sequence attention softmax(q·kᵀ·scale)·v over (B, H, N, D), for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _fused_attention_kernel behind
// audio_separator_tpu/ops/attention.py::_pallas_fused_attention (dispatch
// dot_product_attention), which the HTDemucs cross-transformer's
// self-attention layers run.
//
// What bounds it on the card: the two products. 4·B·H·N²·D operations over
// 4·B·H·N·D elements of q, k, v and o is N operations per element: at the
// HTDemucs shapes (N 1344 and 2688, D 64) hundreds of operations per byte,
// far above the ridge point in both float32 and bf16, so it is
// operation-bound.
//
// Design: the TPU kernel holds a whole (n_pad, n_pad) float32 score tile on
// chip; 2688² floats do not fit 227 KB of shared memory, so this is the tiled
// kernel of tiles.cuh (run_flash): one block per (batch·head, query tile) walks
// key tiles with an online softmax, and no score matrix is ever stored. Scores
// and the softmax are float32; the weights are rounded to v's type before the
// PV product, which accumulates in float32 (the TPU kernel's rounding points,
// except that the online softmax normalises after the PV product, so in bf16
// the weights are rounded unnormalised). The ragged last tile is masked in
// the kernel: rows past N read as zeros, key columns past N get -1e30, and no
// padded copy of q, k or v is made. The caller names the kernel (route, from
// ops/attention.flash_route: the type, N and D decide):
//   * bf16 (flash_wgmma_kernel): 64 queries a consumer warpgroup, three of
//     them a block at D 64 and two at D 128 (one, and two blocks an SM, for
//     sequences of at most 64 rows), and a producer; both products on
//     wgmma, K and V tiles of 128 keys by TMA through a three-dimensional
//     tensor map (so rows past N are zeros, not the next head's rows); scores,
//     weights, output, running maximum and sum in registers; the softmax of a
//     tile runs while the tensor cores work on the previous tile's P·V.
//   * float32, N > 64 at D 64 (flash_tf32x3_kernel; the HTDemucs shapes, N
//     1344 and 2688): both products on wgmma as 3xTF32 (heads and tails of
//     both operands, three TF32 products a term summed in float32: float32
//     accuracy), bound by the TF32 rate over three, 165 TFLOP/s; K and V by
//     TMA, split into heads and tails (V transposed, its keys in the order of
//     the accumulator's columns) by three warps of the producer warpgroup;
//     Q's and P's heads and tails in registers as wgmma's A operand.
//   * float32 otherwise (flash_fma_kernel: N <= 64, D 128): register-blocked
//     FMA with the output, the running maximum and the running sum in
//     registers; only the weights pass through shared memory; K and V have
//     one buffer each, filled by cp.async while the other product runs.
// The head dimension is 64 or 128; the caller zero-pads any other.
#include "tiles.cuh"

namespace asep {

template <typename T>
cudaError_t run_attention(const T* q, const T* k, const T* v, T* o, int bh, int n, int dh,
                          float scale, int route, cudaStream_t stream) {
    return run_flash(q, k, v, HeadMajorOut<T>{o, n, dh}, bh, n, n, dh, scale, route, stream);
}

}  // namespace asep

// dtype: 0 = float32, 1 = bfloat16; route: the kernel (tiles.cuh, FlashRoute).
// q, k, v, o are (bh, n, dh) contiguous and 16-byte aligned, dh is 64 or 128.
// Returns 0 or the first CUDA error.
extern "C" int asep_attention(int dtype, int route, const void* q, const void* k, const void* v,
                              void* o, int bh, int n, int dh, float scale, void* stream) {
    if ((dh != 64 && dh != 128) || bh < 1 || n < 1) return cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto run = [&](auto tag) {
        using T = decltype(tag);
        return asep::run_attention<T>(static_cast<const T*>(q), static_cast<const T*>(k),
                                      static_cast<const T*>(v), static_cast<T*>(o), bh, n, dh,
                                      scale, route, s);
    };
    return dtype == 0 ? run(float{}) : run(asep::bf16{});
}
