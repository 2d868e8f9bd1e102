"""Published dense peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, no
sparsity), at its full 700 W power limit."""

TF32_FLOPS = 495e12     # the highest rate at which it multiplies float32 inputs
BF16_FLOPS = 989e12
FP32_FMA_FLOPS = 67e12
HBM_BYTES = 3.35e12


def matmul_peak(itemsize: int) -> float:
    """The product peak for inputs of ``itemsize`` bytes: TF32 for float32
    (so no float32 method can read over 100 %), bf16 for two-byte types."""
    return TF32_FLOPS if itemsize >= 4 else BF16_FLOPS


def bound_s(ops: float, nbytes: float, itemsize: int) -> float:
    """The least time: operations at the peak or bytes at the memory rate."""
    return max(ops / matmul_peak(itemsize), nbytes / HBM_BYTES)
