"""Precision scopes shared by the port's float32 models.

cuDNN allows TF32 for float32 convolutions by default, and TF32 keeps about
three decimal digits: a float32 model that must match the JAX package's
float32 numerics runs its convolutions and cuBLAS products under
:func:`full_float32`. HTDemucs and TFC-TDF (MDX23C) use it.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_float32():
    """Keep cuDNN convolutions and cuBLAS products of the enclosed float32
    work in full float32, whatever the process-wide TF32 switches say (cuDNN
    allows TF32 by default; it keeps about three decimal digits)."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
