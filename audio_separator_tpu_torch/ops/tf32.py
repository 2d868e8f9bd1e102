"""float32 products on the tensor cores as a 3xTF32 split: the plain
versions of what the CUDA GEMM (``csrc/gemm_tf32.cuh``) does.

Hopper's tensor cores have no float32 mode. TF32 keeps 10 explicit mantissa
bits, so one TF32 product is not a float32 product. Splitting each operand
into a TF32 head and a TF32 tail,

    x = hi + lo + e,   hi = tf32(x),   lo = tf32(x - hi),   |e| <= 2^-22·|x|,

and summing three products into one float32 accumulator,

    a·b ≈ a_hi·b_hi + a_hi·b_lo + a_lo·b_hi,

leaves out only ``a_lo·b_lo`` (≤ 2⁻²² of each term) and the split errors, so
each term is good to about 2⁻²¹ of its size: the float32 product's own level
(2⁻²⁴ per rounding, growing with the depth of the sum). Each product is exact
in float32 (11 × 11 significant bits), and the tensor cores add in float32.

``tf32`` rounds to nearest with ties away from zero (the ``cvt.rna.tf32.f32``
rule) by adding half a unit of the 13 dropped bits and clearing them. The
kernel splits the activations on the fly, by the same bit operations, and
takes the weights in a form made once per weight tensor:
:func:`prepare_tf32_weight` turns a ``(K, N)`` weight into ``(2, N, K)``,
its transpose's heads and tails. The transpose is what the tensor cores need:
``wgmma`` reads 32-bit operands K-major only (it has no transpose bit for
them). For the flagship BS-RoFormer's 24 layers the prepared forms of
``wqkv``, ``wo``, ``ff_w1`` and ``ff_w2`` take 0.6 GB of device memory.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["split_tf32", "prepare_tf32_weight", "matmul_3xtf32", "TF32_DROPPED_BITS"]

TF32_DROPPED_BITS = 13  # float32's 23 mantissa bits less TF32's 10


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    half = 1 << (TF32_DROPPED_BITS - 1)
    mask = -(1 << TF32_DROPPED_BITS)  # 0xFFFFE000 as an int32
    return ((bits + half) & mask).view(torch.float32)


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` of a float32 tensor: both TF32 values stored as float32
    (their low 13 mantissa bits are zero), ``|x - hi - lo| <= 2^-22·|x|`` for
    normal ``x``."""
    if x.dtype != torch.float32:
        raise TypeError(f"split_tf32 takes float32, got {x.dtype}")
    hi = _round_tf32(x)
    return hi, _round_tf32(x - hi)


def prepare_tf32_weight(w: torch.Tensor) -> torch.Tensor:
    """The card-side form of a float32 ``(K, N)`` weight for the 3xTF32 GEMM:
    ``(2, N, K)`` contiguous, ``[0]`` the heads and ``[1]`` the tails of
    ``wᵀ``. Made once per weight tensor and reused by every call."""
    if w.dim() != 2:
        raise ValueError(f"weight must be (K, N), got shape {tuple(w.shape)}")
    hi, lo = split_tf32(w.t().contiguous())
    return torch.stack([hi, lo])


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a (M, K) · b (K, N)`` as the kernel forms it: three products of
    TF32 values, summed in float32."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    return a_hi @ b_hi + a_hi @ b_lo + a_lo @ b_hi
