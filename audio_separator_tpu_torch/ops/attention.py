"""Whole-sequence attention: the CUDA kernel for Hopper, its plain PyTorch
version and the dispatch.

``fused_attention`` replaces the Pallas TPU kernel
``audio_separator_tpu/ops/attention.py::_pallas_fused_attention``
(``_fused_attention_kernel``)::

    softmax(q·kᵀ·scale)·v      per (batch, head), q, k, v of one shape (B, H, N, D)

Scores and softmax are float32, the weights are cast to ``v``'s type before
the PV product, which accumulates in float32, and the result is cast to
``q``'s type. ``attention_ref`` is the same arithmetic in PyTorch ops with the
same rounding points.

``dot_product_attention`` dispatches by the device of ``q``: a CPU tensor takes
the plain version, a CUDA tensor launches the kernel (``csrc/attention.cu``)
or raises. Nothing falls back. The TPU dispatch's rules do not carry over: its
VMEM budget (which sends the HTDemucs frequency branch's N = 2688 to the
einsum path on the TPU), its backend probe, the padding of N to a multiple of
128, the heads-per-cell ``group`` and the minimum N of 16 were all properties
of that chip. On this card every N runs the kernel, N = 2688 included, and the
ragged last tile is masked inside the kernel, so no padded copy of q, k or v is
made along N.

The kernel's head dimension is 64 or 128; any other D that is a multiple of 8
up to 128 is zero-padded to the next of the two here (zero columns add
nothing to q·kᵀ, and the padded output columns are dropped). One deliberate
difference to the TPU kernel: the online softmax normalises after the PV
product, so in bf16 the weights are rounded unnormalised; in float32 that is
reassociation only.

Where the time goes on the card: 4·B·H·N²·D operations over 4·B·H·N·D elements
of input and output, so the kernel is operation-bound at the HTDemucs shapes
(N 1344 and 2688). bf16 runs both products on ``wgmma`` (64 queries a consumer
warpgroup, three of them a block at D 64 and two at D 128, K and V tiles of 128
keys brought by TMA through a three-dimensional tensor map, so rows past N
read as zeros, the softmax overlapped with the previous tile's P·V; sequences of
at most 64 rows get one-warpgroup blocks, two to an SM); float32 runs
register-blocked FMA tiles (TF32 is not float32) with K and V brought by
``cp.async`` while the other product runs. In both, scores, output, running maximum and running sum stay
in registers across key tiles. TMA and the vector loads want 16-byte aligned
operands, which the wrapper checks before the launch.
"""

from __future__ import annotations

from typing import Optional

import torch

from ._build import (DTYPE_CODES, LAUNCHES, check_cuda_layout, check_rc, device_kind,
                     load, reset_launch_counts, stream)

__all__ = ["LAUNCHES", "reset_launch_counts", "attention_ref", "fused_attention",
           "dot_product_attention", "padded_head_dim"]

KERNEL_HEAD_DIMS = (64, 128)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """``(B, H, Nq, D)``, ``(B, H, Nk, D)`` twice → ``(B, H, Nq, D)``."""
    sim = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    attn = torch.softmax(sim, dim=-1).to(v.dtype)
    return torch.matmul(attn.float(), v.float()).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, N, D), got shape {tuple(q.shape)}")
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"q dtype {q.dtype} not supported (float32, bfloat16)")
    for name, t in (("k", k), ("v", v)):
        if tuple(t.shape) != tuple(q.shape):
            raise ValueError(
                f"{name} shape {tuple(t.shape)} != q shape {tuple(q.shape)}: the "
                f"attention kernel takes q, k and v of one shape (self-attention)")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    if 0 in q.shape:
        raise ValueError(f"empty attention operand {tuple(q.shape)}")


def padded_head_dim(d: int) -> int:
    """The kernel head dimension a D-wide head runs at."""
    if d % 8 or not 8 <= d <= KERNEL_HEAD_DIMS[-1]:
        raise ValueError(
            f"kernel needs a head dimension that is a multiple of 8 up to "
            f"{KERNEL_HEAD_DIMS[-1]}, got {d}")
    return next(dh for dh in KERNEL_HEAD_DIMS if d <= dh)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """The kernel wrapper: CUDA tensors of one shape ``(B, H, N, D)``."""
    _check(q, k, v)
    if device_kind(q) != "cuda":
        raise ValueError("fused_attention launches a CUDA kernel; CPU tensors "
                         "go through dot_product_attention")
    b, h, n, d = q.shape
    dh = padded_head_dim(d)
    if dh != d:
        q, k, v = (torch.nn.functional.pad(t, (0, dh - d)) for t in (q, k, v))
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    check_cuda_layout(q, k, v, out)
    lib = load("attention")
    with torch.cuda.device(q.device):
        rc = lib.asep_attention(DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                                v.data_ptr(), out.data_ptr(), b * h, n, dh,
                                float(scale), stream(q))
    check_rc(lib, rc, "fused_attention")
    LAUNCHES["fused_attention"] += 1
    return out[..., :d] if dh != d else out


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Self-attention over ``(B, H, N, D)`` tensors; returns ``(B, H, N, D)``."""
    _check(q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if device_kind(q) == "cpu":
        return attention_ref(q, k, v, scale)
    return fused_attention(q, k, v, scale)
