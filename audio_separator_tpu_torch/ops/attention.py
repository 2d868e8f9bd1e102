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

Gradients: ``dot_product_attention`` is a ``torch.autograd.Function`` on both
devices. Its backward is ``attention_backward``: on a CUDA tensor the kernel
of ``csrc/attention_bwd.cu`` (the JAX package has no backward kernel to port,
as it cannot differentiate through ``pl.pallas_call``), on a CPU tensor its
plain version ``attention_bwd_ref``, so CPU autograd runs the composition the
card runs. The same backward serves the RoFormer attention block, whose
output is the gated merged heads (``gates=``): float32, or bf16 for the bf16
training of the RoFormer family (``csrc/attention_bwd_bf16.cuh``). The
whole-sequence layout is float32 only: its one caller is HTDemucs training,
which the JAX package cannot run in bf16 (ROADMAP C16).
"""

from __future__ import annotations

from typing import Optional

import torch

from ._build import (DTYPE_CODES, LAUNCHES, check_cuda_layout, check_rc, device_kind, launch,
                     load, reset_launch_counts, stream)

__all__ = ["LAUNCHES", "reset_launch_counts", "attention_ref", "fused_attention",
           "dot_product_attention", "padded_head_dim", "attention_bwd_ref",
           "attention_backward", "check_backward_dtype"]

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
    with launch("fused_attention"):
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
    return out[..., :d] if dh != d else out


def check_backward_dtype(t: torch.Tensor) -> None:
    """The backward kernels take float32, and bf16 for the bf16 training of
    the RoFormer family."""
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"the backward pass takes float32 or bfloat16, got {t.dtype}")


def _heads_of(t: torch.Tensor, heads: int) -> torch.Tensor:
    """``(B, N, heads·D)`` merged heads → ``(B, heads, N, D)``."""
    b, n, hd = t.shape
    return t.reshape(b, n, heads, hd // heads).transpose(1, 2)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                      do: torch.Tensor, scale: float, n_valid: Optional[int] = None,
                      gates: Optional[torch.Tensor] = None):
    """The plain version of the attention backward: ``(dq, dk, dv, delta)``.

    ``o`` is the forward's output and ``do`` its gradient, ``(B, H, N, D)``;
    with ``gates`` ``(B, H, N)`` they are instead the attention block's gated
    merged heads ``merged = O·g`` and their gradient, ``(B, N, H·D)``, so
    that ``dO = d_merged·g``. ``delta`` ``(B, H, N)`` is ``Σ dO ⊙ O``
    (``Σ d_merged ⊙ merged`` for the merged heads). Keys ``≥ n_valid`` are
    masked as in the forward.

    bf16 (the gated layout): q, k, v and the merged heads are bf16, the gates
    float32. The scores, softmax, Δ and every sum are float32; ``P·g`` and
    ``dS`` are rounded to bf16 before the products that read them, as the
    forward rounds P before its PV product; dq, dk and dv are bf16, Δ
    float32."""
    if q.dtype == torch.bfloat16 and gates is not None:
        return _attention_bwd_ref_bf16(q, k, v, o, do, scale, n_valid, gates)
    q, k, v = q.float(), k.float(), v.float()
    if gates is not None:
        heads = q.shape[1]
        o, do = _heads_of(o.float(), heads), _heads_of(do.float(), heads)
        delta = (do * o).sum(-1)
        do = do * gates[..., None]
    else:
        o, do = o.float(), do.float()
        delta = (do * o).sum(-1)
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if n_valid is not None and n_valid < s.shape[-1]:
        s[..., n_valid:] = -1e30
    p = torch.softmax(s, dim=-1)
    dv = torch.matmul(p.transpose(-1, -2), do)
    ds = p * (torch.matmul(do, v.transpose(-1, -2)) - delta[..., None])
    dq = torch.matmul(ds, k) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q) * scale
    return dq, dk, dv, delta


def _attention_bwd_ref_bf16(q, k, v, merged, d_merged, scale, n_valid, gates):
    heads = q.shape[1]
    q, k, v = q.float(), k.float(), v.float()
    o, do = _heads_of(merged.float(), heads), _heads_of(d_merged.float(), heads)
    delta = (do * o).sum(-1)
    gain = gates.float()[..., None]
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if n_valid is not None and n_valid < s.shape[-1]:
        s[..., n_valid:] = -1e30
    p = torch.softmax(s, dim=-1)
    pg = (p * gain).to(torch.bfloat16).float()
    dv = torch.matmul(pg.transpose(-1, -2), do)
    dp = torch.matmul(do, v.transpose(-1, -2)) * gain
    ds = (p * (dp - delta[..., None])).to(torch.bfloat16).float()
    dq = torch.matmul(ds, k) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q) * scale
    bf = torch.bfloat16
    return dq.to(bf), dk.to(bf), dv.to(bf), delta


def attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                       do: torch.Tensor, scale: float, n_valid: Optional[int] = None,
                       gates: Optional[torch.Tensor] = None):
    """The attention backward's wrapper: the plain version for CPU tensors,
    the kernel (``csrc/attention_bwd.cu``) for CUDA tensors. Arguments and
    result as :func:`attention_bwd_ref`: float32 in both layouts, bf16 in the
    gated one."""
    check_backward_dtype(q)
    if q.dtype != torch.float32 and gates is None:
        raise NotImplementedError(
            "the whole-sequence attention backward takes float32: its one caller is HTDemucs "
            "training, which the JAX package cannot run in bf16 (ROADMAP C16)")
    b, h, n, d = q.shape
    n_valid = n if n_valid is None else n_valid
    if not 1 <= n_valid <= n:
        raise ValueError(f"n_valid={n_valid} outside [1, {n}]")
    if device_kind(q) == "cpu":
        return attention_bwd_ref(q, k, v, o, do, scale, n_valid, gates)
    with launch("attention_backward" if q.dtype == torch.float32 else "attention_backward_bf16"):
        if gates is not None:
            if d != 64:
                raise ValueError(f"the gated backward takes 64-wide heads, got {d}")
            dh = d
            gates = gates.float().contiguous()
            if tuple(o.shape) != (b, n, h * d) or tuple(gates.shape) != (b, h, n):
                raise ValueError(f"merged heads {tuple(o.shape)} / gates {tuple(gates.shape)} "
                                 f"do not match q {tuple(q.shape)}")
        else:
            dh = padded_head_dim(d)
            if dh != d:
                q, k, v, o, do = (torch.nn.functional.pad(t, (0, dh - d))
                                  for t in (q, k, v, o, do))
        dt = q.dtype
        q, k, v, o, do = (t.to(dt).contiguous() for t in (q, k, v, o, do))
        dq, dk, dv = (torch.empty((b, h, n, dh), dtype=dt, device=q.device) for _ in range(3))
        lse, delta = (torch.empty((b, h, n), dtype=torch.float32, device=q.device)
                      for _ in range(2))
        check_cuda_layout(q, k, v, o, do, dq, dk, dv)
        lib = load("attention_bwd")
        with torch.cuda.device(q.device):
            rc = lib.asep_attention_bwd(
                DTYPE_CODES[dt], 0 if gates is None else 1, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), o.data_ptr(), do.data_ptr(),
                gates.data_ptr() if gates is not None else None, dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), lse.data_ptr(), delta.data_ptr(), b * h, n, n_valid, dh, h,
                float(scale), stream(q))
        check_rc(lib, rc, "attention_backward")
    if dh != d:
        dq, dk, dv = dq[..., :d], dk[..., :d], dv[..., :d]
    return dq, dk, dv, delta


class _Attention(torch.autograd.Function):
    """Forward: the plain version (CPU) or the kernel (CUDA); backward:
    :func:`attention_backward` on the same device."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        if device_kind(q) == "cpu":
            out = attention_ref(q, k, v, scale)
        else:
            out = fused_attention(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv, _ = attention_backward(q, k, v, out, dout, ctx.scale)
        return dq, dk, dv, None


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Self-attention over ``(B, H, N, D)`` tensors; returns ``(B, H, N, D)``.
    Differentiable on both devices (the backward is :func:`attention_backward`)."""
    _check(q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _Attention.apply(q, k, v, scale)
