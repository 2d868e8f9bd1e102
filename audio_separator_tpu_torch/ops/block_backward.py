"""The backward passes of the two fused RoFormer blocks
(``ops/attention_block.py``): three CUDA kernels for Hopper, their plain
PyTorch versions, and the two compositions the blocks' autograd Functions
call.

The JAX package has no backward kernels to port: it cannot differentiate
through ``pl.pallas_call`` (it has no ``custom_vjp``), so its training runs
only on its unfused path. These kernels are new, and are held against
``jax.grad`` of that unfused path on the CPU and against their plain
versions on the card:

* ``rmsnorm_backward`` (K2, ``csrc/norm_bwd.cu``): the blocks' RMSNorm
  ``xn = x·rsqrt(max(Σx², 1e-24))·√d·γ`` → ``dx`` (plus the residual's
  gradient) and ``dγ``;
* ``gelu_backward`` (K3, ``csrc/gelu_bwd.cu``): ``dpre = dh ⊙ GELU_erf'(pre)``,
  also writing ``h = GELU_erf(pre)``;
* ``rope_gate_backward`` (K4, ``csrc/rope_gate_bwd.cu``): the attention's
  gradients back through RoPE into the packed ``dqkv``, and the gate logits'
  gradient ``(1 − g)·Δ``.

The attention itself (K1) is ``ops/attention.attention_backward``. Each
wrapper takes the plain version for CPU tensors and launches its kernel for
CUDA tensors, or raises; nothing falls back. All are float32: bf16 training
is ROADMAP item 17b.

The products between the kernels (``dX = dY·Wᵀ``, ``dW = Xᵀ·dY``) and the
bias sums are plain ``torch.matmul`` / ``sum`` in full float32
(``ops/precision.full_float32``), as the JAX package leaves them to XLA
outside any Pallas kernel. Moving them onto the 3xTF32 GEMM is later work.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ._build import check_cuda_layout, check_rc, count, device_kind, load, stream
from .attention import attention_backward, check_float32_backward
from .precision import full_float32

__all__ = ["rmsnorm_bwd_ref", "rmsnorm_backward", "gelu_bwd_ref", "gelu_backward",
           "rope_gate_bwd_ref", "rope_gate_backward", "attention_block_backward",
           "ff_block_backward"]

# dγ's first stage: partial rows, one per block of the first launch.
NORM_BWD_BLOCKS = 1056


def _rotate_half_t(x: torch.Tensor) -> torch.Tensor:
    """The transpose of the interleaved-pair ``rotate_half``:
    ``out[2k] = x[2k+1]``, ``out[2k+1] = -x[2k]``."""
    x2 = x.reshape(*x.shape[:-1], x.shape[-1] // 2, 2)
    return torch.stack([x2[..., 1], -x2[..., 0]], dim=-1).reshape(x.shape)


# ---------------------------------------------------------------------------
# K2: RMSNorm backward.


def rmsnorm_bwd_ref(x: torch.Tensor, gamma: torch.Tensor, dxn: torch.Tensor,
                    dres: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x``, ``dxn`` (and the residual's gradient ``dres``) ``(..., d)`` →
    ``(dx, dγ)``: the gradient of ``x·rsqrt(max(Σx², 1e-24))·√d·γ``."""
    d = x.shape[-1]
    xf, g = x.float(), dxn.float()
    ssq = (xf * xf).sum(-1, keepdim=True)
    r = torch.rsqrt(ssq.clamp_min(1e-24))
    sd = math.sqrt(d)
    dgamma = (g * xf * (r * sd)).reshape(-1, d).sum(0)
    du = g * gamma.float() * sd
    dot = (du * xf).sum(-1, keepdim=True)
    dx = r * du - torch.where(ssq >= 1e-24, r ** 3 * dot, torch.zeros_like(r)) * xf
    if dres is not None:
        dx = dx + dres.float()
    return dx, dgamma


def rmsnorm_backward(x: torch.Tensor, gamma: torch.Tensor, dxn: torch.Tensor,
                     dres: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's wrapper; arguments and result as :func:`rmsnorm_bwd_ref`."""
    check_float32_backward(x)
    if device_kind(x) == "cpu":
        return rmsnorm_bwd_ref(x, gamma, dxn, dres)
    d = x.shape[-1]
    if d % 4:
        raise ValueError(f"the norm backward needs d % 4 == 0, got {d}")
    x, gamma, dxn = x.contiguous(), gamma.float().contiguous(), dxn.contiguous()
    dres = dres.contiguous() if dres is not None else None
    rows = x.numel() // d
    blocks = min(NORM_BWD_BLOCKS, -(-rows // 8))
    dx = torch.empty_like(x)
    partial = torch.empty((blocks, d), dtype=torch.float32, device=x.device)
    dgamma = torch.empty(d, dtype=torch.float32, device=x.device)
    check_cuda_layout(x, gamma, dxn, dx, *(() if dres is None else (dres,)))
    lib = load("norm_bwd")
    with torch.cuda.device(x.device):
        rc = lib.asep_norm_bwd(x.data_ptr(), gamma.data_ptr(), dxn.data_ptr(),
                               dres.data_ptr() if dres is not None else None, dx.data_ptr(),
                               partial.data_ptr(), dgamma.data_ptr(), rows, d, blocks,
                               stream(x))
    check_rc(lib, rc, "rmsnorm_backward")
    count("rmsnorm_backward")
    return dx, dgamma


# ---------------------------------------------------------------------------
# K3: GELU(erf) backward.


def gelu_bwd_ref(pre: torch.Tensor, dh: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dpre, h)``: ``dh ⊙ (Φ(pre) + pre·φ(pre))`` and ``pre·Φ(pre)``."""
    cdf = 0.5 * (1.0 + torch.erf(pre * 0.7071067811865476))
    pdf = torch.exp(-0.5 * pre * pre) * 0.3989422804014327
    return dh * (cdf + pre * pdf), pre * cdf


def gelu_backward(pre: torch.Tensor, dh: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's wrapper; arguments and result as :func:`gelu_bwd_ref`."""
    check_float32_backward(pre)
    if device_kind(pre) == "cpu":
        return gelu_bwd_ref(pre, dh)
    if pre.shape != dh.shape or pre.numel() % 4:
        raise ValueError(f"pre {tuple(pre.shape)} and dh {tuple(dh.shape)} must match, "
                         f"a multiple of 4 values")
    pre, dh = pre.contiguous(), dh.contiguous()
    dpre, h = torch.empty_like(pre), torch.empty_like(pre)
    check_cuda_layout(pre, dh, dpre, h)
    lib = load("gelu_bwd")
    with torch.cuda.device(pre.device):
        rc = lib.asep_gelu_bwd(pre.data_ptr(), dh.data_ptr(), dpre.data_ptr(), h.data_ptr(),
                               pre.numel(), stream(pre))
    check_rc(lib, rc, "gelu_backward")
    count("gelu_backward")
    return dpre, h


# ---------------------------------------------------------------------------
# K4: RoPE and gate backward.


def rope_gate_bwd_ref(dq: torch.Tensor, dk: torch.Tensor, dv: torch.Tensor,
                      delta: torch.Tensor, gates: torch.Tensor,
                      rope: Optional[Tuple[torch.Tensor, torch.Tensor]]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradients of the rotated q, k and of v, ``(B, H, n, dh)``, →
    ``dqkv (B, n, 3·H·dh)`` in the QKV product's column order; the row sums
    ``delta`` and the gates ``(B, H, n)`` → ``dz (B, n, H)``, the gate
    logits' gradient ``(1 − g)·Δ``. RoPE's transpose: ``cos·g +
    rotate_halfᵀ(sin·g)``."""
    if rope is not None:
        cos, sin = rope[0].float(), rope[1].float()
        dq = dq * cos + _rotate_half_t(dq * sin)
        dk = dk * cos + _rotate_half_t(dk * sin)
    b, h, n, dh = dq.shape
    dqkv = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4).reshape(b, n, 3 * h * dh)
    dz = ((1.0 - gates) * delta).transpose(1, 2)
    return dqkv, dz


def rope_gate_backward(dq: torch.Tensor, dk: torch.Tensor, dv: torch.Tensor,
                       delta: torch.Tensor, gates: torch.Tensor,
                       rope: Optional[Tuple[torch.Tensor, torch.Tensor]]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's wrapper; arguments and result as :func:`rope_gate_bwd_ref`."""
    check_float32_backward(dq)
    if device_kind(dq) == "cpu":
        return rope_gate_bwd_ref(dq, dk, dv, delta, gates, rope)
    b, h, n, dh = dq.shape
    if dh != 64:
        raise ValueError(f"the RoPE and gate backward takes 64-wide heads, got {dh}")
    dq, dk, dv, delta, gates = (t.contiguous() for t in (dq, dk, dv, delta, gates))
    cos, sin = ((t.float().contiguous() for t in rope) if rope is not None else (None, None))
    dqkv = torch.empty((b, n, 3 * h * dh), dtype=torch.float32, device=dq.device)
    dz = torch.empty((b, n, h), dtype=torch.float32, device=dq.device)
    check_cuda_layout(dq, dk, dv, dqkv, *((cos, sin) if cos is not None else ()))
    lib = load("rope_gate_bwd")
    with torch.cuda.device(dq.device):
        rc = lib.asep_rope_gate_bwd(
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            cos.data_ptr() if cos is not None else None,
            sin.data_ptr() if sin is not None else None, delta.data_ptr(), gates.data_ptr(),
            dqkv.data_ptr(), dz.data_ptr(), b, n, h, stream(dq))
    check_rc(lib, rc, "rope_gate_backward")
    count("rope_gate_backward")
    return dqkv, dz


# ---------------------------------------------------------------------------
# The blocks' backward passes (the same composition on both devices).


def attention_block_backward(dy, x, wqkv, gate_w, wo, attn_norm, rope, heads: int,
                             n_valid: int, xn, q, k, v, gates, merged, partial: bool = False):
    """The attention block's gradients ``(dx, dwqkv, dgate_w, dgate_b, dwo,
    dattn_norm)`` from the output's gradient ``dy (B, n_pad, d)`` and what
    the forward kept: ``xn``, the rotated ``q``, ``k`` and ``v`` ``(B, H,
    n_pad, dh)``, the gates ``(B, H, n_pad)`` and the gated merged heads
    ``(B, n_pad, H·dh)``. ``partial``: the block's output had no residual,
    so ``dx`` is the path through the norm alone."""
    b, n, d = x.shape
    hd = merged.shape[-1]
    dy2 = dy.reshape(-1, d)
    with full_float32():
        d_merged = (dy2 @ wo.t()).reshape(b, n, hd)
        dwo = merged.reshape(-1, hd).t() @ dy2
    dq, dk, dv, delta = attention_backward(q, k, v, merged, d_merged, (hd // heads) ** -0.5,
                                           n_valid, gates=gates)
    dqkv, dz = rope_gate_backward(dq, dk, dv, delta, gates, rope)
    with full_float32():
        dqkv2, dz2, xn2 = dqkv.reshape(-1, 3 * hd), dz.reshape(-1, heads), xn.reshape(-1, d)
        dxn = torch.addmm(dz2 @ gate_w.t(), dqkv2, wqkv.t())
        dwqkv = xn2.t() @ dqkv2
        dgate_w = xn2.t() @ dz2
        dgate_b = dz2.sum(0)
    dx, dnorm = rmsnorm_backward(x, attn_norm, dxn.reshape(b, n, d),
                                 dres=None if partial else dy)
    return dx, dwqkv, dgate_w, dgate_b, dwo, dnorm


def ff_block_backward(dy, x, ff_norm, w1, b1, w2, xn, partial: bool = False):
    """The feed-forward block's gradients ``(dx, dff_norm, dw1, db1, dw2,
    db2)`` from ``dy (B, n_pad, d)``, its input ``x`` and the normalised
    ``xn`` the forward kept. The pre-activation ``xn·W1 + b1`` is recomputed
    (the forward keeps no (rows, hidden) activation); K3 gives its gradient
    and the activation the second weight's gradient needs. ``partial``: the
    output had neither residual nor ``b2``; ``db2`` is None."""
    d = x.shape[-1]
    dy2, xn2 = dy.reshape(-1, d), xn.reshape(-1, d)
    with full_float32():
        pre = torch.addmm(b1, xn2, w1)
        dh = dy2 @ w2.t()
    dpre, h = gelu_backward(pre, dh)
    del pre, dh
    with full_float32():
        dw2 = h.t() @ dy2
        db2 = None if partial else dy2.sum(0)
        del h
        dw1 = xn2.t() @ dpre
        db1 = dpre.sum(0)
        dxn = dpre @ w1.t()
    dx, dnorm = rmsnorm_backward(x, ff_norm, dxn.reshape(x.shape), dres=None if partial else dy)
    return dx, dnorm, dw1, db1, dw2, db2
