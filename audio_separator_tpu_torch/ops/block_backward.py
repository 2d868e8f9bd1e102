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
CUDA tensors, or raises; nothing falls back.

Each kernel has a float32 and a bf16 form, chosen by the type of its
tensors; the bf16 forms serve the bf16 training of the RoFormer family
(float32 master weights, cast to bf16 inside each step). They read and
write bf16 activations and gradients and compute in float32 in between:
the sums of K2, the GELU of K3; the gates, Δ and the gate logits' gradient
stay float32 in K4, as the forward keeps the gates. K2's dγ is float32; so
are the bias sums here; autograd rounds a gradient to its parameter's type.

The products between the kernels (``dX = dY·Wᵀ``, ``dW = Xᵀ·dY``) are plain
``torch.matmul``, as the JAX package leaves them to XLA outside any Pallas
kernel: in full float32 for float32 blocks (``ops/precision.full_float32``;
moving them onto the 3xTF32 GEMM is later work), and in bf16 with float32
accumulation for bf16 blocks (``ops/precision.float32_bf16_reductions``).
The bias sums accumulate in float32.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ._build import DTYPE_CODES, check_cuda_layout, check_rc, device_kind, launch, load, stream
from .attention import attention_backward, check_backward_dtype
from .precision import float32_bf16_reductions, full_float32

__all__ = ["rmsnorm_bwd_ref", "rmsnorm_backward", "gelu_bwd_ref", "gelu_backward",
           "rope_gate_bwd_ref", "rope_gate_backward", "attention_block_backward",
           "ff_block_backward"]

# dγ's first stage: partial rows, one per block of the first launch.
NORM_BWD_BLOCKS = 1056


def _launch_name(name: str, dtype: torch.dtype) -> str:
    """The launch counter of a kernel's form for ``dtype``."""
    return name if dtype == torch.float32 else f"{name}_bf16"


def _products(dtype: torch.dtype):
    """The precision scope of the plain products between the kernels."""
    return full_float32() if dtype == torch.float32 else float32_bf16_reductions()


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
    ``(dx, dγ)``: the gradient of ``x·rsqrt(max(Σx², 1e-24))·√d·γ``, in
    float32; ``dx`` in ``x``'s type, ``dγ`` float32."""
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
    return dx.to(x.dtype), dgamma


def rmsnorm_backward(x: torch.Tensor, gamma: torch.Tensor, dxn: torch.Tensor,
                     dres: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's wrapper; arguments and result as :func:`rmsnorm_bwd_ref`."""
    check_backward_dtype(x)
    if device_kind(x) == "cpu":
        return rmsnorm_bwd_ref(x, gamma, dxn, dres)
    with launch(_launch_name("rmsnorm_backward", x.dtype)):
        d, vec = x.shape[-1], 16 // x.element_size()
        if d % vec:
            raise ValueError(f"the norm backward needs d % {vec} == 0, got {d}")
        dt = x.dtype
        x, gamma, dxn = x.contiguous(), gamma.float().contiguous(), dxn.to(dt).contiguous()
        dres = dres.to(dt).contiguous() if dres is not None else None
        rows = x.numel() // d
        blocks = min(NORM_BWD_BLOCKS, -(-rows // 8))
        dx = torch.empty_like(x)
        partial = torch.empty((blocks, d), dtype=torch.float32, device=x.device)
        dgamma = torch.empty(d, dtype=torch.float32, device=x.device)
        check_cuda_layout(x, gamma, dxn, dx, *(() if dres is None else (dres,)))
        lib = load("norm_bwd")
        with torch.cuda.device(x.device):
            rc = lib.asep_norm_bwd(DTYPE_CODES[dt], x.data_ptr(), gamma.data_ptr(), dxn.data_ptr(),
                                   dres.data_ptr() if dres is not None else None, dx.data_ptr(),
                                   partial.data_ptr(), dgamma.data_ptr(), rows, d, blocks,
                                   stream(x))
        check_rc(lib, rc, "rmsnorm_backward")
    return dx, dgamma


# ---------------------------------------------------------------------------
# K3: GELU(erf) backward.


def gelu_bwd_ref(pre: torch.Tensor, dh: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dpre, h)``: ``dh ⊙ (Φ(pre) + pre·φ(pre))`` and ``pre·Φ(pre)``,
    computed in float32 and written in ``pre``'s type."""
    dt = pre.dtype
    pre, dh = pre.float(), dh.float()
    cdf = 0.5 * (1.0 + torch.erf(pre * 0.7071067811865476))
    pdf = torch.exp(-0.5 * pre * pre) * 0.3989422804014327
    return (dh * (cdf + pre * pdf)).to(dt), (pre * cdf).to(dt)


def gelu_backward(pre: torch.Tensor, dh: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's wrapper; arguments and result as :func:`gelu_bwd_ref`."""
    check_backward_dtype(pre)
    if device_kind(pre) == "cpu":
        return gelu_bwd_ref(pre, dh)
    with launch(_launch_name("gelu_backward", pre.dtype)):
        vec = 16 // pre.element_size()  # values a 16-byte vector holds
        if pre.shape != dh.shape or pre.numel() % vec:
            raise ValueError(f"pre {tuple(pre.shape)} and dh {tuple(dh.shape)} must match, "
                             f"a multiple of {vec} values")
        dt = pre.dtype
        pre, dh = pre.contiguous(), dh.to(dt).contiguous()
        dpre, h = torch.empty_like(pre), torch.empty_like(pre)
        check_cuda_layout(pre, dh, dpre, h)
        lib = load("gelu_bwd")
        with torch.cuda.device(pre.device):
            rc = lib.asep_gelu_bwd(DTYPE_CODES[dt], pre.data_ptr(), dh.data_ptr(), dpre.data_ptr(),
                                   h.data_ptr(), pre.numel(), stream(pre))
        check_rc(lib, rc, "gelu_backward")
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
    rotate_halfᵀ(sin·g)``, in float32 with float32 tables; ``dqkv`` in
    ``dq``'s type, ``dz`` float32."""
    dt = dq.dtype
    dq, dk, dv = dq.float(), dk.float(), dv.float()
    if rope is not None:
        cos, sin = rope[0].float(), rope[1].float()
        dq = dq * cos + _rotate_half_t(dq * sin)
        dk = dk * cos + _rotate_half_t(dk * sin)
    b, h, n, dh = dq.shape
    dqkv = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4).reshape(b, n, 3 * h * dh)
    dz = ((1.0 - gates.float()) * delta.float()).transpose(1, 2)
    return dqkv.to(dt), dz


def rope_gate_backward(dq: torch.Tensor, dk: torch.Tensor, dv: torch.Tensor,
                       delta: torch.Tensor, gates: torch.Tensor,
                       rope: Optional[Tuple[torch.Tensor, torch.Tensor]]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's wrapper; arguments and result as :func:`rope_gate_bwd_ref`."""
    check_backward_dtype(dq)
    if device_kind(dq) == "cpu":
        return rope_gate_bwd_ref(dq, dk, dv, delta, gates, rope)
    with launch(_launch_name("rope_gate_backward", dq.dtype)):
        b, h, n, dh = dq.shape
        if dh != 64:
            raise ValueError(f"the RoPE and gate backward takes 64-wide heads, got {dh}")
        dt = dq.dtype
        dq, dk, dv = (t.to(dt).contiguous() for t in (dq, dk, dv))
        delta, gates = (t.float().contiguous() for t in (delta, gates))
        cos, sin = ((t.float().contiguous() for t in rope) if rope is not None else (None, None))
        dqkv = torch.empty((b, n, 3 * h * dh), dtype=dt, device=dq.device)
        dz = torch.empty((b, n, h), dtype=torch.float32, device=dq.device)
        check_cuda_layout(dq, dk, dv, dqkv, *((cos, sin) if cos is not None else ()))
        lib = load("rope_gate_bwd")
        with torch.cuda.device(dq.device):
            rc = lib.asep_rope_gate_bwd(
                DTYPE_CODES[dt], dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                cos.data_ptr() if cos is not None else None,
                sin.data_ptr() if sin is not None else None, delta.data_ptr(), gates.data_ptr(),
                dqkv.data_ptr(), dz.data_ptr(), b, n, h, stream(dq))
        check_rc(lib, rc, "rope_gate_backward")
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
    so ``dx`` is the path through the norm alone. In ``x``'s type: float32,
    or bf16 with the gates and the gate logits' gradient in float32."""
    b, n, d = x.shape
    dt = x.dtype
    hd = merged.shape[-1]
    dy2 = dy.reshape(-1, d)
    with _products(dt):
        d_merged = (dy2 @ wo.t()).reshape(b, n, hd)
        dwo = merged.reshape(-1, hd).t() @ dy2
    dq, dk, dv, delta = attention_backward(q, k, v, merged, d_merged, (hd // heads) ** -0.5,
                                           n_valid, gates=gates)
    dqkv, dz = rope_gate_backward(dq, dk, dv, delta, gates, rope)
    with _products(dt):
        dqkv2, dz2, xn2 = dqkv.reshape(-1, 3 * hd), dz.reshape(-1, heads), xn.reshape(-1, d)
        # The gate path in float32 (the forward's gates are), added to the
        # QKV product's float32 sum before its one rounding to dt.
        dxn = torch.addmm((dz2 @ gate_w.float().t()).to(dt), dqkv2, wqkv.t())
        dwqkv = xn2.t() @ dqkv2
        dgate_w = xn2.float().t() @ dz2
        dgate_b = dz2.sum(0)
    dx, dnorm = rmsnorm_backward(x, attn_norm, dxn.reshape(b, n, d),
                                 dres=None if partial else dy)
    return dx, dwqkv, dgate_w, dgate_b, dwo, dnorm


def ff_block_backward(dy, x, ff_norm, w1, b1, w2, xn, partial: bool = False):
    """The feed-forward block's gradients ``(dx, dff_norm, dw1, db1, dw2,
    db2)`` from ``dy (B, n_pad, d)``, its input ``x`` and the normalised
    ``xn`` the forward kept. The pre-activation ``xn·W1 + b1`` is recomputed
    (the forward keeps no (rows, hidden) activation), rounded to ``x``'s
    type; K3 gives its gradient and the activation the second weight's
    gradient needs. ``partial``: the output had neither residual nor ``b2``;
    ``db2`` is None."""
    d = x.shape[-1]
    dt = x.dtype
    dy2, xn2 = dy.reshape(-1, d), xn.reshape(-1, d)
    with _products(dt):
        pre = torch.addmm(b1, xn2, w1)
        dh = dy2 @ w2.t()
    dpre, h = gelu_backward(pre, dh)
    del pre, dh
    with _products(dt):
        dw2 = h.t() @ dy2
        db2 = None if partial else dy2.float().sum(0)
        del h
        dw1 = xn2.t() @ dpre
        db1 = dpre.float().sum(0)
        dxn = dpre @ w1.t()
    dx, dnorm = rmsnorm_backward(x, ff_norm, dxn.reshape(x.shape), dres=None if partial else dy)
    return dx, dnorm, dw1, db1, dw2, db2
