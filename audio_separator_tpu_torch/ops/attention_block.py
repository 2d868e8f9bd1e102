"""The RoFormer layer's two fused blocks: CUDA kernels for Hopper, their
plain PyTorch versions and wrappers (the kernel loader and the launch
counters are ``ops/_build.py``'s).

``fused_attention_block`` replaces the Pallas TPU kernel
``audio_separator_tpu/ops/attention_block.py::fused_attention_block``
(``_layer_kernel``)::

    x + Wo·concat_h[σ(xn·gate_w + gate_b)_h ⊙ softmax(RoPE(q_h)·RoPE(k_h)ᵀ/√dh,
                    keys ≥ n_valid masked)·v_h],   xn = rmsnorm(x)·γ, qkv = xn·Wqkv

``fused_ff_block`` replaces ``fused_ff_block`` (``_ff_kernel``)::

    x + GELU_erf(rmsnorm(x)·γ·W1 + b1)·W2 + b2

Both have a partial-sum form (``partial=True``), the row-parallel shard of a
tensor-parallel layer (``parallel/mesh.py``): the attention block on a subset
of the heads writes ``Wo_s·concat_{h∈s}[...]`` and the feed-forward block on a
slice of the hidden columns writes ``GELU(...)_s·W2_s``, each rounded to the
input type, without the residual and without ``b2``; the layer adds ``x``,
``b2`` and every shard's partial product. The kernels are the same launches
with the residual left out of the last product's epilogue
(``csrc/tiles.cuh``, ``ResidualEpi``); they count as
``fused_attention_block_partial`` and ``fused_ff_block_partial``.

Dispatch is by the device of ``x``: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel (``csrc/attention_block.cu``,
``csrc/ff_block.cu``) or raises. Nothing falls back.

Both blocks are ``torch.autograd.Function``s on both devices, their only
route: the forward keeps the intermediates it computes anyway (the attention
block's xn, rotated q and k, v, gates and merged heads; the feed-forward
block's xn, its hidden activation being recomputed), and the backward is
``ops/block_backward.py``'s composition of hand-written kernels, in float32
or bf16 (the bf16 training step): the attention backward, the RoPE and gate
backward, the GELU backward and the RMSNorm backward, with plain products
between them.

Both sides round to the input dtype where the TPU kernels do: ``qkv`` before
RoPE, the rotated q/k, the softmax weights before the PV product, the merged
heads, the projection before the residual add, and the feed-forward hidden
activation. In float32 these roundings are no-ops. The kernel's online softmax
rounds the running (unnormalised) weights instead of the normalised ones, a
bf16-level difference the card-side comparison allows for.

Where the time goes on the card, and what the design does about it: every
product in both blocks is compute-bound at the flagship shapes (over a
thousand FLOP per byte of input and output). The products of both types run
on the tensor cores in one pipeline shape (``csrc/tiles.cuh``): persistent,
warp-specialised blocks in clusters of two; a producer thread keeps a ring of
128-byte-swizzled tiles filled by TMA (the weight tile is loaded half by each
block and multicast to both); the two consumer warpgroups take turns at
output tiles with ``wgmma`` (float32 accumulators in registers), so one's
epilogue (GELU, residual, RoPE, on the accumulator registers) overlaps the
other's products. In bf16 (m64n256k16) the weights are read as they lie,
``(K, N)`` row-major, through ``wgmma``'s transpose bit. In float32 the
products are 3xTF32 (``ops/tf32.py``, ``csrc/gemm_tf32.cuh``): three TF32
products a term, heads and tails of both operands, which keeps float32's
accuracy; ``wgmma`` reads 32-bit operands K-major only, so each float32 weight
is used in a prepared form, its transpose's TF32 heads and tails ``(2, N,
K)``, made once per weight tensor (the RoFormer module keeps them; a caller
that passes none gets them made for the call). The RMSNorm is a launch of its
own so the GEMMs stream their operands untouched; in the attention block it
also computes the gates, ``σ(xn·gate_w + gate_b)``, from the rounded xn. The
bf16 QKV product's epilogue works on whole 64×64 head boxes: RoPE on the
accumulator's own register pairs, q, k, v out by TMA stores. The attention
launch walks key tiles with an online softmax, with scores and output in
registers in both types (``wgmma`` fed by TMA in bf16, FMA in float32), so no
``(n, n)`` score matrix is ever stored, and skips key tiles that lie wholly
past ``n_valid``. TMA wants 16-byte aligned operands whose rows are multiples
of 16 bytes, so the wrappers check the alignment. The intermediates between
the launches of one block (xn, q, k, v, gates, merged heads; the FF hidden
activation) still round-trip through device memory.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ._build import (DTYPE_CODES, LAUNCHES, check_cuda_layout, check_rc, device_kind, launch,
                     load, reset_launch_counts, stream)
from .block_backward import attention_block_backward, ff_block_backward
from .tf32 import prepare_tf32_weight

__all__ = ["LAUNCHES", "reset_launch_counts", "fused_attention_block",
           "fused_attention_block_ref", "fused_ff_block", "fused_ff_block_ref",
           "check_kernel_dims", "rotate_half", "gate_columns"]

# ---------------------------------------------------------------------------
# Argument checks (shared by both devices) and kernel-only limits.


def _check_tensors(x: torch.Tensor, n_valid: Optional[int],
                   **expected: Tuple[torch.Tensor, tuple]) -> None:
    if x.dim() != 3:
        raise ValueError(f"x must be (B, n_pad, d), got shape {tuple(x.shape)}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"x dtype {x.dtype} not supported (float32, bfloat16)")
    n_pad = x.shape[1]
    if n_pad % 64:
        raise ValueError(f"n_pad={n_pad} must be a multiple of 64 "
                         f"(the caller pads the token axis once)")
    if n_valid is not None and not 1 <= n_valid <= n_pad:
        raise ValueError(f"n_valid={n_valid} outside [1, {n_pad}]")
    for name, (t, shape) in {"x": (x, tuple(x.shape)), **expected}.items():
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if t.dtype != x.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != x dtype {x.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


# Dynamic shared memory a block may use on the H100.
MAX_SMEM_BYTES = 232448


def gate_columns(heads: int) -> int:
    """Columns of the norm launch's gate weights in shared memory: ``heads``
    rounded up to a power of two (zero columns past it)."""
    return 1 << max(0, heads - 1).bit_length()


def check_kernel_dims(d_model: int, heads: Optional[int] = None,
                      dim_head: Optional[int] = None,
                      hidden: Optional[int] = None) -> None:
    """Limits of the CUDA kernels' tiling (64-wide tiles, one 64-lane head,
    the gate weights in one block's shared memory)."""
    if d_model % 64:
        raise ValueError(f"kernel needs d_model % 64 == 0, got {d_model}")
    if dim_head is not None and dim_head != 64:
        raise ValueError(f"kernel needs dim_head == 64, got {dim_head}")
    if heads is not None:
        if not 1 <= heads <= 64:
            raise ValueError(f"kernel needs 1 <= heads <= 64, got {heads}")
        if d_model * gate_columns(heads) * 4 > MAX_SMEM_BYTES:
            raise ValueError(f"gate weights of d_model={d_model} x {gate_columns(heads)} "
                             f"float32 exceed one block's shared memory")
    if hidden is not None and hidden % 64:
        raise ValueError(f"kernel needs hidden % 64 == 0, got {hidden}")


def _tf32_forms(forms: Optional[Tuple[torch.Tensor, torch.Tensor]],
                weights: Tuple[torch.Tensor, torch.Tensor], x: torch.Tensor):
    """The prepared 3xTF32 forms the float32 kernels read in place of the
    weights: those given (checked), or made here for this call."""
    if forms is None:
        return tuple(prepare_tf32_weight(w) for w in weights)
    for w, f in zip(weights, forms):
        shape = (2, w.shape[1], w.shape[0])
        if (tuple(f.shape) != shape or f.dtype != torch.float32 or f.device != x.device
                or not f.is_contiguous()):
            raise ValueError(f"prepared weight form {tuple(f.shape)} {f.dtype} on {f.device} "
                             f"is not the contiguous float32 {shape} on {x.device} "
                             f"that prepare_tf32_weight makes")
    return tuple(forms)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the ground truth the kernels are held against).


def _rnd(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round a float32 tensor to ``dtype`` and back (identity for float32)."""
    return t if dtype == torch.float32 else t.to(dtype).float()


def _rmsnorm_rounded(x: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    ssq = (xf * xf).sum(-1, keepdim=True)
    xn = xf * torch.rsqrt(ssq.clamp_min(1e-24)) * math.sqrt(x.shape[-1])
    return _rnd(xn * gamma.float(), x.dtype)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """Interleaved-pair rotation: ``out[2k] = -x[2k+1]``, ``out[2k+1] = x[2k]``."""
    x2 = x.reshape(*x.shape[:-1], x.shape[-1] // 2, 2)
    return torch.stack([-x2[..., 1], x2[..., 0]], dim=-1).reshape(x.shape)


def _attention_block_ref_parts(x, wqkv, gate_w, gate_b, wo, attn_norm, rope, heads: int,
                               n_valid: int, partial: bool = False):
    """The plain attention block and what its backward pass reads: ``out``
    and ``(xn, q, k, v, gates, merged)``, the rotated ``q``, ``k`` and ``v``
    as ``(b, h, n, dh)``, the gates as ``(b, h, n)`` (float32), the rest in
    ``x``'s type, as the kernel writes them. ``partial``: ``out`` is the
    rounded projection alone, without the residual."""
    dt = x.dtype
    b, n, d = x.shape
    dh = wqkv.shape[-1] // (3 * heads)
    xn = _rmsnorm_rounded(x, attn_norm)
    qkv = _rnd(xn @ wqkv.float(), dt)
    gates = torch.sigmoid(xn @ gate_w.float() + gate_b.float()).transpose(1, 2)  # (b, h, n)
    qkv = qkv.reshape(b, n, 3, heads, dh).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]  # (b, h, n, dh)
    if rope is not None:
        cos, sin = rope[0].float(), rope[1].float()
        q = _rnd(q * cos + rotate_half(q) * sin, dt)
        k = _rnd(k * cos + rotate_half(k) * sin, dt)
    s = (q @ k.transpose(-1, -2)) * dh ** -0.5
    if n_valid < n:
        s[..., n_valid:] = -1e30
    p = _rnd(torch.softmax(s, dim=-1), dt)
    o = (p @ v) * gates[..., None]
    merged = _rnd(o.permute(0, 2, 1, 3).reshape(b, n, heads * dh), dt)
    proj = _rnd(merged @ wo.float(), dt)
    out = proj if partial else x.float() + proj
    return out.to(dt), (*(t.to(dt) for t in (xn, q, k, v)), gates, merged.to(dt))


def fused_attention_block_ref(x, wqkv, gate_w, gate_b, wo, attn_norm, rope,
                              heads: int, n_valid: int, partial: bool = False) -> torch.Tensor:
    return _attention_block_ref_parts(x, wqkv, gate_w, gate_b, wo, attn_norm, rope, heads,
                                      n_valid, partial)[0]


def _ff_block_ref_parts(x, ff_norm, w1, b1, w2, b2):
    """The plain feed-forward block and the ``xn`` its backward pass reads;
    ``b2 is None``: the partial form, the rounded product alone."""
    dt = x.dtype
    xn = _rmsnorm_rounded(x, ff_norm)
    h = _rnd(torch.nn.functional.gelu(xn @ w1.float() + b1.float()), dt)
    if b2 is None:
        return _rnd(h @ w2.float(), dt).to(dt), xn.to(dt)
    y = _rnd(h @ w2.float() + b2.float(), dt)
    return (x.float() + y).to(dt), xn.to(dt)


def fused_ff_block_ref(x, ff_norm, w1, b1, w2, b2, partial: bool = False) -> torch.Tensor:
    return _ff_block_ref_parts(x, ff_norm, w1, b1, w2, None if partial else b2)[0]


# ---------------------------------------------------------------------------
# Kernel launches (CUDA tensors, checked by the wrappers).


def _attention_block_cuda(x, wqkv, gate_w, gate_b, wo, attn_norm, rope, heads, n_valid,
                          tf32_weights, partial):
    """The kernel's launch: ``out`` and the intermediates it writes, ``(xn, q,
    k, v, gates, merged)``, which the backward pass reads."""
    with launch("fused_attention_block_partial" if partial else "fused_attention_block"):
        b, n_pad, d = x.shape
        dh = wqkv.shape[-1] // (3 * heads)
        check_kernel_dims(d, heads, dh)
        qkv_shape = (b, heads, n_pad, dh)
        q, k, v = (torch.empty(qkv_shape, dtype=x.dtype, device=x.device)
                   for _ in range(3))
        gates = torch.empty((b, heads, n_pad), dtype=torch.float32, device=x.device)
        merged = torch.empty((b, n_pad, heads * dh), dtype=x.dtype, device=x.device)
        xn, out = torch.empty_like(x), torch.empty_like(x)
        cos, sin = rope if rope is not None else (None, None)
        check_cuda_layout(x, wqkv, wo, xn, q, k, v, merged, out,
                          *(rope if rope is not None else ()))
        if x.dtype == torch.float32:
            wqkv, wo = _tf32_forms(tf32_weights, (wqkv, wo), x)
        lib = load("attention_block")
        with torch.cuda.device(x.device):
            rc = lib.asep_attention_block(
                DTYPE_CODES[x.dtype], x.data_ptr(), wqkv.data_ptr(),
                gate_w.data_ptr(), gate_b.data_ptr(), wo.data_ptr(),
                attn_norm.data_ptr(),
                cos.data_ptr() if cos is not None else None,
                sin.data_ptr() if sin is not None else None, xn.data_ptr(),
                q.data_ptr(), k.data_ptr(), v.data_ptr(), gates.data_ptr(),
                merged.data_ptr(), out.data_ptr(),
                b, n_pad, d, heads, n_valid, int(partial), stream(x))
        check_rc(lib, rc, "fused_attention_block")
    return out, (xn, q, k, v, gates, merged)


def _ff_block_cuda(x, ff_norm, w1, b1, w2, b2, tf32_weights):
    """The kernel's launch: ``out`` and ``xn``, which the backward pass reads
    (the hidden activation is scratch, dropped here); ``b2 is None``: the
    partial form."""
    with launch("fused_ff_block_partial" if b2 is None else "fused_ff_block"):
        b, n_pad, d = x.shape
        hidden = w1.shape[-1]
        check_kernel_dims(d, hidden=hidden)
        h = torch.empty((b, n_pad, hidden), dtype=x.dtype, device=x.device)
        xn, out = torch.empty_like(x), torch.empty_like(x)
        partial = b2 is None
        check_cuda_layout(x, w1, b1, w2, xn, h, out, *(() if partial else (b2,)))
        if x.dtype == torch.float32:
            w1, w2 = _tf32_forms(tf32_weights, (w1, w2), x)
        lib = load("ff_block")
        with torch.cuda.device(x.device):
            rc = lib.asep_ff_block(
                DTYPE_CODES[x.dtype], x.data_ptr(), ff_norm.data_ptr(),
                w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), None if partial else b2.data_ptr(),
                xn.data_ptr(), h.data_ptr(), out.data_ptr(), b * n_pad, d, hidden, int(partial),
                stream(x))
        check_rc(lib, rc, "fused_ff_block")
    return out, xn


# ---------------------------------------------------------------------------
# Autograd: the blocks' only route, on both devices. The forward is the plain
# version (CPU) or the kernel (CUDA) and keeps what it computed on the way;
# the backward is ops/block_backward.py's composition, whose kernels take the
# same dispatch. The prepared 3xTF32 forms are not differentiated. The
# partial forms pass no residual gradient to the norm's backward and give no
# gradient of b2 (the layer that adds them differentiates its own sum).


class _AttentionBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wqkv, gate_w, gate_b, wo, attn_norm, cos, sin, heads, n_valid,
                tf32_weights, partial):
        rope = (cos, sin) if cos is not None else None
        if device_kind(x) == "cpu":
            out, saved = _attention_block_ref_parts(x, wqkv, gate_w, gate_b, wo, attn_norm,
                                                    rope, heads, n_valid, partial)
        else:
            out, saved = _attention_block_cuda(x, wqkv, gate_w, gate_b, wo, attn_norm, rope,
                                               heads, n_valid, tf32_weights, partial)
        ctx.save_for_backward(x, wqkv, gate_w, wo, attn_norm, cos, sin, *saved)
        ctx.heads, ctx.n_valid, ctx.partial = heads, n_valid, partial
        return out

    @staticmethod
    def backward(ctx, dy):
        x, wqkv, gate_w, wo, attn_norm, cos, sin, *saved = ctx.saved_tensors
        rope = (cos, sin) if cos is not None else None
        grads = attention_block_backward(dy, x, wqkv, gate_w, wo, attn_norm, rope, ctx.heads,
                                         ctx.n_valid, *saved, partial=ctx.partial)
        return (*grads, None, None, None, None, None, None)


class _FFBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ff_norm, w1, b1, w2, b2, tf32_weights):
        if device_kind(x) == "cpu":
            out, xn = _ff_block_ref_parts(x, ff_norm, w1, b1, w2, b2)
        else:
            out, xn = _ff_block_cuda(x, ff_norm, w1, b1, w2, b2, tf32_weights)
        ctx.save_for_backward(x, ff_norm, w1, b1, w2, xn)
        ctx.partial = b2 is None
        return out

    @staticmethod
    def backward(ctx, dy):
        dx, dnorm, dw1, db1, dw2, db2 = ff_block_backward(dy, *ctx.saved_tensors,
                                                          partial=ctx.partial)
        return dx, dnorm, dw1, db1, dw2, db2, None


# ---------------------------------------------------------------------------
# Wrappers.


def fused_attention_block(x: torch.Tensor, wqkv: torch.Tensor,
                          gate_w: torch.Tensor, gate_b: torch.Tensor,
                          wo: torch.Tensor, attn_norm: torch.Tensor,
                          rope: Optional[Tuple[torch.Tensor, torch.Tensor]],
                          heads: int, n_valid: int, *,
                          tf32_weights: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                          partial: bool = False) -> torch.Tensor:
    """``x (B, n_pad, d)`` → same shape; ``n_pad % 64 == 0``, key columns
    ``≥ n_valid`` masked. ``rope`` is ``(cos, sin)``, each ``(n_pad, dh)``.
    ``tf32_weights``: the prepared forms of ``(wqkv, wo)``
    (:func:`~audio_separator_tpu_torch.ops.tf32.prepare_tf32_weight`) for a
    float32 call on the card; made for the call where not given.
    ``partial``: the out projection alone, without the residual (the weights
    are then one shard's heads: ``wqkv``'s q, k and v columns of those heads,
    their gate columns and ``wo``'s rows). Differentiable in ``x`` and every
    weight, in float32 and in bf16 (the backward's bf16 kernel forms)."""
    b, n_pad, d = x.shape if x.dim() == 3 else (0, 0, 0)
    hd3 = wqkv.shape[-1] if wqkv.dim() == 2 else 0
    dh = hd3 // (3 * heads)
    expected = {"wqkv": (wqkv, (d, 3 * heads * dh)),
                "gate_w": (gate_w, (d, heads)), "gate_b": (gate_b, (heads,)),
                "wo": (wo, (heads * dh, d)), "attn_norm": (attn_norm, (d,))}
    if rope is not None:
        expected["cos"] = (rope[0], (n_pad, dh))
        expected["sin"] = (rope[1], (n_pad, dh))
    _check_tensors(x, n_valid, **expected)
    cos, sin = rope if rope is not None else (None, None)
    return _AttentionBlock.apply(x, wqkv, gate_w, gate_b, wo, attn_norm, cos, sin, heads,
                                 n_valid, tf32_weights, partial)


def fused_ff_block(x: torch.Tensor, ff_norm: torch.Tensor, w1: torch.Tensor,
                   b1: torch.Tensor, w2: torch.Tensor, b2: Optional[torch.Tensor], *,
                   tf32_weights: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                   partial: bool = False) -> torch.Tensor:
    """``x + FeedForward(rmsnorm(x))`` over ``x (B, n_pad, d)``.
    ``tf32_weights``: the prepared forms of ``(w1, w2)`` for a float32 call on
    the card; made for the call where not given. ``partial``: the second
    product alone, ``GELU(...)·W2`` without ``b2`` (pass ``b2=None``) and the
    residual, over one shard's hidden columns. Differentiable in ``x`` and
    every weight, in float32 and in bf16 (the backward's bf16 kernel forms)."""
    d = x.shape[-1] if x.dim() == 3 else 0
    hidden = w1.shape[-1] if w1.dim() == 2 else 0
    if partial != (b2 is None):
        raise ValueError("fused_ff_block: pass b2=None exactly when partial=True "
                         "(the partial form adds no bias)")
    expected = dict(ff_norm=(ff_norm, (d,)), w1=(w1, (d, hidden)), b1=(b1, (hidden,)),
                    w2=(w2, (hidden, d)))
    if b2 is not None:
        expected["b2"] = (b2, (d,))
    _check_tensors(x, None, **expected)
    return _FFBlock.apply(x, ff_norm, w1, b1, w2, b2, tf32_weights)
