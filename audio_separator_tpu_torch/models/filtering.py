"""Multichannel Wiener filtering with EM refinement (norbert-style).

Port of ``audio_separator_tpu/models/filtering.py``. Used by the Demucs
magnitude head (``cac=False``): the head's raw output seeds the source
estimates with the mixture's phase, and the EM refines them against the
mixture. Complex arithmetic is native complex64, and the 2×2 spatial
covariance inverses are closed-form, as in the JAX package. The contractions
run in full float32 (``ops/precision.full_float32``): the statistics are
computed in float32 upstream.

Shapes:
    y   (frames, bins, channels, sources)  complex — source estimates
    x   (frames, bins, channels)           complex — mixture STFT
"""

from __future__ import annotations

import torch

from ..ops.precision import full_float32


def _invert2(m: torch.Tensor, eps: float) -> torch.Tensor:
    """Closed-form inverse of ``(..., C, C)`` complex matrices for C in
    {1, 2}; ``torch.linalg.inv`` otherwise."""
    c = m.shape[-1]
    if c == 1:
        return 1.0 / (m + eps)
    if c == 2:
        det = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
        inv_det = 1.0 / (det + eps)
        out = torch.stack([
            torch.stack([m[..., 1, 1], -m[..., 0, 1]], dim=-1),
            torch.stack([-m[..., 1, 0], m[..., 0, 0]], dim=-1),
        ], dim=-2)
        return out * inv_det[..., None, None]
    return torch.linalg.inv(m)


def expectation_maximization(y: torch.Tensor, x: torch.Tensor, iterations: int = 2,
                             eps: float = 1e-10) -> torch.Tensor:
    """EM refinement of source estimates: ``y (T, F, C, S)`` complex and
    ``x (T, F, C)`` complex → refined ``y``."""
    channels = x.shape[-1]
    identity = torch.eye(channels, dtype=x.dtype, device=x.device)
    with full_float32():
        for _ in range(iterations):
            # power spectral densities: mean |y|² over channels → (T, F, S)
            v = (y.abs() ** 2).mean(dim=2)
            # spatial covariance per source, averaged over frames → (F, C, C, S)
            cov = torch.einsum("tfcs,tfds->fcds", y, y.conj())
            weight = v.sum(dim=0) + eps  # (F, S)
            r = cov / weight[:, None, None, :]
            # mixture covariance (T, F, C, C)
            cxx = torch.einsum("tfs,fcds->tfcd", v.to(x.dtype), r)
            cxx = cxx + eps ** 0.5 * identity
            inv_cxx = _invert2(cxx, eps)
            # Wiener gains per source, applied to the mixture
            gain = torch.einsum("fcds,tfde->tfces", r, inv_cxx) \
                * v[..., None, None, :].to(x.dtype)
            y = torch.einsum("tfces,tfe->tfcs", gain, x)
    return y


def wiener(targets_spectrograms: torch.Tensor, mix_stft: torch.Tensor,
           iterations: int = 1, softmask: bool = False, residual: bool = False,
           scale_factor: float = 10.0, eps: float = 1e-10) -> torch.Tensor:
    """Wiener-based separation: ``targets_spectrograms (T, F, C, S)`` real
    (the raw head output) and ``mix_stft (T, F, C)`` complex →
    ``(T, F, C, S)`` complex estimates (``S + 1`` with ``residual``)."""
    if softmask:
        ratio = targets_spectrograms / (
            eps + targets_spectrograms.sum(dim=-1, keepdim=True))
        y = mix_stft[..., None] * ratio.to(mix_stft.dtype)
    else:
        phase = mix_stft / mix_stft.abs().clamp_min(1e-12)
        y = targets_spectrograms.to(mix_stft.dtype) * phase[..., None]

    if residual:
        res = mix_stft[..., None] - y.sum(dim=-1, keepdim=True)
        y = torch.cat([y, res], dim=-1)

    if iterations == 0:
        return y

    max_abs = torch.clamp(mix_stft.abs().max() / scale_factor, min=1.0)
    y = expectation_maximization(y / max_abs, mix_stft / max_abs, iterations, eps=eps)
    return y * max_abs
