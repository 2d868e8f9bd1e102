"""STFT / iSTFT with ``torch.stft`` semantics.

The JAX package emulates ``torch.stft`` / ``torch.istft`` (center=True,
reflect padding, least-squares inverse); here those are called directly. The
windows are computed in float64 with numpy and then cast, exactly as the JAX
package computes them, so both sides start from the same bits.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def hann_window(n: int, periodic: bool = True, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """Periodic Hann window, identical to ``torch.hann_window(n, periodic=True)``."""
    m = n if periodic else n - 1
    i = np.arange(n, dtype=np.float64)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * i / max(m, 1))
    return torch.as_tensor(w, dtype=dtype, device=device)


def hamming_window(n: int, periodic: bool = False, dtype=torch.float32,
                   device=None) -> torch.Tensor:
    """Hamming window matching ``scipy.signal.windows.hamming`` (symmetric)."""
    m = n if periodic else n - 1
    i = np.arange(n, dtype=np.float64)
    w = 0.54 - 0.46 * np.cos(2.0 * np.pi * i / max(m, 1))
    return torch.as_tensor(w, dtype=dtype, device=device)


def stft(x: torch.Tensor, n_fft: int, hop: int, window: torch.Tensor,
         center: bool = True, pad_mode: str = "reflect") -> torch.Tensor:
    """``x (..., L)`` real → ``(..., n_fft//2 + 1, T)`` complex64."""
    lead = x.shape[:-1]
    spec = torch.stft(x.reshape(-1, x.shape[-1]).float(), n_fft, hop,
                      window=window.to(x.device, torch.float32),
                      center=center, pad_mode=pad_mode, return_complex=True)
    return spec.reshape(*lead, *spec.shape[-2:])


def istft(spec: torch.Tensor, n_fft: int, hop: int, window: torch.Tensor,
          center: bool = True, length: Optional[int] = None) -> torch.Tensor:
    """``(..., F, T)`` complex → ``(..., L)`` real, ``L = hop * (T - 1)`` for
    ``center=True`` unless ``length`` is given.

    The imaginary parts of the DC and Nyquist bins are zeroed first. A real
    inverse FFT ignores them on the CPU (pocketfft, and the JAX package's
    irfft), but cuFFT's C2R transform does not for every plan: measured on
    an H100, a masked flagship spectrum (4 × 1025 × 801) came back at 38 dB
    SDR against the CPU inverse until they were zeroed."""
    lead = spec.shape[:-2]
    spec = spec.clone()
    spec[..., 0, :].imag.zero_()
    if n_fft % 2 == 0:
        spec[..., -1, :].imag.zero_()
    out = torch.istft(spec.reshape(-1, *spec.shape[-2:]), n_fft, hop,
                      window=window.to(spec.device, torch.float32),
                      center=center, length=length)
    return out.reshape(*lead, out.shape[-1])


def stft_real_packed(x: torch.Tensor, n_fft: int, hop: int, window: torch.Tensor,
                     dim_f: int) -> torch.Tensor:
    """MDX-style packed STFT: ``(..., C, L)`` → ``(..., C*2, dim_f, T)``
    float32, the channel axis interleaved per input channel as
    ``[c0_re, c0_im, c1_re, c1_im]`` and cropped to the lowest ``dim_f``
    bins."""
    spec = stft(x, n_fft, hop, window)  # (..., C, F, T)
    packed = torch.stack([spec.real, spec.imag], dim=-3)  # (..., C, 2, F, T)
    shape = packed.shape
    packed = packed.reshape(*shape[:-4], shape[-4] * 2, shape[-2], shape[-1])
    return packed[..., :dim_f, :]


def istft_real_packed(packed: torch.Tensor, n_fft: int, hop: int,
                      window: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`stft_real_packed`: ``(..., C*2, dim_f, T)`` is
    zero-padded on the frequency axis to ``n_fft//2 + 1`` bins and inverted
    to ``(..., C, L)``."""
    n_bins = n_fft // 2 + 1
    *batch, c2, dim_f, t = packed.shape
    if dim_f < n_bins:
        packed = torch.nn.functional.pad(packed, (0, 0, 0, n_bins - dim_f))
    packed = packed.float().reshape(*batch, c2 // 2, 2, n_bins, t)
    spec = torch.complex(packed[..., 0, :, :], packed[..., 1, :, :])
    return istft(spec, n_fft, hop, window)
