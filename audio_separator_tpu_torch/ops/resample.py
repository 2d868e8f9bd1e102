"""Polyphase resampling: on the host with scipy, and on the tensor's device.

Port of the JAX package's ``ops/resample.py``. ``resample_poly_np`` is
``scipy.signal.resample_poly``; ``resample_torch`` computes the same
polyphase filter (scipy's default design: Kaiser β 5, 10 taps a zero
crossing) as a strided convolution of the zero-stuffed signal, on whatever
device the tensor lies. The VR multiband chain (``ops/vr_chain.py``) runs it
for every band, whatever resampler a band's JSON names.
"""

from __future__ import annotations

import functools
import logging
from fractions import Fraction

import numpy as np
import scipy.signal
import torch
import torch.nn.functional as F

from .precision import full_float32


def _gcd_ratio(orig_sr: int, new_sr: int) -> tuple[int, int]:
    exact = Fraction(new_sr, orig_sr)
    frac = exact.limit_denominator(1 << 16)
    if frac != exact:
        # A bounded filter length needs a bounded denominator, so the rate is
        # approximated: say so rather than drift silently.
        logging.getLogger(__name__).warning(
            f"resample ratio {new_sr}/{orig_sr} approximated as "
            f"{frac.numerator}/{frac.denominator}")
    return frac.numerator, frac.denominator


def resample_poly_np(x: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
    """Polyphase resample of ``(..., samples)`` float32."""
    if orig_sr == new_sr:
        return x
    up, down = _gcd_ratio(orig_sr, new_sr)
    return scipy.signal.resample_poly(x, up, down, axis=-1).astype(x.dtype)


@functools.lru_cache(maxsize=64)
def _design_filter(up: int, down: int, window_beta: float = 5.0) -> np.ndarray:
    """Kaiser-windowed sinc low-pass, scipy.resample_poly's default design
    (window ``('kaiser', 5.0)``, 10 taps a zero crossing), float64."""
    max_rate = max(up, down)
    half_len = 10 * max_rate
    h = scipy.signal.firwin(2 * half_len + 1, 1.0 / max_rate, window=("kaiser", window_beta))
    return (h * up).astype(np.float64)


@functools.lru_cache(maxsize=64)
def _filter_tensor(up: int, down: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The time-reversed filter on ``device``, made once: an upload per call
    would make the host wait for the device's queue."""
    return torch.as_tensor(_design_filter(up, down)[::-1].copy(), dtype=dtype, device=device)


def resample_torch(x: torch.Tensor, orig_sr: int, new_sr: int) -> torch.Tensor:
    """Polyphase resample of ``(..., samples)`` float32 on ``x``'s device,
    ``ceil(n * new_sr / orig_sr)`` samples out.

    Zero-stuff by ``up``, pad ``half`` taps ahead and enough behind, and
    correlate with the time-reversed filter at stride ``down``: the JAX
    package's ``conv_general_dilated`` with input dilation, written out. The
    convolution runs under ``full_float32``: TF32 would round the filter's
    0.50025874 centre tap to 0.5 (about 54 dB)."""
    if orig_sr == new_sr:
        return x
    up, down = _gcd_ratio(orig_sr, new_sr)
    h = _filter_tensor(up, down, x.dtype, x.device)
    lead = x.shape[:-1]
    flat = x.reshape(-1, x.shape[-1])
    n_in = flat.shape[-1]
    n_out = -(-n_in * up // down)
    n_taps = h.shape[0]
    half = (n_taps - 1) // 2
    n_up = (n_in - 1) * up + 1
    pad_hi = max(0, (n_out - 1) * down + n_taps - half - n_up)
    stuffed = flat.new_zeros(flat.shape[0], half + n_up + pad_hi)
    stuffed[:, half : half + n_up : up] = flat
    with full_float32():
        out = F.conv1d(stuffed[:, None], h[None, None], stride=down)
    return out[:, 0, :n_out].reshape(*lead, n_out)


def change_pitch_semitones_np(pcm: np.ndarray, sample_rate: int,
                              semitone_shift: float) -> tuple[np.ndarray, int]:
    """Resample-trick pitch shift. Returns ``(shifted_pcm, playback_rate)``
    with ``playback_rate = round(sample_rate / 2**(shift/12))``."""
    factor = 2.0 ** (semitone_shift / 12.0)
    new_rate = int(round(sample_rate / factor))
    return resample_poly_np(pcm, orig_sr=sample_rate, new_sr=new_rate), new_rate
