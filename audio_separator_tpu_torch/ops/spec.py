"""Host-side waveform helpers used by the separators (numpy in and out).

Port of the JAX package's ``ops/spec.py``: peak normalisation, shape
matching, the VR helpers (magnitude and phase, window padding), and the
spectral inversion of a stem against its mixture
(``invert_stem``, the MDX secondary under ``invert_using_spec``), whose STFT
runs in torch on the device given.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .stft import hann_window, istft, stft


def normalize(wave: np.ndarray, max_peak: float = 1.0,
              min_peak: float | None = None) -> np.ndarray:
    """Scale down to ``max_peak`` if louder; scale up to ``min_peak`` if a
    non-silent wave is quieter."""
    maxv = np.abs(wave).max()
    if maxv > max_peak:
        return wave * (max_peak / maxv)
    if min_peak is not None and 0 < maxv < min_peak:
        return wave * (min_peak / maxv)
    return wave


def preprocess(spec: np.ndarray):
    """Complex spectrogram → (magnitude, phase) (ref: spec_utils.preprocess:74)."""
    return np.abs(spec), np.angle(spec)


def make_padding(width: int, cropsize: int, offset: int):
    """Left and right padding so ``width`` frames tile into windows of
    ``cropsize`` with ``offset`` borders, and the tile stride
    (ref: spec_utils.make_padding:85)."""
    left = offset
    roi_size = cropsize - offset * 2
    if roi_size == 0:
        roi_size = cropsize
    right = roi_size - (width % roi_size) + left
    return left, right, roi_size


_INV_N_FFT = 2048
_INV_HOP = 1024


def _stft2048(wave: np.ndarray, device="cpu") -> np.ndarray:
    spec = stft(torch.as_tensor(wave.astype(np.float32), device=device), _INV_N_FFT,
                _INV_HOP, hann_window(_INV_N_FFT, device=device), pad_mode="constant")
    return spec.cpu().numpy()


def _istft2048(spec: np.ndarray, device="cpu") -> np.ndarray:
    wave = istft(torch.as_tensor(spec, device=device), _INV_N_FFT, _INV_HOP,
                 hann_window(_INV_N_FFT, device=device))
    out = wave.cpu().numpy()
    if out.ndim == 1:
        out = np.stack([out, out])
    return out


def invert_audio(specs: List[np.ndarray], invert_p: bool = True) -> np.ndarray:
    """Spectral inversion of a stem against the mixture
    (ref: spec_utils.invert_audio:557-573)."""
    ln = min(specs[0].shape[2], specs[1].shape[2])
    a, b = specs[0][:, :, :ln], specs[1][:, :, :ln]
    if invert_p:
        max_mag = np.maximum(np.abs(a), np.abs(b))
        return b - max_mag * np.exp(1.0j * np.angle(a))
    # ref else-branch (spec_utils.py:568-570): soften the stem first, then
    # subtract it from the mixture.
    b = reduce_vocal_aggressively(a, b, 0.2)
    return a - b


def invert_stem(mixture: np.ndarray, stem: np.ndarray, device="cpu") -> np.ndarray:
    """Derive the secondary stem by spectral subtraction
    (ref: spec_utils.invert_stem:575-580). Input/output are (samples, channels)
    transposed arrays as in the reference call sites; the STFTs run on
    ``device``."""
    mix_spec = _stft2048(mixture.T if mixture.shape[0] != 2 else mixture, device)
    stem_spec = _stft2048(stem.T if stem.shape[0] != 2 else stem, device)
    out = _istft2048(invert_audio([mix_spec, stem_spec]), device)
    return -out.T


def to_shape(x: np.ndarray, target_shape) -> np.ndarray:
    """Zero-pad trailing edges so ``x`` matches ``target_shape``
    (ref: spec_utils.to_shape)."""
    pads = [(0, t - s) for s, t in zip(x.shape, target_shape)]
    return np.pad(x, pads, mode="constant")


def match_array_shapes(a: np.ndarray, b: np.ndarray, is_swap: bool = False) -> np.ndarray:
    """Crop or zero-pad ``a``'s time axis (axis 1) to ``b``'s."""
    if is_swap:
        a, b = a.T, b.T
    if a.shape[1] > b.shape[1]:
        a = a[:, : b.shape[1]]
    elif a.shape[1] < b.shape[1]:
        a = np.pad(a, ((0, 0), (0, b.shape[1] - a.shape[1])), mode="constant")
    if is_swap:
        a = a.T
    return a


def match_mono_array_shapes(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Crop or zero-pad the 1-D ``a`` to ``len(b)``."""
    if len(a) > len(b):
        return a[: len(b)]
    if len(a) < len(b):
        return np.pad(a, (0, len(b) - len(a)), mode="constant")
    return a


def reduce_vocal_aggressively(x_spec: np.ndarray, y_spec: np.ndarray,
                              softmask: float) -> np.ndarray:
    """(ref: spec_utils.reduce_vocal_aggressively)."""
    v_spec = x_spec - y_spec
    y_mag_tmp = np.abs(y_spec)
    v_mag_tmp = np.abs(v_spec)
    v_mask = v_mag_tmp > y_mag_tmp
    y_mag = np.clip(y_mag_tmp - v_mag_tmp * v_mask * softmask, 0, np.inf)
    return y_mag * np.exp(1.0j * np.angle(y_spec))
