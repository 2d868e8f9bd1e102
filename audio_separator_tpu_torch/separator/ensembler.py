"""Multi-model output ensembling: the 11 algorithms of the JAX package's
``separator/ensembler.py`` (ref: ensembler.py:6-156).

The waveform algorithms run in numpy, as in the JAX package, so that their
results are the same bits. The spectral ones (``*_fft``, ``uvr_*_spec``) take
the STFT (n_fft 2048, hop 1024, periodic Hann, constant padding), combine the
spectra and invert them with torch on the separator's device.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops import spec as spec_ops

ALGORITHMS = (
    "avg_wave", "median_wave", "min_wave", "max_wave",
    "avg_fft", "median_fft", "min_fft", "max_fft",
    "uvr_max_spec", "uvr_min_spec", "ensemble_wav",
)


def _select_by(arr: np.ndarray, axis: int, key, use_max: bool) -> np.ndarray:
    idxs = (np.argmax if use_max else np.argmin)(key(arr), axis)
    idxs = np.expand_dims(idxs, axis)
    return np.squeeze(np.take_along_axis(arr, idxs, axis), axis=axis)


def _select_by_magnitude(specs: torch.Tensor, use_max: bool) -> torch.Tensor:
    """Per bin, the spectrum of largest (smallest) magnitude; ties to the
    first, as ``np.argmax`` / ``np.argmin``."""
    mag = specs.abs()
    idx = (mag.argmax if use_max else mag.argmin)(dim=0, keepdim=True)
    return torch.take_along_dim(specs, idx, dim=0)[0]


def _median(x: torch.Tensor) -> torch.Tensor:
    """``np.median`` over axis 0: the mean of the two middle values for an
    even count (``torch.median`` takes the lower one)."""
    v = x.sort(dim=0).values
    n = x.shape[0]
    return (v[(n - 1) // 2] + v[n // 2]) / 2


class Ensembler:
    def __init__(self, logger: Optional[logging.Logger] = None,
                 algorithm: str = "avg_wave", weights: Optional[Sequence[float]] = None,
                 device="cpu"):
        self.logger = logger or logging.getLogger(__name__)
        self.algorithm = algorithm
        self.weights = weights
        self.device = torch.device(device)

    def ensemble(self, waveforms: List[np.ndarray]) -> Optional[np.ndarray]:
        """Ensemble ``(channels, length)`` waveforms into one; shorter inputs
        are zero-padded to the longest."""
        if not waveforms:
            return None
        if len(waveforms) == 1:
            return waveforms[0]

        channels = waveforms[0].shape[0]
        if any(w.shape[0] != channels for w in waveforms):
            raise ValueError("All waveforms must have the same number of channels")
        max_len = max(w.shape[1] for w in waveforms)
        waveforms = [
            np.pad(w, ((0, 0), (0, max_len - w.shape[1]))) if w.shape[1] < max_len else w
            for w in waveforms
        ]

        weights = self._validated_weights(len(waveforms))
        algo = self.algorithm

        if algo == "avg_wave":
            acc = np.zeros_like(waveforms[0])
            for w, wt in zip(waveforms, weights):
                acc += w * wt
            return acc / np.sum(weights)
        if algo == "median_wave":
            self._warn_weights_ignored(weights)
            return np.median(np.array(waveforms), axis=0)
        if algo == "min_wave":
            self._warn_weights_ignored(weights)
            return _select_by(np.array(waveforms), 0, np.abs, use_max=False)
        if algo == "max_wave":
            self._warn_weights_ignored(weights)
            return _select_by(np.array(waveforms), 0, np.abs, use_max=True)
        if algo in ("avg_fft", "median_fft", "min_fft", "max_fft"):
            return self._ensemble_fft(waveforms, weights)
        if algo == "uvr_max_spec":
            return spec_ops.ensemble_spec_waves(spec_ops.MAX_SPEC, waveforms, self.device)
        if algo == "uvr_min_spec":
            return spec_ops.ensemble_spec_waves(spec_ops.MIN_SPEC, waveforms, self.device)
        if algo == "ensemble_wav":
            return spec_ops.ensemble_wav(waveforms)
        raise ValueError(f"Unknown ensemble algorithm: {algo}")

    # ------------------------------------------------------------------ utils

    def _validated_weights(self, n: int) -> np.ndarray:
        if self.weights is None:
            return np.ones(n)
        weights = np.array(self.weights, dtype=np.float64)
        if len(weights) != n:
            self.logger.warning(
                f"Number of weights ({len(weights)}) does not match number of "
                f"waveforms ({n}); using equal weights")
            return np.ones(n)
        total = weights.sum()
        if not np.all(np.isfinite(weights)) or not np.isfinite(total) or total == 0:
            self.logger.warning("Weights invalid (non-finite or zero-sum); using equal weights")
            return np.ones(n)
        return weights

    def _warn_weights_ignored(self, weights: np.ndarray):
        if self.weights is not None and not np.all(weights == weights[0]):
            self.logger.warning(f"Weights are ignored for algorithm {self.algorithm}")

    def _spec(self, wave: np.ndarray) -> torch.Tensor:
        """A mono wave is duplicated to two channels first."""
        if wave.ndim == 1:
            wave = np.stack([wave, wave])
        elif wave.shape[0] == 1:
            wave = np.vstack([wave, wave])
        return spec_ops.stft2048(torch.as_tensor(wave.astype(np.float32), device=self.device))

    def _ensemble_fft(self, waveforms, weights) -> np.ndarray:
        channels = waveforms[0].shape[0]
        final_len = waveforms[0].shape[-1]
        specs = torch.stack([self._spec(w) for w in waveforms])
        if self.algorithm == "avg_fft":
            wt = torch.as_tensor(weights, dtype=torch.float32, device=self.device)
            out = (specs * wt[:, None, None, None]).sum(dim=0) / float(np.sum(weights))
        else:
            self._warn_weights_ignored(weights)
            if self.algorithm == "median_fft":
                out = torch.complex(_median(specs.real), _median(specs.imag))
            else:
                out = _select_by_magnitude(specs, use_max=self.algorithm == "max_fft")
        wave = spec_ops.istft2048(out, length=final_len).cpu().numpy()
        if channels == 1:
            wave = wave[:1, :]
        return wave
