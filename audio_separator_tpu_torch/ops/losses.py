"""Training losses: the multi-resolution STFT loss the RoFormer models ship
for fine-tuning (upstream ``bs_roformer.py:519-562``, and
``mel_band_roformer.py``'s identical block), over the port's STFT.

Port of ``audio_separator_tpu/ops/losses.py``. ``torch.stft`` is
differentiable, so these losses take part in the training step's autograd
graph as they are; inference never calls them.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from .stft import hann_window, stft

DEFAULT_RESOLUTIONS: Tuple[int, ...] = (4096, 2048, 1024, 512, 256)


def _l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``F.l1_loss`` semantics, complex inputs included (mean ``|a - b|``)."""
    return (a - b).abs().mean()


def multi_res_stft_loss(recon: torch.Tensor, target: torch.Tensor,
                        stft_n_fft: int = 2048,
                        window_sizes: Sequence[int] = DEFAULT_RESOLUTIONS,
                        hop_length: int = 147) -> torch.Tensor:
    """Sum over resolutions of the L1 between complex STFTs of ``recon`` and
    ``target`` (``(..., T)`` each): ``n_fft = max(window, stft_n_fft)``, a
    Hann window of the resolution's size centre-padded to ``n_fft``, hop
    ``hop_length``."""
    flat_r = recon.reshape(-1, recon.shape[-1])
    flat_t = target.reshape(-1, target.shape[-1])
    total = torch.zeros((), dtype=torch.float32, device=recon.device)
    for w in window_sizes:
        n_fft = max(int(w), int(stft_n_fft))
        win = hann_window(int(w), device=recon.device)
        if w < n_fft:
            lp = (n_fft - w) // 2
            win = F.pad(win, (lp, n_fft - w - lp))
        total = total + _l1(stft(flat_r, n_fft, hop_length, win),
                            stft(flat_t, n_fft, hop_length, win))
    return total


def roformer_training_loss(recon: torch.Tensor, target: torch.Tensor,
                           stft_n_fft: int = 2048,
                           window_sizes: Sequence[int] = DEFAULT_RESOLUTIONS,
                           hop_length: int = 147, multi_stft_weight: float = 1.0):
    """``total = L1(recon, target) + multi_stft_weight · multi-res STFT loss``
    over the model output ``recon (B, S?, C, T)`` and ``target`` (cut to
    ``recon``'s length). Returns ``(total, (l1, multi_res))``."""
    target = target[..., : recon.shape[-1]]
    base = _l1(recon, target)
    multi = multi_res_stft_loss(recon, target, stft_n_fft=stft_n_fft,
                                window_sizes=window_sizes, hop_length=hop_length)
    return base + multi_stft_weight * multi, (base, multi)
