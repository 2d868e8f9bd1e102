"""The VR multiband chain on the device: analyze → (mask) → finalize →
synthesize.

Port of the JAX package's ``ops/vr_chain.py`` (ref: uvr_lib_v5/
spec_utils.py:232-470, vr_separator.py:255-375): the wave goes up once and
the two stems come down once; the per-band resample cascade, the STFTs, the
band combine and pre-filter, the mask's TTA average and aggression, the
optional high-end mirroring and the per-band iSTFT → filter → resample
synthesis run as PyTorch on the wave's device.

The JAX chain pads a track to a length bucket so that one compiled program
serves many lengths, and carries a frame-validity vector and true-length
masks to stay equal to the exact-shape chain. The port compiles nothing, so
it runs at the track's true length: every one of those masks is then the
identity and is left out, and the plain inverse STFT is the exact-shape
inverse. The length arithmetic (:func:`chain_frames`, :func:`synth_out_len`)
is the JAX package's, so both chains give the same lengths.

``reverse`` geometries flip each band's wave before its STFT and its iSTFT
output back; the v5.1 nets' per-band ``convert_channels`` transforms replace
the v5 ``mid_side`` / ``mid_side_b2`` ones, in the reference's precedence.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import numpy as np
import torch

from .resample import _gcd_ratio, resample_torch
from .stft import hann_window, istft, stft

# ----------------------------------------------------------------- geometry


def band_geometry(mp: Dict, is_v51: bool) -> tuple:
    """The static geometry of a VR model-parameters dict: per band ``(sr,
    hl, n_fft, crop_start, crop_stop, lpf_start, lpf_stop, hpf_start,
    hpf_stop, convert_channels)``, then ``bins``, the pre-filter range, the
    ``mid_side``, ``mid_side_b2`` and ``reverse`` flags and ``is_v51``."""
    bands = []
    for d in range(1, len(mp["band"]) + 1):
        bp = mp["band"][d]
        bands.append((
            int(bp["sr"]), int(bp["hl"]), int(bp["n_fft"]),
            int(bp["crop_start"]), int(bp["crop_stop"]),
            int(bp.get("lpf_start", 0)), int(bp.get("lpf_stop", 0)),
            int(bp.get("hpf_start", 0)), int(bp.get("hpf_stop", 0)),
            bp.get("convert_channels", ""),
        ))
    return (
        tuple(bands), int(mp["bins"]),
        int(mp.get("pre_filter_start", 0)), int(mp.get("pre_filter_stop", 0)),
        bool(mp.get("mid_side")), bool(mp.get("mid_side_b2")),
        bool(mp.get("reverse")), bool(is_v51),
    )


def _res_len(n: int, sr_from: int, sr_to: int) -> int:
    """Output length of the polyphase resampler: ``ceil(n · up / down)``."""
    if sr_from == sr_to:
        return n
    up, down = _gcd_ratio(sr_from, sr_to)
    return -(-n * up // down)


def _wave_lengths(geom: tuple, t: int) -> list:
    """Per-band wave lengths (index 0 = band 1) for ``t`` samples at the
    highest band's rate."""
    bands = geom[0]
    lens = [0] * len(bands)
    lens[-1] = t
    for d in range(len(bands) - 2, -1, -1):
        lens[d] = _res_len(lens[d + 1], bands[d + 1][0], bands[d][0])
    return lens


def chain_frames(geom: tuple, t: int) -> int:
    """Combined-spectrogram frame count for a ``t``-sample input: the least
    of the bands' STFT frame counts."""
    return min(1 + lw // bp[1] for lw, bp in zip(_wave_lengths(geom, t), geom[0]))


def synth_out_len(geom: tuple, n_frame: int) -> int:
    """Wave length the synthesis cascade gives for ``n_frame`` frames: each
    band's iSTFT length, the running sum cropped to the shorter member and
    resampled up to the next band's rate."""
    bands = geom[0]
    wave_len: Optional[int] = None
    for d, band in enumerate(bands):
        ln = band[1] * (n_frame - 1)
        if d == len(bands) - 1:
            return ln if wave_len is None else min(wave_len, ln)
        ln = ln if wave_len is None else min(wave_len, ln)
        wave_len = _res_len(ln, band[0], bands[d + 1][0])
    raise AssertionError("unreachable")


# ------------------------------------------------------------ static filters
# Deterministic in the band JSON: built once in numpy (the reference's per-bin
# loops, spec_utils.fft_lp_filter / fft_hp_filter:400-430) and applied as one
# product.


def _lp_mask_v51(n_bins: int, start: int, stop: int) -> np.ndarray:
    return np.concatenate([
        np.ones((start - 1, 1), np.float32),
        np.linspace(1, 0, stop - start + 1, dtype=np.float32)[:, None],
        np.zeros((n_bins - stop, 1), np.float32),
    ], axis=0)


def _hp_mask_v51(n_bins: int, start: int, stop: int) -> np.ndarray:
    return np.concatenate([
        np.zeros((stop + 1, 1), np.float32),
        np.linspace(0, 1, 1 + start - stop, dtype=np.float32)[:, None],
        np.ones((n_bins - start - 2, 1), np.float32),
    ], axis=0)


def _lp_mask_v5(n_bins: int, start: int, stop: int) -> np.ndarray:
    mask = np.ones((n_bins, 1), np.float32)
    g = 1.0
    for b in range(start, stop):
        g -= 1.0 / (stop - start)
        mask[b] = g
    mask[stop:] = 0.0
    return mask


def _hp_mask_v5(n_bins: int, start: int, stop: int) -> np.ndarray:
    mask = np.ones((n_bins, 1), np.float32)
    g = 1.0
    for b in range(start, stop, -1):
        g -= 1.0 / (start - stop)
        mask[b] = g
    mask[: stop + 1] = 0.0
    return mask


def _prefilter_gp_mask(n_bins: int, start: int, stop: int) -> np.ndarray:
    """The v5 multiband pre-filter cascade (spec_utils.combine_spectrograms:270)."""
    mask = np.ones((n_bins, 1), np.float32)
    gp = 1.0
    for b in range(start + 1, stop):
        g = math.pow(10, -(b - start) * (3.5 - gp) / 20.0)
        gp = g
        mask[b] = g
    return mask


_MASKS = {"lp_v5": _lp_mask_v5, "lp_v51": _lp_mask_v51, "hp_v5": _hp_mask_v5,
          "hp_v51": _hp_mask_v51, "prefilter": _prefilter_gp_mask}


@functools.lru_cache(maxsize=256)
def _mask(kind: str, n_bins: int, start: int, stop: int, device: torch.device) -> torch.Tensor:
    """A filter column on ``device``, uploaded once (an upload per call would
    make the host wait for the device's queue)."""
    return torch.as_tensor(_MASKS[kind](n_bins, start, stop), device=device)


@functools.lru_cache(maxsize=64)
def _window(n_fft: int, device: torch.device) -> torch.Tensor:
    return hann_window(n_fft, device=device)


# ------------------------------------------------------------------- analyze


def _convert_channels_fwd(spec: torch.Tensor, cc: str) -> torch.Tensor:
    """v5.1 per-band channel transform (spec_utils.convert_channels:236)."""
    if cc == "mid_side_c":
        return torch.stack([spec[0] + spec[1] * 0.25, spec[1] - spec[0] * 0.25])
    if cc == "mid_side":
        return torch.stack([(spec[0] + spec[1]) / 2, spec[0] - spec[1]])
    if cc == "stereo_n":
        return torch.stack([(spec[0] + spec[1] * 0.25) / 0.9375,
                            (spec[1] + spec[0] * 0.25) / 0.9375])
    return spec


def _convert_channels_inv(wave: torch.Tensor, cc: str) -> torch.Tensor:
    """The inverse transform after the iSTFT (spec_utils.spectrogram_to_wave:315)."""
    left, right = wave[..., 0, :], wave[..., 1, :]
    if cc == "mid_side_c":
        return torch.stack([left / 1.0625 - right / 4.25, right / 1.0625 + left / 4.25], dim=-2)
    if cc == "mid_side":
        return torch.stack([left + right / 2, left - right / 2], dim=-2)
    if cc == "stereo_n":
        return torch.stack([left - right * 0.25, right - left * 0.25], dim=-2)
    return wave


def high_end_height(geom: tuple) -> int:
    """Rows of the top band kept for high-end mirroring (0: none)."""
    bands, _, pre_start, pre_stop = geom[:4]
    return (bands[-1][2] // 2 - bands[-1][4]) + (pre_stop - pre_start)


def analyze(geom: tuple, wave: torch.Tensor):
    """``wave (2, T)`` float32 at the top band's rate → ``(spec_c (2, bins+1,
    n_frame) complex64, input_high_end (2, h, n_frame) | None)``: per-band
    resample cascade, constant-pad STFT, channel transforms, band combine and
    pre-filter (ref: vr_separator.py:255-293)."""
    bands, bins, pre_start, pre_stop, mid_side, mid_side_b2, reverse, is_v51 = geom
    n_bands = len(bands)
    lb = chain_frames(geom, wave.shape[-1])
    specs = {}
    w = wave
    for d in range(n_bands - 1, -1, -1):
        if d < n_bands - 1:
            w = resample_torch(w, bands[d + 1][0], bands[d][0])
        x = w
        if not is_v51:
            # The reference's if/elif precedence (spec_utils.wave_to_spectrogram:282-313).
            if reverse:
                x = torch.flip(x, dims=(-1,))
            elif mid_side:
                x = torch.stack([(x[0] + x[1]) / 2, x[0] - x[1]])
            elif mid_side_b2:
                x = torch.stack([x[1] + x[0] * 0.5, x[0] - x[1] * 0.5])
        s = stft(x, bands[d][2], bands[d][1], _window(bands[d][2], x.device), pad_mode="constant")
        specs[d] = _convert_channels_fwd(s, bands[d][9]) if is_v51 else s

    he_h = high_end_height(geom)
    high_end = None
    if he_h > 0:
        nf2 = bands[-1][2] // 2
        high_end = specs[n_bands - 1][:, nf2 - he_h : nf2, :lb]

    rows = [specs[d][:, bands[d][3] : bands[d][4], :lb] for d in range(n_bands)]
    used = sum(b[4] - b[3] for b in bands)
    if used > bins:
        raise ValueError("Too much bins")
    rows.append(rows[0].new_zeros((2, bins + 1 - used, lb)))
    spec_c = torch.cat(rows, dim=1)
    if pre_start > 0:
        kind = "lp_v51" if is_v51 else "lp_v5" if n_bands == 1 else "prefilter"
        spec_c = spec_c * _mask(kind, bins + 1, pre_start, pre_stop, spec_c.device)
    return spec_c, high_end


# ------------------------------------------------------------------ finalize


def _adjust_aggr(mask: torch.Tensor, is_non_accom_stem: bool, aggressiveness: Dict) -> torch.Tensor:
    """Aggression shaping (spec_utils.adjust_aggr:472)."""
    aggr = aggressiveness["value"] * 2
    if aggr == 0:
        return mask
    if is_non_accom_stem:
        aggr = 1 - aggr
    aggr_lr = [aggr, aggr]
    corr = aggressiveness.get("aggr_correction")
    if corr is not None:
        aggr_lr[0] += corr["left"]
        aggr_lr[1] += corr["right"]
    split = aggressiveness["split_bin"]
    return torch.stack([
        torch.cat([torch.pow(mask[ch, :split], 1 + aggr_lr[ch] / 3),
                   torch.pow(mask[ch, split:], 1 + aggr_lr[ch])], dim=0)
        for ch in range(2)])


def _fit(m: torch.Tensor, n_frame: int) -> torch.Tensor:
    if m.shape[-1] >= n_frame:
        return m[:, :, :n_frame]
    return torch.nn.functional.pad(m, (0, n_frame - m.shape[-1]))


def finalize(mask: torch.Tensor, n_frame: int, roi: int, aggressiveness: Dict,
             is_non_accom_stem: bool, mask_tta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The tiled mask fitted to ``n_frame`` frames, averaged with the
    half-roi-shifted TTA mask when there is one (vr_separator.py:308-320),
    then aggression-shaped. Runs before the optional host post-process, in
    the reference's order."""
    m = _fit(mask, n_frame)
    if mask_tta is not None:
        m = (m + _fit(mask_tta[:, :, roi // 2 :], n_frame)) * 0.5
    return _adjust_aggr(m, is_non_accom_stem, aggressiveness)


# ---------------------------------------------------------------- synthesize


def _mirroring(spec: torch.Tensor, high_end: torch.Tensor, pre_start: int,
               he_h: int) -> torch.Tensor:
    """"mirroring" high-end reconstruction (spec_utils.mirroring:458)."""
    mirror = torch.flip(torch.abs(spec[..., pre_start - 10 - he_h : pre_start - 10, :]),
                        dims=(-2,))
    mirror = mirror * torch.exp(1j * torch.angle(high_end))
    return torch.where(torch.abs(high_end) <= torch.abs(mirror), high_end, mirror)


def synthesize(geom: tuple, mask: torch.Tensor, spec_c: torch.Tensor,
               input_high_end: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``mask (2, bins+1, n_frame)`` (aggression-shaped), ``spec_c`` →
    ``waves (2 stems, 2, synth_out_len)``: both stems' spectra
    (mask · |spec| · phase, NaN scrubbed), the optional high-end mirroring,
    and the per-band iSTFT → filter → resample-up cascade of
    spec_utils.cmb_spectrogram_to_wave:341 (ref: vr_separator.py:337-375)."""
    bands, bins, pre_start, pre_stop, mid_side, mid_side_b2, reverse, is_v51 = geom
    n_bands = len(bands)
    he_h = high_end_height(geom)
    dev = spec_c.device
    phase = torch.exp(1j * torch.angle(spec_c))
    mag = torch.abs(spec_c)
    spec_pair = torch.nan_to_num(torch.stack([mask * mag * phase, (1 - mask) * mag * phase]),
                                 nan=0.0, posinf=0.0, neginf=0.0)

    extra = None
    if input_high_end is not None and he_h > 0:
        extra = torch.stack([_mirroring(spec_pair[s], input_high_end, pre_start, he_h)
                             for s in range(2)])

    def band_wave(spec_s: torch.Tensor, d: int) -> torch.Tensor:
        wave = istft(spec_s, bands[d][2], bands[d][1], _window(bands[d][2], dev))
        if is_v51:
            return _convert_channels_inv(wave, bands[d][9])
        if reverse:
            return torch.flip(wave, dims=(-1,))
        left, right = wave[..., 0, :], wave[..., 1, :]
        if mid_side:
            return torch.stack([left + right / 2, left - right / 2], dim=-2)
        if mid_side_b2:
            return torch.stack([right / 1.25 + 0.4 * left, left / 1.25 - 0.4 * right], dim=-2)
        return wave

    lp, hp = ("lp_v51", "hp_v51") if is_v51 else ("lp_v5", "hp_v5")
    offset = 0
    wave = None
    for d, (sr, hl, n_fft, crop_lo, crop_hi, lpf_lo, lpf_hi, hpf_lo, hpf_hi, _) in \
            enumerate(bands):
        n_bins_d = n_fft // 2 + 1
        h = crop_hi - crop_lo
        spec_s = torch.nn.functional.pad(spec_pair[:, :, offset : offset + h],
                                         (0, 0, crop_lo, n_bins_d - crop_hi))
        offset += h
        if d == n_bands - 1:  # the highest band
            if extra is not None:
                spec_s[:, :, n_fft // 2 - he_h : n_fft // 2] = extra[:, :, :he_h]
            if hpf_lo > 0:
                spec_s = spec_s * _mask(hp, n_bins_d, hpf_lo, hpf_hi - 1, dev)
            top = band_wave(spec_s, d)
            if wave is None:
                return top
            n_out = min(wave.shape[-1], top.shape[-1])
            return wave[..., :n_out] + top[..., :n_out]
        if d == 0:  # the lowest band
            spec_s = spec_s * _mask(lp, n_bins_d, lpf_lo, lpf_hi, dev)
            wave = band_wave(spec_s, d)
        else:
            spec_s = (spec_s * _mask(hp, n_bins_d, hpf_lo, hpf_hi - 1, dev)
                      * _mask(lp, n_bins_d, lpf_lo, lpf_hi, dev))
            mid = band_wave(spec_s, d)
            n_mid = min(wave.shape[-1], mid.shape[-1])
            wave = wave[..., :n_mid] + mid[..., :n_mid]
        wave = resample_torch(wave, sr, bands[d + 1][0])
    raise AssertionError("unreachable")
