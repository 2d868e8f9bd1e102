"""Track alignment toolkit (UVR "align inputs" tooling counterpart).

Own copy of the JAX package's ``ops/align.py`` (numpy and scipy only).
Functional re-design of the reference's alignment utilities
(ref: uvr_lib_v5/spec_utils.py:793-1267 — align_audio, adjust_leading_silence,
check_if_phase_inverted, phase_shift_hilbert, time_correction, ensemble_wav):
cross-correlation global shift, per-window fine alignment, phase handling.
These are offline tools (not on the separation hot path), kept in numpy/scipy.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
from scipy.signal import hilbert


def _cross_correlate(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    n = len(a) + len(b) - 1
    nfft = 1 << int(np.ceil(np.log2(n)))
    corr = np.fft.irfft(np.fft.rfft(a, nfft) * np.conj(np.fft.rfft(b, nfft)), nfft)
    return np.concatenate([corr[-(len(b) - 1):], corr[: len(a)]])


def best_shift(a: np.ndarray, b: np.ndarray) -> int:
    """Lag that best aligns ``b`` to ``a`` (positive → delay b),
    via FFT cross-correlation (ref get_diff: spec_utils.py:960-964)."""
    corr = _cross_correlate(a, b)
    return int(np.argmax(corr) - (len(b) - 1))


def best_shift_and_phase(a: np.ndarray, b: np.ndarray) -> Tuple[int, bool]:
    """Joint lag + phase-inversion estimate: the strongest |correlation| peak;
    a negative peak means ``b`` is phase-inverted relative to ``a``."""
    corr = _cross_correlate(a, b)
    peak = int(np.argmax(np.abs(corr)))
    return peak - (len(b) - 1), bool(corr[peak] < 0)


def check_if_phase_inverted(wav1: np.ndarray, wav2: np.ndarray,
                            is_mono: bool = False) -> bool:
    """(ref: spec_utils.check_if_phase_inverted)."""
    a = wav1 if is_mono else wav1.mean(axis=0)
    b = wav2 if is_mono else wav2.mean(axis=0)
    n = min(len(a), len(b), 44100 * 10)
    pos = float(np.dot(a[:n], b[:n]))
    return pos < 0


def adjust_leading_silence(target: np.ndarray, reference: np.ndarray,
                           silence_threshold: float = 0.01) -> np.ndarray:
    """Trim/pad target's leading silence to match the reference's
    (ref: spec_utils.adjust_leading_silence)."""
    def leading_silence(x):
        mono = x if x.ndim == 1 else np.abs(x).max(axis=0)
        above = np.nonzero(np.abs(mono) >= silence_threshold)[0]
        return int(above[0]) if len(above) else len(mono)

    t_sil = leading_silence(target)
    r_sil = leading_silence(reference)
    diff = t_sil - r_sil
    if diff == 0:
        return target
    if diff > 0:  # target has more silence → trim
        return target[..., diff:]
    pad = [(0, 0)] * (target.ndim - 1) + [(-diff, 0)]
    return np.pad(target, pad)


def shift_track(wav: np.ndarray, shift: int) -> np.ndarray:
    """Apply an integer sample shift (positive delays the track)."""
    if shift == 0:
        return wav
    pad = [(0, 0)] * (wav.ndim - 1)
    if shift > 0:
        return np.pad(wav, pad + [(shift, 0)])[..., : wav.shape[-1]]
    return np.pad(wav[..., -shift:], pad + [(0, -shift)])


def phase_shift_hilbert(signal: np.ndarray, degree: float) -> np.ndarray:
    """Constant phase shift via the analytic signal
    (ref: spec_utils.phase_shift_hilbert:1114)."""
    analytic = hilbert(signal, axis=-1)
    rad = np.deg2rad(degree)
    return np.cos(rad) * analytic.real - np.sin(rad) * analytic.imag


def get_phase_shifted_tracks(track: np.ndarray, phase_shift: int) -> list:
    """Variants of ``track`` phase-rotated in ``phase_shift``-degree steps
    (ref: spec_utils.get_phase_shifted_tracks:1119-1131): always includes the
    identity and the polarity flip; finer steps add ±Hilbert rotations."""
    if phase_shift == 180:
        return [track, -track]
    step = phase_shift
    end = 180 - (180 % step) if 180 % step == 0 else 181
    flipped = [track, -track]
    for deg in range(step, end, step):
        flipped.extend([phase_shift_hilbert(track, deg),
                        phase_shift_hilbert(track, -deg)])
    return flipped


def time_correction(
    mix: np.ndarray,
    instrumental: np.ndarray,
    align_window: Sequence[float] = (0.08, 0.12, 0.25),
    db_analysis: Tuple[float, Sequence[float]] = (0.0, (0.0,)),
    sample_rate: int = 44100,
    phase_shifts: Optional[int] = None,
    ensemble_split_size: int = 12,
) -> np.ndarray:
    """Windowed drift-tolerant vocal extraction: ``mix − align(instrumental)``.

    Re-design of the reference's ``time_correction``
    (ref: spec_utils.py:1134-1243): for each window size in ``align_window``,
    slide a half-overlapping Hann window over both tracks; inside each window
    try every dB adjustment in ``db_analysis`` (center gain + offsets) and
    every phase variant (``phase_shifts`` in degrees; None = identity only),
    align by the strongest |cross-correlation| peak (circular ``roll``, as the
    reference does), keep the candidate whose residual ``mix − shifted`` has
    the least mean |amplitude|, and overlap-add the residuals. The per-window-
    size results are combined with the least-noisy-chunk waveform ensemble
    (ops/spec.ensemble_wav).

    Accepts mono ``(T,)`` or channel-first ``(C, T)`` arrays (the repo-wide
    layout; the reference uses (T, C)).
    """
    from .spec import ensemble_wav

    assert mix.shape == instrumental.shape, (
        f"Audio files must have the same shape - Mix: {mix.shape}, "
        f"Inst: {instrumental.shape}")
    mono = mix.ndim == 1
    mix2 = mix[None, :] if mono else mix
    inst2 = instrumental[None, :] if mono else instrumental

    center_db, db_range = db_analysis
    inst2 = inst2 * np.power(10.0, center_db / 20.0)

    def align_window_pair(wm: np.ndarray, wi: np.ndarray) -> np.ndarray:
        variants = ([wi] if phase_shifts is None
                    else get_phase_shifted_tracks(wi, phase_shifts))
        best_resid, best = None, None
        for db_adj in db_range:
            gain = 10.0 ** (db_adj / 20.0)
            for cand in variants:
                adj = cand * gain
                corr = _cross_correlate(wm, adj)
                delay = int(np.argmax(np.abs(corr))) - (len(wm) - 1)
                shifted = np.roll(adj, delay)
                resid = float(np.abs(wm - shifted).mean())
                if best_resid is None or resid < best_resid:
                    best_resid, best = resid, shifted
        return best

    subs = {}
    for secs in align_window:
        window_size = int(sample_rate * secs)
        step_size = int(sample_rate * secs / 2)
        window = np.hanning(window_size)
        sub = np.zeros_like(mix2)
        divider = np.zeros_like(mix2)
        for ch in range(mix2.shape[0]):
            for i in range(0, mix2.shape[1] - window_size, step_size):
                wm = mix2[ch, i : i + window_size] * window
                wi = inst2[ch, i : i + window_size] * window
                aligned = align_window_pair(wm, wi)
                sub[ch, i : i + window_size] += wm - aligned
                divider[ch, i : i + window_size] += window
        sub = np.where(divider > 1e-6, sub / divider, sub)
        subs[float(np.abs(sub).mean())] = sub

    out = ensemble_wav(list(subs.values()), split_size=ensemble_split_size)
    return out[0] if mono else out


def align_tracks(
    wav1: np.ndarray,
    wav2: np.ndarray,
    sample_rate: int = 44100,
    align_window_seconds: Sequence[float] = (0.125, 0.25, 0.5),
    probe_positions: Sequence[int] = (1, 10, 4, 2),
    auto_phase: bool = True,
    match_silence: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Align ``wav2`` to ``wav1`` and return (wav2_aligned, wav1 − wav2_aligned).

    Mirrors the reference align_audio flow (spec_utils.py:937-1110): optional
    phase-inversion detection, leading-silence match, global shift estimated
    from probe segments, then per-window fine shifts chosen to minimise
    residual energy.
    """
    mono = wav1.ndim == 1
    a, b = wav1, wav2
    if match_silence:
        b = adjust_leading_silence(b, a)

    a_m = a if mono else a.mean(axis=0)
    b_m = b if mono else b.mean(axis=0)
    seconds = min(len(a_m), len(b_m)) // sample_rate

    # Global shift (+ phase): probe several positions, take the median.
    shifts, inversions = [], []
    for div in probe_positions:
        sec = 1 if div == 1 else max(1, int(seconds // div))
        idx = sample_rate * sec
        if idx + sample_rate > min(len(a_m), len(b_m)):
            continue
        lag, inverted = best_shift_and_phase(a_m[idx : idx + sample_rate],
                                             b_m[idx : idx + sample_rate])
        shifts.append(lag)
        inversions.append(inverted)
    global_shift = int(np.median(shifts)) if shifts else 0
    if auto_phase and inversions and sum(inversions) * 2 > len(inversions):
        b = -b
    b = shift_track(b, global_shift)

    n = min(a.shape[-1], b.shape[-1])
    a, b = a[..., :n], b[..., :n]

    # Per-window fine alignment: choose the window size whose residual is
    # smallest per block (ref: time_correction windowed subtraction).
    best = b.copy()
    win = int(align_window_seconds[-1] * sample_rate) if align_window_seconds else 0
    if win > 0:
        out = np.zeros_like(b)
        for start in range(0, n, win):
            sl = slice(start, min(start + win, n))
            seg_a = a[..., sl]
            candidates = [b[..., sl]]
            for w_sec in align_window_seconds:
                max_lag = int(w_sec * sample_rate / 8)
                a_seg_m = seg_a if mono else seg_a.mean(axis=0)
                b_seg_m = b[..., sl] if mono else b[..., sl].mean(axis=0)
                lag = best_shift(a_seg_m, b_seg_m)
                lag = int(np.clip(lag, -max_lag, max_lag))
                candidates.append(shift_track(b[..., sl], lag))
            residuals = [float(np.sum((seg_a - c[..., : seg_a.shape[-1]]) ** 2))
                         for c in candidates]
            out[..., sl] = candidates[int(np.argmin(residuals))][..., : seg_a.shape[-1]]
        best = out
    return best, a - best
