"""Time-stretch / pitch-shift — first-party phase-vocoder implementation.

Own copy of the JAX package's ``ops/stretch.py`` (numpy only, over the port's
``ops/resample.resample_poly_np``).

The reference shells out to the rubberband CLI for these
(ref: audio_separator/separator/uvr_lib_v5/pyrb.py:23-92, used by the
spec_utils alignment/augmentation cold paths). This framework implements the
equivalent natively: an identity-phase-locked phase vocoder for time
stretching and a stretch+polyphase-resample combination for pitch shifting —
no subprocess, no temp files, deterministic.

Cold path: host numpy (these utilities run on one track during alignment
tooling, not inside the demix engine).
"""

from __future__ import annotations

import numpy as np

from .resample import resample_poly_np

__all__ = ["time_stretch", "pitch_shift", "augment_audio"]


def _stft_np(x: np.ndarray, n_fft: int, hop: int, win: np.ndarray) -> np.ndarray:
    pad = n_fft // 2
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="reflect")
    n_frames = 1 + (xp.shape[-1] - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = xp[..., idx] * win
    return np.fft.rfft(frames, axis=-1)  # (..., T, F)


def _istft_np(spec: np.ndarray, n_fft: int, hop: int, win: np.ndarray,
              length: int) -> np.ndarray:
    frames = np.fft.irfft(spec, n=n_fft, axis=-1) * win
    *batch, n_frames, _ = frames.shape
    total = n_fft + hop * (n_frames - 1)
    y = np.zeros((*batch, total), dtype=np.float64)
    env = np.zeros(total, dtype=np.float64)
    wsq = win * win
    for t in range(n_frames):
        y[..., t * hop : t * hop + n_fft] += frames[..., t, :]
        env[t * hop : t * hop + n_fft] += wsq
    y = y / np.maximum(env, 1e-11)
    pad = n_fft // 2
    y = y[..., pad:]
    return y[..., :length]


def time_stretch(y: np.ndarray, sr: int, rate: float,
                 n_fft: int = 2048) -> np.ndarray:
    """Stretch ``y`` to ``1/rate`` of its duration at constant pitch.

    ``rate > 1`` speeds up (shorter output); ``rate < 1`` slows down —
    same convention as ``pyrb.time_stretch`` / rubberband ``--tempo``.
    Accepts ``(T,)`` mono or ``(T, C)`` frames-first audio (the reference's
    soundfile convention) and returns the same layout.
    """
    if rate <= 0:
        raise ValueError(f"rate must be positive, got {rate}")
    if rate == 1.0:
        return np.asarray(y, dtype=np.float32).copy()

    y = np.asarray(y, dtype=np.float64)
    frames_first = y.ndim == 2
    x = y.T if frames_first else y[None, :]  # (C, T)

    hop = n_fft // 4
    win = np.hanning(n_fft + 1)[:n_fft]
    spec = _stft_np(x, n_fft, hop, win)  # (C, T, F)
    c, n_frames, n_bins = spec.shape

    # Analysis positions in input-frame coordinates for each output frame.
    out_frames = max(2, int(np.ceil(n_frames / rate)))
    steps = np.minimum(np.arange(out_frames) * rate, n_frames - 1)
    lo = np.floor(steps).astype(int)
    hi = np.minimum(lo + 1, n_frames - 1)
    frac = (steps - lo)[None, :, None]

    mag = (1.0 - frac) * np.abs(spec[:, lo]) + frac * np.abs(spec[:, hi])

    # Phase propagation: accumulate per-bin instantaneous frequency.
    omega = 2.0 * np.pi * hop * np.arange(n_bins) / n_fft  # expected advance
    phase = np.angle(spec)
    dphase = phase[:, hi] - phase[:, lo] - omega
    dphase -= 2.0 * np.pi * np.round(dphase / (2.0 * np.pi))
    inst = omega + dphase  # (C, out_frames, F) instantaneous advance

    acc = np.empty_like(inst)
    acc[:, 0] = phase[:, lo[0]]
    np.cumsum(inst[:, :-1], axis=1, out=acc[:, 1:])
    acc[:, 1:] += phase[:, lo[0]][:, None, :]

    out_spec = mag * np.exp(1j * acc)
    out_len = int(round(x.shape[-1] / rate))
    out = _istft_np(out_spec, n_fft, hop, win, out_len).astype(np.float32)
    return out.T if frames_first else out[0]


def pitch_shift(y: np.ndarray, sr: int, n_steps: float,
                n_fft: int = 2048) -> np.ndarray:
    """Shift pitch by ``n_steps`` semitones at constant duration
    (``pyrb.pitch_shift`` / rubberband ``--pitch`` semantics).
    """
    if n_steps == 0:
        return np.asarray(y, dtype=np.float32).copy()
    factor = 2.0 ** (n_steps / 12.0)
    # Stretch to factor× duration (pitch unchanged), then resample the length
    # back down by 1/factor — decimation scales all frequencies by `factor`.
    stretched = time_stretch(y, sr, 1.0 / factor, n_fft=n_fft)

    frames_first = stretched.ndim == 2
    x = stretched.T if frames_first else stretched[None, :]
    # resample_poly with integer ratio approximation of 1/factor
    from fractions import Fraction

    frac = Fraction(factor).limit_denominator(1000)
    out = resample_poly_np(x, frac.numerator, frac.denominator)
    y_arr = np.asarray(y)
    target = y_arr.shape[0] if frames_first else y_arr.shape[-1]
    if out.shape[-1] < target:
        out = np.pad(out, [(0, 0), (0, target - out.shape[-1])])
    out = out[..., :target].astype(np.float32)
    return out.T if frames_first else out[0]


def augment_audio(
    export_path: str,
    audio_file: str,
    rate: float,
    is_normalization: bool = False,
    bit_depth: int = 16,
    is_pitch: bool = False,
    is_time_correction: bool = True,
) -> str:
    """Offline augmentation: stretch or pitch-shift a file and write the result
    (ref: spec_utils.augment_audio:793-820 — there via the rubberband CLI and
    soundfile; here via the first-party phase vocoder and the native codec).

    ``is_time_correction=False`` uses the resample trick (pitch + tempo change
    together, written at the original rate); otherwise ``is_pitch`` selects
    pitch-shift (constant tempo) vs time-stretch (constant pitch).
    """
    from ..io.audio import load_audio, save_audio
    from .resample import change_pitch_semitones_np
    from .spec import normalize, to_shape

    pcm, sr = load_audio(audio_file, sample_rate=44100, channels=2)  # (C, T)
    if not is_time_correction:
        mix, _ = change_pitch_semitones_np(pcm, 44100, -rate)
    elif is_pitch:
        mix = pitch_shift(pcm.T, sr, rate).T
    else:
        chans = [time_stretch(ch, sr, rate) for ch in pcm]
        longest = max(ch.shape[-1] for ch in chans)
        mix = np.stack([to_shape(ch, (longest,)) for ch in chans])
    if is_normalization:
        mix = normalize(mix)
    save_audio(export_path, mix.astype(np.float32), sr, bit_depth=bit_depth)
    return export_path
