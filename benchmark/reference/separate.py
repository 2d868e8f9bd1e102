"""Plain separation of a song into stems, the reference the song and service
cells are judged against.

Written from the algorithms the program states, in numpy and PyTorch, with
no code of the program:

* the WAV codec: 16-bit PCM read as ``int / 32768`` and written as
  ``round(clip(x) · 32767)``;
* the MDXC (RoFormer) path: the mix scaled down to a 0.9 peak, windows of
  ``hop · (dim_t − 1)`` samples every ``min(overlap · rate, chunk)``
  samples, the last start clamped to the end, a symmetric Hamming weight,
  the weighted sum divided by the summed weights; the target stem, the
  residual stem (mix minus target), each scaled down to a 0.9 peak;
* the Demucs path: the mix standardised by its mono mean and deviation, the
  shift trick (``shifts`` offsets drawn by ``numpy.random.default_rng(0)``
  from ``[0, rate / 2]``, each shift the mix delayed by its offset in a
  ``rate / 2``-padded copy, ``length + rate / 2`` samples long), each shift
  split into training-length windows every ``(1 − overlap) · segment``
  samples with triangular weights and centred context for the tail, the
  shifts realigned and averaged, the scale restored, each stem scaled down
  to a 0.9 peak.

The Demucs window plan follows the program's statement of it (the JAX
package's and the port's): every shift is split over ``length + rate / 2``
samples, where upstream ``demucs.apply`` splits ``length + rate / 2 −
offset``. Both are the shift trick; the window grids differ.
"""

from __future__ import annotations

import re
import wave

import numpy as np
import torch

STEM_IN_NAME = re.compile(r"_\(([^)]+)\)_")


def read_wav(path: str) -> tuple:
    """``(int16 samples (channels, frames), rate)`` of a 16-bit PCM WAV."""
    with wave.open(path, "rb") as w:
        if w.getsampwidth() != 2:
            raise ValueError(f"{path}: {8 * w.getsampwidth()}-bit, expected 16")
        ch, rate, n = w.getnchannels(), w.getframerate(), w.getnframes()
        raw = w.readframes(n)
    return np.frombuffer(raw, dtype="<i2").reshape(-1, ch).T, rate


def write_wav(path: str, pcm: np.ndarray, rate: int) -> None:
    """Float ``(channels, frames)`` as 16-bit PCM."""
    ints = np.round(np.clip(pcm, -1.0, 1.0).T * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(pcm.shape[0])
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(ints.tobytes())


def decode(path: str) -> np.ndarray:
    pcm, _ = read_wav(path)
    pcm = pcm.astype(np.float32) / 32768.0
    return np.stack([pcm[0], pcm[0]]) if pcm.shape[0] == 1 else pcm


def peak_limit(wave_: np.ndarray, peak: float = 0.9) -> np.ndarray:
    top = float(np.abs(wave_).max())
    return wave_ * (peak / top) if top > peak else wave_


def hamming(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    return (0.54 - 0.46 * np.cos(2.0 * np.pi * i / max(n - 1, 1))).astype(np.float32)


def triangle(segment: int) -> np.ndarray:
    tri = np.concatenate([np.arange(1, segment // 2 + 1),
                          np.arange(segment - segment // 2, 0, -1)]).astype(np.float32)
    return tri / tri.max()


def mdxc_windows(total: int, chunk: int, step: int) -> list:
    if total <= chunk:
        return [0]
    return [i if i + chunk <= total else total - chunk for i in range(0, total, step)]


@torch.no_grad()
def run_batches(model, windows: np.ndarray, device, batch: int) -> np.ndarray:
    """``model`` over ``(N, 2, L)`` windows, ``batch`` at a time →
    ``(N, S, 2, L)``."""
    outs = []
    for i in range(0, len(windows), batch):
        x = torch.as_tensor(windows[i : i + batch], device=device)
        y = model(x)
        if y.shape[-1] < x.shape[-1]:
            y = torch.nn.functional.pad(y, (0, x.shape[-1] - y.shape[-1]))
        outs.append(y[..., : x.shape[-1]].float().cpu().numpy())
    return np.concatenate(outs)


def separate_mdxc(model, mix: np.ndarray, cfg: dict, params: dict, device,
                  batch: int = 4) -> dict:
    """``{stem: (2, T) float}`` as written, for a RoFormer with one target
    stem and its residual."""
    audio, model_cfg = cfg["audio"], cfg["model"]
    dim_t = int(cfg["inference"]["dim_t"])
    chunk = int(model_cfg["stft_hop_length"]) * (dim_t - 1)
    step = min(int(params.get("overlap", 8) * int(audio["sample_rate"])), chunk) or chunk
    mix = peak_limit(mix.astype(np.float32))
    total = mix.shape[1]
    starts = mdxc_windows(total, chunk, step)
    span = max(total, max(starts) + chunk)
    buf = np.zeros((2, span), np.float32)
    buf[:, :total] = mix
    outs = run_batches(model, np.stack([buf[:, s : s + chunk] for s in starts]), device, batch)
    win = hamming(chunk)
    acc = np.zeros((outs.shape[1], 2, span), np.float64)
    wsum = np.zeros(span, np.float64)
    for s, out in zip(starts, outs):
        acc[..., s : s + chunk] += out * win
        wsum[s : s + chunk] += win
    target = (acc / np.maximum(wsum, 1e-10))[0, :, :total].astype(np.float32)
    training = cfg["training"]
    other = [name for name in training["instruments"] if name != training["target_instrument"]]
    return {training["target_instrument"]: peak_limit(target),
            other[0]: peak_limit(mix - target)}


def separate_demucs(model, mix: np.ndarray, sources: list, params: dict, device,
                    batch: int = 4) -> dict:
    """``{source: (2, T) float}`` as written, for one HTDemucs with the
    shift trick over the training-length split."""
    shifts, overlap = int(params.get("shifts", 2)), float(params.get("overlap", 0.25))
    mix = mix.astype(np.float32)
    mono = mix.astype(np.float64).mean(axis=0)
    mean, std = mono.mean(), mono.std(ddof=1)
    norm = ((mix - mean) / (std + 1e-20)).astype(np.float32)
    length = norm.shape[1]
    max_shift = int(0.5 * model.samplerate)
    rng = np.random.default_rng(0)
    offsets = [int(rng.integers(0, max_shift + 1)) for _ in range(shifts)]
    padded = np.pad(norm, ((0, 0), (max_shift, max_shift)))
    segment = model.training_length
    stride = int((1 - overlap) * segment)
    tri = triangle(segment)
    track_len = length + max_shift
    out = np.zeros((len(sources), 2, length), np.float64)
    for offset in offsets:
        track = padded[:, offset : offset + track_len]
        lead = segment  # zeros either side give the tail windows their context
        buf = np.zeros((2, lead + track_len + 2 * segment), np.float32)
        buf[:, lead : lead + track_len] = track
        plan = []
        for start in range(0, track_len, stride):
            chunk_len = min(segment, track_len - start)
            delta = segment - chunk_len
            plan.append((start, chunk_len, lead + start - delta // 2, delta // 2))
        windows = np.stack([buf[:, p : p + segment] for _, _, p, _ in plan])
        res = run_batches(model, windows, device, batch)
        acc = np.zeros((len(sources), 2, track_len), np.float64)
        wsum = np.zeros(track_len, np.float64)
        for (start, chunk_len, _, skip), est in zip(plan, res):
            w = tri[:chunk_len]
            acc[..., start : start + chunk_len] += est[..., skip : skip + chunk_len] * w
            wsum[start : start + chunk_len] += w
        out += (acc / np.maximum(wsum, 1e-10))[..., max_shift - offset :][..., :length]
    stems = (out / shifts * std + mean).astype(np.float32)
    return {name: peak_limit(stems[i]) for i, name in enumerate(sources)}


def stem_errors(files: list, reference: dict) -> dict:
    """``{stem: ||written − reference|| / ||reference||}`` in 16-bit units,
    the reference rounded to 16 bits as the codec writes it, so that what the
    two sides agree on reads 0 and a last-bit flip 1; for the written WAV
    files, matched to the reference's stems by the ``_(<stem>)_`` in their
    names. A stem missing on either side, or of another shape, reads
    infinity."""
    found = {}
    for path in files:
        m = STEM_IN_NAME.search(path.rsplit("/", 1)[-1])
        if m:
            found[m.group(1).lower()] = path
    errors = {}
    for name, ref in reference.items():
        path = found.get(name.lower())
        if path is None:
            errors[name] = float("inf")
            continue
        got, _ = read_wav(path)
        want = np.round(np.clip(ref.astype(np.float64), -1.0, 1.0) * 32767.0)
        if got.shape != want.shape:
            errors[name] = float("inf")
            continue
        errors[name] = float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))
    return errors
