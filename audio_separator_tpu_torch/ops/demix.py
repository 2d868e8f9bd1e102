"""Windowed overlap-add demixing on one device.

Port of the single-device path of
``audio_separator_tpu/ops/demix.overlap_add_demix``: the mix is uploaded once,
each window batch is gathered on the device, run through the model, weighted
by its window and accumulated, and the result is normalised and fetched once.
The window is either one ``(chunk,)`` vector shared by every position (the
window sum is then accumulated on the device) or ``(N, chunk)`` per-position
rows; an explicit ``divider`` replaces the accumulated window sum, and
``post_device_fn`` runs on the normalised device tensor before the fetch. The
window count is padded only to a multiple of ``batch_size`` (padding rows
carry zero weight).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


def window_positions(total: int, chunk: int, step: int) -> np.ndarray:
    """Clamped window starts: every ``i`` in ``range(0, total, step)``, with
    starts that would overrun clamped to ``total - chunk`` (duplicates kept)."""
    if total <= chunk:
        return np.zeros(1, dtype=np.int64)
    return np.asarray([i if i + chunk <= total else total - chunk
                       for i in range(0, total, step)], dtype=np.int64)


@torch.no_grad()
def overlap_add_demix(
    model_fn: Callable[[torch.Tensor], torch.Tensor],
    mix: np.ndarray,
    chunk: int,
    step: int,
    window: np.ndarray,
    num_stems: int,
    batch_size: int = 1,
    positions: Optional[np.ndarray] = None,
    divider: Optional[np.ndarray] = None,
    fetch_stems: Optional[tuple] = None,
    post_device_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    device="cuda",
) -> np.ndarray:
    """Demix ``mix (C, T)`` → ``(num_stems, C, T)`` (or ``len(fetch_stems)``
    stems, in that order).

    ``model_fn`` maps ``(B, C, chunk)`` float32 on ``device`` to
    ``(B, num_stems, C, chunk)``. ``window`` is the ``(chunk,)`` weight shared
    by every position, or ``(N, chunk)`` rows, one per position; ``positions``
    overrides the clamped default grid. ``divider (T_buf,)`` overrides the
    accumulated window sum as the normaliser (shorter dividers are extended
    with ones). ``post_device_fn`` maps the normalised ``(S, C, T_buf)`` device
    tensor (after ``fetch_stems``) to what is fetched, and owns its shape;
    without it the result is cropped to ``T``."""
    c, total = mix.shape
    if positions is None:
        positions = window_positions(total, chunk, step)
    positions = np.asarray(positions, dtype=np.int64)
    n = len(positions)
    n_pad = -(-n // batch_size) * batch_size
    t_buf = max(total, int(positions.max()) + chunk)
    window = np.asarray(window, np.float32)
    shared_window = window.ndim == 1
    if not shared_window and window.shape != (n, chunk):
        raise ValueError(f"window rows {window.shape} != (positions, chunk) {(n, chunk)}")

    mix_dev = torch.zeros((c, t_buf), dtype=torch.float32, device=device)
    mix_dev[:, :total] = torch.as_tensor(np.ascontiguousarray(mix, np.float32)).to(device)
    pos_dev = torch.zeros(n_pad, dtype=torch.int64, device=device)
    pos_dev[:n] = torch.as_tensor(positions).to(device)
    if shared_window:
        row_scale = torch.zeros(n_pad, dtype=torch.float32, device=device)
        row_scale[:n] = 1.0
        win_dev = torch.as_tensor(window).to(device)
    else:
        win_dev = torch.zeros((n_pad, chunk), dtype=torch.float32, device=device)
        win_dev[:n] = torch.as_tensor(window).to(device)
    offsets = torch.arange(chunk, device=device)

    acc = torch.zeros((num_stems, c, t_buf), dtype=torch.float32, device=device)
    wsum = (torch.zeros(t_buf, dtype=torch.float32, device=device)
            if divider is None else None)
    for i in range(0, n_pad, batch_size):
        idx = (pos_dev[i : i + batch_size, None] + offsets).reshape(-1)  # (B*chunk,)
        chunks = mix_dev[:, idx].reshape(c, batch_size, chunk).transpose(0, 1)
        out = model_fn(chunks.contiguous())  # (B, S, C, chunk)
        if shared_window:
            win_b = win_dev * row_scale[i : i + batch_size, None]  # (B, chunk)
        else:
            win_b = win_dev[i : i + batch_size]
        out = out.float() * win_b[:, None, None, :]
        acc.index_add_(2, idx, out.permute(1, 2, 0, 3).reshape(num_stems, c, -1))
        if wsum is not None:
            wsum.index_add_(0, idx, win_b.reshape(-1))
    if divider is None:
        acc = acc / wsum.clamp_min(1e-10)
    else:
        div = np.ones(t_buf, np.float32)
        div[: min(len(divider), t_buf)] = np.asarray(divider, np.float32)[:t_buf]
        acc = acc / torch.as_tensor(np.maximum(div, 1e-10)).to(device)
    if fetch_stems is not None:
        acc = acc[list(fetch_stems)]
    if post_device_fn is not None:
        return post_device_fn(acc).cpu().numpy()
    return acc[..., :total].cpu().numpy()


def demix_jobs(
    model_fn: Callable[[torch.Tensor], torch.Tensor],
    mixes: list,
    chunk: int,
    step: int,
    window: np.ndarray,
    num_stems: int,
    batch_size: int,
    fetch_stems: Optional[tuple] = None,
    device="cuda",
) -> list:
    """Cross-job window batching: demix K same-geometry mixes ``(C, T_i)`` in
    one engine pass and return per-job ``(num_stems, C, T_i)`` stems.

    The mixes lie end to end in one buffer, each spanning ``max(T_i, chunk)``
    so that a clamped window never reads a neighbour; the positions are each
    job's own window grid offset by its start, and the normaliser is the
    shared window sum. No window and no overlap-add crosses a job boundary,
    so each job's slice is its solo :func:`overlap_add_demix` result, while
    batch padding and the fetch are shared by the jobs.

    The JAX package groups jobs by peak when its host-device link transfers
    are quantised; this port has no quantised transfer, so every job always
    shares one pass.
    """
    if not mixes:
        return []
    c = mixes[0].shape[0]
    offs, lens, pos_parts = [], [], []
    cur = 0
    for m in mixes:
        if m.shape[0] != c:
            raise ValueError("demix_jobs: mixes must share channel count")
        t = int(m.shape[1])
        offs.append(cur)
        lens.append(t)
        pos_parts.append(window_positions(t, chunk, step) + cur)
        cur += max(t, chunk)
    mix_cat = np.zeros((c, cur), dtype=np.float32)
    for m, off, t in zip(mixes, offs, lens):
        mix_cat[:, off : off + t] = m
    out = overlap_add_demix(
        model_fn, mix_cat, chunk, step, window, num_stems=num_stems,
        batch_size=batch_size, positions=np.concatenate(pos_parts),
        fetch_stems=fetch_stems, device=device)
    return [out[..., off : off + t] for off, t in zip(offs, lens)]
