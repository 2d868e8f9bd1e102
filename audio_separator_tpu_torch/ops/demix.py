"""Windowed overlap-add demixing on one device or over a device mesh.

Port of ``audio_separator_tpu/ops/demix.overlap_add_demix``: the mix is uploaded once,
each window batch is gathered on the device, run through the model, weighted
by its window and accumulated, and the result is normalised and fetched once.
The window is either one ``(chunk,)`` vector shared by every position (the
window sum is then accumulated on the device) or ``(N, chunk)`` per-position
rows; an explicit ``divider`` replaces the accumulated window sum, and
``post_device_fn`` runs on the normalised device tensor before the fetch. The
window count is padded only to a multiple of ``batch_size`` (padding rows
carry zero weight).

With a ``mesh`` (``parallel/mesh.Mesh``) the windows are independent work on
its data axis, as in the JAX package: the batch is rounded up to a multiple
of the mesh's local rows, each row's slice is copied to that row's first
device and run there, and the outputs come back to the mesh's first device,
where the overlap-add, the normalisation and ``post_device_fn`` run. The
slices are enqueued one after another with no host sync between them.
``model_fn`` is called with each row's slice on that row's device and must
compute there (the architectures pick the model's replica for the tensor's
device). The model axis is the model's business: a tensor-parallel module
runs its shards where they lie.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


def _mesh_geometry(mesh, batch_size: int, device):
    """``(batch_size, device, rows)``: the batch rounded up to a multiple of the
    mesh's local rows (JAX ``ops/demix.py``), the device where the results
    meet and each row's device; without a mesh, the arguments and None."""
    if mesh is None:
        return batch_size, device, None
    rows = mesh.row_devices()
    return -(-batch_size // len(rows)) * len(rows), mesh.first, rows


def _run_rows(model_fn: Callable, batch: torch.Tensor, rows) -> torch.Tensor:
    """``model_fn`` over ``batch`` split into one slice a mesh row (none:
    one call), each on its row's device, the outputs joined on ``batch``'s."""
    if rows is None:
        return model_fn(batch)
    outs = [model_fn(part.to(dev, non_blocking=True)).to(batch.device, non_blocking=True)
            for part, dev in zip(batch.tensor_split(len(rows)), rows) if len(part)]
    return torch.cat(outs)


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
    mesh=None,
) -> np.ndarray:
    """Demix ``mix (C, T)`` → ``(num_stems, C, T)`` (or ``len(fetch_stems)``
    stems, in that order). ``mesh``: split every window batch over its data
    axis (the module docstring); ``device`` is then the mesh's first.

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
    batch_size, device, rows = _mesh_geometry(mesh, batch_size, device)
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
        out = _run_rows(model_fn, chunks.contiguous(), rows)  # (B, S, C, chunk)
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
    mesh=None,
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
        fetch_stems=fetch_stems, device=device, mesh=mesh)
    return [out[..., off : off + t] for off, t in zip(offs, lens)]


def demix_jobs_layout(
    model_fn: Callable[[torch.Tensor], torch.Tensor],
    jobs: list,
    chunk: int,
    step: int,
    num_stems: int,
    batch_size: int,
    fetch_stems: Optional[tuple] = None,
    device="cuda",
    mesh=None,
) -> list:
    """Cross-job window batching for architectures whose demix uses an
    explicit per-job layout: ``jobs`` is a list of ``(mixture (C, total_i),
    positions_i (N_i,), windows_i (N_i, chunk), divider_i (total_i,))``
    tuples, e.g. MDX's trim-padded mixtures with per-position
    ``np.hanning(actual)`` tail windows and a host divider
    (``architectures/mdx.py``). Returns each job's full accumulator
    ``(num_stems, C, total_i)``; callers crop their own trim.

    Each job spans at least its widest window, so a gather never reads a
    neighbour's samples, and its divider normalises only its own span (ones
    past its end), so each job's slice is its solo
    :func:`overlap_add_demix` result."""
    if not jobs:
        return []
    c = jobs[0][0].shape[0]
    offs, lens, pos_parts, win_parts, div_parts = [], [], [], [], []
    cur = 0
    for mixture, positions, windows, divider in jobs:
        if mixture.shape[0] != c:
            raise ValueError("demix_jobs_layout: jobs must share channel count")
        t = int(mixture.shape[1])
        positions = np.asarray(positions, dtype=np.int64)
        span = max(t, int(positions.max()) + chunk)
        offs.append(cur)
        lens.append(t)
        pos_parts.append(positions + cur)
        win_parts.append(np.asarray(windows, dtype=np.float32))
        div = np.ones(span, dtype=np.float32)
        div[: len(divider)] = divider
        div_parts.append(div)
        cur += span
    mix_cat = np.zeros((c, cur), dtype=np.float32)
    for (mixture, *_), off, t in zip(jobs, offs, lens):
        mix_cat[:, off : off + t] = mixture
    out = overlap_add_demix(
        model_fn, mix_cat, chunk, step, np.concatenate(win_parts, axis=0),
        num_stems=num_stems, batch_size=batch_size, positions=np.concatenate(pos_parts),
        divider=np.concatenate(div_parts), fetch_stems=fetch_stems, device=device, mesh=mesh)
    return [out[..., off : off + t] for off, t in zip(offs, lens)]


@torch.no_grad()
def tiled_mask_predict(
    model_fn: Callable[[torch.Tensor], torch.Tensor],
    spec: torch.Tensor,
    window: int,
    offset: int,
    batch_size: int,
    n_tiles: int,
    mesh=None,
) -> torch.Tensor:
    """The VR mask engine, device in and device out: ``spec (C, F, T)``
    padded magnitudes → mask ``(C', F', n_tiles · roi)``, ``roi = window −
    2 · offset``.

    Tile ``i`` reads frames ``[i · roi, i · roi + window)`` (zeros past the
    end) and ``model_fn`` maps ``(B, C, F, window)`` to the centre ``roi``
    frames of its mask, ``(B, C', F', roi)``. ``batch_size`` tiles go through
    a forward, the last batch holds what is left: only the ``n_tiles`` tiles
    the track needs are computed (the JAX package's
    ``tiled_mask_predict_dev`` without its length buckets). ``mesh``: each
    batch split over its data axis, the mask joined on ``spec``'s device
    (the mesh's first)."""
    roi = window - 2 * offset
    batch_size, _, rows = _mesh_geometry(mesh, batch_size, spec.device)
    need = (n_tiles - 1) * roi + window
    if spec.shape[-1] >= need:
        spec = spec[..., :need]
    else:
        spec = torch.nn.functional.pad(spec, (0, need - spec.shape[-1]))
    tiles = spec.unfold(-1, window, roi)  # (C, F, n_tiles, window)
    outs = [_run_rows(model_fn, tiles[:, :, i : i + batch_size].permute(2, 0, 1, 3).contiguous(),
                      rows)
            for i in range(0, n_tiles, batch_size)]
    mask = torch.cat(outs, dim=0)  # (n_tiles, C', F', roi)
    b, oc, of, _ = mask.shape
    return mask.permute(1, 2, 0, 3).reshape(oc, of, b * roi)
