"""Demucs architecture separator (v4 ``HTDemucs`` and v3 ``HDemucs``).

Port of ``audio_separator_tpu/architectures/demucs.py``: bag-of-models with
per-source weights, shift-trick test-time augmentation, and two splits, both
with triangular transition weights and executed through the shared demix
engine with the bag's models on the separator's device:

* training-length (v4): every window runs at the training length, the tail
  with centred context, and all shifts share one engine call;
* exact-length (v3, ``use_train_segment=False``): full windows batch through
  the engine, and each window that would run past the track's end (a tail)
  gets one direct call at its exact length; the shifts are sequential
  passes, since each sees a different length.

Everything runs in float32: Demucs is precision-sensitive.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.demucs_load import bag_members, load_demucs_member
from ..models.htdemucs import HTDemucs, HTDemucsConfig, build_demucs
from ..ops.demix import overlap_add_demix
from ..ops.fn_cache import file_key, memoized_model
from ..separator.common import BaseSeparator
from ..utils.tracing import span

DEMUCS_4_SOURCE_MAPPER = {
    BaseSeparator.BASS_STEM: 0,
    BaseSeparator.DRUM_STEM: 1,
    BaseSeparator.OTHER_STEM: 2,
    BaseSeparator.VOCAL_STEM: 3,
}
DEMUCS_2_SOURCE_MAPPER = {
    BaseSeparator.INST_STEM: 0,
    BaseSeparator.VOCAL_STEM: 1,
}
DEMUCS_6_SOURCE_MAPPER = {
    BaseSeparator.BASS_STEM: 0,
    BaseSeparator.DRUM_STEM: 1,
    BaseSeparator.OTHER_STEM: 2,
    BaseSeparator.VOCAL_STEM: 3,
    BaseSeparator.GUITAR_STEM: 4,
    BaseSeparator.PIANO_STEM: 5,
}


class _MemberOnRows:
    """A bag member as the engine's model function over a mesh: the module
    on the separator's device, its replica on another row's device
    (``BaseSeparator.model_on``)."""

    def __init__(self, separator, model, key_for, build):
        self.cfg = model.cfg
        self._args = (separator, model, key_for, build)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        separator, model, key_for, build = self._args
        return separator.model_on(x.device, model, key_for, build)(x)


class DemucsSeparator(BaseSeparator):
    def __init__(self, common_config: Dict, arch_config: Dict):
        super().__init__(config=common_config)
        self.segment_size = arch_config.get("segment_size", "Default")
        self.shifts = arch_config.get("shifts", 2)
        self.overlap = arch_config.get("overlap", 0.25)
        self.segments_enabled = arch_config.get("segments_enabled", True)
        self.batch_size = int(arch_config.get("batch_size", 4) or 4)
        self._models: Optional[Tuple[List[HTDemucs], List[List[float]]]] = None

    # ------------------------------------------------------------------ model

    def _load_models(self) -> Tuple[List[HTDemucs], List[List[float]]]:
        """The bag's modules on the device, loaded once per instance and
        shared process-wide, one cache entry per member file
        (``ops/fn_cache``): a second separator over the same bag reads no
        member file. (A member file is a pickled package whose class and
        arguments build the module, so there is no converted form to keep
        beside it; the JAX package keeps none either.)"""
        if self._models is not None:
            return self._models
        repo_dir = os.path.dirname(self.model_path)
        paths, weights, segment = bag_members(self.model_path, repo_dir)
        # The caller's segment override, else the bag's.
        override = None
        if self.segment_size != "Default":
            try:
                override = float(int(self.segment_size))
            except (TypeError, ValueError):
                pass
        elif segment is not None:
            override = float(segment)

        def load_member(th_path, device):
            cfg, state = load_demucs_member(th_path)
            if override is not None:
                cfg = dataclasses.replace(cfg, segment=override)
            model = build_demucs(cfg)
            model.load_state_dict(state, strict=True)
            return model.to(device).eval()

        # Per member: (cache key, build) for a device, also a mesh row's.
        self._member_replicas = [
            (lambda device, p=p: ("demucs", file_key(p), override, device),
             lambda device, p=p: load_member(p, device)) for p in paths]
        models = [memoized_model(key_for(str(self.device)), lambda b=build: b(self.device))
                  for key_for, build in self._member_replicas]
        if weights is None:
            weights = [[1.0] * len(models[0].cfg.sources) for _ in models]
        self._models = (models, weights)
        return self._models

    # --------------------------------------------------------------- separate

    def separate(self, audio_file_path: str, custom_output_names: Optional[Dict] = None):
        self.audio_file_path = audio_file_path
        self.audio_file_base = os.path.splitext(os.path.basename(audio_file_path))[0]

        mix = self.prepare_mix(audio_file_path)

        models, _ = self._load_models()
        n_sources = len(models[0].cfg.sources)
        source_map = {2: DEMUCS_2_SOURCE_MAPPER, 6: DEMUCS_6_SOURCE_MAPPER}.get(
            n_sources, DEMUCS_4_SOURCE_MAPPER)

        # output_single_stem: every source is computed on the device but only
        # the requested one is fetched. A name that matches no source fetches
        # all (and the loop below then writes nothing).
        wanted = None
        if self.output_single_stem is not None:
            hits = tuple(idx for name, idx in source_map.items()
                         if name.lower() == self.output_single_stem.lower())
            if hits:
                wanted = hits

        source = self.demix_demucs(mix, wanted=wanted)

        output_files = []
        for stem_name, idx in source_map.items():
            if (self.output_single_stem is not None
                    and stem_name.lower() != self.output_single_stem.lower()):
                continue
            row = source[wanted.index(idx)] if wanted is not None else source[idx]
            path = self.get_stem_output_path(stem_name, custom_output_names)
            self.final_process(path, row.T, stem_name)
            output_files.append(path)
        return output_files

    # ------------------------------------------------------------------ demix

    def demix_demucs(self, mix: np.ndarray, wanted: Optional[tuple] = None) -> np.ndarray:
        """Standardise, apply the bag with shifts and split, un-standardise,
        swap sources 0 and 1.

        ``wanted``: optional tuple of POST-swap source indices; only those
        rows are fetched from the device (the model still computes every
        source), and they come back in ``wanted`` order. ``None`` returns all
        sources in post-swap order."""
        models, weights = self._load_models()
        with span("separate.normalize"):
            mix = np.asarray(mix, dtype=np.float32)
            ref_mean = float(mix.mean(axis=0).mean())
            ref_std = float(mix.mean(axis=0).std(ddof=1))
            norm = (mix - ref_mean) / (ref_std + 1e-20)

        n_sources = len(models[0].cfg.sources)
        if wanted is None:
            fetch = tuple(range(n_sources))
        else:
            # Undo the final 0<->1 swap: `fetch` is in model-output order.
            fetch = tuple(1 if i == 0 else 0 if i == 1 else i for i in wanted)
        # The bag's shift and split host work, around the engine's own spans.
        with span("demix.plan"):
            estimates = np.zeros((len(fetch), 2, mix.shape[-1]), dtype=np.float32)
            totals = [0.0] * len(fetch)
            rng = np.random.default_rng(0)  # one generator for the whole bag
            for model, weight, replicas in zip(models, weights, self._member_replicas):
                member = model if self.mesh is None else _MemberOnRows(self, model, *replicas)
                out = self._apply_one(member, norm, rng, fetch=fetch)
                for j, k in enumerate(fetch):
                    out[j] *= weight[k]
                    totals[j] += weight[k]
                estimates += out
            for j in range(len(fetch)):
                estimates[j] /= totals[j]

        with span("separate.normalize"):
            sources = estimates * ref_std + ref_mean
            if wanted is None:
                sources[[0, 1]] = sources[[1, 0]]
        return sources

    def _apply_one(self, model: HTDemucs, mix: np.ndarray, rng,
                   fetch: Optional[tuple] = None) -> np.ndarray:
        """One sub-model: the shift trick over the split overlap-add."""
        cfg = model.cfg
        length = mix.shape[-1]
        if fetch is None:
            fetch = tuple(range(len(cfg.sources)))
        if not self.shifts:
            return self._apply_split(model, mix, fetch=fetch)
        max_shift = int(0.5 * cfg.samplerate)
        offsets = [int(rng.integers(0, max_shift + 1)) for _ in range(self.shifts)]
        if cfg.use_train_segment and self.segments_enabled:
            return self._apply_shifts_batched(model, mix, offsets, max_shift, fetch=fetch)
        # Direct evaluation: the input's length differs per shift position, so
        # the shifts stay sequential passes.
        padded = np.pad(mix, ((0, 0), (max_shift, max_shift)))
        out = np.zeros((len(fetch), 2, length), dtype=np.float32)
        for offset in offsets:
            shifted = padded[:, offset : offset + length + max_shift]
            shifted_out = self._apply_split(model, shifted, fetch=fetch)
            out += shifted_out[..., max_shift - offset :][..., :length]
        return out / self.shifts

    @staticmethod
    def _triangle(segment: int) -> np.ndarray:
        """The transition weight of a window: a triangle peaking at 1."""
        tri = np.concatenate([np.arange(1, segment // 2 + 1),
                              np.arange(segment - segment // 2, 0, -1)]).astype(np.float32)
        return tri / tri.max()

    def _train_segment_plan(self, cfg: HTDemucsConfig, track_len: int):
        """Window plan of the training-length split: triangular transition
        weights, centred context for the tail chunks, per-position weight
        rows and the overlap divider — all relative to a buffer with
        ``pad_lead`` leading samples and room for the widest centred tail."""
        segment = cfg.training_length
        stride = int((1 - self.overlap) * segment)
        tri = self._triangle(segment)
        pad_lead = segment  # room for the centred context of tail chunks
        span = pad_lead + track_len + pad_lead + segment
        positions, rows = [], []
        divider = np.zeros(span, dtype=np.float32)
        for offset in range(0, track_len, stride):
            chunk_len = min(segment, track_len - offset)
            delta = segment - chunk_len
            start = offset - delta // 2  # centred context
            row = np.zeros(segment, dtype=np.float32)
            row[delta // 2 : delta // 2 + chunk_len] = tri[:chunk_len]
            positions.append(pad_lead + start)
            rows.append(row)
            divider[pad_lead + offset : pad_lead + offset + chunk_len] += tri[:chunk_len]
        return (segment, stride, pad_lead, span,
                np.asarray(positions, dtype=np.int32), np.stack(rows),
                np.maximum(divider, 1e-10))

    def _apply_shifts_batched(self, model: HTDemucs, mix: np.ndarray, offsets,
                              max_shift: int, fetch: Optional[tuple] = None) -> np.ndarray:
        """The shift trick as ONE engine call: each shift's windows gather from
        and accumulate into its own region of a single concatenated buffer, so
        all shifts × windows share the engine's batches. The regions are
        disjoint, so the concatenated divider normalises each shift by its own
        window sum; the shifts are aligned and averaged on the device before
        the fetch."""
        cfg = model.cfg
        length = mix.shape[-1]
        n_sources = len(cfg.sources)
        if fetch is None:
            fetch = tuple(range(n_sources))
        track_len = length + max_shift  # every shift sees this many samples
        (segment, stride, pad_lead, span, rel_pos, rows,
         div_one) = self._train_segment_plan(cfg, track_len)
        padded = np.pad(mix, ((0, 0), (max_shift, max_shift)))
        n_shifts = len(offsets)
        buf = np.zeros((2, span * n_shifts), dtype=np.float32)
        positions = np.concatenate([rel_pos + s * span for s in range(n_shifts)])
        for s, offset in enumerate(offsets):
            buf[:, s * span + pad_lead : s * span + pad_lead + track_len] = \
                padded[:, offset : offset + track_len]

        def post(acc: torch.Tensor) -> torch.Tensor:  # (S, 2, span * n_shifts)
            parts = [acc[..., s * span + pad_lead + (max_shift - offset):][..., :length]
                     for s, offset in enumerate(offsets)]
            return sum(parts) / n_shifts

        return overlap_add_demix(
            model, buf, segment, stride, np.tile(rows, (n_shifts, 1)),
            num_stems=n_sources, batch_size=self.batch_size, positions=positions,
            divider=np.tile(div_one, n_shifts),
            fetch_stems=fetch if len(fetch) < n_sources else None,
            post_device_fn=post, device=self.device, mesh=self.mesh)

    @torch.no_grad()
    def _apply_split(self, model: HTDemucs, mix: np.ndarray,
                     fetch: Optional[tuple] = None) -> np.ndarray:
        cfg = model.cfg
        length = mix.shape[-1]
        n_sources = len(cfg.sources)
        if fetch is None:
            fetch = tuple(range(n_sources))
        partial = len(fetch) < n_sources

        if not self.segments_enabled:
            # Direct evaluation of the whole (padded) track; the source axis
            # is sliced on the device so only the fetched rows come back.
            target = max(length, cfg.training_length) if cfg.use_train_segment else length
            delta = target - length
            padded = np.pad(mix, ((0, 0), (delta // 2, delta - delta // 2)))
            out_dev = model(torch.as_tensor(padded[None]).to(self.device))[0]
            out = (out_dev[list(fetch)] if partial else out_dev).cpu().numpy()
            start = (out.shape[-1] - length) // 2
            return out[..., start : start + length]

        if not cfg.use_train_segment:
            return self._apply_exact_split(model, mix, fetch)

        (segment, stride, pad_lead, span, positions, rows,
         divider) = self._train_segment_plan(cfg, length)
        buf = np.zeros((2, span), dtype=np.float32)
        buf[:, pad_lead : pad_lead + length] = mix
        out = overlap_add_demix(
            model, buf, segment, stride, rows, num_stems=n_sources,
            batch_size=self.batch_size, positions=positions, divider=divider,
            fetch_stems=fetch if partial else None, device=self.device, mesh=self.mesh)
        return out[..., pad_lead : pad_lead + length]

    @torch.no_grad()
    def _apply_exact_split(self, model: HTDemucs, mix: np.ndarray,
                           fetch: tuple) -> np.ndarray:
        """The v3 split: each window at its exact length (no padding to the
        training length). The full windows go through the engine in batches;
        it is given a unit divider, so it returns their weighted sum, and the
        weights' sum is kept here. Each tail (a window that would run past the
        track's end) gets one direct call at its own length. All is divided
        by the weights' sum at the end."""
        cfg = model.cfg
        length = mix.shape[-1]
        n_sources = len(cfg.sources)
        partial = len(fetch) < n_sources
        segment = cfg.training_length
        stride = int((1 - self.overlap) * segment)
        tri = self._triangle(segment)
        out = np.zeros((len(fetch), 2, length), np.float32)
        sum_w = np.zeros(length, np.float32)
        offsets = range(0, length, stride)
        full = [o for o in offsets if o + segment <= length]
        if full:
            pad_len = full[-1] + segment
            out[..., :pad_len] += overlap_add_demix(
                model, mix[:, :pad_len], segment, stride, tri, num_stems=n_sources,
                batch_size=self.batch_size, positions=np.asarray(full),
                divider=np.ones(pad_len, np.float32),
                fetch_stems=fetch if partial else None, device=self.device, mesh=self.mesh)
            for o in full:
                sum_w[o : o + segment] += tri
        for o in offsets:
            if o + segment <= length:
                continue
            chunk = torch.as_tensor(np.ascontiguousarray(mix[:, o:])[None]).to(self.device)
            est = model(chunk)[0]
            est = (est[list(fetch)] if partial else est).cpu().numpy()
            chunk_len = length - o
            out[..., o:] += tri[:chunk_len] * est
            sum_w[o:] += tri[:chunk_len]
        return out / np.maximum(sum_w, 1e-10)
