"""MDXC architecture separator: BS/Mel-Band RoFormer and TFC-TDF v3 (MDX23C).

Port of ``audio_separator_tpu/architectures/mdxc.py``: the same chunk
geometry, Hamming-window overlap-add (RoFormer) and unfold with uniform
windows (TFC-TDF), output-single-stem fetch plan, residual secondary,
pitch-shift semantics and cross-job batching (``separate_batch``), with the
model as a PyTorch module on the separator's device.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..models.convert import (
    cached_convert,
    convert_roformer,
    convert_tfc_tdf,
    load_jax_params,
    load_jax_tfc_tdf_params,
)
from ..models.roformer import Roformer
from ..models.tfc_tdf import TFCTDFNet, build_tfc_tdf_config
from ..ops import spec as spec_ops
from ..ops.demix import demix_jobs, overlap_add_demix
from ..ops.fn_cache import file_key, memoized_model
from ..ops.resample import change_pitch_semitones_np
from ..ops.stft import hamming_window
from ..separator.common import BaseSeparator
from ..separator.roformer_config import (
    ModelLoadingResult,
    build_roformer_config,
    collect_config_warnings,
    detect_roformer_type,
    flatten_model_config,
    normalize_roformer_params,
)


def _synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class MDXCSeparator(BaseSeparator):
    def __init__(self, common_config: Dict, arch_config: Dict):
        super().__init__(config=common_config)

        self.segment_size = arch_config.get("segment_size", 256)
        self.override_model_segment_size = arch_config.get("override_model_segment_size", False)
        self.overlap = arch_config.get("overlap", 8)
        self.batch_size = arch_config.get("batch_size") or 4
        self.pitch_shift = arch_config.get("pitch_shift", 0)
        self.process_all_stems = arch_config.get("process_all_stems", False)
        self.compute_dtype = torch.bfloat16 if common_config.get("use_autocast") else torch.float32

        self.is_roformer = (
            self.model_data.get("is_roformer", False)
            or "roformer" in (self.model_path or "").lower()
            or "roformer" in (self.model_name or "").lower()
        )
        self.model_cfg = None
        self.model: Optional[torch.nn.Module] = None
        self.loading_result = None
        self.load_split: Dict[str, float] = {}
        self.load_model()

        training = self.model_data.get("training") or {}
        self.stem_list = (
            [training["target_instrument"]] if training.get("target_instrument")
            else list(training.get("instruments") or [self.primary_stem_name])
        )
        self.instrument_list = list(training.get("instruments") or self.stem_list)
        self.is_primary_stem_main_target = bool(training.get("target_instrument"))

    # ----------------------------------------------------------------- model

    def load_model(self):
        """checkpoint → parameter tree (``cached_convert``: ``convert_roformer``
        for a RoFormer, ``convert_tfc_tdf`` for TFC-TDF) → the module
        (``load_jax_params`` / ``load_jax_tfc_tdf_params``) on the
        separator's device in the compute dtype, with a RoFormer's 3xTF32
        weight forms made. The module is shared process-wide
        (``ops/fn_cache``): a second separator over the same file, device,
        dtype and configuration reads nothing. ``load_split`` has the seconds
        of each part of a build, or ``{"cached": seconds}``."""
        t0 = time.perf_counter()
        if self.is_roformer:
            self.model_cfg = build_roformer_config(self.model_data, self.model_path or "")
            family, convert, build, load = ("roformer", convert_roformer, Roformer,
                                            load_jax_params)
        else:
            self.model_cfg = build_tfc_tdf_config(self.model_data)
            family, convert, build, load = ("tfc_tdf", convert_tfc_tdf, TFCTDFNet,
                                            load_jax_tfc_tdf_params)
        split = {}

        def load_module(device):
            tree = cached_convert(self.model_path, self.model_cfg, convert, times=split)
            t1 = time.perf_counter()
            model = load(build(self.model_cfg), tree)
            t2 = time.perf_counter()
            model = model.to(device=device, dtype=self.compute_dtype).eval()
            _synchronize(device)
            t3 = time.perf_counter()
            if self.is_roformer:
                model.tf32_forms()  # float32 on the card: made once, here
                _synchronize(device)
            split.update(build=t2 - t1, upload=t3 - t2, forms=time.perf_counter() - t3)
            return model

        def key_for(device: str):
            return (f"mdxc-{family}", file_key(self.model_path), device,
                    str(self.compute_dtype), repr(self.model_cfg))

        self._replica_args = (key_for, load_module)
        self.model = memoized_model(key_for(str(self.device)),
                                    lambda: load_module(self.device))
        self.load_split = split or {"cached": time.perf_counter() - t0}
        if not self.is_roformer:
            return
        flat = normalize_roformer_params(flatten_model_config(self.model_data))
        self.loading_result = ModelLoadingResult(
            success=True,
            model_type=detect_roformer_type(flat, self.model_path or ""),
            parameter_count=sum(p.numel() for p in self.model.parameters()),
            load_duration_seconds=time.perf_counter() - t0,
            warnings=collect_config_warnings(flat),
        )
        for w in self.loading_result.warnings:
            self.logger.warning(w)
        self.logger.debug(self.loading_result.summary())

    # ----------------------------------------------------------------- inference

    def separate(self, audio_file_path: str, custom_output_names: Optional[Dict] = None):
        self.primary_source = None
        self.secondary_source = None
        self.audio_file_path = audio_file_path
        self.audio_file_base = os.path.splitext(os.path.basename(audio_file_path))[0]

        mix = self.prepare_mix(audio_file_path)
        if mix.shape[1] / self.sample_rate < 10.0 and not self.override_model_segment_size:
            self.override_model_segment_size = True
            self.logger.warning("Audio shorter than 10s; enabling override_model_segment_size.")

        mix = spec_ops.normalize(mix, self.normalization_threshold, self.amplification_threshold)
        source = self.demix(mix)
        return self._finalize_outputs(source, custom_output_names)

    def separate_batch(self, audio_file_paths: list,
                       custom_output_names_list: Optional[list] = None) -> list:
        """Separate several files through one engine pass (cross-job window
        batching, ``ops/demix.demix_jobs``). Returns one output-file list per
        input.

        Falls back to sequential :meth:`separate` for TFC-TDF (unfold path),
        pitch shift, a single file, or any track under the 10 s segment-size
        override.

        Each file's stems are written at that file's own input bit depth. The
        JAX package writes every file of a batch at the last file's depth
        (ROADMAP Queue C2); this is a deliberate divergence from it.
        """
        names = custom_output_names_list or [None] * len(audio_file_paths)
        if len(names) != len(audio_file_paths):
            raise ValueError(
                f"custom_output_names_list has {len(names)} entries for "
                f"{len(audio_file_paths)} files")
        batchable = (self.is_roformer and self.pitch_shift == 0
                     and len(audio_file_paths) > 1)
        prepared, depths = [], []
        if batchable:
            for path in audio_file_paths:
                self.audio_file_path = path
                mix = self.prepare_mix(path)
                if mix.shape[1] / self.sample_rate < 10.0:
                    batchable = False
                    break
                depths.append(self.input_bit_depth)
                prepared.append(spec_ops.normalize(
                    mix, self.normalization_threshold, self.amplification_threshold))
        if not batchable:
            return [self.separate(p, n) for p, n in zip(audio_file_paths, names)]

        sources = self._demix_batch(prepared)
        outputs = []
        for path, source, custom, depth in zip(audio_file_paths, sources, names, depths):
            self.primary_source = None
            self.secondary_source = None
            self.audio_file_path = path
            self.audio_file_base = os.path.splitext(os.path.basename(path))[0]
            self.input_bit_depth = depth
            outputs.append(self._finalize_outputs(source, custom))
        return outputs

    def _finalize_outputs(self, source, custom_output_names: Optional[Dict]):
        output_files = []
        if isinstance(source, dict):
            if self.process_all_stems and len(self.stem_list) > 2:
                for stem_name in self.stem_list:
                    path = self.get_stem_output_path(stem_name, custom_output_names)
                    stem = spec_ops.normalize(source[stem_name], self.normalization_threshold,
                                              self.amplification_threshold).T
                    self.final_process(path, stem, stem_name)
                    output_files.append(path)
                return output_files

            # With output_single_stem, demix fetched only the requested stem;
            # the other name is absent here and is never written below.
            if (not isinstance(self.primary_source, np.ndarray)
                    and self.primary_stem_name in source):
                self.primary_source = spec_ops.normalize(
                    source[self.primary_stem_name],
                    self.normalization_threshold, self.amplification_threshold).T
            if (not isinstance(self.secondary_source, np.ndarray)
                    and self.secondary_stem_name in source):
                self.secondary_source = spec_ops.normalize(
                    source[self.secondary_stem_name],
                    self.normalization_threshold, self.amplification_threshold).T

            if (not self.output_single_stem
                    or self.output_single_stem.lower() == self.secondary_stem_name.lower()):
                path = self.get_stem_output_path(self.secondary_stem_name, custom_output_names)
                self.final_process(path, self.secondary_source, self.secondary_stem_name)
                output_files.append(path)
            if (not self.output_single_stem
                    or self.output_single_stem.lower() == self.primary_stem_name.lower()):
                path = self.get_stem_output_path(self.primary_stem_name, custom_output_names)
                self.final_process(path, self.primary_source, self.primary_stem_name)
                output_files.append(path)
        elif (not self.output_single_stem
                or self.output_single_stem.lower() == self.primary_stem_name.lower()):
            path = self.get_stem_output_path(self.primary_stem_name, custom_output_names)
            if not isinstance(self.primary_source, np.ndarray):
                self.primary_source = source.T
            self.final_process(path, self.primary_source, self.primary_stem_name)
            output_files.append(path)
        return output_files

    def _segment_size(self) -> int:
        if self.override_model_segment_size:
            return int(self.segment_size)
        inference = self.model_data.get("inference") or {}
        return int(inference.get("dim_t", self.segment_size))

    def _model_fn(self):
        """``(B, C, chunk)`` → ``(B, S, C, chunk)`` on the tensor's device
        (the module's replica there, for a mesh row)."""
        def model(x: torch.Tensor) -> torch.Tensor:
            return self.model_on(x.device, self.model, *self._replica_args)(x)

        if not self.is_roformer:
            return model
        stereo = self.model_cfg.stereo

        def fn(chunks: torch.Tensor) -> torch.Tensor:  # (B, C, chunk) -> (B, S, C, chunk)
            x = chunks if stereo else chunks.reshape(-1, 1, chunks.shape[-1])
            out = model(x)
            if not stereo:
                out = out.reshape(chunks.shape[0], chunks.shape[1], -1,
                                  chunks.shape[-1]).transpose(1, 2)
            if out.shape[-1] < chunks.shape[-1]:
                out = torch.nn.functional.pad(out, (0, chunks.shape[-1] - out.shape[-1]))
            return out[..., : chunks.shape[-1]]

        return fn

    def _fetch_plan(self, num_stems: int):
        """(fetch_stems, kept_names) for output_single_stem: only the requested
        stem is brought back from the device."""
        fetch_stems = None
        kept_names = list(self.stem_list)
        if self.output_single_stem and num_stems > 1 and not self.process_all_stems:
            want = self.output_single_stem.lower()
            idx = [i for i, name in enumerate(self.stem_list) if name.lower() == want]
            if idx:
                fetch_stems = tuple(idx)
                kept_names = [self.stem_list[i] for i in idx]
        return fetch_stems, kept_names

    def _roformer_geometry(self):
        """(chunk, step, window) of the RoFormer overlap-add grid."""
        seg = self._segment_size()
        model_section = self.model_data.get("model") or {}
        audio_section = self.model_data.get("audio") or {}
        stft_hop = int(model_section.get("stft_hop_length",
                                         audio_section.get("hop_length",
                                                           self.model_cfg.stft_hop_length)))
        chunk = stft_hop * (seg - 1)
        audio_sr = int(audio_section.get("sample_rate", self.sample_rate))
        desired_step = int(self.overlap * audio_sr)
        step = chunk if desired_step <= 0 else min(desired_step, chunk)
        return chunk, step, hamming_window(chunk).numpy()

    def _sources_from_out(self, out, kept_names, num_stems, orig_mix):
        """Engine output → the job's sources dict or array: stem naming and
        the residual secondary of target-instrument models."""
        names = kept_names if num_stems > 1 else [self.stem_list[0]]
        sources = {name: np.asarray(out[i], dtype=np.float32) for i, name in enumerate(names)}
        if num_stems > 1:
            # Multi-stem models never take the residual secondary.
            return sources

        primary = sources[self.stem_list[0]]
        if self.is_primary_stem_main_target:
            if primary.shape[1] != orig_mix.shape[1]:
                primary = spec_ops.match_array_shapes(primary, orig_mix)
            return {
                self.primary_stem_name: primary,
                self.secondary_stem_name: orig_mix - primary,
            }
        return primary

    def _demix_batch(self, mixes: list) -> list:
        """K prepared mixes → K sources through one engine pass
        (``ops/demix.demix_jobs``). Callers guarantee the RoFormer path with
        no pitch shift; stem naming and the residual secondary apply per job."""
        num_stems = len(self.stem_list)
        fetch_stems, kept_names = self._fetch_plan(num_stems)
        chunk, step, window = self._roformer_geometry()
        outs = demix_jobs(
            self._model_fn(), mixes, chunk, step, window, num_stems=num_stems,
            batch_size=max(1, int(self.batch_size)), fetch_stems=fetch_stems,
            device=self.device, mesh=self.mesh)
        return [self._sources_from_out(out, kept_names, num_stems, mix)
                for out, mix in zip(outs, mixes)]

    def demix(self, mix: np.ndarray):
        orig_mix = mix
        sample_rate = self.sample_rate
        if self.pitch_shift != 0:
            mix, sample_rate = change_pitch_semitones_np(
                mix, self.sample_rate, semitone_shift=-self.pitch_shift)

        num_stems = len(self.stem_list)
        fetch_stems, kept_names = self._fetch_plan(num_stems)
        if self.is_roformer:
            chunk, step, window = self._roformer_geometry()
            out = overlap_add_demix(
                self._model_fn(), mix, chunk, step, window, num_stems=num_stems,
                batch_size=max(1, int(self.batch_size)), fetch_stems=fetch_stems,
                device=self.device, mesh=self.mesh)
        else:
            audio_section = self.model_data.get("audio") or {}
            chunk = int(audio_section.get("hop_length", 1024)) * (self._segment_size() - 1)
            out = self._demix_unfold(mix, chunk, chunk // int(self.overlap), num_stems,
                                     fetch_stems=fetch_stems)
        if self.pitch_shift != 0:
            out = [self._pitch_fix(value, sample_rate, orig_mix) for value in out]
        return self._sources_from_out(out, kept_names, num_stems, orig_mix)

    def _demix_unfold(self, mix: np.ndarray, chunk: int, hop_size: int, num_stems: int,
                      fetch_stems: Optional[tuple] = None):
        """MDX23C path: a lead of ``chunk - hop_size`` zeros and a tail, a
        uniform window at explicit positions every ``hop_size``, the
        accumulated window count as the divider, then the crop
        ``[lead : lead + total]``."""
        c, total = mix.shape
        pad_size = hop_size - (total - chunk) % hop_size
        lead = chunk - hop_size
        padded = np.concatenate(
            [np.zeros((c, lead), np.float32), mix.astype(np.float32),
             np.zeros((c, pad_size + lead), np.float32)], axis=1)
        positions = np.arange(0, padded.shape[1] - chunk + 1, hop_size, dtype=np.int64)
        out = overlap_add_demix(
            self._model_fn(), padded, chunk, hop_size, np.ones(chunk, np.float32),
            num_stems=num_stems, batch_size=max(1, int(self.batch_size)),
            positions=positions, fetch_stems=fetch_stems, device=self.device, mesh=self.mesh)
        return out[..., lead : lead + total]

    def _pitch_fix(self, source: np.ndarray, sr_pitched: int, orig_mix: np.ndarray):
        source = change_pitch_semitones_np(source, sr_pitched,
                                           semitone_shift=self.pitch_shift)[0]
        return spec_ops.match_array_shapes(source, orig_mix)
