"""MDX architecture separator (ONNX Conv-TDF models on a packed STFT).

Port of ``audio_separator_tpu/architectures/mdx.py``: the reference
MDXSeparator's chunk geometry (trim/gen_size padding), per-position Hann
windows with exact partial-tail lengths, zeroing of the lowest three bins,
the denoise double pass, and the compensated or spectrally inverted
secondary (ref: audio_separator/separator/architectures/mdx_separator.py).
The ONNX graph runs through ``models/onnx_torch`` on the separator's device:
packed STFT → Conv-TDF net → iSTFT for each batch of windows, then the
overlap-add of ``ops/demix``.

The float32 forward runs under ``ops/precision.full_float32`` (cuDNN would
otherwise run float32 convolutions in TF32); ``use_autocast`` runs the net
in bf16 with float32 STFT and iSTFT. ``separate_batch`` writes each file at
its own input bit depth (ROADMAP Queue C2; the JAX package writes a batch at
its last file's depth).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..models.onnx_torch import onnx_to_torch
from ..ops import spec as spec_ops
from ..ops.demix import demix_jobs_layout, overlap_add_demix
from ..ops.fn_cache import file_key, memoized_model
from ..ops.precision import full_float32
from ..ops.stft import hann_window, istft_real_packed, stft_real_packed
from ..separator.common import BaseSeparator


class MDXSeparator(BaseSeparator):
    def __init__(self, common_config: Dict, arch_config: Dict):
        super().__init__(config=common_config)

        self.segment_size = arch_config.get("segment_size", 256)
        self.overlap = arch_config.get("overlap", 0.25)
        self.batch_size = arch_config.get("batch_size") or 4
        self.hop_length = arch_config.get("hop_length", 1024)
        self.enable_denoise = arch_config.get("enable_denoise", False)

        self.compensate = self.model_data["compensate"]
        self.dim_f = self.model_data["mdx_dim_f_set"]
        self.dim_t = 2 ** self.model_data["mdx_dim_t_set"]
        self.n_fft = self.model_data["mdx_n_fft_scale_set"]

        self.load_model()

        # Derived model settings (ref: mdx_separator.py:205-228).
        self.n_bins = self.n_fft // 2 + 1
        self.trim = self.n_fft // 2
        self.chunk_size = self.hop_length * (self.segment_size - 1)
        self.gen_size = self.chunk_size - 2 * self.trim

    def load_model(self):
        """The ONNX graph as a function of tensors, its initializers on the
        separator's device; shared process-wide (``ops/fn_cache``), so a
        second separator over the same file parses and uploads nothing. (The
        graph is parsed for its function anyway, and that parse gives the
        parameters: a converted ``.npz`` beside the file would save nothing.)"""
        self._replica_args = (lambda device: ("mdx", file_key(self.model_path), device),
                              lambda device: onnx_to_torch(self.model_path, device=device)[:2])
        key_for, build = self._replica_args
        self._onnx_fn, self._onnx_params = memoized_model(key_for(str(self.device)),
                                                          lambda: build(self.device))

    # ------------------------------------------------------------- model fn

    def _model_fn(self, is_match_mix: bool):
        """``(B, 2, chunk)`` float32 → ``(B, 1, 2, chunk)``: packed STFT, the
        lowest three bins zeroed, the net (skipped for the match-mix pass),
        iSTFT, cropped or zero-padded to the chunk."""
        n_fft, hop, dim_f = self.n_fft, self.hop_length, self.dim_f
        net_dtype = torch.bfloat16 if self.use_autocast else torch.float32
        local = (self._onnx_fn, self._onnx_params)
        denoise = bool(self.enable_denoise)
        win = hann_window(n_fft, device=self.device)

        def run_net(spek):
            # the graph's replica on the tensor's device (a mesh row's)
            onnx_fn, params = self.model_on(spek.device, local, *self._replica_args)
            # optional denoise double pass (ref: mdx_separator.py:427-441)
            if denoise:
                neg = onnx_fn(params, -spek)[0]
                pos = onnx_fn(params, spek)[0]
                return pos * 0.5 - neg * 0.5
            return onnx_fn(params, spek)[0]

        def fn(chunks: torch.Tensor) -> torch.Tensor:
            with full_float32():
                spek = stft_real_packed(chunks, n_fft, hop, win.to(chunks.device), dim_f)
                spek[:, :, :3, :] = 0.0  # low-bin suppression
                spec_pred = (spek if is_match_mix
                             else run_net(spek.to(net_dtype)).float())
                out = istft_real_packed(spec_pred, n_fft, hop, win.to(chunks.device))
            out = out[..., : chunks.shape[-1]]
            if out.shape[-1] < chunks.shape[-1]:
                out = torch.nn.functional.pad(out, (0, chunks.shape[-1] - out.shape[-1]))
            return out[:, None]

        return fn

    # --------------------------------------------------------------- demix

    def _pass_geometry(self, is_match_mix: bool) -> tuple:
        """(chunk_size, overlap, step) for a demix pass
        (ref: mdx_separator.py:300-311 match-mix overrides)."""
        if is_match_mix:
            chunk_size = self.hop_length * (self.segment_size - 1)
            overlap = 0.02
        else:
            chunk_size = self.chunk_size
            overlap = self.overlap
        return chunk_size, overlap, int((1 - overlap) * chunk_size)

    def _job_layout(self, mix: np.ndarray, chunk_size: int, overlap: float,
                    step: int) -> tuple:
        """One track's engine layout: trim-padded mixture, window positions,
        per-position ``np.hanning(actual)`` tail windows, and the overlap
        divider (ref: mdx_separator.py:330-366)."""
        gen_size = chunk_size - 2 * self.trim
        pad = gen_size + self.trim - (mix.shape[-1] % gen_size)
        mixture = np.concatenate(
            [np.zeros((2, self.trim), np.float32), mix.astype(np.float32),
             np.zeros((2, pad), np.float32)], axis=1)
        total = mixture.shape[-1]

        positions = np.arange(0, total, step, dtype=np.int64)
        # Per-position windows: np.hanning over the in-bounds length (partial
        # tails get shorter symmetric windows, ref :358-366).
        windows = np.zeros((len(positions), chunk_size), dtype=np.float32)
        divider = np.zeros(total, dtype=np.float32)
        for row, start in enumerate(positions):
            actual = min(start + chunk_size, total) - start
            if overlap != 0:
                w = np.hanning(actual).astype(np.float32)
            else:
                w = np.ones(actual, dtype=np.float32)
            windows[row, :actual] = w
            divider[start : start + actual] += w
        return mixture, positions, windows, np.maximum(divider, 1e-10)

    def demix(self, mix: np.ndarray, is_match_mix: bool = False) -> np.ndarray:
        """``mix (2, T)`` → the net's stem ``(2, T)`` (or the STFT round
        trip of the mix for the match-mix pass)."""
        chunk_size, overlap, step = self._pass_geometry(is_match_mix)
        mixture, positions, windows, divider = self._job_layout(
            mix, chunk_size, overlap, step)
        out = overlap_add_demix(
            self._model_fn(is_match_mix), mixture, chunk_size, step, windows,
            num_stems=1, batch_size=max(1, int(self.batch_size)),
            positions=positions, divider=divider, device=self.device, mesh=self.mesh)
        return out[0][:, self.trim : -self.trim][:, : mix.shape[-1]]

    def _demix_batch(self, mixes: list, is_match_mix: bool = False) -> list:
        """K tracks through one engine pass (``ops/demix.demix_jobs_layout``);
        each job's slice is its solo :meth:`demix` result."""
        chunk_size, overlap, step = self._pass_geometry(is_match_mix)
        jobs = [self._job_layout(np.asarray(m, dtype=np.float32), chunk_size, overlap, step)
                for m in mixes]
        outs = demix_jobs_layout(
            self._model_fn(is_match_mix), jobs, chunk_size, step, num_stems=1,
            batch_size=max(1, int(self.batch_size)), device=self.device, mesh=self.mesh)
        return [o[0][:, self.trim : -self.trim][:, : m.shape[-1]]
                for o, m in zip(outs, mixes)]

    # -------------------------------------------------------------- separate

    def _secondary(self, mix: np.ndarray, raw_mix: Optional[np.ndarray]) -> np.ndarray:
        if self.invert_using_spec:
            return spec_ops.invert_stem(raw_mix, self.primary_source.T * self.compensate,
                                        device=self.device)
        return (-self.primary_source * self.compensate) + mix.T

    def separate(self, audio_file_path: str, custom_output_names: Optional[Dict] = None):
        self.primary_source = None
        self.secondary_source = None
        self.audio_file_path = audio_file_path
        self.audio_file_base = os.path.splitext(os.path.basename(audio_file_path))[0]

        mix = self.prepare_mix(audio_file_path)
        peak = np.abs(mix).max()
        mix = spec_ops.normalize(mix, self.normalization_threshold,
                                 self.amplification_threshold)
        self.primary_source = (self.demix(mix) * peak).T
        # The match-mix pass runs whether or not invert_stem reads it, as
        # the reference's call sequence does.
        raw_mix = self.demix(mix, is_match_mix=True)
        self.secondary_source = self._secondary(mix, raw_mix)
        return self._write_outputs(custom_output_names)

    def _write_outputs(self, custom_output_names: Optional[Dict]) -> list:
        """Write secondary then primary (reference order,
        ref: mdx_separator.py:184-202), honouring output_single_stem."""
        output_files = []
        for name, source in ((self.secondary_stem_name, self.secondary_source),
                             (self.primary_stem_name, self.primary_source)):
            if not self.output_single_stem or self.output_single_stem.lower() == name.lower():
                path = self.get_stem_output_path(name, custom_output_names)
                self.final_process(path, source, name)
                output_files.append(path)
        return output_files

    def separate_batch(self, audio_file_paths: list,
                       custom_output_names_list: Optional[list] = None) -> list:
        """Separate several files through shared engine passes: one batched
        primary pass for the group, plus one batched match-mix pass when
        ``invert_using_spec`` reads it. Each file's stems equal its solo
        :meth:`separate` output and are written at that file's own input bit
        depth. Returns one output-file list per input."""
        names = custom_output_names_list or [None] * len(audio_file_paths)
        if len(names) != len(audio_file_paths):
            raise ValueError(
                f"custom_output_names_list has {len(names)} entries for "
                f"{len(audio_file_paths)} files")
        if len(audio_file_paths) <= 1:
            return [self.separate(p, n) for p, n in zip(audio_file_paths, names)]

        mixes, peaks, depths = [], [], []
        for path in audio_file_paths:
            self.audio_file_path = path
            mix = self.prepare_mix(path)
            depths.append(self.input_bit_depth)
            peaks.append(np.abs(mix).max())
            mixes.append(spec_ops.normalize(mix, self.normalization_threshold,
                                            self.amplification_threshold))

        primaries = self._demix_batch(mixes)
        # Only invert_stem reads the match-mix pass; the waveform secondary
        # does not, so the batch skips it then (the outputs are unchanged).
        raw_mixes = (self._demix_batch(mixes, is_match_mix=True)
                     if self.invert_using_spec else [None] * len(mixes))

        outputs = []
        for path, custom, mix, peak, src, raw, depth in zip(
                audio_file_paths, names, mixes, peaks, primaries, raw_mixes, depths):
            self.audio_file_path = path
            self.audio_file_base = os.path.splitext(os.path.basename(path))[0]
            self.input_bit_depth = depth
            self.primary_source = (src * peak).T
            self.secondary_source = self._secondary(mix, raw)
            outputs.append(self._write_outputs(custom))
        return outputs
