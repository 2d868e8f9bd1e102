"""Shared architecture-separator base: stem naming, mix prep, output writing.

Port of ``audio_separator_tpu/separator/common.py``: stem pair resolution
including the target-instrument swap, the (channels, samples) PCM convention,
``{base}_({Stem})_{model}.{ext}`` output naming, bit-depth preservation and
the near-silent guard. ``config["device"]`` is the torch device the
architecture computes on, ``config["mesh"]`` an optional
``parallel/mesh.Mesh`` whose data axis the engine splits window batches
over (the model replicated on each row's first device, :meth:`model_on`).
"""

from __future__ import annotations

import logging
import os
import re
from typing import Callable, Dict, Hashable, List, Optional

import numpy as np

from ..io import audio as audio_io
from ..ops import spec as spec_ops
from ..ops.fn_cache import memoized_model
from ..parallel.mesh import canonical_device


class BaseSeparator:
    """Base class for the four architecture separators."""

    ALL_STEMS = "All Stems"
    VOCAL_STEM = "Vocals"
    INST_STEM = "Instrumental"
    OTHER_STEM = "Other"
    BASS_STEM = "Bass"
    DRUM_STEM = "Drums"
    GUITAR_STEM = "Guitar"
    PIANO_STEM = "Piano"
    SYNTH_STEM = "Synthesizer"
    STRINGS_STEM = "Strings"
    WOODWINDS_STEM = "Woodwinds"
    BRASS_STEM = "Brass"
    WIND_INST_STEM = "Wind Inst"
    PRIMARY_STEM = "Primary Stem"
    SECONDARY_STEM = "Secondary Stem"
    LEAD_VOCAL_STEM = "lead_only"
    BV_VOCAL_STEM = "backing_only"
    NO_STEM = "No "

    STEM_PAIR_MAPPER = {
        VOCAL_STEM: INST_STEM,
        INST_STEM: VOCAL_STEM,
        LEAD_VOCAL_STEM: BV_VOCAL_STEM,
        BV_VOCAL_STEM: LEAD_VOCAL_STEM,
        PRIMARY_STEM: SECONDARY_STEM,
    }

    NON_ACCOM_STEMS = (
        VOCAL_STEM, OTHER_STEM, BASS_STEM, DRUM_STEM, GUITAR_STEM, PIANO_STEM,
        SYNTH_STEM, STRINGS_STEM, WOODWINDS_STEM, BRASS_STEM, WIND_INST_STEM,
    )

    def __init__(self, config: Dict):
        self.logger: logging.Logger = config.get("logger") or logging.getLogger(__name__)
        self.log_level: int = config.get("log_level", logging.INFO)

        self.model_name = config.get("model_name")
        self.model_path = config.get("model_path")
        self.model_data = config.get("model_data") or {}

        self.output_dir = config.get("output_dir")
        self.output_format = config.get("output_format") or "WAV"
        self.output_bitrate = config.get("output_bitrate")
        self.normalization_threshold = config.get("normalization_threshold", 0.9)
        self.amplification_threshold = config.get("amplification_threshold", 0.0)
        self.output_single_stem = config.get("output_single_stem")
        self.invert_using_spec = config.get("invert_using_spec", False)
        self.sample_rate = int(config.get("sample_rate", 44100))
        self.use_soundfile = config.get("use_soundfile", False)
        self.use_autocast = config.get("use_autocast", False)
        self.device = config.get("device", "cuda")
        self.mesh = config.get("mesh")

        # Stem resolution (ref: common_separator.py:103-125).
        self.primary_stem_name: Optional[str] = None
        self.secondary_stem_name: Optional[str] = None
        training = self.model_data.get("training") or {}
        instruments = training.get("instruments") if isinstance(training, dict) else None
        if instruments:
            target = training.get("target_instrument")
            if (target and len(instruments) >= 2 and instruments[0] != target
                    and instruments[1] == target):
                self.primary_stem_name = instruments[1]
                self.secondary_stem_name = instruments[0]
            else:
                self.primary_stem_name = instruments[0]
                self.secondary_stem_name = (
                    instruments[1] if len(instruments) > 1
                    else self.secondary_stem(instruments[0])
                )
        if self.primary_stem_name is None:
            self.primary_stem_name = self.model_data.get("primary_stem", "Vocals")
            self.secondary_stem_name = self.secondary_stem(self.primary_stem_name)

        self.is_karaoke = self.model_data.get("is_karaoke", False)
        self.is_bv_model = self.model_data.get("is_bv_model", False)
        self.bv_model_rebalance = self.model_data.get("is_bv_model_rebalanced", 0)

        self.audio_file_path: Optional[str] = None
        self.audio_file_base: Optional[str] = None
        self.primary_source: Optional[np.ndarray] = None
        self.secondary_source: Optional[np.ndarray] = None
        self.input_bit_depth: Optional[int] = None

    def model_on(self, device, local, key_for: Callable[[str], Hashable],
                 build: Callable):
        """The model for ``device``: ``local`` on the separator's own device;
        on another row device of the mesh, the same model built there by
        ``build(device)``, shared process-wide (``ops/fn_cache``) under
        ``key_for(str(device))``."""
        dev = canonical_device(device)
        if dev == canonical_device(self.device):
            return local
        return memoized_model(key_for(str(dev)), lambda: build(dev))

    # ------------------------------------------------------------------ stems

    def secondary_stem(self, primary_stem: str) -> str:
        """Counterpart stem name (ref: common_separator.py:148-157)."""
        primary_stem = primary_stem if primary_stem else self.NO_STEM
        if primary_stem in self.STEM_PAIR_MAPPER:
            return self.STEM_PAIR_MAPPER[primary_stem]
        if self.NO_STEM in primary_stem:
            return primary_stem.replace(self.NO_STEM, "")
        return f"{self.NO_STEM}{primary_stem}"

    # ------------------------------------------------------------------- I/O

    def prepare_mix(self, mix) -> np.ndarray:
        """Load + stereo-ify audio to (2, samples) float32; captures input bit
        depth for write-side preservation (ref: common_separator.py:217-282)."""
        if isinstance(mix, np.ndarray):
            pcm = mix
            # soundfile layout (samples, channels) → (channels, samples);
            # covers (N,1) mono columns and multichannel, not just (N,2)
            # (ref contract: common_separator.py:256-263 always transposes).
            if pcm.ndim == 2 and pcm.shape[0] > pcm.shape[1]:
                pcm = pcm.T
            if self.input_bit_depth is None:
                self.input_bit_depth = 16
        else:
            self.capture_input_bit_depth(mix)
            pcm, _ = audio_io.load_audio(mix, sample_rate=self.sample_rate)
            if not np.any(pcm):
                raise ValueError(f"Audio file {mix} is empty or not valid")

        pcm = np.asarray(pcm, dtype=np.float32)
        if pcm.ndim == 2 and pcm.shape[0] == 1:
            pcm = pcm[0]  # load_audio returns (1, N) for mono files
        if pcm.ndim == 1:
            pcm = np.stack([pcm, pcm])
        return pcm

    def capture_input_bit_depth(self, path: str) -> int:
        """Probe + classify the input's bit depth for write-side preservation
        (ref: common_separator.py:230-251); shared by prepare_mix and the VR
        multiband loader."""
        try:
            bits = audio_io.probe(path).bits_per_sample
            self.input_bit_depth = 24 if bits == 24 else 32 if bits >= 32 else 16
        except Exception as exc:
            self.logger.warning(
                f"Could not probe {path}, defaulting to 16-bit output: {exc}")
            self.input_bit_depth = 16
        return self.input_bit_depth

    def write_audio(self, stem_path: str, stem_source: np.ndarray) -> None:
        """Write a (samples, channels) stem with normalisation, near-silent
        guard, and bit-depth preservation (ref: common_separator.py:284-451)."""
        stem_source = spec_ops.normalize(
            stem_source,
            max_peak=self.normalization_threshold,
            min_peak=self.amplification_threshold,
        )
        if np.max(np.abs(stem_source)) < 1e-6:
            # Deviation from the reference (common_separator.py:312-314),
            # which skips the write and leaves callers holding a path to a
            # nonexistent file — breaking chunked merge and ensembling. Write
            # the silent stem so every reported output path exists.
            self.logger.warning("stem_source array is near-silent or empty")

        if self.output_dir:
            os.makedirs(self.output_dir, exist_ok=True)
            stem_path = os.path.join(self.output_dir, stem_path)

        bit_depth = self.input_bit_depth or 16
        fmt = self.output_format.lower()
        bitrate = 0
        if self.output_bitrate:
            bitrate = int(str(self.output_bitrate).lower().rstrip("k"))
        audio_io.save_audio(
            stem_path,
            stem_source.T.astype(np.float32),  # (channels, samples)
            self.sample_rate,
            output_format=fmt,
            bit_depth=bit_depth,
            bitrate_kbps=bitrate,
        )

    def final_process(self, stem_path: str, source: np.ndarray, stem_name: str):
        self.logger.debug(f"Finalizing {stem_name} stem processing and writing audio...")
        self.write_audio(stem_path, source)
        return {stem_name: source}

    # ---------------------------------------------------------------- naming

    @staticmethod
    def sanitize_filename(filename: str) -> str:
        sanitized = re.sub(r'[<>:"/\\|?*]', "_", filename)
        sanitized = re.sub(r"_+", "_", sanitized)
        return sanitized.strip("_. ")

    def get_stem_output_path(self, stem_name: str, custom_output_names: Optional[Dict]) -> str:
        """{base}_({Stem})_{model}.{ext}, or a custom name
        (ref: common_separator.py:489-507)."""
        if custom_output_names:
            lowered = {k.lower(): v for k, v in custom_output_names.items()}
            if stem_name.lower() in lowered:
                return f"{self.sanitize_filename(lowered[stem_name.lower()])}.{self.output_format.lower()}"
        base = self.sanitize_filename(self.audio_file_base or "output")
        stem = self.sanitize_filename(stem_name)
        model = self.sanitize_filename(self.model_name or "model")
        return f"{base}_({stem})_{model}.{self.output_format.lower()}"

    def clear_file_specific_paths(self):
        self.audio_file_path = None
        self.audio_file_base = None
        self.primary_source = None
        self.secondary_source = None
        # Bit depth is per-input: without this reset an ndarray input would
        # inherit the previous file's depth instead of the 16-bit default.
        self.input_bit_depth = None

    # ------------------------------------------------------------- interface

    def separate(self, audio_file_path: str, custom_output_names: Optional[Dict] = None) -> List[str]:
        raise NotImplementedError
