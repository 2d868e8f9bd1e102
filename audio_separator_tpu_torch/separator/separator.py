"""The public ``Separator`` facade of the PyTorch/CUDA port.

Port of ``audio_separator_tpu/separator/separator.py``: the constructor,
device setup, ``load_model`` (registry lookup, model data resolution,
architecture instantiation), ``separate`` and ``_separate_file``. The
MDXC/RoFormer family and Demucs v4 (HTDemucs bags) are ported; the other
families, Demucs v3, ensembles, chunked processing, ``warmup`` and
``separate_batch`` are later slices (ROADMAP, Queue A).

Computation runs on the CUDA device unless the caller passes
``device="cpu"``; without a CUDA device, ``device=None`` raises.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, List, Optional

import torch

from .. import __version__
from ..io import audio as audio_io
from .registry import ModelRegistry
from ..io.yaml_config import read_yaml_config

DEFAULT_MODEL = "model_bs_roformer_ep_317_sdr_12.9755.ckpt"

_AUDIO_EXTENSIONS = (".wav", ".flac", ".mp3", ".ogg", ".opus", ".m4a", ".aiff", ".ac3")


class Separator:
    """Audio stem separation orchestrator (PyTorch; CUDA by default)."""

    def __init__(
        self,
        log_level=logging.INFO,
        log_formatter=None,
        model_file_dir=None,
        output_dir=None,
        output_format="WAV",
        output_bitrate=None,
        normalization_threshold=0.9,
        amplification_threshold=0.0,
        output_single_stem=None,
        invert_using_spec=False,
        sample_rate=44100,
        use_soundfile=False,
        use_autocast=False,
        demucs_params=None,
        mdxc_params=None,
        info_only=False,
        device=None,
    ):
        self.logger = logging.getLogger(__name__)
        self.logger.setLevel(log_level)
        self.log_level = log_level
        self.log_formatter = log_formatter or logging.Formatter(
            "%(asctime)s - %(levelname)s - %(module)s - %(message)s")
        self.log_handler = logging.StreamHandler()
        self.log_handler.setFormatter(self.log_formatter)
        if not self.logger.hasHandlers():
            self.logger.addHandler(self.log_handler)

        if not info_only:
            self.logger.info(f"Separator (PyTorch) version {__version__} instantiating "
                             f"with output_dir: {output_dir}, output_format: {output_format}")

        if model_file_dir is None:
            model_file_dir = (os.environ.get("AUDIO_SEPARATOR_MODEL_DIR")
                              or "/tmp/audio-separator-models/")
        self.model_file_dir = model_file_dir
        os.makedirs(self.model_file_dir, exist_ok=True)

        self.output_dir = output_dir
        self.output_format = output_format or "WAV"
        self.output_bitrate = output_bitrate

        if not 0 < normalization_threshold <= 1:
            raise ValueError("The normalization_threshold must be greater than 0 "
                             "and less than or equal to 1.")
        if not 0 <= amplification_threshold <= 1:
            raise ValueError("The amplification_threshold must be greater than or "
                             "equal to 0 and less than or equal to 1.")
        self.normalization_threshold = normalization_threshold
        self.amplification_threshold = amplification_threshold
        self.output_single_stem = output_single_stem
        self.invert_using_spec = invert_using_spec
        self.sample_rate = int(sample_rate)
        self.use_soundfile = use_soundfile
        self.use_autocast = use_autocast

        self.arch_specific_params = {
            "Demucs": demucs_params if demucs_params is not None else {
                "segment_size": "Default", "shifts": 2, "overlap": 0.25,
                "segments_enabled": True},
            "MDXC": mdxc_params if mdxc_params is not None else {
                "segment_size": 256, "override_model_segment_size": False,
                "batch_size": 4, "overlap": 8, "pitch_shift": 0},
        }

        self.registry = ModelRegistry(self.model_file_dir, self.logger)
        self.model_instance = None
        self.model_filename = None
        self.device = None
        if not info_only:
            self.setup_inferencing_device(device)

    # ----------------------------------------------------------------- device

    def setup_inferencing_device(self, device=None) -> torch.device:
        """``None`` means the CUDA device; ask for ``"cpu"`` explicitly."""
        import platform

        self.logger.info(f"Operating System: {platform.system()} {platform.release()}")
        self.logger.info(f"Python Version: {platform.python_version()}")
        dev = torch.device(device if device is not None else "cuda")
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "no CUDA device available; pass device='cpu' to run the "
                    "plain PyTorch path on the CPU")
            self.logger.info(f"CUDA device: {torch.cuda.get_device_name(dev)}")
        elif dev.type != "cpu":
            raise ValueError(f"unsupported device {dev} (cuda or cpu)")
        self.device = dev
        return dev

    # ------------------------------------------------------------------ model

    def load_model_data_from_yaml(self, yaml_config_filename: str) -> dict:
        path = (yaml_config_filename if os.path.exists(yaml_config_filename)
                else os.path.join(self.model_file_dir, yaml_config_filename))
        self.logger.debug(f"Loading model data from YAML at path {path}")
        model_data = read_yaml_config(path)
        if "roformer" in path.lower():
            model_data["is_roformer"] = True
        return model_data

    def _resolve_model_data(self, model_path: str,
                            yaml_config_filename: Optional[str]) -> dict:
        """Model params by priority: companion/explicit YAML → local sidecar
        ``<model>.json`` → UVR hash lookup."""
        if yaml_config_filename is not None:
            return self.load_model_data_from_yaml(yaml_config_filename)
        sidecar = os.path.splitext(model_path)[0] + ".json"
        if os.path.exists(sidecar):
            self.logger.debug(f"Loading model data from sidecar {sidecar}")
            with open(sidecar, encoding="utf-8") as f:
                return json.load(f)
        return self.registry.load_model_data_using_hash(model_path)

    def load_model(self, model_filename: str = DEFAULT_MODEL):
        """Resolve the model's files (downloading only what is missing from
        ``model_file_dir``) and instantiate its architecture separator."""
        if self.device is None:
            raise ValueError("Separator was built with info_only=True; no device")
        self.model_filename = model_filename
        self.logger.info(f"Loading model {model_filename}...")
        start = time.perf_counter()

        model_filename, model_type, _friendly, model_path, yaml_config_filename = (
            self.registry.download_model_files(model_filename))
        model_name = model_filename.split(".")[0]
        if model_path.lower().endswith(".yaml"):
            yaml_config_filename = model_path
        model_data = self._resolve_model_data(model_path, yaml_config_filename)

        if model_type not in self.arch_specific_params:
            raise NotImplementedError(
                f"model type {model_type} is not ported to PyTorch yet "
                f"(ROADMAP, Queue A); MDXC/RoFormer and Demucs v4 models are")
        if model_type == "Demucs":
            from ..architectures.demucs import DemucsSeparator as separator_class
        else:
            from ..architectures.mdxc import MDXCSeparator as separator_class

        common_params = {
            "logger": self.logger,
            "log_level": self.log_level,
            "model_name": model_name,
            "model_path": model_path,
            "model_data": model_data,
            "output_format": self.output_format,
            "output_bitrate": self.output_bitrate,
            "output_dir": self.output_dir,
            "normalization_threshold": self.normalization_threshold,
            "amplification_threshold": self.amplification_threshold,
            "output_single_stem": self.output_single_stem,
            "invert_using_spec": self.invert_using_spec,
            "sample_rate": self.sample_rate,
            "use_soundfile": self.use_soundfile,
            "use_autocast": self.use_autocast,
            "device": self.device,
        }
        self.model_instance = separator_class(
            common_config=common_params,
            arch_config=self.arch_specific_params[model_type])
        self.logger.info(f"Load model duration: {time.perf_counter() - start:.2f}s")

    # --------------------------------------------------------------- separate

    def separate(self, audio_file_path, custom_output_names: Optional[Dict] = None) -> List[str]:
        """Separate one file, a list of files, or every audio file under a
        directory. Returns the written output paths."""
        if not self.model_instance:
            raise ValueError("Initialization failed or model not loaded. Please "
                             "load a model before attempting to separate.")
        if isinstance(audio_file_path, str):
            audio_file_path = [audio_file_path]

        output_files: List[str] = []
        for path in audio_file_path:
            if os.path.isdir(path):
                for root, _dirs, files in os.walk(path):
                    for file in files:
                        if file.lower().endswith(_AUDIO_EXTENSIONS):
                            full_path = os.path.join(root, file)
                            try:
                                output_files.extend(
                                    self._separate_file(full_path, custom_output_names))
                            except Exception as exc:
                                self.logger.error(f"Failed to process file {full_path}: {exc}")
            elif len(audio_file_path) == 1:
                # A single input surfaces its failure to the caller.
                output_files.extend(self._separate_file(path, custom_output_names))
            else:
                try:
                    output_files.extend(self._separate_file(path, custom_output_names))
                except Exception as exc:
                    self.logger.error(f"Failed to process file {path}: {exc}")
        return output_files

    def _separate_file(self, audio_file_path: str, custom_output_names=None) -> List[str]:
        self.logger.info(f"Starting separation process for audio_file_path: {audio_file_path}")
        start = time.perf_counter()
        output_files = self.model_instance.separate(audio_file_path, custom_output_names)
        self.model_instance.clear_file_specific_paths()
        elapsed = time.perf_counter() - start
        self.logger.info(f"Separation duration: {elapsed:.2f}s")
        try:
            info = audio_io.probe(audio_file_path)
        except (OSError, RuntimeError, ValueError):
            return output_files
        if info.frames > 0 and info.sample_rate > 0 and elapsed > 0:
            self.logger.info(f"Real-time factor: {info.frames / info.sample_rate / elapsed:.1f}x")
        return output_files
