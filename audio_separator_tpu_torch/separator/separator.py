"""The public ``Separator`` facade of the PyTorch/CUDA port.

Port of ``audio_separator_tpu/separator/separator.py``: the constructor,
device setup, the registry's listing and download methods, ``load_model``
(registry lookup, model data resolution, architecture instantiation),
``separate``, ``separate_batch``, ``warmup``, chunked processing
(``chunk_duration``) and multi-model ensembles (a list of models or a named
preset: each model separates the file, the stems are grouped by their
canonical name and each group is ensembled, ``separator/ensembler.py``). The
four families are ported: MDX (ONNX Conv-TDF), VR (CascadedASPPNet v5 and
CascadedNet v5.1 over the multiband chain), MDXC (BS/Mel RoFormer and
TFC-TDF, MDX23C) and Demucs (v4 HTDemucs and v3 HDemucs bags).
``use_mesh`` spreads each window batch over a device mesh's data axis
(``parallel/mesh.py``, ``ops/demix.py``), with the model replicated on each
row, as in the JAX package.

Computation runs on the CUDA device unless the caller passes
``device="cpu"``; without a CUDA device, ``device=None`` raises.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
import tempfile
import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from .. import __version__
from ..io import audio as audio_io
from ..io.yaml_config import read_yaml_config
from ..utils import tracing
from ..utils.profiling import device_trace
from .chunking import AudioChunker
from .ensembler import ALGORITHMS as VALID_ENSEMBLE_ALGORITHMS
from .ensembler import Ensembler
from .registry import ModelRegistry, _load_data_json, get_model_hash

DEFAULT_MODEL = "model_bs_roformer_ep_317_sdr_12.9755.ckpt"

# A member's stem name → the ensemble group it joins.
STEM_NAME_MAP = {
    "vocals": "Vocals",
    "instrumental": "Instrumental",
    "inst": "Instrumental",
    "karaoke": "Instrumental",
    "other": "Other",
    "no_vocals": "Instrumental",
    "drums": "Drums",
    "bass": "Bass",
    "guitar": "Guitar",
    "piano": "Piano",
    "synthesizer": "Synthesizer",
    "strings": "Strings",
    "woodwinds": "Woodwinds",
    "brass": "Brass",
    "wind inst": "Wind Inst",
    "lead vocals": "Lead Vocals",
    "backing vocals": "Backing Vocals",
    "primary stem": "Primary Stem",
    "secondary stem": "Secondary Stem",
}
# Prefixes dropped from a member's file name in a custom ensemble's output name.
_SLUG_PREFIXES = ("mel_band_roformer_", "melband_roformer_", "bs_roformer_",
                  "model_bs_roformer_", "UVR-MDX-NET-", "UVR_MDXNET_")

_AUDIO_EXTENSIONS = (".wav", ".flac", ".mp3", ".ogg", ".opus", ".m4a", ".aiff", ".ac3")


def resolve_device(device=None) -> torch.device:
    """The device a ``Separator`` computes on: ``None`` means the CUDA device,
    and raises without one; ask for ``"cpu"`` explicitly."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    return dev


class Separator:
    """Audio stem separation orchestrator (PyTorch; CUDA by default)."""

    VALID_ENSEMBLE_ALGORITHMS = VALID_ENSEMBLE_ALGORITHMS

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
        use_directml=False,
        chunk_duration=None,
        mdx_params=None,
        vr_params=None,
        demucs_params=None,
        mdxc_params=None,
        ensemble_algorithm=None,
        ensemble_weights=None,
        ensemble_preset=None,
        info_only=False,
        trace_dir=None,
        use_mesh=False,
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
        if use_directml:
            self.logger.warning("use_directml is ignored: this build runs on CUDA or the CPU")
        self.use_mesh = use_mesh
        self.chunk_duration = chunk_duration
        self.trace_dir = trace_dir

        # Ensembles: a preset supplies the models, and the algorithm and
        # weights where the caller gives none.
        self.ensemble_algorithm = ensemble_algorithm
        self.ensemble_weights = ensemble_weights
        self.ensemble_preset = ensemble_preset
        self._ensemble_preset_models = None
        if ensemble_preset is not None:
            preset = self._load_ensemble_preset(ensemble_preset)
            self._ensemble_preset_models = preset["models"]
            if self.ensemble_algorithm is None:
                self.ensemble_algorithm = preset.get("algorithm", "avg_wave")
            if self.ensemble_weights is None:
                self.ensemble_weights = preset.get("weights")
        if (self.ensemble_algorithm is not None
                and self.ensemble_algorithm not in VALID_ENSEMBLE_ALGORITHMS):
            raise ValueError(f"Invalid ensemble algorithm: {self.ensemble_algorithm}. "
                             f"Valid options: {', '.join(VALID_ENSEMBLE_ALGORITHMS)}")

        self.arch_specific_params = {
            "MDX": mdx_params if mdx_params is not None else {
                "hop_length": 1024, "segment_size": 256, "overlap": 0.25,
                "batch_size": 4, "enable_denoise": False},
            "VR": vr_params if vr_params is not None else {
                "batch_size": 4, "window_size": 512, "aggression": 5,
                "enable_tta": False, "enable_post_process": False,
                "post_process_threshold": 0.2, "high_end_process": False},
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
        self.model_filenames: List[str] = []
        self.model_is_uvr_vip = False
        self.model_friendly_name = None
        self.device = None
        if not info_only:
            self.setup_inferencing_device(device)

    # ----------------------------------------------------------------- device

    def setup_inferencing_device(self, device=None) -> torch.device:
        """``None`` means the CUDA device; ask for ``"cpu"`` explicitly."""
        import platform

        self.logger.info(f"Operating System: {platform.system()} {platform.release()}")
        self.logger.info(f"Python Version: {platform.python_version()}")
        dev = resolve_device(device)
        if dev.type == "cuda":
            self.logger.info(f"CUDA device: {torch.cuda.get_device_name(dev)}")
        self.device = dev
        return dev

    def _resolve_mesh(self):
        """The device mesh the engine splits window batches over, or None.

        ``use_mesh=True``: every local CUDA device on a pure-data mesh; on the
        CPU, or with one card, None (the plain path, said in a debug log). A
        ``parallel.mesh.Mesh`` passes through; its first device must be the
        separator's, and a model axis wider than one is not used for tensor
        parallelism (the model is replicated on each row, as the JAX
        ``Separator`` does)."""
        if not self.use_mesh:
            return None
        from ..parallel.mesh import canonical_device, make_mesh

        if self.use_mesh is not True:
            mesh = self.use_mesh
            if canonical_device(mesh.first) != canonical_device(self.device):
                raise ValueError(f"use_mesh: the mesh's first device {mesh.first} is not the "
                                 f"separator's device {self.device}")
            return mesh
        if self.device.type != "cuda" or torch.cuda.device_count() <= 1:
            self.logger.debug("use_mesh requested but only one device present: "
                              "demixing on the plain path")
            return None
        mesh = make_mesh()
        self.logger.info(f"demixing over device mesh {dict(mesh.shape)}")
        return mesh

    # --------------------------------------------------------------- registry

    def list_supported_model_files(self):
        return self.registry.list_supported_model_files()

    def download_model_files(self, model_filename: str):
        result = self.registry.download_model_files(model_filename)
        self.model_friendly_name = result[2]
        self.model_is_uvr_vip = "VIP" in (self.model_friendly_name or "")
        self.print_uvr_vip_message()
        return result

    def get_model_hash(self, model_path: str) -> str:
        return get_model_hash(model_path)

    def print_uvr_vip_message(self):
        if self.model_is_uvr_vip:
            self.logger.warning(
                f"The model: '{self.model_friendly_name}' is a VIP model, intended by "
                f"Anjok07 for access by paying subscribers only.")
            self.logger.warning(
                "If you are not already subscribed, please consider supporting the "
                "developer of UVR, Anjok07 by subscribing here: https://patreon.com/uvr")

    def get_simplified_model_list(self, filter_sort_by: Optional[str] = None):
        """Flat ``{filename: {Name, Type, Stems, SDR}}`` listing, sorted by
        ``name`` or ``filename``, or filtered to a stem and sorted by its SDR."""
        simplified = {}
        for model_type, models in self.list_supported_model_files().items():
            for name, data in models.items():
                scores = data.get("scores") or {}
                target_stem = data.get("target_stem")
                stems_with_scores, stem_sdr = [], {}
                for stem in data.get("stems") or []:
                    stem_scores = scores.get(stem, {})
                    display = f"{stem}*" if stem == target_stem else stem
                    if isinstance(stem_scores, dict) and "SDR" in stem_scores:
                        sdr = round(stem_scores["SDR"], 1)
                        stems_with_scores.append(f"{display} ({sdr})")
                        stem_sdr[stem.lower()] = sdr
                    else:
                        stems_with_scores.append(display)
                        stem_sdr[stem.lower()] = None
                if not stems_with_scores:
                    stems_with_scores = ["Unknown"]
                    stem_sdr["unknown"] = None
                simplified[data["filename"]] = {
                    "Name": name, "Type": model_type,
                    "Stems": stems_with_scores, "SDR": stem_sdr,
                }

        if not filter_sort_by:
            return simplified
        if filter_sort_by == "name":
            return dict(sorted(simplified.items(), key=lambda x: x[1]["Name"]))
        if filter_sort_by == "filename":
            return dict(sorted(simplified.items()))
        key = filter_sort_by.lower()
        filtered = {k: v for k, v in simplified.items() if key in v["SDR"]}

        def sort_key(item):
            sdr = item[1]["SDR"][key]
            return (0 if sdr is None else 1, sdr if sdr is not None else float("-inf"))

        return dict(sorted(filtered.items(), key=sort_key, reverse=True))

    # ------------------------------------------------------------------ model

    def load_model_data_from_yaml(self, yaml_config_filename: str) -> dict:
        path = (yaml_config_filename if os.path.exists(yaml_config_filename)
                else os.path.join(self.model_file_dir, yaml_config_filename))
        self.logger.debug(f"Loading model data from YAML at path {path}")
        model_data = read_yaml_config(path)
        if "roformer" in path.lower():
            model_data["is_roformer"] = True
        return model_data

    def load_model_data_using_hash(self, model_path: str) -> dict:
        """The UVR registry's model data for the file at ``model_path``, keyed
        by its hash (downloading the registry's data files if they are not in
        ``model_file_dir``)."""
        return self.registry.load_model_data_using_hash(model_path)

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
        return self.load_model_data_using_hash(model_path)

    def load_model(self, model_filename: Union[str, List[str]] = DEFAULT_MODEL):
        """Resolve the model's files (downloading only what is missing from
        ``model_file_dir``) and instantiate its architecture separator. A list
        of two or more models (or the preset's, when the default is asked
        for) makes an ensemble: its members load one at a time, at each
        :meth:`separate`."""
        if self.device is None:
            raise ValueError("Separator was built with info_only=True; no device")
        if self._ensemble_preset_models is not None and model_filename == DEFAULT_MODEL:
            model_filename = self._ensemble_preset_models
        if isinstance(model_filename, list):
            if len(model_filename) > 1:
                self.model_filename = list(model_filename)
                self.model_filenames = list(model_filename)
                self.logger.info(f"Multiple models specified for ensembling: "
                                 f"{self.model_filenames}")
                return
            model_filename = model_filename[0]
        self.model_filename = model_filename
        self.model_filenames = [model_filename]
        self.logger.info(f"Loading model {model_filename}...")
        start = time.perf_counter()

        model_filename, model_type, _friendly, model_path, yaml_config_filename = (
            self.download_model_files(model_filename))
        model_name = model_filename.split(".")[0]
        if model_path.lower().endswith(".yaml"):
            yaml_config_filename = model_path
        model_data = self._resolve_model_data(model_path, yaml_config_filename)

        if model_type == "Demucs":
            from ..architectures.demucs import DemucsSeparator as separator_class
        elif model_type == "MDX":
            from ..architectures.mdx import MDXSeparator as separator_class
        elif model_type == "VR":
            from ..architectures.vr import VRSeparator as separator_class
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
            "mesh": self._resolve_mesh(),
        }
        self.model_instance = separator_class(
            common_config=common_params,
            arch_config=self.arch_specific_params[model_type])
        self.logger.info(f"Load model duration: {time.perf_counter() - start:.2f}s")

    def download_model_and_data(self, model_filename: str):
        """Download a model and its config or data without loading it."""
        self.logger.info(f"Downloading model {model_filename}...")
        model_filename, model_type, friendly_name, model_path, yaml_config_filename = (
            self.download_model_files(model_filename))
        if model_path.lower().endswith(".yaml"):
            yaml_config_filename = model_path
        model_data = self._resolve_model_data(model_path, yaml_config_filename)
        self.logger.info(
            f"Model downloaded, type: {model_type}, friendly name: {friendly_name}, "
            f"model_path: {model_path}, model_data: {len(model_data)} items")

    # --------------------------------------------------------------- separate

    def separate(self, audio_file_path, custom_output_names: Optional[Dict] = None) -> List[str]:
        """Separate one file, a list of files, or every audio file under a
        directory. Returns the written output paths. One request of the
        program's spans (``utils/tracing.py``): ``separate.request``."""
        with tracing.request(), tracing.span("separate.request"):
            return self._separate(audio_file_path, custom_output_names)

    def _separate(self, audio_file_path, custom_output_names: Optional[Dict]) -> List[str]:
        if not (self.model_instance or self._is_ensemble()):
            raise ValueError("Initialization failed or model not loaded. Please "
                             "load a model before attempting to separate.")
        if self._is_ensemble():
            return self._separate_ensemble(audio_file_path, custom_output_names)
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

    def separate_batch(self, audio_file_paths: List[str],
                       custom_output_names_list: Optional[List] = None) -> List[List[str]]:
        """Separate several files, sharing one engine pass where the loaded
        architecture batches across jobs (the MDXC RoFormer branch,
        ``ops/demix.demix_jobs``); otherwise, and whenever ``chunk_duration``
        is set, one :meth:`separate` a file. Returns one output-file list per
        input path, in order. One request of the program's spans, as
        :meth:`separate`."""
        with tracing.request(), tracing.span("separate.request", files=len(audio_file_paths)):
            return self._separate_batch(audio_file_paths, custom_output_names_list)

    def _separate_batch(self, audio_file_paths: List[str],
                        custom_output_names_list: Optional[List]) -> List[List[str]]:
        if not self.model_instance:
            raise ValueError("Load a model before calling separate_batch.")
        names = custom_output_names_list or [None] * len(audio_file_paths)
        if len(names) != len(audio_file_paths):
            raise ValueError("custom_output_names_list length mismatch")
        batch_fn = getattr(self.model_instance, "separate_batch", None)
        # chunk_duration bounds what one engine pass holds; the batch path
        # would run whole tracks and skip the split, so it goes file by file.
        if batch_fn is not None and len(audio_file_paths) > 1 and self.chunk_duration is None:
            with device_trace(self.trace_dir, self.logger):
                outputs = batch_fn(audio_file_paths, names)
            self.model_instance.clear_file_specific_paths()
            return outputs
        return [self._separate_file(p, n) for p, n in zip(audio_file_paths, names)]

    def warmup(self, seconds: float = 8.0) -> float:
        """Run the loaded model once on a seeded synthetic track of
        ``seconds`` through :meth:`separate` (chunking included), so that the
        first user request does not pay the first call's costs (kernel
        builds and loads, cuDNN and cuFFT plans, allocator growth). Outputs
        go to a temporary directory and are discarded. Returns the elapsed
        seconds."""
        if not (self.model_instance or self._is_ensemble()):
            raise ValueError("Load a model before warming up.")
        start = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="audsep_warmup_") as td:
            path = os.path.join(td, "warmup.wav")
            noise = (np.random.default_rng(0).standard_normal(
                (2, max(1, int(seconds * self.sample_rate)))) * 0.05).astype(np.float32)
            audio_io.save_audio(path, noise, self.sample_rate)
            prev_output_dir = self.output_dir
            self.output_dir = td
            if self.model_instance:
                self.model_instance.output_dir = td
            try:
                self.separate(path)
            finally:
                self.output_dir = prev_output_dir
                if self.model_instance:
                    self.model_instance.clear_file_specific_paths()
                    self.model_instance.output_dir = prev_output_dir
        elapsed = time.perf_counter() - start
        self.logger.info(f"Warmup separation took {elapsed:.1f}s ({seconds:.0f}s synthetic track)")
        return elapsed

    def _separate_file(self, audio_file_path: str, custom_output_names=None) -> List[str]:
        if self.chunk_duration is not None:
            chunker = AudioChunker(self.chunk_duration, self.logger)
            if chunker.should_chunk(audio_file_path):
                self.logger.info(
                    f"File exceeds chunk size {self.chunk_duration}s, using chunked processing")
                return self._process_with_chunking(audio_file_path, custom_output_names)

        self.logger.info(f"Starting separation process for audio_file_path: {audio_file_path}")
        start = time.perf_counter()
        with device_trace(self.trace_dir, self.logger):
            output_files = self.model_instance.separate(audio_file_path, custom_output_names)
        self.model_instance.clear_file_specific_paths()
        self.print_uvr_vip_message()
        elapsed = time.perf_counter() - start
        self.logger.info(f"Separation duration: {elapsed:.2f}s")
        try:
            info = audio_io.probe(audio_file_path)
        except (OSError, RuntimeError, ValueError):
            return output_files
        if info.frames > 0 and info.sample_rate > 0 and elapsed > 0:
            self.logger.info(f"Real-time factor: {info.frames / info.sample_rate / elapsed:.1f}x")
        return output_files

    def _process_with_chunking(self, audio_file_path: str, custom_output_names=None) -> List[str]:
        """Split into ``chunk_duration`` pieces (float32 WAV intermediates),
        separate each, and merge each stem's pieces in order."""
        temp_dir = tempfile.mkdtemp(prefix="audio-separator-chunks-")
        try:
            chunker = AudioChunker(self.chunk_duration, self.logger)
            chunk_paths = chunker.split_audio(audio_file_path, temp_dir)
            chunks_by_stem: Dict[str, List[str]] = {}

            for i, chunk_path in enumerate(chunk_paths):
                self.logger.info(f"Processing chunk {i + 1}/{len(chunk_paths)}: {chunk_path}")
                original_chunk_duration = self.chunk_duration
                original_output_dir = self.output_dir
                original_model_output_dir = self.model_instance.output_dir
                self.chunk_duration = None
                self.output_dir = temp_dir
                self.model_instance.output_dir = temp_dir
                try:
                    outputs = self._separate_file(chunk_path)
                    for stem_index, stem_path in enumerate(outputs):
                        match = re.search(r"_\(([^)]+)\)", os.path.basename(stem_path))
                        # Positional keys stay stable across chunks, so an
                        # unmatched output still merges per stem.
                        stem_name = match.group(1) if match else f"stem_{stem_index}"
                        abs_path = (stem_path if os.path.isabs(stem_path)
                                    else os.path.join(temp_dir, stem_path))
                        chunks_by_stem.setdefault(stem_name, []).append(abs_path)
                finally:
                    self.chunk_duration = original_chunk_duration
                    self.output_dir = original_output_dir
                    self.model_instance.output_dir = original_model_output_dir

            base_name = os.path.splitext(os.path.basename(audio_file_path))[0]
            output_files = []
            for stem_name in sorted(chunks_by_stem):
                paths = chunks_by_stem[stem_name]
                if custom_output_names and stem_name in custom_output_names:
                    output_filename = custom_output_names[stem_name]
                else:
                    output_filename = f"{base_name}_({stem_name})"
                output_path = os.path.join(
                    self.output_dir or ".", f"{output_filename}.{self.output_format.lower()}")
                self.logger.info(f"Merging {len(paths)} chunks for stem: {stem_name}")
                chunker.merge_chunks(paths, output_path)
                output_files.append(output_path)
            return output_files
        finally:
            shutil.rmtree(temp_dir, ignore_errors=True)

    # --------------------------------------------------------------- ensemble

    def _is_ensemble(self) -> bool:
        return isinstance(self.model_filename, list) and len(self.model_filename) > 1

    @staticmethod
    def _ensemble_group(raw_name: str, stem_names: List[str]) -> str:
        """The canonical stem name a member's stem is ensembled under."""
        lower = raw_name.lower()
        if "vocal" in lower and "lead" not in lower and "backing" not in lower:
            return "Vocals"
        if lower == "other" and len(stem_names) == 2 and any(
                "vocal" in s.lower() for s in stem_names):
            return "Instrumental"
        return STEM_NAME_MAP.get(lower, raw_name.title())

    def _ensemble_output_name(self, base_name: str, stem_name: str, members: List[str],
                              custom_output_names: Optional[Dict]) -> str:
        if custom_output_names and stem_name in custom_output_names:
            return custom_output_names[stem_name]
        if self.ensemble_preset:
            return f"{base_name}_({stem_name})_preset_{self.ensemble_preset}"
        slugs = []
        for mf in members:
            name = os.path.splitext(mf)[0]
            for prefix in _SLUG_PREFIXES:
                if name.startswith(prefix):
                    name = name[len(prefix):]
                    break
            slugs.append(name[:12])
        return f"{base_name}_({stem_name})_custom_ensemble_{'_'.join(slugs)}"

    def _separate_ensemble(self, audio_file_path, custom_output_names=None) -> List[str]:
        """Each member separates the file into a temporary directory; its
        stems are grouped by canonical name, each group is ensembled (on the
        separator's device for the spectral algorithms) and written once
        (ref: separator.py:1242-1412). A group whose members are all mono
        stays mono."""
        if isinstance(audio_file_path, str):
            audio_file_path = [audio_file_path]
        output_files: List[str] = []
        members = list(self.model_filenames)
        ensembler = Ensembler(self.logger, self.ensemble_algorithm or "avg_wave",
                              self.ensemble_weights, device=self.device)
        for path in audio_file_path:
            self.logger.info(f"Ensemble processing for file: {path}")
            temp_dir = tempfile.mkdtemp(prefix="audio-separator-ensemble-")
            original_output_dir = self.output_dir
            try:
                stems_by_type: Dict[str, List[str]] = {}
                for model_filename in members:
                    self.logger.info(f"Processing with model: {model_filename}")
                    self.load_model(model_filename)
                    self.output_dir = temp_dir
                    self.model_instance.output_dir = temp_dir
                    try:
                        model_stems = self._separate_file(path, None)
                    finally:
                        self.output_dir = original_output_dir
                    stem_names = []
                    for stem_path in model_stems:
                        match = re.search(r"_\(([^)]+)\)", os.path.basename(stem_path))
                        stem_names.append(match.group(1) if match else "Unknown")
                    for stem_path, raw_name in zip(model_stems, stem_names):
                        abs_path = (stem_path if os.path.isabs(stem_path)
                                    else os.path.join(temp_dir, stem_path))
                        stems_by_type.setdefault(
                            self._ensemble_group(raw_name, stem_names), []).append(abs_path)

                base_name = os.path.splitext(os.path.basename(path))[0]
                for stem_name, stem_paths in stems_by_type.items():
                    self.logger.info(f"Ensembling {len(stem_paths)} stems for type: {stem_name}")
                    waveforms, channels = [], 1
                    for sp in stem_paths:
                        wav, _sr = audio_io.load_audio(sp, sample_rate=self.sample_rate)
                        channels = max(channels, wav.shape[0])
                        waveforms.append(np.vstack([wav, wav]) if wav.shape[0] == 1 else wav)
                    ensembled = ensembler.ensemble(waveforms)
                    if channels == 1:
                        ensembled = ensembled[:1, :]
                    name = self._ensemble_output_name(base_name, stem_name, members,
                                                      custom_output_names)
                    output_path = f"{name}.{self.output_format.lower()}"
                    self.model_instance.audio_file_path = path
                    self.model_instance.output_dir = self.output_dir
                    self.model_instance.write_audio(output_path, ensembled.T)
                    output_files.append(os.path.join(self.output_dir or ".", output_path))
            finally:
                self.model_filename = members
                self.model_filenames = members
                self.model_instance = None
                shutil.rmtree(temp_dir, ignore_errors=True)
        return output_files

    # ---------------------------------------------------------------- presets

    def _load_ensemble_preset(self, preset_name: str) -> dict:
        presets = self.list_ensemble_presets()
        if preset_name not in presets:
            available = ", ".join(sorted(presets.keys()))
            raise ValueError(
                f"Unknown ensemble preset: '{preset_name}'. Available presets: {available}")
        preset = presets[preset_name]
        models = preset.get("models", [])
        if not isinstance(models, list) or len(models) < 2:
            raise ValueError(f"Ensemble preset '{preset_name}' must specify at least 2 models")
        algorithm = preset.get("algorithm", "avg_wave")
        if algorithm not in VALID_ENSEMBLE_ALGORITHMS:
            raise ValueError(
                f"Ensemble preset '{preset_name}' has unknown algorithm: '{algorithm}'")
        weights = preset.get("weights")
        if weights is not None and (not isinstance(weights, list) or len(weights) != len(models)):
            raise ValueError(
                f"Ensemble preset '{preset_name}' weights length must match models count")
        self.logger.info(
            f"Loaded ensemble preset '{preset_name}': {preset.get('name', preset_name)} — "
            f"{preset.get('description', '')}")
        return preset

    def list_ensemble_presets(self) -> dict:
        """The presets of the package's own ``data/ensemble_presets.json``."""
        return _load_data_json("ensemble_presets.json").get("presets", {})
