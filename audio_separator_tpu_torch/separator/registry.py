"""Model registry: listing, download, and hash identification.

Port of ``audio_separator_tpu/separator/registry.py`` over this package's own
copy of ``data/registry.json``, ``data/scores.json`` and
``data/model-data-overrides.json``, merged with the UVR remote lists fetched
at run time when the network is reachable. Nothing is downloaded when the
files are already in ``model_file_dir``. ``requests`` and ``tqdm`` are
imported only when a download actually starts.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
from typing import Dict, Optional

logger = logging.getLogger(__name__)

UVR_APP_DATA_URL = "https://raw.githubusercontent.com/TRvlvr/application_data/main"
PUBLIC_MODEL_REPO = "https://github.com/TRvlvr/model_repo/releases/download/all_public_uvr_models"
VIP_MODEL_REPO = "https://github.com/Anjok0109/ai_magic/releases/download/v5"
AUDIO_SEPARATOR_REPO = "https://github.com/nomadkaraoke/python-audio-separator/releases/download/model-configs"

_ARCH_KEYS = {"vr": "VR", "mdx": "MDX", "mdxc": "MDXC", "demucs": "Demucs"}


_DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")


def _load_data_json(name: str) -> dict:
    with open(os.path.join(_DATA_DIR, name), encoding="utf-8") as f:
        return json.load(f)


def get_model_hash(model_path: str) -> str:
    """MD5 of the last 10,240,000 bytes."""
    part = 10_240_000
    size = os.path.getsize(model_path)
    with open(model_path, "rb") as f:
        if size > part:
            f.seek(-part, os.SEEK_END)
        return hashlib.md5(f.read()).hexdigest()


class ModelRegistry:
    def __init__(self, model_file_dir: str, logger_: Optional[logging.Logger] = None,
                 allow_network: bool = True):
        self.model_file_dir = model_file_dir
        self.logger = logger_ or logger
        self.allow_network = allow_network
        os.makedirs(model_file_dir, exist_ok=True)

    # -------------------------------------------------------------- download

    def download_file_if_not_exists(self, url: str, output_path: str) -> None:
        if os.path.isfile(output_path):
            return
        if not self.allow_network:
            raise RuntimeError(f"network disabled; cannot fetch {url}")
        import requests
        from tqdm import tqdm

        self.logger.debug(f"Downloading {url} -> {output_path}")
        response = requests.get(url, stream=True, timeout=300)
        if response.status_code != 200:
            raise RuntimeError(f"Failed to download {url}: HTTP {response.status_code}")
        total = int(response.headers.get("content-length", 0))
        bar = tqdm(total=total, unit="iB", unit_scale=True, disable=total == 0)
        tmp_path = output_path + ".part"
        with open(tmp_path, "wb") as f:
            for block in response.iter_content(chunk_size=1 << 16):
                bar.update(len(block))
                f.write(block)
        bar.close()
        os.replace(tmp_path, output_path)

    # --------------------------------------------------------------- listing

    def _remote_download_checks(self) -> dict:
        path = os.path.join(self.model_file_dir, "download_checks.json")
        try:
            self.download_file_if_not_exists(
                f"{UVR_APP_DATA_URL}/filelists/download_checks.json", path)
            with open(path, encoding="utf-8") as f:
                return json.load(f)
        except Exception as exc:
            self.logger.debug(f"UVR remote registry unavailable ({exc}); using local registry only")
            return {}

    def list_supported_model_files(self) -> Dict[str, Dict[str, dict]]:
        """Grouped {arch: {friendly_name: info}}."""
        local = _load_data_json("registry.json")
        scores = _load_data_json("scores.json")
        remote = self._remote_download_checks()

        def info_for(filename: str, download_files: list) -> dict:
            s = scores.get(filename, {})
            return {
                "filename": filename,
                "scores": s.get("median_scores", {}),
                "stems": s.get("stems", []),
                "target_stem": s.get("target_stem"),
                "download_files": download_files,
            }

        grouped: Dict[str, Dict[str, dict]] = {"VR": {}, "MDX": {}, "Demucs": {}, "MDXC": {}}

        # Remote UVR lists (flat {name: filename} and nested mdx23c/roformer).
        for name, filename in {**remote.get("vr_download_list", {})}.items():
            grouped["VR"][name] = info_for(filename, [filename])
        for name, filename in {**remote.get("mdx_download_list", {}),
                               **remote.get("mdx_download_vip_list", {})}.items():
            grouped["MDX"][name] = info_for(filename, [filename])
        for name, files in {k: v for k, v in remote.get("demucs_download_list", {}).items()
                            if k.startswith("Demucs v4")}.items():
            yaml_file = next((fn for fn in files if fn.endswith(".yaml")), None)
            if yaml_file:
                grouped["Demucs"][name] = info_for(yaml_file, list(files.values()))
        for name, files in {**remote.get("mdx23c_download_list", {}),
                            **remote.get("mdx23c_download_vip_list", {}),
                            **remote.get("roformer_download_list", {})}.items():
            model_files = list(files.keys())
            grouped["MDXC"][name] = info_for(model_files[0], model_files + list(files.values()))

        # Local first-party registry (takes precedence).
        for arch_key, arch_name in _ARCH_KEYS.items():
            for name, entry in local.get(arch_key, {}).items():
                grouped[arch_name][name] = info_for(entry["filename"], entry["download_files"])
        return grouped

    # ---------------------------------------------------------------- lookup

    def _local_demucs_package(self, fname: str) -> bool:
        """A Demucs package ``<signature>-<checksum>.th`` is resolved inside
        ``model_file_dir`` by its signature alone (the bag's YAML names only
        signatures), so a local package of that signature stands in for the
        listed file and nothing is fetched."""
        if not fname.endswith(".th"):
            return False
        sig = fname.split("-", 1)[0]
        return any(fn.endswith(".th") and (fn.split("-", 1)[0] == sig or fn[:-3] == sig)
                   for fn in os.listdir(self.model_file_dir))

    def download_model_files(self, model_filename: str):
        """Resolve + download all files for a model.

        Returns (model_filename, model_type, friendly_name, model_path,
        yaml_config_filename).
        """
        model_path = os.path.join(self.model_file_dir, model_filename)
        grouped = self.list_supported_model_files()
        yaml_config_filename = None

        for model_type, models in grouped.items():
            for friendly_name, model_info in models.items():
                if not (model_info["filename"] == model_filename
                        or model_filename in model_info["download_files"]):
                    continue
                is_vip = "VIP" in friendly_name
                repo = VIP_MODEL_REPO if is_vip else PUBLIC_MODEL_REPO
                for file_to_download in model_info["download_files"]:
                    if file_to_download.startswith("http"):
                        fname = file_to_download.rsplit("/", 1)[-1]
                        if self._local_demucs_package(fname):
                            continue
                        self.download_file_if_not_exists(
                            file_to_download, os.path.join(self.model_file_dir, fname))
                        continue
                    download_path = os.path.join(self.model_file_dir, file_to_download)
                    if model_type == "MDXC" and file_to_download.endswith(".yaml"):
                        yaml_config_filename = file_to_download
                        try:
                            self.download_file_if_not_exists(
                                f"{repo}/mdx_model_data/mdx_c_configs/{file_to_download}",
                                download_path)
                        except Exception as exc:
                            # Any failure mode (HTTP error, connection reset,
                            # timeout) tries the mirror before giving up.
                            self.logger.warning(
                                f"primary repo failed for {file_to_download}: {exc}; trying mirror")
                            self.download_file_if_not_exists(
                                f"{AUDIO_SEPARATOR_REPO}/{file_to_download}", download_path)
                        continue
                    try:
                        self.download_file_if_not_exists(f"{repo}/{file_to_download}", download_path)
                    except Exception as exc:
                        self.logger.warning(
                            f"primary repo failed for {file_to_download}: {exc}; trying mirror")
                        self.download_file_if_not_exists(
                            f"{AUDIO_SEPARATOR_REPO}/{file_to_download}", download_path)
                return model_filename, model_type, friendly_name, model_path, yaml_config_filename

        # Local/custom model fallback: an absolute path, or a file already in
        # model_file_dir, loads without a registry entry. Type is inferred
        # from the extension; an MDXC companion YAML is picked up by stem.
        local = (model_filename if os.path.isabs(model_filename)
                 and os.path.exists(model_filename) else model_path)
        if os.path.exists(local):
            ext = os.path.splitext(local)[1].lower()
            ext_type = {".onnx": "MDX", ".pth": "VR", ".yaml": "Demucs",
                        ".ckpt": "MDXC", ".th": "Demucs"}.get(ext)
            if ext_type:
                yaml_side = os.path.splitext(local)[0] + ".yaml"
                yaml_name = (yaml_side if ext_type == "MDXC"
                             and os.path.exists(yaml_side) else None)
                self.logger.info(
                    f"Model {model_filename} not in the registry; loading as a "
                    f"local {ext_type} model from {local}")
                return (os.path.basename(local), ext_type,
                        f"Local model: {os.path.basename(local)}", local, yaml_name)

        raise ValueError(f"Model file {model_filename} not found in supported model files")

    # ------------------------------------------------------------ model data

    def load_model_data_using_hash(self, model_path: str) -> dict:
        """Hash → UVR params lookup."""
        model_hash = get_model_hash(model_path)
        merged: dict = {}
        for name, url in (
            ("vr_model_data.json", f"{UVR_APP_DATA_URL}/vr_model_data/model_data_new.json"),
            ("mdx_model_data.json", f"{UVR_APP_DATA_URL}/mdx_model_data/model_data_new.json"),
        ):
            path = os.path.join(self.model_file_dir, name)
            try:
                self.download_file_if_not_exists(url, path)
                with open(path, encoding="utf-8") as f:
                    merged.update(json.load(f))
            except Exception as exc:
                self.logger.debug(f"model data source {name} unavailable: {exc}")
        overrides = _load_data_json("model-data-overrides.json")
        merged.update(overrides.get("vr_model_data", {}))
        merged.update(overrides.get("mdx_model_data", {}))
        if model_hash not in merged:
            raise ValueError(
                f"Unsupported Model File: parameters for MD5 hash {model_hash} "
                f"could not be found in UVR model data")
        return merged[model_hash]
