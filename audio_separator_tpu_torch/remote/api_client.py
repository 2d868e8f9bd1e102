"""HTTP client for the remote separation API
(ref: audio_separator/remote/api_client.py:22-530). The port's own copy of
``audio_separator_tpu/remote/api_client.py``; endpoint-compatible with both
packages' servers and the reference's Modal/Cloud Run deployments."""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, List, Optional

import requests


class AudioSeparatorAPIClient:
    def __init__(self, api_url: str, logger: Optional[logging.Logger] = None,
                 api_key: Optional[str] = None):
        self.api_url = api_url.rstrip("/")
        self.logger = logger or logging.getLogger(__name__)
        self.session = requests.Session()
        # Shared-key auth matching server.check_api_key: explicit arg wins,
        # else the same AUDSEP_API_KEY env var the server reads.
        key = api_key or os.environ.get("AUDSEP_API_KEY")
        if key:
            self.session.headers["X-API-Key"] = key

    # ------------------------------------------------------------- submission

    def separate_audio(
        self,
        file_path: Optional[str] = None,
        model: Optional[str] = None,
        models: Optional[List[str]] = None,
        preset: Optional[str] = None,
        gcs_uri: Optional[str] = None,
        output_format: str = "flac",
        output_bitrate: Optional[str] = None,
        normalization_threshold: float = 0.9,
        amplification_threshold: float = 0.0,
        output_single_stem: Optional[str] = None,
        invert_using_spec: bool = False,
        sample_rate: int = 44100,
        use_soundfile: bool = False,
        use_autocast: bool = False,
        custom_output_names: Optional[Dict[str, str]] = None,
        mdx_segment_size: int = 256,
        mdx_overlap: float = 0.25,
        mdx_batch_size: int = 4,
        mdx_hop_length: int = 1024,
        mdx_enable_denoise: bool = False,
        vr_batch_size: int = 4,
        vr_window_size: int = 512,
        vr_aggression: int = 5,
        vr_enable_tta: bool = False,
        vr_high_end_process: bool = False,
        vr_enable_post_process: bool = False,
        vr_post_process_threshold: float = 0.2,
        demucs_segment_size: str = "Default",
        demucs_shifts: int = 2,
        demucs_overlap: float = 0.25,
        demucs_segments_enabled: bool = True,
        mdxc_segment_size: int = 256,
        mdxc_override_model_segment_size: bool = False,
        mdxc_overlap: int = 8,
        mdxc_batch_size: int = 4,
        mdxc_pitch_shift: int = 0,
    ) -> dict:
        """Submit a separation job; returns {"task_id", "status"}."""
        if not file_path and not gcs_uri:
            raise ValueError("Must provide either file_path or gcs_uri")
        if file_path and gcs_uri:
            raise ValueError("Provide either file_path or gcs_uri, not both")

        files = {}
        file_handle = None
        if file_path:
            if not os.path.exists(file_path):
                raise FileNotFoundError(f"Audio file not found: {file_path}")
            file_handle = open(file_path, "rb")
            files = {"file": (os.path.basename(file_path), file_handle)}

        data: Dict[str, object] = {}
        if gcs_uri:
            data["gcs_uri"] = gcs_uri
        if preset:
            data["preset"] = preset
        elif models:
            data["models"] = json.dumps(models)
        elif model:
            data["model"] = model

        data.update({
            "output_format": output_format,
            "normalization_threshold": normalization_threshold,
            "amplification_threshold": amplification_threshold,
            "invert_using_spec": invert_using_spec,
            "sample_rate": sample_rate,
            "use_soundfile": use_soundfile,
            "use_autocast": use_autocast,
            "mdx_segment_size": mdx_segment_size,
            "mdx_overlap": mdx_overlap,
            "mdx_batch_size": mdx_batch_size,
            "mdx_hop_length": mdx_hop_length,
            "mdx_enable_denoise": mdx_enable_denoise,
            "vr_batch_size": vr_batch_size,
            "vr_window_size": vr_window_size,
            "vr_aggression": vr_aggression,
            "vr_enable_tta": vr_enable_tta,
            "vr_high_end_process": vr_high_end_process,
            "vr_enable_post_process": vr_enable_post_process,
            "vr_post_process_threshold": vr_post_process_threshold,
            "demucs_segment_size": demucs_segment_size,
            "demucs_shifts": demucs_shifts,
            "demucs_overlap": demucs_overlap,
            "demucs_segments_enabled": demucs_segments_enabled,
            "mdxc_segment_size": mdxc_segment_size,
            "mdxc_override_model_segment_size": mdxc_override_model_segment_size,
            "mdxc_overlap": mdxc_overlap,
            "mdxc_batch_size": mdxc_batch_size,
            "mdxc_pitch_shift": mdxc_pitch_shift,
        })
        if output_bitrate:
            data["output_bitrate"] = output_bitrate
        if output_single_stem:
            data["output_single_stem"] = output_single_stem
        if custom_output_names:
            data["custom_output_names"] = json.dumps(custom_output_names)

        try:
            if not files:
                files = {"file": ("", b"", "application/octet-stream")}
            response = self.session.post(f"{self.api_url}/separate", files=files,
                                         data=data, timeout=1800)
            response.raise_for_status()
            return response.json()
        except requests.RequestException as exc:
            self.logger.error(f"Separation request failed: {exc}")
            raise
        finally:
            if file_handle:
                file_handle.close()

    def separate_audio_and_wait(
        self,
        file_path: Optional[str] = None,
        download: bool = True,
        output_dir: Optional[str] = None,
        timeout: int = 600,
        poll_interval: float = 2.0,
        **kwargs,
    ) -> dict:
        """Submit, poll until completed, optionally download all outputs
        (ref: api_client.py:172-399)."""
        result = self.separate_audio(file_path=file_path, **kwargs)
        task_id = result["task_id"]
        deadline = time.time() + timeout
        status = {}
        while time.time() < deadline:
            status = self.get_job_status(task_id)
            state = status.get("status")
            if state == "completed":
                break
            if state == "error":
                raise RuntimeError(f"Remote job failed: {status.get('error')}")
            time.sleep(poll_interval)
        else:
            raise TimeoutError(f"Job {task_id} did not finish within {timeout}s")

        downloaded = []
        if download:
            for entry in status.get("files", []):
                path = self.download_file_by_hash(
                    task_id, entry["hash"], entry["filename"], output_dir)
                downloaded.append(path)
        return {"task_id": task_id, "status": status, "downloaded_files": downloaded}

    # ---------------------------------------------------------------- queries

    def get_job_status(self, task_id: str) -> dict:
        response = self.session.get(f"{self.api_url}/status/{task_id}", timeout=30)
        response.raise_for_status()
        return response.json()

    def download_file_by_hash(self, task_id: str, file_hash: str, filename: str,
                              output_dir: Optional[str] = None) -> str:
        response = self.session.get(
            f"{self.api_url}/download/{task_id}/{file_hash}", timeout=300)
        response.raise_for_status()
        # Server-supplied names must not escape output_dir (path traversal).
        out_path = os.path.join(output_dir or ".", os.path.basename(filename))
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "wb") as f:
            f.write(response.content)
        return out_path

    def download_file(self, task_id: str, filename: str,
                      output_dir: Optional[str] = None) -> str:
        from .server import generate_file_hash

        return self.download_file_by_hash(task_id, generate_file_hash(filename),
                                          filename, output_dir)

    def list_models(self, format_type: str = "pretty",
                    filter_by: Optional[str] = None) -> dict:
        endpoint = "/models-json" if format_type == "json" else "/models"
        response = self.session.get(f"{self.api_url}{endpoint}", timeout=60)
        response.raise_for_status()
        models = response.json()
        if filter_by and isinstance(models, dict):
            lowered = filter_by.lower()
            models = {k: v for k, v in models.items()
                      if lowered in json.dumps(v).lower() or lowered in k.lower()}
        return models

    def get_server_version(self) -> str:
        response = self.session.get(f"{self.api_url}/health", timeout=30)
        response.raise_for_status()
        return response.json().get("version", "unknown")
