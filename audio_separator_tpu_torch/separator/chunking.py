"""Long-file chunked processing.

Port of ``audio_separator_tpu/separator/chunking.py`` over this package's WAV
I/O: split an input into fixed-duration chunk files, let the separator
process each, and concatenate the per-stem outputs.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional

import numpy as np

from ..io import audio as audio_io


class AudioChunker:
    def __init__(self, chunk_duration_seconds: float, logger: Optional[logging.Logger] = None):
        self.chunk_duration_seconds = float(chunk_duration_seconds)
        self.logger = logger or logging.getLogger(__name__)

    def should_chunk(self, input_path: str) -> bool:
        """True when the file is longer than the chunk duration."""
        try:
            info = audio_io.probe(input_path)
        except (OSError, RuntimeError, ValueError) as exc:
            self.logger.warning(f"Could not probe {input_path}: {exc}")
            return False
        if info.frames <= 0:
            return False
        return (info.frames / info.sample_rate) > self.chunk_duration_seconds

    def split_audio(self, input_path: str, output_dir: str) -> List[str]:
        if not os.path.exists(input_path):
            raise FileNotFoundError(f"Input file not found: {input_path}")
        os.makedirs(output_dir, exist_ok=True)

        pcm, sr = audio_io.load_audio(input_path)
        chunk_samples = int(self.chunk_duration_seconds * sr)
        total = pcm.shape[1]
        num_chunks = -(-total // chunk_samples)
        self.logger.info(
            f"Splitting {total / sr:.1f}s audio into {num_chunks} chunks of "
            f"{self.chunk_duration_seconds:.1f}s each")

        paths = []
        for i in range(num_chunks):
            start = i * chunk_samples
            piece = pcm[:, start : min(start + chunk_samples, total)]
            # Chunks are intermediates: float32 WAV, so a 24-bit or float
            # input is not quantised to 16 bits between the split and the
            # merge.
            path = os.path.join(output_dir, f"chunk_{i:04d}.wav")
            audio_io.save_audio(path, piece, sr, output_format="wav", bit_depth=32)
            paths.append(path)
        return paths

    def merge_chunks(self, chunk_paths: List[str], output_path: str) -> str:
        if not chunk_paths:
            raise ValueError("No chunks to merge")
        pieces, sr = [], None
        for path in chunk_paths:
            pcm, sr_i = audio_io.load_audio(path)
            if sr is None:
                sr = sr_i
            elif sr_i != sr:
                raise ValueError(f"Sample-rate mismatch while merging: {sr_i} != {sr}")
            pieces.append(pcm)
        merged = np.concatenate(pieces, axis=1)
        out_dir = os.path.dirname(output_path)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
        fmt = os.path.splitext(output_path)[1].lstrip(".") or "wav"
        audio_io.save_audio(output_path, merged, sr, output_format=fmt)
        return output_path
