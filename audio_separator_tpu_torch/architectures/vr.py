"""VR architecture separator (cascaded spectrogram U-Nets over a multiband
STFT).

Port of ``audio_separator_tpu/architectures/vr.py`` (ref: audio_separator/
separator/architectures/vr_separator.py): the band JSONs, the architecture
chosen by the checkpoint's size in KB (v5 ``CascadedASPPNet`` or v5.1
``CascadedNet``, offset 128 or 64), the tiled mask inference with optional
TTA, aggression, post-process and high-end mirroring. The whole chain runs on
the separator's device (``ops/vr_chain.py``): the wave goes up once and both
stems come down once; the only other round trip is the post-process's
data-dependent region search, when it is asked for.

``use_autocast`` runs the mask net in bf16 (the JAX package's rounding
points: the net's input cast to bf16, its weights in the input's dtype, the
mask returned in float32; the one departure, the LSTMs computing in float32
on bf16-rounded weights, is ``models/vr_nets._MaskNet.to_compute_dtype``'s);
the chain stays float32.
``separate_batch`` writes each file at its own input bit depth (ROADMAP
Queue C2; the JAX package writes a batch at its last file's depth).

Not carried: the JAX package's ``AUDSEP_VR_CHAIN=host`` switch and its numpy
host chain (the port has no switch between paths), and its quantised
host-device transfers (a TPU-link measure).
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..models.convert import load_torch_state_dict
from ..models.vr_nets import load_vr_net
from ..ops import vr_chain
from ..ops.demix import tiled_mask_predict
from ..ops.fn_cache import file_key, memoized_model
from ..ops.resample import resample_poly_np
from ..ops.vr_bands import merge_artifacts
from ..separator.common import BaseSeparator

NN_ARCH_SIZES = [31191, 33966, 56817, 123821, 123812, 129605, 218409, 537238, 537227]
VR_5_1_MODELS = [56817, 218409]

_PARAMS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "data", "vr_modelparams")


def load_vr_model_params(name: str) -> Dict:
    """A band-definition JSON of the package's ``data/vr_modelparams``
    (ref: vr_network/model_param_init.py:44-71): digit keys as ints, the
    channel-transform flags defaulted to False, ``bins`` set from ``n_bins``."""
    with open(os.path.join(_PARAMS_DIR, f"{name}.json"), encoding="utf-8") as f:
        raw = json.load(f)

    def int_keys(d):
        return {int(k) if isinstance(k, str) and k.isdigit() else k: v for k, v in d.items()}

    param = int_keys(raw)
    if "band" in param:
        param["band"] = int_keys(param["band"])
    for key in ("mid_side", "mid_side_b", "mid_side_b2", "stereo_w", "stereo_n", "reverse"):
        param.setdefault(key, False)
    if "n_bins" in param:
        param["bins"] = param["n_bins"]
    return param


class VRSeparator(BaseSeparator):
    # separate_batch sub-group size: each pending job keeps its stems and
    # chain intermediates on the device until its fetch.
    _BATCH_GROUP = 4

    def __init__(self, common_config: Dict, arch_config: Dict):
        super().__init__(config=common_config)

        # v5.1 by its model data (its widths come from the checkpoint), else
        # by the file's size (_load_network).
        self.is_vr_51_model = "nout" in self.model_data and "nout_lstm" in self.model_data

        self.mp = load_vr_model_params(self.model_data["vr_model_param"])

        self.enable_tta = arch_config.get("enable_tta", False)
        self.enable_post_process = arch_config.get("enable_post_process", False)
        self.post_process_threshold = arch_config.get("post_process_threshold", 0.2)
        self.batch_size = arch_config.get("batch_size") or 4
        self.window_size = arch_config.get("window_size", 512)
        self.high_end_process = arch_config.get("high_end_process", False)
        self.aggression = float(int(arch_config.get("aggression", 5)) / 100)
        self.aggressiveness = {
            "value": self.aggression,
            "split_bin": self.mp["band"][1]["crop_stop"],
            "aggr_correction": self.mp.get("aggr_correction"),
        }
        self.model_samplerate = self.mp["sr"]

        self.net = None
        self._arch_size = None
        self._offset = None

    # ------------------------------------------------------------------ model

    def _load_network(self):
        """The net keyed by the file's size in KB (nearest ``NN_ARCH_SIZES``
        entry), its widths from the checkpoint, on the separator's device."""
        if self.net is not None:
            return
        model_size = math.ceil(os.stat(self.model_path).st_size / 1024)
        arch_size = min(NN_ARCH_SIZES, key=lambda x: abs(x - model_size))
        if arch_size in VR_5_1_MODELS or self.is_vr_51_model:
            self.is_vr_51_model = True
            self._offset = 64
        else:
            self._offset = 128
        self._arch_size = arch_size

        def load_net(device):
            net = load_vr_net(load_torch_state_dict(self.model_path), self.mp["bins"] * 2,
                              arch_size, self.is_vr_51_model, self._offset, device=device)
            return net.to_compute_dtype(torch.bfloat16) if self.use_autocast else net

        def key_for(device: str):
            return ("vr", file_key(self.model_path), device, self.mp["bins"], arch_size,
                    self.is_vr_51_model, self._offset, bool(self.use_autocast))

        # Shared process-wide (ops/fn_cache): a second separator over the same
        # file and settings reads nothing. The state dict is used as it is, so
        # no converted .npz is kept beside it.
        self._replica_args = (key_for, load_net)
        self.net = memoized_model(key_for(str(self.device)), lambda: load_net(self.device))
        self.logger.debug(f"VR model loaded: arch_size={arch_size}, v51={self.is_vr_51_model}")

    def _predict(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, 2, bins+1, window)`` float32 → ``(B, 2, bins+1, roi)`` mask,
        float32, on ``x``'s device (the net's replica there, for a mesh row)."""
        net = self.model_on(x.device, self.net, *self._replica_args)
        return net(x.to(net.out.weight.dtype)).float()

    # --------------------------------------------------------------- separate

    def separate(self, audio_file_path: str, custom_output_names: Optional[Dict] = None):
        self.primary_source = None
        self.secondary_source = None
        self.audio_file_path = audio_file_path
        self.audio_file_base = os.path.splitext(os.path.basename(audio_file_path))[0]
        self._load_network()
        self._set_sources(*self._inference_device_async())
        return self._write_stems(custom_output_names)

    def _set_sources(self, waves: torch.Tensor, out_len: int) -> None:
        """Fetch both stems (the one download) and bring them to the output
        rate as ``(samples, 2)``."""
        host = np.nan_to_num(waves.cpu().numpy(), nan=0.0, posinf=0.0, neginf=0.0)
        self.primary_source = self._to_output_rate(host[0][..., :out_len]).T
        self.secondary_source = self._to_output_rate(host[1][..., :out_len]).T

    def _write_stems(self, custom_output_names: Optional[Dict]) -> list:
        """Write primary then secondary, honouring ``output_single_stem``."""
        if self.output_single_stem and self.output_single_stem.lower() not in (
                self.primary_stem_name.lower(), self.secondary_stem_name.lower()):
            self.logger.warning(
                f"output_single_stem '{self.output_single_stem}' matches neither stem; "
                f"saving both.")
            self.output_single_stem = None
        output_files = []
        for name, source in ((self.primary_stem_name, self.primary_source),
                             (self.secondary_stem_name, self.secondary_source)):
            if not self.output_single_stem or self.output_single_stem.lower() == name.lower():
                path = self.get_stem_output_path(name, custom_output_names)
                self.final_process(path, source, name)
                output_files.append(path)
        return output_files

    def separate_batch(self, audio_file_paths: list,
                       custom_output_names_list: Optional[list] = None) -> list:
        """Separate several files with every job of a group enqueued on the
        device before the first fetch, so that a job's load and upload
        overlap the device work of the jobs before it. Groups hold at most
        ``_BATCH_GROUP`` files. Each output equals the file's solo
        :meth:`separate` and is written at that file's own input bit depth."""
        names = custom_output_names_list or [None] * len(audio_file_paths)
        if len(names) != len(audio_file_paths):
            raise ValueError(
                f"custom_output_names_list has {len(names)} entries for "
                f"{len(audio_file_paths)} files")
        if len(audio_file_paths) <= 1:
            return [self.separate(p, n) for p, n in zip(audio_file_paths, names)]
        if len(audio_file_paths) > self._BATCH_GROUP:
            outputs = []
            for i in range(0, len(audio_file_paths), self._BATCH_GROUP):
                outputs.extend(self.separate_batch(audio_file_paths[i: i + self._BATCH_GROUP],
                                                   names[i: i + self._BATCH_GROUP]))
            return outputs
        self._load_network()

        pending = []
        for path in audio_file_paths:
            self.audio_file_path = path
            pending.append((*self._inference_device_async(), self.input_bit_depth))

        outputs = []
        for path, custom, (waves, out_len, bit_depth) in zip(audio_file_paths, names, pending):
            self.audio_file_path = path
            self.audio_file_base = os.path.splitext(os.path.basename(path))[0]
            self.input_bit_depth = bit_depth
            self._set_sources(waves, out_len)
            outputs.append(self._write_stems(custom))
        return outputs

    def _to_output_rate(self, wave: np.ndarray) -> np.ndarray:
        """``(2, T)`` from the model rate to the configured output rate (the
        writer stamps ``sample_rate`` in the header)."""
        if self.model_samplerate != self.sample_rate:
            return resample_poly_np(wave, self.model_samplerate, self.sample_rate)
        return wave

    # ---------------------------------------------------------- device chain

    def _upload(self, pcm: np.ndarray) -> torch.Tensor:
        wave = torch.from_numpy(np.ascontiguousarray(pcm, np.float32))
        if torch.device(self.device).type == "cuda":  # pinned: need not wait for the queue
            return wave.pin_memory().to(self.device, non_blocking=True)
        return wave

    @torch.no_grad()
    def _inference_device_async(self):
        """Enqueue the current file's whole chain on the device without
        fetching: load at the top band's rate, upload, analyze, the tiled
        mask (and its TTA pass), finalize, the optional post-process, and the
        synthesis of both stems (ref: vr_separator.py:255-375). Returns
        ``(stems (2, 2, T) on the device, output length)``."""
        from ..io import audio as audio_io

        geom = vr_chain.band_geometry(self.mp, self.is_vr_51_model)
        sr_top = self.mp["band"][len(self.mp["band"])]["sr"]
        pcm, _ = audio_io.load_audio(self.audio_file_path, sample_rate=sr_top)
        self.capture_input_bit_depth(self.audio_file_path)
        if pcm.ndim == 2 and pcm.shape[0] == 1:
            pcm = pcm[0]
        if pcm.ndim == 1:
            pcm = np.stack([pcm, pcm])

        spec_c, high_end = vr_chain.analyze(geom, self._upload(pcm))
        n_frame = spec_c.shape[-1]

        window, offset = self.window_size, self._offset
        if window - 2 * offset <= 0:
            raise ValueError("Window size error: h1_shape[3] must be greater than h2_shape[3]")
        roi = window - 2 * offset
        n_tiles = n_frame // roi + 1  # the make_padding tiling of n_frame
        batch = max(1, int(self.batch_size))
        mag = spec_c.abs()
        mx = mag.max()  # the reference normalises by the raw maximum
        pad = torch.nn.functional.pad
        mask = tiled_mask_predict(self._predict, pad(mag, (offset, 0)) / mx, window, offset,
                                  batch, n_tiles, mesh=self.mesh)
        mask_tta = None
        if self.enable_tta:
            mask_tta = tiled_mask_predict(self._predict, pad(mag, (offset + roi // 2, 0)) / mx,
                                          window, offset, batch, n_tiles + 1, mesh=self.mesh)
        mask = vr_chain.finalize(mask, n_frame, roi, self.aggressiveness,
                                 self.primary_stem_name in self.NON_ACCOM_STEMS, mask_tta)
        if self.enable_post_process:
            # Data-dependent region search: the one host round trip, only
            # when asked for.
            host = merge_artifacts(mask.cpu().numpy(), thres=self.post_process_threshold)
            mask = self._upload(host)
        waves = vr_chain.synthesize(geom, mask, spec_c,
                                    high_end if self.high_end_process else None)
        return waves, vr_chain.synth_out_len(geom, n_frame)
