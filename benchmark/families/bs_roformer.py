"""BS-RoFormer served through the MDXC separator: its seeded checkpoint in
the upstream key layout, its plain reference and the reference's window
plan.

The configuration file holds the model's YAML as the program reads it
(``yaml``) and the file name it is loaded under (``model_file``).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from benchlib import seeded
from reference import roformer, separate


def reference(cfg: dict, device, state: dict = None, checkpoint: bool = False):
    """The plain module on ``device``, with ``state`` (default: the seed's)."""
    with torch.device("meta"):
        module = roformer.from_config(cfg["yaml"], checkpoint=checkpoint)
    module.load_state_dict(state, assign=True)
    return module.to(device).eval()


def seeded_state(cfg: dict, seed: int, device) -> dict:
    with torch.device("meta"):
        module = roformer.from_config(cfg["yaml"])
    return seeded.seeded_state(module, seed, device, seeded.fan_in_rule)


def write_model(cfg: dict, seed: int, model_dir: str, device) -> str:
    """The checkpoint, its YAML under the same name and an empty remote
    listing (so the program resolves the model offline); returns the name to
    load."""
    os.makedirs(model_dir, exist_ok=True)
    state = seeded_state(cfg, seed, device)
    name = cfg["model_file"]
    torch.save({"state_dict": {k: v.cpu() for k, v in state.items()}},
               os.path.join(model_dir, name))
    with open(os.path.join(model_dir, os.path.splitext(name)[0] + ".yaml"), "w") as f:
        json.dump(cfg["yaml"], f)  # JSON is YAML
    with open(os.path.join(model_dir, "download_checks.json"), "w") as f:
        f.write("{}")
    return name


def separator_kwargs(params: dict) -> dict:
    return {"mdxc_params": dict(params)}


def _geometry(cfg: dict, params: dict):
    y = cfg["yaml"]
    chunk = int(y["model"]["stft_hop_length"]) * (int(y["inference"]["dim_t"]) - 1)
    step = min(int(params.get("overlap", 8) * int(y["audio"]["sample_rate"])), chunk) or chunk
    return chunk, step


def separate_song(model, mix: np.ndarray, cfg: dict, params: dict, device) -> dict:
    return separate.separate_mdxc(model, mix, cfg["yaml"], params, device,
                                  batch=int(params.get("batch_size", 4)))


def windows(samples: int, cfg: dict, params: dict) -> int:
    """Windows a song of ``samples`` needs (a last batch's padding not
    counted)."""
    chunk, step = _geometry(cfg, params)
    return len(separate.mdxc_windows(samples, chunk, step))


def window_input(cfg: dict, device) -> torch.Tensor:
    chunk, _ = _geometry(cfg, {})
    return torch.zeros((1, 2, chunk), device=device)


def _band_runs(cfg: dict) -> list:
    """The group of each band: runs of consecutive bands of one width."""
    widths = cfg["yaml"]["model"]["freqs_per_bands"]
    groups, g = [], -1
    for i, w in enumerate(widths):
        if i == 0 or w != widths[i - 1]:
            g += 1
        groups.append(g)
    return groups


_BLOCK = {"0.norm.gamma": "attn_norm", "0.to_qkv.weight": "wqkv", "0.to_gates.weight": "gate_w",
          "0.to_gates.bias": "gate_b", "0.to_out.0.weight": "wo", "1.net.0.gamma": "ff_norm",
          "1.net.1.weight": "ff_w1", "1.net.1.bias": "ff_b1", "1.net.4.weight": "ff_w2",
          "1.net.4.bias": "ff_b2"}


def program_groups(cfg: dict, ref_state: dict) -> dict:
    """``{program leaf: [(reference key, rows or None)]}``: which reference
    tensors make up each of the program's stacked parameters (the port keeps
    every layer of a kind in one tensor, the bands of one width in one, and
    a mask estimator's output product as value and gate halves)."""
    runs = _band_runs(cfg)
    groups = {}

    def add(leaf, key, rows=None):
        groups.setdefault(leaf, []).append((key, rows))

    for key, value in ref_state.items():
        p = key.split(".")
        if p[0] == "band_split":
            i, kind = int(p[2]), ".".join(p[3:])
            if kind == "1.bias":
                add("band_split.b", key)
            else:
                add(f"band_split.groups.{runs[i]}.{'gamma' if kind == '0.gamma' else 'w'}", key)
        elif p[0] == "layers":
            axis = "time" if p[2] == "0" else "freq"
            add(f"blocks.{axis}.{_BLOCK['.'.join(p[5:])]}", key)
        elif p[0] == "final_norm":
            add("final_norm.gamma", key)
        elif p[0] == "mask_estimators":
            i, layer, kind = int(p[3]), p[5], p[6]
            if layer == "0":
                add(f"mask_est.hidden.0.{'w' if kind == 'weight' else 'b'}", key)
            else:
                half = value.shape[0] // 2
                suffix = "w" if kind == "weight" else "b"
                add(f"mask_est.groups.{runs[i]}.val_{suffix}", key, (0, half))
                add(f"mask_est.groups.{runs[i]}.gate_{suffix}", key, (half, 2 * half))
        else:
            raise KeyError(f"no program leaf for reference key {key}")
    return groups
