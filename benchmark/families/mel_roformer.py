"""Mel-Band RoFormer served through the MDXC separator: its seeded checkpoint
in the upstream key layout, its plain reference (``reference/mel_roformer.
py``) and the reference's window plan, which is BS-RoFormer's
(``families/bs_roformer.py``, whose separator options, window plan and
separation this family takes as they are).

The configuration file holds the model's YAML as the program reads it
(``yaml``) and the file name it is loaded under (``model_file``).
"""

from __future__ import annotations

import json
import os

import torch

from benchlib import manifest, seeded
from reference import mel_roformer

_bs = manifest.plugin("families", "bs_roformer")
separator_kwargs = _bs.separator_kwargs
separate_song = _bs.separate_song
windows = _bs.windows
window_input = _bs.window_input


def reference(cfg: dict, device, state: dict = None, checkpoint: bool = False):
    """The plain module on ``device`` with ``state``."""
    with torch.device("meta"):
        module = mel_roformer.from_config(cfg["yaml"], checkpoint=checkpoint)
    module.load_state_dict(state, assign=True)
    return module.to(device).eval()


def seeded_state(cfg: dict, seed: int, device) -> dict:
    with torch.device("meta"):
        module = mel_roformer.from_config(cfg["yaml"])
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


def program_groups(cfg: dict, ref_state: dict) -> dict:
    """``{program leaf: [(reference key, rows or None)]}``, as
    ``families/bs_roformer.program_groups``: the port stacks every layer of a
    kind, the bands of one run of equal widths (here told from the band-split
    gains' lengths, since Mel bands are not listed by width) and each
    transformer's output norm, and keeps every hidden layer of the mask
    estimator as one tensor over all bands."""
    widths = {int(k.split(".")[2]): v.shape[0] for k, v in ref_state.items()
              if k.startswith("band_split.") and k.endswith(".0.gamma")}
    runs = [0]
    for i in range(1, len(widths)):
        runs.append(runs[-1] + (widths[i] != widths[i - 1]))
    hidden = int(cfg["yaml"]["model"]["mask_estimator_depth"])
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
            if p[3] == "norm":
                add(f"blocks.{axis}.out_norm", key)
            else:
                add(f"blocks.{axis}.{_bs._BLOCK['.'.join(p[5:])]}", key)
        elif p[0] == "mask_estimators":
            i, layer, kind = int(p[3]), int(p[5]) // 2, p[6]
            suffix = "w" if kind == "weight" else "b"
            if layer < hidden:
                add(f"mask_est.hidden.{layer}.{suffix}", key)
            else:
                half = value.shape[0] // 2
                add(f"mask_est.groups.{runs[i]}.val_{suffix}", key, (0, half))
                add(f"mask_est.groups.{runs[i]}.gate_{suffix}", key, (half, 2 * half))
        else:
            raise KeyError(f"no program leaf for reference key {key}")
    return groups
