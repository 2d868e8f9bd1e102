"""HTDemucs (Demucs v4) served through the Demucs separator: its seeded
package under the published signature, its plain reference and the
reference's window plan.

The configuration file holds the package's constructor arguments
(``kwargs``), its signature and the bag that names it.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import sys
import types

import numpy as np
import torch

from benchlib import seeded
from reference import htdemucs, separate


def _module(cfg: dict):
    return htdemucs.HTDemucs(**cfg["kwargs"])


def reference(cfg: dict, device, state: dict = None, checkpoint: bool = False):
    with torch.device("meta"):
        module = _module(cfg)
    module.load_state_dict(state, assign=True)
    return module.to(device).eval()


def _rule(key: str, shape: tuple) -> tuple:
    """N(0, 1/fan_in) weights, 0.02 · N biases, unit gains, LayerScale gains
    of 0.5 (not a fresh model's 1e-3 and 1e-4, so that the DConv branches and
    the transformer add to the output), the frequency embedding at 0.1 · N."""
    leaf = key.rsplit(".", 1)[-1]
    if leaf == "scale":
        return "fill", 0.5
    if key.startswith("freq_emb"):
        return "scale", 0.1
    return seeded.fan_in_rule(key, shape, transposed=".conv_tr." in f".{key}")


def seeded_state(cfg: dict, seed: int, device) -> dict:
    with torch.device("meta"):
        module = _module(cfg)
    return seeded.seeded_state(module, seed, device, _rule)


def write_model(cfg: dict, seed: int, model_dir: str, device) -> str:
    """``<signature>-<sha256 prefix>.th`` (the package pickles the class
    ``demucs.htdemucs.HTDemucs``, the constructor arguments and the state),
    the YAML bag naming the signature, and an empty remote listing; returns
    the bag's name."""
    os.makedirs(model_dir, exist_ok=True)
    state = {k: v.cpu() for k, v in seeded_state(cfg, seed, device).items()}
    sig = cfg["signature"]
    tmp = os.path.join(model_dir, f"{sig}.tmp")
    names = ("demucs", "demucs.htdemucs")
    saved = {n: sys.modules.get(n) for n in names}
    mod = types.ModuleType("demucs.htdemucs")
    klass = type("HTDemucs", (), {"__module__": "demucs.htdemucs"})
    mod.HTDemucs = klass
    sys.modules["demucs"] = types.ModuleType("demucs")
    sys.modules["demucs.htdemucs"] = mod
    try:
        torch.save({"klass": klass, "args": (), "kwargs": dict(cfg["kwargs"]),
                    "state": state}, tmp)
    finally:
        for n, m in saved.items():
            if m is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = m
    sha = hashlib.sha256()
    with open(tmp, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            sha.update(block)
    os.replace(tmp, os.path.join(model_dir, f"{sig}-{sha.hexdigest()[:8]}.th"))
    with open(os.path.join(model_dir, cfg["model_file"]), "w") as f:
        json.dump(cfg["bag"], f)
    with open(os.path.join(model_dir, "download_checks.json"), "w") as f:
        f.write("{}")
    return cfg["model_file"]


def separator_kwargs(params: dict) -> dict:
    return {"demucs_params": dict(params)}


def separate_song(model, mix: np.ndarray, cfg: dict, params: dict, device) -> dict:
    return separate.separate_demucs(model, mix, cfg["kwargs"]["sources"], params, device,
                                    batch=int(params.get("batch_size", 4)))


def windows(samples: int, cfg: dict, params: dict) -> int:
    k = cfg["kwargs"]
    rate = int(k.get("samplerate", 44100))
    segment = int(float(k["segment"]) * rate)
    stride = int((1 - float(params.get("overlap", 0.25))) * segment)
    track = samples + int(0.5 * rate)
    return int(params.get("shifts", 2)) * math.ceil(track / stride)


def window_input(cfg: dict, device) -> torch.Tensor:
    k = cfg["kwargs"]
    return torch.zeros((1, 2, int(float(k["segment"]) * int(k.get("samplerate", 44100)))),
                       device=device)
