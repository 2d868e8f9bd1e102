"""Demucs checkpoint loading: signed ``.th`` packages and YAML bags.

Port of ``audio_separator_tpu/models/demucs_load.py``. The pickled ``klass``
global inside a ``.th`` file references ``demucs.*`` modules, so stub modules
are registered for unpickling and only the class *name* is used to pick the
implementation. A package yields a config and a state dict of float32 tensors
under the upstream keys, which ``models/htdemucs.HTDemucs`` (Demucs v4) or
``HDemucs`` (Demucs v3, ``arch="hdemucs"`` in the config) loads strictly.
"""

from __future__ import annotations

import hashlib
import os
import re
import sys
import threading
import types
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..io.yaml_config import read_yaml_config
from .htdemucs import HTDemucsConfig, config_from_kwargs

_STUB_MODULES = [
    "demucs", "demucs.htdemucs", "demucs.hdemucs", "demucs.demucs",
    "demucs.tasnet", "demucs.tasnet_v2", "demucs.model", "demucs.model_v2",
    "demucs.transformer", "demucs.states", "demucs.spec", "demucs.repo",
]
_STUB_CLASSES = ["HTDemucs", "HDemucs", "Demucs", "ConvTasNet"]
# sys.modules is the process's: one load at a time installs, uses and removes
# the stubs, or a second thread's unpickling finds them gone (a server loads
# packages on several worker threads).
_STUB_LOCK = threading.Lock()


def _ensure_stub_modules() -> List[str]:
    """Install unpickling stubs; returns the names added so the caller can
    remove them afterwards (leaving them would shadow a real ``demucs``
    package for the rest of the process)."""
    added = []
    for name in _STUB_MODULES:
        if name in sys.modules:
            continue
        mod = types.ModuleType(name)
        for cls_name in _STUB_CLASSES:
            setattr(mod, cls_name, type(cls_name, (), {"__module__": name}))
        sys.modules[name] = mod
        added.append(name)
    return added


def check_checksum(path: str) -> None:
    """Demucs repo files embed a sha256 prefix in the name,
    ``<signature>-<checksum>.th``. Only names of that scheme (hex suffix) are
    verified: a user's dash-named checkpoint (``my-finetune.th``) is not
    rejected as corrupt."""
    stem = os.path.splitext(os.path.basename(path))[0]
    if not re.fullmatch(r"[^-]+-[0-9a-fA-F]{4,64}", stem):
        return
    checksum = stem.split("-", 1)[1]
    sha = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            sha.update(block)
    actual = sha.hexdigest()[: len(checksum)]
    if actual != checksum:
        raise RuntimeError(
            f"Invalid checksum for file {path}, expected {checksum} but got {actual}")


def load_demucs_checkpoint(path: str) -> Tuple[str, HTDemucsConfig, Dict[str, torch.Tensor]]:
    """Load one ``.th`` package → (class name, config, state dict)."""
    with _STUB_LOCK:
        added_stubs = _ensure_stub_modules()
        try:
            # A package pickles the model *class* itself, which the plain
            # weights_only loader rejects. Allowlist exactly the stub classes;
            # fall back to full unpickling only if a package carries some
            # other global.
            safe = [cls for name in _STUB_MODULES if name in sys.modules
                    for cls in (getattr(sys.modules[name], c, None) for c in _STUB_CLASSES)
                    if isinstance(cls, type)]
            try:
                with torch.serialization.safe_globals(safe):
                    package = torch.load(path, map_location="cpu", weights_only=True)
            except Exception:
                package = torch.load(path, map_location="cpu", weights_only=False)
        finally:
            for name in added_stubs:
                sys.modules.pop(name, None)
    klass = package["klass"]
    klass_name = getattr(klass, "__name__", str(klass))
    kwargs = dict(package.get("kwargs") or {})
    args = tuple(package.get("args") or ())
    state = package["state"]

    if klass_name not in ("HTDemucs", "HDemucs"):
        raise NotImplementedError(
            f"Demucs model class {klass_name} not supported (HTDemucs v4 and HDemucs v3 "
            f"only; legacy v1/v2/TasNet are unreachable through the model list); "
            f"file: {path}")

    if isinstance(state, dict) and state.get("__quantized"):
        # diffq-quantised package: dequantise positionally against the
        # constructor-derived parameter manifest, no diffq needed.
        from .diffq_restore import restore_quantized_state

        state = restore_quantized_state(state, klass_name, kwargs, args)

    cfg = config_from_kwargs(kwargs, args, klass_name)
    tensors: Dict[str, torch.Tensor] = {}
    for key, value in state.items():
        if key.endswith("num_batches_tracked"):
            continue
        if isinstance(value, np.ndarray):  # dequantised diffq restore
            value = torch.from_numpy(np.ascontiguousarray(value))
        tensors[key] = value.detach().to(torch.float32)
    return klass_name, cfg, tensors


def bag_members(
    name_or_path: str, repo_dir: str
) -> Tuple[List[str], List[List[float]], Optional[float]]:
    """Resolve a model name (YAML bag or ``.th`` signature) inside ``repo_dir``
    to its member files, without reading them.

    Returns (member ``.th`` paths, per-source weights per member or None,
    segment override)."""
    stem = os.path.splitext(os.path.basename(name_or_path))[0]

    def find_th(sig: str) -> Optional[str]:
        # Files are "<sig>-<checksum>.th" or "<sig>.th".
        for fn in sorted(os.listdir(repo_dir)):
            if fn.endswith(".th") and (fn.split("-", 1)[0] == sig
                                       or os.path.splitext(fn)[0] == sig):
                return os.path.join(repo_dir, fn)
        return None

    yaml_path = os.path.join(repo_dir, f"{stem}.yaml")
    if os.path.exists(yaml_path):
        bag = read_yaml_config(yaml_path)
        paths = []
        for sig in bag["models"]:
            th_path = find_th(sig)
            if th_path is None:
                raise FileNotFoundError(f"model {sig}.th not found in {repo_dir}")
            paths.append(th_path)
        return paths, bag.get("weights"), bag.get("segment")

    th_path = find_th(stem) or (name_or_path if os.path.exists(name_or_path) else None)
    if th_path is None:
        raise FileNotFoundError(f"no demucs model named {name_or_path} in {repo_dir}")
    return [th_path], None, None


def load_demucs_member(th_path: str) -> Tuple[HTDemucsConfig, Dict[str, torch.Tensor]]:
    """One member file, its checksum checked: (config, state dict)."""
    check_checksum(th_path)
    _, cfg, state = load_demucs_checkpoint(th_path)
    return cfg, state


def load_demucs_model_or_bag(
    name_or_path: str, repo_dir: str
) -> Tuple[List[Tuple[HTDemucsConfig, Dict[str, torch.Tensor]]], List[List[float]],
           Optional[float]]:
    """Resolve a model name (YAML bag or ``.th`` signature) inside ``repo_dir``
    and load its members.

    Returns (models, per-source weights per model, segment override)."""
    paths, weights, segment = bag_members(name_or_path, repo_dir)
    models = [load_demucs_member(p) for p in paths]
    if weights is None:
        weights = [[1.0] * len(models[0][0].sources) for _ in models]
    return models, weights, segment
