"""Checkpoint conversion: upstream torch state dicts → the parameter tree of
``models/roformer.Roformer``, and that tree → the module; the JAX package's
HTDemucs, HDemucs, TFC-TDF and VR trees → their modules.

The tree is the JAX package's parameter pytree (numpy leaves: per-depth
transformer layers stacked along a leading axis, ``nn.Linear`` weights as
``(in, out)``, per-run band-split and mask-estimator weights). One function,
``load_jax_params``, loads such a tree into the module, for checkpoints and
for trees produced elsewhere alike.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from .roformer import BandLayout, RoformerConfig, band_layout


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Load a .ckpt/.pth/.th checkpoint to numpy, unwrapping the usual
    ``state_dict`` / ``model`` / ``model_state_dict`` containers and a uniform
    ``model.`` key prefix."""
    # Downloaded checkpoints are untrusted pickles: the tensor-only loader
    # first; full unpickling only for files that store other Python objects.
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict):
        for key in ("state_dict", "model", "model_state_dict"):
            if key in obj and isinstance(obj[key], dict):
                obj = obj[key]
                break
    if not isinstance(obj, dict):
        raise ValueError(f"unsupported checkpoint container in {path}")
    out = {k: v.detach().cpu().float().numpy() if v.is_floating_point()
           else v.detach().cpu().numpy()
           for k, v in obj.items() if hasattr(v, "detach")}
    if out and all(k.startswith("model.") for k in out):
        out = {k[len("model."):]: v for k, v in out.items()}
    return out


def _stack(dicts, key):
    return np.stack([d[key] for d in dicts])


def _convert_attention(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    return {
        "attn_norm": sd[f"{prefix}.0.norm.gamma"],
        "wqkv": sd[f"{prefix}.0.to_qkv.weight"].T,
        "gate_w": sd[f"{prefix}.0.to_gates.weight"].T,
        "gate_b": sd[f"{prefix}.0.to_gates.bias"],
        "wo": sd[f"{prefix}.0.to_out.0.weight"].T,
        "ff_norm": sd[f"{prefix}.1.net.0.gamma"],
        "ff_w1": sd[f"{prefix}.1.net.1.weight"].T,
        "ff_b1": sd[f"{prefix}.1.net.1.bias"],
        "ff_w2": sd[f"{prefix}.1.net.4.weight"].T,
        "ff_b2": sd[f"{prefix}.1.net.4.bias"],
    }


def _convert_linear_attention(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    """LinearAttention layer: no gates or RoPE, per-head temperature,
    bias-free projections."""
    return {
        "attn_norm": sd[f"{prefix}.0.norm.gamma"],
        "wqkv": sd[f"{prefix}.0.to_qkv.0.weight"].T,
        "temperature": sd[f"{prefix}.0.temperature"].reshape(-1),
        "wo": sd[f"{prefix}.0.to_out.1.weight"].T,
        "ff_norm": sd[f"{prefix}.1.net.0.gamma"],
        "ff_w1": sd[f"{prefix}.1.net.1.weight"].T,
        "ff_b1": sd[f"{prefix}.1.net.1.bias"],
        "ff_w2": sd[f"{prefix}.1.net.4.weight"].T,
        "ff_b2": sd[f"{prefix}.1.net.4.bias"],
    }


def _convert_transformer(sd, prefix: str, inner_depth: int, has_out_norm: bool,
                         linear: bool = False):
    convert = _convert_linear_attention if linear else _convert_attention
    layers = [convert(sd, f"{prefix}.layers.{l}") for l in range(inner_depth)]
    out = {k: _stack(layers, k) for k in layers[0]}
    if has_out_norm:
        out["out_norm"] = sd[f"{prefix}.norm.gamma"]
    return out


def convert_roformer(sd: Dict[str, np.ndarray], cfg: RoformerConfig) -> Dict[str, Any]:
    """Build the parameter tree from an upstream BS/Mel-RoFormer state dict."""
    layout: BandLayout = band_layout(cfg)
    nb, dim = layout.n_bands, cfg.dim

    bs_groups = []
    for (s0, e0, _width, _dense) in layout.runs:
        gamma = np.stack([sd[f"band_split.to_features.{i}.0.gamma"] for i in range(s0, e0)])
        w = np.stack([sd[f"band_split.to_features.{i}.1.weight"].T for i in range(s0, e0)])
        bs_groups.append({"gamma": gamma.astype(np.float32), "w": w.astype(np.float32)})
    b = np.stack([sd[f"band_split.to_features.{i}.1.bias"] for i in range(nb)])
    params: Dict[str, Any] = {"band_split": {"groups": bs_groups, "b": b.astype(np.float32)}}

    has_inner_norm = cfg.kind == "mel"  # norm_output=True for the mel variant
    has_linear = cfg.linear_transformer_depth > 0
    time_idx, freq_idx = (1, 2) if has_linear else (0, 1)
    per_depth = []
    for d in range(cfg.depth):
        entry = {
            "time": _convert_transformer(sd, f"layers.{d}.{time_idx}",
                                         cfg.time_transformer_depth, has_inner_norm),
            "freq": _convert_transformer(sd, f"layers.{d}.{freq_idx}",
                                         cfg.freq_transformer_depth, has_inner_norm),
        }
        if has_linear:
            entry["linear"] = _convert_transformer(
                sd, f"layers.{d}.0", cfg.linear_transformer_depth, has_inner_norm,
                linear=True)
        per_depth.append(entry)
    params["blocks"] = {
        branch: {k: np.stack([pd[branch][k] for pd in per_depth])
                 for k in per_depth[0][branch]}
        for branch in per_depth[0]
    }

    if "final_norm.gamma" in sd:
        params["final_norm"] = {"gamma": sd["final_norm.gamma"]}

    # The upstream MLP constructors disagree on `depth`: the BS one makes `depth`
    # linears, the mel one `depth + 1`.
    depth = cfg.mask_estimator_depth
    n_hidden = depth if cfg.kind == "mel" else depth - 1
    hidden_dim = cfg.dim * cfg.mlp_expansion_factor
    hidden_layers = []
    for h in range(n_hidden):
        in_dim = dim if h == 0 else hidden_dim
        wh = np.zeros((cfg.num_stems, nb, in_dim, hidden_dim), np.float32)
        bh = np.zeros((cfg.num_stems, nb, hidden_dim), np.float32)
        for s in range(cfg.num_stems):
            for i in range(nb):
                key = f"mask_estimators.{s}.to_freqs.{i}.0.{2 * h}"
                wh[s, i] = sd[f"{key}.weight"].T
                bh[s, i] = sd[f"{key}.bias"]
        hidden_layers.append({"w": wh, "b": bh})

    final_idx = 2 * n_hidden
    me_groups = []
    for (s0, e0, width, _dense) in layout.runs:
        vw, vb, gw, gb = [], [], [], []
        for s in range(cfg.num_stems):
            vw.append([]); vb.append([]); gw.append([]); gb.append([])
            for i in range(s0, e0):
                key = f"mask_estimators.{s}.to_freqs.{i}.0.{final_idx}"
                wt = sd[f"{key}.weight"]  # (2*width, in): GLU value ; gate
                bt = sd[f"{key}.bias"]
                vw[s].append(wt[:width].T); gw[s].append(wt[width:].T)
                vb[s].append(bt[:width]); gb[s].append(bt[width:])
        me_groups.append({
            "val_w": np.asarray(vw, np.float32),
            "val_b": np.asarray(vb, np.float32),
            "gate_w": np.asarray(gw, np.float32),
            "gate_b": np.asarray(gb, np.float32),
        })
    params["mask_est"] = {"hidden": hidden_layers, "groups": me_groups}
    return params


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts/lists → ``{"a.b.0.c": leaf}``, the module's state-dict keys."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix[:-1]: np.asarray(tree)}
    flat: Dict[str, np.ndarray] = {}
    for k, v in items:
        flat.update(flatten_tree(v, f"{prefix}{k}."))
    return flat


def load_jax_params(module: nn.Module, tree: Any) -> nn.Module:
    """Copy a parameter tree in the JAX pytree layout (numpy or array-like
    leaves) into ``module``, casting to each parameter's dtype and device.
    The tree's keys and shapes must match the module's exactly."""
    flat = flatten_tree(tree)
    state = module.state_dict()
    missing = sorted(set(state) - set(flat))
    extra = sorted(set(flat) - set(state))
    if missing or extra:
        raise ValueError(f"parameter tree does not match the module: "
                         f"missing {missing[:8]}, unexpected {extra[:8]}")
    with torch.no_grad():
        for key, target in state.items():
            value = flat[key]
            if tuple(value.shape) != tuple(target.shape):
                raise ValueError(f"{key}: tree shape {tuple(value.shape)} != "
                                 f"module shape {tuple(target.shape)}")
            target.copy_(torch.from_numpy(np.ascontiguousarray(value, np.float32)))
    return module


def export_jax_params(module: nn.Module) -> Dict[str, Any]:
    """The module's parameters and buffers as the JAX package's parameter
    tree (numpy float32 leaves): the inverse of ``load_jax_params`` for a
    ``Roformer`` (whose numbered levels are lists) and of
    ``load_jax_htdemucs_params`` / ``load_jax_hdemucs_params`` and the other
    path trees (numbered levels stay string keys), e.g. to hand trained
    weights back to the JAX package or to ``save_params``."""
    from .roformer import Roformer

    tree = tree_from_state_dict({k: v.detach().float().cpu().numpy()
                                 for k, v in module.state_dict().items()})
    if not isinstance(module, Roformer):
        return tree

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    tree = lists(tree)
    tree["mask_est"].setdefault("hidden", [])  # no hidden layer: no state-dict key
    return tree


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        flat[f"{prefix}__len__"] = np.asarray(len(tree))
        for i, v in enumerate(tree):
            flat.update(_flatten(v, f"{prefix}{i}/"))
    else:
        flat[prefix[:-1]] = np.asarray(tree)
    return flat


def save_params(path: str, params: Any) -> None:
    """Write a parameter tree as the ``.npz`` the JAX package's
    ``models/convert.save_params`` writes (``/``-joined keys, ``__len__``
    entries for lists), which its ``load_params`` reads."""
    np.savez(path, **_flatten(params))


def _load_path_tree(module: nn.Module, tree: Any) -> nn.Module:
    """Strict ``load_state_dict`` of a tree keyed by the state-dict path split
    on ``.``: every key of the tree is consumed and every parameter and
    buffer of the module is set."""
    state = {key: torch.from_numpy(np.ascontiguousarray(value, np.float32))
             for key, value in flatten_tree(tree).items()}
    module.load_state_dict(state, strict=True)
    return module


def load_jax_htdemucs_params(module: nn.Module, tree: Any) -> nn.Module:
    """Copy the JAX package's HTDemucs parameter tree (nested dicts of numpy
    arrays keyed by the upstream state-dict path split on ``.``) into an
    ``HTDemucs`` module, strictly."""
    return _load_path_tree(module, tree)


def load_jax_hdemucs_params(module: nn.Module, tree: Any) -> nn.Module:
    """Copy the JAX package's HDemucs (Demucs v3) parameter tree, in the same
    layout as HTDemucs's, into an ``HDemucs`` module, strictly."""
    return _load_path_tree(module, tree)


def tree_from_state_dict(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """``'a.b.c'`` keys → nested tree (drops ``num_batches_tracked`` buffers)."""
    tree: Dict[str, Any] = {}
    for key, value in sd.items():
        if key.endswith("num_batches_tracked"):
            continue
        node = tree
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = np.asarray(value)
    return tree


def convert_tfc_tdf(sd: Dict[str, np.ndarray], cfg=None) -> Dict[str, Any]:
    """TFC-TDF v3 checkpoints map directly to a path-addressed tree."""
    return tree_from_state_dict(sd)


def load_jax_tfc_tdf_params(module: nn.Module, tree: Any) -> nn.Module:
    """Copy the JAX package's TFC-TDF parameter tree (``convert_tfc_tdf``'s
    layout) into a ``TFCTDFNet``, strictly."""
    return _load_path_tree(module, tree)


def load_jax_vr_params(module: nn.Module, tree: Any) -> nn.Module:
    """Copy the JAX package's VR parameter tree (``models/vr_nets.
    state_dict_to_tree``: the upstream state-dict path split on ``.``, less
    ``num_batches_tracked``) into a ``CascadedASPPNet`` or ``CascadedNet``,
    strictly."""
    return _load_path_tree(module, tree)


def convert_onnx_params(params: Dict[str, np.ndarray], device="cpu") -> Dict[str, torch.Tensor]:
    """An ONNX graph's initializers (``onnx_to_jax``'s params, or
    ``OnnxToTorch.params``: name → numpy array) → the same names as tensors
    on ``device``, for ``onnx_torch``'s ``fn(params, *inputs)``. Dtypes are
    kept; the executor casts each weight to its activation's dtype."""
    return {name: torch.as_tensor(np.array(value), device=device)
            for name, value in params.items()}
