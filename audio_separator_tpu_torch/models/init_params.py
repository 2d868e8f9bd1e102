"""Seeded random parameter trees — for smoke runs and benchmarks where no
trained checkpoint is on disk. RoFormer trees are in the layout of
``models/convert.convert_roformer`` (load one with ``convert.load_jax_params``);
HTDemucs and HDemucs trees are in the upstream state-dict layout split on
``.`` (load one with ``convert.load_jax_htdemucs_params`` or
``load_jax_hdemucs_params``)."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from .diffq_restore import demucs_param_manifest
from .htdemucs import HTDemucsConfig
from .roformer import RoformerConfig, band_layout


def init_roformer_params(cfg: RoformerConfig, seed: int = 0,
                         scale: float = 0.02) -> Dict[str, Any]:
    """Weights drawn from N(0, scale²) (large leaves tile a 1M-value pool),
    norm gains one, biases zero."""
    rng = np.random.default_rng(seed)
    pool = (rng.standard_normal(1 << 20) * scale).astype(np.float32)

    def w(*shape):
        n = int(np.prod(shape))
        reps = -(-n // pool.size)
        return np.tile(pool, reps)[:n].reshape(shape)

    def zeros(*shape):
        return np.zeros(shape, np.float32)

    def ones(*shape):
        return np.ones(shape, np.float32)

    layout = band_layout(cfg)
    nb, dim, h, dh = layout.n_bands, cfg.dim, cfg.heads, cfg.dim_head
    hidden = dim * cfg.mlp_expansion_factor

    def trans_stack(inner_depth: int):
        d = cfg.depth
        stack = {
            "attn_norm": ones(d, inner_depth, dim),
            "wqkv": w(d, inner_depth, dim, 3 * h * dh),
            "gate_w": w(d, inner_depth, dim, h),
            "gate_b": zeros(d, inner_depth, h),
            "wo": w(d, inner_depth, h * dh, dim),
            "ff_norm": ones(d, inner_depth, dim),
            "ff_w1": w(d, inner_depth, dim, hidden),
            "ff_b1": zeros(d, inner_depth, hidden),
            "ff_w2": w(d, inner_depth, hidden, dim),
            "ff_b2": zeros(d, inner_depth, dim),
        }
        if cfg.kind == "mel":
            stack["out_norm"] = ones(d, dim)
        return stack

    params: Dict[str, Any] = {
        "band_split": {
            "groups": [{"gamma": ones(e0 - s0, width), "w": w(e0 - s0, width, dim)}
                       for (s0, e0, width, _dense) in layout.runs],
            "b": zeros(nb, dim),
        },
        "blocks": {"time": trans_stack(cfg.time_transformer_depth),
                   "freq": trans_stack(cfg.freq_transformer_depth)},
    }
    if cfg.linear_transformer_depth > 0:
        lin = trans_stack(cfg.linear_transformer_depth)
        del lin["gate_w"], lin["gate_b"]
        lin["temperature"] = ones(cfg.depth, cfg.linear_transformer_depth, h)
        params["blocks"]["linear"] = lin
    if cfg.kind == "bs":
        params["final_norm"] = {"gamma": ones(dim)}

    # mel MLPs have one more hidden layer than bs for the same depth.
    n_hidden = (cfg.mask_estimator_depth if cfg.kind == "mel"
                else cfg.mask_estimator_depth - 1)
    hidden_layers = [{"w": w(cfg.num_stems, nb, dim if i == 0 else hidden, hidden),
                      "b": zeros(cfg.num_stems, nb, hidden)}
                     for i in range(n_hidden)]
    final_in = dim if n_hidden == 0 else hidden
    params["mask_est"] = {
        "hidden": hidden_layers,
        "groups": [
            {"val_w": w(cfg.num_stems, e0 - s0, final_in, width),
             "val_b": zeros(cfg.num_stems, e0 - s0, width),
             "gate_w": w(cfg.num_stems, e0 - s0, final_in, width),
             "gate_b": zeros(cfg.num_stems, e0 - s0, width)}
            for (s0, e0, width, _dense) in layout.runs
        ],
    }
    return params


# The 62-band layout of the flagship BS-RoFormer checkpoints (24×2, 12×4,
# 8×12, 8×24, 8×48, 128, 129 bins, summing to 1025).
FLAGSHIP_FREQS_PER_BANDS = tuple(
    [2] * 24 + [4] * 12 + [12] * 8 + [24] * 8 + [48] * 8 + [128, 129]
)


def flagship_config() -> RoformerConfig:
    """BS-RoFormer ep_317-class flagship configuration (viperx 1297 family):
    dim 512 / depth 12 / stereo / 2 stems / n_fft 2048 / hop 441."""
    return RoformerConfig(
        kind="bs", dim=512, depth=12, stereo=True, num_stems=2,
        time_transformer_depth=1, freq_transformer_depth=1,
        freqs_per_bands=FLAGSHIP_FREQS_PER_BANDS,
        dim_head=64, heads=8,
        stft_n_fft=2048, stft_hop_length=441, stft_win_length=2048,
        mask_estimator_depth=2,
    )


def htdemucs_full_config(sources=("drums", "bass", "other", "vocals")) -> HTDemucsConfig:
    """The published ``htdemucs`` (signature 955717e8) constructor arguments."""
    return HTDemucsConfig(
        sources=tuple(sources), channels=48, growth=2, nfft=4096, depth=4, kernel_size=8,
        stride=4, dconv_depth=2, dconv_comp=8, t_layers=5, t_heads=8, t_hidden_scale=4.0,
        bottom_channels=512, segment=7.8, use_train_segment=True)


def hdemucs_full_config(sources=("drums", "bass", "other", "vocals")) -> HTDemucsConfig:
    """The published ``hdemucs_mmi`` (signature 75fc33f5): the ``HDemucs``
    constructor's defaults, evaluated at each chunk's exact length."""
    return HTDemucsConfig(
        sources=tuple(sources), arch="hdemucs", channels=48, growth=2, nfft=4096, depth=6,
        kernel_size=8, stride=4, norm_starts=4, norm_groups=4, dconv_depth=2, dconv_comp=4,
        dconv_lstm=4, dconv_attn=4, freq_emb=0.2, cac=True, samplerate=44100, segment=40.0,
        use_train_segment=False)


_V3_ONLY = ("arch", "use_train_segment", "t_layers", "t_heads", "t_hidden_scale",
            "t_cross_first", "bottom_channels")


def htdemucs_kwargs(cfg: HTDemucsConfig) -> Dict[str, Any]:
    """A config as the constructor arguments a checkpoint package records
    (an ``HDemucs`` constructor takes no transformer arguments)."""
    kwargs = {**cfg.__dict__, "sources": list(cfg.sources)}
    if cfg.arch == "hdemucs":
        kwargs = {k: v for k, v in kwargs.items() if k not in _V3_ONLY}
    return kwargs


def demucs_class_name(cfg: HTDemucsConfig) -> str:
    return "HDemucs" if cfg.arch == "hdemucs" else "HTDemucs"


def init_htdemucs_params(cfg: HTDemucsConfig, seed: int = 0,
                         layer_scale: float = 0.5) -> Dict[str, Any]:
    """A tree with every key and shape of the upstream state dict of an
    ``HTDemucs``, or of an ``HDemucs`` for ``arch="hdemucs"``. Weights are
    drawn from N(0, 1/fan_in) (so activations keep their scale through the
    depth), norm gains are one, biases small, and the LayerScale gains
    ``layer_scale`` rather than the 1e-4 of a fresh model, so that the DConv
    branches and the transformer contribute to the output."""
    rng = np.random.default_rng(seed)
    tree: Dict[str, Any] = {}
    for key, shape in demucs_param_manifest(demucs_class_name(cfg), htdemucs_kwargs(cfg)):
        parts = key.split(".")
        leaf = parts[-1]
        if leaf == "scale":
            value = np.full(shape, layer_scale, np.float32)
        elif leaf.startswith("bias") or leaf == "in_proj_bias":  # LSTM: bias_ih_l0, ...
            value = (rng.standard_normal(shape) * 0.02).astype(np.float32)
        elif len(shape) == 1:  # norm gains
            value = np.ones(shape, np.float32)
        elif parts[0] == "freq_emb":
            value = (rng.standard_normal(shape) * 0.1).astype(np.float32)
        else:
            # Conv (out, in, *k), ConvTranspose (in, out, *k) and Linear
            # (out, in): the fan-in is everything but the output channels.
            out_axis = 1 if parts[-2] == "conv_tr" else 0
            fan_in = int(np.prod(shape)) // shape[out_axis]
            value = (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree
