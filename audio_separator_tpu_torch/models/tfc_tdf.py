"""TFC-TDF v3 (MDX23C) as a PyTorch module.

Port of ``audio_separator_tpu/models/tfc_tdf.py``: the complex-as-channels
spectrogram U-Net with time-frequency convolutions (TFC), time-distributed
fullband linear layers (TDF), sub-band folding (cac↔cws) and the first-conv
multiplicative artifact reduction. The module's ``state_dict`` keys are the
upstream checkpoint's (``first_conv``, ``encoder_blocks.i.tfc_tdf.blocks.j.
{tfc1,tdf,tfc2,shortcut}``, ``encoder_blocks.i.downscale.conv``,
``bottleneck_block``, ``decoder_blocks.i.upscale.conv``, ``final_conv``),
less BatchNorm's ``num_batches_tracked``, so the JAX package's parameter tree
loads with ``models/convert.load_jax_tfc_tdf_params``.

The rounding points are the JAX package's: norm statistics in float32 with
eps 1e-5, then cast to the compute dtype (the module's parameter dtype);
exact GELU; convolutions and the TDF products in the compute dtype with
float32 accumulation; the STFT and its inverse in float32. The forward runs
under ``ops/precision.full_float32``, so float32 convolutions stay float32 on
the card. Every operation is plain PyTorch (cuDNN convolutions on the card):
the JAX package computes all of it outside any Pallas kernel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.precision import full_float32
from ..ops.stft import hann_window, istft_real_packed, stft_real_packed


@dataclass(frozen=True)
class TFCTDFConfig:
    num_subbands: int
    num_scales: int
    scale: Tuple[int, int]
    num_blocks_per_scale: int
    num_channels: int
    growth: int
    bottleneck_factor: int
    norm: str
    act: str
    dim_f: int
    n_fft: int
    hop_length: int
    audio_channels: int = 2
    num_stems: int = 1


def build_tfc_tdf_config(model_data: Dict[str, Any]) -> TFCTDFConfig:
    model = model_data.get("model") or {}
    audio = model_data.get("audio") or {}
    training = model_data.get("training") or {}
    num_stems = 1 if training.get("target_instrument") else len(
        training.get("instruments") or [None])
    return TFCTDFConfig(
        num_subbands=int(model.get("num_subbands", 4)),
        num_scales=int(model.get("num_scales", 5)),
        scale=tuple(model.get("scale", (2, 2))),
        num_blocks_per_scale=int(model.get("num_blocks_per_scale", 2)),
        num_channels=int(model.get("num_channels", 128)),
        growth=int(model.get("growth", 128)),
        bottleneck_factor=int(model.get("bottleneck_factor", 4)),
        norm=str(model.get("norm", "InstanceNorm")),
        act=str(model.get("act", "gelu")),
        dim_f=int(audio.get("dim_f", 4096)),
        n_fft=int(audio.get("n_fft", 8192)),
        hop_length=int(audio.get("hop_length", 1024)),
        audio_channels=int(audio.get("num_channels", 2)),
        num_stems=num_stems,
    )


# --------------------------------------------------------------------------
# primitives


class Norm(nn.Module):
    """BatchNorm (running statistics), InstanceNorm (affine) or GroupNorm<g>;
    anything else is the identity."""

    def __init__(self, norm_type: str, channels: int):
        super().__init__()
        self.norm_type = norm_type or ""
        self.groups = 0
        if self.norm_type.startswith("GroupNorm"):
            self.groups = int(self.norm_type.replace("GroupNorm", ""))
        if self.norm_type in ("BatchNorm", "InstanceNorm") or self.groups:
            self.weight = nn.Parameter(torch.ones(channels))
            self.bias = nn.Parameter(torch.zeros(channels))
        if self.norm_type == "BatchNorm":
            self.register_buffer("running_mean", torch.zeros(channels))
            self.register_buffer("running_var", torch.ones(channels))

    def _affine(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.weight[None, :, None, None] + self.bias[None, :, None, None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.norm_type == "BatchNorm":
            shape = (1, -1, 1, 1)
            inv = torch.rsqrt(self.running_var + 1e-5)
            return ((x - self.running_mean.reshape(shape)) * (inv * self.weight).reshape(shape)
                    + self.bias.reshape(shape))
        if self.norm_type == "InstanceNorm":
            x32 = x.float()
            var, mean = torch.var_mean(x32, dim=(2, 3), unbiased=False, keepdim=True)
            return self._affine(((x32 - mean) * torch.rsqrt(var + 1e-5)).to(x.dtype))
        if self.groups:
            b = x.shape[0]
            xg = x.reshape(b, self.groups, -1).float()
            var, mean = torch.var_mean(xg, dim=-1, unbiased=False, keepdim=True)
            out = ((xg - mean) * torch.rsqrt(var + 1e-5)).reshape(x.shape).to(x.dtype)
            return self._affine(out)
        return x


class Act(nn.Module):
    def __init__(self, act_type: str):
        super().__init__()
        if act_type not in ("gelu", "relu") and not act_type.startswith("elu"):
            raise ValueError(f"unknown activation {act_type}")
        self.act_type = act_type

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.act_type == "gelu":
            return F.gelu(x)
        if self.act_type == "relu":
            return torch.clamp_min(x, 0)
        alpha = float(self.act_type.replace("elu", "") or 1.0)
        return torch.where(x >= 0, x, alpha * (torch.exp(x) - 1.0))


def _conv(in_c: int, out_c: int, kernel: int, stride: int = 1, padding: int = 0) -> nn.Conv2d:
    return nn.Conv2d(in_c, out_c, kernel, stride, padding, bias=False)


class _TFCTDFBlock(nn.Module):
    def __init__(self, in_c: int, c: int, f: int, bn: int, norm: str, act: str):
        super().__init__()
        self.tfc1 = nn.Sequential(Norm(norm, in_c), Act(act), _conv(in_c, c, 3, 1, 1))
        self.tdf = nn.Sequential(Norm(norm, c), Act(act), nn.Linear(f, f // bn, bias=False),
                                 Norm(norm, c), Act(act), nn.Linear(f // bn, f, bias=False))
        self.tfc2 = nn.Sequential(Norm(norm, c), Act(act), _conv(c, c, 3, 1, 1))
        self.shortcut = _conv(in_c, c, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.shortcut(x)
        h = self.tfc1(x)
        h = h + self.tdf(h)
        return self.tfc2(h) + s


class TFCTDF(nn.Module):
    """A stack of ``num_blocks_per_scale`` TFC-TDF blocks; x is (B, C, T, F)."""

    def __init__(self, in_c: int, c: int, blocks: int, f: int, bn: int, norm: str, act: str):
        super().__init__()
        self.blocks = nn.ModuleList()
        for _ in range(blocks):
            self.blocks.append(_TFCTDFBlock(in_c, c, f, bn, norm, act))
            in_c = c

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return x


class _Scale(nn.Module):
    """Norm, activation, then the strided convolution (down) or the transposed
    convolution (up), whose kernel equals its stride: no overlap, no bias."""

    def __init__(self, in_c: int, out_c: int, scale, norm: str, act: str, up: bool):
        super().__init__()
        conv = nn.ConvTranspose2d if up else nn.Conv2d
        self.conv = nn.Sequential(Norm(norm, in_c), Act(act),
                                  conv(in_c, out_c, tuple(scale), tuple(scale), bias=False))

    def forward(self, x):
        return self.conv(x)


class TFCTDFNet(nn.Module):
    """``forward``: chunks (B, C, L) → stems (B, num_stems, C, L);
    ``forward_spec``: packed spectrogram (B, C*2, dim_f, T) → per-stem packed
    spectrogram (B, S, C*2, dim_f, T)."""

    def __init__(self, cfg: TFCTDFConfig):
        super().__init__()
        self.cfg = cfg
        k, norm, act = cfg.num_subbands, cfg.norm, cfg.act
        dim_c = k * cfg.audio_channels * 2
        c, g, bn, blocks = cfg.num_channels, cfg.growth, cfg.bottleneck_factor, \
            cfg.num_blocks_per_scale
        f = cfg.dim_f // k
        self.first_conv = _conv(dim_c, c, 1)
        self.encoder_blocks = nn.ModuleList()
        for _ in range(cfg.num_scales):
            stage = nn.Module()  # named as the upstream checkpoint names it
            stage.tfc_tdf = TFCTDF(c, c, blocks, f, bn, norm, act)
            stage.downscale = _Scale(c, c + g, cfg.scale, norm, act, up=False)
            f //= cfg.scale[1]
            c += g
            self.encoder_blocks.append(stage)
        self.bottleneck_block = TFCTDF(c, c, blocks, f, bn, norm, act)
        self.decoder_blocks = nn.ModuleList()
        for _ in range(cfg.num_scales):
            stage = nn.Module()
            stage.upscale = _Scale(c, c - g, cfg.scale, norm, act, up=True)
            f *= cfg.scale[1]
            c -= g
            stage.tfc_tdf = TFCTDF(2 * c, c, blocks, f, bn, norm, act)
            self.decoder_blocks.append(stage)
        self.final_conv = nn.Sequential(_conv(c + dim_c, c, 1), Act(act),
                                        _conv(c, cfg.num_stems * dim_c, 1))

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.first_conv.weight.dtype

    @torch.no_grad()
    def forward(self, chunks: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        t_samples = chunks.shape[-1]
        win = hann_window(cfg.n_fft, device=chunks.device)
        with full_float32():
            spec = stft_real_packed(chunks, cfg.n_fft, cfg.hop_length, win, cfg.dim_f)
            x = self._body(spec.to(self.compute_dtype))
            out = istft_real_packed(x.float(), cfg.n_fft, cfg.hop_length, win)
        out = out[..., :t_samples]
        if out.shape[-1] < t_samples:
            out = F.pad(out, (0, t_samples - out.shape[-1]))
        return out  # (B, S, C, L)

    @torch.no_grad()
    def forward_spec(self, spec: torch.Tensor) -> torch.Tensor:
        with full_float32():
            return self._body(spec.to(self.compute_dtype))

    def _body(self, spec: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        k = cfg.num_subbands
        b, c, f, t = spec.shape
        x = spec.reshape(b, c * k, f // k, t)  # cac2cws
        mix = x
        first_conv_out = x = self.first_conv(x)
        x = x.transpose(-1, -2)  # (B, C, T, F)

        encoder_outputs = []
        for stage in self.encoder_blocks:
            x = stage.tfc_tdf(x)
            encoder_outputs.append(x)
            x = stage.downscale(x)
        x = self.bottleneck_block(x)
        for stage in self.decoder_blocks:
            x = stage.upscale(x)
            x = torch.cat([x, encoder_outputs.pop()], dim=1)
            x = stage.tfc_tdf(x)

        x = x.transpose(-1, -2) * first_conv_out  # artifact reduction
        x = self.final_conv(torch.cat([mix, x], dim=1))

        b2, c2, f2, t2 = x.shape
        x = x.reshape(b2, c2 // k, f2 * k, t2)  # cws2cac
        if cfg.num_stems > 1:
            return x.reshape(b2, cfg.num_stems, -1, f2 * k, t2)
        return x[:, None]
