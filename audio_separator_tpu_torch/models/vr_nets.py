"""The VR mask networks as PyTorch modules: CascadedASPPNet (v5) and
CascadedNet (v5.1).

Port of ``audio_separator_tpu/models/vr_nets.py`` (ref: uvr_lib_v5/
vr_network/nets.py, nets_new.py, layers.py, layers_new.py). The modules'
``state_dict`` keys are the upstream checkpoints' less BatchNorm's
``num_batches_tracked``, so a ``.pth`` loads with ``load_state_dict`` and the
JAX package's parameter tree with ``models/convert.load_jax_vr_params``.
Every width comes from the checkpoint's shapes (:func:`build_vr_net`); the
structure (strides, dilations, which ASPP branches exist) from the
architecture, as in the reference constructors.

The rounding points are the JAX package's: every operation computes in the
parameters' dtype (``to_compute_dtype(torch.bfloat16)`` runs the cascade in
bf16, with float32 accumulation in the convolutions; the LSTMs alone compute
in float32 on bf16-rounded weights), BatchNorm as
``(x − mean) · (rsqrt(var + eps) · weight) + bias``, and the bilinear
upsampling as the JAX package's gather and lerp with its weights in the
activation's dtype. A float32 forward runs under
``ops/precision.full_float32``, its convolutions on PyTorch's own kernels
(:class:`Conv2d`). Everything is plain PyTorch (cuDNN's LSTM and bf16
convolutions on the card): the JAX package computes none of it in a Pallas
kernel.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.precision import full_float32
from .lstm import LSTM

Shapes = Dict[str, Tuple[int, ...]]

# The v5 ASPP's extra separable branches by architecture key (file size in
# KB, architectures/vr.py): 129605 adds conv6 (and an enc5/dec5 level);
# 537238, 537227 and 33966 add conv6 and conv7, which upstream share one
# module.
_ASPP_EXTRA = {129605: ("conv6",), 537238: ("conv6", "conv7"),
               537227: ("conv6", "conv7"), 33966: ("conv6", "conv7")}


# --------------------------------------------------------------------------
# primitives


class BatchNorm(nn.Module):
    """Inference BatchNorm over axis 1 (running statistics, eps 1e-5)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.ndim - 2)
        inv = torch.rsqrt(self.running_var + 1e-5)
        return ((x - self.running_mean.reshape(shape)) * (inv * self.weight).reshape(shape)
                + self.bias.reshape(shape))


class Activation(nn.Module):
    def __init__(self, activ: str):
        super().__init__()
        if activ not in ("relu", "leaky"):
            raise ValueError(activ)
        self.activ = activ

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(x) if self.activ == "relu" else F.leaky_relu(x, 0.01)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose float32 calls run PyTorch's own convolution
    (im2col and a float32 GEMM on the card) instead of cuDNN's. With TF32
    off, every cuDNN 9 float32 engine takes 0.3–0.6 s for some decoder shapes
    of these nets (``(4, 320, 112, 128) → 128`` at 3×3, 0.1 TFLOP/s) where
    PyTorch's takes 1.6 ms, and the full-width v5.1 forward of 4 windows
    drops from 728 to 194 ms (``tools/torch_vr_conv_probe.py``, H100). bf16
    calls keep cuDNN's tensor-core kernels.

    ``torch._convolution`` takes cuDNN's and TF32's switches as arguments of
    the one call, so no process-wide switch is touched: a server runs jobs
    on several threads, and the other threads' convolutions keep cuDNN."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype != torch.float32:
            return super().forward(x)
        # benchmark, deterministic, cudnn_enabled, allow_tf32
        return torch._convolution(x, self.weight, self.bias, self.stride, self.padding,
                                  self.dilation, False, (0, 0), self.groups,
                                  False, False, False, False)


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


class Conv2DBNActiv(nn.Module):
    """Conv (no bias) → BatchNorm → activation; padding = dilation for a 3×3
    kernel and 0 for 1×1, as every reference constructor call has it."""

    def __init__(self, nin: int, nout: int, ksize: int, stride=1, dilation=1,
                 activ: str = "relu"):
        super().__init__()
        dilation = _pair(dilation)
        pad = dilation if ksize == 3 else (0, 0)
        self.conv = nn.Sequential(
            Conv2d(nin, nout, ksize, stride, pad, dilation, bias=False),
            BatchNorm(nout), Activation(activ))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class SeperableConv2DBNActiv(nn.Module):
    """Depthwise 3×3 (padding = dilation) → pointwise 1×1 → BatchNorm →
    activation (the reference's spelling of the class)."""

    def __init__(self, nin: int, nout: int, dilation: int, activ: str = "relu"):
        super().__init__()
        self.conv = nn.Sequential(
            Conv2d(nin, nin, 3, 1, dilation, dilation, groups=nin, bias=False),
            Conv2d(nin, nout, 1, bias=False),
            BatchNorm(nout), Activation(activ))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


def _cba(shapes: Shapes, prefix: str, stride=1, dilation=1, activ="relu") -> Conv2DBNActiv:
    nout, nin, k, _ = shapes[f"{prefix}.conv.0.weight"]
    return Conv2DBNActiv(nin, nout, k, stride, dilation, activ)


def _sep_cba(shapes: Shapes, prefix: str, dilation: int) -> SeperableConv2DBNActiv:
    nout, nin = shapes[f"{prefix}.conv.1.weight"][:2]
    return SeperableConv2DBNActiv(nin, nout, dilation)


class _FreqMean(nn.Module):
    """AdaptiveAvgPool2d((1, None)): the mean over the frequency axis."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=2, keepdim=True)


def _axis_weights(in_dim: int, out_dim: int):
    if out_dim == 1 or in_dim == 1:
        idx = np.zeros(out_dim, np.int64)
        return idx, idx, np.zeros(out_dim, np.float32)
    pos = np.linspace(0.0, in_dim - 1.0, out_dim)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, in_dim - 1)
    return lo, hi, (pos - lo).astype(np.float32)


@functools.lru_cache(maxsize=256)
def _lerp_tables(in_dim: int, out_dim: int, dtype: torch.dtype, device: torch.device):
    """Neighbour indices and fractions on ``device``, made once: an upload
    per call would make the host wait for the device's queue."""
    lo, hi, fr = _axis_weights(in_dim, out_dim)
    return (torch.as_tensor(lo, device=device), torch.as_tensor(hi, device=device),
            torch.as_tensor(fr, dtype=dtype, device=device))


def bilinear_align_corners(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """``F.interpolate(x, (out_h, out_w), mode="bilinear", align_corners=True)``
    computed as the JAX package does: gather the two neighbours along each
    axis and lerp with float64-placed fractions cast to ``x``'s dtype (the
    library places its fractions in float32, and rounds once in bf16)."""
    h_lo, h_hi, h_fr = _lerp_tables(x.shape[2], out_h, x.dtype, x.device)
    w_lo, w_hi, w_fr = _lerp_tables(x.shape[3], out_w, x.dtype, x.device)
    h_fr, w_fr = h_fr[None, None, :, None], w_fr[None, None, None, :]
    top = x[:, :, h_lo] * (1 - h_fr) + x[:, :, h_hi] * h_fr
    return top[:, :, :, w_lo] * (1 - w_fr) + top[:, :, :, w_hi] * w_fr


def crop_center(skip: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Crop ``skip``'s time axis to ``target``'s (ref: spec_utils.crop_center:50)."""
    t1, t2 = skip.shape[3], target.shape[3]
    if t1 == t2:
        return skip
    if t1 < t2:
        raise ValueError("skip time axis smaller than target")
    start = (t1 - t2) // 2
    return skip[:, :, :, start : start + t2]


def _upsample_cat(x: torch.Tensor, skip) -> torch.Tensor:
    x = bilinear_align_corners(x, x.shape[2] * 2, x.shape[3] * 2)
    if skip is not None:
        x = torch.cat([x, crop_center(skip, x)], dim=1)
    return x


def _replicate_pad_freq(mask: torch.Tensor, output_bin: int) -> torch.Tensor:
    pad = output_bin - mask.shape[2]
    if pad > 0:
        mask = torch.cat([mask, mask[:, :, -1:].expand(-1, -1, pad, -1)], dim=2)
    return mask


# --------------------------------------------------------------------------
# v5: CascadedASPPNet (nets.py / layers.py)


class EncoderV5(nn.Module):
    def __init__(self, shapes: Shapes, prefix: str, stride: int):
        super().__init__()
        self.conv1 = _cba(shapes, f"{prefix}.conv1", activ="leaky")
        self.conv2 = _cba(shapes, f"{prefix}.conv2", stride=stride, activ="leaky")

    def forward(self, x):
        skip = self.conv1(x)
        return self.conv2(skip), skip


class DecoderV5(nn.Module):
    def __init__(self, shapes: Shapes, prefix: str):
        super().__init__()
        self.conv = _cba(shapes, f"{prefix}.conv")

    def forward(self, x, skip=None):
        return self.conv(_upsample_cat(x, skip))


class ASPPModuleV5(nn.Module):
    def __init__(self, shapes: Shapes, prefix: str, arch: int, dilations=(4, 8, 16)):
        super().__init__()
        self.conv1 = nn.Sequential(_FreqMean(), _cba(shapes, f"{prefix}.conv1.1"))
        self.conv2 = _cba(shapes, f"{prefix}.conv2")
        self.conv3 = _sep_cba(shapes, f"{prefix}.conv3", dilations[0])
        self.conv4 = _sep_cba(shapes, f"{prefix}.conv4", dilations[1])
        self.conv5 = _sep_cba(shapes, f"{prefix}.conv5", dilations[2])
        self.extra = _ASPP_EXTRA.get(arch, ())
        for name in self.extra:
            setattr(self, name, _sep_cba(shapes, f"{prefix}.{name}", dilations[2]))
        self.bottleneck = nn.Sequential(_cba(shapes, f"{prefix}.bottleneck.0"))

    def forward(self, x):
        h, w = x.shape[2], x.shape[3]
        feats = [bilinear_align_corners(self.conv1(x), h, w), self.conv2(x),
                 self.conv3(x), self.conv4(x), self.conv5(x)]
        feats += [getattr(self, name)(x) for name in self.extra]
        return self.bottleneck(torch.cat(feats, dim=1))


class BaseASPPNet(nn.Module):
    def __init__(self, shapes: Shapes, prefix: str, arch: int):
        super().__init__()
        self.levels = 5 if arch == 129605 else 4
        for i in range(1, self.levels + 1):
            setattr(self, f"enc{i}", EncoderV5(shapes, f"{prefix}.enc{i}", 2))
        self.aspp = ASPPModuleV5(shapes, f"{prefix}.aspp", arch)
        for i in range(self.levels, 0, -1):
            setattr(self, f"dec{i}", DecoderV5(shapes, f"{prefix}.dec{i}"))

    def forward(self, x):
        skips = []
        for i in range(1, self.levels + 1):
            x, skip = getattr(self, f"enc{i}")(x)
            skips.append(skip)
        x = self.aspp(x)
        for i in range(self.levels, 0, -1):
            x = getattr(self, f"dec{i}")(x, skips[i - 1])
        return x


class _MaskNet(nn.Module):
    """Shared head: crop to ``max_bin`` on input; the mask's frequency axis
    edge-padded to ``n_fft/2 + 1`` and its time axis cropped by ``offset``
    on both sides on output."""

    def __init__(self, n_fft_bins: int, offset: int):
        super().__init__()
        self.max_bin = n_fft_bins // 2
        self.output_bin = n_fft_bins // 2 + 1
        self.offset = offset

    def mask(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def to_compute_dtype(self, dtype: torch.dtype) -> "_MaskNet":
        """Run the net in ``dtype`` (bf16: ``use_autocast``): every weight is
        rounded to it, and every operation computes in it except the LSTMs,
        which compute in float32 on their rounded weights (cuDNN's bf16 LSTM
        steps one small product a frame and packs no weights; its float32
        LSTM is one persistent launch)."""
        self.to(dtype)
        for m in self.modules():
            if isinstance(m, LSTM):
                m.float()
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, 2, bins, frames)`` magnitudes → ``(B, 2, n_fft/2 + 1,
        frames − 2·offset)`` mask in the parameters' dtype."""
        with full_float32():
            mask = _replicate_pad_freq(self.mask(x[:, :, : self.max_bin]), self.output_bin)
        if self.offset > 0:
            mask = mask[:, :, :, self.offset : -self.offset]
        return mask


class CascadedASPPNet(_MaskNet):
    """VR v5 (ref: nets.py:5-175)."""

    def __init__(self, shapes: Shapes, n_fft_bins: int, arch: int, offset: int = 128):
        super().__init__(n_fft_bins, offset)
        self.stg1_low_band_net = BaseASPPNet(shapes, "stg1_low_band_net", arch)
        self.stg1_high_band_net = BaseASPPNet(shapes, "stg1_high_band_net", arch)
        self.stg2_bridge = _cba(shapes, "stg2_bridge")
        self.stg2_full_band_net = BaseASPPNet(shapes, "stg2_full_band_net", arch)
        self.stg3_bridge = _cba(shapes, "stg3_bridge")
        self.stg3_full_band_net = BaseASPPNet(shapes, "stg3_full_band_net", arch)
        self.out = Conv2d(*shapes["out.weight"][1::-1], 1, bias=False)
        # Training-only heads, kept so that a checkpoint loads strictly.
        self.aux1_out = nn.Conv2d(*shapes["aux1_out.weight"][1::-1], 1, bias=False)
        self.aux2_out = nn.Conv2d(*shapes["aux2_out.weight"][1::-1], 1, bias=False)

    def mask(self, x):
        bw = x.shape[2] // 2
        aux1 = torch.cat([self.stg1_low_band_net(x[:, :, :bw]),
                          self.stg1_high_band_net(x[:, :, bw:])], dim=2)
        aux2 = self.stg2_full_band_net(self.stg2_bridge(torch.cat([x, aux1], dim=1)))
        h = self.stg3_full_band_net(self.stg3_bridge(torch.cat([x, aux1, aux2], dim=1)))
        return torch.sigmoid(self.out(h))


# --------------------------------------------------------------------------
# v5.1: CascadedNet (nets_new.py / layers_new.py)


class EncoderV51(nn.Module):
    def __init__(self, shapes: Shapes, prefix: str, stride: int):
        super().__init__()
        self.conv1 = _cba(shapes, f"{prefix}.conv1", stride=stride, activ="leaky")
        self.conv2 = _cba(shapes, f"{prefix}.conv2", activ="leaky")

    def forward(self, x):
        return self.conv2(self.conv1(x))


class DecoderV51(nn.Module):
    def __init__(self, shapes: Shapes, prefix: str):
        super().__init__()
        self.conv1 = _cba(shapes, f"{prefix}.conv1")

    def forward(self, x, skip=None):
        return self.conv1(_upsample_cat(x, skip))


class ASPPModuleV51(nn.Module):
    def __init__(self, shapes: Shapes, prefix: str, dilations=((4, 2), (8, 4), (12, 6))):
        super().__init__()
        self.conv1 = nn.Sequential(_FreqMean(), _cba(shapes, f"{prefix}.conv1.1"))
        self.conv2 = _cba(shapes, f"{prefix}.conv2")
        self.conv3 = _cba(shapes, f"{prefix}.conv3", dilation=dilations[0])
        self.conv4 = _cba(shapes, f"{prefix}.conv4", dilation=dilations[1])
        self.conv5 = _cba(shapes, f"{prefix}.conv5", dilation=dilations[2])
        self.bottleneck = _cba(shapes, f"{prefix}.bottleneck")

    def forward(self, x):
        h, w = x.shape[2], x.shape[3]
        feats = [bilinear_align_corners(self.conv1(x), h, w), self.conv2(x),
                 self.conv3(x), self.conv4(x), self.conv5(x)]
        return self.bottleneck(torch.cat(feats, dim=1))


class LSTMModule(nn.Module):
    """1×1 conv to one channel → bidirectional LSTM over frames (one step a
    frame, the bins as features) → dense + BatchNorm1d + ReLU
    (ref: layers_new.py:124-160). ``(N, C, bins, frames)`` →
    ``(N, 1, bins, frames)``."""

    def __init__(self, shapes: Shapes, prefix: str):
        super().__init__()
        self.conv = _cba(shapes, f"{prefix}.conv")
        self.lstm = LSTM.from_state_shapes(shapes, f"{prefix}.lstm")
        nin, nout = shapes[f"{prefix}.dense.0.weight"][::-1]
        self.dense = nn.Sequential(nn.Linear(nin, nout), BatchNorm(nout), nn.ReLU())

    def forward(self, x):
        n, _, nbins, nframes = x.shape
        h = self.conv(x)[:, 0].permute(2, 0, 1)  # (frames, N, bins)
        h = self.lstm(h)
        h = self.dense(h.reshape(-1, h.shape[-1]))
        return h.reshape(nframes, n, 1, nbins).permute(1, 2, 3, 0)


class BaseNetV51(nn.Module):
    def __init__(self, shapes: Shapes, prefix: str):
        super().__init__()
        self.enc1 = _cba(shapes, f"{prefix}.enc1")
        for i in range(2, 6):
            setattr(self, f"enc{i}", EncoderV51(shapes, f"{prefix}.enc{i}", 2))
        self.aspp = ASPPModuleV51(shapes, f"{prefix}.aspp")
        for i in (4, 3, 2):
            setattr(self, f"dec{i}", DecoderV51(shapes, f"{prefix}.dec{i}"))
        self.lstm_dec2 = LSTMModule(shapes, f"{prefix}.lstm_dec2")
        self.dec1 = DecoderV51(shapes, f"{prefix}.dec1")

    def forward(self, x):
        e1 = self.enc1(x)
        e2 = self.enc2(e1)
        e3 = self.enc3(e2)
        e4 = self.enc4(e3)
        h = self.aspp(self.enc5(e4))
        h = self.dec2(self.dec3(self.dec4(h, e4), e3), e2)
        h = torch.cat([h, self.lstm_dec2(h)], dim=1)
        return self.dec1(h, e1)


class CascadedNet(_MaskNet):
    """VR v5.1 (ref: nets_new.py:7-160)."""

    def __init__(self, shapes: Shapes, n_fft_bins: int, offset: int = 64):
        super().__init__(n_fft_bins, offset)
        self.stg1_low_band_net = nn.Sequential(BaseNetV51(shapes, "stg1_low_band_net.0"),
                                               _cba(shapes, "stg1_low_band_net.1"))
        self.stg1_high_band_net = BaseNetV51(shapes, "stg1_high_band_net")
        self.stg2_low_band_net = nn.Sequential(BaseNetV51(shapes, "stg2_low_band_net.0"),
                                               _cba(shapes, "stg2_low_band_net.1"))
        self.stg2_high_band_net = BaseNetV51(shapes, "stg2_high_band_net")
        self.stg3_full_band_net = BaseNetV51(shapes, "stg3_full_band_net")
        self.out = Conv2d(*shapes["out.weight"][1::-1], 1, bias=False)
        # Training-only head, kept so that a checkpoint loads strictly.
        self.aux_out = nn.Conv2d(*shapes["aux_out.weight"][1::-1], 1, bias=False)

    def mask(self, x):
        bw = x.shape[2] // 2
        l1_in, h1_in = x[:, :, :bw], x[:, :, bw:]
        l1 = self.stg1_low_band_net(l1_in)
        h1 = self.stg1_high_band_net(h1_in)
        l2 = self.stg2_low_band_net(torch.cat([l1_in, l1], dim=1))
        h2 = self.stg2_high_band_net(torch.cat([h1_in, h1], dim=1))
        f3 = self.stg3_full_band_net(torch.cat([x, torch.cat([l1, h1], dim=2),
                                                torch.cat([l2, h2], dim=2)], dim=1))
        return torch.sigmoid(self.out(f3))


# --------------------------------------------------------------------------
# construction


def inference_state(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A checkpoint's state dict less BatchNorm's ``num_batches_tracked``."""
    return {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}


def build_vr_net(sd: Dict[str, np.ndarray], n_fft_bins: int, arch: int, is_v51: bool,
                 offset: int) -> _MaskNet:
    """The VR net whose widths ``sd``'s shapes give (weights not loaded):
    v5.1's ``CascadedNet`` or v5's ``CascadedASPPNet`` at architecture key
    ``arch``. ``n_fft_bins`` is the band JSON's ``bins · 2``."""
    shapes = {k: tuple(np.shape(v)) for k, v in inference_state(sd).items()}
    if is_v51:
        return CascadedNet(shapes, n_fft_bins, offset)
    return CascadedASPPNet(shapes, n_fft_bins, arch, offset)


def load_vr_net(sd: Dict[str, np.ndarray], n_fft_bins: int, arch: int, is_v51: bool,
                offset: int, device="cpu") -> _MaskNet:
    """:func:`build_vr_net` with ``sd``'s weights loaded strictly, in
    inference mode on ``device``."""
    net = build_vr_net(sd, n_fft_bins, arch, is_v51, offset)
    net.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
                         for k, v in inference_state(sd).items()}, strict=True)
    return net.eval().requires_grad_(False).to(device)
