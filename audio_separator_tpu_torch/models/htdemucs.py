"""HTDemucs (Demucs v4 hybrid transformer) and HDemucs (Demucs v3) as
PyTorch modules.

Port of ``audio_separator_tpu/models/htdemucs.py`` (``apply_htdemucs`` and
``apply_hdemucs``). The modules' ``state_dict`` keys are the upstream
checkpoint's keys (the JAX package's parameter tree is that layout split on
``.``), so a checkpoint's state loads with ``load_state_dict(strict=True)``
and a JAX tree with ``models/convert.load_jax_htdemucs_params`` or
``load_jax_hdemucs_params``.

Scope: the Demucs v4 configuration family (complex-as-channels, dense
attention, norm-first transformer with layer scale and output norm) —
htdemucs / htdemucs_ft / htdemucs_6s — and the Demucs v3 hybrid (``HDemucs``:
six levels, GroupNorm past ``norm_starts``, BLSTM and LocalState branches in
the deep DConvs, no transformer, the decoder fed zeros, and either the
complex-as-channels head or the magnitude head with the multichannel Wiener
filter of ``models/filtering.py``). Everything runs in float32: Demucs is
precision-sensitive.

The self-attention layers of the cross-transformer go through
``ops/attention.dot_product_attention`` (the hand-written kernel on a CUDA
tensor). The projections around it are plain products (``F.linear``), and the
cross-attention layers, whose query and key lengths differ, are plain PyTorch
too — as the JAX package computes both outside any Pallas kernel. The
modules are differentiable (``training.make_train_step`` trains them); the
self-attention's backward is the kernel of ``csrc/attention_bwd.cu``.

Every GroupNorm goes through ``ops/group_norm.group_norm`` with the step that
follows it (the DConvs' GELU and GLU·scale + residual, the encoders' GELU and
GLU, the transformer's output norm in its ``(B, T, C)`` layout): the
hand-written kernel on a CUDA tensor in inference, the modules' own
composition on the CPU and under autograd. The ``nn.GroupNorm``, ``nn.GELU``,
``nn.GLU`` and ``LayerScale`` modules stay where upstream has them, so the
state-dict keys do not move.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, fields
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention
from ..ops.group_norm import group_norm
from ..ops.precision import full_float32
from ..ops.stft import hann_window, istft, stft
from .filtering import wiener
from .lstm import LSTM


@dataclass(frozen=True)
class HTDemucsConfig:
    sources: Tuple[str, ...]
    arch: str = "htdemucs"  # "htdemucs" (v4) | "hdemucs" (v3)
    audio_channels: int = 2
    channels: int = 48
    growth: int = 2
    nfft: int = 4096
    cac: bool = True
    depth: int = 4
    kernel_size: int = 8
    stride: int = 4
    time_stride: int = 2
    context: int = 1
    context_enc: int = 0
    norm_starts: int = 4
    norm_groups: int = 4
    dconv_mode: int = 1  # 1: DConv in the encoders, 2: in the decoders, 3: both
    dconv_depth: int = 2
    dconv_comp: int = 8
    freq_emb: float = 0.2
    emb_scale: float = 10.0
    bottom_channels: int = 0
    t_layers: int = 5
    t_heads: int = 8
    t_hidden_scale: float = 4.0
    t_cross_first: bool = False
    samplerate: int = 44100
    segment: float = 10.0
    use_train_segment: bool = True
    # HDemucs (v3) only: the levels from which the DConvs hold a BLSTM and a
    # LocalState, and the magnitude head's Wiener filter (cac=False).
    dconv_lstm: int = 4
    dconv_attn: int = 4
    wiener_iters: int = 0
    wiener_residual: bool = False

    @property
    def hop_length(self) -> int:
        return self.nfft // 4

    @property
    def training_length(self) -> int:
        return int(self.segment * self.samplerate)


# The HDemucs constructor's defaults where they differ from HTDemucs's.
HDEMUCS_DEFAULTS = {"depth": 6, "segment": 40.0, "dconv_comp": 4}


def config_from_kwargs(kwargs: Dict[str, Any], args: tuple = (),
                       klass_name: str = "HTDemucs") -> HTDemucsConfig:
    """Build the config from a demucs checkpoint's (args, kwargs) record.

    An ``HDemucs`` record takes that constructor's defaults and evaluates
    each chunk at its exact length (``use_train_segment=False``), as the JAX
    loader does."""
    sources = tuple(kwargs.get("sources") or (args[0] if args else ()))
    known = {f.name for f in fields(HTDemucsConfig)}
    picked = {k: v for k, v in kwargs.items() if k in known and k != "sources"}
    if klass_name == "HDemucs":
        picked = {**HDEMUCS_DEFAULTS, **picked, "arch": "hdemucs",
                  "use_train_segment": False}
    if "segment" in picked:
        picked["segment"] = float(picked["segment"])
    return HTDemucsConfig(sources=sources, **picked)


# --------------------------------------------------------------------------
# Demucs-normalised STFT


def pad1d_reflect(x: torch.Tensor, pad_left: int, pad_right: int) -> torch.Tensor:
    """Reflect pad of the last axis; an input no longer than the pad is first
    zero-extended so the reflection is defined."""
    length = x.shape[-1]
    max_pad = max(pad_left, pad_right)
    if length <= max_pad:
        extra = max_pad - length + 1
        extra_right = min(pad_right, extra)
        extra_left = extra - extra_right
        x = F.pad(x, (extra_left, extra_right))
        pad_left -= extra_left
        pad_right -= extra_right
    lead = x.shape[:-1]
    out = F.pad(x.reshape(1, -1, x.shape[-1]), (pad_left, pad_right), mode="reflect")
    return out.reshape(*lead, out.shape[-1])


def _spectro(x: torch.Tensor, nfft: int, hop: int) -> torch.Tensor:
    """``torch.stft(normalized=True)``: periodic Hann, reflect-padded frames,
    scaled by ``nfft ** -0.5``."""
    return stft(x, nfft, hop, hann_window(nfft), pad_mode="reflect") * (1.0 / math.sqrt(nfft))


def _ispectro(z: torch.Tensor, hop: int, length: int) -> torch.Tensor:
    nfft = 2 * z.shape[-2] - 2
    return istft(z * math.sqrt(nfft), nfft, hop, hann_window(nfft), length=length)


def _model_spec(x: torch.Tensor, cfg: HTDemucsConfig) -> torch.Tensor:
    """``(..., T)`` → ``(..., nfft // 2, ceil(T / hop))`` complex."""
    hl = cfg.hop_length
    le = int(math.ceil(x.shape[-1] / hl))
    pad = hl // 2 * 3
    x = pad1d_reflect(x, pad, pad + le * hl - x.shape[-1])
    z = _spectro(x, cfg.nfft, hl)[..., :-1, :]
    return z[..., 2 : 2 + le]


def _model_ispec(z: torch.Tensor, length: int, cfg: HTDemucsConfig) -> torch.Tensor:
    hl = cfg.hop_length
    z = F.pad(z, (2, 2, 0, 1))  # one zero frequency row, two frames each side
    pad = hl // 2 * 3
    le = hl * int(math.ceil(length / hl)) + 2 * pad
    x = _ispectro(z, hl, length=le)
    return x[..., pad : pad + length]


# --------------------------------------------------------------------------
# Encoder / decoder layers


class LayerScale(nn.Module):
    def __init__(self, channels: int, channel_last: bool = False):
        super().__init__()
        self.channel_last = channel_last
        self.scale = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.scale * x if self.channel_last else self.scale[:, None] * x


class BLSTM(nn.Module):
    """Two bidirectional LSTM layers over ``(B, C, T)``, a linear layer back
    to ``C`` channels and the residual. A sequence longer than ``max_steps``
    runs as frames of ``max_steps`` at a stride of half that, each frame's
    outer quarter-strides trimmed at the seams (JAX ``_blstm``)."""

    def __init__(self, dim: int, max_steps: int = 200):
        super().__init__()
        self.max_steps = max_steps
        self.lstm = LSTM(dim, dim, num_layers=2, bidirectional=True)
        self.linear = nn.Linear(2 * dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, t = x.shape
        residual = x
        framed = t > self.max_steps
        if framed:
            width, stride = self.max_steps, self.max_steps // 2
            n_frames = -(-t // stride)
            x = F.pad(x, (0, (n_frames - 1) * stride + width - t))
            x = x.unfold(-1, width, stride)  # (B, C, n_frames, width)
            x = x.permute(0, 2, 1, 3).reshape(-1, c, width)
        y = self.linear(self.lstm(x.permute(2, 0, 1)))  # (T', B', C)
        x = y.permute(1, 2, 0)
        if framed:
            frames = x.reshape(b, n_frames, c, width)
            limit = stride // 2
            pieces = [frames[:, 0, :, :-limit]]
            pieces += [frames[:, k, :, limit:-limit] for k in range(1, n_frames - 1)]
            pieces.append(frames[:, -1, :, limit:])
            x = torch.cat(pieces, dim=-1)[..., :t]
        return x + residual


class LocalState(nn.Module):
    """Attention over time with a learnt decay in the distance: per head,
    the key·query products plus ``Σ_f −f·|t−s|·sigmoid(q_f(s))/2 / √ndecay``,
    the diagonal set to −100, a softmax over the key axis, then the content
    weighted and projected back, plus the residual (JAX ``_local_state``).
    Plain products: the JAX package computes it in XLA, not in a kernel."""

    def __init__(self, channels: int, heads: int = 4, ndecay: int = 4):
        super().__init__()
        self.heads, self.ndecay = heads, ndecay
        self.content = nn.Conv1d(channels, channels, 1)
        self.query = nn.Conv1d(channels, channels, 1)
        self.key = nn.Conv1d(channels, channels, 1)
        self.query_decay = nn.Conv1d(channels, heads * ndecay, 1)
        self.proj = nn.Conv1d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, t = x.shape
        h = self.heads
        queries = self.query(x).reshape(b, h, -1, t)
        keys = self.key(x).reshape(b, h, -1, t)
        dots = torch.matmul(keys.transpose(-1, -2), queries)  # (B, H, T_key, T_query)
        dots = dots / keys.shape[2] ** 0.5
        # The decay kernel -f·|t−s|/√ndecay is separable: weigh each query's
        # decays by f first, then scale the distance matrix once.
        decays = torch.arange(1, self.ndecay + 1, dtype=x.dtype, device=x.device)
        decay_q = torch.sigmoid(self.query_decay(x).reshape(b, h, self.ndecay, t)) / 2
        rate = torch.einsum("f,bhfs->bhs", decays, decay_q) / self.ndecay ** 0.5
        idx = torch.arange(t, device=x.device, dtype=x.dtype)
        distance = (idx[:, None] - idx[None, :]).abs()
        dots = dots - distance * rate[:, :, None, :]
        dots = dots.masked_fill(torch.eye(t, dtype=torch.bool, device=x.device), -100.0)
        weights = torch.softmax(dots, dim=2)
        content = self.content(x).reshape(b, h, -1, t)
        result = torch.matmul(content, weights).reshape(b, -1, t)
        return x + self.proj(result)


def _norm(norm: nn.GroupNorm, x: torch.Tensor, epilogue: str = "none",
          **kwargs) -> torch.Tensor:
    """``norm`` and the ``epilogue`` after it (``ops/group_norm``)."""
    return group_norm(x, norm.weight, norm.bias, norm.num_groups, norm.eps, epilogue, **kwargs)


class DConv(nn.Module):
    """Residual branch of dilated convolutions over ``(B, C, T)``:
    conv → GroupNorm → GELU → [BLSTM] → [LocalState] → conv → GroupNorm →
    GLU → scale, per depth (the bracketed modules in Demucs v3's deep levels,
    at Sequential index 3 and on, as upstream inserts them). Each GroupNorm
    runs with the step after it, the second with the residual add too; the
    Sequential keeps upstream's indices and is not called as a whole."""

    def __init__(self, channels: int, compress: float, depth: int,
                 lstm: bool = False, attn: bool = False):
        super().__init__()
        hidden = int(channels / compress)
        self.layers = nn.ModuleList()
        for d in range(depth):
            mods = [nn.Conv1d(channels, hidden, 3, dilation=2 ** d, padding=2 ** d),
                    nn.GroupNorm(1, hidden), nn.GELU(),
                    nn.Conv1d(hidden, 2 * channels, 1), nn.GroupNorm(1, 2 * channels),
                    nn.GLU(1), LayerScale(channels)]
            if attn:
                mods.insert(3, LocalState(hidden))
            if lstm:
                mods.insert(3, BLSTM(hidden))
            self.layers.append(nn.Sequential(*mods))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            mods = list(layer)
            y = _norm(mods[1], mods[0](x), "gelu")
            for branch in mods[3:-4]:  # v3's BLSTM and LocalState
                y = branch(y)
            x = _norm(mods[-3], mods[-4](y), "glu_scale_residual", scale=mods[-1].scale,
                      residual=x)
        return x


def _dconv_over_time(dconv: DConv, y: torch.Tensor) -> torch.Tensor:
    """Apply a DConv along time; a frequency-branch ``(B, C, Fr, T)`` input
    folds its frequency axis into the batch."""
    if y.dim() == 3:
        return dconv(y)
    b, c, fr, t = y.shape
    y = dconv(y.permute(0, 2, 1, 3).reshape(-1, c, t))
    return y.reshape(b, fr, c, t).permute(0, 2, 1, 3)


class HEncLayer(nn.Module):
    def __init__(self, chin: int, chout: int, kernel: int, stride: int, pad: int,
                 freq: bool, empty: bool, norm: bool, cfg: HTDemucsConfig,
                 lstm: bool = False, attn: bool = False):
        super().__init__()
        self.freq, self.stride, self.empty = freq, stride, empty
        conv = nn.Conv2d if freq else nn.Conv1d
        if freq:
            self.conv = nn.Conv2d(chin, chout, (kernel, 1), (stride, 1), (pad, 0))
        else:
            self.conv = nn.Conv1d(chin, chout, kernel, stride, pad)
        if empty:
            return
        ctx = cfg.context_enc
        if norm:
            self.norm1 = nn.GroupNorm(cfg.norm_groups, chout)
        self.rewrite = conv(chout, 2 * chout, 1 + 2 * ctx, 1, ctx)
        if norm:
            self.norm2 = nn.GroupNorm(cfg.norm_groups, 2 * chout)
        if cfg.dconv_mode & 1:
            self.dconv = DConv(chout, cfg.dconv_comp, cfg.dconv_depth, lstm, attn)

    def forward(self, x: torch.Tensor, inject: Optional[torch.Tensor] = None) -> torch.Tensor:
        if not self.freq:
            if x.dim() == 4:
                x = x.reshape(x.shape[0], -1, x.shape[-1])
            le = x.shape[-1]
            if le % self.stride:
                x = F.pad(x, (0, self.stride - le % self.stride))
        y = self.conv(x)
        if self.empty:
            return y
        if inject is not None:
            if inject.dim() == 3 and y.dim() == 4:
                inject = inject[:, :, None]
            y = y + inject
        y = _norm(self.norm1, y, "gelu") if hasattr(self, "norm1") else F.gelu(y)
        if hasattr(self, "dconv"):
            y = _dconv_over_time(self.dconv, y)
        z = self.rewrite(y)
        if hasattr(self, "norm2"):
            return _norm(self.norm2, z, "glu_scale_residual")
        return F.glu(z, dim=1)


class HDecLayer(nn.Module):
    def __init__(self, chin: int, chout: int, kernel: int, stride: int, pad: int,
                 freq: bool, empty: bool, norm: bool, last: bool, cfg: HTDemucsConfig,
                 lstm: bool = False, attn: bool = False):
        super().__init__()
        self.freq, self.pad, self.empty, self.last, self.chin = freq, pad, empty, last, chin
        if freq:
            # Strides the frequency axis only.
            self.conv_tr = nn.ConvTranspose2d(chin, chout, (kernel, 1), (stride, 1))
        else:
            self.conv_tr = nn.ConvTranspose1d(chin, chout, kernel, stride)
        if norm:
            self.norm2 = nn.GroupNorm(cfg.norm_groups, chout)
        if empty:
            return
        ctx = cfg.context
        conv = nn.Conv2d if freq else nn.Conv1d
        # On the frequency branch the rewrite is a square (1 + 2·ctx)² conv.
        self.rewrite = conv(chin, 2 * chin, 1 + 2 * ctx, 1, ctx)
        if norm:
            self.norm1 = nn.GroupNorm(cfg.norm_groups, 2 * chin)
        if cfg.dconv_mode & 2:
            self.dconv = DConv(chin, cfg.dconv_comp, cfg.dconv_depth, lstm, attn)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor],
                length: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns ``(z, y)``: the layer's output and its input to the
        transposed convolution (which the merge level's time decoder reads)."""
        if self.freq and x.dim() == 3:
            x = x.reshape(x.shape[0], self.chin, -1, x.shape[-1])
        if self.empty:
            if skip is not None:
                raise ValueError("an empty decoder layer takes no skip")
            y = x
        else:
            y = self.rewrite(x + skip)
            if hasattr(self, "norm1"):
                y = _norm(self.norm1, y, "glu_scale_residual")
            else:
                y = F.glu(y, dim=1)
            if hasattr(self, "dconv"):
                y = _dconv_over_time(self.dconv, y)
        z = self.conv_tr(y)
        if hasattr(self, "norm2"):  # the GELU below comes after a slice
            z = _norm(self.norm2, z)
        if self.freq:
            if self.pad:
                z = z[..., self.pad : -self.pad, :]
        else:
            z = z[..., self.pad : self.pad + length]
        if not self.last:
            z = F.gelu(z)
        return z, y


class ScaledEmbedding(nn.Module):
    """The stored weight is divided by ``scale`` and multiplied back at
    lookup."""

    def __init__(self, num_embeddings: int, embedding_dim: int, scale: float):
        super().__init__()
        self.embedding = nn.Embedding(num_embeddings, embedding_dim)
        self.scale = scale

    def forward(self, n: int) -> torch.Tensor:
        return self.embedding.weight[:n] * self.scale


# --------------------------------------------------------------------------
# Cross transformer


@functools.lru_cache(maxsize=8)
def _sin_embedding_1d(length: int, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    pos = np.arange(length, dtype=np.float64)[:, None]
    half = dim // 2
    adim = np.arange(half, dtype=np.float64)[None, :]
    phase = pos / (max_period ** (adim / (half - 1)))
    return torch.as_tensor(np.concatenate([np.cos(phase), np.sin(phase)], axis=-1),
                           dtype=torch.float32)  # (T, dim)


@functools.lru_cache(maxsize=8)
def _sin_embedding_2d(d_model: int, height: int, width: int,
                      max_period: float = 10000.0) -> torch.Tensor:
    """``(1, C, H, W)``, computed in float64 and cast."""
    pe = np.zeros((d_model, height, width))
    half = d_model // 2
    div_term = np.exp(np.arange(0.0, half, 2) * -(math.log(max_period) / half))
    pos_w = np.arange(width)[:, None]
    pos_h = np.arange(height)[:, None]
    pe[0:half:2] = np.tile(np.sin(pos_w * div_term).T[:, None, :], (1, height, 1))
    pe[1:half:2] = np.tile(np.cos(pos_w * div_term).T[:, None, :], (1, height, 1))
    pe[half::2] = np.tile(np.sin(pos_h * div_term).T[:, :, None], (1, 1, width))
    pe[half + 1 :: 2] = np.tile(np.cos(pos_h * div_term).T[:, :, None], (1, 1, width))
    return torch.as_tensor(pe[None], dtype=torch.float32)


def _cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """Attention with query and key lengths that differ: plain products."""
    attn = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * scale, dim=-1)
    return torch.matmul(attn, v)


class MultiheadAttention(nn.Module):
    """``nn.MultiheadAttention(batch_first=True)`` at inference, under its
    parameter names."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        b, tq, e = q.shape
        dh = e // self.heads
        w, bias = self.in_proj_weight, self.in_proj_bias

        def split(x, lo):
            y = F.linear(x, w[lo : lo + e], bias[lo : lo + e])
            return y.reshape(b, x.shape[1], self.heads, dh).transpose(1, 2)

        qh, kh, vh = split(q, 0), split(k, e), split(v, 2 * e)
        if qh.shape == kh.shape:
            out = dot_product_attention(qh, kh, vh)
        else:
            out = _cross_attention(qh, kh, vh, dh ** -0.5)
        return self.out_proj(out.transpose(1, 2).reshape(b, tq, e))


class FeedForwardShard(nn.Module):
    """One tensor-parallel shard of a cross-transformer feed-forward
    (``parallel/mesh.shard_htdemucs_params``): ``linear1``'s rows of its
    hidden units with their bias (column-parallel) and ``linear2``'s columns
    of the same units, without its bias (row-parallel: a partial product)."""

    def __init__(self, linear1: nn.Linear, linear2: nn.Linear):
        super().__init__()
        self.linear1 = linear1
        self.linear2 = linear2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear2(F.gelu(self.linear1(x.to(self.linear1.weight.device))))


class RowParallelBias(nn.Module):
    """What a sharded layer keeps of ``linear2``: its bias, added once after
    the shards' partial products are summed."""

    def __init__(self, bias: torch.Tensor):
        super().__init__()
        self.bias = nn.Parameter(bias, requires_grad=bias.requires_grad)


class _TransformerLayer(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.linear1 = nn.Linear(dim, hidden)
        self.linear2 = nn.Linear(hidden, dim)
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.norm_out = nn.GroupNorm(1, dim)
        self.gamma_1 = LayerScale(dim, channel_last=True)
        self.gamma_2 = LayerScale(dim, channel_last=True)
        # Set by parallel/mesh.shard_htdemucs_params (a ModuleList of
        # FeedForwardShard; linear1 then goes and linear2 keeps its bias).
        self.tp_shards = None

    def _feed_forward(self, x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
        h = norm(x)
        if self.tp_shards is None:
            y = self.linear2(F.gelu(self.linear1(h)))
        else:  # the all-reduce: the shards' partial products summed on h's device
            y = self.linear2.bias + sum(shard(h).to(h.device) for shard in self.tp_shards)
        x = x + self.gamma_2(y)
        # GroupNorm(1) on (B, T, C): statistics over (T, C) jointly.
        return _norm(self.norm_out, x, channel_last=True)


class SelfAttentionLayer(_TransformerLayer):
    def __init__(self, dim: int, heads: int, hidden: int):
        super().__init__(dim, hidden)
        self.self_attn = MultiheadAttention(dim, heads)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm1(x)
        x = x + self.gamma_1(self.self_attn(h, h, h))
        return self._feed_forward(x, self.norm2)


class CrossAttentionLayer(_TransformerLayer):
    def __init__(self, dim: int, heads: int, hidden: int):
        super().__init__(dim, hidden)
        self.cross_attn = MultiheadAttention(dim, heads)
        self.norm3 = nn.LayerNorm(dim)

    def forward(self, q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        kn = self.norm2(k)
        x = q + self.gamma_1(self.cross_attn(self.norm1(q), kn, kn))
        return self._feed_forward(x, self.norm3)


class CrossTransformerEncoder(nn.Module):
    def __init__(self, dim: int, cfg: HTDemucsConfig):
        super().__init__()
        hidden = int(dim * cfg.t_hidden_scale)
        self.norm_in = nn.LayerNorm(dim)
        self.norm_in_t = nn.LayerNorm(dim)
        self.layers = nn.ModuleList()
        self.layers_t = nn.ModuleList()
        classic_parity = 1 if cfg.t_cross_first else 0
        for idx in range(cfg.t_layers):
            kind = SelfAttentionLayer if idx % 2 == classic_parity else CrossAttentionLayer
            self.layers.append(kind(dim, cfg.t_heads, hidden))
            self.layers_t.append(kind(dim, cfg.t_heads, hidden))

    def forward(self, x: torch.Tensor, xt: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        b, c, fr, t1 = x.shape
        pos_2d = _sin_embedding_2d(c, fr, t1).permute(0, 3, 2, 1).reshape(1, t1 * fr, c)
        x = x.permute(0, 3, 2, 1).reshape(b, t1 * fr, c)  # b (t1 fr) c
        x = self.norm_in(x) + pos_2d.to(x.device)

        t2 = xt.shape[-1]
        xt = xt.transpose(1, 2)  # (B, T2, C)
        xt = self.norm_in_t(xt) + _sin_embedding_1d(t2, c)[None].to(xt.device)

        for layer, layer_t in zip(self.layers, self.layers_t):
            if isinstance(layer, SelfAttentionLayer):
                x = layer(x)
                xt = layer_t(xt)
            else:
                old_x = x
                x = layer(x, xt)
                xt = layer_t(xt, old_x)

        x = x.reshape(b, t1, fr, c).permute(0, 3, 2, 1)
        return x, xt.transpose(1, 2)


# --------------------------------------------------------------------------
# The model


def _layer_geometry(cfg: HTDemucsConfig) -> List[Dict[str, Any]]:
    """Per-depth frequency-branch kernel / stride / pad / last_freq."""
    geo = []
    freqs = cfg.nfft // 2
    for _ in range(cfg.depth):
        freq = freqs > 1
        stri, ker = cfg.stride, cfg.kernel_size
        if not freq:
            ker, stri = cfg.time_stride * 2, cfg.time_stride
        pad = True
        last_freq = False
        if freq and freqs <= cfg.kernel_size:
            ker = freqs
            pad = False
            last_freq = True
        geo.append({"freq": freq, "kernel": ker, "stride": stri,
                    "pad": ker // 4 if pad else 0, "last_freq": last_freq})
        if freq:
            freqs = 1 if freqs <= cfg.kernel_size else freqs // cfg.stride
    return geo


class HTDemucs(nn.Module):
    """``mix (B, C, T)`` → ``(B, S, C, T)``."""

    v3 = False  # HDemucs: no transformer, decoder fed zeros, BLSTM / LocalState

    def __init__(self, cfg: HTDemucsConfig):
        super().__init__()
        self.cfg = cfg
        self.geometry = _layer_geometry(cfg)
        self.encoder = nn.ModuleList()
        self.decoder = nn.ModuleList()
        self.tencoder = nn.ModuleList()
        self.tdecoder = nn.ModuleList()

        chin = cfg.audio_channels
        chin_z = chin * 2 if cfg.cac else chin  # complex as channels, or magnitudes
        chout = chout_z = cfg.channels
        tpad = cfg.kernel_size // 4
        for index, g in enumerate(self.geometry):
            norm = index >= cfg.norm_starts
            branches = {"lstm": self.v3 and index >= cfg.dconv_lstm,
                        "attn": self.v3 and index >= cfg.dconv_attn}
            if g["last_freq"]:
                chout_z = max(chout, chout_z)
                chout = chout_z
            self.encoder.append(HEncLayer(chin_z, chout_z, g["kernel"], g["stride"], g["pad"],
                                          g["freq"], False, norm, cfg, **branches))
            if g["freq"]:
                self.tencoder.append(HEncLayer(chin, chout, cfg.kernel_size, cfg.stride, tpad,
                                               False, g["last_freq"], norm, cfg, **branches))
            if index == 0:
                chin = cfg.audio_channels * len(cfg.sources)
                chin_z = chin * 2 if cfg.cac else chin
            self.decoder.insert(0, HDecLayer(chout_z, chin_z, g["kernel"], g["stride"],
                                             g["pad"], g["freq"], False, norm, index == 0, cfg,
                                             **branches))
            if g["freq"]:
                self.tdecoder.insert(0, HDecLayer(chout, chin, cfg.kernel_size, cfg.stride,
                                                  tpad, False, g["last_freq"], norm,
                                                  index == 0, cfg, **branches))
            chin, chin_z = chout, chout_z
            chout, chout_z = int(cfg.growth * chout), int(cfg.growth * chout_z)
            if index == 0 and cfg.freq_emb:
                self.freq_emb = ScaledEmbedding(cfg.nfft // 2 // cfg.stride, chin_z,
                                                cfg.emb_scale)
        if not self.v3:
            self._build_bottleneck(cfg)
        # Inference builds no graph; training.make_train_step turns this on.
        self.requires_grad_(False)

    def _build_bottleneck(self, cfg: HTDemucsConfig) -> None:
        t_channels = cfg.channels * cfg.growth ** (cfg.depth - 1)
        if cfg.bottom_channels:
            self.channel_upsampler = nn.Conv1d(t_channels, cfg.bottom_channels, 1)
            self.channel_downsampler = nn.Conv1d(cfg.bottom_channels, t_channels, 1)
            self.channel_upsampler_t = nn.Conv1d(t_channels, cfg.bottom_channels, 1)
            self.channel_downsampler_t = nn.Conv1d(cfg.bottom_channels, t_channels, 1)
            t_channels = cfg.bottom_channels
        if cfg.t_layers > 0:
            self.crosstransformer = CrossTransformerEncoder(t_channels, cfg)

    def forward(self, mix: torch.Tensor) -> torch.Tensor:
        """Differentiable; the parameters are created with ``requires_grad``
        off, so an inference call builds no graph. The scope keeps this
        call's convolutions float32; a training step keeps its backward pass
        float32 with a scope of its own around ``backward()``."""
        with full_float32():
            return self._forward(mix)

    def _bottleneck(self, x: torch.Tensor, xt: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The cross-transformer between the two branches' deepest levels."""
        if not hasattr(self, "crosstransformer"):
            return x, xt
        cfg = self.cfg
        if cfg.bottom_channels:
            bb, _, ff, tt = x.shape
            x = self.channel_upsampler(x.reshape(bb, -1, ff * tt)).reshape(bb, -1, ff, tt)
            xt = self.channel_upsampler_t(xt)
        x, xt = self.crosstransformer(x, xt)
        if cfg.bottom_channels:
            x = self.channel_downsampler(x.reshape(bb, -1, ff * tt)).reshape(bb, -1, ff, tt)
            xt = self.channel_downsampler_t(xt)
        return x, xt

    def _forward(self, mix: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        mix = mix.float()
        length = mix.shape[-1]
        length_pre_pad = None
        if not self.v3 and cfg.use_train_segment and length < cfg.training_length:
            mix = F.pad(mix, (0, cfg.training_length - length))
            length_pre_pad = length
            length = cfg.training_length

        z = _model_spec(mix, cfg)  # (B, C, Fr, T) complex
        b, c, fr, t = z.shape
        if cfg.cac:
            x = torch.stack([z.real, z.imag], dim=2).reshape(b, c * 2, fr, t)
        else:
            x = z.abs()

        mean = x.mean(dim=(1, 2, 3), keepdim=True)
        std = x.std(dim=(1, 2, 3), keepdim=True)
        x = (x - mean) / (1e-5 + std)

        xt = mix
        meant = xt.mean(dim=(1, 2), keepdim=True)
        stdt = xt.std(dim=(1, 2), keepdim=True)
        xt = (xt - meant) / (1e-5 + stdt)

        saved, saved_t, lengths, lengths_t = [], [], [], []
        for idx, (g, encode) in enumerate(zip(self.geometry, self.encoder)):
            lengths.append(x.shape[-1])
            inject = None
            if idx < len(self.tencoder):
                lengths_t.append(xt.shape[-1])
                xt_out = self.tencoder[idx](xt)
                if g["last_freq"]:
                    inject = xt_out
                else:
                    xt = xt_out
                    saved_t.append(xt)
            x = encode(x, inject)
            if idx == 0 and hasattr(self, "freq_emb"):
                emb = self.freq_emb(x.shape[-2]).t()[None, :, :, None]
                x = x + cfg.freq_emb * emb
            saved.append(x)

        x, xt = self._bottleneck(x, xt)

        offset = cfg.depth - len(self.tdecoder)
        for idx, decode in enumerate(self.decoder):
            g = self.geometry[cfg.depth - 1 - idx]
            x, pre = decode(x, saved.pop(-1), lengths.pop(-1))
            if idx >= offset:
                tdecode = self.tdecoder[idx - offset]
                length_t = lengths_t.pop(-1)
                if g["last_freq"]:
                    xt, _ = tdecode(pre[:, :, 0], None, length_t)
                else:
                    xt, _ = tdecode(xt, saved_t.pop(-1), length_t)

        n_sources = len(cfg.sources)
        x = x.reshape(b, n_sources, -1, fr, t)
        x = x * std[:, None] + mean[:, None]
        xf = _model_ispec(self._head(x, z), length, cfg)

        xt = xt.reshape(b, n_sources, -1, length)
        xt = xt * stdt[:, None] + meant[:, None]
        result = xt + xf
        if length_pre_pad is not None:
            result = result[..., :length_pre_pad]
        return result

    def _head(self, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """The frequency branch's output ``(B, S, C', Fr, T)`` → the sources'
        complex spectrograms ``(B, S, C, Fr, T)``: complex as channels, or a
        magnitude head (``cac=False``) whose raw values (no ``abs``: a negative
        value flips the mixture's phase at that bin, as upstream) scale the
        mixture's phase (``wiener_iters < 0``) or seed the Wiener EM, run in
        300-frame windows so that its statistics and scaling match upstream;
        ``wiener_residual`` adds a residual source and drops it again."""
        cfg = self.cfg
        if cfg.cac:
            b, s, c2, fr, t = x.shape
            out = x.reshape(b, s, c2 // 2, 2, fr, t)
            return torch.complex(out[:, :, :, 0].contiguous(), out[:, :, :, 1].contiguous())
        if cfg.wiener_iters < 0:
            zm = z[:, None]
            return zm / (1e-8 + zm.abs()) * x
        window = 300
        outs = []
        for mags, mix_z in zip(x, z):
            tfcs = mags.permute(3, 2, 1, 0)  # (T, F, C, S)
            tfc = mix_z.permute(2, 1, 0)  # (T, F, C)
            y = torch.cat([wiener(tfcs[pos : pos + window], tfc[pos : pos + window],
                                  iterations=max(cfg.wiener_iters, 0),
                                  residual=cfg.wiener_residual)
                           for pos in range(0, tfcs.shape[0], window)], dim=0)
            if cfg.wiener_residual:
                y = y[..., :-1]
            outs.append(y.permute(3, 2, 1, 0))  # (S, C, F, T)
        return torch.stack(outs)


class HDemucs(HTDemucs):
    """Demucs v3 (``hdemucs_mmi``): ``mix (B, C, T)`` → ``(B, S, C, T)`` at the
    input's exact length. The levels past ``dconv_lstm`` / ``dconv_attn`` hold
    a BLSTM / LocalState in their DConvs; there is no transformer, and the
    decoder starts from zeros, so only the skips carry signal (JAX
    ``apply_hdemucs``)."""

    v3 = True

    def _bottleneck(self, x: torch.Tensor, xt: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return torch.zeros_like(x), xt


def build_demucs(cfg: HTDemucsConfig) -> HTDemucs:
    """The module a config describes: ``HDemucs`` for ``arch="hdemucs"``,
    else ``HTDemucs``."""
    return HDemucs(cfg) if cfg.arch == "hdemucs" else HTDemucs(cfg)
