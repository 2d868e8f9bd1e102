"""BS-RoFormer and Mel-Band RoFormer as a PyTorch module.

Port of ``audio_separator_tpu/models/roformer.py``. The module's parameters
keep the JAX parameter pytree's layout and names (``blocks.time.wqkv`` is
``(depth, inner_depth, d, 3·h·dh)``, per-run band-split and mask-estimator
weights, ...), so one converted checkpoint tree loads into either side
(``models/convert.load_jax_params``).

Every attention+feed-forward layer of the time and frequency transformers
runs through the two fused blocks of ``ops/attention_block.py``: CUDA kernels
for a CUDA module, their plain PyTorch versions for a CPU module, forward and
backward (``training.make_train_step`` trains the module). The token
axis is padded to a multiple of 64 once around each inner stack and the
kernels mask key columns past the real length. The linear-attention
pre-stage (``linear_transformer_depth > 0``) has no kernel in the JAX package
and stays plain PyTorch here too.

Tensor parallelism (``parallel/mesh.shard_roformer_params``): a sharded
module keeps the Megatron-split weights in ``tp_shards``, one
``ModuleDict`` tree a shard, each on its own device of a mesh row, under the
names of the leaves it splits (``tp_shards.1.blocks.time.wqkv``), and the
replicated leaves where they were. A sharded layer runs each shard's partial
form of the two blocks (``partial=True``: its heads, its hidden columns) on
the shard's device and adds the partial products, the residual and ``b2`` on
the input's device (:func:`_sum_partials`, the all-reduce). The replicated
gate weights and biases of the column-parallel products are sliced there per
shard. The mask estimator's hidden layers are column-parallel (their outputs
gathered before a next hidden layer) and its final value and gate products
row-parallel. Activations go to a shard's weights and come back with
``.to``, so autograd carries the gradients across devices.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention_block import fused_attention_block, fused_ff_block
from ..ops.stft import hann_window, istft, stft
from ..ops.tf32 import split_tf32
from .melbands import mel_band_membership

SEQ_GRANULARITY = 64  # the fused blocks' n_pad % 64 == 0 contract


@dataclass(frozen=True)
class RoformerConfig:
    kind: str  # "bs" | "mel"
    dim: int
    depth: int
    stereo: bool = False
    num_stems: int = 1
    time_transformer_depth: int = 2
    freq_transformer_depth: int = 2
    linear_transformer_depth: int = 0
    freqs_per_bands: Optional[Tuple[int, ...]] = None  # BS
    num_bands: Optional[int] = None  # Mel
    sample_rate: int = 44100
    dim_head: int = 64
    heads: int = 8
    stft_n_fft: int = 2048
    stft_hop_length: int = 512
    stft_win_length: int = 2048
    mask_estimator_depth: int = 2
    mlp_expansion_factor: int = 4
    match_input_audio_length: bool = False
    flash_attn: bool = True  # accepted for config parity

    @property
    def audio_channels(self) -> int:
        return 2 if self.stereo else 1

    @property
    def n_bins(self) -> int:
        return self.stft_n_fft // 2 + 1


@dataclass(frozen=True)
class BandLayout:
    """Static tables mapping packed spectrogram features (row-major ``(f s)``
    rows × (re, im)) to bands. Bands cover contiguous bin ranges; ``runs``
    groups consecutive equal-width bands as ``(band_start, band_end, width,
    dense)``, where ``dense`` runs tile their feature ranges contiguously."""

    n_bands: int
    n_feat: int
    starts: np.ndarray  # (n_bands,) first feature of each band
    denom: np.ndarray  # (n_feat,) how many bands cover each feature
    runs: tuple


@functools.lru_cache(maxsize=16)
def band_layout(cfg: RoformerConfig) -> BandLayout:
    s = cfg.audio_channels
    if cfg.kind == "bs":
        if cfg.freqs_per_bands is None:
            raise ValueError("BS-RoFormer requires freqs_per_bands")
        if sum(cfg.freqs_per_bands) != cfg.n_bins:
            raise ValueError(f"freqs_per_bands must sum to {cfg.n_bins}, "
                             f"got {sum(cfg.freqs_per_bands)}")
        band_bins, start = [], 0
        for nf in cfg.freqs_per_bands:
            band_bins.append(np.arange(start, start + nf))
            start += nf
    elif cfg.kind == "mel":
        if cfg.num_bands is None:
            raise ValueError("Mel-Band RoFormer requires num_bands")
        member, _, _, _ = mel_band_membership(cfg.sample_rate, cfg.stft_n_fft,
                                              cfg.num_bands)
        band_bins = [np.nonzero(member[i])[0] for i in range(cfg.num_bands)]
    else:
        raise ValueError(f"unknown roformer kind {cfg.kind}")

    n_bands = len(band_bins)
    n_feat = cfg.n_bins * s * 2
    dims = np.array([len(b) * s * 2 for b in band_bins], dtype=np.int32)
    starts = np.zeros(n_bands, dtype=np.int32)
    counts = np.zeros(n_feat, dtype=np.float32)
    for i, bins in enumerate(band_bins):
        bins = np.asarray(bins)
        if len(bins) > 1 and not (np.diff(bins) == 1).all():
            raise ValueError(f"band {i} bins are not contiguous")
        starts[i] = int(bins[0]) * s * 2
        counts[starts[i] : starts[i] + dims[i]] += 1.0
    runs, i = [], 0
    while i < n_bands:
        j = i
        while j + 1 < n_bands and dims[j + 1] == dims[i]:
            j += 1
        w = int(dims[i])
        dense = all(int(starts[k + 1]) == int(starts[k]) + w for k in range(i, j))
        runs.append((i, j + 1, w, dense))
        i = j + 1
    return BandLayout(n_bands, n_feat, starts, np.maximum(counts, 1e-8), tuple(runs))


# ---------------------------------------------------------------------------
# Functional blocks


def _rmsnorm(x: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """``F.normalize(x, dim=-1) · √d · γ``, in float32 internally."""
    x32 = x.float()
    norm = x32.norm(dim=-1, keepdim=True)
    out = x32 / norm.clamp_min(1e-12) * math.sqrt(x.shape[-1])
    return (out * gamma.float()).to(x.dtype)


def _rope_tables(n: int, dim_head: int, dtype=torch.float32, device=None):
    """rotary_embedding_torch convention: interleaved pairs, theta=10000."""
    inv = 1.0 / (10000.0 ** (np.arange(0, dim_head, 2, dtype=np.float64) / dim_head))
    ang = np.arange(n, dtype=np.float64)[:, None] * inv[None, :]
    cos = np.repeat(np.cos(ang), 2, axis=-1)
    sin = np.repeat(np.sin(ang), 2, axis=-1)
    return (torch.as_tensor(cos, dtype=dtype, device=device),
            torch.as_tensor(sin, dtype=dtype, device=device))


def _linear_attention(p: Dict[str, torch.Tensor], x: torch.Tensor,
                      heads: int) -> torch.Tensor:
    """XCiT-style cross-covariance attention: the (dh × dh) attention matrix
    contracts over tokens, q/k l2-normalised along tokens, a learned per-head
    temperature on q, softmax scale 8."""
    return _linear_attention_heads(_rmsnorm(x, p["attn_norm"]), p["wqkv"], p["temperature"],
                                   p["wo"], heads)


def _linear_attention_heads(xn: torch.Tensor, wqkv: torch.Tensor, temperature: torch.Tensor,
                            wo: torch.Tensor, heads: int) -> torch.Tensor:
    """The linear attention of ``heads`` heads from the normalised ``xn``:
    all of them, or one shard's (its q, k and v columns, temperatures and
    ``wo`` rows), whose projection is then a partial sum."""
    b, n, _ = xn.shape
    qkv = xn @ wqkv
    dh = qkv.shape[-1] // (3 * heads)
    qkv = qkv.reshape(b, n, 3, heads, dh).permute(2, 0, 3, 4, 1)
    q, k, v = qkv[0], qkv[1], qkv[2]  # (b, h, dh, n)

    def l2(t):
        t32 = t.float()
        return (t32 / t32.norm(dim=-1, keepdim=True).clamp_min(1e-12)).to(t.dtype)

    temp = temperature.float().exp().reshape(1, heads, 1, 1)
    q = (l2(q).float() * temp).to(xn.dtype)
    k = l2(k)
    sim = torch.einsum("bhdn,bhen->bhde", q.float(), k.float()) * 8.0
    attn = torch.softmax(sim, dim=-1).to(v.dtype)
    out = torch.einsum("bhde,bhen->bhdn", attn, v)
    out = out.permute(0, 3, 1, 2).reshape(b, n, heads * dh)
    return out @ wo


def _feedforward(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    xn = _rmsnorm(x, p["ff_norm"])
    h = F.gelu(xn @ p["ff_w1"] + p["ff_b1"])
    return h @ p["ff_w2"] + p["ff_b2"]


def _sum_partials(x: torch.Tensor, parts, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x + Σ parts (+ bias)`` on ``x``'s device, in float32, rounded once
    to ``x``'s type: the all-reduce of a row-parallel layer's partial
    products, fused with its residual and bias."""
    acc = x.float()
    for part in parts:
        acc = acc + part.to(x.device).float()
    if bias is not None:
        acc = acc + bias.to(x.device).float()
    return acc.to(x.dtype)


def _cols(t: torch.Tensor, s: int, tp: int, device) -> torch.Tensor:
    """Shard ``s`` of ``tp`` of a replicated leaf's last axis, on ``device``."""
    w = t.shape[-1] // tp
    return t[..., s * w : (s + 1) * w].contiguous().to(device)


def _attention_tp(x, stack, shards, j, rope, heads, n_valid, forms):
    """One tensor-parallel attention layer: each shard's partial block on its
    device, summed with the residual on ``x``'s."""
    tp = len(shards)
    parts = []
    for s, (sh, f) in enumerate(zip(shards, forms)):
        dev = sh["wqkv"].device
        parts.append(fused_attention_block(
            x.to(dev), sh["wqkv"][j], _cols(stack["gate_w"][j], s, tp, dev),
            _cols(stack["gate_b"][j], s, tp, dev), sh["wo"][j], stack["attn_norm"][j].to(dev),
            None if rope is None else (rope[0].to(dev), rope[1].to(dev)), heads // tp,
            n_valid=n_valid, tf32_weights=(f["wqkv"][j], f["wo"][j]) if f else None,
            partial=True))
    return _sum_partials(x, parts)


def _ff_tp(x, stack, shards, j, forms):
    tp = len(shards)
    parts = []
    for s, (sh, f) in enumerate(zip(shards, forms)):
        dev = sh["ff_w1"].device
        parts.append(fused_ff_block(
            x.to(dev), stack["ff_norm"][j].to(dev), sh["ff_w1"][j],
            _cols(stack["ff_b1"][j], s, tp, dev), sh["ff_w2"][j], None,
            tf32_weights=(f["ff_w1"][j], f["ff_w2"][j]) if f else None, partial=True))
    return _sum_partials(x, parts, stack["ff_b2"][j])


def _linear_layer_tp(layer, shard_layers, x, heads):
    """One tensor-parallel linear-attention layer and its feed-forward, in
    plain PyTorch (no kernel, as in the unsharded stack)."""
    tp = len(shard_layers)
    xn = _rmsnorm(x, layer["attn_norm"])
    parts = []
    for s, sh in enumerate(shard_layers):
        dev = sh["wqkv"].device
        parts.append(_linear_attention_heads(xn.to(dev), sh["wqkv"],
                                             _cols(layer["temperature"], s, tp, dev), sh["wo"],
                                             heads // tp))
    x = _sum_partials(x, parts)
    xn = _rmsnorm(x, layer["ff_norm"])
    parts = []
    for s, sh in enumerate(shard_layers):
        dev = sh["ff_w1"].device
        h = F.gelu(xn.to(dev) @ sh["ff_w1"] + _cols(layer["ff_b1"], s, tp, dev))
        parts.append(h @ sh["ff_w2"])
    return _sum_partials(x, parts, layer["ff_b2"])


def _transformer(stack: Dict[str, torch.Tensor], x: torch.Tensor, heads: int,
                 inner_depth: int,
                 rope: Optional[Tuple[torch.Tensor, torch.Tensor]],
                 linear: bool = False,
                 tf32: Optional[Dict[str, torch.Tensor]] = None,
                 shards: Optional[list] = None) -> torch.Tensor:
    """Inner transformer: ``inner_depth`` × (attention + feed-forward), then
    the optional output norm. ``stack`` tensors carry a leading
    ``(inner_depth, ...)`` axis; so do ``tf32``'s, the prepared 3xTF32 forms
    of ``wqkv``, ``wo``, ``ff_w1`` and ``ff_w2`` for a float32 stack on the card.
    ``shards``: a tensor-parallel stack's split weights, one dict a shard
    (``stack`` then holds the replicated leaves), and ``tf32`` one dict of
    forms (or None) a shard.

    Softmax layers run as the two fused blocks over tokens padded once to a
    multiple of 64 (``n_valid`` masks the padded key columns); the padding is
    sliced off after the stack."""
    if linear:
        for j in range(inner_depth):
            layer = {k: v[j] for k, v in stack.items() if k != "out_norm"}
            if shards is not None:
                x = _linear_layer_tp(layer, [{k: v[j] for k, v in sh.items()} for sh in shards],
                                     x, heads)
                continue
            x = x + _linear_attention(layer, x, heads)
            x = x + _feedforward(layer, x)
    else:
        n = x.shape[1]
        pad = (-n) % SEQ_GRANULARITY
        # A one-item batch whose token count is a multiple of 64 arrives as
        # a permuted view; the blocks take contiguous tensors.
        x = F.pad(x, (0, 0, 0, pad)) if pad else x.contiguous()
        if rope is not None and pad:
            rope = (F.pad(rope[0], (0, 0, 0, pad)), F.pad(rope[1], (0, 0, 0, pad)))
        for j in range(inner_depth):
            if shards is not None:
                forms = tf32 if tf32 is not None else [None] * len(shards)
                x = _attention_tp(x, stack, shards, j, rope, heads, n, forms)
                x = _ff_tp(x, stack, shards, j, forms)
                continue
            forms = {k: v[j] for k, v in tf32.items()} if tf32 is not None else None
            x = fused_attention_block(
                x, stack["wqkv"][j], stack["gate_w"][j], stack["gate_b"][j],
                stack["wo"][j], stack["attn_norm"][j], rope, heads, n_valid=n,
                tf32_weights=(forms["wqkv"], forms["wo"]) if forms else None)
            x = fused_ff_block(x, stack["ff_norm"][j], stack["ff_w1"][j],
                               stack["ff_b1"][j], stack["ff_w2"][j],
                               stack["ff_b2"][j],
                               tf32_weights=(forms["ff_w1"], forms["ff_w2"]) if forms else None)
        if pad:
            x = x[:, :n]
    if "out_norm" in stack:
        x = _rmsnorm(x, stack["out_norm"])
    return x


def tf32_stack_forms(stack, names) -> Dict[str, torch.Tensor]:
    """``{name: (depth, inner, 2, N, K)}``: for every layer of a stack, the
    prepared 3xTF32 form of its ``(K, N)`` weight ``name``, as
    ``ops/tf32.prepare_tf32_weight`` makes it."""
    forms = {}
    for name in names:
        hi, lo = split_tf32(stack[name].transpose(-1, -2).contiguous())
        forms[name] = torch.stack([hi, lo], dim=2)
    return forms


def _gather_run(feats: torch.Tensor, layout: BandLayout, run) -> torch.Tensor:
    """feats (B, T, n_feat) → (B, T, g, w) for one equal-width band run."""
    s0, e0, w, dense = run
    if dense:
        fs = int(layout.starts[s0])
        g = e0 - s0
        return feats[..., fs : fs + g * w].reshape(*feats.shape[:-1], g, w)
    return torch.stack(
        [feats[..., int(layout.starts[i]) : int(layout.starts[i]) + w]
         for i in range(s0, e0)], dim=-2)


def _band_split(p: nn.Module, feats: torch.Tensor, layout: BandLayout) -> torch.Tensor:
    """feats (B, T, n_feat) → (B, T, n_bands, dim): per band, RMSNorm over
    its real features then Linear(dim_in → dim), batched per run."""
    dt = feats.dtype
    outs = []
    for run, gp in zip(layout.runs, p.groups):
        w = run[2]
        xb32 = _gather_run(feats, layout, run).float()
        xn = xb32 / xb32.norm(dim=-1, keepdim=True).clamp_min(1e-12) * math.sqrt(w)
        xn = (xn * gp["gamma"].float()).to(dt)
        outs.append(torch.einsum("btni,nid->btnd", xn, gp["w"]))
    return torch.cat(outs, dim=-2) + p.b


def _mask_estimate_tp(p: nn.Module, shards: list, x: torch.Tensor, layout: BandLayout) -> list:
    """:func:`_mask_estimate` with the hidden layers column-parallel and the
    final value and gate products row-parallel (over the hidden width, or
    over ``dim`` when there is no hidden layer)."""
    tp = len(shards)
    h, hs = x[:, :, None], None
    for i, layer in enumerate(p.hidden):
        if hs is not None:  # a second hidden layer reads the whole width: gather
            h = torch.cat([t.to(x.device) for t in hs], dim=-1)
        hs = []
        for s, sh in enumerate(shards):
            w = sh["mask_est"]["hidden"][str(i)]["w"]
            hs.append(torch.tanh(torch.einsum("btsnd,sndh->btsnh", h.to(w.device), w)
                                 + _cols(layer["b"], s, tp, w.device)))
    if hs is None:
        hs = list(h.chunk(tp, dim=-1))
    outs = []
    for g, (run, gp) in enumerate(zip(layout.runs, p.groups)):
        s0, e0 = run[0], run[1]
        vals, gates = [], []
        for s, sh in enumerate(shards):
            sg = sh["mask_est"]["groups"][str(g)]
            hg = hs[s].to(sg["val_w"].device).float()[..., s0:e0, :]
            vals.append(torch.einsum("btsnd,sndo->btsno", hg, sg["val_w"].float()))
            gates.append(torch.einsum("btsnd,sndo->btsno", hg, sg["gate_w"].float()))
        val = _sum_partials(gp["val_b"].float(), vals)
        gate = _sum_partials(gp["gate_b"].float(), gates)
        outs.append(val * torch.sigmoid(gate))
    return outs


def _mask_estimate(p: nn.Module, x: torch.Tensor, layout: BandLayout) -> list:
    """x (B, T, nb, dim) → per-run band features [(B, T, ns, g, w) f32, ...]:
    tanh MLP layers batched over all bands, then the final GLU projection per
    equal-width run."""
    h = x[:, :, None]  # (B, T, 1, nb, dim)
    for layer in p.hidden:
        h = torch.tanh(torch.einsum("btsnd,sndh->btsnh", h, layer["w"]) + layer["b"])
    outs = []
    hf = h.float()
    for run, gp in zip(layout.runs, p.groups):
        s0, e0 = run[0], run[1]
        hg = hf[..., s0:e0, :]
        val = torch.einsum("btsnd,sndo->btsno", hg, gp["val_w"].float()) + gp["val_b"].float()
        gate = torch.einsum("btsnd,sndo->btsno", hg, gp["gate_w"].float()) + gp["gate_b"].float()
        outs.append(val * torch.sigmoid(gate))
    return outs


# ---------------------------------------------------------------------------
# Module


def _params(**shapes) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(torch.zeros(v), requires_grad=False)
                             for k, v in shapes.items()})


class Roformer(nn.Module):
    """``audio (B, channels, T)`` → stems ``(B, num_stems, channels, T_out)``
    (BSRoformer.forward / MelBandRoformer.forward semantics).

    Parameters are created zero-filled in the JAX pytree layout; load weights
    with ``models.convert.load_jax_params``. The module computes in the dtype
    of its parameters (``.to(torch.bfloat16)`` for bf16 compute); the STFT
    and the mask recombination stay in float32."""

    def __init__(self, cfg: RoformerConfig):
        super().__init__()
        self.cfg = cfg
        layout = band_layout(cfg)
        self.layout = layout
        nb, dim, h, dh = layout.n_bands, cfg.dim, cfg.heads, cfg.dim_head
        hidden = dim * cfg.mlp_expansion_factor

        def stack(inner: int, linear: bool) -> nn.ParameterDict:
            d = cfg.depth
            shapes = dict(attn_norm=(d, inner, dim), wqkv=(d, inner, dim, 3 * h * dh),
                          wo=(d, inner, h * dh, dim), ff_norm=(d, inner, dim),
                          ff_w1=(d, inner, dim, hidden), ff_b1=(d, inner, hidden),
                          ff_w2=(d, inner, hidden, dim), ff_b2=(d, inner, dim))
            if linear:
                shapes["temperature"] = (d, inner, h)
            else:
                shapes.update(gate_w=(d, inner, dim, h), gate_b=(d, inner, h))
            if cfg.kind == "mel":
                shapes["out_norm"] = (d, dim)
            return _params(**shapes)

        self.band_split = nn.Module()
        self.band_split.groups = nn.ModuleList(
            [_params(gamma=(e0 - s0, w), w=(e0 - s0, w, dim))
             for (s0, e0, w, _dense) in layout.runs])
        self.band_split.b = nn.Parameter(torch.zeros(nb, dim), requires_grad=False)

        blocks = {"time": stack(cfg.time_transformer_depth, False),
                  "freq": stack(cfg.freq_transformer_depth, False)}
        if cfg.linear_transformer_depth > 0:
            blocks["linear"] = stack(cfg.linear_transformer_depth, True)
        self.blocks = nn.ModuleDict(blocks)
        if cfg.kind == "bs":
            self.final_norm = _params(gamma=(dim,))

        ns = cfg.num_stems
        n_hidden = (cfg.mask_estimator_depth if cfg.kind == "mel"
                    else cfg.mask_estimator_depth - 1)
        self.mask_est = nn.Module()
        self.mask_est.hidden = nn.ModuleList(
            [_params(w=(ns, nb, dim if i == 0 else hidden, hidden), b=(ns, nb, hidden))
             for i in range(n_hidden)])
        final_in = dim if n_hidden == 0 else hidden
        self.mask_est.groups = nn.ModuleList(
            [_params(val_w=(ns, e0 - s0, final_in, w), val_b=(ns, e0 - s0, w),
                     gate_w=(ns, e0 - s0, final_in, w), gate_b=(ns, e0 - s0, w))
             for (s0, e0, w, _dense) in layout.runs])
        # Set by parallel/mesh.shard_roformer_params: the split weights, one
        # ModuleDict tree a shard (a ModuleList), and the mesh of their layout.
        self.tp_shards = None
        self.mesh = None

    TF32_WEIGHTS = ("wqkv", "wo", "ff_w1", "ff_w2")

    def tf32_forms(self):
        """The prepared 3xTF32 forms (``ops/tf32.prepare_tf32_weight``) of the
        softmax stacks' product weights, ``{branch: {name: (depth, inner, 2,
        N, K)}}``, for float32 parameters on the card (None otherwise); for a
        sharded module a list of them, one a shard, each on its shard's
        device. Made at first use and kept until a weight changes (in place or
        moved): 0.6 GB for the flagship's 24 layers."""
        if self.tp_shards is None:
            sets = [{br: self.blocks[br] for br in ("time", "freq")}]
        else:
            sets = [{br: sh["blocks"][br] for br in ("time", "freq")} for sh in self.tp_shards]
        first = sets[0]["time"]["wqkv"]
        if first.device.type != "cuda" or first.dtype != torch.float32:
            return None
        key = tuple((p.data_ptr(), p._version) for params in sets for st in params.values()
                    for name, p in st.items() if name in self.TF32_WEIGHTS)
        cached = getattr(self, "_tf32_cache", None)
        if cached is None or cached[0] != key:
            with torch.no_grad():  # the forms are no part of a training graph
                forms = [{br: tf32_stack_forms(st, self.TF32_WEIGHTS)
                          for br, st in params.items()} for params in sets]
            cached = (key, forms[0] if self.tp_shards is None else forms)
            self._tf32_cache = cached
        return cached[1]

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        """Differentiable: the parameters are created with ``requires_grad``
        off, so an inference call builds no graph (its callers also run it
        under ``torch.no_grad``); ``training.make_train_step`` turns them on."""
        cfg, layout = self.cfg, self.layout
        dt = self.band_split.b.dtype
        dev = audio.device
        b, s, t = audio.shape
        if s != cfg.audio_channels:
            raise ValueError(f"expected {cfg.audio_channels} channels, got {s}")
        n_fft, hop = cfg.stft_n_fft, cfg.stft_hop_length
        win = hann_window(cfg.stft_win_length, device=dev)
        if cfg.stft_win_length < n_fft:
            lp = (n_fft - cfg.stft_win_length) // 2
            win = F.pad(win, (lp, n_fft - cfg.stft_win_length - lp))

        spec = stft(audio.reshape(b * s, t), n_fft, hop, win)  # (b*s, F, Tf)
        n_bins, tf = spec.shape[-2], spec.shape[-1]
        rows = spec.reshape(b, s, n_bins, tf).permute(0, 2, 1, 3).reshape(b, n_bins * s, tf)
        feats = torch.view_as_real(rows)  # (b, rows, Tf, 2)
        feats = feats.permute(0, 2, 1, 3).reshape(b, tf, layout.n_feat)

        x = _band_split(self.band_split, feats.to(dt), layout)  # (b, Tf, nb, dim)

        time_rope = _rope_tables(tf, cfg.dim_head, dt, dev)
        freq_rope = _rope_tables(layout.n_bands, cfg.dim_head, dt, dev)
        nb, dim, heads = layout.n_bands, cfg.dim, cfg.heads
        forms = self.tf32_forms()
        sharded = self.tp_shards is not None

        def at_depth(blocks, d):
            return {br: {k: v[d] for k, v in params.items()} for br, params in blocks.items()}

        for d in range(cfg.depth):
            lp = at_depth(self.blocks, d)
            shards = {br: None for br in lp}
            tf32 = {"time": None, "freq": None}
            if sharded:
                per_shard = [at_depth(sh["blocks"], d) for sh in self.tp_shards]
                shards = {br: [ps[br] for ps in per_shard] for br in lp}
                if forms is not None:
                    tf32 = {br: [at_depth(f, d)[br] for f in forms] for br in tf32}
            elif forms is not None:
                tf32 = at_depth(forms, d)
            if "linear" in lp:
                flat = _transformer(lp["linear"], x.reshape(b, tf * nb, dim), heads,
                                    cfg.linear_transformer_depth, None, linear=True,
                                    shards=shards["linear"])
                x = flat.reshape(b, tf, nb, dim)
            # time attention: tokens = frames, bands folded into batch
            xt = x.permute(0, 2, 1, 3).reshape(b * nb, tf, dim)
            xt = _transformer(lp["time"], xt, heads, cfg.time_transformer_depth,
                              time_rope, tf32=tf32["time"], shards=shards["time"])
            x = xt.reshape(b, nb, tf, dim).permute(0, 2, 1, 3)
            # freq attention: tokens = bands, frames folded into batch
            xf = x.reshape(b * tf, nb, dim)
            xf = _transformer(lp["freq"], xf, heads, cfg.freq_transformer_depth,
                              freq_rope, tf32=tf32["freq"], shards=shards["freq"])
            x = xf.reshape(b, tf, nb, dim)

        if cfg.kind == "bs":
            x = _rmsnorm(x, self.final_norm["gamma"])

        banded_runs = (_mask_estimate_tp(self.mask_est, list(self.tp_shards), x, layout)
                       if sharded else _mask_estimate(self.mask_est, x, layout))

        # Band → feature recombination: BS bands are disjoint (dense runs are
        # reshaped concats); Mel bands overlap, sum and are averaged by counts.
        ns = cfg.num_stems
        acc = torch.zeros((b, tf, ns, layout.n_feat), dtype=torch.float32, device=dev)
        for run, o in zip(layout.runs, banded_runs):
            s0, e0, w, dense = run
            if dense:
                fs = int(layout.starts[s0])
                acc[..., fs : fs + (e0 - s0) * w] += o.reshape(b, tf, ns, (e0 - s0) * w)
            else:
                for j in range(e0 - s0):
                    st = int(layout.starts[s0 + j])
                    acc[..., st : st + w] += o[..., j, :]
        if cfg.kind == "mel":
            acc = acc / torch.as_tensor(layout.denom, device=dev)

        mask_feats = acc.permute(0, 2, 3, 1).reshape(b, ns, n_bins * s, 2, tf)
        mask = torch.complex(mask_feats[..., 0, :], mask_feats[..., 1, :])
        spec_out = rows[:, None] * mask  # (b, ns, rows, Tf)
        spec_out = spec_out.reshape(b, ns, n_bins, s, tf).permute(0, 1, 3, 2, 4)
        out_len = t if cfg.match_input_audio_length else None
        audio_out = istft(spec_out.reshape(b * ns * s, n_bins, tf), n_fft, hop, win,
                          length=out_len)
        return audio_out.reshape(b, ns, s, -1)
