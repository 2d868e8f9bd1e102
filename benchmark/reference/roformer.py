"""Plain BS-RoFormer forward in PyTorch, the benchmark's reference.

A frozen copy of the repository's test oracle for RoFormer numerics, made
device-aware: every tensor it creates lives on the input's device. Its
``state_dict()`` uses the key layout of the upstream checkpoints
(``band_split.to_features.N.{0.gamma,1.weight}``, ``layers.D.I.layers.L.
{0,1}.*``, ``mask_estimators.S.to_freqs.N.0.*``, ``final_norm.gamma``), so the
seeded checkpoint the benchmark writes is loaded both by the program, through
its own converter, and by this module, as it stands.

Departures from a bare transcription of lucidrains' ``bs_roformer.py``,
each one about arithmetic, not the model: dropout is left out (inference and
the fine-tune compare deterministic steps); the inverse STFT drops the
imaginary part of the DC and Nyquist bins first, which is what a one-sided
inverse transform means (numpy's ``irfft`` ignores them; cuFFT's C2R does not
for every plan). ``checkpoint=True`` recomputes each transformer in the
backward pass (``torch.utils.checkpoint``), which changes memory, not values.

Imports nothing of the program.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint as _checkpoint


# A function applied to both inputs of every matrix product, or None. The
# fine-tune's control sets it (``reference.train.float8_products``) to compute
# the products in fp8; a module attribute, so that a checkpointed layer's
# recomputation in the backward pass rounds as its forward did.
ROUND_PRODUCT_INPUTS = None


def _r(x):
    return x if ROUND_PRODUCT_INPUTS is None else ROUND_PRODUCT_INPUTS(x)


class Linear(nn.Linear):
    def forward(self, x):
        return F.linear(_r(x), _r(self.weight), self.bias)


class RMSNorm(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return F.normalize(x, dim=-1) * math.sqrt(x.shape[-1]) * self.gamma


def rope_tables(n, dim_head, device):
    """rotary_embedding_torch's convention: theta 10000, interleaved pairs."""
    inv = 1.0 / (10000.0 ** (torch.arange(0, dim_head, 2, dtype=torch.float64) / dim_head))
    ang = torch.arange(n, dtype=torch.float64)[:, None] * inv[None, :]
    cos = ang.cos().repeat_interleave(2, dim=-1).float().to(device)
    sin = ang.sin().repeat_interleave(2, dim=-1).float().to(device)
    return cos, sin


def rope_rotate(x, cos, sin):
    x2 = x.reshape(*x.shape[:-1], x.shape[-1] // 2, 2)
    rot = torch.stack([-x2[..., 1], x2[..., 0]], dim=-1).reshape(x.shape)
    return x * cos + rot * sin


class Attention(nn.Module):
    def __init__(self, dim, heads, dim_head):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.norm = RMSNorm(dim)
        self.to_qkv = Linear(dim, inner * 3, bias=False)
        self.to_gates = Linear(dim, heads)
        self.to_out = nn.Sequential(Linear(inner, dim, bias=False))

    def forward(self, x, rope):
        b, n, _ = x.shape
        h, dh = self.heads, self.dim_head
        xn = self.norm(x)
        qkv = self.to_qkv(xn).reshape(b, n, 3, h, dh).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        cos, sin = rope
        q, k = rope_rotate(q, cos, sin), rope_rotate(k, cos, sin)
        attn = torch.softmax(_r(q) @ _r(k).transpose(-1, -2) * dh ** -0.5, dim=-1)
        out = _r(attn) @ _r(v)
        out = out * torch.sigmoid(self.to_gates(xn)).permute(0, 2, 1)[..., None]
        return self.to_out(out.permute(0, 2, 1, 3).reshape(b, n, h * dh))


class FeedForward(nn.Module):
    def __init__(self, dim, mult=4):
        super().__init__()
        inner = dim * mult
        # Indices 3 and 5 are upstream's dropouts; the keys keep their numbers.
        self.net = nn.Sequential(RMSNorm(dim), Linear(dim, inner), nn.GELU(),
                                 nn.Identity(), Linear(inner, dim))

    def forward(self, x):
        return self.net(x)


class Transformer(nn.Module):
    def __init__(self, dim, depth, heads, dim_head, mult):
        super().__init__()
        self.layers = nn.ModuleList(
            [nn.ModuleList([Attention(dim, heads, dim_head), FeedForward(dim, mult)])
             for _ in range(depth)])

    def forward(self, x, rope):
        for attn, ff in self.layers:
            x = attn(x, rope) + x
            x = ff(x) + x
        return x


def mlp(dim_in, dim_out, hidden, depth):
    """``depth`` linears with tanh between them (bs_roformer.py's MLP)."""
    layers, dims = [], (dim_in, *([hidden] * (depth - 1)), dim_out)
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        layers.append(Linear(a, b))
        if i < len(dims) - 2:
            layers.append(nn.Tanh())
    return nn.Sequential(*layers)


class BSRoformer(nn.Module):
    """``audio (B, S, T)`` → ``(B, stems, S, T)``: STFT, band split, ``depth``
    pairs of time and frequency transformers with rotary positions, the
    final norm, one mask estimator a stem, the masked spectrum's inverse."""

    def __init__(self, freqs_per_bands, dim, depth, heads, dim_head, stereo, num_stems,
                 time_transformer_depth, freq_transformer_depth, stft_n_fft,
                 stft_hop_length, mask_estimator_depth, mlp_expansion_factor=4,
                 checkpoint=False):
        super().__init__()
        self.n_fft, self.hop = stft_n_fft, stft_hop_length
        self.num_stems, self.dim_head = num_stems, dim_head
        self.checkpoint = checkpoint
        s = 2 if stereo else 1
        self.s = s
        bins, start = [], 0
        for nf in freqs_per_bands:
            bins.append(list(range(start, start + nf)))
            start += nf
        self.band_bins = bins
        dims_in = [len(b) * s * 2 for b in bins]
        self.band_split = nn.Module()
        self.band_split.to_features = nn.ModuleList(
            [nn.Sequential(RMSNorm(d), Linear(d, dim)) for d in dims_in])
        self.layers = nn.ModuleList(
            [nn.ModuleList([
                Transformer(dim, time_transformer_depth, heads, dim_head, mlp_expansion_factor),
                Transformer(dim, freq_transformer_depth, heads, dim_head, mlp_expansion_factor),
            ]) for _ in range(depth)])
        self.final_norm = RMSNorm(dim)
        self.mask_estimators = nn.ModuleList()
        for _ in range(num_stems):
            est = nn.Module()
            est.to_freqs = nn.ModuleList(
                [nn.Sequential(mlp(dim, d * 2, dim * mlp_expansion_factor,
                                   mask_estimator_depth), nn.GLU(dim=-1))
                 for d in dims_in])
            self.mask_estimators.append(est)

    def _band_index(self, bins, device):
        s = self.s
        return torch.tensor([(f * s + c) * 2 + ri for f in bins for c in range(s)
                             for ri in range(2)], device=device)

    def _run(self, module, x, rope):
        if self.checkpoint and torch.is_grad_enabled():
            return _checkpoint(module, x, rope, use_reentrant=False)
        return module(x, rope)

    def forward(self, audio):
        b, s, t = audio.shape
        dev = audio.device
        win = torch.hann_window(self.n_fft, device=dev)
        spec = torch.stft(audio.reshape(b * s, t), n_fft=self.n_fft, hop_length=self.hop,
                          window=win, center=True, return_complex=True)
        n_bins, tf = spec.shape[-2:]
        rows = spec.reshape(b, s, n_bins, tf).permute(0, 2, 1, 3).reshape(b, n_bins * s, tf)
        x = torch.view_as_real(rows).permute(0, 2, 1, 3).reshape(b, tf, n_bins * s * 2)

        x = torch.stack([net(x[..., self._band_index(bins, dev)])
                         for bins, net in zip(self.band_bins, self.band_split.to_features)],
                        dim=-2)  # (b, tf, nb, dim)
        nb, dim = x.shape[-2], x.shape[-1]
        t_rope = rope_tables(tf, self.dim_head, dev)
        f_rope = rope_tables(nb, self.dim_head, dev)
        for time_tr, freq_tr in self.layers:
            xt = x.permute(0, 2, 1, 3).reshape(b * nb, tf, dim)
            x = self._run(time_tr, xt, t_rope).reshape(b, nb, tf, dim).permute(0, 2, 1, 3)
            xf = self._run(freq_tr, x.reshape(b * tf, nb, dim), f_rope)
            x = xf.reshape(b, tf, nb, dim)
        x = self.final_norm(x)

        n_feat = n_bins * s * 2
        masks = []
        for est in self.mask_estimators:
            acc = torch.zeros(b, tf, n_feat, device=dev, dtype=x.dtype)
            for bi, (bins, net) in enumerate(zip(self.band_bins, est.to_freqs)):
                acc = acc.index_add(-1, self._band_index(bins, dev), net(x[:, :, bi]))
            masks.append(acc)
        mask = torch.stack(masks, dim=1)  # (b, stems, tf, n_feat)
        mask = mask.permute(0, 1, 3, 2).reshape(b, self.num_stems, n_bins * s, 2, tf)
        mask = torch.complex(mask[..., 0, :], mask[..., 1, :])
        spec_out = rows[:, None] * mask
        spec_out = spec_out.reshape(b, self.num_stems, n_bins, s, tf).permute(0, 1, 3, 2, 4)
        spec_out = spec_out.reshape(-1, n_bins, tf)
        spec_out = one_sided(spec_out)
        out = torch.istft(spec_out, n_fft=self.n_fft, hop_length=self.hop, window=win,
                          center=True)
        return out.reshape(b, self.num_stems, s, -1)


def one_sided(spec):
    """A one-sided spectrum as a real signal has it: the imaginary parts of
    the DC bin and, for an even transform, the Nyquist bin set to zero."""
    real, imag = spec.real, spec.imag.clone()
    imag[..., 0, :] = 0
    imag[..., -1, :] = 0
    return torch.complex(real, imag)


def from_config(cfg: dict, checkpoint=False) -> BSRoformer:
    """The module for a configuration file's ``model`` section."""
    m = cfg["model"]
    return BSRoformer(
        freqs_per_bands=m["freqs_per_bands"], dim=m["dim"], depth=m["depth"],
        heads=m["heads"], dim_head=m["dim_head"], stereo=m["stereo"],
        num_stems=m["num_stems"], time_transformer_depth=m["time_transformer_depth"],
        freq_transformer_depth=m["freq_transformer_depth"], stft_n_fft=m["stft_n_fft"],
        stft_hop_length=m["stft_hop_length"], mask_estimator_depth=m["mask_estimator_depth"],
        mlp_expansion_factor=m.get("mlp_expansion_factor", 4), checkpoint=checkpoint)
