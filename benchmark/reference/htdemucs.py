"""Plain HTDemucs (Demucs v4) forward in PyTorch, the benchmark's reference.

Written from facebookresearch/demucs ``htdemucs.py``, ``hdemucs.py`` and
``transformer.py`` for the configurations the benchmark runs, starting from a
frozen copy of the repository's test oracle: the same parameter names as an
upstream package's state dict, so the benchmark's seeded package loads here
as it stands. What the published ``htdemucs`` (955717e8) needs beyond the
oracle: DConv branches in the encoders only (``dconv_mode`` 1), the decoders'
rewrite over ``1 + 2·context`` taps, no GroupNorm below ``norm_starts``, and
the 1×1 ``channel_upsampler`` / ``channel_downsampler`` pairs around a
``bottom_channels``-wide cross-transformer.

Departures, each about arithmetic only: multi-head attention is written out
as products and a softmax (``nn.MultiheadAttention``'s parameters, none of its
fused paths); the inverse STFT drops the imaginary part of the DC and Nyquist
bins first (a one-sided inverse transform; cuFFT's C2R does not ignore them
for every plan). Imports nothing of the program.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from .roformer import one_sided


def pad1d(x, paddings, mode="constant", value=0.0):
    length = x.shape[-1]
    pl, pr = paddings
    if mode == "reflect":
        max_pad = max(pl, pr)
        if length <= max_pad:
            extra = max_pad - length + 1
            epr = min(pr, extra)
            epl = extra - epr
            x = F.pad(x, (epl, epr))
            pl, pr = pl - epl, pr - epr
    return F.pad(x, (pl, pr), mode, value)


def spectro(x, n_fft, hop):
    *other, length = x.shape
    x = x.reshape(-1, length)
    z = torch.stft(x, n_fft, hop, window=torch.hann_window(n_fft, device=x.device),
                   win_length=n_fft, normalized=True, center=True, return_complex=True,
                   pad_mode="reflect")
    return z.view(*other, z.shape[-2], z.shape[-1])


def ispectro(z, hop, length=None):
    *other, freqs, frames = z.shape
    n_fft = 2 * freqs - 2
    z = one_sided(z.reshape(-1, freqs, frames))
    x = torch.istft(z, n_fft, hop, window=torch.hann_window(n_fft, device=z.device),
                    win_length=n_fft, normalized=True, length=length, center=True)
    return x.view(*other, x.shape[-1])


class LayerScale(nn.Module):
    def __init__(self, channels, channel_last=False):
        super().__init__()
        self.channel_last = channel_last
        self.scale = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return self.scale * x if self.channel_last else self.scale[:, None] * x


class DConv(nn.Module):
    def __init__(self, channels, compress, depth):
        super().__init__()
        hidden = int(channels / compress)
        self.layers = nn.ModuleList()
        for d in range(depth):
            dilation = 2 ** d
            self.layers.append(nn.Sequential(
                nn.Conv1d(channels, hidden, 3, dilation=dilation, padding=dilation),
                nn.GroupNorm(1, hidden), nn.GELU(),
                nn.Conv1d(hidden, 2 * channels, 1), nn.GroupNorm(1, 2 * channels),
                nn.GLU(1), LayerScale(channels)))

    def forward(self, x):
        for layer in self.layers:
            x = x + layer(x)
        return x


def _over_time(dconv, y):
    if y.dim() == 3:
        return dconv(y)
    b, c, fr, t = y.shape
    y = dconv(y.permute(0, 2, 1, 3).reshape(-1, c, t))
    return y.view(b, fr, c, t).permute(0, 2, 1, 3)


class HEncLayer(nn.Module):
    def __init__(self, chin, chout, kernel_size, stride, freq, dconv, context, norm_groups,
                 norm, dconv_kw, empty=False):
        super().__init__()
        pad = kernel_size // 4
        klass = nn.Conv1d
        self.freq, self.stride, self.empty = freq, stride, empty
        if freq:
            kernel_size, stride, pad = [kernel_size, 1], [stride, 1], [pad, 0]
            klass = nn.Conv2d
        self.conv = klass(chin, chout, kernel_size, stride, pad)
        if empty:
            return
        self.norm1 = nn.GroupNorm(norm_groups, chout) if norm else nn.Identity()
        self.rewrite = klass(chout, 2 * chout, 1 + 2 * context, 1, context)
        self.norm2 = nn.GroupNorm(norm_groups, 2 * chout) if norm else nn.Identity()
        self.dconv = DConv(chout, **dconv_kw) if dconv else None

    def forward(self, x, inject=None):
        if not self.freq and x.dim() == 4:
            x = x.reshape(x.shape[0], -1, x.shape[-1])
        if not self.freq:
            le = x.shape[-1]
            if le % self.stride != 0:
                x = F.pad(x, (0, self.stride - (le % self.stride)))
        y = self.conv(x)
        if self.empty:
            return y
        if inject is not None:
            if inject.dim() == 3 and y.dim() == 4:
                inject = inject[:, :, None]
            y = y + inject
        y = F.gelu(self.norm1(y))
        if self.dconv is not None:
            y = _over_time(self.dconv, y)
        return F.glu(self.norm2(self.rewrite(y)), dim=1)


class HDecLayer(nn.Module):
    def __init__(self, chin, chout, kernel_size, stride, freq, dconv, context, norm_groups,
                 norm, dconv_kw, last=False, empty=False):
        super().__init__()
        self.pad = kernel_size // 4
        self.last, self.freq, self.chin, self.empty = last, freq, chin, empty
        klass, klass_tr = nn.Conv1d, nn.ConvTranspose1d
        if freq:
            kernel_size, stride = [kernel_size, 1], [stride, 1]
            klass, klass_tr = nn.Conv2d, nn.ConvTranspose2d
        self.conv_tr = klass_tr(chin, chout, kernel_size, stride)
        self.norm2 = nn.GroupNorm(norm_groups, chout) if norm else nn.Identity()
        if empty:
            return
        self.rewrite = klass(chin, 2 * chin, 1 + 2 * context, 1, context)
        self.norm1 = nn.GroupNorm(norm_groups, 2 * chin) if norm else nn.Identity()
        self.dconv = DConv(chin, **dconv_kw) if dconv else None

    def forward(self, x, skip, length):
        if self.freq and x.dim() == 3:
            b, _, t = x.shape
            x = x.view(b, self.chin, -1, t)
        if self.empty:
            y = x
        else:
            y = F.glu(self.norm1(self.rewrite(x + skip)), dim=1)
            if self.dconv is not None:
                y = _over_time(self.dconv, y)
        z = self.norm2(self.conv_tr(y))
        if self.freq:
            z = z[..., self.pad : -self.pad, :]
        else:
            z = z[..., self.pad : self.pad + length]
        if not self.last:
            z = F.gelu(z)
        return z, y


def create_sin_embedding(length, dim, device, max_period=10000):
    pos = torch.arange(length, device=device).view(-1, 1, 1)
    half = dim // 2
    adim = torch.arange(half, device=device).view(1, 1, -1)
    phase = pos / (max_period ** (adim / (half - 1)))
    return torch.cat([torch.cos(phase), torch.sin(phase)], dim=-1)


def create_2d_sin_embedding(d_model, height, width, device, max_period=10000):
    pe = torch.zeros(d_model, height, width, device=device)
    d_model = int(d_model / 2)
    div_term = torch.exp(torch.arange(0.0, d_model, 2, device=device)
                         * -(math.log(max_period) / d_model))
    pos_w = torch.arange(0.0, width, device=device).unsqueeze(1)
    pos_h = torch.arange(0.0, height, device=device).unsqueeze(1)
    pe[0:d_model:2] = torch.sin(pos_w * div_term).transpose(0, 1).unsqueeze(1).repeat(1, height, 1)
    pe[1:d_model:2] = torch.cos(pos_w * div_term).transpose(0, 1).unsqueeze(1).repeat(1, height, 1)
    pe[d_model::2] = torch.sin(pos_h * div_term).transpose(0, 1).unsqueeze(2).repeat(1, 1, width)
    pe[d_model + 1 :: 2] = torch.cos(pos_h * div_term).transpose(0, 1).unsqueeze(2).repeat(1, 1, width)
    return pe[None]


class MyGroupNorm(nn.GroupNorm):
    def forward(self, x):
        return super().forward(x.transpose(1, 2)).transpose(1, 2)


class MultiheadAttention(nn.Module):
    """``nn.MultiheadAttention``'s parameters (batch first), computed as
    products and a softmax."""

    def __init__(self, d_model, nhead):
        super().__init__()
        self.nhead = nhead
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, q, k, v):
        b, nq, d = q.shape
        h = self.nhead
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        q = F.linear(q, wq, bq).view(b, nq, h, d // h).transpose(1, 2)
        k = F.linear(k, wk, bk).view(b, -1, h, d // h).transpose(1, 2)
        v = F.linear(v, wv, bv).view(b, -1, h, d // h).transpose(1, 2)
        attn = torch.softmax(q @ k.transpose(-1, -2) * (d // h) ** -0.5, dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(b, nq, d)
        return self.out_proj(out)


class SelfLayer(nn.Module):
    def __init__(self, d_model, nhead, hidden):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, nhead)
        self.linear1 = nn.Linear(d_model, hidden)
        self.linear2 = nn.Linear(hidden, d_model)
        self.norm1 = nn.LayerNorm(d_model)
        self.norm2 = nn.LayerNorm(d_model)
        self.norm_out = MyGroupNorm(num_groups=1, num_channels=d_model)
        self.gamma_1 = LayerScale(d_model, True)
        self.gamma_2 = LayerScale(d_model, True)

    def forward(self, x):
        h = self.norm1(x)
        x = x + self.gamma_1(self.self_attn(h, h, h))
        x = x + self.gamma_2(self.linear2(F.gelu(self.linear1(self.norm2(x)))))
        return self.norm_out(x)


class CrossLayer(nn.Module):
    def __init__(self, d_model, nhead, hidden):
        super().__init__()
        self.cross_attn = MultiheadAttention(d_model, nhead)
        self.linear1 = nn.Linear(d_model, hidden)
        self.linear2 = nn.Linear(hidden, d_model)
        self.norm1 = nn.LayerNorm(d_model)
        self.norm2 = nn.LayerNorm(d_model)
        self.norm3 = nn.LayerNorm(d_model)
        self.norm_out = MyGroupNorm(num_groups=1, num_channels=d_model)
        self.gamma_1 = LayerScale(d_model, True)
        self.gamma_2 = LayerScale(d_model, True)

    def forward(self, q, k):
        kn = self.norm2(k)
        x = q + self.gamma_1(self.cross_attn(self.norm1(q), kn, kn))
        x = x + self.gamma_2(self.linear2(F.gelu(self.linear1(self.norm3(x)))))
        return self.norm_out(x)


class CrossTransformer(nn.Module):
    """Alternating self and cross layers over the two branches, the first a
    self layer (``t_cross_first`` False)."""

    def __init__(self, dim, heads, num_layers, hidden_scale):
        super().__init__()
        self.num_layers = num_layers
        hidden = int(dim * hidden_scale)
        self.norm_in = nn.LayerNorm(dim)
        self.norm_in_t = nn.LayerNorm(dim)
        self.layers = nn.ModuleList()
        self.layers_t = nn.ModuleList()
        for idx in range(num_layers):
            kind = SelfLayer if idx % 2 == 0 else CrossLayer
            self.layers.append(kind(dim, heads, hidden))
            self.layers_t.append(kind(dim, heads, hidden))

    def forward(self, x, xt):
        b, c, fr, t1 = x.shape
        pos2d = create_2d_sin_embedding(c, fr, t1, x.device)
        pos2d = pos2d.permute(0, 3, 2, 1).reshape(1, t1 * fr, c)
        x = self.norm_in(x.permute(0, 3, 2, 1).reshape(b, t1 * fr, c)) + pos2d
        _, c, t2 = xt.shape
        pos1d = create_sin_embedding(t2, c, xt.device).permute(1, 0, 2)
        xt = self.norm_in_t(xt.permute(0, 2, 1)) + pos1d
        for idx in range(self.num_layers):
            if idx % 2 == 0:
                x = self.layers[idx](x)
                xt = self.layers_t[idx](xt)
            else:
                old_x = x
                x = self.layers[idx](x, xt)
                xt = self.layers_t[idx](xt, old_x)
        x = x.reshape(b, t1, fr, c).permute(0, 3, 2, 1)
        return x, xt.permute(0, 2, 1)


class ScaledEmbedding(nn.Module):
    def __init__(self, num_embeddings, embedding_dim, scale):
        super().__init__()
        self.embedding = nn.Embedding(num_embeddings, embedding_dim)
        self.scale = scale

    def forward(self, x):
        return self.embedding(x) * self.scale


class HTDemucs(nn.Module):
    """``mix (B, 2, T)`` → ``(B, sources, 2, T)`` for the constructor
    arguments of an upstream package (``kwargs``)."""

    def __init__(self, sources, audio_channels=2, channels=48, growth=2, nfft=4096,
                 depth=4, kernel_size=8, stride=4, context=1, context_enc=0, norm_starts=4,
                 norm_groups=4, dconv_mode=1, dconv_depth=2, dconv_comp=8, freq_emb=0.2,
                 emb_scale=10, bottom_channels=0, t_layers=5, t_heads=8, t_hidden_scale=4.0,
                 samplerate=44100, segment=10, **_unused):
        super().__init__()
        self.sources, self.nfft, self.depth = list(sources), nfft, depth
        self.hop_length = nfft // 4
        self.samplerate, self.segment = samplerate, segment
        self.bottom_channels = bottom_channels
        dconv_kw = {"compress": dconv_comp, "depth": dconv_depth}
        self.encoder, self.decoder = nn.ModuleList(), nn.ModuleList()
        self.tencoder, self.tdecoder = nn.ModuleList(), nn.ModuleList()
        chin, chin_z = audio_channels, audio_channels * 2  # complex as channels
        chout = chout_z = channels
        freqs = nfft // 2
        for index in range(depth):
            norm = index >= norm_starts
            freq = freqs > 1
            if freq and freqs <= kernel_size:
                raise NotImplementedError("a last frequency layer (freqs <= kernel_size)")
            common = dict(norm_groups=norm_groups, norm=norm, dconv_kw=dconv_kw)
            self.encoder.append(HEncLayer(chin_z, chout_z, kernel_size, stride, freq,
                                          bool(dconv_mode & 1), context_enc, **common))
            self.tencoder.append(HEncLayer(chin, chout, kernel_size, stride, False,
                                           bool(dconv_mode & 1), context_enc, **common))
            if index == 0:
                chin = audio_channels * len(sources)
                chin_z = chin * 2
            self.decoder.insert(0, HDecLayer(chout_z, chin_z, kernel_size, stride, freq,
                                             bool(dconv_mode & 2), context,
                                             last=index == 0, **common))
            self.tdecoder.insert(0, HDecLayer(chout, chin, kernel_size, stride, False,
                                              bool(dconv_mode & 2), context,
                                              last=index == 0, **common))
            chin, chin_z = chout, chout_z
            chout, chout_z = int(growth * chout), int(growth * chout_z)
            freqs //= stride
            if index == 0 and freq_emb:
                self.freq_emb = ScaledEmbedding(freqs, chin_z, emb_scale)
                self.freq_emb_scale = freq_emb
        t_channels = channels * growth ** (depth - 1)
        if bottom_channels:
            self.channel_upsampler = nn.Conv1d(t_channels, bottom_channels, 1)
            self.channel_downsampler = nn.Conv1d(bottom_channels, t_channels, 1)
            self.channel_upsampler_t = nn.Conv1d(t_channels, bottom_channels, 1)
            self.channel_downsampler_t = nn.Conv1d(bottom_channels, t_channels, 1)
            t_channels = bottom_channels
        self.crosstransformer = CrossTransformer(t_channels, t_heads, t_layers, t_hidden_scale)

    @property
    def training_length(self):
        return int(self.segment * self.samplerate)

    def _spec(self, x):
        hl = self.hop_length
        le = int(math.ceil(x.shape[-1] / hl))
        pad = hl // 2 * 3
        x = pad1d(x, (pad, pad + le * hl - x.shape[-1]), mode="reflect")
        z = spectro(x, self.nfft, hl)[..., :-1, :]
        return z[..., 2 : 2 + le]

    def _ispec(self, z, length):
        hl = self.hop_length
        z = F.pad(z, (0, 0, 0, 1))
        z = F.pad(z, (2, 2))
        pad = hl // 2 * 3
        le = hl * int(math.ceil(length / hl)) + 2 * pad
        x = ispectro(z, hl, length=le)
        return x[..., pad : pad + length]

    def forward(self, mix):
        length = mix.shape[-1]
        if length < self.training_length:
            mix = F.pad(mix, (0, self.training_length - length))
        z = self._spec(mix)
        b, c, fq, t = z.shape
        x = torch.view_as_real(z).permute(0, 1, 4, 2, 3).reshape(b, c * 2, fq, t)
        mean = x.mean(dim=(1, 2, 3), keepdim=True)
        std = x.std(dim=(1, 2, 3), keepdim=True)
        x = (x - mean) / (1e-5 + std)
        xt = mix
        meant = xt.mean(dim=(1, 2), keepdim=True)
        stdt = xt.std(dim=(1, 2), keepdim=True)
        xt = (xt - meant) / (1e-5 + stdt)

        saved, saved_t, lengths, lengths_t = [], [], [], []
        for idx, encode in enumerate(self.encoder):
            lengths.append(x.shape[-1])
            lengths_t.append(xt.shape[-1])
            xt = self.tencoder[idx](xt)
            saved_t.append(xt)
            x = encode(x)
            if idx == 0 and hasattr(self, "freq_emb"):
                frs = torch.arange(x.shape[-2], device=x.device)
                emb = self.freq_emb(frs).t()[None, :, :, None].expand_as(x)
                x = x + self.freq_emb_scale * emb
            saved.append(x)

        if self.bottom_channels:
            bb, _, ff, tt = x.shape
            x = self.channel_upsampler(x.reshape(bb, -1, ff * tt)).reshape(bb, -1, ff, tt)
            xt = self.channel_upsampler_t(xt)
        x, xt = self.crosstransformer(x, xt)
        if self.bottom_channels:
            x = self.channel_downsampler(x.reshape(bb, -1, ff * tt)).reshape(bb, -1, ff, tt)
            xt = self.channel_downsampler_t(xt)

        for idx, decode in enumerate(self.decoder):
            x, _ = decode(x, saved.pop(-1), lengths.pop(-1))
            xt, _ = self.tdecoder[idx](xt, saved_t.pop(-1), lengths_t.pop(-1))

        s = len(self.sources)
        x = x.view(b, s, -1, fq, t) * std[:, None] + mean[:, None]
        out = x.view(b, s, -1, 2, fq, t).permute(0, 1, 2, 4, 5, 3)
        xf = self._ispec(torch.view_as_complex(out.contiguous()), mix.shape[-1])
        xt = xt.view(b, s, -1, mix.shape[-1]) * stdt[:, None] + meant[:, None]
        return (xt + xf)[..., :length]
