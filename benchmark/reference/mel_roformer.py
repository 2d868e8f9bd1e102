"""Plain Mel-Band RoFormer forward in PyTorch, the benchmark's reference for
the Mel-Band configurations.

Follows lucidrains' ``mel_band_roformer.py`` (Wang et al., "Mel-Band
RoFormer for Music Source Separation", arXiv:2310.01809), which upstream
audio-separator vendors as ``uvr_lib_v5/roformer/mel_band_roformer.py``:
the STFT, the bins of each band gathered by index (bands overlap), the band
split, ``depth`` pairs of time and frequency transformers with rotary
positions, each transformer ending in its own RMSNorm (``norm_output``; no
final norm), one mask estimator a stem whose per-band MLP has
``mask_estimator_depth`` hidden tanh layers, the per-band masks summed back
onto the bins they came from (``scatter_add``) and divided by how many bands
cover each bin, the masked spectrum's inverse. Its ``state_dict()`` uses the
upstream key layout (``band_split.to_features.N.{0.gamma,1.weight,1.bias}``,
``layers.D.I.layers.L.{0,1}.*`` with each transformer's ``layers.D.I.norm.
gamma``, ``mask_estimators.S.to_freqs.N.0.{0,2,4}.*``).

The band membership is its own numpy copy of the Slaney mel filterbank
(``librosa.filters.mel``, htk off): bin ``f`` is in band ``i`` where the
``i``-th triangle is positive, with the first band's DC bin and the last
band's Nyquist bin forced on, as upstream does.

Departures from a bare transcription, each one about arithmetic, not the
model: dropout is left out (inference compares deterministic passes); the
inverse STFT drops the imaginary part of the DC and Nyquist bins first, which
is what a one-sided inverse transform means (``reference.roformer.
one_sided``); the per-band masks are summed and averaged as real and
imaginary parts, which is the complex sum and division done part by part;
the bins' index tables are made in the forward pass on the input's device
rather than kept as buffers. ``checkpoint=True`` recomputes each transformer
in the backward pass, which changes memory, not values.

Imports nothing of the program; shares the attention, feed-forward, norm,
rotary and one-sided pieces of ``reference/roformer.py``.
"""

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint as _checkpoint

from .roformer import Attention, FeedForward, Linear, RMSNorm, one_sided, rope_tables

# Slaney's mel scale (librosa's default): linear below 1 kHz, logarithmic above.
_F_SP = 200.0 / 3
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(hz):
    hz = np.asanyarray(hz, dtype=np.float64)
    log = _MIN_LOG_MEL + np.log(np.maximum(hz, _MIN_LOG_HZ) / _MIN_LOG_HZ) / _LOGSTEP
    return np.where(hz >= _MIN_LOG_HZ, log, hz / _F_SP)


def mel_to_hz(mel):
    mel = np.asanyarray(mel, dtype=np.float64)
    log = _MIN_LOG_HZ * np.exp(_LOGSTEP * (mel - _MIN_LOG_MEL))
    return np.where(mel >= _MIN_LOG_MEL, log, _F_SP * mel)


def band_membership(sample_rate: int, n_fft: int, num_bands: int) -> np.ndarray:
    """``(num_bands, n_fft // 2 + 1)`` booleans: the support of each of
    ``num_bands`` Slaney triangles over the rFFT bins. Triangle ``i`` rises
    from edge ``i`` to edge ``i + 1`` and falls to edge ``i + 2`` of
    ``num_bands + 2`` edges evenly spaced in mel from 0 Hz to Nyquist, so it
    is positive exactly on bins strictly between edges ``i`` and ``i + 2``.
    The DC bin of the first band and the Nyquist bin of the last are forced
    on."""
    bins = np.fft.rfftfreq(n_fft, 1.0 / sample_rate)
    edges = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(sample_rate / 2.0), num_bands + 2))
    member = (bins[None, :] > edges[:-2, None]) & (bins[None, :] < edges[2:, None])
    member[0, 0] = True
    member[-1, -1] = True
    if not member.any(axis=0).all():
        raise ValueError("every bin must lie in at least one band")
    return member


class Transformer(nn.Module):
    """``depth`` attention and feed-forward layers, then the output norm."""

    def __init__(self, dim, depth, heads, dim_head, mult):
        super().__init__()
        self.layers = nn.ModuleList(
            [nn.ModuleList([Attention(dim, heads, dim_head), FeedForward(dim, mult)])
             for _ in range(depth)])
        self.norm = RMSNorm(dim)

    def forward(self, x, rope):
        for attn, ff in self.layers:
            x = attn(x, rope) + x
            x = ff(x) + x
        return self.norm(x)


def mlp(dim_in, dim_out, hidden, depth):
    """``depth`` hidden linears with tanh after each, then the output linear
    (mel_band_roformer.py's MLP: ``depth + 1`` linears)."""
    dims = (dim_in, *([hidden] * depth), dim_out)
    layers = []
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        layers.append(Linear(a, b))
        if i < len(dims) - 2:
            layers.append(nn.Tanh())
    return nn.Sequential(*layers)


class MelBandRoformer(nn.Module):
    """``audio (B, S, T)`` → ``(B, stems, S, T)``."""

    def __init__(self, num_bands, sample_rate, dim, depth, heads, dim_head, stereo, num_stems,
                 time_transformer_depth, freq_transformer_depth, stft_n_fft, stft_hop_length,
                 stft_win_length, mask_estimator_depth, mlp_expansion_factor=4,
                 checkpoint=False):
        super().__init__()
        self.n_fft, self.hop, self.win_length = stft_n_fft, stft_hop_length, stft_win_length
        self.num_stems, self.dim_head = num_stems, dim_head
        self.checkpoint = checkpoint
        s = 2 if stereo else 1
        member = band_membership(sample_rate, stft_n_fft, num_bands)
        # The spectrum's rows are ``(f s)``; each band takes its bins' rows.
        self.band_rows = [int(f) * s + c for band in member for f in np.nonzero(band)[0]
                          for c in range(s)]
        self.bands_per_row = np.repeat(member.sum(axis=0), s).tolist()
        self.dims_in = [int(band.sum()) * s * 2 for band in member]
        self.band_split = nn.Module()
        self.band_split.to_features = nn.ModuleList(
            [nn.Sequential(RMSNorm(d), Linear(d, dim)) for d in self.dims_in])
        self.layers = nn.ModuleList(
            [nn.ModuleList([
                Transformer(dim, time_transformer_depth, heads, dim_head, mlp_expansion_factor),
                Transformer(dim, freq_transformer_depth, heads, dim_head, mlp_expansion_factor),
            ]) for _ in range(depth)])
        self.mask_estimators = nn.ModuleList()
        for _ in range(num_stems):
            est = nn.Module()
            est.to_freqs = nn.ModuleList(
                [nn.Sequential(mlp(dim, d * 2, dim * mlp_expansion_factor, mask_estimator_depth),
                               nn.GLU(dim=-1))
                 for d in self.dims_in])
            self.mask_estimators.append(est)

    def _run(self, module, x, rope):
        if self.checkpoint and torch.is_grad_enabled():
            return _checkpoint(module, x, rope, use_reentrant=False)
        return module(x, rope)

    def forward(self, audio):
        b, s, t = audio.shape
        dev = audio.device
        win = torch.hann_window(self.win_length, device=dev)
        spec = torch.stft(audio.reshape(b * s, t), n_fft=self.n_fft, hop_length=self.hop,
                          win_length=self.win_length, window=win, normalized=False,
                          center=True, return_complex=True)
        n_bins, tf = spec.shape[-2:]
        spec = torch.view_as_real(spec).reshape(b, s, n_bins, tf, 2)
        spec = spec.permute(0, 2, 1, 3, 4).reshape(b, n_bins * s, tf, 2)  # b (f s) t c
        rows = torch.tensor(self.band_rows, device=dev)
        x = spec[:, rows].permute(0, 2, 1, 3).reshape(b, tf, -1)  # b t (f c)

        x = torch.stack([net(part) for net, part in
                         zip(self.band_split.to_features, x.split(self.dims_in, dim=-1))],
                        dim=-2)  # (b, tf, nb, dim)
        nb, dim = x.shape[-2], x.shape[-1]
        t_rope = rope_tables(tf, self.dim_head, dev)
        f_rope = rope_tables(nb, self.dim_head, dev)
        for time_tr, freq_tr in self.layers:
            xt = x.permute(0, 2, 1, 3).reshape(b * nb, tf, dim)
            x = self._run(time_tr, xt, t_rope).reshape(b, nb, tf, dim).permute(0, 2, 1, 3)
            xf = self._run(freq_tr, x.reshape(b * tf, nb, dim), f_rope)
            x = xf.reshape(b, tf, nb, dim)

        masks = torch.stack([torch.cat([net(x[:, :, i]) for i, net in enumerate(est.to_freqs)],
                                       dim=-1)
                             for est in self.mask_estimators], dim=1)  # b n t (f c)
        ns = self.num_stems
        masks = masks.reshape(b, ns, tf, len(self.band_rows), 2).permute(0, 1, 3, 2, 4)
        summed = torch.zeros((b, ns, n_bins * s, tf, 2), device=dev, dtype=masks.dtype)
        summed = summed.index_add(2, rows, masks)
        denom = torch.tensor(self.bands_per_row, device=dev, dtype=masks.dtype)
        masks = summed / denom.clamp(min=1e-8)[:, None, None]
        spec_out = torch.view_as_complex(spec)[:, None] * torch.view_as_complex(masks)
        spec_out = spec_out.reshape(b, ns, n_bins, s, tf).permute(0, 1, 3, 2, 4)
        spec_out = one_sided(spec_out.reshape(-1, n_bins, tf))
        out = torch.istft(spec_out, n_fft=self.n_fft, hop_length=self.hop,
                          win_length=self.win_length, window=win, center=True)
        return out.reshape(b, ns, s, -1)


def from_config(cfg: dict, checkpoint=False) -> MelBandRoformer:
    """The module for a configuration file's ``model`` section."""
    m = cfg["model"]
    return MelBandRoformer(
        num_bands=m["num_bands"], sample_rate=m["sample_rate"], dim=m["dim"],
        depth=m["depth"], heads=m["heads"], dim_head=m["dim_head"], stereo=m["stereo"],
        num_stems=m["num_stems"], time_transformer_depth=m["time_transformer_depth"],
        freq_transformer_depth=m["freq_transformer_depth"], stft_n_fft=m["stft_n_fft"],
        stft_hop_length=m["stft_hop_length"], stft_win_length=m["stft_win_length"],
        mask_estimator_depth=m["mask_estimator_depth"],
        mlp_expansion_factor=m.get("mlp_expansion_factor", 4), checkpoint=checkpoint)
