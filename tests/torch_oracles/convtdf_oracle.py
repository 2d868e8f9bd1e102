"""Test-only torch oracle for the MDX-Net network class: ``ConvTDFNet``
(TFC-TDF v1) of kuielab/mdx-net (``models.py``), the class UVR's MDX-Net
``.onnx`` models were trained with before their export. Test scaffolding,
not shipped code; shared by the CPU tests and ``chip_smoke.py``.

Structure, as published:

* a 1x1 first conv to ``g`` channels + BatchNorm + ReLU, then a transpose of
  the (f, t) plane to (t, f), so the TDF linears act on frequency;
* ``n = num_blocks // 2`` encoder scales: a TFC-TDF block (``l`` ``k``x``k``
  conv + BatchNorm + ReLU layers, then the residual TDF
  ``Linear(f, f // bn) -> BN -> ReLU -> Linear(f // bn, f) -> BN -> ReLU``)
  and a 2x2 stride-2 conv to ``c + g`` channels + BN + ReLU;
* a bottleneck block;
* ``n`` 2x2 stride-2 transposed convs to ``c - g`` channels + BN + ReLU, each
  followed by the multiplicative skip ``x *= skip`` and a block;
* the transpose back and a 1x1 final conv to ``dim_c`` channels.

Every conv and linear here is ``bias=False`` (the published class has the
``bias`` hyperparameter on its TDF linears; its conv biases, each followed
by a BatchNorm, add nothing the BatchNorm's shift does not).

The full-width instance is UVR's MDX-Net width (``dim_c 4``,
``num_blocks 11``, ``l 3``, ``k 3``, ``g 48``, ``bn 8``) at the STFT geometry
recorded for UVR-MDX-NET-Inst_HQ_3 (n_fft 6144, ``dim_f 2560``,
``dim_t 2**8``, hop 1024, compensate 1.022): about 14.7 M parameters. No
UVR checkpoint is in the repository to confirm these hyperparameters; the
weights are seeded and random.
"""

import torch
from torch import nn

# UVR's MDX-Net width and the Inst HQ 3 STFT geometry (see the docstring).
FULL_WIDTH = {"dim_c": 4, "dim_f": 2560, "num_blocks": 11, "l": 3, "g": 48, "k": 3, "bn": 8}
INST_HQ_3_MODEL_DATA = {"compensate": 1.022, "mdx_dim_f_set": 2560, "mdx_dim_t_set": 8,
                        "mdx_n_fft_scale_set": 6144, "primary_stem": "Instrumental"}


class ConvTDF(nn.Module):
    def __init__(self, c, l, f, k, bn):
        super().__init__()
        self.H = nn.ModuleList(
            nn.Sequential(nn.Conv2d(c, c, k, stride=1, padding=k // 2, bias=False),
                          nn.BatchNorm2d(c), nn.ReLU())
            for _ in range(l))
        self.tdf = nn.Sequential(
            nn.Linear(f, f // bn, bias=False), nn.BatchNorm2d(c), nn.ReLU(),
            nn.Linear(f // bn, f, bias=False), nn.BatchNorm2d(c), nn.ReLU())

    def forward(self, x):
        for h in self.H:
            x = h(x)
        return x + self.tdf(x)


class ConvTDFNet(nn.Module):
    def __init__(self, dim_c=4, dim_f=2560, num_blocks=11, l=3, g=48, k=3, bn=8):
        super().__init__()
        self.n = num_blocks // 2
        scale = (2, 2)
        self.first_conv = nn.Sequential(nn.Conv2d(dim_c, g, (1, 1), bias=False),
                                        nn.BatchNorm2d(g), nn.ReLU())
        f, c = dim_f, g
        self.encoding_blocks = nn.ModuleList()
        self.ds = nn.ModuleList()
        for _ in range(self.n):
            self.encoding_blocks.append(ConvTDF(c, l, f, k, bn))
            self.ds.append(nn.Sequential(
                nn.Conv2d(c, c + g, scale, stride=scale, bias=False),
                nn.BatchNorm2d(c + g), nn.ReLU()))
            f //= 2
            c += g
        self.bottleneck_block = ConvTDF(c, l, f, k, bn)
        self.decoding_blocks = nn.ModuleList()
        self.us = nn.ModuleList()
        for _ in range(self.n):
            self.us.append(nn.Sequential(
                nn.ConvTranspose2d(c, c - g, scale, stride=scale, bias=False),
                nn.BatchNorm2d(c - g), nn.ReLU()))
            f *= 2
            c -= g
            self.decoding_blocks.append(ConvTDF(c, l, f, k, bn))
        self.final_conv = nn.Sequential(nn.Conv2d(c, dim_c, (1, 1), bias=False))

    def forward(self, x):
        x = self.first_conv(x)
        x = x.transpose(-1, -2)
        skips = []
        for enc, ds in zip(self.encoding_blocks, self.ds):
            x = enc(x)
            skips.append(x)
            x = ds(x)
        x = self.bottleneck_block(x)
        for i, (us, dec) in enumerate(zip(self.us, self.decoding_blocks)):
            x = us(x)
            x = x * skips[-i - 1]
            x = dec(x)
        x = x.transpose(-1, -2)
        return self.final_conv(x)


def seeded_convtdf(seed: int, **kw) -> ConvTDFNet:
    """A ``ConvTDFNet`` in eval mode with seeded weights and BatchNorm
    statistics that keep activations of order one through the depth (the
    default running statistics, mean 0 and variance 1, with multiplicative
    skips, would grow them scale by scale)."""
    torch.manual_seed(seed)
    net = ConvTDFNet(**kw)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.weight.uniform_(0.8, 1.2)
                m.bias.uniform_(0.0, 0.2)
                m.running_mean.uniform_(-0.1, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    return net.eval()
