"""``ops/group_norm`` on the CPU. The plain version is the modules' own
composition (``nn.GroupNorm`` and each epilogue, channel-last included), bit
for bit; the wrapper takes it for CPU tensors and wherever autograd needs a
gradient, and the kernel path for a CUDA tensor in inference (the kernel
itself runs only on the card: here its launch is replaced by a recorder);
the launch plan; the span a launch keeps; and the Demucs modules, whose
state-dict keys stay upstream's and whose forwards compute what the
``nn.Sequential`` composition computed. The kernel against its plain
version: ``tests/test_torch_cuda_kernels.py`` on the card."""

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from audio_separator_tpu_torch.models import htdemucs as ht
from audio_separator_tpu_torch.ops import _build
from audio_separator_tpu_torch.ops import group_norm as gn
from audio_separator_tpu_torch.utils import tracing

from torch_threads import one_torch_thread  # noqa: F401


def _randn(*shape, seed=0, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g) * scale


def _norm_module(groups, channels, seed):
    norm = nn.GroupNorm(groups, channels)
    with torch.no_grad():
        norm.weight.copy_(1 + 0.2 * _randn(channels, seed=seed))
        norm.bias.copy_(0.1 * _randn(channels, seed=seed + 1))
    return norm.requires_grad_(False)


@pytest.mark.parametrize("groups, shape", [(1, (3, 6, 101)), (1, (2, 96, 336)),
                                           (4, (2, 16, 5, 7)), (2, (5, 8, 1))])
@pytest.mark.parametrize("epilogue", ["none", "gelu", "glu_scale_residual"])
def test_plain_version_is_the_modules_composition(groups, shape, epilogue):
    x = _randn(*shape, seed=1, scale=3.0) + 0.5
    norm = _norm_module(groups, shape[1], seed=2)
    got = gn.group_norm_ref(x, norm.weight, norm.bias, groups, norm.eps, epilogue)
    want = norm(x)
    if epilogue == "gelu":
        want = nn.GELU()(want)
    elif epilogue == "glu_scale_residual":
        want = nn.GLU(1)(want)
    assert torch.equal(got, want)


def test_plain_glu_with_scale_and_residual_is_a_dconv_tail():
    x = _randn(2, 12, 50, seed=3)
    residual = _randn(2, 6, 50, seed=4)
    norm = _norm_module(1, 12, seed=5)
    scale = ht.LayerScale(6)
    with torch.no_grad():
        scale.scale.copy_(_randn(6, seed=6))
    got = gn.group_norm_ref(x, norm.weight, norm.bias, 1, norm.eps, "glu_scale_residual",
                            scale=scale.scale, residual=residual)
    assert torch.equal(got, residual + scale(nn.GLU(1)(norm(x))))


@pytest.mark.parametrize("epilogue", ["none", "gelu"])
def test_plain_channel_last_is_the_transposed_group_norm(epilogue):
    x = _randn(2, 30, 16, seed=7)
    norm = _norm_module(1, 16, seed=8)
    got = gn.group_norm_ref(x, norm.weight, norm.bias, 1, norm.eps, epilogue,
                            channel_last=True)
    want = norm(x.transpose(1, 2)).transpose(1, 2)
    assert torch.equal(got, F.gelu(want) if epilogue == "gelu" else want)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    x = _randn(2, 8, 40, seed=9)
    norm = _norm_module(2, 8, seed=10)
    before = dict(_build.LAUNCHES)
    got = gn.group_norm(x, norm.weight, norm.bias, 2, norm.eps, "gelu")
    assert torch.equal(got, F.gelu(norm(x)))
    assert _build.LAUNCHES == before


@pytest.fixture
def on_a_card(monkeypatch):
    """The wrapper as it sees a CUDA tensor, with the kernel's launch
    replaced by a recorder of its calls."""
    calls = []
    monkeypatch.setattr(gn, "device_kind", lambda x: "cuda")
    monkeypatch.setattr(gn, "_launch", lambda *args: calls.append(args) or args[0])
    return calls


@pytest.mark.parametrize("grad_mode, requires, kernel", [
    (True, "weight", False), (True, "x", False), (True, "residual", False),
    (True, None, True), (False, "weight", True)])
def test_grad_mode_routes_to_the_plain_path(on_a_card, grad_mode, requires, kernel):
    tensors = {"x": _randn(2, 8, 20, seed=11), "weight": 1 + _randn(8, seed=12),
               "bias": _randn(8, seed=13), "residual": _randn(2, 4, 20, seed=14)}
    if requires:
        tensors[requires].requires_grad_(True)
    with torch.set_grad_enabled(grad_mode):
        out = gn.group_norm(tensors["x"], tensors["weight"], tensors["bias"], 1, 1e-5,
                            "glu_scale_residual", residual=tensors["residual"])
    assert len(on_a_card) == int(kernel)
    if not kernel:
        want = gn.group_norm_ref(tensors["x"], tensors["weight"], tensors["bias"], 1, 1e-5,
                                 "glu_scale_residual", residual=tensors["residual"])
        assert torch.equal(out, want) and out.requires_grad


def test_inference_mode_takes_the_kernel(on_a_card):
    weight = nn.Parameter(torch.ones(4))
    with torch.inference_mode():
        gn.group_norm(_randn(1, 4, 8), weight, None, 1, 1e-5)
    assert len(on_a_card) == 1


@pytest.mark.parametrize("kwargs, match", [
    (dict(x=torch.zeros(2, 4, 8, dtype=torch.float64)), "float32"),
    (dict(x=torch.zeros(2, 8, 6), groups=2, channel_last=True), "one group"),
    (dict(x=torch.zeros(2, 4, 6), epilogue="glu_scale_residual", channel_last=True),
     "one group and no GLU"),
    (dict(x=torch.zeros(2, 6, 8), groups=4), "groups"),
    (dict(x=torch.zeros(2, 6, 8), epilogue="glu_scale_residual",
          residual=torch.zeros(2, 6, 8)), "residual"),
    (dict(x=torch.zeros(3, 8)), r"\(N, C, L...\)"),
])
def test_kernel_path_refuses_what_it_does_not_take(monkeypatch, kwargs, match):
    monkeypatch.setattr(gn, "device_kind", lambda x: "cuda")
    args = dict(weight=None, bias=None, groups=1, eps=1e-5)
    with pytest.raises(ValueError, match=match):
        gn.group_norm(**{**args, **kwargs})


@pytest.mark.parametrize("epilogue", ["none", "gelu"])
def test_scale_and_residual_belong_to_the_glu_epilogue(epilogue):
    with pytest.raises(ValueError, match="glu_scale_residual"):
        gn.group_norm(torch.zeros(1, 2, 4), None, None, 1, 1e-5, epilogue,
                      residual=torch.zeros(1, 2, 4))


@pytest.mark.parametrize("rows, row_len, split", [
    (4, 96 * 85995, True),     # HTDemucs level 0, time branch: the GLU norm
    (4, 6 * 85995, True),      # and its GELU norm
    (4, 1344 * 512, True),     # the transformer's time-branch output norm
    (2048, 96 * 336, False),   # level 0, frequency rows folded into the batch
    (2048, 6 * 336, False),
    (3, 9, False),             # a row shorter than a block's least
])
def test_plan_fills_the_card_when_rows_are_few(rows, row_len, split):
    sms = 132
    splits, chunk, pieces, piece = gn.plan(rows, row_len, rows, row_len, sms)
    assert (splits > 1) is split
    for parts, part in ((splits, chunk), (pieces, piece)):
        assert part % 4 == 0 and (parts - 1) * part < row_len <= parts * part
        assert parts == 1 or part >= gn.MIN_BLOCK_ELEMENTS
    wave = gn.BLOCKS_PER_SM * sms
    assert rows * splits >= min(wave, rows * row_len // gn.MIN_BLOCK_ELEMENTS) // 2
    assert rows * splits <= max(rows, wave + rows)


def test_a_launch_with_sizes_keeps_a_span_record():
    saved = dict(_build.LAUNCHES)
    tracing.disable()
    tracing.clear()
    try:
        with _build.launch("group_norm", rows=4, splits=33):
            pass
        assert tracing.records() == []
        tracing.enable()
        with _build.launch("group_norm", rows=4, splits=33):
            pass
        with _build.launch("gelu_backward"):
            pass
        (record,) = tracing.records()
        assert record.name == "kernel.group_norm" and record.attrs == {"rows": 4, "splits": 33}
        assert _build.LAUNCHES["group_norm"] == saved["group_norm"] + 2
    finally:
        tracing.disable()
        tracing.clear()
        _build.LAUNCHES.update(saved)


def _dconv(lstm, attn, seed):
    torch.manual_seed(seed)
    dconv = ht.DConv(16, 4, 2, lstm=lstm, attn=attn)
    with torch.no_grad():
        for p in dconv.parameters():
            p.copy_(0.3 * torch.randn_like(p) + (1.0 if p.dim() == 1 else 0))
    return dconv.requires_grad_(False)


@pytest.mark.parametrize("lstm, attn", [(False, False), (True, True)])
def test_dconv_computes_what_its_sequential_did(lstm, attn):
    dconv = _dconv(lstm, attn, seed=15)
    x = _randn(2, 16, 37, seed=16)
    want = x
    for layer in dconv.layers:
        want = want + layer(want)
    assert torch.equal(dconv(x), want)


def test_encoder_and_decoder_norms_compute_what_the_modules_did():
    cfg = ht.HTDemucsConfig(sources=("a", "b"), channels=8, norm_groups=4, dconv_comp=4,
                            dconv_mode=3)
    torch.manual_seed(17)
    enc = ht.HEncLayer(4, 8, 4, 2, 1, freq=False, empty=False, norm=True, cfg=cfg)
    dec = ht.HDecLayer(8, 4, 4, 2, 1, freq=False, empty=False, norm=True, last=False, cfg=cfg)
    for m in (enc, dec):
        with torch.no_grad():
            for p in m.parameters():
                p.copy_(0.3 * torch.randn_like(p) + (1.0 if p.dim() == 1 else 0))
        m.requires_grad_(False)

    def dconv(d, y):
        for layer in d.layers:
            y = y + layer(y)
        return y

    x = _randn(2, 4, 64, seed=18)
    y = dconv(enc.dconv, F.gelu(enc.norm1(enc.conv(x))))
    assert torch.equal(enc(x), F.glu(enc.norm2(enc.rewrite(y)), dim=1))
    h, skip = _randn(2, 8, 33, seed=19), _randn(2, 8, 33, seed=20)
    y = dconv(dec.dconv, F.glu(dec.norm1(dec.rewrite(h + skip)), dim=1))
    z, pre = dec(h, skip, 60)
    assert torch.equal(pre, y)
    assert torch.equal(z, F.gelu(dec.norm2(dec.conv_tr(y))[..., 1:61]))


def test_transformer_output_norm_is_the_transposed_group_norm():
    torch.manual_seed(21)
    layer = ht.SelfAttentionLayer(16, 2, 32).requires_grad_(False)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(0.3 * torch.randn_like(p) + (1.0 if p.dim() == 1 else 0))
    x = _randn(2, 12, 16, seed=22)
    h = layer.norm2(x)
    y = layer.linear2(F.gelu(layer.linear1(h)))
    x2 = x + layer.gamma_2(y)
    want = layer.norm_out(x2.transpose(1, 2)).transpose(1, 2)
    assert torch.equal(layer._feed_forward(x, layer.norm2), want)


def test_dconv_state_dict_keys_are_upstreams():
    def keys(dconv):
        return [k for k in dconv.state_dict() if k.startswith("layers.0.")]

    assert keys(ht.DConv(16, 4, 2)) == [
        "layers.0.0.weight", "layers.0.0.bias", "layers.0.1.weight", "layers.0.1.bias",
        "layers.0.3.weight", "layers.0.3.bias", "layers.0.4.weight", "layers.0.4.bias",
        "layers.0.6.scale"]
    deep = keys(ht.DConv(16, 4, 2, lstm=True, attn=True))
    assert deep[:4] == ["layers.0.0.weight", "layers.0.0.bias", "layers.0.1.weight",
                        "layers.0.1.bias"]
    assert {k.split(".")[2] for k in deep} == {"0", "1", "3", "4", "5", "6", "8"}
    assert deep[-5:] == ["layers.0.5.weight", "layers.0.5.bias", "layers.0.6.weight",
                         "layers.0.6.bias", "layers.0.8.scale"]


@pytest.mark.parametrize("arch", ["htdemucs", "hdemucs"])
def test_model_norm_keys_are_upstreams(arch):
    cfg = ht.HTDemucsConfig(sources=("a", "b"), arch=arch, channels=4, depth=6 if arch ==
                            "hdemucs" else 4, t_layers=1, nfft=256, dconv_comp=4)
    keys = set(ht.build_demucs(cfg).state_dict())
    assert "encoder.0.dconv.layers.1.4.weight" in keys
    assert "tencoder.0.dconv.layers.0.6.scale" in keys
    if arch == "hdemucs":
        assert {"encoder.4.norm1.weight", "encoder.4.norm2.bias", "decoder.0.norm1.weight",
                "decoder.0.norm2.bias", "encoder.4.dconv.layers.0.3.lstm.weight_ih_l0"} <= keys
    else:
        assert {"crosstransformer.layers.0.norm_out.weight",
                "crosstransformer.layers_t.0.norm_out.bias"} <= keys
