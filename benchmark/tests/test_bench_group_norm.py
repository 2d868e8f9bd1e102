"""The GroupNorm metrics of the HTDemucs cell: ``counts/group_norm.py`` by
hand, one record of each epilogue; the two readers on a hand-made window,
with and without the program's ``kernel.group_norm`` spans."""

import importlib
import types

import pytest

from benchlib import manifest, peaks, program_spans
from benchlib.trace import Summary

TRACING = "audio_separator_tpu_torch.utils.tracing"
# Sizes as the program's span records carry them.
RECORDS = {
    "glu_scale_residual": dict(rows=4, row_len=96 * 85995, channels=96, groups=1,
                               epilogue="glu_scale_residual", channel_last=False, splits=132,
                               scale=True, residual=True),
    "gelu": dict(rows=4, row_len=6 * 85995, channels=6, groups=1, epilogue="gelu",
                 channel_last=False, splits=126, scale=False, residual=False),
    "none": dict(rows=4, row_len=1344 * 512, channels=512, groups=1, epilogue="none",
                 channel_last=True, splits=168, scale=False, residual=False),
}


def _count(**attrs):
    return manifest.plugin("counts", "group_norm").count(**attrs, itemsize=4)


def test_group_norm_bytes_by_hand():
    # DConv's tail at level 0: 4 × 96 × 85 995 inputs read, half as many
    # outputs written and residual values read, γ and β of 96 channels, 48 scales.
    n = 4 * 96 * 85995
    assert _count(**RECORDS["glu_scale_residual"]) == (0, 4 * (n + n // 2 + n // 2 + 192 + 48))
    # The GELU norm: inputs read, as many outputs written, γ and β.
    n = 4 * 6 * 85995
    assert _count(**RECORDS["gelu"]) == (0, 4 * (2 * n + 12))
    # The transformer's channel-last output norm.
    n = 4 * 1344 * 512
    assert _count(**RECORDS["none"]) == (0, 4 * (2 * n + 1024))
    # GLU without scale or residual (the v3 encoders'): inputs and half outputs.
    glu = dict(RECORDS["glu_scale_residual"], scale=False, residual=False)
    n = 4 * 96 * 85995
    assert _count(**glu) == (0, 4 * (n + n // 2 + 192))
    # Bound by bytes: 0.079 ms for the level-0 tail at 3.35 TB/s.
    ops, nbytes = _count(**RECORDS["glu_scale_residual"])
    assert round(1e3 * peaks.bound_s(ops, nbytes, 4), 3) == 0.079


@pytest.fixture
def tracing(monkeypatch):
    module = importlib.import_module(TRACING)
    module.disable()
    module.clear()
    monkeypatch.setattr(program_spans, "_tracing", None)
    yield module
    module.disable()
    module.clear()


def _ctx(span_device_s, audio_s=120.0):
    summary = Summary(window_s=60.0, busy_s=30.0, device_ops=[], idle_gaps=[],
                      span_device_s=span_device_s)
    window = types.SimpleNamespace(t0=100.0, t1=160.0, seconds=60.0, summary=summary)
    cell = types.SimpleNamespace(config={}, autocast=lambda: False)
    return types.SimpleNamespace(window=window, extras={"audio_s": audio_s}, cell=cell)


def _read(metric, ctx):
    reader = manifest.plugin("metrics", metric)
    reader.install(ctx)
    return reader.read(ctx)


def test_group_norm_readers_on_a_hand_made_window(tracing):
    ctx = _ctx({"kernel.group_norm": 0.02, "kernel.fused_attention": 1.5})
    # 20 ms of GroupNorm over 2 minutes of audio.
    assert _read("groupnorm_ms_per_audio_min.demucs", ctx) == pytest.approx(10.0)
    for start in (101.0, 159.99, 170.0):  # the last ends after the window
        for k, attrs in enumerate(RECORDS.values()):
            t0 = start + k * 1e-3
            tracing.mark("kernel.group_norm", int(t0 * 1e9), int((t0 + 5e-4) * 1e9), **attrs)
    bound = 2 * sum(peaks.bound_s(*_count(**attrs), 4) for attrs in RECORDS.values())
    assert _read("groupnorm_roofline.demucs", ctx) == pytest.approx(100.0 * bound / 0.02)


def test_group_norm_readers_return_none_without_the_span(tracing):
    """The program before its GroupNorm kernel: nothing attributed to it."""
    ctx = _ctx({"kernel.fused_attention": 1.5})
    assert _read("groupnorm_ms_per_audio_min.demucs", ctx) is None
    assert _read("groupnorm_roofline.demucs", ctx) is None
    ctx.window.summary = None  # an untraced run
    assert _read("groupnorm_ms_per_audio_min.demucs", ctx) is None
    assert _read("groupnorm_roofline.demucs", ctx) is None
