"""The readers of the program's spans on a hand-made window: a synthetic
``Summary`` (idle gaps by name) and records kept by the program's tracing
module, some inside the window and some outside it; and, where the program
has no spans (an older checkout), every reader returns None."""

import importlib
import types

import pytest

from benchlib import manifest, program_spans
from benchlib.trace import SPAN_PREFIX, Summary

TRACING = "audio_separator_tpu_torch.utils.tracing"

IDLE = [["song", 4.0], ["demix.batch", 1.0], ["host", 1.0], ["service.store", 0.6],
        ["separate.request", 0.5], ["audio.encode", 0.4], ["train.loss", 0.3],
        ["kernel.fused_attention_block", 0.25], ["service.wait", 0.2], ["b1", 0.1]]


@pytest.fixture
def tracing(monkeypatch):
    import torch.profiler

    module = importlib.import_module(TRACING)
    module.disable()
    module.clear()
    monkeypatch.setattr(program_spans, "_tracing", None)
    monkeypatch.setattr(program_spans, "_all_threads", False)
    monkeypatch.setattr(torch.profiler, "profile", torch.profiler.profile)
    yield module
    module.disable()
    module.clear()


def _ctx(**extras):
    t0, t1 = 100.0, 160.0
    summary = Summary(window_s=t1 - t0, busy_s=50.0, device_ops=[], idle_gaps=IDLE,
                      span_device_s={})
    window = types.SimpleNamespace(t0=t0, t1=t1, seconds=t1 - t0, summary=summary)
    return types.SimpleNamespace(window=window, extras=extras)


def _read(metric, ctx):
    reader = manifest.plugin("metrics", metric)
    reader.install(ctx)
    return reader.read(ctx)


def _ns(seconds):
    return int(seconds * 1e9)


def test_install_turns_the_programs_spans_on_under_the_harness_prefix(tracing):
    program_spans.install(_ctx())
    assert tracing.enabled() and tracing._prefix == SPAN_PREFIX


def test_all_threads_has_a_profile_record_a_thread_of_its_own(tracing):
    import threading

    import torch
    from torch.profiler import ProfilerActivity

    go, done = threading.Event(), threading.Event()

    def service_thread():  # started before the profile, as the service's worker
        go.wait(10)
        with tracing.span("service.store"):
            torch.ones(4).sum()
        done.set()

    program_spans.install(_ctx(), all_threads=True)
    worker = threading.Thread(target=service_thread)
    worker.start()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]) as prof:
        go.set()
        assert done.wait(10)
    worker.join(10)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert SPAN_PREFIX + "service.store" in names


@pytest.mark.parametrize("metric, extras, expected", [
    # separate.*, demix.* and kernel.* gaps: 1.75 s over 3 minutes of audio.
    ("demix_idle_ms_per_audio_min.sep", {"audio_s": 180.0}, 1750.0 / 3),
    ("demix_idle_ms_per_audio_min.demucs", {"audio_s": 60.0}, 1750.0),
    # train.* and kernel.* gaps: 0.55 s over 5 steps.
    ("step_idle_ms.train", {"steps": 5}, 110.0),
    # service.* gaps: 0.8 s over 4 jobs.
    ("service_idle_ms_per_job.remote", {"job_ms": [1, 2, 3, 4]}, 200.0),
])
def test_idle_readers(tracing, metric, extras, expected):
    assert _read(metric, _ctx(**extras)) == pytest.approx(expected)


def test_codec_reader_sums_the_windows_decode_and_encode(tracing):
    ctx = _ctx(audio_s=120.0)
    program_spans.install(ctx)
    tracing.mark("audio.decode", _ns(101.0), _ns(101.2))
    tracing.mark("audio.encode", _ns(150.0), _ns(150.5))
    tracing.mark("audio.encode", _ns(159.9), _ns(160.1))    # ends after the window
    tracing.mark("audio.decode", _ns(99.0), _ns(99.5))      # before it
    tracing.mark("separate.prepare", _ns(101.0), _ns(101.3))  # not the codec
    assert _read("codec_ms_per_audio_min.sep", ctx) == pytest.approx(700.0 / 2)


def test_queue_wait_reader_takes_the_median_of_the_windows_pick_ups(tracing):
    ctx = _ctx()
    program_spans.install(ctx)
    for start, end in ((98.0, 101.0), (120.0, 122.5), (130.0, 131.0), (150.0, 161.0)):
        tracing.mark("service.queue_wait", _ns(start), _ns(end))
    assert _read("queue_wait_ms.remote", ctx) == pytest.approx(2500.0)


@pytest.mark.parametrize("metric, extras", [
    ("demix_idle_ms_per_audio_min.sep", {"audio_s": 60.0}),
    ("codec_ms_per_audio_min.demucs", {"audio_s": 60.0}),
    ("step_idle_ms.train", {"steps": 3}),
    ("service_idle_ms_per_job.remote", {"job_ms": [1.0]}),
    ("queue_wait_ms.remote", {}),
])
def test_readers_return_none_without_the_programs_spans(tracing, monkeypatch, metric, extras):
    real = importlib.import_module

    def without_tracing(name, *a, **kw):
        if name == TRACING:
            raise ModuleNotFoundError(f"No module named {name!r}", name=name)
        return real(name, *a, **kw)

    monkeypatch.setattr(program_spans.importlib, "import_module", without_tracing)
    assert _read(metric, _ctx(**extras)) is None
    assert not tracing.enabled()


def test_readers_return_none_without_a_window(tracing):
    ctx = types.SimpleNamespace(window=None, extras={"audio_s": 60.0, "steps": 2})
    for metric in ("demix_idle_ms_per_audio_min.sep", "codec_ms_per_audio_min.sep",
                   "step_idle_ms.train", "queue_wait_ms.remote"):
        assert _read(metric, ctx) is None
