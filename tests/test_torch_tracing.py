"""The port's spans (``audio_separator_tpu_torch/utils/tracing.py``) on the
CPU: off, a shared null context that records nothing; on, records with their
parent, request id and thread in a bounded buffer, and profiler ranges under
the chosen prefix that nest as the spans do; the kernel wrappers' ``launch``
(``ops/_build.py``) counting as ``count`` does; the spans placed in the
demix engine, the codec, the training step and the service."""

import collections
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from audio_separator_tpu_torch.io import audio as audio_io
from audio_separator_tpu_torch.ops import _build
from audio_separator_tpu_torch.ops.demix import overlap_add_demix
from audio_separator_tpu_torch.remote.server import SeparatorService
from audio_separator_tpu_torch.separator.separator import Separator
from audio_separator_tpu_torch.training import cast_call, make_train_step
from audio_separator_tpu_torch.utils import tracing
from audio_separator_tpu_torch.utils.profiling import device_trace

from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def spans_off_and_empty():
    """Every test starts and ends with spans off and the buffer empty, and
    leaves the launch counters as they were."""
    saved = dict(_build.LAUNCHES)
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()
    _build.LAUNCHES.update(saved)


def _names(records):
    return [r.name for r in records]


def test_off_span_is_one_shared_null_context_and_records_nothing():
    assert not tracing.enabled()
    a, b = tracing.span("x.a"), tracing.span("x.b", k=1)
    assert a is b
    assert tracing.profiler_range("kernel.k") is a
    assert tracing.request("job") is a
    with a, tracing.span("x.c"):
        tracing.mark("x.wait", time.perf_counter_ns())
    assert tracing.records() == [] and tracing.dropped() == 0


def test_on_spans_record_nesting_parent_request_and_thread():
    tracing.enable(range_prefix="t.")
    with tracing.request("req-1"):
        with tracing.span("outer.call", size=3):
            with tracing.span("inner.part"):
                pass
            with tracing.span("inner.part"):
                pass
    with tracing.span("free.span"):
        pass
    recs = tracing.records()
    assert _names(recs) == ["inner.part", "inner.part", "outer.call", "free.span"]
    inner1, inner2, outer, free = recs
    assert outer.parent is None and inner1.parent == outer.span_id == inner2.parent
    assert len({r.span_id for r in recs}) == 4
    assert [r.request for r in recs] == ["req-1"] * 3 + [None]
    assert {r.thread for r in recs} == {threading.get_ident()}
    assert outer.attrs == {"size": 3} and inner1.attrs == {}
    assert outer.start_ns <= inner1.start_ns <= inner1.end_ns <= inner2.start_ns
    assert inner2.end_ns <= outer.end_ns
    assert tracing.records(since_ns=free.start_ns) == [free]


def test_request_without_an_id_keeps_the_current_one():
    tracing.enable()
    with tracing.request():
        with tracing.span("a.one"):
            pass
        with tracing.request():
            with tracing.span("a.two"):
                pass
    with tracing.request("job"), tracing.request():
        with tracing.span("a.three"):
            pass
    one, two, three = tracing.records()
    assert one.request and one.request == two.request
    assert three.request == "job"


def test_spans_on_another_thread_carry_that_thread_and_no_request():
    tracing.enable()
    seen = []

    def work():
        with tracing.span("w.part"):
            seen.append(threading.get_ident())

    with tracing.request("main"), tracing.span("m.part"):
        t = threading.Thread(target=work)
        t.start()
        t.join(10)
    assert not t.is_alive()
    w, m = tracing.records()
    assert w.thread == seen[0] != m.thread
    assert w.request is None and w.parent is None and m.request == "main"


def test_mark_keeps_a_record_from_a_given_start_under_the_open_span():
    tracing.enable()
    t0 = time.perf_counter_ns()
    with tracing.span("s.outer"):
        tracing.mark("s.wait", t0, job=7)
        tracing.mark("s.fixed", 10, 30)
    wait, fixed, outer = tracing.records()
    assert wait.start_ns == t0 <= wait.end_ns and wait.parent == outer.span_id
    assert wait.attrs == {"job": 7} and (fixed.start_ns, fixed.end_ns) == (10, 30)


def test_buffer_keeps_the_newest_and_counts_drops(monkeypatch):
    assert tracing._buffer.maxlen == tracing.CAPACITY
    monkeypatch.setattr(tracing, "_buffer", collections.deque(maxlen=4))
    tracing.enable()
    for i in range(10):
        with tracing.span("b.part", i=i):
            pass
    recs = tracing.records()
    assert [r.attrs["i"] for r in recs] == [6, 7, 8, 9]
    assert tracing.dropped() == 6
    tracing.clear()
    assert tracing.records() == [] and tracing.dropped() == 0


def test_spans_from_many_threads_lose_no_record():
    tracing.enable()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def work(k):
            for i in range(300):
                with tracing.span("c.part", k=k, i=i):
                    pass
        threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    recs = tracing.records()
    assert len(recs) == 2400 and tracing.dropped() == 0
    assert len({r.span_id for r in recs}) == 2400


def _profiled_ranges(prof, prefix):
    """``{name: [(start, end)]}`` of the profiler's CPU events under ``prefix``."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(prefix) and e.device_type() == torch.autograd.DeviceType.CPU:
            out.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def test_ranges_under_a_cpu_profiler_carry_the_prefix_and_nest():
    from torch.profiler import ProfilerActivity, profile

    tracing.enable(range_prefix="probe.")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("outer.call"):
            with tracing.span("inner.part"):
                torch.ones(8).sum()
            with _build.launch("fused_attention"):
                torch.ones(8).sum()
    ranges = _profiled_ranges(prof, "probe.")
    assert set(ranges) == {"probe.outer.call", "probe.inner.part",
                           "probe.kernel.fused_attention"}
    (o0, o1), = ranges["probe.outer.call"]
    for name in ("probe.inner.part", "probe.kernel.fused_attention"):
        (s, e), = ranges[name]
        assert o0 <= s <= e <= o1
    # Kernel ranges go to the profiler only.
    assert _names(tracing.records()) == ["inner.part", "outer.call"]


@pytest.mark.parametrize("spans_on", [False, True])
def test_launch_counts_as_count_did(spans_on):
    if spans_on:
        tracing.enable()
    _build.reset_launch_counts()
    with _build.launch("fused_ff_block"):
        pass
    _build.count("fused_ff_block")
    with pytest.raises(RuntimeError):
        with _build.launch("fused_ff_block"):
            raise RuntimeError("a launch that fails is not counted")
    with _build.launch("attention_backward_bf16"):
        pass
    assert _build.LAUNCHES["fused_ff_block"] == 2
    assert _build.LAUNCHES["attention_backward_bf16"] == 1
    assert sum(_build.LAUNCHES.values()) == 3
    assert tracing.records() == []


def test_launch_counts_exactly_across_threads():
    _build.reset_launch_counts()
    tracing.enable()

    def work():
        for _ in range(2000):
            with _build.launch("gelu_backward"):
                pass
    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    assert _build.LAUNCHES["gelu_backward"] == 16_000


def test_device_trace_turns_spans_on_for_its_call(tmp_path):
    with device_trace(str(tmp_path)):
        assert tracing.enabled()
        with tracing.span("separate.request"):
            torch.ones(4).sum()
    assert not tracing.enabled()
    (trace,) = os.listdir(tmp_path)
    with open(tmp_path / trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "asep.separate.request" in names
    # Spans another caller turned on stay on, under that caller's prefix.
    tracing.enable(range_prefix="mine.")
    with device_trace(str(tmp_path / "two")):
        with tracing.span("separate.request"):
            pass
    assert tracing.enabled()
    (trace,) = os.listdir(tmp_path / "two")
    with open(tmp_path / "two" / trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "mine.separate.request" in names


def test_demix_engine_and_codec_spans(tmp_path):
    tracing.enable()
    rng = np.random.default_rng(0)
    mix = rng.standard_normal((2, 1000)).astype(np.float32)
    path = str(tmp_path / "mix.wav")
    with tracing.request("r"):
        audio_io.save_audio(path, mix, 44100)
        pcm, _ = audio_io.load_audio(path)
        out = overlap_add_demix(lambda x: x[:, None] * 2.0, pcm, chunk=200, step=100,
                                window=np.hanning(200), num_stems=1, batch_size=3,
                                device="cpu")
    assert out.shape == (1, 2, 1000)
    names = _names(tracing.records())
    batches = -(-len(range(0, 1000, 100)) // 3)
    assert names == (["audio.encode", "audio.decode", "demix.upload"]
                     + ["demix.batch"] * batches + ["demix.fetch"])
    assert {r.request for r in tracing.records()} == {"r"}


def test_training_step_spans():
    tracing.enable()
    torch.manual_seed(0)
    model = torch.nn.Linear(16, 16)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    step = make_train_step(object(), model, opt)  # not a RoFormer: the L1 loss
    step(torch.randn(2, 2, 16), torch.randn(2, 1, 2, 16))
    assert _names(tracing.records()) == ["train.zero_grad", "train.forward", "train.loss",
                                         "train.backward", "train.optimizer"]
    tracing.clear()
    x = torch.randn(2, 16, dtype=torch.bfloat16)
    assert cast_call(model, x, dtype=torch.bfloat16).dtype == torch.bfloat16
    assert _names(tracing.records()) == ["train.cast"]


def test_service_job_records_its_queue_wait_and_the_workers_spans(tmp_path, monkeypatch):
    def fake_load_model(self, model_filename="default"):
        self.model_filename = str(model_filename)
        self.model_instance = object()

    def fake_separate(self, audio_file_path, custom_output_names):
        with tracing.span("separate.prepare"):
            out = os.path.join(self.output_dir, "song_(Vocals)_fake.wav")
            with open(out, "wb") as f:
                f.write(b"RIFF" + b"\0" * 16)
        return [out]

    monkeypatch.setattr(Separator, "load_model", fake_load_model)
    monkeypatch.setattr(Separator, "_separate", fake_separate)
    monkeypatch.setenv("AUDSEP_SERVER_COALESCE", "1")
    models = tmp_path / "models"
    models.mkdir()
    (models / "download_checks.json").write_text("{}")
    tracing.enable()
    service = SeparatorService(work_dir=str(tmp_path / "work"), model_file_dir=str(models),
                               device="cpu")
    task_id = service.submit("song.wav", b"x", {"model": "m.ckpt"})
    status = service.wait(task_id, timeout=60, poll_interval=0.02)
    assert status and status["status"] == "completed", status
    recs = tracing.records()
    job = [r for r in recs if r.request == task_id]
    waits = [r for r in job if r.name == "service.queue_wait"]
    assert len(waits) == 1 and waits[0].end_ns >= waits[0].start_ns
    assert {"service.build", "service.load_model", "service.separate", "separate.request",
            "separate.prepare", "service.store"} <= set(_names(job))
    worker = {r.thread for r in job}
    assert len(worker) == 1 and worker != {threading.get_ident()}
    by_id = {r.span_id: r for r in recs}
    prepare = next(r for r in job if r.name == "separate.prepare")
    assert by_id[prepare.parent].name == "separate.request"
    assert by_id[by_id[prepare.parent].parent].name == "service.separate"
    # The wait that the job ended, closed when the worker took it.
    assert any(r.name == "service.wait" and r.request is None for r in recs)
