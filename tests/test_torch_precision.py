"""The port's process-wide state under concurrent workers: the float32 scope
``ops/precision.full_float32``, VR's float32 convolutions, the launch
counters of ``ops/_build`` and the unpickling stubs of ``models/demucs_load``.

A server runs jobs on several threads, and both TF32 switches belong to the
process. Two threads interleave their scopes here, ordered by events, and
every switch read inside a scope must be ``False`` while any thread is
inside; after the last thread leaves, the switches read what they read
before. A VR float32 convolution touches no cuDNN switch at all. The counter must lose no launch under eight threads, and two threads
must be able to load Demucs packages at once."""

import sys
import threading
import time

import pytest
import torch

from audio_separator_tpu_torch.models import demucs_load
from audio_separator_tpu_torch.models.convert import flatten_tree
from audio_separator_tpu_torch.models.htdemucs import HTDemucsConfig
from audio_separator_tpu_torch.models.init_params import init_htdemucs_params
from audio_separator_tpu_torch.models.vr_nets import Conv2d as VRConv2d
from audio_separator_tpu_torch.ops import _build
from audio_separator_tpu_torch.ops.precision import full_float32

from test_torch_demucs_separator import KWARGS, SMALL, _save_package
from torch_threads import one_torch_thread  # noqa: F401

JOIN_S = 30.0


def _switches():
    return (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)


@pytest.fixture()
def tf32_switches():
    saved = _switches()
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _cudnn_switches():
    cudnn = torch.backends.cudnn
    return {"enabled": cudnn.enabled, "allow_tf32": cudnn.allow_tf32,
            "benchmark": cudnn.benchmark, "deterministic": cudnn.deterministic}


@pytest.fixture()
def cudnn_switches():
    saved = _cudnn_switches()
    yield
    for key, value in saved.items():
        setattr(torch.backends.cudnn, key, value)


class _Gated(torch.Tensor):
    """A tensor whose convolutions call ``self.gate`` first: it holds a
    thread inside a convolution until the test lets it go."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if func in (torch.conv2d, torch.convolution, torch._convolution):
            args[0].gate()
        with torch._C.DisableTorchFunctionSubclass():
            return func(*args, **(kwargs or {}))


def _run(*threads):
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
    assert not any(t.is_alive() for t in threads), "a thread did not finish"


@pytest.mark.parametrize("before", [(True, True), (True, False), (False, False)])
def test_full_float32_holds_while_any_thread_is_inside(tf32_switches, before):
    """A enters, B enters, A leaves while B is still inside, B leaves."""
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before
    a_in, b_in, a_out = threading.Event(), threading.Event(), threading.Event()
    seen, errors = {}, []

    def thread_a():
        try:
            with full_float32():
                seen["a inside"] = _switches()
                a_in.set()
                assert b_in.wait(JOIN_S)
                seen["a with b inside"] = _switches()
            a_out.set()
        except BaseException as exc:  # reported by the main thread
            errors.append(exc)
            a_out.set()

    def thread_b():
        try:
            assert a_in.wait(JOIN_S)
            with full_float32():
                seen["b inside"] = _switches()
                b_in.set()
                assert a_out.wait(JOIN_S)
                seen["b after a left"] = _switches()
        except BaseException as exc:
            errors.append(exc)
            b_in.set()

    _run(threading.Thread(target=thread_a), threading.Thread(target=thread_b))
    assert not errors, errors
    assert seen == {k: (False, False) for k in
                    ("a inside", "a with b inside", "b inside", "b after a left")}, seen
    assert _switches() == before


def test_full_float32_nests_and_restores_after_an_error(tf32_switches):
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, True
    with pytest.raises(ValueError):
        with full_float32():
            with full_float32():
                assert _switches() == (False, False)
            assert _switches() == (False, False)
            raise ValueError("inside")
    assert _switches() == (True, True)


def test_full_float32_under_many_threads(tf32_switches):
    """16 threads enter and leave the scope 200 times each with a short
    switch interval: none reads a switch on inside, and the switches end
    where they began."""
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, True
    bad = []

    def work():
        for _ in range(200):
            with full_float32():
                if _switches() != (False, False):
                    bad.append(_switches())

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _run(*(threading.Thread(target=work) for _ in range(16)))
    finally:
        sys.setswitchinterval(interval)
    assert not bad, bad[:5]
    assert _switches() == (True, True)


@pytest.mark.parametrize("depthwise", [False, True], ids=["dense", "depthwise"])
def test_vr_float32_convolutions_leave_the_cudnn_switches_alone(cudnn_switches, depthwise):
    """A is inside a VR float32 convolution, B enters one, A leaves while B
    is still inside, B leaves. No thread, and not the main thread while both
    are inside, reads a cuDNN switch other than what it read before, and the
    convolution equals ``F.conv2d``."""
    before = _cudnn_switches()
    channels = 4
    conv = VRConv2d(channels, channels, 3, 1, 2, 2, groups=channels if depthwise else 1,
                    bias=False)
    g = torch.Generator().manual_seed(3)
    xs = [torch.randn(1, channels, 9, 7, generator=g) for _ in range(2)]
    a_in, b_in, a_out = threading.Event(), threading.Event(), threading.Event()
    seen, outputs, errors = {}, {}, []

    def gate(name, enter, wait_for):
        def hold():
            seen[f"{name} inside"] = _cudnn_switches()
            enter.set()
            assert wait_for.wait(JOIN_S)
        return hold

    def run(name, x, enter, wait_for, start=None, done=None):
        try:
            if start is not None:
                assert start.wait(JOIN_S)
            gated = x.as_subclass(_Gated)
            gated.gate = gate(name, enter, wait_for)
            outputs[name] = conv(gated)
        except BaseException as exc:  # reported by the main thread
            errors.append(exc)
            enter.set()
        finally:
            if done is not None:
                done.set()

    threads = [threading.Thread(target=run, args=("a", xs[0], a_in, b_in), kwargs={"done": a_out}),
               threading.Thread(target=run, args=("b", xs[1], b_in, a_out), kwargs={"start": a_in})]
    for t in threads:
        t.start()
    assert b_in.wait(JOIN_S)
    seen["main while both were inside"] = _cudnn_switches()
    for t in threads:
        t.join(JOIN_S)
    assert not any(t.is_alive() for t in threads), "a thread did not finish"
    assert not errors, errors
    assert seen == {k: before for k in ("a inside", "b inside", "main while both were inside")}, seen
    assert _cudnn_switches() == before
    with torch.no_grad():
        for name, x in zip("ab", xs):
            want = torch.nn.functional.conv2d(x, conv.weight, None, 1, 2, 2, conv.groups)
            assert torch.equal(outputs[name], want)


def test_launch_counter_loses_no_count_under_threads():
    """8 threads x 10 000 calls of ``_build.count`` give exactly 80 000."""
    name = "fused_attention"
    saved = dict(_build.LAUNCHES)
    _build.reset_launch_counts()

    def work():
        for _ in range(10_000):
            _build.count(name)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _run(*(threading.Thread(target=work) for _ in range(8)))
        assert _build.LAUNCHES[name] == 80_000
        assert all(v == 0 for k, v in _build.LAUNCHES.items() if k != name)
    finally:
        sys.setswitchinterval(interval)
        _build.LAUNCHES.update(saved)


def test_demucs_packages_load_on_two_threads_at_once(tmp_path, monkeypatch):
    """The ``demucs.*`` stubs live in ``sys.modules``: while one thread
    unpickles a package, a second thread's load must neither find them
    removed under it nor remove them under the first. The first load is held
    open (a slow ``torch.load``) until the second has had time to start."""
    state = {k: torch.from_numpy(v) for k, v in
             flatten_tree(init_htdemucs_params(HTDemucsConfig(**SMALL), seed=2)).items()}
    path = _save_package(str(tmp_path), "955717e8", "HTDemucs", KWARGS, state)
    real_load = torch.load
    first_inside = threading.Event()

    def slow_load(*args, **kwargs):
        first_inside.set()
        time.sleep(0.3)
        return real_load(*args, **kwargs)

    monkeypatch.setattr(torch, "load", slow_load)
    results, errors = [], []

    def load(wait):
        try:
            if wait:
                assert first_inside.wait(JOIN_S)
            results.append(demucs_load.load_demucs_checkpoint(path))
        except BaseException as exc:
            errors.append(exc)

    _run(threading.Thread(target=load, args=(False,)), threading.Thread(target=load, args=(True,)))
    assert not errors, errors
    assert [r[0] for r in results] == ["HTDemucs", "HTDemucs"]
    assert not any(name.startswith("demucs") for name in sys.modules)
