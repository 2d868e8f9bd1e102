"""Probes the harness puts around the program's entry points from outside,
in a traced run only: each wraps a module attribute, so that calls made
through it open a ``bench.<name>`` range in the trace, add their host time to
a running total and, where asked, record what a count needs from their
arguments.

A probe sees only calls that look the attribute up at call time: the
program's ``audio_io.load_audio(...)`` does, a name bound by ``from ...
import`` in another module must be wrapped in that module. Nothing is
recorded while no window is open (``ACTIVE``).
"""

from __future__ import annotations

import functools
import importlib
import threading
import time

import torch

from .trace import SPAN_PREFIX

ACTIVE = threading.Event()


class Probe:
    def __init__(self, name: str, record=None):
        self.name = name
        self.record = record
        self.calls = []
        self.host_s = 0.0
        self.count = 0
        self._lock = threading.Lock()
        self.local = threading.local()  # .last: this thread's last recorded item

    def last(self):
        return getattr(self.local, "last", None)

    def wrap(self, fn):
        probe = self

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not ACTIVE.is_set():
                return fn(*args, **kwargs)
            item = probe.record(*args, **kwargs) if probe.record else None
            if probe.record is not None and item is None:
                return fn(*args, **kwargs)  # a call of another form: not this probe's
            probe.local.last = item
            t0 = time.perf_counter()
            with torch.profiler.record_function(SPAN_PREFIX + probe.name):
                out = fn(*args, **kwargs)
            dt = time.perf_counter() - t0
            with probe._lock:
                probe.host_s += dt
                probe.count += 1
                if item is not None:
                    probe.calls.append(item)
            return out

        wrapper.__wrapped_by_probe__ = probe
        return wrapper


_PROBES = {}


def install(name: str, module: str, attr: str, record=None) -> Probe:
    """Wrap ``module.attr`` (once per name) and return its probe."""
    if name in _PROBES:
        return _PROBES[name]
    mod = importlib.import_module(module)
    probe = Probe(name, record)
    setattr(mod, attr, probe.wrap(getattr(mod, attr)))
    _PROBES[name] = probe
    return probe


def get(name: str):
    return _PROBES.get(name)
