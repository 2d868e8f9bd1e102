"""Spans: the program's own names for the parts of its work, off by default.

A span marks one layer's part of a call, at the boundary where that work
happens; every name is ``<layer>.<part>`` (``separate.prepare``,
``demix.batch``, ``audio.encode``, ``train.backward``, ``service.store``)::

    with tracing.span("demix.fetch"):
        ...

**Off** (the default) :func:`span` returns one shared null context after a
single flag check: it allocates nothing, takes no lock and makes no
``torch`` call. **On** (:func:`enable`), each span

* keeps a :class:`Record` in memory: its name, thread, parent span, request
  id and ``time.perf_counter_ns()`` start and end, in a buffer of
  :data:`CAPACITY` records (the oldest dropped, and counted: :func:`dropped`);
* opens a ``torch.profiler.record_function`` range ``<prefix><name>``, so
  that under a running profiler the span sits on the device trace's own
  clock beside the kernels launched inside it.

:func:`profiler_range` opens the range alone, for sections too many to keep
(each kernel wrapper's launches, ``ops/_build.launch``); :func:`mark` keeps
a record alone, for a wait that starts on one thread and ends on another (a
service job's time in the queue).

A request id ties the spans of one call together: :func:`request` sets it
for a ``Separator.separate`` / ``separate_batch`` call or a service job, in a
``contextvars.ContextVar``, so every span of that call on that thread
carries it; a call inside a job keeps the job's id.

``utils/profiling.device_trace`` (``Separator(trace_dir=...)``, the CLI's
``--trace_dir``, ``AUDIO_SEPARATOR_TRACE``) turns spans on for the call it
traces, so the Chrome trace it writes shows the program's layers. Nothing
else writes records out: a caller reads them with :func:`records`.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import threading
import time
import uuid
from typing import List, NamedTuple, Optional

__all__ = ["Record", "span", "profiler_range", "mark", "request", "enable", "disable", "enabled",
           "records", "dropped", "clear"]

CAPACITY = 65536
DEFAULT_PREFIX = "asep."


class Record(NamedTuple):
    name: str
    thread: int              # threading.get_ident() of the thread that closed it
    span_id: int
    parent: Optional[int]    # span_id of the span open around it on its thread
    request: Optional[str]
    start_ns: int            # time.perf_counter_ns()
    end_ns: int
    attrs: dict


_ON = False
_prefix = DEFAULT_PREFIX
_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_buffer: collections.deque = collections.deque(maxlen=CAPACITY)
_dropped = 0
_ids = itertools.count(1)
_current: contextvars.ContextVar = contextvars.ContextVar("tracing_span", default=None)
_request: contextvars.ContextVar = contextvars.ContextVar("tracing_request", default=None)


def _keep(record: Record) -> None:
    global _dropped
    with _lock:
        if len(_buffer) == _buffer.maxlen:
            _dropped += 1
        _buffer.append(record)


class _Span:
    __slots__ = ("name", "attrs", "span_id", "parent", "token", "range", "start")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        import torch

        self.span_id = next(_ids)
        self.parent = _current.get()
        self.token = _current.set(self.span_id)
        self.range = torch.profiler.record_function(_prefix + self.name)
        self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.range.__exit__(*exc)
        _current.reset(self.token)
        _keep(Record(self.name, threading.get_ident(), self.span_id, self.parent,
                     _request.get(), self.start, end, self.attrs))
        return False


def span(name: str, **attrs):
    """``with span("<layer>.<part>", **attrs):`` a record and a profiler
    range while spans are on; the shared null context while they are off."""
    if not _ON:
        return _NULL
    return _Span(name, attrs)


def profiler_range(name: str):
    """The profiler range ``<prefix><name>`` alone, without a record, while
    spans are on; the shared null context while they are off."""
    if not _ON:
        return _NULL
    import torch

    return torch.profiler.record_function(_prefix + name)


def mark(name: str, start_ns: int, end_ns: Optional[int] = None, **attrs) -> None:
    """Keep a record of ``name`` from ``start_ns`` to ``end_ns`` (now if not
    given), ``time.perf_counter_ns()`` times, under the innermost open span
    and the current request; no profiler range. A no-op while spans are off."""
    if not _ON:
        return
    end = time.perf_counter_ns() if end_ns is None else end_ns
    _keep(Record(name, threading.get_ident(), next(_ids), _current.get(), _request.get(),
                 int(start_ns), int(end), attrs))


@contextlib.contextmanager
def _request_scope(request_id: str):
    token = _request.set(request_id)
    try:
        yield request_id
    finally:
        _request.reset(token)


def request(request_id: Optional[str] = None):
    """``with request(rid):`` the spans inside carry ``rid``; without an id,
    a new one unless a request is already current (a ``separate`` inside a
    service job keeps the job's). The shared null context while spans are
    off."""
    if not _ON:
        return _NULL
    if request_id is None:
        if _request.get() is not None:
            return _NULL
        request_id = uuid.uuid4().hex
    return _request_scope(request_id)


def enable(range_prefix: str = DEFAULT_PREFIX) -> None:
    """Turn spans on; their profiler ranges are named ``<range_prefix><name>``."""
    global _ON, _prefix
    with _lock:
        _prefix = range_prefix
        _ON = True


def disable() -> None:
    """Turn spans off; the records kept so far stay until :func:`clear`."""
    global _ON
    _ON = False


def enabled() -> bool:
    return _ON


def records(since_ns: Optional[int] = None) -> List[Record]:
    """The kept records in the order they ended; with ``since_ns``, those
    that started at or after it."""
    with _lock:
        kept = list(_buffer)
    if since_ns is None:
        return kept
    return [r for r in kept if r.start_ns >= since_ns]


def dropped() -> int:
    """Records dropped from a full buffer since the last :func:`clear`."""
    return _dropped


def clear() -> None:
    """Forget every kept record and the count of drops."""
    global _dropped
    with _lock:
        _buffer.clear()
        _dropped = 0
