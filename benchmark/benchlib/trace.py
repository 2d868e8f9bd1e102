"""The traced window: ``torch.profiler`` over the whole measured window, and
its reduction to the numbers the per-layer readers and the result line use.

The reduction reads the profiler's raw events (``kineto_results.events()``)
rather than its aggregated tables:

* device intervals: every kernel, copy and fill on the card. ``busy_s`` is
  the length of their union, ``window_s`` the traced window's;
* the host's spans: ``record_function`` ranges named ``bench.<name>`` that
  the harness opens around its own calls and around the program's entry
  points (``benchlib/probes.py``), each on its thread;
* launches: the runtime and driver API events that start device work, tied
  to their device event by the correlation id. A device event belongs to a
  span when its launch lies inside an instance of that span on the same
  thread, which is how a kernel's device time is attributed to the entry
  point that launched it;
* idle gaps: the stretches between device intervals, each named by the
  innermost span that holds its midpoint (``host`` where none does).

The device-time union follows the profiled-call arithmetic of the
repository's ``chip_smoke.py`` (``profile_separate``), over a whole window
rather than one call.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass

import torch

SPAN_PREFIX = "bench."

_LAUNCH_WORDS = ("launch", "memcpy", "memset")


def short_name(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return name.split("(")[0].split("<")[0][:96]


@contextlib.contextmanager
def span(name: str, enabled: bool):
    """A ``bench.<name>`` range in the trace when ``enabled``."""
    if not enabled:
        yield
        return
    with torch.profiler.record_function(SPAN_PREFIX + name):
        yield


@dataclass
class Summary:
    window_s: float
    busy_s: float
    device_ops: list     # [[kernel name, seconds]] by total device time
    idle_gaps: list      # [[host span, seconds]] by total idle time
    span_device_s: dict  # {span: device seconds of the work launched inside it}

    def breakdown(self) -> dict:
        return {"device_ops": self.device_ops[:10], "idle_gaps": self.idle_gaps[:10]}


def _union(intervals):
    total, merged = 0, []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    for s, e in merged:
        total += e - s
    return total, merged


def _sweep(spans_by_thread, points_by_thread):
    """For each thread's sorted query points, the stack of spans (names,
    outermost first, with their starts) open at that point. Spans on one
    thread nest, so one stack a thread holds them. Yields ``(point, stack)``
    in each thread's point order."""
    for tid, points in points_by_thread.items():
        edges = []
        for s, e, name in spans_by_thread.get(tid, ()):
            edges.append((s, 1, name))
            edges.append((e, 0, name))
        edges.sort(key=lambda x: (x[0], x[1]))
        stack, i = [], 0
        for point, payload in points:
            while i < len(edges) and edges[i][0] <= point:
                t, opening, name = edges[i]
                if opening:
                    stack.append((t, name))
                else:
                    for j in range(len(stack) - 1, -1, -1):
                        if stack[j][1] == name:
                            del stack[j]
                            break
                i += 1
            yield point, payload, stack


def _is_annotation(e) -> bool:
    return e.name().startswith(SPAN_PREFIX) or (
        hasattr(e, "is_user_annotation") and e.is_user_annotation())


def reduce_events(events, start_ns, window_ns) -> Summary:
    """Reduce the profiler's raw events over the window ``[start_ns,
    start_ns + window_ns)`` of the profiler's clock."""
    device, launches = [], {}
    spans = defaultdict(list)   # tid -> [(start, end, name)]
    for e in events:
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            dur = e.duration_ns()
            if dur > 0 and not _is_annotation(e):  # the ranges' device-side copies are no work
                device.append((e.start_ns(), e.start_ns() + dur, name, e.correlation_id()))
            continue
        if name.startswith(SPAN_PREFIX):
            s = e.start_ns()
            spans[e.start_thread_id()].append((s, s + e.duration_ns(), name[len(SPAN_PREFIX):]))
            continue
        low = name.lower()
        if low.startswith(("cuda", "cu")) and any(w in low for w in _LAUNCH_WORDS):
            launches[e.correlation_id()] = (e.start_thread_id(), e.start_ns())

    busy_ns, merged = _union([(s, e) for s, e, _, _ in device])
    by_name, span_device = defaultdict(int), defaultdict(int)
    launched = defaultdict(list)  # tid -> [(launch time, device ns)]
    for s, e, name, corr in device:
        by_name[short_name(name)] += e - s
        launch = launches.get(corr)
        if launch is not None:
            launched[launch[0]].append((launch[1], e - s))
    for points in launched.values():
        points.sort()
    for _, dur, stack in _sweep(spans, launched):
        for span_name in {name for _, name in stack}:
            span_device[span_name] += dur

    # Idle gaps between device intervals, named by the innermost span open at
    # the gap's midpoint on any thread (the latest-opened), else "host".
    cuts = [start_ns] + [x for iv in merged for x in iv] + [start_ns + window_ns]
    mids = [((s + e) // 2, e - s) for s, e in zip(cuts[0::2], cuts[1::2]) if e > s]
    innermost = {}
    for tid in spans:
        for mid, dur, stack in _sweep(spans, {tid: mids}):
            if stack and (mid not in innermost or stack[-1][0] > innermost[mid][0]):
                innermost[mid] = stack[-1]
    gaps = defaultdict(int)
    for mid, dur in mids:
        gaps[innermost[mid][1] if mid in innermost else "host"] += dur

    def ranked(d):
        return [[k, v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])]

    return Summary(window_s=window_ns / 1e9, busy_s=busy_ns / 1e9,
                   device_ops=ranked(by_name), idle_gaps=ranked(gaps),
                   span_device_s={k: v / 1e9 for k, v in span_device.items()})


class Window:
    """The measured window: ``with Window(trace) as w: ...``; ``w.seconds``
    after it, and ``w.summary`` when traced. The card is synchronised at both
    ends, so the window holds all the device work of the calls inside it."""

    def __init__(self, trace: bool, device_sync=None):
        self.trace = trace
        self.sync = device_sync or (lambda: None)
        self.summary = None
        self.seconds = None
        self._prof = None

    def __enter__(self):
        self.sync()
        if self.trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def close(self):
        """End the window now (the driver calls this at its boundary)."""
        if self.seconds is not None:
            return
        self.sync()
        self.t1 = time.perf_counter()
        self.seconds = self.t1 - self.t0
        if self._prof is not None:
            self._prof.__exit__(None, None, None)
            results = self._prof.profiler.kineto_results
            events = results.events()
            start = (results.trace_start_ns() if hasattr(results, "trace_start_ns")
                     else min((e.start_ns() for e in events), default=0))
            self.summary = reduce_events(events, start, int(self.seconds * 1e9))
            self._prof = None

    def __exit__(self, *exc):
        self.close()
        return False
