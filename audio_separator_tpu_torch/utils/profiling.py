"""Structured timing and optional device tracing.

Port of ``audio_separator_tpu/utils/profiling.py``:

* :class:`PhaseTimer` — named wall-clock phase accounting with a
  machine-readable summary;
* :func:`device_trace` — a ``torch.profiler`` trace of the enclosed work,
  written as a Chrome trace (``trace_<pid>_<ns>.json``, loadable in Perfetto or
  ``chrome://tracing``) into ``trace_dir`` or ``AUDIO_SEPARATOR_TRACE``; a
  no-op when neither is set.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Dict, Optional

__all__ = ["PhaseTimer", "device_trace"]


class PhaseTimer:
    """Accumulates named wall-clock phases.

    Usage::

        timer = PhaseTimer(logger)
        with timer.phase("demix"):
            ...
        logger.info(timer.summary())
    """

    def __init__(self, logger: Optional[logging.Logger] = None):
        self.logger = logger
        self.durations: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.durations[name] = self.durations.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
            if self.logger:
                self.logger.debug(f"phase {name}: {dt*1e3:.1f} ms")

    def summary(self) -> str:
        total = sum(self.durations.values())
        parts = [f"{k}={v*1e3:.0f}ms" for k, v in sorted(
            self.durations.items(), key=lambda kv: -kv[1])]
        return f"phases: {' '.join(parts)} (total {total*1e3:.0f}ms)"

    def as_dict(self) -> Dict[str, float]:
        return dict(self.durations)

    def dump_json(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"durations_s": self.durations, "counts": self.counts}, f)


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str] = None,
                 logger: Optional[logging.Logger] = None):
    """Optionally capture a ``torch.profiler`` trace (host and, with a CUDA
    device, the card) of the enclosed work into ``trace_dir`` or
    ``AUDIO_SEPARATOR_TRACE``; otherwise a no-op."""
    target = trace_dir or os.environ.get("AUDIO_SEPARATOR_TRACE")
    if not target:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(target, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    path = os.path.join(target, f"trace_{os.getpid()}_{time.time_ns()}.json")
    if logger:
        logger.info(f"capturing torch profiler trace to {path}")
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
