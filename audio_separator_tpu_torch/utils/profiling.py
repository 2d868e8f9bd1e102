"""Optional device tracing.

:func:`device_trace` — a ``torch.profiler`` trace of the enclosed work,
written as a Chrome trace (``trace_<pid>_<ns>.json``, loadable in Perfetto or
``chrome://tracing``) into ``trace_dir`` or ``AUDIO_SEPARATOR_TRACE``; a
no-op when neither is set. It turns the program's spans on for the traced
call (``utils/tracing.py``), so the trace shows the program's layers
(``asep.separate.prepare``, ``asep.demix.batch``, ``asep.kernel.<name>``, ...)
beside the kernels they launched.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Optional

from . import tracing

__all__ = ["device_trace"]


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str] = None,
                 logger: Optional[logging.Logger] = None):
    """Optionally capture a ``torch.profiler`` trace (host and, with a CUDA
    device, the card) of the enclosed work into ``trace_dir`` or
    ``AUDIO_SEPARATOR_TRACE``, with the program's spans on; otherwise a
    no-op. Spans already on (another caller's) stay on, under their prefix."""
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
    was_on = tracing.enabled()
    if not was_on:
        tracing.enable()
    try:
        with profile(activities=activities) as prof:
            yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        if not was_on:
            tracing.disable()
    prof.export_chrome_trace(path)
