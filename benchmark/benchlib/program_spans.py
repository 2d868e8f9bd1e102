"""The program's own spans in a traced run (``utils/tracing.py`` of the
port): every reader of them calls :func:`install`, which turns them on under
the harness's range prefix before set-up. ``benchlib/trace.py`` then names
each idle gap by the innermost open span, the program's included, and
attributes device time to the program's ``kernel.<name>`` ranges in
``Summary.span_device_s``, beside the probes' names.

``torch.profiler`` records the ranges of the thread that starts it and of
the threads that inherit its state (autograd's), not those of threads of
their own: the service's worker and handler threads. A reader of the
service's spans installs with ``all_threads``, which has every profile
started afterwards record all threads (``profile_all_threads``, where this
torch has it), as the song and fine-tune cells' main thread is recorded.

A checkout whose program has no spans (an older commit) has no such module:
:func:`install` then does nothing, and every reader of the spans returns
None."""

from __future__ import annotations

import importlib

from .trace import SPAN_PREFIX

MODULE = "audio_separator_tpu_torch.utils.tracing"

_tracing = None
_all_threads = False


def install(ctx, all_threads: bool = False) -> None:
    """Turn the program's spans on (once), their ranges named
    ``<SPAN_PREFIX><name>``; with ``all_threads``, record every thread's
    ranges in the traced window (the module docstring)."""
    global _tracing
    if all_threads:
        _profile_all_threads()
    if _tracing is not None:
        return
    try:
        module = importlib.import_module(MODULE)
    except ModuleNotFoundError as exc:
        if exc.name != MODULE:
            raise
        return
    module.enable(range_prefix=SPAN_PREFIX)
    _tracing = module


def _profile_all_threads() -> None:
    global _all_threads
    if _all_threads:
        return
    import torch.profiler
    from torch._C._profiler import _ExperimentalConfig

    try:
        _ExperimentalConfig(profile_all_threads=True)
    except TypeError:  # a torch without the option: the main thread's ranges only
        return
    base = torch.profiler.profile

    class profile(base):
        def __init__(self, *args, experimental_config=None, **kwargs):
            if experimental_config is None:
                experimental_config = _ExperimentalConfig(profile_all_threads=True)
            super().__init__(*args, experimental_config=experimental_config, **kwargs)

    torch.profiler.profile = profile
    _all_threads = True


def window_records(ctx, name: str):
    """The program's records named ``name`` that ended inside the closed
    window (both clocks are ``time.perf_counter``); None without spans or a
    window."""
    win = ctx.window
    if _tracing is None or win is None or win.seconds is None:
        return None
    t0, t1 = win.t0 * 1e9, win.t1 * 1e9
    return [r for r in _tracing.records() if r.name == name and t0 <= r.end_ns <= t1]


def idle_ms(ctx, *layers: str):
    """Milliseconds of the traced window's idle gaps named by a program span
    of one of ``layers`` (``<layer>.<part>``); None without spans or a
    trace."""
    summary = ctx.window.summary if ctx.window is not None else None
    if _tracing is None or summary is None:
        return None
    prefixes = tuple(f"{layer}." for layer in layers)
    return 1000.0 * sum(s for name, s in summary.idle_gaps if name.startswith(prefixes))
