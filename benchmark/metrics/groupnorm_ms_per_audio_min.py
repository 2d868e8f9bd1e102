"""Device milliseconds of the work launched inside the program's GroupNorm
spans (``kernel.group_norm`` of ``ops/group_norm.py``, one a launch;
``Summary.span_device_s``) in the traced window, per minute of input audio;
the reader of every ``groupnorm_ms_per_audio_min.<part>``. A program without
that span gives None."""

from benchlib import program_spans

SPAN = "kernel.group_norm"


def install(ctx):
    program_spans.install(ctx)


def device_s(ctx):
    """Seconds of device work the window's trace attributes to the span;
    None without a trace or where it launched nothing."""
    summary = ctx.window.summary if ctx.window is not None else None
    if summary is None:
        return None
    seconds = summary.span_device_s.get(SPAN, 0.0)
    return seconds if seconds > 0 else None


def read(ctx):
    audio_s = ctx.extras.get("audio_s")
    seconds = device_s(ctx)
    if not audio_s or seconds is None:
        return None
    return 1000.0 * seconds / (audio_s / 60.0)
