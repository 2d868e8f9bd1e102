"""Device milliseconds of the work launched inside the program's band-stage
spans (``kernel.band_split``, ``kernel.mask_estimate`` and
``kernel.band_merge`` of ``models/roformer.py``; ``Summary.span_device_s``)
in the traced window, per minute of input audio; the reader of every
``band_ms_per_audio_min.<part>``. A program without those spans gives
None."""

from benchlib import program_spans

STAGES = ("kernel.band_split", "kernel.mask_estimate", "kernel.band_merge")


def install(ctx):
    program_spans.install(ctx)


def device_s(ctx):
    """Seconds of device work the window's trace attributes to the three
    spans; None without a trace or where they launched nothing."""
    summary = ctx.window.summary if ctx.window is not None else None
    if summary is None:
        return None
    total = sum(summary.span_device_s.get(name, 0.0) for name in STAGES)
    return total if total > 0 else None


def read(ctx):
    audio_s = ctx.extras.get("audio_s")
    seconds = device_s(ctx)
    if not audio_s or seconds is None:
        return None
    return 1000.0 * seconds / (audio_s / 60.0)
