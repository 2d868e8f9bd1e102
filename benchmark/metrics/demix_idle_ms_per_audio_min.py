"""The card's idle milliseconds in the traced window's gaps that the
program's ``separate.*``, ``demix.*`` and ``kernel.*`` spans name (the
separation's host work; a gap is named by the innermost span open at its
midpoint, ``benchlib/trace.py``), per minute of input audio; the reader of
every ``demix_idle_ms_per_audio_min.<part>``."""

from benchlib import program_spans


def install(ctx):
    program_spans.install(ctx)


def read(ctx):
    audio_s = ctx.extras.get("audio_s")
    idle = program_spans.idle_ms(ctx, "separate", "demix", "kernel")
    if not audio_s or idle is None:
        return None
    return idle / (audio_s / 60.0)
