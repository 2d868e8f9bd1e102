"""Host milliseconds inside the program's ``audio.decode`` and
``audio.encode`` spans (``io/audio.load_audio`` and ``save_audio``) that
ended in the traced window, per minute of input audio: the quantity of
``io_ms_per_audio_min``, measured inside the program; the reader of every
``codec_ms_per_audio_min.<part>``."""

from benchlib import program_spans


def install(ctx):
    program_spans.install(ctx)


def read(ctx):
    audio_s = ctx.extras.get("audio_s")
    decode = program_spans.window_records(ctx, "audio.decode")
    encode = program_spans.window_records(ctx, "audio.encode")
    if not audio_s or decode is None or not (decode or encode):
        return None
    return sum(r.end_ns - r.start_ns for r in decode + encode) / 1e6 / (audio_s / 60.0)
