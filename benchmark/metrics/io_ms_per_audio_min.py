"""Host milliseconds inside the program's audio decode and encode
(``io.audio.load_audio`` and ``io.audio.save_audio``, which the separators
call through the module) per minute of input audio in the traced window;
the reader of every ``io_ms_per_audio_min.<part>``."""

from benchlib import probes


def install(ctx):
    probes.install("load_audio", "audio_separator_tpu_torch.io.audio", "load_audio")
    probes.install("save_audio", "audio_separator_tpu_torch.io.audio", "save_audio")


def read(ctx):
    audio_s = ctx.extras.get("audio_s")
    load, save = probes.get("load_audio"), probes.get("save_audio")
    if not audio_s or load is None or save is None or not (load.count or save.count):
        return None
    return 1000.0 * (load.host_s + save.host_s) / (audio_s / 60.0)
