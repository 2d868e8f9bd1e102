"""The GroupNorm kernel's share of its roofline, the reader of every
``groupnorm_roofline.<part>``: 100 × Σ bound over Σ device time of the
program's ``kernel.group_norm`` spans in the traced window, each span
record's bytes from its attributes (``counts/group_norm.py``; float32, the
kernel's only type) at the memory rate of ``benchlib/peaks.bound_s``. A
program without that span gives None."""

from benchlib import manifest, peaks, program_spans

ms_reader = manifest.plugin("metrics", "groupnorm_ms_per_audio_min")
ITEMSIZE = 4


def install(ctx):
    program_spans.install(ctx)


def read(ctx):
    seconds = ms_reader.device_s(ctx)
    records = program_spans.window_records(ctx, ms_reader.SPAN)
    if seconds is None or not records:
        return None
    count = manifest.plugin("counts", "group_norm").count
    bound = sum(peaks.bound_s(*count(**r.attrs, itemsize=ITEMSIZE), ITEMSIZE) for r in records)
    return 100.0 * bound / seconds
