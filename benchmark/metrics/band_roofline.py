"""The band stages' share of their roofline, the reader of every
``band_roofline.<part>``: 100 × Σ bound over Σ device time of the program's
``kernel.band_split``, ``kernel.mask_estimate`` and ``kernel.band_merge``
spans in the traced window, each span record's operations and bytes from its
attributes and the configuration (``counts/bands.py``), at the peaks of
``benchlib/peaks.bound_s`` for the cell's type, as for B1 and B2. A program
without those spans gives None."""

from benchlib import manifest, peaks, program_spans

ms_reader = manifest.plugin("metrics", "band_ms_per_audio_min")


def install(ctx):
    program_spans.install(ctx)


def read(ctx):
    seconds = ms_reader.device_s(ctx)
    if seconds is None:
        return None
    records = []
    for name in ms_reader.STAGES:
        records += program_spans.window_records(ctx, name) or []
    if not records:
        return None
    bands = manifest.plugin("counts", "bands")
    sizes = bands.model_sizes(ctx.cell.config["yaml"]["model"])
    itemsize = 2 if ctx.cell.autocast() else 4
    bound = sum(peaks.bound_s(*bands.count(r.name.split(".", 1)[1], **r.attrs, **sizes,
                                           itemsize=itemsize), itemsize)
                for r in records)
    return 100.0 * bound / seconds
