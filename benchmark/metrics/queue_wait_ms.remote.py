"""The median job's wait in the service's queue, submit to a worker's
pick-up (the program's ``service.queue_wait`` records), over the jobs picked
up in the traced window, in milliseconds."""

import statistics

from benchlib import program_spans


def install(ctx):
    program_spans.install(ctx)


def read(ctx):
    waits = program_spans.window_records(ctx, "service.queue_wait")
    if not waits:
        return None
    return statistics.median(r.end_ns - r.start_ns for r in waits) / 1e6
