"""The median job's milliseconds by the clients' own clock: upload start to
the last stem downloaded, over the jobs completed in the window."""

import statistics


def read(ctx):
    jobs = ctx.extras.get("job_ms")
    return statistics.median(jobs) if jobs else None
