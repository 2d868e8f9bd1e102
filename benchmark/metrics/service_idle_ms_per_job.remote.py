"""The card's idle milliseconds a served job in the traced window's gaps
that the service's own spans name (``service.*``: upload, download, wait,
build, load_model, separate, store), over the jobs served in the window."""

from benchlib import program_spans


def install(ctx):
    program_spans.install(ctx, all_threads=True)  # the service's own threads


def read(ctx):
    jobs = ctx.extras.get("job_ms")
    idle = program_spans.idle_ms(ctx, "service")
    if not jobs or idle is None:
        return None
    return idle / len(jobs)
