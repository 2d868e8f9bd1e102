"""The card's idle milliseconds a fine-tune step: gaps of the traced window
that the program's ``train.*`` and ``kernel.*`` spans name (autograd launches
the backward's kernels from its own thread, inside their ``kernel.*``
ranges), over the window's optimizer steps."""

from benchlib import program_spans


def install(ctx):
    program_spans.install(ctx)


def read(ctx):
    steps = ctx.extras.get("steps")
    idle = program_spans.idle_ms(ctx, "train", "kernel")
    if not steps or idle is None:
        return None
    return idle / steps
