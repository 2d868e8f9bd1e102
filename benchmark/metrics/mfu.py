"""The separation's model FLOP utilisation, the reader of every
``mfu.<part>`` without a file of its own (``mfu.train`` has one): the
operations of the windows the window's songs need (the reference's window
plan; a last batch's padding windows are waste and not counted), each
window's operations counted by ``torch.utils.flop_counter`` on the plain
reference, over the window's wall time at the TF32 peak."""

from benchlib import peaks, readers


def read(ctx):
    return readers.mfu(ctx, "flops_per_window", "windows", peaks.TF32_FLOPS)
