"""The fine-tune's model FLOP utilisation: the forward and backward
operations of the plain reference's step at the cell's batch
(``torch.utils.flop_counter``), times the window's steps, over the window's
wall time at the bf16 peak."""

from benchlib import peaks, readers


def read(ctx):
    return readers.mfu(ctx, "flops_per_step", "steps", peaks.BF16_FLOPS)
