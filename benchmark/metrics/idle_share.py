"""The device's idle share of the traced window, the reader of every
``idle_share.<part>``: 100 × (1 − the union of its kernel, copy and fill
intervals over the window's length)."""

from benchlib import readers


def read(ctx):
    return readers.idle_share(ctx)
