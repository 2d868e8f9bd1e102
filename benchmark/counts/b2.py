"""B2, the fused feed-forward block (``ops/attention_block.fused_ff_block``):
RMSNorm, ``dim → hidden`` with GELU, ``hidden → dim``, the residual, over
``rows`` rows (the valid rows of the padded sequences). Bytes: ``x`` read and
the output written at the padded length, each weight read once."""


def count(rows: int, padded_rows: int, dim: int, hidden: int, itemsize: int,
          weight_bytes: int) -> tuple:
    ops = 2 * 2 * rows * dim * hidden
    nbytes = 2 * padded_rows * dim * itemsize + weight_bytes
    return ops, nbytes
