"""B1, the fused attention block (``ops/attention_block.fused_attention_block``):
RMSNorm, the QKV and gate products, rotary positions, attention over the
``n_valid`` keys, the gates and the out product, for the ``n_valid`` rows of
each of ``batch`` sequences. Bytes: ``x`` read and the output written at the
padded length, each weight and the rotary tables read once."""


def count(batch: int, n_pad: int, n_valid: int, dim: int, inner: int, heads: int,
          itemsize: int, weight_bytes: int) -> tuple:
    rows = batch * n_valid
    dh = inner // heads
    ops = (2 * rows * dim * 3 * inner          # QKV
           + 2 * rows * dim * heads             # gates
           + 4 * batch * heads * n_valid * n_valid * dh   # scores and P·V
           + 2 * rows * inner * dim)            # out
    nbytes = 2 * batch * n_pad * dim * itemsize + weight_bytes + 2 * n_pad * dh * 4
    return ops, nbytes
