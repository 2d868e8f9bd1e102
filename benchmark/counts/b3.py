"""B3, attention over ``(B, H, N, D)`` heads (``ops/attention.dot_product_attention``):
scores and P·V, ``4 · B · H · Nq · Nk · D``. Bytes: q, k, v read, the output
written."""


def count(batch: int, heads: int, n_q: int, n_k: int, dh: int, itemsize: int) -> tuple:
    ops = 4 * batch * heads * n_q * n_k * dh
    nbytes = (2 * batch * heads * n_q * dh + 2 * batch * heads * n_k * dh) * itemsize
    return ops, nbytes
