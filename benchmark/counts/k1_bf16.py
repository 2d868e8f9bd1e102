"""K1 in bf16, the gated attention backward (``ops/attention.attention_backward``
with ``gates``): 2.5 × the forward's ``4 · B · H · N² · D`` over the
``n_valid`` keys and rows (the recomputed scores, dP, and the dQ, dK and dV
products). Bytes: q, k, v, the merged output and its gradient read, the
float32 gates read; dq, dk, dv and the float32 row sums Δ written."""


def count(batch: int, heads: int, n_pad: int, n_valid: int, dh: int, itemsize: int) -> tuple:
    ops = 2.5 * 4 * batch * heads * n_valid * n_valid * dh
    head_tensor = batch * heads * n_pad * dh * itemsize
    per_row = batch * heads * n_pad * 4
    nbytes = 5 * head_tensor + per_row + 3 * head_tensor + per_row
    return ops, nbytes
