"""K1's bf16 form's share of its roofline: Σ bound over Σ device time of the
gated bf16 attention backward's calls in the traced window
(``counts/k1_bf16.py``), probed around ``ops.block_backward.attention_backward``
(the blocks' backward pass calls it on autograd's thread). Calls in another
type or without gates are not this kernel's and are not recorded."""

from benchlib import probes, readers

NAME = "k1"


def _record(q, k, v, o, do, scale, n_valid=None, gates=None):
    if gates is None or q.element_size() != 2:
        return None
    b, h, n, d = q.shape
    return {"batch": b, "heads": h, "n_pad": n, "n_valid": int(n_valid or n), "dh": d,
            "itemsize": q.element_size()}


def install(ctx):
    probes.install(NAME, "audio_separator_tpu_torch.ops.block_backward", "attention_backward",
                   _record)


def read(ctx):
    return readers.roofline(ctx, NAME, "k1_bf16")
