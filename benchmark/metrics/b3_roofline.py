"""B3's share of its roofline: Σ bound over Σ device time of the attention
calls in the traced window (``counts/b3.py``), probed around
``models.htdemucs.dot_product_attention``."""

from benchlib import probes, readers

NAME = "b3"


def _record(q, k, v, scale=None):
    b, h, nq, d = q.shape
    return {"batch": b, "heads": h, "n_q": nq, "n_k": k.shape[2], "dh": d,
            "itemsize": q.element_size()}


def install(ctx):
    probes.install(NAME, "audio_separator_tpu_torch.models.htdemucs", "dot_product_attention",
                   _record)


def read(ctx):
    return readers.roofline(ctx, NAME, "b3")
