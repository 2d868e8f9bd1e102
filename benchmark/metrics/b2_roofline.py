"""B2's share of its roofline: Σ bound over Σ device time of the fused
feed-forward block's calls in the traced window (``counts/b2.py``), probed
around ``models.roformer.fused_ff_block``. The rows counted are the valid
ones: where the thread's last B1 call (``b1_roofline``'s probe) had the same
input shape, its ``n_valid`` of each sequence; otherwise every row."""

from benchlib import probes, readers

NAME = "b2"


def _record(x, ff_norm, w1, b1, w2, b2, **kw):
    weights = sum(t.numel() * t.element_size() for t in (ff_norm, w1, b1, w2)
                  if t is not None) + (b2.numel() * b2.element_size() if b2 is not None else 0)
    batch, n_pad, dim = x.shape
    attn = probes.get("b1")
    last = attn.last() if attn is not None else None
    n_valid = (last["n_valid"] if last and (last["batch"], last["n_pad"]) == (batch, n_pad)
               else n_pad)
    return {"rows": batch * n_valid, "padded_rows": batch * n_pad, "dim": dim,
            "hidden": w1.shape[-1], "itemsize": x.element_size(), "weight_bytes": weights}


def install(ctx):
    probes.install(NAME, "audio_separator_tpu_torch.models.roformer", "fused_ff_block", _record)


def read(ctx):
    return readers.roofline(ctx, NAME, "b2")
