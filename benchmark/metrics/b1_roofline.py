"""B1's share of its roofline: Σ bound over Σ device time of the fused
attention block's calls in the traced window (``counts/b1.py``), the device
time being that of the kernels launched inside the probe's range around
``models.roformer.fused_attention_block``."""

from benchlib import probes, readers

NAME = "b1"


def _record(x, wqkv, gate_w, gate_b, wo, attn_norm, rope, heads, n_valid, **kw):
    weights = sum(t.numel() * t.element_size() for t in (wqkv, gate_w, gate_b, wo, attn_norm))
    return {"batch": x.shape[0], "n_pad": x.shape[1], "n_valid": int(n_valid),
            "dim": x.shape[2], "inner": wo.shape[0], "heads": int(heads),
            "itemsize": x.element_size(), "weight_bytes": weights}


def install(ctx):
    probes.install(NAME, "audio_separator_tpu_torch.models.roformer", "fused_attention_block",
                   _record)


def read(ctx):
    return readers.roofline(ctx, NAME, "b1")
