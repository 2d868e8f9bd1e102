"""Plain training steps, the reference the fine-tune cell is judged against.

The loss is upstream ``bs_roformer.py``'s: the L1 between output and target
plus, for each window size, the L1 between their complex STFTs (``n_fft =
max(window, 2048)``, a Hann window of the window size, hop 147, not
normalised). The optimizer is ``torch.optim.Adam`` with the step's settings.

``float8_products`` computes every product in fp8 instead: inside it, the
inputs of each matrix product are scaled to their largest magnitude, rounded
to ``float8_e4m3fn`` and back, and multiplied in float32. That is the control
for a bf16 configuration (one precision step below).
"""

from __future__ import annotations

import contextlib
import statistics

import torch

E4M3_MAX = 448.0


def roformer_loss(recon, target, window_sizes=(4096, 2048, 1024, 512, 256), n_fft=2048,
                  hop=147):
    target = target[..., : recon.shape[-1]]
    loss = (recon - target).abs().mean()
    r = recon.reshape(-1, recon.shape[-1])
    t = target.reshape(-1, target.shape[-1])
    for w in window_sizes:
        kw = dict(n_fft=max(w, n_fft), hop_length=hop, win_length=w, return_complex=True,
                  window=torch.hann_window(w, device=recon.device), normalized=False)
        loss = loss + (torch.stft(r, **kw) - torch.stft(t, **kw)).abs().mean()
    return loss


def _fp8(x):
    if not torch.is_tensor(x) or not x.is_floating_point():
        return x
    scale = x.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
    q = (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach()  # rounded forward, straight-through backward


@contextlib.contextmanager
def float8_products():
    """Round both inputs of every product of the RoFormer reference to fp8
    (per-tensor scale) while the block runs."""
    from . import roformer

    roformer.ROUND_PRODUCT_INPUTS = _fp8
    try:
        yield
    finally:
        roformer.ROUND_PRODUCT_INPUTS = None


def leaf_norms(tensors: dict, groups: dict) -> dict:
    """``{leaf: norm}`` over the program's leaves, each the norm of the
    reference tensors (or row ranges of them) that make it up."""
    out = {}
    for leaf, parts in groups.items():
        sq = 0.0
        for key, rows in parts:
            t = tensors[key]
            t = t if rows is None else t[rows[0] : rows[1]]
            sq += float(t.double().pow(2).sum())
        out[leaf] = sq ** 0.5
    return out


def worst_leaf_gap(program: dict, reference: dict, ref_grad: dict, floor: bool = True) -> tuple:
    """``(gap, leaf)``: the largest ``|program − reference|`` of a leaf's norm
    over the larger of the reference's norm of that leaf and of the median
    leaf (``floor=False``: over the leaf's own). Leaves whose reference
    gradient is under a thousandth of the median leaf's are left out (they
    move by round-off alone).

    The median floor is the check's rule for leaves whose gradient is all
    but zero: a bf16 step's error in a leaf is set by the rounding of the
    products and sums that feed it, not by the leaf's own norm. The gap over
    each leaf's own norm is recorded beside it."""
    median_grad = statistics.median(ref_grad.values())
    kept = [k for k in reference if ref_grad[k] >= 1e-3 * median_grad]
    median = statistics.median(reference[k] for k in kept) if floor else 0.0
    worst, where = 0.0, None
    for k in kept:
        gap = abs(program[k] - reference[k]) / max(reference[k], median, 1e-300)
        if gap > worst:
            worst, where = gap, k
    return worst, where
