"""Separation quality metrics — museval (BSS Eval v4) conventions.

The port's own copy of ``audio_separator_tpu/utils/metrics.py``. It stays
numpy, in float64, with the same operations in the same order, so the port's
scores are bit-identical to the JAX package's (``tests/test_torch_metrics.py``).

The reference's quality numbers come from museval over MUSDB18HQ
(ref: tests/model-metrics/test-all-models.py:30-43, models-scores.json).
museval and musdb are not dependencies, so the BSS Eval v4 algorithm is
implemented here directly, following museval's published ``evaluate()``
conventions exactly so regenerated scores are comparable with the
reference's:

* **Images model** (``bsseval_sources_version=False``, museval's default):
  stems are multichannel images; ``s_true`` is the raw reference image and a
  spatial-distortion term ``e_spat`` (projection onto the target's own
  delayed channels minus ``s_true``) is split out. ISR is defined for mono
  too (single-channel delayed projection ≠ raw reference).
* **Time-invariant (global) distortion filters** (``framewise_filters=False``,
  i.e. museval mode='v4'): the 512-tap least-squares projection filters are
  computed ONCE over the full track; the four energy ratios are then computed
  framewise over the decomposed signals.
* **Framing**: 1 s windows, 1 s hop (museval ``win=hop=1*rate`` defaults);
  ``nwin = floor((nsampl - win + hop) / hop)`` (trailing partial window
  dropped). A frame in which ANY reference source is silent yields NaN for
  every metric of every source in that frame (singular projection), matching
  museval's ``_any_source_silent`` guard.
* **Aggregation**: nanmedian over frames (museval's per-track
  ``agg_frames``); models-scores.json's ``median_scores`` are exactly this.

The implementation is validated against a brute-force explicit-design-matrix
oracle in tests/test_metrics.py and tests/test_torch_metrics.py (same
decomposition computed by ``np.linalg.lstsq`` over explicitly delayed copies)
and against analytic cases (short-FIR-filtered targets ⇒ zero
interference/artifacts).

:func:`simple_sdr` is the plain global (scale-variant) SDR for golden-output
tests.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
from numpy.fft import irfft, rfft


def simple_sdr(estimate: np.ndarray, reference: np.ndarray, eps: float = 1e-10) -> float:
    """Plain global SDR in dB (no filters, scale-variant):
    10 log10(||ref||² / ||ref − est||²)."""
    reference = np.asarray(reference, dtype=np.float64)
    estimate = np.asarray(estimate, dtype=np.float64)
    n = min(reference.shape[-1], estimate.shape[-1])
    reference = reference[..., :n]
    estimate = estimate[..., :n]
    num = np.sum(reference ** 2)
    den = np.sum((reference - estimate) ** 2)
    return float(10.0 * np.log10((num + eps) / (den + eps)))


# ---------------------------------------------------------------------------
# BSS Eval v4 projections (global/time-invariant distortion filters)


def _correlations(refs: np.ndarray, flen: int):
    """Gram matrix of delayed rows plus the row spectra for cross terms.

    refs: (nrow, n). Returns (G, sf, nfft) where G is the (nrow*flen,
    nrow*flen) block-Toeplitz Gram of all flen-delayed copies of every row
    (inner products over the zero-padded support, i.e. linear correlation)
    and sf are the length-nfft rFFTs of the rows.
    """
    nrow, n = refs.shape
    nfft = 1 << int(np.ceil(np.log2(n + flen)))
    sf = rfft(refs, n=nfft)

    G = np.empty((nrow * flen, nrow * flen))
    lags = np.subtract.outer(np.arange(flen) * -1, np.arange(flen) * -1)
    for i in range(nrow):
        for j in range(i, nrow):
            cij = irfft(sf[i] * np.conj(sf[j]), n=nfft)
            # toeplitz: entry (a,b) = <row_i delayed a, row_j delayed b>
            #         = c_ij[b - a] with wraparound negative lags at end
            block = cij[lags % nfft]
            G[i * flen : (i + 1) * flen, j * flen : (j + 1) * flen] = block
            if j > i:
                G[j * flen : (j + 1) * flen, i * flen : (i + 1) * flen] = block.T
    return G, sf, nfft


def _cross(sf: np.ndarray, est: np.ndarray, flen: int, nfft: int) -> np.ndarray:
    """D[(i,a)] = <row_i delayed by a, est> for every row spectrum in sf."""
    nrow = sf.shape[0]
    ef = rfft(est, n=nfft)
    D = np.empty(nrow * flen)
    for i in range(nrow):
        ci = irfft(np.conj(sf[i]) * ef, n=nfft)
        D[i * flen : (i + 1) * flen] = ci[:flen]
    return D


def _solve(G: np.ndarray, D: np.ndarray) -> np.ndarray:
    """museval-style solve: exact when well-posed, lstsq on singularity."""
    try:
        coeffs = np.linalg.solve(G, D)
        if not np.all(np.isfinite(coeffs)):
            raise np.linalg.LinAlgError
        return coeffs
    except np.linalg.LinAlgError:
        return np.linalg.lstsq(G, D, rcond=None)[0]


def _filter_sum(refs: np.ndarray, coeffs: np.ndarray, flen: int, out_len: int) -> np.ndarray:
    """Σ_i conv(coeffs_i, refs_i), truncated/padded to out_len."""
    out = np.zeros(out_len)
    coeffs = coeffs.reshape(refs.shape[0], flen)
    for i in range(refs.shape[0]):
        c = np.convolve(coeffs[i], refs[i])
        out[: min(len(c), out_len)] += c[:out_len]
    return out


def _decompose_images(
    refs_flat: np.ndarray,  # (nsrc*nchan, n) all reference channels
    G: np.ndarray,
    sf: np.ndarray,
    nfft: int,
    est_img: np.ndarray,  # (nchan, n) the estimate for source j
    j: int,
    nchan: int,
    flen: int,
):
    """BSS Eval v4 images decomposition for source ``j`` with global filters.

    Per estimate channel c:
      s_true   = ref_j[c] zero-padded by flen-1     (the raw target image)
      e_spat   = P_{ref_j channels}(est_c) − s_true (spatial distortion)
      e_interf = P_{all channels}(est_c) − P_{ref_j channels}(est_c)
      e_artif  = est_c (padded) − P_{all}(est_c)

    Returns four (nchan, n + flen − 1) arrays.
    """
    n = refs_flat.shape[1]
    out_len = n + flen - 1
    rows_j = slice(j * nchan, (j + 1) * nchan)
    idx_j = np.arange(j * nchan * flen, (j + 1) * nchan * flen)
    G_j = G[np.ix_(idx_j, idx_j)]

    s_true = np.zeros((nchan, out_len))
    e_spat = np.empty((nchan, out_len))
    e_interf = np.empty((nchan, out_len))
    e_artif = np.empty((nchan, out_len))
    for c in range(nchan):
        D_all = _cross(sf, est_img[c], flen, nfft)
        p_all = _filter_sum(refs_flat, _solve(G, D_all), flen, out_len)
        p_j = _filter_sum(refs_flat[rows_j], _solve(G_j, D_all[idx_j]), flen,
                          out_len)
        s_true[c, :n] = refs_flat.reshape(-1, nchan, n)[j, c]
        e_spat[c] = p_j - s_true[c]
        e_interf[c] = p_all - p_j
        e_artif[c] = -p_all
        e_artif[c, :n] += est_img[c]
    return s_true, e_spat, e_interf, e_artif


def _frame_ratios(s_true, e_spat, e_interf, e_artif, sl) -> Dict[str, float]:
    """The four v4 energy ratios over one frame (sums over channels+samples)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        st = np.sum(s_true[:, sl] ** 2)
        sp = np.sum(e_spat[:, sl] ** 2)
        it = np.sum(e_interf[:, sl] ** 2)
        ar = np.sum(e_artif[:, sl] ** 2)
        sdr = 10 * np.log10(st / np.sum((e_spat + e_interf + e_artif)[:, sl] ** 2))
        isr = 10 * np.log10(st / sp)
        sir = 10 * np.log10(np.sum((s_true + e_spat)[:, sl] ** 2) / it)
        sar = 10 * np.log10(np.sum((s_true + e_spat + e_interf)[:, sl] ** 2) / ar)
    return {"SDR": float(sdr), "ISR": float(isr), "SIR": float(sir),
            "SAR": float(sar)}


def bss_eval_framewise(
    references: Sequence[np.ndarray],
    estimates: Sequence[np.ndarray],
    sample_rate: int = 44100,
    window_seconds: float = 1.0,
    hop_seconds: float = 1.0,
    filter_length: int = 512,
) -> List[Dict[str, List[float]]]:
    """Framewise BSS Eval v4 over (channels, samples) stems.

    Returns one dict per source: {"SDR", "ISR", "SIR", "SAR"} of per-frame
    values (NaN where any reference source is silent in the frame —
    museval's convention). Stems may be (samples,) mono or (channels,
    samples); all stems must share the channel count.
    """
    refs = [np.atleast_2d(np.asarray(r, dtype=np.float64)) for r in references]
    ests = [np.atleast_2d(np.asarray(e, dtype=np.float64)) for e in estimates]
    if len(refs) != len(ests):
        raise ValueError("references and estimates must have the same count")
    nsrc = len(refs)
    nchan = refs[0].shape[0]
    if any(x.shape[0] != nchan for x in refs + ests):
        raise ValueError("all stems must share one channel count")

    # museval evaluate(padding=True): zero-pad everything to the max length.
    n = max(max(r.shape[1] for r in refs), max(e.shape[1] for e in ests))
    refs = [np.pad(r, ((0, 0), (0, n - r.shape[1]))) for r in refs]
    ests = [np.pad(e, ((0, 0), (0, n - e.shape[1]))) for e in ests]

    flen = int(filter_length)
    refs_flat = np.concatenate(refs, axis=0)  # (nsrc*nchan, n)
    G, sf, nfft = _correlations(refs_flat, flen)

    win = int(window_seconds * sample_rate)
    hop = int(hop_seconds * sample_rate)
    nwin = max(int(np.floor((n - win + hop) / hop)), 1)
    frame_slices = [slice(t * hop, min(t * hop + win, n)) for t in range(nwin)]
    # museval _any_source_silent: a frame where ANY reference source is
    # silent is NaN for every source (the projection there is singular).
    silent_frame = [
        any(not np.any(r[:, sl]) for r in refs) for sl in frame_slices
    ]

    results = []
    for j in range(nsrc):
        decomp = _decompose_images(refs_flat, G, sf, nfft, ests[j], j, nchan,
                                   flen)
        frames = {"SDR": [], "ISR": [], "SIR": [], "SAR": []}
        for sl, silent in zip(frame_slices, silent_frame):
            if silent:
                vals = {k: float("nan") for k in frames}
            else:
                vals = _frame_ratios(*decomp, sl)
            for k in frames:
                frames[k].append(vals[k])
        results.append(frames)
    return results


def bss_eval(
    references: Sequence[np.ndarray],
    estimates: Sequence[np.ndarray],
    sample_rate: int = 44100,
    window_seconds: float = 1.0,
    hop_seconds: float = 1.0,
    filter_length: int = 512,
) -> List[Dict[str, float]]:
    """museval-convention track scores: nanmedian over BSS Eval v4 frames.

    One dict per source — {"SDR", "SIR", "SAR", "ISR"} — matching the
    per-track ``median_scores`` in the reference's models-scores.json.
    """
    framewise = bss_eval_framewise(
        references, estimates, sample_rate=sample_rate,
        window_seconds=window_seconds, hop_seconds=hop_seconds,
        filter_length=filter_length)
    out = []
    for frames in framewise:
        agg = {}
        for k, v in frames.items():
            arr = np.asarray(v, dtype=np.float64)
            with np.errstate(invalid="ignore"):
                # nanmedian, not finite-median: museval keeps ±inf frames
                # (a perfectly separated frame is +inf and should pull the
                # median up, not be silently dropped).
                agg[k] = (float(np.nanmedian(arr))
                          if np.any(~np.isnan(arr)) else float("nan"))
        out.append(agg)
    return out
