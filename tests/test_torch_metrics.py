"""The port's BSS Eval v4 and SDR (``audio_separator_tpu_torch/utils/metrics``)
against the JAX package's (``audio_separator_tpu/utils/metrics``): bit-exact
on seeded mono and stereo stems, silent frames included (``np.array_equal``,
NaN in the same places), plus the semantic cases of ``tests/test_metrics.py``
held on the port's copy."""

import numpy as np
import pytest

from audio_separator_tpu.utils import metrics as jax_metrics
from audio_separator_tpu_torch.utils.metrics import bss_eval, bss_eval_framewise, simple_sdr

from test_metrics import _oracle_frames
from torch_threads import one_torch_thread  # noqa: F401

KEYS = ("SDR", "ISR", "SIR", "SAR")


def _case(name):
    """Seeded references and estimates: (refs, ests, sample_rate, flen)."""
    rng = np.random.default_rng(CASES.index(name) + 11)
    sr = 100
    if name == "mono":
        n = 5 * sr + 23
        refs = [rng.standard_normal(n), rng.standard_normal(n)]  # (n,) stems
        ests = [0.8 * refs[0] + 0.1 * refs[1] + 0.05 * rng.standard_normal(n),
                0.9 * refs[1] + 0.2 * rng.standard_normal(n)]
        return refs, ests, sr, 16
    if name == "stereo":
        n = 6 * sr
        refs = [rng.standard_normal((2, n)) for _ in range(3)]
        mix = sum(refs)
        ests = [0.7 * r + 0.1 * mix + 0.03 * rng.standard_normal((2, n)) for r in refs]
        return refs, ests, sr, 24
    if name == "silent_frames":
        n = 5 * sr + 37
        refs = [rng.standard_normal((2, n)), rng.standard_normal((2, n))]
        refs[1][:, 2 * sr : 3 * sr] = 0.0  # source 2 silent in frame 2
        refs[0][:, 4 * sr :] = 0.0  # source 1 silent from frame 4 on
        ests = [refs[0] + 0.1 * rng.standard_normal((2, n)),
                refs[1] + 0.01 * rng.standard_normal((2, n))]
        return refs, ests, sr, 16
    if name == "exact_and_unequal_lengths":
        n = 4 * sr
        refs = [rng.standard_normal((2, n)), rng.standard_normal((2, n - 30))]
        ests = [refs[0].copy(), refs[1][:, : n - 50].copy()]  # +inf frames, padding
        return refs, ests, sr, 8
    raise KeyError(name)


CASES = ("mono", "stereo", "silent_frames", "exact_and_unequal_lengths")


@pytest.mark.parametrize("name", CASES)
def test_bss_eval_framewise_is_bit_exact_against_jax(name):
    refs, ests, sr, flen = _case(name)
    got = bss_eval_framewise(refs, ests, sample_rate=sr, filter_length=flen)
    want = jax_metrics.bss_eval_framewise(refs, ests, sample_rate=sr, filter_length=flen)
    assert len(got) == len(want) == len(refs)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in KEYS:
            assert np.array_equal(np.asarray(g[k]), np.asarray(w[k]), equal_nan=True), k
    if name == "silent_frames":
        assert np.isnan(got[0]["SDR"][2]) and np.isnan(got[1]["SAR"][4])


@pytest.mark.parametrize("name", CASES)
def test_bss_eval_is_bit_exact_against_jax(name):
    refs, ests, sr, flen = _case(name)
    got = bss_eval(refs, ests, sample_rate=sr, filter_length=flen)
    want = jax_metrics.bss_eval(refs, ests, sample_rate=sr, filter_length=flen)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in KEYS:
            assert np.array_equal(g[k], w[k], equal_nan=True), (k, g[k], w[k])


@pytest.mark.parametrize("name", CASES)
def test_simple_sdr_is_bit_exact_against_jax(name):
    refs, ests, _, _ = _case(name)
    for r, e in zip(refs, ests):
        assert simple_sdr(e, r) == jax_metrics.simple_sdr(e, r)
        assert simple_sdr(e.astype(np.float32), r) == jax_metrics.simple_sdr(
            e.astype(np.float32), r)


def test_all_silent_source_is_nan_in_both():
    """A reference silent in every frame: every frame and the median NaN."""
    rng = np.random.default_rng(4)
    sr, n = 100, 300
    refs = [rng.standard_normal((1, n)), np.zeros((1, n))]
    ests = [refs[0] + 0.1, rng.standard_normal((1, n))]
    got = bss_eval(refs, ests, sample_rate=sr, filter_length=8)
    want = jax_metrics.bss_eval(refs, ests, sample_rate=sr, filter_length=8)
    assert all(np.isnan(got[j][k]) and np.isnan(want[j][k]) for j in (0, 1) for k in KEYS)


# ---------------------------------------------------------------------------
# The semantic cases of tests/test_metrics.py, on the port's copy.


def _tones(n, sr=8000):
    t = np.arange(n) / sr
    s1 = np.sin(2 * np.pi * 440 * t)
    s2 = np.sign(np.sin(2 * np.pi * 123 * t)) * 0.5
    return s1.astype(np.float64), s2.astype(np.float64)


def test_port_simple_sdr_perfect_and_noisy():
    ref = np.random.default_rng(0).standard_normal(10000)
    assert simple_sdr(ref, ref) > 90
    noisy = ref + 0.1 * np.random.default_rng(1).standard_normal(10000)
    assert 15 < simple_sdr(noisy, ref) < 25


def test_port_bss_eval_perfect_separation_and_interference():
    s1, s2 = _tones(16000)
    res = bss_eval([s1[None], s2[None]], [s1[None], s2[None]], sample_rate=8000)
    assert res[0]["SDR"] > 40 and res[1]["SDR"] > 40
    res = bss_eval([s1[None], s2[None]], [(s1 + 0.3 * s2)[None], s2[None]], sample_rate=8000)
    assert res[0]["SIR"] < res[1]["SIR"] and res[0]["SIR"] < 30


def test_port_bss_eval_filtered_target_images_semantics():
    rng = np.random.default_rng(2)
    s1, s2 = rng.standard_normal(16000), rng.standard_normal(16000)
    filtered = np.convolve(s1, np.array([0.9, 0.1, -0.05]))[:16000]
    res_f = bss_eval([s1[None], s2[None]], [filtered[None], s2[None]], sample_rate=8000)
    assert res_f[0]["SIR"] > 60 and res_f[0]["SAR"] > 60
    expected = 10 * np.log10(1.0 / (0.1**2 + 0.1**2 + 0.05**2))
    assert abs(res_f[0]["SDR"] - expected) < 1.0
    assert abs(res_f[0]["ISR"] - res_f[0]["SDR"]) < 0.2
    noisy = s1 + 0.3 * rng.standard_normal(16000)
    res_n = bss_eval([s1[None], s2[None]], [noisy[None], s2[None]], sample_rate=8000)
    assert res_n[0]["SDR"] < 15 and res_n[0]["SAR"] < 15
    assert res_n[0]["SAR"] < res_f[0]["SAR"]


@pytest.mark.parametrize("nchan", [1, 2])
def test_port_bss_eval_matches_bruteforce_oracle(nchan):
    rng = np.random.default_rng(7)
    sr, n, flen = 100, 350, 8
    refs = [rng.standard_normal((nchan, n)) for _ in range(2)]
    mix = refs[0] + refs[1]
    ests = [0.8 * refs[0] + 0.25 * mix + 0.02 * rng.standard_normal((nchan, n)),
            0.7 * refs[1] + 0.2 * mix + 0.03 * rng.standard_normal((nchan, n))]
    got = bss_eval_framewise(refs, ests, sample_rate=sr, filter_length=flen)
    want = _oracle_frames(refs, ests, sr, flen)
    for g, w in zip(got, want):
        for k in KEYS:
            np.testing.assert_allclose(g[k], w[k], atol=1e-6, rtol=1e-9)


def test_port_bss_eval_global_filters_not_framewise():
    rng = np.random.default_rng(8)
    sr, n = 100, 1000
    s1, s2 = rng.standard_normal((1, n)), rng.standard_normal((1, n))
    est = np.empty((1, n))
    est[0, : n // 2] = s1[0, : n // 2]
    est[0, n // 2 :] = np.convolve(s1[0], [0.2, -0.9])[n // 2 : n]
    sar = np.asarray(bss_eval_framewise([s1, s2], [est, s2], sample_rate=sr,
                                        filter_length=4)[0]["SAR"])
    assert np.isfinite(sar).all() and sar.min() < 40


def test_port_bss_eval_silent_frame_nan_and_framing():
    sr = 100
    n = 5 * sr + 37
    rng = np.random.default_rng(9)
    s1, s2 = rng.standard_normal((1, n)), rng.standard_normal((1, n))
    s2[:, 2 * sr : 3 * sr] = 0.0
    frames = bss_eval_framewise([s1, s2], [s1.copy(), s2.copy()], sample_rate=sr)
    assert len(frames[0]["SDR"]) == 5
    for j in (0, 1):
        assert np.isnan(frames[j]["SDR"][2]) and np.isnan(frames[j]["SAR"][2])
    assert frames[0]["SDR"][0] > 100
    assert bss_eval([s1, s2], [s1.copy(), s2.copy()], sample_rate=sr)[0]["SDR"] > 40


def test_port_isr_images_semantics_stereo_and_mono():
    rng = np.random.default_rng(3)
    n = 44100 * 2
    ref_l = rng.standard_normal(n)
    ref = np.stack([ref_l, 0.8 * ref_l + 0.2 * rng.standard_normal(n)])
    other = rng.standard_normal((2, n))
    est = ref + 0.1 * rng.standard_normal((2, n))
    r = bss_eval([ref, other], [est, other])[0]
    assert np.isfinite(r["ISR"]) and np.isfinite(r["SAR"])
    assert abs(r["ISR"] - r["SAR"]) > 1e-6
    mono = bss_eval([ref.mean(0), other.mean(0)], [est.mean(0), other.mean(0)])
    assert np.isfinite(mono[0]["ISR"])
