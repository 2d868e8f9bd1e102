"""The port's ``Ensembler`` (all 11 algorithms), its ``ops/spec`` ensembling
helpers, and its own copies of ``ops/align`` and ``ops/stretch`` against the
JAX package's, on seeded inputs: with and without weights, mono and stereo,
inputs of unequal length. The waveform algorithms are held bit-exact (numpy
on both sides); the spectral ones within 1e-5 of the output's largest
magnitude (the STFTs are torch's on one side and the JAX package's DFT on the
other). ``align`` and ``stretch`` are numpy on both sides: bit-exact."""

import logging

import numpy as np
import pytest

from audio_separator_tpu.ops import align as jax_align
from audio_separator_tpu.ops import spec as jax_spec
from audio_separator_tpu.ops import stretch as jax_stretch
from audio_separator_tpu.separator.ensembler import ALGORITHMS as JAX_ALGORITHMS
from audio_separator_tpu.separator.ensembler import Ensembler as JaxEnsembler
from audio_separator_tpu_torch.ops import align, spec, stretch
from audio_separator_tpu_torch.separator.ensembler import ALGORITHMS, Ensembler
from torch_threads import one_torch_thread  # noqa: F401

WAVE_ALGORITHMS = ("avg_wave", "median_wave", "min_wave", "max_wave", "ensemble_wav")
SPECTRAL_TOL = 1e-5


def _waves(channels, lengths, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(max(lengths)) / 44100
    waves = []
    for k, n in enumerate(lengths):
        tone = 0.3 * np.sin(2 * np.pi * (220 + 55 * k) * t[:n])
        waves.append((tone + 0.1 * rng.standard_normal((channels, n))).astype(np.float32))
    return waves


def test_the_algorithm_list_is_the_jax_one():
    assert ALGORITHMS == JAX_ALGORITHMS and len(ALGORITHMS) == 11


@pytest.mark.parametrize("weights", [None, [1.0, 2.0, 0.5]], ids=["equal", "weighted"])
@pytest.mark.parametrize("channels", [2, 1], ids=["stereo", "mono"])
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_ensembler_matches_jax(algorithm, channels, weights):
    """Three inputs of 20000, 19000 and 20480 samples (the shorter are
    zero-padded, or the spectra cropped, as the algorithm does)."""
    waves = _waves(channels, (20000, 19000, 20480), seed=len(algorithm) + channels)
    log = logging.getLogger("test")
    got = Ensembler(log, algorithm, weights).ensemble([w.copy() for w in waves])
    want = JaxEnsembler(log, algorithm, weights).ensemble([w.copy() for w in waves])
    assert got.shape == want.shape
    if algorithm in WAVE_ALGORITHMS:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, atol=SPECTRAL_TOL * scale, rtol=0)


def test_ensembler_edge_cases_match_jax(caplog):
    """No input, one input, a channel mismatch, and weights of the wrong
    length or zero sum (equal weights and a warning, as in JAX)."""
    log = logging.getLogger("test")
    waves = _waves(2, (5000, 5000), seed=3)
    assert Ensembler(log).ensemble([]) is None
    assert Ensembler(log).ensemble(waves[:1]) is waves[0]
    with pytest.raises(ValueError, match="same number of channels"):
        Ensembler(log).ensemble([waves[0], waves[1][:1]])
    for bad in ([1.0], [1.0, -1.0]):
        with caplog.at_level(logging.WARNING):
            got = Ensembler(log, "avg_wave", bad).ensemble(waves)
        assert "equal weights" in caplog.text
        np.testing.assert_array_equal(got, JaxEnsembler(log, "avg_wave", bad).ensemble(waves))
    with pytest.raises(ValueError, match="Unknown ensemble algorithm"):
        Ensembler(log, "nope").ensemble(waves)


@pytest.mark.parametrize("algorithm", [spec.MAX_SPEC, spec.MIN_SPEC])
def test_ensemble_spec_waves_matches_jax(algorithm):
    waves = _waves(2, (12000, 11000), seed=9)
    got = spec.ensemble_spec_waves(algorithm, waves)
    want = jax_spec.ensemble_spec_waves(algorithm, waves)
    # 11000 samples are 11 frames, whose inverse is 10 hops long: the crop to
    # the shortest input does not lengthen it.
    assert got.shape == want.shape == (2, 10 * 1024)
    np.testing.assert_allclose(got, want, atol=SPECTRAL_TOL * np.abs(want).max(), rtol=0)


def test_ensemble_wav_and_average_dual_sources_match_jax():
    waves = _waves(2, (9000, 9000, 9000), seed=4)
    np.testing.assert_array_equal(spec.ensemble_wav(waves, split_size=17),
                                  jax_spec.ensemble_wav(waves, split_size=17))
    a, b = _waves(2, (9000, 7000), seed=5)
    np.testing.assert_array_equal(spec.average_dual_sources(a, b, 0.3),
                                  jax_spec.average_dual_sources(a, b, 0.3))


# ----------------------------------------------------------- align, stretch


def test_align_matches_jax():
    """The cases of tests/test_align_and_images.py, on both copies."""
    rng = np.random.default_rng(2)
    sr = 8000
    a = rng.standard_normal((2, sr * 6)).astype(np.float32)
    b = -align.shift_track(a, 250)
    for got, want in zip(align.align_tracks(a, b, sample_rate=sr),
                         jax_align.align_tracks(a, b, sample_rate=sr)):
        np.testing.assert_array_equal(got, want)
    x = rng.standard_normal(8000)
    assert align.best_shift(x[:4000], np.roll(x, -137)[:4000]) == \
        jax_align.best_shift(x[:4000], np.roll(x, -137)[:4000])
    assert align.check_if_phase_inverted(a, -a) and not align.check_if_phase_inverted(a, a)
    ref = np.concatenate([np.zeros(100), np.ones(900)])[None]
    target = np.concatenate([np.zeros(400), np.ones(600)])[None]
    np.testing.assert_array_equal(align.adjust_leading_silence(target, ref),
                                  jax_align.adjust_leading_silence(target, ref))
    np.testing.assert_array_equal(align.phase_shift_hilbert(x, 45),
                                  jax_align.phase_shift_hilbert(x, 45))
    for got, want in zip(align.get_phase_shifted_tracks(x[:2000], 90),
                         jax_align.get_phase_shifted_tracks(x[:2000], 90)):
        np.testing.assert_array_equal(got, want)


def test_time_correction_matches_jax():
    sr = 4000
    rng = np.random.default_rng(1)
    inst = rng.standard_normal((2, sr)) * 0.5
    mix = inst * 10 ** (3 / 20) + 0.05 * rng.standard_normal((2, sr))
    kwargs = dict(align_window=(0.1,), db_analysis=(0.0, (0.0, 3.0)), sample_rate=sr,
                  phase_shifts=180)
    np.testing.assert_array_equal(align.time_correction(mix, inst, **kwargs),
                                  jax_align.time_correction(mix, inst, **kwargs))


def test_stretch_matches_jax():
    """The cases of tests/test_stretch.py: stretch at two rates, mono and
    frames-first stereo, and pitch shifts both ways."""
    sr = 22050
    t = np.arange(sr) / sr
    mono = np.sin(2 * np.pi * 440.0 * t).astype(np.float32)
    stereo = np.stack([np.sin(2 * np.pi * 220 * t), np.sin(2 * np.pi * 330 * t)],
                      axis=1).astype(np.float32)
    for y, rate in ((mono, 0.75), (mono, 1.5), (stereo, 2.0), (mono, 1.0)):
        np.testing.assert_array_equal(stretch.time_stretch(y, sr, rate),
                                      jax_stretch.time_stretch(y, sr, rate))
    for steps in (-5.0, 4.0, 0.0):
        np.testing.assert_array_equal(stretch.pitch_shift(mono, sr, steps),
                                      jax_stretch.pitch_shift(mono, sr, steps))


def test_augment_audio_matches_jax(tmp_path):
    """Both copies write the same file from the same input (the port through
    its own codec), for the stretch and the resample-trick pitch paths."""
    from audio_separator_tpu_torch.io import audio as audio_io

    sr = 44100
    t = np.arange(sr) / sr
    y = np.stack([np.sin(2 * np.pi * 220 * t), np.sin(2 * np.pi * 330 * t)]
                 ).astype(np.float32) * 0.5
    src = str(tmp_path / "in.wav")
    audio_io.save_audio(src, y, sr)
    for name, kwargs in (("fast", {}), ("pitched", {"is_time_correction": False,
                                                     "is_normalization": True})):
        got = stretch.augment_audio(str(tmp_path / f"{name}_port.wav"), src, 2.0, **kwargs)
        want = jax_stretch.augment_audio(str(tmp_path / f"{name}_jax.wav"), src, 2.0, **kwargs)
        with open(got, "rb") as f, open(want, "rb") as g:
            assert f.read() == g.read(), name
