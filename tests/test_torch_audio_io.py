"""The port's WAV path, resampling and host helpers against the JAX
package's own versions on the same seeded signals. The codec routes are held
against the JAX package's in tests/test_torch_codec.py."""

import numpy as np
import pytest

from audio_separator_tpu.io import audio as jax_audio
from audio_separator_tpu.ops import resample as jax_resample
from audio_separator_tpu.ops import spec as jax_spec
from audio_separator_tpu_torch.io import audio
from audio_separator_tpu_torch.ops import resample, spec


@pytest.mark.parametrize("bit_depth", [16, 24, 32])
@pytest.mark.parametrize("channels", [1, 2])
def test_wav_round_trip_matches_jax_reader(tmp_path, bit_depth, channels):
    pcm = (np.random.default_rng(bit_depth).standard_normal((channels, 3001)) * 0.3
           ).astype(np.float32)
    path = str(tmp_path / "x.wav")
    audio.save_audio(path, pcm, 44100, bit_depth=bit_depth)
    got, sr = audio.load_audio(path)
    want, want_sr = jax_audio._load_wav(path, None, None)
    assert sr == want_sr == 44100
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, np.clip(pcm, -1, 1), atol=2.0 ** -(bit_depth - 2))
    info = audio.probe(path)
    assert (info.sample_rate, info.channels, info.frames, info.bits_per_sample) == \
        (44100, channels, 3001, bit_depth)


def _without_codec(monkeypatch):
    """The route of a machine where the codec cannot be built or loaded."""
    monkeypatch.setattr(audio, "_load_lib", lambda: None)
    monkeypatch.setattr(audio, "_codec_cli", lambda: None)
    monkeypatch.setattr(audio, "_lib_error", "no libav here")


def _resampled_pair(tmp_path, jax_load):
    pcm = np.random.default_rng(1).standard_normal((1, 4800)).astype(np.float32) * 0.2
    path = str(tmp_path / "mono48k.wav")
    audio.save_audio(path, pcm, 48000)
    want, _ = jax_load(path, 44100, 2)
    got, sr = audio.load_audio(path, sample_rate=44100, channels=2)
    assert sr == 44100 and got.shape == want.shape == (2, 4410)
    return got, want


def test_load_resamples_and_upmixes_like_jax(tmp_path):
    """Where the codec loads, resampling runs in libswresample, as the JAX
    package's load_audio does."""
    got, want = _resampled_pair(tmp_path, jax_audio.load_audio)
    np.testing.assert_allclose(got, want, atol=1e-7)


def test_wav_route_resamples_and_upmixes_like_jax_wav_path(tmp_path, monkeypatch):
    """Without the codec, resampling runs in scipy, as the JAX package's WAV
    path does."""
    _without_codec(monkeypatch)
    got, want = _resampled_pair(tmp_path, jax_audio._load_wav)
    np.testing.assert_allclose(got, want, atol=1e-7)


@pytest.mark.parametrize("shift", [2, -3])
def test_pitch_shift_matches_jax(shift):
    pcm = np.random.default_rng(2).standard_normal((2, 5000)).astype(np.float32)
    got, rate = resample.change_pitch_semitones_np(pcm, 44100, shift)
    want, want_rate = jax_resample.change_pitch_semitones_np(pcm, 44100, shift)
    assert rate == want_rate
    np.testing.assert_array_equal(got, want)


def test_non_wav_formats_raise(tmp_path, monkeypatch):
    """Without the codec only WAV is read and written (the JAX package's
    save_audio raises RuntimeError there too)."""
    _without_codec(monkeypatch)
    with pytest.raises(RuntimeError, match="WAV"):
        audio.save_audio(str(tmp_path / "x.flac"), np.zeros((2, 10), np.float32), 44100)
    with pytest.raises(ValueError, match="WAV"):
        audio.load_audio(str(tmp_path / "x.mp3"))
    with pytest.raises(ValueError, match="WAV"):
        audio.probe(str(tmp_path / "x.mp3"))


@pytest.mark.parametrize("peak,max_peak,min_peak", [(2.0, 0.9, 0.0), (0.5, 0.9, 0.0),
                                                    (0.01, 0.9, 0.1), (0.0, 0.9, 0.1)])
def test_normalize_matches_jax(peak, max_peak, min_peak):
    wave = np.linspace(-peak, peak, 101, dtype=np.float32)
    np.testing.assert_array_equal(spec.normalize(wave, max_peak, min_peak),
                                  jax_spec.normalize(wave, max_peak, min_peak))


@pytest.mark.parametrize("length", [50, 100, 130])
def test_match_array_shapes_matches_jax(length):
    a = np.arange(2 * length, dtype=np.float32).reshape(2, length)
    b = np.zeros((2, 100), np.float32)
    np.testing.assert_array_equal(spec.match_array_shapes(a, b),
                                  jax_spec.match_array_shapes(a, b))
