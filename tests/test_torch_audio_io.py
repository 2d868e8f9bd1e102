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


# ---------------------------------------------------------------------------
# The WAV writer (io/wav.cpp) against the JAX package's normalise and numpy
# writer: the same bytes for every bit depth, channel count, layout and scale.

SR = 44100


def _edge_signal(channels: int, dtype=np.float32) -> np.ndarray:
    """Samples at ±1 and beyond, at the half steps of both PCM widths, silence
    (±0) and noise: ``(channels, frames)``, peak 1.5."""
    k = np.arange(-40, 40)
    edges = np.concatenate([
        [0.0, -0.0, 1.0, -1.0, 1.5, -1.5, 1.0 + 2 ** -23, -1.0 - 2 ** -23],
        (k + 0.5) / 32767.0, (k + 0.5) / 8388607.0,
        (32766 + np.array([0.5, -0.5])) / 32767.0, -(32766 + np.array([0.5, -0.5])) / 32767.0,
        np.zeros(16)])
    noise = np.random.default_rng(channels).uniform(-1.2, 1.2, (channels, 301))
    pcm = np.concatenate([np.stack([np.roll(edges, c) for c in range(channels)]), noise], axis=1)
    return pcm.astype(dtype)


def _layout(pcm: np.ndarray, layout: str) -> np.ndarray:
    """The same ``(channels, frames)`` values in another memory layout."""
    if layout == "planar":  # C-ordered (channels, frames)
        return np.ascontiguousarray(pcm)
    if layout == "interleaved":  # F-ordered: a (frames, channels) array's .T
        return np.ascontiguousarray(pcm.T).T
    if layout == "strided":  # every other frame of a larger planar array
        wide = np.zeros((pcm.shape[0], 2 * pcm.shape[1]), pcm.dtype)
        wide[:, ::2] = pcm
        return wide[:, ::2]
    assert layout == "reversed"  # negative frame stride
    return np.ascontiguousarray(pcm[:, ::-1])[:, ::-1]


# (max_peak, min_peak, gain): no normalisation; a peak above max_peak (scaled
# down); one under min_peak (scaled up); thresholds given, no scale applied.
SCALES = {"none": (None, None, 1.0), "above_max": (0.9, 0.0, 1.0),
          "under_min": (0.9, 0.1, 0.01), "within": (2.0, 0.1, 1.0)}


def _numpy_writer(path, pcm, bit_depth, max_peak, min_peak):
    """The reference: the JAX package's ``normalize``, then its numpy writer
    on the float32 interleaved copy. Returns the peak after."""
    pcm = pcm[None, :] if pcm.ndim == 1 else pcm
    peak = None
    if max_peak is not None:
        pcm = jax_spec.normalize(pcm, max_peak, min_peak)
        peak = np.max(np.abs(pcm))
    jax_audio._save_wav(path, np.ascontiguousarray(pcm.T, dtype=np.float32), SR, bit_depth)
    return peak


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture
def counted():
    """``ENCODES`` by route from the test's start."""
    before = dict(audio.ENCODES)
    return lambda route: audio.ENCODES[route] - before.get(route, 0)


def _check_same_bytes(tmp_path, pcm, bit_depth, scale):
    """One ``save_audio`` through the WAV writer against the reference: the
    same file bytes and the same peak, in the same type."""
    max_peak, min_peak, gain = SCALES[scale]
    if gain != 1.0:
        pcm = pcm * pcm.dtype.type(gain)
    mine, theirs = str(tmp_path / "writer.wav"), str(tmp_path / "numpy.wav")
    before = audio.ENCODES["wav_native"]
    peak = audio.save_audio(mine, pcm, SR, bit_depth=bit_depth, max_peak=max_peak,
                            min_peak=min_peak)
    assert audio.ENCODES["wav_native"] == before + 1
    want_peak = _numpy_writer(theirs, pcm, bit_depth, max_peak, min_peak)
    assert _read(mine) == _read(theirs)
    if max_peak is None:
        assert peak is None
    else:
        assert peak.dtype == want_peak.dtype
        assert peak == want_peak or (np.isnan(peak) and np.isnan(want_peak))


@pytest.mark.parametrize("scale", list(SCALES))
@pytest.mark.parametrize("layout", ["planar", "interleaved", "strided", "reversed"])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("bit_depth", [16, 24, 32])
def test_wav_writer_bytes_equal_numpy_writer(tmp_path, bit_depth, channels, layout, scale):
    _check_same_bytes(tmp_path, _layout(_edge_signal(channels), layout), bit_depth, scale)


@pytest.mark.parametrize("scale", list(SCALES))
@pytest.mark.parametrize("bit_depth", [16, 24, 32])
def test_wav_writer_normalises_float64_before_the_cast(tmp_path, bit_depth, scale):
    """A float64 stem (the ensembler's) is scaled in float64 and rounded to
    float32 after, as ``normalize`` then the cast did."""
    pcm = _edge_signal(2, np.float64) * (1 + 1e-9)  # not float32 values
    _check_same_bytes(tmp_path, _layout(pcm, "interleaved"), bit_depth, scale)


@pytest.mark.parametrize("bit_depth", [16, 24, 32])
def test_wav_writer_non_finite_channels_and_types(tmp_path, bit_depth):
    """NaN (no scale applies) and infinities (the scale is 0, and inf · 0 is
    NaN); six channels, planar and strided; a 1-D mono stem; float16, which
    the writer does not read in place (normalised in numpy first, as
    before)."""
    pcm = _edge_signal(2)
    pcm[1, 9], pcm[1, 11] = np.inf, -np.inf
    with_nan = pcm.copy()
    with_nan[0, 7] = np.nan
    with np.errstate(invalid="ignore"):
        for scale in ("none", "above_max"):
            _check_same_bytes(tmp_path, with_nan, bit_depth, scale)
            _check_same_bytes(tmp_path, pcm, bit_depth, scale)
    for layout in ("planar", "strided"):
        _check_same_bytes(tmp_path, _layout(_edge_signal(6), layout), bit_depth, "above_max")
    _check_same_bytes(tmp_path, _edge_signal(1)[0], bit_depth, "above_max")
    _check_same_bytes(tmp_path, _edge_signal(2, np.float16), bit_depth, "above_max")


def test_wav_python_route_writes_the_same_bytes(tmp_path, monkeypatch, counted):
    """Where g++ cannot build the writer, the port's numpy writer takes over,
    with the reference's bytes."""
    def no_build(artifact):
        raise RuntimeError(f"g++ could not run for {artifact}")

    monkeypatch.setattr(audio, "_build", no_build)
    monkeypatch.setattr(audio, "_wav_lib", None)
    monkeypatch.setattr(audio, "_wav_error", None)
    for bit_depth in (16, 24, 32):
        for scale in SCALES:
            pcm = _layout(_edge_signal(2), "interleaved") * np.float32(SCALES[scale][2])
            mine, native = str(tmp_path / "python.wav"), str(tmp_path / "native.wav")
            peak = audio.save_audio(mine, pcm, SR, bit_depth=bit_depth,
                                    max_peak=SCALES[scale][0], min_peak=SCALES[scale][1])
            want = _numpy_writer(native, pcm, bit_depth, *SCALES[scale][:2])
            assert _read(mine) == _read(native) and peak == want
    assert counted("wav_python") == 12 and counted("wav_native") == 0
    assert "g++ could not run" in audio._wav_error


@pytest.mark.parametrize("route", ["wav_native", "wav_python", "library", "subprocess"])
def test_encodes_counts_each_route(tmp_path, monkeypatch, counted, route):
    if route == "wav_python":
        monkeypatch.setattr(audio, "_build", lambda artifact: (_ for _ in ()).throw(
            RuntimeError("no g++")))
        monkeypatch.setattr(audio, "_wav_lib", None)
        monkeypatch.setattr(audio, "_wav_error", None)
    if route == "library":
        monkeypatch.delenv("AUDSEP_CODEC_SUBPROCESS", raising=False)
    if route == "subprocess":
        monkeypatch.setenv("AUDSEP_CODEC_SUBPROCESS", "1")
    ext = "wav" if route.startswith("wav") else "flac"
    audio.save_audio(str(tmp_path / f"x.{ext}"), _edge_signal(2) * np.float32(0.5), SR)
    assert {r: counted(r) for r in ("wav_native", "wav_python", "library", "subprocess")} == \
        {r: int(r == route) for r in ("wav_native", "wav_python", "library", "subprocess")}


def test_encode_span_names_its_route(tmp_path):
    from audio_separator_tpu_torch.utils import tracing

    tracing.disable()
    tracing.clear()
    tracing.enable()
    try:
        audio.save_audio(str(tmp_path / "x.wav"), np.zeros((2, 64), np.float32), SR)
        records = [r for r in tracing.records() if r.name == "audio.encode"]
    finally:
        tracing.disable()
        tracing.clear()
    assert [r.attrs for r in records] == [{"route": "wav_native"}]


def test_encodes_counts_every_write_of_many_threads(tmp_path, counted):
    """16 threads, more than the cores, write 10 WAVs each under a short
    switch interval: no count is lost."""
    import sys
    import threading

    pcm = _edge_signal(2)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda t=t: [
            audio.save_audio(str(tmp_path / f"t{t}_{i}.wav"), pcm, SR, max_peak=0.9)
            for i in range(10)]) for t in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert counted("wav_native") == 160


def _separator(tmp_path, **config):
    from audio_separator_tpu_torch.separator.common import BaseSeparator

    return BaseSeparator({"output_dir": str(tmp_path), "sample_rate": SR, **config})


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_write_audio_bytes_equal_normalise_then_numpy_writer(tmp_path, dtype):
    """``write_audio`` on a ``(samples, channels)`` stem: the bytes of the
    reference chain (the JAX package's normalise, a transposed float32 copy,
    its numpy writer)."""
    stem = _edge_signal(2, dtype).T * dtype(1.7)
    sep = _separator(tmp_path)
    sep.write_audio("stem.wav", stem)
    want = str(tmp_path / "want.wav")
    normalised = jax_spec.normalize(stem, max_peak=0.9, min_peak=0.0)
    jax_audio._save_wav(want, np.ascontiguousarray(normalised.T.astype(np.float32).T), SR, 16)
    assert _read(str(tmp_path / "stem.wav")) == _read(want)


@pytest.mark.parametrize("native", [True, False])
def test_write_audio_writes_a_near_silent_stem_and_warns(tmp_path, monkeypatch, caplog,
                                                         native):
    if not native:
        monkeypatch.setattr(audio, "_build", lambda artifact: (_ for _ in ()).throw(
            RuntimeError("no g++")))
        monkeypatch.setattr(audio, "_wav_lib", None)
        monkeypatch.setattr(audio, "_wav_error", None)
    sep = _separator(tmp_path)
    with caplog.at_level("WARNING"):
        sep.write_audio("silent.wav", np.zeros((500, 2), np.float32))
        sep.write_audio("faint.wav", np.full((500, 2), 4e-7, np.float32))
        sep.write_audio("loud.wav", np.full((500, 2), 0.5, np.float32))
    warned = [r for r in caplog.records if "near-silent" in r.getMessage()]
    assert len(warned) == 2
    for name in ("silent", "faint", "loud"):
        assert audio.probe(str(tmp_path / f"{name}.wav")).frames == 500
