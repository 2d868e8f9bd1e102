"""The port's native codec (``audio_separator_tpu_torch/io/codec.cpp`` through
``io/audio.py``) against the JAX package's, on both codec routes: the child
process (``AUDSEP_CODEC_SUBPROCESS``, which tests/conftest.py sets) and the
``ctypes`` library. Both packages build the same C++ against the same libav,
so decodes agree exactly and resampling agrees to float32 rounding (atol
1e-6)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from audio_separator_tpu.io import audio as jax_audio
from audio_separator_tpu_torch.io import audio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUTES = ["subprocess", "library"]
# (extension, bit depth, bitrate kbps)
FORMATS = [("flac", 16, 0), ("flac", 24, 0), ("mp3", 16, 192),
           ("wav", 16, 0), ("wav", 24, 0), ("wav", 32, 0)]


@pytest.fixture(params=ROUTES)
def route(request, monkeypatch):
    if request.param == "library":
        monkeypatch.delenv("AUDSEP_CODEC_SUBPROCESS", raising=False)
    else:
        monkeypatch.setenv("AUDSEP_CODEC_SUBPROCESS", "1")
    if audio._route() != request.param:
        pytest.fail(f"the port took the {audio._route()} route, not {request.param}")
    return request.param


def _signal(seed, n=12000, channels=2):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 44100
    tone = 0.3 * np.sin(2 * np.pi * 440 * t)
    return (tone + 0.05 * rng.standard_normal((channels, n))).astype(np.float32)


@pytest.mark.parametrize("ext,bits,kbps", FORMATS)
def test_encode_decode_probe_match_jax(tmp_path, route, ext, bits, kbps):
    pcm = _signal(bits + kbps)
    mine, theirs = str(tmp_path / f"port.{ext}"), str(tmp_path / f"jax.{ext}")
    audio.save_audio(mine, pcm, 44100, bit_depth=bits, bitrate_kbps=kbps)
    jax_audio.save_audio(theirs, pcm, 44100, bit_depth=bits, bitrate_kbps=kbps)

    got, sr = audio.load_audio(mine)
    want, want_sr = jax_audio.load_audio(theirs)
    assert sr == want_sr == 44100
    np.testing.assert_array_equal(got, want)
    # the port decodes the JAX package's file as the JAX package does
    np.testing.assert_array_equal(audio.load_audio(theirs)[0], want)
    assert audio.probe(mine) == audio.AudioInfo(**vars(jax_audio.probe(theirs)))
    if ext != "mp3":  # lossless: the decode is the quantised input
        np.testing.assert_allclose(got, pcm, atol=2.0 ** -(min(bits, 24) - 2))
    else:
        assert audio.probe(mine).sample_rate == 44100 and got.shape[0] == 2


def test_c7_resampled_load_matches_jax_load_audio(tmp_path, route):
    """ROADMAP C7: a 48 kHz WAV loaded at 44.1 kHz goes through
    libswresample, as the JAX package's load_audio does where its codec
    loads (scipy's polyphase filter gave 39.59 dB against it)."""
    n = 3 * 48000
    t = np.arange(n) / 48000
    rng = np.random.default_rng(7)
    pcm = np.stack([0.4 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(n),
                    0.3 * np.sin(2 * np.pi * 3000 * t)]).astype(np.float32)
    path = str(tmp_path / "in48k.wav")
    audio.save_audio(path, pcm, 48000)
    got, sr = audio.load_audio(path, 44100, 2)
    want, want_sr = jax_audio.load_audio(path, 44100, 2)
    assert sr == want_sr == 44100 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("channels", [1, 2])
def test_channel_mixing_matches_jax(tmp_path, route, channels):
    path = str(tmp_path / "x.flac")
    audio.save_audio(path, _signal(3, channels=3 - channels), 44100)
    got, _ = audio.load_audio(path, None, channels)
    want, _ = jax_audio.load_audio(path, None, channels)
    assert got.shape[0] == channels
    np.testing.assert_array_equal(got, want)


def test_codec_errors_name_the_file(tmp_path, route):
    bad = str(tmp_path / "not_audio.flac")
    with open(bad, "wb") as f:
        f.write(b"this is not audio")
    with pytest.raises(RuntimeError, match="not_audio.flac"):
        audio.load_audio(bad)
    with pytest.raises(RuntimeError, match="not_audio.flac"):
        audio.probe(bad)


def test_the_route_is_logged_once(caplog, route):
    audio._routes_logged.discard(route)
    with caplog.at_level("INFO", logger=audio.__name__):
        audio._route()
        audio._route()
    lines = [r.message for r in caplog.records if r.message.startswith("audio I/O route")]
    assert len(lines) == 1 and lines[0].startswith(f"audio I/O route: {route} (")


def test_codec_builds_under_build_keyed_on_the_source():
    for artifact in ("library", "cli"):
        path = audio.codec_path(artifact)
        assert os.path.dirname(path) == os.path.join(REPO, "build", "torch_codec")
        assert os.path.exists(audio._build(artifact))


def test_the_port_never_loads_a_binary_of_the_jax_package(tmp_path):
    """In a fresh process: decode, probe and encode on both routes, then no
    mapped library and no executed program lies under audio_separator_tpu/io."""
    code = (
        "import json, os, subprocess, sys\n"
        "import numpy as np\n"
        "ran = []\n"
        "real_run = subprocess.run\n"
        "def run(args, *a, **k):\n"
        "    ran.append(args[0])\n"
        "    return real_run(args, *a, **k)\n"
        "subprocess.run = run\n"
        "from audio_separator_tpu_torch.io import audio\n"
        "d = sys.argv[1]\n"
        "pcm = np.zeros((2, 4000), np.float32)\n"
        "for env in ('1', ''):\n"
        "    os.environ['AUDSEP_CODEC_SUBPROCESS'] = env\n"
        "    p = os.path.join(d, f'x{env}.flac')\n"
        "    audio.save_audio(p, pcm, 44100)\n"
        "    audio.load_audio(p, 48000, 1)\n"
        "    audio.probe(p)\n"
        "maps = open('/proc/self/maps').read()\n"
        "print('MAPS ' + json.dumps([l.split()[-1] for l in maps.splitlines() if 'audsep' in l]))\n"
        "print('RAN ' + json.dumps(ran))\n")
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    jax_io = os.path.join(REPO, "audio_separator_tpu", "io")
    lines = dict(line.split(" ", 1) for line in proc.stdout.splitlines()
                 if line.startswith(("MAPS", "RAN")))
    mapped, ran = json.loads(lines["MAPS"]), json.loads(lines["RAN"])
    assert mapped and all(os.path.dirname(p) == audio.BUILD_DIR for p in set(mapped))
    codec_runs = [p for p in ran if "audsep" in os.path.basename(p)]
    assert codec_runs and all(os.path.dirname(p) == audio.BUILD_DIR for p in codec_runs)
    assert not any(p.startswith(jax_io) for p in set(mapped) | set(ran))
