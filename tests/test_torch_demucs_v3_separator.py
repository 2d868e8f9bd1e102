"""The port's Demucs v3 path against the JAX package's, on one synthetic
``HDemucs`` package under the published ``hdemucs_mmi`` signature: the
exact-length split (full windows through the engine, the tail by one direct
call at its exact length) for a track of one full window plus a tail, a track
shorter than one window, and a fetched subset of the sources; then
``hdemucs_mmi.yaml`` through ``Separator(device="cpu")``, written stems at
>= 40 dB against the JAX package (tests/test_parity_pipeline.py's bar).

The model is a small v3 with a BLSTM and a LocalState at its last level
(channels 8, nfft 64, depth 2) and 0.2 s windows, so that both branches of the
split run on short tracks. The track lengths are chosen so that the JAX side
compiles one engine program and one tail program for the whole file: the
long track's tail is as long as the short track, and the separator's shifted
pass (its track plus half a second) is as long as the long track."""

import json
import logging
import os

import numpy as np
import pytest
import requests
import torch

import jax

from audio_separator_tpu.architectures import demucs as jax_demucs
from audio_separator_tpu.architectures.demucs import DemucsSeparator as JaxDemucsSeparator
from audio_separator_tpu.io import audio as jax_audio_io
from audio_separator_tpu_torch.architectures.demucs import DemucsSeparator
from audio_separator_tpu_torch.io import audio as audio_io
from audio_separator_tpu_torch.models import htdemucs as ht
from audio_separator_tpu_torch.models.convert import flatten_tree
from audio_separator_tpu_torch.models.init_params import htdemucs_kwargs, init_htdemucs_params
from audio_separator_tpu_torch.separator import Separator

from test_torch_demucs_separator import _arch, _common, _save_package, _sdr
from torch_threads import one_torch_thread  # noqa: F401

SR = 44100
SOURCES = ("drums", "bass", "other", "vocals")
V3 = ht.HTDemucsConfig(sources=SOURCES, arch="hdemucs", channels=8, nfft=64, depth=2,
                       norm_starts=1, dconv_lstm=1, dconv_attn=1, dconv_comp=4, segment=0.2,
                       use_train_segment=False)
SEGMENT = V3.training_length  # 8820 samples; stride 6615 at overlap 0.25
SIGNATURE = "75fc33f5"  # the signature hdemucs_mmi.yaml names in the registry
# Windows at 0, 6615, 13230 and 19845 are full; the one at 26460 is a
# 3540-sample tail.
TRACKS = {"windows_and_tail": 30000, "shorter_than_a_window": 3540}
MAX_SHIFT = SR // 2
MIN_PARITY_SDR = 40.0


FAST_COMPILE = {"xla_backend_optimization_level": 0}


@pytest.fixture(autouse=True)
def offline(monkeypatch):
    """Every file is local: a request would be a fault of the test."""
    def refuse(*args, **kwargs):
        raise AssertionError(f"network request in an offline test: {args[1:3]}")

    monkeypatch.setattr(requests.sessions.Session, "request", refuse)


_COMPILED = {}


def _apply_hdemucs_compiled(params, cfg, mix, compute_dtype=None):
    """The JAX ``apply_hdemucs``, jitted per (config, shape) and compiled at
    ``xla_backend_optimization_level`` 0 when called on an array (the direct
    calls on the split's tail); inside a trace (the engine's program) the
    function itself. Its numerics are the function's: an eager call
    dispatches op by op and costs tens of seconds a new tail length here."""
    if isinstance(mix, jax.core.Tracer):
        return _APPLY_HDEMUCS(params, cfg, mix, compute_dtype=compute_dtype)
    key = (cfg, tuple(mix.shape), compute_dtype)
    if key not in _COMPILED:
        fn = jax.jit(lambda p, m: _APPLY_HDEMUCS(p, cfg, m, compute_dtype=compute_dtype))
        _COMPILED[key] = fn.lower(params, mix).compile(compiler_options=FAST_COMPILE)
    return _COMPILED[key](params, mix)


_APPLY_HDEMUCS = jax_demucs.apply_hdemucs


@pytest.fixture(autouse=True)
def fast_jax_tail(monkeypatch):
    monkeypatch.setattr(jax_demucs, "apply_hdemucs", _apply_hdemucs_compiled)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """``hdemucs_mmi.yaml`` (JSON-flow YAML), its package and an empty remote
    listing: the registry resolves the model locally."""
    directory = str(tmp_path_factory.mktemp("torch-demucs-v3"))
    tree = init_htdemucs_params(V3, seed=13)
    state = {k: torch.from_numpy(v) for k, v in flatten_tree(tree).items()}
    _save_package(directory, SIGNATURE, "HDemucs", htdemucs_kwargs(V3), state)
    with open(os.path.join(directory, "hdemucs_mmi.yaml"), "w") as f:
        json.dump({"models": [SIGNATURE]}, f)
    with open(os.path.join(directory, "download_checks.json"), "w") as f:
        f.write("{}")
    return directory


def _common_v3(model_dir, **extra):
    return {**_common(model_dir, **extra), "model_name": "hdemucs_mmi",
            "model_path": os.path.join(model_dir, "hdemucs_mmi.yaml")}


@pytest.fixture(scope="module")
def mix():
    rng = np.random.default_rng(6)
    n = max(TRACKS.values())
    t = np.arange(n) / SR
    return (0.3 * np.stack([np.sin(2 * np.pi * 220 * t), np.sin(2 * np.pi * 331 * t)])
            + 0.1 * rng.standard_normal((2, n))).astype(np.float32)


@pytest.fixture(scope="module")
def separators(model_dir):
    port = DemucsSeparator(common_config=_common_v3(model_dir, device="cpu"),
                           arch_config=_arch(0, True))
    ref = JaxDemucsSeparator(common_config=_common_v3(model_dir), arch_config=_arch(0, True))
    return port, ref


def test_hdemucs_package_loads_as_v3(separators):
    port, ref = separators
    (model,), weights = port._load_models()
    (jcfg, _params), = ref._load_models()[0]
    assert isinstance(model, ht.HDemucs) and model.cfg == V3 and weights == [[1.0] * 4]
    assert (jcfg.arch, jcfg.depth, jcfg.segment, jcfg.use_train_segment) == \
        ("hdemucs", V3.depth, V3.segment, False)


@pytest.mark.parametrize("track", sorted(TRACKS))
def test_exact_length_split_matches_jax(separators, mix, track):
    port, ref = separators
    length = TRACKS[track]
    model = port._load_models()[0][0]
    (jcfg, params), = ref._load_models()[0]
    got = port._apply_split(model, mix[:, :length])
    want = np.asarray(ref._apply_split(jcfg, params, mix[:, :length]))
    assert got.shape == want.shape == (4, 2, length) and np.isfinite(got).all()
    for i in range(4):
        assert _sdr(want[i], got[i]) >= MIN_PARITY_SDR, (i, _sdr(want[i], got[i]))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=1e-4 * scale)


@pytest.mark.parametrize("track", sorted(TRACKS))
def test_exact_length_split_fetches_a_subset(separators, mix, track):
    """The fetched rows equal those of the full result: through the engine
    (its ``fetch_stems``) and the direct tail call alike. The JAX side is
    compared on the short track, where its fetch is the direct call's (on the
    long one it would compile a second engine program)."""
    port, ref = separators
    length = TRACKS[track]
    model = port._load_models()[0][0]
    full = port._apply_split(model, mix[:, :length])
    got = port._apply_split(model, mix[:, :length], fetch=(3, 1))
    assert got.shape == (2, 2, length)
    np.testing.assert_allclose(got, full[[3, 1]], atol=1e-6 * np.abs(full).max())
    if track == "shorter_than_a_window":
        (jcfg, params), = ref._load_models()[0]
        want = np.asarray(ref._apply_split(jcfg, params, mix[:, :length], fetch=(3, 1)))
        assert want.shape == got.shape
        for j in range(2):
            assert _sdr(want[j], got[j]) >= MIN_PARITY_SDR


def test_hdemucs_mmi_through_the_separator_matches_jax(model_dir, mix, tmp_path):
    """One shift (a sequential pass over the track plus half a second, which
    runs a full window and a tail), every stem written at >= 40 dB. The JAX
    side is its architecture separator on the same files (its registry would
    look for the published package's own file name)."""
    wav = str(tmp_path / "song.wav")
    track = mix[:, :TRACKS["windows_and_tail"] - MAX_SHIFT]
    audio_io.save_audio(wav, track, SR)
    params = {"segment_size": "Default", "shifts": 1, "overlap": 0.25,
              "segments_enabled": True}
    torch_dir, jax_dir = str(tmp_path / "torch"), str(tmp_path / "jax")
    sep = Separator(model_file_dir=model_dir, output_dir=torch_dir, demucs_params=params,
                    device="cpu", log_level=logging.WARNING)
    sep.load_model("hdemucs_mmi.yaml")
    assert isinstance(sep.model_instance, DemucsSeparator)
    files = sep.separate(wav)
    ref = JaxDemucsSeparator(common_config=_common_v3(model_dir, out_dir=jax_dir),
                             arch_config=params)
    jax_files = ref.separate(wav)
    assert sorted(files) == sorted(jax_files) and len(files) == 4
    for name in files:
        got, sr = audio_io.load_audio(os.path.join(torch_dir, name))
        want, _ = jax_audio_io.load_audio(os.path.join(jax_dir, name))
        assert sr == SR and got.shape == want.shape == track.shape
        assert _sdr(want, got) >= MIN_PARITY_SDR, name
