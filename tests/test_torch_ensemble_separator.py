"""Ensembles through the port's ``Separator(device="cpu")`` against the JAX
package's ``Separator``: a list of two small models and a named preset
(stems grouped by canonical name, the output names, every written stem at
>= 40 dB against the JAX package, tests/test_parity_pipeline.py's bar), the
presets listed from the port's own copy of the JSON, an unknown preset and an
invalid algorithm refused as in JAX, and an ensemble's ``warmup``. The
members are small BS-RoFormers written under the file names the registry
knows, so that nothing is fetched."""

import logging
import os

import numpy as np
import pytest
import requests

from audio_separator_tpu.io import audio as jax_audio_io
from audio_separator_tpu.separator import Separator as JaxSeparator
from audio_separator_tpu_torch.io import audio as audio_io
from audio_separator_tpu_torch.separator import Separator

from test_torch_separate_batch import write_small_roformer
from torch_threads import one_torch_thread  # noqa: F401

SR = 44100
MIN_PARITY_SDR = 40.0
CUSTOM = ("bs_roformer_vocals_a.ckpt", "bs_roformer_vocals_b.ckpt")
PRESET = "vocal_balanced"  # avg_fft over two RoFormers
PRESET_FILES = {"bs_roformer_vocals_resurrection_unwa.ckpt":
                "config_bs_roformer_vocals_resurrection_unwa.yaml",
                "melband_roformer_big_beta6x.ckpt": "config_melbandroformer_big_beta6x.yaml"}


def _sdr(ref, est):
    return 10 * np.log10(np.sum(ref ** 2) / max(np.sum((ref - est) ** 2), 1e-30))


@pytest.fixture(autouse=True)
def offline(monkeypatch):
    """Every file is local: a request would be a fault of the test."""
    def refuse(*args, **kwargs):
        raise AssertionError(f"network request in an offline test: {args[1:3]}")

    monkeypatch.setattr(requests.sessions.Session, "request", refuse)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("torch-ensemble-models"))
    for seed, ckpt in enumerate(CUSTOM):
        write_small_roformer(directory, seed=seed + 3, ckpt=ckpt)
    for seed, (ckpt, yaml_name) in enumerate(PRESET_FILES.items()):
        write_small_roformer(directory, seed=seed + 7, ckpt=ckpt, yaml_name=yaml_name)
    return directory


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch-ensemble-wav") / "song.wav")
    rng = np.random.default_rng(12)
    t = np.arange(SR) / SR
    mix = (0.3 * np.stack([np.sin(2 * np.pi * 220 * t), np.sin(2 * np.pi * 330 * t)])
           + 0.05 * rng.standard_normal((2, SR))).astype(np.float32)
    audio_io.save_audio(path, mix, SR)
    return path


def _run_both(model_dir, wav, out_root, models, **kwargs):
    outs = {}
    for name, cls, extra in (("torch", Separator, {"device": "cpu"}), ("jax", JaxSeparator, {})):
        out_dir = os.path.join(out_root, name)
        sep = cls(model_file_dir=model_dir, output_dir=out_dir, log_level=logging.WARNING,
                  **kwargs, **extra)
        if models is None:
            sep.load_model()
        else:
            sep.load_model(list(models))
        outs[name] = (sep, out_dir, sep.separate(wav))
    return outs


def _check_against_jax(outs):
    _, torch_dir, files = outs["torch"]
    _, jax_dir, jax_files = outs["jax"]
    names = [os.path.basename(f) for f in files]
    assert names == [os.path.basename(f) for f in jax_files]
    assert files == [os.path.join(torch_dir, name) for name in names]
    for name in names:
        got, sr = audio_io.load_audio(os.path.join(torch_dir, name))
        want, _ = jax_audio_io.load_audio(os.path.join(jax_dir, name))
        assert sr == SR and got.shape == want.shape
        assert _sdr(want, got) >= MIN_PARITY_SDR, (name, _sdr(want, got))


def test_two_models_ensemble_like_jax(model_dir, wav, tmp_path):
    """Both members write (vocals) and (other); a two-stem member's "other"
    joins the Instrumental group. Outputs are named after the members."""
    outs = _run_both(model_dir, wav, str(tmp_path), CUSTOM, ensemble_algorithm="uvr_max_spec")
    sep, _, files = outs["torch"]
    assert sorted(files) == [os.path.join(str(tmp_path / "torch"), f"song_({stem})_custom_"
                                          f"ensemble_vocals_a_vocals_b.wav")
                             for stem in ("Instrumental", "Vocals")]
    _check_against_jax(outs)
    # The members are loaded at each separate; the list stays the model.
    assert sep.model_filename == list(CUSTOM) and sep.model_instance is None


def test_preset_ensembles_like_jax(model_dir, wav, tmp_path):
    outs = _run_both(model_dir, wav, str(tmp_path), None, ensemble_preset=PRESET)
    sep, _, files = outs["torch"]
    assert sep.ensemble_algorithm == "avg_fft" and sep.model_filenames == list(PRESET_FILES)
    assert sorted(os.path.basename(f) for f in files) == [
        f"song_({stem})_preset_{PRESET}.wav" for stem in ("Instrumental", "Vocals")]
    _check_against_jax(outs)


def test_ensemble_warmup_runs_every_member(model_dir):
    sep = Separator(model_file_dir=model_dir, device="cpu", log_level=logging.WARNING,
                    ensemble_algorithm="avg_wave")
    sep.load_model(list(CUSTOM))
    assert sep.warmup(1.0) > 0
    assert sep.model_filename == list(CUSTOM) and sep.output_dir is None


def test_list_ensemble_presets_is_the_jax_list(model_dir):
    got = Separator(info_only=True, model_file_dir=model_dir).list_ensemble_presets()
    want = JaxSeparator(info_only=True, model_file_dir=model_dir).list_ensemble_presets()
    assert got == want and len(got) == 9


@pytest.mark.parametrize("kwargs,match", [
    ({"ensemble_preset": "no_such_preset"}, "Unknown ensemble preset"),
    ({"ensemble_algorithm": "loudest_wave"}, "Invalid ensemble algorithm"),
])
def test_bad_ensemble_arguments_raise_as_in_jax(model_dir, kwargs, match):
    messages = []
    for cls, extra in ((Separator, {"device": "cpu"}), (JaxSeparator, {})):
        with pytest.raises(ValueError, match=match) as exc:
            cls(model_file_dir=model_dir, log_level=logging.WARNING, **kwargs, **extra)
        messages.append(str(exc.value))
    assert messages[0] == messages[1]
