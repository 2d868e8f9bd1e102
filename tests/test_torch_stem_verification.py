"""The port's stem verification (``audio_separator_tpu_torch/utils/
audio_verification``): the regression-tier label policy of
``tests/test_stem_verification.py`` on the port's copy, and the same
verdicts, correlations and classifications from both packages on the same
files. The JAX all-models sweep tool (``tools/stem_verification.py``) stays
on the JAX package and is tested there."""

import dataclasses

import numpy as np
import pytest

from audio_separator_tpu.utils import audio_verification as jax_av
from audio_separator_tpu_torch.io import audio as audio_io
from audio_separator_tpu_torch.utils import audio_verification as av
from audio_separator_tpu_torch.utils.audio_verification import (is_specialized_model,
                                                                verify_stem_label)

from torch_threads import one_torch_thread  # noqa: F401

SR = 44100
N = SR * 2
VOCAL_REF = "mardy20s_(Vocals)_mel_band_roformer_karaoke_aufr33_viperx_sdr_10.flac"
INST_REF = "mardy20s_(Instrumental)_mel_band_roformer_karaoke_aufr33_viperx_sdr_10.flac"


@pytest.fixture(scope="module")
def refs():
    """Synthetic reference trio: uncorrelated vocal/inst, mix = sum."""
    rng = np.random.default_rng(7)
    vocal = (rng.standard_normal(N) * 0.1).astype(np.float32)
    inst = (rng.standard_normal(N) * 0.1).astype(np.float32)
    return vocal, inst, vocal + inst, N


def _write(tmp_path, name, mono):
    path = str(tmp_path / name)
    audio_io.save_audio(path, np.stack([mono, mono]), SR)
    return path


def test_port_correct_vocal_stem_passes(refs, tmp_path):
    vocal, inst, mix, n = refs
    noisy = vocal + np.random.default_rng(1).standard_normal(n).astype(np.float32) * 0.01
    passed, msg = verify_stem_label(_write(tmp_path, "x_(Vocals)_m.wav", noisy), "Vocals",
                                    vocal, inst, mix, n)
    assert passed, msg


def test_port_mislabelled_vocal_stem_fails(refs, tmp_path):
    vocal, inst, mix, n = refs
    passed, msg = verify_stem_label(_write(tmp_path, "x_(Vocals)_m.wav", inst), "Vocals",
                                    vocal, inst, mix, n)
    assert not passed and "detected INSTRUMENTAL" in msg


def test_port_silent_primary_stem_fails(refs, tmp_path):
    vocal, inst, mix, n = refs
    path = _write(tmp_path, "x_(Instrumental)_m.wav", np.zeros(n, np.float32))
    passed, msg = verify_stem_label(path, "Instrumental", vocal, inst, mix, n)
    assert not passed and "SILENT" in msg


def test_port_mix_leak_fails(refs, tmp_path):
    vocal, inst, mix, n = refs
    path = _write(tmp_path, "x_(Instrumental)_m.wav", mix)
    passed, msg = verify_stem_label(path, "Instrumental", vocal, inst, mix, n)
    assert not passed and "FULL_MIX" in msg


def test_port_silent_sub_stem_passes(refs, tmp_path):
    vocal, inst, mix, n = refs
    path = _write(tmp_path, "x_(Drums)_m.wav", np.zeros(n, np.float32))
    passed, msg = verify_stem_label(path, "Drums", vocal, inst, mix, n)
    assert passed, msg


def test_port_utility_stem_mix_passthrough_passes(refs, tmp_path):
    vocal, inst, mix, n = refs
    path = _write(tmp_path, "x_(No Reverb)_m.wav", mix)
    passed, msg = verify_stem_label(path, "No Reverb", vocal, inst, mix, n)
    assert passed, msg


def test_port_partial_vocal_low_corr_passes(refs, tmp_path):
    vocal, inst, mix, n = refs
    backing = (vocal * 0.3
               + np.random.default_rng(3).standard_normal(n).astype(np.float32) * 0.08)
    path = _write(tmp_path, "x_(Backing Vocals)_m.wav", backing)
    passed, msg = verify_stem_label(path, "Backing Vocals", vocal, inst, mix, n)
    assert passed, msg


def test_port_unknown_label_fails_with_reason(refs, tmp_path):
    vocal, inst, mix, n = refs
    path = _write(tmp_path, "x_(Mystery)_m.wav", vocal)
    passed, msg = verify_stem_label(path, "Mystery", vocal, inst, mix, n)
    assert not passed and "unknown stem type" in msg


def test_port_specialized_model_patterns():
    assert is_specialized_model("UVR-BVE-4B_SN-44100-1.pth")
    assert is_specialized_model("UVR-DeEcho-DeReverb.pth")
    assert is_specialized_model("x.ckpt", friendly_name="Mel Band De-Noise")
    assert not is_specialized_model("model_bs_roformer_ep_317_sdr_12.9755.ckpt")
    for name in ("UVR-BVE-4B_SN-44100-1.pth", "model_bs_roformer_ep_317_sdr_12.9755.ckpt",
                 "UVR-De-Echo-Normal.pth"):
        assert is_specialized_model(name) == jax_av.is_specialized_model(name)


# ---------------------------------------------------------------------------
# Both packages on the same files


@pytest.fixture(scope="module")
def inputs(refs, tmp_path_factory):
    """The reference trio under the file names ``load_references`` reads,
    and one stem of each kind."""
    vocal, inst, mix, n = refs
    tmp = tmp_path_factory.mktemp("stem-verification")
    for name, mono in ((VOCAL_REF, vocal), (INST_REF, inst), ("mardy20s.flac", mix)):
        _write(tmp, name, mono)
    rng = np.random.default_rng(5)
    stems = {
        "Vocals": vocal + 0.01 * rng.standard_normal(n).astype(np.float32),
        "Instrumental": inst + 0.3 * vocal,
        "Drums": np.zeros(n, np.float32),
        "No Reverb": mix,
        "Backing Vocals": 0.3 * vocal + 0.08 * rng.standard_normal(n).astype(np.float32),
        "Mystery": 0.5 * (vocal - inst),
    }
    paths = {label: _write(tmp, f"x_({label})_m.wav", mono) for label, mono in stems.items()}
    return str(tmp), paths


def test_load_references_matches_jax(inputs):
    input_dir, _ = inputs
    got = av.load_references(input_dir)
    want = jax_av.load_references(input_dir)
    assert got[3] == want[3] == N
    for g, w in zip(got[:3], want[:3]):
        assert g.shape == w.shape == (N,)
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("label", ["Vocals", "Instrumental", "Drums", "No Reverb",
                                   "Backing Vocals", "Mystery"])
def test_stem_verdicts_match_jax(inputs, label):
    input_dir, paths = inputs
    references = av.load_references(input_dir)
    got = av.verify_stem(paths[label], label, *references)
    want = jax_av.verify_stem(paths[label], label, *references)
    assert type(got).__name__ == type(want).__name__ == "StemVerification"
    assert dataclasses.astuple(got) == pytest.approx(dataclasses.astuple(want), nan_ok=True)
    assert (got.detected_content, got.label_matches) == (want.detected_content,
                                                         want.label_matches)
    assert (av.verify_stem_label(paths[label], label, *references)
            == jax_av.verify_stem_label(paths[label], label, *references))


def test_classify_audio_matches_jax(refs):
    vocal, inst, mix, n = refs
    rng = np.random.default_rng(6)
    for y in (mix, vocal, inst, np.zeros(n // 2), 0.001 * rng.standard_normal(n),
              rng.standard_normal(n + 100)):
        got = av.classify_audio(y, vocal, inst, mix, n)
        want = jax_av.classify_audio(y, vocal, inst, mix, n)
        assert got[-1] == want[-1]
        np.testing.assert_array_equal(np.asarray(got[:-1]), np.asarray(want[:-1]))
