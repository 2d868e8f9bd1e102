"""Cross-job batching, ``warmup`` and chunked processing of the port's
``Separator(device="cpu")`` against the JAX package's.

* ``demix_jobs`` against the JAX package's and against the port's own solo
  ``overlap_add_demix`` per job (equal: no window crosses a job boundary and
  each sample sums the same windows in the same order);
* ``Separator.separate_batch`` of three WAVs of different lengths with a small
  BS-RoFormer (the default model's file names) at >= 40 dB SDR against the
  JAX package's written stems, and equal to the port's solo ``separate``;
* a batch of a 16-bit and a 24-bit file writes each file's stems at its own
  depth (the JAX package writes both at the last file's, ROADMAP Queue C2: a
  deliberate divergence);
* the sequential fallbacks (TFC-TDF, a track under 10 s, ``chunk_duration``);
* ``warmup`` leaves no file behind;
* ``chunk_duration`` output against the JAX package's chunked output.
"""

import json
import logging
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_separator_tpu.io import audio as jax_audio_io
from audio_separator_tpu.ops import demix as jax_demix
from audio_separator_tpu_torch.io import audio as audio_io
from audio_separator_tpu_torch.ops import demix
from audio_separator_tpu_torch.ops.stft import hamming_window
from audio_separator_tpu_torch.separator import DEFAULT_MODEL, Separator

from test_torch_mdxc_tfc_tdf_separator import MDXC_PARAMS, MODEL as MDX23C_MODEL
from test_torch_mdxc_tfc_tdf_separator import write_mdx23c_model
from torch_oracles.roformer_oracle import RoformerOracle

SR = 44100
FREQS = (16, 16, 32, 65)  # n_fft 256
MIN_PARITY_SDR = 40.0


def _sdr(ref, est):
    return 10 * np.log10(np.sum(ref ** 2) / max(np.sum((ref - est) ** 2), 1e-30))


def write_small_roformer(model_dir, seed=3, ckpt=DEFAULT_MODEL, yaml_name=None):
    """A small BS-RoFormer (vocals / other) checkpoint in the upstream key
    layout and its YAML, under the default model's file names unless others
    are given, plus an empty remote listing."""
    torch.manual_seed(seed)
    bins, start = [], 0
    for nf in FREQS:
        bins.append(list(range(start, start + nf)))
        start += nf
    oracle = RoformerOracle(kind="bs", band_bins=bins, dim=32, depth=1, heads=2,
                            dim_head=16, stereo=True, num_stems=1, t_depth=1, f_depth=1,
                            n_fft=256, hop=64, mask_depth=2)
    with torch.no_grad():
        for p in oracle.parameters():
            p.copy_(torch.randn_like(p) * 0.2)
    torch.save({"state_dict": oracle.state_dict()}, os.path.join(model_dir, ckpt))
    config = {
        "audio": {"sample_rate": SR, "hop_length": 64},
        "model": {"dim": 32, "depth": 1, "stereo": True, "num_stems": 1,
                  "time_transformer_depth": 1, "freq_transformer_depth": 1,
                  "freqs_per_bands": list(FREQS), "dim_head": 16, "heads": 2,
                  "stft_n_fft": 256, "stft_hop_length": 64, "stft_win_length": 256,
                  "mask_estimator_depth": 2},
        "training": {"instruments": ["vocals", "other"], "target_instrument": "vocals"},
        "inference": {"dim_t": 64},
    }
    with open(os.path.join(model_dir, yaml_name or ckpt.replace(".ckpt", ".yaml")), "w") as f:
        json.dump(config, f)  # JSON-flow YAML
    with open(os.path.join(model_dir, "download_checks.json"), "w") as f:
        f.write("{}")


def write_wav(path, seconds, seed, bit_depth=16):
    n = int(seconds * SR)
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    f0 = 180 + 40 * seed
    mix = (0.3 * np.stack([np.sin(2 * np.pi * f0 * t), np.sin(2 * np.pi * 1.5 * f0 * t)])
           + 0.05 * rng.standard_normal((2, n))).astype(np.float32)
    audio_io.save_audio(path, mix, SR, bit_depth=bit_depth)
    return mix


@pytest.fixture(scope="module")
def roformer_dir(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch-batch-model")
    write_small_roformer(str(tmp))
    return str(tmp)


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch-batch-wavs")
    paths = []
    for i, seconds in enumerate((10.2, 11.0, 12.3)):
        path = str(tmp / f"track{i}.wav")
        write_wav(path, seconds, seed=i)
        paths.append(path)
    return paths


def _port_separator(model_dir, out_dir, **kw):
    sep = Separator(model_file_dir=model_dir, output_dir=out_dir, device="cpu",
                    log_level=logging.WARNING, **kw)
    sep.load_model()
    return sep


# ----------------------------------------------------------------- demix_jobs


def _port_model(chunks):  # (B, C, chunk) -> (B, 2, C, chunk)
    return torch.stack([chunks * 0.5, torch.tanh(3.0 * chunks)], dim=1)


def _jax_model(chunks):
    return jnp.stack([chunks * 0.5, jnp.tanh(3.0 * chunks)], axis=1)


@pytest.mark.parametrize("batch_size,fetch_stems", [(3, None), (4, (1,))])
def test_demix_jobs_matches_jax_and_solo(batch_size, fetch_stems):
    rng = np.random.default_rng(0)
    chunk, step = 1024, 700
    mixes = [(rng.standard_normal((2, t)) * 0.4).astype(np.float32)
             for t in (5000, 800, 3000)]  # a clamped tail, a mix shorter than one window
    window = hamming_window(chunk).numpy()
    got = demix.demix_jobs(_port_model, mixes, chunk, step, window, num_stems=2,
                           batch_size=batch_size, fetch_stems=fetch_stems, device="cpu")
    want = jax_demix.demix_jobs(_jax_model, mixes, chunk, step, window, num_stems=2,
                                batch_size=batch_size, fetch_stems=fetch_stems,
                                quantized_transfer=False, quantized_upload=False)
    n_out = 2 if fetch_stems is None else 1
    for mix, g, w in zip(mixes, got, want):
        assert g.shape == w.shape == (n_out, 2, mix.shape[1])
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-6)
        solo = demix.overlap_add_demix(_port_model, mix, chunk, step, window, num_stems=2,
                                       batch_size=batch_size, fetch_stems=fetch_stems,
                                       device="cpu")
        np.testing.assert_array_equal(g, solo)


def test_demix_jobs_of_nothing_is_nothing():
    assert demix.demix_jobs(_port_model, [], 1024, 512, np.ones(1024, np.float32),
                            num_stems=2, batch_size=2, device="cpu") == []


# ----------------------------------------------------------- separate_batch


@pytest.fixture(scope="module")
def batched(roformer_dir, wavs, tmp_path_factory):
    from audio_separator_tpu.separator import Separator as JaxSeparator

    tmp = tmp_path_factory.mktemp("torch-batch-run")
    port = _port_separator(roformer_dir, str(tmp / "torch"))
    port_files = port.separate_batch(wavs)
    jax_sep = JaxSeparator(model_file_dir=roformer_dir, output_dir=str(tmp / "jax"),
                           log_level=logging.WARNING)
    jax_sep.load_model()
    jax_files = jax_sep.separate_batch(wavs)
    return port, str(tmp), port_files, jax_files


def test_separate_batch_matches_jax(batched, wavs):
    _, tmp, port_files, jax_files = batched
    assert len(port_files) == len(jax_files) == len(wavs)
    for wav, got_files, want_files in zip(wavs, port_files, jax_files):
        assert sorted(got_files) == sorted(want_files) and len(got_files) == 2
        mix, _ = audio_io.load_audio(wav)
        for name in got_files:
            got, sr = audio_io.load_audio(os.path.join(tmp, "torch", name))
            want, _ = jax_audio_io.load_audio(os.path.join(tmp, "jax", name))
            assert sr == SR and got.shape == want.shape == mix.shape
            assert _sdr(want, got) >= MIN_PARITY_SDR, name


def test_separate_batch_equals_solo_separate(batched, wavs, tmp_path):
    port, tmp, port_files, _ = batched
    solo_dir = str(tmp_path / "solo")
    port.output_dir = port.model_instance.output_dir = solo_dir
    try:
        for wav, batch_files in zip(wavs, port_files):
            solo_files = port.separate(wav)
            assert sorted(solo_files) == sorted(batch_files)
            for name in solo_files:
                got, _ = audio_io.load_audio(os.path.join(tmp, "torch", name))
                want, _ = audio_io.load_audio(os.path.join(solo_dir, name))
                np.testing.assert_array_equal(got, want)
    finally:
        port.output_dir = port.model_instance.output_dir = os.path.join(tmp, "torch")


def test_separate_batch_keeps_each_files_bit_depth(roformer_dir, tmp_path):
    a, b = str(tmp_path / "a16.wav"), str(tmp_path / "b24.wav")
    write_wav(a, 10.2, seed=4, bit_depth=16)
    write_wav(b, 10.5, seed=5, bit_depth=24)
    sep = _port_separator(roformer_dir, str(tmp_path / "out"))
    calls = []
    original = sep.model_instance._demix_batch
    sep.model_instance._demix_batch = lambda mixes: calls.append(len(mixes)) or original(mixes)
    files = sep.separate_batch([a, b])
    assert calls == [2]  # one engine pass for both files
    for depth, outputs in zip((16, 24), files):
        assert len(outputs) == 2
        for name in outputs:
            assert audio_io.probe(str(tmp_path / "out" / name)).bits_per_sample == depth


def _count_calls(sep):
    inst = sep.model_instance
    calls = {"separate": 0, "batch": 0}
    separate, demix_batch = inst.separate, inst._demix_batch

    def counted_separate(*a, **k):
        calls["separate"] += 1
        return separate(*a, **k)

    def counted_batch(*a, **k):
        calls["batch"] += 1
        return demix_batch(*a, **k)

    inst.separate, inst._demix_batch = counted_separate, counted_batch
    return calls


def test_separate_batch_falls_back_for_short_tracks(roformer_dir, wavs, tmp_path):
    short = str(tmp_path / "short.wav")
    write_wav(short, 2.0, seed=6)
    sep = _port_separator(roformer_dir, str(tmp_path / "out"))
    calls = _count_calls(sep)
    files = sep.separate_batch([wavs[0], short])
    assert calls == {"separate": 2, "batch": 0}
    assert [len(f) for f in files] == [2, 2]


def test_separate_batch_falls_back_under_chunk_duration(roformer_dir, wavs, tmp_path):
    sep = _port_separator(roformer_dir, str(tmp_path / "out"), chunk_duration=6.0)
    calls = _count_calls(sep)
    files = sep.separate_batch(wavs[:2])
    assert calls["batch"] == 0 and calls["separate"] == 4  # two chunks a file
    for outputs in files:
        assert len(outputs) == 2 and all(os.path.exists(p) for p in outputs)


def test_separate_batch_falls_back_for_tfc_tdf(tmp_path):
    model_dir = str(tmp_path / "models")
    os.makedirs(model_dir)
    write_mdx23c_model(model_dir)
    a, b = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    write_wav(a, 1.0, seed=7)
    write_wav(b, 1.5, seed=8)
    sep = Separator(model_file_dir=model_dir, output_dir=str(tmp_path / "out"), device="cpu",
                    log_level=logging.WARNING, mdxc_params=dict(MDXC_PARAMS))
    sep.load_model(MDX23C_MODEL)
    calls = _count_calls(sep)
    files = sep.separate_batch([a, b])
    assert calls == {"separate": 2, "batch": 0}
    assert [len(f) for f in files] == [2, 2]


# ------------------------------------------------------------ warmup, chunks


def test_warmup_leaves_no_file(roformer_dir, tmp_path):
    out_dir = tmp_path / "out"
    sep = _port_separator(roformer_dir, str(out_dir))
    elapsed = sep.warmup(seconds=2.0)
    assert elapsed > 0
    assert not out_dir.exists() or not any(out_dir.iterdir())
    assert sep.output_dir == sep.model_instance.output_dir == str(out_dir)


def test_warmup_needs_a_model(roformer_dir):
    sep = Separator(model_file_dir=roformer_dir, device="cpu", log_level=logging.WARNING)
    with pytest.raises(ValueError, match="Load a model"):
        sep.warmup()
    with pytest.raises(ValueError, match="Load a model"):
        sep.separate_batch(["a.wav", "b.wav"])


def test_chunked_output_matches_jax(roformer_dir, tmp_path):
    from audio_separator_tpu.separator import Separator as JaxSeparator

    wav = str(tmp_path / "long.wav")
    mix = write_wav(wav, 2.5, seed=9)
    port_dir, jax_dir = str(tmp_path / "torch"), str(tmp_path / "jax")
    got_files = _port_separator(roformer_dir, port_dir, chunk_duration=1.0).separate(wav)
    jax_sep = JaxSeparator(model_file_dir=roformer_dir, output_dir=jax_dir, chunk_duration=1.0,
                           output_format="WAV", log_level=logging.WARNING)
    jax_sep.load_model()
    want_files = jax_sep.separate(wav)
    assert [os.path.basename(p) for p in got_files] == \
        [os.path.basename(p) for p in want_files] == ["long_(other).wav", "long_(vocals).wav"]
    for g, w in zip(got_files, want_files):
        got, sr = audio_io.load_audio(g)
        want, _ = jax_audio_io.load_audio(w)
        assert sr == SR and got.shape == want.shape == mix.shape
        assert _sdr(want, got) >= MIN_PARITY_SDR, g
