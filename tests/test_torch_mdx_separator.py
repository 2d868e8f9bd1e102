"""MDX (ONNX Conv-TDF) through the port's ``Separator(device="cpu")`` against
the JAX package's ``Separator``: one torch-exported Conv-TDF graph at
tests/test_mdx_integration.py's geometry (n_fft 512, hop 128, dim_f 128,
segment 32), resolved through each package's registry by its MD5 in
``mdx_model_data.json``, on one seeded WAV. Written stems must agree at
>= 40 dB SDR (tests/test_parity_pipeline.py's bar); the demix, before any
file is written, at 1e-4 of the output scale. Denoise and
``invert_using_spec`` are held against tests/test_mdx_integration.py's
emulation of the reference chunk loop; ``separate_batch`` against solo
``separate`` calls."""

import json
import logging
import os

import numpy as np
import pytest
import torch

from audio_separator_tpu.io import audio as jax_audio_io
from audio_separator_tpu.ops import spec as jax_spec
from audio_separator_tpu_torch.architectures.mdx import MDXSeparator
from audio_separator_tpu_torch.io import audio as audio_io
from audio_separator_tpu_torch.separator import Separator
from audio_separator_tpu_torch.separator.registry import get_model_hash
from audio_separator_tpu_torch.utils import cli

# test_mdx_integration sets the exporter's onnxscript bypass on import.
from test_mdx_integration import (DIM_F, HOP, N_FFT, SEGMENT, MiniConvTDF,
                                  _reference_mdx_demix)

SR = 44100
MODEL = "UVR_test_mdx.onnx"
MIN_PARITY_SDR = 40.0
MODEL_DATA = {"compensate": 1.035, "mdx_dim_f_set": DIM_F, "mdx_dim_t_set": 5,
              "mdx_n_fft_scale_set": N_FFT, "primary_stem": "Instrumental"}
MDX_PARAMS = {"hop_length": HOP, "segment_size": SEGMENT, "overlap": 0.25,
              "batch_size": 2, "enable_denoise": False}


def _sdr(ref, est):
    return 10 * np.log10(np.sum(ref ** 2) / max(np.sum((ref - est) ** 2), 1e-30))


def write_mdx_model(model_dir, seed=11):
    """The Conv-TDF graph, its UVR model data keyed by the file's hash, and
    empty remote listings, so both registries resolve it without a
    download. Returns the torch module that was exported."""
    torch.manual_seed(seed)
    model = MiniConvTDF(f=DIM_F).eval()
    path = os.path.join(model_dir, MODEL)
    torch.onnx.export(model, torch.randn(1, 4, DIM_F, SEGMENT), path,
                      input_names=["input"], output_names=["output"], dynamo=False)
    with open(os.path.join(model_dir, "mdx_model_data.json"), "w") as f:
        json.dump({get_model_hash(path): MODEL_DATA}, f)
    for name in ("vr_model_data.json", "download_checks.json"):
        with open(os.path.join(model_dir, name), "w") as f:
            f.write("{}")
    return model


def write_wav(path, seconds, seed, bit_depth=16):
    n = int(seconds * SR)
    t = np.arange(n) / SR
    rng = np.random.default_rng(seed)
    mix = (0.3 * np.stack([np.sin(2 * np.pi * 220 * t), np.sin(2 * np.pi * 330 * t)])
           + 0.05 * rng.standard_normal((2, n))).astype(np.float32)
    audio_io.save_audio(path, mix, SR, bit_depth=bit_depth)
    return mix


def _port(model_dir, out_dir, **kw):
    params = dict(MDX_PARAMS, **kw.pop("mdx", {}))
    sep = Separator(model_file_dir=model_dir, output_dir=out_dir, device="cpu",
                    log_level=logging.WARNING, mdx_params=params, **kw)
    sep.load_model(MODEL)
    return sep


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch-mdx")
    model_dir = str(tmp / "models")
    os.makedirs(model_dir)
    model = write_mdx_model(model_dir)
    wav = str(tmp / "song.wav")
    mix = write_wav(wav, 2.5, seed=5)
    return tmp, model_dir, model, wav, mix


@pytest.fixture(scope="module")
def separated(setup):
    """The port's and the JAX package's Separator on the same file; the JAX
    MDXSeparator runs once here."""
    from audio_separator_tpu.separator import Separator as JaxSeparator

    tmp, model_dir, _, wav, _ = setup
    outs = {}
    for name, cls, kw in (("torch", Separator, {"device": "cpu"}), ("jax", JaxSeparator, {})):
        out_dir = str(tmp / name)
        sep = cls(model_file_dir=model_dir, output_dir=out_dir, log_level=logging.WARNING,
                  mdx_params=dict(MDX_PARAMS), **kw)
        sep.load_model(MODEL)
        outs[name] = (sep, out_dir, sep.separate(wav))
    return outs


def test_load_model_resolves_mdx_through_the_registry(separated):
    inst = separated["torch"][0].model_instance
    assert isinstance(inst, MDXSeparator)
    assert (inst.n_fft, inst.dim_f, inst.dim_t, inst.compensate) == (N_FFT, DIM_F, 32, 1.035)
    assert (inst.trim, inst.chunk_size) == (N_FFT // 2, HOP * (SEGMENT - 1))
    assert (inst.primary_stem_name, inst.secondary_stem_name) == ("Instrumental", "Vocals")
    assert all(p.device.type == "cpu" for p in inst._onnx_params.values())


def test_mdx_stems_match_jax(separated, setup):
    mix = setup[4]
    _, torch_dir, torch_files = separated["torch"]
    _, jax_dir, jax_files = separated["jax"]
    assert torch_files == jax_files and len(torch_files) == 2
    assert "(Vocals)" in torch_files[0]  # the secondary is written first
    for name in torch_files:
        got, sr = audio_io.load_audio(os.path.join(torch_dir, name))
        want, _ = jax_audio_io.load_audio(os.path.join(jax_dir, name))
        assert sr == SR and got.shape == want.shape == mix.shape
        assert _sdr(want, got) >= MIN_PARITY_SDR, name


@pytest.mark.parametrize("is_match_mix", [False, True])
def test_mdx_demix_matches_jax(separated, setup, is_match_mix):
    mix = setup[4]
    got = separated["torch"][0].model_instance.demix(mix, is_match_mix=is_match_mix)
    want = separated["jax"][0].model_instance.demix(mix, is_match_mix=is_match_mix)
    assert got.shape == want.shape == mix.shape
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("denoise,invert_using_spec", [(True, False), (False, True)])
def test_denoise_and_spectral_inversion_match_the_reference_loop(
        setup, tmp_path, denoise, invert_using_spec):
    """The primary against the reference chunk loop (the denoise double pass
    as the reference runs it, ref: mdx_separator.py:427-441), the secondary
    against the compensated subtraction or the reference's spectral
    inversion of that loop's match-mix pass."""
    _, model_dir, model, wav, _ = setup
    sep = _port(model_dir, str(tmp_path), invert_using_spec=invert_using_spec,
                mdx={"enable_denoise": denoise})
    inst = sep.model_instance
    inst.separate(wav)
    mix = inst.prepare_mix(wav)
    peak = np.abs(mix).max()
    mix = jax_spec.normalize(mix, 0.9, 0.0)
    net = (lambda s: model(s) * 0.5 - model(-s) * 0.5) if denoise else model
    primary = _reference_mdx_demix(net, mix, overlap=0.25) * peak
    if invert_using_spec:
        raw = _reference_mdx_demix(model, mix, overlap=0.25, is_match_mix=True)
        secondary = jax_spec.invert_stem(raw, primary * 1.035).T
    else:
        secondary = mix - primary * 1.035
    # The spectral inversion's iSTFT gives whole hops only (as the reference's).
    assert primary.shape == mix.shape
    for got, want in ((inst.primary_source.T, primary), (inst.secondary_source.T, secondary)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=2e-3 * np.abs(want).max())


@pytest.mark.parametrize("invert_using_spec", [False, True])
def test_separate_batch_equals_solo_at_each_files_depth(setup, tmp_path, invert_using_spec):
    """A 16-bit and a 24-bit WAV through one batched pass: each output equals
    its solo ``separate`` and is written at its own input depth (ROADMAP C2:
    the JAX package writes the batch at the last file's depth)."""
    _, model_dir, _, _, _ = setup
    wavs = [str(tmp_path / "a16.wav"), str(tmp_path / "b24.wav")]
    write_wav(wavs[0], 1.3, seed=1, bit_depth=16)
    write_wav(wavs[1], 2.1, seed=2, bit_depth=24)
    solo_dir, batch_dir = str(tmp_path / "solo"), str(tmp_path / "batch")
    solo_sep = _port(model_dir, solo_dir, invert_using_spec=invert_using_spec)
    solo = [solo_sep.separate(w) for w in wavs]
    batch = _port(model_dir, batch_dir, invert_using_spec=invert_using_spec
                  ).separate_batch(wavs)
    assert batch == solo
    for files, depth in zip(batch, (16, 24)):
        for name in files:
            a, _ = audio_io.load_audio(os.path.join(solo_dir, name))
            b, _ = audio_io.load_audio(os.path.join(batch_dir, name))
            assert audio_io.probe(os.path.join(batch_dir, name)).bits_per_sample == depth
            np.testing.assert_allclose(b, a, atol=2.0 ** -(depth - 1), rtol=0)


def test_demix_batch_equals_solo_demix(separated):
    inst = separated["torch"][0].model_instance
    rng = np.random.default_rng(3)
    mixes = [(rng.standard_normal((2, n)) * 0.2).astype(np.float32) for n in (9000, 17000)]
    for got, m in zip(inst._demix_batch(mixes), mixes):
        np.testing.assert_allclose(got, inst.demix(m), atol=1e-6, rtol=0)


def test_output_single_stem_and_bf16(setup, tmp_path, separated):
    """``output_single_stem`` writes only that stem; ``use_autocast`` runs
    the net in bf16 and stays near float32 (the JAX package's bound)."""
    _, model_dir, _, wav, _ = setup
    sep = _port(model_dir, str(tmp_path), output_single_stem="Instrumental",
                use_autocast=True)
    files = sep.separate(wav)
    assert len(files) == 1 and "(Instrumental)" in files[0]
    half, _ = audio_io.load_audio(os.path.join(str(tmp_path), files[0]))
    _, torch_dir, torch_files = separated["torch"]
    full, _ = audio_io.load_audio(os.path.join(torch_dir, files[0]))
    assert np.abs(half - full).max() < 0.1 * np.abs(full).max()


def test_the_cli_separates_with_an_mdx_model(setup, separated, tmp_path):
    _, model_dir, _, wav, _ = setup
    out_dir = str(tmp_path / "cli")
    cli.main([wav, "--device", "cpu", "--model_filename", MODEL, "--model_file_dir", model_dir,
              "--output_dir", out_dir, "--output_format", "WAV", "--log_level", "warning",
              "--mdx_segment_size", str(SEGMENT), "--mdx_hop_length", str(HOP),
              "--mdx_batch_size", "2"])
    _, torch_dir, torch_files = separated["torch"]
    assert sorted(os.listdir(out_dir)) == sorted(torch_files)
    for name in torch_files:
        np.testing.assert_array_equal(audio_io.load_audio(os.path.join(out_dir, name))[0],
                                      audio_io.load_audio(os.path.join(torch_dir, name))[0])
