"""MDX23C (TFC-TDF v3) through the port's ``Separator(device="cpu")`` against
the JAX package's ``Separator``: one synthetic checkpoint and YAML under the
published model's file names (``MDX23C-8KFFT-InstVoc_HQ_2.ckpt``,
``model_2_stem_full_band_8k.yaml``), resolved through each package's
registry, on one seeded WAV. The written stems must agree at >= 40 dB SDR
(tests/test_parity_pipeline.py's bar); the architecture's unfold demix,
before any file is written, at 1e-4 of the output scale (the module level)."""

import json
import logging
import os

import numpy as np
import pytest
import torch

from audio_separator_tpu.io import audio as jax_audio_io
from audio_separator_tpu_torch.architectures.mdxc import MDXCSeparator
from audio_separator_tpu_torch.io import audio as audio_io
from audio_separator_tpu_torch.separator import Separator

from torch_oracles.tfc_tdf_oracle import TFCTDFNetOracle

SR = 44100
MODEL = "MDX23C-8KFFT-InstVoc_HQ_2.ckpt"
CONFIG = "model_2_stem_full_band_8k.yaml"
MIN_PARITY_SDR = 40.0
# The small geometry of tests/test_tfc_tdf.py: chunk 64 * 63 samples.
MDXC_PARAMS = {"segment_size": 64, "override_model_segment_size": False,
               "batch_size": 2, "overlap": 2, "pitch_shift": 0}


def _sdr(ref, est):
    return 10 * np.log10(np.sum(ref ** 2) / max(np.sum((ref - est) ** 2), 1e-30))


def write_mdx23c_model(model_dir, seed=1):
    """A small TFC-TDF checkpoint in the upstream key layout and its YAML
    under the published model's file names, plus an empty remote listing so
    the registry resolves both locally."""
    torch.manual_seed(seed)
    oracle = TFCTDFNetOracle(num_subbands=2, num_scales=2, scale=(2, 2), l=1, c=8, g=8,
                             bn=2, dim_f=64, num_stems=2, norm_type="InstanceNorm")
    with torch.no_grad():
        for p in oracle.parameters():
            p.copy_(torch.randn_like(p) * 0.1)
    torch.save(oracle.state_dict(), os.path.join(model_dir, MODEL))
    config = {
        "audio": {"num_channels": 2, "sample_rate": SR, "n_fft": 256, "hop_length": 64,
                  "dim_f": 64, "dim_t": 64, "chunk_size": 64 * 63},
        "model": {"num_subbands": 2, "num_scales": 2, "scale": [2, 2],
                  "num_blocks_per_scale": 1, "num_channels": 8, "growth": 8,
                  "bottleneck_factor": 2, "norm": "InstanceNorm", "act": "gelu"},
        "training": {"instruments": ["Vocals", "Instrumental"], "target_instrument": None},
        "inference": {"dim_t": 64, "batch_size": 2},
    }
    with open(os.path.join(model_dir, CONFIG), "w") as f:
        json.dump(config, f)  # JSON-flow YAML
    with open(os.path.join(model_dir, "download_checks.json"), "w") as f:
        f.write("{}")


@pytest.fixture(scope="module")
def separated(tmp_path_factory):
    from audio_separator_tpu.separator import Separator as JaxSeparator

    tmp = tmp_path_factory.mktemp("torch-mdx23c")
    model_dir = str(tmp / "models")
    os.makedirs(model_dir)
    write_mdx23c_model(model_dir)
    rng = np.random.default_rng(5)
    n = int(2.5 * SR)
    t = np.arange(n) / SR
    mix = (0.3 * np.stack([np.sin(2 * np.pi * 220 * t), np.sin(2 * np.pi * 330 * t)])
           + 0.05 * rng.standard_normal((2, n))).astype(np.float32)
    wav = str(tmp / "song.wav")
    audio_io.save_audio(wav, mix, SR)

    outs = {}
    for name, cls, kw in (("torch", Separator, {"device": "cpu"}), ("jax", JaxSeparator, {})):
        out_dir = str(tmp / name)
        sep = cls(model_file_dir=model_dir, output_dir=out_dir, log_level=logging.WARNING,
                  mdxc_params=dict(MDXC_PARAMS), **kw)
        sep.load_model(MODEL)
        files = sep.separate(wav)
        outs[name] = (sep, out_dir, files)
    return mix, outs


def test_load_model_resolves_mdx23c_through_the_registry(separated):
    _, outs = separated
    sep = outs["torch"][0]
    inst = sep.model_instance
    assert isinstance(inst, MDXCSeparator) and not inst.is_roformer
    assert inst.stem_list == ["Vocals", "Instrumental"]
    assert inst.model_cfg.num_stems == 2
    assert next(inst.model.parameters()).dtype == torch.float32


def test_mdx23c_stems_match_jax(separated):
    mix, outs = separated
    _, torch_dir, torch_files = outs["torch"]
    _, jax_dir, jax_files = outs["jax"]
    assert sorted(torch_files) == sorted(jax_files)
    assert len(torch_files) == 2
    for name in torch_files:
        got, sr = audio_io.load_audio(os.path.join(torch_dir, name))
        want, _ = jax_audio_io.load_audio(os.path.join(jax_dir, name))
        assert sr == SR and got.shape == want.shape == mix.shape
        assert _sdr(want, got) >= MIN_PARITY_SDR, name


def test_mdx23c_unfold_demix_matches_jax(separated):
    """The unfold path (lead and tail padding, uniform windows at explicit
    positions, the crop) before any file is written."""
    mix, outs = separated
    got = outs["torch"][0].model_instance.demix(mix)
    want = outs["jax"][0].model_instance.demix(mix)
    assert set(got) == set(want) == {"Vocals", "Instrumental"}
    for stem in got:
        assert got[stem].shape == want[stem].shape == mix.shape
        scale = np.abs(want[stem]).max()
        np.testing.assert_allclose(got[stem], want[stem], atol=1e-4 * scale)


@pytest.mark.parametrize("total", [5000, 4032, 9000])
def test_unfold_covers_every_sample_evenly(separated, total):
    """With a model that returns its input, the unfold demix returns the mix
    itself: the divider is each sample's own window count, edges included."""
    _, outs = separated
    inst = outs["torch"][0].model_instance
    model = inst.model
    inst.model = lambda chunks: torch.stack([chunks, 2 * chunks], dim=1)
    try:
        mix = np.random.default_rng(total).standard_normal((2, total)).astype(np.float32)
        out = inst._demix_unfold(mix, 4032, 2016, 2)
    finally:
        inst.model = model
    assert out.shape == (2, 2, total)
    np.testing.assert_allclose(out[0], mix, atol=1e-6)
    np.testing.assert_allclose(out[1], 2 * mix, atol=1e-6)
