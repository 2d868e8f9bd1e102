"""The port's Mel-Band RoFormer against the benchmark's plain reference
(``benchmark/reference/mel_roformer.py``) on the CPU: the reference's band
membership against the librosa golden, the module on one upstream-layout
state dict loaded through ``models/convert``, the normal path from the
benchmark family's checkpoint through ``Separator`` to the written stems,
the band stages' spans, and the parameter count of the benchmark's
configuration."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from audio_separator_tpu_torch.models import convert
from audio_separator_tpu_torch.models.roformer import Roformer
from audio_separator_tpu_torch.separator.roformer_config import build_roformer_config
from audio_separator_tpu_torch.separator.separator import Separator
from audio_separator_tpu_torch.utils import tracing

from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
if BENCH not in sys.path:
    sys.path.append(BENCH)

from benchlib import manifest, seeded  # noqa: E402
from reference import mel_roformer, separate  # noqa: E402

GOLDEN = os.path.join(ROOT, "tests", "goldens", "mel_membership.npz")
CONFIG = os.path.join(BENCH, "configs", "mel_roformer_ep3005.json")


def _tiny_yaml(num_stems=1):
    """dim 48, depth 2, 24 bands at n_fft 512, stereo; the published
    mask-estimator depth 2 and output norms; ``dim_t`` 33 (4096-sample
    windows)."""
    return {
        "audio": {"chunk_size": 4096, "dim_t": 33, "hop_length": 128, "n_fft": 512,
                  "num_channels": 2, "sample_rate": 44100},
        "model": {"dim": 48, "depth": 2, "stereo": True, "num_stems": num_stems,
                  "time_transformer_depth": 1, "freq_transformer_depth": 1,
                  "linear_transformer_depth": 0, "num_bands": 24, "dim_head": 16, "heads": 4,
                  "sample_rate": 44100, "stft_n_fft": 512, "stft_hop_length": 128,
                  "stft_win_length": 512, "mask_estimator_depth": 2},
        "training": {"instruments": ["vocals", "other"], "target_instrument": "vocals"},
        "inference": {"dim_t": 33},
    }


def _seeded(yaml, seed):
    with torch.device("meta"):
        shell = mel_roformer.from_config(yaml)
    state = seeded.seeded_state(shell, seed, "cpu", seeded.fan_in_rule)
    ref = mel_roformer.from_config(yaml).eval()
    ref.load_state_dict(state)
    return ref, state


def _port(yaml, state):
    cfg = build_roformer_config(yaml)
    tree = convert.convert_roformer({k: v.numpy() for k, v in state.items()}, cfg)
    return convert.load_jax_params(Roformer(cfg), tree).eval()


@pytest.mark.parametrize("geometry", ["member_44100_2048_60", "member_44100_2048_80",
                                      "member_44100_512_24"])
def test_reference_membership_is_the_librosa_golden(geometry):
    with np.load(GOLDEN) as golden:
        want = golden[geometry]
    _, sr, n_fft, bands = geometry.split("_")
    got = mel_roformer.band_membership(int(sr), int(n_fft), int(bands))
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("num_stems", [1, 2])
def test_port_matches_reference_on_one_upstream_state_dict(num_stems):
    """Both sides compute in float32 from the same weights; they differ in
    the order of their sums (stacked band runs and mask products against
    per-band linears, the port's STFT against ``torch.stft``), which at this
    depth moves outputs by about 1e-6 of their scale. 3e-5 of the scale, the
    bound below, is far under what a wrong band, row order or norm gives
    (order one)."""
    yaml = _tiny_yaml(num_stems)
    ref, state = _seeded(yaml, 2**33 + num_stems)
    port = _port(yaml, state)
    audio = torch.from_numpy(
        np.random.default_rng(num_stems).standard_normal((2, 2, 8192)).astype(np.float32) * 0.3)
    with torch.no_grad():
        want = ref(audio)
        got = port(audio)
    assert got.shape == want.shape == (2, num_stems, 2, 8192)
    scale = want.abs().max().item()
    assert scale > 1e-3
    err = (got - want).abs().max().item()
    assert err <= 3e-5 * scale, (err, scale)  # 7.9e-7 and 7.0e-7 of the scale here


def test_separator_writes_the_reference_stems(tmp_path):
    """The normal path: the family's seeded checkpoint in the upstream
    layout, ``Separator.load_model`` by its published file name (the YAML
    beside it), ``separate`` of a 3 s clip, both stems as 16-bit WAV; the
    reference's plan of the same windows (``separate_song``). A 3 s clip
    turns ``override_model_segment_size`` on, so the options' segment size
    is the YAML's ``dim_t``: both sides run 4096-sample windows. The limit
    is the tiny benchmark cell's (1e-4 of a stem's norm in 16-bit units, a
    float32 sound reading a few 1e-5)."""
    fam = manifest.plugin("families", "mel_roformer")
    with open(CONFIG) as f:
        cfg = dict(json.load(f), yaml=_tiny_yaml())
    seed = 2**40 + 7
    params = {"segment_size": 33, "override_model_segment_size": False, "batch_size": 4,
              "overlap": 8, "pitch_shift": 0}
    name = fam.write_model(cfg, seed, str(tmp_path / "models"), "cpu")
    (song, _), = seeded.write_songs(str(tmp_path / "in"), seed, [3.0], 44100, "cpu")
    sep = Separator(model_file_dir=str(tmp_path / "models"), output_dir=str(tmp_path / "out"),
                    output_format="WAV", device="cpu", mdxc_params=dict(params))
    sep.load_model(name)
    outs = [o if os.path.isabs(o) else str(tmp_path / "out" / o) for o in sep.separate(song)]
    assert len(outs) == 2
    ref = fam.reference(cfg, "cpu", fam.seeded_state(cfg, seed, "cpu"))
    want = fam.separate_song(ref, separate.decode(song), cfg, params, "cpu")
    errors = separate.stem_errors(outs, want)
    assert set(errors) == {"vocals", "other"}
    assert max(errors.values()) <= 1e-4, errors


@pytest.mark.parametrize("kind", ["bs", "mel"])
def test_band_stages_make_one_span_each_a_forward(kind):
    yaml = _tiny_yaml()
    if kind == "bs":
        model = dict(yaml["model"], freqs_per_bands=[8] * 16 + [129])
        del model["num_bands"]
        yaml = dict(yaml, model=model)
    port = Roformer(build_roformer_config(yaml)).eval()
    audio = torch.zeros((3, 2, 4096))
    stages = ["kernel.band_split", "kernel.mask_estimate", "kernel.band_merge"]
    layout = port.layout
    want = {"batch": 3, "frames": 33, "bands": layout.n_bands, "runs": len(layout.runs),
            "hidden_layers": 2 if kind == "mel" else 1,
            "features": 2 * 2 * (257 if kind == "bs" else int(
                mel_roformer.band_membership(44100, 512, 24).sum()))}
    tracing.disable()
    tracing.clear()
    try:
        with torch.no_grad():
            port(audio)
        assert tracing.records() == []
        tracing.enable()
        with torch.no_grad():
            port(audio)
        records = [r for r in tracing.records() if r.name in stages]
        assert [r.name for r in records] == stages
        for r in records:
            assert r.attrs == want
    finally:
        tracing.disable()
        tracing.clear()
    assert (want["features"] > layout.n_feat) == (kind == "mel")


def test_configuration_parameters_match_reference_and_port():
    with open(CONFIG) as f:
        cfg = json.load(f)
    assert cfg["reduced"] == [] and cfg["family"] == "mel_roformer"
    with torch.device("meta"):
        ref = mel_roformer.from_config(cfg["yaml"])
        port = Roformer(build_roformer_config(cfg["yaml"]))
    count = sum(p.numel() for p in ref.parameters())
    assert count == cfg["parameters"] == sum(p.numel() for p in port.parameters())
    assert port.layout.n_bands == 60 and port.layout.features == 7916
