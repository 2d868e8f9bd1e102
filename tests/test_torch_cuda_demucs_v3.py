"""Demucs v3 and ensembling on a CUDA card: the ``HDemucs`` forward against
the CPU at a small and at the published width, the exact-length split on the
card against the CPU, and one 30 s ensemble ``separate`` of the full-width
default BS-RoFormer and the full-width HTDemucs bag, which must launch the
fused attention block 24 times, the fused feed-forward block 24 times, the
whole-sequence attention 18 times and the GroupNorm kernel 126 times. Each test decides inside its fixture
whether a card is present and skips without one. Run on the card with

    python -m pytest tests/test_torch_cuda_demucs_v3.py --noconftest -q

Floor: 100 dB SDR of the card's float32 output against the CPU's (the MDX
bar, PERF.md §2)."""

import logging
import math
import os
import sys

import numpy as np
import pytest
import torch

from audio_separator_tpu_torch.architectures.demucs import DemucsSeparator
from audio_separator_tpu_torch.models import htdemucs as ht
from audio_separator_tpu_torch.models.convert import load_jax_hdemucs_params
from audio_separator_tpu_torch.models.init_params import (hdemucs_full_config,
                                                          init_htdemucs_params)
from audio_separator_tpu_torch.ops import _build
from audio_separator_tpu_torch.separator import Separator
from audio_separator_tpu_torch.separator.separator import DEFAULT_MODEL

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (its model writers)

pytestmark = pytest.mark.gpu

FLOOR_DB = 100.0
SOURCES = ("drums", "bass", "other", "vocals")
SMALL = ht.HTDemucsConfig(sources=SOURCES, arch="hdemucs", channels=8, nfft=256, depth=4,
                          norm_starts=2, dconv_lstm=2, dconv_attn=2, dconv_comp=4,
                          segment=0.5, use_train_segment=False)
SPLIT = ht.HTDemucsConfig(sources=SOURCES, arch="hdemucs", channels=8, nfft=64, depth=2,
                          norm_starts=1, dconv_lstm=1, dconv_attn=1, dconv_comp=4,
                          segment=0.2, use_train_segment=False)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = True  # the module's own scope must hold
    torch.backends.cudnn.allow_tf32 = True
    return torch.device("cuda")


def _sdr(ref, est):
    ref, est = np.asarray(ref, np.float64), np.asarray(est, np.float64)
    return 10 * math.log10(np.sum(ref ** 2) / max(np.sum((ref - est) ** 2), 1e-300))


def _mix(channels, n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 44100
    return (0.2 * np.stack([np.sin(2 * np.pi * (220 + 57 * c) * t) for c in range(channels)])
            + 0.05 * rng.standard_normal((channels, n))).astype(np.float32)


@pytest.mark.parametrize("width,seconds", [("small", 0.5), ("published", 10.0)])
def test_hdemucs_forward_on_card_matches_cpu(cuda, width, seconds):
    """The published width at 10 s (a chunk shorter than a window runs at
    its exact length)."""
    cfg = SMALL if width == "small" else hdemucs_full_config()
    tree = init_htdemucs_params(cfg, seed=4)
    mix = torch.from_numpy(_mix(2, int(seconds * 44100), seed=4)[None])
    cpu = load_jax_hdemucs_params(ht.HDemucs(cfg), tree).eval()
    want = cpu(mix).numpy()
    card = load_jax_hdemucs_params(ht.HDemucs(cfg), tree).to(cuda).eval()
    got = card(mix.to(cuda)).cpu().numpy()
    assert got.shape == want.shape == (1, 4, 2, mix.shape[-1]) and np.isfinite(got).all()
    for i in range(4):
        assert _sdr(want[:, i], got[:, i]) >= FLOOR_DB, (i, _sdr(want[:, i], got[:, i]))


def test_exact_length_split_on_card_matches_cpu(cuda, tmp_path):
    """30000 samples in 8820-sample windows: four full windows through the
    engine and a 3540-sample tail by a direct call, on the card and on the
    CPU."""
    chip_smoke.write_synthetic_demucs_bag(str(tmp_path), 13, cfg=SPLIT, signature="75fc33f5",
                                          bag="hdemucs_mmi.yaml")
    mix = _mix(2, 30000, seed=6)
    outs = {}
    for device in ("cpu", "cuda"):
        common = {"logger": logging.getLogger("test"), "model_name": "hdemucs_mmi",
                  "model_path": str(tmp_path / "hdemucs_mmi.yaml"), "model_data": {},
                  "output_format": "WAV", "sample_rate": 44100, "device": torch.device(device)}
        sep = DemucsSeparator(common_config=common,
                              arch_config={"segment_size": "Default", "shifts": 0,
                                           "overlap": 0.25, "segments_enabled": True})
        model = sep._load_models()[0][0]
        assert isinstance(model, ht.HDemucs)
        outs[device] = sep._apply_split(model, mix)
    assert outs["cuda"].shape == (4, 2, 30000) and np.isfinite(outs["cuda"]).all()
    for i in range(4):
        assert _sdr(outs["cpu"][i], outs["cuda"][i]) >= FLOOR_DB


def test_ensemble_launches_every_kernel_of_its_members(cuda, tmp_path):
    model_dir = str(tmp_path / "models")
    os.makedirs(model_dir)
    chip_smoke.write_synthetic_model(model_dir, seed=0)
    chip_smoke.write_synthetic_demucs_bag(model_dir, seed=0)
    wav = str(tmp_path / "mix.wav")
    chip_smoke.write_seeded_wav(wav, 0, 30.0)
    sep = Separator(model_file_dir=model_dir, output_dir=str(tmp_path / "out"),
                    ensemble_algorithm="avg_fft", log_level=logging.WARNING)
    sep.load_model([DEFAULT_MODEL, "htdemucs.yaml"])
    _build.reset_launch_counts()
    files = sep.separate(wav)
    assert chip_smoke.launches_to_compare(dict(_build.LAUNCHES)) == chip_smoke.ENSEMBLE_LAUNCHES
    assert len(files) == 5 and all(os.path.exists(f) for f in files)
