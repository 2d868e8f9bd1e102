"""The VR family on a CUDA card against the CPU: the v5.1 net's forward
(cuDNN convolutions and LSTM under ``full_float32``) and one
``VRSeparator.separate`` through the whole device chain. Each test decides
inside its fixture whether a card is present and skips without one. Run on
the card with

    python -m pytest tests/test_torch_cuda_vr.py --noconftest -q

Floor: 100 dB SDR of the card's float32 output against the CPU's (the MDX
bar, PERF.md §2); bf16 is held to 30 dB against the card's float32."""

import json
import logging
import math
import os

import numpy as np
import pytest
import torch

from audio_separator_tpu_torch.io import audio as audio_io
from audio_separator_tpu_torch.models.vr_nets import load_vr_net
from audio_separator_tpu_torch.separator import Separator
from torch_oracles.vr_oracle import CascadedASPPNetOracle, CascadedNetOracle

pytestmark = pytest.mark.gpu

FLOOR_DB = 100.0
SP_CAPS = [(2, 16), (2, 16), (18, 8, 1, 1, 0), (8, 16), (34, 16, 1, 1, 0), (16, 32),
           (32, 2, 1), (16, 2, 1), (16, 2, 1)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True  # the module's own scope must hold
    return torch.device("cuda")


def _sdr(ref, est):
    ref, est = np.asarray(ref, np.float64), np.asarray(est, np.float64)
    return 10 * math.log10(np.sum(ref ** 2) / max(np.sum((ref - est) ** 2), 1e-300))


def _seeded(net, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.weight.copy_(1 + 0.1 * torch.randn(m.weight.shape, generator=g))
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape, generator=g))
                m.running_var.copy_(0.5 + torch.rand(m.running_var.shape, generator=g))
    return {k: v.numpy() for k, v in net.state_dict().items()}


def test_v51_forward_on_card_matches_cpu(cuda):
    """nout 32, nout_lstm 128 (the smaller published width) over the
    896-bin geometry, two windows of 512 frames; float32 and bf16."""
    torch.manual_seed(0)
    sd = _seeded(CascadedNetOracle(1792, 32, 128), 0)
    x = torch.from_numpy(np.abs(np.random.default_rng(0).standard_normal(
        (2, 2, 897, 512))).astype(np.float32)) / 4
    with torch.no_grad():
        want = load_vr_net(sd, 1792, 56817, True, 64)(x[:1])
        net = load_vr_net(sd, 1792, 56817, True, 64, device=cuda)
        got = net(x.to(cuda)).cpu()
        half = net.to_compute_dtype(torch.bfloat16)(x.to(cuda, torch.bfloat16)).float().cpu()
    assert got.shape == (2, 2, 897, 384) and torch.isfinite(half).all()
    assert _sdr(want[0], got[0]) >= FLOOR_DB
    assert _sdr(got, half) >= 30.0


def test_vr_separate_on_card_matches_cpu(cuda, tmp_path):
    """The v5 sp net (arch 33966 by its file size) over ``4band_44100`` with
    TTA and high end: both stems of a 3 s track, card against CPU."""
    torch.manual_seed(1)
    net = CascadedASPPNetOracle(1536, SP_CAPS, 33966)
    _seeded(net, 1)
    torch.save(net.state_dict(), tmp_path / "vr5.pth")
    (tmp_path / "vr5.json").write_text(json.dumps({"vr_model_param": "4band_44100",
                                                   "primary_stem": "Instrumental"}))
    (tmp_path / "download_checks.json").write_text("{}")
    n = 3 * 44100
    t = np.arange(n) / 44100
    mix = (0.3 * np.stack([np.sin(2 * np.pi * 220 * t), np.sin(2 * np.pi * 330 * t)])
           + 0.05 * np.random.default_rng(2).standard_normal((2, n))).astype(np.float32)
    wav = str(tmp_path / "song.wav")
    audio_io.save_audio(wav, mix, 44100)
    out = {}
    for device in ("cuda", "cpu"):
        sep = Separator(model_file_dir=str(tmp_path), output_dir=str(tmp_path / device),
                        device=device, log_level=logging.WARNING,
                        vr_params={"batch_size": 4, "window_size": 512, "aggression": 5,
                                   "enable_tta": True, "enable_post_process": False,
                                   "post_process_threshold": 0.2, "high_end_process": True})
        sep.load_model("vr5.pth")
        inst = sep.model_instance
        inst.separate(wav)
        assert inst._arch_size == 33966
        out[device] = (inst.primary_source, inst.secondary_source)
    for cpu, card in zip(out["cpu"], out["cuda"]):
        assert card.shape == cpu.shape and np.isfinite(card).all()
        assert _sdr(cpu, card) >= FLOOR_DB
    assert os.listdir(tmp_path / "cuda")
