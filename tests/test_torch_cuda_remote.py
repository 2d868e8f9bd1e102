"""The port's remote server on a CUDA card with two workers and both TF32
switches on: two full-width HTDemucs jobs at once, then a full-width float32
VR v5.1 job and a float32 MDX23C job at once. Each served stem must score
>= 100 dB against its solo direct ``Separator`` call on the card (the MDX
bar, PERF.md §2), and cuDNN's and the matmul's process-wide switches must
read after the jobs what they read before. Each job's float32 forward runs
under ``ops/precision.full_float32``, which must hold while either job is
inside it, and VR's float32 convolutions must touch no switch. The tests
decide inside their fixture whether a card is present and skip without one.
Run on the card with

    python -m pytest tests/test_torch_cuda_remote.py --noconftest -q"""

import logging
import os
import sys
import threading

import pytest
import torch

from audio_separator_tpu_torch.io import audio as audio_io
from audio_separator_tpu_torch.remote import server as server_mod
from audio_separator_tpu_torch.separator import Separator
from audio_separator_tpu_torch.utils.metrics import simple_sdr

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (its model writers and HTTP helpers)

pytestmark = pytest.mark.gpu

FLOOR_DB = 100.0
TRACKS = {"a": 20.0, "b": 15.0}


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.allow_tf32 = matmul.allow_tf32 = True  # each job's own scope must hold
    monkeypatch.setenv("AUDSEP_SERVER_COALESCE", "1")
    yield torch.device("cuda")
    cudnn.allow_tf32, matmul.allow_tf32 = saved


def _serve_two_at_once(tmp_path, model_dir, jobs):
    """``jobs``: {key: (model file name, WAV path)}. Each job's direct call
    on the card, then all jobs submitted together to a two-worker server;
    the served stems are held to the direct ones, and the switches to what
    they read before the jobs."""
    direct = {}
    for key, (model, wav) in jobs.items():
        sep = Separator(model_file_dir=model_dir, output_dir=str(tmp_path / "direct" / key),
                        output_format="wav", log_level=logging.WARNING)
        sep.load_model(model)
        direct[key] = {chip_smoke.stem_label(f): audio_io.load_audio(
            os.path.join(sep.output_dir, f))[0] for f in sep.separate(wav)}
        del sep

    before = chip_smoke.backend_switches()
    srv = server_mod.serve(host="127.0.0.1", port=0, model_file_dir=model_dir,
                           work_dir=str(tmp_path / "work"), workers=2, device="cuda")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        tasks = {key: chip_smoke.submit_job(url, wav, {"model": model,
                                                      "output_format": "wav"})[0]
                 for key, (model, wav) in jobs.items()}
        done = chip_smoke.wait_jobs(lambda t: chip_smoke.http_json(f"{url}/status/{t}")[1],
                                    list(tasks.values()))
        assert chip_smoke.backend_switches() == before
        for key, task in tasks.items():
            served = chip_smoke.read_stems(chip_smoke.http_fetcher(url), done[task][0],
                                           str(tmp_path / "dl" / key))
            assert sorted(served) == sorted(direct[key]) and served
            for name, got in served.items():
                assert got.shape == direct[key][name].shape
                assert simple_sdr(got, direct[key][name]) >= FLOOR_DB, (key, name)
        return direct
    finally:
        srv.shutdown()
        srv.server_close()


def _wavs(tmp_path):
    wavs = {k: str(tmp_path / f"{k}.wav") for k in TRACKS}
    for i, (key, seconds) in enumerate(TRACKS.items()):
        chip_smoke.write_seeded_wav(wavs[key], 50 + i, seconds, bit_depth=32)
    return wavs


def test_two_workers_serve_two_htdemucs_jobs_at_full_float32(cuda, tmp_path):
    model_dir = str(tmp_path / "models")
    os.makedirs(model_dir)
    chip_smoke.write_synthetic_demucs_bag(model_dir, seed=5)
    wavs = _wavs(tmp_path)
    direct = _serve_two_at_once(tmp_path, model_dir,
                                {key: ("htdemucs.yaml", wav) for key, wav in wavs.items()})
    assert all(len(stems) == 4 for stems in direct.values())


def test_two_workers_serve_float32_vr_and_mdx23c_together(cuda, tmp_path):
    model_dir = str(tmp_path / "models")
    os.makedirs(model_dir)
    chip_smoke.write_vr51_model(model_dir, seed=5)
    chip_smoke.write_synthetic_mdx23c(model_dir, seed=5)
    wavs = _wavs(tmp_path)
    direct = _serve_two_at_once(tmp_path, model_dir,
                                {"vr": (chip_smoke.VR51_MODEL, wavs["a"]),
                                 "mdx23c": (chip_smoke.MDX23C_MODEL, wavs["b"])})
    assert all(len(stems) == 2 for stems in direct.values())
