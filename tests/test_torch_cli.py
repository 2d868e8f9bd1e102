"""The port's CLI (``audio_separator_tpu_torch.utils.cli.main``) with
``--device cpu``: help without arguments, model listings, a separation that
writes the same stems as ``Separator.separate``, ``--chunk_duration``, the
ensemble flags, the one unported flag, and the default device without a
card."""

import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from audio_separator_tpu_torch.io import audio as audio_io
from audio_separator_tpu_torch.separator import Separator
from audio_separator_tpu_torch.utils import cli

from test_torch_ensemble_separator import PRESET, PRESET_FILES
from test_torch_separate_batch import write_small_roformer, write_wav
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SECOND = "bs_roformer_vocals_b.ckpt"


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """The default model, a second small RoFormer and the two of the
    ``vocal_balanced`` preset, all local."""
    tmp = tmp_path_factory.mktemp("torch-cli-model")
    write_small_roformer(str(tmp))
    write_small_roformer(str(tmp), seed=5, ckpt=SECOND)
    for seed, (ckpt, yaml_name) in enumerate(PRESET_FILES.items()):
        write_small_roformer(str(tmp), seed=seed + 7, ckpt=ckpt, yaml_name=yaml_name)
    return str(tmp)


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch-cli-wav") / "song.wav")
    write_wav(path, 2.5, seed=11)
    return path


def _main(argv):
    with pytest.raises(SystemExit) as exc:
        cli.main(argv)
    return exc.value.code


def test_no_arguments_prints_help_and_exits_1(capsys):
    assert _main([]) == 1
    assert "usage:" in capsys.readouterr().out


@pytest.mark.parametrize("fmt", ["pretty", "json"])
def test_list_models(model_dir, capsys, fmt):
    assert _main(["--list_models", "--list_format", fmt, "--model_file_dir", model_dir]) == 0
    out = capsys.readouterr().out
    if fmt == "json":
        listing = json.loads(out)
        assert set(listing) == {"VR", "MDX", "Demucs", "MDXC"}
        files = {info["filename"] for info in listing["MDXC"].values()}
        assert {"model_bs_roformer_ep_317_sdr_12.9755.ckpt",
                "MDX23C-8KFFT-InstVoc_HQ_2.ckpt"} <= files
    else:
        assert "Model Filename" in out and "MDX23C-8KFFT-InstVoc_HQ_2.ckpt" in out


def test_list_models_filter_and_limit(model_dir, capsys):
    assert _main(["--list_models", "--list_filter", "vocals", "--list_limit", "3",
                  "--model_file_dir", model_dir]) == 0
    rows = [line for line in capsys.readouterr().out.splitlines()
            if line and not line.startswith("-") and not line.startswith("Model Filename")]
    assert len(rows) == 3


def _stems(out_dir, files):
    return {os.path.basename(f): audio_io.load_audio(os.path.join(out_dir, f))[0]
            for f in files}


def test_separation_writes_the_same_stems_as_separator(model_dir, wav, tmp_path):
    cli_dir, api_dir = str(tmp_path / "cli"), str(tmp_path / "api")
    cli.main([wav, "--device", "cpu", "--model_file_dir", model_dir,
              "--output_dir", cli_dir, "--log_level", "warning"])
    # The CLI writes FLAC by default (the JAX CLI's default).
    sep = Separator(model_file_dir=model_dir, output_dir=api_dir, device="cpu",
                    output_format="FLAC", log_level=logging.WARNING)
    sep.load_model()
    files = sep.separate(wav)
    assert sorted(os.listdir(cli_dir)) == sorted(files) and len(files) == 2
    got, want = _stems(cli_dir, files), _stems(api_dir, files)
    for name in files:
        np.testing.assert_array_equal(got[name], want[name])


def test_chunk_duration(model_dir, wav, tmp_path):
    out_dir = str(tmp_path / "out")
    cli.main([wav, "--device", "cpu", "--model_file_dir", model_dir, "--output_dir", out_dir,
              "--chunk_duration", "1", "--log_level", "warning"])
    mix, _ = audio_io.load_audio(wav)
    names = sorted(os.listdir(out_dir))
    assert names == ["song_(other).flac", "song_(vocals).flac"]
    for name in names:
        pcm, _ = audio_io.load_audio(os.path.join(out_dir, name))
        assert pcm.shape == mix.shape and np.isfinite(pcm).all()


_CUSTOM = "custom_ensemble_ep_317_sdr_1_vocals_b"  # the members' slugs


@pytest.mark.parametrize("flags,expect", [
    (["--extra_models", SECOND], _CUSTOM),
    (["--extra_models", SECOND, "--ensemble_algorithm", "max_wave",
      "--ensemble_weights", "1", "2"], _CUSTOM),
    (["--ensemble_preset", PRESET], f"preset_{PRESET}"),
    (["--list_presets"], 0),
    (["--use_mesh"], 2),
], ids=["flags0-14", "flags1-14", "flags2-14", "flags3-14", "flags4-16"])  # ROADMAP items
def test_unported_flags_exit_naming_roadmap(model_dir, wav, tmp_path, capsys, flags, expect):
    """The ensemble flags run on the CPU: ``--extra_models`` (with an
    algorithm and weights) and ``--ensemble_preset`` write one file for each
    stem group, named after the members or the preset; ``--list_presets``
    lists the presets and exits 0. ``--use_mesh`` is not ported: it exits 2
    naming its ROADMAP item."""
    out_dir = str(tmp_path / "out")
    argv = [wav, "--device", "cpu", "--model_file_dir", model_dir, "--output_dir", out_dir,
            "--log_level", "warning"] + flags
    if isinstance(expect, int):
        assert _main(argv) == expect
        captured = capsys.readouterr()
        if expect == 2:
            assert "ROADMAP, Queue A item 16" in captured.err
        else:
            assert "Preset ID" in captured.out and PRESET in captured.out
        return
    cli.main(argv)
    mix, _ = audio_io.load_audio(wav)
    names = sorted(os.listdir(out_dir))
    assert names == [f"song_({stem})_{expect}.flac" for stem in ("Instrumental", "Vocals")]
    for name in names:
        pcm, _ = audio_io.load_audio(os.path.join(out_dir, name))
        assert pcm.shape == mix.shape and np.isfinite(pcm).all()


def test_env_info_on_the_cpu(capsys):
    assert _main(["--env_info", "--device", "cpu", "--log_level", "warning"]) == 0
    out = capsys.readouterr().out
    assert f"torch {torch.__version__}" in out and "CUDA available" in out


def test_default_device_without_a_card_raises(model_dir, wav, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([wav, "--model_file_dir", model_dir, "--output_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--env_info"])


def test_python_dash_m_runs_the_cli():
    proc = subprocess.run([sys.executable, "-m", "audio_separator_tpu_torch.utils.cli",
                           "--version"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "0.1.0" in proc.stdout
