"""The port's user surface: ``Separator(device="cpu")`` against the JAX
package's ``Separator`` on one synthetic checkpoint and WAV (written stems at
>= 40 dB parity SDR, tests/test_parity_pipeline.py's bar); no silent CPU
fallback; and the port's independence from JAX and the JAX package."""

import ast
import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from audio_separator_tpu.io import audio as jax_audio_io
from audio_separator_tpu_torch.io import audio as audio_io
from audio_separator_tpu_torch.separator import DEFAULT_MODEL, Separator

from torch_oracles.roformer_oracle import RoformerOracle
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "audio_separator_tpu_torch")
SR = 44100
FREQS = (16, 16, 32, 65)  # n_fft 256
MIN_PARITY_SDR = 40.0


def _sdr(ref, est):
    return 10 * np.log10(np.sum(ref ** 2) / max(np.sum((ref - est) ** 2), 1e-30))


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A BS-RoFormer checkpoint in the upstream key layout and its YAML,
    under the default model's file names, so the registry resolves it
    locally (``download_checks.json`` present: no remote listing)."""
    tmp = tmp_path_factory.mktemp("torch-sep-model")
    torch.manual_seed(3)
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
    torch.save({"state_dict": oracle.state_dict()},
               os.path.join(tmp, DEFAULT_MODEL))
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
    with open(os.path.join(tmp, DEFAULT_MODEL.replace(".ckpt", ".yaml")), "w") as f:
        json.dump(config, f)  # JSON-flow YAML
    with open(os.path.join(tmp, "download_checks.json"), "w") as f:
        f.write("{}")
    return str(tmp)


@pytest.fixture(scope="module")
def separated(model_dir, tmp_path_factory):
    from audio_separator_tpu.separator import Separator as JaxSeparator

    tmp = tmp_path_factory.mktemp("torch-sep-run")
    rng = np.random.default_rng(9)
    t = np.arange(SR) / SR
    mix = (0.3 * np.stack([np.sin(2 * np.pi * 220 * t), np.sin(2 * np.pi * 330 * t)])
           + 0.05 * rng.standard_normal((2, SR))).astype(np.float32)
    wav = str(tmp / "song.wav")
    audio_io.save_audio(wav, mix, SR)

    outs = {}
    for name, cls, kw in (("torch", Separator, {"device": "cpu"}),
                          ("jax", JaxSeparator, {})):
        out_dir = str(tmp / name)
        sep = cls(model_file_dir=model_dir, output_dir=out_dir,
                  log_level=logging.WARNING, **kw)
        sep.load_model()
        files = sep.separate(wav)
        outs[name] = (sep, out_dir, files)
    return wav, mix, outs


def test_separator_stems_match_jax(separated):
    wav, mix, outs = separated
    _, torch_dir, torch_files = outs["torch"]
    _, jax_dir, jax_files = outs["jax"]
    assert sorted(torch_files) == sorted(jax_files)
    assert len(torch_files) == 2
    for name in torch_files:
        got, sr = audio_io.load_audio(os.path.join(torch_dir, name))
        want, _ = jax_audio_io.load_audio(os.path.join(jax_dir, name))
        assert sr == SR and got.shape == want.shape == mix.shape
        assert _sdr(want, got) >= MIN_PARITY_SDR, name


def test_mdxc_demix_matches_jax(separated):
    """The architecture's demix (model + overlap-add + residual secondary)
    before any file is written, against the JAX separator's."""
    _, mix, outs = separated
    got = outs["torch"][0].model_instance.demix(mix)
    want = outs["jax"][0].model_instance.demix(mix)
    assert set(got) == set(want) == {"vocals", "other"}
    for stem in got:
        assert got[stem].shape == want[stem].shape == mix.shape
        scale = np.abs(want[stem]).max()
        np.testing.assert_allclose(got[stem], want[stem], atol=3e-4 * scale)
    np.testing.assert_allclose(got["other"], mix - got["vocals"], atol=1e-6)


def test_separator_inference_builds_no_graph(separated):
    """The forwards of a separation run without gradients: no parameter
    requires one and no model output carries a graph."""
    wav, _, outs = separated
    sep = outs["torch"][0]
    model = sep.model_instance.model
    graphs = []
    handle = model.register_forward_hook(
        lambda _m, _i, out: graphs.append(out.requires_grad or out.grad_fn is not None))
    try:
        sep.separate(wav)
    finally:
        handle.remove()
    assert graphs and not any(graphs)
    assert not any(p.requires_grad for p in model.parameters())


def test_separator_without_cuda_raises(model_dir):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Separator(model_file_dir=model_dir)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Separator(model_file_dir=model_dir, device="cuda")


def test_separator_rejects_unported_model_types(model_dir, tmp_path):
    """Every model type the registry lists now separates: a Demucs v3 bag
    (ROADMAP item 12b, refused before it was ported) writes its two stems.
    The device mesh (item 16, refused before it was ported) is taken too:
    ``use_mesh=True`` on the CPU gives the plain path and the same stems."""
    from audio_separator_tpu_torch.models.convert import flatten_tree
    from audio_separator_tpu_torch.models.htdemucs import HTDemucsConfig
    from audio_separator_tpu_torch.models.init_params import (htdemucs_kwargs,
                                                              init_htdemucs_params)
    from test_torch_demucs_separator import _save_package

    cfg = HTDemucsConfig(sources=("drums", "bass"), arch="hdemucs", channels=8, nfft=64,
                         depth=2, dconv_comp=4, segment=0.05, use_train_segment=False)
    state = {k: torch.from_numpy(v)
             for k, v in flatten_tree(init_htdemucs_params(cfg, seed=1)).items()}
    _save_package(str(tmp_path), "v3model", "HDemucs", htdemucs_kwargs(cfg), state)
    (tmp_path / "v3bag.yaml").write_text(json.dumps({"models": ["v3model"]}))
    (tmp_path / "download_checks.json").write_text("{}")
    wav = str(tmp_path / "song.wav")
    audio_io.save_audio(wav, np.zeros((2, 4410), np.float32) + 0.1, 44100)
    sep = Separator(model_file_dir=str(tmp_path), output_dir=str(tmp_path / "out"),
                    device="cpu", log_level=logging.WARNING)
    sep.load_model("v3bag.yaml")  # the bag's models load at the first separation
    files = sep.separate(wav)
    assert len(files) == 2 and all(os.path.exists(tmp_path / "out" / f) for f in files)
    meshed = Separator(model_file_dir=str(tmp_path), output_dir=str(tmp_path / "mesh"),
                       device="cpu", use_mesh=True, log_level=logging.WARNING)
    meshed.load_model("v3bag.yaml")
    assert meshed.model_instance.mesh is None
    assert sorted(meshed.separate(wav)) == sorted(files)
    for f in files:
        np.testing.assert_array_equal(audio_io.load_audio(str(tmp_path / "mesh" / f))[0],
                                      audio_io.load_audio(str(tmp_path / "out" / f))[0])


def test_importing_the_port_leaves_jax_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import audio_separator_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'audio_separator_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imported_roots(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_of_the_port_imports_jax():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    # The Demucs v3, ensembling, remote-service and metrics modules are among them.
    files.append(os.path.join(REPO, "tools", "finetune_torch.py"))
    # The training and device-mesh slices' modules are among them too.
    for module in ("training.py", "ops/losses.py", "ops/block_backward.py",
                   "models/filtering.py", "separator/ensembler.py", "ops/align.py",
                   "ops/stretch.py", "models/htdemucs.py", "remote/server.py",
                   "remote/asgi.py", "remote/api_client.py", "remote/cli.py",
                   "remote/job_store.py", "remote/output_store.py", "utils/metrics.py",
                   "utils/audio_verification.py", "parallel/mesh.py",
                   "parallel/dcn_dryrun.py"):
        assert os.path.join(PORT, module) in files, module
    for path in files:
        roots = set(_imported_roots(path))
        assert not roots & {"jax", "jaxlib", "audio_separator_tpu"}, path


def test_vr_band_params_are_read_from_the_ports_own_copies():
    """The VR band JSONs load from the port's ``data/vr_modelparams``, which
    holds all 26 of the JAX package's."""
    from audio_separator_tpu_torch.architectures import vr

    own = os.path.realpath(os.path.join(PORT, "data", "vr_modelparams"))
    assert os.path.realpath(vr._PARAMS_DIR) == own
    names = sorted(os.listdir(own))
    assert len(names) == 26 and names == sorted(os.listdir(os.path.join(
        REPO, "audio_separator_tpu", "data", "vr_modelparams")))


def test_ensemble_presets_are_read_from_the_ports_own_copy(tmp_path):
    """The presets come from the port's ``data/ensemble_presets.json``, a copy
    of the JAX package's."""
    from audio_separator_tpu_torch.separator import registry

    own = os.path.join(PORT, "data", "ensemble_presets.json")
    assert os.path.realpath(registry._DATA_DIR) == os.path.realpath(os.path.join(PORT, "data"))
    with open(own, encoding="utf-8") as f, open(os.path.join(
            REPO, "audio_separator_tpu", "data", "ensemble_presets.json"), encoding="utf-8") as g:
        assert json.load(f) == json.load(g)
    with open(own, encoding="utf-8") as f:
        presets = json.load(f)["presets"]
    assert Separator(info_only=True, model_file_dir=str(tmp_path)).list_ensemble_presets() == presets


def test_yaml_config_reader_without_pyyaml(monkeypatch, tmp_path):
    """Without PyYAML the reader takes JSON-flow YAML and names the problem
    for anything else."""
    from audio_separator_tpu_torch.separator.separator import read_yaml_config

    monkeypatch.setitem(sys.modules, "yaml", None)  # import yaml -> ImportError
    good = tmp_path / "good.yaml"
    good.write_text('{"model": {"dim": 8}, "training": {"instruments": ["a", "b"]}}')
    assert read_yaml_config(str(good))["model"] == {"dim": 8}
    bad = tmp_path / "bad.yaml"
    bad.write_text("model:\n  dim: 8\n")
    with pytest.raises(RuntimeError, match="PyYAML is not installed"):
        read_yaml_config(str(bad))


def test_load_model_data_using_hash_matches_jax(tmp_path):
    """``Separator.load_model_data_using_hash`` returns the registry's model
    data for the file's hash, as the JAX ``Separator``'s does (offline: the
    model data files are in ``model_file_dir``)."""
    from audio_separator_tpu.separator import Separator as JaxSeparator
    from audio_separator_tpu_torch.separator.registry import get_model_hash

    model_dir = str(tmp_path)
    path = os.path.join(model_dir, "custom.onnx")
    with open(path, "wb") as f:
        f.write(np.random.default_rng(2).bytes(4096))
    data = {"compensate": 1.035, "mdx_dim_f_set": 2048, "mdx_dim_t_set": 8,
            "mdx_n_fft_scale_set": 6144, "primary_stem": "Vocals"}
    with open(os.path.join(model_dir, "mdx_model_data.json"), "w") as f:
        json.dump({get_model_hash(path): data}, f)
    for name in ("vr_model_data.json", "download_checks.json"):
        with open(os.path.join(model_dir, name), "w") as f:
            f.write("{}")
    got = Separator(model_file_dir=model_dir, device="cpu",
                    log_level=logging.WARNING).load_model_data_using_hash(path)
    want = JaxSeparator(model_file_dir=model_dir,
                        log_level=logging.WARNING).load_model_data_using_hash(path)
    assert got == want == data
