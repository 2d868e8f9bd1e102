"""The demix engine and the ``Separator`` over a device mesh of repeated CPU
handles, against the single-device path and the JAX engine on its CPU mesh
(tests/test_demix.py:56-104 and 647-674), at ``atol=1e-5``.

* ``overlap_add_demix`` over a dp 4 mesh equals one device and the JAX
  meshed engine; over a dp 2 × tp 2 mesh with a tensor-parallel RoFormer it
  equals the unsharded module on one device; ``post_device_fn`` with a mesh
  equals the plain engine and the JAX meshed one; the VR mask engine
  (``tiled_mask_predict``) splits its tile batches too.
* ``Separator(use_mesh=<4 CPU handles>)`` writes the stems of the plain
  ``separate`` for MDXC (RoFormer), Demucs, MDX and VR, on synthetic
  checkpoints; ``use_mesh=True`` on the CPU takes the plain path.
"""

import json
import logging
import os

import numpy as np
import pytest
import torch

from audio_separator_tpu.ops import demix as jax_demix
from audio_separator_tpu.ops.stft import hamming_window as jax_hamming
from audio_separator_tpu.parallel import mesh as jax_mesh
from audio_separator_tpu_torch.io import audio as audio_io
from audio_separator_tpu_torch.models.convert import flatten_tree, load_jax_params
from audio_separator_tpu_torch.models.init_params import (init_htdemucs_params,
                                                          init_roformer_params)
from audio_separator_tpu_torch.models.roformer import Roformer, RoformerConfig
from audio_separator_tpu_torch.ops import demix
from audio_separator_tpu_torch.ops.stft import hamming_window
from audio_separator_tpu_torch.parallel import mesh
from audio_separator_tpu_torch.separator import DEFAULT_MODEL, Separator
from torch_oracles.roformer_oracle import RoformerOracle
from torch_threads import one_torch_thread  # noqa: F401

import jax.numpy as jnp

CPU = torch.device("cpu")
SR = 44100
ATOL = 1e-5


def _cpu_mesh(dp, tp=1):
    return mesh.make_mesh(devices=[CPU] * (dp * tp), dp=dp, tp=tp)


def _port_model(chunks):  # (B, C, chunk) -> (B, 2, C, chunk), on the chunks' device
    return torch.stack([chunks * 0.5, torch.tanh(3.0 * chunks)], dim=1)


def _jax_model(chunks):
    return jnp.stack([chunks * 0.5, jnp.tanh(3.0 * chunks)], axis=1)


def test_demix_over_a_dp4_mesh_matches_one_device_and_jax():
    rng = np.random.default_rng(7)
    mix = rng.standard_normal((2, 40000)).astype(np.float32)
    chunk, step = 4096, 3000
    seen = []

    def model(chunks):
        seen.append(chunks.shape[0])
        return _port_model(chunks)

    base = demix.overlap_add_demix(_port_model, mix, chunk, step,
                                   hamming_window(chunk).numpy(), num_stems=2, batch_size=2,
                                   device="cpu")
    got = demix.overlap_add_demix(model, mix, chunk, step, hamming_window(chunk).numpy(),
                                  num_stems=2, batch_size=2, device="cpu", mesh=_cpu_mesh(4))
    assert set(seen) == {1}  # the batch rounded up to 4, one window a row
    np.testing.assert_allclose(got, base, atol=ATOL)
    want = jax_demix.overlap_add_demix(
        _jax_model, mix, chunk, step, np.asarray(jax_hamming(chunk)), num_stems=2,
        batch_size=2, mesh=jax_mesh.make_mesh(n_devices=4, dp=4, tp=1),
        quantized_transfer=False, quantized_upload=False)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_demix_over_a_2x2_mesh_with_a_tensor_parallel_roformer():
    cfg = RoformerConfig(kind="bs", dim=32, depth=1, stereo=True, num_stems=2,
                         time_transformer_depth=1, freq_transformer_depth=1,
                         freqs_per_bands=(2, 2, 4, 8, 16, 32, 64, 129), dim_head=8, heads=4,
                         stft_n_fft=512, stft_hop_length=128, stft_win_length=512,
                         mask_estimator_depth=2)
    model = load_jax_params(Roformer(cfg), init_roformer_params(cfg, seed=1))
    m = _cpu_mesh(2, 2)
    sharded = mesh.shard_roformer_params(model, m)
    mix = np.random.default_rng(8).standard_normal((2, 12000)).astype(np.float32) * 0.3
    chunk = cfg.stft_hop_length * 15

    def run(fn, **kw):
        return demix.overlap_add_demix(lambda x: fn(x)[..., :chunk], mix, chunk, chunk // 2,
                                       np.ones(chunk, np.float32), num_stems=2, batch_size=2,
                                       device="cpu", **kw)

    np.testing.assert_allclose(run(sharded, mesh=m), run(model), atol=ATOL)


def test_post_device_fn_with_a_mesh_matches_the_plain_engine_and_jax():
    rng = np.random.default_rng(31)
    mix = rng.standard_normal((2, 30000)).astype(np.float32)
    chunk, step = 2048, 1500
    positions = demix.window_positions(30000, chunk, step)
    windows = np.tile(hamming_window(chunk).numpy()[None], (len(positions), 1))
    divider = np.ones(30000 + chunk, np.float32)
    for r, p in enumerate(positions):
        divider[p : p + chunk] += windows[r]
    kw = dict(num_stems=2, batch_size=2, positions=positions, divider=divider)
    plain = demix.overlap_add_demix(_port_model, mix, chunk, step, windows, device="cpu",
                                    post_device_fn=lambda acc: acc[..., :30000], **kw)
    meshed = demix.overlap_add_demix(_port_model, mix, chunk, step, windows, device="cpu",
                                     post_device_fn=lambda acc: acc[..., :30000],
                                     mesh=_cpu_mesh(4), **kw)
    np.testing.assert_allclose(meshed, plain, atol=ATOL)
    want = jax_demix.overlap_add_demix(
        _jax_model, mix, chunk, step, windows, post_device_fn=lambda acc: acc[..., :30000],
        mesh=jax_mesh.make_mesh(n_devices=4, dp=4, tp=1), pipeline_segments=4,
        quantized_transfer=False, quantized_upload=False, **kw)
    np.testing.assert_allclose(meshed, want, atol=ATOL)


@pytest.mark.parametrize("n_tiles,batch", [(7, 2), (3, 8)])
def test_tiled_mask_predict_splits_tile_batches_over_the_mesh(n_tiles, batch):
    spec = torch.from_numpy(np.random.default_rng(2).random((2, 33, 600)).astype(np.float32))
    sizes = []

    def model(x):  # (B, C, F, window) -> (B, C, F, roi)
        sizes.append(x.shape[0])
        return torch.sigmoid(x[..., 16:-16] * 2.0)

    plain = demix.tiled_mask_predict(model, spec, 96, 16, batch, n_tiles)
    sizes.clear()
    meshed = demix.tiled_mask_predict(model, spec, 96, 16, batch, n_tiles, mesh=_cpu_mesh(4))
    assert max(sizes) <= -(-batch // 4)
    torch.testing.assert_close(meshed, plain, atol=0, rtol=0)


# ------------------------------------------------------------------ Separator


def _roformer_dir(directory):
    """A BS-RoFormer checkpoint under the default model's names (the layout
    of tests/test_torch_separator.py)."""
    freqs = (16, 16, 32, 65)
    torch.manual_seed(3)
    bins, start = [], 0
    for nf in freqs:
        bins.append(list(range(start, start + nf)))
        start += nf
    oracle = RoformerOracle(kind="bs", band_bins=bins, dim=32, depth=1, heads=2, dim_head=16,
                            stereo=True, num_stems=1, t_depth=1, f_depth=1, n_fft=256, hop=64,
                            mask_depth=2)
    with torch.no_grad():
        for p in oracle.parameters():
            p.copy_(torch.randn_like(p) * 0.2)
    torch.save({"state_dict": oracle.state_dict()}, os.path.join(directory, DEFAULT_MODEL))
    config = {"audio": {"sample_rate": SR, "hop_length": 64},
              "model": {"dim": 32, "depth": 1, "stereo": True, "num_stems": 1,
                        "time_transformer_depth": 1, "freq_transformer_depth": 1,
                        "freqs_per_bands": list(freqs), "dim_head": 16, "heads": 2,
                        "stft_n_fft": 256, "stft_hop_length": 64, "stft_win_length": 256,
                        "mask_estimator_depth": 2},
              "training": {"instruments": ["vocals", "other"], "target_instrument": "vocals"},
              "inference": {"dim_t": 64}}
    with open(os.path.join(directory, DEFAULT_MODEL.replace(".ckpt", ".yaml")), "w") as f:
        json.dump(config, f)
    return DEFAULT_MODEL, {"mdxc_params": {"segment_size": 64, "override_model_segment_size":
                                           False, "batch_size": 3, "overlap": 0.5,
                                           "pitch_shift": 0}}


def _demucs_dir(directory):
    from audio_separator_tpu_torch.models import htdemucs as ht
    from test_torch_demucs_separator import KWARGS, SIGNATURE, SMALL, _save_package

    tree = init_htdemucs_params(ht.HTDemucsConfig(**SMALL), seed=21)
    state = {k: torch.from_numpy(v) for k, v in flatten_tree(tree).items()}
    _save_package(directory, SIGNATURE, "HTDemucs", KWARGS, state)
    with open(os.path.join(directory, "htdemucs.yaml"), "w") as f:
        json.dump({"models": [SIGNATURE]}, f)
    return "htdemucs.yaml", {"demucs_params": {"segment_size": "Default", "shifts": 1,
                                               "overlap": 0.25, "segments_enabled": True,
                                               "batch_size": 3}}


def _mdx_dir(directory):
    from test_torch_mdx_separator import MDX_PARAMS, MODEL, write_mdx_model

    write_mdx_model(directory)
    return MODEL, {"mdx_params": dict(MDX_PARAMS, batch_size=3)}


def _vr_dir(directory):
    from test_torch_vr_separator import PLAIN, TINY_CAPS, V5, V5_DATA
    from test_vr import _randomize
    from torch_oracles.vr_oracle import CascadedASPPNetOracle

    net = _randomize(CascadedASPPNetOracle(768 * 2, TINY_CAPS, 31191), seed=3).eval()
    torch.save(net.state_dict(), os.path.join(directory, V5))
    with open(os.path.join(directory, V5.replace(".pth", ".json")), "w") as f:
        json.dump(V5_DATA, f)
    return V5, {"vr_params": dict(PLAIN, batch_size=3)}


FAMILIES = {"mdxc_roformer": _roformer_dir, "demucs": _demucs_dir, "mdx": _mdx_dir,
            "vr": _vr_dir}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_separator_over_a_mesh_writes_the_plain_stems(family, tmp_path):
    model_dir = str(tmp_path / "models")
    os.makedirs(model_dir)
    model, params = FAMILIES[family](model_dir)
    with open(os.path.join(model_dir, "download_checks.json"), "w") as f:
        f.write("{}")
    rng = np.random.default_rng(5)
    t = np.arange(int(1.5 * SR)) / SR
    mix = (0.3 * np.stack([np.sin(2 * np.pi * 220 * t), np.sin(2 * np.pi * 330 * t)])
           + 0.05 * rng.standard_normal((2, t.size))).astype(np.float32)
    wav = str(tmp_path / "song.wav")
    audio_io.save_audio(wav, mix, SR, bit_depth=32)  # float stems: no 16-bit rounding
    stems = {}
    for name, use_mesh in (("plain", False), ("mesh", _cpu_mesh(4))):
        out_dir = str(tmp_path / name)
        sep = Separator(model_file_dir=model_dir, output_dir=out_dir, device="cpu",
                        output_format="WAV", log_level=logging.WARNING, use_mesh=use_mesh,
                        **params)
        sep.load_model(model)
        assert sep.model_instance.mesh is (use_mesh or None)
        files = sorted(sep.separate(wav))
        stems[name] = {f: audio_io.load_audio(os.path.join(out_dir, f))[0] for f in files}
    assert sorted(stems["mesh"]) == sorted(stems["plain"]) and stems["plain"]
    for f, want in stems["plain"].items():
        np.testing.assert_allclose(stems["mesh"][f], want, atol=ATOL)


def test_use_mesh_true_on_the_cpu_takes_the_plain_path(tmp_path, caplog):
    model, _ = _roformer_dir(str(tmp_path))
    (tmp_path / "download_checks.json").write_text("{}")
    sep = Separator(model_file_dir=str(tmp_path), device="cpu", use_mesh=True,
                    log_level=logging.DEBUG)
    with caplog.at_level(logging.DEBUG):
        assert sep._resolve_mesh() is None
    assert "only one device present" in caplog.text
    sep.load_model(model)
    assert sep.model_instance.mesh is None
    with pytest.raises(ValueError, match="first device"):
        Separator(model_file_dir=str(tmp_path), device="cpu",
                  use_mesh=mesh.Mesh(np.array([[torch.device("meta")]])))._resolve_mesh()


def test_a_row_on_another_device_builds_its_replica_once():
    """``BaseSeparator.model_on``: the separator's own device gets the local
    model; another row's device gets the model built there, once, from the
    process-wide cache (a ``meta`` handle stands for a second card)."""
    from audio_separator_tpu_torch.ops import fn_cache
    from audio_separator_tpu_torch.separator.common import BaseSeparator

    sep = BaseSeparator({"device": CPU, "mesh": _cpu_mesh(2)})
    local, built = object(), []

    def build(device):
        built.append(device)
        return ("replica", str(device))

    def key_for(device):
        return ("test-model-on", device)

    try:
        assert sep.model_on(CPU, local, key_for, build) is local
        assert sep.model_on(torch.device("meta"), local, key_for, build) == ("replica", "meta")
        assert sep.model_on(torch.device("meta"), local, key_for, build) == ("replica", "meta")
        assert built == [torch.device("meta")]
    finally:
        fn_cache.clear()
