"""VR through the port's ``Separator(device="cpu")``: synthetic ``.pth``
checkpoints with sidecar JSONs, resolved by ``load_model`` and keyed by
their size in KB as real files are.

The v5 net (arch 31191 at narrow caps, over ``4band_44100``) is held
against the JAX package's ``VRSeparator.separate`` with the same file, with
TTA, post-process and high-end mirroring on: written stems ≥ 40 dB SDR
(``tests/test_parity_pipeline.py``'s bar) and equal lengths (each chain
stage is held to the JAX package's with the options one at a time in
``tests/test_torch_vr_ops.py``). The track is 2 s long, a whole number of
the JAX chain's length buckets, so that the JAX chain's post-process sees the
track's frames only (ROADMAP Queue C8). v5.1 (``4band_v4_ms_fullband``, nout 8, nout_lstm 16)
is held against the port's own chain driven by the torch oracle net.
Also: ``separate_batch`` against solo calls at each file's bit depth,
``output_single_stem``, bf16, and the CLI's ``--vr_*`` flags."""

import json
import logging
import os

import numpy as np
import pytest
import torch

from audio_separator_tpu_torch.architectures.vr import VRSeparator
from audio_separator_tpu_torch.io import audio as audio_io
from audio_separator_tpu_torch.ops import vr_chain
from audio_separator_tpu_torch.ops.demix import tiled_mask_predict
from audio_separator_tpu_torch.separator import Separator
from audio_separator_tpu_torch.utils import cli
from torch_oracles.vr_oracle import CascadedASPPNetOracle, CascadedNetOracle

from test_vr import _randomize
from test_torch_vr_nets import one_torch_thread  # noqa: F401  (autouse)

SR = 44100
MIN_PARITY_SDR = 40.0
V5, V51 = "vr_v5_test.pth", "vr_v51_test.pth"
# The sp-class capacity row of tests/test_vr.py at a quarter of its widths:
# (nin, ch) of each BaseASPPNet, the bridges' (nin, nout, k, stride, pad) and
# the output convolutions' (nin, nout, k).
TINY_CAPS = [(2, 4), (2, 4), (6, 4, 1, 1, 0), (4, 4), (10, 4, 1, 1, 0), (4, 8), (8, 2, 1),
             (4, 2, 1), (4, 2, 1)]
V5_DATA = {"vr_model_param": "4band_44100", "primary_stem": "Instrumental"}
V51_DATA = {"vr_model_param": "4band_v4_ms_fullband", "nout": 8, "nout_lstm": 16,
            "primary_stem": "Vocals"}
PLAIN = {"batch_size": 2, "window_size": 512, "aggression": 5, "enable_tta": False,
         "enable_post_process": False, "post_process_threshold": 0.2,
         "high_end_process": False}
ALL_OPTIONS = dict(PLAIN, aggression=10, enable_tta=True, enable_post_process=True,
                   high_end_process=True)


def _sdr(ref, est):
    return 10 * np.log10(np.sum(ref ** 2) / max(np.sum((ref - est) ** 2), 1e-30))


def write_wav(path, seconds, seed, bit_depth=16):
    n = int(seconds * SR)
    t = np.arange(n) / SR
    rng = np.random.default_rng(seed)
    mix = (0.3 * np.stack([np.sin(2 * np.pi * 220 * t), np.sin(2 * np.pi * 330 * t)])
           + 0.05 * rng.standard_normal((2, n))).astype(np.float32)
    audio_io.save_audio(path, mix, SR, bit_depth=bit_depth)
    return mix


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A model directory with both checkpoints, their sidecars and an empty
    remote listing (no download), and a 2 s WAV."""
    tmp = tmp_path_factory.mktemp("torch-vr")
    model_dir = str(tmp / "models")
    os.makedirs(model_dir)
    v5 = _randomize(CascadedASPPNetOracle(768 * 2, TINY_CAPS, 31191), seed=3).eval()
    v51 = _randomize(CascadedNetOracle(896 * 2, nout=8, nout_lstm=16), seed=4).eval()
    for name, net, data in ((V5, v5, V5_DATA), (V51, v51, V51_DATA)):
        torch.save(net.state_dict(), os.path.join(model_dir, name))
        with open(os.path.join(model_dir, name.replace(".pth", ".json")), "w") as f:
            json.dump(data, f)
    with open(os.path.join(model_dir, "download_checks.json"), "w") as f:
        f.write("{}")
    wav = str(tmp / "song.wav")
    mix = write_wav(wav, 2.0, seed=5)
    return tmp, model_dir, {V5: v5, V51: v51}, wav, mix


def _port(model_dir, out_dir, model=V5, vr=PLAIN, **kw):
    sep = Separator(model_file_dir=model_dir, output_dir=out_dir, device="cpu",
                    log_level=logging.WARNING, vr_params=dict(vr), **kw)
    sep.load_model(model)
    return sep


def _stems(out_dir, files):
    return {f.split("_(")[1].split(")")[0]: audio_io.load_audio(os.path.join(out_dir, f))[0]
            for f in files}


def test_load_model_keys_the_architecture_by_file_size(setup):
    _, model_dir, _, _, _ = setup
    v5 = _port(model_dir, None).model_instance
    v51 = _port(model_dir, None, model=V51).model_instance
    assert isinstance(v5, VRSeparator) and isinstance(v51, VRSeparator)
    v5._load_network()
    v51._load_network()
    # small files key to the smallest size; the sidecar's nout makes v5.1
    assert (v5._arch_size, v5.is_vr_51_model, v5._offset) == (31191, False, 128)
    assert (v51.is_vr_51_model, v51._offset, v51.net.stg3_full_band_net.enc1.conv[0].out_channels) \
        == (True, 64, 8)
    assert (v5.primary_stem_name, v5.secondary_stem_name) == ("Instrumental", "Vocals")
    assert v5.aggressiveness == {"value": 0.05, "split_bin": 186, "aggr_correction": None}
    assert all(p.device.type == "cpu" for p in v5.net.parameters())


def test_v5_stems_match_jax_with_tta_post_process_and_high_end(setup):
    from audio_separator_tpu.architectures.vr import VRSeparator as JaxVRSeparator

    tmp, model_dir, _, wav, mix = setup
    vr = ALL_OPTIONS
    port_dir, jax_dir = str(tmp / "port"), str(tmp / "jax")
    files = _port(model_dir, port_dir, vr=vr).separate(wav)
    common = {"logger": logging.getLogger("test"), "model_name": "vr_v5_test",
              "model_path": os.path.join(model_dir, V5), "model_data": dict(V5_DATA),
              "output_dir": jax_dir, "output_format": "WAV",
              "normalization_threshold": 0.9, "amplification_threshold": 0.0,
              "sample_rate": SR}
    jax_files = JaxVRSeparator(common, dict(vr)).separate(wav)
    assert files == jax_files and len(files) == 2
    got, want = _stems(port_dir, files), _stems(jax_dir, jax_files)
    for name in got:
        # the synthesis gives whole hops of the top band: a little short of the mix
        assert got[name].shape == want[name].shape
        assert 0 < mix.shape[1] - got[name].shape[1] < 512
        assert _sdr(want[name], got[name]) >= MIN_PARITY_SDR, name


def test_v51_separate_matches_its_chain_with_the_oracle_net(setup):
    """The separator against the port's chain stages driven by hand with the
    torch oracle as the net, TTA on."""
    tmp, model_dir, nets, wav, _ = setup
    vr = dict(PLAIN, enable_tta=True, aggression=8)
    inst = _port(model_dir, str(tmp / "v51"), model=V51, vr=vr).model_instance
    inst.separate(wav)

    mp = inst.mp
    geom = vr_chain.band_geometry(mp, True)
    pcm, _ = audio_io.load_audio(wav, sample_rate=SR)
    spec_c, _ = vr_chain.analyze(geom, torch.from_numpy(pcm))
    n_frame = spec_c.shape[-1]
    roi = 512 - 128
    mag = spec_c.abs()
    oracle = nets[V51]

    def predict(x):
        with torch.no_grad():
            return oracle.predict_mask(x)

    pad = torch.nn.functional.pad
    mask = tiled_mask_predict(predict, pad(mag, (64, 0)) / mag.max(), 512, 64, 2,
                              n_frame // roi + 1)
    mask_tta = tiled_mask_predict(predict, pad(mag, (64 + roi // 2, 0)) / mag.max(), 512, 64,
                                  2, n_frame // roi + 2)
    mask = vr_chain.finalize(mask, n_frame, roi, inst.aggressiveness, True, mask_tta)
    waves = vr_chain.synthesize(geom, mask, spec_c).numpy()
    assert inst.primary_source.shape == (vr_chain.synth_out_len(geom, n_frame), 2)
    for got, want in ((inst.primary_source.T, waves[0]), (inst.secondary_source.T, waves[1])):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_separate_batch_equals_solo_at_each_files_depth(setup, tmp_path):
    """A 16-bit and a 24-bit WAV through one enqueued group: each output
    equals its solo ``separate`` and is written at its own input depth
    (ROADMAP C2); a group larger than ``_BATCH_GROUP`` goes in sub-groups; a
    wrong number of names is refused."""
    _, model_dir, _, _, _ = setup
    wavs = [str(tmp_path / "a16.wav"), str(tmp_path / "b24.wav")]
    for path, secs, seed, depth in zip(wavs, (1.3, 1.7), (1, 2), (16, 24)):
        write_wav(path, secs, seed, bit_depth=depth)
    solo_dir, batch_dir = str(tmp_path / "solo"), str(tmp_path / "batch")
    solo_sep = _port(model_dir, solo_dir)
    solo = [solo_sep.separate(w) for w in wavs]
    batch_sep = _port(model_dir, batch_dir)
    batch = batch_sep.separate_batch(wavs)
    assert batch == solo
    for files, depth in zip(batch, (16, 24)):
        for name in files:
            a, _ = audio_io.load_audio(os.path.join(solo_dir, name))
            b, _ = audio_io.load_audio(os.path.join(batch_dir, name))
            assert audio_io.probe(os.path.join(batch_dir, name)).bits_per_sample == depth
            np.testing.assert_allclose(b, a, atol=2.0 ** -(depth - 1), rtol=0)
    inst = batch_sep.model_instance
    with pytest.raises(ValueError, match="1 entries for 2 files"):
        inst.separate_batch(wavs, [None])
    groups = []
    inst._BATCH_GROUP = 1
    inst.separate = lambda path, names=None: groups.append(path) or []
    assert inst.separate_batch(wavs) == [[], []] and groups == wavs


def test_output_single_stem_and_bf16(setup, tmp_path):
    """``output_single_stem`` writes that stem only; ``use_autocast`` runs the
    net as a bf16 copy and gives finite stems close to float32."""
    _, model_dir, _, wav, mix = setup
    out32, out16 = str(tmp_path / "f32"), str(tmp_path / "bf16")
    f32 = _port(model_dir, out32, output_single_stem="vocals").separate(wav)
    assert len(f32) == 1 and "(Vocals)" in f32[0]
    sep16 = _port(model_dir, out16, output_single_stem="Vocals", use_autocast=True)
    bf16 = sep16.separate(wav)
    assert bf16 == f32
    assert next(sep16.model_instance.net.parameters()).dtype == torch.bfloat16
    a, _ = audio_io.load_audio(os.path.join(out32, f32[0]))
    b, _ = audio_io.load_audio(os.path.join(out16, bf16[0]))
    assert a.shape == b.shape and np.isfinite(b).all()
    assert _sdr(a, b) > 20


def test_cli_vr_flags_reach_the_separator(setup, tmp_path, monkeypatch):
    """``--vr_aggression`` and ``--vr_enable_tta`` (and the other ``--vr_*``
    flags) reach the VR instance, and the CLI writes both stems."""
    _, model_dir, _, _, _ = setup
    seen = {}
    load = Separator.load_model

    def spy(self, *args, **kwargs):
        load(self, *args, **kwargs)
        seen["inst"] = self.model_instance

    monkeypatch.setattr(Separator, "load_model", spy)
    short = str(tmp_path / "short.wav")
    write_wav(short, 1.0, seed=9)
    out_dir = str(tmp_path / "cli")
    cli.main([short, "-m", V5, "--model_file_dir", model_dir, "--output_dir", out_dir,
              "--output_format", "WAV", "--device", "cpu", "--vr_aggression", "12",
              "--vr_enable_tta", "--vr_batch_size", "3", "--vr_window_size", "384",
              "--vr_high_end_process", "--vr_post_process_threshold", "0.3"])
    inst = seen["inst"]
    assert (inst.aggression, inst.enable_tta, inst.batch_size, inst.window_size,
            inst.high_end_process, inst.enable_post_process, inst.post_process_threshold) \
        == (0.12, True, 3, 384, True, False, 0.3)
    names = sorted(os.listdir(out_dir))
    assert names == ["short_(Instrumental)_vr_v5_test.wav", "short_(Vocals)_vr_v5_test.wav"]
    for name in names:
        pcm, _ = audio_io.load_audio(os.path.join(out_dir, name))
        assert pcm.shape[0] == 2 and np.isfinite(pcm).all() and np.abs(pcm).max() > 0


def test_chunking_and_warmup_run_vr_unchanged(setup, tmp_path):
    """``chunk_duration`` and ``warmup`` go through ``separate``: a 2 s track
    in 1 s chunks gives two stems of about the track's length (each chunk's
    stems are a little short of it, by less than a hop of the top band)."""
    _, model_dir, _, wav, mix = setup
    out_dir = str(tmp_path / "chunks")
    sep = _port(model_dir, out_dir, chunk_duration=1.0)
    assert sep.warmup(0.5) > 0 and not os.path.exists(out_dir)
    files = sep.separate(wav)
    assert len(files) == 2
    for path in files:
        pcm, sr = audio_io.load_audio(path)
        assert sr == SR and abs(pcm.shape[1] - mix.shape[1]) < 2 * 512
        assert pcm.shape[0] == 2 and np.isfinite(pcm).all()


def test_post_process_follows_the_exact_shape_chain(tmp_path, monkeypatch):
    """ROADMAP Queue C8. The post-process's region search runs over the
    track's frames, as the reference's and the JAX package's host chain do;
    the JAX device chain runs it over its length bucket, so a region that
    reaches the track's end runs on into the padding and the fade that
    closes it falls past the track. A stand-in net whose mask is 0.5
    everywhere (one region over everything, above the 0.2 threshold) and a
    1.3 s track (bucket 2 s): the port equals the JAX host chain and departs
    from the JAX device chain over the track's last frames."""
    import jax.numpy as jnp

    from audio_separator_tpu.architectures.vr import VRSeparator as JaxVRSeparator

    wav = str(tmp_path / "song.wav")
    write_wav(wav, 1.3, seed=6)
    vr = dict(PLAIN, enable_post_process=True)
    data = {"vr_model_param": "1band_sr44100_hl512", "primary_stem": "Instrumental"}

    port = VRSeparator({"model_name": "m", "model_path": wav, "model_data": data,
                        "output_dir": str(tmp_path / "port"), "device": torch.device("cpu"),
                        "logger": logging.getLogger("test")}, dict(vr))
    port.net, port._offset = True, 128  # the stand-in replaces the net
    port._predict = lambda x: torch.full_like(x[..., 128:-128], 0.5)
    port.separate(wav)

    out = {}
    for chain in ("host", "device"):
        monkeypatch.setenv("AUDSEP_VR_CHAIN", chain)
        sep = JaxVRSeparator({"model_name": "m", "model_path": wav, "model_data": data,
                              "output_dir": str(tmp_path / chain),
                              "logger": logging.getLogger("test")}, dict(vr))
        sep._params, sep._offset, sep._arch_size = {}, 128, 31191
        sep._jit_predict = lambda params, x: jnp.full_like(x[..., 128:-128], 0.5)
        sep.separate(wav)
        out[chain] = sep.primary_source
    got = port.primary_source
    assert got.shape == out["host"].shape == out["device"].shape
    assert _sdr(out["host"], got) >= MIN_PARITY_SDR
    assert _sdr(out["device"], got) < 20
    tail = 32 * 512  # the fade's 32 frames at the hop of 512
    assert _sdr(out["device"][:-tail], got[:-tail]) >= MIN_PARITY_SDR
