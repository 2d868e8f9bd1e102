"""The port's Demucs path against the JAX package's, on one synthetic
HTDemucs package and YAML bag: checkpoint loading (plain, diffq-quantised,
checksum rule, an HDemucs package as Demucs v3), the window plan, ``demix_demucs`` with and
without shifts and split (>= 40 dB SDR per source, tests/test_parity_pipeline.py's
bar), and ``Separator(device="cpu")`` end to end."""

import hashlib
import json
import logging
import os
import sys

import numpy as np
import pytest
import torch

from audio_separator_tpu.architectures.demucs import DemucsSeparator as JaxDemucsSeparator
from audio_separator_tpu.models import htdemucs as jax_ht
from audio_separator_tpu_torch.architectures.demucs import DemucsSeparator
from audio_separator_tpu_torch.io import audio as audio_io
from audio_separator_tpu_torch.models import demucs_load
from audio_separator_tpu_torch.models import htdemucs as ht
from audio_separator_tpu_torch.models.convert import flatten_tree
from audio_separator_tpu_torch.models.diffq_restore import demucs_param_manifest, quantize_diffq
from audio_separator_tpu_torch.models.init_params import init_htdemucs_params
from audio_separator_tpu_torch.separator import Separator
from torch_threads import one_torch_thread  # noqa: F401

SR = 44100
SOURCES = ("drums", "bass", "other", "vocals")
SMALL = dict(sources=SOURCES, channels=8, nfft=1024, depth=3, t_layers=3, t_heads=4,
             segment=0.5)
KWARGS = {**SMALL, "sources": list(SOURCES)}
SIGNATURE = "955717e8"  # the signature htdemucs.yaml names in the registry
BAG_WEIGHTS = [[1.0, 0.5, 1.0, 2.0]]
MIN_PARITY_SDR = 40.0
SHORT = 15000  # samples of the track the sequential-shift case runs on
DIRECT = SHORT + SR // 2  # what one shifted pass of that case sees


def _sdr(ref, est):
    return 10 * np.log10(np.sum(ref ** 2) / max(np.sum((ref - est) ** 2), 1e-30))


def _stub_class(name):
    added = demucs_load._ensure_stub_modules()
    klass = getattr(sys.modules["demucs.htdemucs" if name == "HTDemucs" else "demucs.hdemucs"],
                    name)
    return klass, added


def _save_package(directory, signature, klass_name, kwargs, state):
    """``<signature>-<sha256 prefix>.th`` with a stub class as ``klass``, as a
    genuine package pickles ``demucs.htdemucs.HTDemucs``."""
    klass, added = _stub_class(klass_name)
    tmp = os.path.join(directory, f"{signature}.tmp")
    try:
        torch.save({"klass": klass, "args": (), "kwargs": kwargs, "state": state}, tmp)
    finally:
        for name in added:
            sys.modules.pop(name, None)
    with open(tmp, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:8]
    path = os.path.join(directory, f"{signature}-{digest}.th")
    os.replace(tmp, path)
    return path


@pytest.fixture(scope="module")
def tree():
    return init_htdemucs_params(ht.HTDemucsConfig(**SMALL), seed=21)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory, tree):
    """A model directory the registry resolves ``htdemucs.yaml`` in without
    any download: the bag (JSON-flow YAML), its package and an empty remote
    listing."""
    directory = str(tmp_path_factory.mktemp("torch-demucs-models"))
    state = {k: torch.from_numpy(v) for k, v in flatten_tree(tree).items()}
    _save_package(directory, SIGNATURE, "HTDemucs", KWARGS, state)
    with open(os.path.join(directory, "htdemucs.yaml"), "w") as f:
        json.dump({"models": [SIGNATURE], "weights": BAG_WEIGHTS}, f)
    with open(os.path.join(directory, "download_checks.json"), "w") as f:
        f.write("{}")
    return directory


def _common(model_dir, out_dir=None, **extra):
    return {"logger": logging.getLogger("test"), "model_name": "htdemucs",
            "model_path": os.path.join(model_dir, "htdemucs.yaml"),
            "model_data": {"primary_stem": "Vocals"}, "output_dir": out_dir,
            "output_format": "WAV", "normalization_threshold": 0.9,
            "amplification_threshold": 0.0, "sample_rate": SR, **extra}


def _arch(shifts, split, batch_size=4):
    return {"segment_size": "Default", "shifts": shifts, "overlap": 0.25,
            "segments_enabled": split, "batch_size": batch_size}


@pytest.fixture(scope="module")
def mix():
    rng = np.random.default_rng(5)
    t = np.arange(3 * SR) / SR
    return (0.3 * np.stack([np.sin(2 * np.pi * 220 * t), np.sin(2 * np.pi * 331 * t)])
            + 0.1 * rng.standard_normal((2, 3 * SR))).astype(np.float32)


# ------------------------------------------------------------------ loading


def test_package_and_bag_round_trip(model_dir, tree):
    # An earlier test in this process may have left demucs modules behind:
    # the load must leave them as it found them.
    before = {m for m in sys.modules if m.split(".")[0] == "demucs"}
    models, weights, segment = demucs_load.load_demucs_model_or_bag(
        os.path.join(model_dir, "htdemucs.yaml"), model_dir)
    assert weights == BAG_WEIGHTS and segment is None and len(models) == 1
    cfg, state = models[0]
    assert cfg == ht.HTDemucsConfig(**SMALL)
    flat = flatten_tree(tree)
    assert set(state) == set(flat)
    for key, value in flat.items():
        assert state[key].dtype == torch.float32
        np.testing.assert_array_equal(state[key].numpy(), value)
    assert {m for m in sys.modules if m.split(".")[0] == "demucs"} == before  # stubs removed
    # The same package by its signature alone.
    single, w, _ = demucs_load.load_demucs_model_or_bag(SIGNATURE, model_dir)
    assert single[0][0] == cfg and w == [[1.0] * 4]


def test_quantized_package_loads(tmp_path, tree):
    """A diffq-quantised state (made with the copy's ``quantize_diffq``) is
    restored positionally from the constructor's parameter manifest."""
    flat = flatten_tree(tree)
    min_size = 0.002  # MB: parameters above 524 values are quantised
    min_params = int(min_size * 2 ** 20 // 4)
    manifest = demucs_param_manifest("HTDemucs", KWARGS)
    quantized, others = [], []
    for name, shape in manifest:
        if int(np.prod(shape)) > min_params:
            quantized.append(tuple(torch.from_numpy(a) for a in quantize_diffq(flat[name])))
        else:
            others.append(torch.from_numpy(flat[name]))
    assert quantized and others
    state = {"__quantized": True, "quantized": quantized, "others": others,
             "meta": {"init_kwargs": {"min_size": min_size}}}
    path = _save_package(str(tmp_path), "quantized", "HTDemucs", KWARGS, state)
    _, cfg, restored = demucs_load.load_demucs_checkpoint(path)
    assert cfg == ht.HTDemucsConfig(**SMALL)
    assert list(restored) == [name for name, _ in manifest]
    for name, shape in manifest:
        got, want = restored[name].numpy(), flat[name]
        assert got.shape == tuple(shape)
        if int(np.prod(shape)) > min_params:  # 8 bits, per group of 8: half a level
            assert np.abs(got - want).max() <= np.abs(want).max() / 127 / 2 * 1.001
        else:
            np.testing.assert_array_equal(got, want)
    ht.HTDemucs(cfg).load_state_dict(restored, strict=True)


def test_checksum_mismatch_raises(tmp_path, model_dir):
    good = next(fn for fn in os.listdir(model_dir) if fn.endswith(".th"))
    demucs_load.check_checksum(os.path.join(model_dir, good))
    bad = tmp_path / f"{SIGNATURE}-0badc0de.th"
    bad.write_bytes(open(os.path.join(model_dir, good), "rb").read())
    with pytest.raises(RuntimeError, match="Invalid checksum"):
        demucs_load.check_checksum(str(bad))
    (tmp_path / "bag.yaml").write_text(json.dumps({"models": [SIGNATURE]}))
    with pytest.raises(RuntimeError, match="Invalid checksum"):
        demucs_load.load_demucs_model_or_bag("bag.yaml", str(tmp_path))
    named = tmp_path / "my-finetune.th"  # not the scheme: not verified
    named.write_bytes(b"x")
    demucs_load.check_checksum(str(named))
    with pytest.raises(FileNotFoundError):
        demucs_load.load_demucs_model_or_bag("absent", str(tmp_path))


def test_hdemucs_package_is_refused_loudly(tmp_path):
    """An HDemucs package loads as Demucs v3, as the JAX loader reads it: the
    HDemucs constructor's defaults (depth 6, 40 s segments, DConv compression
    4) and exact-length evaluation; its state loads into ``HDemucs``
    strictly. (Until Demucs v3 was ported, such a package was refused.)"""
    from audio_separator_tpu.models.demucs_load import load_demucs_checkpoint as jax_load
    from audio_separator_tpu_torch.models.init_params import htdemucs_kwargs

    kwargs = {"sources": list(SOURCES), "channels": 8, "nfft": 256, "norm_starts": 2,
              "dconv_lstm": 3, "dconv_attn": 3}
    cfg = ht.config_from_kwargs(kwargs, klass_name="HDemucs")
    tree = init_htdemucs_params(cfg, seed=2)
    assert htdemucs_kwargs(cfg)["depth"] == 6
    state = {k: torch.from_numpy(v) for k, v in flatten_tree(tree).items()}
    path = _save_package(str(tmp_path), "v3model", "HDemucs", kwargs, state)
    klass, cfg, restored = demucs_load.load_demucs_checkpoint(path)
    _, jcfg, _ = jax_load(path)
    assert klass == "HDemucs" and cfg.arch == jcfg.arch == "hdemucs"
    for field in ("depth", "segment", "use_train_segment", "channels", "nfft", "norm_starts"):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    assert (cfg.depth, cfg.segment, cfg.use_train_segment, cfg.dconv_comp) == (6, 40.0, False, 4)
    model = ht.build_demucs(cfg)
    assert isinstance(model, ht.HDemucs)
    model.load_state_dict(restored, strict=True)


# ----------------------------------------------------------------- the plan


@pytest.mark.parametrize("track_len", [132300, 22050, 10000, 154350])
@pytest.mark.parametrize("overlap", [0.25, 0.5])
def test_train_segment_plan_matches_jax(track_len, overlap):
    port, ref = DemucsSeparator.__new__(DemucsSeparator), \
        JaxDemucsSeparator.__new__(JaxDemucsSeparator)
    port.overlap = ref.overlap = overlap
    got = port._train_segment_plan(ht.HTDemucsConfig(**SMALL), track_len)
    want = ref._train_segment_plan(jax_ht.HTDemucsConfig(**SMALL), track_len)
    assert got[:4] == want[:4]
    for g, w in zip(got[4:], want[4:]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


# -------------------------------------------------------------------- demix


@pytest.fixture(scope="module")
def jax_outputs(model_dir, mix):
    """The JAX separator's ``demix_demucs`` for every case below (each case
    compiles its own program, so they are made once for the module)."""
    outs = {}
    for shifts in (0, 2):
        sep = JaxDemucsSeparator(common_config=_common(model_dir),
                                 arch_config=_arch(shifts, True))
        outs[(shifts, True)] = sep.demix_demucs(mix)
    sep = JaxDemucsSeparator(common_config=_common(model_dir), arch_config=_arch(2, False))
    outs[(2, False)] = sep.demix_demucs(mix[:, :SHORT])
    # Split off without shifts: the JAX ``demix_demucs`` scales a read-only
    # view of the device result in place and raises, so the direct pass is
    # compared one level down (at the length the shifted passes above ran at).
    (cfg, params), = sep._load_models()[0]
    outs["direct"] = np.asarray(sep._apply_split(cfg, params, mix[:, :DIRECT]))
    return outs


@pytest.mark.parametrize("shifts,split", [(0, True), (2, True), (2, False)])
def test_demix_demucs_matches_jax(model_dir, mix, jax_outputs, shifts, split):
    """Split on: the whole 3 s mix through the engine, without shifts and
    with both shifts in one call. Split off: the shifts are sequential direct
    passes over the whole (here short) track."""
    track = mix if split else mix[:, :SHORT]
    sep = DemucsSeparator(common_config=_common(model_dir, device="cpu"),
                          arch_config=_arch(shifts, split))
    got = sep.demix_demucs(track)
    want = jax_outputs[(shifts, split)]
    assert got.shape == want.shape == (4, 2, track.shape[-1])
    assert np.isfinite(got).all()
    for i in range(4):
        assert _sdr(want[i], got[i]) >= MIN_PARITY_SDR, (i, _sdr(want[i], got[i]))


def test_direct_pass_without_split_matches_jax(model_dir, mix, jax_outputs):
    sep = DemucsSeparator(common_config=_common(model_dir, device="cpu"),
                          arch_config=_arch(0, False))
    model = sep._load_models()[0][0]
    got = sep._apply_split(model, mix[:, :DIRECT])
    want = jax_outputs["direct"]
    assert got.shape == want.shape == (4, 2, DIRECT)
    for i in range(4):
        assert _sdr(want[i], got[i]) >= MIN_PARITY_SDR
    got[0] *= 2.0  # the port's result is writable, so demix_demucs can weight it
    full = sep.demix_demucs(mix[:, :DIRECT])
    assert full.shape == (4, 2, DIRECT) and np.isfinite(full).all()


def test_demix_demucs_wanted_rows_match_the_full_result(model_dir, mix, jax_outputs):
    sep = DemucsSeparator(common_config=_common(model_dir, device="cpu"),
                          arch_config=_arch(0, True))
    full = sep.demix_demucs(mix)
    want = jax_outputs[(0, True)]
    for wanted in ((3,), (0,), (1, 2)):
        rows = sep.demix_demucs(mix, wanted=wanted)
        assert rows.shape == (len(wanted), 2, mix.shape[-1])
        for j, i in enumerate(wanted):
            np.testing.assert_allclose(rows[j], full[i], atol=1e-5)
            assert _sdr(want[i], rows[j]) >= MIN_PARITY_SDR


def test_segment_override_and_models_are_loaded_once(model_dir):
    sep = DemucsSeparator(common_config=_common(model_dir, device="cpu"),
                          arch_config={**_arch(0, True), "segment_size": 1})
    models, weights = sep._load_models()
    assert models[0].cfg.segment == 1.0 and models[0].cfg.training_length == SR
    assert weights == BAG_WEIGHTS
    assert sep._load_models()[0][0] is models[0]
    assert not any(p.is_cuda for p in models[0].parameters())


def test_exact_length_split_is_refused(model_dir, mix):
    """The exact-length split runs (it was refused until Demucs v3 was
    ported; tests/test_torch_demucs_v3_separator.py holds it to the JAX
    package). Over 30000 samples in 0.5 s windows at stride 16537, the window
    at 0 is full and the one at 16537 is a tail: up to the tail's start the
    result is the first window's own output, where the weights cancel."""
    import dataclasses

    sep = DemucsSeparator(common_config=_common(model_dir, device="cpu"),
                          arch_config=_arch(0, True))
    model = sep._load_models()[0][0]
    saved = model.cfg
    model.cfg = dataclasses.replace(saved, use_train_segment=False)
    try:
        track = mix[:, :30000]
        out = sep._apply_split(model, track)
        first = model(torch.from_numpy(track[None, :, :22050]))[0].numpy()
    finally:
        model.cfg = saved
    assert out.shape == (4, 2, 30000) and np.isfinite(out).all()
    np.testing.assert_allclose(out[..., :16537], first[..., :16537],
                               atol=1e-5 * np.abs(first).max())


# ---------------------------------------------------------------- Separator


def test_separator_end_to_end_writes_the_stems_jax_names(model_dir, mix, tmp_path):
    wav = str(tmp_path / "song.wav")
    audio_io.save_audio(wav, mix, SR)
    out_dir = str(tmp_path / "out")
    sep = Separator(model_file_dir=model_dir, output_dir=out_dir, device="cpu",
                    log_level=logging.WARNING)
    assert sep.arch_specific_params["Demucs"] == {
        "segment_size": "Default", "shifts": 2, "overlap": 0.25, "segments_enabled": True}
    sep.load_model("htdemucs.yaml")
    assert isinstance(sep.model_instance, DemucsSeparator)
    files = sep.separate(wav)

    ref = JaxDemucsSeparator(common_config=_common(model_dir, out_dir),
                             arch_config=_arch(2, True))
    ref.audio_file_base = "song"
    expected = [ref.get_stem_output_path(stem, None)
                for stem in ("Bass", "Drums", "Other", "Vocals")]
    assert files == expected
    direct = sep.model_instance.demix_demucs(mix)
    for i, name in enumerate(files):
        pcm, sr = audio_io.load_audio(os.path.join(out_dir, name))
        assert sr == SR and pcm.shape == mix.shape
        assert np.isfinite(pcm).all() and np.abs(pcm).max() > 1e-3
        # The written stem is the demix row, peak-normalised to 0.9 at most.
        row = direct[i] * min(1.0, 0.9 / np.abs(direct[i]).max())
        assert _sdr(row, pcm) >= MIN_PARITY_SDR


def test_separator_inference_builds_no_graph(model_dir, mix, tmp_path):
    """The HTDemucs forwards of a separation run without gradients: no
    parameter requires one and no model output carries a graph."""
    wav = str(tmp_path / "song.wav")
    audio_io.save_audio(wav, mix[:, : SR // 2], SR)
    sep = Separator(model_file_dir=model_dir, output_dir=str(tmp_path / "out"), device="cpu",
                    log_level=logging.WARNING)
    sep.load_model("htdemucs.yaml")
    models, _ = sep.model_instance._load_models()
    graphs = []
    handles = [m.register_forward_hook(
        lambda _m, _i, out: graphs.append(out.requires_grad or out.grad_fn is not None))
        for m in models]
    try:
        assert len(sep.separate(wav)) == 4
    finally:
        for h in handles:
            h.remove()
    assert graphs and not any(graphs)
    assert not any(p.requires_grad for m in models for p in m.parameters())


def test_separator_single_stem_writes_only_that_stem(model_dir, mix, tmp_path):
    wav = str(tmp_path / "song.wav")
    audio_io.save_audio(wav, mix[:, :SR], SR)
    sep = Separator(model_file_dir=model_dir, output_dir=str(tmp_path / "out"), device="cpu",
                    output_single_stem="drums", log_level=logging.WARNING,
                    demucs_params={"segment_size": "Default", "shifts": 0, "overlap": 0.25,
                                   "segments_enabled": True})
    sep.load_model("htdemucs.yaml")
    files = sep.separate(wav)
    assert len(files) == 1 and "(Drums)" in files[0]
    assert os.path.exists(os.path.join(str(tmp_path / "out"), files[0]))
