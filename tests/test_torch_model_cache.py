"""The port's process-wide model cache (``ops/fn_cache``) and its converted
checkpoint cache (``models/convert.cached_convert``), on the CPU:

* a second ``Separator`` over the same file reads no checkpoint and shares the
  first one's module, and its stems are bit-identical, for every family
  (BS-RoFormer and TFC-TDF through MDXC, VR, MDX, a Demucs bag);
* a touched checkpoint (new modification time) is read again;
* two threads that ask for one model build it once;
* the LRU keeps at most ``MAX_ENTRIES`` and drops the least recently used;
* ``make_train_step`` refuses a cached module and takes a copy;
* ``load_params`` reads what ``save_params`` writes, and so does the JAX
  package's ``load_params``;
* the converted ``.npz`` is kept per configuration, and a RoFormer or
  TFC-TDF built from it separates bit-identically to one built from the
  checkpoint."""

import copy
import json
import logging
import os
import threading
import time

import numpy as np
import pytest
import torch

from audio_separator_tpu.models import convert as jax_convert
from audio_separator_tpu_torch.architectures import mdx as mdx_arch
from audio_separator_tpu_torch.architectures import vr as vr_arch
from audio_separator_tpu_torch.io import audio as audio_io
from audio_separator_tpu_torch.models import convert, demucs_load
from audio_separator_tpu_torch.models.init_params import init_htdemucs_params
from audio_separator_tpu_torch.models.htdemucs import HTDemucsConfig
from audio_separator_tpu_torch.ops import fn_cache
from audio_separator_tpu_torch.separator import DEFAULT_MODEL, Separator
from audio_separator_tpu_torch.training import make_train_step
from torch_oracles.roformer_oracle import RoformerOracle
from torch_threads import one_torch_thread  # noqa: F401

SR = 44100
JOIN_S = 60


def _write_roformer(model_dir):
    torch.manual_seed(3)
    freqs, bins, start = (16, 16, 32, 65), [], 0
    for nf in freqs:
        bins.append(list(range(start, start + nf)))
        start += nf
    oracle = RoformerOracle(kind="bs", band_bins=bins, dim=32, depth=1, heads=2, dim_head=16,
                            stereo=True, num_stems=1, t_depth=1, f_depth=1, n_fft=256,
                            hop=64, mask_depth=2)
    with torch.no_grad():
        for p in oracle.parameters():
            p.copy_(torch.randn_like(p) * 0.2)
    torch.save({"state_dict": oracle.state_dict()}, os.path.join(model_dir, DEFAULT_MODEL))
    config = {
        "audio": {"sample_rate": SR, "hop_length": 64},
        "model": {"dim": 32, "depth": 1, "stereo": True, "num_stems": 1,
                  "time_transformer_depth": 1, "freq_transformer_depth": 1,
                  "freqs_per_bands": list(freqs), "dim_head": 16, "heads": 2,
                  "stft_n_fft": 256, "stft_hop_length": 64, "stft_win_length": 256,
                  "mask_estimator_depth": 2},
        "training": {"instruments": ["vocals", "other"], "target_instrument": "vocals"},
        "inference": {"dim_t": 64},
    }
    with open(os.path.join(model_dir, DEFAULT_MODEL.replace(".ckpt", ".yaml")), "w") as f:
        json.dump(config, f)  # JSON-flow YAML
    return DEFAULT_MODEL, {}


def _write_tfc_tdf(model_dir):
    from test_torch_mdxc_tfc_tdf_separator import MODEL, write_mdx23c_model

    write_mdx23c_model(model_dir)
    return MODEL, {}


def _write_vr(model_dir):
    from test_torch_vr_separator import PLAIN, TINY_CAPS, V5, V5_DATA, _randomize
    from torch_oracles.vr_oracle import CascadedASPPNetOracle

    net = _randomize(CascadedASPPNetOracle(768 * 2, TINY_CAPS, 31191), seed=3).eval()
    torch.save(net.state_dict(), os.path.join(model_dir, V5))
    with open(os.path.join(model_dir, V5.replace(".pth", ".json")), "w") as f:
        json.dump(V5_DATA, f)
    return V5, {"vr_params": dict(PLAIN, window_size=320)}


def _write_mdx(model_dir):
    from test_torch_mdx_separator import MDX_PARAMS, MODEL, write_mdx_model

    write_mdx_model(model_dir)
    return MODEL, {"mdx_params": dict(MDX_PARAMS)}


def _write_demucs(model_dir):
    from test_torch_demucs_separator import KWARGS, SIGNATURE, SMALL, _save_package

    tree = init_htdemucs_params(HTDemucsConfig(**SMALL), seed=21)
    state = {k: torch.from_numpy(v) for k, v in convert.flatten_tree(tree).items()}
    _save_package(model_dir, SIGNATURE, "HTDemucs", KWARGS, state)
    with open(os.path.join(model_dir, "htdemucs.yaml"), "w") as f:
        json.dump({"models": [SIGNATURE], "weights": [[1.0, 0.5, 1.0, 2.0]]}, f)
    return "htdemucs.yaml", {"demucs_params": {"segment_size": "Default", "shifts": 0,
                                               "overlap": 0.25, "segments_enabled": True}}


# family -> (writer, the module and name of the function that reads its file)
FAMILIES = {"roformer": (_write_roformer, convert, "load_torch_state_dict"),
            "tfc_tdf": (_write_tfc_tdf, convert, "load_torch_state_dict"),
            "vr": (_write_vr, vr_arch, "load_torch_state_dict"),
            "mdx": (_write_mdx, mdx_arch, "onnx_to_torch"),
            "demucs": (_write_demucs, demucs_load, "load_demucs_checkpoint")}


def _model_of(sep):
    inst = sep.model_instance
    for name in ("model", "net", "_onnx_params"):
        if getattr(inst, name, None) is not None:
            return getattr(inst, name)
    return inst._load_models()[0][0]


def _count_reads(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(args[0] if args else None)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)
    return calls


def _wav(path, seconds=0.5):
    t = np.arange(int(seconds * SR)) / SR
    rng = np.random.default_rng(9)
    mix = (0.3 * np.stack([np.sin(2 * np.pi * 220 * t), np.sin(2 * np.pi * 330 * t)])
           + 0.05 * rng.standard_normal((2, t.size))).astype(np.float32)
    audio_io.save_audio(path, mix, SR)
    return path


def _model_dir(tmp_path, family):
    model_dir = str(tmp_path / "models")
    os.makedirs(model_dir)
    with open(os.path.join(model_dir, "download_checks.json"), "w") as f:
        f.write("{}")
    model, kwargs = FAMILIES[family][0](model_dir)
    return model_dir, model, kwargs


def _separator(model_dir, out_dir, model, **kwargs):
    sep = Separator(model_file_dir=model_dir, output_dir=out_dir, device="cpu",
                    log_level=logging.WARNING, **kwargs)
    sep.load_model(model)
    return sep


@pytest.mark.parametrize("family", list(FAMILIES))
def test_a_second_separator_shares_the_loaded_model(tmp_path, monkeypatch, family):
    fn_cache.clear()
    model_dir, model, kwargs = _model_dir(tmp_path, family)
    _, module, reader = FAMILIES[family]
    reads = _count_reads(monkeypatch, module, reader)
    wav = _wav(str(tmp_path / "song.wav"))
    outs = []
    for run in ("fresh", "cached"):
        out_dir = str(tmp_path / run)
        sep = _separator(model_dir, out_dir, model, **kwargs)
        files = sep.separate(wav)
        outs.append((sep, out_dir, sorted(files)))
        if run == "fresh":
            assert reads, "the first separator read no model file"
            first_reads = len(reads)
    (first, dir1, files1), (second, dir2, files2) = outs
    assert len(reads) == first_reads, "the second separator read a model file again"
    assert _model_of(second) is _model_of(first)
    assert files1 == files2 and files1
    for name in files1:
        with open(os.path.join(dir1, name), "rb") as a, open(os.path.join(dir2, name), "rb") as b:
            assert a.read() == b.read(), name


def test_touching_the_checkpoint_reloads_it(tmp_path, monkeypatch):
    fn_cache.clear()
    model_dir, model, _ = _model_dir(tmp_path, "roformer")
    reads = _count_reads(monkeypatch, convert, "load_torch_state_dict")
    first = _model_of(_separator(model_dir, None, model))
    assert _model_of(_separator(model_dir, None, model)) is first and len(reads) == 1
    path = os.path.join(model_dir, model)
    st = os.stat(path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 10 ** 9))
    again = _model_of(_separator(model_dir, None, model))
    assert again is not first and len(reads) == 2


def test_two_threads_build_one_model_once():
    fn_cache.clear()
    builds, results, errors = [], [], []
    inside = threading.Event()

    def make():
        builds.append(threading.get_ident())
        inside.set()
        time.sleep(0.3)  # the second thread arrives while this one builds
        return torch.nn.Linear(2, 2)

    def ask(wait):
        try:
            if wait:
                assert inside.wait(JOIN_S)
            results.append(fn_cache.memoized_model(("two-threads",), make))
        except BaseException as exc:
            errors.append(exc)

    threads = [threading.Thread(target=ask, args=(w,)) for w in (False, True)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(JOIN_S)
    assert not errors, errors
    assert len(builds) == 1 and len(results) == 2 and results[0] is results[1]
    assert fn_cache.is_shared(results[0])


def test_the_cache_keeps_its_bound_and_drops_the_least_recently_used():
    fn_cache.clear()
    bound = fn_cache.MAX_ENTRIES
    for i in range(bound):
        fn_cache.memoized_model(("lru", i), lambda i=i: i)
    fn_cache.memoized_model(("lru", 0), lambda: pytest.fail("entry 0 was rebuilt"))
    fn_cache.memoized_model(("lru", bound), lambda: bound)
    keys = fn_cache.cached_keys()
    assert len(keys) == bound
    assert ("lru", 1) not in keys and ("lru", 0) in keys and ("lru", bound) in keys
    assert fn_cache.clear() == bound and fn_cache.cached_keys() == []


def test_make_train_step_refuses_a_cached_module(tmp_path):
    fn_cache.clear()
    model_dir, model, _ = _model_dir(tmp_path, "roformer")
    shared = _separator(model_dir, None, model).model_instance.model
    opt = torch.optim.SGD(shared.parameters(), lr=1e-3)
    with pytest.raises(ValueError, match="shared"):
        make_train_step(shared.cfg, shared, opt)
    assert not any(p.requires_grad for p in shared.parameters())
    own = copy.deepcopy(shared)
    assert not fn_cache.is_shared(own)
    step = make_train_step(own.cfg, own, torch.optim.SGD(own.parameters(), lr=1e-3),
                           stft_n_fft=256, window_sizes=(256,), hop_length=64)
    mix = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 2, 4096))
                           .astype(np.float32))
    loss = step(mix, mix[:, None] * 0.5)
    assert torch.isfinite(loss)
    assert not any(p.requires_grad for p in shared.parameters())


def test_load_params_reads_what_save_params_writes(tmp_path):
    rng = np.random.default_rng(4)
    tree = {"band_split": {"w": rng.standard_normal((3, 4)).astype(np.float32)},
            "layers": [{"a": rng.standard_normal(5).astype(np.float32)},
                       {"a": np.arange(3, dtype=np.int64)}],
            "mask_est": {"hidden": []}, "scalar": np.float32(2.5)}
    path = str(tmp_path / "tree.npz")
    convert.save_params(path, tree)
    for load in (convert.load_params, jax_convert.load_params):
        got = load(path)
        assert set(got) == set(tree) and got["mask_est"]["hidden"] == []
        np.testing.assert_array_equal(got["band_split"]["w"], tree["band_split"]["w"])
        assert len(got["layers"]) == 2
        for a, b in zip(got["layers"], tree["layers"]):
            np.testing.assert_array_equal(a["a"], b["a"])
        assert float(got["scalar"]) == 2.5


def test_cached_convert_keeps_the_converted_tree_beside_the_checkpoint(tmp_path, monkeypatch):
    model_dir, model, _ = _model_dir(tmp_path, "vr")
    path = os.path.join(model_dir, model)
    reads = _count_reads(monkeypatch, convert, "load_torch_state_dict")
    times = {}
    first = convert.cached_convert(path, None, lambda sd, _cfg: sd, times=times)
    convert.finish_cache_writes()
    assert len(reads) == 1 and set(times) == {"read", "convert"}
    cached = [f for f in os.listdir(model_dir) if f.endswith(".torch.npz")]
    assert len(cached) == 1 and not [f for f in os.listdir(model_dir) if ".tmp" in f]
    second = convert.cached_convert(path, None, lambda sd, _cfg: pytest.fail("converted"))
    assert len(reads) == 1 and set(second) == set(first)
    for key in first:
        np.testing.assert_array_equal(second[key], first[key])


def test_the_converted_tree_is_kept_per_configuration(tmp_path, monkeypatch):
    model_dir, model, _ = _model_dir(tmp_path, "vr")
    path = os.path.join(model_dir, model)
    reads = _count_reads(monkeypatch, convert, "load_torch_state_dict")

    def tagged(sd, cfg):
        return {"cfg": np.asarray(cfg), "n": np.asarray(len(sd))}

    for cfg in ("layout A", "layout B"):
        assert str(convert.cached_convert(path, cfg, tagged)["cfg"]) == cfg
    convert.finish_cache_writes()
    assert len(reads) == 2
    assert len([f for f in os.listdir(model_dir) if f.endswith(".torch.npz")]) == 2
    for cfg in ("layout B", "layout A"):
        assert str(convert.cached_convert(path, cfg, tagged)["cfg"]) == cfg
    assert len(reads) == 2


@pytest.mark.parametrize("family", ["roformer", "tfc_tdf"])
def test_a_model_built_from_the_converted_npz_separates_as_from_the_checkpoint(
        tmp_path, monkeypatch, family):
    fn_cache.clear()
    model_dir, model, kwargs = _model_dir(tmp_path, family)
    reads = _count_reads(monkeypatch, convert, "load_torch_state_dict")
    wav = _wav(str(tmp_path / "song.wav"))
    outs = []
    for run in ("checkpoint", "npz"):
        out_dir = str(tmp_path / run)
        sep = _separator(model_dir, out_dir, model, **kwargs)
        outs.append((_model_of(sep), out_dir, sorted(sep.separate(wav))))
        convert.finish_cache_writes()
        fn_cache.clear()  # the second separator builds anew, from the .npz
    assert len(reads) == 1, "the second load read the checkpoint again"
    assert [f for f in os.listdir(model_dir) if f.endswith(".torch.npz")]
    (first, dir1, files1), (second, dir2, files2) = outs
    assert second is not first and files1 == files2 and files1
    for name in files1:
        with open(os.path.join(dir1, name), "rb") as a, open(os.path.join(dir2, name), "rb") as b:
            assert a.read() == b.read(), name
