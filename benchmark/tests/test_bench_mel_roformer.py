"""The Mel-Band RoFormer cell on the CPU: the songs driver end to end at a
tiny configuration of its own; the band stages' operation counts against
``torch.utils.flop_counter`` on the plain references, for both RoFormer
kinds; the family's map from reference keys to the program's leaves; and
the band readers on a hand-made window, with and without the program's
band spans."""

import contextlib
import importlib
import io
import json
import os
import types

import pytest
import torch

import run
from benchlib import manifest, peaks, program_spans
from benchlib.trace import Summary
from conftest import ROOT

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
CELL = "melroformer_fp32_songs"
TRACING = "audio_separator_tpu_torch.utils.tracing"


def _tiny(name):
    with open(os.path.join(DATA, name)) as f:
        return json.load(f)


@pytest.mark.parametrize("trace", [0, 1])
def test_mel_cell_runs_on_the_cpu(trace):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", CELL, "--seed", "23456789012", "--seconds", "0.5",
                       "--trace", str(trace)], allow_cpu=True,
                      config_file=os.path.join(DATA, "tiny_mel_roformer.json"),
                      traffic_file=os.path.join(DATA, "tiny_songs.json"),
                      spec_file=os.path.join(DATA, f"cell_{CELL}.json"))
    assert rc == 0, err.getvalue()[-3000:]
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        man = json.load(f)
    if trace:
        allowed = {m["name"] for m in man["per_layer"] if CELL in m["workloads"]}
        assert allowed == {"band_ms_per_audio_min.mel", "band_roofline.mel", "mfu.mel"}
        assert set(result["metrics"]) <= allowed
    else:
        assert set(result["metrics"]) == {"audio_s_per_s", "setup_s"}


def _band_attrs(family, cfg, batch, frames):
    """What the program's band spans record for ``cfg``, from the plain
    reference's own modules."""
    model = cfg["yaml"]["model"]
    ref = _reference(family, cfg)
    dims = [net[0].gamma.shape[0] for net in ref.band_split.to_features]
    depth = int(model["mask_estimator_depth"])
    return ref, {"batch": batch, "frames": frames, "bands": len(dims), "runs": 0,
                 "hidden_layers": depth if family == "mel_roformer" else depth - 1,
                 "features": sum(dims)}


def _reference(family, cfg):
    fam = manifest.plugin("families", family)
    return fam.reference(cfg, "cpu", fam.seeded_state(cfg, 34567890123, "cpu"))


@pytest.mark.parametrize("family, config, stems", [("bs_roformer", "tiny_roformer.json", 1),
                                                   ("mel_roformer", "tiny_mel_roformer.json", 1),
                                                   ("mel_roformer", "tiny_mel_roformer.json", 2)])
def test_band_counts_match_the_flop_counter(family, config, stems):
    from torch.utils.flop_counter import FlopCounterMode

    cfg = _tiny(config)
    cfg["yaml"]["model"]["num_stems"] = stems
    batch, frames = 2, 5
    ref, attrs = _band_attrs(family, cfg, batch, frames)
    counts = manifest.plugin("counts", "bands")
    sizes = counts.model_sizes(cfg["yaml"]["model"])
    dim = sizes["dim"]
    with torch.no_grad():
        with FlopCounterMode(display=False) as split:
            for net in ref.band_split.to_features:
                net(torch.randn(batch, frames, net[0].gamma.shape[0]))
        x = torch.randn(batch, frames, dim)
        with FlopCounterMode(display=False) as mask:
            for est in ref.mask_estimators:
                for net in est.to_freqs:
                    net(x)
    for stage, counter in (("band_split", split), ("mask_estimate", mask)):
        ops, nbytes = counts.count(stage, **attrs, **sizes, itemsize=4)
        assert ops == counter.get_total_flops()
        assert nbytes > 0
    ops, nbytes = counts.count("band_merge", **attrs, **sizes, itemsize=4)
    assert ops == 0
    assert nbytes == stems * batch * frames * (attrs["features"] + sizes["n_feat"]) * 4


def test_mel_program_groups_rebuild_the_ports_leaves():
    """Each program leaf's norm, from the reference tensors (or row ranges)
    the family names for it, equals the norm of that leaf as the port
    converts the same state dict."""
    from audio_separator_tpu_torch.models import convert
    from audio_separator_tpu_torch.separator.roformer_config import build_roformer_config

    cfg = _tiny("tiny_mel_roformer.json")
    ref = _reference("mel_roformer", cfg)
    state = {k: v.detach() for k, v in ref.state_dict().items()}
    groups = manifest.plugin("families", "mel_roformer").program_groups(cfg, state)
    tree = convert.convert_roformer({k: v.numpy() for k, v in state.items()},
                                    build_roformer_config(cfg["yaml"]))
    leaves = convert.flatten_tree(tree)
    assert set(groups) == set(leaves)
    for leaf, parts in groups.items():
        got = torch.cat([(state[k] if rows is None else state[k][rows[0]:rows[1]]).reshape(-1)
                         for k, rows in parts])
        assert got.norm().item() == pytest.approx(float((leaves[leaf] ** 2).sum()) ** 0.5,
                                                  rel=1e-5), leaf


@pytest.fixture
def tracing(monkeypatch):
    module = importlib.import_module(TRACING)
    module.disable()
    module.clear()
    monkeypatch.setattr(program_spans, "_tracing", None)
    yield module
    module.disable()
    module.clear()


def _ctx(span_device_s, audio_s=120.0):
    cfg = _tiny("tiny_mel_roformer.json")
    summary = Summary(window_s=60.0, busy_s=50.0, device_ops=[], idle_gaps=[],
                      span_device_s=span_device_s)
    window = types.SimpleNamespace(t0=100.0, t1=160.0, seconds=60.0, summary=summary)
    cell = types.SimpleNamespace(config=cfg, autocast=lambda: False)
    return types.SimpleNamespace(window=window, extras={"audio_s": audio_s}, cell=cell)


def _read(metric, ctx):
    reader = manifest.plugin("metrics", metric)
    reader.install(ctx)
    return reader.read(ctx)


def test_band_readers_on_a_hand_made_window(tracing):
    device = {"kernel.band_split": 0.1, "kernel.mask_estimate": 0.3, "kernel.band_merge": 0.1,
              "kernel.fused_attention_block": 9.0}
    ctx = _ctx(device)
    # 0.5 s of band work over 2 minutes of audio.
    assert _read("band_ms_per_audio_min.mel", ctx) == pytest.approx(250.0)
    attrs = dict(batch=4, frames=33, bands=24, runs=17, hidden_layers=2, features=400)
    for start in (101.0, 159.99, 170.0):  # the last ends after the window
        for k, stage in enumerate(("band_split", "mask_estimate", "band_merge")):
            tracing.mark(f"kernel.{stage}", int((start + k * 1e-3) * 1e9),
                         int((start + k * 1e-3 + 5e-4) * 1e9), **attrs)
    counts = manifest.plugin("counts", "bands")
    sizes = counts.model_sizes(ctx.cell.config["yaml"]["model"])
    bound = 2 * sum(peaks.bound_s(*counts.count(stage, **attrs, **sizes, itemsize=4), 4)
                    for stage in ("band_split", "mask_estimate", "band_merge"))
    assert _read("band_roofline.mel", ctx) == pytest.approx(100.0 * bound / 0.5)


def test_band_readers_return_none_without_the_band_spans(tracing):
    """The program before its band spans: nothing attributed to them."""
    ctx = _ctx({"kernel.fused_attention_block": 9.0})
    assert _read("band_ms_per_audio_min.sep", ctx) is None
    assert _read("band_roofline.mel", ctx) is None
