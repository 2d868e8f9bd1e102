"""BENCHMARK.json against the benchmark's contract: names, units, keys, the
files each entry names, and the per-layer metrics' cells."""

import json
import os
import re

import pytest

from benchlib import manifest
from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def man():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert len(json.dumps(man)) <= 64 * 1024


def test_command_and_paths(man):
    assert 1 <= len(man["paths"]) <= 16
    for p in man["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert 1 <= len(man["command"]) <= 32
    for word in man["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word and "\t" not in word
        assert not word.startswith("/") and ".." not in word.split("/")
        if "/" in word:
            assert any(word.startswith(p + "/") for p in man["paths"])


def test_run_seconds_fits_a_full_check(man):
    rs = man["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    cells = 24
    assert (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200 <= 43200


def test_names_units_and_text(man):
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [entry["name"] for entry in man[group]]
        assert all(NAME.match(n) for n in names), names
        assert len(set(names)) == len(names)
        for entry in man[group]:
            for key in ("why", "layer"):
                if key in entry:
                    text = entry[key]
                    assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    metrics = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_configs(man):
    assert 1 <= len(man["configs"]) <= 24
    used = {w["config"] for w in man["workloads"]}
    files = set()
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"].startswith("benchmark/") and c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]
        assert len(c["reduced"]) <= 16
        assert c["source"].startswith("https://")


def test_workloads(man):
    assert 1 <= len(man["workloads"]) <= 24
    pairs = set()
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert NAME.match(w["traffic"]) and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        for path in (f"workloads/{w['name']}.json", f"traffic/{w['traffic']}.json"):
            with open(os.path.join(BENCH, path)) as f:
                json.load(f)
        with open(os.path.join(BENCH, "workloads", f"{w['name']}.json")) as f:
            driver = json.load(f)["driver"]
        assert os.path.exists(os.path.join(BENCH, "drivers", f"{driver}.py"))


def test_end_to_end(man):
    assert 1 <= len(man["end_to_end"]) <= 16
    keys = {"name", "unit", "better", "bound", "source", "workloads"}
    names = [m["name"] for m in man["end_to_end"]]
    assert "setup_s" in names
    for m in man["end_to_end"]:
        assert set(m) <= keys and keys - {"workloads"} <= set(m)
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in man["workloads"]}
    for cell in cells:
        reported = [m for m in man["end_to_end"] if cell in m.get("workloads", [cell])]
        assert any(m["name"] == "setup_s" for m in reported)
        assert len(reported) >= 2


def test_per_layer(man):
    assert 1 <= len(man["per_layer"]) <= 128
    e2e = {m["name"]: m for m in man["end_to_end"]}
    cells = {w["name"] for w in man["workloads"]}
    layers = {}
    for m in man["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert os.path.exists(manifest.plugin_path("metrics", m["name"]))
        for cell in m["workloads"]:
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", [cell]), (m["name"], cell)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for cell in cells:
        assert any(cell in m["workloads"] for m in man["per_layer"])


def test_every_rate_cell_reports_its_mfu_beside_its_rooflines(man):
    for m in man["per_layer"]:
        if m["name"].endswith("_roofline"):
            for cell in m["workloads"]:
                assert any("mfu" in o["name"] and cell in o["workloads"]
                           and o["moves"] == m["moves"] for o in man["per_layer"])


def test_files_under_paths_are_named_from_name_characters(man):
    for base, _, files in os.walk(BENCH):
        if "__pycache__" in base or ".cache" in base:
            continue
        for name in files:
            rel = os.path.relpath(os.path.join(base, name), ROOT)
            if name.endswith(".pyc"):
                continue
            assert PATH.match(rel), rel


@pytest.mark.parametrize("name, file", [
    ("idle_share.train", "idle_share.py"),
    ("mfu.demucs", "mfu.py"),
    ("mfu.train", "mfu.train.py"),
    ("b1_roofline", "b1_roofline.py"),
])
def test_a_metric_without_a_reader_of_its_own_is_read_by_its_kind(name, file):
    assert manifest.plugin_path("metrics", name) == os.path.join(BENCH, "metrics", file)
    assert manifest.plugin("metrics", name) is manifest.plugin("metrics", file[:-3])


def test_a_cells_dtype_sets_autocast(man):
    for w in man["workloads"]:
        cell = manifest.Cell(w["name"], man)
        if cell.spec["driver"] != "finetune":
            assert cell.autocast() is (cell.spec["dtype"] == "bfloat16")
