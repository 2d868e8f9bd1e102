"""The manifest and the files it names: one cell, one configuration, one
traffic mix, one driver, one per-layer reader, each found by its name.

    benchmark/workloads/<cell>.json     the cell: driver, dtype, program options, limits
    benchmark/traffic/<traffic>.json    the traffic mix's parameters
    benchmark/configs/<config>.json     the configuration (BENCHMARK.json names the file)
    benchmark/drivers/<driver>.py       one general driver a kind of traffic
    benchmark/families/<family>.py      a model family: its seeded weights and reference
    benchmark/metrics/<metric>.py       one per-layer reader; a metric
                                        ``<kind>.<part>`` (``idle_share.train``)
                                        without a file of its own is read by
                                        ``metrics/<kind>.py``
    benchmark/counts/<kernel>.py        one kernel's operations and bytes
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def load_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def manifest(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def plugin_path(kind: str, name: str) -> str:
    """``benchmark/<kind>/<name>.py``; where that is absent and the name is
    ``<base>.<part>``, ``benchmark/<kind>/<base>.py``."""
    path = os.path.join(BENCH, kind, f"{name}.py")
    if not os.path.exists(path) and "." in name:
        path = os.path.join(BENCH, kind, f"{name.rsplit('.', 1)[0]}.py")
    return path


def plugin(kind: str, name: str):
    """The module ``plugin_path(kind, name)`` names, loaded once."""
    path = plugin_path(kind, name)
    stem = os.path.splitext(os.path.basename(path))[0]
    key = f"bench_{kind}_{stem}".replace(".", "_").replace("-", "_")
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    spec.loader.exec_module(module)
    return module


class Cell:
    """One cell with everything it names, read from the manifest."""

    def __init__(self, name: str, man: dict, root: str = ROOT, config_file: str = None,
                 traffic_file: str = None, spec_file: str = None):
        entries = [w for w in man["workloads"] if w["name"] == name]
        if not entries:
            raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
        self.entry = entries[0]
        self.name = name
        self.chips = int(self.entry["chips"])
        self.spec = load_json(spec_file or os.path.join(BENCH, "workloads", f"{name}.json"))
        self.traffic = load_json(traffic_file or os.path.join(BENCH, "traffic",
                                                             f"{self.entry['traffic']}.json"))
        conf = [c for c in man["configs"] if c["name"] == self.entry["config"]][0]
        self.config = load_json(config_file or os.path.join(root, conf["file"]))
        self.end_to_end = [m for m in man["end_to_end"] if name in m.get("workloads", [name])]
        self.per_layer = [m for m in man["per_layer"] if name in m.get("workloads", [name])]
        self.driver = plugin("drivers", self.spec["driver"])

    def autocast(self) -> bool:
        """Whether the program separates under bf16 autocast: the cell's dtype."""
        return {"float32": False, "bfloat16": True}[self.spec["dtype"]]

    def family(self):
        return plugin("families", self.config["family"])
