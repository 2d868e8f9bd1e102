"""Each driver runs its cell end to end on the CPU at a tiny configuration
of its own, through the same code as on the card, and prints one
well-formed result line with ``correct`` true."""

import json

import pytest

from cpu_runs import TINY, run_tiny
from conftest import ROOT


def _manifest():
    with open(f"{ROOT}/BENCHMARK.json") as f:
        return json.load(f)


@pytest.mark.parametrize("cell", sorted(TINY))
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_on_the_cpu(cell, trace):
    man = _manifest()
    if cell not in {w["name"] for w in man["workloads"]}:
        pytest.skip(f"{cell} is not in BENCHMARK.json")
    rc, result, err = run_tiny(cell, trace=trace, seconds=0.5 if cell != "bsroformer_remote_clips" else 2)
    assert rc == 0, err[-3000:]
    assert {"correct", "attempted", "failed", "metrics", "device", "checks"} <= set(result)
    assert list(result)[-1] == "checks"
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert result["device"]["platform"] == "cpu"
    for check in result["checks"].values():
        assert check["value"] <= check["limit"]
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        allowed = {m["name"] for m in man["per_layer"] if cell in m["workloads"]}
        assert set(result["metrics"]) <= allowed
    else:
        wanted = {m["name"] for m in man["end_to_end"] if cell in m.get("workloads", [cell])}
        assert set(result["metrics"]) == wanted
        for metric in result["metrics"].values():
            assert metric["value"] > 0
