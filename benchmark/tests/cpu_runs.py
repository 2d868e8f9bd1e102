"""Runs of a cell on the CPU at a tiny configuration, through ``run.main``."""

import contextlib
import io
import json
import os

import run

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")

# Configuration, traffic and cell file of each cell's tiny copy. A tiny cell
# file is the cell's own with limits set from tiny CPU runs: the card's
# limits hold the card's sizes.
TINY = {
    "bsroformer_fp32_songs": ("tiny_roformer.json", "tiny_songs.json"),
    "htdemucs_songs": ("tiny_htdemucs.json", "tiny_songs.json"),
    "bsroformer_bf16_finetune": ("tiny_roformer.json", "tiny_finetune.json"),
    "bsroformer_remote_clips": ("tiny_roformer.json", "tiny_clips.json"),
}


def run_tiny(cell: str, seed: int = 12345678901, seconds: float = 0.5, trace: int = 0):
    """``(exit code, last stdout line as JSON or None, stderr)``."""
    config, traffic = TINY[cell]
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace)], allow_cpu=True,
                      config_file=os.path.join(DATA, config),
                      traffic_file=os.path.join(DATA, traffic),
                      spec_file=os.path.join(DATA, f"cell_{cell}.json"))
    lines = out.getvalue().strip().splitlines()
    result = json.loads(lines[-1]) if rc == 0 and lines else None
    return rc, result, err.getvalue()
