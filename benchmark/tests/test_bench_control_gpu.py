"""The controls on the card, at a size a test run holds: the reference in
the precision below the configuration's, in the program's place, comes out
above each cell's limit. The full-size readings that set the limits come
from ``benchmark/control.py``."""

import argparse

import pytest
import torch

import run
from benchlib import manifest


def _ctx(cell_name, seed, device, tmp_path, traffic=None):
    cell = manifest.Cell(cell_name, manifest.manifest())
    if traffic:
        cell.traffic = {**cell.traffic, **traffic}
    return run.Context(cell, argparse.Namespace(seed=seed, seconds=0, trace=0), device,
                       str(tmp_path))


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["bsroformer_fp32_songs", "htdemucs_songs"])
def test_tf32_control_fails_the_song_check(cuda, tmp_path, cell):
    import control

    ctx = _ctx(cell, 424242, cuda, tmp_path, {"count": 1, "min_s": 20, "max_s": 20})
    reading = control.song_control(ctx)
    assert reading["stem_rel_err"] > ctx.cell.spec["limits"]["stem_rel_err"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.gpu
def test_fp8_control_fails_the_finetune_check(cuda, tmp_path):
    import control

    ctx = _ctx("bsroformer_bf16_finetune", 434343, cuda, tmp_path)
    reading = control.train_control(ctx, None)
    limits = ctx.cell.spec["limits"]
    assert any(reading[k] > limits[k] for k in limits)
