"""The kernels' operation and byte counts reproduce the bounds measured and
recorded for the port (PERF.md's kernel table): B1 0.744 / 0.443 TFLOP a
call on the flagship's time and frequency axes, B2 0.833 TFLOP, B3 14.8
GFLOP at (4, 8, 1344, 64), K1 in bf16 0.412 / 0.253 ms."""

import pytest

from benchlib import manifest, peaks


def counts(name):
    return manifest.plugin("counts", name)


@pytest.mark.parametrize("batch, n_pad, n_valid, tflop", [(248, 832, 801, 0.744),
                                                          (3204, 64, 62, 0.443)])
def test_b1(batch, n_pad, n_valid, tflop):
    ops, nbytes = counts("b1").count(batch, n_pad, n_valid, 512, 512, 8, 4, 0)
    assert round(ops / 1e12, 3) == tflop
    assert nbytes / peaks.HBM_BYTES < ops / peaks.TF32_FLOPS  # bound by operations


def test_b2():
    ops, _ = counts("b2").count(248 * 801, 248 * 832, 512, 2048, 4, 0)
    assert round(ops / 1e12, 3) == 0.833


def test_b3():
    ops, nbytes = counts("b3").count(4, 8, 1344, 1344, 64, 4)
    assert round(ops / 1e9, 1) == 14.8
    assert nbytes == 4 * 4 * 8 * 1344 * 64 * 4


@pytest.mark.parametrize("batch, n_pad, n_valid, bound_ms", [(124, 832, 801, 0.412),
                                                             (1602, 64, 62, 0.253)])
def test_k1_bf16(batch, n_pad, n_valid, bound_ms):
    ops, nbytes = counts("k1_bf16").count(batch, 8, n_pad, n_valid, 64, 2)
    assert round(1e3 * peaks.bound_s(ops, nbytes, 2), 3) == bound_ms


def test_peaks_by_type():
    assert peaks.matmul_peak(4) == peaks.TF32_FLOPS
    assert peaks.matmul_peak(2) == peaks.BF16_FLOPS


def test_roofline_reader_sums_bounds_over_attributed_device_time():
    from types import SimpleNamespace

    from benchlib import probes, readers
    from benchlib.trace import Summary

    probe = probes.Probe("b1_test")
    call = dict(batch=248, n_pad=832, n_valid=801, dim=512, inner=512, heads=8,
                itemsize=4, weight_bytes=0)
    probe.calls = [call, call]
    probes._PROBES["b1_test"] = probe
    try:
        ops, nbytes = counts("b1").count(**call)
        bound = 2 * peaks.bound_s(ops, nbytes, 4)
        summary = Summary(1.0, 0.5, [], [], {"b1_test": 4 * bound})
        ctx = SimpleNamespace(window=SimpleNamespace(summary=summary))
        assert readers.roofline(ctx, "b1_test", "b1") == pytest.approx(25.0)
    finally:
        probes._PROBES.pop("b1_test")
