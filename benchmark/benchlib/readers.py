"""Arithmetic the per-layer readers share: a kernel's roofline share from its
probe's recorded calls and the device time the trace attributes to it, an
idle share, a model FLOP utilisation."""

from __future__ import annotations

from . import manifest, peaks, probes


def roofline(ctx, probe_name: str, counts_name: str) -> float | None:
    """100 × Σ bound over Σ device time of the probe's calls in the window,
    each call's operations and bytes from ``counts/<counts_name>.py`` with
    the call's recorded arguments; None where the window made no call or the
    trace attributes no time."""
    probe = probes.get(probe_name)
    summary = ctx.window.summary if ctx.window is not None else None
    if probe is None or summary is None or not probe.calls:
        return None
    device_s = summary.span_device_s.get(probe_name, 0.0)
    if device_s <= 0:
        return None
    count = manifest.plugin("counts", counts_name).count
    bound = sum(peaks.bound_s(*count(**call), call["itemsize"]) for call in probe.calls)
    return 100.0 * bound / device_s


def idle_share(ctx) -> float | None:
    summary = ctx.window.summary if ctx.window is not None else None
    if summary is None or summary.window_s <= 0 or summary.busy_s <= 0:
        return None
    return 100.0 * (1.0 - summary.busy_s / summary.window_s)


def mfu(ctx, flops_key: str, units_key: str, peak: float) -> float | None:
    """100 × (units of work in the window × FLOP a unit) / (window × peak)."""
    flops, units = ctx.extras.get(flops_key), ctx.extras.get(units_key)
    window_s = ctx.extras.get("window_s")
    if not flops or not units or not window_s:
        return None
    return 100.0 * flops * units / (window_s * peak)
