"""The port's spans on the card: what a traced benchmark run attributes to
them, and what they cost.

    python3 tools/torch_spans.py check --workload <cell> --seed <n> [--seconds 51]
    python3 tools/torch_spans.py cost

``check`` runs one benchmark cell traced (``benchmark/run.py --trace 1``,
which prints its result line) with a ``benchlib.trace.Window`` kept, then
prints one JSON line from the window's whole summary: the idle seconds by
name (every gap, not the result line's first ten), the share of idle named
by a program span other than ``separate.request`` (a program span is
``<layer>.<part>``; the harness's names have no dot), and the device seconds
of each ``kernel.<name>`` range beside those of the harness's probe of the
same kernel (``b1``, ``b2``, ``b3``, ``k1``), with their relative gap, and
the encodes: ``io/audio.ENCODES`` over the whole run, and the window's
``audio.encode`` records by their ``route`` and their median milliseconds;
with the count and the summed seconds of the window's records of each span
name (a span's time includes the spans inside it).

``cost`` times, in one process, a call of ``tracing.span`` and
``ops/_build.launch`` with spans off, on, and on under a running CPU
profiler, and ``ops/_build.count``, in ns a call (the median of several
rounds).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Kernel range -> the harness probe around the same kernel's entry point.
PROBE_OF = {"kernel.fused_attention_block": "b1", "kernel.fused_ff_block": "b2",
            "kernel.fused_attention": "b3", "kernel.attention_backward_bf16": "k1"}


def check(args) -> int:
    for path in (os.path.join(ROOT, "benchmark"), ROOT):
        if path not in sys.path:
            sys.path.insert(0, path)
    import run
    from benchlib import trace

    windows = []

    class KeptWindow(trace.Window):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            windows.append(self)

    trace.Window = KeptWindow
    rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", "1"])
    if rc != 0 or not windows or windows[0].summary is None:
        print(f"torch_spans: the run gave rc {rc} and no traced window", file=sys.stderr)
        return rc or 1
    s = windows[0].summary
    idle = dict(s.idle_gaps)
    idle_s = sum(idle.values())
    program = {k: v for k, v in idle.items() if "." in k and k != "separate.request"}
    kernels = {}
    for name, probe in PROBE_OF.items():
        if name in s.span_device_s or probe in s.span_device_s:
            a, b = s.span_device_s.get(name, 0.0), s.span_device_s.get(probe, 0.0)
            kernels[name] = {"range_s": a, "probe": probe, "probe_s": b,
                             "gap": (a - b) / b if b else None}
    line = {"workload": args.workload, "seed": args.seed, "window_s": s.window_s,
            "busy_s": s.busy_s, "idle_s": idle_s,
            "program_named_share": sum(program.values()) / idle_s if idle_s else None,
            "idle_by_name": idle, "kernels": kernels,
            "span_device_s": {k: v for k, v in s.span_device_s.items()},
            **_window_spans(windows[0])}
    print("SPANS " + json.dumps(line), flush=True)
    return 0


def _window_spans(win) -> dict:
    from audio_separator_tpu_torch.io import audio
    from audio_separator_tpu_torch.utils import tracing

    kept = [r for r in tracing.records() if win.t0 * 1e9 <= r.end_ns <= win.t1 * 1e9]
    seconds = {}
    for r in kept:
        n, total = seconds.get(r.name, (0, 0.0))
        seconds[r.name] = (n + 1, total + (r.end_ns - r.start_ns) / 1e9)
    encodes = [r for r in kept if r.name == "audio.encode"]
    routes = {}
    for r in encodes:
        route = r.attrs.get("route", "unnamed")
        routes[route] = routes.get(route, 0) + 1
    return {"encodes": dict(getattr(audio, "ENCODES", {})), "encode_routes": routes,
            "encode_ms_median": statistics.median((r.end_ns - r.start_ns) / 1e6 for r in encodes)
            if encodes else None,
            "span_count_s": seconds}


def _ns_a_call(fn, n: int, rounds: int = 7) -> float:
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            fn()
        times.append((time.perf_counter_ns() - t0) / n)
    return statistics.median(times)


def cost(args) -> int:
    sys.path.insert(0, ROOT)
    from audio_separator_tpu_torch.ops import _build
    from audio_separator_tpu_torch.utils import tracing

    def span():
        with tracing.span("cost.span"):
            pass

    def launch():
        with _build.launch("fused_ff_block"):
            pass

    def count():
        _build.count("fused_ff_block")

    saved = dict(_build.LAUNCHES)
    out = {"span_off_ns": _ns_a_call(span, args.n), "launch_off_ns": _ns_a_call(launch, args.n),
           "count_ns": _ns_a_call(count, args.n)}
    tracing.enable()
    out.update(span_on_ns=_ns_a_call(span, args.n // 10),
               launch_on_ns=_ns_a_call(launch, args.n // 10))
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        out.update(span_on_profiled_ns=_ns_a_call(span, args.n // 100),
                   launch_on_profiled_ns=_ns_a_call(launch, args.n // 100))
    out["torch"] = torch.__version__
    tracing.disable()
    tracing.clear()
    _build.LAUNCHES.update(saved)
    print("COST " + json.dumps(out), flush=True)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="what", required=True)
    c = sub.add_parser("check")
    c.add_argument("--workload", required=True)
    c.add_argument("--seed", type=int, required=True)
    c.add_argument("--seconds", type=float, default=51)
    k = sub.add_parser("cost")
    k.add_argument("--n", type=int, default=200_000)
    args = parser.parse_args(argv)
    return check(args) if args.what == "check" else cost(args)


if __name__ == "__main__":
    sys.exit(main())
