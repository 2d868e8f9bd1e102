"""Run one benchmark cell once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell, its configuration, its traffic, its
driver and its per-layer readers are found by name (``benchlib/manifest.py``);
this file knows none of them. A run:

1. checks for the CUDA cards the cell asks for (none: exit 3, no result);
2. with ``--trace 1``, lets each of the cell's per-layer readers put its
   probes on the program (``install``);
3. lets the driver set up (weights and inputs from the seed, the program
   loaded and warmed up on every shape the window uses): ``setup_s`` is the
   process's age when the window opens;
4. opens the window, under ``torch.profiler`` with ``--trace 1``, and lets
   the driver run its traffic for ``--seconds``; the driver closes it at its
   boundary;
5. reads the device's peak memory, lets the driver free the program's state
   and compare what the window produced with the plain reference;
6. with ``--trace 1``, asks each per-layer reader for its number (a reader
   that finds nothing returns None and its metric is left out);
7. refuses to print if JAX or the JAX package was loaded (exit 4), and
   prints the checks on standard error and the result as the last line of
   standard output, its ``checks`` last.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import shutil
import sys
import tempfile
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
for _path in (os.path.dirname(BENCH), BENCH):  # the program's package, then the harness
    if _path not in sys.path:
        sys.path.insert(0, _path)

FORBIDDEN = ("jax", "jaxlib", "flax", "audio_separator_tpu")


def process_age() -> float:
    """Seconds since this process started (``/proc``), else since import."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def forbidden_modules(names) -> list:
    """Top-level names among ``names`` that are JAX's or the JAX package's,
    compared whole (``audio_separator_tpu_torch`` is not
    ``audio_separator_tpu``)."""
    return sorted({n.split(".", 1)[0] for n in names} & set(FORBIDDEN))


def checkout_caches(root: str) -> None:
    """Kernel and compiler caches at fixed paths inside the checkout. The
    program builds its kernels into ``build/torch_kernels`` of its own."""
    cache = os.path.join(root, "benchmark", ".cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(cache, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


class Context:
    """What a driver and the readers share for one run."""

    def __init__(self, cell, args, device, tmp):
        self.cell, self.seed, self.seconds = cell, args.seed, args.seconds
        self.trace = bool(args.trace)
        self.device, self.tmp = device, tmp
        self.metrics, self.extras, self.checks = {}, {}, []
        self.attempted = self.failed = 0
        self.state = {}
        self.window = None

    def check(self, name: str, value: float, limit: float) -> None:
        """A number compared with its limit: ``correct`` needs value <= limit."""
        self.checks.append((name, float(value), float(limit)))


def _device_info(torch, device, chips):
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def _dir_bytes(path: str) -> int:
    total = 0
    for base, _, files in os.walk(path):
        for name in files:
            try:
                total += os.path.getsize(os.path.join(base, name))
            except OSError:
                pass
    return total


def main(argv=None, allow_cpu=False, config_file=None, traffic_file=None, spec_file=None,
         root=None) -> int:
    """The command line's run. The keywords are for the CPU tests: run on the
    CPU, and a tiny configuration, traffic and cell file (with limits for
    that size) in place of the cell's."""
    parser = argparse.ArgumentParser(description="Run one benchmark cell once.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    root = root or os.path.dirname(BENCH)
    checkout_caches(root)

    import torch

    from benchlib import manifest, probes
    from benchlib.trace import Window

    man = manifest.manifest(root)
    cell = manifest.Cell(args.workload, man, root=root, config_file=config_file,
                         traffic_file=traffic_file, spec_file=spec_file)
    if torch.cuda.is_available() and torch.cuda.device_count() >= cell.chips:
        device = torch.device("cuda", 0)
    elif allow_cpu:
        device = torch.device("cpu")
    else:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell needs {cell.chips} CUDA device(s), this machine has {have}",
              file=sys.stderr)
        return 3
    base = os.environ.get("TMPDIR") or tempfile.gettempdir()
    tmp = tempfile.mkdtemp(prefix=f"bench-{args.workload}-", dir=base)
    try:
        ctx = Context(cell, args, device, tmp)
        sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else None
        readers = [(m, manifest.plugin("metrics", m["name"])) for m in cell.per_layer]
        if ctx.trace:
            for _, reader in readers:
                if hasattr(reader, "install"):
                    reader.install(ctx)
        cell.driver.setup(ctx)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        setup_s = process_age()
        window = Window(ctx.trace, sync)
        ctx.window = window
        with window:
            if ctx.trace:
                probes.ACTIVE.set()
            try:
                cell.driver.window(ctx, window)
            finally:
                probes.ACTIVE.clear()
        ctx.metrics["setup_s"] = setup_s
        device_info = _device_info(torch, device, cell.chips)
        if ctx.trace and window.summary is not None:
            device_info["busy_s"] = window.summary.busy_s
            device_info["window_s"] = window.summary.window_s
        print(f"benchmark: setup {setup_s:.3f} s, window {window.seconds:.3f} s, "
              f"{ctx.attempted} attempted, {ctx.failed} failed; "
              f"{_dir_bytes(tmp)} bytes under the run's temporary directory",
              file=sys.stderr)
        cell.driver.release(ctx)
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        cell.driver.check(ctx)
        for key, value in ctx.extras.get("notes", {}).items():
            print(f"benchmark: {key}: {value}", file=sys.stderr)

        metrics = {}
        if ctx.trace:
            for entry, reader in readers:
                value = reader.read(ctx)
                if value is not None:
                    metrics[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
        else:
            for entry in cell.end_to_end:
                if entry["name"] in ctx.metrics:
                    metrics[entry["name"]] = {"value": float(ctx.metrics[entry["name"]]),
                                              "unit": entry["unit"]}
        correct = bool(ctx.checks) and all(
            math.isfinite(v) and v <= lim for _, v, lim in ctx.checks)
        result = {"correct": correct, "attempted": ctx.attempted, "failed": ctx.failed,
                  "metrics": metrics, "device": device_info}
        if ctx.trace and window.summary is not None:
            result["breakdown"] = window.summary.breakdown()
        # A reading that is not a number (a stem missing) prints as the
        # largest float, so that the line stays JSON.
        result["checks"] = {name: {"value": v if math.isfinite(v) else sys.float_info.max,
                                   "limit": lim} for name, v, lim in ctx.checks}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    bad = forbidden_modules(list(sys.modules))
    if bad:
        print(f"benchmark: refused: {', '.join(bad)} loaded in this process", file=sys.stderr)
        return 4
    for name, v, lim in ctx.checks:
        print(f"check {name}: {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
