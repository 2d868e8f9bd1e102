#!/usr/bin/env python3
"""The attention backward (K1, ``csrc/attention_bwd.cu`` and its bf16 form
``csrc/attention_bwd_bf16.cuh``) at the shapes of the training path, on one
CUDA card, beside its plain version and ``scaled_dot_product_attention``'s
backward in the same type (a yardstick the port never calls).

    python3 tools/torch_k1_bench.py                # this checkout
    python3 tools/torch_k1_bench.py --root DIR     # DIR's package against this one, in turns

Shapes: the flagship BS-RoFormer's attention block (gated merged heads) on
the time axis (124, 8, 832, 64) with 801 valid keys and the frequency axis
(1602, 8, 64, 64) with 62, in bf16 (the bf16 training step's) and float32,
and HTDemucs's whole-sequence attention at (2, 8, 1344, 64) and (2, 8, 2688,
64), float32. With ``--root`` both packages are loaded into this process
(the other one under another module name, its kernels built into its own
``build/``) and timed on the same inputs in turns (other, this, this,
other). Prints the card's name and power limit, the ptxas report of the
backward kernels, then one JSON object a shape: CUDA-event milliseconds a
call (each turn the median of five runs of five calls; the mean of the
turns), the plain version's and the yardstick's, the bound (bf16: five N²·D products over 989 TFLOP/s or the
bytes over 3.35 TB/s; float32: the same over 494.7 / 3 TFLOP/s for 3xTF32,
and over 67 for the FMA pipe), the largest error of each output against the
plain version over its scale, whether two calls gave the same bits, and
each kernel's device time a call (torch.profiler).
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# axis -> (shape, n_valid, dtype name, gated)
SHAPES = {"time bf16": ((124, 8, 832, 64), 801, "bfloat16", True),
          "freq bf16": ((1602, 8, 64, 64), 62, "bfloat16", True),
          "time": ((124, 8, 832, 64), 801, "float32", True),
          "freq": ((1602, 8, 64, 64), 62, "float32", True),
          "htdemucs time": ((2, 8, 1344, 64), None, "float32", False),
          "htdemucs freq": ((2, 8, 2688, 64), None, "float32", False)}
PEAK_BF16, PEAK_3XTF32, PEAK_FMA, PEAK_BYTES = 989e12, 494.7e12 / 3, 67e12, 3.35e12


def event_ms(fn, calls=5, runs=5):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def kernel_ms(fn, calls=5):
    """Device milliseconds a call of each backward kernel that fn launches,
    from torch.profiler (CUPTI)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if "_bwd_" in e.key and us:
            split[e.key.split("(")[0]] = us / calls / 1e3
    return split


def load_package(root: str, alias: str):
    """``(ops.attention, ops._build)`` of the port package under ``root``,
    imported as ``alias``."""
    init = os.path.join(root, "audio_separator_tpu_torch", "__init__.py")
    spec = importlib.util.spec_from_file_location(
        alias, init, submodule_search_locations=[os.path.dirname(init)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[alias] = module
    spec.loader.exec_module(module)
    return (importlib.import_module(f"{alias}.ops.attention"),
            importlib.import_module(f"{alias}.ops._build"))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=None,
                        help="another checkout whose package to time against this one")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_k1_bench: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    impls = {"this": load_package(REPO, "k1_this")}
    if args.root:
        impls = {"other": load_package(os.path.abspath(args.root), "k1_other"), **impls}
    att = impls["this"][0]
    for name, (_, build) in impls.items():
        for line in build.build_kernels()["attention_bwd"].splitlines():
            if any(k in line for k in ("Compiling entry", "registers", "spill", "C75")):
                print(f"[ptxas {name}] {line.strip()}", flush=True)
    order = ["other", "this", "this", "other"] if args.root else ["this"]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    for axis, ((b, h, n, dh), n_valid, dtype_name, gated) in SHAPES.items():
        dt = getattr(torch, dtype_name)
        nv = n_valid or n

        def randn(*shape, s=1.0, dtype=dt):
            return (torch.randn(*shape, generator=g, device=dev) * s).to(dtype)

        q, k, v = (randn(b, h, n, dh) for _ in range(3))
        if gated:
            gates = torch.sigmoid(randn(b, h, n, dtype=torch.float32))
            o, do = randn(b, n, h * dh), randn(b, n, h * dh)
            scale = 0.125
        else:
            q, k, v = q * 0.7, k * 0.7, v * 0.7
            gates, do, scale = None, randn(b, h, n, dh, s=0.7), dh ** -0.5
            o = att.attention_ref(q, k, v, scale)

        def call(impl):
            return lambda: impl[0].attention_backward(q, k, v, o, do, scale, n_valid,
                                                      gates=gates)

        def plain():
            return att.attention_bwd_ref(q, k, v, o, do, scale, n_valid, gates=gates)

        want = plain()
        errs, repeat = {}, {}
        for name, impl in impls.items():
            got, again = call(impl)(), call(impl)()
            errs[name] = [float((a.float() - w.float()).abs().max())
                          / max(float(w.float().abs().max()), 1e-30) for a, w in zip(got, want)]
            repeat[name] = all(torch.equal(a, a2) for a, a2 in zip(got, again))
            del got, again
        del want
        torch.cuda.empty_cache()
        times = {name: [] for name in impls}
        for name in order:
            times[name].append(event_ms(call(impls[name])))
        split = {name: kernel_ms(call(impl)) for name, impl in impls.items()}
        plain_ms = event_ms(plain, calls=2, runs=3)
        qs = [randn(b, h, n, dh).requires_grad_(True) for _ in range(3)]
        out, dout = F.scaled_dot_product_attention(*qs), randn(b, h, n, dh)
        sdpa_ms = event_ms(lambda: torch.autograd.grad(out, qs, dout, retain_graph=True))
        del qs, out, dout
        flop = 10.0 * b * h * nv * nv * dh  # five N²·D products
        row = {"axis": axis, "dtype": dtype_name, "shape": [b, h, n, dh], "n_valid": nv,
               "ms": {name: statistics.mean(t) for name, t in times.items()},
               "ms_runs": times, "kernels_ms": split, "plain_ms": plain_ms,
               "sdpa_backward_ms": sdpa_ms, "rel_errs": errs, "repeat_bit_identical": repeat,
               "card": smi, "other_root": os.path.abspath(args.root) if args.root else None}
        if dt == torch.bfloat16:
            # q, k, v, merged, d_merged read and dq, dk, dv written as bf16;
            # the gates read and Δ written as float32.
            nbytes = 2.0 * 8 * b * h * n * dh + 4.0 * 2 * b * h * n
            row["bound_ms"] = max(flop / PEAK_BF16, nbytes / PEAK_BYTES) * 1e3
            row["bound_by"] = "operations" if flop / PEAK_BF16 > nbytes / PEAK_BYTES else "bytes"
        else:
            nbytes = 4.0 * (8 * b * h * n * dh + 2 * b * h * n)
            row["bound_3xtf32_ms"] = max(flop / PEAK_3XTF32, nbytes / PEAK_BYTES) * 1e3
            row["bound_fma_ms"] = max(flop / PEAK_FMA, nbytes / PEAK_BYTES) * 1e3
        print(json.dumps(row), flush=True)
        del q, k, v, o, do, gates
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
