#!/usr/bin/env python3
"""The attention backward (K1, ``csrc/attention_bwd.cu``) at the four shapes
of the training path, on one CUDA card, beside its plain version and
``scaled_dot_product_attention``'s float32 backward (a yardstick the port
never calls).

    python3 tools/torch_k1_bench.py                # this checkout
    python3 tools/torch_k1_bench.py --root DIR     # the package of another checkout

Shapes: the flagship BS-RoFormer's attention block (gated merged heads) on
the time axis (124, 8, 832, 64) with 801 valid keys and the frequency axis
(1602, 8, 64, 64) with 62, and HTDemucs's whole-sequence attention at
(2, 8, 1344, 64) and (2, 8, 2688, 64). Prints one JSON object a shape:
CUDA-event milliseconds a call (each the median of five runs of five calls),
the bounds (operations over 165 TFLOP/s for 3xTF32 and over 67 for the FMA
pipe, bytes over 3.35 TB/s), the largest error of each output against the
plain version over its scale, and the card's name and power limit. To compare
two versions, run both in one call on one card, in turns.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

SHAPES = {"time": ((124, 8, 832, 64), 801, True), "freq": ((1602, 8, 64, 64), 62, True),
          "htdemucs time": ((2, 8, 1344, 64), None, False),
          "htdemucs freq": ((2, 8, 2688, 64), None, False)}
PEAK_3XTF32, PEAK_FMA, PEAK_BYTES = 494.7e12 / 3, 67e12, 3.35e12


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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout whose audio_separator_tpu_torch to time")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_k1_bench: no CUDA device", file=sys.stderr)
        return 2
    from audio_separator_tpu_torch.ops import _build
    from audio_separator_tpu_torch.ops import attention as att

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    report = _build.build_kernels()["attention_bwd"]
    for line in report.splitlines():
        if any(k in line for k in ("Compiling entry", "registers", "spill")):
            print(f"[ptxas] {line.strip()}")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    for axis, ((b, h, n, dh), n_valid, gated) in SHAPES.items():
        nv = n_valid or n

        def randn(*shape):
            return torch.randn(*shape, generator=g, device=dev)

        q, k, v = (randn(b, h, n, dh) for _ in range(3))
        if gated:
            gates = torch.sigmoid(randn(b, h, n))
            o, do = randn(b, n, h * dh), randn(b, n, h * dh)
        else:
            q, k, v = q * 0.7, k * 0.7, v * 0.7
            gates, do = None, randn(b, h, n, dh) * 0.7
            o = att.attention_ref(q, k, v, dh ** -0.5)
        scale = 0.125 if gated else dh ** -0.5

        def kernel():
            return att.attention_backward(q, k, v, o, do, scale, n_valid, gates=gates)

        def plain():
            return att.attention_bwd_ref(q, k, v, o, do, scale, n_valid, gates=gates)

        got, want = kernel(), plain()
        errs = [float((a - w).abs().max()) / max(float(w.abs().max()), 1e-30)
                for a, w in zip(got, want)]
        again = kernel()
        repeat = all(torch.equal(a, a2) for a, a2 in zip(got, again))
        del got, want, again
        torch.cuda.empty_cache()
        ms, plain_ms = event_ms(kernel), event_ms(plain, calls=2, runs=3)
        qs = [randn(b, h, n, dh).requires_grad_(True) for _ in range(3)]
        out, dout = F.scaled_dot_product_attention(*qs), randn(b, h, n, dh)
        sdpa_ms = event_ms(lambda: torch.autograd.grad(out, qs, dout, retain_graph=True))
        del qs, out, dout
        flop = 10.0 * b * h * nv * nv * dh  # five N²·D products
        nbytes = 4.0 * (8 * b * h * n * dh + 2 * b * h * n)
        print(json.dumps({"axis": axis, "shape": [b, h, n, dh], "n_valid": nv, "ms": ms,
                          "plain_ms": plain_ms, "sdpa_backward_ms": sdpa_ms,
                          "bound_3xtf32_ms": max(flop / PEAK_3XTF32, nbytes / PEAK_BYTES) * 1e3,
                          "bound_fma_ms": max(flop / PEAK_FMA, nbytes / PEAK_BYTES) * 1e3,
                          "rel_errs": errs, "repeat_bit_identical": repeat, "card": smi,
                          "root": os.path.abspath(args.root)}), flush=True)
        del q, k, v, o, do, gates
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
