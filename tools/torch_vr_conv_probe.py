#!/usr/bin/env python3
"""Which convolutions of the full-width VR nets cost what, on one CUDA card.

    python3 tools/torch_vr_conv_probe.py [--seed N] [--top K] [--only nets|shapes]

Builds the two full-width VR nets of ``chip_smoke.py``'s ``[vr]`` phase
(v5.1 ``CascadedNet`` nout 64 / nout_lstm 128 over ``4band_v4_ms_fullband``,
and the v5 sp ``CascadedASPPNet`` at arch 33966 over ``4band_44100``, seeded
weights) and runs one forward of 4 windows of 512 frames, float32, under
four settings: cuDNN's heuristics (``cudnn.benchmark`` off), its
autotuner (``cudnn.benchmark`` on), the heuristics on channels-last tensors,
and every convolution with cuDNN off, PyTorch's own, which is what the port
runs in float32 (``models/vr_nets.Conv2d``; the LSTMs keep cuDNN). For each it prints the warm forward time (CUDA
events), the peak device memory, the SDR against the first setting, and the
convolution calls that take the most device time (torch.profiler, grouped by
input shape, with the kernels each launched: cuDNN's FFT algorithms show as
``fft`` and ``cf32`` kernels).

``shapes``: the slowest of those convolutions alone, and two ordinary ones,
float32, timed (first call and warm, CUDA events) under cuDNN's heuristics,
its autotuner trying its 10 best-ranked algorithms (PyTorch's default
``benchmark_limit``) or all of them, with cuDNN off (PyTorch's own
convolution), and as the sum of the nine 1×1 convolutions of the kernel's
taps over shifted inputs; each with its largest difference from the
heuristics' result.
"""

from __future__ import annotations

import argparse
import functools
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


# The innermost convolution ops: cuDNN's, and PyTorch's own for plain,
# dilated and depthwise kernels.
CONV_OPS = ("aten::cudnn_convolution", "aten::_slow_conv2d_forward",
            "aten::slow_conv_dilated2d", "aten::_conv_depthwise2d")


def conv_table(fn, top):
    """Device ms of each convolution call (by input shapes) and the device
    kernels under it, for one call of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    rows = {}
    for e in prof.events():
        if e.name not in CONV_OPS:
            continue
        key = str(e.input_shapes[:2])
        kernels = {k.name.split("(")[0].replace("void ", "")[:60] for k in e.kernels}
        ms = sum(k.duration for k in e.kernels) / 1e3 if e.kernels else e.device_time_total / 1e3
        row = rows.setdefault(key, [0.0, 0, set()])
        row[0] += ms
        row[1] += 1
        row[2] |= kernels
    total = sum(r[0] for r in rows.values())
    lines = [f"    convolution device ms in all {total:.1f}"]
    for key, (ms, n, kernels) in sorted(rows.items(), key=lambda kv: -kv[1][0])[:top]:
        lines.append(f"    {ms:8.2f} ms x{n:<3d} {key}  {sorted(kernels)[:3]}")
    return lines


# (input shape, output channels): the two convolutions the v5.1 and v5 nets
# spend most in under the heuristics, then two they run fast.
PROBE_SHAPES = [((4, 320, 112, 128), 128), ((4, 384, 192, 128), 128),
                ((4, 193, 896, 512), 64), ((4, 512, 56, 32), 512)]


def conv_by_taps(x, w):
    """A 3×3 convolution (stride 1, padding 1) as the sum of its nine taps'
    1×1 convolutions over shifted views of the padded input."""
    import torch.nn.functional as F

    h, wd = x.shape[2], x.shape[3]
    xp = F.pad(x, (1, 1, 1, 1))
    out = None
    for i in range(3):
        for j in range(3):
            term = F.conv2d(xp[:, :, i: i + h, j: j + wd], w[:, :, i: i + 1, j: j + 1])
            out = term if out is None else out + term
    return out


def shape_table(seed):
    import contextlib

    import torch
    import torch.nn.functional as F

    import chip_smoke as cs

    g = torch.Generator(device="cuda").manual_seed(seed)
    for shape, nout in PROBE_SHAPES:
        x = torch.randn(*shape, generator=g, device="cuda")
        w = torch.randn(nout, shape[1], 3, 3, generator=g, device="cuda") / (9 * shape[1]) ** 0.5
        ref = F.conv2d(x, w, padding=1)
        modes = {"heuristics": (False, 10, True, lambda: F.conv2d(x, w, padding=1)),
                 "benchmark, 10 tried": (True, 10, True, lambda: F.conv2d(x, w, padding=1)),
                 "benchmark, all tried": (True, 0, True, lambda: F.conv2d(x, w, padding=1)),
                 "cuDNN off": (False, 10, False, lambda: F.conv2d(x, w, padding=1)),
                 "nine 1x1 taps": (False, 10, True, lambda: conv_by_taps(x, w))}
        flop = 2 * shape[0] * shape[2] * shape[3] * nout * shape[1] * 9
        for name, (bench, limit, enabled, fn) in modes.items():
            torch.backends.cudnn.benchmark = bench
            torch.backends.cudnn.benchmark_limit = limit
            with (contextlib.nullcontext() if enabled
                  else torch.backends.cudnn.flags(enabled=False)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                first = time.perf_counter() - t0
                ms = cs.cuda_time_ms(fn, iters=3)
            err = float((out - ref).abs().max() / ref.abs().max())
            print(f"[conv {shape} -> {nout}] {name}: first call {first * 1e3:.1f} ms, warm "
                  f"{ms:.2f} ms ({flop / ms / 1e9:.1f} TFLOP/s), max |diff| {err:.2e} of the "
                  f"scale", flush=True)
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.benchmark_limit = 10


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--top", type=int, default=8)
    parser.add_argument("--only", choices=("nets", "shapes"))
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_vr_conv_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from audio_separator_tpu_torch.models.vr_nets import load_vr_net

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    if args.only != "nets":
        shape_table(args.seed)
    if args.only == "shapes":
        return 0
    rng = np.random.default_rng(args.seed)
    for label, v51, bins, arch, offset in (("v5.1 nout 64", True, 896, 218409, 64),
                                           ("v5 sp 33966", False, 768, 33966, 128)):
        sd = {k: v.numpy() for k, v in cs.vr_state_dict(args.seed, v51).items()}
        x = torch.from_numpy(np.abs(rng.standard_normal((4, 2, bins + 1, 512)))
                             .astype(np.float32) / 4).cuda()
        ref = None
        for mode in ("heuristics", "benchmark", "channels_last", "convolutions without cuDNN"):
            torch.backends.cudnn.benchmark = mode == "benchmark"
            net = load_vr_net(sd, 2 * bins, arch, v51, offset, device="cuda")
            if mode != "convolutions without cuDNN":  # the port's own choice otherwise
                for m in net.modules():
                    if isinstance(m, torch.nn.Conv2d):
                        m.forward = functools.partial(torch.nn.Conv2d.forward, m)
            xin = x
            if mode == "channels_last":
                net = net.to(memory_format=torch.channels_last)
                xin = x.contiguous(memory_format=torch.channels_last)
            with torch.no_grad():
                t0 = time.perf_counter()
                out = net(xin)
                torch.cuda.synchronize()
                first = time.perf_counter() - t0
                torch.cuda.reset_peak_memory_stats()
                ms = cs.cuda_time_ms(lambda: net(xin), iters=3)
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                ref = out if ref is None else ref
                sdr = cs.sdr_db(ref.cpu(), out.cpu())
                print(f"[{label}] {mode}: first call {first:.2f} s, warm forward {ms:.1f} ms "
                      f"for 4 windows, peak {peak:.2f} GiB, SDR vs heuristics {sdr:.2f} dB",
                      flush=True)
                for line in conv_table(lambda: net(xin), args.top):
                    print(line, flush=True)
            del net
            torch.cuda.empty_cache()
    torch.backends.cudnn.benchmark = False
    return 0


if __name__ == "__main__":
    sys.exit(main())
