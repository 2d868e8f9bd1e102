#!/usr/bin/env python3
"""What the parts of the port's bf16 kernels cost, on one CUDA card.

    python3 tools/torch_kernel_ab.py

Three tables; the first two are device milliseconds per launch from
torch.profiler (so neither the Python wrappers nor the launch gaps count):

1. the feed-forward block's launches (``csrc/ff_block.cu``) at the flagship
   time-axis shape, as built, and as variants with one part taken out: the
   whole epilogue, the GELU's erf, its two special-function instructions,
   the shuffles that give a lane eight consecutive columns, the stores, the
   cluster multicast of the weights, or with the turn handed to the other
   warpgroup before the last products have finished; and the SM clock and
   the power draw that ``nvidia-smi`` reads while the launches run back to
   back, as built and without the epilogue.
   A variant is a copy of ``csrc/`` under ``build/`` with a few lines
   replaced; every replacement must match exactly once, so the script fails
   loudly when the sources have moved on. The variants compute wrong
   results: only their times mean anything;
2. the whole-sequence attention kernel (``csrc/attention.cu``) beside
   ``scaled_dot_product_attention`` at the HTDemucs shapes, a 128-wide head
   and the two shapes of the RoFormer block's attention launch;
3. the SM clock and power draw under each of the three calls, bf16 and
   float32, at its main-path shape.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

EPILOGUE = ("            if (inside)\n                epilogue(Flag<false>{});\n"
            "            else\n                epilogue(Flag<true>{});\n")
MULTICAST = ("                    for (int p = 2 * rank; p < 2 * rank + 2; ++p)\n"
             "                        tma_load_2d_multicast(st + G_A_BYTES + p * G_PANEL_BYTES, "
             "bmap, full + s,\n"
             "                                              col0 + 64 * p, kk * G_BK, 3);\n")
REMOTE_ARRIVE = "mbar_arrive_cluster(empty + (it - 1) % G_STAGES, rank ^ 1);"

# variant -> [(file, old, new, occurrences)]
VARIANTS = {
    "as built": [],
    "no epilogue": [("tiles.cuh", EPILOGUE, "", 1)],
    "no erf": [("ff_block.cu", "        const float t = rcp(", "        return y;\n"
                "        const float t = rcp(", 1)],
    "no shuffles": [("tiles.cuh", "    return make_float2(__shfl_xor_sync(0xffffffffu, v.x, mask),",
                     "    return make_float2(v.y + mask, v.x);\n"
                     "    return make_float2(__shfl_xor_sync(0xffffffffu, v.x, mask),", 1)],
    "no stores": [("ff_block.cu", "        store8(h + (size_t)grow * cols + gcol0, g);",
                   "        if (g[0] + g[1] + g[2] + g[3] == 12345.f) "
                   "store8(h + (size_t)grow * cols + gcol0, g);", 1)],
    "no mufu": [("ff_block.cu", "        const float t = rcp(fmaf(", "        const float t = (2.f - fmaf(", 1),
                ("ff_block.cu", "p * t * ex2(y * y * (-0.5f * LOG2E));",
                 "p * t * fmaf(y * y, -0.5f * LOG2E, 1.f);", 1)],
    "early turn": [("tiles.cuh", "                mbar_arrive(turn + (wg ^ 1));\n", "", 1),
                   ("tiles.cuh", "            const bool inside = row0 + G_WM <= M && valid >= G_BN;",
                    "            if (elected) mbar_arrive(turn + (wg ^ 1));\n"
                    "            const bool inside = row0 + G_WM <= M && valid >= G_BN;", 1)],
    "no cluster": [
        ("tiles.cuh", "__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(G_THREADS, 1)",
         "__global__ void __launch_bounds__(G_THREADS, 1)", 1),
        ("tiles.cuh", "            mbar_init(empty + s, 2);", "            mbar_init(empty + s, 1);", 1),
        ("tiles.cuh", "    const uint32_t rank = cluster_rank();",
         "    const uint32_t rank = blockIdx.x & 1;", 1),
        ("tiles.cuh", MULTICAST,
         "                    for (int p = 0; p < 4; ++p)\n"
         "                        tma_load_2d(st + G_A_BYTES + p * G_PANEL_BYTES, bmap, full + s,\n"
         "                                    col0 + 64 * p, kk * G_BK);\n", 1),
        ("tiles.cuh", REMOTE_ARRIVE, "", 2),
        ("tiles.cuh", "cluster_sync();", "__syncthreads();", 3),
    ],
}


def build_variant(name, edits, build_flags, nvcc):
    """Copy csrc/, apply the edits, start nvcc for ff_block.cu."""
    from audio_separator_tpu_torch.ops import _build

    tag = name.replace(" ", "_")
    src = os.path.join(REPO, "build", "kernel_ab", tag)
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_build.CSRC_DIR, src)
    for fn, old, new, count in edits:
        path = os.path.join(src, fn)
        with open(path, encoding="utf-8") as f:
            text = f.read()
        if text.count(old) != count:
            raise SystemExit(f"variant {name!r}: {fn} has {text.count(old)} matches of "
                             f"{old[:60]!r}, expected {count}: the sources have moved on")
        with open(path, "w", encoding="utf-8") as f:
            f.write(text.replace(old, new))
    lib = os.path.join(src, "ff_block.so")
    proc = subprocess.Popen([nvcc, *build_flags, "-o", lib, os.path.join(src, "ff_block.cu")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, lib


def device_ms(fn, calls=20):
    """Device milliseconds per kernel name for one call of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {e.key.split("(")[0].replace("void ", "").replace("asep::", ""):
             e.device_time_total / calls / 1e3
             for e in prof.key_averages() if e.device_time_total > 0}
    if split:
        return split
    # The profiler brought back no device record: the time between two CUDA
    # events around the calls, launch gaps included.
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return {"between CUDA events": start.elapsed_time(stop) / calls}


def clocks_under_load(fn, seconds=2.0, batch=100):
    """SM clock (MHz) and power draw (W) as nvidia-smi reads them while ``fn``
    keeps the card busy: the last three samples of ``seconds`` of back-to-back
    launches. A kernel that draws the power limit runs at a lower clock, and
    then every instruction it issues costs time wherever it is scheduled."""
    import time

    import torch

    samples = []
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        for _ in range(batch):
            fn()
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, check=True, timeout=60).stdout
        samples.append(out.strip().splitlines()[0])
    torch.cuda.synchronize()
    return " | ".join(samples[-3:])


def ff_table():
    import torch

    from audio_separator_tpu_torch.ops import _build

    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    nvcc = _build.find_nvcc()
    started = {name: build_variant(name, edits, flags, nvcc) for name, edits in VARIANTS.items()}

    dev = torch.device("cuda")
    d, hidden, rows = 512, 2048, 248 * 832
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, s=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * s).to(torch.bfloat16)

    x = randn(rows, d)
    weights = [(1 + randn(d, s=0.1).float()).to(torch.bfloat16), randn(d, hidden, s=0.05),
               randn(hidden, s=0.05), randn(hidden, d, s=0.05), randn(d, s=0.05)]
    xn, out = torch.empty_like(x), torch.empty_like(x)
    h = torch.empty(rows, hidden, dtype=torch.bfloat16, device=dev)
    pointer, integer = ctypes.c_void_p, ctypes.c_int
    print(f"feed-forward block, bf16, x {tuple(x.shape)}, hidden {hidden}: device ms per launch")
    for name, (proc, lib_path) in started.items():
        report, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name!r} did not build:\n{report[-3000:]}")
        lib = ctypes.CDLL(lib_path)
        lib.asep_ff_block.argtypes = [integer] + [pointer] * 9 + [integer] * 3 + [pointer]

        def call():
            rc = lib.asep_ff_block(1, x.data_ptr(), *(w.data_ptr() for w in weights),
                                   xn.data_ptr(), h.data_ptr(), out.data_ptr(), rows, d, hidden,
                                   torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"variant {name!r}: CUDA error {rc}")

        split = device_ms(call)
        print(f"  {name:12s} " + ", ".join(f"{k} {v:.3f}" for k, v in split.items()), flush=True)
        if name in ("as built", "no epilogue"):
            print(f"  {name:12s} SM MHz, W under load: {clocks_under_load(call)}", flush=True)
    w1 = weights[1]
    print("  one library product (x @ W1), SM MHz, W under load: "
          f"{clocks_under_load(lambda: torch.matmul(x, w1))}", flush=True)


def attention_table():
    import torch
    import torch.nn.functional as F

    from audio_separator_tpu_torch.ops import attention as att

    dev = torch.device("cuda")
    print("whole-sequence attention, bf16: device ms per call, kernel / "
          "scaled_dot_product_attention")
    for shape in ((4, 8, 1344, 64), (4, 8, 2688, 64), (4, 4, 1344, 128), (248, 8, 832, 64),
                  (3204, 8, 64, 64)):
        g = torch.Generator(device=dev).manual_seed(0)
        q, k, v = ((torch.randn(*shape, generator=g, device=dev) * 0.7).to(torch.bfloat16)
                   for _ in range(3))
        ours = sum(device_ms(lambda: att.fused_attention(q, k, v, shape[-1] ** -0.5)).values())
        lib = sum(device_ms(lambda: F.scaled_dot_product_attention(q, k, v)).values())
        flop = 4 * shape[0] * shape[1] * shape[2] ** 2 * shape[3]
        print(f"  {shape}: {ours:.4f} ({flop / ours / 1e9:.0f} TFLOP/s) / {lib:.4f}", flush=True)


def power_table():
    """SM clock and power draw under each of the port's calls at its main-path
    shape, launched back to back."""
    import torch

    from audio_separator_tpu_torch.ops import attention as att
    from audio_separator_tpu_torch.ops import attention_block as ab

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    print("SM MHz, W under load (last three samples of two seconds of back-to-back calls)")
    for dtype in (torch.bfloat16, torch.float32):
        def randn(*shape, s=1.0):
            return (torch.randn(*shape, generator=g, device=dev) * s).to(dtype)

        b, n_pad, n_valid, d, heads, hidden = 248, 832, 801, 512, 8, 2048
        x = randn(b, n_pad, d)
        norm = (1 + randn(d, s=0.1).float()).to(dtype)
        block = [randn(d, 3 * heads * 64, s=0.05), randn(d, heads, s=0.05), randn(heads, s=0.05),
                 randn(heads * 64, d, s=0.05), norm]
        angle = torch.rand(n_pad, 64, generator=g, device=dev) * 6.28
        rope = (torch.cos(angle).to(dtype), torch.sin(angle).to(dtype))
        ff = [norm, randn(d, hidden, s=0.05), randn(hidden, s=0.05), randn(hidden, d, s=0.05),
              randn(d, s=0.05)]
        q, k, v = (randn(4, 8, 2688, 64, s=0.7) for _ in range(3))
        name = str(dtype).split(".")[-1]
        calls = {
            "fused_attention_block": lambda: ab.fused_attention_block(x, *block, rope, heads,
                                                                       n_valid),
            "fused_ff_block": lambda: ab.fused_ff_block(x, *ff),
            "fused_attention (4, 8, 2688, 64)": lambda: att.fused_attention(q, k, v, 0.125),
        }
        for what, fn in calls.items():
            fn()
            print(f"  {name:8s} {what}: {clocks_under_load(fn, batch=40)}", flush=True)
        del x, block, ff, q, k, v
        torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    ff_table()
    attention_table()
    power_table()
    return 0


if __name__ == "__main__":
    sys.exit(main())
