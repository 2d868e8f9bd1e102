#!/usr/bin/env python3
"""What the parts of the port's kernels cost, on one CUDA card.

    python3 tools/torch_kernel_ab.py
    python3 tools/torch_kernel_ab.py --parent DIR   # DIR: an older checkout to count against
    python3 tools/torch_kernel_ab.py --only tf32 gates   # some of the tables

Seven tables; the first four are device milliseconds per launch from
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
2. the float32 feed-forward block's two 3xTF32 GEMM launches
   (``csrc/gemm_tf32.cuh``) at the same shape, as built and as variants of
   the GEMM: the tensor cores' sums added into the FMA-side sums every 1, 2
   or 8 stages instead of 4, three stages (these compute
   the same function: their error against the plain version is printed), no
   split of A, one product of the three, no epilogue, no B tails (wrong
   results by design); clock and power as built and without the epilogue;
3. the attention block's norm + gates launch alone (bf16, time-axis shape),
   as built and as variants: without the gate products, without the gates'
   store, with one block per eight rows in place of persistent blocks; the
   feed-forward block's plain norm launch beside it;
4. the whole-sequence attention kernel (``csrc/attention.cu``) beside
   ``scaled_dot_product_attention`` at the HTDemucs shapes, a 128-wide head
   and the two shapes of the RoFormer block's attention launch;
5. the SM clock and power draw under each of the three calls, bf16 and
   float32, at its main-path shape;
6. the SM clock and power draw under the attention block's QKV launch alone
   (a variant of ``csrc/attention_block.cu`` that stops after it, so the call
   is the norm launch and the QKV product): bf16 with its tile epilogue,
   float32 as three TF32 products a term;
7. the static SASS instructions (``cuobjdump -sass``) of the bf16 QKV
   product's epilogue, per output element of a consumer warpgroup's tile
   (64 x 256 / 128 threads = 128): the kernel as built less the same kernel
   with the epilogue call taken out. With ``--parent DIR`` the same count for
   the ``csrc/`` in DIR (one copy of its run epilogue: the one for tiles
   wholly inside the output), so that two designs can be compared.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

EPILOGUE = ("                if (inside)\n                    epilogue(Flag<false>{});\n"
            "                else\n                    epilogue(Flag<true>{});\n")
MULTICAST = ("                    for (int p = 2 * rank; p < 2 * rank + 2; ++p)\n"
             "                        tma_load_2d_multicast(st + G_A_BYTES + p * G_PANEL_BYTES, "
             "&map_b, full + s,\n"
             "                                              col0 + 64 * p, kk * G_BK, 3);\n")
TILE_EPILOGUE = ("                epi.tile(acc, pre,\n"
                 "                         TileCtx{row0, col0, valid, wrow, quad, lane, "
                 "(int)(threadIdx.x % 128) / 32,\n"
                 "                                 wg, elected, staging + wg * STAGING_BYTES<Epi>});\n")
# The run epilogue of the bf16 GEMM before it took tile epilogues (a parent's
# tiles.cuh): the copy for tiles inside the output is kept.
PARENT_EPILOGUE = ("            if (inside)\n                epilogue(Flag<false>{});\n"
                   "            else\n                epilogue(Flag<true>{});\n")
QKV_ONLY = ("    if (err != cudaSuccess) return err;\n\n"
            "    const MergedGatedOut<T> attn_out")
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
         "                        tma_load_2d(st + G_A_BYTES + p * G_PANEL_BYTES, &map_b, full + s,\n"
         "                                    col0 + 64 * p, kk * G_BK);\n", 1),
        ("tiles.cuh", REMOTE_ARRIVE, "", 2),
        ("tiles.cuh", "cluster_sync();", "__syncthreads();", 3),
    ],
}


TF32_EPILOGUE = ("            if (inside)\n                runs.template run<false>(acc);\n"
                 "            else\n                runs.template run<true>(acc);\n")
# variants of the float32 (3xTF32) GEMM, gemm_tf32.cuh
TF32_CONSTANTS = "T_STAGES = 4, T_CLUSTER = 2, T_CHAIN = 4;"
TF32_VARIANTS = {
    "as built": [],
    "chain 1": [("gemm_tf32.cuh", TF32_CONSTANTS, "T_STAGES = 4, T_CLUSTER = 2, T_CHAIN = 1;", 1)],
    "chain 2": [("gemm_tf32.cuh", TF32_CONSTANTS, "T_STAGES = 4, T_CLUSTER = 2, T_CHAIN = 2;", 1)],
    "chain 8": [("gemm_tf32.cuh", TF32_CONSTANTS, "T_STAGES = 4, T_CLUSTER = 2, T_CHAIN = 8;", 1)],
    "3 stages": [("gemm_tf32.cuh", TF32_CONSTANTS, "T_STAGES = 3, T_CLUSTER = 2, T_CHAIN = 4;", 1)],
    "no split": [("gemm_tf32.cuh", "u < T_A_BYTES / 16; u += T_SPLITTERS", "u < 0; u += T_SPLITTERS",
                  1)],
    "one product": [("gemm_tf32.cuh",
                     "                        wgmma_tf32_n128(part, da, desc_k_major(b_lo + k8 * 32), 1);\n"
                     "                        wgmma_tf32_n128(part, desc_k_major(a_lo + k8 * 32), db, 1);\n",
                     "", 1)],
    "no epilogue": [("gemm_tf32.cuh", TF32_EPILOGUE, "", 1)],
    "no B tails": [("gemm_tf32.cuh", "T_STAGE_TX = T_A_BYTES + 2 * T_B_BYTES;",
                    "T_STAGE_TX = T_A_BYTES + T_B_BYTES;", 1),
                   ("gemm_tf32.cuh",
                    "                    tma_load_2d_multicast(b + T_B_BYTES, &map_b_lo, full + s, "
                    "kk * T_BK, col0,\n                                          T_ALL);\n", "", 1)],
}
# the variants that compute what "as built" does
TF32_SAME = ("as built", "chain 1", "chain 2", "chain 8", "3 stages")


# variants of the attention block's norm + gates launch (tiles.cuh), the
# block cut after that launch
NORM_ONLY = ("                                        n_pad, stream);\n"
             "    if (err != cudaSuccess) return err;\n\n    if constexpr (sizeof(T) == 2) {")
GATES_VARIANTS = {
    "as built": [],
    "no gate work": [("tiles.cuh", "            for (int h = 0; h < H; ++h) {\n                float w[4];",
                      "            for (int h = 0; h < 0; ++h) {\n                float w[4];", 1)],
    "no gates store": [("tiles.cuh",
                        "                gates[((size_t)(row / n_pad) * heads + h) * n_pad + row % n_pad] =\n"
                        "                    1.f / (1.f + expf(-s));",
                        "                if (s == 12345.f) gates[0] = s;", 1)],
    "one-shot grid": [("tiles.cuh", "    const int blocks = min((rows + rows_a_block - 1) / rows_a_block, "
                       "max(per_sm, 1) * sm_count());",
                       "    const int blocks = (rows + rows_a_block - 1) / rows_a_block;", 1)],
}


def build_variant(name, edits, build_flags, nvcc, source="ff_block.cu", csrc=None):
    """Copy csrc/ (or ``csrc``), apply the edits, start nvcc for ``source``."""
    from audio_separator_tpu_torch.ops import _build

    tag = name.replace(" ", "_")
    src = os.path.join(REPO, "build", "kernel_ab", tag)
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(csrc or _build.CSRC_DIR, src)
    for fn, old, new, count in edits:
        path = os.path.join(src, fn)
        with open(path, encoding="utf-8") as f:
            text = f.read()
        if text.count(old) != count:
            raise SystemExit(f"variant {name!r}: {fn} has {text.count(old)} matches of "
                             f"{old[:60]!r}, expected {count}: the sources have moved on")
        with open(path, "w", encoding="utf-8") as f:
            f.write(text.replace(old, new))
    lib = os.path.join(src, source.replace(".cu", ".so"))
    proc = subprocess.Popen([nvcc, *build_flags, "-o", lib, os.path.join(src, source)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, lib


def finish(name, started):
    proc, lib = started
    report, _ = proc.communicate()
    if proc.returncode:
        raise SystemExit(f"variant {name!r} did not build:\n{report[-3000:]}")
    return lib


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
    for name, started_variant in started.items():
        lib = ctypes.CDLL(finish(name, started_variant))
        lib.asep_ff_block.argtypes = [integer] + [pointer] * 9 + [integer] * 4 + [pointer]

        def call():
            rc = lib.asep_ff_block(1, x.data_ptr(), *(w.data_ptr() for w in weights),
                                   xn.data_ptr(), h.data_ptr(), out.data_ptr(), rows, d, hidden,
                                   0, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"variant {name!r}: CUDA error {rc}")

        split = device_ms(call)
        print(f"  {name:12s} " + ", ".join(f"{k} {v:.3f}" for k, v in split.items()), flush=True)
        if name in ("as built", "no epilogue"):
            print(f"  {name:12s} SM MHz, W under load: {clocks_under_load(call)}", flush=True)
    w1 = weights[1]
    print("  one library product (x @ W1), SM MHz, W under load: "
          f"{clocks_under_load(lambda: torch.matmul(x, w1))}", flush=True)


def tf32_table():
    """The float32 feed-forward block's two 3xTF32 GEMM launches at the
    flagship time-axis shape, as built and as variants of gemm_tf32.cuh."""
    import torch

    from audio_separator_tpu_torch.ops import _build
    from audio_separator_tpu_torch.ops import attention_block as ab
    from audio_separator_tpu_torch.ops.tf32 import prepare_tf32_weight

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in float32
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    nvcc = _build.find_nvcc()
    started = {name: build_variant(f"tf32 {name}", edits, flags, nvcc)
               for name, edits in TF32_VARIANTS.items()}
    dev = torch.device("cuda")
    d, hidden, rows = 512, 2048, 248 * 832
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(rows, d, generator=g, device=dev)
    norm = 1 + 0.1 * torch.randn(d, generator=g, device=dev)
    w1, w2 = (torch.randn(*s, generator=g, device=dev) * 0.05 for s in ((d, hidden), (hidden, d)))
    b1, b2 = (torch.randn(n, generator=g, device=dev) * 0.05 for n in (hidden, d))
    weights = [norm, prepare_tf32_weight(w1), b1, prepare_tf32_weight(w2), b2]
    xn, out = torch.empty_like(x), torch.empty_like(x)
    h = torch.empty(rows, hidden, device=dev)
    pointer, integer = ctypes.c_void_p, ctypes.c_int
    print(f"feed-forward block, float32 (3xTF32), x {tuple(x.shape)}, hidden {hidden}: "
          "device ms per launch; max |out - plain| / max |plain|")
    reference = ab.fused_ff_block_ref(x.view(1, rows, d), norm, w1, b1, w2, b2).view(rows, d)
    scale = float(reference.abs().max())
    for name, started_variant in started.items():
        lib = ctypes.CDLL(finish(name, started_variant))
        lib.asep_ff_block.argtypes = [integer] + [pointer] * 9 + [integer] * 4 + [pointer]

        def call():
            rc = lib.asep_ff_block(0, x.data_ptr(), *(w.data_ptr() for w in weights),
                                   xn.data_ptr(), h.data_ptr(), out.data_ptr(), rows, d, hidden,
                                   0, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"variant {name!r}: CUDA error {rc}")

        call()
        torch.cuda.synchronize()
        err = (f"{float((out - reference).abs().max()) / scale:.3e}" if name in TF32_SAME
               else "wrong by design")
        split = device_ms(call)
        print(f"  {name:12s} " + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
              + f"; {err}", flush=True)
        if name in ("as built", "no epilogue"):
            print(f"  {name:12s} SM MHz, W under load: {clocks_under_load(call, batch=20)}",
                  flush=True)


def gates_table():
    """The attention block's norm + gates launch alone (bf16, time-axis
    shape), as built and as variants, beside the plain norm launch of the
    feed-forward block."""
    import torch

    from audio_separator_tpu_torch.ops import _build
    from audio_separator_tpu_torch.ops import attention as att
    from audio_separator_tpu_torch.ops import attention_block as ab

    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    nvcc = _build.find_nvcc()
    started = {name: build_variant(f"gates {name}", [("attention_block.cu", NORM_ONLY,
                                                       "                                        "
                                                       "n_pad, stream);\n    return err;\n"
                                                       "    if constexpr (sizeof(T) == 2) {", 1)]
                                   + edits, flags, nvcc, source="attention_block.cu")
               for name, edits in GATES_VARIANTS.items()}
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    b, n_pad, d, heads, hidden = 248, 832, 512, 8, 2048

    def randn(*shape, s=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * s).to(torch.bfloat16)

    x = randn(b, n_pad, d)
    wqkv, gate_w, gate_b, norm = randn(d, 3 * heads * 64), randn(d, heads, s=0.05), \
        randn(heads, s=0.05), randn(d)
    xn, gates = torch.empty_like(x), torch.empty(b, heads, n_pad, device=dev)
    print("norm + gates launch alone, bf16, x (248, 832, 512), 8 heads: device ms")
    for name, started_variant in started.items():
        lib = ctypes.CDLL(finish(name, started_variant))
        lib.asep_attention_block.argtypes = _build._SIGNATURES["attention_block"][1]

        def call():
            rc = lib.asep_attention_block(
                1, x.data_ptr(), wqkv.data_ptr(), gate_w.data_ptr(), gate_b.data_ptr(),
                wqkv.data_ptr(), norm.data_ptr(), None, None, xn.data_ptr(), xn.data_ptr(),
                xn.data_ptr(), xn.data_ptr(), gates.data_ptr(), xn.data_ptr(), xn.data_ptr(), b,
                n_pad, d, heads, 801, 0, att.FLASH_ROUTES.index(att.flash_route(torch.bfloat16, n_pad, 64)),
                torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"variant {name!r}: CUDA error {rc}")

        split = device_ms(call)
        print(f"  {name:14s} " + ", ".join(f"{k} {v:.4f}" for k, v in split.items()), flush=True)
    ff = [norm, randn(d, hidden, s=0.05), randn(hidden, s=0.05), randn(hidden, d, s=0.05),
          randn(d, s=0.05)]
    split = device_ms(lambda: ab.fused_ff_block(x, *ff))
    print("  the feed-forward block's plain norm: "
          + ", ".join(f"{k} {v:.4f}" for k, v in split.items() if "rmsnorm" in k), flush=True)


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
    from audio_separator_tpu_torch.ops.tf32 import prepare_tf32_weight

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
        # float32: the prepared 3xTF32 weight forms, made once as the model does.
        forms = ((prepare_tf32_weight(block[0]), prepare_tf32_weight(block[3])),
                 (prepare_tf32_weight(ff[1]), prepare_tf32_weight(ff[3]))
                 ) if dtype == torch.float32 else (None, None)
        calls = {
            "fused_attention_block": lambda: ab.fused_attention_block(
                x, *block, rope, heads, n_valid, tf32_weights=forms[0]),
            "fused_ff_block": lambda: ab.fused_ff_block(x, *ff, tf32_weights=forms[1]),
            "fused_attention (4, 8, 2688, 64)": lambda: att.fused_attention(q, k, v, 0.125),
        }
        for what, fn in calls.items():
            fn()
            print(f"  {name:8s} {what}: {clocks_under_load(fn, batch=40)}", flush=True)
        del x, block, ff, q, k, v, forms
        torch.cuda.empty_cache()


def qkv_power_table():
    """Clock and power while the attention block's norm and QKV launches run
    back to back (a variant that returns after the QKV product)."""
    import torch

    from audio_separator_tpu_torch.ops import _build
    from audio_separator_tpu_torch.ops import attention as att
    from audio_separator_tpu_torch.ops.tf32 import prepare_tf32_weight

    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    lib = ctypes.CDLL(finish("qkv only", build_variant(
        "qkv only", [("attention_block.cu", QKV_ONLY,
                      "    return err;\n    const MergedGatedOut<T> attn_out", 1)],
        flags, _build.find_nvcc(), source="attention_block.cu")))
    lib.asep_attention_block.argtypes = _build._SIGNATURES["attention_block"][1]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    b, n_pad, d, heads = 248, 832, 512, 8
    print("SM MHz, W under load: norm + QKV launches alone, time-axis shape")
    for dtype in (torch.bfloat16, torch.float32):
        def randn(*shape, s=1.0):
            return (torch.randn(*shape, generator=g, device=dev) * s).to(dtype)

        x = randn(b, n_pad, d)
        wqkv, wo = randn(d, 3 * heads * 64, s=0.05), randn(heads * 64, d, s=0.05)
        if dtype == torch.float32:
            wqkv, wo = prepare_tf32_weight(wqkv), prepare_tf32_weight(wo)
        gate_w, gate_b, norm = randn(d, heads, s=0.05), randn(heads, s=0.05), randn(d)
        angle = torch.rand(n_pad, 64, generator=g, device=dev) * 6.28
        cos, sin = torch.cos(angle).to(dtype), torch.sin(angle).to(dtype)
        xn = torch.empty_like(x)
        q, k, v = (torch.empty(b, heads, n_pad, 64, dtype=dtype, device=dev) for _ in range(3))
        gates = torch.empty(b, heads, n_pad, device=dev)
        merged, out = torch.empty_like(x), torch.empty_like(x)

        def call():
            rc = lib.asep_attention_block(
                _build.DTYPE_CODES[dtype], x.data_ptr(), wqkv.data_ptr(), gate_w.data_ptr(),
                gate_b.data_ptr(), wo.data_ptr(), norm.data_ptr(), cos.data_ptr(),
                sin.data_ptr(), xn.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                gates.data_ptr(), merged.data_ptr(), out.data_ptr(), b, n_pad, d, heads, 801,
                0, att.FLASH_ROUTES.index(att.flash_route(dtype, n_pad, 64)),
                torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"qkv only: CUDA error {rc}")

        split = device_ms(call)
        print(f"  {str(dtype).split('.')[-1]:8s} " + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
              + f"; SM MHz, W: {clocks_under_load(call, batch=40)}", flush=True)
        del x, xn, q, k, v, merged, out
        torch.cuda.empty_cache()


def sass_instructions(lib, must_contain):
    """Static SASS instruction count of the one kernel in ``lib`` whose
    mangled name contains every string of ``must_contain``."""
    from audio_separator_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = 0
        elif name and line.strip().startswith("/*") and "*/" in line and ";" in line:
            counts[name] += 1
    found = {n: c for n, c in counts.items() if all(m in n for m in must_contain)}
    if len(found) != 1:
        raise SystemExit(f"{len(found)} kernels match {must_contain} in {lib}")
    return next(iter(found.values()))


def sass_table(parent):
    from audio_separator_tpu_torch.ops import _build

    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    nvcc = _build.find_nvcc()
    elements = 64 * 256 // 128
    designs = {"this tree": (None, ("gemm_wgmma_kernel", "QkvTileEpi"),
                             [("tiles.cuh", TILE_EPILOGUE, "", 1)], [])}
    if parent:
        designs["parent"] = (os.path.join(parent, "audio_separator_tpu_torch", "csrc"),
                             ("gemm_wgmma_kernel", "QkvEpi"),
                             [("tiles.cuh", PARENT_EPILOGUE, "", 1)],
                             [("tiles.cuh", PARENT_EPILOGUE, "            epilogue(Flag<false>{});\n", 1)])
    print("bf16 QKV product: static SASS instructions of its epilogue per output element "
          f"of a warpgroup's tile ({elements} a thread)")
    for label, (csrc, names, none, one_copy) in designs.items():
        started = {tag: build_variant(f"sass {label} {tag}", edits, flags, nvcc,
                                      source="attention_block.cu", csrc=csrc)
                   for tag, edits in (("as built", one_copy), ("no epilogue", none))}
        n = {tag: sass_instructions(finish(tag, st), names) for tag, st in started.items()}
        print(f"  {label}: kernel {n['as built']}, without the epilogue {n['no epilogue']}: "
              f"{(n['as built'] - n['no epilogue']) / elements:.1f} an element", flush=True)


def main() -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", help="root of an older checkout whose bf16 QKV epilogue "
                                         "is counted beside this tree's")
    parser.add_argument("--only", nargs="*", default=None,
                        choices=["ff", "tf32", "gates", "attention", "power", "qkv_power",
                                 "sass"])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    tables = {"ff": ff_table, "tf32": tf32_table, "gates": gates_table,
              "attention": attention_table, "power": power_table,
              "qkv_power": qkv_power_table, "sass": lambda: sass_table(args.parent)}
    for name, table in tables.items():
        if args.only is None or name in args.only:
            table()
    return 0


if __name__ == "__main__":
    sys.exit(main())
