#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (audio_separator_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed N] [--seconds S] [--phase all|remote|training|mesh]

(``--phase remote``, ``training`` or ``mesh`` builds the kernels and runs
that phase alone, and prints no result line.)

Phases, each of which must pass (any failure exits non-zero before the
result lines are printed):

1. the card: ``nvidia-smi`` name and power limit, ``torch.cuda`` device name;
2. build every kernel from ``audio_separator_tpu_torch/csrc`` with nvcc for
   sm_90a and print ptxas's register / shared-memory / spill report;
3. each kernel against its plain PyTorch version at the shapes its main path
   gives it, in float32 and bf16, with CUDA-event times for both, the bound
   (float32 RoFormer blocks: on the FMA pipe and at the 3xTF32 rate, whose
   products they run; their weights' prepared 3xTF32 forms are made once,
   timed on a line of their own, and passed to every call as the model does),
   and the torch.profiler split of one call over its launches:
   the two fused RoFormer blocks at the flagship BS-RoFormer shapes (d 512,
   8 heads x 64, FF 2048; time axis 4·62 sequences of 801 -> 832 tokens,
   frequency axis 4·801 sequences of 62 -> 64 tokens), and the whole-sequence
   attention at the full-width HTDemucs shapes ((4, 8, 1344, 64) on the time
   branch, (4, 8, 2688, 64) on the frequency branch) and one ragged small
   shape, plus a 128-wide head, with ``scaled_dot_product_attention`` timed
   beside it as a yardstick that the port never calls; one cuBLAS product of
   each bf16 GEMM shape of the two blocks is timed the same way; and the
   GroupNorm kernel at every GroupNorm shape of one HTDemucs forward (plus
   a four-group and a ragged shape), against ``group_norm_ref`` on the same
   card tensors, one launch a call, timed beside the plain version,
   ``F.group_norm`` alone and the byte bound;
4. the flagship Roformer (seeded random weights) on one 8 s window with the
   kernels, against the same module on the CPU (plain versions), float32:
   SDR floor 108.95 dB (the 3xTF32 products' condition: within 10 dB of the
   FMA products' 118.95), and 24 launches of each kernel; the full-width HTDemucs
   (seeded random weights) on one batch of 4 segments the same way: SDR floor
   40 dB per source and 6 launches of the attention kernel; the full-width
   MDX23C (TFC-TDF v3, the published ``model_2_stem_full_band_8k.yaml``
   geometry, seeded oracle weights) on one batch of 4 windows in float32 with
   the process-wide cuDNN TF32 switch left on, so that the module's
   ``full_float32`` scope is what keeps it float32, against the same module on
   the CPU at a batch of 1: SDR floor 40 dB per stem, with its warm time,
   TFLOP/s (FLOP counted by ``torch.utils.flop_counter``), peak device
   memory, and the bf16 forward beside it; the full-width MDX-Net
   ``ConvTDFNet`` (kuielab/mdx-net TFC-TDF v1 at UVR's MDX-Net width and the
   UVR-MDX-NET-Inst_HQ_3 STFT geometry, seeded weights,
   ``tests/torch_oracles/convtdf_oracle.py``), exported once to ONNX (traced
   on the card) and run through ``models/onnx_torch`` on the packed STFT of
   4 windows, float32 under ``full_float32`` with the cuDNN TF32 switch on,
   against the CPU at a batch of 1 (floor 100 dB), with the same numbers and
   the bf16 forward's SDR against float32;
5. the main paths, each with the launch counts set to 0 just before and read
   just after: a full-width synthetic BS-RoFormer checkpoint in the upstream
   key layout, ``Separator(use_autocast=True).load_model()`` then
   ``.separate()`` of a seeded stereo WAV (two finite stems of the input's
   length), then the same with the default float32 (``use_autocast=False``),
   each with one more call under torch.profiler for the card's busy time;
   then, on that float32 separator, ``separate_batch`` of a 16-bit and a
   24-bit WAV (each output >= 100 dB against its solo ``separate`` and at its
   input's bit depth), ``warmup(8)``, and the CLI (``utils/cli.main`` in a
   child process) on the card with and without ``--chunk_duration 10``; a
   full-width synthetic HTDemucs package and its YAML bag,
   ``Separator().load_model("htdemucs.yaml")`` with the default Demucs
   parameters then ``.separate()`` of the same WAV (four finite stems); the
   full-width MDX23C checkpoint under its published file names,
   ``Separator().load_model("MDX23C-8KFFT-InstVoc_HQ_2.ckpt")`` then
   ``.separate()`` in float32 and under ``use_autocast=True`` (two finite
   stems each; the device time split into convolution, norm, elementwise and
   the rest; bf16's SDR against float32 reported without a floor); the
   audio I/O route ``io/audio.py`` takes on this machine (the native codec
   where libav builds, else WAV only) and a WAV round trip at 16 and 24 bits;
   the full-width MDX graph under its registry name
   (``UVR-MDX-NET-Inst_HQ_3.onnx``, model data keyed by its hash),
   ``Separator().load_model()`` then ``.separate()`` in float32 and under
   ``use_autocast=True`` (profiled as above), one call with
   ``enable_denoise`` and one with ``invert_using_spec``, and
   ``separate_batch`` of a 16-bit and a 24-bit WAV against their solo outputs
   (>= 100 dB, each at its own depth); the path launches none of the three
   kernels, and the counts, set to 0 before it, must read 0 after it;
   then VR (``[vr]``): the full-width v5.1 ``CascadedNet`` (nout 64,
   nout_lstm 128 over ``4band_v4_ms_fullband``, seeded weights, a ≈ 219 MB
   ``.pth`` that its size keys to 218409) forward of 4 windows on the card
   against the CPU (floor 100 dB), float32 and bf16, with TFLOP/s, peak
   memory and the device time by category; ``Separator().load_model()`` then
   ``.separate()`` of the WAV in float32 and bf16 (profiled), once each with
   TTA, post-process and high end, and card against CPU on a 3 s excerpt
   (floor 100 dB); the full-width v5 sp ``CascadedASPPNet`` (arch 33966 by
   its size) over ``4band_44100`` and ``4band_44100_reverse``; and
   ``separate_batch`` of a 16-bit and a 24-bit WAV against their solo
   outputs; the path launches none of the three kernels either;
   then Demucs v3 (``[demucs_v3]``): the full-width ``HDemucs`` of the
   published ``hdemucs_mmi`` (83.6 M parameters, seeded) forward of one 40 s
   window on the card against the CPU (floor 40 dB), with its time, TFLOP/s
   and peak memory; a seeded package under the published signature
   (``75fc33f5-<sha256[:8]>.th``) and ``hdemucs_mmi.yaml``,
   ``Separator().load_model("hdemucs_mmi.yaml")`` then ``.separate()`` of a
   60 s WAV, whose every shifted pass runs a full window through the engine
   and its tails by direct calls (four finite stems, profiled), and the
   card's stems against the CPU's on the first 40 s (floor 40 dB); the path
   launches none of the three kernels; then ensembles (``[ensemble]``): the
   full-width BS-RoFormer and HTDemucs in one model directory,
   ``Separator(ensemble_algorithm=...).load_model([default, "htdemucs.yaml"])``
   then ``.separate()`` of the 30 s WAV under ``avg_wave``, ``avg_fft`` and
   ``uvr_max_spec``: five stem groups, Vocals ensembled from both members and
   held against the CPU ``Ensembler`` on the members' solo stems, the rest
   passed through (floor 60 dB), and 24, 24 and 18 launches of B1, B2 and B3
   in each call, with the warm ensemble wall beside the members' solo walls
   and beside the same call with the process's model cache emptied first,
   and each member's load with the cache empty (the RoFormer's split: read,
   convert, build, upload, 3xTF32 forms);
   then the remote service (``[remote]``): the full-width BS-RoFormer,
   HTDemucs, VR v5.1 and MDX23C in one model directory, a seeded 30 s and a 20 s float32 WAV,
   direct ``Separator`` calls of each job's file and settings on the card as
   references, the model cache emptied before them (each model's first call
   builds it and prints its load split, the next ones take it from the
   cache, as does a second built-and-loaded 30 s RoFormer call); the port's
   HTTP server (``remote/server.serve``) with one
   worker and ``AUDSEP_SERVER_COALESCE=2`` answering ``/health``,
   ``/models-json``, ``/presets``, a 404 and (with ``AUDSEP_API_KEY`` set) a
   401, and running an HTDemucs job, two float32 RoFormer jobs that must
   coalesce into one ``separate_batch`` group, and a bf16 RoFormer job, each
   submitted over HTTP (a multipart body built by hand, the standard
   library's ``urllib``), polled on ``/status`` and downloaded by hash;
   a second server with two workers and coalescing off, both TF32 switches
   on, running two HTDemucs jobs at once and then a float32 VR and a float32
   MDX23C job submitted together; cuDNN's and the matmul's switches must read
   after each round what they read before;
   one RoFormer job through the ASGI app (``remote/asgi.create_app``) driven
   in process. Every job must complete with no group retry and no failure
   logged by the server; every served stem must score >= 100 dB against its
   direct call (``utils/metrics.simple_sdr``), one ``bss_eval`` of served
   against direct stems must finish (SDR +inf only where they are
   bit-identical); the launches of B1, B2 and B3 over each server must equal
   what the engine's window plan implies (24 B1 and B2 per RoFormer forward,
   6 B3 per HTDemucs forward); each job's latency, each server's wall and
   jobs/hour and the group's wall against two solo calls are printed;
   then training (``[training]``, ``training.make_train_step``), with the
   model cache emptied first: each of
   the four backward kernels (K1 attention, K2 RMSNorm, K3 GELU, K4 RoPE
   and gate) against its plain version at the full-width shapes of batch 2,
   with CUDA-event times, bounds (K1's 3xTF32 one beside its FMA one) and,
   where one exists, a library call beside them
   (``scaled_dot_product_attention``'s backward,
   ``aten._fused_rms_norm_backward``, ``aten.gelu_backward``, which writes
   less than K3); the three autograd Functions against autograd
   through their plain versions on the card; the flagship BS-RoFormer at
   depth 2, one step's gradients against the CPU plain path (>= 80 dB each,
   or within 6 dB of the CPU's own spread where the CPU does not reproduce
   a gradient to 80 dB itself); at depth 12, 3 SGD and 3 Adam steps on
   batch 2 of 8 s windows with both TF32 switches on (the step's
   ``full_float32`` scope keeps it float32), each with its launches against
   the plan (B1 24, B2 24, K1 24, K2 48, K3 24, K4 24), the step split into
   forms remade, forward, backward and optimiser, peak memory and device
   time by category; then bf16 training (``compute_dtype=torch.bfloat16``,
   float32 master weights): the bf16 form of each backward kernel against
   its plain bf16 version at the same full-width shapes (the bf16
   tolerance), timed beside its bf16 bound and its bf16 yardstick; the
   flagship at depth 2, the card's bf16 step gradients against its float32
   step, each within 6 dB of the CPU plain bf16 step's distance to the CPU
   float32 step, and the same bf16 step with cuBLAS allowed to reduce bf16
   products in bf16 (``allow_bf16_reduced_precision_reduction``), reported
   against the switch held off; at depth 12, 3 SGD and 3 Adam bf16 steps on
   batch 2 of 8 s, each launching B1 24, B2 24 and the bf16 forms K1 24, K2
   48, K3 24, K4 24 times, with the split cast, forward + loss, backward,
   optimiser, peak memory and device time by category; the published
   HTDemucs against the CPU and 3 Adam
   steps on batch 2 (B3 6, K1 6 a step); one HDemucs step on 10 s;
   then the device mesh (``[mesh]``, ``parallel/mesh.py``) over repeated
   handles of the one card, the model cache emptied first: the partial-sum
   forms of B1 and B2 (no residual, no ``b2``: a tensor-parallel shard's
   launch) against their plain versions at the flagship's shard shapes for
   tp 2 and 4 (4 and 2 heads, 1024 and 512 hidden columns), float32 and
   bf16, timed beside their bounds; the flagship BS-RoFormer forward
   tensor-parallel at tp 2 and 4 against its tp 1 forward (float32 >= 100
   dB, bf16 reported against a 40 dB bar), each partial form launched
   exactly 24 · tp times a forward and no full form; ``Separator`` over a
   dp 2 × tp 2 mesh for the flagship and HTDemucs on the 30 s WAV (stems
   >= 100 dB against the plain call, warm walls side by side, the full
   forms launched by each row); ``Separator(use_mesh=True)`` on the one card
   taking the plain path and saying so; one flagship step at depth 2 on
   batch 2 over the dp 2 × tp 2 mesh, its gradients gathered against the
   tp 1 step's (>= 80 dB), and the same in bf16: the sharded bf16 step's
   gradients against the tp 1 float32 step's, each within 6 dB of the tp 1
   bf16 step's distance to it;
6. one JSON line describing each kernel (with its launches on the ensemble
   path, over the remote servers and over the training steps; the backward
   kernels' launches are those of the training steps, their bf16 forms'
   (``*_bf16``) those of the bf16 flagship steps; the partial forms' those
   of the float32 tensor-parallel forward at tp 2), then the last line
   ``{"ok": true, "device": {...}}``.

TF32 is off for every float32 comparison (``torch.backends.cuda.matmul`` and
``torch.backends.cudnn``), so the plain versions run in full float32; the
MDX23C forward of phase 4 turns the cuDNN switch back on for its card run.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import logging
import math
import os
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks at the 700 W limit (NVIDIA data sheet).
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # bf16 tensor cores; fp32 without
PEAK_BYTES = 3.35e12
# The RoFormer blocks' float32 products run as three TF32 products a term on
# the tensor cores: their bound beside the FMA one is the TF32 peak over three.
PEAK_3XTF32 = 494.7e12 / 3

# Kernel vs plain tolerances, relative to the reference's largest magnitude.
# float32: both sides accumulate in float32 in different orders over at most
# 2048 terms (≲ √K·2⁻²⁴ ≈ 3e-6 of the scale per output); 1e-4 leaves margin.
# bf16: both round to bf16 at the same points but in different orders, and
# the online softmax rounds unnormalised weights, so single outputs may land a
# few bf16 steps (2⁻⁸ relative) apart while the mean error stays well under one.
TOLERANCE = {"float32": {"max": 1e-4, "mean": 1e-5},
             "bfloat16": {"max": 4 * 2.0 ** -8, "mean": 2.0 ** -10}}
# The fused RoFormer blocks in float32 (3xTF32 products, each term good to
# about 2⁻²¹, float32 sums) are held to the float32 level itself.
BLOCK_TOLERANCE = {**TOLERANCE, "float32": {"max": 1e-5, "mean": 1e-6}}
SDR_FLOOR_DB = 40.0
# The float32 forward on the card, its products as 3xTF32, must stay within
# 10 dB of the 118.95 dB that the forward reached with float32 FMA products.
TF32_FORWARD_FLOOR_DB = 108.95


def log(msg: str) -> None:
    print(msg, flush=True)


def sdr_db(ref, est) -> float:
    import torch

    ref, est = torch.as_tensor(ref), torch.as_tensor(est)
    num = float((ref.double() ** 2).sum())
    den = float(((ref.double() - est.double()) ** 2).sum())
    return 10 * math.log10(num / max(den, 1e-300))


def cuda_time_ms(fn, iters: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_split(fn):
    """Device milliseconds per CUDA kernel name for one call of ``fn``, from
    torch.profiler (empty if the profiler records no device activity)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            name = e.key.replace("(anonymous namespace)::", "").split("(")[0]
            name = name.replace("void ", "").replace("asep::", "")
            split[name] = split.get(name, 0.0) + e.device_time_total / 1e3
    return split


def attention_cost(b, n_pad, n_valid, d, h, dh, elt):
    """(FLOP, bytes) one fused attention block needs for these inputs: the
    products over the valid tokens; x read and out written once, weights and
    RoPE tables read once."""
    rows = b * n_valid
    flops = (2 * rows * d * (3 * h * dh + h) + 4 * b * h * n_valid * n_valid * dh
             + 2 * rows * h * dh * d)
    nbytes = elt * (2 * b * n_pad * d + d * (3 * h * dh + h) + h + h * dh * d + d
                    + 2 * n_pad * dh)
    return flops, nbytes


def ff_cost(b, n_pad, n_valid, d, hidden, elt):
    rows = b * n_valid
    return 4 * rows * d * hidden, elt * (2 * b * n_pad * d + 2 * d * hidden + hidden + 2 * d)


def whole_attention_cost(b, h, n, d, elt):
    """(FLOP, bytes) of softmax(q·kᵀ·scale)·v: the two products; q, k, v read
    and the result written once."""
    return 4 * b * h * n * n * d, elt * 4 * b * h * n * d


def bound(cost, dtype_name):
    flops, nbytes = cost
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def compare(got, want, dtype_name, tolerance=TOLERANCE):
    diff = (got.float() - want.float()).abs()
    scale = float(want.float().abs().max())
    err = {"max_abs_err": float(diff.max()), "mean_abs_err": float(diff.mean()),
           "scale": scale}
    tol = tolerance[dtype_name]
    err["ok"] = (err["max_abs_err"] <= tol["max"] * scale
                 and err["mean_abs_err"] <= tol["mean"] * scale)
    return err


def phase_kernels(ab, seed):
    """Phase 3. Returns the per-case records."""
    import torch
    import torch.nn.functional as F

    from audio_separator_tpu_torch.models.roformer import _rope_tables
    from audio_separator_tpu_torch.ops.tf32 import prepare_tf32_weight

    dev = torch.device("cuda")
    d, h, dh, hidden = 512, 8, 64, 2048
    axes = {"time": (4 * 62, 801), "freq": (4 * 801, 62)}
    records = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        elt = torch.finfo(dtype).bits // 8
        for axis, (b, n_valid) in axes.items():
            n_pad = -(-n_valid // 64) * 64
            g = torch.Generator(device=dev).manual_seed(seed)

            def randn(*shape, s=1.0):
                return (torch.randn(*shape, generator=g, device=dev) * s).to(dtype)

            x = randn(b, n_pad, d)
            x[:, n_valid:] = 0  # the model pads tokens with zeros
            attn = dict(wqkv=randn(d, 3 * h * dh, s=0.05), gate_w=randn(d, h, s=0.05),
                        gate_b=randn(h, s=0.05), wo=randn(h * dh, d, s=0.05),
                        attn_norm=(1 + randn(d, s=0.1).float()).to(dtype))
            cos, sin = _rope_tables(n_valid, dh, dtype, dev)
            rope = (F.pad(cos, (0, 0, 0, n_pad - n_valid)), F.pad(sin, (0, 0, 0, n_pad - n_valid)))
            ff = dict(ff_norm=(1 + randn(d, s=0.1).float()).to(dtype),
                      w1=randn(d, hidden, s=0.05), b1=randn(hidden, s=0.05),
                      w2=randn(hidden, d, s=0.05), b2=randn(d, s=0.05))
            forms = {"fused_attention_block": None, "fused_ff_block": None}
            if dtype == torch.float32:
                # The prepared 3xTF32 weight forms, made once as the model
                # makes them and passed to every call.
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                forms = {"fused_attention_block": (prepare_tf32_weight(attn["wqkv"]),
                                                   prepare_tf32_weight(attn["wo"])),
                         "fused_ff_block": (prepare_tf32_weight(ff["w1"]),
                                            prepare_tf32_weight(ff["w2"]))}
                torch.cuda.synchronize()
                log(f"[kernels] one-off: the prepared 3xTF32 forms of wqkv, wo, w1, w2 "
                    f"(one layer, {sum(f.numel() for p in forms.values() for f in p) * 4 / 2**20:.1f}"
                    f" MiB) in {(time.perf_counter() - t0) * 1e3:.3f} ms")
            runs = {
                "fused_attention_block": (
                    lambda: ab.fused_attention_block(
                        x, rope=rope, heads=h, n_valid=n_valid,
                        tf32_weights=forms["fused_attention_block"], **attn),
                    lambda: ab.fused_attention_block_ref(x, rope=rope, heads=h,
                                                         n_valid=n_valid, **attn),
                    attention_cost(b, n_pad, n_valid, d, h, dh, elt)),
                "fused_ff_block": (
                    lambda: ab.fused_ff_block(x, tf32_weights=forms["fused_ff_block"], **ff),
                    lambda: ab.fused_ff_block_ref(x, **ff),
                    ff_cost(b, n_pad, n_valid, d, hidden, elt)),
            }
            for name, (kernel, plain, cost) in runs.items():
                got = kernel()
                torch.cuda.synchronize()
                want = plain()
                err = compare(got[:, :n_valid], want[:, :n_valid], dname, BLOCK_TOLERANCE)
                del got, want
                ms = cuda_time_ms(kernel, iters=5)
                plain_ms = cuda_time_ms(plain, iters=2)
                bound_ms, bound_by = bound(cost, dname)
                split = device_split(kernel)
                rec = dict(name=name, dtype=dname, axis=axis, shape=[b, n_pad, d],
                           n_valid=n_valid, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by, flop=cost[0], bytes=cost[1], split=split,
                           **err)
                extra = ""
                if dtype == torch.float32:
                    rec["bound_3xtf32_ms"] = max(cost[0] / PEAK_3XTF32,
                                                 cost[1] / PEAK_BYTES) * 1e3
                    extra = (f" (FMA pipe, 67 TFLOP/s); 3xTF32 bound "
                             f"{rec['bound_3xtf32_ms']:.3f} ms (494.7 / 3 TFLOP/s)")
                records.append(rec)
                tol = BLOCK_TOLERANCE[dname]
                log(f"[kernels] {name} {dname} {axis} x{(b, n_pad, d)} n_valid={n_valid}: "
                    f"max_abs_err={err['max_abs_err']:.3e} "
                    f"(rel {err['max_abs_err'] / err['scale']:.3e}, tol {tol['max']:.3e}) "
                    f"mean_abs_err={err['mean_abs_err']:.3e} "
                    f"(rel {err['mean_abs_err'] / err['scale']:.3e}, tol {tol['mean']:.3e}) "
                    f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
                    f"bound {bound_ms:.3f} ms ({bound_by}){extra}")
                log(f"[kernels]   launches of one call (torch.profiler, device ms): "
                    + (", ".join(f"{k} {v:.3f}" for k, v in split.items())
                       or "no device time recorded"))
                if not err["ok"]:
                    raise AssertionError(f"{name} {dname} {axis}: kernel disagrees with "
                                         f"its plain version: {err}")
            # Yardstick, not used by the port: the library's attention over the
            # block's attention launch shape (all n_pad keys, no gate).
            qkv = [torch.randn(b, h, n_pad, dh, generator=g, device=dev).to(dtype)
                   for _ in range(3)]
            sdpa_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(*qkv), iters=5)
            records[-2]["attention_library_ms"] = sdpa_ms
            log(f"[kernels] yardstick: scaled_dot_product_attention {dname} "
                f"({b}, {h}, {n_pad}, {dh}) {sdpa_ms:.3f} ms")
            del qkv
            if dtype == torch.bfloat16 and axis == "time":
                # Yardsticks, not used by the port: one cuBLAS product of each
                # GEMM shape of the two blocks, (B·n_pad, K)·(K, N) in bf16.
                a2d = x.reshape(-1, d)
                h2d = torch.empty(a2d.shape[0], hidden, dtype=dtype, device=dev).normal_()
                for what, lhs, rhs in (("FF first", a2d, ff["w1"]), ("FF second", h2d, ff["w2"]),
                                       ("QKV", a2d, attn["wqkv"]), ("out projection", a2d, attn["wo"])):
                    gemm_ms = cuda_time_ms(lambda: lhs @ rhs, iters=5)
                    flop = 2 * lhs.shape[0] * lhs.shape[1] * rhs.shape[1]
                    log(f"[kernels] yardstick: cuBLAS bf16 {what} {tuple(lhs.shape)}x"
                        f"{tuple(rhs.shape)} product {gemm_ms:.3f} ms "
                        f"({flop / gemm_ms / 1e9:.0f} TFLOP/s)")
                del h2d
            del x, attn, ff, rope, forms
            torch.cuda.empty_cache()
    return records


def phase_attention_kernel(att, seed):
    """Phase 3, the whole-sequence attention: kernel against its plain
    version, and one library call beside them for the time alone."""
    import torch
    import torch.nn.functional as F

    dev = torch.device("cuda")
    # (shape, dtype, timed): the HTDemucs time and frequency branch at full
    # width, then a ragged last tile with a head dimension the wrapper pads.
    cases = [((4, 8, 1344, 64), torch.float32, True), ((4, 8, 2688, 64), torch.float32, True),
             ((4, 8, 1344, 64), torch.bfloat16, True), ((4, 8, 2688, 64), torch.bfloat16, True),
             ((2, 4, 173, 8), torch.float32, False), ((2, 4, 173, 8), torch.bfloat16, False),
             ((4, 4, 1344, 128), torch.float32, True), ((4, 4, 1344, 128), torch.bfloat16, True)]
    records = []
    for shape, dtype, timed in cases:
        dname = str(dtype).split(".")[-1]
        b, h, n, d = shape
        g = torch.Generator(device=dev).manual_seed(seed)
        q, k, v = ((torch.randn(*shape, generator=g, device=dev) * 0.7).to(dtype)
                   for _ in range(3))
        scale = d ** -0.5
        before = att.LAUNCHES["fused_attention"]
        got = att.dot_product_attention(q, k, v)
        torch.cuda.synchronize()
        if att.LAUNCHES["fused_attention"] != before + 1:
            raise AssertionError("dot_product_attention did not launch the kernel")
        want = att.attention_ref(q, k, v, scale)
        err = compare(got, want, dname)
        del got, want
        torch.cuda.empty_cache()
        axis = "wide head" if d == 128 else ("time" if n == 1344 else "freq")
        rec = dict(name="fused_attention", dtype=dname, axis=axis, shape=list(shape), n_valid=n,
                   **err)
        tol = TOLERANCE[dname]
        msg = (f"[kernels] fused_attention {dname} q=k=v{shape}: "
               f"max_abs_err={err['max_abs_err']:.3e} "
               f"(rel {err['max_abs_err'] / err['scale']:.3e}, tol {tol['max']:.3e}) "
               f"mean_abs_err={err['mean_abs_err']:.3e} "
               f"(rel {err['mean_abs_err'] / err['scale']:.3e}, tol {tol['mean']:.3e})")
        if timed:
            cost = whole_attention_cost(b, h, n, d, torch.finfo(dtype).bits // 8)
            bound_ms, bound_by = bound(cost, dname)
            ms = cuda_time_ms(lambda: att.dot_product_attention(q, k, v), iters=10)
            plain_ms = cuda_time_ms(lambda: att.attention_ref(q, k, v, scale), iters=3)
            torch.cuda.empty_cache()  # the plain version's (B, H, N, N) scores
            # Yardstick only: the port never calls it.
            library_ms = cuda_time_ms(
                lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), iters=10)
            rec.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                       bound_by=bound_by, flop=cost[0], bytes=cost[1],
                       split=device_split(lambda: att.dot_product_attention(q, k, v)))
            msg += (f" kernel {ms:.3f} ms ({cost[0] / ms / 1e9:.1f} TFLOP/s), plain "
                    f"{plain_ms:.3f} ms, library yardstick (scaled_dot_product_attention) "
                    f"{library_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by})")
        log(msg)
        records.append(rec)
        if not err["ok"]:
            raise AssertionError(f"fused_attention {dname} {shape}: kernel disagrees with "
                                 f"its plain version: {err}")
        del q, k, v
        torch.cuda.empty_cache()
    return records


# GroupNorm kernel against group_norm_ref on the same card tensors: both sum
# the float32 statistics of rows of up to 8.3 M elements, in different orders
# (good to some 1e-7 of the scale), and the apply pass adds a few float32
# roundings (a·x + b, erf or exp, the scale and the residual).
GN_TOLERANCE = {"float32": {"max": 1e-5, "mean": 1e-6}}
# Every GroupNorm shape of one HTDemucs forward of the songs cell (4 segments
# of 7.8 s at 44.1 kHz): each encoder level's DConv, two depths of
# GroupNorm(1, C/8) -> GELU and GroupNorm(1, 2C) -> GLU·scale + residual, on
# the time branch and on the frequency branch with its rows folded into the
# batch; then the 5 transformer layers' channel-last output norms a branch.
GN_BATCH, GN_FRAMES = 4, 336
GN_LEVELS = ((85995, 512), (21499, 128), (5375, 32), (1344, 8))  # time length, freq rows


def group_norm_shapes():
    """``(axis, shape, groups, epilogue, channel_last, launches a forward)``:
    one HTDemucs forward's GroupNorms (their launches sum to
    HTDEMUCS_GROUP_NORMS_PER_FORWARD), then, timed by no forward, HDemucs
    v3's four-group norm and a row length that is no multiple of 4."""
    shapes = []
    for level, (length, rows) in enumerate(GN_LEVELS):
        c = 48 * 2 ** level
        for branch, lead, n in (("time", GN_BATCH, length), ("freq", GN_BATCH * rows, GN_FRAMES)):
            shapes.append((f"L{level} {branch}", (lead, c // 8, n), 1, "gelu", False, 2))
            shapes.append((f"L{level} {branch}", (lead, 2 * c, n), 1, "glu_scale_residual",
                           False, 2))
    shapes.append(("transformer time", (GN_BATCH, 1344, 512), 1, "none", True, 5))
    shapes.append(("transformer freq", (GN_BATCH, 2688, 512), 1, "none", True, 5))
    shapes.append(("v3", (GN_BATCH, 384, 8, 336), 4, "gelu", False, 0))
    shapes.append(("ragged", (3, 10, 1001), 1, "glu_scale_residual", False, 0))
    return shapes


def phase_group_norm_kernel(seed):
    """Phase 3, the GroupNorm kernel (ops/group_norm.group_norm): at each
    shape of group_norm_shapes, one call with the launch counts set to 0
    just before (one launch, split where its plan splits the rows, nothing
    else), against group_norm_ref on the same card tensors; at a forward's
    shapes its CUDA-event and device time beside the plain version's, the
    library's F.group_norm alone (no epilogue) and the byte bound of
    benchmark/counts/group_norm.py."""
    import torch
    import torch.nn.functional as F

    from audio_separator_tpu_torch.ops import _build
    from audio_separator_tpu_torch.ops import group_norm as gn

    sys.path.insert(0, os.path.join(REPO, "benchmark"))
    from benchlib import manifest, peaks

    count_bytes = manifest.plugin("counts", "group_norm").count
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    records = []
    forward = dict.fromkeys(("ms", "device_ms", "plain_ms", "library_ms", "bound_ms"), 0.0)
    for axis, shape, groups, epilogue, channel_last, per_forward in group_norm_shapes():
        g = torch.Generator(device=dev).manual_seed(seed)
        channels = shape[-1] if channel_last else shape[1]
        # An offset mean and a spread of scales, as the card tests use.
        x = torch.randn(*shape, generator=g, device=dev) * 2.5 + 0.75
        kw = dict(weight=1 + 0.3 * torch.randn(channels, generator=g, device=dev),
                  bias=0.2 * torch.randn(channels, generator=g, device=dev), groups=groups,
                  eps=1e-5, epilogue=epilogue, channel_last=channel_last)
        if epilogue == "glu_scale_residual":
            kw.update(scale=0.5 * torch.randn(channels // 2, generator=g, device=dev),
                      residual=torch.randn(shape[0], channels // 2, *shape[2:], generator=g,
                                           device=dev))

        def kernel():
            return gn.group_norm(x, **kw)

        def plain():
            return gn.group_norm_ref(x, **kw)

        def library():
            xin = x.transpose(1, 2) if channel_last else x
            return F.group_norm(xin, groups, kw["weight"], kw["bias"], 1e-5)

        rows, row_len = shape[0] * groups, x.numel() // shape[0] // groups
        out_len = row_len * groups // (2 if epilogue == "glu_scale_residual" else 1)
        splits = gn.plan(rows, row_len, shape[0], out_len, sms)[0]
        with torch.inference_mode():
            _build.reset_launch_counts()
            got = kernel()
            torch.cuda.synchronize()
            launches = {k: v for k, v in _build.LAUNCHES.items() if v}
            want = plain()
        err = compare(got, want, "float32", GN_TOLERANCE)
        del got, want
        rec = dict(name="group_norm", dtype="float32", axis=axis, shape=list(shape),
                   groups=groups, epilogue=epilogue, channel_last=channel_last,
                   per_forward=per_forward, splits=splits, **err)
        tol = GN_TOLERANCE["float32"]
        msg = (f"[kernels] group_norm {axis} {epilogue}{' channel-last' if channel_last else ''} "
               f"x{shape} groups {groups}, {splits} split(s) a row: "
               f"max_abs_err={err['max_abs_err']:.3e} "
               f"(rel {err['max_abs_err'] / err['scale']:.3e}, tol {tol['max']:.0e}) "
               f"mean_abs_err={err['mean_abs_err']:.3e} "
               f"(rel {err['mean_abs_err'] / err['scale']:.3e}, tol {tol['mean']:.0e})")
        if per_forward:
            with torch.inference_mode():
                ms = cuda_time_ms(kernel, iters=5)
                plain_ms = cuda_time_ms(plain, iters=3)
                library_ms = cuda_time_ms(library, iters=3)
                split = device_split(kernel)
            _, nbytes = count_bytes(rows, row_len, channels, epilogue, 4,
                                    scale="scale" in kw, residual="residual" in kw)
            bound_ms = 1e3 * peaks.bound_s(0, nbytes, 4)
            device_ms = sum(split.values()) or None
            rec.update(ms=ms, device_ms=device_ms, plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=bound_ms, bound_by="bytes", bytes=nbytes, split=split)
            for key in forward:
                forward[key] += per_forward * (rec[key] or 0.0)
            msg += (f"; kernel {ms:.3f} ms (device "
                    + (f"{device_ms:.3f}" if device_ms else "not recorded")
                    + f"), plain {plain_ms:.3f} ms, library yardstick (F.group_norm alone) "
                    f"{library_ms:.3f} ms, bound {bound_ms:.3f} ms (bytes); "
                    f"{per_forward} a forward")
        log(msg)
        records.append(rec)
        want_launches = {"group_norm": 1, **({"group_norm_split": 1} if splits > 1 else {})}
        if launches != want_launches:
            raise AssertionError(f"group_norm {axis} {shape}: launches {launches}, "
                                 f"expected {want_launches}")
        if not err["ok"]:
            raise AssertionError(f"group_norm {axis} {shape}: kernel disagrees with its "
                                 f"plain version: {err}")
        del x, kw
        torch.cuda.empty_cache()
    launches = sum(r["per_forward"] for r in records)
    if launches != HTDEMUCS_GROUP_NORMS_PER_FORWARD:
        raise AssertionError(f"group_norm_shapes gives {launches} launches a forward, "
                             f"expected {HTDEMUCS_GROUP_NORMS_PER_FORWARD}")
    log(f"[kernels] group_norm, one HTDemucs forward's {launches} launches: kernel "
        f"{forward['ms']:.3f} ms (device {forward['device_ms']:.3f}), plain "
        f"{forward['plain_ms']:.3f} ms, library yardstick {forward['library_ms']:.3f} ms, "
        f"bound {forward['bound_ms']:.3f} ms (bytes; device time's share "
        f"{100 * forward['bound_ms'] / max(forward['device_ms'], 1e-9):.1f} %)")
    return records, forward


def phase_model(ab, seed):
    """Phase 4: flagship forward with kernels vs the CPU plain path."""
    import numpy as np
    import torch

    from audio_separator_tpu_torch.models.convert import load_jax_params
    from audio_separator_tpu_torch.models.init_params import flagship_config, init_roformer_params
    from audio_separator_tpu_torch.models.roformer import Roformer

    cfg = flagship_config()
    tree = init_roformer_params(cfg, seed=seed)
    chunk = cfg.stft_hop_length * 800  # one 8 s window, 801 frames
    audio = torch.from_numpy(
        (np.random.default_rng(seed).standard_normal((1, 2, chunk)) * 0.2).astype(np.float32))

    gpu = load_jax_params(Roformer(cfg), tree).cuda().eval()
    ab.reset_launch_counts()
    t0 = time.perf_counter()
    out_gpu = gpu(audio.cuda())
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    launches = dict(ab.LAUNCHES)
    out_gpu = out_gpu.cpu()
    del gpu
    torch.cuda.empty_cache()

    cpu = load_jax_params(Roformer(cfg), tree).eval()
    t0 = time.perf_counter()
    out_cpu = cpu(audio)
    cpu_s = time.perf_counter() - t0
    sdr = sdr_db(out_cpu, out_gpu)
    expected = cfg.depth * (cfg.time_transformer_depth + cfg.freq_transformer_depth)
    log(f"[model] flagship Roformer fp32, one window {tuple(audio.shape)} -> "
        f"{tuple(out_gpu.shape)}: SDR vs CPU plain path {sdr:.2f} dB (floor "
        f"{TF32_FORWARD_FLOOR_DB}, 3xTF32 products); "
        f"launches {launches} (expected {expected} each); "
        f"card {gpu_s:.3f} s (first call), CPU {cpu_s:.1f} s")
    if not bool(torch.isfinite(out_gpu).all()):
        raise AssertionError("model output is not finite")
    if sdr < max(SDR_FLOOR_DB, TF32_FORWARD_FLOOR_DB):
        raise AssertionError(f"model SDR {sdr:.2f} dB below {TF32_FORWARD_FLOOR_DB} "
                             f"(3xTF32 float32 products)")
    if any(launches[name] != expected for name in ("fused_attention_block", "fused_ff_block")):
        raise AssertionError(f"launch counts {launches}, expected {expected} each")
    return {"sdr_db": sdr, "launches": launches}


HTDEMUCS_LAUNCHES_PER_FORWARD = 6  # self-attention layers 0, 2, 4 on both branches
# Every GroupNorm of an HTDemucs forward runs the GroupNorm kernel
# (ops/group_norm.py): two a DConv depth, two depths, on the 4 + 4 encoder
# levels (32), and the output norm of the 5 transformer layers on both
# branches (10). How many launches split their rows over several blocks
# follows the shapes and the card's SM count, so the exact launch checks
# leave "group_norm_split" out (launches_to_compare).
HTDEMUCS_GROUP_NORMS_PER_FORWARD = 42


def launches_to_compare(launches):
    """``launches`` without ``group_norm_split``, after checking that it lies
    between 0 and the GroupNorm launches."""
    split = launches.get("group_norm_split", 0)
    if not 0 <= split <= launches.get("group_norm", 0):
        raise AssertionError(f"group_norm_split {split} outside 0..group_norm: {launches}")
    return {name: n for name, n in launches.items() if name != "group_norm_split"}


def phase_htdemucs_model(att, seed):
    """Phase 4, HTDemucs: the full-width forward with the attention kernel
    against the same module on the CPU (plain version), float32."""
    import numpy as np
    import torch

    from audio_separator_tpu_torch.models.convert import load_jax_htdemucs_params
    from audio_separator_tpu_torch.models.htdemucs import HTDemucs
    from audio_separator_tpu_torch.models.init_params import (htdemucs_full_config,
                                                              init_htdemucs_params)

    cfg = htdemucs_full_config()
    tree = init_htdemucs_params(cfg, seed=seed)
    rng = np.random.default_rng(seed)
    t = np.arange(cfg.training_length) / cfg.samplerate
    tones = np.stack([np.sin(2 * np.pi * f * t) for f in (110, 220, 330, 440, 550, 660, 770, 880)])
    audio = torch.from_numpy((0.2 * tones.reshape(4, 2, -1)
                              + 0.05 * rng.standard_normal((4, 2, cfg.training_length))
                              ).astype(np.float32))

    gpu = load_jax_htdemucs_params(HTDemucs(cfg), tree).cuda().eval()
    att.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out_gpu = gpu(audio.cuda())
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = att.LAUNCHES["fused_attention"]
    group_norms = att.LAUNCHES["group_norm"]
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    x = audio.cuda()
    forward_ms = cuda_time_ms(lambda: gpu(x), iters=3)
    out_gpu = out_gpu.cpu()
    del gpu, x
    torch.cuda.empty_cache()

    cpu = load_jax_htdemucs_params(HTDemucs(cfg), tree).eval()
    t0 = time.perf_counter()
    out_cpu = cpu(audio)
    cpu_s = time.perf_counter() - t0
    sdrs = [sdr_db(out_cpu[:, i], out_gpu[:, i]) for i in range(len(cfg.sources))]
    log(f"[model] full-width HTDemucs fp32 (TF32 off), {tuple(audio.shape)} -> "
        f"{tuple(out_gpu.shape)}: SDR vs CPU plain path per source "
        f"{[round(v, 2) for v in sdrs]} dB (floor {SDR_FLOOR_DB}); fused_attention launches "
        f"{launches} (expected {HTDEMUCS_LAUNCHES_PER_FORWARD}), group_norm {group_norms} "
        f"(expected {HTDEMUCS_GROUP_NORMS_PER_FORWARD}); card first call "
        f"{first_s:.3f} s, warm forward {forward_ms:.1f} ms, peak device memory "
        f"{peak_gb:.2f} GiB; CPU {cpu_s:.1f} s; output peak {float(out_cpu.abs().max()):.3f}")
    if tuple(out_gpu.shape) != (4, len(cfg.sources), 2, cfg.training_length):
        raise AssertionError(f"HTDemucs output shape {tuple(out_gpu.shape)}")
    if not bool(torch.isfinite(out_gpu).all()):
        raise AssertionError("HTDemucs output is not finite")
    if min(sdrs) < SDR_FLOOR_DB:
        raise AssertionError(f"HTDemucs SDR {sdrs} dB below {SDR_FLOOR_DB}")
    if launches != HTDEMUCS_LAUNCHES_PER_FORWARD:
        raise AssertionError(f"{launches} fused_attention launches in one forward, "
                             f"expected {HTDEMUCS_LAUNCHES_PER_FORWARD}")
    if group_norms != HTDEMUCS_GROUP_NORMS_PER_FORWARD:
        raise AssertionError(f"{group_norms} group_norm launches in one forward, "
                             f"expected {HTDEMUCS_GROUP_NORMS_PER_FORWARD}")
    return {"sdr_db": sdrs, "launches": launches, "forward_ms": forward_ms}


# model_2_stem_full_band_8k.yaml (UVR mdx_c_configs), the published config of
# MDX23C-8KFFT-InstVoc_HQ(_2).ckpt, as JSON-flow YAML.
MDX23C_MODEL = "MDX23C-8KFFT-InstVoc_HQ_2.ckpt"
MDX23C_CONFIG = "model_2_stem_full_band_8k.yaml"
MDX23C_MODEL_DATA = {
    "audio": {"chunk_size": 261120, "dim_f": 4096, "dim_t": 256, "hop_length": 1024,
              "n_fft": 8192, "num_channels": 2, "sample_rate": 44100, "min_mean_abs": 0.001},
    "model": {"act": "gelu", "bottleneck_factor": 4, "growth": 128, "norm": "InstanceNorm",
              "num_blocks_per_scale": 2, "num_channels": 128, "num_scales": 5,
              "num_subbands": 4, "scale": [2, 2]},
    "training": {"instruments": ["Vocals", "Instrumental"], "target_instrument": None},
    "inference": {"batch_size": 1, "dim_t": 256, "num_overlap": 8},
}
MDX23C_FLOP_PER_WINDOW = 2.43e12  # torch.utils.flop_counter, one 261120-sample window


def mdx23c_state_dict(seed: int) -> dict:
    """Full-width MDX23C weights in the upstream key layout: the test oracle's
    default initialisation under ``torch.manual_seed(seed)``."""
    import torch

    from audio_separator_tpu_torch.models.tfc_tdf import build_tfc_tdf_config

    cfg = build_tfc_tdf_config(MDX23C_MODEL_DATA)
    torch.manual_seed(seed)
    oracle = _oracle_class("tfc_tdf_oracle", "TFCTDFNetOracle")(
        num_subbands=cfg.num_subbands, num_scales=cfg.num_scales, scale=cfg.scale,
        l=cfg.num_blocks_per_scale, c=cfg.num_channels, g=cfg.growth,
        bn=cfg.bottleneck_factor, dim_f=cfg.dim_f, num_stems=cfg.num_stems,
        norm_type=cfg.norm, act_type=cfg.act, audio_channels=cfg.audio_channels)
    return oracle.state_dict()


def phase_mdx23c_model(seed):
    """Phase 4, MDX23C: the full-width TFC-TDF forward on one batch of 4
    windows, float32, with the process-wide cuDNN TF32 switch at PyTorch's
    default (on) so that the module's own ``full_float32`` scope is what keeps
    it float32; against the same module on the CPU at a batch of 1."""
    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from audio_separator_tpu_torch.models.convert import (convert_tfc_tdf,
                                                          load_jax_tfc_tdf_params)
    from audio_separator_tpu_torch.models.tfc_tdf import TFCTDFNet, build_tfc_tdf_config

    cfg = build_tfc_tdf_config(MDX23C_MODEL_DATA)
    chunk = cfg.hop_length * (MDX23C_MODEL_DATA["inference"]["dim_t"] - 1)
    tree = convert_tfc_tdf({k: v.numpy() for k, v in mdx23c_state_dict(seed).items()})
    rng = np.random.default_rng(seed)
    t = np.arange(chunk) / 44100
    audio = torch.from_numpy((0.2 * np.sin(2 * np.pi * 220 * t)
                              + 0.05 * rng.standard_normal((4, 2, chunk))).astype(np.float32))

    gpu = load_jax_tfc_tdf_params(TFCTDFNet(cfg), tree).cuda().eval()
    n_params = sum(p.numel() for p in gpu.parameters())
    x = audio.cuda()
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out_gpu = gpu(x)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        forward_ms = cuda_time_ms(lambda: gpu(x), iters=3)
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    out_gpu = out_gpu.cpu()
    bf16 = gpu.to(torch.bfloat16)
    forward_bf16_ms = cuda_time_ms(lambda: bf16(x), iters=3)
    out_bf16 = bf16(x).cpu()
    del gpu, bf16, x
    torch.cuda.empty_cache()

    cpu = load_jax_tfc_tdf_params(TFCTDFNet(cfg), tree).eval()
    with FlopCounterMode(display=False) as counter:
        t0 = time.perf_counter()
        out_cpu = cpu(audio[:1])
        cpu_s = time.perf_counter() - t0
    flop = counter.get_total_flops()
    sdrs = [sdr_db(out_cpu[0, i], out_gpu[0, i]) for i in range(cfg.num_stems)]
    sdrs_bf16 = [sdr_db(out_gpu[:, i], out_bf16[:, i]) for i in range(cfg.num_stems)]
    tflops = 4 * flop / (forward_ms * 1e-3) / 1e12
    log(f"[model] full-width MDX23C (TFC-TDF v3, {n_params / 1e6:.1f} M parameters) fp32 "
        f"under full_float32 (process-wide cuDNN TF32 on), {tuple(audio.shape)} -> "
        f"{tuple(out_gpu.shape)}: SDR vs CPU plain path (batch row 0) per stem "
        f"{[round(v, 2) for v in sdrs]} dB (floor {SDR_FLOOR_DB}); card first call "
        f"{first_s:.3f} s, warm forward {forward_ms:.1f} ms for 4 windows "
        f"({flop / 1e12:.3f} TFLOP a window by torch.utils.flop_counter, expected "
        f"{MDX23C_FLOP_PER_WINDOW / 1e12:.2f}; {tflops:.1f} TFLOP/s; FMA bound "
        f"{4 * flop / PEAK_FLOPS['float32'] * 1e3:.1f} ms), peak device memory {peak_gb:.2f} GiB; "
        f"bf16 forward {forward_bf16_ms:.1f} ms ({4 * flop / (forward_bf16_ms * 1e-3) / 1e12:.1f}"
        f" TFLOP/s, bound {4 * flop / PEAK_FLOPS['bfloat16'] * 1e3:.1f} ms), bf16 vs fp32 card "
        f"SDR {[round(v, 2) for v in sdrs_bf16]} dB; CPU {cpu_s:.1f} s a window; output peak "
        f"{float(out_cpu.abs().max()):.3f}")
    if tuple(out_gpu.shape) != (4, cfg.num_stems, 2, chunk):
        raise AssertionError(f"MDX23C output shape {tuple(out_gpu.shape)}")
    if not bool(torch.isfinite(out_gpu).all()):
        raise AssertionError("MDX23C output is not finite")
    if min(sdrs) < SDR_FLOOR_DB:
        raise AssertionError(f"MDX23C SDR {sdrs} dB below {SDR_FLOOR_DB}")
    return {"sdr_db": sdrs, "forward_ms": forward_ms, "forward_bf16_ms": forward_bf16_ms,
            "flop_per_window": flop, "peak_gb": peak_gb}


def write_synthetic_mdx23c(model_dir: str, seed: int) -> None:
    """The full-width MDX23C checkpoint under the published file name, its
    published YAML and an empty remote listing, so the registry resolves the
    model locally."""
    import torch

    torch.save(mdx23c_state_dict(seed), os.path.join(model_dir, MDX23C_MODEL))
    with open(os.path.join(model_dir, MDX23C_CONFIG), "w") as f:
        json.dump(MDX23C_MODEL_DATA, f)  # JSON-flow YAML
    with open(os.path.join(model_dir, "download_checks.json"), "w") as f:
        f.write("{}")


def phase_mdx23c_separator(seed, seconds, device_label):
    """Phase 5, MDX23C: ``Separator().load_model(MDX23C_MODEL).separate()`` in
    float32 and under ``use_autocast=True``."""
    from audio_separator_tpu_torch.io import audio as audio_io
    from audio_separator_tpu_torch.separator import Separator

    work = os.path.join(REPO, "build")
    os.makedirs(work, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=work) as tmp:
        model_dir = os.path.join(tmp, "models")
        os.makedirs(model_dir)
        t0 = time.perf_counter()
        write_synthetic_mdx23c(model_dir, seed)
        write_s = time.perf_counter() - t0
        sr = 44100
        wav = os.path.join(tmp, "mix.wav")
        mix = write_seeded_wav(wav, seed, seconds, sr)

        result = {}
        stems = {}
        for label, autocast in (("float32", False), ("bf16", True)):
            out_dir = os.path.join(tmp, f"out_{label}")
            t0 = time.perf_counter()
            sep = Separator(model_file_dir=model_dir, output_dir=out_dir,
                            use_autocast=autocast, log_level=logging.WARNING)
            sep.load_model(MDX23C_MODEL)
            load_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            files = sep.separate(wav)
            wall = time.perf_counter() - t0
            check_stems(out_dir, files, 2, mix, sr)
            t0 = time.perf_counter()
            sep.separate(wav)
            wall2 = time.perf_counter() - t0
            prof = profile_separate(sep, wav, tag=f"mdx23c {label}")
            stems[label] = {f.split("_(")[1].split(")")[0]:
                            audio_io.load_audio(os.path.join(out_dir, f))[0] for f in files}
            inst = sep.model_instance
            log(f"[mdx23c] {device_label}: {seconds:.0f} s stereo WAV, full-width MDX23C "
                f"({label}), batch {inst.batch_size}, overlap {inst.overlap}, stems "
                f"{sorted(files)}: first separate {wall:.3f} s ({seconds / wall:.2f}x "
                f"realtime), second {wall2:.3f} s ({seconds / wall2:.2f}x realtime); "
                f"load_model {load_s:.1f} s")
            result[label] = {"wall_s": wall, "wall2_s": wall2, **prof}
            del sep, inst
        sdr = {name: sdr_db(stems["float32"][name], stems["bf16"][name])
               for name in stems["float32"]}
        log(f"[mdx23c] bf16 stems vs float32 card stems: SDR "
            f"{ {k: round(v, 2) for k, v in sdr.items()} } dB (no floor); checkpoint write "
            f"{write_s:.1f} s")
        result["bf16_vs_float32_sdr_db"] = sdr
        if sorted(stems["float32"]) != ["Instrumental", "Vocals"]:
            raise AssertionError(f"MDX23C stems {sorted(stems['float32'])}")
        return result


def phase_codec(seed):
    """Phase 5, audio I/O: the route ``io/audio.py`` takes on this machine
    (the native codec where it builds against libav, else WAV only) and a WAV
    round trip at 16 and 24 bits."""
    import shutil

    import numpy as np

    from audio_separator_tpu_torch.io import audio as audio_io

    route = audio_io._route()
    detail = (audio_io._cli if route == "subprocess" else audio_io.codec_path("library")
              if route == "library" else audio_io._lib_error)
    log(f"[codec] audio I/O route on this machine: {route} ({detail}); g++ "
        f"{shutil.which('g++') or 'absent'}; AUDSEP_CODEC_SUBPROCESS "
        f"{os.environ.get('AUDSEP_CODEC_SUBPROCESS') or 'unset'}")
    rng = np.random.default_rng(seed)
    pcm = np.clip(0.3 * rng.standard_normal((2, 44100)), -1, 1).astype(np.float32)
    work = os.path.join(REPO, "build")
    os.makedirs(work, exist_ok=True)
    errors = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=work) as tmp:
        for bits in (16, 24):
            path = os.path.join(tmp, f"rt{bits}.wav")
            audio_io.save_audio(path, pcm, 44100, bit_depth=bits)
            got, sr = audio_io.load_audio(path)
            info = audio_io.probe(path)
            err = float(np.abs(got - pcm).max())
            errors[bits] = err
            log(f"[codec] WAV {bits}-bit round trip of {pcm.shape}: max |error| {err:.3e} "
                f"(bound {2.0 ** -(bits - 2):.3e}: the writer scales by 2^(b-1) - 1, the reader by 2^(b-1)), probe {info}")
            if (got.shape != pcm.shape or sr != 44100 or info.bits_per_sample != bits
                    or err > 2.0 ** -(bits - 2)):
                raise AssertionError(f"WAV {bits}-bit round trip failed: {got.shape}, {sr} Hz, "
                                     f"{info}, error {err}")
    return {"route": route, "round_trip_max_err": errors}


# The MDX-Net network class (kuielab/mdx-net ConvTDFNet, TFC-TDF v1) at UVR's
# MDX-Net width and the STFT geometry recorded for UVR-MDX-NET-Inst_HQ_3.
MDX_MODEL = "UVR-MDX-NET-Inst_HQ_3.onnx"
MDX_FLOP_PER_WINDOW = 0.611e12  # counted from the shapes (PERF.md); the phase measures it


def export_mdx_model(model_dir: str, seed: int):
    """The full-width ConvTDFNet (seeded weights) exported to ONNX under the
    registry's file name, traced on the card, with its UVR model data keyed
    by the file's hash and empty remote listings, so the registry resolves
    it without a download. Returns the export's wall seconds."""
    import torch

    from audio_separator_tpu_torch.separator.registry import get_model_hash

    try:  # the onnx package is absent: skip the exporter's onnxscript pass
        from torch.onnx._internal.torchscript_exporter import onnx_proto_utils

        onnx_proto_utils._add_onnxscript_fn = lambda model_bytes, custom_opsets: model_bytes
    except ImportError:
        pass
    full_width = _oracle_class("convtdf_oracle", "FULL_WIDTH")
    net = _oracle_class("convtdf_oracle", "seeded_convtdf")(seed, **full_width).cuda()
    path = os.path.join(model_dir, MDX_MODEL)
    t0 = time.perf_counter()
    torch.onnx.export(net, torch.zeros(1, 4, full_width["dim_f"], 256, device="cuda"), path,
                      input_names=["input"], output_names=["output"], dynamo=False)
    export_s = time.perf_counter() - t0
    with open(os.path.join(model_dir, "mdx_model_data.json"), "w") as f:
        json.dump({get_model_hash(path): _oracle_class("convtdf_oracle",
                                                       "INST_HQ_3_MODEL_DATA")}, f)
    for name in ("vr_model_data.json", "download_checks.json"):
        with open(os.path.join(model_dir, name), "w") as f:
            f.write("{}")
    del net
    torch.cuda.empty_cache()
    return export_s


def phase_mdx_model(seed, model_dir):
    """Phase 4, MDX: the full-width ConvTDFNet graph through
    ``models/onnx_torch`` on one batch of 4 windows (the packed STFT of a
    seeded track, the lowest three bins zeroed, as the separator feeds it),
    float32 under ``full_float32`` with the process-wide cuDNN TF32 switch
    on, against the same graph on the CPU at a batch of 1; then bf16."""
    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from audio_separator_tpu_torch.models.onnx_torch import onnx_to_torch
    from audio_separator_tpu_torch.ops.precision import full_float32
    from audio_separator_tpu_torch.ops.stft import hann_window, stft_real_packed

    export_s = export_mdx_model(model_dir, seed)
    path = os.path.join(model_dir, MDX_MODEL)
    data = _oracle_class("convtdf_oracle", "INST_HQ_3_MODEL_DATA")
    n_fft, dim_f = data["mdx_n_fft_scale_set"], data["mdx_dim_f_set"]
    chunk = 1024 * (2 ** data["mdx_dim_t_set"] - 1)
    rng = np.random.default_rng(seed)
    t = np.arange(chunk) / 44100
    audio = torch.from_numpy((0.2 * np.sin(2 * np.pi * 220 * t)
                              + 0.05 * rng.standard_normal((4, 2, chunk))).astype(np.float32))
    spek = stft_real_packed(audio.cuda(), n_fft, 1024, hann_window(n_fft, device="cuda"), dim_f)
    spek[:, :, :3, :] = 0.0

    fn, params, _, _ = onnx_to_torch(path, device="cuda")
    n_params = sum(p.numel() for p in params.values() if p.is_floating_point())
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default
    try:
        with torch.no_grad(), full_float32():
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out_gpu = fn(params, spek)[0]
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
            forward_ms = cuda_time_ms(lambda: fn(params, spek), iters=3)
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    with torch.no_grad():
        half = spek.to(torch.bfloat16)
        forward_bf16_ms = cuda_time_ms(lambda: fn(params, half), iters=3)
        out_bf16 = fn(params, half)[0].float().cpu()
    out_gpu = out_gpu.cpu()
    del params, half
    torch.cuda.empty_cache()

    cpu_fn, cpu_params, _, _ = onnx_to_torch(path, device="cpu")
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        t0 = time.perf_counter()
        out_cpu = cpu_fn(cpu_params, spek[:1].cpu())[0]
        cpu_s = time.perf_counter() - t0
    flop = counter.get_total_flops()
    sdr = sdr_db(out_cpu[0], out_gpu[0])
    sdr_bf16 = sdr_db(out_gpu, out_bf16)
    tflops = 4 * flop / (forward_ms * 1e-3) / 1e12
    log(f"[mdx] model: full-width ConvTDFNet (kuielab/mdx-net TFC-TDF v1, {n_params / 1e6:.2f} M "
        f"parameters) as ONNX (export traced on the card {export_s:.1f} s) through "
        f"onnx_torch, fp32 under full_float32 (process-wide cuDNN TF32 on), "
        f"{tuple(spek.shape)} -> {tuple(out_gpu.shape)}: SDR vs CPU (batch row 0) "
        f"{sdr:.2f} dB (floor 100); card first call {first_s:.3f} s, warm forward "
        f"{forward_ms:.1f} ms for 4 windows ({flop / 1e12:.3f} TFLOP a window by "
        f"torch.utils.flop_counter, expected {MDX_FLOP_PER_WINDOW / 1e12:.3f}; {tflops:.1f} "
        f"TFLOP/s; FMA bound {4 * flop / PEAK_FLOPS['float32'] * 1e3:.1f} ms), peak device "
        f"memory {peak_gb:.2f} GiB; bf16 forward {forward_bf16_ms:.1f} ms "
        f"({4 * flop / (forward_bf16_ms * 1e-3) / 1e12:.1f} TFLOP/s, bound "
        f"{4 * flop / PEAK_FLOPS['bfloat16'] * 1e3:.1f} ms), bf16 vs fp32 card SDR "
        f"{sdr_bf16:.2f} dB; CPU {cpu_s:.1f} s a window; output peak "
        f"{float(out_cpu.abs().max()):.3f}")
    if tuple(out_gpu.shape) != tuple(spek.shape):
        raise AssertionError(f"ConvTDFNet output shape {tuple(out_gpu.shape)}")
    if not bool(torch.isfinite(out_gpu).all()) or not bool(torch.isfinite(out_bf16).all()):
        raise AssertionError("ConvTDFNet output is not finite")
    if sdr < 100.0:
        raise AssertionError(f"ConvTDFNet float32 card forward at {sdr:.2f} dB, floor 100")
    return {"sdr_db": sdr, "sdr_bf16_db": sdr_bf16, "forward_ms": forward_ms,
            "forward_bf16_ms": forward_bf16_ms, "flop_per_window": flop, "peak_gb": peak_gb,
            "params": n_params}


def phase_mdx_separator(ab, att, seed, seconds, model_dir, device_label):
    """Phase 5, MDX: ``Separator().load_model(MDX_MODEL)`` through the
    registry, a warm ``separate`` in float32 and bf16 (profiled), one call
    with ``enable_denoise``, one with ``invert_using_spec``, and
    ``separate_batch`` of a 16-bit and a 24-bit WAV against their solo
    outputs. The path launches none of the three kernels: the counts are set
    to 0 before it and must read 0 after it."""
    import numpy as np

    from audio_separator_tpu_torch.architectures.mdx import MDXSeparator
    from audio_separator_tpu_torch.io import audio as audio_io
    from audio_separator_tpu_torch.separator import Separator

    sr = 44100
    tmp = os.path.dirname(model_dir)
    wav = os.path.join(tmp, "mix.wav")
    mix = write_seeded_wav(wav, seed, seconds, sr)
    ab.reset_launch_counts()
    att.reset_launch_counts()

    def stems_of(out_dir, files):
        return {f.split("_(")[1].split(")")[0]: audio_io.load_audio(os.path.join(out_dir, f))[0]
                for f in files}

    result, stems = {}, {}
    for label, autocast in (("float32", False), ("bf16", True)):
        out_dir = os.path.join(tmp, f"out_{label}")
        t0 = time.perf_counter()
        sep = Separator(model_file_dir=model_dir, output_dir=out_dir, use_autocast=autocast,
                        log_level=logging.WARNING)
        sep.load_model(MDX_MODEL)
        load_s = time.perf_counter() - t0
        inst = sep.model_instance
        if not isinstance(inst, MDXSeparator) or (inst.n_fft, inst.dim_f, inst.dim_t) != \
                (6144, 2560, 256):
            raise AssertionError(f"{MDX_MODEL} loaded as {type(inst).__name__} "
                                 f"({getattr(inst, 'n_fft', None)}, {getattr(inst, 'dim_f', None)})")
        t0 = time.perf_counter()
        files = sep.separate(wav)
        wall = time.perf_counter() - t0
        check_stems(out_dir, files, 2, mix, sr)
        t0 = time.perf_counter()
        sep.separate(wav)
        wall2 = time.perf_counter() - t0
        prof = profile_separate(sep, wav, tag=f"mdx {label}")
        stems[label] = stems_of(out_dir, files)
        log(f"[mdx] separator {device_label}: {seconds:.0f} s stereo WAV, full-width "
            f"ConvTDFNet ({label}), batch {inst.batch_size}, overlap {inst.overlap}, chunk "
            f"{inst.chunk_size}, stems {sorted(files)}: first separate {wall:.3f} s "
            f"({seconds / wall:.2f}x realtime), second {wall2:.3f} s ({seconds / wall2:.2f}x "
            f"realtime); load_model {load_s:.2f} s")
        result[label] = {"wall_s": wall, "wall2_s": wall2, **prof}
        if label == "float32":
            sep32 = sep
    sdr = {k: sdr_db(stems["float32"][k], stems["bf16"][k]) for k in stems["float32"]}
    log(f"[mdx] bf16 stems vs float32 card stems: SDR "
        f"{ {k: round(v, 2) for k, v in sdr.items()} } dB (no floor)")
    result["bf16_vs_float32_sdr_db"] = sdr
    if sorted(stems["float32"]) != ["Instrumental", "Vocals"]:
        raise AssertionError(f"MDX stems {sorted(stems['float32'])}")

    # enable_denoise and invert_using_spec, each on a separator of its own
    for label, kw in (("enable_denoise", {"mdx_params": dict(
            sep32.arch_specific_params["MDX"], enable_denoise=True)}),
            ("invert_using_spec", {"invert_using_spec": True})):
        out_dir = os.path.join(tmp, f"out_{label}")
        sep = Separator(model_file_dir=model_dir, output_dir=out_dir, log_level=logging.WARNING,
                        **kw)
        sep.load_model(MDX_MODEL)
        t0 = time.perf_counter()
        files = sep.separate(wav)
        wall = time.perf_counter() - t0
        got = stems_of(out_dir, files)
        for name, pcm in got.items():
            # the spectral inversion's iSTFT returns whole hops of 1024
            n = mix.shape[1] - (mix.shape[1] % 1024 if label == "invert_using_spec"
                                and name == "Vocals" else 0)
            # Random weights: the denoise pass (f(x) - f(-x)) / 2 may leave
            # little of a primary stem, so only silence itself fails.
            if pcm.shape != (2, n) or not np.isfinite(pcm).all() or not np.abs(pcm).max() > 0:
                raise AssertionError(f"{label} {name}: shape {pcm.shape}, expected (2, {n}), "
                                     f"or not finite, or all zero")
        log(f"[mdx] separator with {label}: {wall:.3f} s, stems "
            f"{ {k: v.shape for k, v in got.items()} }, peaks "
            f"{ {k: round(float(np.abs(v).max()), 6) for k, v in got.items()} }; Vocals vs the "
            f"plain float32 call "
            f"{sdr_db(stems['float32']['Vocals'][:, :got['Vocals'].shape[1]], got['Vocals']):.2f}"
            f" dB, Instrumental {sdr_db(stems['float32']['Instrumental'], got['Instrumental']):.2f}"
            f" dB")
        result[label] = {"wall_s": wall}
        del sep

    # separate_batch of a 16-bit and a 24-bit WAV against their solo outputs
    durations = {"a16.wav": (seconds, 16), "b24.wav": (2 * seconds / 3, 24)}
    wavs, mixes = [], []
    for i, (name, (secs, depth)) in enumerate(durations.items()):
        path = os.path.join(tmp, name)
        mixes.append(write_seeded_wav(path, seed + 1 + i, secs, sr, bit_depth=depth))
        wavs.append(path)
    solo_dir, batch_dir = os.path.join(tmp, "solo"), os.path.join(tmp, "batch")
    sep32.output_dir = sep32.model_instance.output_dir = solo_dir
    solo, solo_walls = [], []
    for path in wavs:
        t0 = time.perf_counter()
        solo.append(stems_of(solo_dir, sep32.separate(path)))
        solo_walls.append(time.perf_counter() - t0)
    sep32.output_dir = sep32.model_instance.output_dir = batch_dir
    t0 = time.perf_counter()
    batch_files = sep32.separate_batch(wavs)
    batch_wall = time.perf_counter() - t0
    worst = math.inf
    for mix_i, files, want, (_, depth) in zip(mixes, batch_files, solo, durations.values()):
        check_stems(batch_dir, files, 2, mix_i, sr)
        got = stems_of(batch_dir, files)
        for f in files:
            bits = audio_io.probe(os.path.join(batch_dir, f)).bits_per_sample
            if bits != depth:
                raise AssertionError(f"{f}: written at {bits} bits, input had {depth}")
        worst = min([worst] + [sdr_db(want[k], got[k]) for k in want])
    launches = {**ab.LAUNCHES, **att.LAUNCHES}
    log(f"[mdx] separate_batch of a {durations['a16.wav'][0]:.0f} s 16-bit and a "
        f"{durations['b24.wav'][0]:.0f} s 24-bit WAV (float32): {batch_wall:.3f} s against solo "
        f"{solo_walls[0]:.3f} s + {solo_walls[1]:.3f} s = {sum(solo_walls):.3f} s; worst stem "
        f"SDR against its solo output {worst:.2f} dB (floor 100); bit depths kept per file; "
        f"kernel launches on the whole MDX path {launches} (the path runs none)")
    if worst < 100.0:
        raise AssertionError(f"MDX separate_batch differs from solo separate: {worst:.2f} dB")
    if any(launches.values()):
        raise AssertionError(f"the MDX path launched a kernel: {launches}")
    result.update({"batch_wall_s": batch_wall, "solo_walls_s": solo_walls,
                   "batch_worst_sdr_db": worst, "launches": launches})
    return result


# The VR family. v5.1: UVR's CascadedNet at its two published widths over
# 4band_v4_ms_fullband (model-data-overrides.json); the wider one here, whose
# state dict keys to 218409 by its size in KB. v5: the sp capacity row of
# CascadedASPPNet (uvr_lib_v5/vr_network/nets.py:79, tests/test_vr.py SP_CAPS)
# at arch 33966, the seven-branch ASPP.
VR51_MODEL = "vr51_fullband_seeded.pth"
VR51_DATA = {"is_bv_model": True, "is_bv_model_rebalanced": 0.9, "is_karaoke": False,
             "nout": 64, "nout_lstm": 128, "primary_stem": "Vocals",
             "vr_model_param": "4band_v4_ms_fullband"}
VR5_MODELS = {"vr5_sp_4band.pth": "4band_44100", "vr5_sp_4band_reverse.pth": "4band_44100_reverse"}
VR_SP_CAPS = [(2, 16), (2, 16), (18, 8, 1, 1, 0), (8, 16), (34, 16, 1, 1, 0), (16, 32),
              (32, 2, 1), (16, 2, 1), (16, 2, 1)]
VR_FLOOR_DB = 100.0  # float32 card against CPU: the MDX bar (PERF.md §2)


def vr_state_dict(seed: int, v51: bool) -> dict:
    """Seeded VR weights in the upstream key layout: the oracle's default
    initialisation under ``torch.manual_seed(seed)``, BatchNorm near unit
    scale (weight 1 ± 0.1, bias and running mean ± 0.1, running variance in
    [0.5, 1.5)) so that activations keep their scale through the cascade."""
    import torch

    torch.manual_seed(seed)
    if v51:
        net = _oracle_class("vr_oracle", "CascadedNetOracle")(
            2 * 896, VR51_DATA["nout"], VR51_DATA["nout_lstm"])
    else:
        net = _oracle_class("vr_oracle", "CascadedASPPNetOracle")(2 * 768, VR_SP_CAPS, 33966)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.weight.copy_(1 + 0.1 * torch.randn(m.weight.shape, generator=g))
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape, generator=g))
                m.running_var.copy_(0.5 + torch.rand(m.running_var.shape, generator=g))
    return net.state_dict()


def write_vr_models(model_dir: str, seed: int) -> dict:
    """The v5.1 and v5 checkpoints with sidecar JSONs (the model data) and an
    empty remote listing; returns each file's size in KB."""
    import torch

    files = {VR51_MODEL: (vr_state_dict(seed, True), VR51_DATA)}
    sd5 = vr_state_dict(seed + 1, False)
    for name, params in VR5_MODELS.items():
        files[name] = (sd5, {"vr_model_param": params, "primary_stem": "Instrumental"})
    sizes = {}
    for name, (sd, data) in files.items():
        path = os.path.join(model_dir, name)
        torch.save(sd, path)
        with open(os.path.splitext(path)[0] + ".json", "w") as f:
            json.dump(data, f)
        sizes[name] = math.ceil(os.path.getsize(path) / 1024)
    with open(os.path.join(model_dir, "download_checks.json"), "w") as f:
        f.write("{}")
    return sizes


def category_split(fn) -> dict:
    """Device ms by ``OP_CATEGORIES`` for one call of ``fn`` (torch.profiler)."""
    cats = {}
    for name, ms in device_split(fn).items():
        cats[op_category(name)] = cats.get(op_category(name), 0.0) + ms
    return cats


def vr_separator(model_dir, out_dir, device="cuda", autocast=False, **vr):
    from audio_separator_tpu_torch.separator import Separator

    params = {"batch_size": 4, "window_size": 512, "aggression": 5, "enable_tta": False,
              "enable_post_process": False, "post_process_threshold": 0.2,
              "high_end_process": False, **vr}
    sep = Separator(model_file_dir=model_dir, output_dir=out_dir, use_autocast=autocast,
                    log_level=logging.WARNING, vr_params=params, device=device)
    return sep


def check_vr_stems(out_dir, files, mix, sr, expect_len):
    """Two finite, non-silent stems of the chain's output length (whole hops
    of the top band: a little short of the mix)."""
    import numpy as np

    from audio_separator_tpu_torch.io import audio as audio_io

    if len(files) != 2 or len(set(files)) != 2:
        raise AssertionError(f"expected 2 stems, got {files}")
    stems = {}
    for name in files:
        pcm, file_sr = audio_io.load_audio(os.path.join(out_dir, name))
        if pcm.shape != (2, expect_len) or file_sr != sr or expect_len > mix.shape[1]:
            raise AssertionError(f"{name}: shape {pcm.shape} at {file_sr} Hz, expected "
                                 f"(2, {expect_len}) at {sr} (mix {mix.shape})")
        if not np.isfinite(pcm).all() or not np.abs(pcm).max() > 1e-4:
            raise AssertionError(f"{name}: stem is not finite or is silent")
        stems[name.split("_(")[1].split(")")[0]] = pcm
    return stems


def vr_card_vs_cpu(model_dir, model, wav):
    """``VRSeparator.separate`` of ``wav`` on the card and on the CPU (float32):
    SDR of the card's float stems against the CPU's, before any file is
    written."""
    out = {}
    for device in ("cuda", "cpu"):
        sep = vr_separator(model_dir, None, device=device)
        sep.load_model(model)
        inst = sep.model_instance
        with tempfile.TemporaryDirectory(dir=os.path.dirname(wav)) as td:
            inst.output_dir = td
            inst.separate(wav)
        out[device] = (inst.primary_source, inst.secondary_source)
        del sep, inst
    return [sdr_db(c, g) for c, g in zip(out["cpu"], out["cuda"])]


def phase_vr(ab, att, seed, seconds, device_label):
    """Phase 5, VR: (a) the full-width v5.1 net's forward of 4 windows on the
    card against the CPU, float32 and bf16; (b) ``Separator.separate`` of the
    seeded WAV with the v5.1 model in float32 and bf16 (warm, profiled), with
    TTA, post-process and high end once each, and card against CPU on a 3 s
    excerpt; (c) the full-width v5 sp model (arch 33966) over ``4band_44100``
    and ``4band_44100_reverse``; (d) ``separate_batch`` of a 16-bit and a
    24-bit WAV against their solo outputs. The path launches none of the three
    kernels: the counts are set to 0 before it and must read 0 after it."""
    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from audio_separator_tpu_torch.architectures.vr import VRSeparator, load_vr_model_params
    from audio_separator_tpu_torch.io import audio as audio_io
    from audio_separator_tpu_torch.models.convert import load_torch_state_dict
    from audio_separator_tpu_torch.models.vr_nets import load_vr_net
    from audio_separator_tpu_torch.ops import vr_chain

    sr = 44100
    work = os.path.join(REPO, "build")
    os.makedirs(work, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=work) as tmp:
        model_dir = os.path.join(tmp, "models")
        os.makedirs(model_dir)
        t0 = time.perf_counter()
        sizes = write_vr_models(model_dir, seed)
        write_s = time.perf_counter() - t0
        wav = os.path.join(tmp, "mix.wav")
        mix = write_seeded_wav(wav, seed, seconds, sr)
        excerpt = os.path.join(tmp, "excerpt.wav")
        write_seeded_wav(excerpt, seed + 7, 3.0, sr)
        ab.reset_launch_counts()
        att.reset_launch_counts()

        # (a) the v5.1 forward of 4 windows: the first tiles of the track's
        # normalised magnitudes, as the separator feeds them
        mp = load_vr_model_params(VR51_DATA["vr_model_param"])
        geom = vr_chain.band_geometry(mp, True)
        sd = load_torch_state_dict(os.path.join(model_dir, VR51_MODEL))
        with torch.no_grad():
            spec_c, _ = vr_chain.analyze(geom, torch.from_numpy(mix).cuda())
            mag = spec_c.abs()
            padded = torch.nn.functional.pad(mag, (64, max(0, 3 * 384 + 448 - mag.shape[-1])))
            x = torch.stack([padded[..., i * 384: i * 384 + 512] for i in range(4)]) / mag.max()
            net = load_vr_net(sd, 2 * mp["bins"], 218409, True, 64, device="cuda")
            n_params = sum(p.numel() for p in net.parameters())
            n_values = sum(v.size for k, v in sd.items() if "num_batches" not in k)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out_gpu = net(x)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
            forward_ms = cuda_time_ms(lambda: net(x), iters=3)
            cats = category_split(lambda: net(x))
            bf16 = net.to_compute_dtype(torch.bfloat16)
            xb = x.to(torch.bfloat16)
            torch.cuda.reset_peak_memory_stats()
            out_bf16 = bf16(xb).float()
            peak_bf16_gb = torch.cuda.max_memory_allocated() / 2 ** 30
            forward_bf16_ms = cuda_time_ms(lambda: bf16(xb), iters=3)
            cats_bf16 = category_split(lambda: bf16(xb))
            out_gpu, out_bf16 = out_gpu.cpu(), out_bf16.cpu()
            del net, bf16, xb
            torch.cuda.empty_cache()
            cpu_net = load_vr_net(sd, 2 * mp["bins"], 218409, True, 64)
            with FlopCounterMode(display=False) as counter:
                t0 = time.perf_counter()
                out_cpu = cpu_net(x[:1].cpu())
                cpu_s = time.perf_counter() - t0
            flop = counter.get_total_flops()
            del cpu_net
        sdr = sdr_db(out_cpu[0], out_gpu[0])
        sdr_bf16 = sdr_db(out_gpu, out_bf16)

        def split(c):
            busy = sum(c.values())
            return ", ".join(f"{k} {v:.1f} ({v / busy:.3f})"
                             for k, v in sorted(c.items(), key=lambda kv: -kv[1]))

        log(f"[vr] model: full-width CascadedNet v5.1 (nout 64, nout_lstm 128, "
            f"{n_params / 1e6:.2f} M parameters, {n_values / 1e6:.2f} M state-dict values, "
            f"{sizes[VR51_MODEL]} KB file) over 4band_v4_ms_fullband, fp32, "
            f"{tuple(x.shape)} -> {tuple(out_gpu.shape)}: SDR vs CPU (window 0) {sdr:.2f} dB "
            f"(floor {VR_FLOOR_DB}); card first call {first_s:.3f} s, warm forward "
            f"{forward_ms:.1f} ms for 4 windows ({flop / 1e12:.3f} TFLOP a window by "
            f"torch.utils.flop_counter, LSTM not counted; "
            f"{4 * flop / (forward_ms * 1e-3) / 1e12:.1f} TFLOP/s; FMA bound "
            f"{4 * flop / PEAK_FLOPS['float32'] * 1e3:.1f} ms), peak device memory "
            f"{peak_gb:.2f} GiB; bf16 forward {forward_bf16_ms:.1f} ms "
            f"({4 * flop / (forward_bf16_ms * 1e-3) / 1e12:.1f} TFLOP/s, bound "
            f"{4 * flop / PEAK_FLOPS['bfloat16'] * 1e3:.1f} ms, peak {peak_bf16_gb:.2f} GiB), "
            f"bf16 vs fp32 card SDR {sdr_bf16:.2f} dB; CPU {cpu_s:.1f} s a window; mask mean "
            f"{float(out_cpu.mean()):.3f}, std {float(out_cpu.std()):.3f}")
        log(f"[vr]   forward device ms by category, fp32: {split(cats)}")
        log(f"[vr]   forward device ms by category, bf16: {split(cats_bf16)}")
        if not bool(torch.isfinite(out_gpu).all()) or not bool(torch.isfinite(out_bf16).all()):
            raise AssertionError("v5.1 mask is not finite")
        if tuple(out_gpu.shape) != (4, 2, mp["bins"] + 1, 384):
            raise AssertionError(f"v5.1 mask shape {tuple(out_gpu.shape)}")
        if sdr < VR_FLOOR_DB:
            raise AssertionError(f"v5.1 float32 card forward at {sdr:.2f} dB, floor {VR_FLOOR_DB}")
        result = {"forward_ms": forward_ms, "forward_bf16_ms": forward_bf16_ms, "sdr_db": sdr,
                  "flop_per_window": flop, "peak_gb": peak_gb}

        # (b) separate with the v5.1 model, float32 and bf16
        n_frame = vr_chain.chain_frames(geom, mix.shape[1])
        out_len = vr_chain.synth_out_len(geom, n_frame)
        stems = {}
        for label, autocast in (("float32", False), ("bf16", True)):
            out_dir = os.path.join(tmp, f"vr_{label}")
            t0 = time.perf_counter()
            sep = vr_separator(model_dir, out_dir, autocast=autocast)
            sep.load_model(VR51_MODEL)
            load_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            files = sep.separate(wav)
            wall = time.perf_counter() - t0
            stems[label] = check_vr_stems(out_dir, files, mix, sr, out_len)
            t0 = time.perf_counter()
            sep.separate(wav)
            wall2 = time.perf_counter() - t0
            prof = profile_separate(sep, wav, tag=f"vr {label}")
            inst = sep.model_instance
            if not isinstance(inst, VRSeparator) or (inst._arch_size, inst.is_vr_51_model) != \
                    (218409, True):
                raise AssertionError(f"{VR51_MODEL} loaded as {type(inst).__name__} "
                                     f"({getattr(inst, '_arch_size', None)})")
            log(f"[vr] separator {device_label}: {seconds:.0f} s stereo WAV, full-width v5.1 "
                f"({label}), arch {inst._arch_size} by file size, window {inst.window_size}, "
                f"batch {inst.batch_size}, aggression {inst.aggression}, {n_frame} frames -> "
                f"{n_frame // 384 + 1} tiles, stems {sorted(files)}: first separate "
                f"{wall:.3f} s ({seconds / wall:.2f}x realtime), second {wall2:.3f} s "
                f"({seconds / wall2:.2f}x realtime); load_model {load_s:.2f} s")
            result[label] = {"wall_s": wall, "wall2_s": wall2, **prof}
            del sep, inst
        sdr_stems = {k: sdr_db(stems["float32"][k], stems["bf16"][k]) for k in stems["float32"]}
        log(f"[vr] bf16 stems vs float32 card stems: SDR "
            f"{ {k: round(v, 2) for k, v in sdr_stems.items()} } dB (no floor); model files "
            f"written in {write_s:.1f} s")
        for label, vr in (("enable_tta", {"enable_tta": True}),
                          ("enable_post_process", {"enable_post_process": True}),
                          ("high_end_process", {"high_end_process": True})):
            out_dir = os.path.join(tmp, f"vr_{label}")
            sep = vr_separator(model_dir, out_dir, **vr)
            sep.load_model(VR51_MODEL)
            t0 = time.perf_counter()
            files = sep.separate(wav)
            wall = time.perf_counter() - t0
            got = check_vr_stems(out_dir, files, mix, sr, out_len)
            log(f"[vr] separator with {label}: {wall:.3f} s (first call of its instance); "
                f"stems vs the plain float32 call "
                f"{ {k: round(sdr_db(stems['float32'][k], v), 2) for k, v in got.items()} } dB")
            result[label] = {"wall_s": wall}
            del sep
        sdrs = vr_card_vs_cpu(model_dir, VR51_MODEL, excerpt)
        log(f"[vr] separate of a 3 s excerpt, float32 card vs CPU: primary {sdrs[0]:.2f} dB, "
            f"secondary {sdrs[1]:.2f} dB (floor {VR_FLOOR_DB})")
        if min(sdrs) < VR_FLOOR_DB:
            raise AssertionError(f"v5.1 separate card vs CPU {sdrs} dB, floor {VR_FLOOR_DB}")
        result["separate_card_vs_cpu_db"] = sdrs

        # (c) the full-width v5 sp model, arch 33966, two geometries
        for name, params in VR5_MODELS.items():
            out_dir = os.path.join(tmp, f"vr5_{params}")
            sep = vr_separator(model_dir, out_dir)
            sep.load_model(name)
            t0 = time.perf_counter()
            files = sep.separate(wav)
            wall = time.perf_counter() - t0
            t0 = time.perf_counter()
            sep.separate(wav)
            wall2 = time.perf_counter() - t0
            inst = sep.model_instance
            g5 = vr_chain.band_geometry(inst.mp, False)
            n5 = vr_chain.chain_frames(g5, mix.shape[1])
            check_vr_stems(out_dir, files, mix, sr, vr_chain.synth_out_len(g5, n5))
            n5_params = sum(p.numel() for p in inst.net.parameters())
            if (inst._arch_size, inst.is_vr_51_model) != (33966, False):
                raise AssertionError(f"{name} keyed to {inst._arch_size}")
            log(f"[vr] v5 sp CascadedASPPNet ({n5_params / 1e6:.2f} M parameters, "
                f"{sizes[name]} KB file -> arch {inst._arch_size}, seven-branch ASPP) over "
                f"{params}, float32: first separate {wall:.3f} s, second {wall2:.3f} s "
                f"({seconds / wall2:.2f}x realtime)")
            result[params] = {"wall_s": wall, "wall2_s": wall2}
            del sep, inst
        sdrs5 = vr_card_vs_cpu(model_dir, "vr5_sp_4band.pth", excerpt)
        log(f"[vr] v5 separate of the 3 s excerpt, float32 card vs CPU: {sdrs5[0]:.2f} / "
            f"{sdrs5[1]:.2f} dB (floor {VR_FLOOR_DB})")
        if min(sdrs5) < VR_FLOOR_DB:
            raise AssertionError(f"v5 separate card vs CPU {sdrs5} dB, floor {VR_FLOOR_DB}")

        # (d) separate_batch of a 16-bit and a 24-bit WAV against solo calls
        durations = {"a16.wav": (seconds, 16), "b24.wav": (2 * seconds / 3, 24)}
        wavs = []
        for i, (name, (secs, depth)) in enumerate(durations.items()):
            path = os.path.join(tmp, name)
            write_seeded_wav(path, seed + 1 + i, secs, sr, bit_depth=depth)
            wavs.append(path)
        solo_dir, batch_dir = os.path.join(tmp, "vr_solo"), os.path.join(tmp, "vr_batch")
        sep = vr_separator(model_dir, solo_dir)
        sep.load_model(VR51_MODEL)
        sep.separate(wavs[0])  # warm
        solo, solo_walls = [], []
        for path in wavs:
            t0 = time.perf_counter()
            files = sep.separate(path)
            solo_walls.append(time.perf_counter() - t0)
            solo.append({f: audio_io.load_audio(os.path.join(solo_dir, f))[0] for f in files})
        sep.output_dir = sep.model_instance.output_dir = batch_dir
        t0 = time.perf_counter()
        batch_files = sep.separate_batch(wavs)
        batch_wall = time.perf_counter() - t0
        worst = math.inf
        for files, want, (_, depth) in zip(batch_files, solo, durations.values()):
            if sorted(files) != sorted(want):
                raise AssertionError(f"separate_batch wrote {files}, solo {sorted(want)}")
            for f in files:
                bits = audio_io.probe(os.path.join(batch_dir, f)).bits_per_sample
                if bits != depth:
                    raise AssertionError(f"{f}: written at {bits} bits, input had {depth}")
                got = audio_io.load_audio(os.path.join(batch_dir, f))[0]
                worst = min(worst, sdr_db(want[f], got))
        launches = {**ab.LAUNCHES, **att.LAUNCHES}
        log(f"[vr] separate_batch of a {durations['a16.wav'][0]:.0f} s 16-bit and a "
            f"{durations['b24.wav'][0]:.0f} s 24-bit WAV (v5.1, float32): {batch_wall:.3f} s "
            f"against solo {solo_walls[0]:.3f} s + {solo_walls[1]:.3f} s = "
            f"{sum(solo_walls):.3f} s; worst stem SDR against its solo output {worst:.2f} dB "
            f"(floor 100); bit depths kept per file; kernel launches on the whole VR path "
            f"{launches} (the path runs none)")
        if worst < 100.0:
            raise AssertionError(f"VR separate_batch differs from solo separate: {worst:.2f} dB")
        if any(launches.values()):
            raise AssertionError(f"the VR path launched a kernel: {launches}")
        result.update({"batch_wall_s": batch_wall, "solo_walls_s": solo_walls,
                       "launches": launches})
        return result


CLI_CHILD = (
    "import json, sys\n"
    "from audio_separator_tpu_torch.ops import attention_block as ab\n"
    "from audio_separator_tpu_torch.utils import cli\n"
    "ab.reset_launch_counts()\n"
    "cli.main(sys.argv[1:])\n"
    "print('RESULT ' + json.dumps(ab.LAUNCHES))\n")

# A fresh process: load the default model, optionally warmup(seconds), then
# time two separate() calls of the same WAV.
FIRST_CALL_CHILD = (
    "import json, logging, sys, time\n"
    "import torch\n"
    "from audio_separator_tpu_torch.separator import Separator\n"
    "model_dir, out_dir, wav, warm = sys.argv[1:5]\n"
    "sep = Separator(model_file_dir=model_dir, output_dir=out_dir, log_level=logging.WARNING)\n"
    "sep.load_model()\n"
    "times = {'warmup_s': sep.warmup(float(warm)) if float(warm) > 0 else None}\n"
    "for key in ('first_s', 'second_s'):\n"
    "    t0 = time.perf_counter()\n"
    "    sep.separate(wav)\n"
    "    torch.cuda.synchronize()\n"
    "    times[key] = time.perf_counter() - t0\n"
    "print('RESULT ' + json.dumps(times))\n")


def run_child(code, args, timeout=300):
    """``code`` in a child Python process on the card; returns its wall time
    and the JSON it printed after ``RESULT``."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code] + [str(a) for a in args], cwd=REPO,
                          capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"child {args} exited {proc.returncode}: {proc.stderr[-2000:]}")
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    return wall, json.loads(line[len("RESULT "):])


def phase_user_surface(ab, sep, model_dir, tmp, seed, seconds, device_label):
    """Phase 5, the rest of the user surface over the default RoFormer
    (float32): ``separate_batch`` of a 16-bit and a 24-bit WAV against each
    file's solo ``separate``, ``warmup(8)``, and the CLI with and without
    ``--chunk_duration``. Each path runs with the launch counts set to 0
    just before it and read just after."""
    from audio_separator_tpu_torch.io import audio as audio_io

    sr = 44100
    durations = {"a16.wav": (seconds, 16), "b24.wav": (2 * seconds / 3, 24)}
    wavs, mixes = [], []
    for i, (name, (secs, depth)) in enumerate(durations.items()):
        path = os.path.join(tmp, name)
        mix = write_seeded_wav(path, seed + 1 + i, secs, sr, bit_depth=depth)
        wavs.append(path)
        mixes.append(mix)

    def stems_of(out_dir, files):
        return {os.path.basename(f): audio_io.load_audio(os.path.join(out_dir, f))[0]
                for f in files}

    solo_dir, batch_dir = os.path.join(tmp, "solo"), os.path.join(tmp, "batch")
    sep.output_dir = sep.model_instance.output_dir = solo_dir
    solo, solo_walls = [], []
    for wav in wavs:
        t0 = time.perf_counter()
        solo.append(stems_of(solo_dir, sep.separate(wav)))
        solo_walls.append(time.perf_counter() - t0)
    sep.output_dir = sep.model_instance.output_dir = batch_dir
    ab.reset_launch_counts()
    t0 = time.perf_counter()
    batch_files = sep.separate_batch(wavs)
    batch_wall = time.perf_counter() - t0
    batch_launches = dict(ab.LAUNCHES)
    worst = math.inf
    for wav, mix, files, want, (_, depth) in zip(wavs, mixes, batch_files, solo,
                                                 durations.values()):
        check_stems(batch_dir, files, 2, mix, sr)
        got = stems_of(batch_dir, files)
        for name in files:
            bits = audio_io.probe(os.path.join(batch_dir, name)).bits_per_sample
            if bits != depth:
                raise AssertionError(f"{name}: written at {bits} bits, input had {depth}")
            worst = min(worst, sdr_db(want[os.path.basename(name)],
                                         got[os.path.basename(name)]))
    log(f"[batch] {device_label}: separate_batch of a {durations['a16.wav'][0]:.0f} s 16-bit "
        f"and a {durations['b24.wav'][0]:.0f} s 24-bit WAV (default RoFormer, float32): "
        f"{batch_wall:.3f} s against solo separate() {solo_walls[0]:.3f} s + "
        f"{solo_walls[1]:.3f} s = {sum(solo_walls):.3f} s; worst stem SDR against its solo "
        f"output {worst:.2f} dB (floor 100); bit depths kept per file; launches {batch_launches}")
    if worst < 100.0:
        raise AssertionError(f"separate_batch differs from solo separate: {worst:.2f} dB")
    if any(batch_launches[name] == 0 for name in ("fused_attention_block", "fused_ff_block")):
        raise AssertionError(f"separate_batch never launched a kernel: {batch_launches}")

    ab.reset_launch_counts()
    warm_s = sep.warmup(8)
    warm_launches = dict(ab.LAUNCHES)
    log(f"[warmup] warmup(8) on the loaded float32 RoFormer: {warm_s:.3f} s; launches "
        f"{warm_launches}")
    if any(warm_launches[name] == 0 for name in ("fused_attention_block", "fused_ff_block")):
        raise AssertionError(f"warmup never launched a kernel: {warm_launches}")

    cli_runs = {}
    for label, extra in (("whole", []), ("chunk_duration 10", ["--chunk_duration", "10"])):
        out_dir = os.path.join(tmp, "cli_" + label.split()[0])
        # WAV explicitly: the CLI's default is FLAC, which needs the codec.
        wall, launches = run_child(CLI_CHILD, [wavs[0], "--model_file_dir", model_dir,
                                               "--output_dir", out_dir, "--output_format",
                                               "WAV", "--log_level", "warning"] + extra)
        files = sorted(os.listdir(out_dir))
        check_stems(out_dir, files, 2, mixes[0], sr)
        log(f"[cli] {device_label}: python -c 'cli.main(argv)' child, default model on the "
            f"{seconds:.0f} s WAV ({label}): {wall:.3f} s wall (process start, kernel load, "
            f"checkpoint load and separation), stems {files}, launches {launches}")
        if any(launches[name] == 0 for name in ("fused_attention_block", "fused_ff_block")):
            raise AssertionError(f"the CLI ({label}) never launched a kernel: {launches}")
        cli_runs[label] = {"wall_s": wall, "launches": launches}

    # The first call of a fresh process against its second, without and with
    # a warmup of the track's own length (a warmup under 10 s would switch
    # the instance to the short-track segment size, ROADMAP C6).
    first_call = {}
    for warm in (0, seconds):
        _, times = run_child(FIRST_CALL_CHILD, [model_dir, os.path.join(tmp, "first_call"),
                                                wavs[0], warm])
        first_call[f"warmup {warm:.0f} s"] = times
        warm_msg = "not called" if not warm else f"{times['warmup_s']:.3f} s"
        log(f"[first call] fresh process, default float32 RoFormer, {seconds:.0f} s WAV, "
            f"warmup({warm:.0f}) {warm_msg}: first separate {times['first_s']:.3f} s, "
            f"second {times['second_s']:.3f} s")
    return {"batch_wall_s": batch_wall, "solo_walls_s": solo_walls, "worst_sdr_db": worst,
            "warmup_s": warm_s, "cli": cli_runs, "launches": batch_launches,
            "first_call": first_call}


def write_synthetic_demucs_bag(model_dir: str, seed: int, cfg=None, signature="955717e8",
                               bag="htdemucs.yaml") -> None:
    """A full-width Demucs package ``<signature>-<sha256 prefix>.th`` (seeded
    weights, the loader's stub class as ``klass``, as a genuine package
    pickles ``demucs.htdemucs.HTDemucs`` or ``demucs.hdemucs.HDemucs``), the
    JSON-flow YAML bag that names its signature, and an empty remote listing
    so the registry resolves everything locally. The defaults are the
    published ``htdemucs``; ``cfg=hdemucs_full_config()``, signature
    ``75fc33f5`` and ``hdemucs_mmi.yaml`` make the published Demucs v3."""
    import hashlib

    import torch

    from audio_separator_tpu_torch.models import demucs_load
    from audio_separator_tpu_torch.models.convert import flatten_tree
    from audio_separator_tpu_torch.models.init_params import (demucs_class_name,
                                                              htdemucs_full_config,
                                                              htdemucs_kwargs,
                                                              init_htdemucs_params)

    cfg = cfg or htdemucs_full_config()
    state = {k: torch.from_numpy(v)
             for k, v in flatten_tree(init_htdemucs_params(cfg, seed=seed)).items()}
    klass = demucs_class_name(cfg)
    tmp = os.path.join(model_dir, f"{signature}.tmp")
    added = demucs_load._ensure_stub_modules()
    try:
        module = sys.modules["demucs.hdemucs" if klass == "HDemucs" else "demucs.htdemucs"]
        torch.save({"klass": getattr(module, klass), "args": (),
                    "kwargs": htdemucs_kwargs(cfg), "state": state}, tmp)
    finally:
        for name in added:
            sys.modules.pop(name, None)
    sha = hashlib.sha256()
    with open(tmp, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            sha.update(block)
    os.replace(tmp, os.path.join(model_dir, f"{signature}-{sha.hexdigest()[:8]}.th"))
    with open(os.path.join(model_dir, bag), "w") as f:
        json.dump({"models": [signature]}, f)  # JSON-flow YAML
    with open(os.path.join(model_dir, "download_checks.json"), "w") as f:
        f.write("{}")


def _oracle_class(module_name="roformer_oracle", class_name="RoformerOracle"):
    path = os.path.join(REPO, "tests", "torch_oracles", f"{module_name}.py")
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return getattr(module, class_name)


def write_synthetic_model(model_dir: str, seed: int) -> None:
    """Full-width BS-RoFormer checkpoint in the upstream key layout (seeded
    default init), its JSON-flow YAML under the default model's file names,
    and an empty remote listing so the registry resolves everything locally."""
    import torch

    from audio_separator_tpu_torch.models.init_params import flagship_config
    from audio_separator_tpu_torch.separator.separator import DEFAULT_MODEL

    cfg = flagship_config()
    bins, start = [], 0
    for nf in cfg.freqs_per_bands:
        bins.append(list(range(start, start + nf)))
        start += nf
    torch.manual_seed(seed)
    oracle = _oracle_class()(
        kind="bs", band_bins=bins, dim=cfg.dim, depth=cfg.depth, heads=cfg.heads,
        dim_head=cfg.dim_head, stereo=True, num_stems=1,
        t_depth=cfg.time_transformer_depth, f_depth=cfg.freq_transformer_depth,
        n_fft=cfg.stft_n_fft, hop=cfg.stft_hop_length, mask_depth=cfg.mask_estimator_depth)
    torch.save({"state_dict": oracle.state_dict()}, os.path.join(model_dir, DEFAULT_MODEL))
    config = {
        "audio": {"sample_rate": 44100, "hop_length": cfg.stft_hop_length,
                  "n_fft": cfg.stft_n_fft, "chunk_size": cfg.stft_hop_length * 800},
        "model": {"dim": cfg.dim, "depth": cfg.depth, "stereo": True, "num_stems": 1,
                  "time_transformer_depth": 1, "freq_transformer_depth": 1,
                  "linear_transformer_depth": 0, "freqs_per_bands": list(cfg.freqs_per_bands),
                  "dim_head": cfg.dim_head, "heads": cfg.heads,
                  "stft_n_fft": cfg.stft_n_fft, "stft_hop_length": cfg.stft_hop_length,
                  "stft_win_length": cfg.stft_win_length, "mask_estimator_depth": 2},
        "training": {"instruments": ["vocals", "other"], "target_instrument": "vocals"},
        "inference": {"dim_t": 801, "batch_size": 4},
    }
    with open(os.path.join(model_dir, DEFAULT_MODEL.replace(".ckpt", ".yaml")), "w") as f:
        json.dump(config, f)  # JSON-flow YAML: readable without PyYAML
    with open(os.path.join(model_dir, "download_checks.json"), "w") as f:
        f.write("{}")


# Device kernels by what they compute, matched on the kernel name in this
# order (cuDNN convolutions run implicit-GEMM kernels, PyTorch's own an
# im2col and a GEMM counted under matmul; norm statistics and other
# reductions run reduce kernels).
OP_CATEGORIES = (("fft", ("fft",)),
                 ("attention", ("flash",)),
                 ("lstm", ("rnn", "lstm")),
                 ("convolution", ("conv", "fprop", "dgrad", "wgrad", "implicit", "cudnn",
                                  "im2col")),
                 ("matmul", ("gemm", "cutlass", "xmma")),
                 ("norm/reduce", ("reduce", "welford", "norm", "moments")),
                 ("copy", ("memcpy", "memset", "copy", "cat")),
                 ("gather/scatter", ("index", "scatter", "gather")),
                 ("elementwise", ("elementwise",)))


def op_category(name: str) -> str:
    low = name.lower()
    for category, keys in OP_CATEGORIES:
        if any(k in low for k in keys):
            return category
    return "other"


def profile_separate(sep, wav, tag="separator") -> dict:
    """One more warm ``separate`` under torch.profiler: the card's busy time
    (every kernel and copy on the device) against the host wall time of the
    same call, the device time by category (``OP_CATEGORIES``) and by kernel
    name. The profiler's own cost lengthens this call, so its wall time is not
    an RTF."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sep.separate(wav)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in device) / 1e3
    log(f"[{tag}] profiled warm call: device busy {busy:.1f} ms of {wall * 1e3:.1f} ms wall "
        f"(idle share {1 - busy / (wall * 1e3):.3f})")
    categories = {}
    for e in device:
        cat = op_category(e.key)
        categories[cat] = categories.get(cat, 0.0) + e.self_device_time_total / 1e3
    log(f"[{tag}]   device ms by category: " + ", ".join(
        f"{k} {v:.1f} ({v / busy:.3f})" for k, v in sorted(categories.items(),
                                                          key=lambda kv: -kv[1])))
    for e in sorted(device, key=lambda e: -e.self_device_time_total)[:16]:
        name = e.key.replace("(anonymous namespace)::", "").split("(")[0]
        log(f"[{tag}]   {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} "
            f"{name.replace('void ', '')[:80]}")
    return {"busy_ms": busy, "wall_ms": wall * 1e3, "categories": categories}


def write_seeded_wav(path: str, seed: int, seconds: float, sr: int = 44100, bit_depth: int = 16):
    import numpy as np

    from audio_separator_tpu_torch.io import audio as audio_io

    n = int(seconds * sr)
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    mix = (0.25 * np.stack([np.sin(2 * np.pi * 220 * t), np.sin(2 * np.pi * 277 * t)])
           + 0.05 * rng.standard_normal((2, n))).astype(np.float32)
    audio_io.save_audio(path, mix, sr, bit_depth=bit_depth)
    return mix


def check_stems(out_dir, files, count, mix, sr):
    import numpy as np

    from audio_separator_tpu_torch.io import audio as audio_io

    if len(files) != count or len(set(files)) != count:
        raise AssertionError(f"expected {count} stems, got {files}")
    for name in files:
        pcm, file_sr = audio_io.load_audio(os.path.join(out_dir, name))
        if pcm.shape != mix.shape or file_sr != sr:
            raise AssertionError(f"{name}: shape {pcm.shape} at {file_sr} Hz, "
                                 f"expected {mix.shape} at {sr}")
        if not np.isfinite(pcm).all() or not np.abs(pcm).max() > 1e-3:
            raise AssertionError(f"{name}: stem is not finite or is silent")


def phase_demucs_separator(att, seed, seconds, device_label):
    """Phase 5, Demucs: ``htdemucs.yaml`` through the user entry point with
    the default Demucs parameters."""
    import math

    from audio_separator_tpu_torch.models.init_params import htdemucs_full_config
    from audio_separator_tpu_torch.separator import Separator

    work = os.path.join(REPO, "build")
    os.makedirs(work, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=work) as tmp:
        model_dir = os.path.join(tmp, "models")
        out_dir = os.path.join(tmp, "out")
        os.makedirs(model_dir)
        t0 = time.perf_counter()
        write_synthetic_demucs_bag(model_dir, seed)
        write_s = time.perf_counter() - t0
        sr = 44100
        wav = os.path.join(tmp, "mix.wav")
        mix = write_seeded_wav(wav, seed, seconds, sr)

        att.reset_launch_counts()
        t0 = time.perf_counter()
        sep = Separator(model_file_dir=model_dir, output_dir=out_dir, log_level=logging.WARNING)
        params = sep.arch_specific_params["Demucs"]
        sep.load_model("htdemucs.yaml")
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        files = sep.separate(wav)
        wall = time.perf_counter() - t0
        launches = dict(att.LAUNCHES)
        check_stems(out_dir, files, 4, mix, sr)

        # 6 launches a forward; one forward per batch of windows; the windows
        # of every shift (each sees the track plus half a second) share the
        # batches; one model in the bag.
        cfg = htdemucs_full_config()
        batch = sep.model_instance.batch_size
        stride = int((1 - params["overlap"]) * cfg.training_length)
        windows = math.ceil((mix.shape[-1] + sr // 2) / stride)
        expected = HTDEMUCS_LAUNCHES_PER_FORWARD * math.ceil(params["shifts"] * windows / batch)

        t0 = time.perf_counter()
        sep.separate(wav)
        wall2 = time.perf_counter() - t0
        profile_separate(sep, wav, tag="demucs")
        log(f"[demucs] {device_label}: {seconds:.0f} s stereo WAV, full-width HTDemucs "
            f"(float32, TF32 off), params {params}, batch {batch}, stems {sorted(files)}: "
            f"first separate {wall:.3f} s ({seconds / wall:.2f}x realtime), second "
            f"{wall2:.3f} s ({seconds / wall2:.2f}x realtime); package write {write_s:.1f} s, "
            f"load_model {load_s:.1f} s; launches {launches} (expected fused_attention "
            f"{expected} = {HTDEMUCS_LAUNCHES_PER_FORWARD} x 1 model x "
            f"ceil({params['shifts']} shifts x {windows} windows / {batch}))")
        if launches["fused_attention"] != expected:
            raise AssertionError(f"fused_attention launched {launches['fused_attention']} "
                                 f"times, expected {expected}")
        return {"launches": launches, "wall_s": wall, "wall2_s": wall2}


V3_SECONDS = 60.0  # at a 30 s stride, each shifted pass runs a full 40 s window and a tail
V3_SIGNATURE = "75fc33f5"  # the published hdemucs_mmi


def phase_demucs_v3(seed, device_label):
    """Demucs v3 (``[demucs_v3]``): the full-width ``HDemucs`` forward of one
    40 s window on the card against the CPU, then ``hdemucs_mmi.yaml`` through
    the user entry point on a 60 s WAV (each shifted pass runs a full window
    through the engine and its 30.5 s and 0.5 s tails by direct calls), and
    the card's stems against the CPU's. The path launches none of the three
    kernels."""
    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from audio_separator_tpu_torch.io import audio as audio_io
    from audio_separator_tpu_torch.models.convert import load_jax_hdemucs_params
    from audio_separator_tpu_torch.models.htdemucs import HDemucs
    from audio_separator_tpu_torch.models.init_params import (hdemucs_full_config,
                                                              init_htdemucs_params)
    from audio_separator_tpu_torch.ops import _build
    from audio_separator_tpu_torch.separator import Separator

    cfg = hdemucs_full_config()
    tree = init_htdemucs_params(cfg, seed=seed)
    n = cfg.training_length
    rng = np.random.default_rng(seed)
    t = np.arange(n) / cfg.samplerate
    audio = torch.from_numpy((0.2 * np.stack([np.sin(2 * np.pi * 220 * t),
                                              np.sin(2 * np.pi * 277 * t)])[None]
                              + 0.05 * rng.standard_normal((1, 2, n))).astype(np.float32))

    _build.reset_launch_counts()
    gpu = load_jax_hdemucs_params(HDemucs(cfg), tree).cuda().eval()
    n_params = sum(p.numel() for p in gpu.parameters())
    torch.cuda.reset_peak_memory_stats()
    x = audio.cuda()
    t0 = time.perf_counter()
    out_gpu = gpu(x)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    forward_ms = cuda_time_ms(lambda: gpu(x), iters=3)
    x4 = x.expand(4, -1, -1).contiguous()  # the engine's batch of windows
    forward4_ms = cuda_time_ms(lambda: gpu(x4), iters=2)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    with FlopCounterMode(display=False) as counter:
        gpu(x)
    flop = counter.get_total_flops()  # cuDNN's LSTM is not counted
    split = category_split(lambda: gpu(x))
    out_gpu = out_gpu.cpu()
    del gpu, x, x4
    torch.cuda.empty_cache()
    cpu = load_jax_hdemucs_params(HDemucs(cfg), tree).eval()
    t0 = time.perf_counter()
    out_cpu = cpu(audio)
    cpu_s = time.perf_counter() - t0
    del cpu
    sdrs = [sdr_db(out_cpu[:, i], out_gpu[:, i]) for i in range(len(cfg.sources))]
    busy = sum(split.values())
    log(f"[demucs_v3] {device_label}: full-width HDemucs ({n_params / 1e6:.2f} M parameters) "
        f"fp32 (TF32 off), one {n / cfg.samplerate:.0f} s window {tuple(audio.shape)} -> "
        f"{tuple(out_gpu.shape)}: SDR vs CPU per source {[round(v, 2) for v in sdrs]} dB "
        f"(floor {SDR_FLOOR_DB}); card first call {first_s:.3f} s, warm forward "
        f"{forward_ms:.1f} ms ({flop / 1e12:.3f} TFLOP by torch.utils.flop_counter, LSTM "
        f"excluded: {flop / (forward_ms * 1e-3) / 1e12:.1f} TFLOP/s; FMA bound "
        f"{flop / PEAK_FLOPS['float32'] * 1e3:.1f} ms), batch of 4 windows {forward4_ms:.1f} ms, "
        f"peak device memory {peak_gb:.2f} GiB; CPU {cpu_s:.1f} s")
    log("[demucs_v3]   device ms by category (one window): " + ", ".join(
        f"{k} {v:.1f} ({v / busy:.3f})" for k, v in sorted(split.items(), key=lambda kv: -kv[1])))
    if tuple(out_gpu.shape) != (1, len(cfg.sources), 2, n) or not bool(
            torch.isfinite(out_gpu).all()):
        raise AssertionError(f"HDemucs output {tuple(out_gpu.shape)} is not finite or misshapen")
    if min(sdrs) < SDR_FLOOR_DB:
        raise AssertionError(f"HDemucs SDR {sdrs} dB below {SDR_FLOOR_DB}")

    work = os.path.join(REPO, "build")
    os.makedirs(work, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=work) as tmp:
        model_dir = os.path.join(tmp, "models")
        os.makedirs(model_dir)
        t0 = time.perf_counter()
        write_synthetic_demucs_bag(model_dir, seed, cfg=cfg, signature=V3_SIGNATURE,
                                   bag="hdemucs_mmi.yaml")
        write_s = time.perf_counter() - t0
        sr = 44100
        wav = os.path.join(tmp, "mix.wav")
        mix = write_seeded_wav(wav, seed, V3_SECONDS, sr, bit_depth=32)

        out_dir = os.path.join(tmp, "out")
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        sep = Separator(model_file_dir=model_dir, output_dir=out_dir, log_level=logging.WARNING)
        sep.load_model("hdemucs_mmi.yaml")
        load_s = time.perf_counter() - t0
        params = sep.arch_specific_params["Demucs"]
        t0 = time.perf_counter()
        files = sep.separate(wav)
        wall = time.perf_counter() - t0
        check_stems(out_dir, files, 4, mix, sr)
        t0 = time.perf_counter()
        sep.separate(wav)
        wall2 = time.perf_counter() - t0
        prof = profile_separate(sep, wav, tag="demucs_v3")
        launches = dict(_build.LAUNCHES)
        segment, stride = cfg.training_length, int((1 - params["overlap"]) * cfg.training_length)
        pass_len = mix.shape[-1] + sr // 2
        full = [o for o in range(0, pass_len, stride) if o + segment <= pass_len]
        tails = [pass_len - o for o in range(0, pass_len, stride) if o + segment > pass_len]
        log(f"[demucs_v3] {device_label}: {V3_SECONDS:.0f} s stereo WAV, hdemucs_mmi.yaml "
            f"(float32), params {params}: each of {params['shifts']} shifted passes "
            f"({pass_len} samples) runs windows at {full} through the engine and tails "
            f"of {tails} samples by direct calls; first separate {wall:.3f} s, warm "
            f"{wall2:.3f} s ({V3_SECONDS / wall2:.2f}x realtime), idle share "
            f"{1 - prof['busy_ms'] / prof['wall_ms']:.3f}; package write {write_s:.1f} s, "
            f"load_model {load_s:.1f} s; launches {launches}")
        if not full or not tails:
            raise AssertionError("the 60 s track does not run both branches of the split")
        others = {k: n for k, n in launches_to_compare(launches).items() if k != "group_norm"}
        if any(others.values()) or not launches["group_norm"]:
            raise AssertionError(f"the Demucs v3 path launched a kernel other than its "
                                 f"GroupNorms, or none of those: {launches}")

        # Card against CPU through the same entry point on the first 40 s (one
        # pass of 40.5 s: the window at 0 and a 10.5 s tail), one shift and
        # one window a batch: the CPU's share of the phase.
        one = {**params, "shifts": 1, "batch_size": 1}
        excerpt = os.path.join(tmp, "mix40.wav")
        audio_io.save_audio(excerpt, mix[:, : 40 * sr], sr, bit_depth=32)
        stems = {}
        for device in ("cuda", "cpu"):
            d = os.path.join(tmp, f"cmp_{device}")
            sep = Separator(model_file_dir=model_dir, output_dir=d, demucs_params=one,
                            log_level=logging.WARNING, device=device)
            sep.load_model("hdemucs_mmi.yaml")
            t0 = time.perf_counter()
            names = sep.separate(excerpt)
            took = time.perf_counter() - t0
            stems[device] = {f: audio_io.load_audio(os.path.join(d, f))[0] for f in names}
            log(f"[demucs_v3]   {device} separate (shifts 1, batch 1): {took:.2f} s")
        stem_sdrs = {f: round(sdr_db(stems["cpu"][f], stems["cuda"][f]), 2) for f in stems["cpu"]}
        log(f"[demucs_v3] written stems, card vs CPU: {stem_sdrs} dB (floor {SDR_FLOOR_DB})")
        if sorted(stems["cpu"]) != sorted(stems["cuda"]) or min(stem_sdrs.values()) < SDR_FLOOR_DB:
            raise AssertionError(f"Demucs v3 card stems against the CPU: {stem_sdrs}")
    return {"sdr_db": sdrs, "forward_ms": forward_ms, "wall2_s": wall2,
            "stem_sdr_db": stem_sdrs}


ENSEMBLE_ALGORITHMS = ("avg_wave", "avg_fft", "uvr_max_spec")
# One 30 s ensemble separate: the RoFormer member's one forward launches each
# fused block once a layer (24), the HTDemucs member's 3 forwards the
# whole-sequence attention 6 times each and the GroupNorm kernel 42 times.
# The backward kernels (training's) run on no inference path.
NO_BF16_BACKWARD = {"attention_backward_bf16": 0, "rmsnorm_backward_bf16": 0,
                    "gelu_backward_bf16": 0, "rope_gate_backward_bf16": 0}
NO_BACKWARD = {"attention_backward": 0, "rmsnorm_backward": 0, "gelu_backward": 0,
               "rope_gate_backward": 0, **NO_BF16_BACKWARD}
# The partial-sum forms of B1 and B2 run only on tensor-parallel layers ([mesh]).
NO_PARTIAL = {"fused_attention_block_partial": 0, "fused_ff_block_partial": 0}
# A training step runs its GroupNorms as the plain composition (autograd).
NO_GROUP_NORM = {"group_norm": 0, "group_norm_split": 0}
ENSEMBLE_LAUNCHES = {"fused_attention_block": 24, "fused_ff_block": 24, "fused_attention": 18,
                     "group_norm": 3 * HTDEMUCS_GROUP_NORMS_PER_FORWARD,
                     **NO_BACKWARD, **NO_PARTIAL}
ENSEMBLE_FLOOR_DB = 60.0  # card ensemble against the CPU Ensembler on the same member stems


def phase_ensemble(seed, seconds, device_label):
    """Ensembles (``[ensemble]``): the full-width default BS-RoFormer and the
    full-width HTDemucs bag in one model directory, ``load_model([default,
    "htdemucs.yaml"])`` under three algorithms; the Vocals group is
    ensembled from both members and held against the CPU ``Ensembler`` on
    the members' solo stems, the other groups pass one member's stem through;
    every kernel's launches are counted over each ensemble call."""
    import numpy as np

    from audio_separator_tpu_torch.io import audio as audio_io
    from audio_separator_tpu_torch.models.convert import finish_cache_writes
    from audio_separator_tpu_torch.ops import _build, fn_cache
    from audio_separator_tpu_torch.ops.spec import normalize
    from audio_separator_tpu_torch.separator import Separator
    from audio_separator_tpu_torch.separator.ensembler import Ensembler
    from audio_separator_tpu_torch.separator.separator import DEFAULT_MODEL

    members = [DEFAULT_MODEL, "htdemucs.yaml"]
    work = os.path.join(REPO, "build")
    os.makedirs(work, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=work) as tmp:
        model_dir = os.path.join(tmp, "models")
        os.makedirs(model_dir)
        t0 = time.perf_counter()
        write_synthetic_model(model_dir, seed)
        write_synthetic_demucs_bag(model_dir, seed)
        write_s = time.perf_counter() - t0
        sr = 44100
        wav = os.path.join(tmp, "mix.wav")
        write_seeded_wav(wav, seed, seconds, sr, bit_depth=32)

        def read(path):
            return audio_io.load_audio(path, sample_rate=sr)[0]

        # The members load cold here (cache cleared), and from the cache in
        # every ensemble call after.
        fn_cache.clear()
        solo, cold = {}, {}
        for member in members:
            out = os.path.join(tmp, "solo_" + member.split(".")[0])
            sep = Separator(model_file_dir=model_dir, output_dir=out, log_level=logging.WARNING)
            t0 = time.perf_counter()
            sep.load_model(member)
            if hasattr(sep.model_instance, "_load_models"):  # Demucs loads at separate
                sep.model_instance._load_models()
            cold[member] = (time.perf_counter() - t0,
                            getattr(sep.model_instance, "load_split", None))
            files = sep.separate(wav)
            t0 = time.perf_counter()
            sep.separate(wav)
            solo[member] = ({f.split("_(")[1].split(")")[0].lower(): read(os.path.join(out, f))
                             for f in files}, time.perf_counter() - t0)
            del sep
        solo_sum = sum(w for _, w in solo.values())

        slug = "custom_ensemble_ep_317_sdr_1_htdemucs"
        groups = ("Bass", "Drums", "Instrumental", "Other", "Vocals")
        results = {}
        for algorithm in ENSEMBLE_ALGORITHMS:
            out = os.path.join(tmp, algorithm)
            sep = Separator(model_file_dir=model_dir, output_dir=out,
                            ensemble_algorithm=algorithm, log_level=logging.WARNING)
            sep.load_model(members)
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            files = sep.separate(wav)
            wall = time.perf_counter() - t0
            launches = dict(_build.LAUNCHES)
            names = sorted(os.path.basename(f) for f in files)
            if names != [f"mix_({g})_{slug}.wav" for g in groups]:
                raise AssertionError(f"{algorithm}: ensemble outputs {names}")
            if launches_to_compare(launches) != ENSEMBLE_LAUNCHES:
                raise AssertionError(f"{algorithm}: launches {launches}, "
                                     f"expected {ENSEMBLE_LAUNCHES}")
            got = {g: read(os.path.join(out, f"mix_({g})_{slug}.wav")) for g in groups}
            roformer, demucs = solo[DEFAULT_MODEL][0], solo["htdemucs.yaml"][0]
            # The written ensemble is peak-normalised to 0.9 (write_audio).
            want = {"Vocals": normalize(Ensembler(algorithm=algorithm, device="cpu").ensemble(
                        [roformer["vocals"], demucs["vocals"]]), 0.9),
                    "Instrumental": roformer["other"], "Bass": demucs["bass"],
                    "Drums": demucs["drums"], "Other": demucs["other"]}
            sdrs = {g: round(sdr_db(want[g], got[g]), 2) for g in groups}
            # (uvr_*_spec end at the inverse STFT's length, up to a hop short
            # of the track, as in the JAX package.)
            n = got["Vocals"].shape[-1]
            vocal_members = [round(sdr_db(got["Vocals"], m[..., :n]), 2)
                             for m in (roformer["vocals"], demucs["vocals"])]
            log(f"[ensemble] {device_label}: {seconds:.0f} s WAV, {algorithm}: separate "
                f"{wall:.3f} s, launches {launches}; outputs against the CPU Ensembler on the "
                f"members' solo stems (Vocals) and the members' own stems (the rest) {sdrs} dB "
                f"(floor {ENSEMBLE_FLOOR_DB}); Vocals against each member {vocal_members} dB")
            if min(sdrs.values()) < ENSEMBLE_FLOOR_DB:
                raise AssertionError(f"{algorithm}: ensemble outputs against the CPU {sdrs}")
            results[algorithm] = {"wall_s": wall, "sdr_db": sdrs, "launches": launches}
            if algorithm == ENSEMBLE_ALGORITHMS[0]:
                t0 = time.perf_counter()
                sep.separate(wav)
                results["warm_wall_s"] = time.perf_counter() - t0
                # The same call with the model cache emptied: both members
                # built and uploaded again, the RoFormer from its converted
                # .npz (written by now), HTDemucs from its checkpoint. Its
                # stems must match the first call's.
                finish_cache_writes()
                fn_cache.clear()
                t0 = time.perf_counter()
                sep.separate(wav)
                results["cold_cache_wall_s"] = time.perf_counter() - t0
                again = {g: read(os.path.join(out, f"mix_({g})_{slug}.wav")) for g in groups}
                cold_sdrs = {g: round(sdr_db(got[g], again[g]), 2) for g in groups}
                identical = all(np.array_equal(got[g], again[g]) for g in groups)
                log(f"[ensemble] {device_label}: the call with the cache emptied against the "
                    f"first call: {'bit-identical' if identical else cold_sdrs} "
                    f"(floor {REMOTE_FLOOR_DB} dB)")
                if not identical and min(cold_sdrs.values()) < REMOTE_FLOOR_DB:
                    raise AssertionError(f"{algorithm}: stems after a cold cache {cold_sdrs}")
            del sep
        log(f"[ensemble] {device_label}: member loads with the model cache empty (s, and "
            f"the RoFormer's split: read, convert, build, upload, forms) "
            f"{({m: (round(t, 3), {k: round(v, 3) for k, v in (sp or {}).items()}) for m, (t, sp) in cold.items()})}")
        log(f"[ensemble] {device_label}: warm ensemble separate {results['warm_wall_s']:.3f} s "
            f"(both members from the model cache), {results['cold_cache_wall_s']:.3f} s with "
            f"the cache emptied before the call, against the members' warm solo calls "
            f"{[round(w, 3) for _, w in solo.values()]} s, sum {solo_sum:.3f} s "
            f"(x{results['warm_wall_s'] / solo_sum:.2f}); checkpoint writes {write_s:.1f} s")
        return {"launches": results[ENSEMBLE_ALGORITHMS[0]]["launches"], "results": results}


# ---------------------------------------------------------------------------
# [remote]: the serving front end over HTTP and ASGI


REMOTE_FLOOR_DB = 100.0  # served stems against direct card calls (PERF.md §2)
REMOTE_SHORT_SECONDS = 20.0
REMOTE_WAIT_S = 300.0


def http_request(url, method="GET", body=None, headers=None):
    """(status, body bytes) over the standard library."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body, method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()


def http_json(url, method="GET", body=None, headers=None):
    status, payload = http_request(url, method, body, headers)
    return status, json.loads(payload)


def multipart_body(fields, file_path=None):
    """A multipart/form-data body built by hand: (bytes, content type)."""
    import uuid

    boundary = "chip-smoke-" + uuid.uuid4().hex
    parts = [f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n{v}\r\n'
             .encode() for k, v in fields.items()]
    if file_path is not None:
        with open(file_path, "rb") as f:
            data = f.read()
        parts.append(f'--{boundary}\r\nContent-Disposition: form-data; name="file"; '
                     f'filename="{os.path.basename(file_path)}"\r\n'
                     f'Content-Type: application/octet-stream\r\n\r\n'.encode() + data + b"\r\n")
    parts.append(f"--{boundary}--\r\n".encode())
    return b"".join(parts), f"multipart/form-data; boundary={boundary}"


def submit_job(url, wav, fields):
    """POST /separate; returns (task id, submit time on the host clock)."""
    body, ctype = multipart_body(fields, wav)
    t0 = time.perf_counter()
    status, payload = http_json(url + "/separate", "POST", body, {"Content-Type": ctype})
    if status != 200 or payload.get("status") != "queued":
        raise AssertionError(f"submit of {os.path.basename(wav)}: {status} {payload}")
    return payload["task_id"], t0


def wait_jobs(get_status, task_ids, timeout=REMOTE_WAIT_S):
    """Poll each job's status until every one is terminal: {task id:
    (status JSON, host time it was first seen terminal)}."""
    done = {}
    deadline = time.perf_counter() + timeout
    while len(done) < len(task_ids):
        for task_id in task_ids:
            if task_id not in done:
                status = get_status(task_id)
                if status["status"] in ("completed", "error"):
                    done[task_id] = (status, time.perf_counter())
        if time.perf_counter() > deadline:
            raise AssertionError(f"jobs not finished after {timeout:.0f} s: "
                                 f"{[t for t in task_ids if t not in done]}")
        time.sleep(0.02)
    failed = {t: s["error"] for t, (s, _) in done.items() if s["status"] != "completed"}
    if failed:
        raise AssertionError(f"remote jobs failed: {failed}")
    return done


def http_fetcher(url):
    """``fetch(task, hash)`` -> the file's bytes, over GET /download."""
    def fetch(task, file_hash):
        status, payload = http_request(f"{url}/download/{task}/{file_hash}")
        if status != 200:
            raise AssertionError(f"download {task}/{file_hash}: {status} {payload[:200]}")
        return payload

    return fetch


def stem_label(name):
    """``<task>_<file>_(Vocals)_<model>.wav`` -> ``vocals``."""
    return name.split("_(")[1].split(")")[0].lower()


def read_stems(fetch, status, out_dir):
    """Download every file of a completed job through ``fetch(task, hash)``
    (bytes) into ``out_dir``: {stem label: (C, T) float32}."""
    from audio_separator_tpu_torch.io import audio as audio_io

    os.makedirs(out_dir, exist_ok=True)
    stems = {}
    for entry in status["files"]:
        path = os.path.join(out_dir, os.path.basename(entry["filename"]))
        with open(path, "wb") as f:
            f.write(fetch(status["task_id"], entry["hash"]))
        stems[stem_label(entry["filename"])] = audio_io.load_audio(path)[0]
    return stems


def asgi_call(app, method, path, headers=None, body=b""):
    """One request through an ASGI app's raw interface: (status, body)."""
    import asyncio

    messages = []

    async def run():
        scope = {"type": "http", "method": method, "path": path,
                 "headers": [(k.lower().encode(), v.encode())
                             for k, v in (headers or {}).items()]}
        sent = [False]

        async def receive():
            if sent[0]:
                return {"type": "http.disconnect"}
            sent[0] = True
            return {"type": "http.request", "body": body, "more_body": False}

        async def send(message):
            messages.append(message)

        await app(scope, receive, send)

    asyncio.run(run())
    status = next(m["status"] for m in messages if m["type"] == "http.response.start")
    return status, b"".join(m.get("body", b"") for m in messages
                            if m["type"] == "http.response.body")


def roformer_forwards(sep, lengths):
    """Forwards of the RoFormer engine for tracks of ``lengths`` samples in
    one pass: ``demix_jobs`` pools every job's windows into its batches."""
    from audio_separator_tpu_torch.ops.demix import window_positions

    mi = sep.model_instance
    chunk, step, _ = mi._roformer_geometry()
    windows = sum(len(window_positions(n, chunk, step)) for n in lengths)
    return math.ceil(windows / max(1, int(mi.batch_size)))


def demucs_forwards(sep, length):
    """Forwards of one Demucs v4 ``separate`` of ``length`` samples: every
    model of the bag runs its shifts' windows in one engine call."""
    mi = sep.model_instance
    models, _ = mi._load_models()
    total = 0
    for model in models:
        max_shift = int(0.5 * model.cfg.samplerate)
        positions = mi._train_segment_plan(model.cfg, length + max_shift)[4]
        total += math.ceil(mi.shifts * len(positions) / mi.batch_size)
    return total


class _RecordCounter(logging.Handler):
    """Counts the server's records of failed jobs and failed groups."""

    def __init__(self):
        super().__init__(level=logging.ERROR)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def write_vr51_model(model_dir: str, seed: int) -> None:
    """The full-width v5.1 checkpoint of the ``[vr]`` phase and its sidecar
    JSON, alone."""
    import torch

    path = os.path.join(model_dir, VR51_MODEL)
    torch.save(vr_state_dict(seed, True), path)
    with open(os.path.splitext(path)[0] + ".json", "w") as f:
        json.dump(VR51_DATA, f)


def backend_switches():
    """The process-wide switches that float32 work of the port must leave
    as it found them."""
    import torch

    cudnn = torch.backends.cudnn
    return {"cudnn.enabled": cudnn.enabled, "cudnn.allow_tf32": cudnn.allow_tf32,
            "cudnn.benchmark": cudnn.benchmark, "cudnn.deterministic": cudnn.deterministic,
            "matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32}


def phase_remote(seed, seconds, device_label):
    """The serving front end (``[remote]``): the full-width BS-RoFormer and
    HTDemucs behind the port's HTTP server and its ASGI app on the card, each
    served stem against a direct ``Separator`` call of the same file with the
    same settings, and the kernels' launches over each server against the
    engine's window plan. Server B also runs the full-width VR v5.1 and
    MDX23C in float32 on its two workers, whose process-wide switches must
    end as they began."""
    import numpy as np
    import torch

    from audio_separator_tpu_torch.io import audio as audio_io
    from audio_separator_tpu_torch.ops import _build, fn_cache
    from audio_separator_tpu_torch.remote import server as server_mod
    from audio_separator_tpu_torch.remote.asgi import create_app
    from audio_separator_tpu_torch.separator import DEFAULT_MODEL, Separator
    from audio_separator_tpu_torch.utils.metrics import bss_eval, simple_sdr

    sr = 44100
    work = os.path.join(REPO, "build")
    os.makedirs(work, exist_ok=True)
    records = _RecordCounter()
    server_mod.logger.addHandler(records)
    saved_env = {k: os.environ.get(k) for k in ("AUDSEP_SERVER_COALESCE", "AUDSEP_API_KEY")}
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=work) as tmp:
            model_dir = os.path.join(tmp, "models")
            os.makedirs(model_dir)
            t0 = time.perf_counter()
            write_synthetic_model(model_dir, seed)
            write_synthetic_demucs_bag(model_dir, seed)
            write_vr51_model(model_dir, seed)
            write_synthetic_mdx23c(model_dir, seed)
            write_s = time.perf_counter() - t0
            wavs = {"long": os.path.join(tmp, "long.wav"), "short": os.path.join(tmp, "short.wav")}
            lengths = {}
            for i, (key, secs) in enumerate((("long", seconds),
                                             ("short", REMOTE_SHORT_SECONDS))):
                # 32-bit float WAVs: the stems are written at the input's depth
                lengths[key] = write_seeded_wav(wavs[key], seed + 70 + i, secs, sr,
                                                bit_depth=32).shape[-1]

            # Direct card calls with the server's settings: the references,
            # the solo walls and the window plans.
            models = {"demucs": ("htdemucs.yaml", False, ("long", "short")),
                      "roformer": (DEFAULT_MODEL, False, ("long", "short")),
                      "roformer bf16": (DEFAULT_MODEL, True, ("long",)),
                      "vr": (VR51_MODEL, False, ("long",)),
                      "mdx23c": (MDX23C_MODEL, False, ("short",))}
            # The model cache starts empty: each model's first direct call
            # builds it, the second (and every server job) takes it from the
            # cache.
            fn_cache.clear()
            direct, solo_s, seps, load_splits = {}, {}, {}, {}
            for key, (model, autocast, tracks) in models.items():
                for track in tracks:
                    t0 = time.perf_counter()
                    sep = Separator(model_file_dir=model_dir, output_format="wav",
                                    output_dir=os.path.join(tmp, "direct", key),
                                    use_autocast=autocast, log_level=logging.WARNING)
                    sep.load_model(model)
                    load_splits[key, track] = getattr(sep.model_instance, "load_split", None)
                    t1 = time.perf_counter()
                    files = sep.separate(wavs[track])
                    torch.cuda.synchronize()
                    t2 = time.perf_counter()
                    solo_s[key, track] = (t2 - t0, t2 - t1)
                    direct[key, track] = {
                        stem_label(f): audio_io.load_audio(os.path.join(sep.output_dir, f))[0]
                        for f in files}
                    seps[key] = sep
            # A second built-and-loaded 30 s float32 RoFormer call: its model
            # from the cache.
            t0 = time.perf_counter()
            sep = Separator(model_file_dir=model_dir, output_format="wav",
                            output_dir=os.path.join(tmp, "direct", "again"),
                            log_level=logging.WARNING)
            sep.load_model(DEFAULT_MODEL)
            again_split = sep.model_instance.load_split
            sep.separate(wavs["long"])
            torch.cuda.synchronize()
            again_s = time.perf_counter() - t0
            del sep
            log(f"[remote] {device_label}: a second built-and-loaded {seconds:.0f} s float32 "
                f"RoFormer call {again_s:.3f} s (load {again_split}), the first "
                f"{solo_s['roformer', 'long'][0]:.3f} s")
            log(f"[remote] {device_label}: direct calls, load + separate / separate alone "
                f"(s), the first of each model with the model cache empty: "
                f"{({f'{k} {t}': (round(a, 3), round(b, 3)) for (k, t), (a, b) in solo_s.items()})}"
                f"; MDXC load split (read, convert, build, upload, forms; or cached) "
                f"{({f'{k} {t}': {n: round(v, 3) for n, v in sp.items()} for (k, t), sp in load_splits.items() if sp})}")
            cfg = seps["roformer"].model_instance.model_cfg  # one B1 and one B2 a layer
            per_forward = {"roformer": cfg.depth * (cfg.time_transformer_depth
                                                    + cfg.freq_transformer_depth),
                           "demucs": HTDEMUCS_LAUNCHES_PER_FORWARD}
            fwd = {"demucs": {k: demucs_forwards(seps["demucs"], n) for k, n in lengths.items()},
                   "roformer": {k: roformer_forwards(seps["roformer"], [n])
                                for k, n in lengths.items()},
                   "group": roformer_forwards(seps["roformer"], list(lengths.values()))}
            del seps

            def expect(b1_forwards, b3_forwards):
                return {"fused_attention_block": per_forward["roformer"] * b1_forwards,
                        "fused_ff_block": per_forward["roformer"] * b1_forwards,
                        "fused_attention": per_forward["demucs"] * b3_forwards,
                        "group_norm": HTDEMUCS_GROUP_NORMS_PER_FORWARD * b3_forwards,
                        **NO_BACKWARD, **NO_PARTIAL}

            def score(tag, job_key, stems, track):
                """The served stems against the direct call's: SDR per stem,
                and whether all are bit-identical."""
                want = direct[job_key, track]
                if sorted(stems) != sorted(want):
                    raise AssertionError(f"{tag}: stems {sorted(stems)}, direct {sorted(want)}")
                sdrs = {}
                for name, got in stems.items():
                    if got.shape != want[name].shape or not np.isfinite(got).all():
                        raise AssertionError(f"{tag} {name}: shape {got.shape} against "
                                             f"{want[name].shape}, or not finite")
                    sdrs[name] = round(simple_sdr(got, want[name]), 2)
                return {"sdr_db": sdrs, "bit_identical": all(
                    np.array_equal(got, want[name]) for name, got in stems.items())}

            def floor(tag, result):
                if min(result["sdr_db"].values()) < REMOTE_FLOOR_DB:
                    raise AssertionError(f"{tag}: served stems against the direct call "
                                         f"{result['sdr_db']} dB (floor {REMOTE_FLOOR_DB})")
                return result

            def check(tag, job_key, stems, track):
                return floor(tag, score(tag, job_key, stems, track))

            results = {}
            remote_launches = dict.fromkeys(_build.LAUNCHES, 0)

            # ---- Server A: one worker, coalescing on at 2.
            os.environ["AUDSEP_SERVER_COALESCE"] = "2"
            srv = server_mod.serve(host="127.0.0.1", port=0, model_file_dir=model_dir,
                                   work_dir=os.path.join(tmp, "server_a"), workers=1,
                                   device="cuda")
            thread = threading.Thread(target=srv.serve_forever, daemon=True)
            thread.start()
            url = f"http://127.0.0.1:{srv.server_address[1]}"
            try:
                for path in ("/health", "/models-json", "/presets"):
                    status, payload = http_json(url + path)
                    if status != 200 or not payload:
                        raise AssertionError(f"GET {path}: {status} {payload}")
                if http_request(url + "/status/unknown-task")[0] != 404:
                    raise AssertionError("GET /status of an unknown task did not answer 404")
                jobs = [("demucs", "long", {"model": "htdemucs.yaml"}),
                        ("roformer", "long", {"use_autocast": "false"}),
                        ("roformer", "short", {"use_autocast": "false"}),
                        ("roformer bf16", "long", {"use_autocast": "true"})]
                _build.reset_launch_counts()
                t_start = time.perf_counter()
                submitted = [(key, track, *submit_job(url, wavs[track],
                                                      {**fields, "output_format": "wav"}))
                             for key, track, fields in jobs]
                done = wait_jobs(lambda t: http_json(f"{url}/status/{t}")[1],
                                 [task for _, _, task, _ in submitted])
                wall_a = time.perf_counter() - t_start
                launches_a = dict(_build.LAUNCHES)
                want_a = expect(fwd["group"] + fwd["roformer"]["long"],
                                fwd["demucs"]["long"])

                latencies, served = {}, {}
                for key, track, task, t_submit in submitted:
                    status, t_done = done[task]
                    latencies[f"{key} {track}"] = t_done - t_submit
                    served[key, track] = read_stems(http_fetcher(url), status,
                                                    os.path.join(tmp, "dl", task))
                    results[f"A {key} {track}"] = check(f"server A {key} {track}", key,
                                                        served[key, track], track)
                group_dir = os.path.join(tmp, "server_a", "group-" + submitted[1][2])
                if not os.path.isdir(group_dir):
                    raise AssertionError("the two float32 RoFormer jobs did not coalesce")
                # the group starts when the one worker finishes the HTDemucs job
                group_s = done[submitted[2][2]][1] - done[submitted[0][2]][1]
                os.environ["AUDSEP_API_KEY"] = "chip-smoke-key"
                status_401 = http_request(url + f"/status/{submitted[0][2]}")[0]
                os.environ.pop("AUDSEP_API_KEY")
                if status_401 != 401:
                    raise AssertionError(f"GET /status without the API key: {status_401}")
                # bss_eval: the short file's two served RoFormer stems against
                # the direct ones
                names = sorted(served["roformer", "short"])
                t0 = time.perf_counter()
                bss = bss_eval([direct["roformer", "short"][n] for n in names],
                               [served["roformer", "short"][n] for n in names], sample_rate=sr)
                bss_s = time.perf_counter() - t0
                # SDR is +inf exactly where a served stem equals its direct
                # stem bit for bit (no distortion at all); every other ratio
                # must be finite
                identical = [np.array_equal(served["roformer", "short"][n],
                                            direct["roformer", "short"][n]) for n in names]
                if not all(math.isfinite(v) or (k == "SDR" and v == math.inf and same)
                           for scores, same in zip(bss, identical) for k, v in scores.items()):
                    raise AssertionError(f"bss_eval of served against direct stems: {bss} "
                                         f"(bit-identical {identical})")
            finally:
                srv.shutdown()
                srv.server_close()
            for name, n in launches_a.items():
                remote_launches[name] += n
            log(f"[remote] {device_label}: server A (1 worker, coalescing at 2), "
                f"{seconds:.0f} s and {REMOTE_SHORT_SECONDS:.0f} s float32 WAVs, 4 jobs: wall "
                f"{wall_a:.3f} s ({len(jobs) * 3600 / wall_a:.1f} jobs/hour); latency submit to "
                f"completed {({k: round(v, 3) for k, v in latencies.items()})} s")
            log(f"[remote] {device_label}: server A launches {launches_a}, expected {want_a} "
                f"({per_forward['roformer']} B1/B2 per RoFormer forward x ({fwd['group']} "
                f"forwards of the coalesced group + {fwd['roformer']['long']} bf16); "
                f"{per_forward['demucs']} B3 per HTDemucs forward x {fwd['demucs']['long']})")
            log(f"[remote] {device_label}: coalesced float32 RoFormer group (one "
                f"separate_batch, {seconds:.0f} s + {REMOTE_SHORT_SECONDS:.0f} s, its Separator "
                f"built and loaded) {group_s:.3f} s against two solo direct calls built, loaded "
                f"and run {solo_s['roformer', 'long'][0]:.3f} + "
                f"{solo_s['roformer', 'short'][0]:.3f} s (separate alone "
                f"{solo_s['roformer', 'long'][1]:.3f} + {solo_s['roformer', 'short'][1]:.3f} s)")
            log(f"[remote] {device_label}: served stems against direct card calls (floor "
                f"{REMOTE_FLOOR_DB} dB): {results}; bss_eval of the "
                f"{REMOTE_SHORT_SECONDS:.0f} s float32 RoFormer stems {names} in {bss_s:.1f} s: "
                f"{[{k: round(v, 2) for k, v in s.items()} for s in bss]} (bit-identical to "
                f"the direct stems: {identical})")
            if launches_to_compare(launches_a) != want_a:
                raise AssertionError(f"server A launches {launches_a}, expected {want_a}")

            # ---- Server B: two workers, coalescing off, both TF32 switches
            # on. Round 1: two HTDemucs jobs at once, whose float32 scopes
            # must keep TF32 off while either job is inside one. Round 2: the
            # VR v5.1 and MDX23C jobs submitted together, float32 both (VR's
            # convolutions pass cuDNN's switches per call). Every score is
            # logged before any check raises.
            os.environ["AUDSEP_SERVER_COALESCE"] = "1"
            cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
            saved_tf32 = (cudnn.allow_tf32, matmul.allow_tf32)
            cudnn.allow_tf32 = matmul.allow_tf32 = True
            switches_before = backend_switches()
            rounds = (("demucs", "long", {"model": "htdemucs.yaml"}),
                      ("demucs", "short", {"model": "htdemucs.yaml"})), (
                      ("vr", "long", {"model": VR51_MODEL}),
                      ("mdx23c", "short", {"model": MDX23C_MODEL}))
            try:
                srv = server_mod.serve(host="127.0.0.1", port=0, model_file_dir=model_dir,
                                       work_dir=os.path.join(tmp, "server_b"), workers=2,
                                       device="cuda")
                thread = threading.Thread(target=srv.serve_forever, daemon=True)
                thread.start()
                url = f"http://127.0.0.1:{srv.server_address[1]}"
                try:
                    walls_b, latencies_b, switches_after = [], {}, []
                    _build.reset_launch_counts()
                    for jobs_b in rounds:
                        t_start = time.perf_counter()
                        submitted = [(key, track, *submit_job(url, wavs[track],
                                                              {**fields, "output_format": "wav"}))
                                     for key, track, fields in jobs_b]
                        done = wait_jobs(lambda t: http_json(f"{url}/status/{t}")[1],
                                         [task for _, _, task, _ in submitted])
                        walls_b.append(time.perf_counter() - t_start)
                        switches_after.append(backend_switches())
                        for key, track, task, t_submit in submitted:
                            status, t_done = done[task]
                            latencies_b[f"{key} {track}"] = t_done - t_submit
                            stems = read_stems(http_fetcher(url), status,
                                               os.path.join(tmp, "dl", task))
                            results[f"B {key} {track}"] = score(f"server B {key} {track}", key,
                                                                stems, track)
                    launches_b = dict(_build.LAUNCHES)
                finally:
                    srv.shutdown()
                    srv.server_close()
            finally:
                cudnn.allow_tf32, matmul.allow_tf32 = saved_tf32
            want_b = expect(0, fwd["demucs"]["long"] + fwd["demucs"]["short"])
            for name, n in launches_b.items():
                remote_launches[name] += n
            log(f"[remote] {device_label}: server B (2 workers, coalescing off, both TF32 "
                f"switches on): two HTDemucs jobs at once, wall {walls_b[0]:.3f} s "
                f"({2 * 3600 / walls_b[0]:.1f} jobs/hour), solo direct calls "
                f"{solo_s['demucs', 'long'][0]:.3f} + {solo_s['demucs', 'short'][0]:.3f} s; "
                f"float32 VR v5.1 and MDX23C jobs together, wall {walls_b[1]:.3f} s, solo "
                f"direct calls {solo_s['vr', 'long'][0]:.3f} + "
                f"{solo_s['mdx23c', 'short'][0]:.3f} s; latency "
                f"{({k: round(v, 3) for k, v in latencies_b.items()})} s; stems against direct "
                f"{({k: v for k, v in results.items() if k.startswith('B ')})}; switches before "
                f"{switches_before}, after each round {switches_after}; launches {launches_b}, "
                f"expected {want_b}")
            for key, result in results.items():
                if key.startswith("B "):
                    floor(f"server {key}", result)
            if any(after != switches_before for after in switches_after):
                raise AssertionError(f"switches after concurrent jobs {switches_after}, "
                                     f"before {switches_before}")
            if launches_to_compare(launches_b) != want_b:
                raise AssertionError(f"server B launches {launches_b}, expected {want_b}")

            # ---- ASGI: one float32 RoFormer job in process.
            os.environ.pop("AUDSEP_SERVER_COALESCE")
            app = create_app(service=server_mod.SeparatorService(
                work_dir=os.path.join(tmp, "asgi"), model_file_dir=model_dir, workers=1,
                device="cuda"))
            status, payload = asgi_call(app, "GET", "/health")
            if status != 200:
                raise AssertionError(f"ASGI /health: {status} {payload}")
            body, ctype = multipart_body({"output_format": "wav"}, wavs["short"])
            _build.reset_launch_counts()
            t_submit = time.perf_counter()
            status, payload = asgi_call(app, "POST", "/separate", {"Content-Type": ctype}, body)
            if status != 200:
                raise AssertionError(f"ASGI /separate: {status} {payload}")
            task = json.loads(payload)["task_id"]
            done = wait_jobs(lambda t: json.loads(asgi_call(app, "GET", f"/status/{t}")[1]),
                             [task])
            latency_asgi = done[task][1] - t_submit
            launches_asgi = dict(_build.LAUNCHES)
            want_asgi = expect(fwd["roformer"]["short"], 0)
            stems = read_stems(lambda t, h: asgi_call(app, "GET", f"/download/{t}/{h}")[1],
                               done[task][0], os.path.join(tmp, "dl", "asgi"))
            results["ASGI roformer short"] = check("ASGI roformer short", "roformer", stems,
                                                   "short")
            for name, n in launches_asgi.items():
                remote_launches[name] += n
            log(f"[remote] {device_label}: ASGI app, one {REMOTE_SHORT_SECONDS:.0f} s float32 "
                f"RoFormer job: latency {latency_asgi:.3f} s; stems against direct "
                f"{results['ASGI roformer short']}; launches {launches_asgi}, expected "
                f"{want_asgi}; checkpoint writes {write_s:.1f} s")
            if launches_to_compare(launches_asgi) != want_asgi:
                raise AssertionError(f"ASGI launches {launches_asgi}, expected {want_asgi}")
            if records.messages:
                raise AssertionError(f"the server logged failures: {records.messages}")
            return {"launches": remote_launches, "stems": results}
    finally:
        server_mod.logger.removeHandler(records)
        for key, value in saved_env.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


# ----------------------------------------------------------------------------
# [training]: the backward kernels and make_train_step on the card.

# name -> (source, the TPU kernel whose gradient it computes; the JAX package
# has no backward kernel: it cannot differentiate through pl.pallas_call)
BACKWARD_KERNELS = {
    "attention_backward": ("audio_separator_tpu_torch/csrc/attention_bwd.cu",
                           "audio_separator_tpu/ops/attention.py:39"),
    "rmsnorm_backward": ("audio_separator_tpu_torch/csrc/norm_bwd.cu",
                         "audio_separator_tpu/ops/attention_block.py:119"),
    "gelu_backward": ("audio_separator_tpu_torch/csrc/gelu_bwd.cu",
                      "audio_separator_tpu/ops/attention_block.py:119"),
    "rope_gate_backward": ("audio_separator_tpu_torch/csrc/rope_gate_bwd.cu",
                           "audio_separator_tpu/ops/attention_block.py:35"),
}
# One flagship (depth 12) training step: each of the 24 softmax layers runs B1
# and B2 forward; B1's backward K1, K4 and K2, B2's K3 and K2.
ROFORMER_STEP_LAUNCHES = {"fused_attention_block": 24, "fused_ff_block": 24,
                          "fused_attention": 0, "attention_backward": 24,
                          "rmsnorm_backward": 48, "gelu_backward": 24, "rope_gate_backward": 24,
                          **NO_PARTIAL, **NO_BF16_BACKWARD, **NO_GROUP_NORM}
# The same step in bf16 (compute_dtype=torch.bfloat16): B1 and B2 forward in
# bf16, and the backward kernels' bf16 forms in place of their float32 ones.
ROFORMER_BF16_STEP_LAUNCHES = {**ROFORMER_STEP_LAUNCHES, "attention_backward": 0,
                               "rmsnorm_backward": 0, "gelu_backward": 0,
                               "rope_gate_backward": 0, "attention_backward_bf16": 24,
                               "rmsnorm_backward_bf16": 48, "gelu_backward_bf16": 24,
                               "rope_gate_backward_bf16": 24}
# The bf16 forms: name -> (the float32 kernel's name, the source of the bf16
# form). K1's bf16 form is its own pair of kernels, included by
# attention_bwd.cu; K2-K4 are their sources' kernels templated on the type.
BF16_BACKWARD_KERNELS = {
    "attention_backward_bf16": ("attention_backward",
                                "audio_separator_tpu_torch/csrc/attention_bwd_bf16.cuh"),
    "rmsnorm_backward_bf16": ("rmsnorm_backward", "audio_separator_tpu_torch/csrc/norm_bwd.cu"),
    "gelu_backward_bf16": ("gelu_backward", "audio_separator_tpu_torch/csrc/gelu_bwd.cu"),
    "rope_gate_backward_bf16": ("rope_gate_backward",
                                "audio_separator_tpu_torch/csrc/rope_gate_bwd.cu"),
}
# One HTDemucs step: 6 self-attention layers, B3 forward and K1 backward.
HTDEMUCS_STEP_LAUNCHES = {**dict.fromkeys(ROFORMER_STEP_LAUNCHES, 0), "fused_attention": 6,
                          "attention_backward": 6}
# Every parameter's gradient, card against the CPU plain path: within 1e-4
# relative L2, 10x above the 1e-5 of output scale the 3xTF32 forward keeps.
GRADIENT_FLOOR_DB = 80.0


def grad_db(want, got) -> float:
    """20·log10(‖want‖ / ‖want − got‖), +inf where they are equal."""
    num = float(want.double().norm())
    den = float((want.double() - got.double()).norm())
    if den == 0:
        return math.inf
    return 20 * math.log10(max(num, 1e-300) / den)


class tf32_switches_on:
    """Both process-wide TF32 switches on for the enclosed run (as server B of
    ``[remote]`` runs), so that the training step's ``full_float32`` scope is
    what keeps its forward and backward float32. Single-threaded use only."""

    def __enter__(self):
        import torch

        self.saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True

    def __exit__(self, exc_type, *exc):
        import torch

        left = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = self.saved
        if exc_type is None and left != (True, True):
            raise AssertionError(f"a training step left the TF32 switches at {left}")


def training_category(name: str) -> str:
    if "_bwd_" in name:
        return "backward kernels (K1-K4)"
    if any(k in name for k in ("flash_", "gemm_tf32x3", "gemm_wgmma", "rmsnorm")):
        return "forward kernels (B1-B3)"
    if "nvjet" in name:  # cuBLASLt's products on Hopper (the bf16 ones among them)
        return "matmul"
    return op_category(name)


def check_backward_case(records, name, axis, shape, kernel, plain, cost, library=None,
                        n_valid=None, library_note=None, tensor_cores=False,
                        dtype_name="float32"):
    """One backward kernel against its plain version: every output within
    the tolerance of ``dtype_name`` (the type of its bf16 form's bf16
    outputs; float32 outputs, such as Δ, dγ and dz, at the float32 one) of
    its own scale; CUDA-event times of both and of the library call beside
    them. ``tensor_cores``: the float32 kernel's products run as 3xTF32, so
    its bound is that of its own design (the TF32 peak over three), with the
    float32 FMA bound kept beside it as ``bound_fma_ms``; a bf16 form's
    bound is at the bf16 tensor-core peak."""
    import torch

    got = kernel()
    torch.cuda.synchronize()
    want = plain()
    errs = [compare(a, b, "bfloat16" if a.dtype == torch.bfloat16 else "float32")
            for a, b in zip(got, want)]
    del got, want
    torch.cuda.empty_cache()
    ms = cuda_time_ms(kernel, iters=5)
    plain_ms = cuda_time_ms(plain, iters=2)
    torch.cuda.empty_cache()
    library_ms = cuda_time_ms(library, iters=5) if library is not None else None
    bound_ms, bound_by = bound(cost, dtype_name)
    bound_fma_ms = None
    if tensor_cores and dtype_name == "float32":
        t_ops, t_bytes = cost[0] / PEAK_3XTF32, cost[1] / PEAK_BYTES
        bound_fma_ms = bound_ms
        bound_ms = max(t_ops, t_bytes) * 1e3
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
    rel = [e["max_abs_err"] / max(e["scale"], 1e-30) for e in errs]
    rec = dict(name=name, dtype=dtype_name, axis=axis, shape=list(shape), n_valid=n_valid, ms=ms,
               plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
               flop=cost[0], bytes=cost[1], max_abs_err=max(e["max_abs_err"] for e in errs),
               mean_abs_err=max(e["mean_abs_err"] for e in errs),
               scale=min(e["scale"] for e in errs), rel_errs=rel, split=device_split(kernel),
               library_note=library_note, bound_fma_ms=bound_fma_ms,
               bound_3xtf32_ms=bound_ms if bound_fma_ms is not None else None)
    records.append(rec)
    log(f"[training] {name} {dtype_name} {axis} {tuple(shape)}"
        + (f" n_valid={n_valid}" if n_valid is not None else "")
        + f": max |kernel - plain| / scale per output {[f'{r:.2e}' for r in rel]} (tol "
        f"{TOLERANCE[dtype_name]['max']:.0e}); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        + (f"library {library_ms:.3f} ms, " if library_ms is not None else "")
        + (f"({library_note}), " if library_note else "")
        + (f"3xTF32 bound {bound_ms:.3f} ms ({bound_by}; 494.7 / 3 TFLOP/s), FMA bound "
           f"{bound_fma_ms:.3f} ms (67 TFLOP/s)" if bound_fma_ms is not None
           else f"bound {bound_ms:.3f} ms ({bound_by}"
           + ("; 989 TFLOP/s" if dtype_name == "bfloat16" else "") + ")")
        + "; launches (device ms) "
        + ", ".join(f"{k} {v:.3f}" for k, v in rec["split"].items()))
    if not all(e["ok"] for e in errs):
        raise AssertionError(f"{name} {axis}: kernel disagrees with its plain version: {errs}")


def rms_norm_yardstick(x, gamma, dxn):
    """K2's library yardstick, never called by the port: one
    ``aten._fused_rms_norm_backward`` call (dx and dγ, no residual) on the
    same inputs, its ``rstd`` from ``aten._fused_rms_norm``. Returns
    ``(call or None, note)``. Its norm differs in eps: the port clamps Σx²
    at 1e-24, aten adds eps to the mean of x² (1e-24 / d here)."""
    import torch

    d = x.shape[-1]
    eps = 1e-24 / d
    if not hasattr(torch.ops.aten, "_fused_rms_norm_backward"):
        return None, "aten._fused_rms_norm_backward absent in this PyTorch"
    try:
        _, rstd = torch.ops.aten._fused_rms_norm(x, [d], gamma, eps)
        call = (lambda: torch.ops.aten._fused_rms_norm_backward(dxn, x, [d], rstd, gamma,
                                                                [True, True]))
        call()
    except (RuntimeError, TypeError) as exc:
        return None, f"aten._fused_rms_norm_backward failed: {str(exc)[:120]}"
    return call, (f"aten._fused_rms_norm_backward: rsqrt(mean(x²) + {eps:.1e}) where the "
                  f"port clamps Σx² at 1e-24, and no residual gradient added")


def phase_backward_kernels(seed):
    """[training] part 1: each backward kernel against its plain version at
    the path's full-width shapes (batch 2), float32."""
    import torch
    import torch.nn.functional as F

    from audio_separator_tpu_torch.models.roformer import _rope_tables
    from audio_separator_tpu_torch.ops import attention as att
    from audio_separator_tpu_torch.ops import block_backward as bb

    dev = torch.device("cuda")
    d, h, dh, hidden = 512, 8, 64, 2048
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, s=1.0):
        return torch.randn(*shape, generator=g, device=dev) * s

    def sdpa_backward(shape):
        """Yardstick, never called by the port: scaled_dot_product_attention's
        backward at the same shape."""
        qs = [randn(*shape).requires_grad_(True) for _ in range(3)]
        out, do = F.scaled_dot_product_attention(*qs), randn(*shape)
        return lambda: torch.autograd.grad(out, qs, do, retain_graph=True)

    records = []
    for axis, (b, n_valid) in {"time": (2 * 62, 801), "freq": (2 * 801, 62)}.items():
        n_pad = -(-n_valid // 64) * 64
        rows = b * n_pad
        # K1 in the attention block's layout: merged heads, their gradient, gates.
        q, k, v = (randn(b, h, n_pad, dh) for _ in range(3))
        gates = torch.sigmoid(randn(b, h, n_pad))
        merged, dm = randn(b, n_pad, h * dh), randn(b, n_pad, h * dh)
        check_backward_case(
            records, "attention_backward", axis, (b, h, n_pad, dh),
            lambda: att.attention_backward(q, k, v, merged, dm, 0.125, n_valid, gates=gates),
            lambda: att.attention_bwd_ref(q, k, v, merged, dm, 0.125, n_valid, gates=gates),
            (2.5 * 4 * b * h * n_valid * n_valid * dh, 4 * (8 * b * h * n_pad * dh
                                                          + 2 * b * h * n_pad)),
            sdpa_backward((b, h, n_pad, dh)), n_valid, tensor_cores=True)
        del q, k, v, gates, merged, dm
        torch.cuda.empty_cache()
        # K2 with the residual's gradient, padded tokens zero.
        x, dxn, dres = randn(b, n_pad, d), randn(b, n_pad, d), randn(b, n_pad, d)
        x[:, n_valid:] = 0
        gamma = 1 + randn(d, s=0.1)
        rms_library, rms_note = rms_norm_yardstick(x, gamma, dxn)
        check_backward_case(records, "rmsnorm_backward", axis, (rows, d),
                            lambda: bb.rmsnorm_backward(x, gamma, dxn, dres),
                            lambda: bb.rmsnorm_bwd_ref(x, gamma, dxn, dres),
                            (10 * rows * d, 4 * (4 * rows * d + 2 * d)),
                            rms_library, library_note=rms_note)
        del rms_library
        del x, dxn, dres
        # K3 (12 operations a value besides erf and exp).
        pre, dh_ = randn(rows, hidden, s=2.0), randn(rows, hidden)
        check_backward_case(records, "gelu_backward", axis, (rows, hidden),
                            lambda: bb.gelu_backward(pre, dh_),
                            lambda: bb.gelu_bwd_ref(pre, dh_),
                            (12 * rows * hidden, 4 * 4 * rows * hidden),
                            lambda: torch.ops.aten.gelu_backward(dh_, pre),
                            library_note="aten.gelu_backward writes dpre only; K3 also writes "
                                         "h, the GELU's output, for the W2 weight gradient")
        del pre, dh_
        torch.cuda.empty_cache()
        # K4 with the model's RoPE tables, zero past n_valid.
        dq, dk, dv = (randn(b, h, n_pad, dh) for _ in range(3))
        delta, gates = randn(b, h, n_pad), torch.sigmoid(randn(b, h, n_pad))
        cos, sin = _rope_tables(n_valid, dh, torch.float32, dev)
        tables = (F.pad(cos, (0, 0, 0, n_pad - n_valid)), F.pad(sin, (0, 0, 0, n_pad - n_valid)))
        check_backward_case(records, "rope_gate_backward", axis, (b, h, n_pad, dh),
                            lambda: bb.rope_gate_backward(dq, dk, dv, delta, gates, tables),
                            lambda: bb.rope_gate_bwd_ref(dq, dk, dv, delta, gates, tables),
                            (8 * 3 * rows * h * dh, 4 * (6 * rows * h * dh + 2 * n_pad * dh
                                                         + 3 * rows * h)))
        del dq, dk, dv, delta, gates
        torch.cuda.empty_cache()
    # K1 in the whole-sequence layout at the published HTDemucs shapes.
    for axis, shape in (("htdemucs time", (2, 8, 1344, 64)), ("htdemucs freq", (2, 8, 2688, 64))):
        b, h_, n, dh_ = shape
        q, k, v, do = (randn(*shape, s=0.7) for _ in range(4))
        o = att.attention_ref(q, k, v, dh_ ** -0.5)
        check_backward_case(records, "attention_backward", axis, shape,
                            lambda: att.attention_backward(q, k, v, o, do, dh_ ** -0.5),
                            lambda: att.attention_bwd_ref(q, k, v, o, do, dh_ ** -0.5),
                            (2.5 * 4 * b * h_ * n * n * dh_, 4 * 8 * b * h_ * n * dh_),
                            sdpa_backward(shape), tensor_cores=True)
        del q, k, v, do, o
        torch.cuda.empty_cache()
    return records


def phase_backward_kernels_bf16(seed):
    """[training] part 1b: the bf16 form of each backward kernel against its
    plain bf16 version at the flagship step's full-width shapes (batch 2),
    with the bf16 bound (989 TFLOP/s, 3.35 TB/s) and the one-call
    yardsticks in bf16: ``scaled_dot_product_attention``'s backward (flash),
    ``aten._fused_rms_norm_backward`` and ``aten.gelu_backward``."""
    import torch
    import torch.nn.functional as F

    from audio_separator_tpu_torch.models.roformer import _rope_tables
    from audio_separator_tpu_torch.ops import attention as att
    from audio_separator_tpu_torch.ops import block_backward as bb

    dev, bf = torch.device("cuda"), torch.bfloat16
    d, h, dh, hidden = 512, 8, 64, 2048
    g = torch.Generator(device=dev).manual_seed(seed + 7)

    def randn(*shape, s=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g, device=dev) * s).to(dtype)

    def sdpa_backward(shape):
        qs = [randn(*shape).requires_grad_(True) for _ in range(3)]
        out, do = F.scaled_dot_product_attention(*qs), randn(*shape)
        return lambda: torch.autograd.grad(out, qs, do, retain_graph=True)

    records = []
    for axis, (b, n_valid) in {"time": (2 * 62, 801), "freq": (2 * 801, 62)}.items():
        n_pad = -(-n_valid // 64) * 64
        rows = b * n_pad
        q, k, v = (randn(b, h, n_pad, dh) for _ in range(3))
        gates = torch.sigmoid(randn(b, h, n_pad, dtype=torch.float32))
        merged, dm = randn(b, n_pad, h * dh), randn(b, n_pad, h * dh)
        # Five N²·D products over the valid keys; q, k, v, merged, d_merged
        # read and dq, dk, dv written as bf16, the gates read and Δ written
        # as float32.
        check_backward_case(
            records, "attention_backward", axis, (b, h, n_pad, dh),
            lambda: att.attention_backward(q, k, v, merged, dm, 0.125, n_valid, gates=gates),
            lambda: att.attention_bwd_ref(q, k, v, merged, dm, 0.125, n_valid, gates=gates),
            (2.5 * 4 * b * h * n_valid * n_valid * dh,
             2 * 8 * b * h * n_pad * dh + 4 * 2 * b * h * n_pad),
            sdpa_backward((b, h, n_pad, dh)), n_valid, dtype_name="bfloat16",
            library_note="scaled_dot_product_attention's bf16 backward (flash), no gates, "
                         "no key mask")
        del q, k, v, gates, merged, dm
        torch.cuda.empty_cache()
        x, dxn, dres = randn(b, n_pad, d), randn(b, n_pad, d), randn(b, n_pad, d)
        x[:, n_valid:] = 0
        gamma = 1 + randn(d, s=0.1, dtype=torch.float32)
        rms_library, rms_note = rms_norm_yardstick(x, gamma.to(bf), dxn)
        check_backward_case(records, "rmsnorm_backward", axis, (rows, d),
                            lambda: bb.rmsnorm_backward(x, gamma, dxn, dres),
                            lambda: bb.rmsnorm_bwd_ref(x, gamma, dxn, dres),
                            (10 * rows * d, 2 * 4 * rows * d + 4 * 2 * d),
                            rms_library, library_note=rms_note, dtype_name="bfloat16")
        del rms_library, x, dxn, dres
        pre, dh_ = randn(rows, hidden, s=2.0), randn(rows, hidden)
        check_backward_case(records, "gelu_backward", axis, (rows, hidden),
                            lambda: bb.gelu_backward(pre, dh_),
                            lambda: bb.gelu_bwd_ref(pre, dh_),
                            (12 * rows * hidden, 2 * 4 * rows * hidden),
                            lambda: torch.ops.aten.gelu_backward(dh_, pre),
                            library_note="aten.gelu_backward writes dpre only; K3 also writes "
                                         "h, the GELU's output, for the W2 weight gradient",
                            dtype_name="bfloat16")
        del pre, dh_
        torch.cuda.empty_cache()
        dq, dk, dv = (randn(b, h, n_pad, dh) for _ in range(3))
        delta = randn(b, h, n_pad, dtype=torch.float32)
        gates = torch.sigmoid(randn(b, h, n_pad, dtype=torch.float32))
        cos, sin = _rope_tables(n_valid, dh, bf, dev)
        tables = (F.pad(cos, (0, 0, 0, n_pad - n_valid)), F.pad(sin, (0, 0, 0, n_pad - n_valid)))
        # dq, dk, dv read and dqkv written as bf16; the tables (float32 in
        # the kernel), Δ, the gates and dz as float32.
        check_backward_case(records, "rope_gate_backward", axis, (b, h, n_pad, dh),
                            lambda: bb.rope_gate_backward(dq, dk, dv, delta, gates, tables),
                            lambda: bb.rope_gate_bwd_ref(dq, dk, dv, delta, gates, tables),
                            (8 * 3 * rows * h * dh, 2 * 6 * rows * h * dh
                             + 4 * (2 * n_pad * dh + 3 * rows * h)),
                            dtype_name="bfloat16")
        del dq, dk, dv, delta, gates
        torch.cuda.empty_cache()
    return records


def phase_backward_functions(seed):
    """[training] part 2: the three autograd Functions on the card (kernels
    forward and backward) against autograd through their plain versions on
    the card, every input's gradient, at both RoFormer axes (batch 2) and
    both HTDemucs shapes."""
    import torch
    import torch.nn.functional as F

    from audio_separator_tpu_torch.models.roformer import _rope_tables
    from audio_separator_tpu_torch.ops import attention as att
    from audio_separator_tpu_torch.ops import attention_block as ab

    dev = torch.device("cuda")
    d, h, hidden = 512, 8, 2048
    g = torch.Generator(device=dev).manual_seed(seed + 1)

    def randn(*shape, s=1.0):
        return torch.randn(*shape, generator=g, device=dev) * s

    def check(tag, fn, ref, inputs, names, dy, valid=None):
        got = torch.autograd.grad(fn(), inputs, dy)
        want = torch.autograd.grad(ref(), inputs, dy)
        errs = {n: compare(a[:, :valid] if n == "x" and valid else a,
                           w[:, :valid] if n == "x" and valid else w, "float32")
                for n, a, w in zip(names, got, want)}
        log(f"[training] autograd {tag}: max |card - plain| / scale per gradient "
            + ", ".join(f"{n} {e['max_abs_err'] / max(e['scale'], 1e-30):.2e}"
                        for n, e in errs.items())
            + f" (tol {TOLERANCE['float32']['max']:.0e})")
        if not all(e["ok"] for e in errs.values()):
            raise AssertionError(f"{tag}: gradients disagree with the plain version's: {errs}")

    for axis, (b, n_valid) in {"time": (2 * 62, 801), "freq": (2 * 801, 62)}.items():
        n_pad = -(-n_valid // 64) * 64
        x = randn(b, n_pad, d)
        x[:, n_valid:] = 0
        dy = randn(b, n_pad, d)
        dy[:, n_valid:] = 0  # the model drops the padded tokens
        x.requires_grad_(True)
        cos, sin = _rope_tables(n_valid, 64, torch.float32, dev)
        tables = (F.pad(cos, (0, 0, 0, n_pad - n_valid)), F.pad(sin, (0, 0, 0, n_pad - n_valid)))
        w = {k: t.requires_grad_(True) for k, t in dict(
            wqkv=randn(d, 3 * h * 64, s=0.05), gate_w=randn(d, h, s=0.05), gate_b=randn(h, s=0.05),
            wo=randn(h * 64, d, s=0.05), attn_norm=1 + randn(d, s=0.1)).items()}
        kw = dict(rope=tables, heads=h, n_valid=n_valid)
        check(f"fused_attention_block {axis} ({b}, {n_pad}, {d})",
              lambda: ab.fused_attention_block(x, **kw, **w),
              lambda: ab.fused_attention_block_ref(x, **kw, **w),
              [x, *w.values()], ["x", *w], dy, n_valid)
        ff = {k: t.requires_grad_(True) for k, t in dict(
            ff_norm=1 + randn(d, s=0.1), w1=randn(d, hidden, s=0.05), b1=randn(hidden, s=0.05),
            w2=randn(hidden, d, s=0.05), b2=randn(d, s=0.05)).items()}
        check(f"fused_ff_block {axis} ({b}, {n_pad}, {d})",
              lambda: ab.fused_ff_block(x, **ff), lambda: ab.fused_ff_block_ref(x, **ff),
              [x, *ff.values()], ["x", *ff], dy, n_valid)
        del x, dy, w, ff
        torch.cuda.empty_cache()
    for shape in ((2, 8, 1344, 64), (2, 8, 2688, 64)):
        q, k, v = (randn(*shape, s=0.7).requires_grad_(True) for _ in range(3))
        check(f"dot_product_attention {shape}", lambda: att.dot_product_attention(q, k, v),
              lambda: att.attention_ref(q, k, v, shape[-1] ** -0.5), [q, k, v], list("qkv"),
              randn(*shape))
        del q, k, v
        torch.cuda.empty_cache()


def step_gradients(cfg, build, tree, mix, target, device, compute_dtype=None):
    """One ``make_train_step`` step of the module ``build(cfg, tree)`` on
    ``device`` (SGD at lr 0: the weights stay, the gradients are left in
    ``.grad``), in ``compute_dtype`` (float32 by default). Returns (loss,
    {name: gradient on the CPU})."""
    import torch

    from audio_separator_tpu_torch.training import make_train_step

    model = build(cfg, tree).to(device)
    step = make_train_step(cfg, model, torch.optim.SGD(model.parameters(), lr=0.0),
                           compute_dtype=compute_dtype or torch.float32)
    with tf32_switches_on():
        loss = float(step(mix.to(device), target.to(device)))
    grads = {n: (p.grad.detach().cpu() if p.grad is not None else torch.zeros(p.shape))
             for n, p in model.named_parameters()}
    del model, step
    if device == "cuda":
        torch.cuda.empty_cache()
    return loss, grads


def check_gradients(tag, cfg, build, tree, mix, target):
    """The card's gradients of one step against the CPU plain path's: every
    one >= GRADIENT_FLOOR_DB. A gradient that sums many terms of both signs
    (a bias under the loss sums its output gradient over every sample) can
    lose more than that to float32 rounding on the CPU itself: a gradient
    below the floor is held instead to the CPU's own spread, the same step
    on a batch of the same item twice (the same gradient in exact
    arithmetic, summed in another order), within 6 dB."""
    import torch

    t0 = time.perf_counter()
    loss_gpu, gpu = step_gradients(cfg, build, tree, mix, target, "cuda")
    t1 = time.perf_counter()
    loss_cpu, cpu = step_gradients(cfg, build, tree, mix, target, "cpu")
    cpu_s = time.perf_counter() - t1
    dbs = {k: grad_db(cpu[k], gpu[k]) for k in cpu}
    low = {k: v for k, v in dbs.items() if v < GRADIENT_FLOOR_DB}
    line = (f"[training] {tag}: one step on the card (both TF32 switches on) against the CPU "
            f"plain path, {len(dbs)} parameters: loss {loss_gpu:.6f} / {loss_cpu:.6f}; gradient "
            f"parity min {min(dbs.values()):.2f} dB, median "
            f"{sorted(dbs.values())[len(dbs) // 2]:.2f} dB, lowest "
            + ", ".join(f"{k} {v:.2f}" for k, v in sorted(dbs.items(), key=lambda kv: kv[1])[:3])
            + f" (floor {GRADIENT_FLOOR_DB})")
    failed = []
    if low:
        _, twice = step_gradients(cfg, build, tree, torch.cat([mix, mix]),
                                  torch.cat([target, target]), "cpu")
        for k, v in sorted(low.items(), key=lambda kv: kv[1]):
            spread = grad_db(cpu[k], twice[k])
            line += (f"; {k}: {v:.2f} dB against the CPU, whose own spread (the batch twice) "
                     f"is {spread:.2f} dB")
            if v < min(GRADIENT_FLOOR_DB, spread - 6.0):
                failed.append((k, v, spread))
    log(line + f"; card step {t1 - t0:.2f} s (first, with set-up), CPU step {cpu_s:.1f} s")
    if not all(math.isfinite(v) for v in (loss_gpu, loss_cpu)):
        raise AssertionError(f"{tag}: loss not finite")
    if failed:
        raise AssertionError(f"{tag}: gradients below {GRADIENT_FLOOR_DB} dB against the CPU "
                             f"and more than 6 dB under the CPU's own spread: {failed}")
    return {"min_db": min(dbs.values()), "below_floor": {k: dbs[k] for k in low},
            "card": gpu, "cpu": cpu}


def timed_steps(tag, step, mix, target, count, plan):
    """``count`` steps through the entry point, each with the launch counts
    set to 0 just before it and read just after; returns the losses, ms per
    step and the launches summed over the run."""
    import torch

    from audio_separator_tpu_torch.ops import _build

    losses, times, total = [], [], dict.fromkeys(_build.LAUNCHES, 0)
    with tf32_switches_on():
        for i in range(count):
            torch.cuda.synchronize()
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            losses.append(float(step(mix, target)))  # float() waits for the step
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            launches = dict(_build.LAUNCHES)
            for name, n in launches.items():
                total[name] += n
            if launches != plan:
                raise AssertionError(f"{tag} step {i}: launches {launches}, expected {plan}")
    log(f"[training] {tag}: losses {[round(v, 6) for v in losses]}, ms per step "
        f"{[round(t, 1) for t in times]}; launches per step as planned: "
        + (", ".join(f"{k} {v}" for k, v in plan.items() if v) or "none"))
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{tag}: loss not finite: {losses}")
    return losses, times, total


def phase_training(seed, device_label):
    """[training]: the backward kernels against their plain versions, the
    autograd Functions against autograd through the plain versions, and
    ``training.make_train_step`` at full width: the flagship BS-RoFormer
    (gradients against the CPU at depth 2; 3 SGD and 3 Adam steps at depth
    12 on batch 2 of 8 s windows), the published HTDemucs (against the CPU;
    3 Adam steps on batch 2) and one HDemucs step, with both TF32 switches on
    around every step."""
    import dataclasses

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from audio_separator_tpu_torch.models.convert import (load_jax_htdemucs_params,
                                                          load_jax_params)
    from audio_separator_tpu_torch.models.htdemucs import build_demucs
    from audio_separator_tpu_torch.models.init_params import (flagship_config,
                                                              hdemucs_full_config,
                                                              htdemucs_full_config,
                                                              init_htdemucs_params,
                                                              init_roformer_params)
    from audio_separator_tpu_torch.models.roformer import Roformer
    from audio_separator_tpu_torch.ops.precision import full_float32
    from audio_separator_tpu_torch.training import make_loss_fn, make_train_step

    from audio_separator_tpu_torch.ops import fn_cache

    # The models the inference phases loaded stay on the card in the
    # process-wide cache; training needs the memory.
    dropped = fn_cache.clear()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[training] model cache cleared ({dropped} entries); "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB still allocated")
    t_phase = time.perf_counter()
    records = phase_backward_kernels(seed) + phase_backward_kernels_bf16(seed)
    t1 = time.perf_counter()
    phase_backward_functions(seed)
    t2 = time.perf_counter()
    log(f"[training] kernels {t1 - t_phase:.1f} s, autograd Functions {t2 - t1:.1f} s")

    def roformer(cfg, tree):
        return load_jax_params(Roformer(cfg), tree)

    def demucs(cfg, tree):
        return load_jax_htdemucs_params(build_demucs(cfg), tree)

    def batch(rng, n, channels_out, length):
        mix = rng.standard_normal((n, 2, length)).astype(np.float32) * 0.2
        tgt = rng.standard_normal((n, channels_out, 2, length)).astype(np.float32) * 0.2
        return torch.from_numpy(mix), torch.from_numpy(0.5 * tgt + 0.5 * mix[:, None])

    rng = np.random.default_rng(seed)
    cfg = flagship_config()
    chunk = cfg.stft_hop_length * 800  # 8 s windows, 801 frames
    # Part 3: the flagship. Gradients against the CPU at depth 2.
    cfg2 = dataclasses.replace(cfg, depth=2)
    mix1, tgt1 = batch(rng, 1, cfg.num_stems, chunk)
    t0 = time.perf_counter()
    roformer_db = check_gradients("flagship BS-RoFormer, depth 2, batch 1 of 8 s", cfg2,
                                  roformer, init_roformer_params(cfg2, seed=seed), mix1, tgt1)
    parity_s = time.perf_counter() - t0

    # Full depth, batch 2: 3 SGD and 3 Adam steps through the entry point.
    t0 = time.perf_counter()
    model = roformer(cfg, init_roformer_params(cfg, seed=seed)).cuda()
    mix2, tgt2 = (t.cuda() for t in batch(rng, 2, cfg.num_stems, chunk))
    torch.cuda.reset_peak_memory_stats()
    path_launches = dict.fromkeys(ROFORMER_STEP_LAUNCHES, 0)
    step_ms = {}
    for opt_name, opt in (("SGD", torch.optim.SGD(model.parameters(), lr=1e-4)),
                          ("Adam", torch.optim.Adam(model.parameters(), lr=1e-4))):
        step = make_train_step(cfg, model, opt)
        _, step_ms[opt_name], total = timed_steps(
            f"flagship BS-RoFormer depth 12, batch 2 of 8 s, {opt_name}", step, mix2, tgt2, 3,
            ROFORMER_STEP_LAUNCHES)
        for name, n in total.items():
            path_launches[name] += n
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    # One more Adam step, split: the prepared forms remade after the update,
    # forward and loss, backward, optimiser.
    loss_fn = make_loss_fn(cfg, model)
    split = {}

    def timed(part, fn):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        split[part] = (time.perf_counter() - start) * 1e3
        return out

    with tf32_switches_on(), full_float32():
        timed("forms remade", model.tf32_forms)
        opt.zero_grad(set_to_none=True)
        loss = timed("forward + loss", lambda: loss_fn(mix2, tgt2))
        timed("backward", loss.backward)
        timed("optimiser", opt.step)
    del loss
    with tf32_switches_on(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(mix2, tgt2)
        torch.cuda.synchronize()
    categories = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            cat = training_category(e.key)
            categories[cat] = categories.get(cat, 0.0) + e.self_device_time_total / 1e3
    busy = sum(categories.values())
    samples_per_s = 2 * chunk / (sum(step_ms["Adam"]) / len(step_ms["Adam"]) / 1e3)
    log(f"[training] {device_label}: flagship step split (Adam, ms): "
        + ", ".join(f"{k} {v:.1f}" for k, v in split.items())
        + f"; peak device memory {peak_gib:.2f} GiB at batch 2; {samples_per_s:.0f} samples/s "
        f"({samples_per_s / 44100:.2f} s of audio per second); device ms of one step by "
        f"category ({busy:.1f} busy): "
        + ", ".join(f"{k} {v:.1f} ({v / busy:.3f})" for k, v in
                    sorted(categories.items(), key=lambda kv: -kv[1])))
    del model, mix2, tgt2, opt, step, loss_fn
    torch.cuda.empty_cache()
    flagship_s = time.perf_counter() - t0

    # Part 3b: the flagship in bf16 (float32 masters).
    t0 = time.perf_counter()
    bf16 = phase_training_bf16(seed, device_label, cfg, cfg2, roformer, roformer_db, mix1, tgt1,
                               batch(rng, 2, cfg.num_stems, chunk), chunk)
    for name, n in bf16.pop("launches").items():
        path_launches[name] += n
    bf16_s = time.perf_counter() - t0

    # Part 4: the published HTDemucs at its training length.
    t0 = time.perf_counter()
    hcfg = htdemucs_full_config()
    htree = init_htdemucs_params(hcfg, seed=seed)
    n_src = len(hcfg.sources)
    hmix1, htgt1 = batch(rng, 1, n_src, hcfg.training_length)
    htdemucs_db = check_gradients(f"published HTDemucs, batch 1 of {hcfg.training_length}",
                                  hcfg, demucs, htree, hmix1, htgt1)
    model = demucs(hcfg, htree).cuda()
    hmix2, htgt2 = (t.cuda() for t in batch(rng, 2, n_src, hcfg.training_length))
    step = make_train_step(hcfg, model, torch.optim.Adam(model.parameters(), lr=1e-4))
    torch.cuda.reset_peak_memory_stats()
    _, ht_ms, total = timed_steps("published HTDemucs, batch 2, Adam", step, hmix2, htgt2, 3,
                                  HTDEMUCS_STEP_LAUNCHES)
    ht_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for name, n in total.items():
        path_launches[name] += n
    del model, step, hmix2, htgt2
    torch.cuda.empty_cache()
    # One HDemucs step on a 10 s segment (no kernel on its path).
    vcfg = hdemucs_full_config()
    model = demucs(vcfg, init_htdemucs_params(vcfg, seed=seed)).cuda()
    vmix, vtgt = (t.cuda() for t in batch(rng, 1, len(vcfg.sources), 441000))
    step = make_train_step(vcfg, model, torch.optim.Adam(model.parameters(), lr=1e-4))
    (v_loss,), v_ms, _ = timed_steps("hdemucs_mmi, batch 1 of 10 s, Adam", step, vmix, vtgt, 1,
                                     dict.fromkeys(ROFORMER_STEP_LAUNCHES, 0))
    del model, step, vmix, vtgt
    torch.cuda.empty_cache()
    log(f"[training] HTDemucs peak device memory {ht_peak:.2f} GiB at batch 2; parts: kernels "
        f"{t1 - t_phase:.1f} s, Functions {t2 - t1:.1f} s, flagship parity {parity_s:.1f} s, "
        f"flagship steps {flagship_s:.1f} s, flagship bf16 {bf16_s:.1f} s, HTDemucs and "
        f"HDemucs {time.perf_counter() - t0:.1f} s; phase {time.perf_counter() - t_phase:.1f} s")
    for result in (roformer_db, htdemucs_db):
        del result["card"], result["cpu"]
    return {"records": records, "launches": path_launches, "roformer_db": roformer_db,
            "htdemucs_db": htdemucs_db, "step_ms": step_ms, "split": split,
            "peak_gib": peak_gib, "htdemucs_ms": ht_ms, "hdemucs_ms": v_ms, "bf16": bf16}


def phase_training_bf16(seed, device_label, cfg, cfg2, build, f32, mix1, tgt1, batch2, chunk):
    """[training] part 3b, the flagship BS-RoFormer trained in bf16
    (``make_train_step(..., compute_dtype=torch.bfloat16)``, float32 master
    weights):

    * depth 2, batch 1 of 8 s: the card's bf16 step gradients against the
      card's float32 step (``f32``, part 3's), each within 6 dB of the CPU
      plain bf16 step's distance to the CPU float32 step, so the kernels add
      at most 6 dB to what bf16 rounding costs on the plain path; and the
      card's bf16 gradients once more with cuBLAS allowed to reduce bf16
      products in bf16 (``allow_bf16_reduced_precision_reduction`` on, the
      ``ops/precision.float32_bf16_reductions`` scopes taken out), to show
      whether that switch moves them;
    * depth 12, batch 2 of 8 s (``batch2``): 3 SGD and 3 Adam steps, each
      launching B1 24, B2 24 and the bf16 forms K1 24, K2 48, K3 24, K4 24
      times, with the step split (cast, forward + loss, backward, optimiser),
      peak device memory, device time by category and samples/s."""
    import contextlib
    import functools

    import torch
    from torch.profiler import ProfilerActivity, profile

    from audio_separator_tpu_torch import training
    from audio_separator_tpu_torch.models.init_params import init_roformer_params
    from audio_separator_tpu_torch.ops import block_backward
    from audio_separator_tpu_torch.ops.precision import float32_bf16_reductions, full_float32

    bf = torch.bfloat16
    tree2 = init_roformer_params(cfg2, seed=seed)
    t0 = time.perf_counter()
    loss_card, card = step_gradients(cfg2, build, tree2, mix1, tgt1, "cuda", bf)
    t_card = time.perf_counter() - t0
    loss_cpu, cpu = step_gradients(cfg2, build, tree2, mix1, tgt1, "cpu", bf)
    t_cpu = time.perf_counter() - t0 - t_card
    margins, failed = {}, []
    for k in card:
        card_db, cpu_db = grad_db(f32["card"][k], card[k]), grad_db(f32["cpu"][k], cpu[k])
        margins[k] = card_db - cpu_db
        if card_db < cpu_db - 6.0:
            failed.append((k, card_db, cpu_db))
    lowest = sorted(margins.items(), key=lambda kv: kv[1])[:3]
    card_dbs = [grad_db(f32["card"][k], card[k]) for k in card]
    log(f"[training] bf16 flagship BS-RoFormer, depth 2, batch 1 of 8 s: loss {loss_card:.6f} "
        f"(card) / {loss_cpu:.6f} (CPU plain); {len(card)} gradients, the card's bf16 step "
        f"against its float32 step: min {min(card_dbs):.2f} dB, median "
        f"{sorted(card_dbs)[len(card_dbs) // 2]:.2f} dB; card minus CPU-plain dB (bar -6): "
        f"min {min(margins.values()):.2f}, median "
        f"{sorted(margins.values())[len(margins) // 2]:.2f}, lowest "
        + ", ".join(f"{k} {v:.2f}" for k, v in lowest)
        + f"; card step {t_card:.2f} s (first, with set-up), CPU step {t_cpu:.1f} s")
    if not all(math.isfinite(v) for v in (loss_card, loss_cpu)):
        raise AssertionError("bf16 depth-2 step: loss not finite")
    if failed:
        raise AssertionError(f"bf16 gradients more than 6 dB under the CPU plain path's bf16 "
                             f"error: {failed}")
    del cpu

    # The reduction switch: the same bf16 step with cuBLAS allowed to reduce
    # bf16 products in bf16 (the scopes that hold it off taken out).
    matmul = torch.backends.cuda.matmul
    saved = (matmul.allow_bf16_reduced_precision_reduction, training.float32_bf16_reductions,
             block_backward.float32_bf16_reductions)
    try:
        matmul.allow_bf16_reduced_precision_reduction = True
        training.float32_bf16_reductions = block_backward.float32_bf16_reductions = (
            contextlib.nullcontext)
        _, reduced = step_gradients(cfg2, build, tree2, mix1, tgt1, "cuda", bf)
    finally:
        (matmul.allow_bf16_reduced_precision_reduction, training.float32_bf16_reductions,
         block_backward.float32_bf16_reductions) = saved
    switch_dbs = {k: grad_db(card[k], reduced[k]) for k in card}
    moved = {k: v for k, v in switch_dbs.items() if math.isfinite(v)}
    log(f"[training] allow_bf16_reduced_precision_reduction on against off (bf16 step, depth "
        f"2): {len(moved)} of {len(switch_dbs)} gradients moved"
        + (f"; their distance to the switch-off gradients min {min(moved.values()):.2f} dB, "
           f"median {sorted(moved.values())[len(moved) // 2]:.2f} dB (the bf16 step's own "
           f"distance to the float32 step: min {min(card_dbs):.2f} dB)" if moved else ""))
    del card, reduced

    # Full depth, batch 2: 3 SGD and 3 Adam bf16 steps through the entry point.
    model = build(cfg, init_roformer_params(cfg, seed=seed)).cuda()
    mix2, tgt2 = (t.cuda() for t in batch2)
    torch.cuda.reset_peak_memory_stats()
    launches = dict.fromkeys(ROFORMER_BF16_STEP_LAUNCHES, 0)
    step_ms, losses = {}, {}
    for opt_name, opt in (("SGD", torch.optim.SGD(model.parameters(), lr=1e-4)),
                          ("Adam", torch.optim.Adam(model.parameters(), lr=1e-4))):
        step = training.make_train_step(cfg, model, opt, compute_dtype=bf)
        losses[opt_name], step_ms[opt_name], total = timed_steps(
            f"bf16 flagship BS-RoFormer depth 12, batch 2 of 8 s, {opt_name}", step, mix2, tgt2,
            3, ROFORMER_BF16_STEP_LAUNCHES)
        for name, n in total.items():
            launches[name] += n
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in model.parameters()):
        raise AssertionError("the bf16 step left a master weight or its gradient not float32")
    # One more Adam step, split.
    split = {}

    def timed(part, fn):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        split[part] = (time.perf_counter() - start) * 1e3
        return out

    with tf32_switches_on(), full_float32(), float32_bf16_reductions():
        opt.zero_grad(set_to_none=True)
        cast = timed("cast", lambda: {n: p.to(bf) for n, p in model.named_parameters()})
        loss_fn = training.make_loss_fn(
            cfg, functools.partial(torch.func.functional_call, model, cast))
        loss = timed("forward + loss", lambda: loss_fn(mix2, tgt2))
        timed("backward", loss.backward)
        timed("optimiser", opt.step)
    del loss, cast
    with tf32_switches_on(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(mix2, tgt2)
        torch.cuda.synchronize()
    categories, by_kernel = {}, {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            cat = training_category(e.key)
            categories[cat] = categories.get(cat, 0.0) + e.self_device_time_total / 1e3
            name = e.key.replace("(anonymous namespace)::", "").split("(")[0][:60]
            by_kernel[name] = by_kernel.get(name, 0.0) + e.self_device_time_total / 1e3
    busy = sum(categories.values())
    mean_ms = sum(step_ms["Adam"]) / len(step_ms["Adam"])
    log("[training] bf16 step, the device ms of its ten largest kernels: "
        + "; ".join(f"{k} {v:.1f}" for k, v in
                    sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]))
    samples_per_s = 2 * chunk / (mean_ms / 1e3)
    log(f"[training] {device_label}: bf16 flagship step split (Adam, ms): "
        + ", ".join(f"{k} {v:.1f}" for k, v in split.items())
        + f"; peak device memory {peak_gib:.2f} GiB at batch 2; {samples_per_s:.0f} samples/s "
        f"({samples_per_s / 44100:.2f} s of audio per second); device ms of one step by "
        f"category ({busy:.1f} busy): "
        + ", ".join(f"{k} {v:.1f} ({v / busy:.3f})" for k, v in
                    sorted(categories.items(), key=lambda kv: -kv[1])))
    del model, mix2, tgt2, opt, step, loss_fn
    torch.cuda.empty_cache()
    return {"launches": launches, "step_ms": step_ms, "losses": losses, "split": split,
            "peak_gib": peak_gib, "busy_ms": busy, "categories": categories,
            "samples_per_s": samples_per_s, "gradient_margin_db": min(margins.values()),
            "switch_moved": len(moved)}


def phase_separator(ab, seed, seconds, device_label):
    """Phase 5, RoFormer: the default model through the user entry point."""
    from audio_separator_tpu_torch.separator import Separator

    work = os.path.join(REPO, "build")
    os.makedirs(work, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=work) as tmp:
        model_dir = os.path.join(tmp, "models")
        out_dir = os.path.join(tmp, "out")
        os.makedirs(model_dir)
        t0 = time.perf_counter()
        write_synthetic_model(model_dir, seed)
        write_s = time.perf_counter() - t0

        sr = 44100
        wav = os.path.join(tmp, "mix.wav")
        mix = write_seeded_wav(wav, seed, seconds, sr)

        ab.reset_launch_counts()
        t0 = time.perf_counter()
        sep = Separator(model_file_dir=model_dir, output_dir=out_dir, use_autocast=True,
                        log_level=logging.WARNING)
        sep.load_model()
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        files = sep.separate(wav)
        wall = time.perf_counter() - t0
        launches = dict(ab.LAUNCHES)

        check_stems(out_dir, files, 2, mix, sr)
        t0 = time.perf_counter()
        sep.separate(wav)
        wall2 = time.perf_counter() - t0
        profile_separate(sep, wav)
        log(f"[separator] {device_label}: {seconds:.0f} s stereo WAV, full-width "
            f"BS-RoFormer (bf16), stems {sorted(files)}: first separate {wall:.3f} s "
            f"({seconds / wall:.2f}x realtime), second {wall2:.3f} s "
            f"({seconds / wall2:.2f}x realtime); checkpoint write {write_s:.1f} s, "
            f"load_model {load_s:.1f} s; launches {launches}")
        if any(launches[name] == 0 for name in ("fused_attention_block", "fused_ff_block")):
            raise AssertionError(f"a kernel of the main path never launched: {launches}")

        # The Separator's default compute type is float32 (use_autocast=False).
        del sep
        sep32 = Separator(model_file_dir=model_dir, output_dir=out_dir,
                          log_level=logging.WARNING)
        sep32.load_model()
        t0 = time.perf_counter()
        sep32.separate(wav)
        wall32 = time.perf_counter() - t0
        t0 = time.perf_counter()
        sep32.separate(wav)
        wall32_2 = time.perf_counter() - t0
        log(f"[separator] {device_label}: same track, default float32: first separate "
            f"{wall32:.3f} s ({seconds / wall32:.2f}x realtime), second {wall32_2:.3f} s "
            f"({seconds / wall32_2:.2f}x realtime)")
        profile_separate(sep32, wav, tag="separator float32")
        surface = phase_user_surface(ab, sep32, model_dir, tmp, seed, seconds, device_label)
        return {"launches": launches, "wall_s": wall, "wall2_s": wall2, "surface": surface}


# ---------------------------------------------------------------------------
# [mesh]: the device mesh on the one card, as a 2 × 2 grid of cuda:0 handles.

MESH_FLOOR_DB = 100.0  # TP forward (float32) and meshed separate against the plain call
MESH_BF16_BAR_DB = 40.0  # the bf16 TP forward against the bf16 tp = 1 forward
PARTIAL_KERNELS = {
    "fused_attention_block_partial": ("audio_separator_tpu_torch/csrc/attention_block.cu",
                                      "audio_separator_tpu/ops/attention_block.py:35"),
    "fused_ff_block_partial": ("audio_separator_tpu_torch/csrc/ff_block.cu",
                               "audio_separator_tpu/ops/attention_block.py:119"),
}


def card_mesh(tp, handles=4):
    """A (handles / tp, tp) mesh over repeated handles of the one card."""
    import torch

    from audio_separator_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(devices=[torch.device("cuda", 0)] * handles, tp=tp)


def phase_mesh_kernels(ab, seed):
    """The partial-sum forms of B1 and B2 against their plain versions at the
    flagship's shard shapes (8 / tp heads, 2048 / tp hidden columns) for tp 2
    and 4, float32 (3xTF32, held to BLOCK_TOLERANCE) and bf16, timed as in
    phase 3."""
    import torch
    import torch.nn.functional as F

    from audio_separator_tpu_torch.models.roformer import _rope_tables
    from audio_separator_tpu_torch.ops.tf32 import prepare_tf32_weight
    from audio_separator_tpu_torch.parallel.mesh import wqkv_shard_columns

    dev = torch.device("cuda")
    d, h, dh, hidden = 512, 8, 64, 2048
    axes = {"time": (4 * 62, 801), "freq": (4 * 801, 62)}
    records = []
    for tp in (2, 4):
        hs, ws = h // tp, hidden // tp
        cols = torch.as_tensor(wqkv_shard_columns(h, dh, tp, 0), device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            elt = torch.finfo(dtype).bits // 8
            for axis, (b, n_valid) in axes.items():
                n_pad = -(-n_valid // 64) * 64
                g = torch.Generator(device=dev).manual_seed(seed)

                def randn(*shape, s=1.0):
                    return (torch.randn(*shape, generator=g, device=dev) * s).to(dtype)

                x = randn(b, n_pad, d)
                x[:, n_valid:] = 0
                # Shard 0 of a full layer: its heads' q, k, v columns and gates,
                # its rows of wo; its hidden columns of w1 and rows of w2.
                attn = dict(wqkv=randn(d, 3 * h * dh, s=0.05)[:, cols].contiguous(),
                            gate_w=randn(d, h, s=0.05)[:, :hs].contiguous(),
                            gate_b=randn(h, s=0.05)[:hs].contiguous(),
                            wo=randn(h * dh, d, s=0.05)[: hs * dh].contiguous(),
                            attn_norm=(1 + randn(d, s=0.1).float()).to(dtype))
                cos, sin = _rope_tables(n_valid, dh, dtype, dev)
                rope = (F.pad(cos, (0, 0, 0, n_pad - n_valid)),
                        F.pad(sin, (0, 0, 0, n_pad - n_valid)))
                ff = dict(ff_norm=(1 + randn(d, s=0.1).float()).to(dtype),
                          w1=randn(d, hidden, s=0.05)[:, :ws].contiguous(),
                          b1=randn(hidden, s=0.05)[:ws].contiguous(),
                          w2=randn(hidden, d, s=0.05)[:ws].contiguous(), b2=None)
                forms = {"fused_attention_block_partial": None, "fused_ff_block_partial": None}
                if dtype == torch.float32:
                    forms = {"fused_attention_block_partial": (prepare_tf32_weight(attn["wqkv"]),
                                                               prepare_tf32_weight(attn["wo"])),
                             "fused_ff_block_partial": (prepare_tf32_weight(ff["w1"]),
                                                        prepare_tf32_weight(ff["w2"]))}
                runs = {
                    "fused_attention_block_partial": (
                        lambda: ab.fused_attention_block(
                            x, rope=rope, heads=hs, n_valid=n_valid, partial=True,
                            tf32_weights=forms["fused_attention_block_partial"], **attn),
                        lambda: ab.fused_attention_block_ref(x, rope=rope, heads=hs,
                                                             n_valid=n_valid, partial=True,
                                                             **attn),
                        attention_cost(b, n_pad, n_valid, d, hs, dh, elt)),
                    "fused_ff_block_partial": (
                        lambda: ab.fused_ff_block(
                            x, partial=True, tf32_weights=forms["fused_ff_block_partial"], **ff),
                        lambda: ab.fused_ff_block_ref(x, partial=True, **ff),
                        ff_cost(b, n_pad, n_valid, d, ws, elt)),
                }
                for name, (kernel, plain, cost) in runs.items():
                    got = kernel()
                    torch.cuda.synchronize()
                    want = plain()
                    err = compare(got[:, :n_valid], want[:, :n_valid], dname, BLOCK_TOLERANCE)
                    del got, want
                    ms = cuda_time_ms(kernel, iters=5)
                    plain_ms = cuda_time_ms(plain, iters=2)
                    bound_ms, bound_by = bound(cost, dname)
                    rec = dict(name=name, tp=tp, dtype=dname, axis=axis, shape=[b, n_pad, d],
                               n_valid=n_valid, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by=bound_by, flop=cost[0], bytes=cost[1], **err)
                    extra = ""
                    if dtype == torch.float32:
                        t_ops, t_bytes = cost[0] / PEAK_3XTF32, cost[1] / PEAK_BYTES
                        rec["bound_3xtf32_ms"] = max(t_ops, t_bytes) * 1e3
                        rec["bound_3xtf32_by"] = "operations" if t_ops >= t_bytes else "bytes"
                        extra = (f"; 3xTF32 bound {rec['bound_3xtf32_ms']:.3f} ms "
                                 f"({rec['bound_3xtf32_by']})")
                    records.append(rec)
                    tol = BLOCK_TOLERANCE[dname]
                    log(f"[mesh] {name} tp {tp} ({hs} heads, {ws} hidden) {dname} {axis} "
                        f"x{(b, n_pad, d)} n_valid={n_valid}: max_abs_err={err['max_abs_err']:.3e} "
                        f"(rel {err['max_abs_err'] / err['scale']:.3e}, tol {tol['max']:.3e}) "
                        f"mean rel {err['mean_abs_err'] / err['scale']:.3e} (tol "
                        f"{tol['mean']:.3e}); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
                        f"{bound_ms:.3f} ms ({bound_by}){extra}")
                    if not err["ok"]:
                        raise AssertionError(f"{name} tp {tp} {dname} {axis}: kernel disagrees "
                                             f"with its plain version: {err}")
                del x, attn, ff, rope, forms
                torch.cuda.empty_cache()
    return records


def phase_mesh_forward(ab, seed):
    """The flagship BS-RoFormer at full width, tensor-parallel over the
    model axis of a mesh of the one card (tp 2 and 4), against its tp = 1
    forward: float32 >= MESH_FLOOR_DB, bf16 reported against a 40 dB bar;
    the partial forms launch 24 · tp times a forward and the full forms not
    at all. Returns the float32 tp = 2 launches (the kernels line's)."""
    import numpy as np
    import torch

    from audio_separator_tpu_torch.models.convert import load_jax_params
    from audio_separator_tpu_torch.models.init_params import flagship_config, init_roformer_params
    from audio_separator_tpu_torch.models.roformer import Roformer
    from audio_separator_tpu_torch.parallel.mesh import shard_roformer_params

    cfg = flagship_config()
    tree = init_roformer_params(cfg, seed=seed)
    chunk = cfg.stft_hop_length * 800
    audio = torch.from_numpy((np.random.default_rng(seed).standard_normal((1, 2, chunk)) * 0.2)
                             .astype(np.float32)).cuda()
    layers = cfg.depth * (cfg.time_transformer_depth + cfg.freq_transformer_depth)
    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        model = load_jax_params(Roformer(cfg), tree).to(device="cuda", dtype=dtype).eval()
        with torch.no_grad():
            base = model(audio).float()
            base_ms = cuda_time_ms(lambda: model(audio), iters=2)
            for tp in (2, 4):
                sharded = shard_roformer_params(model, card_mesh(tp))
                sharded(audio)  # the shards' 3xTF32 forms are made at first use
                torch.cuda.synchronize()
                ab.reset_launch_counts()
                out = sharded(audio).float()
                torch.cuda.synchronize()
                launches = dict(ab.LAUNCHES)
                tp_ms = cuda_time_ms(lambda: sharded(audio), iters=2)
                db = sdr_db(base.cpu(), out.cpu())
                want = {"fused_attention_block_partial": layers * tp,
                        "fused_ff_block_partial": layers * tp,
                        "fused_attention_block": 0, "fused_ff_block": 0}
                log(f"[mesh] flagship BS-RoFormer {dname}, tp {tp} over {tp} handles of the "
                    f"card, one 8 s window: {db:.2f} dB against the tp 1 forward ("
                    + (f"floor {MESH_FLOOR_DB}" if dtype == torch.float32
                       else f"bar {MESH_BF16_BAR_DB}, reported") + f"); forward {tp_ms:.1f} ms "
                    f"against {base_ms:.1f} ms at tp 1; launches "
                    + ", ".join(f"{k} {launches[k]}" for k in want) + f" (expected {want})")
                if not bool(torch.isfinite(out).all()):
                    raise AssertionError(f"tp {tp} {dname} forward is not finite")
                if dtype == torch.float32 and db < MESH_FLOOR_DB:
                    raise AssertionError(f"tp {tp} float32 forward {db:.2f} dB below "
                                         f"{MESH_FLOOR_DB} against tp 1")
                if any(launches[k] != v for k, v in want.items()):
                    raise AssertionError(f"tp {tp} {dname} launches {launches}, expected {want}")
                result[dname, tp] = {"db": db, "ms": tp_ms, "base_ms": base_ms,
                                     "launches": launches}
                del sharded, out
                torch.cuda.empty_cache()
        del model, base
        torch.cuda.empty_cache()
    return result


def phase_mesh_separate(ab, seed, seconds, device_label):
    """``Separator(use_mesh=<2 × 2 mesh of the card>)`` against the plain
    ``Separator`` on the same 30 s WAV, for the flagship BS-RoFormer and the
    published HTDemucs: stems >= MESH_FLOOR_DB, walls side by side, the
    mesh's rows launching the full forms; then ``use_mesh=True`` on the one
    card takes the plain path and says so."""
    import numpy as np

    from audio_separator_tpu_torch.io import audio as audio_io
    from audio_separator_tpu_torch.ops import _build
    from audio_separator_tpu_torch.separator import Separator

    work = os.path.join(REPO, "build")
    os.makedirs(work, exist_ok=True)
    result = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=work) as tmp:
        model_dir = os.path.join(tmp, "models")
        os.makedirs(model_dir)
        write_synthetic_model(model_dir, seed)
        write_synthetic_demucs_bag(model_dir, seed)
        wav = os.path.join(tmp, "mix.wav")
        mix = write_seeded_wav(wav, seed, seconds, bit_depth=32)
        mesh = card_mesh(2)
        for label, model, count in (("flagship BS-RoFormer", None, 2),
                                    ("HTDemucs", "htdemucs.yaml", 4)):
            stems, walls, launches = {}, {}, {}
            for run, use_mesh in (("plain", False), ("mesh", mesh)):
                out_dir = os.path.join(tmp, f"{run}_{len(result)}")
                sep = Separator(model_file_dir=model_dir, output_dir=out_dir,
                                use_mesh=use_mesh, log_level=logging.WARNING)
                sep.load_model(*(() if model is None else (model,)))
                sep.separate(wav)  # warm
                _build.reset_launch_counts()
                t0 = time.perf_counter()
                files = sep.separate(wav)
                walls[run] = time.perf_counter() - t0
                launches[run] = {k: v for k, v in
                                 launches_to_compare(dict(_build.LAUNCHES)).items() if v}
                check_stems(out_dir, files, count, mix, 44100)
                stems[run] = {os.path.basename(f): audio_io.load_audio(os.path.join(out_dir, f))[0]
                              for f in files}
                del sep
            worst = min(sdr_db(stems["plain"][f], stems["mesh"][f]) for f in stems["plain"])
            same = all(np.array_equal(stems["plain"][f], stems["mesh"][f]) for f in stems["plain"])
            log(f"[mesh] {device_label}: Separator over a dp 2 x tp 2 mesh of the card, "
                f"{label}, {seconds:.0f} s WAV: worst stem "
                + ("bit-identical to" if same else f"{worst:.2f} dB against")
                + f" the plain call (floor {MESH_FLOOR_DB}); warm wall {walls['mesh']:.3f} s against "
                f"{walls['plain']:.3f} s plain; launches {launches['mesh']} (plain "
                f"{launches['plain']})")
            if sorted(stems["mesh"]) != sorted(stems["plain"]) or worst < MESH_FLOOR_DB:
                raise AssertionError(f"{label}: meshed stems differ from the plain call "
                                     f"({worst:.2f} dB)")
            # Each row's slice is a forward of its own: up to one more forward a
            # batch than the plain call's, and never a partial form.
            rows = mesh.local_rows
            if (set(launches["mesh"]) != set(launches["plain"])
                    or any(not launches["plain"][k] <= n <= rows * launches["plain"][k]
                           for k, n in launches["mesh"].items())):
                raise AssertionError(f"{label}: the mesh launched {launches['mesh']}, the plain "
                                     f"call {launches['plain']}")
            result[label] = {"db": worst, "identical": same, "walls": walls,
                             "launches": launches["mesh"]}

        records = []

        class Keep(logging.Handler):
            def emit(self, record):
                records.append(record.getMessage())

        keep = Keep(level=logging.DEBUG)
        sep = Separator(model_file_dir=model_dir, output_dir=os.path.join(tmp, "true"),
                        use_mesh=True, log_level=logging.DEBUG)
        sep.logger.addHandler(keep)
        try:
            sep.load_model()
        finally:
            sep.logger.removeHandler(keep)
            sep.logger.setLevel(logging.WARNING)
        said = [r for r in records if "only one device present" in r]
        log(f"[mesh] Separator(use_mesh=True) on {device_label}: mesh "
            f"{sep.model_instance.mesh}; said: {said}")
        if sep.model_instance.mesh is not None or not said:
            raise AssertionError("use_mesh=True on one card did not take the plain path "
                                 "or did not say so")
        del sep
    return result


def phase_mesh_training(ab, seed):
    """One flagship step at depth 2 on a dp 2 × tp 2 mesh of the card (batch
    2 of 8 s windows), its gradients, gathered, against the tp 1 step's on
    the same batch (>= GRADIENT_FLOOR_DB each, or within 6 dB of the card's
    own spread, the same step on the batch twice, where a gradient is not
    reproducible to the floor)."""
    import copy
    import dataclasses

    import numpy as np
    import torch

    from audio_separator_tpu_torch.models.convert import load_jax_params
    from audio_separator_tpu_torch.models.init_params import flagship_config, init_roformer_params
    from audio_separator_tpu_torch.models.roformer import Roformer
    from audio_separator_tpu_torch.ops import _build
    from audio_separator_tpu_torch.parallel.mesh import gather_params, shard_model
    from audio_separator_tpu_torch.training import make_train_step

    cfg = dataclasses.replace(flagship_config(), depth=2)
    tree = init_roformer_params(cfg, seed=seed)
    rng = np.random.default_rng(seed)
    chunk = cfg.stft_hop_length * 800
    mix = rng.standard_normal((2, 2, chunk)).astype(np.float32) * 0.2
    tgt = 0.5 * rng.standard_normal((2, 2, 2, chunk)).astype(np.float32) * 0.2 + 0.5 * mix[:, None]
    mix, tgt = torch.from_numpy(mix).cuda(), torch.from_numpy(tgt).cuda()

    def grads(mesh, batch=1, dtype=torch.float32):
        model = load_jax_params(Roformer(cfg), tree).cuda()
        if mesh is not None:
            model = shard_model(model, mesh)
        step = make_train_step(cfg, model, torch.optim.SGD(model.parameters(), lr=0.0),
                               mesh=mesh, compute_dtype=dtype)
        _build.reset_launch_counts()
        with tf32_switches_on():
            t0 = time.perf_counter()
            loss = float(step(torch.cat([mix] * batch), torch.cat([tgt] * batch)))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        holder = copy.deepcopy(model)  # the gradients in the parameters' places, then gathered
        with torch.no_grad():
            for p_holder, p in zip(holder.parameters(), model.parameters()):
                p_holder.copy_(p.grad)
        full = gather_params(holder)
        out = {n: p.detach().cpu() for n, p in full.named_parameters()}
        del model, step, holder, full
        torch.cuda.empty_cache()
        return loss, out, ms, launches

    loss1, g1, ms1, _ = grads(None)
    loss_tp, g_tp, ms_tp, launches = grads(card_mesh(2))
    dbs = {k: grad_db(g1[k], g_tp[k]) for k in g1}
    low = {k: v for k, v in dbs.items() if v < GRADIENT_FLOOR_DB}
    failed = []
    if low:
        _, twice, _, _ = grads(None, batch=2)
        for k, v in low.items():
            spread = grad_db(g1[k], twice[k])
            if v < min(GRADIENT_FLOOR_DB, spread - 6.0):
                failed.append((k, v, spread))
    log(f"[mesh] flagship BS-RoFormer depth 2, one step on batch 2 of 8 s over a dp 2 x tp 2 "
        f"mesh of the card: loss {loss_tp:.6f} against {loss1:.6f} at tp 1; {len(dbs)} "
        f"gradients against the tp 1 step: min {min(dbs.values()):.2f} dB, median "
        f"{sorted(dbs.values())[len(dbs) // 2]:.2f} dB (floor {GRADIENT_FLOOR_DB}); below it "
        f"{low}; step {ms_tp:.0f} ms against {ms1:.0f} ms (first steps, with set-up); "
        f"launches {launches}")
    if not (math.isfinite(loss_tp) and abs(loss_tp - loss1) <= 1e-4 * abs(loss1)):
        raise AssertionError(f"sharded loss {loss_tp} against {loss1}")
    if failed:
        raise AssertionError(f"sharded gradients below {GRADIENT_FLOOR_DB} dB: {failed}")
    if not (launches.get("fused_attention_block_partial") and launches.get("fused_ff_block_partial")
            and not launches.get("fused_attention_block")):
        raise AssertionError(f"the sharded step did not run the partial forms: {launches}")

    # bf16: the sharded step's gathered gradients against the tp 1 float32
    # step's, each within 6 dB of the tp 1 bf16 step's own distance to it.
    loss16, g16, ms16, _ = grads(None, dtype=torch.bfloat16)
    loss16_tp, g16_tp, ms16_tp, launches16 = grads(card_mesh(2), dtype=torch.bfloat16)
    margins = {k: grad_db(g1[k], g16_tp[k]) - grad_db(g1[k], g16[k]) for k in g1}
    failed16 = {k: v for k, v in margins.items() if v < -6.0}
    db16 = [grad_db(g1[k], g16_tp[k]) for k in g1]
    log(f"[mesh] bf16 flagship BS-RoFormer depth 2, one step on batch 2 of 8 s over a dp 2 x "
        f"tp 2 mesh of the card: loss {loss16_tp:.6f} against {loss16:.6f} at tp 1 bf16 and "
        f"{loss1:.6f} at tp 1 float32; gradients against the tp 1 float32 step: min "
        f"{min(db16):.2f} dB, median {sorted(db16)[len(db16) // 2]:.2f} dB; minus the tp 1 bf16 "
        f"step's (bar -6): min {min(margins.values()):.2f}, median "
        f"{sorted(margins.values())[len(margins) // 2]:.2f}; step {ms16_tp:.0f} ms against "
        f"{ms16:.0f} ms at tp 1 (first steps, with set-up); launches {launches16}")
    if not math.isfinite(loss16_tp):
        raise AssertionError(f"sharded bf16 loss {loss16_tp}")
    if failed16:
        raise AssertionError(f"sharded bf16 gradients more than 6 dB under the tp 1 bf16 "
                             f"step's: {failed16}")
    if not (launches16.get("fused_attention_block_partial")
            and launches16.get("attention_backward_bf16")
            and not launches16.get("attention_backward")):
        raise AssertionError(f"the sharded bf16 step did not run the partial forms and the "
                             f"bf16 backward forms: {launches16}")
    return {"min_db": min(dbs.values()), "launches": launches,
            "bf16_margin_db": min(margins.values()), "bf16_launches": launches16}


def phase_mesh(ab, seed, seconds, device_label):
    """[mesh]: the partial forms, the TP forward, the meshed Separator and the
    sharded step, with the model cache emptied first."""
    import torch

    from audio_separator_tpu_torch.ops import fn_cache

    fn_cache.clear()
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    records = phase_mesh_kernels(ab, seed)
    t1 = time.perf_counter()
    forward = phase_mesh_forward(ab, seed)
    t2 = time.perf_counter()
    separate = phase_mesh_separate(ab, seed, seconds, device_label)
    t3 = time.perf_counter()
    training = phase_mesh_training(ab, seed)
    log(f"[mesh] parts: kernels {t1 - t0:.1f} s, TP forward {t2 - t1:.1f} s, Separator "
        f"{t3 - t2:.1f} s, training {time.perf_counter() - t3:.1f} s")
    return {"records": records, "forward": forward, "separate": separate, "training": training}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--seconds", type=float, default=30.0)
    parser.add_argument("--phase", choices=("all", "remote", "training", "mesh"), default="all",
                        help="'remote', 'training' or 'mesh' builds the kernels and runs that "
                             "phase alone; it prints no result line")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from audio_separator_tpu_torch.ops import _build
    from audio_separator_tpu_torch.ops import attention as att
    from audio_separator_tpu_torch.ops import attention_block as ab

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    log(smi)
    log(f"[card] torch.cuda: {kind}, {torch.cuda.device_count()} device(s); "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    reports = _build.build_kernels()
    log(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)} in {time.perf_counter() - t0:.1f} s")
    for name, report in reports.items():
        log(f"[build] {_build.library_path(name)} from "
            f"{os.path.relpath(os.path.join(_build.CSRC_DIR, _build.KERNEL_SOURCES[name]), REPO)}")
        for line in report.splitlines():
            # C75xx: ptxas serialised a wgmma pipeline (Potential Performance Loss)
            if any(k in line for k in ("Compiling entry", "registers", "spill", "smem", "C75")):
                log(f"[ptxas] {name}: {line.strip()}")

    if args.phase == "remote":
        t0 = time.perf_counter()
        phase_remote(args.seed, args.seconds, f"{kind} ({smi})")
        log(f"[remote] phase {time.perf_counter() - t0:.1f} s; no other phase was run")
        return 0
    if args.phase == "training":
        phase_training(args.seed, f"{kind} ({smi})")
        log("[training] no other phase was run")
        return 0
    if args.phase == "mesh":
        t0 = time.perf_counter()
        phase_mesh(ab, args.seed, args.seconds, f"{kind} ({smi})")
        log(f"[mesh] phase {time.perf_counter() - t0:.1f} s; no other phase was run")
        return 0

    records = phase_kernels(ab, args.seed) + phase_attention_kernel(att, args.seed)
    gn_records, gn_forward = phase_group_norm_kernel(args.seed)
    model = phase_model(ab, args.seed)
    htdemucs = phase_htdemucs_model(att, args.seed)
    phase_mdx23c_model(args.seed)
    phase_codec(args.seed)
    sep = phase_separator(ab, args.seed, args.seconds, f"{kind} ({smi})")
    demucs = phase_demucs_separator(att, args.seed, args.seconds, f"{kind} ({smi})")
    phase_mdx23c_separator(args.seed, args.seconds, f"{kind} ({smi})")
    work = os.path.join(REPO, "build")
    os.makedirs(work, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=work) as tmp:
        mdx_dir = os.path.join(tmp, "models")
        os.makedirs(mdx_dir)
        phase_mdx_model(args.seed, mdx_dir)
        phase_mdx_separator(ab, att, args.seed, args.seconds, mdx_dir, f"{kind} ({smi})")
    phase_vr(ab, att, args.seed, args.seconds, f"{kind} ({smi})")
    phase_demucs_v3(args.seed, f"{kind} ({smi})")
    ensemble = phase_ensemble(args.seed, args.seconds, f"{kind} ({smi})")
    t0 = time.perf_counter()
    remote = phase_remote(args.seed, args.seconds, f"{kind} ({smi})")
    log(f"[remote] phase {time.perf_counter() - t0:.1f} s")
    training = phase_training(args.seed, f"{kind} ({smi})")
    t0 = time.perf_counter()
    mesh = phase_mesh(ab, args.seed, args.seconds, f"{kind} ({smi})")
    log(f"[mesh] phase {time.perf_counter() - t0:.1f} s")

    # name -> (source, TPU kernel, its main path's run, that path's dtype,
    #          launches per forward of its model)
    sources = {"fused_attention_block": ("audio_separator_tpu_torch/csrc/attention_block.cu",
                                         "audio_separator_tpu/ops/attention_block.py:35",
                                         sep, "bfloat16", model["launches"]),
               "fused_ff_block": ("audio_separator_tpu_torch/csrc/ff_block.cu",
                                  "audio_separator_tpu/ops/attention_block.py:119",
                                  sep, "bfloat16", model["launches"]),
               "fused_attention": ("audio_separator_tpu_torch/csrc/attention.cu",
                                   "audio_separator_tpu/ops/attention.py:39",
                                   demucs, "float32", {"fused_attention": htdemucs["launches"]})}
    kernels = []
    for name, (source, replaces, path_run, path_dtype, per_forward) in sources.items():
        # Headline numbers: the main path's dtype, per launch, averaged over
        # the time- and frequency-axis shapes (one forward launches each
        # kernel equally often on both).
        main = [r for r in records
                if r["name"] == name and r["dtype"] == path_dtype and "ms" in r
                and r["axis"] in ("time", "freq")]
        library = [r["library_ms"] for r in main if r.get("library_ms") is not None]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": path_run["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in main),
            "ms": sum(r["ms"] for r in main) / len(main),
            "plain_ms": sum(r["plain_ms"] for r in main) / len(main),
            "bound_ms": sum(r["bound_ms"] for r in main) / len(main),
            "bound_by": main[0]["bound_by"],
            "library_ms": sum(library) / len(library) if library else None,
            "cases": [{k: r.get(k) for k in ("dtype", "axis", "shape", "n_valid", "ms",
                                              "plain_ms", "library_ms", "bound_ms", "bound_by",
                                              "bound_3xtf32_ms", "attention_library_ms",
                                              "max_abs_err", "mean_abs_err", "scale", "split")}
                      for r in records if r["name"] == name],
            "model_launches_per_forward": per_forward[name],
            "ensemble_launches": ensemble["launches"][name],
            "remote_launches": remote["launches"][name],
            "training_launches": training["launches"][name],
        })
    # The GroupNorm kernel: the main path is the Demucs separator's; headline
    # numbers per launch, averaged over one HTDemucs forward's launches.
    timed = [r for r in gn_records if r["per_forward"]]
    kernels.append({
        "name": "group_norm", "route": "cuda",
        "source": "audio_separator_tpu_torch/csrc/group_norm.cu",
        "replaces": None, "launches": demucs["launches"]["group_norm"],
        "max_abs_err": max(r["max_abs_err"] for r in gn_records),
        **{key: gn_forward[key] / HTDEMUCS_GROUP_NORMS_PER_FORWARD
           for key in ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms")},
        "bound_by": "bytes",
        "forward": gn_forward,
        "cases": [{k: r.get(k) for k in ("axis", "shape", "groups", "epilogue", "channel_last",
                                          "per_forward", "splits", "ms", "device_ms", "plain_ms",
                                          "library_ms", "bound_ms", "bytes", "max_abs_err",
                                          "mean_abs_err", "scale", "split")}
                  for r in gn_records],
        "model_launches_per_forward": sum(r["per_forward"] for r in timed),
        "ensemble_launches": ensemble["launches"]["group_norm"],
        "remote_launches": remote["launches"]["group_norm"],
        "training_launches": training["launches"].get("group_norm", 0),
    })
    # The backward kernels: the main path is the [training] phase's steps
    # (flagship and HTDemucs); headline numbers over the flagship's two axes.
    for name, (source, replaces) in BACKWARD_KERNELS.items():
        cases = [r for r in training["records"] if r["name"] == name and r["dtype"] == "float32"]
        main = [r for r in cases if r["axis"] in ("time", "freq")]
        library = [r["library_ms"] for r in main if r["library_ms"] is not None]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": training["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in cases),
            "ms": sum(r["ms"] for r in main) / len(main),
            "plain_ms": sum(r["plain_ms"] for r in main) / len(main),
            "bound_ms": sum(r["bound_ms"] for r in main) / len(main),
            "bound_by": main[0]["bound_by"],
            "library_ms": sum(library) / len(library) if library else None,
            "cases": [{k: r.get(k) for k in ("dtype", "axis", "shape", "n_valid", "ms",
                                              "plain_ms", "library_ms", "library_note",
                                              "bound_ms", "bound_by", "bound_3xtf32_ms",
                                              "bound_fma_ms",
                                              "max_abs_err", "rel_errs", "split")}
                      for r in cases],
            "launches_per_roformer_step": ROFORMER_STEP_LAUNCHES[name],
            "launches_per_htdemucs_step": HTDEMUCS_STEP_LAUNCHES[name],
        })
    # Their bf16 forms: the main path is the [training] phase's bf16 flagship
    # steps; headline numbers over the flagship's two axes, bf16 cases.
    for name, (float_name, source) in BF16_BACKWARD_KERNELS.items():
        main = [r for r in training["records"]
                if r["name"] == float_name and r["dtype"] == "bfloat16"]
        library = [r["library_ms"] for r in main if r["library_ms"] is not None]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": BACKWARD_KERNELS[float_name][1],
            "launches": training["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in main),
            "ms": sum(r["ms"] for r in main) / len(main),
            "plain_ms": sum(r["plain_ms"] for r in main) / len(main),
            "bound_ms": sum(r["bound_ms"] for r in main) / len(main),
            "bound_by": main[0]["bound_by"],
            "library_ms": sum(library) / len(library) if library else None,
            "cases": [{k: r.get(k) for k in ("dtype", "axis", "shape", "n_valid", "ms",
                                              "plain_ms", "library_ms", "library_note",
                                              "bound_ms", "bound_by", "max_abs_err", "rel_errs",
                                              "split")}
                      for r in main],
            "launches_per_bf16_roformer_step": ROFORMER_BF16_STEP_LAUNCHES[name],
            "mesh_bf16_step_launches": mesh["training"]["bf16_launches"].get(name, 0),
        })
    # The partial-sum forms: the main path is [mesh]'s float32 flagship
    # forward at tp 2; headline numbers at tp 2 in float32 over both axes,
    # against the 3xTF32 bound of the products they run (the FMA bound, 67
    # TFLOP/s, is each case's bound_ms).
    for name, (source, replaces) in PARTIAL_KERNELS.items():
        cases = [r for r in mesh["records"] if r["name"] == name]
        main = [r for r in cases if r["tp"] == 2 and r["dtype"] == "float32"]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": mesh["forward"]["float32", 2]["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in main),
            "ms": sum(r["ms"] for r in main) / len(main),
            "plain_ms": sum(r["plain_ms"] for r in main) / len(main),
            "bound_ms": sum(r["bound_3xtf32_ms"] for r in main) / len(main),
            "bound_by": main[0]["bound_3xtf32_by"],
            "library_ms": None,
            "cases": [{k: r.get(k) for k in ("tp", "dtype", "axis", "shape", "n_valid", "ms",
                                              "plain_ms", "bound_ms", "bound_by",
                                              "bound_3xtf32_ms", "bound_3xtf32_by",
                                              "max_abs_err", "mean_abs_err", "scale")}
                      for r in cases],
            "launches_per_forward": {f"{d} tp {tp}": v["launches"][name]
                                     for (d, tp), v in mesh["forward"].items()},
            "training_launches": mesh["training"]["launches"].get(name, 0),
        })
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
