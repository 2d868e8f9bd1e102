"""The kernel loader shared by every CUDA kernel of the package, and the one
table of launch counts.

Each source under ``csrc/`` is compiled by ``nvcc`` for sm_90a into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), linked against ``libcuda`` (``cuTensorMapEncodeTiled``, which encodes
the TMA tensor maps, lives there) and loaded with ``ctypes`` at first use:
nothing is compiled or loaded
until a wrapper launches or :func:`build_kernels` is called.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

import torch

from ..utils import tracing

# Launch counters: each wrapper adds one for its kernel (chain), through
# launch() (or count()), under one lock: jobs of a server launch from several
# threads. The backward kernels' bf16 forms count under names of their own
# (``_bf16``); ``group_norm_split`` counts the GroupNorm launches whose rows
# were split over several blocks (``ops/group_norm.py``).
LAUNCHES: Dict[str, int] = {"fused_attention_block": 0, "fused_ff_block": 0,
                            "fused_attention_block_partial": 0,
                            "fused_ff_block_partial": 0, "fused_attention": 0, "attention_backward": 0,
                            "rmsnorm_backward": 0, "gelu_backward": 0,
                            "rope_gate_backward": 0, "attention_backward_bf16": 0,
                            "rmsnorm_backward_bf16": 0, "gelu_backward_bf16": 0,
                            "rope_gate_backward_bf16": 0, "group_norm": 0, "group_norm_split": 0}
_count_lock = threading.Lock()


def count(name: str) -> None:
    """Add one launch of kernel ``name``."""
    with _count_lock:
        LAUNCHES[name] += 1


class launch:
    """``with launch(name, **attrs):`` around all of a wrapper's device work
    for kernel ``name`` (its inputs made contiguous, padding, the chain): one
    launch counted in :data:`LAUNCHES` when the block ends without an
    exception, as :func:`count`; while spans are on (``utils/tracing.py``),
    the profiler range ``kernel.<name>`` around the block, so that a trace
    gives the wrapper's device time. With ``attrs`` (the call's sizes) the
    range is a span that also keeps a record of them; without, no record is
    kept."""

    __slots__ = ("name", "attrs", "_range")

    def __init__(self, name: str, **attrs):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        self._range = (tracing.span("kernel." + self.name, **self.attrs) if self.attrs
                       else tracing.profiler_range("kernel." + self.name))
        self._range.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._range.__exit__(exc_type, exc, tb)
        if exc_type is None:
            count(self.name)
        return False


def reset_launch_counts() -> None:
    with _count_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lcuda")

_P = ctypes.c_void_p
_I = ctypes.c_int
# library name -> source file under csrc/, and -> (entry point, ctypes argtypes)
KERNEL_SOURCES = {"attention_block": "attention_block.cu",
                  "ff_block": "ff_block.cu",
                  "attention": "attention.cu",
                  "attention_bwd": "attention_bwd.cu",
                  "norm_bwd": "norm_bwd.cu",
                  "gelu_bwd": "gelu_bwd.cu",
                  "rope_gate_bwd": "rope_gate_bwd.cu",
                  "group_norm": "group_norm.cu"}
_SIGNATURES = {
    "attention_block": ("asep_attention_block",
                        [_I] + [_P] * 15 + [_I] * 6 + [_P]),
    "ff_block": ("asep_ff_block", [_I] + [_P] * 9 + [_I] * 4 + [_P]),
    "attention": ("asep_attention",
                  [_I] + [_P] * 4 + [_I] * 3 + [ctypes.c_float, _P]),
    "attention_bwd": ("asep_attention_bwd",
                      [_I, _I] + [_P] * 11 + [_I] * 5 + [ctypes.c_float, _P]),
    "norm_bwd": ("asep_norm_bwd", [_I] + [_P] * 7 + [_I] * 3 + [_P]),
    "gelu_bwd": ("asep_gelu_bwd", [_I] + [_P] * 4 + [ctypes.c_longlong, _P]),
    "rope_gate_bwd": ("asep_rope_gate_bwd", [_I] + [_P] * 9 + [_I] * 3 + [_P]),
    "group_norm": ("asep_group_norm",
                   [_P] * 7 + [_I] * 7 + [ctypes.c_longlong] + [_I] * 2 + [ctypes.c_float, _P]),
}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_libs: Dict[str, ctypes.CDLL] = {}
_lib_lock = threading.Lock()


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the CUDA "
        "kernels are compiled from audio_separator_tpu_torch/csrc at first "
        "use and need the CUDA toolkit")


def _sources_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fn in sorted(os.listdir(CSRC_DIR)):
        if fn.endswith((".cu", ".cuh")):
            h.update(fn.encode())
            with open(os.path.join(CSRC_DIR, fn), "rb") as f:
                h.update(f.read())
    return h.hexdigest()[:16]


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"{name}-{_sources_digest()}.so")


def build_kernels() -> Dict[str, str]:
    """Compile every kernel library not built yet for these
    sources, one nvcc per source, all started together. Returns
    ``{name: ptxas report}``.

    Outputs are keyed on a hash of the sources and flags and written under a
    temporary name, then renamed, so concurrent processes never see a partial
    library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    pending = {}
    for name, src in KERNEL_SOURCES.items():
        lib = library_path(name)
        if not os.path.exists(lib):
            tmp = f"{lib}.{os.getpid()}.tmp"
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
                   os.path.join(CSRC_DIR, src)]
            pending[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, lib)
    failures = []
    for name, (proc, tmp, lib) in pending.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}:\n{report}")
            continue
        with open(f"{tmp}.log", "w") as f:
            f.write(report)
        os.replace(f"{tmp}.log", f"{lib}.log")
        os.replace(tmp, lib)
    if failures:
        raise RuntimeError("\n".join(failures))
    reports = {}
    for name in KERNEL_SOURCES:
        log = f"{library_path(name)}.log"
        reports[name] = open(log).read() if os.path.exists(log) else ""
    return reports


def load(name: str) -> ctypes.CDLL:
    with _lib_lock:
        lib = _libs.get(name)
        if lib is None:
            build_kernels()
            lib = ctypes.CDLL(library_path(name))
            fn_name, argtypes = _SIGNATURES[name]
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            lib.asep_error_string.argtypes = [ctypes.c_int]
            lib.asep_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
    return lib


def check_rc(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{what}: CUDA error {rc} ({lib.asep_error_string(rc).decode()})")


def check_cuda_layout(*tensors: torch.Tensor) -> None:
    """The operands the kernels read and write in 16-byte vectors or through
    TMA tensor maps: both need a 16-byte aligned base."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("kernel operands must be 16-byte aligned")


def device_kind(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device} (cpu or cuda)")
    return x.device.type


def stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream
