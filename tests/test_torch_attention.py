"""The port's whole-sequence attention (the plain version, which CPU tensors
take) against the JAX package's einsum path and its Pallas kernel in
interpret mode; the dispatch; the CUDA source's entry point against the
ctypes signature.

Tolerances: float32 atol 2e-5, as tests/test_attention.py holds the Pallas
kernel to the einsum path; bf16 within two bf16 steps (2·2⁻⁸) of the output
scale, since both sides round the softmax weights and the result to bf16 and
may land on neighbouring values."""

import contextlib
import ctypes
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_separator_tpu.ops.attention import _einsum_attention, _pallas_fused_attention
from audio_separator_tpu_torch.ops import _build
from audio_separator_tpu_torch.ops import attention as att
from audio_separator_tpu_torch.utils import tracing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _qkv(b, h, n, d, seed=0):
    rng = np.random.default_rng(seed)
    return tuple((rng.standard_normal((b, h, n, d)) * 0.5).astype(np.float32)
                 for _ in range(3))


@pytest.mark.parametrize("scale", [None, 0.3])
@pytest.mark.parametrize("d", [8, 48, 64])
@pytest.mark.parametrize("n", [16, 62, 173, 256])
def test_attention_plain_matches_jax_einsum(n, d, scale):
    q, k, v = _qkv(2, 3, n, d, seed=n + d)
    got = att.dot_product_attention(*(torch.from_numpy(t) for t in (q, k, v)),
                                    scale=scale).numpy()
    want = np.asarray(_einsum_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        scale if scale is not None else d ** -0.5))
    assert got.shape == want.shape == (2, 3, n, d)
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("scale", [None, 0.3])
@pytest.mark.parametrize("n", [16, 62, 173, 256])
def test_attention_plain_matches_interpreted_pallas_kernel(n, scale):
    q, k, v = _qkv(2, 4, n, 64, seed=n)
    s = scale if scale is not None else 0.125
    got = att.attention_ref(*(torch.from_numpy(t) for t in (q, k, v)), s).numpy()
    want = np.asarray(_pallas_fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                              s, group=2, interpret=True))
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("reference", ["einsum", "pallas"])
def test_attention_plain_bf16_tracks_jax_bf16(reference):
    q, k, v = _qkv(2, 4, 173, 64, seed=7)
    got = att.dot_product_attention(
        *(torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v))).float().numpy()
    jq, jk, jv = (jnp.asarray(t, jnp.bfloat16) for t in (q, k, v))
    if reference == "einsum":
        want = _einsum_attention(jq, jk, jv, 0.125)
    else:
        want = _pallas_fused_attention(jq, jk, jv, 0.125, group=1, interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 2 * 2.0 ** -8 * scale


def test_attention_plain_takes_unequal_lengths():
    """The plain version is the einsum path, which also serves the
    cross-attention of unequal lengths in the JAX package."""
    rng = np.random.default_rng(3)
    q = (rng.standard_normal((1, 2, 40, 16)) * 0.5).astype(np.float32)
    k, v = ((rng.standard_normal((1, 2, 24, 16)) * 0.5).astype(np.float32) for _ in range(2))
    got = att.attention_ref(*(torch.from_numpy(t) for t in (q, k, v)), 0.25).numpy()
    want = np.asarray(_einsum_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.25))
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("n", [8, 16, 300])
def test_dispatch_cpu_tensor_takes_the_plain_version(n):
    """Whatever N, a CPU tensor is computed by the plain version: no launch."""
    q, k, v = (torch.from_numpy(t) for t in _qkv(1, 2, n, 16, seed=1))
    before = dict(att.LAUNCHES)
    got = att.dot_product_attention(q, k, v)
    assert att.LAUNCHES == before
    torch.testing.assert_close(got, att.attention_ref(q, k, v, 0.25), rtol=0, atol=0)


BAD_ARGUMENTS = {
    "unequal_lengths": (lambda q, k, v: (q, k[:, :, :8], v[:, :, :8]), ValueError, "one shape"),
    "unequal_head_dim": (lambda q, k, v: (q, k, v[..., :8]), ValueError, "one shape"),
    "not_4d": (lambda q, k, v: (q[0], k[0], v[0]), ValueError, "B, H, N, D"),
    "float64": (lambda q, k, v: (q.double(), k.double(), v.double()), TypeError, "float64"),
    "mixed_dtypes": (lambda q, k, v: (q, k.to(torch.bfloat16), v), TypeError, "dtype"),
    "mixed_devices": (lambda q, k, v: (q, k.to("meta"), v), ValueError, "meta"),
    "unsupported_device": (lambda q, k, v: (q.to("meta"), k.to("meta"), v.to("meta")),
                           ValueError, "unsupported device"),
    "empty": (lambda q, k, v: (q[:, :, :0], k[:, :, :0], v[:, :, :0]), ValueError, "empty"),
}


@pytest.mark.parametrize("case", sorted(BAD_ARGUMENTS))
def test_dispatch_rejects_bad_arguments(case):
    mutate, error, match = BAD_ARGUMENTS[case]
    q, k, v = (torch.from_numpy(t) for t in _qkv(1, 2, 32, 16))
    before = dict(att.LAUNCHES)
    with pytest.raises(error, match=match):
        att.dot_product_attention(*mutate(q, k, v))
    assert att.LAUNCHES == before


def test_kernel_wrapper_refuses_cpu_tensors_and_odd_head_dims():
    q = torch.zeros(1, 2, 32, 16)
    with pytest.raises(ValueError, match="CUDA kernel"):
        att.fused_attention(q, q, q, 0.25)
    assert [att.padded_head_dim(d) for d in (8, 48, 64, 72, 128)] == [64, 64, 64, 128, 128]
    for d in (4, 20, 136):
        with pytest.raises(ValueError, match="head dimension"):
            att.padded_head_dim(d)


# (type, rows, kernel head dimension) -> the attention kernel: both axes of
# the BS-RoFormer and Mel-Band flagships (801 -> 832 frames; 62 and 60 bands
# -> 64), HTDemucs's two branches (1344, 2688), the tile edges around 64
# rows, a 128-wide head and bf16.
FLASH_ROUTE_CASES = [
    (torch.float32, 832, 64, "flash_tf32x3"),
    (torch.float32, 64, 64, "flash_fma"),
    (torch.float32, 1344, 64, "flash_tf32x3"),
    (torch.float32, 2688, 64, "flash_tf32x3"),
    (torch.float32, 65, 64, "flash_tf32x3"),
    (torch.float32, 1, 64, "flash_fma"),
    (torch.float32, 1344, 128, "flash_fma"),
    (torch.float32, 64, 128, "flash_fma"),
    (torch.bfloat16, 832, 64, "flash_wgmma"),
    (torch.bfloat16, 64, 64, "flash_wgmma"),
    (torch.bfloat16, 2688, 128, "flash_wgmma"),
]


@pytest.mark.parametrize("dtype,n_rows,dh,route", FLASH_ROUTE_CASES)
def test_flash_route_follows_type_rows_and_head_dim(dtype, n_rows, dh, route):
    assert att.flash_route(dtype, n_rows, dh) == route
    assert route in att.FLASH_ROUTES and route in _build.LAUNCHES


def test_flash_route_refuses_what_no_kernel_takes():
    with pytest.raises(TypeError, match="float16"):
        att.flash_route(torch.float16, 832, 64)
    with pytest.raises(ValueError, match="head dimension"):
        att.flash_route(torch.float32, 832, 96)


class _RecordingLib:
    """A stand-in for a kernel library: records each call's arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("asep_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


def _on_a_pretend_card(monkeypatch, module, lib):
    monkeypatch.setattr(module, "device_kind", lambda t: "cuda")
    monkeypatch.setattr(module, "load", lambda name: lib)
    monkeypatch.setattr(module, "stream", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())


@pytest.mark.parametrize("n,d,route", [(300, 64, "flash_tf32x3"), (64, 64, "flash_fma"),
                                       (200, 128, "flash_fma"), (300, 48, "flash_tf32x3")])
def test_kernel_wrapper_passes_and_counts_the_route(monkeypatch, n, d, route):
    """The wrapper hands flash_route's choice (for the padded head) to the C
    entry point as its number, counts the launch under the route's name and
    puts the route on the launch's span record."""
    lib = _RecordingLib()
    _on_a_pretend_card(monkeypatch, att, lib)
    saved = dict(_build.LAUNCHES)
    tracing.clear()
    tracing.enable()
    try:
        q = torch.zeros(1, 2, n, d)
        att.fused_attention(q, q, q, 0.125)
        records = [r for r in tracing.records() if r.name == "kernel.fused_attention"]
        (name, args), = lib.calls
        assert name == "asep_attention" and args[1] == att.FLASH_ROUTES.index(route)
        assert [r.attrs for r in records] == [{"route": route}]
        assert _build.LAUNCHES["fused_attention"] == saved["fused_attention"] + 1
        for r in att.FLASH_ROUTES:
            assert _build.LAUNCHES[r] == saved[r] + (r == route)
    finally:
        tracing.disable()
        tracing.clear()
        _build.LAUNCHES.update(saved)


def test_cuda_source_entry_point_matches_ctypes_signature():
    """``csrc/attention.cu`` exists, exposes ``asep_attention`` with a plain C
    interface whose parameters line up with the ctypes argtypes, and builds on
    the kernels of ``tiles.cuh`` that the fused block's attention uses."""
    assert _build.KERNEL_SOURCES["attention"] == "attention.cu"
    with open(os.path.join(_build.CSRC_DIR, "attention.cu"), encoding="utf-8") as f:
        source = f.read()
    entry, argtypes = _build._SIGNATURES["attention"]
    found = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", source)
    assert found, "entry point not found"
    params = [p.strip() for p in found.group(1).replace("\n", " ").split(",")]
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float}
    expected = [ctypes.c_void_p if "*" in p else kinds[p.split()[0]] for p in params]
    assert expected == argtypes
    assert '#include "tiles.cuh"' in source
    with open(os.path.join(_build.CSRC_DIR, "attention_block.cu"), encoding="utf-8") as f:
        block_source = f.read()
    with open(os.path.join(_build.CSRC_DIR, "tiles.cuh"), encoding="utf-8") as f:
        tiles = f.read()
    # Both callers go through the one launcher, and behind it there is one
    # kernel per type: the earlier kernels are gone, not kept as a second path.
    assert "run_flash(" in source and "run_flash(" in block_source
    for kernel in ("flash_fma_kernel", "flash_wgmma_kernel", "flash_tf32x3_kernel",
                   "gemm_wgmma_kernel"):
        assert f"\n{kernel}(" in tiles
    for gone in ("flash_mma_kernel", "gemm_mma_kernel", "mma.sync", "ldmatrix"):
        assert gone not in tiles + source + block_source
    assert "scaled_dot_product_attention" not in open(att.__file__, encoding="utf-8").read()


def _as_if_on_the_card(monkeypatch, module):
    """Make a wrapper take its CUDA branch with CPU tensors, with a loader
    that must not be reached: what the wrapper refuses, it refuses before any
    build or launch."""
    def no_load(name):
        raise AssertionError(f"the loader was reached for {name}")

    monkeypatch.setattr(module, "device_kind", lambda t: "cuda")
    monkeypatch.setattr(module, "load", no_load)


def test_kernel_wrapper_refuses_misaligned_operands_before_any_build(monkeypatch):
    """TMA tensor maps and the kernels' vector loads need a 16-byte aligned
    base: a view that starts one float into its buffer raises ValueError."""
    _as_if_on_the_card(monkeypatch, att)
    buf = torch.zeros(2 * 32 * 64 + 1)
    q = buf[1:].view(1, 2, 32, 64)
    assert q.data_ptr() % 16 and q.is_contiguous()
    before = dict(att.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte"):
        att.fused_attention(q, q, q, 0.125)
    aligned = torch.zeros(1, 2, 32, 64)
    with pytest.raises(AssertionError, match="loader was reached"):
        att.fused_attention(aligned, aligned, aligned, 0.125)
    assert att.LAUNCHES == before


@pytest.mark.parametrize("n,d", [(1, 64), (65, 64), (200, 128), (17, 48)])
def test_cpu_tensor_never_reaches_the_loader(monkeypatch, n, d):
    def no_load(name):
        raise AssertionError(f"the loader was reached for {name}")

    monkeypatch.setattr(att, "load", no_load)
    monkeypatch.setattr(_build, "load", no_load)
    q, k, v = (torch.from_numpy(t) for t in _qkv(1, 2, n, d, seed=3))
    got = att.dot_product_attention(q, k, v)
    torch.testing.assert_close(got, att.attention_ref(q, k, v, d ** -0.5), rtol=0, atol=0)
