"""The PyTorch port's fused RoFormer blocks (plain versions, which CPU tensors
take) against the JAX package's Pallas kernels in interpret mode and its
composed ops; the wrappers' argument checks; the kernel loader without nvcc.

Tolerance: atol 3e-5 in float32, as tests/test_attention.py holds the Pallas
kernels to the composed ops."""

import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_separator_tpu.models.roformer import _attention, _feedforward
from audio_separator_tpu.models.roformer import _rope_tables as jax_rope_tables
from audio_separator_tpu.ops.attention_block import (
    fused_attention_block as jax_fused_attention_block,
)
from audio_separator_tpu.ops.attention_block import fused_ff_block as jax_fused_ff_block
from audio_separator_tpu_torch.models.roformer import _rope_tables
from audio_separator_tpu_torch.ops import _build
from audio_separator_tpu_torch.ops import attention as att
from audio_separator_tpu_torch.ops import attention_block as ab
from audio_separator_tpu_torch.utils import tracing

# (n, b, rope, group, gran, d, heads, dim_head): the four cases of
# tests/test_attention.py plus one flagship-width layer (d 512, 8 x 64,
# freq axis n 62 -> 64).
ATTN_CASES = [
    (100, 4, True, 2, 128, 64, 4, 16),
    (62, 6, False, 3, 128, 64, 4, 16),
    (130, 2, True, 1, 128, 64, 4, 16),
    (62, 6, True, 3, 64, 64, 4, 16),
    (62, 2, True, 1, 64, 512, 8, 64),
]


def _attn_inputs(n, b, d, h, dh, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, n, d)) * 0.3).astype(np.float32)
    p = {
        "attn_norm": (rng.standard_normal(d) * 0.1 + 1.0).astype(np.float32),
        "wqkv": (rng.standard_normal((d, 3 * h * dh)) * 0.05).astype(np.float32),
        "gate_w": (rng.standard_normal((d, h)) * 0.05).astype(np.float32),
        "gate_b": (rng.standard_normal(h) * 0.05).astype(np.float32),
        "wo": (rng.standard_normal((h * dh, d)) * 0.05).astype(np.float32),
    }
    return x, p


def _port_attention(x, p, heads, n, gran, rope, dtype=torch.float32):
    pad = (-n) % gran
    xt = torch.nn.functional.pad(torch.from_numpy(x), (0, 0, 0, pad)).to(dtype)
    w = {k: torch.from_numpy(v).to(dtype) for k, v in p.items()}
    dh = p["wqkv"].shape[1] // (3 * heads)
    rope_p = None
    if rope:
        cos, sin = _rope_tables(n, dh, dtype)
        rope_p = (torch.nn.functional.pad(cos, (0, 0, 0, pad)),
                  torch.nn.functional.pad(sin, (0, 0, 0, pad)))
    out = ab.fused_attention_block(xt, w["wqkv"], w["gate_w"], w["gate_b"], w["wo"],
                                   w["attn_norm"], rope_p, heads, n_valid=n)
    return out[:, :n].float().numpy()


@pytest.mark.parametrize("reference", ["pallas", "composed"])
@pytest.mark.parametrize("n,b,rope,group,gran,d,h,dh", ATTN_CASES)
def test_attention_block_plain_matches_jax(reference, n, b, rope, group, gran, d, h, dh):
    x, p = _attn_inputs(n, b, d, h, dh)
    got = _port_attention(x, p, h, n, gran, rope)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    xj = jnp.asarray(x)
    tables = jax_rope_tables(n, dh) if rope else None
    if reference == "composed":
        want = np.asarray(xj + _attention(jp, xj, h, tables))
    else:
        pad = (-n) % gran
        rope_p = None
        if rope:
            rope_p = tuple(jnp.pad(t, ((0, pad), (0, 0))) for t in tables)
        want = np.asarray(jax_fused_attention_block(
            jnp.pad(xj, ((0, 0), (0, pad), (0, 0))), jp["wqkv"], jp["gate_w"],
            jp["gate_b"], jp["wo"], jp["attn_norm"], rope_p, h, n_valid=n,
            group=group, interpret=True))[:, :n]
    np.testing.assert_allclose(got, want, atol=3e-5)


def test_attention_block_plain_bf16_tracks_pallas_bf16():
    """In bf16 both sides round at the same points (qkv, rotated q/k, softmax
    weights, merged heads, projection); they differ only in where XLA rounds
    inside RoPE's products, so they agree to a few bf16 steps (2^-8 relative)."""
    n, b, d, h, dh = 62, 2, 64, 4, 16
    x, p = _attn_inputs(n, b, d, h, dh, seed=3)
    got = _port_attention(x, p, h, n, 64, True, torch.bfloat16)
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()}
    tables = tuple(jnp.pad(t, ((0, 2), (0, 0))) for t in jax_rope_tables(n, dh, jnp.bfloat16))
    want = np.asarray(jax_fused_attention_block(
        jnp.pad(jnp.asarray(x, jnp.bfloat16), ((0, 0), (0, 2), (0, 0))), jp["wqkv"],
        jp["gate_w"], jp["gate_b"], jp["wo"], jp["attn_norm"], tables, h, n_valid=n,
        group=1, interpret=True)).astype(np.float32)[:, :n]
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 4 * 2.0 ** -8 * scale
    assert np.abs(got - want).mean() <= 0.25 * 2.0 ** -8 * scale


@pytest.mark.parametrize("reference", ["pallas", "composed"])
@pytest.mark.parametrize("b,n,d,hidden", [(3, 128, 64, 256), (2, 64, 512, 2048)])
def test_ff_block_plain_matches_jax(reference, b, n, d, hidden):
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((b, n, d)) * 0.3).astype(np.float32)
    p = {
        "ff_norm": (rng.standard_normal(d) * 0.1 + 1.0).astype(np.float32),
        "ff_w1": (rng.standard_normal((d, hidden)) * 0.05).astype(np.float32),
        "ff_b1": (rng.standard_normal(hidden) * 0.05).astype(np.float32),
        "ff_w2": (rng.standard_normal((hidden, d)) * 0.05).astype(np.float32),
        "ff_b2": (rng.standard_normal(d) * 0.05).astype(np.float32),
    }
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    got = ab.fused_ff_block(torch.from_numpy(x), t["ff_norm"], t["ff_w1"], t["ff_b1"],
                            t["ff_w2"], t["ff_b2"]).numpy()
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    xj = jnp.asarray(x)
    if reference == "composed":
        want = np.asarray(xj + _feedforward(jp, xj))
    else:
        want = np.asarray(jax_fused_ff_block(xj, jp["ff_norm"], jp["ff_w1"], jp["ff_b1"],
                                             jp["ff_w2"], jp["ff_b2"], group=1,
                                             interpret=True))
    np.testing.assert_allclose(got, want, atol=3e-5)


def _valid_attention_args(dtype=torch.float32):
    b, n_pad, d, h, dh = 2, 64, 64, 4, 16
    g = torch.Generator().manual_seed(0)
    x = torch.randn(b, n_pad, d, generator=g).to(dtype)
    args = dict(x=x, wqkv=torch.randn(d, 3 * h * dh, generator=g).to(dtype),
                gate_w=torch.randn(d, h, generator=g).to(dtype),
                gate_b=torch.zeros(h, dtype=dtype), wo=torch.randn(h * dh, d, generator=g).to(dtype),
                attn_norm=torch.ones(d, dtype=dtype),
                rope=(torch.ones(n_pad, dh, dtype=dtype), torch.zeros(n_pad, dh, dtype=dtype)),
                heads=h, n_valid=50)
    return args


BAD_ATTENTION_ARGS = {
    "n_pad_not_multiple_of_64": (lambda a: a.update(x=a["x"][:, :50]), ValueError),
    "x_not_3d": (lambda a: a.update(x=a["x"][0]), ValueError),
    "float64": (lambda a: a.update({k: a[k].double() for k in
                                    ("x", "wqkv", "gate_w", "gate_b", "wo", "attn_norm")}),
                TypeError),
    "weight_dtype_mismatch": (lambda a: a.update(wo=a["wo"].to(torch.bfloat16)), TypeError),
    "wqkv_shape": (lambda a: a.update(wqkv=a["wqkv"][:, :-16]), ValueError),
    "gate_b_shape": (lambda a: a.update(gate_b=torch.zeros(5)), ValueError),
    "rope_shape": (lambda a: a.update(rope=(a["rope"][0][:32], a["rope"][1][:32])), ValueError),
    "non_contiguous_weight": (lambda a: a.update(wo=a["wo"].t().contiguous().t()), ValueError),
    "non_contiguous_x": (lambda a: a.update(x=a["x"].transpose(0, 1).contiguous().transpose(0, 1)),
                         ValueError),
    "n_valid_zero": (lambda a: a.update(n_valid=0), ValueError),
    "n_valid_past_pad": (lambda a: a.update(n_valid=65), ValueError),
    "mixed_devices": (lambda a: a.update(wo=a["wo"].to("meta")), ValueError),
    "unsupported_device": (lambda a: a.update({k: a[k].to("meta") for k in
                                               ("x", "wqkv", "gate_w", "gate_b", "wo",
                                                "attn_norm")}, rope=None), ValueError),
}


@pytest.mark.parametrize("case", sorted(BAD_ATTENTION_ARGS))
def test_attention_wrapper_rejects_bad_arguments(case):
    mutate, error = BAD_ATTENTION_ARGS[case]
    args = _valid_attention_args()
    mutate(args)
    before = dict(ab.LAUNCHES)
    with pytest.raises(error):
        ab.fused_attention_block(**args)
    assert ab.LAUNCHES == before


def test_attention_wrapper_valid_arguments_run_plain_on_cpu():
    args = _valid_attention_args()
    before = dict(ab.LAUNCHES)
    out = ab.fused_attention_block(**args)
    assert out.shape == args["x"].shape and torch.isfinite(out).all()
    assert ab.LAUNCHES == before  # the plain version is no kernel launch


@pytest.mark.parametrize("case", ["n_pad", "hidden_shape", "bias_dtype", "non_contiguous"])
def test_ff_wrapper_rejects_bad_arguments(case):
    d, hidden = 64, 128
    x = torch.zeros(2, 64, d)
    w = dict(ff_norm=torch.ones(d), w1=torch.zeros(d, hidden), b1=torch.zeros(hidden),
             w2=torch.zeros(hidden, d), b2=torch.zeros(d))
    if case == "n_pad":
        x = x[:, :40]
    elif case == "hidden_shape":
        w["w2"] = torch.zeros(hidden + 1, d)
    elif case == "bias_dtype":
        w["b1"] = w["b1"].to(torch.bfloat16)
    else:
        w["w1"] = torch.zeros(hidden, d).t()
    with pytest.raises((ValueError, TypeError)):
        ab.fused_ff_block(x, **w)


@pytest.mark.parametrize("dims", [(100, 8, 64, None), (512, 8, 32, None),
                                  (512, 66, 64, None), (512, 0, 64, None),
                                  (512, 8, 64, 100), (1024, 64, 64, None)])
def test_kernel_dims_outside_the_tiling_raise(dims):
    """The last case: 1024 x 64 float32 gate weights exceed a block's shared
    memory."""
    with pytest.raises(ValueError):
        ab.check_kernel_dims(*dims)
    ab.check_kernel_dims(512, 8, 64, 2048)  # the flagship layer fits


@pytest.mark.parametrize("heads", [1, 3, 7, 8, 33, 64])
def test_odd_head_counts_fit_the_kernels(heads):
    """The QKV product has no gate columns, so no column tile can straddle
    Wqkv and gate_w: any head count up to 64 fits."""
    ab.check_kernel_dims(512, heads, 64, 2048)


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """Without the CUDA toolkit the loader raises a clear error (no silent
    fallback); the build targets sm_90a and is keyed on the sources."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    if _build.os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has the CUDA toolkit")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    path = _build.library_path("ff_block")
    assert path.startswith(_build.BUILD_DIR) and path.endswith(".so")
    assert path == _build.library_path("ff_block")
    # One loader and one table of launch counts for every kernel.
    assert set(_build.KERNEL_SOURCES) == {"attention_block", "ff_block", "attention",
                                          "attention_bwd", "norm_bwd", "gelu_bwd",
                                          "rope_gate_bwd", "group_norm"}
    assert ab.LAUNCHES is _build.LAUNCHES


def test_build_links_libcuda_and_hashes_every_header():
    """The tensor maps are encoded by ``cuTensorMapEncodeTiled``, so the libraries
    link libcuda; a change to any header under csrc/ changes the library names."""
    assert "-lcuda" in _build.NVCC_FLAGS
    headers = [fn for fn in _build.os.listdir(_build.CSRC_DIR) if fn.endswith(".cuh")]
    assert {"tiles.cuh", "hopper.cuh"} <= set(headers)
    with open(_build.os.path.join(_build.CSRC_DIR, "hopper.cuh"), encoding="utf-8") as f:
        hopper = f.read()
    for needed in ("cuTensorMapEncodeTiled", "wgmma.mma_async", "cp.async.bulk.tensor",
                   "mbarrier.try_wait.parity", "setmaxnreg"):
        assert needed in hopper


@pytest.mark.parametrize("heads", [1, 2, 6, 8, 12, 16])
def test_gate_weights_fill_a_power_of_two_of_columns(heads):
    """The norm launch keeps gate_w in shared memory transposed, [H][d] of the
    storage type, H the head count rounded up to a power of two: each warp
    reduces its row's H sums in one transposing reduction."""
    cols = ab.gate_columns(heads)
    assert cols >= heads and cols & (cols - 1) == 0 and cols < 2 * heads
    assert (32 % cols == 0) or cols == 64


def _no_load(name):
    raise AssertionError(f"the loader was reached for {name}")


@pytest.mark.parametrize("block", ["attention", "ff"])
def test_block_wrappers_refuse_misaligned_operands_before_any_build(monkeypatch, block):
    """With the CUDA branch forced on CPU tensors and a loader that must not
    be reached: a weight whose storage starts 4 bytes off raises ValueError,
    and only well-aligned arguments get as far as the loader."""
    monkeypatch.setattr(ab, "device_kind", lambda t: "cuda")
    monkeypatch.setattr(ab, "load", _no_load)
    d, h, dh, hidden = 64, 8, 64, 128
    x = torch.zeros(2, 64, d)

    def off_by_one_float(*shape):
        n = int(np.prod(shape))
        t = torch.zeros(n + 1)[1:].view(*shape)
        assert t.data_ptr() % 16 and t.is_contiguous()
        return t

    if block == "attention":
        args = dict(x=x, wqkv=torch.zeros(d, 3 * h * dh), gate_w=torch.zeros(d, h),
                    gate_b=torch.zeros(h), wo=torch.zeros(h * dh, d), attn_norm=torch.ones(d),
                    rope=None, heads=h, n_valid=50)
        call, bad = ab.fused_attention_block, dict(wqkv=off_by_one_float(d, 3 * h * dh))
    else:
        args = dict(x=x, ff_norm=torch.ones(d), w1=torch.zeros(d, hidden), b1=torch.zeros(hidden),
                    w2=torch.zeros(hidden, d), b2=torch.zeros(d))
        call, bad = ab.fused_ff_block, dict(b1=off_by_one_float(hidden))
    before = dict(ab.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte"):
        call(**{**args, **bad})
    with pytest.raises(AssertionError, match="loader was reached"):
        call(**args)
    assert ab.LAUNCHES == before


@pytest.mark.parametrize("dtype,n_pad,partial,route", [
    (torch.float32, 832, False, "flash_tf32x3"), (torch.float32, 64, False, "flash_fma"),
    (torch.float32, 128, True, "flash_tf32x3"), (torch.bfloat16, 832, False, "flash_wgmma")])
def test_attention_block_passes_and_counts_the_route(monkeypatch, dtype, n_pad, partial, route):
    """The block hands its attention launch's route (flash_route of its type
    and n_pad at 64-wide heads) to the C entry point as its number, counts it
    under the route's name beside the block's own count, and puts it on the
    launch's span record."""
    calls = []

    class Lib:
        def asep_attention_block(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(ab, "device_kind", lambda t: "cuda")
    monkeypatch.setattr(ab, "load", lambda name: Lib())
    monkeypatch.setattr(ab, "stream", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    d, h = 64, 2
    name = "fused_attention_block_partial" if partial else "fused_attention_block"
    saved = dict(_build.LAUNCHES)
    tracing.clear()
    tracing.enable()
    try:
        ab.fused_attention_block(torch.zeros(1, n_pad, d, dtype=dtype),
                                 torch.zeros(d, 3 * h * 64, dtype=dtype),
                                 torch.zeros(d, h, dtype=dtype), torch.zeros(h, dtype=dtype),
                                 torch.zeros(h * 64, d, dtype=dtype), torch.ones(d, dtype=dtype),
                                 None, h, n_pad - 3, partial=partial)
        (args,) = calls
        assert args[-2] == att.FLASH_ROUTES.index(route) and args[-3] == int(partial)
        assert [r.attrs for r in tracing.records() if r.name == "kernel." + name] == [
            {"route": route}]
        assert _build.LAUNCHES[name] == saved[name] + 1
        for r in att.FLASH_ROUTES:
            assert _build.LAUNCHES[r] == saved[r] + (r == route)
    finally:
        tracing.disable()
        tracing.clear()
        _build.LAUNCHES.update(saved)


@pytest.mark.parametrize("block", ["attention", "ff"])
def test_cpu_tensors_never_reach_the_loader(monkeypatch, block):
    monkeypatch.setattr(ab, "load", _no_load)
    monkeypatch.setattr(_build, "load", _no_load)
    if block == "attention":
        out = ab.fused_attention_block(**_valid_attention_args())
    else:
        d, hidden = 64, 128
        g = torch.Generator().manual_seed(1)
        out = ab.fused_ff_block(torch.randn(3, 64, d, generator=g), torch.ones(d),
                                torch.randn(d, hidden, generator=g), torch.zeros(hidden),
                                torch.randn(hidden, d, generator=g), torch.zeros(d))
    assert torch.isfinite(out).all()
