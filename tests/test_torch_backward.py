"""The backward passes of the port's three kernels on the CPU: the plain
versions of the four backward kernels (``ops/attention.attention_bwd_ref``,
``ops/block_backward.rmsnorm_bwd_ref``, ``gelu_bwd_ref``,
``rope_gate_bwd_ref``) and the compositions the blocks' autograd Functions
run, held two ways:

* against ``torch.autograd`` through the forward plain versions
  (``fused_attention_block_ref``, ``fused_ff_block_ref``, ``attention_ref``
  and the norm, GELU, RoPE and gate steps), at 1e-5 of each gradient's
  largest magnitude: the same float32 arithmetic, summed in other orders;
* against ``jax.grad`` of the JAX package's unfused counterparts
  (``models/roformer._attention`` and ``_feedforward`` plus the residual, on
  the unpadded tokens, while the port pads them to a multiple of 64 and masks
  the padded keys; ``ops/attention._einsum_attention``), same seeds, same
  weights, at 1e-5 of the gradient's largest magnitude. (The JAX package
  cannot differentiate its Pallas kernels; on the CPU it runs these.)

The CUDA kernels themselves are held against these plain versions on the
card: tests/test_torch_cuda_kernels.py and chip_smoke.py's ``[training]``
phase."""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from audio_separator_tpu.models import roformer as jax_roformer
from audio_separator_tpu.ops import attention as jax_attention
from audio_separator_tpu_torch.models.roformer import _rope_tables
from audio_separator_tpu_torch.ops import attention as att
from audio_separator_tpu_torch.ops import attention_block as ab
from audio_separator_tpu_torch.ops import block_backward as bb
from audio_separator_tpu_torch.ops.tf32 import matmul_3xtf32
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5


def _close(got, want, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.detach().numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, atol=TOL * np.abs(want).max(), rtol=0, err_msg=what)


def _randn(rng, *shape, s=1.0):
    return (rng.standard_normal(shape) * s).astype(np.float32)


def _block_case(seed, b, n, d, heads, dh, hidden):
    """Weights, tokens and an output gradient, numpy, with the token axis
    unpadded."""
    rng = np.random.default_rng(seed)
    w = dict(attn_norm=1 + _randn(rng, d, s=0.1), wqkv=_randn(rng, d, 3 * heads * dh, s=0.1),
             gate_w=_randn(rng, d, heads, s=0.1), gate_b=_randn(rng, heads, s=0.1),
             wo=_randn(rng, heads * dh, d, s=0.1), ff_norm=1 + _randn(rng, d, s=0.1),
             ff_w1=_randn(rng, d, hidden, s=0.1), ff_b1=_randn(rng, hidden, s=0.1),
             ff_w2=_randn(rng, hidden, d, s=0.1), ff_b2=_randn(rng, d, s=0.1))
    return w, _randn(rng, b, n, d), _randn(rng, b, n, d)


ATTN_KEYS = ("wqkv", "gate_w", "gate_b", "wo", "attn_norm")
FF_KEYS = ("ff_norm", "ff_w1", "ff_b1", "ff_w2", "ff_b2")


def _port_block_grads(which, w, x, dy, heads, dh, rope):
    """The port's block (the autograd Function, CPU) over the tokens padded
    to a multiple of 64: gradients of Σ out[:, :n]·dy in x and the weights."""
    b, n, d = x.shape
    n_pad = -(-n // 64) * 64
    xt = torch.from_numpy(x).requires_grad_(True)
    keys = ATTN_KEYS if which == "attention" else FF_KEYS
    ws = {k: torch.from_numpy(w[k]).requires_grad_(True) for k in keys}
    xp = F.pad(xt, (0, 0, 0, n_pad - n))
    if which == "attention":
        tables = None
        if rope:
            cos, sin = _rope_tables(n, dh)
            tables = (F.pad(cos, (0, 0, 0, n_pad - n)), F.pad(sin, (0, 0, 0, n_pad - n)))
        out = ab.fused_attention_block(xp, ws["wqkv"], ws["gate_w"], ws["gate_b"], ws["wo"],
                                       ws["attn_norm"], tables, heads, n_valid=n)
    else:
        out = ab.fused_ff_block(xp, ws["ff_norm"], ws["ff_w1"], ws["ff_b1"], ws["ff_w2"],
                                ws["ff_b2"])
    grads = torch.autograd.grad(out[:, :n], [xt, *ws.values()], torch.from_numpy(dy))
    return dict(zip(("x",) + keys, grads))


def _jax_block_grads(which, w, x, dy, heads, dh, rope):
    keys = ATTN_KEYS if which == "attention" else FF_KEYS
    p = {k: jnp.asarray(w[k]) for k in keys}
    tables = jax_roformer._rope_tables(x.shape[1], dh) if rope else None

    def f(xj, pj):
        if which == "attention":
            y = xj + jax_roformer._attention(pj, xj, heads, tables)
        else:
            y = xj + jax_roformer._feedforward(pj, xj)
        return jnp.sum(y * jnp.asarray(dy))

    gx, gp = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), p)
    return {"x": gx, **gp}


BLOCK_CASES = [  # (b, n, d, heads, dh, hidden, rope): a time-like and a frequency-like axis
    (2, 50, 64, 4, 16, 128, True), (3, 62, 32, 2, 16, 64, True), (2, 70, 32, 4, 8, 64, False)]


@pytest.mark.parametrize("which", ["attention", "feedforward"])
@pytest.mark.parametrize("case", BLOCK_CASES)
def test_block_backward_matches_jax_grad_of_the_unfused_path(which, case):
    b, n, d, heads, dh, hidden, rope = case
    w, x, dy = _block_case(sum(case[:5]), b, n, d, heads, dh, hidden)
    got = _port_block_grads(which, w, x, dy, heads, dh, rope)
    want = _jax_block_grads(which, w, x, dy, heads, dh, rope)
    assert set(got) == set(want)
    for key in got:
        _close(got[key], want[key], key)


@pytest.mark.parametrize("case", BLOCK_CASES)
def test_block_backward_matches_autograd_of_the_plain_forward(case):
    """The Functions' backward (the composition of the backward plain
    versions) against autograd through the forward plain versions, on the
    padded tokens, padded rows and all."""
    b, n, d, heads, dh, hidden, rope = case
    w, x, dy = _block_case(sum(case[:5]) + 1, b, n, d, heads, dh, hidden)
    n_pad = -(-n // 64) * 64
    xt = torch.from_numpy(np.pad(x, ((0, 0), (0, n_pad - n), (0, 0)))).requires_grad_(True)
    dyp = torch.from_numpy(np.pad(dy, ((0, 0), (0, n_pad - n), (0, 0))))
    ws = {k: torch.from_numpy(v).requires_grad_(True) for k, v in w.items()}
    tables = None
    if rope:
        cos, sin = _rope_tables(n, dh)
        tables = (F.pad(cos, (0, 0, 0, n_pad - n)), F.pad(sin, (0, 0, 0, n_pad - n)))
    attn_args = dict(wqkv=ws["wqkv"], gate_w=ws["gate_w"], gate_b=ws["gate_b"], wo=ws["wo"],
                     attn_norm=ws["attn_norm"], rope=tables, heads=heads, n_valid=n)
    ff_args = dict(ff_norm=ws["ff_norm"], w1=ws["ff_w1"], b1=ws["ff_b1"], w2=ws["ff_w2"],
                   b2=ws["ff_b2"])
    for fn, ref, args, keys in ((ab.fused_attention_block, ab.fused_attention_block_ref,
                                 attn_args, ATTN_KEYS),
                                (ab.fused_ff_block, ab.fused_ff_block_ref, ff_args, FF_KEYS)):
        inputs = [xt] + [ws[k] for k in keys]
        out = fn(xt, **args)
        assert type(out.grad_fn).__name__ in ("_AttentionBlockBackward", "_FFBlockBackward")
        got = torch.autograd.grad(out, inputs, dyp)
        want = torch.autograd.grad(ref(xt, **args), inputs, dyp)
        for key, g, r in zip(("x",) + keys, got, want):
            _close(g, r, key)


@pytest.mark.parametrize("shape", [(2, 3, 37, 24), (1, 2, 130, 64), (2, 2, 16, 8)])
def test_attention_backward_matches_autograd_and_jax_grad(shape):
    rng = np.random.default_rng(shape[2])
    q, k, v, do = (_randn(rng, *shape) for _ in range(4))
    scale = shape[-1] ** -0.5
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = att.dot_product_attention(*ts)
    assert type(out.grad_fn).__name__ == "_AttentionBackward"
    got = torch.autograd.grad(out, ts, torch.from_numpy(do))
    plain = torch.autograd.grad(att.attention_ref(*ts, scale), ts, torch.from_numpy(do))
    jgrad = jax.grad(lambda a, b, c: jnp.sum(jax_attention._einsum_attention(a, b, c, scale)
                                             * jnp.asarray(do)), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for name, g, p, j in zip("qkv", got, plain, jgrad):
        _close(g, p, name)
        _close(g, j, name)


def test_attention_backward_masks_keys_past_n_valid():
    """Keys past n_valid get no gradient, and the rest is the gradient of
    the attention over the valid keys alone."""
    rng = np.random.default_rng(3)
    q, k, v, o_unused, do = (torch.from_numpy(_randn(rng, 2, 2, 64, 16)) for _ in range(5))
    scale = 0.25
    out = att.attention_ref(q, k[:, :, :50], v[:, :, :50], scale)
    dq, dk, dv, delta = att.attention_backward(q, k, v, out, do, scale, n_valid=50)
    assert not dk[:, :, 50:].any() and not dv[:, :, 50:].any()
    ts = [t.clone().requires_grad_(True) for t in (q, k[:, :, :50], v[:, :, :50])]
    want = torch.autograd.grad(att.attention_ref(*ts, scale), ts, do)
    for g, w in zip((dq, dk[:, :, :50], dv[:, :, :50]), want):
        _close(g, w)
    _close(delta, (do * out).sum(-1))


def _attention_bwd_3xtf32(q, k, v, o, do, scale, n_valid):
    """The arithmetic of the card's attention backward (csrc/attention_bwd.cu):
    every product as three TF32 products summed in float32
    (``ops/tf32.matmul_3xtf32``), the log-sum-exp recomputed from those
    scores."""
    s = matmul_3xtf32(q, k.transpose(-1, -2)) * scale
    s[..., n_valid:] = -math.inf
    p = torch.exp(s - torch.logsumexp(s, -1, keepdim=True))
    delta = (do * o).sum(-1)
    dv = matmul_3xtf32(p.transpose(-1, -2), do)
    ds = p * (matmul_3xtf32(do, v.transpose(-1, -2)) - delta[..., None])
    dq = matmul_3xtf32(ds, k) * scale
    dk = matmul_3xtf32(ds.transpose(-1, -2), q) * scale
    return dq, dk, dv, delta


def test_attention_backward_in_3xtf32_meets_the_float32_tolerance(capsys):
    """The kernel's 3xTF32 products, held to the float64 plain version with
    the card's float32 tolerance (1e-4 max, 1e-5 mean of each output's
    scale), with scores that reach ±20 and masked keys."""
    rng = np.random.default_rng(11)
    shape, n_valid, scale = (2, 2, 96, 64), 77, 0.125
    q, k = (torch.from_numpy(_randn(rng, *shape, s=2.2)) for _ in range(2))
    v, do = (torch.from_numpy(_randn(rng, *shape)) for _ in range(2))
    o = att.attention_ref(q, k[:, :, :n_valid], v[:, :, :n_valid], scale)
    s64 = torch.matmul(q.double(), k.double().transpose(-1, -2))[..., :n_valid] * scale
    assert float(s64.abs().max()) >= 15.0
    got = _attention_bwd_3xtf32(q, k, v, o, do, scale, n_valid)
    # The float64 plain version (attention_bwd_ref computes in float32).
    q64, k64, v64, o64, do64 = (t.double() for t in (q, k, v, o, do))
    p = torch.softmax(s64, -1)
    delta = (do64 * o64).sum(-1)
    ds = p * (torch.matmul(do64, v64[:, :, :n_valid].transpose(-1, -2)) - delta[..., None])
    dk, dv = (torch.zeros_like(q64) for _ in range(2))
    dk[:, :, :n_valid] = torch.matmul(ds.transpose(-1, -2), q64) * scale
    dv[:, :, :n_valid] = torch.matmul(p.transpose(-1, -2), do64)
    want = (torch.matmul(ds, k64[:, :, :n_valid]) * scale, dk, dv, delta)
    for name, g, w in zip(("dq", "dk", "dv", "delta"), got, want):
        ref_scale = float(w.abs().max())
        err = (g.double() - w).abs()
        with capsys.disabled():
            print(f"\n3xTF32 attention backward {name}: max {float(err.max()) / ref_scale:.2e}, "
                  f"mean {float(err.mean()) / ref_scale:.2e} of scale")
        assert float(err.max()) <= 1e-4 * ref_scale, name
        assert float(err.mean()) <= 1e-5 * ref_scale, name


@pytest.mark.parametrize("dres", [False, True])
def test_rmsnorm_backward_matches_autograd(dres):
    """K2's plain version, a zero row (a padded token) included."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(_randn(rng, 3, 10, 64))
    x[:, -2:] = 0
    gamma = torch.from_numpy(1 + _randn(rng, 64, s=0.1))
    dxn, res = (torch.from_numpy(_randn(rng, 3, 10, 64)) for _ in range(2))
    xt, gt = x.clone().requires_grad_(True), gamma.clone().requires_grad_(True)
    ssq = (xt * xt).sum(-1, keepdim=True)
    xn = xt * torch.rsqrt(ssq.clamp_min(1e-24)) * math.sqrt(64) * gt
    wx, wg = torch.autograd.grad(xn, [xt, gt], dxn)
    dx, dgamma = bb.rmsnorm_backward(x, gamma, dxn, res if dres else None)
    _close(dx, wx + res if dres else wx)
    _close(dgamma, wg)


def test_gelu_backward_matches_autograd():
    pre = torch.from_numpy(_randn(np.random.default_rng(5), 40, 64, s=2.0))
    dh = torch.from_numpy(_randn(np.random.default_rng(6), 40, 64))
    pt = pre.clone().requires_grad_(True)
    h = F.gelu(pt)
    (want,) = torch.autograd.grad(h, [pt], dh)
    dpre, got_h = bb.gelu_backward(pre, dh)
    _close(dpre, want)
    _close(got_h, h)


@pytest.mark.parametrize("rope", [True, False])
def test_rope_gate_backward_matches_autograd(rope):
    """K4's plain version against autograd through the QKV split, RoPE and
    the gating of the attention's output."""
    b, n, heads, dh = 2, 12, 3, 16
    rng = np.random.default_rng(7)
    qkv = torch.from_numpy(_randn(rng, b, n, 3 * heads * dh)).requires_grad_(True)
    z = torch.from_numpy(_randn(rng, b, n, heads)).requires_grad_(True)
    o = torch.from_numpy(_randn(rng, b, heads, n, dh))
    gq, gk, gv, gm = (torch.from_numpy(_randn(rng, b, heads, n, dh)) for _ in range(4))
    tables = _rope_tables(n, dh) if rope else None
    parts = qkv.reshape(b, n, 3, heads, dh).permute(2, 0, 3, 1, 4)
    q, k, v = parts[0], parts[1], parts[2]
    if rope:
        q = q * tables[0] + ab.rotate_half(q) * tables[1]
        k = k * tables[0] + ab.rotate_half(k) * tables[1]
    gates = torch.sigmoid(z).transpose(1, 2)  # (b, heads, n)
    merged = o * gates[..., None]
    loss = (q * gq).sum() + (k * gk).sum() + (v * gv).sum() + (merged * gm).sum()
    want_qkv, want_z = torch.autograd.grad(loss, [qkv, z])
    delta = (gm * merged).sum(-1).detach()
    dqkv, dz = bb.rope_gate_backward(gq, gk, gv, delta, gates.detach(), tables)
    _close(dqkv, want_qkv)
    _close(dz, want_z)


def test_cpu_backward_launches_no_kernel_and_refuses_bf16():
    """On the CPU every backward wrapper takes its plain version, in float32
    and in bf16, and launches nothing; bf16 is taken where a bf16 step runs
    it (the RoFormer blocks) and refused, naming ROADMAP C16, by the
    whole-sequence attention's backward, whose only caller is HTDemucs
    training."""
    rng = np.random.default_rng(8)
    before = dict(att.LAUNCHES)
    x = torch.from_numpy(_randn(rng, 4, 64))
    for dt in (torch.float32, torch.bfloat16):
        xd = x.to(dt)
        dx, dgamma = bb.rmsnorm_backward(xd, torch.ones(64), xd)
        dpre, h = bb.gelu_backward(xd, xd)
        assert (dx.dtype, dgamma.dtype, dpre.dtype, h.dtype) == (dt, torch.float32, dt, dt)
        q = torch.from_numpy(_randn(rng, 1, 2, 64, 8)).to(dt)
        gates = torch.rand(1, 2, 64)
        merged = torch.from_numpy(_randn(rng, 1, 64, 16)).to(dt)
        dq, dk, dv, delta = att.attention_backward(q, q, q, merged, merged, 0.3, 50, gates=gates)
        assert (dq.dtype, delta.dtype) == (dt, torch.float32)
        dqkv, dz = bb.rope_gate_backward(dq, dk, dv, delta, gates, None)
        assert (dqkv.dtype, dz.dtype) == (dt, torch.float32)
    assert att.LAUNCHES == before
    q = torch.from_numpy(_randn(rng, 1, 1, 8, 8)).to(torch.bfloat16).requires_grad_(True)
    with pytest.raises(NotImplementedError, match="C16"):
        att.dot_product_attention(q, q, q).sum().backward()
