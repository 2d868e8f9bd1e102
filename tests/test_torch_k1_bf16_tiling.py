"""The arithmetic of K1's bf16 dQ launch on the CPU, before the card.

``csrc/attention_bwd_bf16.cuh``'s ``attention_bwd_dq_wgmma_bf16_kernel``
takes dQ in one pass over the key tiles: it keeps each row's running maximum,
rounds dS to bf16 *unnormalised* (against that maximum) a tile at a time,
rescales what it summed when the maximum grows, and divides by the row sum
of P at the end. The plain bf16 version (``ops/attention.attention_bwd_ref``)
rounds the normalised dS. ``tiled_dq`` below is that launch's arithmetic in
torch, tile by tile in the kernel's order, and is held:

* against the plain bf16 version, at the card tests' bf16 tolerance (max
  4·2⁻⁸, mean 2⁻¹⁰ of dq's scale);
* against ``jax.grad`` of the JAX package's unfused attention in bf16,
  within 6 dB of the JAX package's own bf16 error (as
  ``test_torch_bf16_training.py`` holds the blocks): dq alone against the
  gated unfused core (``ops/attention._einsum_attention``), and inside the
  port's bf16 attention block (autograd through the plain versions, dq from
  ``tiled_dq``) every gradient against the unfused block ``_attention``
  (``audio_separator_tpu/models/roformer.py``).

Cases: the flagship time axis's length (832 rows, 801 valid keys) at a
small batch and head count, and scores whose row maximum rises at every key
tile to about 20, so that every tile rescales the sums (held to the core:
tokens built to give such scores through the block's RMSNorm make its norm
gradient a sum that neither bf16 path keeps to 6 dB of the other, with or
without the tiling); inputs from a numpy seed."""

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
from torch_threads import one_torch_thread  # noqa: F401

BF = torch.bfloat16
TILE = 64  # the kernel's key tile
KERNEL_TOL = (4 * 2.0 ** -8, 2.0 ** -10)  # chip_smoke.py TOLERANCE["bfloat16"]
FAST_COMPILE = {"xla_backend_optimization_level": 0}
ATTN_KEYS = ("wqkv", "gate_w", "gate_b", "wo", "attn_norm")


def tiled_dq(q, k, v, merged, d_merged, gates, scale, n_valid):
    """dq as the dQ launch computes it: float32 scores, P against the
    running maximum, dS rounded to bf16 unnormalised a key tile at a time,
    the sums rescaled as the maximum grows, the row sum of P dividing at the
    end. Returns ``(dq bf16, log-sum-exp base 2, Δ)``."""
    b, h, n, dh = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    o, do = (t.float().reshape(b, n, h, dh).transpose(1, 2) for t in (merged, d_merged))
    delta = (do * o).sum(-1)
    gain = gates.float()[..., None]
    c2 = scale * math.log2(math.e)
    m = torch.full((b, h, n), -math.inf)
    l = torch.zeros(b, h, n)
    acc = torch.zeros(b, h, n, dh)
    for k0 in range(0, n_valid, TILE):
        kt, vt = kf[:, :, k0:k0 + TILE], vf[:, :, k0:k0 + TILE]
        s = torch.matmul(qf, kt.transpose(-1, -2)) * c2
        s = s.masked_fill(torch.arange(k0, k0 + kt.shape[2]) >= n_valid, -math.inf)
        mn = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - mn)
        p = torch.exp2(s - mn[..., None])
        ds = p * (torch.matmul(do, vt.transpose(-1, -2)) * gain - delta[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.matmul(ds.to(BF).float(), kt)
        m = mn
    return (acc * (scale / l)[..., None]).to(BF), m + torch.log2(l), delta


def _randn(rng, *shape, s=1.0):
    return (rng.standard_normal(shape) * s).astype(np.float32)


def _step_ramp(n, n_valid, top):
    """A value per key that steps up by top / tiles at every key tile of the
    valid keys (the keys past them as the last)."""
    tiles = -(-n_valid // TILE)
    return top * (np.minimum(np.arange(n), n_valid - 1) // TILE + 1) / tiles


def _core_case(seed, b, h, n, n_valid, late):
    rng = np.random.default_rng(seed)
    if late:
        # q·k·scale ≈ the ramp, so each tile raises every row's maximum; k's
        # own part is orthogonal to q's common direction e, so that it moves
        # the scores little but dq (Σ dS·k) a lot: k's common part, which
        # Σ dS nearly cancels, does not dominate dq.
        e = np.full(64, 0.125, np.float32)
        eta = _randn(rng, b, h, n, 64, s=4.0)
        eta -= (eta @ e)[..., None] * e
        q = _randn(rng, b, h, n, 64, s=0.01) + 8.0 * e
        k = eta + _step_ramp(n, n_valid, 20.0)[:, None] * e
    else:
        q, k = _randn(rng, b, h, n, 64), _randn(rng, b, h, n, 64)
    v = _randn(rng, b, h, n, 64)
    merged, d_merged = _randn(rng, b, n, h * 64), _randn(rng, b, n, h * 64)
    gates = 1 / (1 + np.exp(-_randn(rng, b, h, n)))
    bf = [torch.from_numpy(t).to(BF) for t in (q, k, v, merged, d_merged)]
    return (*bf, torch.from_numpy(gates.astype(np.float32)))


def _maxima_rise_at_every_tile(s, n_valid):
    """Whether every key tile of scores s (..., n) raises every row's
    running maximum."""
    tiles = s[..., :n_valid].split(TILE, dim=-1)
    running = tiles[0].amax(-1)
    for tile in tiles[1:]:
        if not bool((tile.amax(-1) > running).all()):
            return False
        running = torch.maximum(running, tile.amax(-1))
    return True


def _close_bf16(got, want, what):
    got, want = got.float(), want.float()
    scale = float(want.abs().max())
    diff = (got - want).abs()
    assert float(diff.max()) <= KERNEL_TOL[0] * scale, (what, float(diff.max()), scale)
    assert float(diff.mean()) <= KERNEL_TOL[1] * scale, (what, float(diff.mean()), scale)


@pytest.mark.parametrize("b,h,n,n_valid,late", [(2, 2, 832, 801, False), (2, 2, 832, 801, True),
                                                (2, 3, 300, 257, False), (1, 2, 300, 257, True)],
                         ids=["flagship", "flagship-late-maximum", "ragged",
                              "ragged-late-maximum"])
def test_tiled_dq_matches_the_plain_bf16_backward(b, h, n, n_valid, late):
    q, k, v, merged, d_merged, gates = _core_case(81 + n + late, b, h, n, n_valid, late)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * 0.125
    if late:
        assert float(s[..., :n_valid].max()) >= 15.0
        assert _maxima_rise_at_every_tile(s, n_valid)
    dq, lse2, delta = tiled_dq(q, k, v, merged, d_merged, gates, 0.125, n_valid)
    want = att.attention_bwd_ref(q, k, v, merged, d_merged, 0.125, n_valid, gates=gates)
    assert dq.dtype == BF and dq.shape == want[0].shape
    _close_bf16(dq, want[0], "dq")
    torch.testing.assert_close(delta, want[3], rtol=0, atol=1e-5 * float(want[3].abs().max()))
    lse_want = torch.logsumexp(s[..., :n_valid].double(), -1) * math.log2(math.e)
    torch.testing.assert_close(lse2.double(), lse_want, rtol=0, atol=1e-5)


# ------------------------------------------------------ against the JAX package


def _jax_core_dq(q, k, v, gates, d_merged, n_valid, dtype):
    """``jax.grad`` in q of Σ merged·d_merged, merged the gated heads of the
    JAX package's unfused attention core (``ops/attention._einsum_attention``)
    over the valid keys, in ``dtype``: dq, float32 numpy."""
    b, h, n, _ = q.shape
    kj, vj = (jnp.asarray(t[:, :, :n_valid].float().numpy(), dtype) for t in (k, v))
    g = jnp.asarray(gates.numpy())[..., None]
    dm = jnp.asarray(d_merged.float().numpy().reshape(b, n, h, 64).transpose(0, 2, 1, 3))

    def f(qj):
        o = jax_attention._einsum_attention(qj, kj, vj, 0.125)
        return jnp.sum(o.astype(jnp.float32) * g * dm)

    return np.asarray(jax.grad(f)(jnp.asarray(q.float().numpy(), dtype)), np.float32)


def _rel(a, b):
    return float(np.linalg.norm(a.astype(np.float64) - b.astype(np.float64))
                 / max(np.linalg.norm(b.astype(np.float64)), 1e-30))


@pytest.mark.parametrize("late", [False, True], ids=["flagship", "flagship-late-maximum"])
def test_tiled_dq_within_6db_of_the_jax_bf16_attention_error(late):
    """dq at 832 rows with 801 valid keys: ‖tiled − JAX float32‖ at most
    twice ‖JAX bf16 − JAX float32‖."""
    q, k, v, _, d_merged, gates = _core_case(85 + late, 1, 2, 832, 801, late)
    # The forward's own gated heads, as the bf16 forward rounds them: Δ then
    # belongs to the function that jax.grad differentiates.
    o = att.attention_ref(q, k[:, :, :801], v[:, :, :801], 0.125).float() * gates[..., None]
    merged = o.transpose(1, 2).reshape(1, 832, 128).to(BF)
    dq = tiled_dq(q, k, v, merged, d_merged, gates, 0.125, 801)[0].float().numpy()
    want = _jax_core_dq(q, k, v, gates, d_merged, 801, jnp.float32)
    jax_err = _rel(_jax_core_dq(q, k, v, gates, d_merged, 801, jnp.bfloat16), want)
    assert _rel(dq, want) <= 2 * jax_err, (_rel(dq, want), jax_err)


def _port_block_grads_bf16(w, x, dy, heads):
    """The port's attention block in bf16 with RoPE (the autograd Function,
    CPU: the plain versions) over the tokens padded to a multiple of 64:
    gradients of Σ out[:, :n]·dy, as float32 numpy."""
    _, n, _ = x.shape
    n_pad = -(-n // 64) * 64
    xt = torch.from_numpy(x).to(BF).requires_grad_(True)
    ws = {k: torch.from_numpy(w[k]).to(BF).requires_grad_(True) for k in ATTN_KEYS}
    cos, sin = _rope_tables(n, 64, BF)
    tables = (F.pad(cos, (0, 0, 0, n_pad - n)), F.pad(sin, (0, 0, 0, n_pad - n)))
    out = ab.fused_attention_block(F.pad(xt, (0, 0, 0, n_pad - n)), ws["wqkv"], ws["gate_w"],
                                   ws["gate_b"], ws["wo"], ws["attn_norm"], tables, heads,
                                   n_valid=n)
    grads = torch.autograd.grad(out[:, :n].float(), [xt, *ws.values()], torch.from_numpy(dy))
    return {k: g.float().numpy() for k, g in zip(("x",) + ATTN_KEYS, grads)}


def _jax_block_grads(w, x, dy, heads, dtype):
    """``jax.grad`` of the JAX unfused attention block (``models/roformer.
    _attention``, with RoPE) plus its residual in ``dtype``, float32 numpy."""
    p = {k: jnp.asarray(w[k], dtype) for k in ATTN_KEYS}
    tables = jax_roformer._rope_tables(x.shape[1], 64, dtype)

    def f(xj, pj):
        y = xj + jax_roformer._attention(pj, xj, heads, tables)
        return jnp.sum(y.astype(jnp.float32) * jnp.asarray(dy))

    args = (jnp.asarray(x, dtype), p)
    grad = jax.jit(jax.grad(f, argnums=(0, 1))).lower(*args).compile(
        compiler_options=FAST_COMPILE)
    gx, gp = grad(*args)
    return {k: np.asarray(v, np.float32) for k, v in {"x": gx, **gp}.items()}


def test_tiled_dq_block_gradients_within_6db_of_the_jax_bf16_error(monkeypatch):
    """The port's bf16 attention block with dq from ``tiled_dq``, at the
    flagship time axis's 801 tokens (padded to 832), 2 heads of 64, width
    128, against the JAX unfused block: every gradient within 6 dB of the
    JAX package's own bf16 error."""
    heads, n, d = 2, 801, 128
    rng = np.random.default_rng(91)
    w = dict(attn_norm=1 + _randn(rng, d, s=0.1), wqkv=_randn(rng, d, 3 * heads * 64, s=0.1),
             gate_w=_randn(rng, d, heads, s=0.1), gate_b=_randn(rng, heads, s=0.1),
             wo=_randn(rng, heads * 64, d, s=0.1))
    x, dy = _randn(rng, 1, n, d), _randn(rng, 1, n, d)
    calls = []

    def attention_backward_tiled(q, k, v, merged, d_merged, scale, n_valid=None, gates=None):
        _, dk, dv, delta = att.attention_backward(q, k, v, merged, d_merged, scale, n_valid,
                                                  gates=gates)
        calls.append(q.dtype)
        return tiled_dq(q, k, v, merged, d_merged, gates, scale, n_valid)[0], dk, dv, delta

    monkeypatch.setattr(bb, "attention_backward", attention_backward_tiled)
    got = _port_block_grads_bf16(w, x, dy, heads)
    assert calls == [BF]
    want = _jax_block_grads(w, x, dy, heads, jnp.float32)
    jax_bf16 = _jax_block_grads(w, x, dy, heads, jnp.bfloat16)
    for key in want:
        port_err, jax_err = _rel(got[key], want[key]), _rel(jax_bf16[key], want[key])
        assert port_err <= 2 * jax_err, (
            f"{key}: port bf16 (tiled dq) {port_err:.3e} against JAX float32, JAX bf16 "
            f"{jax_err:.3e} (bar 2x)")
