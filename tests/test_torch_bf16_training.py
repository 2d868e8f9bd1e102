"""bf16 training of the RoFormer family (``training.make_train_step(...,
compute_dtype=torch.bfloat16)``) on the CPU, against the JAX package.

The JAX package's whole bf16 step does not run on this CPU: XLA's CPU
backend has no bf16 x bf16 = float32 dot, which the band split's einsum asks
for (ROADMAP C17). ``jax.grad`` of its unfused blocks in bf16 does run. So:

* Per block: the bf16 gradients of the attention and feed-forward blocks
  through the port's autograd Functions (plain versions) against ``jax.grad``
  of the JAX unfused ``_attention`` / ``_feedforward`` (plus the residual) in
  bf16, on the same seeded inputs and weights. The bar is the reference's
  own bf16 error, measured here: for every gradient, ‖port bf16 − JAX
  float32‖ ≤ 2·‖JAX bf16 − JAX float32‖ (within 6 dB).
* Per kernel: each bf16 plain version (K1–K4) against autograd through the
  bf16 plain forward, at the card's bf16 tolerance (``chip_smoke.py``
  ``TOLERANCE["bfloat16"]``: max 4·2⁻⁸, mean 2⁻¹⁰ of each output's scale).
* The step: 3 SGD steps of the port's bf16 step against the JAX float32
  ``make_train_step`` for BS- and Mel-RoFormer (``STEP_BOUND``).
* The masters stay float32, and the products really ran in bf16.
* HTDemucs and HDemucs stay refused in bf16 (ROADMAP C16), and the JAX
  package's own bf16 gradient of HTDemucs raises.
* The sharded bf16 step, in one process and over two ``gloo`` processes,
  against the port's tp 1 bf16 step.
* The scope that holds the bf16 products' reductions in float32, under
  threads.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from audio_separator_tpu.models import htdemucs as jax_ht
from audio_separator_tpu.models import roformer as jax_roformer
from audio_separator_tpu.models.init_params import init_roformer_params
from audio_separator_tpu.training import make_train_step as jax_make_train_step
from audio_separator_tpu_torch.models import htdemucs as ht
from audio_separator_tpu_torch.models.convert import (export_jax_params, flatten_tree,
                                                      load_jax_params)
from audio_separator_tpu_torch.models.roformer import Roformer, RoformerConfig, _rope_tables
from audio_separator_tpu_torch.ops import attention as att
from audio_separator_tpu_torch.ops import attention_block as ab
from audio_separator_tpu_torch.ops import block_backward as bb
from audio_separator_tpu_torch.parallel import mesh
from audio_separator_tpu_torch.training import make_train_step
from test_torch_backward import ATTN_KEYS, BLOCK_CASES, FF_KEYS, _block_case, _randn
from test_torch_mesh_training import HT_KW
from test_torch_training import HDEMUCS_KW, MEL_KW, _port_config
from test_training import CFG as JAX_BS_CFG
from test_training import LOSS_KW, _data, _htdemucs_setup
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF = torch.bfloat16
FAST_COMPILE = {"xla_backend_optimization_level": 0}
KERNEL_TOL = (4 * 2.0 ** -8, 2.0 ** -10)  # chip_smoke.py TOLERANCE["bfloat16"]
# The step's SGD rate: large enough that every leaf's 3-step update is far
# above the float32 rounding of the master weight it is added to (at 1e-2
# some updates are a few float32 steps of their weight, and their relative
# error measures that rounding).
STEP_LR = 1.0
# Each leaf's 3-step update, bf16 port against the JAX float32 step, in
# relative L2: the block test below measures the JAX package's own bf16
# gradient error against its float32 one at 2.65e-2 at most over its cases
# (gate_b of the third BLOCK_CASE, a 6-token-wide sum), and the port is held
# to twice that (6 dB); a leaf's update is the sum of its gradients, so its
# relative error is bounded by theirs.
STEP_BOUND = 2 * 2.65e-2
# The losses: an eighth of one bf16 rounding (2⁻⁹). The loss is a mean over
# every sample of the output, which averages the bf16 roundings out.
LOSS_RTOL = 2.0 ** -12
FLAGSHIP_LAYER = (1, 62, 512, 8, 64, 2048, True)  # the frequency axis at flagship width


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - np.asarray(b, np.float64))
                 / max(np.linalg.norm(np.asarray(b, np.float64)), 1e-30))


# ------------------------------------------------------------------ per block


def _port_block_grads_bf16(which, w, x, dy, heads, dh, rope):
    """The port's block in bf16 (the autograd Function, CPU: the plain
    versions) over the tokens padded to a multiple of 64: gradients of
    Σ out[:, :n]·dy in x and the weights, as float32 numpy."""
    b, n, d = x.shape
    n_pad = -(-n // 64) * 64
    xt = torch.from_numpy(x).to(BF).requires_grad_(True)
    keys = ATTN_KEYS if which == "attention" else FF_KEYS
    ws = {k: torch.from_numpy(w[k]).to(BF).requires_grad_(True) for k in keys}
    xp = F.pad(xt, (0, 0, 0, n_pad - n))
    if which == "attention":
        tables = None
        if rope:
            cos, sin = _rope_tables(n, dh, BF)
            tables = (F.pad(cos, (0, 0, 0, n_pad - n)), F.pad(sin, (0, 0, 0, n_pad - n)))
        out = ab.fused_attention_block(xp, ws["wqkv"], ws["gate_w"], ws["gate_b"], ws["wo"],
                                       ws["attn_norm"], tables, heads, n_valid=n)
    else:
        out = ab.fused_ff_block(xp, ws["ff_norm"], ws["ff_w1"], ws["ff_b1"], ws["ff_w2"],
                                ws["ff_b2"])
    grads = torch.autograd.grad(out[:, :n].float(), [xt, *ws.values()], torch.from_numpy(dy))
    return {k: g.float().numpy() for k, g in zip(("x",) + keys, grads)}


def _jax_block_grads(which, w, x, dy, heads, dh, rope, dtype):
    """``jax.grad`` of the JAX unfused block plus its residual in ``dtype``
    (jitted, as the JAX step runs it), as float32 numpy."""
    keys = ATTN_KEYS if which == "attention" else FF_KEYS
    p = {k: jnp.asarray(w[k], dtype) for k in keys}
    tables = jax_roformer._rope_tables(x.shape[1], dh, dtype) if rope else None

    def f(xj, pj):
        if which == "attention":
            y = xj + jax_roformer._attention(pj, xj, heads, tables)
        else:
            y = xj + jax_roformer._feedforward(pj, xj)
        return jnp.sum(y.astype(jnp.float32) * jnp.asarray(dy))

    args = (jnp.asarray(x, dtype), p)
    grad = jax.jit(jax.grad(f, argnums=(0, 1))).lower(*args).compile(
        compiler_options=FAST_COMPILE)
    gx, gp = grad(*args)
    return {k: np.asarray(v, np.float32) for k, v in {"x": gx, **gp}.items()}


@pytest.mark.parametrize("which", ["attention", "feedforward"])
@pytest.mark.parametrize("case", BLOCK_CASES + [FLAGSHIP_LAYER])
def test_bf16_block_gradients_within_6db_of_the_jax_bf16_error(which, case):
    b, n, d, heads, dh, hidden, rope = case
    w, x, dy = _block_case(sum(case[:5]), b, n, d, heads, dh, hidden)
    want = _jax_block_grads(which, w, x, dy, heads, dh, rope, jnp.float32)
    jax_bf16 = _jax_block_grads(which, w, x, dy, heads, dh, rope, jnp.bfloat16)
    got = _port_block_grads_bf16(which, w, x, dy, heads, dh, rope)
    assert set(got) == set(want)
    for key in want:
        port_err, jax_err = _rel(got[key], want[key]), _rel(jax_bf16[key], want[key])
        assert port_err <= 2 * jax_err, (
            f"{key}: port bf16 {port_err:.3e} against JAX float32, JAX bf16 {jax_err:.3e} "
            f"(bar 2x); port against JAX bf16 {_rel(got[key], jax_bf16[key]):.3e}")


# ------------------------------------------------------------------ per kernel


def _close_bf16(got, want, what=""):
    got, want = got.detach().float(), want.detach().float()
    scale = float(want.abs().max())
    diff = (got - want).abs()
    assert float(diff.max()) <= KERNEL_TOL[0] * scale, (what, float(diff.max()), scale)
    assert float(diff.mean()) <= KERNEL_TOL[1] * scale, (what, float(diff.mean()), scale)


@pytest.mark.parametrize("dres", [False, True])
def test_rmsnorm_bf16_plain_backward_matches_autograd(dres):
    """K2's bf16 plain version against autograd through the blocks' bf16 norm
    (float32 inside, the output rounded to bf16), a zero row included."""
    rng = np.random.default_rng(14)
    x = torch.from_numpy(_randn(rng, 3, 10, 64)).to(BF)
    x[:, -2:] = 0
    gamma = torch.from_numpy(1 + _randn(rng, 64, s=0.1))
    dxn, res = (torch.from_numpy(_randn(rng, 3, 10, 64)).to(BF) for _ in range(2))
    xt, gt = x.clone().requires_grad_(True), gamma.clone().requires_grad_(True)
    xf = xt.float()
    xn = (xf * torch.rsqrt((xf * xf).sum(-1, keepdim=True).clamp_min(1e-24)) * 8.0 * gt).to(BF)
    wx, wg = torch.autograd.grad(xn, [xt, gt], dxn)
    dx, dgamma = bb.rmsnorm_backward(x, gamma, dxn, res if dres else None)
    assert (dx.dtype, dgamma.dtype) == (BF, torch.float32)
    _close_bf16(dx, (wx.float() + res.float()) if dres else wx, "dx")
    _close_bf16(dgamma, wg, "dgamma")


def test_gelu_bf16_plain_backward_matches_autograd():
    rng = np.random.default_rng(15)
    pre = torch.from_numpy(_randn(rng, 40, 64, s=2.0)).to(BF)
    dh = torch.from_numpy(_randn(rng, 40, 64)).to(BF)
    pt = pre.clone().requires_grad_(True)
    h = F.gelu(pt.float()).to(BF)
    (want,) = torch.autograd.grad(h, [pt], dh)
    dpre, got_h = bb.gelu_backward(pre, dh)
    assert (dpre.dtype, got_h.dtype) == (BF, BF)
    _close_bf16(dpre, want, "dpre")
    _close_bf16(got_h, h, "h")


@pytest.mark.parametrize("rope", [True, False])
def test_rope_gate_bf16_plain_backward_matches_autograd(rope):
    """K4's bf16 plain version against autograd through the bf16 QKV split,
    RoPE (rounded to bf16, as the forward rounds the rotated q and k) and
    the float32 gates."""
    b, n, heads, dh = 2, 12, 3, 16
    rng = np.random.default_rng(16)
    qkv = torch.from_numpy(_randn(rng, b, n, 3 * heads * dh)).to(BF).requires_grad_(True)
    z = torch.from_numpy(_randn(rng, b, n, heads)).requires_grad_(True)
    o = torch.from_numpy(_randn(rng, b, heads, n, dh))
    gq, gk, gv = (torch.from_numpy(_randn(rng, b, heads, n, dh)).to(BF) for _ in range(3))
    gm = torch.from_numpy(_randn(rng, b, heads, n, dh))
    tables = _rope_tables(n, dh, BF) if rope else None
    parts = qkv.reshape(b, n, 3, heads, dh).permute(2, 0, 3, 1, 4)
    q, k, v = parts[0], parts[1], parts[2]
    if rope:
        cos, sin = tables[0].float(), tables[1].float()
        q = (q.float() * cos + ab.rotate_half(q.float()) * sin).to(BF)
        k = (k.float() * cos + ab.rotate_half(k.float()) * sin).to(BF)
    gates = torch.sigmoid(z).transpose(1, 2)
    merged = o * gates[..., None]
    loss = ((q.float() * gq.float()).sum() + (k.float() * gk.float()).sum()
            + (v.float() * gv.float()).sum() + (merged * gm).sum())
    want_qkv, want_z = torch.autograd.grad(loss, [qkv, z])
    delta = (gm * merged).sum(-1).detach()
    dqkv, dz = bb.rope_gate_backward(gq, gk, gv, delta, gates.detach(), tables)
    assert (dqkv.dtype, dz.dtype) == (BF, torch.float32)
    _close_bf16(dqkv, want_qkv, "dqkv")
    _close_bf16(dz, want_z, "dz")


@pytest.mark.parametrize("n,n_valid", [(64, 62), (128, 101)])
def test_attention_bf16_plain_backward_matches_autograd(n, n_valid):
    """K1's bf16 plain version (the gated layout) against autograd through
    the bf16 plain attention of the block (P rounded to bf16, the merged
    heads O·g rounded to bf16), keys past n_valid masked."""
    b, heads, dh = 2, 4, 16
    rng = np.random.default_rng(17 + n)
    q, k, v = (torch.from_numpy(_randn(rng, b, heads, n, dh)).to(BF).requires_grad_(True)
               for _ in range(3))
    gates = torch.sigmoid(torch.from_numpy(_randn(rng, b, heads, n)))
    dm = torch.from_numpy(_randn(rng, b, n, heads * dh)).to(BF)
    s = (q.float() @ k.float().transpose(-1, -2)) * dh ** -0.5
    s = s.masked_fill(torch.arange(n) >= n_valid, -1e30)
    p = torch.softmax(s, -1).to(BF).float()
    o = (p @ v.float()) * gates[..., None]
    merged = o.permute(0, 2, 1, 3).reshape(b, n, heads * dh).to(BF)
    want = torch.autograd.grad(merged, [q, k, v], dm)
    got = att.attention_backward(q.detach(), k.detach(), v.detach(), merged.detach(), dm,
                                 dh ** -0.5, n_valid, gates=gates)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == BF
        _close_bf16(g, w, name)
    _close_bf16(got[3], (dm.float() * merged.float()).reshape(b, n, heads, dh).sum(-1)
                .transpose(1, 2), "delta")


# ------------------------------------------------------------------ the step


def _mel_case():
    jcfg = jax_roformer.RoformerConfig(**MEL_KW)
    rng = np.random.default_rng(5)
    chunk = 128 * 15
    mix = rng.standard_normal((2, 2, chunk)).astype(np.float32) * 0.2
    target = (0.5 * rng.standard_normal((2, 1, 2, chunk)).astype(np.float32) * 0.2
              + 0.5 * mix[:, None])
    return jcfg, RoformerConfig(**MEL_KW), init_roformer_params(jcfg, seed=2), mix, target


def _bs_case():
    mix, target = (np.asarray(a) for a in _data(2, seed=1))
    return (JAX_BS_CFG, _port_config(JAX_BS_CFG), init_roformer_params(JAX_BS_CFG, seed=0),
            mix, target)


def _port_steps(pcfg, tree, mix, target, dtype, steps=3, m=None):
    """``steps`` SGD steps of the port from ``tree``: (losses, exported tree,
    the module)."""
    model = load_jax_params(Roformer(pcfg), tree)
    if m is not None:
        model = mesh.shard_model(model, m)
    step = make_train_step(pcfg, model, torch.optim.SGD(model.parameters(), lr=STEP_LR),
                           mesh=m, compute_dtype=dtype, **LOSS_KW)
    tmix, ttarget = torch.from_numpy(mix.copy()), torch.from_numpy(target.copy())
    losses = [float(step(tmix, ttarget)) for _ in range(steps)]
    return losses, flatten_tree(export_jax_params(model)), model


@pytest.mark.parametrize("case", ["bs_roformer", "mel_roformer"])
def test_bf16_sgd_steps_match_the_jax_float32_step(case):
    """3 SGD steps (rate ``STEP_LR``): the losses within ``LOSS_RTOL`` and
    every leaf's update (after − before) within ``STEP_BOUND`` relative L2
    of the JAX float32 step's."""
    jcfg, pcfg, tree, mix, target = {"bs_roformer": _bs_case, "mel_roformer": _mel_case}[case]()
    jstep, jstate = jax_make_train_step(jcfg, optax.sgd(STEP_LR), tree, **LOSS_KW)
    params = jax.tree.map(jnp.asarray, tree)
    jstep = jstep.lower(params, jstate, mix, target).compile(compiler_options=FAST_COMPILE)
    jlosses = []
    for _ in range(3):
        params, jstate, loss = jstep(params, jstate, mix, target)
        jlosses.append(float(loss))
    losses, got, _ = _port_steps(pcfg, tree, mix, target, BF)
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    want, before = flatten_tree(jax.tree.map(np.asarray, params)), flatten_tree(tree)
    assert sorted(got) == sorted(want)
    errs = {k: _rel(got[k] - before[k], want[k] - before[k]) for k in want}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= STEP_BOUND, (worst, errs[worst], STEP_BOUND)


def test_bf16_step_keeps_float32_masters_and_runs_bf16_products():
    """The module's parameters and their gradients stay float32; the bf16
    step's losses part from the float32 step's by more than float32 noise
    (2⁻²⁰ of the loss, eight float32 roundings) and its gradients by more
    than 1e-3 relative L2 (bf16 keeps 2⁻⁹), so the products ran in bf16."""
    _, pcfg, tree, mix, target = _bs_case()
    f32_losses, _, f32 = _port_steps(pcfg, tree, mix, target, torch.float32, steps=1)
    bf_losses, _, bf = _port_steps(pcfg, tree, mix, target, BF, steps=1)
    for model in (f32, bf):
        assert all(p.dtype == torch.float32 for p in model.parameters())
        assert all(p.grad is not None and p.grad.dtype == torch.float32
                   for p in model.parameters())
    assert abs(bf_losses[0] - f32_losses[0]) > 2.0 ** -20 * abs(f32_losses[0])
    g32 = torch.cat([p.grad.flatten() for p in f32.parameters()])
    g16 = torch.cat([p.grad.flatten() for p in bf.parameters()])
    assert _rel(g16.numpy(), g32.numpy()) > 1e-3


def test_bf16_training_contract_and_refusals():
    """bf16 is taken for the RoFormer family; a bf16 module (its masters would
    be bf16) and any compute type other than float32 or bf16 are refused;
    HTDemucs and HDemucs in bf16 are refused naming ROADMAP C16."""
    model = load_jax_params(Roformer(_port_config(JAX_BS_CFG)),
                            init_roformer_params(JAX_BS_CFG, seed=0))
    opt = torch.optim.SGD(model.parameters(), lr=1e-2)
    assert callable(make_train_step(model.cfg, model, opt, compute_dtype=BF))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        make_train_step(model.cfg, model, opt, compute_dtype=torch.float16)
    with pytest.raises(NotImplementedError, match="master weights"):
        make_train_step(model.cfg, model.to(BF), opt, compute_dtype=BF)
    cfg = ht.HTDemucsConfig(**HDEMUCS_KW, dconv_lstm=2, dconv_attn=2, dconv_comp=4)
    for demucs in (ht.HTDemucs(ht.HTDemucsConfig(**HT_KW)), ht.HDemucs(cfg)):
        with pytest.raises(NotImplementedError, match="C16"):
            make_train_step(demucs.cfg, demucs, torch.optim.SGD(demucs.parameters(), lr=1e-2),
                            compute_dtype=BF)


def test_jax_htdemucs_bf16_gradient_raises():
    """ROADMAP C16: the JAX package cannot differentiate HTDemucs in bf16 (the
    transpose of its transposed convolution mixes bf16 and float32), so the
    port refuses it too. If this stops raising, the item has become
    portable."""
    jcfg, tree, mix, _ = _htdemucs_setup()

    def loss(p):
        return jnp.sum(jax_ht.apply_htdemucs(p, jcfg, jnp.asarray(mix),
                                             compute_dtype=jnp.bfloat16).astype(jnp.float32))

    with pytest.raises(TypeError, match="same dtypes"):  # raised while tracing
        jax.eval_shape(jax.grad(loss), jax.tree.map(jnp.asarray, tree))


# ------------------------------------------------------------------ the mesh

CPU = torch.device("cpu")


def test_sharded_bf16_steps_match_the_tp1_bf16_step():
    """3 bf16 SGD steps on a dp 2 × tp 2 mesh of CPU handles against the
    unsharded bf16 steps on the same batch: losses within ``LOSS_RTOL`` and
    every leaf's update within ``STEP_BOUND`` (each run is within it of the
    float32 step; the shards round their partial products to bf16 where the
    unsharded blocks round once)."""
    _, pcfg, tree, _, _ = _bs_case()
    mix, target = (np.asarray(a) for a in _data(4, seed=1))
    want_losses, want, _ = _port_steps(pcfg, tree, mix, target, BF)
    m = mesh.make_mesh(devices=[CPU] * 4, dp=2, tp=2)
    losses, got, model = _port_steps(pcfg, tree, mix, target, BF, m=m)
    assert any("tp_shards" in n for n, _ in model.named_parameters())
    assert all(p.dtype == torch.float32 for p in model.parameters())
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    before = flatten_tree(tree)
    errs = {k: _rel(got[k] - before[k], want[k] - before[k]) for k in want}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= STEP_BOUND, (worst, errs[worst], STEP_BOUND)


_WORKER = """
import sys
import numpy as np
import torch
from audio_separator_tpu_torch.models.convert import export_jax_params, flatten_tree
from audio_separator_tpu_torch.models.convert import load_jax_params
from audio_separator_tpu_torch.models.init_params import init_roformer_params
from audio_separator_tpu_torch.models.roformer import Roformer
from audio_separator_tpu_torch.parallel import dcn_dryrun
from audio_separator_tpu_torch.parallel.mesh import (init_distributed_from_env, make_mesh,
                                                     shard_model)
from audio_separator_tpu_torch.training import make_train_step

torch.set_num_threads(1)
assert init_distributed_from_env(backend="gloo")
m = make_mesh(devices=[torch.device("cpu")] * 4, tp=2)
model = shard_model(load_jax_params(Roformer(dcn_dryrun.CFG),
                                    init_roformer_params(dcn_dryrun.CFG, seed=0)), m)
step = make_train_step(dcn_dryrun.CFG, model, torch.optim.SGD(model.parameters(), lr=%r),
                       mesh=m, compute_dtype=torch.bfloat16, **dcn_dryrun.LOSS_KW)
mix, target = dcn_dryrun.global_batch(m.shape["data"])
rows = slice(m.process_index * m.local_rows, (m.process_index + 1) * m.local_rows)
loss = float(step(torch.from_numpy(mix[rows]), torch.from_numpy(target[rows])))
if m.process_index == 0:
    np.savez(sys.argv[1], loss=loss, **flatten_tree(export_jax_params(model)))
import torch.distributed as dist
dist.destroy_process_group()
""" % STEP_LR


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_processes_take_one_sharded_bf16_step(tmp_path):
    """Two processes × 4 CPU handles under ``gloo`` (a dp 4 × tp 2 mesh, one
    item a data row) take one bf16 step on their parts of the global batch:
    its loss and every leaf's update against the unsharded bf16 step on the
    whole batch, as in the test above."""
    from audio_separator_tpu_torch.parallel import dcn_dryrun

    out = str(tmp_path / "sharded.npz")
    for attempt in range(2):  # one retry on a fresh port, as the float32 test does
        port = _free_port()
        procs = []
        for pid in range(2):
            env = dict(os.environ)
            env.update({"PYTHONPATH": REPO + os.pathsep + env.get("PYTHONPATH", ""),
                        "OMP_NUM_THREADS": "1", "AUDSEP_COORDINATOR": f"127.0.0.1:{port}",
                        "AUDSEP_NUM_PROCESSES": "2", "AUDSEP_PROCESS_ID": str(pid)})
            procs.append(subprocess.Popen([sys.executable, "-c", _WORKER, out], env=env,
                                          cwd=REPO, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True))
        try:
            outs = [p.communicate(timeout=120) for p in procs]
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
                p.communicate()
            if attempt == 0:
                continue
            raise
        for p, (o, e) in zip(procs, outs):
            assert p.returncode == 0, f"worker failed:\nstdout={o}\nstderr={e}"
        break
    got = dict(np.load(out))
    tree = init_roformer_params(dcn_dryrun.CFG, seed=0)
    mix, target = dcn_dryrun.global_batch(4)
    (want_loss,), want, _ = _port_steps(dcn_dryrun.CFG, tree, mix, target, BF, steps=1)
    np.testing.assert_allclose(float(got.pop("loss")), want_loss, rtol=LOSS_RTOL)
    before = flatten_tree(tree)
    assert sorted(got) == sorted(want)
    errs = {k: _rel(got[k] - before[k], want[k] - before[k]) for k in want}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= STEP_BOUND, (worst, errs[worst], STEP_BOUND)


# ------------------------------------------------------------------ the reductions scope


def test_float32_bf16_reductions_holds_while_any_thread_is_inside():
    """``ops/precision.float32_bf16_reductions`` counts the scopes open in
    every thread, as ``full_float32`` does: A enters, B enters, A leaves while
    B is inside (the switch still off), B leaves (the switch restored); it
    nests and restores after an error."""
    import threading

    from audio_separator_tpu_torch.ops.precision import float32_bf16_reductions

    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = True
    try:
        a_in, b_in, a_out = threading.Event(), threading.Event(), threading.Event()
        seen, errors = {}, []

        def thread_a():
            try:
                with float32_bf16_reductions():
                    seen["a inside"] = matmul.allow_bf16_reduced_precision_reduction
                    a_in.set()
                    assert b_in.wait(30)
                a_out.set()
            except BaseException as exc:  # reported by the main thread
                errors.append(exc)
                a_out.set()

        def thread_b():
            try:
                assert a_in.wait(30)
                with float32_bf16_reductions():
                    b_in.set()
                    assert a_out.wait(30)
                    seen["b after a left"] = matmul.allow_bf16_reduced_precision_reduction
            except BaseException as exc:
                errors.append(exc)
                b_in.set()

        threads = [threading.Thread(target=thread_a), threading.Thread(target=thread_b)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not errors, errors
        assert seen == {"a inside": False, "b after a left": False}
        assert matmul.allow_bf16_reduced_precision_reduction is True
        with pytest.raises(ValueError):
            with float32_bf16_reductions(), float32_bf16_reductions():
                assert matmul.allow_bf16_reduced_precision_reduction is False
                raise ValueError("inside")
        assert matmul.allow_bf16_reduced_precision_reduction is True
    finally:
        matmul.allow_bf16_reduced_precision_reduction = saved
