"""The port's device mesh (``audio_separator_tpu_torch/parallel/mesh.py``)
against the JAX package's on its 8-device CPU mesh, at small sizes.

* ``make_mesh``: the shapes and errors of the JAX ``make_mesh``, over
  repeated CPU handles.
* Placements: the port's col/row/rep leaf sets equal the JAX specs leaf for
  leaf, for a RoFormer (with a linear-attention stack and two mask-estimator
  hidden layers) and an HTDemucs tree; ``wqkv``'s shards are cut by heads
  (ROADMAP C14), which is asserted explicitly against the JAX contiguous cut.
* The partial-sum forms of the two fused blocks: ``x + Σ partials (+ b2)``
  equals the full block to 1e-5 of its scale, and their gradients equal
  autograd through the plain parts.
* Tensor-parallel forwards: a BS-RoFormer (depth 2, dim 128, 4 heads) at
  tp 2 and 4 and an HTDemucs on a dp 2 × tp 2 mesh, each against the port's
  unsharded forward and the JAX sharded forward (jitted with its batch on
  the data axis), at 1e-4 of the output's scale.
* One shard is the unsharded module: a RoFormer laid out at tp 1 gives the
  unsharded module's outputs and training-loss gradients bit for bit.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from audio_separator_tpu.models import htdemucs as jax_ht
from audio_separator_tpu.models import roformer as jax_roformer
from audio_separator_tpu.models.init_params import init_roformer_params
from audio_separator_tpu.parallel import mesh as jax_mesh
from audio_separator_tpu_torch.models import htdemucs as ht
from audio_separator_tpu_torch.models.convert import (flatten_tree, load_jax_htdemucs_params,
                                                      load_jax_params)
from audio_separator_tpu_torch.models.init_params import init_htdemucs_params
from audio_separator_tpu_torch.models.roformer import Roformer, RoformerConfig
from audio_separator_tpu_torch.ops import attention_block as ab
from audio_separator_tpu_torch.parallel import mesh
from audio_separator_tpu_torch.training import make_loss_fn
from torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
FAST_COMPILE = {"xla_backend_optimization_level": 0}
FWD_TOL = 1e-4
BS_KW = dict(kind="bs", dim=128, depth=2, stereo=True, num_stems=2, time_transformer_depth=1,
             freq_transformer_depth=1, freqs_per_bands=(2, 2, 4, 8, 16, 32, 64, 129),
             dim_head=32, heads=4, stft_n_fft=512, stft_hop_length=128, stft_win_length=512,
             mask_estimator_depth=2)
MEL_LINEAR_KW = dict(kind="mel", dim=32, depth=1, stereo=True, num_stems=2,
                     time_transformer_depth=1, freq_transformer_depth=1,
                     linear_transformer_depth=1, num_bands=16, dim_head=8, heads=4,
                     stft_n_fft=512, stft_hop_length=128, stft_win_length=512,
                     mask_estimator_depth=2)
HT_KW = dict(sources=("drums", "bass", "other", "vocals"), channels=8, nfft=1024, depth=3,
             t_layers=2, t_heads=4, segment=0.5)


def _place(sharding, out_axis=-1) -> str:
    """A JAX NamedSharding (in flatten_tree's 0-d object array) as a port
    placement: split on the output features (``out_axis``: last in the
    RoFormer's (in, out) layout, first in torch's (out, in)) is "col"."""
    spec = tuple(np.asarray(sharding).item().spec)
    if not any(spec):
        return "rep"
    assert spec.count("model") == 1, spec
    return "col" if spec[out_axis] == "model" else "row"


def _randn(*shape, seed=0, scale=0.2):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# ------------------------------------------------------------------ make_mesh


@pytest.mark.parametrize("n,dp,tp", [(4, None, None), (4, 2, 2), (8, None, 2), (4, 3, None)])
def test_make_mesh_matches_jax(n, dp, tp):
    try:
        want = dict(jax_mesh.make_mesh(n_devices=n, dp=dp, tp=tp).shape)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            mesh.make_mesh(n_devices=n, dp=dp, tp=tp, devices=[CPU] * 8)
        return
    got = mesh.make_mesh(n_devices=n, dp=dp, tp=tp, devices=[CPU] * 8)
    assert got.shape == want
    assert got.devices.shape == (want["data"], want["model"])
    assert got.axis_names == ("data", "model") and got.first == CPU


def test_init_distributed_without_the_contract_returns_false(monkeypatch):
    for var in ("AUDSEP_COORDINATOR", "AUDSEP_NUM_PROCESSES", "AUDSEP_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert mesh.init_distributed_from_env() is False


# ------------------------------------------------------------------ placements


def test_roformer_placements_match_jax_and_wqkv_is_cut_by_heads():
    jcfg = jax_roformer.RoformerConfig(**MEL_LINEAR_KW)
    tree = init_roformer_params(jcfg, seed=0)
    jmesh = jax_mesh.make_mesh(n_devices=4, tp=2)
    want = {k: _place(v) for k, v in flatten_tree(
        jax_mesh.roformer_param_shardings(tree, jmesh)).items()}
    got = flatten_tree(mesh.roformer_param_shardings(tree))
    got = {k: str(v) for k, v in got.items()}
    assert got == want
    assert {k for k, v in got.items() if v == "col"} >= {"blocks.linear.wqkv",
                                                         "mask_est.hidden.1.w"}

    # C14: shard s holds q, k and v of heads [s·h/tp, (s+1)·h/tp), where the
    # JAX contiguous cut gives shard 0 all of q and none of v.
    heads, dh, tp = jcfg.heads, jcfg.dim_head, 2
    hd = heads * dh
    cols0 = mesh.wqkv_shard_columns(heads, dh, tp, 0)
    assert list(cols0) == (list(range(0, hd // 2)) + list(range(hd, hd + hd // 2))
                           + list(range(2 * hd, 2 * hd + hd // 2)))
    jax_cols0 = np.arange(3 * hd)[: 3 * hd // tp]
    assert set(jax_cols0) >= set(range(hd)) and not set(jax_cols0) & set(range(2 * hd, 3 * hd))
    sharded = mesh.shard_roformer_params(
        load_jax_params(Roformer(RoformerConfig(**MEL_LINEAR_KW)), tree),
        mesh.make_mesh(devices=[CPU] * 4, tp=tp))
    full = np.asarray(tree["blocks"]["time"]["wqkv"])
    for s in range(tp):
        np.testing.assert_array_equal(
            sharded.tp_shards[s]["blocks"]["time"]["wqkv"].numpy(),
            full[..., mesh.wqkv_shard_columns(heads, dh, tp, s)])


def test_htdemucs_placements_match_jax():
    tree = init_htdemucs_params(ht.HTDemucsConfig(**HT_KW), seed=3)
    jmesh = jax_mesh.make_mesh(n_devices=4, dp=2, tp=2)
    want = {k: _place(v, out_axis=0) for k, v in flatten_tree(
        jax_mesh.htdemucs_param_shardings(tree, jmesh)).items()}
    got = {k: str(v) for k, v in flatten_tree(mesh.htdemucs_param_shardings(tree)).items()}
    assert got == want
    assert got["crosstransformer.layers.0.linear1.weight"] == "col"
    assert got["crosstransformer.layers.0.linear2.weight"] == "row"
    assert got["crosstransformer.layers.0.linear2.bias"] == "rep"
    assert got["crosstransformer.layers.0.self_attn.in_proj_weight"] == "rep"


# ------------------------------------------------------- partial-sum blocks


def _attention_inputs(tp, seed=0, b=2, n=128, d=64, heads=4, dh=16):
    r = np.random.default_rng(seed)

    def t(*shape, scale=0.2):
        return torch.from_numpy((r.standard_normal(shape) * scale).astype(np.float32))

    x = t(b, n, d, scale=1.0)
    wqkv, gate_w, gate_b, wo = t(d, 3 * heads * dh), t(d, heads), t(heads), t(heads * dh, d)
    norm = 1.0 + t(d, scale=0.1)
    ang = torch.arange(n)[:, None] * (0.1 / (1 + torch.arange(dh)))[None]
    rope = (torch.cos(ang).float(), torch.sin(ang).float())
    return x, (wqkv, gate_w, gate_b, wo, norm), rope, heads, dh


def _attention_shard(weights, heads, dh, tp, s):
    wqkv, gate_w, gate_b, wo, norm = weights
    hs = heads // tp
    cols = torch.as_tensor(mesh.wqkv_shard_columns(heads, dh, tp, s))
    return (wqkv[:, cols].contiguous(), gate_w[:, s * hs : (s + 1) * hs].contiguous(),
            gate_b[s * hs : (s + 1) * hs].contiguous(),
            wo[s * hs * dh : (s + 1) * hs * dh].contiguous(), norm)


@pytest.mark.parametrize("tp", [2, 4])
def test_partial_blocks_sum_to_the_full_blocks(tp):
    x, weights, rope, heads, dh = _attention_inputs(tp)
    n_valid = 101
    full = ab.fused_attention_block(x, *weights, rope, heads, n_valid)
    parts = [ab.fused_attention_block(x, *_attention_shard(weights, heads, dh, tp, s), rope,
                                      heads // tp, n_valid, partial=True) for s in range(tp)]
    scale = float(full.abs().max())
    torch.testing.assert_close(x + sum(parts), full, atol=1e-5 * scale, rtol=0)

    r = np.random.default_rng(1)
    d, hidden = x.shape[-1], 256
    w1, b1, w2, b2 = (torch.from_numpy((r.standard_normal(s) * 0.1).astype(np.float32))
                      for s in ((d, hidden), (hidden,), (hidden, d), (d,)))
    norm = weights[-1]
    full = ab.fused_ff_block(x, norm, w1, b1, w2, b2)
    w = hidden // tp
    parts = [ab.fused_ff_block(x, norm, w1[:, s * w : (s + 1) * w].contiguous(),
                               b1[s * w : (s + 1) * w].contiguous(),
                               w2[s * w : (s + 1) * w].contiguous(), None, partial=True)
             for s in range(tp)]
    torch.testing.assert_close(x + sum(parts) + b2, full,
                               atol=1e-5 * float(full.abs().max()), rtol=0)
    with pytest.raises(ValueError, match="b2=None"):
        ab.fused_ff_block(x, norm, w1, b1, w2, b2, partial=True)


def _grads(fn, tensors, dy):
    tensors = [t.detach().clone().requires_grad_(True) for t in tensors]
    out = fn(*tensors)
    return out, torch.autograd.grad(out, tensors, dy)


def test_partial_block_gradients_match_autograd_of_the_plain_parts():
    """The Functions' hand-composed backward (ops/block_backward.py, plain
    versions on the CPU) against autograd through the plain forward."""
    x, weights, rope, heads, dh = _attention_inputs(2, seed=2)
    shard = _attention_shard(weights, heads, dh, 2, 1)
    n_valid = 90
    dy = torch.from_numpy(_randn(*x.shape, seed=3))

    def fused(x, *w):
        return ab.fused_attention_block(x, *w, rope, heads // 2, n_valid, partial=True)

    def plain(x, *w):
        return ab.fused_attention_block_ref(x, *w, rope, heads // 2, n_valid, partial=True)

    out, got = _grads(fused, (x, *shard), dy)
    ref, want = _grads(plain, (x, *shard), dy)
    torch.testing.assert_close(out, ref, atol=1e-6, rtol=0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5 * float(w.abs().max()), rtol=0)

    r = np.random.default_rng(4)
    d, width = x.shape[-1], 96
    ff = [torch.from_numpy((r.standard_normal(s) * 0.1).astype(np.float32))
          for s in ((d,), (d, width), (width,), (width, d))]
    out, got = _grads(lambda x, *w: ab.fused_ff_block(x, *w, None, partial=True), (x, *ff), dy)
    ref, want = _grads(lambda x, *w: ab.fused_ff_block_ref(x, *w, None, partial=True),
                       (x, *ff), dy)
    torch.testing.assert_close(out, ref, atol=1e-6, rtol=0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5 * float(w.abs().max()), rtol=0)


# ------------------------------------------------------ tensor-parallel forwards


@pytest.fixture(scope="module")
def bs_setup():
    jcfg = jax_roformer.RoformerConfig(**BS_KW)
    tree = init_roformer_params(jcfg, seed=5)
    model = load_jax_params(Roformer(RoformerConfig(**BS_KW)), tree)
    mix = _randn(2, 2, BS_KW["stft_hop_length"] * 31, seed=6)
    with torch.no_grad():
        base = model(torch.from_numpy(mix)).numpy()
    return jcfg, tree, model, mix, base


def _jax_sharded_forward(apply, params, shard, jcfg, mix, dp, tp):
    jm = jax_mesh.make_mesh(n_devices=dp * tp, dp=dp, tp=tp)
    data = NamedSharding(jm, P("data"))
    sharded = shard(jax.tree.map(np.asarray, params), jm)

    def fwd(p, x):
        return apply(p, jcfg, jax.lax.with_sharding_constraint(x, data))

    x = jax.device_put(jnp.asarray(mix), data)
    compiled = jax.jit(fwd).lower(sharded, x).compile(compiler_options=FAST_COMPILE)
    return np.asarray(compiled(sharded, x))


@pytest.mark.parametrize("tp", [2, 4])
def test_roformer_tp_forward_matches_unsharded_and_jax(bs_setup, tp):
    jcfg, tree, model, mix, base = bs_setup
    m = mesh.make_mesh(devices=[CPU] * 4, tp=tp)
    sharded = mesh.shard_roformer_params(model, m)
    assert len(sharded.tp_shards) == tp
    with torch.no_grad():
        got = sharded(torch.from_numpy(mix)).numpy()
    scale = float(np.abs(base).max())
    np.testing.assert_allclose(got, base, atol=1e-5 * scale, rtol=0)
    want = _jax_sharded_forward(jax_roformer.apply_roformer, tree,
                                jax_mesh.shard_roformer_params, jcfg, mix, 4 // tp, tp)
    np.testing.assert_allclose(got, want, atol=FWD_TOL * scale, rtol=0)


def test_htdemucs_tp_forward_on_a_2x2_mesh_matches_unsharded_and_jax():
    cfg = ht.HTDemucsConfig(**HT_KW)
    tree = init_htdemucs_params(cfg, seed=7)
    model = load_jax_htdemucs_params(ht.HTDemucs(cfg), tree).eval()
    m = mesh.make_mesh(devices=[CPU] * 4, dp=2, tp=2)
    sharded = mesh.shard_htdemucs_params(model, m)
    layer = sharded.crosstransformer.layers[0]
    assert len(layer.tp_shards) == 2 and not hasattr(layer, "linear1")
    mix = _randn(2, 2, cfg.training_length, seed=8)
    with torch.no_grad():
        base = model(torch.from_numpy(mix)).numpy()
        got = sharded(torch.from_numpy(mix)).numpy()
    scale = float(np.abs(base).max())
    np.testing.assert_allclose(got, base, atol=1e-5 * scale, rtol=0)
    known = jax_ht.HTDemucsConfig.__dataclass_fields__
    jcfg = jax_ht.HTDemucsConfig(**{k: v for k, v in HT_KW.items() if k in known})
    want = _jax_sharded_forward(jax_ht.apply_htdemucs, tree, jax_mesh.shard_htdemucs_params,
                                jcfg, mix, 2, 2)
    np.testing.assert_allclose(got, want, atol=FWD_TOL * scale, rtol=0)


def _random_roformer(kw, seed):
    """A RoFormer with every leaf drawn at random, its biases too: the
    seeded trees keep biases zero, which would hide where a bias is added."""
    model = Roformer(RoformerConfig(**kw))
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            gain = 1.0 if name.endswith(("norm", "gamma")) else 0.0
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2 + gain)
    return model


@pytest.mark.parametrize("kw", [BS_KW, MEL_LINEAR_KW], ids=["bs", "mel_linear"])
def test_one_shard_runs_the_unsharded_path_bit_for_bit(kw):
    """On a pure-data mesh every split leaf is one shard (``tp_shards.0``):
    the module runs the unsharded layers, so its outputs and the gradients
    of a training loss, replicated and split leaves alike, equal the
    unsharded module's exactly."""
    model = _random_roformer(kw, seed=3).requires_grad_(True)
    one = mesh.shard_roformer_params(model, mesh.make_mesh(devices=[CPU] * 4, tp=1))
    assert len(one.tp_shards) == 1
    assert any(n.startswith("tp_shards.0.") for n, _ in one.named_parameters())
    length = kw["stft_hop_length"] * 31
    mix = torch.from_numpy(_randn(2, 2, length, seed=4))
    target = torch.from_numpy(_randn(2, kw["num_stems"], 2, length, seed=5))
    outs, grads = [], []
    for m in (model, one):
        with torch.no_grad():
            outs.append(m(mix))
        make_loss_fn(m.cfg, m, stft_n_fft=256, window_sizes=(256, 128),
                     hop_length=64)(mix, target).backward()
        grads.append({n.replace("tp_shards.0.", ""): p.grad for n, p in m.named_parameters()})
    assert torch.equal(outs[0], outs[1])
    want, got = grads
    assert got.keys() == want.keys()
    for name in want:
        assert want[name] is not None and torch.equal(got[name], want[name]), name
