"""The port's training (``audio_separator_tpu_torch/training.py``,
``ops/losses.py``) against the JAX package's on the CPU.

* The losses against ``audio_separator_tpu/ops/losses.py`` on the inputs of
  tests/test_losses.py (rtol 1e-5 for the L1, 1e-4 for the STFT terms, as
  there), and their gradients against ``jax.grad`` (1e-5 of the gradient's
  largest magnitude: float32 FFTs in different orders).
* The whole step: ``make_train_step`` against the JAX ``make_train_step``
  over 3 SGD steps (``torch.optim.SGD(lr=1e-2)`` against ``optax.sgd(1e-2)``)
  from one parameter tree, for BS-RoFormer (tests/test_training.py's tiny
  ``CFG``), Mel-RoFormer, HTDemucs (its ``_htdemucs_setup``) and HDemucs:
  losses at rtol 2e-4 and every updated leaf at atol 2e-4, the tolerances of
  tests/test_training.py's sharded-against-replicated check. The JAX side
  trains on its unfused path (it cannot differentiate its Pallas kernels);
  the port runs its blocks' autograd Functions, whose CPU forward and
  backward are the kernels' plain versions.
* Adam: the loss decreases, as in tests/test_training.py.
* ``mesh=`` takes a module laid out for the mesh (tests/test_torch_mesh_training.py
  holds the sharded step), bf16 is taken for the RoFormer family alone
  (tests/test_torch_bf16_training.py holds the bf16 step), and inference
  builds no graph.
"""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_separator_tpu.models import htdemucs as jax_ht
from audio_separator_tpu.models import roformer as jax_roformer
from audio_separator_tpu.models.init_params import init_roformer_params
from audio_separator_tpu.ops import losses as jax_losses
from audio_separator_tpu.training import make_train_step as jax_make_train_step
from audio_separator_tpu_torch.models import htdemucs as ht
from audio_separator_tpu.models.convert import load_params as jax_load_params
from audio_separator_tpu_torch.models.convert import (export_jax_params, flatten_tree,
                                                      load_jax_htdemucs_params,
                                                      load_jax_params, save_params)
from audio_separator_tpu_torch.models.init_params import init_htdemucs_params
from audio_separator_tpu_torch.models.roformer import Roformer, RoformerConfig
from audio_separator_tpu_torch.ops import losses
from audio_separator_tpu_torch.training import make_train_step
from test_training import CFG as JAX_BS_CFG
from test_training import LOSS_KW, _data, _htdemucs_setup
from torch_threads import one_torch_thread  # noqa: F401

FAST_COMPILE = {"xla_backend_optimization_level": 0}
STEP_TOL = 2e-4  # tests/test_training.py:62-68
MEL_KW = dict(kind="mel", dim=32, depth=1, stereo=True, num_stems=1,
              time_transformer_depth=1, freq_transformer_depth=1, num_bands=16,
              sample_rate=44100, dim_head=8, heads=4, stft_n_fft=512, stft_hop_length=128,
              stft_win_length=512, mask_estimator_depth=1)
# tests/test_torch_hdemucs.py's geometry: BLSTM and LocalState in the deep DConvs.
HDEMUCS_KW = dict(sources=("drums", "bass", "other", "vocals"), arch="hdemucs", channels=8,
                  nfft=256, depth=4, norm_starts=2, segment=0.5, use_train_segment=False)


def _port_config(jcfg) -> RoformerConfig:
    return RoformerConfig(**{f.name: getattr(jcfg, f.name)
                             for f in dataclasses.fields(RoformerConfig)})


def _leaves(tree):
    return {k: np.asarray(v) for k, v in flatten_tree(tree).items()}


def _run_both(jcfg, tree, model, mix, target, loss_kw, steps=3):
    """``steps`` SGD steps of the JAX ``make_train_step`` and of the port's
    from ``tree``; returns (JAX losses, JAX tree, port losses, port tree)."""
    jstep, jstate = jax_make_train_step(jcfg, optax.sgd(1e-2), tree, **loss_kw)
    params = jax.tree.map(jnp.asarray, tree)
    jstep = jstep.lower(params, jstate, mix, target).compile(compiler_options=FAST_COMPILE)
    jlosses = []
    for _ in range(steps):
        params, jstate, loss = jstep(params, jstate, mix, target)
        jlosses.append(float(loss))
    pcfg = model.cfg
    step = make_train_step(pcfg, model, torch.optim.SGD(model.parameters(), lr=1e-2),
                           **loss_kw)
    tmix, ttarget = (torch.from_numpy(np.array(a)) for a in (mix, target))
    plosses = [float(step(tmix, ttarget)) for _ in range(steps)]
    return jlosses, jax.tree.map(np.asarray, params), plosses, export_jax_params(model)


def _assert_steps_match(jlosses, jtree, plosses, ptree):
    np.testing.assert_allclose(plosses, jlosses, rtol=STEP_TOL)
    want, got = _leaves(jtree), _leaves(ptree)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=STEP_TOL, err_msg=key)


# ------------------------------------------------------------------ losses


def _loss_inputs():
    rng = np.random.default_rng(0)  # tests/test_losses.py:32-42
    recon = rng.standard_normal((2, 2, 2, 8192)).astype(np.float32) * 0.3
    target = rng.standard_normal((2, 2, 2, 8200)).astype(np.float32) * 0.3
    return recon, target


def test_roformer_training_loss_matches_jax():
    recon, target = _loss_inputs()
    total, (base, multi) = losses.roformer_training_loss(torch.from_numpy(recon),
                                                         torch.from_numpy(target))
    jtotal, (jbase, jmulti) = jax_losses.roformer_training_loss(jnp.asarray(recon),
                                                               jnp.asarray(target))
    np.testing.assert_allclose(float(base), float(jbase), rtol=1e-5)
    np.testing.assert_allclose(float(multi), float(jmulti), rtol=1e-4)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-4)


@pytest.mark.parametrize("which", ["multi_res_stft_loss", "roformer_training_loss"])
def test_loss_gradients_match_jax(which):
    rng = np.random.default_rng(1)  # tests/test_losses.py:45-56
    recon = rng.standard_normal((1, 2, 4096)).astype(np.float32)
    target = rng.standard_normal((1, 2, 4096)).astype(np.float32)
    kw = dict(window_sizes=(512, 256))

    def pick(out):
        return out[0] if which == "roformer_training_loss" else out

    want = np.asarray(jax.grad(lambda x: pick(getattr(jax_losses, which)(
        x, jnp.asarray(target), **kw)))(jnp.asarray(recon)))
    x = torch.from_numpy(recon).requires_grad_(True)
    pick(getattr(losses, which)(x, torch.from_numpy(target), **kw)).backward()
    got = x.grad.numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)


# ------------------------------------------------------------------ the step


def test_bs_roformer_sgd_steps_match_jax():
    tree = init_roformer_params(JAX_BS_CFG, seed=0)
    model = load_jax_params(Roformer(_port_config(JAX_BS_CFG)), tree)
    mix, target = _data(2, seed=1)
    _assert_steps_match(*_run_both(JAX_BS_CFG, tree, model, mix, target, LOSS_KW))


def test_mel_roformer_sgd_steps_match_jax():
    jcfg = jax_roformer.RoformerConfig(**MEL_KW)
    tree = init_roformer_params(jcfg, seed=2)
    model = load_jax_params(Roformer(RoformerConfig(**MEL_KW)), tree)
    rng = np.random.default_rng(5)
    chunk = 128 * 15
    mix = rng.standard_normal((2, 2, chunk)).astype(np.float32) * 0.2
    target = (0.5 * rng.standard_normal((2, 1, 2, chunk)).astype(np.float32) * 0.2
              + 0.5 * mix[:, None])
    _assert_steps_match(*_run_both(jcfg, tree, model, jnp.asarray(mix), jnp.asarray(target),
                                   LOSS_KW))


def test_htdemucs_sgd_steps_match_jax():
    jcfg, tree, mix, target = _htdemucs_setup()
    known = {f.name for f in dataclasses.fields(ht.HTDemucsConfig)}
    # The oracle behind _htdemucs_setup has DConvs in the decoders too.
    cfg = ht.HTDemucsConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items() if k in known},
                            dconv_mode=3)
    model = load_jax_htdemucs_params(ht.HTDemucs(cfg), tree)
    _assert_steps_match(*_run_both(jcfg, tree, model, mix, target, {}))


def test_hdemucs_sgd_steps_match_jax():
    cfg = ht.HTDemucsConfig(**HDEMUCS_KW, dconv_lstm=2, dconv_attn=2, dconv_comp=4)
    jcfg = jax_ht.HTDemucsConfig(**HDEMUCS_KW)
    tree = init_htdemucs_params(cfg, seed=7)
    model = load_jax_htdemucs_params(ht.HDemucs(cfg), tree)
    rng = np.random.default_rng(8)
    length = 4096
    mix = rng.standard_normal((2, 2, length)).astype(np.float32) * 0.2
    target = 0.5 * rng.standard_normal((2, 4, 2, length)).astype(np.float32) * 0.2 \
        + 0.5 * mix[:, None]
    _assert_steps_match(*_run_both(jcfg, tree, model, jnp.asarray(mix), jnp.asarray(target),
                                   {}))


def test_adam_loss_decreases():
    """tests/test_training.py:36-45 with the port: six Adam steps."""
    tree = init_roformer_params(JAX_BS_CFG, seed=0)
    model = load_jax_params(Roformer(_port_config(JAX_BS_CFG)), tree)
    step = make_train_step(model.cfg, model, torch.optim.Adam(model.parameters(), lr=3e-3),
                           **LOSS_KW)
    mix, target = (torch.from_numpy(np.array(a)) for a in _data(2))
    got = [float(step(mix, target)) for _ in range(6)]
    assert np.isfinite(got).all()
    assert got[-1] < got[0] * 0.98, got


def test_trained_parameters_round_trip_the_npz(tmp_path):
    """export_jax_params is load_jax_params's inverse, and save_params writes
    the JAX package's .npz layout (its load_params reads it back)."""
    tree = init_roformer_params(JAX_BS_CFG, seed=3)
    model = load_jax_params(Roformer(_port_config(JAX_BS_CFG)), tree)
    path = str(tmp_path / "tuned.npz")
    save_params(path, export_jax_params(model))
    back = jax_load_params(path)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------ refusals


def test_mesh_and_bf16_are_refused_with_their_items():
    """``mesh=`` takes a module laid out for that mesh and refuses any other;
    bf16 compute is taken for the RoFormer family (float32 masters), while a
    bf16 module (its masters would be bf16) and HTDemucs or HDemucs in bf16
    (ROADMAP C16) are refused. tests/test_torch_bf16_training.py holds the
    bf16 step itself."""
    from audio_separator_tpu_torch.parallel.mesh import make_mesh, shard_model

    model = Roformer(_port_config(JAX_BS_CFG))
    opt = torch.optim.SGD(model.parameters(), lr=1e-2)
    mesh = make_mesh(devices=[torch.device("cpu")] * 4, tp=2)
    with pytest.raises(ValueError, match="lay the module out"):
        make_train_step(model.cfg, model, opt, mesh=mesh)
    sharded = shard_model(model, mesh)
    assert callable(make_train_step(sharded.cfg, sharded,
                                    torch.optim.SGD(sharded.parameters(), lr=1e-2), mesh=mesh))
    assert callable(make_train_step(sharded.cfg, sharded,
                                    torch.optim.SGD(sharded.parameters(), lr=1e-2), mesh=mesh,
                                    compute_dtype=torch.bfloat16))
    assert callable(make_train_step(model.cfg, model, opt, compute_dtype=torch.bfloat16))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    hdemucs = ht.HDemucs(ht.HTDemucsConfig(**HDEMUCS_KW, dconv_lstm=2, dconv_attn=2,
                                           dconv_comp=4))
    with pytest.raises(NotImplementedError, match="C16"):
        make_train_step(hdemucs.cfg, hdemucs, torch.optim.SGD(hdemucs.parameters(), lr=1e-2),
                        compute_dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="master weights"):
        make_train_step(model.cfg, model.to(torch.bfloat16), opt)


def test_new_modules_build_no_graph():
    """Parameters are created with gradients off: a module's forward outside
    any training step builds no graph."""
    tree = init_roformer_params(JAX_BS_CFG, seed=0)
    model = load_jax_params(Roformer(_port_config(JAX_BS_CFG)), tree)
    mix, _ = _data(1)
    assert not any(p.requires_grad for p in model.parameters())
    assert model(torch.from_numpy(np.array(mix))).grad_fn is None
    cfg = ht.HTDemucsConfig(**HDEMUCS_KW, dconv_lstm=2, dconv_attn=2, dconv_comp=4)
    assert not any(p.requires_grad for p in ht.HDemucs(cfg).parameters())
