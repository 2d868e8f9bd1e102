"""The port's Demucs v3 (``HDemucs``) against the JAX package's
``apply_hdemucs``, with one numpy parameter tree loaded into both: the BLSTM
(framed and unframed), LocalState, a v3 DConv layer, the whole forward at the
tests/test_hdemucs.py geometry (channels 8, nfft 256, depth 4, norm_starts /
dconv_lstm / dconv_attn 2), the magnitude head (``cac=False``) with each
Wiener setting over more than one 300-frame window, and ``filtering.wiener``.

The JAX side is jitted and compiled at ``xla_backend_optimization_level`` 0
(its numerics do not depend on the backend's optimisations; an eager forward
dispatches op by op and costs tens of seconds here). Tolerance: 1e-5 of the
reference's largest magnitude throughout, tighter than the 2e-4 a whole
forward may need (both sides float32; the LSTM and attention chains
reassociate sums): the forwards agree to about 1e-6."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_separator_tpu.models import filtering as jax_filtering
from audio_separator_tpu.models import htdemucs as jax_ht
from audio_separator_tpu_torch.models import filtering
from audio_separator_tpu_torch.models import htdemucs as ht
from audio_separator_tpu_torch.models.convert import (flatten_tree, load_jax_hdemucs_params,
                                                      tree_from_state_dict)
from audio_separator_tpu_torch.models.diffq_restore import demucs_param_manifest
from audio_separator_tpu_torch.models.init_params import (hdemucs_full_config, htdemucs_kwargs,
                                                          init_htdemucs_params)
from torch_threads import one_torch_thread  # noqa: F401

FAST_COMPILE = {"xla_backend_optimization_level": 0}
SOURCES = ("drums", "bass", "other", "vocals")
# tests/test_hdemucs.py's geometry.
SMALL = dict(sources=SOURCES, arch="hdemucs", channels=8, nfft=256, depth=4, norm_starts=2,
             segment=0.5, use_train_segment=False)
# The smallest v3 with a merge level, for the heads (no BLSTM or LocalState:
# the SMALL forward holds those, and their scans cost most of a compile here).
TINY = dict(sources=SOURCES, arch="hdemucs", channels=8, nfft=64, depth=2, norm_starts=1,
            segment=0.5, use_train_segment=False)
MODULE_TOL = FORWARD_TOL = 1e-5


def _jit(fn, *args, **static):
    """``fn(*args)`` jitted over ``args`` with ``static`` bound, compiled fast."""
    f = jax.jit(functools.partial(fn, **static))
    out = f.lower(*args).compile(compiler_options=FAST_COMPILE)(*args)
    return [np.asarray(o) for o in out] if isinstance(out, list) else np.asarray(out)


def _apply_hdemucs(params, mix, cfg):
    return jax_ht.apply_hdemucs(params, cfg, mix)


def _seeded(module, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    return module.eval()


def _tree(module):
    return tree_from_state_dict({k: v.numpy() for k, v in module.state_dict().items()})


def _close(got, want, tol):
    assert got.shape == want.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0)


def _v3(kwargs, **extra):
    """The port's config (with the DConv fields the JAX config reads from the
    tree instead) and the JAX config."""
    first = 2 if kwargs is SMALL else kwargs["depth"]
    cfg = ht.HTDemucsConfig(**kwargs, dconv_lstm=first, dconv_attn=first, dconv_comp=4, **extra)
    return cfg, jax_ht.HTDemucsConfig(**kwargs, **extra)


# ------------------------------------------------------------------ modules


@pytest.mark.parametrize("steps", [150, 437])
def test_blstm_matches_jax(steps):
    """150 steps run as one sequence; 437 as five frames of 200 at stride 100,
    trimmed at the seams and cropped."""
    blstm = _seeded(ht.BLSTM(6), seed=steps)
    x = np.random.default_rng(steps).standard_normal((2, 6, steps)).astype(np.float32)
    with torch.no_grad():
        got = blstm(torch.from_numpy(x)).numpy()
    want = _jit(jax_ht._blstm, _tree(blstm), jnp.asarray(x))
    _close(got, want, MODULE_TOL)


def test_local_state_matches_jax():
    local = _seeded(ht.LocalState(8), seed=4)
    x = np.random.default_rng(4).standard_normal((2, 8, 57)).astype(np.float32)
    with torch.no_grad():
        got = local(torch.from_numpy(x)).numpy()
    want = _jit(jax_ht._local_state, _tree(local), jnp.asarray(x))
    _close(got, want, MODULE_TOL)


def test_v3_dconv_matches_jax():
    """Two layers of conv → GN → GELU → BLSTM → LocalState → conv → GN → GLU →
    scale, the BLSTM at Sequential index 3 and LocalState at 4, as upstream
    keys them."""
    cfg, jcfg = _v3(SMALL)
    dconv = _seeded(ht.DConv(16, 4, 2, lstm=True, attn=True), seed=5)
    assert {k.split(".")[2] for k in dconv.state_dict()} == {"0", "1", "3", "4", "5", "6", "8"}
    assert "layers.0.3.lstm.weight_ih_l1_reverse" in dconv.state_dict()
    assert "layers.1.4.query_decay.weight" in dconv.state_dict()
    x = np.random.default_rng(5).standard_normal((2, 16, 230)).astype(np.float32)
    with torch.no_grad():
        got = dconv(torch.from_numpy(x)).numpy()
    want = _jit(jax_ht._dconv, _tree(dconv), jnp.asarray(x), cfg=jcfg)
    _close(got, want, MODULE_TOL)


# ------------------------------------------------------------------ forward


def test_hdemucs_state_dict_is_the_upstream_manifest():
    """The module's keys and shapes are diffq_restore's HDemucs manifest (the
    upstream constructor's parameters), at the test size and at the
    published width."""
    for cfg in (_v3(SMALL)[0], hdemucs_full_config()):
        model = ht.HDemucs(cfg)
        manifest = demucs_param_manifest("HDemucs", htdemucs_kwargs(cfg))
        assert [(k, tuple(v.shape)) for k, v in model.state_dict().items()] == \
            [(k, tuple(s)) for k, s in manifest]
    assert not hasattr(ht.HDemucs(hdemucs_full_config()), "crosstransformer")


def test_hdemucs_forward_matches_jax():
    cfg, jcfg = _v3(SMALL)
    tree = init_htdemucs_params(cfg, seed=3)
    model = load_jax_hdemucs_params(ht.HDemucs(cfg), tree).eval()
    mix = (np.random.default_rng(5).standard_normal((1, 2, 22050)) * 0.2).astype(np.float32)
    got = model(torch.from_numpy(mix)).numpy()
    want = _jit(_apply_hdemucs, tree, jnp.asarray(mix), cfg=jcfg)
    assert got.shape == (1, 4, 2, 22050)
    _close(got, want, FORWARD_TOL)


HEADS = [(-1, False), (0, False), (1, False), (1, True)]
HEAD_MIX = (np.random.default_rng(8).standard_normal((2, 2, 6000)) * 0.2).astype(np.float32)


@pytest.fixture(scope="module")
def jax_heads():
    """The JAX forward for every head setting, as one program: the trunk is
    the same for all four, so it is compiled once."""
    jcfgs = [_v3(TINY, cac=False, wiener_iters=w, wiener_residual=r)[1] for w, r in HEADS]
    tree = init_htdemucs_params(_v3(TINY, cac=False)[0], seed=7)

    def heads(params, mix):
        return [jax_ht.apply_hdemucs(params, c, mix) for c in jcfgs]

    outs = _jit(heads, tree, jnp.asarray(HEAD_MIX))
    return tree, dict(zip(HEADS, outs))


@pytest.mark.parametrize("wiener_iters,residual", HEADS)
def test_magnitude_head_matches_jax(jax_heads, wiener_iters, residual):
    """``cac=False``: a ratio mask with the mixture's phase (-1), or the
    Wiener EM in 300-frame windows (6000 samples at hop 16 are 375 frames, so
    two windows), with and without the residual source; a batch of two."""
    cfg, _ = _v3(TINY, cac=False, wiener_iters=wiener_iters, wiener_residual=residual)
    tree, outs = jax_heads
    model = load_jax_hdemucs_params(ht.HDemucs(cfg), tree).eval()
    assert model.encoder[0].conv.in_channels == 2  # magnitudes, not complex pairs
    got = model(torch.from_numpy(HEAD_MIX)).numpy()
    assert got.shape == (2, 4, 2, 6000) and np.isfinite(got).all()
    _close(got, outs[(wiener_iters, residual)], FORWARD_TOL)


def test_htdemucs_builds_the_magnitude_head():
    """The magnitude head is shared: a v4 model with ``cac=False`` builds with
    magnitude inputs and separates (the JAX ``apply_htdemucs`` has no such
    head to compare with)."""
    cfg = ht.HTDemucsConfig(sources=("a", "b"), channels=8, nfft=256, depth=2, t_layers=1,
                            t_heads=2, segment=0.1, cac=False, wiener_iters=1)
    model = ht.HTDemucs(cfg).eval()
    assert model.encoder[0].conv.in_channels == 2 and model.decoder[-1].conv_tr.out_channels == 4
    out = model(torch.randn(1, 2, 4410) * 0.1)
    assert out.shape == (1, 2, 2, 4410) and torch.isfinite(out).all()


# ------------------------------------------------------------------- wiener


@pytest.mark.parametrize("iterations,residual,softmask", [(0, False, False), (1, False, False),
                                                          (2, True, False), (1, False, True)])
def test_wiener_matches_jax(iterations, residual, softmask):
    rng = np.random.default_rng(iterations + 3 * residual)
    t, f, c, s = 31, 17, 2, 3
    raw = rng.standard_normal((t, f, c, s)).astype(np.float32)  # signed: the raw head
    if softmask:
        raw = np.abs(raw)
    mix = (rng.standard_normal((t, f, c)) + 1j * rng.standard_normal((t, f, c))
           ).astype(np.complex64) * 30  # max |mix| above the 10x scale factor
    got = filtering.wiener(torch.from_numpy(raw), torch.from_numpy(mix), iterations=iterations,
                           residual=residual, softmask=softmask).numpy()
    want = np.asarray(jax_filtering.wiener(jnp.asarray(raw), jnp.asarray(mix),
                                           iterations=iterations, residual=residual,
                                           softmask=softmask))
    assert got.shape == want.shape == (t, f, c, s + residual)
    _close(got, want, 1e-5)


def test_flatten_round_trip_of_the_v3_tree():
    cfg = _v3(SMALL)[0]
    tree = init_htdemucs_params(cfg, seed=1)
    state = ht.HDemucs(cfg).state_dict()
    assert set(flatten_tree(tree)) == set(state)
    with pytest.raises(RuntimeError):
        load_jax_hdemucs_params(ht.HDemucs(cfg), {**tree, "crosstransformer": {"x": np.ones(1)}})
