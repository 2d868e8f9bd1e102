"""The port's HTDemucs module against the JAX package's functional HTDemucs,
with one numpy parameter tree loaded into both: the normalised STFT pair, one
encoder layer, one decoder layer, the cross-transformer and the whole forward,
at the small size of tests/test_htdemucs.py (channels 8, nfft 1024, depth 3,
3 transformer layers, 4 heads, 0.5 s segments), plus ``bottom_channels`` and a
six-source model. Whole-forward tolerance: 5e-4 of the reference's largest
magnitude, the JAX package's own bar against its torch oracle."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_separator_tpu.models import htdemucs as jax_ht
from audio_separator_tpu.models.diffq_restore import demucs_param_manifest as jax_manifest
from audio_separator_tpu_torch.models import htdemucs as ht
from audio_separator_tpu_torch.models.convert import flatten_tree, load_jax_htdemucs_params
from audio_separator_tpu_torch.models.init_params import (
    htdemucs_full_config,
    htdemucs_kwargs,
    init_htdemucs_params,
)
from audio_separator_tpu_torch.ops import attention as att
from torch_threads import one_torch_thread  # noqa: F401

SMALL = dict(sources=("drums", "bass", "other", "vocals"), channels=8, nfft=1024, depth=3,
             t_layers=3, t_heads=4, segment=0.5)
VARIANTS = {
    "small": {},
    "bottom_channels": {"bottom_channels": 16},
    "six_sources": {"sources": ("drums", "bass", "other", "vocals", "guitar", "piano"),
                    "t_layers": 2},
    # GroupNorm past the first level and DConv branches in the decoders too,
    # which checkpoints may ask for though the published v4 models do not.
    "norms_and_decoder_dconv": {"norm_starts": 1, "dconv_mode": 3, "t_layers": 1},
}


def _build(variant):
    kwargs = {**SMALL, **VARIANTS[variant]}
    cfg = ht.HTDemucsConfig(**kwargs)
    tree = init_htdemucs_params(cfg, seed=11)
    model = load_jax_htdemucs_params(ht.HTDemucs(cfg), tree).eval()
    # The JAX config has no DConv fields: its layers follow the tree's keys.
    known = jax_ht.HTDemucsConfig.__dataclass_fields__
    jcfg = jax_ht.HTDemucsConfig(**{k: v for k, v in kwargs.items() if k in known})
    return cfg, jcfg, tree, model


@pytest.fixture(scope="module")
def small():
    return _build("small")


def _jax_forward(jcfg, tree, mix):
    """Op by op, as tests/test_htdemucs.py runs it: the first call in a
    process compiles each op once (tens of seconds), later calls of the same
    shapes reuse them. Compiling the whole forward as one program costs more
    here: XLA folds the DFT matrices of the STFT at compile time."""
    return np.asarray(jax_ht.apply_htdemucs(tree, jcfg, jnp.asarray(mix)))


@pytest.fixture(scope="module")
def small_reference(small):
    """The JAX forward of the small model on one batch; pays the op compiles
    for every later JAX call of this module."""
    cfg, jcfg, tree, _ = small
    mix = _randn(2, 2, cfg.training_length, seed=13, scale=0.2)
    return mix, _jax_forward(jcfg, tree, mix)


def _randn(*shape, seed=0, scale=0.3):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("length", [22050, 8192, 700])
def test_model_spec_matches_jax(small, length):
    cfg, jcfg, _, _ = small
    x = _randn(2, 2, length, seed=length)
    got = ht._model_spec(torch.from_numpy(x), cfg).numpy()
    want = np.asarray(jax_ht._model_spec(jnp.asarray(x), jcfg))
    assert got.shape == want.shape == (2, 2, 512, -(-length // 256))
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("length", [22050, 8192])
def test_model_ispec_matches_jax(small, length):
    cfg, jcfg, _, _ = small
    frames = -(-length // 256)
    z = _randn(2, 4, 2, 512, frames, seed=1) + 1j * _randn(2, 4, 2, 512, frames, seed=2)
    z = z.astype(np.complex64)
    got = ht._model_ispec(torch.from_numpy(z), length, cfg).numpy()
    want = np.asarray(jax_ht._model_ispec(jnp.asarray(z), length, jcfg))
    assert got.shape == want.shape == (2, 4, 2, length)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_pad1d_reflect_zero_extends_short_inputs():
    x = _randn(1, 2, 5, seed=3)
    got = ht.pad1d_reflect(torch.from_numpy(x), 7, 9).numpy()
    want = np.asarray(jax_ht.pad1d_reflect(jnp.asarray(x), 7, 9))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("branch,index", [("encoder", 0), ("encoder", 1), ("tencoder", 0)])
def test_encoder_layer_matches_jax(small, branch, index):
    cfg, jcfg, tree, model = small
    g = ht._layer_geometry(cfg)[index]
    assert g == jax_ht._layer_geometry(jcfg)[index]
    layer = getattr(model, branch)[index]
    chin = layer.conv.in_channels
    if branch == "encoder":
        x = _randn(2, chin, 512 // 4 ** index, 20, seed=4)
        want = jax_ht._henc_layer(tree[branch][str(index)], jnp.asarray(x), jcfg, freq=True,
                                  kernel=g["kernel"], stride=g["stride"], pad=g["pad"])
    else:
        x = _randn(2, chin, 4001, seed=5)  # padded to a multiple of the stride
        want = jax_ht._henc_layer(tree[branch][str(index)], jnp.asarray(x), jcfg, freq=False,
                                  kernel=cfg.kernel_size, stride=cfg.stride,
                                  pad=cfg.kernel_size // 4)
    got = layer(torch.from_numpy(x)).detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-5 * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("branch,index", [("decoder", 1), ("decoder", 2), ("tdecoder", 2)])
def test_decoder_layer_matches_jax(small, branch, index):
    cfg, jcfg, tree, model = small
    g = ht._layer_geometry(cfg)[cfg.depth - 1 - index]
    layer = getattr(model, branch)[index]
    chin = layer.conv_tr.in_channels
    last = index == cfg.depth - 1
    if branch == "decoder":
        fr = 512 // 4 ** (cfg.depth - index)
        x, skip = _randn(2, chin, fr, 20, seed=6), _randn(2, chin, fr, 20, seed=7)
        want = jax_ht._hdec_layer(tree[branch][str(index)], jnp.asarray(x), jnp.asarray(skip),
                                  20, jcfg, freq=True, kernel=g["kernel"], stride=g["stride"],
                                  pad=g["pad"], last=last, chin=chin)
        length = 20
    else:
        x, skip = _randn(2, chin, 1000, seed=8), _randn(2, chin, 1000, seed=9)
        length = 3998
        want = jax_ht._hdec_layer(tree[branch][str(index)], jnp.asarray(x), jnp.asarray(skip),
                                  length, jcfg, freq=False, kernel=cfg.kernel_size,
                                  stride=cfg.stride, pad=cfg.kernel_size // 4, last=last)
    got = layer(torch.from_numpy(x), torch.from_numpy(skip), length)
    for g_, w_ in zip(got, want):  # (z, y): the output and the conv_tr's input
        w_ = np.asarray(w_)
        assert tuple(g_.shape) == w_.shape
        np.testing.assert_allclose(g_.detach().numpy(), w_,
                                   atol=2e-5 * max(np.abs(w_).max(), 1.0))


def test_cross_transformer_matches_jax(small):
    cfg, jcfg, tree, model = small
    dim = cfg.channels * cfg.growth ** (cfg.depth - 1)
    x, xt = _randn(2, dim, 8, 22, seed=10), _randn(2, dim, 87, seed=11)
    before = dict(att.LAUNCHES)
    with torch.no_grad():
        got = model.crosstransformer(torch.from_numpy(x), torch.from_numpy(xt))
    assert att.LAUNCHES == before  # CPU tensors: the plain version, no launch
    want = jax_ht._cross_transformer(tree["crosstransformer"], jnp.asarray(x),
                                     jnp.asarray(xt), jcfg)
    for g_, w_ in zip(got, want):
        w_ = np.asarray(w_)
        assert tuple(g_.shape) == w_.shape
        np.testing.assert_allclose(g_.numpy(), w_, atol=5e-5 * max(np.abs(w_).max(), 1.0))


def test_self_attention_goes_through_the_dispatch(small, monkeypatch):
    """Self-attention layers (0 and 2 of 3) call ``dot_product_attention``
    once per branch; the cross layer, whose lengths differ, does not."""
    cfg, _, _, model = small
    seen = []
    real = ht.dot_product_attention
    monkeypatch.setattr(ht, "dot_product_attention",
                        lambda q, k, v: seen.append(tuple(q.shape)) or real(q, k, v))
    model(torch.from_numpy(_randn(1, 2, cfg.training_length, seed=12)))
    frames = -(-cfg.training_length // cfg.hop_length)
    t_len = -(-cfg.training_length // cfg.stride ** cfg.depth)
    dh = cfg.channels * cfg.growth ** (cfg.depth - 1) // cfg.t_heads
    assert seen == [(1, 4, 8 * frames, dh), (1, 4, t_len, dh)] * 2


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_matches_jax(variant, small, small_reference):
    cfg, jcfg, tree, model = small if variant == "small" else _build(variant)
    mix, want = small_reference
    got = model(torch.from_numpy(mix)).numpy()
    if variant != "small":
        want = _jax_forward(jcfg, tree, mix)
    assert got.shape == want.shape == (2, len(cfg.sources), 2, cfg.training_length)
    scale = np.abs(want).max()
    assert scale > 1e-2  # the model does something
    np.testing.assert_allclose(got, want, atol=5e-4 * scale, rtol=0)


def test_short_input_is_padded_to_the_training_length(small, small_reference):
    cfg, jcfg, tree, model = small
    mix = _randn(2, 2, 15000, seed=14, scale=0.2)
    assert mix.shape[-1] < cfg.training_length
    got = model(torch.from_numpy(mix)).numpy()
    want = _jax_forward(jcfg, tree, mix)
    assert got.shape == want.shape == (2, 4, 2, 15000)
    np.testing.assert_allclose(got, want, atol=5e-4 * np.abs(want).max(), rtol=0)


def test_layer_scale_makes_the_transformer_matter(small):
    """With the seeded tree the cross-transformer changes the output by far
    more than the comparison's tolerance, so a fault in it cannot hide."""
    cfg, _, tree, model = small
    mix = torch.from_numpy(_randn(1, 2, cfg.training_length, seed=15, scale=0.2))
    base = model(mix)
    flat = {k: torch.from_numpy(v.copy()) for k, v in flatten_tree(tree).items()}
    for key in flat:
        if key.startswith("crosstransformer") and "gamma_" in key:
            flat[key].zero_()
    muted = ht.HTDemucs(cfg)
    muted.load_state_dict(flat, strict=True)
    diff = float((muted.eval()(mix) - base).abs().max())
    assert diff > 20 * 5e-4 * float(base.abs().max())


def test_full_width_tree_has_the_upstream_keys_and_shapes():
    """Shapes only: no full-width forward on the CPU."""
    cfg = htdemucs_full_config()
    assert (cfg.channels, cfg.nfft, cfg.depth, cfg.t_layers, cfg.t_heads,
            cfg.bottom_channels, cfg.segment) == (48, 4096, 4, 5, 8, 512, 7.8)
    assert cfg.training_length == 343980
    manifest = jax_manifest("HTDemucs", htdemucs_kwargs(cfg))
    tree = flatten_tree(init_htdemucs_params(cfg, seed=0))
    assert list(tree) == [name for name, _ in manifest]
    assert all(tuple(tree[name].shape) == tuple(shape) for name, shape in manifest)
    assert all(v.dtype == np.float32 and np.isfinite(v).all() for v in tree.values())
    with torch.device("meta"):
        module = ht.HTDemucs(cfg)
    state = module.state_dict()
    assert set(state) == set(tree)
    assert all(tuple(state[k].shape) == tree[k].shape for k in tree)
    assert sum(v.size for v in tree.values()) == 41_473_616


def test_load_is_strict(small):
    cfg, _, tree, _ = small
    broken = {k: v for k, v in tree.items() if k != "freq_emb"}
    with pytest.raises(RuntimeError, match="freq_emb"):
        load_jax_htdemucs_params(ht.HTDemucs(cfg), broken)
    extra = {**tree, "surplus": {"weight": np.zeros(3, np.float32)}}
    with pytest.raises(RuntimeError, match="surplus"):
        load_jax_htdemucs_params(ht.HTDemucs(cfg), extra)


def test_config_from_kwargs_matches_jax():
    kwargs = {"sources": ["drums", "bass", "other", "vocals"], "channels": 48, "nfft": 4096,
              "depth": 4, "t_layers": 5, "t_heads": 8, "bottom_channels": 512, "segment": 39 / 5,
              "dconv_comp": 8, "t_dropout": 0.02, "rewrite": True, "samplerate": 44100}
    cfg = ht.config_from_kwargs(kwargs)
    want = jax_ht.config_from_kwargs(kwargs)
    for field in ("sources", "channels", "nfft", "depth", "t_layers", "t_heads",
                  "bottom_channels", "segment", "samplerate", "use_train_segment",
                  "hop_length", "training_length"):
        assert getattr(cfg, field) == getattr(want, field), field
    assert ht.config_from_kwargs({}, args=(["a", "b"],)).sources == ("a", "b")
    # cac=False builds the shared magnitude head (Demucs v3's; it was refused
    # before v3 was ported): magnitudes in, one channel per audio channel.
    model = ht.HTDemucs(ht.HTDemucsConfig(sources=("a", "b"), cac=False))
    assert model.encoder[0].conv.in_channels == 2
