"""The port's TFC-TDF v3 (MDX23C) module against the JAX package's functional
TFC-TDF, with one oracle state dict turned into one parameter tree that feeds
both: the spectrogram body in every norm, activation and stem count, the whole
forward (packed STFT, body, inverse), and the packed STFT pair itself, at the
small geometry of tests/test_tfc_tdf.py (2 sub-bands, 2 scales, 8 channels,
n_fft 256).

Tolerance: 1e-4 of the reference's largest magnitude. Both sides compute in
float32 with different summation orders in the convolutions and products
(measured ≈ 3e-7 of the scale); the JAX package's own oracle test allows
3e-4 absolute on outputs of order one (tests/test_tfc_tdf.py:48)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_separator_tpu.models import tfc_tdf as jax_tfc
from audio_separator_tpu.models.convert import tree_from_state_dict as jax_tree_from_state_dict
from audio_separator_tpu.ops import stft as jax_stft
from audio_separator_tpu_torch.models import tfc_tdf
from audio_separator_tpu_torch.models.convert import convert_tfc_tdf, load_jax_tfc_tdf_params
from audio_separator_tpu_torch.ops import stft as port_stft

from torch_oracles.tfc_tdf_oracle import TFCTDFNetOracle

TOL = 1e-4  # of the output scale
SMALL = dict(num_subbands=2, num_scales=2, scale=(2, 2), num_blocks_per_scale=1,
             num_channels=8, growth=8, bottleneck_factor=2, dim_f=64, n_fft=256,
             hop_length=64)


def _state_dict(norm, num_stems, seed=0):
    """Seeded oracle weights in the upstream key layout; BatchNorm running
    statistics set away from their defaults so they take part."""
    torch.manual_seed(seed)
    oracle = TFCTDFNetOracle(num_subbands=2, num_scales=2, scale=(2, 2), l=1, c=8, g=8,
                             bn=2, dim_f=64, num_stems=num_stems, norm_type=norm).eval()
    with torch.no_grad():
        for p in oracle.parameters():
            p.copy_(torch.randn_like(p) * 0.1)
        for name, buf in oracle.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.randn_like(buf) * 0.1)
            elif name.endswith("running_var"):
                buf.copy_(torch.rand_like(buf) + 0.5)
    return {k: v.numpy() for k, v in oracle.state_dict().items()}


def _pair(norm="InstanceNorm", act="gelu", num_stems=2, seed=0):
    sd = _state_dict(norm, num_stems, seed)
    kwargs = dict(SMALL, norm=norm, act=act, num_stems=num_stems)
    jcfg = jax_tfc.TFCTDFConfig(**kwargs)
    model = load_jax_tfc_tdf_params(tfc_tdf.TFCTDFNet(tfc_tdf.TFCTDFConfig(**kwargs)),
                                    convert_tfc_tdf(sd)).eval()
    return jcfg, jax_tree_from_state_dict(sd), model


def _assert_close(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("num_stems", [1, 2])
@pytest.mark.parametrize("act", ["gelu", "relu", "elu"])
@pytest.mark.parametrize("norm", ["InstanceNorm", "BatchNorm", "GroupNorm4"])
def test_spec_body_matches_jax(norm, act, num_stems):
    jcfg, tree, model = _pair(norm, act, num_stems)
    spec = np.random.default_rng(0).standard_normal((2, 4, 64, 16)).astype(np.float32)
    want = np.asarray(jax_tfc.apply_tfc_tdf_spec(tree, jcfg, jnp.asarray(spec)))
    got = model.forward_spec(torch.from_numpy(spec)).numpy()
    assert got.shape == (2, num_stems, 4, 64, 16)
    _assert_close(got, want)


@pytest.mark.parametrize("num_stems", [1, 2])
def test_forward_matches_jax(num_stems):
    jcfg, tree, model = _pair(num_stems=num_stems, seed=1)
    rng = np.random.default_rng(1)
    chunks = (rng.standard_normal((2, 2, 64 * 15)) * 0.3).astype(np.float32)
    want = np.asarray(jax_tfc.apply_tfc_tdf(tree, jcfg, jnp.asarray(chunks)))
    got = model(torch.from_numpy(chunks)).numpy()
    assert got.shape == (2, num_stems, 2, 64 * 15)
    _assert_close(got, want)


def test_packed_stft_pair_matches_jax():
    n_fft, hop, dim_f = 256, 64, 64
    x = np.random.default_rng(2).standard_normal((3, 2, 2000)).astype(np.float32)
    win = port_stft.hann_window(n_fft)
    got = port_stft.stft_real_packed(torch.from_numpy(x), n_fft, hop, win, dim_f)
    want = np.asarray(jax_stft.stft_real_packed(jnp.asarray(x), n_fft, hop,
                                                jax_stft.hann_window(n_fft), dim_f))
    assert got.shape == (3, 4, dim_f, 1 + 2000 // hop)
    _assert_close(got.numpy(), want)
    # channel interleave [c0_re, c0_im, c1_re, c1_im]
    spec = port_stft.stft(torch.from_numpy(x), n_fft, hop, win)
    np.testing.assert_array_equal(got[:, 2].numpy(), spec[:, 1, :dim_f].real.numpy())
    np.testing.assert_array_equal(got[:, 3].numpy(), spec[:, 1, :dim_f].imag.numpy())

    back = port_stft.istft_real_packed(got, n_fft, hop, win).numpy()
    back_jax = np.asarray(jax_stft.istft_real_packed(jnp.asarray(want), n_fft, hop,
                                                     jax_stft.hann_window(n_fft)))
    _assert_close(back, back_jax)


def test_config_defaults_are_the_published_8k_model():
    """``build_tfc_tdf_config`` of an empty model section gives the geometry of
    model_2_stem_full_band_8k.yaml, as the JAX package's does."""
    data = {"training": {"instruments": ["Vocals", "Instrumental"], "target_instrument": None}}
    cfg = tfc_tdf.build_tfc_tdf_config(data)
    assert cfg.__dict__ == jax_tfc.build_tfc_tdf_config(data).__dict__
    assert (cfg.n_fft, cfg.hop_length, cfg.dim_f, cfg.num_channels, cfg.num_stems) == \
        (8192, 1024, 4096, 128, 2)


def test_loader_is_strict():
    sd = _state_dict("InstanceNorm", 2)
    tree = convert_tfc_tdf({k: v for k, v in sd.items() if k != "first_conv.weight"})
    with pytest.raises(RuntimeError, match="first_conv.weight"):
        load_jax_tfc_tdf_params(tfc_tdf.TFCTDFNet(tfc_tdf.TFCTDFConfig(
            **SMALL, norm="InstanceNorm", act="gelu", num_stems=2)), tree)
