"""The port's VR operations against the JAX package on the CPU: the copied
band JSONs and their loader, the device resampler (against scipy in float64
and ``resample_jax``), the spec helpers, ``merge_artifacts``, the tiled mask
engine, and the three chain stages (``analyze``, ``finalize``,
``synthesize``) against the JAX ``build_*`` programs run at the track's true
length (no bucket).

Tolerances: the resampler at 1e-6 absolute (unit-scale input; float32
against float64); the chain stages at 1e-4 of the reference's largest
magnitude (rtol 1e-4 of the scale: single values near zero carry no relative
meaning in an STFT), with lengths equal."""

import functools
import os
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

from audio_separator_tpu.architectures import vr as jax_vr_arch
from audio_separator_tpu.ops import demix as jax_demix
from audio_separator_tpu.ops import spec as jax_spec
from audio_separator_tpu.ops import vr_bands as jax_vr_bands
from audio_separator_tpu.ops import vr_chain as jax_chain
from audio_separator_tpu.ops.resample import resample_jax
from audio_separator_tpu_torch.architectures import vr as port_vr_arch
from audio_separator_tpu_torch.ops import spec as port_spec
from audio_separator_tpu_torch.ops import vr_chain as port_chain
from audio_separator_tpu_torch.ops.demix import tiled_mask_predict
from audio_separator_tpu_torch.ops.resample import resample_torch
from audio_separator_tpu_torch.ops.vr_bands import merge_artifacts

from test_vr_chain import _mp_2band_v51, _mp_3band_v5
from test_torch_vr_nets import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = sorted(f[:-5] for f in os.listdir(
    os.path.join(REPO, "audio_separator_tpu", "data", "vr_modelparams")) if f.endswith(".json"))
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def _band_ratios():
    """Every distinct (from, to) rate pair between adjacent bands of the
    packaged geometries, both ways (analysis goes down, synthesis up)."""
    pairs = set()
    for name in PARAMS:
        mp = port_vr_arch.load_vr_model_params(name)
        srs = [mp["band"][d]["sr"] for d in sorted(mp["band"])]
        for lo, hi in zip(srs, srs[1:]):
            if lo != hi:
                pairs |= {(hi, lo), (lo, hi)}
    return sorted(pairs)


# ---------------------------------------------------------------- the JSONs


@pytest.mark.parametrize("name", PARAMS)
def test_vr_modelparams_are_own_copies_that_load_like_jax(name):
    port_file = os.path.join(REPO, "audio_separator_tpu_torch", "data", "vr_modelparams",
                             f"{name}.json")
    jax_file = os.path.join(REPO, "audio_separator_tpu", "data", "vr_modelparams",
                            f"{name}.json")
    with open(port_file, "rb") as a, open(jax_file, "rb") as b:
        assert a.read() == b.read()
    assert port_vr_arch.load_vr_model_params(name) == jax_vr_arch.load_vr_model_params(name)


def test_package_data_lists_the_copied_jsons():
    with open(os.path.join(REPO, "pyproject.toml"), encoding="utf-8") as f:
        line = next(ln for ln in f if ln.startswith("audio_separator_tpu_torch ="))
    assert '"data/vr_modelparams/*.json"' in line
    assert len(PARAMS) == 26


# -------------------------------------------------------------- resampling


def test_band_ratios_cover_the_packaged_geometries():
    assert _band_ratios() == sorted({(14700, 7350), (22050, 11025), (32000, 6000),
                                     (44100, 11025), (44100, 14700), (44100, 22050),
                                     (48000, 6000)} | {(7350, 14700), (11025, 22050),
                                                       (6000, 32000), (11025, 44100),
                                                       (14700, 44100), (22050, 44100),
                                                       (6000, 48000)})


@pytest.mark.parametrize("sr_from,sr_to", _band_ratios())
def test_resampler_matches_scipy_and_jax(sr_from, sr_to):
    x = (np.random.default_rng(sr_from + sr_to).standard_normal((2, 2, 3001)) * 0.3
         ).astype(np.float32)
    got = resample_torch(torch.from_numpy(x), sr_from, sr_to).numpy()
    ratio = Fraction(sr_to, sr_from)
    want = scipy.signal.resample_poly(x.astype(np.float64), ratio.numerator,
                                      ratio.denominator, axis=-1)
    jax_out = np.asarray(resample_jax(jnp.asarray(x), sr_from, sr_to))
    assert got.shape == want.shape == jax_out.shape == (2, 2, -(-3001 * sr_to // sr_from))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, jax_out, rtol=0, atol=1e-6)


# ------------------------------------------------------------ spec helpers


def test_spec_helpers_match_jax():
    rng = np.random.default_rng(0)
    spec = (rng.standard_normal((2, 9, 7)) + 1j * rng.standard_normal((2, 9, 7))
            ).astype(np.complex64)
    for got, want in zip(port_spec.preprocess(spec), jax_spec.preprocess(spec)):
        np.testing.assert_array_equal(got, want)
    for width, crop, off in ((700, 512, 128), (256, 512, 64), (100, 256, 128), (1, 512, 64)):
        assert port_spec.make_padding(width, crop, off) == jax_spec.make_padding(width, crop, off)
    a = rng.standard_normal(10)
    for n in (4, 10, 15):
        b = np.zeros(n)
        np.testing.assert_array_equal(port_spec.match_mono_array_shapes(a, b),
                                      jax_spec.match_mono_array_shapes(a, b))


@pytest.mark.parametrize("thres", [0.2, 0.5, 0.99])
def test_merge_artifacts_matches_jax(thres):
    rng = np.random.default_rng(int(thres * 100))
    mask = rng.uniform(0.0, 1.0, (2, 17, 400)).astype(np.float32)
    mask[:, :, 30:200] = rng.uniform(0.6, 1.0, (2, 17, 170))  # a long run above 0.5
    mask[:, :, 330:] = 0.9  # a run that reaches the end
    got = merge_artifacts(mask.copy(), thres=thres)
    want = jax_vr_bands.merge_artifacts(mask.copy(), thres=thres)
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------- tiled mask engine


@pytest.mark.parametrize("n_tiles,batch", [(5, 2), (3, 4), (1, 1)])
def test_tiled_mask_predict_matches_jax(n_tiles, batch):
    """A stand-in net (the window's centre, scaled per channel) through both
    engines: the port computes only the true tiles, JAX pads to its bucket;
    the masks agree over the port's length."""
    window, offset = 48, 8
    roi = window - 2 * offset
    spec = np.random.default_rng(n_tiles).uniform(size=(2, 5, n_tiles * roi + 3)
                                                  ).astype(np.float32)
    scale = np.array([1.0, -2.0], np.float32)[None, :, None, None]

    def jax_net(x):
        return x[..., offset:-offset] * scale

    def port_net(x):
        assert x.shape[0] <= batch
        return x[..., offset:-offset] * torch.from_numpy(scale)

    got = tiled_mask_predict(port_net, torch.from_numpy(spec), window, offset, batch,
                             n_tiles).numpy()
    want = np.asarray(jax_demix.tiled_mask_predict_dev(jax_net, jnp.asarray(spec), window,
                                                       offset, batch, n_tiles))
    assert got.shape == (2, 5, n_tiles * roi) and want.shape[-1] >= got.shape[-1]
    np.testing.assert_array_equal(got, want[..., : got.shape[-1]])


# ------------------------------------------------------------- chain stages


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _jax_programs(geom, t, roi, tta, aggr, high_end):
    """The JAX chain programs at the true length ``t`` (no bucket), each
    compiled once."""
    n_frame = jax_chain.chain_frames(geom, t)
    aggressiveness = {"value": aggr, "split_bin": 200, "aggr_correction": None}
    return (jax_chain.build_analyze(geom, t),
            jax_chain.build_finalize(n_frame, roi, tta, aggressiveness, False),
            jax_chain.build_synthesize(geom, n_frame, high_end), aggressiveness)


def _compiled(fn, *args):
    return fn.lower(*args).compile(compiler_options=FAST_COMPILE)(*args)


CHAIN_CASES = {
    # name: (model params, is_v51, seconds, tta, aggression value, high end)
    "3band_v5_tta_high_end": (_mp_3band_v5(), False, 1.37, True, 0.05, True),
    "4band_v4_ms_fullband_v51": ("4band_v4_ms_fullband", True, 1.21, False, 0.1, True),
    "reverse": (_mp_3band_v5(reverse=True), False, 1.43, False, 0.1, False),
    "mid_side": (_mp_3band_v5(mid_side=True), False, 1.0, True, 0.0, False),
    "mid_side_b2_high_end": (_mp_3band_v5(mid_side_b2=True), False, 1.1, False, 0.05, True),
    "2band_v51_mid_side_c_stereo_n": (_mp_2band_v51(), True, 1.3, False, 0.1, False),
}


@pytest.mark.parametrize("case", list(CHAIN_CASES))
def test_chain_stages_match_jax(case):
    mp, is_v51, seconds, tta, aggr, high_end = CHAIN_CASES[case]
    if isinstance(mp, str):
        mp = port_vr_arch.load_vr_model_params(mp)
    geom = port_chain.band_geometry(mp, is_v51)
    assert geom == jax_chain.band_geometry(mp, is_v51)
    sr_top = mp["band"][len(mp["band"])]["sr"]
    t = int(sr_top * seconds)
    rng = np.random.default_rng(len(case))
    wave = (rng.standard_normal((2, t)) * 0.3).astype(np.float32)
    roi = 64
    analyze, fin, synth, aggressiveness = _jax_programs(geom, t, roi, tta, aggr, high_end)

    # analyze
    spec_c, he = port_chain.analyze(geom, torch.from_numpy(wave))
    spec_j, he_j = _compiled(analyze, jnp.asarray(wave), jnp.int32(t))
    n_frame = port_chain.chain_frames(geom, t)
    assert spec_c.shape == (2, mp["bins"] + 1, n_frame)
    _close(spec_c.numpy(), spec_j)
    assert (he is None) == (he_j is None)
    if he is not None:
        _close(he.numpy(), he_j)

    # finalize: a tiled mask a little longer than the track (and its TTA pass)
    n_mask = (n_frame // roi + 1) * roi
    mask = rng.uniform(0.0, 1.0, (2, mp["bins"] + 1, n_mask)).astype(np.float32)
    mask_tta = (rng.uniform(0.0, 1.0, (2, mp["bins"] + 1, n_mask + roi)).astype(np.float32)
                if tta else None)
    got_m = port_chain.finalize(torch.from_numpy(mask), n_frame, roi, aggressiveness, False,
                                None if mask_tta is None else torch.from_numpy(mask_tta))
    args = (jnp.asarray(mask),) + ((jnp.asarray(mask_tta),) if tta else ())
    want_m = _compiled(fin, *args)
    _close(got_m.numpy(), want_m)

    # synthesize, from the same (JAX) spectrogram and mask
    spec_in = np.array(spec_j)
    got_w = port_chain.synthesize(geom, torch.from_numpy(np.array(want_m)),
                                  torch.from_numpy(spec_in),
                                  torch.from_numpy(np.array(he_j)) if high_end else None)
    s_args = (want_m, spec_j, jnp.int32(n_frame)) + ((he_j,) if high_end else ())
    want_w = _compiled(synth, *s_args)
    out_len = port_chain.synth_out_len(geom, n_frame)
    assert out_len == jax_chain.synth_out_len(geom, n_frame)
    assert got_w.shape == (2, 2, out_len) and want_w.shape[-1] == out_len
    _close(got_w.numpy(), want_w)


def test_chain_lengths_match_jax_over_many_track_lengths():
    for name in ("4band_v4_ms_fullband", "4band_44100", "2band_32000", "1band_sr33075_hl384"):
        mp = port_vr_arch.load_vr_model_params(name)
        geom = port_chain.band_geometry(mp, name.endswith("fullband"))
        for t in (1, 999, 44100, 123457, 1323000):
            n_frame = port_chain.chain_frames(geom, t)
            assert n_frame == jax_chain.chain_frames(geom, t)
            assert port_chain.synth_out_len(geom, n_frame) == \
                jax_chain.synth_out_len(geom, n_frame)


def test_chain_on_silence_gives_silence_of_the_expected_length():
    """A silent track through all three stages of the v5.1 fullband
    geometry with high end on: zero stems (the mask's normaliser is never
    reached by the chain itself), and the synthesis length the JAX
    arithmetic gives."""
    mp = port_vr_arch.load_vr_model_params("4band_v4_ms_fullband")
    geom = port_chain.band_geometry(mp, True)
    spec_c, he = port_chain.analyze(geom, torch.zeros(2, 44100))
    n_frame = spec_c.shape[-1]
    mask = port_chain.finalize(torch.full((2, mp["bins"] + 1, n_frame + 40), 0.5), n_frame,
                               64, {"value": 0.05, "split_bin": 102,
                                    "aggr_correction": None}, True)
    waves = port_chain.synthesize(geom, mask, spec_c, he)
    assert waves.shape == (2, 2, jax_chain.synth_out_len(geom, n_frame))
    assert not bool(waves.abs().max())
