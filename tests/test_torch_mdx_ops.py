"""The host and engine pieces the MDX path adds to the port, against the JAX
package's own versions on the same seeded inputs: framing and overlap-add
(``ops/stft``), the spectral inversion of a stem and ``to_shape``
(``ops/spec``), and cross-job batching with per-job layouts
(``ops/demix.demix_jobs_layout``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_separator_tpu.ops import demix as jax_demix
from audio_separator_tpu.ops import spec as jax_spec
from audio_separator_tpu.ops import stft as jax_stft
from audio_separator_tpu_torch.ops import demix, spec, stft


@pytest.mark.parametrize("frame_len,hop,length", [(16, 4, 100), (10, 4, 38), (8, 8, 64)])
def test_frame_signal_and_overlap_add_match_jax(frame_len, hop, length):
    x = np.random.default_rng(length).standard_normal((2, length)).astype(np.float32)
    frames = stft.frame_signal(torch.from_numpy(x), frame_len, hop)
    want = np.asarray(jax_stft.frame_signal(jnp.asarray(x), frame_len, hop))
    np.testing.assert_array_equal(frames.numpy(), want)
    got = stft.overlap_add(frames, hop).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_stft.overlap_add(jnp.asarray(want), hop)),
                               atol=1e-6)
    assert got.shape[-1] == frame_len + hop * (want.shape[-2] - 1)


@pytest.mark.parametrize("invert_p", [True, False])
def test_spectral_inversion_matches_jax(invert_p):
    rng = np.random.default_rng(4)
    mix = (rng.standard_normal((2, 20000)) * 0.3).astype(np.float32)
    stem = (0.6 * mix + 0.05 * rng.standard_normal((2, 20000))).astype(np.float32)
    if invert_p:  # the MDX secondary: (samples, channels) out
        got = spec.invert_stem(mix, stem)
        want = jax_spec.invert_stem(mix, stem)
    else:
        specs = [spec._stft2048(mix), spec._stft2048(stem)]
        np.testing.assert_allclose(specs[0], jax_spec._stft2048(mix), atol=1e-4)
        got = spec._istft2048(spec.invert_audio(specs, invert_p=False))
        want = jax_spec._istft2048(jax_spec.invert_audio(
            [jax_spec._stft2048(mix), jax_spec._stft2048(stem)], invert_p=False))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def test_to_shape_matches_jax():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    np.testing.assert_array_equal(spec.to_shape(x, (3, 5)), jax_spec.to_shape(x, (3, 5)))


def _port_model(chunks):  # (B, C, chunk) -> (B, 1, C, chunk)
    return torch.tanh(2.0 * chunks)[:, None]


def _jax_model(chunks):
    return jnp.tanh(2.0 * chunks)[:, None]


def _layout(mix, chunk, step):
    """An MDX-style job: positions past the end, hanning tails, divider."""
    total = mix.shape[1]
    positions = np.arange(0, total, step)
    windows = np.zeros((len(positions), chunk), np.float32)
    divider = np.zeros(total, np.float32)
    for row, start in enumerate(positions):
        actual = min(start + chunk, total) - start
        windows[row, :actual] = np.hanning(actual)
        divider[start : start + actual] += windows[row, :actual]
    return mix, positions, windows, np.maximum(divider, 1e-10)


@pytest.mark.parametrize("batch_size", [1, 3])
def test_demix_jobs_layout_matches_jax_and_solo(batch_size):
    rng = np.random.default_rng(9)
    chunk, step = 512, 384
    jobs = [_layout((rng.standard_normal((2, t)) * 0.4).astype(np.float32), chunk, step)
            for t in (3000, 700, 1900)]
    got = demix.demix_jobs_layout(_port_model, jobs, chunk, step, num_stems=1,
                                  batch_size=batch_size, device="cpu")
    want = jax_demix.demix_jobs_layout(_jax_model, jobs, chunk, step, num_stems=1,
                                       batch_size=batch_size, quantized_transfer=False,
                                       quantized_upload=False)
    for (mix, positions, windows, divider), g, w in zip(jobs, got, want):
        assert g.shape == np.asarray(w).shape == (1, 2, mix.shape[1])
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-6)
        solo = demix.overlap_add_demix(_port_model, mix, chunk, step, windows, num_stems=1,
                                       batch_size=batch_size, positions=positions,
                                       divider=divider, device="cpu")
        np.testing.assert_array_equal(g, solo)
    assert demix.demix_jobs_layout(_port_model, [], chunk, step, 1, 2, device="cpu") == []
