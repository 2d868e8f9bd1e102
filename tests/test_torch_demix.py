"""The port's overlap-add demix engine against the JAX engine, with the same
simple model function on both sides, a clamped tail, batch padding, a
device-side stem selection, and what the Demucs path passes: per-position
window rows, an explicit divider and a device-side post function."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_separator_tpu.ops import demix as jax_demix
from audio_separator_tpu.ops.stft import hamming_window as jax_hamming
from audio_separator_tpu_torch.ops import demix
from audio_separator_tpu_torch.ops.stft import hamming_window


def _port_model(chunks):  # (B, C, chunk) -> (B, 2, C, chunk)
    return torch.stack([chunks * 0.5, torch.tanh(3.0 * chunks)], dim=1)


def _jax_model(chunks):
    return jnp.stack([chunks * 0.5, jnp.tanh(3.0 * chunks)], axis=1)


@pytest.mark.parametrize("total,chunk,step", [(5000, 1024, 700), (1000, 1024, 512),
                                              (4096, 1024, 1024)])
def test_window_positions_match_jax(total, chunk, step):
    np.testing.assert_array_equal(demix.window_positions(total, chunk, step),
                                  jax_demix.window_positions(total, chunk, step))


@pytest.mark.parametrize("batch_size,fetch_stems", [(3, None), (1, None), (4, (1,)),
                                                    (2, (1, 0))])
def test_overlap_add_demix_matches_jax(batch_size, fetch_stems):
    rng = np.random.default_rng(0)
    chunk, step, total = 1024, 700, 5000  # clamped tail: last start 3976
    mix = (rng.standard_normal((2, total)) * 0.4).astype(np.float32)
    got = demix.overlap_add_demix(_port_model, mix, chunk, step,
                                  hamming_window(chunk).numpy(), num_stems=2,
                                  batch_size=batch_size, fetch_stems=fetch_stems,
                                  device="cpu")
    want = jax_demix.overlap_add_demix(
        _jax_model, mix, chunk, step, np.asarray(jax_hamming(chunk)), num_stems=2,
        batch_size=batch_size, fetch_stems=fetch_stems, quantized_transfer=False,
        quantized_upload=False, pipeline_segments=1)
    n_out = 2 if fetch_stems is None else len(fetch_stems)
    assert got.shape == want.shape == (n_out, 2, total)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_overlap_add_demix_short_mix_is_one_window():
    mix = np.random.default_rng(1).standard_normal((2, 300)).astype(np.float32)
    seen = []

    def model(chunks):
        seen.append(tuple(chunks.shape))
        return _port_model(chunks)

    out = demix.overlap_add_demix(model, mix, 1024, 512, np.ones(1024, np.float32),
                                  num_stems=2, batch_size=2, device="cpu")
    assert seen == [(2, 2, 1024)]  # one real window plus one zero-weight pad row
    np.testing.assert_allclose(out[0], mix * 0.5, atol=1e-7)


def _demucs_like_layout(chunk=1024, track=3000, shifts=2):
    """Per-position rows with centred tails, a divider and two disjoint
    regions of one buffer, as the Demucs shift trick lays them out."""
    stride = int(0.75 * chunk)
    tri = np.concatenate([np.arange(1, chunk // 2 + 1),
                          np.arange(chunk - chunk // 2, 0, -1)]).astype(np.float32)
    tri /= tri.max()
    span = 3 * chunk + track
    positions, rows = [], []
    divider = np.zeros(span, np.float32)
    for offset in range(0, track, stride):
        n = min(chunk, track - offset)
        delta = chunk - n
        row = np.zeros(chunk, np.float32)
        row[delta // 2 : delta // 2 + n] = tri[:n]
        positions.append(chunk + offset - delta // 2)
        rows.append(row)
        divider[chunk + offset : chunk + offset + n] += tri[:n]
    positions = np.concatenate([np.asarray(positions) + s * span for s in range(shifts)])
    rows = np.tile(np.stack(rows), (shifts, 1))
    divider = np.tile(np.maximum(divider, 1e-10), shifts)
    rng = np.random.default_rng(3)
    buf = np.zeros((2, span * shifts), np.float32)
    for s in range(shifts):
        buf[:, s * span + chunk : s * span + chunk + track] = \
            rng.standard_normal((2, track)) * 0.4
    return chunk, stride, span, track, positions.astype(np.int32), rows, divider, buf


def _jax_engine(model, buf, chunk, stride, rows, **kw):
    return jax_demix.overlap_add_demix(
        model, buf, chunk, stride, rows, num_stems=2, quantized_transfer=False,
        quantized_upload=False, pipeline_segments=1, **kw)


@pytest.mark.parametrize("batch_size", [1, 4])
@pytest.mark.parametrize("with_divider", [False, True])
def test_per_position_window_rows_match_jax(batch_size, with_divider):
    chunk, stride, _, _, positions, rows, divider, buf = _demucs_like_layout()
    kw = dict(batch_size=batch_size, positions=positions,
              divider=divider if with_divider else None)
    got = demix.overlap_add_demix(_port_model, buf, chunk, stride, rows, num_stems=2,
                                  device="cpu", **kw)
    want = _jax_engine(_jax_model, buf, chunk, stride, rows, **kw)
    assert got.shape == want.shape == (2, 2, buf.shape[-1])
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("fetch_stems", [None, (1,)])
def test_post_device_fn_matches_jax(fetch_stems):
    """The post function sees the normalised (stems, C, T_buf) tensor on the
    device, after the stem selection, and owns the fetched shape."""
    chunk, stride, span, track, positions, rows, divider, buf = _demucs_like_layout()
    starts = [s * span + chunk for s in range(2)]
    seen = []

    def port_post(acc):
        assert isinstance(acc, torch.Tensor)
        seen.append(tuple(acc.shape))
        return sum(acc[..., a : a + track] for a in starts) / 2

    def jax_post(acc):
        return sum(acc[..., a : a + track] for a in starts) / 2

    kw = dict(batch_size=4, positions=positions, divider=divider, fetch_stems=fetch_stems)
    got = demix.overlap_add_demix(_port_model, buf, chunk, stride, rows, num_stems=2,
                                  post_device_fn=port_post, device="cpu", **kw)
    want = _jax_engine(_jax_model, buf, chunk, stride, rows, post_device_fn=jax_post, **kw)
    n_out = 2 if fetch_stems is None else 1
    assert seen == [(n_out, 2, buf.shape[-1])]
    assert got.shape == want.shape == (n_out, 2, track)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_short_divider_is_extended_with_ones_and_rows_are_checked():
    chunk, stride, _, _, positions, rows, divider, buf = _demucs_like_layout(shifts=1)
    full = demix.overlap_add_demix(_port_model, buf, chunk, stride, rows, num_stems=2,
                                   batch_size=2, positions=positions, divider=divider,
                                   device="cpu")
    cut = len(divider) - chunk  # no window weight lies in the last chunk samples
    short = demix.overlap_add_demix(_port_model, buf, chunk, stride, rows, num_stems=2,
                                    batch_size=2, positions=positions,
                                    divider=divider[:cut], device="cpu")
    np.testing.assert_array_equal(full, short)
    with pytest.raises(ValueError, match="window rows"):
        demix.overlap_add_demix(_port_model, buf, chunk, stride, rows[:-1], num_stems=2,
                                positions=positions, device="cpu")
