"""The plain 3xTF32 split that the float32 GEMM (csrc/gemm_tf32.cuh) runs on
the tensor cores: its contract, its products against float64, and the
prepared weight form. numpy makes the inputs; all of it runs on the CPU.

Bounds: ``split_tf32`` leaves ``|x - hi - lo| <= 2^-22·|x|`` (two roundings
to nearest at 10 mantissa bits), checked at 2^-21; a 3xTF32 product drops
``a_lo·b_lo`` and the split errors (about 2^-21 of each term) and adds in
float32, so against the float64 product it stays within 1e-6 of the output
scale (largest |output|) at the depths the RoFormer blocks use."""

import numpy as np
import pytest
import torch

from audio_separator_tpu_torch.models.convert import load_jax_params
from audio_separator_tpu_torch.models.init_params import init_roformer_params
from audio_separator_tpu_torch.models.roformer import Roformer, RoformerConfig, tf32_stack_forms
from audio_separator_tpu_torch.ops.tf32 import (matmul_3xtf32, prepare_tf32_weight,
                                                 split_tf32)


def _normal(shape, seed, scale=1.0):
    return torch.from_numpy(
        (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32))


@pytest.mark.parametrize("scale", [1e-3, 1.0, 3e4])
def test_split_tf32_contract(scale):
    x = _normal((4096,), seed=1, scale=scale)
    hi, lo = split_tf32(x)
    for part in (hi, lo):
        assert part.dtype == torch.float32
        assert not (part.view(torch.int32) & 0x1FFF).any()  # low 13 mantissa bits zero
    err = (x.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -21 * x.double().abs()).all())
    assert bool(((x - hi).abs() <= 2.0 ** -11 * x.abs()).all())  # hi is the nearest


def test_split_tf32_rounds_ties_away_from_zero():
    """1 + 2^-11 lies halfway between two TF32 values: hi goes away from zero,
    as cvt.rna.tf32.f32 does, and the kernel's bit operations do."""
    x = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12, 0.0])
    hi, lo = split_tf32(x)
    assert hi.tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0, 0.0]
    assert (hi + lo).tolist() == x.tolist()


@pytest.mark.parametrize("k", [64, 512, 2048])
def test_3xtf32_product_matches_float64(k):
    a = _normal((96, k), seed=k)
    b = _normal((k, 80), seed=k + 1, scale=0.05)
    want = a.double() @ b.double()
    scale = float(want.abs().max())
    err3 = float((matmul_3xtf32(a, b).double() - want).abs().max())
    assert err3 <= 1e-6 * scale, (err3, scale)
    # One TF32 product alone is some three orders of magnitude further off.
    a_hi, _ = split_tf32(a)
    b_hi, _ = split_tf32(b)
    err1 = float(((a_hi @ b_hi).double() - want).abs().max())
    assert err1 > 30 * err3


def test_prepared_weight_form():
    w = _normal((512, 1536), seed=3, scale=0.05)
    form = prepare_tf32_weight(w)
    assert form.shape == (2, 1536, 512) and form.dtype == torch.float32
    assert form.is_contiguous()
    back = (form[0].double() + form[1].double()).t()
    assert bool(((back - w.double()).abs() <= 2.0 ** -21 * w.double().abs()).all())
    assert torch.equal(form[0], split_tf32(w.t().contiguous())[0])
    with pytest.raises(ValueError):
        prepare_tf32_weight(w[0])
    with pytest.raises(TypeError):
        split_tf32(w.to(torch.bfloat16))


def _small_roformer():
    cfg = RoformerConfig(kind="bs", dim=64, depth=2, stereo=True, num_stems=1,
                         time_transformer_depth=1, freq_transformer_depth=1,
                         freqs_per_bands=(2, 3, 4), dim_head=16, heads=2,
                         stft_n_fft=16, stft_hop_length=4, stft_win_length=16,
                         mask_estimator_depth=1)
    return load_jax_params(Roformer(cfg), init_roformer_params(cfg, seed=4))


def test_roformer_stack_forms_are_the_prepared_weights():
    """Each layer's slice of the stacked forms is prepare_tf32_weight of that
    layer's weight."""
    stack = _small_roformer().blocks["time"]
    forms = tf32_stack_forms(stack, Roformer.TF32_WEIGHTS)
    for name in Roformer.TF32_WEIGHTS:
        w = stack[name]
        assert forms[name].shape == (*w.shape[:2], 2, w.shape[3], w.shape[2])
        for d in range(w.shape[0]):
            assert forms[name][d, 0].is_contiguous()
            assert torch.equal(forms[name][d, 0], prepare_tf32_weight(w[d, 0]))


def test_roformer_keeps_no_tf32_forms_off_the_card():
    """The module builds the prepared forms only for float32 parameters on
    the card; on the CPU (plain versions) and in bf16 there are none."""
    model = _small_roformer()
    assert model.tf32_forms() is None
    assert model.to(torch.bfloat16).tf32_forms() is None
