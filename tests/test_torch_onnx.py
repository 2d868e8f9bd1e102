"""The port's ONNX executor (``models/onnx_torch``) against the JAX package's
(``onnx_to_jax``) and against the torch module that was exported, on the
graphs of tests/test_onnx_jax.py and a few more, at that file's tolerance:
2e-5 of the output scale, 5e-5 for the Conv-TDF graphs. Both executors get the
same weights: the port's come from the JAX executor's params through
``models/convert.convert_onnx_params``."""

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax.numpy as jnp

from audio_separator_tpu.models.onnx_jax import onnx_to_jax
from audio_separator_tpu_torch.models.convert import convert_onnx_params
from audio_separator_tpu_torch.models.onnx_torch import OnnxToTorch, onnx_to_torch
from audio_separator_tpu_torch.models.onnx_proto import load_model

# test_onnx_jax sets the exporter's onnxscript bypass on import.
from test_onnx_jax import MiniConvTDF, TFCTDFBlock
from torch_oracles.convtdf_oracle import seeded_convtdf


class _LinearReshape(nn.Module):
    def __init__(self):
        super().__init__()
        self.l1 = nn.Linear(24, 12)
        self.l2 = nn.Linear(12, 6)

    def forward(self, x):
        b = x.shape[0]
        x = torch.tanh(self.l1(x.reshape(b, -1)))
        return self.l2(x).reshape(b, 2, 3)


class _ConcatSplitPad(nn.Module):
    def forward(self, x):
        a, b = torch.split(x, 2, dim=1)
        y = torch.cat([a, b, a * b], dim=1)
        return nn.functional.pad(y, (1, 2, 3, 0))


class _MoreOps(nn.Module):
    """Resize (nearest and bilinear), Gemm, LayerNormalization, Erf (GELU),
    Softmax, Slice with a negative step (flip), ReduceMean, Where, Expand,
    Pow, Sqrt, Div, Neg, Abs, Clip, LeakyRelu, Tile, Gather."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(2, 4, 3, padding=1)
        self.norm = nn.LayerNorm(8)
        self.fc = nn.Linear(16, 5)

    def forward(self, x):  # (B, 2, 4, 4)
        y = self.conv(x)
        y = nn.functional.interpolate(y, scale_factor=2, mode="nearest")       # (B, 4, 8, 8)
        z = nn.functional.interpolate(y, scale_factor=2, mode="bilinear")      # (B, 4, 16, 16)
        y = self.norm(y) + nn.functional.gelu(y)
        y = torch.softmax(y, dim=-1) + torch.flip(y, dims=[-1])
        y = torch.where(y > 0, y, nn.functional.leaky_relu(y, 0.1))
        y = y / torch.sqrt(torch.abs(y) + 1.0) - torch.pow(y, 2).mean(dim=(2, 3), keepdim=True)
        y = torch.clamp(-y, -2.0, 2.0).repeat(1, 1, 2, 2) + z                  # (B, 4, 16, 16)
        g = self.fc(y[:, 0, 3])                                                # Gather + Gemm
        return y.sum(dim=1) + g.mean(dim=-1, keepdim=True)[:, :, None].expand(-1, 16, 16)


# name -> (module factory, input factory, opset, tolerance); the first eight
# are the graphs of tests/test_onnx_jax.py.
CASES = {
    "mini_convtdf": (lambda: MiniConvTDF(), lambda: torch.randn(1, 4, 32, 16), 17, 5e-5),
    "conv_padding_strides": (lambda: nn.Sequential(
        nn.Conv2d(3, 6, (3, 5), stride=(2, 1), padding=(1, 2)), nn.ReLU(),
        nn.Conv2d(6, 6, 3, padding=1, groups=3)), lambda: torch.randn(2, 3, 17, 19), 17, 2e-5),
    "conv_transpose_output_padding": (
        lambda: nn.ConvTranspose2d(4, 3, 3, stride=2, padding=1, output_padding=1),
        lambda: torch.randn(1, 4, 9, 11), 17, 2e-5),
    "conv_transpose_groups": (lambda: nn.ConvTranspose2d(4, 4, 2, stride=2, groups=2),
                              lambda: torch.randn(1, 4, 8, 8), 17, 2e-5),
    "pools_and_activations": (lambda: nn.Sequential(
        nn.Conv2d(2, 4, 3, padding=1), nn.MaxPool2d(2), nn.ELU(), nn.AvgPool2d(2),
        nn.Sigmoid()), lambda: torch.randn(1, 2, 16, 16), 17, 2e-5),
    "linear_and_reshape": (_LinearReshape, lambda: torch.randn(3, 4, 6), 17, 2e-5),
    "opset11_groupnorm": (lambda: nn.Sequential(
        nn.Conv2d(4, 8, 3, padding=1), nn.GroupNorm(4, 8), nn.ReLU()),
        lambda: torch.randn(1, 4, 12, 12), 11, 2e-5),
    "concat_split_pad": (_ConcatSplitPad, lambda: torch.randn(2, 4, 5, 6), 17, 2e-5),
    "tfc_tdf_block": (lambda: TFCTDFBlock(8, 16), lambda: torch.randn(2, 8, 16, 12), 17, 5e-5),
    "convtdfnet_small": (lambda: seeded_convtdf(0, dim_c=4, dim_f=64, num_blocks=5, l=3, g=8,
                                                k=3, bn=8),
                         lambda: torch.randn(2, 4, 64, 32), 17, 5e-5),
    "more_ops": (_MoreOps, lambda: torch.randn(2, 2, 4, 4), 17, 2e-5),
}


def _export(name, tmp_path):
    make_model, make_input, opset, tol = CASES[name]
    torch.manual_seed(sorted(CASES).index(name))
    model = make_model().eval()
    x = make_input()
    path = str(tmp_path / f"{name}.onnx")
    torch.onnx.export(model, x, path, input_names=["input"], output_names=["output"],
                      opset_version=opset, dynamo=False)
    return model, x, path, tol


def _close(got, want, tol):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol * max(1.0, np.abs(want).max()), rtol=0)


@pytest.mark.parametrize("name", list(CASES))
def test_executor_matches_jax_and_torch(name, tmp_path):
    model, x, path, tol = _export(name, tmp_path)
    jax_fn, jax_params, _, _ = onnx_to_jax(path)
    fn = OnnxToTorch(load_model(path)).make_fn()
    with torch.no_grad():
        ref = model(x).numpy()
        got = fn(convert_onnx_params(jax_params), x)[0].numpy()
    want = np.asarray(jax_fn(jax_params, jnp.asarray(x.numpy()))[0])
    _close(got, ref, tol)
    _close(got, want, tol)


def test_onnx_to_torch_params_are_the_graph_initializers(tmp_path):
    _, x, path, _ = _export("mini_convtdf", tmp_path)
    fn, params, in_names, out_names = onnx_to_torch(path, device="cpu")
    _, jax_params, jax_in, jax_out = onnx_to_jax(path)
    assert (in_names, out_names) == (jax_in, jax_out) == (["input"], ["output"])
    assert sorted(params) == sorted(jax_params)
    for name, value in jax_params.items():
        assert params[name].device.type == "cpu"
        np.testing.assert_array_equal(params[name].numpy(), np.asarray(value))
    with torch.no_grad():
        np.testing.assert_array_equal(fn(params, x)[0].numpy(),
                                      fn(convert_onnx_params(jax_params), x)[0].numpy())


def test_bf16_input_runs_the_net_in_bf16(tmp_path):
    """Weights follow the input's dtype, as in the JAX executor: a bf16
    input gives a bf16 output near both the float32 output and the JAX
    executor's bf16 output (bf16 keeps 8 bits; a few roundings deep)."""
    _, x, path, _ = _export("convtdfnet_small", tmp_path)
    jax_fn, jax_params, _, _ = onnx_to_jax(path)
    fn, params, _, _ = onnx_to_torch(path, device="cpu")
    with torch.no_grad():
        full = fn(params, x)[0]
        half = fn(params, x.bfloat16())[0]
    jax_half = np.asarray(jax_fn(jax_params, jnp.asarray(x.numpy(), jnp.bfloat16))[0]
                          ).astype(np.float32)
    assert half.dtype == torch.bfloat16
    scale = float(full.abs().max())
    assert float((half.float() - full).abs().max()) < 2.0 ** -4 * scale
    assert np.abs(half.float().numpy() - jax_half).max() < 2.0 ** -4 * scale


def test_resize_refuses_other_coordinate_modes(tmp_path):
    class AlignCorners(nn.Module):
        def forward(self, x):
            return nn.functional.interpolate(x, scale_factor=2, mode="bilinear",
                                             align_corners=True)

    path = str(tmp_path / "align.onnx")
    torch.onnx.export(AlignCorners(), torch.randn(1, 1, 4, 4), path, input_names=["input"],
                      output_names=["output"], opset_version=17, dynamo=False)
    fn, params, _, _ = onnx_to_torch(path, device="cpu")
    with pytest.raises(NotImplementedError, match="align_corners"):
        fn(params, torch.randn(1, 1, 4, 4))


def test_unknown_op_is_named(tmp_path):
    class Cumsum(nn.Module):
        def forward(self, x):
            return torch.cumsum(x, dim=1)

    path = str(tmp_path / "cumsum.onnx")
    torch.onnx.export(Cumsum(), torch.randn(2, 3), path, input_names=["input"],
                      output_names=["output"], opset_version=17, dynamo=False)
    fn, params, _, _ = onnx_to_torch(path, device="cpu")
    with pytest.raises(NotImplementedError, match="CumSum"):
        fn(params, torch.randn(2, 3))
