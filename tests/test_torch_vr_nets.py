"""The port's VR mask nets (``models/vr_nets.py``) and LSTM
(``models/lstm.py``) against the JAX package's ``models/vr_nets.py`` and the
torch oracle of ``tests/torch_oracles/vr_oracle.py``, on the CPU.

Tolerances are the JAX package's own against the same oracle: atol 2e-4 for
the v5 net (``tests/test_vr.py``), 3e-4 for v5.1. The whole v5.1 net is held
to the oracle only (its JAX forward costs about 50 s here); its LSTM module
and the LSTM itself are held to the JAX ``_lstm_module`` and
``_lstm_cell_scan`` directly, small and at full width (one layer,
nout_lstm 128 over 224 bins, 64 frames)."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_separator_tpu.models import vr_nets as jax_vr
from audio_separator_tpu_torch.architectures.vr import NN_ARCH_SIZES
from audio_separator_tpu_torch.models.convert import load_jax_vr_params
from audio_separator_tpu_torch.models.lstm import LSTM
from audio_separator_tpu_torch.models.vr_nets import (
    LSTMModule,
    bilinear_align_corners,
    build_vr_net,
    load_vr_net,
)
from torch_oracles.vr_oracle import CascadedASPPNetOracle, CascadedNetOracle

from test_vr import SP_CAPS, _randomize


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these modules' CPU work. The LSTM steps a frame
    at a time, each step a parallel region of a few small products; when the
    test workers share the cores, every region waits on descheduled threads
    (the v5.1 separator test took 495 s under six workers, 13 s with one
    thread). The other VR test files import this fixture."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sd(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


def _mag(seed, *shape):
    return np.abs(np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


# XLA:CPU's backend optimisations take most of a whole-net compile under the
# debug allocator tests/conftest.py preloads; the forward's numerics do not depend on them.
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def _jax_v5(sd, x, arch):
    """The JAX net, jitted and compiled once (cheaper here than eager
    dispatch)."""
    fn = jax.jit(functools.partial(jax_vr.predict_mask_v5, n_fft_bins=256, arch=arch,
                                   offset=128))
    tree = jax_vr.state_dict_to_tree(sd)
    return np.asarray(fn.lower(tree, x).compile(compiler_options=FAST_COMPILE)(tree, x))


@pytest.mark.parametrize("arch", [31191, 33966, 129605])
def test_v5_net_matches_oracle(arch):
    """arch 31191: the five-branch ASPP; 33966: seven branches, conv6 and
    conv7 shared upstream; 129605: enc5/dec5 and six branches."""
    oracle = _randomize(CascadedASPPNetOracle(256, SP_CAPS, arch), seed=arch % 7).eval()
    net = load_vr_net(_sd(oracle), 256, arch, is_v51=False, offset=128)
    x = torch.from_numpy(_mag(arch, 1, 2, 129, 384))
    with torch.no_grad():
        got, want = net(x).numpy(), oracle.predict_mask(x).numpy()
    assert got.shape == want.shape == (1, 2, 129, 128)
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_v5_net_matches_jax_predict_mask():
    """The whole cascade against the JAX ``predict_mask_v5`` (arch 31191,
    512 frames); the other two architectures differ from it only inside the
    band nets, held to the JAX package's below."""
    oracle = _randomize(CascadedASPPNetOracle(256, SP_CAPS, 31191), seed=1).eval()
    sd = _sd(oracle)
    net = load_vr_net(sd, 256, 31191, is_v51=False, offset=128)
    x = _mag(1, 1, 2, 129, 512)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    want = _jax_v5(sd, jnp.asarray(x), 31191)
    assert got.shape == want.shape == (1, 2, 129, 256)
    np.testing.assert_allclose(got, want, atol=2e-4)


@pytest.mark.parametrize("arch", [31191, 33966, 129605])
def test_v5_band_net_matches_jax(arch):
    """One ``BaseASPPNet`` (encoders, the architecture's ASPP, decoders)
    against the JAX ``_base_aspp_net`` on the stage-3 band net's input."""
    oracle = _randomize(CascadedASPPNetOracle(256, SP_CAPS, arch), seed=arch % 5).eval()
    sd = _sd(oracle)
    net = load_vr_net(sd, 256, arch, is_v51=False, offset=128).stg3_full_band_net
    x = _mag(arch + 1, 1, 16, 128, 288)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    tree = jax_vr.state_dict_to_tree(sd)["stg3_full_band_net"]
    fn = jax.jit(functools.partial(jax_vr._base_aspp_net, arch=arch))
    xj = jnp.asarray(x)
    want = np.asarray(fn.lower(tree, xj).compile(compiler_options=FAST_COMPILE)(tree, xj))
    assert got.shape == want.shape == (1, 32, 128, 288)
    np.testing.assert_allclose(got, want, atol=2e-4 * max(1.0, np.abs(want).max()))


def test_v51_net_matches_oracle():
    oracle = _randomize(CascadedNetOracle(256, nout=8, nout_lstm=16), seed=2).eval()
    net = load_vr_net(_sd(oracle), 256, arch=56817, is_v51=True, offset=64)
    x = _mag(2, 2, 2, 129, 256)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
        want = oracle.predict_mask(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 2, 129, 128)
    np.testing.assert_allclose(got, want, atol=3e-4)


@pytest.mark.parametrize("nin_conv,nin_lstm,nout_lstm,batch,frames",
                         [(4, 16, 8, 2, 24),
                          (128, 224, 128, 1, 64)])  # the last: full width, one layer
def test_lstm_module_matches_jax(nin_conv, nin_lstm, nout_lstm, batch, frames):
    from torch_oracles.vr_oracle import LSTMModule as OracleLSTMModule

    oracle = _randomize(OracleLSTMModule(nin_conv, nin_lstm, nout_lstm), seed=nout_lstm).eval()
    sd = _sd(oracle)
    shapes = {k: v.shape for k, v in sd.items()}
    module = LSTMModule({f"m.{k}": v for k, v in shapes.items()}, "m")
    load_jax_vr_params(module, jax_vr.state_dict_to_tree(sd))
    x = _mag(nin_lstm, batch, nin_conv, nin_lstm, frames)
    with torch.no_grad():
        got = module.eval()(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_vr._lstm_module(jax_vr.state_dict_to_tree(sd), jnp.asarray(x)))
    assert got.shape == want.shape == (batch, 1, nin_lstm, frames)
    np.testing.assert_allclose(got, want, atol=1e-5 * max(1.0, np.abs(want).max()))


def _jax_lstm(params, x, layers, bidirectional):
    """The JAX package's stacking of ``_lstm_cell_scan``: one scan a
    direction and a layer, the directions concatenated (as
    ``models/htdemucs._blstm`` runs Demucs v3's two layers)."""
    seq = jnp.asarray(x)
    for k in range(layers):
        outs = [jax_vr._lstm_cell_scan(seq, *(params[f"{n}_l{k}"] for n in (
            "weight_ih", "weight_hh", "bias_ih", "bias_hh")))]
        if bidirectional:
            outs.append(jax_vr._lstm_cell_scan(seq, *(params[f"{n}_l{k}_reverse"] for n in (
                "weight_ih", "weight_hh", "bias_ih", "bias_hh")), reverse=True))
        seq = jnp.concatenate(outs, axis=-1)
    return np.asarray(seq)


@pytest.mark.parametrize("layers,bidirectional,t,b,n_in,hidden",
                         [(1, False, 30, 3, 12, 8), (1, True, 30, 2, 12, 8),
                          (2, True, 50, 2, 16, 16),  # Demucs v3's BLSTM shape, small
                          (1, True, 64, 1, 224, 64)])  # v5.1 at full width
def test_lstm_matches_jax_cell_scan(layers, bidirectional, t, b, n_in, hidden):
    torch.manual_seed(t + layers)
    lstm = LSTM(n_in, hidden, num_layers=layers, bidirectional=bidirectional).eval()
    params = {k: v.detach().numpy() for k, v in lstm.state_dict().items()}
    shapes = {f"p.{k}": v.shape for k, v in params.items()}
    rebuilt = LSTM.from_state_shapes(shapes, "p")
    assert (rebuilt.input_size, rebuilt.hidden_size, rebuilt.num_layers,
            rebuilt.bidirectional) == (n_in, hidden, layers, bidirectional)
    x = np.random.default_rng(t).standard_normal((t, b, n_in)).astype(np.float32)
    with torch.no_grad():
        got = lstm(torch.from_numpy(x)).numpy()
    want = _jax_lstm(params, x, layers, bidirectional)
    assert got.shape == want.shape == (t, b, hidden * (2 if bidirectional else 1))
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("shape,out", [((2, 3, 5, 7), (10, 14)), ((1, 4, 1, 9), (6, 9)),
                                       ((1, 2, 28, 64), (56, 128))])
def test_bilinear_align_corners_matches_jax_and_interpolate(shape, out):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    got = bilinear_align_corners(torch.from_numpy(x), *out).numpy()
    want = np.asarray(jax_vr.bilinear_align_corners(jnp.asarray(x), *out))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    lib = torch.nn.functional.interpolate(torch.from_numpy(x), size=out, mode="bilinear",
                                          align_corners=True).numpy()
    np.testing.assert_allclose(got, lib, rtol=0, atol=1e-5)


def test_load_jax_vr_params_round_trip():
    """The JAX tree into the module and back out as the same state dict, and
    a mismatched tree refused."""
    oracle = _randomize(CascadedNetOracle(128, nout=8, nout_lstm=8), seed=4)
    sd = _sd(oracle)
    tree = jax_vr.state_dict_to_tree(sd)
    net = build_vr_net(sd, 128, arch=56817, is_v51=True, offset=64)
    load_jax_vr_params(net, tree)
    back = net.state_dict()
    assert set(back) == {k for k in sd if not k.endswith("num_batches_tracked")}
    for key, value in back.items():
        np.testing.assert_array_equal(value.numpy(), sd[key])
    del tree["out"]
    with pytest.raises(RuntimeError, match="out.weight"):
        load_jax_vr_params(net, tree)


def test_bf16_copy_runs_in_bf16():
    """``to_compute_dtype(bf16)`` (the separator's ``use_autocast``) runs the
    v5 cascade in bf16, within a few bf16 steps of float32; in v5.1 the LSTMs
    keep computing in float32 on their bf16-rounded weights."""
    oracle = _randomize(CascadedASPPNetOracle(256, SP_CAPS, 31191), seed=5).eval()
    net = load_vr_net(_sd(oracle), 256, 31191, is_v51=False, offset=128)
    x = torch.from_numpy(_mag(5, 1, 2, 129, 384))
    with torch.no_grad():
        f32 = net(x)
        got = net.to_compute_dtype(torch.bfloat16)(x.to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and got.shape == f32.shape
    err = (got.float() - f32).abs()
    assert 0 < float(err.max()) and float(err.mean()) <= 2.0 ** -8

    v51 = CascadedNetOracle(128, nout=8, nout_lstm=8)
    net = load_vr_net(_sd(v51), 128, 56817, is_v51=True, offset=64)
    w32 = net.stg3_full_band_net.lstm_dec2.lstm.weight_hh_l0.clone()
    net.to_compute_dtype(torch.bfloat16)
    lstm = net.stg3_full_band_net.lstm_dec2.lstm
    assert net.out.weight.dtype == torch.bfloat16 and lstm.weight_hh_l0.dtype == torch.float32
    assert torch.equal(lstm.weight_hh_l0, w32.to(torch.bfloat16).float())
    with torch.no_grad():
        out = net(torch.from_numpy(_mag(6, 1, 2, 65, 192)).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16 and bool(torch.isfinite(out.float()).all())


@pytest.mark.parametrize("nout,params_m,values_m,arch", [(64, 55.98, 56.03, 218409),
                                                         (32, 14.64, 14.66, 56817)])
def test_full_width_v51_widths_and_size_key(nout, params_m, values_m, arch):
    """The two published v5.1 widths (nout_lstm 128 over the 896-bin
    ``4band_v4_ms_fullband`` geometry), built on the meta device from the
    oracle's shapes: trainable parameters, state-dict values (BatchNorm's
    running statistics included), and the architecture key that the state
    dict's size in KB selects."""
    with torch.device("meta"):
        shapes = CascadedNetOracle(1792, nout, 128).state_dict()
        net = build_vr_net(shapes, 1792, arch=arch, is_v51=True, offset=64)
    n_params = sum(p.numel() for p in net.parameters())
    assert round(n_params / 1e6, 2) == params_m
    assert round(sum(v.numel() for v in shapes.values()) / 1e6, 2) == values_m
    state_kb = sum(v.numel() * v.element_size() for v in shapes.values()) / 1024
    assert min(NN_ARCH_SIZES, key=lambda s: abs(s - math.ceil(state_kb))) == arch
    # the LSTM runs over the bins of its stage's band: half of the 896 in the
    # low and high band nets, all of them in the full band net
    for stage, bins, hidden in (("stg1_low_band_net.0", 224, 64),
                                ("stg1_high_band_net", 224, 32),
                                ("stg3_full_band_net", 448, 64)):
        lstm = net.get_submodule(f"{stage}.lstm_dec2.lstm")
        assert (lstm.input_size, lstm.hidden_size, lstm.bidirectional) == (bins, hidden, True)
