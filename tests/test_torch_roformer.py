"""The port's RoFormer: checkpoint conversion and ``load_jax_params`` on a
torch-oracle state dict, the module against the JAX ``apply_roformer`` and
the oracle, and the shared layout helpers.

Tolerance for whole forwards: atol 3e-4 · max|ref| (tests/test_roformer.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_separator_tpu.models import convert as jax_convert
from audio_separator_tpu.models import init_params as jax_init
from audio_separator_tpu.models import roformer as jax_roformer
from audio_separator_tpu.models.melbands import mel_band_membership
from audio_separator_tpu_torch.models import convert, init_params, roformer
from audio_separator_tpu_torch.parallel import mesh
from audio_separator_tpu_torch.utils import tracing

from torch_oracles.roformer_oracle import RoformerOracle

CONFIGS = {
    "bs": dict(kind="bs", dim=64, depth=2, stereo=True, num_stems=2,
               time_transformer_depth=1, freq_transformer_depth=1,
               freqs_per_bands=(2, 2, 4, 8, 16, 32, 64, 129), dim_head=16, heads=4,
               stft_n_fft=512, stft_hop_length=128, stft_win_length=512,
               mask_estimator_depth=2),
    "bs_linear": dict(kind="bs", dim=64, depth=2, stereo=True, num_stems=1,
                      time_transformer_depth=1, freq_transformer_depth=1,
                      linear_transformer_depth=1,
                      freqs_per_bands=(2, 2, 4, 8, 16, 32, 64, 129), dim_head=16,
                      heads=4, stft_n_fft=512, stft_hop_length=128,
                      stft_win_length=512, mask_estimator_depth=2),
    "mel": dict(kind="mel", dim=48, depth=2, stereo=True, num_stems=1,
                time_transformer_depth=1, freq_transformer_depth=1, num_bands=24,
                sample_rate=44100, dim_head=16, heads=4, stft_n_fft=512,
                stft_hop_length=128, stft_win_length=512, mask_estimator_depth=1),
}


def _band_bins(cfg):
    if cfg.kind == "bs":
        bins, start = [], 0
        for nf in cfg.freqs_per_bands:
            bins.append(list(range(start, start + nf)))
            start += nf
        return bins
    member, _, _, _ = mel_band_membership(cfg.sample_rate, cfg.stft_n_fft, cfg.num_bands)
    return [list(np.nonzero(member[i])[0]) for i in range(cfg.num_bands)]


def _oracle(cfg, seed=0):
    torch.manual_seed(seed)
    oracle = RoformerOracle(
        kind=cfg.kind, band_bins=_band_bins(cfg), dim=cfg.dim, depth=cfg.depth,
        heads=cfg.heads, dim_head=cfg.dim_head, stereo=cfg.stereo,
        num_stems=cfg.num_stems, t_depth=cfg.time_transformer_depth,
        f_depth=cfg.freq_transformer_depth, n_fft=cfg.stft_n_fft,
        hop=cfg.stft_hop_length, mask_depth=cfg.mask_estimator_depth,
        mult=cfg.mlp_expansion_factor, lin_depth=cfg.linear_transformer_depth,
    ).eval()
    with torch.no_grad():
        for p in oracle.parameters():
            p.copy_(torch.randn_like(p) * 0.2)
    return oracle


def _audio(seed=1, length=16384):
    return np.random.default_rng(seed).standard_normal((2, 2, length)).astype(np.float32) * 0.3


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_convert_matches_jax_and_loads_into_module(name):
    cfg = roformer.RoformerConfig(**CONFIGS[name])
    sd = {k: v.numpy() for k, v in _oracle(cfg).state_dict().items()}
    tree = convert.convert_roformer(sd, cfg)
    jax_tree = jax_convert.convert_roformer(sd, jax_roformer.RoformerConfig(**CONFIGS[name]))
    got, want = convert.flatten_tree(tree), convert.flatten_tree(jax_tree)
    assert got.keys() == want.keys()
    for key in got:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    module = convert.load_jax_params(roformer.Roformer(cfg), tree)
    state = module.state_dict()
    for key, value in got.items():
        np.testing.assert_array_equal(state[key].numpy(), value, err_msg=key)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_module_matches_torch_oracle(name):
    """Checkpoint path end to end: upstream state dict → convert_roformer →
    load_jax_params → forward, against the upstream-layout oracle."""
    cfg = roformer.RoformerConfig(**CONFIGS[name])
    oracle = _oracle(cfg)
    sd = {k: v.numpy() for k, v in oracle.state_dict().items()}
    module = convert.load_jax_params(roformer.Roformer(cfg), convert.convert_roformer(sd, cfg))
    audio = _audio()
    with torch.no_grad():
        want = oracle(torch.from_numpy(audio)).numpy()
    got = module(torch.from_numpy(audio)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=3e-4 * max(np.abs(want).max(), 1e-3), rtol=0)


@pytest.mark.parametrize("name", ["bs", "mel"])
def test_module_matches_jax_apply_roformer(name):
    """Same seeded parameter tree through both packages: the port pads tokens
    to 64 and masks keys past the real length (the fused blocks' contract),
    the JAX package on the CPU runs its unfused ops without padding."""
    cfg = roformer.RoformerConfig(**CONFIGS[name])
    tree = init_params.init_roformer_params(cfg, seed=4, scale=0.2)
    module = convert.load_jax_params(roformer.Roformer(cfg), tree)
    audio = _audio(seed=5, length=8192)
    got = module(torch.from_numpy(audio)).numpy()
    jcfg = jax_roformer.RoformerConfig(**CONFIGS[name])
    # XLA's backend optimisation level changes how fast the CPU program is
    # built, not what it computes: level 0 keeps this test to seconds.
    apply = jax.jit(lambda p, a: jax_roformer.apply_roformer(p, jcfg, a))
    compiled = apply.lower(tree, jnp.asarray(audio)).compile(
        {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True})
    want = np.asarray(compiled(tree, jnp.asarray(audio)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=3e-4 * max(np.abs(want).max(), 1e-3), rtol=0)


def test_load_jax_params_rejects_mismatched_tree():
    cfg = roformer.RoformerConfig(**CONFIGS["bs"])
    tree = init_params.init_roformer_params(cfg)
    module = roformer.Roformer(cfg)
    bad_shape = dict(tree, band_split=dict(tree["band_split"], b=np.zeros((3, 3), np.float32)))
    with pytest.raises(ValueError, match="shape"):
        convert.load_jax_params(module, bad_shape)
    missing = {k: v for k, v in tree.items() if k != "final_norm"}
    with pytest.raises(ValueError, match="missing"):
        convert.load_jax_params(module, missing)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_init_params_match_jax(name):
    got = convert.flatten_tree(init_params.init_roformer_params(
        roformer.RoformerConfig(**CONFIGS[name]), seed=7))
    want = convert.flatten_tree(jax_init.init_roformer_params(
        jax_roformer.RoformerConfig(**CONFIGS[name]), seed=7))
    assert got.keys() == want.keys()
    for key in got:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_flagship_config_and_layout_match_jax():
    cfg, jcfg = init_params.flagship_config(), jax_init.flagship_config()
    assert init_params.FLAGSHIP_FREQS_PER_BANDS == jax_init.FLAGSHIP_FREQS_PER_BANDS
    assert {f: getattr(cfg, f) for f in cfg.__dataclass_fields__} == \
        {f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__}
    for kw in (CONFIGS["mel"], {**CONFIGS["mel"], "num_bands": 60, "stft_n_fft": 2048}):
        a = roformer.band_layout(roformer.RoformerConfig(**kw))
        b = jax_roformer.band_layout(jax_roformer.RoformerConfig(**kw))
        assert a.runs == b.runs and a.n_feat == b.n_feat
        np.testing.assert_array_equal(a.starts, b.starts)
        np.testing.assert_array_equal(a.denom, b.denom)
    layout = roformer.band_layout(cfg)
    assert layout.n_bands == 62 and layout.n_feat == 1025 * 2 * 2


def test_rope_tables_match_jax():
    for n, dh in ((801, 64), (62, 64), (9, 16)):
        cos, sin = roformer._rope_tables(n, dh)
        jcos, jsin = jax_roformer._rope_tables(n, dh)
        np.testing.assert_array_equal(cos.numpy(), np.asarray(jcos))
        np.testing.assert_array_equal(sin.numpy(), np.asarray(jsin))


BAND_SPANS = ("kernel.band_split", "kernel.mask_estimate", "kernel.band_merge")


def test_blocks_and_band_spans_keep_the_seams_the_benchmark_probes(monkeypatch):
    """The roofline probes wrap the module globals ``fused_attention_block``
    and ``fused_ff_block`` (``benchmark/metrics/b1_roofline.py``,
    ``b2_roofline.py``) and the band metrics read the band spans' records
    (``benchmark/counts/bands.py``). Every softmax layer calls the blocks
    there: whole unsharded, partial once a shard at tp 2 (its heads and
    widths); every forward leaves one record of each band span."""
    cfg = roformer.RoformerConfig(**CONFIGS["bs"])
    model = convert.load_jax_params(roformer.Roformer(cfg), init_params.init_roformer_params(cfg))
    calls = []
    attention, ff = roformer.fused_attention_block, roformer.fused_ff_block

    def attention_probe(x, wqkv, gate_w, gate_b, wo, attn_norm, rope, heads, n_valid, **kw):
        calls.append(("attention", kw.get("partial", False), heads, wqkv.shape[-1], wo.shape[0]))
        return attention(x, wqkv, gate_w, gate_b, wo, attn_norm, rope, heads, n_valid=n_valid,
                         **kw)

    def ff_probe(x, ff_norm, w1, b1, w2, b2, **kw):
        calls.append(("ff", kw.get("partial", False), b2 is not None, w1.shape[-1], w2.shape[0]))
        return ff(x, ff_norm, w1, b1, w2, b2, **kw)

    monkeypatch.setattr(roformer, "fused_attention_block", attention_probe)
    monkeypatch.setattr(roformer, "fused_ff_block", ff_probe)
    layout = roformer.band_layout(cfg)
    counts = dict(batch=2, bands=layout.n_bands, runs=len(layout.runs),
                  hidden_layers=cfg.mask_estimator_depth - 1, features=layout.features)
    layers = cfg.depth * (cfg.time_transformer_depth + cfg.freq_transformer_depth)
    qkv, hidden = 3 * cfg.heads * cfg.dim_head, cfg.dim * cfg.mlp_expansion_factor

    def expected(tp):  # each call's (block, partial, heads or b2, widths)
        return ([("attention", tp > 1, cfg.heads // tp, qkv // tp, qkv // 3 // tp)] * layers * tp
                + [("ff", tp > 1, tp == 1, hidden // tp, hidden // tp)] * layers * tp)

    tp2 = mesh.shard_roformer_params(model, mesh.make_mesh(devices=[torch.device("cpu")] * 2,
                                                           tp=2))
    tracing.clear()
    tracing.enable()
    try:
        for module, tp in ((model, 1), (tp2, 2)):
            calls.clear()
            tracing.clear()
            with torch.no_grad():
                module(torch.from_numpy(_audio(length=8192)))
            assert sorted(calls) == sorted(expected(tp))
            records = [r for r in tracing.records() if r.name in BAND_SPANS]
            assert sorted(r.name for r in records) == sorted(BAND_SPANS)
            for r in records:
                assert {k: v for k, v in r.attrs.items() if k != "frames"} == counts, r.name
                assert r.attrs["frames"] == 8192 // cfg.stft_hop_length + 1
    finally:
        tracing.disable()
        tracing.clear()
