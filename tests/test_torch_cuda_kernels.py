"""The port's CUDA kernels against their plain PyTorch versions, and the
models that run them against the CPU, on a CUDA card. Each test decides inside its fixture whether a card is present and
skips without one. Run on the card with

    python -m pytest tests/test_torch_cuda_kernels.py --noconftest -q

(``--noconftest``: tests/conftest.py imports JAX, which the port does not need.)

Tolerances (relative to the reference's largest magnitude) are those of
chip_smoke.py: float32 1e-4 max / 1e-5 mean (the whole-sequence attention
across its shapes), and 1e-5 max / 1e-6 mean for the RoFormer blocks, whose
float32 products run as 3xTF32 on the tensor cores (a term good to about 2⁻²¹,
float32 sums: the float32 level), and for both attention launches' float32
routes by themselves; bf16 four bf16 steps max (4·2⁻⁸) and a quarter step
mean."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from audio_separator_tpu_torch.models.roformer import _rope_tables
from audio_separator_tpu_torch.ops import attention as att
from audio_separator_tpu_torch.ops import attention_block as ab
from audio_separator_tpu_torch.ops.tf32 import prepare_tf32_weight

pytestmark = pytest.mark.gpu

TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (4 * 2.0 ** -8, 2.0 ** -10)}
# The fused RoFormer blocks: float32 through the 3xTF32 products.
BLOCK_TOL = {**TOL, torch.float32: (1e-5, 1e-6)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype, tol=TOL):
    diff = (got.float() - want.float()).abs()
    scale = float(want.float().abs().max())
    tmax, tmean = tol[dtype]
    assert float(diff.max()) <= tmax * scale, (float(diff.max()), scale)
    assert float(diff.mean()) <= tmean * scale, (float(diff.mean()), scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n_valid,rope", [(16, 801, True), (96, 62, True), (8, 130, False),
                                            (4, 64, True), (3, 1, True), (2, 832, True),
                                            (5, 1, False), (1, 192, False)])
def test_attention_kernel_matches_plain(cuda, dtype, b, n_valid, rope):
    d, h, dh = 512, 8, 64
    n_pad = -(-n_valid // 64) * 64
    g = torch.Generator(device=cuda).manual_seed(0)

    def randn(*shape, s=1.0):
        return (torch.randn(*shape, generator=g, device=cuda) * s).to(dtype)

    x = randn(b, n_pad, d)
    x[:, n_valid:] = 0
    w = dict(wqkv=randn(d, 3 * h * dh, s=0.05), gate_w=randn(d, h, s=0.05),
             gate_b=randn(h, s=0.05), wo=randn(h * dh, d, s=0.05),
             attn_norm=(1 + randn(d, s=0.1).float()).to(dtype))
    tables = None
    if rope:
        cos, sin = _rope_tables(n_valid, dh, dtype, cuda)
        tables = (F.pad(cos, (0, 0, 0, n_pad - n_valid)), F.pad(sin, (0, 0, 0, n_pad - n_valid)))
    before = ab.LAUNCHES["fused_attention_block"]
    got = ab.fused_attention_block(x, rope=tables, heads=h, n_valid=n_valid, **w)
    torch.cuda.synchronize()
    assert ab.LAUNCHES["fused_attention_block"] == before + 1
    want = ab.fused_attention_block_ref(x, rope=tables, heads=h, n_valid=n_valid, **w)
    _close(got[:, :n_valid], want[:, :n_valid], dtype, BLOCK_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n_pad,hidden,d", [(16, 832, 2048, 512), (96, 64, 2048, 512),
                                              (3, 64, 2048, 512), (3, 64, 256, 512),
                                              (5, 128, 4096, 512), (3, 64, 256, 64)])
def test_ff_kernel_matches_plain(cuda, dtype, b, n_pad, hidden, d):
    """Row counts that are no multiple of the kernels' row tiles (3·64, 5·128),
    hidden widths of one column tile and of sixteen, and products 64, 256,
    512, 2048 and 4096 deep."""
    g = torch.Generator(device=cuda).manual_seed(1)

    def randn(*shape, s=1.0):
        return (torch.randn(*shape, generator=g, device=cuda) * s).to(dtype)

    x = randn(b, n_pad, d)
    w = dict(ff_norm=(1 + randn(d, s=0.1).float()).to(dtype), w1=randn(d, hidden, s=0.05),
             b1=randn(hidden, s=0.05), w2=randn(hidden, d, s=0.05), b2=randn(d, s=0.05))
    before = ab.LAUNCHES["fused_ff_block"]
    got = ab.fused_ff_block(x, **w)
    torch.cuda.synchronize()
    assert ab.LAUNCHES["fused_ff_block"] == before + 1
    _close(got, ab.fused_ff_block_ref(x, **w), dtype, BLOCK_TOL)


# HTDemucs at full width (time and frequency branch), a ragged small shape
# with a padded head dimension, D = 48 (HTDemucs without bottom_channels),
# a 128-wide head, a single short tile; then N below one key tile, N one past
# a tile, a 128-wide head over several tiles, and a single (batch, head).
WHOLE_SEQ_SHAPES = [(4, 8, 1344, 64), (4, 8, 2688, 64), (2, 4, 173, 8), (2, 8, 336, 48),
                    (1, 2, 200, 128), (3, 2, 5, 64), (2, 2, 1, 64), (2, 3, 17, 64),
                    (1, 2, 63, 64), (2, 2, 65, 64), (1, 2, 129, 64), (1, 2, 2689, 64),
                    (2, 2, 700, 128), (1, 1, 300, 64), (1, 1, 130, 48),
                    # at most 64 rows: the one-warpgroup blocks, two to an SM
                    (40, 8, 64, 64), (2, 3, 64, 128), (1, 1, 33, 128)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", WHOLE_SEQ_SHAPES)
@pytest.mark.parametrize("scale", [None, 0.3])
def test_whole_sequence_attention_kernel_matches_plain(cuda, dtype, shape, scale):
    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = ((torch.randn(*shape, generator=g, device=cuda) * 0.7).to(dtype)
               for _ in range(3))
    before = att.LAUNCHES["fused_attention"]
    got = att.dot_product_attention(q, k, v, scale)
    torch.cuda.synchronize()
    assert att.LAUNCHES["fused_attention"] == before + 1
    assert got.shape == q.shape and got.dtype == dtype
    want = att.attention_ref(q, k, v, scale if scale is not None else shape[-1] ** -0.5)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_are_deterministic(cuda, dtype):
    """The same call twice gives bit-identical results: nothing in the
    producer / consumer pipelines races."""
    g = torch.Generator(device=cuda).manual_seed(8)

    def randn(*shape, s=1.0):
        return (torch.randn(*shape, generator=g, device=cuda) * s).to(dtype)

    q, k, v = (randn(2, 4, 777, 64, s=0.7) for _ in range(3))
    first = att.dot_product_attention(q, k, v)
    assert torch.equal(first, att.dot_product_attention(q, k, v))

    d, h, dh, hidden, n_valid, n_pad = 512, 8, 64, 2048, 801, 832
    x = randn(6, n_pad, d)
    ff = dict(ff_norm=(1 + randn(d, s=0.1).float()).to(dtype), w1=randn(d, hidden, s=0.05),
              b1=randn(hidden, s=0.05), w2=randn(hidden, d, s=0.05), b2=randn(d, s=0.05))
    first = ab.fused_ff_block(x, **ff)
    assert torch.equal(first, ab.fused_ff_block(x, **ff))
    w = dict(wqkv=randn(d, 3 * h * dh, s=0.05), gate_w=randn(d, h, s=0.05),
             gate_b=randn(h, s=0.05), wo=randn(h * dh, d, s=0.05),
             attn_norm=(1 + randn(d, s=0.1).float()).to(dtype))
    cos, sin = _rope_tables(n_valid, dh, dtype, cuda)
    tables = (F.pad(cos, (0, 0, 0, n_pad - n_valid)), F.pad(sin, (0, 0, 0, n_pad - n_valid)))
    first = ab.fused_attention_block(x, rope=tables, heads=h, n_valid=n_valid, **w)
    again = ab.fused_attention_block(x, rope=tables, heads=h, n_valid=n_valid, **w)
    assert torch.equal(first, again)


def test_attention_block_with_a_head_count_that_is_no_multiple_of_eight(cuda):
    """The norm launch keeps gate_w in shared memory with zero columns up to a
    power of two (here 2 heads, a QKV product 384 columns wide)."""
    d, h, dh = 256, 2, 64
    g = torch.Generator(device=cuda).manual_seed(9)
    for dtype in (torch.float32, torch.bfloat16):
        def randn(*shape, s=1.0):
            return (torch.randn(*shape, generator=g, device=cuda) * s).to(dtype)

        x = randn(3, 64, d)
        w = dict(wqkv=randn(d, 3 * h * dh, s=0.05), gate_w=randn(d, h, s=0.05),
                 gate_b=randn(h, s=0.05), wo=randn(h * dh, d, s=0.05),
                 attn_norm=(1 + randn(d, s=0.1).float()).to(dtype))
        got = ab.fused_attention_block(x, rope=None, heads=h, n_valid=50, **w)
        want = ab.fused_attention_block_ref(x, rope=None, heads=h, n_valid=50, **w)
        _close(got[:, :50], want[:, :50], dtype, BLOCK_TOL)


def _block_weights(g, cuda, dtype, d, h, dh=64):
    def randn(*shape, s=1.0):
        return (torch.randn(*shape, generator=g, device=cuda) * s).to(dtype)

    return dict(wqkv=randn(d, 3 * h * dh, s=0.05), gate_w=randn(d, h, s=0.05),
                gate_b=randn(h, s=0.05), wo=randn(h * dh, d, s=0.05),
                attn_norm=(1 + randn(d, s=0.1).float()).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,rope", [(3, True), (1, False), (5, True)])
def test_attention_block_with_odd_head_counts(cuda, dtype, h, rope):
    """An odd head count: the QKV product (192·h columns) ends inside a column
    tile and its head boxes straddle q, k and v; one head makes the output
    projection 64 deep."""
    d, n_valid, n_pad = 256, 100, 128
    g = torch.Generator(device=cuda).manual_seed(10 + h)
    x = (torch.randn(3, n_pad, d, generator=g, device=cuda)).to(dtype)
    x[:, n_valid:] = 0
    w = _block_weights(g, cuda, dtype, d, h)
    tables = None
    if rope:
        cos, sin = _rope_tables(n_valid, 64, dtype, cuda)
        tables = (F.pad(cos, (0, 0, 0, n_pad - n_valid)), F.pad(sin, (0, 0, 0, n_pad - n_valid)))
    got = ab.fused_attention_block(x, rope=tables, heads=h, n_valid=n_valid, **w)
    want = ab.fused_attention_block_ref(x, rope=tables, heads=h, n_valid=n_valid, **w)
    _close(got[:, :n_valid], want[:, :n_valid], dtype, BLOCK_TOL)


def test_prepared_float32_forms_are_reused_across_calls(cuda):
    """The forms a model keeps give the same result as forms made for the
    call, call after call, and a form of the wrong shape is refused."""
    d, h, hidden, n_valid, n_pad = 512, 8, 2048, 62, 64
    g = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn(40, n_pad, d, generator=g, device=cuda)
    x[:, n_valid:] = 0
    w = _block_weights(g, cuda, torch.float32, d, h)
    cos, sin = _rope_tables(n_valid, 64, torch.float32, cuda)
    tables = (F.pad(cos, (0, 0, 0, n_pad - n_valid)), F.pad(sin, (0, 0, 0, n_pad - n_valid)))
    forms = (prepare_tf32_weight(w["wqkv"]), prepare_tf32_weight(w["wo"]))
    made = ab.fused_attention_block(x, rope=tables, heads=h, n_valid=n_valid, **w)
    for _ in range(2):
        kept = ab.fused_attention_block(x, rope=tables, heads=h, n_valid=n_valid,
                                        tf32_weights=forms, **w)
        assert torch.equal(kept, made)
    ff = dict(ff_norm=torch.ones(d, device=cuda),
              w1=torch.randn(d, hidden, generator=g, device=cuda) * 0.05,
              b1=torch.zeros(hidden, device=cuda),
              w2=torch.randn(hidden, d, generator=g, device=cuda) * 0.05,
              b2=torch.zeros(d, device=cuda))
    ff_forms = (prepare_tf32_weight(ff["w1"]), prepare_tf32_weight(ff["w2"]))
    assert torch.equal(ab.fused_ff_block(x, tf32_weights=ff_forms, **ff),
                       ab.fused_ff_block(x, **ff))
    with pytest.raises(ValueError, match="prepared weight form"):
        ab.fused_ff_block(x, tf32_weights=ff_forms[::-1], **ff)


@pytest.mark.parametrize("axis", ["time", "freq"])
def test_float32_blocks_at_the_flagship_shapes(cuda, axis):
    """Both blocks in float32 at the flagship BS-RoFormer's shapes (4 windows:
    62 sequences of 801 -> 832 tokens, or 801 of 62 -> 64), within 1e-5 of the
    output scale of their float32 plain versions."""
    b, n_valid = {"time": (4 * 62, 801), "freq": (4 * 801, 62)}[axis]
    d, h, hidden = 512, 8, 2048
    n_pad = -(-n_valid // 64) * 64
    g = torch.Generator(device=cuda).manual_seed(12)
    x = torch.randn(b, n_pad, d, generator=g, device=cuda)
    x[:, n_valid:] = 0
    w = _block_weights(g, cuda, torch.float32, d, h)
    cos, sin = _rope_tables(n_valid, 64, torch.float32, cuda)
    tables = (F.pad(cos, (0, 0, 0, n_pad - n_valid)), F.pad(sin, (0, 0, 0, n_pad - n_valid)))
    got = ab.fused_attention_block(x, rope=tables, heads=h, n_valid=n_valid, **w)
    want = ab.fused_attention_block_ref(x, rope=tables, heads=h, n_valid=n_valid, **w)
    _close(got[:, :n_valid], want[:, :n_valid], torch.float32, BLOCK_TOL)
    del got, want
    ff = dict(ff_norm=(1 + 0.1 * torch.randn(d, generator=g, device=cuda)),
              w1=torch.randn(d, hidden, generator=g, device=cuda) * 0.05,
              b1=torch.randn(hidden, generator=g, device=cuda) * 0.05,
              w2=torch.randn(hidden, d, generator=g, device=cuda) * 0.05,
              b2=torch.randn(d, generator=g, device=cuda) * 0.05)
    _close(ab.fused_ff_block(x, **ff), ab.fused_ff_block_ref(x, **ff), torch.float32, BLOCK_TOL)


# The 3xTF32 flash route (flash_tf32x3_kernel) in the attention block: B1's
# time axis at the BS-RoFormer (d 512) and Mel-Band (d 384) widths, 801 of 832
# rows, and key counts at the tile edges (65, 127), one short of the padded
# length (800) and all of it (832).
@pytest.mark.parametrize("d,b,n_valid", [(512, 248, 801), (384, 248, 801), (512, 16, 65),
                                         (512, 16, 127), (512, 16, 800), (512, 16, 832)])
def test_tf32x3_flash_route_in_the_attention_block(cuda, d, b, n_valid):
    """Within 1e-5 of the output scale of the float32 plain version, the same
    bits twice, and both launches counted on the route."""
    n_pad = -(-n_valid // 64) * 64
    g = torch.Generator(device=cuda).manual_seed(23)
    x = torch.randn(b, n_pad, d, generator=g, device=cuda)
    x[:, n_valid:] = 0
    w = _block_weights(g, cuda, torch.float32, d, 8)
    cos, sin = _rope_tables(n_valid, 64, torch.float32, cuda)
    tables = (F.pad(cos, (0, 0, 0, n_pad - n_valid)), F.pad(sin, (0, 0, 0, n_pad - n_valid)))
    forms = (prepare_tf32_weight(w["wqkv"]), prepare_tf32_weight(w["wo"]))
    before = dict(ab.LAUNCHES)
    got = ab.fused_attention_block(x, rope=tables, heads=8, n_valid=n_valid, tf32_weights=forms,
                                   **w)
    again = ab.fused_attention_block(x, rope=tables, heads=8, n_valid=n_valid,
                                     tf32_weights=forms, **w)
    torch.cuda.synchronize()
    assert ab.LAUNCHES["flash_tf32x3"] == before["flash_tf32x3"] + 2
    assert ab.LAUNCHES["flash_fma"] == before["flash_fma"]
    assert torch.equal(got, again)
    want = ab.fused_attention_block_ref(x, rope=tables, heads=8, n_valid=n_valid, **w)
    _close(got[:, :n_valid], want[:, :n_valid], torch.float32, BLOCK_TOL)


# B3 at HTDemucs's two branches and at short ragged lengths on the 3xTF32
# route; 64 rows and a 128-wide head stay on the FMA route.
@pytest.mark.parametrize("shape,route", [((4, 8, 1344, 64), "flash_tf32x3"),
                                         ((4, 8, 2688, 64), "flash_tf32x3"),
                                         ((2, 2, 65, 64), "flash_tf32x3"),
                                         ((1, 3, 127, 64), "flash_tf32x3"),
                                         ((2, 3, 300, 48), "flash_tf32x3"),
                                         ((40, 8, 64, 64), "flash_fma"),
                                         ((2, 2, 700, 128), "flash_fma")])
def test_float32_whole_sequence_attention_routes(cuda, shape, route):
    """Within 1e-5 of the output scale (the float32 level, as the blocks are
    held) on both routes, the same bits twice, each launch counted on its
    route."""
    g = torch.Generator(device=cuda).manual_seed(29)
    q, k, v = (torch.randn(*shape, generator=g, device=cuda) * 0.7 for _ in range(3))
    before = dict(att.LAUNCHES)
    got = att.dot_product_attention(q, k, v)
    again = att.dot_product_attention(q, k, v)
    torch.cuda.synchronize()
    for r in att.FLASH_ROUTES:
        assert att.LAUNCHES[r] == before[r] + 2 * (r == route)
    assert torch.equal(got, again)
    _close(got, att.attention_ref(q, k, v, shape[-1] ** -0.5), torch.float32, BLOCK_TOL)


def test_cuda_wrappers_reject_misaligned_operands(cuda):
    """TMA and the vector loads need 16-byte aligned operands: a view that
    starts 4 bytes into a buffer raises before any launch."""
    buf = torch.zeros(1 * 2 * 32 * 64 + 1, device=cuda)
    q = buf[1:].view(1, 2, 32, 64)
    before = dict(att.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte"):
        att.fused_attention(q, q, q, 0.125)
    assert att.LAUNCHES == before


def test_whole_sequence_attention_takes_strided_heads(cuda):
    """The model hands over (B, N, H, D) projections viewed as (B, H, N, D)."""
    g = torch.Generator(device=cuda).manual_seed(6)
    q, k, v = (torch.randn(2, 100, 4, 64, generator=g, device=cuda).transpose(1, 2)
               for _ in range(3))
    got = att.dot_product_attention(q, k, v)
    _close(got, att.attention_ref(q, k, v, 0.125), torch.float32)


def test_whole_sequence_attention_rejects_what_the_kernel_cannot_take(cuda):
    q = torch.zeros(1, 2, 32, 64, device=cuda)
    with pytest.raises(ValueError, match="one shape"):
        att.dot_product_attention(q, q[:, :, :16], q[:, :, :16])
    wide = torch.zeros(1, 2, 32, 136, device=cuda)
    with pytest.raises(ValueError, match="head dimension"):
        att.dot_product_attention(wide, wide, wide)
    with pytest.raises(TypeError):
        att.dot_product_attention(q.half(), q.half(), q.half())


def test_cuda_wrappers_reject_shapes_outside_the_tiling(cuda):
    x = torch.zeros(2, 64, 64, device=cuda)
    with pytest.raises(ValueError, match="dim_head"):
        ab.fused_attention_block(
            x, torch.zeros(64, 3 * 4 * 16, device=cuda), torch.zeros(64, 4, device=cuda),
            torch.zeros(4, device=cuda), torch.zeros(64, 64, device=cuda),
            torch.ones(64, device=cuda), None, 4, n_valid=64)


def test_model_forward_on_card_matches_cpu(cuda):
    """A small BS-RoFormer (d 512, one block) through the kernels vs the same
    module on the CPU: ≥ 40 dB SDR, one launch of each kernel per layer."""
    from audio_separator_tpu_torch.models.convert import load_jax_params
    from audio_separator_tpu_torch.models.init_params import init_roformer_params
    from audio_separator_tpu_torch.models.roformer import Roformer, RoformerConfig

    cfg = RoformerConfig(kind="bs", dim=512, depth=1, stereo=True, num_stems=1,
                         time_transformer_depth=1, freq_transformer_depth=1,
                         freqs_per_bands=(64, 64, 129), dim_head=64, heads=8,
                         stft_n_fft=512, stft_hop_length=128, stft_win_length=512,
                         mask_estimator_depth=2)
    tree = init_roformer_params(cfg, seed=2)
    audio = torch.from_numpy(
        (np.random.default_rng(3).standard_normal((2, 2, 16384)) * 0.2).astype(np.float32))
    want = load_jax_params(Roformer(cfg), tree)(audio)
    ab.reset_launch_counts()
    got = load_jax_params(Roformer(cfg), tree).to(cuda)(audio.to(cuda)).cpu()
    assert ab.LAUNCHES == {"fused_attention_block": 2, "fused_ff_block": 2,
                           "fused_attention_block_partial": 0, "fused_ff_block_partial": 0,
                           "fused_attention": 0, "attention_backward": 0,
                           "rmsnorm_backward": 0, "gelu_backward": 0,
                           "rope_gate_backward": 0, "attention_backward_bf16": 0,
                           "rmsnorm_backward_bf16": 0, "gelu_backward_bf16": 0,
                           "rope_gate_backward_bf16": 0, "group_norm": 0, "group_norm_split": 0,
                           # time axis 129 -> 192 frames, frequency axis 3 -> 64 bands
                           "flash_wgmma": 0, "flash_fma": 1, "flash_tf32x3": 1}
    sdr = 10 * np.log10(float((want ** 2).sum()) / float(((want - got) ** 2).sum()))
    assert sdr >= 40.0


def test_istft_on_card_matches_cpu(cuda):
    """A masked spectrum is not Hermitian at DC and Nyquist; the port's istft
    drops those imaginary parts on every backend, so cuFFT and the CPU FFT
    agree (the flagship window's shape: 4 × 1025 bins × 801 frames)."""
    from audio_separator_tpu_torch.ops.stft import hann_window, istft

    g = torch.Generator().manual_seed(4)
    spec = torch.complex(torch.randn(4, 1025, 801, generator=g),
                         torch.randn(4, 1025, 801, generator=g))
    win = hann_window(2048)
    want = istft(spec, 2048, 441, win)
    got = istft(spec.to(cuda), 2048, 441, win).cpu()
    sdr = 10 * np.log10(float((want ** 2).sum()) / float(((want - got) ** 2).sum()))
    assert sdr >= 100.0


def test_htdemucs_istft_on_card_matches_cpu(cuda):
    """The HTDemucs inverse pads one zero frequency row and two frames each
    side before the iSTFT; its DC row keeps an imaginary part that cuFFT's
    real inverse does not ignore for every plan, so the port's istft drops
    it. Full width: 4 sources x 2 channels, 2048 bins x 336 frames, n_fft 4096."""
    from audio_separator_tpu_torch.models.htdemucs import _model_ispec
    from audio_separator_tpu_torch.models.init_params import htdemucs_full_config

    cfg = htdemucs_full_config()
    g = torch.Generator().manual_seed(7)
    z = torch.complex(torch.randn(1, 4, 2, 2048, 336, generator=g),
                      torch.randn(1, 4, 2, 2048, 336, generator=g))
    want = _model_ispec(z, cfg.training_length, cfg)
    got = _model_ispec(z.to(cuda), cfg.training_length, cfg).cpu()
    assert got.shape == want.shape == (1, 4, 2, cfg.training_length)
    sdr = 10 * np.log10(float((want ** 2).sum()) / float(((want - got) ** 2).sum()))
    assert sdr >= 100.0


def test_htdemucs_forward_on_card_matches_cpu(cuda):
    """A narrow HTDemucs (head dimension 8, padded to the kernel's 64) through
    the attention kernel against the same module on the CPU."""
    from audio_separator_tpu_torch.models.convert import load_jax_htdemucs_params
    from audio_separator_tpu_torch.models.htdemucs import HTDemucs, HTDemucsConfig
    from audio_separator_tpu_torch.models.init_params import init_htdemucs_params

    cfg = HTDemucsConfig(sources=("drums", "bass", "other", "vocals"), channels=8, nfft=1024,
                         depth=3, t_layers=3, t_heads=4, segment=0.5)
    tree = init_htdemucs_params(cfg, seed=3)
    audio = torch.from_numpy(
        (np.random.default_rng(4).standard_normal((2, 2, cfg.training_length)) * 0.2
         ).astype(np.float32))
    want = load_jax_htdemucs_params(HTDemucs(cfg), tree).eval()(audio)
    att.reset_launch_counts()
    got = load_jax_htdemucs_params(HTDemucs(cfg), tree).to(cuda).eval()(audio.to(cuda)).cpu()
    assert att.LAUNCHES["fused_attention"] == 4  # layers 0 and 2, both branches
    # Two DConv depths of two norms on 3 + 3 encoder levels, and the output
    # norm of the 3 transformer layers on both branches.
    assert att.LAUNCHES["group_norm"] == 30
    sdr = 10 * np.log10(float((want ** 2).sum()) / float(((want - got) ** 2).sum()))
    assert sdr >= 40.0


def test_mdx_model_fn_on_card_matches_cpu(cuda, tmp_path):
    """The MDX model function (packed STFT, the ONNX Conv-TDF graph through
    ``models/onnx_torch``, iSTFT) at tests/test_mdx_integration.py's small
    geometry, on the card against the CPU: float32 at this file's float32
    tolerance, and no kernel launch (the MDX path runs none)."""
    import logging

    from audio_separator_tpu_torch.architectures.mdx import MDXSeparator

    from torch_oracles.convtdf_oracle import seeded_convtdf

    try:  # the onnx package is absent: skip the exporter's onnxscript pass
        from torch.onnx._internal.torchscript_exporter import onnx_proto_utils

        onnx_proto_utils._add_onnxscript_fn = lambda model_bytes, custom_opsets: model_bytes
    except ImportError:
        pass
    path = str(tmp_path / "convtdf.onnx")
    torch.onnx.export(seeded_convtdf(0, dim_f=128, num_blocks=5, g=8), torch.randn(1, 4, 128, 32),
                      path, input_names=["input"], output_names=["output"], dynamo=False)

    def separator(device):
        common = {"logger": logging.getLogger("test"), "model_name": "m", "model_path": path,
                  "model_data": {"compensate": 1.035, "mdx_dim_f_set": 128,
                                 "mdx_dim_t_set": 5, "mdx_n_fft_scale_set": 512},
                  "device": device}
        return MDXSeparator(common, {"hop_length": 128, "segment_size": 32})

    chunks = torch.from_numpy(
        (np.random.default_rng(5).standard_normal((4, 2, 128 * 31)) * 0.2).astype(np.float32))
    want = separator(torch.device("cpu"))._model_fn(False)(chunks)
    ab.reset_launch_counts()
    att.reset_launch_counts()
    got = separator(cuda)._model_fn(False)(chunks.to(cuda)).cpu()
    assert got.shape == want.shape == (4, 1, 2, 128 * 31)
    assert not any({**ab.LAUNCHES, **att.LAUNCHES}.values())
    _close(got, want, torch.float32)


# ------------------------------------------------------------------ backward
# The backward kernels (float32) against their plain versions on the card,
# and the three autograd Functions against autograd through the forward
# plain versions, at the slice's full-width shapes. Gradient tolerance: the
# float32 TOL (1e-4 max, 1e-5 mean of each gradient's scale); the Functions'
# forwards are the 3xTF32 kernels, good to 1e-5 of their outputs' scale, and
# the weight gradients sum over tens of thousands of tokens.

from audio_separator_tpu_torch.ops import _build  # noqa: E402
from audio_separator_tpu_torch.ops import block_backward as bb  # noqa: E402


def _counted(name):
    before = _build.LAUNCHES[name]
    return lambda: _build.LAUNCHES[name] - before


@pytest.mark.parametrize("shape,n_valid", [((2, 8, 1344, 64), None), ((2, 8, 2688, 64), None),
                                           ((2, 4, 173, 8), None), ((2, 4, 700, 128), None),
                                           ((3, 2, 130, 64), 77), ((4, 2, 64, 64), 62)])
def test_attention_backward_kernel_matches_plain(cuda, shape, n_valid):
    g = torch.Generator(device=cuda).manual_seed(21)
    q, k, v, do = (torch.randn(*shape, generator=g, device=cuda) * 0.7 for _ in range(4))
    scale = shape[-1] ** -0.5
    n_valid = n_valid or shape[2]
    o = att.attention_ref(q, k[:, :, :n_valid], v[:, :, :n_valid], scale)
    launched = _counted("attention_backward")
    got = att.attention_backward(q, k, v, o, do, scale, n_valid)
    torch.cuda.synchronize()
    assert launched() == 1
    want = att.attention_bwd_ref(q, k, v, o, do, scale, n_valid)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        _close(a, b, torch.float32)


@pytest.mark.parametrize("b,n_valid", [(16, 801), (96, 62)])
def test_gated_attention_backward_kernel_matches_plain(cuda, b, n_valid):
    """The attention block's layout: merged heads, their gradient and the gates."""
    h, n_pad = 8, -(-n_valid // 64) * 64
    g = torch.Generator(device=cuda).manual_seed(22)
    q, k, v = (torch.randn(b, h, n_pad, 64, generator=g, device=cuda) for _ in range(3))
    gates = torch.sigmoid(torch.randn(b, h, n_pad, generator=g, device=cuda))
    merged = torch.randn(b, n_pad, h * 64, generator=g, device=cuda)
    dm = torch.randn(b, n_pad, h * 64, generator=g, device=cuda)
    got = att.attention_backward(q, k, v, merged, dm, 0.125, n_valid, gates=gates)
    want = att.attention_bwd_ref(q, k, v, merged, dm, 0.125, n_valid, gates=gates)
    for a, w in zip(got, want):
        _close(a, w, torch.float32)


def _attention_bwd_case(cuda, seed, b, h, n, dh, gated, s=0.7):
    """Inputs of the attention backward in either layout; ``o`` None for the
    head-major layout (the caller passes the forward's output)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v = (torch.randn(b, h, n, dh, generator=g, device=cuda) * s for _ in range(3))
    if gated:
        gates = torch.sigmoid(torch.randn(b, h, n, generator=g, device=cuda))
        o, do = (torch.randn(b, n, h * dh, generator=g, device=cuda) for _ in range(2))
        return q, k, v, o, do, gates
    do = torch.randn(b, h, n, dh, generator=g, device=cuda)
    return q, k, v, None, do, None


# Both paths (one launch for n <= 64, two beyond) at and around the tile
# edges, both layouts: two calls give the same bits, and each output is
# within the float32 tolerance of the plain version. o is random here (the
# kernel takes any o): with a single valid key and the forward's own output,
# dS = P·(dO·v − Δ) is zero in exact arithmetic, and dq and dk are rounding
# noise in both versions, with no scale to hold them to.
@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("n,n_valid", [(64, 64), (64, 1), (64, 37), (65, 65), (65, 1),
                                       (129, 129), (129, 70), (300, 257)])
def test_attention_backward_kernel_is_deterministic_at_the_tile_edges(cuda, gated, n, n_valid):
    q, k, v, o, do, gates = _attention_bwd_case(cuda, 31 + n + n_valid, 2, 3, n, 64, gated)
    scale = 0.125
    if o is None:
        o = torch.randn_like(do)
    launched = _counted("attention_backward")
    first = att.attention_backward(q, k, v, o, do, scale, n_valid, gates=gates)
    second = att.attention_backward(q, k, v, o, do, scale, n_valid, gates=gates)
    torch.cuda.synchronize()
    assert launched() == 2
    want = att.attention_bwd_ref(q, k, v, o, do, scale, n_valid, gates=gates)
    for a, a2, w in zip(first, second, want):
        assert torch.equal(a, a2)
        _close(a, w, torch.float32)
    assert not first[1][:, :, n_valid:].any() and not first[2][:, :, n_valid:].any()


@pytest.mark.parametrize("n", [40, 64, 130])
@pytest.mark.parametrize("d", [8, 128])
def test_attention_backward_kernel_at_other_head_widths(cuda, n, d):
    """D 128 runs its own instance; D 8 is padded to 64 by the wrapper."""
    q, k, v, _, do, _ = _attention_bwd_case(cuda, 41 + n + d, 2, 2, n, d, False)
    scale = d ** -0.5
    o = att.attention_ref(q, k, v, scale)
    first = att.attention_backward(q, k, v, o, do, scale)
    second = att.attention_backward(q, k, v, o, do, scale)
    for a, a2, w in zip(first, second, att.attention_bwd_ref(q, k, v, o, do, scale)):
        assert a.shape == w.shape
        assert torch.equal(a, a2)
        _close(a, w, torch.float32)


@pytest.mark.parametrize("n,n_valid", [(64, 62), (832, 801)])
def test_attention_backward_kernel_with_scores_near_twenty(cuda, n, n_valid):
    """q and k scaled so that the scaled scores reach ±20: P is nearly one-hot
    in places, and the log-sum-exp the kernel recomputes must be exact to the
    float32 level."""
    q, k, v, o, do, gates = _attention_bwd_case(cuda, 51 + n, 2, 4, n, 64, True, s=2.2)
    s = torch.matmul(q, k.transpose(-1, -2))[..., :n_valid] * 0.125
    assert float(s.abs().max()) >= 15.0
    got = att.attention_backward(q, k, v, o, do, 0.125, n_valid, gates=gates)
    want = att.attention_bwd_ref(q, k, v, o, do, 0.125, n_valid, gates=gates)
    for a, w in zip(got, want):
        _close(a, w, torch.float32)


@pytest.mark.parametrize("rows,d,zero_rows", [(16 * 832, 512, 31), (96 * 64, 512, 2), (5, 64, 1)])
@pytest.mark.parametrize("residual", [True, False])
def test_rmsnorm_backward_kernel_matches_plain(cuda, rows, d, zero_rows, residual):
    g = torch.Generator(device=cuda).manual_seed(23)
    x, dxn, dres = (torch.randn(rows, d, generator=g, device=cuda) for _ in range(3))
    x[-zero_rows:] = 0  # padded tokens
    gamma = 1 + 0.1 * torch.randn(d, generator=g, device=cuda)
    launched = _counted("rmsnorm_backward")
    got = bb.rmsnorm_backward(x, gamma, dxn, dres if residual else None)
    torch.cuda.synchronize()
    assert launched() == 1
    want = bb.rmsnorm_bwd_ref(x, gamma, dxn, dres if residual else None)
    for a, w in zip(got, want):
        _close(a, w, torch.float32)


@pytest.mark.parametrize("rows,hidden", [(16 * 832, 2048), (7, 64)])
def test_gelu_backward_kernel_matches_plain(cuda, rows, hidden):
    g = torch.Generator(device=cuda).manual_seed(24)
    pre = torch.randn(rows, hidden, generator=g, device=cuda) * 2
    dh = torch.randn(rows, hidden, generator=g, device=cuda)
    launched = _counted("gelu_backward")
    got = bb.gelu_backward(pre, dh)
    torch.cuda.synchronize()
    assert launched() == 1
    for a, w in zip(got, bb.gelu_bwd_ref(pre, dh)):
        _close(a, w, torch.float32)


@pytest.mark.parametrize("b,n_pad,heads,rope", [(16, 832, 8, True), (96, 64, 8, True),
                                                (3, 128, 5, False)])
def test_rope_gate_backward_kernel_matches_plain(cuda, b, n_pad, heads, rope):
    g = torch.Generator(device=cuda).manual_seed(25)
    dq, dk, dv = (torch.randn(b, heads, n_pad, 64, generator=g, device=cuda) for _ in range(3))
    delta = torch.randn(b, heads, n_pad, generator=g, device=cuda)
    gates = torch.sigmoid(torch.randn(b, heads, n_pad, generator=g, device=cuda))
    tables = _rope_tables(n_pad, 64, torch.float32, cuda) if rope else None
    launched = _counted("rope_gate_backward")
    got = bb.rope_gate_backward(dq, dk, dv, delta, gates, tables)
    torch.cuda.synchronize()
    assert launched() == 1
    for a, w in zip(got, bb.rope_gate_bwd_ref(dq, dk, dv, delta, gates, tables)):
        assert a.shape == w.shape
        _close(a, w, torch.float32)


def _grads(out, inputs, dy):
    return torch.autograd.grad(out, inputs, dy)


@pytest.mark.parametrize("b,n_valid", [(16, 801), (96, 62)])
def test_block_functions_backward_match_plain_autograd(cuda, b, n_valid):
    """Every input's gradient of both blocks' autograd Functions (kernels
    forward and backward) against autograd through the plain versions."""
    d, h, hidden = 512, 8, 2048
    n_pad = -(-n_valid // 64) * 64
    g = torch.Generator(device=cuda).manual_seed(26)
    x = torch.randn(b, n_pad, d, generator=g, device=cuda)
    x[:, n_valid:] = 0
    dy = torch.randn(b, n_pad, d, generator=g, device=cuda)
    dy[:, n_valid:] = 0  # the model drops the padded tokens
    w = _block_weights(g, cuda, torch.float32, d, h)
    cos, sin = _rope_tables(n_valid, 64, torch.float32, cuda)
    tables = (F.pad(cos, (0, 0, 0, n_pad - n_valid)), F.pad(sin, (0, 0, 0, n_pad - n_valid)))
    ff = dict(ff_norm=(1 + 0.1 * torch.randn(d, generator=g, device=cuda)),
              w1=torch.randn(d, hidden, generator=g, device=cuda) * 0.05,
              b1=torch.randn(hidden, generator=g, device=cuda) * 0.05,
              w2=torch.randn(hidden, d, generator=g, device=cuda) * 0.05,
              b2=torch.randn(d, generator=g, device=cuda) * 0.05)
    xs = x.requires_grad_(True)
    for fn, ref, kw, block_weights in (
            (ab.fused_attention_block, ab.fused_attention_block_ref,
             dict(rope=tables, heads=h, n_valid=n_valid), w),
            (ab.fused_ff_block, ab.fused_ff_block_ref, {}, ff)):
        weights = {k: t.clone().requires_grad_(True) for k, t in block_weights.items()}
        names = list(weights)
        inputs = [xs, *weights.values()]
        _build.reset_launch_counts()
        got = _grads(fn(xs, **kw, **weights), inputs, dy)
        torch.cuda.synchronize()
        if fn is ab.fused_attention_block:
            assert {k: _build.LAUNCHES[k] for k in ("attention_backward", "rope_gate_backward",
                                                   "rmsnorm_backward")} == dict.fromkeys(
                ("attention_backward", "rope_gate_backward", "rmsnorm_backward"), 1)
        else:
            assert (_build.LAUNCHES["gelu_backward"], _build.LAUNCHES["rmsnorm_backward"]) == (1, 1)
        want = _grads(ref(xs, **kw, **weights), inputs, dy)
        for name, a, b_ in zip(["x", *names], got, want):
            _close(a[:, :n_valid] if name == "x" else a, b_[:, :n_valid] if name == "x" else b_,
                   torch.float32)
        del got, want


@pytest.mark.parametrize("shape", [(2, 8, 1344, 64), (2, 8, 2688, 64)])
def test_attention_function_backward_matches_plain_autograd(cuda, shape):
    g = torch.Generator(device=cuda).manual_seed(27)
    q, k, v = (torch.randn(*shape, generator=g, device=cuda).requires_grad_(True)
               for _ in range(3))
    do = torch.randn(*shape, generator=g, device=cuda)
    _build.reset_launch_counts()
    got = _grads(att.dot_product_attention(q, k, v), [q, k, v], do)
    assert (_build.LAUNCHES["fused_attention"], _build.LAUNCHES["attention_backward"]) == (1, 1)
    want = _grads(att.attention_ref(q, k, v, shape[-1] ** -0.5), [q, k, v], do)
    for a, b in zip(got, want):
        _close(a, b, torch.float32)


def test_backward_kernels_refuse_bf16(cuda):
    """The bf16 forms serve the RoFormer blocks; the whole-sequence attention's
    backward (HTDemucs training, float32 only in the JAX package) refuses
    bf16, naming ROADMAP C16."""
    x = torch.randn(4, 64, device=cuda, dtype=torch.bfloat16)
    launched = _counted("rmsnorm_backward_bf16")
    dx, _ = bb.rmsnorm_backward(x, torch.ones(64, device=cuda), x)
    assert dx.dtype == torch.bfloat16 and launched() == 1
    q = torch.randn(1, 1, 64, 64, device=cuda, dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(NotImplementedError, match="C16"):
        att.dot_product_attention(q, q, q).sum().backward()


# The bf16 forms of K1-K4 against their plain bf16 versions (the bf16
# tolerance: both sides round to bf16 at the same points, in other orders).

BF = torch.bfloat16


def _check_bf16_attention_backward(q, k, v, o, do, gates, n_valid):
    """Two calls of K1's bf16 form: the same bits, each output within the
    bf16 tolerance of the plain bf16 version, dk and dv zero past n_valid."""
    launched = _counted("attention_backward_bf16")
    first = att.attention_backward(q, k, v, o, do, 0.125, n_valid, gates=gates)
    second = att.attention_backward(q, k, v, o, do, 0.125, n_valid, gates=gates)
    torch.cuda.synchronize()
    assert launched() == 2
    want = att.attention_bwd_ref(q, k, v, o, do, 0.125, n_valid, gates=gates)
    for a, a2, w in zip(first, second, want):
        assert a.dtype == w.dtype and a.shape == w.shape
        assert torch.equal(a, a2)
        _close(a, w, BF)
    assert not first[1][:, :, n_valid:].any() and not first[2][:, :, n_valid:].any()


# n <= 64 runs one launch a sequence, longer sequences two launches on wgmma
# over blocks of 128 rows: the edges of both, ragged lengths, key blocks
# wholly or partly past n_valid, and the head counts of the sharded step
# (2 and 4 heads a shard).
@pytest.mark.parametrize("b,h,n,n_valid", [
    (16, 8, 832, 801), (96, 8, 64, 62), (2, 8, 64, 1), (2, 8, 33, 33), (2, 8, 64, 64),
    (2, 8, 65, 65), (2, 8, 129, 70), (2, 8, 300, 257), (2, 8, 300, 129), (3, 8, 128, 128),
    (2, 8, 450, 450), (4, 2, 832, 801), (4, 4, 832, 801), (24, 2, 64, 62), (24, 4, 64, 62),
    (3, 4, 129, 129)])
def test_gated_attention_backward_bf16_kernel_matches_plain(cuda, b, h, n, n_valid):
    q, k, v, o, do, gates = _attention_bwd_case(cuda, 61 + n + n_valid, b, h, n, 64, True)
    q, k, v, o, do = (t.to(BF) for t in (q, k, v, o, do))
    _check_bf16_attention_backward(q, k, v, o, do, gates, n_valid)


def _late_maximum_case(cuda, seed, b, h, n, n_valid):
    """Scaled scores that rise along the keys to about 20: every row's
    largest score lies in its last key tile, so the dQ launch's running
    maximum grows, and its sums are rescaled, at every tile."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    e = torch.full((64,), 0.125, device=cuda)  # a unit vector
    tiles = -(-n_valid // 64)
    ramp = 20.0 * (torch.arange(n, device=cuda).clamp(max=n_valid - 1) // 64 + 1) / tiles
    q = 0.05 * torch.randn(b, h, n, 64, generator=g, device=cuda) + 8.0 * e
    k = 0.05 * torch.randn(b, h, n, 64, generator=g, device=cuda) + ramp[:, None] * e
    v = torch.randn(b, h, n, 64, generator=g, device=cuda)
    gates = torch.sigmoid(torch.randn(b, h, n, generator=g, device=cuda))
    o, do = (torch.randn(b, n, h * 64, generator=g, device=cuda) for _ in range(2))
    return (*(t.to(BF) for t in (q, k, v, o, do)), gates)


@pytest.mark.parametrize("n,n_valid", [(832, 801), (300, 257), (64, 62)])
def test_attention_backward_bf16_kernel_with_the_maximum_in_the_last_tile(cuda, n, n_valid):
    """The bf16 counterpart of the scores-near-twenty test: scaled scores
    reach 20, and each row's maximum moves up at every key tile."""
    q, k, v, o, do, gates = _late_maximum_case(cuda, 71 + n, 2, 4, n, n_valid)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))[..., :n_valid] * 0.125
    assert float(s.max()) >= 15.0
    tiles = s.split(64, dim=-1)
    running = tiles[0].amax(-1)
    for tile in tiles[1:]:  # every tile raises every row's maximum
        assert bool((tile.amax(-1) > running).all())
        running = torch.maximum(running, tile.amax(-1))
    _check_bf16_attention_backward(q, k, v, o, do, gates, n_valid)


@pytest.mark.parametrize("rows,d,zero_rows", [(16 * 832, 512, 31), (96 * 64, 512, 2), (5, 64, 1)])
@pytest.mark.parametrize("residual", [True, False])
def test_rmsnorm_backward_bf16_kernel_matches_plain(cuda, rows, d, zero_rows, residual):
    g = torch.Generator(device=cuda).manual_seed(63)
    x, dxn, dres = (torch.randn(rows, d, generator=g, device=cuda).to(BF) for _ in range(3))
    x[-zero_rows:] = 0  # padded tokens
    gamma = 1 + 0.1 * torch.randn(d, generator=g, device=cuda)
    launched = _counted("rmsnorm_backward_bf16")
    got = bb.rmsnorm_backward(x, gamma, dxn, dres if residual else None)
    torch.cuda.synchronize()
    assert launched() == 1
    want = bb.rmsnorm_bwd_ref(x, gamma, dxn, dres if residual else None)
    assert (got[0].dtype, got[1].dtype) == (BF, torch.float32)
    _close(got[0], want[0], BF)
    _close(got[1], want[1], torch.float32)  # dγ: float32 sums of the same values


@pytest.mark.parametrize("rows,hidden", [(16 * 832, 2048), (7, 64)])
def test_gelu_backward_bf16_kernel_matches_plain(cuda, rows, hidden):
    g = torch.Generator(device=cuda).manual_seed(64)
    pre = (torch.randn(rows, hidden, generator=g, device=cuda) * 2).to(BF)
    dh = torch.randn(rows, hidden, generator=g, device=cuda).to(BF)
    launched = _counted("gelu_backward_bf16")
    got = bb.gelu_backward(pre, dh)
    torch.cuda.synchronize()
    assert launched() == 1
    for a, w in zip(got, bb.gelu_bwd_ref(pre, dh)):
        assert a.dtype == BF
        _close(a, w, BF)


@pytest.mark.parametrize("b,n_pad,heads,rope", [(16, 832, 8, True), (96, 64, 8, True),
                                                (3, 128, 5, False)])
def test_rope_gate_backward_bf16_kernel_matches_plain(cuda, b, n_pad, heads, rope):
    g = torch.Generator(device=cuda).manual_seed(65)
    dq, dk, dv = (torch.randn(b, heads, n_pad, 64, generator=g, device=cuda).to(BF)
                  for _ in range(3))
    delta = torch.randn(b, heads, n_pad, generator=g, device=cuda)
    gates = torch.sigmoid(torch.randn(b, heads, n_pad, generator=g, device=cuda))
    tables = _rope_tables(n_pad, 64, BF, cuda) if rope else None
    launched = _counted("rope_gate_backward_bf16")
    got = bb.rope_gate_backward(dq, dk, dv, delta, gates, tables)
    torch.cuda.synchronize()
    assert launched() == 1
    want = bb.rope_gate_bwd_ref(dq, dk, dv, delta, gates, tables)
    assert (got[0].dtype, got[1].dtype) == (BF, torch.float32)
    _close(got[0], want[0], BF)
    _close(got[1], want[1], torch.float32)


def _rel_l2(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))


@pytest.mark.parametrize("b,n_valid", [(2, 801), (16, 62)])
def test_block_functions_bf16_backward_launch_the_bf16_forms(cuda, b, n_valid):
    """Both blocks' autograd Functions in bf16 on the card run K1-K4's bf16
    forms (and no float32 form), and every gradient's distance to the
    float32 Functions' is within 6 dB of the same bf16 composition's on the
    CPU (the plain versions, rounding at the same points): the kernels add
    at most 6 dB to what bf16 costs."""
    d, h, hidden = 512, 8, 2048
    n_pad = -(-n_valid // 64) * 64
    g = torch.Generator(device=cuda).manual_seed(66)
    x = torch.randn(b, n_pad, d, generator=g, device=cuda).to(BF)
    x[:, n_valid:] = 0
    dy = torch.randn(b, n_pad, d, generator=g, device=cuda).to(BF)
    dy[:, n_valid:] = 0
    cos, sin = _rope_tables(n_valid, 64, BF, cuda)
    tables = (F.pad(cos, (0, 0, 0, n_pad - n_valid)), F.pad(sin, (0, 0, 0, n_pad - n_valid)))
    blocks = {
        "attention": (ab.fused_attention_block, dict(heads=h, n_valid=n_valid),
                      _block_weights(g, cuda, BF, d, h),
                      {"fused_attention_block": 1, "flash_wgmma": 1, "attention_backward_bf16": 1,
                       "rope_gate_backward_bf16": 1, "rmsnorm_backward_bf16": 1}),
        "feedforward": (ab.fused_ff_block, {}, dict(
            ff_norm=(1 + 0.1 * torch.randn(d, generator=g, device=cuda)).to(BF),
            w1=(torch.randn(d, hidden, generator=g, device=cuda) * 0.05).to(BF),
            b1=(torch.randn(hidden, generator=g, device=cuda) * 0.05).to(BF),
            w2=(torch.randn(hidden, d, generator=g, device=cuda) * 0.05).to(BF),
            b2=(torch.randn(d, generator=g, device=cuda) * 0.05).to(BF)),
                        {"fused_ff_block": 1, "gelu_backward_bf16": 1,
                         "rmsnorm_backward_bf16": 1})}
    for which, (fn, kw, weights, plan) in blocks.items():
        def grads(device, dtype):
            xs = x.to(device, dtype).requires_grad_(True)
            ws = {k: t.to(device, dtype).requires_grad_(True) for k, t in weights.items()}
            extra = ({"rope": tuple(t.to(device, dtype) for t in tables)}
                     if which == "attention" else {})
            out = fn(xs, **kw, **extra, **ws)
            return [t.float().cpu() for t in torch.autograd.grad(out, [xs, *ws.values()],
                                                                 dy.to(device, dtype))]

        _build.reset_launch_counts()
        got = grads(cuda, BF)
        torch.cuda.synchronize()
        assert {k: v for k, v in _build.LAUNCHES.items() if v} == plan
        ref = grads(cuda, torch.float32)
        plain = grads(torch.device("cpu"), BF)
        for name, a, r, p in zip(["x", *weights], got, ref, plain):
            if name == "x":
                a, r, p = a[:, :n_valid], r[:, :n_valid], p[:, :n_valid]
            assert _rel_l2(a, r) <= 2 * _rel_l2(p, r), (which, name, _rel_l2(a, r),
                                                         _rel_l2(p, r))


# ------------------------------------------------- partial-sum forms (the mesh)


def _partial_case(cuda, dtype, tp, b, n_valid, seed=31):
    """Shard 0 of a flagship layer at tp: its heads' q, k, v columns, gates
    and wo rows; its hidden columns of w1 and b1 and rows of w2."""
    from audio_separator_tpu_torch.parallel.mesh import wqkv_shard_columns

    d, h, dh, hidden = 512, 8, 64, 2048
    hs, ws = h // tp, hidden // tp
    n_pad = -(-n_valid // 64) * 64
    g = torch.Generator(device=cuda).manual_seed(seed)

    def randn(*shape, s=1.0):
        return (torch.randn(*shape, generator=g, device=cuda) * s).to(dtype)

    x = randn(b, n_pad, d)
    x[:, n_valid:] = 0
    cols = torch.as_tensor(wqkv_shard_columns(h, dh, tp, 0), device=cuda)
    attn = dict(wqkv=randn(d, 3 * h * dh, s=0.05)[:, cols].contiguous(),
                gate_w=randn(d, h, s=0.05)[:, :hs].contiguous(),
                gate_b=randn(h, s=0.05)[:hs].contiguous(),
                wo=randn(h * dh, d, s=0.05)[: hs * dh].contiguous(),
                attn_norm=(1 + randn(d, s=0.1).float()).to(dtype))
    cos, sin = _rope_tables(n_valid, dh, dtype, cuda)
    rope = (F.pad(cos, (0, 0, 0, n_pad - n_valid)), F.pad(sin, (0, 0, 0, n_pad - n_valid)))
    ff = dict(ff_norm=(1 + randn(d, s=0.1).float()).to(dtype),
              w1=randn(d, hidden, s=0.05)[:, :ws].contiguous(),
              b1=randn(hidden, s=0.05)[:ws].contiguous(),
              w2=randn(hidden, d, s=0.05)[:ws].contiguous())
    return x, attn, dict(rope=rope, heads=hs, n_valid=n_valid), ff


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("b,n_valid", [(16, 801), (96, 62)])
def test_partial_block_kernels_match_plain(cuda, dtype, tp, b, n_valid):
    """B1 and B2 without their residual (and b2) at the flagship's shard
    shapes, counted as their partial forms."""
    x, attn, kw, ff = _partial_case(cuda, dtype, tp, b, n_valid)
    before = dict(ab.LAUNCHES)
    got = ab.fused_attention_block(x, partial=True, **kw, **attn)
    got_ff = ab.fused_ff_block(x, b2=None, partial=True, **ff)
    torch.cuda.synchronize()
    assert ab.LAUNCHES["fused_attention_block_partial"] == before[
        "fused_attention_block_partial"] + 1
    assert ab.LAUNCHES["fused_ff_block_partial"] == before["fused_ff_block_partial"] + 1
    assert ab.LAUNCHES["fused_attention_block"] == before["fused_attention_block"]
    want = ab.fused_attention_block_ref(x, partial=True, **kw, **attn)
    _close(got[:, :n_valid], want[:, :n_valid], dtype, BLOCK_TOL)
    _close(got_ff, ab.fused_ff_block_ref(x, b2=None, partial=True, **ff), dtype, BLOCK_TOL)


def test_full_blocks_are_their_partial_forms_plus_the_residual(cuda):
    """In float32 the full launch is x + the partial launch's product, to
    the float32 level; the full form's output is unchanged by the flag."""
    x, attn, kw, ff = _partial_case(cuda, torch.float32, 1, 16, 801)
    full = ab.fused_attention_block(x, **kw, **attn)
    part = ab.fused_attention_block(x, partial=True, **kw, **attn)
    _close((x + part)[:, :801], full[:, :801], torch.float32, BLOCK_TOL)
    b2 = torch.randn(x.shape[-1], device=cuda) * 0.05
    _close(x + ab.fused_ff_block(x, b2=None, partial=True, **ff) + b2,
           ab.fused_ff_block(x, b2=b2, **ff), torch.float32, BLOCK_TOL)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("b,n_valid", [(16, 801), (96, 62)])
def test_partial_block_functions_backward_match_plain_autograd(cuda, tp, b, n_valid):
    """The partial forms' gradients (kernels forward and backward, float32;
    no residual gradient into K2, no b2) against autograd through the plain
    partial forms."""
    x, attn, kw, ff = _partial_case(cuda, torch.float32, tp, b, n_valid, seed=32)
    g = torch.Generator(device=cuda).manual_seed(33)
    dy = torch.randn(x.shape, generator=g, device=cuda)
    dy[:, n_valid:] = 0
    xs = x.requires_grad_(True)
    for fn, ref, fkw, block_weights in (
            (ab.fused_attention_block, ab.fused_attention_block_ref, kw, attn),
            (ab.fused_ff_block, ab.fused_ff_block_ref, {"b2": None}, ff)):
        weights = {k: t.clone().requires_grad_(True) for k, t in block_weights.items()}
        inputs = [xs, *weights.values()]
        got = _grads(fn(xs, partial=True, **fkw, **weights), inputs, dy)
        want = _grads(ref(xs, partial=True, **fkw, **weights), inputs, dy)
        for name, a, b_ in zip(["x", *weights], got, want):
            _close(a[:, :n_valid] if name == "x" else a, b_[:, :n_valid] if name == "x" else b_,
                   torch.float32)


# ----------------------------------------------------------------- GroupNorm
# ops/group_norm (csrc/group_norm.cu) against its plain version computed in
# float64, at the HTDemucs songs cell's shapes. Tolerance GN_TOL (max, mean
# of the output's scale): the kernel's float32 statistics sum in another
# order than the reference's (per-thread vectors of four merged by Chan's
# formula, then a fixed tree): the mean and M2 of rows of up to 8.3 M
# elements are good to some 1e-7 relative, and the apply pass adds a few
# float32 roundings (a·x + b, erf or exp, the scale and the residual).

from audio_separator_tpu_torch.ops import group_norm as gn  # noqa: E402

GN_TOL = {torch.float32: (1e-5, 1e-6)}


def _gn_case(cuda, shape, groups, epilogue, channel_last=False, seed=40):
    g = torch.Generator(device=cuda).manual_seed(seed)
    channels = shape[-1] if channel_last else shape[1]
    # An offset mean and a spread of scales: a shifted sum would lose digits.
    x = torch.randn(*shape, generator=g, device=cuda) * 2.5 + 0.75
    kw = dict(weight=1 + 0.3 * torch.randn(channels, generator=g, device=cuda),
              bias=0.2 * torch.randn(channels, generator=g, device=cuda))
    if epilogue == "glu_scale_residual":
        out = (shape[0], channels // 2, *shape[2:])
        kw.update(scale=0.5 * torch.randn(channels // 2, generator=g, device=cuda),
                  residual=torch.randn(*out, generator=g, device=cuda))
    return x, kw


def _gn_check(x, kw, groups, epilogue, channel_last=False):
    got = gn.group_norm(x, groups=groups, eps=1e-5, epilogue=epilogue,
                        channel_last=channel_last, **kw)
    want = gn.group_norm_ref(x.double(), groups=groups, eps=1e-5, epilogue=epilogue,
                             channel_last=channel_last,
                             **{k: v.double() for k, v in kw.items()})
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got, want, torch.float32, GN_TOL)
    return got


@pytest.mark.parametrize("shape, groups, epilogue, channel_last", [
    ((4, 96, 85995), 1, "glu_scale_residual", False),  # DConv level 0, time branch
    ((4, 6, 85995), 1, "gelu", False),
    ((2048, 96, 336), 1, "glu_scale_residual", False),  # level 0, frequency rows folded
    ((2048, 6, 336), 1, "gelu", False),
    ((4, 1344, 512), 1, "none", True),                  # transformer output norms
    ((4, 2688, 512), 1, "none", True),
    ((4, 384, 8, 336), 4, "gelu", False),               # v3's GroupNorm(4, 384)
    ((4, 768, 8, 84), 4, "glu_scale_residual", False),  # v3's GroupNorm(4, 2C) before GLU
    ((4, 384, 1000), 4, "none", False),
])
def test_group_norm_kernel_matches_float64_at_the_cells_shapes(cuda, shape, groups, epilogue,
                                                               channel_last):
    x, kw = _gn_case(cuda, shape, groups, epilogue, channel_last)
    launches = _counted("group_norm")
    _gn_check(x, kw, groups, epilogue, channel_last)
    assert launches() == 1


@pytest.mark.parametrize("shape, groups, epilogue, scaled", [
    ((3, 7, 1001), 1, "gelu", False),                # C·L odd: misaligned rows
    ((3, 10, 1001), 1, "glu_scale_residual", True),  # C/2·L odd: scalar GLU inputs
    ((3, 10, 1001), 1, "glu_scale_residual", False),  # GLU alone, as HEncLayer's
    ((5, 4, 3), 2, "none", False),                   # rows shorter than a vector
    ((2, 6, 1), 3, "gelu", False),
])
def test_group_norm_kernel_takes_ragged_rows(cuda, shape, groups, epilogue, scaled):
    x, kw = _gn_case(cuda, shape, groups, epilogue, seed=41)
    if epilogue == "glu_scale_residual" and not scaled:
        kw.pop("scale"), kw.pop("residual")
    _gn_check(x, kw, groups, epilogue)
    xv = torch.empty(x.numel() + 1, device=cuda)[1:].view(x.shape).copy_(x)
    assert xv.data_ptr() % 16  # a base off the 16-byte grid is made contiguous anew
    _gn_check(xv, kw, groups, epilogue)


def test_group_norm_kernel_gives_the_same_bits_twice(cuda):
    for shape, epilogue, channel_last in (((4, 96, 85995), "glu_scale_residual", False),
                                          ((4, 2688, 512), "none", True)):
        x, kw = _gn_case(cuda, shape, 1, epilogue, channel_last, seed=42)
        first = gn.group_norm(x, groups=1, eps=1e-5, epilogue=epilogue,
                              channel_last=channel_last, **kw)
        again = gn.group_norm(x, groups=1, eps=1e-5, epilogue=epilogue,
                              channel_last=channel_last, **kw)
        assert torch.equal(first, again)


def test_group_norm_split_counts_few_row_launches_only(cuda):
    split, launches = _counted("group_norm_split"), _counted("group_norm")
    x, kw = _gn_case(cuda, (4, 96, 85995), 1, "glu_scale_residual", seed=43)
    gn.group_norm(x, groups=1, eps=1e-5, epilogue="glu_scale_residual", **kw)
    assert (split(), launches()) == (1, 1)
    x, kw = _gn_case(cuda, (2048, 6, 336), 1, "gelu", seed=44)
    gn.group_norm(x, groups=1, eps=1e-5, epilogue="gelu", **kw)
    assert (split(), launches()) == (1, 2)


def test_group_norm_under_autograd_is_the_plain_composition(cuda):
    x, kw = _gn_case(cuda, (2, 12, 500), 1, "glu_scale_residual", seed=45)
    kw["weight"].requires_grad_(True)
    launches = _counted("group_norm")
    got = gn.group_norm(x, groups=1, eps=1e-5, epilogue="glu_scale_residual", **kw)
    assert launches() == 0 and got.requires_grad
    assert torch.equal(got, gn.group_norm_ref(x, groups=1, eps=1e-5,
                                              epilogue="glu_scale_residual", **kw))
