"""Restore diffq-quantized Demucs checkpoints without the diffq package.

Demucs v3-era bags (mdx_q / mdx_extra_q and user fine-tunes saved with
``quant.diffq``) store ``state = {"__quantized": True, "quantized": [...],
"float16": [...], "others": [...]}`` produced by diffq's
``BaseQuantizer.get_quantized_state`` and restored by
``diffq.restore_quantized_state``
(ref: uvr_lib_v5/demucs/states.py:18,34-64 — ``set_state`` dispatches to the
diffq restore path for ``__quantized`` states).

The three lists are *positional*: they follow the model's parameter
traversal order (``named_modules`` × ``named_parameters(recurse=False)``,
which equals state_dict parameter order), partitioned by size —

  * params with ``numel > min_size·2**20/4`` → ``quantized`` (DiffQuantizer
    entries ``(levels, scales, bits)``: per-group symmetric max-abs
    quantisation, ``w = levels · scales / (2^(bits−1) − 1)``; or
    UniformQuantizer entries ``(levels, mn, scale)`` with scalar ``bits``:
    ``w = levels / (2^bits − 1) · scale + mn``),
  * the rest → ``others`` (fp32 clones) or ``float16`` when the quantizer
    was built with ``float16=True`` (demucs uses the default False).

Restoring therefore needs the ordered (name, shape) manifest of the model's
parameters. :func:`demucs_param_manifest` rebuilds it from the checkpoint's
own ``(klass, kwargs)`` record by mirroring the constructor geometry of
HDemucs/HTDemucs (ref: uvr_lib_v5/demucs/hdemucs.py:67-331 HEnc/HDecLayer,
demucs.py:99-232 DConv/BLSTM/LocalState, htdemucs.py:222-340,
transformer.py:415-530). The manifest is parity-tested against the
reference's real ``named_parameters`` in tests/test_diffq.py.

Demucs quantizer defaults when the state carries no ``meta``:
``DiffQuantizer(model, min_size=args.min_size, group_size=args.group_size)``
with the demucs training defaults min_size=1 (MB), group_size=8.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Sequence, Tuple

import numpy as np

Manifest = List[Tuple[str, Tuple[int, ...]]]


# ---------------------------------------------------------------------------
# Parameter manifests


def _conv(name: str, cout: int, cin: int, *kernel: int) -> Iterable:
    yield f"{name}.weight", (cout, cin, *kernel)
    yield f"{name}.bias", (cout,)


def _conv_tr(name: str, cin: int, cout: int, *kernel: int) -> Iterable:
    # ConvTranspose stores weight as (in, out, *k)
    yield f"{name}.weight", (cin, cout, *kernel)
    yield f"{name}.bias", (cout,)


def _affine(name: str, c: int) -> Iterable:
    yield f"{name}.weight", (c,)
    yield f"{name}.bias", (c,)


def _dconv_manifest(prefix: str, channels: int, compress: float, depth: int,
                    lstm: bool, attn: bool) -> Iterable:
    """DConv residual branch (ref: demucs.py:99-168; Sequential indices shift
    when BLSTM/LocalState are inserted at position 3)."""
    hidden = int(channels / compress)
    for d in range(depth):
        base = f"{prefix}.layers.{d}"
        yield from _conv(f"{base}.0", hidden, channels, 3)
        yield from _affine(f"{base}.1", hidden)  # GroupNorm(1, hidden)
        idx = 3  # index 2 is the activation
        if lstm:
            lb = f"{base}.{idx}"
            for layer in range(2):
                isz = hidden if layer == 0 else 2 * hidden
                for rev in ("", "_reverse"):
                    yield f"{lb}.lstm.weight_ih_l{layer}{rev}", (4 * hidden, isz)
                    yield f"{lb}.lstm.weight_hh_l{layer}{rev}", (4 * hidden, hidden)
                    yield f"{lb}.lstm.bias_ih_l{layer}{rev}", (4 * hidden,)
                    yield f"{lb}.lstm.bias_hh_l{layer}{rev}", (4 * hidden,)
            yield f"{lb}.linear.weight", (hidden, 2 * hidden)
            yield f"{lb}.linear.bias", (hidden,)
            idx += 1
        if attn:
            lsb = f"{base}.{idx}"  # LocalState(heads=4, ndecay=4)
            yield from _conv(f"{lsb}.content", hidden, hidden, 1)
            yield from _conv(f"{lsb}.query", hidden, hidden, 1)
            yield from _conv(f"{lsb}.key", hidden, hidden, 1)
            yield from _conv(f"{lsb}.query_decay", 16, hidden, 1)
            yield from _conv(f"{lsb}.proj", hidden, hidden, 1)
            idx += 1
        yield from _conv(f"{base}.{idx}", 2 * channels, hidden, 1)
        yield from _affine(f"{base}.{idx + 1}", 2 * channels)
        # idx+2 is GLU; LayerScale at idx+3
        yield f"{base}.{idx + 3}.scale", (channels,)


def _henc_manifest(prefix: str, chin: int, chout: int, ker: int, freq: bool,
                   norm: bool, context: int, empty: bool, dconv: bool,
                   dconv_kw: Dict[str, Any]) -> Iterable:
    """HEncLayer (ref: hdemucs.py:67-117): conv → norm1 → rewrite → norm2 →
    dconv."""
    if freq:
        yield from _conv(f"{prefix}.conv", chout, chin, ker, 1)
    else:
        yield from _conv(f"{prefix}.conv", chout, chin, ker)
    if empty:
        return
    if norm:
        yield from _affine(f"{prefix}.norm1", chout)
    rk = 1 + 2 * context
    if freq:
        yield from _conv(f"{prefix}.rewrite", 2 * chout, chout, rk, rk)
    else:
        yield from _conv(f"{prefix}.rewrite", 2 * chout, chout, rk)
    if norm:
        yield from _affine(f"{prefix}.norm2", 2 * chout)
    if dconv:
        yield from _dconv_manifest(f"{prefix}.dconv", chout, **dconv_kw)


def _hdec_manifest(prefix: str, chin: int, chout: int, ker: int, freq: bool,
                   norm: bool, context: int, empty: bool, dconv: bool,
                   dconv_kw: Dict[str, Any]) -> Iterable:
    """HDecLayer (ref: hdemucs.py:252-297): conv_tr → norm2 → rewrite →
    norm1 → dconv."""
    if freq:
        yield from _conv_tr(f"{prefix}.conv_tr", chin, chout, ker, 1)
    else:
        yield from _conv_tr(f"{prefix}.conv_tr", chin, chout, ker)
    if norm:
        yield from _affine(f"{prefix}.norm2", chout)
    if empty:
        return
    rk = 1 + 2 * context
    if freq:
        yield from _conv(f"{prefix}.rewrite", 2 * chin, chin, rk, rk)
    else:
        yield from _conv(f"{prefix}.rewrite", 2 * chin, chin, rk)
    if norm:
        yield from _affine(f"{prefix}.norm1", 2 * chin)
    if dconv:
        yield from _dconv_manifest(f"{prefix}.dconv", chin, **dconv_kw)


def _transformer_layer_manifest(prefix: str, dim: int, hidden: int,
                                cross: bool) -> Iterable:
    """MyTransformerEncoderLayer / CrossTransformerEncoderLayer with the
    HTDemucs defaults t_norm_first=True, t_norm_out=True, t_layer_scale=True,
    t_group_norm=False (ref: transformer.py:257-283, 364-412)."""
    attn = "cross_attn" if cross else "self_attn"
    yield f"{prefix}.{attn}.in_proj_weight", (3 * dim, dim)
    yield f"{prefix}.{attn}.in_proj_bias", (3 * dim,)
    yield f"{prefix}.{attn}.out_proj.weight", (dim, dim)
    yield f"{prefix}.{attn}.out_proj.bias", (dim,)
    yield f"{prefix}.linear1.weight", (hidden, dim)
    yield f"{prefix}.linear1.bias", (hidden,)
    yield f"{prefix}.linear2.weight", (dim, hidden)
    yield f"{prefix}.linear2.bias", (dim,)
    yield from _affine(f"{prefix}.norm1", dim)
    yield from _affine(f"{prefix}.norm2", dim)
    if cross:
        yield from _affine(f"{prefix}.norm3", dim)
    yield from _affine(f"{prefix}.norm_out", dim)
    yield f"{prefix}.gamma_1.scale", (dim,)
    yield f"{prefix}.gamma_2.scale", (dim,)


def demucs_param_manifest(klass_name: str, kwargs: Dict[str, Any],
                          args: Sequence[Any] = ()) -> Manifest:
    """Ordered (state_dict key, shape) for every parameter of an
    HDemucs/HTDemucs built with the given checkpoint kwargs."""
    is_ht = klass_name == "HTDemucs"
    if klass_name not in ("HDemucs", "HTDemucs"):
        raise NotImplementedError(
            f"diffq restore: unsupported demucs class {klass_name}")
    kw = dict(kwargs)
    sources = tuple(kw.get("sources") or (args[0] if args else ()))
    if kw.get("multi_freqs"):
        raise NotImplementedError(
            "diffq restore: MultiWrap (multi_freqs) checkpoints unsupported")
    audio_channels = kw.get("audio_channels", 2)
    channels = kw.get("channels", 48)
    channels_time = kw.get("channels_time")
    growth = kw.get("growth", 2)
    nfft = kw.get("nfft", 4096)
    cac = kw.get("cac", True)
    depth = kw.get("depth", 4 if is_ht else 6)
    rewrite = kw.get("rewrite", True)
    if not rewrite:
        raise NotImplementedError("diffq restore: rewrite=False unsupported")
    freq_emb_w = kw.get("freq_emb", 0.2)
    kernel_size = kw.get("kernel_size", 8)
    time_stride = kw.get("time_stride", 2)
    stride = kw.get("stride", 4)
    context = kw.get("context", 1)
    context_enc = kw.get("context_enc", 0)
    norm_starts = kw.get("norm_starts", 4)
    dconv_mode = kw.get("dconv_mode", 1)
    dconv_depth = kw.get("dconv_depth", 2)
    dconv_comp = kw.get("dconv_comp", 8 if is_ht else 4)
    dconv_lstm = kw.get("dconv_lstm", 4)  # HDemucs only
    dconv_attn = kw.get("dconv_attn", 4)
    hybrid = True if is_ht else kw.get("hybrid", True)
    bottom_channels = kw.get("bottom_channels", 0) if is_ht else 0
    t_layers = kw.get("t_layers", 5) if is_ht else 0
    t_hidden_scale = kw.get("t_hidden_scale", 4.0)

    # Mirror the constructor loop (ref: hdemucs.py:484-560, htdemucs.py:242-330)
    enc: List[Tuple] = []
    dec: List[Tuple] = []
    tenc: List[Tuple] = []
    tdec: List[Tuple] = []
    freq_emb_entry = None

    chin = audio_channels
    chin_z = chin * 2 if cac else chin
    chout = channels_time or channels
    chout_z = channels
    freqs = nfft // 2
    for index in range(depth):
        if is_ht:
            lstm = attn = False
        else:
            lstm = index >= dconv_lstm
            attn = index >= dconv_attn
        norm = index >= norm_starts
        freq = freqs > 1
        stri, ker = stride, kernel_size
        if not freq:
            ker, stri = time_stride * 2, time_stride
        last_freq = False
        if freq and freqs <= kernel_size:
            ker = freqs
            last_freq = True
        dconv_kw = {"compress": dconv_comp, "depth": dconv_depth,
                    "lstm": lstm, "attn": attn}
        if last_freq:
            chout_z = max(chout, chout_z)
            chout = chout_z

        # The freq-branch encoder layer is never empty; only the time-branch
        # twin is (it injects into the freq branch at the merge layer).
        enc.append((chin_z, chout_z, ker, freq, norm, context_enc,
                    False, bool(dconv_mode & 1), dconv_kw))
        if hybrid and freq:
            tenc.append((chin, chout, kernel_size, False, norm, context_enc,
                         last_freq, bool(dconv_mode & 1), dconv_kw))
        if index == 0:
            chin = audio_channels * len(sources)
            chin_z = chin * 2 if cac else chin
        dec.insert(0, (chout_z, chin_z, ker, freq, norm, context,
                       False, bool(dconv_mode & 2), dconv_kw))
        if hybrid and freq:
            tdec.insert(0, (chout, chin, kernel_size, False, norm, context,
                            last_freq, bool(dconv_mode & 2), dconv_kw))
        chin, chin_z = chout, chout_z
        chout, chout_z = int(growth * chout), int(growth * chout_z)
        if freq:
            freqs = 1 if freqs <= kernel_size else freqs // stride
        if index == 0 and freq_emb_w:
            freq_emb_entry = ("freq_emb.embedding.weight", (freqs, chin_z))

    manifest: Manifest = []
    # Module attribute order: encoder, decoder, tencoder, tdecoder, freq_emb,
    # [channel (up/down)samplers], crosstransformer.
    for i, spec in enumerate(enc):
        cin, cout, ker, freq, norm, ctx, empty, dconv, dkw = spec
        manifest.extend(_henc_manifest(f"encoder.{i}", cin, cout, ker, freq,
                                       norm, ctx, empty, dconv, dkw))
    for i, spec in enumerate(dec):
        cin, cout, ker, freq, norm, ctx, empty, dconv, dkw = spec
        manifest.extend(_hdec_manifest(f"decoder.{i}", cin, cout, ker, freq,
                                       norm, ctx, empty, dconv, dkw))
    for i, spec in enumerate(tenc):
        cin, cout, ker, freq, norm, ctx, empty, dconv, dkw = spec
        manifest.extend(_henc_manifest(f"tencoder.{i}", cin, cout, ker, freq,
                                       norm, ctx, empty, dconv, dkw))
    for i, spec in enumerate(tdec):
        cin, cout, ker, freq, norm, ctx, empty, dconv, dkw = spec
        manifest.extend(_hdec_manifest(f"tdecoder.{i}", cin, cout, ker, freq,
                                       norm, ctx, empty, dconv, dkw))
    if freq_emb_entry is not None:
        manifest.append(freq_emb_entry)

    if is_ht:
        t_channels = channels * growth ** (depth - 1)
        if bottom_channels:
            manifest.extend(_conv("channel_upsampler", bottom_channels,
                                  t_channels, 1))
            manifest.extend(_conv("channel_downsampler", t_channels,
                                  bottom_channels, 1))
            manifest.extend(_conv("channel_upsampler_t", bottom_channels,
                                  t_channels, 1))
            manifest.extend(_conv("channel_downsampler_t", t_channels,
                                  bottom_channels, 1))
            t_channels = bottom_channels
        if t_layers > 0:
            dim = t_channels
            hidden = int(dim * t_hidden_scale)
            cross_first = bool(kw.get("t_cross_first", False))
            classic_parity = 1 if cross_first else 0
            ct = "crosstransformer"
            manifest.extend(_affine(f"{ct}.norm_in", dim))
            manifest.extend(_affine(f"{ct}.norm_in_t", dim))
            for branch in ("layers", "layers_t"):
                for idx in range(t_layers):
                    cross = idx % 2 != classic_parity
                    manifest.extend(_transformer_layer_manifest(
                        f"{ct}.{branch}.{idx}", dim, hidden, cross))
    return manifest


# ---------------------------------------------------------------------------
# Dequantisation


def _numel(shape: Tuple[int, ...]) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t
    return t.detach().cpu().numpy()  # torch tensor


def dequantize_entry(entry, shape: Tuple[int, ...]) -> np.ndarray:
    """One ``quantized`` list entry → float32 array of ``shape``.

    DiffQuantizer: ``(levels, scales, bits)`` with per-group tensors —
    ``w = levels · scales / (2^(bits−1) − 1)``. UniformQuantizer:
    ``(levels, mn, scale[, bits])`` with scalar mn/scale —
    ``w = levels / (2^bits − 1) · scale + mn``.
    """
    if not isinstance(entry, (tuple, list)) or len(entry) not in (3, 4):
        raise NotImplementedError(
            f"diffq restore: unrecognised quantized entry type {type(entry)} "
            "(bit-packed states are not supported; re-export with diffq's "
            "unpacked get_quantized_state)")
    parts = [_to_numpy(p) if hasattr(p, "detach") or isinstance(p, np.ndarray)
             else p for p in entry]
    levels = parts[0]
    if np.issubdtype(np.asarray(parts[1]).dtype, np.floating) and \
            np.asarray(parts[1]).ndim == 0:
        # UniformQuantizer: scalar (mn, scale)
        mn = float(parts[1])
        scale = float(parts[2])
        bits = int(parts[3]) if len(parts) == 4 else 8
        w = levels.astype(np.float32) / (2 ** bits - 1) * scale + mn
    else:
        scales = np.asarray(parts[1], dtype=np.float32)
        bits = np.asarray(parts[2], dtype=np.float32)
        unit = 1.0 / (2.0 ** (bits - 1.0) - 1.0)
        w = levels.astype(np.float32) * unit * scales
    w = w.reshape(-1)[: _numel(shape)]
    return w.reshape(shape).astype(np.float32)


def quantize_diffq(w: np.ndarray, group_size: int = 8, bits: int = 8):
    """DiffQuantizer-format quantisation of one tensor (per-group symmetric
    max-abs). Mirrors diffq's pack math; used by the synthetic round-trip
    test and available for re-exporting states."""
    flat = w.reshape(-1).astype(np.float32)
    if group_size > 0 and flat.size % group_size == 0:
        groups = flat.reshape(-1, group_size)
    else:
        groups = flat.reshape(1, -1)
    scales = np.abs(groups).max(axis=-1, keepdims=True)
    scales = np.where(scales == 0, 1.0, scales)
    unit = 1.0 / (2 ** (bits - 1) - 1)
    levels = np.round(groups / scales / unit)
    levels = levels.astype(np.int8 if bits <= 8 else np.int16)
    bits_arr = np.full((groups.shape[0], 1), bits, dtype=np.uint8)
    return levels, scales.astype(np.float32), bits_arr


def restore_quantized_state(state: Dict[str, Any], klass_name: str,
                            kwargs: Dict[str, Any],
                            args: Sequence[Any] = ()) -> Dict[str, np.ndarray]:
    """Positional quantized state → {state_dict key: float32 array}."""
    assert state.get("__quantized")
    meta = state.get("meta") or {}
    init_kwargs = dict(meta.get("init_kwargs") or {})
    # demucs training defaults (conf: quant.min_size=1 MB, group_size=8)
    min_size = float(init_kwargs.get("min_size", 1.0))
    float16 = bool(init_kwargs.get("float16", False))
    exclude = list(init_kwargs.get("exclude") or [])
    if exclude:
        raise NotImplementedError(
            "diffq restore: quantizer exclude patterns unsupported")
    min_params = int(min_size * 2 ** 20 // 4)

    manifest = demucs_param_manifest(klass_name, kwargs, args)
    quant_names = [(n, s) for n, s in manifest if _numel(s) > min_params]
    small_names = [(n, s) for n, s in manifest if _numel(s) <= min_params]

    quantized = list(state.get("quantized") or [])
    small_src = state.get("float16") if float16 else state.get("others")
    small = list(small_src or [])
    if len(quantized) != len(quant_names) or len(small) != len(small_names):
        raise ValueError(
            "diffq restore: state layout mismatch — "
            f"{len(quantized)} quantized entries for {len(quant_names)} "
            f"large params, {len(small)} small entries for "
            f"{len(small_names)} small params (class {klass_name}). The "
            "checkpoint may use a different quantizer configuration; if it "
            "carries meta.init_kwargs those were honoured.")

    decoded: Dict[str, np.ndarray] = {}
    for (name, shape), entry in zip(quant_names, quantized):
        decoded[name] = dequantize_entry(entry, shape)
    for (name, shape), tensor in zip(small_names, small):
        arr = _to_numpy(tensor).astype(np.float32)
        if arr.shape != tuple(shape):
            raise ValueError(
                f"diffq restore: small-param shape mismatch for {name}: "
                f"{arr.shape} vs manifest {tuple(shape)}")
        decoded[name] = arr
    # state_dict (manifest) order, like a normal checkpoint
    return {name: decoded[name] for name, _ in manifest}
