"""GroupNorm with the elementwise step that follows it, for the Demucs models
(``models/htdemucs.py``): a CUDA kernel for Hopper (``csrc/group_norm.cu``)
and its plain PyTorch version.

``group_norm(x, weight, bias, groups, eps, epilogue)`` is
``nn.GroupNorm(groups, C)`` followed by one of

* ``"none"``;
* ``"gelu"``: ``nn.GELU()`` (the erf form);
* ``"glu_scale_residual"``: ``nn.GLU(1)`` over the channel halves, times
  ``scale`` (a ``LayerScale``'s per-channel gains) where given, plus
  ``residual`` where given: the tail of a ``DConv`` depth, ``x + layer(x)``.

``channel_last=True`` takes ``(B, T, C)`` with one group, statistics over
``(T, C)`` jointly (the cross-transformer's output norm), and returns that
layout. The JAX package has no kernel for any of this: it leaves GroupNorm
to XLA.

The plain version is the modules' own composition, so a CPU tensor computes
what the modules computed. A CUDA float32 tensor in inference launches the
kernel; where autograd needs a gradient through the call (grad mode on and
an input that requires one: the Demucs fine-tune of ``training.py``) the
plain version runs, on any device. Anything else the kernel does not take
raises.

The kernel reduces each (sample, group) row in ``splits`` chunks, one
block each, and merges them in a fixed order, so that few long rows fill
the card (:func:`plan`); PyTorch's GroupNorm gives a row one block. Each
launch counts in ``ops/_build.LAUNCHES["group_norm"]``, and in
``["group_norm_split"]`` too when its rows were split; while spans are on it
is the span ``kernel.group_norm`` with its sizes (``rows``, ``row_len``,
``channels``, ``groups``, ``epilogue``, ``channel_last``, ``splits``,
``scale``, ``residual``).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ._build import check_rc, count, device_kind, launch, load, stream

__all__ = ["EPILOGUES", "group_norm", "group_norm_ref", "plan"]

EPILOGUES = ("none", "gelu", "glu_scale_residual")
_CODES = {name: i for i, name in enumerate(EPILOGUES)}
# Elements a block takes at the least (16 a thread of its 256), and the
# blocks of one wave (eight of 256 threads an SM) a launch aims at.
MIN_BLOCK_ELEMENTS = 4096
BLOCKS_PER_SM = 8
MAX_GROUPS = 64      # csrc/group_norm.cu: the statistics a block holds
MAX_CHANNELS = 8192  # its per-channel a, b (and scale) in shared memory
_MAX_SAMPLE = 2 ** 31 - 4096


def _split(length: int, wanted: int) -> Tuple[int, int]:
    """``(parts, part)``: ``length`` cut into at most ``wanted`` parts of
    ``part`` elements, a multiple of 4, every part non-empty."""
    part = -(-length // max(1, wanted))
    part = -(-part // 4) * 4
    return -(-length // part), part


def plan(rows: int, row_len: int, samples: int, out_len: int,
         sms: int) -> Tuple[int, int, int, int]:
    """``(splits, chunk, pieces, piece)`` of a launch: each of the ``rows``
    statistics rows of ``row_len`` elements in ``splits`` chunks of ``chunk``,
    each of the ``samples`` outputs of ``out_len`` elements in ``pieces`` of
    ``piece``. Enough blocks to fill the card's ``sms`` SMs when rows are
    few, one block a row when they are many, and never a block of fewer
    than :data:`MIN_BLOCK_ELEMENTS` elements where a row has more."""
    wave = BLOCKS_PER_SM * sms
    splits, chunk = _split(row_len, min(-(-wave // rows), -(-row_len // MIN_BLOCK_ELEMENTS)))
    pieces, piece = _split(out_len, min(-(-wave // samples), -(-out_len // MIN_BLOCK_ELEMENTS)))
    return splits, chunk, pieces, piece


def group_norm_ref(x: torch.Tensor, weight: Optional[torch.Tensor],
                   bias: Optional[torch.Tensor], groups: int, eps: float,
                   epilogue: str = "none", scale: Optional[torch.Tensor] = None,
                   residual: Optional[torch.Tensor] = None,
                   channel_last: bool = False) -> torch.Tensor:
    """The plain version: ``F.group_norm`` and the epilogue, composed as the
    modules compose them (``nn.GroupNorm``, ``nn.GELU``, ``nn.GLU(1)``,
    ``LayerScale``, ``x + layer(x)``)."""
    if channel_last:
        y = F.group_norm(x.transpose(1, 2), groups, weight, bias, eps).transpose(1, 2)
    else:
        y = F.group_norm(x, groups, weight, bias, eps)
    if epilogue == "gelu":
        return F.gelu(y)
    if epilogue == "glu_scale_residual":
        y = F.glu(y, 1)
        if scale is not None:
            y = scale.reshape(-1, *[1] * (y.dim() - 2)) * y
        if residual is not None:
            y = residual + y
    return y


def _needs_grad(*tensors: Optional[torch.Tensor]) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous on the 16-byte grid the kernel's vectors read."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def group_norm(x: torch.Tensor, weight: Optional[torch.Tensor], bias: Optional[torch.Tensor],
               groups: int, eps: float, epilogue: str = "none",
               scale: Optional[torch.Tensor] = None, residual: Optional[torch.Tensor] = None,
               channel_last: bool = False) -> torch.Tensor:
    """GroupNorm and ``epilogue`` (module docstring): the kernel for a CUDA
    float32 tensor in inference, else the plain version."""
    if epilogue not in _CODES:
        raise ValueError(f"epilogue {epilogue!r}: one of {EPILOGUES}")
    if epilogue != "glu_scale_residual" and (scale is not None or residual is not None):
        raise ValueError("scale and residual belong to the glu_scale_residual epilogue")
    args = (x, weight, bias, groups, eps, epilogue, scale, residual, channel_last)
    if device_kind(x) == "cpu" or _needs_grad(x, weight, bias, scale, residual):
        return group_norm_ref(*args)
    return _launch(*args)


def _launch(x, weight, bias, groups, eps, epilogue, scale, residual, channel_last):
    glu = epilogue == "glu_scale_residual"
    if x.dtype != torch.float32:
        raise ValueError(f"the GroupNorm kernel takes float32, got {x.dtype}")
    if x.dim() < 3 or (channel_last and x.dim() != 3):
        raise ValueError(f"the GroupNorm kernel takes (N, C, L...) or, channel-last, "
                         f"(N, T, C); got {tuple(x.shape)}")
    samples = x.shape[0]
    channels = x.shape[-1] if channel_last else x.shape[1]
    length = x.numel() // max(1, samples * channels)
    if not 1 <= groups <= MAX_GROUPS or channels % groups or channels > MAX_CHANNELS:
        raise ValueError(f"the GroupNorm kernel takes C % groups == 0, groups <= {MAX_GROUPS} "
                         f"and C <= {MAX_CHANNELS}; got C {channels}, groups {groups}")
    if channel_last and (groups != 1 or glu):
        raise ValueError("the channel-last GroupNorm kernel takes one group and no GLU")
    if glu and channels % 2:
        raise ValueError(f"GLU needs an even channel count, got {channels}")
    if x.numel() == 0 or channels * length >= _MAX_SAMPLE:
        raise ValueError(f"the GroupNorm kernel takes 0 < C·L < {_MAX_SAMPLE}, "
                         f"got {tuple(x.shape)}")
    out_shape = (samples, channels // 2, *x.shape[2:]) if glu else tuple(x.shape)
    params = []
    for name, t, shape in (("weight", weight, (channels,)), ("bias", bias, (channels,)),
                           ("scale", scale, (channels // 2,)), ("residual", residual, out_shape)):
        if t is None:
            params.append(None)
            continue
        if t.device != x.device or t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: float32 {shape} on {x.device} expected, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        params.append(t.contiguous())
    weight, bias, scale, residual = params
    rows = samples * groups
    row_len = channels // groups * length
    out_len = (channels // 2 if glu else channels) * length
    splits, chunk, pieces, piece = plan(rows, row_len, samples, out_len,
                                        _sm_count(x.device.index or 0))
    attrs = dict(rows=rows, row_len=row_len, channels=channels, groups=groups,
                 epilogue=epilogue, channel_last=channel_last, splits=splits,
                 scale=scale is not None, residual=residual is not None)
    with launch("group_norm", **attrs):
        x = _aligned(x)
        residual = None if residual is None else _aligned(residual)
        out = torch.empty(out_shape, dtype=torch.float32, device=x.device)
        partials = torch.empty((rows * splits, 4), dtype=torch.float32, device=x.device)
        lib = load("group_norm")

        def ptr(t):
            return None if t is None else t.data_ptr()

        with torch.cuda.device(x.device):
            rc = lib.asep_group_norm(x.data_ptr(), ptr(weight), ptr(bias), ptr(scale),
                                     ptr(residual), out.data_ptr(), partials.data_ptr(),
                                     samples, channels, groups, length, int(channel_last),
                                     _CODES[epilogue], splits, chunk, pieces, piece,
                                     float(eps), stream(x))
        check_rc(lib, rc, "group_norm")
        if splits > 1:
            count("group_norm_split")
    return out
