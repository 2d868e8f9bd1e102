"""ONNX graph → a function of torch tensors.

The counterpart of the JAX package's ``models/onnx_jax.py``, which replaces the
reference's ONNX Runtime (ref: mdx_separator.py:108-133 runs MDX ``.onnx``
models through ``ort.InferenceSession``). The graph is interpreted once per
call, op by op, into PyTorch calls:

* Weights (initializers) live in a params dict of tensors on an explicit
  device, passed per call (``onnx_to_torch``; ``models/convert.
  convert_onnx_params`` makes the same dict from the JAX executor's params).
* Shape-machinery ops (Shape/Gather/Concat/Cast chains feeding Reshape/Slice)
  are constant-folded with numpy: shapes are concrete, so every
  data-dependent-looking reshape in torch exports resolves to constants.
* The layout stays ONNX/torch NCHW. Convolutions, transposed convolutions and
  MatMul/Gemm are ``torch.nn.functional`` / ``torch.matmul`` calls (cuDNN and
  cuBLAS on the card; the JAX package runs them as XLA, not in a Pallas
  kernel).
* Weights follow the input's dtype by explicit casts, so a bf16 input runs the
  net in bf16 with the JAX executor's rounding points; instance-norm
  statistics stay float32.

Numpy operands mixed with tensors are converted at the op (float64 → float32,
as JAX without x64 does) and the operands promoted by dtype alone, as JAX
promotes them (a bf16 tensor and a float32 constant give float32).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .convert import convert_onnx_params
from .onnx_proto import Graph, Model, Node, load_model

_DTYPE_MAP = {
    1: torch.float32, 2: torch.uint8, 3: torch.int8, 6: torch.int32, 7: torch.int64,
    9: torch.bool, 10: torch.float16, 11: torch.float64, 16: torch.bfloat16,
}
_NP_CAST = {1: np.float32, 6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16,
            11: np.float64}


def _is_const(x) -> bool:
    return isinstance(x, (np.ndarray, np.generic, int, float, bool))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _pair_pads(pads: Sequence[int], rank: int):
    """ONNX pads [x1b, x2b, ..., x1e, x2e, ...] → [(b, e), ...] per spatial axis."""
    half = len(pads) // 2
    return [(int(pads[i]), int(pads[i + half])) for i in range(half)]


def _tensor(x, device) -> torch.Tensor:
    """A constant as a tensor on ``device``; float64 becomes float32."""
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return torch.tensor(arr, device=device)


def _device_of(*xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return None


def _promote(*xs) -> List[torch.Tensor]:
    """Tensors of one dtype, promoted by dtype alone (not by rank)."""
    device = _device_of(*xs)
    ts = [_tensor(x, device) for x in xs]
    dtype = ts[0].dtype
    for t in ts[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return [t.to(dtype) for t in ts]


def _cast(w, x: torch.Tensor) -> torch.Tensor:
    """A weight in the dtype and on the device of the activation ``x``."""
    if isinstance(w, torch.Tensor):
        return w.to(device=x.device, dtype=x.dtype)
    return torch.tensor(np.asarray(w), dtype=x.dtype, device=x.device)


def _bcast_shape(x: torch.Tensor) -> tuple:
    return (1, -1) + (1,) * (x.ndim - 2)


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d, 3: F.conv_transpose3d}


def _pad_spatial(x: torch.Tensor, pads, value: float = 0.0) -> torch.Tensor:
    """Pad the trailing ``len(pads)`` axes by ``[(begin, end), ...]``."""
    flat = []
    for b, e in reversed(pads):
        flat += [b, e]
    if not any(flat):
        return x
    return F.pad(x, flat, value=value)


# Resize, as ``jax.image.resize`` computes it (half-pixel sample centres;
# linear and cubic antialias when downsampling), with its weights in float32.

def _triangle(x):
    return np.maximum(np.float32(0), np.float32(1) - np.abs(x))


def _keys_cubic(x):
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1.0)
    out = np.where(x >= 1.0, ((np.float32(-0.5) * x + np.float32(2.5)) * x
                              - np.float32(4.0)) * x + np.float32(2.0), out)
    return np.where(x >= 2.0, np.float32(0), out).astype(np.float32)


def _resize_weights(m: int, n: int, kernel) -> np.ndarray:
    """``(m, n)`` weights mapping an axis of ``m`` samples to ``n``."""
    scale = np.float32(n / m)
    inv_scale = np.float32(1.0) / scale
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample_f = ((np.arange(n, dtype=np.float32) + np.float32(0.5)) * inv_scale
                - np.float32(0.5))
    x = np.abs(sample_f[None, :] - np.arange(m, dtype=np.float32)[:, None]) / kernel_scale
    weights = kernel(x.astype(np.float32)).astype(np.float32)
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, 1), 0).astype(np.float32)
    inside = (sample_f >= -0.5) & (sample_f <= m - 0.5)
    return np.where(inside[None, :], weights, 0).astype(np.float32)


class OnnxToTorch:
    """Builds a ``fn(params, *inputs) -> [outputs]`` from an ONNX graph."""

    def __init__(self, model: Model):
        self.model = model
        self.graph: Graph = model.graph
        self.params: Dict[str, np.ndarray] = dict(self.graph.initializers)
        init_names = set(self.params)
        self.input_names = [vi.name for vi in self.graph.inputs if vi.name not in init_names]
        self.output_names = [vi.name for vi in self.graph.outputs]

    # -- public ------------------------------------------------------------

    def make_fn(self) -> Callable:
        """Returns fn(params, *inputs) evaluating the graph. Each value is
        dropped after the last node that reads it, so a forward holds only
        the activations still to be read (the skips of a U-Net, say), not
        every intermediate of the graph."""
        nodes = self.graph.nodes
        input_names = self.input_names
        output_names = self.output_names
        param_names = list(self.params)
        last_read: Dict[str, int] = {}
        for i, node in enumerate(nodes):
            for name in node.inputs:
                last_read[name] = i
        keep = set(output_names) | {""}
        drops = [[] for _ in nodes]
        for name, i in last_read.items():
            if name not in keep:
                drops[i].append(name)

        def fn(params, *inputs):
            env: Dict[str, Any] = {"": None}
            for name in param_names:
                env[name] = params[name]
            for name, value in zip(input_names, inputs):
                env[name] = value
            for node, dropped in zip(nodes, drops):
                results = self._exec(node, env)
                for name in dropped:
                    env.pop(name, None)
                for out_name, result in zip(node.outputs, results):
                    if out_name:
                        env[out_name] = result
            return [env[name] for name in output_names]

        return fn

    # -- op dispatch -------------------------------------------------------

    def _exec(self, node: Node, env: Dict[str, Any]) -> List[Any]:
        handler = getattr(self, f"op_{node.op_type}", None)
        if handler is None:
            raise NotImplementedError(f"ONNX op not supported: {node.op_type}")
        args = [env[n] if n else None for n in node.inputs]
        result = handler(node, *args)
        return result if isinstance(result, (list, tuple)) else [result]

    # -- helpers -----------------------------------------------------------

    @staticmethod
    def _shape_of(x) -> tuple:
        return tuple(x.shape) if isinstance(x, torch.Tensor) else tuple(_np(x).shape)

    # -- elementwise / activation -----------------------------------------

    def op_Relu(self, node, x):
        return torch.clamp_min(x, 0)

    def op_LeakyRelu(self, node, x):
        alpha = node.attrs.get("alpha", 0.01)
        return torch.where(x >= 0, x, x * alpha)

    def op_Elu(self, node, x):
        alpha = node.attrs.get("alpha", 1.0)
        return torch.where(x >= 0, x, alpha * (torch.exp(x) - 1.0))

    def op_Sigmoid(self, node, x):
        return torch.sigmoid(x)

    def op_Tanh(self, node, x):
        return torch.tanh(x)

    def op_Softmax(self, node, x):
        return torch.softmax(x, dim=node.attrs.get("axis", -1))

    def op_Erf(self, node, x):
        return torch.erf(x)

    def op_Sqrt(self, node, x):
        return torch.sqrt(x)

    def op_Exp(self, node, x):
        return torch.exp(x)

    def op_Log(self, node, x):
        return torch.log(x)

    def op_Neg(self, node, x):
        return -x

    def op_Abs(self, node, x):
        return torch.abs(x)

    def op_Reciprocal(self, node, x):
        return 1.0 / x

    def op_Clip(self, node, x, lo=None, hi=None):
        lo = node.attrs.get("min", lo)
        hi = node.attrs.get("max", hi)
        if lo is not None:
            x = torch.maximum(*_promote(x, lo))
        if hi is not None:
            x = torch.minimum(*_promote(x, hi))
        return x

    _NP_BINARY = {"add": np.add, "sub": np.subtract, "mul": np.multiply,
                  "pow": np.power, "eq": np.equal, "gt": np.greater, "lt": np.less}
    _TORCH_BINARY = {"add": torch.add, "sub": torch.sub, "mul": torch.mul,
                     "pow": torch.pow, "eq": torch.eq, "gt": torch.gt, "lt": torch.lt}

    def _binary(self, op, a, b):
        if _is_const(a) and _is_const(b):
            return self._NP_BINARY[op](_np(a), _np(b))
        return self._TORCH_BINARY[op](*_promote(a, b))

    def op_Add(self, node, a, b):
        return self._binary("add", a, b)

    def op_Sub(self, node, a, b):
        return self._binary("sub", a, b)

    def op_Mul(self, node, a, b):
        return self._binary("mul", a, b)

    def op_Div(self, node, a, b):
        if _is_const(a) and _is_const(b):
            a_np, b_np = _np(a), _np(b)
            if np.issubdtype(a_np.dtype, np.integer) and np.issubdtype(b_np.dtype, np.integer):
                # ONNX integer Div truncates toward zero (C semantics);
                # Python // floors, which differs for negative operands.
                return (np.sign(a_np) * np.sign(b_np)
                        * (np.abs(a_np) // np.abs(b_np))).astype(a_np.dtype)
            return a_np / b_np
        return torch.div(*_promote(a, b))

    def op_Pow(self, node, a, b):
        return self._binary("pow", a, b)

    def op_Equal(self, node, a, b):
        return self._binary("eq", a, b)

    def op_Greater(self, node, a, b):
        return self._binary("gt", a, b)

    def op_Less(self, node, a, b):
        return self._binary("lt", a, b)

    def op_Where(self, node, cond, a, b):
        a, b = _promote(a, b)
        return torch.where(_tensor(cond, a.device).to(torch.bool), a, b)

    def op_Max(self, node, *xs):
        xs = _promote(*xs)
        out = xs[0]
        for x in xs[1:]:
            out = torch.maximum(out, x)
        return out

    def op_Min(self, node, *xs):
        xs = _promote(*xs)
        out = xs[0]
        for x in xs[1:]:
            out = torch.minimum(out, x)
        return out

    # -- normalisation -----------------------------------------------------

    def op_BatchNormalization(self, node, x, scale, bias, mean, var):
        eps = node.attrs.get("epsilon", 1e-5)
        shape = _bcast_shape(x)
        inv = torch.rsqrt(_cast(var, x) + eps).reshape(shape)
        return ((x - _cast(mean, x).reshape(shape)) * inv * _cast(scale, x).reshape(shape)
                + _cast(bias, x).reshape(shape))

    def op_InstanceNormalization(self, node, x, scale, bias):
        eps = node.attrs.get("epsilon", 1e-5)
        axes = tuple(range(2, x.ndim))
        # Statistics in float32 even for a bf16 activation, as the JAX
        # executor computes them.
        x32 = x.float()
        mean = x32.mean(dim=axes, keepdim=True)
        var = x32.var(dim=axes, keepdim=True, unbiased=False)
        shape = _bcast_shape(x)
        out = ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)
        return out * _cast(scale, x).reshape(shape) + _cast(bias, x).reshape(shape)

    def op_GroupNormalization(self, node, x, scale, bias):
        eps = node.attrs.get("epsilon", 1e-5)
        groups = int(node.attrs["num_groups"])
        n, c = x.shape[:2]
        xg = x.reshape(n, groups, c // groups, *x.shape[2:])
        axes = tuple(range(2, xg.ndim))
        mean = xg.mean(dim=axes, keepdim=True)
        var = xg.var(dim=axes, keepdim=True, unbiased=False)
        out = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
        shape = _bcast_shape(x)
        return out * _cast(scale, x).reshape(shape) + _cast(bias, x).reshape(shape)

    def op_LayerNormalization(self, node, x, scale, bias=None):
        eps = node.attrs.get("epsilon", 1e-5)
        axis = node.attrs.get("axis", -1)
        axes = tuple(range(axis % x.ndim, x.ndim))
        mean = x.mean(dim=axes, keepdim=True)
        var = x.var(dim=axes, keepdim=True, unbiased=False)
        out = (x - mean) * torch.rsqrt(var + eps) * _cast(scale, x)
        if bias is not None:
            out = out + _cast(bias, x)
        return out

    @staticmethod
    def _reduce_axes(node, x, axes):
        axes = node.attrs.get("axes", axes)
        if axes is None:
            return tuple(range(x.ndim))
        return tuple(int(a) for a in _np(axes).reshape(-1))

    def op_ReduceMean(self, node, x, axes=None):
        keepdims = bool(node.attrs.get("keepdims", 1))
        return x.mean(dim=self._reduce_axes(node, x, axes), keepdim=keepdims)

    def op_ReduceSum(self, node, x, axes=None):
        keepdims = bool(node.attrs.get("keepdims", 1))
        return x.sum(dim=self._reduce_axes(node, x, axes), keepdim=keepdims)

    # -- conv / pool -------------------------------------------------------

    def op_Conv(self, node, x, w, b=None):
        rank = x.ndim - 2
        strides = [int(s) for s in node.attrs.get("strides", [1] * rank)]
        dilations = [int(d) for d in node.attrs.get("dilations", [1] * rank)]
        group = int(node.attrs.get("group", 1))
        auto_pad = node.attrs.get("auto_pad", "NOTSET")
        kernel_spatial = self._shape_of(w)[2:]
        if auto_pad in ("SAME_UPPER", "SAME_LOWER"):
            pads = []
            for i in range(rank):
                out_dim = -(-x.shape[2 + i] // strides[i])
                total = max(0, (out_dim - 1) * strides[i]
                            + (kernel_spatial[i] - 1) * dilations[i] + 1 - x.shape[2 + i])
                lo = total // 2 if auto_pad == "SAME_UPPER" else (total + 1) // 2
                pads.append((lo, total - lo))
        else:
            pads = _pair_pads(node.attrs.get("pads", [0] * 2 * rank), rank)
        if all(b_ == e_ for b_, e_ in pads):
            padding = [b_ for b_, _ in pads]
        else:
            x, padding = _pad_spatial(x, pads), [0] * rank
        out = _CONV[rank](x, _cast(w, x), None, strides, padding, dilations, group)
        if b is not None:
            out = out + _cast(b, x).reshape((1, -1) + (1,) * rank)
        return out

    def op_ConvTranspose(self, node, x, w, b=None):
        rank = x.ndim - 2
        strides = [int(s) for s in node.attrs.get("strides", [1] * rank)]
        dilations = [int(d) for d in node.attrs.get("dilations", [1] * rank)]
        group = int(node.attrs.get("group", 1))
        out_padding = [int(p) for p in node.attrs.get("output_padding", [0] * rank)]
        pads = _pair_pads(node.attrs.get("pads", [0] * 2 * rank), rank)
        # The ONNX weight layout (C_in, C_out/group, *k) is torch's. The full
        # transposed convolution, extended by output_padding at each axis's
        # end and cropped by the pads, is ONNX's output for any pads.
        out = _CONV_T[rank](x, _cast(w, x), None, strides, 0, 0, group, dilations)
        out = _pad_spatial(out, [(0, p) for p in out_padding])
        crop = [slice(None), slice(None)]
        for i, (pb, pe) in enumerate(pads):
            crop.append(slice(pb, out.shape[2 + i] - pe))
        out = out[tuple(crop)]
        if b is not None:
            out = out + _cast(b, x).reshape((1, -1) + (1,) * rank)
        return out

    def _pool(self, node, x, is_avg=False):
        rank = x.ndim - 2
        kernel = [int(k) for k in node.attrs["kernel_shape"]]
        strides = [int(s) for s in node.attrs.get("strides", [1] * rank)]
        pads = _pair_pads(node.attrs.get("pads", [0] * 2 * rank), rank)
        if rank == 1:  # pool a 1-D signal as a (1, L) image
            x, kernel, strides, pads = x[:, :, None], [1] + kernel, [1] + strides, \
                [(0, 0)] + pads
        pool = F.max_pool2d if len(kernel) == 2 else F.max_pool3d
        if not is_avg:
            out = pool(_pad_spatial(x, pads, value=-float("inf")), kernel, strides)
        else:
            sums = F.avg_pool2d if len(kernel) == 2 else F.avg_pool3d
            out = sums(_pad_spatial(x, pads), kernel, strides, divisor_override=1)
            if not node.attrs.get("count_include_pad", 0):
                ones = _pad_spatial(torch.ones_like(x), pads)
                out = out / sums(ones, kernel, strides, divisor_override=1)
            else:
                out = out / float(np.prod(kernel))
        return out[:, :, 0] if rank == 1 else out

    def op_MaxPool(self, node, x):
        return self._pool(node, x)

    def op_AveragePool(self, node, x):
        return self._pool(node, x, is_avg=True)

    def op_GlobalAveragePool(self, node, x):
        return x.mean(dim=tuple(range(2, x.ndim)), keepdim=True)

    # -- linear ------------------------------------------------------------

    def op_MatMul(self, node, a, b):
        if not isinstance(a, torch.Tensor):
            a = _tensor(a, _device_of(b)).float()
        return torch.matmul(a, _cast(b, a))

    def op_Gemm(self, node, a, b, c=None):
        alpha = node.attrs.get("alpha", 1.0)
        beta = node.attrs.get("beta", 1.0)
        if not isinstance(a, torch.Tensor):
            a = _tensor(a, _device_of(b, c)).float()
        b = _cast(b, a)
        if node.attrs.get("transA", 0):
            a = a.transpose(-1, -2)
        if node.attrs.get("transB", 0):
            b = b.transpose(-1, -2)
        # float32 products and sum, one rounding to the activation's dtype
        # at the end, as the JAX executor's preferred_element_type does.
        out = torch.matmul(a.float(), b.float()) * alpha
        if c is not None:
            out = out + beta * _tensor(c, a.device).float()
        return out.to(a.dtype)

    # -- shape machinery (constant-folded where possible) ------------------

    def op_Shape(self, node, x):
        shape = np.asarray(self._shape_of(x), dtype=np.int64)
        start = node.attrs.get("start", 0)
        end = node.attrs.get("end", len(shape))
        return shape[start:end]

    def op_Size(self, node, x):
        return np.asarray(int(np.prod(self._shape_of(x))), dtype=np.int64)

    def op_Constant(self, node):
        for key in ("value", "value_float", "value_int", "value_floats", "value_ints"):
            if key in node.attrs:
                return _np(node.attrs[key])
        raise ValueError("Constant node without value")

    def op_ConstantOfShape(self, node, shape):
        value = _np(node.attrs.get("value", np.zeros(1, dtype=np.float32)))
        return np.full(tuple(int(s) for s in _np(shape)), value.reshape(-1)[0],
                       dtype=value.dtype)

    def op_Cast(self, node, x):
        to = int(node.attrs["to"])
        if _is_const(x):
            return _np(x).astype(_NP_CAST.get(to, np.float32))
        return x.to(_DTYPE_MAP.get(to, torch.float32))

    def op_Identity(self, node, x):
        return x

    def op_Dropout(self, node, x, *rest):
        return x

    def op_Reshape(self, node, x, shape=None):
        target = node.attrs.get("shape", shape)
        target = [int(s) for s in _np(target).reshape(-1)]
        cur = self._shape_of(x)
        resolved = [cur[i] if s == 0 and node.attrs.get("allowzero", 0) == 0 else s
                    for i, s in enumerate(target)]
        if _is_const(x):
            return _np(x).reshape(resolved)
        return x.reshape(resolved)

    def op_Flatten(self, node, x):
        axis = node.attrs.get("axis", 1)
        shape = self._shape_of(x)
        if axis < 0:  # opset 11+: negative axis counts from the end
            axis += len(shape)
        lead = int(np.prod(shape[:axis])) if axis > 0 else 1
        return x.reshape(lead, -1)

    def op_Transpose(self, node, x):
        perm = node.attrs.get("perm")
        if perm is None:
            perm = list(range(len(self._shape_of(x))))[::-1]
        if _is_const(x):
            return _np(x).transpose(perm)
        return x.permute([int(p) for p in perm])

    def op_Unsqueeze(self, node, x, axes=None):
        axes = node.attrs.get("axes", axes)
        for a in sorted(int(a) for a in _np(axes).reshape(-1)):
            x = np.expand_dims(x, a) if _is_const(x) else x.unsqueeze(a)
        return x

    def op_Squeeze(self, node, x, axes=None):
        axes = node.attrs.get("axes", axes)
        if axes is None:
            axes_t = tuple(i for i, s in enumerate(self._shape_of(x)) if s == 1)
        else:
            axes_t = tuple(int(a) for a in _np(axes).reshape(-1))
        if _is_const(x):
            return np.squeeze(_np(x), axis=axes_t)
        return x.squeeze(axes_t)

    def op_Concat(self, node, *xs):
        axis = int(node.attrs["axis"])
        if all(_is_const(x) for x in xs):
            return np.concatenate([_np(x) for x in xs], axis=axis)
        return torch.cat(_promote(*xs), dim=axis)

    def op_Gather(self, node, x, indices):
        axis = int(node.attrs.get("axis", 0))
        if _is_const(x) and _is_const(indices):
            return np.take(_np(x), _np(indices).astype(np.int64), axis=axis)
        x = _tensor(x, _device_of(indices))
        axis %= x.ndim
        idx = _tensor(indices, x.device).long()
        idx = torch.where(idx < 0, idx + x.shape[axis], idx)
        out = torch.index_select(x, axis, idx.reshape(-1))
        return out.reshape(*x.shape[:axis], *idx.shape, *x.shape[axis + 1:])

    def op_Slice(self, node, x, starts=None, ends=None, axes=None, steps=None):
        # opset < 10 uses attributes
        starts = node.attrs.get("starts", starts)
        ends = node.attrs.get("ends", ends)
        axes = node.attrs.get("axes", axes)
        steps = steps if steps is not None else node.attrs.get("steps")
        starts = [int(v) for v in _np(starts).reshape(-1)]
        ends = [int(v) for v in _np(ends).reshape(-1)]
        axes = ([int(v) for v in _np(axes).reshape(-1)] if axes is not None
                else list(range(len(starts))))
        steps = ([int(v) for v in _np(steps).reshape(-1)] if steps is not None
                 else [1] * len(starts))
        shape = self._shape_of(x)
        slices = [slice(None)] * len(shape)
        for st, en, ax, sp in zip(starts, ends, axes, steps):
            # clamp ONNX INT64_MAX-style sentinels
            en = None if en >= (1 << 62) else en
            slices[ax] = slice(st, en, sp)
        if _is_const(x):
            return _np(x)[tuple(slices)]
        for ax, sl in enumerate(slices):  # torch slices step forward only
            if sl.step is not None and sl.step < 0:
                idx = torch.arange(*sl.indices(shape[ax]), device=x.device)
                x = torch.index_select(x, ax, idx)
                slices[ax] = slice(None)
        return x[tuple(slices)]

    def op_Split(self, node, x, split=None):
        axis = int(node.attrs.get("axis", 0))
        split = node.attrs.get("split", split)
        size = self._shape_of(x)[axis]
        if split is None:
            num = len(node.outputs)
            split = [size // num] * num
        else:
            split = [int(s) for s in _np(split).reshape(-1)]
        if _is_const(x):
            return np.split(_np(x), np.cumsum(split)[:-1], axis=axis)
        return list(torch.split(x, split, dim=axis))

    def op_Pad(self, node, x, pads=None, value=None, axes=None):
        mode = node.attrs.get("mode", "constant")
        pads = node.attrs.get("pads", pads)
        pads = [int(p) for p in _np(pads).reshape(-1)]
        rank = x.ndim
        if axes is not None:
            axes_l = [int(a) % rank for a in _np(axes).reshape(-1)]
        else:
            axes_l = list(range(rank))
        pad_width = [(0, 0)] * rank
        half = len(pads) // 2
        for i, ax in enumerate(axes_l):
            pad_width[ax] = (pads[i], pads[i + half])
        if mode == "constant":
            cval = float(_np(value).reshape(-1)[0]) if value is not None else \
                float(node.attrs.get("value", 0.0))
            return _pad_spatial(x, pad_width, value=cval)
        np_mode = {"reflect": "reflect", "edge": "edge", "wrap": "wrap"}[mode]
        for ax, (b, e) in enumerate(pad_width):
            if b or e:  # numpy's padding of the index vector, gathered
                idx = np.pad(np.arange(x.shape[ax]), (b, e), mode=np_mode)
                x = torch.index_select(x, ax, torch.as_tensor(idx, device=x.device))
        return x

    def op_Expand(self, node, x, shape):
        target = [int(s) for s in _np(shape).reshape(-1)]
        cur = list(self._shape_of(x))
        # ONNX Expand uses numpy broadcasting; -1/1 handling
        while len(cur) < len(target):
            cur.insert(0, 1)
        out_shape = [max(c, t) if t != 1 else c for c, t in zip(cur, target)]
        if _is_const(x):
            return np.broadcast_to(_np(x).reshape(cur), out_shape)
        return torch.broadcast_to(x.reshape(cur), out_shape)

    def op_Tile(self, node, x, repeats):
        reps = [int(r) for r in _np(repeats).reshape(-1)]
        if _is_const(x):
            return np.tile(_np(x), reps)
        return torch.tile(x, reps)

    def op_Range(self, node, start, limit, delta):
        # dtype follows the inputs (ONNX spec); int() coercion would corrupt
        # float ranges (e.g. positional encodings with fractional deltas).
        s0, l0, d0 = (_np(start).reshape(()), _np(limit).reshape(()),
                      _np(delta).reshape(()))
        return np.arange(s0, l0, d0, dtype=np.result_type(s0, l0, d0))

    def op_Resize(self, node, x, roi=None, scales=None, sizes=None):
        mode = node.attrs.get("mode", "nearest")
        coord = node.attrs.get("coordinate_transformation_mode", "half_pixel")
        # Half-pixel sampling, as jax.image.resize does; pytorch_half_pixel
        # only differs when an output dim is 1, and asymmetric matches for
        # nearest upsampling by integral factors (the Conv-TDF decoder
        # pattern). Anything else would silently shift feature maps.
        if coord not in ("half_pixel", "pytorch_half_pixel", "asymmetric"):
            raise NotImplementedError(
                f"Resize coordinate_transformation_mode={coord!r} not supported")
        in_shape = self._shape_of(x)
        if sizes is not None:
            out_shape = [int(s) for s in _np(sizes).reshape(-1)]
        else:
            sc = _np(scales).reshape(-1)
            # ONNX mandates floor(dim * scale) for scale-derived sizes.
            out_shape = [int(np.floor(d * s)) for d, s in zip(in_shape, sc)]
        kernel = {"nearest": None, "linear": _triangle, "cubic": _keys_cubic}[mode]
        for d, (m, n) in enumerate(zip(in_shape, out_shape)):
            if m == n:
                continue
            if kernel is None:
                pos = (np.arange(n, dtype=np.float32) + np.float32(0.5)) * np.float32(m) \
                    / np.float32(n)
                idx = torch.as_tensor(np.floor(pos).astype(np.int64), device=x.device)
                x = torch.index_select(x, d, idx)
            else:
                if not x.is_floating_point():
                    x = x.float()
                w = torch.as_tensor(_resize_weights(m, n, kernel), dtype=x.dtype,
                                    device=x.device)
                x = torch.movedim(torch.tensordot(x, w, dims=([d], [0])), -1, d)
        return x


def onnx_to_torch(path: str, device="cuda"):
    """Load an .onnx file → (fn, params, input_names, output_names), the
    params (initializers) as tensors on ``device``."""
    conv = OnnxToTorch(load_model(path))
    return (conv.make_fn(), convert_onnx_params(conv.params, device=device),
            conv.input_names, conv.output_names)
