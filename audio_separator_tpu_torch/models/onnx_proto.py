"""Minimal ONNX protobuf reader (pure Python, no onnx/protoc dependency).

The reference runs MDX ``.onnx`` checkpoints through ONNX Runtime (C++)
(ref: mdx_separator.py:108-133). This package interprets the ONNX graph as a
function of torch tensors (``models/onnx_torch.py``); this module, the
package's own copy of the JAX package's ``models/onnx_proto.py``, provides
the deserialisation layer: a generic protobuf wire-format decoder plus the
ONNX message schemas needed to read ModelProto files.

Only the fields the converter consumes are mapped; unknown fields are skipped
per protobuf rules, so files produced by any exporter/opset parse fine.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

# --------------------------------------------------------------------------
# Generic wire-format decoding


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _skip_field(buf: bytes, pos: int, wire_type: int) -> int:
    if wire_type == 0:
        _, pos = _read_varint(buf, pos)
    elif wire_type == 1:
        pos += 8
    elif wire_type == 2:
        length, pos = _read_varint(buf, pos)
        pos += length
    elif wire_type == 5:
        pos += 4
    else:
        raise ValueError(f"unsupported wire type {wire_type}")
    return pos


def _iter_fields(buf: bytes):
    pos = 0
    end = len(buf)
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        field_num = tag >> 3
        wire_type = tag & 7
        if wire_type == 0:
            value, pos = _read_varint(buf, pos)
        elif wire_type == 1:
            value = buf[pos : pos + 8]
            pos += 8
        elif wire_type == 2:
            length, pos = _read_varint(buf, pos)
            value = buf[pos : pos + length]
            pos += length
        elif wire_type == 5:
            value = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire_type} (field {field_num})")
        yield field_num, wire_type, value


def _to_signed(value: int) -> int:
    # protobuf int64 varints are two's-complement in 64 bits
    return value - (1 << 64) if value >= (1 << 63) else value


def _unpack_packed_varints(data: bytes) -> List[int]:
    out, pos = [], 0
    while pos < len(data):
        v, pos = _read_varint(data, pos)
        out.append(_to_signed(v))
    return out


# --------------------------------------------------------------------------
# ONNX message structures (field numbers per the public onnx.proto3 schema)


@dataclass
class TensorInfo:
    name: str = ""
    dims: List[int] = field(default_factory=list)
    data_type: int = 0
    _raw: Optional[bytes] = None
    _float_data: List[float] = field(default_factory=list)
    _int64_data: List[int] = field(default_factory=list)
    _int32_data: List[int] = field(default_factory=list)
    _double_data: List[float] = field(default_factory=list)

    _DTYPES = {
        1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
        6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
        12: np.uint32, 13: np.uint64, 16: None,  # bfloat16 handled specially
    }

    def to_numpy(self) -> np.ndarray:
        shape = tuple(self.dims)
        if self._raw is not None:
            if self.data_type == 16:  # bfloat16: widen via int16 << 16
                u16 = np.frombuffer(self._raw, dtype="<u2")
                arr = (u16.astype(np.uint32) << 16).view(np.float32)
            else:
                dtype = self._DTYPES.get(self.data_type)
                if dtype is None:
                    raise ValueError(f"unsupported tensor data_type {self.data_type}")
                arr = np.frombuffer(self._raw, dtype=np.dtype(dtype).newbyteorder("<"))
            return arr.reshape(shape)
        if self._float_data:
            return np.asarray(self._float_data, dtype=np.float32).reshape(shape)
        if self._int64_data:
            return np.asarray(self._int64_data, dtype=np.int64).reshape(shape)
        if self._int32_data:
            dtype = self._DTYPES.get(self.data_type, np.int32)
            return np.asarray(self._int32_data, dtype=np.int32).astype(dtype).reshape(shape)
        if self._double_data:
            return np.asarray(self._double_data, dtype=np.float64).reshape(shape)
        return np.zeros(shape, dtype=self._DTYPES.get(self.data_type, np.float32))


def _parse_tensor(buf: bytes) -> TensorInfo:
    t = TensorInfo()
    for num, wt, val in _iter_fields(buf):
        if num == 1:
            if wt == 2:
                t.dims.extend(_unpack_packed_varints(val))
            else:
                t.dims.append(_to_signed(val))
        elif num == 2:
            t.data_type = val
        elif num == 4:
            if wt == 2:
                t._float_data.extend(struct.unpack(f"<{len(val) // 4}f", val))
            else:
                t._float_data.append(struct.unpack("<f", val)[0])
        elif num == 5:
            if wt == 2:
                t._int32_data.extend(_unpack_packed_varints(val))
            else:
                t._int32_data.append(_to_signed(val))
        elif num == 7:
            if wt == 2:
                t._int64_data.extend(_unpack_packed_varints(val))
            else:
                t._int64_data.append(_to_signed(val))
        elif num == 8:
            t.name = val.decode("utf-8")
        elif num == 9:
            t._raw = val
        elif num == 10:
            if wt == 2:
                t._double_data.extend(struct.unpack(f"<{len(val) // 8}d", val))
            else:
                t._double_data.append(struct.unpack("<d", val)[0])
    return t


@dataclass
class Attribute:
    name: str = ""
    type: int = 0
    f: float = 0.0
    i: int = 0
    s: bytes = b""
    t: Optional[TensorInfo] = None
    floats: List[float] = field(default_factory=list)
    ints: List[int] = field(default_factory=list)
    strings: List[bytes] = field(default_factory=list)

    def value(self) -> Any:
        # AttributeProto.AttributeType: 1 FLOAT, 2 INT, 3 STRING, 4 TENSOR,
        # 6 FLOATS, 7 INTS, 8 STRINGS
        if self.type == 1:
            return self.f
        if self.type == 2:
            return self.i
        if self.type == 3:
            return self.s.decode("utf-8")
        if self.type == 4:
            return self.t.to_numpy() if self.t else None
        if self.type == 6:
            return list(self.floats)
        if self.type == 7:
            return list(self.ints)
        if self.type == 8:
            return [s.decode("utf-8") for s in self.strings]
        # Fall back to whichever field is populated (exporters at opset<3
        # sometimes omit type).
        for candidate in (self.ints, self.floats):
            if candidate:
                return list(candidate)
        if self.t is not None:
            return self.t.to_numpy()
        if self.s:
            return self.s.decode("utf-8")
        return self.i or self.f


def _parse_attribute(buf: bytes) -> Attribute:
    a = Attribute()
    for num, wt, val in _iter_fields(buf):
        if num == 1:
            a.name = val.decode("utf-8")
        elif num == 2:
            a.f = struct.unpack("<f", val)[0]
        elif num == 3:
            a.i = _to_signed(val)
        elif num == 4:
            a.s = val
        elif num == 5:
            a.t = _parse_tensor(val)
        elif num == 7:
            if wt == 2:
                a.floats.extend(struct.unpack(f"<{len(val) // 4}f", val))
            else:
                a.floats.append(struct.unpack("<f", val)[0])
        elif num == 8:
            if wt == 2:
                a.ints.extend(_unpack_packed_varints(val))
            else:
                a.ints.append(_to_signed(val))
        elif num == 9:
            a.strings.append(val)
        elif num == 20:
            a.type = val
    return a


@dataclass
class Node:
    op_type: str = ""
    name: str = ""
    inputs: List[str] = field(default_factory=list)
    outputs: List[str] = field(default_factory=list)
    attrs: Dict[str, Any] = field(default_factory=dict)


def _parse_node(buf: bytes) -> Node:
    n = Node()
    for num, _wt, val in _iter_fields(buf):
        if num == 1:
            n.inputs.append(val.decode("utf-8"))
        elif num == 2:
            n.outputs.append(val.decode("utf-8"))
        elif num == 3:
            n.name = val.decode("utf-8")
        elif num == 4:
            n.op_type = val.decode("utf-8")
        elif num == 5:
            attr = _parse_attribute(val)
            n.attrs[attr.name] = attr.value()
    return n


@dataclass
class ValueInfo:
    name: str = ""
    elem_type: int = 0
    shape: List[Optional[int]] = field(default_factory=list)


def _parse_value_info(buf: bytes) -> ValueInfo:
    v = ValueInfo()
    for num, _wt, val in _iter_fields(buf):
        if num == 1:
            v.name = val.decode("utf-8")
        elif num == 2:  # TypeProto
            for tnum, _twt, tval in _iter_fields(val):
                if tnum == 1:  # tensor_type
                    for fnum, _fwt, fval in _iter_fields(tval):
                        if fnum == 1:
                            v.elem_type = fval
                        elif fnum == 2:  # TensorShapeProto
                            for snum, _swt, sval in _iter_fields(fval):
                                if snum == 1:  # Dimension
                                    dim_value: Optional[int] = None
                                    for dnum, _dwt, dval in _iter_fields(sval):
                                        if dnum == 1:
                                            dim_value = _to_signed(dval)
                                    v.shape.append(dim_value)
    return v


@dataclass
class Graph:
    name: str = ""
    nodes: List[Node] = field(default_factory=list)
    initializers: Dict[str, np.ndarray] = field(default_factory=dict)
    inputs: List[ValueInfo] = field(default_factory=list)
    outputs: List[ValueInfo] = field(default_factory=list)


def _parse_graph(buf: bytes) -> Graph:
    g = Graph()
    for num, _wt, val in _iter_fields(buf):
        if num == 1:
            g.nodes.append(_parse_node(val))
        elif num == 2:
            g.name = val.decode("utf-8")
        elif num == 5:
            tensor = _parse_tensor(val)
            g.initializers[tensor.name] = tensor.to_numpy()
        elif num == 11:
            g.inputs.append(_parse_value_info(val))
        elif num == 12:
            g.outputs.append(_parse_value_info(val))
    return g


@dataclass
class Model:
    ir_version: int = 0
    opset: int = 0
    graph: Optional[Graph] = None


def parse_model(data: bytes) -> Model:
    m = Model()
    for num, _wt, val in _iter_fields(data):
        if num == 1:
            m.ir_version = _to_signed(val)
        elif num == 7:
            m.graph = _parse_graph(val)
        elif num == 8:  # OperatorSetIdProto
            for onum, _owt, oval in _iter_fields(val):
                if onum == 2:
                    m.opset = max(m.opset, _to_signed(oval))
    if m.graph is None:
        raise ValueError("no graph found in ONNX model")
    return m


def load_model(path: str) -> Model:
    with open(path, "rb") as f:
        return parse_model(f.read())
