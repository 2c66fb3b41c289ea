"""Minimal ONNX protobuf decoding — no `onnx` package, no protoc.

Copy of ``thingino_accel_tpu/formats/onnx_proto.py`` (numpy only), so
that the port imports nothing of the JAX package.

Hand-rolled wire-format reader covering exactly the message fields the
importer needs (the reference does the same with prost-generated structs,
``mars-compiler/src/onnx_parser.rs:80-235``; here it's a generic
tag/wire-type walker plus typed views).

Wire format: each field = key varint (field_number << 3 | wire_type);
wire types used by ONNX: 0 varint, 1 fixed64, 2 length-delimited,
5 fixed32.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def _signed(v: int) -> int:
    """Interpret a varint as two's-complement int64."""
    if v >= 1 << 63:
        v -= 1 << 64
    return v


def iter_fields(buf: memoryview):
    """Yield (field_number, wire_type, value) over a message buffer.

    value is int for varint/fixed, memoryview for length-delimited.
    """
    pos = 0
    end = len(buf)
    while pos < end:
        key, pos = _read_varint(buf, pos)
        fnum, wt = key >> 3, key & 7
        if wt == 0:
            v, pos = _read_varint(buf, pos)
            yield fnum, wt, v
        elif wt == 1:
            yield fnum, wt, struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        elif wt == 2:
            ln, pos = _read_varint(buf, pos)
            yield fnum, wt, buf[pos:pos + ln]
            pos += ln
        elif wt == 5:
            yield fnum, wt, struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")


def _packed_varints(buf: memoryview) -> List[int]:
    out = []
    pos = 0
    while pos < len(buf):
        v, pos = _read_varint(buf, pos)
        out.append(_signed(v))
    return out


# ONNX TensorProto.DataType
TP_FLOAT = 1
TP_UINT8 = 2
TP_INT8 = 3
TP_UINT16 = 4
TP_INT16 = 5
TP_INT32 = 6
TP_INT64 = 7
TP_BOOL = 9
TP_FLOAT16 = 10
TP_DOUBLE = 11
TP_UINT32 = 12
TP_UINT64 = 13

_NP_DTYPE = {
    TP_FLOAT: np.float32, TP_UINT8: np.uint8, TP_INT8: np.int8,
    TP_UINT16: np.uint16, TP_INT16: np.int16, TP_INT32: np.int32,
    TP_INT64: np.int64, TP_BOOL: np.bool_, TP_FLOAT16: np.float16,
    TP_DOUBLE: np.float64, TP_UINT32: np.uint32, TP_UINT64: np.uint64,
}


@dataclass
class Tensor:
    """TensorProto: name, dims, numpy array."""

    name: str = ""
    dims: Tuple[int, ...] = ()
    data_type: int = TP_FLOAT
    array: Optional[np.ndarray] = None


def parse_tensor(buf: memoryview) -> Tensor:
    dims: List[int] = []
    data_type = TP_FLOAT
    name = ""
    raw: Optional[bytes] = None
    float_data: List[float] = []
    int32_data: List[int] = []
    int64_data: List[int] = []
    double_data: List[float] = []
    for fnum, wt, v in iter_fields(buf):
        if fnum == 1:
            if wt == 0:
                dims.append(_signed(v))
            else:
                dims.extend(_packed_varints(v))
        elif fnum == 2 and wt == 0:
            data_type = v
        elif fnum == 4:   # float_data
            if wt == 5:
                float_data.append(struct.unpack("<f", struct.pack("<I", v))[0])
            else:
                float_data.extend(np.frombuffer(v, "<f4").tolist())
        elif fnum == 5:   # int32_data (also int8/16/fp16 storage)
            if wt == 0:
                int32_data.append(_signed(v))
            else:
                int32_data.extend(_packed_varints(v))
        elif fnum == 7:   # int64_data
            if wt == 0:
                int64_data.append(_signed(v))
            else:
                int64_data.extend(_packed_varints(v))
        elif fnum == 8 and wt == 2:
            name = bytes(v).decode("utf-8", "replace")
        elif fnum == 9 and wt == 2:
            raw = bytes(v)
        elif fnum == 10:  # double_data
            if wt == 1:
                double_data.append(struct.unpack("<d", struct.pack("<Q", v))[0])
            else:
                double_data.extend(np.frombuffer(v, "<f8").tolist())
    np_dt = _NP_DTYPE.get(data_type, np.float32)
    shape = tuple(dims)
    arr: Optional[np.ndarray] = None
    if raw is not None:
        arr = np.frombuffer(raw, dtype=np_dt)
    elif float_data:
        arr = np.asarray(float_data, np.float32)
    elif double_data:
        arr = np.asarray(double_data, np.float64)
    elif int64_data:
        arr = np.asarray(int64_data, np.int64)
    elif int32_data:
        # int32_data stores int8/16/fp16 values widened per spec
        arr = np.asarray(int32_data, np.int32).astype(np_dt)
    if arr is not None:
        numel = int(np.prod(shape)) if shape else arr.size
        arr = arr[:numel].reshape(shape)
    return Tensor(name=name, dims=shape, data_type=data_type, array=arr)


@dataclass
class Attribute:
    name: str = ""
    f: Optional[float] = None
    i: Optional[int] = None
    s: Optional[bytes] = None
    t: Optional[Tensor] = None
    floats: Tuple[float, ...] = ()
    ints: Tuple[int, ...] = ()


def parse_attribute(buf: memoryview) -> Attribute:
    a = Attribute()
    floats: List[float] = []
    ints: List[int] = []
    for fnum, wt, v in iter_fields(buf):
        if fnum == 1 and wt == 2:
            a.name = bytes(v).decode("utf-8", "replace")
        elif fnum == 2 and wt == 5:
            a.f = struct.unpack("<f", struct.pack("<I", v))[0]
        elif fnum == 3 and wt == 0:
            a.i = _signed(v)
        elif fnum == 4 and wt == 2:
            a.s = bytes(v)
        elif fnum == 5 and wt == 2:
            a.t = parse_tensor(v)
        elif fnum == 7:   # floats (6 is the subgraph field)
            if wt == 5:
                floats.append(struct.unpack("<f", struct.pack("<I", v))[0])
            else:
                floats.extend(np.frombuffer(v, "<f4").tolist())
        elif fnum == 8:   # ints
            if wt == 0:
                ints.append(_signed(v))
            else:
                ints.extend(_packed_varints(v))
    a.floats = tuple(floats)
    a.ints = tuple(ints)
    return a


@dataclass
class NodeProto:
    op_type: str = ""
    name: str = ""
    inputs: Tuple[str, ...] = ()
    outputs: Tuple[str, ...] = ()
    attrs: Dict[str, Attribute] = field(default_factory=dict)

    def attr_i(self, name: str, default: int = 0) -> int:
        a = self.attrs.get(name)
        return a.i if a and a.i is not None else default

    def attr_f(self, name: str, default: float = 0.0) -> float:
        a = self.attrs.get(name)
        return a.f if a and a.f is not None else default

    def attr_ints(self, name: str, default=()) -> Tuple[int, ...]:
        a = self.attrs.get(name)
        return a.ints if a and a.ints else tuple(default)

    def attr_s(self, name: str, default: str = "") -> str:
        a = self.attrs.get(name)
        return a.s.decode() if a and a.s is not None else default


def parse_node(buf: memoryview) -> NodeProto:
    n = NodeProto()
    ins: List[str] = []
    outs: List[str] = []
    for fnum, wt, v in iter_fields(buf):
        if fnum == 1 and wt == 2:
            ins.append(bytes(v).decode("utf-8", "replace"))
        elif fnum == 2 and wt == 2:
            outs.append(bytes(v).decode("utf-8", "replace"))
        elif fnum == 3 and wt == 2:
            n.name = bytes(v).decode("utf-8", "replace")
        elif fnum == 4 and wt == 2:
            n.op_type = bytes(v).decode("utf-8", "replace")
        elif fnum == 5 and wt == 2:
            a = parse_attribute(v)
            n.attrs[a.name] = a
    n.inputs = tuple(ins)
    n.outputs = tuple(outs)
    return n


def _parse_value_info(buf: memoryview) -> Tuple[str, Tuple[int, ...], int]:
    """ValueInfoProto -> (name, shape (0 for dynamic dims), elem_type)."""
    name = ""
    shape: Tuple[int, ...] = ()
    elem = 0
    for fnum, wt, v in iter_fields(buf):
        if fnum == 1 and wt == 2:
            name = bytes(v).decode("utf-8", "replace")
        elif fnum == 2 and wt == 2:       # TypeProto
            for f2, w2, v2 in iter_fields(v):
                if f2 == 1 and w2 == 2:   # tensor_type
                    dims: List[int] = []
                    for f3, w3, v3 in iter_fields(v2):
                        if f3 == 1 and w3 == 0:
                            elem = v3
                        elif f3 == 2 and w3 == 2:  # TensorShapeProto
                            for f4, w4, v4 in iter_fields(v3):
                                if f4 == 1 and w4 == 2:   # Dimension
                                    dv = 0
                                    for f5, w5, v5 in iter_fields(v4):
                                        if f5 == 1 and w5 == 0:
                                            dv = _signed(v5)
                                    dims.append(dv)
                    shape = tuple(dims)
    return name, shape, elem


@dataclass
class GraphProto:
    nodes: List[NodeProto] = field(default_factory=list)
    initializers: Dict[str, Tensor] = field(default_factory=dict)
    inputs: List[Tuple[str, Tuple[int, ...], int]] = field(default_factory=list)
    outputs: List[Tuple[str, Tuple[int, ...], int]] = field(default_factory=list)
    value_infos: Dict[str, Tuple[Tuple[int, ...], int]] = field(
        default_factory=dict)
    name: str = ""


def parse_graph(buf: memoryview) -> GraphProto:
    g = GraphProto()
    for fnum, wt, v in iter_fields(buf):
        if fnum == 1 and wt == 2:
            g.nodes.append(parse_node(v))
        elif fnum == 2 and wt == 2:
            g.name = bytes(v).decode("utf-8", "replace")
        elif fnum == 5 and wt == 2:
            t = parse_tensor(v)
            g.initializers[t.name] = t
        elif fnum == 11 and wt == 2:
            g.inputs.append(_parse_value_info(v))
        elif fnum == 12 and wt == 2:
            g.outputs.append(_parse_value_info(v))
        elif fnum == 13 and wt == 2:
            nm, shape, el = _parse_value_info(v)
            g.value_infos[nm] = (shape, el)
    return g


@dataclass
class ModelProto:
    graph: GraphProto
    ir_version: int = 0
    opset: int = 0


def parse_model(data: bytes) -> ModelProto:
    buf = memoryview(data)
    graph: Optional[GraphProto] = None
    ir_version = 0
    opset = 0
    for fnum, wt, v in iter_fields(buf):
        if fnum == 1 and wt == 0:
            ir_version = v
        elif fnum == 7 and wt == 2:
            graph = parse_graph(v)
        elif fnum == 8 and wt == 2:   # OperatorSetIdProto
            for f2, w2, v2 in iter_fields(v):
                if f2 == 2 and w2 == 0:
                    opset = max(opset, v2)
    if graph is None:
        raise ValueError("no graph in ONNX model")
    return ModelProto(graph=graph, ir_version=ir_version, opset=opset)


def load(path_or_bytes) -> ModelProto:
    if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
        return parse_model(bytes(path_or_bytes))
    with open(path_or_bytes, "rb") as f:
        return parse_model(f.read())
