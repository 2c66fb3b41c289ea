"""Minimal ONNX protobuf writer.

Copy of ``thingino_accel_tpu/formats/onnx_writer.py`` (numpy only), so
that the port imports nothing of the JAX package.

The reference's decompiler hand-rolls ONNX serialization in Rust
(``mgk-decompiler/src/onnx_export.rs``: "Hand-rolled ONNX protobuf
writer"); this is the same capability for the framework — exporting
IR graphs (or ad-hoc test graphs) as ONNX files, dependency-free.

Only the wire-format subset the importer reads is emitted: ModelProto
{ir_version, opset_import, graph}, GraphProto {node, initializer,
input, output}, NodeProto {input, output, op_type, name, attribute},
AttributeProto {name, i/f/s/t/ints/floats, type}, TensorProto
{dims, data_type, raw_data, name}.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from thingino_accel_tpu_torch.formats import onnx_proto as OP

_NP_TO_TP = {
    np.dtype(np.float32): OP.TP_FLOAT,
    np.dtype(np.uint8): OP.TP_UINT8,
    np.dtype(np.int8): OP.TP_INT8,
    np.dtype(np.int16): OP.TP_INT16,
    np.dtype(np.int32): OP.TP_INT32,
    np.dtype(np.int64): OP.TP_INT64,
    np.dtype(np.float16): OP.TP_FLOAT16,
    np.dtype(np.float64): OP.TP_DOUBLE,
    np.dtype(np.bool_): OP.TP_BOOL,
}

# AttributeProto.AttributeType
_AT_FLOAT, _AT_INT, _AT_STRING, _AT_TENSOR = 1, 2, 3, 4
_AT_FLOATS, _AT_INTS = 6, 7


def _varint(v: int) -> bytes:
    out = bytearray()
    v &= (1 << 64) - 1
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(fnum: int, wt: int) -> bytes:
    return _varint((fnum << 3) | wt)


def _ld(fnum: int, payload: bytes) -> bytes:
    return _key(fnum, 2) + _varint(len(payload)) + payload


def _vi(fnum: int, v: int) -> bytes:
    return _key(fnum, 0) + _varint(v)


def _f32(fnum: int, v: float) -> bytes:
    return _key(fnum, 5) + struct.pack("<f", v)


def _s(fnum: int, s: str) -> bytes:
    return _ld(fnum, s.encode("utf-8"))


def tensor_proto(name: str, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    out = b""
    for d in arr.shape:
        out += _vi(1, d)
    out += _vi(2, _NP_TO_TP[arr.dtype])
    out += _s(8, name)
    out += _ld(9, arr.tobytes())
    return out


def attribute(name: str, value) -> bytes:
    out = _s(1, name)
    if isinstance(value, bool):
        out += _vi(3, int(value)) + _vi(20, _AT_INT)
    elif isinstance(value, int):
        out += _vi(3, value) + _vi(20, _AT_INT)
    elif isinstance(value, float):
        out += _f32(2, value) + _vi(20, _AT_FLOAT)
    elif isinstance(value, str):
        out += _ld(4, value.encode()) + _vi(20, _AT_STRING)
    elif isinstance(value, bytes):
        out += _ld(4, value) + _vi(20, _AT_STRING)
    elif isinstance(value, np.ndarray):
        out += _ld(5, tensor_proto("", value)) + _vi(20, _AT_TENSOR)
    elif isinstance(value, (tuple, list)):
        if value and isinstance(value[0], float):
            for v in value:
                out += _f32(7, v)
            out += _vi(20, _AT_FLOATS)
        else:
            for v in value:
                out += _vi(8, int(v))
            out += _vi(20, _AT_INTS)
    else:
        raise TypeError(f"unsupported attribute {name}={value!r}")
    return out


def node(op_type: str, inputs: Sequence[str], outputs: Sequence[str],
         name: str = "", **attrs) -> bytes:
    out = b""
    for i in inputs:
        out += _s(1, i)
    for o in outputs:
        out += _s(2, o)
    if name:
        out += _s(3, name)
    out += _s(4, op_type)
    for k, v in attrs.items():
        out += _ld(5, attribute(k, v))
    return out


def value_info(name: str, shape: Sequence[int],
               elem_type: int = OP.TP_FLOAT) -> bytes:
    dims = b""
    for d in shape:
        dims += _ld(1, _vi(1, d))          # Dimension{dim_value}
    shape_p = dims
    tensor_type = _vi(1, elem_type) + _ld(2, shape_p)
    type_p = _ld(1, tensor_type)
    return _s(1, name) + _ld(2, type_p)


def graph(nodes: Sequence[bytes],
          inputs: Sequence[bytes],
          outputs: Sequence[bytes],
          initializers: Sequence[bytes] = (),
          name: str = "g") -> bytes:
    out = b""
    for n in nodes:
        out += _ld(1, n)
    out += _s(2, name)
    for t in initializers:
        out += _ld(5, t)
    for i in inputs:
        out += _ld(11, i)
    for o in outputs:
        out += _ld(12, o)
    return out


def model(graph_bytes: bytes) -> bytes:
    """A ModelProto of IR version 8 at opset 13 around ``graph_bytes``."""
    opset_p = _s(1, "") + _vi(2, 13)
    return _vi(1, 8) + _ld(7, graph_bytes) + _ld(8, opset_p)


def build_model(
    nodes: Sequence[Tuple],               # (op, ins, outs, attrs_dict)
    inputs: Dict[str, Tuple[Sequence[int], int]],
    outputs: Dict[str, Tuple[Sequence[int], int]],
    initializers: Dict[str, np.ndarray],
) -> bytes:
    """Convenience: assemble a complete ONNX model file from parts."""
    nb = [node(op, ins, outs, **(attrs or {}))
          for (op, ins, outs, attrs) in nodes]
    ib = [value_info(k, s, t) for k, (s, t) in inputs.items()]
    ob = [value_info(k, s, t) for k, (s, t) in outputs.items()]
    tb = [tensor_proto(k, v) for k, v in initializers.items()]
    return model(graph(nb, ib, ob, tb))
