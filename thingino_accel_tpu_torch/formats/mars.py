"""`.mars` binary model format: reader and writer.

Copy of ``thingino_accel_tpu/formats/mars.py`` (numpy only), so that the
port imports nothing of the JAX package.

The `.mars` file is the reference stack's own model format (spec:
``include/mars.h``; ground-truth packed struct sizes documented in
``tools/mars_gen_test.py:8-12``):

    +------------------+
    | header           |  76 bytes
    +------------------+
    | tensor descs     |  num_tensors * 124 bytes
    +------------------+
    | layer descs      |  num_layers * 112 bytes
    +------------------+
    | weight blob      |  64-byte aligned, raw little-endian
    +------------------+

NOTE the size comments inside ``include/mars.h`` (64/64/128) are wrong —
the structs are ``__attribute__((packed))`` and their true sizes are
76/124/112, which is what the bundled models and the runtime
(``src/mars/mars_runtime.c:137-201``) actually use.

This module is a faithful, dependency-free parser/serializer producing
plain dataclasses + numpy arrays.  Graph-level interpretation (shape
inference, weight unpacking, fusion) lives in ``thingino_accel_tpu_torch.ir``.
"""

from __future__ import annotations

import enum
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

MARS_MAGIC = 0x5352414D  # "MARS" little-endian
VERSION_MAJOR = 1
VERSION_MINOR = 0

HEADER_SIZE = 76
TENSOR_SIZE = 124
LAYER_SIZE = 112
MAX_DIMS = 6
NO_TENSOR = 0xFFFFFFFF


class DType(enum.IntEnum):
    """mars_dtype_t (``include/mars.h:35-42``)."""

    FLOAT32 = 0
    INT32 = 1
    INT16 = 2
    INT8 = 3
    UINT8 = 4
    UINT4 = 5

    @property
    def np(self) -> np.dtype:
        return {
            DType.FLOAT32: np.dtype(np.float32),
            DType.INT32: np.dtype(np.int32),
            DType.INT16: np.dtype(np.int16),
            DType.INT8: np.dtype(np.int8),
            DType.UINT8: np.dtype(np.uint8),
            DType.UINT4: np.dtype(np.uint8),  # 2 elems / byte, caller unpacks
        }[self]

    @property
    def itemsize(self) -> int:
        return {DType.UINT4: 1}.get(self, self.np.itemsize)


class Format(enum.IntEnum):
    """mars_format_t (``include/mars.h:46-56``)."""

    NCHW = 0
    NDHWC32 = 1
    HWIO = 2
    NMHWSOIB2 = 3
    NMC32 = 4
    D1 = 5
    OHWI = 6
    NHWC = 7
    OIHW = 8


class LayerType(enum.IntEnum):
    """mars_layer_type_t (``include/mars.h:59-79``)."""

    CONV2D = 0
    DEPTHWISE_CONV2D = 1
    MAXPOOL = 2
    AVGPOOL = 3
    GLOBAL_AVGPOOL = 4
    RELU = 5
    RELU6 = 6
    LEAKY_RELU = 7
    SILU = 8
    SIGMOID = 9
    CONCAT = 10
    ADD = 11
    MUL = 12
    UPSAMPLE = 13
    RESHAPE = 14
    SOFTMAX = 15
    FC = 16
    TRANSPOSE = 17
    BATCHNORM = 18


class Activation(enum.IntEnum):
    """mars_activation_t — activations fusable into conv/fc (``include/mars.h:82-91``)."""

    NONE = 0
    RELU = 1
    RELU6 = 2
    LEAKY_RELU = 3
    SILU = 4
    SIGMOID = 5
    TANH = 6
    HARD_SWISH = 7


class Padding(enum.IntEnum):
    """mars_padding_t (``include/mars.h:94-98``)."""

    VALID = 0
    SAME = 1
    EXPLICIT = 2


@dataclass
class ConvParams:
    """mars_conv_params_t (``include/mars.h:139-155``)."""

    kernel_h: int = 1
    kernel_w: int = 1
    stride_h: int = 1
    stride_w: int = 1
    dilation_h: int = 1
    dilation_w: int = 1
    padding: Padding = Padding.VALID
    pad_top: int = 0
    pad_bottom: int = 0
    pad_left: int = 0
    pad_right: int = 0
    groups: int = 1
    activation: Activation = Activation.NONE
    weight_tensor_id: int = NO_TENSOR
    bias_tensor_id: int = NO_TENSOR

    _FMT = "<6Ii4IIiII"

    def pack(self) -> bytes:
        return struct.pack(
            self._FMT,
            self.kernel_h, self.kernel_w, self.stride_h, self.stride_w,
            self.dilation_h, self.dilation_w, int(self.padding),
            self.pad_top, self.pad_bottom, self.pad_left, self.pad_right,
            self.groups, int(self.activation),
            self.weight_tensor_id, self.bias_tensor_id,
        )

    @classmethod
    def unpack(cls, raw: bytes) -> "ConvParams":
        vals = struct.unpack_from(cls._FMT, raw, 0)
        return cls(
            kernel_h=vals[0], kernel_w=vals[1], stride_h=vals[2],
            stride_w=vals[3], dilation_h=vals[4], dilation_w=vals[5],
            padding=Padding(vals[6]), pad_top=vals[7], pad_bottom=vals[8],
            pad_left=vals[9], pad_right=vals[10], groups=vals[11],
            activation=Activation(vals[12]), weight_tensor_id=vals[13],
            bias_tensor_id=vals[14],
        )


@dataclass
class PoolParams:
    """mars_pool_params_t (``include/mars.h:158-168``)."""

    kernel_h: int = 2
    kernel_w: int = 2
    stride_h: int = 2
    stride_w: int = 2
    padding: Padding = Padding.VALID
    pad_top: int = 0
    pad_bottom: int = 0
    pad_left: int = 0
    pad_right: int = 0

    _FMT = "<4Ii4I"

    def pack(self) -> bytes:
        return struct.pack(
            self._FMT,
            self.kernel_h, self.kernel_w, self.stride_h, self.stride_w,
            int(self.padding),
            self.pad_top, self.pad_bottom, self.pad_left, self.pad_right,
        )

    @classmethod
    def unpack(cls, raw: bytes) -> "PoolParams":
        vals = struct.unpack_from(cls._FMT, raw, 0)
        return cls(
            kernel_h=vals[0], kernel_w=vals[1], stride_h=vals[2],
            stride_w=vals[3], padding=Padding(vals[4]), pad_top=vals[5],
            pad_bottom=vals[6], pad_left=vals[7], pad_right=vals[8],
        )


@dataclass
class ActParams:
    """mars_act_params_t (``include/mars.h:171-173``)."""

    alpha: float = 0.0

    def pack(self) -> bytes:
        return struct.pack("<f", self.alpha)

    @classmethod
    def unpack(cls, raw: bytes) -> "ActParams":
        return cls(alpha=struct.unpack_from("<f", raw, 0)[0])


@dataclass
class ConcatParams:
    """mars_concat_params_t (``include/mars.h:176-179``)."""

    axis: int = 1
    num_inputs: int = 2

    def pack(self) -> bytes:
        return struct.pack("<II", self.axis, self.num_inputs)

    @classmethod
    def unpack(cls, raw: bytes) -> "ConcatParams":
        axis, num_inputs = struct.unpack_from("<II", raw, 0)
        return cls(axis=axis, num_inputs=num_inputs)


@dataclass
class UpsampleParams:
    """mars_upsample_params_t (``include/mars.h:182-186``)."""

    scale_h: int = 2
    scale_w: int = 2
    mode: int = 0  # 0=nearest, 1=bilinear

    def pack(self) -> bytes:
        return struct.pack("<III", self.scale_h, self.scale_w, self.mode)

    @classmethod
    def unpack(cls, raw: bytes) -> "UpsampleParams":
        scale_h, scale_w, mode = struct.unpack_from("<III", raw, 0)
        return cls(scale_h=scale_h, scale_w=scale_w, mode=mode)


@dataclass
class ReshapeParams:
    """mars_reshape_params_t (``include/mars.h:189-192``)."""

    new_shape: Tuple[int, ...] = ()

    def pack(self) -> bytes:
        dims = list(self.new_shape)[:MAX_DIMS]
        dims += [0] * (MAX_DIMS - len(dims))
        return struct.pack("<6iI", *dims, len(self.new_shape))

    @classmethod
    def unpack(cls, raw: bytes) -> "ReshapeParams":
        vals = struct.unpack_from("<6iI", raw, 0)
        ndims = vals[6]
        return cls(new_shape=tuple(vals[:ndims]))


@dataclass
class FCParams:
    """mars_fc_params_t (``include/mars.h:195-199``)."""

    weight_tensor_id: int = NO_TENSOR
    bias_tensor_id: int = NO_TENSOR
    activation: Activation = Activation.NONE

    def pack(self) -> bytes:
        return struct.pack(
            "<IIi", self.weight_tensor_id, self.bias_tensor_id,
            int(self.activation),
        )

    @classmethod
    def unpack(cls, raw: bytes) -> "FCParams":
        wid, bid, act = struct.unpack_from("<IIi", raw, 0)
        return cls(weight_tensor_id=wid, bias_tensor_id=bid,
                   activation=Activation(act))


Params = Union[ConvParams, PoolParams, ActParams, ConcatParams,
               UpsampleParams, ReshapeParams, FCParams, bytes]

_PARAM_CLASS: Dict[LayerType, type] = {
    LayerType.CONV2D: ConvParams,
    LayerType.DEPTHWISE_CONV2D: ConvParams,
    LayerType.MAXPOOL: PoolParams,
    LayerType.AVGPOOL: PoolParams,
    LayerType.GLOBAL_AVGPOOL: PoolParams,
    LayerType.RELU: ActParams,
    LayerType.RELU6: ActParams,
    LayerType.LEAKY_RELU: ActParams,
    LayerType.SILU: ActParams,
    LayerType.SIGMOID: ActParams,
    LayerType.CONCAT: ConcatParams,
    LayerType.ADD: ActParams,
    LayerType.MUL: ActParams,
    LayerType.UPSAMPLE: UpsampleParams,
    LayerType.RESHAPE: ReshapeParams,
    LayerType.SOFTMAX: ActParams,
    LayerType.FC: FCParams,
    LayerType.TRANSPOSE: ReshapeParams,
    LayerType.BATCHNORM: ActParams,
}


@dataclass
class MarsTensor:
    """One 124-byte tensor descriptor + (for weights) its blob slice."""

    id: int
    name: str
    dtype: DType
    format: Format
    shape: Tuple[int, ...]
    data_offset: int = 0
    data_size: int = 0
    scale: float = 1.0
    zero_point: int = 0
    data: Optional[np.ndarray] = None  # raw bytes view for weight tensors

    @property
    def is_weight(self) -> bool:
        return self.data_size > 0

    def numel(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    def pack(self) -> bytes:
        name_b = self.name.encode("utf-8")[:59]
        name_b += b"\x00" * (60 - len(name_b))
        dims = list(self.shape)[:MAX_DIMS]
        dims += [0] * (MAX_DIMS - len(dims))
        out = struct.pack("<I", self.id)
        out += name_b
        out += struct.pack("<iiI", int(self.dtype), int(self.format),
                           len(self.shape))
        out += struct.pack("<6i", *dims)
        out += struct.pack("<QQ", self.data_offset, self.data_size)
        out += struct.pack("<fi", self.scale, self.zero_point)
        assert len(out) == TENSOR_SIZE
        return out

    @classmethod
    def unpack(cls, raw: bytes, off: int = 0) -> "MarsTensor":
        tid, = struct.unpack_from("<I", raw, off)
        name = raw[off + 4:off + 64].split(b"\x00")[0].decode("utf-8", "replace")
        dtype, fmt, ndims = struct.unpack_from("<iiI", raw, off + 64)
        shape = struct.unpack_from("<6i", raw, off + 76)[:ndims]
        data_offset, data_size = struct.unpack_from("<QQ", raw, off + 100)
        scale, zero_point = struct.unpack_from("<fi", raw, off + 116)
        return cls(
            id=tid, name=name, dtype=DType(dtype), format=Format(fmt),
            shape=tuple(shape), data_offset=data_offset, data_size=data_size,
            scale=scale, zero_point=zero_point,
        )


@dataclass
class MarsLayer:
    """One 112-byte layer descriptor."""

    id: int
    type: LayerType
    inputs: Tuple[int, ...]
    outputs: Tuple[int, ...]
    params: Params = b""
    raw_params: bytes = field(default=b"", repr=False)

    def pack(self) -> bytes:
        if len(self.inputs) > 4 or len(self.outputs) > 4:
            # 4 id slots per direction: silently truncating (e.g. a
            # 5-way concat) round-trips to a DIFFERENT graph
            raise ValueError(
                f"layer {self.id} ({self.type!r}): .mars supports at "
                f"most 4 inputs/outputs per layer "
                f"(got {len(self.inputs)}/{len(self.outputs)})")
        out = struct.pack("<IiII", self.id, int(self.type),
                          len(self.inputs), len(self.outputs))
        ins = list(self.inputs)[:4] + [NO_TENSOR] * (4 - min(len(self.inputs), 4))
        outs = list(self.outputs)[:4] + [NO_TENSOR] * (4 - min(len(self.outputs), 4))
        out += struct.pack("<4I", *ins)
        out += struct.pack("<4I", *outs)
        p = self.params.pack() if hasattr(self.params, "pack") else bytes(self.params)
        p = p[:64] + b"\x00" * (64 - min(len(p), 64))
        out += p
        assert len(out) == LAYER_SIZE
        return out

    @classmethod
    def unpack(cls, raw: bytes, off: int = 0) -> "MarsLayer":
        lid, ltype, nin, nout = struct.unpack_from("<IiII", raw, off)
        ins = struct.unpack_from("<4I", raw, off + 16)[:nin]
        outs = struct.unpack_from("<4I", raw, off + 32)[:nout]
        raw_params = bytes(raw[off + 48:off + 112])
        ltype = LayerType(ltype)
        pcls = _PARAM_CLASS.get(ltype)
        params: Params = pcls.unpack(raw_params) if pcls else raw_params
        return cls(id=lid, type=ltype, inputs=tuple(ins), outputs=tuple(outs),
                   params=params, raw_params=raw_params)


@dataclass
class MarsModel:
    """A parsed `.mars` file: descriptors + weight blob."""

    tensors: List[MarsTensor]
    layers: List[MarsLayer]
    input_ids: Tuple[int, ...]
    output_ids: Tuple[int, ...]
    weights: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.uint8), repr=False
    )
    version: Tuple[int, int] = (VERSION_MAJOR, VERSION_MINOR)
    flags: int = 0

    def __post_init__(self) -> None:
        self._by_id = {t.id: t for t in self.tensors}

    def tensor(self, tid: int) -> MarsTensor:
        return self._by_id[tid]

    def get_tensor(self, tid: int) -> Optional[MarsTensor]:
        if tid == NO_TENSOR:
            return None
        return self._by_id.get(tid)

    def weight_bytes(self, t: MarsTensor) -> np.ndarray:
        """Raw little-endian bytes of a weight tensor from the blob."""
        if not t.is_weight:
            raise ValueError(f"tensor {t.id} ({t.name}) has no stored data")
        end = t.data_offset + t.data_size
        if end > self.weights.size:
            raise ValueError(
                f"tensor {t.id} data [{t.data_offset}:{end}] outside weight "
                f"blob of {self.weights.size} bytes"
            )
        return self.weights[t.data_offset:end]

    @property
    def inputs(self) -> List[MarsTensor]:
        return [self.tensor(i) for i in self.input_ids]

    @property
    def outputs(self) -> List[MarsTensor]:
        return [self.tensor(i) for i in self.output_ids]

    def summary(self) -> str:
        lines = [
            f"mars model v{self.version[0]}.{self.version[1]}: "
            f"{len(self.layers)} layers, {len(self.tensors)} tensors, "
            f"{self.weights.size} weight bytes",
            f"  inputs:  {[(t.id, t.name, t.shape, str(t.dtype)) for t in self.inputs]}",
            f"  outputs: {[(t.id, t.name, t.shape, str(t.dtype)) for t in self.outputs]}",
        ]
        for l in self.layers:
            lines.append(f"  L{l.id:<3} {l.type.name:<12} in={l.inputs} out={l.outputs}")
        return "\n".join(lines)


def read_mars(src: Union[str, bytes, bytearray, memoryview]) -> MarsModel:
    """Parse a `.mars` file (path or bytes) into a :class:`MarsModel`.

    Mirrors the loader logic of ``src/mars/mars_runtime.c:126-238`` (header
    validation, descriptor tables, weight blob) without the device memory
    planner — buffer placement on TPU belongs to XLA.
    """
    if isinstance(src, str):
        with open(src, "rb") as f:
            data = f.read()
    else:
        data = bytes(src)

    if len(data) < HEADER_SIZE:
        raise ValueError("file too small for .mars header")
    magic, vmaj, vmin, flags, n_layers, n_tensors, n_in, n_out = (
        struct.unpack_from("<IHHIIIII", data, 0)
    )
    if magic != MARS_MAGIC:
        raise ValueError(f"bad magic 0x{magic:08x} (want 0x{MARS_MAGIC:08x})")
    if vmaj != VERSION_MAJOR:
        raise ValueError(f"unsupported major version {vmaj}")
    weights_offset, weights_size = struct.unpack_from("<QQ", data, 28)
    input_ids = struct.unpack_from("<4I", data, 44)[:n_in]
    output_ids = struct.unpack_from("<4I", data, 60)[:n_out]

    # structural bounds (the reference loader's validation role,
    # src/mars/mars_runtime.c:137-201): fail with a clear error instead
    # of running the descriptor loops off the end of a truncated or
    # count-corrupted file
    tables_end = (HEADER_SIZE + n_tensors * TENSOR_SIZE
                  + n_layers * LAYER_SIZE)
    if tables_end > len(data):
        raise ValueError(
            f"truncated .mars: {n_tensors} tensors + {n_layers} layers "
            f"need {tables_end} bytes, file has {len(data)}")
    if weights_size and weights_offset + weights_size > len(data):
        raise ValueError(
            f"weight blob out of bounds: offset {weights_offset} + size "
            f"{weights_size} > file size {len(data)}")

    off = HEADER_SIZE
    tensors = []
    for _ in range(n_tensors):
        tensors.append(MarsTensor.unpack(data, off))
        off += TENSOR_SIZE
    layers = []
    for _ in range(n_layers):
        layers.append(MarsLayer.unpack(data, off))
        off += LAYER_SIZE

    blob = np.frombuffer(
        data, dtype=np.uint8, count=weights_size, offset=weights_offset
    ).copy() if weights_size else np.zeros(0, np.uint8)

    model = MarsModel(
        tensors=tensors, layers=layers,
        input_ids=tuple(input_ids), output_ids=tuple(output_ids),
        weights=blob, version=(vmaj, vmin), flags=flags,
    )
    for t in tensors:
        if t.is_weight:
            t.data = model.weight_bytes(t)
    return model


def write_mars(model: MarsModel, path: Optional[str] = None) -> bytes:
    """Serialize a :class:`MarsModel` back to `.mars` bytes (optionally to disk).

    Weight blob offset/order is taken from the tensor descriptors; the blob
    is 64-byte aligned after the descriptor tables, as the reference
    compiler emits (``mars-compiler/src/main.rs`` write path).
    """
    n_tensors, n_layers = len(model.tensors), len(model.layers)
    weights_offset = HEADER_SIZE + n_tensors * TENSOR_SIZE + n_layers * LAYER_SIZE
    weights_offset = (weights_offset + 63) & ~63

    if len(model.input_ids) > 4 or len(model.output_ids) > 4:
        # the header has exactly 4 id slots each way; silently
        # truncating would round-trip to a different model
        raise ValueError(
            f".mars supports at most 4 inputs/outputs "
            f"(got {len(model.input_ids)}/{len(model.output_ids)})")
    ins = list(model.input_ids) + [0] * (4 - len(model.input_ids))
    outs = list(model.output_ids) + [0] * (4 - len(model.output_ids))
    header = struct.pack(
        "<IHHIIIII", MARS_MAGIC, model.version[0], model.version[1],
        model.flags, n_layers, n_tensors,
        len(model.input_ids), len(model.output_ids),
    )
    header += struct.pack("<QQ", weights_offset, int(model.weights.size))
    header += struct.pack("<4I", *ins)
    header += struct.pack("<4I", *outs)
    assert len(header) == HEADER_SIZE

    parts = [header]
    parts += [t.pack() for t in model.tensors]
    parts += [l.pack() for l in model.layers]
    body = b"".join(parts)
    body += b"\x00" * (weights_offset - len(body))
    body += model.weights.tobytes()

    if path is not None:
        with open(path, "wb") as f:
            f.write(body)
    return body


def build_mars(
    tensors: Sequence[MarsTensor],
    layers: Sequence[MarsLayer],
    input_ids: Sequence[int],
    output_ids: Sequence[int],
    weight_arrays: Dict[int, np.ndarray],
) -> MarsModel:
    """Assemble a MarsModel, laying out ``weight_arrays`` (tensor id -> array)
    into a fresh 64-byte-aligned weight blob and fixing up descriptors."""
    blob = bytearray()
    tensors = [MarsTensor(**vars(t)) if not isinstance(t, MarsTensor) else t
               for t in tensors]
    by_id = {t.id: t for t in tensors}
    for tid, arr in weight_arrays.items():
        raw = np.ascontiguousarray(arr).tobytes()
        off = (len(blob) + 63) & ~63
        blob.extend(b"\x00" * (off - len(blob)))
        blob.extend(raw)
        t = by_id[tid]
        t.data_offset = off
        t.data_size = len(raw)
    model = MarsModel(
        tensors=list(tensors), layers=list(layers),
        input_ids=tuple(input_ids), output_ids=tuple(output_ids),
        weights=np.frombuffer(bytes(blob), dtype=np.uint8).copy(),
    )
    for t in model.tensors:
        if t.is_weight:
            t.data = model.weight_bytes(t)
    return model
