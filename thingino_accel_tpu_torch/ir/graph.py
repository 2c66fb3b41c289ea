"""Network graph IR.

Copy of ``thingino_accel_tpu/ir/graph.py``, plus :func:`concat_axis_of`
(the executor's and the ONNX exporter's one rule for a CONCAT's axis) and
:func:`graph_from_jax`.

The IR is a flat, topologically-ordered op list over named tensors —
deliberately close to the `.mars` layer table (``include/mars.h:59-79``)
so the importer is near-trivial, but normalized for TPU execution:

- weights are unpacked from NNA layouts (NMHWSOIB2 -> OIHW) at import;
- feature layout is canonicalized to NHWC (TPU-native; channels-last
  feeds the MXU lane dimension) with the original `.mars` layout recorded
  so bit-parity tests can transpose back;
- per-tensor quantization (scale, zero_point) is carried on tensors, as
  in the reference (``include/mars.h:130-131``).

The executor (``runtime.executor``) traces this IR into a single jitted
XLA program — the TPU replacement for the reference's per-layer
interpreter loop (``src/mars/mars_runtime.c:439-459``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from thingino_accel_tpu_torch.formats import mars as M
from thingino_accel_tpu_torch.formats.packing import unpack_nmhwsoib2


@dataclass(frozen=True)
class QuantInfo:
    """Per-tensor affine quantization: real = (q - zero_point) * scale."""

    scale: float = 1.0
    zero_point: int = 0

    @property
    def is_identity(self) -> bool:
        return self.scale == 1.0 and self.zero_point == 0


@dataclass
class TensorInfo:
    """A tensor in the graph. Activations are NHWC; weights OIHW."""

    name: str
    shape: Tuple[int, ...]
    dtype: np.dtype
    quant: QuantInfo = field(default_factory=QuantInfo)
    # Constant data (weights/bias); None for activations.
    data: Optional[np.ndarray] = None
    # Layout of `shape` as stored in the source file, for round-tripping.
    source_format: Optional[M.Format] = None
    # Per-output-channel quant scales (per-channel weight quantization
    # extension; None = per-tensor `quant.scale`).
    channel_scales: Optional[np.ndarray] = None

    @property
    def is_const(self) -> bool:
        return self.data is not None


@dataclass
class Node:
    """One op. `op` is a LayerType name string plus framework extensions."""

    op: str
    inputs: List[str]
    outputs: List[str]
    attrs: Dict[str, Any] = field(default_factory=dict)
    name: str = ""

    def __repr__(self) -> str:  # compact graph dumps
        a = {k: v for k, v in self.attrs.items() if not isinstance(v, np.ndarray)}
        return f"Node({self.op}, {self.inputs}->{self.outputs}, {a})"


@dataclass
class Graph:
    """A topologically-ordered network."""

    nodes: List[Node]
    tensors: Dict[str, TensorInfo]
    inputs: List[str]
    outputs: List[str]
    name: str = "network"
    # set by ir.passes.stem_space_to_depth: the input takes frames in
    # space-to-depth order (models.yolo.space_to_depth)
    stem_s2d: bool = False

    def validate(self) -> None:
        defined = set(self.inputs)
        defined |= {n for n, t in self.tensors.items() if t.is_const}
        for node in self.nodes:
            for i in node.inputs:
                if i not in self.tensors:
                    raise ValueError(f"{node}: unknown input tensor {i!r}")
                if i not in defined:
                    raise ValueError(
                        f"{node}: input {i!r} used before definition "
                        "(graph not topologically ordered)")
            for o in node.outputs:
                if o not in self.tensors:
                    raise ValueError(f"{node}: unknown output tensor {o!r}")
                defined.add(o)
        for o in self.outputs:
            if o not in defined:
                raise ValueError(f"graph output {o!r} never produced")

    def consumers(self) -> Dict[str, List[Node]]:
        out: Dict[str, List[Node]] = {}
        for node in self.nodes:
            for i in node.inputs:
                out.setdefault(i, []).append(node)
        return out

    def producer_map(self) -> Dict[str, Node]:
        out: Dict[str, Node] = {}
        for node in self.nodes:
            for o in node.outputs:
                out[o] = node
        return out

    def with_outputs(self, outputs: List[str]) -> "Graph":
        """Re-target graph outputs (graph surgery) and drop dead nodes.

        Used e.g. to read the valid detect-conv features of the bundled
        YOLO files whose in-file decode head is broken (see
        ``_materialize_dangling``).
        """
        for o in outputs:
            if o not in self.tensors:
                raise KeyError(f"unknown tensor {o!r}")
        g = Graph(nodes=list(self.nodes), tensors=self.tensors,
                  inputs=list(self.inputs), outputs=list(outputs),
                  name=self.name, stem_s2d=self.stem_s2d)
        from thingino_accel_tpu_torch.ir import passes
        return passes.dead_code(g)

    def summary(self) -> str:
        lines = [f"graph {self.name}: {len(self.nodes)} nodes, "
                 f"{len(self.tensors)} tensors"]
        for t in self.inputs:
            ti = self.tensors[t]
            lines.append(f"  in  {t}: {ti.shape} {ti.dtype} s={ti.quant.scale}")
        for node in self.nodes:
            lines.append(f"  {node!r}")
        for t in self.outputs:
            ti = self.tensors[t]
            lines.append(f"  out {t}: {ti.shape} {ti.dtype} s={ti.quant.scale}")
        return "\n".join(lines)


def count_macs(g: Graph) -> int:
    """Multiply-accumulates for ONE pass over the graph's stored shapes.

    Counts the MXU ops only (CONV2D / DEPTHWISE_CONV2D / FC) — they
    carry >99% of a detector's arithmetic. Shapes include whatever
    batch dim the graph was built with; divide by ``shape[0]`` of the
    input for per-frame MACs. Used by bench.py's MFU line.
    """
    total = 0
    for node in g.nodes:
        if node.op not in ("CONV2D", "DEPTHWISE_CONV2D", "FC"):
            continue
        out = g.tensors[node.outputs[0]].shape
        w = g.tensors[node.inputs[1]].shape  # OIHW / (O, I)
        if node.op == "FC":
            total += int(np.prod(out)) * int(w[1])
        else:
            # w[1] is already Cin/groups (depthwise: 1)
            total += int(np.prod(out)) * int(w[1] * w[2] * w[3])
    return total


# ---------------------------------------------------------------------------
# .mars -> IR import
# ---------------------------------------------------------------------------

def concat_axis_of(in_shapes: Sequence[Sequence[int]],
                   out_shape: Sequence[int], axis: int) -> int:
    """The axis a CONCAT of ``in_shapes`` into ``out_shape`` joins. .mars
    graphs express it on NCHW axis 1 (NHWC axis 3) and some files carry
    garbage values (the C runtime ignores the field and always concats
    channels, mars_runtime.c:963-1000), so it is inferred from the shapes
    where they identify it; else ``axis``, with 1 read as 3 at rank 4.
    The rule of JAX's executor (``runtime/executor.py:1168-1180``)."""
    rank = len(in_shapes[0])
    if all(len(s) == rank for s in in_shapes):
        cands = []
        for ax in range(rank):
            tot = sum(s[ax] for s in in_shapes)
            others = all(
                all(s[d] == in_shapes[0][d] for s in in_shapes)
                for d in range(rank) if d != ax)
            if others and len(out_shape) == rank \
                    and out_shape[ax] in (tot, 0) and tot > 0:
                cands.append(ax)
        if len(cands) == 1:
            axis = cands[0]
        elif axis == 1 and rank == 4:
            axis = 3
    return axis


def _feature_shape_nhwc(t: M.MarsTensor) -> Tuple[Tuple[int, ...], bool]:
    """Return (NHWC shape, was_nchw) for a feature tensor descriptor.

    The bundled models mark feature tensors NCHW (format 0) or NDHWC32 with
    NCHW-ordered dims; the runtime only distinguishes NHWC(7) vs everything
    else (``src/mars/mars_runtime.c:561``). We canonicalize 4-D features to
    NHWC and leave other ranks untouched.
    """
    if len(t.shape) == 4 and t.format != M.Format.NHWC:
        n, c, h, w = t.shape
        return (n, h, w, c), True
    return tuple(t.shape), False


def _decode_plain_weight(model: M.MarsModel, t: M.MarsTensor) -> np.ndarray:
    """Decode a non-conv-weight constant (bias, BN scale/bias, LUT).

    Handles a compiler quirk: `.mars` files emitted from fp16 ONNX exports
    clone the raw fp16 initializer bytes for conv biases while declaring
    the tensor FLOAT32 (``mars-compiler/src/main.rs:784-798`` copies
    ``bias_tensor.data`` verbatim; the fp16->f32 widening at ``:20-46`` is
    applied elsewhere but not here). Detect via ``data_size == 2*numel``
    and widen. The reference runtime misreads these as int32/f32 —
    recorded in docs/DIVERGENCES.md.
    """
    raw = model.weight_bytes(t).tobytes()
    numel = t.numel()
    if (t.dtype == M.DType.FLOAT32 and numel
            and len(raw) == 2 * numel):
        return np.frombuffer(raw, dtype=np.float16).astype(np.float32).reshape(
            t.shape)
    data = np.frombuffer(raw, dtype=t.dtype.np)
    if numel and data.size >= numel:
        data = data[:numel].reshape(t.shape)
    return data


def from_mars(
    model: M.MarsModel,
    name: str = "mars",
    weight_layout_hint: Optional[Dict[int, str]] = None,
) -> Graph:
    """Lower a parsed `.mars` file to the IR.

    - features -> NHWC activations
    - conv weights -> OIHW numpy arrays (unpacked from NMHWSOIB2 etc.)
    - bias -> int32/f32 1-D arrays
    - layer params -> node attrs

    ``weight_layout_hint`` maps tensor id -> 'OIHW'|'OHWI' for files whose
    descriptors don't self-describe the layout (format code reused as 0/1 by
    old generators, see tools/mars_gen_test.py:30-32 vs include/mars.h:46-56).
    """
    g_tensors: Dict[str, TensorInfo] = {}
    nodes: List[Node] = []
    tname: Dict[int, str] = {}

    def uniq(base: str, tid: int) -> str:
        n = base if base else f"t{tid}"
        if n in g_tensors:
            n = f"{n}_{tid}"
        return n

    weight_ids = set()
    conv_weight_meta: Dict[int, Tuple[int, M.ConvParams]] = {}
    for layer in model.layers:
        if layer.type in (M.LayerType.CONV2D, M.LayerType.DEPTHWISE_CONV2D):
            p = layer.params
            if p.weight_tensor_id != M.NO_TENSOR:
                conv_weight_meta[p.weight_tensor_id] = (layer.id, p)
                weight_ids.add(p.weight_tensor_id)
            if p.bias_tensor_id != M.NO_TENSOR:
                weight_ids.add(p.bias_tensor_id)
        elif layer.type == M.LayerType.FC:
            p = layer.params
            if p.weight_tensor_id != M.NO_TENSOR:
                weight_ids.add(p.weight_tensor_id)
            if p.bias_tensor_id != M.NO_TENSOR:
                weight_ids.add(p.bias_tensor_id)

    # Tensors
    for t in model.tensors:
        nm = uniq(t.name, t.id)
        tname[t.id] = nm
        quant = QuantInfo(scale=float(t.scale), zero_point=int(t.zero_point))
        if t.is_weight:
            if t.id in conv_weight_meta:
                hint = (weight_layout_hint or {}).get(t.id)
                data = _decode_conv_weight(model, t, hint)
                shape = data.shape
            else:
                data = _decode_plain_weight(model, t)
                shape = tuple(data.shape)
            g_tensors[nm] = TensorInfo(
                name=nm, shape=tuple(shape), dtype=data.dtype, quant=quant,
                data=data, source_format=t.format)
        else:
            shape, nchw = _feature_shape_nhwc(t)
            g_tensors[nm] = TensorInfo(
                name=nm, shape=shape, dtype=t.dtype.np, quant=quant,
                source_format=t.format)

    # Nodes
    for layer in model.layers:
        ins = [tname[i] for i in layer.inputs if i != M.NO_TENSOR]
        outs = [tname[o] for o in layer.outputs if o != M.NO_TENSOR]
        attrs: Dict[str, Any] = {}
        p = layer.params
        if layer.type in (M.LayerType.CONV2D, M.LayerType.DEPTHWISE_CONV2D):
            attrs = dict(
                kernel=(p.kernel_h, p.kernel_w),
                stride=(p.stride_h, p.stride_w),
                dilation=(p.dilation_h, p.dilation_w),
                padding=p.padding.name,
                explicit_pad=(p.pad_top, p.pad_bottom, p.pad_left, p.pad_right),
                groups=p.groups,
                activation=p.activation.name,
            )
            if p.weight_tensor_id != M.NO_TENSOR:
                ins = ins + [tname[p.weight_tensor_id]]
            if p.bias_tensor_id != M.NO_TENSOR:
                ins = ins + [tname[p.bias_tensor_id]]
        elif layer.type in (M.LayerType.MAXPOOL, M.LayerType.AVGPOOL,
                            M.LayerType.GLOBAL_AVGPOOL):
            attrs = dict(
                kernel=(p.kernel_h, p.kernel_w),
                stride=(p.stride_h, p.stride_w),
                padding=p.padding.name,
                explicit_pad=(p.pad_top, p.pad_bottom, p.pad_left, p.pad_right),
            )
        elif layer.type in (M.LayerType.RELU, M.LayerType.RELU6,
                            M.LayerType.LEAKY_RELU, M.LayerType.SILU,
                            M.LayerType.SIGMOID, M.LayerType.SOFTMAX):
            attrs = dict(alpha=getattr(p, "alpha", 0.0))
        elif layer.type == M.LayerType.CONCAT:
            attrs = dict(axis=p.axis)
        elif layer.type == M.LayerType.UPSAMPLE:
            attrs = dict(scale=(p.scale_h, p.scale_w), mode=p.mode)
        elif layer.type in (M.LayerType.RESHAPE, M.LayerType.TRANSPOSE):
            attrs = dict(new_shape=tuple(getattr(p, "new_shape", ())))
        elif layer.type == M.LayerType.FC:
            attrs = dict(activation=p.activation.name)
            if p.weight_tensor_id != M.NO_TENSOR:
                ins = ins + [tname[p.weight_tensor_id]]
            if p.bias_tensor_id != M.NO_TENSOR:
                ins = ins + [tname[p.bias_tensor_id]]
        nodes.append(Node(
            op=layer.type.name, inputs=ins, outputs=outs, attrs=attrs,
            name=f"L{layer.id}"))

    g = Graph(
        nodes=nodes,
        tensors=g_tensors,
        inputs=[tname[i] for i in model.input_ids],
        outputs=[tname[o] for o in model.output_ids],
        name=name,
    )
    _quantize_float_biases(g)
    _materialize_dangling(g)
    _attach_channel_scales(g)
    g.validate()
    return g


def _attach_channel_scales(g: Graph) -> None:
    """Reattach per-channel weight scales serialized as companion D1
    tensors named ``<weight>__chs`` (our format extension — the base
    `.mars` descriptor has only a per-tensor scale)."""
    for name in list(g.tensors):
        if not name.endswith("__chs"):
            continue
        base = name[:-5]
        t = g.tensors.get(base)
        cht = g.tensors[name]
        if t is not None and t.is_const and cht.data is not None:
            t.channel_scales = np.asarray(cht.data, np.float32).reshape(-1)
            del g.tensors[name]


def _materialize_dangling(g: Graph) -> None:
    """Zero-fill activation tensors that are consumed but never produced.

    The reference compiler skips unsupported ONNX ops (Shape/Gather/Slice/
    Split/Pow — ``mars-compiler/src/main.rs`` op table), leaving layers in
    the emitted graph that consume tensors with no producer (e.g. the
    ``/model.24/Split_output_0`` family in the bundled yolov5n detect
    head). The C runtime reads whatever stale bytes sit in the round-robin
    work buffer (``src/mars/mars_runtime.c:315-334``); we make them
    deterministic zeros instead. docs/DIVERGENCES.md has the full story.
    """
    produced = set(g.inputs)
    produced |= {n for n, t in g.tensors.items() if t.is_const}
    for node in g.nodes:
        produced.update(node.outputs)
    for node in g.nodes:
        for i in node.inputs:
            if i not in produced and i in g.tensors:
                t = g.tensors[i]
                t.data = np.zeros(t.shape, t.dtype)
                produced.add(i)


def _quantize_float_biases(g: Graph) -> None:
    """int8 convs need int32 bias in accumulator units:
    ``b_i32 = round(b_real / (in_scale * w_scale))``. Files from fp16 ONNX
    exports carry float biases even for int8 convs; convert at import so
    the executor's integer path stays exact."""
    for node in g.nodes:
        if node.op not in ("CONV2D", "DEPTHWISE_CONV2D", "FC"):
            continue
        if len(node.inputs) < 3:
            continue
        xt = g.tensors[node.inputs[0]]
        bt = g.tensors[node.inputs[2]]
        wt = g.tensors[node.inputs[1]]
        if (np.issubdtype(xt.dtype, np.signedinteger) and xt.dtype.itemsize == 1
                and bt.data is not None
                and np.issubdtype(bt.data.dtype, np.floating)):
            denom = np.float32(xt.quant.scale) * np.float32(wt.quant.scale)
            if denom == 0:
                denom = np.float32(1.0)
            q = np.round(bt.data.astype(np.float64) / denom)
            bt.data = np.clip(q, np.iinfo(np.int32).min,
                              np.iinfo(np.int32).max).astype(np.int32)
            bt.dtype = bt.data.dtype


def _decode_conv_weight(
    model: M.MarsModel, wt: M.MarsTensor, hint: Optional[str]
) -> np.ndarray:
    """Conv weight blob -> OIHW array (fp16-stored f32 widened, see
    :func:`_decode_plain_weight`)."""
    raw = model.weight_bytes(wt)
    shape = wt.shape
    if wt.format == M.Format.NMHWSOIB2:
        o, i, kh, kw = shape
        return unpack_nmhwsoib2(raw, o, i, kh, kw)
    numel = wt.numel()
    if (wt.dtype == M.DType.FLOAT32 and numel
            and raw.size == 2 * numel):
        arr = np.frombuffer(raw.tobytes(), dtype=np.float16).astype(np.float32)
    else:
        arr = np.frombuffer(raw.tobytes(), dtype=wt.dtype.np)
    layout = hint
    if layout is None:
        if wt.format == M.Format.OHWI:
            layout = "OHWI"
        elif wt.format == M.Format.HWIO:
            layout = "HWIO"
        else:
            layout = "OIHW"
    if layout == "OHWI":
        o, a, b, c = shape  # declared (O, KH, KW, I) per generator convention
        return np.ascontiguousarray(
            arr.reshape(o, a, b, c).transpose(0, 3, 1, 2))
    if layout == "HWIO":
        kh, kw, i, o = shape
        return np.ascontiguousarray(
            arr.reshape(kh, kw, i, o).transpose(3, 2, 0, 1))
    return arr.reshape(shape)


def graph_from_jax(g: Any) -> Graph:
    """The port's :class:`Graph` from any graph of the same shape (the JAX
    package's, read by attribute): new nodes, attrs dicts and tensor
    records, with the constants' numpy arrays shared, not copied. The
    counterpart for graphs of ``runtime.executor.params_from_jax``."""
    def quant(q: Any) -> QuantInfo:
        return QuantInfo(scale=q.scale, zero_point=q.zero_point)

    def fmt(f: Any) -> Optional[M.Format]:
        return None if f is None else M.Format(int(f))

    tensors = {
        name: TensorInfo(name=t.name, shape=tuple(t.shape), dtype=t.dtype,
                         quant=quant(t.quant), data=t.data,
                         source_format=fmt(t.source_format),
                         channel_scales=t.channel_scales)
        for name, t in g.tensors.items()}
    nodes = [Node(op=n.op, inputs=list(n.inputs), outputs=list(n.outputs),
                  attrs=dict(n.attrs), name=n.name) for n in g.nodes]
    return Graph(nodes=nodes, tensors=tensors, inputs=list(g.inputs),
                 outputs=list(g.outputs), name=g.name)
