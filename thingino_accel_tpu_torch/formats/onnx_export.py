"""Generic IR -> ONNX exporter.

Copy of ``thingino_accel_tpu/formats/onnx_export.py`` on the port's
``ops.reference._conv_pads``, with one repair: each CONCAT is exported
along the axis the executor joins (``ir.graph.concat_axis_of``), where
JAX's maps the stored axis as it stands, so a `.mars` file's ``axis=1``
(NCHW channels, NHWC axis 3 by the executor's rule) left as ONNX axis 2,
H (ROADMAP.md C.13).

The reference's decompiler contains a generic hand-rolled ONNX graph
builder (``mgk-decompiler/src/onnx_export.rs``) used by its AEC and
YOLO exporters; this module is the framework's equivalent for the
2D-vision IR: any :class:`~thingino_accel_tpu_torch.ir.graph.Graph` of the
common layer set (CONV2D / ADD / CONCAT / MAXPOOL / AVGPOOL /
UPSAMPLE) serializes to a float32 ONNX model that round-trips through
``formats.onnx.import_onnx`` and runs on the engine.

Layout: IR activations are NHWC, ONNX is NCHW — node structure is
layout-independent, so only the value_info shapes and the CONCAT axis
are remapped; weights are OIHW in both worlds.

Quantized graphs are exported dequantized (float32 weights =
``int8 * scale``; int32 bias * ``in_scale * w_scale``), mirroring the
reference's dequantize-on-export (``yolo_onnx_export.rs:191-196``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from thingino_accel_tpu_torch.formats import onnx_proto as OP
from thingino_accel_tpu_torch.formats import onnx_writer as W
from thingino_accel_tpu_torch.ir.graph import Graph, concat_axis_of
from thingino_accel_tpu_torch.ops import reference as R


def _nchw(shape: Tuple[int, ...]) -> Tuple[int, ...]:
    if len(shape) == 4:
        n, h, w, c = shape
        return (n, c, h, w)
    return tuple(shape)


def _axis_nchw(axis: int, rank: int) -> int:
    if rank != 4:
        return axis
    return {0: 0, 1: 2, 2: 3, 3: 1}[axis]


def _dequant_weight(t) -> np.ndarray:
    """Constant tensor -> float32 (dequantized if int8/int32)."""
    arr = t.data
    if arr is None:
        raise ValueError(f"{t.name}: not a constant tensor")
    if arr.dtype == np.float32:
        return arr
    if arr.dtype == np.int8:
        if t.channel_scales is not None:
            sc = np.asarray(t.channel_scales, np.float32).reshape(
                (-1,) + (1,) * (arr.ndim - 1))
        else:
            sc = np.float32(t.quant.scale)
        return arr.astype(np.float32) * sc
    raise ValueError(f"{t.name}: unsupported weight dtype {arr.dtype}")


def _dequant_bias(t, in_scale: float, wt) -> np.ndarray:
    arr = t.data
    if arr.dtype == np.float32:
        return arr
    if arr.dtype == np.int32:
        # bias units: in_scale * w_scale (per channel when applicable)
        if wt.channel_scales is not None:
            ws = np.asarray(wt.channel_scales, np.float32)
        else:
            ws = np.float32(wt.quant.scale)
        return arr.astype(np.float32) * (np.float32(in_scale) * ws)
    raise ValueError(f"{t.name}: unsupported bias dtype {arr.dtype}")


def _resolve_pads(node, tensors) -> List[int]:
    """ONNX pads [top, left, bottom, right] via the reference's rules."""
    t_in = tensors[node.inputs[0]]
    t_out = tensors[node.outputs[0]]
    a = node.attrs
    k = a.get("kernel", (1, 1))
    (pt, pb), (pl_, pr) = R._conv_pads(
        (t_in.shape[1], t_in.shape[2]), (t_out.shape[1], t_out.shape[2]),
        k, a.get("stride", (1, 1)), a.get("dilation", (1, 1)),
        a.get("padding", "VALID"), a.get("explicit_pad", (0, 0, 0, 0)))
    return [pt, pl_, pb, pr]


def ir_to_onnx(
    graph: Graph,
    weights_override: Optional[Dict[str, np.ndarray]] = None,
) -> bytes:
    """Serialize ``graph`` as a float32 NCHW ONNX model.

    ``weights_override``: optional f32 arrays by weight-tensor name
    (used by the `.mgk` YOLO exporter to graft extracted weights onto
    the architecture graph, the reference's ``export_with_reference``
    pattern, ``yolo_onnx_export.rs:219-282``).
    """
    weights_override = weights_override or {}
    nodes: List[Tuple] = []
    inits: Dict[str, np.ndarray] = {}

    def emit_act(act: str, alpha: float, src: str, dst: str) -> None:
        if act in (None, "NONE"):
            nodes.append(("Identity", [src], [dst], None))
        elif act == "RELU":
            nodes.append(("Relu", [src], [dst], None))
        elif act == "LEAKY_RELU":
            nodes.append(("LeakyRelu", [src], [dst], dict(alpha=alpha)))
        elif act == "SILU":
            nodes.append(("Sigmoid", [src], [dst + "_sig"], None))
            nodes.append(("Mul", [src, dst + "_sig"], [dst], None))
        elif act == "SIGMOID":
            nodes.append(("Sigmoid", [src], [dst], None))
        else:
            raise ValueError(f"unsupported activation {act}")

    for node in graph.nodes:
        a = node.attrs
        out = node.outputs[0]
        if node.op in ("CONV2D", "DEPTHWISE_CONV2D"):
            wt = graph.tensors[node.inputs[1]]
            wname = node.inputs[1]
            if wname in weights_override:
                inits[wname] = np.asarray(
                    weights_override[wname], np.float32)
            else:
                inits[wname] = _dequant_weight(wt)
            ins = [node.inputs[0], wname]
            if len(node.inputs) > 2:
                bname = node.inputs[2]
                if bname in weights_override:
                    inits[bname] = np.asarray(
                        weights_override[bname], np.float32)
                else:
                    in_sc = graph.tensors[node.inputs[0]].quant.scale
                    inits[bname] = _dequant_bias(
                        graph.tensors[bname], in_sc, wt)
                ins.append(bname)
            act = a.get("activation", "NONE")
            conv_out = out + "_conv" if act not in (None, "NONE") else out
            nodes.append(("Conv", ins, [conv_out], dict(
                kernel_shape=tuple(a.get("kernel", (1, 1))),
                strides=tuple(a.get("stride", (1, 1))),
                dilations=tuple(a.get("dilation", (1, 1))),
                group=int(a.get("groups", 1)),
                pads=tuple(_resolve_pads(node, graph.tensors)))))
            if act not in (None, "NONE"):
                emit_act(act, a.get("alpha", 0.01) or 0.01, conv_out, out)
        elif node.op == "ADD":
            nodes.append(("Add", list(node.inputs[:2]), [out], None))
        elif node.op == "MUL":
            nodes.append(("Mul", list(node.inputs[:2]), [out], None))
        elif node.op == "CONCAT":
            out_shape = graph.tensors[out].shape
            axis = concat_axis_of(
                [graph.tensors[i].shape for i in node.inputs], out_shape,
                int(a.get("axis", 3)))
            nodes.append(("Concat", list(node.inputs), [out],
                          dict(axis=_axis_nchw(axis, len(out_shape)))))
        elif node.op in ("MAXPOOL", "AVGPOOL"):
            op = "MaxPool" if node.op == "MAXPOOL" else "AveragePool"
            nodes.append((op, [node.inputs[0]], [out], dict(
                kernel_shape=tuple(a.get("kernel", (2, 2))),
                strides=tuple(a.get("stride", (1, 1))),
                pads=tuple(_resolve_pads(node, graph.tensors)))))
        elif node.op == "UPSAMPLE":
            sc = a.get("scale", (2, 2))
            sname = out + "_scales"
            inits[sname] = np.asarray([1.0, 1.0, sc[0], sc[1]], np.float32)
            nodes.append(("Resize", [node.inputs[0], "", sname], [out],
                          dict(mode="nearest")))
        elif node.op in ("RELU", "LEAKY_RELU", "SILU", "SIGMOID"):
            emit_act(node.op, a.get("alpha", 0.01) or 0.01,
                     node.inputs[0], out)
        elif node.op == "DEQUANT":
            # edge node from ir.passes.dequantize_graph: x * scale
            sc = float(a.get("scale", 1.0))
            if sc == 1.0:
                nodes.append(("Identity", [node.inputs[0]], [out], None))
            else:
                sname = out + "_scale"
                inits[sname] = np.asarray([sc], np.float32)
                nodes.append(("Mul", [node.inputs[0], sname], [out],
                              None))
        else:
            raise ValueError(
                f"ir_to_onnx: unsupported op {node.op} ({node.name})")

    inputs = {n: (_nchw(graph.tensors[n].shape), OP.TP_FLOAT)
              for n in graph.inputs}
    outputs = {n: (_nchw(graph.tensors[n].shape), OP.TP_FLOAT)
               for n in graph.outputs}
    return W.build_model(nodes=nodes, inputs=inputs, outputs=outputs,
                         initializers=inits)
