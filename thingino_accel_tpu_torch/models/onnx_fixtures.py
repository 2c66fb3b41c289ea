"""ONNX models that drive the format code, built in process.

``qdq_yolov5`` writes the zoo's int8 YOLOv5 (``models.zoo.build_yolov5``,
per-tensor scales) as a QDQ ONNX model through ``formats.onnx_writer``, in
the layout a QDQ exporter gives:

- the input is int8 (NCHW) behind a ``DequantizeLinear`` at its scale;
- each conv weight is an int8 initializer behind a ``DequantizeLinear`` at
  the zoo's weight scale, each bias an int32 initializer behind one at
  ``input scale * weight scale``;
- each op's output goes through ``QuantizeLinear`` -> ``DequantizeLinear``
  at the zoo's scale of that tensor (int8 zero point 0);
- a conv's SiLU is ``Sigmoid`` -> Q/DQ at 1/127 -> ``Mul`` -> Q/DQ, as the
  real yolov5n's file carries it (SIGMOID + MUL, the sigmoid's output at
  1/127);
- the outputs are the three heads' int8 ``QuantizeLinear`` outputs.

Imported in int8 mode (``formats.onnx.import_onnx``), it gives the zoo's
graph with its SiLUs as SIGMOID + MUL. This is test data, not a feature:
no command of the CLI reaches it. The tests and ``chip_smoke.py`` compile
it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from thingino_accel_tpu_torch.formats import onnx_proto as OP
from thingino_accel_tpu_torch.formats import onnx_writer as W
from thingino_accel_tpu_torch.ir.graph import Graph
from thingino_accel_tpu_torch.models import zoo

SIGMOID_SCALE = np.float32(1 / 127)   # the real yolov5n's sigmoid outputs


def _nchw(shape: Tuple[int, ...]) -> Tuple[int, ...]:
    n, h, w, c = shape
    return (n, c, h, w)


def qdq_onnx(graph: Graph) -> bytes:
    """An int8 graph of the zoo's ops (CONV2D with act NONE or SILU,
    MAXPOOL, CONCAT on channels, ADD, nearest UPSAMPLE; per-tensor
    scales) as a QDQ ONNX model."""
    nodes: List[Tuple] = []
    inits: Dict[str, np.ndarray] = {"zp": np.zeros((), np.int8)}

    def scale_of(name: str, value) -> str:
        inits[name] = np.asarray(value, np.float32)
        return name

    def qdq(src: str, scale) -> str:
        """``src`` (float) through Q -> DQ at ``scale``; the DQ's output."""
        s = scale_of(f"{src}_scale", scale)
        nodes.append(("QuantizeLinear", [src, s, "zp"], [f"{src}_q"], None))
        nodes.append(("DequantizeLinear", [f"{src}_q", s, "zp"],
                      [f"{src}_dq"], None))
        return f"{src}_dq"

    t = graph.tensors
    # IR tensor -> the ONNX name that carries its dequantized value
    fl: Dict[str, str] = {}
    for name in graph.inputs:
        s = scale_of(f"{name}_scale", t[name].quant.scale)
        nodes.append(("DequantizeLinear", [name, s, "zp"], [f"{name}_dq"],
                      None))
        fl[name] = f"{name}_dq"
    for node in graph.nodes:
        a = node.attrs
        out = node.outputs[0]
        out_scale = t[out].quant.scale
        ins = [fl[i] for i in node.inputs if i in fl]
        if node.op == "CONV2D":
            x, wname = node.inputs[0], node.inputs[1]
            w_scale = t[wname].quant.scale
            inits[wname] = t[wname].data
            conv_ins = [fl[x], f"{wname}_dq"]
            nodes.append(("DequantizeLinear",
                          [wname, scale_of(f"{wname}_scale", w_scale)],
                          [f"{wname}_dq"], None))
            if len(node.inputs) > 2:
                bname = node.inputs[2]
                inits[bname] = t[bname].data
                b_scale = np.float32(t[x].quant.scale) * np.float32(w_scale)
                nodes.append(("DequantizeLinear",
                              [bname, scale_of(f"{bname}_scale", b_scale)],
                              [f"{bname}_dq"], None))
                conv_ins.append(f"{bname}_dq")
            pt, pb, pl, pr = a["explicit_pad"]
            act = a.get("activation", "NONE")
            conv_out = out if act == "NONE" else f"{out}_conv"
            nodes.append(("Conv", conv_ins, [conv_out], dict(
                kernel_shape=tuple(a["kernel"]), strides=tuple(a["stride"]),
                dilations=tuple(a["dilation"]), group=int(a["groups"]),
                pads=(pt, pl, pb, pr))))
            if act == "SILU":
                c = qdq(conv_out, out_scale)
                nodes.append(("Sigmoid", [c], [f"{out}_sig"], None))
                sg = qdq(f"{out}_sig", SIGMOID_SCALE)
                nodes.append(("Mul", [c, sg], [out], None))
            elif act != "NONE":
                raise ValueError(f"qdq_onnx: activation {act} ({node.name})")
        elif node.op == "MAXPOOL":
            pt, pb, pl, pr = a["explicit_pad"]
            nodes.append(("MaxPool", ins, [out], dict(
                kernel_shape=tuple(a["kernel"]), strides=tuple(a["stride"]),
                pads=(pt, pl, pb, pr))))
        elif node.op == "CONCAT" and a.get("axis") == 3:
            nodes.append(("Concat", ins, [out], dict(axis=1)))
        elif node.op == "ADD":
            nodes.append(("Add", ins, [out], None))
        elif node.op == "UPSAMPLE" and a.get("mode", 0) == 0:
            sh, sw = a["scale"]
            s = f"{out}_resize"
            inits[s] = np.asarray([1.0, 1.0, sh, sw], np.float32)
            nodes.append(("Resize", [ins[0], "", s], [out],
                          dict(mode="nearest")))
        else:
            raise ValueError(f"qdq_onnx: op {node.op} ({node.name})")
        fl[out] = qdq(out, out_scale)
    inputs = {n: (_nchw(t[n].shape), OP.TP_INT8) for n in graph.inputs}
    outputs = {f"{n}_q": (_nchw(t[n].shape), OP.TP_INT8)
               for n in graph.outputs}
    return W.build_model(nodes=nodes, inputs=inputs, outputs=outputs,
                         initializers=inits)


def qdq_yolov5(size: str = "n", cfg: Optional[zoo.ZooConfig] = None
               ) -> bytes:
    """The zoo's int8 YOLOv5-``size`` as a QDQ ONNX model."""
    return qdq_onnx(zoo.build_yolov5(size, cfg))
