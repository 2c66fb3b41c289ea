"""IR graph -> `.mars` file serializer (the mars-compiler back-half).

Copy of ``thingino_accel_tpu/formats/mars_export.py`` (numpy only), so
that the port imports nothing of the JAX package.

Together with ``formats.onnx`` this completes the reference's offline
pipeline (ONNX -> .mars, ``mars-compiler/src/main.rs``) inside the
framework: import ONNX to IR, optionally run passes, export `.mars` for
interchange with the reference runtime.

Emitted conventions (chosen to be *well-formed* for both runtimes, unlike
some bundled files — see docs/DIVERGENCES.md):
- features: NHWC descriptors (format 7), the reference's fast path
- int8 conv weights: OHWI blobs (format 6), what
  ``conv2d_int8_nhwc_mxu`` indexes; f32 weights: OIHW (format 8)
- biases: int32 (int8 graphs) / f32, format D1
- per-tensor scales on every descriptor
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from thingino_accel_tpu_torch.formats import mars as M
from thingino_accel_tpu_torch.ir.graph import Graph, Node

_ACT = {name: M.Activation[name] for name in M.Activation.__members__}

_SIMPLE_OPS = {
    "MAXPOOL": M.LayerType.MAXPOOL,
    "AVGPOOL": M.LayerType.AVGPOOL,
    "GLOBAL_AVGPOOL": M.LayerType.GLOBAL_AVGPOOL,
    "RELU": M.LayerType.RELU,
    "RELU6": M.LayerType.RELU6,
    "LEAKY_RELU": M.LayerType.LEAKY_RELU,
    "SILU": M.LayerType.SILU,
    "SIGMOID": M.LayerType.SIGMOID,
    "CONCAT": M.LayerType.CONCAT,
    "ADD": M.LayerType.ADD,
    "MUL": M.LayerType.MUL,
    "UPSAMPLE": M.LayerType.UPSAMPLE,
    "RESHAPE": M.LayerType.RESHAPE,
    "SOFTMAX": M.LayerType.SOFTMAX,
    "TRANSPOSE": M.LayerType.TRANSPOSE,
    "BATCHNORM": M.LayerType.BATCHNORM,
    "FC": M.LayerType.FC,
}


def export_mars(graph: Graph, path: Optional[str] = None) -> bytes:
    """Serialize an IR graph to `.mars` bytes (optionally writing a file)."""
    tid: Dict[str, int] = {}
    tensors: List[M.MarsTensor] = []
    weight_arrays: Dict[int, np.ndarray] = {}

    def add_tensor(name: str) -> int:
        if name in tid:
            return tid[name]
        t = graph.tensors[name]
        i = len(tensors)
        tid[name] = i
        is_i8 = (np.issubdtype(t.dtype, np.signedinteger)
                 and np.dtype(t.dtype).itemsize == 1)
        if t.is_const:
            data = t.data
            if data.ndim == 4:
                # conv weight OIHW in IR
                if data.dtype == np.int8:
                    fmt = M.Format.OHWI
                    blob = np.ascontiguousarray(
                        data.transpose(0, 2, 3, 1))      # -> OHWI
                    shape = blob.shape
                    dt = M.DType.INT8
                else:
                    fmt = M.Format.OIHW
                    blob = np.ascontiguousarray(data, np.float32)
                    shape = blob.shape
                    dt = M.DType.FLOAT32
            else:
                fmt = M.Format.D1
                blob = np.ascontiguousarray(data)
                dmap = {np.dtype(np.int32): M.DType.INT32,
                        np.dtype(np.float32): M.DType.FLOAT32,
                        np.dtype(np.int8): M.DType.INT8,
                        np.dtype(np.uint8): M.DType.UINT8,
                        np.dtype(np.int16): M.DType.INT16}
                if blob.dtype not in dmap:
                    # float64/float16 etc: cast rather than declaring
                    # FLOAT32 over raw foreign bytes (garbage on import)
                    blob = np.ascontiguousarray(blob, np.float32)
                shape = blob.shape
                dt = dmap.get(blob.dtype, M.DType.FLOAT32)
            # truncate so the companion "<stored>__chs" also fits the
            # 59-char name field and strips back to exactly this name
            stored = name[:54] if t.channel_scales is not None else name[:58]
            tensors.append(M.MarsTensor(
                id=i, name=stored, dtype=dt, format=fmt,
                shape=tuple(shape), scale=t.quant.scale,
                zero_point=t.quant.zero_point))
            weight_arrays[i] = blob
            if t.channel_scales is not None:
                # per-channel scales ride as a companion D1 tensor named
                # "<weight>__chs" (format extension; importer reattaches)
                ci = len(tensors)
                chs = np.asarray(t.channel_scales, np.float32)
                tensors.append(M.MarsTensor(
                    id=ci, name=stored + "__chs",
                    dtype=M.DType.FLOAT32, format=M.Format.D1,
                    shape=tuple(chs.shape)))
                weight_arrays[ci] = chs
        else:
            if (np.issubdtype(t.dtype, np.integer) and not is_i8):
                raise ValueError(
                    f"activation {name!r}: .mars has no "
                    f"{np.dtype(t.dtype).name} activation dtype "
                    "(int8 or float32 only)")
            dt = M.DType.INT8 if is_i8 else M.DType.FLOAT32
            tensors.append(M.MarsTensor(
                id=i, name=name[:58], dtype=dt, format=M.Format.NHWC,
                shape=tuple(t.shape), scale=t.quant.scale,
                zero_point=t.quant.zero_point))
        return i

    for name in graph.inputs:
        add_tensor(name)

    layers: List[M.MarsLayer] = []
    for li, node in enumerate(graph.nodes):
        a = node.attrs
        op = node.op
        if op == "SILU_FUSED":
            op = "SILU"
        if op == "DEPTHWISE_CONV2D":
            lt = M.LayerType.DEPTHWISE_CONV2D
        elif op == "CONV2D":
            lt = M.LayerType.CONV2D
        elif op in _SIMPLE_OPS:
            lt = _SIMPLE_OPS[op]
        else:
            raise ValueError(
                f"op {node.op!r} has no .mars layer type (node {node.name})")

        if lt in (M.LayerType.CONV2D, M.LayerType.DEPTHWISE_CONV2D):
            win = add_tensor(node.inputs[1]) if len(node.inputs) > 1 \
                else M.NO_TENSOR
            bin_ = add_tensor(node.inputs[2]) if len(node.inputs) > 2 \
                else M.NO_TENSOR
            ep = a.get("explicit_pad", (0, 0, 0, 0))
            params: M.Params = M.ConvParams(
                kernel_h=a["kernel"][0], kernel_w=a["kernel"][1],
                stride_h=a["stride"][0], stride_w=a["stride"][1],
                dilation_h=a.get("dilation", (1, 1))[0],
                dilation_w=a.get("dilation", (1, 1))[1],
                padding=M.Padding[a.get("padding", "VALID")],
                pad_top=ep[0], pad_bottom=ep[1], pad_left=ep[2],
                pad_right=ep[3],
                groups=a.get("groups", 1),
                activation=_ACT.get(a.get("activation", "NONE"),
                                    M.Activation.NONE),
                weight_tensor_id=win, bias_tensor_id=bin_)
            ins = [add_tensor(node.inputs[0])]
        elif lt in (M.LayerType.MAXPOOL, M.LayerType.AVGPOOL,
                    M.LayerType.GLOBAL_AVGPOOL):
            ep = a.get("explicit_pad", (0, 0, 0, 0))
            params = M.PoolParams(
                kernel_h=a.get("kernel", (2, 2))[0],
                kernel_w=a.get("kernel", (2, 2))[1],
                stride_h=a.get("stride", (2, 2))[0],
                stride_w=a.get("stride", (2, 2))[1],
                padding=M.Padding[a.get("padding", "VALID")],
                pad_top=ep[0], pad_bottom=ep[1], pad_left=ep[2],
                pad_right=ep[3])
            ins = [add_tensor(i) for i in node.inputs]
        elif lt == M.LayerType.CONCAT:
            params = M.ConcatParams(axis=a.get("axis", 3),
                                    num_inputs=len(node.inputs))
            ins = [add_tensor(i) for i in node.inputs]
        elif lt == M.LayerType.UPSAMPLE:
            sc = a.get("scale", (2, 2))
            params = M.UpsampleParams(scale_h=sc[0], scale_w=sc[1],
                                      mode=a.get("mode", 0))
            ins = [add_tensor(i) for i in node.inputs]
        elif lt in (M.LayerType.RESHAPE, M.LayerType.TRANSPOSE):
            params = M.ReshapeParams(
                new_shape=tuple(a.get("new_shape",
                                      a.get("perm", ()))))
            ins = [add_tensor(i) for i in node.inputs]
        elif lt == M.LayerType.FC:
            win = add_tensor(node.inputs[1]) if len(node.inputs) > 1 \
                else M.NO_TENSOR
            bin_ = add_tensor(node.inputs[2]) if len(node.inputs) > 2 \
                else M.NO_TENSOR
            params = M.FCParams(
                weight_tensor_id=win, bias_tensor_id=bin_,
                activation=_ACT.get(a.get("activation", "NONE"),
                                    M.Activation.NONE))
            ins = [add_tensor(node.inputs[0])]
        else:
            params = M.ActParams(alpha=float(a.get("alpha", 0.0) or 0.0))
            ins = [add_tensor(i) for i in node.inputs]

        outs = [add_tensor(o) for o in node.outputs]
        layers.append(M.MarsLayer(
            id=li, type=lt, inputs=tuple(ins), outputs=tuple(outs),
            params=params))

    model = M.build_mars(
        tensors, layers,
        [tid[n] for n in graph.inputs],
        [tid[n] for n in graph.outputs],
        weight_arrays)
    return M.write_mars(model, path)
