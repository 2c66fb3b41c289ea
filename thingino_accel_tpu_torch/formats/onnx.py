"""ONNX -> IR importer (the mars-compiler front-end).

Copy of ``thingino_accel_tpu/formats/onnx.py`` (numpy only), with one
repair: a QuantizeLinear / DequantizeLinear whose scale or zero point has
more than one element is not read as its first element (JAX's does,
ROADMAP.md C.14). In float32 mode a DequantizeLinear of a constant
dequantizes along its ``axis``, as the ONNX operator defines it; in int8
mode, whose tensors carry one scale, such a node raises
``NotImplementedError``.

Covers the reference compiler's op table (``mars-compiler/src/main.rs:
76-103``: Conv/MaxPool/AveragePool/Relu/LeakyRelu/Sigmoid/Mul/Add/Concat/
Resize/Reshape/Transpose/Softmax/BatchNorm + QDQ scale extraction) and
goes beyond it: Split/Slice/Pow/Clip/Gemm/MatMul/Flatten are imported
instead of skipped, so detect heads survive intact (the reference skips
them and emits dangling graphs — see ir.graph._materialize_dangling).

Two modes:
- float32: QDQ pairs fold away (DQ(const) becomes an f32 const), all
  activations f32.
- int8 (QDQ models): Q/DQ pairs collapse onto int8 tensors with
  per-tensor scales, conv weights stay int8 — feeds the integer engine.

Activations are canonicalized NCHW -> NHWC at import (axis/perm/pad
attributes remapped); weights stay OIHW as the IR expects.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from thingino_accel_tpu_torch.formats import onnx_proto as OP
from thingino_accel_tpu_torch.ir.graph import Graph, Node, QuantInfo, TensorInfo


class _Ctx:
    def __init__(self, g: OP.GraphProto, float32: bool, verbose: bool):
        self.g = g
        self.float32 = float32
        self.verbose = verbose
        self.graph = Graph(nodes=[], tensors={}, inputs=[], outputs=[],
                           name=g.name or "onnx")
        # name -> const numpy array (initializers + folded constants)
        self.consts: Dict[str, np.ndarray] = {
            k: t.array for k, t in g.initializers.items() if t.array is not None}
        # activation name -> NHWC shape
        self.shapes: Dict[str, Tuple[int, ...]] = {}
        # activation name -> dtype
        self.dtypes: Dict[str, np.dtype] = {}
        # activation name -> quant scale (int8 mode)
        self.scales: Dict[str, float] = {}
        self.zero_points: Dict[str, int] = {}
        # onnx name -> ir name (aliasing for folded ops)
        self.alias: Dict[str, str] = {}
        # 4-D activations stored in ONNX order (not NHWC) — GRU Y outputs
        # and tensors derived from them; reshape/transpose handlers must
        # not apply the NHWC bracket to these.
        self.onnx4d: set = set()
        # int8 mode: DQ'd constant -> its weight scale (read, not popped, by
        # each conv: a DQ'd weight initializer can feed several), and a Q'd
        # tensor -> the scale a conv producing it takes (popped)
        self.wscale: Dict[str, float] = {}
        self.pending_out_scale: Dict[str, float] = {}

    def log(self, msg: str) -> None:
        if self.verbose:
            print(f"[onnx] {msg}")

    def resolve(self, name: str) -> str:
        while name in self.alias:
            name = self.alias[name]
        return name

    def const_of(self, name: str) -> Optional[np.ndarray]:
        return self.consts.get(self.resolve(name))

    def shape_of(self, name: str) -> Tuple[int, ...]:
        name = self.resolve(name)
        if name in self.shapes:
            return self.shapes[name]
        c = self.consts.get(name)
        if c is not None:
            return tuple(c.shape)
        raise KeyError(f"unknown shape for {name!r}")

    def dtype_of(self, name: str) -> np.dtype:
        name = self.resolve(name)
        if name in self.dtypes:
            return self.dtypes[name]
        c = self.consts.get(name)
        if c is not None:
            return c.dtype
        return np.dtype(np.float32)

    def add_const(self, name: str, arr: np.ndarray,
                  scale: float = 1.0) -> str:
        self.graph.tensors[name] = TensorInfo(
            name=name, shape=tuple(arr.shape), dtype=arr.dtype,
            quant=QuantInfo(scale=scale), data=arr)
        self.consts[name] = arr
        return name

    def add_act(self, name: str, shape: Tuple[int, ...],
                dtype: np.dtype, scale: float = 1.0) -> str:
        self.graph.tensors[name] = TensorInfo(
            name=name, shape=tuple(int(s) for s in shape),
            dtype=np.dtype(dtype), quant=QuantInfo(scale=float(scale)))
        self.shapes[name] = tuple(int(s) for s in shape)
        self.dtypes[name] = np.dtype(dtype)
        self.scales[name] = float(scale)
        return name

    def emit(self, op: str, ins: Sequence[str], outs: Sequence[str],
             attrs: Optional[dict] = None, name: str = "") -> None:
        self.graph.nodes.append(Node(
            op=op, inputs=list(ins), outputs=list(outs),
            attrs=attrs or {}, name=name))


def _to_nhwc_shape(shape: Tuple[int, ...]) -> Tuple[int, ...]:
    if len(shape) == 4:
        n, c, h, w = shape
        return (n, h, w, c)
    return shape


def _axis_to_nhwc(axis: int, rank: int) -> int:
    """Map an NCHW axis index to NHWC for 4-D tensors."""
    if rank != 4:
        return axis
    if axis < 0:
        axis += rank
    return {0: 0, 1: 3, 2: 1, 3: 2}[axis]


def _conv_out_hw(h, w, kh, kw, sh, sw, dh, dw, pt, pb, pl, pr):
    eh = (kh - 1) * dh + 1
    ew = (kw - 1) * dw + 1
    return (h + pt + pb - eh) // sh + 1, (w + pl + pr - ew) // sw + 1


def _resolve_autopad(node: OP.NodeProto, h, w, kh, kw, sh, sw, dh=1, dw=1):
    """ONNX pads [pt, pl, pb, pr] or auto_pad SAME_UPPER/LOWER/VALID."""
    ap = node.attr_s("auto_pad", "NOTSET")
    pads = node.attr_ints("pads", (0, 0, 0, 0))
    if ap in ("NOTSET", "", "VALID"):
        if ap == "VALID":
            return 0, 0, 0, 0
        if len(pads) == 4:
            return pads[0], pads[2], pads[1], pads[3]  # -> pt, pb, pl, pr
        return 0, 0, 0, 0
    # SAME_*: output = ceil(in/stride)
    oh = -(-h // sh)
    ow = -(-w // sw)
    eh = (kh - 1) * dh + 1
    ew = (kw - 1) * dw + 1
    ph = max(0, (oh - 1) * sh + eh - h)
    pw = max(0, (ow - 1) * sw + ew - w)
    if ap == "SAME_UPPER":
        return ph // 2, ph - ph // 2, pw // 2, pw - pw // 2
    return ph - ph // 2, ph // 2, pw - pw // 2, pw // 2


def import_onnx(src, float32: bool = False, verbose: bool = False) -> Graph:
    """Import an ONNX model (path/bytes) into the NHWC IR."""
    model = OP.load(src)
    g = model.graph
    ctx = _Ctx(g, float32, verbose)

    init_names = set(g.initializers)
    for name, shape, elem in g.inputs:
        if name in init_names:
            continue
        shape = tuple(max(int(d), 1) for d in shape)
        dtype = OP._NP_DTYPE.get(elem, np.float32)
        ctx.add_act(name, _to_nhwc_shape(shape), dtype)
        ctx.graph.inputs.append(name)

    for node in g.nodes:
        _import_node(ctx, node)

    outs = []
    for name, _, _ in g.outputs:
        rname = ctx.resolve(name)
        if rname in ctx.graph.tensors:
            outs.append(rname)
        else:
            ctx.log(f"output {name} unavailable (producer unsupported)")
    ctx.graph.outputs = outs
    ctx.graph.validate()
    return ctx.graph


def _import_node(ctx: _Ctx, n: OP.NodeProto) -> None:
    op = n.op_type
    handler = _HANDLERS.get(op)
    if handler is None:
        ctx.log(f"skipping unsupported op {op} ({n.name})")
        return
    try:
        handler(ctx, n)
    except KeyError as e:
        # producer of an input was itself skipped — propagate the skip
        # (the reference compiler does the same silently; we log)
        ctx.log(f"skipping {op} ({n.name}): missing dep {e}")


# -- handlers ----------------------------------------------------------------


def _h_conv(ctx: _Ctx, n: OP.NodeProto) -> None:
    x = ctx.resolve(n.inputs[0])
    w = ctx.const_of(n.inputs[1])
    if w is None:
        ctx.log(f"Conv {n.name}: non-const weights unsupported, skipping")
        return
    b = ctx.const_of(n.inputs[2]) if len(n.inputs) > 2 else None
    xs = ctx.shape_of(x)
    if len(xs) == 3:       # Conv1D: [N, C, L] kept in ONNX layout
        _h_conv1d(ctx, n, x, w, b, xs)
        return
    nb, h, wd, cin = xs
    o, ig, kh, kw = w.shape
    groups = n.attr_i("group", 1)
    strides = n.attr_ints("strides", (1, 1))
    dil = n.attr_ints("dilations", (1, 1))
    pt, pb, pl, pr = _resolve_autopad(
        n, h, wd, kh, kw, strides[0], strides[1], dil[0], dil[1])
    oh, ow = _conv_out_hw(h, wd, kh, kw, strides[0], strides[1],
                          dil[0], dil[1], pt, pb, pl, pr)

    is_int8 = w.dtype == np.int8 and not ctx.float32
    # get, not pop: a DQ'd weight initializer can feed several convs
    wq = ctx.wscale.get(n.inputs[1], 1.0)
    wname = ctx.add_const(f"{n.outputs[0]}__w", w, scale=wq)
    ins = [x, wname]
    if b is not None:
        if is_int8 and np.issubdtype(b.dtype, np.floating):
            xscale = ctx.scales.get(x, 1.0)
            denom = np.float32(xscale) * np.float32(wq) or np.float32(1.0)
            b = np.round(b.astype(np.float64) / denom).astype(np.int32)
        ins.append(ctx.add_const(f"{n.outputs[0]}__b", b))

    out_dtype = np.int8 if is_int8 else np.float32
    out_scale = ctx.pending_out_scale.pop(n.outputs[0], 1.0)
    out = ctx.add_act(n.outputs[0], (nb, oh, ow, o), out_dtype, out_scale)
    depthwise = groups > 1 and groups == cin and ig == 1
    ctx.emit(
        "DEPTHWISE_CONV2D" if depthwise else "CONV2D",
        ins, [out],
        attrs=dict(kernel=(kh, kw), stride=tuple(strides),
                   dilation=tuple(dil), padding="EXPLICIT",
                   explicit_pad=(pt, pb, pl, pr), groups=groups,
                   activation="NONE"),
        name=n.name or n.outputs[0])


def _h_conv1d(ctx: _Ctx, n: OP.NodeProto, x, w, b, xs) -> None:
    """Conv1D (audio models): [N, C, L] in, OIW weights; lowered by the
    executor via a channels-last matmul decomposition."""
    nb, cin, ln = xs
    o, ig, k = w.shape
    strides = n.attr_ints("strides", (1,))
    pads = n.attr_ints("pads", (0, 0))
    dil = n.attr_ints("dilations", (1,))
    eff_k = (k - 1) * dil[0] + 1
    ol = (ln + pads[0] + pads[1] - eff_k) // strides[0] + 1
    wname = ctx.add_const(f"{n.outputs[0]}__w", w)
    ins = [x, wname]
    if b is not None:
        ins.append(ctx.add_const(f"{n.outputs[0]}__b", b))
    out = ctx.add_act(n.outputs[0], (nb, o, ol), np.float32)
    ctx.emit("CONV1D", ins, [out],
             attrs=dict(kernel=k, stride=strides[0], dilation=dil[0],
                        pads=tuple(pads), groups=n.attr_i("group", 1)),
             name=n.name)


def _h_convtranspose(ctx: _Ctx, n: OP.NodeProto) -> None:
    """ConvTranspose1D (AEC decoder upsampling): [N, C, L] in,
    weight [C_in, C_out/groups, K]."""
    x = ctx.resolve(n.inputs[0])
    w = ctx.const_of(n.inputs[1])
    if w is None:
        ctx.log(f"ConvTranspose {n.name}: non-const weights unsupported")
        return
    b = ctx.const_of(n.inputs[2]) if len(n.inputs) > 2 else None
    xs = ctx.shape_of(x)
    if len(xs) != 3:
        ctx.log(f"ConvTranspose {n.name}: only 1-D supported, skipping")
        return
    nb, cin, ln = xs
    _, og, k = w.shape
    strides = n.attr_ints("strides", (1,))
    pads = n.attr_ints("pads", (0, 0))
    opad = n.attr_ints("output_padding", (0,))
    ol = (ln - 1) * strides[0] + k - pads[0] - pads[1] + opad[0]
    wname = ctx.add_const(f"{n.outputs[0]}__w", w)
    ins = [x, wname]
    if b is not None:
        ins.append(ctx.add_const(f"{n.outputs[0]}__b", b))
    out = ctx.add_act(n.outputs[0], (nb, og * n.attr_i("group", 1), ol),
                      np.float32)
    ctx.emit("CONV1D_TRANSPOSE", ins, [out],
             attrs=dict(kernel=k, stride=strides[0], pads=tuple(pads),
                        out_len=ol),
             name=n.name)


def _h_squeeze(ctx: _Ctx, n: OP.NodeProto) -> None:
    x = ctx.resolve(n.inputs[0])
    cx = ctx.const_of(n.inputs[0])
    axes = list(n.attr_ints("axes", ()))
    if not axes and len(n.inputs) > 1:
        c = ctx.const_of(n.inputs[1])
        if c is not None:
            axes = [int(v) for v in c.reshape(-1)]
    if cx is not None:
        ctx.consts[n.outputs[0]] = (np.squeeze(cx, tuple(axes))
                                    if axes else np.squeeze(cx))
        ctx.add_const(n.outputs[0], ctx.consts[n.outputs[0]])
        return
    shape = list(ctx.shape_of(x))
    rank = len(shape)
    if rank == 4 and x not in ctx.onnx4d:   # axes are ONNX(NCHW)-indexed
        shape = [shape[0], shape[3], shape[1], shape[2]]
    if n.op_type == "Unsqueeze":
        out_rank = rank + len(axes)
        for a in sorted(a if a >= 0 else a + out_rank for a in axes):
            shape.insert(a, 1)
    else:
        axes = [a if a >= 0 else a + rank for a in axes] or \
            [i for i, d in enumerate(shape) if d == 1]
        shape = [d for i, d in enumerate(shape) if i not in axes]
    _emit_reshape_onnx(ctx, n, x, shape)


def _h_pool(ctx: _Ctx, n: OP.NodeProto) -> None:
    x = ctx.resolve(n.inputs[0])
    nb, h, w, c = ctx.shape_of(x)
    ks = n.attr_ints("kernel_shape", (2, 2))
    st = n.attr_ints("strides", ks)
    pt, pb, pl, pr = _resolve_autopad(n, h, w, ks[0], ks[1], st[0], st[1])
    ceil_mode = n.attr_i("ceil_mode", 0)
    if ceil_mode:
        oh = -(-(h + pt + pb - ks[0]) // st[0]) + 1
        ow = -(-(w + pl + pr - ks[1]) // st[1]) + 1
    else:
        oh = (h + pt + pb - ks[0]) // st[0] + 1
        ow = (w + pl + pr - ks[1]) // st[1] + 1
    dt = ctx.dtype_of(x)
    out = ctx.add_act(n.outputs[0], (nb, oh, ow, c), dt, ctx.scales.get(x, 1.0))
    op = "MAXPOOL" if n.op_type == "MaxPool" else "AVGPOOL"
    ctx.emit(op, [x], [out],
             attrs=dict(kernel=tuple(ks), stride=tuple(st),
                        padding="EXPLICIT", explicit_pad=(pt, pb, pl, pr)),
             name=n.name)


def _h_gap(ctx: _Ctx, n: OP.NodeProto) -> None:
    x = ctx.resolve(n.inputs[0])
    nb, h, w, c = ctx.shape_of(x)
    out = ctx.add_act(n.outputs[0], (nb, 1, 1, c), ctx.dtype_of(x),
                      ctx.scales.get(x, 1.0))
    ctx.emit("GLOBAL_AVGPOOL", [x], [out], name=n.name)


def _unary(op: str, **extra):
    def h(ctx: _Ctx, n: OP.NodeProto) -> None:
        x = ctx.resolve(n.inputs[0])
        attrs = dict(extra)
        if op == "LEAKY_RELU":
            attrs["alpha"] = n.attr_f("alpha", 0.01)
        out = ctx.add_act(n.outputs[0], ctx.shape_of(x), ctx.dtype_of(x),
                          ctx.scales.get(x, 1.0))
        ctx.emit(op, [x], [out], attrs=attrs, name=n.name)
    return h


def _h_clip(ctx: _Ctx, n: OP.NodeProto) -> None:
    lo = n.attr_f("min", None) if "min" in n.attrs else None
    hi = n.attr_f("max", None) if "max" in n.attrs else None
    if lo is None and len(n.inputs) > 1 and n.inputs[1]:
        c = ctx.const_of(n.inputs[1])
        lo = float(c) if c is not None else None
    if hi is None and len(n.inputs) > 2 and n.inputs[2]:
        c = ctx.const_of(n.inputs[2])
        hi = float(c) if c is not None else None
    x = ctx.resolve(n.inputs[0])
    if lo == 0.0 and hi == 6.0:
        out = ctx.add_act(n.outputs[0], ctx.shape_of(x), ctx.dtype_of(x),
                          ctx.scales.get(x, 1.0))
        ctx.emit("RELU6", [x], [out], name=n.name)
    elif lo == 0.0 and hi is None:
        out = ctx.add_act(n.outputs[0], ctx.shape_of(x), ctx.dtype_of(x),
                          ctx.scales.get(x, 1.0))
        ctx.emit("RELU", [x], [out], name=n.name)
    else:
        out = ctx.add_act(n.outputs[0], ctx.shape_of(x), ctx.dtype_of(x),
                          ctx.scales.get(x, 1.0))
        ctx.emit("CLIP", [x], [out],
                 attrs=dict(min=lo, max=hi), name=n.name)


def _h_binary(op: str):
    def h(ctx: _Ctx, n: OP.NodeProto) -> None:
        a_name, b_name = n.inputs[0], n.inputs[1]
        ca, cb = ctx.const_of(a_name), ctx.const_of(b_name)
        if ca is not None and cb is not None:   # constant fold
            fn = {"ADD": np.add, "MUL": np.multiply, "SUB": np.subtract,
                  "DIV": np.divide, "POW": np.power}[op]
            ctx.consts[n.outputs[0]] = fn(ca, cb)
            ctx.add_const(n.outputs[0], ctx.consts[n.outputs[0]])
            return
        ins = []
        shapes = []
        for nm, c in ((a_name, ca), (b_name, cb)):
            r = ctx.resolve(nm)
            if c is not None and r not in ctx.graph.tensors:
                # materialize const operand, NCHW-broadcast -> NHWC layout
                arr = c
                if arr.ndim == 3 and len(ctx.shape_of(
                        ctx.resolve(b_name if nm == a_name else a_name))) == 4:
                    arr = np.transpose(arr, (1, 2, 0))  # C,H,W -> H,W,C
                elif arr.ndim == 4:
                    arr = np.transpose(arr, (0, 2, 3, 1))
                r = ctx.add_const(f"{n.outputs[0]}__c{len(ins)}", arr)
            ins.append(r)
            t = ctx.graph.tensors[r]
            shapes.append(t.shape)
        out_shape = tuple(np.broadcast_shapes(*shapes))
        dt = ctx.dtype_of(ins[0])
        sc = ctx.scales.get(ins[0], 1.0)
        out = ctx.add_act(n.outputs[0], out_shape, dt, sc)
        ctx.emit(op, ins, [out], name=n.name)
    return h


def _h_concat(ctx: _Ctx, n: OP.NodeProto) -> None:
    ins = [ctx.resolve(i) for i in n.inputs]
    if all(ctx.const_of(i) is not None for i in n.inputs):
        axis = n.attr_i("axis", 0)
        ctx.consts[n.outputs[0]] = np.concatenate(
            [ctx.const_of(i) for i in n.inputs], axis=axis)
        ctx.add_const(n.outputs[0], ctx.consts[n.outputs[0]])
        return
    shapes = [ctx.shape_of(i) for i in ins]
    rank = len(shapes[0])
    axis = _axis_to_nhwc(n.attr_i("axis", 1), rank)
    out_shape = list(shapes[0])
    out_shape[axis] = sum(s[axis] for s in shapes)
    out = ctx.add_act(n.outputs[0], tuple(out_shape), ctx.dtype_of(ins[0]),
                      ctx.scales.get(ins[0], 1.0))
    ctx.emit("CONCAT", ins, [out], attrs=dict(axis=axis), name=n.name)


def _h_resize(ctx: _Ctx, n: OP.NodeProto) -> None:
    x = ctx.resolve(n.inputs[0])
    nb, h, w, c = ctx.shape_of(x)
    mode = n.attr_s("mode", "nearest")
    sh = sw = 2
    # Resize-11+: inputs [X, roi, scales, sizes]
    if len(n.inputs) > 2 and n.inputs[2]:
        sc = ctx.const_of(n.inputs[2])
        if sc is not None and sc.size == 4:
            fh, fw = float(sc[2]), float(sc[3])
            if fh < 1.0 or fw < 1.0 or fh != int(fh) or fw != int(fw):
                raise ValueError(
                    f"Resize {n.name}: only integer upscale supported "
                    f"(scales {fh}x{fw})")
            sh, sw = int(fh), int(fw)
    if len(n.inputs) > 3 and n.inputs[3]:
        sz = ctx.const_of(n.inputs[3])
        if sz is not None and sz.size == 4:
            th, tw = int(sz[2]), int(sz[3])
            if th < h or tw < w or th % h or tw % w:
                raise ValueError(
                    f"Resize {n.name}: only integer upscale supported "
                    f"(sizes {th}x{tw} from {h}x{w})")
            sh, sw = th // h, tw // w
    out = ctx.add_act(n.outputs[0], (nb, h * sh, w * sw, c),
                      ctx.dtype_of(x), ctx.scales.get(x, 1.0))
    ctx.emit("UPSAMPLE", [x], [out],
             attrs=dict(scale=(sh, sw),
                        mode=0 if mode.startswith("nearest") else 1),
             name=n.name)


def _emit_reshape_onnx(ctx: _Ctx, n: OP.NodeProto, x: str, tgt) -> None:
    """Emit RESHAPE with ONNX (NCHW) element-order semantics.

    4-D activations are stored NHWC in the IR, but ONNX Reshape/Flatten/
    Squeeze element order is defined over the NCHW buffer (and any
    downstream Gemm weights assume it), so bracket the raw reshape with
    transposes wherever the rank crosses 4.
    """
    in_shape = ctx.shape_of(x)
    tgt = [int(v) for v in tgt]
    src = x
    if len(in_shape) == 4 and x not in ctx.onnx4d:
        nchw = tuple(in_shape[i] for i in (0, 3, 1, 2))
        t = ctx.add_act(f"{n.outputs[0]}__nchw", nchw, ctx.dtype_of(x),
                        ctx.scales.get(x, 1.0))
        ctx.emit("TRANSPOSE", [x], [t], attrs=dict(perm=(0, 3, 1, 2)),
                 name=f"{n.name}__to_nchw")
        src = t
    if len(tgt) == 4:
        mid = ctx.add_act(f"{n.outputs[0]}__pre", tuple(tgt),
                          ctx.dtype_of(x), ctx.scales.get(x, 1.0))
        ctx.emit("RESHAPE", [src], [mid],
                 attrs=dict(new_shape=tuple(tgt)), name=n.name)
        nhwc = tuple(tgt[i] for i in (0, 2, 3, 1))
        out = ctx.add_act(n.outputs[0], nhwc, ctx.dtype_of(x),
                          ctx.scales.get(x, 1.0))
        ctx.emit("TRANSPOSE", [mid], [out], attrs=dict(perm=(0, 2, 3, 1)),
                 name=f"{n.name}__to_nhwc")
    else:
        out = ctx.add_act(n.outputs[0], tuple(tgt), ctx.dtype_of(x),
                          ctx.scales.get(x, 1.0))
        ctx.emit("RESHAPE", [src], [out],
                 attrs=dict(new_shape=tuple(tgt)), name=n.name)


def _h_reshape(ctx: _Ctx, n: OP.NodeProto) -> None:
    x = ctx.resolve(n.inputs[0])
    cx = ctx.const_of(n.inputs[0])
    target = ctx.const_of(n.inputs[1]) if len(n.inputs) > 1 else None
    if target is None:
        ctx.log(f"Reshape {n.name}: dynamic shape unsupported, aliasing")
        ctx.alias[n.outputs[0]] = x
        return
    tgt = [int(v) for v in target.reshape(-1)]
    if cx is not None:
        ctx.consts[n.outputs[0]] = cx.reshape(
            [cx.size if v == -1 else v for v in tgt] if -1 in tgt else tgt)
        ctx.add_const(n.outputs[0], ctx.consts[n.outputs[0]])
        return
    in_shape = list(ctx.shape_of(x))
    # 0 copies the input dim at the SAME position, in ONNX (NCHW)
    # terms — 4-D activations are stored NHWC here
    shape_onnx = ([in_shape[0], in_shape[3], in_shape[1], in_shape[2]]
                  if len(in_shape) == 4 and x not in ctx.onnx4d
                  else in_shape)
    tgt = [shape_onnx[i] if v == 0 and i < len(shape_onnx) else v
           for i, v in enumerate(tgt)]
    numel = int(np.prod(in_shape))
    known = int(np.prod([v for v in tgt if v > 0])) or 1
    tgt = [numel // known if v == -1 else v for v in tgt]
    _emit_reshape_onnx(ctx, n, x, tgt)


def _h_transpose(ctx: _Ctx, n: OP.NodeProto) -> None:
    x = ctx.resolve(n.inputs[0])
    cx = ctx.const_of(n.inputs[0])
    perm = n.attr_ints("perm", ())
    if cx is not None:
        ctx.consts[n.outputs[0]] = np.transpose(cx, perm or None)
        ctx.add_const(n.outputs[0], ctx.consts[n.outputs[0]])
        return
    in_shape = ctx.shape_of(x)
    rank = len(in_shape)
    perm = list(perm) if perm else list(reversed(range(rank)))
    out_shape = tuple(in_shape[p] for p in perm) if rank != 4 else None
    mark_onnx4d = False
    if rank == 4 and x not in ctx.onnx4d:
        # perm given in NCHW terms; our tensor is NHWC. Compose:
        # NHWC -> NCHW -> perm -> NHWC
        to_nchw = [0, 3, 1, 2]
        to_nhwc = [0, 2, 3, 1]
        full = [to_nchw[perm[to_nhwc[i]]] for i in range(4)]
        out_shape = tuple(in_shape[p] for p in full)
        perm = full
    elif rank == 4:
        # ONNX-order 4-D tensor (GRU Y family): plain permutation,
        # result stays ONNX-ordered.
        out_shape = tuple(in_shape[p] for p in perm)
        mark_onnx4d = True
    out = ctx.add_act(n.outputs[0], out_shape, ctx.dtype_of(x),
                      ctx.scales.get(x, 1.0))
    if mark_onnx4d:
        ctx.onnx4d.add(out)
    ctx.emit("TRANSPOSE", [x], [out], attrs=dict(perm=tuple(perm)),
             name=n.name)


def _h_softmax(ctx: _Ctx, n: OP.NodeProto) -> None:
    x = ctx.resolve(n.inputs[0])
    shape = ctx.shape_of(x)
    axis = _axis_to_nhwc(n.attr_i("axis", -1), len(shape))
    out = ctx.add_act(n.outputs[0], shape, ctx.dtype_of(x),
                      ctx.scales.get(x, 1.0))
    ctx.emit("SOFTMAX", [x], [out], attrs=dict(axis=axis), name=n.name)


def _h_bn(ctx: _Ctx, n: OP.NodeProto) -> None:
    x = ctx.resolve(n.inputs[0])
    gamma = ctx.const_of(n.inputs[1])
    beta = ctx.const_of(n.inputs[2])
    mean = ctx.const_of(n.inputs[3])
    var = ctx.const_of(n.inputs[4])
    eps = n.attr_f("epsilon", 1e-5)
    # fuse: y = x * s + t (the reference's BN folding,
    # mars-compiler/src/main.rs:1036-1090)
    s = (gamma / np.sqrt(var + eps)).astype(np.float32)
    t = (beta - mean * s).astype(np.float32)
    sn = ctx.add_const(f"{n.outputs[0]}__scale", s)
    tn = ctx.add_const(f"{n.outputs[0]}__bias", t)
    out = ctx.add_act(n.outputs[0], ctx.shape_of(x), ctx.dtype_of(x),
                      ctx.scales.get(x, 1.0))
    ctx.emit("BATCHNORM", [x, sn, tn], [out], name=n.name)


def _h_gemm(ctx: _Ctx, n: OP.NodeProto) -> None:
    x = ctx.resolve(n.inputs[0])
    w = ctx.const_of(n.inputs[1])
    if w is None:
        ctx.log(f"{n.op_type} {n.name}: non-const weights unsupported")
        return
    b = ctx.const_of(n.inputs[2]) if len(n.inputs) > 2 else None
    if n.op_type == "Gemm":
        if n.attr_i("transA", 0):
            raise ValueError(f"Gemm {n.name}: transA unsupported")
        alpha = n.attr_f("alpha", 1.0)
        beta = n.attr_f("beta", 1.0)
        if n.attr_i("transB", 0):
            w = w.T
        # fold alpha/beta into the consts instead of silently
        # computing the unscaled product
        if alpha != 1.0:
            w = w * np.asarray(alpha, w.dtype)
        if b is not None and beta != 1.0:
            b = b * np.asarray(beta, b.dtype)
    in_shape = ctx.shape_of(x)
    k, o = w.shape
    wn = ctx.add_const(f"{n.outputs[0]}__w", np.ascontiguousarray(w))
    if b is not None:
        bn_ = ctx.add_const(f"{n.outputs[0]}__b", b)
    if len(in_shape) > 2:
        # MatMul over leading batch dims ([..., K] @ [K, O]): the FC
        # executor flattens to (rows0, -1), so reshape to 2-D rows
        # first and restore the leading dims after
        if in_shape[-1] != k:
            raise ValueError(
                f"{n.op_type} {n.name}: contraction dim "
                f"{in_shape[-1]} != weight K {k}")
        rows = int(np.prod(in_shape[:-1]))
        flat = ctx.add_act(f"{n.outputs[0]}__2d", (rows, k),
                           ctx.dtype_of(x), ctx.scales.get(x, 1.0))
        ctx.emit("RESHAPE", [x], [flat],
                 attrs=dict(new_shape=(rows, k)), name=f"{n.name}__2d")
        fc_out = ctx.add_act(f"{n.outputs[0]}__fc", (rows, o),
                             ctx.dtype_of(x), ctx.scales.get(x, 1.0))
        ins = [flat, wn] + ([bn_] if b is not None else [])
        ctx.emit("FC", ins, [fc_out], attrs=dict(activation="NONE"),
                 name=n.name)
        out_shape = tuple(in_shape[:-1]) + (o,)
        out = ctx.add_act(n.outputs[0], out_shape, ctx.dtype_of(x),
                          ctx.scales.get(x, 1.0))
        ctx.emit("RESHAPE", [fc_out], [out],
                 attrs=dict(new_shape=out_shape), name=f"{n.name}__nd")
        return
    ins = [x, wn] + ([bn_] if b is not None else [])
    out = ctx.add_act(n.outputs[0], (in_shape[0], o), ctx.dtype_of(x),
                      ctx.scales.get(x, 1.0))
    ctx.emit("FC", ins, [out], attrs=dict(activation="NONE"), name=n.name)


def _h_flatten(ctx: _Ctx, n: OP.NodeProto) -> None:
    x = ctx.resolve(n.inputs[0])
    shape = list(ctx.shape_of(x))
    if len(shape) == 4 and x not in ctx.onnx4d:   # flatten order is NCHW
        shape = [shape[0], shape[3], shape[1], shape[2]]
    axis = n.attr_i("axis", 1)
    if axis < 0:
        axis += len(shape)
    tgt = (int(np.prod(shape[:axis])) if axis else 1,
           int(np.prod(shape[axis:])) if axis < len(shape) else 1)
    _emit_reshape_onnx(ctx, n, x, tgt)


def _h_split(ctx: _Ctx, n: OP.NodeProto) -> None:
    x = ctx.resolve(n.inputs[0])
    shape = ctx.shape_of(x)
    rank = len(shape)
    axis = _axis_to_nhwc(n.attr_i("axis", 0), rank)
    sizes = list(n.attr_ints("split", ()))
    if not sizes and len(n.inputs) > 1:
        c = ctx.const_of(n.inputs[1])
        if c is not None:
            sizes = [int(v) for v in c.reshape(-1)]
    if not sizes:
        k = len(n.outputs)
        sizes = [shape[axis] // k] * k
    outs = []
    for out_name, sz in zip(n.outputs, sizes):
        s = list(shape)
        s[axis] = sz
        outs.append(ctx.add_act(out_name, tuple(s), ctx.dtype_of(x),
                                ctx.scales.get(x, 1.0)))
    ctx.emit("SPLIT", [x], outs,
             attrs=dict(axis=axis, sizes=tuple(sizes)), name=n.name)


def _h_slice(ctx: _Ctx, n: OP.NodeProto) -> None:
    x = ctx.resolve(n.inputs[0])
    cx = ctx.const_of(n.inputs[0])

    def arr(i, default=None):
        if len(n.inputs) > i and n.inputs[i]:
            c = ctx.const_of(n.inputs[i])
            if c is not None:
                return [int(v) for v in c.reshape(-1)]
        return default

    starts = arr(1, list(n.attr_ints("starts", ())))
    ends = arr(2, list(n.attr_ints("ends", ())))
    axes = arr(3, list(n.attr_ints("axes", ())) or None)
    steps = arr(4, None)
    if cx is not None:
        sl = [slice(None)] * cx.ndim
        axes = axes or list(range(len(starts)))
        steps = steps or [1] * len(starts)
        for a, s, e, st in zip(axes, starts, ends, steps):
            sl[a] = slice(s, e, st)
        ctx.consts[n.outputs[0]] = cx[tuple(sl)]
        ctx.add_const(n.outputs[0], ctx.consts[n.outputs[0]])
        return
    shape = ctx.shape_of(x)
    rank = len(shape)
    axes = axes or list(range(len(starts)))
    steps = steps or [1] * len(starts)
    axes = [_axis_to_nhwc(a, rank) for a in axes]
    out_shape = list(shape)
    norm = []
    for a, s, e, st in zip(axes, starts, ends, steps):
        dim = shape[a]
        if st > 0:
            s = max(0, s + dim) if s < 0 else min(s, dim)
            e = max(0, e + dim) if e < 0 else min(e, dim)
            out_shape[a] = max(0, -(-(e - s) // st))
            norm.append((a, s, e, st))
        else:
            # reverse slice (step < 0): ONNX clamps start into
            # [0, dim-1]; an end below -dim means "past the first
            # element", expressible only as a None stop (the executor
            # builds python slices from these attrs, and a negative
            # int stop would re-wrap)
            s = s + dim if s < 0 else min(s, dim - 1)
            if s < 0:
                out_shape[a] = 0
                norm.append((a, 0, 0, 1))
                continue
            if e < -dim:
                e = None
                n_el = -(-(s + 1) // (-st))
            else:
                e = e + dim if e < 0 else min(e, dim)
                n_el = max(0, -(-(s - e) // (-st)))
            out_shape[a] = n_el
            norm.append((a, s, e, st))
    out = ctx.add_act(n.outputs[0], tuple(out_shape), ctx.dtype_of(x),
                      ctx.scales.get(x, 1.0))
    ctx.emit("SLICE", [x], [out], attrs=dict(slices=tuple(norm)),
             name=n.name)


def _h_identity(ctx: _Ctx, n: OP.NodeProto) -> None:
    src = n.inputs[0]
    c = ctx.const_of(src)
    if c is not None:
        ctx.consts[n.outputs[0]] = c
        if ctx.resolve(src) in ctx.graph.tensors:
            ctx.alias[n.outputs[0]] = ctx.resolve(src)
        return
    ctx.alias[n.outputs[0]] = ctx.resolve(src)


def _h_constant(ctx: _Ctx, n: OP.NodeProto) -> None:
    a = n.attrs.get("value")
    if a is not None and a.t is not None and a.t.array is not None:
        ctx.consts[n.outputs[0]] = a.t.array
        return
    for k in ("value_float", "value_int"):
        av = n.attrs.get(k)
        if av is not None:
            v = av.f if av.f is not None else av.i
            ctx.consts[n.outputs[0]] = np.asarray(v)
            return


def _h_shape(ctx: _Ctx, n: OP.NodeProto) -> None:
    """Shape/Gather chains constant-fold against static shapes (the ops
    the reference compiler skips, main.rs op table)."""
    x = n.inputs[0]
    try:
        shape = ctx.shape_of(x)
    except KeyError:
        c = ctx.const_of(x)
        if c is None:
            return
        shape = c.shape
    # report the ONNX-visible (NCHW) shape for fold consistency
    if len(shape) == 4:
        nb, h, w, ch = shape
        shape = (nb, ch, h, w)
    ctx.consts[n.outputs[0]] = np.asarray(shape, np.int64)


def _h_gather(ctx: _Ctx, n: OP.NodeProto) -> None:
    data = ctx.const_of(n.inputs[0])
    idx = ctx.const_of(n.inputs[1])
    if data is not None and idx is not None:
        axis = n.attr_i("axis", 0)
        ctx.consts[n.outputs[0]] = np.take(data, idx.astype(np.int64),
                                           axis=axis)
        ctx.add_const(n.outputs[0], np.asarray(ctx.consts[n.outputs[0]]))
        return
    ctx.log(f"Gather {n.name}: non-const unsupported, skipping")


def _h_cast(ctx: _Ctx, n: OP.NodeProto) -> None:
    c = ctx.const_of(n.inputs[0])
    to = OP._NP_DTYPE.get(n.attr_i("to", OP.TP_FLOAT), np.float32)
    if c is not None:
        ctx.consts[n.outputs[0]] = c.astype(to)
        return
    ctx.alias[n.outputs[0]] = ctx.resolve(n.inputs[0])


def _h_qdq(ctx: _Ctx, n: OP.NodeProto) -> None:
    """QuantizeLinear / DequantizeLinear (QDQ-format models,
    ``mars-compiler/src/main.rs:137-217`` scale extraction).

    float32 mode: both fold to identity (DQ of const widens to f32).
    int8 mode: the Q output carries the scale; consts stay int8 with
    their scale recorded for conv import.
    """
    src = n.inputs[0]
    scale_c = ctx.const_of(n.inputs[1]) if len(n.inputs) > 1 else None
    scales = (np.asarray(scale_c).reshape(-1) if scale_c is not None
              else np.ones(1, np.float32))
    zp_c = ctx.const_of(n.inputs[2]) if len(n.inputs) > 2 and n.inputs[2] \
        else None
    zps = np.asarray(zp_c).reshape(-1) if zp_c is not None else np.zeros(1)
    per_axis = scales.size > 1 or zps.size > 1
    if per_axis and not ctx.float32:
        raise NotImplementedError(
            f"{n.op_type} {n.name or n.outputs[0]}: per-axis scale or zero "
            f"point ({scales.size} scales, {zps.size} zero points): the int8 "
            "import carries one scale a tensor")
    scale = float(scales[0])
    zp = int(zps[0])
    c = ctx.const_of(src)
    if n.op_type == "DequantizeLinear":
        if c is not None:
            if ctx.float32 and per_axis:
                # y = (x - zp) * scale along `axis` (ONNX DequantizeLinear)
                axis = n.attr_i("axis", 1)
                axis = axis + c.ndim if axis < 0 else axis
                bshape = [1] * c.ndim
                bshape[axis] = -1
                sc = np.asarray(scale_c, np.float32).reshape(bshape)
                z = (np.asarray(zp_c, np.float32).reshape(bshape)
                     if zp_c is not None else np.float32(0))
                ctx.consts[n.outputs[0]] = (c.astype(np.float32) - z) * sc
            elif ctx.float32:
                # asymmetric quant (uint8 zp=128 etc.): DQ is
                # (c - zp) * scale, not c * scale
                ctx.consts[n.outputs[0]] = \
                    (c.astype(np.float32) - np.float32(zp)) * scale
            else:
                if zp != 0:
                    # the integer engine is symmetric int8: shift the
                    # codes to zero-point 0 at import (uint8 zp=128 ->
                    # int8). Saturating shift only loses codes a
                    # symmetric engine cannot represent anyway.
                    ctx.log(f"DQ {n.name}: folding zero_point {zp} "
                            "into the stored int8 codes")
                    c = np.clip(c.astype(np.int32) - zp,
                                -128, 127).astype(np.int8)
                ctx.consts[n.outputs[0]] = c
                ctx.wscale[n.outputs[0]] = scale
            return
        r = ctx.resolve(src)
        ctx.alias[n.outputs[0]] = r
        if not ctx.float32:
            ctx.scales[r] = scale
            ctx.zero_points[r] = zp
            if r in ctx.graph.tensors:
                ctx.graph.tensors[r].quant = QuantInfo(scale=scale,
                                                       zero_point=zp)
        return
    # QuantizeLinear
    r = ctx.resolve(src)
    ctx.alias[n.outputs[0]] = r
    if not ctx.float32:
        ctx.scales[r] = scale
        ctx.zero_points[r] = zp
        if r in ctx.graph.tensors:
            ctx.graph.tensors[r].quant = QuantInfo(scale=scale,
                                                   zero_point=zp)
        ctx.pending_out_scale[r] = scale


def _h_gru(ctx: _Ctx, n: OP.NodeProto) -> None:
    """ONNX GRU -> IR GRU node (z,r,h gate order, linear_before_reset
    attr; executed by the engine step by step). X layout 0: [T, B, C]."""
    x = ctx.resolve(n.inputs[0])
    w = ctx.const_of(n.inputs[1])   # [D, 3H, C]
    r = ctx.const_of(n.inputs[2])   # [D, 3H, H]
    b = ctx.const_of(n.inputs[3]) if len(n.inputs) > 3 and n.inputs[3] \
        else None                   # [D, 6H]
    if w is None or r is None:
        ctx.log(f"GRU {n.name}: non-const weights unsupported")
        return
    hidden = n.attr_i("hidden_size", r.shape[-1])
    direction = n.attr_s("direction", "forward")
    ndir = 2 if direction == "bidirectional" else 1
    lbr = n.attr_i("linear_before_reset", 0)
    shape = ctx.shape_of(x)         # [T, B, C] (layout 0)
    t, bsz = shape[0], shape[1]
    wn = ctx.add_const(f"{n.outputs[0]}__w", w.astype(np.float32))
    rn = ctx.add_const(f"{n.outputs[0]}__r", r.astype(np.float32))
    ins = [x, wn, rn]
    if b is not None:
        ins.append(ctx.add_const(f"{n.outputs[0]}__b", b.astype(np.float32)))
    # ONNX input 5 = initial_h [D, B, H] (input 4, sequence_lens, is
    # unsupported/skipped); IR GRU takes it as the 5th input
    if len(n.inputs) > 5 and n.inputs[5]:
        if b is None:   # the IR convention needs the bias slot filled
            ins.append(ctx.add_const(
                f"{n.outputs[0]}__b",
                np.zeros((ndir, 6 * hidden), np.float32)))
        ins.append(ctx.resolve(n.inputs[5]))
    y = ctx.add_act(n.outputs[0], (t, ndir, bsz, hidden), np.float32)
    ctx.onnx4d.add(y)   # GRU Y is [T, dirs, B, H] ONNX order, not NHWC
    outs = [y]
    if len(n.outputs) > 1 and n.outputs[1]:
        yh = ctx.add_act(n.outputs[1], (ndir, bsz, hidden), np.float32)
        outs.append(yh)
    ctx.emit("GRU", ins, outs,
             attrs=dict(hidden_size=hidden, direction=direction,
                        linear_before_reset=lbr),
             name=n.name)


_HANDLERS = {
    "Conv": _h_conv,
    "ConvTranspose": _h_convtranspose,
    "Squeeze": _h_squeeze,
    "Unsqueeze": _h_squeeze,
    "GRU": _h_gru,
    "MaxPool": _h_pool,
    "AveragePool": _h_pool,
    "GlobalAveragePool": _h_gap,
    "Relu": _unary("RELU"),
    "LeakyRelu": _unary("LEAKY_RELU"),
    "Sigmoid": _unary("SIGMOID"),
    "Clip": _h_clip,
    "Add": _h_binary("ADD"),
    "Mul": _h_binary("MUL"),
    "Sub": _h_binary("SUB"),
    "Div": _h_binary("DIV"),
    "Pow": _h_binary("POW"),
    "Concat": _h_concat,
    "Resize": _h_resize,
    "Upsample": _h_resize,
    "Reshape": _h_reshape,
    "Transpose": _h_transpose,
    "Softmax": _h_softmax,
    "BatchNormalization": _h_bn,
    "Gemm": _h_gemm,
    "MatMul": _h_gemm,
    "Flatten": _h_flatten,
    "Split": _h_split,
    "Slice": _h_slice,
    "Identity": _h_identity,
    "Dropout": _h_identity,
    "Constant": _h_constant,
    "Shape": _h_shape,
    "Gather": _h_gather,
    "Cast": _h_cast,
    "QuantizeLinear": _h_qdq,
    "DequantizeLinear": _h_qdq,
    "Sigmoid_": _unary("SIGMOID"),
}
