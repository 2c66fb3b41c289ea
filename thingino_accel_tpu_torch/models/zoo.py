"""Model zoo: the YOLOv5 family and the NanoDet-class detector built
programmatically as IR graphs.

Port of ``thingino_accel_tpu.models.zoo`` (``GraphBuilder``,
``_bottleneck``, ``_c3``, ``_sppf``, ``build_yolov5``, ``_dw_separable``,
``build_nanodet``, ``build_tiny``), which is free of JAX itself but cannot be imported
without it (its package imports ``models.yolo``, which imports jax). The
code and its seeded numpy draws are the JAX package's, so one config
gives the same graph, tensor for tensor, in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from thingino_accel_tpu_torch.ir.graph import Graph, Node, QuantInfo, TensorInfo


@dataclasses.dataclass
class ZooConfig:
    dtype: str = "int8"          # "int8" | "float32"
    num_classes: int = 80
    in_hw: Tuple[int, int] = (640, 640)
    act_scale: float = 0.05      # uniform activation quant scale (int8)
    w_scale: float = 0.01        # uniform weight quant scale (int8)
    seed: int = 0


class GraphBuilder:
    """Small helper to assemble IR graphs programmatically."""

    def __init__(self, name: str, cfg: ZooConfig):
        self.cfg = cfg
        self.graph = Graph(nodes=[], tensors={}, inputs=[], outputs=[],
                           name=name)
        self.rng = np.random.default_rng(cfg.seed)
        self._n = 0
        self.np_dtype = (np.dtype(np.int8) if cfg.dtype == "int8"
                         else np.dtype(np.float32))

    def _name(self, base: str) -> str:
        self._n += 1
        return f"{base}_{self._n}"

    def _quant(self) -> QuantInfo:
        if self.cfg.dtype == "int8":
            return QuantInfo(scale=self.cfg.act_scale)
        return QuantInfo()

    def input(self, name: str, shape: Tuple[int, ...]) -> str:
        self.graph.tensors[name] = TensorInfo(
            name=name, shape=shape, dtype=self.np_dtype, quant=self._quant())
        self.graph.inputs.append(name)
        return name

    def _weight(self, shape: Tuple[int, ...]) -> str:
        nm = self._name("w")
        if self.cfg.dtype == "int8":
            data = self.rng.integers(-127, 128, shape).astype(np.int8)
            q = QuantInfo(scale=self.cfg.w_scale)
        else:
            fan_in = int(np.prod(shape[1:])) or 1
            data = (self.rng.normal(0, 1, shape) / np.sqrt(fan_in)).astype(
                np.float32)
            q = QuantInfo()
        self.graph.tensors[nm] = TensorInfo(
            name=nm, shape=shape, dtype=data.dtype, quant=q, data=data)
        return nm

    def _bias(self, c: int) -> str:
        nm = self._name("b")
        if self.cfg.dtype == "int8":
            data = self.rng.integers(-256, 256, (c,)).astype(np.int32)
        else:
            data = np.zeros((c,), np.float32)
        self.graph.tensors[nm] = TensorInfo(
            name=nm, shape=(c,), dtype=data.dtype, data=data)
        return nm

    def _act_tensor(self, shape: Tuple[int, ...]) -> str:
        nm = self._name("t")
        self.graph.tensors[nm] = TensorInfo(
            name=nm, shape=shape, dtype=self.np_dtype, quant=self._quant())
        return nm

    def conv(self, x: str, c_out: int, k: int = 1, s: int = 1,
             act: str = "SILU", bias: bool = True, valid: bool = False,
             groups: int = 1) -> str:
        xt = self.graph.tensors[x]
        n, h, w, c_in = xt.shape
        if valid:
            pad = 0
            oh, ow = (h - k) // s + 1, (w - k) // s + 1
        else:
            pad = (k - 1) // 2
            oh, ow = (h + s - 1) // s, (w + s - 1) // s
        wname = self._weight((c_out, c_in // groups, k, k))
        ins = [x, wname] + ([self._bias(c_out)] if bias else [])
        out = self._act_tensor((n, oh, ow, c_out))
        op = "DEPTHWISE_CONV2D" if groups == c_in and groups > 1 else "CONV2D"
        self.graph.nodes.append(Node(
            op=op, inputs=ins, outputs=[out],
            attrs=dict(kernel=(k, k), stride=(s, s), dilation=(1, 1),
                       padding="EXPLICIT",
                       explicit_pad=(pad, pad, pad, pad),
                       groups=groups, activation=act),
            name=self._name("conv")))
        return out

    def maxpool(self, x: str, k: int, s: int = 1) -> str:
        xt = self.graph.tensors[x]
        n, h, w, c = xt.shape
        pad = (k - 1) // 2
        oh = (h + 2 * pad - k) // s + 1
        ow = (w + 2 * pad - k) // s + 1
        out = self._act_tensor((n, oh, ow, c))
        self.graph.nodes.append(Node(
            op="MAXPOOL", inputs=[x], outputs=[out],
            attrs=dict(kernel=(k, k), stride=(s, s), padding="EXPLICIT",
                       explicit_pad=(pad, pad, pad, pad)),
            name=self._name("pool")))
        return out

    def concat(self, xs: Sequence[str]) -> str:
        shapes = [self.graph.tensors[x].shape for x in xs]
        c = sum(s[3] for s in shapes)
        out = self._act_tensor((shapes[0][0], shapes[0][1], shapes[0][2], c))
        self.graph.nodes.append(Node(
            op="CONCAT", inputs=list(xs), outputs=[out],
            attrs=dict(axis=3), name=self._name("cat")))
        return out

    def add(self, a: str, b: str) -> str:
        out = self._act_tensor(self.graph.tensors[a].shape)
        self.graph.nodes.append(Node(
            op="ADD", inputs=[a, b], outputs=[out], attrs={},
            name=self._name("add")))
        return out

    def upsample(self, x: str, factor: int = 2) -> str:
        xt = self.graph.tensors[x]
        n, h, w, c = xt.shape
        out = self._act_tensor((n, h * factor, w * factor, c))
        self.graph.nodes.append(Node(
            op="UPSAMPLE", inputs=[x], outputs=[out],
            attrs=dict(scale=(factor, factor), mode=0),
            name=self._name("up")))
        return out

    def finish(self, outputs: Sequence[str]) -> Graph:
        self.graph.outputs = list(outputs)
        self.graph.validate()
        return self.graph


# ---------------------------------------------------------------------------
# YOLOv5
# ---------------------------------------------------------------------------

_YOLO_SIZES = {
    # depth_multiple, width_multiple (ultralytics yolov5 configs)
    "n": (0.33, 0.25),
    "s": (0.33, 0.50),
    "m": (0.67, 0.75),
}


def _mdepth(n: int, dm: float) -> int:
    return max(1, round(n * dm))


def _mwidth(c: int, wm: float) -> int:
    return int(np.ceil(c * wm / 8) * 8)


def _bottleneck(b: GraphBuilder, x: str, c: int, shortcut: bool) -> str:
    y = b.conv(x, c, 1)
    y = b.conv(y, c, 3)
    if shortcut:
        return b.add(x, y)
    return y


def _c3(b: GraphBuilder, x: str, c_out: int, n: int,
        shortcut: bool = True) -> str:
    c_ = c_out // 2
    y1 = b.conv(x, c_, 1)
    for _ in range(n):
        y1 = _bottleneck(b, y1, c_, shortcut)
    y2 = b.conv(x, c_, 1)
    return b.conv(b.concat([y1, y2]), c_out, 1)


def _sppf(b: GraphBuilder, x: str, c_out: int) -> str:
    c_ = c_out // 2
    y = b.conv(x, c_, 1)
    p1 = b.maxpool(y, 5, 1)
    p2 = b.maxpool(p1, 5, 1)
    p3 = b.maxpool(p2, 5, 1)
    return b.conv(b.concat([y, p1, p2, p3]), c_out, 1)


def build_yolov5(
    size: str = "s",
    cfg: Optional[ZooConfig] = None,
    batch: int = 1,
) -> Graph:
    """YOLOv5-{n,s,m} as an IR graph with raw detect heads.

    Outputs three NHWC feature maps [B, H/8, W/8, 3*(5+nc)], /16, /32 —
    decode + NMS live in ``models.yolo``. Architecture matches the
    ultralytics v5 graphs the bundled `.mars` files were compiled from
    (first conv 6x6/2, CSP C3 blocks,
    SPPF, PAN neck; cf. the layer histogram of ``models/yolov5n.mars``:
    60 convs, silu pairs, 3 maxpools, 2 upsamples, 17 concats).
    """
    cfg = cfg or ZooConfig()
    dm, wm = _YOLO_SIZES[size]
    b = GraphBuilder(f"yolov5{size}_{cfg.dtype}", cfg)
    h, w = cfg.in_hw
    no = 3 * (5 + cfg.num_classes)

    x = b.input("images", (batch, h, w, 3))
    c1, c2, c3c, c4, c5 = (_mwidth(64, wm), _mwidth(128, wm),
                           _mwidth(256, wm), _mwidth(512, wm),
                           _mwidth(1024, wm))
    # backbone
    p1 = b.conv(x, c1, 6, 2)                       # /2
    p2 = b.conv(p1, c2, 3, 2)                      # /4
    p2 = _c3(b, p2, c2, _mdepth(3, dm))
    p3 = b.conv(p2, c3c, 3, 2)                     # /8
    p3 = _c3(b, p3, c3c, _mdepth(6, dm))
    p4 = b.conv(p3, c4, 3, 2)                      # /16
    p4 = _c3(b, p4, c4, _mdepth(9, dm))
    p5 = b.conv(p4, c5, 3, 2)                      # /32
    p5 = _c3(b, p5, c5, _mdepth(3, dm))
    p5 = _sppf(b, p5, c5)
    # neck (PAN)
    n5 = b.conv(p5, c4, 1)
    u5 = b.upsample(n5)
    n4 = _c3(b, b.concat([u5, p4]), c4, _mdepth(3, dm), shortcut=False)
    n4s = b.conv(n4, c3c, 1)
    u4 = b.upsample(n4s)
    n3 = _c3(b, b.concat([u4, p3]), c3c, _mdepth(3, dm), shortcut=False)
    d3 = b.conv(n3, c3c, 3, 2)
    n4o = _c3(b, b.concat([d3, n4s]), c4, _mdepth(3, dm), shortcut=False)
    d4 = b.conv(n4o, c4, 3, 2)
    n5o = _c3(b, b.concat([d4, n5]), c5, _mdepth(3, dm), shortcut=False)
    # detect heads (1x1, linear)
    h3 = b.conv(n3, no, 1, act="NONE")
    h4 = b.conv(n4o, no, 1, act="NONE")
    h5 = b.conv(n5o, no, 1, act="NONE")
    return b.finish([h3, h4, h5])


# ---------------------------------------------------------------------------
# NanoDet
# ---------------------------------------------------------------------------


def _dw_separable(b: GraphBuilder, x: str, c_out: int, s: int = 1,
                  k: int = 3) -> str:
    """Depthwise-separable block (ShuffleNet/NanoDet style): depthwise
    KxK + pointwise 1x1."""
    c_in = b.graph.tensors[x].shape[3]
    y = b.conv(x, c_in, k, s, act="LEAKY_RELU", groups=c_in)
    return b.conv(y, c_out, 1, act="LEAKY_RELU")


def build_nanodet(
    cfg: Optional[ZooConfig] = None,
    batch: int = 1,
    num_classes: Optional[int] = None,
) -> Graph:
    """NanoDet-class depthwise detector, the structure of
    ``models/nanodet_320.mars``: a depthwise backbone (stride 4/8/16/32),
    a PAN with depthwise blocks, per-level linear heads emitting
    [B, H, W, num_classes + 4]."""
    cfg = cfg or ZooConfig(in_hw=(320, 320))
    if num_classes is None:
        num_classes = cfg.num_classes
    b = GraphBuilder(f"nanodet_{cfg.dtype}", cfg)
    h, w = cfg.in_hw
    x = b.input("images", (batch, h, w, 3))
    y = b.conv(x, 24, 3, 2, act="LEAKY_RELU")      # /2
    y = _dw_separable(b, y, 48, s=2)               # /4
    c3 = _dw_separable(b, y, 96, s=2)              # /8
    c3 = _dw_separable(b, c3, 96)
    c4 = _dw_separable(b, c3, 192, s=2)            # /16
    c4 = _dw_separable(b, c4, 192)
    c5 = _dw_separable(b, c4, 384, s=2)            # /32
    c5 = _dw_separable(b, c5, 384)
    # PAN-lite
    p5 = b.conv(c5, 96, 1, act="LEAKY_RELU")
    p4 = b.conv(c4, 96, 1, act="LEAKY_RELU")
    p3 = b.conv(c3, 96, 1, act="LEAKY_RELU")
    u5 = b.upsample(p5)
    p4 = b.add(p4, u5)
    u4 = b.upsample(p4)
    p3 = b.add(p3, u4)
    no = num_classes + 4
    h3 = b.conv(_dw_separable(b, p3, 96), no, 1, act="NONE")
    h4 = b.conv(_dw_separable(b, p4, 96), no, 1, act="NONE")
    h5 = b.conv(_dw_separable(b, p5, 96), no, 1, act="NONE")
    return b.finish([h3, h4, h5])


def build_tiny(
    cfg: Optional[ZooConfig] = None, batch: int = 1,
    in_hw: Tuple[int, int] = (160, 160),
) -> Graph:
    """The ``tiny_160`` three-conv stack (``models/tiny_160_*.mars``):
    conv3x3(3->16) relu, conv3x3(16->32) relu, conv3x3(32->64), VALID."""
    cfg = cfg or ZooConfig(in_hw=in_hw)
    b = GraphBuilder(f"tiny_{cfg.dtype}", cfg)
    h, w = in_hw
    x = b.input("input", (batch, h, w, 3))
    y = b.conv(x, 16, 3, act="RELU", valid=True)
    y = b.conv(y, 32, 3, act="RELU", valid=True)
    y = b.conv(y, 64, 3, act="NONE", valid=True)
    return b.finish([y])
