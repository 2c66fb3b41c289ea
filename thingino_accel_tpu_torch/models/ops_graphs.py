"""Graphs that drive every op of the shared lowering, built in process.

``int8_ops_graph`` is an int8 network at a detector's feature width (the
real yolov5n's P3 is 80x80x64) whose nodes cover the ops and dtype
branches of ``runtime.executor.Executor.lower_node`` beside the serving
kernels: plain convs (a 1x1 -> 3x3 pair, the C3 bottleneck shape), a
grouped, a dilated and a stride-(2, 1) conv, BATCHNORM, CLIP, SPLIT,
SLICE, bilinear UPSAMPLE, SUB, DIV, POW, DEQUANT -> FAKE_QUANT -> QUANT,
TRANSPOSE, AVGPOOL, GLOBAL_AVGPOOL -> FC (per-tensor and per-channel
weight scales) and SOFTMAX. ``float_ops_graph`` is its float32 twin.
``recurrent_graph`` is the audio model's shape (``AECConfig``): CONV1D ->
CONV1D_TRANSPOSE -> GRU, forward with ``initial_h`` and bidirectional with
``linear_before_reset``.

Each graph function takes the module whose ``Graph``, ``Node``,
``TensorInfo`` and ``QuantInfo`` it builds with: the port's ``ir.graph``
by default, or any module with the same classes (the tests build the JAX
package's twin and hand it over through ``ir.graph.graph_from_jax``). Weights come from
``numpy.random.default_rng(seed)``. ``OPS`` maps each covered op to the
graph output that shows it. ``TIERS``, ``for_tier`` and ``check_outputs``
run a graph in each tier and hold one run against another (the card's
against the CPU's in ``chip_smoke.py`` and the ``gpu`` tests).
"""

from __future__ import annotations

from types import ModuleType
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from thingino_accel_tpu_torch.ir import graph as port_ir

# op -> the output of the int8 (and float) ops graph that shows it
OPS: Dict[str, str] = {
    "CONV2D": "p2", "CONV2D_GROUPED": "g", "CONV2D_DILATED": "d",
    "CONV2D_STRIDE_2_1": "s21", "BATCHNORM": "bn", "CLIP": "cl",
    "SPLIT": "sp1", "SLICE": "sl", "UPSAMPLE_BILINEAR": "up", "SUB": "sub",
    "DIV": "div", "POW": "pw", "DEQUANT": "dq", "FAKE_QUANT": "fq",
    "QUANT": "q", "TRANSPOSE": "tr", "AVGPOOL": "ap",
    "GLOBAL_AVGPOOL": "gap", "FC": "fc1", "FC_PER_CHANNEL": "fc2",
    "SOFTMAX": "sm",
}
# op -> the outputs of the recurrent graph that show it
RECURRENT_OPS: Dict[str, Tuple[str, ...]] = {
    "CONV1D": ("c1",), "CONV1D_TRANSPOSE": ("ct",),
    "GRU": ("y1", "h1"), "GRU_BIDIRECTIONAL": ("y2", "h2"),
}


# tier -> (EngineOptions keyword arguments, planned); the fast tier leaves
# its outputs in bf16, as the fast serving pipeline runs it
TIERS: Dict[str, Tuple[dict, bool]] = {
    "serving": (dict(precision="serving"), True),
    "unplanned": (dict(precision="serving"), False),
    "exact": (dict(precision="exact"), True),
    "compat": (dict(precision="exact", mode="compat"), True),
    "fast": (dict(precision="fast", quantize_outputs=False), True),
}
# (graph name, tier) -> the outputs the tier cannot run, as JAX's cannot:
# in compat mode GLOBAL_AVGPOOL and the shape ops pass through (the
# reference runtime's behaviour), so FC and GRU meet the wrong shape; the
# fast tier's dequantize_graph scales a per-channel FC weight [K, O] along
# K (ROADMAP.md C)
LEFT_OUT: Dict[Tuple[str, str], Tuple[str, ...]] = {
    ("int8_ops", "compat"): ("fc1", "fc2", "sm"),
    ("int8_ops", "fast"): ("fc2",),
    ("float_ops", "compat"): ("fc1", "fc2", "sm"),
    ("recurrent", "compat"): ("y1", "h1", "y2", "h2"),
}
# int8 outputs through a transcendental function (exp, pow), whose ulps
# differ between devices and libraries: 1 quantum apart on at most 0.1%
TRANSCENDENTAL = ("sm", "pw")
TRANSCENDENTAL_SHARE = 1e-3
# every output of the fast tier follows bf16 convs, whose last bit may
# differ between devices: an int8 one 1 quantum apart on at most 1%, a
# float one (bf16, or float32 computed from bf16) within BF16_TOL, four
# bf16 ulps of the largest |output| (a SUB adds two operands' 1-ulp
# differences; one ulp read up to 0.77 of 2^-7 on an H100)
FAST_INT8_SHARE = 1e-2
FLOAT_TOL, CONV_TOL = 1e-5, 1e-4
BF16_TOL = 2.0 ** -6
CONV_OUTPUTS = ("p2", "g", "d", "s21", "c1", "ct")


def for_tier(graph, tier: str):
    """``graph`` with the outputs ``tier`` runs (``LEFT_OUT``)."""
    left = LEFT_OUT.get((graph.name, tier), ())
    return graph.with_outputs([o for o in graph.outputs if o not in left])


def _numpy(v) -> Tuple[np.ndarray, bool]:
    """A tensor (any device) or array as numpy, bf16 as float32, and
    whether it was bf16."""
    if isinstance(v, torch.Tensor):
        bf16 = v.dtype == torch.bfloat16
        return (v.float() if bf16 else v).cpu().numpy(), bf16
    return np.asarray(v), False


def check_outputs(got: Dict, ref: Dict, tier: str) -> Dict[str, float]:
    """Hold one run's outputs (numpy, or tensors on any device) against
    another's, e.g. the card's against the CPU's: int8 bit for bit (but
    ``TRANSCENDENTAL``, and the fast tier's, as stated there); float32
    within ``FLOAT_TOL`` of the largest |output| (a conv's within
    ``CONV_TOL``); bf16, and any float output of the fast tier, within
    ``BF16_TOL``. Returns each output's largest difference over its bound
    (<= 1); raises AssertionError past it."""
    shares = {}
    for name in ref:
        g, _ = _numpy(got[name])
        r, bf16 = _numpy(ref[name])
        if g.shape != r.shape or g.dtype != r.dtype:
            raise AssertionError(f"{tier} {name}: {g.shape} {g.dtype} "
                                 f"against {r.shape} {r.dtype}")
        if r.dtype == np.int8:
            diff = np.abs(g.astype(np.int32) - r)
            share = (TRANSCENDENTAL_SHARE if name in TRANSCENDENTAL else
                     FAST_INT8_SHARE if tier == "fast" else 0.0)
            moved = float((diff > 0).mean())
            if diff.max(initial=0) > (1 if share else 0) or moved > share:
                raise AssertionError(
                    f"{tier} {name}: int8 {int(diff.max())} apart on "
                    f"{moved:.2e} of the values, bound {share}")
            shares[name] = moved / share if share else 0.0
            continue
        tol = (BF16_TOL if bf16 or tier == "fast" else
               CONV_TOL if name in CONV_OUTPUTS else FLOAT_TOL)
        bound = tol * float(np.abs(r).max(initial=0.0))
        err = float(np.abs(g.astype(np.float64) - r).max(initial=0.0))
        if err > bound:
            raise AssertionError(f"{tier} {name}: {err} > {bound}")
        shares[name] = err / bound if bound else 0.0
    return shares


class _Builder:
    def __init__(self, ir: ModuleType, seed: int):
        self.ir = ir
        self.rng = np.random.default_rng(seed)
        self.tensors: Dict = {}
        self.nodes: list = []

    def act(self, name: str, shape, dtype, scale: float = 1.0) -> str:
        self.tensors[name] = self.ir.TensorInfo(
            name=name, shape=tuple(int(v) for v in shape),
            dtype=np.dtype(dtype), quant=self.ir.QuantInfo(scale=scale))
        return name

    def const(self, name: str, data: np.ndarray, scale: float = 1.0,
              channel_scales: Optional[np.ndarray] = None) -> str:
        self.tensors[name] = self.ir.TensorInfo(
            name=name, shape=data.shape, dtype=data.dtype,
            quant=self.ir.QuantInfo(scale=scale), data=data,
            channel_scales=channel_scales)
        return name

    def node(self, op: str, ins, outs, **attrs) -> None:
        self.nodes.append(self.ir.Node(op=op, inputs=list(ins),
                                       outputs=list(outs), attrs=attrs,
                                       name=f"{op.lower()}_{outs[0]}"))

    def graph(self, name: str, inputs, outputs):
        g = self.ir.Graph(nodes=self.nodes, tensors=self.tensors,
                          inputs=list(inputs), outputs=list(outputs),
                          name=name)
        g.validate()
        return g


def _conv_attrs(k: int, stride=(1, 1), dilation=(1, 1), groups: int = 1,
                act: str = "NONE") -> dict:
    pad = (k - 1) // 2 * dilation[0]
    return dict(kernel=(k, k), stride=tuple(stride),
                dilation=tuple(dilation), padding="EXPLICIT",
                explicit_pad=(pad, pad, pad, pad), groups=groups,
                activation=act, alpha=0.01)


def _ops_graph(n: int, h: int, w: int, c: int, quantized: bool,
               ir: ModuleType, seed: int):
    """The int8 ops graph (``quantized``) or its float32 twin."""
    if c % 4 or h % 2 or w % 2:
        raise ValueError("c must be a multiple of 4, h and w even")
    b = _Builder(ir, seed)
    rng = b.rng
    act_t = np.int8 if quantized else np.float32
    half = c // 2

    def conv(name, src, cin, cout, out_hw, scale, groups=1, k=3, **kw):
        ci = cin // groups
        if quantized:
            wt = rng.integers(-127, 128, (cout, ci, k, k), dtype=np.int8)
            bias = rng.integers(-2000, 2000, cout).astype(np.int32)
        else:
            wt = rng.normal(0, 0.5 / np.sqrt(ci * k * k),
                            (cout, ci, k, k)).astype(np.float32)
            bias = rng.normal(0, 0.1, cout).astype(np.float32)
        wn = b.const(f"{name}_w", wt, scale=0.5 / 127 / np.sqrt(ci * k * k))
        bn_ = b.const(f"{name}_b", bias)
        out = b.act(name, (n,) + tuple(out_hw) + (cout,), act_t, scale)
        b.node("CONV2D", [src, wn, bn_], [out],
               **_conv_attrs(k, groups=groups, **kw))
        return out

    x = b.act("x", (n, h, w, c), act_t, 0.05)
    p1 = conv("p1", x, c, c, (h, w), 0.04, k=1, act="RELU")
    p2 = conv("p2", p1, c, c, (h, w), 0.05)
    conv("g", p2, c, c, (h, w), 0.05, groups=2, act="RELU")
    d = conv("d", p2, c, c, (h, w), 0.05, dilation=(2, 2))
    s21 = conv("s21", p2, c, c, (h // 2, w), 0.05, stride=(2, 1))

    # BATCHNORM (unfolded: p2 has other consumers) -> CLIP -> SPLIT
    bn = b.act("bn", (n, h, w, c), act_t, 0.05)
    b.node("BATCHNORM",
           [p2, b.const("bn_s", rng.uniform(0.5, 1.5, c).astype(np.float32)),
            b.const("bn_t", rng.normal(0, 0.3, c).astype(np.float32))],
           [bn])
    cl = b.act("cl", (n, h, w, c), act_t, 0.05)
    b.node("CLIP", [bn], [cl], min=0.0, max=6.0)
    sp0 = b.act("sp0", (n, h, w, half), act_t, 0.05)
    sp1 = b.act("sp1", (n, h, w, half), act_t, 0.05)
    b.node("SPLIT", [cl], [sp0, sp1], axis=3, sizes=(half, half))
    sl = b.act("sl", (n, h // 2, w // 2, half), act_t, 0.05)
    b.node("SLICE", [sp0], [sl], slices=((1, 0, h, 2), (2, 0, w, 2)))
    up = b.act("up", (n, h, w, half), act_t, 0.05)
    b.node("UPSAMPLE", [sl], [up], scale=(2, 2), mode=1)

    # arithmetic into int8 outputs (float in the twin)
    sub = b.act("sub", (n, h, w, half), act_t, 0.05)
    b.node("SUB", [up, sp1], [sub])
    divisor = b.const("div_by", rng.uniform(0.5, 2.0, (1, 1, 1, half))
                      .astype(np.float32))
    div = b.act("div", (n, h, w, half), act_t, 0.1)
    b.node("DIV", [sp1, divisor], [div])
    base = b.const("pow_base", rng.uniform(0.6, 1.5, (1, 1, 1, half))
                   .astype(np.float32))
    pw = b.act("pw", (n, h, w, half), act_t, 0.02)
    b.node("POW", [base, sp1], [pw])

    # DEQUANT -> FAKE_QUANT -> QUANT -> TRANSPOSE
    dq = b.act("dq", (n, h, w, c), np.float32)
    b.node("DEQUANT", [d], [dq], scale=0.05)
    fq = b.act("fq", (n, h, w, c), np.float32)
    b.node("FAKE_QUANT", [dq], [fq], scale=0.06)
    q = b.act("q", (n, h, w, c), np.int8, 0.06)
    b.node("QUANT", [fq], [q], scale=0.06)
    tr = b.act("tr", (n, c, h, w), np.int8, 0.06)
    b.node("TRANSPOSE", [q], [tr], perm=(0, 3, 1, 2))

    ap = b.act("ap", (n, h // 4, w // 2, c), act_t, 0.05)
    b.node("AVGPOOL", [s21], [ap], kernel=(3, 3), stride=(2, 2),
           padding="SAME", explicit_pad=(0, 0, 0, 0))

    # the classifier head: GLOBAL_AVGPOOL -> FC 64 -> 80, twice -> SOFTMAX
    gap = b.act("gap", (n, 1, 1, c), act_t, 0.02)
    b.node("GLOBAL_AVGPOOL", [p2], [gap])
    classes = 80
    for name, per_channel in (("fc1", False), ("fc2", True)):
        if quantized:
            wt = rng.integers(-127, 128, (c, classes), dtype=np.int8)
            bias = rng.integers(-500, 500, classes).astype(np.int32)
        else:
            wt = rng.normal(0, 1 / np.sqrt(c), (c, classes)).astype(np.float32)
            bias = rng.normal(0, 0.1, classes).astype(np.float32)
        cs = (rng.uniform(0.5, 1.5, classes).astype(np.float32) / 127 / 4
              if per_channel else None)
        wn = b.const(f"{name}_w", wt, scale=1 / 127 / 4, channel_scales=cs)
        out = b.act(name, (n, classes), act_t, 0.05)
        b.node("FC", [gap, wn, b.const(f"{name}_b", bias)], [out],
               activation="NONE")
    sm = b.act("sm", (n, classes), act_t, 1 / 128)
    b.node("SOFTMAX", ["fc1"], [sm], axis=-1)
    outs = [OPS[k] for k in OPS]
    return b.graph("int8_ops" if quantized else "float_ops", [x], outs)


def int8_ops_graph(n: int = 16, h: int = 80, w: int = 80, c: int = 64,
                   ir: ModuleType = port_ir, seed: int = 0):
    """The int8 ops graph over an int8 [n, h, w, c] input (per-tensor
    scales); its outputs are ``OPS``' values."""
    return _ops_graph(n, h, w, c, True, ir, seed)


def float_ops_graph(n: int = 16, h: int = 80, w: int = 80, c: int = 64,
                    ir: ModuleType = port_ir, seed: int = 0):
    """The float32 twin of :func:`int8_ops_graph` (QUANT and TRANSPOSE
    still int8)."""
    return _ops_graph(n, h, w, c, False, ir, seed)


def recurrent_graph(n: int = 16, c: int = 32, length: int = 256,
                    frames: int = 8, hidden: int = 32,
                    ir: ModuleType = port_ir, seed: int = 0):
    """float32 [n, c, length] -> CONV1D (k 3, pad 1) -> CONV1D_TRANSPOSE
    (k 4, stride 2, pads 1) -> [frames, n * 2 length / frames, c] -> GRU
    forward with ``initial_h``, and GRU bidirectional with
    ``linear_before_reset`` 1. The defaults are ``AECConfig``'s widths
    (256 bins, 8 frames, 32 channels, hidden 32) at batch 16."""
    if (2 * length) % frames:
        raise ValueError("2 * length must be a multiple of frames")
    b = _Builder(ir, seed)
    rng = b.rng
    f32 = np.float32
    rows = 2 * length // frames
    bsz = n * rows

    def rand(*shape, s=1.0):
        return rng.normal(0, s, shape).astype(f32)

    x = b.act("x", (n, c, length), f32)
    c1 = b.act("c1", (n, c, length), f32)
    b.node("CONV1D", [x, b.const("c1_w", rand(c, c, 3, s=1 / np.sqrt(3 * c))),
                      b.const("c1_b", rand(c, s=0.1))], [c1],
           kernel=3, stride=1, dilation=1, pads=(1, 1), groups=1)
    ct = b.act("ct", (n, c, 2 * length), f32)
    b.node("CONV1D_TRANSPOSE",
           [c1, b.const("ct_w", rand(c, c, 4, s=1 / np.sqrt(2 * c))),
            b.const("ct_b", rand(c, s=0.1))], [ct],
           kernel=4, stride=2, pads=(1, 1), out_len=2 * length)
    r4 = b.act("r4", (n, c, rows, frames), f32)
    b.node("RESHAPE", [ct], [r4], new_shape=(n, c, rows, frames))
    tp = b.act("tp", (frames, n, rows, c), f32)
    b.node("TRANSPOSE", [r4], [tp], perm=(3, 0, 2, 1))
    seq = b.act("seq", (frames, bsz, c), f32)
    b.node("RESHAPE", [tp], [seq], new_shape=(frames, bsz, c))
    for name, dirs, lbr, h0 in (("1", 1, 0, True), ("2", 2, 1, False)):
        ins = [seq, b.const(f"w{name}", rand(dirs, 3 * hidden, c,
                                             s=1 / np.sqrt(c))),
               b.const(f"r{name}", rand(dirs, 3 * hidden, hidden,
                                        s=1 / np.sqrt(hidden))),
               b.const(f"b{name}", rand(dirs, 6 * hidden, s=0.1))]
        if h0:
            ins.append(b.const(f"h0{name}", rand(dirs, bsz, hidden, s=0.5)))
        y = b.act(f"y{name}", (frames, dirs, bsz, hidden), f32)
        yh = b.act(f"h{name}", (dirs, bsz, hidden), f32)
        b.node("GRU", ins, [y, yh], hidden_size=hidden,
               direction="forward" if dirs == 1 else "bidirectional",
               linear_before_reset=lbr)
    outs = [o for k in RECURRENT_OPS for o in RECURRENT_OPS[k]]
    return b.graph("recurrent", [x], outs)
