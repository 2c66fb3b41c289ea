"""IR executor: runs the graph on torch tensors, in one of four lowerings.

Every tier lowers a node that no kernel unit takes through one function,
:meth:`Executor.lower_node`, the port of JAX's ``_lower_node``
(``thingino_accel_tpu/runtime/executor.py:1005-1370``) branch for branch:
float, grouped and depthwise convs, pools, activations, QDQ, shape ops,
arithmetic, CLIP, BATCHNORM, FC, bilinear UPSAMPLE, GRU, CONV1D and
CONV1D_TRANSPOSE, with the degenerate guard first. The tiers differ only
in where an int8 conv runs (:meth:`Executor.conv_steps`) and in their
options (``compat``, ``round_mode``, ``compute_dtype``, ``accum_dtype``).

**Planned** (what ``Engine(g, EngineOptions(precision="serving"))`` runs):
port of ``thingino_accel_tpu.runtime.executor``'s serving tier with its
planners (``runtime.planner``) and its fold-aware lowering
(``_lower_node_folded``). The plan fuses a residual ADD into the conv
before it, runs a CONCAT consumed only by 1x1 convs as a multi-part
matmul that never materializes it, runs the SPPF pools with their 1x1
conv, and runs a C3 bottleneck's 1x1 -> KxK pair as one kernel. A
stride-1 depthwise conv runs in its own kernel; other depthwise convs take
the plain op, as the JAX serving tier computes them in XLA.

The JAX lowering keeps its tensors in fold layouts and takes run-time
fallbacks that read them: a deferred bottleneck half checks the residual's
padded lane count, a virtual concat whose parts arrive in another layout
is materialized, a residual in another layout is not fused. The port
keeps every tensor in logical NHWC, but replays that bookkeeping (fold
per tensor, physical lane count, bf16 stage tensors) once, when the
executor is built, so it takes the decision the JAX package takes. The
result is a fixed schedule of steps: kernel units (:class:`ConvUnit`,
:class:`MultiUnit`, :class:`BneckUnit`, :class:`SppfUnit`,
:class:`DwUnit`, and :class:`ExactConvUnit` for a dilated or
non-square-stride conv) and plain torch steps.

**Unplanned** (``planned=False``): the per-node lowering: every int8
CONV2D at dilation 1 and a square stride through the fused dispatcher
(``ops.fused_kernels.conv2d_int8_fused``) with its activation in the
kernel's epilogue, any other through the exact tier's route, a stride-1
depthwise conv through its kernel (but SILU, which JAX applies on the
requantized value) and any other through the plain op. It matches the JAX
serving engine built with ``_plan_folds`` returning None, and stays as
that oracle.

**Exact** (:class:`ExactExecutor`, what ``Engine(precision="exact")``
runs): ``_lower_node`` with its ``full`` and ``compat`` modes. Every int8
conv with a per-tensor weight scale runs in the exact tier's kernels
(``ops.conv``: #9, #10 or #11, RELU after the clamp), a per-channel one in
the plain op, as the JAX executor sends it to XLA. Any other activation of
a conv (``_apply_fused_act``) is a function of the int8 output alone, so
it runs as a 256-entry table built from it once (:func:`act_table`): in
the kernel's epilogue, or for a plain conv as a gather step after it.

**Fast** (:class:`FastExecutor`): the same lowering over a dequantized
graph, its float convs in ``compute_dtype``.

The JAX package's ``TAT_*`` modes are resolved once, when an executor is
built (JAX resolves them at trace time), and no forward reads the
environment: ``TAT_FAST_SILU`` gives a conv's SILU to the serving kernels
as SILU_FAST (:func:`kernel_act`; the stem stage keeps the exp SiLU, as
JAX's XLA stem), ``TAT_SERVING_COMPUTE`` the serving kernels' product
(int8 or bf16; the KxK convs of the unplanned dispatcher and the stem
stage stay int8, as JAX's have no such argument), ``TAT_SILU_TANH`` the
float SiLU (:func:`ops.reference.silu`). No mode changes a route.

Every entry point puts its tensors on ``device``, ``"cuda"`` by default;
without a CUDA device it raises (``device="cpu"`` runs the plain versions
on the CPU). Nothing falls back to the CPU.
"""

from __future__ import annotations

import collections
import copy
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from thingino_accel_tpu_torch.ir.graph import (
    Graph, Node, TensorInfo, concat_axis_of,
)
from thingino_accel_tpu_torch.ir.passes import fuse_silu_pairs
from thingino_accel_tpu_torch.ops import conv as C
from thingino_accel_tpu_torch.ops import fused_kernels as FK
from thingino_accel_tpu_torch.ops import reference as R
from thingino_accel_tpu_torch.ops import requant_kernels as RK
from thingino_accel_tpu_torch.ops.quant import RoundMode, clamp_i8, round_to_int
from thingino_accel_tpu_torch.runtime import planner as P
from thingino_accel_tpu_torch.runtime.planner import is_int8 as _is_int8
from thingino_accel_tpu_torch.runtime.planner import pool_pads as _pool_pads
from thingino_accel_tpu_torch.utils import config

# the ops of JAX's ``_lower_node``, which every tier lowers; any other op
# raises, as it does there
LOWERED_OPS = frozenset((
    "CONV2D", "DEPTHWISE_CONV2D", "MAXPOOL", "AVGPOOL", "GLOBAL_AVGPOOL",
    "RELU", "RELU6", "LEAKY_RELU", "SIGMOID", "SILU", "SILU_FUSED",
    "SOFTMAX", "CONCAT", "ADD", "MUL", "UPSAMPLE", "TRANSPOSE", "RESHAPE",
    "DEQUANT", "QUANT", "FAKE_QUANT", "SPLIT", "SLICE", "SUB", "DIV", "POW",
    "GRU", "CONV1D", "CONV1D_TRANSPOSE", "CLIP", "BATCHNORM", "FC"))
# ops whose lowering reads a weight (and a GRU its recurrence) input
_WEIGHTED = {"CONV2D": 2, "DEPTHWISE_CONV2D": 2, "FC": 2, "CONV1D": 2,
             "CONV1D_TRANSPOSE": 2, "GRU": 3}

# kernel unit kind -> the launch counter of its wrapper
KERNEL_OF_KIND = {
    "matmul": "matmul_int8_fused",
    "conv": "conv2d_int8_halo_fused",
    "multi": "matmul_int8_fused_multi",
    "bneck": "bottleneck_int8_fused",
    "sppf": "sppf_int8_fused",
    "dw": "depthwise_conv2d_int8_fused",
}
# the exact tier's conv units are named by their kernel's launch counter
KERNEL_OF_KIND.update({k: k for k in RK.launches})


def _nhwc_out_hw(t: TensorInfo) -> Tuple[int, int]:
    return t.shape[1], t.shape[2]


def resolve_device(device: torch.device | str) -> torch.device:
    """``device`` as a torch device. A CUDA device must exist: there is no
    fallback to the CPU, which runs only when asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested (the default) but torch finds "
            "no CUDA device; pass device='cpu' to run on the CPU")
    return dev


def _torch_dtype(dt: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dt)).dtype


def _ceil128(n: int) -> int:
    return -(-n // 128) * 128


def is_depthwise(node: Node, tensors) -> bool:
    """A DEPTHWISE_CONV2D, or a CONV2D with one group per input channel
    (the JAX executor's test, executor.py:657-658)."""
    if node.op not in ("CONV2D", "DEPTHWISE_CONV2D") or len(node.inputs) < 2:
        return False
    in_shape = tensors[node.inputs[0]].shape
    groups = node.attrs.get("groups", 1)
    cin = in_shape[3] if len(in_shape) == 4 else 0
    return node.op == "DEPTHWISE_CONV2D" or (groups > 1 and groups == cin)


def conv_weight_names(graph: Graph) -> set:
    """The weights a CONV2D reads as HWIO in the JAX layout (every conv's
    but a depthwise one's, which is [KH, KW, C]), as JAX's
    ``prepare_params`` picks them."""
    return {n.inputs[1] for n in graph.nodes
            if n.op in ("CONV2D", "DEPTHWISE_CONV2D") and len(n.inputs) >= 2
            and not is_depthwise(n, graph.tensors)}


def prepare_params(graph: Graph) -> Dict[str, np.ndarray]:
    """The graph's constants as numpy arrays, conv weights OIHW -> HWIO
    and depthwise weights OIHW [C, 1, KH, KW] -> [KH, KW, C]; every other
    constant (FC, GRU, CONV1D, BATCHNORM, an operand) as it is: the same
    dict as the JAX ``prepare_params`` (``Engine._np_params``)."""
    conv_weights = conv_weight_names(graph)
    dw_weights = {n.inputs[1] for n in graph.nodes
                  if is_depthwise(n, graph.tensors)}
    params: Dict[str, np.ndarray] = {}
    for name, t in graph.tensors.items():
        if not t.is_const:
            continue
        data = t.data
        if name in conv_weights:
            data = np.ascontiguousarray(np.transpose(data, (2, 3, 1, 0)))
        elif name in dw_weights:
            o, i, kh, kw = data.shape
            data = np.ascontiguousarray(
                data.reshape(o * i, kh, kw).transpose(1, 2, 0))
        params[name] = data
    return params


def params_from_jax(np_params: Dict[str, np.ndarray],
                    device: torch.device | str = "cuda",
                    conv_weights: Iterable[str] = ()
                    ) -> Dict[str, torch.Tensor]:
    """The JAX engine's numpy params (``Engine._np_params``: HWIO conv
    weights, [KH, KW, C] depthwise weights, the rest as in the graph) as
    the port's tensors on ``device``. The conv weights named in
    ``conv_weights`` (:func:`conv_weight_names` of the graph: the role,
    not the shape, decides, since an FC weight or an ADD operand may be
    4-D int8 too) are repacked HWIO -> OHWI, the kernels' layout: each
    output channel's (ky, kx, c) run is contiguous, matching the NHWC
    input. Everything else keeps its layout."""
    device = resolve_device(device)
    conv_weights = set(conv_weights)
    out: Dict[str, torch.Tensor] = {}
    for name, arr in np_params.items():
        arr = np.asarray(arr)
        if name in conv_weights:
            arr = np.transpose(arr, (3, 0, 1, 2))
        out[name] = torch.from_numpy(np.array(arr, order="C")).to(device)
    return out


def params_to_jax(params: Dict[str, torch.Tensor],
                  conv_weights: Iterable[str] = ()
                  ) -> Dict[str, np.ndarray]:
    """The inverse of :func:`params_from_jax`: the port's params as numpy
    arrays on the CPU in the JAX engine's layout, the conv weights named
    in ``conv_weights`` (the role, as there) OHWI -> HWIO, everything else
    as it is (depthwise [KH, KW, C], FC, GRU, CONV1D, biases)."""
    conv_weights = set(conv_weights)
    out: Dict[str, np.ndarray] = {}
    for name, t in params.items():
        arr = t.detach().cpu().numpy()
        if name in conv_weights:
            arr = np.ascontiguousarray(np.transpose(arr, (1, 2, 3, 0)))
        out[name] = arr
    return out


def graph_with_params(graph: Graph, np_params: Dict[str, np.ndarray]
                      ) -> Graph:
    """A copy of ``graph`` whose constants are ``np_params`` (the JAX
    engine's layout, as :func:`prepare_params` gives and
    :func:`params_to_jax` returns): the inverse of :func:`prepare_params`,
    conv weights HWIO -> OIHW, depthwise weights [KH, KW, C] -> the
    graph's OIHW ([C, 1, KH, KW]), the rest as it is; each in its
    tensor's dtype. A name the graph holds no constant of, or a
    zero-sized constant, is left alone. This carries trained weights back
    into a graph (``training.qat``; JAX's ``examples/qat_yolov5n.py``
    does it by hand)."""
    g = copy.deepcopy(graph)
    conv_weights = conv_weight_names(g)
    dw_weights = {n.inputs[1] for n in g.nodes if is_depthwise(n, g.tensors)}
    for name, arr in np_params.items():
        t = g.tensors.get(name)
        if t is None or not t.is_const or not t.data.size:
            continue
        a = np.asarray(arr)
        if name in conv_weights:
            a = np.transpose(a, (3, 2, 0, 1))
        elif name in dw_weights:
            a = np.transpose(a, (2, 0, 1)).reshape(t.data.shape)
        if a.shape != t.data.shape:
            raise ValueError(f"{name}: params of shape {a.shape} for a "
                             f"constant of shape {t.data.shape}")
        t.data = np.ascontiguousarray(a.astype(t.data.dtype))
    return g


def apply_fused_act(out: torch.Tensor, act: str, scale: float,
                    compat: bool = False, alpha: float = 0.01,
                    silu_tanh: Optional[bool] = None) -> torch.Tensor:
    """Port of ``_apply_fused_act``: a conv's activation beyond RELU (which
    the conv applied), ``scale`` being the output's scale: on an int8
    output requantized, on a float one in its type (LEAKY_RELU promotes
    bf16 to float32, as in JAX; SILU in :func:`ops.reference.silu`'s
    ``tanh`` form where ``silu_tanh``). ``compat`` applies none, as the
    reference runtime. Unknown activations pass through, as in JAX."""
    if act in ("NONE", "RELU") or compat:
        return out
    if out.dtype.is_floating_point:
        if act == "RELU6":
            return R.relu6(out)
        if act == "LEAKY_RELU":
            return R.leaky_relu(out, alpha or 0.01)
        if act == "SILU":
            return R.silu(out, tanh=silu_tanh)
        if act == "SIGMOID":
            return torch.sigmoid(out)
        if act == "TANH":
            return torch.tanh(out)
        if act == "HARD_SWISH":
            return out * torch.clamp(out + 3.0, 0.0, 6.0) / 6.0
        return out
    if act == "RELU6":
        return R.relu6(out, scale, compat=False)
    if act == "LEAKY_RELU":
        return R.leaky_relu(out, alpha or 0.01)
    if act == "SILU":
        return R.silu(out, scale, out_scale=scale)
    if act == "SIGMOID":
        return R.sigmoid(out, scale, scale)
    if act in ("TANH", "HARD_SWISH"):
        xf = out.to(torch.float32) * float(np.float32(scale))
        y = (torch.tanh(xf) if act == "TANH" else
             R._fdiv(xf * torch.clamp(xf + 3.0, 0.0, 6.0), 6.0))
        return clamp_i8(round_to_int(R._fdiv(y, scale),
                                     RoundMode.PLUS_HALF_TRUNC))
    return out


def kernel_act(act: str, fast_silu: bool = False) -> str:
    """The activation a serving kernel's epilogue applies for a conv's
    ``act`` (JAX's ``_kernel_act``): SILU_FAST for SILU where
    ``fast_silu`` (``TAT_FAST_SILU``, resolved by the executor), else
    itself where the epilogue has it, else NONE, the act then following
    the kernel."""
    if act == "SILU" and fast_silu:
        return "SILU_FAST"
    return act if act in FK.ACTS else "NONE"


def act_applied(applied: str, act: str) -> bool:
    """Did a kernel's epilogue (act ``applied``) apply the node's ``act``?
    (JAX's ``_act_applied``: SILU_FAST is the serving tier's SILU.)"""
    return applied == act or (applied == "SILU_FAST" and act == "SILU")


def clip_q(x: torch.Tensor, lo, hi, in_scale: float) -> torch.Tensor:
    """CLIP with ONNX's real bounds (port of ``_clip_q``): an integer
    tensor clamps the quantized bounds, ``trunc(v / scale +- 0.5)``
    clipped to int8 (the RELU6 rule); a float one the bounds in its
    type."""
    if not x.dtype.is_floating_point:
        sc = np.float32(in_scale or 1.0)

        def q(v):
            t = np.float32(v) / sc
            t = np.trunc(t + (0.5 if t >= 0 else -0.5))
            return int(np.clip(t, -128, 127))

        lo = q(lo) if lo is not None else None
        hi = q(hi) if hi is not None else None
    if lo is None and hi is None:
        return x
    # the bounds as scalars of the kernel, in x's type: no host tensor
    return torch.clamp(x, min=lo, max=hi)


def fake_quant(x: torch.Tensor, scale) -> torch.Tensor:
    """Symmetric int8 fake quantization with a straight-through estimator:
    forward the int8 round trip ``clip(round(x / s), -128, 127) * s``
    (round half to even, as ``jnp.round``; a true float32 division),
    backward the identity, in the form ``x + (q - x).detach()``, computed
    in float32 and returned in ``x``'s type. ``scale``: a float (the
    FAKE_QUANT node's, 0 read as 1, as JAX's executor) or a float32
    tensor that broadcasts against ``x`` (per-channel weight scales,
    ``training.qat.weight_scale``; JAX's ``qat.fake_quant``)."""
    xf = x.to(torch.float32)
    if isinstance(scale, torch.Tensor):
        q = torch.clamp(torch.round(xf / scale), -128, 127) * scale
    else:
        s = np.float32(scale or 1.0)
        q = torch.clamp(torch.round(R._fdiv(xf, s)), -128, 127) * float(s)
    return (xf + (q - xf).detach()).to(x.dtype)


def slice_nd(x: torch.Tensor, slices) -> torch.Tensor:
    """SLICE: ``x[start:end:step]`` on each ``(axis, start, end, step)``
    (a later entry for the same axis wins, as in JAX), Python's slice
    semantics; a negative step through its indices."""
    per_axis = {int(ax): slice(s, e, st) for ax, s, e, st in slices}
    for ax, sl in per_axis.items():
        if sl.step is None or sl.step > 0:
            idx = [slice(None)] * x.dim()
            idx[ax] = sl
            x = x[tuple(idx)]
        else:
            x = x.index_select(ax, torch.arange(
                *sl.indices(x.shape[ax]), device=x.device))
    return x.contiguous()


# the conv activations beyond RELU: the exact tier applies each as a table
TABLE_ACTS = ("SILU", "SIGMOID", "RELU6", "LEAKY_RELU", "TANH", "HARD_SWISH")


def act_table(act: str, scale: float, alpha: float = 0.01
              ) -> Optional[torch.Tensor]:
    """A conv's activation beyond RELU on its int8 output (``scale`` the
    output's scale) as int8 [256] on the CPU, entry ``q + 128`` the act of
    ``q``: :func:`apply_fused_act` on the 256 values, so the table gives
    what it gives. None for an act that is not in ``TABLE_ACTS``."""
    if act not in TABLE_ACTS:
        return None
    q = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8)
    return apply_fused_act(q, act, scale, alpha=alpha).contiguous()


def reshape_to(x: torch.Tensor, out_t: TensorInfo) -> torch.Tensor:
    """RESHAPE to the declared shape, batch taken from ``x``; identity
    where the shape metadata is inconsistent."""
    target = list(out_t.shape)
    if target and target[0] == 1 and x.shape[0] != 1:
        target[0] = x.shape[0]
    numel_t = int(np.prod(target)) if target else 0
    return x.reshape(target) if numel_t == x.numel() else x


def upsample_scale(node: Node, x: torch.Tensor,
                   out_hw: Tuple[int, int]) -> Tuple[int, int]:
    """The nearest UPSAMPLE's factors; a corrupt or partial descriptor
    takes them from the shapes."""
    sc = node.attrs.get("scale", (0, 0))
    if sc[0] <= 0 or sc[1] <= 0:
        sc = (out_hw[0] // x.shape[1], out_hw[1] // x.shape[2])
    return sc


# ---------------------------------------------------------------------------
# Steps of a planned forward
# ---------------------------------------------------------------------------


class _Step:
    """One step of a planned forward: computes ``out`` from the
    activations named in ``reads`` (and the params)."""

    out: str
    reads: Tuple[str, ...] = ()
    is_kernel = False   # a launch of a hand-written kernel

    def run(self, env: Dict[str, torch.Tensor], plain: bool = False) -> None:
        raise NotImplementedError


class NodeStep(_Step):
    """A node on the logical path (``Executor.lower_node``)."""

    def __init__(self, ex: "Executor", node: Node):
        self.ex, self.node, self.out = ex, node, node.outputs[0]
        self.reads = tuple(i for i in node.inputs
                           if not ex.tensors[i].is_const)

    def run(self, env, plain=False):
        self.ex.lower_node(self.node, env, plain=plain)


class PoolStep(_Step):
    """A skipped SPPF maxpool recomputed where something outside the fused
    kernel needs it (``_ensure_logical``)."""

    def __init__(self, out: str, src: str, k: int):
        self.out, self.src, self.k = out, src, k
        self.reads = (src,)

    def run(self, env, plain=False):
        z = env[self.src]
        p = (self.k - 1) // 2
        env[self.out] = R.maxpool(z, (self.k, self.k), (1, 1),
                                  (z.shape[1], z.shape[2]), ((p, p), (p, p)))


class ConcatStep(_Step):
    """A virtual concat materialized where something needs it whole."""

    def __init__(self, out: str, ins: Sequence[str]):
        self.out, self.ins = out, list(ins)
        self.reads = tuple(ins)

    def run(self, env, plain=False):
        env[self.out] = R.concat([env[i] for i in self.ins], 3)


class KernelUnit(_Step):
    """One launch of a hand-written kernel (or, ``plain=True``, of its plain
    version). ``kind`` names the port's kernel (``KERNEL_OF_KIND``),
    ``mirrors`` the JAX function whose call it stands for, ``reads`` the
    activations it takes, ``residual`` the one fused in its epilogue."""

    kind: str
    mirrors: str
    residual: Optional[str] = None
    act: str = "NONE"
    # the product (TAT_SERVING_COMPUTE) of a unit whose JAX function takes
    # one, else the int8 one
    product: str = "int8"
    is_kernel = True

    def compute(self, env, plain=False) -> torch.Tensor:
        raise NotImplementedError

    def run(self, env, plain=False):
        env[self.out] = self.compute(env, plain)

    def __repr__(self):
        res = f" + {self.residual}" if self.residual else ""
        return (f"{type(self).__name__}({self.kind} <- {self.mirrors}: "
                f"{list(self.reads)}{res} -> {self.out})")


class ConvUnit(KernelUnit):
    """A conv through ``conv2d_int8_fused``: kernel #1 (1x1/s1 unpadded) or
    #2, with an optional fused residual. Its product ``compute`` is the
    executor's where the JAX function it mirrors takes one (the folded
    conv; the unplanned dispatcher's 1x1), else int8 (the dispatcher's KxK
    ``conv2d_int8_halo_fused`` and the XLA stem have no such argument)."""

    def __init__(self, ex: "Executor", node: Node, out: str,
                 ep: FK.Epilogue, mirrors: str,
                 residual: Optional[str] = None, res_scale: float = 1.0,
                 x: Optional[str] = None):
        a = node.attrs
        t = ex.tensors
        self.node, self.out, self.ep, self.mirrors = node, out, ep, mirrors
        self.x = x or node.inputs[0]
        self.residual, self.res_scale = residual, res_scale
        self.reads = (self.x,) + ((residual,) if residual else ())
        self.act = ep.act
        in_t = t[node.inputs[0]]
        self.out_hw = _nhwc_out_hw(t[node.outputs[0]])
        self.stride, self.dilation = a["stride"], a["dilation"]
        self.pads = R._conv_pads(
            (in_t.shape[1], in_t.shape[2]), self.out_hw, a["kernel"],
            a["stride"], a["dilation"], a["padding"], a["explicit_pad"])
        self.kind = ("matmul" if a["kernel"] == (1, 1)
                     and self.stride == (1, 1)
                     and self.pads == ((0, 0), (0, 0)) else "conv")
        self.product = (ex.compute if mirrors == "conv2d_int8_folded" or (
            mirrors == "conv2d_int8_fused" and self.kind == "matmul")
            else "int8")

    def compute(self, env, plain=False):
        n = self.node
        bias = env[n.inputs[2]] if len(n.inputs) > 2 else None
        res = env[self.residual] if self.residual else None
        return FK.conv2d_int8_fused(
            env[self.x], env[n.inputs[1]], bias, self.ep, self.out_hw,
            self.stride, self.dilation, self.pads, plain=plain,
            residual=res, res_scale=self.res_scale, compute=self.product)


class MultiUnit(KernelUnit):
    """A 1x1 conv over a virtual concat: kernel #3, one part per concat
    input, weights as column slices of the conv's [O, C] weight."""

    kind, mirrors = "multi", "matmul_int8_fused_multi"

    def __init__(self, node: Node, out: str, parts: Sequence[str],
                 widths: Sequence[int], me: FK.MultiEpilogue,
                 residual: Optional[str] = None, res_scale: float = 1.0,
                 product: str = "int8"):
        self.node, self.out, self.me, self.product = node, out, me, product
        self.parts, self.widths = list(parts), list(widths)
        self.residual, self.res_scale = residual, res_scale
        self.reads = tuple(parts) + ((residual,) if residual else ())
        self.act = me.ep.act

    def compute(self, env, plain=False):
        n = self.node
        x0 = env[self.parts[0]]
        nb, h, w = x0.shape[:3]
        m = nb * h * w
        w2d = env[n.inputs[1]].reshape(self.me.ep.cs.shape[0], -1)
        xs, ws, off = [], [], 0
        for p, ci in zip(self.parts, self.widths):
            xs.append(env[p].reshape(m, ci))
            ws.append(w2d[:, off:off + ci])
            off += ci
        bias = env[n.inputs[2]] if len(n.inputs) > 2 else None
        res = (env[self.residual].reshape(m, -1) if self.residual
               else None)
        fn = (FK.matmul_int8_fused_multi_plain if plain
              else FK.matmul_int8_fused_multi)
        return fn(xs, ws, bias, self.me, res, self.res_scale,
                  compute=self.product).reshape(nb, h, w, -1)


class BneckUnit(KernelUnit):
    """The C3 bottleneck pair (1x1 ``conv_a`` -> KxK/1 ``conv_b`` [+x]):
    kernel #6."""

    kind, mirrors = "bneck", "bottleneck_int8_fused"

    def __init__(self, conv_a: Node, conv_b: Node, out: str,
                 ep1: FK.Epilogue, ep2: FK.Epilogue, shortcut: bool,
                 res_scale: float, product: str = "int8"):
        self.conv_a, self.conv_b, self.out = conv_a, conv_b, out
        self.product = product
        self.ep1, self.ep2 = ep1, ep2
        self.shortcut, self.res_scale = shortcut, res_scale
        self.reads = (conv_a.inputs[0],)
        self.residual = conv_a.inputs[0] if shortcut else None
        self.act = ep2.act

    def compute(self, env, plain=False):
        a, b = self.conv_a, self.conv_b
        w1 = env[a.inputs[1]]
        fn = (FK.bottleneck_int8_fused_plain if plain
              else FK.bottleneck_int8_fused)
        return fn(env[a.inputs[0]], w1.reshape(w1.shape[0], -1),
                  env[a.inputs[2]] if len(a.inputs) > 2 else None, self.ep1,
                  env[b.inputs[1]],
                  env[b.inputs[2]] if len(b.inputs) > 2 else None, self.ep2,
                  self.shortcut, self.res_scale, compute=self.product)


class SppfUnit(KernelUnit):
    """SPPF's three pools, concat and 1x1 conv: kernel #4."""

    kind, mirrors = "sppf", "sppf_int8_fused"

    def __init__(self, node: Node, out: str, src: str, k: int,
                 ep: FK.Epilogue, product: str = "int8"):
        self.node, self.out, self.src, self.k, self.ep = \
            node, out, src, k, ep
        self.product = product
        self.reads = (src,)
        self.act = ep.act

    def compute(self, env, plain=False):
        n = self.node
        w = env[n.inputs[1]]
        fn = FK.sppf_int8_fused_plain if plain else FK.sppf_int8_fused
        return fn(env[self.src], w.reshape(w.shape[0], -1),
                  env[n.inputs[2]] if len(n.inputs) > 2 else None, self.ep,
                  self.k, compute=self.product)


class DwUnit(KernelUnit):
    """A stride-1 depthwise conv: kernel #7, weights [KH, KW, C]."""

    kind, mirrors = "dw", "depthwise_conv2d_int8_fused"

    def __init__(self, ex: "Executor", node: Node):
        t = ex.tensors
        self.node, self.out = node, node.outputs[0]
        self.ep = ex.epilogues[self.out]
        self.reads = (node.inputs[0],)
        self.act = self.ep.act
        in_t = t[node.inputs[0]]
        self.out_hw = _nhwc_out_hw(t[self.out])
        a = node.attrs
        self.pads = R._conv_pads(
            (in_t.shape[1], in_t.shape[2]), self.out_hw, a["kernel"],
            a["stride"], a["dilation"], a["padding"], a["explicit_pad"])

    def compute(self, env, plain=False):
        n = self.node
        fn = (FK.depthwise_conv2d_int8_fused_plain if plain
              else FK.depthwise_conv2d_int8_fused)
        return fn(env[n.inputs[0]], env[n.inputs[1]],
                  env[n.inputs[2]] if len(n.inputs) > 2 else None, self.ep,
                  self.out_hw, self.pads)


class ExactConvUnit(KernelUnit):
    """An int8 conv through ``ops.conv.conv2d_int8`` (the exact tier's
    convs, and the serving tier's dilated or non-square-stride ones):
    kernel #9, #10 or #11 for a per-tensor weight scale (``kind`` is the
    kernel's launch counter), the plain op for a per-channel one (``kind``
    ``"plain_convs"``, not a kernel unit). Its output is the requantized
    int8 conv with RELU applied after the clamp; a kernel unit applies any
    other activation through its table (``lut``, the executor's
    ``tables``) in the kernel's epilogue, a plain conv leaves it to the
    :class:`ActStep` after it."""

    mirrors = "conv2d_int8"

    def __init__(self, ex: "Executor", node: Node):
        a = node.attrs
        t = ex.tensors
        self.node, self.out = node, node.outputs[0]
        self.reads = (node.inputs[0],)
        in_t = t[node.inputs[0]]
        self.out_hw = _nhwc_out_hw(t[self.out])
        self.stride, self.dilation = a["stride"], a["dilation"]
        self.pads = R._conv_pads(
            (in_t.shape[1], in_t.shape[2]), self.out_hw, a["kernel"],
            a["stride"], a["dilation"], a["padding"], a["explicit_pad"])
        self.scales = (ex.scale(node.inputs[0]), ex.w_scale(node),
                       ex.scale(self.out))
        self.round_mode = ex.round_mode
        self.relu = a.get("activation", "NONE") == "RELU"
        self.kind = C.route(a["kernel"], self.stride, self.dilation,
                            self.pads, self.scales[1])
        self.is_kernel = self.kind != C.PLAIN
        self.lut = ex.table(node) if self.is_kernel else None
        self.act = a.get("activation", "NONE") if self.lut is not None \
            else ("RELU" if self.relu else "NONE")

    def compute(self, env, plain=False, act=True):
        """The unit's output; ``plain=True``: the plain conv, then the
        table; ``act=False``: without the table (the conv before its
        activation)."""
        n = self.node
        bias = env[n.inputs[2]] if len(n.inputs) > 2 else None
        return C.conv2d_int8(
            env[n.inputs[0]], env[n.inputs[1]], bias, self.out_hw,
            self.stride, self.dilation, self.pads, *self.scales,
            self.round_mode, self.relu, plain=plain,
            lut=self.lut if act else None)


class ActStep(_Step):
    """A conv's activation that its kernel or plain op did not apply, on
    its int8 output: a gather through its table (the executor's
    ``tables``), which gives ``apply_fused_act``'s values."""

    def __init__(self, ex: "Executor", node: Node):
        self.node, self.out = node, node.outputs[0]
        self.reads = (self.out,)
        self.act = node.attrs.get("activation", "NONE")
        self.lut = ex.table(node)

    def run(self, env, plain=False):
        env[self.out] = RK.apply_table(env[self.out], self.lut)


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------


class Executor:
    """``executor(params, inputs) -> outputs`` over torch tensors: the
    serving tier, and the base of the other tiers, which share its
    lowering (:meth:`lower_node`).

    ``planned=True`` (the default) runs the planned serving tier, whose
    schedule of steps (``self.steps``) is built here; ``planned=False``
    runs the unplanned per-node lowering. Epilogue rows (host-computed
    f32 scales) are built once, on ``device``. ``round_mode`` is the
    requantize rule of the convs outside the fused kernels, as JAX's
    ``ExecOptions.round_mode``."""

    # the tier's options (JAX ``ExecOptions``): the serving tier's int8
    # convs at dilation 1 and a square stride run in the fused kernels
    fused = True
    compat = False
    compute_dtype = torch.float32
    accum_dtype: Optional[torch.dtype] = None

    def __init__(self, graph: Graph, device: torch.device | str = "cuda",
                 planned: bool = True,
                 round_mode: RoundMode = RoundMode.HALF_AWAY):
        self._setup(graph, fuse_silu_pairs(graph), device, round_mode)
        self.epilogues: Dict[str, FK.Epilogue] = {}
        for node in self.nodes:
            if self.fused_conv(node) or self.dw_kernel(node):
                self.epilogues[node.outputs[0]] = self._conv_epilogue(node)
        if planned:
            self.plan = P.plan_folds(self.nodes, self.tensors, graph.outputs)
            self.steps = _Scheduler(self).run()

    def _setup(self, graph: Graph, nodes: List[Node],
               device: torch.device | str, round_mode: RoundMode) -> None:
        """What every tier sets up: the nodes it runs (each checked to be
        lowerable), the device, the conv weights its params repack."""
        self.graph = graph
        self.tensors = graph.tensors
        self.nodes: List[Node] = nodes
        self.device = resolve_device(device)
        self.round_mode = round_mode
        self.plan: Optional[P.FoldPlan] = None
        self.steps: List[_Step] = []
        self.tables: Dict[str, torch.Tensor] = {}
        self._donated: Optional[List[List[str]]] = None
        self._zeros: Dict[str, torch.Tensor] = {}
        # the TAT_* modes, resolved once (JAX: at trace time)
        self.fast_silu = bool(config.get("TAT_FAST_SILU"))
        self.compute = FK.compute_mode(None)
        self.silu_tanh = bool(config.get("TAT_SILU_TANH"))
        for node in nodes:
            self._check(node)
        self.conv_weights = conv_weight_names(graph)

    # -- build time --------------------------------------------------------

    def degenerate(self, node: Node) -> bool:
        """The degenerate guard (:meth:`fill_degenerate`) from the declared
        shapes: a zero-sized input or output, or a pool with a zero
        kernel or stride."""
        a = node.attrs
        return (any(0 in self.tensors[t].shape
                    for t in list(node.inputs) + list(node.outputs))
                or (node.op in ("MAXPOOL", "AVGPOOL")
                    and (0 in a.get("kernel", (1, 1))
                         or 0 in a.get("stride", (1, 1)))))

    def _check(self, node: Node) -> None:
        """Raise for a node no tier lowers, after the degenerate guard (a
        degenerate node of any op writes zeros)."""
        if self.degenerate(node):
            return
        if node.op not in LOWERED_OPS:
            raise NotImplementedError(
                f"op {node.op!r} is lowered by no tier, as by no tier of the "
                "JAX package (ROADMAP.md A.4: an importer emits only "
                "lowered ops)")
        if len(node.inputs) < _WEIGHTED.get(node.op, 1):
            raise ValueError(f"{node.op} node {node.name!r} lacks its "
                             "weight inputs")

    def int8_conv(self, node: Node) -> bool:
        """An int8 conv of one group, not depthwise: the conv a tier routes
        to its kernels (:meth:`conv_steps`)."""
        return (node.op in ("CONV2D", "DEPTHWISE_CONV2D")
                and len(node.inputs) >= 2
                and _is_int8(self.tensors[node.inputs[0]])
                and not is_depthwise(node, self.tensors)
                and node.attrs.get("groups", 1) == 1
                and not self.degenerate(node))

    def fused_conv(self, node: Node) -> bool:
        """Does the serving tier run ``node`` in the fused kernels (#1/#2)?
        An int8 conv at dilation 1 and a square stride (JAX executor.py:
        1067-1069); the others take the exact tier's route."""
        a = node.attrs
        return (self.fused and self.int8_conv(node)
                and a["dilation"] == (1, 1) and a["stride"][0] == a["stride"][1])

    def dw_kernel(self, node: Node) -> bool:
        """Does the serving tier run ``node`` in the depthwise kernel?
        The JAX test (executor.py:653-662): an int8 depthwise conv at
        stride 1, dilation 1, over a non-empty 4-D input."""
        if not self.fused or not is_depthwise(node, self.tensors):
            return False
        a = node.attrs
        in_t = self.tensors[node.inputs[0]]
        return (_is_int8(in_t) and _is_int8(self.tensors[node.outputs[0]])
                and a.get("stride", (1, 1)) == (1, 1)
                and a.get("dilation", (1, 1)) == (1, 1)
                and len(in_t.shape) == 4 and 0 not in in_t.shape)

    def scale(self, name: str) -> float:
        return self.tensors[name].quant.scale

    def w_scale(self, node: Node):
        wt = self.tensors[node.inputs[1]]
        return (wt.channel_scales if wt.channel_scales is not None
                else wt.quant.scale)

    def conv_epilogue(self, node: Node, in_scale: float,
                      out_scale: float, stem: bool = False) -> FK.Epilogue:
        """The epilogue of ``node``'s kernel: its act as the serving
        kernels apply it (:func:`kernel_act`), or, for the stem stage
        (``stem``), as JAX's XLA stem does (the exp SiLU)."""
        a = node.attrs
        act = kernel_act(a.get("activation", "NONE"),
                         self.fast_silu and not stem)
        if self.compat and act not in ("NONE", "RELU"):
            act = "NONE"   # JAX executor.py:1074-1078: the reference's RELU only
        return FK.epilogue_rows(
            self.w_scale(node), in_scale, out_scale, act,
            self.tensors[node.outputs[0]].shape[3],
            alpha=a.get("alpha", 0.01) or 0.01, device=self.device)

    def _conv_epilogue(self, node: Node) -> FK.Epilogue:
        return self.conv_epilogue(node, self.scale(node.inputs[0]),
                                  self.scale(node.outputs[0]))

    def table(self, node: Node) -> Optional[torch.Tensor]:
        """The table of ``node``'s activation beyond RELU on its int8
        output (:func:`act_table`), on the device, made once; None in
        compat mode or for an act that has none."""
        out = node.outputs[0]
        if out not in self.tables and not self.compat:
            a = node.attrs
            lut = act_table(a.get("activation", "NONE"), self.scale(out),
                            a.get("alpha", 0.01) or 0.01)
            if lut is not None:
                self.tables[out] = lut.to(self.device)
        return self.tables.get(out)

    def conv_steps(self, node: Node) -> List[_Step]:
        """The steps of an :meth:`int8_conv`: in the serving tier's fused
        kernels (#1/#2, the act in the epilogue where it has it) where
        :meth:`fused_conv`, else through ``ops.conv`` (#9-#11, or the plain
        op for per-channel scales); then the act that neither applied."""
        if self.fused_conv(node):
            out = node.outputs[0]
            unit: KernelUnit = ConvUnit(self, node, out, self.epilogues[out],
                                        mirrors="conv2d_int8_fused")
        else:
            unit = ExactConvUnit(self, node)
        return [unit] + self.act_steps(node, unit.act)

    def act_steps(self, node: Node, applied: str) -> List[_Step]:
        """An :class:`ActStep` where ``node``'s act is not ``applied``."""
        act = node.attrs.get("activation", "NONE")
        if act_applied(applied, act) or self.table(node) is None:
            return []
        return [ActStep(self, node)]

    # -- run time ----------------------------------------------------------

    def fill_degenerate(self, node: Node, env: Dict[str, torch.Tensor]
                        ) -> bool:
        """The degenerate region guard: a node over a zero-shaped tensor
        (the dangling subgraphs of some files), or a pool with a zero
        kernel or stride, writes zeros of its declared shapes."""
        a = node.attrs
        if not (any(0 in env[i].shape for i in node.inputs if i in env)
                or any(0 in self.tensors[o].shape for o in node.outputs)
                or (node.op in ("MAXPOOL", "AVGPOOL")
                    and (0 in a.get("kernel", (1, 1))
                         or 0 in a.get("stride", (1, 1))))):
            return False
        for o in node.outputs:
            if o not in self._zeros:   # made once: no op writes in place
                t = self.tensors[o]
                self._zeros[o] = torch.zeros(
                    t.shape, dtype=_torch_dtype(t.dtype), device=self.device)
            env[o] = self._zeros[o]
        return True

    @property
    def units(self) -> List[KernelUnit]:
        """The kernel units of a forward, in launch order."""
        return [s for s in self.steps if s.is_kernel]

    def launch_census(self) -> Dict[str, int]:
        """Kernel launches of one planned forward, by the launch counter of
        each kernel a unit kind runs (no unit runs the dma conv, as no
        JAX executor path does), and of each exact-tier kernel that a
        dilated or non-square-stride conv launches."""
        c = collections.Counter(KERNEL_OF_KIND[u.kind] for u in self.units)
        census = {k: c.get(k, 0) for k in FK.launches
                  if k in KERNEL_OF_KIND.values()}
        census.update({k: c[k] for k in RK.launches if c.get(k)})
        return census

    def device_params(self, np_params: Dict[str, np.ndarray]
                      ) -> Dict[str, torch.Tensor]:
        """:func:`params_from_jax` of the JAX layout, the conv weights
        repacked by role; a float conv weight in ``compute_dtype`` once,
        the values every conv casts it to."""
        out = params_from_jax(np_params, self.device, self.conv_weights)
        for k in self.conv_weights & set(out):
            if out[k].dtype.is_floating_point:
                out[k] = out[k].to(self.compute_dtype)
        return out

    def donated(self) -> List[List[str]]:
        """For each step (or node, unplanned) of a forward, the graph inputs
        whose last reader it is and which are no graph output: what
        ``donate=True`` drops from the forward's tensors after it."""
        if self._donated is None:
            seq = ([s.reads for s in self.steps] if self.steps else
                   [n.inputs for n in self.nodes])
            keep = set(self.graph.outputs)
            last: Dict[str, int] = {}
            for i, reads in enumerate(seq):
                for r in reads:
                    if r in self.graph.inputs and r not in keep:
                        last[r] = i
            self._donated = [[] for _ in seq]
            for r, i in last.items():
                self._donated[i].append(r)
        return self._donated

    def __call__(self, params: Dict[str, torch.Tensor],
                 inputs: Dict[str, torch.Tensor],
                 outputs: Optional[List[str]] = None,
                 capture: Optional[list] = None,
                 donate: bool = False,
                 ) -> Dict[str, torch.Tensor]:
        """``capture`` (planned serving or exact): a list that receives,
        for every kernel unit, ``(unit, {read name: tensor}, output)``.
        ``donate`` (JAX's ``donate_inputs``): the caller gives up the fed
        tensors, and each graph input leaves the forward's tensors after
        its last reader, so its memory can be reused."""
        env: Dict[str, torch.Tensor] = dict(params)
        env.update(inputs)
        drops = self.donated() if donate and outputs is None else None
        seq = self.steps or self.nodes
        for i, step in enumerate(seq):
            if self.steps:
                step.run(env)
                if capture is not None and step.is_kernel:
                    capture.append((step, {r: env[r] for r in step.reads},
                                    env[step.out]))
            else:
                self.lower_node(step, env)
            if drops:
                for r in drops[i]:
                    del env[r]
        names = self.graph.outputs if outputs is None else outputs
        return {o: env[o] for o in names}

    def lower_node(self, node: Node, env: Dict[str, torch.Tensor],
                   plain: bool = False) -> None:
        """``_lower_node``: compute ``node``'s outputs from ``env`` into
        ``env``, branch for branch as JAX's (executor.py:1005-1370), the
        tier's kernels taking its int8 convs. ``plain=True`` runs the
        kernels' plain versions on any device (a check, never the serving
        path)."""
        if self.fill_degenerate(node, env):
            return
        op = node.op
        a = node.attrs
        out_name = node.outputs[0]
        out_t = self.tensors[out_name]
        compat = self.compat
        scale = self.scale

        if op in ("CONV2D", "DEPTHWISE_CONV2D"):
            if self.int8_conv(node):
                for step in self.conv_steps(node):
                    step.run(env, plain)
            else:
                env[out_name] = self._other_conv(node, env, plain)
            return
        if op == "SPLIT":
            x = env[node.inputs[0]]
            off = 0
            for o, sz in zip(node.outputs, a["sizes"]):
                env[o] = x.narrow(int(a["axis"]), off, sz).contiguous()
                off += sz
            return
        if op == "GRU":
            ins = [env[i] for i in node.inputs]
            y, y_h = R.gru(ins[0], ins[1], ins[2],
                           ins[3] if len(ins) > 3 else None,
                           ins[4] if len(ins) > 4 else None,
                           a["hidden_size"],
                           bool(a.get("linear_before_reset", 0)),
                           a.get("direction", "forward"))
            env[node.outputs[0]] = y
            if len(node.outputs) > 1:
                env[node.outputs[1]] = y_h
            return

        x = env[node.inputs[0]]
        if op == "MAXPOOL":
            # the reference ignores pool padding entirely
            pads = ((0, 0), (0, 0)) if compat else \
                _pool_pads(a, (x.shape[1], x.shape[2]))
            out = R.maxpool(x, a["kernel"], a["stride"], _nhwc_out_hw(out_t),
                            pads)
        elif op in ("AVGPOOL", "GLOBAL_AVGPOOL", "SILU") and compat:
            out = x   # not implemented by the reference: pass-through
        elif op == "AVGPOOL":
            out = R.avgpool(x, a["kernel"], a["stride"], _nhwc_out_hw(out_t),
                            _pool_pads(a, (x.shape[1], x.shape[2])),
                            scale(node.inputs[0]), scale(out_name))
        elif op == "GLOBAL_AVGPOOL":
            out = R.global_avgpool(x, scale(node.inputs[0]), scale(out_name))
        elif op == "RELU":
            out = R.relu(x)
        elif op == "RELU6":
            out = R.relu6(x, scale(node.inputs[0]), compat)
        elif op == "LEAKY_RELU":
            out = R.leaky_relu(x, a.get("alpha", 0.0) or 0.01)
        elif op == "SIGMOID":
            out = R.sigmoid(x, scale(node.inputs[0]), scale(out_name))
        elif op == "SILU":
            out = R.silu(x, scale(node.inputs[0]), out_scale=scale(out_name),
                         tanh=self.silu_tanh)
        elif op == "SILU_FUSED":
            out = R.silu(x, in_scale=a["in_scale"], sig_scale=a["sig_scale"],
                         out_scale=a["out_scale"], fuse=True,
                         tanh=self.silu_tanh)
        elif op == "SOFTMAX":
            out = R.softmax(x, axis=int(a.get("axis", -1)),
                            in_scale=scale(node.inputs[0]),
                            out_scale=scale(out_name), compat=compat)
        elif op == "CONCAT":
            xs = [env[i] for i in node.inputs]
            out = R.concat(xs, concat_axis_of(
                [tuple(x.shape) for x in xs], tuple(out_t.shape),
                int(node.attrs.get("axis", 3))))
        elif op in ("ADD", "MUL"):
            fn = R.add_q if op == "ADD" else R.mul_q
            out = fn(x, env[node.inputs[1]], scale(node.inputs[0]),
                     scale(node.inputs[1]), scale(out_name))
        elif op == "UPSAMPLE":
            out_hw = _nhwc_out_hw(out_t)
            if a.get("mode", 0) == 1 and not compat:
                out = R.upsample_bilinear(x, out_hw)
            else:
                out = R.upsample_nearest(x, upsample_scale(node, x, out_hw),
                                         out_hw)
        elif op in ("TRANSPOSE", "RESHAPE") and compat:
            out = x   # the reference moves no data
        elif op == "TRANSPOSE" and "perm" in a:
            out = x.permute(tuple(a["perm"])).contiguous()
        elif op in ("TRANSPOSE", "RESHAPE"):   # a re-declared shape
            out = reshape_to(x, out_t)
        elif op == "DEQUANT":   # int8, or the same values in a float type
            out = x.to(torch.float32) * float(np.float32(a["scale"]))
        elif op == "QUANT":
            out = R.quantize_edge(x, a["scale"])
        elif op == "FAKE_QUANT":
            out = fake_quant(x, a["scale"])
        elif op == "SLICE":
            out = slice_nd(x, a["slices"])
        elif op in ("SUB", "DIV", "POW"):
            def deq(nm: str) -> torch.Tensor:
                v = env[nm]
                if v.dtype.is_floating_point:
                    return v.to(torch.float32)
                return v.to(torch.float32) * float(
                    np.float32(scale(nm) or 1.0))
            fn = {"SUB": torch.sub, "DIV": torch.div, "POW": torch.pow}[op]
            out = fn(deq(node.inputs[0]), deq(node.inputs[1]))
            if _is_int8(out_t):
                out = R.quantize_edge(out, out_t.quant.scale)
        elif op == "CONV1D":
            out = R.conv1d(x, env[node.inputs[1]],
                           env[node.inputs[2]] if len(node.inputs) > 2
                           else None, a["stride"], a.get("dilation", 1),
                           a.get("pads", (0, 0)), out_t.shape[2])
        elif op == "CONV1D_TRANSPOSE":
            out = R.conv1d_transpose(
                x, env[node.inputs[1]],
                env[node.inputs[2]] if len(node.inputs) > 2 else None,
                a["stride"], a.get("pads", (0, 0)), out_t.shape[2])
        elif op == "CLIP":
            out = clip_q(x, a.get("min"), a.get("max"), scale(node.inputs[0]))
        elif op == "BATCHNORM":
            c = x.shape[-1]
            sc, bi = (env[node.inputs[i]].reshape(-1)[:c]
                      if len(node.inputs) > i else None for i in (1, 2))
            if sc is None:
                sc = torch.ones(c, dtype=torch.float32, device=x.device)
            if bi is None:
                bi = torch.zeros(c, dtype=torch.float32, device=x.device)
            out = R.batchnorm(x, sc, bi, scale(node.inputs[0]),
                              scale(out_name))
        elif op == "FC":
            w = env[node.inputs[1]]
            out = R.fc(x.reshape(x.shape[0], -1),
                       w.reshape(-1, w.shape[-1]) if w.dim() > 2 else w,
                       env[node.inputs[2]] if len(node.inputs) > 2 else None,
                       scale(node.inputs[0]), self.w_scale(node),
                       scale(out_name), a.get("activation", "NONE") == "RELU")
        else:   # a node the build let through as degenerate
            raise NotImplementedError(f"op {op!r} over non-empty tensors")
        env[out_name] = out

    def _other_conv(self, node: Node, env: Dict[str, torch.Tensor],
                    plain: bool) -> torch.Tensor:
        """A conv no tier routes to its int8 conv kernels (JAX executor.py:
        1037-1104): an int8 depthwise conv (the serving tier's kernel #7
        where :meth:`dw_kernel`, but for SILU outside the planned tier,
        which JAX applies on the requantized value), an int8 grouped one,
        or a float one in ``compute_dtype``; then the act it did not
        apply."""
        a = node.attrs
        x = env[node.inputs[0]]
        w = env[node.inputs[1]]
        bias = env[node.inputs[2]] if len(node.inputs) > 2 else None
        out_name = node.outputs[0]
        out_hw = _nhwc_out_hw(self.tensors[out_name])
        pads = R._conv_pads(
            (x.shape[1], x.shape[2]), out_hw, a["kernel"], a["stride"],
            a["dilation"], a["padding"], a["explicit_pad"])
        act = a.get("activation", "NONE")
        relu = act == "RELU"
        groups = a.get("groups", 1)
        depthwise = is_depthwise(node, self.tensors)
        applied = "RELU" if relu else "NONE"
        if _is_int8(self.tensors[node.inputs[0]]):
            if depthwise and self.dw_kernel(node) and (
                    self.plan is not None or act != "SILU"):
                unit = DwUnit(self, node)
                out, applied = unit.compute(env, plain), unit.act
            elif depthwise:
                out = R.depthwise_conv2d_int8(
                    x, w, bias, out_hw, a["stride"], a["dilation"], pads,
                    self.scale(node.inputs[0]), self.w_scale(node),
                    self.scale(out_name), self.round_mode, relu)
            else:
                out = R.grouped_conv2d_int8(
                    x, w, bias, groups, out_hw, a["stride"], a["dilation"],
                    pads, self.scale(node.inputs[0]), self.w_scale(node),
                    self.scale(out_name), self.round_mode, relu)
        elif depthwise:
            out = R.depthwise_conv2d_f32(x, w, bias, out_hw, a["stride"],
                                         a["dilation"], pads, relu)
        else:
            out = R.conv2d_f32(x, w, bias, out_hw, a["stride"], a["dilation"],
                               pads, relu, self.compute_dtype,
                               self.accum_dtype, groups)
        if act_applied(applied, act):
            return out
        return apply_fused_act(out, act, self.scale(out_name), self.compat,
                               a.get("alpha", 0.01) or 0.01, self.silu_tanh)


class _Scheduler:
    """Replays the JAX fold-aware lowering over shapes alone and records
    the steps it takes.

    State, as ``_FoldPlan``'s run-time fields and the JAX ``env``:
    ``env`` (names present), ``rt`` (``runtime_fold``: the fold of an
    array as stored), ``phys`` (the stored array's last dimension: f*C,
    lane-padded to 128 for kernel outputs), ``qb`` (``qbf16_env``: stem
    stage tensors held as bf16), ``parts`` (``plan.parts`` as mutated at
    run time) and ``live`` (``bneck_live``: deferred bottleneck halves).
    Each method cites the lines of ``thingino_accel_tpu/runtime/
    executor.py`` it mirrors."""

    def __init__(self, ex: Executor):
        self.ex = ex
        self.t = ex.tensors
        self.plan = ex.plan
        g = ex.graph
        self.env = set(g.inputs) | {n for n, t in self.t.items()
                                    if t.is_const}
        self.rt: Dict[str, int] = {}
        self.phys: Dict[str, int] = {
            i: self.c(i) if len(self.t[i].shape) == 4 else 0
            for i in g.inputs}
        self.qb: set = set()
        self.parts = dict(self.plan.parts)
        self.live: set = set()
        self.steps: List[_Step] = []

    def c(self, name: str) -> int:
        return self.t[name].shape[3]

    def run(self) -> List[_Step]:
        """The main loop of the JAX ``build_executor.fn`` (139-157)."""
        plan = self.plan
        for node in self.ex.nodes:
            out0 = node.outputs[0]
            if out0 in plan.skip_outputs and (
                    out0 in self.env or out0 in plan.virtual_concat
                    or out0 in plan.pool_of):
                continue   # folded into a consumer's kernel
            if self.folded(node):
                continue
            self.unfold_inputs(node)
            self.logical(node)
        for o in self.ex.graph.outputs:
            self.ensure_logical(o)
        return self.steps

    # -- helpers mirroring _ensure_logical / _unfold_inputs (596-634) -----

    def ensure_logical(self, name: str) -> None:
        plan = self.plan
        if name not in self.env and name in plan.pool_of:
            src, k = plan.pool_of[name]
            self.ensure_logical(src)
            self.steps.append(PoolStep(name, src, k))
            self.env.add(name)
            self.phys[name] = self.c(name)
            return
        if name not in self.env and name in plan.virtual_concat:
            ins = plan.virtual_concat[name]
            for i in ins:
                self.ensure_logical(i)
            self.steps.append(ConcatStep(name, ins))
            self.env.add(name)
            self.phys[name] = sum(self.c(i) for i in ins)
            return
        self.qb.discard(name)
        if name not in self.rt:
            return
        self.rt.pop(name)
        self.phys[name] = self.c(name)

    def unfold_inputs(self, node: Node) -> None:
        plan = self.plan
        for i in node.inputs:
            if i in self.env or i in plan.virtual_concat or i in plan.pool_of:
                self.ensure_logical(i)

    def logical(self, node: Node) -> None:
        """``_lower_node`` (1005), then the output's fold is popped."""
        if self.ex.int8_conv(node):
            self.steps.extend(self.ex.conv_steps(node))
        else:
            self.steps.append(NodeStep(self.ex, node))
        for o in node.outputs:
            self.env.add(o)
            self.rt.pop(o, None)
            self.phys[o] = self.c(o) if len(self.t[o].shape) == 4 else 0

    def stored(self, name: str, f_out: int, phys: int) -> None:
        """A kernel's output enters env (934-939)."""
        self.env.add(name)
        o_ch = self.c(name)
        pad = phys - f_out * o_ch
        self.phys[name] = phys
        if f_out > 1 or pad > 0:
            self.rt[name] = f_out
            self.parts[name] = (o_ch,) + ((-pad,) if pad else ())

    # -- _lower_node_folded (637-1002) -------------------------------------

    def folded(self, node: Node) -> bool:
        ex, plan, t = self.ex, self.plan, self.t
        out = node.outputs[0]
        if ex.dw_kernel(node):   # fused depthwise (651-687): logical output
            self.unfold_inputs(node)
            unit = DwUnit(ex, node)
            self.steps.extend([unit] + ex.act_steps(node, unit.act))
            self.env.add(out)
            self.phys[out] = self.c(out)
            return True
        if P.conv_fold_eligible(node, t):
            return self.folded_conv(node)
        f_planned = plan.f(out)
        if f_planned <= 1:
            return False
        if node.op in ("ADD", "MUL") or node.op in P.FOLD_ELTWISE:
            # 946-987: on the folded layout, the same values
            ins = (node.inputs if node.op in ("ADD", "MUL")
                   else node.inputs[:1])
            if any(self.rt.get(i, 1) != f_planned for i in ins):
                return False
            self.steps.append(NodeStep(ex, node))
            i0 = node.inputs[0]
            self.env.add(out)
            self.rt[out] = f_planned
            self.parts[out] = self.parts.get(i0, (self.c(i0),))
            self.phys[out] = self.phys[i0]
            return True
        if node.op == "CONCAT":   # 989-1000
            if out in plan.virtual_concat:
                return True
            if any(self.rt.get(i, 1) != f_planned for i in node.inputs):
                return False
            self.steps.append(NodeStep(ex, node))
            self.env.add(out)
            self.rt[out] = f_planned
            ps = []
            for i in node.inputs:
                ps.extend(self.parts.get(i, (self.c(i),)))
            self.parts[out] = tuple(ps)
            self.phys[out] = sum(self.phys[i] for i in node.inputs)
            return True
        return False

    def folded_conv(self, node: Node) -> bool:
        ex, plan, t = self.ex, self.plan, self.t
        a = node.attrs
        act = kernel_act(a.get("activation", "NONE"), ex.fast_silu)
        out = node.outputs[0]
        src = node.inputs[0]
        s = a["stride"][0]
        f_out = plan.f(out)

        # bottleneck, first half: defer the 1x1 (695-711)
        if out in plan.bneck:
            okf = (src in self.env and src not in self.qb
                   and self.rt.get(src, 1) == f_out)
            b_out = plan.bneck[out][1].outputs[0]
            if okf and plan.res_fuse.get(b_out) is not None:
                # the in-kernel residual reads x's lanes
                okf = (_ceil128(self.phys[src])
                       == _ceil128(f_out * self.c(b_out)))
            if okf:
                self.live.add(out)
                return True

        cin = self.c(src)
        k2c = a["kernel"][0] * a["kernel"][1] * cin
        if (out in plan.stem_stage or cin < 16) and k2c <= 1024:
            # the stem stage (727-757): XLA's bf16 conv in JAX, exact,
            # so kernels #1/#2 here (the int8 product, the exp SiLU); no
            # residual
            emit = plan.stem_emit.get(out, "int8")
            if src not in self.qb:
                self.ensure_logical(src)
            unit = ConvUnit(ex, node, out,
                            ex.conv_epilogue(node, ex.scale(src),
                                             ex.scale(out), stem=True),
                            mirrors="conv2d_int8_stem_fused")
            self.steps.extend([unit] + ex.act_steps(node, unit.act))
            if emit == "qbf16":
                self.env.add(out)
                self.qb.add(out)
                self.phys[out] = self.c(out)
                return True
            self.stored(out, f_out, f_out * self.c(out))
            return True

        # epilogue residual (759-776); the JAX `_act_applied` guard always
        # holds for a planned residual, whose act is NONE, RELU or SILU
        # (SILU_FAST under TAT_FAST_SILU)
        o_ch = self.c(out)
        store = out
        residual, res_scale = None, 1.0
        ri = plan.res_fuse.get(out)
        if ri is not None:
            add_node, other = ri
            p_other = self.parts.get(other, (o_ch,))
            if (other in self.env and self.rt.get(other, 1) == f_out
                    and other not in self.qb
                    and tuple(ci for ci in p_other if ci > 0) == (o_ch,)):
                residual, res_scale = other, ex.scale(other)
                store = add_node.outputs[0]
        out_s = ex.scale(store)

        if src in self.live:   # bottleneck, second half (779-820)
            self.live.discard(src)
            conv_a = plan.bneck[src][0]
            x_nm = conv_a.inputs[0]
            ep1 = ex.conv_epilogue(conv_a, ex.scale(x_nm), ex.scale(src))
            ep2 = ex.conv_epilogue(node, ex.scale(src), out_s)
            unit: KernelUnit = BneckUnit(
                conv_a, node, store, ep1, ep2, residual is not None,
                FK.res_scale_bneck(ex.scale(x_nm), out_s, act), ex.compute)
        elif (src in plan.sppf and a["kernel"] == (1, 1) and s == 1
              and residual is None and f_out == 1):   # SPPF (821-830)
            p_src, pk = plan.sppf[src]
            self.ensure_logical(p_src)
            unit = SppfUnit(node, store, p_src, pk,
                            ex.conv_epilogue(node, ex.scale(p_src), out_s),
                            ex.compute)
        elif (src in plan.virtual_concat and a["kernel"] == (1, 1)
              and s == 1):   # virtual concat (831-908)
            ins = plan.virtual_concat[src]
            for i in ins:
                if i not in self.env:
                    self.ensure_logical(i)
            if any(self.rt.get(i, 1) != f_out or i in self.qb
                   for i in ins):
                # layouts diverged from the plan: materialize the concat
                # and take the ordinary path with its single scale
                self.ensure_logical(src)
                if f_out > 1:
                    self.rt[src] = f_out
                    self.parts[src] = (cin,)
                    self.phys[src] = f_out * cin
                unit = ConvUnit(
                    ex, node, store,
                    ex.conv_epilogue(node, ex.scale(src), out_s),
                    mirrors="conv2d_int8_folded", residual=residual,
                    res_scale=FK.res_scale_folded(res_scale, out_s, act))
            else:
                me = FK.multi_epilogue(
                    ex.w_scale(node), [ex.scale(i) for i in ins], out_s,
                    act, o_ch, alpha=a.get("alpha", 0.01) or 0.01,
                    bias_scale=ex.scale(src), device=ex.device)
                unit = MultiUnit(
                    node, store, ins, [self.c(i) for i in ins], me,
                    residual=residual,
                    res_scale=FK.res_scale_multi(res_scale, out_s, act),
                    product=ex.compute)
        else:   # the ordinary folded conv (909-926)
            g = s * f_out
            if self.rt.get(src, 1) != g:
                self.ensure_logical(src)
                if g > 1 and t[src].shape[2] % g:
                    return False   # W not foldable -> logical path
            unit = ConvUnit(
                ex, node, store, ex.conv_epilogue(node, ex.scale(src), out_s),
                mirrors="conv2d_int8_folded", residual=residual,
                res_scale=FK.res_scale_folded(res_scale, out_s, act))
        self.steps.extend([unit] + ex.act_steps(node, unit.act))
        self.stored(store, f_out, _ceil128(f_out * o_ch))
        return True


# ---------------------------------------------------------------------------
# The exact and fast tiers
# ---------------------------------------------------------------------------


class ExactExecutor(Executor):
    """The exact tier, ``mode`` ``"full"`` or ``"compat"`` (port of
    ``build_executor`` with ``_lower_node``): a schedule of steps, one per
    node but two for a plain conv with an activation beyond RELU (the
    table's gather after it). ``tables``: each int8 conv's activation
    table (:func:`act_table`, built on the CPU and moved to ``device``
    once), by its output's name; none in compat mode.

    Compat mode replicates the reference runtime: no SIGMOID+MUL fusion,
    only a conv's RELU, MAXPOOL without pads, AVGPOOL, GLOBAL_AVGPOOL,
    SILU, SOFTMAX, RESHAPE and TRANSPOSE as pass-throughs, RELU6 as RELU,
    nearest UPSAMPLE for a bilinear one."""

    fused = False

    def __init__(self, graph: Graph, device: torch.device | str = "cuda",
                 mode: str = "full",
                 round_mode: RoundMode = RoundMode.HALF_AWAY,
                 fuse_silu: bool = True):
        if mode not in ("full", "compat"):
            raise ValueError(f"unknown mode {mode!r}")
        self.compat = mode == "compat"
        self._setup(graph, fuse_silu_pairs(graph)
                    if fuse_silu and not self.compat else list(graph.nodes),
                    device, round_mode)
        for node in self.nodes:
            self.steps.extend(self.conv_steps(node) if self.int8_conv(node)
                              else [NodeStep(self, node)])

    def launch_census(self) -> Dict[str, int]:
        """Where one forward's convs run, from the shapes alone: launches
        per kernel counter, and ``"plain_convs"`` (per-channel convs on
        the plain op)."""
        c = collections.Counter(s.kind for s in self.steps
                                if isinstance(s, ExactConvUnit))
        return {k: c.get(k, 0) for k in list(RK.launches) + [C.PLAIN]}


class FastExecutor(ExactExecutor):
    """The fast tier (port of ``build_executor`` with the float branches of
    ``_lower_node``) over a dequantized graph (``ir.passes.
    dequantize_graph``): node by node, the float convs through
    ``F.conv2d`` (:func:`ops.reference.conv2d_f32`, in ``compute_dtype``,
    the sums in float32 or, with ``accum_dtype=torch.bfloat16``, in bf16;
    depthwise always in float32), the other ops in plain torch, DEQUANT
    (int8 or float input) and QUANT (PLUS_HALF_TRUNC, clamp) at the edges.
    SIGMOID+MUL pairs fuse (``fuse_silu``) into ``x * sigmoid(x)`` in the
    activation's type. No op of the fast tier is a TPU kernel, so none of
    these is a hand-written one; an int8 conv left in the graph takes the
    exact tier's route, as JAX's."""

    def __init__(self, graph: Graph, device: torch.device | str = "cuda",
                 compute_dtype: torch.dtype = torch.float32,
                 fuse_silu: bool = True,
                 accum_dtype: Optional[torch.dtype] = None):
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be torch.float32 or "
                             f"torch.bfloat16, got {compute_dtype}")
        if accum_dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"accum_dtype must be None, torch.float32 or "
                             f"torch.bfloat16, got {accum_dtype}")
        self.compute_dtype = compute_dtype
        self.accum_dtype = accum_dtype
        super().__init__(graph, device, "full", fuse_silu=fuse_silu)


def build_executor(graph: Graph, device: torch.device | str = "cuda",
                   planned: bool = True, precision: str = "serving",
                   mode: str = "full",
                   round_mode: RoundMode = RoundMode.HALF_AWAY,
                   fuse_silu: bool = True,
                   compute_dtype: torch.dtype = torch.float32,
                   accum_dtype: Optional[torch.dtype] = None) -> Executor:
    """Return ``fn(params, inputs) -> outputs`` for ``graph`` on ``device``.
    ``precision="serving"``: the planned serving tier, or with
    ``planned=False`` the unplanned per-node lowering. ``"exact"``: the
    exact tier in ``mode`` ``"full"`` or ``"compat"``. ``"fast"``: the
    fast tier over a dequantized graph, its convs in ``compute_dtype``
    (float32 here, as the JAX ``ExecOptions``; the engine takes bf16),
    their sums in float32 or, with ``accum_dtype=torch.bfloat16``,
    rounded to bf16 before the bias (:func:`ops.reference.conv2d_f32`).
    ``round_mode`` is the requantize rule of the convs outside the serving
    tier's fused kernels."""
    if precision == "exact":
        return ExactExecutor(graph, device, mode, round_mode, fuse_silu)
    if precision == "fast":
        return FastExecutor(graph, device, compute_dtype, fuse_silu,
                            accum_dtype)
    if precision != "serving":
        raise ValueError(f"unknown precision {precision!r}")
    return Executor(graph, device, planned, round_mode)
