"""Quantization-aware training on ``torch.autograd``.

Port of ``thingino_accel_tpu.training.qat``. Train float32 weights with
int8 fake quantization in the forward pass (the straight-through
estimator: forward the int8 round trip, backward the identity), then
export int8 weights and scales for the integer engine. The forward is
the exact tier's float32 graph (``Engine(float32 graph)._fn``), the same
function served for inference, now differentiated; its activations
observed by FAKE_QUANT nodes (:func:`insert_activation_fake_quant`) at
the scales ``ptq.calibrate`` chose, and its conv weights fake-quantized
(:func:`fake_quant_params`).

Layouts. The port's conv weights are OHWI (``runtime.executor.
params_from_jax``) where JAX's are HWIO; depthwise [KH, KW, C] and every
other float param (CONV1D, GRU, FC) keep JAX's layout. ``channel_axis``
is given in JAX's layout, so ``-1`` is a conv weight's output channel,
which the port holds on axis 0: :func:`fake_quant_params` maps the axis
of each conv weight, known by its role (``Executor.conv_weights``), not
by its shape. A 4-D weight's ``-1`` taken as it stands would scale each
kernel column instead.

``make_train_step`` takes a ``torch.optim`` optimizer over the params'
leaves (tensors with ``requires_grad``); a step updates them in place and
the optimizer holds its state, where JAX's step returns new params and
optax state. ``runtime.checkpoint`` saves both.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from thingino_accel_tpu_torch.ir.graph import Graph, Node, TensorInfo
from thingino_accel_tpu_torch.runtime.executor import fake_quant

# axis p of an OHWI conv weight is axis _HWIO_AXIS[p] of JAX's HWIO one
_HWIO_AXIS = (3, 0, 1, 2)

__all__ = ["fake_quant", "weight_scale", "fake_quant_params",
           "head_l2_loss", "make_train_step",
           "insert_activation_fake_quant", "export_int8"]


def weight_scale(w: torch.Tensor, axis: Optional[int] = None
                 ) -> torch.Tensor:
    """Symmetric scale absmax / 127, at least 1e-8. ``axis=None`` is per
    tensor (the reference compiler's rule for non-QDQ weights); an int
    axis of ``w``'s own layout keeps that axis and reduces the rest
    (per-output-channel scales, as ``ptq.quantize_graph`` deploys, where
    the axis is the output channel's)."""
    if axis is None:
        return torch.clamp_min(w.abs().max() / 127.0, 1e-8)
    axis = axis % w.dim()
    red = tuple(i for i in range(w.dim()) if i != axis)
    am = torch.amax(w.abs(), dim=red, keepdim=True)
    return torch.clamp_min(am / 127.0, 1e-8)


def _port_axis(name: str, v: torch.Tensor, channel_axis: Optional[int],
               conv_weights: set) -> Optional[int]:
    """``channel_axis`` (JAX's layout) as an axis of the port's ``v``."""
    if channel_axis is None or name not in conv_weights:
        return channel_axis
    return _HWIO_AXIS.index(channel_axis % 4)


def fake_quant_params(params: Dict[str, torch.Tensor], quantize: bool,
                      channel_axis: Optional[int] = None,
                      conv_weights: Iterable[str] = ()
                      ) -> Dict[str, torch.Tensor]:
    """Fake-quantize the float weights of 3 or more dimensions (conv OHWI,
    depthwise [KH, KW, C], the others as JAX's), a new dict; the rest as
    they are. ``channel_axis`` (JAX's layout, see the module docstring)
    selects per-channel scales; ``conv_weights`` names the OHWI conv
    weights (``Executor.conv_weights``), whose axis is mapped."""
    if not quantize:
        return params
    conv_weights = set(conv_weights)
    out = {}
    for k, v in params.items():
        # a zero-sized constant (a materialized dangling tensor of an
        # imported file) has no absmax
        if v.dim() >= 3 and v.numel() and v.is_floating_point():
            axis = _port_axis(k, v, channel_axis, conv_weights)
            out[k] = fake_quant(v, weight_scale(v, axis))
        else:
            out[k] = v
    return out


def head_l2_loss(outputs: Dict[str, torch.Tensor],
                 targets: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Mean squared error over the graph outputs, averaged over them
    (detection-head distillation, feature matching)."""
    loss = 0.0
    for k, v in outputs.items():
        loss = loss + torch.mean(torch.square(
            v.to(torch.float32) - targets[k].to(torch.float32)))
    return loss / max(len(outputs), 1)


def make_train_step(
    forward: Callable[[Dict[str, torch.Tensor], Dict[str, torch.Tensor]],
                      Dict[str, torch.Tensor]],
    optimizer: torch.optim.Optimizer,
    qat: bool = True,
    loss_fn: Callable = head_l2_loss,
    channel_axis: Optional[int] = None,
):
    """Build ``train_step(params, inputs, targets) -> loss``.

    ``forward`` is an engine's executor (``Engine._fn``, float32 exact
    tier); ``optimizer`` a ``torch.optim`` optimizer over the values of
    ``params``. A step computes ``loss_fn`` of the forward of the
    fake-quantized params (:func:`fake_quant_params`, per channel with
    ``channel_axis=-1``, the scheme ``ptq.quantize_graph`` deploys), runs
    backward, steps the optimizer, and returns the loss (a 0-dim tensor on
    the params' device; no host sync). The gradients stay in the params'
    ``.grad`` until the next step; a param the loss does not reach (a
    constant of a node the outputs do not need) gets a zero gradient, as
    in JAX, so that every param has optimizer state. ``train_step.loss(params, inputs,
    targets)`` is the loss alone, as JAX's inner ``loss``."""
    conv_weights = set(getattr(forward, "conv_weights", ()))

    def loss(params, inputs, targets):
        outs = forward(fake_quant_params(params, qat, channel_axis,
                                         conv_weights), inputs)
        return loss_fn(outs, targets)

    def train_step(params, inputs, targets):
        optimizer.zero_grad(set_to_none=True)
        value = loss(params, inputs, targets)
        value.backward()
        for p in params.values():
            if p.requires_grad and p.grad is None:
                # a param the loss does not reach: JAX's gradient is 0,
                # and the optimizer keeps state for it, as optax does
                p.grad = torch.zeros_like(p)
        optimizer.step()
        return value.detach()

    train_step.loss = loss
    return train_step


def insert_activation_fake_quant(graph: Graph, stats) -> Graph:
    """A new graph in which every float activation that is not a constant
    (the inputs, every layer output) passes through a FAKE_QUANT node at
    the scale calibration chose (``ptq.CalibStats``; a tensor with no
    positive scale is not observed), as JAX's pass: node ``fq_<name>``
    writes ``<name>__fq``, each consumer and graph output reads that. The
    forward then models the exact tier's activation quantization (weight
    fake quantization alone trains at the weight-noise floor) and stays
    differentiable (FAKE_QUANT's backward is the identity). Scales are
    frozen at calibration."""
    g = copy.deepcopy(graph)
    remap: Dict[str, str] = {}
    new_nodes: List[Node] = []

    def observe(name: str) -> None:
        t = g.tensors[name]
        if t.is_const or not np.issubdtype(np.dtype(t.dtype), np.floating):
            return
        s = stats.scale(name, default=0.0)
        if not s or s <= 0:
            return
        fq = f"{name}__fq"
        g.tensors[fq] = TensorInfo(name=fq, shape=t.shape, dtype=t.dtype)
        new_nodes.append(Node(op="FAKE_QUANT", inputs=[name],
                              outputs=[fq], attrs=dict(scale=float(s)),
                              name=f"fq_{name}"))
        remap[name] = fq

    for name in g.inputs:
        observe(name)
    for node in g.nodes:
        new_nodes.append(Node(
            op=node.op, inputs=[remap.get(i, i) for i in node.inputs],
            outputs=list(node.outputs), attrs=dict(node.attrs),
            name=node.name))
        for o in node.outputs:
            observe(o)
    out = Graph(nodes=new_nodes, tensors=g.tensors, inputs=list(g.inputs),
                outputs=[remap.get(o, o) for o in g.outputs],
                name=f"{g.name}_qat")
    out.validate()
    return out


def export_int8(params: Dict[str, torch.Tensor]
                ) -> Tuple[Dict[str, np.ndarray], Dict[str, float]]:
    """Trained float weights of 3 or more dimensions as int8 with
    per-tensor scales (absmax / 127, at least 1e-8), numpy, each in its
    own layout (per-tensor scales do not depend on it); the rest as numpy
    as they are."""
    out, scales = {}, {}
    for k, v in params.items():
        a = (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
             else np.asarray(v))
        if a.ndim >= 3 and np.issubdtype(a.dtype, np.floating):
            s = float(max(np.abs(a).max() / 127.0, 1e-8))
            out[k] = np.clip(np.round(a / s), -128, 127).astype(np.int8)
            scales[k] = s
        else:
            out[k] = a
    return out, scales
