"""IR executor: runs the graph node by node on torch tensors.

Port of the per-node logical lowering of
``thingino_accel_tpu.runtime.executor`` (``_lower_node``) for the
serving tier without its planners: every int8 CONV2D goes through the
fused dispatcher (``ops.fused_kernels.conv2d_int8_fused``) with its
activation in the kernel's epilogue; MAXPOOL, CONCAT, ADD, nearest
UPSAMPLE and RESHAPE are plain torch. The fold-layout and
epilogue-fusion planners (``_plan_folds``, ``_plan_epilogue_fusions``)
are not ported yet, so this matches the JAX serving engine built with
``_plan_folds`` disabled.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from thingino_accel_tpu.ir.graph import Graph, Node, TensorInfo
from thingino_accel_tpu.ir.passes import fuse_silu_pairs
from thingino_accel_tpu_torch.ops import fused_kernels as FK
from thingino_accel_tpu_torch.ops import reference as R

# ops this lowering takes; anything else raises, naming where it is queued
_SUPPORTED = ("CONV2D", "MAXPOOL", "CONCAT", "ADD", "UPSAMPLE", "RESHAPE")
_QUEUED = {
    "DEPTHWISE_CONV2D": "ROADMAP.md B (depthwise kernel #7)",
    "GRU": "ROADMAP.md A.8 (second modality)",
}


def _is_int8(t: TensorInfo) -> bool:
    return np.issubdtype(t.dtype, np.signedinteger) and t.dtype.itemsize == 1


def _nhwc_out_hw(t: TensorInfo) -> Tuple[int, int]:
    return t.shape[1], t.shape[2]


def _torch_dtype(dt: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dt)).dtype


def prepare_params(graph: Graph) -> Dict[str, np.ndarray]:
    """The graph's constants as numpy arrays, conv weights OIHW -> HWIO:
    the same dict as the JAX ``prepare_params`` (``Engine._np_params``)
    for the ops this lowering takes."""
    conv_weights = {n.inputs[1] for n in graph.nodes
                    if n.op == "CONV2D" and len(n.inputs) >= 2}
    params: Dict[str, np.ndarray] = {}
    for name, t in graph.tensors.items():
        if not t.is_const:
            continue
        data = t.data
        if name in conv_weights:
            data = np.ascontiguousarray(np.transpose(data, (2, 3, 1, 0)))
        params[name] = data
    return params


def params_from_jax(np_params: Dict[str, np.ndarray],
                    device: torch.device | str = "cpu"
                    ) -> Dict[str, torch.Tensor]:
    """The JAX engine's numpy params (``Engine._np_params``: HWIO int8
    conv weights, int32 biases) as the port's tensors on ``device``.

    Every 4-D int8 array is a conv weight (the JAX ``prepare_params``
    makes depthwise weights 3-D) and is repacked HWIO -> OHWI, the
    kernels' layout: each output channel's (ky, kx, c) run is contiguous,
    matching the NHWC input."""
    out: Dict[str, torch.Tensor] = {}
    for name, arr in np_params.items():
        arr = np.asarray(arr)
        if arr.ndim == 4 and arr.dtype == np.int8:
            arr = np.transpose(arr, (3, 0, 1, 2))
        out[name] = torch.from_numpy(np.array(arr, order="C")).to(device)
    return out


class Executor:
    """``executor(params, inputs) -> outputs`` over torch tensors.

    Per-conv epilogue rows (host-computed f32 scales) are built once, on
    ``device``, when the executor is built."""

    def __init__(self, graph: Graph, device: torch.device | str = "cpu"):
        self.graph = graph
        self.tensors = graph.tensors
        self.nodes: List[Node] = fuse_silu_pairs(graph)
        self.device = torch.device(device)
        self.epilogues: Dict[str, FK.Epilogue] = {}
        for node in self.nodes:
            self._check_supported(node)
            if node.op == "CONV2D" and not self._degenerate_decl(node):
                self.epilogues[node.outputs[0]] = self._conv_epilogue(node)

    # -- build time --------------------------------------------------------

    def _degenerate_decl(self, node: Node) -> bool:
        return any(0 in self.tensors[t].shape
                   for t in list(node.inputs[:1]) + list(node.outputs))

    def _check_supported(self, node: Node) -> None:
        op = node.op
        if op not in _SUPPORTED:
            where = _QUEUED.get(op, "ROADMAP.md A (modules to port)")
            raise NotImplementedError(
                f"op {op!r} is not ported to the torch executor yet: {where}")
        if op == "CONV2D" and not self._degenerate_decl(node):
            a = node.attrs
            in_t = self.tensors[node.inputs[0]]
            if not _is_int8(in_t) or len(node.inputs) < 2:
                raise NotImplementedError(
                    "float convs are the exact/fast tiers: ROADMAP.md A.3/A.6")
            if a.get("groups", 1) != 1:
                raise NotImplementedError(
                    "grouped/depthwise int8 convs: ROADMAP.md B "
                    "(depthwise kernel #7)")
            if a["dilation"] != (1, 1) or a["stride"][0] != a["stride"][1]:
                raise NotImplementedError(
                    "dilated or non-square-stride convs leave the fused "
                    "path (exact tier): ROADMAP.md A.3")
            if a.get("activation", "NONE") not in FK.ACTS:
                raise NotImplementedError(
                    f"conv activation {a.get('activation')!r} outside the "
                    "fused epilogue: ROADMAP.md A.3")
        if op == "UPSAMPLE" and node.attrs.get("mode", 0) == 1:
            raise NotImplementedError(
                "bilinear UPSAMPLE: ROADMAP.md A.2 (reference ops)")

    def _conv_epilogue(self, node: Node) -> FK.Epilogue:
        a = node.attrs
        wt = self.tensors[node.inputs[1]]
        ws = (wt.channel_scales if wt.channel_scales is not None
              else wt.quant.scale)
        return FK.epilogue_rows(
            ws, self.tensors[node.inputs[0]].quant.scale,
            self.tensors[node.outputs[0]].quant.scale,
            a.get("activation", "NONE"),
            self.tensors[node.outputs[0]].shape[3],
            alpha=a.get("alpha", 0.01) or 0.01, device=self.device)

    # -- run time ----------------------------------------------------------

    def __call__(self, params: Dict[str, torch.Tensor],
                 inputs: Dict[str, torch.Tensor],
                 outputs: Optional[List[str]] = None
                 ) -> Dict[str, torch.Tensor]:
        env: Dict[str, torch.Tensor] = dict(params)
        env.update(inputs)
        for node in self.nodes:
            self.lower_node(node, env)
        names = self.graph.outputs if outputs is None else outputs
        return {o: env[o] for o in names}

    def lower_node(self, node: Node, env: Dict[str, torch.Tensor],
                   plain: bool = False) -> None:
        """Compute ``node``'s outputs from ``env`` into ``env``.
        ``plain=True`` runs convs through the plain versions on any
        device (a check of the kernels, never the serving path)."""
        op = node.op
        a = node.attrs
        out_name = node.outputs[0]
        out_t = self.tensors[out_name]

        # Degenerate region guard: subgraphs over zero-shaped dangling
        # tensors produce zeros of their declared shape.
        degenerate = (
            any(0 in env[i].shape for i in node.inputs if i in env)
            or any(0 in self.tensors[o].shape for o in node.outputs)
            or (op == "MAXPOOL"
                and (0 in a.get("kernel", (1, 1))
                     or 0 in a.get("stride", (1, 1)))))
        if degenerate:
            for o in node.outputs:
                t = self.tensors[o]
                env[o] = torch.zeros(t.shape, dtype=_torch_dtype(t.dtype),
                                     device=self.device)
            return

        def scale(nm: str) -> float:
            return self.tensors[nm].quant.scale

        if op == "CONV2D":
            x = env[node.inputs[0]]
            bias = env[node.inputs[2]] if len(node.inputs) > 2 else None
            out_hw = _nhwc_out_hw(out_t)
            pads = R._conv_pads(
                (x.shape[1], x.shape[2]), out_hw, a["kernel"], a["stride"],
                a["dilation"], a["padding"], a["explicit_pad"])
            env[out_name] = FK.conv2d_int8_fused(
                x, env[node.inputs[1]], bias, self.epilogues[out_name],
                out_hw, a["stride"], a["dilation"], pads, plain=plain)

        elif op == "MAXPOOL":
            x = env[node.inputs[0]]
            env[out_name] = R.maxpool(
                x, a["kernel"], a["stride"], _nhwc_out_hw(out_t),
                _pool_pads(a, (x.shape[1], x.shape[2])))

        elif op == "CONCAT":
            xs = [env[i] for i in node.inputs]
            axis = int(a.get("axis", 3))
            # .mars graphs express concat on NCHW axis 1 == NHWC axis 3,
            # and some files carry garbage axis values: infer the axis
            # from the declared shapes where they identify it.
            rank = xs[0].ndim
            if all(x.ndim == rank for x in xs):
                cands = []
                for ax in range(rank):
                    tot = sum(x.shape[ax] for x in xs)
                    others = all(
                        all(x.shape[d] == xs[0].shape[d] for x in xs)
                        for d in range(rank) if d != ax)
                    if others and len(out_t.shape) == rank \
                            and out_t.shape[ax] in (tot, 0) and tot > 0:
                        cands.append(ax)
                if len(cands) == 1:
                    axis = cands[0]
                elif axis == 1 and rank == 4:
                    axis = 3
            env[out_name] = R.concat(xs, axis)

        elif op == "ADD":
            env[out_name] = R.add_q(
                env[node.inputs[0]], env[node.inputs[1]],
                scale(node.inputs[0]), scale(node.inputs[1]),
                scale(out_name))

        elif op == "UPSAMPLE":
            x = env[node.inputs[0]]
            out_hw = _nhwc_out_hw(out_t)
            sc = a.get("scale", (0, 0))
            if sc[0] <= 0 or sc[1] <= 0:   # corrupt/partial descriptor
                sc = (out_hw[0] // x.shape[1], out_hw[1] // x.shape[2])
            env[out_name] = R.upsample_nearest(x, sc, out_hw)

        elif op == "RESHAPE":
            x = env[node.inputs[0]]
            target = list(out_t.shape)
            if target and target[0] == 1 and x.shape[0] != 1:
                target[0] = x.shape[0]
            numel_t = int(np.prod(target)) if target else 0
            if numel_t == x.numel():
                env[out_name] = x.reshape(target)
            else:
                env[out_name] = x   # shape metadata inconsistent -> identity


def _pool_pads(a, in_hw=None) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    ep = a.get("explicit_pad", (0, 0, 0, 0))
    if a.get("padding") == "EXPLICIT":
        return (ep[0], ep[1]), (ep[2], ep[3])
    if a.get("padding") == "SAME" and in_hw is not None:
        kh, kw = a.get("kernel", (1, 1))
        sh, sw = a.get("stride", (1, 1))
        ph = max(0, (-(-in_hw[0] // sh) - 1) * sh + kh - in_hw[0])
        pw = max(0, (-(-in_hw[1] // sw) - 1) * sw + kw - in_hw[1])
        return (ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2)
    return (0, 0), (0, 0)


def build_executor(graph: Graph,
                   device: torch.device | str = "cpu") -> Executor:
    """Return ``fn(params, inputs) -> outputs`` for ``graph`` on ``device``."""
    return Executor(graph, device)
