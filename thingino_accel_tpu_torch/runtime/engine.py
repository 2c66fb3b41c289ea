"""The inference engine: load -> prepare once -> run many.

Port of ``thingino_accel_tpu.runtime.engine`` for the serving and exact
tiers. The weights are put on the engine's ``device`` once, ``"cuda"``
unless the caller asks for the CPU; each run is eager PyTorch.
``precision="serving"`` plans, as the JAX package's serving tier does
(``runtime.planner``): residual adds, concats, SPPF and C3 bottlenecks
fuse into the kernels of ``ops.fused_kernels``. ``precision="exact"`` is
the parity tier, node by node, its per-tensor int8 convs in the kernels of
``ops.requant_kernels``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from thingino_accel_tpu_torch.formats import mars as M
from thingino_accel_tpu_torch.ir import passes
from thingino_accel_tpu_torch.ir.graph import Graph, from_mars
from thingino_accel_tpu_torch.models.yolo import find_detect_outputs
from thingino_accel_tpu_torch.ops.quant import RoundMode
from thingino_accel_tpu_torch.runtime.executor import (
    Executor, _torch_dtype, build_executor, params_from_jax,
    prepare_params, resolve_device,
)


@dataclasses.dataclass
class EngineOptions:
    """``precision``:

    - ``"serving"`` (the port's default; the JAX package's default is
      ``"exact"``): the planned int8 tier whose convs carry their
      activation (``ir.passes.fuse_act_into_conv``) and the planner's
      fusions in the requantize epilogue;
    - ``"exact"``: the bit-exact parity tier, ``mode`` ``"full"`` or
      ``"compat"`` (the reference runtime's observable behaviour),
      ``round_mode`` the conv requantize rule, ``fuse_silu`` the
      SIGMOID+MUL fusion (full mode only);
    - ``"fast"`` raises until ROADMAP A.6 lands.

    ``fold_bn`` folds f32 BATCHNORM into the conv before it (full mode).
    The JAX options ``nchw_io``, ``jit`` and ``donate_inputs`` are not
    ported."""

    precision: str = "serving"
    mode: str = "full"
    round_mode: RoundMode = RoundMode.HALF_AWAY
    fuse_silu: bool = True
    fold_bn: bool = True


_QUEUED_TIERS = {
    "fast": "ROADMAP.md A.6 (fast tier)",
}


def load_graph(src: Union[str, bytes, M.MarsModel]) -> Graph:
    """A `.mars` file (path, bytes or parsed model) as an IR graph."""
    return from_mars(src if isinstance(src, M.MarsModel) else M.read_mars(src))


class Engine:
    """Inference engine over a :class:`Graph` on one torch device."""

    def __init__(self, graph: Graph, options: Optional[EngineOptions] = None,
                 device: Union[torch.device, str] = "cuda",
                 params: Optional[Dict[str, np.ndarray]] = None,
                 planned: bool = True):
        """``device``: ``"cuda"`` by default, and without a CUDA device
        the engine raises; ``"cpu"`` runs the kernels' plain versions.
        ``params``: numpy params in the JAX engine's layout (its
        ``_np_params``) to use instead of the graph's own constants.
        ``planned=False`` builds the serving executor without its planner
        (the unplanned per-node lowering: the counterpart of the JAX
        engine with ``_plan_folds`` returning None); the exact tier has no
        plan."""
        self.options = opts = options or EngineOptions()
        prec = opts.precision
        if prec in _QUEUED_TIERS:
            raise NotImplementedError(
                f"precision={prec!r} is not ported yet: {_QUEUED_TIERS[prec]}")
        if prec not in ("serving", "exact"):
            raise ValueError(f"unknown precision {prec!r}")
        if opts.mode not in ("full", "compat"):
            raise ValueError(f"unknown mode {opts.mode!r}")
        if prec == "serving" and opts.mode != "full":
            raise ValueError("compat mode is the exact tier's: "
                             "EngineOptions(precision='exact', mode='compat')")
        self.device = resolve_device(device)
        # the JAX order: [act fusion (serving)], BN fold, params, executor
        if prec == "serving":
            graph = passes.fuse_act_into_conv(graph)
        if opts.fold_bn and opts.mode == "full":
            graph = passes.fold_batchnorm(graph)
        self.graph = graph
        self._np_params = (prepare_params(self.graph) if params is None
                           else params)
        self.params = params_from_jax(self._np_params, self.device)
        self.planned = planned and prec == "serving"
        self._fn = self._executor(self.graph)
        self._trace_fn: Optional[Executor] = None
        self.inference_count = 0
        self.total_inference_s = 0.0

    # -- loading ------------------------------------------------------------

    @classmethod
    def from_mars(
        cls,
        src: Union[str, bytes, M.MarsModel],
        options: Optional[EngineOptions] = None,
        device: Union[torch.device, str] = "cuda",
        planned: bool = True,
    ) -> "Engine":
        return cls(load_graph(src), options, device=device, planned=planned)

    @classmethod
    def from_yolo_mars(
        cls,
        src: Union[str, bytes, M.MarsModel],
        options: Optional[EngineOptions] = None,
        device: Union[torch.device, str] = "cuda",
        planned: bool = True,
    ) -> "Engine":
        """A YOLO `.mars` file rewired to its three raw detect heads
        (``models.yolo.find_detect_outputs``), dropping the file's own
        decode subgraph."""
        graph = load_graph(src)
        return cls(graph.with_outputs(find_detect_outputs(graph)), options,
                   device=device, planned=planned)

    def _executor(self, graph: Graph) -> Executor:
        o = self.options
        return build_executor(graph, self.device, self.planned, o.precision,
                              o.mode, o.round_mode, o.fuse_silu)

    # -- introspection ------------------------------------------------------

    @property
    def input_names(self) -> List[str]:
        return list(self.graph.inputs)

    @property
    def output_names(self) -> List[str]:
        return list(self.graph.outputs)

    # -- execution ----------------------------------------------------------

    def _feed(self, args, inputs) -> Dict[str, torch.Tensor]:
        if len(args) == 1 and isinstance(args[0], dict):
            inputs = {**args[0], **inputs}
            args = ()
        feed: Dict[str, Any] = dict(zip(self.graph.inputs, args))
        for name, arr in inputs.items():
            if name not in self.graph.tensors:
                raise KeyError(f"unknown input {name!r}")
            feed[name] = arr
        for name in self.graph.inputs:
            if name not in feed:
                raise ValueError(f"missing input {name!r}")
            want = _torch_dtype(self.graph.tensors[name].dtype)
            feed[name] = torch.as_tensor(feed[name]).to(self.device, want)
        return feed

    def run(self, *args: Any, **inputs: Any) -> Dict[str, torch.Tensor]:
        """Run inference on NHWC inputs (numpy or tensors). Positional
        args map to graph inputs in order; a single dict positional is a
        name -> array feed. Returns dict name -> NHWC tensor on the
        engine's device, finished (the device is synchronized)."""
        feed = self._feed(args, inputs)
        t0 = time.perf_counter()
        out = self._fn(self.params, feed)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.total_inference_s += time.perf_counter() - t0
        self.inference_count += 1
        return out

    def run_np(self, *args: Any, **inputs: Any) -> Dict[str, np.ndarray]:
        return {k: v.cpu().numpy() for k, v in self.run(*args, **inputs).items()}

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The single-input network on a tensor already on the device,
        asynchronous on CUDA: the serving pipeline's call."""
        return self._fn(self.params, {self.graph.inputs[0]: x})

    def trace(self, *args: Any, **inputs: Any) -> Dict[str, torch.Tensor]:
        """Run inference returning EVERY activation (name -> tensor), for
        layer-by-layer comparison against another implementation.

        As the JAX ``Engine.trace``: the executor is built again with every
        activation as an output, so no residual or bottleneck fuses (a
        fused tensor would never exist; virtual concats and SPPF still run
        fused and are materialized at the end), and on the exact tier no
        SIGMOID+MUL pair fuses."""
        feed = self._feed(args, inputs)
        if not self.planned and self.options.precision == "serving":
            produced = list(self.graph.inputs)
            for node in self._fn.nodes:
                produced.extend(node.outputs)
            return self._fn(self.params, feed, outputs=produced)
        if self._trace_fn is None:
            produced = set(self.graph.inputs)
            for node in self.graph.nodes:
                produced.update(node.outputs)
            all_acts = [n for n, t in self.graph.tensors.items()
                        if not t.is_const and n in produced]
            probe = Graph(nodes=self.graph.nodes, tensors=self.graph.tensors,
                          inputs=self.graph.inputs, outputs=all_acts,
                          name=self.graph.name)
            self._trace_fn = self._executor(probe)
        return self._trace_fn(self.params, feed)

    def capture(self, *args: Any, **inputs: Any) -> List[tuple]:
        """One planned forward that records every kernel unit as
        ``(unit, {input name: tensor}, output)``: the inputs the unit
        read and the tensor its kernel wrote. Unlike :meth:`trace` it runs
        the schedule the serving path runs, fusions included; a unit re-run
        on its recorded inputs (``unit.compute(inputs | params,
        plain=True)``) checks one kernel against its plain version."""
        if not self._fn.steps:
            raise ValueError("capture needs the planned or exact executor")
        rec: List[tuple] = []
        self._fn(self.params, self._feed(args, inputs), capture=rec)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return rec

    # -- reporting ----------------------------------------------------------

    def summary(self) -> str:
        g = self.graph
        nparams = sum(int(np.prod(v.shape)) for v in self._np_params.values())
        o = self.options
        tags = [o.precision] + (["compat"] if o.mode == "compat" else []) + (
            ["unplanned"] if o.precision == "serving" and not self.planned
            else []) + [str(self.device)]
        lines = [
            f"Engine[{', '.join(tags)}] "
            f"{g.name}: "
            f"{len(g.nodes)} nodes, {nparams} weight elems",
        ]
        for n in g.inputs:
            t = g.tensors[n]
            lines.append(f"  in  {n}: {t.shape} {t.dtype}")
        for n in g.outputs:
            t = g.tensors[n]
            lines.append(f"  out {n}: {t.shape} {t.dtype}")
        if self.inference_count:
            avg = self.total_inference_s / self.inference_count * 1e3
            lines.append(
                f"  {self.inference_count} inferences, avg {avg:.3f} ms")
        return "\n".join(lines)
