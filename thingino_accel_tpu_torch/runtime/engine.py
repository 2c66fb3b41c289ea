"""The inference engine: load -> prepare once -> run many.

Port of ``thingino_accel_tpu.runtime.engine`` for the serving tier. The
weights are put on the engine's ``device`` once; each run is eager
PyTorch, with every int8 conv in a hand-written kernel on a CUDA device
(``ops.fused_kernels``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from thingino_accel_tpu.formats import mars as M
from thingino_accel_tpu.ir import passes
from thingino_accel_tpu.ir.graph import Graph, from_mars
from thingino_accel_tpu_torch.models.yolo import find_detect_outputs
from thingino_accel_tpu_torch.runtime.executor import (
    _torch_dtype, build_executor, params_from_jax, prepare_params,
)


@dataclasses.dataclass
class EngineOptions:
    """``precision``: only ``"serving"`` is ported, the int8 tier whose
    convs carry their activation in the requantize epilogue
    (``ir.passes.fuse_act_into_conv``). ``"exact"`` and ``"fast"`` raise
    until their ROADMAP items land."""

    precision: str = "serving"


_QUEUED_TIERS = {
    "exact": "ROADMAP.md A.3 (exact tier)",
    "fast": "ROADMAP.md A.6 (fast tier)",
}


def load_graph(src: Union[str, bytes, M.MarsModel]) -> Graph:
    """A `.mars` file (path, bytes or parsed model) as an IR graph."""
    return from_mars(src if isinstance(src, M.MarsModel) else M.read_mars(src))


class Engine:
    """Inference engine over a :class:`Graph` on one torch device."""

    def __init__(self, graph: Graph, options: Optional[EngineOptions] = None,
                 device: Union[torch.device, str] = "cpu",
                 params: Optional[Dict[str, np.ndarray]] = None):
        """``params``: numpy params in the JAX engine's layout (its
        ``_np_params``) to use instead of the graph's own constants."""
        self.options = options or EngineOptions()
        prec = self.options.precision
        if prec in _QUEUED_TIERS:
            raise NotImplementedError(
                f"precision={prec!r} is not ported yet: {_QUEUED_TIERS[prec]}")
        if prec != "serving":
            raise ValueError(f"unknown precision {prec!r}")
        self.device = torch.device(device)
        # the JAX serving order: act fusion, BN fold, params, executor
        self.graph = passes.fold_batchnorm(passes.fuse_act_into_conv(graph))
        self._np_params = (prepare_params(self.graph) if params is None
                           else params)
        self.params = params_from_jax(self._np_params, self.device)
        self._fn = build_executor(self.graph, self.device)
        self.inference_count = 0
        self.total_inference_s = 0.0

    # -- loading ------------------------------------------------------------

    @classmethod
    def from_mars(
        cls,
        src: Union[str, bytes, M.MarsModel],
        options: Optional[EngineOptions] = None,
        device: Union[torch.device, str] = "cpu",
    ) -> "Engine":
        return cls(load_graph(src), options, device=device)

    @classmethod
    def from_yolo_mars(
        cls,
        src: Union[str, bytes, M.MarsModel],
        options: Optional[EngineOptions] = None,
        device: Union[torch.device, str] = "cpu",
    ) -> "Engine":
        """A YOLO `.mars` file rewired to its three raw detect heads
        (``models.yolo.find_detect_outputs``), dropping the file's own
        decode subgraph."""
        graph = load_graph(src)
        return cls(graph.with_outputs(find_detect_outputs(graph)), options,
                   device=device)

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
        layer-by-layer comparison against another implementation."""
        feed = self._feed(args, inputs)
        produced = list(self.graph.inputs)
        for node in self._fn.nodes:
            produced.extend(node.outputs)
        return self._fn(self.params, feed, outputs=produced)

    # -- reporting ----------------------------------------------------------

    def summary(self) -> str:
        g = self.graph
        nparams = sum(int(np.prod(v.shape)) for v in self._np_params.values())
        lines = [
            f"Engine[{self.options.precision}, {self.device}] {g.name}: "
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
