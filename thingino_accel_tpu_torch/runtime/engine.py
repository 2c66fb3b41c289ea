"""The inference engine: load -> prepare once -> run many.

Port of ``thingino_accel_tpu.runtime.engine`` for its three tiers. The
weights are put on the engine's ``device`` once, ``"cuda"`` unless the
caller asks for the CPU. With ``EngineOptions.jit`` (True, JAX's default)
:meth:`Engine.run` and :meth:`Engine.forward` go through
``runtime.jit.jit`` of the executor: on the card one CUDA graph a
signature, replayed after its first call; on the CPU each run is eager
PyTorch, as it is everywhere with ``jit=False``.
``precision="serving"`` plans, as the JAX package's serving tier does
(``runtime.planner``): residual adds, concats, SPPF and C3 bottlenecks
fuse into the kernels of ``ops.fused_kernels``. ``precision="exact"`` is
the parity tier, node by node, its per-tensor int8 convs in the kernels of
``ops.requant_kernels``. ``precision="fast"`` dequantizes the graph at
load and runs it in bf16 node by node, its convs through ``F.conv2d``
(``runtime.executor.FastExecutor``), after the JAX fast tier's rewrites.
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from thingino_accel_tpu_torch.formats import mars as M
from thingino_accel_tpu_torch.ir import passes
from thingino_accel_tpu_torch.ir.graph import Graph, from_mars
from thingino_accel_tpu_torch.models.yolo import find_detect_outputs
from thingino_accel_tpu_torch.ops.quant import RoundMode
from thingino_accel_tpu_torch.ir.graph import TensorInfo
from thingino_accel_tpu_torch.runtime.executor import (
    Executor, _torch_dtype, build_executor, prepare_params, resolve_device,
)
from thingino_accel_tpu_torch.runtime.jit import jit
from thingino_accel_tpu_torch.utils import config


@dataclasses.dataclass
class EngineOptions:
    """``precision``:

    - ``"exact"`` (the default, as in the JAX package): the bit-exact
      parity tier, ``mode`` ``"full"`` or ``"compat"`` (the reference
      runtime's observable behaviour), ``round_mode`` the conv requantize
      rule, ``fuse_silu`` the SIGMOID+MUL fusion (full mode only);
    - ``"serving"``: the planned int8 tier whose convs carry their
      activation (``ir.passes.fuse_act_into_conv``) and the planner's
      fusions in the requantize epilogue; callers name it;
    - ``"fast"``: the graph dequantized at load
      (``ir.passes.dequantize_graph``: float weights, DEQUANT/QUANT at the
      int8 edges, with ``quantize_outputs`` the heads requantized, else
      left in bf16), then BN folded, ``conv_merge``
      (``merge_sibling_convs``) and ``fpn_split``
      (``split_concat_convs``: ``""`` off, ``"wide"``, ``"all"``, any
      other true value ``"upsample"``, as in JAX), each None by default,
      which reads ``TAT_CONV_MERGE`` (off unset) / ``TAT_FPN_SPLIT``
      (``"wide"`` unset) through ``utils.config``, run in
      ``compute_dtype``, which the engine makes bfloat16 where it is
      float32, as the JAX engine does. ``accum_dtype`` is the JAX
      option's: None (the default, or float32) adds each conv's bias to
      its float32 sums and rounds once; ``torch.bfloat16`` rounds the
      sums to bf16 before the bias, the mode the JAX bench runs
      (``ops.reference.conv2d_f32``). Full mode only.

    ``fold_bn`` folds f32 BATCHNORM into the conv before it (full mode).
    ``nchw_io``: :meth:`Engine.run` takes 4-D inputs NCHW (the `.mars`
    declared layout) and returns 4-D outputs NCHW; :meth:`Engine.trace`
    takes them NCHW and returns NHWC, as JAX's. ``donate_inputs``: the
    caller gives up the tensors it feeds :meth:`Engine.run` and
    :meth:`Engine.forward`, and each graph input leaves the forward's
    tensors after its last reader, so its memory can be reused (JAX's
    ``donate_argnums``); the outputs are the same. ``jit`` (True, JAX's
    name and default): :meth:`Engine.run` and :meth:`Engine.forward`
    replay the forward as one CUDA graph a signature on the card
    (``runtime.jit``), with fresh outputs each call; ``jit=False`` runs
    every forward eagerly. :meth:`Engine.trace` and :meth:`Engine.capture`
    stay eager, and the executor (``Engine._fn``) stays the untraced body
    that pipelines, QAT and the parallel code call."""

    precision: str = "exact"
    mode: str = "full"
    round_mode: RoundMode = RoundMode.HALF_AWAY
    fuse_silu: bool = True
    fold_bn: bool = True
    quantize_outputs: bool = True
    compute_dtype: torch.dtype = torch.float32
    accum_dtype: Optional[torch.dtype] = None
    conv_merge: Optional[bool] = None
    fpn_split: Optional[str] = None
    nchw_io: bool = False
    donate_inputs: bool = False
    jit: bool = True

    def __post_init__(self) -> None:
        if self.compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be torch.float32 or "
                             f"torch.bfloat16, got {self.compute_dtype}")
        if self.accum_dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"accum_dtype must be None, torch.float32 or "
                             f"torch.bfloat16, got {self.accum_dtype}")


def _forward_of(engine: "Engine"):
    """``feed -> outputs``: ``engine._fn`` on ``engine.params``, both read
    at each call (a test may swap the executor), through a weak reference,
    so that the engine's jitted forward keeps no cycle and its graphs'
    memory goes with the engine."""
    ref = weakref.ref(engine)

    def forward(feed: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        eng = ref()
        return eng._fn(eng.params, feed, donate=eng.options.donate_inputs)
    return forward


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
        opts = options or EngineOptions()
        prec = opts.precision
        if prec not in ("serving", "exact", "fast"):
            raise ValueError(f"unknown precision {prec!r}")
        if opts.mode not in ("full", "compat"):
            raise ValueError(f"unknown mode {opts.mode!r}")
        if prec != "exact" and opts.mode != "full":
            raise ValueError("compat mode is the exact tier's: "
                             "EngineOptions(precision='exact', mode='compat')")
        self.device = resolve_device(device)
        # the JAX order: [act fusion (serving) | dequantize, BN fold, merge,
        # split (fast)], BN fold, params, executor
        if prec == "serving":
            graph = passes.fuse_act_into_conv(graph)
        elif prec == "fast":
            graph = passes.dequantize_graph(
                graph, quantize_outputs=opts.quantize_outputs)
            if opts.compute_dtype == torch.float32:
                opts = dataclasses.replace(opts, compute_dtype=torch.bfloat16)
            if opts.fold_bn:
                # before the structural rewrites, which break conv -> BN
                graph = passes.fold_batchnorm(graph)
            merge = opts.conv_merge
            if merge is None:
                merge = config.get("TAT_CONV_MERGE")
            if merge:
                passes.merge_sibling_convs(graph)
            split = opts.fpn_split
            if split is None:
                split = config.get("TAT_FPN_SPLIT")
            if split:
                passes.split_concat_convs(
                    graph, mode=(split if split in ("all", "wide")
                                 else "upsample"))
        if opts.fold_bn and opts.mode == "full":
            graph = passes.fold_batchnorm(graph)
        self.options = opts
        self.graph = graph
        self._np_params = (prepare_params(self.graph) if params is None
                           else params)
        self.planned = planned and prec == "serving"
        self._fn = self._executor(self.graph)
        self.params = self._fn.device_params(self._np_params)
        self._run = _forward_of(self)
        if opts.jit:
            self._run = jit(self._run, donate_argnums=(
                (0,) if opts.donate_inputs else ()))
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
                              o.mode, o.round_mode, o.fuse_silu,
                              o.compute_dtype, o.accum_dtype)

    # -- introspection ------------------------------------------------------

    @property
    def input_names(self) -> List[str]:
        return list(self.graph.inputs)

    @property
    def output_names(self) -> List[str]:
        return list(self.graph.outputs)

    def input_info(self, index: int = 0) -> TensorInfo:
        return self.graph.tensors[self.graph.inputs[index]]

    def output_info(self, index: int = 0) -> TensorInfo:
        return self.graph.tensors[self.graph.outputs[index]]

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
            x = torch.as_tensor(feed[name])
            if self.options.nchw_io and x.dim() == 4:
                x = x.permute(0, 2, 3, 1)
            feed[name] = x.to(self.device, want).contiguous()
        return feed

    def run(self, *args: Any, **inputs: Any) -> Dict[str, torch.Tensor]:
        """Run inference on NHWC inputs (NCHW with ``nchw_io``; numpy or
        tensors). Positional args map to graph inputs in order; a single
        dict positional is a name -> array feed. Returns dict name -> NHWC
        tensor (NCHW with ``nchw_io``) on the engine's device, finished
        (the device is synchronized)."""
        feed = self._feed(args, inputs)
        t0 = time.perf_counter()
        out = self._run(feed)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.total_inference_s += time.perf_counter() - t0
        self.inference_count += 1
        if self.options.nchw_io:
            out = {k: v.permute(0, 3, 1, 2).contiguous() if v.dim() == 4
                   else v for k, v in out.items()}
        return out

    def run_np(self, *args: Any, **inputs: Any) -> Dict[str, np.ndarray]:
        """:meth:`run` as numpy arrays; a bf16 output (numpy has no bf16)
        as float32, which holds its values exactly."""
        return {k: (v.float() if v.dtype == torch.bfloat16 else v)
                .cpu().numpy()
                for k, v in self.run(*args, **inputs).items()}

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The single-input network on an NHWC tensor already on the
        device, asynchronous on CUDA."""
        return self._run({self.graph.inputs[0]: x})

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
