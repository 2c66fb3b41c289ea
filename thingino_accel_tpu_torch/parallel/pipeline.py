"""Pipeline parallelism: stage-split a graph across devices.

Port of ``thingino_accel_tpu.parallel.pipeline``. The IR is cut into N
contiguous stages balanced by estimated FLOPs (the same stages as JAX's,
node for node), each stage an ``Engine`` on its own device, and
microbatches stream through: stage i computes microbatch m while stage
i+1 computes m-1. Each stage runs in a thread of its own, so the overlap
does not rest on asynchronous dispatch; a transfer between stages is a
copy between devices (a peer copy between two cards of one host).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from thingino_accel_tpu_torch.ir.graph import Graph, Node
from thingino_accel_tpu_torch.parallel.shard import _on
from thingino_accel_tpu_torch.runtime.executor import (
    _torch_dtype, resolve_device,
)


def _node_cost(graph: Graph, node: Node) -> float:
    """FLOP estimate for stage balancing (convs dominate)."""
    if node.op in ("CONV2D", "DEPTHWISE_CONV2D"):
        out = graph.tensors[node.outputs[0]].shape
        k = node.attrs.get("kernel", (1, 1))
        cin = graph.tensors[node.inputs[0]].shape[-1]
        groups = node.attrs.get("groups", 1)
        return 2.0 * np.prod(out) * k[0] * k[1] * cin / max(groups, 1)
    if node.op == "FC" and len(node.inputs) > 1:
        w = graph.tensors[node.inputs[1]].shape
        return 2.0 * np.prod(w)
    out_t = graph.tensors.get(node.outputs[0])
    return float(np.prod(out_t.shape)) if out_t is not None else 1.0


def split_graph(graph: Graph, n_stages: int) -> List[Graph]:
    """Cut the (topologically ordered) node list into ``n_stages``
    contiguous stages with balanced FLOPs. Tensors crossing a boundary
    become the downstream stage's inputs."""
    costs = [_node_cost(graph, n) for n in graph.nodes]
    total = sum(costs)
    target = total / n_stages
    n_stages = min(n_stages, len(graph.nodes))
    stages_nodes: List[List[Node]] = [[] for _ in range(n_stages)]
    acc, si = 0.0, 0
    for idx, (node, c) in enumerate(zip(graph.nodes, costs)):
        nodes_left = len(graph.nodes) - idx
        stages_left = n_stages - si
        if si < n_stages - 1 and stages_nodes[si] and (
                acc >= target * (si + 1) or nodes_left <= stages_left - 1):
            si += 1
        stages_nodes[si].append(node)
        acc += c

    const_names = {n for n, t in graph.tensors.items() if t.is_const}
    stages: List[Graph] = []
    for si, nodes in enumerate(stages_nodes):
        stage_produced = set()
        needed = set()
        for node in nodes:
            for i in node.inputs:
                if i in const_names:
                    continue
                if i not in stage_produced:
                    needed.add(i)
            stage_produced.update(node.outputs)
        stage_inputs = sorted(needed)
        # outputs: tensors needed by later stages or final outputs
        later_needed = set(graph.outputs)
        for later in stages_nodes[si + 1:]:
            for node in later:
                later_needed.update(node.inputs)
        stage_outputs = sorted(stage_produced & later_needed)
        tensors = {}
        for node in nodes:
            for nm in list(node.inputs) + list(node.outputs):
                tensors[nm] = graph.tensors[nm]
        for nm in stage_inputs + stage_outputs:
            tensors[nm] = graph.tensors[nm]
        g = Graph(nodes=list(nodes), tensors=tensors,
                  inputs=stage_inputs, outputs=stage_outputs,
                  name=f"{graph.name}_stage{si}")
        g.validate()
        stages.append(g)
    return stages


class PipelinedEngine:
    """Inference pipeline over explicit devices (one stage per device; a
    device may repeat), by default every CUDA device.

    Feed an iterator of microbatch dicts to :meth:`run`; results stream
    out in feed order."""

    def __init__(self, graph: Graph, devices: Optional[Sequence] = None,
                 options=None):
        from thingino_accel_tpu_torch.runtime.engine import Engine
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError("PipelinedEngine: torch finds no CUDA "
                                   "device; pass devices=[...]")
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        devices = [resolve_device(d) for d in devices]
        self.graph_outputs = list(graph.outputs)
        self.stages = split_graph(graph, len(devices))
        self.devices = devices[:len(self.stages)]
        self.engines = [Engine(g, options, device=d)
                        for g, d in zip(self.stages, self.devices)]

    def _stage_call(self, si: int, env: Dict[str, Any]) -> Dict[str, Any]:
        """Run stage ``si`` on its device: move only the stage's inputs
        there, run, wait on that device; returns the updated tensor
        environment. Split out so tests can instrument per-stage
        execution windows."""
        eng, dev = self.engines[si], self.devices[si]
        with _on(dev):
            feed = {k: torch.as_tensor(env[k]).to(
                dev, _torch_dtype(eng.graph.tensors[k].dtype))
                for k in eng.graph.inputs}
            out = eng._fn(eng.params, feed)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        new_env = dict(env)
        new_env.update(out)
        return new_env

    def run(self, microbatches: Iterable[Dict[str, Any]],
            queue_depth: int = 2) -> Iterator[Dict[str, Any]]:
        """Stream microbatches through the stages with one worker
        thread per stage (1F1B-style inference pipeline).

        Each stage runs in its own thread, connected by bounded queues
        (``queue_depth`` deep: backpressure keeps at most ``n_stages +
        queue_depth`` microbatches in flight). Results yield in feed
        order. A stage's exception surfaces in the consumer; a consumer
        that abandons the generator releases every thread."""
        import queue as _queue
        import threading

        n = len(self.engines)
        qs: List[_queue.Queue] = [
            _queue.Queue(maxsize=max(1, queue_depth)) for _ in range(n + 1)]
        stop = object()
        errors: List[BaseException] = []
        cancelled = threading.Event()

        def _put(q: _queue.Queue, item: Any) -> bool:
            """Bounded put that gives up when the run is cancelled
            (consumer abandoned the generator): otherwise a full queue
            would pin the worker thread forever."""
            while not cancelled.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except _queue.Full:
                    continue
            return False

        def worker(si: int) -> None:
            failed = False
            while True:
                try:
                    item = qs[si].get(timeout=0.2)
                except _queue.Empty:
                    if cancelled.is_set():
                        return
                    continue
                if item is stop:
                    # stop is FIFO-last, so every in-flight item has
                    # been handled (or discarded) before forwarding it
                    _put(qs[si + 1], stop)
                    return
                if failed or errors or cancelled.is_set():
                    continue                 # discard; error surfaced
                idx, env = item
                try:
                    _put(qs[si + 1], (idx, self._stage_call(si, env)))
                except BaseException as e:   # surfaced in the consumer
                    errors.append(e)
                    failed = True

        threads = [threading.Thread(target=worker, args=(si,), daemon=True)
                   for si in range(n)]
        for t in threads:
            t.start()

        def feeder() -> None:
            try:
                for idx, mb in enumerate(microbatches):
                    if errors or cancelled.is_set():
                        break
                    if not _put(qs[0], (idx, dict(mb))):
                        break
            finally:
                _put(qs[0], stop)

        feed_t = threading.Thread(target=feeder, daemon=True)
        feed_t.start()

        pending: Dict[int, Dict[str, Any]] = {}
        next_idx = 0
        try:
            while True:
                item = qs[n].get()
                if item is stop:
                    break
                idx, env = item
                pending[idx] = env
                while next_idx in pending:
                    env = pending.pop(next_idx)
                    yield {k: env[k] for k in self.graph_outputs}
                    next_idx += 1
            for t in threads:
                t.join()
            feed_t.join()
            if errors:
                raise errors[0]
            # drain any stragglers that arrived with the stop marker
            while next_idx in pending:
                env = pending.pop(next_idx)
                yield {k: env[k] for k in self.graph_outputs}
                next_idx += 1
        finally:
            # abandoned generator (early break / close): release every
            # blocked thread instead of leaking them on full queues
            cancelled.set()
