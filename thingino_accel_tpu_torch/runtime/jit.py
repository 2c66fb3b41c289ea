"""The port's ``jax.jit``: a function replayed as one CUDA graph.

``jit(fn)`` returns a callable that runs ``fn`` as JAX's jitted one would
run it: the whole call, every kernel launch and torch op of it, is one
program on the device. On a CUDA device it is a ``torch.cuda.CUDAGraph``
(not ``torch.compile``):

- The first call of each signature (the structure of the arguments, the
  shape, dtype and device of each tensor in them, any other leaf by value,
  and the TF32 switches) runs ``fn`` eagerly as a warm-up, which builds the
  kernels, their plans and cuDNN's choices, and returns its outputs.
- The second call captures ``fn`` once for that signature, on a side
  stream, in ``capture_error_mode="thread_local"`` under a lock (stage
  threads of ``parallel.pipeline`` call engines at once), into a memory
  pool the callable owns (``torch.cuda.graph_pool_handle()``, one for all
  its signatures; released when the callable is dropped), then replays it.
  Every later call of the signature replays it.
- A replay copies the tensors of the arguments into the graph's own input
  buffers, replays the graph on the caller's current stream and returns
  **fresh** tensors (copies of the graph's outputs), as ``jax.jit`` does: a
  result stays intact while later calls replay. Tensors that ``fn`` closes
  over (an engine's weights, the kernels' tables, cached constants) are
  read where they lie, as ``jax.jit`` bakes closed-over arrays in, so they
  must stay alive and keep their storage.
- The kernel wrappers count their launches in Python, and a replay runs no
  Python: the capture takes back what it counted, and each replay adds the
  captured call's counts (:func:`counters`), so a replayed call counts as
  an eager one does.
- A failed capture or replay raises. Nothing runs the call eagerly
  instead.

A call whose tensors lie on the CPU (or that has none) runs ``fn``
eagerly, every time: the CPU has no graph. A call made while the current
stream is being captured (a jitted function inside another) runs ``fn``
inline, into the outer graph, as a nested ``jax.jit`` is inlined. On CUDA
the calls run under ``torch.no_grad()``: a replay's outputs have no
autograd history (training calls the untraced body, as ``training.qat``
does).

``donate_argnums`` is JAX's argument: the caller gives up those
arguments. The graph reads its own input buffers, so a donated argument is
free once copied in; the outputs are the same either way.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

_LEAF = "tensor"
# one capture at a time in the process: the allocator routes a capturing
# stream's allocations into its pool, and captures share the device
_CAPTURE_LOCK = threading.RLock()


def counters() -> List[Dict[str, int]]:
    """The launch counters of the port's kernel wrappers, the dicts a
    replay adds its captured counts to."""
    from thingino_accel_tpu_torch.ops import conv, decode_kernel, nms_kernel
    from thingino_accel_tpu_torch.ops import fused_kernels, probe_kernels
    from thingino_accel_tpu_torch.ops import requant_kernels
    return [fused_kernels.launches, requant_kernels.launches,
            decode_kernel.launches, nms_kernel.launches,
            probe_kernels.launches, conv.counts]


def _snapshot() -> List[Dict[str, int]]:
    return [dict(c) for c in counters()]


def _flatten(obj: Any, leaves: list):
    """``obj``'s structure with its tensors appended to ``leaves``: dicts,
    lists, tuples (named too) and dataclass instances are walked, any
    other leaf is kept by value (it must be hashable)."""
    if isinstance(obj, torch.Tensor):
        leaves.append(obj)
        return _LEAF
    if isinstance(obj, dict):
        return (dict, tuple(obj), tuple(_flatten(v, leaves)
                                        for v in obj.values()))
    if isinstance(obj, (list, tuple)):
        kind = (type(obj) if hasattr(obj, "_fields")
                else list if isinstance(obj, list) else tuple)
        return (kind, None, tuple(_flatten(v, leaves) for v in obj))
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        names = tuple(f.name for f in dataclasses.fields(obj))
        return (type(obj), names, tuple(_flatten(getattr(obj, n), leaves)
                                        for n in names))
    try:
        hash(obj)
    except TypeError:
        raise TypeError(f"jit: an argument of type {type(obj).__name__} is "
                        "neither a tensor nor hashable; pass it as a "
                        "tensor or close over it") from None
    return ("static", obj, ())


def _unflatten(tree, leaves) -> Any:
    """:func:`_flatten` undone, the tensors taken from the iterator
    ``leaves`` in order."""
    if tree == _LEAF:
        return next(leaves)
    kind, names, kids = tree
    if kind == "static":
        return names
    vals = [_unflatten(k, leaves) for k in kids]
    if kind is dict:
        return dict(zip(names, vals))
    if names is not None:
        return kind(**dict(zip(names, vals)))
    if kind is tuple or kind is list:
        return kind(vals)
    return kind(*vals)   # a named tuple


def _signature(tree, leaves: Sequence[torch.Tensor]) -> tuple:
    return (tree, tuple((tuple(t.shape), t.dtype, t.device) for t in leaves),
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


@dataclasses.dataclass
class _Captured:
    """One signature's graph: its input buffers, its outputs' structure
    and tensors, and the launch counts of the captured call."""

    graph: Any
    inputs: List[torch.Tensor]
    out_tree: Any
    outputs: List[torch.Tensor]
    counts: List[Dict[str, int]]
    done: Optional[torch.cuda.Event] = None


class Jitted:
    """``fn`` replayed as a CUDA graph per signature (see the module)."""

    def __init__(self, fn: Callable, donate_argnums: Sequence[int] = ()):
        self.fn = fn
        self.donate_argnums = tuple(donate_argnums)
        self._graphs: Dict[tuple, _Captured] = {}
        self._warm: set = set()
        self._pool = None
        self._lock = threading.Lock()

    def __call__(self, *args: Any) -> Any:
        leaves: List[torch.Tensor] = []
        tree = _flatten(args, leaves)
        dev = _cuda_device(leaves)
        if dev is None:
            return self.fn(*args)
        if torch.cuda.is_current_stream_capturing():
            return self.fn(*args)
        key = _signature(tree, leaves)
        with self._lock, torch.no_grad():
            cap = self._graphs.get(key)
            if cap is None:
                if key not in self._warm:
                    out = self.fn(*args)
                    self._warm.add(key)
                    return out
                cap = self._capture(tree, leaves, dev)
                self._graphs[key] = cap
            return self._replay(cap, leaves, dev)

    @property
    def graphs(self) -> int:
        """The graphs captured so far, one a signature."""
        return len(self._graphs)

    def _capture(self, tree, leaves: List[torch.Tensor],
                 dev: torch.device) -> _Captured:
        inputs = [torch.empty(x.shape, dtype=x.dtype, device=dev)
                  for x in leaves]
        args = _unflatten(tree, iter(inputs))
        graph = torch.cuda.CUDAGraph()
        with _CAPTURE_LOCK, torch.cuda.device(dev):
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            before = _snapshot()
            side = torch.cuda.Stream(dev)
            torch.cuda.synchronize(dev)
            with torch.cuda.stream(side):
                graph.capture_begin(pool=self._pool,
                                    capture_error_mode="thread_local")
                try:
                    out = self.fn(*args)
                except BaseException:
                    try:   # leave the stream out of capture; fn's error
                        graph.capture_end()   # is the one raised
                    except Exception:
                        pass
                    raise
                graph.capture_end()
            torch.cuda.current_stream(dev).wait_stream(side)
            counts = []
            for c, b in zip(counters(), before):   # the capture ran nothing
                d = {k: c[k] - b.get(k, 0) for k in c}
                for k, n in d.items():
                    c[k] -= n
                counts.append(d)
        outputs: List[torch.Tensor] = []
        out_tree = _flatten(out, outputs)
        return _Captured(graph, inputs, out_tree, outputs, counts)

    def _replay(self, cap: _Captured, leaves: List[torch.Tensor],
                dev: torch.device) -> Any:
        stream = torch.cuda.current_stream(dev)
        if cap.done is not None:   # the last replay, on another stream?
            stream.wait_event(cap.done)
        for buf, x in zip(cap.inputs, leaves):
            buf.copy_(x)
        cap.graph.replay()
        fresh = [t.clone() for t in cap.outputs]
        cap.done = torch.cuda.Event()
        cap.done.record(stream)
        for c, d in zip(counters(), cap.counts):
            for k, n in d.items():
                c[k] += n
        return _unflatten(cap.out_tree, iter(fresh))


def _cuda_device(leaves: Sequence[torch.Tensor]) -> Optional[torch.device]:
    """The CUDA device of a call's tensors; None where none lies on one.
    Tensors on two devices raise."""
    devs = {t.device for t in leaves}
    cuda = [d for d in devs if d.type == "cuda"]
    if not cuda:
        return None
    if len(devs) > 1:
        raise ValueError(f"jit: a call's tensors lie on "
                         f"{sorted(map(str, devs))}; a graph runs on one "
                         "device")
    return cuda[0]


def jit(fn: Callable, donate_argnums: Sequence[int] = ()) -> Jitted:
    """``fn`` as JAX's ``jax.jit(fn, donate_argnums=...)``: one CUDA graph
    a signature on the card, eager on the CPU (see the module)."""
    return Jitted(fn, donate_argnums)
