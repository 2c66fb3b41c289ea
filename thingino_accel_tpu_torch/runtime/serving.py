"""Batched multi-stream serving (port of
``thingino_accel_tpu.runtime.serving``).

Each batch is copied into pinned host memory and sent to the device with
a non-blocking copy on the current CUDA stream; up to ``depth`` batches
are in flight, so the host prepares batch N+1 while the device works on
batch N. The served function is typically jitted (``runtime.jit``: an
engine's forward, a pipeline): the copy stays outside its graph, enqueued
on the current stream before the replay, and a replay returns fresh
tensors, so a batch's results stay intact while later batches replay. A failed batch yields ``None`` and counts in ``stats.errors``.
With ``timeout_s`` a drain watchdog raises :class:`InferenceTimeout` for a
batch the device does not finish in time and marks the server unhealthy.
:class:`MultiStreamBatcher` interleaves many cameras into fixed batches
and records where each row goes back to.
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import logging
import time
from typing import Any, Callable, Iterable, Iterator, List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class ServingStats:
    """Throughput/latency accounting."""

    frames: int = 0
    batches: int = 0
    errors: int = 0
    wall_s: float = 0.0
    # bounded ring (newest 4096 batches): a long-running server must not
    # grow stats memory or percentile cost without bound
    batch_latencies_s: "collections.deque" = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=4096))

    @property
    def fps(self) -> float:
        return self.frames / self.wall_s if self.wall_s else 0.0

    def latency_ms(self, pct: float = 50.0) -> float:
        if not self.batch_latencies_s:
            return 0.0
        return float(np.percentile(
            np.asarray(self.batch_latencies_s), pct) * 1e3)

    def summary(self) -> str:
        return (f"{self.frames} frames in {self.wall_s:.3f}s = "
                f"{self.fps:.1f} fps; batch latency p50 "
                f"{self.latency_ms(50):.2f} ms / p99 "
                f"{self.latency_ms(99):.2f} ms")


_FAILED = object()   # dispatch-failed batch sentinel (slot preserved)
_log = logging.getLogger(__name__)


class InferenceTimeout(RuntimeError):
    """A drained batch did not finish within ``timeout_s``: the device is
    presumed wedged and the server marks itself unhealthy
    (``StreamServer.healthy``), the role of the reference runtime's DMA
    wait timeouts."""


def _wait(done: Optional[torch.cuda.Event]) -> None:
    """Block until the batch whose work ``done`` closes has finished on
    the device (no event: a CPU batch, already finished)."""
    if done is not None:
        done.synchronize()


class StreamServer:
    """Pipelined batch server around ``fn(batch_tensor) -> result``.

    ``depth`` batches may be in flight: with depth=2 the host copies and
    enqueues batch N+1 while the device computes batch N.

    ``timeout_s``: the drain watchdog. A batch that has not finished that
    long after its drain began raises :class:`InferenceTimeout`, counts one
    error and leaves the server unhealthy; every later batch comes back as
    None. The wait runs in a worker thread, which cannot be cancelled: a
    truly wedged device keeps it, and the process is done serving
    anyway."""

    def __init__(self, fn: Callable[[torch.Tensor], Any], depth: int = 2,
                 device: torch.device | str = "cuda",
                 timeout_s: Optional[float] = None):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self.fn = fn
        self.depth = depth
        self.device = torch.device(device)
        self.timeout_s = timeout_s
        self.wedged = False
        self.stats = ServingStats()

    # the seam for the watchdog (and tests): wait for one batch's event
    _materialize = staticmethod(_wait)

    @property
    def healthy(self) -> bool:
        return not self.wedged

    def _to_device(self, batch: np.ndarray) -> torch.Tensor:
        if self.device.type != "cuda":
            return torch.as_tensor(np.asarray(batch)).to(self.device)
        # torch's pinned-host caching allocator keeps the block until the
        # non-blocking copy from it has finished
        host = torch.empty(batch.shape, dtype=torch.from_numpy(
            np.zeros(0, batch.dtype)).dtype, pin_memory=True)
        host.numpy()[...] = batch
        return host.to(self.device, non_blocking=True)

    def run(self, batches: Iterable[np.ndarray]) -> Iterator[Any]:
        """Feed batches through the pipeline, yielding results in order,
        each finished on the device (``None`` for a failed batch)."""
        inflight: collections.deque = collections.deque()
        self._t_start = time.perf_counter()
        self._wall_base = self.stats.wall_s
        for batch in batches:
            t0 = time.perf_counter()
            done = None
            try:
                out = self.fn(self._to_device(batch))
                if self.device.type == "cuda":
                    done = torch.cuda.Event()
                    done.record(torch.cuda.current_stream(self.device))
            except Exception:
                # dispatch-side failure: keep the slot so outputs stay
                # 1:1 with submitted batches, surfaced as None
                _log.exception("batch dispatch failed")
                out = _FAILED
            inflight.append((out, done, t0, len(batch)))
            if len(inflight) >= self.depth:
                yield self._drain_one(inflight)
        while inflight:
            yield self._drain_one(inflight)

    def _fail(self) -> None:
        self.stats.errors += 1
        self.stats.batches += 1

    def _drain_one(self, inflight) -> Any:
        """Wait for the oldest in-flight batch. A failed batch (bad input,
        an asynchronous device error) is counted in ``stats.errors`` and
        surfaced as None instead of ending the stream; so is every batch
        after the watchdog fired."""
        out, done, t0, n = inflight.popleft()
        if out is _FAILED or self.wedged:
            self._fail()
            return None
        try:
            if self.timeout_s is None:
                self._materialize(done)
            else:
                self._watch(done)
        except InferenceTimeout:
            raise
        except Exception:
            _log.exception("batch failed on the device")
            self._fail()
            return None
        now = time.perf_counter()
        self.stats.batch_latencies_s.append(now - t0)
        self.stats.frames += n
        self.stats.batches += 1
        self.stats.wall_s = self._wall_base + (now - self._t_start)
        return out

    def _watch(self, done) -> None:
        """:meth:`_materialize` in a worker thread, given ``timeout_s``."""
        ex = concurrent.futures.ThreadPoolExecutor(
            1, thread_name_prefix="tat-drain")
        fut = ex.submit(self._materialize, done)
        ex.shutdown(wait=False)
        try:
            fut.result(timeout=self.timeout_s)
        except concurrent.futures.TimeoutError:
            self.wedged = True
            self._fail()
            raise InferenceTimeout(
                f"batch not finished after {self.timeout_s} s; the device "
                "is presumed wedged and the server marked unhealthy"
            ) from None


class MultiStreamBatcher:
    """Interleave frames from S independent streams into fixed batches.

    Each batch's row sources go into ``self.sources``, a FIFO of one list a
    batch of ORIGINAL stream indices, -1 for a padding row: StreamServer
    yields results in submission order, so the consumer pops
    ``sources.popleft()`` for each result to route its rows back to their
    cameras, stable across stream exhaustion and pipeline depth. One
    engine serves S camera feeds."""

    def __init__(self, num_streams: int, batch: int):
        self.num_streams = num_streams
        self.batch = batch
        self.sources: collections.deque = collections.deque()

    def batches(self, streams: List[Iterator[np.ndarray]]
                ) -> Iterator[np.ndarray]:
        """Round-robin over the live streams, one frame each, until
        ``batch`` rows; an exhausted stream leaves the rotation; the last
        batch is padded with zero frames."""
        s = 0
        live = list(enumerate(streams))   # (original index, iterator)
        while live:
            rows, srcs = [], []
            while len(rows) < self.batch and live:
                idx = s % len(live)
                orig, it = live[idx]
                try:
                    rows.append(next(it))
                    srcs.append(orig)
                    s += 1
                except StopIteration:
                    live.pop(idx)
            if not rows:
                return
            while len(rows) < self.batch:   # pad the tail batch (fixed shape)
                rows.append(np.zeros_like(rows[0]))
                srcs.append(-1)
            self.sources.append(srcs)
            yield np.stack(rows)


def serve_file_model(model_path: str, batches: Iterable[np.ndarray],
                     depth: int = 2, device: torch.device | str = "cuda"
                     ) -> ServingStats:
    """Serve raw input batches through a `.mars` model (its default tier,
    the exact one, as in the JAX package) on ``device`` and return the
    throughput stats. The served call is the engine's jitted forward
    (``EngineOptions().jit``), as JAX's serves ``jax.jit`` of the body."""
    from thingino_accel_tpu_torch.runtime.engine import Engine

    eng = Engine.from_mars(model_path, device=device)
    server = StreamServer(eng.forward, depth=depth, device=eng.device)
    for _ in server.run(batches):
        pass
    return server.stats
