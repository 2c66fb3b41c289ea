"""Batched stream serving (port of ``ServingStats`` and ``StreamServer``
from ``thingino_accel_tpu.runtime.serving``).

Each batch is copied into pinned host memory and sent to the device with
a non-blocking copy on the current CUDA stream; up to ``depth`` batches
are in flight, so the host prepares batch N+1 while the device works on
batch N. A failed batch yields ``None`` and counts in ``stats.errors``.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import time
from typing import Any, Callable, Iterable, Iterator

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


class StreamServer:
    """Pipelined batch server around ``fn(batch_tensor) -> result``.

    ``depth`` batches may be in flight: with depth=2 the host copies and
    enqueues batch N+1 while the device computes batch N."""

    def __init__(self, fn: Callable[[torch.Tensor], Any], depth: int = 2,
                 device: torch.device | str = "cuda"):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self.fn = fn
        self.depth = depth
        self.device = torch.device(device)
        self.stats = ServingStats()

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
        """Wait for the oldest in-flight batch. A failed batch is counted
        in ``stats.errors`` and surfaced as None instead of ending the
        stream."""
        out, done, t0, n = inflight.popleft()
        if out is _FAILED:
            self._fail()
            return None
        if done is not None:
            try:
                done.synchronize()
            except RuntimeError:   # an asynchronous CUDA error of this batch
                _log.exception("batch failed on the device")
                self._fail()
                return None
        now = time.perf_counter()
        self.stats.batch_latencies_s.append(now - t0)
        self.stats.frames += n
        self.stats.batches += 1
        self.stats.wall_s = self._wall_base + (now - self._t_start)
        return out
