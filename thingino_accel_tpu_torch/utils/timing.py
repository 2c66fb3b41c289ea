"""Benchmark and profiling harness.

Port of ``thingino_accel_tpu.utils.timing``. CUDA work is asynchronous, so
an honest host-clock time fences the device: :func:`time_fn` and
:func:`time_fn_chained` call ``torch.cuda.synchronize`` where a call's
arguments or result hold a CUDA tensor, and nothing where they hold
only CPU tensors (the CPU runs each op to its end). The chained form
feeds each output back as the next input, so no call can be skipped or
overlapped. :func:`profile_trace` is ``torch.profiler`` with the trace
written to ``logdir``; :func:`compiled_stats` reports only what torch
counted.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Any, Callable, Iterator, Optional

import torch


def _cuda_devices(tree: Any) -> set:
    """The CUDA devices of the tensors in ``tree`` (nested dicts, lists,
    tuples)."""
    if isinstance(tree, torch.Tensor):
        return {tree.device} if tree.is_cuda else set()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return set().union(*(_cuda_devices(t) for t in tree))
    return set()


def _fence(*trees: Any) -> None:
    for dev in _cuda_devices(trees):
        torch.cuda.synchronize(dev)


def time_fn(fn: Callable, *args, iters: int = 10,
            warmup: int = 2) -> float:
    """Average seconds a call, the device fenced after the warm-up and
    after the timed loop."""
    if iters < 1:
        raise ValueError(f"iters must be >= 1 (got {iters})")
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _fence(args, out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _fence(args, out)
    return (time.perf_counter() - t0) / iters


def time_fn_chained(step: Callable[[Any], Any], x0: Any,
                    iters: int = 10, warmup: int = 1) -> float:
    """Average seconds a call where ``step: x -> x`` feeds its output back
    as its next input."""
    x = x0
    for _ in range(warmup):
        x = step(x)
    _fence(x0, x)
    t0 = time.perf_counter()
    for _ in range(iters):
        x = step(x)
    _fence(x)
    return (time.perf_counter() - t0) / iters


def throughput(batch: int, seconds_per_call: float) -> float:
    return batch / seconds_per_call if seconds_per_call > 0 else 0.0


@contextlib.contextmanager
def profile_trace(logdir: Optional[str] = None) -> Iterator[str]:
    """``torch.profiler`` over the block (the CPU, and CUDA where there is
    a device), its Chrome trace written to ``<logdir>/trace.json`` at the
    end; yields ``logdir`` (by default ``tat_profile`` in the temporary
    directory). A profiler that cannot start leaves the block unprofiled,
    as JAX's does."""
    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "tat_profile")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    try:
        prof.start()
        started = True
    except Exception:
        started = False
    try:
        yield logdir
    finally:
        if started:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.stop()
            os.makedirs(logdir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def compiled_stats(fn: Callable, *args) -> dict:
    """What torch counts of one call of ``fn(*args)``: ``"flops"``, the
    floating-point operations of the matmuls and convolutions (2 a
    multiply-add) that ``torch.utils.flop_counter.FlopCounterMode`` sees.
    Other ops count nothing there, so this is the products' work, not the
    whole call's. JAX's counterpart also gives XLA's bytes and code size;
    torch counts neither here, so neither key is given."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args)
    return {"flops": int(counter.get_total_flops())}
