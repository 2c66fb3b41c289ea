"""Chained, baseline-subtracted timing of one function applied N times,
each output feeding the next input: the port of the probes' ``measure``
(``examples/mxu_ceiling_probe.py:164-196``,
``examples/megakernel_probe.py:271-297``).

On a CUDA device the N applications are enqueued behind a device spin
(``torch.cuda._sleep``, long enough that the host has enqueued them all
before the device reaches the first), between two CUDA events; the same
with N = 0 is subtracted, so the launch and event overheads cancel. N
doubles until the difference is at least :data:`MIN_DT_MS` (100 times
the events' resolution of about 0.5 us), so even a launch-bound shape
(K = 128) is timed over a span the events resolve. On the CPU the host
clock times the same chain (the plain versions).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

MIN_DT_MS = 0.05          # 100 x the CUDA events' ~0.5 us resolution
SPIN_CYCLES_BASE = 2_000_000
SPIN_CYCLES_PER_APP = 200_000   # about 0.1 ms of spin an enqueued call
MAX_N = 1 << 14


@dataclasses.dataclass(frozen=True)
class Rate:
    """``n`` chained applications: ``base_ms`` (N = 0) and ``full_ms``
    medians, ``ms`` one application's time, ``tops`` the rate in T/s of
    ``ops`` operations an application."""

    n: int
    base_ms: float
    full_ms: float
    ms: float
    tops: float


def chain_ms(fn: Callable, x, n: int) -> float:
    """Elapsed ms of ``n`` dependent applications of ``fn`` from ``x``."""
    on_card = isinstance(x, torch.Tensor) and x.is_cuda
    if not on_card:
        t0 = time.perf_counter()
        y = x
        for _ in range(n):
            y = fn(y)
        return (time.perf_counter() - t0) * 1e3
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES_BASE + SPIN_CYCLES_PER_APP * n)
    a.record()
    y = x
    for _ in range(n):
        y = fn(y)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def rate(ops: float, n: int, base_ms: float, full_ms: float) -> Rate:
    """The rate of ``n`` applications of ``ops`` operations each, from
    the chain's and the empty chain's elapsed ms."""
    dt = max(full_ms - base_ms, 1e-9)
    return Rate(n=n, base_ms=base_ms, full_ms=full_ms, ms=dt / n,
                tops=ops * n / (dt * 1e-3) / 1e12)


def measure(fn: Callable, x, ops: float, n: int = 30, reps: int = 3,
            elapsed: Optional[Callable[[int], float]] = None) -> Rate:
    """Rate of ``fn`` (``ops`` operations a call): medians of ``reps``
    chains of ``n`` and of 0 applications, after one warm run of each;
    ``n`` doubles (up to :data:`MAX_N`) while the difference is under
    :data:`MIN_DT_MS`. ``elapsed(k)``: the clock, by default
    :func:`chain_ms` of ``fn`` from ``x``."""
    clock = elapsed or (lambda k: chain_ms(fn, x, k))

    def median(k: int) -> float:
        ts = sorted(clock(k) for _ in range(reps))
        return ts[len(ts) // 2]

    clock(0)
    while True:
        clock(n)
        base, full = median(0), median(n)
        if full - base >= MIN_DT_MS or n >= MAX_N:
            return rate(ops, n, base, full)
        n *= 2
