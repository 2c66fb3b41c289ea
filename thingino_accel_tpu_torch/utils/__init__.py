"""Utilities: timing and profiling, logging, the ``TAT_*`` registry.
JAX's ``enable_compile_cache`` has no counterpart: torch has no XLA
compile cache (ROADMAP.md "Do not port")."""

from thingino_accel_tpu_torch.utils.timing import (
    time_fn, time_fn_chained, throughput, profile_trace, compiled_stats,
)
from thingino_accel_tpu_torch.utils.logging import get_logger
from thingino_accel_tpu_torch.utils import config

__all__ = ["time_fn", "time_fn_chained", "throughput", "profile_trace",
           "compiled_stats", "get_logger", "config"]
