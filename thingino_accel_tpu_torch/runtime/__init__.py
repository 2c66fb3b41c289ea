"""Executor, engine and stream serving."""

from thingino_accel_tpu_torch.runtime.engine import Engine, EngineOptions
from thingino_accel_tpu_torch.runtime.serving import (
    InferenceTimeout, MultiStreamBatcher, StreamServer)

__all__ = ["Engine", "EngineOptions", "InferenceTimeout",
           "MultiStreamBatcher", "StreamServer"]
