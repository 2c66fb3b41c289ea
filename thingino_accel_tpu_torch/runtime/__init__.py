"""Executor, engine and stream serving."""

from thingino_accel_tpu_torch.runtime.engine import Engine, EngineOptions

__all__ = ["Engine", "EngineOptions"]
