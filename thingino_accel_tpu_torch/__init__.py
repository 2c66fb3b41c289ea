"""thingino_accel_tpu_torch: the PyTorch + CUDA port of thingino_accel_tpu.

It imports ``torch`` and never ``jax``. From the JAX package it reuses
only the modules that do not import jax: ``formats.mars``,
``formats.packing``, ``ir.graph`` and ``ir.passes``. Module names mirror
the JAX package's, so each port module sits at its counterpart's path.

Ported so far: the serving tier's per-node int8 path (``runtime``), with
the 1x1 and KxK convs in hand-written Hopper kernels
(``ops.fused_kernels``, sources in ``csrc/``), and the YOLO letterbox,
decode and NMS (``models.yolo``).
"""

from thingino_accel_tpu_torch.runtime.engine import Engine, EngineOptions

__all__ = ["Engine", "EngineOptions"]
