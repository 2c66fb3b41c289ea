"""thingino_accel_tpu_torch: the PyTorch + CUDA port of thingino_accel_tpu.

It imports ``torch`` and never ``jax``. From the JAX package it reuses
only the modules that do not import jax: ``formats.mars``,
``formats.packing``, ``ir.graph`` and ``ir.passes``. Module names mirror
the JAX package's, so each port module sits at its counterpart's path.

Ported so far: the planned int8 serving tier (``runtime``: the planner,
the planned lowering and, unplanned, the per-node one), its 1x1, KxK,
multi-part, C3-bottleneck, SPPF and depthwise kernels hand-written for
Hopper (``ops.fused_kernels``, sources in ``csrc/``), the YOLO letterbox,
head decode (``ops.decode_kernel``, a kernel too) and NMS
(``models.yolo``), and the zoo's YOLOv5 and NanoDet (``models.zoo``).
"""

from thingino_accel_tpu_torch.runtime.engine import Engine, EngineOptions

__all__ = ["Engine", "EngineOptions"]
