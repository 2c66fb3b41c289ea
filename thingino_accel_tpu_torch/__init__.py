"""thingino_accel_tpu_torch: the PyTorch + CUDA port of thingino_accel_tpu.

It imports ``torch`` and nothing of JAX or of the JAX package: it keeps
its own copies of the `.mars` reader (``formats``) and of the graph IR and
the passes it runs (``ir``). Module names mirror the JAX package's, so
each port module sits at its counterpart's path. Its entry points put
their tensors on ``"cuda"`` unless the caller asks for the CPU
(``device="cpu"``), where the kernels' plain versions run.

Ported so far: the planned int8 serving tier (``runtime``: the planner,
the planned lowering and, unplanned, the per-node one), its 1x1, KxK,
multi-part, C3-bottleneck, SPPF and depthwise kernels hand-written for
Hopper (``ops.fused_kernels``, sources in ``csrc/``); the exact tier in
full and compat mode (``Engine(EngineOptions(precision="exact"))``) with
its three conv kernels (``ops.requant_kernels``, ``ops.conv``); the YOLO
letterbox, head decode (``ops.decode_kernel``, a kernel too) and NMS
(``models.yolo``), and the zoo's YOLOv5 and NanoDet (``models.zoo``).
"""

from thingino_accel_tpu_torch.runtime.engine import Engine, EngineOptions

__all__ = ["Engine", "EngineOptions"]
