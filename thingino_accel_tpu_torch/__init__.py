"""thingino_accel_tpu_torch: the PyTorch + CUDA port of thingino_accel_tpu.

It imports ``torch`` and nothing of JAX or of the JAX package: it keeps
its own copies of the `.mars` reader (``formats``) and of the graph IR and
the passes it runs (``ir``). Module names mirror the JAX package's, so
each port module sits at its counterpart's path. Its entry points put
their tensors on ``"cuda"`` unless the caller asks for the CPU
(``device="cpu"``), where the kernels' plain versions run.

Ported so far: the exact tier in full and compat mode, ``Engine``'s
default as in the JAX package, with its three conv kernels
(``ops.requant_kernels``, ``ops.conv``); the planned int8 serving tier
(``EngineOptions(precision="serving")``; ``runtime``: the planner, the
planned lowering and, unplanned, the per-node one), its 1x1, KxK,
multi-part, C3-bottleneck, SPPF and depthwise kernels hand-written for
Hopper (``ops.fused_kernels``, sources in ``csrc/``); the YOLO letterbox,
head decode (``ops.decode_kernel``, a kernel too) and NMS
(``models.yolo``), the zoo's YOLOv5 and NanoDet (``models.zoo``); and the
TPU probes under ``examples/`` (``probes``: E1, E3, E4) with their
tensor-core kernels (``ops.probe_kernels``); the fast tier, the camera
streams and the model compiler's formats; and the OEM-model path: the
`.mgk` decompiler (``formats.mgk``, ``formats.mgk_yolo``), post-training
quantization (``training.ptq``), the C-API-shaped shim (``api``) and its
image pipes (``ops.image``); and the last two model families: the AEC
audio modality (``models.audio``, ``models.aec``: the STFT front end, the
GRU U-Net, decompiled-`.mgk` streams, many streams at once) and the JZDL
person detector (``formats.jzdl``, ``models.persondet``); the serving
and fast tiers' ``TAT_*`` modes (``utils.config``: the Pade SiLU epilogue,
bf16 tensor-core products in the serving kernels, the stem stage without
growth, the tanh-form float SiLU).
"""

from thingino_accel_tpu_torch.runtime.engine import Engine, EngineOptions
from thingino_accel_tpu_torch.version import __version__

__all__ = ["Engine", "EngineOptions", "__version__"]
