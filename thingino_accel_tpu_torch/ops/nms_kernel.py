"""The greedy NMS fixpoint as one kernel (``csrc/nms_fixpoint.cu``).

:func:`nms_fixpoint` takes ``up`` [B, K, K] bool, the strictly
upper-triangular "i suppresses j" relation of each frame's score-sorted
pool that ``models.yolo.nms_batched`` builds, and returns ``keep`` [B, K]
bool: the fixpoint of ``keep[j] = !any_i(up[i][j] & keep[i])`` from all
true, stepped until nothing changes (at most K steps), JAX's
``lax.while_loop`` (``thingino_accel_tpu/models/yolo.py:854-877``) per
frame, as under ``vmap``.

It replaces no TPU kernel: JAX's loop stays on the device inside the
jitted program, and the port's plain version (:func:`nms_fixpoint_plain`,
which the CPU keeps) reads back after every step whether anything
changed, a host sync a step, which no CUDA graph can hold. On a CUDA
tensor the wrapper launches the kernel (K <= 1024) or raises; on a CPU
tensor it takes the plain version. Both are boolean logic only, so they
agree bit for bit.
"""

from __future__ import annotations

from typing import Dict

import torch

from thingino_accel_tpu_torch.ops import cuda_build

MAX_K = 1024   # one thread a pool entry, one block a frame

# Kernel launches since the last reset_launches()
launches: Dict[str, int] = {"nms_fixpoint": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def nms_fixpoint_plain(up: torch.Tensor) -> torch.Tensor:
    """The fixpoint stepped over the whole batch until no frame changes,
    one ``torch.equal`` (a host sync on the card) a step; a frame at its
    fixpoint stays there, so this equals the per-frame loop."""
    bsz, k, _ = up.shape
    keep = torch.ones((bsz, k), dtype=torch.bool, device=up.device)
    for _ in range(k):
        new = ~torch.any(up & keep[:, :, None], dim=1)
        if torch.equal(new, keep):
            break
        keep = new
    return keep


def nms_fixpoint(up: torch.Tensor) -> torch.Tensor:
    """``up`` [B, K, K] bool -> ``keep`` [B, K] bool (see the module)."""
    if up.dtype != torch.bool or up.dim() != 3 or up.shape[1] != up.shape[2]:
        raise ValueError(f"up must be bool [B, K, K], got {up.dtype} "
                         f"{tuple(up.shape)}")
    if up.device.type == "cpu":
        return nms_fixpoint_plain(up)
    if up.device.type != "cuda":
        raise ValueError(f"unsupported device {up.device}")
    bsz, k, _ = up.shape
    if k > MAX_K:
        raise ValueError(f"the NMS kernel takes K <= {MAX_K}, got {k}")
    up = up.contiguous()
    keep = torch.empty((bsz, k), dtype=torch.bool, device=up.device)
    if bsz * k > 0:
        cuda_build.check(cuda_build.load_library().tat_nms_fixpoint(
            up.data_ptr(), keep.data_ptr(), bsz, k,
            torch.cuda.current_stream(up.device).cuda_stream),
            "tat_nms_fixpoint")
        launches["nms_fixpoint"] += 1
    return keep
