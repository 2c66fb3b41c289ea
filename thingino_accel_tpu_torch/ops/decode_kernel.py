"""YOLO head decode in one kernel (port of
``thingino_accel_tpu.ops.decode_kernel``).

:func:`decode_and_parse_fused` decodes every pyramid level's raw head
[B, H, W, A*(5+NC)] (int8 with its dequant scale, or f32) into boxes,
conf and class in one launch of ``csrc/decode_fused.cu``, written straight
into the concatenated outputs. Its plain version is
``models.yolo.decode_and_parse``: the wrapper takes it for tensors on the
CPU, and launches the kernel (or raises) for tensors on a CUDA device.

Against the JAX ``decode_level_pallas`` (one launch per level over row
tiles): any row count is taken, so no level falls back to another decode;
a head whose channels are not A*(5+NC) raises; an f32 class row with a
NaN gives the first NaN's index, as ``jnp.argmax`` does. The JAX
package's deferred-class mode (``TAT_DEFER_CLS``) is not ported.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from thingino_accel_tpu_torch.models import yolo as Y
from thingino_accel_tpu_torch.ops import cuda_build

MAX_LEVELS = 4
MAX_ANCHORS = 8

# Kernel launches since the last reset_launches()
launches: Dict[str, int] = {"decode_and_parse_fused": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def decode_and_parse_fused(
    feats: Sequence[torch.Tensor],
    anchors: np.ndarray = Y.YOLOV5_ANCHORS,
    strides: Sequence[int] = Y.YOLOV5_STRIDES,
    num_classes: int = 80,
    scales: Optional[Sequence[Optional[float]]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Raw head maps -> (boxes_xywh [B, N, 4] f32, conf [B, N] f32,
    classes [B, N] int32) in ``decode_and_parse``'s (level, gy, gx,
    anchor) order. All heads share one device, dtype (int8 or float32)
    and batch; ``scales`` are the int8 heads' dequant scales."""
    anchors = np.asarray(anchors, np.float32)
    n_lv = len(feats)
    if not 1 <= n_lv <= MAX_LEVELS or anchors.ndim != 3 \
            or anchors.shape[0] < n_lv or anchors.shape[2] != 2:
        raise ValueError(f"1..{MAX_LEVELS} levels with [A, 2] anchors each, "
                         f"got {n_lv} heads, anchors {anchors.shape}")
    a = anchors.shape[1]
    dev, dt = feats[0].device, feats[0].dtype
    if dt not in (torch.int8, torch.float32):
        raise TypeError(f"int8 or float32 heads expected, got {dt}")
    for f in feats:
        if f.dim() != 4 or f.shape[3] != a * (5 + num_classes):
            raise ValueError(f"head {tuple(f.shape)}: channels must be "
                             f"{a}*(5+{num_classes})")
        if f.device != dev or f.dtype != dt or f.shape[0] != feats[0].shape[0]:
            raise ValueError("heads differ in device, dtype or batch")
    if dev.type == "cpu":
        return Y.decode_and_parse(feats, anchors, strides, num_classes,
                                  scales)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if a > MAX_ANCHORS:
        raise ValueError(f"at most {MAX_ANCHORS} anchors per level")
    if any(not f.is_contiguous() for f in feats):
        raise ValueError("CUDA kernel operands must be contiguous")
    b = feats[0].shape[0]
    n = sum(f.shape[1] * f.shape[2] * a for f in feats)
    boxes = torch.empty((b, n, 4), dtype=torch.float32, device=dev)
    conf = torch.empty((b, n), dtype=torch.float32, device=dev)
    cls = torch.empty((b, n), dtype=torch.int32, device=dev)
    if b * n > 0:
        _launch_decode(feats, anchors[:n_lv], strides, num_classes, scales,
                       boxes, conf, cls)
        launches["decode_and_parse_fused"] += 1
    return boxes, conf, cls


def _launch_decode(feats, anchors, strides, num_classes, scales, boxes,
                   conf, cls) -> None:
    n_lv = len(feats)
    sc = [1.0 if scales is None or scales[i] is None
          else float(np.float32(scales[i])) for i in range(n_lv)]
    ptrs = ctypes.c_void_p * n_lv
    ints = ctypes.c_int * n_lv
    floats = ctypes.c_float * n_lv
    anc = np.ascontiguousarray(anchors, np.float32).ravel()
    cuda_build.check(cuda_build.load_library().tat_decode_fused(
        n_lv, ptrs(*(f.data_ptr() for f in feats)),
        ints(*(f.shape[1] for f in feats)), ints(*(f.shape[2] for f in feats)),
        floats(*(float(s) for s in strides[:n_lv])), floats(*sc),
        (ctypes.c_float * anc.size)(*anc.tolist()), feats[0].shape[0],
        anchors.shape[1], num_classes, int(feats[0].dtype == torch.int8),
        boxes.data_ptr(), conf.data_ptr(), cls.data_ptr(),
        torch.cuda.current_stream(boxes.device).cuda_stream),
        "tat_decode_fused")
