"""YOLO head decode in one kernel (port of
``thingino_accel_tpu.ops.decode_kernel``).

:func:`decode_and_parse_fused` decodes every pyramid level's raw head
[B, H, W, A*(5+NC)] (int8 with its dequant scale, f32, or the fast
tier's bf16) into boxes,
conf and class in one launch of ``csrc/decode_fused.cu``, written straight
into the concatenated outputs. Its plain version is
``models.yolo.decode_and_parse``: the wrapper takes it for tensors on the
CPU, and launches the kernel (or raises) for tensors on a CUDA device.

Against the JAX ``decode_level_pallas`` (one launch per level over row
tiles): any row count is taken, so no level falls back to another decode;
a head whose channels are not A*(5+NC) raises; an f32 class row with a
NaN gives the first NaN's index, as ``jnp.argmax`` does. A bf16 head is
decoded as it is (its values made f32 exactly inside the kernel), never
cast to f32 by another pass first. The JAX package's deferred-class mode
(``TAT_DEFER_CLS``) is not ported.

What the kernel takes, checked on every device before the plain version
is chosen: 1..4 levels, 1..8 anchors a level, 1 <= NC <= 65535, heads of
one device, dtype and batch; on the card also contiguous heads. An int8
head may start at any byte (the kernel aligns the range it stages); an
f32 or bf16 head is aligned to its element, as every such tensor is.
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
MAX_CLASSES = 65535   # the kernel's int8 key packs a class index in 16 bits

# the heads' element types, by the kernel's code for them
ELEM_CODES = {torch.float32: 0, torch.int8: 1, torch.bfloat16: 2}

# Kernel launches since the last reset_launches(): int8 and f32 heads
# count under "decode_and_parse_fused", bf16 heads (the fast tier's)
# under "decode_and_parse_fused_bf16"
launches: Dict[str, int] = {"decode_and_parse_fused": 0,
                            "decode_and_parse_fused_bf16": 0}


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
    anchor) order. All heads share one device, dtype (int8, float32 or
    bfloat16) and batch; ``scales`` are the int8 heads' dequant scales
    (or any heads', multiplied in f32 before each sigmoid)."""
    anchors = np.asarray(anchors, np.float32)
    n_lv = len(feats)
    if not 1 <= n_lv <= MAX_LEVELS or anchors.ndim != 3 \
            or anchors.shape[0] < n_lv or anchors.shape[2] != 2:
        raise ValueError(f"1..{MAX_LEVELS} levels with [A, 2] anchors each, "
                         f"got {n_lv} heads, anchors {anchors.shape}")
    a = anchors.shape[1]
    if not 1 <= a <= MAX_ANCHORS:
        raise ValueError(f"1..{MAX_ANCHORS} anchors per level, got {a}")
    if not 1 <= num_classes <= MAX_CLASSES:
        raise ValueError(f"num_classes must be in 1..{MAX_CLASSES}, got "
                         f"{num_classes}")
    dev, dt = feats[0].device, feats[0].dtype
    if dt not in ELEM_CODES:
        raise TypeError(f"int8 or float32 heads (or bfloat16) expected, "
                        f"got {dt}")
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
        launches["decode_and_parse_fused_bf16" if dt == torch.bfloat16
                 else "decode_and_parse_fused"] += 1
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
        anchors.shape[1], num_classes, ELEM_CODES[feats[0].dtype],
        boxes.data_ptr(), conf.data_ptr(), cls.data_ptr(),
        torch.cuda.current_stream(boxes.device).cuda_stream),
        "tat_decode_fused")
