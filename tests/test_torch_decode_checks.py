"""The head decode wrapper's argument checks (``ops.decode_kernel``),
which hold on every device, before the plain version is chosen for CPU
tensors: each refusal raises with its message, and an int8 head that
starts off 16-byte alignment, which the kernel stages from the aligned
range around it, is taken."""

import numpy as np
import pytest
import torch

from thingino_accel_tpu_torch.models import yolo as Y
from thingino_accel_tpu_torch.ops import decode_kernel as DK

ANCH = np.asarray(Y.YOLOV5_ANCHORS, np.float32)


def test_decode_wrapper_checks_levels_anchors_classes_and_alignment():
    head = torch.zeros((1, 2, 2, 255), dtype=torch.int8)
    with pytest.raises(ValueError, match="1..4 levels"):
        DK.decode_and_parse_fused([head] * 5, anchors=np.ones((5, 3, 2)),
                                  strides=(8,) * 5)
    with pytest.raises(ValueError, match="1..4 levels"):
        DK.decode_and_parse_fused([], anchors=ANCH)
    with pytest.raises(ValueError, match="1..8 anchors per level, got 9"):
        DK.decode_and_parse_fused(
            [torch.zeros((1, 2, 2, 9 * 85), dtype=torch.int8)],
            anchors=np.ones((1, 9, 2)), strides=(8,))
    with pytest.raises(ValueError, match="num_classes must be in 1..65535"):
        DK.decode_and_parse_fused(
            [torch.zeros((1, 1, 1, 65541), dtype=torch.int8)],
            anchors=np.ones((1, 1, 2)), strides=(8,), num_classes=65536)
    with pytest.raises(ValueError, match="num_classes must be in 1..65535"):
        DK.decode_and_parse_fused(
            [torch.zeros((1, 2, 2, 15), dtype=torch.int8)], anchors=ANCH[:1],
            strides=(8,), num_classes=0)
    # an int8 head 5 bytes past a 16-byte boundary decodes as its copy
    rng = np.random.default_rng(3)
    vals = torch.from_numpy(rng.integers(-128, 128, (2, 3, 5, 255),
                                         dtype=np.int8))
    flat = torch.empty(vals.numel() + 32, dtype=torch.int8)
    off = (-flat.data_ptr()) % 16 + 5
    view = flat[off:off + vals.numel()].view(vals.shape)
    view.copy_(vals)
    assert view.data_ptr() % 16 == 5 and view.is_contiguous()
    got = DK.decode_and_parse_fused([view], anchors=ANCH[:1], strides=(8,),
                                    scales=[0.05])
    ref = Y.decode_and_parse([vals], ANCH[:1], (8,), 80, [0.05])
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
