"""The port's zoo (``thingino_accel_tpu_torch.models.zoo``) builds the same
YOLOv5 and NanoDet graphs as the JAX package's zoo: the same nodes in the
same order and byte-identical tensors (the seeded numpy draws are the
same)."""

import numpy as np
import pytest

from thingino_accel_tpu.models import zoo as JZ
from thingino_accel_tpu_torch.models import zoo as PZ


def _assert_same_graph(port, ref):
    assert (port.name, port.inputs, port.outputs) == (
        ref.name, ref.inputs, ref.outputs)
    assert [(n.op, n.inputs, n.outputs, n.attrs, n.name)
            for n in port.nodes] == [(n.op, n.inputs, n.outputs, n.attrs,
                                      n.name) for n in ref.nodes]
    assert list(port.tensors) == list(ref.tensors)
    for name, t in ref.tensors.items():
        p = port.tensors[name]
        assert (p.shape, p.dtype, p.quant.scale, p.is_const) == (
            t.shape, t.dtype, t.quant.scale, t.is_const), name
        if t.is_const:
            assert p.data.tobytes() == t.data.tobytes(), name


@pytest.mark.parametrize("size,hw,seed,batch", [
    ("n", 640, 0, 1), ("s", 640, 0, 1), ("n", 64, 3, 2)])
def test_build_yolov5_identical(size, hw, seed, batch):
    _assert_same_graph(
        PZ.build_yolov5(size, PZ.ZooConfig(in_hw=(hw, hw), seed=seed),
                        batch=batch),
        JZ.build_yolov5(size, JZ.ZooConfig(in_hw=(hw, hw), seed=seed),
                        batch=batch))


@pytest.mark.parametrize("hw,batch,nc", [(64, 2, None), (320, 1, None),
                                         (64, 1, 3)])
def test_build_nanodet_identical(hw, batch, nc):
    port = PZ.build_nanodet(PZ.ZooConfig(in_hw=(hw, hw)), batch=batch,
                            num_classes=nc)
    _assert_same_graph(port, JZ.build_nanodet(JZ.ZooConfig(in_hw=(hw, hw)),
                                              batch=batch, num_classes=nc))
    assert sum(n.op == "DEPTHWISE_CONV2D" for n in port.nodes) == 10


def test_float_zoo_identical():
    cfg = dict(dtype="float32", in_hw=(64, 64))
    ref = JZ.build_yolov5("n", JZ.ZooConfig(**cfg))
    port = PZ.build_yolov5("n", PZ.ZooConfig(**cfg))
    for name, t in ref.tensors.items():
        if t.is_const:
            np.testing.assert_array_equal(port.tensors[name].data, t.data)
