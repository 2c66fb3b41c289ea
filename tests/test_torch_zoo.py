"""The port's zoo (``thingino_accel_tpu_torch.models.zoo``) builds the same
YOLOv5, NanoDet and tiny three-conv graphs as the JAX package's zoo: the same nodes in the
same order and byte-identical tensors (the seeded numpy draws are the
same). The port's own copies of the `.mars` reader and the IR load the
committed models as the JAX package does, and ``graph_from_jax`` turns a
JAX package graph into the port's."""

import os

import numpy as np
import pytest

from thingino_accel_tpu.formats.mars import read_mars
from thingino_accel_tpu.ir.graph import from_mars as jax_from_mars
from thingino_accel_tpu.models import zoo as JZ
from thingino_accel_tpu_torch.ir import graph as PG
from thingino_accel_tpu_torch.models import zoo as PZ
from thingino_accel_tpu_torch.runtime.engine import load_graph

MODELS = os.path.join(os.path.dirname(__file__), "..", "models")


def _assert_same_graph(port, ref):
    """``port`` is made of the port's IR classes and equals ``ref``."""
    assert type(port) is PG.Graph
    assert all(type(n) is PG.Node for n in port.nodes)
    assert all(type(t) is PG.TensorInfo and type(t.quant) is PG.QuantInfo
               for t in port.tensors.values())
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
        assert (p.channel_scales is None) == (t.channel_scales is None)
        if t.channel_scales is not None:
            np.testing.assert_array_equal(p.channel_scales, t.channel_scales)
        assert (p.source_format is None) == (t.source_format is None)
        if t.source_format is not None:
            assert int(p.source_format) == int(t.source_format), name


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


@pytest.mark.parametrize("dtype,hw,batch", [
    ("int8", (32, 32), 1), ("float32", (160, 160), 1), ("int8", (20, 36), 3)])
def test_build_tiny_identical(dtype, hw, batch):
    port = PZ.build_tiny(PZ.ZooConfig(dtype=dtype, in_hw=hw), batch=batch,
                         in_hw=hw)
    _assert_same_graph(port, JZ.build_tiny(JZ.ZooConfig(dtype=dtype,
                                                         in_hw=hw),
                                           batch=batch, in_hw=hw))
    assert [n.op for n in port.nodes] == ["CONV2D"] * 3
    _assert_same_graph(PZ.build_tiny(), JZ.build_tiny())


def test_float_zoo_identical():
    cfg = dict(dtype="float32", in_hw=(64, 64))
    ref = JZ.build_yolov5("n", JZ.ZooConfig(**cfg))
    port = PZ.build_yolov5("n", PZ.ZooConfig(**cfg))
    for name, t in ref.tensors.items():
        if t.is_const:
            np.testing.assert_array_equal(port.tensors[name].data, t.data)


@pytest.mark.parametrize("model", ["yolov5n_cal_int8.mars", "nanodet_320.mars",
                                   "fixtures/test_conv.mars"])
def test_mars_loader_copy_identical(model):
    """The port's ``formats.mars`` and ``ir.graph`` (copies) load a
    committed model into the same graph as the JAX package's."""
    path = os.path.join(MODELS, model)
    ref = jax_from_mars(read_mars(path))
    _assert_same_graph(load_graph(path), ref)


@pytest.mark.parametrize("src", ["zoo_yolov5s", "real_yolov5n"])
def test_graph_from_jax(src):
    """``graph_from_jax`` builds the port's graph from a JAX package graph:
    new nodes and records, the same constants."""
    if src == "zoo_yolov5s":
        ref = JZ.build_yolov5("s", JZ.ZooConfig(in_hw=(64, 64)))
    else:
        ref = jax_from_mars(read_mars(os.path.join(MODELS,
                                                   "yolov5n_cal_int8.mars")))
    port = PG.graph_from_jax(ref)
    _assert_same_graph(port, ref)
    assert all(p is not n and p.attrs is not n.attrs
               for p, n in zip(port.nodes, ref.nodes))
    port.validate()
