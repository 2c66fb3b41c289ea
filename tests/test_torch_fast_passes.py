"""The fast tier's graph rewrites, port vs JAX, by structure: the port's
``dequantize_graph``, ``split_concat_convs``, ``merge_sibling_convs`` and
``stem_space_to_depth`` (``thingino_accel_tpu_torch.ir.passes``) and the
fast ``Engine``'s order of them give the JAX package's nodes (op, inputs,
outputs, attrs, name), tensors (shape, dtype, scale, constants) and
params, bit for bit: no tolerance.

Graphs: the zoo yolov5n and yolov5s at 64x64, the zoo NanoDet at 64x64,
the committed real yolov5n (its three detect heads), each with
``fpn_split`` in {"", "upsample", "wide", "all"} and ``conv_merge`` off
and on, and ``quantize_outputs`` off.
"""

import os

import numpy as np
import pytest

from thingino_accel_tpu.formats.mars import read_mars
from thingino_accel_tpu.ir import passes as JP
from thingino_accel_tpu.ir.graph import from_mars as jax_from_mars
from thingino_accel_tpu.models import yolo as JY
from thingino_accel_tpu.models import zoo
from thingino_accel_tpu.runtime import Engine as JEngine
from thingino_accel_tpu.runtime import EngineOptions as JOptions
from thingino_accel_tpu_torch.ir import passes as P
from thingino_accel_tpu_torch.ir.graph import graph_from_jax
from thingino_accel_tpu_torch.runtime.engine import Engine, EngineOptions

REAL_YOLO = os.path.join(os.path.dirname(__file__), "..", "models",
                         "yolov5n_cal_int8.mars")


def _real():
    g = jax_from_mars(read_mars(REAL_YOLO))
    return g.with_outputs(JY.find_detect_outputs(g))


GRAPHS = {
    "zoo-v5n-64": lambda: zoo.build_yolov5(
        "n", zoo.ZooConfig(in_hw=(64, 64), w_scale=0.0005)),
    "zoo-v5s-64": lambda: zoo.build_yolov5(
        "s", zoo.ZooConfig(in_hw=(64, 64), w_scale=0.0005)),
    "nanodet-64": lambda: zoo.build_nanodet(zoo.ZooConfig(in_hw=(64, 64))),
    "real-v5n": _real,
}
_CACHE = {}


def _graph(name):
    """The JAX graph (built once; the fast rewrites after
    ``dequantize_graph`` never write the source graph)."""
    if name not in _CACHE:
        _CACHE[name] = GRAPHS[name]()
    return _CACHE[name]


def assert_same_graph(port, ref):
    """Nodes, tensors, inputs and outputs equal; constants bit for bit."""
    assert list(port.inputs) == list(ref.inputs)
    assert list(port.outputs) == list(ref.outputs)
    assert port.name == ref.name
    assert len(port.nodes) == len(ref.nodes)
    for pn, jn in zip(port.nodes, ref.nodes):
        assert (pn.op, pn.inputs, pn.outputs, pn.name) == (
            jn.op, list(jn.inputs), list(jn.outputs), jn.name), (pn, jn)
        assert pn.attrs == dict(jn.attrs), pn.name
    assert list(port.tensors) == list(ref.tensors)
    for name, pt in port.tensors.items():
        jt = ref.tensors[name]
        assert tuple(pt.shape) == tuple(jt.shape), name
        assert pt.dtype == jt.dtype, name
        assert pt.quant.scale == jt.quant.scale, name
        assert (pt.channel_scales is None) == (jt.channel_scales is None)
        assert (pt.data is None) == (jt.data is None), name
        if pt.data is not None:
            assert pt.data.dtype == jt.data.dtype, name
            np.testing.assert_array_equal(pt.data, jt.data, err_msg=name)


def assert_same_params(port, ref):
    assert list(port) == list(ref)
    for k in ref:
        assert port[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)


@pytest.mark.parametrize("quantize_outputs", [True, False])
@pytest.mark.parametrize("name", GRAPHS)
def test_dequantize_graph_equals_jax(name, quantize_outputs):
    """``dequantize_graph`` alone: float weights (per-channel scales on
    the real yolov5n), biases in (in x w) units, DEQUANT/QUANT edges."""
    g = _graph(name)
    ref = JP.dequantize_graph(g, quantize_outputs=quantize_outputs)
    got = P.dequantize_graph(graph_from_jax(g),
                             quantize_outputs=quantize_outputs)
    assert_same_graph(got, ref)
    assert [n.op for n in got.nodes].count("QUANT") == 3 * quantize_outputs


def test_dequantize_clones_a_shared_bias_per_conv():
    """An int32 bias shared by two convs over different inputs is
    dequantized once per conv (a ``__dqclone`` tensor), as in JAX."""
    g = zoo.build_yolov5("n", zoo.ZooConfig(in_hw=(64, 64)))
    by_shape = {}
    for n in g.nodes:
        if n.op == "CONV2D" and len(n.inputs) == 3:
            by_shape.setdefault(g.tensors[n.inputs[2]].shape, []).append(n)
    a, b = next(v for v in by_shape.values() if len(v) >= 2)[:2]
    b.inputs[2] = a.inputs[2]
    ref = JP.dequantize_graph(g)
    got = P.dequantize_graph(graph_from_jax(g))
    assert_same_graph(got, ref)
    assert sum("__dqclone" in t for t in got.tensors) == 1


@pytest.mark.parametrize("conv_merge", [False, True])
@pytest.mark.parametrize("fpn_split", ["", "upsample", "wide", "all"])
@pytest.mark.parametrize("name", GRAPHS)
def test_fast_engine_graph_and_params_equal_jax(name, fpn_split,
                                                conv_merge):
    """The fast ``Engine``'s rewritten graph (dequantize, BN fold, merge,
    split, BN fold) and its numpy params equal the JAX fast engine's."""
    g = _graph(name)
    ref = JEngine(g, JOptions(precision="fast", fpn_split=fpn_split,
                              conv_merge=conv_merge))
    got = Engine(graph_from_jax(g), EngineOptions(
        precision="fast", fpn_split=fpn_split, conv_merge=conv_merge),
        device="cpu")
    assert_same_graph(got.graph, ref.graph)
    assert_same_params(got._np_params, ref._np_params)


def test_rewrites_fire_where_jax_says():
    """The counts each pass returns equal JAX's on the zoo yolov5s (the
    graph where every mode rewrites something)."""
    g = _graph("zoo-v5s-64")
    for mode in P.SPLIT_MODES:
        jd, pd = JP.dequantize_graph(g), P.dequantize_graph(graph_from_jax(g))
        n = P.split_concat_convs(pd, mode=mode)
        assert n == JP.split_concat_convs(jd, mode=mode) and n > 0
        assert_same_graph(pd, jd)
    jd, pd = JP.dequantize_graph(g), P.dequantize_graph(graph_from_jax(g))
    n = P.merge_sibling_convs(pd)
    assert n == JP.merge_sibling_convs(jd) and n > 0
    assert_same_graph(pd, jd)


@pytest.mark.parametrize("name", GRAPHS)
def test_stem_space_to_depth_equals_jax(name):
    """The stem rewrite on fresh copies of each graph: same decision, same
    weights gathered by block, same input shape and attrs. NanoDet's 3x3
    stem is not eligible (K = 3), in both."""
    jg = GRAPHS[name]()
    pg = graph_from_jax(GRAPHS[name]())
    done = P.stem_space_to_depth(pg)
    assert done == JP.stem_space_to_depth(jg)
    assert done == (name != "nanodet-64")
    assert_same_graph(pg, jg)
