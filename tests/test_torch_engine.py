"""Port engine vs the JAX serving engine without its planners.

The port lowers node by node (``thingino_accel_tpu_torch.runtime``); its
JAX oracle is ``Engine(precision="serving")`` built while
``runtime.executor._plan_folds`` returns None, which disables the fold
layouts and the epilogue fusions, with the Pallas kernels in interpret
mode.

Tolerances: bit-exact on linear/RELU graphs. On SiLU graphs each node is
checked teacher-forced (the port lowers it from the JAX inputs): non-SiLU
nodes bit-exact, SiLU convs within 1 quantum on at most 0.1% of the
elements (XLA's and torch's sigmoid differ by ulps).
"""

import collections
import os

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from thingino_accel_tpu.ir.graph import Graph, Node
from thingino_accel_tpu.models import zoo
from thingino_accel_tpu.runtime import Engine as JEngine
from thingino_accel_tpu.runtime import EngineOptions as JOptions
from thingino_accel_tpu.runtime import executor as JEX
from thingino_accel_tpu_torch.models.yolo import find_detect_outputs
from thingino_accel_tpu_torch.runtime.engine import (
    Engine, EngineOptions, load_graph,
)
from thingino_accel_tpu_torch.runtime.executor import params_from_jax

REPO = os.path.join(os.path.dirname(__file__), "..")
FIXTURES = os.path.join(REPO, "models", "fixtures")
REAL_YOLO = os.path.join(REPO, "models", "yolov5n_cal_int8.mars")


@pytest.fixture(autouse=True)
def _interpret_mode():
    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.fixture
def unplanned(monkeypatch):
    monkeypatch.setattr(JEX, "_plan_folds", lambda *a, **k: None)


def _jax_serving(graph):
    return JEngine(graph, JOptions(precision="serving"))


def _relu_copy(g: Graph) -> Graph:
    nodes = [Node(op=n.op, inputs=list(n.inputs), outputs=list(n.outputs),
                  attrs=(dict(n.attrs, activation="RELU")
                         if n.op == "CONV2D" else dict(n.attrs)),
                  name=n.name) for n in g.nodes]
    return Graph(nodes=nodes, tensors=g.tensors, inputs=list(g.inputs),
                 outputs=list(g.outputs), name=g.name)


def _yolov5n_64():
    return zoo.build_yolov5("n", zoo.ZooConfig(in_hw=(64, 64)))


def _input(graph, batch=2, seed=0):
    t = graph.tensors[graph.inputs[0]]
    return np.random.default_rng(seed).integers(
        -128, 128, (batch,) + tuple(t.shape[1:]), dtype=np.int8)


def _assert_outputs_equal(port, ref):
    assert set(port) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)


@pytest.mark.parametrize("fixture", ["test_conv.mars", "tiny_160_int8.mars"])
def test_fixture_bit_exact(unplanned, fixture):
    g = load_graph(os.path.join(FIXTURES, fixture))
    x = _input(g)
    ref = _jax_serving(g).run_np(x)
    _assert_outputs_equal(Engine(g).run_np(x), ref)


def test_relu_yolov5n_bit_exact(unplanned):
    g = _relu_copy(_yolov5n_64())
    x = _input(g)
    ref = _jax_serving(g).run_np(x)
    _assert_outputs_equal(Engine(g).run_np(x), ref)


def test_params_from_jax_identical(unplanned):
    g = _relu_copy(_yolov5n_64())
    x = _input(g, seed=1)
    jeng = _jax_serving(g)
    from_jax = Engine(g, params=jeng._np_params)
    assert set(from_jax.params) == set(jeng._np_params)
    for k, v in params_from_jax(jeng._np_params).items():
        assert v.dtype == torch.from_numpy(np.asarray(jeng._np_params[k])
                                           ).dtype
    out = from_jax.run_np(x)
    _assert_outputs_equal(out, Engine(g).run_np(x))
    _assert_outputs_equal(out, jeng.run_np(x))


def test_silu_yolov5n_teacher_forced(unplanned):
    g = _yolov5n_64()
    x = _input(g, batch=2, seed=2)
    jacts = _jax_serving(g).trace(x)
    eng = Engine(g)
    silu_convs = 0
    for node in eng._fn.nodes:
        env = dict(eng.params)
        for i in node.inputs:
            if i in jacts:
                env[i] = torch.from_numpy(np.array(jacts[i]))
        eng._fn.lower_node(node, env)
        for o in node.outputs:
            port, ref = env[o].numpy(), jacts[o]
            assert port.shape == ref.shape and port.dtype == ref.dtype, o
            if node.op == "CONV2D" and node.attrs["activation"] == "SILU":
                silu_convs += 1
                d = np.abs(port.astype(np.int32) - ref.astype(np.int32))
                assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (
                    o, d.max(), (d > 0).mean())
            else:
                np.testing.assert_array_equal(port, ref, err_msg=o)
    assert silu_convs == 57


def test_real_yolov5n_loads_with_slice_census():
    """Only the cheap part on CPU: the real-weight graph rewired to its
    detect heads builds an engine whose ops are the slice's."""
    g = load_graph(REAL_YOLO)
    heads = find_detect_outputs(g)
    assert len(heads) == 3
    eng = Engine(g.with_outputs(heads))
    ops = collections.Counter(n.op for n in eng._fn.nodes)
    assert ops == {"CONV2D": 60, "CONCAT": 13, "ADD": 7, "MAXPOOL": 3,
                   "UPSAMPLE": 2}
    convs = [n for n in eng._fn.nodes if n.op == "CONV2D"]
    kinds = collections.Counter(
        (n.attrs["activation"], n.attrs["kernel"], n.attrs["stride"])
        for n in convs)
    assert kinds == {("SILU", (1, 1), (1, 1)): 39,
                     ("NONE", (1, 1), (1, 1)): 3,
                     ("SILU", (3, 3), (1, 1)): 11,
                     ("SILU", (3, 3), (2, 2)): 6,
                     ("SILU", (6, 6), (2, 2)): 1}
    assert all(g.tensors[n.inputs[1]].channel_scales is not None
               for n in convs)
    assert [eng.graph.tensors[h].shape for h in eng.output_names] == [
        (1, 80, 80, 255), (1, 40, 40, 255), (1, 20, 20, 255)]


def test_unported_tiers_and_ops_raise():
    g = load_graph(os.path.join(FIXTURES, "test_conv.mars"))
    for prec in ("exact", "fast"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Engine(g, EngineOptions(precision=prec))
    full = load_graph(REAL_YOLO)   # still carries its decode subgraph
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Engine(full)
