"""Port engine vs the JAX serving engine, without and with its planners.

Unplanned: the port's per-node lowering (``Engine(..., planned=False)``)
against ``Engine(precision="serving")`` of the JAX package built while
``runtime.executor._plan_folds`` returns None, which disables the fold
layouts and the epilogue fusions. Planned: the port's default engine
against the JAX serving engine as it is. The Pallas kernels run in
interpret mode.

The JAX engines take the JAX package's graphs; the port's engines take
the same graphs converted by ``ir.graph.graph_from_jax``, or built by the
port's own zoo, and run on the CPU (``device="cpu"``).

Tolerances: bit-exact on linear/RELU graphs. On SiLU graphs each node is
checked teacher-forced (the port lowers it from the JAX inputs): non-SiLU
nodes bit-exact, SiLU convs within 1 quantum on at most 0.1% of the
elements (XLA's and torch's sigmoid differ by ulps).
"""

import collections
import dataclasses
import os

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from thingino_accel_tpu.formats.mars import read_mars
from thingino_accel_tpu.ir.graph import Graph
from thingino_accel_tpu.ir.graph import Node as JNode
from thingino_accel_tpu.ir.graph import from_mars as jax_from_mars
from thingino_accel_tpu.models import zoo
from thingino_accel_tpu.runtime import Engine as JEngine
from thingino_accel_tpu.runtime import EngineOptions as JOptions
from thingino_accel_tpu.runtime import executor as JEX
from thingino_accel_tpu_torch.ir.graph import Node, graph_from_jax
from thingino_accel_tpu_torch.models import zoo as PZ
from thingino_accel_tpu_torch.models.yolo import find_detect_outputs
from thingino_accel_tpu_torch.runtime.engine import (
    Engine, EngineOptions, load_graph,
)
from thingino_accel_tpu_torch.runtime.executor import params_from_jax

REPO = os.path.join(os.path.dirname(__file__), "..")
FIXTURES = os.path.join(REPO, "models", "fixtures")
REAL_YOLO = os.path.join(REPO, "models", "yolov5n_cal_int8.mars")
NANODET = os.path.join(REPO, "models", "nanodet_320.mars")


@pytest.fixture(autouse=True)
def _interpret_mode():
    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.fixture
def unplanned(monkeypatch):
    monkeypatch.setattr(JEX, "_plan_folds", lambda *a, **k: None)


def _jax_serving(graph):
    return JEngine(graph, JOptions(precision="serving"))


def _jax_load(path):
    return jax_from_mars(read_mars(path))


SERVING = EngineOptions(precision="serving")


def _port(graph, **kw):
    """The port's serving engine on the CPU over a JAX package graph."""
    return Engine(graph_from_jax(graph), SERVING, device="cpu", **kw)


def _relu_copy(g: Graph) -> Graph:
    nodes = [JNode(op=n.op, inputs=list(n.inputs), outputs=list(n.outputs),
                   attrs=(dict(n.attrs, activation="RELU")
                          if n.op == "CONV2D" else dict(n.attrs)),
                   name=n.name) for n in g.nodes]
    return Graph(nodes=nodes, tensors=g.tensors, inputs=list(g.inputs),
                 outputs=list(g.outputs), name=g.name)


def _scaled_copy(g: Graph, seed: int) -> Graph:
    """``g`` with every activation's scale drawn anew, so the inputs of a
    concat differ in scale as on real weights: the multi-part matmul takes
    its per-part f32 branch and SPPF does not fuse."""
    rng = np.random.default_rng(seed)
    tensors = {
        k: (dataclasses.replace(t, quant=dataclasses.replace(
            t.quant, scale=float(rng.uniform(0.03, 0.07))))
            if not t.is_const and t.quant is not None else t)
        for k, t in g.tensors.items()}
    return Graph(nodes=list(g.nodes), tensors=tensors, inputs=list(g.inputs),
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
    g = _jax_load(os.path.join(FIXTURES, fixture))
    x = _input(g)
    ref = _jax_serving(g).run_np(x)
    _assert_outputs_equal(_port(g, planned=False).run_np(x), ref)


def test_relu_yolov5n_bit_exact(unplanned):
    g = _relu_copy(_yolov5n_64())
    x = _input(g)
    ref = _jax_serving(g).run_np(x)
    _assert_outputs_equal(_port(g, planned=False).run_np(x), ref)


def test_params_from_jax_identical(unplanned):
    g = _relu_copy(_yolov5n_64())
    x = _input(g, seed=1)
    jeng = _jax_serving(g)
    from_jax = _port(g, params=jeng._np_params, planned=False)
    assert set(from_jax.params) == set(jeng._np_params)
    for k, v in params_from_jax(jeng._np_params, "cpu").items():
        assert v.dtype == torch.from_numpy(np.asarray(jeng._np_params[k])
                                           ).dtype
    out = from_jax.run_np(x)
    _assert_outputs_equal(out, _port(g, planned=False).run_np(x))
    _assert_outputs_equal(out, jeng.run_np(x))


def test_silu_yolov5n_teacher_forced(unplanned):
    g = _yolov5n_64()
    x = _input(g, batch=2, seed=2)
    jacts = _jax_serving(g).trace(x)
    eng = _port(g, planned=False)
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
    eng = Engine(g.with_outputs(heads), SERVING, device="cpu")
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
    """Every tier is ported (the fast tier since it took the fixture's
    conv); ops no tier takes yet raise, naming their ROADMAP item, in the
    serving and the fast tier."""
    g = load_graph(os.path.join(FIXTURES, "test_conv.mars"))
    out = Engine(g, EngineOptions(precision="fast"), device="cpu").run_np(
        np.zeros((1, 64, 64, 3), np.int8))["output__q"]
    assert out.shape == (1, 64, 64, 16) and out.dtype == np.int8
    with pytest.raises(ValueError, match="unknown precision"):
        Engine(g, EngineOptions(precision="int4"), device="cpu")
    full = load_graph(REAL_YOLO)   # still carries its decode subgraph
    for prec in ("serving", "fast"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Engine(full, EngineOptions(precision=prec), device="cpu")


# ---------------------------------------------------------------------------
# The planned serving tier vs the planned JAX serving engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scales", ["zoo", "seeded"])
def test_planned_relu_yolov5n_bit_exact(scales):
    """RELU copy of zoo yolov5n at 64, batch 2: the zoo's equal scales run
    SPPF and the int32 branch of the multi-part matmul; a seeded copy with
    different scales runs its f32 branch and no SPPF, as the real weights
    do."""
    g = _relu_copy(_yolov5n_64())
    if scales == "seeded":
        g = _scaled_copy(g, 5)
    x = _input(g, seed=4)
    ref = _jax_serving(g).run_np(x)
    eng = _port(g)
    units = eng._fn.units
    kinds = collections.Counter(u.kind for u in units)
    multis = [u.me.same_scale for u in units if u.kind == "multi"]
    if scales == "zoo":
        assert kinds["sppf"] == 1 and all(multis) and len(multis) == 14
    else:
        assert kinds["sppf"] == 0 and not any(multis) and len(multis) == 15
    assert kinds["bneck"] == 10
    _assert_outputs_equal(eng.run_np(x), ref)
    if scales == "seeded":   # here the plan changes the heads
        unplanned = _port(g, planned=False).run_np(x)
        assert any(not np.array_equal(unplanned[k], ref[k]) for k in ref)


def test_trace_matches_jax_trace():
    """``trace`` re-plans with every activation an output, as the JAX
    ``Engine.trace`` does: no residual or bottleneck fuses; virtual concats
    and SPPF still run fused, and every activation is materialized."""
    g = _relu_copy(_yolov5n_64())
    x = _input(g, batch=1, seed=6)
    ref = _jax_serving(g).trace(x)
    eng = _port(g)
    acts = eng.trace(x)
    units = eng._trace_fn.units
    assert not any(u.kind == "bneck" or u.residual for u in units)
    assert any(u.kind == "sppf" for u in units)
    assert set(acts) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(acts[k].numpy(), ref[k], err_msg=k)


def test_capture_records_every_unit():
    """``capture`` lists each kernel unit of a planned forward with the
    inputs it read and the output it wrote; re-run on those inputs, each
    unit gives its output again."""
    g = _yolov5n_64()
    eng = _port(g)
    rec = eng.capture(_input(g, batch=1, seed=8))
    assert [u for u, _, _ in rec] == eng._fn.units
    for unit, reads, out in rec:
        env = dict(eng.params)
        env.update(reads)
        np.testing.assert_array_equal(unit.compute(env, plain=True).numpy(),
                                      out.numpy(), err_msg=repr(unit))


# ---------------------------------------------------------------------------
# NanoDet: depthwise convs (kernel #7 at stride 1, the plain op at stride 2)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def nanodet_jax():
    """The committed full-width NanoDet-320 through the JAX planned serving
    engine at batch 1 (its Pallas kernels in interpret mode)."""
    g = _jax_load(NANODET)
    x = np.random.default_rng(10).integers(-128, 128, (1, 320, 320, 3),
                                           dtype=np.int8)
    with pltpu.force_tpu_interpret_mode():
        jeng = _jax_serving(g)
        return g, x, jeng, jeng.run_np(x)


def test_nanodet_320_heads_bit_exact(nanodet_jax):
    """27 convs (10 depthwise), LEAKY_RELU, per-channel weight scales:
    the port's planned heads equal the JAX serving engine's bit for bit."""
    g, x, _, ref = nanodet_jax
    eng = Engine.from_mars(NANODET, SERVING, device="cpu")
    ops = collections.Counter(n.op for n in eng._fn.nodes)
    assert ops == {"CONV2D": 17, "DEPTHWISE_CONV2D": 10, "UPSAMPLE": 2,
                   "ADD": 2}
    out = eng.run_np(x)
    _assert_outputs_equal(out, ref)
    assert [out[k].shape for k in eng.output_names] == [
        (1, 40, 40, 84), (1, 20, 20, 84), (1, 10, 10, 84)]
    assert all(len(np.unique(v)) > 10 for v in out.values())


def test_nanodet_depthwise_params_equal_jax(nanodet_jax):
    """``prepare_params`` makes each depthwise weight [KH, KW, C], as the
    JAX engine's ``_np_params`` holds it; ``params_from_jax`` leaves those
    3-D weights alone, and an engine on the JAX params gives the same
    heads."""
    g, x, jeng, ref = nanodet_jax
    port = _port(g)
    dw = [n.inputs[1] for n in port._fn.nodes if n.op == "DEPTHWISE_CONV2D"]
    assert len(dw) == 10
    for k in dw:
        c = port.graph.tensors[k].shape[0]
        assert port._np_params[k].shape == (3, 3, c)
        np.testing.assert_array_equal(port._np_params[k], jeng._np_params[k])
        np.testing.assert_array_equal(
            params_from_jax({k: jeng._np_params[k]}, "cpu")[k].numpy(),
            jeng._np_params[k])
    assert set(port._np_params) == set(jeng._np_params)
    for k, v in jeng._np_params.items():
        np.testing.assert_array_equal(port._np_params[k], v, err_msg=k)
    _assert_outputs_equal(_port(g, params=jeng._np_params).run_np(x), ref)


def test_zoo_nanodet_heads_bit_exact():
    """Zoo nanodet at 64, batch 2, built by the port's zoo (the same graph
    as the JAX zoo's): planned and unplanned heads equal the JAX serving
    engine's, planned and unplanned."""
    g = PZ.build_nanodet(PZ.ZooConfig(in_hw=(64, 64)), batch=2)
    jg = zoo.build_nanodet(zoo.ZooConfig(in_hw=(64, 64)), batch=2)
    x = _input(g, seed=11)
    ref = _jax_serving(jg).run_np(x)
    _assert_outputs_equal(Engine(g, SERVING, device="cpu").run_np(x), ref)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JEX, "_plan_folds", lambda *a, **k: None)
        ref_u = _jax_serving(jg).run_np(x)
    _assert_outputs_equal(Engine(g, SERVING, device="cpu", planned=False).run_np(x),
                          ref_u)


def _dw_graph(stride, act, op="DEPTHWISE_CONV2D"):
    """One int8 depthwise conv, 3x3 over 8 channels, built by the port's
    zoo builder (the JAX engine reads its graph by attribute)."""
    b = PZ.GraphBuilder("dw", PZ.ZooConfig(in_hw=(9, 9)))
    x = b.input("x", (1, 9, 9, 8))
    y = b.conv(x, 8, 3, stride, act=act, groups=8)
    g = b.finish([y])
    if op != "DEPTHWISE_CONV2D":
        g.nodes[0] = Node(op=op, inputs=g.nodes[0].inputs,
                          outputs=g.nodes[0].outputs, attrs=g.nodes[0].attrs,
                          name=g.nodes[0].name)
    return g


@pytest.mark.parametrize("stride,act,op", [
    (1, "RELU", "DEPTHWISE_CONV2D"), (2, "RELU", "DEPTHWISE_CONV2D"),
    (1, "LEAKY_RELU", "CONV2D"), (2, "NONE", "CONV2D")])
def test_single_depthwise_bit_exact(stride, act, op):
    """A depthwise conv as DEPTHWISE_CONV2D or as a CONV2D with one group
    per channel, at stride 1 (kernel #7) and 2 (plain op), planned and
    unplanned."""
    g = _dw_graph(stride, act, op)
    x = _input(g, seed=stride)
    ref = _jax_serving(g).run_np(x)
    eng = Engine(g, SERVING, device="cpu")
    assert eng._fn.launch_census()["depthwise_conv2d_int8_fused"] == (
        stride == 1)
    _assert_outputs_equal(eng.run_np(x), ref)
    _assert_outputs_equal(Engine(g, SERVING, device="cpu", planned=False).run_np(x),
                          ref)


def test_depthwise_silu_outside_the_kernel_raises():
    """SILU after a depthwise conv that is not the fused kernel (stride 2,
    or the unplanned lowering) is the exact tier's semantics."""
    with pytest.raises(NotImplementedError, match="A.3"):
        Engine(_dw_graph(2, "SILU"), SERVING, device="cpu")
    with pytest.raises(NotImplementedError, match="A.3"):
        Engine(_dw_graph(1, "SILU"), SERVING, device="cpu", planned=False)
    assert Engine(_dw_graph(1, "SILU"), SERVING, device="cpu")._fn.launch_census()[
        "depthwise_conv2d_int8_fused"] == 1


def test_entry_points_default_to_cuda():
    """Without a ``device`` argument the engine, the executors and
    ``params_from_jax`` put their tensors on ``cuda``; where torch finds
    no CUDA device they raise, and nothing falls back to the CPU. Whether
    a card is present is decided here, at run time."""
    from thingino_accel_tpu_torch.runtime import executor as EX
    g = PZ.build_yolov5("n", PZ.ZooConfig(in_hw=(64, 64)))
    params = {"w": np.zeros((4, 1, 1, 3), np.int8)}
    exact = EngineOptions(precision="exact")
    if torch.cuda.is_available():
        for eng in (Engine(g), Engine(g, exact),
                    Engine.from_mars(os.path.join(FIXTURES,
                                                  "test_conv.mars"))):
            assert eng.device.type == "cuda"
            assert all(v.is_cuda for v in eng.params.values())
        assert EX.Executor(g).device.type == "cuda"
        assert EX.build_executor(g, precision="exact").device.type == "cuda"
        assert EX.params_from_jax(params)["w"].is_cuda
        return
    calls = [lambda: Engine(g), lambda: Engine(g, exact),
             lambda: Engine.from_mars(os.path.join(FIXTURES,
                                                   "test_conv.mars")),
             lambda: Engine.from_yolo_mars(REAL_YOLO),
             lambda: EX.Executor(g), lambda: EX.build_executor(g),
             lambda: EX.build_executor(g, precision="exact"),
             lambda: EX.params_from_jax(params)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
