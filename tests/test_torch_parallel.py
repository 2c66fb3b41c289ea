"""The port's ``parallel/`` (a mesh of torch devices in one process)
against the JAX package's (``jax.sharding`` over the 8 virtual CPU devices
of ``tests/conftest.py``), on graphs JAX builds, handed over by
``graph_from_jax``; inputs from seeded numpy. The port's mesh is 8 x
``torch.device("cpu")``. Where JAX's sharded call is costly, the port is
held against JAX's unsharded engine, as JAX's own tests hold its sharded
calls equal to that.

- ``make_sharded_forward`` at dp=4 x tp=2 on ``zoo.build_tiny`` and the
  zoo yolov5n at 64 in float32, within JAX's 1e-4 (``FWD_TOL``), and on
  the int8 zoo yolov5n in the exact tier, bit for bit; in the serving
  tier, unplanned and planned, against the port's own engine, bit for
  bit;
- ``param_sharding_rules``: JAX's spec for every param, the axis mapped
  to the port's layout (a conv weight's HWIO axis 3 is OHWI axis 0);
- the channel gathers: 0 at tp=1; at dp=1 x tp=8 one a sharded producer
  -> consumer edge;
- ``make_sharded_train_step`` against JAX's at ``compute_dtype=float32``:
  5 steps, losses within ``LOSS_RTOL``, the loss falling;
- ``make_sharded_detector`` on the int8 zoo yolov5n at 64 in the fast
  tier, as JAX's ``test_sharded_detector_e2e``: scores within 1e-5,
  ``valid`` equal, boxes and classes on the scores unique in a frame, no
  gather;
- ``split_graph``: JAX's stages node for node, with their inputs and
  outputs;
- ``PipelinedEngine`` (JAX's ``test_pipeline_*``): 4 stages, 12
  microbatches in feed order against JAX's engine; stage windows overlap;
  a stage's error surfaces; an abandoned generator releases its threads.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thingino_accel_tpu.models import yolo as JY
from thingino_accel_tpu.models import zoo as JZ
from thingino_accel_tpu.parallel import make_mesh as j_make_mesh
from thingino_accel_tpu.parallel import (
    make_sharded_train_step as j_make_sharded_train_step,
)
from thingino_accel_tpu.parallel import param_sharding_rules as j_rules
from thingino_accel_tpu.parallel.pipeline import split_graph as j_split
from thingino_accel_tpu.runtime import Engine as JEngine
from thingino_accel_tpu.runtime import EngineOptions as JOptions
from thingino_accel_tpu_torch import parallel
from thingino_accel_tpu_torch.ir.graph import graph_from_jax
from thingino_accel_tpu_torch.parallel import (
    PipelinedEngine, make_mesh, make_sharded_detector, make_sharded_forward,
    make_sharded_train_step, param_sharding_rules, split_graph,
)
from thingino_accel_tpu_torch.runtime.engine import Engine, EngineOptions

FWD_TOL = 1e-4      # float32 heads, sharded against JAX's engine
LOSS_RTOL = 1e-4    # a train step's loss against JAX's sharded step
CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def jmesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return j_make_mesh(dp=4, tp=2)


def _yolov5n(dtype="float32", hw=64):
    return JZ.build_yolov5("n", JZ.ZooConfig(dtype=dtype, in_hw=(hw, hw)))


def _tiny(hw):
    return JZ.build_tiny(JZ.ZooConfig(dtype="float32", in_hw=(hw, hw)),
                         in_hw=(hw, hw))


def test_exports_jax_names():
    import thingino_accel_tpu.parallel as jp
    assert sorted(parallel.__all__) == sorted(jp.__all__)


def test_mesh_shape_and_errors(jmesh):
    mesh = make_mesh(dp=4, tp=2, devices=CPU8)
    assert mesh.shape == jmesh.shape == {"dp": 4, "tp": 2}
    assert make_mesh(tp=2, devices=CPU8).shape == {"dp": 4, "tp": 2}
    with pytest.raises(ValueError, match="dp\\*tp"):
        make_mesh(dp=3, tp=2, devices=CPU8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()


@pytest.mark.parametrize("model,tier", [
    ("tiny", "exact"), ("yolov5n", "exact"), ("yolov5n_int8", "exact"),
    ("yolov5n_int8", "serving_unplanned"),
    ("yolov5n_int8", "serving_planned")])
def test_sharded_forward_matches_jax(jmesh, model, tier):
    jg = (_tiny(64) if model == "tiny"
          else _yolov5n("int8" if model.endswith("int8") else "float32"))
    rng = np.random.default_rng(0)
    if model.endswith("int8"):
        x = rng.integers(-128, 128, (8, 64, 64, 3), dtype=np.int8)
    else:
        x = rng.normal(size=(8, 64, 64, 3)).astype(np.float32)
    if tier == "exact":
        eng = Engine(graph_from_jax(jg), device="cpu")
        want = JEngine(jg).run_np(x)
    else:
        # the serving tier against the port's own engine, which the
        # serving tests hold against JAX's: unplanned, its per-channel
        # epilogue rows cut by slice; planned, its fused steps whole on
        # gathered weights
        eng = Engine(graph_from_jax(jg), EngineOptions(precision="serving"),
                     device="cpu", planned=tier == "serving_planned")
        want = eng.run_np(x)
    fn, sp = make_sharded_forward(eng, make_mesh(dp=4, tp=2, devices=CPU8))
    got = fn(sp, {jg.inputs[0]: x})
    if eng.planned:
        assert fn.gathers["channels"] == 0 and fn.gathers["params"] > 0
    else:
        assert fn.tp.sharded and fn.gathers["params"] == 0
    for k, v in want.items():
        g = got[k].numpy()
        assert g.shape == v.shape
        if model.endswith("int8"):
            np.testing.assert_array_equal(g, v)
        else:
            np.testing.assert_allclose(g, v, rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("model", ["yolov5n_f32", "yolov5n_int8"])
def test_param_sharding_rules_match_jax(jmesh, model):
    jg = _yolov5n("int8" if model.endswith("int8") else "float32")
    jeng = JEngine(jg)
    want = j_rules(jeng._np_params, jmesh)
    eng = Engine(graph_from_jax(jg), device="cpu")
    conv = eng._fn.conv_weights
    got = param_sharding_rules(eng.params, make_mesh(dp=4, tp=2,
                                                     devices=CPU8), conv)
    assert set(got) == set(want)
    n_sharded = 0
    for k, spec in want.items():
        axes = [d for d, a in enumerate(tuple(spec.spec)) if a == "tp"]
        # HWIO axis 3 -> OHWI axis 0; every other param keeps JAX's layout
        port_axes = [(3, 0, 1, 2).index(d) if k in conv else d for d in axes]
        assert [d for d, a in enumerate(got[k]) if a == "tp"] == port_axes
        n_sharded += bool(axes)
    assert n_sharded > 50


def _edges(fn, graph):
    """Sharded producer -> consumer edges of the port's node list, and the
    sharded graph outputs."""
    sharded = set(fn.tp.sharded)
    edges = sum(len(set(n.inputs) & sharded) for n in fn.tp.nodes)
    return edges + len(sharded & set(graph.outputs))


@pytest.mark.parametrize("dp,tp", [(8, 1), (1, 8)])
def test_channel_gathers(dp, tp):
    jg = _yolov5n(hw=32)
    eng = Engine(graph_from_jax(jg), device="cpu")
    fn, sp = make_sharded_forward(eng, make_mesh(dp=dp, tp=tp, devices=CPU8))
    x = np.zeros((8, 32, 32, 3), np.float32)
    got = fn(sp, {jg.inputs[0]: x})
    assert sorted(v.shape for v in got.values()) == [
        (8, 1, 1, 255), (8, 2, 2, 255), (8, 4, 4, 255)]
    if tp == 1:
        assert fn.gathers == {"channels": 0, "params": 0}
    else:
        # JAX's test_tp_forward_expected_collective_pattern: one channel
        # all-gather a sharded-producer -> consumer edge, at least 10
        assert fn.gathers["channels"] == _edges(fn, eng.graph) >= 10
        assert fn.gathers["params"] == 0
        assert fn.whole == sorted(n.inputs[1] for n in eng.graph.nodes
                                  if n.op == "CONV2D"
                                  and eng.graph.tensors[n.outputs[0]]
                                  .shape[3] % 8)


def test_sharded_train_step_matches_jax(jmesh):
    jg = _tiny(32)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 32, 32, 3)).astype(np.float32)
    y = rng.normal(size=(8, 26, 26, 64)).astype(np.float32) * 0.1
    step, params, opt = j_make_sharded_train_step(
        jg, jmesh, qat=True, compute_dtype=jnp.float32)
    want = []
    for _ in range(5):
        params, opt, loss = step(params, opt, {jg.inputs[0]: jnp.asarray(x)},
                                 {jg.outputs[0]: jnp.asarray(y)})
        want.append(float(loss))
    step, params, opt = make_sharded_train_step(
        graph_from_jax(jg), make_mesh(dp=4, tp=2, devices=CPU8), qat=True)
    got = []
    for _ in range(5):
        params, opt, loss = step(params, opt, {jg.inputs[0]: x},
                                 {jg.outputs[0]: y})
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert got[-1] < got[0] and np.isfinite(got).all()
    assert step.gathers["channels"] > 0
    whole = step.gather(params)
    assert {k: tuple(v.shape) for k, v in whole.items()} == {
        k: tuple(v.shape) for k, v in Engine(graph_from_jax(jg),
                                             device="cpu").params.items()}


def test_sharded_detector_matches_jax():
    jg = _yolov5n("int8")
    frames = np.random.default_rng(0).integers(0, 256, (8, 48, 64, 3),
                                               dtype=np.uint8)
    # JAX's test_sharded_detector_e2e reference: the unsharded pipeline
    # (as one jitted program: op by op, its NMS compiles for 11 s)
    jeng = JEngine(jg, JOptions(precision="fast"))
    outs = list(jeng.graph.outputs)
    scales = [jeng.graph.tensors[o].quant.scale for o in outs]

    def pipeline(params, fr):
        x = JY.quantize_input_int8(JY.letterbox_uint8(fr, (64, 64)))
        feats = jeng._fn(params, {jeng.graph.inputs[0]: x})
        return JY.nms_batched(*JY.decode_and_parse(
            [feats[k] for k in outs], scales=scales), max_dets=10)

    ref = jax.jit(pipeline)(jeng.params, jnp.asarray(frames))
    eng = Engine(graph_from_jax(jg), EngineOptions(precision="fast"),
                 device="cpu")
    fn, sp = make_sharded_detector(eng, make_mesh(dp=4, tp=2, devices=CPU8),
                                   max_dets=10)
    boxes, scores, classes, valid = (t.numpy() for t in fn(
        sp, torch.from_numpy(frames)))
    assert boxes.shape == (8, 10, 4) and valid.shape == (8, 10)
    assert fn.gathers == {"channels": 0, "params": 0}
    np.testing.assert_allclose(scores, np.asarray(ref.scores), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(valid, np.asarray(ref.valid))
    assert valid.any()
    rv = np.asarray(ref.valid)
    for bi in range(8):
        uniq, counts = np.unique(scores[bi][rv[bi]], return_counts=True)
        m = rv[bi] & np.isin(scores[bi], uniq[counts == 1])
        np.testing.assert_allclose(boxes[bi][m], np.asarray(ref.boxes)[bi][m],
                                   rtol=1e-4, atol=1e-3)
        np.testing.assert_array_equal(classes[bi][m],
                                      np.asarray(ref.classes)[bi][m])


@pytest.mark.parametrize("n_stages", [2, 3, 4, 7])
def test_split_graph_matches_jax(n_stages):
    jg = _yolov5n()
    want = j_split(jg, n_stages)
    got = split_graph(graph_from_jax(jg), n_stages)
    assert [[n.name for n in s.nodes] for s in got] == [
        [n.name for n in s.nodes] for s in want]
    assert [(s.inputs, s.outputs, s.name) for s in got] == [
        (s.inputs, s.outputs, s.name) for s in want]


def test_pipeline_four_stages_in_order(jmesh):
    jg = _yolov5n()
    pipe = PipelinedEngine(graph_from_jax(jg), devices=["cpu"] * 4)
    assert len(pipe.stages) == 4
    ref = JEngine(jg)
    rng = np.random.default_rng(7)
    xs = [rng.normal(size=(1, 64, 64, 3)).astype(np.float32)
          for _ in range(12)]
    outs = list(pipe.run({jg.inputs[0]: x} for x in xs))
    assert len(outs) == 12
    for x, o in zip(xs, outs):        # feed order
        for k, v in ref.run_np(x).items():
            np.testing.assert_allclose(o[k].numpy(), v, rtol=FWD_TOL,
                                       atol=FWD_TOL)


def _tiny_pipe(n):
    g = graph_from_jax(_tiny(32))
    return g, PipelinedEngine(g, devices=["cpu"] * n)


def test_pipeline_stage_overlap(monkeypatch):
    """Stage windows of different stages intersect in wall time, and the
    run ends well under the serial sum (JAX's
    ``test_pipeline_stage_overlap_observed``)."""
    g = graph_from_jax(_yolov5n(hw=32))
    pipe = PipelinedEngine(g, devices=["cpu"] * 4)
    windows = []
    orig = PipelinedEngine._stage_call
    delay = 0.05

    def slow_call(self, si, env):
        t0 = time.perf_counter()
        out = orig(self, si, env)
        time.sleep(delay)
        windows.append((si, t0, time.perf_counter()))
        return out

    monkeypatch.setattr(PipelinedEngine, "_stage_call", slow_call)
    n_mb = 8
    x = np.zeros((1, 32, 32, 3), np.float32)
    list(pipe.run({g.inputs[0]: x} for _ in range(2)))
    windows.clear()
    t0 = time.perf_counter()
    outs = list(pipe.run({g.inputs[0]: x} for _ in range(n_mb)))
    wall = time.perf_counter() - t0
    assert len(outs) == n_mb and len(windows) == n_mb * 4
    overlaps = sum(1 for i, (si, a0, a1) in enumerate(windows)
                   for sj, b0, b1 in windows[i + 1:]
                   if si != sj and max(a0, b0) < min(a1, b1))
    assert overlaps > 0
    assert wall < 0.75 * n_mb * 4 * delay


def test_pipeline_error_propagates():
    g, pipe = _tiny_pipe(4)

    def bad_call(si, env, _orig=pipe._stage_call):
        if si == 2:
            raise RuntimeError("stage 2 boom")
        return _orig(si, env)

    pipe._stage_call = bad_call
    x = np.zeros((1, 32, 32, 3), np.float32)
    with pytest.raises(RuntimeError, match="stage 2 boom"):
        list(pipe.run({g.inputs[0]: x} for _ in range(6)))


def test_pipeline_abandoned_generator_releases_threads():
    g, pipe = _tiny_pipe(3)
    before = threading.active_count()
    x = np.zeros((1, 32, 32, 3), np.float32)
    gen = pipe.run({g.inputs[0]: x} for _ in range(50))
    next(gen)
    gen.close()
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.1)
    assert threading.active_count() <= before
