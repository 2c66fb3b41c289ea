"""The port's serving planner and planned lowering vs the JAX package's.

- Plan: ``runtime.planner.plan_folds`` against ``executor._plan_folds`` on
  the real yolov5n (rewired to its heads), zoo yolov5n at 64, zoo yolov5s
  at 640, ``models/nanodet_320.mars`` and zoo nanodet at 64 (planning
  only, no tensors are computed).
- Run-time decisions: the kernel units the JAX planned engine calls on zoo
  yolov5n and zoo nanodet at 64 (recorded by wrapping the functions of
  ``thingino_accel_tpu.ops.fused_kernels`` in this test only; the executor
  looks them up at call time) against the units of the port's schedule, in
  order. The JAX lowering mutates its plan while it runs (``runtime_fold``,
  ``parts``, ``qbf16_env``), so the JAX engine runs twice on one plan and
  both runs are held against the port's one schedule.
- Each unit teacher-forced: the port's unit computes from the JAX
  package's recorded tensors and is held against the JAX unit's output.
  Tolerance: non-SiLU units bit-exact; SiLU units within 1 quantum on at
  most 0.1% of the elements (torch's and XLA's sigmoid differ by ulps on
  the CPU).
"""

import collections
import functools
import os

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from thingino_accel_tpu.formats.mars import read_mars
from thingino_accel_tpu.ir import passes
from thingino_accel_tpu.ir.graph import from_mars as jax_from_mars
from thingino_accel_tpu.ir.passes import fuse_silu_pairs
from thingino_accel_tpu.models import zoo
from thingino_accel_tpu.ops import fused_kernels as JFK
from thingino_accel_tpu.runtime import Engine as JEngine
from thingino_accel_tpu.runtime import EngineOptions as JOptions
from thingino_accel_tpu.runtime import executor as JEX
from thingino_accel_tpu_torch.ir import passes as port_passes
from thingino_accel_tpu_torch.ir.graph import graph_from_jax
from thingino_accel_tpu_torch.models.yolo import find_detect_outputs
from thingino_accel_tpu_torch.runtime import planner as P
from thingino_accel_tpu_torch.runtime.engine import Engine
from thingino_accel_tpu_torch.runtime.executor import KernelUnit

REAL_YOLO = os.path.join(os.path.dirname(__file__), "..", "models",
                         "yolov5n_cal_int8.mars")
NANODET = os.path.join(os.path.dirname(__file__), "..", "models",
                       "nanodet_320.mars")

# the JAX functions a planned forward calls for its kernel units
UNIT_FUNCS = ("conv2d_int8_stem_fused", "conv2d_int8_folded",
              "matmul_int8_fused_multi", "bottleneck_int8_fused",
              "sppf_int8_fused", "conv2d_int8_fused",
              "depthwise_conv2d_int8_fused")


def _graph(name):
    """The JAX package's graph of ``name``."""
    if name == "real_yolov5n":
        g = jax_from_mars(read_mars(REAL_YOLO))
        return g.with_outputs(find_detect_outputs(g))
    if name == "nanodet_320":
        return jax_from_mars(read_mars(NANODET))
    if name == "zoo_nanodet_64":
        return zoo.build_nanodet(zoo.ZooConfig(in_hw=(64, 64)), batch=2)
    size, hw = {"zoo_yolov5n_64": ("n", 64),
                "zoo_yolov5s_640": ("s", 640)}[name]
    return zoo.build_yolov5(size, zoo.ZooConfig(in_hw=(hw, hw)))


def _serving(g):
    """The serving tier's graph passes and node list, as the JAX engine
    builds them."""
    g = passes.fold_batchnorm(passes.fuse_act_into_conv(g))
    return g, fuse_silu_pairs(g)


def _port_serving(name):
    """The same for the port: ``name``'s graph converted, the port's
    passes."""
    g = graph_from_jax(_graph(name))
    g = port_passes.fold_batchnorm(port_passes.fuse_act_into_conv(g))
    return g, port_passes.fuse_silu_pairs(g)


def _port_engine(g):
    return Engine(graph_from_jax(g), device="cpu")


def _names(d):
    return sorted(d) if isinstance(d, (dict, set)) else d


@pytest.mark.parametrize("name", ["real_yolov5n", "zoo_yolov5n_64",
                                  "zoo_yolov5s_640", "nanodet_320",
                                  "zoo_nanodet_64"])
def test_plan_equals_jax(name):
    g, nodes = _serving(_graph(name))
    ref = JEX._plan_folds(nodes, g.tensors, g.outputs)
    pg, pnodes = _port_serving(name)
    port = P.plan_folds(pnodes, pg.tensors, pg.outputs)
    assert port.stem_stage == ref.stem_stage
    assert port.stem_emit == ref.stem_emit
    assert port.fold == ref.fold
    assert port.parts == ref.parts
    for field in ("res_fuse", "virtual_concat", "sppf", "bneck",
                  "skip_outputs", "pool_of"):
        assert _names(getattr(port, field)) == _names(getattr(ref, field)), \
            field
    assert port.virtual_concat == ref.virtual_concat
    assert port.sppf == ref.sppf
    assert port.pool_of == ref.pool_of
    assert {k: (a.outputs, b.outputs) for k, (a, b) in port.bneck.items()} \
        == {k: (a.outputs, b.outputs) for k, (a, b) in ref.bneck.items()}
    assert {k: (n.outputs, o) for k, (n, o) in port.res_fuse.items()} \
        == {k: (n.outputs, o) for k, (n, o) in ref.res_fuse.items()}


def test_nanodet_plan():
    """The NanoDet stem (3x3/s2 from 3 channels, LEAKY) is a one-conv stem
    stage emitting int8 at fold 4; its LEAKY convs take no fused residual,
    so the two PAN ADDs stay plain; nothing else fuses."""
    g, nodes = _port_serving("nanodet_320")
    plan = P.plan_folds(nodes, g.tensors, g.outputs)
    assert plan.stem_stage == {"t_3"} and plan.stem_emit == {"t_3": "int8"}
    assert plan.f("t_3") == 4
    assert not (plan.res_fuse or plan.virtual_concat or plan.sppf
                or plan.bneck or plan.skip_outputs)
    eng = _port_engine(_graph("nanodet_320"))
    steps = [(type(s).__name__, getattr(s, "kind", s.out))
             for s in eng._fn.steps]
    assert steps[:3] == [("ConvUnit", "conv"), ("NodeStep", "t_7"),
                         ("ConvUnit", "matmul")]
    adds = [s for s in eng._fn.steps if getattr(s, "node", None) is not None
            and s.node.op == "ADD"]
    assert len(adds) == 2


def test_real_yolov5n_plan_census():
    """The fold factors gate the fusions: with the real plan's folds the
    /model.16 concat (inputs at different folds) is materialized."""
    g, nodes = _port_serving("real_yolov5n")
    plan = P.plan_folds(nodes, g.tensors, g.outputs)
    assert (len(plan.res_fuse), len(plan.virtual_concat), len(plan.sppf),
            len(plan.bneck)) == (6, 12, 0, 10)
    assert "/model.16/Concat_output_0" not in plan.virtual_concat
    assert sorted(plan.stem_stage) == sorted(
        f"/model.{m}/act/Mul_output_0" for m in
        ("0", "1", "2/cv1", "2/cv2", "2/m/m.0/cv2"))
    assert collections.Counter(plan.fold.values()) == {1: 45, 2: 11, 4: 7}
    # the same graph at fold 1 everywhere would fuse it
    flat = P.FoldPlan()
    flat.stem_stage = plan.stem_stage
    P.plan_epilogue_fusions(nodes, g.tensors, flat, plan.consumers,
                            set(g.outputs))
    assert "/model.16/Concat_output_0" in flat.virtual_concat
    assert len(flat.virtual_concat) == 13


@pytest.mark.parametrize("name,census", [
    ("real_yolov5n", {"matmul_int8_fused": 17, "conv2d_int8_halo_fused": 8,
                      "matmul_int8_fused_multi": 15,
                      "bottleneck_int8_fused": 10, "sppf_int8_fused": 0,
                      "depthwise_conv2d_int8_fused": 0}),
    ("zoo_yolov5s_640", {"matmul_int8_fused": 14,
                         "conv2d_int8_halo_fused": 7,
                         "matmul_int8_fused_multi": 16,
                         "bottleneck_int8_fused": 11, "sppf_int8_fused": 1,
                         "depthwise_conv2d_int8_fused": 0}),
    ("nanodet_320", {"matmul_int8_fused": 16, "conv2d_int8_halo_fused": 1,
                     "matmul_int8_fused_multi": 0,
                     "bottleneck_int8_fused": 0, "sppf_int8_fused": 0,
                     "depthwise_conv2d_int8_fused": 6}),
])
def test_launch_census(name, census):
    """Kernel launches of one planned forward, from the schedule: every
    residual rides in a bottleneck, 60 convs in 50 (real) launches; the
    NanoDet's 27 convs in 23, its 4 stride-2 depthwise convs plain."""
    eng = _port_engine(_graph(name))
    assert eng._fn.launch_census() == census
    units = eng._fn.units
    assert not any(u.residual for u in units if u.kind != "bneck")
    assert sum(1 + (u.kind == "bneck") for u in units) == sum(
        n.op == "CONV2D" or eng._fn.dw_kernel(n) for n in eng._fn.nodes)


# ---------------------------------------------------------------------------
# Run-time decisions on zoo yolov5n @64, recorded from the JAX engine
# ---------------------------------------------------------------------------


def _record_jax_units(g, x, runs=1):
    """``runs`` planned forwards of one JAX serving engine (not jitted, so
    the values are concrete and each run lowers the graph again on the
    same plan): per run, per top-level kernel unit call, (function, has
    residual, output); and the first run's outputs."""
    recs, depth = [], [0]

    def wrap(name, fn):
        @functools.wraps(fn)
        def rec_fn(*a, **k):
            depth[0] += 1
            try:
                out = fn(*a, **k)
            finally:
                depth[0] -= 1
            if depth[0] == 0:
                res = (k.get("residual") is not None
                       or bool(k.get("shortcut", False)))
                recs[-1].append((name, res, np.asarray(out)))
            return out
        return rec_fn

    with pytest.MonkeyPatch.context() as mp, \
            pltpu.force_tpu_interpret_mode():
        for name in UNIT_FUNCS:
            mp.setattr(JFK, name, wrap(name, getattr(JFK, name)))
        eng = JEngine(g, JOptions(precision="serving", jit=False))
        outs = []
        for _ in range(runs):
            recs.append([])
            outs.append(eng.run_np(x))
    return recs, outs[0]


@pytest.fixture(scope="module")
def jax_units():
    """Two planned forwards of the JAX serving engine on SiLU zoo yolov5n
    at 64, batch 2: the input, the first run's units, its outputs, and
    the second run's units."""
    g = _graph("zoo_yolov5n_64")
    x = np.random.default_rng(2).integers(-128, 128, (2, 64, 64, 3),
                                          dtype=np.int8)
    (rec, rec2), out = _record_jax_units(g, x, runs=2)
    return g, x, rec, out, rec2


@pytest.fixture(scope="module")
def jax_nanodet_units():
    """The same for zoo nanodet at 64, batch 2 (LEAKY_RELU throughout)."""
    g = _graph("zoo_nanodet_64")
    x = np.random.default_rng(3).integers(-128, 128, (2, 64, 64, 3),
                                          dtype=np.int8)
    (rec, rec2), out = _record_jax_units(g, x, runs=2)
    return g, x, rec, out, rec2


def _logical(arr, shape):
    """A JAX unit's output (folded [N, H, W/f, f*C + pad], or rows
    [N*H*W/f, ...]; int8 or integer-valued bf16) as logical NHWC."""
    n, h, w, c = shape
    a = np.asarray(arr).astype(np.int8)
    a = a.reshape(n, h, -1, a.shape[-1])
    f = w // a.shape[2]
    return np.ascontiguousarray(a[..., :f * c].reshape(n, h, w, c))


def test_runtime_units_equal_jax(jax_units):
    g, x, rec, _, _ = jax_units
    eng = _port_engine(g)
    units = eng._fn.units
    port = [(u.mirrors, u.residual is not None) for u in units]
    assert port == [(name, res) for name, res, _ in rec]
    for u, (_, _, arr) in zip(units, rec):
        shape = (2,) + tuple(eng.graph.tensors[u.out].shape[1:])
        assert _logical(arr, shape).shape == shape
    kinds = collections.Counter(u.mirrors for u in units)
    assert kinds == {"conv2d_int8_folded": 20, "matmul_int8_fused_multi": 14,
                     "bottleneck_int8_fused": 10,
                     "conv2d_int8_stem_fused": 5, "sppf_int8_fused": 1}


def test_units_teacher_forced_silu(jax_units):
    """Every port unit computes from the JAX package's tensors (unit
    outputs recorded from the JAX run; exact torch ops in between) and is
    held against the JAX unit's output."""
    g, x, rec, _, _ = jax_units
    eng = _port_engine(g)
    env = dict(eng.params)
    env[eng.input_names[0]] = torch.from_numpy(x)
    i = 0
    silu = 0
    for step in eng._fn.steps:
        if not isinstance(step, KernelUnit):
            step.run(env)
            continue
        shape = (2,) + tuple(eng.graph.tensors[step.out].shape[1:])
        ref = _logical(rec[i][2], shape)
        port = step.compute(env).numpy()
        assert port.shape == ref.shape and port.dtype == ref.dtype
        d = np.abs(port.astype(np.int32) - ref.astype(np.int32))
        if step.act == "SILU":
            silu += 1
            assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (
                step, d.max(), (d > 0).mean())
        else:
            np.testing.assert_array_equal(port, ref, err_msg=repr(step))
        env[step.out] = torch.from_numpy(ref)
        i += 1
    assert i == len(rec) and silu == 47


@pytest.mark.parametrize("which", ["yolov5n", "nanodet"])
def test_second_jax_trace_takes_the_same_units(which, request):
    """The JAX lowering mutates its plan as it runs; a second run on the
    same plan calls the same kernel units, with the same outputs, as the
    first, and both equal the port's one schedule."""
    fixture = {"yolov5n": "jax_units", "nanodet": "jax_nanodet_units"}
    g, _, rec, _, rec2 = request.getfixturevalue(fixture[which])
    port = [(u.mirrors, u.residual is not None)
            for u in _port_engine(g)._fn.units]
    assert [(n, r) for n, r, _ in rec2] == [(n, r) for n, r, _ in rec] \
        == port
    for (_, _, a), (_, _, b) in zip(rec, rec2):
        np.testing.assert_array_equal(a, b)


def test_nanodet_units_teacher_forced(jax_nanodet_units):
    """Zoo nanodet at 64: the JAX planned engine calls 1 stem, 16 folded
    1x1 and 6 depthwise units; each port unit, computed from the JAX
    package's tensors, equals the JAX unit bit for bit, and the port's
    heads equal the JAX heads."""
    g, x, rec, out, _ = jax_nanodet_units
    eng = _port_engine(g)
    assert collections.Counter(u.mirrors for u in eng._fn.units) == {
        "conv2d_int8_stem_fused": 1, "conv2d_int8_folded": 16,
        "depthwise_conv2d_int8_fused": 6}
    env = dict(eng.params)
    env[eng.input_names[0]] = torch.from_numpy(x)
    units = iter(rec)
    for step in eng._fn.steps:
        if not isinstance(step, KernelUnit):
            step.run(env)
            continue
        shape = (2,) + tuple(eng.graph.tensors[step.out].shape[1:])
        ref = _logical(next(units)[2], shape)
        np.testing.assert_array_equal(step.compute(env).numpy(), ref,
                                      err_msg=repr(step))
        env[step.out] = torch.from_numpy(ref)
    got = eng.run_np(x)
    for k in out:
        np.testing.assert_array_equal(got[k], out[k], err_msg=k)
