"""The port's exact tier (``Engine(precision="exact")``) against the JAX
package's exact tier and against the reference-runtime emulator.

- Zoo yolov5n at 64, batch 2 (per-tensor scales, so every conv runs in
  kernel #9, #10 or #11; their plain versions here): against the JAX
  ``Engine(precision="exact", conv_backend="pallas")`` in interpret mode.
  Each node is checked teacher-forced (fed the JAX ``trace`` values of its
  inputs): a conv's int8 output before its activation bit for bit against
  the JAX reference conv, every other output bit for bit except where a
  float step decides it (SiLU/SIGMOID/SOFTMAX: at most 1 quantum on at
  most 0.1% of the values, torch's and XLA's sigmoid differ by ulps).
  The heads end to end: measured bit for bit on the SiLU graph, and so
  held. The RELU copy bit for bit, node by node and end to end.
- The models of ``tests/test_refemu_parity.py`` against
  ``testing.refemu.RefEmulator``: convs at each stride, pad and act, and
  conv -> relu -> pool bit for bit; the compat sigmoid -> mul chain within
  1 quantum on more than 99.5% of the values, as the JAX test holds it.
- ``models.yolo.build_serving_pipeline`` over the exact engine equals its
  JAX counterpart's detections.

The real yolov5n (per-channel scales, SIGMOID+MUL) is in
``tests/test_torch_exact_real.py``.
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from thingino_accel_tpu.formats import mars as JM
from thingino_accel_tpu.ir.graph import Graph
from thingino_accel_tpu.ir.graph import Node as JNode
from thingino_accel_tpu.models import yolo as JY
from thingino_accel_tpu.models import zoo as JZ
from thingino_accel_tpu.ops import reference as JR
from thingino_accel_tpu.runtime import Engine as JEngine
from thingino_accel_tpu.runtime import EngineOptions as JOptions
from thingino_accel_tpu.testing.refemu import RefEmulator
from thingino_accel_tpu_torch.ir.graph import graph_from_jax
from thingino_accel_tpu_torch.models import yolo as Y
from thingino_accel_tpu_torch.ops import reference as R
from thingino_accel_tpu_torch.runtime.engine import Engine, EngineOptions
from thingino_accel_tpu_torch.runtime.executor import ExactConvUnit

from test_refemu_parity import make_conv_model

SILU_MAX_FRAC = 1e-3
FLOAT_OPS = ("SIGMOID", "SILU", "SILU_FUSED", "SOFTMAX")


def _exact(graph, mode="full"):
    """The port's exact engine on the CPU over a JAX package graph."""
    return Engine(graph_from_jax(graph), EngineOptions(precision="exact",
                                                       mode=mode),
                  device="cpu")


def _relu_copy(g: Graph) -> Graph:
    nodes = [JNode(op=n.op, inputs=list(n.inputs), outputs=list(n.outputs),
                   attrs=(dict(n.attrs, activation="RELU")
                          if n.op == "CONV2D" else dict(n.attrs)),
                   name=n.name) for n in g.nodes]
    return Graph(nodes=nodes, tensors=g.tensors, inputs=list(g.inputs),
                 outputs=list(g.outputs), name=g.name)


def _close(port, ref, float_step, what):
    assert port.shape == ref.shape and port.dtype == ref.dtype, what
    if not float_step:
        np.testing.assert_array_equal(port, ref, err_msg=what)
        return 0.0
    d = np.abs(port.astype(np.int32) - ref.astype(np.int32))
    frac = float((d > 0).mean())
    assert d.max() <= 1 and frac <= SILU_MAX_FRAC, (what, d.max(), frac)
    return frac


def check_nodes_teacher_forced(jeng, jacts, eng):
    """Every node of the port's exact executor, computed from the JAX
    engine's traced tensors, against the JAX tensor (or, for a fused SiLU
    pair, the JAX fused op on the same input); every conv's int8 output
    before its activation against the JAX reference conv. Returns the
    counts of nodes checked by op."""
    ex = eng._fn
    seen = collections.Counter()
    for node in ex.nodes:
        env = dict(eng.params)
        env.update({i: torch.from_numpy(np.array(jacts[i]))
                    for i in node.inputs if i in jacts})
        ex.lower_node(node, env)
        out = node.outputs[0]
        a = node.attrs
        if node.op == "SILU_FUSED":
            ref = np.asarray(JR.silu(
                jnp.asarray(jacts[node.inputs[0]]), a["in_scale"],
                a["sig_scale"], a["out_scale"], fuse=True))
        else:
            ref = jacts[out]
        act = a.get("activation", "NONE")
        float_step = node.op in FLOAT_OPS or (
            node.op == "CONV2D" and act in ("SILU", "SIGMOID")
            and not ex.compat)
        _close(env[out].numpy(), ref, float_step, f"{node.op} {out}")
        if node.op == "CONV2D":
            unit = ExactConvUnit(ex, node)
            pre = unit.compute(env, act=False)
            w_hwio = jeng._np_params[node.inputs[1]]
            bias = (jnp.asarray(jeng._np_params[node.inputs[2]])
                    if len(node.inputs) > 2 else None)
            jref = np.asarray(JR.conv2d_int8(
                jnp.asarray(jacts[node.inputs[0]]), jnp.asarray(w_hwio), bias,
                unit.out_hw, unit.stride, unit.dilation, unit.pads,
                *unit.scales, relu=unit.relu))
            np.testing.assert_array_equal(pre.numpy(), jref, err_msg=out)
        seen[node.op] += 1
    return seen


@pytest.fixture(scope="module", params=["silu", "relu"])
def zoo_case(request):
    """Zoo yolov5n at 64, batch 2 (SiLU convs, or their RELU copy), through
    the JAX exact engine with the Pallas backend in interpret mode: its
    graph, engine, input and traced tensors."""
    g = JZ.build_yolov5("n", JZ.ZooConfig(in_hw=(64, 64)))
    if request.param == "relu":
        g = _relu_copy(g)
    x = np.random.default_rng(5).integers(-128, 128, (2, 64, 64, 3),
                                          dtype=np.int8)
    with pltpu.force_tpu_interpret_mode():
        jeng = JEngine(g, JOptions(precision="exact", conv_backend="pallas"))
        return request.param, g, jeng, x, jeng.trace(x)


def test_zoo_nodes_teacher_forced(zoo_case):
    act, g, jeng, x, jacts = zoo_case
    eng = _exact(g)
    assert eng._fn.launch_census() == {
        "matmul_int8_requant": 42, "conv2d_int8_halo": 11, "conv2d_int8": 7,
        "plain_convs": 0}
    seen = check_nodes_teacher_forced(jeng, jacts, eng)
    assert seen == {"CONV2D": 60, "CONCAT": 13, "ADD": 7, "MAXPOOL": 3,
                    "UPSAMPLE": 2}


def test_zoo_heads_bit_exact(zoo_case):
    """The heads end to end, the port's exact engine against the JAX one:
    bit for bit (on the SiLU graph too: no value differed when this was
    measured, so none may)."""
    act, g, _, x, jacts = zoo_case
    out = _exact(g).run_np(x)
    assert set(out) == set(g.outputs)
    for k in g.outputs:
        np.testing.assert_array_equal(out[k], jacts[k], err_msg=k)
    assert all(len(np.unique(v)) > 10 for v in out.values())


def test_zoo_trace_and_capture(zoo_case):
    """``trace`` returns every activation, equal to the JAX trace where no
    float step decides it; ``capture`` records the 60 kernel convs of one
    forward, each re-run equal to its plain version."""
    act, g, _, x, jacts = zoo_case
    eng = _exact(g)
    acts = eng.trace(x)
    assert set(acts) == set(jacts)
    if act == "relu":
        for k in jacts:
            np.testing.assert_array_equal(acts[k].numpy(), jacts[k],
                                          err_msg=k)
    rec = eng.capture(x[:1])
    assert len(rec) == 60 and [u for u, _, _ in rec] == eng._fn.units
    for unit, reads, out in rec:
        env = dict(eng.params)
        env.update(reads)
        np.testing.assert_array_equal(unit.compute(env, plain=True).numpy(),
                                      out.numpy(), err_msg=repr(unit))


# ---------------------------------------------------------------------------
# Against the reference-runtime emulator (tests/test_refemu_parity.py)
# ---------------------------------------------------------------------------


def test_default_engine_is_the_exact_tier_as_in_jax():
    """ROADMAP C.5: with default options both engines run the exact tier,
    so ``Engine(g)`` on the port gives the JAX ``Engine(g)``'s heads bit
    for bit (zoo yolov5n at 64, SiLU, seeded input, batch 2)."""
    assert EngineOptions().precision == "exact" == JOptions().precision
    g = JZ.build_yolov5("n", JZ.ZooConfig(in_hw=(64, 64)))
    x = np.random.default_rng(21).integers(-128, 128, (2, 64, 64, 3),
                                           dtype=np.int8)
    ref = JEngine(g).run_np(x)
    eng = Engine(graph_from_jax(g), device="cpu")
    assert eng.options == EngineOptions(precision="exact")
    assert not eng.planned and eng._fn.launch_census() == {
        "matmul_int8_requant": 42, "conv2d_int8_halo": 11,
        "conv2d_int8": 7, "plain_convs": 0}
    out = eng.run_np(x)
    assert list(out) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(out[k], np.asarray(ref[k]), err_msg=k)


def _run_both(model, x, mode="full"):
    emu = RefEmulator(model)
    emu.set_input(x)
    emu.run()
    ref = emu.get_output()
    eng = Engine.from_mars(JM.write_mars(model),
                           EngineOptions(precision="exact", mode=mode),
                           device="cpu")
    got = list(eng.run_np(x[None] if x.ndim == 3 else x).values())[0]
    return ref, got.reshape(ref.shape), eng


@pytest.mark.parametrize("stride,pad,act", [
    (1, JM.Padding.SAME, JM.Activation.NONE),
    (1, JM.Padding.SAME, JM.Activation.RELU),
    (2, JM.Padding.VALID, JM.Activation.NONE),
    (2, JM.Padding.SAME, JM.Activation.RELU),
])
def test_refemu_conv_bit_parity(rng, stride, pad, act):
    model = make_conv_model(rng, stride=stride, pad=pad, act=act)
    x = rng.integers(-128, 128, (12, 14, 5), dtype=np.int8)
    ref, got, eng = _run_both(model, x)
    np.testing.assert_array_equal(got, ref)
    want = "conv2d_int8_halo" if stride == 1 else "conv2d_int8"
    assert eng._fn.launch_census()[want] == 1


def test_refemu_conv_relu_maxpool_pipeline_parity(rng):
    h, w, in_c, out_c = 12, 12, 4, 6
    weights = rng.integers(-128, 128, (out_c, 3, 3, in_c), dtype=np.int8)
    bias = rng.integers(-500, 500, (out_c,), dtype=np.int32)
    nhwc = JM.Format.NHWC
    tensors = [
        JM.MarsTensor(0, "in", JM.DType.INT8, nhwc, (1, h, w, in_c),
                      scale=0.1),
        JM.MarsTensor(1, "w", JM.DType.INT8, JM.Format.OHWI,
                      (out_c, 3, 3, in_c), scale=0.01),
        JM.MarsTensor(2, "b", JM.DType.INT32, JM.Format.D1, (out_c,)),
        JM.MarsTensor(3, "c1", JM.DType.INT8, nhwc, (1, h, w, out_c),
                      scale=0.2),
        JM.MarsTensor(4, "r1", JM.DType.INT8, nhwc, (1, h, w, out_c),
                      scale=0.2),
        JM.MarsTensor(5, "out", JM.DType.INT8, nhwc,
                      (1, h // 2, w // 2, out_c), scale=0.2),
    ]
    layers = [
        JM.MarsLayer(0, JM.LayerType.CONV2D, (0,), (3,),
                     JM.ConvParams(kernel_h=3, kernel_w=3,
                                   padding=JM.Padding.SAME,
                                   weight_tensor_id=1, bias_tensor_id=2)),
        JM.MarsLayer(1, JM.LayerType.RELU, (3,), (4,), JM.ActParams()),
        JM.MarsLayer(2, JM.LayerType.MAXPOOL, (4,), (5,),
                     JM.PoolParams(kernel_h=2, kernel_w=2,
                                   stride_h=2, stride_w=2)),
    ]
    model = JM.build_mars(tensors, layers, [0], [5], {1: weights, 2: bias})
    x = rng.integers(-128, 128, (h, w, in_c), dtype=np.int8)
    for mode in ("full", "compat"):
        ref, got, _ = _run_both(model, x, mode)
        np.testing.assert_array_equal(got, ref, err_msg=mode)


def test_refemu_elementwise_chain_parity(rng):
    """sigmoid -> mul (the SiLU pattern) in compat mode, unfused: within 1
    quantum on more than 99.5% of the values (libm's and torch's exp)."""
    n = 1, 6, 6, 4
    nhwc = JM.Format.NHWC
    tensors = [
        JM.MarsTensor(0, "in", JM.DType.INT8, nhwc, n, scale=0.08),
        JM.MarsTensor(1, "sig", JM.DType.INT8, nhwc, n, scale=1 / 256),
        JM.MarsTensor(2, "out", JM.DType.INT8, nhwc, n, scale=0.05),
    ]
    layers = [
        JM.MarsLayer(0, JM.LayerType.SIGMOID, (0,), (1,), JM.ActParams()),
        JM.MarsLayer(1, JM.LayerType.MUL, (0, 1), (2,), JM.ActParams()),
    ]
    model = JM.build_mars(tensors, layers, [0], [2], {})
    x = rng.integers(-128, 128, n[1:], dtype=np.int8)
    ref, got, eng = _run_both(model, x, "compat")
    assert [nd.op for nd in eng._fn.nodes] == ["SIGMOID", "MUL"]
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1
    assert (diff == 0).mean() > 0.995


# ---------------------------------------------------------------------------
# The serving pipeline over the exact engine
# ---------------------------------------------------------------------------


def test_serving_pipeline_on_exact_engine_matches_jax():
    """letterbox -> quantize -> exact network -> decode -> NMS: the port's
    ``build_serving_pipeline`` on the CPU against the same composition of
    the JAX package's functions over its exact engine. The frames are at
    the network's size, so both letterboxes copy them exactly; the heads'
    scale is raised so that scores pass the 0.25 threshold."""
    g = JZ.build_yolov5("n", JZ.ZooConfig(in_hw=(64, 64)))
    for o in g.outputs:
        g.tensors[o].quant = type(g.tensors[o].quant)(scale=0.25)
    frames = np.random.default_rng(12).integers(0, 256, (2, 64, 64, 3),
                                                dtype=np.uint8)
    dets = Y.build_serving_pipeline(_exact(g))(torch.from_numpy(frames))
    jeng = JEngine(g, JOptions(precision="exact"))
    x = JY.quantize_input_int8(JY.letterbox_uint8(frames, (64, 64)))
    heads = jeng.run(x)
    jb, jc, jk = JY.decode_and_parse(
        [heads[o] for o in g.outputs],
        scales=[g.tensors[o].quant.scale for o in g.outputs])
    ref = JY.nms_batched(jb, jc, jk, max_dets=100, pre_nms=128, topk_group=8)
    np.testing.assert_array_equal(dets.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(dets.classes.numpy(),
                                  np.asarray(ref.classes))
    np.testing.assert_allclose(dets.boxes.numpy(), np.asarray(ref.boxes),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(dets.scores.numpy(), np.asarray(ref.scores),
                               rtol=1e-6, atol=1e-12)
    assert int(dets.num.sum()) > 0


def test_exact_reference_ops_match_jax(rng):
    """The exact tier's plain ops beyond the model's, against the JAX
    reference ops on the same int8 input: relu, relu6 (full and compat),
    sigmoid, silu (fused and two-step), softmax (full and compat), mul_q,
    avgpool and global_avgpool."""
    x = rng.integers(-128, 128, (2, 7, 9, 6), dtype=np.int8)
    y = rng.integers(-128, 128, (2, 7, 9, 6), dtype=np.int8)
    tx, ty, jx, jy = (torch.from_numpy(x), torch.from_numpy(y),
                      jnp.asarray(x), jnp.asarray(y))
    exact = [
        (R.relu(tx), JR.relu(jx)),
        (R.relu6(tx, 0.03), JR.relu6(jx, 0.03)),
        (R.relu6(tx, 0.03, compat=True), JR.relu6(jx, 0.03, compat=True)),
        (R.mul_q(tx, ty, 0.05, 0.04, 0.06), JR.mul_q(jx, jy, 0.05, 0.04, 0.06)),
        (R.avgpool(tx, (3, 3), (2, 2), (4, 5), ((1, 1), (1, 1)), 0.05, 0.04),
         JR.avgpool(jx, (3, 3), (2, 2), (4, 5), ((1, 1), (1, 1)), 0.05, 0.04)),
        (R.global_avgpool(tx, 0.05, 0.02), JR.global_avgpool(jx, 0.05, 0.02)),
        (R.softmax(tx, compat=True), JR.softmax(jx, compat=True)),
    ]
    for port, ref in exact:
        np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    floats = [
        (R.sigmoid(tx, 0.05, 1 / 256), JR.sigmoid(jx, 0.05, 1 / 256)),
        (R.silu(tx, 0.05, out_scale=0.03), JR.silu(jx, 0.05, out_scale=0.03)),
        (R.silu(tx, 0.05, 1 / 256, 0.03, fuse=False),
         JR.silu(jx, 0.05, 1 / 256, 0.03, fuse=False)),
        (R.softmax(tx, -1, 0.1, 1 / 128), JR.softmax(jx, -1, 0.1, 1 / 128)),
    ]
    for port, ref in floats:
        d = np.abs(port.numpy().astype(np.int32)
                   - np.asarray(ref).astype(np.int32))
        assert d.max() <= 1 and (d > 0).mean() <= 0.02, (d.max(),
                                                          (d > 0).mean())


@pytest.mark.parametrize("act", ["NONE", "RELU", "RELU6", "LEAKY_RELU",
                                 "SILU", "SIGMOID", "TANH", "HARD_SWISH"])
def test_conv_activation_matches_jax(rng, act):
    """``apply_fused_act`` (a conv's activation on its int8 output) against
    the JAX ``_apply_fused_act``: bit for bit where no float function
    decides it, else within 1 quantum on at most 2% of the values."""
    from thingino_accel_tpu.ir.graph import QuantInfo, TensorInfo
    from thingino_accel_tpu.runtime import executor as JEX
    from thingino_accel_tpu_torch.runtime.executor import apply_fused_act
    x = rng.integers(-128, 128, (2, 9, 11, 8), dtype=np.int8)
    out_t = TensorInfo("y", x.shape, np.dtype(np.int8), QuantInfo(0.04))
    ref = np.asarray(JEX._apply_fused_act(jnp.asarray(x), act, out_t, False,
                                          alpha=0.1))
    port = apply_fused_act(torch.from_numpy(x), act, 0.04,
                           alpha=0.1).numpy()
    assert port.dtype == ref.dtype == np.int8
    d = np.abs(port.astype(np.int32) - ref.astype(np.int32))
    if act in ("SILU", "SIGMOID", "TANH", "HARD_SWISH"):
        assert d.max() <= 1 and (d > 0).mean() <= 0.02, (d.max(),
                                                         (d > 0).mean())
    else:
        assert d.max() == 0
    compat = apply_fused_act(torch.from_numpy(x), act, 0.04, compat=True)
    np.testing.assert_array_equal(compat.numpy(), x)
