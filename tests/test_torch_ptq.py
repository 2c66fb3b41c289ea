"""The port's post-training quantization (``thingino_accel_tpu_torch.
training.ptq``) against the JAX package's ``training/ptq.py``, on the same
graphs and seeded calibration batches:

- ``_mse_scale`` equals JAX's on heavy-tailed and flat samples;
- ``calibrate`` (the port's exact tier on the CPU) gives absmax values
  within ``CALIB_RTOL`` (1e-5) of JAX's, ``method="percentile"`` and
  ``"mse"``, on the tiny float convnet and on the decompiled 64x64
  yolov5n of the `.mgk` fixture (zoo weights at w_scale 0.002, so that
  its int8 heads spread), both observing the same tensors;
- ``quantize_graph`` on JAX's ``CalibStats`` gives JAX's graph bit for
  bit (weights, per-channel scales, int32 biases, activation scales) on
  the tiny convnet, the per-channel FC graph of JAX's
  ``tests/test_ptq.py`` (output channels on the FC weight's last axis)
  and the decompiled yolov5n; ``quantize_model`` on the CPU gives JAX's
  graph on the tiny convnet;
- the PTQ'd yolov5n runs in the port's exact tier bit for bit against
  JAX's, and in the serving tier (the kernels' plain versions; SiLU units
  within 1 quantum on at most 0.1%) against JAX's serving tier in
  interpret mode;
- the `.mars` round trip: the port's ``export_mars`` bytes of the PTQ'd
  graph equal JAX's, and the file read back runs to the same outputs;
- a percentile calibration of pool tensors above 1000 values leaves the
  SPPF unfused, a max calibration (``percentile=100``) makes it one #4;
- the default device is the card: without one, ``calibrate`` raises.
"""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from thingino_accel_tpu.formats import mars_export as JX
from thingino_accel_tpu.formats import onnx as JO
from thingino_accel_tpu.formats import onnx_proto as JOP
from thingino_accel_tpu.formats import onnx_writer as JW
from thingino_accel_tpu.models import zoo as JZ
from thingino_accel_tpu.runtime import Engine as JEngine
from thingino_accel_tpu.runtime import EngineOptions as JOptions
from thingino_accel_tpu.training import ptq as JP
from thingino_accel_tpu_torch.formats import mars_export as X
from thingino_accel_tpu_torch.formats import mgk as MGK
from thingino_accel_tpu_torch.formats import mgk_yolo as MY
from thingino_accel_tpu_torch.formats.onnx import import_onnx
from thingino_accel_tpu_torch.ir.graph import graph_from_jax
from thingino_accel_tpu_torch.models import mgk_fixtures as F
from thingino_accel_tpu_torch.models import zoo
from thingino_accel_tpu_torch.runtime.engine import (
    Engine, EngineOptions, load_graph,
)
from thingino_accel_tpu_torch.training import ptq as P

CALIB_RTOL = 1e-5
W_SCALE = 0.002        # the zoo weights that keep the PTQ'd heads spread
SILU_MAX_FRAC = 1e-3   # SiLU units: 1 quantum on at most 0.1%


def _tiny():
    return JZ.build_tiny(JZ.ZooConfig(dtype="float32", in_hw=(32, 32)),
                         in_hw=(32, 32))


def _fc_graph():
    """JAX's ``test_ptq_fc_per_channel`` model: conv, relu, flatten, an FC
    whose output channels differ in magnitude by 1000x."""
    rng = np.random.default_rng(3)
    w = rng.normal(size=(8, 3, 3, 3)).astype(np.float32)
    fw = (rng.normal(size=(6, 8 * 4 * 4)) *
          np.geomspace(0.01, 10.0, 6)[:, None]).astype(np.float32)
    fb = rng.normal(size=(6,)).astype(np.float32)
    m = JW.build_model(
        nodes=[
            ("Conv", ["x", "w"], ["c"],
             dict(kernel_shape=(3, 3), pads=(1, 1, 1, 1))),
            ("Relu", ["c"], ["r"], None),
            ("Flatten", ["r"], ["f"], dict(axis=1)),
            ("Gemm", ["f", "fw", "fb"], ["y"], dict(transB=1)),
        ],
        inputs={"x": ((1, 3, 4, 4), JOP.TP_FLOAT)},
        outputs={"y": ((1, 6), JOP.TP_FLOAT)},
        initializers={"w": w, "fw": fw, "fb": fb},
    )
    return JO.import_onnx(m, float32=True)


def _normal_batches(g, n=3, seed=0):
    rng = np.random.default_rng(seed)
    return [{g.inputs[0]: rng.normal(
        scale=0.5, size=g.tensors[g.inputs[0]].shape).astype(np.float32)}
        for _ in range(n)]


@pytest.fixture(scope="module")
def yolo():
    """The 64x64 yolov5n `.mgk` fixture decompiled to float32 ONNX and
    imported (JAX's graph), and 3 calibration frames: uint8 noise, minus
    128, at the zoo graph's input scale."""
    data, g0 = F.build_yolo_mgk("n", in_hw=(64, 64), w_scale=W_SCALE)
    elf, meta = MGK.load_mgk(data)
    jg = JO.import_onnx(MY.export_yolo_onnx(elf, meta, in_hw=(64, 64)),
                        float32=True)
    in_scale = np.float32(g0.tensors[g0.inputs[0]].quant.scale)
    rng = np.random.default_rng(0)
    batches = [{jg.inputs[0]: (rng.integers(0, 256, (1, 64, 64, 3))
                               .astype(np.float32) - 128) * in_scale}
               for _ in range(3)]
    return jg, batches


GRAPHS = {"tiny": lambda y: (_tiny(), _normal_batches(_tiny())),
          "fc": lambda y: (_fc_graph(), _normal_batches(_fc_graph())),
          "yolov5n": lambda y: y}


def assert_same_graph(port, ref):
    """Nodes, tensors (dtype, quant, per-channel scales, constants bit for
    bit), inputs and outputs equal."""
    ref = graph_from_jax(ref)
    assert (port.name, port.inputs, port.outputs) == (
        ref.name, ref.inputs, ref.outputs)
    assert [(n.op, n.inputs, n.outputs, n.name) for n in port.nodes] == [
        (n.op, n.inputs, n.outputs, n.name) for n in ref.nodes]
    assert list(port.tensors) == list(ref.tensors)
    for name, pt in port.tensors.items():
        jt = ref.tensors[name]
        assert (tuple(pt.shape), np.dtype(pt.dtype), pt.quant) == (
            tuple(jt.shape), np.dtype(jt.dtype), jt.quant), name
        for a, b in ((pt.data, jt.data),
                     (pt.channel_scales, jt.channel_scales)):
            assert (a is None) == (b is None), name
            if a is not None:
                assert np.asarray(a).dtype == np.asarray(b).dtype, name
                np.testing.assert_array_equal(a, b, err_msg=name)


def test_mse_scale_equals_jax():
    rng = np.random.default_rng(0)
    heavy = np.abs(np.concatenate([
        rng.normal(0, 0.5, 60000).astype(np.float32), [8.0]]))
    flat = np.abs(rng.uniform(-1, 1, 60000).astype(np.float32))
    for s in (heavy, flat, heavy[:100], np.zeros(0, np.float32)):
        for am in (float(s.max()) if s.size else 0.0, 3.0, 0.0):
            assert P._mse_scale(s, am) == JP._mse_scale(s, am)


@pytest.mark.parametrize("method", ["percentile", "mse"])
@pytest.mark.parametrize("graph", ["tiny", "yolov5n"])
def test_calibrate_within_rtol_of_jax(graph, method, yolo):
    g, batches = GRAPHS[graph](yolo)
    want = JP.calibrate(g, iter(batches), method=method).absmax
    got = P.calibrate(graph_from_jax(g), iter(batches), method=method,
                      device="cpu").absmax
    assert sorted(got) == sorted(want) and len(want) > 3
    for k, w in want.items():
        assert w > 0 and abs(got[k] - w) <= CALIB_RTOL * w, (k, got[k], w)


@pytest.mark.parametrize("n", [1001, 4097, 100_003, 1_000_003])
def test_percentile_by_sort_is_numpys(n):
    """The card's percentile (a sort, then numpy's own index, fraction and
    interpolation steps) equals ``np.percentile`` bit for bit, here on
    CPU tensors: the float32 virtual index that numpy computes for a
    float32 array at 99.99 lands between other ranks than a float64 one
    would (8.85e-5 apart on the real yolov5n's activations at 640)."""
    rng = np.random.default_rng(n)
    dists = (rng.standard_cauchy(n), rng.normal(size=n), rng.uniform(size=n))
    qs = (99.99, 99.9, 50.0, 12.345, 100.0, 0.0)
    for a in dists[:1] if n > 100_003 else dists:
        a = np.abs(a).astype(np.float32)
        for q in qs[:1] if n > 100_003 else qs:
            assert P._percentile_by_sort(torch.from_numpy(a), q) == \
                float(np.percentile(a, q)), (n, q)


def test_calibrate_percentile_off_and_small_tensors():
    """``percentile=None`` and tensors of at most 1000 elements take the
    raw maximum, as JAX's."""
    g = _fc_graph()
    for pct in (None, 50.0):
        want = JP.calibrate(g, iter(_normal_batches(g)), pct).absmax
        got = P.calibrate(graph_from_jax(g), iter(_normal_batches(g)), pct,
                          device="cpu").absmax
        assert got == want


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_quantize_graph_equals_jax(graph, yolo):
    g, batches = GRAPHS[graph](yolo)
    stats = JP.calibrate(g, iter(batches))
    got = P.quantize_graph(graph_from_jax(g), P.CalibStats(stats.absmax))
    want = JP.quantize_graph(g, stats)
    assert_same_graph(got, want)
    if graph == "fc":    # per OUTPUT channel: the FC weight's last axis
        fc_w = next(t for t in got.tensors.values()
                    if t.is_const and t.channel_scales is not None
                    and t.data.ndim == 2)
        assert fc_w.channel_scales.shape == (6,)


def test_quantize_model_on_the_cpu_equals_jax():
    g = _tiny()
    got = P.quantize_model(graph_from_jax(g), iter(_normal_batches(g)),
                           device="cpu")
    assert_same_graph(got, JP.quantize_model(g, iter(_normal_batches(g))))


@pytest.fixture(scope="module")
def yolo_int8(yolo):
    jg, batches = yolo
    jq = JP.quantize_graph(jg, JP.calibrate(jg, iter(batches)))
    x = np.random.default_rng(1).integers(-128, 128, (2, 64, 64, 3),
                                          dtype=np.int8)
    return jq, x


def test_ptq_yolov5n_exact_tier_equals_jax(yolo_int8):
    jq, x = yolo_int8
    want = JEngine(jq).run_np(x)
    got = Engine(graph_from_jax(jq), device="cpu").run_np(x)
    assert list(got) == list(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w)
        assert 0.01 < float(np.mean(np.abs(w) >= 127)) < 0.2   # spread


def test_ptq_yolov5n_serving_tier_equals_jax(yolo_int8):
    jq, x = yolo_int8
    x = x[:1]     # JAX's interpret mode takes about 10 s a frame here
    with pltpu.force_tpu_interpret_mode():
        want = JEngine(jq, JOptions(precision="serving")).run_np(x)
    eng = Engine(graph_from_jax(jq), EngineOptions(precision="serving"),
                 device="cpu")
    assert eng._fn.launch_census()["sppf_int8_fused"] == 1
    got = eng.run_np(x)
    for k, w in want.items():
        d = np.abs(got[k].astype(np.int32) - w)
        assert d.max() <= 1 and float(np.mean(d > 0)) <= SILU_MAX_FRAC, k


def test_ptq_mars_roundtrip_equals_jax(yolo_int8):
    jq, x = yolo_int8
    pq = graph_from_jax(jq)
    blob = X.export_mars(pq)
    assert blob == JX.export_mars(jq)
    a = Engine(pq, device="cpu").run_np(x)
    b = Engine(load_graph(blob), device="cpu").run_np(x)
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k].reshape(a[k].shape))


def test_ptq_tiny_zoo_graph_roundtrip():
    """The port's own zoo ``build_tiny`` graph through the port's PTQ on
    the CPU and its `.mars` writer: the int8 file reloads bit-equal."""
    g = zoo.build_tiny(zoo.ZooConfig(dtype="float32", in_hw=(32, 32)),
                       in_hw=(32, 32))
    gq = P.quantize_model(g, iter(_normal_batches(g)), device="cpu")
    g2 = load_graph(X.export_mars(gq))
    x = np.random.default_rng(1).integers(-100, 100, (1, 32, 32, 3),
                                          dtype=np.int8)
    (a,) = Engine(gq, device="cpu").run_np(x).values()
    (b,) = Engine(g2, device="cpu").run_np(x).values()
    assert a.dtype == np.int8
    np.testing.assert_array_equal(a, b.reshape(a.shape))


@pytest.mark.parametrize("percentile,sppf", [(99.99, 0), (100.0, 1)])
def test_pool_scales_and_the_sppf_kernel(percentile, sppf):
    """At 128x128 the SPPF's pool tensors hold 2048 values, so the
    percentile (not the raw maximum) calibrates them: at 99.99 each pool
    gets its own scale and the planner's equal-scale rule leaves the SPPF
    unfused; at 100 (max calibration) a max-pool chain keeps its input's
    maximum, so its scales are equal and the SPPF is one #4."""
    data, g0 = F.build_yolo_mgk("n", in_hw=(128, 128), w_scale=W_SCALE)
    elf, meta = MGK.load_mgk(data)
    g = import_onnx(MY.export_yolo_onnx(elf, meta, in_hw=(128, 128)),
                    float32=True)
    in_scale = np.float32(g0.tensors[g0.inputs[0]].quant.scale)
    x = (np.random.default_rng(0).integers(0, 256, (1, 128, 128, 3))
         .astype(np.float32) - 128) * in_scale
    q = P.quantize_model(g, [{g.inputs[0]: x}], percentile, device="cpu")
    eng = Engine(q, EngineOptions(precision="serving"), device="cpu")
    assert eng._fn.launch_census()["sppf_int8_fused"] == sppf


def test_calibrate_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    g = graph_from_jax(_tiny())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.calibrate(g, iter(_normal_batches(g)))
