"""The port's ONNX code (``thingino_accel_tpu_torch.formats``: ``onnx_proto``,
``onnx_writer``, ``onnx``, ``onnx_export``) against the JAX package's, on
the same bytes and seeded numpy inputs:

- the writer: a model's bytes equal JAX's on each node list of JAX's
  ``tests/test_onnx.py`` and on a QDQ block (conv -> relu -> add ->
  concat, int8 weights behind DequantizeLinear, int32 biases);
- ``import_onnx``, float32 and int8 mode: the port's graph equals JAX's
  (``graph_from_jax``): nodes (op, inputs, outputs, attrs, name), tensors
  (shape, dtype, scale, zero point), constants bit for bit; a model JAX
  refuses, the port refuses with the same error;
- the imported graphs' forwards: float graphs in the exact tier within
  1e-5 of the largest |output| (``FLOAT_TOL``); int8 graphs bit for bit in
  the serving, exact and compat tiers (JAX's engine op by op, ``jit=False``,
  at the QDQ block's tie-prone ADD scales: ROADMAP.md C.12);
- ``models.onnx_fixtures.qdq_yolov5("n")`` at 160x160 (w_scale 0.002, so
  that the heads spread: ``W_SCALE``): the port's int8 import equals JAX's
  import of the same bytes, and the engines' int8 heads are equal, serving
  and exact tier;
- ``ir_to_onnx``: bytes equal JAX's on the zoo yolov5n at 160 (its concats
  carry axis 3) and on ``tiny_160_f32.mars``; on the real yolov5n's heads
  graph the port exports each CONCAT along the axis the executor joins
  (ROADMAP.md C.13), so JAX's ``import_onnx`` of the port's bytes gives
  the three heads (80, 80, 255), (40, 40, 255), (20, 20, 255) and JAX's
  float32 forward of it lies within ``FLOAT_TOL`` of the port's forward of
  the port's own import; JAX's own export re-imports to (1, 23680, 80,
  255);
- ROADMAP.md C.14: a per-channel DequantizeLinear on a conv weight. JAX's
  float32 import scales every channel by the first scale; the port's by
  its own (along ``axis``); in int8 mode JAX keeps the first scale and the
  port raises ``NotImplementedError``.
"""

import functools
import os

import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

from thingino_accel_tpu.formats import mars as JM
from thingino_accel_tpu.formats import onnx as JO
from thingino_accel_tpu.formats import onnx_export as JX
from thingino_accel_tpu.formats import onnx_proto as JOP
from thingino_accel_tpu.formats import onnx_writer as JW
from thingino_accel_tpu.ir import graph as JIR
from thingino_accel_tpu.models import yolo as JY
from thingino_accel_tpu.models import zoo as JZ
from thingino_accel_tpu.runtime import Engine as JEngine
from thingino_accel_tpu.runtime import EngineOptions as JOptions
from thingino_accel_tpu_torch.formats import mars as M
from thingino_accel_tpu_torch.formats import onnx as O
from thingino_accel_tpu_torch.formats import onnx_export as X
from thingino_accel_tpu_torch.formats import onnx_proto as OP
from thingino_accel_tpu_torch.formats import onnx_writer as W
from thingino_accel_tpu_torch.ir.graph import from_mars, graph_from_jax
from thingino_accel_tpu_torch.models import onnx_fixtures as F
from thingino_accel_tpu_torch.models import yolo as Y
from thingino_accel_tpu_torch.models import zoo
from thingino_accel_tpu_torch.runtime.engine import (
    Engine, EngineOptions, load_graph,
)

REPO = os.path.join(os.path.dirname(__file__), "..")
REAL_YOLO = os.path.join(REPO, "models", "yolov5n_cal_int8.mars")
TINY_F32 = os.path.join(REPO, "models", "fixtures", "tiny_160_f32.mars")
FLOAT_TOL = 1e-5
W_SCALE = 0.002
REAL_HEADS = [(1, 80, 80, 255), (1, 40, 40, 255), (1, 20, 20, 255)]


# -- the fixtures: each writes its model with the writer module it is given
# (JAX's or the port's) from numpy draws of a seeded generator ---------------


def _conv_relu(w_, rng):
    return w_.build_model(
        nodes=[("Conv", ["x", "w", "b"], ["c"],
                dict(kernel_shape=(3, 3), strides=(2, 2), pads=(1, 1, 1, 1))),
               ("Relu", ["c"], ["y"], None)],
        inputs={"x": ((1, 3, 16, 16), OP.TP_FLOAT)},
        outputs={"y": ((1, 8, 8, 8), OP.TP_FLOAT)},
        initializers={"w": rng.normal(size=(8, 3, 3, 3)).astype(np.float32),
                      "b": rng.normal(size=(8,)).astype(np.float32)})


def _batchnorm(w_, rng):
    c = 6
    return w_.build_model(
        nodes=[("Conv", ["x", "w"], ["c"], dict(kernel_shape=(1, 1))),
               ("BatchNormalization", ["c", "gamma", "beta", "mean", "var"],
                ["y"], dict(epsilon=1e-5))],
        inputs={"x": ((1, 3, 4, 4), OP.TP_FLOAT)},
        outputs={"y": ((1, c, 4, 4), OP.TP_FLOAT)},
        initializers={
            "w": rng.normal(size=(c, 3, 1, 1)).astype(np.float32),
            "gamma": rng.uniform(0.5, 2, c).astype(np.float32),
            "beta": rng.normal(size=c).astype(np.float32),
            "mean": rng.normal(size=c).astype(np.float32),
            "var": rng.uniform(0.5, 2, c).astype(np.float32)})


def _gru(w_, rng):
    t_len, b_sz, c, h = 5, 2, 4, 3
    return w_.build_model(
        nodes=[("GRU", ["x", "w", "r", "b"], ["y", "yh"],
                dict(hidden_size=h, linear_before_reset=1))],
        inputs={"x": ((t_len, b_sz, c), OP.TP_FLOAT)},
        outputs={"y": ((t_len, 1, b_sz, h), OP.TP_FLOAT),
                 "yh": ((1, b_sz, h), OP.TP_FLOAT)},
        initializers={
            "w": rng.normal(size=(1, 3 * h, c)).astype(np.float32),
            "r": rng.normal(size=(1, 3 * h, h)).astype(np.float32),
            "b": rng.normal(size=(1, 6 * h)).astype(np.float32)})


def _conv1d_transpose(w_, rng):
    c_in, c_out, ln = 4, 6, 10
    return w_.build_model(
        nodes=[("Conv", ["x", "w"], ["c"],
                dict(kernel_shape=(2,), strides=(2,), pads=(0, 0))),
               ("ConvTranspose", ["c", "wt"], ["y"],
                dict(kernel_shape=(2,), strides=(2,), pads=(0, 0)))],
        inputs={"x": ((1, c_in, ln), OP.TP_FLOAT)},
        outputs={"y": ((1, c_in, ln), OP.TP_FLOAT)},
        initializers={
            "w": rng.normal(size=(c_out, c_in, 2)).astype(np.float32),
            "wt": rng.normal(size=(c_out, c_in, 2)).astype(np.float32)})


def _split_slice_pow(w_, rng):
    return w_.build_model(
        nodes=[("Split", ["x"], ["a", "b"], dict(axis=1, split=(2, 2))),
               ("Pow", ["a", "two"], ["p"], None),
               ("Mul", ["p", "b"], ["y"], None)],
        inputs={"x": ((1, 4, 4, 4), OP.TP_FLOAT)},
        outputs={"y": ((1, 2, 4, 4), OP.TP_FLOAT)},
        initializers={"two": np.asarray(2.0, np.float32)})


def _flatten_gemm(w_, rng):
    return w_.build_model(
        nodes=[("Conv", ["x", "w"], ["c"],
                dict(kernel_shape=(3, 3), strides=(1, 1), pads=(1, 1, 1, 1))),
               ("Relu", ["c"], ["r"], None),
               ("Flatten", ["r"], ["f"], dict(axis=1)),
               ("Gemm", ["f", "fw", "fb"], ["y"], dict(transB=1))],
        inputs={"x": ((2, 3, 4, 4), OP.TP_FLOAT)},
        outputs={"y": ((2, 10), OP.TP_FLOAT)},
        initializers={
            "w": rng.normal(size=(8, 3, 3, 3)).astype(np.float32),
            "fw": rng.normal(size=(10, 8 * 4 * 4)).astype(np.float32),
            "fb": rng.normal(size=(10,)).astype(np.float32)})


def _reshape_4d(w_, rng):
    return w_.build_model(
        nodes=[("Relu", ["x"], ["r"], None),
               ("Reshape", ["r", "shape"], ["y"], None)],
        inputs={"x": ((1, 4, 6, 2), OP.TP_FLOAT)},
        outputs={"y": ((1, 8, 3, 2), OP.TP_FLOAT)},
        initializers={"shape": np.asarray([1, 8, 3, 2], np.int64)})


def _reshape_zero(w_, rng):
    return w_.build_model(
        nodes=[("Reshape", ["x", "shape"], ["y"], None)],
        inputs={"x": ((2, 6, 4), OP.TP_FLOAT)},
        outputs={"y": ((2, 6, 4), OP.TP_FLOAT)},
        initializers={"shape": np.array([0, 0, -1], np.int64)})


def _slice_reverse(w_, rng):
    # ends = -2^31: a negative int64 is a varint of ten bytes
    return w_.build_model(
        nodes=[("Slice", ["x", "st", "en", "ax", "sp"], ["y"], None)],
        inputs={"x": ((2, 8), OP.TP_FLOAT)},
        outputs={"y": ((2, 8), OP.TP_FLOAT)},
        initializers={"st": np.array([-1], np.int64),
                      "en": np.array([-(2 ** 31)], np.int64),
                      "ax": np.array([1], np.int64),
                      "sp": np.array([-1], np.int64)})


def _unsqueeze(w_, rng):
    return w_.build_model(
        nodes=[("Unsqueeze", ["x", "ax"], ["y"], None)],
        inputs={"x": ((2, 3), OP.TP_FLOAT)},
        outputs={"y": ((2, 3, 1, 1), OP.TP_FLOAT)},
        initializers={"ax": np.array([-1, -2], np.int64)})


def _matmul_3d(w_, rng):
    return w_.build_model(
        nodes=[("MatMul", ["x", "w"], ["y"], None)],
        inputs={"x": ((2, 5, 8), OP.TP_FLOAT)},
        outputs={"y": ((2, 5, 4), OP.TP_FLOAT)},
        initializers={"w": rng.normal(size=(8, 4)).astype(np.float32)})


def _gemm_alpha_beta(w_, rng):
    return w_.build_model(
        nodes=[("Gemm", ["x", "w", "b"], ["y"],
                dict(alpha=2.0, beta=0.5, transB=1))],
        inputs={"x": ((2, 8), OP.TP_FLOAT)},
        outputs={"y": ((2, 4), OP.TP_FLOAT)},
        initializers={"w": rng.normal(size=(4, 8)).astype(np.float32),
                      "b": rng.normal(size=(4,)).astype(np.float32)})


def _resize_down(w_, rng):
    return w_.build_model(
        nodes=[("Resize", ["x", "", "", "sz"], ["y"], dict(mode=b"nearest"))],
        inputs={"x": ((1, 3, 8, 8), OP.TP_FLOAT)},
        outputs={"y": ((1, 3, 4, 4), OP.TP_FLOAT)},
        initializers={"sz": np.array([1, 3, 4, 4], np.int64)})


def _dq_zero_point(w_, rng):
    return w_.build_model(
        nodes=[("DequantizeLinear", ["c", "sc", "zp"], ["w"], None),
               ("MatMul", ["x", "w"], ["y"], None)],
        inputs={"x": ((2, 4), OP.TP_FLOAT)},
        outputs={"y": ((2, 3), OP.TP_FLOAT)},
        initializers={"c": rng.integers(0, 256, (4, 3), dtype=np.uint8),
                      "sc": np.float32(0.1), "zp": np.uint8(128)})


def _qdq_block(w_, rng):
    """int8 in -> DQ -> conv 3x3 (int8 weights, int32 bias, both behind a
    DQ) -> Q/DQ -> relu -> Q/DQ -> add (the input) -> Q/DQ -> concat (the
    relu's output) -> Q: every scale per tensor."""
    zp = "zp"
    nodes, inits = [], {
        "zp": np.zeros((), np.int8),
        "w": rng.integers(-127, 128, (8, 8, 3, 3), dtype=np.int8),
        "b": rng.integers(-3000, 3000, (8,)).astype(np.int32),
        "s_in": np.float32(0.05), "s_w": np.float32(0.004),
        "s_b": np.float32(0.05) * np.float32(0.004),
        "s_c": np.float32(0.08), "s_r": np.float32(0.06),
        "s_a": np.float32(0.1)}
    nodes += [("DequantizeLinear", ["x", "s_in", zp], ["xd"], None),
              ("DequantizeLinear", ["w", "s_w"], ["wd"], None),
              ("DequantizeLinear", ["b", "s_b"], ["bd"], None),
              ("Conv", ["xd", "wd", "bd"], ["c"],
               dict(kernel_shape=(3, 3), pads=(1, 1, 1, 1)))]
    for src, s, op, dst, extra in (("c", "s_c", "Relu", "r", []),
                                   ("r", "s_r", "Add", "a", ["xd"]),
                                   ("a", "s_a", "Concat", "y", ["r_dq"])):
        nodes += [("QuantizeLinear", [src, s, zp], [src + "_q"], None),
                  ("DequantizeLinear", [src + "_q", s, zp], [src + "_dq"],
                   None),
                  (op, [src + "_dq"] + extra, [dst],
                   dict(axis=1) if op == "Concat" else None)]
    nodes.append(("QuantizeLinear", ["y", "s_a", zp], ["y_q"], None))
    return w_.build_model(
        nodes=nodes, inputs={"x": ((2, 8, 16, 16), OP.TP_INT8)},
        outputs={"y_q": ((2, 16, 16, 16), OP.TP_INT8)}, initializers=inits)


FIXTURES = {f.__name__[1:]: f for f in (
    _conv_relu, _batchnorm, _gru, _conv1d_transpose, _split_slice_pow,
    _flatten_gemm, _reshape_4d, _reshape_zero, _slice_reverse, _unsqueeze,
    _matmul_3d, _gemm_alpha_beta, _resize_down, _dq_zero_point, _qdq_block)}
REFUSED = {"resize_down": (ValueError, "integer upscale")}
INT8 = ("qdq_block",)


@functools.lru_cache(maxsize=None)
def model_bytes(name: str) -> bytes:
    return FIXTURES[name](W, np.random.default_rng(1234))


def assert_same_graph(port, ref):
    """The port's graph equals JAX's (as ``graph_from_jax`` gives it):
    nodes, tensors (quant and constants bit for bit), inputs, outputs."""
    ref = graph_from_jax(ref)
    assert (port.name, port.inputs, port.outputs) == (
        ref.name, ref.inputs, ref.outputs)
    assert [(n.op, n.inputs, n.outputs, n.name, n.attrs)
            for n in port.nodes] == [
        (n.op, n.inputs, n.outputs, n.name, n.attrs) for n in ref.nodes]
    assert list(port.tensors) == list(ref.tensors)
    for name, pt in port.tensors.items():
        jt = ref.tensors[name]
        assert (tuple(pt.shape), pt.dtype, pt.quant) == (
            tuple(jt.shape), jt.dtype, jt.quant), name
        assert (pt.data is None) == (jt.data is None), name
        if pt.data is not None:
            assert pt.data.dtype == jt.data.dtype, name
            np.testing.assert_array_equal(pt.data, jt.data, err_msg=name)


def _input(graph, rng):
    t = graph.tensors[graph.inputs[0]]
    if t.dtype == np.int8:
        return rng.integers(-128, 128, t.shape, dtype=np.int8)
    return rng.normal(size=t.shape).astype(np.float32)


def assert_close(got: dict, ref: dict, tol=FLOAT_TOL):
    assert set(got) == set(ref) and ref
    for k, r in ref.items():
        g = got[k]
        assert g.shape == r.shape and g.dtype == r.dtype, k
        if r.dtype == np.int8:
            np.testing.assert_array_equal(g, r, err_msg=k)
        else:
            err = float(np.abs(g.astype(np.float64) - r).max())
            assert err <= tol * float(np.abs(r).max()), (k, err)


@pytest.fixture(autouse=True)
def _interpret_mode():
    with pltpu.force_tpu_interpret_mode():
        yield


# -- writer --------------------------------------------------------------------


@pytest.mark.parametrize("name", FIXTURES)
def test_writer_bytes_equal_jax(name):
    got = FIXTURES[name](W, np.random.default_rng(1234))
    assert got == FIXTURES[name](JW, np.random.default_rng(1234))
    # and the port's reader gives back what JAX's reads
    p, j = OP.load(got).graph, JOP.load(got).graph
    assert [(n.op_type, n.inputs, n.outputs) for n in p.nodes] == [
        (n.op_type, n.inputs, n.outputs) for n in j.nodes]
    assert list(p.initializers) == list(j.initializers)
    for k, t in p.initializers.items():
        assert t.dims == j.initializers[k].dims
        np.testing.assert_array_equal(t.array, j.initializers[k].array)


def test_writer_pieces_equal_jax():
    """Attributes of every type, a value_info and a bare tensor, as JAX's
    writer serializes them (a numpy float32 attribute is refused by
    both)."""
    for name, value in [("i", -3), ("b", True), ("f", 0.1), ("s", "x"),
                        ("by", b"nearest"), ("t", np.arange(6).reshape(2, 3)),
                        ("fs", (0.5, -1.25)), ("is", [-1, 2 ** 40, 0])]:
        assert W.attribute(name, value) == JW.attribute(name, value), name
    for mod in (W, JW):
        with pytest.raises(TypeError):
            mod.attribute("x", np.float32(0.1))
    assert W.value_info("v", (1, 3, 0, 5), OP.TP_INT8) == JW.value_info(
        "v", (1, 3, 0, 5), OP.TP_INT8)
    arr = np.random.default_rng(3).normal(size=(2, 3)).astype(np.float16)
    assert W.tensor_proto("h", arr) == JW.tensor_proto("h", arr)


# -- import ----------------------------------------------------------------------


@pytest.mark.parametrize("float32", [True, False], ids=["f32", "int8"])
@pytest.mark.parametrize("name", FIXTURES)
def test_import_equals_jax(name, float32):
    data = model_bytes(name)
    if name in REFUSED:
        err, match = REFUSED[name]
        with pytest.raises(err, match=match) as got:
            O.import_onnx(data, float32=float32)
        with pytest.raises(err) as want:
            JO.import_onnx(data, float32=float32)
        assert str(got.value) == str(want.value)
        return
    assert_same_graph(O.import_onnx(data, float32=float32),
                      JO.import_onnx(data, float32=float32))


FORWARD_CASES = [(n, "exact") for n in FIXTURES
                 if n not in REFUSED and n not in INT8] + [
    (n, tier) for n in INT8 for tier in ("serving", "exact", "compat")]


@pytest.mark.parametrize("name,tier", FORWARD_CASES)
def test_forward_equals_jax(name, tier, highest_precision):
    """The imported graph's forward, port vs JAX, on one seeded input:
    float graphs in the exact tier (float32 import), int8 graphs (int8
    import) in the serving, exact and compat tiers."""
    float32 = name not in INT8
    data = model_bytes(name)
    jg = JO.import_onnx(data, float32=float32)
    x = _input(jg, np.random.default_rng(7))
    mode = "compat" if tier == "compat" else "full"
    prec = "exact" if tier == "compat" else tier
    # the int8 ADD's scales (0.06, 0.05 -> 0.1) meet rounding ties, where
    # XLA's jit contracts JAX's add_q into an FMA (ROADMAP.md C.12): JAX
    # runs op by op, as the port does
    ref = JEngine(jg, JOptions(precision=prec, mode=mode,
                               jit=float32)).run_np(x)
    got = Engine(O.import_onnx(data, float32=float32),
                 EngineOptions(precision=prec, mode=mode),
                 device="cpu").run_np(x)
    assert_close(got, {k: np.asarray(v) for k, v in ref.items()})
    if not float32:
        assert all(v.dtype == np.int8 for v in got.values())


@functools.lru_cache(maxsize=None)
def _qdq_yolov5n() -> bytes:
    return F.qdq_yolov5("n", zoo.ZooConfig(in_hw=(160, 160),
                                           w_scale=W_SCALE))


def test_qdq_yolov5_import_equals_jax():
    """The QDQ yolov5n: the port's int8 import equals JAX's, and is the
    zoo's graph with each SiLU as SIGMOID + MUL (the real yolov5n's
    form), its scales the zoo's."""
    data = _qdq_yolov5n()
    got = O.import_onnx(data)
    assert_same_graph(got, JO.import_onnx(data))
    z = zoo.build_yolov5("n", zoo.ZooConfig(in_hw=(160, 160),
                                            w_scale=W_SCALE))
    ops = [n.op for n in got.nodes]
    assert ops.count("CONV2D") == 60 and ops.count("SIGMOID") == 57
    assert ops.count("MUL") == 57
    assert got.outputs == z.outputs
    assert [got.tensors[o].shape for o in got.outputs] == [
        z.tensors[o].shape for o in z.outputs]
    convs = [n for n in got.nodes if n.op == "CONV2D"]
    zconvs = [n for n in z.nodes if n.op == "CONV2D"]
    for c, zc in zip(convs, zconvs):
        for i in (1, 2):
            np.testing.assert_array_equal(got.tensors[c.inputs[i]].data,
                                          z.tensors[zc.inputs[i]].data)
        assert got.tensors[c.inputs[1]].quant.scale == np.float32(W_SCALE)


@pytest.mark.parametrize("tier", ["serving", "exact"])
def test_qdq_yolov5_heads_equal_jax(tier):
    data = _qdq_yolov5n()
    jg = JO.import_onnx(data)
    x = np.random.default_rng(5).integers(-128, 128, (1, 160, 160, 3),
                                          dtype=np.int8)
    ref = JEngine(jg, JOptions(precision=tier)).run_np(x)
    got = Engine(O.import_onnx(data), EngineOptions(precision=tier),
                 device="cpu").run_np(x)
    assert_close(got, {k: np.asarray(v) for k, v in ref.items()})
    spread = [float(v.astype(np.float64).std()) for v in got.values()]
    assert min(spread) > 10, spread   # heads that carry information


# -- C.14: per-channel DequantizeLinear ---------------------------------------


def _per_channel_conv(w_):
    rng = np.random.default_rng(9)
    return w_.build_model(
        nodes=[("DequantizeLinear", ["w", "sw"], ["wd"], dict(axis=0)),
               ("Conv", ["x", "wd"], ["y"],
                dict(kernel_shape=(3, 3), pads=(1, 1, 1, 1)))],
        inputs={"x": ((1, 3, 8, 8), OP.TP_FLOAT)},
        outputs={"y": ((1, 8, 8, 8), OP.TP_FLOAT)},
        initializers={
            "w": rng.integers(-127, 128, (8, 3, 3, 3), dtype=np.int8),
            "sw": np.linspace(0.01, 0.08, 8).astype(np.float32)})


def test_per_channel_dequantize_float32():
    """C.14 in float32 mode: the port dequantizes along axis 0; JAX takes
    the first scale for every channel."""
    data = _per_channel_conv(W)
    assert data == _per_channel_conv(JW)
    w = np.random.default_rng(9).integers(-127, 128, (8, 3, 3, 3),
                                          dtype=np.int8)
    sw = np.linspace(0.01, 0.08, 8).astype(np.float32)
    got = O.import_onnx(data, float32=True)
    jg = JO.import_onnx(data, float32=True)
    (conv,) = got.nodes
    np.testing.assert_array_equal(
        got.tensors[conv.inputs[1]].data,
        w.astype(np.float32) * sw[:, None, None, None])
    np.testing.assert_array_equal(
        jg.tensors[jg.nodes[0].inputs[1]].data, w.astype(np.float32) * sw[0])
    # the rest of the graph is JAX's
    jg.tensors[jg.nodes[0].inputs[1]].data = got.tensors[conv.inputs[1]].data
    assert_same_graph(got, jg)


def test_per_channel_dequantize_int8():
    """C.14 in int8 mode: the port raises, naming the node; JAX imports
    the weight with the first scale alone."""
    data = _per_channel_conv(W)
    with pytest.raises(NotImplementedError, match="DequantizeLinear wd"):
        O.import_onnx(data)
    jg = JO.import_onnx(data)
    assert jg.tensors[jg.nodes[0].inputs[1]].quant.scale == np.float32(0.01)


# -- export ----------------------------------------------------------------------


def _real_heads(ir_mod, from_mars, yolo):
    g = from_mars(ir_mod.read_mars(REAL_YOLO))
    return g.with_outputs(yolo.find_detect_outputs(g))


@pytest.mark.parametrize("which", ["zoo-v5n-160", "tiny_160_f32"])
def test_ir_to_onnx_bytes_equal_jax(which):
    """Graphs whose concats carry their executor axis export to JAX's
    bytes."""
    if which == "tiny_160_f32":
        jg = JIR.from_mars(JM.read_mars(TINY_F32))
        g = load_graph(TINY_F32)
    else:
        jg = JZ.build_yolov5("n", JZ.ZooConfig(in_hw=(160, 160)))
        g = zoo.build_yolov5("n", zoo.ZooConfig(in_hw=(160, 160)))
        assert {n.attrs["axis"] for n in g.nodes if n.op == "CONCAT"} == {3}
    got = X.ir_to_onnx(g)
    assert got == JX.ir_to_onnx(jg)
    assert len(O.import_onnx(got, float32=True).nodes) > 0


def test_ir_to_onnx_real_heads_reimport():
    """C.13 repaired: the real yolov5n's heads graph (its concats stored
    as axis 1) exported by the port re-imports in JAX to the three heads,
    and JAX's float32 forward of that import equals the port's forward of
    its own import within FLOAT_TOL."""
    g = _real_heads(M, from_mars, Y)
    assert {n.attrs["axis"] for n in g.nodes if n.op == "CONCAT"} == {1}
    data = X.ir_to_onnx(g)
    jg = JO.import_onnx(data, float32=True)
    pg = O.import_onnx(data, float32=True)
    assert_same_graph(pg, jg)
    assert [jg.tensors[o].shape for o in jg.outputs] == REAL_HEADS
    x = np.random.default_rng(0).uniform(0, 1, (1, 640, 640, 3)).astype(
        np.float32)
    ref = JEngine(jg).run_np(x)
    got = Engine(pg, device="cpu").run_np(x)
    assert_close(got, {k: np.asarray(v) for k, v in ref.items()})


def test_jax_export_of_real_heads_concats_along_h():
    """C.13 as JAX has it: its export writes the stored axis 1 as ONNX
    axis 2 (H), and the heads re-import with H summed."""
    g = _real_heads(JM, JIR.from_mars, JY)
    jg = JO.import_onnx(JX.ir_to_onnx(g), float32=True)
    assert jg.tensors[jg.outputs[0]].shape == (1, 23680, 80, 255)


def test_ir_to_onnx_whole_real_file_raises_as_jax():
    with pytest.raises(ValueError) as want:
        JX.ir_to_onnx(JIR.from_mars(JM.read_mars(REAL_YOLO)))
    with pytest.raises(ValueError, match="unsupported op RESHAPE") as got:
        X.ir_to_onnx(load_graph(REAL_YOLO))
    assert str(got.value) == str(want.value)
