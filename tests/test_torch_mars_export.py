"""The port's `.mars` writer (``thingino_accel_tpu_torch.formats.
mars_export.export_mars``) against the JAX package's, bytes for bytes:

- the committed fixtures (``models/fixtures/*.mars``) read and written
  again, and the real yolov5n, whose bytes come back as the file's;
- the zoo's graphs (yolov5n int8 and float32, NanoDet int8 with its
  depthwise convs, at 64x64);
- the graphs that ``formats.onnx.import_onnx`` makes of ONNX fixtures, a
  float32 and an int8 (QDQ) one, and the QDQ yolov5n of
  ``models.onnx_fixtures`` at 160x160;
- per-channel weight scales (their ``__chs`` companion tensor) and the
  errors both writers raise (an op with no layer type, an int32
  activation).

Also the loop the CLI's ``compile`` runs: the QDQ yolov5n imported, written
as `.mars`, read back: the serving tier's heads equal the imported graph's
bit for bit on the CPU.
"""

import os

import numpy as np
import pytest

from thingino_accel_tpu.formats import mars as JM
from thingino_accel_tpu.formats import mars_export as JE
from thingino_accel_tpu.formats import onnx as JO
from thingino_accel_tpu.ir import graph as JIR
from thingino_accel_tpu.models import zoo as JZ
from thingino_accel_tpu_torch.formats import mars_export as E
from thingino_accel_tpu_torch.formats import onnx as O
from thingino_accel_tpu_torch.formats import onnx_proto as OP
from thingino_accel_tpu_torch.formats import onnx_writer as W
from thingino_accel_tpu_torch.ir.graph import graph_from_jax
from thingino_accel_tpu_torch.models import onnx_fixtures as F
from thingino_accel_tpu_torch.models import zoo
from thingino_accel_tpu_torch.runtime.engine import (
    Engine, EngineOptions, load_graph,
)

REPO = os.path.join(os.path.dirname(__file__), "..")
FIXTURES = os.path.join(REPO, "models", "fixtures")
REAL_YOLO = os.path.join(REPO, "models", "yolov5n_cal_int8.mars")


def _onnx_conv_bn_relu() -> bytes:
    rng = np.random.default_rng(4)
    return W.build_model(
        nodes=[("Conv", ["x", "w", "b"], ["c"],
                dict(kernel_shape=(3, 3), strides=(2, 2), pads=(1, 1, 1, 1))),
               ("BatchNormalization", ["c", "g", "be", "m", "v"], ["n"],
                dict(epsilon=1e-5)),
               ("LeakyRelu", ["n"], ["l"], None),
               ("MaxPool", ["l"], ["p"], dict(kernel_shape=(2, 2))),
               ("Resize", ["p", "", "sc"], ["y"], dict(mode="nearest"))],
        inputs={"x": ((1, 3, 16, 16), OP.TP_FLOAT)},
        outputs={"y": ((1, 8, 8, 8), OP.TP_FLOAT)},
        initializers={"w": rng.normal(size=(8, 3, 3, 3)).astype(np.float32),
                      "b": rng.normal(size=(8,)).astype(np.float32),
                      "g": rng.uniform(0.5, 2, 8).astype(np.float32),
                      "be": rng.normal(size=8).astype(np.float32),
                      "m": rng.normal(size=8).astype(np.float32),
                      "v": rng.uniform(0.5, 2, 8).astype(np.float32),
                      "sc": np.asarray([1, 1, 2, 2], np.float32)})


QDQ_V5N = F.qdq_yolov5("n", zoo.ZooConfig(in_hw=(160, 160), w_scale=0.002))

# name -> (the port's graph, JAX's graph), each built anew
GRAPHS = {
    **{f"fixture-{f}": (lambda f=f: (
        load_graph(os.path.join(FIXTURES, f)),
        JIR.from_mars(JM.read_mars(os.path.join(FIXTURES, f)))))
       for f in ("test_conv.mars", "tiny_160_f32.mars",
                 "tiny_160_int8.mars")},
    "zoo-v5n-int8": lambda: (
        zoo.build_yolov5("n", zoo.ZooConfig(in_hw=(64, 64))),
        JZ.build_yolov5("n", JZ.ZooConfig(in_hw=(64, 64)))),
    "zoo-v5n-f32": lambda: (
        zoo.build_yolov5("n", zoo.ZooConfig(in_hw=(64, 64),
                                            dtype="float32")),
        JZ.build_yolov5("n", JZ.ZooConfig(in_hw=(64, 64),
                                          dtype="float32"))),
    "zoo-nanodet": lambda: (
        zoo.build_nanodet(zoo.ZooConfig(in_hw=(64, 64))),
        JZ.build_nanodet(JZ.ZooConfig(in_hw=(64, 64)))),
    "onnx-f32": lambda: (O.import_onnx(_onnx_conv_bn_relu(), float32=True),
                         JO.import_onnx(_onnx_conv_bn_relu(), float32=True)),
    "onnx-qdq-v5n": lambda: (O.import_onnx(QDQ_V5N),
                             JO.import_onnx(QDQ_V5N)),
}


@pytest.mark.parametrize("name", GRAPHS)
def test_export_mars_bytes_equal_jax(name):
    port, jax_graph = GRAPHS[name]()
    got = E.export_mars(port)
    assert got == JE.export_mars(jax_graph)
    assert JM.read_mars(got).layers


def test_real_yolov5n_bytes_come_back(tmp_path):
    """The real yolov5n read and written again gives the file's bytes
    (1,986,240), also through ``path``."""
    want = open(REAL_YOLO, "rb").read()
    path = str(tmp_path / "y.mars")
    got = E.export_mars(load_graph(REAL_YOLO), path)
    assert got == want and len(got) == 1_986_240
    assert open(path, "rb").read() == want


def test_channel_scales_companion_equals_jax():
    """A per-channel int8 weight rides with its ``__chs`` tensor (its
    name cut to 54 characters), and reads back with its scales."""
    jg = JZ.build_yolov5("n", JZ.ZooConfig(in_hw=(64, 64)))
    conv = next(n for n in jg.nodes if n.op == "CONV2D")
    long = "w" * 70
    wt = jg.tensors.pop(conv.inputs[1])
    wt.name, conv.inputs[1], jg.tensors[long] = long, long, wt
    wt.channel_scales = np.linspace(0.001, 0.01, wt.shape[0]).astype(
        np.float32)
    got = E.export_mars(graph_from_jax(jg))
    assert got == JE.export_mars(jg)
    back = load_graph(got)
    c0 = next(n for n in back.nodes if n.op == "CONV2D")
    np.testing.assert_array_equal(back.tensors[c0.inputs[1]].channel_scales,
                                  wt.channel_scales)


def test_export_errors_equal_jax():
    """An op with no `.mars` layer type, and an int32 activation, raise
    the same ValueError in both writers."""
    for mutate in ("op", "dtype"):
        pair = []
        for build, ZC in ((JZ.build_yolov5, JZ.ZooConfig),
                          (zoo.build_yolov5, zoo.ZooConfig)):
            g = build("n", ZC(in_hw=(64, 64)))
            if mutate == "op":
                g.nodes[3].op = "GRU"
            else:
                g.tensors[g.nodes[0].outputs[0]].dtype = np.dtype(np.int32)
            pair.append(g)
        with pytest.raises(ValueError) as want:
            JE.export_mars(pair[0])
        with pytest.raises(ValueError) as got:
            E.export_mars(pair[1])
        assert str(got.value) == str(want.value)


def test_compiled_qdq_yolov5_serves_as_imported():
    """ONNX -> IR -> `.mars` -> IR: the serving tier's heads from the
    written file equal the imported graph's bit for bit."""
    g = O.import_onnx(QDQ_V5N)
    back = load_graph(E.export_mars(g))
    assert back.outputs == g.outputs
    x = np.random.default_rng(2).integers(-128, 128, (2, 160, 160, 3),
                                          dtype=np.int8)
    opts = EngineOptions(precision="serving")
    want = Engine(g, opts, device="cpu").run_np(x)
    got = Engine(back, opts, device="cpu").run_np(x)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
