"""The port's command line (``thingino_accel_tpu_torch.cli``) against the
JAX package's (``thingino_accel_tpu.cli``), both run in process on the
same model and input, the port with ``--device cpu``:

- ``summary``: the same text (the fixture and the real yolov5n);
- ``run``: the same output lines (shape, dtype, min, max, mean) on the
  fixture conv and on the real yolov5n, with a seeded input and from a
  ``.npy`` input; the engine and timing lines differ by design;
- ``detect``: the same detection lines (class, score, box in image
  pixels) on the real yolov5n (exact tier) at conf 0.001, where its
  random-frame detections spread (60 on this frame; none at 0.25), from
  a ``.npy`` frame of 360x640 and from a PNG through Pillow;
- ``compile`` (``--float32`` of the real yolov5n's heads graph as the
  port's exporter writes it; int8 of the QDQ yolov5n of
  ``models.onnx_fixtures`` at 160x160; ``-v`` on a model with an op the
  importer skips), ``gen-test`` (default and given sizes) and
  ``export-onnx`` (``tiny_160_f32.mars``, ``test_conv.mars``): the output
  file's bytes and the printed lines equal JAX's; ``export-onnx`` of the
  whole real yolov5n raises JAX's error (its decode tail's RESHAPE);
- ``decompile`` of the YOLO and AEC `.mgk` fixtures
  (``models.mgk_fixtures``): the JSON, the ``--extract-weights`` arrays and
  the ``--onnx`` bytes equal JAX's; of the JZDL fixture `.so`
  (``models.jzdl_fixtures``): the layer table and the ``--extract-weights``
  `.npz` arrays equal JAX's; a `.so` with no JZDL network takes the `.mgk`
  route, as in JAX;
- ``quantize`` (``--device cpu``) of ``tiny_160_f32.mars`` and of its
  float32 ONNX export, from seeded random batches, ``--calib`` `.npy` and
  `.npz`, ``--images`` (PNG files through Pillow), ``--method mse`` and a
  given ``--percentile``: the printed line and the int8 `.mars` bytes equal
  JAX's;
- the subcommand not ported (``bench``) exits non-zero naming its ROADMAP
  item; without a card the default device raises.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from thingino_accel_tpu import cli as JCLI
from thingino_accel_tpu_torch import cli as CLI
from thingino_accel_tpu_torch.formats import onnx_export as X
from thingino_accel_tpu_torch.formats import onnx_proto as OP
from thingino_accel_tpu_torch.formats import onnx_writer as W
from thingino_accel_tpu_torch.models import mgk_fixtures as MF
from thingino_accel_tpu_torch.models import onnx_fixtures as F
from thingino_accel_tpu_torch.models import yolo as Y
from thingino_accel_tpu_torch.models import zoo
from thingino_accel_tpu_torch.runtime.engine import load_graph

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FIXTURE = os.path.join(REPO, "models", "fixtures", "test_conv.mars")
REAL = os.path.join(REPO, "models", "yolov5n_cal_int8.mars")
TINY_F32 = os.path.join(REPO, "models", "fixtures", "tiny_160_f32.mars")


def _out(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    assert rc == 0, argv
    return buf.getvalue().splitlines()


@pytest.mark.parametrize("model", [FIXTURE, REAL], ids=["fixture", "real"])
def test_summary_equals_jax(model):
    got = _out(CLI.main, ["summary", model])
    assert got == _out(JCLI.main, ["summary", model]) and got


@pytest.mark.parametrize("model,batch", [(FIXTURE, 2), (REAL, 1)],
                         ids=["fixture", "real"])
def test_run_outputs_equal_jax(model, batch):
    argv = ["run", model, "--batch", str(batch), "--iters", "1",
            "--seed", "3"]
    outputs = lambda lines: [ln for ln in lines if ln.startswith("output ")]
    got = _out(CLI.main, argv + ["--device", "cpu"])
    want = _out(JCLI.main, argv)
    assert outputs(got) == outputs(want) and outputs(got)
    assert got[0].startswith("Engine[exact, cpu]")


def test_run_from_npy_equals_jax(tmp_path):
    x = np.random.default_rng(4).integers(-128, 128, (3, 64, 64, 3),
                                          dtype=np.int8)
    path = str(tmp_path / "x.npy")
    np.save(path, x)
    argv = ["run", FIXTURE, "--input", path, "--iters", "1"]
    got = [ln for ln in _out(CLI.main, argv + ["--device", "cpu"])
           if ln.startswith("output ")]
    want = [ln for ln in _out(JCLI.main, argv) if ln.startswith("output ")]
    assert got == want and "shape=(3, 64, 64, 16)" in got[0]


def test_detect_equals_jax(tmp_path):
    img = np.random.default_rng(3).integers(0, 256, (360, 640, 3),
                                            dtype=np.uint8)
    npy, png = str(tmp_path / "f.npy"), str(tmp_path / "f.png")
    np.save(npy, img)
    from PIL import Image
    Image.fromarray(img).save(png)
    argv = ["detect", REAL, npy, "--conf", "0.001"]
    want = _out(JCLI.main, argv)
    got = _out(CLI.main, argv + ["--device", "cpu"])
    assert got == want
    assert int(got[0].split()[0]) == len(got) - 1 > 0
    assert _out(CLI.main, ["detect", REAL, png, "--conf", "0.001",
                           "--device", "cpu"]) == want


def _real_heads_onnx() -> bytes:
    g = load_graph(REAL)
    return X.ir_to_onnx(g.with_outputs(Y.find_detect_outputs(g)))


def _skipping_onnx() -> bytes:
    """A conv, then an op the importer skips (logged with ``-v``)."""
    w = np.random.default_rng(6).normal(size=(4, 3, 1, 1)).astype(np.float32)
    return W.build_model(
        nodes=[("Conv", ["x", "w"], ["c"], dict(kernel_shape=(1, 1))),
               ("Erf", ["c"], ["e"], None), ("Relu", ["e"], ["y"], None)],
        inputs={"x": ((1, 3, 8, 8), OP.TP_FLOAT)},
        outputs={"c": ((1, 4, 8, 8), OP.TP_FLOAT),
                 "y": ((1, 4, 8, 8), OP.TP_FLOAT)},
        initializers={"w": w})


COMPILE_CASES = {
    "f32-real-heads": (_real_heads_onnx, ["--float32"]),
    "qdq-yolov5n": (lambda: F.qdq_yolov5("n", zoo.ZooConfig(
        in_hw=(160, 160), w_scale=0.002)), []),
    "f32-skips-verbose": (_skipping_onnx, ["--float32", "-v", "--nhwc"]),
}


def _both(tmp_path, argv_of):
    """Run JAX's CLI and the port's on the same arguments, each writing
    its own file: (port's lines, JAX's lines, port's bytes, JAX's bytes);
    the file's path in the lines reads ``OUT``."""
    res = []
    for who, main in (("port", CLI.main), ("jax", JCLI.main)):
        out = str(tmp_path / f"{who}.out")
        lines = [ln.replace(out, "OUT") for ln in _out(main, argv_of(out))]
        res.append((lines, open(out, "rb").read()))
    (pl, pb), (jl, jb) = res
    return pl, jl, pb, jb


@pytest.mark.parametrize("case", COMPILE_CASES)
def test_compile_equals_jax(case, tmp_path):
    build, flags = COMPILE_CASES[case]
    src = str(tmp_path / "m.onnx")
    with open(src, "wb") as f:
        f.write(build())
    pl, jl, pb, jb = _both(tmp_path, lambda out: ["compile", "-i", src,
                                                  "-o", out] + flags)
    assert pb == jb and pl == jl and pl[-1] == "wrote OUT"
    if "-v" in flags:
        assert any("skipping unsupported op Erf" in ln for ln in pl)


@pytest.mark.parametrize("args", [[], ["--height", "24", "--width", "40",
                                       "--channels", "5",
                                       "--out-channels", "7", "--seed", "3"]],
                         ids=["default", "given"])
def test_gen_test_equals_jax(args, tmp_path):
    pl, jl, pb, jb = _both(tmp_path, lambda out: ["gen-test", "-o", out]
                           + args)
    assert pb == jb and pl == jl and pl[0].startswith("wrote OUT: 1 conv")


@pytest.mark.parametrize("model", [TINY_F32, FIXTURE],
                         ids=["tiny_160_f32", "test_conv"])
def test_export_onnx_equals_jax(model, tmp_path):
    pl, jl, pb, jb = _both(tmp_path, lambda out: ["export-onnx", "-i", model,
                                                  "-o", out])
    assert pb == jb and pl == jl and pl == [f"wrote OUT ({len(pb)} bytes)"]


def test_export_onnx_of_the_whole_real_file_raises_as_jax(tmp_path):
    argv = ["export-onnx", "-i", REAL, "-o", str(tmp_path / "r.onnx")]
    with pytest.raises(ValueError) as want:
        JCLI.main(argv)
    with pytest.raises(ValueError, match="unsupported op RESHAPE") as got:
        CLI.main(argv)
    assert str(got.value) == str(want.value)


MGK_FIXTURES = {
    "yolo": lambda: MF.build_yolo_mgk("n", in_hw=(64, 64),
                                      w_scale=0.0004)[0],
    "aec": lambda: MF.build_aec_mgk(0),
}


@pytest.mark.parametrize("which", MGK_FIXTURES)
def test_decompile_equals_jax(which, tmp_path):
    src = tmp_path / f"{which}.mgk"
    src.write_bytes(MGK_FIXTURES[which]())
    got = {}
    for who, main in (("port", CLI.main), ("jax", JCLI.main)):
        w, o = tmp_path / f"{who}_w", tmp_path / f"{who}.onnx"
        lines = _out(main, ["decompile", "-i", str(src),
                            "--extract-weights", str(w), "--onnx", str(o)])
        lines = [ln.replace(str(w), "W").replace(str(o), "O")
                 for ln in lines]
        arrays = {p.name: np.load(p) for p in sorted(w.iterdir())}
        got[who] = (lines, arrays, o.read_bytes())
    (pl, pa, po), (jl, ja, jo) = got["port"], got["jax"]
    assert pl == jl and pl[-2:] == ["weights -> W", "onnx -> O"]
    assert po == jo and list(pa) == list(ja) and "blob.npy" in pa
    for k in ja:
        assert pa[k].dtype == ja[k].dtype, k
        np.testing.assert_array_equal(pa[k], ja[k], err_msg=k)
    assert _out(CLI.main, ["decompile", "-i", str(src)]) == \
        _out(JCLI.main, ["decompile", "-i", str(src)])


def test_decompile_of_a_jzdl_so_names_its_item(tmp_path):
    """A `.so` that embeds no JZDL network goes to the `.mgk` inspector, as
    in JAX (the route is the loader's, not the file name's). The name is
    older than the route: the port once refused every `.so`, naming the
    ROADMAP item that would port JZDL."""
    so = tmp_path / "libpersonDet_inf.so"
    so.write_bytes(MF.build_elf32(b"jzdl\x00"))
    got = _out(CLI.main, ["decompile", "-i", str(so)])
    assert got == _out(JCLI.main, ["decompile", "-i", str(so)])
    assert got[0] == "{" and '  "weight_bytes": 0,' in got


@pytest.mark.parametrize("extract", [False, True])
def test_decompile_of_the_jzdl_fixture_equals_jax(extract, tmp_path):
    """The port's JZDL fixture `.so` (``models.jzdl_fixtures``), also under
    a `.mgk` name: the layer table and the ``--extract-weights`` arrays
    equal JAX's."""
    from thingino_accel_tpu_torch.models import jzdl_fixtures as JF
    so = tmp_path / "pd.mgk"
    so.write_bytes(JF.build_persondet_so(0))
    got = {}
    for who, main in (("port", CLI.main), ("jax", JCLI.main)):
        out = tmp_path / f"{who}.npz"
        argv = ["decompile", "-i", str(so)] + (
            ["--extract-weights", str(out)] if extract else [])
        lines = [ln.replace(str(out), "W") for ln in _out(main, argv)]
        got[who] = (lines, dict(np.load(out)) if extract else {})
    (pl, pa), (jl, ja) = got["port"], got["jax"]
    assert pl == jl and len(pl) == 33 + extract
    assert pl[0] == "jzdl embedded network: input 3x67x67, 32 layers, " \
                    "34 blobs"
    assert list(pa) == list(ja)
    for k in ja:
        assert pa[k].dtype == ja[k].dtype, k
        np.testing.assert_array_equal(pa[k], ja[k], err_msg=k)
    if extract:
        assert pa["L0_weights"].size == 432
        assert sum(v.size for k, v in pa.items()
                   if k.endswith("_weights")) == 926880


def _calib_files(tmp_path):
    """A float32 NHWC calibration array as `.npy` and `.npz`, and a folder
    of PNG frames (with a file that is no image)."""
    rng = np.random.default_rng(9)
    arr = rng.uniform(0, 1, (3, 160, 160, 3)).astype(np.float32)
    np.save(tmp_path / "calib.npy", arr)
    np.savez(tmp_path / "calib.npz", frames=arr[:2])
    from PIL import Image
    img = tmp_path / "imgs"
    img.mkdir()
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (120, 200, 3),
                                     dtype=np.uint8)).save(img / f"{i}.png")
    (img / "notes.txt").write_text("not an image")
    return tmp_path


QUANTIZE_CASES = {
    "mars-random": ("mars", ["--batches", "2"]),
    "mars-mse": ("mars", ["--batches", "2", "--method", "mse",
                          "--seed", "4"]),
    "onnx-npy": ("onnx", ["--calib", "{d}/calib.npy", "--batches", "5"]),
    "onnx-npz-pct": ("onnx", ["--calib", "{d}/calib.npz",
                              "--percentile", "99.5"]),
    "mars-images": ("mars", ["--images", "{d}/imgs", "--batches", "2"]),
}


@pytest.mark.parametrize("case", QUANTIZE_CASES)
def test_quantize_equals_jax(case, tmp_path):
    kind, flags = QUANTIZE_CASES[case]
    d = _calib_files(tmp_path)
    src = TINY_F32
    if kind == "onnx":
        src = str(tmp_path / "tiny.onnx")
        with open(src, "wb") as f:
            f.write(X.ir_to_onnx(load_graph(TINY_F32)))
    flags = [f.replace("{d}", str(d)) for f in flags]
    pl, jl, pb, jb = _both(tmp_path, lambda out: (
        ["quantize", "-i", src, "-o", out] + flags
        + (["--device", "cpu"] if out.endswith("port.out") else [])))
    assert pb == jb and pl == jl
    assert pl[0].startswith("wrote OUT (int8, input scale ")


@pytest.mark.parametrize("cmd,item", [("bench", "A.1")])
def test_unported_subcommands_name_their_item(cmd, item, capsys):
    assert CLI.main([cmd, "-i", "x"]) != 0
    err = capsys.readouterr().err
    assert "not ported" in err and f"ROADMAP.md {item}" in err


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CLI.main(["run", FIXTURE, "--iters", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CLI.main(["quantize", "-i", TINY_F32, "-o", "unused.mars"])
