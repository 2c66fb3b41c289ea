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
- the subcommands not ported exit non-zero naming their ROADMAP item;
  without a card the default device raises.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from thingino_accel_tpu import cli as JCLI
from thingino_accel_tpu_torch import cli as CLI

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FIXTURE = os.path.join(REPO, "models", "fixtures", "test_conv.mars")
REAL = os.path.join(REPO, "models", "yolov5n_cal_int8.mars")


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


@pytest.mark.parametrize("cmd,item", [
    ("compile", "A.4"), ("decompile", "A.4"), ("gen-test", "A.4"),
    ("quantize", "A.8"), ("export-onnx", "A.4"), ("bench", "A.1")])
def test_unported_subcommands_name_their_item(cmd, item, capsys):
    assert CLI.main([cmd, "-i", "x"]) != 0
    err = capsys.readouterr().err
    assert "not ported" in err and f"ROADMAP.md {item}" in err


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CLI.main(["run", FIXTURE, "--iters", "1"])
