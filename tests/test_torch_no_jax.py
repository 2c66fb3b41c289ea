"""The port stands alone: it runs where JAX is not installed (the GPU
machine lists none) and imports nothing of the JAX package.

- A fresh interpreter with ``jax`` and ``thingino_accel_tpu`` blocked
  imports the package, runs a `.mars` model on the CPU, builds the zoo
  yolov5n and nanodet and runs them through the planned serving tier,
  runs the exact tier in full and compat mode, and the KxK conv's
  ``pipeline="dma"`` mode (its plain version on the CPU) and plan.
- No module of the port and no line of ``chip_smoke.py`` holds an
  ``import`` of ``thingino_accel_tpu`` (parsed with ``ast``, so an import
  inside a function counts too).
"""

import ast
import os
import subprocess
import sys
import textwrap

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

SCRIPT = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None          # any `import jax` now raises
    sys.modules["thingino_accel_tpu"] = None   # and so does the JAX package
    import numpy as np
    import thingino_accel_tpu_torch
    from thingino_accel_tpu_torch import EngineOptions
    from thingino_accel_tpu_torch.models import yolo
    from thingino_accel_tpu_torch.runtime import serving
    from thingino_accel_tpu_torch.ops import cuda_build
    eng = thingino_accel_tpu_torch.Engine.from_mars(
        "models/fixtures/test_conv.mars", device="cpu")
    x = np.random.default_rng(0).integers(-128, 128, (2, 64, 64, 3),
                                          dtype=np.int8)
    out = eng.run_np(x)["output"]
    assert out.shape == (2, 64, 64, 16) and out.dtype == np.int8
    assert out.min() >= 0             # the conv's fused RELU
    from thingino_accel_tpu_torch.models import zoo
    from thingino_accel_tpu_torch.runtime import planner
    g = zoo.build_yolov5("n", zoo.ZooConfig(in_hw=(64, 64)))
    eng = thingino_accel_tpu_torch.Engine(g, device="cpu")
    assert eng._fn.plan is not None and eng._fn.plan.sppf
    heads = eng.run_np(np.zeros((1, 64, 64, 3), np.int8))
    assert [h.shape for h in heads.values()] == [
        (1, 8, 8, 255), (1, 4, 4, 255), (1, 2, 2, 255)]
    for mode in ("full", "compat"):
        ex = thingino_accel_tpu_torch.Engine(
            g, EngineOptions(precision="exact", mode=mode), device="cpu")
        assert ex._fn.launch_census() == {
            "matmul_int8_requant": 42, "conv2d_int8_halo": 11,
            "conv2d_int8": 7, "plain_convs": 0}
        got = ex.run_np(x[:1])
        assert [h.shape for h in got.values()] == [
            (1, 8, 8, 255), (1, 4, 4, 255), (1, 2, 2, 255)]
    eng = thingino_accel_tpu_torch.Engine(
        zoo.build_nanodet(zoo.ZooConfig(in_hw=(64, 64))), device="cpu")
    assert eng._fn.launch_census()["depthwise_conv2d_int8_fused"] == 6
    heads = eng.run_np(np.zeros((1, 64, 64, 3), np.int8))
    assert [h.shape for h in heads.values()] == [
        (1, 8, 8, 84), (1, 4, 4, 84), (1, 2, 2, 84)]
    from thingino_accel_tpu_torch.ops import decode_kernel
    from thingino_accel_tpu_torch.ops import fused_kernels as FK
    import torch
    xt = torch.from_numpy(x[:1, :16, :16])
    wt = torch.ones((8, 3, 3, 3), dtype=torch.int8)
    ep = FK.epilogue_rows(0.01, 0.05, 0.1, "RELU", 8)
    got = FK.conv2d_int8_halo_fused(xt, wt, None, ep, (8, 8),
                                    ((1, 1), (1, 1)), 2, pipeline="dma")
    assert torch.equal(got, FK.conv2d_int8_halo_fused(
        xt, wt, None, ep, (8, 8), ((1, 1), (1, 1)), 2))
    assert FK.dma_plan(16, 3, 32, 6, 6, 2, 320, 320,
                       FK.SmemLimits(132, 233472, 232448)).resident
    assert "conv_int8_dma.cu" in cuda_build.SOURCES
    assert sys.modules["jax"] is None
    assert sys.modules["thingino_accel_tpu"] is None
    print("ok")
""")


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def _imports_of(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_import_of_the_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO,
                                               "thingino_accel_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    bad = [(os.path.relpath(f, REPO), m) for f in files
           for m in _imports_of(f)
           if m.split(".")[0] in ("thingino_accel_tpu", "jax")]
    assert not bad, bad
