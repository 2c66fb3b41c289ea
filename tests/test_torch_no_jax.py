"""The port runs where JAX is not installed (the GPU machine lists none):
a fresh interpreter with ``jax`` blocked imports the package, runs a
`.mars` model on the CPU, and builds the zoo yolov5n and nanodet and runs
them through the planned serving tier."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

SCRIPT = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None          # any `import jax` now raises
    import numpy as np
    import thingino_accel_tpu_torch
    from thingino_accel_tpu_torch.models import yolo
    from thingino_accel_tpu_torch.runtime import serving
    from thingino_accel_tpu_torch.ops import cuda_build
    eng = thingino_accel_tpu_torch.Engine.from_mars(
        "models/fixtures/test_conv.mars")
    x = np.random.default_rng(0).integers(-128, 128, (2, 64, 64, 3),
                                          dtype=np.int8)
    out = eng.run_np(x)["output"]
    assert out.shape == (2, 64, 64, 16) and out.dtype == np.int8
    assert out.min() >= 0             # the conv's fused RELU
    from thingino_accel_tpu_torch.models import zoo
    from thingino_accel_tpu_torch.runtime import planner
    g = zoo.build_yolov5("n", zoo.ZooConfig(in_hw=(64, 64)))
    eng = thingino_accel_tpu_torch.Engine(g)
    assert eng._fn.plan is not None and eng._fn.plan.sppf
    heads = eng.run_np(np.zeros((1, 64, 64, 3), np.int8))
    assert [h.shape for h in heads.values()] == [
        (1, 8, 8, 255), (1, 4, 4, 255), (1, 2, 2, 255)]
    eng = thingino_accel_tpu_torch.Engine(
        zoo.build_nanodet(zoo.ZooConfig(in_hw=(64, 64))))
    assert eng._fn.launch_census()["depthwise_conv2d_int8_fused"] == 6
    heads = eng.run_np(np.zeros((1, 64, 64, 3), np.int8))
    assert [h.shape for h in heads.values()] == [
        (1, 8, 8, 84), (1, 4, 4, 84), (1, 2, 2, 84)]
    from thingino_accel_tpu_torch.ops import decode_kernel
    assert sys.modules["jax"] is None
    print("ok")
""")


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
