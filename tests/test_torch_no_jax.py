"""The port runs where JAX is not installed (the GPU machine lists none):
a fresh interpreter with ``jax`` blocked imports the package and runs a
`.mars` model on the CPU."""

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
    assert sys.modules["jax"] is None
    print("ok")
""")


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
