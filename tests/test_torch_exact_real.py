"""The port's exact tier on the committed real-weight yolov5n
(``models/yolov5n_cal_int8.mars`` rewired to its three detect heads), at
batch 1, in full and compat mode, against the JAX exact engine.

Its 60 convs carry per-channel weight scales, so both packages run them
in the plain reference conv (the JAX executor sends them to XLA); the
port counts them as ``plain_convs``. Its SiLUs are SIGMOID+MUL pairs:
fused into SILU_FUSED in full mode, two requantized steps in compat mode.

Checked as ``tests/test_torch_exact.py`` checks the zoo: every node
teacher-forced (convs before their activation and every non-float step bit
for bit; SIGMOID/SILU_FUSED within 1 quantum on at most 0.1% of the
values), and the heads end to end, which were measured bit for bit in
both modes and so are held to that.
"""

import os

import numpy as np
import pytest

from thingino_accel_tpu.formats.mars import read_mars
from thingino_accel_tpu.ir.graph import from_mars
from thingino_accel_tpu.models import yolo as JY
from thingino_accel_tpu.runtime import Engine as JEngine
from thingino_accel_tpu.runtime import EngineOptions as JOptions

from test_torch_exact import _exact, check_nodes_teacher_forced

REAL_YOLO = os.path.join(os.path.dirname(__file__), "..", "models",
                         "yolov5n_cal_int8.mars")


@pytest.fixture(scope="module", params=["full", "compat"])
def real_case(request):
    mode = request.param
    g = from_mars(read_mars(REAL_YOLO))
    g = g.with_outputs(JY.find_detect_outputs(g))
    x = np.random.default_rng(9).integers(-128, 128, (1, 640, 640, 3),
                                          dtype=np.int8)
    jeng = JEngine(g, JOptions(precision="exact", mode=mode))
    return mode, g, jeng, x, jeng.trace(x), jeng.run_np(x)


def test_real_yolov5n_nodes_teacher_forced(real_case):
    mode, g, jeng, x, jacts, _ = real_case
    eng = _exact(g, mode)
    assert eng._fn.launch_census() == {
        "matmul_int8_requant": 0, "conv2d_int8_halo": 0, "conv2d_int8": 0,
        "plain_convs": 60}
    seen = check_nodes_teacher_forced(jeng, jacts, eng)
    pairs = ({"SILU_FUSED": 57} if mode == "full"
             else {"SIGMOID": 57, "MUL": 57})
    assert seen == {"CONV2D": 60, "CONCAT": 13, "ADD": 7, "MAXPOOL": 3,
                    "UPSAMPLE": 2, **pairs}


def test_real_yolov5n_heads_bit_exact(real_case):
    mode, g, _, x, _, ref = real_case
    eng = _exact(g, mode)
    out = eng.run_np(x)
    assert eng._fn.units == []   # no kernel: every conv is per-channel
    for k in g.outputs:
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    assert all(len(np.unique(v)) > 10 for v in out.values())
