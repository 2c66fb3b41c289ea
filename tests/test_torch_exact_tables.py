"""The exact tier's conv activations as 256-entry tables
(``runtime.executor.act_table``), against the JAX package.

- Each table equals the JAX ``_apply_fused_act`` on all 256 int8 inputs,
  bit for bit, for every activation beyond RELU, at every act scale of
  the exact zoo yolov5s at 640 and at every conv output scale of the real
  yolov5n (``models/yolov5n_cal_int8.mars``, whose convs carry no fused
  act: its SiLUs follow them at those scales) and NanoDet-320 (its convs'
  LEAKY_RELU). Where a float function decides a value (SILU, SIGMOID,
  TANH, HARD_SWISH) torch's and XLA's could differ by an ulp; no value
  differed when this was measured, so none may.
- The exact schedule: no ``ActStep`` after a kernel conv (the kernel
  applies the table in its epilogue), so the zoo yolov5s at 640 has 85
  steps and 57 tables; a plain (per-channel) conv keeps its gather step.
- The table gather equals ``apply_fused_act`` on a large tensor, its
  ragged tail included.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thingino_accel_tpu.formats.mars import read_mars
from thingino_accel_tpu.ir.graph import QuantInfo, TensorInfo, from_mars
from thingino_accel_tpu.models import zoo as JZ
from thingino_accel_tpu.runtime import executor as JEX
from thingino_accel_tpu_torch.ir.graph import graph_from_jax
from thingino_accel_tpu_torch.ops import requant_kernels as RK
from thingino_accel_tpu_torch.runtime.engine import Engine, EngineOptions
from thingino_accel_tpu_torch.runtime.executor import (TABLE_ACTS, ActStep,
                                                       ExactConvUnit,
                                                       act_table,
                                                       apply_fused_act)

MODELS = os.path.join(os.path.dirname(__file__), "..", "models")


def _conv_scales(g, acts=None):
    """The output scales of the graph's CONV2D nodes (of those whose act is
    in ``acts``, where given)."""
    return sorted({float(g.tensors[n.outputs[0]].quant.scale)
                   for n in g.nodes if n.op == "CONV2D"
                   and (acts is None or n.attrs.get("activation", "NONE")
                        in acts)})


@pytest.fixture(scope="module")
def act_scales():
    zoo_s = JZ.build_yolov5("s", JZ.ZooConfig())
    real = from_mars(read_mars(os.path.join(MODELS, "yolov5n_cal_int8.mars")))
    nanodet = from_mars(read_mars(os.path.join(MODELS, "nanodet_320.mars")))
    scales = {"zoo yolov5s": _conv_scales(zoo_s, TABLE_ACTS),
              "real yolov5n": _conv_scales(real),
              "nanodet": _conv_scales(nanodet, ("LEAKY_RELU",))}
    assert scales["zoo yolov5s"] and len(scales["real yolov5n"]) > 10
    return scales


@pytest.mark.parametrize("act", TABLE_ACTS)
def test_table_equals_jax_fused_act(act_scales, act):
    q = np.arange(-128, 128).astype(np.int8)
    n = 0
    for model, scales in act_scales.items():
        for sc in scales:
            out_t = TensorInfo("y", q.shape, np.dtype(np.int8), QuantInfo(sc))
            ref = np.asarray(JEX._apply_fused_act(jnp.asarray(q), act, out_t,
                                                  False, alpha=0.1))
            lut = act_table(act, sc, alpha=0.1)
            assert lut.dtype == torch.int8 and tuple(lut.shape) == (256,)
            np.testing.assert_array_equal(lut.numpy(), ref,
                                          err_msg=f"{act} {model} {sc}")
            n += 1
    assert n > 20


@pytest.mark.parametrize("act", TABLE_ACTS)
def test_table_gather_equals_the_act(act):
    """``apply_table`` with the act's table equals ``apply_fused_act`` on
    409,607 int8 values (a ragged length) at three scales; NONE and RELU
    take no table."""
    x = torch.from_numpy(np.random.default_rng(2).integers(
        -128, 128, 409_607, dtype=np.int8))
    for sc in (0.0071, 0.05, 0.31):
        lut = act_table(act, sc, alpha=0.1)
        assert torch.equal(RK.apply_table(x, lut),
                           apply_fused_act(x, act, sc, alpha=0.1))
    assert act_table("NONE", 0.05) is None and act_table("RELU", 0.05) is None


def test_exact_schedule_has_no_act_step_after_a_kernel_conv():
    """The exact zoo yolov5s at 640: 60 kernel convs, 57 of them SILU, each
    with its table and none followed by an ``ActStep``: 142 steps become
    85. Compat mode builds no table."""
    g = graph_from_jax(JZ.build_yolov5("s", JZ.ZooConfig()))
    ex = Engine(g, EngineOptions(precision="exact"), device="cpu")._fn
    assert len(ex.steps) == 85 and len(ex.tables) == 57
    assert not any(isinstance(s, ActStep) for s in ex.steps)
    units = [s for s in ex.steps if isinstance(s, ExactConvUnit)]
    assert len(units) == 60 and all(u.is_kernel for u in units)
    assert sum(u.lut is not None for u in units) == 57
    for u in units:
        if u.lut is not None:
            assert u.node.attrs["activation"] == "SILU"
            assert torch.equal(u.lut, act_table("SILU", ex.scale(u.out)))
    compat = Engine(g, EngineOptions(precision="exact", mode="compat"),
                    device="cpu")._fn
    assert compat.tables == {} and len(compat.steps) == 85


def test_plain_conv_keeps_its_table_step():
    """A conv with per-channel weight scales runs in the plain op, so its
    activation stays a step after it: the gather through its table, equal
    to ``apply_fused_act`` on the conv's output."""
    g = JZ.build_yolov5("n", JZ.ZooConfig(in_hw=(64, 64)))
    node = next(n for n in g.nodes if n.op == "CONV2D"
                and n.attrs.get("activation") == "SILU")
    wt = g.tensors[node.inputs[1]]
    o = g.tensors[node.outputs[0]].shape[3]
    wt.channel_scales = np.full(o, wt.quant.scale, np.float32)
    ex = Engine(graph_from_jax(g), EngineOptions(precision="exact"),
                device="cpu")._fn
    i = next(i for i, s in enumerate(ex.steps)
             if isinstance(s, ExactConvUnit) and s.out == node.outputs[0])
    unit, step = ex.steps[i], ex.steps[i + 1]
    assert not unit.is_kernel and unit.lut is None
    assert isinstance(step, ActStep) and step.out == unit.out
    assert ex.launch_census()["plain_convs"] == 1
    x = torch.from_numpy(np.random.default_rng(4).integers(
        -128, 128, (2, 17, 5), dtype=np.int8))
    env = {unit.out: x}
    step.run(env)
    assert torch.equal(env[unit.out],
                       apply_fused_act(x, "SILU", ex.scale(unit.out)))
