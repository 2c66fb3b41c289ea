"""``ops.quant``'s public helpers against JAX's (``thingino_accel_tpu.ops.
quant``), bit for bit: ``quantize`` at both round modes, ``dequantize``,
``combined_scale``, and the package exports of ``ops`` that JAX's has.

The inputs hold the values a rounding rule decides on: exact halves of
the scale (ties), values past the int8 range, zeros of both signs and
seeded normals; the scales include ones whose reciprocal is not exact,
where a multiply by the reciprocal would round ties the other way.
"""

import numpy as np
import pytest
import torch

import thingino_accel_tpu.ops as JOPS
from thingino_accel_tpu.ops import quant as JQ
from thingino_accel_tpu_torch import ops as OPS
from thingino_accel_tpu_torch.ops import quant as Q
from thingino_accel_tpu_torch.ops import requant_kernels as RK

SCALES = (0.05, 0.1, 1.0 / 3.0, 0.0137, 2.5, 1e-3)


def _values(scale: float) -> np.ndarray:
    s = np.float32(scale)
    halves = (np.arange(-300, 301, dtype=np.float32) + np.float32(0.5)) * s
    rng = np.random.default_rng(7)
    return np.concatenate([
        halves, np.arange(-300, 301, dtype=np.float32) * s,
        np.array([0.0, -0.0, 1e9, -1e9], np.float32),
        (rng.normal(size=2000) * 200 * s).astype(np.float32)])


@pytest.mark.parametrize("mode", list(Q.RoundMode))
@pytest.mark.parametrize("scale", SCALES)
def test_quantize_equals_jax(scale, mode):
    x = _values(scale)
    got = Q.quantize(torch.from_numpy(x), scale, mode)
    ref = JQ.quantize(x, scale, JQ.RoundMode(mode.value))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("scale", SCALES)
def test_dequantize_equals_jax(scale):
    q = np.arange(-128, 128, dtype=np.int8)
    got = Q.dequantize(torch.from_numpy(q), scale)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JQ.dequantize(q, scale)))


def test_combined_scale_equals_jax_and_is_the_exact_tiers():
    rng = np.random.default_rng(3)
    for in_s, w_s, out_s in rng.uniform(1e-4, 1.0, (200, 3)):
        want = JQ.combined_scale(in_s, w_s, out_s)
        assert Q.combined_scale(in_s, w_s, out_s) == want
    assert RK.combined_scale is Q.combined_scale


def test_ops_exports_the_helpers_as_jax():
    names = {"RoundMode", "requantize", "quantize", "dequantize"}
    assert names <= set(JOPS.__all__) and names <= set(OPS.__all__)
    assert OPS.quantize is Q.quantize and OPS.RoundMode is Q.RoundMode
    x = torch.arange(-40, 40, dtype=torch.int32)
    np.testing.assert_array_equal(
        OPS.requantize(x, 0.3).numpy(),
        np.asarray(JOPS.requantize(x.numpy(), 0.3)))
