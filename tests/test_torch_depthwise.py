"""Port vs JAX for the depthwise conv (``thingino_accel_tpu_torch.ops``):
kernel #7's plain version against the JAX ``depthwise_conv2d_int8_fused``
(its Pallas kernel in interpret mode), and the plain strided op the
serving tier uses at stride 2 against the JAX reference op.

On the CPU the port's wrapper takes its plain version (int32 taps, the
float32 epilogue). Tolerances, as for the other fused kernels:
NONE / RELU / LEAKY_RELU bit-exact; SILU at most 1 quantum on at most
0.1% of the elements (XLA's and torch's sigmoid differ by ulps).
"""

import zlib

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from thingino_accel_tpu.ops import fused_kernels as JFK
from thingino_accel_tpu.ops import reference as JR
from thingino_accel_tpu_torch.ops import fused_kernels as FK
from thingino_accel_tpu_torch.ops import reference as R

ACTS = ("NONE", "RELU", "LEAKY_RELU", "SILU")


@pytest.fixture(autouse=True)
def _interpret_mode():
    with pltpu.force_tpu_interpret_mode():
        yield


def _seed(*parts) -> int:
    return zlib.crc32(repr(parts).encode())


def _assert_close(port: np.ndarray, ref: np.ndarray, act: str):
    assert port.shape == ref.shape and port.dtype == ref.dtype == np.int8
    if act != "SILU":
        np.testing.assert_array_equal(port, ref)
        return
    d = np.abs(port.astype(np.int32) - ref.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())


def _case(rng, shape, k, s, per_channel):
    """Input, [KH, KW, C] weights, scales and pads of one depthwise conv
    with SAME-style explicit padding; the output scale keeps the results
    spread over the int8 range."""
    n, h, w, c = shape
    kh, kw = k
    x = rng.integers(-128, 128, shape, dtype=np.int8)
    wt = rng.integers(-128, 128, (kh, kw, c), dtype=np.int8)
    bias = rng.integers(-2000, 2000, c).astype(np.int32)
    ws = (rng.uniform(0.005, 0.015, c).astype(np.float32) if per_channel
          else 0.01)
    in_s, out_s = 0.02, float(0.0137 * np.sqrt(kh * kw) * 2)
    pt, pl = (kh - 1) // 2, (kw - 1) // 2
    oh, ow = (h + 2 * pt - kh) // s + 1, (w + 2 * pl - kw) // s + 1
    pads = R._conv_pads((h, w), (oh, ow), k, (s, s), (1, 1), "EXPLICIT",
                        (pt, pt, pl, pl))
    assert pads == JR._conv_pads((h, w), (oh, ow), k, (s, s), (1, 1),
                                 "EXPLICIT", (pt, pt, pl, pl))
    return x, wt, bias, ws, in_s, out_s, (oh, ow), pads


# (N, H, W, C, KH, KW): odd H/W, C = 24 (word path) and C = 37 (C % 4 != 0),
# an even and a non-square window
DW_SHAPES = [(2, 9, 11, 24, 3, 3), (1, 7, 13, 37, 3, 3),
             (2, 6, 5, 37, 2, 2), (1, 11, 9, 24, 5, 3)]


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", DW_SHAPES,
                         ids=lambda s: "n{}h{}w{}c{}k{}x{}".format(*s))
def test_depthwise_fused_matches_jax(act, per_channel, shape):
    n, h, w, c, kh, kw = shape
    rng = np.random.default_rng(_seed(act, per_channel, shape))
    x, wt, bias, ws, in_s, out_s, out_hw, pads = _case(
        rng, (n, h, w, c), (kh, kw), 1, per_channel)
    ref = np.asarray(JFK.depthwise_conv2d_int8_fused(
        x, wt, bias, out_hw, (1, 1), pads, in_s, ws, out_s, act, 0.1))
    ep = FK.epilogue_rows(ws, in_s, out_s, act, c, alpha=0.1)
    port = FK.depthwise_conv2d_int8_fused(
        torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(bias),
        ep, out_hw, pads).numpy()
    _assert_close(port, ref, act)
    if act == "NONE":   # without a bias too
        ref = np.asarray(JFK.depthwise_conv2d_int8_fused(
            x, wt, None, out_hw, (1, 1), pads, in_s, ws, out_s, act))
        port = FK.depthwise_conv2d_int8_fused(
            torch.from_numpy(x), torch.from_numpy(wt), None, ep, out_hw,
            pads).numpy()
        np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("c", [24, 37])
def test_strided_depthwise_plain_matches_jax(per_channel, c):
    """Stride 2, as the serving tier runs it outside the kernel: the
    reference op (HALF_AWAY requantize), then LEAKY_RELU on the int8
    value."""
    rng = np.random.default_rng(_seed("s2", per_channel, c))
    x, wt, bias, ws, in_s, out_s, out_hw, pads = _case(
        rng, (2, 9, 11, c), (3, 3), 2, per_channel)
    ref = np.asarray(JR.leaky_relu(JR.depthwise_conv2d_int8(
        x, wt, bias, out_hw, (2, 2), (1, 1), pads, in_s, ws, out_s), 0.1))
    port = R.leaky_relu(R.depthwise_conv2d_int8(
        torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(bias),
        out_hw, (2, 2), (1, 1), pads, in_s, ws, out_s), 0.1).numpy()
    assert port.shape == (2, 5, 6, c)
    np.testing.assert_array_equal(port, ref)
    assert len(np.unique(port)) > 50   # spread over the int8 range


def test_strided_depthwise_relu_matches_jax():
    rng = np.random.default_rng(3)
    x, wt, bias, ws, in_s, out_s, out_hw, pads = _case(
        rng, (1, 8, 8, 16), (3, 3), 2, True)
    ref = np.asarray(JR.depthwise_conv2d_int8(
        x, wt, bias, out_hw, (2, 2), (1, 1), pads, in_s, ws, out_s,
        relu=True))
    port = R.depthwise_conv2d_int8(
        torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(bias),
        out_hw, (2, 2), (1, 1), pads, in_s, ws, out_s, relu=True).numpy()
    np.testing.assert_array_equal(port, ref)


def test_leaky_relu_matches_jax():
    x = np.arange(-128, 128, dtype=np.int8).reshape(16, 16)
    for alpha in (0.01, 0.1, 0.37):
        np.testing.assert_array_equal(
            R.leaky_relu(torch.from_numpy(x), alpha).numpy(),
            np.asarray(JR.leaky_relu(x, alpha)))
    xf = np.random.default_rng(0).normal(0, 3, (64,)).astype(np.float32)
    np.testing.assert_array_equal(
        R.leaky_relu(torch.from_numpy(xf), 0.1).numpy(),
        np.asarray(JR.leaky_relu(xf, 0.1)))


def test_depthwise_wrapper_rejects_bad_weights():
    ep = FK.epilogue_rows(0.01, 0.02, 0.1, "NONE", 8)
    x = torch.zeros((1, 4, 4, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="KH, KW"):
        FK.depthwise_conv2d_int8_fused(
            x, torch.zeros((8, 1, 3, 3), dtype=torch.int8), None, ep, (4, 4),
            ((1, 1), (1, 1)))
