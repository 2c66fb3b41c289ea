"""Port vs JAX for the serving tier's fused int8 convs and the reference
ops of the slice (``thingino_accel_tpu_torch.ops``).

On the CPU the port's wrappers take their plain versions (float64
accumulation, float32 epilogue); the JAX side runs its Pallas kernels in
interpret mode, as the JAX package's own tests do.

Tolerances:
- NONE / RELU / LEAKY_RELU: bit-exact (integer accumulation, the same
  float32 epilogue operations in the same order).
- SILU: at most 1 quantum on at most 0.1% of the elements. XLA's and
  torch's sigmoid differ by ulps, which flips a value only where it sits
  on a rounding tie.
"""

import zlib

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from thingino_accel_tpu.ops import fused_kernels as JFK
from thingino_accel_tpu.ops import quant as JQ
from thingino_accel_tpu.ops import reference as JR
from thingino_accel_tpu_torch.ops import fused_kernels as FK
from thingino_accel_tpu_torch.ops import quant as Q
from thingino_accel_tpu_torch.ops import reference as R

ACTS = ("NONE", "RELU", "LEAKY_RELU", "SILU")


@pytest.fixture(autouse=True)
def _interpret_mode():
    with pltpu.force_tpu_interpret_mode():
        yield


def _seed(*parts) -> int:
    return zlib.crc32(repr(parts).encode())


def assert_act_close(port: np.ndarray, ref: np.ndarray, act: str):
    """The module's stated tolerance (see the docstring)."""
    assert port.shape == ref.shape and port.dtype == ref.dtype
    if act != "SILU":
        np.testing.assert_array_equal(port, ref)
        return
    d = np.abs(port.astype(np.int32) - ref.astype(np.int32))
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() <= 1e-3, (d > 0).mean()


def _case(rng, ktot: int, o: int, per_channel: bool):
    """Scales that keep the pre-activation in SiLU's curved range and the
    requantized outputs spread over the int8 range."""
    in_scale = 0.01
    ws = (rng.uniform(0.005, 0.015, o).astype(np.float32) if per_channel
          else 0.01)
    out_scale = float(0.0137 * np.sqrt(ktot))
    bias = rng.integers(-2000, 2000, o).astype(np.int32)
    return in_scale, ws, out_scale, bias


def _port_ep(ws, in_scale, out_scale, act, o, alpha=0.1):
    return FK.epilogue_rows(ws, in_scale, out_scale, act, o, alpha=alpha)


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("m,k,n", [(50, 48, 16), (37, 16, 255)])
def test_matmul_int8_fused_matches_jax(act, per_channel, m, k, n):
    rng = np.random.default_rng(_seed(act, per_channel, m))
    x = rng.integers(-128, 128, (m, k), dtype=np.int8)
    w = rng.integers(-128, 128, (k, n), dtype=np.int8)   # JAX [K, N]
    in_s, ws, out_s, bias = _case(rng, k, n, per_channel)
    ref = np.asarray(JFK.matmul_int8_fused(
        x, w, bias, in_s, ws, out_s, act, 0.1))
    port = FK.matmul_int8_fused(
        torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(w.T)),
        torch.from_numpy(bias), _port_ep(ws, in_s, out_s, act, n)).numpy()
    assert_act_close(port, ref, act)


# (kernel, stride, C, O, H, W): odd sizes, the 255-channel heads, the
# thin stem (C=3) and asymmetric stride-2 pads
HALO_SHAPES = [
    (3, 1, 16, 16, 9, 11),
    (3, 2, 48, 255, 13, 10),
    (6, 2, 3, 16, 16, 15),
    (1, 2, 16, 16, 7, 8),
]


def _halo_case(rng, kk, s, c, o, h, w, per_channel, explicit=None):
    x = rng.integers(-128, 128, (2, h, w, c), dtype=np.int8)
    w_hwio = rng.integers(-128, 128, (kk, kk, c, o), dtype=np.int8)
    pad = (kk - 1) // 2 if explicit is None else explicit
    oh, ow = (h + 2 * pad - kk) // s + 1, (w + 2 * pad - kk) // s + 1
    pads = JR._conv_pads((h, w), (oh, ow), (kk, kk), (s, s), (1, 1),
                         "EXPLICIT", (pad, pad, pad, pad))
    assert pads == R._conv_pads((h, w), (oh, ow), (kk, kk), (s, s), (1, 1),
                                "EXPLICIT", (pad, pad, pad, pad))
    return (x, w_hwio, (oh, ow), pads) + _case(rng, kk * kk * c, o,
                                                per_channel)


def _ohwi(w_hwio):
    return torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 0, 1, 2)))


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", HALO_SHAPES, ids=lambda s: "k{}s{}c{}o{}".format(*s))
def test_conv2d_int8_halo_fused_matches_jax(act, per_channel, shape):
    kk, s, c, o, h, w = shape
    rng = np.random.default_rng(_seed(act, per_channel, shape))
    x, w_hwio, out_hw, pads, in_s, ws, out_s, bias = _halo_case(
        rng, kk, s, c, o, h, w, per_channel)
    ref = np.asarray(JFK.conv2d_int8_halo_fused(
        x, w_hwio, bias, out_hw, pads, in_s, ws, out_s, act, 0.1, stride=s))
    port = FK.conv2d_int8_halo_fused(
        torch.from_numpy(x), _ohwi(w_hwio), torch.from_numpy(bias),
        _port_ep(ws, in_s, out_s, act, o), out_hw, pads, s).numpy()
    assert_act_close(port, ref, act)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", [
    (1, 1, 48, 255, 6, 7),      # matmul route
    (6, 2, 3, 16, 16, 16),      # JAX: XLA bf16 stem; port: conv kernel
    (3, 2, 16, 48, 11, 11),     # halo route, stride 2
], ids=["1x1", "stem", "3x3s2"])
def test_conv2d_int8_fused_dispatch_matches_jax(act, shape):
    kk, s, c, o, h, w = shape
    rng = np.random.default_rng(_seed(act, shape))
    x, w_hwio, out_hw, pads, in_s, ws, out_s, bias = _halo_case(
        rng, kk, s, c, o, h, w, per_channel=True)
    ref = np.asarray(JFK.conv2d_int8_fused(
        x, w_hwio, bias, out_hw, (s, s), (1, 1), pads, in_s, ws, out_s,
        act, 0.1))
    port = FK.conv2d_int8_fused(
        torch.from_numpy(x), _ohwi(w_hwio), torch.from_numpy(bias),
        _port_ep(ws, in_s, out_s, act, o), out_hw, (s, s), (1, 1),
        pads).numpy()
    assert_act_close(port, ref, act)


def test_dispatch_rejects_what_jax_rejects():
    x = torch.zeros((1, 8, 8, 16), dtype=torch.int8)
    w = torch.zeros((16, 3, 3, 16), dtype=torch.int8)
    ep = FK.epilogue_rows(0.01, 0.05, 0.05, "NONE", 16)
    with pytest.raises(ValueError, match="dilation"):
        FK.conv2d_int8_fused(x, w, None, ep, (8, 8), (1, 1), (2, 2),
                             ((1, 1), (1, 1)))
    with pytest.raises(ValueError, match="square"):
        FK.conv2d_int8_fused(x, w, None, ep, (8, 4), (1, 2), (1, 1),
                             ((1, 1), (1, 1)))
    with pytest.raises(ValueError, match="activation"):
        FK.epilogue_rows(0.01, 0.05, 0.05, "GELU", 16)


def test_cpu_wrappers_count_no_launch():
    """On CPU tensors the wrappers take the plain versions: no launch."""
    FK.reset_launches()
    x = torch.zeros((4, 16), dtype=torch.int8)
    ep = FK.epilogue_rows(0.01, 0.05, 0.05, "RELU", 8)
    FK.matmul_int8_fused(x, torch.zeros((8, 16), dtype=torch.int8), None, ep)
    assert FK.launches == {"matmul_int8_fused": 0,
                           "conv2d_int8_halo_fused": 0}


# ---------------------------------------------------------------------------
# Reference ops of the slice, bit-exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["HALF_AWAY", "PLUS_HALF_TRUNC"])
def test_round_to_int_and_clamp_match_jax(mode):
    # ties at +-0.5, +-1.5, values past the int8 range
    x = np.concatenate([np.arange(-300, 300, 0.25, dtype=np.float32),
                        np.random.default_rng(8).normal(0, 90, 4000)
                        .astype(np.float32)])
    ref = np.asarray(JQ.clamp_i8(JQ.round_to_int(x, JQ.RoundMode[mode])))
    port = Q.clamp_i8(Q.round_to_int(torch.from_numpy(x),
                                     Q.RoundMode[mode])).numpy()
    np.testing.assert_array_equal(port, ref)


def test_add_q_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.integers(-128, 128, (2, 9, 7, 32), dtype=np.int8)
    b = rng.integers(-128, 128, (2, 9, 7, 32), dtype=np.int8)
    args = (0.0472, 0.0391, 0.0613)
    ref = np.asarray(JR.add_q(a, b, *args))
    port = R.add_q(torch.from_numpy(a), torch.from_numpy(b), *args).numpy()
    np.testing.assert_array_equal(port, ref)


def test_maxpool_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.integers(-128, 128, (2, 10, 9, 8), dtype=np.int8)
    ref = np.asarray(JR.maxpool(x, (5, 5), (1, 1), (10, 9),
                                ((2, 2), (2, 2))))
    port = R.maxpool(torch.from_numpy(x), (5, 5), (1, 1), (10, 9),
                     ((2, 2), (2, 2))).numpy()
    np.testing.assert_array_equal(port, ref)


def test_concat_matches_jax():
    rng = np.random.default_rng(5)
    xs = [rng.integers(-128, 128, (2, 5, 6, c), dtype=np.int8)
          for c in (8, 16, 4)]
    ref = np.asarray(JR.concat(xs, 3))
    port = R.concat([torch.from_numpy(x) for x in xs], 3).numpy()
    np.testing.assert_array_equal(port, ref)


def test_upsample_nearest_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.integers(-128, 128, (2, 5, 4, 8), dtype=np.int8)
    ref = np.asarray(JR.upsample_nearest(x, (2, 2), (9, 8)))
    port = R.upsample_nearest(torch.from_numpy(x), (2, 2), (9, 8)).numpy()
    np.testing.assert_array_equal(port, ref)
