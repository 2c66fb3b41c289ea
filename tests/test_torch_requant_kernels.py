"""The exact tier's kernels #9-#11 (``ops.requant_kernels``, their plain
versions on CPU tensors) against the JAX package's Pallas kernels
``pallas_kernels.matmul_int8_requant`` / ``conv2d_int8_halo`` /
``conv2d_int8`` in interpret mode: bit for bit, on the shapes of
``tests/test_pallas.py`` (ragged M/N/K, no bias, 5x5, stride 2, 1x1/s2),
both RoundModes, RELU after the clamp, dilation 2 and stride (2, 1) (which
only #11 takes). The port's weights are OHWI ([N, K] for the matmul), the
JAX functions' HWIO ([K, N]).

The dispatch of ``conv2d_int8`` is held against the JAX one (which of the
three Pallas paths it calls), and the routing census of the zoo yolov5s
at 640 is counted from its shapes.
"""

import numpy as np
import pytest
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from thingino_accel_tpu.ops import pallas_kernels as PK
from thingino_accel_tpu.ops.quant import RoundMode as JRound
from thingino_accel_tpu.ops.quant import combined_scale as jax_combined_scale
from thingino_accel_tpu_torch import Engine, EngineOptions
from thingino_accel_tpu_torch.models import zoo
from thingino_accel_tpu_torch.ops import conv as C
from thingino_accel_tpu_torch.ops import fused_kernels as FK
from thingino_accel_tpu_torch.ops import requant_kernels as RK
from thingino_accel_tpu_torch.ops.quant import RoundMode

import torch

ROUND = {"half_away": (RoundMode.HALF_AWAY, JRound.HALF_AWAY),
         "plus_half": (RoundMode.PLUS_HALF_TRUNC, JRound.PLUS_HALF_TRUNC)}


@pytest.fixture(autouse=True)
def _interpret_mode():
    with pltpu.force_tpu_interpret_mode():
        yield


def _i8(rng, shape):
    return rng.integers(-128, 128, shape, dtype=np.int8)


def _bias(rng, n, use):
    return rng.integers(-3000, 3000, (n,), dtype=np.int32) if use else None


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _ohwi(w_hwio):
    return np.ascontiguousarray(np.transpose(w_hwio, (3, 0, 1, 2)))


@pytest.mark.parametrize("m,k,n,bias,rnd,relu", [
    (64, 96, 130, True, "half_away", False),     # test_pallas's shape
    (37, 50, 19, False, "half_away", False),     # ragged, no bias
    (200, 33, 255, True, "plus_half", False),
    (64, 128, 64, True, "half_away", True),
    (1, 3, 5, True, "plus_half", True),
])
def test_matmul_int8_requant_bit_exact(m, k, n, bias, rnd, relu):
    rng = np.random.default_rng(m + k + n)
    x, w, b = _i8(rng, (m, k)), _i8(rng, (k, n)), _bias(rng, n, bias)
    cs = 0.00037
    port_rm, jax_rm = ROUND[rnd]
    ref = np.asarray(PK.matmul_int8_requant(_j(x), _j(w), _j(b), cs, jax_rm,
                                            relu, block_m=32, block_n=128,
                                            block_k=64))
    got = RK.matmul_int8_requant(_t(x), _t(w.T), _t(b), cs, port_rm, relu)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got.dtype == torch.int8 and ((got >= 0).all() or not relu)


# (n, h, w, c, o, k, s): test_pallas's halo matrix, stride 2 included
HALO = [(1, 16, 16, 8, 16, 3, 1), (2, 17, 15, 4, 8, 3, 2),
        (1, 12, 12, 8, 8, 5, 1), (1, 9, 9, 16, 8, 1, 2)]


@pytest.mark.parametrize("shape", HALO, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("rnd,relu", [("half_away", False),
                                      ("plus_half", True)])
def test_conv2d_int8_halo_bit_exact(shape, rnd, relu):
    n, h, w, c, o, k, s = shape
    rng = np.random.default_rng(sum(shape))
    x, wt, b = _i8(rng, (n, h, w, c)), _i8(rng, (k, k, c, o)), \
        _bias(rng, o, True)
    pad = (k - 1) // 2
    oh, ow = (h + 2 * pad - k) // s + 1, (w + 2 * pad - k) // s + 1
    pads = ((pad, pad), (pad, pad))
    port_rm, jax_rm = ROUND[rnd]
    ref = np.asarray(PK.conv2d_int8_halo(
        _j(x), _j(wt), _j(b), (oh, ow), (s, s), pads, 0.05, 0.01, 0.04,
        jax_rm, relu, tile_h=4))
    got = RK.conv2d_int8_halo(_t(x), _t(_ohwi(wt)), _t(b), (oh, ow), (s, s),
                              pads, 0.05, 0.01, 0.04, port_rm, relu)
    np.testing.assert_array_equal(got.numpy(), ref)


# (x shape, k, stride, dilation, pads, bias, round, relu, JAX path)
CONV = [
    ((1, 8, 8, 32), 1, (1, 1), (1, 1), ((0, 0), (0, 0)), True, "half_away",
     False, "mm"),
    ((1, 10, 10, 8), 3, (1, 1), (1, 1), ((1, 1), (1, 1)), True, "half_away",
     False, "halo"),
    ((2, 9, 9, 4), 3, (2, 2), (1, 1), ((0, 0), (0, 0)), False, "half_away",
     True, "tap"),
    ((1, 12, 11, 6), 5, (1, 1), (1, 1), ((2, 2), (2, 2)), True, "plus_half",
     True, "halo"),
    ((1, 9, 9, 16), 1, (2, 2), (1, 1), ((0, 0), (0, 0)), True, "half_away",
     False, "tap"),
    ((1, 8, 8, 8), 1, (1, 1), (1, 1), ((1, 1), (1, 1)), True, "half_away",
     False, "halo"),                               # a padded 1x1: not #9
    ((2, 16, 15, 3), 6, (2, 2), (1, 1), ((2, 2), (2, 1)), True, "half_away",
     False, "tap"),                                # the 6x6/s2 stem
    ((1, 13, 12, 8), 3, (2, 2), (1, 1), ((0, 1), (1, 1)), True, "plus_half",
     False, "tap"),                                # SAME at s2: asymmetric
    ((1, 12, 12, 8), 3, (1, 1), (2, 2), ((2, 2), (2, 2)), True, "half_away",
     True, "tap"),                                 # dilation 2
    ((2, 11, 10, 5), 3, (2, 1), (1, 1), ((1, 1), (1, 1)), True, "plus_half",
     False, "tap"),                                # stride (2, 1)
]


def _out_hw(xs, k, s, d, pads):
    ek = [(k - 1) * d[i] + 1 for i in range(2)]
    return tuple((xs[1 + i] + pads[i][0] + pads[i][1] - ek[i]) // s[i] + 1
                 for i in range(2))


@pytest.mark.parametrize("case", CONV, ids=lambda c: (
    f"{c[0][1]}x{c[0][2]}x{c[0][3]}-k{c[1]}s{c[2][0]}{c[2][1]}"
    f"d{c[3][0]}-{c[6]}{'-relu' if c[7] else ''}"))
def test_conv2d_int8_bit_exact_and_routed_as_jax(case, monkeypatch):
    """The port's ``conv2d_int8`` equals the JAX Pallas ``conv2d_int8``
    bit for bit, and routes each case to the kernel JAX calls."""
    xs, k, s, d, pads, use_b, rnd, relu, jax_path = case
    rng = np.random.default_rng(xs[1] * 31 + k)
    o = 16
    x, wt, b = _i8(rng, xs), _i8(rng, (k, k, xs[3], o)), _bias(rng, o, use_b)
    out_hw = _out_hw(xs, k, s, d, pads)
    port_rm, jax_rm = ROUND[rnd]
    calls = []
    for name, path in (("matmul_int8_requant", "mm"),
                       ("conv2d_int8_halo", "halo"), ("_tapconv_call", "tap")):
        fn = getattr(PK, name)
        monkeypatch.setattr(PK, name, lambda *a, _f=fn, _p=path, **kw: (
            calls.append(_p), _f(*a, **kw))[1])
    args = (out_hw, s, d, pads, 0.05, 0.01, 0.04)
    ref = np.asarray(PK.conv2d_int8(_j(x), _j(wt), _j(b), *args, jax_rm,
                                    relu))
    assert calls == [jax_path]
    port_route = {"mm": "matmul_int8_requant", "halo": "conv2d_int8_halo",
                  "tap": "conv2d_int8"}[jax_path]
    assert RK.route((k, k), s, d, pads) == port_route
    got = RK.conv2d_int8(_t(x), _t(_ohwi(wt)), _t(b), *args, port_rm, relu)
    np.testing.assert_array_equal(got.numpy(), ref)
    plain = RK.conv2d_int8(_t(x), _t(_ohwi(wt)), _t(b), *args, port_rm, relu,
                           plain=True)
    np.testing.assert_array_equal(plain.numpy(), ref)


def test_combined_scale_on_the_host():
    """The combined scale is numpy f32, ``f32(f32(in * w) / out)``, the
    JAX package's ``quant.combined_scale``, on many drawn scales."""
    rng = np.random.default_rng(3)
    for in_s, w_s, out_s in rng.uniform(1e-3, 0.2, (200, 3)):
        assert RK.combined_scale(in_s, w_s, out_s) == jax_combined_scale(
            in_s, w_s, out_s)


def test_plain_versions_cover_each_rounding_rule():
    """HALF_AWAY and PLUS_HALF_TRUNC differ only on negative halves:
    PLUS_HALF_TRUNC truncates toward zero (-1.2 + 0.5 -> 0), and RELU
    comes after the clamp."""
    acc = torch.tensor([[-3, -2, -1, 1, 2, 3, 1000, -1000]], dtype=torch.int32)
    half = RK.requant_exact_plain(acc, None, 0.5, RoundMode.HALF_AWAY)
    trunc = RK.requant_exact_plain(acc, None, 0.5, RoundMode.PLUS_HALF_TRUNC)
    relu = RK.requant_exact_plain(acc, None, 0.5, RoundMode.HALF_AWAY, True)
    assert half.tolist() == [[-2, -1, -1, 1, 1, 2, 127, -128]]
    assert trunc.tolist() == [[-1, 0, 0, 1, 1, 2, 127, -128]]
    assert relu.tolist() == [[0, 0, 0, 1, 1, 2, 127, 0]]


def test_zoo_yolov5s_640_census_from_shapes():
    """The exact zoo yolov5s at 640 (per-tensor scales): 42 1x1 convs on
    #9, 11 3x3/s1 on #10, the 6x6/s2 stem and six 3x3/s2 on #11, no plain
    conv; each conv's route as ``ops.conv.route`` gives it."""
    g = zoo.build_yolov5("s", zoo.ZooConfig())
    eng = Engine(g, EngineOptions(precision="exact"), device="cpu")
    assert eng._fn.launch_census() == {
        "matmul_int8_requant": 42, "conv2d_int8_halo": 11, "conv2d_int8": 7,
        "plain_convs": 0}
    convs = [n for n in g.nodes if n.op == "CONV2D"]
    kinds = sorted((n.attrs["kernel"], n.attrs["stride"]) for n in convs
                   if C.route(n.attrs["kernel"], n.attrs["stride"], (1, 1),
                              ((0, 0), (0, 0)) if n.attrs["kernel"] == (1, 1)
                              else ((1, 1), (1, 1)), 0.01) == "conv2d_int8")
    assert kinds == [((3, 3), (2, 2))] * 6 + [((6, 6), (2, 2))]
    assert len(eng._fn.units) == 60


def test_kxk_convs_of_the_zoo_yolov5s_640():
    """``kxk_convs`` finds the 18 KxK convs a forward of the exact zoo
    yolov5s at 640 as 11 distinct shapes: 11 convs on #10, 7 on #11."""
    ks = RK.kxk_convs(zoo.build_yolov5("s", zoo.ZooConfig()))
    assert len(ks) == 11 and sum(k.count for k in ks) == 18
    assert sum(k.count for k in ks if k.kernel == "conv2d_int8_halo") == 11
    assert ks[0][:8] == ("conv2d_int8", 640, 640, 3, 32, 320, 320, (6, 6))


H100 = FK.SmemLimits(132, 233472, 232448)


@pytest.mark.parametrize("i", range(11))
def test_conv_requant_plan_of_each_yolov5s_kxk_conv(i):
    """At batch 16 on an H100's limits each KxK conv of the zoo yolov5s has
    a plan of every tile and channel block, within the opt-in: the stem in
    im2col mode at one 128-byte K chunk with its 32 channels in one block,
    the two 3x3/s2 convs of C = 256 (-> 512, -> 256) slab-mode C-chunked
    beside resident weights (the weights and a ring of slabs of all C do
    not fit together), the rest slab mode with C whole; the weights always
    resident."""
    k = RK.kxk_convs(zoo.build_yolov5("s", zoo.ZooConfig()))[i]
    mode = "im2col" if k.c == 3 else "slab"
    plans = RK.conv_requant_plans(16, k.oh, k.ow, k.c, k.o, *k.ksize[:2],
                                  k.stride, k.dilation, mode, H100)
    assert len(plans) == len(RK.CONV_TILES) * len(RK.CONV_BNS)
    for p in plans:
        smem = RK.conv_requant_smem(mode, k.c, *k.ksize, k.stride, k.dilation,
                                    p.tile_h, p.tile_w, p.bn, p.ck,
                                    p.resident)
        assert smem <= H100.per_block and 1 <= p.tiles_per_block
        assert p.resident
    best = plans[0]
    assert best == RK.conv_requant_plan(16, k.oh, k.ow, k.c, k.o, *k.ksize,
                                        k.stride, k.dilation, mode, H100)
    if k.c == 3:
        assert best.bn == 32 and best.ck == 3
    elif (k.c, k.stride) == (256, (2, 2)):
        assert all(p.ck < k.c for p in plans)
    else:
        assert best.ck == k.c
