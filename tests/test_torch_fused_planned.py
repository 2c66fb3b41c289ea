"""The planned tier's kernels, port vs JAX: ``matmul_int8_fused_multi``,
``bottleneck_int8_fused``, ``sppf_int8_fused`` and the residual mode of
``matmul_int8_fused`` / ``conv2d_int8_halo_fused`` (the fold-1 computation
of the JAX ``conv2d_int8_folded(residual=...)``).

On the CPU the port's wrappers take their plain versions; the JAX side
runs its Pallas kernels in interpret mode. Tolerance: NONE / RELU /
LEAKY_RELU bit-exact; SILU at most 1 quantum on at most 0.1% of the
elements (XLA's and torch's sigmoid differ by ulps). LEAKY_RELU takes no
residual in either package.
"""

import zlib

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from thingino_accel_tpu.ops import fused_kernels as JFK
from thingino_accel_tpu_torch.ops import fused_kernels as FK

ACTS = ("NONE", "RELU", "LEAKY_RELU", "SILU")
# (activation, with residual): LEAKY_RELU takes none in either package
ACT_RES = [(a, r) for a in ACTS for r in (False, True)
           if not (r and a == "LEAKY_RELU")]
ALPHA = 0.1


@pytest.fixture(autouse=True)
def _interpret_mode():
    with pltpu.force_tpu_interpret_mode():
        yield


def _rng(*parts):
    return np.random.default_rng(zlib.crc32(repr(parts).encode()))


def _i8(rng, shape):
    return rng.integers(-128, 128, shape, dtype=np.int8)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def assert_act_close(port: np.ndarray, ref: np.ndarray, act: str):
    assert port.shape == ref.shape and port.dtype == ref.dtype
    if act != "SILU":
        np.testing.assert_array_equal(port, ref)
        return
    d = np.abs(port.astype(np.int32) - ref.astype(np.int32))
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() <= 1e-3, (d > 0).mean()


# ---------------------------------------------------------------------------
# matmul_int8_fused_multi
# ---------------------------------------------------------------------------

MULTI_PARTS = {1: (48,), 2: (32, 24), 4: (40, 40, 40, 40)}


@pytest.mark.parametrize("scales", ["equal", "different"])
@pytest.mark.parametrize("n_parts", [1, 2, 4])
@pytest.mark.parametrize("act,residual", ACT_RES)
def test_multi_matches_jax(act, residual, n_parts, scales):
    rng = _rng("multi", act, n_parts, scales, residual)
    m, n = 77, 40
    ks = MULTI_PARTS[n_parts]
    xs = [_i8(rng, (m, k)) for k in ks]
    ws = [_i8(rng, (k, n)) for k in ks]          # JAX [K_i, N]
    bias = rng.integers(-2000, 2000, n).astype(np.int32)
    wsc = rng.uniform(0.005, 0.015, n).astype(np.float32)
    if scales == "equal":
        in_scales, bias_scale = [0.05] * n_parts, None
    else:
        in_scales = [float(s) for s in rng.uniform(0.03, 0.07, n_parts)]
        bias_scale = 0.045
    out_s = float(0.0137 * np.sqrt(sum(ks)) * 5)
    res = _i8(rng, (m, n)) if residual else None
    res_scale = 0.061
    ref = np.asarray(JFK.matmul_int8_fused_multi(
        xs, ws, bias, in_scales, wsc, out_s, act, ALPHA, residual=res,
        res_scale=res_scale, bias_scale=bias_scale))
    me = FK.multi_epilogue(wsc, in_scales, out_s, act, n, ALPHA,
                           bias_scale=bias_scale)
    assert me.same_scale == (scales == "equal")
    # the port's weights are [N, K_i] column slices of one [N, sum K] matrix
    wfull = _t(np.concatenate(ws, 0).T)
    offs = np.cumsum((0,) + ks)
    port = FK.matmul_int8_fused_multi(
        [_t(x) for x in xs], [wfull[:, a:b] for a, b in zip(offs, offs[1:])],
        _t(bias), me, _t(res) if residual else None,
        FK.res_scale_multi(res_scale, out_s, act)).numpy()
    assert_act_close(port, ref, act)


def test_multi_rejects_what_it_cannot_run():
    x = torch.zeros((4, 8), dtype=torch.int8)
    w = torch.zeros((3, 8), dtype=torch.int8)
    me = FK.multi_epilogue(0.01, [0.05] * 5, 0.1, "NONE", 3)
    with pytest.raises(ValueError, match="parts"):
        FK.matmul_int8_fused_multi([x] * 5, [w] * 5, None, me)
    leaky = FK.multi_epilogue(0.01, [0.05], 0.1, "LEAKY_RELU", 3)
    with pytest.raises(ValueError, match="LEAKY"):
        FK.matmul_int8_fused_multi([x], [w], None, leaky,
                                   torch.zeros((4, 3), dtype=torch.int8))


# ---------------------------------------------------------------------------
# bottleneck_int8_fused
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("act,shortcut", ACT_RES)
def test_bottleneck_matches_jax(act, shortcut):
    """f = 1, H = 11 over JAX row tiles of 4 (the last tile ragged), a
    non-zero bias so that positions outside the image would show if they
    held epilogue(bias) instead of the quantized zero."""
    rng = _rng("bneck", act, shortcut)
    nb, h, w, c, cm, k = 2, 11, 7, 24, 16, 3
    o = c
    x = _i8(rng, (nb, h, w, c))
    w1 = _i8(rng, (1, 1, c, cm))
    w2 = _i8(rng, (k, k, cm, o))
    b1 = rng.integers(500, 3000, cm).astype(np.int32)
    b2 = rng.integers(-2000, 2000, o).astype(np.int32)
    ws1 = rng.uniform(0.005, 0.015, cm).astype(np.float32)
    ws2 = rng.uniform(0.005, 0.015, o).astype(np.float32)
    in_s, m_s = 0.05, 0.09
    out_s = float(0.0137 * np.sqrt(k * k * cm) * 5)
    ref = np.asarray(JFK.bottleneck_int8_fused(
        x, w1, b1, ws1, m_s, w2, b2, ws2, out_s, in_s, (h, w), f=1,
        act1=act, act2=act, alpha1=ALPHA, alpha2=ALPHA, shortcut=shortcut,
        tile_h=4))
    ep1 = FK.epilogue_rows(ws1, in_s, m_s, act, cm, ALPHA)
    ep2 = FK.epilogue_rows(ws2, m_s, out_s, act, o, ALPHA)
    port = FK.bottleneck_int8_fused(
        _t(x), _t(w1.reshape(c, cm).T), _t(b1), ep1,
        _t(w2.transpose(3, 0, 1, 2)), _t(b2), ep2, shortcut,
        FK.res_scale_bneck(in_s, out_s, act)).numpy()
    assert_act_close(port, ref, act)


# ---------------------------------------------------------------------------
# sppf_int8_fused
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("negative", [False, True])
@pytest.mark.parametrize("act", ACTS)
def test_sppf_matches_jax(act, negative):
    """k = 5, C = 40 (not a multiple of 128); ``negative`` makes every
    input value negative, so the -128 padding of the pools is what an
    edge window sees besides the image."""
    rng = _rng("sppf", act, negative)
    nb, h, w, c, o, k = 2, 6, 9, 40, 24, 5
    x = (rng.integers(-128, 0, (nb, h, w, c), dtype=np.int8) if negative
         else _i8(rng, (nb, h, w, c)))
    wt = _i8(rng, (1, 1, 4 * c, o))
    bias = rng.integers(-2000, 2000, o).astype(np.int32)
    wsc = rng.uniform(0.005, 0.015, o).astype(np.float32)
    in_s, out_s = 0.05, float(0.0137 * np.sqrt(4 * c) * 5)
    ref = np.asarray(JFK.sppf_int8_fused(
        x, wt, bias, k, in_s, wsc, out_s, act, ALPHA))
    ep = FK.epilogue_rows(wsc, in_s, out_s, act, o, ALPHA)
    port = FK.sppf_int8_fused(_t(x), _t(wt.reshape(4 * c, o).T), _t(bias),
                              ep, k).numpy()
    assert_act_close(port, ref, act)


# ---------------------------------------------------------------------------
# residual mode of #1 / #2 == the JAX conv2d_int8_folded at f = 1
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("act", ["NONE", "RELU", "SILU"])
@pytest.mark.parametrize("kk,s", [(1, 1), (3, 1), (3, 2)],
                         ids=["1x1", "3x3s1", "3x3s2"])
def test_folded_residual_matches_jax(act, kk, s):
    """1x1 goes to the JAX multi-part matmul with one part (the port's
    #1 with a residual), KxK to its halo kernel (the port's #2)."""
    rng = _rng("folded", act, kk, s)
    nb, h, w, c, o = 2, 9, 8, 24, 20
    p = (kk - 1) // 2
    oh, ow = (h + 2 * p - kk) // s + 1, (w + 2 * p - kk) // s + 1
    pads = ((p, max(0, (oh - 1) * s + kk - h - p)),
            (p, max(0, (ow - 1) * s + kk - w - p)))
    x = _i8(rng, (nb, h, w, c))
    wt = _i8(rng, (kk, kk, c, o))
    bias = rng.integers(-2000, 2000, o).astype(np.int32)
    wsc = rng.uniform(0.005, 0.015, o).astype(np.float32)
    res = _i8(rng, (nb, oh, ow, o))
    in_s, res_s = 0.05, 0.043
    out_s = float(0.0137 * np.sqrt(kk * kk * c) * 5)
    # the JAX kernel takes its input W-folded by the stride (g = s * f)
    ref = np.asarray(JFK.conv2d_int8_folded(
        x.reshape(nb, h, w // s, s * c), wt, bias, (oh, ow), s, pads, in_s,
        wsc, out_s, act, ALPHA, f_out=1, residual=res, res_scale=res_s))
    ep = FK.epilogue_rows(wsc, in_s, out_s, act, o, ALPHA)
    port = FK.conv2d_int8_fused(
        _t(x), _t(wt.transpose(3, 0, 1, 2)), _t(bias), ep, (oh, ow), (s, s),
        (1, 1), pads, residual=_t(res),
        res_scale=FK.res_scale_folded(res_s, out_s, act)).numpy()
    assert_act_close(port, ref, act)


def test_residual_rules():
    """The three effective-scale rules: divided by the out scale on the
    linear activations (NONE/RELU; LEAKY too for the matmul and the folded
    conv, never fused), kept for SILU."""
    for act in ("NONE", "RELU"):
        for rule in (FK.res_scale_multi, FK.res_scale_bneck,
                     FK.res_scale_folded):
            assert rule(0.3, 0.2, act) == float(np.float32(0.3)
                                                / np.float32(0.2))
    for rule in (FK.res_scale_multi, FK.res_scale_bneck, FK.res_scale_folded):
        assert rule(0.3, 0.2, "SILU") == float(np.float32(0.3))
    assert FK.res_scale_bneck(0.3, 0.2, "LEAKY_RELU") == float(np.float32(0.3))
    assert FK.res_scale_multi(0.3, 0.2, "LEAKY_RELU") == float(
        np.float32(0.3) / np.float32(0.2))
    x = torch.zeros((2, 4, 4, 8), dtype=torch.int8)
    w = torch.zeros((8, 3, 3, 8), dtype=torch.int8)
    ep = FK.epilogue_rows(0.01, 0.05, 0.05, "LEAKY_RELU", 8)
    with pytest.raises(ValueError, match="LEAKY"):
        FK.conv2d_int8_fused(x, w, None, ep, (4, 4), (1, 1), (1, 1),
                             ((1, 1), (1, 1)), residual=x)
