"""The port's CUDA kernels vs their plain torch versions on a CUDA card.

Marked ``gpu``; each test skips without a CUDA device. This file imports
no JAX, so it also runs where JAX is absent. On the card, from the root of
a checkout (``--noconftest`` skips ``tests/conftest.py``, which sets JAX
up)::

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerances: NONE / RELU / LEAKY_RELU bit-exact; SILU at most 1 quantum on
at most 0.1% of the elements (the kernel's ``expf`` and torch's sigmoid
differ by ulps). The shapes cover both load paths of each kernel (4-byte
words when C or K is a multiple of 4 and the pointers are aligned, bytes
otherwise), every ragged edge, the residual modes, and the multi-part,
bottleneck, SPPF and depthwise kernels at their edge cases and model
shapes. The head decode (kernel #8) is held against its plain version on
the CPU: classes exact, boxes within rtol 1e-6 / atol 1e-5, conf within
rtol 1e-6 / atol 1e-7, and the detections after NMS equal. The exact
tier's kernels #9-#11 (``ops.requant_kernels``) are bit-exact against
their plain versions in both RoundModes, with and without RELU, at the
zoo yolov5s's lead shapes and at the edge cases: ragged edges, the byte
path, the stem, asymmetric pads, dilation 2 and stride (2, 1). The
slab-ring KxK conv (#5, ``pipeline="dma"``) equals its plain version and
#2 bit for bit on the five cases of ``tests/test_torch_halo_dma.py`` and a
ragged one, at every tile width its plan can pick, with the weights
resident (the slab whole or chunked) and streamed, and on an input that
is 4-byte but not 16-byte aligned.
"""

import numpy as np
import pytest
import torch

from thingino_accel_tpu_torch.models import yolo as Y
from thingino_accel_tpu_torch.ops import decode_kernel as DK
from thingino_accel_tpu_torch.ops import fused_kernels as FK
from thingino_accel_tpu_torch.ops import requant_kernels as RK
from thingino_accel_tpu_torch.ops.quant import RoundMode

pytestmark = pytest.mark.gpu

ACTS = ("NONE", "RELU", "LEAKY_RELU", "SILU")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card (see the module "
                    "docstring)")
    return torch.device("cuda")


def _close(k: torch.Tensor, p: torch.Tensor, act: str):
    assert k.shape == p.shape and k.dtype == p.dtype == torch.int8
    d = (k.to(torch.int32) - p.to(torch.int32)).abs().cpu().numpy()
    if act == "SILU":
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(),
                                                         (d > 0).mean())
    else:
        assert d.max() == 0, (d.max(), (d > 0).mean())


def _rand(rng, shape, dev):
    return torch.from_numpy(rng.integers(-128, 128, shape,
                                         dtype=np.int8)).to(dev)


def _ep(rng, ktot, o, act, dev):
    ws = rng.uniform(0.005, 0.015, o).astype(np.float32)
    return FK.epilogue_rows(ws, 0.01, float(0.0137 * np.sqrt(ktot)), act, o,
                            alpha=0.1, device=dev)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("m,k,n", [(200, 48, 16), (131, 30, 255),
                                   (64, 512, 64), (1, 3, 5)])
def test_matmul_kernel_matches_plain(cuda, act, m, k, n):
    rng = np.random.default_rng(m * 7 + k)
    x, w = _rand(rng, (m, k), cuda), _rand(rng, (n, k), cuda)
    bias = torch.from_numpy(rng.integers(-2000, 2000, n).astype(
        np.int32)).to(cuda)
    ep = _ep(rng, k, n, act, cuda)
    out = FK.matmul_int8_fused(x, w, bias, ep)
    torch.cuda.synchronize()
    _close(out, FK.matmul_int8_fused_plain(x, w, bias, ep), act)
    _close(FK.matmul_int8_fused(x, w, None, ep),
           FK.matmul_int8_fused_plain(x, w, None, ep), act)


def test_matmul_kernel_unaligned_operands(cuda):
    """A contiguous view at an odd byte offset takes the byte loads."""
    rng = np.random.default_rng(1)
    buf = _rand(rng, (1 + 40 * 32,), cuda)
    x = buf[1:].view(40, 32)
    w = _rand(rng, (24, 32), cuda)
    ep = _ep(rng, 32, 24, "RELU", cuda)
    _close(FK.matmul_int8_fused(x, w, None, ep),
           FK.matmul_int8_fused_plain(x, w, None, ep), "RELU")


# (kernel, stride, C, O, H, W, pad): odd sizes, C % 4 != 0, the thin stem,
# the 255-channel heads, asymmetric stride-2 pads, an unpadded 1x1/s2
CONV_SHAPES = [
    (3, 1, 16, 16, 9, 11, 1),
    (3, 2, 48, 255, 13, 10, 1),
    (6, 2, 3, 16, 16, 15, 2),
    (1, 2, 16, 16, 7, 8, 0),
    (5, 1, 6, 8, 7, 7, 2),
    (3, 2, 64, 128, 80, 80, 1),
]


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", CONV_SHAPES,
                         ids=lambda s: "k{}s{}c{}o{}h{}w{}p{}".format(*s))
def test_conv_kernel_matches_plain(cuda, act, shape):
    kk, s, c, o, h, w, p = shape
    rng = np.random.default_rng(sum(shape))
    x, wt = _rand(rng, (2, h, w, c), cuda), _rand(rng, (o, kk, kk, c), cuda)
    bias = torch.from_numpy(rng.integers(-2000, 2000, o).astype(
        np.int32)).to(cuda)
    oh, ow = (h + 2 * p - kk) // s + 1, (w + 2 * p - kk) // s + 1
    # pads as the graph implies them: bottom/right from the output size
    pb = max(0, (oh - 1) * s + kk - h - p)
    pr = max(0, (ow - 1) * s + kk - w - p)
    pads = ((p, pb), (p, pr))
    ep = _ep(rng, kk * kk * c, o, act, cuda)
    out = FK.conv2d_int8_halo_fused(x, wt, bias, ep, (oh, ow), pads, s)
    torch.cuda.synchronize()
    _close(out, FK.conv2d_int8_halo_fused_plain(x, wt, bias, ep, (oh, ow),
                                                pads, s), act)


@pytest.mark.parametrize("act", ["NONE", "RELU", "SILU"])
@pytest.mark.parametrize("kind", ["matmul", "conv"])
def test_residual_mode_matches_plain(cuda, act, kind):
    """#1 and #2 with a fused residual (LEAKY_RELU takes none); ragged
    M/N and K % 4 != 0."""
    rng = np.random.default_rng(11)
    if kind == "matmul":
        x, w = _rand(rng, (131, 30), cuda), _rand(rng, (70, 30), cuda)
        res = _rand(rng, (131, 70), cuda)
        ep = _ep(rng, 30, 70, act, cuda)
        out = FK.matmul_int8_fused(x, w, None, ep, res, 0.37)
        ref = FK.matmul_int8_fused_plain(x, w, None, ep, res, 0.37)
    else:
        x, w = _rand(rng, (2, 9, 11, 16), cuda), _rand(rng, (24, 3, 3, 16),
                                                        cuda)
        res = _rand(rng, (2, 9, 11, 24), cuda)
        ep = _ep(rng, 144, 24, act, cuda)
        args = (x, w, None, ep, (9, 11), ((1, 1), (1, 1)), 1, res, 0.21)
        out = FK.conv2d_int8_halo_fused(*args)
        ref = FK.conv2d_int8_halo_fused_plain(*args)
    torch.cuda.synchronize()
    _close(out, ref, act)


# (part widths, equal scales, residual): 1/2/4 parts, K % 4 != 0
MULTI_CASES = [((64,), True, False), ((32, 32), True, True),
               ((13, 7), False, False), ((40, 24, 8, 36), False, True),
               ((30, 30, 30, 30), True, False)]


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("parts,same,residual", MULTI_CASES)
def test_multi_kernel_matches_plain(cuda, act, parts, same, residual):
    """Parts as separate tensors, weights as column slices of one [N, K]
    matrix (strided rows; odd offsets take the byte loads)."""
    if residual and act == "LEAKY_RELU":
        residual = False
    rng = np.random.default_rng(sum(parts) + 3 * same)
    m, n = 200, 70
    xs = [_rand(rng, (m, k), cuda) for k in parts]
    wfull = _rand(rng, (n, sum(parts)), cuda)
    ws, off = [], 0
    for k in parts:
        ws.append(wfull[:, off:off + k])
        off += k
    scales = ([0.05] * len(parts) if same
              else list(rng.uniform(0.03, 0.07, len(parts))))
    me = FK.multi_epilogue(rng.uniform(0.005, 0.015, n).astype(np.float32),
                           scales, 0.9, act, n, alpha=0.1,
                           bias_scale=None if same else 0.045, device=cuda)
    bias = torch.from_numpy(rng.integers(-2000, 2000, n).astype(
        np.int32)).to(cuda)
    res = _rand(rng, (m, n), cuda) if residual else None
    out = FK.matmul_int8_fused_multi(xs, ws, bias, me, res, 0.4)
    torch.cuda.synchronize()
    _close(out, FK.matmul_int8_fused_multi_plain(xs, ws, bias, me, res, 0.4),
           act)


# (batch, H, W, C, CM, O, K, shortcut): H not a multiple of the tile,
# C and CM % 4 != 0, CM and O over one 64-wide tile, K = 5
BNECK_CASES = [(2, 13, 11, 32, 32, 32, 3, True),
               (1, 9, 20, 40, 80, 130, 3, False),
               (3, 7, 6, 6, 10, 6, 3, True),
               (1, 12, 9, 16, 16, 16, 5, True),
               (16, 20, 20, 128, 128, 128, 3, True)]


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("case", BNECK_CASES,
                         ids=lambda c: "b{}h{}w{}c{}m{}o{}k{}s{}".format(*c))
def test_bneck_kernel_matches_plain(cuda, act, case):
    nb, h, w, c, cm, o, k, shortcut = case
    shortcut = shortcut and act != "LEAKY_RELU"
    rng = np.random.default_rng(sum(case[:7]))
    x = _rand(rng, (nb, h, w, c), cuda)
    w1, w2 = _rand(rng, (cm, c), cuda), _rand(rng, (o, k, k, cm), cuda)
    b1 = torch.from_numpy(rng.integers(500, 3000, cm).astype(
        np.int32)).to(cuda)
    b2 = torch.from_numpy(rng.integers(-2000, 2000, o).astype(
        np.int32)).to(cuda)
    ep1, ep2 = _ep(rng, c, cm, act, cuda), _ep(rng, k * k * cm, o, act, cuda)
    args = (x, w1, b1, ep1, w2, b2, ep2, shortcut, 0.6)
    out = FK.bottleneck_int8_fused(*args)
    torch.cuda.synchronize()
    _close(out, FK.bottleneck_int8_fused_plain(*args), act)


@pytest.mark.parametrize("tile_rows", [1, 3, 7, 16])
def test_bneck_kernel_any_tile_rows(cuda, tile_rows):
    """Every tile height gives the same result; at 16 rows the halo'd
    intermediate (18 x 20 x 128 B) and the static tiles pass 48 KB of
    shared memory, which needs the kernel's opt-in."""
    rng = np.random.default_rng(tile_rows)
    x = _rand(rng, (2, 20, 20, 128), cuda)
    w1, w2 = _rand(rng, (128, 128), cuda), _rand(rng, (128, 3, 3, 128), cuda)
    ep1, ep2 = _ep(rng, 128, 128, "SILU", cuda), _ep(rng, 1152, 128, "SILU",
                                                      cuda)
    out = torch.empty((2, 20, 20, 128), dtype=torch.int8, device=cuda)
    FK._launch_bneck(x, w1, None, ep1, w2, None, ep2, True, 0.6, out,
                     tile_rows)
    torch.cuda.synchronize()
    _close(out, FK.bottleneck_int8_fused_plain(x, w1, None, ep1, w2, None,
                                               ep2, True, 0.6), "SILU")


# (batch, H, W, C, O, k): C % 4 != 0, O over one tile, the yolov5s shape,
# and a width whose staged rows pass 48 KB of shared memory
SPPF_CASES = [(2, 6, 7, 36, 20, 5), (1, 9, 4, 10, 8, 3),
              (2, 12, 30, 33, 70, 5), (8, 20, 20, 256, 512, 5),
              (1, 20, 40, 32, 16, 5)]


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("negative", [False, True])
@pytest.mark.parametrize("case", SPPF_CASES,
                         ids=lambda c: "b{}h{}w{}c{}o{}k{}".format(*c))
def test_sppf_kernel_matches_plain(cuda, act, negative, case):
    nb, h, w, c, o, k = case
    rng = np.random.default_rng(sum(case))
    x = _rand(rng, (nb, h, w, c), cuda)
    if negative:
        x = -(x.to(torch.int32).abs().clamp(1, 128)).to(torch.int8)
    wt = _rand(rng, (o, 4 * c), cuda)
    bias = torch.from_numpy(rng.integers(-2000, 2000, o).astype(
        np.int32)).to(cuda)
    ep = _ep(rng, 4 * c, o, act, cuda)
    out = FK.sppf_int8_fused(x, wt, bias, ep, k)
    torch.cuda.synchronize()
    _close(out, FK.sppf_int8_fused_plain(x, wt, bias, ep, k), act)


def test_launch_counters(cuda):
    FK.reset_launches()
    rng = np.random.default_rng(2)
    x = _rand(rng, (1, 8, 8, 16), cuda)
    ep = _ep(rng, 16, 16, "NONE", cuda)
    FK.conv2d_int8_fused(x, _rand(rng, (16, 1, 1, 16), cuda), None, ep,
                         (8, 8), (1, 1), (1, 1), ((0, 0), (0, 0)))
    FK.conv2d_int8_fused(x, _rand(rng, (16, 3, 3, 16), cuda), None,
                         _ep(rng, 144, 16, "NONE", cuda), (8, 8), (1, 1),
                         (1, 1), ((1, 1), (1, 1)))
    FK.conv2d_int8_fused(x, _rand(rng, (16, 1, 1, 16), cuda), None, ep,
                         (8, 8), (1, 1), (1, 1), ((0, 0), (0, 0)),
                         plain=True)   # the plain version launches nothing
    xs = [x.reshape(64, 16)] * 2
    FK.matmul_int8_fused_multi(xs, [_rand(rng, (16, 16), cuda)] * 2, None,
                               FK.multi_epilogue(0.01, [0.05, 0.05], 0.05,
                                                 "NONE", 16, device=cuda))
    FK.bottleneck_int8_fused(x, _rand(rng, (8, 16), cuda), None,
                             _ep(rng, 16, 8, "NONE", cuda),
                             _rand(rng, (16, 3, 3, 8), cuda), None,
                             _ep(rng, 72, 16, "NONE", cuda))
    FK.sppf_int8_fused(x, _rand(rng, (16, 64), cuda), None, ep, 5)
    FK.depthwise_conv2d_int8_fused(x, _rand(rng, (3, 3, 16), cuda), None,
                                   ep, (8, 8), ((1, 1), (1, 1)))
    FK.conv2d_int8_halo_fused(x, _rand(rng, (16, 3, 3, 16), cuda), None,
                              _ep(rng, 144, 16, "NONE", cuda), (8, 8),
                              ((1, 1), (1, 1)), pipeline="dma")
    assert FK.launches == {"matmul_int8_fused": 1,
                           "conv2d_int8_halo_fused": 1,
                           "matmul_int8_fused_multi": 1,
                           "bottleneck_int8_fused": 1,
                           "sppf_int8_fused": 1,
                           "depthwise_conv2d_int8_fused": 1,
                           "conv2d_int8_halo_dma": 1}


def test_wrappers_reject_bad_operands(cuda):
    rng = np.random.default_rng(3)
    ep = _ep(rng, 16, 8, "NONE", cuda)
    w = _rand(rng, (8, 16), cuda)
    with pytest.raises(ValueError, match="contiguous"):
        FK.matmul_int8_fused(_rand(rng, (16, 20), cuda).t(), w, None, ep)
    with pytest.raises(TypeError, match="int8"):
        FK.matmul_int8_fused(torch.zeros((4, 16), device=cuda), w, None, ep)
    with pytest.raises(ValueError, match="devices"):
        FK.matmul_int8_fused(torch.zeros((4, 16), dtype=torch.int8), w,
                             None, ep)


# (batch, H, W, C, KH, KW): NanoDet's stride-1 shapes, C % 4 != 0, odd
# sizes, an even and a non-square window
DW_CASES = [(16, 40, 40, 96, 3, 3), (16, 10, 10, 384, 3, 3),
            (2, 9, 11, 37, 3, 3), (1, 7, 5, 6, 2, 2), (3, 11, 9, 24, 5, 3),
            (1, 1, 1, 3, 3, 3)]


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("case", DW_CASES,
                         ids=lambda c: "b{}h{}w{}c{}k{}x{}".format(*c))
def test_dw_kernel_matches_plain(cuda, act, case):
    nb, h, w, c, kh, kw = case
    rng = np.random.default_rng(sum(case))
    x, wt = _rand(rng, (nb, h, w, c), cuda), _rand(rng, (kh, kw, c), cuda)
    bias = torch.from_numpy(rng.integers(-2000, 2000, c).astype(
        np.int32)).to(cuda)
    ep = _ep(rng, kh * kw, c, act, cuda)
    pads = (((kh - 1) // 2, kh // 2), ((kw - 1) // 2, kw // 2))
    for b in (bias, None):
        out = FK.depthwise_conv2d_int8_fused(x, wt, b, ep, (h, w), pads)
        torch.cuda.synchronize()
        _close(out, FK.depthwise_conv2d_int8_fused_plain(x, wt, b, ep,
                                                         (h, w), pads), act)


def test_dw_kernel_unaligned_and_padded_output(cuda):
    """A view at an odd byte offset takes the byte path; a declared output
    larger than the input reads zeros past the edge."""
    rng = np.random.default_rng(5)
    buf = _rand(rng, (1 + 2 * 6 * 7 * 16,), cuda)
    x = buf[1:].view(2, 6, 7, 16)
    wt = _rand(rng, (3, 3, 16), cuda)
    ep = _ep(rng, 9, 16, "LEAKY_RELU", cuda)
    for out_hw, pads in [((6, 7), ((1, 1), (1, 1))),
                         ((8, 9), ((2, 2), (2, 2)))]:
        _close(FK.depthwise_conv2d_int8_fused(x, wt, None, ep, out_hw, pads),
               FK.depthwise_conv2d_int8_fused_plain(x, wt, None, ep, out_hw,
                                                    pads), "LEAKY_RELU")


def _decode_pair(heads, **kw):
    """Kernel on the card vs the plain decode on the CPU copies."""
    DK.reset_launches()
    got = DK.decode_and_parse_fused(heads, **kw)
    torch.cuda.synchronize()
    assert DK.launches["decode_and_parse_fused"] == 1
    ref = DK.decode_and_parse_fused([h.cpu() for h in heads], **kw)
    return [g.cpu() for g in got], ref


def _assert_decode_close(got, ref, nan=False):
    np.testing.assert_allclose(got[0].numpy(), ref[0].numpy(), rtol=1e-6,
                               atol=1e-5, equal_nan=nan)
    np.testing.assert_allclose(got[1].numpy(), ref[1].numpy(), rtol=1e-6,
                               atol=1e-7, equal_nan=nan)
    np.testing.assert_array_equal(got[2].numpy(), ref[2].numpy())


# (batch, level sizes): the real yolov5n heads at 640 (batch 16 and 1, whose
# 20x20 level has 400 rows), two levels, one level of one cell
DECODE_CASES = [(16, (80, 40, 20)), (1, (80, 40, 20)), (3, (13, 7)),
                (2, (1,))]


@pytest.mark.parametrize("dtype", ["int8", "f32"])
@pytest.mark.parametrize("case", DECODE_CASES,
                         ids=lambda c: "b{}_{}".format(c[0], "x".join(
                             map(str, c[1]))))
def test_decode_kernel_matches_plain(cuda, dtype, case):
    nb, hws = case
    rng = np.random.default_rng(nb + sum(hws))
    shapes = [(nb, hw, hw, 255) for hw in hws]
    if dtype == "int8":
        heads = [_rand(rng, s, cuda) for s in shapes]
        scales = list(rng.uniform(0.03, 0.06, len(hws)))
    else:
        heads = [torch.from_numpy(rng.normal(0, 2, s).astype(np.float32)
                                  ).to(cuda) for s in shapes]
        scales = None
    got, ref = _decode_pair(heads, anchors=Y.YOLOV5_ANCHORS[:len(hws)],
                            strides=Y.YOLOV5_STRIDES[:len(hws)],
                            scales=scales)
    _assert_decode_close(got, ref)


def test_decode_kernel_ties_and_nan(cuda):
    """First-occurrence ties on int8 and f32 heads; f32 rows with all,
    some and one NaN class logits give the first NaN's index."""
    feat = np.zeros((2, 8, 8, 3, 85), np.int8)
    feat[..., 0, 5 + 7] = feat[..., 0, 5 + 19] = 100
    feat[..., 1, 5:] = -3
    for dt in (np.int8, np.float32):
        h = torch.from_numpy(feat.reshape(2, 8, 8, 255).astype(dt)).to(cuda)
        got, ref = _decode_pair([h], anchors=Y.YOLOV5_ANCHORS[:1],
                                strides=(8,), scales=[0.05])
        _assert_decode_close(got, ref)
        k = got[2].numpy().reshape(2, 64, 3)
        assert (k[..., 0] == 7).all() and (k[..., 1] == 0).all()
    rng = np.random.default_rng(9)
    f = rng.normal(0, 2, (2, 8, 8, 3, 85)).astype(np.float32)
    f[0, ..., 5:] = np.nan
    f[1][rng.random((8, 8, 3)) < 0.3, 5 + 33] = np.nan
    f[1, 0, 0, 0, 5 + 2] = np.nan
    h = torch.from_numpy(f.reshape(2, 8, 8, 255)).to(cuda)
    got, ref = _decode_pair([h], anchors=Y.YOLOV5_ANCHORS[:1], strides=(8,))
    _assert_decode_close(got, ref, nan=True)
    assert (got[2][0] == 0).all()


def test_decode_kernel_detections_equal(cuda):
    """The seeded tie-heavy head set of ``chip_smoke.py``: NMS over the
    kernel's decode equals NMS over the plain decode."""
    rng = np.random.default_rng(11)
    heads = []
    for hw in (80, 40, 20):
        h = rng.integers(-2, 3, (4, hw, hw, 3, 85)).astype(np.int8) * 8
        h[..., 4] = rng.choice([16, 40, 127], (4, hw, hw, 3))
        heads.append(torch.from_numpy(h.reshape(4, hw, hw, 255)).to(cuda))
    got, ref = _decode_pair(heads, scales=[0.05] * 3)
    _assert_decode_close(got, ref)
    # both decodes on the card, each through the same NMS on the card
    kw = dict(max_dets=100, pre_nms=128, topk_group=8)
    dg = Y.nms_batched(*DK.decode_and_parse_fused(heads, scales=[0.05] * 3),
                       **kw)
    dr = Y.nms_batched(*Y.decode_and_parse(heads, scales=[0.05] * 3), **kw)
    assert int(dr.num.sum()) > 0
    assert torch.equal(dg.valid, dr.valid)
    assert torch.equal(dg.classes, dr.classes)
    torch.testing.assert_close(dg.boxes, dr.boxes, rtol=0, atol=1e-4)
    torch.testing.assert_close(dg.scores, dr.scores, rtol=1e-6, atol=1e-12)


def test_new_wrappers_launch_on_every_cuda_call(cuda):
    """A CUDA operand never reaches the plain version: each call moves the
    wrapper's launch counter."""
    rng = np.random.default_rng(4)
    x = _rand(rng, (1, 8, 8, 16), cuda)
    wt = _rand(rng, (3, 3, 16), cuda)
    ep = _ep(rng, 9, 16, "RELU", cuda)
    head = _rand(rng, (1, 4, 4, 255), cuda)
    FK.reset_launches()
    DK.reset_launches()
    for i in range(1, 4):
        FK.depthwise_conv2d_int8_fused(x, wt, None, ep, (8, 8),
                                       ((1, 1), (1, 1)))
        DK.decode_and_parse_fused([head], anchors=Y.YOLOV5_ANCHORS[:1],
                                  strides=(8,), scales=[0.05])
        assert FK.launches["depthwise_conv2d_int8_fused"] == i
        assert DK.launches["decode_and_parse_fused"] == i
    torch.cuda.synchronize()
    with pytest.raises(ValueError, match="channels"):
        DK.decode_and_parse_fused([_rand(rng, (1, 4, 4, 384), cuda)],
                                  anchors=Y.YOLOV5_ANCHORS[:1], strides=(8,))


# ---------------------------------------------------------------------------
# The slab-ring KxK conv (#5, pipeline="dma")
# ---------------------------------------------------------------------------

# (k, stride, C, O, H, W, pads): the five cases of tests/test_torch_halo_dma.py
# (2 images of 16x16, the stem 32x32), then a ragged one: OW = 37 over tiles
# of 8, O = 70 over two channel blocks, C = 5 (the byte path), asymmetric
# pads where only pt/pl place the window
DMA_GPU_CASES = [
    (3, 1, 32, 32, 16, 16, ((1, 1), (1, 1))),
    (3, 2, 32, 48, 16, 16, ((1, 1), (1, 1))),
    (3, 1, 24, 40, 16, 16, ((1, 1), (1, 1))),
    (6, 2, 3, 16, 32, 32, ((2, 2), (2, 2))),
    (3, 2, 32, 32, 16, 16, ((1, 1), (1, 1))),
    (3, 1, 5, 70, 15, 38, ((0, 1), (1, 0))),
]


def _dma_operands(rng, case, dev):
    kk, s, c, o, h, w, pads = case
    x, wt = _rand(rng, (2, h, w, c), dev), _rand(rng, (o, kk, kk, c), dev)
    bias = torch.from_numpy(rng.integers(-2000, 2000, o).astype(
        np.int32)).to(dev)
    out_hw = ((h + sum(pads[0]) - kk) // s + 1,
              (w + sum(pads[1]) - kk) // s + 1)
    return x, wt, bias, out_hw


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("case", DMA_GPU_CASES,
                         ids=lambda c: "k{}s{}c{}o{}h{}w{}".format(*c[:6]))
def test_dma_kernel_matches_plain_and_blockspec(cuda, act, case):
    """The slab-ring kernel launches (its counter moves, #2's does not)
    and equals its plain version and #2 bit for bit: the two kernels run
    the same dp4a product and epilogue, only their loads differ."""
    rng = np.random.default_rng(sum(case[:6]))
    x, wt, bias, out_hw = _dma_operands(rng, case, cuda)
    kk, s, c, o, _, _, pads = case
    ep = _ep(rng, kk * kk * c, o, act, cuda)
    args = (x, wt, bias, ep, out_hw, pads, s)
    before = dict(FK.launches)
    out = FK.conv2d_int8_halo_fused(*args, pipeline="dma")
    torch.cuda.synchronize()
    assert FK.launches["conv2d_int8_halo_dma"] == \
        before["conv2d_int8_halo_dma"] + 1
    assert FK.launches["conv2d_int8_halo_fused"] == \
        before["conv2d_int8_halo_fused"]
    _close(out, FK.conv2d_int8_halo_fused_plain(*args), act)
    assert torch.equal(out, FK.conv2d_int8_halo_fused(*args))


# (channels a stage, weights resident): all C, a chunked slab, streamed
DMA_MODES = [(128, True), (48, True), (48, False)]


@pytest.mark.parametrize("ck,resident", DMA_MODES)
@pytest.mark.parametrize("tile_w", FK.DMA_TILE_WIDTHS)
def test_dma_kernel_any_tile(cuda, tile_w, ck, resident):
    """Every tile the plan can pick, in each mode: the weights resident
    with all 128 channels a stage or the slab in chunks of 48 (three, the
    last ragged), and the weights streamed with those chunks (each past
    48 KB of shared memory, so each needs the opt-in); at stride 1 and 2,
    with one tile a block and with all of an image's."""
    rng = np.random.default_rng(tile_w + 100 * resident + ck)
    x = _rand(rng, (2, 21, 27, 128), cuda)
    wt = _rand(rng, (70, 3, 3, 128), cuda)
    ep = _ep(rng, 1152, 70, "SILU", cuda)
    for s in (1, 2):
        out_hw = ((21 + 2 - 3) // s + 1, (27 + 2 - 3) // s + 1)
        for tpc in (1, 10 ** 6):
            out = torch.empty((2,) + out_hw + (70,), dtype=torch.int8,
                              device=cuda)
            FK._launch_conv_dma(x, wt, None, ep, ((1, 1), (1, 1)), s, out,
                                FK.DmaPlan(64 // tile_w, tile_w, ck,
                                           resident, tpc))
            torch.cuda.synchronize()
            _close(out, FK.conv2d_int8_halo_fused_plain(
                x, wt, None, ep, out_hw, ((1, 1), (1, 1)), s), "SILU")


def test_dma_kernel_on_an_input_off_16_bytes(cuda):
    """C % 16 == 0 with the input 4 bytes past a 16-byte boundary: the
    layout takes 4-byte copies, and the kernel still equals its plain
    version and #2. The plan reads the card's own limits."""
    lim = FK.smem_limits(cuda)
    assert lim.sms > 0 and 48 * 1024 < lim.per_block <= lim.per_sm
    rng = np.random.default_rng(7)
    x, wt, bias, out_hw = _dma_operands(rng, DMA_GPU_CASES[1], cuda)
    buf = torch.empty(x.numel() + 16, dtype=torch.int8, device=cuda)
    xs = buf[4:4 + x.numel()].view(x.shape)
    xs.copy_(x)
    assert xs.data_ptr() % 16 == 4
    ep = _ep(rng, 288, 48, "LEAKY_RELU", cuda)
    args = (xs, wt, bias, ep, out_hw, ((1, 1), (1, 1)), 2)
    out = FK.conv2d_int8_halo_fused(*args, pipeline="dma")
    torch.cuda.synchronize()
    _close(out, FK.conv2d_int8_halo_fused_plain(*args), "LEAKY_RELU")
    assert torch.equal(out, FK.conv2d_int8_halo_fused(*args))


def test_dma_kernel_rejects_what_it_cannot_run(cuda):
    rng = np.random.default_rng(6)
    x, wt, bias, out_hw = _dma_operands(rng, DMA_GPU_CASES[0], cuda)
    ep = _ep(rng, 288, 32, "RELU", cuda)
    res = _rand(rng, (2,) + out_hw + (32,), cuda)
    with pytest.raises(ValueError, match="residual"):
        FK.conv2d_int8_halo_fused(x, wt, bias, ep, out_hw, ((1, 1), (1, 1)),
                                  residual=res, pipeline="dma")
    buf = _rand(rng, (1 + x.numel(),), cuda)
    with pytest.raises(ValueError, match="aligned"):
        FK.conv2d_int8_halo_fused(buf[1:].view(x.shape), wt, bias, ep, out_hw,
                                  ((1, 1), (1, 1)), pipeline="dma")


# ---------------------------------------------------------------------------
# The exact tier's kernels #9-#11
# ---------------------------------------------------------------------------

RMODES = [(RoundMode.HALF_AWAY, False), (RoundMode.PLUS_HALF_TRUNC, True)]


@pytest.mark.parametrize("rm,relu", RMODES)
@pytest.mark.parametrize("m,k,n", [(200, 48, 16), (131, 30, 255),
                                   (64, 512, 64), (1, 3, 5),
                                   (16 * 80 * 80, 128, 128)])
def test_requant_matmul_kernel_matches_plain(cuda, rm, relu, m, k, n):
    rng = np.random.default_rng(m + 3 * k + n)
    x, w = _rand(rng, (m, k), cuda), _rand(rng, (n, k), cuda)
    bias = torch.from_numpy(rng.integers(-3000, 3000, n).astype(
        np.int32)).to(cuda)
    cs = RK.combined_scale(0.05, 0.01, float(0.0137 * np.sqrt(k)))
    for b in (bias, None):
        out = RK.matmul_int8_requant(x, w, b, cs, rm, relu)
        torch.cuda.synchronize()
        _close(out, RK.matmul_int8_requant_plain(x, w, b, cs, rm, relu),
               "NONE")


# (batch, H, W, C, O, KH, KW, stride, dilation, pads): the lead shapes of
# the zoo yolov5s at 640 (#10 3x3/s1; #11 the stem and a 3x3/s2), then odd
# sizes, C % 4 != 0, a padded 1x1, SAME at stride 2 (asymmetric pads),
# dilation 2, stride (2, 1), a 1x1/s2
REQUANT_CONV = [
    (16, 40, 40, 128, 128, 3, 3, (1, 1), (1, 1), ((1, 1), (1, 1))),
    (16, 640, 640, 3, 32, 6, 6, (2, 2), (1, 1), ((2, 2), (2, 2))),
    (16, 80, 80, 128, 256, 3, 3, (2, 2), (1, 1), ((1, 1), (1, 1))),
    (2, 9, 11, 16, 16, 3, 3, (1, 1), (1, 1), ((1, 1), (1, 1))),
    (2, 13, 10, 6, 70, 5, 5, (1, 1), (1, 1), ((2, 2), (2, 2))),
    (1, 8, 8, 8, 8, 1, 1, (1, 1), (1, 1), ((1, 1), (1, 1))),
    (2, 13, 12, 8, 24, 3, 3, (2, 2), (1, 1), ((0, 1), (1, 1))),
    (2, 12, 12, 20, 16, 3, 3, (1, 1), (2, 2), ((2, 2), (2, 2))),
    (2, 11, 10, 5, 16, 3, 3, (2, 1), (1, 1), ((1, 1), (1, 1))),
    (1, 9, 9, 16, 8, 1, 1, (2, 2), (1, 1), ((0, 0), (0, 0))),
]


def _conv_out_hw(h, w, kh, kw, s, d, pads):
    return ((h + sum(pads[0]) - (kh - 1) * d[0] - 1) // s[0] + 1,
            (w + sum(pads[1]) - (kw - 1) * d[1] - 1) // s[1] + 1)


@pytest.mark.parametrize("rm,relu", RMODES)
@pytest.mark.parametrize("case", REQUANT_CONV, ids=lambda c: (
    "b{}h{}w{}c{}o{}k{}x{}".format(*c[:7])
    + "s{}{}d{}{}".format(*c[7], *c[8])))
def test_requant_conv_kernels_match_plain(cuda, rm, relu, case):
    """#10 or #11 as ``conv2d_int8`` routes the case, against the plain
    version; the launch counter of the routed kernel moves by one."""
    nb, h, w, c, o, kh, kw, s, d, pads = case
    rng = np.random.default_rng(h * w + c + o)
    x, wt = _rand(rng, (nb, h, w, c), cuda), _rand(rng, (o, kh, kw, c), cuda)
    bias = torch.from_numpy(rng.integers(-3000, 3000, o).astype(
        np.int32)).to(cuda)
    out_hw = _conv_out_hw(h, w, kh, kw, s, d, pads)
    args = (x, wt, bias, out_hw, s, d, pads, 0.05, 0.01,
            float(0.0137 * np.sqrt(kh * kw * c)), rm, relu)
    which = RK.route((kh, kw), s, d, pads)
    before = dict(RK.launches)
    out = RK.conv2d_int8(*args)
    torch.cuda.synchronize()
    assert RK.launches[which] == before[which] + 1
    _close(out, RK.conv2d_int8(*args, plain=True), "NONE")


def test_requant_kernels_unaligned_operands(cuda):
    """A contiguous view at an odd byte offset takes the byte loads."""
    rng = np.random.default_rng(5)
    buf = _rand(rng, (1 + 2 * 9 * 9 * 16,), cuda)
    x = buf[1:].view(2, 9, 9, 16)
    wt = _rand(rng, (24, 3, 3, 16), cuda)
    args = (x, wt, None, (5, 5), (2, 2), (1, 1), ((1, 1), (1, 1)), 0.05,
            0.01, 0.3)
    _close(RK.conv2d_int8(*args), RK.conv2d_int8(*args, plain=True), "NONE")
    x2 = buf[1:1 + 40 * 32].view(40, 32)
    w2 = _rand(rng, (24, 32), cuda)
    _close(RK.matmul_int8_requant(x2, w2, None, 0.004),
           RK.matmul_int8_requant_plain(x2, w2, None, 0.004), "NONE")
