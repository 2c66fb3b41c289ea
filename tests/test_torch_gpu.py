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
bottleneck and SPPF kernels at their edge cases and model shapes.
"""

import numpy as np
import pytest
import torch

from thingino_accel_tpu_torch.ops import fused_kernels as FK

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
    assert FK.launches == {"matmul_int8_fused": 1,
                           "conv2d_int8_halo_fused": 1,
                           "matmul_int8_fused_multi": 1,
                           "bottleneck_int8_fused": 1,
                           "sppf_int8_fused": 1}


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
