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
otherwise) and every ragged edge.
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
    assert FK.launches == {"matmul_int8_fused": 1,
                           "conv2d_int8_halo_fused": 1}


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
