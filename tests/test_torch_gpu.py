"""The port's CUDA kernels vs their plain torch versions on a CUDA card.

Marked ``gpu``; each test skips without a CUDA device. This file imports
no JAX, so it also runs where JAX is absent. On the card, from the root of
a checkout (``--noconftest`` skips ``tests/conftest.py``, which sets JAX
up)::

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerances: NONE / RELU / LEAKY_RELU bit-exact; SILU at most 1 quantum on
at most 0.1% of the elements (the kernel's ``expf`` and torch's sigmoid
differ by ulps). The shapes cover both load paths of each kernel (16-byte
copies where the channels are a multiple of 16 and the pointers aligned,
bytes otherwise), every ragged edge, the residual modes, and the
multi-part, bottleneck, SPPF and depthwise kernels at their edge cases and
model shapes (the bottleneck and SPPF also at every plan their planners
offer for a path unit). The head decode (kernel #8) is held against its plain version on
the CPU at the real yolov5n's heads and at every head kind it takes (1-4
levels, A = 1 and 3, NC = 1 to 33000, the units too large to stage, int8
heads off 16-byte alignment, ties, NaN rows), in int8, f32 and the fast
tier's bf16: classes exact, boxes within rtol 1e-6 / atol 1e-5, conf
within rtol 1e-6 / atol 1e-7, and the detections after NMS equal. The
fast tier on the card decodes its bf16 heads in #8 (its bf16 counter),
its heads within 2^-4 of the largest |head| of the CPU's float32
forward. The exact
tier's kernels #9-#11 (``ops.requant_kernels``) are bit-exact against
their plain versions in both RoundModes, with and without RELU and with
an activation table, at the zoo yolov5s's lead shapes and at the edge
cases: ragged edges, the byte path, the stem, asymmetric pads, dilation 2
and stride (2, 1); the tensor-core KxK kernel behind #10 and #11 also at
every plan of both its modes and at all 11 distinct KxK convs of the zoo
yolov5s; #9, the 1x1 GEMM under the exact epilogue, at every plan its
planner offers (K = 1024 -> N = 512, N = 255, K off 32 and off 16), each
table act, and every distinct #9 unit of the zoo yolov5s. The depthwise
kernel #7 at every plan its planner offers for NanoDet's five shapes and
a C = 37 case, and at forced tile heights with a ragged last tile. The serving
KxK conv, which #2 and #5 (``pipeline="dma"``) both launch (the same core
with the serving epilogue), equals its plain version and, through both
entries, itself bit for bit: on the five cases of
``tests/test_torch_halo_dma.py`` and a ragged one, at every plan of both
its modes (each at the next narrower chunk, the weights resident and
streamed), with its residual through both of its loads, on an input off
16 bytes, and at every KxK conv of the four serving paths (planned and
unplanned real yolov5n, planned zoo yolov5s, NanoDet) at batch 16; a plan
it refuses raises. The 1x1 GEMM that #1 and #3 both launch
(``csrc/mm_int8_fused_mma.cu``) at every #1/#3 unit of the same four
paths at batch 16, at every plan its planner offers (each ring depth, 32
K bytes a stage) on the real yolov5n's K_i = 16 unit, SPPF's 4 parts, a
head and a ragged case, with refused plans raising. The probes' tensor-core kernels
(``ops.probe_kernels``: E1 ``chain_mma``, E3 ``megakernel_chain``, E4
``add_one``) against their plain versions over row counts off the block
size, at every block, slab and sub-tile their launchers can pick on the
card, with int4 weights at the wrap edges, and with refused launches
raising: int8 kinds bit-exact (SILU_FAST too), chained SILU kinds within
the SILU bound after one stage and at most 1% apart after more, bf16
within 2^-7 of the largest output. E2's lagged conv
(``probe_kernels.conv3x3_lagged``, the ``wgmma`` kernel) in both modes,
over every plan its launcher can take, at the experiment's shape on 2
images, at a ragged shape and a small one, in each act: equal to its
plain version (the act's tolerance) and to #5 bit for bit, every element
written, its launches counted. The camera-stream path on the card:
``nv12_to_rgb``'s bytes equal the CPU's; NV12 cameras through
``MultiStreamBatcher`` and the watchdog'd ``StreamServer`` into a planned
zoo yolov5n, each camera's routed detections equal to its frames run
straight, bit for bit; ``detect_postprocess_topk`` against #8's decode +
NMS and its CPU run (counts and classes equal, scores rtol 1e-5, boxes
rtol 1e-4 / atol 1e-3); the watchdog raising ``InferenceTimeout`` on a
device spin; the fast tier's bf16 conv in both accumulation modes within
1 bf16 ulp of the CPU's. The shared lowering's graphs
(``models.ops_graphs``, ``chip_smoke.py`` ``[ops]`` (c) and (d) at the
small size) in every tier on the card against the CPU, by
``ops_graphs.check_outputs``. Models the format code wrote
(``chip_smoke.py`` ``[onnx]`` at the zoo yolov5n at 320): a graph written
by ``export_mars`` and read back serves planned with its heads equal to
the source graph's engine's; a QDQ model compiled by the CLI serves
planned with its heads equal to the CPU's; a heads graph through
``ir_to_onnx`` and ``compile --float32`` runs the fast tier, #8 in its
bf16 mode, its heads within 2^-4 of the CPU's float32 forward.
"""

import dataclasses

import numpy as np
import pytest
import torch

from thingino_accel_tpu_torch.models import yolo as Y
from thingino_accel_tpu_torch.ops import decode_kernel as DK
from thingino_accel_tpu_torch.ops import fused_kernels as FK
from thingino_accel_tpu_torch.ops import probe_kernels as PK
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


H100 = FK.SmemLimits(132, 233472, 232448)
BNECK_PLAN_CASE = (2, 20, 20, 128, 128, 128, 3)


@pytest.mark.parametrize("plan", FK.bneck_plans(*BNECK_PLAN_CASE, H100),
                         ids=lambda p: "{}x{}bn{}{}".format(
                             p.tile_h, p.tile_w, p.bn,
                             "" if p.resident else "s"))
@pytest.mark.parametrize("tpb", [1, 5])
def test_bneck_kernel_any_plan(cuda, plan, tpb):
    """Every plan the planner offers for the real yolov5n's 20x20x128 pair
    (with its shortcut), in runs of 1 and 5 tiles (crossing images), gives
    the plain version's result; the larger ones pass 48 KB of shared
    memory, which needs the kernel's opt-in."""
    rng = np.random.default_rng(plan.tile_h * plan.bn + tpb)
    x = _rand(rng, (2, 20, 20, 128), cuda)
    w1, w2 = _rand(rng, (128, 128), cuda), _rand(rng, (128, 3, 3, 128), cuda)
    ep1, ep2 = _ep(rng, 128, 128, "SILU", cuda), _ep(rng, 1152, 128, "SILU",
                                                      cuda)
    out = torch.empty((2, 20, 20, 128), dtype=torch.int8, device=cuda)
    FK._launch_bneck(x, w1, None, ep1, w2, None, ep2, True, 0.6, out,
                     dataclasses.replace(plan, tiles_per_block=tpb))
    torch.cuda.synchronize()
    _close(out, FK.bottleneck_int8_fused_plain(x, w1, None, ep1, w2, None,
                                               ep2, True, 0.6), "SILU")


def test_bneck_kernel_refuses_a_plan_it_cannot_run(cuda):
    rng = np.random.default_rng(9)
    x = _rand(rng, (1, 20, 20, 256), cuda)
    w1, w2 = _rand(rng, (256, 256), cuda), _rand(rng, (256, 3, 3, 256), cuda)
    ep = _ep(rng, 256, 256, "SILU", cuda)
    out = torch.empty_like(x)
    with pytest.raises(RuntimeError, match="tat_bneck_int8_fused"):
        FK._launch_bneck(x, w1, None, ep, w2, None, ep, True, 0.6, out,
                         FK.BneckPlan(8, 16, 64, True, 1))   # 300 KB


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


SPPF_PLAN_CASE = (8, 20, 20, 256, 512, 5)


@pytest.mark.parametrize("plan", FK.sppf_plans(*SPPF_PLAN_CASE, H100),
                         ids=lambda p: f"bm{p.bm}bn{p.bn}ck{p.ck}")
@pytest.mark.parametrize("tpb", [1, 3])
def test_sppf_kernel_any_plan(cuda, plan, tpb):
    """Every plan the planner offers for the zoo yolov5s's SPPF at batch 8,
    in runs of 1 and 3 tiles (crossing images), gives the plain version's
    result."""
    rng = np.random.default_rng(plan.bm + plan.bn + plan.ck + tpb)
    nb, h, w, c, o, k = SPPF_PLAN_CASE
    x, wt = _rand(rng, (nb, h, w, c), cuda), _rand(rng, (o, 4 * c), cuda)
    ep = _ep(rng, 4 * c, o, "SILU", cuda)
    out = torch.empty((nb, h, w, o), dtype=torch.int8, device=cuda)
    FK._launch_sppf(x, wt, None, ep, k, out,
                    dataclasses.replace(plan, tiles_per_block=tpb))
    torch.cuda.synchronize()
    _close(out, FK.sppf_int8_fused_plain(x, wt, None, ep, k), "SILU")


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


# #7 at every plan: NanoDet-320's five shapes at batch 2 and C = 37
DW_PLAN_CASES = [(2, 40, 40, 96), (2, 20, 20, 192), (2, 10, 10, 384),
                 (2, 20, 20, 96), (2, 10, 10, 96), (2, 13, 11, 37)]


@pytest.mark.parametrize("case", DW_PLAN_CASES,
                         ids=lambda c: "b{}h{}w{}c{}".format(*c))
def test_dw_kernel_every_plan(cuda, case):
    """Every plan ``dw_plans`` offers (at most 40, cheapest first) and
    forced tile heights with a ragged last tile, at NanoDet's LEAKY_RELU:
    bit for bit against the plain version, every element written; the
    kernel's shared memory is ``dw_smem``'s."""
    nb, h, w, c = case
    rng = np.random.default_rng(h + c)
    x, wt = _rand(rng, (nb, h, w, c), cuda), _rand(rng, (3, 3, c), cuda)
    bias = torch.from_numpy(rng.integers(-2000, 2000, c).astype(
        np.int32)).to(cuda)
    ep = _ep(rng, 9, c, "LEAKY_RELU", cuda)
    pads = ((1, 1), (1, 1))
    ref = FK.depthwise_conv2d_int8_fused_plain(x, wt, bias, ep, (h, w), pads)
    plans = list(FK.dw_plans(nb, h, w, c, 3, 3, FK.smem_limits(cuda))[:40])
    plans += [FK.DwPlan(th, g) for th in (3, 7) for g in (1, 2)]
    for plan in plans:
        out = torch.full(ref.shape, 99, dtype=torch.int8, device=cuda)
        FK._launch_dw(x, wt, bias, ep, pads, out, plan)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), plan
        smem, blocks = FK.dw_occupancy(plan, c, (3, 3), w)
        assert smem == FK.dw_smem(w, 3, 3, plan.tile_h, plan.groups)
        assert blocks >= 1


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
    bf16 = heads[0].dtype == torch.bfloat16
    assert DK.launches == {"decode_and_parse_fused": int(not bf16),
                           "decode_and_parse_fused_bf16": int(bf16)}
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


@pytest.mark.parametrize("dtype", ["int8", "f32", "bf16"])
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
        if dtype == "bf16":
            heads = [h.to(torch.bfloat16) for h in heads]
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


def test_decode_kernel_bf16_ties_and_nan(cuda):
    """bf16 heads (the fast tier's): first-occurrence ties among classes
    that round to one bf16 value, rows with all, some and one NaN class
    logits (the first NaN's index), a head 2 bytes past 16-byte
    alignment."""
    rng = np.random.default_rng(10)
    f = rng.normal(0, 2, (2, 8, 8, 3, 85)).astype(np.float32)
    f[..., 0, 5 + 7] = f[..., 0, 5 + 19] = 9.0
    f[..., 0, 5 + 30] = 9.001   # 9.0 in bf16: ties index 7
    f[0, ..., 1, 5:] = np.nan
    f[1, ..., 2, 5 + 33][rng.random((8, 8)) < 0.3] = np.nan
    f[1, 0, 0, 2, 5 + 2] = f[1, 0, 0, 2, 5 + 33] = np.nan
    v = torch.from_numpy(f.reshape(2, 8, 8, 255)).to(cuda, torch.bfloat16)
    flat = torch.empty(v.numel() + 16, dtype=torch.bfloat16, device=cuda)
    h = flat[1:1 + v.numel()].view(v.shape)
    h.copy_(v)
    got, ref = _decode_pair([h], anchors=Y.YOLOV5_ANCHORS[:1], strides=(8,))
    _assert_decode_close(got, ref, nan=True)
    k = got[2].numpy().reshape(2, 64, 3)
    assert (k[..., 0] == 7).all() and (k[0, :, 1] == 0).all()
    assert (k[1, :, 2] == 33).any() and k[1, 0, 2] == 2


# (batch, level sizes, A, NC): A = 1 and 3, NC = 1 and 300 (an f32 run of
# 26 units), four levels, and units too large to stage (int8 NC 33000,
# bf16 NC 16500, f32 NC 8200), which the whole block decodes
DECODE_SHAPES = [(2, (9, 5, 3), 3, 80), (3, (6,), 1, 1),
                 (1, (4, 2), 3, 300), (1, (12, 6, 3, 1), 1, 80),
                 (2, (2,), 1, None)]


@pytest.mark.parametrize("dtype", ["int8", "f32", "bf16"])
@pytest.mark.parametrize("case", DECODE_SHAPES, ids=str)
def test_decode_kernel_every_head_shape(cuda, dtype, case):
    """Heads of every kind the kernel takes: equal to the plain version;
    int8 heads start 1, 6, 11 and 16 bytes past a 16-byte boundary."""
    nb, hws, a, nc = case
    nc = nc or {"int8": 33000, "f32": 8200, "bf16": 16500}[dtype]
    rng = np.random.default_rng(nc + len(hws))
    anchors = rng.uniform(4, 60, (len(hws), a, 2)).astype(np.float32)
    heads = []
    for i, hw in enumerate(hws):
        shape = (nb, hw, hw, a * (5 + nc))
        if dtype == "int8":
            v = torch.from_numpy((rng.integers(-3, 2, shape) * 40).astype(
                np.int8)).to(cuda)
            flat = torch.empty(v.numel() + 32, dtype=torch.int8, device=cuda)
            off = 5 * i + 1
            heads.append(flat[off:off + v.numel()].view(shape))
            heads[-1].copy_(v)
        else:
            heads.append(torch.from_numpy(rng.normal(0, 2, shape).astype(
                np.float32)).to(cuda, torch.bfloat16 if dtype == "bf16"
                                else torch.float32))
    scales = (list(rng.uniform(0.03, 0.06, len(hws))) if dtype == "int8"
              else None)
    got, ref = _decode_pair(heads, anchors=anchors,
                            strides=(8, 16, 32, 64)[:len(hws)],
                            num_classes=nc, scales=scales)
    _assert_decode_close(got, ref)


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


def test_fast_pipeline_on_the_card_decodes_bf16_heads_in_the_kernel(cuda):
    """The fast tier on the card: ``F.conv2d`` in bf16, bf16 heads decoded
    by #8 (its bf16 counter, one launch a batch), never cast and decoded
    by the plain version; the heads within 2^-4 of the largest |head| of
    the CPU's float32 forward of the same graph (the bound of
    ``chip_smoke.py``'s fast phase)."""
    from thingino_accel_tpu_torch.ir import passes
    from thingino_accel_tpu_torch.models import zoo
    from thingino_accel_tpu_torch.runtime.engine import Engine, EngineOptions
    from thingino_accel_tpu_torch.runtime.executor import build_executor
    g = zoo.build_yolov5("n", zoo.ZooConfig(in_hw=(128, 128),
                                            w_scale=0.0005))
    assert passes.stem_space_to_depth(g)
    opts = EngineOptions(precision="fast", quantize_outputs=False)
    eng = Engine(g, opts, device=cuda)
    frames = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (2, 72, 128, 3), dtype=np.uint8)).to(cuda)
    DK.reset_launches()
    dets = Y.build_serving_pipeline(eng)(frames)
    torch.cuda.synchronize()
    assert DK.launches == {"decode_and_parse_fused": 0,
                           "decode_and_parse_fused_bf16": 1}
    assert dets.boxes.shape == (2, 100, 4)
    x = Y.quantize_input_int8(Y.space_to_depth(Y.letterbox_uint8(
        frames, (128, 128))), torch.bfloat16)
    heads = eng.forward(x)
    cpu = build_executor(eng.graph, "cpu", precision="fast")
    ref = cpu(cpu.device_params(eng._np_params), {g.inputs[0]: x.cpu()})
    for k, h in heads.items():
        assert h.dtype == torch.bfloat16 and h.is_cuda
        r = ref[k]
        assert float((h.cpu().float() - r).abs().max()) <= (
            2.0 ** -4 * float(r.abs().max()))


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
# The serving KxK conv: #2 and #5 (pipeline="dma") launch one tensor-core
# kernel, tat_conv_int8_fused_mma
# ---------------------------------------------------------------------------

# (k, stride, C, O, H, W, pads): the five cases of tests/test_torch_halo_dma.py
# (2 images of 16x16, the stem 32x32), then a ragged one: OW = 37 over tiles
# of 8, O = 70 over two channel blocks, C = 5 (im2col mode), asymmetric
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
    """``pipeline="dma"`` launches (its counter moves, #2's does not) and
    equals its plain version and #2 bit for bit: both entries launch the
    one tensor-core kernel with the one plan."""
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


def _serving_plans(nb, out_hw, c, o, k, s, mode, dev):
    """Every plan the serving planner offers in ``mode``, each also at the
    next narrower chunk it could take (slab mode: beside resident and
    streamed weights)."""
    plans = FK.conv_plans(nb, *out_hw, c, o, k, k, (s, s), (1, 1), mode,
                          FK.smem_limits(dev), FK.serving_bns(o))
    chunks = FK.conv_chunks(mode, c)
    n = 3 if mode == "slab" else 2
    return [dataclasses.replace(p, ck=ck, resident=r)
            for p in plans for i in [chunks.index((p.ck, p.resident))]
            for ck, r in chunks[i:i + n]]


@pytest.mark.parametrize("s", [1, 2])
@pytest.mark.parametrize("mode", ["slab", "im2col"])
def test_dma_kernel_any_tile(cuda, mode, s):
    """Every plan the serving planner can pick in each mode at C = 128,
    O = 70 (ragged under every block), each also at the next narrower
    chunk (slab mode: the weights resident and streamed), with one tile a
    block and with all of an image's: equal to the plain version, every
    element written."""
    rng = np.random.default_rng(10 * s + len(mode))
    x = _rand(rng, (2, 21, 27, 128), cuda)
    wt = _rand(rng, (70, 3, 3, 128), cuda)
    ep = _ep(rng, 1152, 70, "SILU", cuda)
    out_hw = ((21 + 2 - 3) // s + 1, (27 + 2 - 3) // s + 1)
    ref = FK.conv2d_int8_halo_fused_plain(x, wt, None, ep, out_hw,
                                          ((1, 1), (1, 1)), s)
    plans = _serving_plans(2, out_hw, 128, 70, 3, s, mode, cuda)
    assert len({(p.tile_h, p.tile_w, p.bn) for p in plans}) == \
        len(FK.CONV_TILES) * len(FK.CONV_BNS)
    for plan in plans:
        for tpb in (1, 10 ** 6):
            out = torch.full(ref.shape, 99, dtype=torch.int8, device=cuda)
            FK._launch_conv(x, wt, None, ep, ((1, 1), (1, 1)), s, None, 1.0,
                            out, dataclasses.replace(plan,
                                                     tiles_per_block=tpb))
            torch.cuda.synchronize()
            _close(out, ref, "SILU")


# (C, O, residual offset): slab mode with 16-byte residual copies, with the
# residual byte by byte (O = 40, or the residual 1 byte off), im2col mode
# (C = 16) with 16-byte copies
RES_CASES = [(64, 64, 0), (64, 40, 0), (64, 64, 1), (16, 32, 0)]


@pytest.mark.parametrize("act", ["NONE", "RELU", "SILU"])
@pytest.mark.parametrize("case", RES_CASES, ids=str)
def test_serving_kernel_residual_paths(cuda, act, case):
    """#2 with a fused residual through both of its loads, at every tile
    and block the planner offers: equal to the plain version."""
    c, o, off = case
    rng = np.random.default_rng(c + o + off)
    x, wt = _rand(rng, (2, 19, 23, c), cuda), _rand(rng, (o, 3, 3, c), cuda)
    buf = _rand(rng, (off + 2 * 19 * 23 * o,), cuda)
    res = buf[off:].view(2, 19, 23, o)
    ep = _ep(rng, 9 * c, o, act, cuda)
    args = (x, wt, None, ep, (19, 23), ((1, 1), (1, 1)), 1, res, 0.21)
    ref = FK.conv2d_int8_halo_fused_plain(*args)
    _close(FK.conv2d_int8_halo_fused(*args), ref, act)
    for plan in FK.conv_plans(2, 19, 23, c, o, 3, 3, (1, 1), (1, 1),
                              FK.conv_mode(x, wt), FK.smem_limits(cuda),
                              FK.serving_bns(o)):
        out = torch.full(ref.shape, 99, dtype=torch.int8, device=cuda)
        FK._launch_conv(x, wt, None, ep, ((1, 1), (1, 1)), 1, res, 0.21, out,
                        dataclasses.replace(plan, tiles_per_block=3))
        torch.cuda.synchronize()
        _close(out, ref, act)


def test_dma_kernel_on_an_input_off_16_bytes(cuda):
    """C % 16 == 0 with the input 4 bytes past a 16-byte boundary: the
    plan takes im2col mode, and the kernel still equals its plain version
    and #2. The plan reads the card's own limits; the kernel's shared
    memory is the planner's for that plan."""
    lim = FK.smem_limits(cuda)
    assert lim.sms > 0 and 48 * 1024 < lim.per_block <= lim.per_sm
    rng = np.random.default_rng(7)
    x, wt, bias, out_hw = _dma_operands(rng, DMA_GPU_CASES[1], cuda)
    buf = torch.empty(x.numel() + 16, dtype=torch.int8, device=cuda)
    xs = buf[4:4 + x.numel()].view(x.shape)
    xs.copy_(x)
    assert xs.data_ptr() % 16 == 4
    assert FK.conv_mode(xs, wt) == "im2col" and FK.conv_mode(x, wt) == "slab"
    ep = _ep(rng, 288, 48, "LEAKY_RELU", cuda)
    args = (xs, wt, bias, ep, out_hw, ((1, 1), (1, 1)), 2)
    out = FK.conv2d_int8_halo_fused(*args, pipeline="dma")
    torch.cuda.synchronize()
    _close(out, FK.conv2d_int8_halo_fused_plain(*args), "LEAKY_RELU")
    assert torch.equal(out, FK.conv2d_int8_halo_fused(*args))
    plan = FK.serving_plan(xs, wt, out_hw, 2)
    smem, blocks = FK.conv_occupancy(plan, 32, (3, 3), 2, "LEAKY_RELU")
    assert smem == FK.conv_smem(plan.mode, 32, 3, 3, (2, 2), (1, 1),
                                plan.tile_h, plan.tile_w, plan.bn, plan.ck,
                                plan.resident)
    assert blocks >= 1


def test_dma_kernel_rejects_what_it_cannot_run(cuda):
    """A residual on #5 and LEAKY_RELU with a residual raise before any
    launch; a plan the kernel refuses raises (no fallback)."""
    rng = np.random.default_rng(6)
    x, wt, bias, out_hw = _dma_operands(rng, DMA_GPU_CASES[0], cuda)
    ep = _ep(rng, 288, 32, "RELU", cuda)
    res = _rand(rng, (2,) + out_hw + (32,), cuda)
    before = dict(FK.launches)
    with pytest.raises(ValueError, match="residual"):
        FK.conv2d_int8_halo_fused(x, wt, bias, ep, out_hw, ((1, 1), (1, 1)),
                                  residual=res, pipeline="dma")
    with pytest.raises(ValueError, match="LEAKY_RELU"):
        FK.conv2d_int8_halo_fused(x, wt, bias,
                                  _ep(rng, 288, 32, "LEAKY_RELU", cuda),
                                  out_hw, ((1, 1), (1, 1)), residual=res)
    assert FK.launches == before
    buf = _rand(rng, (1 + x.numel(),), cuda)
    xo = buf[1:].view(x.shape)
    out = torch.empty((2,) + out_hw + (32,), dtype=torch.int8, device=cuda)
    with pytest.raises(RuntimeError, match="tat_conv_int8_fused_mma"):
        FK._launch_conv(xo, wt, bias, ep, ((1, 1), (1, 1)), 1, None, 1.0,
                        out, FK.ConvPlan("slab", 8, 8, 32, 32, True, 1))
    with pytest.raises(RuntimeError, match="tat_conv_int8_fused_mma"):
        FK._launch_conv(x, wt, bias, ep, ((1, 1), (1, 1)), 1, None, 1.0,
                        out, FK.ConvPlan("slab", 8, 8, 48, 32, True, 1))


def _kxk_units(which: str, dev):
    """The KxK convs of one serving forward (``kxk_bench.kxk_convs``: a
    planned schedule's conv units, or the unplanned tier's KxK nodes),
    each as (label, the args of ``conv2d_int8_halo_fused`` without a
    residual, residual, res_scale): the engine's weights and epilogues,
    int8 inputs and residuals from a seed at batch 16."""
    from thingino_accel_tpu_torch import kxk_bench as KB
    eng, convs = KB.kxk_convs(which, dev)
    t = eng.graph.tensors
    rng = np.random.default_rng(len(which))
    units = []
    for node, ep, res, res_scale in convs:
        a = node.attrs
        hwc = tuple(t[node.inputs[0]].shape[1:])
        ohwo = tuple(t[node.outputs[0]].shape[1:])
        pads = FK.R._conv_pads(hwc[:2], ohwo[:2], a["kernel"], a["stride"],
                               a["dilation"], a["padding"], a["explicit_pad"])
        bias = eng.params[node.inputs[2]] if len(node.inputs) > 2 else None
        units.append((node.outputs[0], (
            _rand(rng, (16,) + hwc, dev), eng.params[node.inputs[1]], bias,
            ep, ohwo[:2], pads, a["stride"][0]),
            _rand(rng, (16,) + ohwo, dev) if res else None, res_scale))
    return units


# the serving paths and their KxK conv launches a forward
KXK_PATHS = {"planned_yolov5n": 8, "unplanned_yolov5n": 18,
             "zoo_yolov5s": 7, "nanodet": 1}


@pytest.mark.parametrize("which", list(KXK_PATHS))
def test_serving_kxk_units_of_the_models(cuda, which):
    """Every KxK conv of the planned and unplanned real yolov5n, the
    planned zoo yolov5s at 640 and NanoDet-320, at batch 16, through both
    entries (#2 with its residual, #5 without): each equal to its plain
    version (SILU within its bound), and the two entries equal bit for
    bit."""
    units = _kxk_units(which, cuda)
    assert len(units) == KXK_PATHS[which]
    for label, args, res, res_scale in units:
        x, w, _, ep, out_hw, _, s = args
        assert w.shape[1] > 1 or s > 1, label
        before = dict(FK.launches)
        got = FK.conv2d_int8_halo_fused(*args, residual=res,
                                        res_scale=res_scale)
        dma = FK.conv2d_int8_halo_fused(*args, pipeline="dma")
        torch.cuda.synchronize()
        assert FK.launches["conv2d_int8_halo_fused"] == \
            before["conv2d_int8_halo_fused"] + 1
        assert FK.launches["conv2d_int8_halo_dma"] == \
            before["conv2d_int8_halo_dma"] + 1
        _close(got, FK.conv2d_int8_halo_fused_plain(
            *args, residual=res, res_scale=res_scale), ep.act)
        _close(dma, FK.conv2d_int8_halo_fused_plain(*args), ep.act)
        bs = got if res is None else FK.conv2d_int8_halo_fused(*args)
        assert torch.equal(dma, bs), label


# the serving paths and their #1 + #3 launches a forward
GEMM_PATHS = {"planned_yolov5n": 32, "unplanned_yolov5n": 42,
              "zoo_yolov5s": 30, "nanodet": 16}


@pytest.mark.parametrize("which", list(GEMM_PATHS))
def test_gemm_units_of_the_models(cuda, which):
    """Every 1x1 unit (#1 and #3, ``csrc/mm_int8_fused_mma.cu``) of the
    planned and unplanned real yolov5n, the planned zoo yolov5s at 640 and
    NanoDet-320, at batch 16 (int8 inputs and residuals from a seed, the
    engine's weights, epilogues and part widths): each equal to its plain
    version (SILU within its bound), one launch of its own counter."""
    from thingino_accel_tpu_torch import kxk_bench as KB
    eng, units = KB.gemm_units(which, cuda)
    assert len(units) == GEMM_PATHS[which]
    t = eng.graph.tensors
    rng = np.random.default_rng(len(which))
    for kind, node, ep, widths, res, rs in units:
        oh, ow, n = t[node.outputs[0]].shape[1:]
        m = 16 * oh * ow
        xs = [_rand(rng, (m, k), cuda) for k in widths]
        ws = KB.gemm_weights(eng, node, widths)
        bias = eng.params[node.inputs[2]] if len(node.inputs) > 2 else None
        r = _rand(rng, (m, n), cuda) if res is not None else None
        name = ("matmul_int8_fused" if kind == "matmul"
                else "matmul_int8_fused_multi")
        before = FK.launches[name]
        got = KB.gemm_call(kind, xs, ws, bias, ep, r, rs)()
        torch.cuda.synchronize()
        assert FK.launches[name] == before + 1
        _close(got, KB.gemm_call(kind, xs, ws, bias, ep, r, rs, plain=True)(),
               ep.act if kind == "matmul" else ep.ep.act)


# (M, part widths, N, per-part scales): the planned real yolov5n's K_i =
# 16 unit, SPPF's 4 parts, a head, a ragged M, unequal parts
GEMM_PLAN_CASES = [(409600 // 16, (16, 16), 32, True),
                   (6400, (128,) * 4, 256, True), (20000, (64,), 255, False),
                   (1000, (40, 24, 8), 70, False)]


@pytest.mark.parametrize("case", GEMM_PLAN_CASES, ids=str)
def test_gemm_every_plan(cuda, case):
    """The 1x1 GEMM at every plan its planner offers for the card, each
    also at each ring depth and at 32 K bytes a stage, runs of 3 tiles:
    equal to its plain version (SILU within its bound) at SILU with a
    residual and at LEAKY_RELU without."""
    m, widths, n, per_part = case
    rng = np.random.default_rng(m + n)
    xs = [_rand(rng, (m, k), cuda) for k in widths]
    wfull = _rand(rng, (n, sum(widths)), cuda)
    offs = np.cumsum((0,) + widths)
    ws = [wfull[:, a:b] for a, b in zip(offs[:-1], offs[1:])]
    bias = torch.from_numpy(rng.integers(-2000, 2000, n).astype(
        np.int32)).to(cuda)
    res = _rand(rng, (m, n), cuda)
    scales = ((0.038, 0.046, 0.047, 0.049)[:len(widths)] if per_part
              else [0.05] * len(widths))
    plans = FK.mm_plans(m, n, widths, not per_part,
                        FK.smem_limits(cuda))
    assert plans
    for act, r in (("SILU", res), ("LEAKY_RELU", None)):
        me = FK.multi_epilogue(rng.uniform(0.005, 0.015, n).astype(
            np.float32), scales, 0.9, act, n, alpha=0.1,
            bias_scale=0.045 if per_part else None, device=cuda)
        assert me.same_scale != per_part
        ref = FK.matmul_int8_fused_multi_plain(xs, ws, bias, me, r, 0.4)
        for plan in plans:
            for variant in [dataclasses.replace(plan, stages=st,
                                                tiles_per_block=3)
                            for st in FK.MM_STAGES] + [
                                dataclasses.replace(plan, kc=32)]:
                out = torch.full((m, n), 99, dtype=torch.int8, device=cuda)
                FK._launch_gemm(xs, ws, bias, me.ep, me.part_scales,
                                me.same_scale, me.bias_scale, r, 0.4, out,
                                variant)
                torch.cuda.synchronize()
                _close(out, ref, act)


def test_gemm_refuses_what_it_cannot_run(cuda):
    """A plan the kernel refuses raises (no fallback): per-part at 128 x
    128, bn 48; so does SILU_FAST; the wrappers refuse LEAKY_RELU with a
    residual before any launch."""
    rng = np.random.default_rng(8)
    xs = [_rand(rng, (256, 64), cuda), _rand(rng, (256, 32), cuda)]
    ws = [_rand(rng, (128, 64), cuda), _rand(rng, (128, 32), cuda)]
    me = FK.multi_epilogue(0.01, [0.04, 0.05], 0.9, "SILU", 128,
                           device=cuda)
    out = torch.empty((256, 128), dtype=torch.int8, device=cuda)
    for plan in (FK.MmPlan(128, 128, 64, 4, 1), FK.MmPlan(64, 48, 64, 4, 1)):
        with pytest.raises(RuntimeError, match="tat_mm_int8_fused_mma"):
            FK._launch_gemm(xs, ws, None, me.ep, me.part_scales, False,
                            me.bias_scale, None, 1.0, out, plan)
    with pytest.raises(ValueError, match="SILU_FAST"):
        FK.matmul_int8_fused(xs[0], ws[0], None, FK.epilogue_rows(
            0.01, 0.05, 0.5, "SILU_FAST", 128, device=cuda))
    before = dict(FK.launches)
    with pytest.raises(ValueError, match="LEAKY_RELU"):
        FK.matmul_int8_fused(xs[0], ws[0], None, FK.epilogue_rows(
            0.01, 0.05, 0.5, "LEAKY_RELU", 128, device=cuda), out, 0.4)
    assert FK.launches == before


_RECIP_CHECK = r"""
#include <cuda_runtime.h>
#include "epilogue.cuh"
__global__ void check(unsigned lo, unsigned n, unsigned long long* bad) {
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const float d = __uint_as_float(lo + i);
    if (__float_as_uint(tat::recip_rn(d)) !=
        __float_as_uint(__fdiv_rn(1.0f, d)))
      atomicAdd(bad, 1ull);
  }
}
extern "C" int run(unsigned lo, unsigned n, void* bad) {
  check<<<4096, 256>>>(lo, n, static_cast<unsigned long long*>(bad));
  return static_cast<int>(cudaDeviceSynchronize());
}
"""


def test_silu_reciprocal_is_the_ieee_division(cuda, tmp_path):
    """The serving epilogue's SILU reciprocal (``tat::recip_rn``: the
    approximate reciprocal and one fused Newton step, no branch) equals
    ``__fdiv_rn(1.0f, d)`` for every float d in [1, 8.5e37), all 1.06e9 of
    them, on this card."""
    import ctypes
    import subprocess
    from thingino_accel_tpu_torch.ops import cuda_build
    src = tmp_path / "recip_check.cu"
    src.write_text(_RECIP_CHECK)
    lib = tmp_path / "recip_check.so"
    proc = subprocess.run(
        [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-shared", "-I",
         str(cuda_build.CSRC), "-o", str(lib), str(src)],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:]
    bad = torch.zeros(1, dtype=torch.int64, device=cuda)
    lo = int(np.float32(1.0).view(np.uint32))
    hi = int(np.float32(8.5e37).view(np.uint32))
    rc = ctypes.CDLL(str(lib)).run(ctypes.c_uint(lo), ctypes.c_uint(hi - lo),
                                   ctypes.c_void_p(bad.data_ptr()))
    assert rc == 0 and int(bad.item()) == 0, (rc, int(bad.item()))


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
    lut = _table("SILU", 0.04, cuda)
    for b, t in ((bias, None), (None, None), (bias, lut)):
        out = RK.matmul_int8_requant(x, w, b, cs, rm, relu, t)
        torch.cuda.synchronize()
        _close(out, RK.matmul_int8_requant_plain(x, w, b, cs, rm, relu, t),
               "NONE")


def _table(act, scale, dev):
    from thingino_accel_tpu_torch.runtime.executor import act_table
    return act_table(act, scale, alpha=0.1).to(dev)


# #9 on the 1x1 GEMM under the exact epilogue: (M, K, N) at every plan:
# SPPF's cv2 of the zoo yolov5s (K = 1024 -> N = 512), a head (N = 255),
# K off 32 (48), K off 16 (40: the byte path), ragged M
EXACT_GEMM_PLAN_CASES = [(6400, 1024, 512), (1000, 128, 255),
                         (777, 48, 96), (333, 40, 32)]


@pytest.mark.parametrize("rm,relu", RMODES)
@pytest.mark.parametrize("case", EXACT_GEMM_PLAN_CASES,
                         ids=lambda c: "m{}k{}n{}".format(*c))
def test_exact_gemm_every_plan(cuda, case, rm, relu):
    """Every plan ``mm_plans(..., exact=True)`` offers on this card, each
    ring depth and 32 K bytes a stage of the first, with the SILU table:
    bit for bit against the plain version, every element written; the
    kernel's shared memory is ``mm_smem``'s exact layout."""
    m, k, n = case
    rng = np.random.default_rng(m + k + n)
    x, w = _rand(rng, (m, k), cuda), _rand(rng, (n, k), cuda)
    bias = torch.from_numpy(rng.integers(-3000, 3000, n).astype(
        np.int32)).to(cuda)
    cs = RK.combined_scale(0.05, 0.01, float(0.0137 * np.sqrt(k)))
    lut = _table("SILU", 0.05, cuda)
    ref = RK.matmul_int8_requant_plain(x, w, bias, cs, rm, relu, lut)
    plans = FK.mm_plans(m, n, (k,), True, FK.smem_limits(cuda), exact=True)
    assert plans
    first = plans[0]
    variants = list(plans) + [dataclasses.replace(first, stages=st)
                              for st in (2, 3)] + [
        dataclasses.replace(first, kc=32, tiles_per_block=3)]
    for plan in variants:
        out = torch.full((m, n), 99, dtype=torch.int8, device=cuda)
        RK._launch_mm(x, w, bias, lut, cs, rm, relu, out, plan)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), plan
        smem, blocks = RK.mm_occupancy(plan, k)
        assert smem == FK.mm_smem((k,), plan.bm, plan.bn, plan.kc,
                                  plan.stages, exact=True) and blocks >= 1


@pytest.mark.parametrize("act", ["SILU", "SIGMOID", "RELU6", "LEAKY_RELU",
                                 "TANH", "HARD_SWISH"])
def test_exact_kernels_apply_each_table(cuda, act):
    """#9, #10 and #11 with each act's table, bit for bit against their
    plain versions and so against the act applied after the conv."""
    rng = np.random.default_rng(len(act))
    lut = _table(act, 0.043, cuda)
    for nb, h, w, c, o, kh, kw, s, pads in [
            (2, 20, 20, 64, 96, 1, 1, (1, 1), ((0, 0), (0, 0))),
            (2, 20, 20, 64, 64, 3, 3, (1, 1), ((1, 1), (1, 1))),
            (2, 20, 20, 64, 128, 3, 3, (2, 2), ((1, 1), (1, 1)))]:
        x, wt = _rand(rng, (nb, h, w, c), cuda), _rand(rng, (o, kh, kw, c),
                                                       cuda)
        out_hw = _conv_out_hw(h, w, kh, kw, s, (1, 1), pads)
        args = (x, wt, None, out_hw, s, (1, 1), pads, 0.05, 0.01,
                float(0.0137 * np.sqrt(kh * kw * c)))
        out = RK.conv2d_int8(*args, lut=lut)
        torch.cuda.synchronize()
        ref = RK.conv2d_int8(*args, plain=True, lut=lut)
        _close(out, ref, "NONE")
        assert torch.equal(ref, RK.apply_table(
            RK.conv2d_int8(*args, plain=True), lut))


def test_exact_yolov5s_1x1_units(cuda):
    """Every distinct #9 unit of the exact zoo yolov5s at 640 (18, 42 a
    forward) at batch 2 with its own table (SILU; the heads none): bit for
    bit against its plain version, one launch each."""
    from thingino_accel_tpu_torch import kxk_bench as KB
    eng, units = KB.exact_1x1_units("cuda")
    distinct = {KB.exact_1x1_key(eng, u, 2): u for u in units}
    assert len(units) == 42 and len(distinct) == 18
    rng = np.random.default_rng(9)
    for (m, k, n, act, _), u in distinct.items():
        x2 = _rand(rng, (m, k), cuda)
        assert (u.lut is not None) == (act == "SILU")
        before = RK.launches["matmul_int8_requant"]
        out = KB.exact_1x1_call(eng, u, x2)()
        torch.cuda.synchronize()
        assert RK.launches["matmul_int8_requant"] == before + 1
        _close(out, KB.exact_1x1_call(eng, u, x2, plain=True)(), "NONE")


def test_exact_gemm_refuses_what_it_cannot_run(cuda):
    rng = np.random.default_rng(3)
    x, w = _rand(rng, (64, 64), cuda), _rand(rng, (64, 64), cuda)
    out = torch.empty((64, 64), dtype=torch.int8, device=cuda)
    for plan in [FK.MmPlan(96, 64, 64, 4, 1), FK.MmPlan(64, 48, 64, 4, 1),
                 FK.MmPlan(64, 64, 48, 4, 1), FK.MmPlan(64, 64, 64, 5, 1)]:
        with pytest.raises(RuntimeError, match="tat_mm_int8_requant_mma"):
            RK._launch_mm(x, w, None, None, 0.01, RoundMode.HALF_AWAY,
                          False, out, plan)
    with pytest.raises(ValueError, match="lut"):
        RK.matmul_int8_requant(x, w, None, 0.01,
                               lut=torch.zeros(255, dtype=torch.int8,
                                               device=cuda))


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


# The tensor-core KxK kernel behind #10 and #11: two shapes of each mode
# (batch, H, W, C, O, KH, KW, stride, dilation, pads): slab at #10's lead
# shape and at the C-chunked 3x3/s2 256 -> 512; im2col at the stem and at
# a ragged 5x5 with C = 6, O = 70
MMA_PLAN_CASES = {
    "slab": [(2, 40, 40, 128, 128, 3, 3, (1, 1), (1, 1), ((1, 1), (1, 1))),
             (2, 40, 40, 256, 512, 3, 3, (2, 2), (1, 1), ((1, 0), (1, 0)))],
    "im2col": [(2, 64, 96, 3, 32, 6, 6, (2, 2), (1, 1), ((2, 2), (2, 2))),
               (2, 13, 10, 6, 70, 5, 5, (1, 1), (1, 1), ((2, 2), (2, 2)))],
}


@pytest.mark.parametrize("rm,relu", RMODES)
@pytest.mark.parametrize("mode,i", [(m, i) for m in MMA_PLAN_CASES
                                    for i in range(2)])
def test_requant_mma_every_plan(cuda, mode, i, rm, relu):
    """Every plan ``conv_requant_plans`` offers on this card in ``mode``
    (the mode the wrapper takes for the case), against the plain version
    bit for bit, every element written."""
    nb, h, w, c, o, kh, kw, s, d, pads = MMA_PLAN_CASES[mode][i]
    rng = np.random.default_rng(h + c + o + i)
    x, wt = _rand(rng, (nb, h, w, c), cuda), _rand(rng, (o, kh, kw, c), cuda)
    bias = torch.from_numpy(rng.integers(-3000, 3000, o).astype(
        np.int32)).to(cuda)
    assert RK.conv_mode(x, wt) == mode
    out_hw = _conv_out_hw(h, w, kh, kw, s, d, pads)
    scales = (0.05, 0.01, float(0.0137 * np.sqrt(kh * kw * c)))
    ref = RK.conv2d_int8(x, wt, bias, out_hw, s, d, pads, *scales, rm, relu,
                         plain=True)
    plans = RK.conv_requant_plans(nb, *out_hw, c, o, kh, kw, s, d, mode,
                                  FK.smem_limits(cuda))
    assert len(plans) == len(RK.CONV_TILES) * len(RK.CONV_BNS)
    for plan in plans:
        out = torch.full(ref.shape, 99, dtype=torch.int8, device=cuda)
        RK._launch_conv(x, wt, bias, RK.combined_scale(*scales), s, d, pads,
                        rm, relu, out, plan)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), plan
        smem, blocks = RK.conv_occupancy(plan, c, (kh, kw), s, d)
        assert smem == RK.conv_requant_smem(mode, c, kh, kw, s, d,
                                            plan.tile_h, plan.tile_w,
                                            plan.bn, plan.ck, plan.resident)
        assert blocks >= 1


def _yolov5s_kxk():
    from thingino_accel_tpu_torch.models import zoo
    return RK.kxk_convs(zoo.build_yolov5("s", zoo.ZooConfig()))


@pytest.mark.parametrize("i", range(11))
def test_requant_mma_yolov5s_shapes(cuda, i):
    """The 11 distinct KxK convs of the exact zoo yolov5s at 640 (18 a
    forward), at batch 2 through ``conv2d_int8``: bit for bit against the
    plain version, one launch of the routed counter, the stem in im2col
    mode and the rest in slab mode."""
    k = _yolov5s_kxk()[i]
    rng = np.random.default_rng(100 + i)
    x, wt = _rand(rng, (2, k.h, k.w, k.c), cuda), _rand(
        rng, (k.o,) + k.ksize + (k.c,), cuda)
    bias = torch.from_numpy(rng.integers(-3000, 3000, k.o).astype(
        np.int32)).to(cuda)
    assert RK.conv_mode(x, wt) == ("im2col" if k.c == 3 else "slab")
    args = (x, wt, bias, (k.oh, k.ow), k.stride, k.dilation, k.pads, 0.05,
            0.01, float(0.0137 * np.sqrt(k.ksize[0] * k.ksize[1] * k.c)))
    before = RK.launches[k.kernel]
    out = RK.conv2d_int8(*args)
    torch.cuda.synchronize()
    assert RK.launches[k.kernel] == before + 1
    _close(out, RK.conv2d_int8(*args, plain=True), "NONE")


# ---------------------------------------------------------------------------
# The probes' kernels: E1 chain_mma, E3 megakernel_probe, E4 add_one
# ---------------------------------------------------------------------------

def _probe_close(got, ref, kind, stages):
    """int8 kinds bit-exact (SILU_FAST too: both sides divide in IEEE f32);
    SILU within the SILU bound after one stage, at most 1% of the values
    apart after more; bf16 within 2^-7 of the largest output (the tensor
    cores' f32 sums against float64 ones)."""
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if kind in ("bf16", "bf16-3x3"):
        r = ref.float()
        tol = float(r.abs().max()) * 2.0 ** -7
        assert float((got.float() - r).abs().max()) <= tol
    elif PK.MEGA_ACT.get(kind) == "SILU":
        if stages == 1:
            _close(got, ref, "SILU")
        else:
            d = (got.to(torch.int32) - ref.to(torch.int32)).abs()
            assert float((d > 0).double().mean()) <= 1e-2
    else:
        _close(got, ref, "NONE")


def _chain_operands(rng, kind, rows, k, l, dev, wvals=None):
    if kind == "bf16":
        x = torch.from_numpy(rng.normal(size=(rows, k))).to(torch.bfloat16)
        w = torch.from_numpy(rng.normal(size=(l, k, k)) * 0.05).to(
            torch.bfloat16)
        return x.to(dev), w.to(dev)
    x = torch.from_numpy(rng.integers(-100, 100, (rows, k), dtype=np.int8))
    w = (torch.from_numpy(rng.choice(np.array(wvals, np.int8), (l, k, k)))
         if wvals is not None else
         torch.from_numpy(rng.integers(-100, 100, (l, k, k), dtype=np.int8)))
    if kind == "int4w":
        w = PK.pack_int4(w)
    return x.to(dev), w.to(dev)


@pytest.mark.parametrize("k", [128, 512])
@pytest.mark.parametrize("kind", PK.CHAIN_KINDS)
def test_chain_kernel_matches_plain(cuda, kind, k):
    """E1's chains over 1000 rows (off every block size), L = 3, with
    the plan the launcher picks; one launch a call."""
    rng = np.random.default_rng(k)
    x, w = _chain_operands(rng, kind, 1000, k, 3, cuda)
    before = PK.launches["chain_mma"]
    out = PK.chain_mma(x, w, kind)
    torch.cuda.synchronize()
    assert PK.launches["chain_mma"] == before + 1
    _probe_close(out, PK.chain_mma_plain(x, w, kind), kind, 3)


@pytest.mark.parametrize("kind", PK.CHAIN_KINDS)
def test_chain_kernel_every_plan(cuda, kind):
    """Every block (128 rows, and 64 for bf16 and mixed), weight chunk and
    ring depth the planner offers this card, at K = 128, 256 and 512."""
    lim = FK.smem_limits(cuda)
    rng = np.random.default_rng(9)
    n = 0
    for k in (128, 256, 512):
        x, w = _chain_operands(rng, kind, 300, k, 2, cuda)
        ref = PK.chain_mma_plain(x, w, kind)
        for plan in PK.chain_plans(kind, k, lim):
            out = torch.empty_like(x)
            PK._launch_chain(x, w, kind, out, plan)
            torch.cuda.synchronize()
            _probe_close(out, ref, kind, 2)
            smem, blocks = PK.chain_occupancy(kind, k, plan)
            assert smem == PK.chain_smem(kind, k, plan) and blocks >= 1
            n += 1
    assert n >= 12


@pytest.mark.parametrize("variant", ["no_glue", "no_product", "neither"])
def test_chain_measurement_builds_launch(cuda, variant):
    """``kxk_bench``'s measurement builds of the row chain
    (``CHAIN_VARIANTS``: ``-DTAT_CHAIN_NO_GLUE`` / ``_NO_PRODUCT``, which
    split E1's time into glue and product) build and launch at the blocks
    the launcher picks for the sweep's rows, for the int8 and bf16 chains
    at K = 256 and 512; the library's build beside them still equals its
    plain version."""
    from thingino_accel_tpu_torch import kxk_bench as KB
    from thingino_accel_tpu_torch.ops import cuda_build
    lib = cuda_build.load_variant("chain_mma.cu", KB.CHAIN_VARIANTS[variant],
                                  ("tat_chain_mma", "tat_chain_mma_info"))
    lim = FK.smem_limits(cuda)
    rng = np.random.default_rng(4)
    for kind in ("int8", "bf16"):
        for k in (256, 512):
            x, w = _chain_operands(rng, kind, 600, k, 2, cuda)
            plan = PK.chain_plan(kind, 32768, k, lim)
            PK._launch_chain(x, w, kind, torch.empty_like(x), plan, lib)
            out = torch.empty_like(x)
            PK._launch_chain(x, w, kind, out, plan)
            torch.cuda.synchronize()
            _probe_close(out, PK.chain_mma_plain(x, w, kind), kind, 2)


def test_chain_kernel_int4_wrap_edges(cuda):
    """int4w weights drawn from the wrap edges (+-8, +-16, -100, 9, 7,
    -9, 127, -128): the kernel equals its plain version, which multiplies
    by the weights wrapped as ``astype(jnp.int4)``."""
    rng = np.random.default_rng(12)
    edges = [8, -8, 16, -16, -100, 9, 7, -9, 127, -128]
    x, w = _chain_operands(rng, "int4w", 500, 256, 2, cuda, edges)
    out = PK.chain_mma(x, w, "int4w")
    torch.cuda.synchronize()
    ref = PK.chain_mma_plain(x, w, "int4w")
    _probe_close(out, ref, "int4w", 2)
    xi = x.cpu().to(torch.float64)
    wi = PK.unpack_int4(w.cpu()).to(torch.float64)
    assert set(PK.unpack_int4(w.cpu()).unique().tolist()) <= set(range(-8, 8))
    first = ((xi @ wi[0].t()).to(torch.int32) >> 5).to(torch.int8)
    assert torch.equal(first, PK.chain_mma_plain(x[:, :].cpu(), w[:1].cpu(),
                                                 "int4w"))


@pytest.mark.parametrize("kind", [k for k in PK.MEGA_KINDS
                                  if not PK.is_spatial(k)])
def test_megakernel_1x1_matches_plain(cuda, kind):
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.integers(-100, 100, (1000, 256),
                                      dtype=np.int8)).to(cuda)
    w = torch.from_numpy(rng.integers(-100, 100, (3, 1, 256, 256),
                                      dtype=np.int8)).to(cuda)
    cs = torch.from_numpy(rng.uniform(0.5, 2.0, 256).astype(np.float32)).to(
        cuda)
    for stages in (1, 3):
        out = PK.megakernel_chain(kind, x, w[:stages], cs)
        torch.cuda.synchronize()
        _probe_close(out, PK.megakernel_chain_plain(kind, x, w[:stages], cs),
                     kind, stages)


def _spatial_operands(rng, kind, k, h, l, cells, dev):
    e0 = h + 2 * l
    if kind == "bf16-3x3":
        x = torch.from_numpy(rng.normal(size=(cells, e0, e0, k))).to(
            torch.bfloat16)
        w3 = torch.from_numpy(rng.normal(size=(l, 9, k, k)) * 0.05).to(
            torch.bfloat16)
    else:
        x = torch.from_numpy(rng.integers(-100, 100, (cells, e0, e0, k),
                                          dtype=np.int8))
        w3 = torch.from_numpy(rng.integers(-100, 100, (l, 9, k, k),
                                           dtype=np.int8))
    w1 = torch.from_numpy(rng.integers(-100, 100, (l, 1, k, k),
                                       dtype=np.int8))
    cs = torch.from_numpy(rng.uniform(0.5, 2.0, k).astype(np.float32))
    w = (w1.to(dev), w3.to(dev)) if kind == "i8-c3-round" else w3.to(dev)
    return x.to(dev), w, cs.to(dev)


SPATIAL_KINDS = [k for k in PK.MEGA_KINDS if PK.is_spatial(k)]


@pytest.mark.parametrize("kind", SPATIAL_KINDS)
def test_megakernel_3x3_every_plan(cuda, kind):
    """Every block the planner offers this card for the taps at K = 64
    (resident and streamed weights, each chunk, ring depth and channel
    block), forced on every launch, at H = 8 on 3 cells: L = 1 (the SILU
    bound) and L = 2."""
    lim = FK.smem_limits(cuda)
    rng = np.random.default_rng(14)
    row = PK._row_bytes(kind, 64)
    plans = PK.stage_plans(9, row, 64, 12, lim)
    assert len(plans) >= 12 and any(not p.resident for p in plans)
    for l in (1, 2):
        x, w, cs = _spatial_operands(rng, kind, 64, 8, l, 3, cuda)
        ref = PK.megakernel_chain_plain(kind, x, w, cs)
        w1, w3 = w if kind == "i8-c3-round" else (None, w)
        for plan in plans:
            out = torch.empty(ref.shape, dtype=ref.dtype, device=cuda)
            PK._run_spatial(kind, x, w1, w3, cs, out, plan=plan)
            torch.cuda.synchronize()
            _probe_close(out, ref, kind, l)


@pytest.mark.parametrize("k", [256, 512])
@pytest.mark.parametrize("kind", SPATIAL_KINDS)
def test_megakernel_3x3_at_the_probe_size(cuda, kind, k):
    """The probe's cell (H = 32, L = 4) on 2 cells, with the plans the
    launcher picks for this card, one launch a stage (the C3 round two);
    SILU kinds also at L = 1; and a ragged cell, H = 29 at L = 2 (extents
    33, 31 and 29, none a multiple of 8)."""
    rng = np.random.default_rng(k)
    cases = [(32, l) for l in ((1, 4) if PK.MEGA_ACT.get(kind) == "SILU"
                               else (4,))] + [(29, 2)]
    for h, l in cases:
        x, w, cs = _spatial_operands(rng, kind, k, h, l, 2, cuda)
        before = PK.launches["megakernel_probe"]
        out = PK.megakernel_chain(kind, x, w, cs)
        torch.cuda.synchronize()
        assert PK.launches["megakernel_probe"] == before + (
            2 * l if kind == "i8-c3-round" else l)
        _probe_close(out, PK.megakernel_chain_plain(kind, x, w, cs), kind, l)


def test_megakernel_stage_kernel_occupancy(cuda):
    """The stage kernel's shared memory on the card is ``stage_smem``'s at
    the sweeps' picks, one block an SM where it takes more than half."""
    lim = FK.smem_limits(cuda)
    for ep, taps, k in ((PK.EP_RESIDUAL, 9, 256), (PK.EP_REQUANT, 1, 256),
                        (PK.EP_BF16, 9, 512), (PK.EP_SHIFT, 9, 512)):
        row = 2 * k if ep == PK.EP_BF16 else k
        plan = PK.stage_plan(taps, row, k, 400, lim)
        smem, blocks = PK.stage_occupancy(ep, taps, k, plan)
        assert smem == PK.stage_smem(taps, row, plan.bn, plan.kc,
                                     plan.stages, plan.resident, plan.wslots)
        assert blocks >= 1 and (blocks == 1 or 2 * smem <= lim.per_sm)


def test_probe_kernels_refuse_what_they_cannot_run(cuda):
    """A refused launch raises; nothing falls back."""
    rng = np.random.default_rng(15)
    x, w = _chain_operands(rng, "int8", 64, 512, 1, cuda)
    out = torch.empty_like(x)
    with pytest.raises(ValueError, match="do not tile"):   # a 48 chunk
        PK._launch_chain(x, w, "int8", out, PK.ChainPlan(128, 48, 2))
    for plan in (PK.ChainPlan(96, 64, 2), PK.ChainPlan(64, 64, 2),
                 PK.ChainPlan(128, 128, 4)):   # block, int8 at 64, memory
        with pytest.raises(RuntimeError, match="cudaError"):
            PK._launch_chain(x, w, "int8", out, plan)
    xs, ws, _ = _spatial_operands(rng, "i8-shift-3x3", 64, 8, 1, 1, cuda)
    outs = torch.empty((1, 8, 8, 64), dtype=torch.int8, device=cuda)
    for plan, taps in ((PK.StagePlan(48, 64, 3, True, 1), 9),   # block
                       (PK.StagePlan(64, 32, 3, True, 1), 9),   # chunk
                       (PK.StagePlan(64, 64, 3, True, 1), 5)):  # taps
        with pytest.raises(RuntimeError, match="cudaError"):
            PK._launch_stage(PK.EP_SHIFT, taps, xs, ws[0], None, None, outs,
                             "NONE", plan)
    with pytest.raises(ValueError, match="contiguous"):
        PK.chain_mma(x.t().contiguous().t(), w, "int8")


def test_add_one_kernel(cuda):
    for shape in ((256, 256), (1000,)):
        x = torch.randn(shape, device=cuda)
        before = PK.launches["add_one"]
        out = PK.add_one(x)
        torch.cuda.synchronize()
        assert PK.launches["add_one"] == before + 1
        assert torch.equal(out, PK.add_one_plain(x))


# E2's lagged conv: (x shape, O, act): the experiment's 80 x 80 x 128 ->
# 128 on 2 images, a ragged shape no tile divides, a small RELU one
LAGGED_CASES = [((2, 80, 80, 128), 128, "SILU"),
                ((2, 80, 80, 128), 128, "NONE"),
                ((16, 45, 77, 96), 72, "LEAKY_RELU"),
                ((3, 17, 9, 32), 16, "RELU")]


def _lagged_operands(rng, xs, o, act, dev):
    x = _rand(rng, xs, dev)
    w = _rand(rng, (o, 3, 3, xs[3]), dev)
    bias = torch.from_numpy(rng.integers(-2000, 2000, o).astype(np.int32)).to(
        dev)
    return x, w, bias, _ep(rng, 9 * xs[3], o, act, dev)


@pytest.mark.parametrize("case", LAGGED_CASES,
                         ids=lambda c: f"{'x'.join(map(str, c[0]))}-{c[1]}"
                                       f"-{c[2]}")
def test_lagged_conv_every_plan(cuda, case):
    """Both modes over every plan the launcher can take (each channel block
    and ring depth with its persistent blocks, and the first also with 1
    and 3 blocks walking every tile): equal to the plain version and to #5
    bit for bit, no element left unwritten; the wrapper counts one launch
    a call."""
    xs, o, act = case
    rng = np.random.default_rng(21)
    x, w, bias, ep = _lagged_operands(rng, xs, o, act, cuda)
    ref = PK.conv3x3_lagged_plain(x, w, bias, ep)
    dma = FK.conv2d_int8_halo_fused(x, w, bias, ep, xs[1:3], ((1, 1), (1, 1)),
                                    1, pipeline="dma")
    torch.cuda.synchronize()
    _close(dma, ref, act)
    plans = PK.lagged_plans(xs[0], xs[1], xs[2], xs[3], o,
                            FK.smem_limits(cuda))
    assert len(plans) == len(PK.LAGGED_BNS) * len(PK.LAGGED_STAGES)
    first = plans[0]
    plans += tuple(PK.LaggedPlan(first.bn, first.stages, b) for b in (1, 3))
    for plan in plans:
        for lag in (True, False):
            out = torch.full(ref.shape, 99, dtype=torch.int8, device=cuda)
            PK._launch_lagged(x, w, bias, ep, out, lag, plan)
            torch.cuda.synchronize()
            _close(out, ref, act)
            assert torch.equal(out, dma), (plan, lag)
    before = PK.launches["conv3x3_lagged"]
    for lag in (True, False):
        assert torch.equal(PK.conv3x3_lagged(x, w, bias, ep, lag), dma)
    assert PK.launches["conv3x3_lagged"] == before + 2


def test_lagged_conv_refusals_and_occupancy(cuda):
    """An input off 16 bytes is refused by the wrapper, a plan the kernel
    cannot run (a channel block wgmma takes but the kernel does not, one
    slab slot) by the kernel; both modes of E2's plan take the shared
    memory ``lagged_smem`` gives, one block an SM."""
    rng = np.random.default_rng(22)
    x, w, bias, ep = _lagged_operands(rng, (1, 8, 8, 32), 16, "NONE", cuda)
    flat = torch.empty(x.numel() + 4, dtype=torch.int8, device=cuda)
    off = flat[4:].view(x.shape)
    off.copy_(x)
    with pytest.raises(ValueError, match="aligned"):
        PK.conv3x3_lagged(off, w, bias, ep)
    out = torch.empty((1, 8, 8, 16), dtype=torch.int8, device=cuda)
    for bad in (PK.LaggedPlan(48, 2, 1), PK.LaggedPlan(32, 1, 1)):
        with pytest.raises(RuntimeError, match="cudaError"):
            PK._launch_lagged(x, w, bias, ep, out, True, bad)
    plan = PK.lagged_plan(128, 80, 80, 128, 128, FK.smem_limits(cuda))
    for lag in (True, False):
        assert PK.lagged_occupancy(lag, 128, plan) == (
            PK.lagged_smem(128, plan.bn, plan.stages), 1)


# -- the camera-stream path ----------------------------------------------------


def _nv12(rng, n, h=96, w=128):
    return rng.integers(0, 256, (n, h * 3 // 2, w), dtype=np.uint8)


def test_nv12_to_rgb_on_the_card_equals_the_cpu(cuda):
    """The conversion's bytes on the card equal the CPU's (which equal
    JAX's, ``tests/test_torch_streams.py``), at 720p and a small size."""
    rng = np.random.default_rng(30)
    for n, h, w in ((2, 720, 1280), (3, 6, 10)):
        nv = torch.from_numpy(_nv12(rng, n, h, w))
        assert torch.equal(Y.nv12_to_rgb(nv.to(cuda), h, w).cpu(),
                           Y.nv12_to_rgb(nv, h, w))


def test_streams_route_rows_on_the_card(cuda):
    """Five cameras of NV12 96x128 frames through MultiStreamBatcher(5, 4)
    and a watchdog'd StreamServer into the planned zoo yolov5n at 64 (heads
    at scale 0.25, so that scores pass): each camera's routed detections
    equal its frames run straight, bit for bit, and the CPU's within the
    decode's tolerance (valid masks and classes equal)."""
    from thingino_accel_tpu_torch.models import zoo
    from thingino_accel_tpu_torch.runtime.engine import Engine, EngineOptions
    from thingino_accel_tpu_torch.runtime.serving import (
        MultiStreamBatcher, StreamServer,
    )
    g = zoo.build_yolov5("n", zoo.ZooConfig(in_hw=(64, 64)))
    for o in g.outputs:
        g.tensors[o].quant = type(g.tensors[o].quant)(scale=0.25)
    opts = EngineOptions(precision="serving")
    pipes = {d: Y.build_serving_pipeline(Engine(g, opts, device=d))
             for d in ("cuda", "cpu")}
    fn = {d: (lambda p: lambda nv: p(Y.nv12_to_rgb(nv, 96, 128)))(p)
          for d, p in pipes.items()}
    rng = np.random.default_rng(31)
    cams = [_nv12(rng, 1 + i % 3) for i in range(5)]
    batcher = MultiStreamBatcher(5, 4)
    server = StreamServer(fn["cuda"], depth=2, device=cuda, timeout_s=60.0)
    routed = {i: [] for i in range(5)}
    for dets in server.run(batcher.batches([iter(c) for c in cams])):
        for row, s in enumerate(batcher.sources.popleft()):
            if s >= 0:
                routed[s].append((dets, row))
    assert server.healthy and server.stats.errors == 0
    n = 0
    for i, cam in enumerate(cams):
        straight = fn["cuda"](torch.from_numpy(cam).to(cuda))
        cpu = fn["cpu"](torch.from_numpy(cam))
        assert len(routed[i]) == len(cam)
        for j, (dets, row) in enumerate(routed[i]):
            for k in ("boxes", "scores", "classes", "valid"):
                assert torch.equal(getattr(dets, k)[row],
                                   getattr(straight, k)[j]), (i, j, k)
            assert torch.equal(dets.valid[row].cpu(), cpu.valid[j])
            assert torch.equal(dets.classes[row].cpu(), cpu.classes[j])
            assert torch.allclose(dets.scores[row].cpu(), cpu.scores[j],
                                  rtol=1e-6, atol=1e-12)
            n += int(dets.valid[row].sum())
    assert n > 0


def test_topk_postprocess_on_the_card(cuda):
    """``detect_postprocess_topk`` on the card against #8's decode + NMS at
    the same pool and against its own CPU run: counts and classes equal,
    scores within rtol 1e-5, boxes within rtol 1e-4 / atol 1e-3."""
    rng = np.random.default_rng(32)
    heads = [torch.from_numpy((rng.normal(size=(4, s, s, 255)) * 18)
                              .clip(-128, 127).astype(np.int8))
             for s in (80, 40, 20)]
    scales = [0.08, 0.09, 0.1]
    card = [h.to(cuda) for h in heads]
    got = Y.detect_postprocess_topk(card, scales=scales, pre_nms=128)
    refs = (Y.nms_batched(*DK.decode_and_parse_fused(card, scales=scales),
                          pre_nms=128, topk_group=8),
            Y.detect_postprocess_topk(heads, scales=scales, pre_nms=128))
    for ref in refs:
        for b in range(4):
            gv, rv = got.valid[b].cpu(), ref.valid[b].cpu()
            assert int(gv.sum()) == int(rv.sum()) > 0
            assert torch.equal(got.classes[b].cpu()[gv],
                               ref.classes[b].cpu()[rv])
            assert torch.allclose(got.scores[b].cpu()[gv],
                                  ref.scores[b].cpu()[rv], rtol=1e-5,
                                  atol=1e-6)
            assert torch.allclose(got.boxes[b].cpu()[gv],
                                  ref.boxes[b].cpu()[rv], rtol=1e-4,
                                  atol=1e-3)


def test_watchdog_on_the_card(cuda):
    """A batch whose device work outlasts ``timeout_s`` (a spin of about a
    second) raises InferenceTimeout and leaves the server unhealthy; after
    the device is synchronized an armed, healthy server passes a batch."""
    from thingino_accel_tpu_torch.runtime.serving import (
        InferenceTimeout, StreamServer,
    )

    def wedge(x):
        torch.cuda._sleep(2_000_000_000)
        return x + 1

    srv = StreamServer(wedge, depth=1, device=cuda, timeout_s=0.2)
    with pytest.raises(InferenceTimeout):
        list(srv.run(iter([np.zeros((2, 4), np.float32)])))
    assert not srv.healthy and srv.stats.errors == 1
    torch.cuda.synchronize()
    armed = StreamServer(lambda x: x + 1, depth=1, device=cuda,
                         timeout_s=5.0)
    outs = list(armed.run(iter([np.zeros((2, 4), np.float32)])))
    assert armed.healthy and torch.equal(outs[0].cpu(), torch.ones((2, 4)))


@pytest.mark.parametrize("accum", [None, torch.bfloat16])
def test_fast_conv_accumulation_on_the_card(cuda, accum):
    """``conv2d_f32`` in bf16 on the card against the CPU in the same
    accumulation mode: None adds the bias to float32 sums of the bf16
    values (TF32 allowed for the call: exact products, float32 sums), so
    each value is within 1 bf16 ulp of the CPU's and 2^-12 of the largest
    |output| (the sums' order differs; RELU and the bias cancel near 0);
    bf16 rounds the sums before the bias, so within 1 ulp and 2^-8 of the
    largest |output| (a sum's rounding is relative to the sum, not to the
    value after the bias). The global TF32 setting is left as it was."""
    from thingino_accel_tpu_torch.ops import reference as R
    rng = np.random.default_rng(33)
    x = torch.from_numpy(rng.normal(0, 1, (4, 40, 40, 64)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 0.1, (96, 3, 3, 64)).astype(
        np.float32))
    b = torch.from_numpy(rng.normal(0, 0.1, 96).astype(np.float32))
    args = ((40, 40), (1, 1), (1, 1), ((1, 1), (1, 1)), True, torch.bfloat16,
            accum)
    was = torch.backends.cudnn.allow_tf32
    got = R.conv2d_f32(x.to(cuda), w.to(cuda), b.to(cuda), *args).cpu()
    assert torch.backends.cudnn.allow_tf32 == was
    ref = R.conv2d_f32(x, w, b, *args).float()
    ulp = 2.0 ** (torch.floor(torch.log2(ref.abs().clamp_min(2.0 ** -100)))
                  - 7)
    floor = ref.abs().max() * (2.0 ** -12 if accum is None else 2.0 ** -8)
    assert got.dtype == torch.bfloat16
    assert ((got.float() - ref).abs() <= ulp + floor).all()


@pytest.mark.parametrize("tier", ["serving", "unplanned", "exact", "compat",
                                  "fast"])
@pytest.mark.parametrize("kind", ["int8", "recurrent"])
def test_ops_graphs_on_the_card(cuda, kind, tier):
    """``chip_smoke.py`` ``[ops]``' (c) and (d) at the tests' small size:
    the int8 ops graph and the recurrent graph (``models.ops_graphs``) in
    each tier that takes them, the card's outputs against the CPU's
    (``ops_graphs.check_outputs``: int8 bit for bit but SOFTMAX and POW,
    float32 within 1e-5 of the largest |output|, convs 1e-4, the fast
    tier's floats 2^-6), with cuDNN's TF32 off for the float convs (as
    ``chip_smoke.py`` runs) and the setting restored after."""
    from thingino_accel_tpu_torch.models import ops_graphs as OG
    from thingino_accel_tpu_torch.runtime.engine import Engine, EngineOptions
    g = (OG.int8_ops_graph(2, 16, 16, 16) if kind == "int8"
         else OG.recurrent_graph(2, 8, 16, 4, 8))
    g = OG.for_tier(g, tier)
    opts, planned = OG.TIERS[tier]
    t = g.tensors[g.inputs[0]]
    rng = np.random.default_rng(7)
    x = (rng.integers(-128, 128, t.shape, dtype=np.int8) if t.dtype == np.int8
         else rng.normal(0, 1, t.shape).astype(np.float32))
    was = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        card = Engine(g, EngineOptions(**opts), device=cuda,
                      planned=planned).run(x)
    finally:
        torch.backends.cudnn.allow_tf32 = was
    cpu = Engine(g, EngineOptions(**opts), device="cpu",
                 planned=planned).run(x)
    assert set(card) == set(g.outputs)
    assert all(v.is_cuda for v in card.values())
    OG.check_outputs(card, cpu, tier)


def _zoo_v5n_320(w_scale=0.002):
    from thingino_accel_tpu_torch.models import zoo
    return zoo.ZooConfig(in_hw=(320, 320), w_scale=w_scale)


def _frames_320(dev, n=4):
    frames = np.random.default_rng(8).integers(0, 256, (n, 320, 320, 3),
                                               dtype=np.uint8)
    return torch.from_numpy(frames).to(dev)


def _launched(fn):
    """``fn()``'s launches of every kernel (the counts set to 0 before)."""
    from thingino_accel_tpu_torch.ops import conv as C
    for mod in (FK, DK, RK, PK):
        mod.reset_launches()
    C.reset_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = {**FK.launches, **DK.launches, **RK.launches, **PK.launches,
              **C.counts}
    return out, {k: v for k, v in counts.items() if v}


def test_mars_writer_graph_serves_on_the_card(cuda):
    """``chip_smoke.py`` ``[onnx]`` (a) at the zoo yolov5n at 320: the
    graph written by ``export_mars`` and read back runs the planned serving
    tier's kernels, its census and one #8 a batch, and its heads equal the
    source graph's engine's on the card bit for bit."""
    from thingino_accel_tpu_torch.formats.mars_export import export_mars
    from thingino_accel_tpu_torch.models import zoo
    from thingino_accel_tpu_torch.runtime.engine import (
        Engine, EngineOptions, load_graph,
    )
    g = zoo.build_yolov5("n", _zoo_v5n_320())
    opts = EngineOptions(precision="serving")
    eng = Engine(load_graph(export_mars(g)), opts, device=cuda)
    pipe = Y.build_serving_pipeline(eng)
    fr = _frames_320(cuda)
    _, counts = _launched(lambda: pipe(fr))
    census = {k: v for k, v in eng._fn.launch_census().items() if v}
    assert counts == {**census, "decode_and_parse_fused": 1}
    x = Y.quantize_input_int8(fr)
    got, want = eng.forward(x), Engine(g, opts, device=cuda).forward(x)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_compiled_qdq_model_serves_on_the_card(cuda, tmp_path):
    """``[onnx]`` (b) at the zoo yolov5n at 320: its QDQ ONNX model
    (``models.onnx_fixtures.qdq_yolov5``) compiled by the CLI to an int8
    `.mars`, served planned: #1, #2, #3, #6 and one #8 launched, the heads
    equal the CPU's bit for bit."""
    from thingino_accel_tpu_torch import cli
    from thingino_accel_tpu_torch.models import onnx_fixtures
    from thingino_accel_tpu_torch.runtime.engine import Engine, EngineOptions
    src, out = str(tmp_path / "m.onnx"), str(tmp_path / "m.mars")
    with open(src, "wb") as f:
        f.write(onnx_fixtures.qdq_yolov5("n", _zoo_v5n_320()))
    assert cli.main(["compile", "-i", src, "-o", out]) == 0
    opts = EngineOptions(precision="serving")
    eng = Engine.from_mars(out, opts, device=cuda)
    pipe = Y.build_serving_pipeline(eng)
    fr = _frames_320(cuda)
    _, counts = _launched(lambda: pipe(fr))
    for k in ("matmul_int8_fused", "conv2d_int8_halo_fused",
              "matmul_int8_fused_multi", "bottleneck_int8_fused",
              "decode_and_parse_fused"):
        assert counts.get(k, 0) > 0, counts
    x = Y.quantize_input_int8(fr)
    got = eng.forward(x)
    want = Engine.from_mars(out, opts, device="cpu").forward(x.cpu())
    assert all(torch.equal(got[k].cpu(), want[k]) for k in want)


def test_exported_f32_model_runs_the_fast_tier_on_the_card(cuda, tmp_path):
    """``[onnx]`` (c) at the zoo yolov5n at 320: its heads graph through
    ``ir_to_onnx`` and ``compile --float32``, then the fast tier on the
    real-valued input: #8's bf16 mode once and no other kernel, the bf16
    heads within 2^-4 of the largest |head| of the CPU's float32 exact
    forward."""
    from thingino_accel_tpu_torch import cli
    from thingino_accel_tpu_torch.formats.onnx_export import ir_to_onnx
    from thingino_accel_tpu_torch.models import zoo
    from thingino_accel_tpu_torch.runtime.engine import (
        Engine, EngineOptions, load_graph,
    )
    g = zoo.build_yolov5("n", _zoo_v5n_320())
    src, out = str(tmp_path / "m.onnx"), str(tmp_path / "m.mars")
    with open(src, "wb") as f:
        f.write(ir_to_onnx(g))
    assert cli.main(["compile", "-i", src, "-o", out, "--float32"]) == 0
    fg = load_graph(out)
    fast = Engine(fg, EngineOptions(precision="fast"), device=cuda)
    x = Y.quantize_input_int8(_frames_320(cuda)).float() * float(
        np.float32(g.tensors[g.inputs[0]].quant.scale))
    names = fast.output_names
    heads, counts = _launched(lambda: fast.forward(x.to(torch.bfloat16)))
    dets, dcounts = _launched(lambda: DK.decode_and_parse_fused(
        [heads[k] for k in names]))
    assert not counts and dcounts == {"decode_and_parse_fused_bf16": 1}
    assert torch.isfinite(dets[0]).all()
    ref = Engine(fg, EngineOptions(precision="exact"),
                 device="cpu").forward(x.cpu())
    for k, r in ref.items():
        assert heads[k].dtype == torch.bfloat16
        err = float((heads[k].cpu().float() - r).abs().max())
        assert err <= 2.0 ** -4 * float(r.abs().max()), (k, err)
