"""``conv2d_int8_halo_fused(pipeline="dma")``, port vs JAX: the JAX
``conv2d_int8_folded(pipeline="dma")`` (Pallas body ``_halo_kernel_dma``,
run in interpret mode) against the port's KxK conv in its slab-ring mode,
whose CPU path is the plain version.

The JAX side takes its input W-folded by ``g = stride * f_out`` and
writes ``[N, OH, OW/f, f*O]``; both are numpy reshapes of NHWC. Tolerance:
NONE / RELU / LEAKY_RELU bit-exact; SILU at most 1 quantum on at most 0.1%
of the elements (XLA's and torch's sigmoid differ by ulps). The CUDA
kernel itself is held against the plain version in
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import zlib

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from thingino_accel_tpu.ops import fused_kernels as JFK
from thingino_accel_tpu_torch.ops import fused_kernels as FK

ALPHA = 0.1
# (k, stride, C, O, f_out, act): the JAX package's own dma test first, then
# a stride-2 case, C not a multiple of 16, the 6x6/s2 stem on 3 channels
# and a folded stride-2 case
DMA_CASES = [(3, 1, 32, 32, 2, "RELU"), (3, 2, 32, 48, 1, "SILU"),
             (3, 1, 24, 40, 2, "LEAKY_RELU"), (6, 2, 3, 16, 1, "SILU"),
             (3, 2, 32, 32, 2, "NONE")]


@pytest.fixture(autouse=True)
def _interpret_mode():
    with pltpu.force_tpu_interpret_mode():
        yield


def _rng(*parts):
    return np.random.default_rng(zlib.crc32(repr(parts).encode()))


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


def _dma_case(k, s, c, o):
    """2 images of 16x16 (32x32 for the stem), SAME-style pads
    (k - 1) // 2, per-channel weight scales, a non-zero bias."""
    rng = _rng("dma", k, s, c, o)
    h = w = 32 if k == 6 else 16
    p = (k - 1) // 2
    oh, ow = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
    x = rng.integers(-128, 128, (2, h, w, c), dtype=np.int8)
    wt = rng.integers(-64, 64, (k, k, c, o), dtype=np.int8)
    bias = rng.integers(-500, 500, (o,), dtype=np.int32)
    wsc = rng.uniform(0.01, 0.03, o).astype(np.float32)
    out_s = float(0.0137 * np.sqrt(k * k * c) * 5)
    return x, wt, bias, wsc, out_s, (oh, ow), ((p, p), (p, p))


def _jax_dma(x, wt, bias, wsc, out_s, out_hw, pads, s, act, f, **kw):
    nb, h, w, c = x.shape
    xf = x.reshape(nb, h, w // (s * f), s * f * c)
    return np.asarray(JFK.conv2d_int8_folded(
        xf, wt, bias, out_hw, s, pads, 0.05, wsc, out_s, act, ALPHA,
        f_out=f, pipeline="dma", **kw))


def _port(x, wt, bias, wsc, out_s, out_hw, pads, s, act, **kw):
    ep = FK.epilogue_rows(wsc, 0.05, out_s, act, wt.shape[3], ALPHA)
    return FK.conv2d_int8_halo_fused(
        _t(x), _t(wt.transpose(3, 0, 1, 2)), _t(bias), ep, out_hw, pads, s,
        **kw)


@pytest.mark.parametrize("k,s,c,o,f,act", DMA_CASES,
                         ids=lambda v: str(v))
def test_dma_matches_jax_dma(k, s, c, o, f, act):
    x, wt, bias, wsc, out_s, out_hw, pads = _dma_case(k, s, c, o)
    ref = _jax_dma(x, wt, bias, wsc, out_s, out_hw, pads, s, act, f)
    nb, (oh, ow) = x.shape[0], out_hw
    assert ref.shape == (nb, oh, ow // f, f * o)
    port = _port(x, wt, bias, wsc, out_s, out_hw, pads, s, act,
                 pipeline="dma").numpy()
    assert_act_close(port, ref.reshape(nb, oh, ow, o), act)


def test_dma_and_blockspec_take_the_plain_version_on_cpu(monkeypatch):
    """On the CPU both modes run the plain version, once each, and launch
    nothing."""
    calls = []
    plain = FK.conv2d_int8_halo_fused_plain

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return plain(*a, **kw)

    monkeypatch.setattr(FK, "conv2d_int8_halo_fused_plain", spy)
    args = _dma_case(3, 2, 32, 48)
    FK.reset_launches()
    dma = _port(*args, 2, "SILU", pipeline="dma")
    base = _port(*args, 2, "SILU", pipeline="blockspec")
    assert len(calls) == 2 and torch.equal(dma, base)
    assert not any(FK.launches.values())


def test_dma_with_residual_raises_in_both():
    x, wt, bias, wsc, out_s, out_hw, pads = _dma_case(3, 1, 32, 32)
    res = np.zeros((2,) + out_hw + (32,), np.int8)
    with pytest.raises(ValueError, match="residual"):
        _jax_dma(x, wt, bias, wsc, out_s, out_hw, pads, 1, "RELU", 1,
                 residual=res)
    with pytest.raises(ValueError, match="residual"):
        _port(x, wt, bias, wsc, out_s, out_hw, pads, 1, "RELU",
              pipeline="dma", residual=_t(res))


def test_unknown_pipeline_raises():
    args = _dma_case(3, 1, 32, 32)
    with pytest.raises(ValueError, match="pipeline"):
        _port(*args, 1, "NONE", pipeline="tma")


# ---------------------------------------------------------------------------
# the kernel's plan (shapes only; the kernel runs on the card): #2 and #5
# launch one tensor-core kernel, planned by the planner the exact tier's
# #10/#11 share, with the serving blocks (bn 16 where O <= 16)
# ---------------------------------------------------------------------------

# an H100 SXM: its SMs, an SM's shared memory, a block's most (opted in)
H100 = FK.SmemLimits(132, 233472, 232448)
# (batch, C, O, k, s, OH, OW): chip_smoke.py's cases and the models' convs,
# then the serving stems (the real yolov5n's 6x6/s2 3 -> 16, NanoDet's
# 3x3/s2 3 -> 24) and the C = 16 3x3/s2
PLAN_SHAPES = [(8, 64, 64, 3, 1, 80, 80), (16, 128, 128, 3, 1, 80, 80),
               (16, 128, 256, 3, 2, 40, 40), (16, 3, 32, 6, 2, 320, 320),
               (16, 256, 512, 3, 2, 20, 20), (16, 16, 32, 3, 2, 160, 160),
               (2, 5, 70, 3, 1, 16, 37), (16, 3, 16, 6, 2, 320, 320),
               (16, 3, 24, 3, 2, 160, 160)]


def _mode(c, aligned=True):
    return "slab" if c % 32 == 0 and aligned else "im2col"


def _plan(shape, aligned=True, limits=H100):
    nb, c, o, k, s, oh, ow = shape
    return FK.conv_plan(nb, oh, ow, c, o, k, k, (s, s), (1, 1),
                        _mode(c, aligned), limits, FK.serving_bns(o))


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda v: str(v))
def test_serving_plan_fits_its_blocks_per_sm(shape):
    """The plan is one the kernel takes, its block fits a block's opt-in,
    the blocks an SM its run of tiles was modelled on fit the SM's shared
    memory, and the run walks whole tiles of one image."""
    nb, c, o, k, s, oh, ow = shape
    plan = _plan(shape)
    assert plan.mode == _mode(c)
    assert (plan.tile_h, plan.tile_w) in FK.CONV_TILES
    assert plan.bn in FK.serving_bns(o)
    # no block issues fewer channels (the stem's O = 16 takes bn 16)
    assert -(-o // plan.bn) * plan.bn == min(-(-o // b) * b
                                             for b in FK.serving_bns(o))
    assert 1 <= plan.ck <= c and (plan.ck == c) <= plan.resident
    smem = FK.conv_smem(plan.mode, c, k, k, (s, s), (1, 1), plan.tile_h,
                        plan.tile_w, plan.bn, plan.ck, plan.resident)
    assert smem <= H100.per_block
    per_sm = min(2048 // FK.CONV_THREADS, FK.CONV_MAX_BLOCKS[plan.mode],
                 H100.per_sm // (smem + 1024))
    assert per_sm >= 1 and per_sm * (smem + 1024) <= H100.per_sm
    tiles = -(-oh // plan.tile_h) * -(-ow // plan.tile_w)
    assert 1 <= plan.tiles_per_block <= tiles
    assert plan == FK.conv_plans(nb, oh, ow, c, o, k, k, (s, s), (1, 1),
                                 plan.mode, H100, FK.serving_bns(o))[0]


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda v: str(v))
def test_serving_layout_regions_fit_and_align(shape, aligned):
    """The regions of the plan's layout hold what the kernel puts there,
    in order, without overlap, each 16-byte aligned (cp.async and
    ldmatrix rows; the output tile takes the residual's 16-byte copies);
    every ldmatrix pitch is an odd multiple of 16 bytes; an input off
    16 bytes takes im2col mode."""
    nb, c, o, k, s, oh, ow = shape
    plan = _plan(shape, aligned)
    th, tw, bn, ck = plan.tile_h, plan.tile_w, plan.bn, plan.ck
    lay = FK.conv_layout(plan.mode, c, k, k, (s, s), (1, 1), th, tw, bn, ck,
                         plan.resident)
    rows, cols = (th - 1) * s + k, (tw - 1) * s + k
    tp = th * tw
    offs = [lay.stage_bytes, lay.a_off, lay.w_off, lay.ktab_off, lay.out_off]
    assert all(v % 16 == 0 for v in offs)
    assert lay.smem == lay.out_off + tp * (bn + 16)
    assert (bn + 16) % 16 == 0
    if plan.mode == "slab":
        pitch = ck + 16
        assert pitch % 32 == 16
        assert lay.slab_bytes == rows * cols * pitch
        wpitch = k * k * (c if plan.resident else ck) + 16
        assert wpitch % 32 == 16
        assert lay.stage_bytes == lay.slab_bytes + (
            0 if plan.resident else bn * wpitch)
        assert lay.w_off == 2 * lay.stage_bytes
        assert lay.out_off == lay.w_off + (bn * wpitch if plan.resident
                                           else 0)
    else:
        assert not aligned or c % 32
        kc = -(-k * k * ck // 32) * 32
        assert (kc + 16) % 32 == 16
        assert rows * cols * ck <= lay.slab_bytes == lay.a_off
        assert lay.a_off + tp * (kc + 16) == lay.w_off
        assert lay.w_off + bn * (kc + 16) == lay.ktab_off
        assert lay.ktab_off + 3 * 4 * kc == lay.out_off


def test_serving_plan_chunks_c_at_256_to_512():
    """3x3/s2 256 -> 512 at 20 x 20: the slab of all C beside the
    resident weights passes a block's opt-in, so C is walked in chunks of
    a multiple of 32, the weights resident where they fit."""
    plan = _plan((16, 256, 512, 3, 2, 20, 20))
    assert plan.mode == "slab" and plan.ck < 256 and plan.ck % 32 == 0
    assert 256 % plan.ck == 0
    whole = FK.conv_smem("slab", 256, 3, 3, (2, 2), (1, 1), plan.tile_h,
                         plan.tile_w, plan.bn, 256, True)
    assert whole > H100.per_block


def test_serving_plan_reads_the_limits_it_is_given():
    """Fewer SMs give each block more tiles; less shared memory a block
    turns a plan of all C into a chunked one; none at all raises."""
    shape = (16, 128, 128, 3, 1, 80, 80)
    big = _plan(shape)
    few = _plan(shape, limits=FK.SmemLimits(33, H100.per_sm,
                                            H100.per_block))
    assert few.tiles_per_block > big.tiles_per_block
    small = FK.SmemLimits(132, 233472, 48 * 1024)
    wide = _plan((16, 256, 512, 3, 2, 40, 40))
    narrow = _plan((16, 256, 512, 3, 2, 40, 40), limits=small)
    assert narrow.ck < wide.ck or narrow.bn < wide.bn
    with pytest.raises(ValueError, match="fits"):
        _plan(shape, limits=FK.SmemLimits(132, 233472, 1024))
