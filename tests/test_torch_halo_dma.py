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
# the kernel's plan (shapes only; the kernel runs on the card)
# ---------------------------------------------------------------------------

# an H100 SXM: its SMs, an SM's shared memory, a block's most (opted in)
H100 = FK.SmemLimits(132, 233472, 232448)
# (batch, C, O, k, s, OH, OW): chip_smoke.py's cases and the models' convs
PLAN_SHAPES = [(8, 64, 64, 3, 1, 80, 80), (16, 128, 128, 3, 1, 80, 80),
               (16, 128, 256, 3, 2, 40, 40), (16, 3, 32, 6, 2, 320, 320),
               (16, 256, 512, 3, 2, 20, 20), (16, 16, 32, 3, 2, 160, 160),
               (2, 5, 70, 3, 1, 16, 37)]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda v: str(v))
def test_dma_plan_fits_and_pipelines(shape):
    nb, c, o, k, s, oh, ow = shape
    plan = FK.dma_plan(nb, c, o, k, k, s, oh, ow, H100)
    assert plan.tile_w in FK.DMA_TILE_WIDTHS
    assert plan.tile_h * plan.tile_w == 64
    assert 1 <= plan.ck <= c and (plan.ck == c or plan.ck % 4 == 0)
    assert plan.resident or c % 4 == 0
    smem = FK.dma_layout(c, k, k, s, plan.tile_h, plan.tile_w, plan.ck,
                         plan.resident).smem
    assert smem <= H100.per_sm // 2 - 1024   # two blocks an SM
    tiles = -(-oh // plan.tile_h) * -(-ow // plan.tile_w)
    stages = plan.tiles_per_block * -(-c // plan.ck)
    assert 1 <= plan.tiles_per_block <= tiles
    assert stages >= 2 or tiles == 1


@pytest.mark.parametrize("vec16", [True, False])
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda v: str(v))
def test_dma_layout_regions_fit_and_align(shape, vec16):
    """The regions of the plan's layout hold what the kernel puts there,
    do not overlap, and keep each copy's destination aligned to its width;
    an input that is not 16-byte aligned takes 4-byte copies."""
    nb, c, o, k, s, oh, ow = shape
    plan = FK.dma_plan(nb, c, o, k, k, s, oh, ow, H100, vec16)
    th, tw, ck = plan.tile_h, plan.tile_w, plan.ck
    lay = FK.dma_layout(c, k, k, s, th, tw, ck, plan.resident, vec16)
    rows, cols, kw4 = (th - 1) * s + k, (tw - 1) * s + k, -(-k * k * c // 4)
    pitch = 65 * 4
    want_vw = 16 if c % 16 == 0 and ck % 16 == 0 and vec16 else \
        4 if c % 4 == 0 else 1
    assert lay.vw == want_vw
    assert lay.slot_bytes % 16 == 0 and lay.res_off == 2 * lay.slot_bytes
    slab_end = lay.wslot_off if not plan.resident else lay.slot_bytes
    if lay.vw > 1:
        assert lay.pix_bytes >= ck and lay.pix_bytes % lay.vw == 0
        assert rows * cols * lay.pix_bytes <= slab_end
    else:
        assert lay.row_bytes >= cols * c + 3 and lay.row_bytes % 4 == 0
        assert rows * lay.row_bytes <= lay.rowadj_off
        assert lay.rowadj_off + 4 * rows <= slab_end
    if not plan.resident:
        assert lay.wslot_off % 16 == 0
        assert lay.wslot_off + k * k * (ck // 4) * pitch <= lay.slot_bytes
        assert lay.ktab_off == lay.res_off
    else:
        assert lay.res_off + kw4 * pitch <= lay.ktab_off
    if lay.vw == 1:
        assert lay.ktab_off + 4 * k * k * c <= lay.at_off
        assert lay.at_off + 64 * (kw4 + 1) * 4 == lay.smem
    else:
        assert lay.ktab_off == lay.at_off == lay.smem


@pytest.mark.parametrize("tile_w", FK.DMA_TILE_WIDTHS)
def test_dma_every_tile_fits_a_block(tile_w):
    """``tests/test_torch_gpu.py::test_dma_kernel_any_tile`` launches
    every tile width in each weight mode at C = 128, stride 1 and 2: each
    fits a block's 227 KB, and each passes 48 KB (the opt-in)."""
    for s in (1, 2):
        for ck, resident in ((128, True), (48, True), (48, False)):
            smem = FK.dma_layout(128, 3, 3, s, 64 // tile_w, tile_w, ck,
                                 resident).smem
            assert 48 * 1024 < smem <= H100.per_block, (s, ck, resident, smem)


def test_dma_plan_streams_weights_when_they_do_not_fit():
    """C = 128 at 3x3/s2: the 75 KB of weights stay resident and the
    slab is chunked; C = 256: 147 KB of weights pass the budget of two
    blocks an SM, so the weights stream with the chunks."""
    plan = FK.dma_plan(16, 128, 256, 3, 3, 2, 40, 40, H100)
    assert plan.resident and plan.ck < 128 and plan.ck % 16 == 0
    plan = FK.dma_plan(16, 256, 512, 3, 3, 2, 20, 20, H100)
    assert not plan.resident and plan.ck < 256 and plan.ck % 16 == 0
    # the byte path (C % 4 != 0) has one chunk or no plan
    with pytest.raises(ValueError, match="plan"):
        FK.dma_plan(1, 4001, 64, 3, 3, 1, 8, 8, H100)


def test_dma_plan_reads_the_device_it_is_given():
    """Fewer SMs give each block more tiles; less shared memory an SM
    turns a resident-weight plan into a streamed one."""
    big = FK.dma_plan(16, 128, 128, 3, 3, 1, 80, 80, H100)
    few = FK.dma_plan(16, 128, 128, 3, 3, 1, 80, 80,
                      FK.SmemLimits(33, H100.per_sm, H100.per_block))
    assert few.tiles_per_block > big.tiles_per_block
    a100 = FK.SmemLimits(108, 167936, 166912)
    assert FK.dma_plan(16, 128, 256, 3, 3, 2, 40, 40, H100).resident
    assert not FK.dma_plan(16, 128, 256, 3, 3, 2, 40, 40, a100).resident
