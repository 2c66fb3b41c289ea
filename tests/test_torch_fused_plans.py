"""The plans and shared-memory layouts of the fused C3 bottleneck (#6,
``fused_kernels.bneck_plan`` / ``bneck_layout``) and the fused SPPF (#4,
``sppf_plan`` / ``sppf_layout``), from shapes and an ``SmemLimits`` (an
H100's here; on the card ``smem_limits(device)`` reads them): a plan for
every unit the serving paths run, its layout's regions in order, 16-byte
aligned and within a block's shared memory, every plan the kernels are
built for offered where it fits, and a refusal where nothing fits. The
kernels' ``_info`` entries are held to these layouts by
``tests/test_torch_cuda_shim.py``, the kernels on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``."""

import pytest

from thingino_accel_tpu_torch.ops import fused_kernels as FK

H100 = FK.SmemLimits(132, 233472, 232448)

# the distinct #6 units (batch 16, C = CM = O, K = 3) of the planned real
# yolov5n and the planned zoo yolov5s at 640
BNECK_UNITS = [(80, 80, 32), (40, 40, 64), (20, 20, 128), (160, 160, 32),
               (80, 80, 64), (40, 40, 128), (20, 20, 256)]


def _cdiv(a, b):
    return -(-a // b)


@pytest.mark.parametrize("unit", BNECK_UNITS, ids=str)
def test_bneck_plan_fits_every_path_unit(unit):
    h, w, c = unit
    plan = FK.bneck_plan(16, h, w, c, c, c, 3, H100)
    lay = FK.bneck_layout(c, c, 3, plan.tile_h, plan.tile_w, plan.bn,
                          plan.resident)
    regions = [0, lay.m_off, lay.w1_off, lay.w2_off, lay.col_off,
               lay.out_off, lay.smem]
    assert regions == sorted(regions)
    assert all(r % 16 == 0 for r in regions)
    assert lay.smem <= H100.per_block
    assert (plan.tile_h, plan.tile_w) in FK.CONV_TILES
    assert (plan.tile_h * plan.tile_w // 64, plan.bn // 16) in \
        FK.FUSED_WARP_TILES
    tiles = 16 * _cdiv(h, plan.tile_h) * _cdiv(w, plan.tile_w)
    assert 1 <= plan.tiles_per_block <= tiles


def test_bneck_layout_holds_both_slabs_and_both_weights():
    """The regions' sizes at 20x20x256 with an 8x8 tile and bn 32: the
    10x10 halo'd slabs of x and m at 272 bytes a pixel, w1 256 rows of
    272, w2 32 rows of 9 x 256 + 16, 256 stage-1 columns of 8 bytes, 64
    staged pixels of 48."""
    lay = FK.bneck_layout(256, 256, 3, 8, 8, 32)
    streamed = FK.bneck_layout(256, 256, 3, 8, 8, 32, resident=False)
    assert streamed.col_off - streamed.w2_off == 2 * 32 * (256 + 16)
    assert lay.m_off == 100 * 272
    assert lay.w1_off - lay.m_off == 100 * 272
    assert lay.w2_off - lay.w1_off == 256 * 272
    assert lay.col_off - lay.w2_off == 32 * (9 * 256 + 16)
    assert lay.out_off - lay.col_off == 256 * 8
    assert lay.smem - lay.out_off == 64 * 48
    # C and CM off 32 are zero-filled up to it
    odd = FK.bneck_layout(6, 10, 5, 8, 8, 32)
    assert odd.m_off == 12 * 12 * 48 and odd.w2_off - odd.w1_off == 32 * 48


def test_bneck_plans_offer_every_block_that_fits():
    """At a small C every tile, channel block and w2 residence the kernel
    is built for fits and is offered, cheapest first; at C = 256 only bn 32
    fits beside the resident w1 and a resident w2 of all 256 channels, and
    bn 64 and 128 only with w2 streamed."""
    plans = FK.bneck_plans(2, 13, 18, 48, 40, 48, 3, H100)
    assert len(plans) == len(set(plans)) == 30
    assert {(p.tile_h * p.tile_w // 64, p.bn // 16) for p in plans} == \
        set(FK.FUSED_WARP_TILES)
    big = FK.bneck_plans(16, 20, 20, 256, 256, 256, 3, H100)
    assert {p.bn for p in big if p.resident} == {32}
    assert {p.bn for p in big if not p.resident} == {32, 64, 128}


def test_bneck_plan_reads_the_limits_it_is_given():
    small = FK.SmemLimits(132, 100 * 1024, 64 * 1024)
    for p in FK.bneck_plans(16, 40, 40, 128, 128, 128, 3, small):
        assert FK.bneck_smem(128, 128, 3, p.tile_h, p.tile_w, p.bn,
                             p.resident) <= small.per_block
    with pytest.raises(ValueError, match="bottleneck"):
        FK.bneck_plan(16, 20, 20, 256, 256, 256, 3, small)


# #4: the zoo yolov5s's unit, then the gpu tests' SPPF_CASES shapes
SPPF_UNITS = [(16, 20, 20, 256, 512, 5), (2, 6, 7, 36, 20, 5),
              (1, 9, 4, 10, 8, 3), (2, 12, 30, 33, 70, 5),
              (8, 20, 20, 256, 512, 5), (1, 20, 40, 32, 16, 5)]


@pytest.mark.parametrize("unit", SPPF_UNITS, ids=str)
def test_sppf_plan_fits_every_unit(unit):
    nb, h, w, c, o, k = unit
    plan = FK.sppf_plan(nb, h, w, c, o, k, H100)
    lay = FK.sppf_layout(h, w, c, k, plan.bm, plan.bn, plan.ck)
    regions = [0, lay.tmp_off, lay.l1_off, lay.l2_off, lay.a_off,
               lay.ring_off, lay.out_off, lay.smem]
    assert regions == sorted(regions)
    assert all(r % 16 == 0 for r in regions)
    assert lay.smem <= H100.per_block and lay.rows <= h
    assert plan.ck in FK.SPPF_CKS and plan.ck <= -(-c // 32) * 32
    tiles = nb * _cdiv(h * w, plan.bm)
    assert 1 <= plan.tiles_per_block <= tiles


def test_sppf_layout_stages_a_tiles_rows_and_halo():
    """64 consecutive pixels of a 20-wide image span at most 5 rows (4 and
    a partial one), with 6 halo rows each side at k = 5: 17 of the 20
    rows; 128 pixels take all 20; a 7-wide image of 6 rows, all 6. The
    regions at 20x20x256, bm 64, bn 64, ck 64: y and two levels of 17 x 20
    pixels at 80 bytes, the int16 row pass at 128, the A tile of 64 rows of
    4 x 256 + 16, four ring slots of 64 rows of 128 + 16 (the K slice: 128
    divides Cp = 256), 64 staged pixels of 80."""
    assert FK.sppf_layout(20, 20, 256, 5, 64, 128, 32).rows == 17
    assert FK.sppf_layout(20, 20, 256, 5, 128, 64, 64).rows == 20
    assert FK.sppf_layout(6, 7, 36, 5, 64, 32, 64).rows == 6
    lay = FK.sppf_layout(20, 20, 256, 5, 64, 64, 64)
    level = 17 * 20 * 80
    assert (lay.tmp_off, lay.l1_off - lay.tmp_off) == (level, 17 * 20 * 128)
    assert (lay.l2_off - lay.l1_off, lay.a_off - lay.l2_off) == (level, level)
    assert lay.ring_off - lay.a_off == 64 * (4 * 256 + 16)
    assert lay.out_off - lay.ring_off == 4 * 64 * (128 + 16)
    assert lay.smem - lay.out_off == 64 * 80
    # C off the chunk is zero-filled up to it; the K slice divides Cp
    assert FK.sppf_kc(33, 64) == 64 and FK.sppf_kc(10, 32) == 32
    odd = FK.sppf_layout(12, 30, 33, 5, 64, 32, 64)
    assert odd.ring_off - odd.a_off == 64 * (4 * 64 + 16)


def test_sppf_plans_offer_every_block_and_chunk_that_fits():
    plans = FK.sppf_plans(1, 11, 13, 100, 80, 5, H100)
    assert len(plans) == len(set(plans))
    assert {(p.bm // 64, p.bn // 16) for p in plans} == \
        set(FK.FUSED_WARP_TILES)
    assert {p.ck for p in plans} == set(FK.SPPF_CKS)
    assert len({(p.bm, p.bn, p.ck) for p in plans}) == len(plans)
    # C = 10: one chunk of 32 only
    small = FK.sppf_plans(1, 9, 4, 10, 8, 3, H100)
    assert {p.ck for p in small} == {32}


def test_sppf_plan_reads_the_limits_it_is_given():
    small = FK.SmemLimits(132, 100 * 1024, 64 * 1024)
    plans = FK.sppf_plans(2, 6, 7, 36, 20, 5, small)
    assert plans and len(plans) < len(FK.sppf_plans(2, 6, 7, 36, 20, 5, H100))
    for p in plans:
        assert FK.sppf_smem(6, 7, 36, 5, p.bm, p.bn, p.ck) <= small.per_block
    with pytest.raises(ValueError, match="SPPF"):
        FK.sppf_plan(1, 64, 512, 32, 16, 5, H100)   # 14 staged rows of 512
