"""The YOLO post-processing beyond the serving decode, port vs JAX on the
same seeded numpy inputs (``thingino_accel_tpu_torch.models.yolo``).

Tolerances:
- ``decode_head_level`` / ``decode_heads`` (every channel's sigmoid) and
  ``parse_predictions`` (int8 at a scale and float, with and without
  ``already_sigmoid``): rtol 1e-6 (the two frameworks' sigmoids differ by
  ulps), atol 1e-4 px on boxes of up to 640 px and 1e-12 on scores;
  classes equal;
- ``detect_postprocess_topk`` against JAX's: the same counts and classes,
  scores within rtol 1e-5 / atol 1e-6, boxes within rtol 1e-4 / atol 1e-3
  (JAX's own test of it against the full decode, ``tests/test_yolo.py``),
  on int8 heads with scales, float heads, a float head among int8 ones
  (a None scale) and lane-padded heads; and the port's against its own
  full decode + NMS at the same pool, at the same tolerances;
- ``decode_anchor_free`` (DFL heads, seeded: no committed model has
  them): rtol 1e-5, atol 1e-4 px; conf rtol 1e-5; classes equal;
- ``make_anchor_tables``: equal;
- ``build_e2e_mars_pipeline`` on a graph the test builds (the zoo
  yolov5n's three heads -> RESHAPE -> CONCAT, [B, N, 85] predictions;
  no committed `.mars` emits them): equal valid masks and classes, boxes
  within 1e-3 px in frame pixels, scores within 1e-6 relative, against
  JAX's on the exact tier of both packages.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thingino_accel_tpu.ir.graph import Node, TensorInfo
from thingino_accel_tpu.models import yolo as JY
from thingino_accel_tpu.models import zoo
from thingino_accel_tpu.runtime import Engine as JEngine
from thingino_accel_tpu_torch.ir.graph import graph_from_jax
from thingino_accel_tpu_torch.models import yolo as Y
from thingino_accel_tpu_torch.runtime.engine import Engine

SIZES = (16, 8, 4)


def _int8_heads(seed, batch=2, blk=85, spread=18):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(batch, s, s, 3 * blk)) * spread)
            .clip(-128, 127).astype(np.int8) for s in SIZES]


def _t(arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _close(got, ref, rtol, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("level", range(3))
def test_decode_head_level_matches_jax(level):
    feat = (np.random.default_rng(level).normal(
        0, 3, (2, SIZES[level], SIZES[level], 255))).astype(np.float32)
    ref = JY.decode_head_level(jnp.asarray(feat),
                               jnp.asarray(JY.YOLOV5_ANCHORS[level]),
                               JY.YOLOV5_STRIDES[level])
    got = Y.decode_head_level(torch.from_numpy(feat), Y.YOLOV5_ANCHORS[level],
                              Y.YOLOV5_STRIDES[level])
    assert got.shape == ref.shape and got.dtype == torch.float32
    _close(got, ref, 1e-6, 1e-5)


def test_decode_heads_and_parse_match_jax():
    """The ``detect`` CLI's flow: int8 heads x their scales, decode_heads,
    parse_predictions(already_sigmoid=True), then NMS."""
    heads = _int8_heads(1)
    scales = [0.08, 0.09, 0.1]
    jf = [jnp.asarray(h).astype(jnp.float32) * jnp.float32(s)
          for h, s in zip(heads, scales)]
    pf = [h.to(torch.float32) * float(np.float32(s))
          for h, s in zip(_t(heads), scales)]
    jpred, ppred = JY.decode_heads(jf), Y.decode_heads(pf)
    _close(ppred, jpred, 1e-6, 1e-4)
    jb, jc, jk = JY.parse_predictions(jpred, 1.0, already_sigmoid=True)
    pb, pc, pk = Y.parse_predictions(ppred, 1.0, already_sigmoid=True)
    _close(pb, jb, 1e-6, 1e-4)
    _close(pc, jc, 1e-6, 1e-12)
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
    jd = JY.nms_batched(jb, jc, jk, conf_thresh=0.25)
    pd = Y.nms_batched(pb, pc, pk, conf_thresh=0.25)
    np.testing.assert_array_equal(pd.valid.numpy(), np.asarray(jd.valid))
    np.testing.assert_array_equal(pd.classes.numpy(), np.asarray(jd.classes))
    assert int(pd.num.sum()) > 0


@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_parse_predictions_matches_jax(dtype):
    rng = np.random.default_rng(3)
    if dtype == "int8":
        pred, scale = rng.integers(-128, 128, (2, 300, 85), dtype=np.int8), \
            0.0625
    else:
        pred, scale = rng.normal(0, 4, (2, 300, 85)).astype(np.float32), 1.0
    jb, jc, jk = JY.parse_predictions(jnp.asarray(pred), scale)
    pb, pc, pk = Y.parse_predictions(torch.from_numpy(pred), scale)
    _close(pb, jb, 1e-6, 1e-6)
    _close(pc, jc, 1e-6, 1e-12)
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))


def test_make_anchor_tables_equal_jax():
    shapes = [(s, s + 1) for s in SIZES]
    ref = JY.make_anchor_tables(shapes)
    got = Y.make_anchor_tables(shapes)
    assert ref.keys() == got.keys()
    for k in ref:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], ref[k])


def _assert_dets_close(got, ref):
    """Per frame: equal counts and classes; scores and boxes at JAX's
    tolerances (``tests/test_yolo.py``)."""
    for b in range(got.valid.shape[0]):
        gv, rv = got.valid[b].numpy(), np.asarray(ref.valid[b])
        assert gv.sum() == rv.sum()
        np.testing.assert_array_equal(got.classes[b].numpy()[gv],
                                      np.asarray(ref.classes[b])[rv])
        np.testing.assert_allclose(got.scores[b].numpy()[gv],
                                   np.asarray(ref.scores[b])[rv],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got.boxes[b].numpy()[gv],
                                   np.asarray(ref.boxes[b])[rv],
                                   rtol=1e-4, atol=1e-3)


def _topk_case(case):
    """(heads, scales) of one head kind."""
    if case == "int8":
        return _int8_heads(4), [0.08, 0.09, 0.1]
    if case == "float":
        return [h.astype(np.float32) * 0.09 for h in _int8_heads(5)], None
    if case == "mixed":
        heads = _int8_heads(6)
        heads[1] = heads[1].astype(np.float32) * 0.09
        return heads, [0.08, None, 0.1]
    # lane-padded: a per-anchor block of 128 channels, 85 of them read
    heads = _int8_heads(7, blk=128)
    for h in heads:
        h.reshape(*h.shape[:3], 3, 128)[..., 85:] = 127   # never read
    return heads, [0.08, 0.09, 0.1]


@pytest.mark.parametrize("case", ["int8", "float", "mixed", "padded"])
def test_detect_postprocess_topk_matches_jax(case):
    heads, scales = _topk_case(case)
    kw = dict(conf_thresh=0.25, iou_thresh=0.45, max_dets=50, pre_nms=256)
    ref = JY.detect_postprocess_topk([jnp.asarray(h) for h in heads],
                                     scales=scales, **kw)
    got = Y.detect_postprocess_topk(_t(heads), scales=scales, **kw)
    assert got.boxes.shape == (2, 50, 4)
    _assert_dets_close(got, ref)
    assert int(got.num.min()) > 0


def test_detect_postprocess_topk_matches_the_full_decode():
    """The port's top-k path against its own full decode + NMS at the same
    pool, as JAX's test holds JAX's."""
    heads, scales = _topk_case("int8")
    f32 = [h.to(torch.float32) * s for h, s in zip(_t(heads), scales)]
    ref = Y.nms_batched(*Y.decode_and_parse(f32), conf_thresh=0.25,
                        iou_thresh=0.45, max_dets=50, pre_nms=256)
    got = Y.detect_postprocess_topk(_t(heads), scales=scales,
                                    conf_thresh=0.25, iou_thresh=0.45,
                                    max_dets=50, pre_nms=256)
    _assert_dets_close(got, ref)


def test_detect_postprocess_topk_refuses_a_wrong_channel_count():
    heads = [torch.zeros((1, 4, 4, 3 * 90), dtype=torch.int8)]
    with pytest.raises(ValueError, match="head channels"):
        Y.detect_postprocess_topk(heads, scales=[0.1])


def test_decode_anchor_free_matches_jax():
    rng = np.random.default_rng(8)
    box = [rng.normal(0, 2, (2, s, s, 64)).astype(np.float32) for s in SIZES]
    cls = [rng.normal(0, 2, (2, s, s, 80)).astype(np.float32) for s in SIZES]
    jb, jc, jk = JY.decode_anchor_free([jnp.asarray(b) for b in box],
                                       [jnp.asarray(c) for c in cls])
    pb, pc, pk = Y.decode_anchor_free(_t(box), _t(cls))
    assert pb.shape == (2, sum(s * s for s in SIZES), 4)
    _close(pb, jb, 1e-5, 1e-4)
    _close(pc, jc, 1e-5, 1e-12)
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))


def _predictions_graph():
    """The zoo yolov5n at 64x64 emitting [1, N, 85] predictions: each
    head RESHAPEd to [1, H*W*3, 85], the three CONCATenated on axis 1, all
    at scale 0.25 (so that scores pass the threshold)."""
    g = copy.deepcopy(zoo.build_yolov5("n", zoo.ZooConfig(in_hw=(64, 64))))
    q = type(g.tensors[g.outputs[0]].quant)(scale=0.25)
    flat = []
    for i, o in enumerate(g.outputs):
        t = g.tensors[o]
        t.quant = q
        n = t.shape[1] * t.shape[2] * 3
        name = f"pred_{i}"
        g.tensors[name] = TensorInfo(name, (1, n, 85), np.dtype(np.int8), q)
        g.nodes.append(Node("RESHAPE", [o], [name],
                            {"shape": (1, n, 85)}, name=f"reshape_{i}"))
        flat.append((name, n))
    total = sum(n for _, n in flat)
    g.tensors["pred"] = TensorInfo("pred", (1, total, 85),
                                   np.dtype(np.int8), q)
    g.nodes.append(Node("CONCAT", [n for n, _ in flat], ["pred"],
                        {"axis": 1}, name="concat"))
    g.outputs = ["pred"]
    return g


def test_build_e2e_mars_pipeline_matches_jax():
    g = _predictions_graph()
    frame_hw = (96, 128)   # a size whose letterbox bytes equal JAX's
    frames = np.random.default_rng(13).integers(
        0, 256, (2,) + frame_hw + (3,), dtype=np.uint8)
    ref = JY.build_e2e_mars_pipeline(JEngine(g), frame_hw)(
        jnp.asarray(frames))
    eng = Engine(graph_from_jax(g), device="cpu")
    assert eng.options.precision == "exact"
    got = Y.build_e2e_mars_pipeline(eng, frame_hw)(torch.from_numpy(frames))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.classes.numpy(),
                                  np.asarray(ref.classes))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(ref.boxes),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores),
                               rtol=1e-6, atol=1e-12)
    assert int(got.num.min()) > 0
    b = got.boxes.numpy()[got.valid.numpy()]
    assert (b >= 0).all() and (b[:, 0::2] <= 127).all() \
        and (b[:, 1::2] <= 95).all()
