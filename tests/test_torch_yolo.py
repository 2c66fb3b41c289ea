"""Port vs JAX for the YOLO pre/post-processing of the serving path
(``thingino_accel_tpu_torch.models.yolo``).

Tolerances:
- letterbox: equal bytes at the camera sizes (720x1280 and 1080x1920 ->
  640, seed 0, batch 2) and at the small cases; at 180x320 -> 160 at most
  2e-5 of the bytes differ by 1 (measured: 3 of 153,600), where the
  reference's small dot sums each output's taps in two interleaved
  chains, not in one (the port's weights equal JAX's bit for bit
  everywhere);
- quantize: exact;
- uint8 frames -> detections through the serving pipeline on both
  packages' exact tier (360x640 frames -> 320, the 2x shrink of 720p ->
  640): as decode + NMS below;
- decode + NMS on identical int8 heads: valid masks and classes equal,
  boxes within 1e-4 px and scores within 1e-6 relative (sigmoid differs
  by ulps between the two frameworks).
"""

import numpy as np
import pytest
import torch

from thingino_accel_tpu.models import yolo as JY
from thingino_accel_tpu.models import zoo
from thingino_accel_tpu.runtime import Engine as JEngine
from thingino_accel_tpu.runtime import EngineOptions as JOptions
from thingino_accel_tpu_torch.models import yolo as Y

NMS_KW = dict(max_dets=100, pre_nms=128, topk_group=8)


# (frame size, target, largest share of differing bytes, measured)
LETTERBOX_CASES = {
    "down": ((96, 128), (64, 64), 0.0),
    "up": ((40, 30), (64, 64), 0.0),
    "same": ((64, 64), (64, 64), 0.0),
    "720p": ((720, 1280), (640, 640), 0.0),
    "1080p": ((1080, 1920), (640, 640), 0.0),
    "180x320": ((180, 320), (160, 160), 2e-5),
}


@pytest.mark.parametrize("hw,target,share", LETTERBOX_CASES.values(),
                         ids=LETTERBOX_CASES.keys())
def test_letterbox_matches_jax(hw, target, share):
    frames = np.random.default_rng(0).integers(
        0, 256, (2,) + hw + (3,), dtype=np.uint8)
    ref = np.asarray(JY.letterbox_uint8(frames, target))
    port = Y.letterbox_uint8(torch.from_numpy(frames), target).numpy()
    assert port.shape == ref.shape == (2,) + target + (3,)
    d = np.abs(port.astype(np.int32) - ref.astype(np.int32))
    assert d.max() <= (1 if share else 0), d.max()
    assert (d > 0).mean() <= share, (d > 0).mean()


def test_resize_weights_equal_jax():
    """Each axis's weights equal ``compute_weight_mat``'s bit for bit, at
    the camera sizes (2x and 3x shrinks) and an upsample."""
    from jax._src.image import scale as JS
    kernel = JS._kernels[JS.ResizeMethod.LINEAR]
    for n_in, n_out in [(720, 360), (1280, 640), (1080, 360), (1920, 640),
                        (30, 48)]:
        ref = np.asarray(JS.compute_weight_mat(n_in, n_out, n_out / n_in,
                                               0.0, kernel, True))
        index, weight = Y.resize_taps(n_in, n_out)
        dense = np.zeros((n_in, n_out), np.float32)
        for j in range(n_out):   # the padded taps add 0 to input 0
            np.add.at(dense[:, j], index[j], weight[j].astype(np.float32))
        np.testing.assert_array_equal(dense, ref)


def test_quantize_input_matches_jax():
    frames = np.arange(256, dtype=np.uint8).reshape(1, 4, 64, 1)
    ref = np.asarray(JY.quantize_input_int8(frames))
    port = Y.quantize_input_int8(torch.from_numpy(frames)).numpy()
    np.testing.assert_array_equal(port, ref)


def _postprocess_both(heads, scales, **kw):
    jb, jc, jk = JY.decode_and_parse(heads, scales=scales)
    pb, pc, pk = Y.decode_and_parse([torch.tensor(h) for h in heads],
                                    scales=scales)
    np.testing.assert_allclose(pb.numpy(), np.asarray(jb), rtol=0, atol=1e-4)
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-12)
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
    jd = JY.nms_batched(jb, jc, jk, **kw)
    pd = Y.nms_batched(pb, pc, pk, **kw)
    np.testing.assert_array_equal(pd.valid.numpy(), np.asarray(jd.valid))
    np.testing.assert_array_equal(pd.classes.numpy(), np.asarray(jd.classes))
    np.testing.assert_allclose(pd.boxes.numpy(), np.asarray(jd.boxes),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(pd.scores.numpy(), np.asarray(jd.scores),
                               rtol=1e-6, atol=1e-12)
    return pd


def test_postprocess_on_engine_heads_matches_jax():
    """Heads from the JAX engine over a zoo yolov5n at 64x64."""
    g = zoo.build_yolov5("n", zoo.ZooConfig(in_hw=(64, 64)))
    eng = JEngine(g, JOptions(precision="exact"))
    x = np.random.default_rng(7).integers(-128, 128, (2, 64, 64, 3),
                                          dtype=np.int8)
    out = eng.run_np(x)
    names = JY.find_detect_outputs(g) or list(eng.output_names)
    heads = sorted((out[n] for n in names), key=lambda h: -h.shape[1])
    scales = [g.tensors[n].quant.scale for n in eng.output_names]
    for conf in (0.25, 0.05):
        pd = _postprocess_both(heads, scales, conf_thresh=conf, **NMS_KW)
    assert int(pd.num.sum()) > 0   # the low threshold leaves detections


def test_postprocess_with_tied_scores_matches_jax():
    """Synthetic int8 heads drawn from a few values: scores tie constantly
    and boxes coincide, so the top-k tie order and the suppression
    fixpoint decide the output."""
    rng = np.random.default_rng(11)
    heads = []
    for hw in (16, 8, 4):
        h = rng.integers(-2, 3, (2, hw, hw, 3, 85)).astype(np.int8) * 8
        h[..., 4] = rng.choice([16, 40, 127], (2, hw, hw, 3))   # obj
        heads.append(h.reshape(2, hw, hw, 255))
    pd = _postprocess_both(heads, [0.05, 0.05, 0.05], **NMS_KW)
    assert int(pd.num.min()) > 0


def test_scale_boxes_matches_jax():
    boxes = np.random.default_rng(3).uniform(
        -20, 660, (2, 5, 4)).astype(np.float32)
    ref = np.asarray(JY.scale_boxes_to_original(boxes, (720, 1280)))
    port = Y.scale_boxes_to_original(torch.from_numpy(boxes), (720, 1280))
    np.testing.assert_allclose(port.numpy(), ref, rtol=0, atol=1e-4)


def test_nms_fixed_is_one_frame_of_nms_batched():
    rng = np.random.default_rng(5)
    boxes = torch.from_numpy(rng.uniform(0, 64, (300, 4)).astype(np.float32))
    scores = torch.from_numpy(rng.uniform(0, 1, 300).astype(np.float32))
    classes = torch.from_numpy(rng.integers(0, 3, 300).astype(np.int32))
    one = Y.nms_fixed(boxes, scores, classes, **NMS_KW)
    ref = JY.nms_fixed(boxes.numpy(), scores.numpy(), classes.numpy(),
                       **NMS_KW)
    np.testing.assert_array_equal(one.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(one.classes.numpy(),
                                  np.asarray(ref.classes))
    np.testing.assert_allclose(one.scores.numpy(), np.asarray(ref.scores))


def test_detections_from_frames_match_jax():
    """Seeded uint8 frames through the port's ``build_serving_pipeline``
    and through the JAX pipeline as ``bench.py`` composes it (letterbox ->
    int8 quantize -> engine -> decode -> NMS at conf 0.25, IoU 0.45, 100
    detections, pool 128, group 8), both over the exact tier of a zoo
    yolov5n at 320: 360x640 frames, the 2x shrink of 720p -> 640. The
    heads' scale is raised so that scores pass the threshold."""
    from thingino_accel_tpu_torch.ir.graph import graph_from_jax
    from thingino_accel_tpu_torch.runtime.engine import Engine, EngineOptions
    g = zoo.build_yolov5("n", zoo.ZooConfig(in_hw=(320, 320)))
    for o in g.outputs:
        g.tensors[o].quant = type(g.tensors[o].quant)(scale=0.25)
    frames = np.random.default_rng(12).integers(0, 256, (2, 360, 640, 3),
                                                dtype=np.uint8)
    eng = Engine(graph_from_jax(g), EngineOptions(precision="exact"),
                 device="cpu")
    dets = Y.build_serving_pipeline(eng)(torch.from_numpy(frames))
    jeng = JEngine(g, JOptions(precision="exact"))
    x = JY.quantize_input_int8(JY.letterbox_uint8(frames, (320, 320)))
    heads = jeng.run(x)
    jb, jc, jk = JY.decode_and_parse(
        [heads[o] for o in g.outputs],
        scales=[g.tensors[o].quant.scale for o in g.outputs])
    ref = JY.nms_batched(jb, jc, jk, **NMS_KW)
    np.testing.assert_array_equal(dets.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(dets.classes.numpy(),
                                  np.asarray(ref.classes))
    np.testing.assert_allclose(dets.boxes.numpy(), np.asarray(ref.boxes),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(dets.scores.numpy(), np.asarray(ref.scores),
                               rtol=1e-6, atol=1e-12)
    assert int(dets.num.sum()) > 0
