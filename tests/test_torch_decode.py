"""Port vs JAX for the YOLO head decode (kernel #8's plain version,
``ops.decode_kernel.decode_and_parse_fused`` on CPU tensors).

The JAX side is ``decode_level_pallas`` in interpret mode, one call per
level, concatenated; where that kernel declines (a row count its tiles do
not divide) or mishandles (NaN logits) the JAX package's own
``decode_and_parse`` is the reference. Tolerances, the bounds of
``tests/test_decode_kernel.py``: classes exact, boxes within rtol 1e-6
and atol 1e-5, conf within rtol 1e-6 and atol 1e-7 (sigmoid differs by
ulps between the frameworks).
"""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from thingino_accel_tpu.models import yolo as JY
from thingino_accel_tpu.ops import decode_kernel as JDK
from thingino_accel_tpu_torch.models import yolo as Y
from thingino_accel_tpu_torch.ops import decode_kernel as DK

ANCH = Y.YOLOV5_ANCHORS
STRIDES = Y.YOLOV5_STRIDES


@pytest.fixture(autouse=True)
def _interpret_mode():
    with pltpu.force_tpu_interpret_mode():
        yield


def _heads(rng, b, hws, dtype, nc=80):
    shapes = [(b, h, w, 3 * (5 + nc)) for h, w in hws]
    if dtype == np.int8:
        return [rng.integers(-128, 128, s, dtype=np.int8) for s in shapes]
    return [rng.normal(0, 2, s).astype(np.float32) for s in shapes]


def _jax_pallas(heads, scales, nc=80):
    outs = [JDK.decode_level_pallas(
        h, np.asarray(ANCH[i]), STRIDES[i], nc,
        None if scales is None else scales[i]) for i, h in enumerate(heads)]
    assert all(o is not None for o in outs)
    return tuple(np.concatenate([np.asarray(o[j]) for o in outs], 1)
                 for j in range(3))


def _port(heads, scales, nc=80):
    b, c, k = DK.decode_and_parse_fused([torch.from_numpy(h) for h in heads],
                                        num_classes=nc, scales=scales)
    assert b.dtype == c.dtype == torch.float32 and k.dtype == torch.int32
    return b.numpy(), c.numpy(), k.numpy()


def _assert_decode_close(port, ref):
    np.testing.assert_allclose(port[0], ref[0], rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(port[1], ref[1], rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(port[2], ref[2])


@pytest.mark.parametrize("dtype,scales", [
    (np.int8, [0.043, 0.037, 0.051]), (np.float32, None)],
    ids=["int8", "f32"])
@pytest.mark.parametrize("b,hws", [(8, [(8, 8), (4, 4), (2, 2)]),
                                   (4, [(16, 8), (8, 4), (4, 2)])])
def test_decode_matches_jax_pallas(dtype, scales, b, hws):
    rng = np.random.default_rng(b + len(hws[0]) + (dtype == np.int8))
    heads = _heads(rng, b, hws, dtype)
    port = _port(heads, scales)
    assert port[0].shape == (b, sum(h * w * 3 for h, w in hws), 4)
    _assert_decode_close(port, _jax_pallas(heads, scales))


def test_first_occurrence_ties():
    """Equal max logits: the lowest class index, as jnp.argmax and the
    JAX kernel's int16 packing give; int8 and f32."""
    feat = np.zeros((1, 8, 8, 3 * 85), np.int8)
    feat[..., 5 + 7] = 100        # anchor 0: classes 7 and 19 tie
    feat[..., 5 + 19] = 100
    feat[..., 85 + 5:85 + 85] = -3   # anchor 1: all 80 tie
    for dtype in (np.int8, np.float32):
        f = feat.astype(dtype)
        ref = JDK.decode_level_pallas(f, np.asarray(ANCH[0]), 8, scale=0.05)
        b, c, k = DK.decode_and_parse_fused(
            [torch.from_numpy(f)], anchors=ANCH[:1], strides=(8,),
            scales=[0.05])
        _assert_decode_close((b.numpy(), c.numpy(), k.numpy()),
                             tuple(np.asarray(r) for r in ref))
        k = k.numpy().reshape(64, 3)
        assert (k[:, 0] == 7).all() and (k[:, 1] == 0).all()


def test_row_count_the_pallas_tiles_refuse():
    """Batch 1 at 20x20: 400 rows, which no Pallas tile height divides, so
    the JAX kernel declines and its caller falls back to the XLA decode.
    The port decodes any row count; it equals the JAX decode."""
    rng = np.random.default_rng(20)
    heads = _heads(rng, 1, [(80, 80), (40, 40), (20, 20)], np.int8)
    assert JDK.decode_level_pallas(heads[2], np.asarray(ANCH[2]), 32,
                                   scale=0.05) is None
    scales = [0.043, 0.037, 0.051]
    ref = JY.decode_and_parse(heads, scales=scales)
    _assert_decode_close(_port(heads, scales),
                         tuple(np.asarray(r) for r in ref))


@pytest.mark.parametrize("pattern", ["all", "partial", "first"])
def test_nan_logits_match_jax_decode(pattern):
    """f32 heads with NaN class logits: the class is the first NaN's
    index and conf is NaN, as the JAX ``decode_and_parse`` (jnp.argmax)
    gives; the JAX Pallas kernel gave ``num_classes`` for an all-NaN row
    (ROADMAP C.3), so it is not the reference here."""
    rng = np.random.default_rng(9)
    feat = rng.normal(0, 2, (2, 4, 4, 3, 85)).astype(np.float32)
    if pattern == "all":
        feat[..., 5:] = np.nan
    elif pattern == "partial":
        mask = rng.random((2, 4, 4, 3, 80)) < 0.05
        feat[..., 5:][mask] = np.nan
    else:
        feat[0, 1, 2, 1, 5 + 33] = np.nan
    feat = feat.reshape(2, 4, 4, 255)
    ref = JY.decode_and_parse([feat], anchors=ANCH[:1], strides=(8,))
    b, c, k = DK.decode_and_parse_fused([torch.from_numpy(feat)],
                                        anchors=ANCH[:1], strides=(8,))
    np.testing.assert_array_equal(k.numpy(), np.asarray(ref[2]))
    np.testing.assert_allclose(c.numpy(), np.asarray(ref[1]), rtol=1e-6,
                               atol=1e-7, equal_nan=True)
    np.testing.assert_allclose(b.numpy(), np.asarray(ref[0]), rtol=1e-6,
                               atol=1e-5)
    nan_rows = np.isnan(feat.reshape(2, 4, 4, 3, 85)[..., 5:]).any(-1)
    assert np.isnan(c.numpy().reshape(nan_rows.shape)[nan_rows]).all()
    if pattern == "all":
        assert (k.numpy() == 0).all()


def test_padded_head_raises():
    """A head whose channels are not A*(5+NC) (the lane-padded heads the
    JAX kernel silently handed back to the XLA decode) raises."""
    with pytest.raises(ValueError, match="channels"):
        DK.decode_and_parse_fused([torch.zeros((1, 4, 4, 3 * 128),
                                               dtype=torch.int8)],
                                  anchors=ANCH[:1], strides=(8,))
    with pytest.raises(ValueError, match="channels"):
        DK.decode_and_parse_fused([torch.zeros((1, 4, 4, 255),
                                               dtype=torch.int8)],
                                  anchors=ANCH[:1], strides=(8,),
                                  num_classes=79)
    with pytest.raises(TypeError, match="int8 or float32"):
        DK.decode_and_parse_fused([torch.zeros((1, 4, 4, 255),
                                               dtype=torch.int16)],
                                  anchors=ANCH[:1], strides=(8,))


def test_pipeline_decodes_through_the_wrapper(monkeypatch):
    """The serving pipeline calls the decode wrapper (which, on CPU
    tensors, runs the plain version) once per batch over the three
    heads."""
    from thingino_accel_tpu_torch.models import zoo
    from thingino_accel_tpu_torch.runtime.engine import Engine
    calls = []
    real = DK.decode_and_parse_fused

    def spy(feats, *a, **k):
        calls.append([tuple(f.shape) for f in feats])
        return real(feats, *a, **k)

    monkeypatch.setattr(DK, "decode_and_parse_fused", spy)
    eng = Engine(zoo.build_yolov5("n", zoo.ZooConfig(in_hw=(64, 64))),
                 device="cpu")
    pipe = Y.build_serving_pipeline(eng)
    frames = np.random.default_rng(0).integers(0, 256, (2, 48, 64, 3),
                                               dtype=np.uint8)
    dets = pipe(torch.from_numpy(frames))
    assert dets.boxes.shape == (2, 100, 4)
    assert calls == [[(2, 8, 8, 255), (2, 4, 4, 255), (2, 2, 2, 255)]]
