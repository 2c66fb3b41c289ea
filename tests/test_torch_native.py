"""The port's native host library (``thingino_accel_tpu_torch.native``:
ctypes over the repository's ``csrc/tat_native.cpp``, built into
``build/native/``) against the JAX package's ``native`` over the same
source and against the port's own Python counterparts
(``formats.packing``, ``models.yolo``); each test skips where the library
cannot build (no g++ or libjpeg), as JAX's do:

- every entry point equal to JAX's bit for bit on the same input:
  ``pack_nmhwsoib2`` / ``unpack_nmhwsoib2``, ``quantize_i8``,
  ``decode_jpeg``, ``letterbox``, ``space_to_depth_u8``, ``nms``;
- and to the port's Python counterpart: the packing functions and
  ``space_to_depth_frames`` bit for bit, the JPEG equal to PIL's,
  ``nms``'s kept scores those of ``models.yolo.nms_fixed`` (JAX's test
  rule) and its kept indices the Python fallback's, the letterbox of a
  flat image within 1 of its value inside the pad bars;
- with no library (``load`` returning None) each entry point runs its
  Python counterpart and gives the same results.
"""

import io

import numpy as np
import pytest
import torch

from thingino_accel_tpu import native as JN
from thingino_accel_tpu_torch import native as N
from thingino_accel_tpu_torch.formats import packing
from thingino_accel_tpu_torch.models import yolo

SHAPES = [(16, 3, 6, 6), (33, 40, 3, 3), (64, 64, 1, 1)]


@pytest.fixture(scope="module")
def lib():
    if not N.available():
        pytest.skip("native library unavailable (no compiler or libjpeg)")
    if not JN.available():
        pytest.skip("the JAX package's native library is unavailable")
    assert N.BUILD_DIR in N._lib_path().parents
    assert "csrc" not in N._lib_path().parts[-3:]
    return N.load()


@pytest.fixture
def no_lib(monkeypatch):
    monkeypatch.setattr(N, "load", lambda: None)


def _jpeg():
    from PIL import Image
    y = np.linspace(0, 255, 48, dtype=np.uint8)[:, None, None]
    x = np.linspace(0, 255, 64, dtype=np.uint8)[None, :, None]
    img = np.broadcast_to((y // 2 + x // 2), (48, 64, 3)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=95)
    return img, buf.getvalue()


def _dets(rng, n=150):
    boxes = np.stack([rng.uniform(50, 590, n), rng.uniform(50, 590, n),
                      rng.uniform(10, 120, n), rng.uniform(10, 120, n)],
                     1).astype(np.float32)
    return (boxes, rng.uniform(0, 1, n).astype(np.float32),
            rng.integers(0, 5, n).astype(np.int32))


@pytest.mark.parametrize("shape", SHAPES)
def test_nmhwsoib2_equals_jax_and_python(lib, shape):
    w = np.random.default_rng(0).integers(-128, 128, shape, dtype=np.int8)
    packed = N.pack_nmhwsoib2(w)
    np.testing.assert_array_equal(packed, JN.pack_nmhwsoib2(w))
    np.testing.assert_array_equal(packed, packing.pack_nmhwsoib2(w))
    back = N.unpack_nmhwsoib2(packed, *shape)
    np.testing.assert_array_equal(back, JN.unpack_nmhwsoib2(packed, *shape))
    np.testing.assert_array_equal(back, w)
    with pytest.raises(ValueError, match="too small"):
        N.unpack_nmhwsoib2(packed[:-1], *shape)


def test_quantize_equals_jax(lib):
    u8 = np.random.default_rng(1).integers(0, 256, (64, 64, 3),
                                           dtype=np.uint8)
    got = N.quantize_i8(u8)
    np.testing.assert_array_equal(got, JN.quantize_i8(u8))
    np.testing.assert_array_equal(
        got, (u8.astype(np.int32) - 128).astype(np.int8))


def test_jpeg_equals_jax_and_pil(lib):
    from PIL import Image
    img, data = _jpeg()
    got = N.decode_jpeg(data)
    assert got.shape == (48, 64, 3)
    np.testing.assert_array_equal(got, JN.decode_jpeg(data))
    np.testing.assert_array_equal(
        got, np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))
    assert np.abs(got.astype(int) - img.astype(int)).mean() < 3
    with pytest.raises(ValueError, match="JPEG"):
        N.decode_jpeg(b"not a jpeg")


@pytest.mark.parametrize("hw", [(480, 640), (720, 1280), (37, 53)])
def test_letterbox_equals_jax(lib, hw):
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, hw + (3,), dtype=np.uint8)
    np.testing.assert_array_equal(N.letterbox(img, (640, 640)),
                                  JN.letterbox(img, (640, 640)))
    flat = np.full((480, 640, 3), 200, np.uint8)
    out = N.letterbox(flat, (640, 640))
    assert (out[:80] == 114).all() and (out[-80:] == 114).all()
    assert (np.abs(out[80:560].astype(int) - 200) <= 1).all()


def test_space_to_depth_equals_jax_and_python(lib):
    img = np.random.default_rng(3).integers(0, 256, (64, 96, 3),
                                            dtype=np.uint8)
    got = N.space_to_depth_u8(img)
    np.testing.assert_array_equal(got, JN.space_to_depth_u8(img))
    np.testing.assert_array_equal(
        got, yolo.space_to_depth_frames(img[None])[0])
    with pytest.raises(ValueError, match="even"):
        N.space_to_depth_u8(img[:63])


def test_nms_equals_jax_and_the_device_path(lib):
    boxes, scores, classes = _dets(np.random.default_rng(4))
    keep = N.nms(boxes, scores, classes, 0.25, 0.45, max_out=200)
    np.testing.assert_array_equal(
        keep, JN.nms(boxes, scores, classes, 0.25, 0.45, max_out=200))
    np.testing.assert_array_equal(
        keep, N._nms_py(boxes, scores, classes, 0.25, 0.45, 200))
    d = yolo.nms_fixed(torch.from_numpy(boxes), torch.from_numpy(scores),
                       torch.from_numpy(classes), conf_thresh=0.25,
                       iou_thresh=0.45, max_dets=200)
    dev = sorted(round(float(s), 5) for s, v in zip(d.scores, d.valid) if v)
    assert sorted(round(float(scores[i]), 5) for i in keep) == dev


def test_python_fallbacks_without_the_library(no_lib):
    """``load`` gives None: each entry point's Python path, the results of
    the library's (the letterbox: the device path's ``letterbox_uint8``,
    within 1 on a flat image)."""
    assert not N.available()
    rng = np.random.default_rng(5)
    w = rng.integers(-128, 128, SHAPES[1], dtype=np.int8)
    packed = N.pack_nmhwsoib2(w)
    np.testing.assert_array_equal(packed, packing.pack_nmhwsoib2(w))
    np.testing.assert_array_equal(N.unpack_nmhwsoib2(packed, *SHAPES[1]), w)
    u8 = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        N.quantize_i8(u8), (u8.astype(np.int32) - 128).astype(np.int8))
    np.testing.assert_array_equal(N.space_to_depth_u8(u8),
                                  yolo.space_to_depth_frames(u8[None])[0])
    boxes, scores, classes = _dets(rng)
    np.testing.assert_array_equal(
        N.nms(boxes, scores, classes),
        N._nms_py(boxes, scores, classes, 0.25, 0.45, 300))
    img, data = _jpeg()
    from PIL import Image
    np.testing.assert_array_equal(
        N.decode_jpeg(data),
        np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))
    out = N.letterbox(np.full((480, 640, 3), 200, np.uint8), (640, 640))
    assert out.shape == (640, 640, 3)
    assert (out[:80] == 114).all() and (out[-80:] == 114).all()
    assert (np.abs(out[80:560].astype(int) - 200) <= 1).all()
