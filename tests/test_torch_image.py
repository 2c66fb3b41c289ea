"""The port's image pipes (``thingino_accel_tpu_torch.ops.image``) against
the JAX package's ``ops/image.py`` on the same seeded images:

- ``resize_bilinear`` up and down (both axes, one axis, non-integer and
  integer ratios, each axis order JAX's einsum picks), uint8, int8 and
  float32: integer outputs bit for bit, float32 within ``FLOAT_TOL``
  (2e-7 of the range 255: the f32 sums of the same taps, a few ulps
  apart);
- ``warp_perspective`` (one matrix, a matrix a batch element, fill),
  ``warp_affine`` (translation, general affine) and ``perspective_matrix``:
  integer outputs bit for bit, float32 within ``WARP_TOL`` (a source
  coordinate an ulp apart moves a bilinear sample by up to its gradient
  times the ulp); the matrix bit for bit;
- JAX's own checks of ``tests/test_image.py`` on the port: the identity
  warp, the numpy bilinear oracle, the affine shift, the uint8 round trip,
  the resize's dtype and range, the matrix's corners.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thingino_accel_tpu.ops import image as J
from thingino_accel_tpu_torch.ops import image as I

FLOAT_TOL = 255 * 2e-7
WARP_TOL = 5e-3

RESIZES = [((2, 10, 10, 3), (7, 7)), ((2, 8, 8, 3), (16, 16)),
           ((1, 10, 14, 3), (7, 9)), ((1, 14, 10, 3), (9, 7)),
           ((2, 12, 10, 3), (20, 6)), ((1, 37, 53, 3), (19, 80)),
           ((2, 9, 9, 1), (9, 5)), ((1, 20, 12, 2), (10, 12))]
DTYPES = [np.uint8, np.int8, np.float32]


def _image(shape, dtype, rng):
    if dtype == np.float32:
        return rng.uniform(0, 255, shape).astype(np.float32)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max + 1, shape, dtype=dtype)


def _check(got: torch.Tensor, want, tol):
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("shape,out", RESIZES,
                         ids=[f"{s[1]}x{s[2]}-{o[0]}x{o[1]}"
                              for s, o in RESIZES])
def test_resize_bilinear_equals_jax(shape, out, dtype):
    img = _image(shape, dtype, np.random.default_rng(sum(shape) + out[0]))
    _check(I.resize_bilinear(torch.from_numpy(img), out),
           J.resize_bilinear(jnp.asarray(img), out), FLOAT_TOL)


def test_axis_order_is_the_einsum_path():
    """The cheaper contraction first, H on a tie; an unchanged axis is
    not contracted."""
    assert I._axis_order(14, 10, 9, 7) == (2, 1)
    assert I._axis_order(10, 14, 7, 9) == (1, 2)
    assert I._axis_order(8, 8, 16, 16) == (1, 2)
    assert I._axis_order(9, 9, 9, 5) == (2,)
    assert I._axis_order(4, 4, 4, 4) == ()


QUAD_SRC = [[1, 2], [12, 1], [13, 14], [0, 13]]
QUAD_DST = [[0, 0], [13, 0], [13, 15], [0, 15]]


@pytest.mark.parametrize("batched", [False, True], ids=["one", "per-image"])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
def test_warp_perspective_equals_jax(dtype, batched):
    rng = np.random.default_rng(3)
    img = _image((2, 16, 14, 3), dtype, rng)
    m = J.perspective_matrix(QUAD_SRC, QUAD_DST)
    assert np.array_equal(I.perspective_matrix(QUAD_SRC, QUAD_DST), m)
    if batched:
        m = np.stack([m, np.linalg.inv(m).astype(np.float32)])
    for out_hw, fill in (((16, 14), 114.0), ((9, 20), 0.0)):
        _check(I.warp_perspective(torch.from_numpy(img), m, out_hw, fill),
               J.warp_perspective(jnp.asarray(img), m, out_hw, fill),
               WARP_TOL)


@pytest.mark.parametrize("matrix", [
    [[1, 0, 2], [0, 1, 0]], [[0.9, 0.1, 1.3], [-0.2, 1.1, 0.7]]],
    ids=["shift", "general"])
def test_warp_affine_equals_jax(matrix):
    rng = np.random.default_rng(4)
    m = np.asarray(matrix, np.float32)
    for dtype in DTYPES:
        img = _image((2, 8, 8, 3), dtype, rng)
        _check(I.warp_affine(torch.from_numpy(img), m),
               J.warp_affine(jnp.asarray(img), m), WARP_TOL)
        mb = np.stack([m, m * np.float32(0.5)])
        _check(I.warp_affine(torch.from_numpy(img), mb, (6, 10), 9.0),
               J.warp_affine(jnp.asarray(img), mb, (6, 10), 9.0), WARP_TOL)


# -- JAX's tests/test_image.py checks, on the port ---------------------------


def np_warp(img, m, out_hw, fill):
    h, w, c = img.shape
    oh, ow = out_hw
    out = np.full((oh, ow, c), fill, np.float64)
    for y in range(oh):
        for x in range(ow):
            v = m @ np.array([x, y, 1.0])
            sx, sy = v[0] / v[2], v[1] / v[2]
            x0, y0 = int(np.floor(sx)), int(np.floor(sy))
            fx, fy = sx - x0, sy - y0
            acc = np.zeros(c)
            any_in = False
            for dy, wy in ((0, 1 - fy), (1, fy)):
                for dx, wx in ((0, 1 - fx), (1, fx)):
                    yy, xx = y0 + dy, x0 + dx
                    if 0 <= yy < h and 0 <= xx < w:
                        acc += wy * wx * img[yy, xx]
                        any_in = True
                    else:
                        acc += wy * wx * fill
            out[y, x] = acc if any_in else fill
    return out


def test_identity_warp_and_uint8_roundtrip():
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (1, 12, 10, 3)).astype(np.float32)
    out = I.warp_perspective(torch.from_numpy(img), np.eye(3)).numpy()
    np.testing.assert_allclose(out, img, atol=1e-3)
    img = rng.integers(0, 256, (1, 9, 9, 3), dtype=np.uint8)
    out = I.warp_perspective(torch.from_numpy(img), np.eye(3)).numpy()
    assert out.dtype == np.uint8
    np.testing.assert_array_equal(out, img)


def test_warp_matches_numpy_oracle():
    img = np.random.default_rng(0).uniform(
        0, 255, (2, 16, 14, 3)).astype(np.float32)
    m = I.perspective_matrix(QUAD_SRC, QUAD_DST)
    got = I.warp_perspective(torch.from_numpy(img), m, (16, 14),
                             fill=114.0).numpy()
    for b in range(2):
        ref = np_warp(img[b], m.astype(np.float64), (16, 14), 114.0)
        np.testing.assert_allclose(got[b], ref, atol=0.05)


def test_warp_affine_translation():
    img = np.random.default_rng(0).uniform(
        0, 255, (1, 8, 8, 1)).astype(np.float32)
    m = np.array([[1, 0, 2], [0, 1, 0]], np.float32)
    out = I.warp_affine(torch.from_numpy(img), m, fill=0.0).numpy()
    np.testing.assert_allclose(out[0, :, :6], img[0, :, 2:], atol=1e-3)
    np.testing.assert_allclose(out[0, :, 6:], 0.0, atol=1e-3)


def test_resize_bilinear_dtype_and_range():
    img = np.random.default_rng(0).integers(0, 256, (2, 10, 10, 3),
                                            dtype=np.uint8)
    out = I.resize_bilinear(torch.from_numpy(img), (20, 20)).numpy()
    assert out.shape == (2, 20, 20, 3) and out.dtype == np.uint8
    assert int(out.min()) >= int(img.min()) - 1
    assert int(out.max()) <= int(img.max()) + 1


def test_perspective_matrix_maps_corners():
    src = [[3, 4], [20, 2], [22, 18], [1, 17]]
    dst = [[0, 0], [31, 0], [31, 31], [0, 31]]
    m = I.perspective_matrix(src, dst)
    assert m.dtype == np.float32
    np.testing.assert_array_equal(m, J.perspective_matrix(src, dst))
    for (xs, ys), (xd, yd) in zip(src, dst):
        v = m @ np.array([xd, yd, 1.0])
        np.testing.assert_allclose([v[0] / v[2], v[1] / v[2]], [xs, ys],
                                   atol=1e-4)
