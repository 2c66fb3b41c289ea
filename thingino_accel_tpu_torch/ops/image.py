"""Device-side image pipes: the analogs of the T41's AIP unit.

Port of ``thingino_accel_tpu.ops.image``. The reference drives three
fixed-function image pipes at 0x12b00000
(the reference's ``include/aip.h:1-75``): AIP-T (resize), AIP-F
(single-node conv, ``src/aip.c:aip_conv2d``), AIP-P (perspective
transform, registers 0x300-0x398). Here they are ordinary torch ops on
the image's device — no descriptor chains, no IRQ waits
(``include/aip.h:78-105`` node structs have no analog).

- :func:`resize_bilinear`  — AIP-T analog: ``jax.image.resize(...,
  "bilinear")`` as JAX computes it on the CPU: the triangle-kernel
  weights of each axis (widened by 1 / scale when shrinking: the
  antialias), built here (``ops.reference.resize_taps``; ``F.interpolate``
  computes another function), one axis contracted after the other in the
  order JAX's einsum picks (:func:`_axis_order`);
- :func:`warp_perspective` — AIP-P analog: batched 3x3 homography with
  bilinear sampling and border fill (inverse mapping, the standard
  dewarp formulation camera ISPs use);
- :func:`warp_affine`      — 2x3 affine special case of the same;
- AIP-F's conv is ``ops.reference.conv2d_f32`` (``api.aip_conv2d``).

Integer images round half to even and clamp to their type, as JAX's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from thingino_accel_tpu_torch.ops.reference import resize_axis


def _axis_order(h: int, w: int, oh: int, ow: int) -> Tuple[int, ...]:
    """The axes (1 = H, 2 = W) in the order JAX's ``einsum`` contracts the
    weight matrices of a resize: only the axes whose size changes; of two,
    the order with fewer multiplies (H first on a tie), as the einsum's
    path optimizer chooses."""
    axes = [a for a, (n, m) in ((1, (h, oh)), (2, (w, ow))) if n != m]
    if len(axes) == 2 and h * w * ow + h * ow * oh < h * w * oh + oh * w * ow:
        axes.reverse()
    return tuple(axes)


def resize_bilinear(img: torch.Tensor, out_hw: Tuple[int, int]
                    ) -> torch.Tensor:
    """AIP-T analog: batched bilinear resize, dtype-preserving
    (uint8/int8 inputs round like the reference's fixed-point pipe).

    img: [B, H, W, C]; returns [B, out_h, out_w, C] on its device.
    """
    _, h, w, _ = img.shape
    oh, ow = out_hw
    out = img.to(torch.float32)
    for axis in _axis_order(h, w, oh, ow):
        out = resize_axis(out, axis, oh if axis == 1 else ow)
    return _cast_like(out, img.dtype)


def _cast_like(out: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A float32 result in ``dtype``: integers rounded half to even and
    clamped to the type's range."""
    if not dtype.is_floating_point:
        info = torch.iinfo(dtype)
        out = torch.clamp(torch.round(out), info.min, info.max)
    return out.to(dtype)


def _bilinear_sample(img: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor,
                     fill: float) -> torch.Tensor:
    """Sample [H, W, C] at float coords (sx, sy) [OH, OW] with bilinear
    interpolation; out-of-bounds reads return ``fill``."""
    h, w, c = img.shape
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = sx - x0
    fy = sy - y0
    x0i = x0.to(torch.int32)
    y0i = y0.to(torch.int32)
    flat = img.reshape(h * w, c)

    def tap(yi, xi):
        # clamp for the gather; validity handled by the weight mask
        yc = torch.clamp(yi, 0, h - 1)
        xc = torch.clamp(xi, 0, w - 1)
        v = flat[(yc * w + xc).long()]                # [OH, OW, C]
        ok = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        return v, ok[..., None]

    v00, m00 = tap(y0i, x0i)
    v01, m01 = tap(y0i, x0i + 1)
    v10, m10 = tap(y0i + 1, x0i)
    v11, m11 = tap(y0i + 1, x0i + 1)
    w00 = ((1 - fy) * (1 - fx))[..., None]
    w01 = ((1 - fy) * fx)[..., None]
    w10 = (fy * (1 - fx))[..., None]
    w11 = (fy * fx)[..., None]
    fillv = torch.tensor(fill, dtype=torch.float32, device=img.device)
    acc = (torch.where(m00, v00, fillv) * w00
           + torch.where(m01, v01, fillv) * w01
           + torch.where(m10, v10, fillv) * w10
           + torch.where(m11, v11, fillv) * w11)
    # fully outside -> pure fill
    inside = m00 | m01 | m10 | m11
    return torch.where(inside, acc, fillv)


def _as_matrix(matrix, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(matrix, np.float32) if not isinstance(
        matrix, torch.Tensor) else matrix, dtype=torch.float32).to(device)


def warp_perspective(
    img: torch.Tensor,            # [B, H, W, C] any real dtype
    matrix,                       # [3, 3] or [B, 3, 3] dst->src homography
    out_hw: Optional[Tuple[int, int]] = None,
    fill: float = 0.0,
) -> torch.Tensor:
    """AIP-P analog: perspective (homography) warp with bilinear
    sampling, batched, on the image's device.

    ``matrix`` maps OUTPUT pixel coordinates to SOURCE coordinates
    (inverse mapping — the numerically sane direction; pass
    ``np.linalg.inv(H)`` for a forward homography H). Output pixels
    whose source falls outside the image read ``fill``, matching the
    fixed-function pipe's border behavior.

    The source coordinates are JAX's dot of each matrix row with (x, y,
    1) on the CPU: ``(m0 x + m1 y) + m2`` in float32, each product and sum
    rounded on its own (torch ops, one a pass: nothing contracts them).
    """
    b, h, w, c = img.shape
    oh, ow = out_hw if out_hw is not None else (h, w)
    dev = img.device
    m = _as_matrix(matrix, dev)
    if m.dim() == 2:
        m = m.expand(b, 3, 3)
    gy, gx = torch.meshgrid(torch.arange(oh, dtype=torch.float32, device=dev),
                            torch.arange(ow, dtype=torch.float32, device=dev),
                            indexing="ij")
    mm = m[:, :, :, None, None]                     # [B, 3, 3, 1, 1]
    src = (mm[:, :, 0] * gx + mm[:, :, 1] * gy) + mm[:, :, 2]
    z = src[:, 2]
    z = torch.where(torch.abs(z) < 1e-8,
                    torch.tensor(1e-8, dtype=torch.float32, device=dev), z)
    sx, sy = src[:, 0] / z, src[:, 1] / z
    out = [_bilinear_sample(img[i].to(torch.float32), sx[i], sy[i], fill)
           for i in range(b)]
    return _cast_like(torch.stack(out), img.dtype)


def warp_affine(
    img: torch.Tensor,
    matrix,                       # [2, 3] or [B, 2, 3] dst->src affine
    out_hw: Optional[Tuple[int, int]] = None,
    fill: float = 0.0,
) -> torch.Tensor:
    """Affine special case of :func:`warp_perspective`."""
    m = _as_matrix(matrix, img.device)
    bottom = torch.tensor([[0.0, 0.0, 1.0]], dtype=torch.float32,
                          device=img.device)
    if m.dim() == 2:
        m3 = torch.cat([m, bottom], dim=0)
    else:
        m3 = torch.cat([m, bottom.expand(m.shape[0], 1, 3)], dim=1)
    return warp_perspective(img, m3, out_hw, fill)


def perspective_matrix(src_quad, dst_quad) -> np.ndarray:
    """Solve the 3x3 homography mapping ``dst_quad`` -> ``src_quad``
    (4 point pairs each, [[x, y] x4]) — i.e. directly usable as
    :func:`warp_perspective`'s inverse-mapping ``matrix``. Host-side
    (numpy) setup, like the reference's register programming."""
    src = np.asarray(src_quad, np.float64)
    dst = np.asarray(dst_quad, np.float64)
    a = []
    rhs = []
    for (xs, ys), (xd, yd) in zip(src, dst):
        a.append([xd, yd, 1, 0, 0, 0, -xs * xd, -xs * yd])
        a.append([0, 0, 0, xd, yd, 1, -ys * xd, -ys * yd])
        rhs.extend([xs, ys])
    coef = np.linalg.solve(np.asarray(a), np.asarray(rhs))
    return np.append(coef, 1.0).reshape(3, 3).astype(np.float32)
