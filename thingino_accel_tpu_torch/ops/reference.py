"""Layer semantics in plain torch, NHWC (port of the parts of
``thingino_accel_tpu.ops.reference`` that the serving slice lowers).

Each function keeps the JAX function's name and arithmetic order, and
cites the reference runtime behaviour it replicates through it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from thingino_accel_tpu_torch.ops.quant import (
    RoundMode, clamp_i8, round_to_int,
)


def _conv_pads(
    in_hw: Tuple[int, int],
    out_hw: Tuple[int, int],
    kernel: Tuple[int, int],
    stride: Tuple[int, int],
    dilation: Tuple[int, int],
    padding: str,
    explicit_pad: Tuple[int, int, int, int],
) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Resolve ((pt, pb), (pl, pr)) the way the reference does: SAME
    derives pads from the declared output shape, EXPLICIT takes
    pad_top/pad_left and implies bottom/right from the output shape,
    VALID is zero."""
    kh = (kernel[0] - 1) * dilation[0] + 1
    kw = (kernel[1] - 1) * dilation[1] + 1
    if padding == "VALID":
        pt, pl = 0, 0
    elif padding == "SAME":
        pad_h = (out_hw[0] - 1) * stride[0] + kh - in_hw[0]
        pad_w = (out_hw[1] - 1) * stride[1] + kw - in_hw[1]
        pt = max(0, pad_h // 2)
        pl = max(0, pad_w // 2)
    else:  # EXPLICIT
        pt, pl = explicit_pad[0], explicit_pad[2]
    pb = max(0, (out_hw[0] - 1) * stride[0] + kh - in_hw[0] - pt)
    pr = max(0, (out_hw[1] - 1) * stride[1] + kw - in_hw[1] - pl)
    return (pt, pb), (pl, pr)


def maxpool(
    x: torch.Tensor,
    kernel: Tuple[int, int],
    stride: Tuple[int, int],
    out_hw: Tuple[int, int],
    pads: Tuple[Tuple[int, int], Tuple[int, int]] = ((0, 0), (0, 0)),
) -> torch.Tensor:
    """MaxPool with edge-clipped windows: padding with the dtype's
    minimum (-128 for int8) is the same as clipping the window. A max
    over the KH*KW strided views keeps the dtype (exact for int8)."""
    neg = (torch.iinfo(x.dtype).min if not x.dtype.is_floating_point
           else float("-inf"))
    kh, kw = kernel
    sh, sw = stride
    oh, ow = out_hw
    (pt, _), (pl, _) = pads
    _, h, w, _ = x.shape
    pb = max(0, (oh - 1) * sh + kh - h - pt)
    pr = max(0, (ow - 1) * sw + kw - w - pl)
    xp = torch.nn.functional.pad(x, (0, 0, pl, pr, pt, pb), value=neg)
    out = None
    for dy in range(kh):
        for dx in range(kw):
            v = xp[:, dy:dy + (oh - 1) * sh + 1:sh,
                   dx:dx + (ow - 1) * sw + 1:sw, :]
            out = v if out is None else torch.maximum(out, v)
    return out.contiguous()


def _requant_recip(y: torch.Tensor, out_scale: float) -> torch.Tensor:
    """``(int)(y * (1.0f/out_scale) + 0.5f)``: the reciprocal is taken in
    numpy f32 on the host, then multiplied (not divided)."""
    os_ = np.float32(out_scale) if out_scale > 0 else np.float32(1.0)
    inv = float(np.float32(1.0) / os_)
    return clamp_i8(round_to_int(y * inv, RoundMode.PLUS_HALF_TRUNC))


def _deq_operand(v: torch.Tensor, s: float) -> torch.Tensor:
    """Integer operands dequantize by their scale; float operands are
    already real values."""
    if not v.dtype.is_floating_point:
        return v.to(torch.float32) * float(np.float32(s))
    return v.to(torch.float32)


def add_q(
    a: torch.Tensor, b: torch.Tensor,
    a_scale: float = 1.0, b_scale: float = 1.0, out_scale: float = 1.0,
) -> torch.Tensor:
    """Quantized elementwise add: dequantize each side, add in f32,
    requantize with the PLUS_HALF_TRUNC rule."""
    if a.dtype.is_floating_point and b.dtype.is_floating_point:
        return a + b
    y = _deq_operand(a, a_scale) + _deq_operand(b, b_scale)
    return _requant_recip(y, out_scale)


def concat(xs: Sequence[torch.Tensor], axis: int) -> torch.Tensor:
    """A raw copy with no requantization, even where the inputs' scales
    differ: the reference copies int8 bytes."""
    return torch.cat(list(xs), dim=axis)


def upsample_nearest(
    x: torch.Tensor, scale: Tuple[int, int], out_hw: Tuple[int, int]
) -> torch.Tensor:
    """Nearest-neighbour upsample, ``src = dst // scale``: repeat, then
    crop to the declared output."""
    sh, sw = scale
    out = x.repeat_interleave(sh, dim=1).repeat_interleave(sw, dim=2)
    return out[:, :out_hw[0], :out_hw[1], :].contiguous()
