"""Layer semantics in plain torch, NHWC (port of the parts of
``thingino_accel_tpu.ops.reference`` that the serving, exact and fast
tiers lower). Conv weights are OHWI, the kernels' layout (the JAX
functions take HWIO).

Each function keeps the JAX function's name and arithmetic order, and
cites the reference runtime behaviour it replicates through it.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from thingino_accel_tpu_torch.ops.quant import (
    RoundMode, clamp_i8, requantize, round_to_int,
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


def _combined_scale(in_scale, w_scale, out_scale, device=None):
    """``in_scale * w_scale / out_scale`` in numpy f32, a float or, for a
    per-channel ``w_scale``, an f32 tensor on ``device``."""
    ws = np.asarray(w_scale, np.float32)
    cs = (np.float32(in_scale) * ws) / np.float32(out_scale)
    if cs.ndim == 0:
        return float(cs)
    return torch.from_numpy(np.array(cs, np.float32)).to(device)


def _fdiv(y: torch.Tensor, s) -> torch.Tensor:
    """``y / float32(s)`` as a true f32 division. The divisor is a 0-dim
    tensor on ``y``'s device: a Python scalar would let CUDA multiply by
    its reciprocal, which differs from the division on rounding ties."""
    return y / torch.tensor(np.float32(s), device=y.device)


def conv2d_acc_i32(
    x: torch.Tensor, w: torch.Tensor, out_hw: Tuple[int, int],
    stride: Tuple[int, int] = (1, 1), dilation: Tuple[int, int] = (1, 1),
    pads: Tuple[Tuple[int, int], Tuple[int, int]] = ((0, 0), (0, 0)),
) -> torch.Tensor:
    """Zero-padded conv of NHWC int8 ``x`` with OHWI int8 ``w`` -> int32
    [N, OH, OW, O], exact: the products and sums run in float64, exact
    for int8 operands (|acc| <= KH*KW*C*128^2 << 2^53), since torch has no
    int32 conv. Any stride and dilation, asymmetric pads; rows and
    columns past the padded input read zero."""
    _, h, wd, _ = x.shape
    _, kh, kw, _ = w.shape
    oh, ow = out_hw
    (pt, pb), (pl, pr) = pads
    pb = max(pb, (oh - 1) * stride[0] + (kh - 1) * dilation[0] + 1 - h - pt)
    pr = max(pr, (ow - 1) * stride[1] + (kw - 1) * dilation[1] + 1 - wd - pl)
    xd = torch.nn.functional.pad(x.permute(0, 3, 1, 2).to(torch.float64),
                                 (pl, pr, pt, pb))
    acc = torch.nn.functional.conv2d(
        xd, w.permute(0, 3, 1, 2).to(torch.float64), stride=tuple(stride),
        dilation=tuple(dilation))[:, :, :oh, :ow]
    return acc.permute(0, 2, 3, 1).to(torch.int32)


def conv2d_int8(
    x: torch.Tensor, w: torch.Tensor, bias_i32: Optional[torch.Tensor],
    out_hw: Tuple[int, int], stride: Tuple[int, int],
    dilation: Tuple[int, int],
    pads: Tuple[Tuple[int, int], Tuple[int, int]],
    in_scale: float, w_scale, out_scale: float,
    round_mode: RoundMode = RoundMode.HALF_AWAY, relu: bool = False,
) -> torch.Tensor:
    """int8 conv (``w`` OHWI) with the reference requantization epilogue:
    bias added to the int32 accumulator, x the combined scale (a float, or
    per output channel for a per-channel ``w_scale``), rounded by
    ``round_mode``, clamped; ``relu`` clamps the *quantized* value at 0."""
    acc = conv2d_acc_i32(x, w, out_hw, stride, dilation, pads)
    if bias_i32 is not None:
        acc = acc + bias_i32.to(torch.int32)
    out = requantize(acc, _combined_scale(in_scale, w_scale, out_scale,
                                          x.device), round_mode)
    if relu:
        out = torch.clamp_min(out, 0)
    return out


def _conv_nchw(x: torch.Tensor, w: torch.Tensor, out_hw: Tuple[int, int],
               stride: Tuple[int, int], dilation: Tuple[int, int],
               pads: Tuple[Tuple[int, int], Tuple[int, int]],
               groups: int = 1) -> torch.Tensor:
    """``F.conv2d`` of NCHW ``x`` (channels_last) and OIHW ``w`` with the
    reference's pads, cropped to ``out_hw``: a symmetric pad of the top
    and left sides where it covers the bottom and right ones (rows past
    the declared pads are read by no kept output), else an explicit
    pad."""
    (pt, pb), (pl, pr) = pads
    if pb > pt or pr > pl:
        x = torch.nn.functional.pad(x, (pl, pr, pt, pb))
        pt = pl = 0
    out = torch.nn.functional.conv2d(x, w, None, tuple(stride), (pt, pl),
                                     tuple(dilation), groups)
    return out[:, :, :out_hw[0], :out_hw[1]]


def conv2d_f32(
    x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
    out_hw: Tuple[int, int], stride: Tuple[int, int],
    dilation: Tuple[int, int],
    pads: Tuple[Tuple[int, int], Tuple[int, int]],
    relu: bool = False, compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Float conv of NHWC ``x`` with OHWI ``w`` (the fast tier's): the
    conv in ``compute_dtype`` (float32 or bfloat16, sums in float32) and
    channels_last, cropped to ``out_hw``, the bias added in float32, then
    RELU, the result cast to ``compute_dtype``. A bf16 conv's output is
    rounded to bf16 before the bias (``F.conv2d`` returns its input's
    type), where JAX adds the bias to the f32 sums: one rounding more
    (ROADMAP C.9).
    On the card a float32 conv follows ``torch.backends.cudnn.allow_tf32``
    (the caller sets it)."""
    cl = torch.channels_last
    xc = x.to(compute_dtype).permute(0, 3, 1, 2).contiguous(memory_format=cl)
    wc = w.to(compute_dtype).permute(0, 3, 1, 2).contiguous(memory_format=cl)
    out = _conv_nchw(xc, wc, out_hw, stride, dilation, pads)
    out = out.permute(0, 2, 3, 1)
    # the add reads the conv's output and writes float32 in one pass
    out = (out + bias.to(torch.float32) if bias is not None
           else out.to(torch.float32))
    if relu:
        out = torch.clamp_min(out, 0.0)
    return out.to(compute_dtype).contiguous()


def depthwise_conv2d_f32(
    x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
    out_hw: Tuple[int, int], stride: Tuple[int, int],
    dilation: Tuple[int, int],
    pads: Tuple[Tuple[int, int], Tuple[int, int]],
    relu: bool = False,
) -> torch.Tensor:
    """Float depthwise conv of NHWC ``x`` with ``w`` [KH, KW, C], in
    float32 whatever the input's type (as JAX's), cropped to ``out_hw``,
    + bias, RELU; returns float32."""
    cl = torch.channels_last
    xc = x.to(torch.float32).permute(0, 3, 1, 2).contiguous(memory_format=cl)
    wc = w.to(torch.float32).permute(2, 0, 1).unsqueeze(1)   # [C, 1, KH, KW]
    out = _conv_nchw(xc, wc, out_hw, stride, dilation, pads,
                     groups=x.shape[3]).permute(0, 2, 3, 1)
    if bias is not None:
        out = out + bias.to(torch.float32)
    if relu:
        out = torch.clamp_min(out, 0.0)
    return out.contiguous()


def depthwise_acc_i32(
    x: torch.Tensor, w: torch.Tensor, out_hw: Tuple[int, int],
    stride: Tuple[int, int], dilation: Tuple[int, int],
    pads: Tuple[Tuple[int, int], Tuple[int, int]],
) -> torch.Tensor:
    """Zero-padded depthwise conv of NHWC int8 ``x`` with ``w`` [KH, KW, C]
    -> int32 [N, OH, OW, C]: one elementwise int32 multiply-add per tap."""
    _, h, wd, _ = x.shape
    kh, kw, _ = w.shape
    oh, ow = out_hw
    (pt, pb), (pl, pr) = pads
    # rows/columns past the input read zero, however short pb/pr are
    pb = max(pb, (oh - 1) * stride[0] + (kh - 1) * dilation[0] + 1 - h - pt)
    pr = max(pr, (ow - 1) * stride[1] + (kw - 1) * dilation[1] + 1 - wd - pl)
    xp = torch.nn.functional.pad(x, (0, 0, pl, pr, pt, pb)).to(torch.int32)
    wi = w.to(torch.int32)
    acc = None
    for dy in range(kh):
        for dx in range(kw):
            ys, xs = dy * dilation[0], dx * dilation[1]
            sl = xp[:, ys:ys + (oh - 1) * stride[0] + 1:stride[0],
                    xs:xs + (ow - 1) * stride[1] + 1:stride[1], :]
            p = sl * wi[dy, dx]
            acc = p if acc is None else acc + p
    return acc


def depthwise_conv2d_int8(
    x: torch.Tensor, w: torch.Tensor, bias_i32: Optional[torch.Tensor],
    out_hw: Tuple[int, int], stride: Tuple[int, int],
    dilation: Tuple[int, int],
    pads: Tuple[Tuple[int, int], Tuple[int, int]],
    in_scale: float, w_scale, out_scale: float,
    round_mode: RoundMode = RoundMode.HALF_AWAY, relu: bool = False,
) -> torch.Tensor:
    """Depthwise int8 conv (``w`` [KH, KW, C], any stride and dilation):
    exact int32 accumulation, + bias, x the combined scale, rounded by
    ``round_mode``, clamped; ``relu`` after the clamp."""
    acc = depthwise_acc_i32(x, w, out_hw, stride, dilation, pads)
    if bias_i32 is not None:
        acc = acc + bias_i32.to(torch.int32)
    out = requantize(acc, _combined_scale(in_scale, w_scale, out_scale,
                                          x.device), round_mode)
    if relu:
        out = torch.clamp_min(out, 0)
    return out


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
    out = None
    for v in _pool_taps(x, kernel, stride, out_hw, pads, neg):
        out = v if out is None else torch.maximum(out, v)
    return out.contiguous()


def leaky_relu(x: torch.Tensor, alpha: float = 0.01) -> torch.Tensor:
    """LeakyReLU. int8: the negative branch is ``max(-128, trunc(x *
    alpha))`` on the quantized value, in f32 with C truncation. Float: in
    float32, whatever the float type of ``x``."""
    if not x.dtype.is_floating_point:
        neg = torch.trunc(x.to(torch.float32) * float(np.float32(alpha)))
        neg = torch.clamp_min(neg, -128.0).to(x.dtype)
        return torch.where(x > 0, x, neg)
    # a float32 alpha promotes a bf16 x to float32, as in JAX
    xf = x.to(torch.float32)
    return torch.where(x > 0, xf, xf * float(np.float32(alpha)))


def _pool_taps(x: torch.Tensor, kernel, stride, out_hw, pads, value):
    """The KH*KW strided views of ``x`` padded with ``value`` (the bottom
    and right pads implied by the output size), for a pool."""
    kh, kw = kernel
    sh, sw = stride
    oh, ow = out_hw
    (pt, _), (pl, _) = pads
    _, h, w, _ = x.shape
    pb = max(0, (oh - 1) * sh + kh - h - pt)
    pr = max(0, (ow - 1) * sw + kw - w - pl)
    xp = torch.nn.functional.pad(x, (0, 0, pl, pr, pt, pb), value=value)
    return [xp[:, dy:dy + (oh - 1) * sh + 1:sh, dx:dx + (ow - 1) * sw + 1:sw]
            for dy in range(kh) for dx in range(kw)]


def avgpool(
    x: torch.Tensor, kernel: Tuple[int, int], stride: Tuple[int, int],
    out_hw: Tuple[int, int],
    pads: Tuple[Tuple[int, int], Tuple[int, int]] = ((0, 0), (0, 0)),
    in_scale: float = 1.0, out_scale: float = 1.0,
) -> torch.Tensor:
    """AvgPool, count_include_pad=False: window sums over the taps inside
    the input, divided by their count. int8 sums are integers, exact in
    f32 in any order; then x in_scale, / out_scale, PLUS_HALF_TRUNC,
    clamp."""
    xf = x.to(torch.float32)
    summed = torch.stack(_pool_taps(xf, kernel, stride, out_hw, pads, 0.0)
                         ).sum(0)
    ones = torch.ones((1,) + tuple(x.shape[1:3]) + (1,), dtype=torch.float32,
                      device=x.device)
    counts = torch.stack(_pool_taps(ones, kernel, stride, out_hw, pads, 0.0)
                         ).sum(0)
    avg = summed / counts
    if not x.dtype.is_floating_point:
        avg = avg * float(np.float32(in_scale))
        return clamp_i8(round_to_int(_fdiv(avg, out_scale),
                                     RoundMode.PLUS_HALF_TRUNC))
    return avg


def global_avgpool(x: torch.Tensor, in_scale: float = 1.0,
                   out_scale: float = 1.0) -> torch.Tensor:
    """GlobalAvgPool -> [N, 1, 1, C]: the f32 sum over H, W divided by
    H*W (a division, as ``jnp.mean``; ``torch.mean`` multiplies by the
    reciprocal), then requantized as :func:`avgpool`."""
    xf = x.to(torch.float32)
    avg = _fdiv(xf.sum(dim=(1, 2), keepdim=True), x.shape[1] * x.shape[2])
    if not x.dtype.is_floating_point:
        avg = avg * float(np.float32(in_scale))
        return clamp_i8(round_to_int(_fdiv(avg, out_scale),
                                     RoundMode.PLUS_HALF_TRUNC))
    return avg


def relu(x: torch.Tensor) -> torch.Tensor:
    """ReLU, int8 and f32."""
    return torch.clamp_min(x, 0)


def relu6(x: torch.Tensor, scale: float = 1.0,
          compat: bool = False) -> torch.Tensor:
    """ReLU6. ``compat=True`` is the reference runtime's plain RELU;
    otherwise the int8 upper clamp is ``trunc(6/scale + 0.5)``."""
    out = torch.clamp_min(x, 0)
    if compat:
        return out
    if not x.dtype.is_floating_point:
        hi = int(np.clip(np.trunc(6.0 / np.float32(scale) + 0.5), -128, 127))
        return torch.clamp_max(out, hi)
    return torch.clamp_max(out, 6.0)


def sigmoid(x: torch.Tensor, in_scale: float = 1.0,
            out_scale: float = 1.0) -> torch.Tensor:
    """Sigmoid. int8: dequant -> 1/(1+exp(-x)) -> ``(int)(y/out_scale +
    0.5)`` -> clamp."""
    if x.dtype.is_floating_point:
        return torch.sigmoid(x)
    xf = x.to(torch.float32) * float(np.float32(in_scale))
    os_ = float(out_scale) if out_scale > 0 else 1.0
    return clamp_i8(round_to_int(_fdiv(torch.sigmoid(xf), os_),
                                 RoundMode.PLUS_HALF_TRUNC))


def silu(x: torch.Tensor, in_scale: float = 1.0, sig_scale: float = 1.0,
         out_scale: float = 1.0, fuse: bool = True) -> torch.Tensor:
    """SiLU = x * sigmoid(x). int8, ``fuse=True``: in f32, then x the f32
    reciprocal of ``out_scale``, PLUS_HALF_TRUNC, clamp. ``fuse=False``:
    the graphs' two-step dataflow, the sigmoid requantized to
    ``sig_scale`` first, then :func:`mul_q`."""
    if x.dtype.is_floating_point:
        return x * torch.sigmoid(x)
    if fuse:
        xf = x.to(torch.float32) * float(np.float32(in_scale))
        y = xf * torch.sigmoid(xf)
        os_ = float(out_scale) if out_scale > 0 else 1.0
        inv = float(np.float32(1.0 / np.float32(os_)))
        return clamp_i8(round_to_int(y * inv, RoundMode.PLUS_HALF_TRUNC))
    s = sigmoid(x, in_scale, sig_scale)
    return mul_q(x, s, in_scale, sig_scale, out_scale)


def softmax(x: torch.Tensor, axis: int = -1, in_scale: float = 1.0,
            out_scale: float = 1.0, compat: bool = False) -> torch.Tensor:
    """Softmax; ``compat=True`` is the reference runtime's pass-through.
    int8: dequant, softmax in f32, / out_scale, PLUS_HALF_TRUNC, clamp."""
    if compat:
        return x
    if x.dtype.is_floating_point:
        return torch.softmax(x.to(torch.float32), dim=axis)
    xf = x.to(torch.float32) * float(np.float32(in_scale))
    y = torch.softmax(xf, dim=axis)
    os_ = float(out_scale) if out_scale > 0 else 1.0
    return clamp_i8(round_to_int(_fdiv(y, os_), RoundMode.PLUS_HALF_TRUNC))


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


def mul_q(
    a: torch.Tensor, b: torch.Tensor,
    a_scale: float = 1.0, b_scale: float = 1.0, out_scale: float = 1.0,
) -> torch.Tensor:
    """Quantized elementwise mul: dequantize each side by its own dtype,
    multiply in f32, requantize with the PLUS_HALF_TRUNC rule."""
    if a.dtype.is_floating_point and b.dtype.is_floating_point:
        return a * b
    y = _deq_operand(a, a_scale) * _deq_operand(b, b_scale)
    return _requant_recip(y, out_scale)


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


def quantize_edge(x: torch.Tensor, scale: float) -> torch.Tensor:
    """QUANT, a float graph's int8 edge: ``x / scale`` in f32,
    PLUS_HALF_TRUNC, clamp. XLA's f32 -> int32 conversion saturates and
    takes NaN to 0 (torch's is undefined out of range), so the quotient is
    held in [-129, 128], NaN as 0, before the rounding: the same int8."""
    y = _fdiv(x.to(torch.float32), scale or 1.0)
    y = torch.clamp(torch.nan_to_num(y, nan=0.0), -129.0, 128.0)
    return clamp_i8(round_to_int(y, RoundMode.PLUS_HALF_TRUNC))


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
