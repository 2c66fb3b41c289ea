"""Layer semantics in plain torch, NHWC (port of the parts of
``thingino_accel_tpu.ops.reference`` that the serving, exact and fast
tiers lower). Conv weights are OHWI, the kernels' layout (the JAX
functions take HWIO).

Each function keeps the JAX function's name and arithmetic order, and
cites the reference runtime behaviour it replicates through it.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from thingino_accel_tpu_torch.ops.quant import (
    RoundMode, clamp_i8, device_constant, requantize, round_to_int,
)
from thingino_accel_tpu_torch.utils import config


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
    return device_constant(cs.astype(np.float32), device)


def _fdiv(y: torch.Tensor, s) -> torch.Tensor:
    """``y / float32(s)`` as a true f32 division. The divisor is a 0-dim
    tensor on ``y``'s device: a Python scalar would let CUDA multiply by
    its reciprocal, which differs from the division on rounding ties.
    It is made once per value and device (:func:`device_constant`)."""
    return y / device_constant(np.float32(s), y.device)


def relu_f(x: torch.Tensor) -> torch.Tensor:
    """ReLU of a float tensor as ``jnp.maximum(x, 0)``: the same values as
    a clamp, and under autograd a value exactly at 0 takes half the
    gradient, as JAX differentiates ``maximum`` (``clamp_min`` would pass
    all of it)."""
    return torch.maximum(x, x.new_zeros(()))


def conv2d_acc_i32(
    x: torch.Tensor, w: torch.Tensor, out_hw: Tuple[int, int],
    stride: Tuple[int, int] = (1, 1), dilation: Tuple[int, int] = (1, 1),
    pads: Tuple[Tuple[int, int], Tuple[int, int]] = ((0, 0), (0, 0)),
    groups: int = 1,
) -> torch.Tensor:
    """Zero-padded conv of NHWC int8 ``x`` with OHWI int8 ``w`` ([O, KH,
    KW, C / groups]) -> int32 [N, OH, OW, O], exact: the products and sums
    run in float64, exact for int8 operands (|acc| <= KH*KW*C*128^2 <<
    2^53), since torch has no int32 conv. Any stride and dilation,
    asymmetric pads; rows and columns past the padded input read zero."""
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
        dilation=tuple(dilation), groups=groups)[:, :, :oh, :ow]
    return acc.permute(0, 2, 3, 1).to(torch.int32)


def conv2d_int8(
    x: torch.Tensor, w: torch.Tensor, bias_i32: Optional[torch.Tensor],
    out_hw: Tuple[int, int], stride: Tuple[int, int],
    dilation: Tuple[int, int],
    pads: Tuple[Tuple[int, int], Tuple[int, int]],
    in_scale: float, w_scale, out_scale: float,
    round_mode: RoundMode = RoundMode.HALF_AWAY, relu: bool = False,
    groups: int = 1,
) -> torch.Tensor:
    """int8 conv (``w`` OHWI) with the reference requantization epilogue:
    bias added to the int32 accumulator, x the combined scale (a float, or
    per output channel for a per-channel ``w_scale``), rounded by
    ``round_mode``, clamped; ``relu`` clamps the *quantized* value at 0."""
    acc = conv2d_acc_i32(x, w, out_hw, stride, dilation, pads, groups)
    if bias_i32 is not None:
        acc = acc + bias_i32.to(torch.int32)
    out = requantize(acc, _combined_scale(in_scale, w_scale, out_scale,
                                          x.device), round_mode)
    if relu:
        out = torch.clamp_min(out, 0)
    return out


def grouped_conv2d_int8(
    x: torch.Tensor, w: torch.Tensor, bias_i32: Optional[torch.Tensor],
    groups: int, out_hw: Tuple[int, int], stride: Tuple[int, int],
    dilation: Tuple[int, int],
    pads: Tuple[Tuple[int, int], Tuple[int, int]],
    in_scale: float, w_scale, out_scale: float,
    round_mode: RoundMode = RoundMode.HALF_AWAY, relu: bool = False,
) -> torch.Tensor:
    """Grouped int8 conv (``w`` OHWI [O, KH, KW, C / groups]): each group's
    exact accumulator (JAX runs one conv a group and concatenates them;
    one grouped float64 conv gives the same integers), then the
    epilogue of :func:`conv2d_int8`."""
    return conv2d_int8(x, w, bias_i32, out_hw, stride, dilation, pads,
                       in_scale, w_scale, out_scale, round_mode, relu,
                       groups)


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


@contextlib.contextmanager
def no_tf32():
    """Float32 matmuls and cuDNN convs in full float32 inside the block (no
    TF32 on the card), as the CPU computes them; the settings as they were
    after. The float32 exact tier's scope: the AEC model and its STFT, the
    person detector's sums, the PTQ reference forward."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


@contextlib.contextmanager
def _cudnn_tf32():
    """cuDNN may take TF32 inside the block; the setting as it was after."""
    was = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = was


def conv2d_f32(
    x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
    out_hw: Tuple[int, int], stride: Tuple[int, int],
    dilation: Tuple[int, int],
    pads: Tuple[Tuple[int, int], Tuple[int, int]],
    relu: bool = False, compute_dtype: torch.dtype = torch.float32,
    accum_dtype: Optional[torch.dtype] = None, groups: int = 1,
) -> torch.Tensor:
    """Float conv of NHWC ``x`` with OHWI ``w`` ([O, KH, KW, C / groups];
    JAX's function takes no groups and XLA refuses a grouped weight, so
    ``groups`` > 1 is the port's own): the
    operands rounded to ``compute_dtype`` (float32 or bfloat16), the conv
    in channels_last, cropped to ``out_hw``, the bias added in float32,
    then RELU, the result cast to ``compute_dtype``.

    ``accum_dtype`` is the JAX option's. None (or float32): the sums are
    float32 and the bias is added to them, one rounding at the end, as
    JAX's ``preferred_element_type=float32``. A bf16 conv then runs as a
    float32 conv of the bf16 values: each product of two bf16 values is
    exact in float32, and in TF32 too (10 mantissa bits hold bf16's 7),
    so on the card such a conv allows TF32 for its own call.
    ``torch.bfloat16``: the conv in bf16, its sums rounded to bf16 before
    the bias (``F.conv2d`` returns its input's type), as JAX's
    ``preferred_element_type=bfloat16``: the mode the JAX bench runs.
    On the card a float32 conv of float32 values follows
    ``torch.backends.cudnn.allow_tf32`` (the caller sets it)."""
    if accum_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"accum_dtype must be None, torch.float32 or "
                         f"torch.bfloat16, got {accum_dtype}")
    cl = torch.channels_last
    widen = compute_dtype == torch.bfloat16 and accum_dtype != torch.bfloat16
    xc = x.to(compute_dtype)
    wc = w.to(compute_dtype)
    if widen:   # exact: bf16 values in float32
        xc, wc = xc.to(torch.float32), wc.to(torch.float32)
    xc = xc.permute(0, 3, 1, 2).contiguous(memory_format=cl)
    wc = wc.permute(0, 3, 1, 2).contiguous(memory_format=cl)
    if widen and xc.is_cuda:
        with _cudnn_tf32():
            out = _conv_nchw(xc, wc, out_hw, stride, dilation, pads, groups)
    else:
        out = _conv_nchw(xc, wc, out_hw, stride, dilation, pads, groups)
    if accum_dtype == torch.bfloat16:   # a no-op on a bf16 conv's output
        out = out.to(torch.bfloat16)
    out = out.permute(0, 2, 3, 1)
    # the add reads the conv's output and writes float32 in one pass
    out = (out + bias.to(torch.float32) if bias is not None
           else out.to(torch.float32))
    if relu:
        out = relu_f(out)
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
        out = relu_f(out)
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
    minimum (-128 for int8) is the same as clipping the window. int8: a
    max over the KH*KW strided views, in the dtype. Float: ``F.max_pool2d``
    over the input padded with -inf, the same values, and under autograd
    a window's gradient goes to its first maximum in row-major order, as
    JAX differentiates ``reduce_window`` max (a chain of maxima would
    split it over ties)."""
    if x.dtype.is_floating_point:
        kh, kw = kernel
        (pt, _), (pl, _) = pads
        pb = max(0, (out_hw[0] - 1) * stride[0] + kh - x.shape[1] - pt)
        pr = max(0, (out_hw[1] - 1) * stride[1] + kw - x.shape[2] - pl)
        xp = torch.nn.functional.pad(x, (0, 0, pl, pr, pt, pb),
                                     value=float("-inf"))
        out = torch.nn.functional.max_pool2d(
            xp.permute(0, 3, 1, 2), (kh, kw), tuple(stride))
        return out[:, :, :out_hw[0], :out_hw[1]].permute(0, 2, 3, 1) \
            .contiguous()
    neg = torch.iinfo(x.dtype).min
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
    """ReLU, int8 and f32 (:func:`relu_f`)."""
    return relu_f(x) if x.dtype.is_floating_point else torch.clamp_min(x, 0)


def relu6(x: torch.Tensor, scale: float = 1.0,
          compat: bool = False) -> torch.Tensor:
    """ReLU6. ``compat=True`` is the reference runtime's plain RELU;
    otherwise the int8 upper clamp is ``trunc(6/scale + 0.5)``."""
    out = relu(x)
    if compat:
        return out
    if not x.dtype.is_floating_point:
        hi = int(np.clip(np.trunc(6.0 / np.float32(scale) + 0.5), -128, 127))
        return torch.clamp_max(out, hi)
    return torch.minimum(out, out.new_full((), 6.0))   # JAX's tie gradient


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
         out_scale: float = 1.0, fuse: bool = True,
         tanh: Optional[bool] = None) -> torch.Tensor:
    """SiLU = x * sigmoid(x). Float: in the activation's type; ``tanh``
    (None: ``TAT_SILU_TANH``, as JAX reads it) takes the sigmoid as
    ``0.5 * (tanh(x * 0.5) + 1)``, in the order of JAX's expression. int8,
    ``fuse=True``: in f32, then x the f32 reciprocal of ``out_scale``,
    PLUS_HALF_TRUNC, clamp. ``fuse=False``: the graphs' two-step dataflow,
    the sigmoid requantized to ``sig_scale`` first, then :func:`mul_q`."""
    if x.dtype.is_floating_point:
        if tanh is None:
            tanh = bool(config.get("TAT_SILU_TANH"))
        if tanh:
            return x * (0.5 * (torch.tanh(x * 0.5) + 1.0))
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


def upsample_bilinear(x: torch.Tensor, out_hw: Tuple[int, int]
                      ) -> torch.Tensor:
    """Bilinear upsample (UPSAMPLE mode 1): ``jax.image.resize(...,
    "bilinear")`` of the f32 values, H then W, each axis by
    :func:`resize_axis` (JAX's taps and weights, each output the sum of
    its taps in input order). An int8 input is rounded half away from
    zero and clamped; a float one returns float32. At an integer ratio
    the weights are multiples of a power of two, so the int8 sums are
    exact in any order and equal JAX's bit for bit."""
    out = resize_axis(x, 1, out_hw[0])
    out = resize_axis(out, 2, out_hw[1])
    if not x.dtype.is_floating_point:
        return clamp_i8(round_to_int(out, RoundMode.HALF_AWAY))
    return out


def batchnorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              in_scale: float = 1.0, out_scale: float = 1.0) -> torch.Tensor:
    """BatchNorm with fused parameters, ``y = x * scale + bias`` per channel
    (the last axis). int8: dequantize by ``in_scale``, the affine in f32,
    ``/ out_scale``, PLUS_HALF_TRUNC, clamp (a scale <= 0 reads 1); float:
    in ``x``'s type."""
    if x.dtype.is_floating_point:
        return x * scale.to(x.dtype) + bias.to(x.dtype)
    ins = np.float32(in_scale) if in_scale > 0 else np.float32(1.0)
    os_ = np.float32(out_scale) if out_scale > 0 else np.float32(1.0)
    xf = x.to(torch.float32) * float(ins)
    y = xf * scale.to(torch.float32) + bias.to(torch.float32)
    return quantize_edge(y, os_)


def fc(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
       in_scale: float = 1.0, w_scale=1.0, out_scale: float = 1.0,
       relu_act: bool = False) -> torch.Tensor:
    """Fully connected, ``x`` [N, K] @ ``w`` [K, O]. int8: the exact int32
    product (float64 sums, exact for int8: torch has no int32 matmul on
    the card), + the int32 bias, x the combined scale (per output channel
    for a per-channel ``w_scale``), HALF_AWAY, clamp, as the conv
    epilogue. Float: the product in the operands' common type, + bias.
    ``relu_act`` then clamps at 0."""
    if not x.dtype.is_floating_point:
        acc = (x.to(torch.float64) @ w.to(torch.float64)).to(torch.int32)
        if bias is not None:
            acc = acc + bias.to(torch.int32)
        out = requantize(acc, _combined_scale(in_scale, w_scale, out_scale,
                                              x.device), RoundMode.HALF_AWAY)
    else:
        dt = torch.promote_types(x.dtype, w.dtype)
        out = x.to(dt) @ w.to(dt)
        if bias is not None:
            out = out + bias
    if relu_act:
        out = relu(out)
    return out


def conv1d(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
           stride: int, dilation: int, pads: Tuple[int, int],
           out_len: int) -> torch.Tensor:
    """CONV1D: [N, C, L] x OIW [O, C, K] -> float32 [N, O, out_len], the
    input zero-padded by ``pads``, + bias."""
    xp = torch.nn.functional.pad(x.to(torch.float32), tuple(pads))
    out = torch.nn.functional.conv1d(xp, w.to(torch.float32), None, stride,
                                     0, dilation)[:, :, :out_len]
    if bias is not None:
        out = out + bias.to(torch.float32)[:, None]
    return out.contiguous()


def conv1d_transpose(x: torch.Tensor, w: torch.Tensor,
                     bias: Optional[torch.Tensor], stride: int,
                     pads: Tuple[int, int], out_len: int) -> torch.Tensor:
    """CONV1D_TRANSPOSE (ONNX ConvTranspose): [N, C_in, L] with ``w`` [C_in,
    O, K] -> float32 [N, O, out_len]: the full transposed conv, its first
    ``pads[0]`` outputs dropped, cropped to ``out_len``, + bias."""
    full = torch.nn.functional.conv_transpose1d(
        x.to(torch.float32), w.to(torch.float32), None, stride)
    out = full[:, :, pads[0]:pads[0] + out_len]
    if bias is not None:
        out = out + bias.to(torch.float32)[:, None]
    return out.contiguous()


def gru(x: torch.Tensor, w: torch.Tensor, r: torch.Tensor,
        b: Optional[torch.Tensor], h0: Optional[torch.Tensor], hidden: int,
        linear_before_reset: bool = False, direction: str = "forward"
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ONNX GRU over ``x`` [T, B, C] (gate order z, r, h), in float32:
    ``w`` [D, 3H, C], ``r`` [D, 3H, H], ``b`` [D, 6H] (input then
    recurrence biases), ``h0`` [D, B, H] (zeros where None). Direction 1
    of a bidirectional GRU, or a ``"reverse"`` one, runs from the last
    step to the first. ``linear_before_reset`` applies the reset gate
    after the recurrent product (torch's convention), else to h before it
    (ONNX's default). Returns ``Y`` [T, D, B, H] and ``Y_h`` [D, B, H]."""
    hs = hidden
    x = x.to(torch.float32)
    t, bsz, c = x.shape
    ys, finals = [], []
    for d in range(w.shape[0]):
        w_t = w[d].to(torch.float32).t()
        r_t = r[d].to(torch.float32).t()
        bd = (b[d].to(torch.float32) if b is not None else
              torch.zeros(6 * hs, dtype=torch.float32, device=x.device))
        wbi, rbi = bd[:3 * hs], bd[3 * hs:]
        # the input's products of every step at once
        gi_all = (x.reshape(t * bsz, c) @ w_t + wbi).reshape(t, bsz, 3 * hs)
        h = (h0[d].to(torch.float32) if h0 is not None else
             torch.zeros(bsz, hs, dtype=torch.float32, device=x.device))
        rev = direction == "reverse" or d == 1
        y = [None] * t
        for step in (range(t - 1, -1, -1) if rev else range(t)):
            gi = gi_all[step]
            hz = h @ r_t[:, :hs] + rbi[:hs]
            hr = h @ r_t[:, hs:2 * hs] + rbi[hs:2 * hs]
            z = torch.sigmoid(gi[:, :hs] + hz)
            rr = torch.sigmoid(gi[:, hs:2 * hs] + hr)
            if linear_before_reset:
                hh = h @ r_t[:, 2 * hs:] + rbi[2 * hs:]
                n_ = torch.tanh(gi[:, 2 * hs:] + rr * hh)
            else:
                n_ = torch.tanh(gi[:, 2 * hs:] + (rr * h) @ r_t[:, 2 * hs:]
                                + rbi[2 * hs:])
            h = (1.0 - z) * n_ + z * h
            y[step] = h
        ys.append(torch.stack(y))
        finals.append(h)
    return torch.stack(ys, dim=1), torch.stack(finals)


# XLA's CPU backend sums a reduction longer than this in runs of this many
# elements (the runs centred on the padded length), then sums the runs
_XLA_REDUCE_RUN = 32


def _xla_column_sums(w: np.ndarray) -> np.ndarray:
    """``w.sum(axis=0)`` in f32, in the order XLA's CPU backend sums it
    (its tree reduction): for n > 32 rows, runs of 32 rows from row
    ``-pad // 2`` (pad: to the next multiple of 32), each summed in row
    order from 0, then the runs' sums in run order."""
    n = w.shape[0]
    if n <= _XLA_REDUCE_RUN:
        runs = [w]
    else:
        pad = -n % _XLA_REDUCE_RUN
        starts = range(-(pad // 2), n, _XLA_REDUCE_RUN)
        runs = [w[max(s, 0):s + _XLA_REDUCE_RUN] for s in starts]
    total = np.zeros(w.shape[1], np.float32)
    for run in runs:
        part = np.zeros(w.shape[1], np.float32)
        for row in run:
            part = part + row
        total = total + part
    return total


@functools.lru_cache(maxsize=32)
def resize_taps(n_in: int, n_out: int) -> Tuple[np.ndarray, np.ndarray]:
    """The bilinear resize weights of one axis, ``n_in`` -> ``n_out``, as
    ``jax.image.resize(..., "bilinear")`` computes them on the CPU (the
    formula of ``jax._src.image.scale.compute_weight_mat``, copied, in
    f32): the triangle kernel widened by ``1 / scale`` when shrinking
    (antialias), each output's weights divided by their sum, zero where
    the sample falls outside the input. XLA divides by the constant
    kernel scale as a multiply by its f32 reciprocal and sums the columns
    in runs (:func:`_xla_column_sums`); both are kept, so the weights are
    JAX's bit for bit.

    Returns ``(index, weight)``, each [n_out, T]: output j's nonzero taps
    in ascending input order (T the most any output has; the rest padded
    with input 0 at weight 0), the weights f32 values held as f64."""
    f32 = np.float32
    inv = 1.0 / (n_out / n_in)
    recip = f32(1) / f32(max(inv, 1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * f32(inv) - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) * recip
    w = np.maximum(f32(1) - np.abs(x), f32(0))
    tot = _xla_column_sums(w)
    w = np.where(np.abs(tot) > f32(1000.0 * np.finfo(np.float32).eps),
                 w / np.where(tot != 0, tot, f32(1)), f32(0))
    w = np.where((sample >= -0.5) & (sample <= n_in - 0.5), w, f32(0))
    taps = [np.nonzero(w[:, j])[0] for j in range(n_out)]
    t = max(1, max(len(i) for i in taps))
    index = np.zeros((n_out, t), np.int64)
    weight = np.zeros((n_out, t), np.float64)
    for j, i in enumerate(taps):
        index[j, :len(i)] = i
        weight[j, :len(i)] = w[i, j]
    return index, weight


@functools.lru_cache(maxsize=32)
def resize_window(n_in: int, n_out: int
                  ) -> Optional[Tuple[int, int, np.ndarray]]:
    """:func:`resize_taps` as a strided window where ``n_in`` is a
    multiple of ``n_out`` (the camera sizes: 720 -> 360, 1080 -> 360):
    ``(s, c, weight)``, output j's window the inputs ``s j + c + t`` for
    t < T' (zero outside the input), ``weight`` [n_out, T'] its taps'
    weights there and 0 elsewhere, in the same ascending input order; None
    for any other ratio."""
    if n_in % n_out:
        return None
    s = n_in // n_out
    index, weight = resize_taps(n_in, n_out)
    j = np.arange(n_out)[:, None]
    live = weight != 0
    c = int(np.min(np.where(live, index - s * j, n_in)))
    t_max = int(np.max(np.where(live, index - s * j - c, 0))) + 1
    window = np.zeros((n_out, t_max), np.float64)
    rows, cols = np.nonzero(live)
    window[rows, index[rows, cols] - s * rows - c] = weight[rows, cols]
    return s, c, window


def resize_axis(x: torch.Tensor, axis: int, n_out: int) -> torch.Tensor:
    """One axis of the resize: each output the f32 sum of its taps in
    ascending input order, each step one fused multiply-add (the product
    exact, one rounding to f32), as the reference's dot computes it. The
    products of a uint8 or f32 input and an f32 weight are exact in f64,
    so ``addcmul`` in f64 with an f32 output rounds once a step whether or
    not the device contracts it: the card and the CPU give the same bits.
    A tap of weight 0 adds an exact 0, so an integer ratio reads its taps
    as strided views of the zero-padded input (:func:`resize_window`), no
    gather; any other ratio gathers them."""
    n_in = x.shape[axis]
    shape = [1] * x.dim()
    shape[axis] = n_out
    out_shape = list(x.shape)
    out_shape[axis] = n_out
    acc = torch.zeros(out_shape, dtype=torch.float32, device=x.device)
    win = resize_window(n_in, n_out)
    if win is None:
        index, weight = resize_taps(n_in, n_out)
        idx = device_constant(index, x.device)
        taps = [x.index_select(axis, idx[:, t])
                for t in range(index.shape[1])]
    else:
        s, c, weight = win
        left = max(0, -c)
        right = max(0, s * (n_out - 1) + c + weight.shape[1] - n_in)
        pads = [torch.zeros(x.shape[:axis] + (p,) + x.shape[axis + 1:],
                            dtype=x.dtype, device=x.device)
                for p in (left, right)]
        xp = torch.cat([pads[0], x, pads[1]], axis)
        taps = []
        for t in range(weight.shape[1]):
            start = c + left + t
            view = [slice(None)] * x.dim()
            view[axis] = slice(start, start + s * (n_out - 1) + 1, s)
            taps.append(xp[tuple(view)])
    wts = device_constant(weight, x.device)
    for t, tap in enumerate(taps):
        torch.addcmul(acc, tap, wts[:, t].view(shape), out=acc)
    return acc
