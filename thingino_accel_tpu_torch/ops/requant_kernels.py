"""The exact tier's int8 conv kernels: a conv or matmul whose requantize
(bias, one per-tensor combined scale, either ``RoundMode``, clamp, then
RELU on the quantized value) runs before the single int8 write. Port of
``thingino_accel_tpu.ops.pallas_kernels``, with its names:

- :func:`matmul_int8_requant` (kernel #9, the 1x1 convs), CUDA
  ``tat_mm_int8_requant`` in ``csrc/requant_int8.cu``;
- :func:`conv2d_int8_halo` (kernel #10, KxK convs at square stride, in the
  model at stride 1), CUDA ``tat_conv_int8_requant``;
- :func:`conv2d_int8`, the JAX dispatch: 1x1/s1 unpadded -> #9, stride
  and dilation 1 -> #10, anything else (any stride, also non-square, any
  dilation) through kernel #11, ``tat_conv_int8_requant`` at the general
  instantiation (the JAX ``_tapconv_call``).

Each wrapper takes its ``_plain`` version for a tensor on the CPU and
launches its kernel for a tensor on a CUDA device (or raises). The plain
versions accumulate in float64 (exact for int8 products) and run the
requantize in torch float32 ops in the Pallas bodies' order; they run on
any device. ``launches`` counts one launch per TPU kernel, so a census
shows which of the three each conv replaced.

Weights are OHWI ``[O, KH, KW, C]`` (``[N, K]`` for the matmul), the
kernels' layout (``runtime.executor.params_from_jax`` repacks the JAX
package's HWIO). The combined scale is computed on the host in numpy f32,
``float32(float32(in * w) / out)``, as the JAX functions compute it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from thingino_accel_tpu_torch.ops import cuda_build
from thingino_accel_tpu_torch.ops import reference as R
from thingino_accel_tpu_torch.ops.quant import RoundMode

_ROUND_CODE = {RoundMode.HALF_AWAY: 0, RoundMode.PLUS_HALF_TRUNC: 1}

# Kernel launches per TPU kernel since the last reset_launches().
launches: Dict[str, int] = {"matmul_int8_requant": 0,
                            "conv2d_int8_halo": 0,
                            "conv2d_int8": 0}

Pads = Tuple[Tuple[int, int], Tuple[int, int]]


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def combined_scale(in_scale: float, w_scale: float, out_scale: float
                   ) -> float:
    """``in_scale * w_scale / out_scale`` in numpy f32 (per-tensor)."""
    return float(np.float32(np.float32(in_scale) * np.float32(w_scale))
                 / np.float32(out_scale))


def route(kernel: Tuple[int, int], stride: Tuple[int, int],
          dilation: Tuple[int, int], pads: Pads) -> str:
    """The TPU kernel :func:`conv2d_int8` runs a conv of these geometry
    attributes in (its launch counter's name)."""
    if tuple(kernel) == (1, 1) and tuple(stride) == (1, 1) \
            and tuple(map(tuple, pads)) == ((0, 0), (0, 0)):
        return "matmul_int8_requant"
    if tuple(stride) == (1, 1) and tuple(dilation) == (1, 1):
        return "conv2d_int8_halo"
    return "conv2d_int8"


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def requant_exact_plain(acc: torch.Tensor, bias: Optional[torch.Tensor],
                        cs: float, round_mode: RoundMode = RoundMode.HALF_AWAY,
                        relu: bool = False) -> torch.Tensor:
    """int32 accumulator [..., N] -> int8, the Pallas bodies' tail: + bias,
    -> f32, x cs, + 0.5 (away from zero for HALF_AWAY), trunc, clamp
    [-128, 127] in f32, [max(q, 0)], int8."""
    if bias is not None:
        acc = acc + bias.to(torch.int32)
    scaled = acc.to(torch.float32) * cs
    if round_mode is RoundMode.HALF_AWAY:
        shifted = scaled + torch.where(scaled >= 0, 0.5, -0.5)
    else:
        shifted = scaled + 0.5
    q = torch.clamp(torch.trunc(shifted), -128.0, 127.0)
    if relu:
        q = torch.clamp_min(q, 0.0)
    return q.to(torch.int8)


def matmul_int8_requant_plain(
    x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
    combined_scale: float, round_mode: RoundMode = RoundMode.HALF_AWAY,
    relu: bool = False,
) -> torch.Tensor:
    """``x [M, K] int8 @ w [N, K]^T`` -> int8 [M, N]."""
    acc = (x.to(torch.float64) @ w.to(torch.float64).t()).to(torch.int32)
    return requant_exact_plain(acc, bias, combined_scale, round_mode, relu)


def conv2d_int8_plain(
    x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
    out_hw: Tuple[int, int], stride: Tuple[int, int],
    dilation: Tuple[int, int], pads: Pads, in_scale: float, w_scale: float,
    out_scale: float, round_mode: RoundMode = RoundMode.HALF_AWAY,
    relu: bool = False,
) -> torch.Tensor:
    """NHWC int8 ``x`` (*) OHWI int8 ``w`` at any stride and dilation,
    zero outside the image -> int8 [N, OH, OW, O]."""
    acc = R.conv2d_acc_i32(x, w, out_hw, stride, dilation, pads)
    return requant_exact_plain(acc, bias,
                               combined_scale(in_scale, w_scale, out_scale),
                               round_mode, relu)


def conv2d_int8_halo_plain(
    x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
    out_hw: Tuple[int, int], stride: Tuple[int, int], pads: Pads,
    in_scale: float, w_scale: float, out_scale: float,
    round_mode: RoundMode = RoundMode.HALF_AWAY, relu: bool = False,
) -> torch.Tensor:
    """:func:`conv2d_int8_plain` at square ``stride`` and dilation 1."""
    _check_square(stride)
    return conv2d_int8_plain(x, w, bias, out_hw, stride, (1, 1), pads,
                             in_scale, w_scale, out_scale, round_mode, relu)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check_square(stride) -> None:
    if stride[0] != stride[1]:
        raise ValueError(f"the halo kernel needs a square stride, got "
                         f"{tuple(stride)}")


def _check(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
           n_out: int) -> torch.device:
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"int8 operands expected, got {x.dtype}, {w.dtype}")
    if bias is not None and (bias.dtype != torch.int32
                             or tuple(bias.shape) != (n_out,)):
        raise ValueError(f"bias must be int32 [{n_out}], got "
                         f"{bias.dtype} {tuple(bias.shape)}")
    ts = (x, w) + ((bias,) if bias is not None else ())
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")
    dev = x.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not all(t.is_contiguous() for t in ts):
        raise ValueError("CUDA kernel operands must be contiguous")
    return dev


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def matmul_int8_requant(
    x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
    combined_scale: float, round_mode: RoundMode = RoundMode.HALF_AWAY,
    relu: bool = False,
) -> torch.Tensor:
    """Kernel #9: ``requant(x @ w^T + b)``, x [M, K] int8, w [N, K] int8,
    bias [N] int32 or None -> int8 [M, N]."""
    m, k = x.shape
    n, k_w = w.shape
    if k_w != k:
        raise ValueError(f"K mismatch: x {tuple(x.shape)}, w {tuple(w.shape)}")
    dev = _check(x, w, bias, n)
    if dev.type == "cpu":
        return matmul_int8_requant_plain(x, w, bias, combined_scale,
                                         round_mode, relu)
    out = torch.empty((m, n), dtype=torch.int8, device=dev)
    if out.numel() > 0:
        cuda_build.check(cuda_build.load_library().tat_mm_int8_requant(
            _ptr(x), _ptr(w), _ptr(bias), _ptr(out), m, n, k,
            float(np.float32(combined_scale)), _ROUND_CODE[round_mode],
            int(relu), torch.cuda.current_stream(dev).cuda_stream),
            "tat_mm_int8_requant")
        launches["matmul_int8_requant"] += 1
    return out


def _launch_conv(x, w, bias, cs, stride, dilation, pads, round_mode, relu,
                 out) -> None:
    nb, h, wd, c = x.shape
    o, kh, kw, _ = w.shape
    (pt, _), (pl, _) = pads
    cuda_build.check(cuda_build.load_library().tat_conv_int8_requant(
        _ptr(x), _ptr(w), _ptr(bias), _ptr(out), nb, h, wd, c, o, kh, kw,
        stride[0], stride[1], dilation[0], dilation[1], pt, pl,
        out.shape[1], out.shape[2], float(np.float32(cs)),
        _ROUND_CODE[round_mode], int(relu),
        torch.cuda.current_stream(out.device).cuda_stream),
        "tat_conv_int8_requant")


def _conv(counter, x, w, bias, out_hw, stride, dilation, pads, in_scale,
          w_scale, out_scale, round_mode, relu) -> torch.Tensor:
    """Kernel #10 or #11 on a CUDA tensor, the plain version on the CPU.
    ``out_hw`` is the declared output size; only pt/pl of ``pads``
    position the window, and taps outside the image read zero."""
    nb, h, wd, c = x.shape
    o, kh, kw, c_w = w.shape
    if c_w != c:
        raise ValueError(f"C mismatch: x {tuple(x.shape)}, w {tuple(w.shape)}")
    dev = _check(x, w, bias, o)
    if dev.type == "cpu":
        return conv2d_int8_plain(x, w, bias, out_hw, stride, dilation, pads,
                                 in_scale, w_scale, out_scale, round_mode,
                                 relu)
    out = torch.empty((nb,) + tuple(out_hw) + (o,), dtype=torch.int8,
                      device=dev)
    if out.numel() > 0:
        _launch_conv(x, w, bias, combined_scale(in_scale, w_scale, out_scale),
                     stride, dilation, pads, round_mode, relu, out)
        launches[counter] += 1
    return out


def conv2d_int8_halo(
    x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
    out_hw: Tuple[int, int], stride: Tuple[int, int], pads: Pads,
    in_scale: float, w_scale: float, out_scale: float,
    round_mode: RoundMode = RoundMode.HALF_AWAY, relu: bool = False,
) -> torch.Tensor:
    """Kernel #10: a KxK int8 conv at square ``stride``, dilation 1, x
    NHWC [N, H, W, C], w OHWI [O, KH, KW, C] -> int8 [N, OH, OW, O]."""
    _check_square(stride)
    return _conv("conv2d_int8_halo", x, w, bias, out_hw, stride, (1, 1), pads,
                 in_scale, w_scale, out_scale, round_mode, relu)


def conv2d_int8(
    x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
    out_hw: Tuple[int, int], stride: Tuple[int, int],
    dilation: Tuple[int, int], pads: Pads, in_scale: float, w_scale: float,
    out_scale: float, round_mode: RoundMode = RoundMode.HALF_AWAY,
    relu: bool = False, plain: bool = False,
) -> torch.Tensor:
    """The exact tier's int8 conv, routed as the JAX ``conv2d_int8`` routes
    it (:func:`route`): 1x1/s1 unpadded -> :func:`matmul_int8_requant`;
    stride and dilation 1 -> :func:`conv2d_int8_halo`; anything else ->
    kernel #11. ``plain=True`` takes the plain versions on any device: for
    checking the kernels against them, never on the serving path."""
    n, h, wd, c = x.shape
    o, kh, kw, _ = w.shape
    which = route((kh, kw), stride, dilation, pads)
    if which == "matmul_int8_requant":
        mm = matmul_int8_requant_plain if plain else matmul_int8_requant
        out = mm(x.reshape(n * h * wd, c), w.reshape(o, c), bias,
                 combined_scale(in_scale, w_scale, out_scale), round_mode,
                 relu)
        return out.reshape(n, h, wd, o)
    if which == "conv2d_int8_halo":
        halo = conv2d_int8_halo_plain if plain else conv2d_int8_halo
        return halo(x, w, bias, out_hw, stride, pads, in_scale, w_scale,
                    out_scale, round_mode, relu)
    if plain:
        return conv2d_int8_plain(x, w, bias, out_hw, stride, dilation, pads,
                                 in_scale, w_scale, out_scale, round_mode,
                                 relu)
    return _conv("conv2d_int8", x, w, bias, out_hw, stride, dilation, pads,
                 in_scale, w_scale, out_scale, round_mode, relu)
