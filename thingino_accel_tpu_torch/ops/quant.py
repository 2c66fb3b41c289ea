"""Quantization rounding rules (port of ``thingino_accel_tpu.ops.quant``).

Two rules, both needed for bit parity with the reference's int8 outputs:

1. ``HALF_AWAY``: ``(int)(x + (x >= 0 ? 0.5f : -0.5f))``, the conv
   epilogue rule.
2. ``PLUS_HALF_TRUNC``: ``(int)(x + 0.5f)`` with C's truncation toward
   zero (so -1.2 -> -0.7 -> 0), the rule of the elementwise int8 ops
   such as ``add_q``.

All arithmetic is float32, one torch op per C operation, so no two are
fused into one rounding. ``quantize``, ``dequantize`` and
``combined_scale`` are JAX's public helpers (``ops/quant.py:72-90``);
:func:`device_constant` keeps the host constants of a forward on the
device.
"""

from __future__ import annotations

import enum
import functools

import numpy as np
import torch


class RoundMode(enum.Enum):
    HALF_AWAY = "half_away"
    PLUS_HALF_TRUNC = "plus_half"


# the float32 values nearest int32's ends: a conversion saturates there, as
# XLA's float -> int32 conversion does (a cast out of range is undefined)
_I32_LO, _I32_HI = -2147483648.0, 2147483520.0


def round_to_int(x: torch.Tensor, mode: RoundMode) -> torch.Tensor:
    """f32 -> int32 with one of the reference rounding rules, saturating
    beyond int32's range."""
    x = x.to(torch.float32)
    if mode is RoundMode.HALF_AWAY:
        shifted = x + torch.where(x >= 0, 0.5, -0.5)
    else:
        shifted = x + 0.5
    return torch.clamp(torch.trunc(shifted), _I32_LO, _I32_HI).to(
        torch.int32)


def clamp_i8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, -128, 127).to(torch.int8)


def requantize(acc_i32: torch.Tensor, combined_scale,
               mode: RoundMode = RoundMode.HALF_AWAY) -> torch.Tensor:
    """int32 accumulator -> int8, the reference conv epilogue:
    ``acc -> f32 x combined_scale``, round by ``mode``, clamp.
    ``combined_scale`` is a float or a per-channel f32 tensor broadcast
    over the last axis."""
    scaled = acc_i32.to(torch.float32) * combined_scale
    return clamp_i8(round_to_int(scaled, mode))


def device_constant(value, device) -> torch.Tensor:
    """``value`` (a numpy array or scalar) as a tensor of its dtype on
    ``device``, made once per (value, device) and kept for the process:
    the host constants a forward needs, so that no forward copies from the
    host (a pageable copy syncs the host and cannot sit in a CUDA graph).
    A captured graph reads it by address, so nothing ever evicts it.
    Callers must not write to it."""
    a = np.ascontiguousarray(value)
    return _device_array(a.tobytes(), a.dtype.str, a.shape,
                         torch.device(device))


@functools.lru_cache(maxsize=None)
def _device_array(data: bytes, dtype: str, shape: tuple,
                  device: torch.device) -> torch.Tensor:
    host = np.frombuffer(data, np.dtype(dtype)).reshape(shape).copy()
    return torch.from_numpy(host).to(device)


def quantize(x: torch.Tensor, scale: float,
             mode: RoundMode = RoundMode.PLUS_HALF_TRUNC) -> torch.Tensor:
    """f32 -> int8 with the elementwise rule ``(int)(x/scale + 0.5)`` (a
    true f32 division by a divisor on ``x``'s device: CUDA multiplies by
    the reciprocal of a host scalar, which differs on rounding ties)."""
    xf = x.to(torch.float32)
    q = round_to_int(xf / device_constant(np.float32(scale), xf.device),
                     mode)
    return clamp_i8(q)


def dequantize(q: torch.Tensor, scale: float) -> torch.Tensor:
    """int8 -> f32: ``q * scale`` (zero point 0 throughout the
    reference)."""
    return q.to(torch.float32) * float(np.float32(scale))


def combined_scale(in_scale: float, w_scale: float, out_scale: float
                   ) -> float:
    """f32 replica of ``(in_scale * w_scale) / out_scale`` computed in C
    floats (per-tensor)."""
    return float(np.float32(np.float32(in_scale) * np.float32(w_scale))
                 / np.float32(out_scale))
