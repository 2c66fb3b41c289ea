"""Quantization rounding rules (port of ``thingino_accel_tpu.ops.quant``).

Two rules, both needed for bit parity with the reference's int8 outputs:

1. ``HALF_AWAY``: ``(int)(x + (x >= 0 ? 0.5f : -0.5f))``, the conv
   epilogue rule.
2. ``PLUS_HALF_TRUNC``: ``(int)(x + 0.5f)`` with C's truncation toward
   zero (so -1.2 -> -0.7 -> 0), the rule of the elementwise int8 ops
   such as ``add_q``.

All arithmetic is float32, one torch op per C operation, so no two are
fused into one rounding.
"""

from __future__ import annotations

import enum

import torch


class RoundMode(enum.Enum):
    HALF_AWAY = "half_away"
    PLUS_HALF_TRUNC = "plus_half"


def round_to_int(x: torch.Tensor, mode: RoundMode) -> torch.Tensor:
    """f32 -> int32 with one of the reference rounding rules."""
    x = x.to(torch.float32)
    if mode is RoundMode.HALF_AWAY:
        shifted = x + torch.where(x >= 0, 0.5, -0.5)
    else:
        shifted = x + 0.5
    return torch.trunc(shifted).to(torch.int32)


def clamp_i8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, -128, 127).to(torch.int8)
