"""The exact tier's int8 conv dispatch (counterpart of
``thingino_accel_tpu.ops.conv`` with its ``pallas`` backend).

A conv with one per-tensor weight scale goes to the hand-written kernels
through ``ops.requant_kernels.conv2d_int8`` (#9, #10 or #11). A conv with
per-channel weight scales takes the plain op ``ops.reference.
conv2d_int8``, as the JAX executor sends it to XLA whatever the backend
(the Pallas epilogue is per-tensor only); ``counts["plain_convs"]`` counts
those, so that a census never hides them. Both JAX backends give the same
numbers, so there is no backend switch: one route per case.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from thingino_accel_tpu_torch.ops import reference as R
from thingino_accel_tpu_torch.ops import requant_kernels as RK
from thingino_accel_tpu_torch.ops.quant import RoundMode

PLAIN = "plain_convs"

# per-channel convs run by the plain op since the last reset_counts()
counts: Dict[str, int] = {PLAIN: 0}


def reset_counts() -> None:
    counts[PLAIN] = 0


def per_channel(w_scale) -> bool:
    return np.ndim(w_scale) > 0


def route(kernel: Tuple[int, int], stride: Tuple[int, int],
          dilation: Tuple[int, int],
          pads: Tuple[Tuple[int, int], Tuple[int, int]], w_scale) -> str:
    """Where :func:`conv2d_int8` runs a conv: a kernel's launch counter
    (``requant_kernels.route``) or ``"plain_convs"``."""
    if per_channel(w_scale):
        return PLAIN
    return RK.route(kernel, stride, dilation, pads)


def conv2d_int8(
    x: torch.Tensor, w: torch.Tensor, bias_i32: Optional[torch.Tensor],
    out_hw: Tuple[int, int], stride: Tuple[int, int],
    dilation: Tuple[int, int],
    pads: Tuple[Tuple[int, int], Tuple[int, int]],
    in_scale: float, w_scale, out_scale: float,
    round_mode: RoundMode = RoundMode.HALF_AWAY, relu: bool = False,
    plain: bool = False,
) -> torch.Tensor:
    """int8 conv (x NHWC, w OHWI) with the exact requantize; ``plain=True``
    takes the kernels' plain versions (a check, never the serving path)."""
    if per_channel(w_scale):
        if not plain:
            counts[PLAIN] += 1
        return R.conv2d_int8(x, w, bias_i32, out_hw, stride, dilation, pads,
                             in_scale, w_scale, out_scale, round_mode, relu)
    return RK.conv2d_int8(x, w, bias_i32, out_hw, stride, dilation, pads,
                          in_scale, float(w_scale), out_scale, round_mode,
                          relu, plain=plain)
