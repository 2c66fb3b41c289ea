"""The exact tier's int8 conv kernels: a conv or matmul whose requantize
(bias, one per-tensor combined scale, either ``RoundMode``, clamp, then
RELU on the quantized value) and activation run before the single int8
write. Port of ``thingino_accel_tpu.ops.pallas_kernels``, with its names:

- :func:`matmul_int8_requant` (kernel #9, the 1x1 convs), CUDA
  ``tat_mm_int8_requant_mma``: the serving tier's tensor-core 1x1 GEMM
  ``csrc/mm_int8_fused_mma.cu`` (``mma.sync`` from a ``cp.async`` ring,
  resident weights) under the exact epilogue policy, one part, run with
  the block :func:`mm_requant_plan` picks;
- :func:`conv2d_int8_halo` (kernel #10, KxK convs at square stride, in the
  model at stride 1) and :func:`conv2d_int8`, the JAX dispatch: 1x1/s1
  unpadded -> #9, stride and dilation 1 -> #10, anything else (any
  stride, also non-square, any dilation) through kernel #11 (the JAX
  ``_tapconv_call``). #10 and #11 are one tensor-core implicit-GEMM
  kernel, CUDA ``tat_conv_int8_requant_mma`` in
  ``csrc/conv_int8_requant_mma.cu``, run with the block
  :func:`conv_requant_plan` picks: in slab mode (C % 32 == 0, x and w
  16-byte aligned) from a ``cp.async`` slab ring, else in im2col mode.

Each takes ``lut``: the conv's activation beyond RELU as 256 int8 values
(entry ``q + 128`` the act of ``q``, :func:`apply_table`), applied after
the requantize (in the kernel's epilogue, from shared memory), or None.
The activation of an int8 value is a function of that value alone, so the
table is exact (``runtime.executor.act_table`` builds it from the plain
activation).

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

import ctypes
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from thingino_accel_tpu_torch.ops import cuda_build
from thingino_accel_tpu_torch.ops import fused_kernels as FK
from thingino_accel_tpu_torch.ops import reference as R
from thingino_accel_tpu_torch.ops.quant import RoundMode, combined_scale

_ROUND_CODE = {RoundMode.HALF_AWAY: 0, RoundMode.PLUS_HALF_TRUNC: 1}

# Kernel launches per TPU kernel since the last reset_launches().
launches: Dict[str, int] = {"matmul_int8_requant": 0,
                            "conv2d_int8_halo": 0,
                            "conv2d_int8": 0}

Pads = Tuple[Tuple[int, int], Tuple[int, int]]


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


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


class KxKConv(NamedTuple):
    """A conv of a graph that #10 or #11 runs (``kernel``: the launch
    counter's name), at batch 1, and how often it occurs."""
    kernel: str
    h: int
    w: int
    c: int
    o: int
    oh: int
    ow: int
    ksize: Tuple[int, int]
    stride: Tuple[int, int]
    dilation: Tuple[int, int]
    pads: Pads
    count: int


def kxk_convs(g) -> List[KxKConv]:
    """The distinct CONV2D nodes of the IR graph ``g`` that :func:`route`
    sends to #10 or #11, in graph order, each with its count."""
    seen: Dict[tuple, int] = {}
    for n in g.nodes:
        if n.op != "CONV2D" or n.attrs.get("groups", 1) != 1:
            continue
        a = n.attrs
        _, h, w, c = g.tensors[n.inputs[0]].shape
        _, oh, ow, o = g.tensors[n.outputs[0]].shape
        k, s, d = tuple(a["kernel"]), tuple(a["stride"]), tuple(a["dilation"])
        pads = R._conv_pads((h, w), (oh, ow), k, s, d, a["padding"],
                            a["explicit_pad"])
        which = route(k, s, d, pads)
        if which != "matmul_int8_requant":
            key = (which, h, w, c, o, oh, ow, k, s, d, pads)
            seen[key] = seen.get(key, 0) + 1
    return [KxKConv(*key, count) for key, count in seen.items()]


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def apply_table(q: torch.Tensor, lut: Optional[torch.Tensor]
                ) -> torch.Tensor:
    """``lut[q + 128]`` (int8 ``q``, ``lut`` int8 [256] on q's device), or
    ``q`` where ``lut`` is None."""
    return q if lut is None else lut[q.long() + 128]


def requant_exact_plain(acc: torch.Tensor, bias: Optional[torch.Tensor],
                        cs: float, round_mode: RoundMode = RoundMode.HALF_AWAY,
                        relu: bool = False,
                        lut: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int32 accumulator [..., N] -> int8, the Pallas bodies' tail: + bias,
    -> f32, x cs, + 0.5 (away from zero for HALF_AWAY), trunc, clamp
    [-128, 127] in f32, [max(q, 0)], int8; then ``lut``."""
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
    return apply_table(q.to(torch.int8), lut)


def matmul_int8_requant_plain(
    x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
    combined_scale: float, round_mode: RoundMode = RoundMode.HALF_AWAY,
    relu: bool = False, lut: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``x [M, K] int8 @ w [N, K]^T`` -> int8 [M, N]."""
    acc = (x.to(torch.float64) @ w.to(torch.float64).t()).to(torch.int32)
    return requant_exact_plain(acc, bias, combined_scale, round_mode, relu,
                               lut)


def conv2d_int8_plain(
    x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
    out_hw: Tuple[int, int], stride: Tuple[int, int],
    dilation: Tuple[int, int], pads: Pads, in_scale: float, w_scale: float,
    out_scale: float, round_mode: RoundMode = RoundMode.HALF_AWAY,
    relu: bool = False, lut: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """NHWC int8 ``x`` (*) OHWI int8 ``w`` at any stride and dilation,
    zero outside the image -> int8 [N, OH, OW, O]."""
    acc = R.conv2d_acc_i32(x, w, out_hw, stride, dilation, pads)
    return requant_exact_plain(acc, bias,
                               combined_scale(in_scale, w_scale, out_scale),
                               round_mode, relu, lut)


def conv2d_int8_halo_plain(
    x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
    out_hw: Tuple[int, int], stride: Tuple[int, int], pads: Pads,
    in_scale: float, w_scale: float, out_scale: float,
    round_mode: RoundMode = RoundMode.HALF_AWAY, relu: bool = False,
    lut: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """:func:`conv2d_int8_plain` at square ``stride`` and dilation 1."""
    _check_square(stride)
    return conv2d_int8_plain(x, w, bias, out_hw, stride, (1, 1), pads,
                             in_scale, w_scale, out_scale, round_mode, relu,
                             lut)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check_square(stride) -> None:
    if stride[0] != stride[1]:
        raise ValueError(f"the halo kernel needs a square stride, got "
                         f"{tuple(stride)}")


def _check(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
           n_out: int, lut: Optional[torch.Tensor] = None) -> torch.device:
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"int8 operands expected, got {x.dtype}, {w.dtype}")
    if bias is not None and (bias.dtype != torch.int32
                             or tuple(bias.shape) != (n_out,)):
        raise ValueError(f"bias must be int32 [{n_out}], got "
                         f"{bias.dtype} {tuple(bias.shape)}")
    if lut is not None and (lut.dtype != torch.int8
                            or tuple(lut.shape) != (256,)):
        raise ValueError(f"lut must be int8 [256], got {lut.dtype} "
                         f"{tuple(lut.shape)}")
    ts = (x, w) + tuple(t for t in (bias, lut) if t is not None)
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
    relu: bool = False, lut: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Kernel #9: ``lut[requant(x @ w^T + b) + 128]``, x [M, K] int8, w
    [N, K] int8, bias [N] int32 or None, lut int8 [256] or None -> int8
    [M, N]. On a CUDA tensor the tensor-core 1x1 GEMM under the exact
    epilogue (``tat_mm_int8_requant_mma``) with :func:`mm_requant_plan`;
    on the CPU the plain version."""
    m, k = x.shape
    n, k_w = w.shape
    if k_w != k:
        raise ValueError(f"K mismatch: x {tuple(x.shape)}, w {tuple(w.shape)}")
    dev = _check(x, w, bias, n, lut)
    if dev.type == "cpu":
        return matmul_int8_requant_plain(x, w, bias, combined_scale,
                                         round_mode, relu, lut)
    out = torch.empty((m, n), dtype=torch.int8, device=dev)
    if out.numel() > 0:
        _launch_mm(x, w, bias, lut, combined_scale, round_mode, relu, out)
        launches["matmul_int8_requant"] += 1
    return out


def mm_requant_plan(m: int, n: int, k: int, limits: FK.SmemLimits
                    ) -> FK.MmPlan:
    """The 1x1 GEMM's plan for #9 (:func:`fused_kernels.mm_plan`, one part,
    the exact layout)."""
    return FK.mm_plan(m, n, (k,), True, limits, exact=True)


def _mm_args(x, w, bias, lut, cs, round_mode, relu, out,
             plan: FK.MmPlan) -> tuple:
    """The arguments of ``tat_mm_int8_requant_mma`` up to the stream."""
    m, k = x.shape
    return (_ptr(x), _ptr(w), _ptr(bias), _ptr(lut), _ptr(out), m,
            w.shape[0], k, float(np.float32(cs)), _ROUND_CODE[round_mode],
            int(relu), plan.bm, plan.bn, plan.kc, plan.stages,
            plan.tiles_per_block)


def _launch_mm(x, w, bias, lut, cs, round_mode, relu, out,
               plan: Optional[FK.MmPlan] = None) -> None:
    if plan is None:
        plan = mm_requant_plan(x.shape[0], w.shape[0], x.shape[1],
                               FK.smem_limits(out.device))
    cuda_build.check(cuda_build.load_library().tat_mm_int8_requant_mma(
        *_mm_args(x, w, bias, lut, cs, round_mode, relu, out, plan),
        torch.cuda.current_stream(out.device).cuda_stream),
        "tat_mm_int8_requant_mma")


def mm_occupancy(plan: FK.MmPlan, k: int) -> Tuple[int, int]:
    """``(shared memory bytes, blocks an SM holds)`` of #9's kernel with
    ``plan`` at K = ``k`` on the current card."""
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    cuda_build.check(cuda_build.load_library().tat_mm_int8_requant_mma_info(
        k, plan.bm, plan.bn, plan.kc, plan.stages, ctypes.byref(smem),
        ctypes.byref(blocks)), "tat_mm_int8_requant_mma_info")
    return smem.value, blocks.value


# ---------------------------------------------------------------------------
# The KxK kernel's plan (#10 and #11)
# ---------------------------------------------------------------------------


# One planner and one shared-memory layout for the KxK kernel of both
# tiers (ops/fused_kernels.py), under the names the exact tier has used;
# the exact kernels take bn 64 and 32 and keep the activation table
ConvPlan = FK.ConvPlan
CONV_TILES = FK.CONV_TILES
CONV_BNS = FK.CONV_BNS
_chunks = FK.conv_chunks
conv_mode = FK.conv_mode


def conv_requant_smem(mode: str, c: int, kh: int, kw: int, stride, dilation,
                      tile_h: int, tile_w: int, bn: int, ck: int,
                      resident: bool) -> int:
    """:func:`fused_kernels.conv_smem` with the exact policy's table."""
    return FK.conv_smem(mode, c, kh, kw, stride, dilation, tile_h, tile_w,
                        bn, ck, resident, FK.EXACT_TABLE_BYTES)


def conv_requant_plans(batch: int, oh: int, ow: int, c: int, o: int, kh: int,
                       kw: int, stride: Tuple[int, int],
                       dilation: Tuple[int, int], mode: str,
                       limits: FK.SmemLimits) -> Tuple[ConvPlan, ...]:
    """:func:`fused_kernels.conv_plans` with the exact kernels' blocks."""
    return FK.conv_plans(batch, oh, ow, c, o, kh, kw, tuple(stride),
                         tuple(dilation), mode, limits, CONV_BNS,
                         FK.EXACT_TABLE_BYTES)


def conv_requant_plan(batch: int, oh: int, ow: int, c: int, o: int, kh: int,
                      kw: int, stride: Tuple[int, int],
                      dilation: Tuple[int, int], mode: str,
                      limits: FK.SmemLimits) -> ConvPlan:
    """:func:`fused_kernels.conv_plan` with the exact kernels' blocks."""
    return FK.conv_plan(batch, oh, ow, c, o, kh, kw, stride, dilation, mode,
                        limits, CONV_BNS, FK.EXACT_TABLE_BYTES)


def _conv_args(x, w, bias, cs, stride, dilation, pads, round_mode, relu,
               out, plan: ConvPlan, lut=None) -> tuple:
    """The arguments of ``tat_conv_int8_requant_mma`` up to the stream."""
    nb, h, wd, c = x.shape
    o, kh, kw, _ = w.shape
    (pt, _), (pl, _) = pads
    return (_ptr(x), _ptr(w), _ptr(bias), _ptr(lut), _ptr(out), nb, h, wd, c,
            o, kh, kw, stride[0], stride[1], dilation[0], dilation[1], pt,
            pl, out.shape[1], out.shape[2], float(np.float32(cs)),
            _ROUND_CODE[round_mode], int(relu), FK._MODE_CODE[plan.mode],
            plan.tile_h, plan.tile_w, plan.bn, plan.ck, int(plan.resident),
            plan.tiles_per_block)


def _launch_conv(x, w, bias, cs, stride, dilation, pads, round_mode, relu,
                 out, plan: ConvPlan, lut=None) -> None:
    cuda_build.check(cuda_build.load_library().tat_conv_int8_requant_mma(
        *_conv_args(x, w, bias, cs, stride, dilation, pads, round_mode, relu,
                    out, plan, lut),
        torch.cuda.current_stream(out.device).cuda_stream),
        "tat_conv_int8_requant_mma")


def _info_args(plan: ConvPlan, c: int, kernel, stride, dilation) -> tuple:
    return (FK._MODE_CODE[plan.mode], c, kernel[0], kernel[1], stride[0],
            stride[1], dilation[0], dilation[1], plan.tile_h, plan.tile_w,
            plan.bn, plan.ck, int(plan.resident))


def conv_occupancy(plan: ConvPlan, c: int, kernel: Tuple[int, int], stride,
                   dilation) -> Tuple[int, int]:
    """``(shared memory bytes, blocks an SM holds)`` of the KxK kernel
    with ``plan`` on the current card
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    cuda_build.check(cuda_build.load_library().tat_conv_int8_requant_mma_info(
        *_info_args(plan, c, kernel, stride, dilation), ctypes.byref(smem),
        ctypes.byref(blocks)), "tat_conv_int8_requant_mma_info")
    return smem.value, blocks.value


def _conv(counter, x, w, bias, out_hw, stride, dilation, pads, in_scale,
          w_scale, out_scale, round_mode, relu, lut) -> torch.Tensor:
    """Kernel #10 or #11 on a CUDA tensor, the plain version on the CPU.
    ``out_hw`` is the declared output size; only pt/pl of ``pads``
    position the window, and taps outside the image read zero."""
    nb, h, wd, c = x.shape
    o, kh, kw, c_w = w.shape
    if c_w != c:
        raise ValueError(f"C mismatch: x {tuple(x.shape)}, w {tuple(w.shape)}")
    dev = _check(x, w, bias, o, lut)
    if dev.type == "cpu":
        return conv2d_int8_plain(x, w, bias, out_hw, stride, dilation, pads,
                                 in_scale, w_scale, out_scale, round_mode,
                                 relu, lut)
    out = torch.empty((nb,) + tuple(out_hw) + (o,), dtype=torch.int8,
                      device=dev)
    if out.numel() > 0:
        plan = conv_requant_plan(nb, out.shape[1], out.shape[2], c, o, kh, kw,
                                 stride, dilation, conv_mode(x, w),
                                 FK.smem_limits(dev))
        _launch_conv(x, w, bias, combined_scale(in_scale, w_scale, out_scale),
                     stride, dilation, pads, round_mode, relu, out, plan, lut)
        launches[counter] += 1
    return out


def conv2d_int8_halo(
    x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
    out_hw: Tuple[int, int], stride: Tuple[int, int], pads: Pads,
    in_scale: float, w_scale: float, out_scale: float,
    round_mode: RoundMode = RoundMode.HALF_AWAY, relu: bool = False,
    lut: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Kernel #10: a KxK int8 conv at square ``stride``, dilation 1, x
    NHWC [N, H, W, C], w OHWI [O, KH, KW, C] -> int8 [N, OH, OW, O]."""
    _check_square(stride)
    return _conv("conv2d_int8_halo", x, w, bias, out_hw, stride, (1, 1), pads,
                 in_scale, w_scale, out_scale, round_mode, relu, lut)


def conv2d_int8(
    x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
    out_hw: Tuple[int, int], stride: Tuple[int, int],
    dilation: Tuple[int, int], pads: Pads, in_scale: float, w_scale: float,
    out_scale: float, round_mode: RoundMode = RoundMode.HALF_AWAY,
    relu: bool = False, plain: bool = False,
    lut: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The exact tier's int8 conv, routed as the JAX ``conv2d_int8`` routes
    it (:func:`route`): 1x1/s1 unpadded -> :func:`matmul_int8_requant`;
    stride and dilation 1 -> :func:`conv2d_int8_halo`; anything else ->
    kernel #11; then ``lut``. ``plain=True`` takes the plain versions on
    any device: for checking the kernels against them, never on the
    serving path."""
    n, h, wd, c = x.shape
    o, kh, kw, _ = w.shape
    which = route((kh, kw), stride, dilation, pads)
    if which == "matmul_int8_requant":
        mm = matmul_int8_requant_plain if plain else matmul_int8_requant
        out = mm(x.reshape(n * h * wd, c), w.reshape(o, c), bias,
                 combined_scale(in_scale, w_scale, out_scale), round_mode,
                 relu, lut)
        return out.reshape(n, h, wd, o)
    if which == "conv2d_int8_halo":
        halo = conv2d_int8_halo_plain if plain else conv2d_int8_halo
        return halo(x, w, bias, out_hw, stride, pads, in_scale, w_scale,
                    out_scale, round_mode, relu, lut)
    if plain:
        return conv2d_int8_plain(x, w, bias, out_hw, stride, dilation, pads,
                                 in_scale, w_scale, out_scale, round_mode,
                                 relu, lut)
    return _conv("conv2d_int8", x, w, bias, out_hw, stride, dilation, pads,
                 in_scale, w_scale, out_scale, round_mode, relu, lut)
