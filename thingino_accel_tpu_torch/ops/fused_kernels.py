"""Serving-tier fused int8 convs: conv/matmul with the whole post-conv
chain (bias + per-channel scale + activation [+ residual] + requantize)
run before the single int8 write. Port of
``thingino_accel_tpu.ops.fused_kernels`` for the planned serving tier:

- :func:`matmul_int8_fused` (1x1 convs), CUDA kernel
  ``csrc/mm_int8_fused.cu``;
- :func:`conv2d_int8_halo_fused` (KxK convs at any square stride, the
  thin-channel stem included), CUDA kernel ``csrc/conv_int8_fused.cu``;
  with ``pipeline="dma"`` the same conv through ``csrc/conv_int8_dma.cu``,
  which stages each tile's input slab in shared memory through a two-slot
  ``cp.async`` ring (the JAX ``conv2d_int8_folded(pipeline="dma")``);
- :func:`matmul_int8_fused_multi` (a 1x1 conv over a CONCAT that is never
  materialized), CUDA kernel ``csrc/mm_multi_int8_fused.cu``;
- :func:`bottleneck_int8_fused` (the C3 bottleneck, 1x1 -> KxK/1 [+x]),
  CUDA kernel ``csrc/bneck_int8_fused.cu``;
- :func:`sppf_int8_fused` (three chained maxpools + 4-part 1x1), CUDA
  kernel ``csrc/sppf_int8_fused.cu``;
- :func:`depthwise_conv2d_int8_fused` (stride-1 depthwise convs), CUDA
  kernel ``csrc/dw_int8_fused.cu``;
- :func:`conv2d_int8_fused`, the dispatcher between the first two.

Each wrapper takes its plain torch version for a tensor on the CPU, and
launches its kernel for a tensor on a CUDA device (or raises). The plain
versions accumulate in float64 (exact for int8 products: |acc| <=
K*K*C*128^2 << 2^53) and run the same epilogue in torch float32 ops;
they are device-agnostic, since torch has no int32 matmul on CUDA.

Weights are in the kernels' layout: ``[N, K]`` for the matmuls, OHWI
``[O, KH, KW, C]`` for the convs (``runtime.executor.params_from_jax``
repacks the JAX package's HWIO) and the JAX layout ``[KH, KW, C]`` for
the depthwise convs.

A residual ``r`` joins the epilogue after the activation as
``pre + r * res_scale`` (``_act_requant``); ``res_scale`` is the value
the kernel multiplies by, after one of the three rules of the JAX
package (:func:`res_scale_multi`, :func:`res_scale_bneck`,
:func:`res_scale_folded`). LEAKY_RELU takes no residual: its alpha
applies on the quantized value.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from thingino_accel_tpu_torch.ops import cuda_build
from thingino_accel_tpu_torch.ops import reference as R

# SILU_FAST: the Pade sigmoid of the JAX ``_sigmoid_fast``; as in JAX no
# executor path selects it by default (TAT_FAST_SILU there)
ACTS = ("NONE", "RELU", "LEAKY_RELU", "SILU", "SILU_FAST")
_ACT_CODE = {a: i for i, a in enumerate(ACTS)}   # tat::Act in epilogue.cuh
_LINEAR = ("NONE", "RELU", "LEAKY_RELU")
MAX_PARTS = 4   # parts of matmul_int8_fused_multi: SPPF's concat has 4


def _kernel_act(act: str) -> int:
    """``tat::Act`` of a serving kernel's epilogue. SILU_FAST is compiled
    only into the probes' kernels (``act_requant<true>``, epilogue.cuh):
    a serving kernel refuses it; the plain versions take it."""
    if act == "SILU_FAST":
        raise ValueError("the serving kernels are built without SILU_FAST")
    return _ACT_CODE[act]


# Kernel launches per wrapper since the last reset_launches(): a run can
# show which kernels its main path went through.
launches: Dict[str, int] = {"matmul_int8_fused": 0,
                            "conv2d_int8_halo_fused": 0,
                            "matmul_int8_fused_multi": 0,
                            "bottleneck_int8_fused": 0,
                            "sppf_int8_fused": 0,
                            "depthwise_conv2d_int8_fused": 0,
                            "conv2d_int8_halo_dma": 0}
# the load schemes of the KxK conv: #2's gathers from global memory, or the
# slab ring of ``conv_int8_dma.cu``
PIPELINES = ("blockspec", "dma")


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _f32(v) -> float:
    """``v`` rounded to float32, as a Python float (exact in both)."""
    return float(np.float32(v))


@dataclasses.dataclass(frozen=True)
class Epilogue:
    """Requantize epilogue of one conv: ``cs`` is the [N] f32 per-channel
    scale row on the conv's device, ``inv_out`` a float32 value."""

    cs: torch.Tensor
    inv_out: float
    act: str
    alpha: float


def epilogue_rows(w_scale, in_scale: float, out_scale: float, act: str,
                  n: int, alpha: float = 0.01,
                  device: torch.device | str = "cpu") -> Epilogue:
    """Port of ``_scale_rows``: the scale arithmetic runs on the host in
    numpy f32, as the reference computes its combined scale in IEEE f32.

    NONE/RELU/LEAKY_RELU: ``cs = in*w/out`` and ``inv_out = 1`` (LEAKY
    quantizes on the linear path; alpha applies on the int8 value).
    SILU: ``cs = in*w`` and ``inv_out = 1/out``."""
    if act not in ACTS:
        raise ValueError(f"unsupported fused activation {act!r}")
    ws = np.asarray(w_scale, np.float32)
    if ws.ndim == 0:
        ws = np.full((n,), ws, np.float32)
    cs = (np.float32(in_scale) * ws).astype(np.float32)
    if act in _LINEAR:
        cs = (cs / np.float32(out_scale)).astype(np.float32)
        inv_out = 1.0
    else:
        inv_out = float(1.0 / np.float32(out_scale))
    return Epilogue(cs=torch.from_numpy(np.ascontiguousarray(cs)).to(device),
                    inv_out=inv_out, act=act, alpha=float(alpha))


@dataclasses.dataclass(frozen=True)
class MultiEpilogue:
    """Scales of :func:`matmul_int8_fused_multi`. ``same_scale``: every
    part (and the bias) has one input scale, so the parts' products sum
    in int32 and ``ep`` is the ordinary epilogue. Otherwise the parts
    combine in f32 with ``part_scales`` and ``ep.cs`` holds the weight
    scale only (divided by the out scale for the linear activations)."""

    ep: Epilogue
    same_scale: bool
    part_scales: Tuple[float, ...]
    bias_scale: float


def multi_epilogue(w_scale, in_scales: Sequence[float], out_scale: float,
                   act: str, n: int, alpha: float = 0.01,
                   bias_scale: Optional[float] = None,
                   device: torch.device | str = "cpu") -> MultiEpilogue:
    """Port of the scale set-up of ``matmul_int8_fused_multi``
    (fused_kernels.py:404-429): ``same_scale`` compares the f32 values
    of the part scales and of ``bias_scale`` (the bias's units; default
    the first part's scale)."""
    if act not in ACTS:
        raise ValueError(f"unsupported fused activation {act!r}")
    if bias_scale is None:
        bias_scale = float(in_scales[0])
    same = (len({_f32(s) for s in in_scales}) == 1
            and _f32(bias_scale) == _f32(in_scales[0]))
    if same:
        ep = epilogue_rows(w_scale, in_scales[0], out_scale, act, n, alpha,
                           device)
    else:
        ws = np.asarray(w_scale, np.float32)
        if ws.ndim == 0:
            ws = np.full((n,), ws, np.float32)
        if act in _LINEAR:
            cs = (ws / np.float32(out_scale)).astype(np.float32)
            inv_out = 1.0
        else:
            cs, inv_out = ws, float(1.0 / np.float32(out_scale))
        ep = Epilogue(cs=torch.from_numpy(np.array(cs, np.float32)).to(device),
                      inv_out=inv_out, act=act, alpha=float(alpha))
    return MultiEpilogue(ep=ep, same_scale=same,
                         part_scales=tuple(_f32(s) for s in in_scales),
                         bias_scale=_f32(bias_scale))


# The residual's effective scale: three rules, as the JAX package has
# them. They differ only for LEAKY_RELU, which takes no residual.


def res_scale_multi(res_scale: float, out_scale: float, act: str) -> float:
    """``matmul_int8_fused_multi`` (fused_kernels.py:430-435)."""
    if act in ("NONE", "RELU", "LEAKY_RELU"):
        return float(np.float32(res_scale) / np.float32(out_scale))
    return float(np.float32(res_scale))


def res_scale_bneck(in_scale: float, out_scale: float, act: str) -> float:
    """``bottleneck_int8_fused`` (fused_kernels.py:1309-1312)."""
    if act in ("NONE", "RELU"):
        return float(np.float32(in_scale) / np.float32(out_scale))
    return float(np.float32(in_scale))


def res_scale_folded(res_scale: float, out_scale: float, act: str) -> float:
    """``conv2d_int8_folded`` (fused_kernels.py:1094-1099)."""
    if act in ("NONE", "RELU", "LEAKY_RELU"):
        return float(np.float32(res_scale) / np.float32(out_scale))
    return float(np.float32(res_scale))


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def sigmoid_fast(x: torch.Tensor) -> torch.Tensor:
    """The JAX ``_sigmoid_fast`` (fused_kernels.py:79-110) as it computes
    outside a kernel: ``0.5 + 0.5 * tanh(y)`` with the [5/4] Pade tanh on
    ``y = x/2`` clamped to +-3.6333, the quotient ``num / den`` a true f32
    division; in the order of the JAX expression, one f32 rounding a
    step."""
    y = torch.clamp(x * 0.5, -3.6333, 3.6333)
    y2 = y * y
    y4 = y2 * y2
    num = y * ((945.0 + 105.0 * y2) + y4)
    den = (945.0 + 420.0 * y2) + 15.0 * y4
    return 0.5 + 0.5 * (num / den)


def act_requant_plain(pre: torch.Tensor, ep: Epilogue,
                      residual: Optional[torch.Tensor] = None,
                      res_scale: float = 1.0) -> torch.Tensor:
    """f32 pre-activation (already x cs) -> int8, in the order of the JAX
    ``_act_requant``: activation, [+ r*res_scale], x inv_out, +-0.5 by
    sign, trunc, clamp; LEAKY_RELU's alpha applies after the clamp on the
    quantized value, truncated."""
    if ep.act == "RELU":
        pre = torch.clamp_min(pre, 0.0)
    elif ep.act == "SILU":
        pre = pre * torch.sigmoid(pre)
    elif ep.act == "SILU_FAST":
        pre = pre * sigmoid_fast(pre)
    if residual is not None:
        if ep.act == "LEAKY_RELU":
            raise ValueError("LEAKY_RELU takes no fused residual: its alpha "
                             "applies after quantization")
        pre = pre + residual.to(torch.float32) * _f32(res_scale)
    scaled = pre * ep.inv_out
    shifted = scaled + torch.where(scaled >= 0, 0.5, -0.5)
    q = torch.clamp(torch.trunc(shifted), -128.0, 127.0)
    if ep.act == "LEAKY_RELU":
        neg = torch.clamp_min(torch.trunc(q * ep.alpha), -128.0)
        q = torch.where(q > 0, q, neg)
    return q.to(torch.int8)


def epilogue_plain(acc: torch.Tensor, bias: Optional[torch.Tensor],
                   ep: Epilogue, residual: Optional[torch.Tensor] = None,
                   res_scale: float = 1.0) -> torch.Tensor:
    """int32 accumulator [..., N] -> int8 (the JAX ``_epilogue``): +
    bias (int32), -> f32, x cs, then :func:`act_requant_plain`."""
    if bias is not None:
        acc = acc + bias
    return act_requant_plain(acc.to(torch.float32) * ep.cs, ep, residual,
                             res_scale)


def _mm_acc(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [M, K] @ w [N, K]^T`` as int32, exact through float64."""
    return (x.to(torch.float64) @ w.to(torch.float64).t()).to(torch.int32)


def matmul_int8_fused_plain(x: torch.Tensor, w: torch.Tensor,
                            bias: Optional[torch.Tensor], ep: Epilogue,
                            residual: Optional[torch.Tensor] = None,
                            res_scale: float = 1.0) -> torch.Tensor:
    """``x [M, K] int8 @ w [N, K]^T`` [+ residual [M, N]] -> int8 [M, N]."""
    return epilogue_plain(_mm_acc(x, w), bias, ep, residual, res_scale)


def conv2d_int8_halo_fused_plain(
    x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
    ep: Epilogue, out_hw: Tuple[int, int],
    pads: Tuple[Tuple[int, int], Tuple[int, int]], stride: int = 1,
    residual: Optional[torch.Tensor] = None, res_scale: float = 1.0,
) -> torch.Tensor:
    """NHWC int8 ``x`` (*) OHWI int8 ``w`` at square ``stride`` with zero
    padding ``pads`` [+ residual [N, OH, OW, O]] -> int8 NHWC
    [N, OH, OW, O]."""
    (pt, pb), (pl, pr) = pads
    oh, ow = out_hw
    xd = F.pad(x.permute(0, 3, 1, 2).to(torch.float64), (pl, pr, pt, pb))
    acc = F.conv2d(xd, w.permute(0, 3, 1, 2).to(torch.float64),
                   stride=stride)[:, :, :oh, :ow]
    acc = acc.permute(0, 2, 3, 1).to(torch.int32)
    return epilogue_plain(acc, bias, ep, residual, res_scale)


def matmul_int8_fused_multi_plain(
    xs: Sequence[torch.Tensor], ws: Sequence[torch.Tensor],
    bias: Optional[torch.Tensor], me: MultiEpilogue,
    residual: Optional[torch.Tensor] = None, res_scale: float = 1.0,
) -> torch.Tensor:
    """``sum_i x_i [M, K_i] @ w_i [N, K_i]^T`` -> int8 [M, N]. Equal
    scales: an int32 sum and the ordinary epilogue. Otherwise, as
    ``_mm_multi_kernel``: ``dot_i * s_i`` summed in f32 in part order,
    ``+ bias * bias_scale``, ``x cs``, then the activation tail."""
    accs = [_mm_acc(x, w) for x, w in zip(xs, ws)]
    if me.same_scale:
        acc = accs[0]
        for a in accs[1:]:
            acc = acc + a
        return epilogue_plain(acc, bias, me.ep, residual, res_scale)
    accf = accs[0].to(torch.float32) * me.part_scales[0]
    for a, s in zip(accs[1:], me.part_scales[1:]):
        accf = accf + a.to(torch.float32) * s
    if bias is None:
        bias = torch.zeros(me.ep.cs.shape, dtype=torch.int32,
                           device=accf.device)
    accf = (accf + bias.to(torch.float32) * me.bias_scale) * me.ep.cs
    return act_requant_plain(accf, me.ep, residual, res_scale)


def bottleneck_int8_fused_plain(
    x: torch.Tensor, w1: torch.Tensor, b1: Optional[torch.Tensor],
    ep1: Epilogue, w2: torch.Tensor, b2: Optional[torch.Tensor],
    ep2: Epilogue, shortcut: bool = False, res_scale: float = 1.0,
) -> torch.Tensor:
    """The C3 bottleneck: ``m = 1x1(x)`` (x NHWC [N, H, W, C], w1
    [CM, C]), then the KxK/1 conv over m with zero (quantized zero)
    padding (w2 OHWI [O, K, K, CM]) [+ x] -> int8 [N, H, W, O]."""
    n, h, wd, c = x.shape
    k = w2.shape[1]
    hh = (k - 1) // 2
    m = matmul_int8_fused_plain(x.reshape(n * h * wd, c), w1, b1, ep1)
    return conv2d_int8_halo_fused_plain(
        m.reshape(n, h, wd, -1), w2, b2, ep2, (h, wd), ((hh, hh), (hh, hh)),
        1, residual=x if shortcut else None, res_scale=res_scale)


def sppf_int8_fused_plain(x: torch.Tensor, w: torch.Tensor,
                          bias: Optional[torch.Tensor], ep: Epilogue,
                          k: int) -> torch.Tensor:
    """SPPF: ``m_{i+1} = maxpool_kxk/1(m_i)`` (padding -128), then the
    1x1 conv ``w [O, 4C]`` over ``concat(x, m1, m2, m3)`` -> int8
    [N, H, W, O]."""
    n, h, wd, c = x.shape
    p = (k - 1) // 2
    levels = [x]
    for _ in range(3):
        levels.append(R.maxpool(levels[-1], (k, k), (1, 1), (h, wd),
                                ((p, p), (p, p))))
    cat = torch.cat(levels, 3).reshape(n * h * wd, 4 * c)
    return matmul_int8_fused_plain(cat, w, bias, ep).reshape(n, h, wd, -1)


def depthwise_conv2d_int8_fused_plain(
    x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
    ep: Epilogue, out_hw: Tuple[int, int],
    pads: Tuple[Tuple[int, int], Tuple[int, int]],
) -> torch.Tensor:
    """Stride-1 depthwise conv: x NHWC [N, H, W, C] int8, w [KH, KW, C]
    int8, zero (quantized zero) outside the image -> int8 [N, OH, OW, C]
    through the epilogue. Elementwise int32 taps: exact on any device."""
    acc = R.depthwise_acc_i32(x, w, out_hw, (1, 1), (1, 1), pads)
    return epilogue_plain(acc, bias, ep)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check_operands(x, w, bias, ep, n_out, contiguous=True):
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"int8 operands expected, got {x.dtype}, {w.dtype}")
    if bias is not None and (bias.dtype != torch.int32
                             or tuple(bias.shape) != (n_out,)):
        raise ValueError(f"bias must be int32 [{n_out}], got "
                         f"{bias.dtype} {tuple(bias.shape)}")
    if ep.cs.dtype != torch.float32 or tuple(ep.cs.shape) != (n_out,):
        raise ValueError(f"cs must be float32 [{n_out}]")
    devs = {t.device for t in (x, w, ep.cs) + ((bias,) if bias is not None
                                               else ())}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")
    dev = x.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda":
        for t in (x, w, bias, ep.cs):
            if t is None:
                continue
            if contiguous or t.dim() < 2:
                ok = t.is_contiguous()
            else:   # rows may be strided; each row contiguous
                ok = t.shape[-1] <= 1 or t.stride(-1) == 1
            if not ok:
                raise ValueError("CUDA kernel operands must be contiguous")
    return dev


def _check_residual(res, shape, act, dev):
    if res is None:
        return
    if act == "LEAKY_RELU":
        raise ValueError("LEAKY_RELU takes no fused residual: its alpha "
                         "applies after quantization")
    if res.dtype != torch.int8 or tuple(res.shape) != tuple(shape):
        raise ValueError(f"residual must be int8 {tuple(shape)}, got "
                         f"{res.dtype} {tuple(res.shape)}")
    if res.device != dev:
        raise ValueError(f"residual on {res.device}, operands on {dev}")
    if dev.type == "cuda" and not res.is_contiguous():
        raise ValueError("CUDA kernel operands must be contiguous")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def matmul_int8_fused(x: torch.Tensor, w: torch.Tensor,
                      bias: Optional[torch.Tensor], ep: Epilogue,
                      residual: Optional[torch.Tensor] = None,
                      res_scale: float = 1.0) -> torch.Tensor:
    """``int8 = requant(act((x @ w^T + b) * cs) [+ r * res_scale])``:
    x [M, K] int8, w [N, K] int8, bias [N] int32 or None, residual
    [M, N] int8 or None -> int8 [M, N]."""
    m, k = x.shape
    n, k_w = w.shape
    if k_w != k:
        raise ValueError(f"K mismatch: x {tuple(x.shape)}, w {tuple(w.shape)}")
    dev = _check_operands(x, w, bias, ep, n)
    _check_residual(residual, (m, n), ep.act, dev)
    if dev.type == "cpu":
        return matmul_int8_fused_plain(x, w, bias, ep, residual, res_scale)
    out = torch.empty((m, n), dtype=torch.int8, device=dev)
    if m > 0:
        _launch_mm(x, w, bias, ep, residual, res_scale, out)
        launches["matmul_int8_fused"] += 1
    return out


def _launch_mm(x, w, bias, ep, residual, res_scale, out) -> None:
    m, k = x.shape
    cuda_build.check(cuda_build.load_library().tat_mm_int8_fused(
        _ptr(x), _ptr(w), _ptr(bias), _ptr(ep.cs), _ptr(residual), _ptr(out),
        m, w.shape[0], k, _kernel_act(ep.act), ep.inv_out, ep.alpha,
        _f32(res_scale), _stream(out.device)), "tat_mm_int8_fused")


def conv2d_int8_halo_fused(
    x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
    ep: Epilogue, out_hw: Tuple[int, int],
    pads: Tuple[Tuple[int, int], Tuple[int, int]], stride: int = 1,
    residual: Optional[torch.Tensor] = None, res_scale: float = 1.0,
    pipeline: str = "blockspec",
) -> torch.Tensor:
    """KxK int8 conv at square ``stride``: x NHWC [N, H, W, C] int8,
    w OHWI [O, KH, KW, C] int8 [+ residual [N, OH, OW, O]] -> int8
    [N, OH, OW, O]. ``out_hw`` is the graph's declared output size;
    ``pads`` ((pt, pb), (pl, pr)) may be asymmetric. Only pt/pl position
    the window; rows and columns past the input are zero.

    ``pipeline`` picks the kernel on a CUDA tensor: ``"blockspec"`` #2,
    ``"dma"`` the slab-ring kernel (no residual, as in JAX). Both compute
    the same function; on the CPU both take the plain version."""
    if pipeline not in PIPELINES:
        raise ValueError(f"unknown pipeline {pipeline!r}; one of {PIPELINES}")
    if pipeline == "dma" and residual is not None:
        raise ValueError("residual fusion not supported on the dma "
                         "pipeline variant")
    nb, h, wd, c = x.shape
    o, kh, kw, c_w = w.shape
    if c_w != c:
        raise ValueError(f"C mismatch: x {tuple(x.shape)}, w {tuple(w.shape)}")
    dev = _check_operands(x, w, bias, ep, o)
    oh, ow = out_hw
    _check_residual(residual, (nb, oh, ow, o), ep.act, dev)
    if dev.type == "cpu":
        return conv2d_int8_halo_fused_plain(x, w, bias, ep, out_hw, pads,
                                            stride, residual, res_scale)
    out = torch.empty((nb, oh, ow, o), dtype=torch.int8, device=dev)
    if out.numel() == 0:
        return out
    if pipeline == "dma":
        _launch_conv_dma(x, w, bias, ep, pads, stride, out, dma_plan(
            nb, c, o, kh, kw, stride, oh, ow, smem_limits(dev),
            _aligned16(x)))
        launches["conv2d_int8_halo_dma"] += 1
    else:
        _launch_conv(x, w, bias, ep, pads, stride, residual, res_scale, out)
        launches["conv2d_int8_halo_fused"] += 1
    return out


def _launch_conv(x, w, bias, ep, pads, stride, residual, res_scale,
                 out) -> None:
    nb, h, wd, c = x.shape
    o, kh, kw, _ = w.shape
    (pt, _), (pl, _) = pads
    cuda_build.check(cuda_build.load_library().tat_conv_int8_fused(
        _ptr(x), _ptr(w), _ptr(bias), _ptr(ep.cs), _ptr(residual), _ptr(out),
        nb, h, wd, c, o, kh, kw, stride, pt, pl, out.shape[1], out.shape[2],
        _kernel_act(ep.act), ep.inv_out, ep.alpha, _f32(res_scale),
        _stream(out.device)), "tat_conv_int8_fused")


# The slab-ring kernel's plan. A tile is tile_h x tile_w output pixels,
# tile_h = 64 // tile_w (the 64 rows of the dp4a tile); `ck` channels of
# its slab are staged a stage; the block's weights stay `resident` in
# shared memory, or stream with each chunk; a block walks
# `tiles_per_block` consecutive tiles of one image.
DMA_TILE_WIDTHS = (4, 8, 16, 32, 64)
_BLOCK_RESERVED = 1024   # shared memory the runtime keeps for each block
_BS_PITCH = 65 * 4       # bytes of a K-word row of the weight tile


@dataclasses.dataclass(frozen=True)
class DmaPlan:
    tile_h: int
    tile_w: int
    ck: int
    resident: bool
    tiles_per_block: int


@dataclasses.dataclass(frozen=True)
class SmemLimits:
    """What the plan reads of the device: its SMs, an SM's shared memory
    and the most one block may opt into, in bytes."""
    sms: int
    per_sm: int
    per_block: int


@functools.lru_cache(maxsize=16)
def smem_limits(device: torch.device) -> SmemLimits:
    p = torch.cuda.get_device_properties(device)
    return SmemLimits(p.multi_processor_count,
                      p.shared_memory_per_multiprocessor,
                      p.shared_memory_per_block_optin)


@dataclasses.dataclass(frozen=True)
class DmaLayout:
    """One block's dynamic shared memory in ``conv_int8_dma.cu``, in bytes
    from its start; the kernel takes these offsets as they are. Two ring
    slots, each the slab (the byte path: then its row table; streamed
    weights: then the chunk's weights), then the resident weights, then
    the byte path's k table and im2col tile."""
    vw: int           # bytes a copy: 16 or 4 (word paths), 1 (byte path)
    pix_bytes: int    # word paths: slab bytes a pixel
    row_bytes: int    # byte path: slab bytes a row
    rowadj_off: int   # byte path: the row table in a slot
    wslot_off: int    # streamed weights in a slot
    slot_bytes: int   # one ring slot
    res_off: int      # resident weights
    ktab_off: int     # byte path: (ky, kx, kx*C + c) of each k
    at_off: int       # byte path: the stage's im2col tile
    smem: int         # in all


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(v: int, m: int) -> int:
    return _cdiv(v, m) * m


def run_of_tiles(batch: int, tiles_img: int, oblocks: int, smem: int,
                 limits: SmemLimits, threads: int, max_blocks: int = 32
                 ) -> int:
    """The run of consecutive tiles a block of a tile-walking kernel takes:
    the fewest waves of blocks times a block's tiles plus one (its first
    copy and its last store overlap nothing), over the blocks an SM holds
    (by its threads, its shared memory and ``max_blocks``)."""
    per_sm = max(1, min(2048 // threads, max_blocks,
                        limits.per_sm // (smem + _BLOCK_RESERVED)))
    slots = limits.sms * per_sm

    def cost(tpb: int) -> int:
        blocks = batch * _cdiv(tiles_img, tpb) * oblocks
        return _cdiv(blocks, slots) * (tpb + 1)
    return min(range(1, tiles_img + 1), key=lambda t: (cost(t), -t))


def _aligned16(x: torch.Tensor) -> bool:
    return x.data_ptr() % 16 == 0


@functools.lru_cache(maxsize=1024)
def dma_layout(c: int, kh: int, kw: int, s: int, tile_h: int, tile_w: int,
               ck: int, resident: bool, vec16: bool = True) -> DmaLayout:
    """The shared-memory layout of one block of ``conv_int8_dma.cu``.
    Copies are 16 bytes when C and ``ck`` are multiples of 16 and the
    input is 16-byte aligned (``vec16``), 4 bytes when they are multiples
    of 4, else the byte path copies each slab row's covering words."""
    rows, cols = (tile_h - 1) * s + kh, (tile_w - 1) * s + kw
    vw = (16 if c % 16 == 0 and ck % 16 == 0 and vec16
          else 4 if c % 4 == 0 and ck % 4 == 0 else 1)
    pix = row = rowadj = wslot = 0
    if vw > 1:
        # a pixel pitch off a multiple of 128 B / s, so that the two pixels
        # a warp reads per row of its sub-tile fall on different banks
        pix = _round_up(ck, vw)
        if pix * s % 128 == 0:
            pix += vw
        slot = _round_up(rows * cols * pix, 16)
    else:
        row = _round_up(cols * c + 3, 4)
        rowadj = _round_up(rows * row, 16)
        slot = rowadj + _round_up(4 * rows, 16)
    if not resident:
        wslot = slot
        slot += _round_up(kh * kw * (ck // 4) * _BS_PITCH, 16)
    k = kh * kw * c
    res = 2 * slot
    ktab = res + (_round_up(_cdiv(k, 4) * _BS_PITCH, 16) if resident else 0)
    at = ktab + (_round_up(4 * k, 16) if vw == 1 else 0)
    smem = at + (64 * 4 * (_cdiv(k, 4) + 1) if vw == 1 else 0)
    return DmaLayout(vw, pix, row, rowadj, wslot, slot, res, ktab, at, smem)


def _dma_chunks(c: int) -> Tuple[int, ...]:
    """Channel chunks to try: all C, then the multiples of the copy
    width from 128 down (the byte path takes all C only)."""
    if c % 4:
        return (c,)
    unit = 16 if c % 16 == 0 else 4
    return (c,) + tuple(k for k in range(min(c - 1, 128) // unit * unit, 0,
                                         -unit))


@functools.lru_cache(maxsize=256)
def dma_plan(batch: int, c: int, o: int, kh: int, kw: int, s: int, oh: int,
             ow: int, limits: SmemLimits, vec16: bool = True) -> DmaPlan:
    """The slab-ring kernel's plan for one conv on a device with
    ``limits``. The tile width is the one of :data:`DMA_TILE_WIDTHS` that
    wastes the fewest output pixels at the ragged edges, then whose slab
    re-reads the fewest input pixels per output; then the largest chunk
    (all C first) with the weights resident, else streamed, whose
    :func:`dma_layout` fits two blocks an SM, else one. Each block then
    takes enough tiles that the grid is about two waves of the blocks that
    fit, and at least two stages, so that its ring has a next slab to
    copy."""
    def key(tw):
        th = 64 // tw
        waste = _cdiv(oh, th) * th * _cdiv(ow, tw) * tw
        halo = ((th - 1) * s + kh) * ((tw - 1) * s + kw) / (th * tw)
        return waste, halo

    modes = (True, False) if c % 4 == 0 else (True,)   # bytes: resident
    two_a_sm = limits.per_sm // 2 - _BLOCK_RESERVED
    for budget in (two_a_sm, limits.per_block):
        for tw in sorted(DMA_TILE_WIDTHS, key=key):
            th = 64 // tw
            for res, k in ((m, k) for m in modes for k in _dma_chunks(c)):
                smem = dma_layout(c, kh, kw, s, th, tw, k, res, vec16).smem
                if smem > budget:
                    continue
                per_sm = max(1, min(4, limits.per_sm
                                    // (smem + _BLOCK_RESERVED)))
                tiles_img = _cdiv(oh, th) * _cdiv(ow, tw)
                total = batch * tiles_img * _cdiv(o, 64)
                tpc = max(2 if k == c else 1,
                          total // (2 * limits.sms * per_sm))
                return DmaPlan(th, tw, k, res, min(tpc, tiles_img))
    raise ValueError(f"no slab-ring plan fits shared memory: C={c}, "
                     f"{kh}x{kw}/s{s}")


def _launch_conv_dma(x, w, bias, ep, pads, stride, out,
                     plan: DmaPlan) -> None:
    nb, h, wd, c = x.shape
    o, kh, kw, _ = w.shape
    (pt, _), (pl, _) = pads
    if x.data_ptr() % 4 or w.data_ptr() % 4:
        raise ValueError("the dma conv copies 4-byte words: x and w must be "
                         "4-byte aligned")
    lay = dma_layout(c, kh, kw, stride, plan.tile_h, plan.tile_w, plan.ck,
                     plan.resident, _aligned16(x))
    cuda_build.check(cuda_build.load_library().tat_conv_int8_dma(
        _ptr(x), _ptr(w), _ptr(bias), _ptr(ep.cs), _ptr(out), nb, h, wd, c,
        o, kh, kw, stride, pt, pl, out.shape[1], out.shape[2],
        _kernel_act(ep.act), ep.inv_out, ep.alpha, plan.tile_h, plan.tile_w,
        plan.ck, int(plan.resident), plan.tiles_per_block,
        *dataclasses.astuple(lay), _stream(out.device)),
        "tat_conv_int8_dma")


def matmul_int8_fused_multi(
    xs: Sequence[torch.Tensor], ws: Sequence[torch.Tensor],
    bias: Optional[torch.Tensor], me: MultiEpilogue,
    residual: Optional[torch.Tensor] = None, res_scale: float = 1.0,
) -> torch.Tensor:
    """The fused lowering of CONCAT -> 1x1 CONV [-> ADD]: parts x_i
    [M, K_i] int8 and w_i [N, K_i] int8 (each may be a view whose rows
    are strided, e.g. a column slice of the conv's [N, sum K_i] weight;
    the last stride must be 1), bias [N] int32 in units of
    ``me.bias_scale * w_scale``, residual [M, N] int8 -> int8 [M, N]."""
    n_parts = len(xs)
    if not 1 <= n_parts <= MAX_PARTS or len(ws) != n_parts \
            or len(me.part_scales) != n_parts:
        raise ValueError(f"1..{MAX_PARTS} parts with one weight and one "
                         f"scale each, got {n_parts}, {len(ws)}, "
                         f"{len(me.part_scales)}")
    m = xs[0].shape[0]
    n = ws[0].shape[0]
    dev = xs[0].device
    for x, w in zip(xs, ws):
        if x.dim() != 2 or w.dim() != 2 or x.shape[0] != m \
                or w.shape[0] != n or x.shape[1] != w.shape[1]:
            raise ValueError(f"part shapes {tuple(x.shape)} @ "
                             f"{tuple(w.shape)}^T, expected [{m}, K] @ "
                             f"[{n}, K]^T")
        if x.device != dev:
            raise ValueError(f"operands on several devices: {x.device}, "
                             f"{dev}")
        _check_operands(x, w, bias, me.ep, n, contiguous=False)
    _check_residual(residual, (m, n), me.ep.act, dev)
    if dev.type == "cpu":
        return matmul_int8_fused_multi_plain(xs, ws, bias, me, residual,
                                             res_scale)
    out = torch.empty((m, n), dtype=torch.int8, device=dev)
    if m > 0:
        _launch_multi(xs, ws, bias, me, residual, res_scale, out)
        launches["matmul_int8_fused_multi"] += 1
    return out


def _launch_multi(xs, ws, bias, me, residual, res_scale, out) -> None:
    for t in list(xs) + list(ws):
        if t.shape[1] > 1 and t.stride(1) != 1:
            raise ValueError("CUDA kernel operands need unit inner stride")
    ptrs = ctypes.c_void_p * MAX_PARTS
    longs = ctypes.c_longlong * MAX_PARTS
    ints = ctypes.c_int * MAX_PARTS
    floats = ctypes.c_float * MAX_PARTS
    m, n = out.shape
    cuda_build.check(cuda_build.load_library().tat_mm_multi_int8_fused(
        len(xs), ptrs(*(x.data_ptr() for x in xs)),
        longs(*(x.stride(0) for x in xs)),
        ptrs(*(w.data_ptr() for w in ws)), ints(*(w.stride(0) for w in ws)),
        ints(*(x.shape[1] for x in xs)), floats(*me.part_scales),
        int(me.same_scale), _ptr(bias), me.bias_scale, _ptr(me.ep.cs),
        _ptr(residual), _ptr(out), m, n, _kernel_act(me.ep.act),
        me.ep.inv_out, me.ep.alpha, _f32(res_scale), _stream(out.device)),
        "tat_mm_multi_int8_fused")


@functools.lru_cache(maxsize=256)
def bneck_tile_rows(batch: int, h: int, w: int, c: int, cm: int, o: int,
                    k: int) -> int:
    """Output rows per block of the bottleneck kernel: the height (at most
    16, the halo'd intermediate within 96 KB) whose grid has the fewest
    dp4a tile steps per block slot. The grid is batch x row tiles x
    64-channel output tiles, 264 blocks run at once (two per SM of an
    H100), and a block runs its 1x1 tiles (halo rows included) and its
    KxK tiles in turn. At the real yolov5n's shapes the model's
    height ran within 10% of the fastest measured in 7 of 8 cases
    (PERF.md)."""
    def cdiv(a, b):
        return -(-a // b)

    def cost(th):
        blocks = batch * cdiv(h, th) * cdiv(o, 64)
        stage1 = (cdiv(min(h, th + k - 1) * w, 64) * cdiv(cm, 64)
                  * cdiv(c, 32))
        stage2 = cdiv(th * w, 64) * cdiv(k * k * cm, 32)
        return cdiv(blocks, 264) * (stage1 + stage2), -th

    fits = [th for th in range(1, min(h, 16) + 1)
            if (th + k - 1) * w * cm <= 96 * 1024]
    return min(fits, key=cost) if fits else 1


def bottleneck_int8_fused(
    x: torch.Tensor, w1: torch.Tensor, b1: Optional[torch.Tensor],
    ep1: Epilogue, w2: torch.Tensor, b2: Optional[torch.Tensor],
    ep2: Epilogue, shortcut: bool = False, res_scale: float = 1.0,
) -> torch.Tensor:
    """``requant(act2(convKxK(requant(act1(x @ w1^T)))) [+ x])`` with the
    intermediate on chip: x NHWC [N, H, W, C] int8, w1 [CM, C], w2 OHWI
    [O, K, K, CM] (K odd, stride 1, SAME padding) -> int8 [N, H, W, O].
    ``shortcut`` adds x itself (needs C == O) with ``res_scale``."""
    nb, h, wd, c = x.shape
    cm, c1 = w1.shape
    o, k, k2, cm2 = w2.shape
    if c1 != c or cm2 != cm or k != k2 or k % 2 == 0:
        raise ValueError(f"bottleneck shapes: x {tuple(x.shape)}, w1 "
                         f"{tuple(w1.shape)}, w2 {tuple(w2.shape)}")
    dev = _check_operands(x, w1, b1, ep1, cm)
    _check_operands(x, w2, b2, ep2, o)
    if shortcut:
        _check_residual(x, (nb, h, wd, o), ep2.act, dev)
    if dev.type == "cpu":
        return bottleneck_int8_fused_plain(x, w1, b1, ep1, w2, b2, ep2,
                                           shortcut, res_scale)
    out = torch.empty((nb, h, wd, o), dtype=torch.int8, device=dev)
    if out.numel() > 0:
        _launch_bneck(x, w1, b1, ep1, w2, b2, ep2, shortcut, res_scale, out,
                      bneck_tile_rows(nb, h, wd, c, cm, o, k))
        launches["bottleneck_int8_fused"] += 1
    return out


def _launch_bneck(x, w1, b1, ep1, w2, b2, ep2, shortcut, res_scale, out,
                  tile_rows) -> None:
    nb, h, wd, c = x.shape
    o, k, _, cm = w2.shape
    cuda_build.check(cuda_build.load_library().tat_bneck_int8_fused(
        _ptr(x), _ptr(w1), _ptr(b1), _ptr(ep1.cs), _ptr(w2), _ptr(b2),
        _ptr(ep2.cs), _ptr(out), nb, h, wd, c, cm, o, k, tile_rows,
        _kernel_act(ep1.act), ep1.inv_out, ep1.alpha,
        _kernel_act(ep2.act), ep2.inv_out, ep2.alpha,
        int(shortcut), _f32(res_scale), _stream(out.device)),
        "tat_bneck_int8_fused")


def sppf_int8_fused(x: torch.Tensor, w: torch.Tensor,
                    bias: Optional[torch.Tensor], ep: Epilogue,
                    k: int) -> torch.Tensor:
    """SPPF tail in one kernel: x NHWC [N, H, W, C] int8, three chained
    ``k``x``k``/1 maxpools (padding -128), then the 1x1 conv w
    [O, 4C] over ``concat(x, m1, m2, m3)`` and the epilogue -> int8
    [N, H, W, O]."""
    nb, h, wd, c = x.shape
    o, c4 = w.shape
    if c4 != 4 * c or k % 2 == 0:
        raise ValueError(f"SPPF shapes: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, k {k}")
    dev = _check_operands(x, w, bias, ep, o)
    if dev.type == "cpu":
        return sppf_int8_fused_plain(x, w, bias, ep, k)
    out = torch.empty((nb, h, wd, o), dtype=torch.int8, device=dev)
    if out.numel() > 0:
        _launch_sppf(x, w, bias, ep, k, out)
        launches["sppf_int8_fused"] += 1
    return out


def _launch_sppf(x, w, bias, ep, k, out) -> None:
    nb, h, wd, c = x.shape
    cuda_build.check(cuda_build.load_library().tat_sppf_int8_fused(
        _ptr(x), _ptr(w), _ptr(bias), _ptr(ep.cs), _ptr(out),
        nb, h, wd, c, out.shape[3], k, _kernel_act(ep.act), ep.inv_out,
        ep.alpha, _stream(out.device)), "tat_sppf_int8_fused")


def depthwise_conv2d_int8_fused(
    x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
    ep: Epilogue, out_hw: Tuple[int, int],
    pads: Tuple[Tuple[int, int], Tuple[int, int]],
) -> torch.Tensor:
    """Stride-1 int8 depthwise conv with the epilogue: x NHWC
    [N, H, W, C] int8, w [KH, KW, C] int8 (any KH x KW), bias [C] int32
    -> int8 [N, OH, OW, C]. ``out_hw`` is the declared output size; only
    pt/pl of ``pads`` position the window, and taps outside the image
    read zero."""
    nb, h, wd, c = x.shape
    if w.dim() != 3 or w.shape[2] != c:
        raise ValueError(f"depthwise weights must be [KH, KW, {c}], got "
                         f"{tuple(w.shape)}")
    dev = _check_operands(x, w, bias, ep, c)
    if dev.type == "cpu":
        return depthwise_conv2d_int8_fused_plain(x, w, bias, ep, out_hw,
                                                 pads)
    out = torch.empty((nb,) + tuple(out_hw) + (c,), dtype=torch.int8,
                      device=dev)
    if out.numel() > 0:
        _launch_dw(x, w, bias, ep, pads, out)
        launches["depthwise_conv2d_int8_fused"] += 1
    return out


def _launch_dw(x, w, bias, ep, pads, out) -> None:
    nb, h, wd, c = x.shape
    kh, kw, _ = w.shape
    (pt, _), (pl, _) = pads
    cuda_build.check(cuda_build.load_library().tat_dw_int8_fused(
        _ptr(x), _ptr(w), _ptr(bias), _ptr(ep.cs), _ptr(out), nb, h, wd, c,
        kh, kw, pt, pl, out.shape[1], out.shape[2], _kernel_act(ep.act),
        ep.inv_out, ep.alpha, _stream(out.device)), "tat_dw_int8_fused")


def conv2d_int8_fused(
    x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
    ep: Epilogue, out_hw: Tuple[int, int], stride: Tuple[int, int],
    dilation: Tuple[int, int],
    pads: Tuple[Tuple[int, int], Tuple[int, int]],
    plain: bool = False,
    residual: Optional[torch.Tensor] = None, res_scale: float = 1.0,
) -> torch.Tensor:
    """Route an int8 conv to its fused kernel: 1x1 stride-1 unpadded ->
    :func:`matmul_int8_fused`; everything else (any square stride, the
    thin-channel stem included) -> :func:`conv2d_int8_halo_fused`.
    ``residual`` [N, OH, OW, O] joins the epilogue.

    ``plain=True`` takes the plain versions on any device: for checking
    the kernels against them, never on the serving path."""
    n, h, wd, c = x.shape
    o, kh, kw, _ = w.shape
    if dilation != (1, 1):
        raise ValueError("fused kernels support dilation 1 only")
    if kh == kw == 1 and stride == (1, 1) and pads == ((0, 0), (0, 0)):
        mm = matmul_int8_fused_plain if plain else matmul_int8_fused
        res = residual.reshape(n * h * wd, o) if residual is not None \
            else None
        out = mm(x.reshape(n * h * wd, c), w.reshape(o, c), bias, ep, res,
                 res_scale)
        return out.reshape(n, h, wd, o)
    if stride[0] != stride[1]:
        raise ValueError("fused conv needs square stride")
    conv = conv2d_int8_halo_fused_plain if plain else conv2d_int8_halo_fused
    return conv(x, w, bias, ep, out_hw, pads, stride[0], residual, res_scale)
