"""Serving-tier fused int8 convs: conv/matmul with the whole post-conv
chain (bias + per-channel scale + activation [+ residual] + requantize)
run before the single int8 write. Port of
``thingino_accel_tpu.ops.fused_kernels`` for the planned serving tier:

- :func:`matmul_int8_fused` (1x1 convs, #1) and
  :func:`matmul_int8_fused_multi` (a 1x1 conv over a CONCAT that is never
  materialized, #3): one tensor-core kernel, CUDA
  ``csrc/mm_int8_fused_mma.cu`` (``mma.sync`` from a ``cp.async`` ring
  with resident weights, the serving epilogue of
  ``csrc/epilogue_policy.cuh``), planned by :func:`mm_plan`;
- :func:`conv2d_int8_halo_fused` (KxK convs at any square stride, the
  thin-channel stems included; #2, and with ``pipeline="dma"`` #5, the
  JAX ``conv2d_int8_folded(pipeline="dma")``): one tensor-core kernel,
  CUDA ``csrc/conv_int8_fused_mma.cu`` on the implicit-GEMM core of
  ``csrc/conv_mma_core.cuh`` (``mma.sync`` from a ``cp.async`` slab ring,
  or its im2col mode), planned by :func:`conv_plan`, the planner the
  exact tier's #10/#11 share;
- :func:`bottleneck_int8_fused` (the C3 bottleneck, 1x1 -> KxK/1 [+x]),
  CUDA ``csrc/bneck_int8_fused.cu`` (both stages on the tensor cores, m in
  shared memory), planned by :func:`bneck_plan`;
- :func:`sppf_int8_fused` (three chained maxpools + 4-part 1x1), CUDA
  ``csrc/sppf_int8_fused.cu`` (the pool pyramid in shared memory, the
  product on the tensor cores), planned by :func:`sppf_plan`;
- :func:`depthwise_conv2d_int8_fused` (stride-1 depthwise convs), CUDA
  kernel ``csrc/dw_int8_fused.cu`` (a block's halo tile in shared memory
  through ``cp.async``, a sliding window of taps in registers), planned by
  :func:`dw_plan`;
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

The JAX serving modes: every kernel's epilogue takes the act
``SILU_FAST`` (the Pade sigmoid :func:`sigmoid_fast`, which the executor
picks for SILU under ``TAT_FAST_SILU``), and the wrappers JAX gives a
``compute`` argument (#1-#6) take one: ``"int8"`` (the s8 tensor-core
product, int32 sums) or ``"bf16"`` (the same int8 values through the bf16
tensor-core product into f32 sums, the epilogue from ``(acc + f32(bias))
* cs``: equal to int8 while every partial sum stays below 2^24 in
magnitude); None reads ``TAT_SERVING_COMPUTE`` (:func:`compute_mode`).
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
from thingino_accel_tpu_torch.utils import config

# SILU_FAST: the Pade sigmoid of the JAX ``_sigmoid_fast``; as in JAX the
# executor selects it for SILU only under TAT_FAST_SILU
ACTS = ("NONE", "RELU", "LEAKY_RELU", "SILU", "SILU_FAST")
_ACT_CODE = {a: i for i, a in enumerate(ACTS)}   # tat::Act in epilogue.cuh
_LINEAR = ("NONE", "RELU", "LEAKY_RELU")
MAX_PARTS = 4   # parts of matmul_int8_fused_multi: SPPF's concat has 4
COMPUTES = ("int8", "bf16")
_COMPUTE_CODE = {c: i for i, c in enumerate(COMPUTES)}   # tat::Compute


def compute_mode(compute: Optional[str]) -> str:
    """The serving kernels' product, as the JAX ``_compute_mode``:
    ``compute`` itself, or ``TAT_SERVING_COMPUTE`` where it is None;
    anything but ``"int8"`` or ``"bf16"`` fails as JAX's assert does."""
    if compute is None:
        compute = config.get("TAT_SERVING_COMPUTE")
    if compute not in COMPUTES:
        raise AssertionError(compute)
    return compute


def _kernel_act(act: str) -> int:
    """``tat::Act`` of a kernel's epilogue (SILU_FAST included)."""
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
# the TPU kernels a KxK conv call stands for: #2 (the JAX "blockspec"
# call) or #5 (the "dma" call); one kernel on the card
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
                   res_scale: float = 1.0,
                   compute: str = "int8") -> torch.Tensor:
    """Accumulator [..., N] -> int8 (the JAX ``_epilogue``). int8: the
    int32 sums + bias (int32), -> f32, x cs; bf16: the sums as f32 (an
    int32 ``acc`` rounded to f32 once), + f32(bias), x cs, as the f32
    branch. Then :func:`act_requant_plain`."""
    if compute == "bf16":
        pre = acc.to(torch.float32)
        if bias is not None:
            pre = pre + bias.to(torch.float32)
        return act_requant_plain(pre * ep.cs, ep, residual, res_scale)
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
                            res_scale: float = 1.0,
                            compute: str = "int8") -> torch.Tensor:
    """``x [M, K] int8 @ w [N, K]^T`` [+ residual [M, N]] -> int8 [M, N];
    ``compute`` the epilogue's branch (:func:`epilogue_plain`): the sums
    are exact either way."""
    return epilogue_plain(_mm_acc(x, w), bias, ep, residual, res_scale,
                          compute)


def conv2d_int8_halo_fused_plain(
    x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
    ep: Epilogue, out_hw: Tuple[int, int],
    pads: Tuple[Tuple[int, int], Tuple[int, int]], stride: int = 1,
    residual: Optional[torch.Tensor] = None, res_scale: float = 1.0,
    compute: str = "int8",
) -> torch.Tensor:
    """NHWC int8 ``x`` (*) OHWI int8 ``w`` at square ``stride`` with zero
    padding ``pads`` [+ residual [N, OH, OW, O]] -> int8 NHWC
    [N, OH, OW, O]; ``compute`` the epilogue's branch."""
    (pt, pb), (pl, pr) = pads
    oh, ow = out_hw
    xd = F.pad(x.permute(0, 3, 1, 2).to(torch.float64), (pl, pr, pt, pb))
    acc = F.conv2d(xd, w.permute(0, 3, 1, 2).to(torch.float64),
                   stride=stride)[:, :, :oh, :ow]
    acc = acc.permute(0, 2, 3, 1).to(torch.int32)
    return epilogue_plain(acc, bias, ep, residual, res_scale, compute)


def matmul_int8_fused_multi_plain(
    xs: Sequence[torch.Tensor], ws: Sequence[torch.Tensor],
    bias: Optional[torch.Tensor], me: MultiEpilogue,
    residual: Optional[torch.Tensor] = None, res_scale: float = 1.0,
    compute: str = "int8",
) -> torch.Tensor:
    """``sum_i x_i [M, K_i] @ w_i [N, K_i]^T`` -> int8 [M, N]. Equal
    scales: an int32 sum (bf16: each part's sum as f32, added in f32 in
    part order, as ``_mm_multi_kernel``'s f32 dots) and the ordinary
    epilogue. Otherwise, as ``_mm_multi_kernel``: ``dot_i * s_i`` summed
    in f32 in part order, ``+ bias * bias_scale``, ``x cs``, then the
    activation tail."""
    accs = [_mm_acc(x, w) for x, w in zip(xs, ws)]
    if me.same_scale:
        acc = accs[0].to(torch.float32) if compute == "bf16" else accs[0]
        for a in accs[1:]:
            acc = acc + (a.to(torch.float32) if compute == "bf16" else a)
        return epilogue_plain(acc, bias, me.ep, residual, res_scale, compute)
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
    compute: str = "int8",
) -> torch.Tensor:
    """The C3 bottleneck: ``m = 1x1(x)`` (x NHWC [N, H, W, C], w1
    [CM, C]), then the KxK/1 conv over m with zero (quantized zero)
    padding (w2 OHWI [O, K, K, CM]) [+ x] -> int8 [N, H, W, O]; both
    epilogues in ``compute``'s branch."""
    n, h, wd, c = x.shape
    k = w2.shape[1]
    hh = (k - 1) // 2
    m = matmul_int8_fused_plain(x.reshape(n * h * wd, c), w1, b1, ep1,
                                compute=compute)
    return conv2d_int8_halo_fused_plain(
        m.reshape(n, h, wd, -1), w2, b2, ep2, (h, wd), ((hh, hh), (hh, hh)),
        1, residual=x if shortcut else None, res_scale=res_scale,
        compute=compute)


def sppf_int8_fused_plain(x: torch.Tensor, w: torch.Tensor,
                          bias: Optional[torch.Tensor], ep: Epilogue,
                          k: int, compute: str = "int8") -> torch.Tensor:
    """SPPF: ``m_{i+1} = maxpool_kxk/1(m_i)`` (padding -128), then the
    1x1 conv ``w [O, 4C]`` over ``concat(x, m1, m2, m3)`` -> int8
    [N, H, W, O]. bf16: the four levels' sums as f32, added in f32 in
    level order, as ``_sppf_kernel``'s f32 part dots."""
    n, h, wd, c = x.shape
    p = (k - 1) // 2
    levels = [x]
    for _ in range(3):
        levels.append(R.maxpool(levels[-1], (k, k), (1, 1), (h, wd),
                                ((p, p), (p, p))))
    if compute == "bf16":
        me = MultiEpilogue(ep=ep, same_scale=True, part_scales=(1.0,) * 4,
                           bias_scale=1.0)
        return matmul_int8_fused_multi_plain(
            [lv.reshape(n * h * wd, c) for lv in levels],
            [w[:, i * c:(i + 1) * c] for i in range(4)], bias, me,
            compute=compute).reshape(n, h, wd, -1)
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
                      res_scale: float = 1.0,
                      compute: Optional[str] = None) -> torch.Tensor:
    """``int8 = requant(act((x @ w^T + b) * cs) [+ r * res_scale])``:
    x [M, K] int8, w [N, K] int8, bias [N] int32 or None, residual
    [M, N] int8 or None -> int8 [M, N]; ``compute`` the product
    (:func:`compute_mode`). On a CUDA tensor: the tensor-core 1x1 GEMM
    ``tat_mm_int8_fused_mma`` (``csrc/mm_int8_fused_mma.cu``, one part)
    with :func:`gemm_plan`; on the CPU the plain version."""
    compute = compute_mode(compute)
    m, k = x.shape
    n, k_w = w.shape
    if k_w != k:
        raise ValueError(f"K mismatch: x {tuple(x.shape)}, w {tuple(w.shape)}")
    dev = _check_operands(x, w, bias, ep, n)
    _check_residual(residual, (m, n), ep.act, dev)
    if dev.type == "cpu":
        return matmul_int8_fused_plain(x, w, bias, ep, residual, res_scale,
                                       compute)
    out = torch.empty((m, n), dtype=torch.int8, device=dev)
    if m > 0:
        _launch_mm(x, w, bias, ep, residual, res_scale, out, compute)
        launches["matmul_int8_fused"] += 1
    return out


def _launch_mm(x, w, bias, ep, residual, res_scale, out,
               compute: str = "int8") -> None:
    """#1 on the card: the one-part case of ``tat_mm_int8_fused_mma``."""
    _launch_gemm([x], [w], bias, ep, (1.0,), True, 1.0, residual, res_scale,
                 out, compute=compute)


def conv2d_int8_halo_fused(
    x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
    ep: Epilogue, out_hw: Tuple[int, int],
    pads: Tuple[Tuple[int, int], Tuple[int, int]], stride: int = 1,
    residual: Optional[torch.Tensor] = None, res_scale: float = 1.0,
    pipeline: str = "blockspec", compute: Optional[str] = None,
) -> torch.Tensor:
    """KxK int8 conv at square ``stride``: x NHWC [N, H, W, C] int8,
    w OHWI [O, KH, KW, C] int8 [+ residual [N, OH, OW, O]] -> int8
    [N, OH, OW, O]. ``out_hw`` is the graph's declared output size;
    ``pads`` ((pt, pb), (pl, pr)) may be asymmetric. Only pt/pl position
    the window; rows and columns past the input are zero.

    ``pipeline`` names the TPU kernel a call stands for: ``"blockspec"``
    #2, ``"dma"`` #5 (no residual and no bf16 ``compute``, as in JAX).
    Both compute the same function, and on a CUDA tensor both launch the
    one tensor-core kernel ``tat_conv_int8_fused_mma`` with
    :func:`serving_plan` (each counted under its own name in
    :data:`launches`); on the CPU both take the plain version."""
    if pipeline not in PIPELINES:
        raise ValueError(f"unknown pipeline {pipeline!r}; one of {PIPELINES}")
    compute = compute_mode(compute)
    if pipeline == "dma" and compute == "bf16":
        raise ValueError("bf16 compute not supported on the dma "
                         "pipeline variant")
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
                                            stride, residual, res_scale,
                                            compute)
    out = torch.empty((nb, oh, ow, o), dtype=torch.int8, device=dev)
    if out.numel() == 0:
        return out
    _launch_conv(x, w, bias, ep, pads, stride, residual, res_scale, out,
                 serving_plan(x, w, out_hw, stride), compute)
    launches["conv2d_int8_halo_dma" if pipeline == "dma"
             else "conv2d_int8_halo_fused"] += 1
    return out


# ---------------------------------------------------------------------------
# The tensor-core KxK conv's plan: one planner for the serving tier's #2 and
# #5 (``tat_conv_int8_fused_mma``) and the exact tier's #10 and #11
# (``tat_conv_int8_requant_mma``), whose kernels are the one core of
# ``csrc/conv_mma_core.cuh`` under two epilogue policies
# ---------------------------------------------------------------------------

_BLOCK_RESERVED = 1024   # shared memory the runtime keeps for each block


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


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """The block of the KxK kernel: ``mode`` "slab" or "im2col";
    ``tile_h`` x ``tile_w`` output pixels a tile; ``bn`` output channels;
    the input channels walked in chunks of ``ck``; ``resident``: the
    weights of all C loaded once for the whole run (always where ``ck ==
    C``; in slab mode also beside a chunked slab), else each stage carries
    its chunk's slice; ``tiles_per_block`` consecutive tiles of one image
    (row-major)."""

    mode: str
    tile_h: int
    tile_w: int
    bn: int
    ck: int
    resident: bool
    tiles_per_block: int


# (tile_h, tile_w): 128 or 64 pixels (2 or 1 m16 tiles a warp), tile_w a
# power of two; bn 64 or 32 (4 or 2 n8 tiles a warp); 8 warps a block
CONV_TILES = ((8, 16), (16, 8), (4, 32), (8, 8), (4, 16), (2, 32))
CONV_BNS = (64, 32)
# the serving epilogue's kernels also take bn 16 (one n8 tile a warp),
# offered where O <= 16 (the real yolov5n's stem), so no half-empty block
SERVING_BN16_MAX_O = 16
CONV_THREADS = 256
# blocks an SM the registers allow at most (__launch_bounds__(256, n): 128
# registers a thread in slab mode, 85 in im2col mode)
CONV_MAX_BLOCKS = {"slab": 2, "im2col": 3}
_MODE_CODE = {"slab": 0, "im2col": 1}
_OUT_PAD = 16         # bytes after each staged output pixel (kOutPad)


def serving_bns(o: int) -> Tuple[int, ...]:
    """The channel blocks the serving kernels offer for ``o`` channels."""
    return CONV_BNS + ((16,) if o <= SERVING_BN16_MAX_O else ())


def _slab_hw(tile_h: int, tile_w: int, kh: int, kw: int, stride, dilation
             ) -> Tuple[int, int]:
    return ((tile_h - 1) * stride[0] + (kh - 1) * dilation[0] + 1,
            (tile_w - 1) * stride[1] + (kw - 1) * dilation[1] + 1)


@dataclasses.dataclass(frozen=True)
class ConvLayout:
    """One block's dynamic shared memory in the KxK kernel (``conv_layout``
    of ``csrc/conv_mma_core.cuh``), byte offsets from its start. Slab mode:
    two ring stages of ``stage_bytes`` (the slab, ``slab_bytes`` at ck + 16
    bytes a pixel, then the chunk's weights unless resident), the resident
    weights at ``w_off`` (KH KW C + 16 bytes a channel), the output tile at
    ``out_off`` (bn + 16 bytes a pixel; the residual lands there too).
    im2col mode: the slab (ck bytes a pixel), the A tile at ``a_off`` and
    the weights at ``w_off`` (kc + 16 bytes a row, kc = KH KW ck rounded up
    to 32), three int32 k tables of kc entries at ``ktab_off``, the output
    tile. Then the epilogue policy's table (the exact policy's 256 bytes,
    :data:`EXACT_TABLE_BYTES`; the serving policy has none). The kernel
    has no static shared memory."""
    slab_bytes: int
    stage_bytes: int
    a_off: int
    w_off: int
    ktab_off: int
    out_off: int
    smem: int


def conv_layout(mode: str, c: int, kh: int, kw: int, stride, dilation,
                tile_h: int, tile_w: int, bn: int, ck: int,
                resident: bool, table: int = 0) -> ConvLayout:
    slab_h, slab_w = _slab_hw(tile_h, tile_w, kh, kw, stride, dilation)
    tp = tile_h * tile_w
    if mode == "slab":
        wpitch = kh * kw * (c if resident else ck) + 16
        slab = slab_h * slab_w * (ck + 16)
        stage = slab + (0 if resident else bn * wpitch)
        w_off = 2 * stage
        out_off = w_off + (bn * wpitch if resident else 0)
        a_off = ktab_off = 0
    else:
        kc = _round_up(kh * kw * ck, 32)
        slab = stage = _round_up(slab_h * slab_w * ck, 16)
        a_off = slab
        w_off = a_off + tp * (kc + 16)
        ktab_off = w_off + bn * (kc + 16)
        out_off = ktab_off + 12 * kc
    return ConvLayout(slab, stage, a_off, w_off, ktab_off, out_off,
                      out_off + tp * (bn + _OUT_PAD) + table)


def conv_smem(mode: str, c: int, kh: int, kw: int, stride, dilation,
              tile_h: int, tile_w: int, bn: int, ck: int,
              resident: bool, table: int = 0) -> int:
    """Shared memory of a block in bytes (:func:`conv_layout`'s total)."""
    return conv_layout(mode, c, kh, kw, stride, dilation, tile_h, tile_w,
                       bn, ck, resident, table).smem


def conv_chunks(mode: str, c: int) -> Tuple[Tuple[int, bool], ...]:
    """The (chunk width, resident weights) a mode takes, in the order a
    plan tries them: all C; then, in slab mode, the multiples of 32 that
    divide C, widest first, beside resident weights and then with the
    weights streamed; in im2col mode C / 2, C / 4, ... (rounded up; the
    last chunk may be ragged), streamed."""
    if mode == "slab":
        widths = [k for k in range(c - 32, 31, -32) if c % k == 0]
        return ((c, True),) + tuple((k, True) for k in widths) + tuple(
            (k, False) for k in widths)
    chunks, k = [(c, True)], c
    while k > 1:
        k = _cdiv(k, 2)
        chunks.append((k, False))
    return tuple(chunks)


@functools.lru_cache(maxsize=512)
def conv_plans(batch: int, oh: int, ow: int, c: int, o: int, kh: int,
               kw: int, stride: Tuple[int, int], dilation: Tuple[int, int],
               mode: str, limits: SmemLimits,
               bns: Tuple[int, ...] = CONV_BNS, table: int = 0
               ) -> Tuple[ConvPlan, ...]:
    """Every tile and channel block (of ``bns``) the kernel can run in
    ``mode`` within the shared memory (``table``: the epilogue policy's
    table bytes), each with its widest chunk that fits
    and its modelled run of tiles, in the order :func:`conv_plan` prefers
    them: the fewest products issued (ragged tiles and channel blocks count
    whole), C in one chunk, resident weights, the largest block, the least
    halo, the widest tile."""
    def first_fit(th, tw, bn):
        for ck, resident in conv_chunks(mode, c):
            smem = conv_smem(mode, c, kh, kw, stride, dilation, th, tw, bn,
                             ck, resident, table)
            if smem <= limits.per_block:
                return ck, resident, smem
        return None

    def key(tb):
        (th, tw), bn, (ck, resident, _) = tb
        issued = (_cdiv(oh, th) * th * _cdiv(ow, tw) * tw
                  * _cdiv(o, bn) * bn)
        slab_h, slab_w = _slab_hw(th, tw, kh, kw, stride, dilation)
        return (issued, ck < c, not resident, -th * tw * bn,
                slab_h * slab_w / (th * tw), -tw)

    fits = [(t, bn, fit) for t in CONV_TILES for bn in bns
            for fit in [first_fit(*t, bn)] if fit is not None]
    plans = []
    for (th, tw), bn, (ck, resident, smem) in sorted(fits, key=key):
        tiles_img = _cdiv(oh, th) * _cdiv(ow, tw)
        plans.append(ConvPlan(mode, th, tw, bn, ck, resident,
                              run_of_tiles(batch, tiles_img, _cdiv(o, bn),
                                           smem, limits, CONV_THREADS,
                                           CONV_MAX_BLOCKS[mode])))
    return tuple(plans)


def conv_mode(x: torch.Tensor, w: torch.Tensor) -> str:
    """"slab" where the ring's 16-byte copies can run (C % 32 == 0, x and
    w 16-byte aligned), else "im2col"."""
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    return "slab" if x.shape[3] % 32 == 0 and aligned else "im2col"


def conv_plan(batch: int, oh: int, ow: int, c: int, o: int, kh: int, kw: int,
              stride: Tuple[int, int], dilation: Tuple[int, int], mode: str,
              limits: SmemLimits, bns: Tuple[int, ...] = CONV_BNS,
              table: int = 0) -> ConvPlan:
    """The first of :func:`conv_plans` in ``mode``; a slab-mode conv no
    slab fits takes im2col mode. ValueError if nothing fits."""
    args = (batch, oh, ow, c, o, kh, kw, tuple(stride), tuple(dilation))
    plans = conv_plans(*args, mode, limits, tuple(bns), table)
    if not plans and mode == "slab":
        plans = conv_plans(*args, "im2col", limits, tuple(bns), table)
    if not plans:
        raise ValueError(f"no block of the KxK conv kernel fits C={c} "
                         f"{kh}x{kw} in {limits.per_block} bytes of shared "
                         "memory")
    return plans[0]


def serving_plan(x: torch.Tensor, w: torch.Tensor, out_hw, stride: int
                 ) -> ConvPlan:
    """The plan :func:`conv2d_int8_halo_fused` launches on the card."""
    nb, _, _, c = x.shape
    o, kh, kw, _ = w.shape
    return conv_plan(nb, out_hw[0], out_hw[1], c, o, kh, kw,
                     (stride, stride), (1, 1), conv_mode(x, w),
                     smem_limits(x.device), serving_bns(o))


def _conv_args(x, w, bias, ep, pads, stride, residual, res_scale, out,
               plan: ConvPlan, compute: str = "int8") -> tuple:
    """The arguments of ``tat_conv_int8_fused_mma`` up to the stream."""
    nb, h, wd, c = x.shape
    o, kh, kw, _ = w.shape
    (pt, _), (pl, _) = pads
    return (_ptr(x), _ptr(w), _ptr(bias), _ptr(ep.cs), _ptr(residual),
            _ptr(out), nb, h, wd, c, o, kh, kw, stride, pt, pl, out.shape[1],
            out.shape[2], _kernel_act(ep.act), ep.inv_out, ep.alpha,
            _f32(res_scale), _MODE_CODE[plan.mode], plan.tile_h, plan.tile_w,
            plan.bn, plan.ck, int(plan.resident), plan.tiles_per_block,
            _COMPUTE_CODE[compute])


def _launch_conv(x, w, bias, ep, pads, stride, residual, res_scale, out,
                 plan: ConvPlan, compute: str = "int8") -> None:
    cuda_build.check(cuda_build.load_library().tat_conv_int8_fused_mma(
        *_conv_args(x, w, bias, ep, pads, stride, residual, res_scale, out,
                    plan, compute), _stream(out.device)),
        "tat_conv_int8_fused_mma")


def conv_occupancy(plan: ConvPlan, c: int, kernel: Tuple[int, int],
                   stride: int, act: str,
                   compute: str = "int8") -> Tuple[int, int]:
    """``(shared memory bytes, blocks an SM holds)`` of the serving KxK
    kernel of ``act`` and ``compute`` with ``plan`` on the current card
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    cuda_build.check(cuda_build.load_library().tat_conv_int8_fused_mma_info(
        _kernel_act(act), _MODE_CODE[plan.mode], c, kernel[0], kernel[1],
        stride, plan.tile_h, plan.tile_w, plan.bn, plan.ck,
        int(plan.resident), _COMPUTE_CODE[compute], ctypes.byref(smem),
        ctypes.byref(blocks)), "tat_conv_int8_fused_mma_info")
    return smem.value, blocks.value


def matmul_int8_fused_multi(
    xs: Sequence[torch.Tensor], ws: Sequence[torch.Tensor],
    bias: Optional[torch.Tensor], me: MultiEpilogue,
    residual: Optional[torch.Tensor] = None, res_scale: float = 1.0,
    compute: Optional[str] = None,
) -> torch.Tensor:
    """The fused lowering of CONCAT -> 1x1 CONV [-> ADD]: parts x_i
    [M, K_i] int8 and w_i [N, K_i] int8 (each may be a view whose rows
    are strided, e.g. a column slice of the conv's [N, sum K_i] weight;
    the last stride must be 1), bias [N] int32 in units of
    ``me.bias_scale * w_scale``, residual [M, N] int8 -> int8 [M, N].
    On a CUDA tensor: the kernel of :func:`matmul_int8_fused`,
    ``tat_mm_int8_fused_mma`` (``csrc/mm_int8_fused_mma.cu``), over the
    parts, its product ``compute`` (:func:`compute_mode`); on the CPU the
    plain version."""
    compute = compute_mode(compute)
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
                                             res_scale, compute)
    out = torch.empty((m, n), dtype=torch.int8, device=dev)
    if m > 0:
        _launch_multi(xs, ws, bias, me, residual, res_scale, out, compute)
        launches["matmul_int8_fused_multi"] += 1
    return out


def _launch_multi(xs, ws, bias, me, residual, res_scale, out,
                  compute: str = "int8") -> None:
    """#3 on the card: ``tat_mm_int8_fused_mma`` over the parts."""
    _launch_gemm(xs, ws, bias, me.ep, me.part_scales, me.same_scale,
                 me.bias_scale, residual, res_scale, out, compute=compute)


# ---------------------------------------------------------------------------
# The tensor-core 1x1 GEMM of #1 and #3 (``tat_mm_int8_fused_mma``,
# ``csrc/mm_int8_fused_mma.cu``): its plan and shared-memory layout
# ---------------------------------------------------------------------------

MM_BMS = (128, 64)        # rows a tile: 2 or 1 m16 tiles a warp
MM_BNS = (128, 64, 32)    # channels a block (8, 4, 2 n8 tiles a warp)
MM_KC_MAX = 128           # K bytes a ring stage at most
MM_STAGES = (4, 3, 2)     # ring depths, deepest first
MM_THREADS = 256
# bytes of a channel's Col in shared memory: ServingEpilogue's bias and cs,
# ExactEpilogue's bias
_MM_COL_BYTES = {False: 8, True: 4}
# the exact epilogue's activation table in shared memory
# (ExactEpilogue::kTableBytes), in the 1x1 GEMM and the KxK core alike
EXACT_TABLE_BYTES = 256


def mm_max_blocks(bm: int, bn: int) -> int:
    """Blocks an SM the registers allow (``mm_min_blocks``): 1 for the
    largest tile (128 x 128), else 2."""
    return 1 if (bm // 64) * (bn // 16) >= 16 else 2


def mm_smem(ks: Sequence[int], bm: int, bn: int, kc: int,
            stages: int, exact: bool = False) -> int:
    """Dynamic shared memory of one block of the 1x1 GEMM in bytes
    (``mm_layout`` of ``csrc/mm_int8_fused_mma.cu``; no static bytes): the
    ring of ``stages`` slots of bm rows at kc + 16 bytes, the resident
    weights (bn rows at Kp + 16 bytes, Kp the sum of the parts' K rounded
    up to 32 each), the staged output tile (bm rows at bn + 16 bytes; the
    residual lands there too), and each channel's bias and cs (``exact``:
    its bias) and its bias x bias_scale; ``exact``: then the activation
    table."""
    kp = sum(_round_up(k, 32) for k in ks)
    return (stages * bm * (kc + 16) + bn * (kp + 16) + bm * (bn + _OUT_PAD)
            + bn * (_MM_COL_BYTES[exact] + 4)
            + (EXACT_TABLE_BYTES if exact else 0))


@dataclasses.dataclass(frozen=True)
class MmPlan:
    """The block of the 1x1 GEMM: ``bm`` rows a tile, ``bn`` output
    channels (their weights resident), ``kc`` K bytes a ring stage, a ring
    of ``stages``, ``tiles_per_block`` consecutive tiles a block."""
    bm: int
    bn: int
    kc: int
    stages: int
    tiles_per_block: int


@functools.lru_cache(maxsize=512)
def mm_plans(m: int, n: int, ks: Tuple[int, ...], same_scale: bool,
             limits: SmemLimits, exact: bool = False
             ) -> Tuple[MmPlan, ...]:
    """Every (bn, bm) the kernel can run within the shared memory, in the
    order :func:`mm_plan` prefers them: the fewest channel blocks (each
    reads x again), then the fewest channels issued, bn 16 offered where
    N <= 16; bm 128 where the tiles fill the SMs and bn < 128 (bm 128 at
    bn 128 holds one block an SM), else 64 (the per-part branch never
    pairs bm 128 with bn 128: its f32 sums would spill);
    each with the deepest ring that keeps its blocks an SM, ``kc`` the
    widest part's K (rounded up to 32, at most 128) and its modelled run
    of tiles (:func:`run_of_tiles`). ``exact``: the exact tier's kernel
    (#9: one part, :func:`mm_smem`'s exact layout)."""
    kc = min(MM_KC_MAX, max(_round_up(k, 32) for k in ks))
    bns = MM_BNS + ((16,) if n <= SERVING_BN16_MAX_O else ())
    bns = sorted(bns, key=lambda bn: (_cdiv(n, bn), _cdiv(n, bn) * bn))
    plans = []
    for bn in bns:
        nbn = _cdiv(n, bn)
        # bm 128 at bn 128 holds one block an SM (mm_max_blocks)
        bms = (MM_BMS if _cdiv(m, 128) * nbn >= limits.sms and bn < 128
               else MM_BMS[::-1])
        for bm in bms:
            if not same_scale and bm == 128 and bn == 128:
                continue
            max_blocks = mm_max_blocks(bm, bn)
            fits = [st for st in MM_STAGES
                    if mm_smem(ks, bm, bn, kc, st, exact) <= limits.per_block]
            if not fits:
                continue
            keep = [st for st in fits
                    if max_blocks * (mm_smem(ks, bm, bn, kc, st, exact)
                                     + _BLOCK_RESERVED) <= limits.per_sm]
            stages = (keep or fits)[0]
            smem = mm_smem(ks, bm, bn, kc, stages, exact)
            plans.append(MmPlan(bm, bn, kc, stages, run_of_tiles(
                1, _cdiv(m, bm), nbn, smem, limits, MM_THREADS, max_blocks)))
    return tuple(plans)


def mm_plan(m: int, n: int, ks: Sequence[int], same_scale: bool,
            limits: SmemLimits, exact: bool = False) -> MmPlan:
    """The first of :func:`mm_plans`; ValueError if no block fits."""
    plans = mm_plans(m, n, tuple(ks), bool(same_scale), limits, exact)
    if not plans:
        raise ValueError(f"no block of the 1x1 GEMM fits K = {tuple(ks)} "
                         f"in {limits.per_block} bytes of shared memory")
    return plans[0]


def gemm_plan(xs: Sequence[torch.Tensor], n: int, same_scale: bool
              ) -> MmPlan:
    """The plan #1 and #3 launch on the card."""
    return mm_plan(xs[0].shape[0], n, [x.shape[1] for x in xs], same_scale,
                   smem_limits(xs[0].device))


def _gemm_args(xs, ws, bias, ep, part_scales, same_scale, bias_scale,
               residual, res_scale, out, plan: MmPlan,
               compute: str = "int8") -> tuple:
    """The arguments of ``tat_mm_int8_fused_mma`` up to the stream."""
    for t in list(xs) + list(ws):
        if t.shape[1] > 1 and t.stride(1) != 1:
            raise ValueError("CUDA kernel operands need unit inner stride")
    ptrs = ctypes.c_void_p * MAX_PARTS
    longs = ctypes.c_longlong * MAX_PARTS
    ints = ctypes.c_int * MAX_PARTS
    floats = ctypes.c_float * MAX_PARTS
    m, n = out.shape
    return (len(xs), ptrs(*(x.data_ptr() for x in xs)),
            longs(*(x.stride(0) for x in xs)),
            ptrs(*(w.data_ptr() for w in ws)),
            ints(*(w.stride(0) for w in ws)), ints(*(x.shape[1] for x in xs)),
            floats(*part_scales), int(same_scale), _ptr(bias),
            _f32(bias_scale), _ptr(ep.cs), _ptr(residual), _ptr(out), m, n,
            _kernel_act(ep.act), ep.inv_out, ep.alpha, _f32(res_scale),
            plan.bm, plan.bn, plan.kc, plan.stages, plan.tiles_per_block,
            _COMPUTE_CODE[compute])


def _launch_gemm(xs, ws, bias, ep, part_scales, same_scale, bias_scale,
                 residual, res_scale, out,
                 plan: Optional[MmPlan] = None, compute: str = "int8") -> None:
    if plan is None:
        plan = gemm_plan(xs, out.shape[1], same_scale)
    cuda_build.check(cuda_build.load_library().tat_mm_int8_fused_mma(
        *_gemm_args(xs, ws, bias, ep, part_scales, same_scale, bias_scale,
                    residual, res_scale, out, plan, compute),
        _stream(out.device)), "tat_mm_int8_fused_mma")


def gemm_occupancy(plan: MmPlan, ks: Sequence[int], same_scale: bool,
                   act: str, compute: str = "int8") -> Tuple[int, int]:
    """``(shared memory bytes, blocks an SM holds)`` of the 1x1 GEMM of
    ``act`` and ``compute`` with ``plan`` on the current card."""
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    cuda_build.check(cuda_build.load_library().tat_mm_int8_fused_mma_info(
        *_gemm_info_args(plan, ks, same_scale, act, compute),
        ctypes.byref(smem), ctypes.byref(blocks)),
        "tat_mm_int8_fused_mma_info")
    return smem.value, blocks.value


def _gemm_info_args(plan: MmPlan, ks: Sequence[int], same_scale: bool,
                    act: str, compute: str = "int8") -> tuple:
    """The arguments of ``tat_mm_int8_fused_mma_info`` up to the outputs."""
    ints = ctypes.c_int * MAX_PARTS
    return (len(ks), ints(*ks), int(same_scale), _kernel_act(act), plan.bm,
            plan.bn, plan.kc, plan.stages, _COMPUTE_CODE[compute])


def bottleneck_int8_fused(
    x: torch.Tensor, w1: torch.Tensor, b1: Optional[torch.Tensor],
    ep1: Epilogue, w2: torch.Tensor, b2: Optional[torch.Tensor],
    ep2: Epilogue, shortcut: bool = False, res_scale: float = 1.0,
    compute: Optional[str] = None,
) -> torch.Tensor:
    """``requant(act2(convKxK(requant(act1(x @ w1^T)))) [+ x])`` with the
    intermediate on chip: x NHWC [N, H, W, C] int8, w1 [CM, C], w2 OHWI
    [O, K, K, CM] (K odd, stride 1, SAME padding) -> int8 [N, H, W, O].
    ``shortcut`` adds x itself (needs C == O) with ``res_scale``; both
    stages' product ``compute`` (:func:`compute_mode`). On a CUDA tensor:
    the tensor-core kernel ``tat_bneck_int8_fused``
    (``csrc/bneck_int8_fused.cu``) with :func:`bneck_plan`; on the CPU the
    plain version."""
    compute = compute_mode(compute)
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
                                           shortcut, res_scale, compute)
    out = torch.empty((nb, h, wd, o), dtype=torch.int8, device=dev)
    if out.numel() > 0:
        _launch_bneck(x, w1, b1, ep1, w2, b2, ep2, shortcut, res_scale, out,
                      bneck_plan(nb, h, wd, c, cm, o, k, smem_limits(dev)),
                      compute)
        launches["bottleneck_int8_fused"] += 1
    return out


def _bneck_args(x, w1, b1, ep1, w2, b2, ep2, shortcut, res_scale, out,
                plan: "BneckPlan", compute: str = "int8") -> tuple:
    """The arguments of ``tat_bneck_int8_fused`` up to the stream."""
    nb, h, wd, c = x.shape
    o, k, _, cm = w2.shape
    return (_ptr(x), _ptr(w1), _ptr(b1), _ptr(ep1.cs), _ptr(w2), _ptr(b2),
            _ptr(ep2.cs), _ptr(out), nb, h, wd, c, cm, o, k,
            _kernel_act(ep1.act), ep1.inv_out, ep1.alpha,
            _kernel_act(ep2.act), ep2.inv_out, ep2.alpha, int(shortcut),
            _f32(res_scale), plan.tile_h, plan.tile_w, plan.bn,
            int(plan.resident), plan.tiles_per_block, _COMPUTE_CODE[compute])


def _launch_bneck(x, w1, b1, ep1, w2, b2, ep2, shortcut, res_scale, out,
                  plan: "BneckPlan", compute: str = "int8") -> None:
    cuda_build.check(cuda_build.load_library().tat_bneck_int8_fused(
        *_bneck_args(x, w1, b1, ep1, w2, b2, ep2, shortcut, res_scale, out,
                     plan, compute), _stream(out.device)),
        "tat_bneck_int8_fused")


def sppf_int8_fused(x: torch.Tensor, w: torch.Tensor,
                    bias: Optional[torch.Tensor], ep: Epilogue,
                    k: int, compute: Optional[str] = None) -> torch.Tensor:
    """SPPF tail in one kernel: x NHWC [N, H, W, C] int8, three chained
    ``k``x``k``/1 maxpools (padding -128), then the 1x1 conv w
    [O, 4C] over ``concat(x, m1, m2, m3)`` and the epilogue -> int8
    [N, H, W, O]; the product ``compute`` (:func:`compute_mode`). On a
    CUDA tensor: the tensor-core kernel ``tat_sppf_int8_fused``
    (``csrc/sppf_int8_fused.cu``) with :func:`sppf_plan`; on the CPU the
    plain version."""
    compute = compute_mode(compute)
    nb, h, wd, c = x.shape
    o, c4 = w.shape
    if c4 != 4 * c or k % 2 == 0:
        raise ValueError(f"SPPF shapes: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, k {k}")
    dev = _check_operands(x, w, bias, ep, o)
    if dev.type == "cpu":
        return sppf_int8_fused_plain(x, w, bias, ep, k, compute)
    out = torch.empty((nb, h, wd, o), dtype=torch.int8, device=dev)
    if out.numel() > 0:
        _launch_sppf(x, w, bias, ep, k, out,
                     sppf_plan(nb, h, wd, c, o, k, smem_limits(dev)), compute)
        launches["sppf_int8_fused"] += 1
    return out


def _sppf_args(x, w, bias, ep, k, out, plan: "SppfPlan",
               compute: str = "int8") -> tuple:
    """The arguments of ``tat_sppf_int8_fused`` up to the stream."""
    nb, h, wd, c = x.shape
    return (_ptr(x), _ptr(w), _ptr(bias), _ptr(ep.cs), _ptr(out), nb, h, wd,
            c, out.shape[3], k, _kernel_act(ep.act), ep.inv_out, ep.alpha,
            plan.bm, plan.bn, plan.ck, plan.tiles_per_block,
            _COMPUTE_CODE[compute])


def _launch_sppf(x, w, bias, ep, k, out, plan: "SppfPlan",
                 compute: str = "int8") -> None:
    cuda_build.check(cuda_build.load_library().tat_sppf_int8_fused(
        *_sppf_args(x, w, bias, ep, k, out, plan, compute),
        _stream(out.device)), "tat_sppf_int8_fused")


# ---------------------------------------------------------------------------
# The fused C3 bottleneck (#6) and SPPF (#4) kernels on the KxK core's
# product and store: their plans and shared-memory layouts (``bneck_layout``
# of ``csrc/bneck_int8_fused.cu``, ``sppf_layout`` of
# ``csrc/sppf_int8_fused.cu``)
# ---------------------------------------------------------------------------

# (TP / 64, BN / 16): the MI m16 x NI n8 tiles a warp both kernels are
# built for (8 warps tiling TP pixels x BN channels 4 x 2; TP 128 with BN
# 128 would hold 64 int32 sums a thread)
FUSED_WARP_TILES = ((1, 2), (2, 2), (1, 4), (2, 4), (1, 8))
FUSED_BNS = (128, 64, 32)
# the cost model's weights, in a sub-core's issue slots: an mma.sync
# m16n8k32 s8, one element of a SILU epilogue (about 40 instructions a
# thread), one 16-byte item of a pool pass, one barrier, a byte of weights
# streamed from L2; a second block an SM hides latency worth this share of
# its issue slots (the bottleneck's plans on an H100, PERF.md)
_MMA_SLOTS = 6.0
_EPI_SLOTS = 1.25
_POOL_SLOTS = 1.5
_BARRIER_SLOTS = 300.0
_L2_BYTE_SLOTS = 1 / 32
_SECOND_BLOCK_GAIN = 0.35


def fused_max_blocks(tp: int, bn: int) -> int:
    """Blocks an SM the registers allow (``__launch_bounds__``): 1 from 32
    int32 sums a thread (MI x NI >= 8), else 2."""
    return 1 if (tp // 64) * (bn // 16) >= 8 else 2


def _fused_cost(tiles: int, oblocks: int, smem: int, max_blocks: int,
                tile_cost, limits: SmemLimits) -> Tuple[float, int, int]:
    """(modelled cost, run of tiles, blocks an SM) of a plan: the waves of
    blocks (by ``max_blocks``, the registers' bound, and the shared
    memory), each block's run of tiles (:func:`run_of_tiles`) at
    ``tile_cost(run)`` a tile and a quarter tile more (its weights and first
    input overlap nothing); blocks that share an SM share its issue slots,
    a second one hiding latency worth :data:`_SECOND_BLOCK_GAIN`."""
    tpb = run_of_tiles(1, tiles, oblocks, smem, limits, CONV_THREADS,
                       max_blocks)
    tile_cost = tile_cost(tpb)
    per_sm = max(1, min(max_blocks,
                        limits.per_sm // (smem + _BLOCK_RESERVED)))
    blocks = _cdiv(tiles, tpb) * oblocks
    gain = 1 + _SECOND_BLOCK_GAIN * (per_sm - 1)
    return (_cdiv(blocks, limits.sms * per_sm) * per_sm * (tpb + 0.25)
            * tile_cost / gain, tpb, per_sm)


@dataclasses.dataclass(frozen=True)
class BneckPlan:
    """The block of the fused bottleneck: ``tile_h`` x ``tile_w`` output
    pixels a tile, ``bn`` output channels, their w2 rows ``resident`` (all
    taps, loaded once a run) or streamed a tap at a time through a two-slot
    ring (all of w1 resident either way), ``tiles_per_block`` consecutive
    tiles (in (image, tile) order)."""
    tile_h: int
    tile_w: int
    bn: int
    resident: bool
    tiles_per_block: int


@dataclasses.dataclass(frozen=True)
class BneckLayout:
    """One block's dynamic shared memory, byte offsets from its start: the
    halo'd x slab at 0 (Cp + 16 bytes a pixel, Cp = C rounded up to 32),
    the m slab at ``m_off`` (CMp + 16 a pixel), w1 at ``w1_off`` (CMp rows
    of Cp + 16), w2 at ``w2_off`` (resident: bn rows of K K CMp + 16;
    streamed: two slots of bn rows of CMp + 16), stage 1's bias and cs at
    ``col_off`` (8 bytes a channel of CMp), the staged output tile at
    ``out_off`` (bn + 16 bytes a pixel; the shortcut lands there too). No
    static bytes."""
    m_off: int
    w1_off: int
    w2_off: int
    col_off: int
    out_off: int
    smem: int


def bneck_layout(c: int, cm: int, k: int, tile_h: int, tile_w: int,
                 bn: int, resident: bool = True) -> BneckLayout:
    halo = (tile_h + k - 1) * (tile_w + k - 1)
    cp, cmp_ = _round_up(c, 32), _round_up(cm, 32)
    m_off = halo * (cp + 16)
    w1_off = m_off + halo * (cmp_ + 16)
    w2_off = w1_off + cmp_ * (cp + 16)
    col_off = w2_off + (bn * (k * k * cmp_ + 16) if resident
                        else 2 * bn * (cmp_ + 16))
    out_off = col_off + 8 * cmp_
    return BneckLayout(m_off, w1_off, w2_off, col_off, out_off,
                       out_off + tile_h * tile_w * (bn + _OUT_PAD))


def bneck_smem(c: int, cm: int, k: int, tile_h: int, tile_w: int,
               bn: int, resident: bool = True) -> int:
    """Shared memory of a block in bytes (:func:`bneck_layout`'s total)."""
    return bneck_layout(c, cm, k, tile_h, tile_w, bn, resident).smem


def bneck_tile_cost(h: int, c: int, cm: int, k: int, tile_h: int,
                    tile_w: int, bn: int, resident: bool = True,
                    tpb: int = 1) -> float:
    """The modelled work of one tile of one channel block in runs of
    ``tpb`` tiles: stage 1's products and epilogue (each channel block
    recomputes them) in rounds of the 8 warps over its items of 16 slab
    pixels x 16 or 32 channels (a tile below the run's previous one takes
    K - 1 rows of m from it and computes the rest: all but the first tile of
    a run's stretch of a column of tiles); stage 2's products and epilogue;
    three barriers; and where w2 is streamed its bytes from L2 and a
    barrier a tap."""
    sw = tile_w + k - 1
    halo = (tile_h + k - 1) * sw
    cp, cmp_ = _round_up(c, 32), _round_up(cm, 32)
    tp = tile_h * tile_w
    ch = 16 if cmp_ <= 64 else 32   # channels a stage-1 item

    def rounds(pixels: int) -> int:
        return _cdiv(_cdiv(pixels, 16) * (cmp_ // ch), 8)
    stretch = min(tpb, _cdiv(h, tile_h))   # tiles a run takes a column
    carried = (rounds(halo - (k - 1) * sw) if tile_h >= k - 1
               else rounds(halo))
    stage1_rounds = (rounds(halo) + (stretch - 1) * carried) / stretch
    item = (_MMA_SLOTS * (ch // 8) * (cp // 32) + _EPI_SLOTS * 16 * ch)
    stage1 = 8 * stage1_rounds * item
    stage2 = (_MMA_SLOTS * (tp // 16) * (bn // 8) * (k * k * cmp_ // 32)
              + _EPI_SLOTS * tp * bn)
    stream = 0.0 if resident else k * k * (
        _BARRIER_SLOTS + _L2_BYTE_SLOTS * bn * cmp_)
    return stage1 + stage2 + 3 * _BARRIER_SLOTS + stream


@functools.lru_cache(maxsize=256)
def bneck_plans(batch: int, h: int, w: int, c: int, cm: int, o: int, k: int,
                limits: SmemLimits) -> Tuple[BneckPlan, ...]:
    """Every tile (:data:`CONV_TILES`), channel block (``FUSED_BNS``, by
    :data:`FUSED_WARP_TILES`) and w2 residence whose layout fits, each
    with its modelled run of tiles, cheapest first by :func:`_fused_cost`
    over :func:`bneck_tile_cost` (ragged tiles and channel blocks count
    whole); ties: more blocks an SM, resident weights, the larger block,
    the wider tile."""
    cands = []
    for th, tw in CONV_TILES:
        tp = th * tw
        tiles = batch * _cdiv(h, th) * _cdiv(w, tw)
        for bn in FUSED_BNS:
            if (tp // 64, bn // 16) not in FUSED_WARP_TILES:
                continue
            for resident in (True, False):
                smem = bneck_smem(c, cm, k, th, tw, bn, resident)
                if smem > limits.per_block:
                    continue
                cost, tpb, per_sm = _fused_cost(
                    tiles, _cdiv(o, bn), smem, fused_max_blocks(tp, bn),
                    functools.partial(bneck_tile_cost, h, c, cm, k, th, tw,
                                      bn, resident), limits)
                cands.append(((cost, -per_sm, not resident, -tp * bn, -tw),
                              BneckPlan(th, tw, bn, resident, tpb)))
    return tuple(p for _, p in sorted(cands, key=lambda t: t[0]))


def bneck_plan(batch: int, h: int, w: int, c: int, cm: int, o: int, k: int,
               limits: SmemLimits) -> BneckPlan:
    """The first of :func:`bneck_plans`; ValueError if no block fits."""
    plans = bneck_plans(batch, h, w, c, cm, o, k, limits)
    if not plans:
        raise ValueError(f"no block of the bottleneck kernel fits C={c} "
                         f"CM={cm} {k}x{k} in {limits.per_block} bytes of "
                         "shared memory")
    return plans[0]


def bneck_occupancy(plan: BneckPlan, c: int, cm: int, k: int, act1: str,
                    act2: str, compute: str = "int8") -> Tuple[int, int]:
    """``(shared memory bytes, blocks an SM holds)`` of the bottleneck
    kernel of ``act1`` / ``act2`` and ``compute`` with ``plan`` on the
    current card."""
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    cuda_build.check(cuda_build.load_library().tat_bneck_int8_fused_info(
        _kernel_act(act1), _kernel_act(act2), c, cm, k, plan.tile_h,
        plan.tile_w, plan.bn, int(plan.resident), _COMPUTE_CODE[compute],
        ctypes.byref(smem), ctypes.byref(blocks)),
        "tat_bneck_int8_fused_info")
    return smem.value, blocks.value


@dataclasses.dataclass(frozen=True)
class SppfPlan:
    """The block of the fused SPPF: ``bm`` consecutive pixels a tile (its
    pool pyramid built once, a chunk of ``ck`` channels at a time, into a
    resident A tile), the GEMM in blocks of ``bn`` output channels,
    ``tiles_per_block`` consecutive tiles (in (image, tile) order), each
    over all the output channels."""
    bm: int
    bn: int
    ck: int
    tiles_per_block: int


SPPF_CKS = (128, 64, 32)
SPPF_RING = 4             # slots of the weights' ring (kRing)


def sppf_kc(c: int, ck: int) -> int:
    """The ring's K slice: the widest of 128, 64, 32 bytes that divides
    Cp (C rounded up to ck), so that no slice straddles two levels."""
    cp = _round_up(c, ck)
    return 128 if cp % 128 == 0 else (64 if cp % 64 == 0 else 32)


@dataclasses.dataclass(frozen=True)
class SppfLayout:
    """One block's dynamic shared memory, byte offsets from its start: y
    at 0 and two levels at ``l1_off`` and ``l2_off`` (``rows`` image rows
    of W pixels at ck + 16 bytes), the row pass's int16 at ``tmp_off``
    (rows x W x 2 ck), the A tile at ``a_off`` (bm rows of 4 Cp + 16, Cp
    = C rounded up to ck), the weights' ring at ``ring_off`` (4 slots of
    bn rows at KC + 16), the staged output tile at ``out_off`` (bm pixels
    of bn + 16). No static bytes."""
    rows: int
    tmp_off: int
    l1_off: int
    l2_off: int
    a_off: int
    ring_off: int
    out_off: int
    smem: int


def sppf_layout(h: int, w: int, c: int, k: int, bm: int, bn: int,
                ck: int) -> SppfLayout:
    span = (bm + w - 2) // w + 1   # image rows bm consecutive pixels span
    rows = min(h, span + 3 * (k - 1))
    level = rows * w * (ck + 16)
    tmp_off = level
    l1_off = tmp_off + rows * w * 2 * ck
    l2_off = l1_off + level
    a_off = l2_off + level
    ring_off = a_off + bm * (4 * _round_up(c, ck) + 16)
    out_off = ring_off + SPPF_RING * bn * (sppf_kc(c, ck) + 16)
    return SppfLayout(rows, tmp_off, l1_off, l2_off, a_off, ring_off,
                      out_off, out_off + bm * (bn + _OUT_PAD))


def sppf_smem(h: int, w: int, c: int, k: int, bm: int, bn: int,
              ck: int) -> int:
    """Shared memory of a block in bytes (:func:`sppf_layout`'s total)."""
    return sppf_layout(h, w, c, k, bm, bn, ck).smem


def sppf_tile_cost(h: int, w: int, c: int, o: int, k: int, bm: int,
                   bn: int, ck: int) -> float:
    """The modelled work of one tile of one block: the pyramid (per chunk
    the pool passes over the rows each level must hold, a tile of bm
    pixels spanning about bm / W + 1 rows, and eight barriers), then the
    BN blocks of all O in the GEMM (a barrier a ring slice) and their
    epilogues."""
    pk = (k - 1) // 2
    band = min(h, _cdiv(bm, w) + 1)
    rows = [min(h, band + 2 * (3 - lv) * pk) for lv in range(4)]
    items = (rows[0] + 2 * rows[1] + 2 * rows[2] + rows[3]) * w * ck // 16
    pyramid = _cdiv(c, ck) * (_POOL_SLOTS * items + 8 * _BARRIER_SLOTS)
    kc = sppf_kc(c, ck)
    slices = 4 * _round_up(c, ck) // kc
    blocks = _cdiv(o, bn)
    slice_cost = (_MMA_SLOTS * (bm // 16) * (bn // 8) * (kc // 32)
                  + _BARRIER_SLOTS)
    return pyramid + blocks * (slices * slice_cost + _EPI_SLOTS * bm * bn)


@functools.lru_cache(maxsize=256)
def sppf_plans(batch: int, h: int, w: int, c: int, o: int, k: int,
               limits: SmemLimits) -> Tuple[SppfPlan, ...]:
    """Every (bm, bn, ck) whose layout fits (ck at most C rounded up to
    32), each with its modelled run of tiles, cheapest first by
    :func:`_fused_cost` over :func:`sppf_tile_cost`; ties: more blocks an
    SM, the larger block, the wider chunk."""
    cands = []
    for bm in (128, 64):
        tiles = batch * _cdiv(h * w, bm)
        for bn in FUSED_BNS:
            if (bm // 64, bn // 16) not in FUSED_WARP_TILES:
                continue
            for ck in SPPF_CKS:
                if ck > _round_up(c, 32):
                    continue
                smem = sppf_smem(h, w, c, k, bm, bn, ck)
                if smem > limits.per_block:
                    continue
                work = sppf_tile_cost(h, w, c, o, k, bm, bn, ck)
                cost, tpb, per_sm = _fused_cost(
                    tiles, 1, smem, 1, lambda _: work, limits)
                cands.append(((cost, -per_sm, -bm * bn, -ck),
                              SppfPlan(bm, bn, ck, tpb)))
    return tuple(p for _, p in sorted(cands, key=lambda t: t[0]))


def sppf_plan(batch: int, h: int, w: int, c: int, o: int, k: int,
              limits: SmemLimits) -> SppfPlan:
    """The first of :func:`sppf_plans`; ValueError if no block fits."""
    plans = sppf_plans(batch, h, w, c, o, k, limits)
    if not plans:
        raise ValueError(f"no block of the SPPF kernel fits {h}x{w}x{c} "
                         f"k={k} in {limits.per_block} bytes of shared "
                         "memory")
    return plans[0]


def sppf_occupancy(plan: SppfPlan, h: int, w: int, c: int, k: int,
                   act: str, compute: str = "int8") -> Tuple[int, int]:
    """``(shared memory bytes, blocks an SM holds)`` of the SPPF kernel of
    ``act`` and ``compute`` with ``plan`` on the current card."""
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    cuda_build.check(cuda_build.load_library().tat_sppf_int8_fused_info(
        _kernel_act(act), h, w, c, k, plan.bm, plan.bn, plan.ck,
        _COMPUTE_CODE[compute], ctypes.byref(smem), ctypes.byref(blocks)),
        "tat_sppf_int8_fused_info")
    return smem.value, blocks.value


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


def _launch_dw(x, w, bias, ep, pads, out,
               plan: Optional["DwPlan"] = None) -> None:
    if plan is None:
        plan = dw_plan(x.shape[0], out.shape[1], out.shape[2], x.shape[3],
                       w.shape[0], w.shape[1], smem_limits(out.device))
    cuda_build.check(cuda_build.load_library().tat_dw_int8_fused(
        *_dw_args(x, w, bias, ep, pads, out, plan), _stream(out.device)),
        "tat_dw_int8_fused")


def _dw_args(x, w, bias, ep, pads, out, plan: "DwPlan") -> tuple:
    """The arguments of ``tat_dw_int8_fused`` up to the stream."""
    nb, h, wd, c = x.shape
    kh, kw, _ = w.shape
    (pt, _), (pl, _) = pads
    return (_ptr(x), _ptr(w), _ptr(bias), _ptr(ep.cs), _ptr(out), nb, h, wd,
            c, kh, kw, pt, pl, out.shape[1], out.shape[2],
            _kernel_act(ep.act), ep.inv_out, ep.alpha, plan.tile_h,
            plan.groups)


# ---------------------------------------------------------------------------
# The depthwise kernel's plan and shared-memory layout (``dw_layout`` of
# ``csrc/dw_int8_fused.cu``)
# ---------------------------------------------------------------------------

DW_MAX_GROUPS = 16        # 16-channel groups a block (kMaxGroups)
DW_MAX_THREADS = 256      # threads a block at most (kMaxThreads)


@dataclasses.dataclass(frozen=True)
class DwPlan:
    """The block of the depthwise kernel: ``tile_h`` output rows of one
    image, ``groups`` x 16 channels, all the output's columns."""
    tile_h: int
    groups: int


def dw_threads(ow: int, groups: int) -> int:
    """A block's threads: ``groups`` x min(ow, 256 / groups) columns."""
    return groups * min(ow, DW_MAX_THREADS // groups)


def dw_smem(ow: int, kh: int, kw: int, tile_h: int, groups: int) -> int:
    """Dynamic shared memory of a block in bytes: the halo, (tile_h + kh -
    1) rows of ow + kw - 1 pixels at 16 x groups bytes, kh kw weight rows
    of 16 x groups int32, then the 16 x groups channels' int32 bias and
    f32 cs (no static bytes)."""
    cb = 16 * groups
    return ((tile_h + kh - 1) * (ow + kw - 1) * cb + 4 * kh * kw * cb
            + 8 * cb)


@functools.lru_cache(maxsize=256)
def dw_plans(batch: int, oh: int, ow: int, c: int, kh: int, kw: int,
             limits: SmemLimits) -> Tuple[DwPlan, ...]:
    """Every (tile_h, groups) that fits the shared memory, cheapest first
    by a model: the waves of blocks (blocks an SM by threads, 128 registers
    a thread and shared memory) times the halo rows a thread walks through
    (tile_h + kh - 1, times its columns' passes); ties: the fewest idle
    groups in the last slab, blocks nearest 128 threads (4 warps: several
    blocks an SM, the SMs' shares even), the taller tile (fewer halo
    re-reads). On the card its picks for NanoDet-320's five shapes ran a
    forward within 3% of the fastest plans' (PERF.md, PR 12)."""
    n_groups = _cdiv(c, 16)
    cands = []
    for groups in range(1, min(n_groups, DW_MAX_GROUPS) + 1):
        threads = _round_up(dw_threads(ow, groups), 32)
        passes = _cdiv(ow, dw_threads(ow, groups) // groups)
        for th in range(1, oh + 1):
            smem = dw_smem(ow, kh, kw, th, groups)
            if smem > limits.per_block:
                break
            per_sm = max(1, min(2048 // threads, 65536 // (threads * 128),
                                limits.per_sm // (smem + _BLOCK_RESERVED)))
            blocks = batch * _cdiv(oh, th) * _cdiv(n_groups, groups)
            cost = _cdiv(blocks, limits.sms * per_sm) * passes * (th + kh - 1)
            idle = _cdiv(n_groups, groups) * groups - n_groups
            key = (cost, idle, abs(dw_threads(ow, groups) - 128), -th)
            cands.append((key, DwPlan(th, groups)))
    return tuple(p for _, p in sorted(cands, key=lambda t: t[0]))


def dw_plan(batch: int, oh: int, ow: int, c: int, kh: int, kw: int,
            limits: SmemLimits) -> DwPlan:
    """The first of :func:`dw_plans`; ValueError if no block fits."""
    plans = dw_plans(batch, oh, ow, c, kh, kw, limits)
    if not plans:
        raise ValueError(f"no block of the depthwise kernel fits OW={ow} "
                         f"{kh}x{kw} in {limits.per_block} bytes of shared "
                         "memory")
    return plans[0]


def dw_occupancy(plan: DwPlan, c: int, kernel: Tuple[int, int],
                 ow: int) -> Tuple[int, int]:
    """``(shared memory bytes, blocks an SM holds)`` of the depthwise
    kernel with ``plan`` on the current card."""
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    cuda_build.check(cuda_build.load_library().tat_dw_int8_fused_info(
        c, kernel[0], kernel[1], ow, plan.tile_h, plan.groups,
        ctypes.byref(smem), ctypes.byref(blocks)), "tat_dw_int8_fused_info")
    return smem.value, blocks.value


def conv2d_int8_fused(
    x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
    ep: Epilogue, out_hw: Tuple[int, int], stride: Tuple[int, int],
    dilation: Tuple[int, int],
    pads: Tuple[Tuple[int, int], Tuple[int, int]],
    plain: bool = False,
    residual: Optional[torch.Tensor] = None, res_scale: float = 1.0,
    compute: Optional[str] = None,
) -> torch.Tensor:
    """Route an int8 conv to its fused kernel: 1x1 stride-1 unpadded ->
    :func:`matmul_int8_fused`; everything else (any square stride, the
    thin-channel stem included) -> :func:`conv2d_int8_halo_fused`.
    ``residual`` [N, OH, OW, O] joins the epilogue; ``compute`` the
    product (:func:`compute_mode`).

    ``plain=True`` takes the plain versions on any device: for checking
    the kernels against them, never on the serving path."""
    compute = compute_mode(compute)
    n, h, wd, c = x.shape
    o, kh, kw, _ = w.shape
    if dilation != (1, 1):
        raise ValueError("fused kernels support dilation 1 only")
    if kh == kw == 1 and stride == (1, 1) and pads == ((0, 0), (0, 0)):
        mm = matmul_int8_fused_plain if plain else matmul_int8_fused
        res = residual.reshape(n * h * wd, o) if residual is not None \
            else None
        out = mm(x.reshape(n * h * wd, c), w.reshape(o, c), bias, ep, res,
                 res_scale, compute=compute)
        return out.reshape(n, h, wd, o)
    if stride[0] != stride[1]:
        raise ValueError("fused conv needs square stride")
    conv = conv2d_int8_halo_fused_plain if plain else conv2d_int8_halo_fused
    return conv(x, w, bias, ep, out_hw, pads, stride[0], residual, res_scale,
                compute=compute)
