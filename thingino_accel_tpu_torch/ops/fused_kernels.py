"""Serving-tier fused int8 convs: conv/matmul with the whole post-conv
chain (bias + per-channel scale + activation + requantize) run before
the single int8 write. Port of ``thingino_accel_tpu.ops.fused_kernels``
for the slice's two kernels:

- :func:`matmul_int8_fused` (1x1 convs), CUDA kernel
  ``csrc/mm_int8_fused.cu``;
- :func:`conv2d_int8_halo_fused` (KxK convs at any square stride, the
  thin-channel stem included), CUDA kernel ``csrc/conv_int8_fused.cu``;
- :func:`conv2d_int8_fused`, the dispatcher between them.

Each wrapper takes its plain torch version for a tensor on the CPU, and
launches its kernel for a tensor on a CUDA device (or raises). The plain
versions accumulate in float64 (exact for int8 products: |acc| <=
K*K*C*128^2 << 2^53) and run the same epilogue in torch float32 ops;
they are device-agnostic, since torch has no int32 matmul on CUDA.

Weights are in the kernels' layout: ``[N, K]`` for the matmul and OHWI
``[O, KH, KW, C]`` for the conv (``runtime.executor.params_from_jax``
repacks the JAX package's HWIO).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from thingino_accel_tpu_torch.ops import cuda_build

ACTS = ("NONE", "RELU", "LEAKY_RELU", "SILU")
_ACT_CODE = {a: i for i, a in enumerate(ACTS)}   # tat::Act in epilogue.cuh

# Kernel launches per wrapper since the last reset_launches(): a run can
# show which kernels its main path went through.
launches: Dict[str, int] = {"matmul_int8_fused": 0,
                            "conv2d_int8_halo_fused": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


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
    if act in ("NONE", "RELU", "LEAKY_RELU"):
        cs = (cs / np.float32(out_scale)).astype(np.float32)
        inv_out = 1.0
    else:
        inv_out = float(1.0 / np.float32(out_scale))
    return Epilogue(cs=torch.from_numpy(np.ascontiguousarray(cs)).to(device),
                    inv_out=inv_out, act=act, alpha=float(alpha))


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def epilogue_plain(acc: torch.Tensor, bias: Optional[torch.Tensor],
                   ep: Epilogue) -> torch.Tensor:
    """int32 accumulator [..., N] -> int8, in the order of the JAX
    ``_epilogue``/``_act_requant``: + bias (int32), -> f32, x cs,
    activation, x inv_out, +-0.5 by sign, trunc, clamp; LEAKY_RELU's
    alpha applies after the clamp on the quantized value, truncated."""
    if bias is not None:
        acc = acc + bias
    pre = acc.to(torch.float32) * ep.cs
    if ep.act == "RELU":
        pre = torch.clamp_min(pre, 0.0)
    elif ep.act == "SILU":
        pre = pre * torch.sigmoid(pre)
    scaled = pre * ep.inv_out
    shifted = scaled + torch.where(scaled >= 0, 0.5, -0.5)
    q = torch.clamp(torch.trunc(shifted), -128.0, 127.0)
    if ep.act == "LEAKY_RELU":
        neg = torch.clamp_min(torch.trunc(q * ep.alpha), -128.0)
        q = torch.where(q > 0, q, neg)
    return q.to(torch.int8)


def matmul_int8_fused_plain(x: torch.Tensor, w: torch.Tensor,
                            bias: Optional[torch.Tensor],
                            ep: Epilogue) -> torch.Tensor:
    """``x [M, K] int8 @ w [N, K]^T`` -> int8 [M, N]."""
    acc = (x.to(torch.float64) @ w.to(torch.float64).t()).to(torch.int32)
    return epilogue_plain(acc, bias, ep)


def conv2d_int8_halo_fused_plain(
    x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
    ep: Epilogue, out_hw: Tuple[int, int],
    pads: Tuple[Tuple[int, int], Tuple[int, int]], stride: int = 1,
) -> torch.Tensor:
    """NHWC int8 ``x`` (*) OHWI int8 ``w`` at square ``stride`` with zero
    padding ``pads`` -> int8 NHWC [N, OH, OW, O]."""
    (pt, pb), (pl, pr) = pads
    oh, ow = out_hw
    xd = F.pad(x.permute(0, 3, 1, 2).to(torch.float64), (pl, pr, pt, pb))
    acc = F.conv2d(xd, w.permute(0, 3, 1, 2).to(torch.float64),
                   stride=stride)[:, :, :oh, :ow]
    acc = acc.permute(0, 2, 3, 1).to(torch.int32)
    return epilogue_plain(acc, bias, ep)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check_operands(x, w, bias, ep, n_out):
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
            if t is not None and not t.is_contiguous():
                raise ValueError("CUDA kernel operands must be contiguous")
    return dev


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def matmul_int8_fused(x: torch.Tensor, w: torch.Tensor,
                      bias: Optional[torch.Tensor],
                      ep: Epilogue) -> torch.Tensor:
    """``int8 = requant(act((x @ w^T + b) * cs))``: x [M, K] int8,
    w [N, K] int8, bias [N] int32 or None -> int8 [M, N]."""
    m, k = x.shape
    n, k_w = w.shape
    if k_w != k:
        raise ValueError(f"K mismatch: x {tuple(x.shape)}, w {tuple(w.shape)}")
    dev = _check_operands(x, w, bias, ep, n)
    if dev.type == "cpu":
        return matmul_int8_fused_plain(x, w, bias, ep)
    out = torch.empty((m, n), dtype=torch.int8, device=dev)
    if m == 0:
        return out
    lib = cuda_build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    cuda_build.check(lib.tat_mm_int8_fused(
        _ptr(x), _ptr(w), _ptr(bias), _ptr(ep.cs), _ptr(out), m, n, k,
        _ACT_CODE[ep.act], ep.inv_out, ep.alpha, stream),
        "tat_mm_int8_fused")
    launches["matmul_int8_fused"] += 1
    return out


def conv2d_int8_halo_fused(
    x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
    ep: Epilogue, out_hw: Tuple[int, int],
    pads: Tuple[Tuple[int, int], Tuple[int, int]], stride: int = 1,
) -> torch.Tensor:
    """KxK int8 conv at square ``stride``: x NHWC [N, H, W, C] int8,
    w OHWI [O, KH, KW, C] int8 -> int8 [N, OH, OW, O]. ``out_hw`` is the
    graph's declared output size; ``pads`` ((pt, pb), (pl, pr)) may be
    asymmetric. Only pt/pl position the window; rows and columns past the
    input are zero."""
    nb, h, wd, c = x.shape
    o, kh, kw, c_w = w.shape
    if c_w != c:
        raise ValueError(f"C mismatch: x {tuple(x.shape)}, w {tuple(w.shape)}")
    dev = _check_operands(x, w, bias, ep, o)
    if dev.type == "cpu":
        return conv2d_int8_halo_fused_plain(x, w, bias, ep, out_hw, pads,
                                            stride)
    oh, ow = out_hw
    (pt, _), (pl, _) = pads
    out = torch.empty((nb, oh, ow, o), dtype=torch.int8, device=dev)
    if out.numel() == 0:
        return out
    lib = cuda_build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    cuda_build.check(lib.tat_conv_int8_fused(
        _ptr(x), _ptr(w), _ptr(bias), _ptr(ep.cs), _ptr(out),
        nb, h, wd, c, o, kh, kw, stride, pt, pl, oh, ow,
        _ACT_CODE[ep.act], ep.inv_out, ep.alpha, stream),
        "tat_conv_int8_fused")
    launches["conv2d_int8_halo_fused"] += 1
    return out


def conv2d_int8_fused(
    x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
    ep: Epilogue, out_hw: Tuple[int, int], stride: Tuple[int, int],
    dilation: Tuple[int, int],
    pads: Tuple[Tuple[int, int], Tuple[int, int]],
    plain: bool = False,
) -> torch.Tensor:
    """Route an int8 conv to its fused kernel: 1x1 stride-1 unpadded ->
    :func:`matmul_int8_fused`; everything else (any square stride, the
    thin-channel stem included) -> :func:`conv2d_int8_halo_fused`.

    ``plain=True`` takes the plain versions on any device: for checking
    the kernels against them, never on the serving path."""
    n, h, wd, c = x.shape
    o, kh, kw, _ = w.shape
    if dilation != (1, 1):
        raise ValueError("fused kernels support dilation 1 only")
    if kh == kw == 1 and stride == (1, 1) and pads == ((0, 0), (0, 0)):
        mm = matmul_int8_fused_plain if plain else matmul_int8_fused
        out = mm(x.reshape(n * h * wd, c), w.reshape(o, c), bias, ep)
        return out.reshape(n, h, wd, o)
    if stride[0] != stride[1]:
        raise ValueError("fused conv needs square stride")
    conv = conv2d_int8_halo_fused_plain if plain else conv2d_int8_halo_fused
    return conv(x, w, bias, ep, out_hw, pads, stride[0])
