"""The kernels of the probes (``thingino_accel_tpu_torch.probes``): the
port's first tensor-core code, and the kernel rung of the health ladder.

- :func:`chain_mma`, E1 (``examples/mxu_ceiling_probe.py:build``): L
  chained ``[rows, K] x [K, K]`` products with the cheapest glue between
  them, in four variants (:data:`CHAIN_KINDS`), CUDA ``csrc/chain_mma.cu``;
- :func:`megakernel_chain`, E3 (``examples/megakernel_probe.py:build``):
  the same chain with the production requantize epilogue, the
  valid-shrink 3x3 chains and the C3 round (:data:`MEGA_KINDS`), CUDA
  ``csrc/megakernel_probe.cu``;
- :func:`add_one`, E4 (``examples/wedge_probe.py`` rung ``pallas``): f32
  ``x + 1``, CUDA ``csrc/add_one.cu``;
- :func:`conv3x3_lagged`, E2 (``examples/pipeline_experiment.py:lagged``):
  the int8 3x3/s1 conv with the serving epilogue on Hopper's warpgroup
  MMA (``wgmma``, slabs by TMA), two consumer warpgroups whose epilogues
  overlap each other's products (``lag=True``, ping-pong) or run in
  lockstep after them (``lag=False``), CUDA ``csrc/conv_int8_lagged.cu``.

Each wrapper takes its plain torch version for a tensor on the CPU and
launches its kernel for a tensor on a CUDA device, or raises; nothing
falls back. Weights are in the kernels' layout: each output column's K
values contiguous, ``[L, taps, N, K]`` (the JAX probes hold ``[L, taps,
K, N]``: ``x @ w``), E2's OHWI ``[O, 3, 3, C]`` (JAX: HWIO); int4 weights
wrapped to [-8, 7] as JAX's ``astype(jnp.int4)`` wraps, packed two a byte
(:func:`pack_int4`).
The plain versions sum in float64, exact for these int8 products and
rounded once for the bf16 ones, and are device-agnostic.
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
from thingino_accel_tpu_torch.ops import fused_kernels as FK

CHAIN_KINDS = ("int8", "bf16", "mixed", "int4w")
_GLUE = {"int8": 0, "bf16": 1, "mixed": 2, "int4w": 3}   # tat::ChainGlue
_GLUE_REQUANT = 4
MEGA_KINDS = ("i8-shift-1x1", "i8-rq-silu-1x1", "i8-rq-siluf-1x1",
              "i8-rq-relu-1x1", "i8-shift-3x3", "i8-rq-silu-3x3",
              "bf16-3x3", "i8-c3-round")
# the activation of each requantizing kind (the probe's _requant)
MEGA_ACT = {"i8-rq-silu-1x1": "SILU", "i8-rq-siluf-1x1": "SILU_FAST",
            "i8-rq-relu-1x1": "RELU", "i8-rq-silu-3x3": "SILU",
            "i8-c3-round": "SILU"}
_SPATIAL_CODE = {"i8-shift-3x3": 0, "i8-rq-silu-3x3": 1, "bf16-3x3": 2,
                 "i8-c3-round": 3}
INV_OUT = 1.0 / 32.0   # the probe's _requant: inv_out, alpha, res_scale
ALPHA = 0.01
RES_SCALE = 0.5

# Kernel launches per wrapper since the last reset_launches().
launches: Dict[str, int] = {"chain_mma": 0, "megakernel_probe": 0,
                            "add_one": 0, "conv3x3_lagged": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def is_spatial(kind: str) -> bool:
    return kind.endswith("3x3") or kind == "i8-c3-round"


# ---------------------------------------------------------------------------
# int4 weights
# ---------------------------------------------------------------------------


def wrap_int4(w: torch.Tensor) -> torch.Tensor:
    """int8 values wrapped modulo 16 into [-8, 7], as ``astype(jnp.int4)``
    (-100 -> -4, 9 -> -7, 16 -> 0)."""
    return (((w.to(torch.int16) + 8) & 15) - 8).to(torch.int8)


def pack_int4(w: torch.Tensor) -> torch.Tensor:
    """int8 ``[..., K]`` (K even) wrapped to int4 and packed two a byte,
    element 2j in the low nibble of byte j: uint8 ``[..., K / 2]``."""
    if w.dtype != torch.int8 or w.shape[-1] % 2:
        raise ValueError(f"int8 [..., even K] expected, got {w.dtype} "
                         f"{tuple(w.shape)}")
    v = w.to(torch.int16) & 15
    return (v[..., 0::2] | (v[..., 1::2] << 4)).to(torch.uint8)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`pack_int4`: uint8 ``[..., K/2]`` -> int8
    ``[..., K]`` in [-8, 7]."""
    v = p.to(torch.int16)
    nib = torch.stack((v & 15, v >> 4), dim=-1).flatten(-2)
    return (nib - 16 * (nib >= 8)).to(torch.int8)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _mm_exact(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [M, K] @ w [N, K]^T`` in float64."""
    return x.to(torch.float64) @ w.to(torch.float64).t()


def _requant(acc: torch.Tensor, cs: torch.Tensor, act: str,
             residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    ep = FK.Epilogue(cs=cs, inv_out=INV_OUT, act=act, alpha=ALPHA)
    return FK.epilogue_plain(acc, None, ep, residual, RES_SCALE)


def _bf16_exit(acc: torch.Tensor) -> torch.Tensor:
    return (acc.to(torch.float32) * (1.0 / 128.0)).to(torch.bfloat16)


def chain_mma_plain(x: torch.Tensor, w: torch.Tensor,
                    kind: str) -> torch.Tensor:
    """E1's four chains (``mxu_ceiling_probe.py:47-91``): for each of the L
    weights, ``acc = x @ w[i]``, then
    int8 ``(acc >> 7)`` as int8 (wrapping); int4w ``(acc >> 5)`` as int8
    on the weights wrapped to int4; mixed ``clip(acc / 128, +-127)``
    truncated to int8; bf16 ``bf16(acc / 128)``."""
    if kind == "int4w":
        w = unpack_int4(w)
    for i in range(w.shape[0]):
        acc = _mm_exact(x, w[i])
        if kind == "bf16":
            x = _bf16_exit(acc)
        elif kind == "mixed":
            v = torch.clamp(acc.to(torch.float32) * (1.0 / 128.0), -127, 127)
            x = torch.trunc(v).to(torch.int8)
        else:
            x = (acc.to(torch.int32) >> (5 if kind == "int4w" else 7)).to(
                torch.int8)
    return x


def _taps_exact(x: torch.Tensor, w9: torch.Tensor) -> torch.Tensor:
    """VALID 3x3 of NHWC ``x [cells, e, e, K]`` with ``w9 [9, N, K]`` (tap
    3 dy + dx) in float64: ``[cells, e - 2, e - 2, N]``."""
    n, k = w9.shape[1], w9.shape[2]
    wt = w9.reshape(3, 3, n, k).permute(2, 3, 0, 1).to(torch.float64)
    y = F.conv2d(x.permute(0, 3, 1, 2).to(torch.float64), wt)
    return y.permute(0, 2, 3, 1)


def megakernel_chain_plain(kind: str, x: torch.Tensor, w, cs=None
                           ) -> torch.Tensor:
    """E3's eight kinds (``megakernel_probe.py:87-166``).

    1x1 kinds: ``x [rows, K]``, ``w [L, 1, N, K]``; L stages of ``x @ w``
    then ``>> 7`` as int8 or the requantize of :data:`MEGA_ACT`.
    3x3 kinds: ``x [cells, H + 2L, H + 2L, K]``, ``w [L, 9, N, K]`` (the
    C3 round: ``(w1 [L, 1, N, K], w3)``); stage i takes extent e = H +
    2(L - i) to e - 2 -> ``[cells, H, H, K]``. The C3 round requantizes
    ``x @ w1[i]`` (SILU), runs the taps on it and adds the residual
    ``x[1:e-1, 1:e-1]`` at :data:`RES_SCALE` in its SILU epilogue."""
    act = MEGA_ACT.get(kind)
    if not is_spatial(kind):
        for i in range(w.shape[0]):
            acc = _mm_exact(x, w[i, 0])
            x = (_requant(acc.to(torch.int32), cs, act) if act else
                 (acc.to(torch.int32) >> 7).to(torch.int8))
        return x
    w1, w3 = w if kind == "i8-c3-round" else (None, w)
    for i in range(w3.shape[0]):
        if kind == "i8-c3-round":
            e, k = x.shape[1], x.shape[3]
            m = _mm_exact(x.reshape(-1, k), w1[i, 0]).to(torch.int32)
            m = _requant(m, cs, "SILU").reshape(x.shape)
            acc = _taps_exact(m, w3[i]).to(torch.int32)
            x = _requant(acc, cs, "SILU", x[:, 1:e - 1, 1:e - 1, :])
            continue
        acc = _taps_exact(x, w3[i])
        if kind == "bf16-3x3":
            x = _bf16_exit(acc)
        elif act:
            x = _requant(acc.to(torch.int32), cs, act)
        else:
            x = (acc.to(torch.int32) >> 7).to(torch.int8)
    return x


def add_one_plain(x: torch.Tensor) -> torch.Tensor:
    return x + 1.0


def conv3x3_lagged_plain(x: torch.Tensor, w: torch.Tensor,
                         bias: Optional[torch.Tensor],
                         ep: FK.Epilogue) -> torch.Tensor:
    """E2's function: the int8 3x3/s1 pad-1 conv of NHWC ``x`` with OHWI
    ``w`` and the serving epilogue, all rows (#2's plain version)."""
    return FK.conv2d_int8_halo_fused_plain(
        x, w, bias, ep, (x.shape[1], x.shape[2]), ((1, 1), (1, 1)), 1)


# ---------------------------------------------------------------------------
# Plans: the block shapes the launchers pick, from the device's limits
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ChainPlan:
    """A row chain's block: ``bm`` rows, weight slabs of ``bn`` columns."""

    bm: int
    bn: int


CHAIN_BMS = (256, 128, 64)


def chain_bns(bm: int) -> Tuple[int, ...]:
    """The slab widths the row chain takes at ``bm`` rows: 2, 4 or 8 n8
    tiles a warp over the warps the rows leave (chain_mma.cuh)."""
    wm = min(8, bm // 16)
    return tuple(8 * nw * (8 // wm) for nw in (8, 4, 2))


def _row_bytes(kind: str, k: int) -> int:
    return 2 * k if kind in ("bf16", "bf16-3x3") else k


def chain_smem(kind: str, k: int, plan: ChainPlan) -> int:
    """Shared memory of a row chain (``row_chain_smem`` of
    chain_mma.cuh): two x buffers, two weight slots and, for int4w, the
    unpacked slab; rows padded by 16 bytes."""
    pitch = _row_bytes(kind, k) + 16
    slot = plan.bn * (k // 2 if kind == "int4w" else pitch)
    return 2 * plan.bm * pitch + 2 * slot + (plan.bn * pitch
                                             if kind == "int4w" else 0)


def chain_plan(kind: str, rows: int, k: int,
               limits: FK.SmemLimits) -> ChainPlan:
    """The most rows a block that the shared memory holds (the weights
    are streamed once a block, so more rows read fewer L2 bytes an
    operation), no more than twice the rows there are, then the widest
    slab."""
    for bm in CHAIN_BMS:
        if bm > 64 and bm > 2 * rows:
            continue
        for bn in chain_bns(bm):
            plan = ChainPlan(bm, bn)
            if k % bn == 0 and chain_smem(kind, k, plan) <= limits.per_block:
                return plan
    raise ValueError(f"no row-chain block fits {kind} K={k} in "
                     f"{limits.per_block} bytes of shared memory")


@dataclasses.dataclass(frozen=True)
class SpatialPlan:
    """A 3x3 chain's block: a ``th`` x ``tw`` sub-tile of a cell's output,
    weight slabs of ``bn`` columns."""

    th: int
    tw: int
    bn: int


SPATIAL_TILES = (2, 4, 8, 16)
SPATIAL_BNS = (32, 16, 8)
SPATIAL_MAX_ROWS = 512   # 8 warps x 4 m16 tiles
SPATIAL_SLOTS = 3        # weight slabs in flight (kSlots)


def _region(l: int, th: int, tw: int) -> Tuple[int, int]:
    return th + 2 * l, tw + 2 * l


def spatial_smem(kind: str, k: int, l: int, plan: SpatialPlan) -> int:
    """Shared memory of a 3x3 chain (``launch_spatial`` of
    megakernel_probe.cu): the stage-0 region, the stage-1 region, the C3
    round's 1x1 output, :data:`SPATIAL_SLOTS` weight slots; rows padded by
    16 bytes."""
    pitch = _row_bytes(kind, k) + 16
    eh, ew = _region(l, plan.th, plan.tw)
    region = eh * ew
    return pitch * (region + (eh - 2) * (ew - 2)
                    + (region if kind == "i8-c3-round" else 0)
                    + SPATIAL_SLOTS * plan.bn)


def spatial_issued_ops(kind: str, k: int, h: int, l: int, cells: int,
                       plan: SpatialPlan) -> float:
    """Operations the 3x3 kernel issues with ``plan``: each block's
    shrinking regions, the halo it shares with its neighbours included."""
    px = 0
    for i in range(l):
        eh, ew = _region(l - i, plan.th, plan.tw)
        px += 9 * (eh - 2) * (ew - 2) + (eh * ew if kind == "i8-c3-round"
                                         else 0)
    return 2.0 * k * k * px * cells * (h // plan.th) * (h // plan.tw)


def spatial_plans(kind: str, k: int, h: int, l: int,
                  limits: FK.SmemLimits) -> Tuple[SpatialPlan, ...]:
    """Every plan the kernel can run here: sub-tiles dividing ``h``, no
    more rows a phase than :data:`SPATIAL_MAX_ROWS`, within the shared
    memory."""
    plans = []
    for th in SPATIAL_TILES:
        for tw in SPATIAL_TILES:
            if h % th or h % tw:
                continue
            eh, ew = _region(l, th, tw)
            rows = eh * ew if kind == "i8-c3-round" else (eh - 2) * (ew - 2)
            if rows > SPATIAL_MAX_ROWS:
                continue
            for bn in SPATIAL_BNS:
                p = SpatialPlan(th, tw, bn)
                if k % bn == 0 and spatial_smem(kind, k, l, p) \
                        <= limits.per_block:
                    plans.append(p)
    return tuple(plans)


def spatial_plan(kind: str, k: int, h: int, l: int,
                 limits: FK.SmemLimits) -> SpatialPlan:
    """The plan that issues the fewest operations (the least halo
    recomputed), then the widest slab."""
    plans = spatial_plans(kind, k, h, l, limits)
    if not plans:
        raise ValueError(f"no 3x3 sub-tile fits {kind} K={k} H={h} L={l} in "
                         f"{limits.per_block} bytes of shared memory")
    return min(plans, key=lambda p: (spatial_issued_ops(kind, k, h, l, 1, p),
                                     -p.bn, -p.th * p.tw))


@dataclasses.dataclass(frozen=True)
class LaggedPlan:
    """The lagged conv's block: ``bn`` output channels (the wgmma's N),
    ``stages`` slab slots in the TMA ring, ``blocks`` persistent blocks a
    channel block, walking the 8 x 8 tiles ``blockIdx.x, + blocks, ...``
    (the kernel takes at most the tiles)."""

    bn: int
    stages: int
    blocks: int


LAGGED_TILE = 8          # 8 x 8 output pixels a tile: one m64 wgmma tile
LAGGED_BNS = (128, 64, 32)
LAGGED_STAGES = (4, 3, 2)
LAGGED_THREADS = 384     # a producer warpgroup + two consumer warpgroups
LAGGED_PLANE = 1664      # a slab's 16-channel plane: 10 x 10 x 16, to 128


def lagged_smem(c: int, bn: int, stages: int) -> int:
    """Shared memory of a lagged-conv block (``lagged_layout`` of
    conv_int8_lagged.cu): the resident weights (9 C bn bytes), ``stages``
    slab slots of C / 16 planes, bias and cs (8 bn bytes), the 2 stages +
    1 mbarriers. Both modes take the same."""
    return (9 * c * bn + stages * (c // 16) * LAGGED_PLANE + 8 * bn
            + 8 * (2 * stages + 1))


def lagged_blocks(tiles: int, oblocks: int, smem: int,
                  limits: FK.SmemLimits) -> int:
    """Persistent blocks a channel block: every block an SM holds (by its
    threads and shared memory) over the SMs, shared by the channel
    blocks, at most the tiles."""
    per_sm = max(1, min(2048 // LAGGED_THREADS,
                        limits.per_sm // (smem + FK._BLOCK_RESERVED)))
    return max(1, min(tiles, limits.sms * per_sm // oblocks))


@functools.lru_cache(maxsize=256)
def lagged_plans(batch: int, h: int, w: int, c: int, o: int,
                 limits: FK.SmemLimits) -> Tuple[LaggedPlan, ...]:
    """Every channel block and ring depth the kernel can run here within
    the shared memory, each with its persistent blocks, in the order
    :func:`lagged_plan` prefers them: the fewest products issued (a ragged
    channel block counts whole), then the widest block, the deepest
    ring."""
    tiles = batch * FK._cdiv(h, LAGGED_TILE) * FK._cdiv(w, LAGGED_TILE)
    plans = []
    for bn, st in sorted(((b, s) for b in LAGGED_BNS for s in LAGGED_STAGES),
                         key=lambda p: (FK._cdiv(o, p[0]) * p[0], -p[0],
                                        -p[1])):
        smem = lagged_smem(c, bn, st)
        if smem > limits.per_block:
            continue
        plans.append(LaggedPlan(bn, st, lagged_blocks(
            tiles, FK._cdiv(o, bn), smem, limits)))
    return tuple(plans)


def lagged_plan(batch: int, h: int, w: int, c: int, o: int,
                limits: FK.SmemLimits) -> LaggedPlan:
    """The first of :func:`lagged_plans`; ValueError if none fits (C too
    large for the resident weights and the slab ring)."""
    plans = lagged_plans(batch, h, w, c, o, limits)
    if not plans:
        raise ValueError(f"no lagged-conv block fits C={c} in "
                         f"{limits.per_block} bytes of shared memory")
    return plans[0]


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _device_of(*ts: torch.Tensor) -> torch.device:
    devs = {t.device for t in ts if t is not None}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not all(t.is_contiguous() for t in ts
                                      if t is not None):
        raise ValueError("CUDA kernel operands must be contiguous")
    return dev


def _need(t: torch.Tensor, dtype: torch.dtype, shape: Sequence[int],
          what: str) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} must be {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def chain_mma(x: torch.Tensor, w: torch.Tensor, kind: str) -> torch.Tensor:
    """E1: ``x [rows, K]`` (int8; bf16 for ``"bf16"``) through L chained
    products with ``w [L, N=K, K]`` (int4w: uint8 ``[L, K, K/2]`` from
    :func:`pack_int4`) -> ``[rows, K]`` of x's type; on the card with
    the block :func:`chain_plan` picks for the device."""
    if kind not in CHAIN_KINDS:
        raise ValueError(f"unknown chain kind {kind!r}")
    if x.dim() != 2 or w.dim() != 3:
        raise ValueError("x [rows, K] and w [L, N, K] expected")
    rows, k = x.shape
    xdt = torch.bfloat16 if kind == "bf16" else torch.int8
    _need(x, xdt, (rows, k), "x")
    if kind == "int4w":
        _need(w, torch.uint8, (w.shape[0], k, k // 2), "w (packed int4)")
    else:
        _need(w, xdt, (w.shape[0], k, k), "w")
    dev = _device_of(x, w)
    if dev.type == "cpu":
        return chain_mma_plain(x, w, kind)
    out = torch.empty_like(x)
    _launch_chain(x, w, kind, out, chain_plan(kind, rows, k,
                                              FK.smem_limits(dev)))
    launches["chain_mma"] += 1
    return out


def _launch_chain(x, w, kind, out, plan: ChainPlan) -> None:
    cuda_build.check(cuda_build.load_library().tat_chain_mma(
        _GLUE[kind], x.data_ptr(), w.data_ptr(), out.data_ptr(), x.shape[0],
        x.shape[1], w.shape[0], plan.bm, plan.bn, _stream(x.device)),
        "tat_chain_mma")


def megakernel_chain(kind: str, x: torch.Tensor, w, cs=None
                     ) -> torch.Tensor:
    """E3: one application of ``kind`` (shapes as
    :func:`megakernel_chain_plain`); ``cs`` the [K] float32 per-channel
    scale of the requantizing kinds. On the card the block is the one
    :func:`chain_plan` or :func:`spatial_plan` picks for the device."""
    if kind not in MEGA_KINDS:
        raise ValueError(f"unknown megakernel kind {kind!r}")
    c3 = kind == "i8-c3-round"
    w1, w3 = w if c3 else (None, w)
    if w3.dim() != 4:
        raise ValueError("w [L, taps, N, K] expected")
    l, taps, n, k = w3.shape
    dt = torch.bfloat16 if kind == "bf16-3x3" else torch.int8
    _need(w3, dt, (l, 9 if is_spatial(kind) else 1, k, k), "w")
    if c3:
        _need(w1, torch.int8, (l, 1, k, k), "w1")
    if kind in MEGA_ACT:
        if cs is None:
            raise ValueError(f"{kind} needs the per-channel scale cs")
        _need(cs, torch.float32, (k,), "cs")
    elif cs is not None:
        cs = None   # the shift and bf16 kinds take no scale
    if is_spatial(kind):
        if x.dim() != 4 or x.shape[1] != x.shape[2] or x.shape[1] <= 2 * l:
            raise ValueError(f"x [cells, H + 2L, H + 2L, K] expected, got "
                             f"{tuple(x.shape)} with L = {l}")
        _need(x, dt, (x.shape[0], x.shape[1], x.shape[1], k), "x")
    else:
        _need(x, dt, (x.shape[0], k), "x")
    dev = _device_of(x, w1, w3, cs)
    if dev.type == "cpu":
        return megakernel_chain_plain(kind, x, w, cs)
    limits = FK.smem_limits(dev)
    if not is_spatial(kind):
        out = torch.empty_like(x)
        plan = chain_plan("int8", x.shape[0], k, limits)
        act = MEGA_ACT.get(kind)
        cuda_build.check(cuda_build.load_library().tat_megakernel_1x1(
            _GLUE_REQUANT if act else _GLUE["int8"], x.data_ptr(),
            w3.data_ptr(), None if cs is None else cs.data_ptr(),
            out.data_ptr(), x.shape[0], k, l, plan.bm, plan.bn,
            FK._ACT_CODE[act] if act else 0, INV_OUT, ALPHA,
            _stream(dev)), "tat_megakernel_1x1")
    else:
        h = x.shape[1] - 2 * l
        out = torch.empty((x.shape[0], h, h, k), dtype=dt, device=dev)
        _launch_spatial(x, w1, w3, cs, out, kind,
                        spatial_plan(kind, k, h, l, limits))
    launches["megakernel_probe"] += 1
    return out


def _launch_spatial(x, w1, w3, cs, out, kind, plan: SpatialPlan) -> None:
    """One launch of the 3x3 kernel of ``kind`` writing ``out [cells, H,
    H, K]`` with the block ``plan``."""
    l, k = w3.shape[0], w3.shape[3]
    cuda_build.check(cuda_build.load_library().tat_megakernel_3x3(
        _SPATIAL_CODE[kind], x.data_ptr(),
        None if w1 is None else w1.data_ptr(), w3.data_ptr(),
        None if cs is None else cs.data_ptr(), out.data_ptr(), x.shape[0],
        out.shape[1], l, k, plan.th, plan.tw, plan.bn,
        FK._ACT_CODE[MEGA_ACT.get(kind, "NONE")], INV_OUT, ALPHA, RES_SCALE,
        _stream(x.device)), "tat_megakernel_3x3")


def add_one(x: torch.Tensor) -> torch.Tensor:
    """E4: float32 ``x + 1``."""
    if x.dtype != torch.float32:
        raise ValueError(f"float32 expected, got {x.dtype}")
    dev = _device_of(x)
    if dev.type == "cpu":
        return add_one_plain(x)
    out = torch.empty_like(x)
    if x.numel():
        cuda_build.check(cuda_build.load_library().tat_add_one(
            x.data_ptr(), out.data_ptr(), x.numel(), _stream(dev)),
            "tat_add_one")
        launches["add_one"] += 1
    return out


def conv3x3_lagged(x: torch.Tensor, w: torch.Tensor,
                   bias: Optional[torch.Tensor], ep: FK.Epilogue,
                   lag: bool = True) -> torch.Tensor:
    """E2: the int8 3x3/s1 pad-1 conv of NHWC ``x [N, H, W, C]`` with OHWI
    ``w [O, 3, 3, C]``, ``bias [O]`` int32 or None and the serving
    epilogue ``ep`` -> int8 ``[N, H, W, O]``, every row. On the card the
    ``wgmma`` kernel whose two consumer warpgroups alternate tiles, each
    epilogue overlapping the other's product (``lag=True``), or both
    products then both epilogues in lockstep (``lag=False``), with the
    block :func:`lagged_plan` picks. C must be a multiple of 32 and O of 8
    (ValueError otherwise, on any device); nothing falls back."""
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[1:3]) != (3, 3):
        raise ValueError(f"x [N, H, W, C] and w [O, 3, 3, C] expected, got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    nb, h, wd, c = x.shape
    o = w.shape[0]
    if w.shape[3] != c:
        raise ValueError(f"C mismatch: x {tuple(x.shape)}, w {tuple(w.shape)}")
    if c == 0 or c % 32:
        raise ValueError(f"the lagged conv needs C % 32 == 0, got C={c}")
    if o == 0 or o % 8:
        raise ValueError(f"the lagged conv needs O % 8 == 0, got O={o}")
    dev = FK._check_operands(x, w, bias, ep, o)
    if dev.type == "cpu":
        return conv3x3_lagged_plain(x, w, bias, ep)
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("the lagged conv copies 16-byte units: x and w must "
                         "be 16-byte aligned")
    out = torch.empty((nb, h, wd, o), dtype=torch.int8, device=dev)
    if out.numel() == 0:
        return out
    _launch_lagged(x, w, bias, ep, out, lag,
                   lagged_plan(nb, h, wd, c, o, FK.smem_limits(dev)))
    launches["conv3x3_lagged"] += 1
    return out


def _launch_lagged(x, w, bias, ep, out, lag: bool, plan: LaggedPlan,
                   lib=None) -> None:
    """One launch of the lagged conv (``lag``: the mode) writing ``out``
    with the block ``plan``; ``lib``: a measurement build of the source
    (``cuda_build.load_variant``), else the library."""
    nb, h, wd, c = x.shape
    lib = lib or cuda_build.load_library()
    cuda_build.check(lib.tat_conv_int8_lagged(
        int(lag), x.data_ptr(), w.data_ptr(), FK._ptr(bias), ep.cs.data_ptr(),
        out.data_ptr(), nb, h, wd, c, w.shape[0], FK._kernel_act(ep.act),
        ep.inv_out, ep.alpha, plan.bn, plan.stages, plan.blocks,
        _stream(x.device)), "tat_conv_int8_lagged")


def lagged_occupancy(lag: bool, c: int, plan: LaggedPlan) -> Tuple[int, int]:
    """``(shared memory bytes, blocks an SM holds)`` of the lagged
    kernel of ``lag`` with ``plan`` on the current card
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    cuda_build.check(cuda_build.load_library().tat_conv_int8_lagged_info(
        int(lag), c, plan.bn, plan.stages, ctypes.byref(smem),
        ctypes.byref(blocks)), "tat_conv_int8_lagged_info")
    return smem.value, blocks.value
