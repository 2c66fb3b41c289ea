"""The kernels of the probes (``thingino_accel_tpu_torch.probes``): the
port's first tensor-core code, and the kernel rung of the health ladder.

- :func:`chain_mma`, E1 (``examples/mxu_ceiling_probe.py:build``): L
  chained ``[rows, K] x [K, K]`` products with the cheapest glue between
  them, in four variants (:data:`CHAIN_KINDS`), CUDA ``csrc/chain_mma.cu``
  on the ``wgmma`` row chain of ``csrc/chain_mma.cuh`` (rows resident in
  shared memory, weights by TMA);
- :func:`megakernel_chain`, E3 (``examples/megakernel_probe.py:build``):
  the same chain with the production requantize epilogue, the
  valid-shrink 3x3 chains and the C3 round (:data:`MEGA_KINDS`), CUDA
  ``csrc/megakernel_probe.cu``: the 1x1 kinds on E1's row chain, the 3x3
  kinds one launch of a ``wgmma`` stage kernel (slabs by TMA, E2's
  product) a stage, through scratch tensors that stay in L2;
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
import weakref
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
    """A row chain's block: ``bm`` rows (256: two consumer warpgroups of
    two m64 tiles; 128: two of one; 64: one, for bf16 rows that two
    buffers of 128 cannot hold), weight chunks of ``bn`` columns through
    ``wslots`` slots."""

    bm: int
    bn: int
    wslots: int


CHAIN_BMS = (256, 128, 64)
CHAIN_BNS = (128, 64, 32)
CHAIN_WSLOTS = (4, 3, 2)
# the row chain's glues: E1's variants and E3's 1x1 kinds ("int8" >> 7,
# "requant" the SILU/SILU_FAST/RELU requantize)
CHAIN_GLUES = CHAIN_KINDS + ("requant",)


def _row_bytes(kind: str, k: int) -> int:
    return 2 * k if kind in ("bf16", "bf16-3x3") else k


def chain_smem(kind: str, k: int, plan: ChainPlan) -> int:
    """Shared memory of a row chain (``row_chain_layout`` of
    chain_mma.cuh): two buffers of the block's rows in the operand type
    (bf16 for bf16 and mixed), ``wslots`` operand weight chunks, two raw
    chunks where the weights are converted in shared memory (int4w,
    mixed), the scales (requant), the mbarriers."""
    op = 2 * k if kind in ("bf16", "mixed") else k
    w = k // 2 if kind == "int4w" else _row_bytes(kind, k)
    cons = 2 if plan.bm > 64 else 1
    return (2 * plan.bm * op + plan.wslots * op * plan.bn
            + (2 * w * plan.bn if kind in ("int4w", "mixed") else 0)
            + (4 * k if kind == "requant" else 0)
            + 8 * (cons + 2 * plan.wslots + 2))


@functools.lru_cache(maxsize=64)
def chain_plans(kind: str, k: int, limits: FK.SmemLimits
                ) -> Tuple[ChainPlan, ...]:
    """Every block the row chain can run here within the shared memory, in
    the order :func:`chain_plan` prefers them: the most rows (each weight
    chunk read from L2 serves them all: 256, then 128, then 64 for bf16
    and mixed only), then the widest chunk (an m64 x bn wgmma reads its A
    rows once for bn columns), then the deepest ring."""
    plans = []
    for bm in CHAIN_BMS:
        if bm == 64 and kind not in ("bf16", "mixed"):
            continue
        for bn in CHAIN_BNS:
            for ws in CHAIN_WSLOTS:
                plan = ChainPlan(bm, bn, ws)
                wrow = k // 2 if kind == "int4w" else k
                if k % bn == 0 and wrow * bn % 1024 == 0 and \
                        chain_smem(kind, k, plan) <= limits.per_block:
                    plans.append(plan)
    return tuple(plans)


def chain_plan(kind: str, rows: int, k: int,
               limits: FK.SmemLimits) -> ChainPlan:
    """The first of :func:`chain_plans` whose blocks fill nine tenths of
    the SMs (one block an SM: more rows a block read fewer weight bytes
    from L2, but a half-empty wave costs more), else the first of the
    fewest rows a block; ValueError if none fits."""
    plans = chain_plans(kind, k, limits)
    if not plans:
        raise ValueError(f"no row-chain block fits {kind} K={k} in "
                         f"{limits.per_block} bytes of shared memory")
    for plan in plans:
        if -(-rows // plan.bm) >= 0.9 * limits.sms:
            return plan
    least = min(p.bm for p in plans)
    return next(p for p in plans if p.bm == least)


@dataclasses.dataclass(frozen=True)
class StagePlan:
    """E3's stage kernel's block: ``bn`` output channels (the wgmma's N),
    each tile's slab in chunks of ``kc`` bytes of K through ``stages``
    slots, the weights ``resident`` (all taps x K, once a block; ``kc`` is
    then the whole row) or streamed a tap of a chunk at a time through
    ``wslots`` slots, ``blocks`` persistent blocks a channel block walking
    the 8 x 8 output tiles."""

    bn: int
    kc: int
    stages: int
    resident: bool
    blocks: int
    wslots: int = 2


STAGE_TILE = 8          # 8 x 8 output pixels a tile: one m64 wgmma tile
STAGE_BNS = (128, 64, 32)
STAGE_STAGES = (4, 3, 2)
STAGE_WSLOTS = (4, 3, 2)   # streamed weight units in flight
# the stage kernel's epilogues (StageEp of megakernel_probe.cu)
EP_SHIFT, EP_REQUANT, EP_BF16, EP_RESIDUAL = 0, 1, 2, 3
_STAGE_EP = {"i8-shift-3x3": EP_SHIFT, "i8-rq-silu-3x3": EP_REQUANT,
             "bf16-3x3": EP_BF16}


def stage_plane(taps: int) -> int:
    """A slab's 16-byte plane: 10 x 10 pixels for the taps, 8 x 8 for the
    1x1, rounded up to 128 bytes."""
    side = STAGE_TILE + (2 if taps == 9 else 0)
    return -(-side * side * 16 // 128) * 128


def stage_smem(taps: int, row_bytes: int, bn: int, kc: int, stages: int,
               resident: bool, wslots: int = 2) -> int:
    """Shared memory of a stage-kernel block (``stage_layout`` of
    megakernel_probe.cu): the weights (resident: taps x row x bn bytes;
    streamed: ``wslots`` units of kc x bn), ``stages`` slab slots of
    kc / 16 planes, cs (4 bn bytes), the mbarriers."""
    w = taps * row_bytes * bn if resident else wslots * kc * bn
    return (w + stages * (kc // 16) * stage_plane(taps) + 4 * bn
            + 8 * (2 * stages + (1 if resident else 2 * wslots)))


def stage_tiles(taps: int, cells: int, e: int) -> int:
    """The 8 x 8 output tiles of a stage over extent ``e``."""
    eo = e - 2 if taps == 9 else e
    return cells * FK._cdiv(eo, STAGE_TILE) ** 2


@functools.lru_cache(maxsize=256)
def stage_plans(taps: int, row_bytes: int, k: int, tiles: int,
                limits: FK.SmemLimits) -> Tuple[StagePlan, ...]:
    """Every plan the stage kernel can run here within the shared memory,
    each with its persistent blocks, in the order :func:`stage_plan`
    prefers them: resident weights (read once a block) first, then the
    widest channel block (each slab is read K / bn times), the widest
    chunk, the deepest weight ring (streamed), the deepest slab ring."""
    plans = []
    for resident in (True, False):
        for bn in STAGE_BNS:
            if k % bn:
                continue
            kcs = ((row_bytes,) if resident else
                   tuple(row_bytes >> i for i in range(8)
                         if (row_bytes >> i) >= 32
                         and (row_bytes >> i) % 32 == 0
                         and row_bytes % (row_bytes >> i) == 0))
            for kc in kcs:
                for ws in ((2,) if resident else STAGE_WSLOTS):
                    for st in STAGE_STAGES:
                        smem = stage_smem(taps, row_bytes, bn, kc, st,
                                          resident, ws)
                        if smem > limits.per_block:
                            continue
                        plans.append(StagePlan(
                            bn, kc, st, resident,
                            lagged_blocks(tiles, k // bn, smem, limits), ws))
    return tuple(plans)


def stage_plan(taps: int, row_bytes: int, k: int, tiles: int,
               limits: FK.SmemLimits) -> StagePlan:
    """The first of :func:`stage_plans`; ValueError if none fits."""
    plans = stage_plans(taps, row_bytes, k, tiles, limits)
    if not plans:
        raise ValueError(f"no stage-kernel block fits K={k} ({row_bytes} "
                         f"bytes a pixel) in {limits.per_block} bytes of "
                         "shared memory")
    return plans[0]


def spatial_launches(kind: str, e0: int, l: int) -> Tuple[Tuple[int, ...],
                                                          ...]:
    """The stage kernel's launches of one application of a 3x3 kind, in
    order: ``(ep, taps, e)`` with ``e`` the launch's input extent (the C3
    round: its 1x1 then its taps, each stage)."""
    out = []
    for i in range(l):
        e = e0 - 2 * i
        if kind == "i8-c3-round":
            out += [(EP_REQUANT, 1, e), (EP_RESIDUAL, 9, e)]
        else:
            out.append((_STAGE_EP[kind], 9, e))
    return tuple(out)


def spatial_ops(kind: str, k: int, h: int, l: int, cells: int
                ) -> Tuple[float, float]:
    """``(computed, issued)`` operations of one application: each output
    pixel of each launch once (the probe's own count: no halo is computed
    again), and the m64 tiles' rows the tensor cores run (the rows of a
    ragged extent's last tiles included, their outputs masked)."""
    own = tiled = 0.0
    for _, taps, e in spatial_launches(kind, h + 2 * l, l):
        eo = e - 2 if taps == 9 else e
        t = FK._cdiv(eo, STAGE_TILE) * STAGE_TILE
        own += 2.0 * taps * k * k * eo * eo
        tiled += 2.0 * taps * k * k * t * t
    return own * cells, tiled * cells


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


def _stream(dev: torch.device) -> Optional[int]:
    """The current CUDA stream of ``dev``; None on the CPU (the CUDA shim's
    rehearsals pass host tensors to the launchers)."""
    return (torch.cuda.current_stream(dev).cuda_stream if dev.type == "cuda"
            else None)


def chain_mma(x: torch.Tensor, w: torch.Tensor, kind: str) -> torch.Tensor:
    """E1: ``x [rows, K]`` (int8; bf16 for ``"bf16"``) through L chained
    products with ``w [L, N=K, K]`` (int4w: uint8 ``[L, K, K/2]`` from
    :func:`pack_int4`) -> ``[rows, K]`` of x's type; on the card the
    ``wgmma`` row chain with the block :func:`chain_plan` picks, its
    weights tiled once (:func:`tile_weights`: change ``w`` only in place)."""
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


def _launch_chain(x, w, kind, out, plan: ChainPlan, lib=None) -> None:
    """One launch of E1's row chain of ``kind`` with the block ``plan``;
    ``lib``: another build of the kernels (the CUDA shim's), else the
    library."""
    lib = lib or cuda_build.load_library()
    cuda_build.check(lib.tat_chain_mma(
        _GLUE[kind], x.data_ptr(), tile_weights(w, plan.bn).data_ptr(),
        out.data_ptr(), x.shape[0],
        x.shape[1], w.shape[0], plan.bm, plan.bn, plan.wslots,
        _stream(x.device)), "tat_chain_mma")


def _launch_1x1(kind, x, w, cs, out, plan: ChainPlan, lib=None) -> None:
    """One launch of E3's 1x1 ``kind`` on the row chain (``w [L, 1, K,
    K]``) with the block ``plan``; ``lib`` as :func:`_launch_chain`'s."""
    act = MEGA_ACT.get(kind)
    lib = lib or cuda_build.load_library()
    cuda_build.check(lib.tat_megakernel_1x1(
        _GLUE_REQUANT if act else _GLUE["int8"], x.data_ptr(),
        tile_weights(w, plan.bn).data_ptr(),
        FK._ptr(cs), out.data_ptr(), x.shape[0], x.shape[1], w.shape[0],
        plan.bm, plan.bn, plan.wslots, FK._ACT_CODE[act] if act else 0,
        INV_OUT, ALPHA, _stream(x.device)), "tat_megakernel_1x1")


def chain_occupancy(kind: str, k: int, plan: ChainPlan) -> Tuple[int, int]:
    """``(shared memory bytes, blocks an SM holds)`` of the row chain of
    ``kind`` (one of :data:`CHAIN_GLUES`) with ``plan`` on the current
    card."""
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    lib = cuda_build.load_library()
    if kind in CHAIN_KINDS:
        rc = lib.tat_chain_mma_info(_GLUE[kind], k, plan.bm, plan.bn,
                                    plan.wslots, ctypes.byref(smem),
                                    ctypes.byref(blocks))
    else:   # the 1x1 entry's requantize
        rc = lib.tat_megakernel_1x1_info(
            _GLUE_REQUANT, k, plan.bm, plan.bn, plan.wslots,
            ctypes.byref(smem), ctypes.byref(blocks))
    cuda_build.check(rc, "row chain info")
    return smem.value, blocks.value


def megakernel_chain(kind: str, x: torch.Tensor, w, cs=None
                     ) -> torch.Tensor:
    """E3: one application of ``kind`` (shapes as
    :func:`megakernel_chain_plain`); ``cs`` the [K] float32 per-channel
    scale of the requantizing kinds. On the card the 1x1 kinds are one
    launch of the ``wgmma`` row chain with the block :func:`chain_plan`
    picks, the
    3x3 kinds one launch of the ``wgmma`` stage kernel a stage (the C3
    round two), each with the block :func:`stage_plan` picks
    (:func:`_run_spatial`); the launch count grows by the launches. The
    weights are tiled once (:func:`tile_weights`: change them only in
    place); the stages' scratch is one a shape and stream."""
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
        _launch_1x1(kind, x, w3, cs, out, chain_plan(
            "requant" if kind in MEGA_ACT else "int8", x.shape[0], k,
            limits))
        launches["megakernel_probe"] += 1
        return out
    h = x.shape[1] - 2 * l
    out = torch.empty((x.shape[0], h, h, k), dtype=dt, device=dev)
    launches["megakernel_probe"] += _run_spatial(kind, x, w1, w3, cs, out,
                                                 limits)
    return out


# each weight tensor's tiles (tile_weights), by id, with a weak reference
# that tells a live tensor from a later one at the same id
_TILED: Dict[int, tuple] = {}


def tile_weights(w: torch.Tensor, bn: int) -> torch.Tensor:
    """Weights ``[L, T, N, ...]`` or ``[L, N, ...]`` (T taps, 1 if absent;
    each output column's row of R bytes: K int8, 2 K bf16, K / 2 packed
    int4) as the kernels' shared-memory image of each chunk of ``bn``
    columns, uint8 ``[L, N / bn, T, R / 16, bn, 16]``: a chunk's planes of
    bn rows x 16 bytes, contiguous, so that TMA moves them in 128-byte rows.
    Made once a tensor, ``bn`` and version (``w._version``: an in-place
    change makes it again). A write that leaves the version as it was
    (through ``w.data`` or ``set_``) is not seen, and the kernels would
    read the old tiles: weights must not change underneath the cache that
    way."""
    ent = _TILED.get(id(w))
    if ent is None or ent[0]() is not w:
        for key in [k for k, v in _TILED.items() if v[0]() is None]:
            del _TILED[key]
        ent = _TILED[id(w)] = (weakref.ref(w), {})
    tiles = ent[1]
    for key in [k for k in tiles if k[1] != w._version]:
        del tiles[key]
    key = (bn, w._version)
    if key not in tiles:
        b = w.contiguous().view(torch.uint8)
        if b.dim() == 3:
            b = b.unsqueeze(1)
        l, t, n, r = b.shape
        if bn <= 0 or n % bn or r % 16:
            raise ValueError(f"the kernels' weight chunks of {bn} columns "
                             f"do not tile [{n}, {r} bytes] rows")
        tiles[key] = b.reshape(l, t, n // bn, bn, r // 16, 16).permute(
            0, 2, 1, 4, 3, 5).contiguous()
    return tiles[key]


# each shape's stage outputs between launches: two buffers that take turns
# and the C3 round's 1x1 output, allocated once a shape and stream (the
# applications on one stream run in turn; two streams get their own)
_SCRATCH: Dict[tuple, Tuple[torch.Tensor, ...]] = {}


def _scratch(kind: str, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    cells, e0, _, k = x.shape
    key = (x.device, _stream(x.device), x.dtype, cells, e0, k,
           kind == "i8-c3-round")
    if key not in _SCRATCH:
        n = cells * (e0 - 2) ** 2 * k
        _SCRATCH[key] = (
            torch.empty(n, dtype=x.dtype, device=x.device),
            torch.empty(n, dtype=x.dtype, device=x.device),
            torch.empty(cells * e0 * e0 * k if key[-1] else 0,
                        dtype=torch.int8, device=x.device))
    return _SCRATCH[key]


def _run_spatial(kind, x, w1, w3, cs, out, limits=None,
                 plan: Optional[StagePlan] = None, lib=None) -> int:
    """One application of the 3x3 ``kind`` through the stage kernel, one
    launch a stage (the C3 round two: its 1x1 over the whole extent into
    the scratch ``m``, then the taps with the residual), in order on the
    current stream; the activations between launches plane-major in the
    scratch tensors, ``x`` and the last stage's ``out [cells, H, H, K]``
    NHWC. Each launch takes ``plan``, or the one :func:`stage_plan` picks
    under ``limits``, and its weights tiled for its block
    (:func:`tile_weights`); ``lib``: another build of the kernels (the CUDA
    shim's), else the library. Returns the launches."""
    l, k = w3.shape[0], w3.shape[3]
    cells, e0 = x.shape[0], x.shape[1]
    row_bytes = _row_bytes(kind, k)
    ys = _scratch(kind, x)
    act = MEGA_ACT.get(kind, "NONE")
    steps = spatial_launches(kind, e0, l)
    cur = m = x
    for idx, (ep, taps, e) in enumerate(steps):
        stage = idx // 2 if kind == "i8-c3-round" else idx
        eo = e - 2 if taps == 9 else e
        p = plan or stage_plan(taps, row_bytes, k, stage_tiles(taps, cells, e),
                               limits)
        res = None
        if taps == 1:   # the C3 round's 1x1: x -> m
            src, w, dst = cur, tile_weights(w1, p.bn)[stage], \
                ys[2][:cells * e * e * k].view(cells, e, e, k)
            m = dst
        else:
            src = m if ep == EP_RESIDUAL else cur
            w = tile_weights(w3, p.bn)[stage]
            res = cur if ep == EP_RESIDUAL else None
            dst = out if idx == len(steps) - 1 else \
                ys[stage % 2][:cells * eo * eo * k].view(cells, eo, eo, k)
        _launch_stage(ep, taps, src, w, cs, res, dst, act, p,
                      src is not x, res is not None and res is not x,
                      dst is not out, lib)
        if taps == 9:
            cur = dst
    return len(steps)


def _launch_stage(ep: int, taps: int, x, w, cs, res, out, act: str,
                  plan: StagePlan, xpm: bool = False, rpm: bool = False,
                  opm: bool = False, lib=None) -> None:
    """One launch of the stage kernel: ``x [cells, e, e, K]`` with ``w``,
    the stage's weights as :func:`tile_weights` makes them for
    ``plan.bn``, into ``out`` with the epilogue ``ep`` (``act`` for the
    requantizing ones, ``res`` the C3 round's residual) and the block
    ``plan``; ``xpm``, ``rpm``, ``opm``: x, res, out plane-major
    (``[cells, row / 16, e, e, 16]`` bytes), else NHWC; ``lib``: another
    build of the kernels, else the library."""
    lib = lib or cuda_build.load_library()
    cuda_build.check(lib.tat_megakernel_3x3(
        ep, taps, x.data_ptr(), w.data_ptr(), FK._ptr(cs), FK._ptr(res),
        out.data_ptr(), int(xpm), int(rpm), int(opm), x.shape[0],
        x.shape[1], x.shape[3],
        FK._ACT_CODE[act], INV_OUT, ALPHA, RES_SCALE, plan.bn, plan.kc,
        plan.stages, int(plan.resident), plan.wslots, plan.blocks,
        _stream(x.device)), "tat_megakernel_3x3")


def stage_occupancy(ep: int, taps: int, k: int, plan: StagePlan
                    ) -> Tuple[int, int]:
    """``(shared memory bytes, blocks an SM holds)`` of the stage kernel
    of ``ep`` and ``taps`` with ``plan`` on the current card."""
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    cuda_build.check(cuda_build.load_library().tat_megakernel_3x3_info(
        ep, taps, k, plan.bn, plan.kc, plan.stages, int(plan.resident),
        plan.wslots, ctypes.byref(smem), ctypes.byref(blocks)),
        "tat_megakernel_3x3_info")
    return smem.value, blocks.value


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
