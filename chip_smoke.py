#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``thingino_accel_tpu_torch``)
on one NVIDIA GPU (built for Hopper, sm_90a).

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases:

1. Device: name, power limit, torch / CUDA / nvcc versions.
2. Build: compile the kernels in ``thingino_accel_tpu_torch/csrc/`` with
   nvcc, one process per source, all started together (timed); fail on a
   ptxas warning that it serialised a wgmma; count the IDP4A, IMMA,
   IGMMA, LDSM, LDGSTS and UTMALDG instructions of each kernel of the
   library (``cuobjdump -sass``): no kernel holds an IDP4A, the 1x1 GEMM,
   the KxK core, the fused bottleneck and the fused SPPF hold IMMA, and
   E2's kernel, E3's stage kernel and the probes' row chain hold IGMMA (the
   warpgroup MMA) and UTMALDG (TMA loads) and no IMMA.
3. Kernels vs their plain torch versions on the card at the paths'
   shapes (NONE, LEAKY_RELU and SILU, per-channel scales, residual modes;
   #3, which launches #1's tensor-core 1x1 GEMM
   ``csrc/mm_int8_fused_mma.cu``, at its lead shape in both scale
   branches, at the real yolov5n's K_i = 16 unit, SPPF's 4 parts, N = 255
   and with a residual; the fused C3 bottleneck #6
   (``csrc/bneck_int8_fused.cu``) and the fused SPPF #4
   (``csrc/sppf_int8_fused.cu``), both on the tensor cores, at their leads
   and at the gpu tests' edge shapes in every act (#4 also on inputs all
   below 0); the depthwise kernel #7 (``csrc/dw_int8_fused.cu``:
   a halo tile in shared memory, a window of taps in registers) at
   NanoDet's shapes, bit for bit (its SILU case within the bound); the head
   decode on the real yolov5n's heads at batch 16 and 1); median
   CUDA-event times of both. Then the ``[decode]`` table: #8 at batch 16
   and 1, its time, bound and share of the bound beside the time of the
   warp-per-unit kernel it replaced (``records/warp_decode.json``).
4. The main path: the planned serving tier (``Engine(precision=
   "serving")``) on the real-weight ``models/yolov5n_cal_int8.mars`` at
   640x640 through letterbox -> int8 quantize -> network -> decode (one
   kernel over the three heads) -> NMS inside the port's ``StreamServer``
   (depth 2), 4 batches of 16 uint8 1280x720 frames made from a seed, then
   12 more batches for steadier numbers. Checks: no failed batch; the
   launches of each conv kernel equal 4x its count in the plan's schedule,
   and the decode launches once per batch; finite detections inside the
   frame; every kernel unit of one batch (inputs captured on the card)
   against its plain version; one frame's letterbox on the card equal to
   the CPU's byte for byte, and its steps on the card against the CPU path
   (the path the tests hold against JAX); decode + NMS on
   tie-heavy heads, kernel decode vs plain decode. Prints the share of
   head values where the planned and the unplanned tier differ on the
   same batch. Then #5's path on that checked batch (see 10).
5. The unplanned tier (kept as the tests' oracle), 1 batch: one launch
   per conv, each conv teacher-forced kernel vs plain, one frame node by
   node against the CPU.
6. The zoo yolov5s at 640 (random weights from seed 0), planned, 2
   batches of 8: one SPPF launch per forward, every unit of both batches
   as one forward of 16 against its plain version; then #5's path on
   that checked forward (see 10).
7. The committed ``models/nanodet_320.mars`` (full width, 320x320,
   depthwise): letterbox -> int8 quantize -> network through
   ``StreamServer``, 4 batches of 16; launches per forward as the plan
   counts them (16 of #1, 1 of #2, 6 of #7; its 4 stride-2 depthwise
   convs are plain torch); every unit of one batch against its plain
   version; one frame's heads on the card against the CPU path. Then the
   depthwise table: each distinct #7 unit of that batch on its recorded
   input (equal to the unit's output), with its plan and blocks an SM, its
   time beside fp16 ``F.conv2d`` with groups = C and its bound, the time of
   the kernel it replaced (``records/dp4a_dw.json``) and the per-forward
   sums.
8. The exact tier (``Engine(precision="exact")``) on the zoo yolov5s at
   640 (random weights from seed 0, per-tensor scales): kernels #9, #10 and
   #11 against their plain versions at the model's lead shapes (both
   RoundModes, RELU after the clamp, dilation 2, stride (2, 1); #9, the 1x1
   GEMM ``csrc/mm_int8_fused_mma.cu`` under the exact epilogue, also with
   the SILU table, at K = 1024 -> N = 512 and at a head, N = 255); the
   tensor-core KxK kernel of #10 and #11 (``csrc/conv_int8_requant_mma.cu``)
   at the model's 11 distinct KxK convs (18 a forward) at batch 16, bit for
   bit, each timed beside fp16 ``F.conv2d`` and its bound, with its plan,
   mode and blocks an SM, the per-forward sums, and each one's split into
   epilogue, product and the rest (from builds without the epilogue's
   stores, without the product, without both); then
   letterbox -> int8 quantize -> network -> decode -> NMS through
   ``StreamServer`` (depth 2), 4 batches of 16 uint8 1280x720 frames:
   launches 4 x {#9: 42, #10: 11, #11: 7} plus one decode a batch and no
   plain conv, 85 steps a forward (each SILU in its conv's epilogue as a
   256-entry table, no step of its own); every conv of one batch against
   its plain version; one frame step by step on the card against the CPU
   path, every step and the heads bit for bit. Then the exact 1x1 table:
   each distinct #9 unit of that batch on its recorded input (equal to the
   unit's output), with its plan and blocks an SM, its time beside
   ``torch._int_mm`` and its bound, its split into epilogue, product and
   the rest (the ``GEMM_VARIANTS`` builds), the time of the dp4a kernel it
   replaced (``records/dp4a_exact_1x1.json``, which ran the SILU as a
   step of its own) and the per-forward sums.
9. #5 (``conv2d_int8_halo_fused(pipeline="dma")``), which launches the
   serving KxK kernel #2 launches (``csrc/conv_int8_fused_mma.cu``: the
   tensor-core core of ``csrc/conv_mma_core.cuh`` with the serving
   epilogue), at #2's lead shape, 16x80x80x128 -> 128, a 3x3/s2, the 6x6/s2
   stem and a ragged case: equal to its plain version and, through #2's
   entry, to itself bit for bit, timed beside #2's entry, the plain
   version and fp16 ``F.conv2d``.
10. Its path, inside phases 4 and 6: the batch of 16 whose units were
   just held against their plain versions, through the planned real
   yolov5n and the planned zoo yolov5s at 640; every KxK conv unit
   without a residual re-run on its recorded input through #5's entry
   (one launch each, no other kernel), equal to its plain version on that
   input (the tolerance below) and to the unit's output (#2's entry) bit
   for bit; the per-forward sums of both entries' times. No engine path
   routes to #5, as no JAX executor path runs the DMA variant. Beside it,
   inside phases 4, 6 and 7, the serving KxK table: every distinct #2
   unit of the planned real yolov5n, the planned zoo yolov5s and
   NanoDet-320 on its recorded input at batch 16, with its plan, mode and
   blocks an SM, its time and T/s beside fp16 ``F.conv2d`` and its bound,
   its split into epilogue, product and the rest (the ``KXK_VARIANTS``
   builds of the serving source), the real yolov5n's stem also at bn 32,
   and the per-forward sums. Beside it, inside phases 4-7, the 1x1 table:
   every distinct #1/#3 unit of the planned and unplanned real yolov5n,
   the planned zoo yolov5s and NanoDet-320 on its recorded input at batch
   16 (``gemm_table``), through its entry point, with its plan and blocks
   an SM, its time and T/s beside ``torch._int_mm`` (K concatenated) and
   its bound, its split into epilogue, product and the rest (the
   ``GEMM_VARIANTS`` builds), the dp4a kernels' time it replaced (a
   record of ``kxk_bench`` in the checkout that had them,
   ``thingino_accel_tpu_torch/records/dp4a_1x1.json``), and the
   per-forward sums. Beside it, inside phases 4 and 6, the bottleneck
   table (``[bneck]``): every distinct #6 unit of the planned real yolov5n
   and the planned zoo yolov5s on its recorded input at batch 16, equal to
   the unit's output and to the unfused tensor-core pair (#1 into device
   memory, then #2 with the shortcut) bit for bit, with its plan and
   blocks an SM, its time beside the pair's, fp16 ``F.conv2d`` of the KxK
   stage alone and its bound, the dp4a kernel's time it replaced
   (``records/dp4a_bneck.json``) and the per-forward sums; inside phase 6
   the SPPF table (``[sppf]``): the #4 unit likewise, beside #3's GEMM
   alone over the four levels (equal bit for bit) and ``torch._int_mm``
   over them, with ``records/dp4a_sppf.json``.
11. ``[probes]``: the ports of the TPU probes under ``examples/``
   (``thingino_accel_tpu_torch.probes``), the port's first tensor-core
   kernels. Each E1 variant (``csrc/chain_mma.cu``: the ``wgmma`` row chain
   of ``csrc/chain_mma.cuh``) and E3 kind (``csrc/megakernel_probe.cu``:
   the 1x1 kinds on the row chain, the 3x3 kinds on the ``wgmma`` stage
   kernel, a launch a stage) against its
   plain version at full width on 2 grid cells (the SILU kinds at L = 1
   too), and the 3x3 kinds also at a ragged H = 29, L = 2 (extents 33, 31,
   29); each again at its sweep's size (E1 grid 32, E3 GRID 16), so that
   the plans the sweeps time are the plans checked; then E1's sweep (m = 1024, L = 8, grid = 32, K = 128/256/512) and
   E3's (H = 32, L = 4, GRID = 16, K = 256/512) through their entry points
   and the ladder's kernel rung (E4, ``csrc/add_one.cu``) with the counts
   set to 0 before and read after; each kind's time beside its plain
   version's, the library chain's (the ``torch.matmul`` /
   ``torch._int_mm`` chains; for the 3x3 kinds L chained fp16
   ``F.conv2d`` 3x3, for the C3 round the fp16 library round at the
   probe's shapes), its bound (int8 over 1,979 TOP/s, bf16 over 989
   TFLOP/s, bytes over 3.35 TB/s) and the time of the ``mma.sync`` kernel
   it replaced (``records/mma_megakernel.json``, ``records/mma_chain.json``);
   for E3's 3x3 kinds the operations computed and the m64 tiles' over the
   probe's own (no halo computed twice), and the device's idle time
   between an application's kernels (each kernel's start less the
   previous one's end in a ``torch.profiler`` trace of chained
   applications behind a spin, the mean and spread of three traces); E1's ``_int_mm`` chain split into its L
   products and the glue between them; E4 by the chained timing beside
   chained ``torch.add``; both decision rules as they come out on this
   card; the health ladder, one line a rung, each rung in its own
   process.
12. ``[pipeline]``: E2, the lagged-epilogue 3x3 conv
   (``probe_kernels.conv3x3_lagged``, ``csrc/conv_int8_lagged.cu``: wgmma
   from TMA-loaded slabs, two consumer warpgroups), both modes (``LAG =
   1``: ping-pong, one warpgroup's epilogue of tile t while the other's
   product of tile t + 1 runs; ``LAG = 0``: both products, then both
   epilogues, in lockstep) at the experiment's 128x80x80x128 -> 128 SILU
   and NONE (its own
   seeded draws; against the plain version on 2 images, against #5 and #2
   on all 128), at a ragged 16x45x77x96 -> 72 LEAKY_RELU and a small
   3x17x9x32 -> 16 RELU (against all three on every image); then the
   probe's table at the experiment's shape
   (``probes.pipeline.run``: #2, #5, both modes, fp16 ``F.conv2d``, both
   modes at NONE, the lag's reading, both modes' blocks an SM) with the
   launch counts set to 0 before and read after, and beside it the
   ``mma.sync`` kernel's times it replaced (``records/mma_lagged.json``).
13. ``[fast]``: the fast tier, the JAX bench's default path, on the real
   yolov5n and the zoo yolov5s at 640 (``trace_path.fast_graph``: the stem
   rewritten to space-to-depth; the zoo's weights at w_scale 0.0005, its
   detect convs' biases zeroed): 4 batches of 16 frames through
   StreamServer (letterbox -> ``space_to_depth`` -> bf16 quantize -> the
   dequantized bf16 graph, convs in ``F.conv2d`` -> #8 on the bf16 heads
   -> NMS) with the counts set to 0 before and read after (#8's bf16
   counter once a batch, no other kernel); the serving tier on the same
   model and frames and the fast tier, 12 batches each in turns (serving,
   fast, fast, serving), fps and p50/p99 batch latency; the card's bf16
   heads within 2^-4 of the largest |head| of the CPU's float32 forward
   of the same graph on the first batch's 16 frames; on the real yolov5n
   the card's detections (IoU >= 0.9, same class) leave unmatched at
   most as many of the CPU float32 forward's as the CPU's own bf16
   forward does, plus three standard deviations, at conf 0.25 and 0.001
   (the zoo yolov5s's are printed, not held); #8's bf16 mode against its
   plain version on those heads at batch 16 and 1.

Each path is run with the launch counters set to 0 just before it and
read just after. Tolerances (as in ``tests/test_torch_fused_kernels.py``):
NONE/RELU/LEAKY_RELU bit-exact; SILU at most 1 quantum on at most 0.1% of
the elements (the kernel's ``expf`` and torch's sigmoid differ by ulps).
The exact tier bit for bit everywhere: its activations are tables built
on the host from the plain activation, so card and CPU read the same
bytes.
E2's lagged conv: as the fused kernels against its plain version, and
bit for bit against #5 and #2 (the same epilogue code).
The probes: int8 kinds bit-exact (SILU_FAST too), chained SILU kinds
within the SILU tolerance at L = 1 and at most 1% of the values apart at
full L, bf16 within 2^-7 of the largest output.
The head decode (int8, f32 and bf16 heads): classes exact, boxes within
rtol 1e-6 / atol 1e-5, conf within rtol 1e-6 / atol 1e-7, detections
after NMS equal.

Each kernel's line carries its time (``ms``, CUDA events), its plain
version's (``plain_ms``), the time of one PyTorch call computing the same
product or convolution (``library_ms``: ``torch._int_mm``, or
``F.conv2d`` in fp16 channels_last, a yardstick of time and not of
numbers; null where no single call exists) and its bound (``bound_ms``:
the larger of the bytes it must move over 3.35 TB/s and its int8
operations over 1,979 TOP/s, the H100 SXM's published peaks), at its
first case's shape.

Prints the kernels' JSON line, the card's ``name, power.limit`` line and,
as the last line, ``{"ok": true, "device": {...}}``. Any failure exits
non-zero without that line. It never falls back to the CPU. Writes the
detailed numbers to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent
MODEL = REPO / "models" / "yolov5n_cal_int8.mars"
NANODET = REPO / "models" / "nanodet_320.mars"
BATCHES, BATCH, FRAME_HW = 4, 16, (720, 1280)
ZOO_BATCHES, ZOO_BATCH = 2, 8
SILU_MAX_FRAC = 1e-3
PROBE_SILU_LOOSE = 1e-2   # share of a chained SILU probe's values apart
RAGGED_H = 29   # E3's ragged check: no extent a multiple of the 8 x 8 tile
PEAK_OPS, PEAK_BYTES = 1979e12, 3.35e12   # H100 SXM: int8 TOP/s, HBM B/s
PEAK_BF16 = 989e12                          # H100 SXM: bf16/fp16 TFLOP/s

# the planned real yolov5n: 60 convs in 50 launches (5 stem-stage convs
# and 20 others on #1/#2, 15 concat consumers on #3, 10 bottleneck pairs
# on #6); the zoo yolov5s adds the SPPF on #4
PLANNED_REAL = {"matmul_int8_fused": 17, "conv2d_int8_halo_fused": 8,
                "matmul_int8_fused_multi": 15, "bottleneck_int8_fused": 10,
                "sppf_int8_fused": 0, "depthwise_conv2d_int8_fused": 0}
PLANNED_ZOO_S = {"matmul_int8_fused": 14, "conv2d_int8_halo_fused": 7,
                 "matmul_int8_fused_multi": 16, "bottleneck_int8_fused": 11,
                 "sppf_int8_fused": 1, "depthwise_conv2d_int8_fused": 0}
# the unplanned real yolov5n: one launch per conv, 42 1x1 and 18 KxK
UNPLANNED_REAL = {"matmul_int8_fused": 42, "conv2d_int8_halo_fused": 18,
                  "matmul_int8_fused_multi": 0, "bottleneck_int8_fused": 0,
                  "sppf_int8_fused": 0, "depthwise_conv2d_int8_fused": 0}
# NanoDet-320: 17 convs and 10 depthwise convs in 23 launches (the 16 1x1
# on #1, the 3x3/s2 stem on #2, the 6 stride-1 depthwise on #7)
PLANNED_NANODET = {"matmul_int8_fused": 16, "conv2d_int8_halo_fused": 1,
                   "matmul_int8_fused_multi": 0, "bottleneck_int8_fused": 0,
                   "sppf_int8_fused": 0, "depthwise_conv2d_int8_fused": 6}
# the exact zoo yolov5s at 640: its 60 convs on #9 (1x1), #10 (3x3/s1)
# and #11 (the 6x6/s2 stem and six 3x3/s2), none on the plain op
EXACT_ZOO_S = {"matmul_int8_requant": 42, "conv2d_int8_halo": 11,
               "conv2d_int8": 7, "plain_convs": 0}
# the YOLO pipelines decode their three heads in one launch per batch;
# the fast tier's bf16 heads count under the bf16 counter
DECODE = "decode_and_parse_fused"
FAST_DECODE = "decode_and_parse_fused_bf16"
# the fast tier: its bf16 heads on the card within FAST_HEAD_TOL of the
# largest |head| of the CPU's float32 forward (8-16 bf16 ulps of it;
# tests/test_torch_fast.py holds the CPU's bf16 tier within 4 of JAX's),
# on the first FAST_CPU_FRAMES frames. The detection gate (IoU >= 0.9,
# same class, against the CPU's float32 detections) holds the models in
# FAST_DETS_GATED: the card leaves unmatched at most the count u the
# CPU's own bf16 forward leaves, plus 3 sqrt(2 max(u, 1)). Each bf16 run
# flips the detections that sit near a threshold, a count about Poisson
# of mean u, so that is three standard deviations of the difference of
# two such counts. The zoo yolov5s's random detector puts its boxes near
# the IoU threshold (two bf16 runs matched 0.18-0.23 of its detections):
# its shares are printed, and its heads are its gate.
FAST_HEAD_TOL = 2.0 ** -4
FAST_CPU_FRAMES = BATCH
FAST_MODELS = ("yolov5n", "yolov5s")
FAST_DETS_GATED = ("yolov5n",)
# #5, the same serving KxK kernel as #2 under its own counter: no engine
# path routes to it, as no JAX executor path runs
# conv2d_int8_folded(pipeline="dma"); its path is the replay of the planned
# models' KxK conv units through it
DMA = "conv2d_int8_halo_dma"
DMA_PATH = "planned yolov5n + zoo yolov5s 640, KxK units replayed"
KERNEL_INFO = {
    "matmul_int8_fused": {
        "source": "thingino_accel_tpu_torch/csrc/mm_int8_fused_mma.cu",
        "replaces": "thingino_accel_tpu/ops/fused_kernels.py:241"},
    "conv2d_int8_halo_fused": {
        "source": "thingino_accel_tpu_torch/csrc/conv_int8_fused_mma.cu",
        "replaces": "thingino_accel_tpu/ops/fused_kernels.py:544"},
    "matmul_int8_fused_multi": {
        "source": "thingino_accel_tpu_torch/csrc/mm_int8_fused_mma.cu",
        "replaces": "thingino_accel_tpu/ops/fused_kernels.py:361"},
    "bottleneck_int8_fused": {
        "source": "thingino_accel_tpu_torch/csrc/bneck_int8_fused.cu",
        "replaces": "thingino_accel_tpu/ops/fused_kernels.py:1241"},
    "sppf_int8_fused": {
        "source": "thingino_accel_tpu_torch/csrc/sppf_int8_fused.cu",
        "replaces": "thingino_accel_tpu/ops/fused_kernels.py:698"},
    "depthwise_conv2d_int8_fused": {
        "source": "thingino_accel_tpu_torch/csrc/dw_int8_fused.cu",
        "replaces": "thingino_accel_tpu/ops/fused_kernels.py:1397"},
    DECODE: {
        "source": "thingino_accel_tpu_torch/csrc/decode_fused.cu",
        "replaces": "thingino_accel_tpu/ops/decode_kernel.py:98"},
    FAST_DECODE: {
        "source": "thingino_accel_tpu_torch/csrc/decode_fused.cu",
        "replaces": "thingino_accel_tpu/ops/decode_kernel.py:98 "
                    "(bf16 heads, the fast tier's)"},
    "matmul_int8_requant": {
        "source": "thingino_accel_tpu_torch/csrc/mm_int8_fused_mma.cu",
        "replaces": "thingino_accel_tpu/ops/pallas_kernels.py:120"},
    "conv2d_int8_halo": {
        "source": "thingino_accel_tpu_torch/csrc/conv_int8_requant_mma.cu",
        "replaces": "thingino_accel_tpu/ops/pallas_kernels.py:216"},
    "conv2d_int8": {
        "source": "thingino_accel_tpu_torch/csrc/conv_int8_requant_mma.cu",
        "replaces": "thingino_accel_tpu/ops/pallas_kernels.py:300 "
                    "(_tapconv_call :388)"},
    DMA: {
        "source": "thingino_accel_tpu_torch/csrc/conv_int8_fused_mma.cu",
        "replaces": "thingino_accel_tpu/ops/fused_kernels.py:942 "
                    "(pipeline=\"dma\", _halo_kernel_dma :817)"},
}
# the TPU probes under examples/ (E1, E3, E4): off the system's paths, their
# path is the probes' own sweeps and the health ladder's kernel rung
PROBE_PATH = "probe E1/E3/E4"
PROBE_KERNELS = ("chain_mma", "megakernel_probe", "add_one")
KERNEL_INFO.update({
    "chain_mma": {
        "source": "thingino_accel_tpu_torch/csrc/chain_mma.cu",
        "replaces": "examples/mxu_ceiling_probe.py:103 (build :94)"},
    "megakernel_probe": {
        "source": "thingino_accel_tpu_torch/csrc/megakernel_probe.cu",
        "replaces": "examples/megakernel_probe.py:182 (pallas_calls :205, "
                    ":213, :236, :257)"},
    "add_one": {
        "source": "thingino_accel_tpu_torch/csrc/add_one.cu",
        "replaces": "examples/wedge_probe.py:59 (run_rung(\"pallas\"))"},
})
# E2, the lagged-epilogue conv: off the system's paths, its path is the
# probe's own table (probes.pipeline.run)
LAGGED = "conv3x3_lagged"
KERNEL_INFO[LAGGED] = {
    "source": "thingino_accel_tpu_torch/csrc/conv_int8_lagged.cu",
    "replaces": "examples/pipeline_experiment.py:71 lagged (_kernel :44, "
                "pallas_call :92)"}
# the KxK core under each epilogue policy (#10/#11's source, #2/#5's)
# built three more times, as measurement variants that no wrapper reaches:
# its epilogue storing nothing, without its product (ldmatrix, mma.sync),
# without either; phase 8 and the serving KxK table split each KxK conv's
# time by them
KXK_SOURCE = "conv_int8_requant_mma.cu"
SERVING_SOURCE = "conv_int8_fused_mma.cu"
KXK_VARIANTS = {
    "no_store": ("-DTAT_CONV_REQUANT_NO_STORE",),
    "no_product": ("-DTAT_CONV_REQUANT_NO_PRODUCT",),
    "neither": ("-DTAT_CONV_REQUANT_NO_STORE",
                "-DTAT_CONV_REQUANT_NO_PRODUCT")}
# the 1x1 GEMM of #1 and #3 built three more times the same way (its own
# macros); the 1x1 table splits each unit's time by them
GEMM_SOURCE = "mm_int8_fused_mma.cu"
GEMM_VARIANTS = {
    "no_store": ("-DTAT_GEMM_NO_STORE",),
    "no_product": ("-DTAT_GEMM_NO_PRODUCT",),
    "neither": ("-DTAT_GEMM_NO_STORE", "-DTAT_GEMM_NO_PRODUCT")}
# the dp4a kernels #1 and #3 ran before the 1x1 GEMM, each 1x1 unit timed by
# kxk_bench in the checkout that had them (a record, not this run's
# measurement), by the 1x1 table's path and unit; the same for #9's dp4a
# kernel (csrc/requant_int8.cu), #7's first port and the dp4a #6 and #4
RECORDS = REPO / "thingino_accel_tpu_torch" / "records"
DP4A_1X1 = RECORDS / "dp4a_1x1.json"
DP4A_EXACT_1X1 = RECORDS / "dp4a_exact_1x1.json"
DP4A_DW = RECORDS / "dp4a_dw.json"
DP4A_BNECK = RECORDS / "dp4a_bneck.json"
DP4A_SPPF = RECORDS / "dp4a_sppf.json"
# #8's warp-per-unit kernel and E2's mma.sync kernel before their redesign,
# timed by kxk_bench --what decode,lagged in the checkout that had them
WARP_DECODE = RECORDS / "warp_decode.json"
MMA_LAGGED = RECORDS / "mma_lagged.json"
# E1's and E3's mma.sync kernels before E3's redesign, one application by
# the chained timing (kxk_bench --what probes in the checkout that had them)
MMA_CHAIN = RECORDS / "mma_chain.json"
MMA_MEGAKERNEL = RECORDS / "mma_megakernel.json"
# kernels counted by a piece of their names: the 1x1 GEMM (#1, #3, #9),
# the KxK core (#2, #5, #10, #11), #7, the fused C3 bottleneck (#6) and
# SPPF (#4). The whole library must hold no IDP4A; every kernel but #7
# (per-channel products) must hold IMMA
NO_DP4A = ("mm_mma_kernel", "conv_mma_kernel", "dw_int8_fused_kernel",
           "bneck_mma_kernel", "sppf_mma_kernel", "conv_lagged_wgmma_kernel",
           "stage_wgmma_kernel", "row_chain_wgmma_kernel")
TENSOR_CORE = ("mm_mma_kernel", "conv_mma_kernel", "bneck_mma_kernel",
               "sppf_mma_kernel")
# E2's kernel, E3's stage kernel and the probes' row chain (E1, E3's 1x1
# kinds): the warpgroup MMA and TMA loads, no mma.sync
WGMMA = ("conv_lagged_wgmma_kernel", "stage_wgmma_kernel",
         "row_chain_wgmma_kernel")
# the edge shapes of tests/test_torch_gpu.py, each in every act: #6's
# (batch, H, W, C, CM, O, K, shortcut) and #4's (batch, H, W, C, O, k)
BNECK_EDGES = [(2, 13, 11, 32, 32, 32, 3, True),
               (1, 9, 20, 40, 80, 130, 3, False),
               (3, 7, 6, 6, 10, 6, 3, True),
               (1, 12, 9, 16, 16, 16, 5, True),
               (16, 20, 20, 128, 128, 128, 3, True)]
SPPF_EDGES = [(2, 6, 7, 36, 20, 5), (1, 9, 4, 10, 8, 3),
              (2, 12, 30, 33, 70, 5), (8, 20, 20, 256, 512, 5),
              (1, 20, 40, 32, 16, 5)]
# the instructions counted, by their SASS opcodes (dp4a is IDP.4A on sm_90)
SASS_OPS = {"IDP4A": r"IDP\.4A", "IMMA": r"IMMA", "IGMMA": r"IGMMA",
            "LDSM": r"LDSM", "LDGSTS": r"LDGSTS", "UTMALDG": r"UTMALDG"}
EXACT_ZOO_S_STEPS = 85   # 60 convs, 25 other nodes; no act step
DP4A_PATH = {"planned real yolov5n": "planned_yolov5n",
             "unplanned real yolov5n": "unplanned_yolov5n",
             "planned zoo yolov5s 640": "zoo_yolov5s",
             "planned nanodet 320": "nanodet"}
# the path whose run gives each kernel's launch count
PATH_OF = {k: "planned real yolov5n" for k in KERNEL_INFO}
PATH_OF["sppf_int8_fused"] = "planned zoo yolov5s 640"
PATH_OF["depthwise_conv2d_int8_fused"] = "planned nanodet 320"
for _k in ("matmul_int8_requant", "conv2d_int8_halo", "conv2d_int8"):
    PATH_OF[_k] = "exact zoo yolov5s 640"
PATH_OF[DMA] = DMA_PATH
for _k in PROBE_KERNELS:
    PATH_OF[_k] = PROBE_PATH
PATH_OF[LAGGED] = "probe E2"
PATH_OF[FAST_DECODE] = "fast real yolov5n"


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def compare(kernel_out, plain_out, act: str, what: str) -> int:
    """Max |kernel - plain| in quanta, after checking the tolerance."""
    import torch
    require(kernel_out.shape == plain_out.shape
            and kernel_out.dtype == plain_out.dtype == torch.int8,
            f"{what}: shape/dtype {tuple(kernel_out.shape)} "
            f"{kernel_out.dtype} vs {tuple(plain_out.shape)} {plain_out.dtype}")
    d = (kernel_out.to(torch.int32) - plain_out.to(torch.int32)).abs()
    dmax = int(d.max().item()) if d.numel() else 0
    frac = float((d > 0).to(torch.float64).mean().item()) if d.numel() else 0.0
    if act == "SILU":
        require(dmax <= 1 and frac <= SILU_MAX_FRAC,
                f"{what}: SILU mismatch max {dmax}, frac {frac}")
    else:
        require(dmax == 0, f"{what}: {act} not bit-exact (max {dmax}, "
                           f"frac {frac})")
    return dmax


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median of per-launch CUDA-event times, device synchronized around.
    The device spins for about 1 ms (``torch.cuda._sleep``) before the
    first event, so the host has enqueued the call's work by the time the
    device reaches it: the span is the device's time, not the wrapper's
    host time."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def note_err(results: dict, kernel: str, dmax) -> None:
    results[kernel]["max_abs_err"] = max(results[kernel]["max_abs_err"], dmax)


def bound(ops: float, nbytes: float, peak_ops: float = PEAK_OPS) -> tuple:
    """The least time the card could take (ms) and what bounds it;
    ``peak_ops``: the rate of the operations' type (int8 by default)."""
    t_ops, t_bytes = ops / peak_ops, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def conv_work(x, w, out, extra_bytes=0, groups=1) -> tuple:
    """(int8 operations, bytes) of a conv: x NHWC, w OHWI (depthwise:
    [KH, KW, C]), out NHWC; 4-byte bias and scale rows in ``extra``."""
    macs = out.numel() * (w.numel() // out.shape[-1] if groups == 1
                          else w.shape[0] * w.shape[1])
    return 2 * macs, x.numel() + w.numel() + out.numel() + extra_bytes


def library_ms(fn, label: str):
    """Time one PyTorch call computing the same product or convolution
    (never called by the port); None, with the reason printed, where the
    call refuses the case."""
    try:
        return time_ms(fn, 20)
    except Exception as e:   # a yardstick only: the kernel stands alone
        print(f"[kernels] library call for {label} refused: "
              f"{type(e).__name__}: {str(e).splitlines()[0][:200]}")
        return None


def int_mm_call(x2, w2):
    """``torch._int_mm`` over ``x [M, K] @ w [N, K]^T``: the product alone,
    no epilogue."""
    import torch
    wt = w2.t()
    return lambda: torch._int_mm(x2, wt)


def conv_fp16_call(x, w, stride, padding, dilation=(1, 1), groups=1):
    """``F.conv2d`` in fp16, channels_last, on the same shapes (a yardstick
    of time, not of numbers). ``w`` OHWI, or [KH, KW, C] for depthwise."""
    import torch
    import torch.nn.functional as F
    cl = torch.channels_last
    xh = x.permute(0, 3, 1, 2).half().contiguous(memory_format=cl)
    if w.dim() == 3:
        w = w.permute(2, 0, 1).unsqueeze(-1)   # [C, KH, KW, 1] OHWI
    wh = w.permute(0, 3, 1, 2).half().contiguous(memory_format=cl)
    return lambda: F.conv2d(xh, wh, None, stride, padding, dilation, groups)


def reset_launches() -> None:
    from thingino_accel_tpu_torch.ops import conv as C
    from thingino_accel_tpu_torch.ops import decode_kernel as DK
    from thingino_accel_tpu_torch.ops import fused_kernels as FK
    from thingino_accel_tpu_torch.ops import probe_kernels as PK
    from thingino_accel_tpu_torch.ops import requant_kernels as RK
    FK.reset_launches()
    DK.reset_launches()
    RK.reset_launches()
    PK.reset_launches()
    C.reset_counts()


def read_launches() -> dict:
    from thingino_accel_tpu_torch.ops import conv as C
    from thingino_accel_tpu_torch.ops import decode_kernel as DK
    from thingino_accel_tpu_torch.ops import fused_kernels as FK
    from thingino_accel_tpu_torch.ops import probe_kernels as PK
    from thingino_accel_tpu_torch.ops import requant_kernels as RK
    return {**FK.launches, **DK.launches, **RK.launches, **PK.launches,
            **C.counts}


def compare_decode(got, ref, what: str) -> float:
    """Kernel decode vs plain decode (boxes, conf, classes): classes
    exact, boxes within rtol 1e-6 / atol 1e-5, conf within rtol 1e-6 /
    atol 1e-7. Returns the max |diff| over boxes and conf."""
    import torch
    require(all(g.shape == r.shape and g.dtype == r.dtype
                for g, r in zip(got, ref)), f"{what}: shapes/dtypes differ")
    require(torch.equal(got[2], ref[2]), f"{what}: classes differ")
    dmax = 0.0
    for g, r, atol in ((got[0], ref[0], 1e-5), (got[1], ref[1], 1e-7)):
        require(torch.allclose(g, r, rtol=1e-6, atol=atol, equal_nan=True),
                f"{what}: values outside rtol 1e-6 / atol {atol}")
        dmax = max(dmax, float((g - r).abs().nan_to_num(0.0).max()))
    return dmax


def phase_device():
    import torch
    require(torch.cuda.is_available(),
            "torch.cuda.is_available() is false: this smoke test needs a "
            "CUDA device and never runs on the CPU")
    require(torch.cuda.device_count() >= 1, "no CUDA device")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    from thingino_accel_tpu_torch.ops import cuda_build
    nvcc = subprocess.run([cuda_build.find_nvcc(), "--version"],
                          capture_output=True, text=True, timeout=60)
    print(f"[device] {name} (count {torch.cuda.device_count()})")
    print(f"[device] nvidia-smi: {smi[0] if smi else 'n/a'}")
    print(f"[device] python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, torch CUDA {torch.version.cuda}, nvcc "
          f"{nvcc.stdout.strip().splitlines()[-1]}")
    return name, (smi[0] if smi else "n/a")


def phase_build() -> float:
    import threading
    from thingino_accel_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    variants = [threading.Thread(target=cuda_build.build,
                                 args=((src,), flags))
                for src, flag_sets in ((KXK_SOURCE, KXK_VARIANTS),
                                       (SERVING_SOURCE, KXK_VARIANTS),
                                       (GEMM_SOURCE, GEMM_VARIANTS))
                for flags in flag_sets.values()]   # beside the library
    for t in variants:
        t.start()
    cuda_build.load_library()
    for t in variants:
        t.join()
    secs = time.perf_counter() - t0
    import re
    log = cuda_build.library_path().with_suffix(".log").read_text()
    regs, spills = [], []
    # ptxas -v: a kernel's "Compiling entry function" line, then its spill
    # and register lines
    for name, body in re.findall(r"Compiling entry function '(\S+)'"
                                 r"(.*?)(?=Compiling entry|\Z)", log, re.S):
        used = re.search(r"Used (\d+) registers", body)
        spill = re.search(r"(\d+) bytes spill stores", body)
        regs.append(int(used.group(1)) if used else 0)
        if spill and int(spill.group(1)) > 0:
            spills.append(f"{name}: {spill.group(1)} bytes spilled")
    print(f"[build] {len(regs)} kernels, {min(regs, default=0)}-"
          f"{max(regs, default=0)} registers a thread; {len(spills)} spill:")
    for line in spills:
        print(f"[build]   {line}")
    serial = [ln for ln in log.splitlines()
              if "wgmma" in ln and "serializ" in ln]
    require(not serial, "ptxas serialised wgmma: " + " | ".join(serial[:3]))
    print(f"[build] ptxas: {sum('wgmma' in ln for ln in log.splitlines())} "
          f"lines name wgmma, none of them a serialisation")
    print(f"[build] {len(cuda_build.SOURCES)} sources built and loaded in "
          f"{secs:.3f} s")
    return secs


def sass_counts() -> dict:
    """``SASS_OPS`` counted in each kernel of the library
    (``cuobjdump -sass``, beside nvcc), summed by the ``NO_DP4A`` name
    pieces and over all kernels; fails if no kernel of a piece is found,
    if a ``TENSOR_CORE`` piece holds no IMMA, if a ``WGMMA`` piece holds no
    IGMMA, no UTMALDG or an IMMA, or if any kernel of the library holds an
    IDP4A:
    no kernel of the port runs dp4a."""
    import re
    from thingino_accel_tpu_torch.ops import cuda_build
    tool = Path(cuda_build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass",
                           str(cuda_build.library_path())],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts = {k: dict.fromkeys(SASS_OPS, 0) for k in NO_DP4A + ("all",)}
    found = dict.fromkeys(NO_DP4A, 0)
    for block in sass.split("Function : ")[1:]:
        name = block.split(maxsplit=1)[0]
        ops = {op: len(re.findall(r"\b" + pat + r"\b", block))
               for op, pat in SASS_OPS.items()}
        for piece in NO_DP4A + ("all",):
            if piece == "all" or piece in name:
                found[piece] = found.get(piece, 0) + 1
                for op in SASS_OPS:
                    counts[piece][op] += ops[op]
    for piece in NO_DP4A:
        require(found[piece] > 0, f"no kernel named *{piece}* in the SASS")
        require(piece not in TENSOR_CORE or counts[piece]["IMMA"] > 0,
                f"{piece}: no IMMA in the SASS")
        require(piece not in WGMMA or (counts[piece]["IGMMA"] > 0
                                       and counts[piece]["UTMALDG"] > 0
                                       and counts[piece]["IMMA"] == 0),
                f"{piece}: no IGMMA, no UTMALDG or an IMMA in the SASS")
        print(f"[build] SASS of the {found[piece]} {piece} kernels: "
              f"{counts[piece]}")
    print(f"[build] SASS of all {found['all']} kernels: {counts['all']}")
    require(counts["all"]["IDP4A"] == 0,
            f"{counts['all']['IDP4A']} IDP4A in the library's SASS")
    return {"kernels": found, "ops": counts}


def time_case(results, phase, kernel, label, act, kern, plain, work=None,
              library=None) -> dict:
    """One case of a kernel: its output against its plain version (the
    tolerance of ``act``), both timed. ``work(out)``: the case's (ops,
    bytes), for its bound; ``library``: one PyTorch call computing the
    same function, or None. A kernel's first case needs ``work``: its
    line in the JSON reports that case. Returns the case's record."""
    import torch
    first = not results[kernel]["cases"]
    out_k = kern()
    torch.cuda.synchronize()
    dmax = compare(out_k, plain(), act, f"{label} {act}")
    ms = time_ms(kern, 20)
    plain_ms = time_ms(plain, 5, warmup=1)
    case = {"case": f"{label} {act}", "ms": ms, "plain_ms": plain_ms,
            "max_abs_err": dmax}
    extra = ""
    if first or work is not None:
        case["bound_ms"], case["bound_by"] = bound(*work(out_k))
        case["library_ms"] = (library_ms(library, label)
                              if library is not None else None)
        extra = (f", bound {case['bound_ms']:.4f} ms ({case['bound_by']}), "
                 f"library {case['library_ms']}")
    results[kernel]["cases"].append(case)
    note_err(results, kernel, dmax)
    print(f"[{phase}] {kernel:24s} {label} {act}: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, max |diff| {dmax}{extra}")
    return case


def phase_kernels(results: dict) -> None:
    """Each kernel vs its plain version at the paths' shapes."""
    import numpy as np
    import torch
    from thingino_accel_tpu_torch.ops import fused_kernels as FK

    rng = np.random.default_rng(0)
    dev = torch.device("cuda")

    def rnd(shape):
        return torch.from_numpy(
            rng.integers(-128, 128, shape, dtype=np.int8)).to(dev)

    def bias_of(o):
        return torch.from_numpy(
            rng.integers(-2000, 2000, o).astype(np.int32)).to(dev)

    def wscale(o):
        return rng.uniform(0.005, 0.015, o).astype(np.float32)

    def ep_of(o, ktot, act):
        return FK.epilogue_rows(wscale(o), 0.01,
                                float(0.0137 * np.sqrt(ktot)), act, o,
                                device=dev)

    def run_case(*args):
        return time_case(results, "kernels", *args)

    # the 1x1 and KxK convs: (label, kernel, x shape, w OHWI shape, stride,
    # pad)
    cases = [
        ("1x1 M=8*80*80 K=64 N=64", "matmul_int8_fused",
         (8, 80, 80, 64), (64, 1, 1, 64), 1, 0),
        ("1x1 head M=16*80*80 K=64 N=255", "matmul_int8_fused",
         (16, 80, 80, 64), (255, 1, 1, 64), 1, 0),
        ("3x3/s1 8x80x80x64 -> 64", "conv2d_int8_halo_fused",
         (8, 80, 80, 64), (64, 3, 3, 64), 1, 1),
        ("3x3/s2 8x80x80x64 -> 128", "conv2d_int8_halo_fused",
         (8, 80, 80, 64), (128, 3, 3, 64), 2, 1),
        ("6x6/s2 stem 8x640x640x3 -> 16", "conv2d_int8_halo_fused",
         (8, 640, 640, 3), (16, 6, 6, 3), 2, 2),
    ]
    for label, kernel, xs, ws_shape, s, p in cases:
        nb, h, w, c = xs
        o, kk = ws_shape[0], ws_shape[1]
        oh, ow = (h + 2 * p - kk) // s + 1, (w + 2 * p - kk) // s + 1
        pads = ((p, p), (p, p))
        x, wt = rnd(xs), rnd(ws_shape)
        bias = bias_of(o)
        for act in ("NONE", "SILU"):
            ep = ep_of(o, kk * kk * c, act)
            work = (lambda out, x=x, wt=wt, o=o:
                    conv_work(x, wt, out, 8 * o))
            if kernel == "matmul_int8_fused":
                x2, w2 = x.reshape(-1, c), wt.reshape(o, c)
                run_case(kernel, label, act,
                         lambda: FK.matmul_int8_fused(x2, w2, bias, ep),
                         lambda: FK.matmul_int8_fused_plain(x2, w2, bias, ep),
                         work, int_mm_call(x2, w2))
            else:
                args = (x, wt, bias, ep, (oh, ow), pads, s)
                run_case(kernel, label, act,
                         lambda: FK.conv2d_int8_halo_fused(*args),
                         lambda: FK.conv2d_int8_halo_fused_plain(*args),
                         work, conv_fp16_call(x, wt, s, p))

    # residual modes of #1 and #2 (SILU: the C3 shortcut's activation)
    x = rnd((16, 80, 80, 32))
    res = rnd((16, 80, 80, 32))
    w1, w3 = rnd((32, 32)), rnd((32, 3, 3, 32))
    b = bias_of(32)
    ep = ep_of(32, 32, "SILU")
    x2, r2 = x.reshape(-1, 32), res.reshape(-1, 32)
    run_case("matmul_int8_fused", "1x1 + residual M=16*80*80 K=N=32", "SILU",
             lambda: FK.matmul_int8_fused(x2, w1, b, ep, r2, 0.05),
             lambda: FK.matmul_int8_fused_plain(x2, w1, b, ep, r2, 0.05))
    ep3 = ep_of(32, 288, "SILU")
    args = (x, w3, b, ep3, (80, 80), ((1, 1), (1, 1)), 1, res, 0.05)
    run_case("conv2d_int8_halo_fused", "3x3/s1 + residual 16x80x80x32",
             "SILU", lambda: FK.conv2d_int8_halo_fused(*args),
             lambda: FK.conv2d_int8_halo_fused_plain(*args))

    # multi-part matmul (#3, the 1x1 GEMM #1 launches): its lead, the C3
    # cv3 of model.4 (2 parts), in both scale branches first; then the real
    # yolov5n's K_i = 16 unit, SPPF's concat of 4 parts, N = 255 and a
    # residual. (label, rows, part widths, per-part scales, N, residual,
    # acts)
    lead = ("2 parts M=16*80*80 K=64+64 N=128", 16 * 80 * 80, (64, 64))
    for label, m, parts, per_part, n, with_res, acts in [
            (*lead, False, 128, False, ("NONE", "SILU")),
            (*lead, True, 128, False, ("NONE", "SILU")),
            ("2 parts M=16*160*160 K=16+16 N=32", 16 * 160 * 160, (16, 16),
             True, 32, False, ("SILU",)),
            ("4 parts M=16*20*20 K=4x128 N=256", 16 * 20 * 20, (128,) * 4,
             True, 256, False, ("SILU",)),
            ("2 parts M=16*80*80 K=64+64 N=255", 16 * 80 * 80, (64, 64),
             False, 255, False, ("NONE",)),
            ("2 parts M=16*80*80 K=32+32 N=64 + residual", 16 * 80 * 80,
             (32, 32), True, 64, True, ("RELU", "SILU"))]:
        xs = [rnd((m, k)) for k in parts]
        wfull = rnd((n, sum(parts)))
        ws, off = [], 0
        for k in parts:
            ws.append(wfull[:, off:off + k])
            off += k
        bias = bias_of(n)
        res = rnd((m, n)) if with_res else None
        xcat = torch.cat(xs, 1)
        scales = ((0.038, 0.046, 0.047, 0.049)[:len(parts)] if per_part
                  else (0.045,) * len(parts))
        for act in acts:
            me = FK.multi_epilogue(wscale(n), scales, 0.9, act, n,
                                   bias_scale=0.045, device=dev)
            require(me.same_scale != per_part, f"{label}: scale branch")
            branch = "per-part" if per_part else "equal"
            run_case("matmul_int8_fused_multi", f"{label}, {branch} scales",
                     act,
                     lambda: FK.matmul_int8_fused_multi(xs, ws, bias, me, res,
                                                        0.05),
                     lambda: FK.matmul_int8_fused_multi_plain(xs, ws, bias,
                                                              me, res, 0.05),
                     lambda out, m=m, k=sum(parts), n=n, r=res: (
                         2 * m * k * n, m * k + n * k + 8 * n + out.numel()
                         + (r.numel() if r is not None else 0)),
                     int_mm_call(xcat, wfull))

    # bottleneck: model.4's pair with its shortcut, a neck pair without.
    # No single library call computes 1x1 -> act -> 3x3 [+ x]; fp16
    # F.conv2d of the 3x3 stage alone is kept as a note
    for label, (nb, h, w, c), shortcut in [
            ("16x80x80x32 shortcut", (16, 80, 80, 32), True),
            ("16x40x40x64 no shortcut", (16, 40, 40, 64), False)]:
        x = rnd((nb, h, w, c))
        w1, w2 = rnd((c, c)), rnd((c, 3, 3, c))
        b1, b2 = bias_of(c), bias_of(c)
        for act in ("NONE", "SILU"):
            args = (x, w1, b1, ep_of(c, c, act), w2, b2,
                    ep_of(c, 9 * c, act), shortcut, 0.05)
            case = run_case(
                "bottleneck_int8_fused", label, act,
                lambda: FK.bottleneck_int8_fused(*args),
                lambda: FK.bottleneck_int8_fused_plain(*args),
                lambda out, x=x, w1=w1, w2=w2, c=c: (
                    2 * out.numel() // out.shape[-1] * (c * c + w2.numel()),
                    x.numel() + w1.numel() + w2.numel() + 16 * c
                    + out.numel()))
            case["stage3x3_fp16_ms"] = library_ms(
                conv_fp16_call(x, w2, 1, 1), f"{label} 3x3 stage")
            print(f"[kernels] bottleneck {label} {act}: fp16 F.conv2d of "
                  f"the 3x3 stage alone {case['stage3x3_fp16_ms']}")

    # SPPF of the zoo yolov5s at 640: 20x20x256, k = 5 -> 512
    x = rnd((8, 20, 20, 256))
    wt = rnd((512, 1024))
    bias = bias_of(512)
    for act in ("NONE", "SILU"):
        ep = ep_of(512, 1024, act)
        run_case("sppf_int8_fused", "8x20x20x256 k5 -> 512", act,
                 lambda: FK.sppf_int8_fused(x, wt, bias, ep, 5),
                 lambda: FK.sppf_int8_fused_plain(x, wt, bias, ep, 5),
                 lambda out: (2 * out.numel() * 1024,
                              x.numel() + wt.numel() + 8 * 512
                              + out.numel()))   # no single library call

    # #6 and #4 at the edge shapes of the gpu tests, each act (the
    # shortcut where the act takes one), against their plain versions
    for nb, h, w, c, cm, o, k, sc in BNECK_EDGES:
        x, w1, w2 = rnd((nb, h, w, c)), rnd((cm, c)), rnd((o, k, k, cm))
        b1, b2 = bias_of(cm), bias_of(o)
        for act in ("NONE", "RELU", "LEAKY_RELU", "SILU"):
            args = (x, w1, b1, ep_of(cm, c, act), w2, b2,
                    ep_of(o, k * k * cm, act), sc and act != "LEAKY_RELU",
                    0.05)
            note_err(results, "bottleneck_int8_fused", compare(
                FK.bottleneck_int8_fused(*args),
                FK.bottleneck_int8_fused_plain(*args), act,
                f"bottleneck {nb}x{h}x{w}x{c} -> {cm} -> {k}x{k} {o}"))
    for nb, h, w, c, o, k in SPPF_EDGES:
        x, wt, bias = rnd((nb, h, w, c)), rnd((o, 4 * c)), bias_of(o)
        xneg = -(x.to(torch.int32).abs().clamp(1, 128)).to(torch.int8)
        for act in ("NONE", "RELU", "LEAKY_RELU", "SILU"):
            ep = ep_of(o, 4 * c, act)
            for xi in (x, xneg):
                note_err(results, "sppf_int8_fused", compare(
                    FK.sppf_int8_fused(xi, wt, bias, ep, k),
                    FK.sppf_int8_fused_plain(xi, wt, bias, ep, k), act,
                    f"SPPF {nb}x{h}x{w}x{c} k{k} -> {o}"))
    print(f"[kernels] #6 at {len(BNECK_EDGES)} and #4 at {len(SPPF_EDGES)} "
          "edge shapes (#4 also all below 0), each act: within tolerance")

    # depthwise 3x3/s1 at NanoDet's batch-16 shapes (its LEAKY_RELU), a
    # SILU case and a C % 4 != 0 case (byte path)
    for shape, act in [((16, 40, 40, 96), "LEAKY_RELU"),
                       ((16, 10, 10, 384), "LEAKY_RELU"),
                       ((16, 20, 20, 192), "SILU"),
                       ((16, 40, 40, 37), "LEAKY_RELU")]:
        nb, h, w, c = shape
        x, wt, bias = rnd(shape), rnd((3, 3, c)), bias_of(c)
        ep = FK.epilogue_rows(wscale(c), 0.01, 0.05, act, c, device=dev)
        args = (x, wt, bias, ep, (h, w), ((1, 1), (1, 1)))
        run_case("depthwise_conv2d_int8_fused",
                 "3x3/s1 {}x{}x{}x{}".format(*shape), act,
                 lambda: FK.depthwise_conv2d_int8_fused(*args),
                 lambda: FK.depthwise_conv2d_int8_fused_plain(*args),
                 lambda out, x=x, wt=wt, c=c: conv_work(x, wt, out, 8 * c,
                                                        groups=c),
                 conv_fp16_call(x, wt, 1, 1, groups=c))

    # head decode on the real yolov5n's heads (int8, 3 levels, per-head
    # scales) at batch 16 and at batch 1
    from thingino_accel_tpu_torch.models import yolo as Y
    from thingino_accel_tpu_torch.ops import decode_kernel as DK
    for nb in (16, 1):
        heads = [rnd((nb, hw, hw, 255)) for hw in (80, 40, 20)]
        scales = [0.047, 0.051, 0.063]
        got = DK.decode_and_parse_fused(heads, scales=scales)
        torch.cuda.synchronize()
        dmax = compare_decode(got, Y.decode_and_parse(heads, scales=scales),
                              f"decode batch {nb}")
        ms = time_ms(lambda: DK.decode_and_parse_fused(heads, scales=scales),
                     20)
        plain_ms = time_ms(lambda: Y.decode_and_parse(heads, scales=scales),
                           5, warmup=1)
        label = f"3 heads {nb}x(80,40,20)^2x255 int8"
        case = {"case": label, "ms": ms, "plain_ms": plain_ms,
                "max_abs_err": dmax}
        # bytes only: the heads read once, boxes/conf/class written once;
        # no single library call decodes
        case["bound_ms"], case["bound_by"] = bound(0, sum(
            h.numel() for h in heads) + sum(
            t.numel() * t.element_size() for t in got))
        case["library_ms"] = None
        results[DECODE]["cases"].append(case)
        note_err(results, DECODE, dmax)
        print(f"[kernels] {DECODE:24s} {label}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, max |diff| {dmax:.3g}")
    decode_table(results)


def decode_table(results: dict) -> None:
    """The ``[decode]`` lines: #8 at batch 16 and 1 on the real yolov5n's
    heads (phase 3's cases), its time, bound and share of the bound beside
    the warp-per-unit kernel's recorded time (``WARP_DECODE``)."""
    record = json.loads(WARP_DECODE.read_text())
    for case in results[DECODE]["cases"]:
        old = record["ms"].get(case["case"])
        case["warp_recorded_ms"] = old
        case["bound_share"] = case["bound_ms"] / case["ms"]
        print(f"[decode] {case['case']}: kernel {case['ms']:.4f} ms, bound "
              f"{case['bound_ms']:.4f} ms ({case['bound_by']}), "
              f"{100 * case['bound_share']:.1f}% of the bound; the "
              f"warp-per-unit kernel (recorded, {record['device']}) {old} ms")


def check_units(eng, x, results: dict, what: str) -> list:
    """Every kernel unit of one planned forward (inputs captured on the
    card) against its plain version on the same inputs; returns the
    record, (unit, inputs, output) a unit."""
    from thingino_accel_tpu_torch.runtime.executor import KERNEL_OF_KIND
    rec = eng.capture(x)
    for unit, reads, out in rec:
        env = dict(eng.params)
        env.update(reads)
        plain = unit.compute(env, plain=True)
        dmax = compare(out, plain, unit.act, f"{what} {unit!r}")
        note_err(results, KERNEL_OF_KIND[unit.kind], dmax)
    return rec


def check_postprocess_on_card(dev, results: dict) -> int:
    """Decode + NMS over seeded int8 heads drawn from a few values, so
    that scores tie and boxes coincide: the decode kernel then NMS on the
    card, vs the plain decode then NMS on the card, and vs both on the CPU
    (the path the tests hold against JAX): valid masks and classes equal,
    boxes within 1e-4 px, scores within 1e-6 relative."""
    import numpy as np
    import torch
    from thingino_accel_tpu_torch.models import yolo as Y
    from thingino_accel_tpu_torch.ops import decode_kernel as DK

    rng = np.random.default_rng(11)
    heads = []
    for hw in (80, 40, 20):
        h = rng.integers(-2, 3, (BATCH, hw, hw, 3, 85)).astype(np.int8) * 8
        h[..., 4] = rng.choice([16, 40, 127], (BATCH, hw, hw, 3))
        heads.append(torch.from_numpy(h.reshape(BATCH, hw, hw, 255)))
    card = [h.to(dev) for h in heads]
    dec = {"kernel": DK.decode_and_parse_fused(card, scales=[0.05] * 3),
           "plain": Y.decode_and_parse(card, scales=[0.05] * 3),
           "cpu": Y.decode_and_parse(heads, scales=[0.05] * 3)}
    note_err(results, DECODE, compare_decode(dec["kernel"], dec["plain"],
                                             "tie-heavy decode"))
    res = {k: Y.nms_batched(*v, max_dets=100, pre_nms=128, topk_group=8)
           for k, v in dec.items()}
    r = res["cpu"]
    for k in ("kernel", "plain"):
        g = res[k]
        require(torch.equal(g.valid.cpu(), r.valid),
                f"NMS valid masks differ ({k} decode)")
        require(torch.equal(g.classes.cpu(), r.classes),
                f"NMS classes differ ({k} decode)")
        require(torch.allclose(g.boxes.cpu(), r.boxes, rtol=0, atol=1e-4),
                f"NMS boxes differ ({k} decode)")
        require(torch.allclose(g.scores.cpu(), r.scores, rtol=1e-6,
                               atol=1e-12), f"NMS scores differ ({k} decode)")
    return int(r.num.sum())


def check_letterbox_on_card(frame_u8, target):
    """The letterbox of one frame, card vs CPU byte for byte (the CPU's
    equals the JAX letterbox at the camera sizes, tests/test_torch_yolo.py);
    returns the card's int8 network input."""
    import torch
    from thingino_accel_tpu_torch.models import yolo as Y
    frame = torch.from_numpy(frame_u8)
    boxed = Y.letterbox_uint8(frame.cuda(), target)
    d = (boxed.cpu().to(torch.int32)
         - Y.letterbox_uint8(frame, target).to(torch.int32)).abs()
    require(int(d.max()) == 0, f"letterbox card vs CPU: {int((d > 0).sum())}"
                               f" bytes differ, max {int(d.max())}")
    return Y.quantize_input_int8(boxed)


def check_steps_against_cpu(eng, x) -> int:
    """One frame through the planned schedule on the card, each step held
    against the same step on the CPU path (plain kernels and torch ops,
    the path the tests hold against JAX) on the card's own inputs: SILU
    units within the SILU tolerance, every other step bit-exact."""
    from thingino_accel_tpu_torch.runtime.engine import Engine, EngineOptions
    from thingino_accel_tpu_torch.runtime.executor import KernelUnit
    cpu = Engine.from_yolo_mars(str(MODEL), EngineOptions(precision="serving"),
                                device="cpu")
    steps, cpu_steps = eng._fn.steps, cpu._fn.steps
    require(len(steps) == len(cpu_steps), "card and CPU schedules differ")
    env = dict(eng.params)
    env[eng.input_names[0]] = x
    for step, cstep in zip(steps, cpu_steps):
        require(step.out == cstep.out, f"step {step.out} vs {cstep.out}")
        step.run(env)
        cenv = dict(cpu.params)
        cenv.update({r: env[r].cpu() for r in step.reads})
        cstep.run(cenv)
        act = step.act if isinstance(step, KernelUnit) else "NONE"
        compare(env[step.out].cpu(), cenv[step.out], act,
                f"card vs CPU {step.out}")
    return len(steps)


def check_nodes_against_cpu(eng, x) -> int:
    """The unplanned tier on one frame: every node held against the CPU
    path on the card's own inputs."""
    from thingino_accel_tpu_torch.runtime.engine import Engine, EngineOptions
    acts = eng.trace(x)
    cpu = Engine.from_yolo_mars(str(MODEL), EngineOptions(precision="serving"),
                                device="cpu", planned=False)
    for node in cpu._fn.nodes:
        env = dict(cpu.params)
        env.update({i: acts[i].cpu() for i in node.inputs if i in acts})
        cpu._fn.lower_node(node, env)
        act = (node.attrs.get("activation", "NONE")
               if node.op == "CONV2D" else "NONE")
        for o in node.outputs:
            compare(acts[o].cpu(), env[o], act, f"card vs CPU {node.op} {o}")
    return len(cpu._fn.nodes)


def check_detections(outs, target) -> list:
    import torch
    from thingino_accel_tpu_torch.models import yolo as Y
    dets_per_frame = []
    for d in outs:
        require(d.boxes.shape == (BATCH, 100, 4), f"boxes {d.boxes.shape}")
        require(bool(torch.isfinite(d.boxes).all())
                and bool(torch.isfinite(d.scores).all()), "non-finite dets")
        v = d.valid
        require(bool(((d.scores >= 0.25) | ~v).all()), "valid below conf")
        require(bool(((d.classes >= 0) & (d.classes < 80) | ~v).all()),
                "class out of range")
        b = Y.scale_boxes_to_original(d.boxes, FRAME_HW, target)
        require(bool(((b[..., 2] >= b[..., 0]) & (b[..., 3] >= b[..., 1])
                      | ~v).all()), "inverted box")
        require(bool(((b[..., 0::2] <= FRAME_HW[1] - 1).all(-1)
                      & (b[..., 1::2] <= FRAME_HW[0] - 1).all(-1)
                      & (b >= 0).all(-1)).all()), "box outside the frame")
        dets_per_frame.extend(d.num.tolist())
    return dets_per_frame


def expect_launches(counts: dict, per_forward: dict, forwards: int,
                    what: str, decodes: int = 0) -> None:
    """Each conv kernel ``forwards`` times its count per forward; the head
    decode ``decodes`` times; every other counter 0."""
    want = {k: 0 for k in counts}
    want.update({k: forwards * v for k, v in per_forward.items()})
    want[DECODE] = decodes
    require(counts == want, f"{what}: launches {counts}, expected {want}")


def frames_of(n_batches: int):
    import numpy as np
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, (BATCH,) + FRAME_HW + (3,), dtype=np.uint8)
            for _ in range(n_batches)]


def phase_slice(results: dict) -> dict:
    """The main path: the planned real yolov5n through StreamServer."""
    import numpy as np
    import torch
    from thingino_accel_tpu_torch.models import yolo as Y
    from thingino_accel_tpu_torch.runtime.engine import Engine, EngineOptions
    from thingino_accel_tpu_torch.runtime.serving import StreamServer

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    eng = Engine.from_yolo_mars(str(MODEL), EngineOptions(precision="serving"),
                                device=dev)
    census = eng._fn.launch_census()
    require(census == PLANNED_REAL,
            f"planned real yolov5n schedule {census}, expected {PLANNED_REAL}")
    print(f"[slice] planned engine on {dev} in {time.perf_counter() - t0:.3f}"
          f" s: {len(eng._fn.units)} kernel units per forward {census}")
    pipe = Y.build_serving_pipeline(eng)
    frames = frames_of(BATCHES)

    # warm-up outside the counted run (allocator and library first use)
    pipe(torch.from_numpy(frames[0]).to(dev))
    torch.cuda.synchronize()

    reset_launches()
    server = StreamServer(pipe, depth=2, device=dev)
    outs = list(server.run(frames))
    torch.cuda.synchronize()
    counts = read_launches()
    st = server.stats
    require(len(outs) == BATCHES, f"{len(outs)} results for {BATCHES} batches")
    require(all(o is not None for o in outs) and st.errors == 0,
            f"failed batches: errors={st.errors}")
    expect_launches(counts, census, BATCHES, "planned real yolov5n",
                    decodes=BATCHES)
    for name in KERNEL_INFO:
        if PATH_OF[name] == "planned real yolov5n":
            require(counts[name] > 0, f"{name} never launched on the path")
            results[name]["launches"] = counts[name]
    print(f"[slice] launches {counts} (= {BATCHES} x the plan's census, "
          "one decode per batch)")

    in_t = eng.graph.tensors[eng.input_names[0]]
    target = (in_t.shape[1], in_t.shape[2])
    dets_per_frame = check_detections(outs, target)
    print(f"[slice] 4-batch run: {st.summary()}")
    print(f"[slice] detections per frame: mean "
          f"{float(np.mean(dets_per_frame))}, min {min(dets_per_frame)}, "
          f"max {max(dets_per_frame)}")

    steady = StreamServer(pipe, depth=2, device=dev)
    for o in steady.run(frames[i % BATCHES] for i in range(12)):
        require(o is not None, "failed batch in the steady run")
    print(f"[slice] 12-batch steady run: {steady.stats.summary()}")

    x = Y.quantize_input_int8(
        Y.letterbox_uint8(torch.from_numpy(frames[0]).to(dev), target))
    rec = check_units(eng, x, results, "real yolov5n")
    n_units = len(rec)
    print(f"[slice] kernel vs plain on every unit of one batch: {n_units} "
          "units within tolerance")
    dma = replay_dma(eng, rec, results, "planned real yolov5n")
    table = serving_kxk_table(eng, rec, "planned real yolov5n")
    gemm = gemm_table(eng, planned_gemm_units(eng, rec),
                      "planned real yolov5n")
    bneck = bneck_table(eng, rec, "planned real yolov5n")
    x1 = check_letterbox_on_card(frames[0][:1], target)
    n_steps = check_steps_against_cpu(eng, x1)
    print(f"[slice] card vs CPU, one frame: {n_steps} planned steps within "
          "tolerance")
    n_dets = check_postprocess_on_card(dev, results)
    print(f"[slice] decode + NMS on tie-heavy heads: kernel decode == plain "
          f"decode on the card == CPU ({n_dets} detections)")

    # planned vs unplanned tier on the same batch (PERF.md open question)
    unplanned = Engine.from_yolo_mars(
        str(MODEL), EngineOptions(precision="serving"), device=dev,
        planned=False)
    hp, hu = eng.forward(x), unplanned.forward(x)
    diff = [(hp[k].to(torch.int32) - hu[k].to(torch.int32)).abs()
            for k in eng.output_names]
    n_vals = sum(d.numel() for d in diff)
    share = sum(int((d > 0).sum()) for d in diff) / n_vals
    dmax = max(int(d.max()) for d in diff)
    print(f"[slice] planned vs unplanned heads, one batch: {share:.4f} of "
          f"{n_vals} values differ, max |diff| {dmax}")
    return {
        "launches": counts, "census_per_forward": census,
        "fps_4batch": st.fps, "p50_ms_4batch": st.latency_ms(50),
        "p99_ms_4batch": st.latency_ms(99), "fps_steady": steady.stats.fps,
        "p50_ms_steady": steady.stats.latency_ms(50),
        "p99_ms_steady": steady.stats.latency_ms(99),
        "dets_per_frame_mean": float(np.mean(dets_per_frame)),
        "units_checked": n_units, "steps_card_vs_cpu": n_steps,
        "planned_vs_unplanned_head_share": share,
        "planned_vs_unplanned_head_max": dmax, "dma_replay": dma,
        "serving_kxk": table, "gemm": gemm, "bneck": bneck,
    }


def phase_unplanned(results: dict) -> dict:
    """The unplanned tier, kept as the tests' oracle: 1 batch."""
    import torch
    from thingino_accel_tpu_torch.models import yolo as Y
    from thingino_accel_tpu_torch.runtime.engine import Engine, EngineOptions
    from thingino_accel_tpu_torch.runtime.serving import StreamServer

    dev = torch.device("cuda")
    eng = Engine.from_yolo_mars(str(MODEL), EngineOptions(precision="serving"),
                                device=dev, planned=False)
    pipe = Y.build_serving_pipeline(eng)
    frames = frames_of(1)
    pipe(torch.from_numpy(frames[0]).to(dev))
    torch.cuda.synchronize()
    reset_launches()
    server = StreamServer(pipe, depth=2, device=dev)
    outs = list(server.run(frames))
    torch.cuda.synchronize()
    counts = read_launches()
    require(len(outs) == 1 and outs[0] is not None
            and server.stats.errors == 0, "the unplanned batch failed")
    expect_launches(counts, UNPLANNED_REAL, 1, "unplanned real yolov5n",
                    decodes=1)
    in_t = eng.graph.tensors[eng.input_names[0]]
    target = (in_t.shape[1], in_t.shape[2])
    check_detections(outs, target)
    print(f"[unplanned] 1 batch: {server.stats.summary()}; launches {counts}")

    x = Y.quantize_input_int8(
        Y.letterbox_uint8(torch.from_numpy(frames[0]).to(dev), target))
    acts = eng.trace(x)
    n_conv = 0
    for node in eng._fn.nodes:
        if node.op != "CONV2D":
            continue
        env = dict(eng.params)
        env[node.inputs[0]] = acts[node.inputs[0]]
        eng._fn.lower_node(node, env, plain=True)
        out = node.outputs[0]
        a = node.attrs
        kernel = ("matmul_int8_fused" if a["kernel"] == (1, 1)
                  and a["stride"] == (1, 1) else "conv2d_int8_halo_fused")
        dmax = compare(acts[out], env[out], a.get("activation", "NONE"),
                       f"unplanned teacher-forced {out}")
        note_err(results, kernel, dmax)
        n_conv += 1
    torch.cuda.synchronize()
    gemm = gemm_table(eng, [
        ("matmul", n, eng._fn.epilogues[n.outputs[0]],
         [acts[n.inputs[0]].shape[-1]], 1.0, acts, [n.inputs[0]], None, None)
        for n in eng._fn.nodes if n.op == "CONV2D"
        and n.attrs["kernel"] == (1, 1) and n.attrs["stride"] == (1, 1)],
        "unplanned real yolov5n")
    n_nodes = check_nodes_against_cpu(eng, check_letterbox_on_card(
        frames[0][:1], target))
    print(f"[unplanned] teacher-forced kernel vs plain: {n_conv} convs; "
          f"card vs CPU, one frame: {n_nodes} nodes within tolerance")
    return {"launches": counts, "fps": server.stats.fps,
            "teacher_forced_convs": n_conv, "nodes_card_vs_cpu": n_nodes,
            "gemm": gemm}


def phase_zoo_s(results: dict) -> dict:
    """The zoo yolov5s at 640, planned: the path that runs SPPF."""
    import numpy as np
    import torch
    from thingino_accel_tpu_torch.models import zoo
    from thingino_accel_tpu_torch.runtime.engine import Engine, EngineOptions

    dev = torch.device("cuda")
    eng = Engine(zoo.build_yolov5("s", zoo.ZooConfig(in_hw=(640, 640))),
                 EngineOptions(precision="serving"), device=dev)
    census = eng._fn.launch_census()
    require(census == PLANNED_ZOO_S,
            f"planned zoo yolov5s schedule {census}, expected {PLANNED_ZOO_S}")
    rng = np.random.default_rng(1)
    xs = [torch.from_numpy(rng.integers(-128, 128, (ZOO_BATCH, 640, 640, 3),
                                        dtype=np.int8)).to(dev)
          for _ in range(ZOO_BATCHES)]
    eng.forward(xs[0])
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    outs = [eng.forward(x) for x in xs]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_launches()
    expect_launches(counts, census, ZOO_BATCHES, "planned zoo yolov5s")
    require(counts["sppf_int8_fused"] == ZOO_BATCHES,
            "SPPF must launch once per forward")
    results["sppf_int8_fused"]["launches"] = counts["sppf_int8_fused"]
    for out in outs:
        for k, h in out.items():
            want = (ZOO_BATCH,) + tuple(eng.graph.tensors[k].shape[1:])
            require(tuple(h.shape) == want and h.dtype == torch.int8,
                    f"zoo yolov5s head {k}: {tuple(h.shape)} {h.dtype}")
    # both batches as one of 16 frames, the batch of the KxK replay
    rec = check_units(eng, torch.cat(xs), results, "zoo yolov5s")
    n_units = len(rec)
    print(f"[zoo-s] 2 batches of {ZOO_BATCH} in {secs:.3f} s (host clock, "
          f"synchronized); launches {counts}; {n_units} units of both "
          "batches as one forward within tolerance")
    dma = replay_dma(eng, rec, results, "planned zoo yolov5s 640")
    table = serving_kxk_table(eng, rec, "planned zoo yolov5s 640")
    gemm = gemm_table(eng, planned_gemm_units(eng, rec),
                      "planned zoo yolov5s 640")
    bneck = bneck_table(eng, rec, "planned zoo yolov5s 640")
    sppf = sppf_table(eng, rec)
    return {"launches": counts, "census_per_forward": census,
            "forward_s_2_batches": secs, "units_checked": n_units,
            "dma_replay": dma, "serving_kxk": table, "gemm": gemm,
            "bneck": bneck, "sppf": sppf}


def phase_nanodet(results: dict) -> dict:
    """The committed NanoDet-320 (depthwise), planned, through
    StreamServer: letterbox -> int8 quantize -> network -> heads."""
    import numpy as np
    import torch
    from thingino_accel_tpu_torch.models import yolo as Y
    from thingino_accel_tpu_torch.runtime.engine import Engine, EngineOptions
    from thingino_accel_tpu_torch.runtime.serving import StreamServer

    dev = torch.device("cuda")
    serving = EngineOptions(precision="serving")
    eng = Engine.from_mars(str(NANODET), serving, device=dev)
    census = eng._fn.launch_census()
    require(census == PLANNED_NANODET,
            f"planned nanodet schedule {census}, expected {PLANNED_NANODET}")
    in_t = eng.graph.tensors[eng.input_names[0]]
    target = (in_t.shape[1], in_t.shape[2])

    def pipe(frames_u8):
        return eng.forward(Y.quantize_input_int8(
            Y.letterbox_uint8(frames_u8, target)))

    frames = frames_of(BATCHES)
    pipe(torch.from_numpy(frames[0]).to(dev))
    torch.cuda.synchronize()
    reset_launches()
    server = StreamServer(pipe, depth=2, device=dev)
    outs = list(server.run(frames))
    torch.cuda.synchronize()
    counts = read_launches()
    st = server.stats
    require(len(outs) == BATCHES and all(o is not None for o in outs)
            and st.errors == 0, f"failed nanodet batches: errors={st.errors}")
    expect_launches(counts, census, BATCHES, "planned nanodet")
    results["depthwise_conv2d_int8_fused"]["launches"] = \
        counts["depthwise_conv2d_int8_fused"]
    for out in outs:
        for k, h in out.items():
            want = (BATCH,) + tuple(eng.graph.tensors[k].shape[1:])
            require(tuple(h.shape) == want and h.dtype == torch.int8,
                    f"nanodet head {k}: {tuple(h.shape)} {h.dtype}")
    print(f"[nanodet] planned engine: {len(eng._fn.units)} kernel units per "
          f"forward {census}; {st.summary()}; launches {counts}")

    x = Y.quantize_input_int8(
        Y.letterbox_uint8(torch.from_numpy(frames[0]).to(dev), target))
    rec = check_units(eng, x, results, "nanodet")
    n_units = len(rec)
    table = serving_kxk_table(eng, rec, "planned nanodet 320")
    gemm = gemm_table(eng, planned_gemm_units(eng, rec),
                      "planned nanodet 320")
    dw = dw_table(eng, rec)
    cpu = Engine.from_mars(str(NANODET), serving, device="cpu")
    card, ref = eng.run(x[:1]), cpu.run(x[:1].cpu())
    for k in eng.output_names:
        compare(card[k].cpu(), ref[k], "NONE", f"nanodet head {k} card vs CPU")
    spread = min(len(np.unique(ref[k].numpy())) for k in ref)
    print(f"[nanodet] kernel vs plain on every unit of one batch: {n_units} "
          f"units within tolerance; one frame's heads on the card == CPU "
          f"(min {spread} distinct values per head)")
    return {"launches": counts, "census_per_forward": census,
            "fps_4batch": st.fps, "p50_ms_4batch": st.latency_ms(50),
            "p99_ms_4batch": st.latency_ms(99), "units_checked": n_units,
            "serving_kxk": table, "gemm": gemm, "dw": dw}


def phase_exact_kernels(results: dict) -> dict:
    """Kernels #9-#11 against their plain versions, bit for bit, at the
    exact zoo yolov5s's lead shapes at batch 16, then #9 with the SILU
    table at its lead, at SPPF's cv2 (K = 1024 -> N = 512) and at a head
    (N = 255), both RoundModes and RELU on one shape each, one dilation-2
    case and one stride-(2, 1) case (only #11 takes those two; no model
    here reaches them); then :func:`exact_kxk_table`, whose numbers it
    returns."""
    import numpy as np
    import torch
    from thingino_accel_tpu_torch.ops import requant_kernels as RK
    from thingino_accel_tpu_torch.ops.quant import RoundMode
    from thingino_accel_tpu_torch.runtime.executor import act_table

    rng = np.random.default_rng(4)
    dev = torch.device("cuda")
    half, trunc = RoundMode.HALF_AWAY, RoundMode.PLUS_HALF_TRUNC

    def rnd(shape):
        return torch.from_numpy(
            rng.integers(-128, 128, shape, dtype=np.int8)).to(dev)

    # (kernel, label, x shape, OHWI w shape, stride, dilation, pads,
    # round mode, relu[, the act of the conv's table])
    cases = [
        ("matmul_int8_requant", "1x1 16x80x80x128 -> 128",
         (16, 80, 80, 128), (128, 1, 1, 128), (1, 1), (1, 1), 0, half, False),
        ("conv2d_int8_halo", "3x3/s1 16x40x40x128 -> 128",
         (16, 40, 40, 128), (128, 3, 3, 128), (1, 1), (1, 1), 1, half, False),
        ("conv2d_int8", "6x6/s2 stem 16x640x640x3 -> 32",
         (16, 640, 640, 3), (32, 6, 6, 3), (2, 2), (1, 1), 2, half, False),
        ("conv2d_int8", "3x3/s2 16x80x80x128 -> 256",
         (16, 80, 80, 128), (256, 3, 3, 128), (2, 2), (1, 1), 1, half, False),
        ("matmul_int8_requant", "1x1 16x80x80x128 -> 128",
         (16, 80, 80, 128), (128, 1, 1, 128), (1, 1), (1, 1), 0, half, False,
         "SILU"),
        ("matmul_int8_requant", "1x1 SPPF cv2 16x20x20x1024 -> 512",
         (16, 20, 20, 1024), (512, 1, 1, 1024), (1, 1), (1, 1), 0, half,
         False, "SILU"),
        ("matmul_int8_requant", "1x1 head 16x80x80x128 -> 255",
         (16, 80, 80, 128), (255, 1, 1, 128), (1, 1), (1, 1), 0, half,
         False),
        ("conv2d_int8_halo", "3x3/s1 16x40x40x128 -> 128",
         (16, 40, 40, 128), (128, 3, 3, 128), (1, 1), (1, 1), 1, trunc,
         False, "SILU"),
        ("matmul_int8_requant", "1x1 16x80x80x128 -> 128",
         (16, 80, 80, 128), (128, 1, 1, 128), (1, 1), (1, 1), 0, trunc,
         True),
        ("conv2d_int8_halo", "3x3/s1 16x40x40x128 -> 128",
         (16, 40, 40, 128), (128, 3, 3, 128), (1, 1), (1, 1), 1, trunc,
         False),
        ("conv2d_int8", "3x3/s2 16x80x80x128 -> 256",
         (16, 80, 80, 128), (256, 3, 3, 128), (2, 2), (1, 1), 1, half, True),
        ("conv2d_int8", "3x3/s1 dilation 2 16x40x40x128 -> 128",
         (16, 40, 40, 128), (128, 3, 3, 128), (1, 1), (2, 2), 2, half, False),
        ("conv2d_int8", "3x3 stride (2,1) 16x40x40x64 -> 64",
         (16, 40, 40, 64), (64, 3, 3, 64), (2, 1), (1, 1), 1, trunc, False),
    ]
    for kernel, label, xs, ws, st, dil, p, rm, relu, *act in cases:
        x, wt = rnd(xs), rnd(ws)
        o, kh, kw, c = ws
        bias = torch.from_numpy(
            rng.integers(-3000, 3000, o).astype(np.int32)).to(dev)
        out_hw = tuple((xs[1 + i] + 2 * p - (ws[1 + i] - 1) * dil[i] - 1)
                       // st[i] + 1 for i in range(2))
        pads = ((p, p), (p, p))
        args = (x, wt, bias, out_hw, st, dil, pads, 0.05, 0.01,
                float(0.0137 * np.sqrt(kh * kw * c)), rm, relu)
        lut = act_table(act[0], args[9]).to(dev) if act else None
        require(RK.route((kh, kw), st, dil, pads) == kernel,
                f"{label} routes to {RK.route((kh, kw), st, dil, pads)}")
        if kernel == "matmul_int8_requant":
            library = int_mm_call(x.reshape(-1, c), wt.reshape(o, c))
        else:
            library = conv_fp16_call(x, wt, st, p, dil)
        # the exact convs are compared bit for bit ("NONE")
        time_case(results, "exact", kernel,
                  f"{label} {rm.name}{' relu' if relu else ''}"
                  f"{' + ' + act[0] + ' table' if act else ''}", "NONE",
                  lambda args=args, t=lut: RK.conv2d_int8(*args, lut=t),
                  lambda args=args, t=lut: RK.conv2d_int8(*args, plain=True,
                                                          lut=t),
                  lambda out, x=x, wt=wt, o=o, t=lut: conv_work(
                      x, wt, out, 4 * o + (256 if t is not None else 0)),
                  library)
    return exact_kxk_table(rng, results)


def exact_kxk_table(rng, results: dict) -> dict:
    """The tensor-core KxK kernel behind #10 and #11 at the 11 distinct KxK
    convs of the exact zoo yolov5s at 640 (18 a forward), batch 16, each
    with its SILU table as on the path: each
    bit for bit against its plain version, its median event time beside
    fp16 channels-last ``F.conv2d``'s and its bound, T/s, plan, mode and
    blocks an SM, and its split: the times of the same plan in the
    ``KXK_VARIANTS`` builds (built beside the library in phase 2, reached
    by no wrapper), whence the epilogue's share (1 - no_store / kernel),
    the product's (1 - no_product / kernel) and the rest, copies and
    syncs and the im2col build (neither); the per-forward sums of #10 and
    #11."""
    import numpy as np
    import torch
    from thingino_accel_tpu_torch.models import zoo
    from thingino_accel_tpu_torch.ops import cuda_build
    from thingino_accel_tpu_torch.ops import fused_kernels as FK
    from thingino_accel_tpu_torch.ops import requant_kernels as RK
    from thingino_accel_tpu_torch.ops.quant import RoundMode
    from thingino_accel_tpu_torch.runtime.executor import act_table

    dev = torch.device("cuda")
    variants = {name: cuda_build.load_variant(
        KXK_SOURCE, flags, ("tat_conv_int8_requant_mma",))
        for name, flags in KXK_VARIANTS.items()}
    rows = []
    for k in RK.kxk_convs(zoo.build_yolov5("s", zoo.ZooConfig())):
        x = torch.from_numpy(rng.integers(-128, 128, (BATCH, k.h, k.w, k.c),
                                          dtype=np.int8)).to(dev)
        wt = torch.from_numpy(rng.integers(
            -128, 128, (k.o,) + k.ksize + (k.c,), dtype=np.int8)).to(dev)
        bias = torch.from_numpy(
            rng.integers(-3000, 3000, k.o).astype(np.int32)).to(dev)
        cs_args = (0.05, 0.01, float(0.0137 * np.sqrt(
            k.ksize[0] * k.ksize[1] * k.c)))
        args = (x, wt, bias, (k.oh, k.ow), k.stride, k.dilation, k.pads,
                *cs_args)
        lut = act_table("SILU", cs_args[2]).to(dev)
        label = (f"{k.ksize[0]}x{k.ksize[1]}/s{k.stride[0]} {BATCH}x{k.h}x"
                 f"{k.w}x{k.c} -> {k.o}")
        mode = RK.conv_mode(x, wt)
        plan = RK.conv_requant_plan(BATCH, k.oh, k.ow, k.c, k.o, *k.ksize,
                                    k.stride, k.dilation, mode,
                                    FK.smem_limits(dev))
        out = RK.conv2d_int8(*args, lut=lut)
        torch.cuda.synchronize()
        dmax = compare(out, RK.conv2d_int8(*args, plain=True, lut=lut),
                       "NONE", f"kxk {label}")
        note_err(results, k.kernel, dmax)
        ms = time_ms(lambda: RK.conv2d_int8(*args, lut=lut), 20)
        lib = library_ms(conv_fp16_call(x, wt, k.stride, k.pads[0][0],
                                        k.dilation), label)
        ops, nbytes = conv_work(x, wt, out, 4 * k.o + 256)
        bms, side = bound(ops, nbytes)
        _, blocks = RK.conv_occupancy(plan, k.c, k.ksize, k.stride,
                                      k.dilation)
        row = {"kernel": k.kernel, "conv": label, "count": k.count, "ms": ms,
               "library_ms": lib, "bound_ms": bms, "bound_by": side,
               "tops": ops / ms / 1e9, "plan": dataclasses.asdict(plan),
               "mode": mode, "blocks_per_sm": blocks, "max_abs_err": dmax}
        cs = RK.combined_scale(*cs_args)
        row["split_ms"] = {}
        for name, vlib in variants.items():
            def bare(vlib=vlib, x=x, wt=wt, bias=bias, k=k, plan=plan, cs=cs,
                     o=out, lut=lut):
                cuda_build.check(vlib.tat_conv_int8_requant_mma(
                    *RK._conv_args(x, wt, bias, cs, k.stride, k.dilation,
                                   k.pads, RoundMode.HALF_AWAY, False,
                                   torch.empty_like(o), plan, lut),
                    torch.cuda.current_stream(dev).cuda_stream),
                    f"tat_conv_int8_requant_mma ({name})")
            row["split_ms"][name] = time_ms(bare, 20)
        row["epilogue_share"] = 1 - row["split_ms"]["no_store"] / ms
        row["product_share"] = 1 - row["split_ms"]["no_product"] / ms
        rows.append(row)
        print(f"[exact] kxk {k.kernel:16s} {label} x{k.count}: kernel "
              f"{ms:.4f} ms, F.conv2d fp16 {lib} ms, bound {bms:.4f} ms "
              f"({side}), {row['tops']:.1f} T/s, {mode} {plan.tile_h}x"
              f"{plan.tile_w} bn {plan.bn} ck {plan.ck} tpb "
              f"{plan.tiles_per_block}{' resident' if plan.resident else ''}, "
              f"{blocks} blocks/SM; split: epilogue "
              f"{row['epilogue_share']:.3f}, product "
              f"{row['product_share']:.3f}, without both "
              f"{row['split_ms']['neither']:.4f} ms")
    sums = {}
    for kernel in ("conv2d_int8_halo", "conv2d_int8"):
        mine = [r for r in rows if r["kernel"] == kernel]
        sums[kernel] = {
            "convs": sum(r["count"] for r in mine),
            **{key: sum(r["count"] * r[key] for r in mine)
               for key in ("ms", "library_ms", "bound_ms")}}
        print(f"[exact] per forward, {kernel} ({sums[kernel]['convs']} "
              f"convs): kernel {sums[kernel]['ms']:.4f} ms, F.conv2d fp16 "
              f"{sums[kernel]['library_ms']:.4f} ms, bound "
              f"{sums[kernel]['bound_ms']:.4f} ms")
    require(sum(v["convs"] for v in sums.values()) == 18,
            "the exact zoo yolov5s has 18 KxK convs a forward")
    return {"rows": rows, "per_forward": sums}


def check_exact_steps_against_cpu(eng, cpu, x) -> tuple:
    """One frame through the exact schedule on the card, each step held
    against the same step on the CPU path (the path the tests hold
    against JAX) on the card's own inputs, bit for bit: the convs with
    their activation tables, and every other step. Returns the number of
    steps and the share of head values where the card's forward and the
    CPU's differ end to end, with the largest difference."""
    import torch
    steps, cpu_steps = eng._fn.steps, cpu._fn.steps
    require(len(steps) == len(cpu_steps), "card and CPU schedules differ")
    env = dict(eng.params)
    env[eng.input_names[0]] = x
    for step, cstep in zip(steps, cpu_steps):
        require(step.out == cstep.out, f"step {step.out} vs {cstep.out}")
        cenv = dict(cpu.params)   # the reads first: an ActStep overwrites
        cenv.update({r: env[r].cpu() for r in step.reads})
        step.run(env)
        cstep.run(cenv)
        compare(env[step.out].cpu(), cenv[step.out], "NONE",
                f"card vs CPU {step.out}")
    card, ref = eng.run(x), cpu.run(x.cpu())
    diff = [(card[k].cpu().to(torch.int32) - ref[k].to(torch.int32)).abs()
            for k in eng.output_names]
    n_vals = sum(d.numel() for d in diff)
    share = sum(int((d > 0).sum()) for d in diff) / n_vals
    return len(steps), share, max(int(d.max()) for d in diff)


def phase_exact(results: dict) -> dict:
    """The exact tier's pipeline: the zoo yolov5s at 640 through
    StreamServer, letterbox -> int8 quantize -> network (#9-#11, each SiLU
    a table in its conv's epilogue) -> decode (#8) -> NMS; then
    :func:`exact_1x1_table` on the checked batch."""
    import numpy as np
    import torch
    from thingino_accel_tpu_torch.models import yolo as Y
    from thingino_accel_tpu_torch.models import zoo
    from thingino_accel_tpu_torch.runtime.engine import Engine, EngineOptions
    from thingino_accel_tpu_torch.runtime.serving import StreamServer

    dev = torch.device("cuda")
    g = zoo.build_yolov5("s", zoo.ZooConfig())
    exact = EngineOptions(precision="exact")
    t0 = time.perf_counter()
    eng = Engine(g, exact, device=dev)
    census = eng._fn.launch_census()
    require(census == EXACT_ZOO_S,
            f"exact zoo yolov5s census {census}, expected {EXACT_ZOO_S}")
    require(len(eng._fn.steps) == EXACT_ZOO_S_STEPS,
            f"{len(eng._fn.steps)} exact steps, expected {EXACT_ZOO_S_STEPS}")
    print(f"[exact] engine on {dev} in {time.perf_counter() - t0:.3f} s: "
          f"{len(eng._fn.steps)} steps, {len(eng._fn.units)} kernel units "
          f"per forward {census}")
    pipe = Y.build_serving_pipeline(eng)
    frames = frames_of(BATCHES)
    pipe(torch.from_numpy(frames[0]).to(dev))
    torch.cuda.synchronize()

    reset_launches()
    server = StreamServer(pipe, depth=2, device=dev)
    outs = list(server.run(frames))
    torch.cuda.synchronize()
    counts = read_launches()
    st = server.stats
    require(len(outs) == BATCHES and all(o is not None for o in outs)
            and st.errors == 0, f"failed exact batches: errors={st.errors}")
    expect_launches(counts, census, BATCHES, "exact zoo yolov5s",
                    decodes=BATCHES)
    for name in KERNEL_INFO:
        if PATH_OF[name] == "exact zoo yolov5s 640":
            require(counts[name] > 0, f"{name} never launched on the path")
            results[name]["launches"] = counts[name]
    target = tuple(g.tensors[g.inputs[0]].shape[1:3])
    dets_per_frame = check_detections(outs, target)
    print(f"[exact] launches {counts} (= {BATCHES} x the census, one decode "
          "per batch)")
    print(f"[exact] 4-batch run: {st.summary()}; detections per frame: mean "
          f"{float(np.mean(dets_per_frame))}")

    x = Y.quantize_input_int8(
        Y.letterbox_uint8(torch.from_numpy(frames[0]).to(dev), target))
    rec = check_units(eng, x, results, "exact zoo yolov5s")
    n_units = len(rec)
    require(n_units == 60, f"{n_units} kernel convs captured, expected 60")
    print(f"[exact] kernel vs plain on every conv of one batch: {n_units} "
          "convs bit for bit")
    table = exact_1x1_table(eng, rec)
    cpu = Engine(g, exact, device="cpu")
    n_steps, share, dmax = check_exact_steps_against_cpu(
        eng, cpu, check_letterbox_on_card(frames[0][:1], target))
    print(f"[exact] card vs CPU, one frame: {n_steps} steps bit for bit; "
          f"heads end to end: {share:.6f} of the values differ, max |diff| "
          f"{dmax}")
    require(dmax == 0 and share == 0,
            f"exact heads card vs CPU: share {share}, max {dmax}")
    return {"launches": counts, "census_per_forward": census,
            "fps_4batch": st.fps, "p50_ms_4batch": st.latency_ms(50),
            "p99_ms_4batch": st.latency_ms(99),
            "dets_per_frame_mean": float(np.mean(dets_per_frame)),
            "units_checked": n_units, "steps_card_vs_cpu": n_steps,
            "heads_card_vs_cpu_share": share, "heads_card_vs_cpu_max": dmax,
            "exact_1x1": table}


def phase_dma_kernels(results: dict) -> None:
    """#5 against its plain version (the tolerance of the case's act) and
    against #2's entry (``"blockspec"``, the same kernel) bit for bit, at
    #2's lead shape, the TPU experiment's 16x80x80x128 -> 128, a 3x3/s2,
    the 6x6/s2 stem and a ragged case; its time beside #2's entry's, the
    plain version's, fp16 channels-last ``F.conv2d``'s and the bound."""
    import numpy as np
    import torch
    from thingino_accel_tpu_torch.ops import fused_kernels as FK

    rng = np.random.default_rng(5)
    dev = torch.device("cuda")

    def rnd(shape):
        return torch.from_numpy(
            rng.integers(-128, 128, shape, dtype=np.int8)).to(dev)

    # (label, x shape, OHWI w shape, stride, pads, act)
    cases = [
        ("3x3/s1 8x80x80x64 -> 64", (8, 80, 80, 64), (64, 3, 3, 64), 1,
         ((1, 1), (1, 1)), "NONE"),
        ("3x3/s1 16x80x80x128 -> 128", (16, 80, 80, 128), (128, 3, 3, 128),
         1, ((1, 1), (1, 1)), "SILU"),
        ("3x3/s2 16x80x80x128 -> 256", (16, 80, 80, 128), (256, 3, 3, 128),
         2, ((1, 1), (1, 1)), "RELU"),
        ("6x6/s2 stem 16x640x640x3 -> 32", (16, 640, 640, 3),
         (32, 6, 6, 3), 2, ((2, 2), (2, 2)), "SILU"),
        ("ragged 3x3/s1 16x45x77x40 -> 70 pads (0,1),(1,0)",
         (16, 45, 77, 40), (70, 3, 3, 40), 1, ((0, 1), (1, 0)),
         "LEAKY_RELU"),
    ]
    for label, xs, ws, s, pads, act in cases:
        x, wt = rnd(xs), rnd(ws)
        o, kk, _, c = ws
        out_hw = ((xs[1] + sum(pads[0]) - kk) // s + 1,
                  (xs[2] + sum(pads[1]) - kk) // s + 1)
        bias = torch.from_numpy(
            rng.integers(-2000, 2000, o).astype(np.int32)).to(dev)
        ep = FK.epilogue_rows(rng.uniform(0.005, 0.015, o).astype(np.float32),
                              0.01, float(0.0137 * np.sqrt(kk * kk * c)), act,
                              o, device=dev)
        args = (x, wt, bias, ep, out_hw, pads, s)

        def dma(args=args):
            return FK.conv2d_int8_halo_fused(*args, pipeline="dma")

        def blockspec(args=args):
            return FK.conv2d_int8_halo_fused(*args)

        out = dma()
        torch.cuda.synchronize()
        dmax = compare(out, FK.conv2d_int8_halo_fused_plain(*args), act,
                       f"dma {label} {act}")
        require(torch.equal(out, blockspec()),
                f"dma {label} {act}: differs from #2 (blockspec)")
        plan = FK.serving_plan(x, wt, out_hw, s)
        case = {"case": f"{label} {act}", "ms": time_ms(dma, 20),
                "blockspec_ms": time_ms(blockspec, 20),
                "plain_ms": time_ms(
                    lambda: FK.conv2d_int8_halo_fused_plain(*args), 5,
                    warmup=1),
                "library_ms": library_ms(
                    conv_fp16_call(x, wt, s, (pads[0][0], pads[1][0])), label),
                "max_abs_err": dmax, "plan": list(dataclasses.astuple(plan))}
        case["bound_ms"], case["bound_by"] = bound(*conv_work(x, wt, out,
                                                              8 * o))
        results[DMA]["cases"].append(case)
        note_err(results, DMA, dmax)
        print(f"[dma] {label} {act}: kernel {case['ms']:.4f} ms, #2 "
              f"{case['blockspec_ms']:.4f} ms, plain {case['plain_ms']:.4f} "
              f"ms, F.conv2d fp16 {case['library_ms']}, bound "
              f"{case['bound_ms']:.4f} ms ({case['bound_by']}), plan "
              f"{plan}; == plain (max |diff| {dmax}) and == #2's entry")


def replay_dma(eng, rec: list, results: dict, what: str) -> dict:
    """#5's path: every KxK conv unit (kind "conv", no residual) of a
    planned forward whose units ``check_units`` has just held against
    their plain versions, re-run on its recorded input through #5's entry:
    one launch each and no other kernel, each output equal to the plain
    version on the same input (``compare``) and to the unit's own output
    (#2's entry, the same kernel) bit for bit. Both entries timed per
    unit; the sums are per forward."""
    import torch
    from thingino_accel_tpu_torch.ops import fused_kernels as FK
    from thingino_accel_tpu_torch.runtime.executor import ConvUnit

    units = [(u, reads, out) for u, reads, out in rec
             if isinstance(u, ConvUnit) and u.kind == "conv"
             and u.residual is None]
    require(units, f"{what}: no KxK conv unit to replay")

    def args(u, reads):
        n = u.node
        bias = eng.params[n.inputs[2]] if len(n.inputs) > 2 else None
        require(u.stride[0] == u.stride[1], f"{what}: non-square stride")
        return (reads[u.x], eng.params[n.inputs[1]], bias, u.ep, u.out_hw,
                u.pads, u.stride[0])

    def call(u, reads, pipeline):
        a = args(u, reads)
        return lambda: FK.conv2d_int8_halo_fused(*a, pipeline=pipeline)

    reset_launches()
    outs = [call(u, reads, "dma")() for u, reads, _ in units]
    torch.cuda.synchronize()
    counts = read_launches()
    want = {k: 0 for k in counts}
    want[DMA] = len(units)
    require(counts == want, f"{what} dma replay: launches {counts}")
    results[DMA]["launches"] += len(units)
    for (u, reads, out), got in zip(units, outs):
        plain = FK.conv2d_int8_halo_fused_plain(*args(u, reads))
        note_err(results, DMA, compare(got, plain, u.act,
                                       f"{what} {u!r} dma vs plain"))
        require(torch.equal(got, out),
                f"{what} {u!r}: #5's entry differs from #2's")
    dma_ms = sum(time_ms(call(u, r, "dma"), 10) for u, r, _ in units)
    bs_ms = sum(time_ms(call(u, r, "blockspec"), 10) for u, r, _ in units)
    print(f"[dma] {what}: {len(units)} KxK units replayed through #5's "
          f"entry, each == plain and == #2's entry bit for bit; per forward "
          f"#5 {dma_ms:.4f} ms, #2 {bs_ms:.4f} ms")
    return {"units": len(units), "dma_ms_per_forward": dma_ms,
            "blockspec_ms_per_forward": bs_ms,
            "shapes": [f"{tuple(r[u.x].shape)} k{u.node.attrs['kernel']}"
                       f" s{u.stride[0]} -> {u.ep.cs.shape[0]} {u.act}"
                       for u, r, _ in units]}


def serving_kxk_table(eng, rec: list, what: str) -> dict:
    """The serving KxK table of one planned path: every distinct #2 unit
    (kind "conv") of the forward whose units ``check_units`` has just held
    against their plain versions, re-run on its recorded input (batch 16,
    its residual too) through #2's entry and equal to the unit's output:
    its plan, mode and blocks an SM, its median event time and T/s beside
    fp16 channels-last ``F.conv2d`` and its bound, its split by the
    ``KXK_VARIANTS`` builds of the serving source (the epilogue's share
    1 - no_store / kernel, the product's 1 - no_product / kernel, and the
    rest: copies, syncs and the im2col build, the time without both); a
    block of 16 channels (bn 16) also timed at the plan the planner gives
    without it (bn 32), equal bit for bit; the per-forward sums, whose
    units must make up the plan's #2 launches."""
    import torch
    from thingino_accel_tpu_torch.ops import cuda_build
    from thingino_accel_tpu_torch.ops import fused_kernels as FK
    from thingino_accel_tpu_torch.runtime.executor import ConvUnit

    dev = torch.device("cuda")
    variants = {name: cuda_build.load_variant(
        SERVING_SOURCE, flags, ("tat_conv_int8_fused_mma",))
        for name, flags in KXK_VARIANTS.items()}
    distinct: dict = {}
    for u, reads, out in rec:
        if isinstance(u, ConvUnit) and u.kind == "conv":
            key = (tuple(reads[u.x].shape),
                   tuple(eng.params[u.node.inputs[1]].shape), u.stride[0],
                   u.pads, u.act, u.residual is not None)
            distinct.setdefault(key, [u, reads, out, 0])[3] += 1
    rows = []
    for (_, _, s, pads, act, _), (u, reads, out, count) in distinct.items():
        n = u.node
        x, w = reads[u.x], eng.params[n.inputs[1]]
        bias = eng.params[n.inputs[2]] if len(n.inputs) > 2 else None
        res = reads[u.residual] if u.residual else None
        o, kh, kw, c = w.shape
        args = (x, w, bias, u.ep, u.out_hw, pads, s)

        def call(args=args, res=res, rs=u.res_scale):
            return FK.conv2d_int8_halo_fused(*args, residual=res,
                                             res_scale=rs)
        got = call()
        torch.cuda.synchronize()
        label = (f"{kh}x{kw}/s{s} {x.shape[0]}x{x.shape[1]}x{x.shape[2]}x{c}"
                 f" -> {o} {act}{' + residual' if res is not None else ''}")
        require(torch.equal(got, out), f"{what} {label}: differs from the "
                                       "unit's own output")
        plan = FK.serving_plan(x, w, u.out_hw, s)
        ms = time_ms(call, 20)
        lib = library_ms(conv_fp16_call(x, w, s, (pads[0][0], pads[1][0])),
                         label)
        ops, nbytes = conv_work(x, w, got, 8 * o + (
            res.numel() if res is not None else 0))
        bms, side = bound(ops, nbytes)
        _, blocks = FK.conv_occupancy(plan, c, (kh, kw), s, act)
        row = {"path": what, "conv": label, "count": count, "ms": ms,
               "library_ms": lib, "bound_ms": bms, "bound_by": side,
               "tops": ops / ms / 1e9, "plan": dataclasses.asdict(plan),
               "blocks_per_sm": blocks, "split_ms": {}}

        def bare(vlib, p=plan, x=x, w=w, bias=bias, ep=u.ep, pads=pads, s=s,
                 res=res, rs=u.res_scale, o=got):
            cuda_build.check(vlib.tat_conv_int8_fused_mma(
                *FK._conv_args(x, w, bias, ep, pads, s, res, rs,
                               torch.empty_like(o), p),
                torch.cuda.current_stream(dev).cuda_stream),
                "tat_conv_int8_fused_mma (variant)")
        for name, vlib in variants.items():
            row["split_ms"][name] = time_ms(lambda v=vlib: bare(v), 20)
        row["epilogue_share"] = 1 - row["split_ms"]["no_store"] / ms
        row["product_share"] = 1 - row["split_ms"]["no_product"] / ms
        extra = ""
        if plan.bn == 16:
            alt = FK.conv_plan(x.shape[0], *u.out_hw, c, o, kh, kw, (s, s),
                               (1, 1), plan.mode, FK.smem_limits(dev))
            alt_out = torch.empty_like(got)

            def launch_alt(alt=alt, x=x, w=w, bias=bias, ep=u.ep, pads=pads,
                           s=s, res=res, rs=u.res_scale, ao=alt_out):
                FK._launch_conv(x, w, bias, ep, pads, s, res, rs, ao, alt)
            launch_alt()
            torch.cuda.synchronize()
            require(torch.equal(alt_out, got), f"{what} {label}: bn 32 "
                                               "differs from bn 16")
            row["bn32_ms"] = time_ms(launch_alt, 20)
            row["bn32_plan"] = dataclasses.asdict(alt)
            extra = f"; at bn 32 {row['bn32_ms']:.4f} ms"
        rows.append(row)
        print(f"[serving-kxk] {what}: {label} x{count}: kernel {ms:.4f} ms, "
              f"F.conv2d fp16 {lib} ms, bound {bms:.4f} ms ({side}), "
              f"{row['tops']:.1f} T/s, {plan.mode} {plan.tile_h}x"
              f"{plan.tile_w} bn {plan.bn} ck {plan.ck} tpb "
              f"{plan.tiles_per_block}{' resident' if plan.resident else ''}"
              f", {blocks} blocks/SM; split: epilogue "
              f"{row['epilogue_share']:.3f}, product "
              f"{row['product_share']:.3f}, without both "
              f"{row['split_ms']['neither']:.4f} ms{extra}")
    sums = {"convs": sum(r["count"] for r in rows),
            **{key: sum(r["count"] * (r[key] or 0.0) for r in rows)
               for key in ("ms", "library_ms", "bound_ms")}}
    census = eng._fn.launch_census()["conv2d_int8_halo_fused"]
    require(sums["convs"] == census, f"{what}: {sums['convs']} #2 units in "
                                     f"the table, {census} in the plan")
    print(f"[serving-kxk] {what} per forward ({sums['convs']} #2 units): "
          f"kernel {sums['ms']:.4f} ms, F.conv2d fp16 "
          f"{sums['library_ms']:.4f} ms, bound {sums['bound_ms']:.4f} ms")
    return {"rows": rows, "per_forward": sums}


def gemm_table(eng, units: list, what: str) -> dict:
    """The 1x1 table of one path: every distinct #1/#3 unit of a forward
    whose units were just held against their plain versions (``units``:
    (kind, node, epilogue, part widths, res_scale, {name: recorded
    tensor}, inputs' names, residual's name, the unit's output)), re-run
    on its recorded input at batch 16 through its entry point: equal to
    the unit's own output (planned paths) or within the act's tolerance of
    its plain version (the unplanned one); its median event time and T/s
    beside ``torch._int_mm`` (the parts' K concatenated; null where it
    refuses the shape) and its bound, the plan and blocks an SM, its split
    by the ``GEMM_VARIANTS`` builds (the epilogue's share 1 - no_store /
    kernel, the product's 1 - no_product / kernel, and the time without
    both: copies and syncs); the per-forward sums. The dp4a kernels it
    replaced, timed by ``kxk_bench`` in the checkout that had them, are
    printed beside from ``DP4A_1X1`` (a record, seeded inputs)."""
    import torch
    from thingino_accel_tpu_torch import kxk_bench as KB
    from thingino_accel_tpu_torch.ops import cuda_build
    from thingino_accel_tpu_torch.ops import fused_kernels as FK

    variants = {name: cuda_build.load_variant(
        GEMM_SOURCE, flags, ("tat_mm_int8_fused_mma",))
        for name, flags in GEMM_VARIANTS.items()}
    dp4a_record = json.loads(DP4A_1X1.read_text())
    dp4a = dp4a_record["ms"][DP4A_PATH[what]]

    distinct: dict = {}
    for kind, node, ep, widths, rs, env, ins, res, out in units:
        m = env[ins[0]].numel() // widths[0]
        n = (ep.cs if kind == "matmul" else ep.ep.cs).shape[0]
        key = KB.gemm_key(kind, m, widths, n, ep) + (res is not None,)
        distinct.setdefault(key, [kind, node, ep, widths, rs, env, ins, res,
                                  out, 0])[9] += 1
    rows = []
    for key, (kind, node, ep, widths, rs, env, ins, res, out, count) in \
            distinct.items():
        m, n = key[1], key[3]
        xs = [env[i].reshape(m, k) for i, k in zip(ins, widths)]
        ws = KB.gemm_weights(eng, node, widths)
        bias = eng.params[node.inputs[2]] if len(node.inputs) > 2 else None
        r = env[res].reshape(m, n) if res is not None else None
        call = KB.gemm_call(kind, xs, ws, bias, ep, r, rs)
        got = call()
        torch.cuda.synchronize()
        label = KB.gemm_label(kind, m, widths, n, ep, r is not None)
        single = kind == "matmul"
        act = ep.act if single else ep.ep.act
        if out is not None:
            require(torch.equal(got, out.reshape(m, n)),
                    f"{what} {label}: differs from the unit's own output")
        else:
            compare(got, KB.gemm_call(kind, xs, ws, bias, ep, r, rs,
                                      plain=True)(), act, f"{what} {label}")
        ms = time_ms(call, 20)
        xcat = torch.cat(xs, 1) if len(xs) > 1 else xs[0]
        wcat = torch.cat(ws, 1) if len(ws) > 1 else ws[0]
        lib = library_ms(int_mm_call(xcat, wcat), label)
        k = sum(widths)
        ops = 2 * m * k * n
        bms, side = bound(ops, m * k + n * k + 8 * n + m * n
                          + (m * n if r is not None else 0))
        same = single or ep.same_scale
        plan = FK.gemm_plan(xs, n, same)
        _, blocks = FK.gemm_occupancy(plan, widths, same, act)
        row = {"path": what, "unit": label, "count": count, "ms": ms,
               "tops": ops / ms / 1e9, "int_mm_ms": lib, "bound_ms": bms,
               "bound_by": side, "plan": dataclasses.asdict(plan),
               "blocks_per_sm": blocks, "split_ms": {}}
        if single:
            scales, e = ((1.0,), True, 1.0), ep
        else:
            scales, e = (ep.part_scales, ep.same_scale, ep.bias_scale), ep.ep
        for name, vlib in variants.items():
            def bare(vlib=vlib, xs=xs, ws=ws, bias=bias, e=e, sc=scales,
                     r=r, rs=rs, o=got, plan=plan):
                cuda_build.check(vlib.tat_mm_int8_fused_mma(
                    *FK._gemm_args(xs, ws, bias, e, *sc, r, rs,
                                   torch.empty_like(o), plan),
                    torch.cuda.current_stream().cuda_stream),
                    "tat_mm_int8_fused_mma (variant)")
            row["split_ms"][name] = time_ms(bare, 20)
        row["epilogue_share"] = 1 - row["split_ms"]["no_store"] / ms
        row["product_share"] = 1 - row["split_ms"]["no_product"] / ms
        row["dp4a_recorded_ms"] = dp4a.get(label)
        rows.append(row)
        print(f"[gemm] {what}: {label} x{count}: kernel {ms:.4f} ms, "
              f"{row['tops']:.1f} T/s, _int_mm {lib}, bound {bms:.4f} ms "
              f"({side}), bm {plan.bm} bn {plan.bn} kc {plan.kc} stages "
              f"{plan.stages} tpb {plan.tiles_per_block}, {blocks} "
              f"blocks/SM; split: epilogue {row['epilogue_share']:.3f}, "
              f"product {row['product_share']:.3f}, without both "
              f"{row['split_ms']['neither']:.4f} ms; dp4a (recorded) "
              f"{row['dp4a_recorded_ms']} ms")
    sums = {"units": sum(r["count"] for r in rows),
            **{key: sum(r["count"] * (r[key] or 0.0) for r in rows)
               for key in ("ms", "int_mm_ms", "bound_ms")}}
    want = sum(1 for u in units)
    require(sums["units"] == want, f"{what}: {sums['units']} units in the "
                                   f"table, {want} 1x1 units")
    sums["dp4a_recorded_ms"] = sum(r["count"] * (r["dp4a_recorded_ms"] or 0)
                                   for r in rows)
    print(f"[gemm] {what} per forward ({sums['units']} #1/#3 units): kernel "
          f"{sums['ms']:.4f} ms, _int_mm {sums['int_mm_ms']:.4f} ms (where "
          f"it runs), bound {sums['bound_ms']:.4f} ms; dp4a (recorded, "
          f"{dp4a_record['device']}) {sums['dp4a_recorded_ms']:.4f} ms")
    return {"rows": rows, "per_forward": sums}


def exact_1x1_table(eng, rec: list) -> dict:
    """The exact 1x1 table: every distinct #9 unit of the exact forward
    ``rec`` (batch 16, its units just held against their plain versions),
    re-run on its recorded input through #9's entry with its table: equal
    to the unit's own output; its median event time and T/s beside
    ``torch._int_mm`` and its bound (each input byte, the table and each
    output byte once), the plan and blocks an SM, its split by the
    ``GEMM_VARIANTS`` builds (the epilogue's share 1 - no_store / kernel,
    the product's 1 - no_product / kernel, the time without both); the
    per-forward sums. The dp4a kernel it replaced, timed by ``kxk_bench``
    in the checkout that had it (seeded inputs, the SILU a step of its own
    and not in that time), is printed beside from ``DP4A_EXACT_1X1``."""
    import torch
    from thingino_accel_tpu_torch import kxk_bench as KB
    from thingino_accel_tpu_torch.ops import cuda_build
    from thingino_accel_tpu_torch.ops import fused_kernels as FK
    from thingino_accel_tpu_torch.ops import requant_kernels as RK

    variants = {name: cuda_build.load_variant(
        GEMM_SOURCE, flags, ("tat_mm_int8_requant_mma",))
        for name, flags in GEMM_VARIANTS.items()}
    dp4a_record = json.loads(DP4A_EXACT_1X1.read_text())
    distinct: dict = {}
    for u, reads, out in rec:
        if u.kind == "matmul_int8_requant":
            key = KB.exact_1x1_key(eng, u, out.shape[0])
            distinct.setdefault(key, [u, reads, out, 0])[3] += 1
    rows = []
    limits = FK.smem_limits(torch.device("cuda"))
    for key, (u, reads, out, count) in distinct.items():
        m, k, n = key[:3]
        x2 = reads[u.node.inputs[0]].reshape(m, k)
        call = KB.exact_1x1_call(eng, u, x2)
        got = call()
        torch.cuda.synchronize()
        label = KB.exact_1x1_label(key)
        require(torch.equal(got, out.reshape(m, n)),
                f"exact 1x1 {label}: differs from the unit's own output")
        ms = time_ms(call, 20)
        w = eng.params[u.node.inputs[1]]
        w2 = w.reshape(n, k)
        bias = eng.params[u.node.inputs[2]] if len(u.node.inputs) > 2 \
            else None
        lib = library_ms(int_mm_call(x2, w2), label)
        ops = 2 * m * k * n
        bms, side = bound(ops, m * k + n * k + 4 * n + m * n
                          + (256 if u.lut is not None else 0))
        plan = RK.mm_requant_plan(m, n, k, limits)
        _, blocks = RK.mm_occupancy(plan, k)
        row = {"unit": label, "count": count, "ms": ms,
               "tops": ops / ms / 1e9, "int_mm_ms": lib, "bound_ms": bms,
               "bound_by": side, "plan": dataclasses.asdict(plan),
               "blocks_per_sm": blocks, "split_ms": {}}
        cs = RK.combined_scale(*u.scales)
        for name, vlib in variants.items():
            def bare(vlib=vlib, x2=x2, w2=w2, bias=bias, u=u, cs=cs, o=got,
                     plan=plan):
                cuda_build.check(vlib.tat_mm_int8_requant_mma(
                    *RK._mm_args(x2, w2, bias, u.lut, cs, u.round_mode,
                                 u.relu, torch.empty_like(o), plan),
                    torch.cuda.current_stream().cuda_stream),
                    "tat_mm_int8_requant_mma (variant)")
            row["split_ms"][name] = time_ms(bare, 20)
        row["epilogue_share"] = 1 - row["split_ms"]["no_store"] / ms
        row["product_share"] = 1 - row["split_ms"]["no_product"] / ms
        row["dp4a_recorded_ms"] = dp4a_record["ms"].get(label)
        rows.append(row)
        print(f"[exact1x1] {label} x{count}: kernel {ms:.4f} ms, "
              f"{row['tops']:.1f} T/s, _int_mm {lib}, bound {bms:.4f} ms "
              f"({side}), bm {plan.bm} bn {plan.bn} kc {plan.kc} stages "
              f"{plan.stages} tpb {plan.tiles_per_block}, {blocks} "
              f"blocks/SM; split: epilogue {row['epilogue_share']:.3f}, "
              f"product {row['product_share']:.3f}, without both "
              f"{row['split_ms']['neither']:.4f} ms; dp4a (recorded) "
              f"{row['dp4a_recorded_ms']} ms")
    sums = {"units": sum(r["count"] for r in rows),
            **{key: sum(r["count"] * (r[key] or 0.0) for r in rows)
               for key in ("ms", "int_mm_ms", "bound_ms",
                           "dp4a_recorded_ms")}}
    require(sums["units"] == EXACT_ZOO_S["matmul_int8_requant"],
            f"{sums['units']} #9 units in the exact 1x1 table")
    print(f"[exact1x1] per forward ({sums['units']} #9 units): kernel "
          f"{sums['ms']:.4f} ms, _int_mm {sums['int_mm_ms']:.4f} ms (where "
          f"it runs), bound {sums['bound_ms']:.4f} ms; dp4a (recorded, "
          f"{dp4a_record['device']}) {sums['dp4a_recorded_ms']:.4f} ms")
    return {"rows": rows, "per_forward": sums}


def dw_table(eng, rec: list) -> dict:
    """The depthwise table: every distinct #7 unit of the planned NanoDet
    forward ``rec`` (batch 16), re-run on its recorded input through its
    entry: equal to the unit's own output; its median event time beside
    fp16 channels-last ``F.conv2d`` with groups = C and its bound, the plan
    and blocks an SM; the per-forward sums. The kernel it replaced
    (PR 3's thread-per-pixel kernel), timed by ``kxk_bench`` in the
    checkout that had it (seeded inputs), is printed beside from
    ``DP4A_DW``."""
    import torch
    from thingino_accel_tpu_torch import kxk_bench as KB
    from thingino_accel_tpu_torch.ops import fused_kernels as FK

    record = json.loads(DP4A_DW.read_text())
    distinct: dict = {}
    for u, reads, out in rec:
        if u.kind == "dw":
            key = KB.dw_key(eng, u, out.shape[0])
            distinct.setdefault(key, [u, reads, out, 0])[3] += 1
    rows = []
    limits = FK.smem_limits(torch.device("cuda"))
    for key, (u, reads, out, count) in distinct.items():
        env = dict(eng.params)
        env.update(reads)
        got = u.compute(env)
        torch.cuda.synchronize()
        label = KB.dw_label(key)
        require(torch.equal(got, out),
                f"dw {label}: differs from the unit's own output")
        ms = time_ms(lambda: u.compute(env), 20)
        x, w = reads[u.node.inputs[0]], eng.params[u.node.inputs[1]]
        nb, h, wd, c = x.shape
        lib = library_ms(conv_fp16_call(x, w, 1, u.pads[0][0], groups=c),
                         label)
        bms, side = bound(*conv_work(x, w, out, 8 * c, groups=c))
        plan = FK.dw_plan(nb, *u.out_hw, c, *w.shape[:2], limits)
        _, blocks = FK.dw_occupancy(plan, c, tuple(w.shape[:2]),
                                    u.out_hw[1])
        row = {"unit": label, "count": count, "ms": ms, "fp16_ms": lib,
               "bound_ms": bms, "bound_by": side,
               "plan": dataclasses.asdict(plan), "blocks_per_sm": blocks,
               "old_recorded_ms": record["ms"].get(label)}
        rows.append(row)
        print(f"[dw] {label} x{count}: kernel {ms:.4f} ms, F.conv2d fp16 "
              f"groups=C {lib} ms, bound {bms:.4f} ms ({side}), tile_h "
              f"{plan.tile_h} groups {plan.groups}, {blocks} blocks/SM; "
              f"the kernel it replaced (recorded) {row['old_recorded_ms']} ms")
    sums = {"units": sum(r["count"] for r in rows),
            **{key: sum(r["count"] * (r[key] or 0.0) for r in rows)
               for key in ("ms", "fp16_ms", "bound_ms", "old_recorded_ms")}}
    require(sums["units"] == PLANNED_NANODET["depthwise_conv2d_int8_fused"],
            f"{sums['units']} #7 units in the depthwise table")
    print(f"[dw] per forward ({sums['units']} #7 units): kernel "
          f"{sums['ms']:.4f} ms, F.conv2d fp16 {sums['fp16_ms']:.4f} ms, "
          f"bound {sums['bound_ms']:.4f} ms; the kernel it replaced "
          f"(recorded, {record['device']}) {sums['old_recorded_ms']:.4f} ms")
    return {"rows": rows, "per_forward": sums}


def bneck_table(eng, rec: list, what: str) -> dict:
    """The bottleneck table of one planned path: every distinct #6 unit of
    the forward ``rec`` (batch 16, its units just held against their plain
    versions), re-run on its recorded input through its entry: equal to the
    unit's own output, and the unfused tensor-core pair (#1's 1x1 into
    device memory, then #2's KxK with the shortcut) equal to it bit for
    bit; its plan and blocks an SM, its median event time beside the
    pair's, fp16 channels-last ``F.conv2d`` of the KxK stage alone and its
    bound (each input byte and each output byte once); the per-forward
    sums. The dp4a kernel it replaced, timed by ``kxk_bench`` in the
    checkout that had it (seeded inputs), is printed beside from
    ``DP4A_BNECK``."""
    import torch
    from thingino_accel_tpu_torch import kxk_bench as KB
    from thingino_accel_tpu_torch.ops import fused_kernels as FK

    record = json.loads(DP4A_BNECK.read_text())
    dp4a = record["ms"][DP4A_PATH[what]]
    distinct: dict = {}
    for u, reads, out in rec:
        if u.kind == "bneck":
            key = KB.bneck_key(eng, u, out.shape[0])
            distinct.setdefault(key, [u, reads, out, 0])[3] += 1
    rows = []
    limits = FK.smem_limits(torch.device("cuda"))
    for key, (u, reads, out, count) in distinct.items():
        (nb, h, w, c), cm, o, k = key[:4]
        x = reads[u.conv_a.inputs[0]]
        calls = KB.bneck_calls(eng, u, x)
        got, pair = calls["fused"](), calls["pair"]()
        torch.cuda.synchronize()
        label = KB.bneck_label(key)
        require(torch.equal(got, out),
                f"{what} {label}: differs from the unit's own output")
        require(torch.equal(pair, got),
                f"{what} {label}: the #1 + #2 pair differs")
        ms, pair_ms = time_ms(calls["fused"], 20), time_ms(calls["pair"], 20)
        lib = library_ms(calls["fp16"], f"{label} KxK stage")
        m = nb * h * w
        bms, side = bound(2 * m * (c * cm + k * k * cm * o),
                          m * c + cm * c + o * k * k * cm + 8 * (cm + o)
                          + m * o)
        plan = FK.bneck_plan(nb, h, w, c, cm, o, k, limits)
        _, blocks = FK.bneck_occupancy(plan, c, cm, k, u.ep1.act, u.ep2.act)
        row = {"path": what, "unit": label, "count": count, "ms": ms,
               "pair_ms": pair_ms, "fp16_kxk_ms": lib, "bound_ms": bms,
               "bound_by": side, "plan": dataclasses.asdict(plan),
               "blocks_per_sm": blocks, "dp4a_recorded_ms": dp4a.get(label)}
        rows.append(row)
        print(f"[bneck] {what}: {label} x{count}: kernel {ms:.4f} ms, #1 + "
              f"#2 {pair_ms:.4f} ms, F.conv2d fp16 (KxK stage) {lib} ms, "
              f"bound {bms:.4f} ms ({side}), {plan.tile_h}x{plan.tile_w} bn "
              f"{plan.bn}{'' if plan.resident else ' w2 streamed'} tpb "
              f"{plan.tiles_per_block}, {blocks} blocks/SM; "
              f"dp4a (recorded) {row['dp4a_recorded_ms']} ms")
    sums = {"units": sum(r["count"] for r in rows),
            **{key: sum(r["count"] * (r[key] or 0.0) for r in rows)
               for key in ("ms", "pair_ms", "fp16_kxk_ms", "bound_ms",
                           "dp4a_recorded_ms")}}
    census = eng._fn.launch_census()["bottleneck_int8_fused"]
    require(sums["units"] == census, f"{what}: {sums['units']} #6 units in "
                                     f"the table, {census} in the plan")
    print(f"[bneck] {what} per forward ({sums['units']} #6 units): kernel "
          f"{sums['ms']:.4f} ms, #1 + #2 {sums['pair_ms']:.4f} ms, F.conv2d "
          f"fp16 (KxK stages) {sums['fp16_kxk_ms']:.4f} ms, bound "
          f"{sums['bound_ms']:.4f} ms; dp4a (recorded, {record['device']}) "
          f"{sums['dp4a_recorded_ms']:.4f} ms")
    return {"rows": rows, "per_forward": sums}


def sppf_table(eng, rec: list) -> dict:
    """The SPPF table of the planned zoo yolov5s: its #4 unit of the
    forward ``rec`` (batch 16), re-run on its recorded input through its
    entry: equal to the unit's own output, and #3's 1x1 GEMM alone over
    the four levels (pooled beforehand by the plain maxpool) equal to it
    bit for bit; its plan and blocks an SM, its median event time beside
    that GEMM's, ``torch._int_mm`` over the levels concatenated and its
    bound; the dp4a kernel it replaced from ``DP4A_SPPF``."""
    import torch
    from thingino_accel_tpu_torch import kxk_bench as KB
    from thingino_accel_tpu_torch.ops import fused_kernels as FK

    record = json.loads(DP4A_SPPF.read_text())
    rows = []
    limits = FK.smem_limits(torch.device("cuda"))
    for u, reads, out in rec:
        if u.kind != "sppf":
            continue
        key = KB.sppf_key(eng, u, out.shape[0])
        (nb, h, w, c), o, k, act = key
        x = reads[u.src]
        wt, bias = KB.sppf_operands(eng, u)
        calls = KB.sppf_calls(u, x, wt, bias)
        got, gemm = calls["fused"](), calls["gemm"]()
        torch.cuda.synchronize()
        label = KB.sppf_label(key)
        require(torch.equal(got, out),
                f"{label}: differs from the unit's own output")
        require(torch.equal(gemm, got.reshape(gemm.shape)),
                f"{label}: #3 over the levels differs")
        ms, gemm_ms = time_ms(calls["fused"], 20), time_ms(calls["gemm"], 20)
        lib = library_ms(calls["int_mm"], label)
        m = nb * h * w
        bms, side = bound(2 * m * 4 * c * o, m * c + 4 * c * o + 8 * o
                          + m * o)
        plan = FK.sppf_plan(nb, h, w, c, o, k, limits)
        _, blocks = FK.sppf_occupancy(plan, h, w, c, k, act)
        row = {"unit": label, "ms": ms, "gemm_levels_ms": gemm_ms,
               "int_mm_ms": lib, "bound_ms": bms, "bound_by": side,
               "plan": dataclasses.asdict(plan), "blocks_per_sm": blocks,
               "dp4a_recorded_ms": record["ms"].get(label)}
        rows.append(row)
        print(f"[sppf] {label}: kernel {ms:.4f} ms, #3 over the levels "
              f"{gemm_ms:.4f} ms, _int_mm {lib}, bound {bms:.4f} ms "
              f"({side}), bm {plan.bm} bn {plan.bn} ck {plan.ck} tpb "
              f"{plan.tiles_per_block}, {blocks} blocks/SM; dp4a (recorded, "
              f"{record['device']}) {row['dp4a_recorded_ms']} ms")
    require(len(rows) == PLANNED_ZOO_S["sppf_int8_fused"],
            f"{len(rows)} #4 units in the SPPF table")
    return {"rows": rows}


def planned_gemm_units(eng, rec: list) -> list:
    """The #1/#3 units of a captured planned forward, for
    :func:`gemm_table`."""
    from thingino_accel_tpu_torch.runtime.executor import ConvUnit, MultiUnit
    units = []
    for u, reads, out in rec:
        if isinstance(u, ConvUnit) and u.kind == "matmul":
            units.append(("matmul", u.node, u.ep,
                          [reads[u.x].shape[-1]], u.res_scale, reads,
                          [u.x], u.residual, out))
        elif isinstance(u, MultiUnit):
            units.append(("multi", u.node, u.me, list(u.widths),
                          u.res_scale, reads, list(u.parts), u.residual,
                          out))
    census = eng._fn.launch_census()
    require(len(units) == census["matmul_int8_fused"]
            + census["matmul_int8_fused_multi"], "1x1 units vs the census")
    return units


def compare_probe(got, ref, kind: str, stages: int, what: str) -> float:
    """A probe kernel against its plain version: int8 kinds bit for bit
    (SILU_FAST too: both sides divide in IEEE f32); SILU kinds within the
    SILU tolerance after one stage and at most PROBE_SILU_LOOSE of the
    values apart after more (a flipped quantum moves every later stage);
    bf16 within 2^-7 of the largest output (f32 tensor-core sums against
    float64 ones). Returns the largest difference."""
    import torch
    from thingino_accel_tpu_torch.ops import probe_kernels as PK
    require(got.shape == ref.shape and got.dtype == ref.dtype,
            f"{what}: {tuple(got.shape)} {got.dtype} vs {tuple(ref.shape)} "
            f"{ref.dtype}")
    if kind in ("bf16", "bf16-3x3"):
        r = ref.float()
        d = float((got.float() - r).abs().max())
        tol = float(r.abs().max()) * 2.0 ** -7
        require(d <= tol, f"{what}: bf16 max |diff| {d} over {tol}")
        return d
    silu = PK.MEGA_ACT.get(kind) == "SILU"
    if silu and stages > 1:
        d = (got.to(torch.int32) - ref.to(torch.int32)).abs()
        frac = float((d > 0).to(torch.float64).mean())
        require(frac <= PROBE_SILU_LOOSE,
                f"{what}: {frac} of the values differ after {stages} stages")
        return int(d.max())
    return compare(got, ref, "SILU" if silu else "NONE", what)


def phase_probe_checks(results: dict) -> dict:
    """Each E1 variant and E3 kind against its plain version on the card
    at full width on 2 grid cells (E1: m = 1024, L = 8; E3: H = 32,
    L = 4, the SILU kinds also at L = 1, the 3x3 kinds also at the ragged
    H = 29, L = 2), at each K of the sweeps; then at the sweeps' own
    sizes (E1 grid 32, E3 GRID 16 at H = 32, L = 4), where the planners
    pick the blocks the sweeps time."""
    import torch
    from thingino_accel_tpu_torch.ops import probe_kernels as PK
    from thingino_accel_tpu_torch.probes import megakernel as P3
    from thingino_accel_tpu_torch.probes import mxu_ceiling as P1

    dev = torch.device("cuda")
    checked = {}
    for grid in (2, P1.GRID):
        for kind in P1.KINDS:
            for k in P1.KS:
                fn, x, w = P1.build(kind, P1.M, k, P1.L, grid, dev)
                got = fn(x, w)
                torch.cuda.synchronize()
                what = f"E1 {kind} K={k} grid={grid}"
                checked[what] = compare_probe(
                    got, PK.chain_mma_plain(x, w, kind), kind, P1.L, what)
                note_err(results, "chain_mma", checked[what])
    saved = (P3.GRID, P3.L, P3.H)
    try:
        for kind in P3.KINDS:
            depths = [(2, saved[2], 1), (2, saved[2], saved[1])] \
                if PK.MEGA_ACT.get(kind) == "SILU" \
                else [(2, saved[2], saved[1])]
            if PK.is_spatial(kind):   # ragged: extents 33, 31, 29
                depths.append((2, RAGGED_H, 2))
            depths.append((saved[0], saved[2], saved[1]))   # the sweep's
            for k in P3.KS:
                for grid, h, l in depths:
                    P3.GRID = grid
                    P3.H = P3.W = h
                    P3.L = P3.PAD = l
                    fn, (x, w), _ = P3.build(kind, k, dev)
                    got = fn(x, w)
                    torch.cuda.synchronize()
                    what = f"E3 {kind} K={k} H={h} L={l} GRID={grid}"
                    checked[what] = compare_probe(
                        got, P3.plain_fn(kind, k, dev)(x, w), kind, l, what)
                    note_err(results, "megakernel_probe", checked[what])
    finally:
        P3.GRID, (P3.L, P3.PAD) = saved[0], (saved[1], saved[1])
        P3.H = P3.W = saved[2]
    print(f"[probes] {len(checked)} probe cases == their plain versions: "
          + ", ".join(f"{k} {v:.3g}" for k, v in checked.items()))
    return checked


def _rates(row: dict) -> dict:
    """A sweep row with each timing.Rate as a dict."""
    return {c: (dataclasses.asdict(v) if hasattr(v, "tops") else v)
            for c, v in row.items()}


def phase_probes(results: dict) -> dict:
    """The probes' paths, with the launch counts set to 0 before and read
    after: E1's sweep (m = 1024, L = 8, grid = 32, K = 128/256/512) and
    E3's (H = 32, L = 4, GRID = 16, K = 256/512) through their entry
    points, and the health ladder's kernel rung in this process. Then, at
    each sweep size, the plain version's time, the library call's and the
    bound beside each kernel's; the decision rules as they come out on
    this card; and the ladder, each rung in its own process."""
    import torch
    from thingino_accel_tpu_torch.ops import fused_kernels as FK
    from thingino_accel_tpu_torch.ops import probe_kernels as PK
    from thingino_accel_tpu_torch.probes import megakernel as P3
    from thingino_accel_tpu_torch.probes import mxu_ceiling as P1
    from thingino_accel_tpu_torch.probes import timing
    from thingino_accel_tpu_torch.probes import wedge as P4

    dev = torch.device("cuda")
    reset_launches()
    e1 = P1.sweep(dev)
    e3 = P3.sweep(dev)
    rung = P4.run_rung("kernel", dev)
    torch.cuda.synchronize()
    counts = read_launches()
    for k in PROBE_KERNELS:
        require(counts[k] > 0, f"{k} never launched on the probes' path")
        results[k]["launches"] = counts[k]
    others = {k: v for k, v in counts.items() if k not in PROBE_KERNELS and v}
    require(not others, f"the probes launched other kernels: {others}")
    print(f"[probes] launches {dict((k, counts[k]) for k in PROBE_KERNELS)}; "
          f"{rung}")
    for line in P1.table(e1, P1.M, P1.L, P1.GRID) + P3.table(e3):
        print(f"[probes] {line}")
    verdicts = {}
    for r in e1:
        verdicts[f"E1 K={r['k']}"] = P1.verdict(r["int8"].tops,
                                                r["bf16"].tops)
    for r in e3:
        verdicts[f"E3 K={r['k']}"] = P3.verdict(
            r["i8-c3-round"].tops, r["fp16-c3"].tops, r["bf16-3x3"].tops)
    for key, v in verdicts.items():
        print(f"[probes] decision {key}: {v}")

    # E1: each variant at the sweep's sizes; the int8 chain at K = 256
    # first (the kernels line reports it), its library call _int_mm
    mma1 = json.loads(MMA_CHAIN.read_text())
    e1_cases = []
    for r in sorted(e1, key=lambda r: r["k"] != 256):
        k, ops = r["k"], r["ops"]
        for kind in sorted(P1.KINDS, key=lambda kd: kd != "int8"):
            fn, x, w = P1.build(kind, P1.M, k, P1.L, P1.GRID, dev)
            nbytes = 2 * x.numel() * x.element_size() + w.numel() * \
                w.element_size()
            lib = {"int8": r.get("torch-int8"), "bf16": r.get("torch-bf16")}
            case = {"case": f"E1 {kind} m={P1.M} K={k} L={P1.L} "
                            f"grid={P1.GRID}",
                    "ms": r[kind].ms, "tops": r[kind].tops,
                    "plain_ms": time_ms(
                        lambda: PK.chain_mma_plain(x, w, kind), 3, warmup=1),
                    "library_ms": (lib[kind].ms if lib.get(kind) else None),
                    "mma_recorded_ms": mma1["ms"].get(f"E1 {kind} K={k}"),
                    "max_abs_err": results["chain_mma"]["max_abs_err"]}
            case["bound_ms"], case["bound_by"] = bound(
                ops, nbytes, PEAK_BF16 if kind in ("bf16", "mixed")
                else PEAK_OPS)
            e1_cases.append(case)
    results["chain_mma"]["cases"] += e1_cases
    # the _int_mm chain's yardstick: its L products alone, the rest glue
    e1_split = {}
    for r in e1:
        lib = r.get("torch-int8")
        if lib is None:
            continue
        pfn, px, pw = P1.library_int8_products(P1.M, r["k"], P1.L, P1.GRID,
                                               dev)
        prod = timing.measure(lambda y: pfn(y, pw), px, r["ops"])
        e1_split[r["k"]] = {"chain_ms": lib.ms, "products_ms": prod.ms,
                            "glue_ms": lib.ms - prod.ms}
        print(f"[probes] E1 _int_mm chain K={r['k']}: {lib.ms:.4f} ms, its "
              f"{P1.L} products alone {prod.ms:.4f} ms "
              f"({prod.ms / lib.ms:.1%}), the glue (>> 7, the int8 casts) "
              f"{lib.ms - prod.ms:.4f} ms ({1 - prod.ms / lib.ms:.1%})")

    # E3: each kind; the C3 round at K = 256 first. Library: the fp16
    # library round for the C3 round, the fp16 3x3 chain for the other
    # 3x3 kinds (probes.megakernel.library_round / library_taps)
    limits = FK.smem_limits(dev)
    mma3 = json.loads(MMA_MEGAKERNEL.read_text())
    e3_cases = []
    for r in sorted(e3, key=lambda r: r["k"] != 256):
        k = r["k"]
        for kind in sorted(P3.KINDS, key=lambda kd: kd != "i8-c3-round"):
            fn, (x, w), ops = P3.build(kind, k, dev)
            pf = P3.plain_fn(kind, k, dev)
            ws = w if isinstance(w, tuple) else (w,)
            nbytes = 2 * x.numel() * x.element_size() + sum(
                t.numel() * t.element_size() for t in ws) + 4 * k
            lib = r["fp16-c3" if kind == "i8-c3-round" else "fp16-3x3"]
            case = {"case": f"E3 {kind} K={k} H={P3.H} L={P3.L} "
                            f"GRID={P3.GRID}",
                    "ms": r[kind].ms, "tops": r[kind].tops,
                    "issued_ops": r["issued"][kind],
                    "tiled_ops": r["tiled"][kind], "ops": ops,
                    "plain_ms": time_ms(lambda: pf(x, w), 3, warmup=1),
                    "library_ms": (lib.ms if lib is not None
                                   and PK.is_spatial(kind) else None),
                    "mma_recorded_ms": mma3["ms"].get(f"E3 {kind} K={k}"),
                    "max_abs_err": results["megakernel_probe"]["max_abs_err"]}
            if PK.is_spatial(kind):
                row = PK._row_bytes(kind, k)
                case["plans"] = [
                    [ep, taps, e, *dataclasses.astuple(PK.stage_plan(
                        taps, row, k, PK.stage_tiles(taps, P3.GRID, e),
                        limits))]
                    for ep, taps, e in PK.spatial_launches(
                        kind, P3.H + 2 * P3.L, P3.L)]
                case.update(P3.kernel_ms(kind, k, dev))
            case["bound_ms"], case["bound_by"] = bound(
                ops, nbytes, PEAK_BF16 if kind == "bf16-3x3" else PEAK_OPS)
            e3_cases.append(case)
    results["megakernel_probe"]["cases"] += e3_cases
    for c in e1_cases + e3_cases:
        print(f"[probes] {c['case']}: kernel {c['ms']:.4f} ms "
              f"({c['tops']:.1f} T/s, {c['bound_ms'] / c['ms']:.1%} of the "
              f"bound), mma.sync (recorded) {c['mma_recorded_ms']}, plain "
              f"{c['plain_ms']:.4f} ms, library {c['library_ms']}, bound "
              f"{c['bound_ms']:.4f} ms ({c['bound_by']})"
              + (f", computed/own ops {c['issued_ops'] / c['ops']:.3f}, m64 "
                 f"tiles/own {c['tiled_ops'] / c['ops']:.3f}"
                 if "issued_ops" in c else "")
              + (f"; {c['stage_launches']:.0f} stage launches "
                 f"{c['stage_ms']:.4f} ms, pad {c['other_ms']:.4f} ms, "
                 f"launch gap {c['gap_ms']:.4f} ms "
                 f"({c['gap_lo_ms']:.4f}-{c['gap_hi_ms']:.4f} over the "
                 f"traces; {c['gap_ms'] / max(c['launches'] - 1, 1):.4f} "
                 f"between two of its {c['launches']} kernels)"
                 if "gap_ms" in c else ""))
    print(f"[probes] the mma.sync times: {mma3['device']} "
          f"({MMA_MEGAKERNEL.name}, {MMA_CHAIN.name})")

    # E4: the kernel rung's add-one at its size, by the chained timing (the
    # launch and event overheads cancel: the kernel, not the launch), then
    # the ladder
    x = torch.ones((256, 256), dtype=torch.float32, device=dev)
    y = PK.add_one(x)
    torch.cuda.synchronize()
    require(torch.equal(y, PK.add_one_plain(x)), "add_one differs from x + 1")
    case = {"case": "E4 f32 [256, 256] + 1 (chained)",
            "ms": timing.measure(PK.add_one, x, 0.0).ms,
            "plain_ms": timing.measure(PK.add_one_plain, x, 0.0).ms,
            "library_ms": timing.measure(lambda y: torch.add(y, 1.0), x,
                                         0.0).ms,
            "event_ms": time_ms(lambda: PK.add_one(x), 20),
            "event_library_ms": library_ms(lambda: torch.add(x, 1.0),
                                           "add_one"),
            "max_abs_err": 0.0}
    case["bound_ms"], case["bound_by"] = bound(0, 2 * x.numel() * 4)
    results["add_one"]["cases"].append(case)
    print(f"[probes] {case['case']}: kernel {case['ms']:.4f} ms, plain "
          f"{case['plain_ms']:.4f} ms, torch.add {case['library_ms']:.4f} ms, "
          f"bound {case['bound_ms']:.6f} ms; one launch by events: kernel "
          f"{case['event_ms']:.4f} ms, torch.add {case['event_library_ms']}")
    ladder = P4.ladder(P4.RUNGS, "cuda")
    require(all(" PASS " in ln for ln in ladder), "a rung of the ladder "
            "failed: " + " | ".join(ln for ln in ladder if " FAIL " in ln))
    return {"launches": {k: counts[k] for k in PROBE_KERNELS},
            "e1": [_rates(r) for r in e1], "e3": [_rates(r) for r in e3],
            "e1_library_split": e1_split, "verdicts": verdicts,
            "ladder": ladder}


def phase_pipeline(results: dict) -> dict:
    """E2's lagged conv in both modes against its plain version (the act's
    tolerance) and against #5 and #2 bit for bit: the experiment's
    128x80x80x128 -> 128 at SILU and NONE on its own draws (the plain
    version on 2 images), a ragged 16x45x77x96 -> 72 LEAKY_RELU, a small
    3x17x9x32 -> 16 RELU; then the probe's path, ``probes.pipeline.run``
    at the experiment's shape, with the launch counts set to 0 before and
    read after; the kernel's line (LAG = 1) beside the plain version on
    all 128 images, fp16 ``F.conv2d`` and the bound; both modes at SILU and
    NONE beside the ``mma.sync`` kernel's recorded times (``MMA_LAGGED``)."""
    import numpy as np
    import torch
    from thingino_accel_tpu_torch.ops import fused_kernels as FK
    from thingino_accel_tpu_torch.ops import probe_kernels as PK
    from thingino_accel_tpu_torch.probes import pipeline as P2

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    pads = ((1, 1), (1, 1))
    w_np, b_np, xs_np = P2.draws(n_inputs=1)
    e2 = (torch.from_numpy(xs_np[0]).to(dev), P2.to_ohwi(w_np).to(dev),
          torch.from_numpy(b_np).to(dev))
    rng = np.random.default_rng(7)
    ragged = (torch.from_numpy(rng.integers(-128, 128, (16, 45, 77, 96),
                                            dtype=np.int8)).to(dev),
              torch.from_numpy(rng.integers(-128, 128, (72, 3, 3, 96),
                                            dtype=np.int8)).to(dev),
              torch.from_numpy(rng.integers(-2000, 2000, 72).astype(
                  np.int32)).to(dev))
    ragged_ep = FK.epilogue_rows(
        rng.uniform(0.005, 0.015, 72).astype(np.float32), 0.01,
        float(0.0137 * np.sqrt(9 * 96)), "LEAKY_RELU", 72, device=dev)
    small = (torch.from_numpy(rng.integers(-128, 128, (3, 17, 9, 32),
                                           dtype=np.int8)).to(dev),
             torch.from_numpy(rng.integers(-128, 128, (16, 3, 3, 32),
                                           dtype=np.int8)).to(dev),
             torch.from_numpy(rng.integers(-2000, 2000, 16).astype(
                 np.int32)).to(dev))
    eps = {"LEAKY_RELU": ragged_ep,
           "RELU": FK.epilogue_rows(
               rng.uniform(0.005, 0.015, 16).astype(np.float32), 0.01,
               float(0.0137 * np.sqrt(9 * 32)), "RELU", 16, device=dev)}
    cases = [
        ("E2 128x80x80x128 -> 128", e2, "SILU", P2.CHECK_IMAGES),
        ("E2 128x80x80x128 -> 128", e2, "NONE", P2.CHECK_IMAGES),
        ("ragged 16x45x77x96 -> 72", ragged, "LEAKY_RELU", 16),
        ("small 3x17x9x32 -> 16", small, "RELU", 3),
    ]
    checks = {}
    for label, (x, w, b), act, n_plain in cases:
        ep = eps.get(act) or P2.epilogue(act, P2.O, dev)
        hw = tuple(x.shape[1:3])
        dma = FK.conv2d_int8_halo_fused(x, w, b, ep, hw, pads, 1,
                                        pipeline="dma")
        blockspec = FK.conv2d_int8_halo_fused(x, w, b, ep, hw, pads, 1)
        plain = PK.conv3x3_lagged_plain(x[:n_plain], w, b, ep)
        for lag in (1, 0):
            out = PK.conv3x3_lagged(x, w, b, ep, bool(lag))
            torch.cuda.synchronize()
            what = f"{label} {act} LAG {lag}"
            dmax = compare(out[:n_plain], plain, act, f"{what} vs plain")
            require(torch.equal(out, dma), f"{what}: differs from #5")
            require(torch.equal(out, blockspec), f"{what}: differs from #2")
            note_err(results, LAGGED, dmax)
            checks[what] = dmax
    print(f"[pipeline] {len(checks)} cases == plain (on {P2.CHECK_IMAGES} "
          f"images at E2's shape) and == #5 and #2 bit for bit: "
          + ", ".join(f"{k} {v}" for k, v in checks.items()))

    reset_launches()
    res = P2.run()
    torch.cuda.synchronize()
    counts = read_launches()
    want = 2 + 4 * (P2.N_INPUTS + P2.ITERS)   # the checks, then 4 timings
    require(counts[LAGGED] == want, f"the probe's path launched {LAGGED} "
            f"{counts[LAGGED]} times, expected {want}")
    require(max(res["max_diff"].values()) == 0,
            f"the probe's lagged vs baseline: {res['max_diff']}")
    results[LAGGED]["launches"] = counts[LAGGED]
    for line in P2.table(res, P2.BATCH, P2.H, P2.C, P2.O):
        print(f"[pipeline] {line}")

    x, w, b = e2
    ep = P2.epilogue(P2.ACT, P2.O, dev)
    out = PK.conv3x3_lagged(x, w, b, ep)
    case = {"case": f"E2 {P2.BATCH}x{P2.H}x{P2.H}x{P2.C} -> {P2.O} "
                    f"{P2.ACT} LAG 1",
            "ms": res["ms"]["LAG 1"], "lag0_ms": res["ms"]["LAG 0"],
            "ms_none": res["ms_none"],
            "blockspec_ms": res["ms"]["baseline (#2)"],
            "dma_ms": res["ms"]["dma (#5)"],
            "plain_ms": time_ms(
                lambda: PK.conv3x3_lagged_plain(x, w, b, ep), 3, warmup=1),
            "library_ms": res["ms"]["fp16 F.conv2d"],
            "max_abs_err": results[LAGGED]["max_abs_err"],
            "plan": list(dataclasses.astuple(res["plan"])),
            "occupancy": res["occupancy"]}
    case["bound_ms"], case["bound_by"] = bound(*conv_work(x, w, out,
                                                          8 * P2.O))
    record = json.loads(MMA_LAGGED.read_text())
    case["mma_recorded_ms"] = record["ms"]
    for act, ms in (("SILU", res["ms"]), ("NONE", res["ms_none"])):
        for lag in (1, 0):
            label = f"E2 128x80x80x128 -> 128 {act} LAG {lag}"
            print(f"[pipeline] {label}: wgmma {ms[f'LAG {lag}']:.4f} ms, the "
                  f"mma.sync kernel (recorded, {record['device']}) "
                  f"{record['ms'].get(label)} ms")
    results[LAGGED]["cases"].append(case)
    secs = time.perf_counter() - t0
    print(f"[pipeline] {case['case']}: kernel {case['ms']:.4f} ms, plain "
          f"{case['plain_ms']:.4f} ms, library {case['library_ms']:.4f} ms, "
          f"bound {case['bound_ms']:.4f} ms ({case['bound_by']}); launches "
          f"{counts[LAGGED]}; phase {secs:.1f} s")
    return {"checks": checks, "ms": res["ms"], "ms_none": res["ms_none"],
            "plan": case["plan"], "occupancy": res["occupancy"],
            "launches": counts[LAGGED], "seconds": secs}


def decode_case(results: dict, kernel: str, heads, label: str,
                scales=None) -> dict:
    """#8 on ``heads`` against its plain version, both timed, with its
    bound (bytes only: the heads read once, boxes, conf and class written
    once; no single library call decodes)."""
    import torch
    from thingino_accel_tpu_torch.models import yolo as Y
    from thingino_accel_tpu_torch.ops import decode_kernel as DK
    got = DK.decode_and_parse_fused(heads, scales=scales)
    torch.cuda.synchronize()
    dmax = compare_decode(got, Y.decode_and_parse(heads, scales=scales),
                          f"decode {label}")
    ms = time_ms(lambda: DK.decode_and_parse_fused(heads, scales=scales), 20)
    plain_ms = time_ms(lambda: Y.decode_and_parse(heads, scales=scales), 5,
                       warmup=1)
    case = {"case": label, "ms": ms, "plain_ms": plain_ms,
            "max_abs_err": dmax, "library_ms": None}
    case["bound_ms"], case["bound_by"] = bound(0, sum(
        h.numel() * h.element_size() for h in heads) + sum(
        t.numel() * t.element_size() for t in got))
    results[kernel]["cases"].append(case)
    note_err(results, kernel, dmax)
    print(f"[decode] {kernel:24s} {label}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {case['bound_ms']:.4f} ms "
          f"({case['bound_by']}, {100 * case['bound_ms'] / ms:.1f}% of "
          f"it), max |diff| {dmax:.3g}")
    return case


def phase_fast(results: dict) -> dict:
    """The fast tier, the JAX bench's default path, on the real yolov5n and
    the zoo yolov5s at 640 (``trace_path.fast_graph``: the stem rewritten
    to s2d): uint8 1280x720 frames -> letterbox -> s2d -> bf16 quantize ->
    the dequantized bf16 graph (``F.conv2d``) -> #8 on the bf16 heads ->
    NMS, through StreamServer, beside the serving tier on the same model
    (its stem as it is) and frames."""
    import numpy as np
    import torch
    from thingino_accel_tpu_torch.models import yolo as Y
    from thingino_accel_tpu_torch.runtime.engine import Engine, EngineOptions
    from thingino_accel_tpu_torch.runtime.executor import build_executor
    from thingino_accel_tpu_torch.runtime.serving import StreamServer
    from thingino_accel_tpu_torch.trace_path import fast_graph

    dev = torch.device("cuda")
    frames = frames_of(BATCHES)
    res = {}
    for model in FAST_MODELS:
        what = "fast " + ("real yolov5n" if model == "yolov5n"
                          else "zoo yolov5s 640")
        t0 = time.perf_counter()
        fast = Engine(fast_graph(model), EngineOptions(
            precision="fast", quantize_outputs=False), device=dev)
        serving = Engine(fast_graph(model, s2d=False),
                         EngineOptions(precision="serving"), device=dev)
        require(fast.options.compute_dtype == torch.bfloat16
                and all(fast.graph.tensors[o].dtype == np.float32
                        for o in fast.output_names),
                f"{what}: the engine is not the bf16 tier with float heads")
        pipes = {"fast": Y.build_serving_pipeline(fast),
                 "serving": Y.build_serving_pipeline(serving)}
        in_t = serving.graph.tensors[serving.input_names[0]]
        target = (in_t.shape[1], in_t.shape[2])   # the letterbox's
        for p in pipes.values():   # warm-up: allocator, cuDNN's first use
            p(torch.from_numpy(frames[0]).to(dev))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0

        reset_launches()
        server = StreamServer(pipes["fast"], depth=2, device=dev)
        outs = list(server.run(frames))
        torch.cuda.synchronize()
        counts = read_launches()
        want = {k: 0 for k in counts}
        want[FAST_DECODE] = BATCHES
        require(len(outs) == BATCHES and all(o is not None for o in outs)
                and server.stats.errors == 0, f"{what}: failed batches")
        require(counts == want, f"{what}: launches {counts}, expected "
                                f"{want}: #8 once a batch on bf16 heads")
        if model == "yolov5n":
            results[FAST_DECODE]["launches"] = counts[FAST_DECODE]
        dets = check_detections(outs, target)
        print(f"[fast] {what}: engine + warm-up {build_s:.2f} s; "
              f"{BATCHES}-batch run {server.stats.summary()}; launches "
              f"{ {k: v for k, v in counts.items() if v} } (#8 bf16 once a "
              f"batch, no other kernel); detections per frame mean "
              f"{float(np.mean(dets))}")

        # the two tiers in turns, 12 batches each: serving, fast, fast,
        # serving
        runs = {"serving": [], "fast": []}
        for tier in ("serving", "fast", "fast", "serving"):
            st = StreamServer(pipes[tier], depth=2, device=dev)
            for o in st.run(frames[i % BATCHES] for i in range(12)):
                require(o is not None, f"{what}: failed {tier} batch")
            runs[tier].append({"fps": st.stats.fps,
                               "p50_ms": st.stats.latency_ms(50),
                               "p99_ms": st.stats.latency_ms(99)})
        for tier, rs in runs.items():
            print(f"[fast] {what}: {tier} tier, 12-batch steady runs: "
                  + "; ".join(f"{r['fps']:.1f} fps, p50 {r['p50_ms']:.3f} "
                              f"ms, p99 {r['p99_ms']:.3f} ms" for r in rs))

        # the card's bf16 heads against the CPU's float32 forward
        x = Y.quantize_input_int8(Y.space_to_depth(Y.letterbox_uint8(
            torch.from_numpy(frames[0]).to(dev), target)), torch.bfloat16)
        heads = fast.forward(x)
        cpu = build_executor(fast.graph, "cpu", precision="fast")
        ref = cpu(cpu.device_params(fast._np_params),
                  {fast.input_names[0]: x[:FAST_CPU_FRAMES].cpu()})
        rel = max(float((heads[k][:FAST_CPU_FRAMES].cpu().float() - r)
                        .abs().max() / r.abs().max()) for k, r in ref.items())
        require(rel <= FAST_HEAD_TOL, f"{what}: bf16 heads {rel:.4g} of the "
                                      f"largest |head| from the f32 forward")
        # detections of those frames: the card's pipeline (conf 0.25) and
        # its heads' decode + NMS at conf 0.001, against the same from the
        # CPU's float32 forward, beside the CPU's own bf16 forward
        cpu16 = build_executor(fast.graph, "cpu", precision="fast",
                               compute_dtype=torch.bfloat16)
        ref16 = cpu16(cpu16.device_params(fast._np_params),
                      {fast.input_names[0]: x[:FAST_CPU_FRAMES].cpu()})
        names = fast.output_names
        nms = lambda hs, conf: Y.nms_batched(
            *Y.decode_and_parse([hs[k] for k in names]), conf_thresh=conf,
            max_dets=100, pre_nms=128, topk_group=8)
        card_hs = {k: heads[k][:FAST_CPU_FRAMES].cpu() for k in names}
        card = pipes["fast"](torch.from_numpy(
            frames[0][:FAST_CPU_FRAMES]).to(dev))
        shares = []
        for conf in (0.25, 0.001):
            c = (Y.Detections(*(t.cpu() for t in (
                card.boxes, card.scores, card.classes, card.valid)))
                if conf == 0.25 else nms(card_hs, conf))
            r32, r16 = nms(ref, conf), nms(ref16, conf)
            # (matched, total) of each pair
            mc, m16 = Y.match_counts(c, r32), Y.match_counts(r16, r32)
            u16 = m16[1] - m16[0]
            row = {"conf": conf, "card": int(c.num.sum()),
                   "cpu_f32": int(r32.num.sum()),
                   "cpu_bf16": int(r16.num.sum()),
                   "card_vs_f32": mc, "cpu_bf16_vs_f32": m16,
                   "card_vs_cpu_bf16": Y.match_counts(c, r16),
                   "card_unmatched": mc[1] - mc[0],
                   "allowed": u16 + 3 * math.sqrt(2 * max(u16, 1))}
            shares.append(row)
            require(model not in FAST_DETS_GATED
                    or row["card_unmatched"] <= row["allowed"],
                    f"{what}: detections at conf {conf}: {row}")
        print(f"[fast] {what}: card bf16 vs CPU f32, {FAST_CPU_FRAMES} "
              f"frames: heads within {rel:.4g} of the largest |head| (bound "
              f"{FAST_HEAD_TOL}); detections (matched, total) at IoU >= "
              f"0.9, same class"
              f"{'' if model in FAST_DETS_GATED else ', not held'}: "
              f"{shares}")

        # #8's bf16 mode against its plain version on these heads
        cases = []
        for nb in ((16, 1) if model == "yolov5n" else (16,)):
            hs = [heads[k][:nb].contiguous() for k in names]
            sizes = ",".join(str(h.shape[1]) for h in hs)
            cases.append(decode_case(
                results, FAST_DECODE, hs,
                f"3 heads {nb}x({sizes})^2x255 bf16 ({model})"))
        res[model] = {"launches": counts, "runs": runs,
                      "head_rel_diff": rel, "detections": shares,
                      "dets_per_frame_mean": float(np.mean(dets)),
                      "decode": cases}
    return res


def main() -> int:
    if not (REPO / "thingino_accel_tpu_torch" / "csrc").is_dir() \
            or not MODEL.exists() or not NANODET.exists():
        print("chip_smoke: FAIL: run it from a checkout of the repository "
              "(the port package and models/ are missing here)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    sys.modules["jax"] = None   # the port must never need JAX
    sys.modules["thingino_accel_tpu"] = None   # nor the JAX package
    t_start = time.perf_counter()
    try:
        import torch
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        name, smi = phase_device()
        build_s = phase_build()
        sass = sass_counts()
        results = {k: {"cases": [], "max_abs_err": 0, "launches": 0}
                   for k in KERNEL_INFO}
        phase_kernels(results)
        exact_kxk = phase_exact_kernels(results)
        phase_dma_kernels(results)
        slice_res = phase_slice(results)
        unplanned_res = phase_unplanned(results)
        zoo_res = phase_zoo_s(results)
        nanodet_res = phase_nanodet(results)
        exact_res = phase_exact(results)
        probe_checks = phase_probe_checks(results)
        probes_res = phase_probes(results)
        pipeline_res = phase_pipeline(results)
        fast_res = phase_fast(results)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAIL", file=sys.stderr)
        return 1

    kernels = []
    for k, r in results.items():
        rep = r["cases"][0]   # the first case, at a path's shape
        kernels.append({"name": k, "route": "cuda", **KERNEL_INFO[k],
                        "launches": r["launches"],
                        "max_abs_err": r["max_abs_err"], "ms": rep["ms"],
                        "plain_ms": rep["plain_ms"],
                        "bound_ms": rep["bound_ms"],
                        "bound_by": rep["bound_by"],
                        "library_ms": rep["library_ms"], "at": rep["case"],
                        "path": PATH_OF[k]})
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "device": name, "nvidia_smi": smi, "build_s": build_s,
        "total_s": time.perf_counter() - t_start, "sass": sass,
        "kernels": results,
        "slice": slice_res, "unplanned": unplanned_res,
        "zoo_yolov5s": zoo_res, "nanodet": nanodet_res,
        "exact": exact_res, "exact_kxk": exact_kxk,
        "probe_checks": probe_checks,
        "probes": probes_res, "pipeline": pipeline_res,
        "fast": fast_res}, indent=1))
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
