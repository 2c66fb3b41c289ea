#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``thingino_accel_tpu_torch``)
on one NVIDIA GPU (built for Hopper, sm_90a).

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases:

1. Device: name, power limit, torch / CUDA / nvcc versions.
2. Build: compile the kernels in ``thingino_accel_tpu_torch/csrc/`` with
   nvcc, one process per source, all started together (timed).
3. Kernels vs their plain torch versions on the card at the paths'
   shapes (NONE, LEAKY_RELU and SILU, per-channel scales, residual modes;
   the depthwise kernel at NanoDet's shapes; the head decode on the real
   yolov5n's heads at batch 16 and 1); median CUDA-event times of both.
4. The main path: the planned serving tier (``Engine(precision=
   "serving")``) on the real-weight ``models/yolov5n_cal_int8.mars`` at
   640x640 through letterbox -> int8 quantize -> network -> decode (one
   kernel over the three heads) -> NMS inside the port's ``StreamServer``
   (depth 2), 4 batches of 16 uint8 1280x720 frames made from a seed, then
   12 more batches for steadier numbers. Checks: no failed batch; the
   launches of each conv kernel equal 4x its count in the plan's schedule,
   and the decode launches once per batch; finite detections inside the
   frame; every kernel unit of one batch (inputs captured on the card)
   against its plain version; one frame step by step on the card against
   the CPU path (the path the tests hold against JAX); decode + NMS on
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
   version; one frame's heads on the card against the CPU path.
8. The exact tier (``Engine(precision="exact")``) on the zoo yolov5s at
   640 (random weights from seed 0, per-tensor scales): kernels #9, #10 and
   #11 against their plain versions at the model's lead shapes (both
   RoundModes, RELU after the clamp, dilation 2, stride (2, 1)), then
   letterbox -> int8 quantize -> network -> decode -> NMS through
   ``StreamServer`` (depth 2), 4 batches of 16 uint8 1280x720 frames:
   launches 4 x {#9: 42, #10: 11, #11: 7} plus one decode a batch and no
   plain conv; every conv of one batch against its plain version; one
   frame step by step on the card against the CPU path, and its heads.
9. The slab-ring KxK conv (#5, ``conv2d_int8_halo_fused(pipeline="dma")``,
   ``csrc/conv_int8_dma.cu``) at #2's lead shape, 16x80x80x128 -> 128, a
   3x3/s2, the 6x6/s2 stem and a ragged case: equal to its plain version
   and to #2 bit for bit, timed beside #2, the plain version and fp16
   ``F.conv2d``.
10. Its path, inside phases 4 and 6: the batch of 16 whose units were
   just held against their plain versions, through the planned real
   yolov5n and the planned zoo yolov5s at 640; every KxK conv unit
   without a residual re-run on its recorded input through #5 (one
   launch each, no other kernel), equal to its plain version on that
   input (the tolerance below) and to the unit's output (#2's) bit for
   bit; the per-forward sums of both kernels' times. No engine path
   routes to #5, as no JAX executor path runs the DMA variant.

Each path is run with the launch counters set to 0 just before it and
read just after. Tolerances (as in ``tests/test_torch_fused_kernels.py``):
NONE/RELU/LEAKY_RELU bit-exact; SILU at most 1 quantum on at most 0.1% of
the elements (the kernel's ``expf`` and torch's sigmoid differ by ulps).
The head decode: classes exact, boxes within rtol 1e-6 / atol 1e-5, conf
within rtol 1e-6 / atol 1e-7, detections after NMS equal.

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
PEAK_OPS, PEAK_BYTES = 1979e12, 3.35e12   # H100 SXM: int8 TOP/s, HBM B/s

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
# the YOLO pipelines decode their three heads in one launch per batch
DECODE = "decode_and_parse_fused"
# the slab-ring KxK conv (#5): no engine path routes to it, as no JAX
# executor path runs conv2d_int8_folded(pipeline="dma"); its path is the
# replay of the planned models' KxK conv units through it
DMA = "conv2d_int8_halo_dma"
DMA_PATH = "planned yolov5n + zoo yolov5s 640, KxK units replayed"
KERNEL_INFO = {
    "matmul_int8_fused": {
        "source": "thingino_accel_tpu_torch/csrc/mm_int8_fused.cu",
        "replaces": "thingino_accel_tpu/ops/fused_kernels.py:241"},
    "conv2d_int8_halo_fused": {
        "source": "thingino_accel_tpu_torch/csrc/conv_int8_fused.cu",
        "replaces": "thingino_accel_tpu/ops/fused_kernels.py:544"},
    "matmul_int8_fused_multi": {
        "source": "thingino_accel_tpu_torch/csrc/mm_multi_int8_fused.cu",
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
    "matmul_int8_requant": {
        "source": "thingino_accel_tpu_torch/csrc/requant_int8.cu",
        "replaces": "thingino_accel_tpu/ops/pallas_kernels.py:120"},
    "conv2d_int8_halo": {
        "source": "thingino_accel_tpu_torch/csrc/requant_int8.cu",
        "replaces": "thingino_accel_tpu/ops/pallas_kernels.py:216"},
    "conv2d_int8": {
        "source": "thingino_accel_tpu_torch/csrc/requant_int8.cu",
        "replaces": "thingino_accel_tpu/ops/pallas_kernels.py:300 "
                    "(_tapconv_call :388)"},
    DMA: {
        "source": "thingino_accel_tpu_torch/csrc/conv_int8_dma.cu",
        "replaces": "thingino_accel_tpu/ops/fused_kernels.py:942 "
                    "(pipeline=\"dma\", _halo_kernel_dma :817)"},
}
# the path whose run gives each kernel's launch count
PATH_OF = {k: "planned real yolov5n" for k in KERNEL_INFO}
PATH_OF["sppf_int8_fused"] = "planned zoo yolov5s 640"
PATH_OF["depthwise_conv2d_int8_fused"] = "planned nanodet 320"
for _k in ("matmul_int8_requant", "conv2d_int8_halo", "conv2d_int8"):
    PATH_OF[_k] = "exact zoo yolov5s 640"
PATH_OF[DMA] = DMA_PATH


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


def bound(ops: float, nbytes: float) -> tuple:
    """The least time the card could take (ms) and what bounds it."""
    t_ops, t_bytes = ops / PEAK_OPS, nbytes / PEAK_BYTES
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
    from thingino_accel_tpu_torch.ops import requant_kernels as RK
    FK.reset_launches()
    DK.reset_launches()
    RK.reset_launches()
    C.reset_counts()


def read_launches() -> dict:
    from thingino_accel_tpu_torch.ops import conv as C
    from thingino_accel_tpu_torch.ops import decode_kernel as DK
    from thingino_accel_tpu_torch.ops import fused_kernels as FK
    from thingino_accel_tpu_torch.ops import requant_kernels as RK
    return {**FK.launches, **DK.launches, **RK.launches, **C.counts}


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
    from thingino_accel_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    cuda_build.load_library()
    secs = time.perf_counter() - t0
    log = cuda_build.library_path().with_suffix(".log")
    for line in log.read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")
    print(f"[build] {len(cuda_build.SOURCES)} sources built and loaded in "
          f"{secs:.3f} s")
    return secs


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

    # multi-part matmul: the C3 cv3 of model.4 (2 parts, equal scales) and
    # SPPF's concat with 4 parts of different scales
    for label, m, parts, scales, n in [
            ("2 parts M=16*80*80 K=64+64 N=128, equal scales",
             16 * 80 * 80, (64, 64), (0.05, 0.05), 128),
            ("4 parts M=16*20*20 K=4x128 N=256, different scales",
             16 * 20 * 20, (128,) * 4, (0.038, 0.046, 0.047, 0.049), 256)]:
        xs = [rnd((m, k)) for k in parts]
        wfull = rnd((n, sum(parts)))
        ws, off = [], 0
        for k in parts:
            ws.append(wfull[:, off:off + k])
            off += k
        bias = bias_of(n)
        xcat = torch.cat(xs, 1)
        for act in ("NONE", "SILU"):
            me = FK.multi_epilogue(wscale(n), scales, 0.9, act, n,
                                   bias_scale=0.045, device=dev)
            run_case("matmul_int8_fused_multi", label, act,
                     lambda: FK.matmul_int8_fused_multi(xs, ws, bias, me),
                     lambda: FK.matmul_int8_fused_multi_plain(xs, ws, bias,
                                                              me),
                     lambda out, m=m, k=sum(parts), n=n: (
                         2 * m * k * n, m * k + n * k + 8 * n + out.numel()),
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
        if not results[DECODE]["cases"]:
            # bytes only: the heads read once, boxes/conf/class written
            # once; no single library call decodes
            case["bound_ms"], case["bound_by"] = bound(0, sum(
                h.numel() for h in heads) + sum(
                t.numel() * t.element_size() for t in got))
            case["library_ms"] = None
        results[DECODE]["cases"].append(case)
        note_err(results, DECODE, dmax)
        print(f"[kernels] {DECODE:24s} {label}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, max |diff| {dmax:.3g}")


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
    """The letterbox of one frame, card vs CPU within 1 on uint8; returns
    the card's int8 network input."""
    import torch
    from thingino_accel_tpu_torch.models import yolo as Y
    frame = torch.from_numpy(frame_u8)
    boxed = Y.letterbox_uint8(frame.cuda(), target)
    d = (boxed.cpu().to(torch.int32)
         - Y.letterbox_uint8(frame, target).to(torch.int32)).abs()
    require(int(d.max()) <= 1, f"letterbox card vs CPU: max {int(d.max())}")
    return Y.quantize_input_int8(boxed)


def check_steps_against_cpu(eng, x) -> int:
    """One frame through the planned schedule on the card, each step held
    against the same step on the CPU path (plain kernels and torch ops,
    the path the tests hold against JAX) on the card's own inputs: SILU
    units within the SILU tolerance, every other step bit-exact."""
    from thingino_accel_tpu_torch.runtime.engine import Engine, EngineOptions
    from thingino_accel_tpu_torch.runtime.executor import KernelUnit
    cpu = Engine.from_yolo_mars(str(MODEL), EngineOptions("serving"),
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
    cpu = Engine.from_yolo_mars(str(MODEL), EngineOptions("serving"),
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
    eng = Engine.from_yolo_mars(str(MODEL), EngineOptions("serving"),
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
    x1 = check_letterbox_on_card(frames[0][:1], target)
    n_steps = check_steps_against_cpu(eng, x1)
    print(f"[slice] card vs CPU, one frame: {n_steps} planned steps within "
          "tolerance")
    n_dets = check_postprocess_on_card(dev, results)
    print(f"[slice] decode + NMS on tie-heavy heads: kernel decode == plain "
          f"decode on the card == CPU ({n_dets} detections)")

    # planned vs unplanned tier on the same batch (PERF.md open question)
    unplanned = Engine.from_yolo_mars(str(MODEL), EngineOptions("serving"),
                                      device=dev, planned=False)
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
    }


def phase_unplanned(results: dict) -> dict:
    """The unplanned tier, kept as the tests' oracle: 1 batch."""
    import torch
    from thingino_accel_tpu_torch.models import yolo as Y
    from thingino_accel_tpu_torch.runtime.engine import Engine, EngineOptions
    from thingino_accel_tpu_torch.runtime.serving import StreamServer

    dev = torch.device("cuda")
    eng = Engine.from_yolo_mars(str(MODEL), EngineOptions("serving"),
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
    n_nodes = check_nodes_against_cpu(eng, check_letterbox_on_card(
        frames[0][:1], target))
    print(f"[unplanned] teacher-forced kernel vs plain: {n_conv} convs; "
          f"card vs CPU, one frame: {n_nodes} nodes within tolerance")
    return {"launches": counts, "fps": server.stats.fps,
            "teacher_forced_convs": n_conv, "nodes_card_vs_cpu": n_nodes}


def phase_zoo_s(results: dict) -> dict:
    """The zoo yolov5s at 640, planned: the path that runs SPPF."""
    import numpy as np
    import torch
    from thingino_accel_tpu_torch.models import zoo
    from thingino_accel_tpu_torch.runtime.engine import Engine

    dev = torch.device("cuda")
    eng = Engine(zoo.build_yolov5("s", zoo.ZooConfig(in_hw=(640, 640))),
                 device=dev)
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
    return {"launches": counts, "census_per_forward": census,
            "forward_s_2_batches": secs, "units_checked": n_units,
            "dma_replay": dma}


def phase_nanodet(results: dict) -> dict:
    """The committed NanoDet-320 (depthwise), planned, through
    StreamServer: letterbox -> int8 quantize -> network -> heads."""
    import numpy as np
    import torch
    from thingino_accel_tpu_torch.models import yolo as Y
    from thingino_accel_tpu_torch.runtime.engine import Engine
    from thingino_accel_tpu_torch.runtime.serving import StreamServer

    dev = torch.device("cuda")
    eng = Engine.from_mars(str(NANODET), device=dev)
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
    n_units = len(check_units(eng, x, results, "nanodet"))
    cpu = Engine.from_mars(str(NANODET), device="cpu")
    card, ref = eng.run(x[:1]), cpu.run(x[:1].cpu())
    for k in eng.output_names:
        compare(card[k].cpu(), ref[k], "NONE", f"nanodet head {k} card vs CPU")
    spread = min(len(np.unique(ref[k].numpy())) for k in ref)
    print(f"[nanodet] kernel vs plain on every unit of one batch: {n_units} "
          f"units within tolerance; one frame's heads on the card == CPU "
          f"(min {spread} distinct values per head)")
    return {"launches": counts, "census_per_forward": census,
            "fps_4batch": st.fps, "p50_ms_4batch": st.latency_ms(50),
            "p99_ms_4batch": st.latency_ms(99), "units_checked": n_units}


def phase_exact_kernels(results: dict) -> None:
    """Kernels #9-#11 against their plain versions, bit for bit, at the
    exact zoo yolov5s's lead shapes at batch 16, then both RoundModes and
    RELU on one shape each, one dilation-2 case and one stride-(2, 1) case
    (only #11 takes those two; no model here reaches them)."""
    import numpy as np
    import torch
    from thingino_accel_tpu_torch.ops import requant_kernels as RK
    from thingino_accel_tpu_torch.ops.quant import RoundMode

    rng = np.random.default_rng(4)
    dev = torch.device("cuda")
    half, trunc = RoundMode.HALF_AWAY, RoundMode.PLUS_HALF_TRUNC

    def rnd(shape):
        return torch.from_numpy(
            rng.integers(-128, 128, shape, dtype=np.int8)).to(dev)

    # (kernel, label, x shape, OHWI w shape, stride, dilation, pads,
    # round mode, relu)
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
    for kernel, label, xs, ws, st, dil, p, rm, relu in cases:
        x, wt = rnd(xs), rnd(ws)
        o, kh, kw, c = ws
        bias = torch.from_numpy(
            rng.integers(-3000, 3000, o).astype(np.int32)).to(dev)
        out_hw = tuple((xs[1 + i] + 2 * p - (ws[1 + i] - 1) * dil[i] - 1)
                       // st[i] + 1 for i in range(2))
        pads = ((p, p), (p, p))
        args = (x, wt, bias, out_hw, st, dil, pads, 0.05, 0.01,
                float(0.0137 * np.sqrt(kh * kw * c)), rm, relu)
        require(RK.route((kh, kw), st, dil, pads) == kernel,
                f"{label} routes to {RK.route((kh, kw), st, dil, pads)}")
        if kernel == "matmul_int8_requant":
            library = int_mm_call(x.reshape(-1, c), wt.reshape(o, c))
        else:
            library = conv_fp16_call(x, wt, st, p, dil)
        # the exact convs are compared bit for bit ("NONE")
        time_case(results, "exact", kernel,
                  f"{label} {rm.name}{' relu' if relu else ''}", "NONE",
                  lambda args=args: RK.conv2d_int8(*args),
                  lambda args=args: RK.conv2d_int8(*args, plain=True),
                  lambda out, x=x, wt=wt, o=o: conv_work(x, wt, out, 4 * o),
                  library)


def check_exact_steps_against_cpu(eng, cpu, x) -> tuple:
    """One frame through the exact schedule on the card, each step held
    against the same step on the CPU path (the path the tests hold
    against JAX) on the card's own inputs: convs and every non-float step
    bit-exact, the SiLU steps within the SILU tolerance. Returns the
    number of steps and the share of head values where the card's forward
    and the CPU's differ end to end, with the largest difference."""
    import torch
    from thingino_accel_tpu_torch.runtime.executor import ActStep
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
        float_step = isinstance(step, ActStep) or getattr(
            step, "node", None) is not None and step.node.op in (
            "SIGMOID", "SILU", "SILU_FUSED", "SOFTMAX") and not step.is_kernel
        compare(env[step.out].cpu(), cenv[step.out],
                "SILU" if float_step else "NONE", f"card vs CPU {step.out}")
    card, ref = eng.run(x), cpu.run(x.cpu())
    diff = [(card[k].cpu().to(torch.int32) - ref[k].to(torch.int32)).abs()
            for k in eng.output_names]
    n_vals = sum(d.numel() for d in diff)
    share = sum(int((d > 0).sum()) for d in diff) / n_vals
    return len(steps), share, max(int(d.max()) for d in diff)


def phase_exact(results: dict) -> dict:
    """The exact tier's pipeline: the zoo yolov5s at 640 through
    StreamServer, letterbox -> int8 quantize -> network (#9-#11 and the
    plain SiLU steps) -> decode (#8) -> NMS."""
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
    n_units = len(check_units(eng, x, results, "exact zoo yolov5s"))
    require(n_units == 60, f"{n_units} kernel convs captured, expected 60")
    print(f"[exact] kernel vs plain on every conv of one batch: {n_units} "
          "convs bit for bit")
    cpu = Engine(g, exact, device="cpu")
    n_steps, share, dmax = check_exact_steps_against_cpu(
        eng, cpu, check_letterbox_on_card(frames[0][:1], target))
    print(f"[exact] card vs CPU, one frame: {n_steps} steps within "
          f"tolerance; heads end to end: {share:.6f} of the values differ, "
          f"max |diff| {dmax}")
    require(dmax <= 1 and share <= SILU_MAX_FRAC,
            f"exact heads card vs CPU: share {share}, max {dmax}")
    return {"launches": counts, "census_per_forward": census,
            "fps_4batch": st.fps, "p50_ms_4batch": st.latency_ms(50),
            "p99_ms_4batch": st.latency_ms(99),
            "dets_per_frame_mean": float(np.mean(dets_per_frame)),
            "units_checked": n_units, "steps_card_vs_cpu": n_steps,
            "heads_card_vs_cpu_share": share, "heads_card_vs_cpu_max": dmax}


def phase_dma_kernels(results: dict) -> None:
    """The slab-ring KxK conv (#5) against its plain version (the
    tolerance of the case's act) and against #2 (``"blockspec"``) bit for
    bit, at #2's lead shape, the TPU experiment's 16x80x80x128 -> 128, a
    3x3/s2, the 6x6/s2 stem and a ragged case; its time beside #2's, the
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
        plan = FK.dma_plan(xs[0], c, o, kk, kk, s, *out_hw,
                           FK.smem_limits(dev), x.data_ptr() % 16 == 0)
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
              f"{plan}; == plain (max |diff| {dmax}) and == #2")


def replay_dma(eng, rec: list, results: dict, what: str) -> dict:
    """The slab-ring kernel's path: every KxK conv unit (kind "conv", no
    residual) of a planned forward whose units ``check_units`` has just
    held against their plain versions, re-run on its recorded input
    through #5: one launch each and no other kernel, each output equal to
    the plain version on the same input (``compare``) and to the unit's
    own output (#2's) bit for bit. Both kernels timed per unit; the sums
    are per forward."""
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
        require(torch.equal(got, out), f"{what} {u!r}: dma differs from #2")
    dma_ms = sum(time_ms(call(u, r, "dma"), 10) for u, r, _ in units)
    bs_ms = sum(time_ms(call(u, r, "blockspec"), 10) for u, r, _ in units)
    print(f"[dma] {what}: {len(units)} KxK units replayed through the dma "
          f"kernel, each == plain and == #2 bit for bit; per forward dma "
          f"{dma_ms:.4f} ms, #2 {bs_ms:.4f} ms")
    return {"units": len(units), "dma_ms_per_forward": dma_ms,
            "blockspec_ms_per_forward": bs_ms,
            "shapes": [f"{tuple(r[u.x].shape)} k{u.node.attrs['kernel']}"
                       f" s{u.stride[0]} -> {u.ep.cs.shape[0]} {u.act}"
                       for u, r, _ in units]}


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
        results = {k: {"cases": [], "max_abs_err": 0, "launches": 0}
                   for k in KERNEL_INFO}
        phase_kernels(results)
        phase_exact_kernels(results)
        phase_dma_kernels(results)
        slice_res = phase_slice(results)
        unplanned_res = phase_unplanned(results)
        zoo_res = phase_zoo_s(results)
        nanodet_res = phase_nanodet(results)
        exact_res = phase_exact(results)
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
        "total_s": time.perf_counter() - t_start, "kernels": results,
        "slice": slice_res, "unplanned": unplanned_res,
        "zoo_yolov5s": zoo_res, "nanodet": nanodet_res,
        "exact": exact_res}, indent=1))
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
