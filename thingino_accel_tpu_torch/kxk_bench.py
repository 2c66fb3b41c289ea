"""The convs, one by one, on the card: every distinct KxK conv (#2,
``fused_kernels.conv2d_int8_halo_fused``) of the four serving paths,
timed through both of its entries (``pipeline="blockspec"``, #2, with the
conv's residual; ``"dma"``, #5, without) beside fp16 channels-last
``F.conv2d`` on the same shapes; every distinct 1x1 unit (#1
``matmul_int8_fused`` and #3 ``matmul_int8_fused_multi``, with the unit's
parts, scale branch and residual) through its entry beside
``torch._int_mm`` (the parts' K concatenated; null where it refuses the
shape); with ``exact1x1``, every distinct #9 unit
(``requant_kernels.matmul_int8_requant``, with its activation table where
the entry takes one) of the exact zoo yolov5s at 640 beside
``torch._int_mm``; with ``dw``, every distinct #7 unit
(``fused_kernels.depthwise_conv2d_int8_fused``) of NanoDet-320 beside
fp16 ``F.conv2d`` with groups = C; with ``dwplans``, each of those at
every plan ``fused_kernels.dw_plans`` offers up to 12 rows a tile, beside
the planner's pick; with ``bneck``, every distinct #6 unit
(``fused_kernels.bottleneck_int8_fused``) of the planned real yolov5n and
the planned zoo yolov5s at 640 beside the unfused tensor-core pair (#1's
1x1 into device memory, then #2's KxK with the shortcut) and fp16
``F.conv2d`` of the KxK stage alone; with ``sppf``, every distinct #4 unit
(``fused_kernels.sppf_int8_fused``) of the planned zoo yolov5s beside #3's
1x1 GEMM alone over the four levels (pooled beforehand by the plain
maxpool) and ``torch._int_mm`` over them concatenated; with ``fusedplans``, each of
those #6 and #4 units at every plan ``fused_kernels.bneck_plans`` /
``sppf_plans`` offers, beside the planner's pick; with ``decode``, the
head decode #8 (``decode_kernel.decode_and_parse_fused``) on the real
yolov5n's three int8 heads at 640 (80, 40 and 20 squared, 255 channels,
per-head scales) at batch 16 and 1; with ``lagged``, E2
(``probe_kernels.conv3x3_lagged``) at the experiment's 128x80x80x128 ->
128, both modes at SILU and NONE, each the mean of
``probes.pipeline.time_calls`` (50 calls over 4 distinct inputs); with
``laggedplans``, E2 there at every plan ``probe_kernels.lagged_plans``
offers, both modes at SILU (each equal bit for bit to the entry's output
first); with ``laggedsplit``, E2's plan in both modes at SILU and NONE
through measurement builds of its source that leave out the slab loads
(``-DTAT_LAGGED_NO_LOAD``), the product (``-DTAT_LAGGED_NO_PRODUCT``), the
epilogue (``-DTAT_LAGGED_NO_STORE``, the sums XORed and kept alive) or two
of them (the product, the epilogue, the loads alone), and that hand the
tensor cores on only after the product has completed
(``-DTAT_LAGGED_TURN_AFTER_WAIT``) or not at all (``-DTAT_LAGGED_NO_TURN``:
LAG 1's consumers unordered); with ``probes``, E1's four variants (K =
128/256/512) and E3's eight kinds (K = 256/512) through their entry points,
one application each by the probes' chained timing (their sweeps,
``probes.mxu_ceiling.sweep`` and ``probes.megakernel.sweep``); with
``probeplans``, E1's variants and E3's ``i8-shift-3x3`` at every plan
their planners offer (K = 256 and 512); with ``chainsplit``, E1's int8 and
bf16 chains through measurement builds of ``chain_mma.cu`` without the
glue's stores (``-DTAT_CHAIN_NO_GLUE``), without the product
(``-DTAT_CHAIN_NO_PRODUCT``) or without both.

``--best-of A.json B.json --record OUT.json [--prefix E1]`` writes, from
two ``probes`` runs, each label's smaller time (a record of a parent
checkout's kernels; ``--prefix``: only the labels that start so).

Run from the root of a checkout, on a machine with a CUDA card::

    python3 -m thingino_accel_tpu_torch.kxk_bench [--what WHAT]

with WHAT a comma-separated choice of kxk, gemm (the default: both),
exact1x1, dw, dwplans, bneck, sppf, fusedplans, decode, lagged,
laggedplans, laggedsplit, probes, probeplans and chainsplit.

The paths: the planned and the unplanned real yolov5n
(``models/yolov5n_cal_int8.mars``), the planned zoo yolov5s at 640 (random
weights, seed 0) and NanoDet-320 (``models/nanodet_320.mars``). A planned
path's convs are its schedule's conv units (their epilogues and
residuals), the unplanned path's its KxK conv nodes; weights are the
engine's, inputs and residuals int8 from seed 0 at batch 16. Each time is
the median of CUDA-event spans over 20 calls behind a device spin. It
needs only the entry points a user calls, so it times whatever kernel
they launch. Prints one line a conv and the per-forward sums, and writes
``chiprun_out/kxk_bench.json``. It needs a CUDA device and never falls
back to the CPU. The 1x1 rows go to ``chiprun_out/gemm_bench.json``, the
#9 rows to ``exact1x1_bench.json``, the #7 rows to ``dw_bench.json``,
the #7 plans to ``dwplans_bench.json``, the #6 rows to
``bneck_bench.json``, the #4 rows to ``sppf_bench.json``, the #6 and #4
plans to ``fusedplans_bench.json``, the decode to ``decode_bench.json``,
E2 to ``lagged_bench.json``, its plans to ``laggedplans_bench.json``,
its split to ``laggedsplit_bench.json``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parents[1]
PATHS = ("planned_yolov5n", "unplanned_yolov5n", "zoo_yolov5s", "nanodet")
BATCH = 16


def time_ms(fn, iters: int = 20) -> float:
    """Median CUDA-event span of ``fn``, the device spun for about 1 ms
    before each so that the span is the device's time."""
    for _ in range(2):
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


def _engine(path: str, device: str = "cuda"):
    from thingino_accel_tpu_torch.models import zoo
    from thingino_accel_tpu_torch.runtime.engine import Engine, EngineOptions
    serving = EngineOptions(precision="serving")
    models = REPO / "models"
    if path == "zoo_yolov5s":
        return Engine(zoo.build_yolov5("s", zoo.ZooConfig(in_hw=(640, 640))),
                      serving, device=device)
    if path == "nanodet":
        return Engine.from_mars(str(models / "nanodet_320.mars"), serving,
                                device=device)
    return Engine.from_yolo_mars(str(models / "yolov5n_cal_int8.mars"),
                                 serving, device=device,
                                 planned=path == "planned_yolov5n")


def kxk_convs(path: str, device: str = "cuda") -> tuple:
    """The path's engine and its KxK convs, each ``(node, epilogue,
    residual name, res_scale)``, in schedule (or graph) order."""
    from thingino_accel_tpu_torch.runtime.executor import ConvUnit
    eng = _engine(path, device)
    if path == "unplanned_yolov5n":
        convs = [(n, eng._fn.epilogues[n.outputs[0]], None, 1.0)
                 for n in eng._fn.nodes if n.op == "CONV2D"
                 and not (n.attrs["kernel"] == (1, 1)
                          and n.attrs["stride"] == (1, 1))]
    else:
        convs = [(u.node, u.ep, u.residual, u.res_scale)
                 for u in eng._fn.units
                 if isinstance(u, ConvUnit) and u.kind == "conv"]
    return eng, convs


def bench_path(path: str, rng) -> dict:
    from thingino_accel_tpu_torch.ops import fused_kernels as FK
    from thingino_accel_tpu_torch.ops import reference as R
    eng, convs = kxk_convs(path)
    t = eng.graph.tensors
    distinct: dict = {}
    for node, ep, res, rs in convs:
        a = node.attrs
        key = (tuple(t[node.inputs[0]].shape[1:]),
               tuple(t[node.outputs[0]].shape[1:]), tuple(a["kernel"]),
               tuple(a["stride"]), ep.act, res is not None)
        distinct.setdefault(key, [node, ep, res, rs, 0])[4] += 1
    rows = []
    for (hwc, ohwo, k, s, act, has_res), (node, ep, _, rs, count) in \
            distinct.items():
        a = node.attrs
        x = torch.from_numpy(rng.integers(-128, 128, (BATCH,) + hwc,
                                          dtype=np.int8)).cuda()
        w = eng.params[node.inputs[1]]
        bias = eng.params[node.inputs[2]] if len(node.inputs) > 2 else None
        out_hw = ohwo[:2]
        pads = R._conv_pads(hwc[:2], out_hw, a["kernel"], a["stride"],
                            a["dilation"], a["padding"], a["explicit_pad"])
        r = (torch.from_numpy(rng.integers(-128, 128, (BATCH,) + ohwo,
                                           dtype=np.int8)).cuda()
             if has_res else None)
        args = (x, w, bias, ep, out_hw, pads, s[0])
        xh = x.permute(0, 3, 1, 2).half().contiguous(
            memory_format=torch.channels_last)
        wh = w.permute(0, 3, 1, 2).half().contiguous(
            memory_format=torch.channels_last)
        row = {
            "conv": f"{k[0]}x{k[1]}/s{s[0]} {BATCH}x{hwc[0]}x{hwc[1]}x"
                    f"{hwc[2]} -> {ohwo[2]} {act}"
                    f"{' + residual' if has_res else ''}",
            "count": count,
            "blockspec_ms": time_ms(lambda: FK.conv2d_int8_halo_fused(
                *args, residual=r, res_scale=rs)),
            "dma_ms": time_ms(lambda: FK.conv2d_int8_halo_fused(
                *args, pipeline="dma")),
            "fp16_ms": time_ms(lambda: F.conv2d(
                xh, wh, None, s, (pads[0][0], pads[1][0]))),
        }
        rows.append(row)
        print(f"[kxk] {path}: {row['conv']} x{count}: #2 "
              f"{row['blockspec_ms']:.4f} ms, #5 {row['dma_ms']:.4f} ms, "
              f"F.conv2d fp16 {row['fp16_ms']:.4f} ms")
    sums = {key: sum(r["count"] * r[key] for r in rows)
            for key in ("blockspec_ms", "dma_ms", "fp16_ms")}
    sums["convs"] = sum(r["count"] for r in rows)
    print(f"[kxk] {path} per forward ({sums['convs']} convs): #2 "
          f"{sums['blockspec_ms']:.4f} ms, #5 {sums['dma_ms']:.4f} ms, "
          f"F.conv2d fp16 {sums['fp16_ms']:.4f} ms")
    return {"rows": rows, "per_forward": sums}


def gemm_units(path: str, device: str = "cuda") -> tuple:
    """The path's engine and its 1x1 units, each ``(kind, node, epilogue,
    part widths, residual name, res_scale)``: ``kind`` "matmul" (#1, an
    ``Epilogue``, one part) or "multi" (#3, a ``MultiEpilogue``), in
    schedule (or graph) order."""
    from thingino_accel_tpu_torch.runtime.executor import ConvUnit, MultiUnit
    eng = _engine(path, device)
    if path == "unplanned_yolov5n":
        t = eng.graph.tensors
        units = [("matmul", n, eng._fn.epilogues[n.outputs[0]],
                  [t[n.inputs[0]].shape[3]], None, 1.0)
                 for n in eng._fn.nodes if n.op == "CONV2D"
                 and n.attrs["kernel"] == (1, 1)
                 and n.attrs["stride"] == (1, 1)]
        return eng, units
    units = []
    for u in eng._fn.units:
        if isinstance(u, ConvUnit) and u.kind == "matmul":
            units.append(("matmul", u.node, u.ep,
                          [eng.graph.tensors[u.x].shape[3]], u.residual,
                          u.res_scale))
        elif isinstance(u, MultiUnit):
            units.append(("multi", u.node, u.me, list(u.widths), u.residual,
                          u.res_scale))
    return eng, units


def gemm_key(kind: str, m: int, widths, n: int, ep) -> tuple:
    """What makes two 1x1 units one row: the kind, rows, part widths,
    channels, act and (for #3) the scale branch."""
    act = ep.act if kind == "matmul" else ep.ep.act
    same = True if kind == "matmul" else ep.same_scale
    return kind, m, tuple(widths), n, act, same


def gemm_label(kind: str, m: int, widths, n: int, ep, residual: bool
               ) -> str:
    kind, m, widths, n, act, same = gemm_key(kind, m, widths, n, ep)
    parts = "+".join(str(k) for k in widths)
    branch = "" if kind == "matmul" else (" equal" if same else " per-part")
    return (f"{'#1' if kind == 'matmul' else '#3'} M={m} K={parts} N={n} "
            f"{act}{branch}{' + residual' if residual else ''}")


def gemm_call(kind: str, xs, ws, bias, ep, res, res_scale, plain=False):
    """The unit as a call of its entry point (or its plain version)."""
    from thingino_accel_tpu_torch.ops import fused_kernels as FK
    if kind == "matmul":
        fn = FK.matmul_int8_fused_plain if plain else FK.matmul_int8_fused
        return lambda: fn(xs[0], ws[0], bias, ep, res, res_scale)
    fn = (FK.matmul_int8_fused_multi_plain if plain
          else FK.matmul_int8_fused_multi)
    return lambda: fn(xs, ws, bias, ep, res, res_scale)


def gemm_weights(eng, node, widths):
    """The unit's weight as parts: column slices of its [N, sum K]."""
    w = eng.params[node.inputs[1]]
    w2 = w.reshape(w.shape[0], -1)
    offs = np.cumsum([0] + list(widths))
    return [w2[:, a:b] for a, b in zip(offs[:-1], offs[1:])]


def bench_gemm_path(path: str, rng) -> dict:
    eng, units = gemm_units(path)
    t = eng.graph.tensors
    distinct: dict = {}
    for kind, node, ep, widths, res, rs in units:
        hw = t[node.outputs[0]].shape[1:3]
        m = BATCH * hw[0] * hw[1]
        n = t[node.outputs[0]].shape[3]
        key = gemm_key(kind, m, widths, n, ep) + (res is not None,)
        distinct.setdefault(key, [kind, node, ep, widths, res, rs, 0])[6] += 1
    rows = []
    for key, (kind, node, ep, widths, res, rs, count) in distinct.items():
        m, n = key[1], key[3]
        xs = [torch.from_numpy(rng.integers(-128, 128, (m, k),
                                            dtype=np.int8)).cuda()
              for k in widths]
        ws = gemm_weights(eng, node, widths)
        bias = eng.params[node.inputs[2]] if len(node.inputs) > 2 else None
        r = (torch.from_numpy(rng.integers(-128, 128, (m, n),
                                           dtype=np.int8)).cuda()
             if res is not None else None)
        xcat = torch.cat(xs, 1) if len(xs) > 1 else xs[0]
        wcat_t = torch.cat(ws, 1).t() if len(ws) > 1 else ws[0].t()
        row = {"unit": gemm_label(kind, m, widths, n, ep, r is not None),
               "count": count,
               "ms": time_ms(gemm_call(kind, xs, ws, bias, ep, r, rs))}
        try:
            row["int_mm_ms"] = time_ms(lambda: torch._int_mm(xcat, wcat_t))
        except RuntimeError:   # _int_mm takes K and N in multiples of 8
            row["int_mm_ms"] = None
        rows.append(row)
        print(f"[gemm] {path}: {row['unit']} x{count}: {row['ms']:.4f} ms, "
              f"_int_mm {row['int_mm_ms']}")
    sums = {"units": sum(r["count"] for r in rows),
            "ms": sum(r["count"] * r["ms"] for r in rows)}
    print(f"[gemm] {path} per forward ({sums['units']} units): "
          f"{sums['ms']:.4f} ms")
    return {"rows": rows, "per_forward": sums}


def exact_1x1_units(device: str = "cuda") -> tuple:
    """The exact zoo yolov5s at 640 (random weights, seed 0) and its #9
    units (``ExactConvUnit`` of kind ``matmul_int8_requant``), in schedule
    order."""
    from thingino_accel_tpu_torch.models import zoo
    from thingino_accel_tpu_torch.runtime.engine import Engine, EngineOptions
    eng = Engine(zoo.build_yolov5("s", zoo.ZooConfig()),
                 EngineOptions(precision="exact"), device=device)
    return eng, [u for u in eng._fn.units
                 if u.kind == "matmul_int8_requant"]


def exact_1x1_key(eng, unit, batch: int = BATCH) -> tuple:
    """What makes two #9 units one row: rows, K, N, the act, RELU."""
    t = eng.graph.tensors
    _, h, w, k = t[unit.node.inputs[0]].shape
    n = t[unit.out].shape[3]
    return batch * h * w, k, n, unit.node.attrs.get("activation", "NONE"), \
        unit.relu


def exact_1x1_label(key: tuple) -> str:
    m, k, n, act, relu = key
    return f"#9 M={m} K={k} N={n} {act}{' relu' if relu else ''}"


def exact_1x1_call(eng, unit, x2, plain: bool = False):
    """The unit as a call of #9's entry (or its plain version) on ``x2``
    [M, K], with its table where the unit has one (a checkout whose
    entry takes none runs the act as a step of its own, not timed here)."""
    from thingino_accel_tpu_torch.ops import requant_kernels as RK
    n = unit.node
    w = eng.params[n.inputs[1]]
    w2 = w.reshape(w.shape[0], -1)
    bias = eng.params[n.inputs[2]] if len(n.inputs) > 2 else None
    cs = RK.combined_scale(*unit.scales)
    lut = getattr(unit, "lut", None)
    kw = {} if lut is None else {"lut": lut}
    fn = RK.matmul_int8_requant_plain if plain else RK.matmul_int8_requant
    return lambda: fn(x2, w2, bias, cs, unit.round_mode, unit.relu, **kw)


def bench_exact_1x1(rng) -> dict:
    eng, units = exact_1x1_units()
    distinct: dict = {}
    for u in units:
        distinct.setdefault(exact_1x1_key(eng, u), [u, 0])[1] += 1
    rows = []
    for key, (u, count) in distinct.items():
        m, k, n = key[:3]
        x2 = torch.from_numpy(rng.integers(-128, 128, (m, k),
                                           dtype=np.int8)).cuda()
        w = eng.params[u.node.inputs[1]]
        wt = w.reshape(w.shape[0], -1).t()
        row = {"unit": exact_1x1_label(key), "count": count,
               "ms": time_ms(exact_1x1_call(eng, u, x2))}
        try:
            row["int_mm_ms"] = time_ms(lambda: torch._int_mm(x2, wt))
        except RuntimeError:   # _int_mm takes K and N in multiples of 8
            row["int_mm_ms"] = None
        rows.append(row)
        print(f"[exact1x1] {row['unit']} x{count}: {row['ms']:.4f} ms, "
              f"_int_mm {row['int_mm_ms']}")
    sums = {"units": sum(r["count"] for r in rows),
            "ms": sum(r["count"] * r["ms"] for r in rows)}
    print(f"[exact1x1] per forward ({sums['units']} units): "
          f"{sums['ms']:.4f} ms")
    return {"rows": rows, "per_forward": sums}


def dw_units(device: str = "cuda") -> tuple:
    """NanoDet-320's planned engine and its #7 units (``DwUnit``)."""
    eng = _engine("nanodet", device)
    return eng, [u for u in eng._fn.units if u.kind == "dw"]


def dw_key(eng, unit, batch: int = BATCH) -> tuple:
    """What makes two #7 units one row: input and output shapes, window,
    top and left pads, act."""
    t = eng.graph.tensors
    return ((batch,) + tuple(t[unit.node.inputs[0]].shape[1:]),
            tuple(unit.out_hw), tuple(unit.node.attrs["kernel"]),
            (unit.pads[0][0], unit.pads[1][0]), unit.act)


def dw_label(key: tuple) -> str:
    (nb, h, w, c), (oh, ow), (kh, kw), _, act = key
    return f"#7 {kh}x{kw}/s1 {nb}x{h}x{w}x{c} -> {oh}x{ow} {act}"


def bench_dw(rng) -> dict:
    from thingino_accel_tpu_torch.ops import fused_kernels as FK
    eng, units = dw_units()
    distinct: dict = {}
    for u in units:
        distinct.setdefault(dw_key(eng, u), [u, 0])[1] += 1
    rows = []
    for key, (u, count) in distinct.items():
        x = torch.from_numpy(rng.integers(-128, 128, key[0],
                                          dtype=np.int8)).cuda()
        n = u.node
        w = eng.params[n.inputs[1]]
        bias = eng.params[n.inputs[2]] if len(n.inputs) > 2 else None
        c = key[0][3]
        xh = x.permute(0, 3, 1, 2).half().contiguous(
            memory_format=torch.channels_last)
        wh = w.permute(2, 0, 1).unsqueeze(1).half().contiguous(
            memory_format=torch.channels_last)
        row = {"unit": dw_label(key), "count": count,
               "ms": time_ms(lambda: FK.depthwise_conv2d_int8_fused(
                   x, w, bias, u.ep, u.out_hw, u.pads)),
               "fp16_ms": time_ms(lambda: F.conv2d(
                   xh, wh, None, 1, (u.pads[0][0], u.pads[1][0]), 1, c))}
        rows.append(row)
        print(f"[dw] {row['unit']} x{count}: {row['ms']:.4f} ms, F.conv2d "
              f"fp16 groups=C {row['fp16_ms']:.4f} ms")
    sums = {"units": sum(r["count"] for r in rows),
            **{key: sum(r["count"] * r[key] for r in rows)
               for key in ("ms", "fp16_ms")}}
    print(f"[dw] per forward ({sums['units']} units): {sums['ms']:.4f} ms, "
          f"F.conv2d fp16 {sums['fp16_ms']:.4f} ms")
    return {"rows": rows, "per_forward": sums}


def bench_dw_plans(rng, max_tile_h: int = 12) -> dict:
    """Each distinct #7 unit of NanoDet-320 at every plan of ``dw_plans``
    with at most ``max_tile_h`` rows a tile (``_launch_dw``, bit for bit
    against the plain version first): the planner's pick and the
    fastest."""
    from thingino_accel_tpu_torch.ops import fused_kernels as FK
    eng, units = dw_units()
    limits = FK.smem_limits(torch.device("cuda"))
    distinct = {dw_key(eng, u): u for u in units}
    rows = []
    for key, u in distinct.items():
        (nb, h, w, c), out_hw, (kh, kw) = key[0], key[1], key[2]
        x = torch.from_numpy(rng.integers(-128, 128, key[0],
                                          dtype=np.int8)).cuda()
        n = u.node
        wt = eng.params[n.inputs[1]]
        bias = eng.params[n.inputs[2]] if len(n.inputs) > 2 else None
        ref = FK.depthwise_conv2d_int8_fused_plain(x, wt, bias, u.ep,
                                                   u.out_hw, u.pads)
        out = torch.empty_like(ref)
        plans = FK.dw_plans(nb, *out_hw, c, kh, kw, limits)
        times = {}
        for plan in plans:
            if plan.tile_h > max_tile_h:
                continue
            FK._launch_dw(x, wt, bias, u.ep, u.pads, out, plan)
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                raise RuntimeError(f"#7 {plan} differs from its plain "
                                   "version")
            times[plan] = time_ms(lambda plan=plan: FK._launch_dw(
                x, wt, bias, u.ep, u.pads, out, plan))
        best = min(times, key=times.get)
        row = {"unit": dw_label(key), "pick": str(plans[0]),
               "pick_ms": times[plans[0]], "best": str(best),
               "best_ms": times[best], "plans": len(times),
               "ms": {f"{p.tile_h}x{p.groups}": t for p, t in times.items()}}
        rows.append(row)
        print(f"[dwplans] {row['unit']}: pick {plans[0]} "
              f"{row['pick_ms']:.4f} ms, fastest of {len(times)} {best} "
              f"{row['best_ms']:.4f} ms")
    return {"rows": rows}


def bneck_units(path: str, device: str = "cuda") -> tuple:
    """A planned path's engine and its #6 units (``BneckUnit``)."""
    eng = _engine(path, device)
    return eng, [u for u in eng._fn.units if u.kind == "bneck"]


def bneck_operands(eng, unit) -> tuple:
    """The unit's weights and biases: w1 [CM, C], b1, w2 OHWI, b2."""
    a, b = unit.conv_a, unit.conv_b
    w1 = eng.params[a.inputs[1]]
    return (w1.reshape(w1.shape[0], -1),
            eng.params[a.inputs[2]] if len(a.inputs) > 2 else None,
            eng.params[b.inputs[1]],
            eng.params[b.inputs[2]] if len(b.inputs) > 2 else None)


def bneck_key(eng, unit, batch: int = BATCH) -> tuple:
    """What makes two #6 units one row: the input's shape, CM, O, K, the
    shortcut and both acts."""
    w1, _, w2, _ = bneck_operands(eng, unit)
    shape = eng.graph.tensors[unit.conv_a.inputs[0]].shape
    return ((batch,) + tuple(shape[1:]), w1.shape[0], w2.shape[0],
            w2.shape[1], unit.shortcut, unit.ep1.act, unit.ep2.act)


def bneck_label(key: tuple) -> str:
    (nb, h, w, c), cm, o, k, shortcut, act1, act2 = key
    return (f"#6 {nb}x{h}x{w}x{c} -> {cm} -> {k}x{k} {o} {act1}/{act2}"
            f"{' + shortcut' if shortcut else ''}")


def bneck_calls(eng, unit, x) -> dict:
    """The unit on ``x`` as calls: ``fused`` (#6's entry), ``pair`` (#1
    into device memory, then #2 with the shortcut: the unfused tensor-core
    pair) and ``fp16`` (fp16 channels-last ``F.conv2d`` of the KxK stage
    alone, on an input of m's shape)."""
    from thingino_accel_tpu_torch.ops import fused_kernels as FK
    w1, b1, w2, b2 = bneck_operands(eng, unit)
    nb, h, w, c = x.shape
    k = w2.shape[1]
    p = (k - 1) // 2
    args = (x, w1, b1, unit.ep1, w2, b2, unit.ep2, unit.shortcut,
            unit.res_scale)

    def pair():
        m = FK.matmul_int8_fused(x.reshape(-1, c), w1, b1, unit.ep1)
        return FK.conv2d_int8_halo_fused(
            m.reshape(nb, h, w, -1), w2, b2, unit.ep2, (h, w),
            ((p, p), (p, p)), 1, x if unit.shortcut else None,
            unit.res_scale)
    mh = torch.zeros((nb, w1.shape[0], h, w), dtype=torch.half,
                     device=x.device).contiguous(
                         memory_format=torch.channels_last)
    wh = w2.permute(0, 3, 1, 2).half().contiguous(
        memory_format=torch.channels_last)
    return {"fused": lambda: FK.bottleneck_int8_fused(*args), "pair": pair,
            "fp16": lambda: F.conv2d(mh, wh, None, 1, p)}


def bench_bneck(rng) -> dict:
    res = {}
    for path in ("planned_yolov5n", "zoo_yolov5s"):
        eng, units = bneck_units(path)
        distinct: dict = {}
        for u in units:
            distinct.setdefault(bneck_key(eng, u), [u, 0])[1] += 1
        rows = []
        for key, (u, count) in distinct.items():
            x = torch.from_numpy(rng.integers(-128, 128, key[0],
                                              dtype=np.int8)).cuda()
            calls = bneck_calls(eng, u, x)
            row = {"unit": bneck_label(key), "count": count,
                   **{f"{name}_ms": time_ms(calls[name])
                      for name in ("fused", "pair", "fp16")}}
            rows.append(row)
            print(f"[bneck] {path}: {row['unit']} x{count}: #6 "
                  f"{row['fused_ms']:.4f} ms, #1 + #2 {row['pair_ms']:.4f} "
                  f"ms, F.conv2d fp16 (KxK stage) {row['fp16_ms']:.4f} ms")
        sums = {"units": sum(r["count"] for r in rows),
                **{key: sum(r["count"] * r[key] for r in rows)
                   for key in ("fused_ms", "pair_ms", "fp16_ms")}}
        print(f"[bneck] {path} per forward ({sums['units']} units): #6 "
              f"{sums['fused_ms']:.4f} ms, #1 + #2 {sums['pair_ms']:.4f} ms")
        res[path] = {"rows": rows, "per_forward": sums}
    return res


def sppf_units(device: str = "cuda") -> tuple:
    """The planned zoo yolov5s at 640 and its #4 units (``SppfUnit``)."""
    eng = _engine("zoo_yolov5s", device)
    return eng, [u for u in eng._fn.units if u.kind == "sppf"]


def sppf_operands(eng, unit) -> tuple:
    """The unit's weight [O, 4C] and bias."""
    n = unit.node
    w = eng.params[n.inputs[1]]
    return (w.reshape(w.shape[0], -1),
            eng.params[n.inputs[2]] if len(n.inputs) > 2 else None)


def sppf_key(eng, unit, batch: int = BATCH) -> tuple:
    """What makes two #4 units one row: the input's shape, O, k, act."""
    w, _ = sppf_operands(eng, unit)
    shape = eng.graph.tensors[unit.src].shape
    return ((batch,) + tuple(shape[1:]), w.shape[0], unit.k, unit.act)


def sppf_label(key: tuple) -> str:
    (nb, h, w, c), o, k, act = key
    return f"#4 {nb}x{h}x{w}x{c} k{k} -> {o} {act}"


def sppf_calls(unit, x, w, bias) -> dict:
    """The unit on ``x`` as calls: ``fused`` (#4's entry), ``gemm`` (#3's
    1x1 GEMM alone over the four levels, pooled beforehand by the plain
    maxpool: equal scales, one int32 sum) and ``int_mm``
    (``torch._int_mm`` over the levels concatenated)."""
    from thingino_accel_tpu_torch.ops import fused_kernels as FK
    from thingino_accel_tpu_torch.ops import reference as R
    nb, h, wd, c = x.shape
    p = (unit.k - 1) // 2
    levels = [x]
    for _ in range(3):
        levels.append(R.maxpool(levels[-1], (unit.k, unit.k), (1, 1),
                                (h, wd), ((p, p), (p, p))))
    xs = [t.reshape(-1, c) for t in levels]
    ws = [w[:, i * c:(i + 1) * c] for i in range(4)]
    me = FK.MultiEpilogue(ep=unit.ep, same_scale=True,
                          part_scales=(1.0,) * 4, bias_scale=1.0)
    xcat = torch.cat(xs, 1)
    wt = w.t()
    return {"fused": lambda: FK.sppf_int8_fused(x, w, bias, unit.ep, unit.k),
            "gemm": lambda: FK.matmul_int8_fused_multi(xs, ws, bias, me),
            "int_mm": lambda: torch._int_mm(xcat, wt)}


def bench_sppf(rng) -> dict:
    eng, units = sppf_units()
    distinct: dict = {}
    for u in units:
        distinct.setdefault(sppf_key(eng, u), [u, 0])[1] += 1
    rows = []
    for key, (u, count) in distinct.items():
        x = torch.from_numpy(rng.integers(-128, 128, key[0],
                                          dtype=np.int8)).cuda()
        calls = sppf_calls(u, x, *sppf_operands(eng, u))
        row = {"unit": sppf_label(key), "count": count,
               **{f"{name}_ms": time_ms(calls[name])
                  for name in ("fused", "gemm", "int_mm")}}
        rows.append(row)
        print(f"[sppf] {row['unit']} x{count}: #4 {row['fused_ms']:.4f} ms, "
              f"#3 over the levels {row['gemm_ms']:.4f} ms, _int_mm "
              f"{row['int_mm_ms']:.4f} ms")
    return {"rows": rows}


def bench_fused_plans(rng) -> dict:
    """Each distinct #6 unit of the planned real yolov5n and the planned
    zoo yolov5s at 640, and their #4 unit, at every plan
    ``fused_kernels.bneck_plans`` / ``sppf_plans`` offers (each equal bit
    for bit to the entry's output first): the planner's pick, the fastest
    and the pick's margin over it."""
    from thingino_accel_tpu_torch.ops import fused_kernels as FK
    limits = FK.smem_limits(torch.device("cuda"))
    jobs = []   # (label, plans, launch(plan, out), the entry's output)
    for path in ("planned_yolov5n", "zoo_yolov5s"):
        eng, units = bneck_units(path)
        for key, u in {bneck_key(eng, u): u for u in units}.items():
            (nb, h, w, c), cm, o, k = key[:4]
            x = torch.from_numpy(rng.integers(-128, 128, key[0],
                                              dtype=np.int8)).cuda()
            w1, b1, w2, b2 = bneck_operands(eng, u)
            args = (x, w1, b1, u.ep1, w2, b2, u.ep2, u.shortcut,
                    u.res_scale)
            jobs.append((f"{path} {bneck_label(key)}",
                         FK.bneck_plans(nb, h, w, c, cm, o, k, limits),
                         lambda plan, out, args=args: FK._launch_bneck(
                             *args, out, plan),
                         FK.bottleneck_int8_fused(*args)))
    eng, units = sppf_units()
    for key, u in {sppf_key(eng, u): u for u in units}.items():
        (nb, h, w, c), o, k, _ = key
        x = torch.from_numpy(rng.integers(-128, 128, key[0],
                                          dtype=np.int8)).cuda()
        wt, bias = sppf_operands(eng, u)
        jobs.append((f"zoo_yolov5s {sppf_label(key)}",
                     FK.sppf_plans(nb, h, w, c, o, k, limits),
                     lambda plan, out, x=x, wt=wt, bias=bias, u=u:
                     FK._launch_sppf(x, wt, bias, u.ep, u.k, out, plan),
                     FK.sppf_int8_fused(x, wt, bias, u.ep, u.k)))
    rows = []
    for label, plans, launch, ref in jobs:
        out = torch.empty_like(ref)
        times = {}
        for plan in plans:
            launch(plan, out)
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                raise RuntimeError(f"{label} at {plan} differs from its "
                                   "entry's output")
            times[plan] = time_ms(lambda plan=plan: launch(plan, out))
        best = min(times, key=times.get)
        row = {"unit": label, "pick": str(plans[0]),
               "pick_ms": times[plans[0]], "best": str(best),
               "best_ms": times[best],
               "margin": times[plans[0]] / times[best] - 1.0,
               "plans": len(times),
               "ms": {str(p): t for p, t in times.items()}}
        rows.append(row)
        print(f"[fusedplans] {label}: pick {plans[0]} {row['pick_ms']:.4f} "
              f"ms, fastest of {len(times)} {best} {row['best_ms']:.4f} ms "
              f"(+{100 * row['margin']:.2f}%)")
    return {"rows": rows,
            "largest_margin": max(r["margin"] for r in rows)}


DECODE_HW = (80, 40, 20)
DECODE_SCALES = (0.047, 0.051, 0.063)


def decode_label(nb: int) -> str:
    return f"3 heads {nb}x(80,40,20)^2x255 int8"


def bench_decode(rng) -> dict:
    """#8 on the real yolov5n's heads at 640, seeded int8, at batch 16 and
    1, through its entry point."""
    from thingino_accel_tpu_torch.ops import decode_kernel as DK
    rows = []
    for nb in (BATCH, 1):
        heads = [torch.from_numpy(rng.integers(-128, 128, (nb, hw, hw, 255),
                                               dtype=np.int8)).cuda()
                 for hw in DECODE_HW]
        row = {"unit": decode_label(nb), "ms": time_ms(
            lambda: DK.decode_and_parse_fused(heads,
                                              scales=list(DECODE_SCALES)))}
        rows.append(row)
        print(f"[decode] {row['unit']}: {row['ms']:.4f} ms")
    return {"rows": rows}


def lagged_label(act: str, lag: int) -> str:
    return f"E2 128x80x80x128 -> 128 {act} LAG {lag}"


def lagged_operands() -> tuple:
    """E2's weights, bias and 4 inputs on the card, the experiment's
    seeded draws."""
    from thingino_accel_tpu_torch.probes import pipeline as P2
    w_np, b_np, xs_np = P2.draws()
    return (P2.to_ohwi(w_np).cuda(), torch.from_numpy(b_np).cuda(),
            [torch.from_numpy(x).cuda() for x in xs_np])


def bench_lagged(rng) -> dict:
    """E2 at the experiment's shape on its own seeded draws, both modes at
    SILU and NONE, through its entry point (``probes.pipeline``'s
    timing)."""
    from thingino_accel_tpu_torch.ops import probe_kernels as PK
    from thingino_accel_tpu_torch.probes import pipeline as P2
    w, b, xs = lagged_operands()
    rows = []
    for act in ("SILU", "NONE"):
        ep = P2.epilogue(act, P2.O)
        for lag in (1, 0):
            row = {"unit": lagged_label(act, lag), "ms": P2.time_calls(
                lambda x, ep=ep, lag=lag: PK.conv3x3_lagged(
                    x, w, b, ep, bool(lag)), xs)}
            rows.append(row)
            print(f"[lagged] {row['unit']}: {row['ms']:.4f} ms")
    return {"rows": rows}


def bench_lagged_plans(rng) -> dict:
    """E2 at the experiment's shape at every plan the launcher offers, both
    modes at SILU, each checked against the entry's output."""
    from thingino_accel_tpu_torch.ops import fused_kernels as FK
    from thingino_accel_tpu_torch.ops import probe_kernels as PK
    from thingino_accel_tpu_torch.probes import pipeline as P2
    w, b, xs = lagged_operands()
    ep = P2.epilogue("SILU", P2.O)
    ref = PK.conv3x3_lagged(xs[0], w, b, ep)
    out = torch.empty_like(ref)
    rows = []
    for plan in PK.lagged_plans(P2.BATCH, P2.H, P2.H, P2.C, P2.O,
                                FK.smem_limits(torch.device("cuda"))):
        row = {"plan": str(plan)}
        for lag in (1, 0):
            PK._launch_lagged(xs[0], w, b, ep, out, bool(lag), plan)
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                raise RuntimeError(f"{plan} LAG {lag} differs from the entry")
            row[f"LAG {lag}"] = P2.time_calls(
                lambda x, lag=lag, plan=plan: PK._launch_lagged(
                    x, w, b, ep, out, bool(lag), plan), xs)
        rows.append(row)
        print(f"[laggedplans] {plan}: LAG 1 {row['LAG 1']:.4f} ms, LAG 0 "
              f"{row['LAG 0']:.4f} ms")
    return {"rows": rows}


LAGGED_VARIANTS = {
    "no_load": ("-DTAT_LAGGED_NO_LOAD",),
    "no_product": ("-DTAT_LAGGED_NO_PRODUCT",),
    "no_store": ("-DTAT_LAGGED_NO_STORE",),
    "product_alone": ("-DTAT_LAGGED_NO_LOAD", "-DTAT_LAGGED_NO_STORE"),
    "epilogue_alone": ("-DTAT_LAGGED_NO_LOAD", "-DTAT_LAGGED_NO_PRODUCT"),
    "loads_alone": ("-DTAT_LAGGED_NO_PRODUCT", "-DTAT_LAGGED_NO_STORE"),
    "turn_after_wait": ("-DTAT_LAGGED_TURN_AFTER_WAIT",),
    "no_turn": ("-DTAT_LAGGED_NO_TURN",)}


def bench_lagged_split(rng) -> dict:
    """E2's plan at the experiment's shape through the library and each
    of ``LAGGED_VARIANTS`` (built beside it, none reached by a wrapper),
    both modes at SILU and NONE."""
    import threading
    from thingino_accel_tpu_torch.ops import cuda_build
    from thingino_accel_tpu_torch.ops import fused_kernels as FK
    from thingino_accel_tpu_torch.ops import probe_kernels as PK
    from thingino_accel_tpu_torch.probes import pipeline as P2
    src = "conv_int8_lagged.cu"
    entries = ("tat_conv_int8_lagged", "tat_conv_int8_lagged_info")
    builds = [threading.Thread(target=cuda_build.build, args=((src,), f))
              for f in LAGGED_VARIANTS.values()]
    for t in builds:
        t.start()
    for t in builds:
        t.join()
    libs = {"library": None, **{name: cuda_build.load_variant(src, f, entries)
                                for name, f in LAGGED_VARIANTS.items()}}
    w, b, xs = lagged_operands()
    plan = PK.lagged_plan(P2.BATCH, P2.H, P2.H, P2.C, P2.O,
                          FK.smem_limits(torch.device("cuda")))
    out = torch.empty((P2.BATCH, P2.H, P2.H, P2.O), dtype=torch.int8,
                      device="cuda")
    rows = []
    for name, lib in libs.items():
        row = {"build": name}
        for act in ("SILU", "NONE"):
            ep = P2.epilogue(act, P2.O)
            for lag in (1, 0):
                row[f"{act} LAG {lag}"] = P2.time_calls(
                    lambda x, ep=ep, lag=lag, lib=lib: PK._launch_lagged(
                        x, w, b, ep, out, bool(lag), plan, lib), xs)
        rows.append(row)
        print(f"[laggedsplit] {name}: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in row.items() if k != "build"))
    return {"plan": str(plan), "rows": rows}


def bench_probes(rng) -> dict:
    """E1's variants and E3's kinds at their sweeps' sizes through the
    probes' own sweeps (entry points only), one application's ms each."""
    from thingino_accel_tpu_torch.probes import megakernel as P3
    from thingino_accel_tpu_torch.probes import mxu_ceiling as P1
    dev = torch.device("cuda")
    ms = {}
    for tag, mod in (("E1", P1), ("E3", P3)):
        for r in mod.sweep(dev):
            for kind in mod.KINDS:
                ms[f"{tag} {kind} K={r['k']}"] = r[kind].ms
                print(f"[probes] {tag} {kind} K={r['k']}: {r[kind].ms:.4f} ms")
    return {"ms": ms}


def bench_probe_plans(rng) -> dict:
    """E1's four variants at K = 256 and 512 at every plan
    ``probe_kernels.chain_plans`` offers, and E3's ``i8-shift-3x3`` at
    every plan ``stage_plans`` offers for its taps (forced on every
    launch), each equal to the entry's output first, one application's ms
    by the probes' chained timing."""
    from thingino_accel_tpu_torch.ops import fused_kernels as FK
    from thingino_accel_tpu_torch.ops import probe_kernels as PK
    from thingino_accel_tpu_torch.probes import megakernel as P3
    from thingino_accel_tpu_torch.probes import mxu_ceiling as P1
    from thingino_accel_tpu_torch.probes import timing
    dev = torch.device("cuda")
    lim = FK.smem_limits(dev)
    rows = []
    for k in (256, 512):
        for kind in P1.KINDS:
            fn, x, w = P1.build(kind, P1.M, k, P1.L, P1.GRID, dev)
            ref = fn(x, w)
            for plan in PK.chain_plans(kind, k, lim):
                def one(y, plan=plan, kind=kind, w=w):
                    out = torch.empty_like(y)
                    PK._launch_chain(y, w, kind, out, plan)
                    return out
                if not torch.equal(one(x), ref):
                    raise RuntimeError(f"E1 {kind} {plan} differs")
                ms = timing.measure(lambda y: one(y), x, 1.0).ms
                rows.append({"probe": f"E1 {kind} K={k}", "plan": str(plan),
                             "ms": ms})
                print(f"[probeplans] E1 {kind} K={k} {plan}: {ms:.4f} ms")
        kind = "i8-shift-3x3"
        fn, (x, w), _ = P3.build(kind, k, dev)
        ref = PK.megakernel_chain(kind, x, w)
        h = x.shape[1] - 2 * P3.L
        tiles = PK.stage_tiles(9, P3.GRID, x.shape[1])
        for plan in PK.stage_plans(9, k, k, tiles, lim):
            def app(y, plan=plan, w=w):
                out = torch.empty((y.shape[0], h, h, k), dtype=y.dtype,
                                  device=dev)
                PK._run_spatial(kind, y, None, w, None, out, plan=plan)
                return F.pad(out, (0, 0, P3.PAD, P3.PAD, P3.PAD, P3.PAD))
            if not torch.equal(app(x)[:, P3.PAD:-P3.PAD, P3.PAD:-P3.PAD],
                               ref):
                raise RuntimeError(f"E3 {kind} {plan} differs")
            ms = timing.measure(lambda y: app(y), x, 1.0).ms
            rows.append({"probe": f"E3 {kind} K={k}", "plan": str(plan),
                         "ms": ms})
            print(f"[probeplans] E3 {kind} K={k} {plan}: {ms:.4f} ms")
    return {"rows": rows}


CHAIN_VARIANTS = {
    "no_glue": ("-DTAT_CHAIN_NO_GLUE",),
    "no_product": ("-DTAT_CHAIN_NO_PRODUCT",),
    "neither": ("-DTAT_CHAIN_NO_GLUE", "-DTAT_CHAIN_NO_PRODUCT")}


def bench_chain_split(rng) -> dict:
    """E1's int8 and bf16 chains at K = 256 and 512 with the plans the
    launcher picks, through the library and each of ``CHAIN_VARIANTS``
    (measurement builds of ``chain_mma.cu``, none reached by a wrapper):
    one application's ms by the probes' chained timing."""
    import threading
    from thingino_accel_tpu_torch.ops import cuda_build
    from thingino_accel_tpu_torch.ops import fused_kernels as FK
    from thingino_accel_tpu_torch.ops import probe_kernels as PK
    from thingino_accel_tpu_torch.probes import mxu_ceiling as P1
    from thingino_accel_tpu_torch.probes import timing
    src = "chain_mma.cu"
    entries = ("tat_chain_mma", "tat_chain_mma_info")
    builds = [threading.Thread(target=cuda_build.build, args=((src,), f))
              for f in CHAIN_VARIANTS.values()]
    for t in builds:
        t.start()
    for t in builds:
        t.join()
    libs = {"library": None, **{name: cuda_build.load_variant(src, f, entries)
                                for name, f in CHAIN_VARIANTS.items()}}
    dev = torch.device("cuda")
    lim = FK.smem_limits(dev)
    rows = []
    for k in (256, 512):
        for kind in ("int8", "bf16"):
            _, x, w = P1.build(kind, P1.M, k, P1.L, P1.GRID, dev)
            plan = PK.chain_plan(kind, x.shape[0], k, lim)
            row = {"probe": f"E1 {kind} K={k}", "plan": str(plan)}
            for name, lib in libs.items():
                def one(y, lib=lib, w=w, kind=kind, plan=plan):
                    out = torch.empty_like(y)
                    PK._launch_chain(y, w, kind, out, plan, lib)
                    return out
                row[name] = timing.measure(one, x, 1.0).ms
            rows.append(row)
            print(f"[chainsplit] {row['probe']} {plan}: " + ", ".join(
                f"{n} {row[n]:.4f} ms" for n in libs))
    return {"rows": rows}


def best_of(paths, record: str, what: str, prefix: str = "") -> dict:
    """Each label's smaller ms over the ``probes`` runs at ``paths`` (the
    labels starting with ``prefix``), written to ``record`` with ``what``
    and the card's name and power limit (nvidia-smi)."""
    import subprocess
    runs = [json.loads(Path(p).read_text()) for p in paths]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    out = {"what": what, "device": smi[0] if smi else runs[0]["device"],
           "ms": {k: min(r["ms"][k] for r in runs) for k in runs[0]["ms"]
                  if k.startswith(prefix)}}
    Path(record).write_text(json.dumps(out, indent=1) + "\n")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paths", default=",".join(PATHS),
                    help="the serving paths of kxk and gemm")
    ap.add_argument("--what", default="kxk,gemm")
    ap.add_argument("--best-of", nargs="+", default=None,
                    help="probes runs to merge into --record")
    ap.add_argument("--record", default=None)
    ap.add_argument("--record-what", default="")
    ap.add_argument("--prefix", default="", help="the labels to record")
    args = ap.parse_args(argv)
    if args.best_of:
        best_of(args.best_of, args.record, args.record_what, args.prefix)
        return 0
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this bench runs on the card only")
    what = args.what.split(",")
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    for part, bench, name in (("kxk", bench_path, "kxk_bench.json"),
                              ("gemm", bench_gemm_path, "gemm_bench.json")):
        if part not in what:
            continue
        rng = np.random.default_rng(0)
        res = {"device": torch.cuda.get_device_name(0)}
        for path in args.paths.split(","):
            res[path] = bench(path, rng)
        (out / name).write_text(json.dumps(res, indent=1))
    for part, bench, name in (("exact1x1", bench_exact_1x1,
                               "exact1x1_bench.json"),
                              ("dw", bench_dw, "dw_bench.json"),
                              ("dwplans", bench_dw_plans,
                               "dwplans_bench.json"),
                              ("bneck", bench_bneck, "bneck_bench.json"),
                              ("sppf", bench_sppf, "sppf_bench.json"),
                              ("fusedplans", bench_fused_plans,
                               "fusedplans_bench.json"),
                              ("decode", bench_decode, "decode_bench.json"),
                              ("lagged", bench_lagged, "lagged_bench.json"),
                              ("laggedplans", bench_lagged_plans,
                               "laggedplans_bench.json"),
                              ("laggedsplit", bench_lagged_split,
                               "laggedsplit_bench.json"),
                              ("probes", bench_probes, "probes_bench.json"),
                              ("probeplans", bench_probe_plans,
                               "probeplans_bench.json"),
                              ("chainsplit", bench_chain_split,
                               "chainsplit_bench.json")):
        if part in what:
            res = {"device": torch.cuda.get_device_name(0),
                   **bench(np.random.default_rng(0))}
            (out / name).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
