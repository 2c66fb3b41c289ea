"""The serving tier's convs, one by one, on the card: every distinct KxK
conv (#2, ``fused_kernels.conv2d_int8_halo_fused``) of the four serving
paths, timed through both of its entries (``pipeline="blockspec"``, #2,
with the conv's residual; ``"dma"``, #5, without) beside fp16
channels-last ``F.conv2d`` on the same shapes; and every distinct 1x1
unit (#1 ``matmul_int8_fused`` and #3 ``matmul_int8_fused_multi``, with
the unit's parts, scale branch and residual) through its entry beside
``torch._int_mm`` (the parts' K concatenated; null where it refuses the
shape).

Run from the root of a checkout, on a machine with a CUDA card::

    python3 -m thingino_accel_tpu_torch.kxk_bench [--what kxk,gemm]

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
back to the CPU. The 1x1 rows go to ``chiprun_out/gemm_bench.json``.
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paths", default=",".join(PATHS))
    ap.add_argument("--what", default="kxk,gemm")
    args = ap.parse_args(argv)
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
