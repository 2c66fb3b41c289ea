"""The serving tier's KxK convs, one by one, on the card: every distinct
KxK conv (#2, ``fused_kernels.conv2d_int8_halo_fused``) of the four
serving paths, timed through both of its entries (``pipeline=
"blockspec"``, #2, with the conv's residual; ``"dma"``, #5, without)
beside fp16 channels-last ``F.conv2d`` on the same shapes.

Run from the root of a checkout, on a machine with a CUDA card::

    python3 -m thingino_accel_tpu_torch.kxk_bench

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
back to the CPU.
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paths", default=",".join(PATHS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this bench runs on the card only")
    rng = np.random.default_rng(0)
    res = {"device": torch.cuda.get_device_name(0)}
    for path in args.paths.split(","):
        res[path] = bench_path(path, rng)
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "kxk_bench.json").write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
