"""Where a pipeline's time goes on the card: device busy and idle share,
and device time by kernel, from ``torch.profiler``.

Run from the root of a checkout, on a machine with a CUDA card::

    python3 -m thingino_accel_tpu_torch.trace_path --path exact_yolov5s

Paths (batch 16, uint8 1280x720 frames made from seed 0 and put on the
card before the window, so the window holds no host-to-device copy):

- ``exact_yolov5s``: letterbox -> quantize -> the exact tier on the zoo
  yolov5s at 640 (random weights, seed 0) -> decode -> NMS;
- ``serving_yolov5n``: the same over the planned serving tier on the
  committed real-weight ``models/yolov5n_cal_int8.mars``;
- ``serving_yolov5s``: the same over the planned serving tier on the zoo
  yolov5s at 640 (random weights, seed 0), the path that runs SPPF (#4);
- ``serving_nanodet``: letterbox -> quantize -> the planned serving tier on
  the committed ``models/nanodet_320.mars`` (its three heads, no decode);
- ``fast_yolov5n`` / ``fast_yolov5s``: the fast tier as the JAX bench runs
  it by default (letterbox to 640 -> space-to-depth -> quantize into bf16
  -> the dequantized bf16 graph, its stem rewritten to s2d, convs in
  ``F.conv2d`` with their sums rounded to bf16 before the bias,
  ``FAST_ACCUM`` -> #8 on the bf16 heads -> NMS) on the real yolov5n and
  on the zoo yolov5s at 640 as :func:`fast_graph` builds them.

Model paths (no frames: a "batch" is one step, its inputs made from seed
0 and put on the card before the window):

- ``aec_step``: one window of the AEC step loop, ``AECStream.run`` on the
  decompiled synthetic AEC `.mgk` (``build_aec_mgk(0)``), gru1's state
  carried (each run synchronizes, as the loop does);
- ``aec_scanner_s1`` / ``aec_scanner_s32``: one window step of
  ``make_stream_scanner`` on the same graph over 1 or 32 streams (the
  graph's forward ``torch.func.vmap``-ed over the streams);
- ``persondet``: one forward of the JZDL person detector on the fixture
  `.so` (``build_persondet_so(0)``), calibrated on seeded image 1,
  run on seeded image 2.

``--jit 1`` (the default) runs every engine, pipeline and AEC step as
the port runs them by default, jitted (``runtime.jit``: one CUDA graph a
call, captured during the warm-up); ``--jit 0`` runs them eagerly
(``EngineOptions(jit=False)``, ``jit=False`` to the AEC wrappers), one
host dispatch an op. The person detector is not jitted either way.

After two warm-up batches, ``--batches`` pipeline calls run back to back
inside the profiler, then the device is synchronized. The wall time is
the host clock over that window; "busy" is the union of the device
activity intervals (kernels and copies); the idle share is 1 - busy/wall.
Prints a summary and the largest device-time entries, and writes them to
``chiprun_out/trace_path_<path>_jit<0|1>.json``. It needs a CUDA device
and never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
FRAME_HW = (720, 1280)


# the accumulation of the fast paths: the JAX bench's default
# (``accum_dtype=bfloat16`` unless ``TAT_BENCH_F32ACC=1``), each conv's
# sums rounded to bf16 before its bias; None is the engine's default, the
# bias added to the f32 sums
FAST_ACCUM = torch.bfloat16


def fast_options(accum=FAST_ACCUM, jit: bool = True):
    """The fast paths' ``EngineOptions``: bf16 heads (as the JAX bench,
    ``quantize_outputs=False``), the given accumulation."""
    from thingino_accel_tpu_torch.runtime.engine import EngineOptions
    return EngineOptions(precision="fast", quantize_outputs=False,
                         accum_dtype=accum, jit=jit)


def fast_graph(model: str, s2d: bool = True, in_hw=(640, 640)):
    """The graph the fast paths run, before the engine: the stem rewritten
    to space-to-depth (``ir.passes.stem_space_to_depth``, on by default in
    the JAX bench). ``"yolov5n"``: the committed real yolov5n's three
    detect heads. ``"yolov5s"``: the zoo yolov5s at 640 at w_scale 0.0005
    (at the zoo's 0.01 the random weights blow float activations up to
    1e10), its detect convs' biases zeroed and their weights at scale 0.25
    so that scores spread past the threshold, as ``tests/test_torch_fast.py``
    builds it, at ``in_hw`` (640x640 unless given). ``s2d=False`` leaves
    the stem as it is. With ``TAT_S2D_DEEP`` set, the s2d stem is folded
    one stage deeper (``ir.passes.fold_stage2_downsample``), as the JAX
    bench does."""
    from thingino_accel_tpu_torch.ir import passes
    from thingino_accel_tpu_torch.models import zoo
    from thingino_accel_tpu_torch.models.yolo import find_detect_outputs
    from thingino_accel_tpu_torch.runtime.engine import load_graph
    from thingino_accel_tpu_torch.utils import config
    if model == "yolov5n":
        g = load_graph(str(REPO / "models" / "yolov5n_cal_int8.mars"))
        g = g.with_outputs(find_detect_outputs(g))
    else:
        g = zoo.build_yolov5("s", zoo.ZooConfig(w_scale=0.0005,
                                                in_hw=tuple(in_hw)))
        for o in g.outputs:
            prod = next(n for n in g.nodes if o in n.outputs)
            w, b = (g.tensors[t] for t in prod.inputs[1:3])
            w.quant = type(w.quant)(scale=0.25)
            b.data = np.zeros_like(b.data)
    if s2d and not passes.stem_space_to_depth(g):
        raise ValueError(f"{model}: no stem to rewrite")
    if s2d and config.get("TAT_S2D_DEEP"):
        passes.fold_stage2_downsample(g)
    return g


def _engine(path: str, jit: bool = True):
    from thingino_accel_tpu_torch.models import zoo
    from thingino_accel_tpu_torch.runtime.engine import Engine, EngineOptions
    if path.startswith("fast_"):
        return Engine(fast_graph(path[5:]), fast_options(jit=jit),
                      device="cuda")
    if path == "exact_yolov5s":
        return Engine(zoo.build_yolov5("s", zoo.ZooConfig()),
                      EngineOptions(precision="exact", jit=jit),
                      device="cuda")
    serving = EngineOptions(precision="serving", jit=jit)
    if path == "serving_yolov5s":
        return Engine(zoo.build_yolov5("s", zoo.ZooConfig()), serving,
                      device="cuda")
    if path == "serving_yolov5n":
        return Engine.from_yolo_mars(
            str(REPO / "models" / "yolov5n_cal_int8.mars"), serving,
            device="cuda")
    if path == "serving_nanodet":
        return Engine.from_mars(str(REPO / "models" / "nanodet_320.mars"),
                                serving, device="cuda")
    raise ValueError(f"unknown path {path!r}")


def _pipeline(path: str, eng):
    """uint8 frames on the card -> the path's outputs (jitted whole where
    the engine is)."""
    from thingino_accel_tpu_torch.models import yolo as Y
    from thingino_accel_tpu_torch.runtime.jit import jit
    if path != "serving_nanodet":
        return Y.build_serving_pipeline(eng)
    in_t = eng.graph.tensors[eng.input_names[0]]
    target = (in_t.shape[1], in_t.shape[2])
    body, params, name = eng._fn, eng.params, eng.input_names[0]

    def pipe(f):
        x = Y.quantize_input_int8(Y.letterbox_uint8(f, target))
        return body(params, {name: x})
    return jit(pipe) if eng.options.jit else pipe


MODEL_PATHS = ("aec_step", "aec_scanner_s1", "aec_scanner_s32", "persondet")


def _model_step(path: str, jit: bool = True):
    """One step of a model path (the module docstring), a callable."""
    import tempfile
    from thingino_accel_tpu_torch.formats import jzdl, mgk
    from thingino_accel_tpu_torch.models import aec
    from thingino_accel_tpu_torch.models import jzdl_fixtures as JF
    from thingino_accel_tpu_torch.models import mgk_fixtures as MF
    from thingino_accel_tpu_torch.models import persondet as PD
    if path == "persondet":
        with tempfile.TemporaryDirectory() as d:
            Path(f"{d}/p.so").write_bytes(JF.build_persondet_so(0))
            model = jzdl.load_so(f"{d}/p.so")
        cal = PD.calibrate(model, JF.seeded_image(1))
        img = torch.from_numpy(JF.seeded_image(2)).cuda()
        return lambda: PD.forward(model, img, cal)
    with tempfile.TemporaryDirectory() as d:
        Path(f"{d}/a.mgk").write_bytes(MF.build_aec_mgk(0))
        g = mgk.import_mgk(f"{d}/a.mgk", streaming=True)
    rng = np.random.default_rng(0)
    if path == "aec_step":
        stream = aec.AECStream(g, jit=jit)
        win = torch.from_numpy(np.abs(rng.normal(size=(1, 256, 8))).astype(
            np.float32)).cuda()
        state = [stream.init_state()]

        def step():
            _, state[0] = stream.run(win, state[0])
        return step
    streams = int(path.rsplit("_s", 1)[1])
    run = aec.make_stream_scanner(g, jit=jit)
    wins = torch.from_numpy(np.abs(rng.normal(
        size=(1, streams, 1, 256, 8))).astype(np.float32)).cuda()
    h0 = torch.zeros((streams, 1, 64, 32), device="cuda")
    return lambda: run(h0, wins)


def _union_us(intervals) -> float:
    """Total length of the union of [start, end) intervals (us)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def trace(path: str, batches: int, batch: int, jit: bool = True) -> dict:
    from torch.profiler import ProfilerActivity, profile
    from torch.autograd import DeviceType

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this trace runs on the card only")
    if path in MODEL_PATHS:
        step = _model_step(path, jit)
        pipe, frames = (lambda _: step()), [None] * batches
    else:
        pipe = _pipeline(path, _engine(path, jit))
        rng = np.random.default_rng(0)
        frames = [torch.from_numpy(rng.integers(
            0, 256, (batch,) + FRAME_HW + (3,), dtype=np.uint8)).cuda()
            for _ in range(batches)]
    for f in frames[:2]:
        pipe(f)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in frames:
            pipe(f)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = _union_us((e.time_range.start, e.time_range.end)
                        for e in dev) / 1e3
    by_name: dict = {}
    for e in dev:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]
    return {
        "path": path, "batch": batch, "batches": batches, "jit": jit,
        "device": torch.cuda.get_device_name(0),
        "wall_ms_per_batch": wall_ms / batches,
        "busy_ms_per_batch": busy_ms / batches,
        "idle_share": 1.0 - busy_ms / wall_ms,
        "device_ops_per_batch": len(dev) / batches,
        "top": [{"name": k, "ms_per_batch": v[0] / batches,
                 "calls_per_batch": v[1] / batches} for k, v in top],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", default="exact_yolov5s",
                    choices=["exact_yolov5s", "serving_yolov5n",
                             "serving_yolov5s", "serving_nanodet",
                             "fast_yolov5n", "fast_yolov5s",
                             *MODEL_PATHS])
    ap.add_argument("--batches", type=int, default=5)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--jit", type=int, choices=(0, 1), default=1,
                    help="1: jitted, one CUDA graph a call (the default); "
                         "0: eager")
    args = ap.parse_args(argv)
    res = trace(args.path, args.batches, args.batch, bool(args.jit))
    unit = ("step" if args.path in MODEL_PATHS
            else f"batch (batch {res['batch']})")
    print(f"[trace] {res['path']} (jit {args.jit}) on {res['device']}, "
          f"{res['batches']} "
          f"{unit.split()[0]}s: wall {res['wall_ms_per_batch']:.3f} ms a "
          f"{unit}, device busy {res['busy_ms_per_batch']:.3f} ms, idle "
          f"share {res['idle_share']:.3f}, "
          f"{res['device_ops_per_batch']:.0f} device ops a {unit.split()[0]}")
    for t in res["top"]:
        print(f"[trace]   {t['ms_per_batch']:8.4f} ms  "
              f"{t['calls_per_batch']:6.1f}x  {t['name'][:110]}")
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"trace_path_{args.path}_jit{args.jit}.json").write_text(
        json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
