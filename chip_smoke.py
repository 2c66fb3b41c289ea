#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``thingino_accel_tpu_torch``)
on one NVIDIA GPU (built for Hopper, sm_90a).

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases:

1. Device: name, power limit, torch / CUDA / nvcc versions.
2. Build: compile the kernels in ``thingino_accel_tpu_torch/csrc/`` with
   nvcc (timed).
3. Kernels vs their plain torch versions on the card, at the slice's
   shapes, NONE and SILU with per-channel scales; median times of both.
4. The slice: the real-weight ``models/yolov5n_cal_int8.mars`` at 640x640
   through letterbox -> int8 quantize -> serving engine -> decode -> NMS
   inside the port's ``StreamServer`` (depth 2), 4 batches of 16 uint8
   1280x720 frames made from a seed. Checks: no failed batch, launch
   counts of one launch per conv, finite detections inside the frame; then
   a teacher-forced per-conv comparison of kernel vs plain on one batch,
   and of every node of one frame on the card vs the CPU path.

Tolerances (as in ``tests/test_torch_fused_kernels.py``): NONE bit-exact;
SILU at most 1 quantum on at most 0.1% of the elements (the kernel's
``expf`` and torch's sigmoid differ by ulps).

Prints the kernels' JSON line, the card's ``name, power.limit`` line and,
as the last line, ``{"ok": true, "device": {...}}``. Any failure exits
non-zero without that line. It never falls back to the CPU. Writes the
detailed numbers to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent
MODEL = REPO / "models" / "yolov5n_cal_int8.mars"
BATCHES, BATCH, FRAME_HW = 4, 16, (720, 1280)
SILU_MAX_FRAC = 1e-3

# one launch per conv of the real yolov5n: 42 1x1 convs (39 SILU + the 3
# linear detect heads) and 18 KxK (11 3x3/s1, 6 3x3/s2, the 6x6/s2 stem)
EXPECTED_PER_FORWARD = {"matmul_int8_fused": 42, "conv2d_int8_halo_fused": 18}
KERNEL_INFO = {
    "matmul_int8_fused": {
        "source": "thingino_accel_tpu_torch/csrc/mm_int8_fused.cu",
        "replaces": "thingino_accel_tpu/ops/fused_kernels.py:241"},
    "conv2d_int8_halo_fused": {
        "source": "thingino_accel_tpu_torch/csrc/conv_int8_fused.cu",
        "replaces": "thingino_accel_tpu/ops/fused_kernels.py:544"},
}


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
    """Median of per-launch CUDA-event times, device synchronized around."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


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
    print(f"[build] kernels built and loaded in {secs:.3f} s")
    return secs


def phase_kernels(results: dict) -> None:
    """Each kernel vs its plain version at the slice's shapes."""
    import numpy as np
    import torch
    from thingino_accel_tpu_torch.ops import fused_kernels as FK

    rng = np.random.default_rng(0)
    dev = torch.device("cuda")

    def rnd(shape):
        return torch.from_numpy(
            rng.integers(-128, 128, shape, dtype=np.int8)).to(dev)

    # (label, route, x shape, w OHWI shape, stride, pad)
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
    for label, route, xs, ws_shape, s, p in cases:
        nb, h, w, c = xs
        o, kk = ws_shape[0], ws_shape[1]
        oh, ow = (h + 2 * p - kk) // s + 1, (w + 2 * p - kk) // s + 1
        pads = ((p, p), (p, p))
        x, wt = rnd(xs), rnd(ws_shape)
        bias = torch.from_numpy(
            rng.integers(-2000, 2000, o).astype(np.int32)).to(dev)
        wsc = rng.uniform(0.005, 0.015, o).astype(np.float32)
        for act in ("NONE", "SILU"):
            ep = FK.epilogue_rows(wsc, 0.01, float(0.0137 * np.sqrt(kk * kk * c)),
                                  act, o, device=dev)
            if route == "matmul_int8_fused":
                x2, w2 = x.reshape(-1, c), wt.reshape(o, c)

                def kern():
                    return FK.matmul_int8_fused(x2, w2, bias, ep)

                def plain():
                    return FK.matmul_int8_fused_plain(x2, w2, bias, ep)
            else:
                def kern():
                    return FK.conv2d_int8_halo_fused(x, wt, bias, ep, (oh, ow),
                                                     pads, s)

                def plain():
                    return FK.conv2d_int8_halo_fused_plain(
                        x, wt, bias, ep, (oh, ow), pads, s)
            out_k = kern()
            torch.cuda.synchronize()
            dmax = compare(out_k, plain(), act, f"{label} {act}")
            ms = time_ms(kern, 20)
            plain_ms = time_ms(plain, 5, warmup=1)
            r = results[route]
            r["cases"].append({"case": f"{label} {act}", "ms": ms,
                               "plain_ms": plain_ms, "max_abs_err": dmax})
            r["max_abs_err"] = max(r["max_abs_err"], dmax)
            print(f"[kernels] {route:24s} {label} {act}: kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, max |diff| {dmax}")


def check_postprocess_on_card(dev) -> int:
    """Decode + NMS on the card vs on the CPU (the path the tests hold
    against JAX) over seeded int8 heads drawn from a few values, so that
    scores tie and boxes coincide: valid masks and classes equal, boxes
    within 1e-4 px, scores within 1e-6 relative."""
    import numpy as np
    import torch
    from thingino_accel_tpu_torch.models import yolo as Y

    rng = np.random.default_rng(11)
    heads = []
    for hw in (80, 40, 20):
        h = rng.integers(-2, 3, (BATCH, hw, hw, 3, 85)).astype(np.int8) * 8
        h[..., 4] = rng.choice([16, 40, 127], (BATCH, hw, hw, 3))
        heads.append(torch.from_numpy(h.reshape(BATCH, hw, hw, 255)))
    res = {}
    for d in (dev, torch.device("cpu")):
        b, s, c = Y.decode_and_parse([h.to(d) for h in heads],
                                     scales=[0.05] * 3)
        res[d.type] = Y.nms_batched(b, s, c, max_dets=100, pre_nms=128,
                                    topk_group=8)
    g, r = res["cuda"], res["cpu"]
    require(torch.equal(g.valid.cpu(), r.valid), "NMS valid masks differ")
    require(torch.equal(g.classes.cpu(), r.classes), "NMS classes differ")
    require(torch.allclose(g.boxes.cpu(), r.boxes, rtol=0, atol=1e-4),
            "NMS boxes differ")
    require(torch.allclose(g.scores.cpu(), r.scores, rtol=1e-6, atol=1e-12),
            "NMS scores differ")
    return int(r.num.sum())


def check_nodes_against_cpu(eng, frame_u8, target) -> int:
    """One frame through the card's engine, every node held against the
    CPU path (plain convs and torch ops, the path the tests hold against
    JAX) on the card's own inputs: the letterbox within 1 on uint8, SILU
    convs within the SILU tolerance, every other node bit-exact."""
    import torch
    from thingino_accel_tpu_torch.models import yolo as Y
    from thingino_accel_tpu_torch.runtime.engine import Engine, EngineOptions

    frame = torch.from_numpy(frame_u8)
    boxed = Y.letterbox_uint8(frame.cuda(), target)
    d = (boxed.cpu().to(torch.int32)
         - Y.letterbox_uint8(frame, target).to(torch.int32)).abs()
    require(int(d.max()) <= 1, f"letterbox card vs CPU: max {int(d.max())}")
    acts = eng.trace(Y.quantize_input_int8(boxed))
    cpu = Engine.from_yolo_mars(str(MODEL), EngineOptions("serving"))
    for node in cpu._fn.nodes:
        env = dict(cpu.params)
        env.update({i: acts[i].cpu() for i in node.inputs if i in acts})
        cpu._fn.lower_node(node, env)
        act = (node.attrs.get("activation", "NONE")
               if node.op == "CONV2D" else "NONE")
        for o in node.outputs:
            compare(acts[o].cpu(), env[o], act, f"card vs CPU {node.op} {o}")
    return len(cpu._fn.nodes)


def phase_slice(results: dict) -> dict:
    import numpy as np
    import torch
    from thingino_accel_tpu_torch.models import yolo as Y
    from thingino_accel_tpu_torch.ops import fused_kernels as FK
    from thingino_accel_tpu_torch.runtime.engine import Engine, EngineOptions
    from thingino_accel_tpu_torch.runtime.serving import StreamServer

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    eng = Engine.from_yolo_mars(str(MODEL), EngineOptions("serving"),
                                device=dev)
    print(f"[slice] engine on {dev} in {time.perf_counter() - t0:.3f} s: "
          + eng.summary().splitlines()[0])
    pipe = Y.build_serving_pipeline(eng)
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (BATCH,) + FRAME_HW + (3,),
                           dtype=np.uint8) for _ in range(BATCHES)]

    # warm-up outside the counted run (cuDNN/allocator first use)
    pipe(torch.from_numpy(frames[0]).to(dev))
    torch.cuda.synchronize()

    FK.reset_launches()
    server = StreamServer(pipe, depth=2, device=dev)
    outs = list(server.run(frames))
    torch.cuda.synchronize()
    counts = dict(FK.launches)
    st = server.stats
    require(len(outs) == BATCHES, f"{len(outs)} results for {BATCHES} batches")
    require(all(o is not None for o in outs) and st.errors == 0,
            f"failed batches: errors={st.errors}")
    for name, per in EXPECTED_PER_FORWARD.items():
        require(counts[name] == BATCHES * per,
                f"{name}: {counts[name]} launches, expected {BATCHES * per}")
        results[name]["launches"] = counts[name]
    print(f"[slice] launches {counts} (expected {BATCHES} x "
          f"{EXPECTED_PER_FORWARD})")

    in_t = eng.graph.tensors[eng.input_names[0]]
    target = (in_t.shape[1], in_t.shape[2])
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
    print(f"[slice] 4-batch run: {st.summary()}")
    print(f"[slice] detections per frame: mean "
          f"{float(np.mean(dets_per_frame))}, min {min(dets_per_frame)}, "
          f"max {max(dets_per_frame)}")

    # steadier serving numbers: 12 more batches through a fresh server
    steady = StreamServer(pipe, depth=2, device=dev)
    for o in steady.run(frames[i % BATCHES] for i in range(12)):
        require(o is not None, "failed batch in the steady run")
    print(f"[slice] 12-batch steady run: {steady.stats.summary()}")

    # teacher-forced per-conv check on one batch: each conv's kernel output
    # (from the traced run) vs its plain version on the same input
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
        route = ("matmul_int8_fused" if a["kernel"] == (1, 1)
                 and a["stride"] == (1, 1) else "conv2d_int8_halo_fused")
        dmax = compare(acts[out], env[out], a.get("activation", "NONE"),
                       f"teacher-forced {out}")
        results[route]["max_abs_err"] = max(results[route]["max_abs_err"],
                                            dmax)
        n_conv += 1
    torch.cuda.synchronize()
    print(f"[slice] teacher-forced kernel vs plain: {n_conv} convs within "
          "tolerance")
    n_nodes = check_nodes_against_cpu(eng, frames[0][:1], target)
    print(f"[slice] teacher-forced card vs CPU, one frame: {n_nodes} nodes "
          "within tolerance")
    n_dets = check_postprocess_on_card(dev)
    print(f"[slice] decode + NMS on tie-heavy heads: card == CPU "
          f"({n_dets} detections)")
    return {
        "launches": counts, "fps_4batch": st.fps,
        "p50_ms_4batch": st.latency_ms(50), "p99_ms_4batch": st.latency_ms(99),
        "fps_steady": steady.stats.fps,
        "p50_ms_steady": steady.stats.latency_ms(50),
        "p99_ms_steady": steady.stats.latency_ms(99),
        "dets_per_frame_mean": float(np.mean(dets_per_frame)),
        "teacher_forced_convs": n_conv,
    }


def main() -> int:
    if not (REPO / "thingino_accel_tpu_torch" / "csrc").is_dir() \
            or not MODEL.exists():
        print("chip_smoke: FAIL: run it from a checkout of the repository "
              "(the port package and models/ are missing here)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    sys.modules["jax"] = None   # the port must never need JAX
    try:
        import torch
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        name, smi = phase_device()
        build_s = phase_build()
        results = {k: {"cases": [], "max_abs_err": 0, "launches": 0}
                   for k in EXPECTED_PER_FORWARD}
        phase_kernels(results)
        slice_res = phase_slice(results)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAIL", file=sys.stderr)
        return 1

    kernels = []
    for k, r in results.items():
        rep = r["cases"][0]   # the first (NONE) case at the slice shape
        kernels.append({"name": k, "route": "cuda", **KERNEL_INFO[k],
                        "launches": r["launches"],
                        "max_abs_err": r["max_abs_err"], "ms": rep["ms"],
                        "plain_ms": rep["plain_ms"], "at": rep["case"]})
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "device": name, "nvidia_smi": smi, "build_s": build_s,
        "kernels": results, "slice": slice_res}, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
