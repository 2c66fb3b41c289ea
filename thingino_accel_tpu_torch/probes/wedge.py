"""E4, the device health ladder, on the port: the smallest program class
that shows a device is well, each rung in its own process.

Port of ``examples/wedge_probe.py:33-98``. On the TPU a big program that
failed could leave the device wedged while a tiny program still passed;
the ladder finds the smallest rung that fails. Each rung runs in a
subprocess with a 900 s timeout and prints one line, ``NAME PASS|FAIL
(seconds)  detail``. The rungs:

- ``tiny``      ``ones((2, 2)).sum()``
- ``alloc-2g``  fill and reduce a 2 GiB float32 buffer
- ``matmul``    8192 x 8192 bf16, 4 chained products
- ``kernel``    the hand-written f32 ``[256, 256] + 1`` kernel
                (``ops.probe_kernels.add_one``, CUDA ``csrc/add_one.cu``;
                the JAX rung ``pallas``)
- ``conv``      bf16 128 x 80 x 80 x 128, 3x3 (``F.conv2d``; JAX left it
                to XLA)
- ``v5s-b128``  the port's planned serving zoo yolov5s at 640 through
                ``models.yolo.build_serving_pipeline`` at batch 128. The
                JAX rung ran ``bench.build_pipeline``, whose default is
                the fast tier, which the port lacks (ROADMAP A.2).

Run: ``python3 -m thingino_accel_tpu_torch.probes.wedge`` (on the card;
``--rung NAME`` runs one rung in this process; ``--device cpu`` runs the
rungs on the CPU, the kernel rung through its plain version;
``--rungs tiny,kernel`` picks rungs).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[2]
RUNGS = ("tiny", "alloc-2g", "matmul", "kernel", "conv", "v5s-b128")
TIMEOUT_S = 900


def run_rung(name: str, device="cuda") -> str:
    """Run one rung on ``device``; return its PASS line (raises on a
    failure)."""
    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    detail = ""
    if name == "tiny":
        detail = f"sum {float(torch.ones((2, 2), device=dev).sum())}"
    elif name == "alloc-2g":
        x = torch.ones((1024, 1024, 512), dtype=torch.float32, device=dev)
        detail = f"sum {float((x * 2).sum())}"
    elif name == "matmul":
        x = torch.ones((8192, 8192), dtype=torch.bfloat16, device=dev)
        for _ in range(4):
            x = (x @ x) * 1e-4
        detail = f"sum {float(x.float().sum())}"
    elif name == "kernel":
        from thingino_accel_tpu_torch.ops import probe_kernels as PK
        x = torch.ones((256, 256), dtype=torch.float32, device=dev)
        y = PK.add_one(x)
        sync()
        if not torch.equal(y, PK.add_one_plain(x)):
            raise RuntimeError("add_one differs from x + 1")
        detail = f"add_one launches {PK.launches['add_one']}"
    elif name == "conv":
        x = torch.ones((128, 128, 80, 80), dtype=torch.bfloat16,
                       device=dev).contiguous(memory_format=torch.channels_last)
        w = torch.ones((128, 128, 3, 3), dtype=torch.bfloat16,
                       device=dev).contiguous(memory_format=torch.channels_last)
        y = F.conv2d(x, w, None, 1, 1)
        sync()
        detail = f"out {tuple(y.shape)}"
    elif name == "v5s-b128":
        from thingino_accel_tpu_torch.models import yolo, zoo
        from thingino_accel_tpu_torch.runtime.engine import (
            Engine, EngineOptions)
        eng = Engine(zoo.build_yolov5("s", zoo.ZooConfig()),
                     EngineOptions(precision="serving"), device=dev)
        frames = np.random.default_rng(0).integers(
            0, 256, (128, 640, 640, 3), dtype=np.uint8)
        dets = yolo.build_serving_pipeline(eng)(torch.from_numpy(frames).to(
            dev))
        sync()
        detail = (f"{int(dets.num.sum())} detections over 128 frames "
                  "(planned serving tier; the JAX rung ran the fast tier)")
    else:
        raise SystemExit(f"unknown rung {name}")
    sync()
    return f"rung {name}: PASS ({detail})"


def line(name: str, ok: bool, secs: float, detail: str) -> str:
    """One rung's line of the ladder, as the JAX ladder prints it."""
    return f"{name:10} {'PASS' if ok else 'FAIL':4} ({secs:5.1f}s)  " \
           f"{detail[:120]}"


def ladder(rungs: Sequence[str] = RUNGS, device="cuda") -> List[str]:
    """Each rung in a subprocess (no rung inherits another's state), one
    line each."""
    out = []
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    for name in rungs:
        t0 = time.monotonic()
        try:
            p = subprocess.run(
                [sys.executable, "-m", "thingino_accel_tpu_torch.probes.wedge",
                 "--rung", name, "--device", str(device)],
                cwd=ROOT, env=env, capture_output=True, text=True,
                timeout=TIMEOUT_S)
            ok = p.returncode == 0
            tail = (p.stdout + p.stderr).strip().splitlines()
            detail = tail[-1] if tail else ""
        except subprocess.TimeoutExpired:
            ok, detail = False, "timeout"
        out.append(line(name, ok, time.monotonic() - t0, detail))
        print(out[-1], flush=True)
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rung", choices=RUNGS)
    ap.add_argument("--rungs", default=",".join(RUNGS))
    a = ap.parse_args(argv)
    if torch.device(a.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")
    if a.rung:
        print(run_rung(a.rung, a.device))
        return 0
    rungs = [r for r in a.rungs.split(",") if r]
    unknown = [r for r in rungs if r not in RUNGS]
    if unknown:
        raise SystemExit(f"unknown rungs {unknown}; the ladder: {RUNGS}")
    ladder(rungs, a.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
