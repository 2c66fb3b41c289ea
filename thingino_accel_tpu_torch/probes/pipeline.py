"""E2, the lagged-epilogue pipelining experiment, on the port: does running
a conv's requantize epilogue a tile behind its product, on other warps,
hide the epilogue's cost?

Port of ``examples/pipeline_experiment.py``. Its shape is the C3 block's
3x3/s1 conv, C = 128 -> O = 128 at 80 x 80, batch 128, with the
experiment's scalar scales (in 0.05, w 0.01, out 0.05, alpha 0.01) and
act SILU (``--act``, the JAX ``TAT_PIPE_ACT``). :func:`build` returns
``(baseline, lagged)`` as the JAX ``build`` does:

- ``baseline``: #2, ``ops.fused_kernels.conv2d_int8_halo_fused`` (the
  counterpart of the JAX ``conv2d_int8_folded``);
- ``lagged``: ``ops.probe_kernels.conv3x3_lagged`` (CUDA
  ``csrc/conv_int8_lagged.cu``), a ``wgmma`` conv whose two consumer
  warpgroups alternate tiles, one's epilogue of tile t running while the
  other's product of tile t + 1 runs (``lag=True``, ping-pong), or, as the
  control, both products and then both epilogues in lockstep
  (``lag=False``). It computes every output row; the JAX ``lagged``
  writes only ``(h // tile_h) * tile_h`` of them.

:func:`main` draws the weights, the bias and 4 inputs from
``default_rng(0)`` in the JAX ``main``'s order, checks that both lag modes
equal the baseline on the first 2 images and, on the card, times #2, #5
(``pipeline="dma"``), ``LAG = 0``, ``LAG = 1`` and fp16 channels-last
``F.conv2d`` (the library call), each over 50 calls that take the 4
distinct inputs in turn (105 MB each, more than the 50 MB L2), in us and
T/s over ``2 N H W 9 C O`` operations. Then the lag's reading: ``LAG 0 /
LAG 1`` at the act and at NONE, the epilogue's share ``(t_act - t_NONE) /
t_act`` of the ``LAG = 0`` kernel, and both modes' blocks an SM.

Run: ``python3 -m thingino_accel_tpu_torch.probes.pipeline`` (on the
card; ``--device cpu`` runs the plain versions at the size asked, e.g.
``--device cpu --batch 2 --h 16 --c 32 --o 48``).
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from thingino_accel_tpu_torch.ops import fused_kernels as FK
from thingino_accel_tpu_torch.ops import probe_kernels as PK

BATCH, H, C, O = 128, 80, 128, 128
IN_S, W_S, OUT_S = 0.05, 0.01, 0.05
ALPHA = 0.01
ACT = "SILU"
N_INPUTS = 4
ITERS = 50
CHECK_IMAGES = 2
PADS = ((1, 1), (1, 1))
# the timed calls, in the table's order
CALLS = ("baseline (#2)", "dma (#5)", "LAG 0", "LAG 1", "fp16 F.conv2d")


def draws(batch: int = BATCH, h: int = H, c: int = C, o: int = O,
          n_inputs: int = N_INPUTS
          ) -> Tuple[np.ndarray, np.ndarray, List[np.ndarray]]:
    """The JAX ``main``'s draws from ``default_rng(0)``, in its order: w
    HWIO ``[3, 3, c, o]`` int8 in [-64, 64), bias ``[o]`` int32 in [-1000,
    1000), then ``n_inputs`` NHWC ``[batch, h, h, c]`` int8 inputs."""
    rng = np.random.default_rng(0)
    w = rng.integers(-64, 64, (3, 3, c, o), dtype=np.int8)
    b = rng.integers(-1000, 1000, (o,), dtype=np.int32)
    xs = [rng.integers(-128, 128, (batch, h, h, c), dtype=np.int8)
          for _ in range(n_inputs)]
    return w, b, xs


def to_ohwi(w_hwio: np.ndarray) -> torch.Tensor:
    """The JAX HWIO weight in the port's OHWI layout."""
    return torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 0, 1,
                                                                  2)))


def ops(batch: int, h: int, c: int, o: int) -> float:
    """``2 N H W 9 C O``: the JAX ``main``'s operation count."""
    return 2.0 * batch * h * h * 9 * c * o


def epilogue(act: str, o: int, device="cuda") -> FK.Epilogue:
    """The experiment's epilogue: its scalar scales and alpha, ``o``
    channels."""
    return FK.epilogue_rows(W_S, IN_S, OUT_S, act, o, ALPHA, device)


def build(batch: int = BATCH, h: int = H, c: int = C, o: int = O,
          act: str = ACT, device="cuda"):
    """``(baseline, lagged)`` as the JAX ``build``: ``baseline(x, w, b)``
    #2 and ``lagged(x, w, b, lag=True)`` the lagged conv, each on NHWC
    ``x [n, h, h, c]`` int8, OHWI ``w [o, 3, 3, c]`` int8 and ``b [o]``
    int32, with the experiment's scalar scales -> ``[n, h, h, o]`` int8.
    The kernels on the card, the plain versions on the CPU."""
    ep = epilogue(act, o, device)

    def baseline(x, w, b):
        return FK.conv2d_int8_halo_fused(x, w, b, ep, (h, h), PADS, 1)

    def lagged(x, w, b, lag: bool = True):
        return PK.conv3x3_lagged(x, w, b, ep, lag)
    return baseline, lagged


def time_calls(fn, xs: Sequence[torch.Tensor]) -> float:
    """ms a call on the card: one warm call on each input, then
    :data:`ITERS` calls taking the inputs in turn, between two CUDA
    events."""
    for x in xs:
        fn(x)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for i in range(ITERS):
        fn(xs[i % len(xs)])
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / ITERS


def _max_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int32) - b.to(torch.int32)).abs().max())


def run(batch: int = BATCH, h: int = H, c: int = C, o: int = O,
        act: str = ACT, device="cuda") -> Dict:
    """The experiment: ``max_diff`` of each lag mode against the baseline
    on the first :data:`CHECK_IMAGES` images; on the card also ``ms`` of
    each of :data:`CALLS` at ``act`` and of both lag modes at NONE, the
    plan and both modes' occupancy."""
    dev = torch.device(device)
    w_np, b_np, xs_np = draws(batch, h, c, o)
    w, b = to_ohwi(w_np).to(dev), torch.from_numpy(b_np).to(dev)
    xs = [torch.from_numpy(x).to(dev) for x in xs_np]
    baseline, lagged = build(batch, h, c, o, act, dev)
    head = xs[0][:CHECK_IMAGES]
    ref = baseline(head, w, b)
    res: Dict = {"ops": ops(batch, h, c, o), "act": act,
                 "max_diff": {f"LAG {int(lag)}": _max_diff(
                     lagged(head, w, b, lag), ref) for lag in (False, True)}}
    if dev.type != "cuda":
        return res
    ep = epilogue(act, o, dev)
    cl = torch.channels_last
    xh = [x.permute(0, 3, 1, 2).half().contiguous(memory_format=cl)
          for x in xs]
    wh = w.permute(0, 3, 1, 2).half().contiguous(memory_format=cl)
    fns = {
        "baseline (#2)": lambda x: baseline(x, w, b),
        "dma (#5)": lambda x: FK.conv2d_int8_halo_fused(
            x, w, b, ep, (h, h), PADS, 1, pipeline="dma"),
        "LAG 0": lambda x: lagged(x, w, b, False),
        "LAG 1": lambda x: lagged(x, w, b, True),
    }
    ms = {name: time_calls(fn, xs) for name, fn in fns.items()}
    ms["fp16 F.conv2d"] = time_calls(lambda x: F.conv2d(x, wh, None, 1, 1),
                                     xh)
    if act == "NONE":
        none = {k: ms[k] for k in ("LAG 0", "LAG 1")}
    else:
        _, lag_none = build(batch, h, c, o, "NONE", dev)
        none = {f"LAG {int(lag)}": time_calls(
            lambda x, lag=lag: lag_none(x, w, b, lag), xs)
            for lag in (False, True)}
    plan = PK.lagged_plan(batch, h, h, c, o, FK.smem_limits(dev))
    res.update(ms=ms, ms_none=none, plan=plan, occupancy={
        f"LAG {int(lag)}": PK.lagged_occupancy(lag, c, plan)
        for lag in (False, True)})
    return res


def table(res: Dict, batch: int, h: int, c: int, o: int) -> List[str]:
    """The JAX ``main``'s lines: each call in us and T/s, then the lag's
    reading."""
    act, ms, none = res["act"], res["ms"], res["ms_none"]
    out = [f"# E2 lagged epilogue: {batch}x{h}x{h}x{c} -> {o} 3x3/s1 {act}, "
           f"{res['ops']:.4g} ops a call; {ITERS} calls over "
           f"{N_INPUTS} inputs"]
    rows = [(k, ms[k]) for k in CALLS] + [
        (f"{k} NONE", v) for k, v in none.items() if act != "NONE"]
    for name, t in rows:
        out.append(f"{name:>16}: {t * 1e3:10.1f} us  "
                   f"{res['ops'] / (t * 1e-3) / 1e12:7.1f} T/s")
    share = (ms["LAG 0"] - none["LAG 0"]) / ms["LAG 0"]
    out.append(f"# LAG 0 / LAG 1: {ms['LAG 0'] / ms['LAG 1']:.3f} at {act}, "
               f"{none['LAG 0'] / none['LAG 1']:.3f} at NONE; the epilogue's "
               f"share of LAG 0, (t_{act} - t_NONE) / t_{act}: {share:.3f}")
    occ = ", ".join(f"{k} {v[1]}" for k, v in res["occupancy"].items())
    out.append(f"# plan {res['plan']}; shared memory "
               f"{res['occupancy']['LAG 1'][0]} bytes a block; blocks an "
               f"SM: {occ}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--act", default=ACT, choices=FK.ACTS[:4])
    ap.add_argument("--batch", type=int, default=None,
                    help=f"images (default {BATCH} on the card, 2 on the "
                    "CPU, as the JAX main)")
    ap.add_argument("--h", type=int, default=H)
    ap.add_argument("--c", type=int, default=C)
    ap.add_argument("--o", type=int, default=O)
    a = ap.parse_args(argv)
    on_card = torch.device(a.device).type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu for the plain "
                         "versions")
    batch = a.batch or (BATCH if on_card else CHECK_IMAGES)
    res = run(batch, a.h, a.c, a.o, a.act, a.device)
    worst = max(res["max_diff"].values())
    print(f"lagged vs baseline: max|diff| = {worst} "
          f"({'OK' if worst == 0 else 'MISMATCH'}; "
          + ", ".join(f"{k} {v}" for k, v in res["max_diff"].items()) + ")")
    if on_card:
        print("\n".join(table(res, batch, a.h, a.c, a.o)))
        print(f"# {torch.cuda.get_device_name(0)}")
    else:
        print("# the plain versions on the CPU: not timed")
    return 0 if worst == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
