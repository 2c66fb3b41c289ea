"""E3, the megakernel pricing probe, on the port: what do the production
requantize epilogue, the 3x3 taps and a whole C3 round cost at the
chained-product ceiling of E1 (``probes.mxu_ceiling``)?

Port of ``examples/megakernel_probe.py``. The eight kinds
(:data:`KINDS`) run through ``ops.probe_kernels.megakernel_chain`` (CUDA
``csrc/megakernel_probe.cu``): 1x1 chains with ``>> 7`` or the
requantize (SILU, SILU_FAST, RELU), valid-shrink 3x3 chains with ``>> 7``,
the SILU requantize or in bf16, and the C3 round (1x1 -> SILU ->
3x3 -> SILU + residual). The geometry comes from the module constants
(:data:`H`, :data:`W`, :data:`L`, :data:`GRID`, :data:`PAD`), as in the
JAX probe, so a caller may shrink it; ``PAD`` must equal ``L``. A 3x3
application is the kernel then a zero pad back to the input's extent, as
the JAX probe pads outside its kernel.

A cell (40 x 40 x K, 400 KB at K = 256) does not fit in a block's shared
memory, so the 3x3 kinds run one ``wgmma`` stage kernel launch a stage
(the C3 round two: its 1x1, then its taps) over every cell, each stage's
output in a scratch tensor that stays in L2: no halo is computed again.
Rates are reported over the probe's own operation count (:func:`ops_of`),
as JAX does, with the operations the kernels compute and the ones their
8 x 8 tiles issue on the tensor cores, a ragged extent's masked rows
included (:func:`issued_ops`), beside them.

Decision rule (``megakernel_probe.py:45-49``), as this module applies it
on the card: the TPU compared the C3 round's int8 rate against XLA
bf16's C3 rate (147 T/s there). Here the round is held against two
yardsticks at the probe's own shapes and op count: the library round
(:func:`library_round`: fp16 ``F.conv2d`` channels-last, 1x1 -> SiLU ->
VALID 3x3 -> SiLU + 0.5 x residual, L stages) and the probe's own
``bf16-3x3``. Against each, c3-round >= 2x -> build the C3 megakernel;
below 1.3x -> the fp16 tier stands; between -> unclear. Where the two
readings disagree, the rule is unclear (:func:`verdict`).

Run: ``python3 -m thingino_accel_tpu_torch.probes.megakernel`` (on the
card; ``--device cpu`` runs the plain versions at the size asked, e.g.
``--device cpu --k 128 --H 8 --L 2 --grid 2``).
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from thingino_accel_tpu_torch.ops import probe_kernels as PK
from thingino_accel_tpu_torch.probes import timing
from thingino_accel_tpu_torch.probes.mxu_ceiling import to_bf16

# tile geometry (megakernel_probe.py:72-75): H * W == 1024 interior rows
H = W = 32
L = 4              # chain depth
GRID = 16
PAD = L            # valid-shrink halo consumed over the whole chain
KINDS = PK.MEGA_KINDS
KS = (256, 512)
BUILD_RATIO, STAND_RATIO = 2.0, 1.3
LIBRARY = ("fp16-3x3", "fp16-c3")   # the library chains of the sweep


def _ops_3x3(k: int) -> float:
    """``_ops_3x3`` (:171), in operations."""
    return sum(2.0 * (H + 2 * (L - i) - 2) ** 2 * 9 * k * k
               for i in range(L)) * GRID


def _ops_c3(k: int) -> float:
    """``_ops_c3`` (:176), in operations."""
    return sum(2.0 * (H + 2 * (L - i)) ** 2 * k * k
               + 2.0 * (H + 2 * (L - i) - 2) ** 2 * 9 * k * k
               for i in range(L)) * GRID


def ops_of(kind: str, k: int) -> float:
    """The probe's own operation count of one application."""
    if kind == "i8-c3-round":
        return _ops_c3(k)
    if PK.is_spatial(kind):
        return _ops_3x3(k)
    return 2.0 * H * W * k * k * L * GRID


def draws(kind: str, k: int) -> Dict[str, np.ndarray]:
    """The JAX probe's inputs (``build`` :182) in its layout and order from
    ``default_rng(0)``: ``cs [k]``, ``x``, then ``w`` (the C3 round:
    ``w1`` then ``w3``), weights ``[L, taps, K, N]``."""
    rng = np.random.default_rng(0)
    spatial = PK.is_spatial(kind)
    bf16 = kind.startswith("bf16")

    def wgen(taps):
        if bf16:
            return rng.normal(size=(L, taps, k, k)) * 0.05
        return rng.integers(-100, 100, (L, taps, k, k)).astype(np.int8)

    out = {"cs": rng.uniform(0.5, 2.0, (1, k)).astype(np.float32)[0]}
    if not spatial:
        out["x"] = rng.integers(-100, 100, (GRID * H * W, k)).astype(np.int8)
        out["w"] = wgen(1)
        return out
    e0 = H + 2 * PAD
    out["x"] = (rng.normal(size=(GRID, e0, e0, k)) if bf16 else
                rng.integers(-100, 100, (GRID, e0, e0, k)).astype(np.int8))
    if kind == "i8-c3-round":
        out["w1"] = wgen(1)
    out["w"] = wgen(9)
    return out


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    t = to_bf16(a) if a.dtype == np.float64 else torch.from_numpy(a)
    return t.to(device)


def _kernel_layout(w: np.ndarray, device) -> torch.Tensor:
    return _tensor(w, device).transpose(2, 3).contiguous()


def build(kind: str, k: int, device="cuda"):
    """``(fn, (x, w), ops)`` as the JAX ``build``: ``fn(x, w)`` one
    application of ``kind``, its output the shape of ``x`` (the 3x3 kinds
    pad back by PAD); ``w`` in the kernel layout ``[L, taps, N, K]`` (the
    C3 round: ``(w1, w3)``). The kernel on the card, the plain version
    on the CPU."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    if PAD != L or H != W:
        raise ValueError(f"the port needs PAD == L and H == W (PAD {PAD}, "
                         f"L {L}, H {H}, W {W})")
    d = draws(kind, k)
    cs = torch.from_numpy(d["cs"]).to(device)
    x = _tensor(d["x"], device)
    w = _kernel_layout(d["w"], device)
    if kind == "i8-c3-round":
        w = (_kernel_layout(d["w1"], device), w)
    return _application(kind, cs, PK.megakernel_chain), (x, w), \
        ops_of(kind, k)


def _application(kind: str, cs: torch.Tensor, chain):
    pad = (0, 0, PAD, PAD, PAD, PAD)
    if PK.is_spatial(kind):
        return lambda x_, w_: F.pad(chain(kind, x_, w_, cs), pad)
    return lambda x_, w_: chain(kind, x_, w_, cs)


def plain_fn(kind: str, k: int, device="cuda"):
    """``fn(x, w)`` of :func:`build` through the plain version, on any
    device."""
    cs = torch.from_numpy(draws(kind, k)["cs"]).to(device)
    return _application(kind, cs, PK.megakernel_chain_plain)


def issued_ops(kind: str, k: int) -> tuple:
    """``(computed, tiled)`` operations of one application: each output
    pixel of each stage once (the 3x3 kinds' launches compute no halo
    twice; the 1x1 kinds are the probe's own count) and the ones the m64
    tiles run on the tensor cores (``probe_kernels.spatial_ops``)."""
    if not PK.is_spatial(kind):
        return ops_of(kind, k), ops_of(kind, k)
    return PK.spatial_ops(kind, k, H, L, GRID)


OURS = ("stage_wgmma_kernel", "row_chain_wgmma_kernel")


def trace_read(spans, apps: int) -> Dict:
    """One trace of ``apps`` chained applications, ``spans`` its device
    kernels as ``(name, start_us, end_us)`` in any order: an application's
    ``launches`` kernels, ``stage_launches`` and ``stage_ms`` the port's
    (:data:`OURS`), ``other_ms`` the rest, and ``gap_ms`` the device's idle
    time inside an application (each kernel's start less the previous
    kernel's end, summed), each a mean over the applications."""
    spans = sorted(spans, key=lambda s: s[1])
    n = len(spans) // apps
    if n == 0 or n * apps != len(spans):
        raise ValueError(f"{len(spans)} kernels in {apps} applications")
    gap = sum(spans[i + 1][1] - spans[i][2]
              for a in range(apps) for i in range(a * n, a * n + n - 1))
    mine = [s for s in spans if any(o in s[0] for o in OURS)]
    busy = sum(e - b for _, b, e in spans) / 1e3 / apps
    stage = sum(e - b for _, b, e in mine) / 1e3 / apps
    return {"gap_ms": gap / 1e3 / apps, "launches": n,
            "stage_launches": len(mine) / apps, "stage_ms": stage,
            "other_ms": busy - stage}


def complete_reads(take, apps: int, traces: int = 3,
                   retakes: int = 3) -> List[Dict]:
    """``traces`` :func:`trace_read` readings of ``take()``, each a trace of
    ``apps`` applications as ``(name, start_us, end_us)`` spans. A trace
    whose kernels do not split evenly into the applications lost kernels
    from the profiler's record; it is taken again, at most ``retakes``
    times in all, and then the ``ValueError`` stands. Each reading carries
    ``retaken``, the traces thrown away before it; the readings must agree
    on the launches of an application."""
    reads, lost = [], 0
    while len(reads) < traces:
        try:
            read = trace_read(take(), apps)
        except ValueError:
            lost += 1
            if lost > retakes:
                raise
            continue
        read["retaken"] = lost
        reads.append(read)
    if len({r["launches"] for r in reads}) != 1:
        raise ValueError("the traces disagree on an application's launches: "
                         f"{[r['launches'] for r in reads]}")
    return reads


def kernel_ms(kind: str, k: int, device="cuda", apps: int = 10,
              traces: int = 3) -> Dict:
    """One application's kernels on the card (:func:`trace_read`), the
    mean over ``traces`` ``torch.profiler`` traces of ``apps`` chained
    applications each, enqueued behind a device spin as the chained
    timing is, so that the host's launch rate does not show;
    ``gap_lo_ms`` / ``gap_hi_ms`` the least and most gap of the traces,
    ``retaken`` the incomplete traces taken again
    (:func:`complete_reads`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn, (x, w), _ = build(kind, k, device)
    y = fn(x, w)
    torch.cuda.synchronize()

    def take():
        nonlocal y
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(timing.SPIN_CYCLES_BASE
                              + 4 * timing.SPIN_CYCLES_PER_APP * apps)
            for _ in range(apps):
                y = fn(y, w)
            torch.cuda.synchronize()
        return [(e.name, e.time_range.start, e.time_range.end)
                for e in prof.events() if e.device_type == DeviceType.CUDA
                and "spin_kernel" not in e.name]

    reads = complete_reads(take, apps, traces)
    out = {key: sum(r[key] for r in reads) / traces for key in reads[0]}
    out["gap_lo_ms"] = min(r["gap_ms"] for r in reads)
    out["gap_hi_ms"] = max(r["gap_ms"] for r in reads)
    out["retaken"] = reads[-1]["retaken"]
    return out


def _library_weights(k: int, taps: int, device) -> List[torch.Tensor]:
    """L fp16 ``[K, K, t, t]`` channels-last conv weights, std 1 / sqrt(t^2
    K) so that the chained activations stay near 1."""
    g = torch.Generator().manual_seed(taps)
    t = 3 if taps == 9 else 1
    return [(torch.randn(k, k, t, t, generator=g) / (t * k ** 0.5)).to(
        device, torch.float16).contiguous(memory_format=torch.channels_last)
        for _ in range(L)]


def _library_input(k: int, device) -> torch.Tensor:
    g = torch.Generator().manual_seed(0)
    e0 = H + 2 * PAD
    return torch.randn(GRID, k, e0, e0, generator=g).to(
        device, torch.float16).contiguous(memory_format=torch.channels_last)


def library_taps(k: int, device="cuda"):
    """The library's 3x3 chain at the probe's shapes: L chained VALID fp16
    ``F.conv2d`` 3x3 (channels-last) on ``[GRID, K, H + 2L, H + 2L]``,
    padded back by PAD; ``(fn, x, ops)`` with the probe's own count."""
    w3 = _library_weights(k, 9, device)
    pad = (PAD, PAD, PAD, PAD)

    def fn(y):
        for w in w3:
            y = F.conv2d(y, w)
        return F.pad(y, pad)
    return fn, _library_input(k, device), _ops_3x3(k)


def library_round(k: int, device="cuda"):
    """The library's C3 round at the probe's shapes: per stage fp16
    ``F.conv2d`` 1x1, SiLU, VALID 3x3, SiLU, + 0.5 x the input cropped by
    one pixel; padded back by PAD; ``(fn, x, ops)`` with the probe's
    own count."""
    w1, w3 = _library_weights(k, 1, device), _library_weights(k, 9, device)
    pad = (PAD, PAD, PAD, PAD)

    def fn(y):
        for a, b in zip(w1, w3):
            m = F.silu(F.conv2d(y, a))
            y = F.silu(F.conv2d(m, b)) + 0.5 * y[:, :, 1:-1, 1:-1]
        return F.pad(y, pad)
    return fn, _library_input(k, device), _ops_c3(k)


def _branch(r: float) -> str:
    if r >= BUILD_RATIO:
        return "build"
    return "stand" if r < STAND_RATIO else "unclear"


def verdict(c3_tops: float, library_tops: float, bf16_tops: float) -> str:
    """The rule against the library round and against the probe's own
    ``bf16-3x3``; unclear where the two readings disagree."""
    r_lib, r_bf16 = c3_tops / library_tops, c3_tops / bf16_tops
    head = (f"c3-round / fp16 library round = {r_lib:.2f}, c3-round / "
            f"bf16-3x3 = {r_bf16:.2f}")
    branches = {_branch(r_lib), _branch(r_bf16)}
    if branches == {"build"}:
        return f"{head}: both >= {BUILD_RATIO}: build the C3 megakernel"
    if branches == {"stand"}:
        return (f"{head}: both < {STAND_RATIO}: the epilogue and tap "
                "structure eat the int8 advantage; the fp16 tier stands")
    if len(branches) > 1:
        return f"{head}: the two readings disagree, unclear"
    return f"{head}: between {STAND_RATIO} and {BUILD_RATIO}, unclear"


def sweep(device="cuda", ks=KS, iters: int = 20) -> List[Dict]:
    """One row per k: each kind's :class:`timing.Rate` over its own op
    count, the operations its kernels compute and issue
    (:func:`issued_ops`), and the library chains' rates (:data:`LIBRARY`,
    on the card only)."""
    dev = torch.device(device)
    rows = []
    for k in ks:
        row: Dict[str, object] = {"k": k, "issued": {}, "tiled": {}}
        for kind in KINDS:
            fn, (x, w), n_ops = build(kind, k, dev)
            row[kind] = timing.measure(lambda y: fn(y, w), x, n_ops, iters)
            row["issued"][kind], row["tiled"][kind] = issued_ops(kind, k)
        for name, lib in zip(LIBRARY, (library_taps, library_round)):
            row[name] = None
            if dev.type == "cuda":
                lfn, lx, lops = lib(k, dev)
                row[name] = timing.measure(lfn, lx, lops, iters)
        rows.append(row)
    return rows


def table(rows: List[Dict]) -> List[str]:
    out = [f"# megakernel pricing: {H}x{W} interior (M={H * W}), L={L} "
           f"stages, grid={GRID}; T/s over the probe's own op count "
           "(ms: one application; xA/B: the ops the kernels compute / the "
           "probe's, and the ops their m64 tiles issue / the probe's)",
           f"{'K=N':>6} " + " ".join(f"{k:>32}" for k in KINDS)
           + "".join(f" {name:>20}" for name in LIBRARY)]
    for r in rows:
        cells = []
        for kind in KINDS:
            v: Optional[timing.Rate] = r[kind]
            own = ops_of(kind, r["k"])
            extra = (f" x{r['issued'][kind] / own:.2f}/"
                     f"{r['tiled'][kind] / own:.2f}")
            cells.append(f"{v.tops:>9.1f}T {v.ms:>8.4f}ms{extra:>12}")
        for name in LIBRARY:
            c = r[name]
            cells.append(f"{'n/a':>20}" if c is None else
                         f"{c.tops:>9.1f}T {c.ms:>8.4f}ms")
        out.append(f"{r['k']:>6} " + " ".join(cells))
    return out


def main(argv=None) -> int:
    global H, W, L, PAD, GRID
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--k", type=int, nargs="+", default=list(KS))
    ap.add_argument("--H", type=int, default=H)
    ap.add_argument("--L", type=int, default=L)
    ap.add_argument("--grid", type=int, default=GRID)
    ap.add_argument("--iters", type=int, default=20)
    a = ap.parse_args(argv)
    if torch.device(a.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu for the plain "
                         "versions")
    H = W = a.H
    L = PAD = a.L
    GRID = a.grid
    rows = sweep(a.device, a.k, a.iters)
    print("\n".join(table(rows)))
    if torch.device(a.device).type == "cuda":
        print(f"# {torch.cuda.get_device_name(0)}")
        for r in rows:
            print(f"# K={r['k']}: " + verdict(
                r["i8-c3-round"].tops, r["fp16-c3"].tops,
                r["bf16-3x3"].tops))
    else:
        print("# the plain versions on the CPU: not the card's rates")
    return 0


if __name__ == "__main__":
    sys.exit(main())
