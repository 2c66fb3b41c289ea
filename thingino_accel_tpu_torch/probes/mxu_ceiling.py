"""E1, the chained-product ceiling probe, on the port: is a hand-written
int8 tensor-core chain faster than a bf16 one on this card?

Port of ``examples/mxu_ceiling_probe.py``. Each variant runs L chained
``[m, k] x [k, k]`` products over ``m * grid`` rows with the cheapest glue
between them (``ops.probe_kernels.chain_mma``, CUDA ``csrc/chain_mma.cu``,
Hopper's ``wgmma``):
``int8`` (``>> 7``), ``bf16`` (f32 sums, ``/ 128``), ``mixed`` (int8
storage, bf16 products) and ``int4w`` (int8 x int4 weights, at the s8
rate: PTX has no s8 x s4 product). The TPU probe held x and all L
weights in VMEM; here the rows stay in shared memory and the weights in
L2 (2 MB at k = 512, L = 8), streamed per stage to each block. Two library chains time
the same products as yardsticks: bf16 ``torch.matmul`` then ``* (1/128)``
(``xla_chain``) and ``torch._int_mm`` then ``>> 7`` and an int8 cast
(``xla_int8_chain``).

Decision rule (``mxu_ceiling_probe.py:20-25``), as this module applies
it on the card: chained int8 at least 1.5x chained bf16 -> the gap to
the int8 peak is kernel structure, and int8 tensor-core kernels are worth
building; int8 at or below bf16 -> the bf16/fp16 tier is the design;
between -> unclear.

Run: ``python3 -m thingino_accel_tpu_torch.probes.mxu_ceiling`` (on the
card; ``--device cpu`` runs the plain versions at the size asked, e.g.
``--device cpu --m 32 --grid 2 --L 2 --k 128``).
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from thingino_accel_tpu_torch.ops import probe_kernels as PK
from thingino_accel_tpu_torch.probes import timing

KINDS = PK.CHAIN_KINDS
M, L, GRID, KS = 1024, 8, 32, (128, 256, 512)   # main's sweep (:199-227)
# H100 SXM dense tensor-core peaks, T/s (NVIDIA's H100 datasheet)
PEAK_TOPS = {"int8": 1979.0, "bf16": 989.0}
BRANCH_INT8, BRANCH_BF16 = 1.5, 1.0


def ops(m: int, k: int, l: int, grid: int) -> float:
    """Operations of one application: 2 m k^2 L grid."""
    return 2.0 * m * k * k * l * grid


def draws(kind: str, m: int, k: int, l: int, grid: int
          ) -> Tuple[np.ndarray, np.ndarray]:
    """The JAX probe's inputs in its layout (x ``[m grid, k]``, w ``[L, k,
    k]``), drawn from ``default_rng(0)`` in its order with its calls; bf16
    inputs as the float64 draws, to be rounded to bf16."""
    rng = np.random.default_rng(0)
    if kind == "bf16":
        x = rng.normal(size=(m * grid, k))
        w = rng.normal(size=(l, k, k)) * 0.05
        return x, w
    x = rng.integers(-100, 100, (m * grid, k)).astype(np.int8)
    w = rng.integers(-100, 100, (l, k, k)).astype(np.int8)
    return x, w


def to_bf16(a: np.ndarray) -> torch.Tensor:
    """float64 numpy -> bf16 as ``jnp.asarray(a, jnp.bfloat16)`` rounds it
    (torch's conversion gives the same bits)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)


def inputs(kind: str, m: int, k: int, l: int, grid: int,
           device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """x ``[m grid, k]`` and w in the kernel's layout ``[L, N, K]`` (int4w:
    wrapped and packed) on ``device``."""
    x, w = draws(kind, m, k, l, grid)
    if kind == "bf16":
        xt, wt = to_bf16(x), to_bf16(w)
    else:
        xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    wt = wt.transpose(1, 2).contiguous()
    if kind == "int4w":
        wt = PK.pack_int4(wt)
    return xt.to(device), wt.to(device)


def build(kind: str, m: int, k: int, l: int, grid: int, device="cuda"):
    """``(fn, x, w)``: ``fn(x, w)`` one application of the variant's
    chain (its kernel on the card, its plain version on the CPU)."""
    x, w = inputs(kind, m, k, l, grid, device)
    return (lambda x_, w_: PK.chain_mma(x_, w_, kind)), x, w


def library_chain(m: int, k: int, l: int, grid: int, device="cuda"):
    """``xla_chain`` (:124): the bf16 chain as library calls, bf16
    ``torch.matmul`` then ``* (1/128)``; ``(fn, x, ws)`` with ws
    ``[L, k, k]`` (``x @ w``)."""
    x, w = draws("bf16", m, k, l, grid)
    xt, wt = to_bf16(x).to(device), to_bf16(w).to(device)

    def fn(x_, ws):
        for i in range(ws.shape[0]):
            x_ = torch.matmul(x_, ws[i]) * (1.0 / 128.0)
        return x_
    return fn, xt, wt


def library_int8_chain(m: int, k: int, l: int, grid: int, device="cuda"):
    """``xla_int8_chain`` (:142): ``torch._int_mm`` then ``>> 7`` and an
    int8 cast (the card only: ``_int_mm`` has no CPU kernel here)."""
    x, w = draws("int8", m, k, l, grid)
    xt, wt = torch.from_numpy(x).to(device), torch.from_numpy(w).to(device)

    def fn(x_, ws):
        for i in range(ws.shape[0]):
            x_ = (torch._int_mm(x_, ws[i]) >> 7).to(torch.int8)
        return x_
    return fn, xt, wt


def library_int8_products(m: int, k: int, l: int, grid: int,
                          device="cuda"):
    """The L ``torch._int_mm`` products of :func:`library_int8_chain`
    alone, each on the same input (the shapes the chain's take), no glue:
    the chain's time less theirs is its glue's (the shifts and casts)."""
    _, xt, wt = library_int8_chain(m, k, l, grid, device)

    def fn(x_, ws):
        for i in range(ws.shape[0]):
            torch._int_mm(x_, ws[i])
        return x_
    return fn, xt, wt


def verdict(int8_tops: float, bf16_tops: float) -> str:
    r = int8_tops / bf16_tops
    if r >= BRANCH_INT8:
        return (f"int8/bf16 = {r:.2f} >= {BRANCH_INT8}: branch 1, the gap to "
                "the int8 peak is kernel structure; int8 tensor-core kernels "
                "are worth building")
    if r <= BRANCH_BF16:
        return (f"int8/bf16 = {r:.2f} <= {BRANCH_BF16}: branch 2, int8 does "
                "not beat bf16 here; the bf16/fp16 tier is the design")
    return (f"int8/bf16 = {r:.2f}, between {BRANCH_BF16} and {BRANCH_INT8}: "
            "unclear")


def sweep(device="cuda", m: int = M, l: int = L, grid: int = GRID,
          ks=KS, iters: int = 30) -> List[Dict]:
    """One row per k: each variant's and each library chain's rate
    (:class:`timing.Rate`), or None where it failed (printed)."""
    rows = []
    for k in ks:
        n_ops = ops(m, k, l, grid)
        row: Dict[str, Optional[timing.Rate]] = {"k": k, "ops": n_ops}
        for kind in KINDS:
            fn, x, w = build(kind, m, k, l, grid, device)
            row[kind] = timing.measure(lambda y: fn(y, w), x, n_ops, iters)
        makers = (("torch-bf16", library_chain),)
        if torch.device(device).type == "cuda":
            makers += (("torch-int8", library_int8_chain),)
        for name, make in makers:
            try:
                fn, x, w = make(m, k, l, grid, device)
                row[name] = timing.measure(lambda y: fn(y, w), x, n_ops,
                                           iters)
            except RuntimeError as e:   # a yardstick only
                print(f"# {name} k={k} refused: {str(e).splitlines()[0]}",
                      file=sys.stderr)
                row[name] = None
        rows.append(row)
    return rows


COLUMNS = KINDS + ("torch-bf16", "torch-int8")


def table(rows: List[Dict], m: int, l: int, grid: int) -> List[str]:
    out = [f"# chain probe: M={m}/tile x {grid} tiles, L={l} products, "
           "K=N swept; T/s = 2*M*K*N*L*grid / time (ms: one application)",
           f"{'K=N':>6} " + " ".join(f"{c:>20}" for c in COLUMNS)]
    for r in rows:
        cells = []
        for c in COLUMNS:
            v = r.get(c)
            cells.append(f"{'n/a':>20}" if v is None else
                         f"{v.tops:>9.1f}T {v.ms:>8.4f}ms")
        out.append(f"{r['k']:>6} " + " ".join(cells))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--m", type=int, default=M)
    ap.add_argument("--L", type=int, default=L)
    ap.add_argument("--grid", type=int, default=GRID)
    ap.add_argument("--k", type=int, nargs="+", default=list(KS))
    ap.add_argument("--iters", type=int, default=30)
    a = ap.parse_args(argv)
    if torch.device(a.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu for the plain "
                         "versions")
    rows = sweep(a.device, a.m, a.L, a.grid, a.k, a.iters)
    print("\n".join(table(rows, a.m, a.L, a.grid)))
    on_card = torch.device(a.device).type == "cuda"
    if on_card:
        print(f"# {torch.cuda.get_device_name(0)}; peaks, H100 SXM: int8 "
              f"{PEAK_TOPS['int8']:.0f} T/s, bf16 {PEAK_TOPS['bf16']:.0f} T/s")
        for r in rows:
            print(f"# K={r['k']}: {verdict(r['int8'].tops, r['bf16'].tops)}")
    else:
        print("# the plain versions on the CPU: not the card's rates")
    return 0


if __name__ == "__main__":
    sys.exit(main())
