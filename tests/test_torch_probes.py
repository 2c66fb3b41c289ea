"""The port's probes (``thingino_accel_tpu_torch.probes``) against the JAX
examples they port, on the CPU.

Each example is loaded from its file with ``INTERPRET = True`` (its
``pallas_call`` in interpret mode); E3's geometry is shrunk through its
module constants (H = W = 8, L = PAD = 2, GRID = 2) and the port's the
same way. The same seeded inputs (the port draws them as the example
does, and the test checks they are equal) go through both; the port's
CPU path is each kernel's plain version.

Tolerances: every int8 kind without SILU bit-exact at full L. The SILU
kinds (``i8-rq-silu-*``, ``i8-rq-siluf-1x1``, ``i8-c3-round``) at most 1
quantum on at most 0.1% of the values at L = 1 (XLA's and torch's
sigmoid differ by ulps; the JAX kernel takes ``SILU_FAST``'s quotient
through an approximate reciprocal, the port as ``num / den``), and at most
1% of the values differing at full L (a flipped quantum moves every later
stage). bf16 at most 2 bf16 ulps on every value (the sums run in other
orders: JAX in f32, the port in float64 rounded once).
"""

import importlib.util
import io
import os
import re
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thingino_accel_tpu.ops import fused_kernels as JFK
from thingino_accel_tpu_torch.ops import fused_kernels as FK
from thingino_accel_tpu_torch.ops import probe_kernels as PK
from thingino_accel_tpu_torch.probes import megakernel as P3
from thingino_accel_tpu_torch.probes import mxu_ceiling as P1
from thingino_accel_tpu_torch.probes import timing
from thingino_accel_tpu_torch.probes import wedge as P4

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
SILU_KINDS = ("i8-rq-silu-1x1", "i8-rq-siluf-1x1", "i8-rq-silu-3x3",
              "i8-c3-round")


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.INTERPRET = True
    return mod


@pytest.fixture(scope="module")
def e1():
    return _example("mxu_ceiling_probe")


@pytest.fixture
def e3(monkeypatch):
    """The JAX E3 module and the port's, both shrunk to H = W = 8,
    L = PAD = 2, GRID = 2 (restored after the test)."""
    mod = _example("megakernel_probe")
    for m in (mod, P3):
        for name, v in (("H", 8), ("W", 8), ("L", 2), ("PAD", 2),
                        ("GRID", 2)):
            monkeypatch.setattr(m, name, v)
    return mod


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bf16_ulps(got: torch.Tensor, ref) -> int:
    """Largest distance in bf16 steps between ``got`` and ``ref``."""
    def ordinal(t):
        v = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(v < 0, -(v & 0x7FFF), v)
    r = torch.from_numpy(np.array(_np(ref))).to(torch.bfloat16)
    return int((ordinal(got) - ordinal(r)).abs().max())


def _assert_int8(got: torch.Tensor, ref, silu_stages=None):
    d = np.abs(got.to(torch.int32).numpy() - _np(ref).astype(np.int32))
    frac = float((d > 0).mean())
    if silu_stages is None:
        assert d.max() == 0, (int(d.max()), frac)
    elif silu_stages == 1:
        assert d.max() <= 1 and frac <= 1e-3, (int(d.max()), frac)
    else:
        assert frac <= 1e-2, frac


# ---------------------------------------------------------------------------
# E1: the chained-product ceiling probe
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", P1.KINDS)
def test_chain_variants_equal_the_jax_probe(e1, kind):
    """m = 32, k = 128, L = 2, grid = 2: the port draws the probe's
    inputs, and its chain gives the probe's output."""
    fn, x, w = e1.build(kind, 32, 128, 2, 2)
    ref = fn(x, w)
    pf, px, pw = P1.build(kind, 32, 128, 2, 2, "cpu")
    np.testing.assert_array_equal(_np(px), _np(x))
    wk = PK.unpack_int4(pw) if kind == "int4w" else pw
    jw = w.astype(jnp.int4).astype(jnp.int8) if kind == "int4w" else w
    np.testing.assert_array_equal(_np(wk.transpose(1, 2)), _np(jw))
    got = pf(px, pw)
    assert got.dtype == (torch.bfloat16 if kind == "bf16" else torch.int8)
    if kind == "bf16":
        assert _bf16_ulps(got, ref) <= 2
    else:
        _assert_int8(got, ref)
    assert PK.launches["chain_mma"] == 0   # the CPU path launches nothing


def test_library_chains_compute_the_probe_chain(e1):
    """The bf16 yardstick computes the probe's ``xla_chain`` (bf16
    matmul, then / 128) within the bf16 bound."""
    fn, x, ws = e1.xla_chain(32, 128, 2, 2)
    lf, lx, lw = P1.library_chain(32, 128, 2, 2, "cpu")
    got = lf(lx, lw)
    ref = fn(x, ws)
    assert got.dtype == torch.bfloat16
    assert _bf16_ulps(got, ref) <= 2


def test_int4_wraps_as_jax_astype():
    """int8 -> int4 wraps modulo 16 as ``astype(jnp.int4)`` does, at the
    edges (-100 -> -4, 9 -> -7, 16 -> 0, +-8); packing round-trips."""
    v = np.array([-128, -100, -17, -16, -9, -8, -1, 0, 7, 8, 9, 15, 16, 17,
                  100, 127], np.int8)
    ref = np.asarray(jnp.asarray(v).astype(jnp.int4).astype(jnp.int8))
    got = PK.wrap_int4(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert list(got[[1, 10, 12]]) == [-4, -7, 0]
    w = torch.from_numpy(np.random.default_rng(1).integers(
        -128, 128, (3, 8, 32), dtype=np.int8))
    p = PK.pack_int4(w)
    assert p.dtype == torch.uint8 and tuple(p.shape) == (3, 8, 16)
    assert torch.equal(PK.unpack_int4(p), PK.wrap_int4(w))


# ---------------------------------------------------------------------------
# E3: the megakernel pricing probe
# ---------------------------------------------------------------------------


def _e3_pair(e3, kind, k=128):
    fn, args, ops = e3.build(kind, k)
    pf, (x, w), pops = P3.build(kind, k, "cpu")
    np.testing.assert_array_equal(_np(x), _np(args[0]))
    jw = args[1] if kind == "i8-c3-round" else (args[1],)
    pw = w if kind == "i8-c3-round" else (w,)
    for a, b in zip(pw, jw):
        np.testing.assert_array_equal(_np(a.transpose(2, 3)), _np(b))
    assert pops == pytest.approx(ops * 1e12, rel=1e-12)
    return fn(*args), pf(x, w)


@pytest.mark.parametrize("kind", P3.KINDS)
def test_megakernel_kinds_equal_the_jax_probe(e3, kind):
    """K = 128, H = W = 8, L = PAD = 2, GRID = 2."""
    ref, got = _e3_pair(e3, kind)
    assert tuple(got.shape) == tuple(ref.shape)
    if kind == "bf16-3x3":
        assert _bf16_ulps(got, ref) <= 2
    else:
        _assert_int8(got, ref, 2 if kind in SILU_KINDS else None)


@pytest.mark.parametrize("kind", SILU_KINDS)
def test_megakernel_silu_kinds_at_one_stage(e3, kind, monkeypatch):
    """The SILU kinds at L = PAD = 1: within the SILU bound."""
    for m in (e3, P3):
        monkeypatch.setattr(m, "L", 1)
        monkeypatch.setattr(m, "PAD", 1)
    ref, got = _e3_pair(e3, kind)
    _assert_int8(got, ref, 1)


def test_megakernel_op_counts_equal_the_probe(e3):
    """``ops_of`` is ``_ops_3x3`` / ``_ops_c3`` / the 1x1 count of the
    example at the shrunk geometry; the stage kernel's launches compute
    exactly those operations (no halo twice), and their 8 x 8 tiles issue
    more where an extent is ragged, as many where none is."""
    for kind in P3.KINDS:
        for k in (128, 256):
            want = (e3._ops_c3(k) if kind == "i8-c3-round" else
                    e3._ops_3x3(k) if PK.is_spatial(kind) else
                    2.0 * 8 * 8 * k * k * 2 * 2 / 1e12)
            assert P3.ops_of(kind, k) == pytest.approx(want * 1e12)
    for kind in ("i8-shift-3x3", "i8-c3-round"):
        own, tiled = PK.spatial_ops(kind, 128, 8, 2, 2)
        assert own == pytest.approx(P3.ops_of(kind, 128))
        assert P3.issued_ops(kind, 128) == (own, tiled)
        assert tiled > own   # extents 12 and 10: tiles of 16 x 16 pixels
    # H = 8, L = 1: the taps' one output extent is 8, a whole tile
    own, tiled = PK.spatial_ops("i8-shift-3x3", 64, 8, 1, 3)
    assert own == tiled == 2.0 * 9 * 64 * 64 * 64 * 3
    assert len(PK.spatial_launches("i8-c3-round", 12, 2)) == 4


def test_trace_read_takes_the_gap_inside_each_application():
    """``probes.megakernel.trace_read``: two applications of three kernels
    (two stage launches, then the pad), out of order in the trace; the gap
    counts each kernel's start less the previous one's end inside an
    application, not the time between applications."""
    spans = [("stage_wgmma_kernel<1>", 0.0, 10.0),
             ("stage_wgmma_kernel<9>", 12.0, 30.0),
             ("at::native::pad", 31.0, 35.0),
             ("at::native::pad", 136.0, 140.0),
             ("stage_wgmma_kernel<9>", 115.0, 133.0),
             ("stage_wgmma_kernel<1>", 100.0, 110.0)]
    r = P3.trace_read(spans, 2)
    assert r["launches"] == 3 and r["stage_launches"] == 2
    assert r["gap_ms"] == pytest.approx((2 + 1 + 5 + 3) / 2 / 1e3)
    assert r["stage_ms"] == pytest.approx(28 / 1e3)
    assert r["other_ms"] == pytest.approx(4 / 1e3)
    assert P3.trace_read([("row_chain_wgmma_kernel<0>", 0.0, 4.0)],
                         1)["stage_launches"] == 1
    with pytest.raises(ValueError):
        P3.trace_read(spans[:5], 2)


def test_complete_reads_takes_an_incomplete_trace_again():
    """``probes.megakernel.complete_reads``: a trace whose kernels do not
    split evenly into its applications (the profiler lost some) is taken
    again and counted; more incomplete traces than ``retakes`` raise, and
    so do complete traces that disagree on an application's launches."""
    full = [("stage_wgmma_kernel<1>", 0.0, 10.0),
            ("at::native::pad", 11.0, 15.0),
            ("stage_wgmma_kernel<1>", 100.0, 110.0),
            ("at::native::pad", 111.0, 115.0)]
    seq = iter([full[:3], full, full[1:], full])
    reads = P3.complete_reads(lambda: next(seq), 2, traces=2)
    assert [r["retaken"] for r in reads] == [1, 2]
    assert all(r["launches"] == 2 for r in reads)
    with pytest.raises(ValueError):
        P3.complete_reads(lambda: full[:3], 2, traces=1, retakes=3)
    seq = iter([full, full[:2]])
    with pytest.raises(ValueError, match="disagree"):
        P3.complete_reads(lambda: next(seq), 2, traces=2)


def test_sigmoid_fast_equals_jax_outside_a_kernel():
    """``SILU_FAST``: the port's ``sigmoid_fast`` and requantize equal the
    JAX ``_sigmoid_fast`` / ``_act_requant`` as they run eagerly, outside a
    kernel (``num / den``), bit for bit."""
    rng = np.random.default_rng(2)
    pre = np.concatenate([np.linspace(-12, 12, 4001, dtype=np.float32),
                          rng.normal(0, 4, 20000).astype(np.float32),
                          np.array([0.0, -0.0, 7.2666, -7.2666, 7.27],
                                   np.float32)])
    ref = np.asarray(JFK._sigmoid_fast(jnp.asarray(pre)))
    got = FK.sigmoid_fast(torch.from_numpy(pre)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    for inv_out in (1.0 / 32.0, 1.0 / 0.07):
        q = JFK._act_requant(jnp.asarray(pre * 9.0), act="SILU_FAST",
                             inv_out=inv_out, alpha=0.01)
        ep = FK.Epilogue(cs=torch.ones(1), inv_out=inv_out, act="SILU_FAST",
                         alpha=0.01)
        mine = FK.act_requant_plain(torch.from_numpy(pre * 9.0), ep)
        np.testing.assert_array_equal(mine.numpy(), np.asarray(q))
    assert "SILU_FAST" in FK.ACTS and FK._ACT_CODE["SILU_FAST"] == 4
    # the serving kernels are built without it (act_requant<false>)
    assert FK._kernel_act("SILU") == 3
    with pytest.raises(ValueError, match="SILU_FAST"):
        FK._kernel_act("SILU_FAST")


# ---------------------------------------------------------------------------
# Plans, timing, the ladder, the command lines
# ---------------------------------------------------------------------------

H100 = FK.SmemLimits(132, 233472, 232448)


def test_plans_fit_the_card_at_the_sweep_sizes():
    """Every E1 variant and E3 kind has a plan within an H100's shared
    memory at the sweeps' sizes, and the plans' sizes are what the
    sources lay out."""
    for kind in P1.KINDS + ("requant",):
        for k in P1.KS:
            plan = PK.chain_plan(kind, P1.M * P1.GRID, k, H100)
            assert PK.chain_smem(kind, k, plan) <= H100.per_block
            assert plan.bm in PK.CHAIN_BMS and k % plan.bn == 0
    # int8 at K = 512: two buffers of 128 rows (128 KB) and three chunks of
    # 64 columns (256 rows do not fit); bf16 rows there need a block of 64
    assert PK.chain_plan("int8", 32768, 512, H100) == PK.ChainPlan(128, 64, 3)
    assert PK.chain_smem("int8", 512, PK.ChainPlan(128, 64, 3)) == \
        2 * 128 * 512 + 3 * 512 * 64 + 8 * (2 + 6 + 2)
    assert PK.chain_plan("bf16", 32768, 512, H100) == PK.ChainPlan(64, 32, 3)
    # K = 128 and 256: 256 rows a block (two m64 tiles a consumer) where
    # the blocks still fill nine tenths of the SMs (E1's 32768 rows: 128
    # blocks), 128 where they would not (E3's 1x1 kinds: 16384 rows)
    assert PK.chain_plan("int8", 32768, 128, H100) == PK.ChainPlan(256, 128,
                                                                   4)
    assert PK.chain_plan("int8", 32768, 256, H100).bm == 256
    assert PK.chain_plan("requant", 16384, 256, H100).bm == 128
    assert PK.chain_plan("int8", 100, 128, H100).bm == 128
    for kind in P3.KINDS:
        for k in P3.KS:
            if not PK.is_spatial(kind):
                continue
            row = PK._row_bytes(kind, k)
            for _, taps, e in PK.spatial_launches(kind, 40, 4):
                tiles = PK.stage_tiles(taps, P3.GRID, e)
                plan = PK.stage_plan(taps, row, k, tiles, H100)
                assert PK.stage_smem(taps, row, plan.bn, plan.kc,
                                     plan.stages, plan.resident,
                                     plan.wslots) <= H100.per_block
                assert k % plan.bn == 0 and row % plan.kc == 0
                assert plan.blocks * k // plan.bn <= 132 * 5
    # K = 256: the weights resident at bn 64 (9 x 256 x 64 bytes), three
    # 16-plane slab slots of 10 x 10 pixels; K = 512 streams them
    assert PK.stage_plan(9, 256, 256, 400, H100) == PK.StagePlan(
        64, 256, 3, True, 33)
    assert PK.stage_smem(9, 256, 64, 256, 3, True) == \
        9 * 256 * 64 + 3 * 16 * 1664 + 4 * 64 + 8 * 7
    assert not PK.stage_plan(9, 512, 512, 400, H100).resident
    with pytest.raises(ValueError, match="fits"):
        PK.stage_plan(9, 48, 48, 10, H100)   # no block divides K
    with pytest.raises(ValueError, match="fits"):
        PK.chain_plan("bf16", 100, 4096, H100)


def test_measure_arithmetic_with_a_fake_clock():
    """T/s = ops N / (t(N) - t(0)); one application's ms; N doubles until
    the difference is at least MIN_DT_MS."""
    calls = []

    def clock(n):
        calls.append(n)
        return 2.0 + 0.5 * n
    r = timing.measure(None, None, 1e12, n=10, reps=3, elapsed=clock)
    assert (r.n, r.base_ms, r.full_ms) == (10, 2.0, 7.0)
    assert r.ms == pytest.approx(0.5)
    assert r.tops == pytest.approx(1e12 * 10 / 5e-3 / 1e12)
    assert calls == [0, 10, 0, 0, 0, 10, 10, 10]
    slow = timing.measure(None, None, 1.0, n=10, reps=1,
                          elapsed=lambda n: 1.0 + 0.001 * n)
    assert slow.n == 80 and slow.full_ms - slow.base_ms >= timing.MIN_DT_MS
    assert timing.rate(4e12, 2, 1.0, 1.0).tops > 1e6   # dt floored, finite


def test_chain_timing_on_the_cpu_runs_the_chain():
    fn, x, w = P1.build("int8", 16, 64, 1, 1, "cpu")
    r = timing.measure(lambda y: fn(y, w), x, P1.ops(16, 64, 1, 1), n=2,
                       reps=1)
    assert r.n >= 2 and r.tops > 0


def test_wedge_ladder_rungs_and_lines():
    """The JAX ladder's rungs, the kernel rung in place of ``pallas``, and
    the port's serving rung after them; lines as the JAX ladder prints
    them; the CPU rungs pass in their own processes."""
    j = _example("wedge_probe")
    assert list(P4.RUNGS) == [("kernel" if r == "pallas" else r)
                              for r in j.RUNGS] + ["v5s-serving"]
    assert P4.line("tiny", True, 1.25, "rung tiny: PASS") == \
        "tiny       PASS (  1.2s)  rung tiny: PASS"
    assert P4.line("v5s-b128", False, 900.0, "timeout").startswith(
        "v5s-b128   FAIL (900.0s)  timeout")
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert P4.main(["--device", "cpu", "--rungs", "tiny,kernel"]) == 0
    lines = buf.getvalue().splitlines()
    assert len(lines) == 2
    for name, ln in zip(("tiny", "kernel"), lines):
        assert re.match(rf"{name}\s+PASS \(\s*\d+\.\ds\)  rung {name}: PASS",
                        ln), ln
    assert P4.run_rung("kernel", "cpu").startswith("rung kernel: PASS")
    with pytest.raises(SystemExit):
        P4.main(["--device", "cpu", "--rungs", "tiny,pallas"])


def test_wedge_model_rungs_run_the_fast_and_serving_tiers(monkeypatch):
    """``v5s-b128`` runs the fast tier, as JAX's ``bench.build_pipeline``
    default (ROADMAP.md C.15): the zoo yolov5s of ``trace_path.fast_graph``
    (s2d stem) with ``trace_path.fast_options()``; ``v5s-serving`` the
    planned serving tier. At a small size on the CPU, in process and
    through the ladder's own subprocess."""
    from thingino_accel_tpu_torch.runtime import engine as E
    built = []
    real = E.Engine.__init__

    def record(self, graph, options=None, *a, **k):
        real(self, graph, options, *a, **k)
        built.append((graph.stem_s2d, self.options))

    monkeypatch.setattr(E.Engine, "__init__", record)
    line = P4.run_rung("v5s-b128", "cpu", batch=2, hw=64)
    assert line.startswith("rung v5s-b128: PASS") and "(fast tier)" in line
    (s2d, opts), = built
    assert s2d and opts.precision == "fast" and not opts.quantize_outputs
    assert opts.accum_dtype == torch.bfloat16
    line = P4.run_rung("v5s-serving", "cpu", batch=2, hw=64)
    assert "(serving tier)" in line and built[1][1].precision == "serving"
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert P4.main(["--device", "cpu", "--rungs", "v5s-b128", "--batch",
                        "1", "--hw", "64"]) == 0
    assert re.match(r"v5s-b128\s+PASS .*over 1 frames \(fast tier\)",
                    buf.getvalue()), buf.getvalue()


def test_probe_mains_on_the_cpu(monkeypatch):
    """``--device cpu`` runs the plain versions at the size asked and
    prints each table."""
    for name in ("H", "W", "L", "PAD", "GRID"):
        monkeypatch.setattr(P3, name, getattr(P3, name))
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert P1.main(["--device", "cpu", "--m", "16", "--grid", "2",
                        "--L", "1", "--k", "64", "--iters", "1"]) == 0
        assert P3.main(["--device", "cpu", "--k", "32", "--H", "4", "--L",
                        "1", "--grid", "1", "--iters", "1"]) == 0
    out = buf.getvalue()
    assert "K=N" in out and "i8-c3-round" in out and "not the card" in out
    assert re.search(r"^\s+64 .*T", out, re.M)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="cpu"):
            P1.main([])


def test_e3_library_chains_at_the_probe_shapes(e3):
    """The library yardsticks run at the probe's shapes and op counts:
    the fp16 3x3 chain is L VALID convs padded back, the library round
    adds the cropped input at 0.5 after each stage's 3x3 SiLU."""
    k = 16
    fn, x, ops = P3.library_taps(k, "cpu")
    assert x.dtype == torch.float16 and x.shape == (2, k, 12, 12)
    assert ops == P3.ops_of("i8-shift-3x3", k)
    y = fn(x)
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    assert bool((y[:, :, :2] == 0).all()) and bool((y[:, :, 2:10, 2:10] != 0)
                                                   .any())
    fn, x, ops = P3.library_round(k, "cpu")
    assert ops == P3.ops_of("i8-c3-round", k)
    w1, w3 = P3._library_weights(k, 1, "cpu"), P3._library_weights(k, 9,
                                                                   "cpu")
    ref = x.float()
    for a, b in zip(w1, w3):
        m = torch.nn.functional.silu(
            torch.nn.functional.conv2d(ref, a.float()).half().float())
        t = torch.nn.functional.conv2d(m.half().float(), b.float()).half()
        ref = (torch.nn.functional.silu(t.float()).half().float()
               + 0.5 * ref[:, :, 1:-1, 1:-1]).half().float()
    got = fn(x)[:, :, 2:10, 2:10].float()
    assert float((got - ref).abs().max()) <= 2e-2 * float(ref.abs().max())


@pytest.mark.parametrize("c3,lib,bf16,word", [
    (300.0, 100.0, 100.0, "build the C3 megakernel"),
    (100.0, 100.0, 90.0, "the fp16 tier stands"),
    (35.0, 600.0, 11.7, "disagree, unclear"),
    (150.0, 100.0, 90.0, "between 1.3 and 2.0, unclear"),
])
def test_e3_verdict_reads_both_yardsticks(c3, lib, bf16, word):
    """E3's rule against the library round and the probe's bf16-3x3:
    unclear where the two readings disagree."""
    assert P3.verdict(c3, lib, bf16).endswith(word)


def test_wrappers_check_operands():
    x = torch.zeros((4, 64), dtype=torch.int8)
    w = torch.zeros((2, 64, 64), dtype=torch.int8)
    with pytest.raises(ValueError, match="unknown"):
        PK.chain_mma(x, w, "fp8")
    with pytest.raises(ValueError, match="w"):
        PK.chain_mma(x, w[:, :32], "int8")
    with pytest.raises(ValueError, match="packed"):
        PK.chain_mma(x, w, "int4w")
    with pytest.raises(ValueError, match="x"):
        PK.chain_mma(x, w.to(torch.bfloat16), "bf16")
    with pytest.raises(ValueError, match="cs"):
        PK.megakernel_chain("i8-rq-relu-1x1", x, w[:, None])
    with pytest.raises(ValueError, match="float32"):
        PK.add_one(torch.zeros(3, dtype=torch.float64))
    assert torch.equal(PK.add_one(torch.zeros(3)), torch.ones(3))
    assert PK.launches == {"chain_mma": 0, "megakernel_probe": 0,
                           "add_one": 0, "conv3x3_lagged": 0}
