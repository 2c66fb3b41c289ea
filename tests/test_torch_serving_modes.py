"""The JAX package's serving and fast-tier modes in the port, port vs JAX
on the CPU on the same seeded numpy inputs:

- the ``TAT_*`` registry's four modes (``TAT_FAST_SILU``,
  ``TAT_SERVING_COMPUTE``, ``TAT_STEM_NOGROW``, ``TAT_SILU_TANH``): JAX's
  names, defaults and parsers; an unknown product fails as JAX's
  ``_compute_mode`` assert does; ``__version__`` is JAX's;
- each serving wrapper's plain version against the JAX function in
  interpret mode, at the shapes of JAX's ``tests/test_fused_kernels.py``
  bf16 tests: ``compute="bf16"`` bit for bit (SILU within its bound: XLA's
  and torch's sigmoid differ by ulps), #4 within one quantum (JAX adds
  four f32 part sums, which may round once past 2^24); ``SILU_FAST`` in
  #1-#7 within one quantum on at most 0.1% of the values. JAX's interpret
  run takes ``_sigmoid_fast``'s in-kernel branch, ``pl.reciprocal(den,
  approx=True)`` and one Newton step (the test checks that it runs); the
  port's plain version divides ``num / den`` (JAX's branch outside a
  kernel), as its kernels do, so a value on a rounding edge may move by a
  quantum;
- the port's ``Engine`` against JAX's ``Engine`` on the graphs of JAX's
  ``tests/test_serving_tier.py`` mode tests (the stem chain, the SiLU
  conv, the bottleneck cascade; JAX's yolov5n at 160 cut to 64), each
  variable set for both packages: ``TAT_STEM_NOGROW`` with JAX's stage
  and bit for bit against the grown plan, ``TAT_FAST_SILU`` and
  ``TAT_SERVING_COMPUTE=bf16`` within the bounds above, and the port's
  engine resolving its modes once, when it is built (each unit's act and
  product, the launch census the same in every mode);
- ``TAT_SILU_TANH`` in the fast tier (bf16 heads within the fast tier's
  ``BF16_HEAD_ULPS``) and in the exact tier over a float32 graph (rtol
  1e-5).
"""

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import thingino_accel_tpu as JT
from thingino_accel_tpu.ir.passes import fuse_act_into_conv
from thingino_accel_tpu.models import zoo
from thingino_accel_tpu.ops import fused_kernels as JFK
from thingino_accel_tpu.runtime import Engine as JEngine
from thingino_accel_tpu.runtime import EngineOptions as JOptions
from thingino_accel_tpu.runtime.executor import _plan_folds
from thingino_accel_tpu.utils import config as JC
import thingino_accel_tpu_torch as PT
from thingino_accel_tpu_torch.ir.graph import graph_from_jax
from thingino_accel_tpu_torch.ops import fused_kernels as FK
from thingino_accel_tpu_torch.runtime.engine import Engine, EngineOptions
from thingino_accel_tpu_torch.utils import config

MODES = ("TAT_FAST_SILU", "TAT_SERVING_COMPUTE", "TAT_STEM_NOGROW",
         "TAT_SILU_TANH")
BF16_HEAD_ULPS = 3   # tests/test_torch_fast.py: the fast tier's bound


@pytest.fixture(autouse=True)
def _modes_unset(monkeypatch):
    for name in MODES:
        monkeypatch.delenv(name, raising=False)
    with pltpu.force_tpu_interpret_mode():
        yield


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _i8(rng, shape, lo=-128, hi=128):
    return rng.integers(lo, hi, shape, dtype=np.int8)


def _close(port, ref, act, quanta=0):
    """SILU and SILU_FAST at most 1 quantum on at most 0.1% of the values;
    the rest within ``quanta``."""
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape and port.dtype == ref.dtype
    d = np.abs(port.astype(np.int32) - ref.astype(np.int32))
    if act in ("SILU", "SILU_FAST"):
        assert d.max() <= max(1, quanta), d.max()
        if quanta == 0:
            assert (d > 0).mean() <= 1e-3, (d > 0).mean()
    else:
        assert d.max() <= quanta, d.max()


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("raw", [None, "1", "0", "true", "off", "bf16",
                                 "int8", "junk", ""])
def test_modes_registry_as_jax(monkeypatch, raw):
    for name in MODES:
        assert config._REGISTRY[name][0] == JC._REGISTRY[name][0], name
        assert config._REGISTRY[name][2] == JC._REGISTRY[name][2], name
        if raw is not None:
            monkeypatch.setenv(name, raw)
        assert config.get(name) == JC.get(name), (name, raw)
    if raw in ("int8", "bf16", None):
        assert FK.compute_mode(None) == JFK._compute_mode(None)
    else:
        for fn in (FK.compute_mode, JFK._compute_mode):
            with pytest.raises(AssertionError):
                fn(None)
    assert PT.__version__ == JT.__version__


# ---------------------------------------------------------------------------
# The wrappers' plain versions against JAX's kernels in interpret mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("act", ["NONE", "RELU", "SILU"])
def test_matmul_bf16_equals_jax(act):
    """JAX's ``test_matmul_bf16_compute_bit_equal`` shapes."""
    rng = np.random.default_rng(0)
    m, k, n = 48, 256, 72
    x, w = _i8(rng, (m, k)), _i8(rng, (k, n))
    b = rng.integers(-3000, 3000, (n,)).astype(np.int32)
    ref = JFK.matmul_int8_fused(x, w, b, 0.02, 0.015, 0.05, act=act,
                                compute="bf16")
    ep = FK.epilogue_rows(0.015, 0.02, 0.05, act, n)
    got = FK.matmul_int8_fused(_t(x), _t(w.T), _t(b), ep, compute="bf16")
    _close(got.numpy(), ref, act)
    assert torch.equal(got, FK.matmul_int8_fused(_t(x), _t(w.T), _t(b), ep,
                                                 compute="int8"))


def test_conv_folded_bf16_equals_jax():
    """``conv2d_int8_folded`` (#2) in bf16 at JAX's test shapes, SILU."""
    rng = np.random.default_rng(1)
    c, o, h, w = 64, 48, 16, 16
    x, wt = _i8(rng, (1, h, w, c)), _i8(rng, (3, 3, c, o))
    b = rng.integers(-2000, 2000, (o,)).astype(np.int32)
    pads = ((1, 1), (1, 1))
    ref = JFK.conv2d_int8_folded(x, wt, b, (h, w), 1, pads, 0.03, 0.02, 0.07,
                                 act="SILU", compute="bf16")
    ep = FK.epilogue_rows(0.02, 0.03, 0.07, "SILU", o)
    got = FK.conv2d_int8_halo_fused(_t(x), _t(wt.transpose(3, 0, 1, 2)),
                                    _t(b), ep, (h, w), pads, 1,
                                    compute="bf16")
    _close(got.numpy(), ref, "SILU")


def _bneck(rng, act, compute, shortcut=True):
    c, c_, o, h = 64, 32, 64, 12
    x = _i8(rng, (1, h, h, c), -110, 110)
    w1, w2 = _i8(rng, (1, 1, c, c_), -64, 64), _i8(rng, (3, 3, c_, o), -64, 64)
    s = dict(w1=0.02, m=0.06, w2=0.015, out=0.09, x=0.04)
    ref = JFK.bottleneck_int8_fused(
        x, w1, None, s["w1"], s["m"], w2, None, s["w2"], s["out"], s["x"],
        (h, h), act1=act, act2=act, shortcut=shortcut, compute=compute)
    ep1 = FK.epilogue_rows(s["w1"], s["x"], s["m"], act, c_)
    ep2 = FK.epilogue_rows(s["w2"], s["m"], s["out"], act, o)
    got = FK.bottleneck_int8_fused(
        _t(x), _t(w1.reshape(c, c_).T), None, ep1,
        _t(w2.transpose(3, 0, 1, 2)), None, ep2, shortcut,
        FK.res_scale_bneck(s["x"], s["out"], act), compute=compute)
    return got.numpy(), np.asarray(ref)[..., :o]


def test_bottleneck_bf16_equals_jax():
    """JAX's ``test_bottleneck_bf16_compute_bit_equal`` (#6), SILU in both
    stages with the shortcut."""
    got, ref = _bneck(np.random.default_rng(2), "SILU", "bf16")
    _close(got, ref, "SILU")


def _sppf(rng, act, compute):
    c, o, h, w = 256, 128, 8, 8
    x, wt = _i8(rng, (1, h, w, c)), _i8(rng, (1, 1, 4 * c, o))
    ref = JFK.sppf_int8_fused(x, wt, None, 5, 0.03, 0.02, 0.08, act=act,
                              compute=compute)
    ep = FK.epilogue_rows(0.02, 0.03, 0.08, act, o)
    got = FK.sppf_int8_fused(_t(x), _t(wt.reshape(4 * c, o).T), None, ep, 5,
                             compute=compute)
    return got.numpy(), np.asarray(ref)


def test_sppf_bf16_within_one_of_jax():
    """JAX's ``test_sppf_bf16_compute_close`` (#4): within one quantum."""
    got, ref = _sppf(np.random.default_rng(3), "SILU", "bf16")
    _close(got, ref, "SILU", quanta=1)


def test_silu_fast_in_every_wrapper_within_one_quantum_of_jax(monkeypatch):
    """SILU_FAST in #1, #2, #3, #4, #5, #6 and #7 against JAX's kernels in
    interpret mode, which reach ``pl.reciprocal`` (spied here) and a Newton
    step where the port divides: within one quantum on at most 0.1%."""
    calls = []
    recip = pl.reciprocal

    def spy(*a, **k):
        calls.append(k)
        return recip(*a, **k)
    monkeypatch.setattr(JFK.pl, "reciprocal", spy)
    rng = np.random.default_rng(4)
    act = "SILU_FAST"
    # #1
    x, w = _i8(rng, (48, 256)), _i8(rng, (256, 72))
    ref = JFK.matmul_int8_fused(x, w, None, 0.02, 0.015, 0.05, act=act)
    got = FK.matmul_int8_fused(_t(x), _t(w.T), None,
                               FK.epilogue_rows(0.015, 0.02, 0.05, act, 72))
    _close(got.numpy(), ref, act)
    assert calls and calls[0] == {"approx": True}
    # #3, two parts at unequal scales
    xs = [_i8(rng, (77, 32)), _i8(rng, (77, 24))]
    ws = [_i8(rng, (32, 40)), _i8(rng, (24, 40))]
    ref = JFK.matmul_int8_fused_multi(xs, ws, None, [0.04, 0.06], 0.01, 0.3,
                                      act=act, bias_scale=0.05)
    me = FK.multi_epilogue(0.01, [0.04, 0.06], 0.3, act, 40,
                           bias_scale=0.05)
    got = FK.matmul_int8_fused_multi([_t(a) for a in xs],
                                     [_t(a.T) for a in ws], None, me)
    _close(got.numpy(), np.asarray(ref)[:, :40], act)
    # #2 and #5: the folded conv's two pipelines, 3x3/s1 and /s2
    for s, pipe in ((1, "blockspec"), (2, "dma")):
        x, wt = _i8(rng, (1, 16, 16, 32)), _i8(rng, (3, 3, 32, 48))
        oh = 16 // s
        pads = ((1, 1), (1, 1)) if s == 1 else ((0, 1), (0, 1))
        xf = x.reshape(1, 16, 16 // s, s * 32)   # JAX's W-phase fold
        ref = JFK.conv2d_int8_folded(xf, wt, None, (oh, oh), s, pads, 0.03,
                                     0.02, 0.2, act=act, pipeline=pipe)
        got = FK.conv2d_int8_halo_fused(
            _t(x), _t(wt.transpose(3, 0, 1, 2)), None,
            FK.epilogue_rows(0.02, 0.03, 0.2, act, 48), (oh, oh), pads, s,
            pipeline=pipe)
        _close(got.numpy(), ref, act)
    # #4 and #6
    _close(*_sppf(rng, act, "int8"), act)
    _close(*_bneck(rng, act, "int8"), act)
    # #7
    x, wd = _i8(rng, (1, 12, 12, 48)), _i8(rng, (3, 3, 48))
    ref = JFK.depthwise_conv2d_int8_fused(x, wd, None, (12, 12), (1, 1),
                                          ((1, 1), (1, 1)), 0.05, 0.02, 0.1,
                                          act=act)
    got = FK.depthwise_conv2d_int8_fused(
        _t(x), _t(wd), None, FK.epilogue_rows(0.02, 0.05, 0.1, act, 48),
        (12, 12), ((1, 1), (1, 1)))
    _close(got.numpy(), np.asarray(ref)[..., :48], act)


def test_dma_refuses_bf16_as_jax(monkeypatch):
    """#5 (``pipeline="dma"``) raises for bf16, named or from the registry,
    as JAX's ``conv2d_int8_folded`` does."""
    x, w = torch.zeros((1, 8, 8, 32), dtype=torch.int8), torch.zeros(
        (32, 3, 3, 32), dtype=torch.int8)
    ep = FK.epilogue_rows(0.01, 0.05, 0.5, "RELU", 32)
    args = (x, w, None, ep, (8, 8), ((1, 1), (1, 1)), 1)
    with pytest.raises(ValueError, match="bf16 compute not supported"):
        FK.conv2d_int8_halo_fused(*args, pipeline="dma", compute="bf16")
    monkeypatch.setenv("TAT_SERVING_COMPUTE", "bf16")
    with pytest.raises(ValueError, match="bf16 compute not supported"):
        FK.conv2d_int8_halo_fused(*args, pipeline="dma")
    with pytest.raises(ValueError, match="bf16 compute not supported"):
        JFK.conv2d_int8_folded(np.zeros((1, 8, 8, 32), np.int8),
                               np.zeros((3, 3, 32, 32), np.int8), None,
                               (8, 8), 1, ((1, 1), (1, 1)), 0.05, 0.01, 0.5,
                               act="RELU", pipeline="dma")
    assert FK.conv2d_int8_halo_fused(*args).shape == (1, 8, 8, 32)


# ---------------------------------------------------------------------------
# The engines, each variable set for both packages
# ---------------------------------------------------------------------------


def _stem_graph(act, hw=(64, 64)):
    """JAX ``test_serving_tier._stem_graph``: 6x6/2 3->8, 3x3/2 8->16, 1x1
    16->32."""
    b = zoo.GraphBuilder("stemchain", zoo.ZooConfig(dtype="int8", in_hw=hw))
    x = b.input("input", (1, hw[0], hw[1], 3))
    y = b.conv(x, 8, 6, 2, act=act)
    y = b.conv(y, 16, 3, 2, act=act)
    y = b.conv(y, 32, 1, 1, act=act)
    return b.finish([y])


def _bneck_graph(act):
    """JAX ``test_serving_tier._bneck_graph(act, shortcut=True)``."""
    b = zoo.GraphBuilder("bneck", zoo.ZooConfig(dtype="int8", in_hw=(16, 16)))
    x0 = b.input("input", (1, 16, 16, 16))
    x = b.conv(x0, 32, 3, 1, act=act)
    m = b.conv(x, 16, 1, 1, act=act)
    return b.finish([b.add(x, b.conv(m, 32, 3, 1, act=act))])


def _silu1_graph():
    b = zoo.GraphBuilder("silu1", zoo.ZooConfig(dtype="int8", in_hw=(16, 16)))
    x0 = b.input("input", (1, 16, 16, 16))
    return b.finish([b.conv(x0, 32, 3, 1, act="SILU")])


def _engines(g, x):
    """The JAX serving engine's and the port's outputs, and the port's
    engine."""
    ref = JEngine(g, JOptions(precision="serving")).run_np(x)
    eng = Engine(graph_from_jax(g), EngineOptions(precision="serving"),
                 device="cpu")
    return ref, eng.run_np(x), eng


def _all_close(got, ref, act, quanta=0):
    assert sorted(got) == sorted(ref)
    for k in ref:
        _close(got[k], ref[k], act, quanta)


@pytest.mark.parametrize("act,fast", [("RELU", False), ("SILU", False),
                                      ("SILU", True)], ids=str)
def test_stem_nogrow_as_jax(monkeypatch, act, fast):
    """JAX's ``test_stem_nogrow_bitwise_equals_grown``: under the knob the
    port's stage is JAX's (the seed convs alone), its heads equal JAX's
    within the act's bound and the grown plan's bit for bit; with
    ``TAT_FAST_SILU`` too, the conv that leaves the stage takes SILU_FAST
    in both packages (the stage keeps the exp SiLU)."""
    g = _stem_graph(act)
    x = np.random.default_rng(0).integers(-128, 128, (1, 64, 64, 3),
                                          dtype=np.int8)
    if fast:
        monkeypatch.setenv("TAT_FAST_SILU", "1")
    grown = Engine(graph_from_jax(g), EngineOptions(precision="serving"),
                   device="cpu")
    monkeypatch.setenv("TAT_STEM_NOGROW", "1")
    jplan = _plan_folds(list(fuse_act_into_conv(g).nodes), g.tensors,
                        g.outputs)
    ref, got, eng = _engines(g, x)
    # the two seed convs (cin 3 and 8); grown, the 1x1 over them too
    assert len(jplan.stem_stage) == 2
    assert eng._fn.plan.stem_stage == jplan.stem_stage
    assert len(grown._fn.plan.stem_stage) == 3
    assert [u.act for u in eng._fn.units] == [act, act] + [
        "SILU_FAST" if fast else act]
    _all_close(got, ref, act)
    assert eng._fn.launch_census() == grown._fn.launch_census()
    if not fast:
        for k, v in grown.run_np(x).items():
            np.testing.assert_array_equal(got[k], v)


def test_fast_silu_engines_as_jax(monkeypatch):
    """JAX's ``test_fast_silu_within_one_quantum_of_exact_silu`` graphs
    with ``TAT_FAST_SILU=1`` in both packages: the SiLU conv within the
    SILU_FAST bound, the bottleneck cascade (#6 and its residual) at most
    a quantum apart on at most 2% (a flipped quantum moves the next
    layer); each within JAX's own bounds of the exp SiLU engine. The port
    reads the variable once, when its engine is built."""
    x = np.random.default_rng(0).integers(-100, 100, (1, 16, 16, 16),
                                          dtype=np.int8)
    for g, share in ((_silu1_graph(), 1e-3), (_bneck_graph("SILU"), 0.02)):
        exact = Engine(graph_from_jax(g), EngineOptions(precision="serving"),
                       device="cpu")
        monkeypatch.setenv("TAT_FAST_SILU", "1")
        ref, got, eng = _engines(g, x)
        monkeypatch.delenv("TAT_FAST_SILU")
        assert {u.act for u in eng._fn.units} == {"SILU_FAST"}
        assert eng._fn.launch_census() == exact._fn.launch_census()
        for k in ref:
            d = np.abs(got[k].astype(np.int32) - ref[k].astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() <= share, (k, d.max())
        again = eng.run_np(x)   # the variable is unset now
        base = exact.run_np(x)
        for k in ref:
            np.testing.assert_array_equal(again[k], got[k])
            d = np.abs(got[k].astype(np.int32) - base[k].astype(np.int32))
            assert d.mean() < 0.1 and d.max() <= 4, (k, d.max())


@pytest.mark.parametrize("act", ["RELU", "SILU"])
def test_bf16_compute_stem_chain_as_jax(monkeypatch, act):
    """JAX's ``test_serving_bf16_compute_bitwise_equals_int8`` graph with
    ``TAT_SERVING_COMPUTE=bf16`` in both packages: equal to JAX's (SILU
    within its bound) and to the port's int8 engine bit for bit."""
    g = _stem_graph(act)
    x = np.random.default_rng(0).integers(-128, 128, (1, 64, 64, 3),
                                          dtype=np.int8)
    base = Engine(graph_from_jax(g), EngineOptions(precision="serving"),
                  device="cpu").run_np(x)
    monkeypatch.setenv("TAT_SERVING_COMPUTE", "bf16")
    ref, got, eng = _engines(g, x)
    assert eng._fn.compute == "bf16"
    _all_close(got, ref, act)
    for k in base:
        np.testing.assert_array_equal(got[k], base[k])


def test_bf16_and_fast_silu_yolov5n_as_jax(monkeypatch):
    """JAX's ``test_serving_bf16_compute_yolov5n_close`` graph (the zoo
    yolov5n, cut from 160 to 64) with ``TAT_SERVING_COMPUTE=bf16`` and
    ``TAT_FAST_SILU=1`` together in both packages (bottleneck, SPPF and
    concat fusions): heads at most a quantum apart on at most 2% of the
    values (measured: equal). Under ``TAT_STEM_NOGROW`` as well the
    random zoo graph is chaotic (a quantum flipped by JAX's in-kernel
    reciprocal moves whole heads, in either package between runs with and
    without ``TAT_FAST_SILU``), so the knob is held on the stem chain."""
    g = zoo.build_yolov5("n", zoo.ZooConfig(dtype="int8", in_hw=(64, 64)))
    x = np.random.default_rng(0).integers(-128, 128, (1, 64, 64, 3),
                                          dtype=np.int8)
    monkeypatch.setenv("TAT_SERVING_COMPUTE", "bf16")
    monkeypatch.setenv("TAT_FAST_SILU", "1")
    ref, got, eng = _engines(g, x)
    units = eng._fn.units
    assert {"bneck", "sppf", "multi"} <= {u.kind for u in units}
    assert {u.product for u in units
            if u.mirrors != "conv2d_int8_stem_fused"} == {"bf16"}
    assert {u.act for u in units} == {"SILU", "SILU_FAST", "NONE"}
    for k in ref:
        d = np.abs(got[k].astype(np.int32) - ref[k].astype(np.int32))
        assert d.max() <= 1 and (d > 0).mean() <= 0.02, (k, d.max())


def test_silu_tanh_fast_tier_as_jax(monkeypatch):
    """``TAT_SILU_TANH=1`` in both packages' fast tier (bf16, the zoo
    yolov5n at 64): heads within the fast tier's ``BF16_HEAD_ULPS`` of the
    largest |head|; and the tanh form differs from the exp form."""
    g = zoo.build_yolov5("n", zoo.ZooConfig(in_hw=(64, 64), w_scale=0.0005))
    x = np.random.default_rng(3).integers(-128, 128, (2, 64, 64, 3),
                                          dtype=np.int8)
    opts = dict(precision="fast", quantize_outputs=False)
    plain = Engine(graph_from_jax(g), EngineOptions(**opts),
                   device="cpu").run(x)
    monkeypatch.setenv("TAT_SILU_TANH", "1")
    ref = {k: np.asarray(v, np.float32)
           for k, v in JEngine(g, JOptions(**opts)).run(x).items()}
    eng = Engine(graph_from_jax(g), EngineOptions(**opts), device="cpu")
    assert eng._fn.silu_tanh
    got = eng.run(x)
    for k in ref:
        top = np.abs(ref[k]).max()
        tol = BF16_HEAD_ULPS * 2.0 ** (np.floor(np.log2(top)) - 7)
        assert np.abs(got[k].float().numpy() - ref[k]).max() <= tol, k
    assert any(not torch.equal(got[k], plain[k]) for k in got)


def test_silu_tanh_exact_tier_float_graph_as_jax(monkeypatch):
    """``TAT_SILU_TANH=1`` where JAX's float SiLU runs outside the fast
    tier: the exact tier over a float32 graph (the QAT graphs' tier),
    within rtol 1e-5 of JAX's."""
    g = zoo.build_tiny(zoo.ZooConfig(dtype="float32", in_hw=(16, 16)))
    x = np.random.default_rng(5).normal(0, 1, (1, 16, 16, 3)).astype(
        np.float32)
    monkeypatch.setenv("TAT_SILU_TANH", "1")
    ref = JEngine(g, JOptions(precision="exact")).run_np(x)
    eng = Engine(graph_from_jax(g), EngineOptions(precision="exact"),
                 device="cpu")
    got = eng.run_np(x)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5,
                                   atol=1e-5 * np.abs(ref[k]).max())
