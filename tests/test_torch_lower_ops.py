"""The shared lowering of every tier against the JAX package's engine.

``runtime.executor.Executor.lower_node`` is the port of JAX's
``_lower_node``; every tier sends it each node that no kernel unit takes.
The cases run the graphs of ``models.ops_graphs`` at a small size (the int8
ops graph and its float32 twin at batch 2, 16x16x16; the recurrent graph
at batch 2, 8 channels, length 16, T 4, hidden 8), built by the JAX
package's ``ir.graph`` and handed to the port through ``graph_from_jax``,
on the same seeded numpy input, in each tier and mode: the planned and the
unplanned serving tier, the exact tier in full and compat mode, and the
fast tier. Each (graph, tier) runs once, with every op's output a graph
output; each case compares one op's outputs. A tier runs the outputs that
JAX's engine takes there (``NOT_TAKEN`` lists the rest, and
``test_jax_refuses_what_the_cases_leave_out`` shows JAX refusing them).

Tolerances: int8 outputs bit for bit, but POW's (neither ``torch.pow``
nor XLA's is correctly rounded): at most 1 quantum apart, on at most 0.1%
of the values. Float outputs (bf16 in the fast tier) within 1e-5 of the
output's largest magnitude, the convs' (CONV2D, CONV1D,
CONV1D_TRANSPOSE) within 1e-4 (measured: 5e-7 and 0 in bf16).

Also here: the whole real yolov5n file in every tier (its degenerate
tail), ``tiny_160_f32.mars`` against JAX, the engine options ``nchw_io``,
``donate_inputs``, ``input_info`` and ``output_info``, the params by role,
and the grouped float conv, which only the port lowers.
"""

import functools
import os

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from thingino_accel_tpu.ir import graph as JIR
from thingino_accel_tpu.runtime import Engine as JEngine
from thingino_accel_tpu.runtime import EngineOptions as JOptions
from thingino_accel_tpu.runtime import executor as JEX
from thingino_accel_tpu_torch.ir.graph import graph_from_jax
from thingino_accel_tpu_torch.models import ops_graphs as OG
from thingino_accel_tpu_torch.ops import reference as R
from thingino_accel_tpu_torch.runtime import executor as EX
from thingino_accel_tpu_torch.runtime.engine import (
    Engine, EngineOptions, load_graph,
)

REPO = os.path.join(os.path.dirname(__file__), "..")
REAL_YOLO = os.path.join(REPO, "models", "yolov5n_cal_int8.mars")
TINY_F32 = os.path.join(REPO, "models", "fixtures", "tiny_160_f32.mars")

GRAPHS = {
    "int8": lambda ir: OG.int8_ops_graph(2, 16, 16, 16, ir=ir),
    "float": lambda ir: OG.float_ops_graph(2, 16, 16, 16, ir=ir),
    "recurrent": lambda ir: OG.recurrent_graph(2, 8, 16, 4, 8, ir=ir),
}
# tier -> (precision, mode, planned); the fast tier leaves its outputs in
# bf16 (``quantize_outputs=False``, as the fast serving pipeline runs it):
# XLA fuses a bf16 op into the QUANT after it and keeps its value in
# float32, where torch rounds it to bf16 first, so a requantized output may
# move by a quantum (1% of the int8 graph's BATCHNORM outputs; the bf16
# values themselves are equal)
TIERS = {"serving": ("serving", "full", True),
         "unplanned": ("serving", "full", False),
         "exact": ("exact", "full", True),
         "compat": ("exact", "compat", True),
         "fast": ("fast", "full", True)}


def _options(opts_cls, tier, **kw):
    prec, mode, _ = TIERS[tier]
    if prec == "fast":
        kw["quantize_outputs"] = False
    return opts_cls(precision=prec, mode=mode, **kw)
CONVS = {"CONV2D", "CONV2D_GROUPED", "CONV2D_DILATED", "CONV2D_STRIDE_2_1",
         "CONV1D", "CONV1D_TRANSPOSE"}
POW_SHARE = 1e-3
FLOAT_TOL, CONV_TOL = 1e-5, 1e-4

# what JAX's engine does not take: in compat mode GLOBAL_AVGPOOL and the
# shape ops pass through, so FC and GRU meet the wrong shape; XLA refuses
# a grouped float conv; the fast tier's dequantize scales an FC weight
# [K, O] per channel along K
_COMPAT_FC = {"FC", "FC_PER_CHANNEL", "SOFTMAX"}
NOT_TAKEN = {
    ("int8", "compat"): _COMPAT_FC,
    ("int8", "fast"): {"CONV2D_GROUPED", "FC_PER_CHANNEL"},
    ("float", "serving"): {"CONV2D_GROUPED"},
    ("float", "unplanned"): {"CONV2D_GROUPED"},
    ("float", "exact"): {"CONV2D_GROUPED"},
    ("float", "compat"): {"CONV2D_GROUPED"} | _COMPAT_FC,
    ("float", "fast"): {"CONV2D_GROUPED"},
    ("recurrent", "compat"): {"GRU", "GRU_BIDIRECTIONAL"},
}


def _ops(kind):
    table = OG.RECURRENT_OPS if kind == "recurrent" else {
        k: (v,) for k, v in OG.OPS.items()}
    return table


CASES = [(kind, tier, op) for kind in GRAPHS for tier in TIERS
         for op in _ops(kind) if op not in NOT_TAKEN.get((kind, tier), ())]
REFUSED = [(kind, tier, op) for (kind, tier), ops in NOT_TAKEN.items()
           for op in sorted(ops)]


def _input(graph, seed=1):
    t = graph.tensors[graph.inputs[0]]
    rng = np.random.default_rng(seed)
    if t.dtype == np.int8:
        return rng.integers(-128, 128, t.shape, dtype=np.int8)
    return rng.normal(0, 1, t.shape).astype(np.float32)


def _jax_run(graph, tier, x):
    prec, mode, planned = TIERS[tier]
    orig = JEX._plan_folds
    if not planned:   # the plan is made at trace time, on the first run
        JEX._plan_folds = lambda *a, **k: None
    try:
        with pltpu.force_tpu_interpret_mode():
            out = JEngine(graph, _options(JOptions, tier)).run_np(x)
    finally:
        JEX._plan_folds = orig
    return {k: np.asarray(v, np.float32) if v.dtype.kind == "V"
            or str(v.dtype) == "bfloat16" else v for k, v in out.items()}


def _port_engine(graph, tier):
    return Engine(graph_from_jax(graph), _options(EngineOptions, tier),
                  device="cpu", planned=TIERS[tier][2])


def _taken(kind, tier):
    """The graph (JAX's) with the outputs JAX's engine takes in the tier,
    and its input."""
    jg = GRAPHS[kind](JIR)
    left = NOT_TAKEN.get((kind, tier), ())
    return jg.with_outputs([o for op, outs in _ops(kind).items()
                            if op not in left for o in outs]), _input(jg)


@functools.lru_cache(maxsize=None)
def _outputs(kind, tier):
    """One run of the graph in the tier, JAX's and the port's."""
    sub, x = _taken(kind, tier)
    return _jax_run(sub, tier, x), _port_engine(sub, tier).run_np(x)


def _check(got, ref, op, what):
    assert got.shape == ref.shape, what
    if ref.dtype == np.int8:
        assert got.dtype == np.int8, what
        if op == "POW":
            diff = np.abs(got.astype(np.int32) - ref)
            assert diff.max() <= 1, what
            assert (diff > 0).mean() <= POW_SHARE, what
        else:
            np.testing.assert_array_equal(got, ref, err_msg=what)
        return
    tol = (CONV_TOL if op in CONVS else FLOAT_TOL) * float(np.abs(ref).max())
    err = float(np.abs(got.astype(np.float64) - ref).max())
    assert err <= tol, f"{what}: {err} > {tol}"


@pytest.fixture(autouse=True)
def _interpret_mode():
    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.mark.parametrize("kind,tier,op", CASES)
def test_op_matches_jax(kind, tier, op):
    ref, got = _outputs(kind, tier)
    for name in _ops(kind)[op]:
        _check(got[name], ref[name], op, f"{kind} {tier} {op} {name}")


@pytest.mark.parametrize("kind,tier,op", REFUSED)
def test_jax_refuses_what_the_cases_leave_out(kind, tier, op):
    """The cases leave out only what JAX's engine cannot run."""
    jg = GRAPHS[kind](JIR)
    sub = jg.with_outputs(list(_ops(kind)[op]))
    with pytest.raises((TypeError, ValueError)):
        _jax_run(sub, tier, _input(jg))


def test_op_set_is_jaxs():
    """Every op of JAX's ``_lower_node`` is in the port's one op set, and
    the graphs here drive each of them but the SILU family, which the
    serving and exact tests drive."""
    lowered = {"CONV2D", "DEPTHWISE_CONV2D", "MAXPOOL", "AVGPOOL",
               "GLOBAL_AVGPOOL", "RELU", "RELU6", "LEAKY_RELU", "SIGMOID",
               "SILU", "SILU_FUSED", "SOFTMAX", "CONCAT", "ADD", "MUL",
               "UPSAMPLE", "TRANSPOSE", "RESHAPE", "DEQUANT", "QUANT",
               "FAKE_QUANT", "SPLIT", "SLICE", "SUB", "DIV", "POW", "GRU",
               "CONV1D", "CONV1D_TRANSPOSE", "CLIP", "BATCHNORM", "FC"}
    assert EX.LOWERED_OPS == lowered
    driven = {n.op for kind in GRAPHS for n in GRAPHS[kind](JIR).nodes}
    assert lowered - driven == {"DEPTHWISE_CONV2D", "MAXPOOL", "RELU",
                                "RELU6", "LEAKY_RELU", "SIGMOID", "SILU",
                                "SILU_FUSED", "CONCAT", "ADD", "MUL"}


def test_unknown_op_raises_and_degenerate_nodes_fill_zeros():
    """An op no tier lowers raises at build, naming ROADMAP; the same op
    over zero-sized tensors is degenerate and writes zeros first, as
    JAX's guard."""
    for zero in (False, True):
        b = OG._Builder(JIR, 0)
        x = b.act("x", (1, 4, 4, 8), np.int8, 0.1)
        y = b.act("y", (1, 0, 4, 8) if zero else (1, 4, 4, 8), np.int8, 0.1)
        b.node("WARP", [x], [y])
        jg = b.graph("unknown", [x], [y])
        if not zero:
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                Engine(graph_from_jax(jg), device="cpu")
            continue
        xin = np.ones((1, 4, 4, 8), np.int8)
        ref = JEngine(jg).run_np(xin)["y"]
        for tier in TIERS:
            got = _port_engine(jg, tier).run_np(xin)
            np.testing.assert_array_equal(got["y"], ref)


@pytest.mark.parametrize("prec", ["serving", "fast", "exact"])
def test_whole_real_yolov5n(prec):
    """The real yolov5n file loaded whole (its three SOFTMAX and six
    RESHAPE nodes over zero-sized tensors included) builds and runs in
    every tier; its heads equal ``from_yolo_mars``'s bit for bit, and the
    planned serving census stays 50 launches a forward."""
    opts = EngineOptions(precision=prec)
    whole = Engine(load_graph(REAL_YOLO), opts, device="cpu")
    cut = Engine.from_yolo_mars(REAL_YOLO, opts, device="cpu")
    assert [n.op for n in whole.graph.nodes].count("SOFTMAX") == 3
    if prec == "serving":
        census = whole._fn.launch_census()
        assert census == cut._fn.launch_census()
        assert {k: v for k, v in census.items() if v} == {
            "matmul_int8_fused": 17, "conv2d_int8_halo_fused": 8,
            "matmul_int8_fused_multi": 15, "bottleneck_int8_fused": 10}
    x = np.random.default_rng(0).integers(-128, 128, (1, 640, 640, 3),
                                          dtype=np.int8)
    a, b = whole.run_np(x), cut.run_np(x)
    assert set(a) == set(b) and len(a) == 3
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("tier", ["exact", "compat", "serving", "unplanned",
                                  "fast"])
def test_tiny_160_f32_matches_jax(tier):
    """The f32 fixture (float convs) in every tier, against JAX's engine:
    within 1e-4 of the largest |output| (measured equal)."""
    from thingino_accel_tpu.formats.mars import read_mars
    from thingino_accel_tpu.ir.graph import from_mars as jax_from_mars
    jg = jax_from_mars(read_mars(TINY_F32))
    x = np.random.default_rng(2).normal(0, 1, (2, 160, 160, 3)).astype(
        np.float32)
    ref = _jax_run(jg, tier, x)
    got = _port_engine(jg, tier).run_np(x)
    assert set(got) == set(ref)
    for k in ref:
        _check(got[k], ref[k], "CONV2D", f"{tier} {k}")


def test_nchw_io_and_infos_match_jax():
    """``nchw_io``: NCHW in, NCHW out, as JAX's engine; ``trace`` takes
    NCHW and returns NHWC. ``input_info`` / ``output_info`` are the graph's
    tensors, as JAX's."""
    jg = GRAPHS["int8"](JIR).with_outputs(["p2", "fc1"])
    x = _input(jg)
    x_nchw = np.ascontiguousarray(x.transpose(0, 3, 1, 2))
    for tier in ("serving", "exact"):
        prec, mode, _ = TIERS[tier]
        with pltpu.force_tpu_interpret_mode():
            ref = JEngine(jg, JOptions(precision=prec, mode=mode,
                                       nchw_io=True)).run_np(x_nchw)
        eng = Engine(graph_from_jax(jg), EngineOptions(
            precision=prec, mode=mode, nchw_io=True), device="cpu")
        got = eng.run_np(x_nchw)
        plain = _port_engine(jg, tier).run_np(x)
        assert got["p2"].shape == (2, 16, 16, 16)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        np.testing.assert_array_equal(got["p2"],
                                      plain["p2"].transpose(0, 3, 1, 2))
        np.testing.assert_array_equal(
            eng.trace(x_nchw)["p2"].numpy(), plain["p2"])
    jeng = JEngine(jg)
    for got, ref in [(eng.input_info(), jeng.input_info()),
                     (eng.output_info(1), jeng.output_info(1))]:
        assert (got.name, got.shape, got.dtype, got.quant.scale) == (
            ref.name, ref.shape, ref.dtype, ref.quant.scale)


@pytest.mark.parametrize("tier", ["serving", "unplanned", "exact", "fast"])
def test_donate_inputs(tier):
    """``donate_inputs`` changes no output (JAX's engine with it gives the
    same), and the fed input leaves the forward's tensors after its last
    reader."""
    jg, x = _taken("int8", tier)
    eng = Engine(graph_from_jax(jg), _options(EngineOptions, tier,
                                              donate_inputs=True),
                 device="cpu", planned=TIERS[tier][2])
    got = eng.run_np(x)
    ref = _outputs("int8", tier)[1]
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    drops = eng._fn.donated()
    seq = eng._fn.steps or eng._fn.nodes
    last = max(i for i, s in enumerate(seq)
               if "x" in (s.reads if eng._fn.steps else s.inputs))
    assert drops[last] == ["x"] and sum(map(len, drops)) == 1
    if tier == "exact":
        with pltpu.force_tpu_interpret_mode():
            jref = JEngine(jg, JOptions(donate_inputs=True)).run_np(x)
        for k in jref:
            np.testing.assert_array_equal(got[k], jref[k], err_msg=k)


@pytest.mark.parametrize("kind", list(GRAPHS))
def test_prepare_params_equal_jax(kind):
    """``prepare_params`` equals JAX's on the ops graphs: conv weights HWIO,
    FC, GRU, CONV1D, CONV1D_TRANSPOSE and BATCHNORM params as in the
    graph; ``device_params`` repacks the conv weights alone."""
    jg = GRAPHS[kind](JIR)
    ref = JEX.prepare_params(jg)
    pg = graph_from_jax(jg)
    got = EX.prepare_params(pg)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        assert got[k].dtype == ref[k].dtype
    params = EX.build_executor(pg, "cpu", precision="exact").device_params(ref)
    conv_w = EX.conv_weight_names(pg)
    assert conv_w == ({"p1_w", "p2_w", "g_w", "d_w", "s21_w"}
                      if kind != "recurrent" else set())
    for k, v in params.items():
        want = np.transpose(ref[k], (3, 0, 1, 2)) if k in conv_w else ref[k]
        np.testing.assert_array_equal(v.float().numpy(),
                                      np.asarray(want, np.float32), err_msg=k)


def test_params_by_role_keep_a_4d_int8_operand():
    """A 4-D int8 constant that is no conv weight (an ADD operand) keeps
    its layout: the engine on the JAX params equals JAX's, run op by op
    (``jit=False``: jitted, XLA contracts ``add_q``'s ``a * sa + b * sb``
    into a fused multiply-add, and at these scales' rounding ties 3% of
    the sums then round the other way; the port, like the reference, rounds
    each product)."""
    b = OG._Builder(JIR, 0)
    x = b.act("x", (2, 8, 8, 4), np.int8, 0.1)
    k = b.const("k", b.rng.integers(-128, 128, (1, 8, 8, 4), dtype=np.int8),
                scale=0.05)
    y = b.act("y", (2, 8, 8, 4), np.int8, 0.1)
    b.node("ADD", [x, k], [y])
    jg = b.graph("add_const", [x], [y])
    xin = _input(jg)
    jeng = JEngine(jg, JOptions(jit=False))
    assert EX.params_from_jax(jeng._np_params, "cpu")["k"].shape == (
        1, 8, 8, 4)
    for tier in TIERS:
        prec, mode, planned = TIERS[tier]
        eng = Engine(graph_from_jax(jg), EngineOptions(precision=prec,
                                                       mode=mode),
                     device="cpu", params=jeng._np_params, planned=planned)
        assert tuple(eng.params["k"].shape) == (1, 8, 8, 4)
        got = eng.run_np(xin)
        if prec != "fast":
            np.testing.assert_array_equal(got["y"], jeng.run_np(xin)["y"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_float_conv_is_its_groups(dtype):
    """A grouped float conv (the port's own: XLA refuses it in JAX's
    ``conv2d_f32``) equals its groups run apart and concatenated."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(0, 1, (2, 9, 7, 8)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 0.3, (6, 3, 3, 4)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 0.1, 6).astype(np.float32))
    args = ((5, 4), (2, 2), (1, 1), ((1, 1), (1, 1)), True, dtype)
    got = R.conv2d_f32(x, w, bias, *args, groups=2)
    parts = [R.conv2d_f32(x[..., 4 * g:4 * g + 4], w[3 * g:3 * g + 3],
                          bias[3 * g:3 * g + 3], *args) for g in range(2)]
    torch.testing.assert_close(got, torch.cat(parts, -1), rtol=0, atol=0)
