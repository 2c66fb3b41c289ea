"""The port's ``ir.passes.fold_stage2_downsample`` (the s2d fold one stage
deeper: the stem emits 2x2 space-to-depth layout, the 3x3 s2 downsample
becomes 2x2 s1) against the JAX package's, on the patterns of
``tests/test_fold_stage2.py`` (the int8 zoo yolov5n at 64 after
``stem_space_to_depth``), handed over by ``graph_from_jax``; inputs from
seeded numpy:

- the rewritten graph is JAX's: ops, inputs, outputs, attrs, tensor
  shapes, constants' bytes (OIHW in the IR), and the engine's conv
  weights in the port's OHWI layout are JAX's HWIO ones transposed;
- it declines where JAX's declines: no s2d stem, a SAME-padded
  downsample, a chain tensor that is a graph output;
- the exact tier is bit-identical before and after the fold, and equal to
  JAX's folded exact tier; the fast tier within JAX's 1e-2
  (``FAST_TOL``) of the unfolded one;
- ``TAT_S2D_DEEP`` is in the port's registry, off by default, and
  ``trace_path.fast_graph`` folds where it is set.
"""

import copy

import numpy as np
import pytest

from thingino_accel_tpu.ir import passes as JP
from thingino_accel_tpu.models import zoo as JZ
from thingino_accel_tpu.runtime import Engine as JEngine
from thingino_accel_tpu_torch.ir import passes as P
from thingino_accel_tpu_torch.ir.graph import graph_from_jax
from thingino_accel_tpu_torch.models import yolo
from thingino_accel_tpu_torch.runtime.engine import Engine, EngineOptions
from thingino_accel_tpu_torch.utils import config

FAST_TOL = 1e-2    # fast heads folded vs not (tests/test_fold_stage2.py)


def _s2d(w_scale=0.0005):
    """JAX's graph after the s2d stem, and the port's copy of it."""
    jg = JZ.build_yolov5("n", JZ.ZooConfig(dtype="int8", in_hw=(64, 64),
                                           w_scale=w_scale))
    assert JP.stem_space_to_depth(jg)
    g = graph_from_jax(jg)
    g.stem_s2d = True
    return jg, g


def test_rewrite_matches_jax():
    jg, g = _s2d()
    assert JP.fold_stage2_downsample(jg) and P.fold_stage2_downsample(g)
    assert len(jg.nodes) == len(g.nodes)
    for a, b in zip(jg.nodes, g.nodes):
        assert (a.op, a.inputs, a.outputs, a.attrs) == (
            b.op, b.inputs, b.outputs, b.attrs)
    assert set(jg.tensors) == set(g.tensors)
    for k, t in jg.tensors.items():
        u = g.tensors[k]
        assert tuple(t.shape) == tuple(u.shape), k
        if t.data is not None:
            assert u.data.dtype == t.data.dtype
            assert u.data.tobytes() == t.data.tobytes(), k
    stem, down = [n for n in g.nodes if n.op == "CONV2D"][:2]
    assert (stem.attrs["kernel"], stem.attrs["stride"]) == ((4, 4), (2, 2))
    assert (down.attrs["kernel"], down.attrs["stride"],
            down.attrs["explicit_pad"]) == ((2, 2), (1, 1), (1, 0, 1, 0))
    # the engines' weights: the port's OHWI is JAX's HWIO transposed
    jw = JEngine(jg)._np_params
    pw = Engine(g, device="cpu").params
    for n in (stem, down):
        w = n.inputs[1]
        np.testing.assert_array_equal(
            pw[w].numpy(), np.transpose(np.asarray(jw[w]), (3, 0, 1, 2)))


@pytest.mark.parametrize("case", ["no_s2d", "same_pad", "escaping"])
def test_declines_where_jax_declines(case):
    jg = JZ.build_yolov5("n", JZ.ZooConfig(dtype="int8", in_hw=(64, 64)))
    if case != "no_s2d":
        assert JP.stem_space_to_depth(jg)
        convs = [n for n in jg.nodes if n.op == "CONV2D"]
        if case == "same_pad":
            convs[1].attrs["padding"] = "SAME"
            convs[1].attrs.pop("explicit_pad", None)
        else:
            jg.outputs = list(jg.outputs) + [convs[0].outputs[0]]
    g = graph_from_jax(jg)
    before = copy.deepcopy(g)
    assert not JP.fold_stage2_downsample(jg)
    assert not P.fold_stage2_downsample(g)
    assert [(n.op, n.attrs) for n in g.nodes] == [
        (n.op, n.attrs) for n in before.nodes]


def _frames(n, seed=11):
    x = np.random.default_rng(seed).integers(-128, 128, (n, 64, 64, 3),
                                             dtype=np.int8)
    return yolo.space_to_depth_frames(x)


def test_exact_tier_bit_identical():
    jg, g = _s2d()
    folded = copy.deepcopy(g)
    assert P.fold_stage2_downsample(folded) and JP.fold_stage2_downsample(jg)
    xf = _frames(2)
    a = Engine(g, device="cpu").run_np(xf)
    b = Engine(folded, device="cpu").run_np(xf)
    want = JEngine(jg).run_np(xf)
    assert a.keys() == b.keys() == want.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(b[k], want[k])


def test_fast_tier_reassociation_bound():
    _, g = _s2d()
    folded = copy.deepcopy(g)
    assert P.fold_stage2_downsample(folded)
    opts = EngineOptions(precision="fast", quantize_outputs=False)
    xf = _frames(2)
    a = Engine(g, opts, device="cpu").run_np(xf)
    b = Engine(folded, opts, device="cpu").run_np(xf)
    for k in a:
        assert np.abs(a[k] - b[k]).max() < FAST_TOL, k


def test_tat_s2d_deep_in_registry(monkeypatch):
    from thingino_accel_tpu_torch import trace_path
    monkeypatch.delenv("TAT_S2D_DEEP", raising=False)
    assert config.get("TAT_S2D_DEEP") is False
    assert "TAT_S2D_DEEP" in config.describe()

    def kernels():
        g = trace_path.fast_graph("yolov5s", in_hw=(64, 64))
        return [n.attrs["kernel"] for n in g.nodes if n.op == "CONV2D"][:2]

    assert kernels() == [(3, 3), (3, 3)]
    monkeypatch.setenv("TAT_S2D_DEEP", "1")
    assert config.get("TAT_S2D_DEEP") is True
    assert kernels() == [(4, 4), (2, 2)]
