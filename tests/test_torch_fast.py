"""The fast tier end to end, port vs JAX on the same seeded numpy inputs.

- The fast executor at float32 (``build_executor(g, precision="fast")``,
  the JAX ``Engine`` runs the tier in bf16 only, so its test builds the
  JAX ``build_executor(g, ExecOptions(compute_dtype=float32))``
  directly) on the zoo yolov5n / yolov5s / NanoDet at 64x64 and the real
  yolov5n at 640: float heads within rtol 1e-4, atol 1e-4 x the largest
  |head| (both sum exact f32 products, in other orders).
- ``Engine(precision="fast")`` (bf16) against the JAX fast ``Engine``:
  float heads within ``BF16_HEAD_ULPS`` bf16 ulps of the largest |head|
  of the level (the ulp of its binade), and int8 heads
  (``quantize_outputs=True``) within ``BF16_Q_MAX`` quanta on at most
  ``BF16_Q_SHARE`` of the values (measured on the real yolov5n: 2 quanta
  on 11.8-13.1%). Each conv adds its bias to the f32 sums and rounds
  once, as JAX does (ROADMAP C.9, closed); bf16 still rounds at other
  places in the two frameworks: each torch op of ``x * sigmoid(x)``,
  which XLA fuses. Measured on the test's inputs: 1 ulp on the zoo
  yolov5n / yolov5s, 0 on NanoDet (no SiLU: equal to JAX's), 3 on the
  real yolov5n (before C.9's repair 1, 1, 1 and 3). The bound is that
  largest gap, so that it cannot grow unseen. (Over seeds 0-5 the real
  yolov5n's gap reaches 3.625, the zoo graphs' stay at 1.)
- ``EngineOptions(accum_dtype=torch.bfloat16)`` (the JAX bench's mode,
  each conv's sums rounded to bf16 before the bias) against the JAX
  engine with ``accum_dtype=jnp.bfloat16``: float heads within
  ``BF16_ACCUM_HEAD_ULPS`` (measured on the test's inputs: 1 on the zoo
  graphs and NanoDet, 4 on the real yolov5n; over seeds 0-5 at most 4).
- The s2d stem (``stem_space_to_depth``) at float32 gives the heads of
  the unrewritten stem, within the float32 tolerance above.
- The pipeline (``models.yolo.build_serving_pipeline`` of a fast engine,
  uint8 frames -> letterbox -> s2d -> bf16 quantize -> engine -> decode
  -> NMS) against the JAX bench's composition (decode + NMS jitted, as
  the bench runs them), detections matched one to one with the same
  class. At float32, at IoU >= 0.99, at least ``F32_MATCH_SHARE`` of
  them: equal, but for the NMS decisions that sit on a knife edge, where
  the heads' last bits (each framework sums in its own order) swap two
  scores 2e-8 apart or flip a suppression. At bf16, at IoU >= 0.9: the
  port's bf16 detections match JAX's f32 ones at least as well as JAX's
  own bf16 ones do, less ``BF16_SLACK``, and JAX's bf16 ones at
  ``BF16_MATCH_SHARE`` or more: two bf16 runs round differently, this
  random zoo detector's 50 boxes a frame overlap near the IoU threshold,
  and the real yolov5n gives 16-20 detections at conf 0.001 (one is 0.05
  of the share). Measured at seeds 0-5 (the test's seed 9 in brackets):
  f32 0.918-1.0 (0.966) on the zoo yolov5s, 1.0 (1.0) on the real
  yolov5n; the port's bf16 less JAX's, against JAX's f32, -0.036 to
  +0.092 (-0.063) and -0.152 to +0.120 (-0.040); the two bf16 runs
  matched 0.514-0.610 (0.547) and 0.778-1.0 (0.833). Models: the zoo
  yolov5s at 128 (weights at w_scale 0.0005; the three detect convs'
  biases zeroed and their weights at scale 0.25, so that scores spread
  over 0.43-0.75 instead of tying at their biases' sigmoid), 4 frames of
  128x256, and the real yolov5n, 4 frames of 360x640 (the letterbox pads
  them; its resize is held in ``tests/test_torch_yolo.py``; no detection
  on noise at conf 0.25: its heads are also held at conf 0.001).

The zoo graphs are built at w_scale 0.0005: at the zoo's default 0.01 the
random weights blow the float activations up to 1e10 and bf16 rounding
swamps any comparison.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thingino_accel_tpu.formats.mars import read_mars
from thingino_accel_tpu.ir import passes as JP
from thingino_accel_tpu.ir.graph import from_mars as jax_from_mars
from thingino_accel_tpu.models import yolo as JY
from thingino_accel_tpu.models import zoo
from thingino_accel_tpu.runtime import Engine as JEngine
from thingino_accel_tpu.runtime import EngineOptions as JOptions
from thingino_accel_tpu.runtime.executor import ExecOptions
from thingino_accel_tpu.runtime.executor import build_executor as jbuild
from thingino_accel_tpu_torch.ir import passes as P
from thingino_accel_tpu_torch.ir.graph import graph_from_jax
from thingino_accel_tpu_torch.models import yolo as Y
from thingino_accel_tpu_torch.ops import decode_kernel as DK
from thingino_accel_tpu_torch.runtime.engine import Engine, EngineOptions
from thingino_accel_tpu_torch.runtime.executor import (
    FastExecutor, build_executor,
)

REAL_YOLO = os.path.join(os.path.dirname(__file__), "..", "models",
                         "yolov5n_cal_int8.mars")
BF16_HEAD_ULPS = 3
BF16_ACCUM_HEAD_ULPS = 4
BF16_Q_MAX, BF16_Q_SHARE = 2, 0.2
F32_MATCH_SHARE = 0.9
BF16_SLACK, BF16_MATCH_SHARE = 0.2, 0.45
NMS_KW = dict(max_dets=100, pre_nms=128, topk_group=8)


def _real():
    g = jax_from_mars(read_mars(REAL_YOLO))
    return g.with_outputs(JY.find_detect_outputs(g))


GRAPHS = {
    "zoo-v5n-64": lambda: zoo.build_yolov5(
        "n", zoo.ZooConfig(in_hw=(64, 64), w_scale=0.0005)),
    "zoo-v5s-64": lambda: zoo.build_yolov5(
        "s", zoo.ZooConfig(in_hw=(64, 64), w_scale=0.0005)),
    "nanodet-64": lambda: zoo.build_nanodet(
        zoo.ZooConfig(in_hw=(64, 64), w_scale=0.0005)),
    "real-v5n": _real,
}


def _input(g, seed, batch=2):
    shape = (batch,) + tuple(g.tensors[g.inputs[0]].shape[1:])
    return np.random.default_rng(seed).integers(-128, 128, shape,
                                                dtype=np.int8)


def _jax_f32(jeng):
    """The JAX fast graph through ``build_executor`` at float32."""
    fn = jax.jit(jbuild(jeng.graph, ExecOptions(compute_dtype=jnp.float32)))
    return lambda feed: {k: np.asarray(v) for k, v in
                         fn(jeng.params, feed).items()}


def _at_f32(eng):
    """The fast engine's graph through the port's executor at float32."""
    eng._fn = build_executor(eng.graph, "cpu", precision="fast")
    eng.params = eng._fn.device_params(eng._np_params)
    return eng


def _assert_f32_close(got, ref):
    for k in ref:
        np.testing.assert_allclose(np.asarray(got[k]), ref[k], rtol=1e-4,
                                   atol=1e-4 * np.abs(ref[k]).max(),
                                   err_msg=k)


@pytest.mark.parametrize("name", GRAPHS)
def test_fast_executor_f32_matches_jax(name):
    g = GRAPHS[name]()
    jeng = JEngine(g, JOptions(precision="fast", quantize_outputs=False))
    eng = _at_f32(Engine(graph_from_jax(g), EngineOptions(
        precision="fast", quantize_outputs=False), device="cpu"))
    assert isinstance(eng._fn, FastExecutor)
    x = _input(g, seed=len(name), batch=1 if name == "real-v5n" else 2)
    ref = _jax_f32(jeng)({g.inputs[0]: jnp.asarray(x)})
    got = eng.run_np(x)
    assert all(v.dtype == np.float32 for v in got.values())
    _assert_f32_close(got, ref)


@pytest.mark.parametrize("quantize_outputs", [False, True])
@pytest.mark.parametrize("name", GRAPHS)
def test_fast_engine_bf16_matches_jax(name, quantize_outputs):
    g = GRAPHS[name]()
    opts = dict(precision="fast", quantize_outputs=quantize_outputs)
    jeng = JEngine(g, JOptions(**opts))
    eng = Engine(graph_from_jax(g), EngineOptions(**opts), device="cpu")
    assert eng.options.compute_dtype == torch.bfloat16
    x = _input(g, seed=len(name) + 1, batch=1 if name == "real-v5n" else 2)
    ref = {k: np.asarray(v, np.float32) for k, v in jeng.run(x).items()}
    out = eng.run(x)
    for k in ref:
        got = out[k].float().numpy()
        if quantize_outputs:
            assert out[k].dtype == torch.int8
            d = np.abs(got - ref[k])
            assert d.max() <= BF16_Q_MAX, k
            assert (d > 0).mean() <= BF16_Q_SHARE, k
        else:
            assert out[k].dtype == torch.bfloat16
            top = np.abs(ref[k]).max()
            tol = BF16_HEAD_ULPS * 2.0 ** (np.floor(np.log2(top)) - 7)
            assert np.abs(got - ref[k]).max() <= tol, k


def _head_ulps(got, ref):
    """|got - ref| in bf16 ulps of the largest |ref| of each head."""
    return {k: float(np.abs(got[k] - ref[k]).max() / 2.0 ** (
        np.floor(np.log2(np.abs(ref[k]).max())) - 7)) for k in ref}


@pytest.mark.parametrize("name", GRAPHS)
def test_fast_engine_bf16_accum_matches_jax(name):
    """The JAX bench's mode: each conv's sums rounded to bf16 before its
    bias, in both packages."""
    g = GRAPHS[name]()
    jeng = JEngine(g, JOptions(precision="fast", quantize_outputs=False,
                               accum_dtype=jnp.bfloat16))
    eng = Engine(graph_from_jax(g), EngineOptions(
        precision="fast", quantize_outputs=False,
        accum_dtype=torch.bfloat16), device="cpu")
    assert eng._fn.accum_dtype == torch.bfloat16
    x = _input(g, seed=len(name) + 1, batch=1 if name == "real-v5n" else 2)
    ref = {k: np.asarray(v, np.float32) for k, v in jeng.run(x).items()}
    got = {k: v.float().numpy() for k, v in eng.run(x).items()}
    gaps = _head_ulps(got, ref)
    assert max(gaps.values()) <= BF16_ACCUM_HEAD_ULPS, gaps


@pytest.mark.parametrize("name", ["zoo-v5s-64", "real-v5n"])
def test_s2d_stem_gives_the_heads_of_the_plain_stem(name):
    """At float32 the stem rewritten to space-to-depth, fed
    ``space_to_depth_frames(x)``, gives the unrewritten graph's heads."""
    g = graph_from_jax(GRAPHS[name]())
    s2d = graph_from_jax(GRAPHS[name]())
    assert P.stem_space_to_depth(s2d)
    opts = EngineOptions(precision="fast", quantize_outputs=False)
    plain = _at_f32(Engine(g, opts, device="cpu"))
    eng = _at_f32(Engine(s2d, opts, device="cpu"))
    u8 = np.random.default_rng(4).integers(
        0, 256, (1,) + tuple(g.tensors[g.inputs[0]].shape[1:]),
        dtype=np.uint8)
    ref = plain.run_np((u8.astype(np.int32) - 128).astype(np.int8))
    got = eng.run_np((Y.space_to_depth_frames(u8).astype(np.int32)
                      - 128).astype(np.int8))
    _assert_f32_close(got, ref)


# -- the pipeline -----------------------------------------------------------


def _zoo_s():
    g = zoo.build_yolov5("s", zoo.ZooConfig(in_hw=(128, 128),
                                            w_scale=0.0005))
    for o in g.outputs:   # the detect convs: logits that spread
        prod = next(n for n in g.nodes if o in n.outputs)
        q = g.tensors[prod.inputs[1]].quant
        g.tensors[prod.inputs[1]].quant = type(q)(scale=0.25)
        bias = g.tensors[prod.inputs[2]]
        bias.data = np.zeros_like(bias.data)
    return g


PIPELINES = {
    # (graph, frames [B, H, W, 3])
    "zoo-v5s-128": (_zoo_s, (4, 128, 256, 3)),
    "real-v5n": (_real, (4, 360, 640, 3)),
}


@functools.partial(jax.jit, static_argnums=(1,))
def _jax_post(heads, conf):
    """decode (float heads, no scales) -> NMS, jitted as the bench runs
    it (op by op, JAX compiles each op on first use: 10 s more here)."""
    return JY.nms_batched(*JY.decode_and_parse(heads), conf_thresh=conf,
                          **NMS_KW)


def _jax_dets(fn, g, frames, dtype, conf):
    """The JAX bench's composition on an s2d stem: letterbox -> s2d ->
    quantize -> engine -> decode -> NMS at conf 0.25 and at ``conf``."""
    in_t = g.tensors[g.inputs[0]]
    lb = JY.letterbox_uint8(jnp.asarray(frames),
                            (in_t.shape[1] * 2, in_t.shape[2] * 2))
    x = JY.quantize_input_int8(JY.space_to_depth(lb), dtype=dtype)
    feats = fn({g.inputs[0]: x})
    heads = [jnp.asarray(feats[o]) for o in g.outputs]
    return _jax_post(heads, 0.25), _jax_post(heads, conf)


def _port_dets(eng, frames, conf):
    """The port's pipeline (conf 0.25), and its heads' decode + NMS at
    ``conf``."""
    t = torch.from_numpy(frames)
    dets = Y.build_serving_pipeline(eng)(t)
    in_t = eng.graph.tensors[eng.input_names[0]]
    lb = Y.letterbox_uint8(t, (in_t.shape[1] * 2, in_t.shape[2] * 2))
    heads = eng.forward(Y.quantize_input_int8(Y.space_to_depth(lb),
                                              torch.bfloat16))
    dec = Y.decode_and_parse([heads[o] for o in eng.output_names])
    return dets, Y.nms_batched(*dec, conf_thresh=conf, **NMS_KW)


@pytest.mark.parametrize("name", PIPELINES)
def test_fast_pipeline_detections_match_jax(name):
    """The port's pipeline at float32 and at bf16 against the JAX bench's
    composition at both: f32 detections matched one to one (IoU >= 0.99,
    same class) at ``F32_MATCH_SHARE`` or more; bf16 ones as close to
    JAX's f32 detections as JAX's own bf16 ones, less ``BF16_SLACK``, and
    matched to JAX's bf16 ones at ``BF16_MATCH_SHARE`` or more."""
    make, shape = PIPELINES[name]
    jg, pg, pg32 = make(), graph_from_jax(make()), graph_from_jax(make())
    assert all(f(g) for f, g in ((JP.stem_space_to_depth, jg),
                                 (P.stem_space_to_depth, pg),
                                 (P.stem_space_to_depth, pg32)))
    frames = np.random.default_rng(9).integers(0, 256, shape, dtype=np.uint8)
    opts = dict(precision="fast", quantize_outputs=False)
    jeng = JEngine(jg, JOptions(**opts))
    low = 0.25 if name.startswith("zoo") else 0.001
    j32 = _jax_dets(_jax_f32(jeng), jeng.graph, frames, jnp.float32, low)
    j16 = _jax_dets(jeng.run, jeng.graph, frames, jnp.bfloat16, low)
    p32 = _port_dets(_at_f32(Engine(pg32, EngineOptions(**opts),
                                    device="cpu")), frames, low)
    DK.reset_launches()
    p16 = _port_dets(Engine(pg, EngineOptions(**opts), device="cpu"),
                     frames, low)
    assert DK.launches["decode_and_parse_fused_bf16"] == 0   # CPU: plain
    for k in (0, 1):   # the pipeline at conf 0.25, the heads at ``low``
        f32 = Y.match_share(p32[k], j32[k], iou=0.99)
        ref16 = Y.match_share(j16[k], j32[k])
        got16 = Y.match_share(p16[k], j32[k])
        both16 = Y.match_share(p16[k], j16[k])
        print(f"{name} conf {(0.25, low)[k]}: f32 {f32:.3f}; bf16 vs JAX "
              f"f32 {got16:.3f} (JAX's bf16 {ref16:.3f}); bf16 vs JAX bf16 "
              f"{both16:.3f}")
        assert f32 >= F32_MATCH_SHARE
        assert got16 >= ref16 - BF16_SLACK and both16 >= BF16_MATCH_SHARE
    assert int(p16[1].num.sum()) > 0 and int(p32[1].num.sum()) > 0


def test_pipeline_takes_presized_s2d_frames():
    """Frames already at the s2d graph's input shape (a pre-sized feed in
    ``space_to_depth_frames`` order) skip the letterbox: the detections
    equal those of the same frames in pixel order, letterboxed (the
    identity at the target size) and rearranged on the device."""
    g = graph_from_jax(_zoo_s())
    assert P.stem_space_to_depth(g)
    eng = Engine(g, EngineOptions(precision="fast", quantize_outputs=False),
                 device="cpu")
    frames = np.random.default_rng(2).integers(0, 256, (2, 128, 128, 3),
                                               dtype=np.uint8)
    pipe = Y.build_serving_pipeline(eng)
    a = pipe(torch.from_numpy(frames))
    b = pipe(torch.from_numpy(Y.space_to_depth_frames(frames)))
    for f in ("boxes", "scores", "classes", "valid"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert int(a.num.sum()) > 0


def test_pipeline_reads_the_s2d_mark_not_the_channel_count():
    """The pipeline takes a graph for an s2d stem by the mark
    ``stem_space_to_depth`` leaves (kept through the engine's rewrites),
    not by a 12-channel input: the same graph unmarked, an input of 12
    channels of its own, is fed the letterboxed 3-channel frames as they
    are, which its stem refuses, and is never rearranged."""
    g = graph_from_jax(GRAPHS["zoo-v5n-64"]())
    assert not g.stem_s2d
    assert P.stem_space_to_depth(g) and g.stem_s2d
    opts = EngineOptions(precision="fast", quantize_outputs=False)
    assert Engine(g, opts, device="cpu").graph.stem_s2d
    eng = Engine(dataclasses.replace(g, stem_s2d=False), opts, device="cpu")
    assert not eng.graph.stem_s2d
    frames = torch.zeros((1, 64, 64, 3), dtype=torch.uint8)
    with pytest.raises(RuntimeError, match="channels"):
        Y.build_serving_pipeline(eng)(frames)


def test_fast_tier_raises_on_what_it_does_not_take():
    """Compat mode is the exact tier's. The fast tier lowers every op of
    JAX's ``_lower_node`` (the one op set of ``runtime.executor``), so
    the real yolov5n file loaded whole, which raised here on its SOFTMAX
    before the degenerate guard came first, now builds; an op no tier
    lowers names ROADMAP."""
    g = graph_from_jax(GRAPHS["zoo-v5n-64"]())
    with pytest.raises(ValueError, match="compat"):
        Engine(g, EngineOptions(precision="fast", mode="compat"),
               device="cpu")
    full = graph_from_jax(jax_from_mars(read_mars(REAL_YOLO)))
    Engine(full, EngineOptions(precision="fast"), device="cpu")
    full.nodes[0].op = "WARP"   # the stem conv
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Engine(full, EngineOptions(precision="fast"), device="cpu")


def test_fast_graphs_of_the_card_paths():
    """``trace_path.fast_graph``, the graphs ``chip_smoke.py``'s fast phase
    and ``trace_path --path fast_*`` run: s2d stems at 640, the zoo
    yolov5s's detect biases zeroed, and both taken by the fast engine."""
    from thingino_accel_tpu_torch.trace_path import fast_graph
    for model in ("yolov5n", "yolov5s"):
        g = fast_graph(model)
        assert g.tensors[g.inputs[0]].shape == (1, 320, 320, 12)
        plain = fast_graph(model, s2d=False)
        assert plain.tensors[plain.inputs[0]].shape == (1, 640, 640, 3)
    convs = {o: next(n for n in g.nodes if o in n.outputs)
             for o in g.outputs}
    assert all(not g.tensors[n.inputs[2]].data.any()
               and g.tensors[n.inputs[1]].quant.scale == 0.25
               for n in convs.values())
    eng = Engine(g, EngineOptions(precision="fast", quantize_outputs=False),
                 device="cpu")
    assert all(eng.graph.tensors[o].dtype == np.float32
               for o in eng.output_names)


if __name__ == "__main__":
    # The bf16 heads' gap to JAX's, in bf16 ulps of the largest |head|,
    # per graph and seed (the tests use seed len(name) + 1):
    #   PYTHONPATH=. python tests/test_torch_fast.py [seed ...]
    # "before": the port's bf16 accumulation against JAX's default (the
    # port's only mode before C.9's repair); "default" and "bf16 accum":
    # each against JAX in the same mode.
    import sys
    jax.config.update("jax_platforms", "cpu")
    seeds = [int(a) for a in sys.argv[1:]]
    for name, build in GRAPHS.items():
        g = build()
        j = {acc: JEngine(g, JOptions(precision="fast",
                                      quantize_outputs=False,
                                      accum_dtype=acc))
             for acc in (None, jnp.bfloat16)}
        p = {acc: Engine(graph_from_jax(g), EngineOptions(
            precision="fast", quantize_outputs=False, accum_dtype=acc),
            device="cpu") for acc in (None, torch.bfloat16)}
        for seed in seeds or [len(name) + 1]:
            x = _input(g, seed, batch=1 if name == "real-v5n" else 2)
            jr = {a: {k: np.asarray(v, np.float32)
                      for k, v in e.run(x).items()} for a, e in j.items()}
            pr = {a: {k: v.float().numpy() for k, v in e.run(x).items()}
                  for a, e in p.items()}
            row = {"before": _head_ulps(pr[torch.bfloat16], jr[None]),
                   "default": _head_ulps(pr[None], jr[None]),
                   "bf16 accum": _head_ulps(pr[torch.bfloat16],
                                            jr[jnp.bfloat16])}
            print(name, seed, {k: max(v.values()) for k, v in row.items()},
                  flush=True)
