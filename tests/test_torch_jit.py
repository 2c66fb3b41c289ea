"""``runtime.jit``, the port's ``jax.jit``, and the sync-free NMS.

On the CPU a jitted call runs eagerly, so these tests hold what the CUDA
graph replays against the JAX package, and check the properties a graph
needs that the CPU can show:

- ``EngineOptions().jit`` is True, as JAX's is.
- ``Engine(..., device="cpu")`` with ``jit`` True and False, on three
  seeded batches of the zoo yolov5n at 64x64, equals JAX's jitted
  ``Engine`` on the same graph and batches: the planned serving and the
  exact tier bit for bit; the fast tier's float32 heads (its executor at
  float32 on both sides, as ``tests/test_torch_fast.py`` runs it) within
  rtol 1e-4, atol 1e-4 x the largest |head|.
- No host read in a graph body: after one warm-up call, the body runs
  again with ``Tensor.item``, ``__bool__``, ``__int__``, ``__float__``,
  ``tolist``, ``numpy``, ``torch.equal``, ``torch.from_numpy`` and
  ``torch.tensor`` made to raise. A CUDA graph can hold no host read (a
  sync) and no pageable host-to-device copy. The bodies: the serving
  pipeline of each tier (letterbox through a resize by taps and by
  strided windows -> quantize -> forward -> decode -> the NMS kernel's
  input, ``up``), the e2e `.mars` pipeline (its last step
  ``scale_boxes_to_original``), the int8 ops graph in every tier (CLIP,
  the pools, the divisions), the recurrent graph, and the AEC model's
  forward, its scanner's vmapped step and ``AECStream``'s forward.
- The NMS fixpoint's plain version, through ``nms_batched``, equals JAX's
  ``nms_batched`` bit for bit on ``models.nms_fixtures.seeded_sets`` at K
  = 128 and 256 (a random pool, a suppression chain of depth K, an empty
  pool, frames that converge at different steps), and a greedy loop in
  numpy on the same relations.
- The pytree walk of ``runtime.jit`` round-trips the calls' structures,
  and a call on CPU tensors never captures.

The ``gpu``-marked cases (skipped without a card) replay on the card:
results stay intact across later replays (``StreamServer`` at depth 2),
jitted equals eager bit for bit, and a replay counts the launches an
eager call counts. This file imports JAX only inside the CPU tests, so
those cases also run where JAX is absent::

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_jit.py
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from thingino_accel_tpu_torch.models import aec
from thingino_accel_tpu_torch.models import nms_fixtures as NF
from thingino_accel_tpu_torch.models import ops_graphs as OG
from thingino_accel_tpu_torch.models import yolo as Y
from thingino_accel_tpu_torch.models import zoo as PZ
from thingino_accel_tpu_torch.ops import nms_kernel as NK
from thingino_accel_tpu_torch.runtime import jit as J
from thingino_accel_tpu_torch.runtime.engine import Engine, EngineOptions

BATCHES = 3
CONF, IOU = 0.25, 0.45


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card (see the module "
                    "docstring)")
    return torch.device("cuda")


def _zoo_graph(w_scale=0.01, ir=None):
    cfg = dict(in_hw=(64, 64), w_scale=w_scale)
    if ir is None:
        return PZ.build_yolov5("n", PZ.ZooConfig(**cfg))
    return ir.build_yolov5("n", ir.ZooConfig(**cfg))


def _batches(shape=(2, 64, 64, 3)):
    return [np.random.default_rng(s).integers(-128, 128, shape,
                                              dtype=np.int8)
            for s in range(BATCHES)]


# ---------------------------------------------------------------------------
# Engine(jit) against JAX's jitted engine
# ---------------------------------------------------------------------------


def test_jit_is_on_by_default_as_in_jax():
    from thingino_accel_tpu.runtime import EngineOptions as JOptions
    assert EngineOptions().jit is True and JOptions().jit is True


@functools.lru_cache(maxsize=None)
def _jax_heads(tier):
    """JAX's jitted engine on the zoo yolov5n at 64 (the fast tier's
    executor at float32, jitted), one dict of numpy heads a batch."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from thingino_accel_tpu.models import zoo
    from thingino_accel_tpu.runtime import Engine as JEngine
    from thingino_accel_tpu.runtime import EngineOptions as JOptions
    from thingino_accel_tpu.runtime.executor import (
        ExecOptions, build_executor,
    )
    if tier == "fast":
        g = _zoo_graph(0.0005, zoo)
        jeng = JEngine(g, JOptions(precision="fast", quantize_outputs=False))
        fn = jax.jit(build_executor(jeng.graph,
                                    ExecOptions(compute_dtype=jnp.float32)))
        outs = [{k: np.asarray(v) for k, v in fn(
            jeng.params, {jeng.graph.inputs[0]: x}).items()}
            for x in _batches()]
        return g, outs
    g = _zoo_graph(ir=zoo)
    with pltpu.force_tpu_interpret_mode():
        jeng = JEngine(g, JOptions(precision=tier))
        assert jeng.options.jit
        outs = [{k: np.asarray(v) for k, v in jeng.run(x).items()}
                for x in _batches()]
    return g, outs


@pytest.mark.parametrize("jit", [True, False])
@pytest.mark.parametrize("tier", ["serving", "exact", "fast"])
def test_engine_jit_equals_jax_jitted_engine(tier, jit):
    from thingino_accel_tpu_torch.ir.graph import graph_from_jax
    from thingino_accel_tpu_torch.runtime.executor import build_executor
    g, refs = _jax_heads(tier)
    opts = (EngineOptions(precision="fast", quantize_outputs=False, jit=jit)
            if tier == "fast" else EngineOptions(precision=tier, jit=jit))
    eng = Engine(graph_from_jax(g), opts, device="cpu")
    assert isinstance(eng._run, J.Jitted) == jit
    if tier == "fast":   # the executor at float32, read at each call
        eng._fn = build_executor(eng.graph, "cpu", precision="fast")
        eng.params = eng._fn.device_params(eng._np_params)
    for x, ref in zip(_batches(), refs):
        got = eng.run(x)
        fwd = eng.forward(torch.from_numpy(x))
        assert set(got) == set(ref) == set(fwd)
        for k in ref:
            assert torch.equal(got[k], fwd[k]), k
            if tier == "fast":
                np.testing.assert_allclose(
                    got[k].numpy(), ref[k], rtol=1e-4,
                    atol=1e-4 * np.abs(ref[k]).max(), err_msg=k)
            else:
                np.testing.assert_array_equal(got[k].numpy(), ref[k],
                                              err_msg=k)
    if jit:
        assert eng._run.graphs == 0   # the CPU captures nothing


# ---------------------------------------------------------------------------
# No host read in a graph body
# ---------------------------------------------------------------------------

HOST_READS = ("item", "__bool__", "__int__", "__float__", "tolist",
              "numpy")
HOST_COPIES = ("equal", "from_numpy", "tensor")


def _no_host_reads(monkeypatch):
    """Make every host read and host-made tensor raise until the test
    ends."""
    def refuse(name):
        def call(*args, **kwargs):
            raise AssertionError(f"a graph body called {name}")
        return call
    for name in HOST_READS:
        monkeypatch.setattr(torch.Tensor, name, refuse(f"Tensor.{name}"))
    for name in HOST_COPIES:
        monkeypatch.setattr(torch, name, refuse(f"torch.{name}"))


def _frames(hw):
    return lambda seed: torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, (2,) + hw + (3,), dtype=np.uint8))


def _ops_body(graph, tier):
    kw, planned = OG.TIERS[tier]
    eng = Engine(OG.for_tier(graph, tier), EngineOptions(**kw),
                 device="cpu", planned=planned)
    shape = graph.tensors[graph.inputs[0]].shape
    dt = graph.tensors[graph.inputs[0]].dtype

    def make(seed):
        rng = np.random.default_rng(seed)
        if dt == np.int8:
            return torch.from_numpy(rng.integers(-128, 128, shape,
                                                 dtype=np.int8))
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    return eng.forward, make


def _aec_graph(tmp_path):
    from thingino_accel_tpu_torch.formats import mgk
    from thingino_accel_tpu_torch.models import mgk_fixtures as MF
    path = tmp_path / "aec.mgk"
    path.write_bytes(MF.build_aec_mgk(0))
    return mgk.import_mgk(str(path), streaming=True)


def _body(name, tmp_path):
    """(the jitted callable's body, inputs from a seed) of a case."""
    if name.startswith("pipeline"):
        tier = name.split("_")[1]
        opts = (EngineOptions(precision="fast", quantize_outputs=False)
                if tier == "fast" else EngineOptions(precision=tier))
        graph = _zoo_graph(0.0005 if tier == "fast" else 0.01)
        pipe = Y.build_serving_pipeline(Engine(graph, opts, device="cpu"))
        hw = (48, 80) if name.endswith("taps") else (128, 128)
        return pipe.fn, _frames(hw)
    if name == "e2e_pipeline":
        pipe = Y.build_e2e_mars_pipeline(
            Engine(PZ.with_predictions(_zoo_graph()), device="cpu"), (96, 128))
        return pipe.fn, _frames((96, 128))
    if name.startswith("ops_"):
        return _ops_body(OG.int8_ops_graph(2, 16, 16, 16), name[4:])
    if name == "recurrent":
        return _ops_body(OG.recurrent_graph(2, 8, 16, 4, 8), "exact")
    if name == "aec_model":
        model = aec.AECModel(aec.AECConfig(),
                             aec.init_params(aec.AECConfig(), "cpu"))
        state = aec.init_state(aec.AECConfig(), 1, "cpu")
        return (lambda x: model._fwd(x, state), lambda seed: torch.from_numpy(
            np.abs(np.random.default_rng(seed).normal(
                size=(1, 256, 8, 1))).astype(np.float32)))
    g = _aec_graph(tmp_path)
    wins = lambda seed: torch.from_numpy(np.abs(   # noqa: E731
        np.random.default_rng(seed).normal(size=(1, 2, 1, 256, 8))).astype(
        np.float32))
    if name == "aec_scanner":
        run = aec.make_stream_scanner(g, "cpu")
        h0 = torch.zeros((2, 1, 64, 32))
        return (lambda w: run(h0, w)), wins
    stream = aec.AECStream(g, "cpu")
    state = stream.init_state()
    return (lambda w: stream.engine._run(
        {stream._in: w[0, 0], stream._h_in: state})), wins


GUARDED = ("pipeline_serving_taps", "pipeline_serving_windows",
           "pipeline_exact_taps", "pipeline_fast_windows", "e2e_pipeline",
           "ops_serving", "ops_unplanned", "ops_exact", "ops_compat",
           "ops_fast", "recurrent", "aec_model", "aec_scanner", "aec_stream")


@pytest.mark.parametrize("name", GUARDED)
def test_graph_body_reads_nothing_back_to_the_host(name, tmp_path,
                                                   monkeypatch):
    ups = []

    def kernel_input(up):   # the NMS kernel takes up; nothing of it runs
        ups.append(up)
        return up[:, 0, :] | True
    monkeypatch.setattr(Y, "nms_fixpoint", kernel_input)
    fn, make = _body(name, tmp_path)
    want = fn(make(0))   # the warm-up builds what the body keeps
    x = make(1)
    _no_host_reads(monkeypatch)
    got = fn(x)
    monkeypatch.undo()
    assert type(got) is type(want)
    if name.startswith("pipeline") or name == "e2e_pipeline":
        k = 128 if name.startswith("pipeline") else 252   # N, under 256
        assert [tuple(u.shape) for u in ups] == [(2, k, k)] * 2


# ---------------------------------------------------------------------------
# The NMS fixpoint against JAX's
# ---------------------------------------------------------------------------


def _greedy(up: np.ndarray) -> np.ndarray:
    """keep[j] = no kept i < j suppresses j, frame by frame in order."""
    keep = np.zeros(up.shape[:2], bool)
    for f in range(up.shape[0]):
        for j in range(up.shape[1]):
            keep[f, j] = not (up[f, :j, j] & keep[f, :j]).any()
    return keep


@pytest.mark.parametrize("name", NF.NAMES)
@pytest.mark.parametrize("k", [128, 256])
def test_nms_fixpoint_equals_jax(k, name):
    import jax.numpy as jnp
    from thingino_accel_tpu.models import yolo as JY
    boxes, scores, classes = NF.seeded_sets(k)[name]
    kw = dict(conf_thresh=CONF, iou_thresh=IOU, max_dets=100, pre_nms=k,
              topk_group=8)
    ref = JY.nms_batched(jnp.asarray(boxes), jnp.asarray(scores),
                         jnp.asarray(classes), **kw)
    got = Y.nms_batched(torch.from_numpy(boxes), torch.from_numpy(scores),
                        torch.from_numpy(classes), **kw)
    for f in dataclasses.fields(Y.Detections):
        np.testing.assert_array_equal(getattr(got, f.name).numpy(),
                                      np.asarray(getattr(ref, f.name)),
                                      err_msg=f.name)
    up = Y.suppression_pool(torch.from_numpy(boxes),
                            torch.from_numpy(scores),
                            torch.from_numpy(classes), **kw)[3]
    assert tuple(up.shape) == (16, k, k)
    keep = NK.nms_fixpoint(up)
    np.testing.assert_array_equal(keep.numpy(), _greedy(up.numpy()))
    if name == "chain":   # keep alternates along the chain
        assert keep[:, ::2].all() and not keep[:, 1::2].any()
    if name == "empty":
        assert not up.any() and keep.all() and not got.valid.any()


def test_nms_kernel_wrapper_refuses_what_it_cannot_take():
    with pytest.raises(ValueError, match="bool"):
        NK.nms_fixpoint(torch.zeros((1, 4, 4), dtype=torch.uint8))
    with pytest.raises(ValueError, match="bool"):
        NK.nms_fixpoint(torch.zeros((1, 4, 5), dtype=torch.bool))


# ---------------------------------------------------------------------------
# The jit wrapper itself
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Pair:
    a: torch.Tensor
    tag: str


def test_pytree_walk_round_trips():
    t = [torch.zeros(2), torch.ones(3), torch.arange(4)]
    obj = ({"x": t[0], "y": (t[1], 3, None)}, [_Pair(t[2], "p")],
           Y.Detections(*[torch.zeros(1)] * 4), torch.Size([2, 3]))
    leaves = []
    tree = J._flatten(obj, leaves)
    assert len(leaves) == 7 and leaves[:3] == t
    back = J._unflatten(tree, iter(leaves))
    assert back[0]["y"][1:] == (3, None) and back[1][0].tag == "p"
    assert back[3] == (2, 3)
    assert back[1][0].a is t[2] and isinstance(back[2], Y.Detections)
    hash(tree)
    with pytest.raises(TypeError, match="neither a tensor nor hashable"):
        J._flatten((np.zeros(2),), [])


def test_a_cpu_call_runs_eagerly_every_time():
    calls = []

    def fn(x, scale):
        calls.append(x)
        return {"y": x * scale}

    f = J.jit(fn)
    x = torch.arange(4.0)
    for _ in range(3):
        assert torch.equal(f(x, 2.0)["y"], x * 2.0)
    assert len(calls) == 3 and f.graphs == 0


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_replayed_results_stay_intact_at_depth_2(cuda):
    """A jitted pipeline served at depth 2: each batch's detections equal
    the same batch run alone, eagerly, after later batches replayed."""
    from thingino_accel_tpu_torch.runtime.serving import StreamServer
    eng = Engine(_zoo_graph(), EngineOptions(precision="serving"),
                 device=cuda)
    pipe = Y.build_serving_pipeline(eng)
    frames = [np.random.default_rng(s).integers(
        0, 256, (4, 96, 128, 3), dtype=np.uint8) for s in range(5)]
    server = StreamServer(pipe, depth=2, device=cuda)
    outs = list(server.run(frames))
    assert pipe.graphs == 1 and server.stats.errors == 0
    for out, f in zip(outs, frames):
        ref = pipe.fn(torch.from_numpy(f).to(cuda))
        for fld in dataclasses.fields(Y.Detections):
            assert torch.equal(getattr(out, fld.name),
                               getattr(ref, fld.name)), fld.name


@pytest.mark.gpu
@pytest.mark.parametrize("tier", ["serving", "exact", "fast"])
def test_jit_equals_eager_on_the_card(cuda, tier):
    """Three batches through a jitted and an eager engine: heads equal bit
    for bit, the first batch's unchanged after the later replays, and the
    launch counters moved as much by the replays as by the eager calls."""
    opts = (dict(precision="fast", quantize_outputs=False)
            if tier == "fast" else dict(precision=tier))
    graph = _zoo_graph(0.0005 if tier == "fast" else 0.01)
    jitted = Engine(graph, EngineOptions(**opts), device=cuda)
    eager = Engine(graph, EngineOptions(**opts, jit=False), device=cuda)
    xs = [torch.from_numpy(x).to(cuda) for x in _batches((8, 64, 64, 3))]
    counts, outs = [], {}
    for eng in (eager, jitted):
        before = [dict(c) for c in J.counters()]
        outs[eng] = [eng.run(x) for x in xs]
        counts.append([{k: c[k] - b[k] for k in c}
                       for c, b in zip(J.counters(), before)])
    assert jitted._run.graphs == 1
    assert counts[0] == counts[1]
    # every result read after the last replay: a replay's result that the
    # next replay overwrote would hold the next batch's heads
    for got, want in zip(outs[jitted], outs[eager]):
        for k in want:
            assert torch.equal(got[k], want[k]), k
