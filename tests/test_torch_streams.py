"""The camera-stream path, port vs JAX on the same seeded numpy inputs:
NV12 frames -> ``nv12_to_rgb`` -> ``MultiStreamBatcher`` ->
``StreamServer`` (with its drain watchdog) -> the YOLO pipeline, each
row routed back to its camera.

Tolerances:
- ``nv12_to_rgb``: bytes equal to JAX's function as it is called op by
  op (``tests/test_yolo.py`` calls it so) at 720x1280 (four frames) and
  at a small size; neutral chroma (U = V = 128) gives R = G = B = Y.
  (Jitted, XLA contracts the multiply-adds into FMAs and 924 of the
  11,059,200 bytes at 720p differ by 1; the port keeps each product and
  add apart, as JAX's op order writes them.)
- ``normalize_input_f32``: equal.
- The server: mirrors of JAX ``tests/test_serving.py``'s eight cases
  against the port's server on the CPU, with the JAX server beside it
  where both run the same function: results in order and equal, the same
  frames, batches and errors; the watchdog through the instance seam
  ``_materialize``.
- ``MultiStreamBatcher``: batches and ``sources`` equal to JAX's under
  stream exhaustion, at several depths of the pipeline behind it.
- ``serve_file_model``: the same frames, batches and errors as JAX's.
- The streams pipeline end to end: 5 cameras of 96x128 NV12 frames
  (1-3 frames each) through ``MultiStreamBatcher(5, 4)`` and
  ``StreamServer`` into ``build_serving_pipeline`` of the exact tier on
  a zoo yolov5n at 64 (its heads' scale raised to 0.25 so that scores
  pass the threshold): each camera's routed detections against JAX's
  pipeline on that camera's frames (``nv12_to_rgb`` -> letterbox -> int8
  quantize -> the JAX exact engine -> decode -> NMS): valid masks and
  classes equal, boxes within 1e-4 px, scores within 1e-6 relative.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thingino_accel_tpu.models import yolo as JY
from thingino_accel_tpu.models import zoo
from thingino_accel_tpu.runtime import Engine as JEngine
from thingino_accel_tpu.runtime import EngineOptions as JOptions
from thingino_accel_tpu.runtime import serving as JS
from thingino_accel_tpu_torch import runtime as RT
from thingino_accel_tpu_torch.ir.graph import graph_from_jax
from thingino_accel_tpu_torch.models import yolo as Y
from thingino_accel_tpu_torch.models import zoo as PZ
from thingino_accel_tpu_torch.runtime import serving as S
from thingino_accel_tpu_torch.runtime.engine import Engine

NMS_KW = dict(max_dets=100, pre_nms=128, topk_group=8)
TEST_CONV = "models/fixtures/test_conv.mars"


def _nv12(rng, b, h, w):
    return rng.integers(0, 256, (b, h * 3 // 2, w), dtype=np.uint8)


# -- pre-processing -----------------------------------------------------------


@pytest.mark.parametrize("b,h,w", [(4, 720, 1280), (2, 6, 10)],
                         ids=["720p", "small"])
def test_nv12_to_rgb_bytes_equal_jax(b, h, w):
    nv12 = _nv12(np.random.default_rng(0), b, h, w)
    ref = np.asarray(JY.nv12_to_rgb(jnp.asarray(nv12), h, w))
    got = Y.nv12_to_rgb(torch.from_numpy(nv12), h, w)
    assert got.dtype == torch.uint8 and got.shape == (b, h, w, 3)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_nv12_neutral_chroma_is_gray():
    h, w = 4, 6
    nv12 = np.full((2, h * 3 // 2, w), 128, np.uint8)
    nv12[:, :h] = np.random.default_rng(1).integers(0, 256, (2, h, w))
    got = Y.nv12_to_rgb(torch.from_numpy(nv12), h, w).numpy()
    for c in range(3):
        np.testing.assert_array_equal(got[..., c], nv12[:, :h])
    np.testing.assert_array_equal(
        got, np.asarray(JY.nv12_to_rgb(jnp.asarray(nv12), h, w)))


def test_normalize_input_f32_equals_jax():
    u8 = np.arange(256, dtype=np.uint8).reshape(1, 4, 64, 1)
    ref = np.asarray(JY.normalize_input_f32(jnp.asarray(u8)))
    got = Y.normalize_input_f32(torch.from_numpy(u8))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)


# -- the server: mirrors of tests/test_serving.py -------------------------------


def _both(fn_port, fn_jax, batches, depth, **kw):
    """Both servers over ``batches``: (port results, JAX results, port
    server, JAX server)."""
    port = S.StreamServer(fn_port, depth=depth, device="cpu", **kw)
    ref = JS.StreamServer(fn_jax, depth=depth, **kw)
    return list(port.run(iter(batches))), list(ref.run(iter(batches))), \
        port, ref


def _same_stats(port, ref):
    for key in ("frames", "batches", "errors"):
        assert getattr(port.stats, key) == getattr(ref.stats, key), key


def test_stream_server_order_and_stats():
    batches = [np.full((4, 8), i, np.float32) for i in range(7)]
    got, want, port, ref = _both(lambda x: x * 2.0,
                                 jax.jit(lambda x: x * 2.0), batches, 2)
    assert len(got) == len(want) == 7
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), batches[i] * 2.0)
    _same_stats(port, ref)
    assert port.stats.frames == 28 and port.stats.batches == 7
    assert port.stats.fps > 0 and "fps" in port.stats.summary()


def test_stream_server_depth1():
    got, want, port, ref = _both(lambda x: x + 1, jax.jit(lambda x: x + 1),
                                 [np.zeros((2, 2), np.float32)], 1)
    assert len(got) == len(want) == 1
    _same_stats(port, ref)


def test_multi_stream_batcher_interleaves():
    def streams():
        return [iter([np.full((3,), s * 10 + i, np.float32)
                      for i in range(4)]) for s in range(3)]
    port, ref = S.MultiStreamBatcher(3, 4), JS.MultiStreamBatcher(3, 4)
    got, want = list(port.batches(streams())), list(ref.batches(streams()))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert list(port.sources) == list(ref.sources)


def test_serving_engine_with_zoo_model():
    """The JAX test's tiny int8 zoo graph, built by each package's zoo
    (equal: ``tests/test_torch_zoo.py``), through the port's exact engine
    (the JAX ``Engine(g)`` is its exact tier too): 5 batches of 8."""
    g = PZ.build_tiny(PZ.ZooConfig(dtype="int8", in_hw=(32, 32)),
                      in_hw=(32, 32))
    eng = Engine(g, device="cpu")
    g = zoo.build_tiny(zoo.ZooConfig(dtype="int8", in_hw=(32, 32)),
                       in_hw=(32, 32))
    jeng = JEngine(g)
    rng = np.random.default_rng(0)
    batches = [rng.integers(-128, 128, (8, 32, 32, 3), dtype=np.int8)
               for _ in range(5)]
    body, params, in_name = jeng._fn, jeng.params, g.inputs[0]
    got, want, port, ref = _both(
        eng.forward, jax.jit(lambda x: body(params, {in_name: x})),
        batches, 2)
    assert len(got) == 5 and port.stats.frames == 40
    _same_stats(port, ref)
    for g_out, w_out in zip(got, want):
        for k in w_out:
            np.testing.assert_array_equal(g_out[k].numpy(),
                                          np.asarray(w_out[k]))


def test_stream_server_isolates_bad_batch():
    """A malformed batch does not end the stream."""
    w = torch.ones((8, 4))
    batches = [np.ones((2, 8), np.float32), np.ones((2, 5), np.float32),
               np.ones((2, 8), np.float32)]
    got, want, port, ref = _both(
        lambda x: x @ w, jax.jit(lambda x: x @ jnp.ones((8, 4), jnp.float32)),
        batches, 1)
    assert [o is None for o in got] == [o is None for o in want] == [
        False, True, False]
    _same_stats(port, ref)
    assert port.stats.errors == 1 and port.stats.frames == 4


def test_stream_server_isolates_materialization_failure():
    """A batch that fails between dispatch and its drain (the seam raises,
    as an asynchronous device error would) yields None and counts one
    error; the stream goes on."""
    calls = {"n": 0}

    def failing(done):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("device fault")

    port = S.StreamServer(lambda x: x * 2, depth=2, device="cpu")
    port._materialize = failing   # instance seam
    batches = [np.full((2, 8), i, np.float32) for i in range(4)]
    outs = list(port.run(iter(batches)))
    good = [o for o in outs if o is not None]
    assert len(outs) == 4 and len(good) == 3 and outs[1] is None
    assert port.stats.errors == 1 and port.stats.frames == 6
    np.testing.assert_array_equal(good[-1].numpy(), batches[3] * 2)


def test_multistream_batcher_stable_sources():
    """Row sources are ORIGINAL stream ids, stable across stream
    exhaustion, one list a batch in a FIFO; padding rows are -1."""
    def stream(tag, n):
        for i in range(n):
            yield np.full((2, 2), tag * 10 + i, np.int32)

    mb = S.MultiStreamBatcher(num_streams=3, batch=3)
    batches = list(mb.batches([stream(0, 1), stream(1, 3), stream(2, 3)]))
    srcs = list(mb.sources)
    assert len(batches) == len(srcs)
    flat_src = [s for b in srcs for s in b]
    flat_val = [int(r[0, 0]) for b in batches for r in b]
    for sid, val in zip(flat_src, flat_val):
        assert val // 10 == sid if sid >= 0 else val == 0
    real = sorted(v for s, v in zip(flat_src, flat_val) if s >= 0)
    assert real == [0, 10, 11, 12, 20, 21, 22]


def test_stream_server_watchdog_timeout():
    """A wedged device (a wait that never returns) surfaces as
    InferenceTimeout with healthy False instead of hanging the server;
    later batches come back as None. A healthy server with the watchdog
    armed passes results through."""
    srv = S.StreamServer(lambda x: x, depth=1, device="cpu", timeout_s=0.2)
    srv._materialize = lambda done: time.sleep(1.0)   # instance seam
    t0 = time.perf_counter()
    with pytest.raises(S.InferenceTimeout):
        list(srv.run(iter([np.zeros((2, 4), np.float32)])))
    assert time.perf_counter() - t0 < 0.9
    assert not srv.healthy and srv.wedged
    assert srv.stats.errors == 1 and srv.stats.batches == 1
    srv._materialize = staticmethod(lambda done: None)
    outs = list(srv.run(iter([np.ones((2, 4), np.float32)] * 2)))
    assert outs == [None, None] and srv.stats.errors == 3

    srv2 = S.StreamServer(lambda x: x, depth=1, device="cpu", timeout_s=5.0)
    outs = list(srv2.run(iter([np.ones((2, 4), np.float32)])))
    assert srv2.healthy and len(outs) == 1
    np.testing.assert_array_equal(outs[0].numpy(), np.ones((2, 4)))


def test_runtime_exports_the_jax_names():
    assert {"InferenceTimeout", "MultiStreamBatcher", "StreamServer"} <= set(
        RT.__all__)
    assert RT.InferenceTimeout is S.InferenceTimeout


# -- the batcher under exhaustion, behind the server -----------------------------


@pytest.mark.parametrize("lens,batch,depth", [
    ((1, 3, 3), 3, 1), ((2, 3, 4, 2, 3), 4, 2), ((5, 0, 1), 2, 3),
    ((2, 3, 4) * 5 + (2,), 16, 2)])
def test_batcher_routes_rows_as_jax(lens, batch, depth):
    def streams():
        return [iter([np.full((2,), 100 * s + i, np.int32) for i in range(n)])
                for s, n in enumerate(lens)]
    port = S.MultiStreamBatcher(len(lens), batch)
    ref = JS.MultiStreamBatcher(len(lens), batch)
    want = list(ref.batches(streams()))
    server = S.StreamServer(lambda x: x, depth=depth, device="cpu")
    routed = {s: [] for s in range(len(lens))}
    n_out = 0
    for out, w in zip(server.run(port.batches(streams())), want):
        np.testing.assert_array_equal(out.numpy(), w)
        srcs = port.sources.popleft()
        assert srcs == ref.sources.popleft()
        for row, s in zip(out.numpy(), srcs):
            if s >= 0:
                routed[s].append(int(row[0]))
            else:
                assert not row.any()
        n_out += 1
    assert n_out == len(want) and not port.sources
    for s, n in enumerate(lens):
        assert routed[s] == [100 * s + i for i in range(n)]   # in order


def test_serve_file_model_matches_jax():
    rng = np.random.default_rng(2)
    batches = [rng.integers(-128, 128, (2, 64, 64, 3), dtype=np.int8)
               for _ in range(3)]
    got = S.serve_file_model(TEST_CONV, iter(batches), depth=2, device="cpu")
    want = JS.serve_file_model(TEST_CONV, iter(batches), depth=2)
    assert (got.frames, got.batches, got.errors) == (
        want.frames, want.batches, want.errors) == (6, 3, 0)
    assert got.fps > 0
    if not torch.cuda.is_available():   # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            S.serve_file_model(TEST_CONV, iter(batches))


# -- the streams pipeline end to end --------------------------------------------


def test_streams_pipeline_routes_detections_as_jax():
    frame_hw = (96, 128)   # a size whose letterbox bytes equal JAX's
    g = zoo.build_yolov5("n", zoo.ZooConfig(in_hw=(64, 64)))
    for o in g.outputs:
        g.tensors[o].quant = type(g.tensors[o].quant)(scale=0.25)
    eng = Engine(graph_from_jax(g), device="cpu")
    assert eng.options.precision == "exact"
    pipe = Y.build_serving_pipeline(eng)
    h, w = frame_hw

    def fn(nv12):
        return pipe(Y.nv12_to_rgb(nv12, h, w))

    rng = np.random.default_rng(21)
    cams = [_nv12(rng, 1 + i % 3, h, w) for i in range(5)]   # 10 frames
    batcher = S.MultiStreamBatcher(len(cams), 4)
    server = S.StreamServer(fn, depth=2, device="cpu", timeout_s=60.0)
    routed = {i: [] for i in range(len(cams))}
    for dets in server.run(batcher.batches([iter(c) for c in cams])):
        srcs = batcher.sources.popleft()
        for row, s in enumerate(srcs):
            if s >= 0:
                routed[s].append(Y.Detections(
                    dets.boxes[row], dets.scores[row], dets.classes[row],
                    dets.valid[row]))
    assert server.healthy and server.stats.errors == 0
    assert server.stats.frames == 12   # 3 batches of 4, 2 pad rows

    # JAX's pipeline on every camera's frames, one camera after another
    # in one batch (one trace of the engine); each frame is its own
    jeng = JEngine(g, JOptions(precision="exact"))
    scales = [g.tensors[o].quant.scale for o in g.outputs]
    rgb = JY.nv12_to_rgb(jnp.asarray(np.concatenate(cams)), h, w)
    heads = jeng.run(JY.quantize_input_int8(JY.letterbox_uint8(rgb,
                                                               (64, 64))))
    ref = JY.nms_batched(*JY.decode_and_parse(
        [heads[o] for o in g.outputs], scales=scales), **NMS_KW)
    first = np.cumsum([0] + [len(c) for c in cams])
    n_dets = 0
    for i, cam in enumerate(cams):
        assert len(routed[i]) == len(cam)
        for j, d in enumerate(routed[i]):
            f = first[i] + j
            np.testing.assert_array_equal(d.valid.numpy(),
                                          np.asarray(ref.valid[f]))
            np.testing.assert_array_equal(d.classes.numpy(),
                                          np.asarray(ref.classes[f]))
            np.testing.assert_allclose(d.boxes.numpy(),
                                       np.asarray(ref.boxes[f]),
                                       rtol=0, atol=1e-4)
            np.testing.assert_allclose(d.scores.numpy(),
                                       np.asarray(ref.scores[f]),
                                       rtol=1e-6, atol=1e-12)
            n_dets += int(d.valid.sum())
    assert n_dets > 0
