"""The port's StreamServer keeps the JAX server's semantics: results in
submission order, at most ``depth`` batches in flight, a failed batch
yields None and counts in ``stats.errors`` without ending the stream."""

import numpy as np
import pytest
import torch

from thingino_accel_tpu.runtime.serving import StreamServer as JStreamServer
from thingino_accel_tpu_torch.runtime.serving import StreamServer


def _batches(n=5, bsz=3):
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, (bsz, 4, 4, 3), dtype=np.uint8)
            for _ in range(n)]


def _fn(fail_on):
    def fn(x):
        if int(x[0, 0, 0, 0]) == fail_on:
            raise ValueError("bad batch")
        return x.sum()
    return fn


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_stream_server_matches_jax_semantics(depth):
    batches = _batches()
    bad = int(batches[2][0, 0, 0, 0])
    port = StreamServer(_fn(bad), depth=depth, device="cpu")
    ref = JStreamServer(_fn(bad), depth=depth)
    got = list(port.run(batches))
    want = list(ref.run(batches))
    assert [g is None for g in got] == [w is None for w in want] == [
        False, False, True, False, False]
    for g, w in zip(got, want):
        if g is not None:
            assert int(g) == int(np.asarray(w))
    for key in ("frames", "batches", "errors"):
        assert getattr(port.stats, key) == getattr(ref.stats, key), key
    assert len(port.stats.batch_latencies_s) == 4
    assert port.stats.fps > 0 and port.stats.latency_ms(99) >= \
        port.stats.latency_ms(50) > 0


def test_stream_server_rejects_depth_zero():
    with pytest.raises(ValueError):
        StreamServer(lambda x: x, depth=0, device="cpu")
