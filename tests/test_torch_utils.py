"""The port's utilities (``thingino_accel_tpu_torch.utils``) against the
JAX package's ``utils``:

- the ``TAT_*`` registry: the variables the port keeps have JAX's names
  and defaults, and each raw environment value parses to JAX's value; an
  unparsable value gives the default; ``describe`` lists them;
- ``EngineOptions.conv_merge`` / ``fpn_split`` left None read
  ``TAT_CONV_MERGE`` / ``TAT_FPN_SPLIT``: under ``TAT_FPN_SPLIT=1`` (JAX's
  alias of ``"upsample"``) and ``TAT_CONV_MERGE=1`` the port's fast engine
  has JAX's graph and params (zoo yolov5n at 64);
- ``get_logger`` takes its level from ``TAT_LOG``;
- the timing harness on the CPU, ``profile_trace``'s trace file, and
  ``compiled_stats``' counted flops of a matmul and a conv.
"""

import json
import logging as stdlib_logging
import os

import numpy as np
import pytest
import torch

from thingino_accel_tpu.models import zoo as JZ
from thingino_accel_tpu.runtime import Engine as JEngine
from thingino_accel_tpu.runtime import EngineOptions as JOptions
from thingino_accel_tpu.utils import config as JC
from thingino_accel_tpu_torch import utils
from thingino_accel_tpu_torch.ir.graph import graph_from_jax
from thingino_accel_tpu_torch.runtime.engine import Engine, EngineOptions
from thingino_accel_tpu_torch.utils import config, timing
from thingino_accel_tpu_torch.utils.logging import get_logger

KEPT = ("TAT_CONV_MERGE", "TAT_FAST_SILU", "TAT_FPN_SPLIT", "TAT_LOG",
        "TAT_S2D_DEEP", "TAT_SERVING_COMPUTE", "TAT_SILU_TANH",
        "TAT_STEM_NOGROW")


def test_registry_names_and_defaults_equal_jax():
    assert sorted(config._REGISTRY) == sorted(KEPT)
    assert set(KEPT) <= set(JC._REGISTRY)
    for name in KEPT:
        assert config._REGISTRY[name][0] == JC._REGISTRY[name][0], name
        assert config.get(name) == JC.get(name), name


@pytest.mark.parametrize("raw", ["1", "0", "true", "off", "junk", "",
                                 " No ", "wide", "all", "upsample", "debug"])
def test_env_values_parse_as_jax(monkeypatch, raw):
    for name in KEPT:
        monkeypatch.setenv(name, raw)
        assert config.get(name) == JC.get(name), (name, raw)


def test_unparsable_value_gives_the_default(monkeypatch):
    monkeypatch.setitem(config._REGISTRY, "TAT_TEST_ITERS",
                        (10, int, "a test variable"))
    monkeypatch.setenv("TAT_TEST_ITERS", "25")
    assert config.get("TAT_TEST_ITERS") == 25
    monkeypatch.setenv("TAT_TEST_ITERS", "junk")
    assert config.get("TAT_TEST_ITERS") == 10
    monkeypatch.setenv("TAT_CONV_MERGE", "yes")
    text = config.describe()
    assert all(name in text for name in KEPT)
    assert " * TAT_CONV_MERGE" in text and "   TAT_LOG" in text


@pytest.fixture(scope="module")
def v5n():
    return JZ.build_yolov5("n", JZ.ZooConfig(in_hw=(64, 64)))


def _same(port, ref):
    pg, jg = port.graph, ref.graph
    assert [(n.op, n.name, n.inputs, n.outputs, n.attrs) for n in pg.nodes
            ] == [(n.op, n.name, list(n.inputs), list(n.outputs),
                   dict(n.attrs)) for n in jg.nodes]
    assert list(port._np_params) == list(ref._np_params)
    for k, v in ref._np_params.items():
        np.testing.assert_array_equal(port._np_params[k], v, k)


@pytest.mark.parametrize("env", [{"TAT_FPN_SPLIT": "1"},
                                 {"TAT_FPN_SPLIT": ""},
                                 {"TAT_CONV_MERGE": "1",
                                  "TAT_FPN_SPLIT": "all"}])
def test_fast_engine_reads_the_environment_as_jax(monkeypatch, v5n, env):
    """The defaults (None) read the environment; the graph and params
    equal JAX's fast engine's under the same environment, and an explicit
    option wins over it."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    port = Engine(graph_from_jax(v5n), EngineOptions(precision="fast"),
                  device="cpu")
    ref = JEngine(v5n, JOptions(precision="fast"))
    _same(port, ref)
    plain = Engine(graph_from_jax(v5n), EngineOptions(
        precision="fast", fpn_split="", conv_merge=False), device="cpu")
    ref = JEngine(v5n, JOptions(precision="fast", fpn_split="",
                                conv_merge=False))
    _same(plain, ref)
    if env.get("TAT_FPN_SPLIT") == "1":
        ups = Engine(graph_from_jax(v5n), EngineOptions(
            precision="fast", fpn_split="upsample"), device="cpu")
        _same(port, JEngine(v5n, JOptions(precision="fast",
                                          fpn_split="upsample")))
        assert len(ups.graph.nodes) == len(port.graph.nodes)
        assert len(port.graph.nodes) != len(plain.graph.nodes)


@pytest.mark.parametrize("level", ["debug", "info", "warn", "error",
                                   "junk"])
def test_logger_level_from_tat_log(monkeypatch, level):
    monkeypatch.setenv("TAT_LOG", level)
    log = get_logger(f"tat_test_{level}")
    want = {"debug": stdlib_logging.DEBUG, "info": stdlib_logging.INFO,
            "error": stdlib_logging.ERROR}.get(level, stdlib_logging.WARNING)
    assert log.level == want and not log.propagate
    assert get_logger(f"tat_test_{level}") is log
    assert len(log.handlers) == 1


def test_timing_harness_on_the_cpu():
    x = torch.ones((128, 128))
    f = lambda a: a * 2.0
    assert timing.time_fn(f, x, iters=3, warmup=1) > 0
    assert timing.time_fn_chained(f, x, iters=3) > 0
    assert timing.throughput(8, 0.01) == 800.0
    assert timing.throughput(8, 0.0) == 0.0
    with pytest.raises(ValueError):
        timing.time_fn(f, x, iters=0)
    assert utils.time_fn is timing.time_fn
    assert "enable_compile_cache" not in utils.__all__


def test_profile_trace_writes_its_trace(tmp_path):
    logdir = str(tmp_path / "prof")
    with timing.profile_trace(logdir) as d:
        assert d == logdir
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.load(open(os.path.join(logdir, "trace.json")))
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])


def test_compiled_stats_counts_products():
    a, b = torch.ones((64, 32)), torch.ones((32, 16))
    s = timing.compiled_stats(lambda x, y: x @ y + 1.0, a, b)
    assert s["flops"] == 2 * 64 * 32 * 16
    assert set(s) == {"flops"}
    x, w = torch.ones((1, 3, 8, 8)), torch.ones((4, 3, 3, 3))
    s = timing.compiled_stats(torch.nn.functional.conv2d, x, w)
    assert s["flops"] == 2 * 4 * 6 * 6 * 3 * 3 * 3
