"""The port's checkpoints (``thingino_accel_tpu_torch.runtime.checkpoint``)
against the JAX package's ``runtime/checkpoint.py`` on its npz branch
(JAX takes orbax where it imports; the tests that call JAX's ``save``
block ``orbax.checkpoint`` in ``sys.modules`` for the call, so JAX writes
npz, and nothing in JAX changes):

- a round trip of a nested tree (tensors, numpy arrays, a scalar) with
  its step and extra, flat and with ``like``;
- a port npz loads in JAX's ``checkpoint.load`` to equal arrays, flat and
  nested, and a JAX npz in the port's; a params checkpoint crosses with
  ``params_to_jax`` / ``params_from_jax`` (the conv layouts);
- the training state: params and ``torch.optim.Adam``'s state saved at
  step 3 of 6, loaded into fresh params and a fresh optimizer
  (``optimizer_like``), give the uninterrupted run's params and state
  bit for bit on the CPU;
- an orbax checkpoint raises ``ValueError`` naming its backend.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thingino_accel_tpu.models import zoo as JZ
from thingino_accel_tpu.runtime import Engine as JEngine
from thingino_accel_tpu.runtime import checkpoint as JC
from thingino_accel_tpu_torch.ir.graph import graph_from_jax
from thingino_accel_tpu_torch.runtime import checkpoint as C
from thingino_accel_tpu_torch.runtime.engine import Engine
from thingino_accel_tpu_torch.runtime.executor import (
    params_from_jax, params_to_jax,
)
from thingino_accel_tpu_torch.training import qat as Q


@pytest.fixture
def jax_npz(monkeypatch):
    """JAX's ``save`` on its npz branch (``import orbax.checkpoint``
    raises ImportError while ``sys.modules`` holds None for it)."""
    monkeypatch.setitem(__import__("sys").modules, "orbax.checkpoint", None)


def _tree():
    rng = np.random.default_rng(0)
    return {"conv": {"w": torch.from_numpy(rng.normal(size=(8, 3, 3, 4))
                                           .astype(np.float32)),
                     "b": torch.zeros(8)},
            "table": rng.integers(-128, 128, (16,)).astype(np.int8),
            "scale": 0.5, "layers": [torch.ones(2), torch.arange(3)]}


def test_roundtrip(tmp_path):
    tree = _tree()
    path = str(tmp_path / "sub" / "ckpt")
    C.save(path, tree, extra={"note": "test"}, step=7)
    meta = json.load(open(path + ".meta.json"))
    assert meta == {"step": 7, "backend": "npz", "extra": {"note": "test"}}
    flat, meta = C.load(path)
    assert meta["step"] == 7 and meta["extra"]["note"] == "test"
    assert sorted(flat) == ["conv/b", "conv/w", "layers/0", "layers/1",
                            "scale", "table"]
    got, _ = C.load(path, like=tree)
    assert isinstance(got["scale"], float) and got["scale"] == 0.5
    assert isinstance(got["layers"], list)
    for a, b in ((got["conv"]["w"], tree["conv"]["w"]),
                 (got["conv"]["b"], tree["conv"]["b"]),
                 (got["layers"][1], tree["layers"][1])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got["table"].dtype == np.int8
    np.testing.assert_array_equal(got["table"], tree["table"])


def test_port_checkpoint_loads_in_jax_and_back(tmp_path, jax_npz):
    """Both directions, flat and nested: equal arrays, equal meta."""
    tree = _tree()
    path = str(tmp_path / "port")
    C.save(path, tree, extra={"by": "port"}, step=2)
    jflat, jmeta = JC.load(path)
    pflat, pmeta = C.load(path)
    assert jmeta == pmeta and sorted(jflat) == sorted(pflat)
    for k in pflat:
        np.testing.assert_array_equal(jflat[k], pflat[k], k)
    jlike = {"conv": {"w": np.zeros((8, 3, 3, 4), np.float32),
                      "b": np.zeros(8, np.float32)},
             "table": np.zeros(16, np.int8), "scale": np.float32(0),
             "layers": [np.zeros(2, np.float32), np.zeros(3, np.int64)]}
    jtree, _ = JC.load(path, like=jlike)
    np.testing.assert_array_equal(np.asarray(jtree["conv"]["w"]),
                                  tree["conv"]["w"].numpy())
    np.testing.assert_array_equal(np.asarray(jtree["layers"][1]),
                                  tree["layers"][1].numpy())

    path = str(tmp_path / "jax")
    JC.save(path, jlike | {"conv": {"w": tree["conv"]["w"].numpy(),
                                     "b": np.ones(8, np.float32)}},
            extra={"by": "jax"}, step=5)
    assert json.load(open(path + ".meta.json"))["backend"] == "npz"
    got, meta = C.load(path, like=tree)
    assert meta["step"] == 5 and meta["extra"] == {"by": "jax"}
    assert torch.equal(got["conv"]["w"], tree["conv"]["w"])
    assert torch.equal(got["conv"]["b"], torch.ones(8))


def test_params_checkpoint_crosses_with_the_layouts(tmp_path, jax_npz):
    """The tiny float convnet's params: the port's, saved in JAX's layout
    (``params_to_jax``), load in JAX to its engine's params; JAX's saved
    params load in the port to its engine's (``params_from_jax``)."""
    g = JZ.build_tiny(JZ.ZooConfig(dtype="float32", in_hw=(16, 16)))
    je = JEngine(g)
    pe = Engine(graph_from_jax(g), device="cpu")
    cw = pe._fn.conv_weights
    path = str(tmp_path / "p")
    C.save(path, params_to_jax(pe.params, cw))
    got, _ = JC.load(path, like=dict(je._np_params))
    for k, v in je._np_params.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v, k)
    JC.save(path, {k: jnp.asarray(v) for k, v in je._np_params.items()})
    flat, _ = C.load(path)
    back = params_from_jax(flat, "cpu", cw)
    for k, v in pe.params.items():
        assert torch.equal(back[k], v), k


def _run(params, opt, step, feeds, tgts, steps):
    for i in steps:
        step(params, feeds[i % 2], tgts[i % 2])


def test_resume_equals_the_uninterrupted_run(tmp_path):
    """QAT on the tiny convnet with Adam: 6 steps straight against 3
    steps, a checkpoint of params and optimizer state, a fresh start from
    it and 3 more steps: params and optimizer state bit for bit."""
    g = graph_from_jax(JZ.build_tiny(JZ.ZooConfig(dtype="float32",
                                                  in_hw=(16, 16))))
    eng = Engine(g, device="cpu")
    rng = np.random.default_rng(1)
    feeds = [{g.inputs[0]: torch.from_numpy(rng.normal(
        scale=1.2, size=(2, 16, 16, 3)).astype(np.float32))}
        for _ in range(2)]
    tgts = [{k: v.detach() * 0.9 for k, v in eng._fn(eng.params, f).items()}
            for f in feeds]

    def fresh():
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in eng.params.items()}
        opt = torch.optim.Adam(params.values(), lr=1e-3)
        return params, opt, Q.make_train_step(eng._fn, opt, qat=True,
                                              channel_axis=-1)

    straight, sopt, sstep = fresh()
    _run(straight, sopt, sstep, feeds, tgts, range(6))

    params, opt, step = fresh()
    _run(params, opt, step, feeds, tgts, range(3))
    path = str(tmp_path / "train")
    C.save(path, {"params": params, "opt": opt.state_dict()}, step=3)

    params, opt, step = fresh()
    like = {"params": params, "opt": C.optimizer_like(opt)}
    state, meta = C.load(path, like=like)
    assert meta["step"] == 3
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(state["params"][k])
    opt.load_state_dict(state["opt"])
    _run(params, opt, step, feeds, tgts, range(3, 6))
    for k, p in straight.items():
        assert torch.equal(params[k], p), k
    for a, b in zip(C._leaves(opt.state_dict()),
                    C._leaves(sopt.state_dict())):
        assert a[0] == b[0]
        va, vb = a[1], b[1]
        assert (torch.equal(va, vb) if isinstance(va, torch.Tensor)
                else va == vb), a[0]


def test_optimizer_like_leaves_the_params_as_they_were():
    params = {"w": torch.randn(3, 3, requires_grad=True)}
    before = params["w"].detach().clone()
    opt = torch.optim.Adam(params.values(), lr=0.1, weight_decay=0.5)
    like = C.optimizer_like(opt)
    assert set(like["state"][0]) >= {"step", "exp_avg", "exp_avg_sq"}
    assert torch.equal(params["w"], before) and params["w"].grad is None


def test_orbax_checkpoint_raises(tmp_path):
    path = str(tmp_path / "o")
    json.dump({"step": 0, "backend": "orbax", "extra": {}},
              open(path + ".meta.json", "w"))
    with pytest.raises(ValueError, match="orbax"):
        C.load(path)
