"""The port's quantization-aware training (``thingino_accel_tpu_torch.
training.qat`` on ``torch.autograd``) against the JAX package's
``training/qat.py`` (optax, ``jax.value_and_grad``), on JAX's tiny float
convnet with the outliers of ``tests/test_qat.py`` (three 3x3 convs,
16x16 input), handed over by ``graph_from_jax``; inputs from seeded
numpy:

- ``fake_quant``: the value bit for bit (scalar and per-channel scales,
  ties included) and the gradient the identity, as JAX's, the executor's
  FAKE_QUANT node the same function;
- ``weight_scale`` and ``fake_quant_params``, per tensor and per channel
  (JAX's ``channel_axis=-1``), and ``export_int8``: JAX's arrays bit for
  bit once the port's params go through ``params_to_jax``; the per
  channel scales follow a conv weight's output axis, which a blind ``-1``
  on the port's OHWI weight would miss;
- the observed graph (``insert_activation_fake_quant``): JAX's node
  list, names and scales, and its forward against JAX's (observers can
  round a 1-ulp difference upstream the other way at a tie:
  ``OBS_MAX_FRAC`` of the values may be one quantum apart, the rest
  within ``FWD_RTOL`` of the largest output);
- one train step's loss within ``LOSS_RTOL`` and its gradients within
  ``GRAD_RTOL`` of each tensor's largest |gradient| of JAX's
  ``jax.value_and_grad`` of the same loss (float32 sums in another
  order);
- three Adam steps against ``optax.adam``: params within ``2·lr·k``
  absolute after k steps (a gradient near 0 of the other sign flips an
  update by up to 2·lr);
- the 60-step loss decrease of ``tests/test_qat.py``, on the port alone;
- a param the loss does not reach gets JAX's zero gradient, and Adam
  keeps state for it (as optax does), so that a checkpoint's optimizer
  state has every param;
- trained params written back into a graph (``graph_with_params``) give
  ``prepare_params`` back, conv and depthwise weights in their OIHW.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from thingino_accel_tpu.ir.graph import Graph as JGraph
from thingino_accel_tpu.ir.graph import Node as JNode
from thingino_accel_tpu.ir.graph import TensorInfo as JTensorInfo
from thingino_accel_tpu.models import zoo as JZ
from thingino_accel_tpu.runtime import Engine as JEngine
from thingino_accel_tpu.training import ptq as JP
from thingino_accel_tpu.training import qat as JQ
from thingino_accel_tpu_torch.ir.graph import graph_from_jax
from thingino_accel_tpu_torch.runtime.engine import Engine
from thingino_accel_tpu_torch.runtime.executor import (
    graph_with_params, params_to_jax, prepare_params,
)
from thingino_accel_tpu_torch.training import ptq as P
from thingino_accel_tpu_torch.training import qat as Q

LOSS_RTOL = 1e-4       # a loss against JAX's (a float32 mean of 32K values)
GRAD_RTOL = 1e-5       # each gradient, of its tensor's largest |gradient|
FWD_RTOL = 1e-5        # observed forward, of the largest |output|
OBS_MAX_FRAC = 1e-3    # observed outputs a quantum apart: at most 0.1%
LR = 2e-4


def _tiny(seed=7):
    """JAX's ``tests/test_qat.py`` graph: 2% of each conv's weights x20."""
    g = JZ.build_tiny(JZ.ZooConfig(dtype="float32", in_hw=(16, 16)))
    rng = np.random.default_rng(seed)
    for n in g.nodes:
        if n.op == "CONV2D":
            w = g.tensors[n.inputs[1]].data
            mask = rng.random(w.shape) < 0.02
            g.tensors[n.inputs[1]].data = np.where(
                mask, w * 20.0, w).astype(w.dtype)
    return g


def _data():
    rng = np.random.default_rng(1)
    return [rng.normal(scale=1.2, size=(2, 16, 16, 3)).astype(np.float32)
            for _ in range(2)]


@pytest.fixture(scope="module")
def setup():
    """Both packages' engines of the tiny graph and of its observed graph
    (calibrated on the two batches), and JAX's teacher outputs."""
    g = _tiny()
    inp = g.inputs[0]
    data = _data()
    je = JEngine(g)
    teacher = [je._fn(je.params, {inp: jnp.asarray(x)}) for x in data]
    jstats = JP.calibrate(g, [{inp: x} for x in data])
    pg = graph_from_jax(g)
    pstats = P.calibrate(pg, [{inp: x} for x in data], device="cpu")
    jq = JQ.insert_activation_fake_quant(g, jstats)
    pq = Q.insert_activation_fake_quant(pg, pstats)
    return dict(g=g, inp=inp, data=data, je=je, teacher=teacher,
                jstats=jstats, pstats=pstats, jq=jq, pq=pq,
                jeq=JEngine(jq), peq=Engine(pq, device="cpu"),
                pe=Engine(pg, device="cpu"))


def _leaves(pe):
    """The port's params as fresh float32 leaves that hold requires_grad."""
    return {k: v.detach().clone().requires_grad_(True)
            for k, v in pe.params.items()}


def _targets(s, i):
    """Teacher outputs of batch ``i`` keyed by the observed outputs."""
    return {o: s["teacher"][i][k] for o, k in zip(s["jq"].outputs,
                                                  s["g"].outputs)}


def test_fake_quant_value_and_ste_gradient_equal_jax():
    """Value bit for bit and the identity gradient, at a scalar scale (the
    executor's FAKE_QUANT node too) and per channel, ties included."""
    from thingino_accel_tpu_torch.runtime.executor import fake_quant
    rng = np.random.default_rng(0)
    s = 0.037
    x = np.concatenate([np.linspace(-5.1, 5.3, 24),
                        (np.arange(-8, 8) + 0.5) * s,   # ties
                        rng.normal(0, 3, 24)]).astype(np.float32)
    x = x.reshape(4, 4, 4)
    assert Q.fake_quant is fake_quant
    scales = [s, np.asarray(rng.uniform(0.01, 0.1, (1, 1, 4)), np.float32)]
    for sc in scales:
        jsc = jnp.float32(sc) if np.isscalar(sc) else jnp.asarray(sc)
        want = np.asarray(JQ.fake_quant(jnp.asarray(x), jsc))
        tsc = sc if np.isscalar(sc) else torch.from_numpy(sc)
        xt = torch.from_numpy(x).requires_grad_(True)
        got = Q.fake_quant(xt, tsc)
        np.testing.assert_array_equal(got.detach().numpy(), want)
        (got * 3.0).sum().backward()
        jg = jax.grad(lambda v: jnp.sum(JQ.fake_quant(v, jsc) * 3.0))(
            jnp.asarray(x))
        np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jg))
        np.testing.assert_array_equal(xt.grad.numpy(), 3.0)
    # the executor's node: JAX's FAKE_QUANT lowering on the same values
    t = JTensorInfo(name="x", shape=x.shape, dtype=np.dtype(np.float32))
    jg = JGraph(nodes=[JNode(op="FAKE_QUANT", inputs=["x"], outputs=["y"],
                             attrs=dict(scale=s), name="fq")],
                tensors={"x": t, "y": copy.copy(t)}, inputs=["x"],
                outputs=["y"], name="fq_test")
    jg.tensors["y"].name = "y"
    want = JEngine(jg).run_np(x)["y"]
    got = Engine(graph_from_jax(jg), device="cpu").run_np(x)["y"]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channel_axis", [None, -1])
def test_weight_fake_quant_and_export_equal_jax(setup, channel_axis):
    """``fake_quant_params`` (per tensor, and per output channel through
    the conv weights' role) and ``export_int8`` of the port's params equal
    JAX's of JAX's params bit for bit once mapped by ``params_to_jax``;
    ``weight_scale`` along the mapped axis equals JAX's along -1."""
    s = setup
    pe, je = s["pe"], s["je"]
    cw = pe._fn.conv_weights
    assert cw == {k for k, v in je.params.items() if v.ndim == 4}
    got = params_to_jax(Q.fake_quant_params(pe.params, True, channel_axis,
                                            cw), cw)
    want = JQ.fake_quant_params(je.params, True, channel_axis)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), k)
    for k in cw:
        axis = None if channel_axis is None else 0   # OHWI's output axis
        ws = Q.weight_scale(pe.params[k], axis).numpy()
        jws = np.asarray(JQ.weight_scale(je.params[k], channel_axis))
        np.testing.assert_array_equal(
            ws.reshape(-1), jws.reshape(-1))
    p8, ps = Q.export_int8(pe.params)
    j8, js = JQ.export_int8(je.params)
    assert ps == js
    for k, v in params_to_jax({k: torch.from_numpy(v) for k, v in p8.items()},
                              cw).items():
        assert v.dtype == j8[k].dtype, k
        np.testing.assert_array_equal(v, j8[k], k)


def test_per_channel_axis_is_the_output_channel_not_a_blind_minus_one(setup):
    """On the port's OHWI weights, ``channel_axis=-1`` taken blindly (no
    conv roles given) scales each kernel column: every conv weight then
    differs from JAX's per-output-channel result, which the role-mapped
    call equals."""
    s = setup
    pe, je = s["pe"], s["je"]
    cw = pe._fn.conv_weights
    want = JQ.fake_quant_params(je.params, True, -1)
    mapped = params_to_jax(Q.fake_quant_params(pe.params, True, -1, cw), cw)
    blind = params_to_jax(Q.fake_quant_params(pe.params, True, -1), cw)
    for k in cw:
        np.testing.assert_array_equal(mapped[k], np.asarray(want[k]))
        assert not np.array_equal(blind[k], np.asarray(want[k])), k


def test_observed_graph_equals_jax(setup):
    """``insert_activation_fake_quant``: the port's calibration equals
    JAX's, and the observed graph has JAX's nodes (ops, names, inputs,
    outputs), scales and outputs; its forward is JAX's (the observer
    rule of the module docstring)."""
    s = setup
    assert s["pstats"].absmax == s["jstats"].absmax
    jq, pq = s["jq"], s["pq"]
    assert (pq.name, pq.inputs, pq.outputs) == (jq.name, jq.inputs,
                                                 jq.outputs)
    assert [(n.op, n.name, n.inputs, n.outputs) for n in pq.nodes] == [
        (n.op, n.name, list(n.inputs), list(n.outputs)) for n in jq.nodes]
    for pn, jn in zip(pq.nodes, jq.nodes):
        assert pn.attrs == dict(jn.attrs), pn.name
    fq = [n for n in pq.nodes if n.op == "FAKE_QUANT"]
    assert len(fq) == 1 + sum(len(n.outputs) for n in s["g"].nodes)
    assert sorted(pq.tensors) == sorted(jq.tensors)
    for x in s["data"]:
        want = s["jeq"].run_np(x)
        got = s["peq"].run_np(x)
        for k, w in want.items():
            scale = s["pstats"].scale(k[:-len("__fq")])
            d = np.abs(got[k] - w)
            far = d > FWD_RTOL * np.abs(w).max()
            assert far.mean() <= OBS_MAX_FRAC, far.mean()
            assert (d[far] <= scale * (1 + 1e-5)).all()


def test_train_step_loss_and_grads_against_jax(setup):
    """One step of per-channel QAT on the observed graph: the loss and
    every gradient against ``jax.value_and_grad`` of JAX's train-step loss
    (``make_train_step``'s, read through an optax transformation that
    records the gradients it is given)."""
    s = setup
    inp, x = s["inp"], s["data"][0]
    tgt = _targets(s, 0)
    seen = {}

    def record(grads, state, params=None):
        seen.update(grads)
        return grads, state

    jstep = JQ.make_train_step(
        s["jeq"]._fn, optax.GradientTransformation(lambda p: (), record),
        qat=True, channel_axis=-1)
    jparams = {k: jnp.asarray(v) for k, v in s["je"].params.items()}
    _, _, jl = jstep(jparams, (), {inp: jnp.asarray(x)}, tgt)

    params = _leaves(s["pe"])
    opt = torch.optim.SGD(params.values(), lr=0.0)
    step = Q.make_train_step(s["peq"]._fn, opt, qat=True, channel_axis=-1)
    ptgt = {k: torch.from_numpy(np.array(v)) for k, v in tgt.items()}
    loss = step(params, {inp: torch.from_numpy(x)}, ptgt)
    assert loss.shape == () and not loss.requires_grad
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    grads = params_to_jax({k: p.grad for k, p in params.items()},
                          s["peq"]._fn.conv_weights)
    assert sorted(grads) == sorted(seen)
    for k, g in seen.items():
        g = np.asarray(g)
        assert np.abs(g).max() > 0, k
        err = np.abs(grads[k] - g).max() / np.abs(g).max()
        assert err <= GRAD_RTOL, (k, err)


def test_three_adam_steps_against_optax(setup):
    """``torch.optim.Adam`` against ``optax.adam`` (same formula, other
    rounding) on three steps over both batches: params within 2·lr·k of
    JAX's after k steps; the losses as the step test's."""
    s = setup
    inp = s["inp"]
    jopt = optax.adam(LR)
    jstep = jax.jit(JQ.make_train_step(s["jeq"]._fn, jopt, qat=True,
                                       channel_axis=-1))
    jparams = {k: jnp.asarray(v) for k, v in s["je"].params.items()}
    jstate = jopt.init(jparams)
    params = _leaves(s["pe"])
    step = Q.make_train_step(s["peq"]._fn,
                             torch.optim.Adam(params.values(), lr=LR),
                             qat=True, channel_axis=-1)
    cw = s["peq"]._fn.conv_weights
    for k in range(1, 4):
        i = (k - 1) % 2
        x, tgt = s["data"][i], _targets(s, i)
        jparams, jstate, jl = jstep(jparams, jstate, {inp: jnp.asarray(x)},
                                    tgt)
        loss = step(params, {inp: torch.from_numpy(x)},
                    {o: torch.from_numpy(np.array(v))
                     for o, v in tgt.items()})
        np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
        got = params_to_jax(params, cw)
        for name, v in jparams.items():
            d = np.abs(got[name] - np.asarray(v)).max()
            assert d <= 2 * LR * k, (name, k, d)


def test_qat_training_reduces_quantized_loss(setup):
    """JAX's ``test_qat_training_reduces_quantized_loss`` on the port: 60
    Adam steps (lr 2e-4) of per-channel QAT on the observed graph lower
    the mean loss of the last two steps below the first two's."""
    s = setup
    inp = s["inp"]
    params = _leaves(s["pe"])
    step = Q.make_train_step(s["peq"]._fn,
                             torch.optim.Adam(params.values(), lr=LR),
                             qat=True, channel_axis=-1)
    feeds = [{inp: torch.from_numpy(x)} for x in s["data"]]
    tgts = [{o: torch.from_numpy(np.array(v))
             for o, v in _targets(s, i).items()} for i in range(2)]
    losses = [float(step(params, feeds[i % 2], tgts[i % 2]))
              for i in range(60)]
    assert all(np.isfinite(losses))
    assert np.mean(losses[-2:]) < np.mean(losses[:2])


def test_unreached_param_gets_a_zero_gradient_as_in_jax(setup):
    s = setup
    inp, x = s["inp"], s["data"][0]
    params = _leaves(s["pe"])
    params["unused"] = torch.ones((2, 2, 2), requires_grad=True)
    opt = torch.optim.Adam(params.values(), lr=LR)
    step = Q.make_train_step(s["peq"]._fn, opt, qat=True, channel_axis=-1)
    step(params, {inp: torch.from_numpy(x)},
         {o: torch.from_numpy(np.array(v)) for o, v in _targets(s, 0).items()})
    jgrad = jax.grad(lambda u: JQ.head_l2_loss(s["jeq"]._fn(
        dict(s["je"].params, unused=u), {inp: jnp.asarray(x)}),
        _targets(s, 0)))(jnp.ones((2, 2, 2)))
    np.testing.assert_array_equal(params["unused"].grad.numpy(),
                                  np.asarray(jgrad))
    assert set(opt.state[params["unused"]]) >= {"exp_avg", "exp_avg_sq"}
    assert torch.equal(params["unused"], torch.ones((2, 2, 2)))


def test_trained_params_written_back_to_the_graph():
    """``graph_with_params`` inverts ``prepare_params`` on a graph with
    conv and depthwise weights (NanoDet's zoo graph at 64): the written
    graph's params equal the ones given, a conv weight's OIHW is JAX's
    example's HWIO -> OIHW transpose, a depthwise one [C, 1, KH, KW], and
    the source graph is left as it was."""
    g = graph_from_jax(JZ.build_nanodet(JZ.ZooConfig(in_hw=(64, 64))))
    params = prepare_params(g)
    rng = np.random.default_rng(3)
    new = {k: (rng.integers(-128, 128, v.shape).astype(v.dtype)
               if v.dtype == np.int8 else v) for k, v in params.items()}
    before = {k: t.data.copy() for k, t in g.tensors.items() if t.is_const}
    wg = graph_with_params(g, new)
    for k, v in prepare_params(wg).items():
        np.testing.assert_array_equal(v, new[k], k)
    for k, v in before.items():
        np.testing.assert_array_equal(g.tensors[k].data, v, k)
    dw = [n.inputs[1] for n in g.nodes if n.op == "DEPTHWISE_CONV2D"
          or (n.op == "CONV2D" and n.attrs.get("groups", 1) > 1)]
    conv = [n.inputs[1] for n in g.nodes if n.op == "CONV2D"
            and n.inputs[1] not in dw]
    assert dw and conv
    for k in conv:
        np.testing.assert_array_equal(
            wg.tensors[k].data, np.transpose(new[k], (3, 2, 0, 1)))
    for k in dw:
        c = new[k].shape[2]
        assert wg.tensors[k].data.shape[:2] == (c, 1)
        np.testing.assert_array_equal(
            wg.tensors[k].data[:, 0], np.transpose(new[k], (2, 0, 1)))
