"""The port's AEC model (``thingino_accel_tpu_torch.models.aec``) against
the JAX package's, on the same seeded inputs, on the CPU:

- ``init_params`` draws JAX's params (``params_from_jax`` of JAX's equals
  the port's own, bit for bit);
- the GRU (gate order r, z, n; forward and reversed) and the convs (XLA's
  ``SAME`` padding at strides 1 and 2, odd lengths too) within
  ``AEC_TOL``;
- ``forward`` and ``process_stream`` masks and state within ``AEC_TOL``
  (float32, of the largest |value|) of JAX's, from ``params_from_jax`` and
  from the port's own ``init_params(seed)``; ``process_stream`` equals the
  port's own chunk-by-chunk ``forward`` exactly;
- ``try_attach_mgk_weights`` on the AEC fixture `.mgk`'s blob equals JAX's
  bit for bit; ``build_aec_graph`` / ``AECModel.run`` against JAX's,
  ``graph`` raising ``AttributeError``;
- ``AECStream`` and ``make_stream_scanner`` on the decompiled fixture
  (``build_aec_mgk(0)``) against JAX's on the same bytes, W = 4 windows and
  S = 2 streams (JAX's CPU compile stays short); the scanner against the
  port's own ``AECStream`` window by window within ``SCAN_TOL`` (JAX's
  test's bound), with one graph forward a window for all the streams
  (``torch.func.vmap``, not a loop over them); JAX's error text for a
  graph without the streaming state.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from thingino_accel_tpu.formats import mgk as JMGK
from thingino_accel_tpu.models import aec as JA
from thingino_accel_tpu_torch.formats import mgk as MGK
from thingino_accel_tpu_torch.models import aec as A
from thingino_accel_tpu_torch.models import mgk_fixtures as MF
from thingino_accel_tpu_torch.ops import reference as R

AEC_TOL = 1e-5       # of the largest |value|: float32 GRU stacks, two engines
SCAN_TOL = 2e-5      # absolute, the scanner against the step loop (JAX's)


def _close(got, want, tol=AEC_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max()) / max(
        float(np.abs(want).max()), 1e-30)
    assert err <= tol, f"{err:.3g} of the largest |value|"


def _jax_params(seed=0):
    return JA.init_params(JA.AECConfig(seed=seed))


@pytest.fixture(scope="module")
def aec_graphs(tmp_path_factory):
    path = tmp_path_factory.mktemp("aec") / "a.mgk"
    path.write_bytes(MF.build_aec_mgk(0))
    return (MGK.import_mgk(str(path), streaming=True),
            JMGK.import_mgk(str(path), streaming=True), path)


@pytest.mark.parametrize("seed", [0, 3])
def test_init_params_equal_jax(seed):
    jp = _jax_params(seed)
    got = A.init_params(A.AECConfig(seed=seed), "cpu")
    conv = A.params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                             "cpu")
    assert list(got) == list(jp)
    for k, v in jp.items():
        v = np.asarray(v)
        assert torch.equal(got[k], conv[k]), k
        want = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v
        np.testing.assert_array_equal(got[k].numpy(), want, err_msg=k)


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_scan_equals_jax(reverse):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(5, 7, 32)).astype(np.float32)
    h0 = rng.normal(size=(5, 32)).astype(np.float32)
    w = [rng.normal(scale=0.2, size=s).astype(np.float32)
         for s in ((32, 96), (32, 96), (96,), (96,))]
    ys, h = A.gru_scan(torch.from_numpy(x), torch.from_numpy(h0),
                       *map(torch.from_numpy, w), reverse=reverse)
    jys, jh = JA.gru_scan(jnp.asarray(x), jnp.asarray(h0),
                          *map(jnp.asarray, w), reverse=reverse)
    _close(ys, jys)
    _close(h, jh)


@pytest.mark.parametrize("n,k,s", [(256, 2, 2), (64, 2, 1), (7, 2, 2),
                                   (9, 1, 1), (5, 3, 2)])
def test_conv_same_padding_equals_xla(n, k, s):
    rng = np.random.default_rng(n + k + s)
    x = rng.normal(size=(2, n, 6, 4)).astype(np.float32)       # NHWC
    w = rng.normal(size=(k, 1, 4, 3)).astype(np.float32)       # HWIO
    b = rng.normal(size=(3,)).astype(np.float32)
    want = JA._conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), (s, 1))
    got = A._conv(torch.from_numpy(x).permute(0, 3, 1, 2),
                  torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                  torch.from_numpy(b), (s, 1)).permute(0, 2, 3, 1)
    _close(got, want)


@pytest.mark.parametrize("params", ["from_jax", "own_seed_5"])
def test_forward_and_process_stream_equal_jax(params):
    jp = _jax_params(5 if params == "own_seed_5" else 0)
    pp = (A.init_params(A.AECConfig(seed=5), "cpu")
          if params == "own_seed_5" else
          A.params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                            "cpu"))
    rng = np.random.default_rng(2)
    spec = np.abs(rng.normal(size=(2, 256, 8, 1))).astype(np.float32)
    state = rng.normal(scale=0.3, size=(2, 64, 32)).astype(np.float32)
    mask, st = A.forward(pp, torch.from_numpy(spec), torch.from_numpy(state))
    jmask, jst = JA.forward(jp, jnp.asarray(spec), jnp.asarray(state))
    assert mask.shape == (2, 256, 8, 2) and st.shape == (2, 64, 32)
    _close(mask, jmask)
    _close(st, jst)

    long = np.abs(rng.normal(size=(1, 256, 36, 1))).astype(np.float32)
    masks = A.process_stream(pp, torch.from_numpy(long), 8)
    assert masks.shape == (1, 256, 32, 2)
    _close(masks, JA.process_stream(jp, jnp.asarray(long), 8))
    st, chunks = None, []
    for i in range(4):
        m, st = A.forward(pp, torch.from_numpy(long[:, :, 8 * i:8 * i + 8]),
                          st)
        chunks.append(m)
    assert torch.equal(torch.cat(chunks, 2), masks)


def test_mgk_weights_and_model_equal_jax():
    blob = MGK.parse_elf(MF.build_aec_mgk(0)).appended
    jp = JA.try_attach_mgk_weights(_jax_params(), blob)
    got = A.try_attach_mgk_weights(A.init_params(A.AECConfig(), "cpu"),
                                   blob)
    want = A.params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                             "cpu")
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert not torch.equal(got["gru1_w_ih"],
                           A.init_params(A.AECConfig(), "cpu")["gru1_w_ih"])
    # a short blob leaves the init values
    short = A.try_attach_mgk_weights(A.init_params(A.AECConfig(), "cpu"),
                                     blob[:100])
    assert torch.equal(short["gru2f_w_ih"],
                       A.init_params(A.AECConfig(), "cpu")["gru2f_w_ih"])

    model = A.build_aec_graph(blob, device="cpu")
    jmodel = JA.build_aec_graph(blob)
    spec = np.abs(np.random.default_rng(3).normal(size=(1, 256, 8))).astype(
        np.float32)
    m, st = model.run(spec)
    jm, jst = jmodel.run(spec)
    assert m.shape == (1, 256, 8, 2)
    _close(m, jm)
    m2, _ = model.run(spec, st)
    _close(m2, jmodel.run(spec, jst)[0])
    with pytest.raises(AttributeError, match="streaming API"):
        model.graph


def test_aec_stream_equals_jax(aec_graphs):
    g, jg, _ = aec_graphs
    stream, jstream = A.AECStream(g, "cpu"), JA.AECStream(jg)
    assert stream.init_state().shape == (1, 64, 32)
    wins = np.abs(np.random.default_rng(6).normal(size=(3, 1, 256, 8))
                  ).astype(np.float32)
    st = jst = None
    for w in wins:
        m, st = stream.run(w, st)
        jm, jst = jstream.run(w, jst)
        assert m.shape == (1, 256, 2)
        _close(m, jm)
        _close(st, jst)
    plain = MGK.import_mgk(str(aec_graphs[2]))
    with pytest.raises(ValueError) as got:
        A.AECStream(plain, "cpu")
    with pytest.raises(ValueError) as want:
        JA.AECStream(JMGK.import_mgk(str(aec_graphs[2])))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="import with streaming=True"):
        A.make_stream_scanner(plain, "cpu")


def test_stream_scanner_equals_jax_and_the_step_loop(aec_graphs,
                                                     monkeypatch):
    g, jg, _ = aec_graphs
    W, S = 4, 2
    rng = np.random.default_rng(7)
    wins = np.abs(rng.normal(size=(W, S, 1, 256, 8))).astype(np.float32)
    h0 = rng.normal(scale=0.2, size=(S, 1, 64, 32)).astype(np.float32)
    calls = []
    gru = R.gru
    monkeypatch.setattr(R, "gru", lambda *a, **k: calls.append(1) or
                        gru(*a, **k))
    masks = A.make_stream_scanner(g, "cpu")(h0, wins)
    # two GRU nodes a window for all the streams: vmap, no loop over S
    assert masks.shape == (W, S, 1, 256, 2) and len(calls) == 2 * W
    want = JA.make_stream_scanner(jg)(jnp.asarray(h0), jnp.asarray(wins))
    _close(masks, want)
    stream = A.AECStream(g, "cpu")
    for s in range(S):
        state = torch.from_numpy(h0[s])
        for w in range(W):
            m, state = stream.run(wins[w, s], state)
            np.testing.assert_allclose(masks[w, s].numpy(), m.numpy(),
                                       atol=SCAN_TOL)
