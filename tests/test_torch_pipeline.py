"""E2, the lagged-epilogue conv (``thingino_accel_tpu_torch.probes.pipeline``,
``ops.probe_kernels.conv3x3_lagged``), against the JAX example it ports,
``examples/pipeline_experiment.py``, on the CPU.

The example is loaded from its file; its ``build()`` runs under
``pltpu.force_tpu_interpret_mode()`` at 2 images, beside the port's
``build``, whose CPU path is each kernel's plain version. The same seeded
inputs go to both (the port draws them as the example's ``main`` does,
and a test checks they are equal); the JAX baseline pads its channels to
128 lanes (``keep_phys=True``), so it is read through ``[..., :o]``.

Tolerances: NONE, RELU and LEAKY_RELU bit-exact; SILU at most 1 quantum on
at most 0.1% of the values (XLA's and torch's sigmoid differ by ulps).

The JAX ``lagged`` writes only ``(h // tile_h) * tile_h`` rows
(``n_tiles = h // tile_h``); the port computes every row, and the tests
hold it to the JAX baseline on all of them.
"""

import importlib.util
import io
import os
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from thingino_accel_tpu_torch.ops import fused_kernels as FK
from thingino_accel_tpu_torch.ops import probe_kernels as PK
from thingino_accel_tpu_torch.probes import pipeline as P2

EXAMPLE = os.path.join(os.path.dirname(__file__), "..", "examples",
                       "pipeline_experiment.py")
ACTS = ("NONE", "RELU", "LEAKY_RELU", "SILU")
H100 = FK.SmemLimits(132, 233472, 232448)


@pytest.fixture(scope="module")
def e2():
    spec = importlib.util.spec_from_file_location("_example_pipeline",
                                                  EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _assert_act_close(got: torch.Tensor, ref, act: str):
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape and ref.dtype == np.int8
    d = np.abs(got.numpy().astype(np.int32) - ref.astype(np.int32))
    if act == "SILU":
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(),
                                                         (d > 0).mean())
    else:
        assert d.max() == 0, (d.max(), (d > 0).mean())


def _pair(e2, h, c, o, act, tile_h=16):
    """The JAX (baseline, lagged) outputs in interpret mode and the
    port's (baseline, LAG 0, LAG 1), all on the same 2 images."""
    w, b, xs = P2.draws(2, h, c, o, n_inputs=1)
    with pltpu.force_tpu_interpret_mode():
        jb, jl = e2.build(2, h, c, o, tile_h, act)
        jw, jbias, jx = jnp.asarray(w), jnp.asarray(b), jnp.asarray(xs[0])
        ref_base = np.asarray(jb(jx, jw, jbias))[..., :o]
        ref_lag = np.asarray(jl(jx, jw, jbias))
    pb, pl = P2.build(2, h, c, o, act, "cpu")
    x, wt, bt = torch.from_numpy(xs[0]), P2.to_ohwi(w), torch.from_numpy(b)
    return (ref_base, ref_lag), (pb(x, wt, bt), pl(x, wt, bt, False),
                                 pl(x, wt, bt, True))


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("c,o", [(128, 128), (32, 48)])
@pytest.mark.parametrize("h", [16, 32])
def test_lagged_equals_the_jax_experiment(e2, h, c, o, act):
    """Tiles that divide h: the JAX lagged kernel equals its baseline, and
    the port's baseline and both lag modes equal both."""
    (ref_base, ref_lag), outs = _pair(e2, h, c, o, act)
    assert ref_lag.shape == (2, h, h, o)
    for got in outs:
        _assert_act_close(got, ref_lag, act)
        _assert_act_close(got, ref_base, act)
    assert PK.launches["conv3x3_lagged"] == 0   # the CPU path launches none


def test_port_writes_the_rows_the_reference_drops(e2):
    """h = 20, tile_h = 8: the JAX lagged kernel returns 16 rows (n_tiles
    = h // tile_h); the port returns all 20, its first 16 equal to JAX's
    and all 20 equal to the JAX baseline's."""
    (ref_base, ref_lag), outs = _pair(e2, 20, 32, 48, "LEAKY_RELU",
                                      tile_h=8)
    assert ref_lag.shape == (2, 16, 20, 48)
    assert ref_base.shape == (2, 20, 20, 48)
    for got in outs[1:]:
        assert tuple(got.shape) == (2, 20, 20, 48)
        _assert_act_close(got[:, :16], ref_lag, "LEAKY_RELU")
        _assert_act_close(got, ref_base, "LEAKY_RELU")


def test_draws_equal_the_example_main(e2, monkeypatch):
    """The arrays the example's ``main`` hands to ``jnp.asarray`` (w, b,
    then its 4 inputs at 2 images on the CPU) are the port's draws."""
    seen = []
    real = jnp.asarray

    def record(a, *args, **kw):
        if isinstance(a, np.ndarray):
            seen.append(a.copy())
        return real(a, *args, **kw)

    def fake_build(batch, h, c, o, tile_h, act):
        def f(x, w, b):
            return x[..., :1]
        return f, f

    import thingino_accel_tpu.utils.cache as cache
    monkeypatch.setattr(cache, "enable_compile_cache", lambda *a: None)
    monkeypatch.setattr(jax.numpy, "asarray", record)
    monkeypatch.setattr(e2, "build", fake_build)
    with redirect_stdout(io.StringIO()):
        e2.main()
    w, b, xs = P2.draws(2, P2.H, P2.C, P2.O)
    assert len(seen) == 6
    for got, want in zip(seen, [w, b] + xs):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_wrapper_refuses_what_the_kernel_cannot_run():
    ep = FK.epilogue_rows(0.01, 0.05, 0.05, "NONE", 48)
    x = torch.zeros((1, 8, 8, 32), dtype=torch.int8)
    w = torch.zeros((48, 3, 3, 32), dtype=torch.int8)
    assert PK.conv3x3_lagged(x, w, None, ep).shape == (1, 8, 8, 48)
    with pytest.raises(ValueError, match="C % 32"):
        PK.conv3x3_lagged(torch.zeros((1, 8, 8, 48), dtype=torch.int8),
                          torch.zeros((48, 3, 3, 48), dtype=torch.int8),
                          None, ep)
    ep44 = FK.epilogue_rows(0.01, 0.05, 0.05, "NONE", 44)
    with pytest.raises(ValueError, match="O % 8"):
        PK.conv3x3_lagged(x, w[:44], None, ep44)
    with pytest.raises(ValueError, match="3, 3"):
        PK.conv3x3_lagged(x, torch.zeros((48, 1, 1, 32), dtype=torch.int8),
                          None, ep)
    with pytest.raises(TypeError):
        PK.conv3x3_lagged(x.to(torch.int16), w, None, ep)
    assert PK.launches["conv3x3_lagged"] == 0


def test_plans_at_the_experiment_shapes():
    """E2's shape takes 128-channel blocks through a four-slot ring, one
    persistent block an SM (132 walking 12,800 tiles); the ragged 45 x 77
    -> 72 takes 32-channel blocks (96 channels issued, not 128); every plan
    fits and C = 512 has none."""
    plan = PK.lagged_plan(128, 80, 80, 128, 128, H100)
    assert plan == PK.LaggedPlan(128, 4, 132)
    assert PK.lagged_smem(128, 128, 4) == 201800
    ragged = PK.lagged_plan(16, 45, 77, 96, 72, H100)
    assert (ragged.bn, ragged.stages) == (32, 4)
    plans = PK.lagged_plans(2, 80, 80, 128, 128, H100)
    assert len(plans) == len(PK.LAGGED_BNS) * len(PK.LAGGED_STAGES)
    for p in plans:
        assert PK.lagged_smem(128, p.bn, p.stages) <= 232448
        assert 1 <= p.blocks <= 2 * 10 * 10
    with pytest.raises(ValueError, match="fits"):
        PK.lagged_plan(1, 8, 8, 512, 64, H100)


def test_pipeline_main_on_the_cpu():
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert P2.main(["--device", "cpu", "--h", "12", "--c", "32", "--o",
                        "16", "--act", "LEAKY_RELU"]) == 0
    out = buf.getvalue()
    assert "max|diff| = 0 (OK" in out and "not timed" in out
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="cpu"):
            P2.main([])
