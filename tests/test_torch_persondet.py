"""The port's person-detector reconstruction
(``thingino_accel_tpu_torch.models.persondet``, torch) against the JAX
package's (numpy), on the port's fixture `.so` (``models.jzdl_fixtures``)
and seeded images, on the CPU:

- every conv's int32 accumulator, calibration image and held-out image,
  bit for bit (JAX's recorded through its ``conv_acc``);
- the calibration statistics: the means equal numpy's bit for bit, the
  standard deviations (ddof 0) within ``STAT_RTOL`` relative;
- the requantized features (every conv's input) equal JAX's: 0 of them
  differ by a quantum on these images;
- the heads and ``person_maps`` within ``HEAD_RTOL`` (float64, relative
  to the largest |value|; they come out equal), ``head_priors`` equal;
  JAX's calibration dict through ``calibration_from_numpy`` gives JAX's
  heads;
- the shape rules: the stride-2 stem 67 -> 34, the max pool's crop to even
  sizes, the concat's crop to the smallest h and w, nearest upsampling;
- ``forward`` without statistics raises JAX's ``ValueError``.
"""

import numpy as np
import pytest
import torch

from thingino_accel_tpu.formats import jzdl as JJ
from thingino_accel_tpu.models import persondet as JP
from thingino_accel_tpu_torch.formats import jzdl as J
from thingino_accel_tpu_torch.models import jzdl_fixtures as JF
from thingino_accel_tpu_torch.models import persondet as P

STAT_RTOL = 1e-12
HEAD_RTOL = 1e-12


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path = tmp_path_factory.mktemp("pd") / "libpersonDet_inf.so"
    path.write_bytes(JF.build_persondet_so(0))
    return J.load_so(str(path)), JJ.load_so(str(path))


@pytest.fixture(scope="module")
def images():
    return JF.seeded_image(1), JF.seeded_image(2)


def _jax_run(monkeypatch, jm, img, cal=None, collect=None):
    """JAX's forward with every conv_acc call's (input, output) recorded."""
    rec = []
    conv_acc = JP.conv_acc

    def record(x, l):
        acc = conv_acc(x, l)
        rec.append((x, acc))
        return acc
    monkeypatch.setattr(JP, "conv_acc", record)
    heads = JP.forward(jm, img, cal, collect)
    monkeypatch.setattr(JP, "conv_acc", conv_acc)
    return heads, rec


def _port_run(monkeypatch, pm, img, cal=None, collect=None):
    """The port's forward with every conv_acc call's output recorded."""
    accs = []
    conv_acc = P.conv_acc
    monkeypatch.setattr(P, "conv_acc",
                        lambda x, l: accs.append(conv_acc(x, l)) or accs[-1])
    heads = P.forward(pm, img, cal, collect, device="cpu")
    monkeypatch.setattr(P, "conv_acc", conv_acc)
    return heads, accs


def test_accumulators_statistics_features_and_heads_equal_jax(
        models, images, monkeypatch):
    pm, jm = models
    calib, held = images
    jcal = {}
    _, jrec = _jax_run(monkeypatch, jm, calib, collect=jcal)
    pcal = {}
    _, paccs = _port_run(monkeypatch, pm, calib, collect=pcal)
    convs = [i for i, l in enumerate(pm.layers) if l.is_conv]
    assert len(paccs) == len(jrec) == len(convs) == 25
    for li, pacc, (x, acc) in zip(convs, paccs, jrec):
        assert pacc.dtype == torch.int32
        np.testing.assert_array_equal(pacc.numpy(), acc, err_msg=str(li))
    assert list(pcal) == list(jcal)
    for li, (mu, sd) in jcal.items():
        np.testing.assert_array_equal(pcal[li][0].numpy(), mu)
        np.testing.assert_allclose(pcal[li][1].numpy(), sd, rtol=STAT_RTOL,
                                   atol=0)

    jheads, jrec = _jax_run(monkeypatch, jm, held, jcal)
    rec = []
    conv_acc = P.conv_acc
    monkeypatch.setattr(P, "conv_acc", lambda x, l: rec.append(x) or
                        conv_acc(x, l))
    heads, paccs = _port_run(monkeypatch, pm, held, pcal)
    assert len(rec) == len(paccs) == len(jrec) == 25
    off_by_one = 0
    for (jx, jacc), x, pacc, li in zip(jrec, rec, paccs, convs):
        d = np.abs(x.numpy().astype(np.int64) - np.asarray(jx, np.int64))
        assert int(d.max()) <= 1, li
        off_by_one += int((d == 1).sum())
        np.testing.assert_array_equal(pacc.numpy(), jacc, err_msg=str(li))
    assert off_by_one == 0
    assert sorted(heads) == sorted(jheads) == [25, 32]
    for hb in jheads:
        assert heads[hb].dtype == torch.float64
        assert heads[hb].shape == jheads[hb].shape == (
            {25: 17, 32: 34}[hb],) * 2 + (18,)
        np.testing.assert_allclose(
            heads[hb].numpy(), jheads[hb], rtol=0,
            atol=HEAD_RTOL * float(np.abs(jheads[hb]).max()))
    maps, jmaps = P.person_maps(heads), JP.person_maps(jheads)
    for hb in jmaps:
        np.testing.assert_allclose(
            maps[hb].numpy(), jmaps[hb], rtol=0,
            atol=HEAD_RTOL * float(np.abs(jmaps[hb]).max()))


def test_calibrate_and_jax_calibration(models, images):
    pm, jm = models
    calib, held = images
    jcal = JP.calibrate(jm, calib)
    got = P.forward(pm, held, P.calibration_from_numpy(jcal, "cpu"),
                    device="cpu")
    want = JP.forward(jm, held, jcal)
    for hb in want:
        np.testing.assert_array_equal(got[hb].numpy(), want[hb])
    own = P.calibrate(pm, calib, device="cpu")
    assert sorted(own) == sorted(jcal) and len(own) == 23
    heads = P.forward(pm, torch.from_numpy(held), own, device="cpu")
    # the port's own statistics (within 1e-12) requantize to the same features
    for k in heads:
        assert torch.equal(heads[k], got[k]), k
    with pytest.raises(ValueError, match="collect_cal"):
        P.forward(pm, held, device="cpu")
    with pytest.raises(ValueError, match="collect_cal"):
        JP.forward(jm, held)


def test_head_priors_equal_jax(models):
    pm, jm = models
    got, want = P.head_priors(pm, "cpu"), JP.head_priors(jm)
    assert sorted(got) == sorted(want)
    for hb in want:
        assert got[hb].shape == (3, 6)
        np.testing.assert_array_equal(got[hb].numpy(), want[hb])


def test_structural_shape_rules_equal_jax():
    """The max pool crops to even sizes, the concat crops to the smallest
    h and w, the upsample repeats: on odd shapes, against JAX's."""
    rng = np.random.default_rng(9)
    a = rng.integers(-8, 8, (9, 7, 4), dtype=np.int32)
    b = rng.integers(-8, 8, (10, 8, 3), dtype=np.int32)
    for layer, blobs, shape in (
            (J.JzdlLayer(J.T_MAXPOOL, [0], [1]), {0: a}, (4, 3, 4)),
            (J.JzdlLayer(J.T_UPSAMPLE, [0], [1]), {0: a}, (18, 14, 4)),
            (J.JzdlLayer(J.T_CONCAT, [0, 2], [1]), {0: b, 2: a}, (9, 7, 7)),
            (J.JzdlLayer(J.T_SPLIT, [0], [1, 3]), {0: a}, (9, 7, 4))):
        got = {k: torch.from_numpy(v) for k, v in blobs.items()}
        want = dict(blobs)
        P._structural(layer, got[layer.bottoms[0]], got)
        JP._structural(layer, want[layer.bottoms[0]], want)
        for t in layer.tops:
            assert tuple(got[t].shape) == shape, layer.ltype
            np.testing.assert_array_equal(got[t].numpy(), want[t])
    with pytest.raises(ValueError, match="unhandled layer type"):
        P._structural(J.JzdlLayer(99, [0], [1]), a, {})


def test_stem_accumulator_shape(models, images):
    pm, jm = models
    stem_p, stem_j = pm.conv_layers()[0], jm.conv_layers()[0]
    x = images[0].astype(np.int32) - 128
    got = P.conv_acc(torch.from_numpy(x), stem_p)
    assert tuple(got.shape) == (34, 34, 16)
    np.testing.assert_array_equal(got.numpy(), JP.conv_acc(x, stem_j))
