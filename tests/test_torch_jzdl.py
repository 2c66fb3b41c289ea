"""The port's JZDL decompiler (``thingino_accel_tpu_torch.formats.jzdl``)
against the JAX package's, on the `.so` the port's own
``models.jzdl_fixtures`` writes (no OEM library is in the repository):

- the fixture is seeded (the same seed, the same bytes) and holds every
  invariant the JAX package's ``tests/test_jzdl.py`` asserts of the real
  ``libpersonDet_inf.so``: topology, channel flow, the model blob consumed
  exactly, the weight bit widths and layouts, the decoded quant metadata,
  the heads' focal-prior signature (checked through both parsers);
- ``parse_param``, ``parse_model``, ``find_embedded_model`` and
  ``load_so`` give every field and array of every layer equal to JAX's;
- truncated and corrupted blobs (``test_jzdl.py``'s fuzz, 120 seeded
  cases) raise ``ValueError`` (or ``struct.error``) in both, or parse to
  equal models; the param blob cut at every 4 bytes parses or raises
  ``ValueError`` (never ``IndexError``) as JAX's; a file without the two
  symbols raises JAX's ``ValueError``.
"""

import struct

import numpy as np
import pytest

from thingino_accel_tpu.formats import jzdl as JJ
from thingino_accel_tpu_torch.formats import jzdl as J
from thingino_accel_tpu_torch.models import jzdl_fixtures as JF
from thingino_accel_tpu_torch.models import mgk_fixtures as MF


@pytest.fixture(scope="module")
def so_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("jzdl") / "libpersonDet_inf.so"
    path.write_bytes(JF.build_persondet_so(0))
    return str(path)


@pytest.fixture(scope="module", params=["port", "jax"])
def model(request, so_path):
    return (J if request.param == "port" else JJ).load_so(so_path)


def test_fixture_is_seeded():
    a, b = JF.build_persondet_so(0), JF.build_persondet_so(1)
    assert a == JF.build_persondet_so(0) and len(a) == len(b) and a != b
    assert JF.model_blob(0) != JF.model_blob(1)
    assert a.count(JF.param_blob()) == 1 and b.count(JF.model_blob(1)) == 1


def test_topology(model):
    assert model.input_chw == (3, 67, 67)
    assert len(model.layers) == 32 and model.n_blobs == JF.N_BLOBS
    types = [l.ltype for l in model.layers]
    assert types.count(J.T_CONV_HEAD) == 2
    assert types.count(J.T_CONCAT) == 1
    assert types.count(J.T_SPLIT) == 2
    assert types.count(J.T_MAXPOOL) == 1
    assert types.count(J.T_UPSAMPLE) == 1
    det = model.layers[-1]
    assert det.ltype == J.T_DETECT_OUT
    head_tops = [l.tops[0] for l in model.layers
                 if l.ltype == J.T_CONV_HEAD]
    assert set(det.bottoms) == set(head_tops)
    stem = model.conv_layers()[0]
    assert (stem.ltype, stem.kernel, stem.stride, stem.weight_size) == (
        J.T_CONV_STEM, 3, 2, 432)


def test_channel_flow_and_blob_accounting(model):
    for l in model.conv_layers():
        if l.is_depthwise:
            expect = l.kernel * l.kernel * l.out_channels
            assert l.in_channels == l.out_channels
        else:
            expect = l.kernel * l.kernel * l.in_channels * l.out_channels
        assert l.weight_size == expect, (l.ltype, l.weight_size, expect)
        assert l.weights is not None and l.weights.size == l.weight_size
    heads = [l for l in model.conv_layers() if l.weight_flag == 4]
    assert [h.out_channels for h in heads] == [18, 18]
    concat = next(l for l in model.layers if l.ltype == J.T_CONCAT)
    dw_after = next(l for l in model.conv_layers()
                    if l.bottoms == concat.tops)
    assert dw_after.in_channels == 384  # 128 upsampled + 256 skip
    assert sum(l.weight_size for l in model.conv_layers()) == 926880


def test_weight_bitwidths_and_layouts(model):
    for l in model.conv_layers():
        absmax = int(np.abs(l.weights.astype(np.int32)).max())
        if l.is_depthwise:
            assert absmax > 16
            am = np.abs(l.weight_taps().astype(np.int32)).max(axis=0)
            assert (am >= 127).all()
            am_t = np.abs(l.weights.reshape(l.out_channels, 9)
                          .astype(np.int32)).max(axis=1)
            assert (am_t >= 127).mean() < 0.9
        elif l.ltype == J.T_CONV_STEM or l.weight_flag == 4:
            assert absmax <= 8
        else:
            assert absmax <= 16
        if l.kernel == 1:
            am = np.abs(l.weight_matrix().astype(np.int32)).max(axis=1)
            assert (am >= am.max() - 1).all(), l.ltype


def test_quant_metadata_and_head_priors(model):
    stem = model.conv_layers()[0]
    sm = stem.q31_mult.astype(np.int64)
    assert (sm % 1000 == 0).all()
    assert ((sm // 1000 >= 2 ** 20) & (sm // 1000 < 2 ** 21)).all()
    inner = [l for l in model.conv_layers() if l.mant is not None]
    assert len(inner) == 22
    for l in inner:
        m = l.mant.astype(np.int64)
        assert (m > 0).all() and (m % 1000 == 0).all()
        k = m // 1000
        assert ((k >= 2 ** 20) & (k < 2 ** 21)).all()
        assert (l.reserved16 == 0).all() and (l.shift16 < 16).all()
        assert int(np.abs(l.bias16.astype(np.int32)).max()) < 16384
        s = l.requant_scale()
        assert ((s > 2.0 ** -14) & (s < 1.0)).all()
    for h in (l for l in model.conv_layers() if l.weight_flag == 4):
        prior = (h.bias * h.scales).reshape(3, 6)
        assert (prior[:, 4] < -8).all() and (prior[:, 5] > 2).all()
        assert (np.abs(prior[:, :4]) < 8).all()


def _assert_same_model(got, want):
    assert got.input_chw == want.input_chw and got.n_blobs == want.n_blobs
    assert len(got.layers) == len(want.layers)
    for i, (a, b) in enumerate(zip(got.layers, want.layers)):
        for f in ("ltype", "bottoms", "tops", "params", "out_channels",
                  "kernel", "stride", "weight_size", "weight_flag",
                  "weight_meta", "in_channels"):
            assert getattr(a, f) == getattr(b, f), (i, f)
        for f in ("weights", "bias", "q31_mult", "q_shift", "scales",
                  "quant_a", "quant_packed", "bias16", "mant", "shift16",
                  "reserved16"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), (i, f)
            if x is not None:
                assert x.dtype == y.dtype, (i, f)
                np.testing.assert_array_equal(x, y, err_msg=f"{i} {f}")
        if a.weights is not None and a.ltype != J.T_CONV_HEAD:
            np.testing.assert_array_equal(a.requant_scale(),
                                          b.requant_scale())


def test_parse_equals_jax(so_path):
    param, blob, base = J.find_embedded_model(so_path)
    assert (param, blob, base) == JJ.find_embedded_model(so_path)
    assert base == JF.SYMBOL_BASE and param == JF.param_blob()
    assert blob == JF.model_blob(0)
    got, want = J.parse_param(param), JJ.parse_param(param)
    _assert_same_model(got, want)
    J.parse_model(blob, got)
    JJ.parse_model(blob, want)
    _assert_same_model(got, want)
    _assert_same_model(J.load_so(so_path), JJ.load_so(so_path))
    with pytest.raises(ValueError, match="accounting mismatch"):
        J.parse_model(blob + b"\x00" * 4, J.parse_param(param))


def _outcome(pkg, param, blob):
    try:
        m = pkg.parse_param(param)
        pkg.parse_model(blob, m)
    except (ValueError, struct.error) as e:
        return type(e).__name__
    return m


@pytest.mark.parametrize("mode", ["corrupt", "truncate"])
def test_fuzz_fails_as_jax(so_path, mode):
    param, blob, _ = J.find_embedded_model(so_path)
    rng = np.random.default_rng(42 if mode == "corrupt" else 43)
    for case in range(60):
        if mode == "corrupt":
            buf = bytearray(param)
            for _ in range(int(rng.integers(1, 8))):
                off = int(rng.integers(0, len(buf) // 4)) * 4
                buf[off:off + 4] = rng.bytes(4)
            p, b = bytes(buf), blob
        else:
            p = param[:int(rng.integers(0, len(param)))]
            b = blob[:int(rng.integers(0, len(blob)))]
        got, want = _outcome(J, p, b), _outcome(JJ, p, b)
        if isinstance(want, str):
            assert got == want, case
        else:
            _assert_same_model(got, want)

def test_every_truncated_param_blob_parses_or_fails_as_jax(so_path):
    param = J.find_embedded_model(so_path)[0]
    failed = 0
    for cut in range(0, len(param), 4):
        got, want = (_outcome(pkg, param[:cut], b"") for pkg in (J, JJ))
        if isinstance(want, str):
            assert got == want == "ValueError", cut
            failed += 1
        else:
            assert isinstance(got, J.JzdlModel), cut
    assert failed > 10


def test_a_file_without_the_symbols_raises_as_jax(tmp_path):
    path = tmp_path / "other.so"
    path.write_bytes(MF.build_elf32(b"no model here\x00"))
    with pytest.raises(ValueError) as got:
        J.load_so(str(path))
    with pytest.raises(ValueError) as want:
        JJ.load_so(str(path))
    assert str(got.value) == str(want.value)
