"""The port's `.mgk` decompiler (``thingino_accel_tpu_torch.formats.mgk``,
``mgk_yolo``, ``models.mgk_fixtures``) against the JAX package's, on the
same bytes and seeded numpy inputs:

- the fixture writers: the port's ``build_elf32`` and ``build_yolo_mgk``
  bytes equal JAX's ``testing/elf_fixture.py``'s; the port's AEC fixture
  (``build_aec_mgk``) parses in both packages;
- ``parse_elf``, ``mine_rodata``, ``inspect_mgk``, ``extract_weight_table``
  and the block analysis equal JAX's (dataclass fields, arrays bit for
  bit) on the YOLO, AEC and LayerParam fixtures;
- ``unpack_gru_blocks`` and the 2-bit and NMHWSOIB2 unpackers equal JAX's;
- the YOLO weight table, ``detect_yolo_family`` for n and s and its
  rejection of a wrong blob, ``mine_w_scales`` and ``extract_yolo_weights``
  equal JAX's, array for array;
- ``mgk_to_onnx`` bytes equal JAX's for the YOLO fixture (at 640, its
  default, and through ``export_yolo_onnx`` at 64x64) and for the AEC
  fixture, streaming and not; ``import_mgk`` graphs equal JAX's;
- JAX's early-conv probe (``tests/test_mgk_yolo.py``) in the port: the
  decompiled graph's 6th conv output within ``atol=1e-6`` of the
  dequantized zoo graph's, exact tier;
- the AEC graph in the port's exact tier against JAX's engine on the same
  graph: three 8-frame windows with gru1's state carried, outputs and
  state within ``AEC_TOL`` (float32, 1e-5 of the largest |value|), and the
  carried state changes the output;
- ``UnsupportedMgkError`` and its kinds, and the ELF fuzz test.
"""

import dataclasses

import numpy as np
import pytest

from thingino_accel_tpu.formats import mgk as JMGK
from thingino_accel_tpu.formats import mgk_yolo as JMY
from thingino_accel_tpu.ir.passes import dequantize_graph as jdequantize
from thingino_accel_tpu.runtime import Engine as JEngine
from thingino_accel_tpu.testing import elf_fixture as JF
from thingino_accel_tpu_torch.formats import mgk as MGK
from thingino_accel_tpu_torch.formats import mgk_yolo as MY
from thingino_accel_tpu_torch.ir.graph import graph_from_jax
from thingino_accel_tpu_torch.ir.passes import dequantize_graph
from thingino_accel_tpu_torch.models import mgk_fixtures as F
from thingino_accel_tpu_torch.runtime.engine import Engine

AEC_TOL = 1e-5       # of the largest |value|: float32 GRU stacks, two engines
W_SCALE = 0.0004     # JAX's YOLO fixture: 60 layers of random weights bounded


@pytest.fixture(scope="module")
def yolo():
    data, g0 = F.build_yolo_mgk("n", in_hw=(64, 64), w_scale=W_SCALE)
    return data, g0


@pytest.fixture(scope="module")
def aec():
    return F.build_aec_mgk(0)


def layer_param_elf() -> bytes:
    return F.build_elf32(b"", symbols=[
        ("magik::venus::layer::ConvLayerParam", 0x10, 4),
        ("magik::venus::layer::GruLayerParam", 0x20, 4),
        ("magik::venus::layer::AddrHelper", 0x30, 4),
    ], extra_sections={".text": b"\x00" * 64, ".data.rel.ro": b"\x01" * 8})


def fields(obj):
    """A dataclass (or a list / dict of them) as plain values, arrays
    compared by their bytes."""
    if dataclasses.is_dataclass(obj):
        return {f.name: fields(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: fields(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [fields(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return (obj.dtype.str, obj.shape, obj.tobytes())
    return obj


def assert_same_arrays(got: dict, want: dict):
    assert list(got) == list(want) and want
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def assert_same_graph(port, ref):
    """The port's graph equals JAX's (``graph_from_jax``): nodes, tensors
    (quant and constants bit for bit), inputs, outputs."""
    ref = graph_from_jax(ref)
    assert (port.name, port.inputs, port.outputs) == (
        ref.name, ref.inputs, ref.outputs)
    assert [(n.op, n.inputs, n.outputs, n.name, fields(n.attrs))
            for n in port.nodes] == [
        (n.op, n.inputs, n.outputs, n.name, fields(n.attrs))
        for n in ref.nodes]
    assert list(port.tensors) == list(ref.tensors)
    for name, pt in port.tensors.items():
        jt = ref.tensors[name]
        assert (tuple(pt.shape), np.dtype(pt.dtype), pt.quant) == (
            tuple(jt.shape), np.dtype(jt.dtype), jt.quant), name
        assert (pt.data is None) == (jt.data is None), name
        if pt.data is not None:
            assert pt.data.dtype == jt.data.dtype, name
            np.testing.assert_array_equal(pt.data, jt.data, err_msg=name)


# -- the fixtures ------------------------------------------------------------


@pytest.mark.parametrize("size,kw", [
    ("n", dict(in_hw=(64, 64), w_scale=W_SCALE)),
    ("s", dict(in_hw=(64, 64))),
    ("n", dict(in_hw=(32, 32), w_scale_run=False, num_classes=3)),
], ids=["n-64", "s-64", "n-noscales"])
def test_yolo_fixture_bytes_equal_jax(size, kw):
    got, g = F.build_yolo_mgk(size, **kw)
    want, jg = JF.build_yolo_mgk(size, **kw)
    assert got == want
    assert_same_graph(g, jg)


def test_build_elf32_bytes_equal_jax():
    ro = b"500_QuantizeConv2D\x00layer_3_QuantizeGRU\x00"
    syms = [("conv2d_int8_param_init", 0x40, 8), ("gru_param_init", 0, 4)]
    extra = {".text": b"\x90" * 33}
    assert F.build_elf32(ro, syms, b"\x07" * 99, extra) == \
        JF.build_elf32(ro, syms, b"\x07" * 99, extra)
    assert F.build_elf32(b"") == JF.build_elf32(b"")


def test_aec_fixture_parses_in_both(aec):
    assert aec == F.build_aec_mgk(0) != F.build_aec_mgk(1)
    for pkg in (MGK, JMGK):
        elf, meta = pkg.load_mgk(aec)
        assert {"GRU", "Feature", "BatchNorm"} <= {l.kind for l in
                                                   meta.layers}
        assert len(elf.appended) == F.AEC_BLOB_BYTES
        w = pkg.extract_aec_model(elf)
        assert all(np.isfinite(v).all() for v in w.values())
    ro = MGK.parse_elf(aec).section_bytes(".rodata")
    for _, _, sc_off in MGK.AEC_SEQ_LAYOUT.values():
        s = float(np.frombuffer(ro[sc_off:sc_off + 4], "<f4")[0])
        assert 1e-3 <= s <= 1e-1


# -- ELF and .rodata ---------------------------------------------------------


FIXTURES = ("yolo", "aec", "layer_param")


def _fixture_bytes(name, yolo, aec):
    return {"yolo": yolo[0], "aec": aec, "layer_param": layer_param_elf()
            }[name]


@pytest.mark.parametrize("name", FIXTURES)
def test_parse_and_mine_equal_jax(name, yolo, aec):
    data = _fixture_bytes(name, yolo, aec)
    assert fields(MGK.parse_elf(data)) == fields(JMGK.parse_elf(data))
    elf, meta = MGK.load_mgk(data)
    jelf, jmeta = JMGK.load_mgk(data)
    assert fields(meta) == fields(jmeta)
    assert fields(MGK.mine_tensor_info(elf.section_bytes(".rodata"))) == \
        fields(JMGK.mine_tensor_info(jelf.section_bytes(".rodata")))
    assert_same_arrays(MGK.extract_weight_table(elf, meta),
                       JMGK.extract_weight_table(jelf, jmeta))
    blob = elf.appended
    np.testing.assert_array_equal(MGK.analyze_blocks(blob),
                                  JMGK.analyze_blocks(blob))
    assert MGK.detect_weight_boundaries(blob) == \
        JMGK.detect_weight_boundaries(blob)
    assert MGK.dense_regions(blob) == JMGK.dense_regions(blob)
    for nm in ("ptq_model_conv_5_Quantize", "layer_46_QuantizeGRU",
               "123_output_last_layer", "x_Quantize", "pool3", "??"):
        assert MGK.classify_layer_name(nm) == JMGK.classify_layer_name(nm)


@pytest.mark.parametrize("name", FIXTURES)
def test_inspect_and_extract_weights_equal_jax(name, yolo, aec, tmp_path):
    path = tmp_path / f"{name}.mgk"
    path.write_bytes(_fixture_bytes(name, yolo, aec))
    assert MGK.inspect_mgk(str(path)) == JMGK.inspect_mgk(str(path))
    MGK.extract_weights(str(path), str(tmp_path / "port"))
    JMGK.extract_weights(str(path), str(tmp_path / "jax"))
    files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "port").iterdir())
    for f in files:
        a, b = np.load(tmp_path / "port" / f), np.load(tmp_path / "jax" / f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_aec_weight_regions_and_gru_blocks(aec):
    elf, meta = MGK.load_mgk(aec)
    table = MGK.extract_weight_table(elf, meta)
    assert {"layer_46_gru_bidir.fwd_w_ir", "layer_37_gru.w_hh",
            "main_conv_region"} <= set(table)
    rng = np.random.default_rng(0)
    blob = rng.integers(-128, 128, 12 * 1024 + 576, dtype=np.int8).tobytes()
    for bidir, b in ((True, blob), (False, blob[:4096]),
                     (True, blob[:12 * 1024])):
        assert_same_arrays(MGK.unpack_gru_blocks(b, bidir),
                           JMGK.unpack_gru_blocks(b, bidir))


def test_unpackers_equal_jax():
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, 4 * 1024, dtype=np.uint8).tobytes()
    np.testing.assert_array_equal(MGK.unpack_2bit_signed(data[:77]),
                                  JMGK.unpack_2bit_signed(data[:77]))
    for oc, ic, kh, kw in ((32, 32, 1, 1), (40, 20, 1, 1), (32, 32, 2, 2)):
        got = MGK.unpack_nmhwsoib2_2bit(data, oc, ic, kh, kw)
        want = JMGK.unpack_nmhwsoib2_2bit(data, oc, ic, kh, kw)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        MGK.unpack_nmhwsoib2_2bit(data[:100], 32, 32)
    oc, ic, kh, kw = 48, 40, 3, 2
    packed = rng.integers(-128, 128, 2 * 2 * kh * kw * 32 * 32,
                          dtype=np.int8).tobytes()
    np.testing.assert_array_equal(
        MGK.unpack_nmhwsoib2(packed, oc, ic, kh, kw),
        JMGK.unpack_nmhwsoib2(packed, oc, ic, kh, kw))


# -- the YOLO family ---------------------------------------------------------


def test_symbol_decode_equal_jax(yolo, aec):
    for data in (yolo[0], aec, layer_param_elf()):
        assert fields(MY.decode_layers_from_symbols(MGK.parse_elf(data))) \
            == fields(JMY.decode_layers_from_symbols(JMGK.parse_elf(data)))


@pytest.mark.parametrize("size,hw", [("n", (640, 640)), ("s", (64, 64))])
def test_weight_table_equals_jax(size, hw):
    g, entries, total = MY.yolo_weight_table(size, in_hw=hw)
    jg, jentries, jtotal = JMY.yolo_weight_table(size, in_hw=hw)
    assert total == jtotal and fields(entries) == fields(jentries)
    assert_same_graph(g, jg)
    if size == "n":
        assert total == 1_883_956 and len(entries) == 60


def test_family_detection_equals_jax(yolo):
    for size in ("n", "s"):
        data = yolo[0] if size == "n" else F.build_yolo_mgk(
            "s", in_hw=(64, 64))[0]
        elf, meta = MGK.load_mgk(data)
        jelf, jmeta = JMGK.load_mgk(data)
        assert MY.detect_yolo_family(elf, meta) == size == \
            JMY.detect_yolo_family(jelf, jmeta)
    bad = F.build_elf32(b"500_QuantizeConv2D\x00",
                        symbols=[("conv2d_int8_param_init", 0, 4)],
                        appended=b"\x01" * 1000)
    elf, meta = MGK.load_mgk(bad)
    assert MY.detect_yolo_family(elf, meta) is None
    with pytest.raises(MY.UnsupportedMgkError) as got:
        MGK.mgk_to_onnx(bad)
    with pytest.raises(JMY.UnsupportedMgkError) as want:
        JMGK.mgk_to_onnx(bad)
    assert got.value.kinds == want.value.kinds and "Conv" in got.value.kinds
    assert str(got.value) == str(want.value)
    with pytest.raises(MY.UnsupportedMgkError, match="too small"):
        MY.extract_yolo_weights(elf, meta, "n")


@pytest.mark.parametrize("run", [True, False], ids=["scale-run", "default"])
def test_scales_and_extracted_weights_equal_jax(run, yolo):
    data, g0 = yolo if run else F.build_yolo_mgk(
        "n", in_hw=(64, 64), w_scale_run=False)
    elf, meta = MGK.load_mgk(data)
    jelf, jmeta = JMGK.load_mgk(data)
    got, want = MY.mine_w_scales(meta, 60), JMY.mine_w_scales(jmeta, 60)
    if run:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(got, W_SCALE, rtol=1e-6)
    else:
        assert got is None and want is None
    g, w = MY.extract_yolo_weights(elf, meta, "n", in_hw=(64, 64))
    jg, jw = JMY.extract_yolo_weights(jelf, jmeta, "n", in_hw=(64, 64))
    assert_same_graph(g, jg)
    assert_same_arrays(w, jw)
    if run:   # the planted weights, dequantized
        for n in (n for n in g0.nodes if n.op == "CONV2D"):
            t = g0.tensors[n.inputs[1]]
            np.testing.assert_array_equal(
                w[n.inputs[1]], t.data.astype(np.float32)
                * np.float32(t.quant.scale))


# -- ONNX export and import --------------------------------------------------


def test_yolo_onnx_bytes_equal_jax(yolo, tmp_path):
    data = yolo[0]
    path = tmp_path / "y.mgk"
    path.write_bytes(data)
    assert MGK.mgk_to_onnx(str(path)) == JMGK.mgk_to_onnx(str(path))
    elf, meta = MGK.load_mgk(data)
    jelf, jmeta = JMGK.load_mgk(data)
    assert MY.export_yolo_onnx(elf, meta, in_hw=(64, 64)) == \
        JMY.export_yolo_onnx(jelf, jmeta, in_hw=(64, 64))


@pytest.mark.parametrize("streaming", [False, True])
def test_aec_onnx_bytes_and_import_equal_jax(streaming, aec, tmp_path):
    path = tmp_path / "a.mgk"
    path.write_bytes(aec)
    assert MGK.mgk_to_onnx(str(path), streaming) == \
        JMGK.mgk_to_onnx(str(path), streaming)
    assert_same_graph(MGK.import_mgk(str(path), streaming),
                      JMGK.import_mgk(str(path), streaming))


def test_import_mgk_yolo_equals_jax(yolo, tmp_path):
    path = tmp_path / "y.mgk"
    path.write_bytes(yolo[0])
    g = MGK.import_mgk(str(path))
    assert_same_graph(g, JMGK.import_mgk(str(path)))
    assert [g.tensors[o].shape for o in g.outputs] == [
        (1, 80, 80, 255), (1, 40, 40, 255), (1, 20, 20, 255)]


def test_early_conv_probe_in_the_port(yolo):
    """JAX's probe (``tests/test_mgk_yolo.py``): the decompiled graph's 6th
    conv output against the dequantized zoo graph it was packed from, on
    properly scaled inputs, exact tier, ``atol=1e-6``."""
    from thingino_accel_tpu_torch.formats.onnx import import_onnx
    data, g0 = yolo
    elf, meta = MGK.load_mgk(data)
    gi = import_onnx(MY.export_yolo_onnx(elf, meta, in_hw=(64, 64)),
                     float32=True)
    gd = dequantize_graph(g0, quantize_outputs=False)
    early = [n for n in g0.nodes if n.op == "CONV2D"][5].outputs[0]
    assert early in gi.tensors
    in_scale = g0.tensors[g0.inputs[0]].quant.scale
    xq = np.random.default_rng(0).integers(-100, 100, (1, 64, 64, 3),
                                           dtype=np.int8)
    want = Engine(gd.with_outputs([early]), device="cpu").run_np(xq)[early]
    got = Engine(gi.with_outputs([early]), device="cpu").run_np(
        xq.astype(np.float32) * np.float32(in_scale))[early]
    assert float(np.abs(want).max()) > 1e-4, "probe lost signal"
    np.testing.assert_allclose(got, want, atol=1e-6)
    # and JAX's own probe on the same graphs gives the same numbers
    jd = jdequantize(JF.build_yolo_mgk("n", in_hw=(64, 64),
                                       w_scale=W_SCALE)[1],
                     quantize_outputs=False)
    jwant = JEngine(jd.with_outputs([early])).run_np(xq)[early]
    np.testing.assert_allclose(want, jwant, atol=1e-6)


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= AEC_TOL, f"{what}: {err:.3g} of the largest |value|"


def test_aec_streams_with_carried_state(aec, tmp_path):
    """Three 8-frame windows through the streaming AEC graph, gru1's state
    carried: the port's exact tier against JAX's engine on the same graph,
    window by window; the carried state changes the output."""
    path = tmp_path / "a.mgk"
    path.write_bytes(aec)
    g = MGK.import_mgk(str(path), streaming=True)
    jg = JMGK.import_mgk(str(path), streaming=True)
    eng, jeng = Engine(g, device="cpu"), JEngine(jg)
    x_name, h_name = g.inputs
    out, h_out = g.outputs
    rng = np.random.default_rng(5)
    wins = rng.normal(scale=0.5, size=(3, 1, 256, 8)).astype(np.float32)
    h = jh = np.zeros((1, 64, 32), np.float32)
    for i, w in enumerate(wins):
        got = eng.run_np(**{x_name: w, h_name: h})
        want = jeng.run_np(**{x_name: w, h_name: jh})
        assert got[out].shape == (1, 256, 2)
        _close(got[out], want[out], f"window {i} mask")
        _close(got[h_out], want[h_out], f"window {i} state")
        fresh = eng.run_np(**{x_name: w, h_name: np.zeros_like(h)})[out]
        if i:
            assert float(np.abs(got[out] - fresh).max()) > 1e-6
        h, jh = got[h_out], want[h_out]
    assert float(np.abs(h).max()) > 1e-3
    plain = MGK.import_mgk(str(path))
    (o,) = Engine(plain, device="cpu").run_np(wins[0]).values()
    assert o.shape == (1, 256, 2) and 0.0 <= o.min() and o.max() <= 1.0


# -- errors --------------------------------------------------------------------


def test_unsupported_family_kinds_equal_jax(tmp_path):
    cases = {
        "normalize": F.build_elf32(b"some_unknown_blob\x00",
                                   symbols=[("normalize_param_init", 0, 4)]),
        "empty": F.build_elf32(b"mystery\x00"),
        "layer_param": F.build_elf32(b"", symbols=[
            ("magik::venus::layer::PermuteLayerParam", 0, 4)]),
    }
    for name, data in cases.items():
        path = tmp_path / f"{name}.mgk"
        path.write_bytes(data)
        with pytest.raises(MY.UnsupportedMgkError) as got:
            MGK.mgk_to_onnx(str(path))
        with pytest.raises(JMY.UnsupportedMgkError) as want:
            JMGK.mgk_to_onnx(str(path))
        assert got.value.kinds == want.value.kinds, name
        assert isinstance(got.value, ValueError)
    assert MY.UnsupportedMgkError("x", {"b", "a"}).kinds == ["a", "b"]


def test_parse_elf_fuzz_never_crashes(yolo):
    """Corrupted/truncated .mgk bytes fail with ValueError (or parse) in
    the port as in JAX, never an uncontrolled exception: 200 seeded
    single-byte flips biased into the ELF header + section table, plus
    truncations; where both parse, the same sections and symbols."""
    buf = bytearray(yolo[0])
    rng = np.random.default_rng(7)

    def both(data):
        res = []
        for pkg in (MGK, JMGK):
            try:
                res.append(fields(pkg.parse_elf(data)))
            except ValueError as e:
                res.append(("ValueError", str(e)))
        assert res[0] == res[1]

    for cut in (0, 3, 0x20, 0x33, len(buf) // 2, len(buf) - 1):
        both(bytes(buf[:cut]))
    for _ in range(200):
        pos = int(rng.integers(0, 0x400 if rng.random() < 0.5
                               else len(buf)))
        old = buf[pos]
        buf[pos] = int(rng.integers(0, 256))
        try:
            both(bytes(buf))
        finally:
            buf[pos] = old
