"""The port's C-API-shaped shim (``thingino_accel_tpu_torch.api``) against
the JAX package's ``api.py``: the call sequences of the reference examples
(``examples/test_init.c``, ``test_model_load.c``, ``mars_test.c``) through
both, the port bound to the CPU (``nna_init(device="cpu")``):

- ``nna_init`` / ``nna_get_hw_info`` / ``nna_lock`` / ``nna_unlock`` /
  ``nna_deinit``; without a card ``nna_init()`` returns ``NNA_ERROR`` and a
  load with nothing bound fails with ``MARS_ERR_NNA_INIT_FAILED``;
- ``mars_*`` on the committed int8 and float32 fixtures: the same counts,
  tensor descriptors and outputs (bit for bit, int8 and float32 exact
  tier), and the same error code and string for a bad magic, a version
  mismatch, a truncated file and a missing file;
- ``nna_model_*`` and ``BaseNet``: the same info, lookups, run codes,
  outputs and forward memory size;
- ``nna_model_load`` of the YOLO `.mgk` fixture (decompiled to float32,
  the exact tier at 640x640): the same outputs within ``FLOAT_TOL`` of the
  largest |output|; of an unknown family and of a corrupt file: ``None``
  and JAX's error code and message;
- the AIP shims: ``aip_resize`` and ``aip_perspective`` bit for bit on
  seeded uint8 images (``tests/test_torch_image.py`` says where the float
  sums part), ``aip_conv2d`` within ``FLOAT_TOL``.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thingino_accel_tpu import api as JA
from thingino_accel_tpu_torch import api as A
from thingino_accel_tpu_torch.models import mgk_fixtures as F

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
INT8 = os.path.join(REPO, "models", "fixtures", "tiny_160_int8.mars")
F32 = os.path.join(REPO, "models", "fixtures", "tiny_160_f32.mars")
FLOAT_TOL = 1e-5     # of the largest |output|: float32 convs, two engines


@pytest.fixture
def cpu():
    assert A.nna_init(device="cpu") == A.NNA_SUCCESS
    yield
    A.nna_deinit()


def _fill(t, seed):
    rng = np.random.default_rng(seed)
    if np.issubdtype(t.dtype, np.integer):
        return rng.integers(-128, 128, t.shape).astype(t.dtype)
    return rng.normal(size=t.shape).astype(t.dtype)


def _close(got, want):
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= FLOAT_TOL * scale


def test_init_sequence(cpu):
    info = A.nna_get_hw_info()
    assert (info.platform, info.device_kind, info.num_devices,
            info.memory_stats) == ("cpu", "cpu", 1, None)
    assert JA.nna_init() == JA.NNA_SUCCESS
    assert JA.nna_get_hw_info().platform == info.platform
    assert A.nna_lock() == A.nna_unlock() == A.NNA_SUCCESS == \
        JA.nna_lock(5) == JA.nna_unlock()
    assert A.nna_deinit() == A.NNA_SUCCESS == JA.nna_deinit()
    assert A._device is None
    assert (A.NNA_SUCCESS, A.NNA_ERROR) == (JA.NNA_SUCCESS, JA.NNA_ERROR)


def test_without_a_card_init_fails_and_loads_fail():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default binds it")
    A.nna_deinit()
    assert A.nna_init() == A.NNA_ERROR and A._device is None
    err, model = A.mars_load_file(INT8)
    assert (err, model) == (A.MARS_ERR_NNA_INIT_FAILED, None)
    assert A.nna_model_load(INT8) is None
    assert A.nna_get_load_error() == (A.MARS_ERR_NNA_INIT_FAILED,
                                      "NNA initialization failed")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        A.nna_get_hw_info()


def test_error_codes_and_strings_equal_jax():
    names = [n for n in dir(JA) if n.startswith("MARS_")]
    assert len(names) == 9
    for n in names:
        assert getattr(A, n) == getattr(JA, n), n
        code = getattr(JA, n)
        assert A.mars_get_error_string(code) == \
            JA.mars_get_error_string(code)
    assert A.mars_get_error_string(-99) == "Unknown error" == \
        JA.mars_get_error_string(-99)
    assert A.__all__ == JA.__all__


@pytest.mark.parametrize("model", [INT8, F32], ids=["int8", "f32"])
def test_mars_load_run_flow_equals_jax(model, cpu, capsys):
    """mars_test.c: load -> summary -> fill input -> run -> output."""
    err, m = A.mars_load_file(model)
    jerr, jm = JA.mars_load_file(model)
    assert err == jerr == A.MARS_OK
    assert (A.mars_get_num_inputs(m), A.mars_get_num_outputs(m)) == (
        JA.mars_get_num_inputs(jm), JA.mars_get_num_outputs(jm)) == (1, 1)
    for get in ("mars_get_input", "mars_get_output"):
        t, jt = getattr(A, get)(m, 0), getattr(JA, get)(jm, 0)
        assert (t.name, t.shape, t.dtype, t.scale, t.zero_point) == (
            jt.name, jt.shape, jt.dtype, jt.scale, jt.zero_point)
        assert getattr(A, get)(m, 1) is None is getattr(JA, get)(jm, 1)
        assert getattr(A, get)(None, 0) is None
    x = _fill(A.mars_get_input(m, 0), 0)
    A.mars_get_input(m, 0).set_data(x)
    JA.mars_get_input(jm, 0).set_data(x)
    assert A.mars_run(m) == JA.mars_run(jm) == A.MARS_OK
    got, want = A.mars_get_output(m, 0), JA.mars_get_output(jm, 0)
    assert got.data.shape == got.shape == want.data.shape
    assert got.data.dtype == want.data.dtype
    np.testing.assert_array_equal(got.data, want.data)
    A.mars_print_summary(m)
    assert "Engine[exact, cpu]" in capsys.readouterr().out
    A.mars_free(m)
    assert A.mars_run(None) == JA.mars_run(None) == A.MARS_ERR_INVALID_FILE
    assert A.mars_get_num_inputs(None) == 0 == A.mars_get_num_outputs(None)


def _bad_files(tmp_path):
    good = open(INT8, "rb").read()
    version = bytearray(good)
    version[4:6] = (99).to_bytes(2, "little")
    return {"magic": b"XXXX" + b"\x00" * 100, "version": bytes(version),
            "truncated": good[:40], "missing": None}


def test_mars_error_codes_equal_jax(cpu, tmp_path):
    for name, data in _bad_files(tmp_path).items():
        path = tmp_path / f"{name}.mars"
        if data is not None:
            path.write_bytes(data)
        err, model = A.mars_load_file(str(path))
        jerr, _ = JA.mars_load_file(str(path))
        assert (err, model) == (jerr, None), name
        assert A.nna_model_load(str(path)) is None
        assert JA.nna_model_load(str(path)) is None
        assert A.nna_get_load_error() == JA.nna_get_load_error(), name
    codes = {n: A.mars_load_file(str(tmp_path / f"{n}.mars"))[0]
             for n in ("magic", "version", "missing")}
    assert codes == {"magic": A.MARS_ERR_INVALID_MAGIC,
                     "version": A.MARS_ERR_VERSION_MISMATCH,
                     "missing": A.MARS_ERR_INVALID_FILE}
    for data in (b"XXXX" + b"\x00" * 100, b"XXXX" + b"\x00" * 20):
        assert A.mars_load_memory(data)[0] == JA.mars_load_memory(data)[0]


def test_nna_model_api_equals_jax(cpu):
    """test_model_load.c via the generic nna_model_* surface."""
    m, jm = A.nna_model_load(F32), JA.nna_model_load(F32)
    assert A.nna_get_load_error() == JA.nna_get_load_error() == (0, "")
    info, jinfo = A.nna_model_get_info(m), JA.nna_model_get_info(jm)
    assert (info.name, info.num_inputs, info.num_outputs,
            info.num_layers) == (jinfo.name, jinfo.num_inputs,
                                 jinfo.num_outputs, jinfo.num_layers)
    assert info.num_layers == 3        # the committed fixture (C.1)
    t = A.nna_model_get_input(m, 0)
    assert A.nna_model_get_input_by_name(m, t.name) is t
    assert A.nna_model_get_input_by_name(m, "nope") is None
    o = A.nna_model_get_output(m)
    assert A.nna_model_get_output_by_name(m, o.name) is o
    assert A.nna_model_get_output(m, 99) is None
    assert A.nna_model_get_info(None) is None
    x = _fill(t, 1)
    t.set_data(x)
    JA.nna_model_get_input(jm, 0).set_data(x)
    assert A.nna_model_run(m) == JA.nna_model_run(jm) == 0
    np.testing.assert_array_equal(o.data, JA.nna_model_get_output(jm).data)
    assert A.nna_model_run(None) == -1 == JA.nna_model_run(None)
    A.nna_model_unload(m)


def test_tensor_set_data_validates():
    t = A.Tensor("x", (1, 4, 4, 3), np.int8)
    with pytest.raises(ValueError):
        t.set_data(np.zeros((2, 4, 4, 3), np.int8))
    t.set_data(np.ones((1, 4, 4, 3)))
    assert t.data.dtype == np.int8


def test_basenet_equals_jax(cpu):
    """basenet.cpp:20-60 call sequence through both facades."""
    net, jnet = A.BaseNet(), JA.BaseNet()
    assert net.run() == -1 == jnet.run()
    assert net.get_forward_memory_size() == 0
    assert net.load_model(INT8) == 0 == jnet.load_model(INT8)
    t = net.get_input(0)
    assert net.get_input_by_name(t.name) is t
    x = _fill(t, 2)
    t.set_data(x)
    jnet.get_input(0).set_data(x)
    assert net.run() == 0 == jnet.run()
    np.testing.assert_array_equal(net.get_output(0).data,
                                  jnet.get_output(0).data)
    assert net.get_forward_memory_size() == \
        jnet.get_forward_memory_size() > 0
    assert net.load_model("missing.mars") == -1


def test_nna_model_load_yolo_mgk_equals_jax(cpu, tmp_path):
    """A recognized YOLO-family .mgk loads through the same C-API entry
    as .mars files: decompiled, imported in float32, the exact tier."""
    data, _ = F.build_yolo_mgk("n", in_hw=(64, 64), w_scale=0.002)
    path = tmp_path / "yolo.mgk"
    path.write_bytes(data)
    m, jm = A.nna_model_load(str(path)), JA.nna_model_load(str(path))
    assert A.nna_get_load_error() == JA.nna_get_load_error() == (0, "")
    assert m.engine.options.precision == "exact"
    info = A.nna_model_get_info(m)
    assert (info.num_inputs, info.num_outputs, info.num_layers) == (
        1, 3, JA.nna_model_get_info(jm).num_layers)
    t = A.nna_model_get_input(m)
    assert t.shape == (1, 640, 640, 3) and t.dtype == np.float32
    x = (np.random.default_rng(3).integers(0, 256, t.shape)
         .astype(np.float32) - 128) * np.float32(0.05)
    t.set_data(x)
    JA.nna_model_get_input(jm).set_data(x)
    assert A.nna_model_run(m) == JA.nna_model_run(jm) == 0
    for i in range(3):
        got = A.nna_model_get_output(m, i).data
        want = JA.nna_model_get_output(jm, i).data
        assert got.shape == want.shape == A.nna_model_get_output(m, i).shape
        _close(got, want)


def test_nna_model_load_structured_errors_equal_jax(cpu, tmp_path):
    cases = {
        "unknown": F.build_elf32(b"mystery\x00",
                                 symbols=[("normalize_param_init", 0, 4)]),
        "corrupt": b"\x00" * 64,
        "tiny-blob": F.build_elf32(
            b"500_QuantizeConv2D\x00",
            symbols=[("conv2d_int8_param_init", 0, 4)],
            appended=b"\x01" * 1000),
    }
    for name, data in cases.items():
        path = tmp_path / f"{name}.mgk"
        path.write_bytes(data)
        assert A.nna_model_load(str(path)) is None
        assert JA.nna_model_load(str(path)) is None
        assert A.nna_get_load_error() == JA.nna_get_load_error(), name
    path = tmp_path / "unknown.mgk"
    assert A.nna_model_load(str(path)) is None
    code, msg = A.nna_get_load_error()
    assert code == A.MARS_ERR_INVALID_FILE and "Normalize" in msg
    assert A.nna_model_load(str(tmp_path / "missing.mgk")) is None
    assert A.nna_get_load_error()[0] == A.MARS_ERR_INVALID_FILE


def test_aip_shims_equal_jax(cpu):
    """AIP pipe shims (include/aip.h:118-135 call shapes)."""
    ctx, jctx = A.aip_init(), JA.aip_init()
    img = np.random.default_rng(1).integers(0, 256, (2, 8, 8, 3),
                                            dtype=np.uint8)
    for out in ((16, 16), (5, 11)):
        got = A.aip_resize(ctx, img, *out)
        assert got.dtype == torch.uint8 and got.device.type == "cpu"
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(JA.aip_resize(jctx, jnp.asarray(img),
                                                  *out)))
    np.testing.assert_array_equal(
        A.aip_resize(ctx, torch.from_numpy(img), 4, 4).numpy(),
        np.asarray(JA.aip_resize(jctx, jnp.asarray(img), 4, 4)))
    m = np.array([[1.0, 0.1, 0.5], [0.05, 0.9, 1.0], [0.001, 0.0, 1.0]],
                 np.float32)
    for mat, fill in ((np.eye(3), 0.0), (m, 7.0)):
        np.testing.assert_array_equal(
            A.aip_perspective(ctx, img, mat, 8, 6, fill).numpy(),
            np.asarray(JA.aip_perspective(jctx, jnp.asarray(img), mat, 8,
                                          6, fill)))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 8, 8, 4)).astype(np.float32)
    w = rng.normal(size=(3, 3, 4, 8)).astype(np.float32)
    b = rng.normal(size=(8,)).astype(np.float32)
    for stride, pad, bias in ((1, 1, None), (2, 0, b)):
        got = A.aip_conv2d(ctx, x, w, bias, stride, pad).numpy()
        want = np.asarray(JA.aip_conv2d(jctx, jnp.asarray(x), jnp.asarray(w),
                                        None if bias is None else
                                        jnp.asarray(bias), stride, pad))
        assert got.shape == want.shape
        _close(got, want)
    assert A.aip_f_wait(ctx) == 0 == JA.aip_f_wait(jctx)
    A.aip_cleanup(ctx)
