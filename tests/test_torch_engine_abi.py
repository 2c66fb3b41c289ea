"""The port's C ABI engine shim (``thingino_accel_tpu_torch/csrc/
tat_engine.cpp``, built by ``native.engine_lib`` with g++ into
``build/native/``) against the JAX package's (the committed
``csrc/libtat_engine.so``), both driven through ctypes as a C host calls
them, on the committed ``models/fixtures/test_conv.mars`` and seeded
input bytes:

- the port's shim builds at first use, outside ``csrc/``, and keeps
  ``csrc/tat_engine.h``'s ABI version;
- with ``api.nna_init("cpu")`` its output bytes equal those of JAX's
  ``Engine.from_mars(fixture).run_np`` (and of JAX's shim);
- the counts, names, ranks, shapes, byte sizes and dtype strings of the
  inputs and outputs are JAX's shim's;
- the error paths are JAX's shim's: a missing file and a null path give
  NULL with ``tat_last_error`` naming them; with nothing bound the shim
  takes the card, so without one the load fails and says so.
"""

import ctypes
import os

import numpy as np
import pytest
import torch

from thingino_accel_tpu.runtime import Engine as JEngine
from thingino_accel_tpu_torch import api
from thingino_accel_tpu_torch import native as N
from thingino_accel_tpu_torch.runtime.engine import Engine

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FIXTURE = os.path.join(REPO, "models", "fixtures", "test_conv.mars")
JAX_SHIM = os.path.join(REPO, "csrc", "libtat_engine.so")


def _typed(lib):
    """JAX's shim typed as the port's loader types its own."""
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, res, args in (
            ("tat_model_load", P, [ctypes.c_char_p]),
            ("tat_model_run", I, [P]), ("tat_model_unload", None, [P]),
            ("tat_model_num_inputs", I, [P]),
            ("tat_model_num_outputs", I, [P]),
            ("tat_model_get_input", P, [P, ctypes.c_uint32]),
            ("tat_model_get_output", P, [P, ctypes.c_uint32]),
            ("tat_tensor_name", ctypes.c_char_p, [P]),
            ("tat_tensor_ndim", I, [P]),
            ("tat_tensor_shape", ctypes.POINTER(ctypes.c_int64), [P]),
            ("tat_tensor_bytes", ctypes.c_int64, [P]),
            ("tat_tensor_dtype", ctypes.c_char_p, [P]),
            ("tat_tensor_data", P, [P]),
            ("tat_last_error", ctypes.c_char_p, []),
            ("tat_engine_abi_version", I, [])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


@pytest.fixture(scope="module")
def shims():
    if not os.path.exists(JAX_SHIM):
        pytest.skip("libtat_engine.so not built (run make -C csrc)")
    port = N.engine_lib()
    api.nna_init("cpu")
    yield {"port": port, "jax": _typed(ctypes.CDLL(JAX_SHIM))}
    api.nna_deinit()


def _meta(lib, t):
    n = lib.tat_tensor_ndim(t)
    return (lib.tat_tensor_name(t), n,
            [lib.tat_tensor_shape(t)[i] for i in range(n)],
            lib.tat_tensor_bytes(t), lib.tat_tensor_dtype(t))


def _run(lib, payload: bytes):
    """Load the fixture, write ``payload`` into its input, run; returns
    the inputs' and outputs' metadata and the outputs' bytes."""
    m = lib.tat_model_load(FIXTURE.encode())
    assert m, lib.tat_last_error()
    try:
        ins = [_meta(lib, lib.tat_model_get_input(m, i))
               for i in range(lib.tat_model_num_inputs(m))]
        outs = [lib.tat_model_get_output(m, i)
                for i in range(lib.tat_model_num_outputs(m))]
        tin = lib.tat_model_get_input(m, 0)
        assert lib.tat_tensor_bytes(tin) == len(payload)
        ctypes.memmove(lib.tat_tensor_data(tin), payload, len(payload))
        assert lib.tat_model_run(m) == 0, lib.tat_last_error()
        data = [ctypes.string_at(lib.tat_tensor_data(t),
                                 lib.tat_tensor_bytes(t)) for t in outs]
        return ins, [_meta(lib, t) for t in outs], data
    finally:
        lib.tat_model_unload(m)


def test_shim_builds_outside_csrc(shims):
    paths = list(N.BUILD_DIR.glob("libtat_engine_*.so"))
    assert paths and all("csrc" not in p.parts[-3:] for p in paths)
    assert (shims["port"].tat_engine_abi_version()
            == shims["jax"].tat_engine_abi_version() == 1)


@pytest.mark.parametrize("seed", [0, 1])
def test_output_bytes_equal_jax(shims, seed):
    jeng = JEngine.from_mars(FIXTURE)
    shape = jeng.graph.tensors[jeng.graph.inputs[0]].shape
    x = np.random.default_rng(seed).integers(-128, 128, shape,
                                             dtype=np.int8)
    ins, outs, data = _run(shims["port"], x.tobytes())
    j_ins, j_outs, j_data = _run(shims["jax"], x.tobytes())
    assert (ins, outs) == (j_ins, j_outs)
    assert len(ins) == 1 and ins[0][4] == b"int8" and len(outs) >= 1
    want = jeng.run_np(x)
    assert data == j_data == [np.ascontiguousarray(v).tobytes()
                              for v in want.values()]
    got = Engine.from_mars(FIXTURE, device="cpu").run_np(x)
    assert data == [v.tobytes() for v in got.values()]
    assert any(np.frombuffer(d, np.int8).any() for d in data)


@pytest.mark.parametrize("path", [b"/nonexistent/model.mars", None])
def test_error_paths_match_jax(shims, path):
    for lib in shims.values():
        assert not lib.tat_model_load(path)
        err = lib.tat_last_error().decode()
        assert ("null path" if path is None else path.decode()) in err


def test_nothing_bound_takes_the_card(shims):
    lib = shims["port"]
    api.nna_deinit()
    try:
        m = lib.tat_model_load(FIXTURE.encode())
        if torch.cuda.is_available():
            assert m
            lib.tat_model_unload(m)
        else:
            assert not m and "CUDA" in lib.tat_last_error().decode()
    finally:
        api.nna_init("cpu")
