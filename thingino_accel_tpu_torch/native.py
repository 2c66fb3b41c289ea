"""ctypes bindings for the native host runtime, ``csrc/tat_native.cpp``,
and the port's C ABI engine shim, ``thingino_accel_tpu_torch/csrc/
tat_engine.cpp`` (:func:`engine_lib`).

Port of ``thingino_accel_tpu.native`` over the repository's own C++
source, used as it is: host-side weight packing, JPEG decode (libjpeg),
letterbox, space-to-depth, input quantization and NMS on numpy arrays.
The library is built at first use with g++ (the flags of
``csrc/Makefile``'s ``libtat_native.so`` rule) into ``build/native/`` at
the root of the checkout, named by a hash of the source and the flags;
nothing is written into ``csrc/``. Where no compiler or no libjpeg is
there, :func:`load` returns None and :func:`available` False, and each
entry point runs the port's Python counterpart (``formats.packing``,
``models.yolo``, PIL for JPEG). No device path calls this module.

The engine shim embeds CPython and drives the port's ``Engine`` behind
``csrc/tat_engine.h``'s ABI, for a C host (linked against libpython) or a
Python process (through ctypes). :func:`engine_lib` builds it at first use
with g++ (the flags of ``csrc/Makefile``'s ``libtat_engine.so`` rule but
``-fopenmp``, the Python flags from ``sysconfig``) into ``build/native/``,
and raises where it cannot build or load it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sysconfig
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_ROOT = Path(__file__).resolve().parents[1]
SOURCE = _ROOT / "csrc" / "tat_native.cpp"
BUILD_DIR = _ROOT / "build" / "native"
# csrc/Makefile: CXXFLAGS of $(TARGET), then LIBS
CXXFLAGS = ("-O3", "-fPIC", "-shared", "-fopenmp", "-Wall", "-std=c++17")
LIBS = ("-ljpeg",)

ENGINE_SOURCE = _ROOT / "thingino_accel_tpu_torch" / "csrc" / "tat_engine.cpp"
ENGINE_HEADER = _ROOT / "csrc" / "tat_engine.h"
# the Makefile's CXXFLAGS without -fopenmp: the shim has no parallel loop,
# and a toolchain without libgomp then builds it too
ENGINE_CXXFLAGS = tuple(f for f in CXXFLAGS if f != "-fopenmp")
ENGINE_ABI_VERSION = 1

_lib: Optional[ctypes.CDLL] = None
_tried = False
_engine: Optional[ctypes.CDLL] = None


def _hashed_path(name: str, sources, flags) -> Path:
    """``build/native/lib<name>_<hash of the sources and flags>.so``."""
    h = hashlib.sha256()
    for src in sources:
        h.update(src.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _lib_path() -> Path:
    return _hashed_path("tat_native", (SOURCE,), CXXFLAGS + LIBS)


def _compile(path: Path, args) -> None:
    """g++ ``args`` into a temporary file beside ``path``, then rename it
    into place (processes that build at once each write their own).
    Raises ``RuntimeError`` with the compiler's output where it fails."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler: set CXX or install g++")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *args, "-o", tmp], capture_output=True,
                              text=True, timeout=120)
        if proc.returncode:
            raise RuntimeError(f"g++ failed ({proc.returncode}): "
                               f"{proc.stderr[-2000:]}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _build(path: Path) -> bool:
    if not SOURCE.exists():
        return False
    try:
        _compile(path, [*CXXFLAGS, str(SOURCE), *LIBS])
        return True
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return False


def _python_flags() -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """(compile flags, link flags) of this interpreter from ``sysconfig``:
    its include directory; libpython (``LIBDIR``/``LDLIBRARY``) where it is
    a shared library, else nothing, and the shim then takes CPython's
    symbols from the process that loads it."""
    cflags = ("-I" + sysconfig.get_paths()["include"],)
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    ldlib = sysconfig.get_config_var("LDLIBRARY") or ""
    if ".so" in ldlib and (Path(libdir) / ldlib).exists():
        return cflags, ("-L" + libdir, "-l:" + ldlib,
                        "-Wl,-rpath," + libdir)
    return cflags, ()


def engine_lib() -> ctypes.CDLL:
    """The port's C ABI engine shim, built at first use and loaded once,
    its entry points typed as ``csrc/tat_engine.h`` declares them. Raises
    ``RuntimeError`` where it cannot build or load it, or where its ABI
    version is not ``ENGINE_ABI_VERSION``."""
    global _engine
    if _engine is not None:
        return _engine
    cflags, ldflags = _python_flags()
    flags = ENGINE_CXXFLAGS + cflags + ("-I" + str(ENGINE_HEADER.parent),)
    path = _hashed_path("tat_engine", (ENGINE_SOURCE, ENGINE_HEADER),
                        flags + ldflags)
    if not path.exists():
        _compile(path, [*flags, str(ENGINE_SOURCE), *ldflags])
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeError(f"cannot load {path}: {e}") from e
    P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    for name, res, args in (
            ("tat_init", I, []), ("tat_deinit", None, []),
            ("tat_model_load", P, [ctypes.c_char_p]),
            ("tat_model_run", I, [P]), ("tat_model_unload", None, [P]),
            ("tat_model_num_inputs", I, [P]),
            ("tat_model_num_outputs", I, [P]),
            ("tat_model_get_input", P, [P, U]),
            ("tat_model_get_output", P, [P, U]),
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
    if lib.tat_engine_abi_version() != ENGINE_ABI_VERSION:
        raise RuntimeError(f"{path}: ABI version "
                           f"{lib.tat_engine_abi_version()}, expected "
                           f"{ENGINE_ABI_VERSION}")
    _engine = lib
    return lib


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = _lib_path() if SOURCE.exists() else None
    if path is None or (not path.exists() and not _build(path)):
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    if lib.tat_native_version() != 1:
        return None

    i8p = ctypes.POINTER(ctypes.c_int8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.tat_unpack_nmhwsoib2.argtypes = [
        i8p, ctypes.c_int64, i8p] + [ctypes.c_int] * 4
    lib.tat_pack_nmhwsoib2.argtypes = [i8p, i8p] + [ctypes.c_int] * 4
    lib.tat_decode_jpeg.argtypes = [
        u8p, ctypes.c_int64, u8p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.tat_letterbox_rgb.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, u8p, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint8]
    lib.tat_quantize_i8.argtypes = [u8p, i8p, ctypes.c_int64]
    lib.tat_s2d_u8.argtypes = [u8p] + [ctypes.c_int] * 3 + [u8p]
    lib.tat_s2d_u8.restype = ctypes.c_int
    lib.tat_nms.argtypes = [
        f32p, f32p, i32p, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        i32p, ctypes.c_int]
    lib.tat_nms.restype = ctypes.c_int
    _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


def _i8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def unpack_nmhwsoib2(data: np.ndarray, out_ch: int, in_ch: int,
                     kh: int, kw: int) -> np.ndarray:
    """An NMHWSOIB2 weight blob -> OIHW int8."""
    lib = load()
    src = np.ascontiguousarray(data.view(np.int8).reshape(-1))
    if lib is None:
        from thingino_accel_tpu_torch.formats.packing import (
            unpack_nmhwsoib2 as py)
        return py(src, out_ch, in_ch, kh, kw)
    dst = np.empty((out_ch, in_ch, kh, kw), np.int8)
    rc = lib.tat_unpack_nmhwsoib2(
        _i8(src), src.size, _i8(dst), out_ch, in_ch, kh, kw)
    if rc != 0:
        raise ValueError(f"NMHWSOIB2 blob too small (rc={rc})")
    return dst


def pack_nmhwsoib2(w_oihw: np.ndarray) -> np.ndarray:
    """OIHW int8 -> an NMHWSOIB2 blob."""
    lib = load()
    w = np.ascontiguousarray(w_oihw, np.int8)
    if lib is None:
        from thingino_accel_tpu_torch.formats.packing import (
            pack_nmhwsoib2 as py)
        return py(w)
    o, i, kh, kw = w.shape
    n = -(-o // 32) * -(-i // 32) * kh * kw * 1024
    dst = np.empty((n,), np.int8)
    lib.tat_pack_nmhwsoib2(_i8(w), _i8(dst), o, i, kh, kw)
    return dst


def decode_jpeg(data: bytes, max_hw: Tuple[int, int] = (4320, 7680)
                ) -> np.ndarray:
    """JPEG bytes -> HWC uint8 RGB by libjpeg (PIL where the library is
    unavailable)."""
    lib = load()
    if lib is None:
        from io import BytesIO
        from PIL import Image
        return np.asarray(Image.open(BytesIO(data)).convert("RGB"), np.uint8)
    mh, mw = max_hw
    buf = np.empty((mh * mw * 3,), np.uint8)
    src = np.frombuffer(data, np.uint8)
    ow = ctypes.c_int()
    oh = ctypes.c_int()
    rc = lib.tat_decode_jpeg(_u8(src), src.size, _u8(buf), mw, mh,
                             ctypes.byref(ow), ctypes.byref(oh))
    if rc != 0:
        raise ValueError(f"JPEG decode failed (rc={rc})")
    return buf[:oh.value * ow.value * 3].reshape(oh.value, ow.value, 3).copy()


def letterbox(img: np.ndarray, target: Tuple[int, int],
              pad_value: int = 114) -> np.ndarray:
    """Host letterbox of one HWC uint8 frame (C++ bilinear; where the
    library is unavailable, ``models.yolo.letterbox_uint8`` on the CPU,
    the device path's)."""
    lib = load()
    img = np.ascontiguousarray(img, np.uint8)
    th, tw = target
    if lib is None:
        import torch
        from thingino_accel_tpu_torch.models.yolo import letterbox_uint8
        return letterbox_uint8(torch.from_numpy(img[None]), target,
                               pad_value)[0].numpy()
    h, w, _ = img.shape
    dst = np.empty((th, tw, 3), np.uint8)
    lib.tat_letterbox_rgb(_u8(img), h, w, _u8(dst), th, tw, pad_value)
    return dst


def space_to_depth_u8(img: np.ndarray) -> np.ndarray:
    """2x2 space-to-depth of one HWC uint8 frame -> [H/2, W/2, 4C],
    phase-major channels as ``models.yolo.space_to_depth_frames`` (the
    ingest order of a graph that ``ir.passes.stem_space_to_depth``
    rewrote); C++ with OpenMP, else numpy."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    lib = load()
    if lib is None:
        from thingino_accel_tpu_torch.models.yolo import space_to_depth_frames
        return space_to_depth_frames(img[None])[0]
    dst = np.empty((h // 2, w // 2, 4 * c), np.uint8)
    rc = lib.tat_s2d_u8(_u8(img), h, w, c, _u8(dst))
    if rc != 0:
        raise ValueError(f"space_to_depth needs even dims, got {h}x{w}")
    return dst


def quantize_i8(img_u8: np.ndarray) -> np.ndarray:
    """uint8 -> int8 by subtracting 128."""
    lib = load()
    img_u8 = np.ascontiguousarray(img_u8, np.uint8)
    if lib is None:
        return (img_u8.astype(np.int32) - 128).astype(np.int8)
    dst = np.empty(img_u8.shape, np.int8)
    lib.tat_quantize_i8(_u8(img_u8.reshape(-1)), _i8(dst.reshape(-1)),
                        img_u8.size)
    return dst


def _nms_py(b: np.ndarray, s: np.ndarray, c: np.ndarray, conf_thresh: float,
            iou_thresh: float, max_out: int) -> np.ndarray:
    """JAX's Python fallback: greedy class-aware NMS in score order."""
    keep = []
    order = [i for i in np.argsort(-s) if s[i] >= conf_thresh]
    sup = set()
    for ii, i in enumerate(order):
        if i in sup or len(keep) >= max_out:
            continue
        keep.append(i)
        for j in order[ii + 1:]:
            if j in sup or c[i] != c[j]:
                continue
            x1 = max(b[i, 0] - b[i, 2] / 2, b[j, 0] - b[j, 2] / 2)
            y1 = max(b[i, 1] - b[i, 3] / 2, b[j, 1] - b[j, 3] / 2)
            x2 = min(b[i, 0] + b[i, 2] / 2, b[j, 0] + b[j, 2] / 2)
            y2 = min(b[i, 1] + b[i, 3] / 2, b[j, 1] + b[j, 3] / 2)
            inter = max(0, x2 - x1) * max(0, y2 - y1)
            iou = inter / (b[i, 2] * b[i, 3] + b[j, 2] * b[j, 3]
                           - inter + 1e-6)
            if iou > iou_thresh:
                sup.add(j)
    return np.asarray(keep, np.int32)


def nms(boxes_xywh: np.ndarray, scores: np.ndarray, classes: np.ndarray,
        conf_thresh: float = 0.25, iou_thresh: float = 0.45,
        max_out: int = 300) -> np.ndarray:
    """Host NMS -> kept indices (score-descending)."""
    lib = load()
    b = np.ascontiguousarray(boxes_xywh, np.float32)
    s = np.ascontiguousarray(scores, np.float32)
    c = np.ascontiguousarray(classes, np.int32)
    if lib is None:
        return _nms_py(b, s, c, conf_thresh, iou_thresh, max_out)
    keep = np.empty((max_out,), np.int32)
    n = lib.tat_nms(
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(s), conf_thresh, iou_thresh,
        keep.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), max_out)
    return keep[:n].copy()
