"""Build and load the port's hand-written CUDA kernels.

The sources under ``thingino_accel_tpu_torch/csrc/`` are compiled by
``nvcc`` for Hopper (``sm_90a``) into one shared library with a plain C
interface, loaded with :mod:`ctypes`. That takes seconds, where a
PyTorch C++ extension (which includes the torch headers) takes minutes.

The library is built at first use into ``build/kernels/`` at the root of
the checkout, named by a hash of the sources and flags, so an edited
source is rebuilt and an unchanged one is reused. There is no fallback:
a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("mm_int8_fused.cu", "conv_int8_fused.cu")
HEADERS = ("epilogue.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # x, w, bias, cs, out, M, N, K, act, inv_out, alpha, stream
    "tat_mm_int8_fused": (_P, _P, _P, _P, _P, ctypes.c_longlong, _I, _I,
                          _I, _F, _F, _P),
    # x, w, bias, cs, out, batch, H, W, C, O, KH, KW, stride, pt, pl,
    # OH, OW, act, inv_out, alpha, stream
    "tat_conv_int8_fused": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            _I, _I, _I, _I, _I, _I, _F, _F, _P),
}

_library: Optional[ctypes.CDLL] = None


def find_nvcc() -> str:
    """``nvcc`` from PATH, else under ``$CUDA_HOME`` (default
    ``/usr/local/cuda``, the toolkit's standard prefix)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the port's CUDA kernels "
        "cannot be built")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libtat_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless this exact build exists; return the
    library's path. ``nvcc``'s output (with ``-Xptxas -v``: registers,
    shared memory and spills per kernel) goes to ``<library>.log``."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    so.with_suffix(".log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, so)   # atomic: a concurrent process never loads half a file
    return so


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once per process."""
    global _library
    if _library is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _library = lib
    return _library


def check(rc: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")
