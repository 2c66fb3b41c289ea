"""Build and load the port's hand-written CUDA kernels.

The sources under ``thingino_accel_tpu_torch/csrc/`` are compiled by
``nvcc`` for Hopper (``sm_90a``) into one shared library with a plain C
interface, loaded with :mod:`ctypes`. That takes seconds, where a
PyTorch C++ extension (which includes the torch headers) takes minutes.

The library is built at first use into ``build/kernels/`` at the root of
the checkout, named by a hash of the sources and flags, so an edited
source is rebuilt and an unchanged one is reused. Each source compiles
in its own ``nvcc`` process, all started together, and one more links
them. There is no fallback: a missing ``nvcc`` or a failed build raises.
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
SOURCES = ("mm_int8_fused.cu", "conv_int8_fused.cu", "mm_multi_int8_fused.cu",
           "bneck_int8_fused.cu", "sppf_int8_fused.cu", "dw_int8_fused.cu",
           "decode_fused.cu", "requant_int8.cu", "conv_int8_dma.cu")
HEADERS = ("epilogue.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    # x, w, bias, cs, res, out, M, N, K, act, inv_out, alpha, res_scale,
    # stream
    "tat_mm_int8_fused": (_P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _F, _F,
                          _F, _P),
    # x, w, bias, cs, res, out, batch, H, W, C, O, KH, KW, stride, pt, pl,
    # OH, OW, act, inv_out, alpha, res_scale, stream
    "tat_conv_int8_fused": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _I, _I, _I, _I, _I, _I, _I, _F, _F, _F, _P),
    # n_parts, xs[4], ldx[4], ws[4], ldw[4], K[4], part_scales[4],
    # same_scale, bias, bias_scale, cs, res, out, M, N, act, inv_out,
    # alpha, res_scale, stream
    "tat_mm_multi_int8_fused": (
        _I, ctypes.POINTER(_P), ctypes.POINTER(_L), ctypes.POINTER(_P),
        ctypes.POINTER(_I), ctypes.POINTER(_I), ctypes.POINTER(_F), _I, _P,
        _F, _P, _P, _P, _L, _I, _I, _F, _F, _F, _P),
    # x, w1, b1, cs1, w2, b2, cs2, out, batch, H, W, C, CM, O, K, TH,
    # act1, inv1, alpha1, act2, inv2, alpha2, shortcut, res_scale, stream
    "tat_bneck_int8_fused": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _I, _I, _I, _I, _I, _F, _F, _I, _F, _F, _I, _F,
                             _P),
    # x, w, bias, cs, out, batch, H, W, C, O, k, act, inv_out, alpha,
    # stream
    "tat_sppf_int8_fused": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            _F, _F, _P),
    # x, w, bias, cs, out, batch, H, W, C, O, KH, KW, stride, pt, pl, OH,
    # OW, act, inv_out, alpha, tile_h, tile_w, ck, resident,
    # tiles_per_block, then fused_kernels.DmaLayout's ten fields, stream
    "tat_conv_int8_dma": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                          _I, _I, _I, _I, _I, _F, _F, _I, _I, _I, _I, _I,
                          *(_I,) * 10, _P),
    # x, w, bias, cs, out, batch, H, W, C, KH, KW, pt, pl, OH, OW, act,
    # inv_out, alpha, stream
    "tat_dw_int8_fused": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                          _I, _I, _I, _F, _F, _P),
    # x, w, bias, out, M, N, K, cs, round_mode, relu, stream
    "tat_mm_int8_requant": (_P, _P, _P, _P, _L, _I, _I, _F, _I, _I, _P),
    # x, w, bias, out, batch, H, W, C, O, KH, KW, sh, sw, dh, dw, pt, pl,
    # OH, OW, cs, round_mode, relu, stream
    "tat_conv_int8_requant": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                              _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P),
    # levels, feats[], H[], W[], strides[], scales[], anchors[], batch, A,
    # NC, is_int8, boxes, conf, cls, stream
    "tat_decode_fused": (_I, ctypes.POINTER(_P), ctypes.POINTER(_I),
                         ctypes.POINTER(_I), ctypes.POINTER(_F),
                         ctypes.POINTER(_F), ctypes.POINTER(_F), _I, _I, _I,
                         _I, _P, _P, _P, _P),
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
    nvcc = find_nvcc()
    tag = f"{so.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(src).stem}.o" for src in SOURCES]
    cmds = [[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj),
             str(CSRC / src)] for src, obj in zip(SOURCES, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs, failed = [], []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        logs.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} ({proc.returncode}):\n{out[-4000:]}")
    tmp = so.with_name(f"{tag}.so.tmp")
    if not failed:
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        logs.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link ({proc.returncode}):\n{proc.stderr[-4000:]}")
    so.with_suffix(".log").write_text("".join(logs))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, so)   # atomic: no process loads half a file
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
