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
import time
from pathlib import Path
from typing import Optional, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("mm_int8_fused_mma.cu", "conv_int8_fused_mma.cu",
           "bneck_int8_fused.cu",
           "sppf_int8_fused.cu", "dw_int8_fused.cu", "decode_fused.cu",
           "chain_mma.cu", "megakernel_probe.cu",
           "add_one.cu", "conv_int8_lagged.cu", "conv_int8_requant_mma.cu",
           "nms_fixpoint.cu")
HEADERS = ("epilogue.cuh", "mma_tile.cuh", "chain_mma.cuh",
           "epilogue_policy.cuh", "conv_mma_core.cuh", "hopper_async.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    # n_parts, xs[4], ldx[4], ws[4], ldw[4], K[4], part_scales[4],
    # same_scale, bias, bias_scale, cs, res, out, M, N, act, inv_out,
    # alpha, res_scale, bm, bn, kc, stages, tiles_per_block, compute,
    # stream
    "tat_mm_int8_fused_mma": (
        _I, ctypes.POINTER(_P), ctypes.POINTER(_L), ctypes.POINTER(_P),
        ctypes.POINTER(_I), ctypes.POINTER(_I), ctypes.POINTER(_F), _I, _P,
        _F, _P, _P, _P, _L, _I, _I, _F, _F, _F, _I, _I, _I, _I, _I, _I, _P),
    # n_parts, K[4], same_scale, act, bm, bn, kc, stages, compute, -> smem
    # bytes, blocks an SM
    "tat_mm_int8_fused_mma_info": (_I, ctypes.POINTER(_I), _I, _I, _I, _I,
                                   _I, _I, _I, ctypes.POINTER(_I),
                                   ctypes.POINTER(_I)),
    # the exact tier's #9 on the same kernel: x, w, bias, lut, out, M, N, K,
    # cs, round_mode, relu, bm, bn, kc, stages, tiles_per_block, stream
    "tat_mm_int8_requant_mma": (_P, _P, _P, _P, _P, _L, _I, _I, _F, _I, _I,
                                _I, _I, _I, _I, _I, _P),
    # K, bm, bn, kc, stages, -> smem bytes, blocks an SM
    "tat_mm_int8_requant_mma_info": (_I, _I, _I, _I, _I, ctypes.POINTER(_I),
                                     ctypes.POINTER(_I)),
    # x, w, bias, cs, res, out, batch, H, W, C, O, KH, KW, stride, pt, pl,
    # OH, OW, act, inv_out, alpha, res_scale, mode, tile_h, tile_w, bn, ck,
    # resident, tiles_per_block, compute, stream
    "tat_conv_int8_fused_mma": (_P, _P, _P, _P, _P, _P, *(_I,) * 13, _F, _F,
                                _F, *(_I,) * 8, _P),
    # act, mode, C, KH, KW, stride, tile_h, tile_w, bn, ck, resident,
    # compute, -> smem bytes, blocks an SM
    "tat_conv_int8_fused_mma_info": (*(_I,) * 12, ctypes.POINTER(_I),
                                     ctypes.POINTER(_I)),
    # x, w1, b1, cs1, w2, b2, cs2, out, batch, H, W, C, CM, O, K, act1,
    # inv1, alpha1, act2, inv2, alpha2, shortcut, res_scale, tile_h, tile_w,
    # bn, resident, tiles_per_block, compute, stream
    "tat_bneck_int8_fused": (*(_P,) * 8, *(_I,) * 8, _F, _F, _I, _F, _F, _I,
                             _F, *(_I,) * 6, _P),
    # act1, act2, C, CM, K, tile_h, tile_w, bn, resident, compute, -> smem
    # bytes, blocks an SM
    "tat_bneck_int8_fused_info": (*(_I,) * 10, ctypes.POINTER(_I),
                                  ctypes.POINTER(_I)),
    # y, w, bias, cs, out, batch, H, W, C, O, k, act, inv_out, alpha, bm,
    # bn, ck, tiles_per_block, compute, stream
    "tat_sppf_int8_fused": (*(_P,) * 5, *(_I,) * 7, _F, _F, *(_I,) * 5, _P),
    # act, H, W, C, k, bm, bn, ck, compute, -> smem bytes, blocks an SM
    "tat_sppf_int8_fused_info": (*(_I,) * 9, ctypes.POINTER(_I),
                                 ctypes.POINTER(_I)),
    # x, w, bias, cs, out, batch, H, W, C, KH, KW, pt, pl, OH, OW, act,
    # inv_out, alpha, tile_h, groups, stream
    "tat_dw_int8_fused": (_P, _P, _P, _P, _P, *(_I,) * 11, _F, _F, _I, _I,
                          _P),
    # C, KH, KW, OW, tile_h, groups, -> smem bytes, blocks an SM
    "tat_dw_int8_fused_info": (*(_I,) * 6, ctypes.POINTER(_I),
                               ctypes.POINTER(_I)),
    # x, w, bias, lut, out, batch, H, W, C, O, KH, KW, sh, sw, dh, dw, pt,
    # pl, OH, OW, cs, round_mode, relu, mode, tile_h, tile_w, bn, ck,
    # resident, tiles_per_block, stream
    "tat_conv_int8_requant_mma": (_P, _P, _P, _P, _P, *(_I,) * 15, _F, _I,
                                  _I, *(_I,) * 7, _P),
    # mode, C, KH, KW, sh, sw, dh, dw, tile_h, tile_w, bn, ck, resident,
    # -> smem bytes, blocks an SM
    "tat_conv_int8_requant_mma_info": (*(_I,) * 13, ctypes.POINTER(_I),
                                       ctypes.POINTER(_I)),
    # levels, feats[], H[], W[], strides[], scales[], anchors[], batch, A,
    # NC, is_int8, boxes, conf, cls, stream
    "tat_decode_fused": (_I, ctypes.POINTER(_P), ctypes.POINTER(_I),
                         ctypes.POINTER(_I), ctypes.POINTER(_F),
                         ctypes.POINTER(_F), ctypes.POINTER(_F), _I, _I, _I,
                         _I, _P, _P, _P, _P),
    # the probes (ops/probe_kernels.py): glue, x, w, out, rows, K, L, bm,
    # bn, wslots, stream
    "tat_chain_mma": (_I, _P, _P, _P, _L, _I, _I, _I, _I, _I, _P),
    # glue, K, bm, bn, wslots, -> smem bytes, blocks an SM
    "tat_chain_mma_info": (*(_I,) * 5, ctypes.POINTER(_I),
                           ctypes.POINTER(_I)),
    # glue, x, w, cs, out, rows, K, L, bm, bn, wslots, act, inv_out, alpha,
    # stream
    "tat_megakernel_1x1": (_I, _P, _P, _P, _P, _L, *(_I,) * 6, _F, _F, _P),
    "tat_megakernel_1x1_info": (*(_I,) * 5, ctypes.POINTER(_I),
                                ctypes.POINTER(_I)),
    # one stage of E3's 3x3 kinds: ep, taps, x, w, cs, res, out, xpm, rpm,
    # opm, cells, e, K, act, inv_out, alpha, res_scale, bn, kc, stages,
    # resident, wslots, blocks, stream
    "tat_megakernel_3x3": (_I, _I, *(_P,) * 5, *(_I,) * 7, _F, _F, _F,
                           *(_I,) * 6, _P),
    # ep, taps, K, bn, kc, stages, resident, wslots, -> smem bytes, blocks
    # an SM
    "tat_megakernel_3x3_info": (*(_I,) * 8, ctypes.POINTER(_I),
                                ctypes.POINTER(_I)),
    # x, out, n, stream
    "tat_add_one": (_P, _P, _L, _P),
    # up, keep, batch, K, stream
    "tat_nms_fixpoint": (_P, _P, _I, _I, _P),
    # lag, x, w, bias, cs, out, batch, H, W, C, O, act, inv_out, alpha,
    # bn, stages, blocks, stream
    "tat_conv_int8_lagged": (_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _F, _F, _I, _I, _I, _P),
    # lag, C, bn, stages, -> smem bytes, blocks an SM
    "tat_conv_int8_lagged_info": (_I, _I, _I, _I, ctypes.POINTER(_I),
                                  ctypes.POINTER(_I)),
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


def library_path(sources: Sequence[str] = SOURCES,
                 flags: Sequence[str] = ()) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + tuple(flags)).encode())
    for name in tuple(sources) + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libtat_kernels_{h.hexdigest()[:16]}.so"


def _wait_all(procs, t0: float) -> list:
    """Wait for every process of ``procs``: for each, (seconds from ``t0``
    until it ended, the CPU seconds it and its children used). Each is
    reaped by its own pid, so a build in another thread keeps its own."""
    ended = [None] * len(procs)
    while None in ended:
        for i, proc in enumerate(procs):
            if ended[i] is not None:
                continue
            pid, status, usage = os.wait4(proc.pid, os.WNOHANG)
            if pid:
                proc.returncode = os.waitstatus_to_exitcode(status)
                ended[i] = (time.perf_counter() - t0,
                            usage.ru_utime + usage.ru_stime)
        time.sleep(0.05)
    return ended


def build(sources: Sequence[str] = SOURCES,
          flags: Sequence[str] = ()) -> Path:
    """Compile ``sources`` with ``NVCC_FLAGS`` and ``flags`` unless this
    exact build exists, one ``nvcc`` a source, all at once; return the
    library's path. ``nvcc``'s output (with ``-Xptxas -v``: registers,
    shared memory and spills per kernel), each source's seconds until its
    ``nvcc`` ended and the CPU seconds it used, go to ``<library>.log``."""
    so = library_path(sources, flags)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{so.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(src).stem}.o" for src in sources]
    cmds = [[nvcc, *NVCC_FLAGS, *flags, "-I", str(CSRC), "-c", "-o",
             str(obj), str(CSRC / src)] for src, obj in zip(sources, objs)]
    # each nvcc writes to a file of its own: one whose ptxas report outgrew
    # a pipe would stop until the pipes before it had been read
    outs = [obj.with_suffix(".out") for obj in objs]
    t0 = time.perf_counter()
    procs = []
    for cmd, path in zip(cmds, outs):
        with open(path, "w") as f:
            procs.append(subprocess.Popen(cmd, stdout=f,
                                          stderr=subprocess.STDOUT))
    ended = _wait_all(procs, t0)
    logs, failed = [], []
    for cmd, path, proc, (secs, cpu) in zip(cmds, outs, procs, ended):
        out = path.read_text()
        path.unlink()
        logs.append(f"# {Path(cmd[-1]).name}: {secs:.1f} s, {cpu:.1f} s "
                    f"CPU\n" + " ".join(cmd) + "\n" + out)
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


def _bind(lib: ctypes.CDLL, names) -> ctypes.CDLL:
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = list(_SIGNATURES[name])
        fn.restype = ctypes.c_int
    return lib


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once per process."""
    global _library
    if _library is None:
        _library = _bind(ctypes.CDLL(str(build())), _SIGNATURES)
    return _library


def load_variant(source: str, flags: Sequence[str],
                 entries: Sequence[str]) -> ctypes.CDLL:
    """``source`` alone, built with the extra nvcc ``flags`` (``-D...``)
    into a library of its own, its ``entries`` bound: a variant compiled
    for a measurement, which no wrapper loads."""
    return _bind(ctypes.CDLL(str(build((source,), flags))), entries)


def check(rc: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")
