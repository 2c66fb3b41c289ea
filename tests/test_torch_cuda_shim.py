"""The tensor-core CUDA sources (the probes' ``chain_mma.cu``,
``megakernel_probe.cu``, ``add_one.cu``, E2's ``wgmma`` kernel
``conv_int8_lagged.cu``, the
KxK conv core ``conv_mma_core.cuh`` under both its epilogue policies: the
exact tier's ``conv_int8_requant_mma.cu`` and the serving tier's
``conv_int8_fused_mma.cu``, and the 1x1 GEMM ``mm_int8_fused_mma.cu`` of
#1 and #3 and, under the exact policy, of #9, the fused C3 bottleneck
``bneck_int8_fused.cu`` (#6) and the fused SPPF ``sppf_int8_fused.cu`` (#4)
on the core's product and store), the depthwise kernel
#7 ``dw_int8_fused.cu`` and the head decode #8 ``decode_fused.cu``,
compiled for the CPU with g++ and the shim
``tests/cuda_shim/shim.h``, held against their plain versions
(``ops.probe_kernels``, ``ops.requant_kernels``, ``ops.fused_kernels``,
``models.yolo.decode_and_parse``): a rehearsal of
their indexing, their cp.async ring, their ldmatrix / mma.sync fragment
layouts and E2's wgmma descriptors, mbarriers and TMA boxes without a
card. It cannot show what nvcc or the card refuses.

The sources are rewritten into a temporary directory: the cp.async and
the ldmatrix / mma.sync blocks of ``mma_tile.cuh`` (between their
``// ---`` markers), the wgmma / mbarrier / TMA block and the tensor-map
encoding of ``hopper_async.cuh``, the approximate reciprocal of
``epilogue.cuh`` (an exact one here: the Newton step then keeps it), the
volatile shared load of ``dw_int8_fused.cu`` (a plain load here), the byte
permute (``prmt``) of ``sppf_int8_fused.cu`` and the named barriers of
``conv_int8_lagged.cu`` become calls of the shim's emulations (the shim
also emulates DPX ``__vimax3_s16x2``, ``__vmaxs4``, ``__vcmpeq4`` and the
warp shuffles and reduce), the dynamic shared memory its static buffer,
and each ``k<<<grid, block, smem, stream>>>(args)`` a call of
``shim_launch``. The shim runs the copies of a cp.async group only at the
wait that covers it, a wgmma group at the wgmma wait that covers it, a
TMA box when its mbarrier is first waited on, the warp collectives by the
PTX ISA's tables, and each named barrier as a barrier of its thread
count. Skips where g++ is absent.

Tolerances: the int8 kinds without SILU bit-exact; the SILU kinds at most
1 quantum on at most 0.1% of the values after one stage, and at most 2%
of the values differing after two (the host ``expf`` and torch's sigmoid
differ by ulps, and a flipped quantum moves every later stage); bf16
within 2^-7 of the largest output (the emulated sums run in another
order than the plain float64 ones); the decode as on the card (classes
exact, boxes within rtol 1e-6 / atol 1e-5, conf rtol 1e-6 / atol 1e-7).
"""

import ctypes
import dataclasses
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from thingino_accel_tpu_torch.ops import cuda_build
from thingino_accel_tpu_torch.ops import decode_kernel as DK
from thingino_accel_tpu_torch.ops import fused_kernels as FK
from thingino_accel_tpu_torch.ops import probe_kernels as PK
from thingino_accel_tpu_torch.ops import requant_kernels as RK
from thingino_accel_tpu_torch.ops.quant import RoundMode

SHIM = Path(__file__).resolve().parent / "cuda_shim" / "shim.h"
SOURCES = ("chain_mma.cu", "megakernel_probe.cu", "add_one.cu",
           "conv_int8_lagged.cu", "conv_int8_requant_mma.cu",
           "conv_int8_fused_mma.cu", "mm_int8_fused_mma.cu",
           "dw_int8_fused.cu", "bneck_int8_fused.cu", "sppf_int8_fused.cu",
           "decode_fused.cu")
ENTRIES = ("tat_chain_mma", "tat_chain_mma_info", "tat_megakernel_1x1",
           "tat_megakernel_1x1_info", "tat_megakernel_3x3",
           "tat_megakernel_3x3_info", "tat_add_one", "tat_conv_int8_lagged", "tat_conv_int8_lagged_info",
           "tat_conv_int8_requant_mma", "tat_conv_int8_requant_mma_info",
           "tat_conv_int8_fused_mma", "tat_conv_int8_fused_mma_info",
           "tat_mm_int8_fused_mma", "tat_mm_int8_fused_mma_info",
           "tat_mm_int8_requant_mma", "tat_mm_int8_requant_mma_info",
           "tat_dw_int8_fused", "tat_dw_int8_fused_info",
           "tat_bneck_int8_fused", "tat_bneck_int8_fused_info",
           "tat_sppf_int8_fused", "tat_sppf_int8_fused_info",
           "tat_decode_fused")

_CP_ASYNC = """
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  shim_cp_async(dst, src, 16, src_bytes);
}
__device__ __forceinline__ void cp_async_commit() { shim_commit(); }
template <int N>
inline void cp_async_wait() { shim_wait_group(N); }
"""
_MMA = """
inline void ldsm_x4(unsigned (&r)[4], const void* p) { shim_ldsm(r, 4, p); }
inline void ldsm_x2(unsigned (&r)[2], const void* p) { shim_ldsm(r, 2, p); }
inline void mma_s8(int (&d)[4], const unsigned (&a)[4],
                   const unsigned (&b)[2]) { shim_mma_s8(d, a, b); }
inline void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                     const unsigned (&b)[2]) { shim_mma_bf16(d, a, b); }
"""
_RCP = """
inline float rcp_approx(float d) { return 1.0f / d; }
"""
_LDS = """
inline int4 lds_s32x4(const int* p) {
  return *reinterpret_cast<const int4*>(p);
}
"""
_PRMT = """
inline unsigned prmt(unsigned a, unsigned b, unsigned sel) {
  const uint64_t v = (static_cast<uint64_t>(b) << 32) | a;
  unsigned d = 0;
  for (int i = 0; i < 4; ++i) {
    const unsigned s = (sel >> (4 * i)) & 15u;
    unsigned byte = static_cast<unsigned>(v >> (8 * (s & 7))) & 0xffu;
    if (s & 8) byte = byte & 0x80u ? 0xffu : 0u;
    d |= byte << (8 * i);
  }
  return d;
}
"""
_BARS = """
inline void bar_sync(int id, int count) { shim_bar_sync(id, count); }
inline void bar_arrive(int id, int count) { shim_bar_arrive(id, count); }
"""
_HOPPER = """
template <int N>
struct Wgmma {
  static void run(int (&d)[N / 2], uint64_t a, uint64_t b, int scale_d) {
    shim_wgmma_s8(d, N, a, b, scale_d);
  }
};
inline void wgmma_fence() {}
inline void wgmma_commit() { shim_wgmma_commit(); }
template <int N>
inline void wgmma_wait() { shim_wgmma_wait(N); }
template <int N>
struct WgmmaBf16 {
  static void run(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d) {
    shim_wgmma_bf16(d, N, a, b, scale_d);
  }
};
template <class T, int R>
inline void fence_acc(T (&)[R]) {}
inline void fence_proxy_async() {}
inline void mbar_init(uint64_t* bar, int count) { shim_mbar_init(bar, count); }
inline void fence_barrier_init() {}
inline void mbar_arrive(uint64_t* bar) { shim_mbar_arrive(bar, 0); }
inline void mbar_arrive_tx(uint64_t* bar, int bytes) {
  shim_mbar_arrive(bar, bytes);
}
inline void mbar_wait(uint64_t* bar, int parity) {
  shim_mbar_wait(bar, parity);
}
inline void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                        uint64_t* bar) {
  const int c[2] = {c0, c1};
  shim_tma_load(dst, map, c, bar);
}
inline void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                        int c2, int c3, uint64_t* bar) {
  const int c[4] = {c0, c1, c2, c3};
  shim_tma_load(dst, map, c, bar);
}
template <int N>
inline void setmaxnreg_dec() {}
template <int N>
inline void setmaxnreg_inc() {}
"""
_TMAP = """
inline cudaError_t encode_s8_map(CUtensorMap* map, const void* base, int rank,
                                 const uint64_t* dims,
                                 const uint64_t* strides,
                                 const uint32_t* box) {
  shim_cu_tensor_map(map, base, rank, dims, strides, box);
  return cudaSuccess;
}
"""


def _between(src: str, begin: str, end: str, new: str) -> str:
    i = src.index(begin)
    j = src.index("\n", src.index(end, i)) + 1
    return src[:i] + new + src[j:]


def rewrite(text: str) -> str:
    """One source rewritten for the shim (see the module docstring)."""
    if "// --- cp.async" in text:
        text = _between(text, "// --- cp.async", "// --- end of cp.async",
                        _CP_ASYNC)
        text = _between(text, "// --- ldmatrix / mma.sync",
                        "// --- end of ldmatrix / mma.sync", _MMA)
    if "// --- rcp.approx" in text:
        text = _between(text, "// --- rcp.approx", "// --- end of rcp.approx",
                        _RCP)
    if "// --- ld.shared" in text:
        text = _between(text, "// --- ld.shared", "// --- end of ld.shared",
                        _LDS)
    if "// --- prmt" in text:
        text = _between(text, "// --- prmt", "// --- end of prmt", _PRMT)
    if "// --- named barriers" in text:
        text = _between(text, "// --- named barriers",
                        "// --- end of named barriers", _BARS)
    if "// --- wgmma / mbarrier / tma" in text:
        text = _between(text, "// --- wgmma / mbarrier / tma",
                        "// --- end of wgmma / mbarrier / tma", _HOPPER)
        text = _between(text, "// --- tensor map encode",
                        "// --- end of tensor map encode", _TMAP)
    text = re.sub(r"#include <cuda(_runtime|_bf16)?\.h>\n", "", text)
    text = re.sub(r"extern __shared__ __align__\(\d+\) unsigned char "
                  r"smem\[\];", "unsigned char* smem = shim_smem;", text)
    return re.sub(r"(\w+(?:<[^<>;]*>)?)<<<(.*?)>>>\((.*?)\);",
                  r"shim_launch(\1, \2, \3);", text, flags=re.S)


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the CUDA sources for the CPU")
    d = tmp_path_factory.mktemp("cuda_shim")
    for name in SOURCES + cuda_build.HEADERS:
        (d / name).write_text(rewrite((cuda_build.CSRC / name).read_text()))
    lib = d / "libtat_shim.so"
    # one g++ a source, all started together, then the link
    flags = [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC",
             "-pthread", "-w", "-include", str(SHIM), "-I", str(d)]
    procs = [subprocess.Popen(flags + ["-c", "-o", str(d / f"{s}.o"),
                                       "-x", "c++", str(d / s)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for s in SOURCES]
    for src, proc in zip(SOURCES, procs):
        out, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, f"{src}: {out[-4000:]}"
    proc = subprocess.run([gxx, "-shared", "-pthread", "-o", str(lib)]
                          + [str(d / f"{s}.o") for s in SOURCES],
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    so = ctypes.CDLL(str(lib))
    for name in ENTRIES:
        fn = getattr(so, name)
        fn.argtypes = list(cuda_build._SIGNATURES[name])
        fn.restype = ctypes.c_int
    return so


def _rng_int8(rng, shape):
    return torch.from_numpy(rng.integers(-100, 100, shape, dtype=np.int8))


def _chain_operands(kind, rows, k, l, seed):
    rng = np.random.default_rng(seed)
    if kind == "bf16":
        x = torch.from_numpy(rng.normal(size=(rows, k))).to(torch.bfloat16)
        w = torch.from_numpy(rng.normal(size=(l, k, k)) * 0.1).to(
            torch.bfloat16)
        return x, w
    x, w = _rng_int8(rng, (rows, k)), _rng_int8(rng, (l, k, k))
    if kind == "int4w":
        w = PK.pack_int4(w)
    return x, w


def _assert_close(got, ref, kind, stages):
    if kind in ("bf16", "bf16-3x3"):
        g, r = got.float(), ref.float()
        tol = float(r.abs().max()) * 2.0 ** -7
        assert float((g - r).abs().max()) <= tol
        return
    d = (got.to(torch.int32) - ref.to(torch.int32)).abs()
    if PK.MEGA_ACT.get(kind) in ("SILU", "SILU_FAST") and kind != \
            "i8-rq-siluf-1x1":
        frac = float((d > 0).double().mean())
        if stages == 1:
            assert int(d.max()) <= 1 and frac <= 1e-3, (int(d.max()), frac)
        else:
            assert frac <= 0.02, frac
    else:
        assert int(d.max()) == 0, (int(d.max()), float((d > 0).double().mean()))


# the row chain at K = 128: (bn, wslots, rows, L) at 128 rows a block, each
# chunk width and ring depth, rows off the block (a consumer past the last
# row, one with a few), chains of 1-3 stages
CHAIN_CASES = [(128, 3, 70, 2), (128, 2, 200, 3), (64, 3, 130, 2),
               (64, 2, 70, 1), (32, 3, 200, 2), (32, 2, 130, 3),
               (128, 2, 64, 2), (64, 3, 257, 2), (32, 2, 1, 2)]


@pytest.mark.parametrize("case", CHAIN_CASES, ids=str)
@pytest.mark.parametrize("kind", PK.CHAIN_KINDS)
def test_shim_chain_matches_plain(shim, kind, case):
    """E1's four chains on the wgmma row chain at K = 128, 128 rows a
    block, at each of ``CHAIN_CASES``."""
    bn, ws, rows, l = case
    x, w = _chain_operands(kind, rows, 128, l, len(kind) + bn + rows)
    out = torch.empty_like(x)
    PK._launch_chain(x, w, kind, out, PK.ChainPlan(128, bn, ws), shim)
    _assert_close(out, PK.chain_mma_plain(x, w, kind), kind, l)


@pytest.mark.parametrize("bn,rows", [(128, 300), (64, 70)])
@pytest.mark.parametrize("kind", PK.CHAIN_KINDS)
def test_shim_chain_two_tiles_a_consumer(shim, kind, bn, rows):
    """256 rows a block (two m64 tiles a consumer, one weight chunk for
    both) at K = 128, L = 2: rows off the block (a second block of 44
    rows, a tile past the last row)."""
    x, w = _chain_operands(kind, rows, 128, 2, bn + rows)
    out = torch.empty_like(x)
    PK._launch_chain(x, w, kind, out, PK.ChainPlan(256, bn, 2), shim)
    _assert_close(out, PK.chain_mma_plain(x, w, kind), kind, 2)


@pytest.mark.parametrize("bn", [128, 64, 32])
@pytest.mark.parametrize("kind", ["bf16", "mixed"])
def test_shim_chain_one_consumer(shim, kind, bn):
    """bf16 and mixed at 64 rows a block (one consumer warpgroup), the
    block their K = 512 plans take, at K = 128 over 150 rows, L = 2."""
    x, w = _chain_operands(kind, 150, 128, 2, bn)
    out = torch.empty_like(x)
    PK._launch_chain(x, w, kind, out, PK.ChainPlan(64, bn, 2), shim)
    _assert_close(out, PK.chain_mma_plain(x, w, kind), kind, 2)


def test_shim_chain_layout_and_refusals(shim):
    """The row chain's shared memory is ``chain_smem``'s for every plan the
    planner offers at the sweeps' K, every glue; blocks and chunks it
    cannot run are refused."""
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    n = 0
    for kind in PK.CHAIN_GLUES:
        for k in (128, 256, 512):
            plans = PK.chain_plans(kind, k, H100)
            assert plans, (kind, k)
            for p in plans:
                if kind == "requant":
                    rc = shim.tat_megakernel_1x1_info(
                        PK._GLUE_REQUANT, k, p.bm, p.bn, p.wslots,
                        ctypes.byref(smem), ctypes.byref(blocks))
                else:
                    rc = shim.tat_chain_mma_info(
                        PK._GLUE[kind], k, p.bm, p.bn, p.wslots,
                        ctypes.byref(smem), ctypes.byref(blocks))
                want = PK.chain_smem(kind, k, p)
                assert rc == 0 and smem.value == want <= H100.per_block
                assert blocks.value == 233472 // (want + 1024)
                n += 1
    assert n >= 60
    assert PK.chain_plan("int8", 32768, 512, H100) == PK.ChainPlan(128, 64, 3)
    assert PK.chain_plan("bf16", 32768, 512, H100).bm == 64
    xi, wi = _chain_operands("int8", 64, 128, 1, 0)
    # (K, bm, bn, wslots): a 48 chunk, K % bn, 96 rows, 64 rows of int8,
    # one slot, five
    for k, bm, bn, ws in ((128, 128, 48, 2), (96, 128, 64, 2),
                          (128, 96, 64, 2), (128, 64, 64, 2),
                          (128, 128, 64, 1), (128, 128, 64, 5)):
        assert shim.tat_chain_mma(0, xi.data_ptr(), wi.data_ptr(),
                                  xi.data_ptr(), 64, k, 1, bm, bn, ws,
                                  None) == 1
    with pytest.raises(ValueError, match="fits"):
        PK.chain_plan("int8", 100, 48, H100)


ONE_BY_ONE = [k for k in PK.MEGA_KINDS if not PK.is_spatial(k)]


@pytest.mark.parametrize("kind", ONE_BY_ONE)
def test_shim_megakernel_1x1_matches_plain(shim, kind):
    rng = np.random.default_rng(3)
    x, w = _rng_int8(rng, (72, 64)), _rng_int8(rng, (2, 1, 64, 64))
    cs = torch.from_numpy(rng.uniform(0.5, 2.0, 64).astype(np.float32))
    plan = PK.chain_plan("requant" if kind in PK.MEGA_ACT else "int8", 72,
                         64, H100)
    for stages in (1, 2):
        out = torch.empty_like(x)
        PK._launch_1x1(kind, x, w[:stages], cs, out, plan, shim)
        _assert_close(out, PK.megakernel_chain_plain(kind, x, w[:stages], cs),
                      kind, stages)


SPATIAL = [k for k in PK.MEGA_KINDS if PK.is_spatial(k)]
H100 = FK.SmemLimits(132, 233472, 232448)
# E3's stage kernel: (K, H, L, plan) on 3 cells; plan None: the planner's
# pick for an H100 at each launch (resident weights here), else (bn, kc,
# stages, resident, blocks[, wslots]) for every launch, kc None the whole
# row. The
# extents 5 + 2L, 6 + 2L and 10 + 2L cut 8 x 8 tiles at every edge (H = 10
# and 12: several tiles a cell in the plane-major stages); weights streamed
# in one chunk and in several (kc 32: two or four chunks a row); a
# two-slot ring, a 32-channel block under K = 64; one persistent block
# (every tile through one block's ring; 3 tiles: a stand-in in the last
# round of two) and three
SPATIAL_CASES = {
    "k32-h8-l1-pick": (32, 8, 1, None),
    "k64-h8-l2-pick": (64, 8, 2, None),
    "k64-h5-l2-streamed-chunks": (64, 5, 2, (32, 32, 3, False, 1, 3)),
    "k32-h6-l2-streamed": (32, 6, 2, (32, None, 2, False, 3, 2)),
    "k64-h5-l1-resident-bn32": (64, 5, 1, (32, None, 2, True, 1)),
    "k32-h12-l2-pick": (32, 12, 2, None),
    "k32-h10-l2-streamed": (32, 10, 2, (32, None, 3, False, 2, 4)),
}


def _spatial_operands(kind, k, h, l, cells, seed):
    rng = np.random.default_rng(seed)
    e0 = h + 2 * l
    if kind == "bf16-3x3":
        x = torch.from_numpy(rng.normal(size=(cells, e0, e0, k))).to(
            torch.bfloat16)
        w = torch.from_numpy(rng.normal(size=(l, 9, k, k)) * 0.05).to(
            torch.bfloat16)
    else:
        x, w = _rng_int8(rng, (cells, e0, e0, k)), _rng_int8(rng,
                                                            (l, 9, k, k))
    w1 = _rng_int8(rng, (l, 1, k, k))
    cs = torch.from_numpy(rng.uniform(0.5, 2.0, k).astype(np.float32))
    return x, w1, w, cs


@pytest.mark.parametrize("case", SPATIAL_CASES)
@pytest.mark.parametrize("kind", SPATIAL)
def test_shim_megakernel_3x3_matches_plain(shim, kind, case):
    """The valid-shrink 3x3 chains and the C3 round through the wrapper's
    own launch sequence (``_run_spatial``: a stage-kernel launch a stage,
    the C3 round's 1x1 then its taps, the stages' outputs in the scratch
    tensors) with the shim's build, at each of ``SPATIAL_CASES``."""
    k, h, l, plan = SPATIAL_CASES[case]
    c3 = kind == "i8-c3-round"
    x, w1, w3, cs = _spatial_operands(kind, k, h, l, 3, k + h + l)
    if plan is not None:
        bn, kc, stages, resident, blocks, *ws = plan
        plan = PK.StagePlan(bn, kc or PK._row_bytes(kind, k), stages,
                            resident, blocks, *ws)
    out = torch.full((3, h, h, k), 99, dtype=torch.int8).to(x.dtype)
    n = PK._run_spatial(kind, x, w1 if c3 else None, w3, cs, out, H100,
                        plan, shim)
    assert n == (2 * l if c3 else l)
    w = (w1, w3) if c3 else w3
    _assert_close(out, PK.megakernel_chain_plain(kind, x, w, cs), kind, l)


def test_shim_megakernel_3x3_layout_and_refusals(shim):
    """The stage kernel's shared memory is ``stage_smem``'s for every plan
    the planner offers at the sweeps' row sizes, for the taps and the 1x1;
    plans and shapes it cannot run are refused."""
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    n = 0
    for ep, taps, k in ((PK.EP_SHIFT, 9, 256), (PK.EP_BF16, 9, 256),
                        (PK.EP_RESIDUAL, 9, 512), (PK.EP_REQUANT, 1, 512),
                        (PK.EP_REQUANT, 9, 64)):
        row = 2 * k if ep == PK.EP_BF16 else k
        for p in PK.stage_plans(taps, row, k, 100, H100):
            assert shim.tat_megakernel_3x3_info(
                ep, taps, k, p.bn, p.kc, p.stages, int(p.resident), p.wslots,
                ctypes.byref(smem), ctypes.byref(blocks)) == 0
            want = PK.stage_smem(taps, row, p.bn, p.kc, p.stages, p.resident,
                                 p.wslots)
            assert smem.value == want and want <= H100.per_block
            assert blocks.value == 233472 // (want + 1024)
            n += 1
    assert n >= 60
    x, w1, w3, cs = _spatial_operands("i8-c3-round", 64, 6, 1, 1, 0)
    out = torch.empty((1, 6, 6, 64), dtype=torch.int8)
    ok = (PK.EP_RESIDUAL, 9, 0, 64, 64, 64, 3, 1, 0)
    # ep, taps, x offset, K, bn, kc, stages, resident, res missing
    bad = [(PK.EP_RESIDUAL, 9, 0, 64, 48, 64, 3, 1, 0),   # bn
           (PK.EP_RESIDUAL, 9, 0, 64, 64, 48, 3, 0, 0),   # kc % 32
           (PK.EP_RESIDUAL, 9, 0, 64, 64, 32, 3, 1, 0),   # resident chunk
           (PK.EP_RESIDUAL, 9, 0, 64, 64, 64, 1, 1, 0),   # one slot
           (PK.EP_RESIDUAL, 9, 0, 64, 64, 64, 5, 1, 0),   # five slots
           (PK.EP_RESIDUAL, 9, 0, 96, 64, 96, 3, 1, 0),   # K % bn
           (PK.EP_SHIFT, 1, 0, 64, 64, 64, 3, 1, 0),      # a 1x1 shift
           (PK.EP_RESIDUAL, 9, 0, 64, 64, 64, 3, 1, 1),   # no residual
           (PK.EP_RESIDUAL, 9, 8, 64, 64, 64, 3, 1, 0)]   # x off 16 bytes
    wt = PK.tile_weights(w3, 64)[0]
    for ep, taps, off, k, bn, kc, st, res, nores in [ok] + bad:
        rc = shim.tat_megakernel_3x3(
            ep, taps, x.data_ptr() + off, wt.data_ptr(), cs.data_ptr(),
            None if nores else x.data_ptr(), out.data_ptr(), 0, 0, 0, 1, 8,
            k, FK._ACT_CODE["SILU"], PK.INV_OUT, PK.ALPHA, PK.RES_SCALE, bn,
            kc, st, res, 2, 1, None)
        assert rc == (0 if (ep, taps, off, k, bn, kc, st, res, nores) == ok
                      else 1)


def test_shim_add_one_and_refusals(shim):
    x = torch.linspace(-3, 3, 1000, dtype=torch.float32)
    out = torch.empty_like(x)
    assert shim.tat_add_one(x.data_ptr(), out.data_ptr(), 1000, None) == 0
    assert torch.equal(out, PK.add_one_plain(x))
    xi, wi = _chain_operands("int8", 64, 128, 1, 0)
    out = torch.empty_like(xi)
    ok = (PK._GLUE_REQUANT, 3, 0)
    # the requantize without cs, an act past SILU_FAST, a glue the 1x1
    # entry does not take
    for glue, act, nocs in [ok, (PK._GLUE_REQUANT, 3, 1),
                            (PK._GLUE_REQUANT, 5, 0), (PK._GLUE["bf16"], 0,
                                                       0)]:
        cs = torch.ones(128)
        rc = shim.tat_megakernel_1x1(
            glue, xi.data_ptr(), wi.data_ptr(), None if nocs else
            cs.data_ptr(), out.data_ptr(), 64, 128, 1, 128, 64, 2, act,
            PK.INV_OUT, PK.ALPHA, None)
        assert rc == (0 if (glue, act, nocs) == ok else 1)


# E2's lagged conv: a 10 x 20 image (ragged under the 8 x 8 tile in both
# directions), O = 40 (ragged under every channel block), C = 32 and 64
# (one and two wgmma K steps a tap)
LAGGED_SHAPE = (2, 10, 20, 32, 40)
LAGGED_ACTS = ("NONE", "RELU", "LEAKY_RELU", "SILU")


def _lagged_operands(act, seed, c=LAGGED_SHAPE[3]):
    n, h, w, _, o = LAGGED_SHAPE
    rng = np.random.default_rng(seed)
    x = _rng_int8(rng, (n, h, w, c))
    wt = _rng_int8(rng, (o, 3, 3, c))
    bias = torch.from_numpy(rng.integers(-2000, 2000, o).astype(np.int32))
    ep = FK.epilogue_rows(rng.uniform(0.005, 0.015, o).astype(np.float32),
                          0.05, float(0.0137 * np.sqrt(9 * c)), act, o,
                          alpha=0.1)
    return x, wt, bias, ep


def _shim_lagged(shim, lag, x, wt, bias, ep, plan):
    n, h, w, c = x.shape
    out = torch.full((n, h, w, wt.shape[0]), 99, dtype=torch.int8)
    rc = shim.tat_conv_int8_lagged(
        lag, x.data_ptr(), wt.data_ptr(), bias.data_ptr(), ep.cs.data_ptr(),
        out.data_ptr(), n, h, w, c, wt.shape[0], FK._ACT_CODE[ep.act],
        ep.inv_out, ep.alpha, plan.bn, plan.stages, plan.blocks, None)
    assert rc == 0
    return out


@pytest.mark.parametrize("act", LAGGED_ACTS)
@pytest.mark.parametrize("bn", PK.LAGGED_BNS)
@pytest.mark.parametrize("lag", [1, 0])
def test_shim_lagged_conv_matches_plain(shim, lag, bn, act):
    """Both modes of the wgmma lagged conv at each channel block and act:
    at C = 32 through a two-slot ring with one block walking all 12 tiles
    (the ring and the ping-pong wrap several times), at C = 64 through the
    deepest ring with 5 blocks (3 or 2 tiles each: a consumer without a
    partner in the last round); equal to the plain version (SILU within
    its bound), every row and channel written."""
    for c, plan in ((32, PK.LaggedPlan(bn, 2, 1)),
                    (64, PK.LaggedPlan(bn, PK.LAGGED_STAGES[0], 5))):
        x, wt, bias, ep = _lagged_operands(act, bn + len(act) + lag + c, c)
        ref = PK.conv3x3_lagged_plain(x, wt, bias, ep)
        out = _shim_lagged(shim, lag, x, wt, bias, ep, plan)
        _assert_close(out, ref, "i8-rq-silu-3x3" if act == "SILU" else
                      "i8-shift-3x3", 1)


def test_shim_lagged_layout_and_refusals(shim):
    """The kernel's shared memory is ``lagged_smem``'s for every plan, in
    both modes; plans and shapes it cannot run are refused."""
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    for c in (32, 96, 128, 256, 448):
        for bn in PK.LAGGED_BNS:
            for st in PK.LAGGED_STAGES:
                for lag in (0, 1):
                    rc = shim.tat_conv_int8_lagged_info(
                        lag, c, bn, st, ctypes.byref(smem),
                        ctypes.byref(blocks))
                    want = PK.lagged_smem(c, bn, st)
                    if want > 232448:
                        assert rc == 1
                        continue
                    assert rc == 0 and smem.value == want
                    assert blocks.value == 233472 // (want + 1024)
    x, wt, bias, ep = _lagged_operands("NONE", 0)
    n, h, w, c = x.shape
    out = torch.empty((n, h, w, 40), dtype=torch.int8)
    bad = [(48, 40, 64, 2, 1, 0), (32, 36, 64, 2, 1, 0),
           (32, 40, 48, 2, 1, 0), (32, 40, 64, 1, 1, 0),
           (32, 40, 64, 5, 1, 0), (32, 40, 64, 2, 0, 0),
           (32, 40, 64, 2, 1, 1)]
    # C % 32, O % 8, bn, two stages at least, four at most, a block, x
    # off 16 bytes
    for cc, o, bn, st, nblk, off in bad:
        assert shim.tat_conv_int8_lagged(
            1, x.data_ptr() + off, wt.data_ptr(), None, ep.cs.data_ptr(),
            out.data_ptr(), n, h, w, cc, o, 0, 1.0, 0.1, bn, st, nblk,
            None) == 1


# The exact tier's KxK conv (#10 and #11, conv_int8_requant_mma.cu):
# (batch, H, W, C, O, KH, KW, stride, dilation, pads, round mode, relu),
# each small; H and W ragged under every tile, O ragged under both blocks
# where O is not 32 or 64; the im2col mode's A rows built by 2-byte runs
# (the stem, C = 6 and 32), by bytes (C = 3 at 3x3: 9-byte runs) and by
# the k table (dilation 2), its slab loads inside the image (C = 3 on a
# 24 x 40 image) and at its edges
HALF, TRUNC = RoundMode.HALF_AWAY, RoundMode.PLUS_HALF_TRUNC
MMA_CASES = {
    "3x3s1-c32": (2, 10, 20, 32, 40, 3, 3, (1, 1), (1, 1), ((1, 1), (1, 1)),
                  HALF, False),
    "3x3s1-c64": (1, 9, 12, 64, 72, 3, 3, (1, 1), (1, 1), ((1, 1), (1, 1)),
                  TRUNC, True),
    "3x3s2": (2, 13, 21, 32, 24, 3, 3, (2, 2), (1, 1), ((0, 1), (1, 1)),
              HALF, True),
    "dilation2": (1, 12, 14, 32, 16, 3, 3, (1, 1), (2, 2), ((2, 2), (2, 2)),
                  TRUNC, False),
    "stride21": (1, 11, 18, 32, 32, 3, 3, (2, 1), (1, 1), ((1, 1), (1, 1)),
                 HALF, False),
    "stem6x6s2": (2, 22, 26, 3, 32, 6, 6, (2, 2), (1, 1), ((2, 2), (2, 2)),
                  HALF, False),
    "5x5-c6": (1, 13, 10, 6, 70, 5, 5, (1, 1), (1, 1), ((2, 2), (2, 2)),
               TRUNC, True),
    "c96-chunked": (1, 10, 9, 96, 40, 3, 3, (2, 2), (1, 1), ((1, 1), (1, 1)),
                    HALF, False),
    "c3-interior": (1, 24, 40, 3, 16, 3, 3, (1, 1), (1, 1), ((1, 1), (1, 1)),
                    TRUNC, False),
}


def _mma_operands(case, seed):
    nb, h, w, c, o, kh, kw, s, d, pads, rm, relu = case
    rng = np.random.default_rng(seed)
    x, wt = _rng_int8(rng, (nb, h, w, c)), _rng_int8(rng, (o, kh, kw, c))
    bias = torch.from_numpy(rng.integers(-3000, 3000, o).astype(np.int32))
    out_hw = tuple((n + sum(p) - (k - 1) * dd - 1) // ss + 1
                   for n, p, k, dd, ss in zip((h, w), pads, (kh, kw), d, s))
    scales = (0.05, 0.01, float(0.0137 * np.sqrt(kh * kw * c)))
    ref = RK.conv2d_int8_plain(x, wt, bias, out_hw, s, d, pads, *scales, rm,
                               relu)
    return x, wt, bias, out_hw, RK.combined_scale(*scales), ref


def _mma_plans(case, mode):
    """The plans the wrapper offers in ``mode``, each also at the next
    chunks it could take (narrower, im2col's possibly ragged; in slab mode
    beside resident and streamed weights), all at runs of 4 tiles (runs
    that cross tiles, and a ragged last run)."""
    nb, h, w, c, o, kh, kw, s, d = case[:9]
    _, _, _, out_hw, _, _ = _mma_operands(case, 0)
    plans = RK.conv_requant_plans(nb, *out_hw, c, o, kh, kw, s, d, mode,
                                  H100)
    chunks = RK._chunks(mode, c)
    n = 3 if mode == "slab" else 2
    return [dataclasses.replace(p, ck=k, resident=r, tiles_per_block=4)
            for p in plans for i in [chunks.index((p.ck, p.resident))]
            for k, r in chunks[i:i + n]]


def _shim_mma(shim, x, wt, bias, out_hw, cs, case, plan):
    nb, o, s, d, pads, rm, relu = case[0], case[4], *case[7:]
    out = torch.full((nb,) + out_hw + (o,), 99, dtype=torch.int8)
    rc = shim.tat_conv_int8_requant_mma(
        *RK._conv_args(x, wt, bias, cs, s, d, pads, rm, relu, out, plan),
        None)
    assert rc == 0, plan
    return out


MMA_MODES = [(name, mode) for name, case in MMA_CASES.items()
             for mode in (("slab", "im2col") if case[3] % 32 == 0
                          else ("im2col",))]


@pytest.mark.parametrize("name,mode", MMA_MODES, ids=str)
def test_shim_conv_requant_mma_matches_plain(shim, name, mode):
    """The KxK conv in ``mode`` (the slab mode where C % 32 == 0) under
    every plan the wrapper offers, each also at the next narrower chunk:
    equal to ``conv2d_int8_plain`` bit for bit, every element written."""
    case = MMA_CASES[name]
    x, wt, bias, out_hw, cs, ref = _mma_operands(case, len(name))
    assert RK.conv_mode(x, wt) == ("slab" if case[3] % 32 == 0 else
                                   "im2col")
    plans = _mma_plans(case, mode)
    assert len({(p.tile_h, p.tile_w) for p in plans}) == len(RK.CONV_TILES)
    for plan in plans:
        got = _shim_mma(shim, x, wt, bias, out_hw, cs, case, plan)
        assert torch.equal(got, ref), (plan, int((got != ref).sum()))


def test_shim_conv_requant_mma_unaligned_and_no_bias(shim):
    """An input at an odd byte offset takes im2col mode (slab mode refuses
    it); no bias."""
    case = MMA_CASES["3x3s2"]
    x, wt, _, out_hw, cs, _ = _mma_operands(case, 1)
    buf = torch.zeros(1 + x.numel(), dtype=torch.int8)
    xo = buf[1:].view(x.shape)
    xo.copy_(x)
    ref = RK.conv2d_int8_plain(x, wt, None, out_hw, *case[7:10], 0.05, 0.01,
                               float(0.0137 * np.sqrt(9 * 32)), *case[10:])
    assert RK.conv_mode(xo, wt) == "im2col"
    plan = RK.conv_requant_plan(case[0], *out_hw, 32, case[4], 3, 3,
                                case[7], case[8], "im2col", H100)
    assert torch.equal(_shim_mma(shim, xo, wt, None, out_hw, cs, case, plan),
                       ref)
    slab = dataclasses.replace(plan, mode="slab", ck=32, resident=True)
    out = torch.empty_like(ref)
    assert shim.tat_conv_int8_requant_mma(
        *RK._conv_args(xo, wt, None, cs, *case[7:10], *case[10:], out, slab),
        None) == 1


def test_shim_conv_requant_mma_layout_and_refusals(shim):
    """The kernel's shared memory is ``conv_requant_smem``'s for every
    tile, block, chunk and weight residence in both modes (refused above
    the opt-in); plans it cannot run are refused."""
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    geoms = [(32, 3, 3, (1, 1), (1, 1)), (256, 3, 3, (2, 2), (1, 1)),
             (128, 3, 3, (1, 1), (2, 2)), (64, 3, 3, (2, 1), (1, 1)),
             (3, 6, 6, (2, 2), (1, 1)), (20, 5, 5, (1, 1), (1, 1))]
    n = 0
    for c, kh, kw, s, d in geoms:
        for mode in ("slab", "im2col"):
            if mode == "slab" and c % 32:
                continue
            for th, tw in RK.CONV_TILES:
                for bn in RK.CONV_BNS:
                    for ck, res in RK._chunks(mode, c):
                        plan = RK.ConvPlan(mode, th, tw, bn, ck, res, 1)
                        rc = shim.tat_conv_int8_requant_mma_info(
                            *RK._info_args(plan, c, (kh, kw), s, d),
                            ctypes.byref(smem), ctypes.byref(blocks))
                        want = RK.conv_requant_smem(mode, c, kh, kw, s, d,
                                                    th, tw, bn, ck, res)
                        n += 1
                        if want > H100.per_block:
                            assert rc == 1
                            continue
                        assert rc == 0 and smem.value == want
                        assert blocks.value == 233472 // (want + 1024)
    assert n > 500
    bad = [("slab", 20, 8, 8, 64, 20, 1), ("slab", 64, 8, 8, 64, 48, 1),
           ("slab", 64, 8, 8, 64, 64, 0), ("im2col", 64, 8, 8, 64, 32, 1),
           ("im2col", 64, 8, 12, 64, 64, 1), ("im2col", 64, 4, 8, 64, 64, 1),
           ("im2col", 64, 8, 8, 48, 64, 1), ("im2col", 64, 16, 16, 64, 64, 1),
           ("im2col", 64, 8, 8, 64, 65, 1)]
    # C % 32, ck, all C streamed, a chunk resident in im2col, tile_w,
    # pixels, bn, ck > C
    for mode, c, th, tw, bn, ck, res in bad:
        plan = RK.ConvPlan(mode, th, tw, bn, ck, bool(res), 1)
        assert shim.tat_conv_int8_requant_mma_info(
            *RK._info_args(plan, c, (3, 3), (1, 1), (1, 1)),
            ctypes.byref(smem), ctypes.byref(blocks)) == 1


# The serving tier's KxK conv (#2 and #5, conv_int8_fused_mma.cu): the same
# core with ServingEpilogue<ACT>. (batch, H, W, C, O, K, stride, pads, act,
# residual): per-channel cs everywhere; each act; the residual through
# 16-byte copies (O % 16 == 0) and byte by byte (O = 40); O ragged under
# every block (40, 24); the real yolov5n's 6x6/s2 stem on 3 -> 16 channels
# (bn 16), NanoDet's 3x3/s2 stem on 3 -> 24, C = 16 at stride 2 (im2col);
# H and W ragged under every tile
SERVING_CASES = {
    "3x3s1-c32-silu-res": (2, 10, 20, 32, 40, 3, 1, ((1, 1), (1, 1)),
                           "SILU", True),
    "3x3s1-c64-relu-res": (1, 9, 12, 64, 64, 3, 1, ((1, 1), (1, 1)),
                           "RELU", True),
    "3x3s2-c32-leaky": (2, 13, 21, 32, 24, 3, 2, ((0, 1), (1, 1)),
                        "LEAKY_RELU", False),
    "stem6x6s2-c3-o16": (2, 22, 26, 3, 16, 6, 2, ((2, 2), (2, 2)), "SILU",
                         False),
    "stem3x3s2-c3-o24": (1, 20, 18, 3, 24, 3, 2, ((1, 1), (1, 1)),
                         "LEAKY_RELU", False),
    "3x3s2-c16-none-res": (1, 18, 20, 16, 32, 3, 2, ((1, 1), (1, 1)),
                           "NONE", True),
}


def _serving_operands(case, seed):
    nb, h, w, c, o, k, s, pads, act, res = case
    rng = np.random.default_rng(seed)
    x, wt = _rng_int8(rng, (nb, h, w, c)), _rng_int8(rng, (o, k, k, c))
    bias = torch.from_numpy(rng.integers(-3000, 3000, o).astype(np.int32))
    out_hw = tuple((n + sum(p) - k) // s + 1 for n, p in zip((h, w), pads))
    ep = FK.epilogue_rows(rng.uniform(0.005, 0.015, o).astype(np.float32),
                          0.05, float(0.0137 * np.sqrt(k * k * c)), act, o,
                          alpha=0.1)
    r = _rng_int8(rng, (nb,) + out_hw + (o,)) if res else None
    return x, wt, bias, ep, out_hw, r


def _serving_close(got, ref, act):
    _assert_close(got, ref, "i8-rq-silu-3x3" if act == "SILU"
                  else "i8-shift-3x3", 1)


def _shim_serving(shim, x, wt, bias, ep, out_hw, pads, s, res, plan):
    out = torch.full((x.shape[0],) + out_hw + (wt.shape[0],), 99,
                     dtype=torch.int8)
    rc = shim.tat_conv_int8_fused_mma(
        *FK._conv_args(x, wt, bias, ep, pads, s, res, 0.37, out, plan), None)
    assert rc == 0, plan
    return out


SERVING_MODES = [(name, mode) for name, case in SERVING_CASES.items()
                 for mode in (("slab", "im2col") if case[3] % 32 == 0
                              else ("im2col",))]


@pytest.mark.parametrize("name,mode", SERVING_MODES, ids=str)
def test_shim_conv_fused_mma_matches_plain(shim, name, mode):
    """The serving KxK conv in ``mode`` under every plan the serving
    planner offers (the stem's bn 16 among them), at runs of 4 tiles:
    equal to ``conv2d_int8_halo_fused_plain`` (SILU within its bound),
    every element written, with the case's residual and without a bias."""
    case = SERVING_CASES[name]
    nb, _, _, c, o, k, s, pads, act, _ = case
    x, wt, bias, ep, out_hw, res = _serving_operands(case, len(name))
    assert FK.conv_mode(x, wt) == ("slab" if c % 32 == 0 else "im2col")
    plans = FK.conv_plans(nb, *out_hw, c, o, k, k, (s, s), (1, 1), mode,
                          H100, FK.serving_bns(o))
    assert len({(p.tile_h, p.tile_w) for p in plans}) == len(FK.CONV_TILES)
    assert (16 in {p.bn for p in plans}) == (o <= 16)
    for plan in plans:
        plan = dataclasses.replace(plan, tiles_per_block=4)
        got = _shim_serving(shim, x, wt, bias, ep, out_hw, pads, s, res,
                            plan)
        _serving_close(got, FK.conv2d_int8_halo_fused_plain(
            x, wt, bias, ep, out_hw, pads, s, res, 0.37), act)
    plan = dataclasses.replace(plans[0], tiles_per_block=1)
    _serving_close(
        _shim_serving(shim, x, wt, None, ep, out_hw, pads, s, res, plan),
        FK.conv2d_int8_halo_fused_plain(x, wt, None, ep, out_hw, pads, s,
                                        res, 0.37), act)


@pytest.mark.parametrize("act", ["NONE", "RELU", "LEAKY_RELU", "SILU"])
def test_shim_conv_fused_mma_each_act_and_chunk(shim, act):
    """Each act at C = 96 at stride 2, in slab mode with C in chunks of 32
    beside resident and streamed weights and in im2col mode in chunks of
    48; with a residual of 16-byte copies (O = 48) except for LEAKY_RELU,
    which takes none."""
    case = (1, 10, 9, 96, 48, 3, 2, ((1, 1), (1, 1)), act,
            act != "LEAKY_RELU")
    x, wt, bias, ep, out_hw, res = _serving_operands(case, len(act))
    ref = FK.conv2d_int8_halo_fused_plain(x, wt, bias, ep, out_hw, case[7],
                                          2, res, 0.37)
    for plan in (FK.ConvPlan("slab", 8, 8, 32, 32, True, 2),
                 FK.ConvPlan("slab", 4, 16, 64, 32, False, 3),
                 FK.ConvPlan("im2col", 8, 16, 16, 48, False, 1)):
        _serving_close(_shim_serving(shim, x, wt, bias, ep, out_hw, case[7],
                                     2, res, plan), ref, act)


def test_shim_conv_fused_mma_unaligned_operands(shim):
    """An input and a residual at odd byte offsets: im2col mode (slab mode
    refuses the input), the residual read byte by byte although O % 16 ==
    0; LEAKY_RELU with a residual and an act past SILU_FAST are refused."""
    case = SERVING_CASES["3x3s1-c64-relu-res"]
    x, wt, bias, ep, out_hw, res = _serving_operands(case, 5)
    pads = case[7]
    ref = FK.conv2d_int8_halo_fused_plain(x, wt, bias, ep, out_hw, pads, 1,
                                          res, 0.37)
    bx = torch.zeros(1 + x.numel(), dtype=torch.int8)
    br = torch.zeros(1 + res.numel(), dtype=torch.int8)
    xo, ro = bx[1:].view(x.shape), br[1:].view(res.shape)
    xo.copy_(x)
    ro.copy_(res)
    assert FK.conv_mode(xo, wt) == "im2col"
    plan = FK.conv_plan(1, *out_hw, 64, 64, 3, 3, (1, 1), (1, 1), "im2col",
                        H100, FK.serving_bns(64))
    assert torch.equal(_shim_serving(shim, xo, wt, bias, ep, out_hw, pads, 1,
                                     ro, plan), ref)
    slab = FK.ConvPlan("slab", 8, 8, 64, 64, True, 1)
    out = torch.empty_like(ref)
    assert shim.tat_conv_int8_fused_mma(
        *FK._conv_args(xo, wt, bias, ep, pads, 1, res, 0.37, out, slab),
        None) == 1
    leaky = FK.epilogue_rows(0.01, 0.05, 0.5, "LEAKY_RELU", 64)
    assert shim.tat_conv_int8_fused_mma(
        *FK._conv_args(x, wt, bias, leaky, pads, 1, res, 0.37, out, slab),
        None) == 1
    args = list(FK._conv_args(x, wt, bias, ep, pads, 1, None, 0.37, out,
                              slab))
    args[18] = len(FK.ACTS)
    assert shim.tat_conv_int8_fused_mma(*args, None) == 1


def test_shim_conv_fused_mma_layout_and_refusals(shim):
    """The serving kernel's shared memory is ``conv_smem``'s for every
    tile, block (bn 16 too), chunk and weight residence, at each act;
    the exact kernel refuses bn 16; plans it cannot run are refused."""
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    geoms = [(32, 3, 3, 1), (256, 3, 3, 2), (3, 6, 6, 2), (16, 3, 3, 2)]
    n = 0
    for c, kh, kw, s in geoms:
        for mode in ("slab", "im2col"):
            if mode == "slab" and c % 32:
                continue
            for th, tw in FK.CONV_TILES:
                for bn in FK.CONV_BNS + (16,):
                    for ck, res in FK.conv_chunks(mode, c)[:3]:
                        plan = FK.ConvPlan(mode, th, tw, bn, ck, res, 1)
                        want = FK.conv_smem(mode, c, kh, kw, (s, s), (1, 1),
                                            th, tw, bn, ck, res)
                        for act in range(4):
                            rc = shim.tat_conv_int8_fused_mma_info(
                                act, FK._MODE_CODE[mode], c, kh, kw, s, th,
                                tw, bn, ck, int(res), 0, ctypes.byref(smem),
                                ctypes.byref(blocks))
                            n += 1
                            if want > H100.per_block:
                                assert rc == 1
                                continue
                            assert rc == 0 and smem.value == want
                            assert blocks.value == 233472 // (want + 1024)
                        exact = shim.tat_conv_int8_requant_mma_info(
                            *RK._info_args(plan, c, (kh, kw), (s, s),
                                           (1, 1)),
                            ctypes.byref(smem), ctypes.byref(blocks))
                        assert (exact == 1) == (bn == 16
                                                or want > H100.per_block)
    assert n > 500
    bad = [(0, "slab", 20, 8, 8, 64, 20, 1), (0, "im2col", 64, 8, 12, 64, 64, 1),
           (1, "im2col", 64, 8, 8, 48, 64, 1), (2, "im2col", 64, 8, 8, 8, 64, 1),
           (3, "im2col", 64, 8, 8, 64, 32, 1), (5, "im2col", 64, 8, 8, 64, 64, 1)]
    # C % 32, tile_w, bn 48, bn 8, a chunk resident in im2col, an act past
    # SILU_FAST
    for act, mode, c, th, tw, bn, ck, res in bad:
        assert shim.tat_conv_int8_fused_mma_info(
            act, FK._MODE_CODE[mode], c, 3, 3, 1, th, tw, bn, ck, res, 0,
            ctypes.byref(smem), ctypes.byref(blocks)) == 1


# The serving 1x1 GEMM of #1 and #3 (mm_int8_fused_mma.cu): (K of each
# part, N, act, per-part scales, residual). M = 293: two 128-row tiles and
# a ragged one (four 64-row tiles and a ragged one); the parts' weights
# are column slices of one [N, sum K] matrix; K = 16 (zero-filled to 32)
# and unequal K; N = 16 (bn 16), 40 and 255 (ragged under every block);
# the residual through 16-byte copies (N % 16 == 0) and byte by byte.
GEMM_M = 293
GEMM_CASES = {
    "1part-k64-n64-none": ((64,), 64, "NONE", False, False),
    "1part-k16-n16-silu": ((16,), 16, "SILU", False, False),
    "1part-k64-n255-none": ((64,), 255, "NONE", False, False),
    "1part-k32-n32-silu-res": ((32,), 32, "SILU", False, True),
    "2part-k64+64-n128-silu-equal": ((64, 64), 128, "SILU", False, False),
    "2part-k64+64-n128-silu-perpart": ((64, 64), 128, "SILU", True, False),
    "4part-k16+32+64+128-n40-leaky-perpart": ((16, 32, 64, 128), 40,
                                              "LEAKY_RELU", True, False),
    "4part-k64x4-n255-relu-equal": ((64,) * 4, 255, "RELU", False, False),
    "2part-k16+48-n40-none-perpart-res": ((16, 48), 40, "NONE", True, True),
    "3part-k32x3-n64-relu-equal-res": ((32,) * 3, 64, "RELU", False, True),
}


def _gemm_operands(case, seed):
    """x parts, weight column slices, bias, the epilogue (an ``Epilogue``
    for one part, else a ``MultiEpilogue``), the residual."""
    ks, n, act, per_part, res = case
    rng = np.random.default_rng(seed)
    xs = [_rng_int8(rng, (GEMM_M, k)) for k in ks]
    wfull = _rng_int8(rng, (n, sum(ks)))
    offs = np.cumsum((0,) + ks)
    ws = [wfull[:, a:b] for a, b in zip(offs[:-1], offs[1:])]
    bias = torch.from_numpy(rng.integers(-3000, 3000, n).astype(np.int32))
    wscale = rng.uniform(0.005, 0.015, n).astype(np.float32)
    out_scale = float(0.0137 * np.sqrt(sum(ks)))
    if len(ks) == 1:
        ep = FK.epilogue_rows(wscale, 0.05, out_scale, act, n, alpha=0.1)
    else:
        scales = ((0.038, 0.046, 0.047, 0.049)[:len(ks)] if per_part
                  else (0.05,) * len(ks))
        ep = FK.multi_epilogue(wscale, scales, out_scale, act, n, alpha=0.1,
                               bias_scale=0.045 if per_part else 0.05)
        assert ep.same_scale == (not per_part)
    r = _rng_int8(rng, (GEMM_M, n)) if res else None
    return xs, ws, bias, ep, r


def _gemm_plain(xs, ws, bias, ep, r):
    if isinstance(ep, FK.Epilogue):
        return FK.matmul_int8_fused_plain(xs[0], ws[0], bias, ep, r, 0.37)
    return FK.matmul_int8_fused_multi_plain(xs, ws, bias, ep, r, 0.37)


def _shim_gemm(shim, xs, ws, bias, ep, r, plan):
    n = ws[0].shape[0]
    out = torch.full((xs[0].shape[0], n), 99, dtype=torch.int8)
    if isinstance(ep, FK.Epilogue):
        scales = (1.0,) * len(xs), True, 1.0, ep
    else:
        scales = ep.part_scales, ep.same_scale, ep.bias_scale, ep.ep
    part_scales, same, bias_scale, e = scales
    rc = shim.tat_mm_int8_fused_mma(
        *FK._gemm_args(xs, ws, bias, e, part_scales, same, bias_scale, r,
                       0.37, out, plan), None)
    assert rc == 0, plan
    return out


@pytest.mark.parametrize("name", GEMM_CASES)
def test_shim_gemm_mma_matches_plain(shim, name):
    """The 1x1 GEMM under every plan the planner offers (both tile heights
    and every channel block it takes for N), at runs of 2 tiles (runs that
    cross tiles and a ragged last run), and the first plan at each ring
    depth, at K bytes a stage of 32 (the parts in chunks) and without a
    bias: equal to its plain version (SILU within its bound), every
    element written."""
    case = GEMM_CASES[name]
    ks, n, act, per_part = case[:4]
    xs, ws, bias, ep, r = _gemm_operands(case, len(name))
    ref = _gemm_plain(xs, ws, bias, ep, r)
    plans = FK.mm_plans(GEMM_M, n, ks, not per_part, H100)
    assert {p.bm for p in plans} == {64, 128} or per_part
    assert (16 in {p.bn for p in plans}) == (n <= 16)
    first = plans[0]
    variants = [dataclasses.replace(p, tiles_per_block=2) for p in plans]
    variants += [dataclasses.replace(first, stages=st, tiles_per_block=1)
                 for st in (2, 3, 4)]
    variants.append(dataclasses.replace(first, kc=32, tiles_per_block=3))
    for plan in variants:
        _serving_close(_shim_gemm(shim, xs, ws, bias, ep, r, plan), ref, act)
    _serving_close(_shim_gemm(shim, xs, ws, None, ep, r, first),
                   _gemm_plain(xs, ws, None, ep, r), act)


@pytest.mark.parametrize("per_part", [False, True], ids=["equal", "perpart"])
@pytest.mark.parametrize("act", ["NONE", "RELU", "LEAKY_RELU", "SILU"])
def test_shim_gemm_mma_each_act_and_branch(shim, act, per_part):
    """Each act in both scale branches at 2 parts (K 16 + 96) -> 48, with a
    residual of 16-byte copies except for LEAKY_RELU, which takes none."""
    case = ((16, 96), 48, act, per_part, act != "LEAKY_RELU")
    xs, ws, bias, ep, r = _gemm_operands(case, len(act) + per_part)
    plan = FK.mm_plan(GEMM_M, 48, case[0], not per_part, H100)
    _serving_close(_shim_gemm(shim, xs, ws, bias, ep, r, plan),
                   _gemm_plain(xs, ws, bias, ep, r), act)


def test_shim_gemm_mma_unaligned_operands(shim):
    """The byte path: parts at odd byte offsets, a weight slice at a row
    stride off 16, a residual and an output off 16-byte alignment; each
    equal to the plain version."""
    case = GEMM_CASES["2part-k16+48-n40-none-perpart-res"]
    xs, ws, bias, ep, r = _gemm_operands(case, 3)
    ref = _gemm_plain(xs, ws, bias, ep, r)

    def shifted(t):
        buf = torch.zeros(1 + t.numel(), dtype=torch.int8)
        o = buf[1:].view(t.shape)
        o.copy_(t)
        return o
    wfull = torch.zeros((40, 67), dtype=torch.int8)   # row stride 67
    wfull[:, 1:17], wfull[:, 17:65] = ws
    plan = FK.mm_plan(GEMM_M, 40, case[0], False, H100)
    got = _shim_gemm(shim, [shifted(x) for x in xs],
                     [wfull[:, 1:17], wfull[:, 17:65]], bias, ep, shifted(r),
                     plan)
    assert torch.equal(got, ref)
    x1, w1, b1, e1, r1 = _gemm_operands(GEMM_CASES["1part-k32-n32-silu-res"],
                                        4)
    ref1 = _gemm_plain(x1, w1, b1, e1, r1)
    out = shifted(torch.zeros_like(ref1))
    x1o = [shifted(x1[0])]   # held: the call takes raw pointers
    plan = FK.mm_plan(GEMM_M, 32, (32,), True, H100)
    rc = shim.tat_mm_int8_fused_mma(
        *FK._gemm_args(x1o, w1, b1, e1, (1.0,), True, 1.0, r1, 0.37, out,
                       plan), None)
    assert rc == 0
    _serving_close(out, ref1, "SILU")


def test_shim_gemm_mma_layout_and_refusals(shim):
    """The kernel's shared memory is ``mm_smem``'s for every tile
    height, channel block, stage width, ring depth, branch and act
    (refused above the opt-in, and per-part at 128 x 128); LEAKY_RELU with
    a residual, an act past SILU_FAST, 5 parts, K = 0 and plans off the
    kernel's set
    are refused."""
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    n = 0
    for ks in [(64,), (16, 48), (128,) * 4, (2048,) * 4]:
        for bm in FK.MM_BMS:
            for bn in FK.MM_BNS + (16,):
                for kc in (32, 128):
                    for stages in FK.MM_STAGES:
                        plan = FK.MmPlan(bm, bn, kc, stages, 1)
                        want = FK.mm_smem(ks, bm, bn, kc, stages)
                        for same in (True, False):
                            for act in FK.ACTS[:4]:
                                rc = shim.tat_mm_int8_fused_mma_info(
                                    *FK._gemm_info_args(plan, ks, same, act),
                                    ctypes.byref(smem), ctypes.byref(blocks))
                                n += 1
                                if want > H100.per_block or (
                                        not same and bm == bn == 128):
                                    assert rc == 1
                                    continue
                                assert rc == 0 and smem.value == want
                                assert blocks.value == 233472 // (want + 1024)
    assert n > 1000
    ints = ctypes.c_int * FK.MAX_PARTS
    bad = [(1, (64, 0, 0, 0), 64, 64, 64, 4), (1, (0, 0, 0, 0), 64, 64, 64, 4),
           (1, (64, 0, 0, 0), 96, 64, 64, 4), (1, (64, 0, 0, 0), 64, 48, 64, 4),
           (1, (64, 0, 0, 0), 64, 64, 48, 4), (1, (64, 0, 0, 0), 64, 64, 64, 5),
           (1, (64, 0, 0, 0), 64, 64, 64, 1), (5, (64, 64, 64, 64), 64, 64, 64,
                                               4)]
    # 1 part at bm/bn/kc/stages 64/64/64/4 is good; then K = 0, bm 96, bn
    # 48, kc 48, 5 and 1 stages, 5 parts
    for i, (parts, ks, bm, bn, kc, stages) in enumerate(bad):
        rc = shim.tat_mm_int8_fused_mma_info(
            parts, ints(*ks), 1, 0, bm, bn, kc, stages, 0, ctypes.byref(smem),
            ctypes.byref(blocks))
        assert rc == (0 if i == 0 else 1), (parts, ks, bm, bn, kc, stages)
    assert shim.tat_mm_int8_fused_mma_info(
        1, ints(64, 0, 0, 0), 1, len(FK.ACTS), 64, 64, 64, 4, 0,
        ctypes.byref(smem), ctypes.byref(blocks)) == 1
    xs, ws, bias, ep, r = _gemm_operands(GEMM_CASES["1part-k32-n32-silu-res"],
                                         5)
    out = torch.empty((GEMM_M, 32), dtype=torch.int8)
    plan = FK.mm_plan(GEMM_M, 32, (32,), True, H100)
    leaky = FK.epilogue_rows(0.01, 0.05, 0.5, "LEAKY_RELU", 32)
    assert shim.tat_mm_int8_fused_mma(
        *FK._gemm_args(xs, ws, bias, leaky, (1.0,), True, 1.0, r, 0.37, out,
                       plan), None) == 1
    args = list(FK._gemm_args(xs, ws, bias, ep, (1.0,), True, 1.0, None, 0.37,
                              out, plan))
    args[15] = len(FK.ACTS)
    assert shim.tat_mm_int8_fused_mma(*args, None) == 1
    args[15], args[0] = FK._ACT_CODE["SILU"], 5
    assert shim.tat_mm_int8_fused_mma(*args, None) == 1



def _shifted(t):
    """A copy of ``t`` one byte past 16-byte alignment."""
    buf = torch.zeros(1 + t.numel(), dtype=torch.int8)
    o = buf[1:].view(t.shape)
    o.copy_(t)
    return o


# #9 on the 1x1 GEMM under the exact epilogue (tat_mm_int8_requant_mma):
# (K, N, the table's act or None, RoundMode, RELU). M = GEMM_M; K = 1024 ->
# N = 512 (SPPF's cv2 of the zoo yolov5s: several channel blocks, every
# weight resident), N = 255 (the heads, at NONE: no table), K = 48 (off 32,
# zero-filled to 64) and K = 40 (off 16: the byte path), each table act.
HALF, TRUNC = RoundMode.HALF_AWAY, RoundMode.PLUS_HALF_TRUNC
EXACT_GEMM_CASES = {
    "k64-n64-silu-half": (64, 64, "SILU", HALF, False),
    "k64-n64-silu-trunc": (64, 64, "SILU", TRUNC, False),
    "k64-n64-relu-trunc": (64, 64, None, TRUNC, True),
    "k1024-n512-silu": (1024, 512, "SILU", HALF, False),
    "k128-n255-none": (128, 255, None, HALF, False),
    "k48-n96-silu": (48, 96, "SILU", HALF, False),
    "k40-n32-leaky": (40, 32, "LEAKY_RELU", TRUNC, False),
    **{f"k96-n48-{a.lower()}": (96, 48, a, HALF, False)
       for a in ("SIGMOID", "RELU6", "LEAKY_RELU", "TANH", "HARD_SWISH")},
}


def _exact_gemm_operands(case, seed):
    """x, w, bias, the combined scale, the act's table (None: no act)."""
    from thingino_accel_tpu_torch.runtime.executor import act_table
    k, n, act = case[:3]
    rng = np.random.default_rng(seed)
    x, w = _rng_int8(rng, (GEMM_M, k)), _rng_int8(rng, (n, k))
    bias = torch.from_numpy(rng.integers(-3000, 3000, n).astype(np.int32))
    cs = RK.combined_scale(0.05, 0.01, float(0.0137 * np.sqrt(k)))
    lut = act_table(act, 0.043, alpha=0.1) if act else None
    return x, w, bias, cs, lut


def _shim_exact_gemm(shim, x, w, bias, cs, lut, rm, relu, plan):
    out = torch.full((x.shape[0], w.shape[0]), 99, dtype=torch.int8)
    rc = shim.tat_mm_int8_requant_mma(
        *RK._mm_args(x, w, bias, lut, cs, rm, relu, out, plan), None)
    assert rc == 0, plan
    return out


@pytest.mark.parametrize("name", EXACT_GEMM_CASES)
def test_shim_exact_gemm_matches_plain(shim, name):
    """#9 under the exact epilogue, bit for bit against
    ``matmul_int8_requant_plain`` and its table: every plan the planner
    offers at runs of 2 tiles (K = 1024: its first two), the first plan at
    each ring depth and at 32 K bytes a stage, and without a bias; every
    element written (the output starts at 99)."""
    k, n, act, rm, relu = EXACT_GEMM_CASES[name]
    x, w, bias, cs, lut = _exact_gemm_operands(EXACT_GEMM_CASES[name],
                                               len(name))
    ref = RK.matmul_int8_requant_plain(x, w, bias, cs, rm, relu, lut)
    plans = FK.mm_plans(GEMM_M, n, (k,), True, H100, exact=True)
    first = plans[0]
    variants = [dataclasses.replace(p, tiles_per_block=2)
                for p in plans[:2 if k >= 1024 else None]]
    if k < 1024:
        variants += [dataclasses.replace(first, stages=st, tiles_per_block=1)
                     for st in (2, 3, 4)]
        variants.append(dataclasses.replace(first, kc=32, tiles_per_block=3))
    for plan in variants:
        got = _shim_exact_gemm(shim, x, w, bias, cs, lut, rm, relu, plan)
        assert torch.equal(got, ref), plan
    assert torch.equal(
        _shim_exact_gemm(shim, x, w, None, cs, lut, rm, relu, first),
        RK.matmul_int8_requant_plain(x, w, None, cs, rm, relu, lut))


def test_shim_exact_gemm_unaligned_layout_and_refusals(shim):
    """#9 with x, w and the output off 16-byte alignment (the byte path
    and the word stores) equal to its plain version; its kernel's shared
    memory is ``mm_smem(..., exact=True)``'s at every tile, channel block,
    stage width and ring depth (the serving layout plus the 256-byte
    table, 4-byte columns); a plan off the kernel's set and K = 0 are
    refused."""
    x, w, bias, cs, lut = _exact_gemm_operands(
        EXACT_GEMM_CASES["k64-n64-silu-half"], 7)

    ref = RK.matmul_int8_requant_plain(x, w, bias, cs, HALF, False, lut)
    plan = RK.mm_requant_plan(GEMM_M, 64, 64, H100)
    xo, wo, out = _shifted(x), _shifted(w), _shifted(torch.zeros_like(ref))
    rc = shim.tat_mm_int8_requant_mma(
        *RK._mm_args(xo, wo, bias, lut, cs, HALF, False, out, plan), None)
    assert rc == 0 and torch.equal(out, ref)
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    for k in (16, 64, 1024):
        for bm in FK.MM_BMS:
            for bn in FK.MM_BNS + (16,):
                for kc in (32, 128):
                    for stages in FK.MM_STAGES:
                        want = FK.mm_smem((k,), bm, bn, kc, stages, True)
                        assert want == FK.mm_smem((k,), bm, bn, kc, stages) \
                            - 4 * bn + 256
                        rc = shim.tat_mm_int8_requant_mma_info(
                            k, bm, bn, kc, stages, ctypes.byref(smem),
                            ctypes.byref(blocks))
                        if want > H100.per_block:
                            assert rc == 1
                            continue
                        assert rc == 0 and smem.value == want
    for bad in [(0, 64, 64, 64, 4), (64, 96, 64, 64, 4), (64, 64, 48, 64, 4),
                (64, 64, 64, 48, 4), (64, 64, 64, 64, 5)]:
        assert shim.tat_mm_int8_requant_mma_info(
            *bad, ctypes.byref(smem), ctypes.byref(blocks)) == 1, bad


# #7, the depthwise kernel: (batch, H, W, C, KH, KW, pt, pl, OH, OW, act).
# NanoDet's 3x3 with 96 channels (one slab of 6 groups or more slabs),
# C = 37 (the byte path, a ragged group), 272 channels (17 groups: two
# slabs at most), a 5x5 (the kernel that reads its taps from shared
# memory), a 3x2 window with pt 0 / pl 1 and declared output rows and
# columns past the image (their taps read zero).
DW_CASES = {
    "3x3-c96-leaky": (2, 10, 12, 96, 3, 3, 1, 1, 10, 12, "LEAKY_RELU"),
    "3x3-c37-leaky": (2, 9, 11, 37, 3, 3, 1, 1, 9, 11, "LEAKY_RELU"),
    "3x3-c272-relu": (1, 5, 6, 272, 3, 3, 1, 1, 5, 6, "RELU"),
    "5x5-c32-silu": (1, 7, 8, 32, 5, 5, 2, 2, 7, 8, "SILU"),
    "3x2-c16-none-past": (1, 6, 7, 16, 3, 2, 0, 1, 8, 9, "NONE"),
}


def _dw_operands(case, seed):
    nb, h, wd, c, kh, kw, pt, pl, oh, ow, act = case
    rng = np.random.default_rng(seed)
    x, w = _rng_int8(rng, (nb, h, wd, c)), _rng_int8(rng, (kh, kw, c))
    bias = torch.from_numpy(rng.integers(-2000, 2000, c).astype(np.int32))
    ep = FK.epilogue_rows(rng.uniform(0.005, 0.015, c).astype(np.float32),
                          0.01, 0.05, act, c, alpha=0.1)
    pads = ((pt, 0), (pl, 0))
    return x, w, bias, ep, (oh, ow), pads


def _shim_dw(shim, x, w, bias, ep, out_hw, pads, plan, out=None):
    if out is None:
        out = torch.full((x.shape[0],) + tuple(out_hw) + (x.shape[3],), 99,
                         dtype=torch.int8)
    rc = shim.tat_dw_int8_fused(
        *FK._dw_args(x, w, bias, ep, pads, out, plan), None)
    assert rc == 0, plan
    return out


@pytest.mark.parametrize("name", DW_CASES)
def test_shim_dw_matches_plain(shim, name):
    """#7 against ``depthwise_conv2d_int8_fused_plain`` (SILU within its
    bound, the rest bit for bit) at the planner's first plan, at tile
    heights that leave a ragged last tile of rows, at 1 channel group a
    block and the most the kernel takes, and without a bias; every element
    written (the output starts at 99)."""
    case = DW_CASES[name]
    nb, h, wd, c, kh, kw, pt, pl, oh, ow, act = case
    x, w, bias, ep, out_hw, pads = _dw_operands(case, len(name))
    ref = FK.depthwise_conv2d_int8_fused_plain(x, w, bias, ep, out_hw, pads)
    first = FK.dw_plan(nb, oh, ow, c, kh, kw, H100)
    groups = -(-c // 16)
    plans = {first, FK.DwPlan(1, 1), FK.DwPlan(4, min(groups, 16)),
             FK.DwPlan(3, 2), FK.DwPlan(oh, 1)}
    assert oh % 4 or oh % 3   # a ragged last tile
    for plan in sorted(plans, key=str):
        _serving_close(_shim_dw(shim, x, w, bias, ep, out_hw, pads, plan),
                       ref, act)
    _serving_close(_shim_dw(shim, x, w, None, ep, out_hw, pads, first),
                   FK.depthwise_conv2d_int8_fused_plain(x, w, None, ep,
                                                        out_hw, pads), act)


def test_shim_dw_unaligned_layout_and_refusals(shim):
    """#7 with x, w and the output off 16-byte alignment (byte loads and
    byte stores) equal to its plain version; the kernel's shared memory is
    ``dw_smem``'s; a plan off its set (0 rows, 0 or 17 groups) and an
    act past SILU_FAST are refused."""
    case = DW_CASES["3x3-c96-leaky"]
    x, w, bias, ep, out_hw, pads = _dw_operands(case, 11)
    ref = FK.depthwise_conv2d_int8_fused_plain(x, w, bias, ep, out_hw, pads)

    plan = FK.DwPlan(3, 6)
    out = _shifted(torch.zeros_like(ref))
    _shim_dw(shim, _shifted(x), _shifted(w), bias, ep, out_hw, pads, plan, out)
    assert torch.equal(out, ref)
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    for c, kh, kw, ow in [(96, 3, 3, 40), (37, 5, 5, 13), (384, 3, 3, 10)]:
        for th in (1, 2, 7):
            for groups in (1, 3, 16):
                rc = shim.tat_dw_int8_fused_info(c, kh, kw, ow, th, groups,
                                                 ctypes.byref(smem),
                                                 ctypes.byref(blocks))
                assert rc == 0 and smem.value == FK.dw_smem(ow, kh, kw, th,
                                                            groups)
    for th, groups in [(0, 1), (1, 0), (1, 17)]:
        assert shim.tat_dw_int8_fused_info(
            96, 3, 3, 40, th, groups, ctypes.byref(smem),
            ctypes.byref(blocks)) == 1
    args = list(FK._dw_args(x, w, bias, ep, pads, torch.empty_like(ref),
                            plan))
    args[15] = len(FK.ACTS)
    assert shim.tat_dw_int8_fused(*args, None) == 1


# #6, the fused C3 bottleneck (bneck_int8_fused.cu): (batch, H, W, C, CM,
# O, K, shortcut, act). The shapes of tests/test_torch_gpu.py BNECK_CASES
# (H off the tile, C and CM off 16 and 32: the byte path, CM and O over one
# channel block, K = 5; its 16x20x20x128 case at batch 1) and one unit of
# each C on the serving paths at batch 1 (80x80x32 and 20x20x128 with the
# shortcut, 40x40x64 and 20x20x256 without).
BNECK_SHIM_CASES = {
    "b2h13w11-c32-s-silu": (2, 13, 11, 32, 32, 32, 3, True, "SILU"),
    "b1h9w20-c40m80o130-relu": (1, 9, 20, 40, 80, 130, 3, False, "RELU"),
    "b3h7w6-c6m10o6-s-none": (3, 7, 6, 6, 10, 6, 3, True, "NONE"),
    "b1h12w9-c16-k5-s-leaky": (1, 12, 9, 16, 16, 16, 5, False, "LEAKY_RELU"),
    "path-80x80x32-s-silu": (1, 80, 80, 32, 32, 32, 3, True, "SILU"),
    "path-40x40x64-silu": (1, 40, 40, 64, 64, 64, 3, False, "SILU"),
    "path-20x20x128-s-silu": (1, 20, 20, 128, 128, 128, 3, True, "SILU"),
    "path-20x20x256-silu": (1, 20, 20, 256, 256, 256, 3, False, "SILU"),
}


def _bneck_operands(case, seed, act1=None):
    nb, h, w, c, cm, o, k, shortcut, act = case
    rng = np.random.default_rng(seed)
    x = _rng_int8(rng, (nb, h, w, c))
    w1, w2 = _rng_int8(rng, (cm, c)), _rng_int8(rng, (o, k, k, cm))
    b1 = torch.from_numpy(rng.integers(500, 3000, cm).astype(np.int32))
    b2 = torch.from_numpy(rng.integers(-3000, 3000, o).astype(np.int32))
    ep1 = FK.epilogue_rows(rng.uniform(0.005, 0.015, cm).astype(np.float32),
                           0.05, float(0.0137 * np.sqrt(c)), act1 or act, cm,
                           alpha=0.1)
    ep2 = FK.epilogue_rows(rng.uniform(0.005, 0.015, o).astype(np.float32),
                           0.05, float(0.0137 * np.sqrt(k * k * cm)), act, o,
                           alpha=0.1)
    return x, w1, b1, ep1, w2, b2, ep2, shortcut


def _shim_bneck(shim, args, plan, out=None):
    x, w2 = args[0], args[4]
    if out is None:
        out = torch.full(tuple(x.shape[:3]) + (w2.shape[0],), 99,
                         dtype=torch.int8)
    rc = shim.tat_bneck_int8_fused(
        *FK._bneck_args(*args, 0.37, out, plan), None)
    assert rc == 0, plan
    return out


def _bneck_close(got, ref, act1, act2):
    """Bit for bit without SILU; a SILU in the first stage moves m by a
    quantum now and then, and with it the second stage's sums (the two
    stages' tolerance of ``_assert_close``)."""
    if "SILU" in (act1, act2):
        _assert_close(got, ref, "i8-rq-silu-3x3", 2 if act1 == "SILU" else 1)
    else:
        assert torch.equal(got, ref)


@pytest.mark.parametrize("name", BNECK_SHIM_CASES)
def test_shim_bneck_matches_plain(shim, name):
    """#6 against ``bottleneck_int8_fused_plain`` at the planner's plan
    with runs of 3 tiles (crossing images); the small cases also with runs
    of 1 and without the biases; every element written (the output starts
    at 99)."""
    case = BNECK_SHIM_CASES[name]
    nb, h, w, c, cm, o, k, shortcut, act = case
    args = _bneck_operands(case, len(name))
    plan = FK.bneck_plan(nb, h, w, c, cm, o, k, H100)
    _bneck_close(_shim_bneck(shim, args, dataclasses.replace(
        plan, tiles_per_block=3)), FK.bottleneck_int8_fused_plain(
            *args, 0.37), act, act)
    if name.startswith("path"):
        return
    bare = args[:2] + (None,) + args[3:5] + (None,) + args[6:]
    _bneck_close(_shim_bneck(shim, bare, dataclasses.replace(
        plan, tiles_per_block=1)),
        FK.bottleneck_int8_fused_plain(*bare, 0.37), act, act)


@pytest.mark.parametrize("act2", ["NONE", "RELU", "LEAKY_RELU", "SILU"])
@pytest.mark.parametrize("act1", ["SILU", "RELU"])
def test_shim_bneck_every_plan_and_act(shim, act1, act2):
    """#6 on a ragged 1x9x18x48 -> 40 -> 3x3 48 case, with the shortcut
    where the act takes one (C = O = 48), in each second-stage act and two
    first-stage ones (SILU's kernel and the act read at run time), at the
    planner's first plan; SILU -> SILU, the paths' pair, at every tile,
    channel block and w2 residence (resident, streamed a tap at a time) the
    planner offers."""
    shortcut = act2 != "LEAKY_RELU"
    case = (1, 9, 18, 48, 40, 48, 3, shortcut, act2)
    args = _bneck_operands(case, len(act1 + act2), act1)
    ref = FK.bottleneck_int8_fused_plain(*args, 0.37)
    plans = FK.bneck_plans(1, 9, 18, 48, 40, 48, 3, H100)
    assert {(p.tile_h, p.tile_w) for p in plans} == set(FK.CONV_TILES)
    assert {(p.tile_h * p.tile_w // 64, p.bn // 16) for p in plans} == \
        set(FK.FUSED_WARP_TILES)
    assert {p.resident for p in plans} == {True, False}
    for plan in plans if act1 == act2 == "SILU" else plans[:1]:
        _bneck_close(_shim_bneck(shim, args, dataclasses.replace(
            plan, tiles_per_block=2)), ref, act1, act2)


def test_shim_bneck_unaligned_layout_and_refusals(shim):
    """#6 with x, w1, w2 and the output off 16-byte alignment (byte loads,
    narrow stores) equal to its plain version; the kernel's shared memory
    is ``bneck_smem``'s at every tile and channel block; plans off its set,
    an even K, a shortcut with C != O or LEAKY_RELU, and an act past
    SILU_FAST are refused."""
    case = BNECK_SHIM_CASES["b2h13w11-c32-s-silu"]
    args = _bneck_operands(case, 5)
    ref = FK.bottleneck_int8_fused_plain(*args, 0.37)
    shifted = (_shifted(args[0]), _shifted(args[1]), args[2], args[3],
               _shifted(args[4])) + args[5:]
    plan = FK.bneck_plan(2, 13, 11, 32, 32, 32, 3, H100)
    out = _shim_bneck(shim, shifted, plan, _shifted(torch.zeros_like(ref)))
    _bneck_close(out, ref, "SILU", "SILU")
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    n = 0
    for c, cm, k in [(32, 32, 3), (40, 80, 5), (256, 256, 3), (6, 10, 1)]:
        for th, tw in FK.CONV_TILES:
            for bn in FK.FUSED_BNS:
                for res in (1, 0):
                    want = FK.bneck_smem(c, cm, k, th, tw, bn, bool(res))
                    rc = shim.tat_bneck_int8_fused_info(
                        3, 0, c, cm, k, th, tw, bn, res, 0,
                        ctypes.byref(smem), ctypes.byref(blocks))
                    n += 1
                    if (th * tw // 64, bn // 16) not in FK.FUSED_WARP_TILES \
                            or want > H100.per_block:
                        assert rc == 1
                        continue
                    assert rc == 0 and smem.value == want
                    assert blocks.value == 233472 // (want + 1024)
    assert n == 144
    # act1, act2, C, CM, K, tile_h, tile_w, bn, resident: tile_w 12, 96
    # pixels, bn 16 and 48, an even K, an act past SILU_FAST in either stage
    for bad in [(3, 3, 32, 32, 3, 8, 12, 32, 1),
                (3, 3, 32, 32, 3, 12, 8, 32, 1),
                (3, 3, 32, 32, 3, 8, 8, 16, 0), (3, 3, 32, 32, 3, 8, 8, 48, 1),
                (3, 3, 32, 32, 4, 8, 8, 32, 1), (5, 3, 32, 32, 3, 8, 8, 32, 0),
                (3, 5, 32, 32, 3, 8, 8, 32, 1)]:
        assert shim.tat_bneck_int8_fused_info(
            *bad, 0, ctypes.byref(smem), ctypes.byref(blocks)) == 1, bad
    x, w1, b1, ep1, w2, b2, ep2, _ = args
    cut = w2[:16].contiguous()   # O = 16 != C with the shortcut
    out = torch.empty((2, 13, 11, 16), dtype=torch.int8)
    assert shim.tat_bneck_int8_fused(*FK._bneck_args(
        x, w1, b1, ep1, cut, b2[:16].contiguous(),
        FK.epilogue_rows(0.01, 0.05, 0.5, "SILU", 16), True, 0.37, out,
        plan), None) == 1
    leaky = FK.epilogue_rows(0.01, 0.05, 0.5, "LEAKY_RELU", 32)
    assert shim.tat_bneck_int8_fused(*FK._bneck_args(
        x, w1, b1, ep1, w2, b2, leaky, True, 0.37, torch.empty_like(ref),
        plan), None) == 1


# #4, the fused SPPF (sppf_int8_fused.cu): (batch, H, W, C, O, k, act,
# negative). The shapes of tests/test_torch_gpu.py SPPF_CASES (C % 16 != 0:
# the byte path; k = 3; O over one channel block; a width whose staged rows
# pass 48 KB), each also with every input below 0 (the -128 padding shows),
# and the zoo yolov5s's 20x20x256 -> 512 unit at batch 1.
SPPF_SHIM_CASES = {
    "b2h6w7-c36-o20-silu": (2, 6, 7, 36, 20, 5, "SILU", False),
    "b2h6w7-c36-o20-silu-neg": (2, 6, 7, 36, 20, 5, "SILU", True),
    "b1h9w4-c10-o8-k3-leaky": (1, 9, 4, 10, 8, 3, "LEAKY_RELU", False),
    "b1h9w4-c10-o8-k3-leaky-neg": (1, 9, 4, 10, 8, 3, "LEAKY_RELU", True),
    "b2h12w30-c33-o70-relu": (2, 12, 30, 33, 70, 5, "RELU", False),
    "b2h12w30-c33-o70-relu-neg": (2, 12, 30, 33, 70, 5, "RELU", True),
    "b1h20w40-c32-o16-none": (1, 20, 40, 32, 16, 5, "NONE", False),
    "b1h20w40-c32-o16-none-neg": (1, 20, 40, 32, 16, 5, "NONE", True),
    "path-20x20x256-o512-silu": (1, 20, 20, 256, 512, 5, "SILU", False),
}


def _sppf_operands(case, seed):
    nb, h, w, c, o, k, act, negative = case
    rng = np.random.default_rng(seed)
    x = _rng_int8(rng, (nb, h, w, c))
    if negative:
        x = -(x.to(torch.int32).abs().clamp(1, 128)).to(torch.int8)
    wt = _rng_int8(rng, (o, 4 * c))
    bias = torch.from_numpy(rng.integers(-3000, 3000, o).astype(np.int32))
    ep = FK.epilogue_rows(rng.uniform(0.005, 0.015, o).astype(np.float32),
                          0.05, float(0.0137 * np.sqrt(4 * c)), act, o,
                          alpha=0.1)
    return x, wt, bias, ep


def _shim_sppf(shim, x, wt, bias, ep, k, plan, out=None):
    if out is None:
        out = torch.full(tuple(x.shape[:3]) + (wt.shape[0],), 99,
                         dtype=torch.int8)
    rc = shim.tat_sppf_int8_fused(*FK._sppf_args(x, wt, bias, ep, k, out,
                                                 plan), None)
    assert rc == 0, plan
    return out


@pytest.mark.parametrize("name", SPPF_SHIM_CASES)
def test_shim_sppf_matches_plain(shim, name):
    """#4 against ``sppf_int8_fused_plain`` at the planner's plan with runs
    of 3 tiles (crossing images); the small cases also with runs of 1 and
    without a bias; every element written (the output starts at 99)."""
    case = SPPF_SHIM_CASES[name]
    nb, h, w, c, o, k, act, _ = case
    x, wt, bias, ep = _sppf_operands(case, len(name))
    plan = FK.sppf_plan(nb, h, w, c, o, k, H100)
    _serving_close(_shim_sppf(shim, x, wt, bias, ep, k, dataclasses.replace(
        plan, tiles_per_block=3)),
        FK.sppf_int8_fused_plain(x, wt, bias, ep, k), act)
    if name.startswith("path"):
        return
    _serving_close(_shim_sppf(shim, x, wt, None, ep, k, dataclasses.replace(
        plan, tiles_per_block=1)),
        FK.sppf_int8_fused_plain(x, wt, None, ep, k), act)


@pytest.mark.parametrize("act", ["NONE", "RELU", "LEAKY_RELU", "SILU"])
def test_shim_sppf_every_plan_and_act(shim, act):
    """#4 on a 1x11x13x100 -> 80 case (the byte path; C in one, two or
    four chunks, the last one ragged) in each act at the planner's first
    plan; at SILU, the paths' act, at every (bm, bn, ck) the planner
    offers."""
    case = (1, 11, 13, 100, 80, 5, act, False)
    x, wt, bias, ep = _sppf_operands(case, len(act))
    ref = FK.sppf_int8_fused_plain(x, wt, bias, ep, 5)
    plans = FK.sppf_plans(1, 11, 13, 100, 80, 5, H100)
    assert {(p.bm // 64, p.bn // 16) for p in plans} == \
        set(FK.FUSED_WARP_TILES)
    assert {p.ck for p in plans} == set(FK.SPPF_CKS)
    for plan in plans if act == "SILU" else plans[:1]:
        _serving_close(_shim_sppf(shim, x, wt, bias, ep, 5, dataclasses.replace(
            plan, tiles_per_block=2)), ref, act)


def test_shim_sppf_unaligned_layout_and_refusals(shim):
    """#4 with y, w and the output off 16-byte alignment (byte loads,
    narrow stores) equal to its plain version; the kernel's shared memory
    is ``sppf_smem``'s at every tile, channel block and chunk; plans off its
    set, an even k and an act past SILU_FAST are refused."""
    case = SPPF_SHIM_CASES["b1h20w40-c32-o16-none"]
    x, wt, bias, ep = _sppf_operands(case, 3)
    ref = FK.sppf_int8_fused_plain(x, wt, bias, ep, 5)
    plan = FK.sppf_plan(1, 20, 40, 32, 16, 5, H100)
    out = _shifted(torch.zeros_like(ref))
    _shim_sppf(shim, _shifted(x), _shifted(wt), bias, ep, 5, plan, out)
    assert torch.equal(out, ref)
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    n = 0
    for h, w, c, k in [(20, 20, 256, 5), (6, 7, 36, 5), (9, 4, 10, 3),
                       (64, 96, 64, 5)]:
        for bm in (64, 128):
            for bn in FK.FUSED_BNS:
                for ck in FK.SPPF_CKS:
                    want = FK.sppf_smem(h, w, c, k, bm, bn, ck)
                    rc = shim.tat_sppf_int8_fused_info(
                        3, h, w, c, k, bm, bn, ck, 0, ctypes.byref(smem),
                        ctypes.byref(blocks))
                    n += 1
                    if (bm // 64, bn // 16) not in FK.FUSED_WARP_TILES \
                            or want > H100.per_block:
                        assert rc == 1
                        continue
                    assert rc == 0 and smem.value == want
                    assert blocks.value == 233472 // (want + 1024)
    assert n == 72
    # act, H, W, C, k, bm, bn, ck: bm 96, bn 16, ck 48, an even k, an act
    # past SILU_FAST
    for bad in [(3, 20, 20, 64, 5, 96, 32, 32), (3, 20, 20, 64, 5, 64, 16, 32),
                (3, 20, 20, 64, 5, 64, 32, 48), (3, 20, 20, 64, 4, 64, 32, 32),
                (5, 20, 20, 64, 5, 64, 32, 32)]:
        assert shim.tat_sppf_int8_fused_info(
            *bad, 0, ctypes.byref(smem), ctypes.byref(blocks)) == 1, bad


# The head decode (#8, decode_fused.cu): (batch, level sizes (h, w), A, NC)
# small heads; ragged row counts under the 128-unit run, A = 1 and 3, NC =
# 1, 80 and 300 (an f32 run of 26 units), and a unit too large to stage
# (int8 NC 33000, f32 NC 8200), which the whole block decodes
from thingino_accel_tpu_torch.models import yolo as Y  # noqa: E402

DECODE_SHIM_CASES = {
    "3lv-a3-nc80": (2, ((9, 7), (5, 5), (3, 2)), 3, 80),
    "1lv-a1-nc1": (3, ((6, 11),), 1, 1),
    "2lv-a3-nc300": (1, ((4, 5), (2, 3)), 3, 300),
    "4lv-a1-nc80": (1, ((12, 12), (6, 6), (3, 3), (1, 2)), 1, 80),
    "1lv-a1-whole-block": (2, ((1, 2),), 1, None),
}


def _shim_decode(shim, heads, anchors, strides, nc, scales):
    """One launch of the shim's decode on CPU tensors."""
    n_lv, a = len(heads), anchors.shape[1]
    b = heads[0].shape[0]
    n = sum(h.shape[1] * h.shape[2] * a for h in heads)
    boxes = torch.full((b, n, 4), -7.0)
    conf = torch.full((b, n), -7.0)
    cls = torch.full((b, n), -7, dtype=torch.int32)
    sc = [1.0 if scales is None else float(np.float32(s)) for s in
          (scales or [None] * n_lv)]
    anc = np.ascontiguousarray(anchors[:n_lv], np.float32).ravel()
    rc = shim.tat_decode_fused(
        n_lv, (ctypes.c_void_p * n_lv)(*(h.data_ptr() for h in heads)),
        (ctypes.c_int * n_lv)(*(h.shape[1] for h in heads)),
        (ctypes.c_int * n_lv)(*(h.shape[2] for h in heads)),
        (ctypes.c_float * n_lv)(*(float(s) for s in strides[:n_lv])),
        (ctypes.c_float * n_lv)(*sc), (ctypes.c_float * anc.size)(*anc),
        b, a, nc, DK.ELEM_CODES[heads[0].dtype], boxes.data_ptr(),
        conf.data_ptr(), cls.data_ptr(), None)
    assert rc == 0
    return boxes, conf, cls


def _decode_close(got, ref):
    np.testing.assert_allclose(got[0].numpy(), ref[0].numpy(), rtol=1e-6,
                               atol=1e-5, equal_nan=True)
    np.testing.assert_allclose(got[1].numpy(), ref[1].numpy(), rtol=1e-6,
                               atol=1e-7, equal_nan=True)
    np.testing.assert_array_equal(got[2].numpy(), ref[2].numpy())


def _offset_view(t, off):
    """``t``'s values in a fresh buffer, ``off`` bytes past its start."""
    flat = torch.empty(t.numel() * t.element_size() + 64, dtype=torch.uint8)
    base = (-flat.data_ptr()) % 16 + off
    v = flat[base:base + t.numel() * t.element_size()].view(t.dtype)
    v.copy_(t.reshape(-1))
    return v.view(t.shape)


@pytest.mark.parametrize("dtype", ["int8", "f32", "bf16"])
@pytest.mark.parametrize("name", DECODE_SHIM_CASES)
def test_shim_decode_matches_plain(shim, name, dtype):
    """The decode kernel against ``decode_and_parse`` (the plain version):
    ties among int8 classes (values drawn from five), NaN rows in f32 and
    bf16 (all classes, one class), ties among bf16 classes, int8 heads at
    odd byte offsets and bf16 heads at even ones off 16 (the staged range
    aligned inside the kernel)."""
    nb, hws, a, nc = DECODE_SHIM_CASES[name]
    if nc is None:
        nc = {"int8": 33000, "f32": 8200, "bf16": 16500}[dtype]
    rng = np.random.default_rng(len(name) + nc)
    anchors = np.asarray(rng.uniform(4, 60, (len(hws), a, 2)), np.float32)
    strides = (8, 16, 32, 64)[:len(hws)]
    heads = []
    for i, (h, w) in enumerate(hws):
        if dtype == "int8":
            v = (rng.integers(-3, 2, (nb, h, w, a * (5 + nc))) * 40).astype(
                np.int8)
            v[..., ::7] = rng.integers(-128, 128, v[..., ::7].shape)
            t = torch.from_numpy(v)
            heads.append(_offset_view(t, (3 * i + 1) % 16))
        else:
            v = rng.normal(0, 2, (nb, h, w, a, 5 + nc)).astype(np.float32)
            v[0, 0, 0, 0, 5:] = np.nan
            v[..., 5 + nc // 2][rng.random((nb, h, w, a)) < 0.2] = np.nan
            t = torch.from_numpy(v.reshape(nb, h, w, -1))
            if dtype == "bf16":
                t[..., 5::4] = torch.round(t[..., 5::4])   # class ties
                t = _offset_view(t.to(torch.bfloat16), (2 * i + 2) % 16)
            heads.append(t)
    scales = (list(rng.uniform(0.03, 0.06, len(hws))) if dtype == "int8"
              else None)
    got = _shim_decode(shim, heads, anchors, strides, nc, scales)
    ref = Y.decode_and_parse([h.contiguous() for h in heads], anchors,
                             strides, nc, scales)
    _decode_close(got, ref)
    if dtype != "int8":
        assert int(got[2][0, 0]) == 0   # the all-NaN row: the first NaN


def test_shim_decode_refusals(shim):
    """Levels, anchors, classes, batch and an f32 head off 4 bytes are
    refused by the kernel's entry."""
    h = torch.zeros((1, 2, 2, 85 * 3))
    anchors = np.ones((4, 9, 2), np.float32)
    args = [(0, [h], 3, 80), (5, [h] * 5, 3, 80), (1, [h], 9, 80),
            (1, [h], 3, 0), (1, [h], 3, 65536)]
    for n_lv, hs, a, nc in args:
        n = max(n_lv, 1)
        rc = shim.tat_decode_fused(
            n_lv, (ctypes.c_void_p * n)(*(t.data_ptr() for t in hs[:n])),
            (ctypes.c_int * n)(*[2] * n), (ctypes.c_int * n)(*[2] * n),
            (ctypes.c_float * n)(*[8.0] * n), (ctypes.c_float * n)(*[1.0] * n),
            (ctypes.c_float * 72)(*anchors.ravel()), 1, a, nc, 0,
            h.data_ptr(), h.data_ptr(), h.data_ptr(), None)
        assert rc == 1, (n_lv, a, nc)
    out = torch.zeros(64)
    rc = shim.tat_decode_fused(
        1, (ctypes.c_void_p * 1)(h.data_ptr() + 2), (ctypes.c_int * 1)(1),
        (ctypes.c_int * 1)(1), (ctypes.c_float * 1)(8.0),
        (ctypes.c_float * 1)(1.0), (ctypes.c_float * 72)(*anchors.ravel()),
        1, 3, 80, 0, out.data_ptr(), out.data_ptr(), out.data_ptr(), None)
    assert rc == 1
