"""The serving kernels' JAX modes rehearsed without a card: SILU_FAST (the
Pade sigmoid of ``TAT_FAST_SILU``) in every serving kernel's epilogue, and
the bf16 product (``TAT_SERVING_COMPUTE=bf16``: the int8 values widened
in registers into two ``mma.sync`` m16n8k16 bf16 steps a 32-byte K step,
f32 sums, the epilogue from ``(acc + f32(bias)) * cs``) in #1/#3
(``mm_int8_fused_mma.cu``), #2/#5 (``conv_int8_fused_mma.cu``), #4
(``sppf_int8_fused.cu``) and #6 (``bneck_int8_fused.cu``); SILU_FAST also
in #7 (``dw_int8_fused.cu``).

The sources are compiled for the CPU with g++ and ``tests/cuda_shim/
shim.h``, rewritten as ``tests/test_torch_cuda_shim.py`` rewrites them
(its ``rewrite``); the shim runs ``mma.sync`` bf16 from the PTX ISA's
fragment tables, each output's 16 products summed exactly and added to its
f32 sum with one rounding. Only the five serving sources are built here.

Tolerances: SILU_FAST bit for bit (both sides divide in IEEE f32); bf16 bit
for bit against the plain bf16 version and against the int8 kernel while
every partial sum stays below 2^24 in magnitude (every case but one), and
within one quantum where the sums pass it (K = 2048 of large values: the
kernel's f32 sums round at other places than the plain version's one
rounding of the exact sum); SILU within its bound (the host ``expf`` and
torch's sigmoid differ by ulps). Skips where g++ is absent.
"""

import ctypes
import dataclasses
import shutil
import subprocess

import numpy as np
import pytest
import torch

import test_torch_cuda_shim as T
from thingino_accel_tpu_torch.ops import cuda_build
from thingino_accel_tpu_torch.ops import fused_kernels as FK

SOURCES = ("mm_int8_fused_mma.cu", "conv_int8_fused_mma.cu",
           "bneck_int8_fused.cu", "sppf_int8_fused.cu", "dw_int8_fused.cu")
ENTRIES = ("tat_mm_int8_fused_mma", "tat_mm_int8_fused_mma_info",
           "tat_conv_int8_fused_mma", "tat_conv_int8_fused_mma_info",
           "tat_bneck_int8_fused", "tat_bneck_int8_fused_info",
           "tat_sppf_int8_fused", "tat_sppf_int8_fused_info",
           "tat_dw_int8_fused")
H100 = T.H100


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the CUDA sources for the CPU")
    d = tmp_path_factory.mktemp("cuda_shim_modes")
    for name in SOURCES + cuda_build.HEADERS:
        (d / name).write_text(T.rewrite((cuda_build.CSRC / name).read_text()))
    lib = d / "libtat_shim_modes.so"
    flags = [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC",
             "-pthread", "-w", "-include", str(T.SHIM), "-I", str(d)]
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


def _close(got, ref, act):
    """SILU within its bound, the rest (SILU_FAST too) bit for bit."""
    T._serving_close(got, ref, act)


def _full(shape):
    return torch.full(shape, 99, dtype=torch.int8)


# --- #1 and #3: the 1x1 GEMM ---------------------------------------------

# (GEMM case of tests/test_torch_cuda_shim.py, act, compute)
GEMM_MODES = [("1part-k32-n32-silu-res", "SILU_FAST", "int8"),
              ("1part-k32-n32-silu-res", "SILU_FAST", "bf16"),
              ("1part-k64-n255-none", "NONE", "bf16"),
              ("2part-k64+64-n128-silu-equal", "SILU", "bf16"),
              ("2part-k64+64-n128-silu-perpart", "SILU_FAST", "bf16"),
              ("4part-k16+32+64+128-n40-leaky-perpart", "LEAKY_RELU",
               "bf16")]


def _gemm(shim, xs, ws, bias, ep, r, compute, plan=None):
    n = ws[0].shape[0]
    out = _full((xs[0].shape[0], n))
    if isinstance(ep, FK.Epilogue):
        part_scales, same, bias_scale, e = (1.0,) * len(xs), True, 1.0, ep
    else:
        part_scales, same, bias_scale, e = (ep.part_scales, ep.same_scale,
                                            ep.bias_scale, ep.ep)
    if plan is None:
        plan = FK.mm_plan(xs[0].shape[0], n, [x.shape[1] for x in xs], same,
                          H100)
    rc = shim.tat_mm_int8_fused_mma(
        *FK._gemm_args(xs, ws, bias, e, part_scales, same, bias_scale, r,
                       0.37, out, plan, compute), None)
    assert rc == 0, plan
    return out


def _gemm_plain(xs, ws, bias, ep, r, compute):
    if isinstance(ep, FK.Epilogue):
        return FK.matmul_int8_fused_plain(xs[0], ws[0], bias, ep, r, 0.37,
                                          compute)
    return FK.matmul_int8_fused_multi_plain(xs, ws, bias, ep, r, 0.37,
                                            compute)


@pytest.mark.parametrize("name,act,compute", GEMM_MODES, ids=str)
def test_shim_gemm_modes_match_plain(shim, name, act, compute):
    """#1 / #3 in a mode against the plain version in the same mode (one
    part, equal and per-part scales, the residual, N = 255); bf16 also bit
    for bit against the int8 kernel (every sum here is below 2^24)."""
    ks, n, _, per_part, res = T.GEMM_CASES[name]
    xs, ws, bias, ep, r = T._gemm_operands((ks, n, act, per_part, res),
                                           len(name))
    got = _gemm(shim, xs, ws, bias, ep, r, compute)
    _close(got, _gemm_plain(xs, ws, bias, ep, r, compute), act)
    if compute == "bf16":
        assert torch.equal(got, _gemm(shim, xs, ws, bias, ep, r, "int8"))


def test_shim_gemm_bf16_past_2_24(shim):
    """K = 2048 of values in [100, 127] (signs mixed by row and column):
    sums to about 2^25, where f32 rounds; the bf16 kernel within one
    quantum of the plain bf16 version and of the int8 kernel, most values
    equal."""
    rng = np.random.default_rng(24)
    m, k, n = 70, 2048, 32
    sx = rng.choice([-1, 1], (m, 1)) * rng.integers(100, 128, (m, k))
    sw = rng.choice([-1, 1], (n, 1)) * rng.integers(100, 128, (n, k))
    x = torch.from_numpy(sx.astype(np.int8))
    w = torch.from_numpy(sw.astype(np.int8))
    acc = FK._mm_acc(x, w)
    assert int(acc.abs().min()) > 2 ** 24
    ep = FK.epilogue_rows(np.float32(3.0e-6), 1.0, 1.0, "NONE", n)
    got = _gemm(shim, [x], [w], None, ep, None, "bf16")
    for ref in (FK.matmul_int8_fused_plain(x, w, None, ep, compute="bf16"),
                _gemm(shim, [x], [w], None, ep, None, "int8")):
        d = (got.to(torch.int32) - ref.to(torch.int32)).abs()
        assert int(d.max()) <= 1 and float((d > 0).double().mean()) < 0.5
    assert int(got.to(torch.int32).abs().max()) < 127   # not saturated


# --- #2 / #5: the KxK conv ----------------------------------------------

# (serving case, mode, act, compute): both modes of the core, the stem
CONV_MODES = [("3x3s1-c32-silu-res", "slab", "SILU_FAST", "int8"),
              ("3x3s1-c32-silu-res", "slab", "SILU", "bf16"),
              ("3x3s1-c64-relu-res", "im2col", "SILU_FAST", "bf16"),
              ("stem6x6s2-c3-o16", "im2col", "SILU_FAST", "bf16")]


def _conv(shim, x, wt, bias, ep, out_hw, pads, s, res, plan, compute):
    out = _full((x.shape[0],) + out_hw + (wt.shape[0],))
    rc = shim.tat_conv_int8_fused_mma(
        *FK._conv_args(x, wt, bias, ep, pads, s, res, 0.37, out, plan,
                       compute), None)
    assert rc == 0, plan
    return out


@pytest.mark.parametrize("name,mode,act,compute", CONV_MODES, ids=str)
def test_shim_conv_modes_match_plain(shim, name, mode, act, compute):
    """#2 / #5 in a mode at the planner's plan (runs of 2 tiles) against
    ``conv2d_int8_halo_fused_plain`` in the same mode; bf16 also bit for
    bit against the int8 kernel."""
    nb, h, w, c, o, k, s, pads, _, res = T.SERVING_CASES[name]
    x, wt, bias, ep, out_hw, r = T._serving_operands(
        (nb, h, w, c, o, k, s, pads, act, res), len(name))
    plan = dataclasses.replace(
        FK.conv_plan(nb, *out_hw, c, o, k, k, (s, s), (1, 1), mode, H100,
                     FK.serving_bns(o)), tiles_per_block=2)
    assert plan.mode == mode
    got = _conv(shim, x, wt, bias, ep, out_hw, pads, s, r, plan, compute)
    _close(got, FK.conv2d_int8_halo_fused_plain(
        x, wt, bias, ep, out_hw, pads, s, r, 0.37, compute), act)
    if compute == "bf16":
        assert torch.equal(got, _conv(shim, x, wt, bias, ep, out_hw, pads, s,
                                      r, plan, "int8"))


# --- #6 and #4 -----------------------------------------------------------

@pytest.mark.parametrize("act,compute", [("SILU_FAST", "int8"),
                                         ("SILU", "bf16"),
                                         ("SILU_FAST", "bf16")], ids=str)
def test_shim_bneck_modes_match_plain(shim, act, compute):
    """#6 (both stages in the act, the shortcut, two images, runs of 3
    tiles) against ``bottleneck_int8_fused_plain`` in the same mode; bf16
    also bit for bit against the int8 kernel where the act is exact."""
    case = T.BNECK_SHIM_CASES["b2h13w11-c32-s-silu"]
    nb, h, w, c, cm, o, k = case[:7]
    args = T._bneck_operands(case[:8] + (act,), 7)
    plan = dataclasses.replace(FK.bneck_plan(nb, h, w, c, cm, o, k, H100),
                               tiles_per_block=3)

    def run(cmp):
        out = _full((nb, h, w, o))
        assert shim.tat_bneck_int8_fused(
            *FK._bneck_args(*args, 0.37, out, plan, cmp), None) == 0
        return out
    got = run(compute)
    T._bneck_close(got, FK.bottleneck_int8_fused_plain(
        *args, 0.37, compute=compute), act, act)
    if compute == "bf16" and act == "SILU_FAST":
        assert torch.equal(got, run("int8"))


@pytest.mark.parametrize("act,compute", [("SILU_FAST", "int8"),
                                         ("SILU_FAST", "bf16"),
                                         ("RELU", "bf16")], ids=str)
def test_shim_sppf_modes_match_plain(shim, act, compute):
    """#4 (two images, runs of 3 tiles) against ``sppf_int8_fused_plain``
    in the same mode (bf16: four level sums added in f32, as JAX's); bf16
    also bit for bit against the int8 kernel."""
    nb, h, w, c, o, k, _, neg = T.SPPF_SHIM_CASES["b2h6w7-c36-o20-silu"]
    x, wt, bias, ep = T._sppf_operands((nb, h, w, c, o, k, act, neg), 3)
    plan = dataclasses.replace(FK.sppf_plan(nb, h, w, c, o, k, H100),
                               tiles_per_block=3)

    def run(cmp):
        out = _full((nb, h, w, o))
        assert shim.tat_sppf_int8_fused(
            *FK._sppf_args(x, wt, bias, ep, k, out, plan, cmp), None) == 0
        return out
    got = run(compute)
    _close(got, FK.sppf_int8_fused_plain(x, wt, bias, ep, k, compute), act)
    if compute == "bf16":
        assert torch.equal(got, run("int8"))


@pytest.mark.parametrize("name", ["3x3-c37-leaky", "5x5-c32-silu"])
def test_shim_dw_silu_fast_matches_plain(shim, name):
    """#7 with SILU_FAST (its own kernel: the 3x3 window in registers, and
    any other size) against its plain version, bit for bit."""
    case = T.DW_CASES[name][:-1] + ("SILU_FAST",)
    nb, h, wd, c, kh, kw, pt, pl, oh, ow, _ = case
    x, w, bias, ep, out_hw, pads = T._dw_operands(case, 5)
    plan = FK.dw_plan(nb, oh, ow, c, kh, kw, H100)
    out = _full((nb, oh, ow, c))
    assert shim.tat_dw_int8_fused(
        *FK._dw_args(x, w, bias, ep, pads, out, plan), None) == 0
    assert torch.equal(out, FK.depthwise_conv2d_int8_fused_plain(
        x, w, bias, ep, out_hw, pads))


def test_shim_modes_layout_and_refusals(shim):
    """Both products of each kernel take the same shared memory (the modes
    change no layout), SILU_FAST too; a product past bf16 is refused."""
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    out = (ctypes.byref(smem), ctypes.byref(blocks))

    def info(fn, *args):
        rc = fn(*args, *out)
        return rc, smem.value

    plan = FK.MmPlan(64, 64, 64, 4, 1)
    for act in ("SILU", "SILU_FAST"):
        int8 = info(shim.tat_mm_int8_fused_mma_info,
                    *FK._gemm_info_args(plan, (64, 32), False, act))
        bf16 = info(shim.tat_mm_int8_fused_mma_info,
                    *FK._gemm_info_args(plan, (64, 32), False, act, "bf16"))
        assert int8 == bf16 == (0, FK.mm_smem((64, 32), 64, 64, 64, 4))
    args = list(FK._gemm_info_args(plan, (64,), True, "SILU"))
    args[-1] = len(FK.COMPUTES)
    assert info(shim.tat_mm_int8_fused_mma_info, *args)[0] == 1

    want = FK.conv_smem("slab", 64, 3, 3, (1, 1), (1, 1), 8, 16, 64, 64, True)
    for act in (3, 4):
        for compute in (0, 1):
            assert info(shim.tat_conv_int8_fused_mma_info, act, 0, 64, 3, 3,
                        1, 8, 16, 64, 64, 1, compute) == (0, want)
    assert info(shim.tat_conv_int8_fused_mma_info, 3, 0, 64, 3, 3, 1, 8, 16,
                64, 64, 1, 2)[0] == 1

    want = FK.bneck_smem(32, 32, 3, 8, 16, 64, True)
    for act in (3, 4):
        for compute in (0, 1):
            assert info(shim.tat_bneck_int8_fused_info, act, act, 32, 32, 3,
                        8, 16, 64, 1, compute) == (0, want)
    assert info(shim.tat_bneck_int8_fused_info, 3, 3, 32, 32, 3, 8, 16, 64,
                1, 2)[0] == 1

    sp = FK.sppf_plan(1, 20, 20, 256, 512, 5, H100)
    want = FK.sppf_smem(20, 20, 256, 5, sp.bm, sp.bn, sp.ck)
    for act in (3, 4):
        for compute in (0, 1):
            assert info(shim.tat_sppf_int8_fused_info, act, 20, 20, 256, 5,
                        sp.bm, sp.bn, sp.ck, compute) == (0, want)
    assert info(shim.tat_sppf_int8_fused_info, 3, 20, 20, 256, 5, sp.bm,
                sp.bn, sp.ck, 2)[0] == 1
