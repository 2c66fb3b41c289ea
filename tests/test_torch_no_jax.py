"""The port stands alone: it runs where JAX is not installed (the GPU
machine lists none) and imports nothing of the JAX package.

- A fresh interpreter with ``jax`` and ``thingino_accel_tpu`` blocked
  imports the package, runs a `.mars` model on the CPU, builds the zoo
  yolov5n and nanodet and runs them through the planned serving tier,
  runs the exact tier in full and compat mode, the KxK conv's
  ``pipeline="dma"`` mode (its plain version on the CPU) and plan, the
  1x1 GEMM's plan and the multi-part 1x1, the letterbox's taps, one
  tiny chain of each probe (E1, E3, the ladder's kernel rung), one tiny
  ``build()`` of E2's (``probes.pipeline``), and the fast tier (its
  rewrites, s2d stem, bf16 pipeline and decode, NanoDet's depthwise
  convs).
- No module of the port and no line of ``chip_smoke.py`` holds an
  ``import`` of ``thingino_accel_tpu`` (parsed with ``ast``, so an import
  inside a function counts too).
"""

import ast
import os
import subprocess
import sys
import textwrap

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

SCRIPT = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None          # any `import jax` now raises
    sys.modules["thingino_accel_tpu"] = None   # and so does the JAX package
    import numpy as np
    import thingino_accel_tpu_torch
    from thingino_accel_tpu_torch import EngineOptions
    from thingino_accel_tpu_torch.models import yolo
    from thingino_accel_tpu_torch.runtime import serving
    from thingino_accel_tpu_torch.ops import cuda_build
    eng = thingino_accel_tpu_torch.Engine.from_mars(
        "models/fixtures/test_conv.mars", device="cpu")
    x = np.random.default_rng(0).integers(-128, 128, (2, 64, 64, 3),
                                          dtype=np.int8)
    out = eng.run_np(x)["output"]
    assert out.shape == (2, 64, 64, 16) and out.dtype == np.int8
    assert out.min() >= 0             # the conv's fused RELU
    from thingino_accel_tpu_torch.models import zoo
    from thingino_accel_tpu_torch.runtime import planner
    g = zoo.build_yolov5("n", zoo.ZooConfig(in_hw=(64, 64)))
    serving = EngineOptions(precision="serving")
    assert EngineOptions().precision == "exact"
    eng = thingino_accel_tpu_torch.Engine(g, serving, device="cpu")
    assert eng._fn.plan is not None and eng._fn.plan.sppf
    heads = eng.run_np(np.zeros((1, 64, 64, 3), np.int8))
    assert [h.shape for h in heads.values()] == [
        (1, 8, 8, 255), (1, 4, 4, 255), (1, 2, 2, 255)]
    for mode in ("full", "compat"):
        ex = thingino_accel_tpu_torch.Engine(
            g, EngineOptions(precision="exact", mode=mode), device="cpu")
        assert ex._fn.launch_census() == {
            "matmul_int8_requant": 42, "conv2d_int8_halo": 11,
            "conv2d_int8": 7, "plain_convs": 0}
        got = ex.run_np(x[:1])
        assert [h.shape for h in got.values()] == [
            (1, 8, 8, 255), (1, 4, 4, 255), (1, 2, 2, 255)]
    eng = thingino_accel_tpu_torch.Engine(
        zoo.build_nanodet(zoo.ZooConfig(in_hw=(64, 64))), serving,
        device="cpu")
    assert eng._fn.launch_census()["depthwise_conv2d_int8_fused"] == 6
    heads = eng.run_np(np.zeros((1, 64, 64, 3), np.int8))
    assert [h.shape for h in heads.values()] == [
        (1, 8, 8, 84), (1, 4, 4, 84), (1, 2, 2, 84)]
    from thingino_accel_tpu_torch.ops import decode_kernel
    from thingino_accel_tpu_torch.ops import fused_kernels as FK
    import torch
    xt = torch.from_numpy(x[:1, :16, :16])
    wt = torch.ones((8, 3, 3, 3), dtype=torch.int8)
    ep = FK.epilogue_rows(0.01, 0.05, 0.1, "RELU", 8)
    got = FK.conv2d_int8_halo_fused(xt, wt, None, ep, (8, 8),
                                    ((1, 1), (1, 1)), 2, pipeline="dma")
    assert torch.equal(got, FK.conv2d_int8_halo_fused(
        xt, wt, None, ep, (8, 8), ((1, 1), (1, 1)), 2))
    assert FK.conv_plan(16, 320, 320, 3, 16, 6, 6, (2, 2), (1, 1), "im2col",
                        FK.SmemLimits(132, 233472, 232448),
                        FK.serving_bns(16)).bn == 16
    assert "conv_int8_fused_mma.cu" in cuda_build.SOURCES
    assert "mm_int8_fused_mma.cu" in cuda_build.SOURCES
    assert not {"tat_mm_int8_fused", "tat_mm_multi_int8_fused"} & set(
        cuda_build._SIGNATURES)
    assert FK.mm_plan(16 * 160 * 160, 32, (16, 16), False,
                      FK.SmemLimits(132, 233472, 232448)).kc == 32
    me = FK.multi_epilogue(0.01, [0.04, 0.05], 0.9, "SILU", 8)
    parts = [torch.ones((4, 16), dtype=torch.int8)] * 2
    got = FK.matmul_int8_fused_multi(parts, [torch.ones((8, 16),
                                                        dtype=torch.int8)] * 2,
                                     None, me)
    assert got.shape == (4, 8)
    assert yolo.resize_taps(720, 360)[0].shape == (360, 4)
    from thingino_accel_tpu_torch.probes import megakernel, mxu_ceiling, wedge
    fn, x, w = mxu_ceiling.build("int4w", 16, 64, 1, 2, "cpu")
    assert fn(x, w).shape == (32, 64)
    megakernel.H = megakernel.W = 4
    megakernel.L = megakernel.PAD = megakernel.GRID = 1
    fn, (x, w), _ = megakernel.build("i8-c3-round", 32, "cpu")
    assert fn(x, w).shape == x.shape == (1, 6, 6, 32)
    assert wedge.run_rung("kernel", "cpu").startswith("rung kernel: PASS")
    assert {"chain_mma.cu", "megakernel_probe.cu", "add_one.cu"} <= set(
        cuda_build.SOURCES)
    from thingino_accel_tpu_torch.probes import pipeline
    w, b, xs = pipeline.draws(1, 8, 32, 16, n_inputs=1)
    base, lagged = pipeline.build(1, 8, 32, 16, "SILU", "cpu")
    args = (torch.from_numpy(xs[0]), pipeline.to_ohwi(w),
            torch.from_numpy(b))
    assert torch.equal(lagged(*args), base(*args))
    assert lagged(*args, lag=False).shape == (1, 8, 8, 16)
    assert "conv_int8_lagged.cu" in cuda_build.SOURCES
    from thingino_accel_tpu_torch.ops import requant_kernels as RK
    assert "conv_int8_requant_mma.cu" in cuda_build.SOURCES
    assert "tat_conv_int8_requant" not in cuda_build._SIGNATURES
    plan = RK.conv_requant_plan(16, 320, 320, 3, 32, 6, 6, (2, 2), (1, 1),
                                "im2col", FK.SmemLimits(132, 233472, 232448))
    assert (plan.mode, plan.bn, plan.ck) == ("im2col", 32, 3)
    xs, ws = torch.ones((1, 9, 9, 3), dtype=torch.int8), torch.ones(
        (4, 3, 3, 3), dtype=torch.int8)
    got = RK.conv2d_int8(xs, ws, None, (5, 5), (2, 2), (1, 1),
                         ((1, 1), (1, 1)), 1.0, 1.0, 1.0)
    assert got.shape == (1, 5, 5, 4) and int(got[0, 2, 2, 0]) == 27
    from thingino_accel_tpu_torch.ir import passes
    fg = zoo.build_yolov5("n", zoo.ZooConfig(in_hw=(64, 64), w_scale=5e-4))
    assert passes.stem_space_to_depth(fg)
    for merge in (False, True):
        fast = thingino_accel_tpu_torch.Engine(fg, EngineOptions(
            precision="fast", quantize_outputs=False, conv_merge=merge,
            fpn_split="all"), device="cpu")
        assert fast.options.compute_dtype == torch.bfloat16
        dets = yolo.build_serving_pipeline(fast)(torch.zeros(
            (1, 36, 64, 3), dtype=torch.uint8))
        assert dets.boxes.shape == (1, 100, 4)
    heads = fast.forward(yolo.quantize_input_int8(yolo.space_to_depth(
        torch.zeros((1, 64, 64, 3), dtype=torch.uint8)), torch.bfloat16))
    assert all(h.dtype == torch.bfloat16 for h in heads.values())
    assert decode_kernel.decode_and_parse_fused(
        list(heads.values()))[0].shape == (1, 252, 4)
    nd = thingino_accel_tpu_torch.Engine(
        zoo.build_nanodet(zoo.ZooConfig(in_hw=(64, 64))),
        EngineOptions(precision="fast"), device="cpu")
    assert [h.dtype for h in nd.run(np.zeros((1, 64, 64, 3),
                                             np.int8)).values()] == [
        torch.int8] * 3
    assert sys.modules["jax"] is None
    assert sys.modules["thingino_accel_tpu"] is None
    print("ok")
""")


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def _imports_of(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_import_of_the_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO,
                                               "thingino_accel_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    bad = [(os.path.relpath(f, REPO), m) for f in files
           for m in _imports_of(f)
           if m.split(".")[0] in ("thingino_accel_tpu", "jax")]
    assert not bad, bad
