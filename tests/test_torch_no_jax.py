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
  convs), both of its accumulation modes, and the camera-stream path and
  CLI (``nv12_to_rgb``, ``MultiStreamBatcher``, the watchdog'd
  ``StreamServer``, ``serve_file_model``, the float and top-k decodes,
  the DFL decode, ``cli summary/run``), and the shared lowering of every
  tier (``models.ops_graphs``' int8, float and recurrent graphs, the whole
  real yolov5n file with its degenerate tail, ``tiny_160_f32.mars``,
  ``nchw_io`` and ``donate_inputs``), and the model compiler's formats:
  the QDQ yolov5n of ``models.onnx_fixtures`` imported in int8 mode,
  written as `.mars`, read back and served; its heads graph exported as
  float32 ONNX (``ir_to_onnx``) and imported again; the CLI's
  ``compile``, ``gen-test`` and ``export-onnx``; and the OEM-model path:
  `.mgk` files written by the port's own ``models.mgk_fixtures`` (YOLO and
  AEC) through ``api.nna_model_load`` on the CPU (``nna_init(device=
  "cpu")``), the AEC model run, ``training.ptq`` on the tiny zoo graph,
  ``ops.image``'s resize and warp, and the CLI's ``decompile`` and
  ``quantize``; and the last two model families: a WAV written and read,
  ``process_wav_stream`` through ``AECStream`` and ``process_wav``
  through ``build_aec_graph`` on the AEC fixture, ``process_stream``,
  ``make_stream_scanner`` at 2 streams, and the JZDL fixture `.so` through
  ``load_so``, ``persondet.calibrate`` / ``forward`` and the CLI's
  ``decompile``; and the training path and host utilities: a QAT step on
  the tiny float convnet with observers, a checkpoint of it, the weights
  written back, ``export_int8``, the ``TAT_*`` registry, ``compiled_stats``
  and ``native``; and ``parallel``: a dp x tp sharded forward and a
  two-stage ``PipelinedEngine`` over CPU meshes, and the deep s2d fold;
  and ``runtime.jit`` (eager on the CPU), the NMS kernel's wrapper on a
  seeded suppression chain and ``ops``' quantize helpers.
- No module of the port and no line of ``chip_smoke.py`` holds an
  ``import`` of ``thingino_accel_tpu`` (parsed with ``ast``, so an import
  inside a function counts too); the walk covers the format modules,
  ``models/onnx_fixtures.py`` and ``models/mgk_fixtures.py``,
  ``training/ptq.py``, ``api.py`` and ``ops/image.py``, and the audio,
  AEC, JZDL and person-detector modules and the JZDL fixture, QAT,
  checkpoints, the utilities and ``native.py``, and ``parallel/``, and
  ``runtime/jit.py``, ``ops/nms_kernel.py`` and ``models/nms_fixtures.py``.
- The port's C ABI engine shim (``csrc/tat_engine.cpp`` of the package)
  imports ``thingino_accel_tpu_torch.runtime`` and no module of the JAX
  package.
"""

import ast
import os
import re
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
    fast16 = thingino_accel_tpu_torch.Engine(fg, EngineOptions(
        precision="fast", quantize_outputs=False,
        accum_dtype=torch.bfloat16), device="cpu")
    assert fast16._fn.accum_dtype == torch.bfloat16
    from thingino_accel_tpu_torch import cli
    from thingino_accel_tpu_torch.runtime import (
        InferenceTimeout, MultiStreamBatcher, StreamServer)
    from thingino_accel_tpu_torch.runtime.serving import serve_file_model
    nv = np.random.default_rng(1).integers(0, 256, (3, 96, 128),
                                           dtype=np.uint8)
    rgb = yolo.nv12_to_rgb(torch.from_numpy(nv), 64, 128)
    assert rgb.shape == (3, 64, 128, 3) and rgb.dtype == torch.uint8
    assert yolo.normalize_input_f32(rgb).dtype == torch.float32
    mb = MultiStreamBatcher(2, 2)
    srv = StreamServer(lambda b: yolo.nv12_to_rgb(b, 64, 128), depth=2,
                       device="cpu", timeout_s=30.0)
    outs = list(srv.run(mb.batches([iter(nv[:2]), iter(nv[2:])])))
    assert len(outs) == 2 and list(mb.sources) == [[0, 1], [0, -1]]
    assert srv.healthy and issubclass(InferenceTimeout, RuntimeError)
    st = serve_file_model("models/fixtures/test_conv.mars",
                          iter([np.zeros((2, 64, 64, 3), np.int8)]),
                          device="cpu")
    assert st.frames == 2 and st.errors == 0
    hs = [torch.from_numpy(np.random.default_rng(2).integers(
        -128, 128, (1, s, s, 255), dtype=np.int8)) for s in (8, 4, 2)]
    dets = yolo.detect_postprocess_topk(hs, scales=[0.1] * 3)
    assert dets.boxes.shape == (1, 100, 4)
    pred = yolo.decode_heads([h.float() * 0.1 for h in hs])
    assert yolo.parse_predictions(pred, 1.0, True)[1].shape == (1, 252)
    assert yolo.make_anchor_tables([(8, 8)])["gx"].shape == (192,)
    b, s, c = yolo.decode_anchor_free(
        [torch.zeros((1, 4, 4, 64))], [torch.zeros((1, 4, 4, 80))])
    assert b.shape == (1, 16, 4)
    assert cli.main(["summary", "models/fixtures/test_conv.mars"]) == 0
    assert cli.main(["run", "models/fixtures/test_conv.mars", "--iters",
                     "1", "--device", "cpu"]) == 0
    assert cli.main(["bench"]) != 0
    from thingino_accel_tpu_torch.models import ops_graphs
    from thingino_accel_tpu_torch.runtime.engine import load_graph
    graphs = [ops_graphs.int8_ops_graph(1, 8, 8, 8),
              ops_graphs.float_ops_graph(1, 8, 8, 8),
              ops_graphs.recurrent_graph(1, 4, 8, 4, 4)]
    for gr in graphs:
        t = gr.tensors[gr.inputs[0]]
        xin = np.ones(t.shape, t.dtype)
        for prec, planned in (("serving", True), ("serving", False),
                              ("exact", True), ("fast", True)):
            # the fast tier's dequantize cannot take a per-channel FC
            # weight (ROADMAP.md C), as JAX's
            sub = gr.with_outputs([o for o in gr.outputs if o != "fc2"]
                                  if prec == "fast" else gr.outputs)
            got = thingino_accel_tpu_torch.Engine(
                sub, EngineOptions(precision=prec, quantize_outputs=False,
                                   donate_inputs=True),
                device="cpu", planned=planned).run_np(xin)
            assert set(got) == set(sub.outputs)
    nchw = thingino_accel_tpu_torch.Engine(
        graphs[0], EngineOptions(nchw_io=True), device="cpu")
    assert nchw.run_np(np.ones((1, 8, 8, 8), np.int8))["p2"].shape == (
        1, 8, 8, 8) and nchw.input_info().shape == (1, 8, 8, 8)
    whole = thingino_accel_tpu_torch.Engine(
        load_graph("models/yolov5n_cal_int8.mars"), serving, device="cpu")
    assert sum(whole._fn.launch_census().values()) == 50
    tiny = thingino_accel_tpu_torch.Engine.from_mars(
        "models/fixtures/tiny_160_f32.mars", device="cpu")
    assert tiny.run_np(np.zeros((1, 160, 160, 3), np.float32))
    import tempfile
    from thingino_accel_tpu_torch.formats import mars_export, onnx
    from thingino_accel_tpu_torch.formats.onnx_export import ir_to_onnx
    from thingino_accel_tpu_torch.models import onnx_fixtures
    qdq = onnx_fixtures.qdq_yolov5("n", zoo.ZooConfig(in_hw=(64, 64)))
    imported = onnx.import_onnx(qdq)
    assert [n.op for n in imported.nodes].count("SIGMOID") == 57
    compiled = mars_export.export_mars(imported)
    eng = thingino_accel_tpu_torch.Engine(load_graph(compiled), serving,
                                          device="cpu")
    heads = eng.run_np(np.zeros((1, 64, 64, 3), np.int8))
    assert [h.shape for h in heads.values()] == [
        (1, 8, 8, 255), (1, 4, 4, 255), (1, 2, 2, 255)]
    f32 = onnx.import_onnx(ir_to_onnx(imported), float32=True)
    assert [f32.tensors[o].shape for o in f32.outputs] == [
        (1, 8, 8, 255), (1, 4, 4, 255), (1, 2, 2, 255)]
    with tempfile.TemporaryDirectory() as d:
        src, out = d + "/m.onnx", d + "/m.mars"
        open(src, "wb").write(qdq)
        assert cli.main(["compile", "-i", src, "-o", out]) == 0
        assert open(out, "rb").read() == compiled
        assert cli.main(["gen-test", "-o", out]) == 0
        assert cli.main(["export-onnx", "-i", out, "-o", src]) == 0
        assert onnx.import_onnx(src, float32=True).outputs == ["output"]
    from thingino_accel_tpu_torch import api
    from thingino_accel_tpu_torch.formats import mgk, mgk_yolo
    from thingino_accel_tpu_torch.models import mgk_fixtures
    from thingino_accel_tpu_torch.ops import image
    from thingino_accel_tpu_torch.training import ptq
    with tempfile.TemporaryDirectory() as d:
        data, _ = mgk_fixtures.build_yolo_mgk("n", in_hw=(64, 64),
                                              w_scale=4e-4)
        open(d + "/y.mgk", "wb").write(data)
        open(d + "/a.mgk", "wb").write(mgk_fixtures.build_aec_mgk(0))
        elf, meta = mgk.load_mgk(data)
        assert mgk_yolo.detect_yolo_family(elf, meta) == "n"
        assert api.nna_init(device="cpu") == api.NNA_SUCCESS
        m = api.nna_model_load(d + "/y.mgk")
        assert m is not None and api.nna_model_get_info(m).num_outputs == 3
        m = api.nna_model_load(d + "/a.mgk")
        t = api.nna_model_get_input(m)
        t.set_data(np.ones(t.shape, np.float32))
        assert api.nna_model_run(m) == 0
        assert api.nna_model_get_output(m).data.shape == (1, 256, 2)
        assert cli.main(["decompile", "-i", d + "/a.mgk", "--onnx",
                         d + "/a.onnx"]) == 0
        assert cli.main(["quantize", "-i", "models/fixtures/tiny_160_f32.mars",
                         "-o", d + "/q.mars", "--batches", "1",
                         "--device", "cpu"]) == 0
        api.nna_deinit()
    tg = zoo.build_tiny(zoo.ZooConfig(dtype="float32", in_hw=(16, 16)),
                        in_hw=(16, 16))
    gq = ptq.quantize_model(tg, iter([{"input": np.ones((1, 16, 16, 3),
                                                       np.float32)}]),
                            device="cpu")
    assert gq.tensors[gq.outputs[0]].dtype == np.int8
    u8 = torch.zeros((1, 8, 8, 3), dtype=torch.uint8)
    assert image.resize_bilinear(u8, (5, 11)).shape == (1, 5, 11, 3)
    assert image.warp_affine(u8, np.eye(2, 3)).dtype == torch.uint8
    from thingino_accel_tpu_torch.formats import jzdl
    from thingino_accel_tpu_torch.models import (
        aec, audio, jzdl_fixtures, persondet)
    with tempfile.TemporaryDirectory() as d:
        open(d + "/a.mgk", "wb").write(mgk_fixtures.build_aec_mgk(0))
        g = mgk.import_mgk(d + "/a.mgk", streaming=True)
        wav = (np.random.default_rng(3).normal(size=3000) * 0.2).astype(
            np.float32)
        audio.write_wav(d + "/x.wav", wav)
        wav = audio.read_wav(d + "/x.wav")
        stream = aec.AECStream(g, "cpu")
        assert audio.process_wav_stream(stream, wav).shape == (3000,)
        model = aec.build_aec_graph(mgk.parse_elf(open(
            d + "/a.mgk", "rb").read()).appended, device="cpu")
        assert audio.process_wav(model, wav).shape == (3000,)
        spec = torch.ones((1, 256, 16, 1))
        masks = aec.process_stream(model.params, spec, 8)
        assert masks.shape == (1, 256, 16, 2)
        run = aec.make_stream_scanner(g, "cpu")
        assert run(np.zeros((2, 1, 64, 32), np.float32),
                   np.ones((2, 2, 1, 256, 8), np.float32)).shape == (
            2, 2, 1, 256, 2)
        open(d + "/p.so", "wb").write(jzdl_fixtures.build_persondet_so(0))
        pd = jzdl.load_so(d + "/p.so")
        cal = persondet.calibrate(pd, jzdl_fixtures.seeded_image(1), "cpu")
        heads = persondet.forward(pd, jzdl_fixtures.seeded_image(2), cal,
                                  device="cpu")
        assert [tuple(h.shape) for h in heads.values()] == [
            (17, 17, 18), (34, 34, 18)]
        assert cli.main(["decompile", "-i", d + "/p.so",
                         "--extract-weights", d + "/w.npz"]) == 0
    import torch
    from thingino_accel_tpu_torch import native, utils
    from thingino_accel_tpu_torch.runtime import checkpoint
    from thingino_accel_tpu_torch.runtime.executor import (
        graph_with_params, params_to_jax)
    from thingino_accel_tpu_torch.training import qat
    fg = zoo.build_tiny(zoo.ZooConfig(dtype="float32", in_hw=(16, 16)))
    x = {"input": torch.ones((1, 16, 16, 3))}
    stats = ptq.calibrate(fg, [x], device="cpu")
    og = qat.insert_activation_fake_quant(fg, stats)
    eng = thingino_accel_tpu_torch.Engine(og, device="cpu")
    params = {k: v.clone().requires_grad_(True) for k, v in eng.params.items()}
    opt = torch.optim.Adam(params.values(), lr=1e-3)
    step = qat.make_train_step(eng._fn, opt, channel_axis=-1)
    tgt = {k: v.detach() for k, v in eng._fn(eng.params, x).items()}
    assert torch.isfinite(step(params, x, tgt))
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(d + "/c", {"params": params, "opt": opt.state_dict()})
        state, meta = checkpoint.load(d + "/c", like={
            "params": params, "opt": opt.state_dict()})
    assert meta["backend"] == "npz"
    wg = graph_with_params(fg, params_to_jax(params, eng._fn.conv_weights))
    assert qat.export_int8(params)[1]
    assert utils.config.get("TAT_FPN_SPLIT") == "wide"
    assert utils.compiled_stats(torch.mm, torch.ones(4, 4),
                                torch.ones(4, 4))["flops"] == 128
    assert native.quantize_i8(np.zeros((2, 2), np.uint8)).min() == -128
    from thingino_accel_tpu_torch import parallel
    tg = zoo.build_tiny(zoo.ZooConfig(dtype="float32", in_hw=(16, 16)),
                        in_hw=(16, 16))
    teng = thingino_accel_tpu_torch.Engine(tg, device="cpu")
    fn, sp = parallel.make_sharded_forward(
        teng, parallel.make_mesh(dp=2, tp=2, devices=["cpu"] * 4))
    xt = np.ones((2, 16, 16, 3), np.float32)
    tin, tout = tg.inputs[0], tg.outputs[0]
    got = fn(sp, {tin: xt})[tout]
    assert torch.allclose(got, teng.run(xt)[tout], atol=1e-5)
    assert fn.gathers["channels"] > 0
    pipe = parallel.PipelinedEngine(tg, devices=["cpu"] * 2)
    outs = list(pipe.run({tin: xt[:1]} for _ in range(3)))
    assert len(outs) == 3 and len(pipe.stages) == 2
    fg2 = zoo.build_yolov5("n", zoo.ZooConfig(in_hw=(64, 64)))
    assert passes.stem_space_to_depth(fg2)
    assert passes.fold_stage2_downsample(fg2)
    from thingino_accel_tpu_torch.models import nms_fixtures
    from thingino_accel_tpu_torch.ops import nms_kernel
    from thingino_accel_tpu_torch.ops import quantize, dequantize
    from thingino_accel_tpu_torch.runtime.jit import jit
    assert thingino_accel_tpu_torch.EngineOptions().jit
    b, sc, cl = nms_fixtures.seeded_sets(128, batch=2)["chain"]
    up = yolo.suppression_pool(torch.from_numpy(b), torch.from_numpy(sc),
                               torch.from_numpy(cl), pre_nms=128)[3]
    assert nms_kernel.nms_fixpoint(up)[:, ::2].all()
    assert jit(lambda t: {"y": dequantize(quantize(t, 0.5), 0.5)})(
        torch.ones(3))["y"].tolist() == [1.0] * 3
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
    pkg = os.path.join(REPO, "thingino_accel_tpu_torch")
    assert {os.path.join(pkg, "formats", f + ".py") for f in (
        "onnx_proto", "onnx_writer", "onnx", "onnx_export", "mars_export",
        "mgk", "mgk_yolo", "jzdl")
    } | {os.path.join(pkg, *f) for f in (
        ("models", "onnx_fixtures.py"), ("models", "mgk_fixtures.py"),
        ("training", "ptq.py"), ("api.py",), ("ops", "image.py"),
        ("models", "audio.py"), ("models", "aec.py"),
        ("models", "persondet.py"), ("models", "jzdl_fixtures.py"),
        ("training", "qat.py"), ("runtime", "checkpoint.py"),
        ("utils", "config.py"), ("utils", "logging.py"),
        ("utils", "timing.py"), ("native.py",),
        ("parallel", "__init__.py"), ("parallel", "mesh.py"),
        ("parallel", "shard.py"), ("parallel", "pipeline.py"),
        ("runtime", "jit.py"), ("ops", "nms_kernel.py"),
        ("models", "nms_fixtures.py"))
    } <= set(files)
    bad = [(os.path.relpath(f, REPO), m) for f in files
           for m in _imports_of(f)
           if m.split(".")[0] in ("thingino_accel_tpu", "jax")]
    assert not bad, bad


def test_engine_shim_drives_the_port():
    src = open(os.path.join(REPO, "thingino_accel_tpu_torch", "csrc",
                            "tat_engine.cpp")).read()
    imports = re.findall(r'PyImport_ImportModule\("([^"]+)"\)', src)
    assert "thingino_accel_tpu_torch.runtime" in imports
    assert not [m for m in imports
                if m.split(".")[0] in ("thingino_accel_tpu", "jax")]
