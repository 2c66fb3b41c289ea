"""Command-line tools of the port.

- ``summary`` — model inspection (the `.mars` file's structure);
- ``run``     — load a `.mars` model and run it on random, zero or `.npy`
  input in its default tier (the exact one), printing output stats and
  times;
- ``detect``  — YOLO detection on one image: the model's three detect
  heads (or its one predictions output) through the exact tier, the
  float decode, class-aware NMS, boxes in the image's pixels;
- ``compile`` — ONNX -> `.mars` (``formats.onnx`` then
  ``formats.mars_export``; ``--float32`` folds Q/DQ away, else a QDQ model
  becomes an int8 `.mars`);
- ``gen-test`` — a one-conv int8 test `.mars` from a seed;
- ``export-onnx`` — `.mars` -> float32 ONNX (``formats.onnx_export``);
- ``decompile`` — an OEM IVS `.so` embedding a JZDL network ->
  its layer table (``formats.jzdl.load_so``), ``--extract-weights
  OUT.npz`` its weight and metadata arrays; any other file, as an OEM
  `.mgk` -> its metadata as JSON (``formats.mgk.inspect_mgk``),
  ``--extract-weights DIR`` (`.npy` files) and ``--onnx OUT`` (float32
  ONNX of a recognized family, AEC or YOLO). The route is JAX's: a file
  the JZDL loader refuses goes to the `.mgk` one, whatever its name;
- ``quantize`` — PTQ: a float32 `.onnx` or `.mars` calibrated
  (``training.ptq``: ``--calib`` `.npy`/`.npz` batches, ``--images`` a
  folder, else seeded random batches; ``--method``, ``--percentile``) to
  an int8 `.mars` (``formats.mars_export``).

``run``, ``detect`` and ``quantize`` take ``--device`` (``cuda`` by
default; without a card they fail, and ``--device cpu`` runs the
kernels' plain versions). ``compile``, ``gen-test``, ``export-onnx`` and
``decompile`` convert files on the host and touch no device. ``bench`` is
not ported yet: it exits non-zero naming its ROADMAP item.

Usage: ``python -m thingino_accel_tpu_torch.cli <command> ...``
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

# the subcommands still to port, with the ROADMAP item each waits on
NOT_PORTED = {
    "bench": ("run the headline benchmark", "A.1 (the GPU bench)"),
}


def _load_image(path: str) -> np.ndarray:
    """An image file as HWC uint8 RGB: a `.npy` array, or any format
    Pillow decodes."""
    if path.endswith(".npy"):
        return np.asarray(np.load(path), np.uint8)
    try:
        from PIL import Image
    except ImportError as e:
        raise SystemExit(
            "image decoding needs Pillow; pass a .npy file instead") from e
    return np.asarray(Image.open(path).convert("RGB"), np.uint8)


def cmd_summary(args) -> int:
    from thingino_accel_tpu_torch.formats import mars as M
    print(M.read_mars(args.model).summary())
    return 0


def cmd_run(args) -> int:
    from thingino_accel_tpu_torch.runtime import Engine, EngineOptions
    eng = Engine.from_mars(args.model, EngineOptions(mode=args.mode),
                           device=args.device)
    print(eng.summary())
    rng = np.random.default_rng(args.seed)
    feed = {}
    for name in eng.input_names:
        t = eng.graph.tensors[name]
        shape = (args.batch,) + tuple(t.shape[1:])
        if args.input:
            arr = np.load(args.input).astype(t.dtype)
            if tuple(arr.shape[1:]) != tuple(t.shape[1:]):
                print(f"error: --input shape {arr.shape} does not match "
                      f"{name} {t.shape} (batch-free dims)",
                      file=sys.stderr)
                return 1
        elif np.issubdtype(t.dtype, np.integer):
            arr = rng.integers(-128, 128, shape).astype(t.dtype)
        else:
            arr = rng.normal(size=shape).astype(t.dtype)
        feed[name] = arr
    t0 = time.perf_counter()
    out = eng.run_np(**feed)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(args.iters):
        out = eng.run_np(**feed)
    run_s = (time.perf_counter() - t0) / max(args.iters, 1)
    for k, v in out.items():
        print(f"output {k}: shape={v.shape} dtype={v.dtype} "
              f"min={v.min()} max={v.max()} mean={float(np.mean(v)):.4f}")
    fed_batch = next(iter(feed.values())).shape[0]
    print(f"first call: {first_s*1e3:.1f} ms; steady-state: "
          f"{run_s*1e3:.2f} ms ({fed_batch/run_s:.1f} inf/s)")
    return 0


def cmd_detect(args) -> int:
    import torch
    from thingino_accel_tpu_torch.models import yolo
    from thingino_accel_tpu_torch.runtime import Engine
    from thingino_accel_tpu_torch.runtime.engine import load_graph

    g = load_graph(args.model)
    det_outs = yolo.find_detect_outputs(g)
    if det_outs:
        g = g.with_outputs(det_outs)
    eng = Engine(g, device=args.device)
    in_t = eng.graph.tensors[eng.input_names[0]]
    target = (in_t.shape[1], in_t.shape[2])
    is_int8 = np.issubdtype(in_t.dtype, np.signedinteger)
    scales = [eng.graph.tensors[o].quant.scale for o in eng.output_names]

    img = _load_image(args.image)
    frames = torch.from_numpy(np.array(img[None])).to(eng.device)
    lb = yolo.letterbox_uint8(frames, target)
    x = (yolo.quantize_input_int8(lb) if is_int8
         else yolo.normalize_input_f32(lb))
    feats = eng.forward(x)
    if det_outs:
        f32 = [feats[k].to(torch.float32) * float(np.float32(s))
               for k, s in zip(eng.output_names, scales)]
        b, s, c = yolo.parse_predictions(yolo.decode_heads(f32), 1.0,
                                         already_sigmoid=True)
    else:
        (o,) = feats.values()
        b, s, c = yolo.parse_predictions(o, scales[0])
    dets = yolo.nms_batched(b, s, c, conf_thresh=args.conf,
                            iou_thresh=args.iou, max_dets=args.max_dets)
    boxes = yolo.scale_boxes_to_original(dets.boxes, img.shape[:2],
                                         target).cpu().numpy()
    sc, cl, va = (t.cpu().numpy()
                  for t in (dets.scores, dets.classes, dets.valid))
    print(f"{int(va[0].sum())} detections:")
    for i in range(boxes.shape[1]):
        if not va[0, i]:
            continue
        name = (yolo.COCO_CLASSES[cl[0, i]]
                if cl[0, i] < len(yolo.COCO_CLASSES) else "?")
        x0, y0, x1, y1 = boxes[0, i]
        print(f"  {name:<14} {sc[0, i]*100:5.1f}%  "
              f"({x0:.0f},{y0:.0f})-({x1:.0f},{y1:.0f})")
    return 0


def cmd_compile(args) -> int:
    from thingino_accel_tpu_torch.formats import mars_export
    from thingino_accel_tpu_torch.formats import onnx as O
    # --nhwc is parsed for the JAX CLI's arguments; the IR is always NHWC.
    graph = O.import_onnx(args.input, float32=args.float32,
                          verbose=args.verbose)
    mars_export.export_mars(graph, args.output)
    print(f"wrote {args.output}")
    return 0


def cmd_gen_test(args) -> int:
    """A one-conv int8 test `.mars` (the tools/mars_gen_test.py role)."""
    from thingino_accel_tpu_torch.formats import mars as M
    rng = np.random.default_rng(args.seed)
    h, w, cin, cout = args.height, args.width, args.channels, args.out_channels
    weights = rng.integers(-128, 128, (cout, 3, 3, cin), dtype=np.int8)
    bias = np.zeros((cout,), np.int32)
    tensors = [
        M.MarsTensor(0, "input", M.DType.INT8, M.Format.NHWC,
                     (1, h, w, cin), scale=1.0),
        M.MarsTensor(1, "conv1_weight", M.DType.INT8, M.Format.OHWI,
                     (cout, 3, 3, cin), scale=0.01),
        M.MarsTensor(2, "conv1_bias", M.DType.INT32, M.Format.D1, (cout,)),
        M.MarsTensor(3, "output", M.DType.INT8, M.Format.NHWC,
                     (1, h, w, cout), scale=1.0),
    ]
    layers = [M.MarsLayer(0, M.LayerType.CONV2D, (0,), (3,),
                          M.ConvParams(kernel_h=3, kernel_w=3,
                                       padding=M.Padding.SAME,
                                       activation=M.Activation.RELU,
                                       weight_tensor_id=1,
                                       bias_tensor_id=2))]
    model = M.build_mars(tensors, layers, [0], [3],
                         {1: weights, 2: bias})
    M.write_mars(model, args.output)
    print(f"wrote {args.output}: 1 conv layer, {h}x{w}x{cin} -> {cout}ch")
    return 0


def cmd_export_onnx(args) -> int:
    """.mars -> float32 ONNX (dequantized weights), the reverse of
    ``compile``."""
    from thingino_accel_tpu_torch.formats.onnx_export import ir_to_onnx
    from thingino_accel_tpu_torch.runtime.engine import load_graph
    blob = ir_to_onnx(load_graph(args.input))
    with open(args.output, "wb") as f:
        f.write(blob)
    print(f"wrote {args.output} ({len(blob)} bytes)")
    return 0


def cmd_decompile(args) -> int:
    """OEM model -> its structure and weights: a JZDL `.so` -> layer table
    and `.npz`; a `.mgk` -> metadata JSON, weight arrays and ONNX (the
    ``mgk-decompiler`` CLI's role)."""
    from thingino_accel_tpu_torch.formats import jzdl, mgk

    # OEM IVS wrappers (e.g. libpersonDet_inf.so) embed a jzdl network
    # instead of a magik container — route those to the jzdl decompiler
    try:
        model = jzdl.load_so(args.input)
    except (ValueError, OSError):
        model = None
    if model is not None:
        c, h, w = model.input_chw
        print(f"jzdl embedded network: input {c}x{h}x{w}, "
              f"{len(model.layers)} layers, {model.n_blobs} blobs")
        for i, l in enumerate(model.layers):
            tag = jzdl.LAYER_NAMES.get(l.ltype, f"type{l.ltype}")
            extra = ""
            if l.is_conv:
                extra = (f" cin={l.in_channels} cout={l.out_channels}"
                         f" k={l.kernel} s={l.stride}"
                         f" w={l.weight_size}B")
            print(f"  L{i:2d} {tag:9s} {l.bottoms}->{l.tops}{extra}")
        if args.extract_weights:
            arrs = {}
            for i, l in enumerate(model.conv_layers()):
                arrs[f"L{i}_weights"] = l.weights
                for f in ("bias", "scales", "q31_mult", "q_shift",
                          "quant_a", "quant_packed"):
                    v = getattr(l, f)
                    if v is not None:
                        arrs[f"L{i}_{f}"] = v
            np.savez(args.extract_weights, **arrs)
            print(f"weights -> {args.extract_weights}")
        return 0

    info = mgk.inspect_mgk(args.input)
    print(json.dumps(info, indent=2, default=str))
    if args.extract_weights:
        mgk.extract_weights(args.input, args.extract_weights)
        print(f"weights -> {args.extract_weights}")
    if args.onnx:
        with open(args.onnx, "wb") as f:
            f.write(mgk.mgk_to_onnx(args.input))
        print(f"onnx -> {args.onnx}")
    return 0


def cmd_quantize(args) -> int:
    """PTQ: f32 model (.onnx or .mars) -> calibrated int8 .mars.

    The in-framework role of the reference's offline
    ``scripts/quantize_onnx.py`` -> QDQ ONNX -> mars-compiler chain:
    one command, per-channel weight scales, percentile or MSE
    activation calibration (``training/ptq.py``), the calibration forward
    on ``--device``.
    """
    from thingino_accel_tpu_torch.formats import mars_export
    from thingino_accel_tpu_torch.runtime.engine import load_graph
    from thingino_accel_tpu_torch.training import ptq

    if args.input.endswith(".onnx"):
        from thingino_accel_tpu_torch.formats import onnx as O
        graph = O.import_onnx(args.input, float32=True)
    else:
        graph = load_graph(args.input)
    in_name = graph.inputs[0]
    shape = graph.tensors[in_name].shape

    def batches():
        if args.images:
            import glob as _glob
            from PIL import Image
            files = sorted(
                f for f in _glob.glob(os.path.join(args.images, "*"))
                if f.lower().endswith((".jpg", ".jpeg", ".png", ".bmp"))
            )[:args.batches]
            if not files:
                raise SystemExit(f"no images in {args.images}")
            for f in files:
                img = Image.open(f).convert("RGB").resize(
                    (shape[2], shape[1]))
                x = np.asarray(img, np.float32)[None] / 255.0
                yield {in_name: x}
        elif args.calib:
            arr = np.load(args.calib)
            if hasattr(arr, "files"):           # npz: first array
                arr = arr[arr.files[0]]
            arr = np.asarray(arr, np.float32)
            if arr.ndim == len(shape) - 1:
                arr = arr[None]
            for i in range(min(len(arr), args.batches)):
                yield {in_name: arr[i:i + 1]}
        else:
            rng = np.random.default_rng(args.seed)
            for _ in range(args.batches):
                yield {in_name: rng.uniform(
                    0, 1, (1,) + tuple(shape[1:])).astype(np.float32)}

    q = ptq.quantize_model(graph, batches(), percentile=args.percentile,
                           method=args.method, device=args.device)
    mars_export.export_mars(q, args.output)
    in_scale = q.tensors[q.inputs[0]].quant.scale
    print(f"wrote {args.output} (int8, input scale {in_scale:.6f}, "
          f"method {args.method})")
    return 0


def _not_ported(cmd: str):
    def fn(args) -> int:
        print(f"error: '{cmd}' is not ported to the PyTorch package yet: "
              f"ROADMAP.md {NOT_PORTED[cmd][1]}", file=sys.stderr)
        return 2
    return fn


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="thingino-accel-tpu-torch",
                                description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("summary", help="print model structure")
    s.add_argument("model")
    s.set_defaults(fn=cmd_summary)

    s = sub.add_parser("run", help="load and run a model")
    s.add_argument("model")
    s.add_argument("--input", help=".npy input file")
    s.add_argument("--batch", type=int, default=1)
    s.add_argument("--iters", type=int, default=3)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--mode", choices=["full", "compat"], default="full")
    s.add_argument("--device", default="cuda")
    s.set_defaults(fn=cmd_run)

    s = sub.add_parser("detect", help="YOLO detection on an image")
    s.add_argument("model")
    s.add_argument("image")
    s.add_argument("--conf", type=float, default=0.25)
    s.add_argument("--iou", type=float, default=0.45)
    s.add_argument("--max-dets", type=int, default=100)
    s.add_argument("--device", default="cuda")
    s.set_defaults(fn=cmd_detect)

    s = sub.add_parser("compile", help="ONNX -> .mars")
    s.add_argument("-i", "--input", required=True)
    s.add_argument("-o", "--output", required=True)
    s.add_argument("--float32", action="store_true")
    s.add_argument("--nhwc", action="store_true")
    s.add_argument("-v", "--verbose", action="store_true")
    s.set_defaults(fn=cmd_compile)

    s = sub.add_parser("gen-test", help="generate a test .mars model")
    s.add_argument("-o", "--output", default="test_model.mars")
    s.add_argument("--height", type=int, default=64)
    s.add_argument("--width", type=int, default=64)
    s.add_argument("--channels", type=int, default=3)
    s.add_argument("--out-channels", type=int, default=16)
    s.add_argument("--seed", type=int, default=0)
    s.set_defaults(fn=cmd_gen_test)

    s = sub.add_parser("export-onnx", help=".mars -> float32 ONNX")
    s.add_argument("-i", "--input", required=True)
    s.add_argument("-o", "--output", required=True)
    s.set_defaults(fn=cmd_export_onnx)

    s = sub.add_parser("decompile", help=".mgk -> metadata/weights/onnx")
    s.add_argument("-i", "--input", required=True)
    s.add_argument("--extract-weights", metavar="DIR")
    s.add_argument("--onnx", metavar="OUT.onnx",
                   help="export the decompiled model as ONNX")
    s.set_defaults(fn=cmd_decompile)

    s = sub.add_parser("quantize", help="PTQ: f32 .onnx/.mars -> int8 .mars")
    s.add_argument("-i", "--input", required=True)
    s.add_argument("-o", "--output", required=True)
    s.add_argument("--images", metavar="DIR",
                   help="calibration image dir (resized, x/255)")
    s.add_argument("--calib", metavar="NPY",
                   help="calibration batches (.npy/.npz, NHWC float)")
    s.add_argument("--batches", type=int, default=8)
    s.add_argument("--method", choices=["percentile", "mse"],
                   default="percentile")
    s.add_argument("--percentile", type=float, default=99.99)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--device", default="cuda")
    s.set_defaults(fn=cmd_quantize)

    for cmd, (what, item) in NOT_PORTED.items():
        # any arguments are taken as they come, dashes too: none is read
        s = sub.add_parser(cmd, help=f"{what} (not ported: ROADMAP {item})",
                           prefix_chars="+", add_help=False)
        s.add_argument("rest", nargs=argparse.REMAINDER)
        s.set_defaults(fn=_not_ported(cmd))

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
