"""YOLO pre/post-processing on torch tensors (port of
``thingino_accel_tpu.models.yolo`` for the serving path).

uint8 frames -> letterbox + int8 quantize (the values in bf16 for the
fast tier, in 2x2 blocks for a space-to-depth stem) -> engine -> anchor
decode -> class-aware NMS, all on the frames' device. Shapes stay fixed (K
detections per frame with a ``valid`` mask), as in the JAX package.

Tie order follows ``lax.top_k``: among equal scores the lower index comes
first. ``torch.topk`` promises no order among ties, so every top-k here
is a stable descending sort.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from thingino_accel_tpu_torch.ops.reference import (  # noqa: F401
    resize_axis, resize_taps, resize_window,
)

# COCO class names (the reference's ``mars_yolo_test.c`` table).
COCO_CLASSES = (
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep",
    "cow", "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella",
    "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "bottle", "wine glass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "couch", "potted plant", "bed", "dining table", "toilet", "tv",
    "laptop", "mouse", "remote", "keyboard", "cell phone", "microwave",
    "oven", "toaster", "sink", "refrigerator", "book", "clock", "vase",
    "scissors", "teddy bear", "hair drier", "toothbrush",
)

# YOLOv5 anchors / strides (the reference's yolo_detect.cpp tables).
YOLOV5_ANCHORS = np.array([
    [[10, 13], [16, 30], [33, 23]],
    [[30, 61], [62, 45], [59, 119]],
    [[116, 90], [156, 198], [373, 326]],
], dtype=np.float32)
YOLOV5_STRIDES = (8, 16, 32)


# ---------------------------------------------------------------------------
# Preprocessing
# ---------------------------------------------------------------------------


def letterbox_uint8(
    frames: torch.Tensor,          # [B, H, W, 3] uint8
    target: Tuple[int, int] = (640, 640),
    pad_value: int = 114,
) -> torch.Tensor:
    """Aspect-preserving resize + center pad, batched on the frames'
    device: ``scale = min(tw/w, th/h)``, bilinear resize (antialiased when
    shrinking) as ``jax.image.resize`` computes it on the CPU, H first
    and then W (its contraction order at the camera sizes), round half to
    even, clamp, gray fill. Returns uint8 [B, th, tw, 3].

    Held against the JAX letterbox: equal bytes at 720x1280 and
    1080x1920 -> 640 and at the test sizes (``tests/test_torch_yolo.py``;
    the reference's dot splits long sums into blocks, so a few f32 values
    may differ in the last bit, none by a byte there). The card computes
    the same bytes as the CPU."""
    b, h, w, c = frames.shape
    th, tw = target
    scale = min(tw / w, th / h)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    if (nh, nw) == (h, w):
        resized = frames
    else:
        r = frames
        if nh != h:
            r = resize_axis(r, 1, nh)
        if nw != w:
            r = resize_axis(r, 2, nw)
        resized = torch.clamp(torch.round(r), 0, 255).to(torch.uint8)
    if (nh, nw) == (th, tw):
        return resized.contiguous()
    py, px = (th - nh) // 2, (tw - nw) // 2
    out = torch.full((b, th, tw, c), pad_value, dtype=torch.uint8,
                     device=frames.device)
    out[:, py:py + nh, px:px + nw, :] = resized
    return out


def quantize_input_int8(frames_u8: torch.Tensor,
                        dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """uint8 [0,255] -> int8 centered: the reference feeds ``pixel - 128``.
    ``dtype=torch.bfloat16`` holds the same integers in bf16 (exact: |v|
    <= 128), the fast tier's input, whose DEQUANT takes any real type."""
    return (frames_u8.to(torch.int32) - 128).to(dtype)


def nv12_to_rgb(nv12: torch.Tensor, height: int, width: int
                ) -> torch.Tensor:
    """NV12 (the camera's planar YUV 4:2:0, ``include/nna_types.h``) ->
    RGB uint8 on the frames' device, batched: [B, H*3/2, W] uint8 (the Y
    plane, then the interleaved half-resolution UV plane, V4L2's layout)
    -> [B, H, W, 3]. BT.601 full range, chroma upsampled by nearest.

    The JAX function's op order, each op a torch op of its own: f32 planes,
    ``y + 1.402 v``, ``(y - 0.344136 u) - 0.714136 v``, ``y + 1.772 u``,
    each product rounded before its add (no fused multiply-add, which
    changes bytes), round half to even, clamp. The bytes equal JAX's, on
    the CPU and on the card."""
    b = nv12.shape[0]
    y = nv12[:, :height, :].to(torch.float32)
    uv = nv12[:, height:, :].reshape(b, height // 2, width // 2, 2)
    u = uv[..., 0].to(torch.float32) - 128.0
    v = uv[..., 1].to(torch.float32) - 128.0
    u = u.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    v = v.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    r = y + 1.402 * v
    g = y - 0.344136 * u - 0.714136 * v
    bch = y + 1.772 * u
    rgb = torch.stack([r, g, bch], dim=-1)
    return torch.clamp(torch.round(rgb), 0, 255).to(torch.uint8)


def normalize_input_f32(frames_u8: torch.Tensor) -> torch.Tensor:
    """uint8 -> f32 in [0, 1] (the standard YOLOv5 f32 input): a multiply
    by the f32 value of 1/255, as JAX's."""
    return frames_u8.to(torch.float32) * float(np.float32(1.0 / 255.0))


def space_to_depth_frames(frames: np.ndarray) -> np.ndarray:
    """Host 2x2 space-to-depth: ``[B, H, W, C]`` -> ``[B, H/2, W/2, 4C]``,
    each 2x2 block's pixels row-major into the channels (channel
    ``(p*2+q)*C + c``): the input order of a graph rewritten by
    ``ir.passes.stem_space_to_depth``, which a fixed-size feed can be
    written in as it is copied."""
    b, h, w, c = frames.shape
    assert h % 2 == 0 and w % 2 == 0, (h, w)
    out = frames.reshape(b, h // 2, 2, w // 2, 2, c) \
        .transpose(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)
    return np.ascontiguousarray(out)


def space_to_depth(frames: torch.Tensor) -> torch.Tensor:
    """:func:`space_to_depth_frames` on the device (the same channel
    order), for frames letterboxed there: one relayout pass."""
    b, h, w, c = frames.shape
    return frames.reshape(b, h // 2, 2, w // 2, 2, c) \
        .permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)


def find_detect_outputs(graph) -> list:
    """The three raw detect-conv outputs of an imported YOLO graph (the
    1x1 ``model.24.m.{0,1,2}`` convs), by descending spatial size
    (stride 8, 16, 32). The bundled `.mars` YOLO files carry a broken
    in-file decode subgraph after them."""
    outs = []
    for node in graph.nodes:
        if node.op != "CONV2D" or len(node.inputs) < 2:
            continue
        wname = node.inputs[1]
        t = graph.tensors.get(node.outputs[0])
        if t is None or len(t.shape) != 4 or 0 in t.shape:
            continue
        if node.attrs.get("kernel", (0, 0)) != (1, 1):
            continue
        if ".24." in wname or wname.startswith("model.24"):
            outs.append((t.shape[1], node.outputs[0]))
    outs.sort(reverse=True)
    return [name for _, name in outs]


# ---------------------------------------------------------------------------
# Head decode
# ---------------------------------------------------------------------------


def _grid(h: int, w: int, device) -> torch.Tensor:
    """[H, W, 1, 2] cell coordinates (x, y) in f32."""
    gy, gx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=device),
        torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([gx, gy], dim=-1)[:, :, None, :]


def _best_class(cls_logits: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best class logit + first-occurrence index. int8 heads pack
    (logit, 255 - idx) into int16 so one max carries both."""
    if cls_logits.dtype == torch.int8 and cls_logits.shape[-1] <= 256:
        iota = torch.arange(cls_logits.shape[-1], dtype=torch.int16,
                            device=cls_logits.device)
        comb = cls_logits.to(torch.int16) * 256 + (255 - iota)
        cmax = torch.amax(comb, dim=-1)
        return ((cmax >> 8).to(torch.float32),
                (255 - (cmax & 255)).to(torch.int32))
    # torch.argmax returns the first maximum, as jnp.argmax does
    return (torch.amax(cls_logits, dim=-1).to(torch.float32),
            torch.argmax(cls_logits, dim=-1).to(torch.int32))


def decode_and_parse(
    feats: Sequence[torch.Tensor],
    anchors: np.ndarray = YOLOV5_ANCHORS,
    strides: Sequence[int] = YOLOV5_STRIDES,
    num_classes: int = 80,
    scales: Optional[Sequence[Optional[float]]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Raw head maps [B, H, W, A*(5+NC)] -> (boxes_xywh [B,N,4],
    conf [B,N], classes [B,N] int32), anchors in (gy, gx, a) order.

    ``scales``: per-head dequant scales of int8 heads. The class max runs
    on the raw int8 values (monotonic for scale > 0); only the consumed
    channels are dequantized."""
    all_boxes, all_conf, all_cls = [], [], []
    for i, feat in enumerate(feats):
        b, h, w, ch = feat.shape
        a = anchors.shape[1]
        sc = (float(np.float32(scales[i]))
              if scales is not None and scales[i] is not None else None)
        if ch != a * (5 + num_classes):
            raise ValueError(f"head channels {ch} != {a}*(5+{num_classes})")
        x = feat.reshape(b, h, w, a, ch // a)
        x5 = x[..., 0:5].to(torch.float32)
        if sc is not None:
            x5 = x5 * sc
        sig5 = torch.sigmoid(x5)
        xy = (sig5[..., 0:2] * 2.0 - 0.5 + _grid(h, w, feat.device)) \
            * float(strides[i])
        anc = torch.as_tensor(anchors[i], dtype=torch.float32,
                              device=feat.device)
        wh = torch.square(sig5[..., 2:4] * 2.0) * anc[None, None, :, :]
        obj = sig5[..., 4]
        best_logit, cls = _best_class(x[..., 5:5 + num_classes])
        if sc is not None:
            best_logit = best_logit * sc
        conf = obj * torch.sigmoid(best_logit)
        n = h * w * a
        all_boxes.append(torch.cat([xy, wh], -1).reshape(b, n, 4))
        all_conf.append(conf.reshape(b, n))
        all_cls.append(cls.reshape(b, n))
    return (torch.cat(all_boxes, 1), torch.cat(all_conf, 1),
            torch.cat(all_cls, 1))


def decode_head_level(
    feat: torch.Tensor,           # [B, H, W, A*(5+NC)] f32 raw logits
    anchors: np.ndarray,          # [A, 2] f32 (pixels)
    stride: int,
    num_classes: int = 80,
) -> torch.Tensor:
    """YOLOv5 anchor decode of one pyramid level -> [B, H*W*A, 5+NC]:
    ``xy = (2 sigmoid(t) - 0.5 + grid) * stride``, ``wh = (2 sigmoid(t))^2
    * anchor``, obj and classes ``sigmoid(t)``, every channel's sigmoid
    (the ``detect`` flow's float decode; the serving pipeline decodes in
    kernel #8)."""
    b, h, w, _ = feat.shape
    a = anchors.shape[0]
    x = feat.reshape(b, h, w, a, 5 + num_classes)
    sig = torch.sigmoid(x)
    xy = (sig[..., 0:2] * 2.0 - 0.5 + _grid(h, w, feat.device)) \
        * float(stride)
    anc = torch.as_tensor(np.asarray(anchors, np.float32),
                          device=feat.device)
    wh = torch.square(sig[..., 2:4] * 2.0) * anc[None, None, :, :]
    out = torch.cat([xy, wh, sig[..., 4:]], dim=-1)
    return out.reshape(b, h * w * a, 5 + num_classes)


def decode_heads(
    feats: Sequence[torch.Tensor],
    anchors: np.ndarray = YOLOV5_ANCHORS,
    strides: Sequence[int] = YOLOV5_STRIDES,
    num_classes: int = 80,
) -> torch.Tensor:
    """:func:`decode_head_level` of every level, concatenated ->
    [B, N, 5+NC]."""
    return torch.cat([decode_head_level(f, anchors[i], strides[i],
                                        num_classes)
                      for i, f in enumerate(feats)], dim=1)


def parse_predictions(
    pred: torch.Tensor,           # [B, N, 5+NC] int8 or f32
    scale: float = 1.0,
    already_sigmoid: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[B, N, 5+NC] -> (boxes_xywh [B, N, 4], scores [B, N], classes
    [B, N] int32), the reference's parse: obj = sigmoid(p4 * s), class =
    argmax of the raw class logits (the first maximum), conf = obj *
    sigmoid(best). ``already_sigmoid`` skips both sigmoids, for decoded
    heads."""
    p = pred.to(torch.float32) * float(np.float32(scale))
    boxes = p[..., 0:4]
    best = torch.amax(p[..., 5:], dim=-1)
    if already_sigmoid:
        conf = p[..., 4] * best
    else:
        conf = torch.sigmoid(p[..., 4]) * torch.sigmoid(best)
    classes = torch.argmax(p[..., 5:], dim=-1).to(torch.int32)
    return boxes, conf, classes


def decode_anchor_free(
    box_feats: Sequence[torch.Tensor],   # per level [B, H, W, 4*reg_max]
    cls_feats: Sequence[torch.Tensor],   # per level [B, H, W, NC]
    strides: Sequence[int] = YOLOV5_STRIDES,
    reg_max: int = 16,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Anchor-free DFL decode (yolov5u / yolov8-style heads): each box side
    is the softmax expectation over ``reg_max`` bins, in stride units from
    the cell centre; the class score is the sigmoid of the best logit (no
    objectness). Returns (boxes_xywh [B, N, 4], conf [B, N], classes
    [B, N] int32)."""
    all_b, all_s, all_c = [], [], []
    for bf, cf, stride in zip(box_feats, cls_feats, strides):
        b, h, w, _ = bf.shape
        bins = torch.arange(reg_max, dtype=torch.float32, device=bf.device)
        x = bf.to(torch.float32).reshape(b, h, w, 4, reg_max)
        dist = torch.sum(torch.softmax(x, dim=-1) * bins, dim=-1)   # ltrb
        g = _grid(h, w, bf.device)[:, :, 0, :] + 0.5
        gx, gy = g[..., 0], g[..., 1]
        x0 = (gx - dist[..., 0]) * stride
        y0 = (gy - dist[..., 1]) * stride
        x1 = (gx + dist[..., 2]) * stride
        y1 = (gy + dist[..., 3]) * stride
        boxes = torch.stack([(x0 + x1) / 2, (y0 + y1) / 2,
                             x1 - x0, y1 - y0], dim=-1)
        cls_logits = cf.to(torch.float32)
        conf = torch.sigmoid(torch.amax(cls_logits, dim=-1))
        cls = torch.argmax(cls_logits, dim=-1).to(torch.int32)
        all_b.append(boxes.reshape(b, h * w, 4))
        all_s.append(conf.reshape(b, h * w))
        all_c.append(cls.reshape(b, h * w))
    return torch.cat(all_b, 1), torch.cat(all_s, 1), torch.cat(all_c, 1)


def make_anchor_tables(
    shapes: Sequence[Tuple[int, int]],
    anchors: np.ndarray = YOLOV5_ANCHORS,
    strides: Sequence[int] = YOLOV5_STRIDES,
) -> dict:
    """Flat per-candidate tables (grid x / y, anchor w / h, stride) over all
    levels in head-concat order, numpy f32: they let the decode run on the
    top-k survivors only (:func:`detect_postprocess_topk`)."""
    gx, gy, aw, ah, st = [], [], [], [], []
    for (h, w), anc, s in zip(shapes, anchors, strides):
        a = anc.shape[0]
        yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        for arrs, vals in ((gx, np.broadcast_to(xx[..., None], (h, w, a))),
                           (gy, np.broadcast_to(yy[..., None], (h, w, a)))):
            arrs.append(vals.reshape(-1).astype(np.float32))
        aw.append(np.broadcast_to(anc[None, None, :, 0],
                                  (h, w, a)).reshape(-1).astype(np.float32))
        ah.append(np.broadcast_to(anc[None, None, :, 1],
                                  (h, w, a)).reshape(-1).astype(np.float32))
        st.append(np.full(h * w * a, s, np.float32))
    return {k: np.concatenate(v) for k, v in
            (("gx", gx), ("gy", gy), ("aw", aw), ("ah", ah), ("st", st))}


def detect_postprocess_topk(
    feats: Sequence[torch.Tensor],    # per level [B, H, W, A*(5+NC)]
    scales: Optional[Sequence[Optional[float]]] = None,
    anchors: np.ndarray = YOLOV5_ANCHORS,
    strides: Sequence[int] = YOLOV5_STRIDES,
    num_classes: int = 80,
    conf_thresh: float = 0.25,
    iou_thresh: float = 0.45,
    max_dets: int = 100,
    pre_nms: int = 256,
) -> "Detections":
    """Score -> top-k -> decode the survivors only -> NMS. Only the
    confidences (obj x best class, both monotone in the raw logits) touch
    every candidate; the box math runs on the ``pre_nms`` survivors through
    the gathered :func:`make_anchor_tables`. int8 heads with their
    ``scales`` (a None entry: a float head, scale 1), float heads with
    ``scales=None``; lane-padded heads (a per-anchor block past 5+NC, a
    multiple of 128) read only their first 5+NC channels."""
    a = anchors.shape[1]
    flats, confs, clss, lvl = [], [], [], []
    for i, feat in enumerate(feats):
        b, h, w, ch = feat.shape
        blk = ch // a
        if not (ch == a * (5 + num_classes) or (
                ch % a == 0 and blk >= 5 + num_classes and blk % 128 == 0)):
            raise ValueError(f"head channels {ch} fit neither "
                             f"{a}*(5+{num_classes}) nor a lane-padded block")
        x = feat.reshape(b, h * w * a, blk)
        s = (scales[i] if scales is not None and scales[i] is not None
             else 1.0)
        sc = float(np.float32(s))
        obj = torch.sigmoid(x[..., 4].to(torch.float32) * sc)
        cls_logits = x[..., 5:5 + num_classes]
        best = torch.amax(cls_logits, dim=-1).to(torch.float32) * sc
        confs.append(obj * torch.sigmoid(best))
        clss.append(torch.argmax(cls_logits, dim=-1).to(torch.int32))
        flats.append(x[..., :4])
        lvl.append(torch.full((h * w * a,), sc, dtype=torch.float32,
                              device=feat.device))
    conf = torch.cat(confs, dim=1)                  # [B, N]
    cls = torch.cat(clss, dim=1)
    raw4 = torch.cat(flats, dim=1)                  # [B, N, 4] raw logits
    bsz, n = conf.shape
    k = min(pre_nms, n)

    dev = conf.device
    tab = {key: torch.from_numpy(v).to(dev) for key, v in make_anchor_tables(
        [(f.shape[1], f.shape[2]) for f in feats], anchors, strides).items()}
    masked = torch.where(conf >= conf_thresh, conf, 0.0)
    top, idx = top_k_grouped(masked, k)
    r = torch.gather(raw4, 1, idx[..., None].expand(bsz, k, 4)) \
        .to(torch.float32)
    if scales is not None:
        r = r * torch.cat(lvl)[idx][..., None]
    sig = torch.sigmoid(r)
    st = tab["st"][idx]
    boxes = torch.stack([
        (sig[..., 0] * 2.0 - 0.5 + tab["gx"][idx]) * st,
        (sig[..., 1] * 2.0 - 0.5 + tab["gy"][idx]) * st,
        torch.square(sig[..., 2] * 2.0) * tab["aw"][idx],
        torch.square(sig[..., 3] * 2.0) * tab["ah"][idx]], dim=-1)
    return nms_batched(boxes, top, torch.gather(cls, 1, idx),
                       conf_thresh=conf_thresh, iou_thresh=iou_thresh,
                       max_dets=max_dets, pre_nms=k)


# ---------------------------------------------------------------------------
# NMS (fixed shape, batched)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Detections:
    """Fixed-shape detection output: entries with ``valid`` False are
    padding."""

    boxes: torch.Tensor      # [B, K, 4] xyxy, input-image pixels
    scores: torch.Tensor     # [B, K]
    classes: torch.Tensor    # [B, K] int32
    valid: torch.Tensor      # [B, K] bool

    @property
    def num(self) -> torch.Tensor:
        return self.valid.to(torch.int32).sum(dim=-1)


def _xywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    xy, wh = b[..., :2], b[..., 2:4]
    half = wh * 0.5
    return torch.cat([xy - half, xy + half], dim=-1)


def _iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of [..., K, 4] xyxy boxes -> [..., K, K], with the
    reference's +1e-6 denominator guard."""
    a = boxes[..., :, None, :]
    b = boxes[..., None, :, :]
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = torch.clamp_min(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    ext = torch.clamp_min(boxes[..., 2:] - boxes[..., :2], 0.0)
    area = ext[..., 0] * ext[..., 1]
    union = area[..., :, None] + area[..., None, :] - inter
    return inter / (union + 1e-6)


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last dim: descending, ties by lower index."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def top_k_grouped(scores: torch.Tensor, k: int, group: int = 8):
    """Exact top-k over the last dim of [B, N] through a group-max
    prefilter, with the JAX version's two stages (so its tie order): the
    top-k groups by group max (ties by lower group), then the top-k of
    their k*group members in that order."""
    n = scores.shape[-1]
    if k >= n or k > 512:
        return _top_k(scores, min(k, n))
    npad = ((n + group - 1) // group) * group
    s = F.pad(scores, (0, npad - n), value=float("-inf")) \
        if npad != n else scores
    q = s.reshape(*s.shape[:-1], npad // group, group)
    gv = torch.amax(q, dim=-1)
    _, sel = _top_k(gv, min(k, q.shape[-2]))
    cand = torch.gather(q, -2, sel[..., None].expand(*sel.shape, group)) \
        .reshape(*sel.shape[:-1], -1)
    cidx = (sel[..., None] * group
            + torch.arange(group, device=scores.device)).reshape(
        *sel.shape[:-1], -1)
    v, j = _top_k(cand, k)
    return v, torch.gather(cidx, -1, j)


def nms_batched(
    boxes_xywh: torch.Tensor,      # [B, N, 4] center format
    scores: torch.Tensor,          # [B, N]
    classes: torch.Tensor,         # [B, N] int32
    conf_thresh: float = 0.25,
    iou_thresh: float = 0.45,
    max_dets: int = 100,
    class_aware: bool = True,
    pre_nms: int = 256,
    topk_group: int = 8,
) -> Detections:
    """Greedy class-aware NMS with static shapes over the batch.

    Suppression runs over the top ``pre_nms`` candidates above
    ``conf_thresh``. The greedy rule is a fixpoint over the score-sorted
    KxK overlap relation: keep[j] iff no kept higher-scored i overlaps j.
    The loop steps the whole batch until no frame changes (at most K
    steps); a frame at its fixpoint stays there, so this equals the JAX
    per-frame ``while_loop``."""
    bsz = scores.shape[0]
    k = min(max(pre_nms, max_dets), scores.shape[-1])
    masked = torch.where(scores >= conf_thresh, scores, 0.0)
    top_scores, idx = top_k_grouped(masked, k, group=topk_group)
    top_boxes = _xywh_to_xyxy(
        torch.gather(boxes_xywh, 1, idx[..., None].expand(bsz, k, 4)))
    top_classes = torch.gather(classes, 1, idx)

    iou = _iou_matrix(top_boxes)
    if class_aware:
        same = top_classes[:, :, None] == top_classes[:, None, :]
        iou = torch.where(same, iou, 0.0)
    ar = torch.arange(k, device=scores.device)
    up = (iou > iou_thresh) & (ar[:, None] < ar[None, :])  # i suppresses j

    keep = torch.ones((bsz, k), dtype=torch.bool, device=scores.device)
    for _ in range(k):
        new = ~torch.any(up & keep[:, :, None], dim=1)
        if torch.equal(new, keep):
            break
        keep = new
    valid = keep & (top_scores > 0.0)
    if k > max_dets:
        # survivors are score-sorted: a top-k over the masked scores keeps
        # the reference's output order
        sel_scores, sel = _top_k(torch.where(valid, top_scores, 0.0),
                                 max_dets)
        top_boxes = torch.gather(top_boxes, 1,
                                 sel[..., None].expand(bsz, max_dets, 4))
        top_scores = sel_scores
        top_classes = torch.gather(top_classes, 1, sel)
        valid = torch.gather(valid, 1, sel) & (sel_scores > 0.0)
    elif k < max_dets:
        pad = max_dets - k
        top_boxes = F.pad(top_boxes, (0, 0, 0, pad))
        top_scores = F.pad(top_scores, (0, pad))
        top_classes = F.pad(top_classes, (0, pad))
        valid = F.pad(valid, (0, pad))
    return Detections(boxes=top_boxes, scores=top_scores,
                      classes=top_classes, valid=valid)


def nms_fixed(boxes_xywh: torch.Tensor, scores: torch.Tensor,
              classes: torch.Tensor, **kw) -> Detections:
    """:func:`nms_batched` for one frame: [N, 4], [N], [N] -> [K, ...]."""
    d = nms_batched(boxes_xywh[None], scores[None], classes[None], **kw)
    return Detections(boxes=d.boxes[0], scores=d.scores[0],
                      classes=d.classes[0], valid=d.valid[0])


def match_share(got: Detections, ref: Detections, iou: float = 0.9
                ) -> float:
    """How far two detection sets of the same frames agree: the share
    :func:`match_counts` matched; 1.0 where both are empty."""
    matched, total = match_counts(got, ref, iou)
    return 1.0 if total == 0 else matched / total


def match_counts(got: Detections, ref: Detections, iou: float = 0.9
                 ) -> Tuple[int, int]:
    """``(matched, total)``: detections matched one to one, greedily by
    IoU, at IoU >= ``iou`` with the same class, and the larger set of each
    frame, summed over the frames. Any objects with ``boxes``,
    ``classes`` and ``valid`` of the :class:`Detections` shapes (numpy
    arrays too)."""
    matched = total = 0
    for f in range(len(got.valid)):
        sets = []
        for d in (got, ref):
            v = np.asarray(d.valid[f])
            sets.append((np.asarray(d.boxes[f], np.float64)[v],
                         np.asarray(d.classes[f])[v]))
        (gb, gc), (rb, rc) = sets
        total += max(len(gb), len(rb))
        if not len(gb) or not len(rb):
            continue
        lt = np.maximum(gb[:, None, :2], rb[None, :, :2])
        rbm = np.minimum(gb[:, None, 2:], rb[None, :, 2:])
        inter = np.prod(np.clip(rbm - lt, 0, None), -1)
        area = lambda x: np.prod(np.clip(x[:, 2:] - x[:, :2], 0, None), -1)
        m = inter / (area(gb)[:, None] + area(rb)[None, :] - inter + 1e-9)
        m = np.where(gc[:, None] == rc[None, :], m, 0.0)
        while m.max() >= iou:
            i, j = np.unravel_index(np.argmax(m), m.shape)
            matched += 1
            m[i, :] = 0.0
            m[:, j] = 0.0
    return matched, total


def scale_boxes_to_original(
    boxes_xyxy: torch.Tensor,
    orig_hw: Tuple[int, int],
    letterboxed_hw: Tuple[int, int] = (640, 640),
) -> torch.Tensor:
    """Undo the letterbox: subtract the pad, divide by the scale, clamp
    to the image."""
    oh, ow = orig_hw
    th, tw = letterboxed_hw
    scale = min(tw / ow, th / oh)
    px = (tw - ow * scale) / 2.0
    py = (th - oh * scale) / 2.0
    dev = boxes_xyxy.device
    shift = torch.tensor([px, py, px, py], dtype=torch.float32, device=dev)
    out = (boxes_xyxy - shift) / float(np.float32(scale))
    lim = torch.tensor([ow - 1, oh - 1, ow - 1, oh - 1], dtype=torch.float32,
                       device=dev)
    return torch.clamp(out, min=torch.zeros_like(lim), max=lim)


# ---------------------------------------------------------------------------
# The serving pipeline
# ---------------------------------------------------------------------------


def build_serving_pipeline(engine):
    """uint8 frames [B, H, W, 3] on the engine's device -> Detections in
    letterboxed-frame pixels: letterbox -> int8 quantize -> engine ->
    decode -> NMS (conf 0.25, IoU 0.45, 100 detections, pool 128, group
    8), the composition the JAX ``bench.py`` pipeline runs, for the
    engine's tier. ``engine`` is a ``runtime.Engine`` whose outputs are
    the three detect heads.

    The fast tier quantizes into bf16 (:func:`quantize_input_int8`). Its
    heads are bf16, decoded with no scales, or with
    ``quantize_outputs=True`` int8 with their scales. A graph whose stem
    ``ir.passes.stem_space_to_depth`` rewrote (its mark ``stem_s2d``)
    takes frames letterboxed to twice its input size, then
    :func:`space_to_depth` on the device; frames already at its input
    shape (in :func:`space_to_depth_frames` order, a pre-sized feed) go
    straight in, as the letterbox is then the identity.

    The decode is ``ops.decode_kernel.decode_and_parse_fused``: one
    kernel over the three heads on a CUDA device, int8 or bf16, its plain
    version (:func:`decode_and_parse`) on the CPU."""
    # imported here: ops.decode_kernel imports this module
    from thingino_accel_tpu_torch.ops.decode_kernel import (
        decode_and_parse_fused,
    )
    in_t = engine.graph.tensors[engine.input_names[0]]
    s2d = engine.graph.stem_s2d
    target = (in_t.shape[1] * (1 + s2d), in_t.shape[2] * (1 + s2d))
    out_names = engine.output_names
    heads = [engine.graph.tensors[o] for o in out_names]
    scales = (None if any(h.dtype.kind == "f" for h in heads)
              else [h.quant.scale for h in heads])
    dtype = (torch.bfloat16 if engine.options.precision == "fast"
             else torch.int8)

    def pipeline(frames_u8: torch.Tensor) -> Detections:
        if s2d and tuple(frames_u8.shape[1:]) == tuple(in_t.shape[1:]):
            x = quantize_input_int8(frames_u8, dtype)
        else:
            x = letterbox_uint8(frames_u8, target)
            x = quantize_input_int8(space_to_depth(x) if s2d else x, dtype)
        feats = engine.forward(x)
        boxes, scores, classes = decode_and_parse_fused(
            [feats[k] for k in out_names], scales=scales)
        return nms_batched(boxes, scores, classes, max_dets=100,
                           pre_nms=128, topk_group=8)

    return pipeline


def build_e2e_mars_pipeline(
    engine,                       # runtime.Engine over a .mars YOLO graph
    frame_hw: Tuple[int, int],
    conf_thresh: float = 0.25,
    iou_thresh: float = 0.45,
    max_dets: int = 100,
):
    """uint8 frames [B, H, W, 3] on the engine's device -> Detections in
    frame pixels, for a graph whose first output is the [B, N, 5+NC]
    predictions (the reference's ``mars_yolo_test.c`` flow): letterbox ->
    int8 quantize (an int8 input) or normalize to [0, 1] (a float input)
    -> network -> :func:`parse_predictions` at the output's scale ->
    :func:`nms_batched` -> :func:`scale_boxes_to_original`."""
    in_t = engine.graph.tensors[engine.input_names[0]]
    out_name = engine.output_names[0]
    out_t = engine.graph.tensors[out_name]
    target = (in_t.shape[1], in_t.shape[2])
    is_int8 = np.issubdtype(in_t.dtype, np.signedinteger)
    out_scale = out_t.quant.scale

    def pipeline(frames_u8: torch.Tensor) -> Detections:
        lb = letterbox_uint8(frames_u8, target)
        x = quantize_input_int8(lb) if is_int8 else normalize_input_f32(lb)
        preds = engine.forward(x)[out_name]
        if preds.dim() == 2:
            preds = preds[None]
        boxes, scores, classes = parse_predictions(preds, out_scale)
        dets = nms_batched(boxes, scores, classes, conf_thresh=conf_thresh,
                           iou_thresh=iou_thresh, max_dets=max_dets)
        return Detections(
            boxes=scale_boxes_to_original(dets.boxes, frame_hw, target),
            scores=dets.scores, classes=dets.classes, valid=dets.valid)

    return pipeline
