"""YOLO pre/post-processing on torch tensors (port of
``thingino_accel_tpu.models.yolo`` for the serving path).

uint8 frames -> letterbox + int8 quantize -> engine -> anchor decode ->
class-aware NMS, all on the frames' device. Shapes stay fixed (K
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
    shrinking, as ``jax.image.resize`` is), round half to even, gray fill.
    Returns uint8 [B, th, tw, 3]."""
    b, h, w, c = frames.shape
    th, tw = target
    scale = min(tw / w, th / h)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    if (nh, nw) == (h, w):
        resized = frames
    else:
        r = F.interpolate(frames.permute(0, 3, 1, 2).to(torch.float32),
                          size=(nh, nw), mode="bilinear",
                          align_corners=False, antialias=True)
        resized = torch.clamp(torch.round(r), 0, 255).to(torch.uint8) \
            .permute(0, 2, 3, 1)
    if (nh, nw) == (th, tw):
        return resized.contiguous()
    py, px = (th - nh) // 2, (tw - nw) // 2
    out = torch.full((b, th, tw, c), pad_value, dtype=torch.uint8,
                     device=frames.device)
    out[:, py:py + nh, px:px + nw, :] = resized
    return out


def quantize_input_int8(frames_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [0,255] -> int8 centered: the reference feeds ``pixel - 128``."""
    return (frames_u8.to(torch.int32) - 128).to(torch.int8)


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
        gy, gx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=feat.device),
            torch.arange(w, dtype=torch.float32, device=feat.device),
            indexing="ij")
        grid = torch.stack([gx, gy], dim=-1)[:, :, None, :]
        xy = (sig5[..., 0:2] * 2.0 - 0.5 + grid) * float(strides[i])
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
    decode (int8 heads, per-head scales) -> NMS (conf 0.25, IoU 0.45,
    100 detections, pool 128, group 8), the composition the JAX
    ``bench.py`` serving pipeline runs. ``engine`` is a
    ``runtime.Engine`` whose outputs are the three detect heads.

    The decode is ``ops.decode_kernel.decode_and_parse_fused``: one
    kernel over the three heads on a CUDA device, its plain version
    (:func:`decode_and_parse`) on the CPU."""
    # imported here: ops.decode_kernel imports this module
    from thingino_accel_tpu_torch.ops.decode_kernel import (
        decode_and_parse_fused,
    )
    in_t = engine.graph.tensors[engine.input_names[0]]
    target = (in_t.shape[1], in_t.shape[2])
    out_names = engine.output_names
    scales = [engine.graph.tensors[o].quant.scale for o in out_names]

    def pipeline(frames_u8: torch.Tensor) -> Detections:
        x = quantize_input_int8(letterbox_uint8(frames_u8, target))
        feats = engine.forward(x)
        boxes, scores, classes = decode_and_parse_fused(
            [feats[k] for k in out_names], scales=scales)
        return nms_batched(boxes, scores, classes, max_dets=100,
                           pre_nms=128, topk_group=8)

    return pipeline
