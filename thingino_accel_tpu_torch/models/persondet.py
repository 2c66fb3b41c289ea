"""Calibrated reconstruction of the jzdl person detector.

Port of ``thingino_accel_tpu.models.persondet`` (numpy there) as torch on
the device. It runs the network decompiled from the OEM
``libpersonDet_inf.so`` (``formats.jzdl``) with its byte-exact int8
weights. The conv accumulators, topology, head decode (int32 bias + f32
per-channel scale) and the decoded quant metadata structure are all from
the artifact; the inner-conv requantization uses per-channel affines
CALIBRATED from natural-image activation statistics, because the OEM
datapath's exact bias-rounding law is not recoverable offline (see the
``formats.jzdl`` docstring).

Exactness, on the card as on the CPU:

- the accumulators are integer sums taken in float64 (the stem's K = 27
  products of |x| <= 128 by 4-bit weights, the 1x1 convs' K <= 384 of
  4/5-bit features: every sum below 2^24, so exact in any order; float64
  matmuls take no TF32) and returned as int32, JAX's;
- the calibration statistics come from exact int64 sums of the
  accumulators on the device, finished on the host: the mean equals
  numpy's bit for bit, the standard deviation (ddof 0, as ``np.std``) is
  the exact variance rounded, within 1e-15 relative of numpy's pairwise
  one, and the same bits on every device;
- requantization is ``round`` half to even, as ``np.round``.

Entry points take ``device="cuda"`` by default and raise without a card;
``device="cpu"`` runs on the CPU. ``calibration_from_numpy`` takes a JAX
calibration dict.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from thingino_accel_tpu_torch.formats import jzdl
from thingino_accel_tpu_torch.runtime.executor import resolve_device

Device = Union[torch.device, str]

# focal-init head priors decoded from the artifact (bias * scale at
# zero input); used by tests as the absolute reference point
HEAD_CHANNELS = 6        # x, y, w, h, obj, person
HEAD_ANCHORS = 3

Calibration = Dict[int, Tuple[torch.Tensor, torch.Tensor]]


def _layer_weights(l: jzdl.JzdlLayer, device: torch.device) -> torch.Tensor:
    """``l``'s weights as float64 on ``device`` in the layout
    :func:`conv_acc` multiplies by, moved there once per weight array
    (kept on the layer)."""
    cache = l.__dict__.setdefault("_device_weights", {})
    key = (str(device), id(l.weights))
    if key not in cache:
        if l.ltype == jzdl.T_CONV_STEM:
            w = l.weights.reshape(-1, l.out_channels)     # (9 Ci, Co)
        elif l.is_depthwise:
            w = l.weight_taps()                            # (9, C)
        else:
            w = l.weight_matrix().T                        # (Ci, Co)
        # the array stays referenced, so its id names it while cached
        cache[key] = (l.weights, torch.from_numpy(
            np.ascontiguousarray(w)).to(device).to(torch.float64))
    return cache[key][1]


def _taps(x: torch.Tensor, oh: int, ow: int, s: int) -> List[torch.Tensor]:
    """The 3x3 windows of ``x`` [H, W, C] zero-padded by 1, row-major,
    each [oh, ow, C] at stride ``s``."""
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    return [xp[ky:ky + s * oh:s, kx:kx + s * ow:s]
            for ky in range(3) for kx in range(3)]


def conv_acc(x: torch.Tensor, l: jzdl.JzdlLayer) -> torch.Tensor:
    """int32 accumulator map for conv layer ``l`` over ``x`` [H, W, Ci]
    (integers, on x's device), summed exactly in float64.

    Pad semantics: 3x3 convs pad 1 (the -233 'same' marker); the s2 stem
    therefore maps 67 -> 34, matching the downstream concat shapes, which
    is the artifact's own shape constraint."""
    H, W, _ = x.shape
    xf = x.to(torch.float64)
    w = _layer_weights(l, x.device)
    if l.ltype == jzdl.T_CONV_STEM:
        cols = torch.cat(_taps(xf, (H + 1) // 2, (W + 1) // 2, 2), dim=-1)
        acc = cols @ w
    elif l.is_depthwise:
        acc = torch.zeros_like(xf)
        for idx, tap in enumerate(_taps(xf, H, W, 1)):
            acc = acc + tap * w[idx]
    else:
        acc = xf @ w
    return acc.to(torch.int32)


def _structural(l, xin, blobs):
    if l.ltype == jzdl.T_SPLIT:
        for t in l.tops:
            blobs[t] = xin
    elif l.ltype == jzdl.T_MAXPOOL:
        H, W, C = xin.shape
        h2, w2 = H // 2, W // 2
        blobs[l.tops[0]] = xin[:h2 * 2, :w2 * 2].reshape(
            h2, 2, w2, 2, C).amax(dim=(1, 3))
    elif l.ltype == jzdl.T_UPSAMPLE:
        blobs[l.tops[0]] = xin.repeat_interleave(2, 0).repeat_interleave(
            2, 1)
    elif l.ltype == jzdl.T_CONCAT:
        parts = [blobs[b] for b in l.bottoms]
        h = min(p.shape[0] for p in parts)
        w = min(p.shape[1] for p in parts)
        blobs[l.tops[0]] = torch.cat([p[:h, :w] for p in parts], dim=-1)
    elif l.ltype == jzdl.T_DETECT_OUT:
        pass
    else:
        raise ValueError(f"unhandled layer type {l.ltype}")


def _acc_stats(acc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (mean, std + 1e-9) of an int32 accumulator map, ddof 0,
    from exact int64 sums on the device (module docstring). The C values
    of each are finished on the host, in float64: the card's division and
    square root are not the CPU's bit for bit (a 1-ulp std apart, measured
    on an H100), and the statistics must be the same on every device."""
    a = acc.reshape(-1, acc.shape[-1]).to(torch.int64)
    n = a.shape[0]
    s1 = a.sum(dim=0).cpu()
    s2 = (a * a).sum(dim=0).cpu()
    mean = s1.to(torch.float64) / n
    var = (n * s2 - s1 * s1).to(torch.float64) / (n * n)
    return (mean.to(acc.device),
            (torch.sqrt(var) + 1e-9).to(acc.device))


def forward(
    model: jzdl.JzdlModel,
    img,                                  # [H,W,3] uint8 RGB
    cal: Optional[Calibration] = None,
    collect_cal: Optional[Calibration] = None,
    device: Device = "cuda",
) -> Dict[int, torch.Tensor]:
    """Run the reconstruction on ``device``. Returns {head blob id:
    [H,W,18] float64 tensor}.

    With ``collect_cal`` given (an empty dict), per-layer accumulator
    (mean, std) statistics are recorded into it — that dict then serves
    as ``cal`` for subsequent images. Requant per conv: standardize the
    accumulator per channel and map +-2.5 sigma onto the feature
    range (signed view of the 4/5-bit features, metadata widths from
    the artifact's weight_meta)."""
    dev = resolve_device(device)
    c, h, w = model.input_chw
    img = torch.as_tensor(img)
    assert tuple(img.shape) == (h, w, 3), (tuple(img.shape), (h, w, 3))
    blobs: Dict[int, torch.Tensor] = {0: img.to(dev).to(torch.int32) - 128}
    heads: Dict[int, torch.Tensor] = {}
    for li, l in enumerate(model.layers):
        if l.ltype == jzdl.T_INPUT:
            continue
        xin = blobs[l.bottoms[0]]
        if l.is_conv:
            acc = conv_acc(xin, l)
        if l.is_conv and l.weight_flag != 4:
            out_bits = (l.weight_meta[2] if l.ltype == jzdl.T_CONV_STEM
                        else l.weight_meta[1])
            hi = 2 ** (out_bits - 1) - 1
            if collect_cal is not None:
                collect_cal[li] = _acc_stats(acc)
                cal = collect_cal
            if cal is None or li not in cal:
                raise ValueError("run with collect_cal= on a "
                                 "calibration image first")
            mu, sd = cal[li]
            t = (acc.to(torch.float64) - mu) / sd * (hi / 2.5)
            blobs[l.tops[0]] = torch.round(t).clamp(-hi - 1, hi).to(
                torch.int32)
        elif l.is_conv:                        # head: int32 bias, f32 scale
            bias = torch.from_numpy(l.bias).to(dev)
            scales = torch.from_numpy(l.scales).to(dev)
            y = (acc + bias).to(torch.float64) * scales.to(torch.float64)
            blobs[l.tops[0]] = y
            heads[l.tops[0]] = y
        else:
            _structural(l, xin, blobs)
    return heads


def calibrate(model: jzdl.JzdlModel, img, device: Device = "cuda"
              ) -> Calibration:
    """Collect per-layer accumulator statistics on one image."""
    cal: Calibration = {}
    forward(model, img, collect_cal=cal, device=device)
    return cal


def calibration_from_numpy(cal: Dict[int, Tuple[np.ndarray, np.ndarray]],
                           device: Device = "cuda") -> Calibration:
    """A JAX calibration dict ({layer: (mean, std) float64 arrays}) as the
    port's, tensors on ``device``."""
    dev = resolve_device(device)
    return {li: tuple(torch.from_numpy(np.asarray(a, np.float64)).to(dev)
                      for a in pair)
            for li, pair in cal.items()}


def person_maps(heads: Dict[int, torch.Tensor]) -> Dict[int, torch.Tensor]:
    """Per-head [H,W] person-logit maps: max over anchors of
    obj_logit + person_class_logit."""
    out = {}
    for hb, y in heads.items():
        g = y.reshape(y.shape[0], y.shape[1], HEAD_ANCHORS, HEAD_CHANNELS)
        out[hb] = (g[..., 4] + g[..., 5]).amax(dim=-1)
    return out


def head_priors(model: jzdl.JzdlModel, device: Device = "cuda"
                ) -> Dict[int, torch.Tensor]:
    """Per-head (anchors, 6) focal-init priors: bias*scale at zero
    input — the artifact's own absolute calibration reference."""
    dev = resolve_device(device)
    out = {}
    for hl in (l for l in model.conv_layers() if l.weight_flag == 4):
        prior = torch.from_numpy(hl.bias).to(torch.float64) * \
            torch.from_numpy(hl.scales).to(torch.float64)
        out[hl.tops[0]] = prior.reshape(HEAD_ANCHORS, HEAD_CHANNELS).to(dev)
    return out
