"""Post-training quantization: f32 graph + calibration data -> int8 graph.

Port of ``thingino_accel_tpu.training.ptq``. The reference's quantization
pipeline is offline and external: ``scripts/quantize_onnx.py`` runs
onnxruntime static QDQ quantization with an image-folder calibration
reader, then the compiler extracts the QDQ scales
(``mars-compiler/src/main.rs:137-217``). Here the whole loop is
in-framework: run the f32 graph over calibration batches in the exact
tier (``runtime.executor.ExactExecutor``, float32, TF32 off, on
``device``), observe per-tensor activation ranges, pick symmetric int8
scales, quantize weights, and rewrite the IR to an int8 graph the exact
integer engine executes. The output round-trips through `.mars`
(``formats.mars_export``).

As in JAX: the observed tensors are visited in the order of their names
(the order in which a jitted JAX function returns a dict), so that the
``default_rng(0)`` draws of ``method="mse"`` are JAX's; on the CPU the
percentile is numpy's. On the card it is numpy's value too, from the two
order statistics around it (a sort on the device) and numpy's own
interpolation steps (:func:`_percentile_by_sort`); only those values and
the subsamples come to the host.
``quantize_graph`` is pure numpy and gives JAX's graph bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Union

import numpy as np
import torch

from thingino_accel_tpu_torch.ir.graph import Graph, Node, QuantInfo, TensorInfo
from thingino_accel_tpu_torch.ops import reference as R

MSE_SAMPLES = 65536   # values a tensor keeps for ``method="mse"``
MSE_GRID = 40         # clip points ``method="mse"`` tries


@dataclasses.dataclass
class CalibStats:
    """Per-tensor absolute-max observer (symmetric quantization, matching
    the reference compiler's weight rule absmax/127)."""

    absmax: Dict[str, float]

    def scale(self, name: str, default: float = 1.0) -> float:
        am = self.absmax.get(name, 0.0)
        if am <= 0:
            return default
        return float(np.float32(am / 127.0))


def _mse_scale(sample: np.ndarray, absmax: float) -> float:
    """Quantization-MSE-optimal symmetric scale: search absmax
    fractions for the clip point minimizing E[(x - Q(x))^2]. The
    standard improvement over absmax/percentile observers — heavy-
    tailed activations (SiLU) waste most of the int8 range on
    outliers otherwise."""
    if absmax <= 0 or sample.size == 0:
        return 0.0
    cands = absmax * np.linspace(0.15, 1.0, MSE_GRID, dtype=np.float32)
    scales = cands / 127.0                      # [K]
    q = np.clip(np.round(sample[None, :] / scales[:, None]),
                -128, 127) * scales[:, None]    # [K, N]
    mse = np.mean((q - sample[None, :]) ** 2, axis=1)
    return float(cands[int(np.argmin(mse))])


def _percentile(a: torch.Tensor, q: float) -> float:
    """``np.percentile(a, q)`` of a flat float32 tensor: numpy itself on
    the CPU, :func:`_percentile_by_sort` on the card."""
    if a.device.type == "cpu":
        return float(np.percentile(a.numpy(), q))
    return _percentile_by_sort(a, q)


def _percentile_by_sort(a: torch.Tensor, q: float) -> float:
    """``np.percentile(a, q)`` (numpy's default linear method) from a sort
    on ``a``'s device: the two order statistics around the rank, combined
    by numpy's own steps, as the installed numpy promotes them (``q`` over
    ``float32(100)``, the virtual index ``(n - 1) q`` and its fraction in
    that type, then ``_lerp``)."""
    n = a.numel()
    qq = np.asanyarray(np.true_divide(q, np.float32(100)))
    vi = np.asanyarray((n - 1) * qq)
    prev = np.floor(vi)
    t = np.asanyarray(vi - prev, dtype=vi.dtype)
    lo = n - 1 if vi >= n - 1 else int(prev)
    hi = min(lo + 1, n - 1)
    s = torch.sort(a).values
    x = np.asarray(s[lo].item(), np.float32)
    y = np.asarray(s[hi].item(), np.float32)
    d = np.subtract(y, x)
    r = np.asanyarray(np.add(x, d * t))
    if t >= 0.5:
        r = np.asanyarray(np.subtract(y, d * (1 - t))).astype(r.dtype)
    return float(r)


def calibrate(
    graph: Graph,
    batches: Iterable[Dict[str, Union[np.ndarray, torch.Tensor]]],
    percentile: Optional[float] = 99.99,
    method: str = "percentile",     # "percentile" | "mse"
    device: Union[torch.device, str] = "cuda",
) -> CalibStats:
    """Run the f32 graph over calibration batches, recording activation
    ranges for every tensor. ``method="percentile"`` clips at a high
    percentile of |x| (robust to outliers); ``method="mse"`` picks the
    per-tensor clip point minimizing quantization MSE on a value
    subsample (better for heavy-tailed SiLU activations — the fix for
    the exact tier's weak detection parity, ACCURACY.md). ``device``:
    where the forward runs, the card unless the caller asks for the
    CPU."""
    from thingino_accel_tpu_torch.runtime.executor import (
        ExactExecutor, prepare_params, resolve_device,
    )
    dev = resolve_device(device)
    # instrument: make every produced activation a graph output (the
    # tensors dict may carry dead entries after graph surgery)
    produced = set(graph.inputs)
    for node in graph.nodes:
        produced.update(node.outputs)
    all_acts = [n for n, t in graph.tensors.items()
                if not t.is_const and n in produced]
    probe = Graph(nodes=graph.nodes, tensors=graph.tensors,
                  inputs=graph.inputs, outputs=all_acts, name=graph.name)
    fn = ExactExecutor(probe, dev, "full", fuse_silu=False)
    params = fn.device_params(prepare_params(graph))

    absmax: Dict[str, float] = {}
    raw_max: Dict[str, float] = {}
    samples: Dict[str, List[np.ndarray]] = {}
    rng = np.random.default_rng(0)
    with R.no_tf32(), torch.no_grad():
        for batch in batches:
            feed = {k: torch.as_tensor(v).to(dev, torch.float32)
                    for k, v in batch.items()}
            outs = fn(params, feed)
            for name in sorted(outs):
                a = outs[name].to(torch.float32).abs().reshape(-1)
                raw_max[name] = max(raw_max.get(name, 0.0),
                                    float(a.max()) if a.numel() else 0.0)
                if method == "mse":
                    n = a.numel()
                    k = min(n, max(1024, MSE_SAMPLES // 8))
                    # with-replacement draw: rng.choice(n, replace=False)
                    # materializes an O(n) int64 permutation per tensor per
                    # batch just to keep k samples; replacement is
                    # statistically equivalent here (k << n)
                    if n > k:
                        idx = torch.from_numpy(rng.integers(0, n, size=k))
                        a = a[idx.to(dev)]
                    samples.setdefault(name, []).append(a.cpu().numpy())
                elif percentile is not None and a.numel() > 1000:
                    m = _percentile(a, percentile)
                    absmax[name] = max(absmax.get(name, 0.0), m)
                else:
                    absmax[name] = raw_max[name]
    if method == "mse":
        for name, chunks in samples.items():
            s = np.concatenate(chunks)
            if s.size > MSE_SAMPLES:
                s = rng.choice(s, size=MSE_SAMPLES, replace=False)
            best = _mse_scale(s, raw_max[name])
            absmax[name] = best if best > 0 else raw_max[name]
    return CalibStats(absmax=absmax)


def quantize_graph(graph: Graph, stats: CalibStats) -> Graph:
    """Rewrite an f32 IR graph as int8: weights absmax/127 per tensor,
    activations from calibration stats, biases to int32 accumulator
    units. The result runs on the exact integer engine and exports to
    `.mars` with well-formed descriptors."""
    tensors: Dict[str, TensorInfo] = {}
    conv_nodes = [n for n in graph.nodes
                  if n.op in ("CONV2D", "DEPTHWISE_CONV2D", "FC")]
    conv_w = {n.inputs[1]: n for n in conv_nodes if len(n.inputs) > 1}
    conv_b = {n.inputs[2]: n for n in conv_nodes if len(n.inputs) > 2}

    w_scales: Dict[str, np.ndarray] = {}
    for name, t in graph.tensors.items():
        nt = TensorInfo(name=t.name, shape=t.shape, dtype=t.dtype,
                        quant=t.quant, data=t.data,
                        source_format=t.source_format,
                        channel_scales=t.channel_scales)
        if t.is_const and name in conv_w and np.issubdtype(
                np.asarray(t.data).dtype, np.floating):
            # per-output-channel symmetric scales — the accuracy-critical
            # improvement over the reference compiler's per-tensor
            # absmax/127 rule. Output channels sit on axis 0 for conv
            # weights (OIHW/OHWI) but on the LAST axis for FC ([K, O]).
            data = np.asarray(t.data, np.float32)
            ch_axis = data.ndim - 1 if conv_w[name].op == "FC" else 0
            axes = tuple(i for i in range(data.ndim) if i != ch_axis)
            am = np.abs(data).max(axis=axes)
            sc = np.maximum(am / 127.0, 1e-8).astype(np.float32)
            bshape = tuple(-1 if i == ch_axis else 1
                           for i in range(data.ndim))
            nt.data = np.clip(np.round(data / sc.reshape(bshape)),
                              -128, 127).astype(np.int8)
            nt.dtype = nt.data.dtype
            nt.quant = QuantInfo(scale=float(sc.mean()))
            nt.channel_scales = sc
            w_scales[name] = sc
        tensors[name] = nt

    # biases after weight scales are known
    for name, node in conv_b.items():
        t = tensors.get(name)
        if t is None or t.data is None or not np.issubdtype(
                np.asarray(t.data).dtype, np.floating):
            continue
        x_name, w_name = node.inputs[0], node.inputs[1]
        xs = stats.scale(x_name)
        if w_name in w_scales:
            ws = np.asarray(w_scales[w_name], np.float32)
        else:
            # weight was already int8 (skipped above): use its EXISTING
            # scales — a 1.0 fallback would quantize the bias ~100x off
            wt = graph.tensors[w_name]
            ws = (np.asarray(wt.channel_scales, np.float32)
                  if wt.channel_scales is not None
                  else np.float32(wt.quant.scale or 1.0))
        denom = np.maximum(np.float32(xs) * ws, 1e-20)
        t.data = np.clip(np.round(np.asarray(t.data, np.float64) / denom),
                         np.iinfo(np.int32).min, np.iinfo(np.int32).max
                         ).astype(np.int32)
        t.dtype = t.data.dtype

    # activations -> int8 with calibrated scales
    for name, t in tensors.items():
        if t.is_const:
            continue
        if np.issubdtype(np.dtype(t.dtype), np.floating):
            t.dtype = np.dtype(np.int8)
            t.quant = QuantInfo(scale=stats.scale(name))

    g = Graph(nodes=[Node(op=n.op, inputs=list(n.inputs),
                          outputs=list(n.outputs), attrs=dict(n.attrs),
                          name=n.name) for n in graph.nodes],
              tensors=tensors, inputs=list(graph.inputs),
              outputs=list(graph.outputs), name=f"{graph.name}_int8")
    g.validate()
    return g


def quantize_model(
    graph: Graph,
    batches: Iterable[Dict[str, Union[np.ndarray, torch.Tensor]]],
    percentile: Optional[float] = 99.99,
    method: str = "percentile",
    device: Union[torch.device, str] = "cuda",
) -> Graph:
    """One-call PTQ: calibrate (on ``device``) + quantize."""
    stats = calibrate(graph, batches, percentile, method=method,
                      device=device)
    return quantize_graph(graph, stats)
