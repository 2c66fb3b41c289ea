"""YOLO-family `.mgk` reconstruction.

Copy of ``thingino_accel_tpu/formats/mgk_yolo.py`` on the port's
``models.zoo`` and ``formats.onnx_export``.

The reference ships a dedicated YOLO exporter that grafts weights
extracted from a compiled `.mgk` onto a known yolov5s architecture
(``mgk-decompiler/src/yolo_onnx_export.rs:1-325``) plus symbol-driven
layer detection (``layer_decoder.rs:29-66``). This module is the
framework's equivalent, with two deliberate improvements:

- the architecture/weight table is DERIVED from ``models.zoo`` (the
  same graphs the engine serves) instead of a hand-maintained list of
  70 hardcoded shapes, so every zoo size (n/s/m) exports for free and
  the table can never drift from the graph;
- the export goes through the generic ``formats.onnx_export.ir_to_onnx``
  writer, so the result round-trips through ``formats.onnx.import_onnx``
  and runs on the engine — parity is testable end to end.

Blob layout assumed (and produced by the synthetic test fixtures —
no YOLO `.mgk` ships in this environment to mine a real layout from):
per conv layer in graph topological order, int8 OIHW weights followed
by the int32 LE bias, matching the reference's sequential-offset model
(``yolo_onnx_export.rs:166-189``; it packs bias right after weights
too, differing only in assuming int8 bias units). Per-layer weight
scales are
mined from `.rodata` as the f32 scale run whose length equals the
conv count (``rodata_parser.rs`` scale mining); activation scales fall
back to the zoo calibration defaults when no run matches.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from thingino_accel_tpu_torch.formats.mgk import ElfFile, MgkMetadata

YOLO_SIZES = ("n", "s", "m")


class UnsupportedMgkError(ValueError):
    """Raised when a `.mgk` belongs to no recognized model family.

    Carries ``kinds`` (the mined layer kinds) so C-API callers can
    report a structured error instead of a bare raise."""

    def __init__(self, msg: str, kinds=()):
        super().__init__(msg)
        self.kinds = sorted(kinds)


# ---------------------------------------------------------------------------
# Symbol-driven layer decode (layer_decoder.rs:29-66, types.rs:108-141)
# ---------------------------------------------------------------------------

# param_init function-name fragments -> canonical layer kind; mirrors
# detect_layer_type_from_param_init (layer_decoder.rs:115-149).
_PARAM_INIT_KINDS = (
    ("conv2d", "Conv"), ("conv_", "Conv"),
    ("maxpool", "Pool"), ("avgpool", "Pool"), ("pool", "Pool"),
    ("concat", "Concat"),
    ("reshape", "Reshape"),
    ("permute", "Permute"),
    ("gru", "GRU"),
    ("normalize", "Normalize"),
    ("upsample", "Upsample"),
    ("slice", "Slice"),
    ("format_convert", "FormatConvert"),
    ("dequantize", "DeQuantize"),
    ("generate_box", "GenerateBox"),
    ("unsqueeze", "SqueezeUnsqueeze"), ("squeeze", "SqueezeUnsqueeze"),
    ("add", "Add"),
)

# LayerParam type-symbol fragments (types.rs:108-141). Ordered: first
# match wins; "Add" guarded against "Addr".
_LAYER_PARAM_KINDS = (
    ("Conv", "Conv"), ("Pool", "Pool"), ("Concat", "Concat"),
    ("Reshape", "Reshape"), ("Permute", "Permute"), ("Gru", "GRU"),
    ("Normalize", "Normalize"), ("Upsample", "Upsample"),
    ("Slice", "Slice"), ("FormatConvert", "FormatConvert"),
    ("DeQuantize", "DeQuantize"), ("GenerateBox", "GenerateBox"),
    ("SqueezeUnsqueeze", "SqueezeUnsqueeze"),
)


@dataclass
class SymbolLayer:
    name: str
    kind: str
    address: int
    source: str          # "param_init" | "layer_param"


def decode_layers_from_symbols(elf: ElfFile) -> List[SymbolLayer]:
    """Layer kinds from the symbol table: ``*_param_init`` functions
    (one per layer type the compiled model links) and ``*LayerParam``
    type objects as fallback — the reference's two-stage strategy
    (``layer_decoder.rs:29-66``)."""
    out: List[SymbolLayer] = []
    for name, value, _size in elf.symbols:
        if "param_init" in name:
            low = name.lower()
            for frag, kind in sorted(_PARAM_INIT_KINDS,
                                     key=lambda fk: -len(fk[0])):
                if frag in low:
                    out.append(SymbolLayer(name, kind, value, "param_init"))
                    break
            else:
                out.append(SymbolLayer(name, "Unknown", value,
                                       "param_init"))
    if not out:
        seen = set()
        for name, value, _size in elf.symbols:
            if "LayerParam" not in name or "Sp_counted" in name:
                continue
            if "Add" in name and "Addr" not in name:
                kind = "Add"
            else:
                # longest fragment first: "FormatConvert" contains
                # "Conv" and must not classify as Conv
                kind = next((k for frag, k in
                             sorted(_LAYER_PARAM_KINDS,
                                    key=lambda fk: -len(fk[0]))
                             if frag in name), "Unknown")
            if kind not in seen:
                seen.add(kind)
                out.append(SymbolLayer(name, kind, value, "layer_param"))
    return out


# ---------------------------------------------------------------------------
# Architecture/weight table (derived from the zoo, not hardcoded)
# ---------------------------------------------------------------------------


@dataclass
class ConvEntry:
    """One conv layer's slot in the sequential weight blob."""
    w_name: str
    b_name: Optional[str]
    shape_oihw: Tuple[int, int, int, int]
    w_off: int           # byte offset of int8 weights in the blob
    w_size: int          # bytes (= elements)
    b_off: int           # byte offset of the int32 bias
    b_size: int          # bytes (4 * out_channels); 0 if no bias


def _build_graph(size: str, num_classes: int, in_hw: Tuple[int, int],
                 cfg=None):
    from thingino_accel_tpu_torch.models import zoo
    return zoo.build_yolov5(size, cfg or zoo.ZooConfig(
        dtype="int8", num_classes=num_classes, in_hw=in_hw))


def yolo_weight_table(
    size: str,
    num_classes: int = 80,
    in_hw: Tuple[int, int] = (640, 640),
    cfg=None,
):
    """(graph, [ConvEntry...], total_bytes) for a zoo yolov5 size.

    The reference hand-maintains this table for yolov5s only
    (``yolo_onnx_export.rs:28-121``); deriving it from the zoo graph
    covers every size and keeps OIHW shapes authoritative."""
    g = _build_graph(size, num_classes, in_hw, cfg)
    entries: List[ConvEntry] = []
    off = 0
    for node in g.nodes:
        if node.op != "CONV2D":
            continue
        wt = g.tensors[node.inputs[1]]
        o, i, kh, kw = wt.shape       # IR weights are OIHW
        w_size = o * i * kh * kw
        b_name = node.inputs[2] if len(node.inputs) > 2 else None
        b_size = 4 * o if b_name else 0
        entries.append(ConvEntry(
            w_name=node.inputs[1], b_name=b_name,
            shape_oihw=(o, i, kh, kw),
            w_off=off, w_size=w_size,
            b_off=off + w_size, b_size=b_size))
        off += w_size + b_size
    return g, entries, off


@functools.lru_cache(maxsize=None)
def _table_total_bytes(size: str, num_classes: int) -> int:
    return yolo_weight_table(size, num_classes)[2]


def detect_yolo_family(
    elf: ElfFile,
    meta: Optional[MgkMetadata] = None,
    num_classes: int = 80,
) -> Optional[str]:
    """Size letter whose weight table exactly matches the appended
    blob length, or None. The reference assumes yolov5s
    (``main.rs`` --yolo flag); blob-length matching removes the guess.
    Byte totals are cached per (size, classes) — building the zoo graph
    just to sum conv shapes is seconds of work per call otherwise."""
    blob_len = len(elf.appended)
    for size in YOLO_SIZES:
        if _table_total_bytes(size, num_classes) == blob_len:
            return size
    return None


def mine_w_scales(meta: MgkMetadata, n_convs: int) -> Optional[np.ndarray]:
    """The `.rodata` f32 scale run whose length equals the conv count
    (per-layer weight scales). None if no run matches."""
    for _off, vals in meta.scale_groups:
        if len(vals) == n_convs and all(1e-6 < v < 10.0 for v in vals):
            return np.asarray(vals, np.float32)
    return None


def extract_yolo_weights(
    elf: ElfFile,
    meta: MgkMetadata,
    size: str,
    num_classes: int = 80,
    in_hw: Tuple[int, int] = (640, 640),
):
    """(graph, {tensor_name: f32 array}): per-layer dequantized weights
    grafted onto the architecture graph's tensor names."""
    g, entries, total = yolo_weight_table(size, num_classes, in_hw)
    blob = elf.appended
    if len(blob) < total:
        raise UnsupportedMgkError(
            f"weight blob too small for yolov5{size}: "
            f"{len(blob)} < {total}")
    w_scales = mine_w_scales(meta, len(entries))
    if w_scales is None:
        # the reference falls back to a flat default scale
        # (yolo_onnx_export.rs:244 default_scale = 0.01)
        w_scales = np.full((len(entries),), 0.01, np.float32)
    out: Dict[str, np.ndarray] = {}
    for i, e in enumerate(entries):
        q = np.frombuffer(blob[e.w_off:e.w_off + e.w_size], np.int8)
        out[e.w_name] = (q.astype(np.float32) * w_scales[i]) \
            .reshape(e.shape_oihw)
        if e.b_name:
            bq = np.frombuffer(blob[e.b_off:e.b_off + e.b_size],
                               "<i4").astype(np.float32)
            # bias units: in_scale * w_scale; in_scale from the graph's
            # calibration (no validated in-blob source without a real
            # YOLO .mgk to mine)
            in_sc = g.tensors[
                [n for n in g.nodes if n.op == "CONV2D"
                 and n.inputs[1] == e.w_name][0].inputs[0]].quant.scale
            out[e.b_name] = bq * (np.float32(in_sc) * w_scales[i])
    return g, out


def export_yolo_onnx(
    elf: ElfFile,
    meta: MgkMetadata,
    size: Optional[str] = None,
    num_classes: int = 80,
    in_hw: Tuple[int, int] = (640, 640),
) -> bytes:
    """`.mgk` -> float32 ONNX for the YOLO family (the reference's
    ``export_yolov5s_onnx``, ``yolo_onnx_export.rs:199-282``)."""
    from thingino_accel_tpu_torch.formats.onnx_export import ir_to_onnx
    if size is None:
        size = detect_yolo_family(elf, meta, num_classes)
        if size is None:
            raise UnsupportedMgkError(
                "appended blob matches no yolov5 size table "
                f"({len(elf.appended)} bytes)",
                kinds={l.kind for l in meta.layers})
    g, weights = extract_yolo_weights(elf, meta, size, num_classes, in_hw)
    return ir_to_onnx(g, weights_override=weights)
