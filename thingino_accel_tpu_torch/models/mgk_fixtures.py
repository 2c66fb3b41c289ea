"""`.mgk` files that drive the decompiler, built in process.

No OEM `.mgk` ships with the repository, so the decompiler's paths are
driven by files written here, in the manner of ``models.onnx_fixtures``:

- ``build_elf32`` assembles a little-endian ELF32 (the MIPS `.mgk`
  container shape, ``src/model.c:242-258``) with a `.rodata`, a
  `.symtab`/`.strtab` pair and a weight blob appended after the
  section-header table (the OEM layout: ``mgk-decompiler`` computes
  ``elf_end = e_shoff + shnum * shentsize`` and treats the tail as
  weights);
- ``build_yolo_mgk`` packs a zoo YOLOv5's own int8 weights in the
  sequential blob layout ``formats.mgk_yolo`` mines, with YOLO-style layer
  names, the per-layer weight-scale run and ``*_param_init`` symbols;
- ``yolo_mgk_from_mars`` packs the float weights of a `.mars` YOLOv5n
  (the real yolov5n's 60 convs have the shapes of the zoo ``n`` table),
  each re-quantized per tensor (absmax / 127, the reference compiler's
  rule), each bias in the units of the zoo graph's input scale times that
  weight scale, the units ``extract_yolo_weights`` reads;
- ``build_aec_mgk`` writes a synthetic AEC-family `.mgk`:
  ``layer_<n>_Quantize<Kind>`` names at the head of `.rodata`, an f32
  scale at each ``AEC_SEQ_LAYOUT`` `.rodata` offset, seeded int8 weights
  in the blob.

``build_elf32`` and ``build_yolo_mgk`` are copies of the JAX package's
``testing/elf_fixture.py`` and give its bytes. They write just enough of
the format for ``formats.mgk.parse_elf`` and readelf to agree on sections
and symbols; the objects are not loadable. This is test data, not a
feature: the tests and ``chip_smoke.py`` use it.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Sequence, Tuple

import numpy as np

from thingino_accel_tpu_torch.formats import mgk as MGK
from thingino_accel_tpu_torch.formats.mgk_yolo import yolo_weight_table
from thingino_accel_tpu_torch.ir.graph import Graph
from thingino_accel_tpu_torch.models import zoo

_SHT_PROGBITS = 1
_SHT_SYMTAB = 2
_SHT_STRTAB = 3

# the symbols of a YOLO-family .mgk: the param_init functions of the
# layer types it links (formats.mgk_yolo.decode_layers_from_symbols)
YOLO_SYMBOLS = [
    ("conv2d_int8_param_init", 0x1000, 64),
    ("maxpool_int8_param_init", 0x1100, 64),
    ("concat_int8_param_init", 0x1200, 64),
    ("add_int8_param_init", 0x1300, 64),
    ("upsample_int8_param_init", 0x1400, 64),
]


def _strtab(names: Sequence[str]) -> Tuple[bytes, Dict[str, int]]:
    buf = bytearray(b"\x00")
    offs = {}
    for n in names:
        offs[n] = len(buf)
        buf += n.encode() + b"\x00"
    return bytes(buf), offs


def build_elf32(
    rodata: bytes,
    symbols: Sequence[Tuple[str, int, int]] = (),   # (name, value, size)
    appended: bytes = b"",
    extra_sections: Dict[str, bytes] = None,
) -> bytes:
    """Assemble an ELF32-LE image: header | section bodies | shtab |
    ``appended`` weight blob."""
    extra_sections = dict(extra_sections or {})
    sym_strtab, sym_offs = _strtab([s[0] for s in symbols])
    symtab = bytearray(b"\x00" * 16)                  # STN_UNDEF entry
    for name, value, size in symbols:
        # st_name, st_value, st_size, st_info(FUNC=2|GLOBAL<<4),
        # st_other, st_shndx
        symtab += struct.pack("<IIIBBH", sym_offs[name], value, size,
                              (1 << 4) | 2, 0, 1)

    bodies: List[Tuple[str, int, bytes, int]] = [     # (name, type, data, link)
        (".rodata", _SHT_PROGBITS, rodata, 0),
        (".symtab", _SHT_SYMTAB, bytes(symtab), 0),   # link patched below
        (".strtab", _SHT_STRTAB, sym_strtab, 0),
    ]
    for name, data in extra_sections.items():
        bodies.append((name, _SHT_PROGBITS, data, 0))

    shnames = [""] + [b[0] for b in bodies] + [".shstrtab"]
    shstr, shoffs = _strtab(shnames[1:])
    bodies.append((".shstrtab", _SHT_STRTAB, shstr, 0))

    ehsize = 52
    off = ehsize
    placed = []                                        # (name,type,off,size,link)
    for name, st, data, link in bodies:
        placed.append((name, st, off, len(data), link))
        off += len(data)
    # patch .symtab link -> index of .strtab (section 0 is the null one)
    idx = {name: i + 1 for i, (name, *_rest) in enumerate(placed)}
    placed = [(n, t, o, s, idx[".strtab"] if n == ".symtab" else 0)
              for (n, t, o, s, _l) in placed]

    e_shoff = off
    shnum = len(placed) + 1
    shstrndx = idx[".shstrtab"]

    sh = bytearray(b"\x00" * 40)                       # null section
    for name, st, o, size, link in placed:
        sh += struct.pack("<10I", shoffs[name], st, 0, 0, o, size,
                          link, 0, 1, 16 if st == _SHT_SYMTAB else 0)

    hdr = bytearray(52)
    hdr[:4] = b"\x7fELF"
    hdr[4] = 1          # ELFCLASS32
    hdr[5] = 1          # little-endian
    hdr[6] = 1          # EV_CURRENT
    struct.pack_into("<HHI", hdr, 16, 3, 8, 1)         # ET_DYN, EM_MIPS
    struct.pack_into("<I", hdr, 0x20, e_shoff)
    struct.pack_into("<HHH", hdr, 0x2E, 40, shnum, shstrndx)

    body = b"".join(d for _, _, d, _ in bodies)
    return bytes(hdr) + body + bytes(sh) + appended


def _yolo_rodata(n_convs: int, scales=None) -> bytes:
    """YOLO-style layer names, an output marker, a format and a dtype
    string, then (``scales`` given) the weight-scale run between two 0.0
    sentinels."""
    ro = bytearray()
    for i in range(n_convs):
        ro += f"{400 + 3 * i}_QuantizeConv2D\x00".encode()
    ro += f"{400 + 3 * n_convs}_output_last_layer\x00".encode()
    ro += b"NHWC\x00INT8\x00"
    if scales is not None:
        ro += b"\x00" * ((4 - len(ro) % 4) % 4)     # 4-align
        ro += b"\x00" * 4                            # 0.0 sentinel
        ro += np.asarray(scales, "<f4").tobytes()
        ro += b"\x00" * 4                            # 0.0 sentinel
    return bytes(ro)


def build_yolo_mgk(
    size: str = "n",
    num_classes: int = 80,
    in_hw: Tuple[int, int] = (64, 64),
    w_scale_run: bool = True,
    w_scale: float = None,
) -> Tuple[bytes, Graph]:
    """Synthetic YOLO-family `.mgk`: the zoo graph's OWN int8 weights
    packed per the sequential blob layout ``formats.mgk_yolo`` mines,
    `.rodata` carrying YOLO-style layer-name strings + the per-layer
    weight-scale run, and ``*_param_init`` symbols for family
    detection. Returns (mgk_bytes, zoo_graph) so tests can compare the
    decompiled export against the graph it was packed from."""
    cfg = None
    if w_scale is not None:
        # small w_scale keeps 60 layers of random f32 weights bounded
        # so tests can compare full-model outputs numerically
        cfg = zoo.ZooConfig(dtype="int8", num_classes=num_classes,
                            in_hw=in_hw, w_scale=w_scale)
    g, entries, total = yolo_weight_table(size, num_classes, in_hw, cfg)
    blob = bytearray(total)
    for e in entries:
        w = g.tensors[e.w_name].data
        assert w.dtype == np.int8 and w.size == e.w_size
        blob[e.w_off:e.w_off + e.w_size] = w.tobytes()
        if e.b_name:
            b = g.tensors[e.b_name].data
            assert b.dtype == np.int32
            blob[e.b_off:e.b_off + e.b_size] = \
                b.astype("<i4").tobytes()
    scales = ([float(g.tensors[e.w_name].quant.scale) for e in entries]
              if w_scale_run else None)
    return build_elf32(_yolo_rodata(len(entries), scales), YOLO_SYMBOLS,
                       appended=bytes(blob)), g


def yolo_mgk_from_mars(path: str) -> Tuple[bytes, Graph]:
    """The YOLOv5n `.mars` file at ``path`` (its 60 convs in the order and
    shapes of the zoo ``n`` table) as an OEM `.mgk`: each conv's float
    weight (its int8 values times their per-channel or per-tensor scale)
    at its own per-tensor scale absmax / 127, each float bias as int32 in
    units of the zoo graph's input scale of that conv times the weight
    scale (what ``extract_yolo_weights`` reads). Returns (mgk_bytes, the
    zoo graph of the table)."""
    from thingino_accel_tpu_torch.formats.onnx_export import (
        _dequant_bias, _dequant_weight,
    )
    from thingino_accel_tpu_torch.runtime.engine import load_graph
    src = load_graph(path)
    convs = [n for n in src.nodes if n.op == "CONV2D"]
    g, entries, total = yolo_weight_table("n")
    if len(convs) != len(entries):
        raise ValueError(f"{len(convs)} convs, the yolov5n table has "
                         f"{len(entries)}")
    in_scale = {n.inputs[1]: g.tensors[n.inputs[0]].quant.scale
                for n in g.nodes if n.op == "CONV2D"}
    blob = bytearray(total)
    scales = []
    for e, node in zip(entries, convs):
        wt = src.tensors[node.inputs[1]]
        w = _dequant_weight(wt)
        if w.shape != e.shape_oihw:
            raise ValueError(f"{node.inputs[1]}: shape {w.shape}, the "
                             f"table has {e.shape_oihw}")
        ws = np.float32(max(float(np.abs(w).max()), 1e-12) / 127.0)
        q = np.clip(np.round(w / ws), -128, 127).astype(np.int8)
        blob[e.w_off:e.w_off + e.w_size] = q.tobytes()
        if e.b_name:
            b = _dequant_bias(src.tensors[node.inputs[2]],
                              src.tensors[node.inputs[0]].quant.scale, wt)
            unit = np.float32(in_scale[e.w_name]) * ws
            bq = np.clip(np.round(np.asarray(b, np.float64) / unit),
                         np.iinfo(np.int32).min,
                         np.iinfo(np.int32).max).astype("<i4")
            blob[e.b_off:e.b_off + e.b_size] = bq.tobytes()
        scales.append(float(ws))
    return build_elf32(_yolo_rodata(len(entries), scales), YOLO_SYMBOLS,
                       appended=bytes(blob)), g


# the AEC layers named in .rodata (the kinds mine_rodata reads from
# ``layer_<n>_Quantize<Kind>``), at the head of the section
AEC_LAYERS = (
    (2, "Feature"), (4, "BatchNorm"), (8, "Feature"), (10, "Feature"),
    (14, "Feature"), (16, "BatchNorm"), (20, "Feature"), (22, "Feature"),
    (26, "Feature"), (28, "BatchNorm"), (32, "Feature"), (35, "Feature"),
    (37, "GRU"), (41, "Feature"), (44, "Feature"), (46, "GRU"),
    (58, "Feature"), (63, "Feature"), (68, "Feature"), (73, "Feature"),
    (78, "Feature"),
)
# the appended blob's length: the last region of AEC_WEIGHT_OFFSETS ends
# there, so every region is present
AEC_BLOB_BYTES = max(o + s for o, s in MGK.AEC_WEIGHT_OFFSETS.values())


def build_aec_mgk(seed: int = 0) -> bytes:
    """A synthetic AEC-family `.mgk` from ``seed``: the ``layer_<n>_
    Quantize<Kind>`` names in `.rodata` below offset 1792, each
    ``AEC_SEQ_LAYOUT`` tensor's f32 scale at its `.rodata` offset, drawn in
    [1e-3, 1e-1] around 1 / (74 sqrt(fan-in)) (the int8 draws' standard
    deviation is about 74, so each layer keeps its input's magnitude),
    and seeded int8 bytes over the whole blob. ``formats.mgk.mgk_to_onnx``
    exports it through the AEC exporter."""
    rng = np.random.default_rng(seed)
    ro_len = max(sc for _, _, sc in MGK.AEC_SEQ_LAYOUT.values()) + 64
    ro = bytearray(ro_len)
    names = b"".join(f"layer_{i}_Quantize{k}\x00".encode()
                     for i, k in AEC_LAYERS) + b"NDHWC32\x00INT8\x00"
    assert len(names) < 1792
    ro[:len(names)] = names
    for name, (_, shape, sc_off) in MGK.AEC_SEQ_LAYOUT.items():
        if name.startswith("gru"):            # [(dirs,) 3H, in]
            fan_in = shape[-1]
        elif name.startswith("up"):           # ConvTranspose [I, O, K]
            fan_in = shape[0]
        else:                                 # Conv [O, I, K]
            fan_in = shape[1] * shape[2]
        scale = np.clip(rng.uniform(0.7, 1.4) / (74.0 * np.sqrt(fan_in)),
                        1e-3, 1e-1)
        ro[sc_off:sc_off + 4] = np.float32(scale).tobytes()
    blob = rng.integers(-128, 128, AEC_BLOB_BYTES, dtype=np.int8).tobytes()
    symbols = [("gru_int8_param_init", 0x2000, 64),
               ("conv2d_int8_param_init", 0x2100, 64)]
    return build_elf32(bytes(ro), symbols, appended=blob)
