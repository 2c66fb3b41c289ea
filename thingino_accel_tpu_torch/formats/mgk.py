"""`.mgk` (Magik) model importer — offline parsing only.

Copy of ``thingino_accel_tpu/formats/mgk.py`` (numpy only), on the port's
``formats.packing``, ``onnx_proto``, ``onnx_writer`` and ``onnx``: the
same bytes in give the same metadata, arrays and ONNX bytes out.

A `.mgk` model is a MIPS32 ELF shared object carrying both OEM-compiled
kernel code and weights. The reference has two ways in: a host runtime
that ``dlopen``s the model and reconstructs the OEM C++ ABI
(``src/venus/``, fragile by design), and an offline decompiler that mines
the ELF statically (``mgk-decompiler/``). Only the second makes sense off
the device it was compiled for: **we never execute model code** — this
module parses the ELF, mines ``.rodata`` metadata (layer names, formats,
dtypes, quant scales), extracts the appended weight blob, and
reconstructs a runnable IR graph for recognized architectures (the AEC
audio model; the YOLO family in ``formats.mgk_yolo``).

File layout (verified against ``AEC_T41_16K_NS_OUT_UC.mgk``):
ELF header/sections (.text code, .rodata metadata, .data.rel.ro) followed
by raw appended weights at ``elf_end = e_shoff + e_shnum * e_shentsize``
— the same end-of-ELF rule the reference loader uses
(``src/venus/model_loader.cpp:96-122``).
"""

from __future__ import annotations

import re
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from thingino_accel_tpu_torch.formats.packing import unpack_nmhwsoib2


# ---------------------------------------------------------------------------
# Minimal ELF32 parsing
# ---------------------------------------------------------------------------


@dataclass
class Section:
    name: str
    sh_type: int
    offset: int
    size: int
    addr: int


@dataclass
class ElfFile:
    sections: Dict[str, Section]
    elf_end: int
    symbols: List[Tuple[str, int, int]]  # (name, value, size)
    data: bytes

    def section_bytes(self, name: str) -> bytes:
        s = self.sections.get(name)
        if s is None:
            return b""
        return self.data[s.offset:s.offset + s.size]

    @property
    def appended(self) -> bytes:
        """The weight blob appended after the ELF proper."""
        return self.data[self.elf_end:]


def parse_elf(data: bytes) -> ElfFile:
    if len(data) < 0x34:
        raise ValueError("truncated ELF header")
    if data[:4] != b"\x7fELF":
        raise ValueError("not an ELF file")
    if data[4] != 1 or data[5] != 1:
        raise ValueError("only ELF32 little-endian .mgk files supported")
    e_shoff, = struct.unpack_from("<I", data, 0x20)
    e_shentsize, e_shnum, e_shstrndx = struct.unpack_from("<HHH", data, 0x2E)
    elf_end = e_shoff + e_shnum * e_shentsize
    if e_shentsize < 40 or elf_end > len(data):
        raise ValueError(
            f"section header table out of bounds: {e_shnum} entries of "
            f"{e_shentsize}B at {e_shoff}, file has {len(data)}")

    raw_sections = []
    for i in range(e_shnum):
        off = e_shoff + i * e_shentsize
        (sh_name, sh_type, _flags, sh_addr, sh_offset, sh_size,
         sh_link, _info, _align, _entsize) = struct.unpack_from(
             "<10I", data, off)
        raw_sections.append(
            (sh_name, sh_type, sh_addr, sh_offset, sh_size, sh_link))

    shstr_off = raw_sections[e_shstrndx][3] if e_shstrndx < len(raw_sections) \
        else 0

    def str_at(base: int, off: int) -> str:
        end = data.index(b"\x00", base + off)
        return data[base + off:end].decode("utf-8", "replace")

    sections: Dict[str, Section] = {}
    symtabs = []
    strtabs = {}
    for i, (nm, st, addr, off, size, link) in enumerate(raw_sections):
        name = str_at(shstr_off, nm) if shstr_off else f"sec{i}"
        sections[name] = Section(name=name, sh_type=st, offset=off,
                                 size=size, addr=addr)
        if st in (2, 11):  # SYMTAB, DYNSYM
            symtabs.append((name, off, size, link))
        if st == 3:
            strtabs[name] = off

    symbols: List[Tuple[str, int, int]] = []
    fallback = strtabs.get(".dynstr") or strtabs.get(".strtab")
    for _, off, size, link in symtabs:
        # each symtab names its own string table via sh_link
        # (.symtab -> .strtab, .dynsym -> .dynstr)
        str_off = (raw_sections[link][3]
                   if 0 < link < len(raw_sections)
                   and raw_sections[link][1] == 3 else fallback)
        # clamp to the file: a corrupted sh_size must not unpack past
        # the end (the str_at ValueError below is already tolerated)
        for so in range(off, min(off + size, len(data) - 15), 16):
            st_name, st_value, st_size, _info, _other, _shndx = \
                struct.unpack_from("<IIIBBH", data, so)
            if st_name and str_off is not None:
                try:
                    symbols.append(
                        (str_at(str_off, st_name), st_value, st_size))
                except ValueError:
                    pass
    return ElfFile(sections=sections, elf_end=elf_end, symbols=symbols,
                   data=data)


# ---------------------------------------------------------------------------
# .rodata metadata mining
# ---------------------------------------------------------------------------

_DATA_FORMATS = ("NHWC", "NCHW", "NDHWC32", "NDHWC", "NMHWSOIB2", "NMC32",
                 "OIHW", "HWIO", "OHWI", "NV12", "D1", "NC", "N")
_DATA_TYPES = ("FP32", "FP16", "UINT8", "INT8", "UINT16", "INT16",
               "UINT32", "INT32", "UINT4", "INT4", "UINT2", "INT2")
# Layer-name patterns across the known .mgk families
# (role of ``mgk-decompiler/src/rodata_parser.rs:230-340`` patterns 1-4):
_LAYER_RE = re.compile(rb"layer_(\d+)_Quantize([A-Za-z]+)")       # AEC style
_YOLO_LAYER_RE = re.compile(rb"(?<![0-9A-Za-z_])(\d{3,})_Quantize([A-Za-z]*)")
_PTQ_LAYER_RE = re.compile(rb"ptq_model_([a-z_]+?)_(\d+)_Quantize")
_OUTPUT_LAYER_RE = re.compile(rb"(\d+)_output_last_layer")
_ONNX_TENSOR_RE = re.compile(rb"onnx__Quantize([A-Za-z]+)_(\d+)")
_OP_PATH_RE = re.compile(rb"([A-Za-z][A-Za-z0-9]+)/([a-z0-9_]+)/([\d/]+)/")

# substring -> canonical kind, first match wins
# (role of ``rodata_parser.rs:409-461`` parse_layer_type)
_KIND_TABLE = (
    ("GRU", "GRU"), ("Gru", "GRU"),
    ("BatchNorm", "BatchNorm"),
    ("Feature", "Feature"),
    ("ConvTranspose", "ConvTranspose"),
    ("Conv", "Conv"), ("conv", "Conv"),
    ("Pool", "Pool"), ("pool", "Pool"),
    ("Concat", "Concat"), ("concat", "Concat"),
    ("Upsample", "Upsample"), ("UpSample", "Upsample"),
    ("Reshape", "Reshape"),
    ("Sigmoid", "Sigmoid"),
    ("Relu", "ReLU"), ("ReLU", "ReLU"),
    ("Add", "Add"),
    ("output_last_layer", "Output"),
)

_FUSION_MARKERS = (b"QuantizeConv2DWrapper", b"conv2d_tnpu",
                   b"QuantizeWeight", b"fuse_")


def classify_layer_name(name: str) -> str:
    for pat, kind in _KIND_TABLE:
        if pat in name:
            return kind
    if name.endswith("_Quantize"):
        return "QuantizedLayer"
    return "Unknown"


def _cstr_at(data: bytes, off: int) -> str:
    end = data.find(b"\x00", off)
    return data[off:end if end >= 0 else len(data)].decode(
        "utf-8", "replace")


@dataclass
class MgkLayer:
    layer_id: int
    kind: str           # Feature / BatchNorm / GRU / ...
    name: str
    offset: int
    fused: bool = False


@dataclass
class MgkTensor:
    """A tensor name mined from .rodata plus format/dtype strings found
    within 64 bytes of it (the reference associates metadata by
    proximity, ``rodata_parser.rs:177-219``)."""
    name: str
    offset: int
    fmt: Optional[str] = None
    dtype: Optional[str] = None


@dataclass
class MgkMetadata:
    layers: List[MgkLayer] = field(default_factory=list)
    tensors: List["MgkTensor"] = field(default_factory=list)
    op_paths: List[str] = field(default_factory=list)
    formats: List[str] = field(default_factory=list)
    dtypes: List[str] = field(default_factory=list)
    strings: List[str] = field(default_factory=list)
    scale_groups: List[Tuple[int, List[float]]] = field(default_factory=list)
    weight_size: int = 0
    elf_end: int = 0
    has_fused_ops: bool = False


_TENSOR_PREFIXES = ("onnx__", "__FormatConvert", "__Reshape",
                    "__ConvertTensor", "__Transpose", "input", "output",
                    "hidden", "images")


def mine_tensor_info(ro: bytes) -> List[MgkTensor]:
    """Tensor names + nearby format/dtype association."""
    out: List[MgkTensor] = []
    for m in re.finditer(rb"[ -~]{3,}", ro):
        s = m.group(0).decode()
        if not any(s.startswith(p) for p in _TENSOR_PREFIXES):
            continue
        if not all(c.isalnum() or c in "_-" for c in s):
            continue
        window = ro[m.end():m.end() + 64]
        fmt = next((f for f in _DATA_FORMATS
                    if f.encode() in window), None)
        dt = next((d for d in _DATA_TYPES
                   if d.encode() in window), None)
        out.append(MgkTensor(name=s, offset=m.start(), fmt=fmt, dtype=dt))
    return out


def mine_rodata(elf: ElfFile) -> MgkMetadata:
    """Mine layer names / tensor names / op paths / formats / scales
    from .rodata (the role of
    ``mgk-decompiler/src/rodata_parser.rs:116-732``)."""
    ro = elf.section_bytes(".rodata")
    meta = MgkMetadata(weight_size=len(elf.appended), elf_end=elf.elf_end)
    meta.has_fused_ops = any(p in ro for p in _FUSION_MARKERS)

    seen = set()

    def add(lid: int, kind: str, nm: str, off: int) -> None:
        if lid not in seen:
            seen.add(lid)
            meta.layers.append(MgkLayer(
                layer_id=lid, kind=kind, name=nm, offset=off,
                fused=meta.has_fused_ops and "Quantize" in nm))

    for m in _LAYER_RE.finditer(ro):           # AEC family
        add(int(m.group(1)), m.group(2).decode(),
            _cstr_at(ro, m.start()), m.start())
    for m in _PTQ_LAYER_RE.finditer(ro):       # PTQ-fused family
        nm = _cstr_at(ro, m.start())
        add(int(m.group(2)), f"Fused_{m.group(1).decode()}",
            nm, m.start())
    if not meta.layers:
        for m in _YOLO_LAYER_RE.finditer(ro):  # YOLO family
            nm = _cstr_at(ro, m.start())
            add(int(m.group(1)), classify_layer_name(nm), nm, m.start())
    for m in _OUTPUT_LAYER_RE.finditer(ro):    # output markers
        add(int(m.group(1)), "Output", _cstr_at(ro, m.start()), m.start())
    meta.layers.sort(key=lambda l: l.layer_id)

    meta.tensors = mine_tensor_info(ro)

    for m in _OP_PATH_RE.finditer(ro):
        meta.op_paths.append(m.group(0).decode())

    # plain strings (tensor names etc.)
    for m in re.finditer(rb"[ -~]{4,}", ro):
        s = m.group(0).decode()
        meta.strings.append(s)
        if s in _DATA_FORMATS:
            meta.formats.append(s)
        if s in _DATA_TYPES:
            meta.dtypes.append(s)

    # fp32 scale groups: runs of small positive floats
    f32 = np.frombuffer(ro[:len(ro) & ~3], dtype="<f4")
    plausible = (f32 > 1e-6) & (f32 < 1e3) & np.isfinite(f32)
    run_start = None
    for i, ok in enumerate(plausible):
        if ok and run_start is None:
            run_start = i
        elif not ok and run_start is not None:
            if i - run_start >= 4:
                meta.scale_groups.append(
                    (run_start * 4, [float(v) for v in f32[run_start:i]]))
            run_start = None
    if run_start is not None and len(f32) - run_start >= 4:
        # flush a run extending to the end of .rodata (scale tables
        # are commonly the last rodata content)
        meta.scale_groups.append(
            (run_start * 4, [float(v) for v in f32[run_start:]]))
    return meta


# ---------------------------------------------------------------------------
# Weight-blob structure analysis
# ---------------------------------------------------------------------------


BLOCK = 1024   # the bytes of one block of the weight-blob analysis


def analyze_blocks(blob: bytes) -> np.ndarray:
    """Per-1024-byte block statistics of the appended weight blob.

    Returns a structured array with ``nonzero``, ``std``, and the
    ``dense`` predicate (>900 nonzero and std>20 — real NNA weight
    tiles vs padding; role of
    ``mgk-decompiler/src/weight_extractor.rs`` analyze_weight_blocks /
    ``mgk_decompiler.py`` analyze_weight_structure)."""
    n = len(blob) // BLOCK
    arr = np.frombuffer(blob[:n * BLOCK], np.int8).reshape(n, BLOCK)
    nonzero = np.count_nonzero(arr, axis=1)
    std = arr.astype(np.float32).std(axis=1)
    out = np.zeros(n, dtype=[("nonzero", np.int32), ("std", np.float32),
                             ("dense", bool)])
    out["nonzero"] = nonzero
    out["std"] = std
    out["dense"] = (nonzero > 900) & (std > 20)
    return out


def detect_weight_boundaries(blob: bytes) -> List[int]:
    """Byte offsets where the blob's block statistics change regime:
    dense<->sparse transitions or std jumps > 30 (the reference's
    boundary heuristic, ``weight_extractor.rs:482-503``)."""
    st = analyze_blocks(blob)
    bounds = [0]
    for i in range(1, len(st)):
        if st["dense"][i] != st["dense"][i - 1] or \
                abs(float(st["std"][i]) - float(st["std"][i - 1])) > 30.0:
            bounds.append(i * BLOCK)
    return bounds


def dense_regions(blob: bytes) -> List[Tuple[int, int]]:
    """(offset, size) of maximal runs of dense 1024-blocks."""
    st = analyze_blocks(blob)
    out = []
    start = None
    for i, d in enumerate(st["dense"]):
        if d and start is None:
            start = i
        elif not d and start is not None:
            out.append((start * BLOCK, (i - start) * BLOCK))
            start = None
    if start is not None:
        out.append((start * BLOCK, (len(st) - start) * BLOCK))
    return out


# ---------------------------------------------------------------------------
# NMHWSOIB2 weight unpacking (int8 codec: formats.packing.unpack_nmhwsoib2,
# imported above — ONE implementation; 2-bit variants below)
# ---------------------------------------------------------------------------


def unpack_2bit_signed(data: bytes) -> np.ndarray:
    """Little-endian 2-bit fields -> int8 in {-2,-1,0,1}
    (``mgk-decompiler/mgk_decompiler.py`` unpack_2bit_to_signed:
    0->0, 1->1, 2->-2, 3->-1)."""
    u = np.frombuffer(data, np.uint8)
    out = np.empty(len(u) * 4, np.int8)
    out[0::4] = u & 3
    out[1::4] = (u >> 2) & 3
    out[2::4] = (u >> 4) & 3
    out[3::4] = (u >> 6) & 3
    return np.where(out >= 2, out - 4, out).astype(np.int8)


def unpack_nmhwsoib2_2bit(data: bytes, out_ch: int, in_ch: int,
                          kh: int = 1, kw: int = 1) -> np.ndarray:
    """2-bit NMHWSOIB2 [N_OFP, M_IFP, KH, KW, PACK=4, 32, 32] -> OIHW f32.

    pack[3] carries the sign (-2 = positive, 1 = negative); pack[0:3]
    carries magnitude information. Original int8 precision is lost in
    2-bit quantization, so the reconstruction is approximate: sign *
    mean|pack[0:3]| * 10 (the reference's documented recovery,
    ``mgk_decompiler.py`` unpack_nmhwsoib2 quantize_type=2 branch)."""
    n_ofp = -(-out_ch // 32)
    m_ifp = -(-in_ch // 32)
    need = n_ofp * m_ifp * kh * kw * 4 * 32 * 32 // 4
    if len(data) < need:
        raise ValueError(f"2-bit NMHWSOIB2: need {need}, have {len(data)}")
    vals = unpack_2bit_signed(data[:need]).reshape(
        n_ofp, m_ifp, kh, kw, 4, 32, 32)
    magnitude = np.mean(np.abs(vals[:, :, :, :, 0:3].astype(np.float32)),
                        axis=4)
    sign = np.where(vals[:, :, :, :, 3] == -2, 1.0, -1.0).astype(np.float32)
    approx = sign * magnitude * 10.0
    oihw = approx.transpose(0, 4, 1, 5, 2, 3).reshape(
        n_ofp * 32, m_ifp * 32, kh, kw)
    return oihw[:out_ch, :in_ch].copy()


# ---------------------------------------------------------------------------
# Weight extraction
# ---------------------------------------------------------------------------


def unpack_gru_blocks(blob: bytes, bidirectional: bool) -> Dict[str, np.ndarray]:
    """Decode the NNA GRU weight blocks (1024-byte 32x32 tiles).

    Layout per ``mgk-decompiler/MGK_FORMAT.md`` GRU section:
    - unidirectional (4096 B): blocks 0-1 = W_ih [64,32], 2-3 = W_hh [64,32]
    - bidirectional (12864 B): 12 blocks (ir,iz,in,hr,hz,hn) x fwd/bwd
      + 576 B biases.
    """
    arr = np.frombuffer(blob, dtype=np.int8)
    out: Dict[str, np.ndarray] = {}
    if bidirectional:
        names = ["w_ir", "w_iz", "w_in", "w_hr", "w_hz", "w_hn"]
        for d, prefix in enumerate(("fwd", "bwd")):
            for i, nm in enumerate(names):
                block = arr[(d * 6 + i) * 1024:(d * 6 + i + 1) * 1024]
                out[f"{prefix}_{nm}"] = block.reshape(32, 32).copy()
        if arr.size >= 12 * 1024 + 576:
            out["bias"] = arr[12 * 1024:12 * 1024 + 576].copy()
    else:
        out["w_ih"] = arr[:2048].reshape(64, 32).copy()
        out["w_hh"] = arr[2048:4096].reshape(64, 32).copy()
    return out


# Known weight-region offsets for the bundled AEC model, from the
# reference's reverse-engineering notes (``mgk-decompiler/MGK_FORMAT.md``
# "Known Layer Offsets"). Sizes in bytes.
AEC_WEIGHT_OFFSETS = {
    "layer_46_gru_bidir": (0x00000, 12864),
    "layer_63_feature": (0x03500, 448),
    "layer_68_feature": (0x03900, 448),
    "layer_35_feature": (0x03d00, 704),
    "layer_73_feature": (0x04100, 448),
    "main_conv_region": (0x04480, 55168),
    "layer_44_feature": (0x11f00, 576),
    "layer_58_feature": (0x12300, 576),
    "layer_78_feature": (0x12700, 320),
    "layer_4_feature": (0x12a00, 3648),
    "layer_16_feature": (0x13b00, 2112),
    "layer_2_feature": (0x14b00, 320),
    "secondary_conv_region": (0x16d00, 41792),
    "layer_20_feature": (0x21180, 832),
    "layer_26_feature": (0x215c0, 832),
    "layer_28_feature": (0x21a40, 1408),
    "layer_37_gru": (0x220c0, 4096),
    "layer_10_feature": (0x231c0, 2496),
    "layer_32_feature": (0x23cc0, 768),
    "layer_41_feature": (0x24100, 704),
    "layer_8_feature": (0x24500, 1024),
    "layer_14_feature": (0x24a00, 1024),
    "layer_22_feature": (0x25140, 1772),
}


def extract_weight_table(
    elf: ElfFile, meta: MgkMetadata
) -> Dict[str, np.ndarray]:
    """Weight segmentation of the appended blob.

    Boundaries follow the NNA block structure: conv weights are
    1024-byte-aligned NMHWSOIB2 regions, GRU regions are 4096/12864-byte
    block groups (``mgk-decompiler/src/weight_extractor.rs:421-531``
    boundary detection). For the recognized AEC model the per-layer
    offset table (``AEC_WEIGHT_OFFSETS``) attributes each region; GRU
    regions are additionally decoded into their 32x32 gate matrices.
    """
    blob = elf.appended
    out: Dict[str, np.ndarray] = {}
    out["blob"] = np.frombuffer(blob, dtype=np.int8)
    n_blocks = len(blob) // 1024
    if n_blocks:
        out["blocks_1024"] = (
            np.frombuffer(blob[:n_blocks * 1024], dtype=np.int8)
            .reshape(n_blocks, 1024))
    if any(l.kind == "GRU" for l in meta.layers):
        for name, (off, size) in AEC_WEIGHT_OFFSETS.items():
            if off + size > len(blob):
                continue
            region = np.frombuffer(blob[off:off + size], dtype=np.int8)
            out[name] = region.copy()
            if "gru" in name:
                gru = unpack_gru_blocks(blob[off:off + size],
                                        bidirectional="bidir" in name)
                for k, v in gru.items():
                    out[f"{name}.{k}"] = v
    return out


# ---------------------------------------------------------------------------
# AEC model: numerically verified per-layer weight map
# ---------------------------------------------------------------------------
#
# Derived by exact-grid reconstruction against the reference
# decompiler's own extraction (``aec_model_with_weights.onnx``): every
# f32 weight tensor there is an integer grid q * scale; searching the
# .mgk's appended blob for the exact int8 byte sequence of q located
# each tensor at a unique offset. The layout is a COMPACT SEQUENTIAL
# region of plain row-major O,I,K int8 tensors (not NMHWSOIB2 for these
# small 32-channel convs), and every per-tensor scale appears verbatim
# as an f32 in .rodata at the recorded offset. Biases are all zero in
# the reference's extraction too.
#
# Each entry: (blob_offset, OIK shape, rodata_scale_offset).
AEC_SEQ_LAYOUT = {
    "expand_weight":  (1792,  (32, 8, 1),  3536),
    "down1_weight":   (2048,  (32, 32, 2), 4840),
    "conv1_weight":   (4096,  (32, 32, 1), 4848),
    "down2_weight":   (5120,  (32, 32, 2), 6076),
    "feat0_weight":   (7168,  (32, 32, 1), 6084),
    "feat1_weight":   (8192,  (32, 32, 1), 7312),
    "feat2_weight":   (9216,  (32, 32, 1), 7320),
    "gru1_W":         (10240, (1, 96, 32), 8548),
    "gru1_R":         (13312, (1, 96, 32), 8556),
    "gru2_W_fwd":     (16384, (96, 32),    9196),
    "gru2_R_fwd":     (19456, (96, 32),    12504),
    "gru2_W_bwd":     (22528, (96, 32),    14004),
    "gru2_R_bwd":     (25600, (96, 32),    14396),
    "up1_weight":     (28672, (64, 32, 2), 14056),   # ConvTranspose [I,O,K]
    "up2_weight":     (32768, (32, 32, 2), 14444),
    "out_weight":     (34816, (2, 32, 1),  15272),
}


def extract_aec_model(elf: ElfFile) -> Dict[str, np.ndarray]:
    """Per-layer f32 weights of the AEC family: int8 blob regions from
    :data:`AEC_SEQ_LAYOUT` dequantized with their .rodata scales."""
    blob = elf.appended
    ro = elf.section_bytes(".rodata")
    out: Dict[str, np.ndarray] = {}
    for name, (off, shape, sc_off) in AEC_SEQ_LAYOUT.items():
        n = int(np.prod(shape))
        q = np.frombuffer(blob[off:off + n], np.int8).astype(np.float32)
        scale = float(np.frombuffer(ro[sc_off:sc_off + 4], "<f4")[0])
        if not (1e-6 < scale < 10.0):
            raise ValueError(
                f"{name}: implausible scale {scale} at rodata+{sc_off}")
        out[name] = (q * np.float32(scale)).reshape(shape)
    # assemble the bidirectional GRU tensors [dirs, 3H, *]
    out["gru2_W"] = np.stack(
        [out.pop("gru2_W_fwd"), out.pop("gru2_W_bwd")])
    out["gru2_R"] = np.stack(
        [out.pop("gru2_R_fwd"), out.pop("gru2_R_bwd")])
    return out


def export_aec_onnx(elf: ElfFile, streaming: bool = False) -> bytes:
    """Serialize the extracted AEC model as ONNX (the role of the
    reference's ``aec_onnx_export.rs``: graph structure mirrors its
    exported ``aec_model_with_weights.onnx`` node for node).

    ``streaming``: expose gru1's hidden state as a graph input/output so
    a caller can carry it across 8-frame windows — the recurrence the
    reference's ``scripts/aec_inference.py`` streams with (its
    ``[64,1,1,32]`` hidden); gru2 is bidirectional within the window and
    resets per step there too."""
    from thingino_accel_tpu_torch.formats import onnx_proto as OP
    from thingino_accel_tpu_torch.formats import onnx_writer as W

    w = extract_aec_model(elf)
    zeros = {"expand_bias": 32, "down1_bias": 32, "conv1_bias": 32,
             "down2_bias": 32, "feat0_bias": 32, "feat1_bias": 32,
             "feat2_bias": 32, "up1_bias": 32, "up2_bias": 32,
             "out_bias": 2}
    inits = dict(w)
    for k, n in zeros.items():
        inits[k] = np.zeros((n,), np.float32)
    inits["gru1_B"] = np.zeros((1, 192), np.float32)
    inits["gru2_B"] = np.zeros((2, 192), np.float32)
    inits["squeeze_axes"] = np.asarray([1], np.int64)
    inits["gru2_shape"] = np.asarray([64, -1, 64], np.int64)

    def conv(x, wn, bn, y, k=1, s=1):
        return ("Conv", [x, wn, bn], [y],
                dict(kernel_shape=(k,), strides=(s,), pads=(0, 0)))

    nodes = [
        ("Transpose", ["input"], ["transposed"], dict(perm=(0, 2, 1))),
        conv("transposed", "expand_weight", "expand_bias", "expanded"),
        ("Relu", ["expanded"], ["expand_out"], None),
        conv("expand_out", "down1_weight", "down1_bias", "down1_out",
             k=2, s=2),
        ("Relu", ["down1_out"], ["down1_relu_out"], None),
        conv("down1_relu_out", "conv1_weight", "conv1_bias", "conv1_out"),
        ("Relu", ["conv1_out"], ["conv1_relu_out"], None),
        conv("conv1_relu_out", "down2_weight", "down2_bias", "down2_out",
             k=2, s=2),
        ("Relu", ["down2_out"], ["down2_relu_out"], None),
        conv("down2_relu_out", "feat0_weight", "feat0_bias", "feat0_out"),
        ("Relu", ["feat0_out"], ["feat0_relu_out"], None),
        conv("feat0_relu_out", "feat1_weight", "feat1_bias", "feat1_out"),
        ("Relu", ["feat1_out"], ["feat1_relu_out"], None),
        conv("feat1_relu_out", "feat2_weight", "feat2_bias", "feat2_out"),
        ("Relu", ["feat2_out"], ["feat2_relu_out"], None),
        ("Transpose", ["feat2_relu_out"], ["gru_input"],
         dict(perm=(0, 2, 1))),
        ("GRU", ["gru_input", "gru1_W", "gru1_R", "gru1_B"]
         + (["", "gru1_h0"] if streaming else []),
         ["gru1_Y", "gru1_Y_h"],
         dict(hidden_size=32, direction="forward")),
        ("Squeeze", ["gru1_Y", "squeeze_axes"], ["gru1_squeezed"], None),
        ("Transpose", ["gru1_squeezed"], ["gru1_out"],
         dict(perm=(1, 0, 2))),
        ("GRU", ["gru1_out", "gru2_W", "gru2_R", "gru2_B"],
         ["gru2_Y", "gru2_Y_h"],
         dict(hidden_size=32, direction="bidirectional")),
        ("Reshape", ["gru2_Y", "gru2_shape"], ["gru2_reshaped"], None),
        ("Transpose", ["gru2_reshaped"], ["gru2_out"],
         dict(perm=(1, 0, 2))),
        ("Transpose", ["gru2_out"], ["decoder_in"], dict(perm=(0, 2, 1))),
        ("ConvTranspose",
         ["decoder_in", "up1_weight", "up1_bias"], ["up1_out"],
         dict(kernel_shape=(2,), strides=(2,))),
        ("Relu", ["up1_out"], ["up1_relu_out"], None),
        ("ConvTranspose",
         ["up1_relu_out", "up2_weight", "up2_bias"], ["up2_out"],
         dict(kernel_shape=(2,), strides=(2,))),
        ("Relu", ["up2_out"], ["up2_relu_out"], None),
        conv("up2_relu_out", "out_weight", "out_bias", "pre_sigmoid"),
        ("Sigmoid", ["pre_sigmoid"], ["mask"], None),
        ("Transpose", ["mask"], ["output"], dict(perm=(0, 2, 1))),
    ]
    inputs = {"input": ((1, 256, 8), OP.TP_FLOAT)}
    outputs = {"output": ((1, 256, 2), OP.TP_FLOAT)}
    if streaming:
        inputs["gru1_h0"] = ((1, 64, 32), OP.TP_FLOAT)
        outputs["gru1_Y_h"] = ((1, 64, 32), OP.TP_FLOAT)
    return W.build_model(
        nodes=nodes, inputs=inputs, outputs=outputs, initializers=inits)


def mgk_to_onnx(path: str, streaming: bool = False) -> bytes:
    """`.mgk` -> ONNX bytes for recognized architectures (the CLI
    ``decompile --onnx`` role; reference: ``mgk-decompiler --onnx``).

    Families: GRU layers -> AEC exporter; conv-family symbols/names
    with a blob matching a yolov5 size table -> YOLO exporter
    (``formats.mgk_yolo``). Anything else raises
    :class:`~thingino_accel_tpu_torch.formats.mgk_yolo.UnsupportedMgkError`
    (structured: carries the mined layer kinds)."""
    from thingino_accel_tpu_torch.formats import mgk_yolo as MY
    elf, meta = load_mgk(path)
    kinds = {l.kind for l in meta.layers}
    if "GRU" in kinds:
        return export_aec_onnx(elf, streaming=streaming)
    sym_kinds = {s.kind for s in MY.decode_layers_from_symbols(elf)}
    if "GRU" in sym_kinds:
        return export_aec_onnx(elf, streaming=streaming)
    if "Conv" in kinds or "Conv" in sym_kinds:
        size = MY.detect_yolo_family(elf, meta)
        if size is not None:
            return MY.export_yolo_onnx(elf, meta, size)
    raise MY.UnsupportedMgkError(
        "no ONNX exporter for this .mgk family",
        kinds=kinds | sym_kinds)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def load_mgk(path_or_bytes) -> Tuple[ElfFile, MgkMetadata]:
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    elf = parse_elf(data)
    meta = mine_rodata(elf)
    return elf, meta


def inspect_mgk(path: str) -> dict:
    """CLI-facing inspection (the ``mgk-decompiler -i model.mgk`` role)."""
    elf, meta = load_mgk(path)
    kinds: Dict[str, int] = {}
    for l in meta.layers:
        kinds[l.kind] = kinds.get(l.kind, 0) + 1
    return {
        "file_size": len(elf.data),
        "elf_end": elf.elf_end,
        "weight_bytes": len(elf.appended),
        "sections": {n: s.size for n, s in elf.sections.items()
                     if s.size and not n.startswith(".debug")},
        "num_symbols": len(elf.symbols),
        "layers": [l.name for l in meta.layers],
        "layer_kinds": kinds,
        "formats_seen": sorted(set(meta.formats)),
        "dtypes_seen": sorted(set(meta.dtypes)),
        "op_paths": sorted(set(meta.op_paths))[:20],
        "num_scale_groups": len(meta.scale_groups),
    }


def extract_weights(path: str, out_dir: str) -> None:
    """Dump the appended weight blob + 1024-block view as .npy files."""
    import os
    elf, meta = load_mgk(path)
    os.makedirs(out_dir, exist_ok=True)
    for name, arr in extract_weight_table(elf, meta).items():
        np.save(os.path.join(out_dir, f"{name}.npy"), arr)


def import_mgk(path: str, streaming: bool = False):
    """Import a recognized `.mgk` model as a runnable IR graph with its
    REAL per-layer weights.

    The `.mgk` is decompiled offline (never dlopen'd — SURVEY §7) to
    ONNX via the numerically verified weight map, then imported through
    the standard ONNX front end so it runs on the same engine as every
    other model. ``streaming=True`` exposes gru1's hidden state as a
    graph input/output for cross-window carry (``models.aec.AECStream``).
    """
    from thingino_accel_tpu_torch.formats.onnx import import_onnx
    return import_onnx(mgk_to_onnx(path, streaming=streaming),
                       float32=True)
