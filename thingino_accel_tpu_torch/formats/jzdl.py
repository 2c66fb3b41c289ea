"""jzdl (Ingenic "Zhilian DL") embedded-model decompiler.

Copy of ``thingino_accel_tpu/formats/jzdl.py`` (numpy only), on the
port's ``formats.mgk.parse_elf``: the same bytes in give the same layers,
fields and arrays out (``tests/test_torch_jzdl.py``).

OEM IVS libraries for the T-series SoCs (e.g. ``libpersonDet_inf.so``,
shipped alongside the reference) embed their
network as two ``.rodata`` byte arrays compiled from generated headers:

- ``<name>_param_mem_h``  — the network structure ("param" blob)
- ``<name>_model_mem_h``  — weights + per-channel quant metadata

and run them through ``jzdl::Net::load_param(const unsigned char*)`` /
``load_model(const unsigned char*)`` (imported from the OEM libjzdl).
The reference's decompiler stops at the ``.mgk``/magik family
(``mgk-decompiler/src/elf_parser.rs``); this module extends the same
offline no-code-execution approach (SURVEY.md §7) to the jzdl family so
the second real OEM artifact in-env can be reconstructed and served.

Everything here was derived from the binary alone (byte-level format
archaeology on ``libpersonDet_inf.so``); no OEM code was executed.

Param blob grammar (all little-endian int32, sizes verified to the byte
against the model blob):

    header:  magic=0x03000020, layer_count, n_something
    input:   0, 1, 0, C, H, W
    layer:   [type, bottom_count, top_count, bottoms..., tops...,
              params...]
             conv-like params: (Cout, K, ?, stride[, pad_marker=-233
             for K>1 'same' padding]) followed by a weight-block
             descriptor [wsize, flag, meta...]:
               flag=0: meta = (in_frac_bits, out_frac_bits) - pow2
                       feature quantization
               flag=4: meta = (32, ...) - f32 per-channel scales (heads)
    layer types observed: 0=input, 46=conv (stem, stride 2, Q31
    multiplier requant), 73=depthwise conv 3x3, 74/53=conv 1x1,
    33=split, 75=maxpool k2s2, 69=upsample x2 (weightless), 71=concat,
    51=conv 1x1 head (f32 scales, linear), 76=detection output.

Model blob layout (sequential, one record per weighted layer, in
param-blob order):

    stem (type 46):  int8 w[wsize], int32 bias[C], int32 mult[C],
                     int32 shift[C]
    heads (type 51): int8 w[wsize], int32 bias[C], f32 scale[C]
    inner convs:     int8 w[wsize], then an 8*C-byte metadata region:
                     int16  bias[C]      (acc-domain, identity order)
                     int32  mant[C/2]    (PAIR-shared multiplier for
                                          channels (2j, 2j+1))
                     uint16 shift[C]     (per-channel right shift)
                     uint16 reserved[C]  (all zero in the artifact)

The round-4 reading of the inner region as two per-channel int32
arrays ("quantA"/"packed") was WRONG — round-5 forensics decoded it
(examples/jzdl_law_search.py, docs/JZDL.md). The key fingerprints:

- exactly the second half of the old "quantA" words are divisible by
  1000 (a clean block, impossible by chance), and dividing those by
  1000 lands in [2^20, 2^21) for ~97% of entries: the toolchain stores
  multiplier mantissas on a x1000 grid — ``mant = round(m * 2^21) *
  1000`` with m in [0.5, 1). The stem's "q31_mult" follows the SAME
  convention (100% divisible by 1000, /1000 in Q21 range).
- the first half re-read as int16 gives per-channel biases with
  acc-domain magnitudes and layer-appropriate sign statistics.
- the old "packed hi/lo shifts" are simply the uint16 shift[C] array
  (first half of that region) plus a reserved all-zero tail.
- per-channel scale = mant/2^31 * 2^-shift: identity channel order and
  (2j,2j+1) mantissa pairing confirmed by regression against
  activation statistics (corr +0.44 vs +-0.03 for permuted orders).

Weight layouts, independently re-verified in round 5 (spatial
kernel-smoothness, RGB-plane correlation 0.41-vs-0.11, depthwise
center-tap dominance 1.6-3.5x): pointwise/heads (co, ci); depthwise
(K*K, C) channel-fastest; stem (ky, kx, ci, co) output-channel-fastest.

Still open (needs OEM-runtime ground truth, libjzdl is not shipped
in-env): the exact bias-application/rounding detail of the requant —
running the stored metadata verbatim keeps 23 layers of healthy
activation statistics but bleeds image signal ~2x per conv into the
clamp rails. A per-channel affine CALIBRATED from natural-image
activation statistics (``models/persondet.py``) yields a working
detector from the byte-exact weights (validated on a held-out image),
so the weights, topology and head decode are proven; only the bias
rounding law of the OEM datapath remains approximate.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from thingino_accel_tpu_torch.formats import mgk as _mgk

PARAM_MAGIC = 0x03000020
PAD_SAME = -233

# layer type ids observed in persondetv2 (names are ours; the binary
# carries no strings for them)
T_INPUT = 0
T_CONV_STEM = 46
T_CONV_DW = 73
T_CONV_1X1_A = 74
T_CONV_1X1_B = 53
T_SPLIT = 33
T_MAXPOOL = 75
T_UPSAMPLE = 69
T_CONCAT = 71
T_CONV_HEAD = 51
T_DETECT_OUT = 76

CONV_TYPES = (T_CONV_STEM, T_CONV_DW, T_CONV_1X1_A, T_CONV_1X1_B,
              T_CONV_HEAD)

LAYER_NAMES = {
    T_INPUT: "input", T_CONV_STEM: "conv-stem", T_CONV_DW: "dw3x3",
    T_CONV_1X1_A: "conv1x1", T_CONV_1X1_B: "conv1x1", T_SPLIT: "split",
    T_MAXPOOL: "maxpool", T_UPSAMPLE: "upsample", T_CONCAT: "concat",
    T_CONV_HEAD: "head", T_DETECT_OUT: "detect",
}


@dataclass
class JzdlLayer:
    ltype: int
    bottoms: List[int]
    tops: List[int]
    params: List[int] = field(default_factory=list)
    # conv-only fields
    out_channels: int = 0
    kernel: int = 1
    stride: int = 1
    weight_size: int = 0
    weight_flag: int = 0          # 0 = pow2 features, 4 = f32 scales
    weight_meta: Tuple[int, ...] = ()
    # model-blob payloads (filled by parse_model)
    weights: Optional[np.ndarray] = None      # int8, layer-native order
    bias: Optional[np.ndarray] = None         # int32 (stem/heads)
    q31_mult: Optional[np.ndarray] = None     # int32 (stem)
    q_shift: Optional[np.ndarray] = None      # int32 (stem)
    scales: Optional[np.ndarray] = None       # f32 (heads)
    quant_a: Optional[np.ndarray] = None      # raw int32 (inner convs)
    quant_packed: Optional[np.ndarray] = None  # raw uint32 (inner convs)
    # decoded inner-conv metadata (round 5; see module docstring)
    bias16: Optional[np.ndarray] = None       # int16[C] acc-domain bias
    mant: Optional[np.ndarray] = None         # int32[C] (pair-shared,
    #                                           expanded to per-channel)
    shift16: Optional[np.ndarray] = None      # uint16[C] right shift
    reserved16: Optional[np.ndarray] = None   # uint16[C] (all zero)
    in_channels: int = 0                       # derived during linking

    @property
    def is_conv(self) -> bool:
        return self.ltype in CONV_TYPES

    @property
    def is_depthwise(self) -> bool:
        return self.ltype == T_CONV_DW

    # Weight layouts, established by the per-channel-quantization
    # absmax signature (under the correct output-channel grouping,
    # EVERY channel's int absmax sits at the quant ceiling — 1.00
    # fraction for the true layout vs 0.5-0.8 for transposes; see
    # tests/test_jzdl.py::test_weight_layout_signatures in the JAX package):
    #   pointwise + heads: (co, ci), ci fastest
    #   depthwise:         (K*K, C), channel fastest, taps row-major
    #   stem:              output channel fastest (spatial x ci, co)

    def weight_matrix(self) -> np.ndarray:
        """1x1 conv / head weights as (co, ci) int8."""
        assert self.is_conv and self.kernel == 1
        return self.weights.reshape(self.out_channels, self.in_channels)

    def weight_taps(self) -> np.ndarray:
        """Depthwise weights as (K*K, C) int8 (taps row-major)."""
        assert self.is_depthwise
        return self.weights.reshape(self.kernel * self.kernel,
                                    self.out_channels)

    def requant_scale(self) -> np.ndarray:
        """Per-channel requant multiplier ``mant/2^31 * 2^-shift``
        (f64). Works for the stem and the inner convs; the stored
        mantissas follow the x1000 Q21 grid (module docstring), which
        divides out here — no decimal correction is needed."""
        if self.ltype == T_CONV_STEM:
            m = self.q31_mult.astype(np.float64)
            s = self.q_shift.astype(np.float64)
        else:
            assert self.mant is not None, "parse_model not run"
            m = self.mant.astype(np.float64)
            s = self.shift16.astype(np.float64)
        return m / 2.0 ** 31 / np.exp2(s)


@dataclass
class JzdlModel:
    input_chw: Tuple[int, int, int]
    layers: List[JzdlLayer]
    n_blobs: int

    def conv_layers(self) -> List[JzdlLayer]:
        return [l for l in self.layers if l.is_conv]


def _read_ints(blob: bytes) -> List[int]:
    n = len(blob) // 4
    return list(struct.unpack(f"<{n}i", blob[: 4 * n]))


def parse_param(blob: bytes) -> JzdlModel:
    """Decode the ``*_param_mem_h`` structure blob. Raises ValueError
    on corrupt or truncated input (never IndexError)."""
    try:
        return _parse_param(blob)
    except IndexError:
        raise ValueError("truncated jzdl param blob") from None


def _parse_param(blob: bytes) -> JzdlModel:
    ints = _read_ints(blob)
    if len(ints) < 9:
        raise ValueError("jzdl param blob too short")
    if ints[0] != PARAM_MAGIC:
        raise ValueError(
            f"bad jzdl param magic {ints[0]:#x} (want {PARAM_MAGIC:#x})")
    # header: magic, layer_count, n_something
    pos = 3
    if ints[pos] != T_INPUT:
        raise ValueError("param blob does not start with an input layer")
    # input record: 0, 1, 0, C, H, W
    c, h, w = ints[pos + 3], ints[pos + 4], ints[pos + 5]
    pos += 6
    layers: List[JzdlLayer] = [
        JzdlLayer(ltype=T_INPUT, bottoms=[], tops=[0],
                  params=[c, h, w])]
    max_blob = 0

    def take_weight_block(p: int, layer: JzdlLayer) -> int:
        layer.weight_size = ints[p]
        layer.weight_flag = ints[p + 1]
        if layer.weight_flag == 4:          # f32 per-channel scales
            layer.weight_meta = (ints[p + 2], ints[p + 3])
            return p + 4
        # flag 0: (in_frac, out_frac); the stem carries one extra
        # leading meta int (pad alignment observed only there)
        if layer.ltype == T_CONV_STEM:
            layer.weight_meta = (ints[p + 2], ints[p + 3], ints[p + 4])
            return p + 5
        layer.weight_meta = (ints[p + 2], ints[p + 3])
        return p + 4

    n = len(ints)
    while pos < n:
        t = ints[pos]
        if t == 0 and all(v == 0 for v in ints[pos:]):
            break                            # zero padding tail
        if t == 20:
            # quantized-layer marker preceding most records
            pos += 1
            continue
        ltype = t
        bc, tc = ints[pos + 1], ints[pos + 2]
        if not (0 < bc <= 4 and 0 < tc <= 4):
            raise ValueError(
                f"implausible layer record at int {pos}: "
                f"type={ltype} bc={bc} tc={tc}")
        bottoms = ints[pos + 3: pos + 3 + bc]
        tops = ints[pos + 3 + bc: pos + 3 + bc + tc]
        pos = pos + 3 + bc + tc
        layer = JzdlLayer(ltype=ltype, bottoms=bottoms, tops=tops)
        max_blob = max([max_blob] + bottoms + tops)
        if ltype in CONV_TYPES:
            # params: Cout, K, ?, stride [, -233 for same-pad K>1]
            layer.out_channels = ints[pos]
            layer.kernel = ints[pos + 1]
            layer.stride = ints[pos + 3]
            pos += 4
            if pos < n and ints[pos] == PAD_SAME:
                pos += 1
            elif layer.kernel == 1:
                pos += 2                     # 1x1 convs carry (0, 0)
            pos = take_weight_block(pos, layer)
        elif ltype == T_MAXPOOL:
            layer.params = ints[pos: pos + 6]
            pos += 6
        elif ltype == T_UPSAMPLE:
            layer.params = ints[pos: pos + 5]
            pos += 5
        elif ltype in (T_SPLIT, T_CONCAT, T_DETECT_OUT):
            pass                             # io only
        else:
            raise ValueError(f"unknown jzdl layer type {ltype}")
        layers.append(layer)

    _link_channels(layers, c)
    return JzdlModel(input_chw=(c, h, w), layers=layers,
                     n_blobs=max_blob + 1)


def _link_channels(layers: List[JzdlLayer], in_c: int) -> None:
    """Propagate channel counts through blob ids (depthwise convs keep
    channels; their Cout field in the file mirrors a doubled engine
    value, so trust dataflow instead)."""
    blob_c: Dict[int, int] = {0: in_c}
    for l in layers:
        if l.ltype == T_INPUT:
            continue
        cin = blob_c.get(l.bottoms[0], 0)
        l.in_channels = cin
        if l.is_conv:
            if l.is_depthwise:
                # weight accounting: wsize == K*K*C
                c = l.weight_size // (l.kernel * l.kernel)
                l.out_channels = c
                out_c = c
            else:
                out_c = l.out_channels
            for t in l.tops:
                blob_c[t] = out_c
        elif l.ltype == T_CONCAT:
            blob_c[l.tops[0]] = sum(blob_c.get(b, 0) for b in l.bottoms)
        else:
            for t in l.tops:
                blob_c[t] = cin


def parse_model(blob: bytes, model: JzdlModel) -> None:
    """Attach weights and quant metadata from the ``*_model_mem_h``
    blob (layout documented in the module docstring; verified to
    consume the blob exactly)."""
    off = 0
    for l in model.conv_layers():
        w = np.frombuffer(blob, np.int8, l.weight_size, off).copy()
        off += l.weight_size
        c = l.out_channels
        if l.ltype == T_CONV_STEM:
            l.bias = np.frombuffer(blob, "<i4", c, off).copy(); off += 4 * c
            l.q31_mult = np.frombuffer(blob, "<i4", c, off).copy(); off += 4 * c
            l.q_shift = np.frombuffer(blob, "<i4", c, off).copy(); off += 4 * c
        elif l.weight_flag == 4:             # heads: f32 scales
            l.bias = np.frombuffer(blob, "<i4", c, off).copy(); off += 4 * c
            l.scales = np.frombuffer(blob, "<f4", c, off).copy(); off += 4 * c
        else:
            # inner conv: 8*c-byte region = bias i16[c] | mant i32[c/2]
            # | shift u16[c] | reserved u16[c] (module docstring). Keep
            # the legacy raw views too (older tests/tools read them).
            l.quant_a = np.frombuffer(blob, "<i4", c, off).copy()
            l.bias16 = np.frombuffer(blob, "<i2", c, off).copy()
            l.mant = np.repeat(
                np.frombuffer(blob, "<i4", c // 2, off + 2 * c).copy(), 2)
            off += 4 * c
            l.quant_packed = np.frombuffer(blob, "<u4", c, off).copy()
            l.shift16 = np.frombuffer(blob, "<u2", c, off).copy()
            l.reserved16 = np.frombuffer(blob, "<u2", c, off + 2 * c).copy()
            off += 4 * c
        l.weights = w
    if off != len(blob):
        raise ValueError(
            f"model blob accounting mismatch: consumed {off} of "
            f"{len(blob)} bytes")


def find_embedded_model(path: str) -> Tuple[bytes, bytes, str]:
    """Locate the ``*_param_mem*`` / ``*_model_mem*`` symbol pair in an
    OEM ``.so`` and return (param_blob, model_blob, base_name).

    Uses the same ELF32 parser as the .mgk importer
    (``formats/mgk.py``) — static symbol-table mining, no code
    execution."""
    data = open(path, "rb").read()
    elf = _mgk.parse_elf(data)
    param_sym = model_sym = None
    for (name, value, size) in elf.symbols:
        if "param_mem" in name:
            param_sym = (name, value, size)
        elif "model_mem" in name:
            model_sym = (name, value, size)
    if not param_sym or not model_sym:
        raise ValueError(
            f"{path}: no embedded jzdl model (need *_param_mem* and "
            "*_model_mem* symbols)")

    def _extract(sym):
        name, value, size = sym
        for s in elf.sections.values():
            if s.addr <= value and value + size <= s.addr + s.size:
                off = s.offset + (value - s.addr)
                return data[off: off + size]
        raise ValueError(f"symbol {name} not backed by any section")

    base = param_sym[0]
    for tag in ("_param_mem_h", "_param_mem"):
        if tag in base:
            base = base.split(tag)[0].lstrip("_ZL0123456789")
            break
    return _extract(param_sym), _extract(model_sym), base


def load_so(path: str) -> JzdlModel:
    """One-call import: OEM .so -> parsed JzdlModel with weights."""
    param, weights, _ = find_embedded_model(path)
    model = parse_param(param)
    parse_model(weights, model)
    return model
