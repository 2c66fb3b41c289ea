"""A JZDL person-detector `.so` built in process.

No OEM IVS library ships with the repository, so the JZDL decompiler
(``formats.jzdl``) and the calibrated reconstruction
(``models.persondet``) are driven by a file written here, as
``models.mgk_fixtures`` writes `.mgk` files:

- ``param_blob`` writes the ``*_param_mem_h`` structure blob in the
  grammar ``formats.jzdl`` parses: the header (magic, layer count, blob
  count), the input record, one record a layer with a ``20`` marker before
  each conv, a conv's (Cout, K, K, stride) then the ``-233`` same-pad
  marker (3x3) or (0, 0) (1x1), its weight block (size, flag 0 with the
  feature widths, the stem's three meta ints, flag 4 for the heads), a
  zero tail;
- ``model_blob`` writes the ``*_model_mem_h`` blob from seeded draws, one
  record a conv in that order: int8 weights (stem ``(ky, kx, ci, co)``,
  depthwise ``(K*K, C)``, pointwise and heads ``(co, ci)``), then the stem's
  int32 bias, mult and shift, a head's int32 bias and f32 scales, or an
  inner conv's ``bias i16[C] | mant i32[C/2] | shift u16[C] | reserved
  u16[C]``;
- ``build_persondet_so`` embeds both in an ELF32 `.so` (through
  ``mgk_fixtures.build_elf32``) as the ``_ZL..._param_mem_h`` /
  ``_model_mem_h`` symbols ``formats.jzdl.find_embedded_model`` mines.

The network (``LAYERS``) has the artifact's shape and every invariant the
JAX package's ``tests/test_jzdl.py`` asserts of the real file: input
3x67x67, 32 layers, a 3x3 stride-2 stem of 432 weight bytes (67 -> 34),
depthwise 3x3 / pointwise pairs, two splits, one max pool (34 -> 17), an
FPN branch upsampled and concatenated with the pre-pool skip (128 + 256 =
384 channels), two flag-4 heads of 3 anchors x 6 channels at 17x17 and
34x34, and a detect layer over both; 926,880 weight bytes (the real file
has 946,080). Weights: 4-bit stem and heads, full int8 depthwise (each
channel's centre tap at +-127), 5-bit then 4-bit pointwise (each output
row reaching the layer's ceiling); the mantissas on the x1000 Q21 grid,
shifts below 16, the reserved tail zero; head biases set so bias * scale
gives the focal priors (objectness below -8, the person class above 2).
This is test data, not a feature: the tests and ``chip_smoke.py`` use it.
"""

from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np

from thingino_accel_tpu_torch.formats import jzdl as J
from thingino_accel_tpu_torch.models.mgk_fixtures import build_elf32

INPUT_CHW = (3, 67, 67)
STEM_CHANNELS = 16
SYMBOL_BASE = "persondetv2"

# (type, bottoms, tops, out channels of a stem / pointwise / head conv)
LAYERS: List[Tuple[int, List[int], List[int], int]] = [
    (J.T_CONV_STEM, [0], [1], STEM_CHANNELS),
    (J.T_CONV_DW, [1], [2], 0), (J.T_CONV_1X1_A, [2], [3], 32),
    (J.T_CONV_DW, [3], [4], 0), (J.T_CONV_1X1_A, [4], [5], 64),
    (J.T_CONV_DW, [5], [6], 0), (J.T_CONV_1X1_A, [6], [7], 128),
    (J.T_CONV_DW, [7], [8], 0), (J.T_CONV_1X1_A, [8], [9], 256),
    (J.T_CONV_DW, [9], [10], 0), (J.T_CONV_1X1_A, [10], [11], 256),
    (J.T_SPLIT, [11], [12, 13], 0),
    (J.T_MAXPOOL, [12], [14], 0),
    (J.T_CONV_DW, [14], [15], 0), (J.T_CONV_1X1_B, [15], [16], 512),
    (J.T_CONV_DW, [16], [17], 0), (J.T_CONV_1X1_B, [17], [18], 512),
    (J.T_CONV_DW, [18], [19], 0), (J.T_CONV_1X1_B, [19], [20], 256),
    (J.T_SPLIT, [20], [21, 22], 0),
    (J.T_CONV_DW, [21], [23], 0), (J.T_CONV_1X1_B, [23], [24], 256),
    (J.T_CONV_HEAD, [24], [25], 18),
    (J.T_CONV_1X1_B, [22], [26], 128),
    (J.T_UPSAMPLE, [26], [27], 0),
    (J.T_CONCAT, [27, 13], [28], 0),
    (J.T_CONV_DW, [28], [29], 0), (J.T_CONV_1X1_B, [29], [30], 256),
    (J.T_CONV_1X1_B, [30], [31], 256),
    (J.T_CONV_HEAD, [31], [32], 18),
    (J.T_DETECT_OUT, [25, 32], [33], 0),
]
N_BLOBS = 34
# the feature width (bits) of a conv's output: 5 up to the pool, then 4
EARLY_BITS, LATE_BITS = 5, 4
POOL_BLOB = 14          # the first blob past the max pool


def _channels() -> List[Tuple[int, int]]:
    """(in, out) channels of each layer of ``LAYERS``, by dataflow."""
    blob_c = {0: INPUT_CHW[0]}
    io = []
    for ltype, bottoms, tops, cout in LAYERS:
        cin = blob_c[bottoms[0]]
        if ltype == J.T_CONCAT:
            out = sum(blob_c[b] for b in bottoms)
        elif ltype in (J.T_CONV_STEM, J.T_CONV_1X1_A, J.T_CONV_1X1_B,
                       J.T_CONV_HEAD):
            out = cout
        else:
            out = cin
        for t in tops:
            blob_c[t] = out
        io.append((cin, out))
    return io


def _late(bottoms: List[int]) -> bool:
    return bottoms[0] >= POOL_BLOB


def param_blob() -> bytes:
    """The ``*_param_mem_h`` structure blob of ``LAYERS``."""
    ints = [J.PARAM_MAGIC, len(LAYERS) + 1, N_BLOBS, J.T_INPUT, 1, 0,
            *INPUT_CHW]
    for (ltype, bottoms, tops, _), (cin, cout) in zip(LAYERS, _channels()):
        if ltype in J.CONV_TYPES:
            ints.append(20)                           # quantized-layer marker
        ints += [ltype, len(bottoms), len(tops), *bottoms, *tops]
        if ltype in J.CONV_TYPES:
            k = 1 if ltype in (J.T_CONV_1X1_A, J.T_CONV_1X1_B,
                               J.T_CONV_HEAD) else 3
            stride = 2 if ltype == J.T_CONV_STEM else 1
            # a depthwise conv's Cout field holds twice its channels
            field = 2 * cout if ltype == J.T_CONV_DW else cout
            ints += [field, k, k, stride]
            ints += [J.PAD_SAME] if k == 3 else [0, 0]
            wsize = k * k * cout * (1 if ltype == J.T_CONV_DW else cin)
            bits = LATE_BITS if _late(bottoms) else EARLY_BITS
            if ltype == J.T_CONV_HEAD:
                ints += [wsize, 4, 32, 0]
            elif ltype == J.T_CONV_STEM:
                ints += [wsize, 0, 1, 8, bits]
            else:
                ints += [wsize, 0, bits, bits]
        elif ltype == J.T_MAXPOOL:
            ints += [2, 2, 2, 2, 0, 0]
        elif ltype == J.T_UPSAMPLE:
            ints += [2, 2, 1, 0, 0]
    ints += [0] * 4                                   # zero padding tail
    return struct.pack(f"<{len(ints)}i", *ints)


def _rows_at_ceiling(rng, rows: int, cols: int, ceil: int) -> np.ndarray:
    """int8 [rows, cols] in [-ceil, ceil], each row reaching +-ceil."""
    w = rng.integers(-ceil, ceil + 1, (rows, cols))
    at = rng.integers(0, cols, rows)
    w[np.arange(rows), at] = np.where(rng.random(rows) < 0.5, -ceil, ceil)
    return w.astype(np.int8)


def _mantissas(rng, n: int) -> np.ndarray:
    """int32 multipliers on the x1000 Q21 grid: round(m 2^21) * 1000."""
    m = rng.uniform(0.5, 0.999, n)
    return (np.round(m * 2.0 ** 21).astype(np.int64) * 1000).astype("<i4")


def model_blob(seed: int = 0) -> bytes:
    """The ``*_model_mem_h`` blob: seeded weights and metadata for every
    conv of ``LAYERS``, in order."""
    rng = np.random.default_rng(seed)
    out = bytearray()
    for (ltype, bottoms, _, _), (cin, cout) in zip(LAYERS, _channels()):
        if ltype not in J.CONV_TYPES:
            continue
        late = _late(bottoms)
        if ltype == J.T_CONV_STEM:                    # (ky, kx, ci, co)
            w = _rows_at_ceiling(rng, cout, 9 * cin, 7).T
            out += w.tobytes()
            out += rng.integers(-4000, 4000, cout).astype("<i4").tobytes()
            out += _mantissas(rng, cout).tobytes()
            out += rng.integers(4, 10, cout).astype("<i4").tobytes()
        elif ltype == J.T_CONV_HEAD:                  # (co, ci)
            out += _rows_at_ceiling(rng, cout, cin, 7).tobytes()
            scale = rng.uniform(0.02, 0.06, cout).astype("<f4")
            # per anchor: box (4), objectness, person
            prior = np.concatenate([rng.uniform(-2, 2, (3, 4)),
                                    rng.uniform(-20, -10, (3, 1)),
                                    rng.uniform(3, 6, (3, 1))], axis=1)
            bias = np.round(prior.reshape(-1) / scale.astype(np.float64))
            out += bias.astype("<i4").tobytes() + scale.tobytes()
        else:
            if ltype == J.T_CONV_DW:                  # (9, C), centre +-127
                w = rng.integers(-60, 61, (9, cout))
                w[4] = np.where(rng.random(cout) < 0.5, -127, 127)
                w = w.astype(np.int8)
            else:                                     # (co, ci)
                w = _rows_at_ceiling(rng, cout, cin, 7 if late else 15)
            out += w.tobytes()
            out += rng.integers(-2000, 2000, cout).astype("<i2").tobytes()
            out += _mantissas(rng, cout // 2).tobytes()
            out += rng.integers(4, 13, cout).astype("<u2").tobytes()
            out += np.zeros(cout, "<u2").tobytes()
    return bytes(out)


def build_persondet_so(seed: int = 0) -> bytes:
    """An ELF32 `.so` embedding the person detector's two blobs in its
    `.rodata` as ``_ZL<n><base>_param_mem_h`` / ``_model_mem_h`` (the
    weights and metadata drawn from ``seed``)."""
    param, model = param_blob(), model_blob(seed)
    pad = b"\x00" * (-len(param) % 16)
    rodata = param + pad + model
    name = f"_ZL{len(SYMBOL_BASE) + 12}{SYMBOL_BASE}"
    symbols = [(f"{name}_param_mem_h", 0, len(param)),
               (f"{name}_model_mem_h", len(param) + len(pad), len(model))]
    return build_elf32(rodata, symbols)


def seeded_image(seed: int) -> np.ndarray:
    """An HWC uint8 RGB test image at the input's size from ``seed``:
    smooth colour gradients, a few bright and dark blobs, and noise, so
    that the detector's statistics are those of a picture, not of flat
    noise."""
    rng = np.random.default_rng(seed)
    h, w = INPUT_CHW[1:]
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.zeros((h, w, 3))
    for c in range(3):
        a, b, d = rng.uniform(-1, 1, 3)
        img[..., c] = 128 + 60 * np.sin(a * yy / 9 + b * xx / 11 + d * 3)
    for _ in range(4):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        r = rng.uniform(4, 12)
        blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))
        img += blob[..., None] * rng.uniform(-90, 90, 3)
    img += rng.normal(0, 8, img.shape)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)
