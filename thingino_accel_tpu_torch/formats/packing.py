"""NNA packed tensor layout codecs.

Copy of ``thingino_accel_tpu/formats/packing.py`` (numpy only).

The reference NNA hardware consumes weights and features in 32-channel
packed layouts; `.mars` files produced by the reference compiler store
int8 conv weights packed and the decompiler unpacks them:

- NMHWSOIB2 weights: ``[ceil(O/32), ceil(I/32), KH, KW, 32(o), 32(i)]``
  in 1024-byte blocks (reference: ``mars-compiler/src/mars_format.rs:443-478``
  pack, ``mgk-decompiler/src/weight_extractor.rs:421-480`` unpack).
- NDHWC32 features: ``[N, ceil(C/32), H, W, 32]``
  (reference: ``mars-compiler/src/mars_format.rs:499-530``).

On TPU these layouts exist only at the file boundary: the importer unpacks
to plain dense layouts and the kernels pick their own MXU-friendly tiling.
All codecs are pure numpy reshape/transpose (no element loops).
"""

from __future__ import annotations

import numpy as np


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def unpack_nmhwsoib2(
    data: np.ndarray, out_ch: int, in_ch: int, kh: int, kw: int
) -> np.ndarray:
    """Unpack NMHWSOIB2 int8 weight blob -> OIHW ``[O, I, KH, KW]``.

    ``data`` is a flat int8/uint8 buffer of
    ``ceil(O/32)*ceil(I/32)*KH*KW*1024`` bytes.
    """
    n_ofp = _ceil_div(out_ch, 32)
    m_ifp = _ceil_div(in_ch, 32)
    expect = n_ofp * m_ifp * kh * kw * 1024
    flat = np.frombuffer(np.ascontiguousarray(data), dtype=np.int8)
    if flat.size < expect:
        raise ValueError(
            f"NMHWSOIB2 blob too small: need {expect} bytes for "
            f"O={out_ch} I={in_ch} K={kh}x{kw}, got {flat.size}"
        )
    blocks = flat[:expect].reshape(n_ofp, m_ifp, kh, kw, 32, 32)
    # [n, m, h, w, o, i] -> [n, o, m, i, h, w] -> [O_pad, I_pad, KH, KW]
    oihw = blocks.transpose(0, 4, 1, 5, 2, 3).reshape(
        n_ofp * 32, m_ifp * 32, kh, kw
    )
    return np.ascontiguousarray(oihw[:out_ch, :in_ch])


def pack_nmhwsoib2(weights_oihw: np.ndarray) -> np.ndarray:
    """Pack OIHW int8 weights -> flat NMHWSOIB2 blob (zero-padded channels)."""
    w = np.asarray(weights_oihw, dtype=np.int8)
    out_ch, in_ch, kh, kw = w.shape
    n_ofp = _ceil_div(out_ch, 32)
    m_ifp = _ceil_div(in_ch, 32)
    padded = np.zeros((n_ofp * 32, m_ifp * 32, kh, kw), dtype=np.int8)
    padded[:out_ch, :in_ch] = w
    blocks = padded.reshape(n_ofp, 32, m_ifp, 32, kh, kw)
    # [n, o, m, i, h, w] -> [n, m, h, w, o, i]
    return np.ascontiguousarray(blocks.transpose(0, 2, 4, 5, 1, 3)).reshape(-1)


def unpack_ndhwc32(
    data: np.ndarray, batch: int, channels: int, height: int, width: int
) -> np.ndarray:
    """Unpack NDHWC32 feature blob -> NCHW ``[N, C, H, W]`` (int8)."""
    d_c32 = _ceil_div(channels, 32)
    expect = batch * d_c32 * height * width * 32
    flat = np.frombuffer(np.ascontiguousarray(data), dtype=np.int8)
    if flat.size < expect:
        raise ValueError(f"NDHWC32 blob too small: need {expect}, got {flat.size}")
    t = flat[:expect].reshape(batch, d_c32, height, width, 32)
    # [n, d, h, w, c32] -> [n, d, c32, h, w] -> [N, C_pad, H, W]
    nchw = t.transpose(0, 1, 4, 2, 3).reshape(batch, d_c32 * 32, height, width)
    return np.ascontiguousarray(nchw[:, :channels])


def pack_ndhwc32(nchw: np.ndarray) -> np.ndarray:
    """Pack NCHW int8 features -> flat NDHWC32 blob (zero-padded channels)."""
    x = np.asarray(nchw, dtype=np.int8)
    batch, channels, height, width = x.shape
    d_c32 = _ceil_div(channels, 32)
    padded = np.zeros((batch, d_c32 * 32, height, width), dtype=np.int8)
    padded[:, :channels] = x
    t = padded.reshape(batch, d_c32, 32, height, width)
    return np.ascontiguousarray(t.transpose(0, 1, 3, 4, 2)).reshape(-1)


def nmhwsoib2_size(out_ch: int, in_ch: int, kh: int, kw: int) -> int:
    return _ceil_div(out_ch, 32) * _ceil_div(in_ch, 32) * kh * kw * 1024


def ndhwc32_size(batch: int, channels: int, height: int, width: int) -> int:
    return batch * _ceil_div(channels, 32) * height * width * 32
