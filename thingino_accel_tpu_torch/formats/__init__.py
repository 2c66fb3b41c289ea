"""Model interchange formats, copied from the JAX package (numpy only):

- ``mars``: the `.mars` binary graph format (reader + writer);
- ``packing``: the NNA packed-layout codecs it uses;
- ``onnx_proto`` / ``onnx_writer``: the hand-rolled ONNX protobuf reader
  and writer;
- ``onnx``: ONNX -> IR import, float32 and QDQ int8;
- ``mars_export`` / ``onnx_export``: IR -> `.mars` and IR -> float32
  ONNX;
- ``mgk`` / ``mgk_yolo``: the OEM `.mgk` decompiler (ELF parsing,
  `.rodata` mining, weight extraction, AEC and YOLO ONNX export);
- ``jzdl``: the OEM IVS `.so` decompiler (the JZDL person detector's
  structure and weight blobs, mined from the ELF's symbols).
"""

from thingino_accel_tpu_torch.formats.mars import (
    MarsModel,
    MarsTensor,
    MarsLayer,
    read_mars,
    write_mars,
    DType,
    Format,
    LayerType,
    Activation,
    Padding,
)
from thingino_accel_tpu_torch.formats.packing import (
    pack_nmhwsoib2,
    unpack_nmhwsoib2,
    pack_ndhwc32,
    unpack_ndhwc32,
)

__all__ = [
    "MarsModel", "MarsTensor", "MarsLayer", "read_mars", "write_mars",
    "DType", "Format", "LayerType", "Activation", "Padding",
    "pack_nmhwsoib2", "unpack_nmhwsoib2", "pack_ndhwc32", "unpack_ndhwc32",
]
