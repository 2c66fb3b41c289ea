"""C-API-shaped shim over the port's engine.

Port of ``thingino_accel_tpu.api``. Preserves the call shapes of the
reference's public C headers so code written against them ports
line-for-line:

- ``nna_init / nna_deinit / nna_get_hw_info`` (``include/nna.h:26-80``)
- ``nna_model_load / get_input / get_output / run / unload``
  (``include/nna_model.h:45-116``)
- ``mars_load_file / mars_get_input / mars_run / mars_get_output /
  mars_free / mars_print_summary`` (``include/mars_runtime.h:79-138``)
- the AIP pipes ``aip_*`` (``include/aip.h:118-135``) over ``ops.image``.

The device bring-up collapses to binding a torch device and the memory
map/DMA layers do not exist (SURVEY §3.1): ``nna_init`` binds the card
(``"cuda"``; ``device="cpu"`` binds the CPU, where the kernels' plain
versions run) and reports ``NNA_ERROR`` without one; models load on the
bound device (the card when nothing is bound). Tensors are numpy views the
caller fills, like ``tensor->vaddr`` in the reference examples. Error codes
and messages are JAX's; a load that finds no device returns
``MARS_ERR_NNA_INIT_FAILED``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

__all__ = [
    "nna_init", "nna_deinit", "nna_get_hw_info", "nna_lock", "nna_unlock",
    "nna_model_load", "nna_model_unload", "nna_model_run",
    "nna_model_get_info", "nna_model_get_input", "nna_model_get_output",
    "nna_model_get_input_by_name", "nna_model_get_output_by_name",
    "mars_load_file", "mars_load_memory", "mars_free", "mars_run",
    "mars_get_input", "mars_get_output", "mars_get_num_inputs",
    "mars_get_num_outputs", "mars_print_summary", "mars_get_error_string",
    "NNA_SUCCESS", "MARS_OK",
]

NNA_SUCCESS = 0
NNA_ERROR = -1

# mars_error_t (include/mars_runtime.h:19-30)
MARS_OK = 0
MARS_ERR_INVALID_MAGIC = -1
MARS_ERR_VERSION_MISMATCH = -2
MARS_ERR_ALLOC_FAILED = -3
MARS_ERR_INVALID_FILE = -4
MARS_ERR_NNA_INIT_FAILED = -5
MARS_ERR_LAYER_FAILED = -6
MARS_ERR_INVALID_TENSOR = -7
MARS_ERR_INVALID_LAYER = -8

_ERROR_STRINGS = {
    MARS_OK: "OK",
    MARS_ERR_INVALID_MAGIC: "Invalid magic number",
    MARS_ERR_VERSION_MISMATCH: "Version mismatch",
    MARS_ERR_ALLOC_FAILED: "Memory allocation failed",
    MARS_ERR_INVALID_FILE: "Invalid file format",
    MARS_ERR_NNA_INIT_FAILED: "NNA initialization failed",
    MARS_ERR_LAYER_FAILED: "Layer execution failed",
    MARS_ERR_INVALID_TENSOR: "Invalid tensor",
    MARS_ERR_INVALID_LAYER: "Invalid layer",
}

_device: Optional[torch.device] = None


@dataclasses.dataclass
class HwInfo:
    """nna_hw_info_t analog: the device facts that replace ORAM/DDR
    geometry."""

    device_kind: str = ""
    num_devices: int = 0
    platform: str = ""
    memory_stats: Optional[dict] = None


def _bound(device=None) -> torch.device:
    """The device a call runs on: ``device`` if given, else the one
    ``nna_init`` bound, else the card (which raises without one)."""
    from thingino_accel_tpu_torch.runtime.executor import resolve_device
    return resolve_device(device if device is not None
                          else _device if _device is not None else "cuda")


def nna_init(device: Union[torch.device, str, None] = None) -> int:
    """Bind the accelerator (``nna_init``, ``src/device.c:133``: the whole
    mmap/ioctl bring-up collapses to one device query): the card unless
    ``device`` names another; ``NNA_ERROR`` if it is not there."""
    global _device
    try:
        _device = _bound(device if device is not None else "cuda")
        return NNA_SUCCESS
    except RuntimeError:
        return NNA_ERROR


def nna_deinit() -> int:
    global _device
    _device = None
    return NNA_SUCCESS


def nna_get_hw_info() -> HwInfo:
    """The bound device (the card when nothing is bound): its name, the
    count of its kind, ``platform`` ``"gpu"`` or ``"cpu"`` and, on the
    card, ``torch.cuda.mem_get_info`` as ``{"bytes_free", "bytes_limit"}``."""
    d = _bound()
    if d.type != "cuda":
        return HwInfo(device_kind="cpu", num_devices=1, platform="cpu")
    free, total = torch.cuda.mem_get_info(d)
    return HwInfo(device_kind=torch.cuda.get_device_name(d),
                  num_devices=torch.cuda.device_count(), platform="gpu",
                  memory_stats={"bytes_free": int(free),
                                "bytes_limit": int(total)})


def nna_lock(timeout_ms: int = -1) -> int:
    """Multi-process device locking is a TODO stub in the reference
    (``src/device.c:435-443``); here the runtime owns the device."""
    return NNA_SUCCESS


def nna_unlock() -> int:
    return NNA_SUCCESS


# ---------------------------------------------------------------------------
# Tensors (nna_tensor_t analog: include/nna_tensor.h)
# ---------------------------------------------------------------------------


class Tensor:
    """Caller-visible tensor: ``.data`` is the numpy buffer (vaddr analog),
    ``.shape``/``.dtype``/``.scale`` mirror the descriptor fields."""

    def __init__(self, name: str, shape, dtype, scale: float = 1.0,
                 zero_point: int = 0):
        self.name = name
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.scale = scale
        self.zero_point = zero_point
        self.data = np.zeros(self.shape, self.dtype)

    def set_data(self, arr) -> None:
        a = np.asarray(arr, self.dtype)
        if a.shape != self.shape:
            raise ValueError(f"shape {a.shape} != tensor shape {self.shape}")
        self.data = a


class Model:
    """nna_model_t / mars_model_t analog wrapping an Engine."""

    def __init__(self, engine):
        self.engine = engine
        g = engine.graph
        self.inputs = [
            Tensor(n, g.tensors[n].shape, g.tensors[n].dtype,
                   g.tensors[n].quant.scale, g.tensors[n].quant.zero_point)
            for n in g.inputs]
        self.outputs = [
            Tensor(n, g.tensors[n].shape, g.tensors[n].dtype,
                   g.tensors[n].quant.scale, g.tensors[n].quant.zero_point)
            for n in g.outputs]
        self._by_name = {t.name: t for t in self.inputs + self.outputs}

    def run(self) -> int:
        feed = {t.name: t.data for t in self.inputs}
        try:
            out = self.engine.run_np(**feed)
        except Exception:
            return MARS_ERR_LAYER_FAILED
        for t in self.outputs:
            got = out[t.name]
            t.data = got.reshape(t.shape) if got.size == int(
                np.prod(t.shape)) else got
        return MARS_OK


@dataclasses.dataclass
class ModelInfo:
    """nna_model_info_t analog (include/nna_model.h:30-36)."""

    name: str
    num_inputs: int
    num_outputs: int
    num_layers: int


# -- .mars path (mars_runtime.h) --------------------------------------------


def mars_load_file(path: str, options=None):
    """Returns (error_code, Model|None) — mars_load_file shape; the model
    on the bound device."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return MARS_ERR_INVALID_FILE, None
    return mars_load_memory(data, options)


def mars_load_memory(data: bytes, options=None):
    from thingino_accel_tpu_torch.formats import mars as M
    from thingino_accel_tpu_torch.runtime.engine import Engine
    try:
        mm = M.read_mars(data)
    except ValueError as e:
        if "magic" in str(e):
            return MARS_ERR_INVALID_MAGIC, None
        if "version" in str(e):
            return MARS_ERR_VERSION_MISMATCH, None
        return MARS_ERR_INVALID_FILE, None
    try:
        dev = _bound()
    except RuntimeError:
        return MARS_ERR_NNA_INIT_FAILED, None
    try:
        eng = Engine.from_mars(mm, options, device=dev)
    except Exception:
        return MARS_ERR_INVALID_FILE, None
    return MARS_OK, Model(eng)


def mars_free(model: Optional[Model]) -> None:
    pass  # GC-managed; kept for call-shape parity


def mars_run(model: Model) -> int:
    if model is None:
        return MARS_ERR_INVALID_FILE
    return model.run()


def mars_get_input(model: Model, index: int) -> Optional[Tensor]:
    if model is None or not 0 <= index < len(model.inputs):
        return None
    return model.inputs[index]


def mars_get_output(model: Model, index: int) -> Optional[Tensor]:
    if model is None or not 0 <= index < len(model.outputs):
        return None
    return model.outputs[index]


def mars_get_num_inputs(model: Model) -> int:
    return len(model.inputs) if model else 0


def mars_get_num_outputs(model: Model) -> int:
    return len(model.outputs) if model else 0


def mars_print_summary(model: Model) -> None:
    if model:
        print(model.engine.summary())


def mars_get_error_string(err: int) -> str:
    return _ERROR_STRINGS.get(err, "Unknown error")


# -- generic model path (nna_model.h) ---------------------------------------


_last_load_error: list = [NNA_SUCCESS, ""]


def nna_get_load_error() -> Tuple[int, str]:
    """(code, message) of the last :func:`nna_model_load` failure —
    the structured-error channel a C caller reads instead of an
    exception (``nna_strerror`` role, ``include/nna_model.h``)."""
    return _last_load_error[0], _last_load_error[1]


def nna_model_load(path: str, options=None) -> Optional[Model]:
    """Loads any supported model container (`.mars`; `.mgk` via the
    offline importer for recognized families — ``nna_model_load``,
    ``include/nna_model.h:45``), on the bound device. Returns None on
    failure with the cause retrievable via :func:`nna_get_load_error` (an
    unsupported `.mgk` family is a structured error, not a raise). A
    `.mgk` model runs in the engine's default tier, the exact one, as in
    JAX."""
    _last_load_error[:] = [NNA_SUCCESS, ""]
    if path.endswith(".mgk"):
        from thingino_accel_tpu_torch.formats import mgk
        from thingino_accel_tpu_torch.formats.mgk_yolo import (
            UnsupportedMgkError,
        )
        from thingino_accel_tpu_torch.runtime.engine import Engine
        try:
            graph = mgk.import_mgk(path)
        except UnsupportedMgkError as e:
            _last_load_error[:] = [
                MARS_ERR_INVALID_FILE,
                f"unsupported .mgk family (kinds: {e.kinds})"]
            return None
        except (ValueError, OSError) as e:
            _last_load_error[:] = [MARS_ERR_INVALID_FILE, str(e)]
            return None
        try:
            dev = _bound()
        except RuntimeError as e:
            _last_load_error[:] = [MARS_ERR_NNA_INIT_FAILED, str(e)]
            return None
        return Model(Engine(graph, device=dev))
    err, model = mars_load_file(path, options)
    if err != MARS_OK:
        _last_load_error[:] = [err, mars_get_error_string(err)]
        return None
    return model


def nna_model_unload(model: Optional[Model]) -> None:
    pass


def nna_model_run(model: Optional[Model]) -> int:
    if model is None:
        return -1
    return 0 if model.run() == MARS_OK else -1


def nna_model_get_info(model: Model) -> Optional[ModelInfo]:
    if model is None:
        return None
    return ModelInfo(
        name=model.engine.graph.name,
        num_inputs=len(model.inputs),
        num_outputs=len(model.outputs),
        num_layers=len(model.engine.graph.nodes))


def nna_model_get_input(model: Model, index: int = 0) -> Optional[Tensor]:
    return mars_get_input(model, index)


def nna_model_get_output(model: Model, index: int = 0) -> Optional[Tensor]:
    return mars_get_output(model, index)


def nna_model_get_input_by_name(model: Model, name: str) -> Optional[Tensor]:
    # search the list, not _by_name: a same-named output would shadow
    # the input in the shared dict
    for t in model.inputs:
        if t.name == name:
            return t
    return None


def nna_model_get_output_by_name(model: Model, name: str) -> Optional[Tensor]:
    for t in model.outputs:
        if t.name == name:
            return t
    return None


# ---------------------------------------------------------------------------
# BaseNet facade (the magik::venus::BaseNet C++ entry style,
# src/venus/basenet.cpp:20-60 — older OEM API shape)
# ---------------------------------------------------------------------------


class BaseNet:
    """Object-style facade over the same engine: load_model / run /
    get_input / get_output, mirroring the Venus BaseNet call sequence."""

    def __init__(self) -> None:
        self._model: Optional[Model] = None

    def load_model(self, path: str) -> int:
        self._model = nna_model_load(path)
        return 0 if self._model is not None else -1

    def get_input(self, index: int = 0) -> Optional[Tensor]:
        return nna_model_get_input(self._model, index)

    def get_input_by_name(self, name: str) -> Optional[Tensor]:
        return nna_model_get_input_by_name(self._model, name)

    def get_output(self, index: int = 0) -> Optional[Tensor]:
        return nna_model_get_output(self._model, index)

    def run(self) -> int:
        if self._model is None:
            return -1
        return nna_model_run(self._model)

    def get_forward_memory_size(self) -> int:
        """Bytes of the graph's tensors at their declared shapes (JAX's
        count; the reference binds this query explicitly to its base impl
        to dodge broken vtables, model_loader.cpp:577-599)."""
        if self._model is None:
            return 0
        eng = self._model.engine
        total = sum(int(np.prod(t.shape)) * np.dtype(t.dtype).itemsize
                    for t in eng.graph.tensors.values())
        return total


# ---------------------------------------------------------------------------
# AIP shims (include/aip.h:118-135 — the T41's fixed-function image
# pipes). Here they are torch ops on the image's device (ops/image.py); the
# shims preserve the reference's call shapes with tensors instead of
# physical addresses. aip_init/aip_cleanup/aip_f_wait are no-ops: there is
# no register programming. A numpy image goes to the bound device.
# ---------------------------------------------------------------------------


class AipContext:
    """Stands in for ``aip_ctx_t`` — carries nothing here."""


def aip_init() -> AipContext:
    return AipContext()


def aip_cleanup(ctx: AipContext) -> None:
    del ctx


def aip_f_wait(ctx: AipContext) -> int:
    """0: the results are ready. On the card the device is synchronized
    (the reference waits for the pipe's IRQ)."""
    if _device is not None and _device.type == "cuda":
        torch.cuda.synchronize(_device)
    return 0


def _on_device(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x)).to(_bound())


def aip_resize(ctx: AipContext, img, out_h: int, out_w: int):
    """AIP-T: bilinear resize ([B,H,W,C], dtype-preserving)."""
    from thingino_accel_tpu_torch.ops import image as I
    return I.resize_bilinear(_on_device(img), (out_h, out_w))


def aip_perspective(ctx: AipContext, img, matrix, out_h: int, out_w: int,
                    fill: float = 0.0):
    """AIP-P: homography warp (``matrix`` maps dst px -> src px)."""
    from thingino_accel_tpu_torch.ops import image as I
    return I.warp_perspective(_on_device(img), matrix, (out_h, out_w), fill)


def aip_conv2d(ctx: AipContext, x, w, bias=None, stride: int = 1,
               pad: int = 0):
    """AIP-F: one f32 convolution (``aip_conv2d``'s tensor-level shape;
    the reference passes physical addresses + dims): NHWC ``x``, HWIO
    ``w``, through ``ops.reference.conv2d_f32``."""
    from thingino_accel_tpu_torch.ops import reference as R
    x = _on_device(x).to(torch.float32)
    w = torch.as_tensor(w).to(x.device, torch.float32)
    kh, kw = int(w.shape[0]), int(w.shape[1])
    n, h, wd, _ = x.shape
    oh = (h + 2 * pad - kh) // stride + 1
    ow = (wd + 2 * pad - kw) // stride + 1
    b = None if bias is None else torch.as_tensor(bias).to(x.device,
                                                          torch.float32)
    return R.conv2d_f32(x, w.permute(3, 0, 1, 2).contiguous(), b, (oh, ow),
                        (stride, stride), (1, 1), ((pad, pad), (pad, pad)),
                        relu=False)
