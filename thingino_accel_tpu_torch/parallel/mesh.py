"""A ('dp', 'tp') mesh of torch devices in one process, and the sharding
rules for the engine's param layout.

Port of ``thingino_accel_tpu.parallel.mesh``. JAX lays a mesh out in one
controller and lets GSPMD insert the collectives; the port keeps that
single-process call shape: a :class:`Mesh` is a dp x tp array of
``torch.device``s, and ``parallel.shard`` moves the tensors between them
itself (a copy between two cards of one host is a peer copy; a mesh that
names one card several times runs every scatter, shard and gather path on
it). ``torch.distributed`` is not used: NCCL refuses two ranks on one GPU,
so a one-card machine could only run it at world size 1.

- ``dp``: the batch dimension of activations.
- ``tp``: the output channel of conv weights and everything per-channel.
  The rule is JAX's (shard where divisible by tp, else replicate), read in
  the port's layouts: a conv weight is OHWI (JAX's HWIO axis 3 is axis 0
  here), a depthwise weight [KH, KW, C] (axis 2), a 1-D per-channel tensor
  axis 0; any other 4-D or 3-D param keeps JAX's layout and its last axis.
  The role decides which 4-D params are conv weights
  (``runtime.executor.conv_weight_names``), as ``params_from_jax``.

A sharding spec is a tuple as JAX's ``PartitionSpec``: one entry per
leading dimension, ``"dp"``, ``"tp"`` or None; ``()`` replicates.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from thingino_accel_tpu_torch.runtime.executor import resolve_device

Spec = Tuple[Optional[str], ...]


class Mesh:
    """A dp x tp array of torch devices (``devices[i, j]``), with JAX's
    ``shape`` and ``axis_names``."""

    axis_names = ("dp", "tp")

    def __init__(self, devices: np.ndarray):
        self.devices = devices

    @property
    def shape(self) -> Dict[str, int]:
        dp, tp = self.devices.shape
        return {"dp": dp, "tp": tp}


def make_mesh(dp: Optional[int] = None, tp: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ('dp', 'tp') mesh over ``devices`` (a device may repeat), by
    default every CUDA device; without a CUDA device and without
    ``devices`` it raises (no fallback to the CPU). ``dp`` defaults to
    ``len(devices) // tp``; ``dp * tp`` must equal the device count."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: torch finds no CUDA device; pass "
                               "devices=[...] to build a mesh of others")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    n = len(devices)
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp = {dp}*{tp} != {n} devices")
    arr = np.empty((dp, tp), dtype=object)
    for k, d in enumerate(devices):
        arr[k // tp, k % tp] = d
    return Mesh(arr)


def param_sharding_rules(params: Dict[str, torch.Tensor], mesh: Mesh,
                         conv_weights: Iterable[str] = ()
                         ) -> Dict[str, Spec]:
    """The spec of each param (module docstring): the tp shard axis where
    the output channel divides by tp, else ``()``. ``conv_weights``: the
    OHWI conv weights' names (``Executor.conv_weights``)."""
    tp = mesh.shape["tp"]
    conv_weights = set(conv_weights)
    out: Dict[str, Spec] = {}
    for name, arr in params.items():
        shape = tuple(arr.shape)
        spec: Spec = ()
        if tp > 1:
            if name in conv_weights:
                axis = 0 if shape[0] % tp == 0 else None
            elif len(shape) in (1, 3, 4) and shape[-1] % tp == 0:
                axis = len(shape) - 1
            else:
                axis = None
            if axis is not None:
                spec = tuple("tp" if d == axis else None
                             for d in range(len(shape)))
        out[name] = spec
    return out


def spec_axis(spec: Spec, axis_name: str) -> Optional[int]:
    """The dimension that ``spec`` splits over ``axis_name``, or None."""
    return spec.index(axis_name) if axis_name in spec else None


def place(x: torch.Tensor, spec: Spec, mesh: Mesh
          ) -> List[List[torch.Tensor]]:
    """``x`` laid out on the mesh: ``[i][j]`` is the piece of device
    ``(i, j)`` (split over dp and tp where ``spec`` says, whole
    elsewhere), contiguous. Raises where a split does not divide."""
    dp, tp = mesh.devices.shape
    x = torch.as_tensor(x)
    rows = []
    for i in range(dp):
        row = []
        for j in range(tp):
            piece = x
            for d, name in enumerate(spec):
                if name is None:
                    continue
                n, k = (dp, i) if name == "dp" else (tp, j)
                if piece.shape[d] % n:
                    raise ValueError(f"dimension {d} of {tuple(x.shape)} "
                                     f"does not split over {name}={n}")
                size = piece.shape[d] // n
                piece = piece.narrow(d, k * size, size)
            row.append(piece.to(mesh.devices[i, j]).contiguous())
        rows.append(row)
    return rows


def shard_params(params: Dict[str, torch.Tensor], mesh: Mesh,
                 conv_weights: Iterable[str] = ()
                 ) -> Dict[str, List[List[torch.Tensor]]]:
    """Each param placed on the mesh by its rule (:func:`place`):
    ``[i][j]`` its tp shard ``j`` (or the whole param) on device
    ``(i, j)``; dp rows hold copies."""
    rules = param_sharding_rules(params, mesh, conv_weights)
    return {k: place(v, rules[k], mesh) for k, v in params.items()}


def batch_sharding(mesh: Mesh) -> Spec:
    """NHWC activations: batch over 'dp', replicated over 'tp'."""
    return ("dp",)
