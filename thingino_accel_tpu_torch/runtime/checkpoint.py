"""Checkpoint and restore of params and training state.

Port of ``thingino_accel_tpu.runtime.checkpoint`` on its npz format
(JAX's fallback where orbax is absent, as on the card): ``<path>.npz``
holds the leaves and ``<path>.meta.json`` holds ``{"step", "backend":
"npz", "extra"}``. A leaf's key is its path through the nesting, dict
keys and list indices joined by ``/`` (``{"conv": {"w": ...}}`` ->
``"conv/w"``). Either package reads the other's files: a params dict saved
here loads in JAX's ``checkpoint.load`` and the reverse. The port's conv
weights are OHWI and JAX's HWIO, so a params dict crosses with
``runtime.executor.params_to_jax`` / ``params_from_jax``.

Leaves are tensors (saved from the CPU), numpy arrays and Python
scalars; None is no leaf, as in a JAX pytree. A ``torch.optim``
optimizer's state is its ``state_dict()``: its tensors go into the npz,
and :func:`load` restores its structure from ``like``, as JAX restores
optax's state from ``opt.init(params)``. A fresh torch optimizer holds no
state until its first step; :func:`optimizer_like` gives it its full
structure first.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch


def _leaves(tree: Any, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) of every leaf of ``tree`` in order: dicts by their
    keys, lists and tuples by index; None holds no leaf."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (str(i),))
    elif tree is not None:
        yield prefix, tree


def _array(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    return {"/".join(p): _array(v) for p, v in _leaves(tree)}


def save(path: str, params: Any, extra: Optional[Dict[str, Any]] = None,
         step: int = 0) -> None:
    """Save a nested params (or training state) tree and JSON-serializable
    ``extra`` to ``<path>.npz`` and ``<path>.meta.json``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path + ".npz", **_flatten(params))
    meta = {"step": step, "backend": "npz", "extra": extra or {}}
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f)


def _restore(like: Any, flat: Dict[str, np.ndarray],
             prefix: Tuple[str, ...] = ()) -> Any:
    """``like``'s structure with each leaf read from ``flat``: a tensor in
    ``like``'s dtype, on its device, with its ``requires_grad``; a numpy
    array as an array; a Python scalar in its type."""
    if isinstance(like, dict):
        return {k: _restore(v, flat, prefix + (str(k),))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        out = [_restore(v, flat, prefix + (str(i),))
               for i, v in enumerate(like)]
        return out if isinstance(like, list) else tuple(out)
    if like is None:
        return None
    a = flat["/".join(prefix)]
    if isinstance(like, torch.Tensor):
        t = torch.from_numpy(np.array(a)).to(like.device, like.dtype)
        return t.requires_grad_(like.requires_grad) \
            if t.is_floating_point() else t
    if isinstance(like, (bool, int, float, str)):
        return type(like)(a.item())
    return a


def load(path: str, like: Optional[Any] = None
         ) -> Tuple[Any, Dict[str, Any]]:
    """Load a checkpoint saved by :func:`save` (or by JAX's ``save`` on its
    npz branch). ``like`` (a tree of the same structure) restores the
    nesting and the leaves' types; without it a flat dict of numpy arrays
    is returned. An orbax checkpoint raises ``ValueError``: the port has
    no orbax."""
    with open(path + ".meta.json") as f:
        meta = json.load(f)
    if meta["backend"] != "npz":
        raise ValueError(f"{path}: a checkpoint of backend "
                         f"{meta['backend']!r}; the port reads only 'npz' "
                         "(save it from JAX without orbax)")
    with np.load(path + ".npz") as data:
        flat = {k: data[k] for k in data.files}
    if like is None:
        return flat, meta
    return _restore(like, flat), meta


def optimizer_like(optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """``optimizer.state_dict()`` with every per-param state present: a
    fresh ``torch.optim`` optimizer makes its state at its first step, so
    one step is taken here on zero gradients, and the params and their
    gradients are put back as they were. The returned structure is the
    ``like`` that :func:`load` needs; the values in the optimizer are
    those of that step until ``load_state_dict`` replaces them."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    if all(p in optimizer.state and optimizer.state[p] for p in params):
        return optimizer.state_dict()
    saved = [(p.detach().clone(), p.grad) for p in params]
    for p in params:
        p.grad = torch.zeros_like(p)
    optimizer.step()
    with torch.no_grad():
        for p, (v, g) in zip(params, saved):
            p.copy_(v)
            p.grad = g
    return optimizer.state_dict()
