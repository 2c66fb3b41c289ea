"""Seeded NMS inputs that exercise the suppression fixpoint.

:func:`seeded_sets` gives, for a pool depth K, batches of candidates
(numpy boxes xywh [B, N, 4] f32, scores [B, N] f32, classes [B, N] int32)
that ``models.yolo.nms_batched`` (``conf_thresh`` 0.25, ``iou_thresh``
0.45, ``pre_nms`` K) turns into the relations the fixpoint has to get
right: the tests hold the port's NMS against JAX's on them, and
``chip_smoke.py`` the NMS kernel against its plain version.

- ``random``: 2K boxes of 3 classes scattered over 160 pixels, so that
  many overlap;
- ``chain``: K boxes of one class in a row, each overlapping only its
  neighbours (IoU 0.54; two apart 0.25), scores falling along it: a
  suppression chain of depth K, which needs K steps;
- ``empty``: K boxes of zero size scored below the threshold: no
  detection and no overlap;
- ``staggered``: frame f holds a chain of depth 1 + f (K - 1) / (B - 1)
  and isolated boxes after it, so the frames reach their fixpoints at
  different steps.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

Set = Tuple[np.ndarray, np.ndarray, np.ndarray]
NAMES = ("random", "chain", "empty", "staggered")


def _chain(k: int, depth: int) -> Set:
    """``depth`` chained 20x20 boxes 6 pixels apart, then ``k - depth``
    isolated ones, scores falling from 0.99 over all ``k``, one class."""
    i = np.arange(k, dtype=np.float32)
    x = np.where(i < depth, 20 + 6 * i, 2000 + 100 * i).astype(np.float32)
    boxes = np.stack([x, np.full(k, 50, np.float32),
                      np.full(k, 20, np.float32),
                      np.full(k, 20, np.float32)], -1)
    scores = (0.99 - i * np.float32(0.5 / k)).astype(np.float32)
    return boxes, scores, np.zeros(k, np.int32)


def seeded_sets(k: int, batch: int = 16, seed: int = 0) -> Dict[str, Set]:
    """The sets of the module docstring for pool depth ``k``, each
    ``batch`` frames, from ``seed``."""
    rng = np.random.default_rng(seed)
    n = 2 * k
    wh = rng.uniform(10, 60, (batch, n, 2))
    xy = rng.uniform(0, 160, (batch, n, 2))
    sets = {"random": (
        np.concatenate([xy, wh], -1).astype(np.float32),
        rng.uniform(0, 1, (batch, n)).astype(np.float32),
        rng.integers(0, 3, (batch, n)).astype(np.int32))}
    sets["chain"] = tuple(np.stack([a] * batch) for a in _chain(k, k))
    sets["empty"] = (
        np.concatenate([rng.uniform(0, 160, (batch, k, 2)),
                        np.zeros((batch, k, 2))], -1).astype(np.float32),
        rng.uniform(0, 0.2, (batch, k)).astype(np.float32),
        np.zeros((batch, k), np.int32))
    frames = [_chain(k, 1 + f * (k - 1) // max(batch - 1, 1))
              for f in range(batch)]
    sets["staggered"] = tuple(np.stack(a) for a in zip(*frames))
    return sets
