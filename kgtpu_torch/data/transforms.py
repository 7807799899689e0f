"""Label map -> the train batch's instance contract: counterpart of the NumPy
paths of `kgtpu/data/transforms.py::boxes_from_label_map` and
`renumber_label_map` (no native op, no cv2)."""

from __future__ import annotations

import numpy as np


def boxes_from_label_map(label: np.ndarray, max_instances: int
                         ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Boxes (x0, y0, x1, y1) per instance id, area-ranked, padded to N.

    Returns (boxes [N, 4] f32, valid [N] f32, remap [N] int32): remap[i] is
    the original id of slot i (0 for padding).  Instances of fewer than 4
    pixels are dropped; the biggest survive truncation, ties by ascending id.
    """
    n = max_instances
    ids = np.unique(label)
    ids = ids[ids > 0]
    rows = []
    for i in ids:
        ys, xs = np.nonzero(label == i)
        if len(xs) < 4:               # clipped-away slivers
            continue
        rows.append((float(len(xs)), i, float(xs.min()), float(ys.min()),
                     float(xs.max() + 1), float(ys.max() + 1)))
    rows.sort(key=lambda r: (-r[0], r[1]))
    rows = rows[:n]

    boxes = np.zeros((n, 4), np.float32)
    valid = np.zeros((n,), np.float32)
    remap = np.zeros((n,), np.int32)
    for slot, (_, i, x0, y0, x1, y1) in enumerate(rows):
        boxes[slot] = (x0, y0, x1, y1)
        valid[slot] = 1.0
        remap[slot] = i
    return boxes, valid, remap


def renumber_label_map(label: np.ndarray, remap: np.ndarray) -> np.ndarray:
    """Renumber label ids so that slot i's instance has id i + 1 (0 stays
    background; ids of dropped instances become 0)."""
    out = np.zeros_like(label)
    for slot, orig in enumerate(remap):
        if orig > 0:
            out[label == orig] = slot + 1
    return out
