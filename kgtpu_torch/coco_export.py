"""COCO-format prediction export: the port's copy of `kgtpu/coco_export.py`.

The reference family's results are typically consumed as COCO "results"
JSON (one record per detected instance: image_id, category_id, bbox
[x, y, w, h], score, segmentation).  This module converts this framework's
per-image outputs (instance label map + slot-aligned boxes/scores) into
that format so downstream COCO tooling (pycocotools, FiftyOne, CVAT
importers) can consume predictions directly.

Segmentations use COCO's UNCOMPRESSED RLE ({"size": [H, W], "counts":
[...]}, column-major runs starting with the zero-run) — pycocotools is not
available offline here, and uncompressed RLE is valid input to
`pycocotools.mask.frPyObjects` wherever it is available.
"""

from __future__ import annotations

import json

import numpy as np


def mask_to_rle(mask: np.ndarray) -> dict:
    """Binary mask [H, W] → COCO uncompressed RLE (column-major)."""
    h, w = mask.shape
    flat = np.asarray(mask, dtype=bool).reshape(-1, order="F")
    # runs alternate 0s/1s and must start with the count of 0s (possibly 0)
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    bounds = np.concatenate([[0], change, [flat.size]])
    counts = np.diff(bounds).tolist()
    if flat.size and flat[0]:
        counts = [0] + counts
    if not flat.size:
        counts = [0]
    return {"size": [int(h), int(w)], "counts": counts}


def rle_to_mask(rle: dict) -> np.ndarray:
    """Inverse of `mask_to_rle` (for tests / local consumers)."""
    h, w = rle["size"]
    flat = np.zeros(h * w, dtype=bool)
    pos = 0
    val = False
    for c in rle["counts"]:
        flat[pos:pos + c] = val
        pos += c
        val = not val
    return flat.reshape((h, w), order="F")


def coco_results_for_image(image_id, label_map: np.ndarray,
                           boxes: np.ndarray, scores: np.ndarray,
                           category_id: int = 1) -> list[dict]:
    """One image's predictions → list of COCO result records.

    Args:
      image_id: int or str id used in the COCO images table.
      label_map: [H, W] int, 0 = background, i = instance with
        boxes[i-1] / scores[i-1] (slot-aligned, as written by test.py).
      boxes: [D, 4] (x0, y0, x1, y1) pixel coords.
      scores: [D].
    """
    out = []
    for lab in np.unique(label_map):
        if lab <= 0:
            continue
        i = int(lab) - 1
        if i >= len(scores):
            continue
        x0, y0, x1, y1 = (float(v) for v in boxes[i])
        out.append({
            "image_id": image_id,
            "category_id": int(category_id),
            "bbox": [round(x0, 2), round(y0, 2),
                     round(x1 - x0, 2), round(y1 - y0, 2)],
            "score": round(float(scores[i]), 5),
            "segmentation": mask_to_rle(label_map == lab),
        })
    return out


def write_coco_json(path: str, per_image: list[dict]) -> int:
    """per_image: [{"id", "label_map", "boxes", "scores"}] → COCO results
    JSON at `path`.  Returns the number of instance records written."""
    results = []
    for rec in per_image:
        results.extend(coco_results_for_image(
            rec["id"], rec["label_map"], rec["boxes"], rec["scores"]))
    with open(path, "w") as f:
        json.dump(results, f)
    return len(results)
