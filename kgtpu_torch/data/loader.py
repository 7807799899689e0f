"""One sample for inference: counterpart of
`kgtpu/data/loader.py::_prepare_sample` without augmentation.  The
augmenting path and the batch iterator are ROADMAP item 4."""

from __future__ import annotations

import numpy as np

from kgtpu_torch.config import DataConfig
from kgtpu_torch.data import transforms


def prepare_sample(sample: dict, cfg: DataConfig, augment: bool = False,
                   image_only: bool = True) -> dict:
    """The sample resized to cfg.input_size² (`transforms.resize_sample`):
    {"image" uint8 [S, S, 3], "img_gain" ones(3), "img_bias" zeros(3),
    "label_map"}; with image_only=False also the slot contract ("boxes",
    "valid" and the renumbered label map)."""
    if augment:
        raise NotImplementedError(
            "the augmenting loader is not ported yet (ROADMAP item 4)")
    s = transforms.resize_sample(sample, cfg.input_size)
    out = {"image": np.ascontiguousarray(s["image"]),
           "img_gain": np.ones(3, np.float32), "img_bias": np.zeros(3, np.float32),
           "label_map": s["label_map"]}
    if not image_only:
        boxes, valid, remap = transforms.boxes_from_label_map(
            s["label_map"], cfg.max_instances)
        out.update(boxes=boxes, valid=valid,
                   label_map=transforms.renumber_label_map(s["label_map"], remap))
    return out
