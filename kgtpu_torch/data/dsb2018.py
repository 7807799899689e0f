"""Kaggle DSB2018 nuclei dataset reader: counterpart of
`kgtpu/data/dsb2018.py`, reading its images with `data/imread.py`.

Expects the stage1 layout:

  data_dir/
    <image_id>/
      images/<image_id>.png
      masks/<mask_uuid>.png        # one binary PNG per instance (train only)

`split` picks the same id-hash partition as kgtpu (md5 of the id, the
lowest val_fraction of 1000 buckets is "val"); "test" on a directory with
masks serves the val partition and warns, as kgtpu does.
"""

from __future__ import annotations

import hashlib
import os
import warnings

import numpy as np

from kgtpu_torch.data.imread import UnreadableImage, read_image


def bucket(iid: str, val_fraction: float = 0.1) -> str:
    h = int(hashlib.md5(iid.encode()).hexdigest(), 16) % 1000
    return "val" if h < val_fraction * 1000 else "train"


class DSB2018:
    def __init__(self, data_dir: str, split: str = "train",
                 val_fraction: float = 0.1):
        if not os.path.isdir(data_dir):
            raise FileNotFoundError(f"DSB2018 data_dir not found: {data_dir}")
        ids = sorted(
            d for d in os.listdir(data_dir)
            if os.path.isdir(os.path.join(data_dir, d, "images"))
        )
        if split in ("train", "val"):
            ids = [i for i in ids if bucket(i, val_fraction) == split]
        elif split == "test":
            # masks/ present means a training directory: serving every id
            # would evaluate the model on its own training images
            has_masks = any(
                os.path.isdir(os.path.join(data_dir, i, "masks")) for i in ids)
            if has_masks:
                warnings.warn(
                    f"DSB2018 split='test' on {data_dir}: masks/ present, so "
                    "this looks like a TRAINING directory — evaluating on the "
                    "held-out val partition instead of all ids to avoid "
                    "train-set leakage. Point --data_dir at stage1_test for "
                    "a full test run.", stacklevel=2)
                ids = [i for i in ids if bucket(i, val_fraction) == "val"]
        self.data_dir = data_dir
        self.ids = ids

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, idx: int) -> dict:
        iid = self.ids[idx]
        img_path = os.path.join(self.data_dir, iid, "images", iid + ".png")
        if not os.path.isfile(img_path):
            raise FileNotFoundError(img_path)
        img = read_image(img_path, "color")
        label = np.zeros(img.shape[:2], np.int32)
        mask_dir = os.path.join(self.data_dir, iid, "masks")
        if os.path.isdir(mask_dir):
            for k, f in enumerate(sorted(os.listdir(mask_dir))):
                try:
                    m = read_image(os.path.join(mask_dir, f), "gray")
                except UnreadableImage:       # unreadable: skipped, as in kgtpu
                    continue
                label[m > 127] = k + 1
        return {"image": img, "label_map": label, "id": iid}
