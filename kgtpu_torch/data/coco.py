"""COCO-format instance-segmentation dataset reader: counterpart of
`kgtpu/data/coco.py`, with `data/imread.py` for the images, `draw.fill_poly`
for cv2.fillPoly and `transforms.resize_nearest` for cv2.resize(INTER_NEAREST).

`--dataset coco --data_dir <root>`.  Layout (probed in order):

  root/annotations/instances_<split>.json   # per-split files, or
  root/annotations.json                     # one file, hash-split like the
                                            # other readers

Image files resolve as `root/<file_name>`, then `root/images/<file_name>`,
then `root/<split>/<file_name>`, then `root/<stem of instances_*.json>/`.

`segmentation` encodings (all three COCO forms):
  * polygons      - list of flat [x0,y0,x1,y1,...] rings, rounded half to
                    even and filled together (`draw.fill_poly`)
  * uncompressed  - {"counts": [ints], "size": [h, w]}, column-major runs
  * compressed    - {"counts": "<str>", "size": [h, w]}, pycocotools'
                    LEB128-style codec
An RLE whose size differs from the image is resized to it, nearest.

`iscrowd=1` regions are skipped.  Instances paint into the label map in
descending area order, so small instances stay on top of larger ones they
overlap.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

from kgtpu_torch.data.draw import fill_poly
from kgtpu_torch.data.imread import read_image
from kgtpu_torch.data.transforms import resize_nearest


def rle_counts_from_string(s: str) -> list[int]:
    """Decode the COCO compressed-RLE counts string.

    Each count is a variable-length little-endian base-32 integer in
    printable chars (c-48), 5 payload bits per char, bit 0x20 = continuation,
    bit 0x10 of the final char = sign extension; counts beyond the second are
    delta-coded against the count two positions back."""
    counts: list[int] = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        while True:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            i += 1
            k += 1
            if not c & 0x20:
                if c & 0x10:
                    x |= -1 << (5 * k)
                break
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def mask_from_rle(counts: list[int], h: int, w: int) -> np.ndarray:
    """Column-major alternating runs (background first) → bool [h, w]."""
    total = int(np.sum(counts))
    if total != h * w:
        raise ValueError(f"RLE runs sum to {total}, expected {h * w}")
    vals = np.zeros(len(counts), np.uint8)
    vals[1::2] = 1
    flat = np.repeat(vals, counts)
    return flat.reshape((h, w), order="F").astype(bool)


def _ann_mask(ann: dict, h: int, w: int) -> np.ndarray | None:
    seg = ann.get("segmentation")
    if not seg:
        return None
    if isinstance(seg, dict):
        counts = seg["counts"]
        if isinstance(counts, str):
            counts = rle_counts_from_string(counts)
        sh, sw = seg["size"]
        m = mask_from_rle([int(c) for c in counts], int(sh), int(sw))
        if (sh, sw) != (h, w):   # tolerate size mismatch by nearest resize
            m = resize_nearest(m.astype(np.uint8), (w, h)).astype(bool)
        return m
    m = np.zeros((h, w), np.uint8)
    polys = [np.asarray(p, np.float64).reshape(-1, 2).round().astype(np.int32)
             for p in seg if len(p) >= 6]
    if not polys:
        return None
    fill_poly(m, polys, 1)
    return m.astype(bool)


class CocoDataset:
    def __init__(self, data_dir: str, split: str = "train",
                 val_fraction: float = 0.1):
        if not os.path.isdir(data_dir):
            raise FileNotFoundError(f"COCO data_dir not found: {data_dir}")
        self.data_dir = data_dir
        self.split = split
        ann_path, self._hash_split = self._find_annotations(data_dir, split)
        self._ann_path = ann_path
        with open(ann_path) as f:
            doc = json.load(f)
        self._images = {im["id"]: im for im in doc.get("images", [])}
        self._anns: dict[int, list[dict]] = {i: [] for i in self._images}
        for a in doc.get("annotations", []):
            if a.get("iscrowd", 0):
                continue
            if a["image_id"] in self._anns:
                self._anns[a["image_id"]].append(a)

        ids = sorted(self._images)

        def bucket(img_id) -> str:
            key = str(self._images[img_id].get("file_name", img_id))
            hsh = int(hashlib.md5(key.encode()).hexdigest(), 16) % 1000
            return "val" if hsh < val_fraction * 1000 else "train"

        if self._hash_split:
            if split in ("train", "val"):
                ids = [i for i in ids if bucket(i) == split]
            elif split == "test":
                # same train-leak guard as the DSB2018 reader: a single
                # annotated JSON means these are TRAINING images — evaluate
                # on the held-out val partition, never on the train set
                if any(self._anns[i] for i in ids):
                    import warnings
                    warnings.warn(
                        f"COCO split='test' on {ann_path}: annotations "
                        "present, so this is a training file — using the "
                        "held-out val partition to avoid train-set leakage. "
                        "Provide annotations/instances_test.json for a full "
                        "test run.", stacklevel=2)
                    ids = [i for i in ids if bucket(i) == "val"]
        self.ids = ids

    @staticmethod
    def _find_annotations(data_dir: str, split: str) -> tuple[str, bool]:
        """(json path, whether to hash-split a shared file).

        A LONE annotation file — annotations.json or a single
        instances_*.json — hash-splits for train/val regardless of its
        name, so those two requests are ALWAYS disjoint (otherwise 'val' on
        a train-only export would return a subset of the very images
        'train' already served — eval-on-train leak).  split='test' on a
        lone file declaring itself val/test (instances_val2017.json) gets
        the whole file: that split is genuinely held out by whoever
        published it.  Exact per-split resolution applies only when several
        per-split files exist."""
        ann_dir = os.path.join(data_dir, "annotations")
        if os.path.isdir(ann_dir):
            cands = sorted(os.listdir(ann_dir))
            jsons = [f for f in cands if f.endswith(".json")]
            if len(jsons) == 1:
                lone = jsons[0]
                declared_holdout = lone.startswith(("instances_val",
                                                    "instances_test"))
                if split == "test" and declared_holdout:
                    return os.path.join(ann_dir, lone), False
                return os.path.join(ann_dir, lone), True
            # exact per-split file (instances_val.json, instances_val2017.json)
            for f in cands:
                if f.startswith(f"instances_{split}") and f.endswith(".json"):
                    return os.path.join(ann_dir, f), False
            # test falls back to val's file if present (common: no test
            # annotations are published; val IS held out from train here)
            if split == "test":
                for f in cands:
                    if f.startswith("instances_val") and f.endswith(".json"):
                        return os.path.join(ann_dir, f), False
            if jsons:
                raise FileNotFoundError(
                    f"{ann_dir} has per-split files {jsons} but none for "
                    f"split '{split}'")
        single = os.path.join(data_dir, "annotations.json")
        if os.path.isfile(single):
            return single, True
        raise FileNotFoundError(
            f"no COCO annotations under {data_dir} (looked for "
            f"annotations/instances_{split}*.json and annotations.json)")

    def _image_path(self, file_name: str) -> str:
        # the canonical layout keys the image dir to the annotation file's
        # suffix: annotations/instances_val2017.json <-> val2017/
        base = os.path.basename(self._ann_path)
        stem = base[len("instances_"):-len(".json")] \
            if base.startswith("instances_") and base.endswith(".json") else ""
        for sub in ("", "images", self.split, stem):
            p = os.path.join(self.data_dir, sub, file_name)
            if os.path.isfile(p):
                return p
        raise FileNotFoundError(
            f"image {file_name} not found under {self.data_dir}")

    def __len__(self) -> int:
        return len(self.ids)

    def __getitem__(self, idx: int) -> dict:
        img_id = self.ids[idx]
        info = self._images[img_id]
        img = read_image(self._image_path(info["file_name"]), "color")
        h, w = img.shape[:2]

        label = np.zeros((h, w), np.int32)
        anns = self._anns.get(img_id, [])
        masks = [(a, _ann_mask(a, h, w)) for a in anns]
        masks = [(a, m) for a, m in masks if m is not None and m.any()]
        # big first → overlapping small instances win the shared pixels
        masks.sort(key=lambda am: -int(am[1].sum()))
        for k, (_, m) in enumerate(masks):
            label[m] = k + 1
        iid = os.path.splitext(os.path.basename(info["file_name"]))[0]
        return {"image": img, "label_map": label, "id": iid}
