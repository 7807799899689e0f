"""Neural stem-cell dataset reader: counterpart of
`kgtpu/data/neural_cells.py`, reading every file with `data/imread.py`.

Two layouts:

  data_dir/images/<id>.(png|tif|tiff|jpg|jpeg|bmp)
  data_dir/labels/<id>.png          # instance label map, read "unchanged"
or
  data_dir/images/<id>.(...)
  data_dir/masks/<id>/*             # one binary mask per instance, any format,
                                    # read "gray"; a file that cannot be read
                                    # as an image is skipped, as kgtpu skips
                                    # what cv2.imread returns None for, and
                                    # its instance id stays unused
"""

from __future__ import annotations

import glob
import hashlib
import os

import numpy as np

from kgtpu_torch.data.imread import UnreadableImage, read_image

_IMG_EXTS = (".png", ".tif", ".tiff", ".jpg", ".jpeg", ".bmp")


class NeuralCells:
    def __init__(self, data_dir: str, split: str = "train",
                 val_fraction: float = 0.1):
        img_dir = os.path.join(data_dir, "images")
        if not os.path.isdir(img_dir):
            raise FileNotFoundError(f"expected {img_dir}")
        paths = sorted(
            p for p in glob.glob(os.path.join(img_dir, "*"))
            if p.lower().endswith(_IMG_EXTS)
        )
        # id-stable hash split (same scheme as dsb2018.py): membership
        # depends only on the file's own id, so adding/removing files
        # never reshuffles which existing ids are train vs val
        def bucket(s):
            h = int(hashlib.md5(s.encode()).hexdigest(), 16) % 1000
            return "val" if h < val_fraction * 1000 else "train"

        def stem(p):
            return os.path.splitext(os.path.basename(p))[0]

        if split in ("train", "val"):
            paths = [p for p in paths if bucket(stem(p)) == split]
        elif split == "test":
            # same train-leak guard as dsb2018.py: if any image has labels,
            # this is a TRAINING dir — evaluate the held-out val partition,
            # not the images the model trained on
            def labeled(p):
                return (os.path.isfile(
                            os.path.join(data_dir, "labels", stem(p) + ".png"))
                        or os.path.isdir(
                            os.path.join(data_dir, "masks", stem(p))))
            if any(labeled(p) for p in paths):
                import warnings
                warnings.warn(
                    f"NeuralCells split='test' on {data_dir}: labels present, "
                    "so this looks like a TRAINING directory — evaluating on "
                    "the held-out val partition instead of all ids to avoid "
                    "train-set leakage.", stacklevel=2)
                paths = [p for p in paths if bucket(stem(p)) == "val"]
        self.data_dir = data_dir
        self.paths = paths

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx: int) -> dict:
        p = self.paths[idx]
        iid = os.path.splitext(os.path.basename(p))[0]
        img = read_image(p, "color")

        label = np.zeros(img.shape[:2], np.int32)
        lab_path = os.path.join(self.data_dir, "labels", iid + ".png")
        mask_dir = os.path.join(self.data_dir, "masks", iid)
        if os.path.isfile(lab_path):
            label = read_image(lab_path, "unchanged").astype(np.int32)
        elif os.path.isdir(mask_dir):
            for k, f in enumerate(sorted(os.listdir(mask_dir))):
                try:
                    m = read_image(os.path.join(mask_dir, f), "gray")
                except UnreadableImage:       # unreadable: skipped, id kept
                    continue
                label[m > 127] = k + 1
        return {"image": img, "label_map": label, "id": iid}
