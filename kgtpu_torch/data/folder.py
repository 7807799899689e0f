"""Plain image-directory reader (inference only): counterpart of
`kgtpu/data/folder.py`.

`--dataset folder --data_dir <dir>`: every image file under the directory,
recursively, with the same ids as kgtpu's reader (relative path without
extension, separators as "__", "~n" appended to the n-th repeat).  Label
maps are empty.  Images decode with `data/png.py`, so files of other
formats are listed (their ids stay the same) but raise when read.
"""

from __future__ import annotations

import os

import numpy as np

from kgtpu_torch.data.png import read_png

EXTS = (".png", ".jpg", ".jpeg", ".tif", ".tiff", ".bmp")


class ImageFolder:
    def __init__(self, data_dir: str, split: str = "test"):
        if not os.path.isdir(data_dir):
            raise FileNotFoundError(f"image folder not found: {data_dir}")
        paths = []
        for root, _, files in os.walk(data_dir):
            for f in sorted(files):
                if f.lower().endswith(EXTS):
                    paths.append(os.path.join(root, f))
        if not paths:
            raise FileNotFoundError(
                f"no image files ({'/'.join(EXTS)}) under {data_dir}")
        self.data_dir = data_dir
        self.paths = sorted(paths)
        # ids name the output files, so they must be unique: flattening the
        # relpath with '__' can collide (scan__1.png vs scan/1.png)
        ids, seen = [], {}
        for p in self.paths:
            rel = os.path.relpath(p, data_dir)
            iid = os.path.splitext(rel)[0].replace(os.sep, "__")
            if iid in seen:
                seen[iid] += 1
                iid = f"{iid}~{seen[iid]}"
            seen.setdefault(iid, 0)
            ids.append(iid)
        self._ids = ids

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, idx: int) -> dict:
        img = read_png(self.paths[idx], "color")
        return {"image": img,
                "label_map": np.zeros(img.shape[:2], np.int32),
                "id": self._ids[idx]}
