"""Dataset registry keyed by the `--dataset` CLI flag: counterpart of
`kgtpu/data/registry.py` for the readers the port has."""

from __future__ import annotations

from kgtpu_torch.config import DataConfig

_NOT_PORTED = {
    "coco": "ROADMAP item 10 (COCO polygons and JPEG images)",
    "neural_cells": "ROADMAP item 10 (its TIFF and JPEG images)",
}

# split -> (number of images, seed) of the generated datasets; the train
# split's size is cfg.synthetic_train_images
SYNTHETIC_SPLITS = {"train": (None, 0), "val": (16, 7), "test": (16, 13)}


def build_dataset(cfg: DataConfig, split: str = "train"):
    if cfg.dataset in ("synthetic", "synthetic_crowded", "synthetic_hard"):
        from kgtpu_torch.data.synthetic import SyntheticCells
        n, seed = SYNTHETIC_SPLITS.get(split, (16, 7))
        return SyntheticCells(size=cfg.input_size,
                              num_images=cfg.synthetic_train_images if n is None else n,
                              seed=seed, crowded=cfg.dataset.endswith("crowded"),
                              hard=cfg.dataset.endswith("hard"))
    if cfg.dataset == "dsb2018":
        from kgtpu_torch.data.dsb2018 import DSB2018
        return DSB2018(cfg.data_dir, split=split)
    if cfg.dataset == "folder":
        from kgtpu_torch.data.folder import ImageFolder
        return ImageFolder(cfg.data_dir, split=split)
    if cfg.dataset in _NOT_PORTED:
        raise NotImplementedError(
            f"dataset {cfg.dataset!r} is not ported yet: {_NOT_PORTED[cfg.dataset]}")
    raise ValueError(f"unknown dataset: {cfg.dataset}")
