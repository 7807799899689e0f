"""Dataset registry keyed by the `--dataset` CLI flag: counterpart of
`kgtpu/data/registry.py` for the readers the port has."""

from __future__ import annotations

from kgtpu_torch.config import DataConfig

_NOT_PORTED = {
    "synthetic": "ROADMAP item 4 (the synthetic generator draws with cv2)",
    "coco": "ROADMAP item 10 (COCO polygons and JPEG images)",
    "neural_cells": "ROADMAP item 10 (its TIFF and JPEG images)",
}


def build_dataset(cfg: DataConfig, split: str = "train"):
    if cfg.dataset == "dsb2018":
        from kgtpu_torch.data.dsb2018 import DSB2018
        return DSB2018(cfg.data_dir, split=split)
    if cfg.dataset == "folder":
        from kgtpu_torch.data.folder import ImageFolder
        return ImageFolder(cfg.data_dir, split=split)
    key = "synthetic" if cfg.dataset.startswith("synthetic") else cfg.dataset
    if key in _NOT_PORTED:
        raise NotImplementedError(
            f"dataset {cfg.dataset!r} is not ported yet: {_NOT_PORTED[key]}")
    raise ValueError(f"unknown dataset: {cfg.dataset}")
