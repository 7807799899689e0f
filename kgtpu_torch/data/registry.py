"""Dataset registry keyed by the `--dataset` CLI flag: counterpart of
`kgtpu/data/registry.py`, for every dataset kgtpu reads."""

from __future__ import annotations

from kgtpu_torch.config import DataConfig

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
    if cfg.dataset == "coco":
        from kgtpu_torch.data.coco import CocoDataset
        return CocoDataset(cfg.data_dir, split=split)
    if cfg.dataset == "neural_cells":
        from kgtpu_torch.data.neural_cells import NeuralCells
        return NeuralCells(cfg.data_dir, split=split)
    raise ValueError(f"unknown dataset: {cfg.dataset}")
