"""Image normalization: counterpart of `kgtpu/ops/preprocess.py`."""

from __future__ import annotations

import torch


def normalize_images(images: torch.Tensor, mean: tuple[float, float, float],
                     std: tuple[float, float, float]) -> torch.Tensor:
    """Raw pixels [..., H, W, 3] (uint8 or float in [0, 255]) -> float32
    (x / 255 - mean) / std."""
    x = images.float() / 255.0
    m = torch.tensor(mean, dtype=torch.float32, device=images.device)
    s = torch.tensor(std, dtype=torch.float32, device=images.device)
    return (x - m) / s
