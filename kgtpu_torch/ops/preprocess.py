"""Image normalization: counterpart of `kgtpu/ops/preprocess.py`."""

from __future__ import annotations

import torch


def normalize_images(images: torch.Tensor, mean: tuple[float, float, float],
                     std: tuple[float, float, float],
                     gain: torch.Tensor | None = None,
                     bias: torch.Tensor | None = None) -> torch.Tensor:
    """Raw pixels [..., H, W, 3] (uint8 or float in [0, 255]) -> float32
    (x / 255 - mean) / std.

    gain, bias: optional per-image colour jitter [..., 3] (the leading axes
    of `images`), applied as clip(x * gain + bias, 0, 255) first.
    """
    x = images.float()
    if gain is not None:
        g = gain.float()[..., None, None, :]
        b = (torch.zeros_like(g) if bias is None else bias.float()[..., None, None, :])
        x = torch.clamp(x * g + b, 0.0, 255.0)
    x = x / 255.0
    m = torch.tensor(mean, dtype=torch.float32, device=images.device)
    s = torch.tensor(std, dtype=torch.float32, device=images.device)
    return (x - m) / s
