"""Image normalization: counterpart of `kgtpu/ops/preprocess.py`."""

from __future__ import annotations

import torch

# (values, device) -> f32 vector on that device, made once: a call reads it
# without a copy from the host, so a CUDA graph can capture the reads
_VECTORS: dict = {}


def _channel_vector(values: tuple[float, ...], images: torch.Tensor) -> torch.Tensor:
    """`values` as an f32 vector on the images' device.  Real tensors share
    one copy per device, made at the first call; a traced call (fake
    tensors, as `torch.export` traces) makes it as a constant of the trace
    and keeps nothing."""
    if type(images) is not torch.Tensor:
        return torch.tensor(values, dtype=torch.float32, device=images.device)
    key = (tuple(values), images.device)
    vec = _VECTORS.get(key)
    if vec is None:
        with torch.inference_mode(False):
            vec = _VECTORS[key] = torch.tensor(values, dtype=torch.float32,
                                               device=images.device)
    return vec


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
    return (x - _channel_vector(mean, images)) / _channel_vector(std, images)
