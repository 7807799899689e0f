"""Gaussian heatmap targets: counterpart of `kgtpu/ops/targets.py`.

CornerNet/CenterNet semantics, as in the JAX package:
  * radius from `gaussian_radius((h, w), min_overlap)` (CornerNet formula);
  * the splat is centred on the *floored* integer keypoint pixel (the
    fractional part is the offset head's target);
  * splat exp(-(dx^2 + dy^2) / (2 sigma^2)) with sigma = (2 floor(r) + 1) / 6;
  * overlapping splats combine with an elementwise max.

`render_heatmaps_batch` is the plain version of the Gaussian kernel
(`ops/gaussian.py`, `csrc/gaussian.cu`): an instance-chunked max-reduction in
torch that never materialises the [N, C, H, W] broadcast.  The train step
reaches it through the kernel's wrapper, which takes it for CPU tensors.
"""

from __future__ import annotations

import torch


def gaussian_radius(size_hw: torch.Tensor, min_overlap: float = 0.7) -> torch.Tensor:
    """CornerNet radius: the largest r such that a corner displaced by r
    still gives a box with IoU >= min_overlap against the GT box.

    size_hw [..., 2] (height, width) in stride pixels -> [...] radius >= 0.
    """
    h, w = size_hw[..., 0], size_hw[..., 1]

    b1 = h + w
    c1 = w * h * (1.0 - min_overlap) / (1.0 + min_overlap)
    r1 = (b1 - torch.sqrt(torch.clamp(b1 * b1 - 4.0 * c1, min=0.0))) / 2.0

    b2 = 2.0 * (h + w)
    c2 = (1.0 - min_overlap) * w * h
    r2 = (b2 - torch.sqrt(torch.clamp(b2 * b2 - 16.0 * c2, min=0.0))) / 8.0

    a3 = 4.0 * min_overlap
    b3 = -2.0 * min_overlap * (h + w)
    c3 = (min_overlap - 1.0) * w * h
    r3 = (b3 + torch.sqrt(torch.clamp(b3 * b3 - 4.0 * a3 * c3, min=0.0))) / (2.0 * a3)

    return torch.clamp(torch.minimum(torch.minimum(r1, r2), r3), min=0.0)


def keypoints_from_boxes(boxes: torch.Tensor) -> torch.Tensor:
    """boxes [..., 4] (x0, y0, x1, y1) -> keypoints [..., 5, 2] (x, y) in the
    order TL, TR, BL, BR, CENTER."""
    x0, y0, x1, y1 = boxes.unbind(-1)
    cx, cy = (x0 + x1) * 0.5, (y0 + y1) * 0.5
    xs = torch.stack([x0, x1, x0, x1, cx], dim=-1)
    ys = torch.stack([y0, y0, y1, y1, cy], dim=-1)
    return torch.stack([xs, ys], dim=-1)


def splat_coef(sizes_hw: torch.Tensor, valid: torch.Tensor,
               min_overlap: float = 0.7) -> torch.Tensor:
    """Per-instance 1 / (2 sigma^2) in f32, 0 for invalid slots."""
    radius = gaussian_radius(sizes_hw.float(), min_overlap)
    sigma = (2.0 * torch.floor(radius) + 1.0) / 6.0
    return torch.where(valid > 0, 1.0 / (2.0 * sigma * sigma + 1e-12),
                       torch.zeros_like(sigma))


def render_heatmaps_batch(kpts: torch.Tensor, sizes_hw: torch.Tensor,
                          valid: torch.Tensor, height: int, width: int,
                          min_overlap: float = 0.7,
                          instance_chunk: int = 8) -> torch.Tensor:
    """Render Gaussian keypoint heatmaps, the plain version.

    kpts [B, N, C, 2] (x, y) in stride coords, sizes_hw [B, N, 2], valid
    [B, N] -> [B, height, width, C] float32 in [0, 1], exactly 1.0 at every
    valid keypoint pixel.  Instances are splatted `instance_chunk` at a time
    (a [B, chunk, C, H, W] intermediate).
    """
    b, n, c, _ = kpts.shape
    dev = kpts.device
    kpts = torch.floor(kpts.float())
    coef = splat_coef(sizes_hw, valid, min_overlap)              # [B, N]
    live = valid > 0
    ys = torch.arange(height, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    hm = torch.zeros((b, c, height, width), dtype=torch.float32, device=dev)
    for s in range(0, n, instance_chunk):
        k = kpts[:, s:s + instance_chunk]                        # [B, m, C, 2]
        dx = xs - k[..., 0, None, None]                          # [B, m, C, 1, W]
        dy = ys - k[..., 1, None, None]                          # [B, m, C, H, 1]
        cf = coef[:, s:s + instance_chunk, None, None, None]
        g = torch.exp(-(dx * dx + dy * dy) * cf)                 # [B, m, C, H, W]
        g = torch.where(live[:, s:s + instance_chunk, None, None, None], g, 0.0)
        hm = torch.maximum(hm, g.amax(dim=1))
    return hm.permute(0, 2, 3, 1).contiguous()                   # [B, H, W, C]


def render_heatmaps(kpts: torch.Tensor, sizes_hw: torch.Tensor,
                    valid: torch.Tensor, height: int, width: int,
                    min_overlap: float = 0.7) -> torch.Tensor:
    """One image: kpts [N, C, 2], sizes_hw [N, 2], valid [N] -> [H, W, C]."""
    return render_heatmaps_batch(kpts[None], sizes_hw[None], valid[None],
                                 height, width, min_overlap)[0]
