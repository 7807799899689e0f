"""Losses of the train step: counterpart of `kgtpu/losses.py`.

Penalty-reduced focal loss on the heatmaps, L1 on sub-pixel offsets and box
sizes gathered at the floored GT keypoint pixels, and BCE + dice on the mask
crops; all in f32.  The JAX package vmaps the per-image losses over the
batch; here they take the batch axis and return one value per image, which
the train step averages.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from kgtpu_torch.ops.targets import keypoints_from_boxes


def focal_loss(hm_logits: torch.Tensor, hm_targets: torch.Tensor,
               alpha: float = 2.0, beta: float = 4.0,
               count: Callable[[torch.Tensor], torch.Tensor] | None = None) -> torch.Tensor:
    """CornerNet penalty-reduced pixelwise focal loss.

    hm_logits, hm_targets [..., H, W, C]; targets are exactly 1.0 at keypoint
    pixels.  Scalar, normalised by the number of positive pixels; `count`
    maps this batch's number to the one to normalise by (a data-parallel
    rank sums it over the ranks, so its loss is its share of the global
    batch's).
    """
    lg = hm_logits.float()
    p = torch.sigmoid(lg)
    t = hm_targets.float()
    pos = (t >= 1.0).float()
    pos_loss = -((1.0 - p) ** alpha) * F.logsigmoid(lg) * pos
    neg_loss = -((1.0 - t) ** beta) * (p ** alpha) * F.logsigmoid(-lg) * (1.0 - pos)
    num_pos = pos.sum()
    if count is not None:
        num_pos = count(num_pos)
    num_pos = torch.clamp(num_pos, min=1.0)
    return (pos_loss.sum() + neg_loss.sum()) / num_pos


def gather_at(pred_map: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """pred_map [B, H, W, C] at integer pixel coords xy [B, ..., 2] (x, y),
    truncated and clamped into the map -> [B, ..., C]."""
    b, h, w, c = pred_map.shape
    xi = torch.clamp(xy[..., 0].to(torch.int32), 0, w - 1).long()
    yi = torch.clamp(xy[..., 1].to(torch.int32), 0, h - 1).long()
    idx = (yi * w + xi).reshape(b, -1)
    out = torch.gather(pred_map.reshape(b, h * w, c), 1,
                       idx[..., None].expand(-1, -1, c))
    return out.reshape(xy.shape[:-1] + (c,))


def _in_map(ikpts: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return ((ikpts[..., 0] >= 0) & (ikpts[..., 0] < w)
            & (ikpts[..., 1] >= 0) & (ikpts[..., 1] < h))


def _masked_mean(l1: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    m = m.float()
    return (l1 * m).sum((1, 2)) / torch.clamp(m.sum((1, 2)), min=1.0)


def offset_loss(reg: torch.Tensor, kpts: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """L1 between predicted sub-pixel offsets and the keypoints' fractional
    parts.  reg [B, H, W, 2], kpts [B, N, C, 2] (stride coords), valid
    [B, N] -> [B] mean over each image's valid in-map keypoints."""
    _, h, w, _ = reg.shape
    ikpts = torch.floor(kpts)
    frac = kpts - ikpts
    pred = gather_at(reg.float(), ikpts)                       # [B, N, C, 2]
    m = (valid[..., None] > 0) & _in_map(ikpts, h, w)          # [B, N, C]
    return _masked_mean(torch.abs(pred - frac).sum(-1), m)


def wh_loss(wh: torch.Tensor, boxes: torch.Tensor,
            valid: torch.Tensor) -> torch.Tensor:
    """L1 on box (w, h) gathered at all 5 keypoint pixels: the grouper prunes
    corner pairs by the size predicted at the corner peaks.  wh [B, H, W, 2],
    boxes [B, N, 4] (stride coords), valid [B, N] -> [B]."""
    _, h, w, _ = wh.shape
    ikpts = torch.floor(keypoints_from_boxes(boxes))           # [B, N, 5, 2]
    pred = gather_at(wh.float(), ikpts)
    target = torch.stack([boxes[..., 2] - boxes[..., 0],
                          boxes[..., 3] - boxes[..., 1]], dim=-1)[..., None, :]
    m = (valid[..., None] > 0) & _in_map(ikpts, h, w)
    return _masked_mean(torch.abs(pred - target).sum(-1), m)


def mask_loss(logits: torch.Tensor, targets: torch.Tensor, valid: torch.Tensor,
              dice_weight: float = 1.0) -> torch.Tensor:
    """BCE + dice over mask crops.  logits, targets [B, R, m, m], valid
    [B, R] -> [B] mean over each image's valid crops."""
    t = targets.float()
    lg = logits.float()
    bce = -(t * F.logsigmoid(lg) + (1 - t) * F.logsigmoid(-lg)).mean((2, 3))
    p = torch.sigmoid(lg)
    inter = (p * t).sum((2, 3))
    denom = p.sum((2, 3)) + t.sum((2, 3))
    dice = 1.0 - (2.0 * inter + 1.0) / (denom + 1.0)
    m = (valid > 0).float()
    per = bce + dice_weight * dice
    return (per * m).sum(1) / torch.clamp(m.sum(1), min=1.0)
