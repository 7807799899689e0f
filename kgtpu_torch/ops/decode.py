"""Peak decoder: heatmaps -> sub-pixel keypoint peaks.  Counterpart of
`kgtpu/ops/decode.py::decode_peaks` (default path: plateau dedup + blocked
top-k) and `decode_center_wh` (the centernet decode), batched over a leading
axis.

  1. 3x3 max-pool NMS keeps pixels equal to their window max; among equal
     survivors in one window only the lowest row-major index stays, so each
     2x2 block holds at most one peak.
  2. Each 2x2 block's survivor is found with argmax (first occurrence), and
     the H*W/4 block survivors are ordered by (score desc, full-res index
     asc): a sort by index, then a stable sort by score (torch.topk leaves
     the order of ties unspecified).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class Peaks(NamedTuple):
    """Decoded per-class peaks, [B, C, K] (coords [B, C, K, 2])."""

    scores: torch.Tensor   # peak scores in [0, 1], descending per class
    coords: torch.Tensor   # sub-pixel (x, y) in output-stride coords
    indices: torch.Tensor  # flat row-major spatial index (int64)


def maxpool_nms(prob: torch.Tensor) -> torch.Tensor:
    """prob [B, H, W, C] -> same, zero except plateau-deduplicated 3x3
    local maxima."""
    b, h, w, c = prob.shape
    x = prob.permute(0, 3, 1, 2)                          # [B, C, H, W]
    pooled = F.max_pool2d(x, 3, 1, 1)
    achiever = x == pooled
    big = float(h * w)
    fidx = torch.arange(h * w, dtype=torch.float32,
                        device=prob.device).reshape(1, 1, h, w)
    cand = torch.where(achiever, fidx, torch.full_like(x, big))
    min_idx = -F.max_pool2d(-cand, 3, 1, 1)
    keep = achiever & (cand == min_idx)
    return torch.where(keep, x, torch.zeros_like(x)).permute(0, 2, 3, 1)


def blocked_topk(prob: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact per-class top-k of a plateau-deduplicated NMS'd map.
    prob [B, H, W, C] -> (scores [B, C, k], full-res flat indices [B, C, k])
    ordered (score desc, index asc)."""
    b, h, w, c = prob.shape
    h2, w2 = h // 2, w // 2
    blk = prob.reshape(b, h2, 2, w2, 2, c).permute(0, 1, 3, 2, 4, 5)
    blk = blk.reshape(b, h2, w2, 4, c)
    bv, bpos = blk.max(dim=3)                             # first occurrence
    dev = prob.device
    by = torch.arange(h2, device=dev).reshape(1, h2, 1, 1)
    bx = torch.arange(w2, device=dev).reshape(1, 1, w2, 1)
    fidx = (by * 2 + bpos // 2) * w + bx * 2 + bpos % 2   # [B, h2, w2, C]
    vals = bv.reshape(b, h2 * w2, c).transpose(1, 2)      # [B, C, N]
    idxs = fidx.reshape(b, h2 * w2, c).transpose(1, 2)
    # two-key sort: by index, then stably by score descending
    idxs, order = torch.sort(idxs, dim=-1)
    vals = torch.gather(vals, -1, order)
    vals, order = torch.sort(vals, dim=-1, descending=True, stable=True)
    idxs = torch.gather(idxs, -1, order)
    return vals[..., :k], idxs[..., :k]


def decode_peaks(hm: torch.Tensor, reg: torch.Tensor | None, k: int,
                 apply_sigmoid: bool = True) -> Peaks:
    """hm [B, H, W, C] logits (or probabilities), reg [B, H, W, 2] offsets
    (dx, dy) or None -> Peaks with k peaks per class."""
    b, h, w, c = hm.shape
    if k > h * w:
        raise ValueError(f"decode needs k <= H*W, got k={k} for a {h}x{w} map")
    prob = maxpool_nms((torch.sigmoid(hm) if apply_sigmoid else hm).float())
    if h % 2 == 0 and w % 2 == 0 and k <= (h * w) // 4:
        scores, idx = blocked_topk(prob, k)
    else:
        # odd sides or a map too small for the blocked top-k: every pixel,
        # ordered (score desc, index asc) as lax.top_k orders them
        flat = prob.reshape(b, h * w, c).transpose(1, 2)
        scores, idx = torch.sort(flat, dim=-1, descending=True, stable=True)
        scores, idx = scores[..., :k], idx[..., :k]
    ys = torch.div(idx, w, rounding_mode="floor").float()
    xs = (idx % w).float()
    if reg is not None:
        off = gather_at(reg, idx)                         # [B, C, K, 2]
        xs = xs + off[..., 0]
        ys = ys + off[..., 1]
    # the offset head is unbounded: keep peaks inside the map
    xs = xs.clamp(0.0, w - 1.0)
    ys = ys.clamp(0.0, h - 1.0)
    return Peaks(scores=scores, coords=torch.stack([xs, ys], dim=-1),
                 indices=idx)


def decode_center_wh(hm: torch.Tensor, reg: torch.Tensor | None, wh: torch.Tensor,
                     k: int, score_thresh: float = 0.0):
    """CenterNet decode: each center peak becomes a box of the size the wh
    head predicts there.  hm [B, H, W, C] logits (the last channel is the
    center class, the others are ignored), reg [B, H, W, 2] offsets or
    None, wh [B, H, W, 2] sizes (w, h) in stride units -> Boxes [B, k]
    (stride coords), scores zeroed and valid false at or below
    `score_thresh`."""
    from kgtpu_torch.ops.group import Boxes   # ops.group imports this module
    c = hm.shape[-1]
    peaks = decode_peaks(hm[..., c - 1:c], reg, k)
    sc = peaks.scores[:, 0]                               # [B, K]
    xy = peaks.coords[:, 0]                               # [B, K, 2]
    half = torch.clamp(gather_at(wh, peaks.indices)[:, 0], min=0.0) * 0.5
    boxes = torch.stack([xy[..., 0] - half[..., 0], xy[..., 1] - half[..., 1],
                         xy[..., 0] + half[..., 0], xy[..., 1] + half[..., 1]], dim=-1)
    valid = sc > score_thresh
    return Boxes(boxes=boxes, scores=torch.where(valid, sc, torch.zeros_like(sc)),
                 valid=valid)


def gather_at(maps: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """maps [B, H, W, D], flat spatial idx [B, C, K] -> [B, C, K, D] f32."""
    b, h, w, d = maps.shape
    flat = maps.reshape(b, h * w, d).float()
    c, k = idx.shape[1:]
    g = torch.gather(flat, 1, idx.reshape(b, c * k, 1).expand(b, c * k, d))
    return g.reshape(b, c, k, d)
