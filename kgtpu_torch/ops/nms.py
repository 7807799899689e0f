"""Greedy box NMS and the cross-variant TTA merge: counterparts of
`kgtpu/ops/nms.py::box_nms`, `batched_box_iou` and `merge_scales`, batched
over a leading axis.

Candidates are sorted score-descending (stable, so ties keep index order).
Greedy suppression runs as parallel rounds: each round keeps every live box
with no live higher-ranked box overlapping it (IoU > thresh, strict), then
kills the boxes those keeps overlap.  The fixpoint is the sequential greedy
keep-set; a round with no live box changes nothing, so the host checks for
live boxes only every few rounds, or, with `traced=True`, a while_loop runs
them (`ops/control.run_rounds`).
"""

from __future__ import annotations

import torch

from kgtpu_torch.ops.control import run_rounds
from kgtpu_torch.ops.group import Boxes


def batched_box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU.  a [..., N, 4], b [..., M, 4] -> [..., N, M]."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (torch.clamp(a[..., 2] - a[..., 0], min=0.0)
              * torch.clamp(a[..., 3] - a[..., 1], min=0.0))
    area_b = (torch.clamp(b[..., 2] - b[..., 0], min=0.0)
              * torch.clamp(b[..., 3] - b[..., 1], min=0.0))
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def _suppress_round(live: torch.Tensor, keep: torch.Tensor, conflict: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    blocked = (conflict & live[:, :, None]).any(dim=1)
    acc = live & ~blocked
    dead = (conflict & acc[:, :, None]).any(dim=1)
    return live & ~acc & ~dead, keep | acc


def box_nms(dets: Boxes, iou_thresh: float, max_out: int | None = None,
            traced: bool = False) -> Boxes:
    """dets [B, N] -> Boxes [B, max_out] with kept boxes first
    (score-descending), padding after.  traced: the suppression rounds as a
    while_loop."""
    n = dets.boxes.shape[1]
    max_out = max_out or n
    key = torch.where(dets.valid, dets.scores, torch.full_like(dets.scores, -1.0))
    _, order = torch.sort(key, dim=1, descending=True, stable=True)
    boxes = torch.gather(dets.boxes, 1, order[..., None].expand(-1, -1, 4))
    scores = torch.gather(dets.scores, 1, order)
    valid = torch.gather(dets.valid, 1, order)

    iou = batched_box_iou(boxes, boxes)                   # [B, N, N]
    idx = torch.arange(n, device=boxes.device)
    # conflict[b, j, i]: row j outranks row i and overlaps it enough
    conflict = (idx[:, None] < idx[None, :]) & (iou > iou_thresh)
    # each round keeps at least the best-ranked live row, so N rounds
    # always suffice
    keep = run_rounds(_suppress_round, valid, torch.zeros_like(valid), n, traced, (conflict,))

    _, out_order = torch.sort((~keep).to(torch.uint8), dim=1, stable=True)
    out_order = out_order[:, :max_out]
    kept = torch.gather(keep, 1, out_order)
    out_scores = torch.gather(scores, 1, out_order)
    return Boxes(
        boxes=torch.gather(boxes, 1, out_order[..., None].expand(-1, -1, 4)),
        scores=torch.where(kept, out_scores, torch.zeros_like(out_scores)),
        valid=kept,
    )


def merge_scales(per_variant: list[Boxes], iou_thresh: float, max_out: int,
                 vote: str = "max", vote_iou: float = 0.5,
                 vote_thresh: float = 0.0, traced: bool = False) -> Boxes:
    """Cross-variant TTA merge: the union of every variant's detections
    (each Boxes [B, Dv], already in the common frame) -> one NMS pass -> the
    top `max_out` rows [B, max_out].

    vote="max" keeps each survivor's own score.  vote="mean" rescores each
    survivor with the mean over variants of that variant's best-matching
    valid candidate score (IoU > vote_iou; 0 where a variant has none),
    drops survivors whose voted score is below `vote_thresh`, and restores
    the kept-first, score-descending order (stable on ties).  traced: as
    `box_nms`'s."""
    cat = Boxes(boxes=torch.cat([d.boxes for d in per_variant], dim=1),
                scores=torch.cat([d.scores for d in per_variant], dim=1),
                valid=torch.cat([d.valid for d in per_variant], dim=1))
    merged = box_nms(cat, iou_thresh, max_out=max_out, traced=traced)
    if vote == "max":
        return merged
    if vote != "mean":
        raise ValueError(f"unknown vote {vote!r}")
    b, d = merged.scores.shape
    iou = batched_box_iou(merged.boxes, cat.boxes)          # [B, D, V * Dv]
    m = (iou > vote_iou) & cat.valid[:, None, :]
    per_var = torch.where(m, cat.scores[:, None, :], torch.zeros_like(iou))
    best = per_var.reshape(b, d, len(per_variant), -1).amax(dim=-1)   # [B, D, V]
    total = best[..., 0]
    for v in range(1, best.shape[-1]):      # summed in order, as XLA does
        total = total + best[..., v]
    voted = total / len(per_variant)
    valid = merged.valid & (voted >= vote_thresh)
    key = torch.where(valid, voted, torch.full_like(voted, -1.0))
    _, order = torch.sort(-key, dim=1, stable=True)
    voted, valid = torch.gather(voted, 1, order), torch.gather(valid, 1, order)
    return Boxes(
        boxes=torch.gather(merged.boxes, 1, order[..., None].expand(-1, -1, 4)),
        scores=torch.where(valid, voted, torch.zeros_like(voted)),
        valid=valid)
