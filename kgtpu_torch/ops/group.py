"""Keypoint-graph grouping: peaks -> boxes.  Counterpart of
`kgtpu/ops/group.py::group_keypoints`, batched over a leading axis.

Edges are (TL_i, BR_j) pairs with valid geometry, scored by the corner
scores and by distance-decayed support from the CENTER, TR and BL peaks.
Edges are matched greedily by (score desc, flat index asc), each TL and BR
peak used at most once.  The greedy matching is computed in parallel rounds:
each round accepts every live edge that is the best of both its row and its
column, then kills those rows and columns.  A round on a batch with no live
edge changes nothing, so the host checks for live edges only every few
rounds (each check is a device sync on the card).

`traced=True` runs the same rounds as a while_loop (kgtpu's
lax.while_loop; `ops/control.run_rounds`): each iteration runs
ROUNDS_PER_CHECK rounds, and the loop goes on while an edge is live.  That
form has no host-side branch, so `torch.export` can trace it
(`kgtpu_torch/export.py`); it gives the same keep-set, since the rounds it
adds after the last live edge change nothing.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from kgtpu_torch.config import KP_BL, KP_BR, KP_CENTER, KP_TL, KP_TR, GroupConfig
from kgtpu_torch.ops.control import run_rounds
from kgtpu_torch.ops.decode import Peaks


class Boxes(NamedTuple):
    """Fixed-count detections [B, D], padded with valid=False rows."""

    boxes: torch.Tensor   # [B, D, 4] (x0, y0, x1, y1), output-stride coords
    scores: torch.Tensor  # [B, D], descending over valid rows
    valid: torch.Tensor   # [B, D] bool


def nearest_support(points: torch.Tensor, diag: torch.Tensor,
                    kp_xy: torch.Tensor, kp_score: torch.Tensor,
                    score_thresh: float, tol: float) -> torch.Tensor:
    """Distance-decayed score of the nearest supporting peak.

    points [B, K, K, 2], diag [B, K, K], kp_xy [B, K, 2], kp_score [B, K] ->
    [B, K, K]: peak_score * max(1 - dist / (tol * diag), 0) for the nearest
    peak above score_thresh, 0 when there is none.
    """
    b, k = kp_score.shape
    d2 = ((points[..., None, :] - kp_xy[:, None, None, :, :]) ** 2).sum(-1)
    ok = (kp_score > score_thresh)[:, None, None, :]
    d2 = torch.where(ok, d2, torch.full_like(d2, float("inf")))
    best_d2, best = d2.min(dim=-1)                        # first occurrence
    best_d = torch.sqrt(best_d2)
    best_score = torch.gather(kp_score, 1, best.reshape(b, -1)).reshape(best.shape)
    decay = torch.clamp(1.0 - best_d / torch.clamp(tol * diag, min=1e-6), min=0.0)
    return torch.where(torch.isfinite(best_d), best_score * decay,
                       torch.zeros_like(decay))


def _match_round(live: torch.Tensor, kept: torch.Tensor, score: torch.Tensor,
                 fidx: torch.Tensor, big: int) -> tuple[torch.Tensor, torch.Tensor]:
    sc = torch.where(live, score, torch.full_like(score, -1.0))
    row_max = sc.amax(dim=2, keepdim=True)
    col_max = sc.amax(dim=1, keepdim=True)
    bigt = torch.full_like(fidx, big)
    row_arg = torch.where(live & (sc == row_max), fidx, bigt).amin(dim=2, keepdim=True)
    col_arg = torch.where(live & (sc == col_max), fidx, bigt).amin(dim=1, keepdim=True)
    new = live & (fidx == row_arg) & (fidx == col_arg)
    used_r = new.any(dim=2, keepdim=True)
    used_c = new.any(dim=1, keepdim=True)
    return live & ~used_r & ~used_c, kept | new


def group_keypoints(peaks: Peaks, cfg: GroupConfig,
                    kp_wh: torch.Tensor | None = None,
                    traced: bool = False) -> Boxes:
    """peaks [B, 5, K] -> Boxes [B, max_detections], score-descending, not
    yet NMS-deduplicated.  kp_wh: optional [B, 5, K, 2] size-head values at
    each peak, for the size_prune gate.  traced: the matching rounds as a
    while_loop (see the module note)."""
    tl_s, br_s = peaks.scores[:, KP_TL], peaks.scores[:, KP_BR]       # [B, K]
    tl, br = peaks.coords[:, KP_TL], peaks.coords[:, KP_BR]           # [B, K, 2]

    dx = br[:, None, :, 0] - tl[:, :, None, 0]                        # [B, K, K]
    dy = br[:, None, :, 1] - tl[:, :, None, 1]
    geom_ok = ((dx >= cfg.min_box_size) & (dy >= cfg.min_box_size)
               & (dx <= cfg.max_box_size) & (dy <= cfg.max_box_size)
               & (tl_s[:, :, None] > cfg.kp_score_thresh)
               & (br_s[:, None, :] > cfg.kp_score_thresh))
    if kp_wh is not None and cfg.size_prune > 0:
        wh_tl, wh_br = kp_wh[:, KP_TL].float(), kp_wh[:, KP_BR].float()
        pw = torch.clamp(torch.maximum(wh_tl[:, :, None, 0], wh_br[:, None, :, 0]), min=1.0)
        ph = torch.clamp(torch.maximum(wh_tl[:, :, None, 1], wh_br[:, None, :, 1]), min=1.0)
        geom_ok = geom_ok & (dx <= cfg.size_prune * pw) & (dy <= cfg.size_prune * ph)
    diag = torch.sqrt(dx * dx + dy * dy)

    mid = 0.5 * (tl[:, :, None, :] + br[:, None, :, :])               # [B, K, K, 2]
    center_sup = nearest_support(mid, diag, peaks.coords[:, KP_CENTER],
                                 peaks.scores[:, KP_CENTER], cfg.center_thresh,
                                 cfg.center_tol)
    exp_tr = torch.stack([br[:, None, :, 0].expand_as(dx),
                          tl[:, :, None, 1].expand_as(dx)], dim=-1)
    exp_bl = torch.stack([tl[:, :, None, 0].expand_as(dx),
                          br[:, None, :, 1].expand_as(dx)], dim=-1)
    tr_sup = nearest_support(exp_tr, diag, peaks.coords[:, KP_TR],
                             peaks.scores[:, KP_TR], cfg.kp_score_thresh,
                             cfg.edge_tol)
    bl_sup = nearest_support(exp_bl, diag, peaks.coords[:, KP_BL],
                             peaks.scores[:, KP_BL], cfg.kp_score_thresh,
                             cfg.edge_tol)

    w_sum = cfg.w_corner + cfg.w_center + cfg.w_edge
    score = (cfg.w_corner * 0.5 * (tl_s[:, :, None] + br_s[:, None, :])
             + cfg.w_center * center_sup
             + cfg.w_edge * 0.5 * (tr_sup + bl_sup)) / w_sum

    ok = geom_ok & (score > cfg.score_thresh)
    if cfg.require_center:
        ok = ok & (center_sup > 0.0)
    if cfg.require_edges:
        ok = ok & (tr_sup > 0.0) & (bl_sup > 0.0)

    b, k = tl_s.shape
    fidx = torch.arange(k * k, device=score.device).reshape(1, k, k)
    live = ok & (score > 0.0)
    # each round accepts >= 1 edge per batch item that has a live edge and
    # kills its row and column, so K rounds always suffice
    kept = run_rounds(lambda lv, kp, sc, fi: _match_round(lv, kp, sc, fi, k * k),
                      live, torch.zeros_like(live), k, traced, (score, fidx))

    # <= 1 kept edge per row: order rows by (score desc, row asc)
    masked = torch.where(kept, score, torch.full_like(score, -1.0))
    row_score, row_col = masked.max(dim=2)
    top_scores, ti = torch.sort(row_score, dim=1, descending=True, stable=True)
    d = cfg.max_detections
    top_scores, ti = top_scores[:, :d], ti[:, :d]
    bj = torch.gather(row_col, 1, ti)
    bx = torch.stack([torch.gather(tl[..., 0], 1, ti), torch.gather(tl[..., 1], 1, ti),
                      torch.gather(br[..., 0], 1, bj), torch.gather(br[..., 1], 1, bj)],
                     dim=-1)
    valid = top_scores > 0.0
    return Boxes(boxes=bx, scores=torch.clamp(top_scores, min=0.0), valid=valid)
