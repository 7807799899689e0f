"""Host-side mask AP evaluation: the port's copy of `kgtpu/evaluate.py`.

Four protocols:
  * "dsb2018" — the Kaggle Data Science Bowl 2018 metric: per image and IoU
    threshold t ∈ {0.50, 0.55, …, 0.95}, precision = TP/(TP+FP+FN) with
    greedy IoU matching; mean over thresholds, then over images.
  * "coco"    — dataset-level AP: score-ranked PR curve per threshold with
    101-point interpolation, averaged over the same thresholds.
  * "aji"     — Aggregated Jaccard Index (Kumar et al., IEEE TMI 2017), the
    standard nuclei-segmentation metric: per image, every GT instance pairs
    with its best-IoU prediction; AJI = Σ intersections / (Σ pair unions +
    areas of unmatched GTs and predictions).  Mean over images.
  * "pq"      — Panoptic Quality (Kirillov et al., CVPR 2019) for the single
    cell class: matches are IoU>0.5 pairs (provably unique); PQ = SQ·RQ with
    SQ = mean matched IoU and RQ = TP/(TP + FP/2 + FN/2), aggregated over
    the dataset.

All four read the same per-image records.  The IoUs that "dsb2018" and
"coco" match on are f32, as kgtpu computes them by default: its compiled op
(`kgtpu/native`, taken wherever g++ builds it) divides the counts as
(float)inter / (float)union.  Here `iou_from_label_maps` takes the port's
copy of that op (`kgtpu_torch/native.py`) where it is built, and else
divides the same counts as f32 in NumPy, which equals the C division bit
for bit; a match whose IoU lies within an f32 rounding of a threshold thus
goes as it goes in kgtpu.  AJI and PQ keep their f64 arithmetic, as
kgtpu's do.
"""

from __future__ import annotations

import numpy as np

from kgtpu_torch import native

IOU_THRESHOLDS = np.arange(0.5, 1.0, 0.05)


def instance_masks_from_label_map(label: np.ndarray) -> list[np.ndarray]:
    """Label map → list of boolean masks, ordered by instance id."""
    ids = np.unique(label)
    return [label == i for i in ids if i > 0]


def mask_iou_matrix(preds: list[np.ndarray], gts: list[np.ndarray]) -> np.ndarray:
    """[P, G] IoU between boolean masks."""
    if not preds or not gts:
        return np.zeros((len(preds), len(gts)))
    p = np.stack([m.reshape(-1) for m in preds]).astype(np.float32)
    g = np.stack([m.reshape(-1) for m in gts]).astype(np.float32)
    inter = p @ g.T
    union = p.sum(1)[:, None] + g.sum(1)[None, :] - inter
    return inter / np.maximum(union, 1e-9)


def iou_from_label_maps(pred: np.ndarray, gt: np.ndarray
                        ) -> tuple[np.ndarray, list[int], list[int]]:
    """IoU between the *present* instances of two label maps.

    Returns (iou [P, G] f32, pred_ids, gt_ids) where rows/cols follow the
    ascending present-id order: the compiled op's dense matrix at those
    ids, or f32 quotients of one joint-bincount pass (`_pair_stats`).
    """
    pred_ids = [int(i) for i in np.unique(pred) if i > 0]
    gt_ids = [int(i) for i in np.unique(gt) if i > 0]
    if not pred_ids or not gt_ids:
        return np.zeros((len(pred_ids), len(gt_ids))), pred_ids, gt_ids
    dense = native.label_map_iou(pred, gt)
    if dense is not None:
        return dense[np.ix_([i - 1 for i in pred_ids], [i - 1 for i in gt_ids])], \
            pred_ids, gt_ids
    # ids below 0 are background, as in the compiled op
    inter, p_area, g_area = _pair_stats(np.maximum(pred, 0), np.maximum(gt, 0))
    union = p_area[:, None] + g_area[None, :] - inter
    return inter.astype(np.float32) / union.astype(np.float32), pred_ids, gt_ids


def greedy_tp_flags(iou: np.ndarray, scores: np.ndarray,
                    thresholds: np.ndarray = IOU_THRESHOLDS) -> np.ndarray:
    """Greedy-by-score matching, vectorized over ALL IoU thresholds at once.

    Returns [T, P] bool — is prediction p a TP at thresholds[t].  Predictions
    are visited in score order (ties: lowest index, stable sort); each takes
    the highest-IoU still-unused GT with IoU >= t (ties: lowest GT index).
    One O(P) pass with [T, G] array work per step replaces the former
    per-threshold O(P·G) Python loops."""
    thresholds = np.asarray(thresholds, np.float64)
    T, (P, G) = len(thresholds), iou.shape
    flags = np.zeros((T, P), bool)
    if P == 0 or G == 0:
        return flags
    avail = np.ones((T, G), bool)
    rows = np.arange(T)
    for i in np.argsort(-scores, kind="stable"):
        cand = np.where(avail, iou[i][None, :], -1.0)       # [T, G]
        j = cand.argmax(1)
        ok = cand[rows, j] >= thresholds
        flags[ok, i] = True
        avail[rows[ok], j[ok]] = False
    return flags


def dsb2018_image_score(iou: np.ndarray, pred_scores: np.ndarray,
                        n_gt: int) -> float:
    """Mean over thresholds of TP/(TP+FP+FN) for one image."""
    n_pred = iou.shape[0]
    if n_gt == 0:
        return 1.0 if n_pred == 0 else 0.0
    tp = greedy_tp_flags(iou, pred_scores).sum(1)           # [T]
    return float(np.mean(tp / np.maximum(n_pred + n_gt - tp, 1)))


def _rec_iou(rec: dict) -> tuple[np.ndarray, np.ndarray, int]:
    """(iou [P,G], pred scores [P], n_gt) for one per-image record."""
    iou, pred_ids, gt_ids = iou_from_label_maps(rec["pred_label"],
                                                rec["gt_label"])
    s = (np.asarray([rec["scores"][i - 1] for i in pred_ids], np.float32)
         if pred_ids else np.zeros(0, np.float32))
    return iou, s, len(gt_ids)


def evaluate_dsb2018(per_image: list[dict]) -> dict:
    """per_image: [{"pred_label": HxW int, "scores": [D], "gt_label": HxW int}]."""
    scores = []
    for rec in per_image:
        iou, s, n_gt = _rec_iou(rec)
        scores.append(dsb2018_image_score(iou, s, n_gt))
    return {"mAP_dsb2018": float(np.mean(scores)) if scores else 0.0,
            "per_image": scores}


def evaluate_coco(per_image: list[dict]) -> dict:
    """Dataset-level mask AP@[.5:.95] with 101-point interpolation."""
    T = len(IOU_THRESHOLDS)
    all_scores, all_flags = [], []                  # [N], [T, N]
    n_gt = 0
    for rec in per_image:
        iou, s, ng = _rec_iou(rec)
        n_gt += ng
        all_scores.append(s)
        all_flags.append(greedy_tp_flags(iou, s) if ng
                         else np.zeros((T, len(s)), bool))

    scores = np.concatenate(all_scores) if all_scores else np.zeros(0)
    flags = (np.concatenate(all_flags, axis=1) if all_flags
             else np.zeros((T, 0), bool))
    if scores.size == 0 or n_gt == 0:
        return {"AP_coco": 0.0, "AP50": 0.0, "AP75": 0.0}

    order = np.argsort(-scores, kind="stable")
    tps = np.cumsum(flags[:, order], axis=1, dtype=np.float64)   # [T, N]
    ranks = np.arange(1, scores.size + 1, dtype=np.float64)
    recall = tps / n_gt
    precision = tps / ranks[None, :]
    # 101-point interpolation: p(r) = max precision at recall >= r, i.e. the
    # right-to-left precision envelope sampled at the first recall >= r
    env = np.maximum.accumulate(precision[:, ::-1], axis=1)[:, ::-1]
    rs = np.linspace(0, 1, 101)
    aps = []
    for t in range(T):
        idx = np.searchsorted(recall[t], rs, side="left")
        p = np.where(idx < recall.shape[1], env[t][np.minimum(idx, recall.shape[1] - 1)], 0.0)
        aps.append(float(p.mean()))
    return {"AP_coco": float(np.mean(aps)),
            "AP50": aps[0], "AP75": aps[5]}


def _pair_stats(pred: np.ndarray, gt: np.ndarray
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(inter [P,G], pred areas [P], gt areas [G]) in pixel counts, rows/cols
    over the *present* instance ids of each map in ascending order.

    One bincount over joint (pred, gt) codes — a single pass over the image,
    no per-instance mask expansion."""
    pred_ids = np.unique(pred)
    pred_ids = pred_ids[pred_ids > 0]
    gt_ids = np.unique(gt)
    gt_ids = gt_ids[gt_ids > 0]
    P, G = len(pred_ids), len(gt_ids)
    pmap = np.zeros(int(pred.max()) + 1 if P else 1, np.int64)
    pmap[pred_ids] = np.arange(1, P + 1)
    gmap = np.zeros(int(gt.max()) + 1 if G else 1, np.int64)
    gmap[gt_ids] = np.arange(1, G + 1)
    pc = pmap[pred.reshape(-1)]
    gc = gmap[gt.reshape(-1)]
    cnt = np.bincount(pc * (G + 1) + gc,
                      minlength=(P + 1) * (G + 1)).reshape(P + 1, G + 1)
    inter = cnt[1:, 1:].astype(np.float64)
    return inter, cnt[1:, :].sum(1).astype(np.float64), \
        cnt[:, 1:].sum(0).astype(np.float64)


def aji_image(pred: np.ndarray, gt: np.ndarray) -> float:
    """Aggregated Jaccard Index for one image (Kumar et al. 2017, in the
    canonical formulation the nuclei-segmentation literature implements):
    each GT instance pairs with the prediction maximizing IoU against it;
    C accumulates pair intersections and U pair unions; GTs with no
    overlapping prediction and predictions never chosen as any GT's best
    add their full areas to U.  AJI = C / U."""
    inter, p_area, g_area = _pair_stats(pred, gt)
    P, G = inter.shape
    if G == 0:
        # no GT: perfect iff nothing was predicted
        return 1.0 if P == 0 else 0.0
    if P == 0:
        return 0.0
    union = p_area[:, None] + g_area[None, :] - inter
    iou = inter / np.maximum(union, 1e-9)
    best = iou.argmax(0)                                   # [G] best pred
    overlapped = iou.max(0) > 0
    gi = np.nonzero(overlapped)[0]
    c = inter[best[gi], gi].sum()
    u = union[best[gi], gi].sum()
    u += g_area[~overlapped].sum()
    unused = np.ones(P, bool)
    unused[best[overlapped]] = False
    u += p_area[unused].sum()
    return float(c / max(u, 1e-9))


def evaluate_aji(per_image: list[dict]) -> dict:
    """Mean per-image AJI over records of the evaluate_dsb2018 format
    (scores are ignored — AJI is rank-free)."""
    vals = [aji_image(rec["pred_label"], rec["gt_label"])
            for rec in per_image]
    return {"AJI": float(np.mean(vals)) if vals else 0.0, "per_image": vals}


def evaluate_pq(per_image: list[dict], iou_thresh: float = 0.5) -> dict:
    """Single-class Panoptic Quality, aggregated over the dataset.

    Matches are (pred, gt) pairs with IoU > iou_thresh; at the standard 0.5
    they are unique without any assignment step (two masks can't both
    overlap one GT by >50%).  PQ = SQ·RQ; SQ = mean matched IoU;
    RQ = TP / (TP + FP/2 + FN/2)."""
    if iou_thresh < 0.5:
        raise ValueError("PQ requires iou_thresh >= 0.5 (match uniqueness)")
    tp = fp = fn = 0
    iou_sum = 0.0
    for rec in per_image:
        inter, p_area, g_area = _pair_stats(rec["pred_label"],
                                            rec["gt_label"])
        union = p_area[:, None] + g_area[None, :] - inter
        iou = inter / np.maximum(union, 1e-9)
        matched = iou > iou_thresh
        m = int(matched.sum())
        tp += m
        fp += inter.shape[0] - int(matched.any(1).sum())
        fn += inter.shape[1] - int(matched.any(0).sum())
        iou_sum += float(iou[matched].sum())
    sq = iou_sum / tp if tp else 0.0
    denom = tp + 0.5 * fp + 0.5 * fn
    rq = tp / denom if denom else (1.0 if fp == fn == 0 else 0.0)
    return {"PQ": sq * rq, "SQ": sq, "RQ": rq,
            "TP": tp, "FP": fp, "FN": fn}
