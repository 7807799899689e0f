"""Evaluation CLI of the port: counterpart of kgtpu's `eval.py`.

    python -m kgtpu_torch.cli.eval --pred_dir results --dataset dsb2018 \\
        --gt_dir stage1_train --protocol all

Compares <pred_dir>/<id>_label.png and the scores of detections.json against
the dataset's ground truth, resized to the canvas the predictions were made
on, and prints one JSON line of metrics.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np

from kgtpu_torch import evaluate
from kgtpu_torch.config import Config, build_eval_parser
from kgtpu_torch.data.png import read_png
from kgtpu_torch.data.transforms import resize_label_nearest


def records(pred_dir: str, gt_by_id: dict, input_size: int) -> list[dict]:
    """The per-image records of `evaluate` for every image of
    <pred_dir>/detections.json with a ground truth in `gt_by_id`
    ({id: label map at its own size})."""
    with open(os.path.join(pred_dir, "detections.json")) as f:
        summary = json.load(f)
    recs = []
    for rec in summary["images"]:
        iid = rec["id"]
        if iid not in gt_by_id:
            continue
        pred = read_png(os.path.join(pred_dir, f"{iid}_label.png"),
                        "unchanged").astype(np.int32)
        gt = resize_label_nearest(gt_by_id[iid], input_size)
        # scores indexed by label id - 1; the valid detections are slots 0..k
        d = max(int(pred.max()), len(rec["scores"]))
        scores = np.zeros(max(d, 1), np.float32)
        for k, s in enumerate(rec["scores"]):
            scores[k] = s
        recs.append({"pred_label": pred, "scores": scores, "gt_label": gt})
    return recs


def metrics(recs: list[dict], protocol: str = "all") -> dict:
    out = {}
    if protocol in ("dsb2018", "all"):
        out["mAP_dsb2018"] = evaluate.evaluate_dsb2018(recs)["mAP_dsb2018"]
    if protocol in ("coco", "all"):
        out.update(evaluate.evaluate_coco(recs))
    if protocol in ("aji", "all"):
        out["AJI"] = evaluate.evaluate_aji(recs)["AJI"]
    if protocol in ("pq", "all"):
        out.update({k: v for k, v in evaluate.evaluate_pq(recs).items()
                    if k in ("PQ", "SQ", "RQ")})
    return {**out, "num_images": len(recs)}


def main(argv: list[str] | None = None) -> int:
    from kgtpu_torch.data.registry import build_dataset

    args = build_eval_parser().parse_args(argv)
    if args.dataset == "folder":
        raise SystemExit("--dataset folder has no ground truth; every "
                         "metric would be vacuous — evaluate against "
                         "dsb2018/neural_cells/coco/synthetic* instead")
    with open(os.path.join(args.pred_dir, "detections.json")) as f:
        input_size = json.load(f)["input_size"]
    dcfg = dataclasses.replace(Config().data, dataset=args.dataset,
                               data_dir=args.gt_dir, input_size=input_size)
    ds = build_dataset(dcfg, split="test")
    gt_by_id = {}
    for i in range(len(ds)):
        raw = ds[i]
        gt_by_id[raw.get("id", f"img_{i:05d}")] = raw["label_map"]
    print(json.dumps(metrics(records(args.pred_dir, gt_by_id, input_size),
                             args.protocol)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
