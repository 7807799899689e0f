#!/usr/bin/env python
"""Make the evaluation assets of the PyTorch port under assets_torch/.

    python tools/make_torch_eval_assets.py [--out assets_torch]

Runs on the CPU where jax, orbax, cv2 and kgtpu are installed, and writes
what the port needs to serve and score the trained flagship where none of
them is:

  flagship_ema/model_99/     runs/kg_hard1024/model_99's EMA parameters in
                             the port's checkpoint format, f32, params only
                             (tools/orbax_to_torch.py --use_ema --params_only)
  synthetic_hard/images/     the synthetic_hard test split that `test.py
                             --dataset synthetic_hard` serves at 512x512
                             (SyntheticCells(size=512, num_images=16, seed=13,
                             hard=True)) as RGB PNG, <id>.png
  synthetic_hard/labels/     its ground-truth label maps, uint16 PNG, <id>.png
  kgtpu_reference.npz        kgtpu's own run on those PNGs on the CPU, as
                             its test.py serves them (stored architecture,
                             --use_ema, default inference settings, batch 4),
                             once per compute dtype (the stored bfloat16 and
                             float32): label maps `labels_<dtype>` [16, 512,
                             512] uint16, valid instances `counts_<dtype>`
                             [16], `ids`, and `metrics_json`: eval.py's
                             metrics of each run (mAP_dsb2018, COCO AP, AJI,
                             PQ) against the ground truth, with kgtpu's
                             NumPy IoU (its compiled IoU op is switched off).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
FLAGSHIP = os.path.join(ROOT, "runs", "kg_hard1024", "model_99")
BATCH = 4


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=os.path.join(ROOT, "assets_torch"))
    out = p.parse_args(argv).out

    import jax
    jax.config.update("jax_platforms", "cpu")
    import cv2
    import jax.numpy as jnp
    import numpy as np

    from kgtpu import checkpoint, evaluate, native
    from kgtpu.config import Config
    from kgtpu.data.folder import ImageFolder
    from kgtpu.data.loader import _prepare_sample
    from kgtpu.data.synthetic import SyntheticCells
    from kgtpu.infer import build_infer_fn
    from kgtpu.models import KGNet
    from tools.orbax_to_torch import convert

    print(convert(FLAGSHIP, os.path.join(out, "flagship_ema"), use_ema=True,
                  params_only=True))

    img_dir = os.path.join(out, "synthetic_hard", "images")
    lab_dir = os.path.join(out, "synthetic_hard", "labels")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(lab_dir, exist_ok=True)
    ds = SyntheticCells(size=512, num_images=16, seed=13, hard=True)
    gt = {}
    for i in range(len(ds)):
        s = ds[i]
        cv2.imwrite(os.path.join(img_dir, f"{s['id']}.png"),
                    cv2.cvtColor(s["image"], cv2.COLOR_RGB2BGR))
        cv2.imwrite(os.path.join(lab_dir, f"{s['id']}.png"),
                    s["label_map"].astype(np.uint16))
        gt[s["id"]] = s["label_map"]

    # the metric's semantics are kgtpu's NumPy IoU (f64); its compiled IoU op
    # rounds IoUs to f32, which moves matches that lie on a threshold
    native.label_map_iou = lambda pred, gt: None
    params, extra = checkpoint.restore_bundle(FLAGSHIP, use_ema=True)
    stored = checkpoint.decode_config(extra)
    folder = ImageFolder(img_dir)
    ids = [folder[i]["id"] for i in range(len(folder))]
    result = {"ids": np.array(ids)}
    metrics = {"source": "tools/make_torch_eval_assets.py", "jax": jax.__version__,
               "cv2": cv2.__version__, "weights": "runs/kg_hard1024/model_99 (EMA)"}
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(Config(), model=dataclasses.replace(
            stored.model, compute_dtype=dtype))
        infer = build_infer_fn(KGNet(cfg=cfg.model), cfg)
        rng = np.random.default_rng(0)
        labels, counts, recs = [], [], []
        for start in range(0, len(folder), BATCH):
            raws = [folder[i] for i in range(start, min(start + BATCH, len(folder)))]
            imgs = np.stack([_prepare_sample(r, cfg.data, augment=False, rng=rng,
                                             image_only=True)["image"] for r in raws])
            o = infer(params, jnp.asarray(imgs))
            for k, raw in enumerate(raws):
                lab = np.asarray(o["label_map"][k]).astype(np.uint16)
                valid = np.asarray(o["valid"][k])
                kept = np.asarray(o["scores"][k])[valid]
                labels.append(lab)
                counts.append(int(valid.sum()))
                # eval.py's record: scores of the valid slots, indexed by id - 1
                scores = np.zeros(max(int(lab.max()), len(kept), 1), np.float32)
                scores[:len(kept)] = kept
                recs.append({"pred_label": lab.astype(np.int32), "scores": scores,
                             "gt_label": gt[raw["id"]]})
        m = {"mAP_dsb2018": evaluate.evaluate_dsb2018(recs)["mAP_dsb2018"],
             **evaluate.evaluate_coco(recs),
             "AJI": evaluate.evaluate_aji(recs)["AJI"],
             **{k: v for k, v in evaluate.evaluate_pq(recs).items()
                if k in ("PQ", "SQ", "RQ")}}
        metrics[dtype] = m
        result[f"labels_{dtype}"] = np.stack(labels)
        result[f"counts_{dtype}"] = np.array(counts, np.int32)
        print(dtype, counts, json.dumps(m))
    result["metrics_json"] = np.array(json.dumps(metrics))
    np.savez_compressed(os.path.join(out, "kgtpu_reference.npz"), **result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
