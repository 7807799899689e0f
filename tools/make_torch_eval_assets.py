#!/usr/bin/env python
"""Make the evaluation assets of the PyTorch port under assets_torch/.

    python tools/make_torch_eval_assets.py [--out assets_torch] [--only tta]

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
                             default IoU (its compiled f32 op).
  flagship_raw/model_99/     the flagship's raw (non-EMA) parameters, f32,
                             params only (tools/orbax_to_torch.py
                             --params_only): the second ensemble member
  kgtpu_reference_tta.npz    kgtpu's own f32 runs on the CPU of three
                             configurations, with test.py's loops and flags
                             (TTA_FLAGS): "tta" (--test_scales 0.75,1.0,1.25
                             --test_flip --use_ema, mean vote, batch 8, the
                             16 images), "ensemble" (the EMA weights as the
                             mask member plus the raw weights, --test_scales
                             1.0, mean vote, batch 8) and "tiled" (--tiled
                             --input_size 1024, tiles of 512 with overlap 64,
                             on four 1024x1024 slides: 2x2 mosaics of the
                             images in id order, `mosaic`).  Per
                             configuration: `labels_<c>` uint16 label maps,
                             `counts_<c>` valid instances, `ids_<c>`, and
                             `metrics_json` with each run's metrics against
                             the ground truth (for a slide: the mosaic of
                             its images' label maps, ids offset per quadrant)
                             and its flags.

  unet_ema/model_99/         runs/kg_unet1024/model_99's EMA parameters (the
                             unet quality flagship), f32, params only
                             (tools/orbax_to_torch.py --use_ema --params_only)
  kgtpu_reference_unet.npz   kgtpu's own runs on the CPU of two
                             configurations on the 16 images, each in
                             float32 and bfloat16 (every member at that
                             compute dtype), with test.py's loops and flags
                             (UNET_FLAGS): "unet" (the unet flagship,
                             --use_ema, single-scale, batch 4) and
                             "ensemble" (--weights the unet, --ensemble the
                             hourglass flagship, --use_ema, mean vote,
                             batch 8).  Per configuration c and dtype d:
                             `labels_<c>_<d>`, `counts_<c>_<d>`, and
                             `metrics_json` (the metrics against the ground
                             truth, with kgtpu's default IoU) with `ids`.

--only tta writes flagship_raw and kgtpu_reference_tta.npz alone, --only
unet writes unet_ema and kgtpu_reference_unet.npz alone, each from the
committed images and labels, and leave the rest as it is.

--only rescore runs no model: it recomputes the metrics of every run stored
in kgtpu_reference.npz, kgtpu_reference_tta.npz, kgtpu_reference_unet.npz
and kgtpu_reference_formats.npz with kgtpu's default evaluate from the label
maps and ground truth they hold (`rescore`).
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
UNET = os.path.join(ROOT, "runs", "kg_unet1024", "model_99")
BATCH = 4
# test.py's flags of each configuration of kgtpu_reference_tta.npz (the
# data dir and weights come first)
TTA_FLAGS = {
    "tta": ["--use_ema", "--test_scales", "0.75,1.0,1.25", "--test_flip",
            "--batch_size", "8"],
    "ensemble": ["--use_ema", "--ensemble", "assets_torch/flagship_raw", "--test_scales",
                 "1.0", "--batch_size", "8"],
    "tiled": ["--use_ema", "--tiled", "--input_size", "1024"],
}


# test.py's flags of each configuration of kgtpu_reference_unet.npz (the
# data dir and --weights UNET come first)
UNET_FLAGS = {
    "unet": ["--use_ema", "--batch_size", str(BATCH)],
    "ensemble": ["--use_ema", "--ensemble", "assets_torch/flagship_ema", "--tta_vote", "mean",
                 "--test_scales", "1.0", "--batch_size", "8"],
}


def mosaic(tiles: list, rows: int):
    """rows x rows mosaic of equal [H, W, ...] arrays, row-major."""
    import numpy as np
    return np.concatenate([np.concatenate(tiles[r * rows:(r + 1) * rows], axis=1)
                           for r in range(rows)], axis=0)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=os.path.join(ROOT, "assets_torch"))
    p.add_argument("--only", default="", choices=["", "tta", "unet", "rescore"],
                   help="tta: write flagship_raw and kgtpu_reference_tta.npz alone; "
                        "unet: unet_ema and kgtpu_reference_unet.npz alone; rescore: "
                        "recompute the stored metrics from the stored label maps")
    a = p.parse_args(argv)
    out = a.out
    if a.only == "rescore":
        return rescore(out)
    if a.only == "tta":
        return make_tta_reference(out)
    if a.only == "unet":
        return make_unet_reference(out)

    import jax
    jax.config.update("jax_platforms", "cpu")
    import cv2
    import jax.numpy as jnp
    import numpy as np

    from kgtpu import checkpoint, evaluate
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
    return make_tta_reference(out)


def rescore(out: str) -> int:
    """Every stored run's metrics again, with kgtpu's default evaluate (its
    compiled IoU op, f32 IoUs), from the stored label maps and the ground
    truth (synthetic_hard/labels; the tiled slides' mosaics).

    The files hold no scores, but a kgtpu label map's ids follow its score
    order (slot k <-> id k + 1, slots ranked by score), which is all the
    per-image greedy matching reads: with scores falling by id, the metrics
    of each run with f64 IoUs equal the stored ones bit for bit (checked
    here).  So mAP_dsb2018 is recomputed exactly; AJI and PQ do not read
    the IoU op and stay; COCO AP ranks detections across images by score,
    so AP_coco, AP50 and AP75 stay where no match at their thresholds moves
    and become null where one does (the scores that would place it are not
    stored).  Writes the files in place; prints each change."""
    import cv2
    import numpy as np

    from kgtpu import evaluate, native

    lab_dir = os.path.join(out, "synthetic_hard", "labels")
    ids = sorted(f[:-4] for f in os.listdir(lab_dir))
    gt = {i: cv2.imread(os.path.join(lab_dir, f"{i}.png"), cv2.IMREAD_UNCHANGED)
          .astype(np.int32) for i in ids}
    for k in range(len(ids) // 4):
        labs, off = [], 0
        for i in ids[4 * k:4 * k + 4]:
            labs.append(np.where(gt[i] > 0, gt[i] + off, 0))
            off += int(gt[i].max())
        gt[f"slide_{k}"] = mosaic(labs, 2)
    compiled = native.label_map_iou

    def flags(recs: list, f64: bool) -> list:
        native.label_map_iou = (lambda pred, g: None) if f64 else compiled
        try:
            return [evaluate.greedy_tp_flags(*evaluate._rec_iou(r)[:2])
                    if evaluate._rec_iou(r)[2] else None for r in recs]
        finally:
            native.label_map_iou = compiled

    def run(name: str, labels, names, m: dict) -> None:
        recs = []
        for lab, i in zip(labels, names):
            lab = lab.astype(np.int32)
            n = max(int(lab.max()), 1)
            recs.append({"pred_label": lab, "gt_label": gt[str(i)],
                         "scores": (1.0 - np.arange(n) / (2.0 * n)).astype(np.float32)})
        native.label_map_iou = lambda pred, g: None
        try:
            old = evaluate.evaluate_dsb2018(recs)["mAP_dsb2018"]
        finally:
            native.label_map_iou = compiled
        assert old == m["mAP_dsb2018"], (name, old, m["mAP_dsb2018"])
        moved = set()
        for a, b in zip(flags(recs, True), flags(recs, False)):
            if a is not None:
                moved |= {int(t) for t in np.nonzero((a != b).any(1))[0]}
        new = dict(m, mAP_dsb2018=evaluate.evaluate_dsb2018(recs)["mAP_dsb2018"])
        if moved:
            new["AP_coco"] = None
        if 0 in moved:
            new["AP50"] = None
        if 5 in moved:
            new["AP75"] = None
        new["iou"] = "f32 (kgtpu's compiled op)"
        for key in m:
            if new[key] != m[key]:
                print(f"{name}: {key} {m[key]!r} -> {new[key]!r}")
        m.clear()
        m.update(new)

    def rewrite(fname: str, runs) -> None:
        path = os.path.join(out, fname)
        with np.load(path) as z:
            data = {k: z[k] for k in z.files}
        for key, names in runs:
            metrics = json.loads(str(data[key]))
            for name in names:
                prefix = key[:-len("metrics_json")]
                stem = f"{prefix}{name}" if prefix else name
                ids_key = (f"ids_{name}" if f"ids_{name}" in data
                           else f"{prefix}ids")
                run(f"{fname} {stem}", data[f"labels_{stem}"], data[ids_key], metrics[name])
            data[key] = np.array(json.dumps(metrics))
        np.savez_compressed(path, **data)

    rewrite("kgtpu_reference.npz", [("metrics_json", ["bfloat16", "float32"])])
    rewrite("kgtpu_reference_tta.npz", [("metrics_json", ["tta", "ensemble", "tiled"])])
    rewrite("kgtpu_reference_unet.npz", [("metrics_json", [
        "unet_float32", "unet_bfloat16", "ensemble_float32", "ensemble_bfloat16"])])
    rewrite("kgtpu_reference_formats.npz", [("metrics_json", ["bfloat16", "float32"])] + [
        (f"{key}_metrics_json", ["bfloat16", "float32"])
        for key in ("variants", "containers", "jpeg2000", "variants2")])
    return 0


def _score(evaluate, recs: list) -> dict:
    return {"mAP_dsb2018": evaluate.evaluate_dsb2018(recs)["mAP_dsb2018"],
            **evaluate.evaluate_coco(recs),
            "AJI": evaluate.evaluate_aji(recs)["AJI"],
            **{k: v for k, v in evaluate.evaluate_pq(recs).items()
               if k in ("PQ", "SQ", "RQ")}}


def make_tta_reference(out: str) -> int:
    """flagship_raw and kgtpu_reference_tta.npz (module docstring)."""
    import tempfile

    import jax
    jax.config.update("jax_platforms", "cpu")
    import cv2
    import jax.numpy as jnp
    import numpy as np

    from kgtpu import checkpoint, evaluate
    from kgtpu.config import build_test_parser, config_from_test_args
    from kgtpu.data.folder import ImageFolder
    from kgtpu.data.loader import _prepare_sample
    from kgtpu.infer import build_ensemble_fn, build_multiscale_fn, build_tiled_infer_fn
    from kgtpu.models import KGNet, required_divisor
    from tools.orbax_to_torch import convert

    print(convert(FLAGSHIP, os.path.join(out, "flagship_raw"), params_only=True))
    img_dir = os.path.join(out, "synthetic_hard", "images")
    lab_dir = os.path.join(out, "synthetic_hard", "labels")
    images = ImageFolder(img_dir)
    ids = [images[i]["id"] for i in range(len(images))]
    gt = {i: cv2.imread(os.path.join(lab_dir, f"{i}.png"), cv2.IMREAD_UNCHANGED)
          .astype(np.int32) for i in ids}
    ema, extra = checkpoint.restore_bundle(FLAGSHIP, use_ema=True)
    raw, _ = checkpoint.restore_bundle(FLAGSHIP, use_ema=False)
    stored = checkpoint.decode_config(extra)
    model_cfg = dataclasses.replace(stored.model, compute_dtype="float32")
    result, metrics = {}, {"source": "tools/make_torch_eval_assets.py --only tta",
                           "jax": jax.__version__, "cv2": cv2.__version__,
                           "weights": "runs/kg_hard1024/model_99 (EMA; ensemble: + raw)",
                           "compute_dtype": "float32"}
    with tempfile.TemporaryDirectory() as tmp:
        slide_dir = os.path.join(tmp, "slides")
        os.makedirs(slide_dir)
        slide_gt = {}
        for k in range(len(ids) // 4):
            quad = ids[4 * k:4 * k + 4]
            pixels = [cv2.imread(os.path.join(img_dir, f"{i}.png"), cv2.IMREAD_COLOR)
                      for i in quad]
            cv2.imwrite(os.path.join(slide_dir, f"slide_{k}.png"), mosaic(pixels, 2))
            labs, off = [], 0
            for i in quad:
                labs.append(np.where(gt[i] > 0, gt[i] + off, 0))
                off += int(gt[i].max())
            slide_gt[f"slide_{k}"] = mosaic(labs, 2)

        for name, flags in TTA_FLAGS.items():
            data_dir = slide_dir if name == "tiled" else img_dir
            argv = ["--dataset", "folder", "--data_dir", data_dir, "--weights", FLAGSHIP]
            cfg = config_from_test_args(build_test_parser().parse_args(argv + flags))
            cfg = dataclasses.replace(cfg, model=model_cfg)
            model = KGNet(cfg=model_cfg)
            ds = ImageFolder(data_dir)
            base = cfg.infer.input_size
            divisor = required_divisor(model_cfg)
            rng = np.random.default_rng(0)
            labels, counts, recs, names = [], [], [], []
            if name == "tiled":
                infer = build_tiled_infer_fn(model, cfg, (base, base))
                for i in range(len(ds)):
                    r = ds[i]
                    o = infer(ema, _prepare_sample(r, cfg.data, augment=False, rng=rng,
                                                   image_only=True)["image"])
                    lab = np.asarray(o["label_map"])
                    u = np.unique(lab)
                    u = u[u > 0].astype(np.int32)
                    relab = np.zeros_like(lab)          # test.py's NumPy renumbering
                    for n, oid in enumerate(u):
                        relab[lab == oid] = n + 1
                    scores = np.asarray(o["scores"])[u - 1]
                    labels.append(relab.astype(np.uint16))
                    counts.append(len(u))
                    names.append(r["id"])
                    recs.append({"pred_label": relab.astype(np.int32),
                                 "scores": np.concatenate([scores, np.zeros(1, np.float32)]),
                                 "gt_label": slide_gt[r["id"]]})
            else:
                if name == "ensemble":
                    ens = build_ensemble_fn([model, KGNet(cfg=model_cfg)], cfg, mask_member=0)
                    infer = lambda imgs: ens([ema, raw], imgs)  # noqa: E731
                else:
                    ms = build_multiscale_fn(model, cfg)
                    infer = lambda imgs: ms(ema, imgs)  # noqa: E731
                bs = cfg.infer.batch_size
                for start in range(0, len(ds), bs):
                    raws = [ds[i] for i in range(start, min(start + bs, len(ds)))]
                    stacks = {}
                    for sc in cfg.infer.test_scales:
                        dcfg = dataclasses.replace(
                            cfg.data, input_size=max(round(base * sc / divisor), 1) * divisor)
                        st = [_prepare_sample(r, dcfg, augment=False, rng=rng,
                                              image_only=True)["image"] for r in raws]
                        stacks[f"{sc:g}"] = jnp.asarray(np.stack(st + [st[-1]] * (bs - len(st))))
                    o = infer(stacks)
                    for k, r in enumerate(raws):
                        lab = np.asarray(o["label_map"][k]).astype(np.uint16)
                        valid = np.asarray(o["valid"][k])
                        kept = np.asarray(o["scores"][k])[valid]
                        labels.append(lab)
                        counts.append(int(valid.sum()))
                        names.append(r["id"])
                        scores = np.zeros(max(int(lab.max()), len(kept), 1), np.float32)
                        scores[:len(kept)] = kept
                        recs.append({"pred_label": lab.astype(np.int32), "scores": scores,
                                     "gt_label": gt[r["id"]]})
            metrics[name] = {**_score(evaluate, recs), "flags": flags}
            result[f"labels_{name}"] = np.stack(labels)
            result[f"counts_{name}"] = np.array(counts, np.int32)
            result[f"ids_{name}"] = np.array(names)
            print(name, counts, json.dumps(metrics[name]), flush=True)
    result["metrics_json"] = np.array(json.dumps(metrics))
    np.savez_compressed(os.path.join(out, "kgtpu_reference_tta.npz"), **result)
    return make_unet_reference(out)


def make_unet_reference(out: str) -> int:
    """unet_ema and kgtpu_reference_unet.npz (module docstring)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import cv2
    import jax.numpy as jnp
    import numpy as np

    from kgtpu import checkpoint, evaluate
    from kgtpu.config import build_test_parser, config_from_test_args
    from kgtpu.data.folder import ImageFolder
    from kgtpu.data.loader import _prepare_sample
    from kgtpu.infer import build_ensemble_fn, build_infer_fn
    from kgtpu.models import KGNet
    from tools.orbax_to_torch import convert

    print(convert(UNET, os.path.join(out, "unet_ema"), use_ema=True, params_only=True))
    img_dir = os.path.join(out, "synthetic_hard", "images")
    lab_dir = os.path.join(out, "synthetic_hard", "labels")
    images = ImageFolder(img_dir)
    ids = [images[i]["id"] for i in range(len(images))]
    gt = {i: cv2.imread(os.path.join(lab_dir, f"{i}.png"), cv2.IMREAD_UNCHANGED)
          .astype(np.int32) for i in ids}
    unet, extra = checkpoint.restore_bundle(UNET, use_ema=True)
    hourglass, hg_extra = checkpoint.restore_bundle(FLAGSHIP, use_ema=True)
    unet_model = checkpoint.decode_config(extra).model
    hg_model = checkpoint.decode_config(hg_extra).model
    result = {"ids": np.array(ids)}
    metrics = {"source": "tools/make_torch_eval_assets.py --only unet",
               "jax": jax.__version__, "cv2": cv2.__version__,
               "weights": "runs/kg_unet1024/model_99 (EMA); ensemble: + "
                          "runs/kg_hard1024/model_99 (EMA)"}
    for name, flags in UNET_FLAGS.items():
        argv = ["--dataset", "folder", "--data_dir", img_dir, "--weights", UNET]
        base_cfg = config_from_test_args(build_test_parser().parse_args(argv + flags))
        for dtype in ("float32", "bfloat16"):
            mcfg = dataclasses.replace(unet_model, compute_dtype=dtype)
            cfg = dataclasses.replace(base_cfg, model=mcfg)
            if name == "ensemble":
                hcfg = dataclasses.replace(hg_model, compute_dtype=dtype)
                ens = build_ensemble_fn([KGNet(cfg=mcfg), KGNet(cfg=hcfg)], cfg,
                                        mask_member=0)
                infer = lambda imgs: ens([unet, hourglass], {"1": imgs})  # noqa: E731
            else:
                single = build_infer_fn(KGNet(cfg=mcfg), cfg)
                infer = lambda imgs: single(unet, imgs)  # noqa: E731
            bs = cfg.infer.batch_size
            rng = np.random.default_rng(0)
            labels, counts, recs = [], [], []
            for start in range(0, len(images), bs):
                raws = [images[i] for i in range(start, min(start + bs, len(images)))]
                st = [_prepare_sample(r, cfg.data, augment=False, rng=rng,
                                      image_only=True)["image"] for r in raws]
                o = infer(jnp.asarray(np.stack(st + [st[-1]] * (bs - len(st)))))
                for k, r in enumerate(raws):
                    lab = np.asarray(o["label_map"][k]).astype(np.uint16)
                    valid = np.asarray(o["valid"][k])
                    kept = np.asarray(o["scores"][k])[valid]
                    labels.append(lab)
                    counts.append(int(valid.sum()))
                    scores = np.zeros(max(int(lab.max()), len(kept), 1), np.float32)
                    scores[:len(kept)] = kept
                    recs.append({"pred_label": lab.astype(np.int32), "scores": scores,
                                 "gt_label": gt[r["id"]]})
            metrics[f"{name}_{dtype}"] = {**_score(evaluate, recs), "flags": flags}
            result[f"labels_{name}_{dtype}"] = np.stack(labels)
            result[f"counts_{name}_{dtype}"] = np.array(counts, np.int32)
            print(name, dtype, counts, json.dumps(metrics[f"{name}_{dtype}"]), flush=True)
    result["metrics_json"] = np.array(json.dumps(metrics))
    np.savez_compressed(os.path.join(out, "kgtpu_reference_unet.npz"), **result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
