"""Inference CLI of the port: counterpart of kgtpu's `test.py`, single-scale.

    python -m kgtpu_torch.cli.test --dataset folder --data_dir imgs \\
        --weights weights --use_ema --save_dir results [--device cpu]

Takes `test.py`'s flags, and --device (cuda or cpu) and --compute_dtype
(bfloat16 or float32; default: the checkpoint's).  The architecture comes from the checkpoint's stored
config, and flags passed explicitly override it; the checkpoint's parameter
names must match the model built from the result.  Without wh-head size
pruning, the checkpoint's dataset stats set a size cap
(`predictor.size_prior_fallback`).  Images run in batches of --batch_size,
the last one padded with copies of its last image.  Writes, per image:

  <save_dir>/<id>_label.png   uint16 instance label map (0 = background,
                              id k + 1 = slot k of the detections)
  <save_dir>/<id>.json        {"id", "boxes", "scores", "num_instances"}
                              of the valid detections, in slot order

and <save_dir>/detections.json with all of them; --coco_json adds a COCO
results file.  --profile_dir writes a torch.profiler trace.  Paths that are
not ported raise SystemExit naming their ROADMAP item: --tiled (7),
--test_scales other than 1 and --test_flip and --ensemble (6), --ngpus > 1
(9), --save_vis and --debug_nans (10).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import sys
import time

import numpy as np
import torch

from kgtpu_torch import checkpoint
from kgtpu_torch.config import (apply_model_overrides, build_test_parser,
                                config_from_test_args, explicit_cli_dests,
                                required_divisor)

log = logging.getLogger("kgtpu_torch.test")


def _refuse_unported(args, cfg) -> None:
    unported = [
        (args.tiled, "--tiled (whole-slide tiling) is ROADMAP item 7"),
        (cfg.infer.test_scales != (1.0,),
         "--test_scales other than 1.0 (multi-scale TTA) is ROADMAP item 6"),
        (args.test_flip, "--test_flip (flip TTA) is ROADMAP item 6"),
        (bool(args.ensemble), "--ensemble is ROADMAP item 6"),
        (args.num_devices > 1, "--ngpus > 1 (data-parallel inference) is ROADMAP item 9"),
        (args.save_vis, "--save_vis (overlays) is ROADMAP item 10"),
        (args.debug_nans, "--debug_nans is ROADMAP item 10"),
    ]
    for bad, msg in unported:
        if bad:
            raise SystemExit(f"not ported yet: {msg}")


def load_model(cfg, args, parser, argv):
    """(cfg, model) from --weights (or seeded random weights without it)."""
    from kgtpu_torch.models import KGNet, build_model
    from kgtpu_torch.predictor import size_prior_fallback

    state_dict, extra = {}, {}
    if cfg.infer.weights:
        state_dict, extra = checkpoint.restore_bundle(cfg.infer.weights,
                                                      use_ema=args.use_ema)
        stored = checkpoint.decode_config(extra)
        if stored is not None:
            explicit = explicit_cli_dests(parser, argv)
            cfg = dataclasses.replace(
                cfg, model=apply_model_overrides(stored.model, args, explicit))
            log.info("model architecture from checkpoint config: backbone=%s "
                     "num_stacks=%d norm=%s roi_size=%d (explicit CLI flags "
                     "override)", cfg.model.backbone, cfg.model.num_stacks,
                     cfg.model.norm, cfg.model.roi_size)
    if args.compute_dtype:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, compute_dtype=args.compute_dtype))
    if not cfg.infer.weights:
        log.warning("no --weights given: running with random init")
        return cfg, build_model(cfg.model, seed=0, device="cpu")
    model = KGNet(cfg.model)
    want, got = set(model.state_dict()), set(state_dict)
    if want != got:
        raise SystemExit(
            f"checkpoint {cfg.infer.weights} does not match the model built "
            f"from the CLI flags (--backbone {cfg.model.backbone}, --norm "
            f"{cfg.model.norm}, --num_stacks {cfg.model.num_stacks}).\n"
            f"  sample missing keys: {sorted(want - got)[:5]}\n"
            f"  sample extra keys: {sorted(got - want)[:5]}")
    model.load_state_dict(state_dict, strict=True)
    log.info("loaded weights from %s%s", cfg.infer.weights,
             " (EMA)" if args.use_ema else "")
    capped = size_prior_fallback(cfg, extra)
    if capped != cfg:
        log.info("size prior from checkpoint stats: max box side %.1f stride px",
                 capped.group.max_box_size)
    return capped, model


def main(argv: list[str] | None = None) -> int:
    parser = build_test_parser()
    args = parser.parse_args(argv)
    cfg = config_from_test_args(args)
    _refuse_unported(args, cfg)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")

    from kgtpu_torch.coco_export import write_coco_json
    from kgtpu_torch.data.loader import prepare_sample
    from kgtpu_torch.data.png import write_png
    from kgtpu_torch.data.registry import build_dataset
    from kgtpu_torch.device import resolve_device
    from kgtpu_torch.infer import build_infer_fn

    device = resolve_device(args.device)
    cfg, model = load_model(cfg, args, parser, argv)
    divisor = required_divisor(cfg.model)
    if cfg.infer.input_size % divisor:
        raise SystemExit(
            f"--input_size {cfg.infer.input_size} must be divisible by "
            f"{divisor} for backbone {cfg.model.backbone} (hg_depth "
            f"{cfg.model.hg_depth})")
    infer = build_infer_fn(model, cfg, device=device)
    ds = build_dataset(cfg.data, split="test")
    save_dir = cfg.infer.save_dir
    os.makedirs(save_dir, exist_ok=True)
    coco_records = [] if args.coco_json else None

    profiler = contextlib.nullcontext()
    if args.profile_dir:
        from torch.profiler import ProfilerActivity, profile
        profiler = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else []))

    def write_result(iid, label, boxes, scores, valid):
        if coco_records is not None:
            # slot-aligned full arrays: label id i + 1 <-> boxes[i], scores[i]
            coco_records.append({"id": iid, "label_map": label,
                                 "boxes": boxes, "scores": scores})
        write_png(os.path.join(save_dir, f"{iid}_label.png"), label.astype(np.uint16))
        rec = {"id": iid, "boxes": boxes[valid].tolist(),
               "scores": scores[valid].tolist(), "num_instances": int(valid.sum())}
        with open(os.path.join(save_dir, f"{iid}.json"), "w") as f:
            json.dump(rec, f)
        return rec

    summary = []
    t0 = time.time()
    bs = max(cfg.infer.batch_size, 1)
    with profiler:
        for start in range(0, len(ds), bs):
            idxs = list(range(start, min(start + bs, len(ds))))
            raws = [ds[i] for i in idxs]
            samples = [prepare_sample(raw, cfg.data) for raw in raws]
            imgs = np.stack([s["image"] for s in samples]
                            + [samples[-1]["image"]] * (bs - len(samples)))
            out = {k: v.cpu().numpy() for k, v in infer(imgs).items()
                   if k in ("label_map", "boxes", "scores", "valid")}
            for k, i in enumerate(idxs):
                iid = raws[k].get("id", f"img_{i:05d}")
                summary.append(write_result(iid, out["label_map"][k], out["boxes"][k],
                                            out["scores"][k], out["valid"][k]))
            log.info("%d/%d (%.2f img/s)", len(summary), len(ds),
                     len(summary) / max(time.time() - t0, 1e-6))

    if args.profile_dir:
        os.makedirs(args.profile_dir, exist_ok=True)
        profiler.export_chrome_trace(os.path.join(args.profile_dir, "trace.json"))
    with open(os.path.join(save_dir, "detections.json"), "w") as f:
        json.dump({"images": summary, "input_size": cfg.infer.input_size,
                   "test_scales": list(cfg.infer.test_scales), "ensemble": []}, f)
    if coco_records is not None:
        n = write_coco_json(args.coco_json, coco_records)
        log.info("wrote %d COCO instance records to %s", n, args.coco_json)
    log.info("wrote %d results to %s (%.2f img/s end-to-end)", len(summary),
             save_dir, len(summary) / max(time.time() - t0, 1e-6))
    return 0


if __name__ == "__main__":
    sys.exit(main())
