"""Inference CLI of the port: counterpart of kgtpu's `test.py`.

    python -m kgtpu_torch.cli.test --dataset folder --data_dir imgs \\
        --weights weights --use_ema --save_dir results [--device cpu]
        [--test_scales 0.75,1.0,1.25 --test_flip] [--ensemble w2,w3]
        [--tiled --tile_size 512 --tile_overlap 64]

Takes `test.py`'s flags, and --device (cuda or cpu) and --compute_dtype
(bfloat16 or float32; default: the checkpoint's, for --weights and every
--ensemble member).  The architecture comes from the checkpoint's stored
config, and flags passed explicitly override it; the checkpoint's parameter
names must match the model built from the result.  --ensemble members
rebuild from their own stored configs (no flag overrides them).  Without
wh-head size pruning, the checkpoint's dataset stats set a size cap
(`predictor.size_prior_fallback`).

Three loops, as in test.py: single-scale, and TTA or ensemble, run images
in batches of --batch_size, the last one padded with copies of its last
image (TTA: one stack per scale, side = round(input_size * scale / divisor)
* divisor, each resized from the raw image); --tiled serves each image at
--input_size as one slide of tiles and renumbers its label ids to 1..P.
Writes, per image:

  <save_dir>/<id>_label.png   uint16 instance label map (0 = background,
                              id k + 1 = slot k of the detections)
  <save_dir>/<id>.json        {"id", "boxes", "scores", "num_instances"}
                              of the valid detections, in slot order

and <save_dir>/detections.json with all of them; --coco_json adds a COCO
results file.  --profile_dir writes a torch.profiler trace.  Conflicting
flags exit with test.py's messages; paths that are not ported raise
SystemExit naming their ROADMAP item by its title: --ngpus > 1 (data
parallelism), --save_vis and --debug_nans (debugging, profiling and
visualisation).
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


def _refuse(args, cfg, ensemble: list[str]) -> None:
    """test.py's exclusive flags, with its messages, then the paths that are
    not ported."""
    if ensemble:
        if not cfg.infer.weights:
            raise SystemExit("--ensemble needs --weights (the mask member)")
        if args.tiled:
            raise SystemExit("--ensemble and --tiled are exclusive")
    if args.tiled and (cfg.infer.test_scales != (1.0,) or cfg.infer.test_flip):
        raise SystemExit("--tiled and multi-scale --test_scales are exclusive")
    unported = [
        (args.num_devices > 1,
         "--ngpus > 1 (data-parallel inference) is ROADMAP §1: data parallelism"),
        (args.save_vis,
         "--save_vis (overlays) is ROADMAP §1: debugging, profiling and visualisation"),
        (args.debug_nans,
         "--debug_nans is ROADMAP §1: debugging, profiling and visualisation"),
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


def load_member(path: str, args):
    """An --ensemble member from its own stored config (--use_ema and
    --compute_dtype apply; no other flag does)."""
    from kgtpu_torch.models import KGNet

    state_dict, extra = checkpoint.restore_bundle(path, use_ema=args.use_ema)
    stored = checkpoint.decode_config(extra)
    if stored is None:
        raise SystemExit(f"--ensemble member {path} has no self-describing "
                         "config; re-save it with this repo's train.py")
    mcfg = stored.model
    if args.compute_dtype:
        mcfg = dataclasses.replace(mcfg, compute_dtype=args.compute_dtype)
    model = KGNet(mcfg)
    model.load_state_dict(state_dict, strict=True)
    log.info("ensemble member %s: backbone=%s", path, mcfg.backbone)
    return model


def renumber(label: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(label map with its ids renumbered to 1..P in ascending order, the
    old ids [P])."""
    ids = np.unique(label)
    ids = ids[ids > 0].astype(np.int32)
    relab = np.where(label > 0, np.searchsorted(ids, label) + 1, 0).astype(label.dtype)
    return relab, ids


def main(argv: list[str] | None = None) -> int:
    parser = build_test_parser()
    args = parser.parse_args(argv)
    cfg = config_from_test_args(args)
    ensemble = [x for x in args.ensemble.split(",") if x]
    _refuse(args, cfg, ensemble)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")

    from kgtpu_torch.coco_export import write_coco_json
    from kgtpu_torch.data.loader import prepare_sample
    from kgtpu_torch.data.png import write_png
    from kgtpu_torch.data.registry import build_dataset
    from kgtpu_torch.device import resolve_device
    from kgtpu_torch.infer import (build_ensemble_fn, build_infer_fn,
                                   build_multiscale_fn, build_tiled_infer_fn)

    device = resolve_device(args.device)
    cfg, model = load_model(cfg, args, parser, argv)
    members = [load_member(w, args) for w in ensemble]
    divisor = max([required_divisor(cfg.model)] + [required_divisor(m.cfg) for m in members])
    # tiled: the network sees tile_size tiles; only their side must divide
    side, side_flag = ((cfg.infer.tile_size, "--tile_size") if args.tiled
                       else (cfg.infer.input_size, "--input_size"))
    if side % divisor:
        raise SystemExit(
            f"{side_flag} {side} must be divisible by {divisor} for backbone "
            f"{cfg.model.backbone} (hg_depth {cfg.model.hg_depth}); TTA scale sides "
            f"are rounded to multiples automatically")
    base = cfg.infer.input_size
    scales = cfg.infer.test_scales
    multiscale = scales != (1.0,) or cfg.infer.test_flip
    if args.tiled:
        infer = build_tiled_infer_fn(model, cfg, (base, base), device=device)
    elif members:
        infer = build_ensemble_fn([model] + members, cfg, mask_member=0, device=device)
    elif multiscale:
        infer = build_multiscale_fn(model, cfg, device=device)
    else:
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

    def fetch(out):
        return {k: v.cpu().numpy() for k, v in out.items()
                if k in ("label_map", "boxes", "scores", "valid")}

    summary = []
    t0 = time.time()
    bs = max(cfg.infer.batch_size, 1)
    with profiler:
        if args.tiled:
            for i in range(len(ds)):
                raw = ds[i]
                iid = raw.get("id", f"img_{i:05d}")
                out = fetch(infer(prepare_sample(raw, cfg.data)["image"]))
                # ids t * D + d + 1 -> 1..P; scores and boxes aligned to them
                relab, ids = renumber(out["label_map"])
                summary.append(write_result(iid, relab, out["boxes"][ids - 1],
                                            out["scores"][ids - 1],
                                            np.ones(len(ids), bool)))
                log.info("%d/%d (%.2f slides/s)", i + 1, len(ds),
                         (i + 1) / max(time.time() - t0, 1e-6))
        else:
            for start in range(0, len(ds), bs):
                idxs = list(range(start, min(start + bs, len(ds))))
                raws = [ds[i] for i in idxs]
                if multiscale or members:
                    imgs = {}
                    for sc in scales:
                        dcfg = dataclasses.replace(
                            cfg.data, input_size=max(round(base * sc / divisor), 1) * divisor)
                        stack = [prepare_sample(raw, dcfg)["image"] for raw in raws]
                        imgs[f"{sc:g}"] = np.stack(stack + [stack[-1]] * (bs - len(stack)))
                else:
                    stack = [prepare_sample(raw, cfg.data)["image"] for raw in raws]
                    imgs = np.stack(stack + [stack[-1]] * (bs - len(stack)))
                out = fetch(infer(imgs))
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
        json.dump({"images": summary, "input_size": base,
                   "test_scales": list(scales), "ensemble": ensemble}, f)
    if coco_records is not None:
        n = write_coco_json(args.coco_json, coco_records)
        log.info("wrote %d COCO instance records to %s", n, args.coco_json)
    log.info("wrote %d results to %s (%.2f img/s end-to-end)", len(summary),
             save_dir, len(summary) / max(time.time() - t0, 1e-6))
    return 0


if __name__ == "__main__":
    sys.exit(main())
