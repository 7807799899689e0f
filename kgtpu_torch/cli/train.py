"""Training CLI of the port: counterpart of kgtpu's `train.py`.

    python -m kgtpu_torch.cli.train --dataset synthetic_hard --ema_decay 0.999 \\
        --aug_rotate 15 --eval_every 10 --keep_last 4 --save_dir weights

Takes `train.py`'s flags and semantics, and --device (cuda, the default, or
cpu) and --config (a JSON config for the settings that have no flag, such as
the widths).  Per epoch it trains `steps_per_epoch` steps (0 = the train
split's size // batch_size) on augmented batches from `data.loader.
batch_iterator` (seed + epoch), each step's random draws from a generator
seeded by (seed, epoch * 100000 + step), so a resumed run takes the same
steps as one that was not interrupted.  It writes, under --save_dir:

  model_<epoch>/   checkpoints (`kgtpu_torch.checkpoint`; every --save_every
                   epochs and the last), with the dataset statistics and the
                   config as extras; saved on a writer thread
  metrics.jsonl    one line per epoch: the last step's losses, the held-out
                   metrics of that epoch, img/s and the host's RSS in GB
  best.json        {"epoch", "metric"} of the best held-out mAP_dsb2018 (the
                   EMA weights' when --ema_decay > 0), written once its
                   checkpoint is on disk

--eval_every N evaluates the raw and the EMA weights on up to 32 images of
the val split every N epochs, in chunks of 8, with a second model in eval
mode (every GroupNorm through the kernel on CUDA).  --keep_last prunes
before each save and once more at exit, so a run ends with the N newest
checkpoints and the best one.  --resume [latest|path] restores parameters,
optimizer, step and EMA and continues after the saved epoch; --init_from
loads the weights only.

Every backbone (--backbone), norm (--norm batch keeps running stats, which
checkpoints carry and evaluation uses beside the raw or EMA weights),
--inter_inject, --remat and --decode centernet train.  Paths that are not
ported exit naming their ROADMAP item by its title: --steps_per_dispatch > 1
(captured dispatch), --ngpus > 1 and --coordinator (data parallelism),
--profile_dir and --debug_nans (debugging, profiling and visualisation).

The host-RSS watchdog is kgtpu's: --rss_limit_gb -1 (the default) arms it at
75% of MemTotal, 0 turns it off, a positive value is the limit in GB.  At
every epoch boundary but the last, past the limit, the run saves the epoch
if it has not, waits for the checkpoint and re-execs itself as
`python -m kgtpu_torch.cli.train <the same flags> --resume`.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import sys
import time

import numpy as np
import torch

from kgtpu_torch import checkpoint
from kgtpu_torch.config import (Config, build_train_parser, config_from_json,
                                config_from_train_args, required_divisor)
from kgtpu_torch.utils import host

log = logging.getLogger("kgtpu_torch.train")

EVAL_IMAGES = 32            # held-out images per evaluation
EVAL_CHUNK = 8              # images per inference call
LOG_EVERY = 20              # steps
LOADER_WORKERS = 4          # `batch_iterator`'s default pool


def _refuse_unported(args) -> None:
    unported = [
        (args.steps_per_dispatch > 1,
         "--steps_per_dispatch > 1 (multi-step dispatch) is ROADMAP §1: captured dispatch"),
        (args.num_devices > 1,
         "--ngpus > 1 (data-parallel training) is ROADMAP §1: data parallelism"),
        (bool(args.coordinator),
         "--coordinator (multi-host training) is ROADMAP §1: data parallelism"),
        (bool(args.profile_dir),
         "--profile_dir is ROADMAP §1: debugging, profiling and visualisation"),
        (args.debug_nans,
         "--debug_nans is ROADMAP §1: debugging, profiling and visualisation"),
    ]
    for bad, msg in unported:
        if bad:
            raise SystemExit(f"not ported yet: {msg}")


def step_seed(seed: int, key: int) -> int:
    """The seed of one step's generator: a function of (seed, key) alone."""
    return int(np.random.SeedSequence([seed, key]).generate_state(1, np.uint64)[0])


def dataset_stats(ds, cfg: Config) -> dict:
    """The extras stored with every checkpoint, over the whole train split:
    the largest and the 99th-percentile GT box side (instances ranked as the
    loader ranks them, rescaled to the train canvas), the canvas, and the
    config (`predictor.size_prior_fallback` and `cli.test` read them)."""
    from kgtpu_torch.data.transforms import boxes_from_label_map
    sides = []
    for i in range(len(ds)):
        lab = ds[i]["label_map"]
        bx, v, _ = boxes_from_label_map(lab, cfg.data.max_instances)
        if v.sum():
            wh = np.maximum(bx[v > 0, 2] - bx[v > 0, 0], bx[v > 0, 3] - bx[v > 0, 1])
            sides.extend(wh * (cfg.data.input_size / max(lab.shape)))
    sides = np.asarray(sides, np.float32)
    return {
        "max_gt_box_side_px": np.asarray(float(sides.max()) if sides.size else 0.0,
                                         np.float32),
        "p99_gt_box_side_px": np.asarray(float(np.percentile(sides, 99))
                                         if sides.size else 0.0, np.float32),
        "train_input_size": np.asarray(cfg.data.input_size, np.float32),
        "config_json": checkpoint.encode_config(cfg),
    }


class HeldOutEval:
    """Held-out evaluation on up to EVAL_IMAGES images of the val split,
    resized without augmentation, through `build_infer_fn` on a second model
    in eval mode: the weights to score are copied into it, so the trained
    model and its parameters are never touched."""

    def __init__(self, cfg: Config, device: torch.device):
        from kgtpu_torch.data.loader import prepare_sample
        from kgtpu_torch.data.registry import build_dataset
        from kgtpu_torch.infer import build_infer_fn
        from kgtpu_torch.models import build_model
        vds = build_dataset(cfg.data, split="val")
        samples = [prepare_sample(vds[i], cfg.data, image_only=False)
                   for i in range(min(len(vds), EVAL_IMAGES))]
        self.images = np.stack([s["image"] for s in samples])
        self.gts = [s["label_map"] for s in samples]
        self.model = build_model(cfg.model, seed=None, device=device)
        self.infer = build_infer_fn(self.model, cfg, device=device)

    def __call__(self, weights: list[torch.Tensor], buffers: list[torch.Tensor]
                 ) -> tuple[dict, np.ndarray]:
        """(metrics, label maps [n, S, S]) of `weights` (in the model's
        parameter order) with `buffers` (BatchNorm's running stats, in the
        model's buffer order; none for GroupNorm)."""
        from kgtpu_torch import evaluate
        with torch.no_grad():
            for dst, src in zip(self.model.parameters(), weights):
                dst.copy_(src)
            for dst, src in zip(self.model.buffers(), buffers):
                dst.copy_(src)
        labs, scs = [], []
        n = len(self.images)
        for i0 in range(0, n, EVAL_CHUNK):
            out = self.infer(self.images[i0:i0 + EVAL_CHUNK])
            labs.append(out["label_map"].cpu().numpy())
            scs.append(out["scores"].cpu().numpy())
            log.info("held-out eval %d/%d", min(i0 + EVAL_CHUNK, n), n)
        labs, scs = np.concatenate(labs), np.concatenate(scs)
        recs = [{"pred_label": labs[i], "scores": scs[i], "gt_label": self.gts[i]}
                for i in range(n)]
        r = evaluate.evaluate_dsb2018(recs)
        rc = evaluate.evaluate_coco(recs)
        return ({"val_mAP_dsb": round(r["mAP_dsb2018"], 4),
                 "val_AP_coco": round(rc["AP_coco"], 4),
                 "val_AP50": round(rc["AP50"], 4),
                 "val_AJI": round(evaluate.evaluate_aji(recs)["AJI"], 4),
                 "val_PQ": round(evaluate.evaluate_pq(recs)["PQ"], 4)}, labs)


def run(argv: list[str] | None = None) -> dict:
    """Train as `main` does; returns a summary of the run: the start and end
    epochs and steps, per epoch the steps, the training wall time (held-out
    evaluation and saving excluded) and the time spent waiting for batches,
    the last held-out metrics and label maps ({"raw", "ema"}), and best."""
    parser = build_train_parser()
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parser.parse_args(argv)
    base = None
    if args.config:
        with open(args.config) as f:
            base = config_from_json(f.read())
    cfg = config_from_train_args(args, base)
    _refuse_unported(args)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")

    from kgtpu_torch import train_lib
    from kgtpu_torch.data.loader import batch_iterator
    from kgtpu_torch.data.registry import build_dataset
    from kgtpu_torch.device import resolve_device

    device = resolve_device(args.device)
    if cfg.data.dataset == "folder":
        raise SystemExit("--dataset folder is inference-only (no annotations); "
                         "train on dsb2018/synthetic* instead")
    divisor = required_divisor(cfg.model)
    if cfg.data.input_size % divisor:
        raise SystemExit(
            f"--input_size {cfg.data.input_size} must be divisible by {divisor} "
            f"for backbone {cfg.model.backbone} (hg_depth {cfg.model.hg_depth})")
    if device.type == "cuda":
        # the loader's workers each run torch ops on the host: one share of
        # the cores each, so the pool does not oversubscribe them
        torch.set_num_threads(max((os.cpu_count() or 1) // LOADER_WORKERS, 1))

    tcfg = cfg.train
    ds = build_dataset(cfg.data, split="train")
    steps_per_epoch = tcfg.steps_per_epoch or max(len(ds) // tcfg.batch_size, 1)
    # written back: the cosine schedule needs the total step count
    cfg = cfg.replace(train=dataclasses.replace(tcfg, steps_per_epoch=steps_per_epoch))
    tcfg = cfg.train
    log.info("dataset=%s n=%d steps/epoch=%d device=%s host threads=%d",
             cfg.data.dataset, len(ds), steps_per_epoch, device, torch.get_num_threads())

    state = train_lib.create_train_state(cfg, device=device)
    log.info("model=%s params=%.2fM", cfg.model.backbone,
             sum(p.numel() for p in state.model.parameters()) / 1e6)
    start_epoch = 0
    if tcfg.resume:
        src = tcfg.save_dir if tcfg.resume == "latest" else tcfg.resume
        start_epoch = checkpoint.restore(src, state=state)["epoch"] + 1
        log.info("resumed from %s at epoch %d (step %d)", src, start_epoch, state.step)
    elif tcfg.init_from:
        checkpoint.init_params_from(state, tcfg.init_from)
        log.info("initialized params from %s (fresh optimizer/epoch)", tcfg.init_from)
    start_step = state.step
    os.makedirs(tcfg.save_dir, exist_ok=True)
    metrics_path = os.path.join(tcfg.save_dir, "metrics.jsonl")
    rss_limit = (host.default_rss_limit_gb() if args.rss_limit_gb < 0
                 else args.rss_limit_gb)
    if rss_limit:
        log.info("host-RSS watchdog armed at %.1f GB", rss_limit)

    t_stats = time.time()
    data_stats = dataset_stats(ds, cfg)
    log.info("dataset stats over all %d images (%.1fs): GT box side max %.1f / p99 "
             "%.1f px at canvas %d (stored in checkpoints)", len(ds),
             time.time() - t_stats, float(data_stats["max_gt_box_side_px"]),
             float(data_stats["p99_gt_box_side_px"]), cfg.data.input_size)

    held_out = None
    best_val = {"epoch": -1, "metric": -1.0}
    best_marker = os.path.join(tcfg.save_dir, "best.json")
    if tcfg.resume and os.path.isfile(best_marker):
        with open(best_marker) as f:
            best_val = json.load(f)          # a resumed run does not regress it

    step_fn = train_lib.make_train_step(cfg)
    params = state.optimizer.params
    summary = {"start_epoch": start_epoch, "start_step": start_step, "epochs": [],
               "eval": None}
    metrics = {}
    for epoch in range(start_epoch, tcfg.num_epochs):
        it = batch_iterator(ds, cfg.data, tcfg.batch_size, augment=True,
                            seed=tcfg.seed + epoch, steps=steps_per_epoch)
        t0, seen, wait = time.time(), 0, 0.0
        for i in range(steps_per_epoch):
            tw = time.time()
            host_batch = next(it)
            wait += time.time() - tw
            batch = train_lib.batch_to_device(host_batch, device)
            gen = torch.Generator(device=device).manual_seed(
                step_seed(tcfg.seed, epoch * 100_000 + i))
            metrics = step_fn(state, batch, gen)
            seen += tcfg.batch_size
            if i % LOG_EVERY == 0:
                m = {k: round(float(v), 4) for k, v in metrics.items()}
                log.info("epoch %d step %d/%d %s (%.1f img/s)", epoch, i,
                         steps_per_epoch, m, seen / max(time.time() - t0, 1e-6))
        it.close()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        train_s = time.time() - t0
        summary["epochs"].append({"epoch": epoch, "steps": steps_per_epoch,
                                  "train_s": train_s, "wait_s": wait})

        val, new_best, best_saved = {}, False, False
        if tcfg.eval_every_epochs and (epoch + 1) % tcfg.eval_every_epochs == 0:
            t_ev = time.time()
            if held_out is None:
                held_out = HeldOutEval(cfg, device)
            # the EMA weights are scored with the live running stats, as
            # kgtpu pairs its EMA params with the state's batch_stats
            stats = list(state.model.buffers())
            val, labs = held_out(params, stats)
            labels = {"raw": labs}
            if state.ema is not None:
                ema_val, labels["ema"] = held_out(state.ema, stats)
                val.update({k + "_ema": v for k, v in ema_val.items()})
            summary["eval"] = {"epoch": epoch, "metrics": val, "label_maps": labels}
            log.info("epoch %d held-out eval (%.0fs): %s", epoch, time.time() - t_ev, val)
            # the deployable metric: the EMA's mAP when an EMA is kept
            cur = val.get("val_mAP_dsb_ema", val["val_mAP_dsb"])
            if cur > best_val["metric"]:
                best_val.update(epoch=epoch, metric=cur)
                new_best = True
                on_save_grid = ((epoch + 1) % tcfg.save_every_epochs == 0
                                or epoch == tcfg.num_epochs - 1)
                if not on_save_grid:       # the regular save below covers it
                    checkpoint.save(tcfg.save_dir, epoch, state, extra=data_stats,
                                    block=False)
                    best_saved = True
        with open(metrics_path, "a") as f:
            f.write(json.dumps({
                "epoch": epoch,
                **{k: round(float(v), 6) for k, v in metrics.items()},
                **val,
                "img_per_sec": round(seen / max(time.time() - t0, 1e-6), 2),
                "host_rss_gb": round(host.host_rss_gb(), 2),
            }) + "\n")
        on_grid = (epoch + 1) % tcfg.save_every_epochs == 0 or epoch == tcfg.num_epochs - 1
        if on_grid:
            # prune before the new save: only finished dirs are candidates
            for p in checkpoint.prune(tcfg.save_dir, tcfg.keep_last):
                log.info("pruned %s (--keep_last %d)", p, tcfg.keep_last)
            path = checkpoint.save(tcfg.save_dir, epoch, state, extra=data_stats,
                                   block=False)
            log.info("saving %s (async)", path)
        if new_best:
            # best.json names a checkpoint only once it is on disk
            checkpoint.wait()
            with open(best_marker, "w") as f:
                json.dump(best_val, f)
            log.info("new best val mAP %.4f at epoch %d -> best.json (use --weights "
                     "%s/best)", best_val["metric"], epoch, tcfg.save_dir)
        rss = host.host_rss_gb()
        if rss_limit and rss > rss_limit and epoch < tcfg.num_epochs - 1:
            if not (on_grid or best_saved):
                checkpoint.save(tcfg.save_dir, epoch, state, extra=data_stats,
                                block=False)
            checkpoint.wait()
            log.warning("host RSS %.1f GB > limit %.1f GB: checkpoint flushed at "
                        "epoch %d, re-exec'ing with --resume", rss, rss_limit, epoch)
            # run as a module: the script path in sys.argv[0] cannot import
            # the package when it is run as a script
            host.reexec(["-m", "kgtpu_torch.cli.train", *host.restart_argv(argv)])
    checkpoint.wait()
    for p in checkpoint.prune(tcfg.save_dir, tcfg.keep_last):
        log.info("pruned %s (--keep_last %d)", p, tcfg.keep_last)
    log.info("all checkpoints flushed")
    summary.update(end_step=state.step, best=best_val, steps_per_epoch=steps_per_epoch)
    return summary


def main(argv: list[str] | None = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
