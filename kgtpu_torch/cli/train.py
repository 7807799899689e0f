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
--inter_inject, --remat and --decode centernet train.  --profile_dir traces
the first epoch's steps (`utils/profiling.trace`, a Chrome trace in that
directory), as kgtpu's main process does; --debug_nans stops at the first op
that produces a NaN, forward or backward, with FloatingPointError
(`utils/debug.enable_nan_debugging`).

--steps_per_dispatch k runs each full group of k batches as one call of
`train_lib.make_train_multi_step` (on CUDA one captured CUDA graph,
replayed every dispatch; the profile traces the replays); an epoch's tail
that does not fill a group runs as single steps.  The steps, their draws
and keys are those of k = 1; `state.step` and the optimizer's count advance
by k on the host, and the log line comes every max(20 // k, 1) dispatches
with the last step's metrics, as kgtpu logs.  Under --debug_nans the k steps
run one by one in one call (the checks sync with the host after every op,
which a capture cannot hold), as jax_debug_nans reruns a program op by op.

Data parallelism computes the global batch's update on every rank
(`train_lib`, `parallel/multihost.py`): --ngpus n starts n ranks on this
host (rank i on cuda:i, or n gloo ranks with --device cpu), and
--coordinator host:port --num_hosts H --host_id i makes this process rank i
of H, one per host, as kgtpu's train.py does.  --batch_size is the global
batch, each rank builds its rows of it.  Only rank 0 writes metrics.jsonl,
best.json and the checkpoints; the best epoch is rank 0's decision.

The host-RSS watchdog is kgtpu's: --rss_limit_gb -1 (the default) arms it at
75% of MemTotal, 0 turns it off, a positive value is the limit in GB.  At
every epoch boundary but the last, past the limit (the largest RSS of the
ranks), the run saves the epoch if it has not, waits for the checkpoint and
re-execs itself as `python -m kgtpu_torch.cli.train <the same flags>
--resume`: each --coordinator host itself, and for --ngpus the launcher,
once every rank has exited with `parallel.launch.RESTART`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
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
from kgtpu_torch.parallel import launch, multihost
from kgtpu_torch.utils import host
from kgtpu_torch.utils.profiling import trace

log = logging.getLogger("kgtpu_torch.train")

EVAL_IMAGES = 32            # held-out images per evaluation
EVAL_CHUNK = 8              # images per inference call
LOG_EVERY = 20              # steps
LOADER_WORKERS = 4          # `batch_iterator`'s default pool


def _check_parallel(args, batch_size: int) -> int:
    """The number of ranks, after train.py's checks with its messages (the
    global batch divides by the ranks; --ngpus spans every host's device
    under --coordinator), and no more ranks than visible cards."""
    if args.coordinator:
        # one rank per host, each on one card: --ngpus can only name them all
        world = args.num_hosts
        if args.num_devices not in (0, world):
            raise SystemExit(f"--ngpus {args.num_devices} is incompatible with "
                             f"multi-host: the mesh must span all {world} global "
                             "devices (omit the flag or pass 0)")
    else:
        world = max(args.num_devices, 1)
        if world > 1 and torch.device(args.device).type == "cuda":
            visible = torch.cuda.device_count()
            if world > visible:
                raise SystemExit(f"--ngpus {world} exceeds the {visible} visible CUDA devices")
    if world > 1 and batch_size % world:
        raise SystemExit(f"--batch_size {batch_size} (global) must divide by the "
                         f"{world} hosts")
    return world


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


def _parse(argv: list[str]) -> tuple:
    args = build_train_parser().parse_args(argv)
    base = None
    if args.config:
        with open(args.config) as f:
            base = config_from_json(f.read())
    return args, config_from_train_args(args, base)


def run(argv: list[str] | None = None) -> dict:
    """Train as `main` does; returns a summary of the run: the start and end
    epochs and steps, per epoch the steps, the training wall time (held-out
    evaluation and saving excluded) and the time spent waiting for batches,
    the last held-out metrics and label maps ({"raw", "ema"}), best, and the
    all-reduces the host issued (`GlobalBatch.collectives`; a graph replay
    issues none from the host).
    With --ngpus n > 1 (and no --coordinator) it starts the n ranks and
    returns {"ranks": n, "exit_codes": [...]}."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args, cfg = _parse(argv)
    world = _check_parallel(args, cfg.train.batch_size)
    if args.coordinator:
        return _train(argv, args.host_id, world, args.coordinator)
    if world == 1:
        return _train(argv)
    codes = launch.spawn(_rank_main, world, (argv,))
    if codes == [launch.RESTART] * world:
        host.reexec(["-m", "kgtpu_torch.cli.train", *host.restart_argv(argv)])
    if any(codes):
        raise SystemExit(f"--ngpus {world}: the ranks exited with {codes}")
    return {"ranks": world, "exit_codes": codes}


def _rank_main(rank: int, world: int, coordinator: str, argv: list[str]) -> int:
    """One rank of --ngpus: its exit code (`launch.RESTART` asks the launcher
    to restart the group)."""
    return _train(argv, rank, world, coordinator).get("exit_code", 0)


def _train(argv: list[str], rank: int = 0, world: int = 1, coordinator: str = "") -> dict:
    """The training loop of one rank (of `world`, joined at `coordinator`;
    no process group without one)."""
    args, cfg = _parse(argv)
    if args.debug_nans:
        from kgtpu_torch.utils.debug import enable_nan_debugging
        enable_nan_debugging()
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s"
                        + (f" [rank {rank}]" if world > 1 else ""))
    try:
        return _loop(argv, args, cfg, rank, world, coordinator)
    finally:
        multihost.shutdown()


def _loop(argv, args, cfg, rank: int, world: int, coordinator: str) -> dict:
    from kgtpu_torch import train_lib
    from kgtpu_torch.data.loader import batch_iterator, stack_batches
    from kgtpu_torch.data.registry import build_dataset
    from kgtpu_torch.device import resolve_device

    device = resolve_device(args.device)
    if coordinator:
        device = multihost.initialize(coordinator, world, rank, device)
    gb = multihost.global_batch()
    main_rank = multihost.is_main()
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
    if gb is not None:
        log.info("data-parallel: rank %d of %d, %d of the %d images of each batch",
                 gb.rank, gb.world, tcfg.batch_size // gb.world, tcfg.batch_size)

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
    if gb is not None:
        train_lib.broadcast_state(state)
    start_step = state.step
    if main_rank:
        os.makedirs(tcfg.save_dir, exist_ok=True)
    metrics_path = os.path.join(tcfg.save_dir, "metrics.jsonl")
    rss_limit = (host.default_rss_limit_gb() if args.rss_limit_gb < 0
                 else args.rss_limit_gb)
    if rss_limit and main_rank:
        log.info("host-RSS watchdog armed at %.1f GB", rss_limit)

    data_stats = None
    if main_rank:                     # only rank 0 writes checkpoints
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

    step_fn = train_lib.make_train_step(cfg, gb)
    k_dispatch = max(args.steps_per_dispatch, 1)
    multi_fn = (train_lib.make_train_multi_step(cfg, k_dispatch, gb,
                                                capture=not args.debug_nans)
                if k_dispatch > 1 else None)
    if multi_fn is not None:
        log.info("multi-step dispatch: %d steps per call%s", k_dispatch,
                 " (one CUDA graph)" if device.type == "cuda" and not args.debug_nans else "")
    local_bs = tcfg.batch_size // (gb.world if gb is not None else 1)
    params = state.optimizer.params
    summary = {"start_epoch": start_epoch, "start_step": start_step, "epochs": [],
               "eval": None}
    metrics = {}

    def generator(epoch: int, i: int) -> torch.Generator:
        return torch.Generator(device=device).manual_seed(
            step_seed(tcfg.seed, epoch * 100_000 + i))

    for epoch in range(start_epoch, tcfg.num_epochs):
        it = batch_iterator(ds, cfg.data, tcfg.batch_size, augment=True,
                            seed=tcfg.seed + epoch, steps=steps_per_epoch,
                            process_id=rank, num_processes=world)
        t0, seen, wait = time.time(), 0, 0.0
        profiling = bool(args.profile_dir) and epoch == start_epoch and main_rank
        with trace(args.profile_dir) if profiling else contextlib.nullcontext():
            i = 0
            while i < steps_per_epoch:
                tw = time.time()
                group = list(itertools.islice(it, k_dispatch))
                wait += time.time() - tw
                if not group:
                    break
                if multi_fn is not None and len(group) == k_dispatch:
                    # one dispatch of k steps, each with the draws of its own key
                    n = group[0]["valid"].shape[1]
                    draws = [train_lib.step_draws(cfg, generator(epoch, i + j), local_bs, n,
                                                  device, gb) for j in range(k_dispatch)]
                    ms = multi_fn(state, stack_batches(group),
                                  torch.stack([d[0] for d in draws]),
                                  torch.stack([d[1] for d in draws]))
                    metrics = {key: v[-1] for key, v in ms.items()}
                    log_now = (i // k_dispatch) % max(LOG_EVERY // k_dispatch, 1) == 0
                    i += k_dispatch
                else:
                    # k = 1, or the epoch's tail that does not fill a group
                    for host_batch in group:
                        batch = train_lib.batch_to_device(host_batch, device)
                        metrics = step_fn(state, batch, generator(epoch, i))
                        i += 1
                    log_now = (i - len(group)) % LOG_EVERY == 0 or k_dispatch > 1
                seen += tcfg.batch_size * len(group)
                if log_now and main_rank:
                    m = {k: round(float(v), 4) for k, v in metrics.items()}
                    log.info("epoch %d step %d/%d %s (%.1f img/s)", epoch, i - 1,
                             steps_per_epoch, m, seen / max(time.time() - t0, 1e-6))
            it.close()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            train_s = time.time() - t0
        if profiling:
            log.info("profile written to %s", args.profile_dir)
        summary["epochs"].append({"epoch": epoch, "steps": steps_per_epoch,
                                  "train_s": train_s, "wait_s": wait})

        val, new_best, best_saved = {}, False, False
        if tcfg.eval_every_epochs and (epoch + 1) % tcfg.eval_every_epochs == 0:
            cur = -1.0
            if main_rank:             # the other ranks take rank 0's decision
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
            cur = multihost.broadcast_scalar(cur)
            if cur > best_val["metric"]:
                best_val.update(epoch=epoch, metric=cur)
                new_best = True
                on_save_grid = ((epoch + 1) % tcfg.save_every_epochs == 0
                                or epoch == tcfg.num_epochs - 1)
                if not on_save_grid:       # the regular save below covers it
                    if main_rank:
                        checkpoint.save(tcfg.save_dir, epoch, state, extra=data_stats,
                                        block=False)
                    best_saved = True
        if main_rank:
            with open(metrics_path, "a") as f:
                f.write(json.dumps({
                    "epoch": epoch,
                    **{k: round(float(v), 6) for k, v in metrics.items()},
                    **val,
                    "img_per_sec": round(seen / max(time.time() - t0, 1e-6), 2),
                    "host_rss_gb": round(host.host_rss_gb(), 2),
                }) + "\n")
        on_grid = (epoch + 1) % tcfg.save_every_epochs == 0 or epoch == tcfg.num_epochs - 1
        if on_grid and main_rank:
            # prune before the new save: only finished dirs are candidates
            for p in checkpoint.prune(tcfg.save_dir, tcfg.keep_last):
                log.info("pruned %s (--keep_last %d)", p, tcfg.keep_last)
            path = checkpoint.save(tcfg.save_dir, epoch, state, extra=data_stats,
                                   block=False)
            log.info("saving %s (async)", path)
        if new_best:
            # best.json names a checkpoint only once it is on disk
            checkpoint.wait()
            multihost.barrier()
            if main_rank:
                with open(best_marker, "w") as f:
                    json.dump(best_val, f)
                log.info("new best val mAP %.4f at epoch %d -> best.json (use --weights "
                         "%s/best)", best_val["metric"], epoch, tcfg.save_dir)
        rss = host.host_rss_gb()
        if rss_limit:
            rss = multihost.all_hosts_max(rss)
        if rss_limit and rss > rss_limit and epoch < tcfg.num_epochs - 1:
            if not (on_grid or best_saved) and main_rank:
                checkpoint.save(tcfg.save_dir, epoch, state, extra=data_stats,
                                block=False)
            checkpoint.wait()
            multihost.barrier()
            log.warning("host RSS %.1f GB > limit %.1f GB: checkpoint flushed at "
                        "epoch %d, re-exec'ing with --resume", rss, rss_limit, epoch)
            if world > 1 and not args.coordinator:
                # a rank of --ngpus: the launcher restarts the whole group
                summary["exit_code"] = launch.RESTART
                return summary
            multihost.shutdown()
            # run as a module: the script path in sys.argv[0] cannot import
            # the package when it is run as a script
            host.reexec(["-m", "kgtpu_torch.cli.train", *host.restart_argv(argv)])
    checkpoint.wait()
    if main_rank:
        for p in checkpoint.prune(tcfg.save_dir, tcfg.keep_last):
            log.info("pruned %s (--keep_last %d)", p, tcfg.keep_last)
        log.info("all checkpoints flushed")
    summary.update(end_step=state.step, best=best_val, steps_per_epoch=steps_per_epoch,
                   all_reduces=gb.collectives if gb is not None else 0)
    return summary


def main(argv: list[str] | None = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
