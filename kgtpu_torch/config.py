"""Configuration of the PyTorch port: the dataclasses, their JSON form and
the argparse shim of the train, test and eval CLIs.

A copy of the parts of `kgtpu/config.py` that the port runs, with the same
field names and defaults, so a `Config` written for one package means the same
model and the same pipeline in the other.  `config_from_json` reads configs
that kgtpu wrote (its checkpoints store one): a field the port does not hold
must be at kgtpu's default, or reading raises, unless it is one of
`NO_EFFECT_FIELDS`, which choose how kgtpu computes or where a run writes,
not what it computes.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json

# Keypoint class indices: four box corners (TL, TR, BL, BR) + center.
KP_TL, KP_TR, KP_BL, KP_BR, KP_CENTER = 0, 1, 2, 3, 4
NUM_KP_CLASSES = 5


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Backbone + heads."""

    backbone: str = "hourglass"        # "hourglass" | "hourglass_lite" (the
                                       # same architecture) | "hourglass_fast"
                                       # (identity skip at the top level) |
                                       # "resnet_fpn" | "unet"
    num_stacks: int = 2
    base_channels: int = 128
    hg_depth: int = 4
    head_channels: int = 128
    num_kp_classes: int = NUM_KP_CLASSES
    use_wh_head: bool = True
    norm: str = "group"                # "group" | "batch" (running stats)
    inter_inject: bool = False         # prediction feedback between hourglass
                                       # stacks (needs num_stacks > 1)
    roi_size: int = 32
    mask_size: int = 64
    mask_channels: int = 64
    compute_dtype: str = "bfloat16"    # activations; params stay float32
    param_dtype: str = "float32"
    remat: bool = False                # recompute each hourglass in backward
                                       # (torch.utils.checkpoint): less
                                       # activation memory, more compute


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Datasets, augmentation (`data/loader.prepare_sample`), fixed-shape
    batching."""

    dataset: str = "synthetic"         # see data/registry.py
    data_dir: str = ""
    synthetic_train_images: int = 64   # generated train-set size (synthetic*)
    input_size: int = 512
    stride: int = 4
    max_instances: int = 128           # N: instance slots per image
    flip_prob: float = 0.5
    scale_range: tuple[float, float] = (0.8, 1.2)
    rotate_deg: float = 0.0
    color_jitter: float = 0.2
    elastic_alpha: float = 0.0         # elastic deformation, max px (0 = off)
    elastic_sigma: float = 32.0        # its noise-grid spacing, px
    mean: tuple[float, float, float] = (0.485, 0.456, 0.406)
    std: tuple[float, float, float] = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class GroupConfig:
    """Keypoint-graph grouping + NMS thresholds (see kgtpu_torch.ops.group)."""

    method: str = "kg"                 # "kg" (keypoint graph) | "centernet"
                                       # (center + wh head, needs use_wh_head)
    max_peaks_per_class: int = 128
    max_detections: int = 128
    kp_score_thresh: float = 0.1
    center_thresh: float = 0.1
    center_tol: float = 0.35
    edge_tol: float = 0.35
    min_box_size: float = 2.0
    max_box_size: float = 1e9
    size_prune: float = 3.0
    require_center: bool = True
    require_edges: bool = False
    w_corner: float = 1.0
    w_center: float = 1.0
    w_edge: float = 0.5
    score_thresh: float = 0.15
    nms_iou: float = 0.5
    mask_thresh: float = 0.5


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The settings the train step (`train_lib`) and the training CLI
    (`cli/train.py`) read.

    kgtpu's `target_renderer` is left out: it chooses between two XLA
    implementations of one function.  Here the targets render through the
    Gaussian kernel for CUDA tensors and through its plain version for CPU
    tensors (`ops/gaussian.py`).
    """

    batch_size: int = 8
    lr: float = 2.5e-4
    lr_schedule: str = "constant"      # "constant" | "cosine" (decays to
                                       # lr/100 over num_epochs*steps_per_epoch)
    lr_warmup_steps: int = 500
    num_epochs: int = 100
    steps_per_epoch: int = 0           # 0 = derive from dataset length
    weight_decay: float = 0.0
    grad_clip_norm: float = 5.0
    ema_decay: float = 0.0             # 0 disables EMA params
    seed: int = 0
    # loss weights: focal on heatmaps, L1 on offsets and sizes, BCE+dice on
    # masks
    w_heatmap: float = 1.0
    w_offset: float = 1.0
    w_wh: float = 0.1
    w_mask: float = 1.0
    mask_train_rois: int = 16          # instances per image fed to the mask head
    roi_jitter: float = 0.1            # train-time box jitter, fraction of box size
    focal_alpha: float = 2.0           # CornerNet penalty-reduced focal exponents
    focal_beta: float = 4.0
    # the training CLI's checkpoints and held-out evaluation
    save_dir: str = "weights"
    save_every_epochs: int = 1
    keep_last: int = 0                 # keep the N newest model_<epoch> dirs
                                       # (+ the best.json epoch); 0 = all
    eval_every_epochs: int = 0         # held-out AP every N epochs (0 = off)
    resume: str = ""                   # "latest", a path, or "" (fresh start)
    init_from: str = ""                # load only the weights from this
                                       # checkpoint (fresh optimizer, epoch 0)


@dataclasses.dataclass(frozen=True)
class InferConfig:
    """Inference settings: single-scale, multi-scale and flip TTA (merged
    by `ops/nms.merge_scales`), and whole-slide tiling."""

    weights: str = ""                  # checkpoint to load
    test_scales: tuple[float, ...] = (1.0,)
    test_flip: bool = False            # add horizontal-flip TTA variants
    tta_vote: str = "mean"             # cross-variant merge: "max" keeps each
                                       # survivor's own score, "mean" rescores
                                       # it by agreement across variants
    tta_vote_iou: float = 0.5          # IoU for a variant box to support a
                                       # merged box
    tta_vote_thresh: float = 0.15      # mean vote: drop merged boxes whose
                                       # voted score is below this
    input_size: int = 512              # inference canvas (square); with
                                       # tiling, the slide's side
    mask_chunk: int = 32               # detection slots per mask-head chunk;
                                       # chunks with no valid slot are skipped
    mask_rescore: float = 0.0          # w > 0: score *= maskness ** w
    batch_size: int = 1
    tile_size: int = 512               # whole-slide tiling: tile side
    tile_overlap: int = 64             # and the overlap of adjacent tiles
    save_dir: str = "results"


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    group: GroupConfig = dataclasses.field(default_factory=GroupConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    infer: InferConfig = dataclasses.field(default_factory=InferConfig)

    def replace(self, **sections) -> "Config":
        return dataclasses.replace(self, **sections)


def tiny_test_config() -> Config:
    """Small config used by the tests: the same values as kgtpu's."""
    return Config(
        model=ModelConfig(
            backbone="hourglass_lite", num_stacks=1, base_channels=32,
            hg_depth=2, head_channels=32, roi_size=8, mask_size=16,
            mask_channels=16, compute_dtype="float32",
        ),
        data=DataConfig(input_size=128, max_instances=16),
        group=GroupConfig(max_peaks_per_class=32, max_detections=32),
        train=TrainConfig(batch_size=2, num_epochs=1, steps_per_epoch=2,
                          mask_train_rois=4),
        infer=InferConfig(input_size=128),
    )


def required_divisor(cfg: ModelConfig) -> int:
    """Input sides must be divisible by this: the stride-4 stem times the
    backbone's pool/upsample pairs (resnet_fpn: three stride-2 stages)."""
    if cfg.backbone == "resnet_fpn":
        return 32
    return 4 * (2 ** cfg.hg_depth)


# ---------------------------------------------------------------------------
# Config <-> JSON
# ---------------------------------------------------------------------------

_SECTIONS = {"model": ModelConfig, "data": DataConfig, "group": GroupConfig,
             "train": TrainConfig, "infer": InferConfig}

# kgtpu fields that choose how a run is computed, not what it computes (a run
# gives the same parameters and outputs whatever their value): the RSS
# watchdog, the device count and dispatch grouping of data parallelism, the
# target renderer and the fused norm (one function, two implementations).
NO_EFFECT_FIELDS = frozenset({
    ("train", "rss_limit_gb"), ("train", "num_devices"),
    ("train", "steps_per_dispatch"), ("train", "target_renderer"),
    ("infer", "fused_norm"),
})


def config_to_json(cfg: Config) -> str:
    """The whole config tree as JSON (stored in every checkpoint)."""
    return json.dumps(dataclasses.asdict(cfg), sort_keys=True)


def config_from_json(s: str) -> Config:
    """Inverse of `config_to_json`, and reader of the JSON that kgtpu's
    `config_to_json` writes.  Missing keys keep the defaults; lists become
    the tuples the dataclasses declare.  A key the port does not hold is
    dropped when it is in NO_EFFECT_FIELDS; any other raises ValueError
    naming it, since dropping it would change the result."""
    raw = json.loads(s)
    unknown = sorted(set(raw) - set(_SECTIONS))
    if unknown:
        raise ValueError(f"config sections the port does not know: {unknown}")
    sections = {}
    for name, cls in _SECTIONS.items():
        d = raw.get(name, {})
        held = {f.name for f in dataclasses.fields(cls)}
        kwargs = {}
        for k, v in d.items():
            v = tuple(v) if isinstance(v, list) else v
            if k in held:
                kwargs[k] = v
            elif (name, k) in NO_EFFECT_FIELDS:
                continue
            else:
                raise ValueError(f"config field {name}.{k} = {v!r} is not known to "
                                 "the port")
        sections[name] = cls(**kwargs)
    return Config(**sections)


def apply_model_overrides(model: ModelConfig, a: argparse.Namespace,
                          explicit: set[str]) -> ModelConfig:
    """Override a checkpoint-stored ModelConfig with the architecture flags
    the user explicitly passed; everything not passed keeps the trained
    value."""
    kw = {}
    if "backbone" in explicit:
        kw["backbone"] = a.backbone
    if "num_stacks" in explicit:
        kw["num_stacks"] = a.num_stacks
    if "norm" in explicit:
        kw["norm"] = a.norm
    if "wh_head" in explicit:
        kw["use_wh_head"] = bool(a.wh_head) or a.decode == "centernet"
    elif "decode" in explicit and a.decode == "centernet":
        # centernet decode needs the wh head; an explicit `--decode kg` must
        # not force the parser-default wh_head=1 onto a checkpoint without one
        kw["use_wh_head"] = True
    if "inter_inject" in explicit:
        kw["inter_inject"] = a.inter_inject
    if "roi_size" in explicit:
        kw["roi_size"] = a.roi_size
        kw["mask_size"] = a.mask_size or 2 * a.roi_size
    if "mask_size" in explicit and a.mask_size:
        kw["mask_size"] = a.mask_size
    return dataclasses.replace(model, **kw)


def explicit_cli_dests(parser: argparse.ArgumentParser,
                       argv: list[str] | None = None) -> set[str]:
    """The argparse dests the user passed on the command line (not
    defaults): stored checkpoint config is the base, explicit flags
    override."""
    probe = copy.deepcopy(parser)
    for a in probe._actions:
        a.default = argparse.SUPPRESS
    ns, _ = probe.parse_known_args(argv)
    return set(vars(ns))


# ---------------------------------------------------------------------------
# argparse shim: the flags of kgtpu's test.py and eval.py
# ---------------------------------------------------------------------------

def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--dataset", default="dsb2018",
                   choices=["synthetic", "synthetic_crowded",
                            "synthetic_hard", "dsb2018", "neural_cells",
                            "coco", "folder"])
    p.add_argument("--data_dir", default="")
    p.add_argument("--input_size", type=int, default=512)
    p.add_argument("--backbone", default="hourglass",
                   choices=["hourglass", "hourglass_lite", "hourglass_fast",
                            "resnet_fpn", "unet"])
    p.add_argument("--num_stacks", type=int, default=2)
    p.add_argument("--norm", default="group", choices=["group", "batch"])
    p.add_argument("--decode", default="kg", choices=["kg", "centernet"])
    p.add_argument("--K", dest="max_peaks", type=int, default=128,
                   help="per-class top-k peaks kept by the decoder")
    p.add_argument("--max_detections", type=int, default=128)
    p.add_argument("--conf_thresh", type=float, default=0.15)
    p.add_argument("--nms_iou", type=float, default=0.5)
    p.add_argument("--max_box_size", type=float, default=0.0,
                   help="hard cap on box side in input pixels (0 = unlimited)")
    p.add_argument("--size_prune", type=float, default=3.0,
                   help="kill (TL, BR) pairs spanning more than this multiple "
                        "of the wh-head size at the corner peaks (0 disables)")
    p.add_argument("--wh_head", type=int, default=1, choices=[0, 1])
    p.add_argument("--inter_inject", action="store_true")
    p.add_argument("--roi_size", type=int, default=32)
    p.add_argument("--synthetic_n", type=int, default=64)
    p.add_argument("--mask_size", type=int, default=0,
                   help="mask-logit resolution (0 = 2x --roi_size)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--debug_nans", action="store_true",
                   help="not ported (ROADMAP §1: debugging, profiling and visualisation)")


def build_train_parser() -> argparse.ArgumentParser:
    """kgtpu's train.py flags, plus --device and --config.  Flags of paths
    the port does not run parse, and `cli/train.py` exits naming their
    ROADMAP item."""
    p = argparse.ArgumentParser("python -m kgtpu_torch.cli.train",
                                description="Train the KG model (PyTorch port)")
    _add_common(p)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--aug_scale", default="0.8,1.2",
                   help="random scale-jitter range LO,HI of the joint affine "
                        "augmentation")
    p.add_argument("--aug_elastic", default="0",
                   help="elastic deformation: ALPHA (max displacement px) or "
                        "ALPHA,SIGMA (noise-grid spacing px); 0 = off")
    p.add_argument("--aug_rotate", type=float, default=0.0,
                   help="random rotation range in +/- degrees")
    p.add_argument("--ema_decay", type=float, default=0.0)
    p.add_argument("--remat", action="store_true",
                   help="recompute each hourglass's activations in backward "
                        "(less memory, more compute)")
    p.add_argument("--lr", type=float, default=2.5e-4)
    p.add_argument("--lr_schedule", default="constant", choices=["constant", "cosine"])
    p.add_argument("--num_epochs", type=int, default=100)
    p.add_argument("--steps_per_epoch", type=int, default=0,
                   help="0 = the train split's size // batch_size")
    p.add_argument("--save_dir", default="weights")
    p.add_argument("--save_every", type=int, default=1,
                   help="checkpoint every N epochs (the final epoch always saves)")
    p.add_argument("--keep_last", type=int, default=0,
                   help="keep only the N newest checkpoints (+ the best-val "
                        "epoch); 0 = keep all")
    p.add_argument("--eval_every", type=int, default=0,
                   help="held-out AP every N epochs (0 = off); rows land in "
                        "metrics.jsonl, the best epoch in best.json")
    p.add_argument("--resume", default="", nargs="?", const="latest",
                   help="checkpoint path, or the bare flag to resume the latest")
    p.add_argument("--init_from", default="",
                   help="fine-tune: initialise only the network weights from "
                        "this checkpoint (fresh optimizer, epoch 0)")
    p.add_argument("--rss_limit_gb", type=float, default=-1.0,
                   help="host-RSS watchdog: past this many GB, checkpoint and "
                        "re-exec with --resume at an epoch boundary (-1 = 75%% "
                        "of MemTotal, 0 = off)")
    p.add_argument("--ngpus", "--num_devices", dest="num_devices", type=int,
                   default=0, help="more than 1 is not ported (ROADMAP §1: data parallelism)")
    p.add_argument("--steps_per_dispatch", type=int, default=1,
                   help="more than 1 is not ported (ROADMAP §1: captured dispatch)")
    p.add_argument("--target_renderer", default="scan", choices=["scan", "pallas"],
                   help="kgtpu's renderer switch; in the port the Gaussian "
                        "kernel renders every CUDA batch either way")
    p.add_argument("--coordinator", default="", help="not ported (ROADMAP §1: data parallelism)")
    p.add_argument("--num_hosts", type=int, default=1)
    p.add_argument("--host_id", type=int, default=0)
    p.add_argument("--profile_dir", default="",
                   help="not ported (ROADMAP §1: debugging, profiling and visualisation)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--config", default="",
                   help="a JSON config (as a checkpoint's config_json) for the "
                        "settings that have no flag, such as the widths; every "
                        "setting that has a flag takes the flag's value")
    return p


def build_test_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("python -m kgtpu_torch.cli.test",
                                description="Run KG inference (PyTorch port)")
    _add_common(p)
    p.add_argument("--weights", default="", help="checkpoint dir to load")
    p.add_argument("--ensemble", default="",
                   help="comma-separated extra checkpoint dirs, each with its "
                        "stored config, whose detections merge with --weights' "
                        "through the TTA vote (--weights runs the mask stage); "
                        "composes with --test_scales/--test_flip; exclusive "
                        "with --tiled")
    p.add_argument("--use_ema", action="store_true",
                   help="load EMA params from the checkpoint when present "
                        "(applies to --ensemble members too)")
    p.add_argument("--batch_size", type=int, default=8,
                   help="inference batch (the last chunk is padded)")
    p.add_argument("--save_vis", action="store_true",
                   help="not ported (ROADMAP §1: debugging, profiling and visualisation)")
    p.add_argument("--tiled", action="store_true",
                   help="whole-slide mode: --input_size is the slide's side, "
                        "served as tiles of --tile_size with --tile_overlap "
                        "and stitched")
    p.add_argument("--test_scales", default="1.0",
                   help="comma-separated TTA scales, e.g. 0.75,1.0,1.25")
    p.add_argument("--test_flip", action="store_true",
                   help="add horizontal-flip TTA")
    p.add_argument("--tta_vote", default="mean", choices=["max", "mean"])
    p.add_argument("--mask_chunk", type=int, default=32,
                   help="mask-stage detection-slot chunk size (0 = dense)")
    p.add_argument("--tta_vote_thresh", type=float, default=0.15)
    p.add_argument("--mask_rescore", type=float, default=0.0,
                   help="w > 0 multiplies each detection score by maskness^w")
    p.add_argument("--fused_norm", default="off", choices=["auto", "off"],
                   help="kgtpu's TPU kernel switch; in the port every serving "
                        "GroupNorm runs through its CUDA kernel either way")
    p.add_argument("--save_dir", default="results")
    p.add_argument("--coco_json", default="",
                   help="also write predictions as COCO results JSON")
    p.add_argument("--ngpus", "--num_devices", dest="num_devices", type=int,
                   default=0, help="more than 1 is not ported (ROADMAP §1: data parallelism)")
    p.add_argument("--tile_size", type=int, default=512)
    p.add_argument("--tile_overlap", type=int, default=64)
    p.add_argument("--profile_dir", default="",
                   help="write a torch.profiler trace of the run here")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--compute_dtype", default="", choices=["", "bfloat16", "float32"],
                   help="activation dtype; default: the checkpoint's")
    return p


def build_eval_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("python -m kgtpu_torch.cli.eval",
                                description="Evaluate mask AP")
    p.add_argument("--pred_dir", default="results")
    p.add_argument("--gt_dir", default="")
    p.add_argument("--dataset", default="dsb2018")
    p.add_argument("--protocol", default="dsb2018",
                   choices=["dsb2018", "coco", "aji", "pq", "all"])
    return p


def _common_sections(c: Config, a: argparse.Namespace) -> Config:
    """`c` with the model, data and group fields of `_add_common`'s flags."""
    return c.replace(
        model=dataclasses.replace(c.model, backbone=a.backbone,
                                  num_stacks=a.num_stacks, norm=a.norm,
                                  use_wh_head=(bool(a.wh_head)
                                               or a.decode == "centernet"),
                                  inter_inject=a.inter_inject,
                                  roi_size=a.roi_size,
                                  mask_size=a.mask_size or 2 * a.roi_size),
        data=dataclasses.replace(c.data, dataset=a.dataset, data_dir=a.data_dir,
                                 input_size=a.input_size,
                                 synthetic_train_images=a.synthetic_n),
        group=dataclasses.replace(c.group, method=a.decode,
                                  max_peaks_per_class=a.max_peaks,
                                  max_detections=a.max_detections,
                                  max_box_size=(a.max_box_size / c.data.stride
                                                if a.max_box_size > 0 else 1e9),
                                  size_prune=a.size_prune,
                                  score_thresh=a.conf_thresh, nms_iou=a.nms_iou))


def config_from_train_args(a: argparse.Namespace, base: Config | None = None) -> Config:
    """kgtpu's `config_from_train_args` over `base` (default: `Config()`):
    the fields that have a flag take its value, the others keep base's."""
    c = _common_sections(Config() if base is None else base, a)
    try:
        lo, hi = (float(x) for x in str(a.aug_scale).split(","))
    except ValueError:
        raise SystemExit(f"--aug_scale {a.aug_scale!r} must be LO,HI")
    if not (0.0 < lo <= hi):
        raise SystemExit(f"--aug_scale {a.aug_scale!r} needs 0 < LO <= HI")
    try:
        el = [float(x) for x in str(a.aug_elastic).split(",")]
        e_alpha, e_sigma = (el + [c.data.elastic_sigma])[:2]
    except ValueError:
        raise SystemExit(
            f"--aug_elastic {a.aug_elastic!r} must be ALPHA or ALPHA,SIGMA")
    if e_alpha < 0 or e_sigma <= 0:
        raise SystemExit(
            f"--aug_elastic {a.aug_elastic!r} needs ALPHA >= 0, SIGMA > 0")
    return c.replace(
        data=dataclasses.replace(c.data, scale_range=(lo, hi), rotate_deg=a.aug_rotate,
                                 elastic_alpha=e_alpha, elastic_sigma=e_sigma),
        train=dataclasses.replace(c.train, batch_size=a.batch_size, lr=a.lr,
                                  lr_schedule=a.lr_schedule,
                                  num_epochs=a.num_epochs,
                                  steps_per_epoch=a.steps_per_epoch,
                                  save_dir=a.save_dir, resume=a.resume,
                                  init_from=a.init_from,
                                  save_every_epochs=max(a.save_every, 1),
                                  keep_last=max(a.keep_last, 0),
                                  eval_every_epochs=max(a.eval_every, 0),
                                  seed=a.seed, ema_decay=a.ema_decay),
        model=dataclasses.replace(c.model, remat=a.remat))


def config_from_test_args(a: argparse.Namespace) -> Config:
    scales = tuple(float(s) for s in str(a.test_scales).split(",") if s)
    if not scales:
        raise SystemExit("--test_scales must list at least one scale")
    if 1.0 not in scales:
        raise SystemExit(
            f"--test_scales {a.test_scales!r} must include 1.0 (the base "
            "scale that the mask stage and the TTA merge are anchored to)")
    c = _common_sections(Config(), a)
    return c.replace(
        infer=dataclasses.replace(c.infer, weights=a.weights, test_scales=scales,
                                  test_flip=a.test_flip,
                                  mask_chunk=a.mask_chunk,
                                  mask_rescore=a.mask_rescore,
                                  tta_vote=a.tta_vote,
                                  tta_vote_thresh=a.tta_vote_thresh,
                                  input_size=a.input_size, save_dir=a.save_dir,
                                  tile_size=a.tile_size,
                                  tile_overlap=a.tile_overlap,
                                  batch_size=a.batch_size))
