"""Configuration of the PyTorch port: the dataclasses the inference and
training slices read.

A copy of the sections of `kgtpu/config.py` that the port runs, with the same
field names and defaults, so a `Config` written for one package means the same
model and the same pipeline in the other.  Checkpoint, mesh, host-RSS and
multi-step-dispatch settings and the argparse shim are not part of the port
yet.
"""

from __future__ import annotations

import dataclasses

# Keypoint class indices: four box corners (TL, TR, BL, BR) + center.
KP_TL, KP_TR, KP_BL, KP_BR, KP_CENTER = 0, 1, 2, 3, 4
NUM_KP_CLASSES = 5


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Backbone + heads."""

    backbone: str = "hourglass"        # the port runs "hourglass" and
                                       # "hourglass_lite" (same architecture)
    num_stacks: int = 2
    base_channels: int = 128
    hg_depth: int = 4
    head_channels: int = 128
    num_kp_classes: int = NUM_KP_CLASSES
    use_wh_head: bool = True
    norm: str = "group"                # the port runs "group" only
    inter_inject: bool = False         # the port runs False only
    roi_size: int = 32
    mask_size: int = 64
    mask_channels: int = 64
    compute_dtype: str = "bfloat16"    # activations; params stay float32
    param_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """The data settings inference and the train step read."""

    input_size: int = 512
    stride: int = 4
    max_instances: int = 128           # N: instance slots per image
    mean: tuple[float, float, float] = (0.485, 0.456, 0.406)
    std: tuple[float, float, float] = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class GroupConfig:
    """Keypoint-graph grouping + NMS thresholds (see kgtpu_torch.ops.group)."""

    method: str = "kg"                 # the port runs "kg" only
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
    """The settings the train step reads (`train_lib`).

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


@dataclasses.dataclass(frozen=True)
class InferConfig:
    """Single-scale inference settings."""

    input_size: int = 512              # inference canvas (square)
    mask_chunk: int = 32               # detection slots per mask-head chunk;
                                       # chunks with no valid slot are skipped
    mask_rescore: float = 0.0          # w > 0: score *= maskness ** w


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
    hourglass's pool/upsample pairs."""
    return 4 * (2 ** cfg.hg_depth)
