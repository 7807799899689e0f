"""Flax variables -> the port's `state_dict`.

Takes the nested dict of numpy arrays that `kgtpu.checkpoint.restore_bundle`
returns for a KGNet of any backbone and norm (bare params, {"params": ...},
or {"params", "batch_stats"} for a BatchNorm model) and maps each flax leaf
onto the port's names:

  * conv kernels HWIO -> OIHW (biases where the conv has one: the heads',
    the mask head's output, resnet_fpn's 1x1 lateral and top projections);
  * `GroupNorm_0/{scale, bias}` -> `GroupNorm.{weight, bias}`;
  * `BatchNorm_0/{scale, bias}` -> `BatchNorm.{weight, bias}`, and its
    batch_stats `{mean, var}` -> the buffers `running_mean`, `running_var`
    (a tree without batch_stats, such as optimizer moments, maps the
    parameters alone);
  * `nn.ConvTranspose` kernels are flipped spatially, then HWIO -> IOHW (the
    layout of `F.conv_transpose2d`): flax's transposed conv does not flip its
    kernel, PyTorch's does.

flax numbers unnamed submodules per type in call order (`ConvBlock_3`,
`Residual_1`, `Conv_2`); the map follows each backbone's call order.  Every
flax leaf must be consumed and every port parameter filled, or the
conversion raises.  No jax import: the caller hands in numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from kgtpu_torch.config import ModelConfig
from kgtpu_torch.models.kgnet import HOURGLASS_BACKBONES
from kgtpu_torch.models.resnet import STAGE_BLOCKS


def _join(name: str, sub: str) -> str:
    return f"{name}.{sub}" if name else sub


class _Converter:
    def __init__(self, params: dict, stats: dict | None = None):
        self.params = params
        self.stats = stats
        self.used: set[tuple[str, ...]] = set()
        self.out: dict[str, torch.Tensor] = {}

    def _node(self, path: tuple[str, ...], tree=None):
        node = self.params if tree is None else tree
        for k in path:
            node = node[k]
        return node

    def leaf(self, path: tuple[str, ...], tree=None) -> np.ndarray:
        self.used.add(("stats",) + path if tree is not None else path)
        return np.asarray(self._node(path, tree), np.float32)

    def put(self, name: str, arr: np.ndarray) -> None:
        self.out[name] = torch.from_numpy(np.ascontiguousarray(arr))

    def conv(self, path, name, bias=False):
        self.put(_join(name, "weight"), self.leaf(path + ("kernel",)).transpose(3, 2, 0, 1))
        if bias:
            self.put(_join(name, "bias"), self.leaf(path + ("bias",)))

    def norm(self, path, name):
        kind = "GroupNorm_0" if "GroupNorm_0" in self._node(path) else "BatchNorm_0"
        self.put(_join(name, "weight"), self.leaf(path + (kind, "scale")))
        self.put(_join(name, "bias"), self.leaf(path + (kind, "bias")))
        if kind == "BatchNorm_0" and self.stats is not None:
            self.put(_join(name, "running_mean"), self.leaf(path + (kind, "mean"), self.stats))
            self.put(_join(name, "running_var"), self.leaf(path + (kind, "var"), self.stats))

    def conv_block(self, path, name):
        self.conv(path + ("Conv_0",), _join(name, "conv"))
        self.norm(path + ("Norm_0",), _join(name, "norm"))

    def residual(self, path, name):
        self.conv_block(path + ("ConvBlock_0",), _join(name, "conv_block"))
        self.conv(path + ("Conv_0",), _join(name, "conv"))
        self.norm(path + ("Norm_0",), _join(name, "norm"))
        if "Conv_1" in self._node(path):
            self.conv(path + ("Conv_1",), _join(name, "skip_conv"))
            self.norm(path + ("Norm_1",), _join(name, "skip_norm"))

    def hourglass(self, path, name, depth, slim_top=0):
        # without up1 (slim_top) every Residual of this level numbers one lower
        k = 0
        if slim_top == 0:
            self.residual(path + ("Residual_0",), _join(name, "up1"))
            k = 1
        self.residual(path + (f"Residual_{k}",), _join(name, "low1"))
        if depth > 1:
            self.hourglass(path + ("HourglassModule_0",), _join(name, "inner"), depth - 1,
                           max(slim_top - 1, 0))
            self.residual(path + (f"Residual_{k + 1}",), _join(name, "low3"))
        else:
            self.residual(path + (f"Residual_{k + 1}",), _join(name, "inner"))
            self.residual(path + (f"Residual_{k + 2}",), _join(name, "low3"))

    def hourglass_backbone(self, cfg: ModelConfig, inter_inject: bool):
        bb = ("backbone",)
        self.conv_block(bb + ("ConvBlock_0",), "backbone.stem")
        self.residual(bb + ("Residual_0",), "backbone.down")
        for i in range(cfg.num_stacks):
            self.hourglass(bb + (f"HourglassModule_{i}",), f"backbone.hourglasses.{i}",
                           cfg.hg_depth, 1 if cfg.backbone == "hourglass_fast" else 0)
            self.conv_block(bb + (f"ConvBlock_{i + 1}",), f"backbone.feat_convs.{i}")
            if i < cfg.num_stacks - 1:
                # flax names the two fuse convs of stack i Conv_{2i}, Conv_{2i+1}
                self.conv(bb + (f"Conv_{2 * i}",), f"backbone.fuse_x.{i}")
                self.conv(bb + (f"Conv_{2 * i + 1}",), f"backbone.fuse_feat.{i}")
                if inter_inject:
                    self.conv(bb + (f"inject_{i}",), f"backbone.inject.{i}")

    def unet_backbone(self, cfg: ModelConfig):
        # ConvBlock_k in call order: the stem's two, two per down stage, the
        # bottleneck's two, two per up stage
        names = ["backbone.stem.0", "backbone.stem.1"]
        names += [f"backbone.down.{s}.{j}" for s in range(cfg.hg_depth) for j in (0, 1)]
        names += ["backbone.bottleneck.0", "backbone.bottleneck.1"]
        names += [f"backbone.up.{s}.{j}" for s in range(cfg.hg_depth) for j in (0, 1)]
        for k, name in enumerate(names):
            self.conv_block(("backbone", f"ConvBlock_{k}"), name)

    def resnet_backbone(self):
        bb = ("backbone",)
        self.conv_block(bb + ("ConvBlock_0",), "backbone.stem")
        self.residual(bb + ("Residual_0",), "backbone.down")
        k = 1
        for s, n in enumerate(STAGE_BLOCKS):
            for j in range(n):
                self.residual(bb + (f"Residual_{k}",), f"backbone.stages.{s}.{j}")
                k += 1
        # Conv_0 is the top projection; each FPN step creates its lateral
        # Conv before its ConvBlock
        self.conv(bb + ("Conv_0",), "backbone.top", bias=True)
        for j in range(len(STAGE_BLOCKS) - 1):
            self.conv(bb + (f"Conv_{j + 1}",), f"backbone.laterals.{j}", bias=True)
            self.conv_block(bb + (f"ConvBlock_{j + 1}",), f"backbone.smooth.{j}")

    def leaves(self, node=None, path=()):
        node = self.params if node is None else node
        for k, v in node.items():
            if hasattr(v, "items"):
                yield from self.leaves(v, path + (k,))
            else:
                yield path + (k,)


def flax_to_state_dict(params: dict, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """Map flax KGNet variables (numpy leaves) to a KGNet state_dict."""
    stats = params.get("batch_stats")
    params = params.get("params", params)
    c = _Converter(params, stats)
    hourglass = cfg.backbone in HOURGLASS_BACKBONES
    if hourglass:
        c.hourglass_backbone(cfg, cfg.inter_inject and cfg.num_stacks > 1)
    elif cfg.backbone == "unet":
        c.unet_backbone(cfg)
    elif cfg.backbone == "resnet_fpn":
        c.resnet_backbone()
    else:
        raise ValueError(f"unknown backbone: {cfg.backbone}")
    for i in range(cfg.num_stacks if hourglass else 1):
        heads = ["hm", "reg"] + (["wh"] if cfg.use_wh_head else [])
        for h in heads:
            c.conv((f"heads_{i}", f"{h}_conv"), f"heads.{i}.heads.{h}.conv", bias=True)
            c.conv((f"heads_{i}", f"{h}_out"), f"heads.{i}.heads.{h}.out", bias=True)
    mh = ("mask_head",)
    for j in range(3):
        c.conv_block(mh + (f"ConvBlock_{j}",), f"mask_head.convs.{j}")
    up = c.leaf(mh + ("ConvTranspose_0", "kernel"))
    c.put("mask_head.up_weight", up[::-1, ::-1].transpose(2, 3, 0, 1))
    c.put("mask_head.up_bias", c.leaf(mh + ("ConvTranspose_0", "bias")))
    c.conv(mh + ("Conv_0",), "mask_head.out", bias=True)

    left = [p for p in c.leaves() if p not in c.used]
    if stats is not None:
        left += [p for p in c.leaves(stats, ("stats",)) if p not in c.used]
    if left:
        raise ValueError(f"unconverted flax params: {['/'.join(p) for p in left]}")
    return c.out


def load_flax_params(model: torch.nn.Module, params: dict) -> torch.nn.Module:
    """Load a flax param tree into `model` (strict: every name must match)."""
    sd = flax_to_state_dict(params, model.cfg)
    model.load_state_dict(sd, strict=True)
    return model
