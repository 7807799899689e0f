"""Flax param tree -> the port's `state_dict`.

Takes the nested dict of numpy arrays that `kgtpu.checkpoint.restore_bundle`
returns for a GroupNorm hourglass model (bare params, or {"params": ...}) and
maps each flax leaf onto the port's parameter names:

  * conv kernels HWIO -> OIHW;
  * `GroupNorm_0/{scale, bias}` -> `GroupNorm.{weight, bias}`;
  * `nn.ConvTranspose` kernels are flipped spatially, then HWIO -> IOHW (the
    layout of `F.conv_transpose2d`): flax's transposed conv does not flip its
    kernel, PyTorch's does.

Every flax leaf must be consumed and every port parameter filled, or the
conversion raises.  No jax import: the caller hands in numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from kgtpu_torch.config import ModelConfig


def _join(name: str, sub: str) -> str:
    return f"{name}.{sub}" if name else sub


class _Converter:
    def __init__(self, params: dict):
        self.params = params
        self.used: set[tuple[str, ...]] = set()
        self.out: dict[str, torch.Tensor] = {}

    def _node(self, path: tuple[str, ...]):
        node = self.params
        for k in path:
            node = node[k]
        return node

    def leaf(self, path: tuple[str, ...]) -> np.ndarray:
        self.used.add(path)
        return np.asarray(self._node(path), np.float32)

    def put(self, name: str, arr: np.ndarray) -> None:
        self.out[name] = torch.from_numpy(np.ascontiguousarray(arr))

    def conv(self, path, name, bias=False):
        self.put(_join(name, "weight"), self.leaf(path + ("kernel",)).transpose(3, 2, 0, 1))
        if bias:
            self.put(_join(name, "bias"), self.leaf(path + ("bias",)))

    def norm(self, path, name):
        self.put(_join(name, "weight"), self.leaf(path + ("GroupNorm_0", "scale")))
        self.put(_join(name, "bias"), self.leaf(path + ("GroupNorm_0", "bias")))

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

    def hourglass(self, path, name, depth):
        self.residual(path + ("Residual_0",), _join(name, "up1"))
        self.residual(path + ("Residual_1",), _join(name, "low1"))
        if depth > 1:
            self.hourglass(path + ("HourglassModule_0",), _join(name, "inner"), depth - 1)
            self.residual(path + ("Residual_2",), _join(name, "low3"))
        else:
            self.residual(path + ("Residual_2",), _join(name, "inner"))
            self.residual(path + ("Residual_3",), _join(name, "low3"))

    def leaves(self, node=None, path=()):
        node = self.params if node is None else node
        for k, v in node.items():
            if hasattr(v, "items"):
                yield from self.leaves(v, path + (k,))
            else:
                yield path + (k,)


def flax_to_state_dict(params: dict, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """Map a flax KGNet param tree (numpy leaves) to a KGNet state_dict."""
    if "batch_stats" in params:
        raise NotImplementedError("BatchNorm checkpoints are not ported")
    params = params.get("params", params)
    c = _Converter(params)
    bb = ("backbone",)
    c.conv_block(bb + ("ConvBlock_0",), "backbone.stem")
    c.residual(bb + ("Residual_0",), "backbone.down")
    for i in range(cfg.num_stacks):
        c.hourglass(bb + (f"HourglassModule_{i}",), f"backbone.hourglasses.{i}",
                    cfg.hg_depth)
        c.conv_block(bb + (f"ConvBlock_{i + 1}",), f"backbone.feat_convs.{i}")
        if i < cfg.num_stacks - 1:
            # flax names the two fuse convs of stack i Conv_{2i}, Conv_{2i+1}
            c.conv(bb + (f"Conv_{2 * i}",), f"backbone.fuse_x.{i}")
            c.conv(bb + (f"Conv_{2 * i + 1}",), f"backbone.fuse_feat.{i}")
    for i in range(cfg.num_stacks):
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
    if left:
        raise ValueError(f"unconverted flax params: {['/'.join(p) for p in left]}")
    return c.out


def load_flax_params(model: torch.nn.Module, params: dict) -> torch.nn.Module:
    """Load a flax param tree into `model` (strict: every name must match)."""
    sd = flax_to_state_dict(params, model.cfg)
    model.load_state_dict(sd, strict=True)
    return model
