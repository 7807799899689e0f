"""Stacked-hourglass backbone: counterpart of `kgtpu/models/hourglass.py`
(the default "hourglass" variant, no prediction feedback)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from kgtpu_torch.models.blocks import Conv, ConvBlock, Residual, upsample2x


class HourglassModule(nn.Module):
    """One recursive hourglass: down -> recurse -> up, with a skip."""

    def __init__(self, depth: int, features: int):
        super().__init__()
        self.up1 = Residual(features, features)
        self.low1 = Residual(features, features)
        self.inner = (HourglassModule(depth - 1, features) if depth > 1
                      else Residual(features, features))
        self.low3 = Residual(features, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        low = self.low3(self.inner(self.low1(F.max_pool2d(x, 2, 2))))
        return self.up1(x) + upsample2x(low)


class HourglassBackbone(nn.Module):
    """Stride-4 stem + `num_stacks` hourglasses; returns one stride-4 feature
    map per stack."""

    def __init__(self, num_stacks: int = 2, features: int = 128,
                 depth: int = 4):
        super().__init__()
        self.stem = ConvBlock(3, features // 2, kernel=7, stride=2)
        self.down = Residual(features // 2, features, stride=2)
        self.hourglasses = nn.ModuleList(
            HourglassModule(depth, features) for _ in range(num_stacks))
        self.feat_convs = nn.ModuleList(
            ConvBlock(features, features, 3) for _ in range(num_stacks))
        # inter-stack fusion: 1x1 projections of the stack input and output
        self.fuse_x = nn.ModuleList(
            Conv(features, features, 1) for _ in range(num_stacks - 1))
        self.fuse_feat = nn.ModuleList(
            Conv(features, features, 1) for _ in range(num_stacks - 1))

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = self.down(self.stem(x))
        outs = []
        for i, hg in enumerate(self.hourglasses):
            feat = self.feat_convs[i](hg(x))
            outs.append(feat)
            if i < len(self.fuse_x):
                x = torch.relu(self.fuse_x[i](x) + self.fuse_feat[i](feat))
        return outs
