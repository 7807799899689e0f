"""U-Net backbone: counterpart of `kgtpu/models/unet.py`.

The shared stride-4 stem (a stride-2 7x7 ConvBlock at features // 2, then a
stride-2 3x3 at features), `depth` double-conv stages with 2x2 max-pool
down (widths doubling up to `MAX_WIDTH`), a double-conv bottleneck, and
`depth` up stages: nearest 2x upsample, concatenation [upsampled, skip],
double conv at the skip's width.  One stride-4 feature map out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from kgtpu_torch.models.blocks import ConvBlock, upsample2x

MAX_WIDTH = 512     # channel cap at the bottleneck (kgtpu's default)


def _double(cin: int, cout: int, norm: str) -> nn.Sequential:
    return nn.Sequential(ConvBlock(cin, cout, norm=norm), ConvBlock(cout, cout, norm=norm))


class UNetBackbone(nn.Module):
    def __init__(self, features: int = 64, depth: int = 4, norm: str = "group"):
        super().__init__()
        self.stem = nn.Sequential(ConvBlock(3, features // 2, kernel=7, stride=2, norm=norm),
                                  ConvBlock(features // 2, features, kernel=3, stride=2,
                                            norm=norm))
        widths, width, cin = [], features, features
        self.down = nn.ModuleList()
        for _ in range(depth):
            self.down.append(_double(cin, width, norm))
            widths.append(width)
            cin, width = width, min(width * 2, MAX_WIDTH)
        self.bottleneck = _double(cin, width, norm)
        self.up = nn.ModuleList()
        for w in reversed(widths):
            self.up.append(_double(width + w, w, norm))
            width = w

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = self.stem(x)
        skips = []
        for stage in self.down:
            x = stage(x)
            skips.append(x)
            x = F.max_pool2d(x, 2, 2)
        x = self.bottleneck(x)
        for stage, skip in zip(self.up, reversed(skips)):
            x = stage(torch.cat([upsample2x(x), skip], dim=1))
        return [x]
