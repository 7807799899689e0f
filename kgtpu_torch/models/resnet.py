"""ResNet-FPN backbone: counterpart of `kgtpu/models/resnet.py`.

A residual encoder (stride 4 to 32: a stride-2 7x7 ConvBlock, a stride-2
Residual, then four stages of `STAGE_BLOCKS` Residuals, widths from
`features` doubling up to 4x) and a top-down FPN back to stride 4: a 1x1
projection of the deepest stage, then per shallower stage its 1x1 lateral
plus the 2x-upsampled merge, smoothed by a 3x3 ConvBlock.  The 1x1 lateral
and top projections carry biases (flax's default), unlike every other conv
of the model.  One stride-4 feature map out.
"""

from __future__ import annotations

import torch
from torch import nn

from kgtpu_torch.models.blocks import Conv, ConvBlock, Residual, upsample2x

STAGE_BLOCKS = (2, 2, 2, 2)     # Residuals per stage (kgtpu's default)


class ResNetFPN(nn.Module):
    def __init__(self, features: int = 128, norm: str = "group"):
        super().__init__()
        self.stem = ConvBlock(3, features // 2, kernel=7, stride=2, norm=norm)
        self.down = Residual(features // 2, features // 2, stride=2, norm=norm)
        self.stages = nn.ModuleList()
        widths, width, cin = [], features, features // 2
        for si, nblocks in enumerate(STAGE_BLOCKS):
            blocks = [Residual(cin, width, stride=1 if si == 0 else 2, norm=norm)]
            blocks += [Residual(width, width, norm=norm) for _ in range(nblocks - 1)]
            self.stages.append(nn.Sequential(*blocks))
            widths.append(width)
            cin, width = width, min(width * 2, features * 4)
        self.top = Conv(widths[-1], features, 1, bias=True)
        self.laterals = nn.ModuleList(Conv(w, features, 1, bias=True)
                                      for w in reversed(widths[:-1]))
        self.smooth = nn.ModuleList(ConvBlock(features, features, 3, norm=norm)
                                    for _ in widths[:-1])

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = self.down(self.stem(x))
        feats = []
        for stage in self.stages:
            x = stage(x)
            feats.append(x)
        p = self.top(feats[-1])
        for lateral, smooth, f in zip(self.laterals, self.smooth, reversed(feats[:-1])):
            p = smooth(lateral(f) + upsample2x(p))
        return [p]
