"""Keypoint prediction heads: counterpart of `kgtpu/models/heads.py`.

hm [5] heatmap logits (bias initialized to -2.19, about logit(0.1)),
reg [2] sub-pixel offsets, wh [2] box size (optional).
"""

from __future__ import annotations

import torch
from torch import nn

from kgtpu_torch.models.blocks import Conv

HM_BIAS_INIT = -2.19


class Head(nn.Module):
    """conv3x3 (bias) -> ReLU -> conv1x1 (bias)."""

    def __init__(self, cin: int, hidden: int, cout: int):
        super().__init__()
        self.conv = Conv(cin, hidden, 3, bias=True)
        self.out = Conv(hidden, cout, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(torch.relu(self.conv(x)))


class KeypointHeads(nn.Module):
    def __init__(self, cin: int, num_classes: int = 5, hidden: int = 128,
                 use_wh: bool = False):
        super().__init__()
        heads = {"hm": Head(cin, hidden, num_classes),
                 "reg": Head(cin, hidden, 2)}
        if use_wh:
            heads["wh"] = Head(cin, hidden, 2)
        self.heads = nn.ModuleDict(heads)

    def forward(self, feat: torch.Tensor) -> dict[str, torch.Tensor]:
        return {name: head(feat) for name, head in self.heads.items()}
