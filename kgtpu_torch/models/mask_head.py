"""Stage-2 mask head: counterpart of `kgtpu/models/mask_head.py`.

ROI crops of the stride-4 features [D, R, R, F] -> 3 ConvBlocks -> a learned
2x upsample (transposed conv) -> ReLU -> 1x1 conv -> mask logits [D, 2R, 2R].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from kgtpu_torch.models.blocks import Conv, ConvBlock


class MaskHead(nn.Module):
    def __init__(self, cin: int, channels: int = 64, num_convs: int = 3,
                 norm: str = "group"):
        super().__init__()
        self.convs = nn.Sequential(*(
            ConvBlock(cin if i == 0 else channels, channels, 3, norm=norm)
            for i in range(num_convs)))
        # conv_transpose2d layout [in, out, kh, kw]
        self.up_weight = nn.Parameter(torch.zeros(channels, channels, 2, 2))
        self.up_bias = nn.Parameter(torch.zeros(channels))
        self.out = Conv(channels, 1, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [D, F, R, R] (channels-last) -> logits [D, 2R, 2R]."""
        x = self.convs(x)
        x = F.conv_transpose2d(x, self.up_weight.to(x.dtype),
                               self.up_bias.to(x.dtype), stride=2)
        return self.out(torch.relu(x))[:, 0]
