"""Stacked-hourglass backbone: counterpart of `kgtpu/models/hourglass.py`
(the "hourglass", "hourglass_lite" and "hourglass_fast" variants, with
optional prediction feedback and rematerialisation)."""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from kgtpu_torch.models.blocks import BatchNorm, Conv, ConvBlock, Residual, upsample2x


class HourglassModule(nn.Module):
    """One recursive hourglass: down -> recurse -> up, with a skip.
    `slim_top` > 0 replaces the skip Residual with identity at the top
    `slim_top` levels ("hourglass_fast": 1)."""

    def __init__(self, depth: int, features: int, norm: str = "group",
                 slim_top: int = 0):
        super().__init__()
        self.up1 = None if slim_top > 0 else Residual(features, features, norm=norm)
        self.low1 = Residual(features, features, norm=norm)
        self.inner = (HourglassModule(depth - 1, features, norm, max(slim_top - 1, 0))
                      if depth > 1 else Residual(features, features, norm=norm))
        self.low3 = Residual(features, features, norm=norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        low = self.low3(self.inner(self.low1(F.max_pool2d(x, 2, 2))))
        up1 = x if self.up1 is None else self.up1(x)
        return up1 + upsample2x(low)


@contextlib.contextmanager
def _frozen_stats(module: nn.Module):
    """BatchNorm buffers left as they are: the recomputation of a
    rematerialised forward must not move them a second time."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.update_stats = False
    try:
        yield
    finally:
        for m in bns:
            m.update_stats = True


class HourglassBackbone(nn.Module):
    """Stride-4 stem + `num_stacks` hourglasses; returns one stride-4 feature
    map per stack.

    With `inject_channels` > 0 (prediction feedback), `forward` takes the
    per-stack head modules, runs each stack's heads inside the loop and
    projects their raw logits (channels in sorted key order: hm, reg, wh)
    into the next stack's input with a bias-free 1x1 conv; it then returns
    (features, predictions).
    With `remat`, each hourglass runs under a non-reentrant
    `torch.utils.checkpoint` in training, its activations recomputed in
    backward; the recomputation leaves BatchNorm's running stats alone, so
    they move once per forward as without remat."""

    def __init__(self, num_stacks: int = 2, features: int = 128, depth: int = 4,
                 norm: str = "group", slim_top: int = 0, inject_channels: int = 0,
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        self.stem = ConvBlock(3, features // 2, kernel=7, stride=2, norm=norm)
        self.down = Residual(features // 2, features, stride=2, norm=norm)
        self.hourglasses = nn.ModuleList(
            HourglassModule(depth, features, norm, slim_top) for _ in range(num_stacks))
        self.feat_convs = nn.ModuleList(
            ConvBlock(features, features, 3, norm=norm) for _ in range(num_stacks))
        # inter-stack fusion: 1x1 projections of the stack input and output
        self.fuse_x = nn.ModuleList(
            Conv(features, features, 1) for _ in range(num_stacks - 1))
        self.fuse_feat = nn.ModuleList(
            Conv(features, features, 1) for _ in range(num_stacks - 1))
        self.inject = nn.ModuleList(
            Conv(inject_channels, features, 1)
            for _ in range(num_stacks - 1 if inject_channels else 0))

    def _hourglass(self, i: int, x: torch.Tensor) -> torch.Tensor:
        hg = self.hourglasses[i]
        if self.remat and self.training and torch.is_grad_enabled():
            # the forward draws no random numbers: saving the RNG state
            # would only stand in the way of capturing the step
            return checkpoint(hg, x, use_reentrant=False, preserve_rng_state=False,
                              context_fn=lambda: (contextlib.nullcontext(),
                                                  _frozen_stats(hg)))
        return hg(x)

    def forward(self, x: torch.Tensor, heads=None):
        x = self.down(self.stem(x))
        outs, preds = [], []
        for i in range(len(self.hourglasses)):
            feat = self.feat_convs[i](self._hourglass(i, x))
            outs.append(feat)
            p = heads[i](feat) if heads is not None else None
            preds.append(p)
            if i < len(self.fuse_x):
                fuse = self.fuse_x[i](x) + self.fuse_feat[i](feat)
                if p is not None:
                    fuse = fuse + self.inject[i](torch.cat([p[k] for k in sorted(p)], dim=1))
                x = torch.relu(fuse)
        if heads is not None:
            return outs, preds
        return outs
