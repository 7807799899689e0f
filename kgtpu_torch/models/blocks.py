"""Shared conv building blocks (NCHW tensors laid out channels-last).

Counterparts of `kgtpu/models/blocks.py`.  Parameters are float32; each
block computes in the dtype of its input (the model casts the image to the
compute dtype once), as flax does with `dtype=compute_dtype`.

GroupNorm runs the hand-written kernel only in eval mode.  The kernel, like
the Pallas kernel it replaces, has no backward, so its output has no
`grad_fn`: a training forward through it would cut the graph at every norm
and leave everything upstream without a gradient.  In training mode
(`model.train()`) the norms compute the differentiable plain version
instead, which is what the JAX train step runs (flax `nn.GroupNorm` under
XLA; `Norm("group_fused")` is inference-only there too).  The choice follows
`nn.Module.training` alone, and the kernel's wrapper raises if autograd
would record a call.

BatchNorm (`norm="batch"`) is written out on tensors with flax's semantics
(see `BatchNorm`); it runs no kernel, on any device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from kgtpu_torch.ops.groupnorm import (
    group_norm_relu,
    group_norm_relu_reference,
    num_groups,
)
from kgtpu_torch.parallel import multihost


def same_pads(kernel: int, stride: int, size: int) -> tuple[int, int]:
    """Flax/XLA padding="SAME" along one axis: (low, high).  Uneven for
    stride-2 convs on even sides, e.g. (2, 3) for the 7x7 stem."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax nn.Conv(padding="SAME"): explicit F.pad, then an unpadded conv."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 bias: bool = False):
        super().__init__()
        self.kernel, self.stride = kernel, stride
        self.weight = nn.Parameter(torch.zeros(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ph = same_pads(self.kernel, self.stride, x.shape[2])
        pw = same_pads(self.kernel, self.stride, x.shape[3])
        if any(ph + pw):
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), bias, self.stride)


class GroupNorm(nn.Module):
    """flax nn.GroupNorm (eps 1e-6, G = largest divisor of C <= 32), with an
    optional fused ReLU.  In eval mode the GroupNorm kernel computes it on
    CUDA; in training mode the differentiable plain version (`F.group_norm`
    on an f32 upcast, cast back to the input dtype) does, on any device.

    `plain` (set by `KGNet.use_plain_norm`, for comparisons only) computes
    the plain version in eval mode too."""

    def __init__(self, channels: int, relu: bool = False):
        super().__init__()
        self.groups = num_groups(channels)
        self.relu = relu
        self.plain = False
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # a no-op for the port's convolution outputs; the kernel needs it
        x = x.contiguous(memory_format=torch.channels_last)
        if self.training or self.plain:
            return group_norm_relu_reference(x, self.weight, self.bias,
                                             self.groups, self.relu)
        return group_norm_relu(x, self.weight, self.bias, self.groups,
                               self.relu)


class BatchNorm(nn.Module):
    """flax 0.12's nn.BatchNorm as `kgtpu/models/blocks.py::Norm("batch")`
    builds it, with an optional fused ReLU: momentum 0.99, eps 1e-5,
    statistics over (N, H, W), output in the input dtype.

    Training mode normalises with the batch's mean and its biased variance
    E[x^2] - E[x]^2 (clamped at 0), and moves the running buffers towards
    them: r = 0.99 r + 0.01 stat (torch's BatchNorm2d counts its momentum
    the other way and keeps the unbiased variance, hence this module).  Eval
    mode normalises with the running buffers.  Statistics and the
    normalisation are computed in at least f32 (flax's
    force_float32_reductions).  `update_stats` off (set for
    the recomputation of a rematerialised forward) normalises with the
    batch's statistics without moving the buffers.  Inside a process group
    of more than one rank (data-parallel training) the training statistics
    are the global batch's: the sums of x and x^2 are all-reduced, with a
    gradient."""

    momentum = 0.99
    eps = 1e-5

    def __init__(self, channels: int, relu: bool = False):
        super().__init__()
        self.relu = relu
        self.update_stats = True
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.training:
            world = multihost.world_size()
            if world > 1:
                # sync-BN: the global batch's statistics, as kgtpu's sharded
                # step computes them; the all-reduce carries the gradient
                n = xf.numel() // xf.shape[1] * world
                sums = multihost.differentiable_sum(
                    torch.stack([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3))]))
                mean, ex2 = sums[0] / n, sums[1] / n
            else:
                mean, ex2 = xf.mean((0, 2, 3)), (xf * xf).mean((0, 2, 3))
            var = torch.clamp(ex2 - mean * mean, min=0.0)
            if self.update_stats:
                with torch.no_grad():
                    self.running_mean.mul_(self.momentum).add_((1 - self.momentum) * mean)
                    self.running_var.mul_(self.momentum).add_((1 - self.momentum) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        if self.relu:
            y = torch.relu(y)
        return y.to(x.dtype)


def make_norm(kind: str, channels: int, relu: bool = False) -> nn.Module:
    """The norm of `kind` ("group" or "batch") over `channels`."""
    if kind == "group":
        return GroupNorm(channels, relu)
    if kind == "batch":
        return BatchNorm(channels, relu)
    raise ValueError(f"unknown norm kind: {kind}")


class ConvBlock(nn.Module):
    """conv -> norm -> ReLU."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 norm: str = "group"):
        super().__init__()
        self.conv = Conv(cin, cout, kernel, stride)
        self.norm = make_norm(norm, cout, relu=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.conv(x))


class Residual(nn.Module):
    """conv3-conv3 residual block with a projection skip when the shape
    changes."""

    def __init__(self, cin: int, cout: int, stride: int = 1, norm: str = "group"):
        super().__init__()
        self.conv_block = ConvBlock(cin, cout, 3, stride, norm)
        self.conv = Conv(cout, cout, 3)
        self.norm = make_norm(norm, cout)
        self.project = cin != cout or stride != 1
        if self.project:
            self.skip_conv = Conv(cin, cout, 1, stride)
            self.skip_norm = make_norm(norm, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm(self.conv(self.conv_block(x)))
        skip = self.skip_norm(self.skip_conv(x)) if self.project else x
        return torch.relu(y + skip)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample."""
    return F.interpolate(x, scale_factor=2, mode="nearest")
