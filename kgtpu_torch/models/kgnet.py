"""KGNet: the full model, counterpart of `kgtpu/models/kgnet.py` (hourglass
backbones).

`forward` runs backbone + per-stack keypoint heads on NHWC images and returns
{"stacks": [{hm, reg, (wh)} per stack, NHWC float32], "feat": NHWC last
stride-4 features in the compute dtype}.  `apply_mask_head` runs the stage-2
head on NHWC ROI crops.  Inside, tensors are NCHW laid out channels-last, so
the NHWC views at the edges cost nothing.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from kgtpu_torch.config import ModelConfig
from kgtpu_torch.device import resolve_device
from kgtpu_torch.models.blocks import Conv, GroupNorm
from kgtpu_torch.models.heads import HM_BIAS_INIT, KeypointHeads
from kgtpu_torch.models.hourglass import HourglassBackbone
from kgtpu_torch.models.mask_head import MaskHead

HOURGLASS_BACKBONES = ("hourglass", "hourglass_lite")


def _to_nchw(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).to(dtype).contiguous(
        memory_format=torch.channels_last)


class KGNet(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.backbone not in HOURGLASS_BACKBONES:
            raise NotImplementedError(
                f"backbone {cfg.backbone!r} is not ported (hourglass only)")
        if cfg.norm != "group" or cfg.inter_inject:
            raise NotImplementedError(
                "the port runs norm='group' without inter_inject only")
        if cfg.param_dtype != "float32":
            raise NotImplementedError("the port keeps float32 params only")
        self.cfg = cfg
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        f = cfg.base_channels
        self.backbone = HourglassBackbone(cfg.num_stacks, f, cfg.hg_depth)
        self.heads = nn.ModuleList(
            KeypointHeads(f, cfg.num_kp_classes, cfg.head_channels,
                          cfg.use_wh_head)
            for _ in range(cfg.num_stacks))
        self.mask_head = MaskHead(f, cfg.mask_channels)

    def forward(self, images: torch.Tensor, last_stack_only: bool = False) -> dict:
        """images [B, H, W, 3] (normalized) -> {"stacks": [...], "feat"}.

        `last_stack_only` runs the heads of the last stack alone, the one
        inference reads (under jit, XLA drops the others as dead code)."""
        feats = self.backbone(_to_nchw(images, self.compute_dtype))
        pairs = list(zip(self.heads, feats))
        if last_stack_only:
            pairs = pairs[-1:]
        stacks = [
            {k: v.permute(0, 2, 3, 1).float() for k, v in head(f).items()}
            for head, f in pairs
        ]
        return {"stacks": stacks, "feat": feats[-1].permute(0, 2, 3, 1)}

    def apply_mask_head(self, crops: torch.Tensor) -> torch.Tensor:
        """crops [D, R, R, F] -> mask logits [D, m, m] float32."""
        return self.mask_head(_to_nchw(crops, self.compute_dtype)).float()

    def use_plain_norm(self, plain: bool = True) -> "KGNet":
        """Compute every GroupNorm with its plain PyTorch version instead of
        the kernel (for holding the kernel against it on the same inputs)."""
        for m in self.modules():
            if isinstance(m, GroupNorm):
                m.plain = plain
        return self


def init_weights(model: KGNet, generator: torch.Generator) -> KGNet:
    """Random init in flax's defaults: lecun-normal (truncated) conv kernels,
    zero biases, GroupNorm scale 1 / bias 0, and the hm bias prior."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Conv):
                fan_in = m.weight[0].numel()
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std,
                                      b=2 * std, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, MaskHead):
                # flax ConvTranspose: fan_in = kh * kw * in_channels
                fan_in = m.up_weight.shape[0] * 4
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(m.up_weight, std=std, a=-2 * std,
                                      b=2 * std, generator=generator)
                m.up_bias.zero_()
        for heads in model.heads:
            heads.heads["hm"].out.bias.fill_(HM_BIAS_INIT)
    return model


def build_model(cfg: ModelConfig, seed: int | None = 0,
                device: str | torch.device = "cuda") -> KGNet:
    """KGNet with random weights from `seed` (None leaves them unset), in
    eval mode, channels-last, on `device`."""
    device = resolve_device(device)
    model = KGNet(cfg)
    if seed is not None:
        init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device=device, memory_format=torch.channels_last).eval()
