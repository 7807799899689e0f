"""KGNet: the full model, counterpart of `kgtpu/models/kgnet.py`.

The backbone is chosen as kgtpu chooses it: the stacked hourglass
("hourglass", "hourglass_lite", "hourglass_fast" with an identity skip at
the top level) with one head stack per hourglass, or "resnet_fpn" / "unet"
with one head stack.  `forward` runs backbone + keypoint heads on NHWC images
and returns {"stacks": [{hm, reg, (wh)} per stack, NHWC float32], "feat":
NHWC last stride-4 features in the compute dtype}.  `apply_mask_head` runs
the stage-2 head on NHWC ROI crops.  Inside, tensors are NCHW laid out
channels-last, so the NHWC views at the edges cost nothing.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from kgtpu_torch.config import ModelConfig
from kgtpu_torch.device import resolve_device
from kgtpu_torch.models.blocks import BatchNorm, Conv, GroupNorm
from kgtpu_torch.models.heads import HM_BIAS_INIT, KeypointHeads
from kgtpu_torch.models.hourglass import HourglassBackbone
from kgtpu_torch.models.mask_head import MaskHead
from kgtpu_torch.models.resnet import ResNetFPN
from kgtpu_torch.models.unet import UNetBackbone

HOURGLASS_BACKBONES = ("hourglass", "hourglass_lite", "hourglass_fast")


def _to_nchw(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).to(dtype).contiguous(
        memory_format=torch.channels_last)


class KGNet(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.param_dtype != "float32":
            raise NotImplementedError("the port keeps float32 params only")
        self.cfg = cfg
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        f = cfg.base_channels
        # prediction feedback exists only between hourglass stacks
        self.inter_inject = (cfg.inter_inject and cfg.backbone in HOURGLASS_BACKBONES
                             and cfg.num_stacks > 1)
        if cfg.backbone in HOURGLASS_BACKBONES:
            inject = cfg.num_kp_classes + 2 + (2 if cfg.use_wh_head else 0)
            self.backbone = HourglassBackbone(
                cfg.num_stacks, f, cfg.hg_depth, cfg.norm,
                slim_top=1 if cfg.backbone == "hourglass_fast" else 0,
                inject_channels=inject if self.inter_inject else 0, remat=cfg.remat)
            n_heads = cfg.num_stacks
        elif cfg.backbone == "resnet_fpn":
            self.backbone = ResNetFPN(f, norm=cfg.norm)
            n_heads = 1
        elif cfg.backbone == "unet":
            self.backbone = UNetBackbone(f, cfg.hg_depth, cfg.norm)
            n_heads = 1
        else:
            raise ValueError(f"unknown backbone: {cfg.backbone}")
        self.heads = nn.ModuleList(
            KeypointHeads(f, cfg.num_kp_classes, cfg.head_channels, cfg.use_wh_head)
            for _ in range(n_heads))
        self.mask_head = MaskHead(f, cfg.mask_channels, norm=cfg.norm)

    def forward(self, images: torch.Tensor, last_stack_only: bool = False) -> dict:
        """images [B, H, W, 3] (normalized) -> {"stacks": [...], "feat"}.

        `last_stack_only` runs the heads of the last stack alone, the one
        inference reads (under jit, XLA drops the others as dead code).
        Under prediction feedback every stack's heads run inside the
        backbone, and only the output keeps the last stack alone."""
        x = _to_nchw(images, self.compute_dtype)
        if self.inter_inject:
            feats, preds = self.backbone(x, heads=self.heads)
        else:
            feats = self.backbone(x)
            pairs = list(zip(self.heads, feats))
            preds = [head(f) for head, f in (pairs[-1:] if last_stack_only else pairs)]
        if last_stack_only:
            preds = preds[-1:]
        stacks = [{k: v.permute(0, 2, 3, 1).float() for k, v in p.items()}
                  for p in preds]
        return {"stacks": stacks, "feat": feats[-1].permute(0, 2, 3, 1)}

    def apply_mask_head(self, crops: torch.Tensor, state: dict | None = None) -> torch.Tensor:
        """crops [D, R, R, F] -> mask logits [D, m, m] float32.  `state`:
        the mask head's parameters and buffers by name, to run it on those
        tensors instead of its own (a traced branch reads its operands only)."""
        x = _to_nchw(crops, self.compute_dtype)
        if state is None:
            return self.mask_head(x).float()
        return torch.func.functional_call(self.mask_head, state, (x,)).float()

    def use_plain_norm(self, plain: bool = True) -> "KGNet":
        """Compute every GroupNorm with its plain PyTorch version instead of
        the kernel (for holding the kernel against it on the same inputs).
        BatchNorm runs no kernel and is left as it is."""
        for m in self.modules():
            if isinstance(m, GroupNorm):
                m.plain = plain
        return self


def init_weights(model: KGNet, generator: torch.Generator) -> KGNet:
    """Random init in flax's defaults: lecun-normal (truncated) conv kernels,
    zero biases (the heads', resnet_fpn's 1x1 projections'), norm scale 1 /
    bias 0, BatchNorm running mean 0 / variance 1, and the hm bias prior."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Conv):
                fan_in = m.weight[0].numel()
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std,
                                      b=2 * std, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (GroupNorm, BatchNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
                if isinstance(m, BatchNorm):
                    m.running_mean.zero_()
                    m.running_var.fill_(1.0)
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
