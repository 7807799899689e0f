"""Single-scale two-stage inference: counterpart of `kgtpu/infer.py`
(`build_infer_fn` and the stages under it).

  images [B, H, W, 3] raw pixels
    -> normalize -> KGNet backbone + heads          (detect_batch)
    -> decode_peaks -> group_keypoints -> box_nms   (stride coords)
    -> crop_and_resize(features, boxes) -> mask head, in chunks of
       mask_chunk detection slots, skipping chunks with no valid slot
    -> paste_masks_batch -> per-image instance label maps   (mask_batch)

JAX's jit and vmap have no counterpart here: PyTorch runs eagerly, and every
op carries the batch axis.  A skipped chunk is found by one host-side count
of valid slots per batch, where JAX used lax.cond per chunk.
"""

from __future__ import annotations

from typing import Callable

import torch

from kgtpu_torch.config import Config
from kgtpu_torch.device import resolve_device
from kgtpu_torch.models import KGNet
from kgtpu_torch.ops.decode import decode_peaks, gather_at
from kgtpu_torch.ops.group import Boxes, group_keypoints
from kgtpu_torch.ops.nms import box_nms
from kgtpu_torch.ops.preprocess import normalize_images
from kgtpu_torch.ops.roi import crop_and_resize, paste_masks_batch


def _check_cfg(cfg: Config) -> None:
    if cfg.group.method != "kg":
        raise NotImplementedError(
            f"group.method {cfg.group.method!r} is not ported (kg only)")


def decode_batch(cfg: Config, stack: dict) -> Boxes:
    """Last-stack head maps (NHWC f32) -> NMS'd Boxes [B, D] (stride coords)."""
    peaks = decode_peaks(stack["hm"], stack["reg"], cfg.group.max_peaks_per_class)
    kp_wh = None
    if cfg.group.size_prune > 0 and "wh" in stack:
        kp_wh = gather_at(stack["wh"], peaks.indices)     # [B, 5, K, 2]
    cand = group_keypoints(peaks, cfg.group, kp_wh=kp_wh)
    return box_nms(cand, cfg.group.nms_iou)


def detect_batch(model: KGNet, cfg: Config, images: torch.Tensor
                 ) -> tuple[Boxes, torch.Tensor]:
    """Normalized images [B, H, W, 3] -> (Boxes [B, D], features NHWC)."""
    out = model(images, last_stack_only=True)
    return decode_batch(cfg, out["stacks"][-1]), out["feat"]


def mask_probs(model: KGNet, cfg: Config, feats: torch.Tensor,
               dets: Boxes) -> torch.Tensor:
    """ROI crop + mask head -> mask probabilities [B, D, m, m].  Slot chunks
    with no valid detection in any image are skipped (zeros)."""
    b, d = dets.boxes.shape[:2]
    m = cfg.model.mask_size
    ch = cfg.infer.mask_chunk
    if 0 < ch < d:
        pad = (-d) % ch
        boxes = torch.nn.functional.pad(dets.boxes, (0, 0, 0, pad))
        valid = torch.nn.functional.pad(dets.valid, (0, pad))
        live = valid.reshape(b, -1, ch).any(dim=2).any(dim=0)
        chunks = torch.nonzero(live).flatten().tolist()
    else:                                   # dense: every slot, no skipping
        ch, pad, boxes, chunks = d, 0, dets.boxes, [0]
    logits = torch.zeros((b, d + pad, m, m), dtype=torch.float32,
                         device=feats.device)
    for ci in chunks:
        sl = slice(ci * ch, (ci + 1) * ch)
        crops = crop_and_resize(feats, boxes[:, sl], cfg.model.roi_size)
        flat = crops.reshape((b * ch,) + crops.shape[2:])
        logits[:, sl] = model.apply_mask_head(flat).reshape(b, ch, m, m)
    return torch.sigmoid(logits[:, :d])


def rescore_by_maskness(cfg: Config, probs: torch.Tensor, scores: torch.Tensor,
                        valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """score *= maskness ** w (w = infer.mask_rescore; 0 is off), then the
    score gate re-applies.  maskness = mean mask prob over the head's own
    foreground."""
    w = cfg.infer.mask_rescore
    if w <= 0:
        return scores, valid
    fg = (probs > cfg.group.mask_thresh).to(probs.dtype)
    maskness = (probs * fg).sum((-2, -1)) / torch.clamp(fg.sum((-2, -1)), min=1.0)
    scores = scores * torch.where(valid, maskness, torch.ones_like(maskness)) ** w
    return scores, valid & (scores >= cfg.group.score_thresh)


def mask_batch(model: KGNet, cfg: Config, feats: torch.Tensor, dets: Boxes,
               height: int, width: int) -> dict:
    """Stage 2: masks for the detection slots, pasted into label maps.
    Boxes come back in image pixels."""
    probs = mask_probs(model, cfg, feats, dets)
    scores, valid = rescore_by_maskness(cfg, probs, dets.scores, dets.valid)
    boxes = dets.boxes
    if cfg.infer.mask_rescore > 0:
        # restore kept-first order: valid slots first, by rescored score
        key = torch.where(valid, -scores, torch.full_like(scores, float("inf")))
        _, order = torch.sort(key, dim=1, stable=True)
        boxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
        scores = torch.gather(scores, 1, order)
        valid = torch.gather(valid, 1, order)
        probs = torch.gather(probs, 1, order[..., None, None].expand_as(probs))
    boxes_px = boxes * cfg.data.stride
    d = boxes.shape[1]
    ch = cfg.infer.mask_chunk
    label, score_map = paste_masks_batch(
        probs, boxes_px, scores, valid, height, width,
        thresh=cfg.group.mask_thresh, box_chunk=ch if 0 < ch < d else 32)
    return {"boxes": boxes_px, "scores": scores, "valid": valid,
            "masks": probs, "label_map": label, "score_map": score_map}


def build_infer_fn(model: KGNet, cfg: Config,
                   device: str | torch.device = "cuda") -> Callable:
    """(images [B, H, W, 3] raw pixels, uint8 or float 0-255) -> dict of
    boxes [B, D, 4] (pixels), scores [B, D], valid [B, D], masks
    [B, D, m, m], label_map [B, H, W] int32, score_map [B, H, W].

    Moves `model` to `device` (CUDA unless the caller asks for the CPU) and
    puts it in eval mode.  Inputs are moved to that device.
    """
    _check_cfg(cfg)
    dev = resolve_device(device)
    model.to(device=dev, memory_format=torch.channels_last).eval()

    @torch.inference_mode()
    def infer(images) -> dict:
        images = torch.as_tensor(images).to(dev)
        x = normalize_images(images, cfg.data.mean, cfg.data.std)
        dets, feats = detect_batch(model, cfg, x)
        return mask_batch(model, cfg, feats, dets, images.shape[1],
                          images.shape[2])

    return infer
