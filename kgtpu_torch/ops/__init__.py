"""Ops of the port: plain PyTorch tensor functions with a leading batch
axis, plus the wrappers of the CUDA kernels (`groupnorm`, `gaussian`).
Exports the counterparts of `kgtpu.ops`' exports."""

from kgtpu_torch.ops.decode import decode_peaks
from kgtpu_torch.ops.group import group_keypoints
from kgtpu_torch.ops.nms import batched_box_iou, box_nms, merge_scales
from kgtpu_torch.ops.preprocess import normalize_images
from kgtpu_torch.ops.roi import crop_and_resize, paste_masks, paste_masks_batch
from kgtpu_torch.ops.targets import gaussian_radius, keypoints_from_boxes, render_heatmaps

__all__ = [
    "normalize_images",
    "gaussian_radius",
    "keypoints_from_boxes",
    "render_heatmaps",
    "decode_peaks",
    "group_keypoints",
    "batched_box_iou",
    "box_nms",
    "merge_scales",
    "crop_and_resize",
    "paste_masks",
    "paste_masks_batch",
]
