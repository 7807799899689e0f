"""Serving API: one image in, instances out.  Counterpart of
`kgtpu/predictor.py` (`size_prior_fallback` and `Predictor`), built from a
`Config` and a `state_dict`, or from a checkpoint in the port's format
(`kgtpu_torch.checkpoint`; `tools/orbax_to_torch.py` converts kgtpu's).

    p = Predictor.from_checkpoint("weights", use_ema=True)   # on the GPU
    p = Predictor(cfg, state_dict)
    result = p.predict(image_uint8)           # [H, W, 3] RGB, any size
    result["label_map"], result["boxes"], result["scores"], result["masks"]

The image is resized onto the square canvas (long side fits, no letterbox
offset) and results come back in the input frame.  The two resizes follow
cv2, which the JAX package uses, without needing it:

  * image: `cv2.warpAffine(INTER_LINEAR, BORDER_CONSTANT 0)` with the scale
    matrix (`data/transforms.resize_image`);
  * label map: `cv2.resize(INTER_NEAREST)`: source index floor(x * src/dst).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kgtpu_torch import checkpoint as ckpt
from kgtpu_torch.config import Config, required_divisor
from kgtpu_torch.data.transforms import resize_image
from kgtpu_torch.device import resolve_device
from kgtpu_torch.infer import build_infer_fn
from kgtpu_torch.models import KGNet


def resize_nearest(label: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[h, w] label map -> [height, width], nearest (ids are not blended)."""
    h, w = label.shape
    ys = np.minimum(np.floor(np.arange(height) * (1.0 / (height / h))), h - 1)
    xs = np.minimum(np.floor(np.arange(width) * (1.0 / (width / w))), w - 1)
    ys = torch.from_numpy(ys.astype(np.int64)).to(label.device)
    xs = torch.from_numpy(xs.astype(np.int64)).to(label.device)
    return label[ys][:, xs]


def size_prior_fallback(cfg: Config, extra: dict) -> Config:
    """The grouper's size cap for checkpoints without an active wh-head size
    gate, from the dataset stats stored at train time (largest GT box side
    in train-canvas pixels, rescaled to this canvas, times 1.5).  No-op when
    wh-head pruning is active (the default) or a cap is already set."""
    side = float(extra.get("max_gt_box_side_px", 0.0))
    train_canvas = float(extra.get("train_input_size", 0.0))
    prune_active = cfg.group.size_prune > 0 and cfg.model.use_wh_head
    if (side > 0 and train_canvas > 0 and cfg.group.max_box_size >= 1e9
            and not prune_active):
        side_here = side * cfg.infer.input_size / train_canvas
        cfg = dataclasses.replace(
            cfg, group=dataclasses.replace(
                cfg.group, max_box_size=1.5 * side_here / cfg.data.stride))
    return cfg


class Predictor:
    def __init__(self, cfg: Config, state_dict: dict,
                 device: str | torch.device = "cuda"):
        div = required_divisor(cfg.model)
        if cfg.infer.input_size % div:
            raise ValueError(f"infer.input_size {cfg.infer.input_size} must be "
                             f"divisible by {div}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = KGNet(cfg.model)
        self.model.load_state_dict(state_dict, strict=True)
        self._infer = build_infer_fn(self.model, cfg, device=self.device)

    @classmethod
    def from_checkpoint(cls, path: str, cfg: Config | None = None,
                        use_ema: bool = False,
                        device: str | torch.device = "cuda") -> "Predictor":
        """A Predictor on a checkpoint of the port's format.  Without `cfg`,
        the architecture comes from the checkpoint's stored config and the
        inference settings are the defaults; a given `cfg` is used whole."""
        state_dict, extra = ckpt.restore_bundle(path, use_ema=use_ema)
        if cfg is None:
            stored = ckpt.decode_config(extra)
            cfg = Config() if stored is None else dataclasses.replace(
                Config(), model=stored.model)
        return cls(size_prior_fallback(cfg, extra), state_dict, device=device)

    @torch.inference_mode()
    def predict(self, image: np.ndarray, score_thresh: float | None = None) -> dict:
        """image: [H, W, 3] uint8 RGB (or float in [0, 1]).  Returns numpy
        results in the input frame; label id k + 1 is row k of
        boxes/scores/masks."""
        if image.dtype != np.uint8:
            image = np.clip(image * 255.0, 0, 255).astype(np.uint8)
        h0, w0 = image.shape[:2]
        canvas = self.cfg.infer.input_size
        img = resize_image(torch.from_numpy(np.ascontiguousarray(image)).to(self.device),
                           canvas)
        out = self._infer(img[None])
        scale = max(h0, w0) / canvas
        boxes = out["boxes"][0].cpu().numpy() * scale
        scores = out["scores"][0].cpu().numpy()
        valid = out["valid"][0].cpu().numpy()
        if score_thresh is not None:
            valid = valid & (scores >= score_thresh)
        # renumber so id k + 1 indexes row k of the compacted outputs
        lut = np.zeros(len(valid) + 1, np.int32)
        lut[1:][valid] = np.arange(1, int(valid.sum()) + 1)
        lab = torch.from_numpy(lut).to(self.device)[out["label_map"][0].long()]
        span_h, span_w = round(h0 / scale), round(w0 / scale)
        lab = resize_nearest(lab[:span_h, :span_w], h0, w0)
        return {
            "boxes": boxes[valid],
            "scores": scores[valid],
            "masks": out["masks"][0].cpu().numpy()[valid],
            "label_map": lab.cpu().numpy().astype(np.int32),
            "num_instances": int(valid.sum()),
        }
