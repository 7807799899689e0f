"""Serving API: one image in, instances out.  Counterpart of
`kgtpu/predictor.py::Predictor` (`__init__` and `predict`), built from a
`Config` and a `state_dict` (see `kgtpu_torch.convert` for flax params).

    p = Predictor(cfg, state_dict)            # on the GPU
    result = p.predict(image_uint8)           # [H, W, 3] RGB, any size
    result["label_map"], result["boxes"], result["scores"], result["masks"]

The image is resized onto the square canvas (long side fits, no letterbox
offset) and results come back in the input frame.  The two resizes follow
cv2, which the JAX package uses, without needing it:

  * image: `cv2.warpAffine(INTER_LINEAR, BORDER_CONSTANT 0)` with the scale
    matrix, in cv2 5.0's f32 arithmetic: destination pixel x samples source
    x / s (no half-pixel shift, taps outside the image read 0), interpolated
    along x and then along y as fused multiply-adds, rounded half to even;
  * label map: `cv2.resize(INTER_NEAREST)`: source index floor(x * src/dst).
"""

from __future__ import annotations

import numpy as np
import torch

from kgtpu_torch.config import Config, required_divisor
from kgtpu_torch.device import resolve_device
from kgtpu_torch.infer import build_infer_fn
from kgtpu_torch.models import KGNet


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c for f32 tensors with one rounding, as an FMA unit gives it.

    The product of two f32 values is exact in f64; the f64 sum may round,
    and its error (TwoSum) breaks the one case where rounding that sum to
    f32 would round twice: a sum that lies on a tie between two floats."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    z = s - p
    err = (p - (s - z)) + (c - z)                  # s + err == p + c exactly
    r = s.float()
    toward = torch.nextafter(r, torch.where(err > 0, torch.inf, -torch.inf).float())
    tie = (err != 0) & ((r.double() + toward.double()) * 0.5 == s)
    return torch.where(tie, toward, r)


def resize_image(image: torch.Tensor, out_size: int) -> torch.Tensor:
    """[H, W, 3] uint8 -> [out_size, out_size, 3] uint8: the long side scaled
    to out_size, anchored at the top-left corner, zero elsewhere.  Equal to
    cv2 5.0's warpAffine: the f32 source position x * (1 / s), its floor and
    fraction, then top = fma(ax, p01 - p00, p00), bottom = fma(ax, p11 - p10,
    p10), out = fma(ay, bottom - top, top).  The order matters only at
    values within an ulp of a half: there one product rounding more (the
    four-weight sum) moves the result by one."""
    h, w = image.shape[:2]
    s = out_size / max(h, w)
    inv = s * (1.0 / (s * s))         # cv2.invertAffineTransform's 1/s
    pos = np.arange(out_size, dtype=np.float32) * np.float32(inv)
    i0 = np.floor(pos).astype(np.int64)
    frac = pos - i0.astype(np.float32)
    dev = image.device
    img = image.float()
    lo = torch.from_numpy(i0).to(dev)

    def tap(yy, xx):
        v = img[yy.clamp(max=h - 1)][:, xx.clamp(max=w - 1)]
        ok = ((yy < h)[:, None] & (xx < w)[None, :])[..., None]
        return torch.where(ok, v, torch.zeros_like(v))

    p00, p01 = tap(lo, lo), tap(lo, lo + 1)
    p10, p11 = tap(lo + 1, lo), tap(lo + 1, lo + 1)
    f = torch.from_numpy(frac).to(dev)
    ax, ay = f[None, :, None], f[:, None, None]
    top = _fma(ax.expand_as(p00), p01 - p00, p00)
    bottom = _fma(ax.expand_as(p10), p11 - p10, p10)
    out = _fma(ay.expand_as(top), bottom - top, top)
    return torch.round(out).clamp(0, 255).to(torch.uint8)


def resize_nearest(label: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[h, w] label map -> [height, width], nearest (ids are not blended)."""
    h, w = label.shape
    ys = np.minimum(np.floor(np.arange(height) * (1.0 / (height / h))), h - 1)
    xs = np.minimum(np.floor(np.arange(width) * (1.0 / (width / w))), w - 1)
    ys = torch.from_numpy(ys.astype(np.int64)).to(label.device)
    xs = torch.from_numpy(xs.astype(np.int64)).to(label.device)
    return label[ys][:, xs]


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
