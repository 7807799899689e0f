"""Host-side transforms: counterpart of `kgtpu/data/transforms.py` without
cv2 (and of the NumPy paths of its native ops).

  * `resize_sample`: the eval path's letterbox-free resize to out_size²,
    image and label map, equal to kgtpu's cv2 `warpAffine` calls;
  * `boxes_from_label_map`, `renumber_label_map`: label map -> the train
    batch's instance contract.

The augmenting warps (`apply_affine` with a random matrix, elastic fields)
are ROADMAP item 4.
"""

from __future__ import annotations

import numpy as np
import torch


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


def warp_nearest_index(src: int, out_size: int) -> np.ndarray:
    """Source index of every destination index of cv2 5.0's
    `warpAffine(INTER_NEAREST)` with the scale matrix s = out_size / src:
    the f32 product x * (1 / s), rounded half to even.  (Not floor(x / s),
    nor a rounding half up: at 517 -> 512, destination 256 samples 258.5,
    which cv2 takes to 258.)  Indices >= src fall outside the image."""
    s = out_size / src
    inv = np.float32(s * (1.0 / (s * s)))       # cv2.invertAffineTransform
    return np.rint(np.arange(out_size, dtype=np.float32) * inv).astype(np.int64)


def resize_label_nearest(label: np.ndarray, out_size: int) -> np.ndarray:
    """[h, w] label map -> [out_size, out_size] int32: the long side scaled
    to out_size, anchored at the top-left corner, 0 outside the image; equal
    to kgtpu's `cv2.warpAffine(INTER_NEAREST, BORDER_CONSTANT 0)`."""
    h, w = label.shape
    idx = warp_nearest_index(max(h, w), out_size)
    ys, xs = idx[:, None], idx[None, :]
    out = label[np.minimum(ys, h - 1), np.minimum(xs, w - 1)].astype(np.int32)
    return np.where((ys < h) & (xs < w), out, 0)


def resize_sample(sample: dict, out_size: int) -> dict:
    """Deterministic letterbox-free resize to out_size² (the eval path):
    the image bilinear (`resize_image`), the label map nearest."""
    out = dict(sample)
    img = torch.from_numpy(np.ascontiguousarray(sample["image"]))
    out["image"] = resize_image(img, out_size).numpy()
    out["label_map"] = resize_label_nearest(sample["label_map"], out_size)
    return out




def boxes_from_label_map(label: np.ndarray, max_instances: int
                         ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Boxes (x0, y0, x1, y1) per instance id, area-ranked, padded to N.

    Returns (boxes [N, 4] f32, valid [N] f32, remap [N] int32): remap[i] is
    the original id of slot i (0 for padding).  Instances of fewer than 4
    pixels are dropped; the biggest survive truncation, ties by ascending id.
    """
    n = max_instances
    ids = np.unique(label)
    ids = ids[ids > 0]
    rows = []
    for i in ids:
        ys, xs = np.nonzero(label == i)
        if len(xs) < 4:               # clipped-away slivers
            continue
        rows.append((float(len(xs)), i, float(xs.min()), float(ys.min()),
                     float(xs.max() + 1), float(ys.max() + 1)))
    rows.sort(key=lambda r: (-r[0], r[1]))
    rows = rows[:n]

    boxes = np.zeros((n, 4), np.float32)
    valid = np.zeros((n,), np.float32)
    remap = np.zeros((n,), np.int32)
    for slot, (_, i, x0, y0, x1, y1) in enumerate(rows):
        boxes[slot] = (x0, y0, x1, y1)
        valid[slot] = 1.0
        remap[slot] = i
    return boxes, valid, remap


def renumber_label_map(label: np.ndarray, remap: np.ndarray) -> np.ndarray:
    """Renumber label ids so that slot i's instance has id i + 1 (0 stays
    background; ids of dropped instances become 0)."""
    out = np.zeros_like(label)
    for slot, orig in enumerate(remap):
        if orig > 0:
            out[label == orig] = slot + 1
    return out
