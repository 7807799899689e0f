"""Host-side transforms: counterpart of `kgtpu/data/transforms.py` without
cv2.

kgtpu warps with cv2 5.0; here the same arithmetic is written out, so each
function equals kgtpu's result exactly:

  * `get_rotation_matrix_2d`, `invert_affine`: cv2.getRotationMatrix2D and
    cv2.invertAffineTransform, in f64;
  * `random_affine_params`: the augmentation matrix, drawn as kgtpu draws it;
  * `warp_affine_linear` (uint8 images) and `warp_affine_nearest` (label
    maps): cv2.warpAffine(INTER_LINEAR / INTER_NEAREST, BORDER_CONSTANT 0).
    cv2 inverts the matrix, casts it to f32 and maps each destination pixel
    (x, y) to the source point X = fma(m00, x, f32(f32(m01 * y) + m02)),
    Y likewise; nearest takes rint(X), rint(Y) (halves to even), linear
    blends the four taps along x, then along y, as FMAs (`sample_linear`);
    taps outside the source read 0;
  * `resize_image`, `resize_label_nearest`, `resize_sample`: the eval path's
    letterbox-free resize, the warps with the scale matrix;
  * `resize_nearest`: cv2.resize(INTER_NEAREST) to any (w, h), which is
    not the nearest warp: it floors x * (1 / (w_dst / w_src)) in f64;
  * `apply_affine`, `random_elastic_field`, `apply_elastic`: the train-time
    augmentation.  cv2.remap with f32 maps samples as warpAffine does, with
    the maps as the source points;
  * `boxes_from_label_map`, `renumber_label_map`: label map -> the train
    batch's instance contract, through the compiled host ops
    (`kgtpu_torch/native.py`) where g++ built them, as kgtpu takes its own,
    else through NumPy with the same results.

The warps run as torch ops, which release the interpreter lock, so the
loader's worker threads overlap.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from kgtpu_torch import native
from kgtpu_torch.data import draw


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c for f32 tensors (broadcast) with one rounding, as an FMA unit
    gives it.

    The product of two f32 values is exact in f64, and the f64 sum rounds
    to f32 right unless it lies exactly half-way between two f32 values (the
    29 bits f64 keeps below f32's mantissa read 1 then 28 zeros) after the
    f64 sum itself was rounded.  Only there the sum's error (TwoSum) decides
    the direction; f32's subnormal range takes that check too."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    r = s.float()
    tie = ((s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000) | (s.abs() < 2.0 ** -125)
    if bool(tie.any()):
        pt, ct, st, rt = p.expand_as(s)[tie], c.expand_as(s)[tie], s[tie], r[tie]
        z = st - pt
        err = (pt - (st - z)) + (ct - z)           # st + err == pt + ct exactly
        toward = torch.nextafter(rt, torch.where(err > 0, torch.inf, -torch.inf).float())
        fix = (err != 0) & ((rt.double() + toward.double()) * 0.5 == st)
        r[tie] = torch.where(fix, toward, rt)
    return r


def get_rotation_matrix_2d(center: tuple[float, float], angle: float,
                           scale: float) -> np.ndarray:
    """cv2.getRotationMatrix2D: [2, 3] f64 (the center is taken as f32)."""
    cx, cy = (float(np.float32(v)) for v in center)
    a = angle * (math.pi / 180)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def invert_affine(m: np.ndarray) -> np.ndarray:
    """cv2.invertAffineTransform in f64 (a singular matrix gives zeros)."""
    m = np.asarray(m, np.float64)
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22, a12, a21 = m[1, 1] * d, m[0, 0] * d, -m[0, 1] * d, -m[1, 0] * d
    b1 = -a11 * m[0, 2] - a12 * m[1, 2]
    b2 = -a21 * m[0, 2] - a22 * m[1, 2]
    return np.array([[a11, a12, b1], [a21, a22, b2]])


def random_affine_params(rng: np.random.Generator, out_size: int,
                         src_hw: tuple[int, int],
                         scale_range=(0.8, 1.2), rotate_deg: float = 0.0,
                         flip_prob: float = 0.5) -> np.ndarray:
    """Sample a 2x3 affine mapping src image -> out_size canvas: the long
    side fitted and scaled by U(scale_range), rotated by U(+-rotate_deg)
    about the source center, that center moved to the canvas center +-10%,
    and a horizontal flip about the canvas center with flip_prob.  The same
    draws in the same order as kgtpu's."""
    sh, sw = src_hw
    base = out_size / max(sh, sw)
    scale = base * rng.uniform(*scale_range)
    ang = rng.uniform(-rotate_deg, rotate_deg) if rotate_deg > 0 else 0.0
    flip = rng.uniform() < flip_prob

    m = get_rotation_matrix_2d((sw / 2, sh / 2), ang, scale)
    cx_src = m[0, 0] * (sw / 2) + m[0, 1] * (sh / 2) + m[0, 2]
    cy_src = m[1, 0] * (sw / 2) + m[1, 1] * (sh / 2) + m[1, 2]
    jitter = 0.1 * out_size
    tx = out_size / 2 + rng.uniform(-jitter, jitter) - cx_src
    ty = out_size / 2 + rng.uniform(-jitter, jitter) - cy_src
    m[0, 2] += tx
    m[1, 2] += ty
    if flip:
        f = np.array([[-1.0, 0.0, out_size], [0.0, 1.0, 0.0]])
        m3 = np.vstack([m, [0, 0, 1]])
        m = (np.vstack([f, [0, 0, 1]]) @ m3)[:2]
    return m


def affine_points(m: np.ndarray, out_h: int, out_w: int,
                  device: str | torch.device = "cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """The f32 source points [out_h, out_w] (X, Y) that cv2.warpAffine reads
    for each destination pixel under the forward matrix `m`."""
    inv = torch.from_numpy(invert_affine(m).astype(np.float32)).to(device)
    x = torch.arange(out_w, device=device, dtype=torch.float32)[None, :].expand(out_h, out_w)
    y = torch.arange(out_h, device=device, dtype=torch.float32)[:, None]
    pts = []
    for r in range(2):
        row = (inv[r, 1] * y + inv[r, 2]).expand(out_h, out_w)   # f32, two roundings
        pts.append(_fma(inv[r, 0].expand(out_h, out_w), x, row))
    return pts[0], pts[1]


def sample_linear(image: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """[h, w, C] uint8 sampled bilinearly at f32 points [H, W] -> [H, W, C]
    uint8, as cv2 5.0's warpAffine and remap do: floor and fraction of each
    point, taps outside the image read 0, then top = fma(ax, p01 - p00, p00),
    bottom = fma(ax, p11 - p10, p10), out = fma(ay, bottom - top, top),
    rounded half to even.  The order matters only within an ulp of a half,
    where one more rounding moves the result by one."""
    h, w = image.shape[:2]
    img = image.float().reshape(h * w, -1)
    x0f, y0f = torch.floor(xs), torch.floor(ys)
    ax, ay = (xs - x0f)[..., None], (ys - y0f)[..., None]
    x0, y0 = x0f.long(), y0f.long()

    def tap(yy, xx):
        ok = ((yy >= 0) & (yy < h) & (xx >= 0) & (xx < w))[..., None]
        v = img[(yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).reshape(-1)]
        return torch.where(ok, v.reshape(*yy.shape, -1), 0.0)

    p00, p01 = tap(y0, x0), tap(y0, x0 + 1)
    p10, p11 = tap(y0 + 1, x0), tap(y0 + 1, x0 + 1)
    top = _fma(ax.expand_as(p00), p01 - p00, p00)
    bottom = _fma(ax.expand_as(p10), p11 - p10, p10)
    out = _fma(ay.expand_as(top), bottom - top, top)
    return torch.round(out).clamp(0, 255).to(torch.uint8)


def sample_nearest(label: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """[h, w] sampled at the nearest pixel of f32 points [H, W] (rint, halves
    to even), 0 outside the image; the dtype is kept."""
    h, w = label.shape
    xi, yi = torch.round(xs).long(), torch.round(ys).long()
    ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    v = label.reshape(-1)[(yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(-1)]
    return torch.where(ok, v.reshape(ok.shape), torch.zeros((), dtype=label.dtype))


def warp_affine_linear(image: torch.Tensor, m: np.ndarray, out_size: int) -> torch.Tensor:
    """cv2.warpAffine(image, m, (out_size, out_size), INTER_LINEAR,
    BORDER_CONSTANT 0) for a [h, w, C] uint8 tensor (on any device)."""
    xs, ys = affine_points(m, out_size, out_size, image.device)
    return sample_linear(image, xs, ys)


def _label_warp(lab: np.ndarray, sample) -> np.ndarray:
    """kgtpu's label branches: ids below 2^16 travel as uint16, larger ones
    as f32; the result is int32."""
    src = (lab.astype(np.uint16).astype(np.int32) if lab.max() < 2 ** 16
           else lab.astype(np.float32))
    return sample(torch.from_numpy(src)).numpy().astype(np.int32)


def warp_affine_nearest(label: np.ndarray, m: np.ndarray, out_size: int) -> np.ndarray:
    """kgtpu's label warp: cv2.warpAffine(INTER_NEAREST, BORDER_CONSTANT 0)
    of the label map as uint16 (ids < 2^16) or f32 (larger ids), -> int32."""
    xs, ys = affine_points(m, out_size, out_size)
    return _label_warp(np.asarray(label), lambda t: sample_nearest(t, xs, ys))


def _scale_matrix(hw: tuple[int, int], out_size: int) -> np.ndarray:
    s = out_size / max(hw)
    return np.array([[s, 0.0, 0.0], [0.0, s, 0.0]])


def resize_image(image: torch.Tensor, out_size: int) -> torch.Tensor:
    """[H, W, 3] uint8 -> [out_size, out_size, 3] uint8: the long side scaled
    to out_size, anchored at the top-left corner, zero elsewhere (the
    linear warp with the scale matrix)."""
    return warp_affine_linear(image, _scale_matrix(image.shape[:2], out_size), out_size)


def resize_label_nearest(label: np.ndarray, out_size: int) -> np.ndarray:
    """[h, w] label map -> [out_size, out_size] int32: the long side scaled
    to out_size, anchored at the top-left corner, 0 outside the image (the
    nearest warp with the scale matrix).  cv2 5.0's nearest warp is
    rint(f32(x) * f32(1 / s)): neither a floor nor a rounding half up (at
    517 -> 512, destination 256 samples 258.5, which it takes to 258)."""
    label = np.asarray(label)
    xs, ys = affine_points(_scale_matrix(label.shape, out_size), out_size, out_size)
    return sample_nearest(torch.from_numpy(label.astype(np.int64)), xs, ys).numpy().astype(np.int32)


def resize_nearest(src: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """cv2.resize(src, (w, h), interpolation=INTER_NEAREST): destination
    pixel x reads source min(floor(x * ifx), w_src - 1), where ifx is
    1 / (w / w_src) in f64 (not w_src / w: the two differ in the last bit
    at some sizes, and the floor with them); rows likewise."""
    w, h = size
    sh, sw = src.shape[:2]
    ifx, ify = 1.0 / (w / sw), 1.0 / (h / sh)
    xs = np.minimum(np.floor(np.arange(w) * ifx).astype(np.int64), sw - 1)
    ys = np.minimum(np.floor(np.arange(h) * ify).astype(np.int64), sh - 1)
    return src[ys[:, None], xs[None, :]]


def apply_affine(sample: dict, m: np.ndarray, out_size: int,
                 color_jitter: float = 0.0,
                 rng: np.random.Generator | None = None) -> dict:
    """Warp image + label map with the shared affine; optional color jitter
    (kgtpu's f64 gain and bias, truncated to uint8)."""
    img = warp_affine_linear(torch.from_numpy(np.ascontiguousarray(sample["image"])),
                             m, out_size).numpy()
    label = warp_affine_nearest(sample["label_map"], m, out_size)
    if color_jitter > 0 and rng is not None:
        gain = rng.uniform(1 - color_jitter, 1 + color_jitter, 3)
        bias = rng.uniform(-color_jitter, color_jitter, 3) * 30
        img = np.clip(img.astype(np.float32) * gain + bias, 0, 255).astype(np.uint8)
    out = dict(sample)
    out["image"], out["label_map"] = img, label
    return out


def random_elastic_field(rng: np.random.Generator, out_size: int,
                         alpha: float, sigma: float) -> np.ndarray:
    """Smooth random displacement field [H, W, 2] f32 in pixels (Simard
    2003): U(-1, 1) noise on a grid every ~sigma px, bicubic-upsampled to the
    canvas (`draw.resize_cubic_f32`, cv2's INTER_CUBIC), scaled by alpha."""
    g = max(int(np.ceil(out_size / max(sigma, 1.0))) + 1, 2)
    field = rng.uniform(-1.0, 1.0, (g, g, 2)).astype(np.float32)
    return draw.resize_cubic_f32(field, (out_size, out_size)) * alpha


def apply_elastic(sample: dict, field: np.ndarray) -> dict:
    """Warp image (bilinear) + label map (nearest) by the shared field, as
    kgtpu's cv2.remap with the f32 maps x + field[..., 0], y + field[..., 1]
    and a constant-0 border."""
    h, w = sample["label_map"].shape
    f = torch.from_numpy(np.ascontiguousarray(field, np.float32))
    xs = torch.arange(w, dtype=torch.float32)[None, :] + f[..., 0]
    ys = torch.arange(h, dtype=torch.float32)[:, None] + f[..., 1]
    img = sample_linear(torch.from_numpy(np.ascontiguousarray(sample["image"])), xs, ys).numpy()
    label = _label_warp(sample["label_map"], lambda t: sample_nearest(t, xs, ys))
    out = dict(sample)
    out["image"], out["label_map"] = img, label
    return out


def resize_sample(sample: dict, out_size: int) -> dict:
    """Deterministic letterbox-free resize to out_size² (the eval path)."""
    return apply_affine(sample, _scale_matrix(sample["label_map"].shape, out_size), out_size)


def boxes_from_label_map(label: np.ndarray, max_instances: int
                         ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Boxes (x0, y0, x1, y1) per instance id, area-ranked, padded to N.

    Returns (boxes [N, 4] f32, valid [N] f32, remap [N] int32): remap[i] is
    the original id of slot i (0 for padding).  Instances of fewer than 4
    pixels are dropped; the biggest survive truncation, ties by ascending id.
    One pass in the compiled op, else per-id scans in NumPy.
    """
    out = native.boxes_from_label_map(label, max_instances)
    if out is not None:
        return out
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
    background; ids of dropped instances become 0), as int32."""
    out = native.renumber_label_map(label, remap)
    if out is not None:
        return out
    out = np.zeros(np.shape(label), np.int32)
    for slot, orig in enumerate(remap):
        if orig > 0:
            out[label == orig] = slot + 1
    return out
