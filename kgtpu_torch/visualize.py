"""Overlays of the served instances: counterpart of `kgtpu/visualize.py`
(`draw_instances`, `denormalize`), without cv2.

Pixel for pixel what kgtpu draws with cv2 5.0:
  * the masks blended over the image in NumPy, with kgtpu's palette
    (`default_rng(42)`, the same colours) and arithmetic;
  * `cv2.rectangle(thickness 1)` as its four edges drawn with cv2's
    8-connected line (`data.draw._line`, clipped to the image);
  * `cv2.putText(f"{score:.2f}", FONT_HERSHEY_SIMPLEX, 0.35, thickness 1)`,
    which cv2 5.0 draws anti-aliased, blended from a table of the pixels
    each of the 101 strings "0.00" ... "1.00" covers and their coverages
    (`assets_torch/glyphs_hershey_simplex_035.npz`, written by
    `tools/make_torch_glyphs.py`), clipped to the image.
"""

from __future__ import annotations

import functools
import os

import numpy as np

from kgtpu_torch.data.draw import _line

GLYPHS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "assets_torch", "glyphs_hershey_simplex_035.npz")


def _palette(n: int) -> np.ndarray:
    rng = np.random.default_rng(42)
    cols = rng.integers(64, 255, size=(max(n, 1), 3))
    return cols.astype(np.uint8)


@functools.lru_cache(maxsize=1)
def _glyphs() -> dict:
    """{string: ([N, 2] int64 (dy, dx) offsets from the text origin,
    [N, 2] int64 coverages in blending order)}."""
    with np.load(GLYPHS) as z:
        start, offsets, alpha = z["start"], z["offsets"].astype(np.int64), z["alpha"]
        return {str(s): (offsets[start[i]:start[i + 1]], alpha[start[i]:start[i + 1]].astype(np.int64))
                for i, s in enumerate(z["strings"])}


def rectangle(img: np.ndarray, p0: tuple[int, int], p1: tuple[int, int], color) -> None:
    """cv2.rectangle(img, p0, p1, color, 1) in place."""
    (x0, y0), (x1, y1) = p0, p1
    for a, b in (((x0, y0), (x1, y0)), ((x1, y0), (x1, y1)),
                 ((x1, y1), (x0, y1)), ((x0, y1), (x0, y0))):
        _line(img, a, b, color)


def put_score(img: np.ndarray, text: str, origin: tuple[int, int], color) -> None:
    """cv2.putText(img, text, origin, FONT_HERSHEY_SIMPLEX, 0.35, color, 1)
    in place, for text "0.00" ... "1.00": each pixel the text covers is
    blended with its coverages in turn, v <- (v (255 - a) + c a + 127) // 255
    (cv2 5.0's anti-aliased text), clipped to the image."""
    table = _glyphs()
    if text not in table:
        raise ValueError(f"no glyphs for {text!r}: the table holds '0.00' ... '1.00'")
    off, alpha = table[text]
    ys, xs = off[:, 0] + origin[1], off[:, 1] + origin[0]
    inside = (ys >= 0) & (ys < img.shape[0]) & (xs >= 0) & (xs < img.shape[1])
    ys, xs, alpha = ys[inside], xs[inside], alpha[inside]
    c = np.asarray(color, np.int64)
    v = img[ys, xs].astype(np.int64)
    for k in range(alpha.shape[1]):
        a = alpha[:, k].reshape((-1,) + (1,) * (v.ndim - 1))
        v = (v * (255 - a) + c * a + 127) // 255
    img[ys, xs] = v.astype(img.dtype)


def draw_instances(image: np.ndarray, label_map: np.ndarray,
                   boxes: np.ndarray, scores: np.ndarray,
                   valid: np.ndarray, alpha: float = 0.45) -> np.ndarray:
    """Overlay instance masks + boxes + scores on a uint8 RGB image."""
    vis = image.copy()
    n = int(label_map.max())
    cols = _palette(n + 1)
    mask_any = label_map > 0
    color_img = cols[np.clip(label_map, 0, n)]
    vis[mask_any] = (alpha * color_img[mask_any]
                     + (1 - alpha) * vis[mask_any]).astype(np.uint8)
    for d in np.nonzero(valid)[0]:
        x0, y0, x1, y1 = boxes[d].astype(int)
        c = cols[(d + 1) % len(cols)]
        rectangle(vis, (int(x0), int(y0)), (int(x1), int(y1)), c)
        put_score(vis, f"{scores[d]:.2f}", (int(x0), max(int(y0) - 3, 8)), c)
    return vis


def denormalize(image: np.ndarray, mean, std) -> np.ndarray:
    """Undo DataConfig normalization -> uint8 RGB."""
    img = image * np.asarray(std, np.float32) + np.asarray(mean, np.float32)
    return np.clip(img * 255.0, 0, 255).astype(np.uint8)
