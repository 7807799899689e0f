"""Whole-slide sliding-window tiling: counterpart of `kgtpu/ops/tiling.py`
(`tile_grid`, `extract_tiles`, `ownership_rects`, `ownership_mask`,
`stitch_tiles`).

The tile grid is fixed by the slide's shape, the tile size and the overlap.
Duplicates across tiles are suppressed by ownership: the plane is
partitioned among the tiles (boundaries at the midpoints of overlaps, the
outer tiles reaching to +-inf), and a tile keeps only the detections whose
center lies in its own part, so every object is reported by one tile when
the overlap exceeds the largest object.  Stitching then needs no global
NMS: per-tile (label, score) canvases merge by score.
"""

from __future__ import annotations

import numpy as np
import torch

from kgtpu_torch.ops.group import Boxes


def tile_grid(height: int, width: int, tile: int, overlap: int) -> np.ndarray:
    """[T, 2] int32 tile origins (oy, ox) covering the image, row-major.

    Stride = tile - overlap; the last tile of each axis is clamped so that
    it ends at the image border (it may overlap its neighbour more)."""
    assert tile <= height and tile <= width, "image smaller than tile"
    stride = tile - overlap
    ys = list(range(0, max(height - tile, 0) + 1, stride))
    if ys[-1] != height - tile:
        ys.append(height - tile)
    xs = list(range(0, max(width - tile, 0) + 1, stride))
    if xs[-1] != width - tile:
        xs.append(width - tile)
    return np.asarray([(y, x) for y in ys for x in xs], np.int32)


def _pairs(origins) -> list:
    """Tile origins as Python (oy, ox) pairs: from a list of pairs as it is,
    from an array or a tensor through `.tolist()`."""
    return origins.tolist() if hasattr(origins, "tolist") else origins


def extract_tiles(image: torch.Tensor, origins, tile: int) -> torch.Tensor:
    """image [H, W, C], origins [T, 2] (oy, ox; Python ints, an array or a
    tensor) -> [T, tile, tile, C]."""
    return torch.stack([image[oy:oy + tile, ox:ox + tile] for oy, ox in _pairs(origins)])


def ownership_rects(origins: np.ndarray, tile: int) -> np.ndarray:
    """[T, 4] float32 owned regions (lo_x, lo_y, hi_x, hi_y) in image
    coordinates: a partition of the plane, with each boundary at the
    midpoint of the two tiles' overlap and +-inf beyond the outer tiles."""

    def axis_bounds(starts: np.ndarray) -> tuple[dict, dict]:
        uniq = np.unique(starts)
        lo, hi = {}, {}
        for i, o in enumerate(uniq):
            lo[o] = -np.inf if i == 0 else (uniq[i - 1] + o + tile) / 2.0
            hi[o] = np.inf if i == len(uniq) - 1 else (o + uniq[i + 1] + tile) / 2.0
        return lo, hi

    ylo, yhi = axis_bounds(origins[:, 0])
    xlo, xhi = axis_bounds(origins[:, 1])
    rects = np.asarray([[xlo[ox], ylo[oy], xhi[ox], yhi[oy]] for oy, ox in origins],
                       np.float64)
    return rects.astype(np.float32)


def ownership_mask(dets: Boxes, origin: torch.Tensor, rect: torch.Tensor) -> torch.Tensor:
    """[..., D] bool: the valid detections (boxes [..., D, 4] in tile-local
    pixels) whose center lies in the tile's owned region; origin [..., 2]
    (oy, ox) and rect [..., 4] (`ownership_rects`, image coordinates).
    Half-open [lo, hi) bounds, so ownership is a partition."""
    b = dets.boxes
    cy = (b[..., 1] + b[..., 3]) * 0.5 + origin[..., 0, None]
    cx = (b[..., 0] + b[..., 2]) * 0.5 + origin[..., 1, None]
    return ((cy >= rect[..., 1, None]) & (cy < rect[..., 3, None])
            & (cx >= rect[..., 0, None]) & (cx < rect[..., 2, None]) & dets.valid)


def stitch_tiles(local_labels: torch.Tensor, local_scores: torch.Tensor, origins,
                 height: int, width: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge per-tile canvases, local_labels [T, ts, ts] int32 (globally
    unique ids or 0) and local_scores [T, ts, ts] float32, into the
    [height, width] frame; origins [T, 2] as in `extract_tiles`.  One slice
    read-modify-write per tile, in tile order: a pixel takes a tile's label
    where its score is strictly above the canvas's, so ties keep the lowest
    tile."""
    ts = local_labels.shape[1]
    label = torch.zeros((height, width), dtype=torch.int32, device=local_labels.device)
    score = torch.zeros((height, width), dtype=torch.float32, device=local_labels.device)
    for t, (oy, ox) in enumerate(_pairs(origins)):
        cur_l = label[oy:oy + ts, ox:ox + ts]
        cur_s = score[oy:oy + ts, ox:ox + ts]
        better = local_scores[t] > cur_s
        cur_l.copy_(torch.where(better, local_labels[t], cur_l))
        cur_s.copy_(torch.where(better, local_scores[t], cur_s))
    return label, score
