"""AV1's constrained directional enhancement filter, CDEF (specification
section 7.15), over a whole deblocked intra frame, as libaom 3.14's
decoder applies it.

Every 8x8 of luma whose 64x64 read a CDEF index (`cdef_idx` is not -1)
and whose four 4x4 units are not all skipped is filtered (7.15.1): the
direction and variance of its deblocked luma (`find_direction`, 7.15.2),
the luma primary strength scaled by that variance, then in each plane the
primary taps along the direction and the secondary taps along the
directions 45 degrees off it, each difference constrained by its strength
and damping, the result clipped to the taps' range (7.15.3).  Chroma takes
the luma direction through Cdef_Uv_Dir (4:2:2 remaps it).  A tap
outside the decoded area (MiRows * 4 by MiCols * 4) is not available:
libaom's CDEF_VERY_LARGE, which no constraint passes and no range takes.

The filter reads the deblocked frame and writes a copy of it, so no block
reads another's output.  Each plane's blocks are filtered together in
int64 NumPy arrays, the taps gathered by each block's direction.

`cdef(frame)` returns the filtered planes (`av1_decode.Frame`'s layout).
"""

from __future__ import annotations

import numpy as np

# Cdef_Directions: (dy, dx) of the taps k = 0, 1 along each direction
DIRECTIONS = np.array([[(-1, 1), (-2, 2)], [(0, 1), (-1, 2)], [(0, 1), (0, 2)],
                       [(0, 1), (1, 2)], [(1, 1), (2, 2)], [(1, 0), (2, 1)],
                       [(1, 0), (2, 0)], [(1, 0), (2, -1)]], np.int64)
# Cdef_Uv_Dir for 4:2:2 (AV1 has no 4:4:0; the other layouts keep the direction)
UV_DIR_422 = np.array([7, 0, 2, 4, 5, 6, 6, 6], np.int64)
PRI_TAPS = np.array([[4, 2], [3, 3]], np.int64)
SEC_TAPS = (2, 1)
DIV_TABLE = (0, 840, 420, 280, 210, 168, 140, 120, 105)
UNAVAILABLE = -1


def _direction_tables():
    """Per direction, the one-hot [64, 15] map from a pixel of the 8x8 to
    its line (the partial sums of 7.15.2) and the [15] cost weights."""
    maps = np.zeros((8, 64, 15), np.int64)
    for i in range(8):
        for j in range(8):
            for d, line in enumerate((i + j, i + j // 2, i, 3 + i - j // 2, 7 + i - j,
                                      3 - i // 2 + j, j, i // 2 + j)):
                maps[d, i * 8 + j, line] = 1
    weights = np.zeros((8, 15), np.int64)
    for d in (2, 6):
        weights[d, :8] = DIV_TABLE[8]
    for d in (0, 4):
        for i in range(7):
            weights[d, i] = weights[d, 14 - i] = DIV_TABLE[i + 1]
        weights[d, 7] = DIV_TABLE[8]
    for d in (1, 3, 5, 7):
        weights[d, 3:8] = DIV_TABLE[8]
        for j in range(3):
            weights[d, j] = weights[d, 10 - j] = DIV_TABLE[2 * j + 2]
    return maps, weights


LINES, COST_WEIGHTS = _direction_tables()


def find_direction(blocks: np.ndarray, bit_depth: int):
    """7.15.2 (libaom's cdef_find_dir) for [N, 8, 8] luma blocks: (the
    direction, the variance), each [N]."""
    x = (blocks.reshape(len(blocks), 64).astype(np.int64) >> (bit_depth - 8)) - 128
    cost = np.stack([((x @ LINES[d]) ** 2) @ COST_WEIGHTS[d] for d in range(8)], 1)
    best = np.argmax(cost, 1)  # the first of equal costs, as the strict > keeps
    rows = np.arange(len(x))
    return best, (cost[rows, best] - cost[rows, (best + 4) & 7]) >> 10


def _floor_log2(v: np.ndarray) -> np.ndarray:
    return np.frexp(np.maximum(v, 1))[1].astype(np.int64) - 1


def _constrain(diff, strength, damping):
    """constrain() of 7.15.3 (0 where the strength is 0)."""
    adj = np.maximum(0, damping - _floor_log2(strength))
    a = np.abs(diff)
    return np.sign(diff) * np.minimum(a, np.maximum(0, strength - (a >> adj)))


def filter_blocks(padded: np.ndarray, y0, x0, w: int, h: int, pri, sec, damping: int,
                  dirs, coeff_shift: int) -> np.ndarray:
    """cdef_filter (7.15.3) of N blocks of w x h at (y0, x0) in a plane
    held in `padded` (two samples of UNAVAILABLE around the decoded area);
    pri, sec, dirs [N].  The filtered [N, h, w]."""
    n = len(y0)
    ys = (y0[:, None, None] + np.arange(h)[None, :, None] + 2) * np.ones((1, 1, w), np.int64)
    xs = (x0[:, None, None] + np.arange(w)[None, None, :] + 2) * np.ones((1, h, 1), np.int64)
    bc = lambda v: np.asarray(v, np.int64).reshape(n, 1, 1)  # noqa: E731
    pri, sec, dirs = bc(pri), bc(sec), bc(dirs)
    x = padded[ys, xs]
    total = np.zeros_like(x)
    hi = x.copy()
    lo = x.copy()
    pri_taps = PRI_TAPS[(pri >> coeff_shift) & 1]  # [n, 1, 1, 2]
    for k in range(2):
        for sign in (-1, 1):
            for d, strength, tap in ((dirs, pri, pri_taps[..., k]),
                                     ((dirs - 2) & 7, sec, SEC_TAPS[k]),
                                     ((dirs + 2) & 7, sec, SEC_TAPS[k])):
                off = DIRECTIONS[d[..., 0, 0], k]  # [n, 2]
                v = padded[ys + sign * bc(off[:, 0]), xs + sign * bc(off[:, 1])]
                ok = v != UNAVAILABLE
                total += np.where(ok, tap * _constrain(v - x, strength, damping), 0)
                hi = np.where(ok, np.maximum(hi, v), hi)
                lo = np.where(ok, np.minimum(lo, v), lo)
    return np.clip(x + ((8 + total - (total < 0)) >> 4), lo, hi)


def cdef(fr) -> list:
    """7.15 over the deblocked `fr.planes`: the CDEF frame's planes."""
    fh = fr.fh
    bd = fr.bit_depth
    shift = bd - 8
    out = [p.copy() for p in fr.planes]
    r = np.arange(0, fh.mi_rows, 2)
    c = np.arange(0, fh.mi_cols, 2)
    rr, cc = np.meshgrid(r, c, indexing="ij")
    idx = fr.cdef_idx[rr >> 4, cc >> 4]
    sk = fr.skips
    skip = sk[rr, cc] & sk[rr + 1, cc] & sk[rr, cc + 1] & sk[rr + 1, cc + 1]
    on = (idx != -1) & ~skip
    rr, cc, idx = rr[on], cc[on], idx[on].astype(np.int64)
    if not len(rr):
        return out
    strengths = np.array(fh.cdef_strengths, np.int64)[idx]  # [N, 4]
    luma = fr.planes[0]
    y0, x0 = rr * 4, cc * 4
    blocks = luma[y0[:, None, None] + np.arange(8)[None, :, None],
                  x0[:, None, None] + np.arange(8)[None, None, :]]
    ydir, var = find_direction(blocks, bd)
    for plane in range(len(fr.planes)):
        sx = fr.ssx if plane else 0
        sy = fr.ssy if plane else 0
        pri = strengths[:, 2 if plane else 0] << shift
        sec = strengths[:, 3 if plane else 1] << shift
        if not (pri.any() or sec.any()):
            continue
        if plane == 0:
            dirs = np.where(pri == 0, 0, ydir)
            vs = np.where(var >> 6 != 0, np.minimum(_floor_log2(var >> 6), 12), 0)
            pri = np.where(var != 0, (pri * (4 + vs) + 8) >> 4, 0)
            damping = fh.cdef_damping + shift
        else:
            dirs = np.where(pri == 0, 0, UV_DIR_422[ydir] if (sx, sy) == (1, 0) else ydir)
            damping = fh.cdef_damping + shift - 1
        src = fr.planes[plane]
        hgt, wid = (fh.mi_rows * 4) >> sy, (fh.mi_cols * 4) >> sx
        padded = np.full((hgt + 4, wid + 4), UNAVAILABLE, np.int64)
        padded[2:-2, 2:-2] = src[:hgt, :wid]
        w, h = 8 >> sx, 8 >> sy
        py, px = y0 >> sy, x0 >> sx
        res = filter_blocks(padded, py, px, w, h, pri, sec, damping, dirs, shift)
        out[plane][py[:, None, None] + np.arange(h)[None, :, None],
                   px[:, None, None] + np.arange(w)[None, None, :]] = res
    return out
