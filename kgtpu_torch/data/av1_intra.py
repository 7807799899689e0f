"""AV1 intra prediction (specification section 7.11.2) and the chroma-
from-luma and palette predictions (7.11.4-5): DC, V / H and the other
directional modes with the intra edge filter and upsampling, Paeth, the
three smooth modes and recursive filter intra.  Each works on a whole
block with NumPy; the edges are gathered as the specification's AboveRow
and LeftCol (index 0 of the arrays here is position -1 there), the edge
filters run along them in Python (at most 129 samples).
"""

from __future__ import annotations

import numpy as np

from kgtpu_torch.data.av1_tables import (DR_DERIVATIVE, FILTER_INTRA_TAPS, MODE_TO_ANGLE,
                                         SMOOTH_WEIGHTS)

(DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D113_PRED, D157_PRED, D203_PRED, D67_PRED,
 SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED, PAETH_PRED) = range(13)
UV_CFL_PRED = 13
EDGE_KERNEL = ((0, 4, 8, 4, 0), (0, 5, 6, 5, 0), (2, 4, 4, 4, 2))
_SW = {}
for _n, _off in ((2, 0), (3, 4), (4, 12), (5, 28), (6, 60)):
    _SW[_n] = np.array(SMOOTH_WEIGHTS[_off:_off + (1 << _n)], np.int64)
_TAPS = np.array(FILTER_INTRA_TAPS, np.int64)  # [mode][8 outputs][7 inputs]


def is_directional(mode: int) -> bool:
    return V_PRED <= mode <= D67_PRED


def edge_filter_strength(w: int, h: int, filter_type: int, delta: int) -> int:
    d = abs(delta)
    s = w + h
    if filter_type == 0:
        if s <= 8:
            return 1 if d >= 56 else 0
        if s <= 16:
            return 1 if d >= 40 else 0
        if s <= 24:
            return 3 if d >= 32 else 2 if d >= 16 else 1 if d >= 8 else 0
        if s <= 32:
            return 3 if d >= 32 else 2 if d >= 4 else 1 if d >= 1 else 0
        return 3 if d >= 1 else 0
    if s <= 8:
        return 2 if d >= 64 else 1 if d >= 40 else 0
    if s <= 16:
        return 2 if d >= 48 else 1 if d >= 20 else 0
    if s <= 24:
        return 3 if d >= 4 else 0
    return 3 if d >= 1 else 0


def use_upsample(w: int, h: int, filter_type: int, delta: int) -> int:
    d = abs(delta)
    if d == 0 or d >= 40:
        return 0
    return int(w + h <= (8 if filter_type else 16))


def _filter_edge(e: list, sz: int, strength: int) -> None:
    """The intra edge filter (7.11.2.12) over e[0:sz] (e[0] the corner)."""
    if not strength:
        return
    k = EDGE_KERNEL[strength - 1]
    edge = e[:sz]
    last = sz - 1
    for i in range(1, sz):
        s = 0
        for j in range(5):
            q = i - 2 + j
            s += k[j] * edge[0 if q < 0 else last if q > last else q]
        e[i] = (s + 8) >> 4


def _upsample(e: list, num: int, maxv: int) -> list:
    """The intra edge upsample process (7.11.2.11): returns the new edge
    with index 0 at position -2."""
    dup = [e[0], e[0]] + e[1:num + 1] + [e[num]]
    out = [0] * (2 * num + 2)
    out[0] = dup[0]
    for i in range(num):
        s = -dup[i] + 9 * dup[i + 1] + 9 * dup[i + 2] - dup[i + 3]
        s = (s + 8) >> 4
        out[2 * i + 1] = 0 if s < 0 else maxv if s > maxv else s
        out[2 * i + 2] = dup[i + 2]
    return out


def predict_intra(frame: np.ndarray, x: int, y: int, have_left: bool, have_above: bool,
                  have_above_right: bool, have_below_left: bool, mode: int, log2w: int,
                  log2h: int, max_x: int, max_y: int, bit_depth: int, angle_delta: int,
                  filter_intra_mode: int, edge_filter: bool, filter_type_fn) -> np.ndarray:
    """The intra prediction process: the [h, w] prediction of the block at
    (x, y) of `frame` (one plane).  max_x / max_y are the plane's last
    column and row inside MiCols / MiRows; `filter_intra_mode` is -1 or
    the filter intra mode; `filter_type_fn()` gives get_filter_type."""
    w, h = 1 << log2w, 1 << log2h
    n = w + h
    base = 1 << (bit_depth - 1)
    # above[0] / left[0] are AboveRow[-1] / LeftCol[-1]
    if not have_above and have_left:
        above = [int(frame[y, x - 1])] * (n + 1)
    elif not have_above:
        above = [base - 1] * (n + 1)
    else:
        lim = min(max_x, x + (2 * w if have_above_right else w) - 1)
        row = frame[y - 1, x:lim + 1].tolist()
        above = [0] + row + [row[-1]] * (n - len(row))
    if not have_left and have_above:
        left = [int(frame[y - 1, x])] * (n + 1)
    elif not have_left:
        left = [base + 1] * (n + 1)
    else:
        lim = min(max_y, y + (2 * h if have_below_left else h) - 1)
        col = frame[y:lim + 1, x - 1].tolist()
        left = [0] + col + [col[-1]] * (n - len(col))
    if have_above and have_left:
        corner = int(frame[y - 1, x - 1])
    elif have_above:
        corner = int(frame[y - 1, x])
    elif have_left:
        corner = int(frame[y, x - 1])
    else:
        corner = base
    above[0] = left[0] = corner
    maxv = (1 << bit_depth) - 1
    if filter_intra_mode >= 0:
        return _filter_intra(above, left, w, h, filter_intra_mode, maxv)
    if is_directional(mode):
        return _directional(above, left, w, h, x, y, max_x, max_y, have_above, have_left,
                            MODE_TO_ANGLE[mode] + 3 * angle_delta, edge_filter, filter_type_fn,
                            maxv)
    if mode == DC_PRED:
        if have_above and have_left:
            avg = (sum(above[1:w + 1]) + sum(left[1:h + 1]) + (n >> 1)) // n
        elif have_left:
            avg = (sum(left[1:h + 1]) + (h >> 1)) >> log2h
        elif have_above:
            avg = (sum(above[1:w + 1]) + (w >> 1)) >> log2w
        else:
            avg = base
        return np.full((h, w), avg, np.int64)
    a = np.array(above[1:w + 1], np.int64)
    lft = np.array(left[1:h + 1], np.int64)
    if mode == PAETH_PRED:
        base_ = a[None, :] + lft[:, None] - corner
        p_left = np.abs(base_ - lft[:, None])
        p_top = np.abs(base_ - a[None, :])
        p_tl = np.abs(base_ - corner)
        out = np.where((p_left <= p_top) & (p_left <= p_tl), lft[:, None],
                       np.where(p_top <= p_tl, a[None, :], corner))
        return out.astype(np.int64)
    if mode == SMOOTH_PRED:
        wy, wx = _SW[log2h][:, None], _SW[log2w][None, :]
        s = wy * a[None, :] + (256 - wy) * left[h] + wx * lft[:, None] + (256 - wx) * above[w]
        return (s + 256) >> 9
    if mode == SMOOTH_V_PRED:
        wy = _SW[log2h][:, None]
        return (wy * a[None, :] + (256 - wy) * left[h] + 128) >> 8
    wx = _SW[log2w][None, :]  # SMOOTH_H_PRED
    return (wx * lft[:, None] + (256 - wx) * above[w] + 128) >> 8


def _directional(above, left, w, h, x, y, max_x, max_y, have_above, have_left, p_angle,
                 edge_filter, filter_type_fn, maxv) -> np.ndarray:
    up_above = up_left = 0
    if edge_filter:
        if p_angle != 90 and p_angle != 180:
            if 90 < p_angle < 180 and w + h >= 24:
                v = (left[1] * 5 + above[0] * 6 + above[1] * 5 + 8) >> 4
                above[0] = left[0] = v
            ftype = filter_type_fn()
            if have_above:
                strength = edge_filter_strength(w, h, ftype, p_angle - 90)
                num = min(w, max_x - x + 1) + (h if p_angle < 90 else 0) + 1
                _filter_edge(above, num, strength)
            if have_left:
                strength = edge_filter_strength(w, h, ftype, p_angle - 180)
                num = min(h, max_y - y + 1) + (w if p_angle > 180 else 0) + 1
                _filter_edge(left, num, strength)
        else:
            ftype = 0
        up_above = use_upsample(w, h, ftype, p_angle - 90)
        if up_above:
            above = _upsample(above, w + (h if p_angle < 90 else 0), maxv)
        up_left = use_upsample(w, h, ftype, p_angle - 180)
        if up_left:
            left = _upsample(left, h + (w if p_angle > 180 else 0), maxv)
    # offsets: index of position 0 in the lists
    oa = 2 if up_above else 1
    ol = 2 if up_left else 1
    A = np.array(above + [above[-1]] * 2, np.int64)
    L = np.array(left + [left[-1]] * 2, np.int64)
    if p_angle == 90:
        return np.repeat(A[oa:oa + w][None, :], h, 0)
    if p_angle == 180:
        return np.repeat(L[ol:ol + h][:, None], w, 1)
    i = np.arange(h)[:, None]
    j = np.arange(w)[None, :]
    if p_angle < 90:
        dx = DR_DERIVATIVE[p_angle]
        idx = (i + 1) * dx
        base = (idx >> (6 - up_above)) + (j << up_above)
        shift = ((idx << up_above) >> 1) & 0x1F
        max_base = (w + h - 1) << up_above
        bc = np.minimum(base, max_base)
        v = (A[oa + bc] * (32 - shift) + A[oa + bc + 1] * shift + 16) >> 5
        return np.where(base < max_base, v, A[oa + max_base])
    if p_angle < 180:
        dx = DR_DERIVATIVE[180 - p_angle]
        dy = DR_DERIVATIVE[p_angle - 90]
        idx = (j << 6) - (i + 1) * dx
        base = idx >> (6 - up_above)
        use_above = base >= -(1 << up_above)
        shift = ((idx << up_above) >> 1) & 0x1F
        bc = np.maximum(base, -(1 << up_above))
        va = (A[oa + bc] * (32 - shift) + A[oa + bc + 1] * shift + 16) >> 5
        idy = (i << 6) - (j + 1) * dy
        basey = idy >> (6 - up_left)
        shifty = ((idy << up_left) >> 1) & 0x1F
        by = np.clip(basey, -(1 << up_left), len(L) - ol - 2)
        vl = (L[ol + by] * (32 - shifty) + L[ol + by + 1] * shifty + 16) >> 5
        return np.where(use_above, va, vl)
    dy = DR_DERIVATIVE[270 - p_angle]
    idx = (j + 1) * dy
    base = (idx >> (6 - up_left)) + (i << up_left)
    shift = ((idx << up_left) >> 1) & 0x1F
    max_base = (w + h - 1) << up_left
    bc = np.minimum(base, max_base)
    v = (L[ol + bc] * (32 - shift) + L[ol + bc + 1] * shift + 16) >> 5
    return np.where(base < max_base, v, L[ol + max_base])


def _filter_intra(above, left, w, h, mode, maxv) -> np.ndarray:
    """Recursive intra prediction (7.11.2.3), one 4x2 cell at a time."""
    pred = np.zeros((h, w), np.int64)
    taps = _TAPS[mode]
    for i2 in range(h >> 1):
        r = i2 << 1
        for j4 in range(w >> 2):
            c = j4 << 2
            if i2 == 0:
                top = above[c:c + 5]  # AboveRow[c - 1 .. c + 3]
            elif j4 == 0:
                top = [left[r]] + pred[r - 1, c:c + 4].tolist()
            else:
                top = pred[r - 1, c - 1:c + 4].tolist()
            if j4 == 0:
                side = [left[r + 1], left[r + 2]]
            else:
                side = [int(pred[r, c - 1]), int(pred[r + 1, c - 1])]
            p = np.array(top + side, np.int64)
            v = taps @ p
            v = np.where(v < 0, -((-v + 8) >> 4), (v + 8) >> 4)
            pred[r:r + 2, c:c + 4] = np.clip(v, 0, maxv).reshape(2, 4)
    return pred


def cfl_predict(dc: np.ndarray, luma: np.ndarray, alpha: int, maxv: int) -> np.ndarray:
    """Chroma from luma (7.11.5): `luma` the [h, w] subsampled luma in
    1/8 units, `dc` the DC prediction."""
    h, w = luma.shape
    n = (h * w).bit_length() - 1
    avg = (int(luma.sum()) + (1 << (n - 1))) >> n
    d = alpha * (luma - avg)
    scaled = np.where(d < 0, -((-d + 32) >> 6), (d + 32) >> 6)
    return np.clip(dc + scaled, 0, maxv)
