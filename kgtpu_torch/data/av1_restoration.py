"""AV1's loop restoration (specification section 7.17), as libaom 3.14's
decoder applies it to a whole frame after CDEF and superres.

Each plane that restores is cut into restoration units (LoopRestorationSize
square, the last row and column of units taking the rest of the plane, up
to 1.5 units; `unit_count`), each unit filtered by its own type: none, the
Wiener filter (7.17.4) or the self-guided filter (7.17.3).  Filtering runs
in stripes of 64 luma rows, offset 8 rows up (the first stripe is 56 rows;
chroma's scale with its subsampling).  Inside its stripe a filter reads the
upscaled CDEF frame; rows above and below the stripe come from the
upscaled deblocked frame, at most 2 rows out (get_source_sample); rows
outside the plane and columns outside it are clamped to its edges.  The
filters read those copies and never their own output.  The unit of a
stripe's columns is fixed per column, and a stripe lies within one unit row
(units are whole stripes, offset as the stripes are).

  Wiener       7 taps each way (the centre 128 minus twice the others'
               sum), the horizontal pass rounded by InterRound0 and clamped
               to an offset range, the vertical by InterRound1 (3 and 11;
               5 and 9 at 12 bits), clipped to the bit depth
  self-guided  the box sums at radius 2 (every other row, libaom's "fast"
               pass) and 1 of each sample's neighbourhood, the set's
               strength s, libaom's av1_x_by_xplus1 and av1_one_by_x
               tables, the 3x3 weighted sums of the coefficients, then the
               projection of the two filtered planes with the unit's xqd

Each stripe is filtered across the whole plane width at once in int64 NumPy
arrays: the Wiener taps per column, the self-guided filter once per set the
stripe's units use; the C's 32-bit unsigned products are wrapped as in C.

`restore(fr, cdef_planes, deblocked_planes)` returns the restored planes.
"""

from __future__ import annotations

import numpy as np

from kgtpu_torch.data.av1_obu import RESTORE_NONE, RESTORE_SGRPROJ, RESTORE_WIENER
from kgtpu_torch.data.av1_tables import ONE_BY_X, SGR_PARAMS, X_BY_XPLUS1

STRIPE = 64
STRIPE_OFFSET = 8
U32 = 0xFFFFFFFF
X_BY_XPLUS1_ = np.array(X_BY_XPLUS1, np.int64)


def unit_count(size: int, length: int) -> int:
    """count_units_in_frame (5.11.57)."""
    return max((length + (size >> 1)) // size, 1)


def wiener_taps(coeffs: np.ndarray) -> np.ndarray:
    """[..., 3] coded taps (outermost first) -> [..., 7] filter taps."""
    c = np.asarray(coeffs, np.int64)
    centre = 128 - 2 * c.sum(-1, keepdims=True)
    return np.concatenate([c, centre, c[..., ::-1]], -1)


def wiener(src: np.ndarray, hf: np.ndarray, vf: np.ndarray, bit_depth: int) -> np.ndarray:
    """7.17.4 on `src` [h + 6, w + 6] (the samples around an h x w area,
    3 each side): hf, vf the [w, 7] (or [7]) horizontal and vertical taps
    of each column; the [h, w] filtered samples."""
    r0, r1 = (5, 9) if bit_depth == 12 else (3, 11)
    h, w = src.shape[0] - 6, src.shape[1] - 6
    offset = 1 << (bit_depth + 7 - r0 - 1)
    limit = (1 << (bit_depth + 1 + 7 - r0)) - 1
    hf = np.broadcast_to(hf, (w, 7))
    vf = np.broadcast_to(vf, (w, 7))
    s = sum(hf[:, t] * src[:, t:t + w] for t in range(7))
    inter = np.clip((s + (1 << (r0 - 1))) >> r0, -offset, limit - offset)
    s = sum(vf[:, t] * inter[t:t + h] for t in range(7))
    return np.clip((s + (1 << (r1 - 1))) >> r1, 0, (1 << bit_depth) - 1)


def _box(src: np.ndarray, r: int) -> tuple[np.ndarray, np.ndarray]:
    """The sums of the samples and of their squares over the (2r + 1)^2
    box around every sample of src[1:-1, 1:-1] with r <= 2 (src [h + 6, w +
    6]): two [h + 2, w + 2] arrays."""
    out = []
    for v in (src, src * src):
        c = np.zeros((v.shape[0] + 1, v.shape[1] + 1), np.int64)
        c[1:, 1:] = v.cumsum(0).cumsum(1)
        h, w = v.shape[0] - 4, v.shape[1] - 4
        lo, hi = 2 - r, 3 + r
        out.append(c[hi:hi + h, hi:hi + w] - c[lo:lo + h, hi:hi + w] -
                   c[hi:hi + h, lo:lo + w] + c[lo:lo + h, lo:lo + w])
    return out[0], out[1]


def box_filter(src: np.ndarray, r: int, s: int, bit_depth: int) -> np.ndarray:
    """7.17.3's box filter process at radius r (2: pass 0, 1: pass 1) with
    strength s on `src` [h + 6, w + 6] (the stripe's rows 3 above and below
    an h x w area whose first row is even): the [h, w] filtered plane
    (flt0 / flt1), at 4 extra bits (libaom's calc_ab and the 3x3 sums)."""
    h, w = src.shape[0] - 6, src.shape[1] - 6
    n = (2 * r + 1) ** 2
    total, squares = _box(src, r)  # at rows and columns -1 .. h, -1 .. w
    sh = bit_depth - 8
    a = (squares + ((1 << (2 * sh)) >> 1)) >> (2 * sh)
    b = (total + ((1 << sh) >> 1)) >> sh
    p = np.where(a * n < b * b, 0, a * n - b * b)
    z = (((p * s) & U32) + (1 << 19)) >> 20
    A = X_BY_XPLUS1_[np.minimum(z, 255)]
    B = ((((256 - A) * total) & U32) * ONE_BY_X[n - 1] & U32) + (1 << 11) >> 12
    u = src[3:-3, 3:-3]
    if r == 1:
        def nine(m):
            cross = m[1:-1, 1:-1] + m[1:-1, :-2] + m[1:-1, 2:] + m[:-2, 1:-1] + m[2:, 1:-1]
            diag = m[:-2, :-2] + m[:-2, 2:] + m[2:, :-2] + m[2:, 2:]
            return cross * 4 + diag * 3
        return (nine(A) * u + nine(B) + (1 << 8)) >> 9
    out = np.empty((h, w), np.int64)
    # even rows: the coefficient rows above and below (6 in the column, 5
    # beside it); odd rows: their own row
    up, dn = slice(0, h, 2), slice(2, h + 2, 2)

    def even(m):
        return (m[up, 1:-1] + m[dn, 1:-1]) * 6 + \
            (m[up, :-2] + m[up, 2:] + m[dn, :-2] + m[dn, 2:]) * 5
    out[0::2] = (even(A) * u[0::2] + even(B) + (1 << 8)) >> 9
    mid = slice(2, h + 1, 2)

    def odd(m):
        return m[mid, 1:-1] * 6 + (m[mid, :-2] + m[mid, 2:]) * 5
    out[1::2] = (odd(A) * u[1::2] + odd(B) + (1 << 7)) >> 8
    return out


def self_guided(src: np.ndarray, sgr_set: int, xqd, bit_depth: int) -> np.ndarray:
    """7.17.3 on `src` [h + 6, w + 6] with one set and projection (xqd
    [2] or [w, 2] per column): the [h, w] restored samples
    (av1_apply_selfguided_restoration_c)."""
    r0, r1, s0, s1 = SGR_PARAMS[sgr_set]
    xqd = np.asarray(xqd, np.int64)
    xd0, xd1 = xqd[..., 0], xqd[..., 1]
    if r0 == 0:
        xq0, xq1 = 0, 128 - xd1
    elif r1 == 0:
        xq0, xq1 = xd0, 0
    else:
        xq0, xq1 = xd0, 128 - xd0 - xd1
    u = src[3:-3, 3:-3] << 4
    v = u << 7
    if r0:
        v = v + xq0 * (box_filter(src, r0, s0, bit_depth) - u)
    if r1:
        v = v + xq1 * (box_filter(src, r1, s1, bit_depth) - u)
    w = (((v + (1 << 10)) >> 11) + 32768 & 0xFFFF) - 32768  # int16_t
    return np.clip(w, 0, (1 << bit_depth) - 1)


def stripe_rows(y0: int, y1: int, start: int, end: int, plane_h: int):
    """get_source_sample's rows for filtered rows y0 .. y1 of the stripe
    StripeStartY .. StripeEndY = start .. end: (rows [y1 - y0 + 7], whether
    each comes from the deblocked frame)."""
    y = np.clip(np.arange(y0 - 3, y1 + 4), 0, plane_h - 1)
    above, below = y < start, y > end
    y = np.where(above, np.maximum(y, start - 2), np.where(below, np.minimum(y, end + 2), y))
    return y, above | below


def restore_plane(fr, p: int, cdef: np.ndarray, deblocked: np.ndarray) -> np.ndarray:
    """Loop restoration of plane `p` ([plane_h, plane_w] upscaled CDEF and
    deblocked samples): the restored [plane_h, plane_w] samples."""
    fh = fr.fh
    sy = fr.ssy if p else 0
    bd = fr.bit_depth
    plane_h, plane_w = cdef.shape
    size = fh.lr_unit_size[p]
    types, wiener_c = fr.lr_types[p], fr.lr_wiener[p]
    sets, xqds = fr.lr_sgr_set[p], fr.lr_sgr_xqd[p]
    unit_rows, unit_cols = types.shape
    col_unit = np.minimum(np.arange(plane_w) // size, unit_cols - 1)
    cols = np.clip(np.arange(-3, plane_w + 3), 0, plane_w - 1)
    cd, db = cdef.astype(np.int64), deblocked.astype(np.int64)
    out = cd.copy()
    off, height = STRIPE_OFFSET >> sy, STRIPE >> sy
    for start in range(-off, plane_h, height):
        end = start + height - 1
        y0, y1 = max(start, 0), min(end, plane_h - 1)
        ur = min((y0 + off) // size, unit_rows - 1)
        kind = types[ur][col_unit]
        if not (kind != RESTORE_NONE).any():
            continue
        ys, from_db = stripe_rows(y0, y1, start, end, plane_h)
        src = np.where(from_db[:, None], db[ys], cd[ys])[:, cols]
        res = out[y0:y1 + 1]
        on = kind == RESTORE_WIENER
        if on.any():
            taps = wiener_taps(wiener_c[ur][col_unit])  # [w, 2, 7]
            res[:, on] = wiener(src, taps[:, 1], taps[:, 0], bd)[:, on]
        on, col_sets = kind == RESTORE_SGRPROJ, sets[ur][col_unit]
        for st in np.unique(col_sets[on]):
            sel = on & (col_sets == st)
            res[:, sel] = self_guided(src, int(st), xqds[ur][col_unit], bd)[:, sel]
    return out


def restore(fr, cdef_planes: list, deblocked_planes: list) -> list:
    """7.17 over the upscaled CDEF and deblocked planes (each at least
    Round2(FrameHeight, ssy) x Round2(UpscaledWidth, ssx)): the planes after
    loop restoration, cut to that size (those that do not restore are the
    CDEF planes)."""
    fh = fr.fh
    out = []
    for p, (cd, db) in enumerate(zip(cdef_planes, deblocked_planes)):
        sx = fr.ssx if p else 0
        sy = fr.ssy if p else 0
        h, w = (fh.height + sy) >> sy, (fh.upscaled_width + sx) >> sx
        restores = fh.lr_type[p] != RESTORE_NONE
        out.append(restore_plane(fr, p, cd[:h, :w], db[:h, :w]) if restores else cd[:h, :w])
    return out
