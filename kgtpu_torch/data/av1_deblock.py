"""AV1's deblocking filter (specification section 7.14) over a whole
reconstructed intra frame, as libaom 3.14's decoder applies it.

Per plane, the vertical edges of the whole plane are filtered first, then
the horizontal ones (7.14.1).  An edge is a 4-sample side of a 4x4 unit on
a transform block's edge (every block of an intra frame is intra, so every
transform edge is filtered, 7.14.2), inside the frame and not on its left
or top border.  Its filter size is the smaller transform dimension across
it, capped at 16 for luma and 8 for chroma (7.14.3); its level comes from
the frame's level, the block's loop filter delta, its segment's feature
and the INTRA_FRAME reference delta, the block before the edge's level
standing in for a level of 0 (7.14.4-5); the limits from the level and the
sharpness.  Each sample position then takes the 4-, 6-, 8- or 14-tap
filter that its masks allow (7.14.6), thresholds shifted by BitDepth - 8.

Within one pass no edge reads a sample another edge writes (an edge reads
at most half its filter size on each side, and the filter size is at most
the transform size on each side), so each pass gathers every edge's
samples at once, computes the filters in int64 NumPy arrays and writes
them back.  The horizontal pass runs on the transposed plane.

`deblock(frame)` filters `frame.planes` (`av1_decode.Frame`) in place.
"""

from __future__ import annotations

import numpy as np

from kgtpu_torch.data.av1_coeffs import TX_SIZES

MAX_LOOP_FILTER = 63
TXW = np.array([w for w, _ in TX_SIZES], np.int64)
TXH = np.array([h for _, h in TX_SIZES], np.int64)


def _weights(n: int, n2: int) -> np.ndarray:
    """The wide filter's taps (7.14.6.4) as a [2n, 2n + 2] matrix from the
    samples p_n .. p_0, q_0 .. q_n to the outputs p_(n-1) .. q_(n-1)."""
    w = np.zeros((2 * n, 2 * n + 2), np.int64)
    for i in range(-n, n):
        for j in range(-n, n + 1):
            k = min(max(i + j, -(n + 1)), n)
            w[i + n, k + n + 1] += 2 if abs(j) <= n2 else 1
    return w


WIDE = {(3, True): (3, _weights(3, 0)), (3, False): (2, _weights(2, 1)),
        (4, True): (6, _weights(6, 1))}


def levels(fr, plane: int, pas: int) -> np.ndarray:
    """The filter level of every 4x4 of luma for `plane`'s `pas` (0:
    vertical edges) (7.14.4's deltaLF, 7.14.5)."""
    fh = fr.fh
    i = pas if plane == 0 else plane + 1
    if fh.delta_lf_present:
        d = fr.delta_lfs[..., i if fh.delta_lf_multi else 0].astype(np.int64)
        lvl = np.clip(d + fh.lf_level[i], 0, MAX_LOOP_FILTER)
    else:
        lvl = np.full(fr.seg_ids.shape, fh.lf_level[i], np.int64)
    if fh.seg_enabled:
        on = np.array([fh.feature_enabled[s][1 + i] for s in range(8)], bool)
        data = np.array([fh.feature_data[s][1 + i] for s in range(8)], np.int64)
        seg = fr.seg_ids.astype(np.int64)
        lvl = np.where(on[seg], np.clip(lvl + data[seg], 0, MAX_LOOP_FILTER), lvl)
    if fh.lf_delta_enabled:
        lvl = np.clip(lvl + fh.lf_ref_deltas[0] * (1 << (lvl >> 5)), 0, MAX_LOOP_FILTER)
    return lvl


def limits(lvl: np.ndarray, sharpness: int):
    """(limit, blimit, thresh) of each level (7.14.4)."""
    shift = 2 if sharpness > 4 else (1 if sharpness > 0 else 0)
    if sharpness > 0:
        limit = np.clip(lvl >> shift, 1, 9 - sharpness)
    else:
        limit = np.maximum(1, lvl >> shift)
    return limit, 2 * (lvl + 2) + limit, lvl >> 4


def _narrow(p1, p0, q0, q1, hev, bd: int):
    """7.14.6.3: the new p1, p0, q0, q1."""
    half = 0x80 << (bd - 8)
    lo, hi = -(1 << (bd - 1)), (1 << (bd - 1)) - 1
    ps1, ps0, qs0, qs1 = p1 - half, p0 - half, q0 - half, q1 - half
    f = np.where(hev, np.clip(ps1 - qs1, lo, hi), 0)
    f = np.clip(f + 3 * (qs0 - ps0), lo, hi)
    f1 = np.clip(f + 4, lo, hi) >> 3
    f2 = np.clip(f + 3, lo, hi) >> 3
    oq0 = np.clip(qs0 - f1, lo, hi) + half
    op0 = np.clip(ps0 + f2, lo, hi) + half
    f = (f1 + 1) >> 1
    oq1 = np.where(hev, q1, np.clip(qs1 - f, lo, hi) + half)
    op1 = np.where(hev, p1, np.clip(ps1 + f, lo, hi) + half)
    return op1, op0, oq0, oq1


def filter_samples(s: np.ndarray, size: int, luma: bool, limit, blimit, thresh,
                   bd: int) -> np.ndarray:
    """7.14.6 at M sample positions: `s` [M, 14] the samples p6 .. p0, q0 ..
    q6 across each edge, `size` the edge's filter size (4, 8 or 16), the
    level's limits [M]; the filtered [M, 14]."""
    s = s.astype(np.int64)
    out = s.copy()
    p = [s[:, 6 - k] for k in range(7)]
    q = [s[:, 7 + k] for k in range(7)]
    shift = bd - 8
    limit, blimit, thresh = (np.asarray(v, np.int64) << shift for v in (limit, blimit, thresh))
    length = 4 if size == 4 else (6 if not luma else size)
    ad = lambda a, b: np.abs(a - b)  # noqa: E731
    hev = (ad(p[1], p[0]) > thresh) | (ad(q[1], q[0]) > thresh)
    bad = (ad(p[1], p[0]) > limit) | (ad(q[1], q[0]) > limit) | \
        (ad(p[0], q[0]) * 2 + (ad(p[1], q[1]) >> 1) > blimit)
    if length >= 6:
        bad |= (ad(p[2], p[1]) > limit) | (ad(q[2], q[1]) > limit)
    if length >= 8:
        bad |= (ad(p[3], p[2]) > limit) | (ad(q[3], q[2]) > limit)
    on = ~bad
    one = 1 << shift
    flat = np.zeros_like(on)
    flat2 = np.zeros_like(on)
    if size >= 8:
        flat = (ad(p[1], p[0]) <= one) & (ad(q[1], q[0]) <= one) & \
            (ad(p[2], p[0]) <= one) & (ad(q[2], q[0]) <= one)
        if length >= 8:
            flat &= (ad(p[3], p[0]) <= one) & (ad(q[3], q[0]) <= one)
    if size >= 16:
        flat2 = np.ones_like(on)
        for k in (4, 5, 6):
            flat2 &= (ad(p[k], p[0]) <= one) & (ad(q[k], q[0]) <= one)
    narrow = on & ~flat
    if narrow.any():
        op1, op0, oq0, oq1 = _narrow(p[1][narrow], p[0][narrow], q[0][narrow],
                                     q[1][narrow], hev[narrow], bd)
        out[narrow, 5], out[narrow, 6], out[narrow, 7], out[narrow, 8] = op1, op0, oq0, oq1
    for log2, sel in ((3, on & flat & ~flat2), (4, on & flat & flat2)):
        if not sel.any():
            continue
        n, w = WIDE[(log2, luma)]
        taps = s[sel][:, 6 - n:8 + n]
        out[np.ix_(sel.nonzero()[0], np.arange(7 - n, 7 + n))] = \
            (taps @ w.T + (1 << (log2 - 1))) >> log2
    return out


def _pass(a: np.ndarray, tx_len: np.ndarray, lvl: np.ndarray, luma: bool, sharpness: int,
          bd: int) -> None:
    """The vertical edges of `a` (a plane, or its transpose for the
    horizontal pass): `tx_len` [R, C] the transform dimension across the
    edge and `lvl` [R, C] the level of each 4x4 unit in the frame."""
    cur, prev = tx_len[:, 1:], tx_len[:, :-1]
    cols = np.arange(1, tx_len.shape[1])
    edge = (cols * 4) % cur == 0
    size = np.minimum(np.minimum(cur, prev), 16 if luma else 8)
    lv = np.where(lvl[:, 1:] == 0, lvl[:, :-1], lvl[:, 1:])
    ry, cx = np.nonzero(edge & (lv > 0))
    if not len(ry):
        return
    size, lv = size[ry, cx], lv[ry, cx]
    cx = cx + 1
    limit, blimit, thresh = limits(lv, sharpness)
    ys = (ry[:, None] * 4 + np.arange(4)).reshape(-1)
    xs = np.repeat(cx * 4, 4)
    size, limit, blimit, thresh = (np.repeat(v, 4) for v in (size, limit, blimit, thresh))
    cols = np.clip(xs[:, None] + np.arange(-7, 7), 0, a.shape[1] - 1)
    samples = a[ys[:, None], cols]
    new = samples.copy()
    for sz in (4, 8, 16):
        sel = size == sz
        if sel.any():
            new[sel] = filter_samples(samples[sel], sz, luma, limit[sel], blimit[sel],
                                      thresh[sel], bd)
    changed = new != samples
    a[ys[:, None].repeat(14, 1)[changed], cols[changed]] = new[changed]


def deblock(fr) -> None:
    """7.14 over `fr.planes` in place (the frame needs deblocking:
    loop_filter_level[0] or [1] is not 0)."""
    fh = fr.fh
    for plane in range(len(fr.planes)):
        if plane and not fh.lf_level[1 + plane]:
            continue
        sx = fr.ssx if plane else 0
        sy = fr.ssy if plane else 0
        # the 4x4 units whose luma position lies inside the frame
        nr = -(-fh.height // (4 << sy))
        nc = -(-fh.width // (4 << sx))
        tx = fr.lf_tx[plane][:nr, :nc].astype(np.int64)
        mi_r = (np.arange(nr) << sy) | sy
        mi_c = (np.arange(nc) << sx) | sx
        a = fr.planes[plane]
        for pas in (0, 1):
            lvl = levels(fr, plane, pas)[mi_r][:, mi_c]
            if pas == 0:
                _pass(a, TXW[tx], lvl, plane == 0, fh.lf_sharpness, fr.bit_depth)
            else:
                _pass(a.T, TXH[tx].T, lvl.T, plane == 0, fh.lf_sharpness, fr.bit_depth)
