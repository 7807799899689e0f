"""The inverse wavelet transforms of JPEG 2000 as OpenJPEG 2.5.3 runs them
(`dwt.c`), in NumPy, over the rows or columns of one resolution at a time.

A 1-D signal of length n starting at coordinate x0 holds its low-pass
samples at even coordinates: `cas` = x0 % 2 says whether the first sample is
low (0) or high (1).  The tile buffer keeps the sn low samples first and the
dn high ones after them; each transform interleaves and reconstructs.

  * 5/3 (reversible, `opj_idwt53_h` / `_v`): exact integers, symmetric
    extension at both ends, X(2n) = Y(2n) - floor((Y(2n-1) + Y(2n+1) + 2) / 4)
    then X(2n+1) = Y(2n+1) + floor((X(2n) + X(2n+2)) / 2); a signal of one
    sample is left as it is when low and halved (C division, toward 0) when
    high.
  * 9/7 (irreversible, `opj_v8dwt_decode`): float32, the low samples scaled
    by K = 1.230174105 and the high ones by 1.625732422 (OpenJPEG's
    "two_invK", which its step sizes compensate), then the four lifting
    steps on the low, high, low and high samples with c = -0.443506852,
    -0.882911075, 0.052980118 and 1.586134342, each X(k) += (X(k-1) + X(k+1)) * c
    rounded in float32 after every operation (the SSE code's separate
    multiply and add: with them fused, 31 of 188 random 9/7 files differ
    from cv2, `tools/probe_jpeg2000.py --fma`), with symmetric extension;
    a signal of one sample is left as it is, low or high.

Horizontal first over every row of the resolution, then vertical over every
column, as `opj_dwt_decode_tile` and `opj_dwt_decode_tile_97` do.
"""

from __future__ import annotations

import numpy as np

K = np.float32(1.230174105)
TWO_INV_K = np.float32(1.625732422)
# the lifting steps the decoder adds, in the order it runs them backwards
ALPHA = np.float32(1.586134342)
BETA = np.float32(0.052980118)
GAMMA = np.float32(-0.882911075)
DELTA = np.float32(-0.443506852)


def _interleave(a: np.ndarray, sn: int, cas: int) -> np.ndarray:
    """[rows, n] with the sn low samples first -> the signal in place order."""
    out = np.empty_like(a)
    out[:, cas::2] = a[:, :sn]
    out[:, 1 - cas::2] = a[:, sn:]
    return out


def _idwt53_rows(a: np.ndarray, sn: int, cas: int) -> np.ndarray:
    n = a.shape[1]
    if n == 1:
        return a if cas == 0 else np.sign(a) * (np.abs(a) // 2)
    y = _interleave(a, sn, cas)
    p = np.pad(y, ((0, 0), (1, 1)), mode="reflect")      # p[k + 1] = y[k]
    x = y.copy()
    ev = np.arange(cas, n, 2)                            # the low (even-coordinate) samples
    x[:, ev] = y[:, ev] - ((p[:, ev] + p[:, ev + 2] + 2) >> 2)
    q = np.pad(x, ((0, 0), (1, 1)), mode="reflect")
    od = np.arange(1 - cas, n, 2)
    x[:, od] = y[:, od] + ((q[:, od] + q[:, od + 2]) >> 1)
    return x


def _lift(x: np.ndarray, start: int, c: np.float32) -> None:
    """X(k) += (X(k-1) + X(k+1)) * c for k = start, start + 2, ..., in
    float32, the neighbours mirrored at both ends."""
    n = x.shape[1]
    k = np.arange(start, n, 2)
    if k.size == 0:
        return
    left = np.abs(k - 1)
    right = np.where(k + 1 < n, k + 1, 2 * n - 2 - (k + 1))
    x[:, k] = x[:, k] + (x[:, left] + x[:, right]) * c


def _idwt97_rows(a: np.ndarray, sn: int, cas: int) -> np.ndarray:
    n = a.shape[1]
    if n == 1:
        return a
    x = _interleave(a, sn, cas)
    lo, hi = cas, 1 - cas
    x[:, lo::2] *= K
    x[:, hi::2] *= TWO_INV_K
    _lift(x, lo, DELTA)
    _lift(x, hi, GAMMA)
    _lift(x, lo, BETA)
    _lift(x, hi, ALPHA)
    return x


def idwt(tile: np.ndarray, sizes: list, reversible: bool) -> np.ndarray:
    """Reconstruct a tile-component in place: `tile` holds its subbands
    (int64 for 5/3, float32 for 9/7) in OpenJPEG's layout; `sizes` lists
    (x0, y0, x1, y1) of resolutions 0..NL."""
    rows_fn = _idwt53_rows if reversible else _idwt97_rows
    for r in range(1, len(sizes)):
        px0, py0, px1, py1 = sizes[r - 1]
        x0, y0, x1, y1 = sizes[r]
        rw, rh = x1 - x0, y1 - y0
        if rw == 0 or rh == 0:
            continue
        region = tile[:rh, :rw]
        region[:] = rows_fn(region, px1 - px0, x0 % 2)
        region[:] = rows_fn(np.ascontiguousarray(region.T), py1 - py0, y0 % 2).T
    return tile
