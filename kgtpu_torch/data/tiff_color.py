"""libtiff's photometric conversions for its RGBA reader, in NumPy: YCbCr
and CIELab to 8-bit RGB, as `tif_color.c` (TIFFYCbCrToRGBInit /
TIFFYCbCrtoRGB, TIFFCIELabToRGBInit / TIFFCIELab16ToXYZ / TIFFXYZToRGB)
and `tif_getimage.c` (initYCbCrConversion, initCIELabConversion and the
sRGB display) compute them, each float step in float32 and in C's order,
so that every pixel equals cv2 5.0's read through libtiff 4.7.
"""

from __future__ import annotations

import numpy as np

F = np.float32
SHIFT = 16
ONE_HALF = 1 << (SHIFT - 1)


def _fix(x: np.float32) -> int:
    """FIX(x): (int32_t)(x * 65536 + 0.5), the product in float and the sum
    in double."""
    return int(float(F(x) * F(65536)) + 0.5)


def _code2v(c: np.ndarray, rb: np.float32, rw: np.float32, cr: float) -> np.ndarray:
    """Code2V: ((c - (int32_t)RB) * (float)CR) / (float)(RW - RB or 1)."""
    span = F(rw - rb)
    span = span if span != 0 else F(1)
    return (c - np.int32(int(rb))).astype(F) * F(cr) / span


def _clampw(f: np.ndarray, lo: float, hi: float) -> np.ndarray:
    return np.where(f < F(lo), F(lo), np.where(f > F(hi), F(hi), f))


def ycbcr_tables(luma=None, ref=None) -> tuple[np.ndarray, ...]:
    """(Y, Cr_r, Cb_b, Cr_g, Cb_g) tables of TIFFYCbCrToRGBInit, indexed by
    the stored sample.  Defaults: YCbCrCoefficients 0.299, 0.587, 0.114 and
    ReferenceBlackWhite 0, 255, 128, 255, 128, 255."""
    lr, lg, lb = (F(v) for v in (luma or (0.299, 0.587, 0.114)))
    ref = [F(v) for v in (ref or (0, 255, 128, 255, 128, 255))]
    f1 = F(2) - F(2) * lr
    d1 = _fix(min(max(f1, F(0)), F(2)))
    f2 = lr * f1 / lg
    d2 = -_fix(min(max(f2, F(0)), F(2)))
    f3 = F(2) - F(2) * lb
    d3 = _fix(min(max(f3, F(0)), F(2)))
    f4 = lb * f3 / lg
    d4 = -_fix(min(max(f4, F(0)), F(2)))
    x = np.arange(-128, 128, dtype=np.int64)
    cr = _clampw(_code2v(x, ref[4] - F(128), ref[5] - F(128), 127), -128.0 * 32,
                 128.0 * 32).astype(np.int64)
    cb = _clampw(_code2v(x, ref[2] - F(128), ref[3] - F(128), 127), -128.0 * 32,
                 128.0 * 32).astype(np.int64)
    y = _clampw(_code2v(x + 128, ref[0], ref[1], 255), -128.0 * 32, 128.0 * 32).astype(np.int64)
    i32 = lambda v: ((v + 2 ** 31) % 2 ** 32) - 2 ** 31  # noqa: E731  (int32 wrap)
    return (y, (d1 * cr + ONE_HALF) >> SHIFT, (d3 * cb + ONE_HALF) >> SHIFT, i32(d2 * cr),
            i32(d4 * cb + ONE_HALF))


def ycbcr_to_rgb(px: np.ndarray, luma=None, ref=None) -> np.ndarray:
    """[..., 3] (Y, Cb, Cr) uint8 -> [..., 3] RGB uint8 (TIFFYCbCrtoRGB)."""
    y_t, crr, cbb, crg, cbg = ycbcr_tables(luma, ref)
    y, cb, cr = (px[..., k].astype(np.int64) for k in range(3))
    yv = y_t[y]
    r = yv + crr[cr]
    g = yv + ((cbg[cb] + crg[cr]) >> SHIFT)
    b = yv + cbb[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


# tif_getimage.c's display_sRGB
_MATRIX = np.array([[3.2410, -1.5374, -0.4986], [-0.9692, 1.8760, 0.0416],
                    [0.0556, -0.2040, 1.0570]], F)
_Y0, _YC, _VRW, _GAMMA, _RANGE = F(1.0), F(100.0), 255, 2.4, 1500
_D50 = (F(96.4250), F(100.0), F(82.4680))


def _lab_tables() -> tuple[np.float32, np.ndarray]:
    """(step, Y -> value table) of TIFFCIELabToRGBInit for one gun (the
    three guns of display_sRGB are equal)."""
    step = F(F(_YC - _Y0) / F(_RANGE))
    i = np.arange(_RANGE + 1, dtype=np.float64)
    table = F(_VRW) * np.power(i / _RANGE, 1.0 / float(F(_GAMMA))).astype(F)
    return step, table.astype(F)


def lab_to_rgb(px: np.ndarray, bits: int, white=None) -> np.ndarray:
    """[..., 3] CIELab samples (L unsigned, a and b signed; 8 or 16 bits)
    -> [..., 3] RGB uint8, as putcontig8bitCIELab8 / 16 compute them."""
    if white is None:                       # D50, libtiff's default WhitePoint
        s = _D50[0] + _D50[1] + _D50[2]
        white = (_D50[0] / s, _D50[1] / s)
    wx, wy = F(white[0]), F(white[1])
    y0 = F(100.0)
    x0 = wx / wy * y0
    z0 = (F(1.0) - wx - wy) / wy * y0
    if bits == 8:
        l16 = px[..., 0].astype(np.uint32) * 257
        a16 = px[..., 1].astype(np.int8).astype(np.int32) * 256
        b16 = px[..., 2].astype(np.int8).astype(np.int32) * 256
    else:
        l16 = px[..., 0].astype(np.uint32)
        a16 = px[..., 1].astype(np.int16).astype(np.int32)
        b16 = px[..., 2].astype(np.int16).astype(np.int32)
    L = l16.astype(F) * F(100.0) / F(65535.0)
    low = L < F(8.856)
    y_low = (L * y0) / F(903.292)
    cby_low = F(7.787) * (y_low / y0) + F(16.0) / F(116.0)
    cby_hi = (L + F(16.0)) / F(116.0)
    y_hi = y0 * cby_hi * cby_hi * cby_hi
    Y = np.where(low, y_low, y_hi)
    cby = np.where(low, cby_low, cby_hi)

    def cube(t, ref):
        return np.where(t < F(0.2069), ref * (t - F(0.13793)) / F(7.787), ref * t * t * t)
    X = cube(a16.astype(F) / F(256.0) / F(500.0) + cby, x0)
    Z = cube(cby - b16.astype(F) / F(256.0) / F(200.0), z0)
    step, table = _lab_tables()
    out = []
    for row in _MATRIX:
        v = row[0] * X + row[1] * Y + row[2] * Z
        v = np.minimum(np.maximum(v, _Y0), _YC)
        i = np.minimum(((v - _Y0) / step).astype(np.int32), _RANGE)
        r = table[i].astype(np.float64)
        r = np.where(r > 0, r + 0.5, r - 0.5).astype(np.int64).astype(np.uint32)
        out.append(np.minimum(r, _VRW))
    return np.stack(out, -1).astype(np.uint8)
