"""YUV -> cv2 Mat for AVIF, as cv2 5.0's `grfmt_avif.cpp` calls libavif
1.4.2's `avifImageYUVToRGB` (libavif built with libyuv).

cv2's reader (AvifDecoder::readData / CopyToMat):
  * channels = 1 for YUV 4:0:0, else 3, plus 1 with an alpha item;
  * a 1-channel image copies the Y plane (no range conversion), scaled to
    8 bits by `convertTo(CV_8U, 1 / 2^(depth - 8))` (rounding, saturating)
    when the Mat is 8-bit; "color" then adds `cvtColor(GRAY2BGR)`;
  * 3 / 4 channels convert to BGR / BGRA at the Mat's depth (8 bits in
    "color" and "gray", the image's own depth, 10 or 12, in "unchanged"),
    then "color" drops alpha (BGRA2BGR) and "gray" runs BGR(A)2GRAY;
  * grey with alpha (two channels) fails (imread returns None).

libavif's conversion:
  * 8-bit YUV to 8-bit RGB with a matrix libyuv has (BT.601 / unspecified,
    BT.709, BT.2020 NCL; full or limited range): libyuv's fixed point
    (`YuvPixel`: y * 0x0101 * yg >> 16, + yb, + (u - 128) * ub ..., >> 6,
    clamped), its constants read out of the library (`LIBYUV_CONSTANTS`);
    4:2:0 and 4:2:2 chroma upsampled first as libyuv's *MatrixFilter
    functions do (bilinear 9/3/3/1 rows of ScaleRowUp2_Bilinear_Any; the
    first and last columns, odd widths too, and the first and last rows
    take only the nearest chroma column or row);
  * identity (GBR, cv2's lossless files): a copy at equal depths;
  * anything else (another depth, other matrices) libavif's float path:
    unorm tables, 9/16 3/16 3/16 1/16 bilinear chroma, the kr / kb
    formulas, `(uint)(0.5f + v * max)`, all in float32.
  * alpha is copied (rescaled with the same float rounding between
    depths; limited-range alpha is first widened as libavif widens it).
"""

from __future__ import annotations

import numpy as np

from kgtpu_torch.data.av1_tables import AVIF_KR_KB, AVIF_KR_KB_DERIVED, LIBYUV_CONSTANTS
from kgtpu_torch.data.imread import UnreadableImage
from kgtpu_torch.data.pnm import cvt_gray

F32 = np.float32
CHROMA_DERIVED_NCL = 12


def kr_kb(cp: int, mc: int) -> tuple:
    """libavif's avifCalcYUVCoefficients: its table by matrix coefficients,
    or for chroma-derived NCL kr / kb derived from the colour primaries."""
    if mc == CHROMA_DERIVED_NCL:
        return AVIF_KR_KB_DERIVED.get(cp, AVIF_KR_KB_DERIVED[2])
    return AVIF_KR_KB.get(mc, AVIF_KR_KB[2])


def _libyuv_constants(cp: int, mc: int, full: bool):
    """The libyuv matrix libavif picks (chroma-derived NCL by its
    primaries), or None for its own float path."""
    if mc == CHROMA_DERIVED_NCL:
        mc = {1: 1, 2: 1, 5: 6, 6: 6, 9: 9}.get(cp, -1)
    if mc in (2, 5, 6):
        return LIBYUV_CONSTANTS["JPEG" if full else "I601"]
    if mc == 1:
        return LIBYUV_CONSTANTS["F709" if full else "H709"]
    if mc == 9:
        return LIBYUV_CONSTANTS["V2020" if full else "2020"]
    return None


def _up_linear(s: np.ndarray, width: int) -> np.ndarray:
    """libyuv's ScaleRowUp2_Linear_Any along the last axis."""
    out = np.empty(s.shape[:-1] + (width,), np.int32)
    out[..., 0] = s[..., 0]
    n = (width - 1) // 2
    a, b = s[..., :n], s[..., 1:n + 1]
    out[..., 1:2 * n:2] = (3 * a + b + 2) >> 2
    out[..., 2:2 * n + 1:2] = (a + 3 * b + 2) >> 2
    out[..., width - 1] = s[..., (width - 1) // 2]
    return out


def _up_bilinear_pair(s: np.ndarray, t: np.ndarray, width: int):
    """libyuv's ScaleRowUp2_Bilinear_Any: the two output rows between
    chroma rows s (nearer the first) and t."""
    d = np.empty(s.shape[:-1] + (width,), np.int32)
    e = np.empty_like(d)
    d[..., 0] = (3 * s[..., 0] + t[..., 0] + 2) >> 2
    e[..., 0] = (s[..., 0] + 3 * t[..., 0] + 2) >> 2
    n = (width - 1) // 2
    s0, s1, t0, t1 = s[..., :n], s[..., 1:n + 1], t[..., :n], t[..., 1:n + 1]
    d[..., 1:2 * n:2] = (s0 * 9 + s1 * 3 + t0 * 3 + t1 + 8) >> 4
    d[..., 2:2 * n + 1:2] = (s0 * 3 + s1 * 9 + t0 + t1 * 3 + 8) >> 4
    e[..., 1:2 * n:2] = (s0 * 3 + s1 + t0 * 9 + t1 * 3 + 8) >> 4
    e[..., 2:2 * n + 1:2] = (s0 + s1 * 3 + t0 * 3 + t1 * 9 + 8) >> 4
    last = (width - 1) // 2
    d[..., width - 1] = (3 * s[..., last] + t[..., last] + 2) >> 2
    e[..., width - 1] = (s[..., last] + 3 * t[..., last] + 2) >> 2
    return d, e


def _libyuv_upsample(c: np.ndarray, w: int, h: int, ssx: int, ssy: int) -> np.ndarray:
    c = c.astype(np.int32)
    if not ssx:
        return c
    if not ssy:  # 4:2:2: each row linear
        return _up_linear(c, w)
    out = np.empty((h, w), np.int32)
    out[0] = _up_linear(c[0], w)
    y = 1
    k = 0
    while y < h - 1:
        d, e = _up_bilinear_pair(c[k], c[k + 1], w)
        out[y], out[y + 1] = d, e
        y += 2
        k += 1
    if h % 2 == 0:
        out[h - 1] = _up_linear(c[(h - 1) // 2], w)
    return out


def _libyuv_rgb(y, u, v, k, depth: int = 8) -> np.ndarray:
    """libyuv's YuvPixel (8 bits) or YuvPixel10 (10 bits: y widened to 16
    bits, chroma >> 2 and clamped to 255)."""
    ub, ug, vg, vr, yg, yb = k
    y = y.astype(np.int64)
    if depth == 8:
        y32 = y * 0x0101
        ui = u.astype(np.int64) - 128
        vi = v.astype(np.int64) - 128
    else:
        y32 = (y << (16 - depth)) | (y >> (2 * depth - 16))
        ui = np.minimum(u.astype(np.int64) >> (depth - 8), 255) - 128
        vi = np.minimum(v.astype(np.int64) >> (depth - 8), 255) - 128
    y1 = ((y32 * yg) >> 16) + yb
    b = (y1 + ui * ub) >> 6
    g = (y1 - (ui * ug + vi * vg)) >> 6
    r = (y1 + vi * vr) >> 6
    return np.clip(np.stack([b, g, r], -1), 0, 255).astype(np.uint8)


def _float_upsample(c: np.ndarray, w: int, h: int, ssx: int, ssy: int) -> np.ndarray:
    """libavif's built-in 9/16 3/16 3/16 1/16 chroma (as float unorms)."""
    if not ssx and not ssy:
        return c
    i = np.arange(w)
    j = np.arange(h)
    ci, cj = i >> ssx, j >> ssy
    if ssx:
        adj_i = np.where((i == 0) | ((i == w - 1) & (i % 2 != 0)), ci,
                         np.where(i % 2 != 0, ci + 1, ci - 1))
    else:
        adj_i = ci
    if ssy:
        adj_j = np.where((j == 0) | ((j == h - 1) & (j % 2 != 0)), cj,
                         np.where(j % 2 != 0, cj + 1, cj - 1))
    else:
        adj_j = cj
    a = c[cj][:, ci]
    col = c[cj][:, adj_i]
    row = c[adj_j][:, ci]
    dia = c[adj_j][:, adj_i]
    return (a * F32(9.0 / 16.0) + col * F32(3.0 / 16.0) + row * F32(3.0 / 16.0) +
            dia * F32(1.0 / 16.0)).astype(F32)


def _float_rgb(planes, depth: int, ssx: int, ssy: int, cp: int, mc: int, full: bool,
               out_depth: int) -> np.ndarray:
    ymax = (1 << depth) - 1
    h, w = planes[0].shape
    if mc == 0:  # identity: every plane takes luma's range
        bias_y, range_y = (0.0, float(ymax)) if full else (float(16 << (depth - 8)),
                                                             float(219 << (depth - 8)))
        bias_uv, range_uv = bias_y, range_y
    elif full:
        bias_y, range_y = 0.0, float(ymax)
        bias_uv, range_uv = float(1 << (depth - 1)), float(ymax)
    else:
        bias_y, range_y = float(16 << (depth - 8)), float(219 << (depth - 8))
        bias_uv, range_uv = float(1 << (depth - 1)), float(224 << (depth - 8))
    tab_y = ((np.arange(ymax + 1, dtype=F32) - F32(bias_y)) / F32(range_y)).astype(F32)
    tab_uv = ((np.arange(ymax + 1, dtype=F32) - F32(bias_uv)) / F32(range_uv)).astype(F32)
    Y = tab_y[planes[0]]
    Cb = _float_upsample(tab_uv[planes[1]], w, h, ssx, ssy)
    Cr = _float_upsample(tab_uv[planes[2]], w, h, ssx, ssy)
    if mc == 0:
        R, G, B = Cr, Y, Cb
    elif mc == 8:  # YCgCo (H.273 equations 47-50)
        t = Y - Cb
        R, G, B = t + Cr, Y + Cb, t - Cr
    else:
        kr, kb = (F32(v) for v in kr_kb(cp, mc))
        kg = F32(1) - kr - kb
        R = Y + (F32(2) * (F32(1) - kr)) * Cr
        B = Y + (F32(2) * (F32(1) - kb)) * Cb
        G = Y - ((F32(2) * ((kr * (F32(1) - kr) * Cr) + (kb * (F32(1) - kb) * Cb))) / kg)
    omax = F32((1 << out_depth) - 1)
    out = np.stack([B, G, R], -1).astype(F32)
    out = (F32(0.5) + np.clip(out, F32(0), F32(1)) * omax).astype(np.int64)
    return out.astype(np.uint8 if out_depth == 8 else np.uint16)


def _alpha(a: np.ndarray, depth: int, full: bool, out_depth: int) -> np.ndarray:
    a = a.astype(np.int64)
    if not full:
        lo, hi = 16 << (depth - 8), 235 << (depth - 8)
        mx = (1 << depth) - 1
        num = (a - lo) * mx
        a = np.clip(np.where(num < 0, -((-num) // (hi - lo)), num // (hi - lo)), 0, mx)
    if depth == out_depth:
        return a.astype(np.uint8 if out_depth == 8 else np.uint16)
    v = (F32(0.5) + (a.astype(F32) / F32((1 << depth) - 1)) * F32((1 << out_depth) - 1))
    return v.astype(np.int64).astype(np.uint8 if out_depth == 8 else np.uint16)


def reformat_supported(mc: int, subsampled: bool, full: bool) -> bool:
    """libavif's avifPrepareReformatState: the reserved 3, BT.2020 CL, SMPTE
    2085, chroma-derived CL, ICtCp, YCgCo-Re / Ro (which cv2's equal
    depths never allow) and later matrices fail (cv2: "Cannot convert
    from AVIF to Mat", imread returns None), and so do identity unless
    4:4:4 and YCgCo at limited range; 15 converts with BT.601's kr / kb."""
    if mc in (3, 10, 11, 13, 14) or mc >= 16:
        return False
    return not ((mc == 0 and subsampled) or (mc == 8 and not full))


def to_rgb(planes, seq, cicp, out_depth: int, alpha: bool = False) -> np.ndarray:
    """avifImageYUVToRGB to BGR (BGRA's colour with `alpha`) at out_depth
    bits.  Deep YUV with alpha to 8 bits goes through libyuv's 16-bit rows
    (y widened to 16 bits, chroma cut to 8): 10 bits with the bilinear
    chroma of I010/I210AlphaToARGBMatrixFilter, 12 bits with the nearest
    chroma sample (libyuv has no filtered 12-bit rows); deep YUV without
    alpha is first cut to 8 bits by libyuv's Convert16To8 ((v * 2^(24 -
    depth)) >> 16, clamped) and then converted as 8-bit YUV."""
    cp, _, mc, full = cicp
    depth = seq.bit_depth
    h, w = planes[0].shape
    if mc == 0 and depth == out_depth and full:
        out = np.stack([planes[1], planes[0], planes[2]], -1)
        return out.astype(np.uint8 if depth == 8 else np.uint16)
    k = _libyuv_constants(cp, mc, bool(full))
    if depth > 8 and alpha and out_depth == 8 and k is not None:
        if depth == 10:
            u = _libyuv_upsample(planes[1], w, h, seq.ssx, seq.ssy)
            v = _libyuv_upsample(planes[2], w, h, seq.ssx, seq.ssy)
        else:  # libyuv has no filtered 12-bit rows: the nearest chroma sample
            rows = np.arange(h)[:, None] >> seq.ssy
            cols = np.arange(w)[None, :] >> seq.ssx
            u, v = planes[1][rows, cols], planes[2][rows, cols]
        return _libyuv_rgb(planes[0], u, v, k, depth)
    if depth > 8 and out_depth == 8 and k is not None:
        planes = [np.minimum((p.astype(np.int64) << (24 - depth)) >> 16, 255) for p in planes]
        depth = 8
    if depth == 8 and out_depth == 8 and k is not None:
        u = _libyuv_upsample(planes[1], w, h, seq.ssx, seq.ssy)
        v = _libyuv_upsample(planes[2], w, h, seq.ssx, seq.ssy)
        return _libyuv_rgb(planes[0], u, v, k)
    return _float_rgb(planes, depth, seq.ssx, seq.ssy, cp, mc, bool(full), out_depth)


def _gray_scale(y: np.ndarray, depth: int) -> np.ndarray:
    """Mat::convertTo(CV_8U, 1 / 2^(depth - 8)): round half to even, saturate."""
    return np.clip(np.rint(y.astype(np.float64) / (1 << (depth - 8))), 0, 255).astype(np.uint8)


def to_mat(planes, seq, cicp, alpha, mode: str, wide: bool = True,
           mono: bool | None = None) -> np.ndarray:
    """cv2's Mat in `mode`.  cv2 types it from the header (av1C): `wide`,
    more than 8 bits, makes "unchanged" a 16-bit Mat; `mono` (default: the
    decoded frame's) one channel, the Y plane copied whatever was decoded."""
    depth = seq.bit_depth
    if not wide and mode == "unchanged" and depth > 8:
        mode = "color8"
    if mono is None:
        mono = seq.num_planes == 1
    channels = (1 if mono else 3) + (alpha is not None)
    if channels == 2:
        raise UnreadableImage("AVIF grey with alpha: cv2 reads no two-channel AVIF")
    if mono:
        y = planes[0]
        if mode == "color8":
            return _gray_scale(y, depth)
        if mode == "unchanged":
            return y.astype(np.uint8 if depth == 8 else np.uint16)
        g = y.astype(np.uint8) if depth == 8 else _gray_scale(y, depth)
        if mode == "gray":
            return g
        return np.repeat(g[..., None], 3, 2)
    out_depth = depth if mode == "unchanged" else 8
    cp, _, mc, full = cicp
    if seq.num_planes == 1:
        # a monochrome frame under a colour header: libavif converts YUV
        # 4:0:0 in its float path with neutral chroma, identity and YCgCo
        # as grey too (so as BT.601, whose luma range they share)
        if not reformat_supported(mc, False, bool(full)):
            raise UnreadableImage("AVIF matrix coefficients libavif cannot convert")
        neutral = np.full_like(planes[0], 1 << (depth - 1))
        bgr = _float_rgb([planes[0], neutral, neutral], depth, 0, 0, cp,
                         6 if mc in (0, 8) else mc, bool(full), out_depth)
    elif not reformat_supported(mc, bool(seq.ssx | seq.ssy), bool(full)):
        raise UnreadableImage("AVIF matrix coefficients libavif cannot convert")
    else:
        bgr = to_rgb(planes, seq, cicp, out_depth, alpha is not None)
    if alpha is not None and mode in ("unchanged", "color8"):
        a = _alpha(alpha[0], alpha[1], alpha[2], out_depth)
        return np.concatenate([bgr, a[..., None]], -1)
    if mode == "gray":
        return cvt_gray(bgr)
    return bgr
