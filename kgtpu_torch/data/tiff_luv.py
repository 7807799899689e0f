"""SGILog-compressed TIFF (LogLuv and LogL, compressions 34676 SGILOG and
34677 SGILOG24), decoded as libtiff 4.7's `tif_luv.c` decodes it, in NumPy:

  * SGILOG24: three bytes a pixel, big-endian: a 10-bit log luminance and a
    14-bit index into the (u', v') grid of `uvcode.h` (`_USTART`, `_NUS`:
    the grid's rows, read out of libtiff and checked against its known
    first rows), LogLuv24toXYZ;
  * SGILOG: each row's bytes in planes, most significant first, each plane
    run-length coded (a byte >= 128 repeats the next byte n - 126 times,
    one below 128 takes the next n bytes as they are): LogLuv32 (16-bit
    signed log luminance, 8-bit u and v, LogLuv32toXYZ) for LogLuv, and
    LogL16 (LogL16toY) for LogL;
  * the RGBA reader, which cv2's "color" and "gray" modes read through,
    asks for 8-bit output: XYZtoRGB24's CCIR-709 matrix and gamma 2
    (256 sqrt(v), cut to 0..255), and 256 sqrt(Y) for LogL;
  * cv2's "unchanged" of LogLuv asks for float XYZ and converts it with
    its own XYZ -> BGR (float32, `_XYZ2RGB`); LogL reads as grey there.

A row whose data runs out fails libtiff's decoder (the RGBA reader keeps
the rows before it, the rest 0); cv2's float read then fails too.  The
values of a row are computed as libtiff computes them: in double, rounded
to float once (XYZ), and for 8 bits truncated.
"""

from __future__ import annotations

import numpy as np

_USTART = np.array([
    0.247663, 0.243779, 0.241684, 0.237874, 0.235906, 0.232153, 0.228352, 0.226259,
    0.222371, 0.22041, 0.21471, 0.212714, 0.210721, 0.204976, 0.202986, 0.199245, 0.195525,
    0.19356, 0.189878, 0.186216, 0.186216, 0.182592, 0.179003, 0.175466, 0.172001, 0.172001,
    0.168612, 0.168612, 0.163575, 0.158642, 0.158642, 0.158642, 0.153815, 0.153815,
    0.149097, 0.149097, 0.142746, 0.142746, 0.142746, 0.13827, 0.13827, 0.13827, 0.132166,
    0.132166, 0.126204, 0.126204, 0.126204, 0.120381, 0.120381, 0.120381, 0.120381,
    0.112962, 0.112962, 0.112962, 0.10745, 0.10745, 0.10745, 0.10745, 0.100343, 0.100343,
    0.100343, 0.095126, 0.095126, 0.095126, 0.095126, 0.088276, 0.088276, 0.088276,
    0.088276, 0.081523, 0.081523, 0.081523, 0.081523, 0.074861, 0.074861, 0.074861,
    0.074861, 0.06829, 0.06829, 0.06829, 0.06829, 0.063573, 0.063573, 0.063573, 0.063573,
    0.057219, 0.057219, 0.057219, 0.057219, 0.050985, 0.050985, 0.050985, 0.050985,
    0.050985, 0.044859, 0.044859, 0.044859, 0.044859, 0.040571, 0.040571, 0.040571,
    0.040571, 0.036339, 0.036339, 0.036339, 0.036339, 0.032139, 0.032139, 0.032139,
    0.032139, 0.027947, 0.027947, 0.027947, 0.023739, 0.023739, 0.023739, 0.023739,
    0.019504, 0.019504, 0.019504, 0.016976, 0.016976, 0.016976, 0.016976, 0.012639,
    0.012639, 0.012639, 0.009991, 0.009991, 0.009991, 0.009016, 0.009016, 0.009016,
    0.006217, 0.006217, 0.005097, 0.005097, 0.005097, 0.003909, 0.003909, 0.00234, 0.002389,
    0.001068, 0.001653, 0.000717, 0.001614, 0.00027, 0.000484, 0.001103, 0.001242, 0.001188,
    0.001011, 0.000709, 0.000301, 0.002416, 0.003251, 0.003246, 0.004141, 0.005963,
    0.008839, 0.01049, 0.016994, 0.023659,
], np.float32)
_NUS = np.array([
    4, 6, 7, 9, 10, 12, 14, 15, 17, 18, 21, 22, 23, 26, 27, 29, 31, 32, 34, 36, 36, 38, 40,
    42, 44, 44, 46, 46, 49, 52, 52, 52, 55, 55, 58, 58, 62, 62, 62, 65, 65, 65, 69, 69, 73,
    73, 73, 77, 77, 77, 77, 82, 82, 82, 86, 86, 86, 86, 91, 91, 91, 95, 95, 95, 95, 100,
    100, 100, 100, 105, 105, 105, 105, 110, 110, 110, 110, 115, 115, 115, 115, 119, 119,
    119, 119, 124, 124, 124, 124, 129, 129, 129, 129, 129, 134, 134, 134, 134, 138, 138,
    138, 138, 142, 142, 142, 142, 146, 146, 146, 146, 150, 150, 150, 154, 154, 154, 154,
    158, 158, 158, 161, 161, 161, 161, 165, 165, 165, 168, 168, 168, 170, 170, 170, 173,
    173, 175, 175, 175, 177, 177, 177, 170, 164, 157, 150, 143, 136, 129, 123, 115, 109,
    103, 97, 89, 82, 76, 69, 62, 55, 47, 40, 31, 21,
], np.int64)
_NCUM = np.concatenate([[0], np.cumsum(_NUS)[:-1]])
# uvcode.h's (float) constants
UV_SQSIZ, UV_VSTART, UV_NDIVS = float(np.float32(0.0035)), float(np.float32(0.01694)), 16289
U_NEU, V_NEU = 0.210526316, 0.473684211
UVSCALE = 410.0
_LN2 = 0.69314718055994530942
# cv2's XYZ -> sRGB (D65) rows, float32
_XYZ2RGB = np.array([[3.240479, -1.53715, -0.498535], [-0.969256, 1.875991, 0.041556],
                     [0.055648, -0.204043, 1.057311]], np.float32)


def _uv_decode(c: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """uv_decode: (u, v) at the centre of grid cell c; a cell past the
    grid gives the neutral (u, v)."""
    ok = (c >= 0) & (c < UV_NDIVS)
    vi = np.clip(np.searchsorted(_NCUM, c, side="right") - 1, 0, len(_NCUM) - 1)
    ui = c - _NCUM[vi]
    u = _USTART[vi].astype(np.float64) + (ui + 0.5) * UV_SQSIZ
    v = UV_VSTART + (vi + 0.5) * UV_SQSIZ
    return np.where(ok, u, U_NEU), np.where(ok, v, V_NEU)


def _xyz(L: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """(u', v') and luminance -> float32 XYZ, as LogLuv24toXYZ /
    LogLuv32toXYZ compute it (0 where L <= 0)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        s = 1.0 / (6.0 * u - 16.0 * v + 12.0)
        x, y = 9.0 * u * s, 4.0 * v * s
        xyz = np.stack([(x / y * L).astype(np.float32), L.astype(np.float32),
                        ((1.0 - x - y) / y * L).astype(np.float32)], -1)
    return np.where((L > 0)[..., None], xyz, np.float32(0))


def luv24_xyz(p: np.ndarray) -> np.ndarray:
    """24-bit LogLuv words -> float32 XYZ."""
    p10 = (p >> 14) & 0x3FF
    L = np.where(p10 == 0, 0.0, np.exp(_LN2 / 64.0 * (p10 + 0.5) - _LN2 * 12.0))
    u, v = _uv_decode(p & 0x3FFF)
    return _xyz(L, u, v)


def _logl16(p16: np.ndarray) -> np.ndarray:
    le = p16 & 0x7FFF
    y = np.where(le == 0, 0.0, np.exp(_LN2 / 256.0 * (le + 0.5) - _LN2 * 64.0))
    return np.where(p16 & 0x8000, -y, y)


def luv32_xyz(p: np.ndarray) -> np.ndarray:
    """32-bit LogLuv words -> float32 XYZ."""
    L = _logl16((p >> 16).astype(np.int64) & 0xFFFF)
    u = 1.0 / UVSCALE * (((p >> 8) & 0xFF) + 0.5)
    v = 1.0 / UVSCALE * ((p & 0xFF) + 0.5)
    return _xyz(L, u, v)


def _gamma8(v: np.ndarray) -> np.ndarray:
    """(v <= 0) ? 0 : (v >= 1) ? 255 : (int)(256 sqrt(v))."""
    with np.errstate(invalid="ignore"):
        out = np.floor(256.0 * np.sqrt(np.maximum(v, 0.0)))
    return np.where(v <= 0, 0, np.where(v >= 1, 255, out)).astype(np.uint8)


def xyz_to_rgb24(xyz: np.ndarray) -> np.ndarray:
    """XYZtoRGB24: CCIR-709 primaries in double, gamma 2, 8 bits."""
    x, y, z = (xyz[..., k].astype(np.float64) for k in range(3))
    r = 2.690 * x + -1.276 * y + -0.414 * z
    g = -1.022 * x + 1.978 * y + 0.044 * z
    b = 0.061 * x + -0.224 * y + 1.163 * z
    return np.stack([_gamma8(r), _gamma8(g), _gamma8(b)], -1)


def xyz_to_rgb_cv2(xyz: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(XYZ2BGR) on a float32 [h, w, 3] image, as RGB.  Along
    each row cv2 takes the pixels eight at a time, then four, as
    x c0 + (y c1 + z c2) (its SIMD code), and the last ones (fewer than
    four) as (x c0 + y c1) + z c2, each product and sum rounded to
    float32."""
    w = xyz.shape[1]
    vec = w // 8 * 8 + (4 if w % 8 >= 4 else 0)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    m = _XYZ2RGB
    out = np.empty_like(xyz)
    for k in range(3):
        a, b, c = x * m[k, 0], y * m[k, 1], z * m[k, 2]
        out[:, :vec, k] = a[:, :vec] + (b[:, :vec] + c[:, :vec])
        out[:, vec:, k] = (a[:, vec:] + b[:, vec:]) + c[:, vec:]
    return out


def _rle_planes(data: bytes, at: int, n: int, planes: int) -> tuple[np.ndarray, int, bool]:
    """One row of `n` pixels of `planes` run-length coded byte planes (most
    significant first) from data[at:] -> ([n] words, next position,
    whether every plane filled)."""
    words = np.zeros(n, np.uint32)
    cc = len(data) - at
    for k in range(planes):
        shift = 8 * (planes - 1 - k)
        i = 0
        plane = bytearray(n)
        got = np.zeros(n, bool)
        while i < n and cc > 0:
            c = data[at]
            if c >= 128:
                if cc < 2:
                    break
                rc, b = c - 126, data[at + 1]
                at, cc = at + 2, cc - 2
                take = min(rc, n - i)
                plane[i:i + take] = bytes([b]) * take
                got[i:i + take] = True
                i += take
            else:
                at += 1
                rc = c
                while True:
                    cc -= 1
                    if cc == 0 or rc == 0 or i >= n:
                        break
                    rc -= 1
                    plane[i] = data[at]
                    got[i] = True
                    at += 1
                    i += 1
        words |= np.frombuffer(bytes(plane), np.uint8).astype(np.uint32) << shift
        if i != n:
            return words, at, False
    return words, at, True


def decode_sgilog(data: bytes, d, rows: int, w: int, floats: bool) -> tuple[np.ndarray, bool]:
    """One strip of SGILog data -> [rows, w, 3] float32 XYZ (LogLuv) or
    [rows, w] float64 Y (LogL) where `floats`, else the 8-bit RGB or grey
    libtiff's RGBA reader gets; and whether every row decoded (rows after
    a failing one are 0, its own words read so far)."""
    logl = d.photo == 32844
    out = np.zeros((rows, w) if logl else (rows, w, 3), np.float64 if logl and floats else
                   np.float32 if floats else np.uint8)
    at = 0
    for r in range(rows):
        if d.comp == 34677:
            n = min(w, (len(data) - at) // 3)
            b = np.frombuffer(data, np.uint8, 3 * n, at).reshape(n, 3).astype(np.uint32)
            words = np.zeros(w, np.uint32)
            words[:n] = b[:, 0] << 16 | b[:, 1] << 8 | b[:, 2]
            at += 3 * n
            ok = n == w
            if not ok:
                return out, False
        else:
            words, at, ok = _rle_planes(data, at, w, 2 if logl else 4)
            if not ok:
                return out, False
        if logl:
            y = _logl16(words.astype(np.int64) & 0xFFFF)
            out[r] = y if floats else _gamma8(y)
        else:
            xyz = (luv24_xyz if d.comp == 34677 else luv32_xyz)(words)
            out[r] = xyz if floats else xyz_to_rgb24(xyz)
    return out, True


def read_sgilog(d, data: bytes, mode: str) -> np.ndarray:
    """A LogLuv or LogL TIFF (`tiff._Dir` d) in a read mode, as cv2 reads it
    (RGB order): 8-bit through the RGBA reader in "color" and "gray" (and
    LogL's "unchanged"), float32 in LogLuv's "unchanged"."""
    from kgtpu_torch.data.bmp import bgr_to_gray
    from kgtpu_torch.data.imread import UnreadableImage
    logl = d.photo == 32844
    if not (d.photo == 32845 and d.spp == 3 and d.comp in (34676, 34677)
            or logl and d.spp == 1 and d.comp == 34676) or d.planar != 1:
        raise UnreadableImage(f"TIFF SGILog compression {d.comp} of photometric {d.photo} and "
                              f"{d.spp} samples (cv2 cannot read it)")
    floats = mode == "unchanged" and not logl
    if not floats and d.bits not in (1, 2, 4, 8, 16):
        raise UnreadableImage(f"SGILog TIFF of {d.bits}-bit samples in {mode} mode (cv2 "
                              "cannot read it)")
    shape = (d.h, d.w) if logl else (d.h, d.w, 3)
    px = np.zeros(shape, np.float32 if floats else np.uint8)
    for k, (y, _) in enumerate(d.grid):
        rows = min(d.th, d.h - y)
        block, ok = decode_sgilog(d.raw(data, k) or b"", d, rows, d.w, floats)
        if floats and not ok:
            raise UnreadableImage("SGILog data that ends short (cv2's float read fails)")
        px[y:y + rows] = block
    if floats:
        return np.ascontiguousarray(xyz_to_rgb_cv2(px))
    if logl:
        return np.repeat(px[..., None], 3, -1) if mode == "color" else px
    return px if mode == "color" else bgr_to_gray(px[..., ::-1])
