"""The image-format variants of the port's readers against cv2 5.0, which
kgtpu's readers call: TIFF layouts, sample formats and photometric
conversions, four-component, lossless and arithmetic-coded JPEG, JPEG in
TIFF, BMP RLE / 16-bit / OS/2 and CCITT bilevel TIFF, each parametrised by
variant x read mode at small sizes (odd sizes, tiles cut by the edge, every
subsampling); the corrupt and truncated streams of the new entropy
decoders; the containers cv2 sniffs beyond PNG, JPEG, TIFF and BMP; and the
port's folder and neural_cells readers against kgtpu's over a small tree of
variant files.

Fixtures are written in tmp_path by `tools/variant_encoders.py`, cv2 and
PIL.  cv2 reading a fixture is the check that it is valid; where cv2
returns None the port must raise `UnreadableImage` (a FileNotFoundError).

Tolerance: none.  Every comparison is exact (dtype, shape and every value).
"""

import io
import json
import os

import cv2
import numpy as np
import pytest
from PIL import Image

from kgtpu_torch.data.imread import (CONTAINERS, MODES, QUEUED, UnreadableImage,
                                     UnsupportedImage, read_image)
from tools import variant_encoders as ve

_CV = {"color": cv2.IMREAD_COLOR, "gray": cv2.IMREAD_GRAYSCALE,
       "unchanged": cv2.IMREAD_UNCHANGED}


def cv2_read(path, mode):
    """cv2.imread in the port's channel order (RGB / RGBA), or None."""
    img = cv2.imread(path, _CV[mode])
    if img is not None and img.ndim == 3:
        img = img[..., [2, 1, 0, 3][:img.shape[2]]] if img.shape[2] in (3, 4) else img
    return img


def check(path, mode):
    want = cv2_read(path, mode)
    if want is None:
        with pytest.raises(UnreadableImage):
            read_image(path, mode)
        return False
    got = read_image(path, mode)
    assert (got.dtype, got.shape) == (want.dtype, want.shape), (path, mode)
    np.testing.assert_array_equal(got, want, err_msg=f"{path} {mode}")
    return True


def smooth(h, w, seed=0):
    """Gradients and a sine (compress like photographs) with a noisy band."""
    y, x = np.mgrid[:h, :w]
    a = np.stack([(x * 7 + y * 3) % 256, (x * y) % 256,
                  128 + 100 * np.sin(x / 5.0 + y / 7.0)], -1).astype(np.uint8)
    a[h // 3:h // 2] = np.random.default_rng(seed).integers(0, 256, a[h // 3:h // 2].shape)
    return a


SIZES = ((37, 53), (17, 3), (1, 1))


# --- TIFF layouts and sample formats ----------------------------------------

def _tiff_layouts(rng):
    for h, w in SIZES:
        for lay in ({"rows_per_strip": 5}, {"tile": (16, 16)}):
            for comp, pred in ((1, 1), (5, 2), (8, 1), (32773, 1)):
                kw = dict(lay, compression=comp, predictor=pred)
                yield ve.tiff_image(rng.integers(0, 256, (h, w, 3)), 2, planar=2, **kw)
                yield ve.tiff_image(rng.integers(0, 65536, (h, w, 3)), 2, bits=16, planar=2,
                                    **kw)
                for ex in (None, [0], [1], [2]):
                    yield ve.tiff_image(rng.integers(0, 256, (h, w, 4)), 2, planar=2,
                                        extra=ex, bo="MM", **kw)
                    for photo in (0, 1):
                        for planar in (1, 2):
                            yield ve.tiff_image(rng.integers(0, 256, (h, w, 2)), photo,
                                                planar=planar, extra=ex, **kw)
                    yield ve.tiff_image(rng.integers(0, 65536, (h, w, 4)), 2, bits=16,
                                        extra=ex, **kw)
                    yield ve.tiff_image(rng.integers(0, 65536, (h, w, 2)), 1, bits=16,
                                        extra=ex, **kw)


def _tiff_sample_formats(rng):
    for h, w in SIZES[:2]:
        for lay in ({"rows_per_strip": 4}, {"tile": (16, 16)}):
            for bo in ("II", "MM"):
                for c, photo in ((1, 1), (3, 2), (4, 2)):
                    f = (rng.standard_normal((h, w, c)) * 1e3).astype(np.float32)
                    for comp, pred in ((1, 1), (8, 3), (5, 3), (8, 1)):
                        yield ve.tiff_image(f, photo, bits=32, sample_format=3, compression=comp,
                                            predictor=pred, bo=bo, **lay)
                    yield ve.tiff_image(f.astype(np.float64), photo, bits=64, sample_format=3,
                                        compression=8, predictor=3, bo=bo, **lay)
                    for bits, dt in ((8, np.int8), (16, np.int16), (32, np.int32)):
                        v = rng.integers(np.iinfo(dt).min, np.iinfo(dt).max, (h, w, c)).astype(dt)
                        for pred in (1, 2):
                            yield ve.tiff_image(v, photo, bits=bits, sample_format=2,
                                                compression=8, predictor=pred, bo=bo, **lay)
                    u = rng.integers(0, 2 ** 32, (h, w, c), dtype=np.uint64).astype(np.uint32)
                    yield ve.tiff_image(u, photo, bits=32, compression=5, predictor=2, bo=bo,
                                        **lay)
                    yield ve.tiff_image(f.astype(np.float16), photo, bits=16, sample_format=3,
                                        bo=bo, **lay)
                    for fmt, dt in ((1, np.uint64), (2, np.int64)):
                        yield ve.tiff_image(u.astype(dt) * 3 ** 20, photo, bits=64,
                                            sample_format=fmt, bo=bo, **lay)


def _tiff_old_lzw(rng):
    for h, w in SIZES:
        a = smooth(h, w)
        for kw in ({"rows_per_strip": 5}, {"tile": (16, 16)}):
            yield ve.tiff_image(a, 2, compression=-5, **kw)
            yield ve.tiff_image(a[..., 0], 1, compression=-5, **kw)
            yield ve.tiff_image(a.astype(np.uint16) * 257, 2, bits=16, compression=-5, **kw)


# --- TIFF photometric conversions -------------------------------------------

def _ycbcr(rng, h, w, hs, vs):
    y = smooth(h, w)[..., 0]
    cb = rng.integers(0, 256, (-(-h // vs), -(-w // hs)))
    cr = rng.integers(0, 256, cb.shape)
    return y, cb, cr


def _tiff_ycbcr(rng):
    for hs, vs in ((1, 1), (2, 1), (2, 2), (4, 1), (4, 2), (1, 2)):
        for h, w in ((37, 53), (9, 6), (1, 1)):
            y, cb, cr = _ycbcr(rng, h, w, hs, vs)
            yield ve.tiff_ycbcr(y, cb, cr, hs, vs, rows_per_strip=4 * vs)
            yield ve.tiff_ycbcr(y, cb, cr, hs, vs, compression=8, tile=(16, 16), bo="MM")
    y, cb, cr = _ycbcr(rng, 37, 53, 2, 2)
    for ref in ((0, 255, 128, 255, 128, 255), (16, 235, 128, 240, 128, 240),
                (15, 236, 120, 241, 130, 239)):
        for luma in ((0.299, 0.587, 0.114), (0.2126, 0.7152, 0.0722)):
            tags = {532: (ve.RATIONAL, [(int(v * 100), 100) for v in ref]),
                    529: (ve.RATIONAL, [(int(v * 10000), 10000) for v in luma])}
            yield ve.tiff_ycbcr(y, cb, cr, 2, 2, rows_per_strip=6, tags=tags)
    a = smooth(37, 53)
    yield ve.tiff_image(a, 6, tags={530: (ve.SHORT, [1, 1])}, planar=2, rows_per_strip=7)


def _tiff_cmyk_lab(rng):
    for h, w in SIZES:
        for lay in ({"rows_per_strip": 5}, {"tile": (16, 16)}):
            px = rng.integers(0, 256, (h, w, 4))
            yield ve.tiff_image(px, 5, **lay)
            yield ve.tiff_image(px, 5, planar=2, compression=8, **lay)
            lab = rng.integers(0, 256, (h, w, 3))
            yield ve.tiff_image(lab, 8, **lay)
            yield ve.tiff_image(rng.integers(0, 65536, (h, w, 3)), 8, bits=16, **lay)
            yield ve.tiff_image(lab, 8, tags={318: (ve.RATIONAL, [(3127, 10000),
                                                                  (3290, 10000)])}, **lay)
    a = smooth(37, 53)
    for mode in ("CMYK", "LAB", "LA"):
        for comp in (None, "tiff_lzw"):
            buf = io.BytesIO()
            Image.fromarray(a).convert(mode).save(buf, "TIFF", compression=comp)
            yield buf.getvalue()
    yield ve.tiff_image(rng.integers(0, 256, (96, 96, 3)), 8)      # a sweep of Lab


# --- JPEG: four components, lossless, arithmetic --------------------------

def _jpeg(a, **kw):
    params = []
    for k, v in kw.items():
        params += [getattr(cv2, "IMWRITE_JPEG_" + k.upper()), v]
    ok, buf = cv2.imencode(".jpg", a, params)
    return buf.tobytes()


def _jpeg_cmyk(rng):
    for h, w in ((37, 53), (17, 33), (8, 8), (1, 1)):
        a = smooth(h, w, seed=h)
        for q, sub in ((90, 0), (75, 2)):
            buf = io.BytesIO()
            Image.fromarray(a).convert("CMYK").save(buf, "JPEG", quality=q, subsampling=sub)
            cmyk = buf.getvalue()
            yield cmyk
            for t in (0, 1, 2):                     # CMYK, and YCCK by the flag
                yield ve.jpeg_set_adobe(cmyk, t)
        buf = io.BytesIO()
        Image.fromarray(a).convert("CMYK").save(buf, "JPEG", quality=85, progressive=True)
        yield ve.jpeg_set_adobe(buf.getvalue(), 2)


def _jpeg_lossless(rng):
    for h, w in ((37, 53), (17, 3), (1, 1)):
        a = smooth(h, w, seed=w)
        for pred in range(1, 8):
            for pt in (0, 2):
                yield ve.jpeg_lossless([a[..., 0]], pred, pt)
        yield ve.jpeg_lossless([a[..., 0]], 4, 1, restart_rows=2)
        yield ve.jpeg_lossless([a[..., 1]], 7, 0, restart_rows=5)
        for ids, adobe in (((1, 2, 3), None), ((82, 71, 66), None), ((0, 1, 2), None),
                           ((1, 2, 3), 0)):
            yield ve.jpeg_lossless([a[..., k] for k in range(3)], 6, 0, ids=ids, adobe=adobe)
            yield ve.jpeg_lossless([a[..., k] for k in range(3)], 1, 1, ids=ids, adobe=adobe,
                                   interleaved=False, restart_rows=3)
        c4 = [a[..., 0], a[..., 1], a[..., 2], 255 - a[..., 0]]
        yield ve.jpeg_lossless(c4, 5, 0, adobe=0)
        yield ve.jpeg_lossless(c4, 2, 0, adobe=2)
        yield ve.jpeg_lossless(c4, 3, 0)


def _jpeg_arith(rng):
    for h, w in ((37, 53), (17, 33), (8, 8), (1, 1)):
        a = smooth(h, w, seed=h)
        for sampling in ("444", "420", "422"):
            src = _jpeg(a, quality=90, sampling_factor=getattr(
                cv2, "IMWRITE_JPEG_SAMPLING_FACTOR_" + sampling))
            yield ve.jpeg_arith(src)
            yield ve.jpeg_arith(src, restart=3, interleaved=False)
            yield ve.jpeg_arith(src, dac=(1, 3, 2))
            yield ve.jpeg_arith(_jpeg(a, quality=50, progressive=1, sampling_factor=getattr(
                cv2, "IMWRITE_JPEG_SAMPLING_FACTOR_" + sampling)))
        yield ve.jpeg_arith(_jpeg(a[..., 0], quality=95, progressive=1), restart=2)
        yield ve.jpeg_arith(_jpeg(a[..., 0], quality=80), dac=(0, 0, 63))


# --- BMP: RLE, 16-bit, OS/2 -------------------------------------------------

def _bmp_rle(rng):
    for h, w in ((37, 53), (17, 3), (1, 1), (4, 300)):
        for bpp, comp in ((8, 1), (4, 2)):
            n = 1 << bpp
            idx = rng.integers(0, n, (h, w))
            idx[h // 3:h // 2] = rng.integers(0, 3, (1, w))         # long runs
            idx[:, :w // 4] = 0
            for grey in (False, True):
                pal = np.repeat(rng.integers(0, 256, (n, 1)), 3, 1) if grey \
                    else rng.integers(0, 256, (n, 3))
                for kw in ({}, {"absolute": False}, {"deltas": True}, {"end": False}):
                    data = ve.bmp_rle(idx, bpp, **kw)
                    yield ve.bmp_file(data, w, h, bpp, comp, pal)
                data = ve.bmp_rle(idx, bpp)
                yield ve.bmp_file(data[:len(data) // 2] + b"\0\1", w, h, bpp, comp, pal)
                yield ve.bmp_file(data[:len(data) // 2], w, h, bpp, comp, pal)   # truncated
                yield ve.bmp_file(bytes([0, 2, 5, 1]) + data, w, h, bpp, comp, pal)   # delta
                if w < 255:                                                      # past the row
                    yield ve.bmp_file(bytes([w + 1, 1]) + data, w, h, bpp, comp, pal)
                yield ve.bmp_file(data.replace(b"\0\0", b"", 1), w, h, bpp, comp, pal)
                yield ve.bmp_file(data, w, -h, bpp, comp, pal)


def _bmp_16_os2(rng):
    for h, w in ((37, 53), (17, 3), (1, 1)):
        v = rng.integers(0, 65536, (h, w)).astype("<u2")
        rows = ve.bmp_rows(v.view(np.uint8).reshape(h, -1))
        yield ve.bmp_file(rows, w, h, 16)
        for hdr in (40, 56, 124):
            for masks in ((0xF800, 0x7E0, 0x1F, 0), (0x7C00, 0x3E0, 0x1F, 0),
                          (0xF00, 0xF0, 0xF, 0)):
                yield ve.bmp_file(rows, w, h, 16, 3, header=hdr, masks=masks)
        px = rng.integers(0, 256, (h, w, 4))
        for bpp in (1, 4, 8, 24, 32, 16):
            if bpp <= 8:
                for grey in (False, True):
                    pal = np.repeat(rng.integers(0, 256, (1 << bpp, 1)), 3, 1) if grey \
                        else rng.integers(0, 256, (1 << bpp, 3))
                    idx = rng.integers(0, 1 << bpp, (h, w))
                    packed = ve.pack_bits(idx, bpp) if bpp < 8 else idx
                    yield ve.bmp_file(ve.bmp_rows(packed), w, h, bpp, header=12, palette=pal)
            else:
                nb = max(bpp // 8, 2)
                yield ve.bmp_file(ve.bmp_rows(px[..., :nb].reshape(h, -1)), w, h, bpp,
                                  header=12)


# --- JPEG in TIFF ------------------------------------------------------------

def _cv2_jpeg(sampling, quality=90):
    flag = getattr(cv2, "IMWRITE_JPEG_SAMPLING_FACTOR_" + sampling)

    def encode(block):
        a = block[..., 0] if block.shape[2] == 1 else block[..., ::-1]
        return _jpeg(np.ascontiguousarray(a), quality=quality, sampling_factor=flag)
    return encode


def _tiff_jpeg(rng):
    sub = {"444": (1, 1), "422": (2, 1), "420": (2, 2)}
    for h, w in ((37, 53), (17, 33), (1, 1)):
        a = smooth(h, w, seed=h)
        for sampling, hv in sub.items():
            enc = _cv2_jpeg(sampling)
            for lay in ({"rows_per_strip": 16}, {"rows_per_strip": 8, "tall_last": True},
                        {"tile": (16, 16)}, {"rows_per_strip": 16, "tables": False}):
                yield ve.tiff_jpeg(a, enc, 6, sampling=hv, **lay)
            yield ve.tiff_jpeg(a, enc, 6, sampling=(1, 1), rows_per_strip=16)   # wrong factors
        yield ve.tiff_jpeg(a, _cv2_jpeg("444"), 2, rows_per_strip=8)             # raw YCbCr
        yield ve.tiff_jpeg(a[..., :1], _cv2_jpeg("444"), 1, rows_per_strip=8, bo="MM")
        yield ve.tiff_jpeg(a[..., :1], _cv2_jpeg("444", 60), 0, tile=(16, 16))
        for mode in ("RGB", "L", "CMYK", "YCbCr"):
            buf = io.BytesIO()
            Image.fromarray(a).convert(mode).save(buf, "TIFF", compression="jpeg", quality=85)
            yield buf.getvalue()


# --- CCITT bilevel TIFF -------------------------------------------------------

def _tiff_ccitt(rng):
    from PIL import TiffImagePlugin
    for h, w in ((37, 53), (17, 3), (1, 1), (9, 1800)):
        a = smooth(h, w, seed=w)[..., 0] > 128
        a[h // 2:] = rng.random((h - h // 2, w)) < 0.1          # short runs
        for comp, t4 in (("tiff_ccitt", None), ("group3", None), ("group3", 1), ("group3", 5),
                         ("group3", 4), ("group4", None)):
            for fill in (1, 2):
                for rps in (None, 4):
                    ti = TiffImagePlugin.ImageFileDirectory_v2()
                    if t4 is not None:
                        ti[292] = t4
                    ti[266] = fill
                    if rps:
                        ti[278] = rps
                    buf = io.BytesIO()
                    img = Image.fromarray(a)
                    img.save(buf, "TIFF", compression=comp, tiffinfo=ti)
                    data = buf.getvalue()
                    yield data
                    if fill == 1 and rps is None:               # MinIsWhite
                        yield data.replace(b"\x06\x01\x03\x00\x01\x00\x00\x00\x01",
                                           b"\x06\x01\x03\x00\x01\x00\x00\x00\x00")


def _jpeg_smoothing(rng):
    """Progressive Huffman and arithmetic JPEGs with scans dropped so that
    coefficients 1-9 stay unrefined (libjpeg smooths their blocks), and cut
    inside their scans."""
    for h, w, sub in ((37, 53, "420"), (40, 16, "444"), (9, 70, "422")):
        a = smooth(h, w, seed=h)
        src = _jpeg(a, quality=85, progressive=1, sampling_factor=getattr(
            cv2, "IMWRITE_JPEG_SAMPLING_FACTOR_" + sub))
        n = sum(1 for m, _ in ve.jpeg_segments(src) if m == 0xDA)
        for keep in ({0}, {0, 1}, {0, 1, 2, 3}, set(range(n - 1)), {0, 2, 4, 6}):
            x = ve.jpeg_keep_scans(src, keep)
            yield x
            yield ve.jpeg_arith(x, progressive=True)
        yield src[:len(src) // 3]
        yield _jpeg(a[..., 0], quality=60, progressive=1)[:250]


def _jpeg_lossless_sub(rng):
    """Lossless JPEG, first component subsampled hv against the others
    (libjpeg-turbo's box upsampling in lossless frames)."""
    import struct
    for (h, w) in ((24, 32), (17, 23), (5, 3)):
        a = smooth(h, w)
        for hs, vs in ((2, 2), (2, 1), (1, 2), (4, 1), (4, 2)):
            ch, cw = -(-h // vs), -(-w // hs)
            y = ve.jpeg_lossless([a[..., 0]], 1, interleaved=False)
            c = ve.jpeg_lossless([np.ascontiguousarray(a[::vs, ::hs, k][:ch, :cw]) for k in (1, 2)],
                                 1, ids=[2, 3], interleaved=False)
            sof = b"\xff\xc3" + struct.pack(">HBHHB", 17, 8, h, w, 3) + bytes(
                [1, hs * 16 + vs, 0, 2, 0x11, 0, 3, 0x11, 0])
            dht = y[y.index(b"\xff\xc4"):y.index(b"\xff\xda")]
            yield (b"\xff\xd8" + sof + dht + y[y.index(b"\xff\xda"):-2] +
                   c[c.index(b"\xff\xda"):-2] + b"\xff\xd9")


def _tiff_ycbcr44(rng):
    """4x4 YCbCr in strips (one block row, several, the last short) and
    tiles cut by the edges, with odd numbers of blocks across."""
    for h, w in ((24, 28), (13, 9), (22, 30), (37, 53), (8, 4)):
        y, cb, cr = _ycbcr(rng, h, w, 4, 4)
        for lay in ({}, {"rows_per_strip": 4}, {"rows_per_strip": 8}, {"tile": (16, 16)}):
            yield ve.tiff_ycbcr(y, cb, cr, 4, 4, **lay)


def _tiff_packed_depths(rng):
    """10-, 12- and 14-bit grey (one or three samples, MinIsWhite too) and
    RGB(A) (cv2 reads them in "unchanged" only, widened to 16 bits)."""
    for bits in (10, 12, 14):
        for spp, photo in ((1, 1), (1, 0), (3, 2), (4, 2), (3, 1), (2, 1)):
            yield tiff_packed(_rand((7, 9, spp), bits, seed=bits + spp), bits, photo,
                              tags={338: (ve.SHORT, [2])} if spp in (2, 4) else None)


def _tiff_samples_palettes(rng):
    """Grey of two to four samples, palettes with an extra sample or
    without a ColorMap (TIFFReadDirectory's fallback), at 8 and 16 bits."""
    cmap = {320: (ve.SHORT, _rand((3 * 256,), 16, seed=3).tolist())}
    for bits in (8, 16):
        for spp in (2, 3, 4):
            for lay in ({}, {"tile": (16, 16)}) + (({"planar": 2},) if bits == 8 else ()):
                yield ve.tiff_image(_rand((19, 21, spp), bits, seed=spp), 1, bits=bits, **lay)
        for spp in (1, 2, 3):
            yield ve.tiff_image(_rand((19, 21, spp), bits, seed=spp), 3, bits=bits)
            if bits == 8:
                yield ve.tiff_image(_rand((19, 21, spp), 8, seed=spp), 3, tags=cmap,
                                    tile=(16, 16))


def _tiff_jpeg_planes(rng):
    """JPEG TIFF in separate planes: one stream a plane and strip."""
    for spp, photo in ((3, 2), (4, 2), (2, 1)):
        px = (_rand((37, 53, spp), 8, seed=spp) // 32 * 32).astype(np.uint8)
        for rps in (37, 8):
            streams = [_jpeg(np.ascontiguousarray(px[y:y + rps, :, k]), quality=90)
                       for k in range(spp) for y in range(0, 37, rps)]
            t = {256: (ve.LONG, [53]), 257: (ve.LONG, [37]), 258: (ve.SHORT, [8] * spp),
                 259: (ve.SHORT, [7]), 262: (ve.SHORT, [photo]), 277: (ve.SHORT, [spp]),
                 284: (ve.SHORT, [2]), 278: (ve.LONG, [rps])}
            if spp in (2, 4):
                t[338] = (ve.SHORT, [2])
            yield ve.tiff_file(streams, t)


def _tiff_rlew(rng):
    """CCITT RLEW and RLE (MinIsWhite, both fill orders, one strip or
    several)."""
    for h, w in ((37, 53), (9, 1800), (4, 13)):
        a = smooth(h, w, seed=w)[..., 0] > 128
        a[h // 2:] = rng.random((h - h // 2, w)) < 0.1
        for fill in (1, 2):
            for rps in (None, 3):
                for words in (True, False):
                    yield ve.tiff_ccitt_rlew(a, fill, rps, words)


def _tiff_thunderscan(rng):
    """ThunderScan 4-bit palettes: raw pixels, or runs and 2- and 3-bit
    deltas mixed, in one strip or several, and with a byte changed."""
    for h, w in ((6, 10), (17, 23), (40, 64)):
        v = np.cumsum(rng.integers(-1, 2, (h, w)), 1).clip(0, 15).astype(np.uint8)
        v[:, :w // 3] = v[:, :1]
        cm = list(rng.integers(0, 65536, 48))
        for mix, rps in ((None, None), (rng, None), (rng, 3)):
            data = ve.tiff_thunderscan(v, 3, rng=mix, colormap=cm, rows_per_strip=rps)
            yield data
        b = bytearray(data)
        b[20] ^= 0x55
        yield bytes(b)


def _tiff_sgilog(rng):
    """SGILog: LogLuv 24-bit (34677) and 32-bit (34676) words, LogL 16-bit,
    in one strip or several."""
    for h, w in ((6, 10), (17, 23), (5, 3)):
        for rps in (None, 4):
            lc = (rng.integers(0, 1024, (h, w)) << 14 | rng.integers(0, 16400, (h, w)))
            yield ve.tiff_sgilog(lc.astype(np.uint32), False, 34677, rps, bits=8)
            luv = rng.integers(0, 65536, (h, w)) << 16 | rng.integers(0, 65536, (h, w))
            yield ve.tiff_sgilog(luv.astype(np.uint32), False, 34676, rps, rng=rng)
            yield ve.tiff_sgilog(rng.integers(0, 65536, (h, w)).astype(np.uint32), True, 34676,
                                 rps)


VARIANTS = {
    "jpeg_smoothing": _jpeg_smoothing,
    "jpeg_lossless_subsampled": _jpeg_lossless_sub,
    "tiff_ycbcr_4x4": _tiff_ycbcr44,
    "tiff_packed_depths": _tiff_packed_depths,
    "tiff_samples_palettes": _tiff_samples_palettes,
    "tiff_jpeg_planes": _tiff_jpeg_planes,
    "tiff_ccitt_rlew": _tiff_rlew,
    "tiff_thunderscan": _tiff_thunderscan,
    "tiff_sgilog": _tiff_sgilog,
    "tiff_layouts": _tiff_layouts,
    "tiff_sample_formats": _tiff_sample_formats,
    "tiff_old_lzw": _tiff_old_lzw,
    "tiff_ycbcr": _tiff_ycbcr,
    "tiff_cmyk_lab": _tiff_cmyk_lab,
    "jpeg_cmyk": _jpeg_cmyk,
    "jpeg_lossless": _jpeg_lossless,
    "jpeg_arith": _jpeg_arith,
    "tiff_jpeg": _tiff_jpeg,
    "tiff_ccitt": _tiff_ccitt,
    "bmp_rle": _bmp_rle,
    "bmp_16_os2": _bmp_16_os2,
}
_EXT = {"tiff": ".tif", "jpeg": ".jpg", "bmp": ".bmp"}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_reads_like_cv2(tmp_path, variant, mode):
    """Every file of the variant group equals cv2's decode in this mode, or
    raises UnreadableImage where cv2 returns None; a file that cv2 reads
    and the port refuses fails the test."""
    rng = np.random.default_rng(sum(map(ord, variant)))
    path = str(tmp_path / ("f" + _EXT[variant.split("_")[0]]))
    read = 0
    for k, data in enumerate(VARIANTS[variant](rng)):
        with open(path, "wb") as f:
            f.write(data)
        try:
            read += check(path, mode)
        except UnsupportedImage:
            assert variant == "tiff_layouts" and mode == "unchanged", (k, variant)
    # cv2 reads 10- to 14-bit samples in "unchanged" only, and lossless JPEG
    # with subsampled components not in "gray"
    assert read > 0 or (variant, mode) in {("tiff_packed_depths", "color"),
                                           ("tiff_packed_depths", "gray"),
                                           ("jpeg_lossless_subsampled", "gray")}


# --- refusals ------------------------------------------------------------------

def _containers():
    a = smooth(20, 24)
    out = {}
    for name, fmt in (("webp", "WEBP"), ("jp2", "JPEG2000"), ("gif", "GIF"), ("ppm", "PPM"),
                      ("avif_deblocked", "AVIF")):
        buf = io.BytesIO()
        Image.fromarray(a).save(buf, fmt)
        out[name] = buf.getvalue()
    # AVIF whose frame needs loop restoration (read since it was ported) and
    # film grain, a filter still queued (libaom's all-intra encodes; PIL's
    # default only deblocks)
    img = ve.avif_content(np.random.default_rng(30), 64, 64, 3, "smooth")
    planes = [np.ascontiguousarray(img[..., 0])] + \
        [np.ascontiguousarray(img[::2, ::2, k]) for k in (1, 2)]
    for name, opts in (("avif_restored", {"enable-restoration": 1}),
                       ("avif", {"film-grain-test": 1, "enable-restoration": 0})):
        out[name] = ve.avif_file(ve.aom_encode(planes, "420", {
            "cq-level": 30, "enable-cdef": 0, "loopfilter-control": 0, **opts},
            usage=2), 64, 64, ssx=1, ssy=1, profile=0, cicp=(1, 13, 6, 1))
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, "JPEG2000", no_jp2=True)
    out["j2k"] = buf.getvalue()
    for name, ext, img in (("pgm", ".pgm", a[..., 0]), ("pam", ".pam", a),
                           ("pfm", ".pfm", a.astype(np.float32)), ("sun", ".ras", a),
                           ("hdr", ".hdr", a)):
        out[name] = cv2.imencode(ext, img)[1].tobytes()
    out["pgm_ascii"] = cv2.imencode(".pgm", a[..., 0], [cv2.IMWRITE_PXM_BINARY, 0])[1].tobytes()
    return out


PORTED_CONTAINERS = ("webp", "gif", "ppm", "pgm", "pgm_ascii", "pam", "pfm", "sun", "hdr",
                     "jp2", "j2k", "avif_deblocked", "avif_restored")


@pytest.mark.parametrize("name", sorted(PORTED_CONTAINERS))
def test_containers_cv2_sniffs_decode_like_cv2(tmp_path, name):
    """cv2 5.0 reads WebP, PNM / PAM / PFM, Sun raster, Radiance HDR, GIF,
    JPEG 2000 and AVIF content whatever the file is called; the port reads
    them as cv2 does (data/webp.py, pnm.py, sunras.py, hdr.py, gif.py,
    jpeg2000.py, avif.py; PIL's default AVIF is deblocked, libaom's
    `avif_restored` needs loop restoration) in every mode,
    and raises UnreadableImage where cv2 returns None (a colour PFM in
    "gray")."""
    path = str(tmp_path / "image.png")
    with open(path, "wb") as f:
        f.write(_containers()[name])
    assert cv2.imread(path, cv2.IMREAD_UNCHANGED) is not None
    assert sum(check(path, mode) for mode in MODES) >= 2


@pytest.mark.parametrize("name", sorted(set(_containers()) - set(PORTED_CONTAINERS)))
def test_containers_cv2_sniffs_raise_unsupported(tmp_path, name):
    """cv2 5.0 reads AVIF content whatever the file is called; where its
    frame needs a filter still queued (film grain; loop restoration until
    it was ported), the port names the ROADMAP item that queues it instead
    of saying cv2 cannot."""
    path = str(tmp_path / "image.png")
    with open(path, "wb") as f:
        f.write(_containers()[name])
    assert cv2.imread(path, cv2.IMREAD_UNCHANGED) is not None
    for mode in MODES:
        with pytest.raises(UnsupportedImage, match=CONTAINERS):
            read_image(path, mode)


def _patched_sof(marker: int, prec: int = 8, height: int | None = None) -> bytes:
    data = bytearray(_jpeg(smooth(16, 16), quality=90))
    at = data.index(b"\xff\xc0")
    data[at + 1] = marker
    data[at + 4] = prec
    if height is not None:
        data[at + 5:at + 7] = height.to_bytes(2, "big")
    return bytes(data)


def _lossless_subsampled(a) -> bytes:
    """A lossless (SOF3) JPEG whose first component is 2x2 subsampled
    against the other two: one scan a component."""
    import struct
    y = ve.jpeg_lossless([a[..., 0]], 1, interleaved=False)
    c = ve.jpeg_lossless([a[::2, ::2, 1], a[::2, ::2, 2]], 1, ids=[2, 3], interleaved=False)
    h, w = a.shape[:2]
    sof = b"\xff\xc3" + struct.pack(">HBHHB", 17, 8, h, w, 3) + bytes(
        [1, 0x22, 0, 2, 0x11, 0, 3, 0x11, 0])
    dht = y[y.index(b"\xff\xc4"):y.index(b"\xff\xda")]
    return b"\xff\xd8" + sof + dht + y[y.index(b"\xff\xda"):-2] + \
        c[c.index(b"\xff\xda"):-2] + b"\xff\xd9"


def _unreadable():
    a = smooth(17, 21)
    out = {f"tiff_codec_{c}": ve.tiff_image(a, 2, compression=1,
                                            tags={259: (ve.SHORT, [c])})
           for c in (6, 32909, 34925, 50000, 50001, 34887, 34661)}
    out.update({f"jpeg_sof_{m:02x}": _patched_sof(m) for m in (0xC5, 0xC6, 0xC7, 0xCB, 0xCD,
                                                               0xCE, 0xCF)})
    out["jpeg_12bit_sof1"] = _patched_sof(0xC1, 12)
    out["jpeg_12bit_sof0"] = _patched_sof(0xC0, 12)
    out["jpeg_dnl_height"] = _patched_sof(0xC0, 8, 0)
    out["jpeg_lossless_12bit"] = bytearray(ve.jpeg_lossless([a[..., 0]], 1))
    out["jpeg_lossless_12bit"][out["jpeg_lossless_12bit"].index(b"\xff\xc3") + 4] = 12
    out["jpeg_lossless_12bit"] = bytes(out["jpeg_lossless_12bit"])
    out["tiff_float16"] = ve.tiff_image(a.astype(np.float16), 2, bits=16, sample_format=3)
    out["tiff_thunderscan_4bit"] = ve.tiff_image(a[..., 0] >> 4, 1, bits=4,
                                                 tags={259: (ve.SHORT, [32809])})
    out["tiff_thunderscan_8bit_palette"] = ve.tiff_image(
        a[..., 0], 3, tags={259: (ve.SHORT, [32809]), 320: (ve.SHORT, [0] * 768)})
    out["tiff_next_2bit_grey"] = ve.tiff_next(a[..., 0] >> 6)
    out["tiff_next_2bit_palette"] = ve.tiff_next(a[..., 0] >> 6, 3, colormap=[0] * 12)
    out["tiff_sgilog24_logl"] = ve.tiff_image(a[..., 0], 32844, tags={259: (ve.SHORT, [34677])})
    out["tiff_palette_4bit_without_colormap"] = ve.tiff_image(a[..., 0] >> 4, 3, bits=4)
    out["tiff_no_photometric"] = ve.tiff_file(
        [a.tobytes()], {256: (ve.LONG, [21]), 257: (ve.LONG, [17]), 258: (ve.SHORT, [8] * 3),
                        277: (ve.SHORT, [3]), 278: (ve.LONG, [17])})
    out.update(_tiff_cv2_refuses())
    return out


def _rand(shape, bits, seed=0):
    return np.random.default_rng(seed).integers(0, 1 << bits, shape).astype(
        np.uint16 if bits > 8 else np.uint8)


def tiff_packed(px, bits: int, photometric: int, tags=None) -> bytes:
    """A one-strip TIFF of `px` ([H, W, spp]) packed at `bits` bits a
    sample, most significant first, each row byte-aligned (any depth)."""
    h, w, c = px.shape
    rows = []
    for row in px.reshape(h, -1).astype(np.uint32):
        b = ((row[:, None] >> np.arange(bits - 1, -1, -1)) & 1).astype(np.uint8)
        rows.append(np.packbits(b.reshape(-1)).tobytes())
    t = {256: (ve.LONG, [w]), 257: (ve.LONG, [h]), 258: (ve.SHORT, [bits] * c),
         259: (ve.SHORT, [1]), 262: (ve.SHORT, [photometric]), 277: (ve.SHORT, [c]),
         284: (ve.SHORT, [1]), 278: (ve.LONG, [h])}
    t.update(tags or {})
    return ve.tiff_file([b"".join(rows)], t)


def _tiff_cv2_refuses():
    """The TIFFs the reader once called queued though cv2 returns None for
    them (24x20 files): (file, the modes where cv2 returns None)."""
    h, w = 20, 24
    cmap = {320: (ve.SHORT, _rand(3 * 65536, 16, seed=1).tolist())}
    out = {
        # the RGBA reader's kinds (tiff.py `_kind`)
        "tiff_kind_grey_2_samples_4bit": ve.tiff_image(_rand((h, w, 2), 4), 1, bits=4),
        "tiff_kind_rgb_2_samples": ve.tiff_image(_rand((h, w, 2), 8), 2),
        "tiff_kind_rgb_5_samples": ve.tiff_image(_rand((h, w, 5), 8), 2),
        "tiff_kind_rgb_1bit": ve.tiff_image(_rand((h, w, 3), 1), 2, bits=1),
        "tiff_kind_rgb_4bit": ve.tiff_image(_rand((h, w, 3), 4), 2, bits=4),
        "tiff_kind_palette_16bit": ve.tiff_image(_rand((h, w, 1), 16), 3, bits=16, tags=cmap),
        "tiff_kind_photometric_4": ve.tiff_image(_rand((h, w, 1), 1), 4, bits=1),
        "tiff_kind_photometric_9": ve.tiff_image(_rand((h, w, 3), 8), 9),
        "tiff_kind_photometric_10": ve.tiff_image(_rand((h, w, 3), 8), 10),
        "tiff_kind_photometric_32844": ve.tiff_image(_rand((h, w, 3), 8), 32844),
        "tiff_kind_photometric_9_16bit": ve.tiff_image(_rand((h, w, 1), 16), 9, bits=16),
        "tiff_kind_ycbcr_16bit": ve.tiff_image(_rand((h, w, 3), 16), 6, bits=16),
        "tiff_kind_ycbcr_4_samples": ve.tiff_image(_rand((h, w, 4), 8), 6),
        "tiff_kind_cmyk_3_samples": ve.tiff_image(_rand((h, w, 3), 8), 5),
        "tiff_kind_cmyk_5_samples": ve.tiff_image(_rand((h, w, 5), 8), 5),
        "tiff_kind_cmyk_inkset_2": ve.tiff_image(_rand((h, w, 4), 8), 5,
                                                 tags={332: (ve.SHORT, [2])}),
        "tiff_kind_lab_1_sample": ve.tiff_image(_rand((h, w, 1), 8), 8),
        "tiff_kind_lab_4_samples": ve.tiff_image(_rand((h, w, 4), 8), 8),
        # predictors (tiff.py `_check`); libtiff applies them with LZW / deflate
        "tiff_check_predictor_4": ve.tiff_image(_rand((h, w, 3), 8), 2, compression=8,
                                                tags={317: (ve.SHORT, [4])}),
        "tiff_check_predictor_3_int8": ve.tiff_image(_rand((h, w, 3), 8), 2, compression=8,
                                                     tags={317: (ve.SHORT, [3])}),
        "tiff_check_predictor_3_int16": ve.tiff_image(_rand((h, w, 3), 16), 2, bits=16,
                                                      compression=8,
                                                      tags={317: (ve.SHORT, [3])}),
        "tiff_check_predictor_2_1bit": ve.tiff_image(_rand((h, w, 1), 1), 1, bits=1,
                                                     compression=5,
                                                     tags={317: (ve.SHORT, [2])}),
        # mixed BitsPerSample (tiff.py `_Dir.__init__`)
        "tiff_dir_bits_8_8_16": ve.tiff_image(_rand((h, w, 3), 8), 2,
                                              tags={258: (ve.SHORT, [8, 8, 16])}),
        "tiff_dir_bits_8_8_4": ve.tiff_image(_rand((h, w, 3), 8), 2,
                                             tags={258: (ve.SHORT, [8, 8, 4])}),
        # YCbCr subsampling and planes (tiff.py `_ycbcr_subsampled`, `_rgba`)
        "tiff_ycbcr_subsampling_3x1": ve.tiff_ycbcr(*(_rand(s, 8) for s in ((h, w), (h, 8),
                                                                            (h, 8))), 3, 1,
                                                    rows_per_strip=8),
        "tiff_ycbcr_subsampling_2x4": ve.tiff_ycbcr(*(_rand(s, 8) for s in ((h, w), (5, 12),
                                                                            (5, 12))), 2, 4,
                                                    rows_per_strip=8),
        "tiff_ycbcr_planar_subsampled": ve.tiff_image(_rand((h, w, 3), 8), 6, planar=2,
                                                      tags={530: (ve.SHORT, [2, 2])}),
    }
    out = {k: (v, MODES) for k, v in out.items()}
    # bit depths libtiff's RGBA reader refuses (tiff.py `_check`); 10-, 12-
    # and 14-bit grey and RGB read in "unchanged" (`_queued`)
    for bits in (3, 5, 6, 7, 10, 12, 14, 24):
        modes = ("color", "gray") if bits in (10, 12, 14) else MODES
        out[f"tiff_check_grey_{bits}bit"] = (tiff_packed(_rand((h, w, 1), min(bits, 16)),
                                                         bits, 1), modes)
        out[f"tiff_check_rgb_{bits}bit"] = (tiff_packed(_rand((h, w, 3), min(bits, 16)),
                                                        bits, 2), modes)
    out["jpeg_lossless_subsampled_gray"] = (_lossless_subsampled(smooth(24, 32)), ("gray",))
    out["tiff_check_palette_12bit"] = (tiff_packed(
        _rand((h, w, 1), 12), 12, 3, {320: (ve.SHORT, _rand(3 * 4096, 16).tolist())}), MODES)
    return out


@pytest.mark.parametrize("compression", [1, 32773])
def test_predictor_of_a_codec_without_one_reads_like_cv2(tmp_path, compression):
    """libtiff applies the Predictor tag with LZW and deflate only: with no
    compression or PackBits, predictor 4 and predictor 3 on integers are
    ignored and cv2 reads the samples as stored."""
    a = smooth(20, 24)
    for pred in (3, 4):
        path = str(tmp_path / f"p{pred}.tif")
        with open(path, "wb") as f:
            f.write(ve.tiff_image(a, 2, compression=compression,
                                  tags={317: (ve.SHORT, [pred])}))
        assert all(check(path, mode) for mode in MODES)


@pytest.mark.parametrize("name", sorted(_unreadable()))
def test_what_cv2_cannot_read_raises_unreadable(tmp_path, name):
    """Codecs cv2's libtiff lacks, hierarchical and lossless-arithmetic JPEG,
    12-bit JPEG (baseline, extended and lossless), a DNL height and 16-bit
    float TIFF, and the TIFF kinds, predictors, bit depths and YCbCr layouts
    that libtiff refuses: cv2 returns None in each mode tested (every mode,
    or "color" and "gray" for 10-, 12- and 14-bit samples), the port raises
    UnreadableImage (a FileNotFoundError) there."""
    path = str(tmp_path / ("f.tif" if name.startswith("tiff") else "f.jpg"))
    data = _unreadable()[name]
    data, modes = data if isinstance(data, tuple) else (data, MODES)
    with open(path, "wb") as f:
        f.write(data)
    for mode in modes:
        assert cv2.imread(path, _CV[mode]) is None
        with pytest.raises(UnreadableImage):
            read_image(path, mode)


def _queued():
    a = smooth(24, 32)
    y, cb, cr = _ycbcr(np.random.default_rng(0), 24, 32, 4, 4)
    prog = _jpeg(a, quality=90)
    out = {
        "tiff_ycbcr_4x4": (ve.tiff_ycbcr(y, cb, cr, 4, 4, rows_per_strip=8), MODES),
        "tiff_planar16_unchanged": (ve.tiff_image(np.zeros((24, 32, 3), np.uint16) + 7, 2,
                                                  bits=16, planar=2), ("unchanged",)),
        "jpeg_arith_dc_only": (ve.jpeg_arith(prog, progressive=True), MODES),
        "tiff_sgilog": (ve.tiff_image(a, 32845, compression=1, tags={259: (ve.SHORT, [34677])}),
                        ()),
    }
    h, w = 20, 24
    for bits in (10, 12, 14):
        out[f"tiff_grey_{bits}bit_unchanged"] = (tiff_packed(_rand((h, w, 1), bits), bits, 1),
                                                 ("unchanged",))
        out[f"tiff_rgb_{bits}bit_unchanged"] = (tiff_packed(_rand((h, w, 3), bits), bits, 2),
                                                ("unchanged",))
    out.update({
        "tiff_palette_16bit_without_colormap": (ve.tiff_image(_rand((h, w, 1), 16), 3, bits=16),
                                                MODES),
        "tiff_grey_3_samples_16bit": (ve.tiff_image(_rand((h, w, 3), 16), 1, bits=16), MODES),
        "tiff_unknown_compression": (ve.tiff_image(_rand((h, w, 3), 8), 2,
                                                   tags={259: (ve.SHORT, [12345])}), MODES),
        "tiff_ccitt_rlew": (ve.tiff_image(_rand((h, w, 1), 1), 1, bits=1,
                                          tags={259: (ve.SHORT, [32771])}), MODES),
        "tiff_jpeg_separate_planes": (_jpeg_tiff_planar(_rand((h, w, 3), 8)), MODES),
        "jpeg_lossless_subsampled": (_lossless_subsampled(smooth(24, 32)),
                                     ("color", "unchanged")),
    })
    out.update({k: (v, MODES) for k, v in _ccitt_undecodable().items()})
    return out


def _jpeg_tiff_planar(px) -> bytes:
    """A JPEG-compressed RGB TIFF in separate planes, one stream a plane."""
    h, w, _ = px.shape
    streams = [_jpeg(np.ascontiguousarray(px[..., k]), quality=90) for k in range(3)]
    t = {256: (ve.LONG, [w]), 257: (ve.LONG, [h]), 258: (ve.SHORT, [8] * 3),
         259: (ve.SHORT, [7]), 262: (ve.SHORT, [2]), 277: (ve.SHORT, [3]),
         284: (ve.SHORT, [2]), 278: (ve.LONG, [h])}
    return ve.tiff_file(streams, t)


def _ccitt_undecodable():
    """CCITT strips with a byte flipped or zeroed, one per refusal of
    `data/ccitt.py` (libtiff recovers from bad lines; cv2 reads them)."""
    from PIL import TiffImagePlugin

    from kgtpu_torch.data.tiff import _Dir
    rng = np.random.default_rng(1)
    a = rng.random((20, 24)) < 0.3

    def encode(comp):
        buf = io.BytesIO()
        Image.fromarray(a).save(buf, "TIFF", compression=comp,
                                tiffinfo=TiffImagePlugin.ImageFileDirectory_v2())
        return buf.getvalue()

    def mutate(data, fn):
        d = _Dir(data)
        off, cnt = d.offsets[0], d.counts[0]
        return data[:off] + bytes(fn(bytearray(data[off:off + cnt]))) + data[off + cnt:]

    def flip(seed):
        def fn(s):
            r = np.random.default_rng(seed)
            s[int(r.integers(len(s) // 4, len(s)))] ^= int(r.integers(1, 256))
            return s
        return fn
    zero_tail = lambda s: s[:len(s) // 2] + bytearray(len(s) - len(s) // 2)  # noqa: E731
    return {
        "tiff_ccitt_code_that_does_not_decode": mutate(encode("tiff_ccitt"), zero_tail),
        "tiff_ccitt_1d_runs_off_the_width": mutate(encode("tiff_ccitt"), flip(0)),
        "tiff_ccitt_2d_code_off_the_row": mutate(encode("group4"), flip(2)),
        "tiff_ccitt_2d_runs_off_the_width": mutate(encode("group4"), flip(1)),
        "tiff_ccitt_group3_ends_early": mutate(encode("group3"), flip(1)),
    }


@pytest.mark.parametrize("name", ["tiff_planar16_unchanged"])
def test_queued_variants_raise_unsupported(tmp_path, name):
    """The variant cv2 reads and the port still queues (ROADMAP §1's
    image-format variants, "not portable"): 16-bit separate planes in
    "unchanged", where cv2 reads the first plane's blocks as if contiguous
    and leaves the rest of its buffer as it was."""
    data, modes = _queued()[name]
    path = str(tmp_path / ("f.tif" if name.startswith("tiff") else "f.jpg"))
    with open(path, "wb") as f:
        f.write(data)
    for mode in modes:
        assert cv2.imread(path, _CV[mode]) is not None
    for mode in modes or MODES:
        with pytest.raises(UnsupportedImage, match=QUEUED):
            read_image(path, mode)


@pytest.mark.parametrize("name", sorted(set(_queued()) - {"tiff_planar16_unchanged"}))
def test_formerly_queued_variants_read_like_cv2(tmp_path, name):
    """The variants queued until this slice now read exactly as cv2 reads
    them in each mode it reads (UnreadableImage in the others): 4x4 YCbCr
    (libtiff's truncated scanline size and 10-byte tile skew), a progressive
    arithmetic JPEG of its DC scans only (block smoothing), SGILog, 10- to
    14-bit samples in "unchanged", a 16-bit palette without a ColorMap (read
    as grey), grey of three samples, a codec libtiff does not know (zeros),
    CCITT RLEW and damaged CCITT data (libtiff's recovery), JPEG TIFF in
    separate planes and lossless JPEG with subsampled components."""
    data, modes = _queued()[name]
    path = str(tmp_path / ("f.tif" if name.startswith("tiff") else "f.jpg"))
    with open(path, "wb") as f:
        f.write(data)
    read = [mode for mode in MODES if check(path, mode)]
    assert set(modes) <= set(read), (read, modes)


# --- corrupt and truncated streams -------------------------------------------

def _damaged(data: bytes, rng, keep_tail: bytes = b"\xff\xd9"):
    """Cuts at several points (the end marker kept), and single bytes
    flipped in the entropy-coded data; and the header segments (tables,
    frame, scan headers) cut and flipped too."""
    start = data.rindex(b"\xff\xda")
    for frac in (0.2, 0.5, 0.9):
        cut = start + int((len(data) - start) * frac)
        yield data[:cut] + keep_tail
        yield data[:cut]
    for _ in range(4):
        b = bytearray(data)
        at = int(rng.integers(start + 20, len(data) - 2))
        b[at] ^= int(rng.integers(1, 256))
        yield bytes(b)
    head = data.index(b"\xff\xda") + 12
    for _ in range(3):
        yield data[:int(rng.integers(4, head))]
        b = bytearray(data)
        b[int(rng.integers(2, head))] ^= int(rng.integers(1, 256))
        yield bytes(b)


def _corrupt_streams(rng):
    a = smooth(37, 53, seed=3)
    for sampling in ("444", "420"):
        flag = getattr(cv2, "IMWRITE_JPEG_SAMPLING_FACTOR_" + sampling)
        yield from _damaged(ve.jpeg_arith(_jpeg(a, quality=90, sampling_factor=flag)), rng)
        yield from _damaged(ve.jpeg_arith(_jpeg(a, quality=80, progressive=1,
                                                sampling_factor=flag), restart=4), rng)
        src = bytearray(_jpeg(a, quality=90, sampling_factor=flag))
        for m in (0xC9, 0xCA):          # Huffman data read as arithmetic
            b = bytearray(src)
            b[b.index(b"\xff\xc0") + 1] = m
            yield bytes(b)
    for prog in (0, 1):                 # Huffman, sequential and progressive
        for rst in (0, 2):
            yield from _damaged(_jpeg(a, quality=90, progressive=prog, rst_interval=rst), rng)
    for pred in (1, 6):
        yield from _damaged(ve.jpeg_lossless([a[..., 0]], pred), rng)
        yield from _damaged(ve.jpeg_lossless([a[..., k] for k in range(3)], pred,
                                             restart_rows=4), rng)


@pytest.mark.parametrize("mode", MODES)
def test_corrupt_and_truncated_streams_decode_like_cv2(tmp_path, mode):
    """Arithmetic-coded (sequential, progressive with restarts, Huffman data
    under an SOF9 / SOF10 marker), Huffman (sequential and progressive, with
    and without restarts) and lossless streams cut short or with a byte
    flipped: what libjpeg does past the data (zeros for arithmetic; the rest
    of the interval left as it was for Huffman; restart markers resynced)
    and the port decode to the same pixels."""
    path = str(tmp_path / "c.jpg")
    read = 0
    for data in _corrupt_streams(np.random.default_rng(7)):
        with open(path, "wb") as f:
            f.write(data)
        read += check(path, mode)
    assert read > 0


def test_extreme_coefficients_decode_like_cv2(tmp_path):
    """JPEGs whose coefficients leave the range valid data keeps (random
    blocks of magnitudes up to 16000, half of them zero, at several
    quantisations and samplings; coded arithmetically, coefficients as
    given): cv2's IDCT is libjpeg-turbo's AVX2 code, whose 16-bit sums,
    saturated column pass and all-zero-rows shortcut the port follows."""
    import kgtpu_torch.data.jpeg as jpeg
    rng = np.random.default_rng(6)
    path = str(tmp_path / "x.jpg")
    parse = jpeg.parse
    for q in (20, 50, 90, 100):
        for sub in ("444", "420"):
            src = _jpeg(np.full((40, 56, 3), 128, np.uint8), quality=q,
                        sampling_factor=getattr(cv2, "IMWRITE_JPEG_SAMPLING_FACTOR_" + sub))
            for amp in (1000, 16000):
                coefs = [np.where(rng.random(len(c.coef)) < 0.5, 0,
                                  rng.integers(-amp, amp, len(c.coef))).tolist()
                         for c in parse(src)["components"]]

                def planted(data, coefs=coefs):
                    img = parse(data)
                    for c, v in zip(img["components"], coefs):
                        c.coef = list(v)
                    return img
                jpeg.parse = planted
                try:
                    data = ve.jpeg_arith(src)
                finally:
                    jpeg.parse = parse
                with open(path, "wb") as f:
                    f.write(data)
                for mode in MODES:
                    assert check(path, mode)


# --- dataset readers over variant files -------------------------------------

def _variant_files(rng, h=40, w=52):
    """{file name: bytes} of colour-readable variants of every group."""
    a = smooth(h, w, seed=w)
    cmyk = io.BytesIO()
    Image.fromarray(a).convert("CMYK").save(cmyk, "JPEG", quality=90)
    y, cb, cr = _ycbcr(rng, h, w, 2, 2)
    g4 = io.BytesIO()
    Image.fromarray(a[..., 0] > 128).save(g4, "TIFF", compression="group4")
    idx = rng.integers(0, 4, (h, w))
    return {
        "planar.tif": ve.tiff_image(a, 2, planar=2, rows_per_strip=7, compression=8),
        "float.tiff": ve.tiff_image(a, 2, compression=-5, rows_per_strip=9),
        "ycbcr.tif": ve.tiff_ycbcr(y, cb, cr, 2, 2, rows_per_strip=8),
        "cmyk.tif": ve.tiff_image(np.concatenate([a, a[..., :1]], -1), 5, tile=(16, 16)),
        "lab.tif": ve.tiff_image(a, 8),
        "cmyk.jpg": cmyk.getvalue(),
        "ycck.jpeg": ve.jpeg_set_adobe(cmyk.getvalue(), 2),
        "lossless.jpg": ve.jpeg_lossless([a[..., k] for k in range(3)], 7),
        "arith.jpg": ve.jpeg_arith(_jpeg(a, quality=90)),
        "jpeg_in.tif": ve.tiff_jpeg(a, _cv2_jpeg("420"), 6, sampling=(2, 2), rows_per_strip=16),
        "g4.tif": g4.getvalue(),
        "rle8.bmp": ve.bmp_file(ve.bmp_rle(idx, 8), w, h, 8, 1, rng.integers(0, 256, (4, 3))),
        "b16.bmp": ve.bmp_file(ve.bmp_rows(rng.integers(0, 256, (h, 2 * w))), w, h, 16),
        "os2.bmp": ve.bmp_file(ve.bmp_rows(a.reshape(h, -1)), w, h, 24, header=12),
    }


def test_folder_and_neural_cells_read_variants_like_kgtpu(tmp_path):
    """kgtpu's folder and neural_cells readers (cv2) and the port's over a
    tree of variant files, sample by sample (sha256 of every image and label
    map): images of every group, and neural-cells masks in CCITT, RLE and
    YCbCr files, read in grey."""
    import warnings

    from kgtpu.data.folder import ImageFolder as JaxImageFolder
    from kgtpu.data.neural_cells import NeuralCells as JaxNeuralCells
    from kgtpu_torch.data.folder import ImageFolder
    from kgtpu_torch.data.neural_cells import NeuralCells
    from test_torch_datasets import assert_same_samples
    rng = np.random.default_rng(11)
    files = _variant_files(rng)
    folder = tmp_path / "folder"
    os.makedirs(folder / "sub")
    for n, (name, data) in enumerate(sorted(files.items())):
        with open(folder / ("sub" if n % 2 else ".") / name, "wb") as f:
            f.write(data)
    assert_same_samples(ImageFolder(str(folder)), JaxImageFolder(str(folder)))
    root = tmp_path / "cells"
    os.makedirs(root / "images")
    os.makedirs(root / "labels")
    for n, (name, data) in enumerate(sorted(files.items())):
        cid, ext = f"cell_{n:02d}", os.path.splitext(name)[1]
        with open(root / "images" / (cid + ext), "wb") as f:
            f.write(data)
        lab = np.zeros((40, 52), np.uint16)
        lab[5:15, 5:20], lab[20:35, 25:50] = 1, 2 + n
        if n % 3:
            cv2.imwrite(str(root / "labels" / f"{cid}.png"), lab)
            continue
        os.makedirs(root / "masks" / cid)
        for k, v in enumerate(v for v in np.unique(lab) if v):
            m = lab == v
            buf = io.BytesIO()
            if k % 3 == 0:
                Image.fromarray(m).save(buf, "TIFF", compression="group4")
            elif k % 3 == 1:
                buf.write(ve.bmp_file(ve.bmp_rle(m.astype(np.uint8), 8), 52, 40, 8, 1,
                                      [[0, 0, 0], [255, 255, 255]]))
            else:
                buf.write(ve.tiff_ycbcr((m * 255).astype(np.uint8), np.full((20, 26), 128),
                                        np.full((20, 26), 128), 2, 2, rows_per_strip=8))
            with open(root / "masks" / cid / f"m{k}.{'bmp' if k % 3 == 1 else 'tif'}",
                      "wb") as f:
                f.write(buf.getvalue())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for split in ("train", "val"):
            ours, theirs = NeuralCells(str(root), split), JaxNeuralCells(str(root), split)
            assert ours.paths == theirs.paths
            if len(theirs):
                assert_same_samples(ours, theirs)


@pytest.mark.parametrize("key", ["variants2", "variants2_extra"])
def test_committed_variants2_fixtures_decode_as_cv2_recorded(key):
    """The files of assets_torch/formats/variants2 (served by chip_smoke.py
    [15]) and variants2_extra (decoded only) in every mode equal cv2's
    decode recorded in kgtpu_reference_formats.npz (sha256, shape, dtype;
    UnreadableImage where it recorded None), and cv2 here still decodes
    them so."""
    from tools.make_torch_format_assets import VARIANTS2, VARIANTS2_EXTRA, sha
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    folder = os.path.join(root, "assets_torch", "formats", key)
    with np.load(os.path.join(root, "assets_torch", "kgtpu_reference_formats.npz")) as ref:
        decodes = json.loads(str(ref[f"{key}_decode_json"]))
        kinds = json.loads(str(ref[f"{key}_kinds_json"]))
    table = VARIANTS2 if key == "variants2" else VARIANTS2_EXTRA
    assert sorted(kinds.values()) == sorted(k for k, _ in table)
    assert len(decodes) == 3 * len(kinds)
    for d in decodes:
        path = os.path.join(folder, d["path"])
        if d["sha256"] is None:
            assert cv2_read(path, d["mode"]) is None
            with pytest.raises(UnreadableImage):
                read_image(path, d["mode"])
            continue
        got = read_image(path, d["mode"])
        assert (sha(got), list(got.shape), str(got.dtype)) == (d["sha256"], d["shape"],
                                                               d["dtype"]), d
        np.testing.assert_array_equal(got, cv2_read(path, d["mode"]))
