"""The port's image readers (`kgtpu_torch/data/imread.py` and its codecs)
against cv2 5.0, which kgtpu's readers call: every format, read mode and
variant of PNG, BMP, TIFF and JPEG that the port reads, at small odd sizes
(37x53 and smaller) so that MCU, tile and row-padding edges are hit; EXIF
and TIFF orientations; the variants that raise; `draw.fill_poly` against
cv2.fillPoly and `transforms.resize_nearest` against cv2.resize.

Fixtures are written in tmp_path with cv2 and PIL, and by the encoders
below where neither writes the variant (interlaced and low-depth PNG, BMP
headers and bit fields, tiled TIFF, every TIFF codec and predictor).  cv2
reading a fixture is the check that it is valid.

Tolerance: none.  Every comparison is exact (dtype, shape and every value).
"""

import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from kgtpu_torch.data import draw
from kgtpu_torch.data.bmp import bgr_to_gray
from kgtpu_torch.data.imread import (MODES, QUEUED, UnreadableImage, UnsupportedImage,
                                     read_image)
from kgtpu_torch.data.transforms import resize_nearest

_CV = {"color": cv2.IMREAD_COLOR, "gray": cv2.IMREAD_GRAYSCALE,
       "unchanged": cv2.IMREAD_UNCHANGED}
H, W = 37, 53


def cv2_read(path, mode):
    """cv2.imread in the port's channel order (RGB / RGBA), or None."""
    img = cv2.imread(path, _CV[mode])
    if img is not None and img.ndim == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGRA2RGBA if img.shape[2] == 4
                           else cv2.COLOR_BGR2RGB)
    return img


def assert_reads_like_cv2(path, modes=MODES):
    for mode in modes:
        want = cv2_read(path, mode)
        if want is None:
            with pytest.raises(FileNotFoundError):
                read_image(path, mode)
            continue
        got = read_image(path, mode)
        assert (got.dtype, got.shape) == (want.dtype, want.shape), mode
        np.testing.assert_array_equal(got, want, err_msg=f"{path} {mode}")


def write(path, data):
    with open(path, "wb") as f:
        f.write(data)
    return str(path)


# --- encoders for what cv2 and PIL do not write ---------------------------

_PNG_CH = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
ADAM7 = [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2)]


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _pack(v, bits):
    """[rows, n] samples of 1, 2 or 4 bits -> rows of bytes, MSB first."""
    per = 8 // bits
    v = np.concatenate([v, np.zeros((len(v), (-v.shape[1]) % per), v.dtype)], 1)
    v = v.reshape(len(v), -1, per).astype(np.uint8)
    return (v << (bits * np.arange(per - 1, -1, -1)).astype(np.uint8)).sum(-1).astype(np.uint8)


def _png_rows(px, ctype, depth, filters):
    h, w = px.shape[:2]
    ch = _PNG_CH[ctype]
    if depth == 16:
        raw = px.reshape(h, w, ch).astype(">u2").view(np.uint8).reshape(h, -1)
    elif depth == 8:
        raw = px.reshape(h, w * ch).astype(np.uint8)
    else:
        raw = _pack(px.reshape(h, w), depth)
    raw = raw.astype(np.int32)
    bpp = max(ch * depth // 8, 1)
    rows = []
    for r in range(h):
        ft = filters[r % len(filters)]
        cur, prev = raw[r], (raw[r - 1] if r else np.zeros_like(raw[r]))
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        p = left + prev - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, ul))
        pred = [np.zeros_like(cur), left, prev, (left + prev) >> 1, paeth][ft]
        rows.append(np.concatenate([[ft], (cur - pred) & 255]).astype(np.uint8).tobytes())
    return b"".join(rows)


def make_png(px, ctype, depth, filters=(0, 1, 2, 3, 4), palette=None, trns=None,
             interlace=0, extra=b""):
    """A PNG of any colour type and bit depth, plain or Adam7-interlaced,
    its rows filtered by `filters` in turn."""
    px = np.asarray(px)
    h, w = px.shape[:2]
    if interlace:
        data = b"".join(_png_rows(px[y0::dy, x0::dx], ctype, depth, filters)
                        for x0, y0, dx, dy in ADAM7 if px[y0::dy, x0::dx].size)
    else:
        data = _png_rows(px, ctype, depth, filters)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                                               0, 0, interlace))
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return out + extra + _chunk(b"IDAT", zlib.compress(data)) + _chunk(b"IEND", b"")


def make_bmp(px, bpp, palette=None, header=40, compression=0, masks=None, top_down=False,
             clrused=None):
    """A BMP: px is [H, W] indices (bpp <= 8), [H, W, 3|4] BGR(A) bytes (24,
    32 BI_RGB) or [H, W] packed 32-bit pixels (BI_BITFIELDS)."""
    px = np.asarray(px)
    h, w = px.shape[:2]
    stride = (w * bpp + 31) // 32 * 4
    if bpp < 8:
        rows = _pack(px, bpp)
    elif bpp == 8:
        rows = px.astype(np.uint8)
    elif bpp == 24:
        rows = px[..., :3].astype(np.uint8).reshape(h, -1)
    elif masks is None:
        rows = np.concatenate([px[..., :3], px[..., 3:4] if px.shape[-1] == 4 else
                               np.zeros((h, w, 1))], -1).astype(np.uint8).reshape(h, -1)
    else:
        rows = px.astype("<u4").view(np.uint8).reshape(h, -1)
    rows = np.concatenate([rows, np.zeros((h, stride - rows.shape[1]), np.uint8)], 1)
    data = (rows if top_down else rows[::-1]).tobytes()
    pal = b"" if palette is None else np.concatenate(
        [np.asarray(palette, np.uint8), np.zeros((len(palette), 1), np.uint8)], 1).tobytes()
    n_pal = 0 if palette is None else len(palette)
    info = struct.pack("<iiHHIIiiII", w, -h if top_down else h, 1, bpp, compression,
                       len(data), 2835, 2835, n_pal if clrused is None else clrused, 0)
    extra = b""
    if header == 40 and masks is not None:
        extra = struct.pack("<III", *masks[:3])
    elif header > 40:
        info += struct.pack("<4I", *(list(masks or (0, 0, 0, 0)) + [0] * 4)[:4])
        info += b"\0" * (header - 4 - 40 - 16)
    off = 14 + 4 + len(info) + len(extra) + len(pal)
    return (b"BM" + struct.pack("<IHHI", off + len(data), 0, 0, off) + struct.pack("<I", header)
            + info + extra + pal + data)


def lzw_encode(data: bytes) -> bytes:
    """TIFF LZW as libtiff writes it (MSB-first codes, early change)."""
    out, acc, nacc = bytearray(), 0, 0

    def put(code, width):
        nonlocal acc, nacc
        acc = (acc << width) | code
        nacc += width
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 0xFF)
        acc &= (1 << nacc) - 1
    table = {bytes([i]): i for i in range(256)}
    nxt, width, w = 258, 9, b""
    put(256, width)
    for c in data:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        put(table[w], width)
        table[wc] = nxt
        nxt += 1
        if nxt >= 4094:
            put(256, width)
            table = {bytes([i]): i for i in range(256)}
            nxt, width = 258, 9
        elif nxt > (1 << width) - 1:
            width += 1
        w = bytes([c])
    if w:
        put(table[w], width)
        if nxt + 1 > (1 << width) - 1 and width < 12:
            width += 1
    put(257, width)
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


def packbits(data: bytes) -> bytes:
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([257 - (j - i + 1)]) + data[i:i + 1]
        else:
            while j + 1 < n and data[j + 1] != data[j] and j - i < 127:
                j += 1
            out += bytes([j - i]) + data[i:j + 1]
        i = j + 1
    return bytes(out)


def make_tiff(px, photometric, bits=8, compression=1, predictor=1, tile=None,
              rows_per_strip=None, bo="II", colormap=None, extra=None, orientation=None):
    """A TIFF of one IFD in strips or tiles (edge tiles zero-padded)."""
    px = np.asarray(px)
    if px.ndim == 2:
        px = px[..., None]
    h, w, c = px.shape
    e = "<" if bo == "II" else ">"

    def encode(block):
        b = block.astype(np.uint16 if bits == 16 else np.uint8)
        if predictor == 2:
            b[:, 1:] = b[:, 1:] - b[:, :-1].copy()
        if bits == 16:
            rows = [r.astype(e + "u2").tobytes() for r in b]
        elif bits == 8:
            rows = [r.tobytes() for r in b]
        else:
            rows = [r.tobytes() for r in _pack(b.reshape(len(b), -1), bits)]
        if compression in (8, 32946):
            return zlib.compress(b"".join(rows))
        if compression == 5:
            return lzw_encode(b"".join(rows))
        if compression == 32773:
            return b"".join(packbits(r) for r in rows)
        return b"".join(rows)
    if tile:
        tw, th = tile
        blocks = []
        for y in range(0, h, th):
            for x in range(0, w, tw):
                t = np.zeros((th, tw, c), px.dtype)
                sub = px[y:y + th, x:x + tw]
                t[:sub.shape[0], :sub.shape[1]] = sub
                blocks.append(encode(t))
    else:
        rps = rows_per_strip or h
        blocks = [encode(px[y:y + rps]) for y in range(0, h, rps)]
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * c), 259: (3, [compression]),
            262: (3, [photometric]), 277: (3, [c]), 284: (3, [1])}
    if predictor != 1:
        tags[317] = (3, [predictor])
    if colormap is not None:
        tags[320] = (3, list(np.asarray(colormap).T.reshape(-1)))
    if extra is not None:
        tags[338] = (3, list(extra))
    if orientation is not None:
        tags[274] = (3, [orientation])
    if tile:
        tags[322], tags[323] = (3, [tile[0]]), (3, [tile[1]])
        offk, cntk = 324, 325
    else:
        tags[278] = (4, [rows_per_strip or h])
        offk, cntk = 273, 279
    data = bytearray((b"II*\0" if bo == "II" else b"MM\0*") + b"\0\0\0\0")
    offsets = []
    for b in blocks:
        offsets.append(len(data))
        data += b + b"\0" * (len(b) % 2)
    tags[offk], tags[cntk] = (4, offsets), (4, [len(b) for b in blocks])
    packed = {}
    for k, (t, vals) in sorted(tags.items()):
        raw = struct.pack(e + ("H" if t == 3 else "I") * len(vals), *map(int, vals))
        if len(raw) > 4:
            packed[k] = struct.pack(e + "I", len(data))
            data += raw + b"\0" * (len(raw) % 2)
        else:
            packed[k] = raw.ljust(4, b"\0")
    data[4:8] = struct.pack(e + "I", len(data))
    data += struct.pack(e + "H", len(tags))
    for k, (t, vals) in sorted(tags.items()):
        data += struct.pack(e + "HHI", k, t, len(vals)) + packed[k]
    return bytes(data + struct.pack(e + "I", 0))


def exif(orientation, bo="II"):
    e = "<" if bo == "II" else ">"
    return (bo.encode() + struct.pack(e + "HI", 42, 8) + struct.pack(e + "H", 1)
            + struct.pack(e + "HHIHH", 0x112, 3, 1, orientation, 0) + struct.pack(e + "I", 0))


def smooth(h, w, seed=0):
    """Gradients and a sine (compress like photographs) with a noisy band."""
    y, x = np.mgrid[:h, :w]
    a = np.stack([(x * 7 + y * 3) % 256, (x * y) % 256,
                  128 + 100 * np.sin(x / 5.0 + y / 7.0)], -1).astype(np.uint8)
    a[h // 3:h // 2] = np.random.default_rng(seed).integers(0, 256, a[h // 3:h // 2].shape)
    return a


# --- PNG -------------------------------------------------------------------

@pytest.mark.parametrize("ctype,depth", [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8),
                                         (2, 16), (3, 1), (3, 2), (3, 4), (3, 8), (4, 8),
                                         (4, 16), (6, 8), (6, 16)])
def test_png_every_depth_interlace_and_trns(tmp_path, ctype, depth):
    """Every colour type and bit depth, plain and Adam7-interlaced, with and
    without tRNS, in the three modes, at 37x53, 1x1, 3x9 and 9x2."""
    rng = np.random.default_rng(ctype * 100 + depth)
    for interlace in (0, 1):
        for trns in (False, True):
            if trns and ctype in (4, 6):
                continue
            for h, w in ((H, W), (1, 1), (3, 9), (9, 2)):
                pal = tr = None
                if ctype == 3:
                    pal = rng.integers(0, 256, (2 ** depth if depth < 8 else 200, 3))
                    px = rng.integers(0, len(pal), (h, w))
                    tr = bytes(rng.integers(0, 256, max(len(pal) // 2, 1)).astype(np.uint8)) \
                        if trns else None
                else:
                    px = rng.integers(0, 2 ** depth, (h, w, _PNG_CH[ctype]) if depth >= 8
                                      else (h, w))
                    if trns:
                        key = px.reshape(h, w, -1)[0, 0]
                        tr = struct.pack(">" + "H" * len(key), *map(int, key))
                path = write(tmp_path / "x.png", make_png(px, ctype, depth, palette=pal,
                                                          trns=tr, interlace=interlace))
                assert_reads_like_cv2(path)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_png_and_jpeg(tmp_path, orientation):
    """PIL-written PNG and JPEG with EXIF Orientation 1-8 (colour and grey):
    turned in "color" and "gray" as cv2 turns them, never in "unchanged";
    an eXIf chunk after the image data and big-endian EXIF count too.  The
    PNG case fails on the reader before this port (it ignored eXIf)."""
    a = smooth(29, 41)
    ex = Image.Exif()
    ex[0x0112] = orientation
    for arr in (a, a[..., 0]):
        for fmt, kw in (("png", {}), ("jpg", {"quality": 90})):
            path = str(tmp_path / f"o.{fmt}")
            Image.fromarray(arr).save(path, exif=ex, **kw)
            assert_reads_like_cv2(path)
    png = make_png(a, 2, 8)
    end = png.index(b"IEND") - 4
    late = write(tmp_path / "late.png", png[:end] + _chunk(b"eXIf", exif(orientation, "MM"))
                 + png[end:])
    assert_reads_like_cv2(late)
    if orientation == 6:
        assert read_image(late, "color").shape == (41, 29, 3)


# --- BMP -------------------------------------------------------------------

@pytest.mark.parametrize("header", [40, 56, 108, 124])
def test_bmp_headers_depths_and_bitfields(tmp_path, header):
    """24-bit, 32-bit BI_RGB and BI_BITFIELDS (8-, 5-, 6- and 10-bit masks,
    with and without alpha), 1/4/8-bit colour and grey palettes with a
    full or short colour table, bottom-up and top-down rows."""
    rng = np.random.default_rng(header)
    for h, w in ((H, W), (1, 1), (4, 3)):
        for top_down in (False, True):
            kw = {"header": header, "top_down": top_down}
            assert_reads_like_cv2(write(tmp_path / "a.bmp",
                                        make_bmp(rng.integers(0, 256, (h, w, 3)), 24, **kw)))
            assert_reads_like_cv2(write(tmp_path / "a.bmp",
                                        make_bmp(rng.integers(0, 256, (h, w, 4)), 32, **kw)))
            packed = rng.integers(0, 2 ** 32, (h, w), dtype=np.uint64)
            for masks in ((0xFF0000, 0xFF00, 0xFF, 0xFF000000), (0xFF0000, 0xFF00, 0xFF, 0),
                          (0xFF, 0xFF00, 0xFF0000, 0xFF000000), (0xF800, 0x7E0, 0x1F, 0),
                          (0x7C00, 0x3E0, 0x1F, 0x8000), (0x3FF00000, 0xFFC00, 0x3FF, 0)):
                assert_reads_like_cv2(write(tmp_path / "a.bmp", make_bmp(
                    packed, 32, compression=3, masks=masks, **kw)))
            for bpp in (1, 4, 8):
                for grey in (False, True):
                    for short in (False, True):
                        n = min(2, 2 ** bpp) if short else 2 ** bpp
                        pal = (np.repeat(rng.integers(0, 256, (n, 1)), 3, 1) if grey
                               else rng.integers(0, 256, (n, 3)))
                        idx = rng.integers(0, 2 ** bpp, (h, w))
                        assert_reads_like_cv2(write(tmp_path / "a.bmp", make_bmp(
                            idx, bpp, palette=pal, clrused=n if short else 0, **kw)))


def test_bmp_written_by_cv2_and_pil(tmp_path):
    a = smooth(H, W)
    cv2.imwrite(str(tmp_path / "c.bmp"), a)
    cv2.imwrite(str(tmp_path / "g.bmp"), a[..., 0])
    Image.fromarray(a).convert("P").save(tmp_path / "p.bmp")
    Image.fromarray(a[..., 0] > 128).save(tmp_path / "b.bmp")
    for f in ("c.bmp", "g.bmp", "p.bmp", "b.bmp"):
        assert_reads_like_cv2(str(tmp_path / f))


# --- TIFF ------------------------------------------------------------------

def _tiff_cases(rng, h, w):
    """(name, make_tiff args, predictor allowed) of every photometric kind."""
    yield "rgb8", (rng.integers(0, 256, (h, w, 3)), 2), {}, True
    yield "rgb16", (rng.integers(0, 65536, (h, w, 3)), 2), {"bits": 16}, True
    yield "grey8", (rng.integers(0, 256, (h, w)), 1), {}, True
    yield "grey16", (rng.integers(0, 65536, (h, w)), 1), {"bits": 16}, True
    for ex in (0, 1, 2):
        yield f"rgba_extra{ex}", (rng.integers(0, 256, (h, w, 4)), 2), {"extra": [ex]}, True
    yield "bilevel_black0", (rng.integers(0, 2, (h, w)), 1), {"bits": 1}, False
    yield "bilevel_white0", (rng.integers(0, 2, (h, w)), 0), {"bits": 1}, False
    yield "miniswhite8", (rng.integers(0, 256, (h, w)), 0), {}, False
    yield "miniswhite16", (rng.integers(0, 65536, (h, w)), 0), {"bits": 16}, False
    for b in (1, 2, 4, 8):
        pal = rng.integers(0, 256, (2 ** b, 3)) * (257 if b != 4 else 1)
        yield f"palette{b}", (rng.integers(0, 2 ** b, (h, w)), 3), \
            {"bits": b, "colormap": pal}, False


@pytest.mark.parametrize("compression", [1, 5, 8, 32773])
@pytest.mark.parametrize("layout", ["strips", "tiles"])
def test_tiff_codecs_layouts_and_kinds(tmp_path, compression, layout):
    """Every photometric kind and depth under one codec and one layout (strips
    of 5 rows, or 16x16 tiles padded at the edges), in both byte orders,
    with predictor 2 where the kind has 8 or 16 bits (libtiff applies it
    for LZW and deflate only), at 37x53 and 17x3.  Grey of 2 bits and
    2-bit palettes, which cv2 does not read, raise FileNotFoundError."""
    rng = np.random.default_rng(compression + len(layout))
    lay = {"rows_per_strip": 5} if layout == "strips" else {"tile": (16, 16)}
    for h, w in ((H, W), (17, 3)):
        for bo in ("II", "MM"):
            for name, args, kw, pred in _tiff_cases(rng, h, w):
                for predictor in ((1, 2) if pred else (1,)):
                    path = write(tmp_path / "t.tif", make_tiff(
                        *args, compression=compression, predictor=predictor, bo=bo,
                        **kw, **lay))
                    assert_reads_like_cv2(path)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_tiff_orientation(tmp_path, orientation):
    """Orientation 2-4 mirror and flip in every mode (a tiled image read
    through libtiff's RGBA reader tile by tile); 5-8 make cv2's read fail,
    so the port raises FileNotFoundError; PIL-written files too."""
    rng = np.random.default_rng(orientation)
    for kw in ({}, {"tile": (16, 16), "compression": 8, "predictor": 2}, {"bits": 16},
               {"bits": 16, "tile": (16, 16)}, {"rows_per_strip": 4}):
        px = rng.integers(0, 65536 if kw.get("bits") == 16 else 256, (H, W, 3))
        assert_reads_like_cv2(write(tmp_path / "o.tif",
                                    make_tiff(px, 2, orientation=orientation, **kw)))
        assert_reads_like_cv2(write(tmp_path / "g.tif",
                                    make_tiff(px[..., 0], 1, orientation=orientation, **kw)))
    ex = Image.Exif()
    ex[0x0112] = orientation
    Image.fromarray(smooth(H, W)).save(tmp_path / "p.tif", exif=ex)
    assert_reads_like_cv2(str(tmp_path / "p.tif"))


def test_tiff_written_by_cv2_and_pil(tmp_path):
    """cv2's LZW / deflate / PackBits with and without predictor (8 and 16
    bits, 1 and 3 channels) and PIL's codecs and modes; a grey-mode sweep of
    64k colours holds cv2's fixed-point BGR->grey (which is not
    cv2.cvtColor's)."""
    a = smooth(H, W)
    for img in (a, a[..., 0], a.astype(np.uint16) * 257 + 3, a[..., 0].astype(np.uint16) * 99):
        for comp, pred in ((cv2.IMWRITE_TIFF_COMPRESSION_LZW, 2),
                           (cv2.IMWRITE_TIFF_COMPRESSION_ADOBE_DEFLATE, 2),
                           (cv2.IMWRITE_TIFF_COMPRESSION_PACKBITS, 1),
                           (cv2.IMWRITE_TIFF_COMPRESSION_NONE, 1)):
            cv2.imwrite(str(tmp_path / "c.tif"), img, [cv2.IMWRITE_TIFF_COMPRESSION, comp,
                                                       cv2.IMWRITE_TIFF_PREDICTOR, pred])
            assert_reads_like_cv2(str(tmp_path / "c.tif"))
    for mode in ("RGB", "RGBA", "L", "P", "1"):
        for comp in ("tiff_lzw", "packbits", "tiff_adobe_deflate", None):
            Image.fromarray(a).convert(mode).save(tmp_path / "p.tif", compression=comp)
            assert_reads_like_cv2(str(tmp_path / "p.tif"))
    v = np.random.default_rng(0).integers(0, 2 ** 24, (256, 256))
    rgb = np.stack([v >> 16, (v >> 8) & 255, v & 255], -1).astype(np.uint8)
    Image.fromarray(rgb).save(tmp_path / "s.tif")
    np.testing.assert_array_equal(cv2_read(str(tmp_path / "s.tif"), "gray"),
                                  bgr_to_gray(rgb[..., ::-1]))
    assert_reads_like_cv2(str(tmp_path / "s.tif"), ("gray",))


# --- JPEG ------------------------------------------------------------------

_SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
             "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
             "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
             "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
             "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}


@pytest.mark.parametrize("sampling", list(_SAMPLING))
@pytest.mark.parametrize("progressive", [0, 1], ids=["baseline", "progressive"])
def test_jpeg_samplings_restarts_and_sizes(tmp_path, sampling, progressive):
    """cv2-written JPEG in every sampling, baseline and progressive, at
    quality 95 and at quality 50 with a restart interval of 3 MCUs, at
    37x53, 17x33, 8x8, 2x3 and 1x1 (fancy and box upsampling, MCU edges)."""
    path = str(tmp_path / "j.jpg")
    for h, w in ((H, W), (17, 33), (8, 8), (2, 3), (1, 1)):
        a = smooth(h, w, seed=h)
        for rst, q in ((0, 95), (3, 50)):
            cv2.imwrite(path, a, [cv2.IMWRITE_JPEG_QUALITY, q,
                                  cv2.IMWRITE_JPEG_SAMPLING_FACTOR, _SAMPLING[sampling],
                                  cv2.IMWRITE_JPEG_PROGRESSIVE, progressive,
                                  cv2.IMWRITE_JPEG_RST_INTERVAL, rst])
            assert_reads_like_cv2(path)


def test_jpeg_grey_pil_tables_and_rgb(tmp_path):
    """Grey JPEG (baseline, progressive); PIL's optimised Huffman tables,
    subsamplings and progressive scans; an RGB-coded JPEG (Adobe transform
    0), whose grey mode is libjpeg's RGB->Y, not the Y plane."""
    a = smooth(45, 61)
    for prog in (0, 1):
        cv2.imwrite(str(tmp_path / "g.jpg"), a[..., 0], [cv2.IMWRITE_JPEG_PROGRESSIVE, prog])
        assert_reads_like_cv2(str(tmp_path / "g.jpg"))
    for sub in (0, 1, 2):
        for opt in (False, True):
            for prog in (False, True):
                Image.fromarray(a).save(tmp_path / "p.jpg", quality=85, subsampling=sub,
                                        optimize=opt, progressive=prog)
                assert_reads_like_cv2(str(tmp_path / "p.jpg"))
    Image.fromarray(a).save(tmp_path / "r.jpg", quality=90, keep_rgb=True)
    assert_reads_like_cv2(str(tmp_path / "r.jpg"))


def test_content_not_extension_picks_the_codec(tmp_path):
    """cv2 sniffs content: a JPEG named .png, a PNG named .tif and a BMP
    named .jpg read as what they are."""
    a = smooth(H, W)
    ok, jpg = cv2.imencode(".jpg", a)
    ok, png = cv2.imencode(".png", a)
    ok, bmp = cv2.imencode(".bmp", a)
    for name, data in (("j.png", jpg), ("p.tif", png), ("b.jpg", bmp)):
        assert_reads_like_cv2(write(tmp_path / name, data.tobytes()))


def test_unreadable_and_queued_variants_raise(tmp_path):
    """What cv2 cannot read raises FileNotFoundError (as kgtpu's readers
    do); what cv2 reads and the port does not yet raises UnsupportedImage
    naming the ROADMAP item: arithmetic-coded, 12-bit and CMYK JPEG, RLE
    and 16-bit BMP, TIFF with JPEG compression."""
    text = write(tmp_path / "notes.png", b"not an image\n")
    assert cv2.imread(text) is None
    with pytest.raises(FileNotFoundError):
        read_image(text)
    with pytest.raises(UnreadableImage):
        read_image(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        read_image(str(tmp_path / "missing.jpg"))
    ok, jpg = cv2.imencode(".jpg", smooth(16, 16))
    jpg = bytearray(jpg.tobytes())
    at = jpg.index(b"\xff\xc0")
    arith = bytes(jpg[:at + 1]) + b"\xc9" + bytes(jpg[at + 2:])
    twelve = bytearray(jpg)
    twelve[at + 4] = 12
    Image.fromarray(smooth(16, 16)).convert("CMYK").save(tmp_path / "cmyk.jpg")
    idx = np.random.default_rng(0).integers(0, 256, (8, 8))
    rle = make_bmp(idx, 8, palette=np.zeros((256, 3)), compression=1)
    b16 = bytearray(make_bmp(np.zeros((4, 4, 3)), 24))
    b16[28:30] = struct.pack("<H", 16)
    tjpeg = make_tiff(np.zeros((8, 8, 3)), 2, compression=7)
    for name, data in (("a.jpg", arith), ("t.jpg", bytes(twelve)), ("r.bmp", rle),
                       ("s.bmp", bytes(b16)), ("j.tif", tjpeg)):
        with pytest.raises(UnsupportedImage, match=QUEUED):
            read_image(write(tmp_path / name, data))
    with pytest.raises(UnsupportedImage, match=QUEUED):
        read_image(str(tmp_path / "cmyk.jpg"))


# --- fill_poly and the nearest resize --------------------------------------

def test_fill_poly_matches_cv2():
    """cv2.fillPoly(LINE_8, shift 0) on 600 random polygons inside the
    image: non-convex and self-crossing rings of 3-14 points, one to three
    rings per call (overlapping rings filled even-odd, as cv2 fills them),
    and degenerate rings (1-2 points, horizontal runs)."""
    rng = np.random.default_rng(0)
    for trial in range(600):
        h, w = (int(v) for v in rng.integers(5, 70, 2))
        rings = [np.stack([rng.integers(0, w, n), rng.integers(0, h, n)], -1).astype(np.int32)
                 for n in rng.integers(1, 15, int(rng.integers(1, 4)))]
        if trial % 10 == 0:
            rings.append(np.array([[1, 2], [w - 2, 2], [w // 2, 2]], np.int32))
        want = np.zeros((h, w), np.uint8)
        cv2.fillPoly(want, rings, 1)
        got = np.zeros((h, w), np.uint8)
        draw.fill_poly(got, rings, 1)
        np.testing.assert_array_equal(got, want, err_msg=str([r.tolist() for r in rings]))


def test_resize_nearest_sweep_matches_cv2():
    """cv2.resize(INTER_NEAREST) on 400 size pairs, up and down, square and
    not (each destination pixel's source read off a coordinate-coded map),
    and on kgtpu's uint8 masks."""
    rng = np.random.default_rng(1)
    pairs = [(512, 512, 517, 517), (480, 640, 512, 512), (10, 3, 7, 100), (3, 700, 700, 3)]
    pairs += [tuple(int(v) for v in p) for p in rng.integers(1, 600, (400, 4))]
    for sh, sw, dh, dw in pairs:
        src = np.arange(sh * sw, dtype=np.int32).reshape(sh, sw)
        np.testing.assert_array_equal(resize_nearest(src, (dw, dh)),
                                      cv2.resize(src, (dw, dh), interpolation=cv2.INTER_NEAREST))
        m = (src % 3 == 0).astype(np.uint8)
        np.testing.assert_array_equal(resize_nearest(m, (dw, dh)),
                                      cv2.resize(m, (dw, dh), interpolation=cv2.INTER_NEAREST))
