"""TIFF decoding without cv2: NumPy, zlib and struct only.  Returns what
cv2 5.0 (through libtiff 4.7) returns in the read modes of `data/imread.py`.

Reads the first IFD (as cv2 does), in II or MM byte order, stored in strips
or tiles (edge tiles padded), with the samples of a pixel together
(PlanarConfiguration 1) or one plane after another (2).  Codecs: 1 (none),
5 (LZW: MSB-first codes with TIFF's early code-width change, and the
old-style LSB-first codes of libtiff's compat decoder, `tif_lzw.c`), 8 and
32946 (deflate), 32773 (PackBits), 7 (JPEG, `tif_jpeg.c`, through
`data/jpeg.py`) and 2, 3 and 4 (CCITT, `data/ccitt.py`); Predictor 2
(horizontal differencing at 8, 16 and 32 bits) and 3 (`tif_predict.c`'s
floating-point byte planes).  Photometric kinds, as libtiff's RGBA reader
(`tif_getimage.c`) turns them into 8-bit RGBA, which cv2's "color" and
"gray" modes, and its "unchanged" mode at 8 bits, read:

  * MinIsBlack / MinIsWhite of 1, 8 or 16 bits, with or without an alpha
    sample (which no mode returns: cv2 reads grey + alpha as one channel);
  * RGB of 8 or 16 bits, with alpha (RGBA) or without;
  * Palette indices of 1, 4 or 8 bits;
  * YCbCr of 8 bits at the subsamplings 1x1, 2x1, 2x2, 4x1, 4x2 and 1x2
    (4x4 raises `UnsupportedImage`, see `_ycbcr_subsampled`), through `TIFFYCbCrToRGB`'s fixed-point
    tables and ReferenceBlackWhite (`data/tiff_color.py`);
  * Separated (CMYK, InkSet 1) of 8 bits: putRGBcontig8bitCMYKtile's
    r = (255 - k) (255 - c) / 255, truncated;
  * CIELab of 8 or 16 bits, through libtiff's float steps
    (`data/tiff_color.py`).

cv2's rules, each checked against it:

  * MinIsWhite and bilevel samples invert and widen (1 bit -> 0 / 255); a
    ColorMap whose entries all lie below 256 is taken as 8-bit, any other
    as 16-bit (its high byte); 16-bit samples go through libtiff's 16->8
    table, rint(x / 257), except grey, whose high byte is taken; an
    unassociated alpha (ExtraSamples 2) premultiplies: c * a / 255,
    rounded; four RGB samples without ExtraSamples are associated alpha;
  * separate planes are read by libtiff's separate routines: grey + alpha
    there goes through the RGB routine (premultiplied if unassociated, and
    MinIsWhite not inverted), 16-bit grey through the 16->8 table;
  * "unchanged" keeps cv2's type: 8-bit grey (grey + alpha too, and 16-bit
    grey + alpha), RGB, RGBA, palette (as RGB, but a 1-bit palette as its
    grey), YCbCr and CIELab as RGB, and CMYK as RGBA with alpha 255, all
    from the RGBA reader, SampleFormat 2 at 8 bits as int8; 16-bit grey,
    RGB and RGBA, and 32-bit and 64-bit samples, as stored (uint16 /
    int16, uint32 / int32 / float32, float64; MinIsWhite not inverted,
    alpha not premultiplied);
  * "color" and "gray" of 32- and 64-bit or float samples fail, as do
    16-bit float, 16-bit CMYK and 64-bit integers in every mode;
  * in a tile cut by the right edge the grey readers of 16-bit samples,
    and of 8-bit samples with alpha, step each row by (bytes a pixel *
    width inside + tile width - width inside) bytes instead of bytes a
    pixel * tile width (libtiff's `put16bitbwtile` and `putagreytile` add
    the skew in pixels to a byte pointer), and cv2 returns what they read
    there (`_skewed_gray`);
  * "gray" of colour is cv2's fixed-point BGR->grey (`bmp.bgr_to_gray`) on
    the 8-bit colour above; that is not `cv2.cvtColor`, which differs on
    43,864 of the 2^24 colours;
  * Predictor 2 and 3 apply only with LZW and deflate (libtiff ignores them
    for the other codecs);
  * Orientation 2, 3 and 4 mirror and flip the image in every mode (a
    tiled image read through the RGBA reader is mirrored tile by tile,
    each tile where it stands), and orientations 5-8 make cv2's read fail
    (`UnreadableImage`).

cv2 cannot read, so `UnreadableImage` (each case held against cv2 in
`tests/test_torch_format_variants.py`): grey of 2 or 4 bits and 2-bit
palettes; codecs its libtiff was built without (old-style JPEG 6,
PixarLog, LZMA, ZSTD, WebP, LERC, JBIG), so also ThunderScan and NeXT
images, whose 4- and 2-bit grey cv2 does not read; BitsPerSample that
differs between samples; bit depths other than 1, 2, 4, 8, 16, 32 and 64
(10, 12 and 14 bits of grey or RGB in "color" and "gray" only: cv2 reads
them in "unchanged"); with LZW or deflate, a Predictor other than 1, 2
and 3, Predictor 2 below 8 bits and Predictor 3 on integer samples (the
other codecs ignore the tag, as libtiff does); photometric kinds the RGBA
reader does not know (4, 9, 10, 32844, ...); grey of other than 1, 8 or
16 bits; RGB of fewer than three colour samples, more than four samples or
other than 8 or 16 bits; 16-bit palettes with a ColorMap; CMYK of other
than four samples or InkSet 1; YCbCr of other than three 8-bit samples,
or subsampled other than 1x1, 2x1, 2x2, 4x1, 4x2, 1x2 and 4x4, or
subsampled in separate planes; CIELab of other than three samples of 8 or
16 bits.  Raised as `UnsupportedImage`, because cv2 reads them: CCITT
RLEW (32771, see `data/ccitt.py`), ThunderScan and NeXT of a kind cv2
reads, SGILog, codes libtiff does not know (cv2 returns black for them),
10-, 12- and 14-bit grey and RGB in "unchanged", grey of more than two
samples, palettes without a ColorMap or with an extra sample, JPEG in
separate planes, 4x4 YCbCr, and 16- to 64-bit samples in separate planes
in "unchanged" (cv2 reads the first plane's blocks as if they were
contiguous and leaves the rest of its buffer as it was, so its result is
not defined).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from kgtpu_torch.data.bmp import bgr_to_gray
from kgtpu_torch.data.imread import UnreadableImage, unsupported

_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h", 9: "i", 10: "ii",
          11: "f", 12: "d", 16: "Q"}
_DEFAULTS = {258: [1], 259: [1], 262: [None], 274: [1], 277: [1], 284: [1], 317: [1],
             338: [], 339: [1], 332: [1], 530: [2, 2]}
NOT_CONFIGURED = {6: "old-style JPEG", 32909: "PixarLog", 34925: "LZMA", 50000: "ZSTD",
                  50001: "WebP", 34887: "LERC", 34661: "JBIG"}
CCITT = (2, 3, 4)
PREDICTED = (5, 8, 32946)


def _ifd(data: bytes) -> tuple[dict, str]:
    """The tags of the first IFD: {tag: [values]} (a RATIONAL as floats),
    and the byte order."""
    e = "<" if data[:2] == b"II" else ">"
    (at,) = struct.unpack(e + "I", data[4:8])
    if at + 2 > len(data):
        raise UnreadableImage("TIFF IFD offset past the end of the file")
    (n,) = struct.unpack(e + "H", data[at:at + 2])
    tags = {}
    for k in range(n):
        ent = data[at + 2 + 12 * k: at + 14 + 12 * k]
        if len(ent) < 12:
            raise UnreadableImage("TIFF IFD is truncated")
        tag, typ, count = struct.unpack(e + "HHI", ent[:8])
        if typ not in _TYPES:
            continue
        size = struct.calcsize(_TYPES[typ]) * count
        if size <= 4:
            raw = ent[8:8 + size]
        else:
            (off,) = struct.unpack(e + "I", ent[8:12])
            raw = data[off:off + size]
            if len(raw) < size:
                raise UnreadableImage(f"TIFF tag {tag} runs past the end of the file")
        vals = list(struct.unpack(e + _TYPES[typ] * count, raw))
        if typ in (5, 10):
            vals = [float(np.float32(a / b)) if b else 0.0
                    for a, b in zip(vals[0::2], vals[1::2])]
        tags[tag] = vals if typ != 7 or tag != 347 else bytes(raw)
    return tags, e


def lzw_decode(src: bytes, expected: int) -> bytes:
    """TIFF LZW: 9- to 12-bit codes, 256 clears the table and 257 ends the
    data.  New-style codes come most significant bit first and the code
    width grows one code early (at 511, 1023 and 2047 entries); data that
    starts 0x00 0x01 is old-style (`tif_lzw.c`'s LZWDecodeCompat): least
    significant bit first, the width growing at 512, 1024 and 2048.
    Stops after `expected` bytes."""
    compat = len(src) > 1 and src[0] == 0 and bool(src[1] & 1)
    early = 0 if compat else 1
    out = bytearray()
    table: list[bytes] = [bytes([i]) for i in range(256)] + [b"", b""]
    width, acc, nbits, prev = 9, 0, 0, None
    for byte in src:
        if compat:
            acc |= byte << nbits
        else:
            acc = (acc << 8) | byte
        nbits += 8
        if nbits < width:
            continue
        nbits -= width
        if compat:
            code = acc & ((1 << width) - 1)
            acc >>= width
        else:
            code = (acc >> nbits) & ((1 << width) - 1)
            acc &= (1 << nbits) - 1
        if code == 256:
            del table[258:]
            width, prev = 9, None
            continue
        if code == 257:
            break
        if prev is None:
            entry = table[code]
        else:
            if code < len(table):
                entry = table[code]
                table.append(prev + entry[:1])
            elif code == len(table):
                entry = prev + prev[:1]
                table.append(entry)
            else:
                raise UnreadableImage("corrupt TIFF LZW data")
            if len(table) >= (1 << width) - early and width < 12:
                width += 1
        out += entry
        prev = entry
        if len(out) >= expected:
            break
    return bytes(out)


def packbits_decode(src: bytes, expected: int) -> bytes:
    out = bytearray()
    i, n = 0, len(src)
    while i < n and len(out) < expected:
        c = src[i]
        i += 1
        if c < 128:
            out += src[i:i + c + 1]
            i += c + 1
        elif c > 128:
            out += src[i:i + 1] * (257 - c)
            i += 1
    return bytes(out)


def _decompress(block: bytes, comp: int, expected: int) -> bytes:
    if comp == 1:
        return block
    if comp == 5:
        return lzw_decode(block, expected)
    if comp in (8, 32946):
        try:
            return zlib.decompressobj().decompress(block, expected)
        except zlib.error as e:
            raise UnreadableImage(f"corrupt TIFF deflate data: {e}") from None
    if comp == 32773:
        return packbits_decode(block, expected)
    raise unsupported(f"TIFF compression {comp}")


def _dtype(bits: int, fmt: int, e: str) -> np.dtype:
    kind = {1: "u", 2: "i", 3: "f"}.get(fmt, "u")
    return np.dtype(f"{e}{kind}{bits // 8}") if bits > 8 else np.dtype(kind + "1")


def _samples(raw: bytes, rows: int, cols: int, spp: int, bits: int, e: str, fmt: int,
             predictor: int) -> np.ndarray:
    """Decoded bytes of one strip or tile -> [rows, cols, spp] samples in
    native byte order (8-bit and lower as uint8)."""
    rowbytes = (cols * spp * bits + 7) // 8
    buf = np.frombuffer(raw, np.uint8)
    if buf.size < rows * rowbytes:          # libtiff zero-fills a short block
        buf = np.concatenate([buf, np.zeros(rows * rowbytes - buf.size, np.uint8)])
    buf = buf[:rows * rowbytes].reshape(rows, rowbytes)
    if bits < 8:
        per = 8 // bits
        shifts = (bits * np.arange(per - 1, -1, -1)).astype(np.uint8)
        v = ((buf[:, :, None] >> shifts) & ((1 << bits) - 1)).reshape(rows, -1)
        return v[:, :cols * spp].reshape(rows, cols, spp)
    if predictor == 3:               # byte planes, most significant first, differenced
        nb = bits // 8
        acc = buf.reshape(rows, -1, spp).cumsum(axis=1, dtype=np.uint8).reshape(rows, nb, -1)
        be = np.ascontiguousarray(acc.transpose(0, 2, 1)).reshape(rows, -1)
        return be.view(_dtype(bits, fmt, ">")).reshape(rows, cols, spp).astype(
            _dtype(bits, fmt, "="))
    dt = _dtype(bits, fmt, e)
    v = buf.view(dt).reshape(rows, cols, spp).astype(dt.newbyteorder("="))
    if predictor == 2:
        u = v.view(f"u{max(bits // 8, 1)}")
        v = np.cumsum(u, axis=1, dtype=u.dtype).view(v.dtype)
    return v


class _Dir:
    """The fields of the first IFD that the reader uses, with libtiff's
    defaults."""

    def __init__(self, data: bytes):
        tags, e = _ifd(data)
        self.tags, self.e = tags, e
        get = lambda t: tags.get(t, _DEFAULTS.get(t, [None]))  # noqa: E731
        self.get = get
        if 256 not in tags or 257 not in tags:
            raise UnreadableImage("TIFF without ImageWidth / ImageLength")
        self.w, self.h = get(256)[0], get(257)[0]
        self.spp, self.comp = get(277)[0], get(259)[0]
        bits = get(258)
        if len(set(bits)) != 1:
            raise UnreadableImage(f"TIFF with mixed bit depths {bits} (cv2 cannot read it)")
        self.bits = bits[0]
        self.photo, self.planar, self.predictor = get(262)[0], get(284)[0], get(317)[0]
        self.extra, self.fmt, self.orientation = get(338), get(339)[0], get(274)[0]
        if self.photo is None:
            self.photo = 1 if self.spp - len(self.extra) == 1 else 2
        self.tiled = 322 in tags
        if self.tiled:
            self.tw, self.th = get(322)[0], get(323)[0]
            self.offsets, self.counts = get(324), get(325)
        else:
            self.tw = self.w
            self.th = min(get(278)[0] if 278 in tags else self.h, self.h)
            self.offsets, self.counts = get(273), get(279)
        self.grid = [(y, x) for y in range(0, self.h, self.th) for x in range(0, self.w, self.tw)]
        nplanes = self.spp if self.planar == 2 else 1
        need = len(self.grid) * nplanes
        if None in (self.offsets[0], self.counts[0]) or min(len(self.offsets),
                                                            len(self.counts)) < need:
            raise UnreadableImage("TIFF strip / tile offsets missing")

    def block(self, data: bytes, k: int, expected: int) -> bytes:
        off, cnt = self.offsets[k], self.counts[k]
        return _decompress(data[off:off + cnt], self.comp, expected)


def _check(d: _Dir, mode: str) -> None:
    """cv2's and libtiff's refusals, in the order they come."""
    if d.photo in (0, 1, 3) and d.spp == 1 and d.bits in (2, 4) and (d.photo, d.bits) != (3, 4):
        raise UnreadableImage(f"{d.bits}-bit grey or palette TIFF (cv2 cannot read it)")
    if d.comp in NOT_CONFIGURED:
        raise UnreadableImage(f"TIFF compression {d.comp} ({NOT_CONFIGURED[d.comp]}): "
                              "cv2 cannot read it")
    if d.comp not in (1, 5, 7, 8, 32946, 32773) + CCITT:
        raise unsupported(f"TIFF compression {d.comp}")
    if d.orientation in (5, 6, 7, 8):
        raise UnreadableImage(f"TIFF Orientation {d.orientation} (cv2 cannot read it)")
    if d.bits not in (1, 2, 4, 8, 16, 32, 64):
        if d.bits in (10, 12, 14) and d.photo in (0, 1, 2) and mode == "unchanged":
            raise unsupported(f"{d.bits}-bit TIFF in unchanged mode")
        raise UnreadableImage(f"{d.bits}-bit TIFF in {mode} mode (cv2 cannot read it)")
    if d.fmt == 3 and d.bits < 32:
        raise UnreadableImage(f"TIFF of {d.bits}-bit sample format {d.fmt} (cv2 cannot read it)")
    if d.bits >= 32 and mode != "unchanged":
        raise UnreadableImage(f"TIFF of {d.bits}-bit samples in {mode} mode (cv2 cannot "
                              "read it)")
    if d.photo == 5 and d.bits != 8:
        raise UnreadableImage(f"{d.bits}-bit CMYK TIFF (cv2 cannot read it)")
    if d.comp in PREDICTED and (d.predictor not in (1, 2, 3) or (
            d.predictor == 2 and d.bits < 8) or (d.predictor == 3 and d.fmt != 3)):
        raise UnreadableImage(f"TIFF predictor {d.predictor} at {d.bits} bits of sample "
                              f"format {d.fmt} (cv2 cannot read it)")


def _kind(d: _Dir) -> str:
    """The RGBA reader's routine for this image, or raise as libtiff does."""
    colors = d.spp - len(d.extra)
    ok = {0: "gray", 1: "gray", 2: "rgb", 3: "palette", 5: "cmyk", 6: "ycbcr", 8: "lab"}
    kind = ok.get(d.photo)
    if kind is None:
        raise UnreadableImage(f"TIFF photometric {d.photo} (cv2 cannot read it)")
    if kind == "gray" and d.spp > 2 and d.bits in (8, 16):
        raise unsupported(f"TIFF grey of {d.spp} samples of {d.bits} bits")
    if (kind == "gray" and (d.bits not in (1, 8, 16) or d.spp > 2)
            or kind == "rgb" and (colors < 3 or d.bits not in (8, 16) or d.spp > 4)
            or kind == "palette" and d.bits == 16 and 320 in d.tags
            or kind == "cmyk" and (d.spp != 4 or d.get(332)[0] != 1)
            or kind == "ycbcr" and (d.bits != 8 or d.spp != 3)
            or kind == "lab" and (d.spp != 3 or d.bits not in (8, 16))):
        raise UnreadableImage(f"TIFF {kind} of {d.spp} samples of {d.bits} bits (cv2 "
                              "cannot read it)")
    if kind == "palette" and (d.bits not in (1, 4, 8) or d.spp != 1 or 320 not in d.tags):
        raise unsupported(f"TIFF palette of {d.spp} samples of {d.bits} bits")
    return kind


def _out_type(d: _Dir, kind: str) -> tuple[int, np.dtype | None]:
    """cv2's channels and dtype in "unchanged" (dtype None: read through
    the RGBA reader as uint8)."""
    gray = d.photo in (0, 1)
    if d.bits == 1:
        return 1, None
    if d.bits in (4, 8):
        ch = 3 if kind == "palette" else 1 if gray else min(d.spp, 4)
        return ch, np.dtype(np.int8) if d.fmt == 2 else None
    if kind == "lab":
        return 3, None
    if d.bits == 16 and not (gray and d.spp == 2):
        return (1 if gray else d.spp), _dtype(16, d.fmt, "=")
    if d.bits == 16:
        return 1, None
    return (1 if gray else d.spp), _dtype(d.bits, d.fmt, "=")


def decode_tiff(data: bytes, mode: str) -> np.ndarray:
    """The bytes of a TIFF file as one of `imread.MODES`, in RGB(A) order."""
    d = _Dir(data)
    _check(d, mode)
    jpeg_px = None
    if d.comp == 7:
        from kgtpu_torch.data.tiff_jpeg import read_jpeg_tiff
        jpeg_px = read_jpeg_tiff(d, data)
    kind = _kind(d) if d.bits <= 16 else "direct"
    ch, dtype = _out_type(d, kind)
    direct = mode == "unchanged" and dtype is not None and dtype.itemsize > 1
    if direct and d.planar == 2 and d.spp > 1:
        raise unsupported(f"{d.bits}-bit TIFF in separate planes in unchanged mode (cv2 "
                          "reads its first plane's blocks as if contiguous, and what it "
                          "returns beyond them is not defined)")
    if jpeg_px is not None:
        px = jpeg_px
    elif kind == "ycbcr" and d.planar == 1 and tuple(d.get(530)) != (1, 1):
        px = _ycbcr_subsampled(d, data)
    else:
        px = _read_samples(d, data, skewed=kind == "gray" and d.planar == 1 and not direct
                           and (d.bits == 16 or d.bits == 8 and d.spp > 1))
    px = _orient(d, px, rgba_reader=not direct)
    if direct:
        out = px[..., :ch] if ch > 1 else px[..., 0]
        return np.ascontiguousarray(out.astype(dtype))
    rgba = _rgba(d, kind, px)
    if mode == "color":
        return np.ascontiguousarray(rgba[..., :3])
    out = bgr_to_gray(rgba[..., 2::-1]) if mode == "gray" or ch == 1 else \
        np.ascontiguousarray(rgba[..., :ch])
    return out.view(np.int8) if mode == "unchanged" and dtype is not None else out


def _read_samples(d: _Dir, data: bytes, skewed: bool) -> np.ndarray:
    """Every strip or tile decoded into [h, w, spp] samples.  `skewed`:
    16-bit grey read as put16bitbwtile reads it (high bytes, skewed rows in
    tiles cut by the right edge), as uint16 << 8."""
    nplanes = d.spp if d.planar == 2 else 1
    per_block = d.spp // nplanes
    dt = _dtype(max(d.bits, 8), d.fmt, "=")
    px = np.zeros((d.h, d.w, d.spp), np.uint8 if d.bits <= 8 else dt)
    for p in range(nplanes):
        for k, (y, x) in enumerate(d.grid):
            rows = d.th if d.tiled else min(d.th, d.h - y)
            if d.comp in CCITT:
                from kgtpu_torch.data.ccitt import decode_ccitt
                off, cnt = d.offsets[k], d.counts[k]
                block = decode_ccitt(data[off:off + cnt], d, rows, d.tw)[..., None]
            else:
                expected = rows * ((d.tw * per_block * d.bits + 7) // 8)
                raw = d.block(data, p * len(d.grid) + k, expected)
                pred = d.predictor if d.comp in PREDICTED else 1
                block = _samples(raw, rows, d.tw, per_block, d.bits, d.e, d.fmt, pred)
            if skewed:                       # one byte a sample is read
                inside = min(d.tw, d.w - x)
                v = _skewed_gray(block, inside, d.tw).astype(px.dtype) << (8 * (d.bits == 16))
                px[y:y + d.th, x:x + inside, 0] = v[:d.h - y]
                continue
            px[y:y + d.th, x:x + d.tw, p * per_block:(p + 1) * per_block] = \
                block[:d.h - y, :d.w - x]
    return px


def _skewed_gray(block: np.ndarray, inside: int, tw: int) -> np.ndarray:
    """The samples libtiff's grey routines (putgreytile, putagreytile,
    put16bitbwtile) take from a [rows, tw, spp] grey block of which `inside`
    columns lie in the image: they step a byte pointer by spp samples a
    pixel but add the row's skew, tw - inside, in pixels, so row r starts
    r * (nb spp inside + tw - inside) bytes into the block (native,
    little-endian order; nb bytes a sample), not r * nb spp tw.  16-bit
    samples give their high byte."""
    rows, _, spp = block.shape
    nb = block.dtype.itemsize
    flat = block.astype(f"<u{nb}").view(np.uint8).reshape(-1)
    step = nb * spp * inside + tw - inside
    starts = np.arange(rows)[:, None] * step + nb * spp * np.arange(inside)[None, :] + nb - 1
    return flat[np.minimum(starts, flat.size - 1)]


def _ycbcr_subsampled(d: _Dir, data: bytes) -> np.ndarray:
    """Contiguous subsampled YCbCr -> [h, w, 3] (Y, Cb, Cr) per pixel, each
    pixel taking its block's Cb and Cr, as putcontig8bitYCbCrXXtile does.
    In a tile cut by the right edge those routines skip (tw - inside) / hs
    blocks after each block row's ceil(inside / hs).  4x4 is refused
    (`UnsupportedImage`): cv2's reads of it through libtiff's 4x4 routine
    come back black or shifted in strips of one block row and in the last
    block row of an image whose height is not a multiple of 8."""
    hs, vs = d.get(530)[:2]
    if hs not in (1, 2, 4) or vs not in (1, 2, 4) or vs > hs and (hs, vs) != (1, 2):
        raise UnreadableImage(f"TIFF YCbCr subsampling {hs}x{vs} (cv2 cannot read it)")
    if (hs, vs) == (4, 4):
        raise unsupported(f"TIFF YCbCr subsampling {hs}x{vs}")
    unit = hs * vs + 2
    px = np.zeros((d.h, d.w, 3), np.uint8)
    for k, (y, x) in enumerate(d.grid):
        rows = d.th if d.tiled else min(d.th, d.h - y)
        brows, bcols = -(-rows // vs), -(-d.tw // hs)
        size = brows * bcols * unit
        raw = np.frombuffer(d.block(data, k, size), np.uint8)
        raw = np.concatenate([raw, np.zeros(max(size - raw.size, 0), np.uint8)])[:size]
        inside, rows_in = min(d.tw, d.w - x), min(rows, d.h - y)
        used = -(-inside // hs)
        step = used * unit + (d.tw - inside) // hs * unit
        starts = np.arange(-(-rows_in // vs))[:, None] * step + np.arange(used)[None, :] * unit
        units = raw[np.minimum(starts[..., None] + np.arange(unit), size - 1)]
        nb = units.shape[0]
        yy = units[..., :hs * vs].reshape(nb, used, vs, hs).transpose(0, 2, 1, 3).reshape(
            nb * vs, used * hs)
        cb = np.repeat(np.repeat(units[..., -2], vs, 0), hs, 1)
        cr = np.repeat(np.repeat(units[..., -1], vs, 0), hs, 1)
        px[y:y + rows_in, x:x + inside] = np.stack([yy, cb, cr], -1)[:rows_in, :inside]
    return px


def _orient(d: _Dir, px: np.ndarray, rgba_reader: bool) -> np.ndarray:
    if d.orientation in (2, 3):          # libtiff's RGBA reader mirrors tile by tile
        cuts = list(range(0, d.w, d.tw)) + [d.w] if d.tiled and rgba_reader else [0, d.w]
        px = np.concatenate([px[:, a:b][:, ::-1] for a, b in zip(cuts[:-1], cuts[1:])], axis=1)
    if d.orientation in (3, 4):
        px = px[::-1]
    return px


def _to8(v: np.ndarray) -> np.ndarray:
    """libtiff's Bitdepth16To8 table: (v * 255 + 32767) / 65535."""
    return ((v.astype(np.uint32) * 255 + 32767) // 65535).astype(np.uint8)


def _premultiply(c: np.ndarray, a: np.ndarray) -> np.ndarray:
    """libtiff's UaToAa table: (c * a + 127) / 255."""
    return ((c.astype(np.uint32) * a.astype(np.uint32) + 127) // 255).astype(np.uint8)


def _rgba(d: _Dir, kind: str, px: np.ndarray) -> np.ndarray:
    """libtiff's RGBA reader's output for the samples `px`: [h, w, 4]."""
    h, w = px.shape[:2]
    px = px.view(f"u{px.dtype.itemsize}")          # signed samples read as unsigned
    alpha = np.full((h, w), 255, np.uint8)
    # libtiff's img->alpha: ExtraSamples 1 or 2, or 0 with more than 3
    # samples, or four RGB samples without ExtraSamples
    a_kind = d.extra[0] if d.extra else 0
    has_alpha = a_kind in (1, 2) or (d.extra and d.spp > 3) or (
        not d.extra and d.spp == 4 and kind == "rgb")
    separate = d.planar == 2 and d.spp > 1
    if kind == "gray" and separate:               # through the RGB routines
        v = _to8(px[..., 0]) if d.bits == 16 else px[..., 0]
        if has_alpha:
            a = _to8(px[..., 1]) if d.bits == 16 else px[..., 1]
            if a_kind == 2:
                v = _premultiply(v, a)
            alpha = a
        rgb = np.repeat(v[..., None], 3, -1)
    elif kind == "gray":
        g = px[..., 0]
        if d.bits == 1:
            g = g * np.uint8(255)
        elif d.bits == 16:
            g = (g >> 8).astype(np.uint8)
        if d.photo == 0:
            g = 255 - g
        if has_alpha and d.bits == 8:
            alpha = px[..., 1]
        rgb = np.repeat(g.astype(np.uint8)[..., None], 3, -1)
    elif kind == "palette":
        cmap = np.asarray(d.tags[320], np.uint32).reshape(3, -1).T
        if cmap.max(initial=0) >= 256:
            cmap = cmap >> 8
        rgb = cmap.astype(np.uint8)[np.minimum(px[..., 0], len(cmap) - 1)]
    elif kind == "rgb":
        c = _to8(px[..., :3]) if d.bits == 16 else px[..., :3]
        if has_alpha:
            alpha = _to8(px[..., 3]) if d.bits == 16 else px[..., 3]
            if a_kind == 2:
                c = _premultiply(c, alpha[..., None])
        rgb = c
    elif kind == "cmyk":
        k = 255 - px[..., 3:4].astype(np.uint32)
        rgb = (k * (255 - px[..., :3].astype(np.uint32)) // 255).astype(np.uint8)
    elif kind == "ycbcr":
        from kgtpu_torch.data.tiff_color import ycbcr_to_rgb
        if separate and tuple(d.get(530)) != (1, 1):
            raise UnreadableImage("TIFF YCbCr in separate planes with subsampling (cv2 "
                                  "cannot read it)")
        rgb = ycbcr_to_rgb(px, d.get(529) if 529 in d.tags else None,
                           d.get(532) if 532 in d.tags else None)
    else:
        from kgtpu_torch.data.tiff_color import lab_to_rgb
        rgb = lab_to_rgb(px, d.bits, d.get(318) if 318 in d.tags else None)
    return np.concatenate([rgb, alpha[..., None]], -1)
