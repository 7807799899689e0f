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
    sample (which no mode returns: cv2 reads grey + alpha as one channel),
    or with more samples (the first read; 16-bit "unchanged" turns three
    into grey with cv2's icvCvt_BGR2Gray_16u);
  * RGB of 8 or 16 bits, with alpha (RGBA) or without;
  * Palette indices of 1, 4 or 8 bits (8 bits with an extra sample too);
    without a ColorMap libtiff reads one sample of 8 or 16 bits as grey;
  * YCbCr of 8 bits at the subsamplings 1x1, 2x1, 2x2, 4x1, 4x2, 1x2 and
    4x4 (with the 4x4 routine's misreads, see `_ycbcr_subsampled`), through
    `TIFFYCbCrToRGB`'s fixed-point tables and ReferenceBlackWhite
    (`data/tiff_color.py`);
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

Also read as cv2 reads them: 10-, 12- and 14-bit grey and RGB(A) in
"unchanged" (big-endian bits widened with << 16 - n, grfmt_tiff.cpp's
_unpackNTo16); codes libtiff does not know (zeros of the file's shape);
CCITT RLEW (`data/ccitt.py`); ThunderScan 4-bit palettes
(`data/tiff_thunder.py`); SGILog LogLuv and LogL (`data/tiff_luv.py`);
JPEG in separate planes (`data/tiff_jpeg.py`).  Damaged files read as
libtiff 4.7 and cv2 leave them: a codec that fails keeps what it decoded
and zeros after (`lzw_decode`, `packbits_decode`, `_inflate`), which the
RGBA reader ("color", "gray", 8-bit "unchanged") reads on and the
strip / tile reads of cv2's other "unchanged" reads refuse; a strip past
the end of the file fails the read; FillOrder 2 reverses the stored bits;
a missing or implausible StripByteCounts of one strip is estimated
(EstimateStripByteCounts); a tag's repeats are ignored.

cv2 cannot read, so `UnreadableImage` (each case held against cv2 in
`tests/test_torch_format_variants.py` and `tests/test_torch_damaged.py`):
a directory libtiff refuses (a bad type or count of the tags it must read,
sizes of 0, 2^20 or more, a PlanarConfiguration other than 1 or 2,
SampleFormats that differ), no PhotometricInterpretation, strips or tiles
over cv2's limits (RowsPerStrip or tile sides over 2^24, a buffer of 1
GiB); grey of 2 or 4 bits and 2-bit palettes; codecs its libtiff was built
without (old-style JPEG 6, PixarLog, LZMA, ZSTD, WebP, LERC, JBIG);
ThunderScan of other than 4 bits and NeXT (libtiff reads it at 2 bits
only); BitsPerSample that differs between samples; bit depths other than
1, 2, 4, 8, 16, 32 and 64 (10, 12 and 14 bits in "color" and "gray"); with
LZW or deflate, a Predictor other than 1, 2 and 3, Predictor 2 below 8
bits and Predictor 3 on integer samples (the other codecs ignore the tag,
as libtiff does); photometric kinds the RGBA reader does not know (4, 9,
10, ...); grey of other than 1, 8 or 16 bits, or of several samples below
8 bits; RGB of fewer than three colour samples, more than four samples or
other than 8 or 16 bits; palettes of 16 bits with a ColorMap, of several
samples below 8 bits or in separate planes, and of three samples without
a ColorMap (libtiff makes them RGB with two extra samples) outside 16-bit
"unchanged"; CMYK of other than four samples or InkSet 1; YCbCr of other
than three 8-bit samples, or subsampled other than 1x1, 2x1, 2x2, 4x1,
4x2, 1x2 and 4x4, or subsampled in separate planes; CIELab of other than
three samples of 8 or 16 bits.  Raised as `UnsupportedImage`, because cv2
reads them: 16- to 64-bit samples in separate planes in "unchanged" (cv2
reads the first plane's blocks as if they were contiguous and leaves the
rest of its buffer as it was, so its result is not defined), and a Group 3
CCITT strip whose data ends before its last row (`data/ccitt.py`).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from kgtpu_torch.data.bmp import bgr_to_gray
from kgtpu_torch.data.imread import UnreadableImage, unsupported

_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h", 9: "i", 10: "ii",
          11: "f", 12: "d", 13: "I", 16: "Q", 17: "q", 18: "Q"}
# the integer types libtiff's TIFFReadDirEntryShort / Long accept
_INTEGER = (1, 3, 4, 6, 8, 9, 16, 17)
# tags whose bad type or count fails TIFFReadDirectory (the rest are
# ignored with a warning); Photometric, ignored so, fails cv2's header read
_FATAL = {256: 1, 257: 1, 258: 0, 259: 0, 262: 1, 277: 1, 278: 1, 284: 1, 322: 1, 323: 1, 339: 0,
          273: None, 279: None, 324: None, 325: None}
_DEFAULTS = {258: [1], 259: [1], 262: [None], 266: [1], 274: [1], 277: [1], 284: [1], 317: [1],
             338: [], 339: [1], 332: [1], 530: [2, 2]}
NOT_CONFIGURED = {6: "old-style JPEG", 32909: "PixarLog", 34925: "LZMA", 50000: "ZSTD",
                  50001: "WebP", 34887: "LERC", 34661: "JBIG"}
CCITT = (2, 3, 4, 32771)
PREDICTED = (5, 8, 32946)


def _ifd(data: bytes) -> tuple[dict, str]:
    """The tags of the first IFD: {tag: [values]} (a RATIONAL as floats),
    and the byte order."""
    e = "<" if data[:2] == b"II" else ">"
    if len(data) < 8:
        raise UnreadableImage("TIFF header is truncated")
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
        if tag in tags:                 # TIFFReadDirectory ignores a tag's repeats
            continue
        if tag in _FATAL and (typ not in _INTEGER or _FATAL[tag] == 1 and count != 1
                              or count == 0):
            raise UnreadableImage(f"TIFF tag {tag} of type {typ} and count {count} (libtiff "
                                  "cannot read the directory)")
        if typ not in _TYPES:
            continue
        size = struct.calcsize(_TYPES[typ]) * count
        if size <= 4:
            raw = ent[8:8 + size]
        else:
            (off,) = struct.unpack(e + "I", ent[8:12])
            raw = data[off:off + size]
            if len(raw) < size:
                if tag not in _FATAL and tag not in (277, 320, 338, 347, 530):
                    continue                # libtiff ignores the tag
                raise UnreadableImage(f"TIFF tag {tag} runs past the end of the file")
        vals = list(struct.unpack(e + _TYPES[typ] * count, raw))
        if tag in _FATAL and min(vals) < 0:
            raise UnreadableImage(f"TIFF tag {tag} of a negative value")
        if typ in (5, 10):
            vals = [float(np.float32(a / b)) if b else 0.0
                    for a, b in zip(vals[0::2], vals[1::2])]
        tags[tag] = vals if typ != 7 or tag != 347 else bytes(raw)
    return tags, e


def lzw_decode(src: bytes, expected: int) -> tuple[bytes, bool]:
    """TIFF LZW, as libtiff 4.7's `tif_lzw.c` decodes one strip or tile into
    `expected` bytes: (the bytes, whether libtiff's decoder succeeded).
    9- to 12-bit codes, 256 clears the table and 257 ends the data.
    New-style codes (LZWDecode) come most significant bit first and the
    code width grows one code early (at 511, 1023 and 2047 entries); data
    that starts 0x00 0x01 is old-style (LZWDecodeCompat): least significant
    bit first, the width growing at 512, 1024 and 2048.  Where libtiff's
    decoder fails (a code not yet in the table, a table run past its 5119
    entries, a data code before the first clear, a clear followed by a
    string code, the data or an EOI ending the strip short) the bytes decoded so far are kept and the rest is
    zero, as libtiff leaves its zeroed buffer; a string longer than the
    room left is cut."""
    compat = len(src) > 1 and src[0] == 0 and bool(src[1] & 1)
    out = bytearray()
    table: list[bytes] = [bytes([i]) for i in range(256)] + [b"", b""]
    width, acc, nbits, at, n = 9, 0, 0, 0, len(src)
    free, old = 258, b""        # b"": no clear code yet, so no string to extend
    ok = False
    while len(out) < expected:
        while nbits < width and at < n:         # whole bytes, as libtiff reads them
            acc = acc | src[at] << nbits if compat else (acc << 8) | src[at]
            nbits += 8
            at += 1
        if nbits < width:                   # no EOI: compat takes one, LZWDecode fails
            break
        nbits -= width
        if compat:
            code = acc & ((1 << width) - 1)
            acc >>= width
        else:
            code = (acc >> nbits) & ((1 << width) - 1)
            acc &= (1 << nbits) - 1
        if code == 257:
            break
        if code == 256:
            del table[258:]
            free, width, old = 258, 9, None
            continue
        if old is None:                     # the first code after a clear
            if code > 257:
                break                       # "Corrupted LZW table"
            out += table[code]
            old = table[code]
            continue
        if not old or free >= 5119:         # no clear yet, or the table ran past its end
            break                           # the table ran past its end
        if code < free:
            entry = table[code]
            add = old + entry[:1]
        elif code == free:
            entry = add = old + old[:1]
        else:
            break                           # a code not yet in the table
        table.append(add)
        free += 1
        if free > (1 << width) - (1 if compat else 2):
            width = min(width + 1, 12)
        old = entry
        out += entry[:expected - len(out)]
    else:
        ok = True
    return bytes(out) + bytes(expected - len(out)), ok


def packbits_decode(src: bytes, expected: int) -> tuple[bytes, bool]:
    """PackBits as `tif_packbits.c` decodes a strip: a run cut by the end of
    the data is dropped (a literal run whole), a run past `expected` is
    cut, and a strip left short is zero-filled and fails."""
    out = bytearray()
    i, n = 0, len(src)
    while i < n and len(out) < expected:
        c = src[i]
        i += 1
        if c > 128:
            if i >= n:
                break
            out += src[i:i + 1] * min(257 - c, expected - len(out))
            i += 1
        elif c < 128:
            run = min(c + 1, expected - len(out))
            if n - i < run:
                break
            out += src[i:i + run]
            i += run
    return bytes(out) + bytes(expected - len(out)), len(out) == expected


def _inflate(src: bytes, expected: int) -> tuple[bytes, bool]:
    """Deflate as `tif_zip.c` decodes a strip: zlib's output up to where the
    stream ends or fails, zero after it; success only if the strip filled."""
    try:
        out = zlib.decompressobj().decompress(src, expected)
        return out + bytes(expected - len(out)), len(out) == expected
    except zlib.error:
        pass
    z, got = zlib.decompressobj(), bytearray()       # again a byte at a time, to
    for i in range(len(src)):                         # keep what came before the fault
        try:
            got += z.decompress(src[i:i + 1], expected - len(got))
        except zlib.error:
            break
        if len(got) >= expected:
            break
    return bytes(got[:expected]) + bytes(max(expected - len(got), 0)), False


def _decompress(block: bytes, comp: int, expected: int) -> tuple[bytes, bool]:
    """One strip or tile decoded into `expected` bytes, and whether
    libtiff's codec succeeded (where it fails, what it decoded is kept and
    the rest is zero, as in libtiff's zeroed strip buffer)."""
    if comp == 1:       # DumpModeDecode copies nothing from a short strip
        return (block[:expected], True) if len(block) >= expected else (bytes(expected), False)
    if comp == 5:
        return lzw_decode(block, expected)
    if comp in (8, 32946):
        return _inflate(block, expected)
    if comp == 32773:
        return packbits_decode(block, expected)
    return bytes(expected), False       # a codec libtiff does not know: its zeroed buffer


_BITREV = bytes(int(f"{b:08b}"[::-1], 2) for b in range(256))
PACKED = (10, 12, 14)        # read only in "unchanged", as uint16


def _dtype(bits: int, fmt: int, e: str) -> np.dtype:
    if bits in PACKED:
        return np.dtype(np.uint16)
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
    if bits in PACKED:        # grfmt_tiff.cpp's _unpackNTo16: big-endian bits, << 16 - n
        v = np.unpackbits(buf, axis=1)[:, :cols * spp * bits].reshape(rows, cols * spp, bits)
        v = (v.astype(np.uint16) << np.arange(bits - 1, -1, -1, dtype=np.uint16)).sum(
            -1, dtype=np.uint16)
        return (v << (16 - bits)).reshape(rows, cols, spp)
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
        if self.w == 0 or self.h == 0:
            raise UnreadableImage("TIFF of width or height 0")
        if self.w > 1 << 20 or self.h > 1 << 20 or self.w * self.h > 1 << 30:
            raise UnreadableImage(f"{self.w}x{self.h} TIFF: larger than cv2 reads")
        self.spp, self.comp = get(277)[0], get(259)[0]
        bits = get(258)
        if len(set(bits)) != 1:
            raise UnreadableImage(f"TIFF with mixed bit depths {bits} (cv2 cannot read it)")
        self.bits = bits[0]
        self.photo, self.planar, self.predictor = get(262)[0], get(284)[0], get(317)[0]
        self.extra, self.fmt, self.orientation = get(338), get(339)[0], get(274)[0]
        if self.photo is None:          # cv2's header read needs the tag
            raise UnreadableImage("TIFF without PhotometricInterpretation (cv2 cannot read it)")
        self.palette_as_rgb = False
        if self.photo == 3 and 320 not in tags:
            # TIFFReadDirectory's fallback: MissingRequired below 8 bits, else
            # RGB for three samples (two of them already made ExtraSamples,
            # which the RGBA reader refuses) and grey for any other count
            if self.bits < 8:
                raise UnreadableImage("TIFF palette without a ColorMap (cv2 cannot read it)")
            self.photo = 2 if self.spp == 3 else 1
            self.palette_as_rgb = self.spp == 3
        if self.planar not in (1, 2):
            raise UnreadableImage(f"TIFF PlanarConfiguration {self.planar}")
        if 339 in tags and len(set(tags[339])) > 1:
            raise UnreadableImage("TIFF with different SampleFormats per sample")
        self.tiled = 322 in tags
        # a size of 0 fails libtiff's directory read; one over 2^24 cv2's check
        sizes = (get(322)[0], get(323)[0]) if self.tiled else (get(278)[0],) if 278 in tags \
            else ()
        if any(v == 0 or 1 << 24 < v < 0xFFFFFFFF or v == 0xFFFFFFFF and self.tiled
               for v in sizes):
            raise UnreadableImage(f"TIFF strip / tile size {sizes} (cv2 cannot read it)")
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
        if self.offsets[0] is None:
            raise UnreadableImage("TIFF strip / tile offsets missing")
        if self.counts[0] is None or len(self.grid) * nplanes == 1 and not self.tiled and \
                self._count_looks_bad(data):
            self.counts = self._estimate_counts(data, need, at_ifd=struct.unpack(
                e + "I", data[4:8])[0])
        # libtiff zero-fills arrays shorter than the strip count
        self.offsets = list(self.offsets) + [0] * max(need - len(self.offsets), 0)
        self.counts = list(self.counts) + [0] * max(need - len(self.counts), 0)

    def _count_looks_bad(self, data: bytes) -> bool:
        """libtiff's ByteCountLooksBad for an image of one strip: a count of
        0, or, uncompressed, one past the end of the file or short of the
        rows."""
        off, cnt = self.offsets[0], self.counts[0]
        if off == 0:
            return False
        if cnt == 0:
            return True
        if self.comp != 1:
            return False
        if off <= len(data) and cnt > len(data) - off:
            return True
        return cnt < self.h * self.scanline()

    def scanline(self) -> int:
        """TIFFScanlineSize: a row's bytes (a subsampled YCbCr row: its
        block row's bytes / vs, truncated)."""
        hs, vs = self.get(530)[:2] if self.photo == 6 and self.planar == 1 else (1, 1)
        if (hs, vs) != (1, 1):
            return -(-self.w // hs) * (hs * vs + 2) * self.bits // 8 // vs
        return (self.w * (self.spp if self.planar == 1 else 1) * self.bits + 7) // 8

    def _estimate_counts(self, data: bytes, need: int, at_ifd: int) -> list[int]:
        """libtiff's EstimateStripByteCounts for a file without them: the
        bytes of a strip or tile uncompressed, else the file less its header
        and directory, shared by the planes, the last strip cut at the end
        of the file."""
        if self.comp == 1:
            if self.tiled:
                return [self.th * ((self.tw * (self.spp if self.planar == 1 else 1)
                                    * self.bits + 7) // 8)] * need
            return [self.th * self.scanline()] * need
        (n,) = struct.unpack(self.e + "H", data[at_ifd:at_ifd + 2])
        space = 8 + 2 + 12 * n + 4
        for k in range(n):
            typ, count = struct.unpack(self.e + "HI", data[at_ifd + 4 + 12 * k:at_ifd + 10 + 12 * k])
            size = struct.calcsize(_TYPES[typ]) * count if typ in _TYPES else 0
            space += size if size > 4 else 0
        space = len(data) - space if len(data) >= space else len(data)
        if self.planar == 2:
            space //= self.spp
        counts = [space] * need
        last = self.offsets[min(need, len(self.offsets)) - 1]
        if last + space > len(data):
            counts[-1] = len(data) - last if last < len(data) else 0
        return counts

    def raw(self, data: bytes, k: int) -> bytes | None:
        """The stored bytes of strip or tile k, or None where libtiff's
        TIFFFillStrip fails: a byte count of 0 or one that runs past the end
        of the file."""
        off, cnt = self.offsets[k], self.counts[k]
        if cnt == 0 or cnt > len(data) or off > len(data) - cnt:
            return None
        raw = data[off:off + cnt]
        if self.get(266)[0] == 2 and self.comp in (1, 5, 8, 32946, 32773):
            raw = raw.translate(_BITREV)        # TIFFFillStrip's TIFFReverseBits
        return raw

    def block(self, data: bytes, k: int, expected: int) -> tuple[bytes, bool]:
        raw = self.raw(data, k)
        if raw is None:
            raise UnreadableImage(f"TIFF strip / tile {k} runs past the end of the file")
        return _decompress(raw, self.comp, expected)


def _check(d: _Dir, mode: str) -> None:
    """cv2's and libtiff's refusals, in the order they come."""
    if d.photo in (0, 1, 3) and d.spp == 1 and d.bits in (2, 4) and (d.photo, d.bits) != (3, 4):
        raise UnreadableImage(f"{d.bits}-bit grey or palette TIFF (cv2 cannot read it)")
    if d.comp in NOT_CONFIGURED:
        raise UnreadableImage(f"TIFF compression {d.comp} ({NOT_CONFIGURED[d.comp]}): "
                              "cv2 cannot read it")
    if d.comp == 32809 and d.bits != 4 or d.comp == 32766:
        raise UnreadableImage(f"TIFF compression {d.comp} of {d.bits}-bit samples (libtiff "
                              "decodes ThunderScan at 4 bits and NeXT at 2, which cv2 "
                              "cannot read)")
    if d.orientation in (5, 6, 7, 8):
        raise UnreadableImage(f"TIFF Orientation {d.orientation} (cv2 cannot read it)")
    if d.bits not in (1, 2, 4, 8, 16, 32, 64):
        if d.bits in PACKED and mode == "unchanged" and (
                d.photo in (0, 1) and d.spp != 2 or d.photo == 2 and d.spp in (3, 4)):
            return
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
    if (kind == "gray" and (d.bits not in (1, 8, 16) or d.spp > 1 and d.bits < 8 and d.planar == 1)
            or kind == "rgb" and (colors < 3 or d.bits not in (8, 16) or d.spp > 4)
            or kind == "palette" and d.bits == 16 and 320 in d.tags
            or kind == "cmyk" and (d.spp != 4 or d.get(332)[0] != 1)
            or kind == "ycbcr" and (d.bits != 8 or d.spp != 3)
            or kind == "lab" and (d.spp != 3 or d.bits not in (8, 16))):
        raise UnreadableImage(f"TIFF {kind} of {d.spp} samples of {d.bits} bits (cv2 "
                              "cannot read it)")
    if d.palette_as_rgb:
        if d.bits == 16:
            return "direct"             # only cv2's "unchanged" reads it, as stored
        raise UnreadableImage("TIFF palette of three samples without a ColorMap (cv2 cannot "
                              "read it)")
    if kind == "palette" and (d.bits not in (1, 4, 8) or d.spp != 1 and (
            d.bits < 8 or d.planar == 2)):
        raise UnreadableImage(f"TIFF palette of {d.spp} samples of {d.bits} bits (cv2 cannot "
                              "read it)")
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
    if d.comp in (34676, 34677):
        from kgtpu_torch.data.tiff_luv import read_sgilog
        return read_sgilog(d, data, mode)
    jpeg_px = None
    if d.comp == 7:
        from kgtpu_torch.data.tiff_jpeg import read_jpeg_tiff
        jpeg_px = read_jpeg_tiff(d, data)
    kind = _kind(d) if d.bits <= 16 and d.bits not in PACKED else "direct"
    if kind == "direct" and mode != "unchanged":
        raise UnreadableImage(f"TIFF of {d.bits}-bit samples in {mode} mode (cv2 cannot "
                              "read it)")
    ch, dtype = _out_type(d, kind)
    direct = mode == "unchanged" and dtype is not None and dtype.itemsize > 1
    # cv2's buffer for one strip or tile (its stored RowsPerStrip, not cut to
    # the image) must stay under 1 GiB: RGBA words, or the samples as stored
    rps = d.get(278)[0] if 278 in d.tags and not d.tiled else d.th
    rows0 = d.h if rps == 0xFFFFFFFF else rps
    if rows0 * (-(-d.spp * d.tw * d.bits // 8) if direct else 4 * d.tw) >= 1 << 30:
        raise UnreadableImage("TIFF strip / tile over cv2's 1 GiB buffer")
    if direct and d.planar == 2 and d.spp > 1:
        raise unsupported(f"{d.bits}-bit TIFF in separate planes in unchanged mode (cv2 "
                          "reads its first plane's blocks as if contiguous, and what it "
                          "returns beyond them is not defined)")
    if jpeg_px is not None:
        px = jpeg_px
    elif kind == "ycbcr" and d.planar == 1 and tuple(d.get(530)) != (1, 1):
        px = _ycbcr_subsampled(d, data)
    else:
        px = _read_samples(d, data, skewed=d.planar == 1 and not direct and (
            kind == "gray" and (d.bits == 16 or d.bits == 8 and d.spp > 1)
            or kind == "palette" and d.bits == 8 and d.spp > 1), strict=direct)
    px = _orient(d, px, rgba_reader=not direct)
    if direct:
        if d.photo in (0, 1) and d.spp >= 3 and dtype == np.uint16:
            # cv2 reads the samples as colour and turns them grey with its
            # icvCvt_BGR2Gray_16u (the first sample weighted as red), before
            # it widens 10- to 14-bit samples
            shift = 16 - d.bits if d.bits in PACKED else 0
            s = px[..., :3].astype(np.int64) >> shift
            return (((s[..., 0] * 4899 + s[..., 1] * 9617 + s[..., 2] * 1868 + 8192) >> 14)
                    << shift).astype(np.uint16)
        out = px[..., :ch] if ch > 1 else px[..., 0]
        return np.ascontiguousarray(out.astype(dtype))
    rgba = _rgba(d, kind, px)
    if mode == "color":
        return np.ascontiguousarray(rgba[..., :3])
    out = bgr_to_gray(rgba[..., 2::-1]) if mode == "gray" or ch == 1 else \
        np.ascontiguousarray(rgba[..., :ch])
    return out.view(np.int8) if mode == "unchanged" and dtype is not None else out


def _read_samples(d: _Dir, data: bytes, skewed: bool, strict: bool = False) -> np.ndarray:
    """Every strip or tile decoded into [h, w, spp] samples.  `skewed`:
    16-bit grey read as put16bitbwtile reads it (high bytes, skewed rows in
    tiles cut by the right edge), as uint16 << 8.  `strict`: read as cv2
    reads "unchanged" above 8 bits, with TIFFReadEncodedStrip / Tile, whose
    failure fails the read; else as the RGBA reader reads, which keeps what
    a failing codec decoded (and the predictor undone only where it
    succeeded) and zeros for a plane after the first that cannot be
    read."""
    nplanes = d.spp if d.planar == 2 else 1
    per_block = d.spp // nplanes
    dt = _dtype(max(d.bits, 8), d.fmt, "=")
    px = np.zeros((d.h, d.w, d.spp), np.uint8 if d.bits <= 8 else dt)
    for p in range(nplanes):
        for k, (y, x) in enumerate(d.grid):
            rows = d.th if d.tiled else min(d.th, d.h - y)
            expected = rows * ((d.tw * per_block * d.bits + 7) // 8)
            stored = d.raw(data, p * len(d.grid) + k)
            if stored is None and (p == 0 or strict):
                raise UnreadableImage(f"TIFF strip / tile {k} runs past the end of the file")
            if d.comp in CCITT:
                from kgtpu_torch.data.ccitt import decode_ccitt
                block, ok = decode_ccitt(stored or b"", d, rows, d.tw,
                                         d.offsets[p * len(d.grid) + k])
                block = block[..., None]
            elif d.comp == 32809:
                from kgtpu_torch.data.tiff_thunder import decode_thunder
                raw, ok = decode_thunder(stored or b"", rows, d.w)
                block = _samples(raw, rows, d.tw, per_block, d.bits, d.e, d.fmt, 1)
            else:
                raw, ok = _decompress(stored, d.comp, expected) if stored is not None else (
                    bytes(expected), False)
                pred = d.predictor if d.comp in PREDICTED and ok else 1
                block = _samples(raw, rows, d.tw, per_block, d.bits, d.e, d.fmt, pred)
            if strict and not ok:
                raise UnreadableImage(f"corrupt TIFF data in strip / tile {k} (cv2 cannot read "
                                      "it above 8 bits)")
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
    blocks after each block row's ceil(inside / hs) (the 4x4 routine takes
    such a block as 10 bytes long, not 18).  A strip is read only
    as far as libtiff's truncated scanline size reaches (see below)."""
    hs, vs = d.get(530)[:2]
    if hs not in (1, 2, 4) or vs not in (1, 2, 4) or vs > hs and (hs, vs) != (1, 2):
        raise UnreadableImage(f"TIFF YCbCr subsampling {hs}x{vs} (cv2 cannot read it)")
    unit = hs * vs + 2
    px = np.zeros((d.h, d.w, 3), np.uint8)
    for k, (y, x) in enumerate(d.grid):
        rows = d.th if d.tiled else min(d.th, d.h - y)
        brows, bcols = -(-rows // vs), -(-d.tw // hs)
        size = brows * bcols * unit
        raw = np.frombuffer(d.block(data, k, size)[0], np.uint8)
        if not d.tiled:
            # gtStripContig reads (rows rounded up to vs) x TIFFScanlineSize
            # bytes, whose scanline is a block row's bytes / vs, truncated:
            # at 4x4 with an odd number of blocks across it comes up short
            raw = raw[:brows * vs * (bcols * unit // vs)]
        raw = np.concatenate([raw, np.zeros(max(size - raw.size, 0), np.uint8)])[:size]
        inside, rows_in = min(d.tw, d.w - x), min(rows, d.h - y)
        used = -(-inside // hs)
        # putcontig8bitYCbCr44tile skips 10 bytes a block (4x2's size), not 18
        step = used * unit + (d.tw - inside) // hs * (10 if (hs, vs) == (4, 4) else unit)
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
