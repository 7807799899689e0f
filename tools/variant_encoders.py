"""Writers of the image-format variants that neither cv2 nor PIL writes, for
the port's reader tests and fixtures (tests/test_torch_format_variants.py,
tools/make_torch_format_assets.py).  NumPy, zlib and struct only.

  tiff_file / tiff_image   TIFF of any layout: strips or tiles, contiguous or
                           separate planes, any sample type, YCbCr
                           subsampling, JPEG tables, any tag
  jpeg_coefficients,       re-encode a JPEG's quantised coefficients as an
  jpeg_arith               arithmetic-coded JPEG (SOF9 sequential, SOF10
                           progressive), as libjpeg's jcarith.c codes them
  jpeg_lossless            SOF3 lossless JPEG (Huffman, predictors 1-7,
                           point transform, restarts)
  jpeg_set_adobe           an Adobe APP14 marker with a given transform
  bmp_rle                  RLE8 / RLE4 BMP from index rows
  bmp_file                 BMP with any header (12-byte OS/2 too) and depth
  ccitt_encode             CCITT modified Huffman (RLE), Group 3 (1-D / 2-D)
                           and Group 4 bilevel coding
  jpeg2000_random          a random JPEG 2000 file from PIL (size, mode,
                           content and every encoder option PIL has)
  jpeg2000_packed_headers  a JPEG 2000 codestream's packet headers moved into
                           PPT or PPM markers
  jpeg2000_opj             JPEG 2000 from libopenjp2 (PIL's copy) through
                           ctypes, with the code-block styles PIL does not
                           set (BYPASS, RESET, TERMALL, VSC, PTERM, SEGSYM)
  jpeg2000_random_styles   a random file of jpeg2000_opj: size, components,
                           precision, wavelet, layers, resolutions,
                           code-block size and style

cv2 reading a written file is the check that it is valid; the tests hold
the port's decoder against cv2's decode of it, never against these writers.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

# --- TIFF --------------------------------------------------------------------

SHORT, LONG, RATIONAL, ASCII, UNDEFINED, DOUBLE = 3, 4, 5, 2, 7, 12


def pack_bits(v: np.ndarray, bits: int) -> np.ndarray:
    """[rows, n] samples of 1, 2 or 4 bits -> rows of bytes, MSB first."""
    per = 8 // bits
    v = np.concatenate([v, np.zeros((len(v), (-v.shape[1]) % per), v.dtype)], 1)
    v = v.reshape(len(v), -1, per).astype(np.uint8)
    return (v << (bits * np.arange(per - 1, -1, -1)).astype(np.uint8)).sum(-1).astype(np.uint8)


def sample_rows(block: np.ndarray, bits: int, e: str, predictor: int = 1) -> list[bytes]:
    """[rows, cols, spp] samples -> the bytes of each row, with predictor 2
    (horizontal differencing) or 3 (floating point) applied."""
    rows, cols, spp = block.shape
    if bits < 8:
        return [r.tobytes() for r in pack_bits(block.reshape(rows, -1).astype(np.uint8), bits)]
    kind = block.dtype.kind
    dt = np.dtype(f"{'f' if kind == 'f' else ('i' if kind == 'i' else 'u')}{bits // 8}")
    b = block.astype(dt)
    if predictor == 2:
        u = b.view(f"u{bits // 8}")
        d = u.copy()
        d[:, 1:] = u[:, 1:] - u[:, :-1]
        b = d.view(dt)
    if predictor == 3:
        nb = bits // 8
        be = b.astype(dt.newbyteorder(">")).view(np.uint8).reshape(rows, cols * spp, nb)
        planes = be.transpose(0, 2, 1).reshape(rows, -1).astype(np.int16)
        d = planes.copy()
        d[:, spp:] = planes[:, spp:] - planes[:, :-spp]
        return [(r & 255).astype(np.uint8).tobytes() for r in d]
    return [r.astype(dt.newbyteorder(e)).tobytes() for r in b]


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


def lzw_encode_old(data: bytes) -> bytes:
    """Old-style TIFF LZW (LSB-first codes, the width grows when the next
    code reaches 2^width): what libtiff's compat decoder reads.  Starts
    with a clear code, whose low byte 0x00 and next bit make the 0x00 0x01
    libtiff sniffs."""
    out, acc, nacc = bytearray(), 0, 0

    def put(code, width):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += width
        while nacc >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nacc -= 8
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
        elif nxt > (1 << width):
            width += 1
        w = bytes([c])
    if w:
        put(table[w], width)
        nxt += 1
        if nxt > (1 << width) and width < 12:
            width += 1
    put(257, width)
    if nacc:
        out.append(acc & 0xFF)
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


def compress(rows: list[bytes], compression: int) -> bytes:
    raw = b"".join(rows)
    if compression in (8, 32946):
        return zlib.compress(raw)
    if compression == 5:
        return lzw_encode(raw)
    if compression == -5:                       # old-style LZW, stored as 5
        return lzw_encode_old(raw)
    if compression == 32773:
        return b"".join(packbits(r) for r in rows)
    return raw


def tiff_file(blocks: list[bytes], tags: dict, bo: str = "II", tiled: bool = False) -> bytes:
    """A TIFF of one IFD: `blocks` (strips or tiles, already coded) and
    `tags` {tag: (type, [values])}; the offsets and byte counts are added."""
    e = "<" if bo == "II" else ">"
    tags = dict(tags)
    data = bytearray((b"II*\0" if bo == "II" else b"MM\0*") + b"\0\0\0\0")
    offsets = []
    for b in blocks:
        offsets.append(len(data))
        data += b + b"\0" * (len(b) % 2)
    offk, cntk = (324, 325) if tiled else (273, 279)
    tags[offk], tags[cntk] = (LONG, offsets), (LONG, [len(b) for b in blocks])
    fmt = {SHORT: "H", LONG: "I", RATIONAL: "II", ASCII: "B", UNDEFINED: "B", DOUBLE: "d"}
    packed = {}
    for k, (t, vals) in sorted(tags.items()):
        if t == RATIONAL:
            flat = [int(x) for v in vals for x in (v if isinstance(v, tuple) else (v, 1))]
            raw = struct.pack(e + "I" * len(flat), *flat)
            count = len(flat) // 2
        elif t == DOUBLE:
            raw = struct.pack(e + "d" * len(vals), *map(float, vals))
            count = len(vals)
        else:
            raw = struct.pack(e + fmt[t] * len(vals), *map(int, vals))
            count = len(vals)
        if len(raw) > 4:
            packed[k] = (t, count, struct.pack(e + "I", len(data)))
            data += raw + b"\0" * (len(raw) % 2)
        else:
            packed[k] = (t, count, raw.ljust(4, b"\0"))
    data[4:8] = struct.pack(e + "I", len(data))
    data += struct.pack(e + "H", len(tags))
    for k, (t, count, val) in sorted(packed.items()):
        data += struct.pack(e + "HHI", k, t, count) + val
    return bytes(data + struct.pack(e + "I", 0))


def tiff_image(px, photometric: int, bits: int = 8, compression: int = 1, predictor: int = 1,
               tile=None, rows_per_strip=None, planar: int = 1, bo: str = "II",
               sample_format: int | None = None, extra=None, tags=None) -> bytes:
    """A TIFF of `px` ([H, W] or [H, W, spp]) in strips or tiles (edge tiles
    zero-padded), contiguous (planar 1) or one plane after another (planar
    2).  `compression` -5 writes old-style LZW under the code 5."""
    px = np.asarray(px)
    if px.ndim == 2:
        px = px[..., None]
    h, w, c = px.shape
    e = "<" if bo == "II" else ">"
    planes = [px] if planar == 1 else [px[..., k:k + 1] for k in range(c)]
    blocks = []
    for plane in planes:
        if tile:
            tw, th = tile
            for y in range(0, h, th):
                for x in range(0, w, tw):
                    t = np.zeros((th, tw, plane.shape[2]), px.dtype)
                    sub = plane[y:y + th, x:x + tw]
                    t[:sub.shape[0], :sub.shape[1]] = sub
                    blocks.append(compress(sample_rows(t, bits, e, predictor), compression))
        else:
            rps = rows_per_strip or h
            blocks += [compress(sample_rows(plane[y:y + rps], bits, e, predictor), compression)
                       for y in range(0, h, rps)]
    t = {256: (LONG, [w]), 257: (LONG, [h]), 258: (SHORT, [bits] * c),
         259: (SHORT, [abs(compression)]), 262: (SHORT, [photometric]), 277: (SHORT, [c]),
         284: (SHORT, [planar])}
    if predictor != 1:
        t[317] = (SHORT, [predictor])
    if sample_format is not None:
        t[339] = (SHORT, [sample_format] * c)
    if extra is not None:
        t[338] = (SHORT, list(extra))
    if tile:
        t[322], t[323] = (SHORT, [tile[0]]), (SHORT, [tile[1]])
    else:
        t[278] = (LONG, [rows_per_strip or h])
    t.update(tags or {})
    return tiff_file(blocks, t, bo, tiled=bool(tile))


def ycbcr_units(y: np.ndarray, cb: np.ndarray, cr: np.ndarray, hs: int, vs: int) -> np.ndarray:
    """Contiguous YCbCr data of subsampling hs x vs: for each hs x vs block
    of luma (the image padded to whole blocks by repeating its edge), its
    hs*vs Y samples row by row, then Cb and Cr.  Returns [block rows,
    bytes per block row]; cb and cr are [ceil(H/vs), ceil(W/hs)]."""
    h, w = y.shape
    bh, bw = -(-h // vs), -(-w // hs)
    yp = np.pad(y, ((0, bh * vs - h), (0, bw * hs - w)), mode="edge")
    units = yp.reshape(bh, vs, bw, hs).transpose(0, 2, 1, 3).reshape(bh, bw, vs * hs)
    return np.concatenate([units, cb[..., None], cr[..., None]], -1).reshape(bh, -1).astype(
        np.uint8)


def tiff_ycbcr(y, cb, cr, hs: int, vs: int, compression: int = 1, rows_per_strip=None,
               tile=None, bo: str = "II", tags=None) -> bytes:
    """A contiguous YCbCr TIFF with subsampling hs x vs, in strips (rows a
    multiple of vs) or tiles."""
    h, w = y.shape
    units = ycbcr_units(y, cb, cr, hs, vs)
    per = hs * vs + 2
    blocks = []
    if tile:
        tw, th = tile
        for y0 in range(0, h, th):
            for x0 in range(0, w, tw):
                t = np.zeros((th // vs, (tw // hs) * per), np.uint8)
                sub = units[y0 // vs:(y0 + th) // vs, (x0 // hs) * per:((x0 + tw) // hs) * per]
                t[:sub.shape[0], :sub.shape[1]] = sub
                blocks.append(compress([r.tobytes() for r in t], compression))
    else:
        rps = rows_per_strip or h
        blocks = [compress([r.tobytes() for r in units[r0 // vs:-(-(r0 + rps) // vs)]],
                           compression) for r0 in range(0, h, rps)]
    t = {256: (LONG, [w]), 257: (LONG, [h]), 258: (SHORT, [8, 8, 8]),
         259: (SHORT, [compression]), 262: (SHORT, [6]), 277: (SHORT, [3]), 284: (SHORT, [1]),
         530: (SHORT, [hs, vs])}
    if tile:
        t[322], t[323] = (SHORT, [tile[0]]), (SHORT, [tile[1]])
    else:
        t[278] = (LONG, [rows_per_strip or h])
    t.update(tags or {})
    return tiff_file(blocks, t, bo, tiled=bool(tile))


# --- JPEG --------------------------------------------------------------------

def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


class _Bits:
    """Huffman bit writer: MSB first, 0xFF stuffed, restarts padded with 1s."""

    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, v: int, n: int) -> None:
        self.acc = (self.acc << n) | (v & ((1 << n) - 1))
        self.n += n
        while self.n >= 8:
            self.n -= 8
            b = (self.acc >> self.n) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self) -> None:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


# a DC table for the 17 lossless categories: lengths 2, 3 (x5), 4, ..., 14
LOSSLESS_COUNTS = [0, 1, 5, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0]


def _huff_codes(counts: list[int], values: list[int]) -> dict:
    code, k, out = 0, 0, {}
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            out[values[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return out


def lossless_predict(x: np.ndarray, predictor: int, pt: int, first_rows) -> np.ndarray:
    """The prediction of each sample of `x` ([h, w], after the point
    transform) as libjpeg's lossless decoder forms it."""
    h, w = x.shape
    x = x.astype(np.int64)
    pred = np.zeros_like(x)
    for r in range(h):
        if r in first_rows:
            pred[r, 0] = 1 << (8 - pt - 1)
            pred[r, 1:] = x[r, :-1]
            continue
        ra, rb = x[r, :-1], x[r - 1, 1:]
        rc = x[r - 1, :-1]
        pred[r, 0] = x[r - 1, 0]
        pred[r, 1:] = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
                       6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[predictor]
    return pred


def jpeg_lossless(planes, predictor: int = 1, pt: int = 0, restart_rows: int = 0,
                  ids=None, adobe=None, interleaved: bool = True) -> bytes:
    """A lossless (SOF3) JPEG of 8-bit planes ([h, w] each, sampling 1x1),
    one interleaved scan, or one scan per component."""
    planes = [np.asarray(p, np.int64) >> pt for p in planes]
    h, w = planes[0].shape
    n = len(planes)
    ids = list(ids or range(1, n + 1))
    values = list(range(17))
    codes = _huff_codes(LOSSLESS_COUNTS, values)
    first = set(range(0, h, restart_rows)) if restart_rows else {0}
    diffs = []
    for x in planes:
        d = (x - lossless_predict(x, predictor, pt, first)) & 0xFFFF
        diffs.append(np.where(d > 32768, d - 65536, d))
    head = b"\xff\xd8"
    if adobe is not None:
        head += _segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, adobe))
    head += _segment(0xC3, struct.pack(">BHHB", 8, h, w, n) + b"".join(
        struct.pack(">BBB", i, 0x11, 0) for i in ids))
    head += _segment(0xC4, bytes([0x00] + LOSSLESS_COUNTS + values))
    if restart_rows:
        mcus = w if not interleaved or n == 1 else w
        head += _segment(0xDD, struct.pack(">H", restart_rows * mcus))
    groups = [list(range(n))] if interleaved else [[k] for k in range(n)]
    body = b""
    for group in groups:
        bits = _Bits()
        rst = 0
        sos = _segment(0xDA, bytes([len(group)]) + b"".join(bytes([ids[k], 0]) for k in group)
                       + bytes([predictor, 0, pt]))
        for r in range(h):
            if restart_rows and r and r % restart_rows == 0:
                bits.flush()
                bits.out += bytes([0xFF, 0xD0 + rst % 8])
                rst += 1
            for c in range(w):
                for k in group:
                    v = int(diffs[k][r, c])
                    s = 16 if v == 32768 else abs(v).bit_length()
                    bits.put(*codes[s])
                    if 0 < s < 16:
                        bits.put(v if v > 0 else v - 1, s)
        bits.flush()
        body += sos + bytes(bits.out)
    return head + body + b"\xff\xd9"


def jpeg_set_adobe(jpeg: bytes, transform: int) -> bytes:
    """`jpeg` with its Adobe APP14 marker's transform set (a marker added
    after SOI if there is none) and any JFIF APP0 removed."""
    out, pos = bytearray(b"\xff\xd8"), 2
    out += _segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, transform))
    while pos < len(jpeg):
        m = jpeg[pos + 1]
        (length,) = struct.unpack(">H", jpeg[pos + 2:pos + 4])
        if m == 0xDA:
            return bytes(out + jpeg[pos:])
        if not (m == 0xEE or m == 0xE0):
            out += jpeg[pos:pos + 2 + length]
        pos += 2 + length
    return bytes(out)


class _ArithEncoder:
    """jcarith.c's arith_encode and finish_pass."""

    def __init__(self):
        from kgtpu_torch.data.jpeg_arith import AFTER_LPS, AFTER_MPS, QE
        self.QE, self.LPS, self.MPS = QE, AFTER_LPS, AFTER_MPS
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1
        self.out = bytearray()

    def encode(self, st: list, i: int, val: int) -> None:
        sv = st[i]
        qe = self.QE[sv]
        self.a -= qe
        if val != (sv >> 7):
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = self.LPS[sv]
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = self.MPS[sv]
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self.out += b"\x00" * self.zc
                        self.zc = 0
                        self.out.append(self.buffer + 1)
                        if self.buffer + 1 == 0xFF:
                            self.out.append(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self.out += b"\x00" * self.zc
                        self.zc = 0
                        self.out.append(self.buffer)
                    if self.sc:
                        self.out += b"\x00" * self.zc
                        self.zc = 0
                        self.out += b"\xff\x00" * self.sc
                        self.sc = 0
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self.out += b"\x00" * self.zc
                self.zc = 0
                self.out.append(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self.out.append(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self.out += b"\x00" * self.zc
                self.zc = 0
                self.out.append(self.buffer)
            if self.sc:
                self.out += b"\x00" * self.zc
                self.zc = 0
                self.out += b"\xff\x00" * self.sc
                self.sc = 0
        if self.c & 0x7FFF800:
            self.out += b"\x00" * self.zc
            self.zc = 0
            b = (self.c >> 19) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0)
            if self.c & 0x7F800:
                b = (self.c >> 11) & 0xFF
                self.out.append(b)
                if b == 0xFF:
                    self.out.append(0)
        return bytes(self.out)


def _enc_dc(e, st, ctx, v, lo, hi) -> int:
    """Figures F.4-F.9 for one DC difference; returns the next context."""
    if v == 0:
        e.encode(st, ctx, 0)
        return 0
    e.encode(st, ctx, 1)
    if v > 0:
        e.encode(st, ctx + 1, 0)
        i, nctx = ctx + 2, 4
    else:
        v = -v
        e.encode(st, ctx + 1, 1)
        i, nctx = ctx + 3, 8
    m = 0
    v -= 1
    if v:
        e.encode(st, i, 1)
        m = 1
        v2 = v
        i = 20
        v2 >>= 1
        while v2:
            e.encode(st, i, 1)
            m <<= 1
            i += 1
            v2 >>= 1
    e.encode(st, i, 0)
    if m < (1 << lo) >> 1:
        nctx = 0
    elif m > (1 << hi) >> 1:
        nctx += 8
    i += 14
    m >>= 1
    while m:
        e.encode(st, i, 1 if m & v else 0)
        m >>= 1
    return nctx


def _enc_ac_value(e, st, i, fixed, v, k, kx) -> None:
    """Figures F.6-F.9 for a nonzero AC value whose sign is coded; st[i] is
    its S0 bin."""
    i += 2
    m = 0
    v -= 1
    if v:
        e.encode(st, i, 1)
        m = 1
        v2 = v >> 1
        if v2:
            e.encode(st, i, 1)
            m <<= 1
            i = 189 if k <= kx else 217
            v2 >>= 1
            while v2:
                e.encode(st, i, 1)
                m <<= 1
                i += 1
                v2 >>= 1
    e.encode(st, i, 0)
    i += 14
    m >>= 1
    while m:
        e.encode(st, i, 1 if m & v else 0)
        m >>= 1


def _shift(v: int, al: int) -> int:
    """|v| >> al with v's sign (jcarith's point transform of AC values)."""
    return (v >> al) if v >= 0 else -((-v) >> al)


def _arith_scan(comps, scomps, frame, restart, scan, L, U, K) -> bytes:
    """One arithmetic-coded scan's entropy-coded data (with RST markers)."""
    from kgtpu_torch.data.jpeg import ZIGZAG, _Scan
    ss, se, ah, al = scan["ss"], scan["se"], scan["ah"], scan["al"]
    progressive = frame["progressive"]
    out = bytearray()
    for n, interval in enumerate(_Scan(comps, scomps, frame, restart).intervals):
        if n:
            out += bytes([0xFF, 0xD0 + (n - 1) % 8])
        e = _ArithEncoder()
        dc_bins, ac_bins = [0] * 64, [0] * 256          # table 0, shared by every component
        dc = {ci: dc_bins for ci in scomps}
        acs = {ci: ac_bins for ci in scomps}
        last = {ci: 0 for ci in scomps}
        ctx = {ci: 0 for ci in scomps}
        fixed = [113]
        for mcu in interval:
            for ci, base in mcu:
                coef = comps[ci].coef
                blk = [coef[base + ZIGZAG[k]] for k in range(64)]      # zigzag order
                if not progressive or (ss == 0 and ah == 0):
                    d = blk[0] >> al if progressive else blk[0]
                    ctx[ci] = _enc_dc(e, dc[ci], ctx[ci], d - last[ci], L, U)
                    last[ci] = d
                elif ss == 0:
                    e.encode(fixed, 0, (blk[0] >> al) & 1)
                    continue
                if progressive and ss == 0:
                    continue
                lo, hi = (1, 63) if not progressive else (ss, se)
                vals = [_shift(v, al) for v in blk] if progressive else blk
                ke = hi
                while ke >= lo and not vals[ke]:
                    ke -= 1
                st = acs[ci]
                if progressive and ah:
                    kex = ke
                    while kex >= lo and not _shift(blk[kex], ah):
                        kex -= 1
                    k = lo
                    while k <= ke:
                        i = 3 * (k - 1)
                        if k > kex:
                            e.encode(st, i, 0)
                        while True:
                            v = vals[k]
                            if v:
                                if abs(v) >> 1:
                                    e.encode(st, i + 2, abs(v) & 1)
                                else:
                                    e.encode(st, i + 1, 1)
                                    e.encode(fixed, 0, 1 if v < 0 else 0)
                                break
                            e.encode(st, i + 1, 0)
                            i += 3
                            k += 1
                        k += 1
                    if k <= hi:
                        e.encode(st, 3 * (k - 1), 1)
                    continue
                k = lo
                while k <= ke:
                    i = 3 * (k - 1)
                    e.encode(st, i, 0)
                    while not vals[k]:
                        e.encode(st, i + 1, 0)
                        i += 3
                        k += 1
                    e.encode(st, i + 1, 1)
                    v = vals[k]
                    e.encode(fixed, 0, 1 if v < 0 else 0)
                    _enc_ac_value(e, st, i, fixed, abs(v), k, K)
                    k += 1
                if k <= hi:
                    e.encode(st, 3 * (k - 1), 1)
        out += e.finish()
    return bytes(out)


def jpeg_arith(src: bytes, progressive: bool | None = None, restart: int | None = None,
               dac=None, interleaved: bool = True) -> bytes:
    """The JPEG `src` re-coded with arithmetic coding, coefficients
    unchanged: SOF9 sequential (one interleaved scan, or one per
    component), or SOF10 progressive with the scans of a progressive `src`
    (or DC-only scans if `src` is sequential and `progressive` is True).
    `dac`: (L, U, K) conditioning for table 0, written as a DAC marker."""
    from kgtpu_torch.data.jpeg import ZIGZAG, _frame, parse
    img = parse(src)
    comps = img["components"]
    prog = any(s["ah"] or s["al"] or s["ss"] or s["se"] != 63 for s in img["scans"]) \
        if progressive is None else progressive
    coefs = [c.coef for c in comps]
    frame = _frame(img["width"], img["height"], comps, prog)      # (clears the grids)
    for c, coef in zip(comps, coefs):
        c.coef = coef
    restart = restart or 0
    L, U, K = dac or (0, 1, 5)
    out = bytearray(b"\xff\xd8")
    if img["color"] == "ycc":
        out += _segment(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0")
    elif img["color"] in ("rgb", "cmyk", "ycck") and len(comps) > 1:
        out += _segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0,
                                                     {"rgb": 0, "cmyk": 0, "ycck": 2}[
                                                         img["color"]]))
    tables = {}
    for c in comps:
        tables[c.tq] = c.quant
    for t, q in sorted(tables.items()):
        zz = np.asarray(q)[ZIGZAG[:64]]
        out += _segment(0xDB, bytes([t]) + bytes(zz.astype(np.uint8)))
    out += _segment(0xCA if prog else 0xC9, struct.pack(">BHHB", 8, img["height"], img["width"],
                                                        len(comps)) + b"".join(
        struct.pack(">BBB", c.id, (c.h << 4) | c.v, c.tq) for c in comps))
    if dac:
        out += _segment(0xCC, bytes([0, (U << 4) | L, 16, K]))
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    ids = {c.id: i for i, c in enumerate(comps)}
    if prog and progressive is None:
        scans = img["scans"]
    elif prog:
        scans = [{"comps": [c.id for c in comps], "ss": 0, "se": 0, "ah": 0, "al": 1},
                 {"comps": [c.id for c in comps], "ss": 0, "se": 0, "ah": 1, "al": 0}]
    elif interleaved:
        scans = [{"comps": [c.id for c in comps], "ss": 0, "se": 63, "ah": 0, "al": 0}]
    else:
        scans = [{"comps": [c.id], "ss": 0, "se": 63, "ah": 0, "al": 0} for c in comps]
    for scan in scans:
        scomps = [ids[i] for i in scan["comps"]]
        out += _segment(0xDA, bytes([len(scomps)]) + b"".join(bytes([comps[ci].id, 0])
                                                              for ci in scomps)
                        + bytes([scan["ss"], scan["se"], (scan["ah"] << 4) | scan["al"]]))
        out += _arith_scan(comps, scomps, frame, restart, scan, L, U, K)
    return bytes(out + b"\xff\xd9")


# --- BMP ---------------------------------------------------------------------

def bmp_file(data: bytes, w: int, h: int, bpp: int, compression: int = 0, palette=None,
             header: int = 40, masks=None, clrused: int | None = None) -> bytes:
    """A BMP of already-laid-out pixel data (rows bottom-up unless h < 0):
    header 12 (OS/2, palette entries of 3 bytes, 16-bit sizes) or 40-124
    (masks after a 40-byte header, inside a longer one)."""
    pal = b""
    if palette is not None:
        p = np.asarray(palette, np.uint8)
        pal = (p if header == 12 else np.concatenate([p, np.zeros((len(p), 1), np.uint8)], 1)
               ).tobytes()
    if header == 12:
        info = struct.pack("<HhHH", w, h, 1, bpp)
        extra = b""
    else:
        n_pal = 0 if palette is None else len(palette)
        info = struct.pack("<iiHHIIiiII", w, h, 1, bpp, compression, len(data), 2835, 2835,
                           n_pal if clrused is None else clrused, 0)
        extra = b""
        if header == 40 and masks is not None:
            extra = struct.pack("<III", *masks[:3])
        elif header > 40:
            info += struct.pack("<4I", *(list(masks or (0, 0, 0, 0)) + [0] * 4)[:4])
            info += b"\0" * (header - 4 - 40 - 16)
    off = 14 + 4 + len(info) + len(extra) + len(pal)
    return (b"BM" + struct.pack("<IHHI", off + len(data), 0, 0, off) + struct.pack("<I", header)
            + info + extra + pal + data)


def bmp_rows(rows: np.ndarray) -> bytes:
    """[h, bytes] rows, each padded to 4 bytes, bottom-up."""
    h, n = rows.shape
    pad = np.zeros((h, (-n) % 4), np.uint8)
    return np.concatenate([rows.astype(np.uint8), pad], 1)[::-1].tobytes()


def bmp_rle(idx: np.ndarray, bpp: int, deltas: bool = False, absolute: bool = True,
            end: bool = True) -> bytes:
    """RLE8 (bpp 8) or RLE4 (bpp 4) data of an index image ([h, w]),
    bottom-up: runs of equal indices (RLE4: of alternating pairs), literal
    stretches in absolute mode, an end of line after each row, an end of
    bitmap last; `deltas` replaces each row's index-0 stretches of 6 or more
    pixels at its end... by a delta jump."""
    out = bytearray()
    h, w = idx.shape
    for r in range(h - 1, -1, -1):
        row = [int(v) for v in idx[r]]
        x = 0
        while x < w:
            n = 1
            if bpp == 8:
                while x + n < w and row[x + n] == row[x] and n < 255:
                    n += 1
            else:
                while x + n < w and row[x + n] == row[x + (n % 2)] and n < 255:
                    n += 1
            if deltas and row[x] == 0 and n >= 6 and x + n < w:
                out += bytes([0, 2, n, 0])
                x += n
                continue
            if n >= 3 or not absolute:
                val = row[x] if bpp == 8 else (row[x] << 4) | (row[x + 1] if n > 1 else 0)
                out += bytes([n, val])
                x += n
                continue
            m = 0
            while x + m < w and m < 255:
                k = 1
                while x + m + k < w and row[x + m + k] == row[x + m] and k < 3:
                    k += 1
                if k >= 3:
                    break
                m += 1
            if m < 3:
                val = row[x] if bpp == 8 else (row[x] << 4)
                out += bytes([1, val])
                x += 1
                continue
            lit = row[x:x + m]
            if bpp == 8:
                body = bytes(lit)
            else:
                lit = lit + [0] * (m % 2)
                body = bytes((a << 4) | b for a, b in zip(lit[0::2], lit[1::2]))
            out += bytes([0, m]) + body + b"\0" * (len(body) % 2)
            x += m
        if r:
            out += b"\0\0"
    if end:
        out += b"\0\1"
    return bytes(out)


def jpeg_split_tables(jpeg: bytes) -> tuple[bytes, bytes]:
    """(abbreviated table stream: SOI, DQT, DHT, EOI; the rest: SOI and
    every other marker and the data) of a JPEG stream."""
    tables, rest, pos = bytearray(b"\xff\xd8"), bytearray(b"\xff\xd8"), 2
    while pos < len(jpeg):
        m = jpeg[pos + 1]
        if m == 0xDA:
            return bytes(tables + b"\xff\xd9"), bytes(rest + jpeg[pos:])
        (length,) = struct.unpack(">H", jpeg[pos + 2:pos + 4])
        (tables if m in (0xDB, 0xC4) else rest).extend(jpeg[pos:pos + 2 + length])
        pos += 2 + length
    raise ValueError("no scan")


def tiff_jpeg(px, encode, photometric: int, rows_per_strip=None, tile=None, sampling=(1, 1),
              tables: bool = True, tall_last: bool = False, bo: str = "II") -> bytes:
    """A JPEG-compressed TIFF: each strip or tile (edge tiles padded by
    repeating the edge) coded by `encode(block) -> JPEG bytes`, its tables
    moved to JPEGTables when `tables`.  `tall_last`: the last strip's
    stream keeps the full strip height."""
    px = np.asarray(px, np.uint8)
    if px.ndim == 2:
        px = px[..., None]
    h, w, c = px.shape
    streams = []
    if tile:
        tw, th = tile
        for y in range(0, h, th):
            for x in range(0, w, tw):
                sub = px[y:y + th, x:x + tw]
                streams.append(encode(np.pad(sub, ((0, th - sub.shape[0]),
                                                   (0, tw - sub.shape[1]), (0, 0)), "edge")))
    else:
        rps = rows_per_strip or h
        for y in range(0, h, rps):
            sub = px[y:y + rps]
            if tall_last and sub.shape[0] < rps:
                sub = np.pad(sub, ((0, rps - sub.shape[0]), (0, 0), (0, 0)), "edge")
            streams.append(encode(sub))
    tags = {256: (LONG, [w]), 257: (LONG, [h]), 258: (SHORT, [8] * c), 259: (SHORT, [7]),
            262: (SHORT, [photometric]), 277: (SHORT, [c]), 284: (SHORT, [1])}
    if photometric == 6:
        tags[530] = (SHORT, list(sampling))
    if tables:
        tabs = [jpeg_split_tables(s) for s in streams]
        tags[347] = (UNDEFINED, list(tabs[0][0]))
        streams = [s for _, s in tabs]
    if tile:
        tags[322], tags[323] = (SHORT, [tile[0]]), (SHORT, [tile[1]])
    else:
        tags[278] = (LONG, [rows_per_strip or h])
    return tiff_file(streams, tags, bo, tiled=bool(tile))



# --- Sun raster --------------------------------------------------------------

def sun_rle(data: bytes) -> bytes:
    """Sun's byte-encoded RLE: a run of n + 1 (n < 256) equal bytes is 0x80 n
    v, a lone 0x80 is 0x80 0x00, anything else itself."""
    out = bytearray()
    i = 0
    while i < len(data):
        v = data[i]
        n = 1
        while i + n < len(data) and data[i + n] == v and n < 256:
            n += 1
        if n >= 3 or v == 0x80:
            if n == 1:
                out += b"\x80\x00"
            else:
                out += bytes([0x80, n - 1, v])
        else:
            out += bytes([v]) * n
        i += n
    return bytes(out)


def sun_raster(px: np.ndarray, depth: int, ras_type: int = 1, palette=None,
               rle_rows: bool = False) -> bytes:
    """A Sun raster file.  `px`: [h, w] indices (1 or 8 bits) or [h, w, 3|4]
    samples in the order they are stored (BGR(X) for type 1 / 2, RGB(X) for
    type 3); `palette` [n, 3] RGB.  Rows are padded to 16 bits; type 2 codes
    the padded data with `sun_rle` (`rle_rows`: each row coded alone)."""
    h, w = px.shape[:2]
    if depth == 1:
        rows = pack_bits(px.reshape(h, w).astype(np.uint8), 1)
    else:
        rows = px.reshape(h, -1).astype(np.uint8)
    if rows.shape[1] % 2:
        rows = np.concatenate([rows, np.zeros((h, 1), np.uint8)], 1)
    body = rows.tobytes()
    if ras_type == 2:
        body = (b"".join(sun_rle(r.tobytes()) for r in rows) if rle_rows
                else sun_rle(body))
    cmap = b""
    if palette is not None:
        cmap = np.ascontiguousarray(np.asarray(palette, np.uint8).T).tobytes()
    head = struct.pack(">8I", 0x59A66A95, w, h, depth, len(body), ras_type,
                       1 if palette is not None else 0, len(cmap))
    return head + cmap + body


# --- Radiance HDR --------------------------------------------------------------

def rgbe(rgb: np.ndarray) -> np.ndarray:
    """float [..., 3] RGB -> [..., 4] RGBE bytes as Radiance's float2rgbe."""
    v = rgb.max(-1)
    m, e = np.frexp(v)
    scale = np.where(v > 1e-32, m * 256.0 / np.where(v > 0, v, 1), 0)
    out = np.zeros(rgb.shape[:-1] + (4,), np.uint8)
    out[..., :3] = np.clip(rgb * scale[..., None], 0, 255).astype(np.uint8)
    out[..., 3] = np.where(v > 1e-32, e + 128, 0)
    return out


def _hdr_rle_channel(c: bytes) -> bytes:
    out = bytearray()
    i = 0
    while i < len(c):
        run = 1
        while i + run < len(c) and c[i + run] == c[i] and run < 127:
            run += 1
        if run >= 4:
            out += bytes([128 + run, c[i]])
            i += run
            continue
        j = i
        while j < len(c) and j - i < 128:
            if j + 3 < len(c) and c[j] == c[j + 1] == c[j + 2] == c[j + 3]:
                break
            j += 1
        out += bytes([j - i]) + c[i:j]
        i = j
    return bytes(out)


def hdr_file(px: np.ndarray, coding: str = "rle", header: bytes | None = None,
             size_line: bytes | None = None) -> bytes:
    """A Radiance file of RGBE pixels `px` [h, w, 4] uint8.  `coding`:
    "flat" (4 bytes a pixel), "rle" (new-style: 2 2 w>>8 w&255, then each
    channel run-length coded) or "old" (old-style runs: 1 1 1 n repeats the
    last pixel n times).  `header`: the lines before the blank line."""
    h, w = px.shape[:2]
    head = header if header is not None else b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n"
    size = size_line if size_line is not None else f"-Y {h} +X {w}\n".encode()
    body = bytearray()
    for row in px.astype(np.uint8):
        if coding == "rle":
            body += bytes([2, 2, w >> 8, w & 255])
            for c in range(4):
                body += _hdr_rle_channel(row[:, c].tobytes())
        elif coding == "old":
            k = 0
            while k < w:
                body += row[k].tobytes()
                n = 1
                while k + n < w and (row[k + n] == row[k]).all() and n < 255:
                    n += 1
                if n > 1:
                    body += bytes([1, 1, 1, n - 1])
                k += n
        else:
            body += row.tobytes()
    return head + b"\n" + size + bytes(body)


# --- GIF -------------------------------------------------------------------------

def gif_lzw(idx: bytes, min_size: int, clear_every: int = 0) -> bytes:
    """GIF's variable-width LZW of palette indices, LSB-first codes, a clear
    code first, when the table is full and (`clear_every` > 0) every that
    many indices; the end code last."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    out = bytearray()
    acc = nbits = 0

    def put(code, width):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8

    def reset():
        return {bytes([i]): i for i in range(min(1 << min_size, 256))}, end + 1, min_size + 1

    table, nxt, width = reset()
    put(clear, width)
    cur = b""
    since = 0
    for k in range(len(idx)):
        c = idx[k:k + 1]
        if clear_every and since == clear_every:
            if cur:
                put(table[cur], width)
                cur = b""
            put(clear, width)
            table, nxt, width = reset()
            since = 0
        since += 1
        if cur + c in table:
            cur += c
            continue
        put(table[cur], width)
        if nxt < 4096:
            table[cur + c] = nxt
            nxt += 1
            if nxt > (1 << width) and width < 12:
                width += 1
        else:
            put(clear, width)
            table, nxt, width = reset()
        cur = c
    if cur:
        put(table[cur], width)
    put(end, width)
    if nbits:
        out.append(acc & 255)
    return bytes(out)


def gif_sub_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\0"


def gif_file(frames, w: int, h: int, palette=None, background: int = 0,
             version: bytes = b"GIF89a", loop: bool = False) -> bytes:
    """A GIF of `frames`: dicts of `idx` [fh, fw] palette indices and
    optional `left`, `top`, `palette` (local, [n, 3] RGB, n a power of 2),
    `interlace`, `transparent` (index), `disposal`, `delay`, `min_size`,
    `clear_every`.  `palette`: the global one ([n, 3] RGB) or None."""
    def table(p):
        p = np.asarray(p, np.uint8)
        bits = max(1, int(np.ceil(np.log2(len(p)))))
        full = np.zeros((1 << bits, 3), np.uint8)
        full[:len(p)] = p
        return bits, full.tobytes()

    flags, gct = 0, b""
    if palette is not None:
        bits, gct = table(palette)
        flags = 0x80 | ((bits - 1) << 4) | (bits - 1)
    out = bytearray(version + struct.pack("<HHBBB", w, h, flags, background, 0) + gct)
    if loop:
        out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"
    for f in frames:
        idx = np.asarray(f["idx"], np.uint8)
        fh, fw = idx.shape
        if "transparent" in f or "disposal" in f or "delay" in f:
            t = f.get("transparent")
            packed = (f.get("disposal", 0) << 2) | (t is not None)
            out += b"\x21\xf9\x04" + struct.pack("<BHB", packed, f.get("delay", 0), t or 0) + b"\0"
        lflags, lct = 0, b""
        if f.get("palette") is not None:
            bits, lct = table(f["palette"])
            lflags = 0x80 | (bits - 1)
        if f.get("interlace"):
            lflags |= 0x40
            order = [*range(0, fh, 8), *range(4, fh, 8), *range(2, fh, 4), *range(1, fh, 2)]
            idx = idx[order]
        out += b"\x2c" + struct.pack("<HHHHB", f.get("left", 0), f.get("top", 0), fw, fh, lflags) + lct
        size = f.get("min_size", max(2, int(np.ceil(np.log2(max(int(idx.max()) + 1, 2))))))
        out += bytes([size]) + gif_sub_blocks(gif_lzw(idx.tobytes(), size, f.get("clear_every", 0)))
    return bytes(out) + b"\x3b"


# --- WebP --------------------------------------------------------------------------

def webp_riff(chunks) -> bytes:
    """A RIFF / WEBP file of (fourcc, payload) chunks, each padded to even."""
    body = b"".join(tag + struct.pack("<I", len(p)) + p + b"\0" * (len(p) & 1)
                    for tag, p in chunks)
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def webp_chunks(data: bytes) -> list:
    """The (fourcc, payload) chunks of a RIFF / WEBP file."""
    out, pos = [], 12
    while pos + 8 <= len(data):
        tag = data[pos:pos + 4]
        (size,) = struct.unpack("<I", data[pos + 4:pos + 8])
        out.append((tag, data[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def vp8x(w: int, h: int, flags: int) -> tuple:
    return (b"VP8X", bytes([flags, 0, 0, 0]) + (w - 1).to_bytes(3, "little")
            + (h - 1).to_bytes(3, "little"))


def alpha_filter(a: np.ndarray, method: int) -> np.ndarray:
    """libwebp's forward alpha filters (0 none, 1 horizontal, 2 vertical, 3
    gradient): the residuals its unfilters undo."""
    a = a.astype(np.int32)
    h, w = a.shape
    pred = np.zeros_like(a)
    if method == 0:
        return a.astype(np.uint8)
    pred[0, 1:] = a[0, :-1]
    pred[1:, 0] = a[:-1, 0]
    if method == 1:
        pred[1:, 1:] = a[1:, :-1]
    elif method == 2:
        pred[1:, 1:] = a[:-1, 1:]
    else:
        pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
    return ((a - pred) & 255).astype(np.uint8)


def alph_chunk(a: np.ndarray, compression: int, filt: int, vp8l_encode=None,
               preprocessing: int = 0) -> tuple:
    """An ALPH chunk: raw (compression 0) or VP8L-coded (1: `vp8l_encode`
    maps an [h, w, 3] uint8 RGB image to a whole VP8L chunk payload, whose
    5-byte header is dropped; the residuals go in green)."""
    r = alpha_filter(a, filt)
    head = bytes([compression | (filt << 2) | (preprocessing << 4)])
    if compression == 0:
        return (b"ALPH", head + r.tobytes())
    rgb = np.zeros(r.shape + (3,), np.uint8)
    rgb[..., 1] = r
    return (b"ALPH", head + vp8l_encode(rgb)[5:])


def bool_encode(seq) -> bytes:
    """VP8's boolean encoder (libvpx's vp8_encode_bool) over (prob, bit)
    pairs, flushed with 32 zero bits at even odds."""
    out = bytearray()
    low, rng, count = 0, 255, -24
    norm = [0] + [7 ^ (r.bit_length() - 1) for r in range(1, 256)]
    for prob, bit in list(seq) + [(128, 0)] * 32:
        split = 1 + (((rng - 1) * prob) >> 8)
        if bit:
            low += split
            rng -= split
        else:
            rng = split
        shift = norm[rng]
        rng <<= shift
        count += shift
        if count >= 0:
            offset = shift - count
            if (low << (offset - 1)) & 0x80000000:
                x = len(out) - 1
                while x >= 0 and out[x] == 0xFF:
                    out[x] = 0
                    x -= 1
                out[x] += 1
            out.append((low >> (24 - offset)) & 0xFF)
            low = (low << offset) & 0xFFFFFF
            shift = count
            count -= 8
        low <<= shift
    return bytes(out)


def _flag(b) -> list:
    return [(128, int(bool(b)))]


def _bits(v: int, n: int) -> list:
    return [(128, (v >> k) & 1) for k in range(n - 1, -1, -1)]


def _opt_signed(v: int, n: int) -> list:
    return _flag(v) + (_bits(abs(v), n) + _flag(v < 0) if v else [])


def vp8_rewrite(frame: bytes, segment: dict | None = None, filt: dict | None = None,
                quant: dict | None = None) -> bytes:
    """A VP8 frame (a VP8 chunk's payload) whose first partition is coded
    again with some header fields changed: `segment` (absolute, quant [4],
    filter [4]; a frame whose segment header updates its data), `filt`
    (simple, level, sharpness, ref [4], mode [4]: deltas on when given) or
    `quant` (base, deltas [5]).  The macroblock modes and the token
    partitions are kept, so the frame stays valid and decodes otherwise."""
    from kgtpu_torch.data import vp8 as V
    rec = []

    class Rec(V.BoolDecoder):
        def bit(self, prob):
            b = super().bit(prob)
            rec.append((prob, b))
            return b

    w, h, part0 = V._header(frame, len(frame))
    br = Rec(frame[10:10 + part0])
    br.bit(0x80)
    br.bit(0x80)
    a = len(rec)
    seg = V._segment_header(br)
    b = len(rec)
    f = V._filter_header(br)
    c = len(rec)
    br.value_bits(2)
    d = len(rec)
    V._quant(br, seg)
    e = len(rec)
    br.bit(0x80)
    V._probas(br)
    skip_p = br.value_bits(8) if br.bit(0x80) else None
    V._modes(br, (w + 15) >> 4, (h + 15) >> 4, seg, skip_p)
    seg_bits = rec[a:b]
    if segment is not None:
        if not (seg["use"] and len(rec[a:b]) > 3 and rec[a + 2][1]):
            raise ValueError("the frame's segment header carries no data to change")
        seg_bits = _flag(1) + _flag(seg["update_map"]) + _flag(1) + _flag(segment["absolute"])
        seg_bits += sum((_opt_signed(q, 7) for q in segment["quant"]), [])
        seg_bits += sum((_opt_signed(q, 6) for q in segment["filter"]), [])
        if seg["update_map"]:
            seg_bits += sum((_flag(p != 255) + (_bits(p, 8) if p != 255 else [])
                             for p in seg["proba"]), [])
    filt_bits = rec[b:c]
    if filt is not None:
        g = {**{k: f[k] for k in ("simple", "level", "sharpness")}, **filt}
        filt_bits = _flag(g["simple"]) + _bits(g["level"], 6) + _bits(g["sharpness"], 3)
        if "ref" in filt or "mode" in filt:
            filt_bits += _flag(1) + _flag(1)
            filt_bits += sum((_opt_signed(v, 6) for v in filt.get("ref", [0] * 4)), [])
            filt_bits += sum((_opt_signed(v, 6) for v in filt.get("mode", [0] * 4)), [])
        else:
            filt_bits += _flag(0)
    quant_bits = rec[d:e]
    if quant is not None:
        quant_bits = _bits(quant["base"], 7) + sum((_opt_signed(v, 4) for v in quant["deltas"]), [])
    seq = rec[:a] + seg_bits + filt_bits + rec[c:d] + quant_bits + rec[e:]
    p0 = bool_encode(seq)
    tag = (frame[0] | frame[1] << 8 | frame[2] << 16) & 0x1F
    tag |= len(p0) << 5
    return bytes([tag & 255, (tag >> 8) & 255, tag >> 16]) + frame[3:10] + p0 + frame[10 + part0:]


# --- PNM / PAM ---------------------------------------------------------------------

def pam_file(px: np.ndarray, tupltype: str | None, maxval: int = 255,
             comment: bytes = b"") -> bytes:
    """A P7 file of [h, w] or [h, w, depth] samples (big-endian words when
    maxval > 255), with an optional TUPLTYPE line and comment lines."""
    px = px.reshape(px.shape[0], px.shape[1], -1)
    h, w, depth = px.shape
    head = f"P7\nWIDTH {w}\nHEIGHT {h}\nDEPTH {depth}\nMAXVAL {maxval}\n".encode() + comment
    if tupltype is not None:
        head += f"TUPLTYPE {tupltype}\n".encode()
    body = px.astype(">u2" if maxval > 255 else np.uint8).tobytes()
    return head + b"ENDHDR\n" + body


def pbm_p4(black: np.ndarray, comment: bytes = b"") -> bytes:
    """A binary PBM of a [h, w] bool image (True black), rows padded to a
    byte, with optional comment lines after the magic number."""
    h, w = black.shape
    return (b"P4\n" + comment + f"{w} {h}\n".encode()
            + pack_bits(black.astype(np.uint8), 1).tobytes())


# --- JPEG 2000 ----------------------------------------------------------------

def jpeg2000_random(rng, maxsize: int = 64):
    """A random JPEG 2000 file written by PIL (OpenJPEG): size 1..maxsize,
    mode (RGB, L, RGBA, LA, 16-bit grey), random or smooth content, the 5/3
    or 9/7 wavelet, resolutions, code-block and precinct sizes, tiles, the
    progression, rated quality layers, the colour transform, JP2 or a raw
    codestream, PLT markers; and its description.  (None, None) when PIL
    refuses the options."""
    import io

    from PIL import Image
    h, w = (int(v) for v in rng.integers(1, maxsize + 1, 2))
    mode = str(rng.choice(["RGB", "L", "RGBA", "LA", "I;16", "RGB", "RGB"]))
    y, x = np.mgrid[:h, :w]
    if rng.random() < 0.5:
        base = rng.integers(0, 256, (h, w, 4))
    else:
        f = rng.uniform(0.05, 0.5, 4)
        base = np.stack([128 + 120 * np.sin(x * f[k] + y * f[(k + 1) % 4] + k)
                         for k in range(4)], -1)
    base = np.clip(base, 0, 255).astype(np.uint8)
    arr = {"RGB": base[..., :3], "L": base[..., 0], "RGBA": base, "LA": base[..., :2],
           "I;16": base[..., 0].astype(np.uint16) * 256 + base[..., 1]}[mode]
    kw: dict = {}
    if rng.random() < 0.5:
        kw["irreversible"] = True
    if rng.random() < 0.5:
        kw["num_resolutions"] = int(rng.integers(1, 8))
    if rng.random() < 0.3:
        kw["codeblock_size"] = tuple(int(2 ** rng.integers(2, 7)) for _ in range(2))
    if rng.random() < 0.3:
        kw["precinct_size"] = tuple(int(2 ** rng.integers(4, 8)) for _ in range(2))
    if rng.random() < 0.3:
        kw["tile_size"] = tuple(int(rng.integers(8, max(9, maxsize + 1))) for _ in range(2))
    if rng.random() < 0.5:
        kw["progression"] = str(rng.choice(["LRCP", "RLCP", "RPCL", "PCRL", "CPRL"]))
    if rng.random() < 0.5:
        kw["quality_mode"] = "rates"
        kw["quality_layers"] = sorted([float(rng.uniform(2, 60))
                                       for _ in range(int(rng.integers(1, 4)))], reverse=True)
    if rng.random() < 0.2:
        kw["mct"] = 0
    if rng.random() < 0.3:
        kw["no_jp2"] = True
    if rng.random() < 0.2:
        kw["plt"] = True
    if kw.get("irreversible"):
        # OpenJPEG's 9/7 encoder asserts on a signal of one sample: keep
        # every tile's sides above 2^(levels - 1)
        tw, th = kw.get("tile_size", (w, h))
        sides = [min(h, th), min(w, tw), (h % th) or th, (w % tw) or tw]
        levels = int(np.floor(np.log2(min(sides))))
        kw["num_resolutions"] = max(1, min(kw.get("num_resolutions", 6), levels + 1))
    buf = io.BytesIO()
    try:
        Image.fromarray(arr, "LA" if mode == "LA" else None).save(buf, "JPEG2000", **kw)
    except OSError:
        return None, None
    return buf.getvalue(), (h, w, mode, kw)


def jpeg2000_packed_headers(cs: bytes, marker: str = "ppt") -> bytes:
    """A raw codestream (one tile-part a tile, no SOP / EPH) rewritten with
    its packet headers moved out of the tile data into PPT markers (one
    set a tile) or PPM markers (the main header's, one Nppm record a
    tile-part); the packets are found with the port's tier-2
    (`kgtpu_torch.data.jpeg2000.tile_packets`), and cv2 reading the result
    as it reads `cs` is the check that they were."""
    from kgtpu_torch.data.jpeg2000 import SOT, Codestream, tile_packets
    c = Codestream(cs)
    main_end = cs.index(struct.pack(">H", SOT))
    parts = []
    for tno in c.parts:
        data = c.tiles[tno]["data"][0]
        spans: list = []
        tile_packets(c, tno, {}, spans)
        heads = b"".join(data[a:b] for a, b, _ in spans)
        bodies = b"".join(data[b:e] for _, b, e in spans)
        parts.append((tno, heads, bodies))

    def segments(code: int, body: bytes, index_bytes: int = 1) -> bytes:
        out, k = b"", 0
        for at in range(0, max(len(body), 1), 60000):
            chunk = body[at:at + 60000]
            out += struct.pack(">HHB", code, 3 + len(chunk), k) + chunk
            k += 1
        return out
    head = cs[:main_end]
    if marker == "ppm":
        head += segments(0xFF60, b"".join(struct.pack(">I", len(h)) + h for _, h, _ in parts))
    out = head
    for tno, heads, bodies in parts:
        tile_head = segments(0xFF61, heads) if marker == "ppt" else b""
        psot = 12 + len(tile_head) + 2 + len(bodies)
        out += struct.pack(">HHHIBB", SOT, 10, tno, psot, 0, 1) + tile_head + b"\xff\x93" + bodies
    return out + b"\xff\xd9"


def jpeg2000_eph(cs: bytes, drop: int | None = None) -> bytes:
    """A raw codestream (one tile-part a tile, no SOP / EPH) rewritten with
    COD's EPH flag and an EPH marker after every packet header (empty
    packets too), but the one of packet `drop` (counted over the whole
    codestream, negative from its end); the packets are found with the
    port's tier-2 as in `jpeg2000_packed_headers`."""
    from kgtpu_torch.data.jpeg2000 import COD, SOT, Codestream, tile_packets
    c = Codestream(cs)
    main_end = cs.index(struct.pack(">H", SOT))
    tiles = []
    for tno in c.parts:
        spans: list = []
        tile_packets(c, tno, {}, spans)
        tiles.append((tno, c.tiles[tno]["data"][0], spans))
    n = sum(len(sp) for _, _, sp in tiles)
    skip = None if drop is None else drop % n
    head = bytearray(cs[:main_end])
    at = head.index(struct.pack(">H", COD))
    head[at + 4] |= 0x04
    out, k = bytes(head), 0
    for tno, data, spans in tiles:
        body = b""
        for a, b, e in spans:
            body += data[a:b] + (b"" if k == skip else b"\xff\x92") + data[b:e]
            k += 1
        psot = 12 + 2 + len(body)
        out += struct.pack(">HHHIBB", SOT, 10, tno, psot, 0, 1) + b"\xff\x93" + body
    return out + b"\xff\xd9"


_OPJ: list = []


def _openjp2():
    """PIL's libopenjp2 (found by pattern under pillow.libs), once."""
    if not _OPJ:
        import ctypes
        import glob
        import os

        import PIL
        libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
        found = sorted(glob.glob(os.path.join(libs, "libopenjp2-*.so*")))
        if not found:
            raise OSError(f"no libopenjp2 under {libs}")
        lib = ctypes.CDLL(found[0])
        vp = ctypes.c_void_p
        lib.opj_image_create.restype = vp
        lib.opj_image_create.argtypes = [ctypes.c_uint32, vp, ctypes.c_int]
        lib.opj_create_compress.restype = vp
        lib.opj_setup_encoder.argtypes = [vp, vp, vp]
        lib.opj_stream_create_default_file_stream.restype = vp
        lib.opj_stream_create_default_file_stream.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.opj_start_compress.argtypes = [vp, vp, vp]
        lib.opj_encode.argtypes = [vp, vp]
        lib.opj_end_compress.argtypes = [vp, vp]
        for f in ("opj_stream_destroy", "opj_destroy_codec", "opj_image_destroy"):
            getattr(lib, f).argtypes = [vp]
        _OPJ.append(lib)
    return _OPJ[0]


def jpeg2000_opj(px: np.ndarray, prec: int = 8, irreversible: bool = False, layers=(),
                 resolutions: int = 6, cblk: tuple = (64, 64), style: int = 0,
                 mct: bool | None = None, jp2: bool = False) -> bytes:
    """A JPEG 2000 codestream (or JP2 file) of `px` ([h, w] or [h, w, c],
    unsigned, `prec` bits) from libopenjp2's encoder through ctypes, which
    sets what PIL's writer leaves at 0: the code-block style (`style`, the
    COD's byte: 0x01 BYPASS, 0x02 RESET, 0x04 TERMALL, 0x08 VSC, 0x10
    PTERM, 0x20 SEGSYM, any mix).  `layers`: the quality layers' rates
    (compression ratios, falling; a last 0 is lossless), none for one
    lossless layer; `cblk` the code-block width and height; `mct` the
    colour transform (default: on for 3 components).

    The encoder's parameters are a 64 KiB buffer filled by
    `opj_set_default_encoder_parameters` and patched in place: the fields
    sit where openjpeg.h 2.5 puts them, found from `numresolution`,
    `cblockw_init`, `cblockh_init` (its 6, 64, 64): `mode` and
    `irreversible` after them, `tcp_numlayers`, `tcp_rates` and
    `tcp_distoratio` before them, `cp_disto_alloc` at byte 20 and
    `tcp_mct` where the JPWL fields end."""
    import ctypes
    import os
    import tempfile

    lib = _openjp2()
    px = np.asarray(px)
    planes = px[..., None] if px.ndim == 2 else px
    h, w, nc = planes.shape
    raw = ctypes.create_string_buffer(65536)
    lib.opj_set_default_encoder_parameters(raw)
    ints = np.frombuffer(raw, np.int32).copy()
    at = int(next(i for i in range(len(ints) - 2)
                  if (ints[i], ints[i + 1], ints[i + 2]) == (6, 64, 64)))
    ints[at:at + 5] = [resolutions, cblk[0], cblk[1], style, int(irreversible)]
    if layers:
        ints[at - 201] = len(layers)                          # tcp_numlayers
        rates = np.zeros(100, np.float32)
        rates[:len(layers)] = layers
        ints[at - 200:at - 100] = rates.view(np.int32)        # tcp_rates
        ints[5] = 1                                           # cp_disto_alloc
    ctypes.memmove(raw, ints.tobytes(), ints.nbytes)
    # tcp_mct: after the prc sizes, file names, index, offsets, subsampling,
    # formats, 118 JPWL ints, cp_cinema, max_comp_size, cp_rsiz, tp_on, tp_flag
    sub = at + 5 + 3 + 66 + 1024 + 1024 + 1 + 1024 + 2
    assert tuple(ints[sub:sub + 4]) == (1, 1, -1, -1), "unexpected opj_cparameters_t layout"
    raw[(sub + 4 + 118 + 3) * 4 + 2] = int(nc >= 3 if mct is None else mct)
    cmpt = (ctypes.c_uint32 * (9 * nc))()
    for c in range(nc):
        cmpt[9 * c:9 * c + 9] = [1, 1, w, h, 0, 0, prec, prec, 0]
    space = 1 if nc >= 3 else 2                               # sRGB, grey
    img = lib.opj_image_create(nc, ctypes.cast(cmpt, ctypes.c_void_p), space)
    head = (ctypes.c_uint32 * 4).from_address(img)
    head[:] = [0, 0, w, h]
    comps = ctypes.c_void_p.from_address(img + 24).value
    for c in range(nc):
        data = ctypes.c_void_p.from_address(comps + 64 * c + 48).value
        vals = np.ascontiguousarray(planes[..., c], np.int32)
        ctypes.memmove(data, vals.ctypes.data, vals.nbytes)
    codec = lib.opj_create_compress(2 if jp2 else 0)
    fd, path = tempfile.mkstemp(suffix=".j2k")
    os.close(fd)
    stream = None
    try:
        if not lib.opj_setup_encoder(codec, raw, img):
            raise ValueError("libopenjp2 refused the parameters")
        stream = lib.opj_stream_create_default_file_stream(path.encode(), 0)
        if not (lib.opj_start_compress(codec, img, stream) and lib.opj_encode(codec, stream)
                and lib.opj_end_compress(codec, stream)):
            raise ValueError("libopenjp2 failed to encode")
        lib.opj_stream_destroy(stream)
        stream = None
        with open(path, "rb") as f:
            return f.read()
    finally:
        if stream is not None:
            lib.opj_stream_destroy(stream)
        lib.opj_destroy_codec(codec)
        lib.opj_image_destroy(img)
        os.remove(path)


def jpeg2000_random_styles(rng, maxsize: int = 64, encode=None):
    """A random `jpeg2000_opj` file: size 1..maxsize, 1, 3 or 4 components
    of 8, 12 or 16 bits, random or smooth content, the 5/3 or 9/7 wavelet,
    1-3 quality layers, resolutions, code-block size, any code-block style
    (0-63), the colour transform, JP2 or a raw codestream; and its
    description.  (None, None) where the encoder refuses the options.
    `encode` (jpeg2000_opj's signature) replaces the call, as the probe's
    forked one does: libopenjp2's encoder can overrun its heap on noise
    with TERMALL."""
    h, w = (int(v) for v in rng.integers(1, maxsize + 1, 2))
    nc = int(rng.choice([1, 1, 3, 4]))
    prec = int(rng.choice([8, 8, 12, 16]))
    top = (1 << prec) - 1
    y, x = np.mgrid[:h, :w]
    if rng.random() < 0.4:
        px = rng.integers(0, top + 1, (h, w, nc))
    else:
        f = rng.uniform(0.05, 0.5, 4)
        px = np.stack([(0.5 + 0.45 * np.sin(x * f[k] + y * f[(k + 1) % 4] + k)) * top
                       for k in range(nc)], -1)
    px = np.clip(px, 0, top).astype(np.int64)
    irreversible = bool(rng.random() < 0.5)
    levels = int(np.floor(np.log2(min(h, w))))
    # the encoder wants 2^(resolutions - 1) samples a side (and the 9/7 one
    # asserts on a signal of one sample)
    resolutions = max(1, min(int(rng.integers(1, 8)), levels + 1))
    cw = int(2 ** rng.integers(2, 7))
    ch = int(2 ** rng.integers(2, min(7, 13 - int(np.log2(cw)))))
    layers = ()
    if rng.random() < 0.5:
        layers = tuple(sorted((float(rng.uniform(2, 60)) for _ in range(int(rng.integers(1, 4)))),
                              reverse=True))
        if rng.random() < 0.5:
            layers += (0.0,)
    kw = {"prec": prec, "irreversible": irreversible, "layers": layers,
          "resolutions": resolutions, "cblk": (cw, ch), "style": int(rng.integers(0, 64)),
          "mct": bool(rng.random() < 0.8) if nc >= 3 else False,
          "jp2": bool(rng.random() < 0.5)}
    try:
        data = (encode or jpeg2000_opj)(px[..., 0] if nc == 1 else px, **kw)
    except ValueError:
        return None, None
    return data, (h, w, nc, kw)


def mh_row(bits: np.ndarray) -> str:
    """One row of 0 / 1 samples (1 black) as T.4 modified Huffman codes
    (white run first, make-up codes for runs of 64 and more), a bit
    string."""
    from kgtpu_torch.data.ccitt import (_BLACK_MAKEUP, _BLACK_TERM, _EXT_MAKEUP,
                                        _WHITE_MAKEUP, _WHITE_TERM)
    out, color, x, w = [], 0, 0, len(bits)
    while x < w or color == 0 and x == 0 and w == 0:
        end = x
        while end < w and bits[end] == color:
            end += 1
        run = end - x
        term, makeup = (_BLACK_TERM, _BLACK_MAKEUP) if color else (_WHITE_TERM, _WHITE_MAKEUP)
        while run >= 64:
            m = min(run // 64, 40)
            out.append((makeup + _EXT_MAKEUP)[m - 1] if m <= 27 else _EXT_MAKEUP[m - 28])
            run -= 64 * m
        out.append(term[run])
        x, color = end, color ^ 1
        if x >= w:
            break
    return "".join(out)


def tiff_ccitt_rlew(black: np.ndarray, fill_order: int = 1, rows_per_strip=None,
                    words: bool = True) -> bytes:
    """A bilevel TIFF (MinIsWhite, 1 black) coded CCITT RLEW (32771; each row
    padded to 16 bits of the strip) or, with `words` False, CCITT RLE (2;
    padded to a byte)."""
    h, w = black.shape
    rps = rows_per_strip or h
    strips = []
    for y in range(0, h, rps):
        s = ""
        for row in black[y:y + rps]:
            s += mh_row(row.astype(np.uint8))
            s += "0" * (-len(s) % (16 if words else 8))
        b = np.packbits(np.array([int(c) for c in s] or [0], np.uint8)[:len(s)] if s else
                        np.zeros(0, np.uint8), bitorder="little" if fill_order == 2 else "big")
        strips.append(b.tobytes())
    t = {256: (LONG, [w]), 257: (LONG, [h]), 258: (SHORT, [1]),
         259: (SHORT, [32771 if words else 2]), 262: (SHORT, [0]), 266: (SHORT, [fill_order]),
         277: (SHORT, [1]), 278: (LONG, [rps])}
    return tiff_file(strips, t)


def thunder_row(v: np.ndarray, rng=None) -> bytes:
    """One row of 4-bit samples as ThunderScan codes (`tif_thunder.c`): runs
    of the last pixel, 2- and 3-bit deltas from it and raw pixels, mixed at
    random (`rng`) or raw only."""
    out, last, i, n = bytearray(), 0, 0, len(v)
    d2 = {0: 0, 1: 1, -1: 3}
    d3 = {0: 0, 1: 1, 2: 2, 3: 3, -3: 5, -2: 6, -1: 7}
    while i < n:
        k = int(rng.integers(0, 4)) if rng is not None else 3
        run = 0
        while i + run < n and v[i + run] == last and run < 63:
            run += 1
        if k == 0 and run >= 2 and i % 2 == 0:
            out.append(run)
            i += run
            continue
        if k == 1 and i + 2 < n and all(int(v[i + j]) - int(v[i + j - 1] if j else last) in d2
                                        for j in range(3)):
            prev, code = last, 0x40
            for j in range(3):
                code |= d2[int(v[i + j]) - prev] << (4 - 2 * j)
                prev = int(v[i + j])
            out.append(code)
            last, i = prev, i + 3
            continue
        if k == 2 and i + 1 < n and all(int(v[i + j]) - int(v[i + j - 1] if j else last) in d3
                                        for j in range(2)):
            prev, code = last, 0x80
            for j in range(2):
                code |= d3[int(v[i + j]) - prev] << (3 - 3 * j)
                prev = int(v[i + j])
            out.append(code)
            last, i = prev, i + 2
            continue
        out.append(0xC0 | int(v[i]))
        last, i = int(v[i]), i + 1
    return bytes(out)


def tiff_thunderscan(v: np.ndarray, photometric: int = 3, rng=None, rows_per_strip=None,
                     colormap=None) -> bytes:
    """A 4-bit TIFF coded ThunderScan (32809): [H, W] samples 0..15,
    palette (with `colormap`, 3 x 16 16-bit entries) or grey."""
    h, w = v.shape
    rps = rows_per_strip or h
    strips = [b"".join(thunder_row(r, rng) for r in v[y:y + rps]) for y in range(0, h, rps)]
    t = {256: (LONG, [w]), 257: (LONG, [h]), 258: (SHORT, [4]), 259: (SHORT, [32809]),
         262: (SHORT, [photometric]), 277: (SHORT, [1]), 278: (LONG, [rps])}
    if colormap is not None:
        t[320] = (SHORT, list(colormap))
    return tiff_file(strips, t)


def tiff_next(v: np.ndarray, photometric: int = 1, colormap=None) -> bytes:
    """A 2-bit TIFF coded NeXT (32766), every row stored literally (code
    0x00 followed by the row's packed bytes)."""
    h, w = v.shape
    rows = b"".join(b"\x00" + pack_bits(r[None, :], 2).tobytes() for r in v)
    t = {256: (LONG, [w]), 257: (LONG, [h]), 258: (SHORT, [2]), 259: (SHORT, [32766]),
         262: (SHORT, [photometric]), 277: (SHORT, [1]), 278: (LONG, [h])}
    if colormap is not None:
        t[320] = (SHORT, list(colormap))
    return tiff_file([rows], t)


def sgilog_rle_row(words: np.ndarray, planes: int, rng=None) -> bytes:
    """One row of SGILog words as `tif_luv.c` codes them: each byte plane
    (most significant first) as runs (128 + n - 2, byte) of 3 or more equal
    bytes and literal chunks (n < 128, bytes); `rng` varies the chunking."""
    out = bytearray()
    for k in range(planes):
        plane = ((words >> (8 * (planes - 1 - k))) & 0xFF).astype(np.uint8).tobytes()
        i = 0
        while i < len(plane):
            run = 1
            while i + run < len(plane) and plane[i + run] == plane[i] and run < 129:
                run += 1
            if run >= 3:
                out += bytes([run + 126, plane[i]])
                i += run
                continue
            n = 1 if rng is None else int(rng.integers(1, 8))
            n = min(n if rng is not None else 127, len(plane) - i)
            out += bytes([n]) + plane[i:i + n]
            i += n
    return bytes(out)


def tiff_sgilog(words: np.ndarray, logl: bool = False, compression: int = 34676,
                rows_per_strip=None, bits: int = 16, rng=None) -> bytes:
    """A LogLuv (32845) or LogL (32844) TIFF of [H, W] SGILog words: 32-bit
    LogLuv or 16-bit LogL words run-length coded (34676), or 24-bit LogLuv
    words stored as three bytes (34677)."""
    h, w = words.shape
    rps = rows_per_strip or h
    strips = []
    for y in range(0, h, rps):
        block = words[y:y + rps]
        if compression == 34677:
            b = np.stack([(block >> 16) & 255, (block >> 8) & 255, block & 255], -1)
            strips.append(b.astype(np.uint8).tobytes())
        else:
            strips.append(b"".join(sgilog_rle_row(r, 2 if logl else 4, rng) for r in block))
    spp = 1 if logl else 3
    t = {256: (LONG, [w]), 257: (LONG, [h]), 258: (SHORT, [bits] * spp),
         259: (SHORT, [compression]), 262: (SHORT, [32844 if logl else 32845]),
         277: (SHORT, [spp]), 278: (LONG, [rps])}
    return tiff_file(strips, t)


def jpeg_segments(jpeg: bytes) -> list[tuple[int, bytes]]:
    """A JPEG's marker segments in order, [(marker, bytes)], each scan's
    SOS segment carrying its entropy-coded data (up to the next marker)."""
    out, pos = [], 2
    while pos < len(jpeg) - 1:
        m = jpeg[pos + 1]
        if m == 0xD9:
            break
        length = int.from_bytes(jpeg[pos + 2:pos + 4], "big")
        end = pos + 2 + length
        if m == 0xDA:
            while not (jpeg[end] == 0xFF and jpeg[end + 1] not in (0x00,) and
                       not 0xD0 <= jpeg[end + 1] <= 0xD7):
                end += 1
        out.append((m, jpeg[pos:end]))
        pos = end
    return out


def jpeg_keep_scans(jpeg: bytes, keep) -> bytes:
    """The JPEG with only the scans whose index (0-based) is in `keep`: a
    progressive file whose dropped scans leave coefficients (AC bands 1-9
    among them) unrefined, as libjpeg then smooths its blocks."""
    out, k = bytearray(jpeg[:2]), 0
    for m, seg in jpeg_segments(jpeg):
        if m == 0xDA:
            if k in keep:
                out += seg
            k += 1
        else:
            out += seg
    return bytes(out + b"\xff\xd9")


def jpeg2000_ht(px: np.ndarray, irreversible: bool = False, levels: int = 3,
                cblk: tuple = (64, 64), tiles: tuple | None = None,
                precincts: list | None = None, order: str = "LRCP", refine: bool = False,
                sets: int = 1, step: float = 1.0, jp2: bool = False, **kw) -> bytes:
    """A JPEG 2000 file of HT code-blocks (Part 15), which OpenJPEG's encoder
    cannot write: `px` uint8 or uint16, grey [h, w], RGB or RGBA [h, w, c];
    the reversible 5/3 wavelet with RCT, or the 9/7 with ICT and step sizes
    from `step`; `levels` decompositions, tiles (multiples of 2^levels) and
    precincts ((PPx, PPy) per resolution) optional, code-blocks of 4x4 to
    64x64, LRCP or RPCL, one quality layer; the cleanup pass alone, or
    (`refine`) with SigProp and MagRef over the last bit-plane; `sets` > 1
    signals further HT sets (more than the 3 passes OpenJPEG decodes).
    Rsiz and CAP as HT writers set them; a JP2 file around it (sRGB or
    greyscale) with `jp2`.  Other keywords go to
    `tools/j2k_ht_writer.codestream` (code-block style bits, Rsiz, CAP's
    body, marker segments spliced into the main or tile-part headers, two
    or three quality layers, and `tamper(coefficients, Mb, p, passes,
    segments, missing MSBs)`, which may rewrite each code-block's coding).
    See `tools/j2k_ht_writer.py`."""
    from tools import j2k_ht_writer as hw
    cs = hw.codestream(px, irreversible=irreversible, levels=levels, cblk=cblk, tiles=tiles,
                       precincts=precincts, order=order, refine=refine, sets=sets, step=step,
                       **kw)
    if not jp2:
        return cs
    h, w = px.shape[:2]
    nc = 1 if px.ndim == 2 else px.shape[2]
    return hw.jp2(cs, w, h, nc, 16 if px.dtype == np.uint16 else 8, 17 if nc == 1 else 16)


def jpeg2000_ht_random(rng, maxsize: int = 64):
    """A random `jpeg2000_ht` file: size 1..maxsize, grey, RGB, RGBA or
    16-bit grey, random or smooth content, 5/3 or 9/7 (random step), 0-5
    levels, code-blocks of 4x4 to 64x64, tiles and precincts or not, LRCP
    or RPCL, the cleanup pass alone or with SigProp and MagRef, VSC, JP2 or
    a raw codestream.  Returns (bytes, info)."""
    h, w = (int(v) for v in rng.integers(1, maxsize + 1, 2))
    kind = ["grey", "rgb", "rgba", "grey16"][int(rng.integers(0, 4))]
    c = {"grey": 1, "rgb": 3, "rgba": 4, "grey16": 1}[kind]
    top = 65535 if kind == "grey16" else 255
    if rng.random() < 0.5:
        px = rng.integers(0, top + 1, (h, w, c))
    else:
        y, x = np.mgrid[:h, :w]
        px = np.stack([(0.5 + 0.45 * np.sin(x * rng.uniform(0.05, 0.6) + y * rng.uniform(0.05, 0.6)
                                              + k)) * top for k in range(c)], -1)
    px = px.astype(np.uint16 if kind == "grey16" else np.uint8)
    px = px[..., 0] if c == 1 else px
    levels = int(rng.integers(0, 6))
    while levels and max(h, w) >> levels == 0:
        levels -= 1
    cw = 1 << int(rng.integers(2, 7))
    ch = 1 << int(rng.integers(2, min(7, 13 - cw.bit_length() + 1)))
    kw = dict(irreversible=bool(rng.random() < 0.4), levels=levels, cblk=(cw, ch),
              order=["LRCP", "RPCL"][int(rng.integers(0, 2))], refine=bool(rng.random() < 0.35),
              step=float(2.0 ** rng.integers(-2, 5)), jp2=bool(rng.random() < 0.5),
              style=0x40 | (0x08 if rng.random() < 0.2 else 0))
    if rng.random() < 0.3 and levels <= 4:
        t = 1 << levels
        kw["tiles"] = (t * int(rng.integers(1, 4)) * (2 if t < 8 else 1),) * 2
    if rng.random() < 0.3:
        kw["precincts"] = [tuple(int(rng.integers(3 if r else 2, 7)) for _ in range(2))
                           for r in range(levels + 1)]
    try:
        return jpeg2000_ht(px, **kw), (kind, h, w, kw)
    except ValueError:
        return None, (kind, h, w, kw)


# --- AVIF -----------------------------------------------------------------------

AVIF_NO_FILTERS = [("enable-cdef", "0"), ("enable-restoration", "0"),
                   ("loopfilter-control", "0")]


def avif_content(rng, h: int, w: int, c: int, style: str | None = None) -> np.ndarray:
    """[h, w, c] uint8 test content: smooth waves with noise, noise, flat
    areas, or screen-like rectangles and repeated text-like runs."""
    style = style or ("smooth", "noise", "flat", "screen")[int(rng.integers(0, 4))]
    if style == "noise":
        return rng.integers(0, 256, (h, w, c)).astype(np.uint8)
    if style == "flat":
        return np.broadcast_to(rng.integers(0, 256, c).astype(np.uint8), (h, w, c)).copy()
    if style == "screen":
        img = np.broadcast_to(rng.integers(0, 256, c).astype(np.uint8), (h, w, c)).copy()
        for _ in range(int(rng.integers(1, 20))):
            y, x = int(rng.integers(0, h)), int(rng.integers(0, w))
            img[y:y + int(rng.integers(1, 16)), x:x + int(rng.integers(1, 16))] = \
                rng.integers(0, 256, c)
        if h >= 8 and w >= 8:
            t = (rng.random((min(8, h), min(16, w))) < 0.4).astype(np.uint8) * 200
            for _ in range(3):
                y, x = int(rng.integers(0, h - t.shape[0] + 1)), int(rng.integers(0, w - t.shape[1] + 1))
                img[y:y + t.shape[0], x:x + t.shape[1]] = t[..., None]
        return img
    y, x = np.mgrid[0:h, 0:w]
    img = np.zeros((h, w, c))
    for k in range(c):
        f = rng.uniform(2, 12, 2)
        img[..., k] = 128 + 70 * np.sin(x / f[0] + k) + 50 * np.cos(y / f[1]) + \
            rng.normal(0, float(rng.uniform(0, 20)), (h, w))
    return np.clip(img, 0, 255).astype(np.uint8)


def avif_pil(px: np.ndarray, **kw) -> bytes:
    """PIL's AVIF writer (libavif 1.3 over aom); `advanced` takes aom's
    options, e.g. AVIF_NO_FILTERS."""
    import io

    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(px).save(buf, format="AVIF", **kw)
    return buf.getvalue()


def avif_random(rng, maxsize: int = 64):
    """A random AVIF from cv2's writer (lossless at quality 100, 8, 10 or
    12 bits, grey / colour / alpha) or PIL's (quality 0-100, 4:2:0 / 4:2:2
    / 4:4:4, grey, alpha, with or without aom's in-loop filters, screen
    content tuning, quantiser matrices, tiles, 128x128 superblocks), or
    libaom's with a random nclx colour box (`avif_random_cicp`):
    (bytes, info) with info the writer's settings, or (None, info) where
    the writer refused the draw."""
    import cv2
    h, w = (int(v) for v in rng.integers(1, maxsize + 1, 2))
    if rng.random() < 0.15:
        return avif_random_cicp(rng, h, w)
    if rng.random() < 0.4:
        depth = int(rng.choice([8, 8, 10, 12]))
        c = int(rng.choice([1, 3, 3, 4]))
        q = 100 if rng.random() < 0.7 else int(rng.integers(0, 100))
        img = avif_content(rng, h, w, c)
        if depth > 8:
            img = (img.astype(np.uint16) << (depth - 8)) | rng.integers(
                0, 1 << (depth - 8), img.shape).astype(np.uint16)
        if c == 1:
            img = img[..., 0]
        info = ("cv2", h, w, c, depth, q)
        try:
            ok, buf = cv2.imencode(".avif", img, [cv2.IMWRITE_AVIF_QUALITY, q,
                                                  cv2.IMWRITE_AVIF_DEPTH, depth])
        except cv2.error:
            return None, info
        return (buf.tobytes() if ok else None), info
    mode = str(rng.choice(["RGB", "RGB", "RGBA", "L"]))
    c = {"RGB": 3, "RGBA": 4, "L": 1}[mode]
    img = avif_content(rng, h, w, c)
    if c == 1:
        img = img[..., 0]
    kw = {"quality": int(rng.integers(0, 101)),
          "subsampling": str(rng.choice(["4:2:0", "4:2:2", "4:4:4"])),
          "speed": int(rng.integers(4, 11))}
    adv = list(AVIF_NO_FILTERS) if rng.random() < 0.7 else []
    if rng.random() < 0.3:
        adv.append(("tune-content", "screen"))
    if rng.random() < 0.2:
        adv += [("enable-qm", "1"), ("qm-min", str(int(rng.integers(0, 8)))),
                ("qm-max", str(int(rng.integers(8, 16))))]
    if rng.random() < 0.2:
        adv += [("tile-columns", str(int(rng.integers(0, 3)))),
                ("tile-rows", str(int(rng.integers(0, 3))))]
    if rng.random() < 0.2:
        adv.append(("sb-size", str(rng.choice(["64", "128"]))))
    if adv:
        kw["advanced"] = adv
    if rng.random() < 0.1:
        from PIL import Image
        kw["save_all"] = True
        kw["append_images"] = [Image.fromarray(avif_content(rng, h, w, c)[..., 0] if c == 1
                                               else avif_content(rng, h, w, c))
                               for _ in range(int(rng.integers(1, 3)))]
    info = ("pil", h, w, mode, {k: v for k, v in kw.items() if k != "append_images"})
    try:
        return avif_pil(img, **kw), info
    except (ValueError, OSError):
        return None, info


def avif_random_sequence(rng, maxsize: int = 64):
    """PIL's image sequence (2 or 3 frames, RGB or RGBA, any quality, aom's
    in-loop filters off): the (bytes, info) of avif_random."""
    from PIL import Image
    h, w = (int(v) for v in rng.integers(8, maxsize + 1, 2))
    c = int(rng.choice([3, 4]))
    frames = [avif_content(rng, h, w, c) for _ in range(int(rng.integers(2, 4)))]
    q = int(rng.integers(20, 100))
    info = ("pil sequence", h, w, c, len(frames), q)
    try:
        return avif_pil(frames[0], quality=q, advanced=AVIF_NO_FILTERS, save_all=True,
                        append_images=[Image.fromarray(f) for f in frames[1:]]), info
    except (ValueError, OSError):
        return None, info


def avif_random_cicp(rng, h: int, w: int):
    """libaom's own encode (4:2:0 or 4:4:4, 8, 10 or 12 bits, any quality,
    its good-quality usage (aomenc's default, loop restoration on) or its
    all-intra one, superres at a fixed denominator 9-16 in a share, its
    in-loop filters on or off) in `avif_file`'s container with a random
    nclx: colour primaries, transfer and matrix coefficients each a common
    value or any of 0-255, and either range; the (bytes, info) of
    avif_random."""
    fmt = str(rng.choice(["420", "444"]))
    common = {0: [1, 2, 5, 6, 9, 12], 1: [1, 2, 6, 13, 16], 2: [0, 1, 2, 3, 5, 6, 9, 12, 15]}
    cicp = [int(rng.choice(common[k])) if rng.random() < 0.6 else int(rng.integers(0, 256))
            for k in range(3)] + [int(rng.integers(0, 2))]
    opts = {"cq-level": int(rng.integers(0, 64)), "cpu-used": int(rng.integers(4, 10))}
    if rng.random() < 0.5:
        opts.update({"enable-cdef": 0, "enable-restoration": 0, "loopfilter-control": 0})
    usage = 0 if rng.random() < 0.5 else 2
    cfg = {96: 3} if usage == 0 else {}  # rc_end_usage AOM_Q, so cq-level counts
    if rng.random() < 0.3:
        denom = int(rng.integers(9, 17))
        cfg.update({76: 1, 80: denom, 84: denom})  # rc_superres_mode FIXED
    depth = int(rng.choice([8, 8, 8, 10, 12]))
    img = avif_content(rng, h, w, 3)
    if depth > 8:
        img = (img.astype(np.uint16) << (depth - 8)) | rng.integers(
            0, 1 << (depth - 8), img.shape).astype(np.uint16)
    planes = [np.ascontiguousarray(img[..., k]) for k in range(3)]
    if fmt == "420":
        planes = planes[:1] + [np.ascontiguousarray(p[::2, ::2]) for p in planes[1:]]
    info = ("aom", h, w, fmt, depth, tuple(cicp), opts, usage, cfg)
    try:
        obus = aom_encode(planes, fmt, opts, usage=usage, cfg_fields=cfg, bit_depth=depth)
    except ValueError:
        return None, info
    sub = int(fmt == "420")
    profile = 2 if depth == 12 else int(fmt == "444")
    return avif_file(obus, w, h, depth=depth, ssx=sub, ssy=sub, profile=profile,
                     cicp=cicp), info


def _box(typ: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + typ + body


def _full(typ: bytes, version: int, flags: int, body: bytes) -> bytes:
    return _box(typ, struct.pack(">I", (version << 24) | flags) + body)


def avif_file(obus: bytes, w: int, h: int, depth: int = 8, mono: bool = False,
              ssx: int = 0, ssy: int = 0, cicp=(2, 2, 2, 1), profile: int = 1,
              extra=()) -> bytes:
    """A minimal still-image AVIF holding `obus` (a sequence header and a
    frame) as its primary item: ftyp, meta (hdlr, pitm, iloc, iinf, iprp
    with ispe, av1C, pixi, colr nclx and the (box, essential) pairs of
    `extra`, e.g. irot / imir / clap), mdat."""
    ftyp = _box(b"ftyp", b"avif" + b"\0\0\0\0" + b"avifmif1miaf")
    flags = ((depth > 8) << 6) | ((depth == 12) << 5) | (mono << 4) | (ssx << 3) | (ssy << 2)
    av1c = _box(b"av1C", bytes([0x81, profile << 5, flags, 0]))
    n = 1 if mono else 3
    ipco = _box(b"ipco", _full(b"ispe", 0, 0, struct.pack(">II", w, h)) + av1c +
                _full(b"pixi", 0, 0, bytes([n] + [depth] * n)) +
                _box(b"colr", b"nclx" + struct.pack(">HHHB", cicp[0], cicp[1], cicp[2],
                                                    cicp[3] << 7)) +
                b"".join(box for box, _ in extra))
    assoc = [1, 0x82, 3, 4] + [(5 + k) | (0x80 if ess else 0) for k, (_, ess) in enumerate(extra)]
    ipma = _full(b"ipma", 0, 0, struct.pack(">IHB", 1, 1, len(assoc)) + bytes(assoc))

    def meta(offset: int) -> bytes:
        iloc = _full(b"iloc", 0, 0, bytes([0x44, 0x00]) + struct.pack(">HHHHII", 1, 1, 0, 1,
                                                                      offset, len(obus)))
        iinf = _full(b"iinf", 0, 0, struct.pack(">H", 1) +
                     _full(b"infe", 2, 0, struct.pack(">HH", 1, 0) + b"av01" + b"\0"))
        return _full(b"meta", 0, 0, _full(b"hdlr", 0, 0, b"\0\0\0\0pict" + b"\0" * 13) +
                     _full(b"pitm", 0, 0, struct.pack(">H", 1)) + iloc + iinf +
                     _box(b"iprp", ipco + ipma))
    size = len(ftyp) + len(meta(0))
    return ftyp + meta(size + 8) + _box(b"mdat", obus)


_AOM = None


def aom_encode(planes, fmt: str = "444", options: dict | None = None, usage: int = 2,
               cfg_fields: dict | None = None, bit_depth: int = 8) -> bytes:
    """libaom's own encoder (the one cv2's wheel bundles, through ctypes) on
    YUV planes [Y, U, V] ("444", "422" or "420") of `bit_depth` bits (uint16
    planes above 8; 12 bits and 4:2:2 are profile 2): the OBUs of one frame.
    `options` go to aom_codec_set_option (aomenc's names: "lossless",
    "cq-level", "end-usage", "tune-content", "enable-intrabc", "cpu-used",
    "enable-cdef", ...); `cfg_fields` sets 32-bit fields of aom_codec_enc_cfg_t
    by byte offset (76: rc_superres_mode, 80 / 84: its denominators); usage
    2 is AOM_USAGE_ALL_INTRA, 0 AOM_USAGE_GOOD_QUALITY (aomenc's default)."""
    import ctypes
    import glob
    import os

    import cv2
    global _AOM
    if _AOM is None:
        path = glob.glob(os.path.join(os.path.dirname(cv2.__file__), "..", "opencv_python.libs",
                                      "libaom*.so*"))[0]
        _AOM = ctypes.CDLL(path)
        vp, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        for name, res, args in (
                ("aom_codec_av1_cx", vp, []),
                ("aom_codec_enc_config_default", i, [vp, vp, u]),
                ("aom_codec_enc_init_ver", i, [vp, vp, vp, ctypes.c_long, i]),
                ("aom_codec_set_option", i, [vp, ctypes.c_char_p, ctypes.c_char_p]),
                ("aom_img_wrap", vp, [vp, i, u, u, u, vp]),
                ("aom_codec_encode", i, [vp, vp, ctypes.c_int64, ctypes.c_ulong, ctypes.c_long]),
                ("aom_codec_get_cx_data", vp, [vp, vp]),
                ("aom_codec_error_detail", ctypes.c_char_p, [vp]),
                ("aom_codec_destroy", i, [vp])):
            getattr(_AOM, name).restype = res
            getattr(_AOM, name).argtypes = args
    lib = _AOM
    dt = np.uint8 if bit_depth == 8 else np.uint16
    y = np.ascontiguousarray(planes[0], dt)
    h, w = y.shape
    iface = lib.aom_codec_av1_cx()
    cfg = ctypes.create_string_buffer(4096)
    if lib.aom_codec_enc_config_default(iface, cfg, usage):
        raise ValueError("aom_codec_enc_config_default failed")
    profile = 2 if bit_depth == 12 or fmt == "422" else 1 if fmt == "444" else 0
    struct.pack_into("<III", cfg, 8, profile, w, h)  # g_profile, g_w, g_h
    struct.pack_into("<II", cfg, 32, bit_depth, bit_depth)  # g_bit_depth, g_input_bit_depth
    for off, v in (cfg_fields or {}).items():
        struct.pack_into("<I", cfg, off, v)
    ctx = ctypes.create_string_buffer(512)
    flags = 0x40000 if bit_depth > 8 else 0  # AOM_CODEC_USE_HIGHBITDEPTH
    for ver in range(1, 64):
        if lib.aom_codec_enc_init_ver(ctx, iface, cfg, flags, ver) == 0:
            break
    else:
        raise ValueError("aom_codec_enc_init_ver refused every ABI version")
    try:
        for k, v in (options or {}).items():
            if lib.aom_codec_set_option(ctx, k.encode(), str(v).encode()):
                raise ValueError(f"aom option {k}={v} refused")
        # aom_img_wrap lays subsampled planes out at even sizes (the luma
        # stride and height rounded up, the chroma planes half of them): pad
        ssx, ssy = {"444": (0, 0), "422": (1, 0), "420": (1, 1)}[fmt]
        hh, ww = h + (h & ssy), w + (w & ssx)
        data = np.concatenate(
            [np.pad(np.asarray(p, dt), ((0, (hh >> sy) - p.shape[0]),
                                        (0, (ww >> sx) - p.shape[1])), mode="edge").ravel()
             for p, sx, sy in zip([y] + list(planes[1:]), (0, ssx, ssx), (0, ssy, ssy))])
        code = {"444": 0x106, "422": 0x105, "420": 0x102}[fmt] | (0x800 if bit_depth > 8 else 0)
        buf = ctypes.create_string_buffer(data.tobytes(), data.nbytes)
        img = ctypes.create_string_buffer(1024)
        if not lib.aom_img_wrap(img, code, w, h, 1, buf):
            raise ValueError("aom_img_wrap failed")
        out = bytearray()
        for frame in (img, None):
            if lib.aom_codec_encode(ctx, frame, 0, 1, 0):
                raise ValueError("aom_codec_encode: " +
                                 (lib.aom_codec_error_detail(ctx) or b"").decode())
            it = ctypes.c_void_p(0)
            while True:
                pkt = lib.aom_codec_get_cx_data(ctx, ctypes.byref(it))
                if not pkt:
                    break
                if ctypes.c_int.from_address(pkt).value == 0:  # AOM_CODEC_CX_FRAME_PKT
                    p = ctypes.c_void_p.from_address(pkt + 8).value
                    sz = ctypes.c_size_t.from_address(pkt + 16).value
                    out += ctypes.string_at(p, sz)
        return bytes(out)
    finally:
        lib.aom_codec_destroy(ctx)


def _lr_header(obus: bytes) -> dict:
    """Where the loop restoration fields of an intra frame's header lie
    (the frame in an OBU_FRAME, as aom_encode writes it): the OBU's
    position, payload start and end, the sequence and frame headers, the
    header's bits up to its end, the bit offsets (from the payload's start)
    of each plane's 2-bit lr_type and the [lo, hi) run of lr_unit_shift,
    lr_unit_extra_shift and lr_uv_shift."""
    from kgtpu_torch.data import av1_obu

    class Recording(av1_obu.Bits):
        def __init__(self, *a):
            super().__init__(*a)
            self.calls = []

        def f(self, n):
            at = self.pos
            v = super().f(n)
            self.calls.append((at, n))
            return v
    pos, seq = 0, None
    while pos < len(obus):
        typ, start, end = av1_obu._obu_at(obus, pos)
        if typ == av1_obu.OBU_SEQUENCE_HEADER:
            seq = av1_obu.parse_sequence_header(obus, start, end)
        if typ == av1_obu.OBU_FRAME:
            break
        pos = end
    else:
        raise ValueError("no OBU_FRAME")
    b = Recording(obus, start, end)
    fh = av1_obu.parse_frame_header(b, seq)
    if fh.apply_grain or not any(fh.lr_type):
        raise ValueError("the frame has film grain or no loop restoration")
    tail = 1 + (not fh.coded_lossless)  # tx_mode_select, reduced_tx_set
    has_uv = bool(seq.ssx and seq.ssy and any(fh.lr_type[1:]))
    k = len(b.calls) - tail - has_uv
    first = k
    while b.calls[first - 1][1] == 1:  # the shift bits follow the 2-bit lr_types
        first -= 1
    bits = [(obus[i >> 3] >> (7 - (i & 7))) & 1 for i in range(start * 8, b.pos)]
    return {"pos": pos, "start": start, "end": end, "seq": seq, "fh": fh, "bits": bits,
            "tile_at": -(-b.pos // 8), "has_uv": has_uv,
            "lr_type_at": [at - start * 8 for at, _ in b.calls[first - seq.num_planes:first]],
            "shifts": (b.calls[first][0] - start * 8, b.calls[k + has_uv - 1][0] - start * 8 + 1)}


def _frame_obu(obus: bytes, h: dict, bits: list, tile_data: bytes) -> bytes:
    """`obus` with the OBU_FRAME that `_lr_header` found rebuilt from the
    header `bits` (byte-aligned here) and `tile_data`, its size rewritten."""
    bits = bits + [0] * (-len(bits) % 8)
    header = bytes(int("".join(map(str, bits[i:i + 8])), 2) for i in range(0, len(bits), 8))
    payload = header + tile_data
    size, n = bytearray(), len(payload)
    while True:
        size.append((n & 0x7F) | (0x80 if n > 0x7F else 0))
        n >>= 7
        if not n:
            break
    pos = h["pos"]
    return obus[:pos] + obus[pos:pos + 1] + bytes(size) + payload + obus[h["end"]:]


def av1_lr_unit_rewrite(obus: bytes, unit_shift: int, uv_shift: int) -> bytes:
    """`obus` (one intra frame in an OBU_FRAME, as aom_encode writes it) with
    its frame header's lr_unit_shift and lr_uv_shift set anew (the header's
    other bits and the tile data kept, the OBU's size rewritten).  No
    encoder here codes a halved 4:2:0 chroma unit; the tile data stays in
    step only where each plane keeps its number of units (a frame under 96
    samples a side has one per plane at every size), so the rewritten file
    tests the header and the sizes, not the symbols."""
    h = _lr_header(obus)
    if h["seq"].use_128:
        new = [unit_shift - 1]
    else:
        new = [0] if unit_shift == 0 else [1, unit_shift - 1]
    if h["has_uv"]:
        new.append(uv_shift)
    lo, hi = h["shifts"]
    return _frame_obu(obus, h, h["bits"][:lo] + new + h["bits"][hi:],
                      obus[h["tile_at"]:h["end"]])


def av1_lr_switchable_rewrite(obus: bytes) -> bytes:
    """`obus` (one intra frame of one tile in an OBU_FRAME, as aom_encode
    writes it) with every restoring plane's frame restoration type made
    SWITCHABLE: the port's decoder reads the tile, recording each symbol
    with its CDF as read; each unit's use_wiener / use_sgrproj symbol is
    coded again as switchable_restore for the same unit type (its CDF
    adapted as the decoder adapts it), every other symbol and bit as it
    was, by libaom's own od_ec encoder (through ctypes).  libaom's encoder
    here never writes a switchable frame."""
    import ctypes

    from kgtpu_torch.data import av1_block, av1_decode, av1_obu
    from kgtpu_torch.data.av1_symbol import SymbolReader
    from tools.av1_oracle import LibaomOracle
    h = _lr_header(obus)
    seq, fh, tiles = av1_obu.parse_frame(obus)
    if len(tiles) != 1:
        raise ValueError("the frame has more than one tile")
    fr = av1_decode.Frame(seq, fh)
    rd = SymbolReader(obus, tiles[0][2], tiles[0][3], bool(fh.disable_cdf_update))
    log = []
    symbol, read_bool, literal = rd.symbol, rd.bool, rd.literal

    def rec_symbol(cdf):
        before = cdf[:]
        v = symbol(cdf)
        log.append((id(cdf), before, v))
        return v

    def rec_bool():
        v = read_bool()
        log.append((None, 1, v))
        return v

    def rec_literal(n):
        v = literal(n)
        log.append((None, n, v))
        return v
    rd.symbol, rd.bool, rd.literal = rec_symbol, rec_bool, rec_literal
    td = av1_block.TileDecoder(fr, tiles[0][0], tiles[0][1], rd)
    td.decode()
    remap = {id(td.cdf["use_wiener"]): (0, av1_obu.RESTORE_WIENER),
             id(td.cdf["use_sgrproj"]): (0, av1_obu.RESTORE_SGRPROJ)}
    switchable = fr.new_cdfs()["switchable_restore"]
    o = LibaomOracle()
    enc = ctypes.create_string_buffer(512)
    o.fn("od_ec_enc_init", ctypes.c_void_p, ctypes.c_uint32)(ctypes.addressof(enc), 1 << 16)
    put = o.fn("od_ec_encode_cdf_q15", ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
               ctypes.c_int)
    put_bool = o.fn("od_ec_encode_bool_q15", ctypes.c_void_p, ctypes.c_int, ctypes.c_uint)
    for cdf_id, cdf, v in log:
        if cdf_id is None:  # cdf: the literal's bit count
            for i in reversed(range(cdf)):
                put_bool(ctypes.addressof(enc), (v >> i) & 1, 16384)
            continue
        if cdf_id in remap:
            v, cdf = remap[cdf_id][v], switchable[:]
            if not fh.disable_cdf_update:
                _adapt_cdf(switchable, v)
        arr = (ctypes.c_uint16 * len(cdf))(*cdf)
        put(ctypes.addressof(enc), v, ctypes.addressof(arr), len(cdf) - 1)
    nbytes = ctypes.c_uint32(0)
    done = ctypes.CFUNCTYPE(ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p)(
        o.base + o.lib.syms["od_ec_enc_done"][0][0])
    data = ctypes.string_at(done(ctypes.addressof(enc), ctypes.addressof(nbytes)), nbytes.value)
    o.fn("od_ec_enc_clear", ctypes.c_void_p)(ctypes.addressof(enc))
    bits = list(h["bits"])
    for p, at in enumerate(h["lr_type_at"]):
        if fh.lr_type[p] != av1_obu.RESTORE_NONE:
            bits[at:at + 2] = [0, 1]  # lr_type 1: RESTORE_SWITCHABLE
    return _frame_obu(obus, h, bits, data)


def _adapt_cdf(cdf: list, s: int) -> None:
    """libaom's update_cdf on an inverted CDF with its counter, as
    `av1_symbol.SymbolReader` adapts it."""
    n = len(cdf) - 1
    count = cdf[n]
    rate = (3 if n == 2 else 4 if n == 3 else 5) + (count > 15) + (count > 31) + (n == 2)
    for i in range(s):
        cdf[i] += (32768 - cdf[i]) >> rate
    for i in range(s, n - 1):
        cdf[i] -= cdf[i] >> rate
    if count < 32:
        cdf[n] = count + 1


def avif_grid(tiles: list, rows: int, cols: int, tile_w: int, tile_h: int, out_w: int,
              out_h: int, ssx: int = 0, ssy: int = 0, cicp=(2, 2, 2, 1),
              profile: int = 1, in_idat: bool = True) -> bytes:
    """An AVIF whose primary item is a `grid` of rows x cols av01 tiles
    (`tiles`: each tile's OBUs, row-major, all tile_w x tile_h, 8-bit
    colour), output out_w x out_h (ImageGrid with 16-bit sizes, in `idat`
    as libavif writes it, or with `in_idat` False after the tiles in mdat:
    cv2 sniffs AVIF by parsing the file's first 500 bytes, so a grid whose
    ImageGrid lies past them is not read)."""
    n = len(tiles)
    ftyp = _box(b"ftyp", b"avif" + b"\0\0\0\0" + b"avifmif1miaf")
    flags = (ssx << 3) | (ssy << 2)
    av1c = _box(b"av1C", bytes([0x81, profile << 5, flags, 0]))
    ipco = _box(b"ipco", _full(b"ispe", 0, 0, struct.pack(">II", tile_w, tile_h)) + av1c +
                _full(b"pixi", 0, 0, bytes([3, 8, 8, 8])) +
                _box(b"colr", b"nclx" + struct.pack(">HHHB", cicp[0], cicp[1], cicp[2],
                                                    cicp[3] << 7)) +
                _full(b"ispe", 0, 0, struct.pack(">II", out_w, out_h)))
    grid_id = n + 1
    entries = b"".join(struct.pack(">HB", i + 1, 3) + bytes([1, 0x82, 3]) for i in range(n))
    entries += struct.pack(">HB", grid_id, 3) + bytes([5, 3, 4])
    ipma = _full(b"ipma", 0, 0, struct.pack(">I", n + 1) + entries)
    grid_payload = bytes([0, 0, rows - 1, cols - 1]) + struct.pack(">HH", out_w, out_h)
    iinf = _full(b"iinf", 0, 0, struct.pack(">H", n + 1) + b"".join(
        _full(b"infe", 2, 0, struct.pack(">HH", i + 1, 0) + b"av01" + b"\0") for i in range(n)) +
        _full(b"infe", 2, 0, struct.pack(">HH", grid_id, 0) + b"grid" + b"\0"))
    iref = _full(b"iref", 0, 0, _box(b"dimg", struct.pack(">HH", grid_id, n) +
                                     b"".join(struct.pack(">H", i + 1) for i in range(n))))

    def meta(offset: int) -> bytes:
        locs, at = [], offset
        for i, t in enumerate(tiles):
            locs.append(struct.pack(">HHHII", i + 1, 0, 1, at, len(t)))
            at += len(t)
        locs = [struct.pack(">HH", i + 1, 0) + loc[2:] for i, loc in enumerate(locs)]
        locs.append(struct.pack(">HHHHII", grid_id, int(in_idat), 0, 1, 0 if in_idat else at,
                                len(grid_payload)))
        iloc = _full(b"iloc", 1, 0, bytes([0x44, 0x00]) + struct.pack(">H", n + 1) +
                     b"".join(locs))
        return _full(b"meta", 0, 0, _full(b"hdlr", 0, 0, b"\0\0\0\0pict" + b"\0" * 13) +
                     _full(b"pitm", 0, 0, struct.pack(">H", grid_id)) + iloc + iinf + iref +
                     _box(b"iprp", ipco + ipma) +
                     (_box(b"idat", grid_payload) if in_idat else b""))
    size = len(ftyp) + len(meta(0))
    return ftyp + meta(size + 8) + _box(b"mdat", b"".join(tiles) +
                                        (b"" if in_idat else grid_payload))
