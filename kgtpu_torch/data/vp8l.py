"""WebP lossless (VP8L) decoding without libwebp: NumPy only, following
libwebp 1.5's `src/dec/vp8l_dec.c`, `src/utils/huffman_utils.c` and
`src/dsp/lossless.c` (the format of RFC 9649).

`decode_vp8l(data)` reads a whole VP8L stream (its 5-byte header too) to
[H, W] uint32 ARGB; `decode_vp8l_image(data, w, h)` reads a headerless
stream (an ALPH chunk's) of a known size.  libwebp's rules, each followed:

  * transforms (predictor, cross-colour, subtract-green, colour indexing,
    each at most once) are read in order and undone in reverse; colour
    indexing packs 2, 4 or 8 pixels into one when the palette has at most
    16, 4 or 2 colours, and the transforms read after it, and the image,
    have the packed width;
  * the main image may have meta prefix codes (an entropy image of group
    indices, one per 2^bits block); every image may have a colour cache
    (1-11 bits), which every decoded pixel enters in order;
  * a prefix code is either simple (one or two symbols of length 1; a
    single symbol reads no bits) or given by code lengths, themselves
    prefix-coded (`_read_code`); a code that is not complete, other than a
    single symbol, is an error;
  * a green symbol below 256 is a literal (then red, blue, alpha), below
    280 a backward reference (length prefix, distance prefix, the
    distance taken through the 120-entry plane-code map), else a colour
    cache index;
  * a reference before the first pixel or past the last, a bad code, or a
    read past the end of the data is an error (`VP8LError`).
"""

from __future__ import annotations

import numpy as np


class VP8LError(ValueError):
    """A VP8L stream libwebp refuses."""


_CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
_PLANE = (
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a,
    0x26, 0x2a, 0x38, 0x05, 0x37, 0x39, 0x15, 0x1b, 0x36, 0x3a,
    0x25, 0x2b, 0x48, 0x04, 0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b,
    0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45, 0x4b, 0x34, 0x3c, 0x03,
    0x57, 0x59, 0x13, 0x1d, 0x56, 0x5a, 0x23, 0x2d, 0x44, 0x4c,
    0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b,
    0x32, 0x3e, 0x78, 0x01, 0x77, 0x79, 0x53, 0x5d, 0x11, 0x1f,
    0x64, 0x6c, 0x42, 0x4e, 0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b,
    0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e, 0x00, 0x74, 0x7c, 0x41,
    0x4f, 0x10, 0x20, 0x62, 0x6e, 0x30, 0x73, 0x7d, 0x51, 0x5f,
    0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70)
PREDICTOR, CROSS_COLOR, SUBTRACT_GREEN, COLOR_INDEXING = range(4)


class BitReader:
    """LSB-first bits of `data`; a read past its end is an error when the
    stream is done (`check_end`), as libwebp's end-of-stream flag is."""

    def __init__(self, data: bytes):
        self.buf = bytes(data) + b"\0" * 16
        self.nbits = 8 * len(data)
        self.pos = 0

    def read(self, n: int) -> int:
        p = self.pos
        at = p >> 3
        v = (int.from_bytes(self.buf[at:at + 8], "little") >> (p & 7)) & ((1 << n) - 1)
        self.pos = p + n
        return v

    def check_end(self) -> None:
        if self.pos > self.nbits:
            raise VP8LError("VP8L data ends early")


def _table(lengths: np.ndarray):
    """A prefix code's lookup table over its longest code's width: entry
    = symbol << 4 | length, indexed by the next bits (LSB first); or an
    error for a code libwebp refuses.  One symbol reads no bits."""
    nz = np.flatnonzero(lengths)
    if len(nz) == 0:
        raise VP8LError("VP8L prefix code has no symbol")
    if len(nz) == 1:
        return [int(nz[0]) << 4], 0
    ls = lengths[nz].astype(np.int64)
    maxlen = int(ls.max())
    if maxlen > 15 or int((1 << (maxlen - ls)).sum()) != 1 << maxlen:
        raise VP8LError("VP8L prefix code is not complete")
    order = np.lexsort((nz, ls))
    syms, ls = nz[order], ls[order]
    # canonical codes, shortest first
    codes = np.zeros(len(ls), np.int64)
    code, prev = 0, int(ls[0])
    for i in range(1, len(ls)):
        code = (code + 1) << (int(ls[i]) - prev)
        prev = int(ls[i])
        codes[i] = code
    rev = np.zeros(len(ls), np.int64)
    for b in range(maxlen):
        rev |= ((codes >> b) & 1) << (ls - 1 - b)
    table = np.zeros(1 << maxlen, np.int64)
    for length in np.unique(ls):
        sel = ls == length
        step = 1 << int(length)
        keys = rev[sel][:, None] + step * np.arange((1 << maxlen) // step)[None, :]
        table[keys] = ((syms[sel] << 4) | int(length))[:, None]
    return table.tolist(), (1 << maxlen) - 1


def _read_symbol(br: BitReader, code) -> int:
    table, mask = code
    p = br.pos
    at = p >> 3
    e = table[(int.from_bytes(br.buf[at:at + 4], "little") >> (p & 7)) & mask]
    br.pos = p + (e & 15)
    return e >> 4


def _read_code(br: BitReader, size: int):
    lengths = np.zeros(max(size, 256), np.int64)
    if br.read(1):
        n = br.read(1) + 1
        lengths[br.read(8 if br.read(1) else 1)] = 1
        if n == 2:
            lengths[br.read(8)] = 1
        lengths = lengths[:size]
    else:
        cl = np.zeros(19, np.int64)
        for i in range(br.read(4) + 4):
            cl[_CODE_LENGTH_ORDER[i]] = br.read(3)
        lc = _table(cl)
        if br.read(1):
            max_symbol = 2 + br.read(2 + 2 * br.read(3))
            if max_symbol > size:
                raise VP8LError("VP8L code length count past the alphabet")
        else:
            max_symbol = size
        lengths = np.zeros(size, np.int64)
        sym, prev = 0, 8
        while sym < size:
            if max_symbol == 0:
                break
            max_symbol -= 1
            c = _read_symbol(br, lc)
            if c < 16:
                lengths[sym] = c
                sym += 1
                if c:
                    prev = c
                continue
            extra, offset = ((2, 3), (3, 3), (7, 11))[c - 16]
            repeat = br.read(extra) + offset
            if sym + repeat > size:
                raise VP8LError("VP8L code length repeat past the alphabet")
            lengths[sym:sym + repeat] = prev if c == 16 else 0
            sym += repeat
    br.check_end()
    return _table(lengths)


def _prefix_value(br: BitReader, sym: int) -> int:
    if sym < 4:
        return sym + 1
    extra = (sym - 2) >> 1
    return ((2 + (sym & 1)) << extra) + br.read(extra) + 1


def _sub(x: int, bits: int) -> int:
    return (x + (1 << bits) - 1) >> bits


def _decode_image(br: BitReader, xsize: int, ysize: int, level0: bool, transforms=None):
    """One entropy-coded image: [ysize * xsize] ARGB (uint32 ints), after
    reading the transforms of a level-0 image into `transforms`."""
    if level0:
        seen = set()
        while br.read(1):
            kind = br.read(2)
            if kind in seen:
                raise VP8LError("VP8L transform repeated")
            seen.add(kind)
            t = {"kind": kind, "xsize": xsize}
            if kind in (PREDICTOR, CROSS_COLOR):
                t["bits"] = br.read(3) + 2
                t["data"] = _decode_image(br, _sub(xsize, t["bits"]), _sub(ysize, t["bits"]), False)
            elif kind == COLOR_INDEXING:
                n = br.read(8) + 1
                t["bits"] = 3 if n <= 2 else 2 if n <= 4 else 1 if n <= 16 else 0
                pal = np.array(_decode_image(br, n, 1, False), np.uint32).view(np.uint8)
                t["data"] = np.cumsum(pal.reshape(n, 4), 0, dtype=np.uint8).reshape(-1).view(np.uint32)
                xsize = _sub(xsize, t["bits"])
            transforms.append(t)
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= 11:
            raise VP8LError("VP8L colour cache bits out of range")
    meta_bits, meta = 0, None
    if level0 and br.read(1):
        meta_bits = br.read(3) + 2
        mw = _sub(xsize, meta_bits)
        m = _decode_image(br, mw, _sub(ysize, meta_bits), False)
        meta = [(v >> 8) & 0xFFFF for v in m]
        ngroups = max(meta) + 1
    else:
        ngroups = 1
    cache_size = (1 << cache_bits) if cache_bits else 0
    groups = []
    for _ in range(ngroups):
        groups.append([_read_code(br, s) for s in (280 + cache_size, 256, 256, 256, 40)])
    out = _pixels(br, xsize, ysize, groups, meta, meta_bits, cache_bits)
    br.check_end()
    return out


def _pixels(br, xsize, ysize, groups, meta, meta_bits, cache_bits):
    """The entropy-coded pixels (libwebp's DecodeImageData)."""
    total = xsize * ysize
    out = [0] * total
    buf = br.buf
    p = br.pos
    from_bytes = int.from_bytes
    cache = [0] * (1 << cache_bits) if cache_bits else None
    cache_shift = 32 - cache_bits
    cached = 0
    mw = _sub(xsize, meta_bits) if meta is not None else 0
    i = 0
    g = groups[0]
    x = y = 0
    while i < total:
        if meta is not None:
            g = groups[meta[(y >> meta_bits) * mw + (x >> meta_bits)]]
        tg, mg = g[0]
        at = p >> 3
        e = tg[(from_bytes(buf[at:at + 4], "little") >> (p & 7)) & mg]
        p += e & 15
        code = e >> 4
        if code < 256:
            t, m = g[1]
            at = p >> 3
            e = t[(from_bytes(buf[at:at + 4], "little") >> (p & 7)) & m]
            p += e & 15
            red = e >> 4
            t, m = g[2]
            at = p >> 3
            e = t[(from_bytes(buf[at:at + 4], "little") >> (p & 7)) & m]
            p += e & 15
            blue = e >> 4
            t, m = g[3]
            at = p >> 3
            e = t[(from_bytes(buf[at:at + 4], "little") >> (p & 7)) & m]
            p += e & 15
            out[i] = (e >> 4 << 24) | (red << 16) | (code << 8) | blue
            i += 1
            x += 1
            if x == xsize:
                x = 0
                y += 1
            continue
        if code < 280:
            br.pos = p
            length = _prefix_value(br, code - 256)
            t, m = g[4]
            p = br.pos
            at = p >> 3
            e = t[(from_bytes(buf[at:at + 4], "little") >> (p & 7)) & m]
            br.pos = p + (e & 15)
            dcode = _prefix_value(br, e >> 4)
            p = br.pos
            if dcode > 120:
                dist = dcode - 120
            else:
                d = _PLANE[dcode - 1]
                dist = max(1, (d >> 4) * xsize + 8 - (d & 15))
            if dist > i or length > total - i:
                raise VP8LError("VP8L backward reference out of the image")
            if dist >= length:
                out[i:i + length] = out[i - dist:i - dist + length]
            else:
                for k in range(i, i + length):
                    out[k] = out[k - dist]
            i += length
            x += length
            while x >= xsize:
                x -= xsize
                y += 1
        else:
            key = code - 280
            if cache is None:
                raise VP8LError("VP8L colour cache symbol without a cache")
            while cached < i:
                v = out[cached]
                cache[((0x1E35A7BD * v) & 0xFFFFFFFF) >> cache_shift] = v
                cached += 1
            out[i] = cache[key]
            i += 1
            x += 1
            if x == xsize:
                x = 0
                y += 1
        if p > br.nbits + 64:
            raise VP8LError("VP8L data ends early")
    br.pos = p
    return out


# --- inverse transforms ------------------------------------------------------

def _channels(a: np.ndarray) -> np.ndarray:
    """[..., n] uint32 ARGB -> [..., n, 4] int32 as B, G, R, A."""
    return np.ascontiguousarray(a).view(np.uint8).reshape(a.shape + (4,)).astype(np.int32)


def _pack(c: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(c.astype(np.uint8)).view(np.uint32).reshape(c.shape[:-1])


_LO, _HI = 0x00FF00FF, 0xFF00FF00


def _add(a, b):
    """Per-byte a + b (mod 256) of packed ARGB."""
    return (((a & _LO) + (b & _LO)) & _LO) | (((a & _HI) + (b & _HI)) & _HI)


def _predict(mode: int, L, T, TL, TR):
    """libwebp's predictor `mode` on [n, 4] int32 channels."""
    if mode == 0:
        return np.broadcast_to(np.array([0, 0, 0, 255], np.int32), T.shape)
    if mode <= 4:
        return (L, T, TR, TL)[mode - 1]
    if mode == 5:
        return (((L + TR) >> 1) + T) >> 1
    if mode <= 9:
        a, b = ((L, TL), (L, T), (TL, T), (T, TR))[mode - 6]
        return (a + b) >> 1
    if mode == 10:
        return (((L + TL) >> 1) + ((T + TR) >> 1)) >> 1
    if mode == 11:
        left = np.abs(T - TL).sum(1) < np.abs(L - TL).sum(1)
        return np.where(left[:, None], L, T)
    if mode == 12:
        return np.clip(L + T - TL, 0, 255)
    a = (L + T) >> 1
    d = a - TL
    return np.clip(a + np.where(d < 0, -((-d) >> 1), d >> 1), 0, 255)


def _inverse_predictor(res: np.ndarray, w: int, h: int, bits: int, data) -> np.ndarray:
    """Undo the predictor transform on [h, w] packed residuals (libwebp's
    PredictorInverseTransform_C): the first row adds black then the left
    pixel, the first column the top one, the rest the mode of its block;
    on libwebp's flat layout the top-right of a row's last pixel is the
    row's first.  Pixel (x, y) reads only pixels of smaller x + 2y, so the
    pixels of equal x + 2y are predicted at once (a wavefront), mode by
    mode."""
    res = _channels(res.reshape(-1))
    out = np.zeros_like(res)
    first = res[:w].copy()
    first[0, 3] += 255
    out[:w] = np.cumsum(first, 0) & 255
    if h == 1:
        return _pack(out).reshape(h, w)
    blocks = ((np.array(data, np.uint32) >> 8) & 15).reshape(_sub(h, bits), _sub(w, bits))
    ys, xs = np.mgrid[1:h, 0:w]
    modes = blocks[ys >> bits, xs >> bits]
    modes[:, 0] = 2
    t = (xs + 2 * ys).reshape(-1)
    flat = (ys * w + xs).reshape(-1)
    order = np.argsort(t, kind="stable")
    flat, modes, t = flat[order], modes.reshape(-1)[order], t[order]
    cuts = np.flatnonzero(np.diff(t)) + 1
    for idx, m in zip(np.split(flat, cuts), np.split(modes, cuts)):
        for mode in np.unique(m):
            i = idx[m == mode]
            pred = _predict(int(mode), out[i - 1], out[i - w], out[i - w - 1], out[i - w + 1])
            out[i] = (res[i] + pred) & 255
    return _pack(out).reshape(h, w)


def _inverse_cross_color(packed: np.ndarray, w: int, h: int, bits: int, data) -> np.ndarray:
    px = _channels(packed)
    m = _channels(np.array(data, np.uint32)).reshape(_sub(h, bits), _sub(w, bits), 4)
    m = m.astype(np.int8).astype(np.int32)
    m = np.repeat(np.repeat(m, 1 << bits, 0), 1 << bits, 1)[:h, :w]
    g2r, g2b, r2b = m[..., 0], m[..., 1], m[..., 2]
    g = px[..., 1].astype(np.uint8).astype(np.int8).astype(np.int32)
    r = (px[..., 2] + ((g2r * g) >> 5)) & 255
    b = px[..., 0] + ((g2b * g) >> 5) + ((r2b * r.astype(np.uint8).astype(np.int8).astype(np.int32)) >> 5)
    out = px.copy()
    out[..., 2] = r
    out[..., 0] = b & 255
    return _pack(out)


def _inverse_color_indexing(packed: np.ndarray, w: int, h: int, bits: int, palette) -> np.ndarray:
    idx = (packed >> 8) & 255
    if bits:
        per = 1 << bits
        bpp = 8 >> bits
        shifts = (np.arange(w) % per) * bpp
        idx = (idx[:, np.arange(w) >> bits] >> shifts) & ((1 << bpp) - 1)
    pal = np.zeros(256, np.uint32)
    pal[:len(palette)] = palette
    return pal[idx]


def decode_vp8l_image(data: bytes, w: int, h: int, br: BitReader | None = None) -> np.ndarray:
    """A headerless VP8L image of size w x h: [h, w] uint32 ARGB."""
    br = br or BitReader(data)
    transforms: list = []
    packed = _decode_image(br, w, h, True, transforms)
    xs = w
    for t in transforms:
        if t["kind"] == COLOR_INDEXING:
            xs = _sub(xs, t["bits"])
    px = np.array(packed, np.uint32).reshape(h, xs)
    for t in reversed(transforms):
        k, tw = t["kind"], t["xsize"]
        if k == PREDICTOR:
            px = _inverse_predictor(px, tw, h, t["bits"], t["data"])
        elif k == CROSS_COLOR:
            px = _inverse_cross_color(px, tw, h, t["bits"], t["data"])
        elif k == SUBTRACT_GREEN:
            g = (px >> 8) & 255
            px = _add(px, (g << 16) | g)
        else:
            px = _inverse_color_indexing(px, tw, h, t["bits"], t["data"])
    return np.ascontiguousarray(px)


def vp8l_header(data: bytes) -> tuple[int, int, bool]:
    """(width, height, alpha hint) of a VP8L stream, or an error."""
    if len(data) < 5 or data[0] != 0x2F:
        raise VP8LError("VP8L signature")
    v = int.from_bytes(data[1:5], "little")
    if v >> 29:
        raise VP8LError("VP8L version")
    return (v & 0x3FFF) + 1, ((v >> 14) & 0x3FFF) + 1, bool((v >> 28) & 1)


def decode_vp8l(data: bytes) -> np.ndarray:
    """A whole VP8L stream: [H, W] uint32 ARGB."""
    w, h, _ = vp8l_header(data)
    br = BitReader(data)
    br.pos = 40
    return decode_vp8l_image(data, w, h, br)
