"""TIFF decoding without cv2: NumPy, zlib and struct only.  Returns what
cv2 5.0 (through libtiff 4.7) returns in the read modes of `data/imread.py`.

Reads the first IFD (as cv2 does), in II or MM byte order, stored in strips
or tiles (edge tiles padded), PlanarConfiguration 1, with compression 1
(none), 5 (LZW, MSB-first codes with TIFF's early code-width change), 8 and
32946 (deflate) or 32773 (PackBits), and Predictor 2 (horizontal
differencing) at 8 and 16 bits.  Photometric kinds:

  * MinIsBlack / MinIsWhite, one sample of 8 or 16 bits, or 1 bit (bilevel);
  * RGB, three samples of 8 or 16 bits, or four of 8 bits (RGBA);
  * Palette, indices of 1, 4 or 8 bits.

cv2's rules, each checked against it:

  * 8-bit and palette images go through libtiff's RGBA reader: MinIsWhite
    and bilevel samples invert and widen (1 bit -> 0 / 255), a ColorMap
    whose entries all lie below 256 is taken as 8-bit, any other as 16-bit
    (its high byte), and unassociated alpha (ExtraSamples 2) is
    premultiplied: c * a / 255, rounded;
  * "unchanged" gives 8-bit grey, RGB and RGBA from that reader (a palette
    as RGB, but a 1-bit palette as its grey), and 16-bit samples as stored
    (MinIsWhite not inverted);
  * "color" cuts 16-bit grey to its high byte and 16-bit RGB to
    rint(x / 257) (libtiff's 16->8 table).  In a tile cut by the right edge
    the 16-bit grey reader steps each row by (tile width + width inside)
    bytes instead of twice the tile width (libtiff's `put16bitbwtile` adds
    the skew in pixels to a byte pointer), and cv2 returns what it reads
    there (`_skewed_gray16`);
  * "gray" of colour is cv2's fixed-point BGR->grey (`bmp.bgr_to_gray`) on
    the 8-bit colour above; that is not `cv2.cvtColor`, which differs on
    43,864 of the 2^24 colours;
  * Predictor 2 applies only with LZW and deflate (libtiff ignores it for
    the other codecs);
  * Orientation 2, 3 and 4 mirror and flip the image in every mode (a
    tiled image read through the RGBA reader, i.e. all but 16-bit
    "unchanged", is mirrored tile by tile, each tile where it stands), and
    orientations 5-8 make cv2's read fail (`UnreadableImage`).

Other variants cv2 reads (grey + alpha, 16-bit RGBA, separate planes,
YCbCr, CMYK, JPEG or other codecs, float samples, old-style LZW) raise
`UnsupportedImage`; grey of 2 or 4 bits and 2-bit palettes, which cv2 does
not read, raise `UnreadableImage`.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from kgtpu_torch.data.bmp import bgr_to_gray
from kgtpu_torch.data.imread import UnreadableImage, unsupported

_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 6: "b", 7: "B", 8: "h", 9: "i", 16: "Q"}
_DEFAULTS = {258: [1], 259: [1], 262: [None], 274: [1], 277: [1], 284: [1], 317: [1],
             338: [], 339: [1]}


def _ifd(data: bytes) -> tuple[dict, str]:
    """The tags of the first IFD: {tag: [values]}, and the byte order."""
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
        tags[tag] = list(struct.unpack(e + _TYPES[typ] * count, raw))
    return tags, e


def lzw_decode(src: bytes, expected: int) -> bytes:
    """TIFF LZW: 9- to 12-bit codes, most significant bit first, 256 clears
    the table and 257 ends the data; the code width grows one code early
    (at 511, 1023 and 2047 entries).  Stops after `expected` bytes."""
    if src[:2] == b"\x00\x01":
        raise unsupported("old-style (LSB-first) TIFF LZW")
    out = bytearray()
    table: list[bytes] = [bytes([i]) for i in range(256)] + [b"", b""]
    width, acc, nbits, prev = 9, 0, 0, None
    for byte in src:
        acc = (acc << 8) | byte
        nbits += 8
        if nbits < width:
            continue
        nbits -= width
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
            if len(table) >= (1 << width) - 1 and width < 12:
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


def _samples(raw: bytes, rows: int, cols: int, spp: int, bits: int, e: str,
             predictor: int) -> np.ndarray:
    """Decoded bytes of one strip or tile -> [rows, cols, spp] samples."""
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
    dt = np.dtype(e + "u2") if bits == 16 else np.dtype(np.uint8)
    v = buf.view(dt).reshape(rows, cols, spp).astype(dt.newbyteorder("="))
    if predictor == 2:
        v = np.cumsum(v, axis=1, dtype=v.dtype)
    return v


def decode_tiff(data: bytes, mode: str) -> np.ndarray:
    """The bytes of a TIFF file as one of `imread.MODES`, in RGB(A) order."""
    tags, e = _ifd(data)
    get = lambda t: tags.get(t, _DEFAULTS.get(t, [None]))  # noqa: E731
    if 256 not in tags or 257 not in tags:
        raise UnreadableImage("TIFF without ImageWidth / ImageLength")
    w, h = get(256)[0], get(257)[0]
    spp, bits, comp = get(277)[0], get(258), get(259)[0]
    photo, planar, predictor = get(262)[0], get(284)[0], get(317)[0]
    extra, fmt, orientation = get(338), get(339)[0], get(274)[0]
    if len(set(bits)) != 1:
        raise unsupported(f"TIFF with mixed bit depths {bits}")
    bits = bits[0]
    if orientation in (5, 6, 7, 8):
        raise UnreadableImage(f"TIFF Orientation {orientation} (cv2 cannot read it)")
    if photo in (0, 1, 3) and spp == 1 and bits in (2, 4) and (photo, bits) != (3, 4):
        raise UnreadableImage(f"{bits}-bit grey or palette TIFF (cv2 cannot read it)")
    kind = {(0, 1): "gray", (1, 1): "gray", (2, 3): "rgb", (2, 4): "rgba",
            (3, 1): "palette"}.get((photo, spp))
    ok_bits = {"gray": (1, 8, 16), "rgb": (8, 16), "rgba": (8,), "palette": (1, 4, 8)}
    if kind is None or bits not in ok_bits[kind] or planar != 1 or fmt != 1 or (
            photo == 3 and 320 not in tags):
        raise unsupported(f"TIFF photometric {photo}, {spp} samples of {bits} bits, "
                          f"planar {planar}, sample format {fmt}")
    if predictor not in (1, 2) or (predictor == 2 and bits < 8):
        raise unsupported(f"TIFF predictor {predictor} at {bits} bits")
    if comp not in (5, 8, 32946):
        predictor = 1                        # libtiff ignores it for other codecs
    if 322 in tags:
        tw, th = get(322)[0], get(323)[0]
        offsets, counts = get(324), get(325)
        grid = [(y, x) for y in range(0, h, th) for x in range(0, w, tw)]
    else:
        rps = min(get(278)[0] if 278 in tags else h, h)
        offsets, counts = get(273), get(279)
        tw, th = w, rps
        grid = [(y, 0) for y in range(0, h, rps)]
    if None in (offsets[0], counts[0]) or len(offsets) < len(grid) or len(counts) < len(grid):
        raise UnreadableImage("TIFF strip / tile offsets missing")
    px = np.zeros((h, w, spp), np.uint16 if bits == 16 else np.uint8)
    skewed = kind == "gray" and bits == 16 and mode != "unchanged"
    hi = np.zeros((h, w), np.uint8) if skewed else None
    for (y, x), off, cnt in zip(grid, offsets, counts):
        rows = th if 322 in tags else min(th, h - y)
        expected = rows * ((tw * spp * bits + 7) // 8)
        raw = _decompress(data[off:off + cnt], comp, expected)
        block = _samples(raw, rows, tw, spp, bits, e, predictor)
        px[y:y + th, x:x + tw] = block[:h - y, :w - x]
        if skewed:
            hi[y:y + th, x:x + tw] = _skewed_gray16(block[..., 0], min(tw, w - x))[:h - y]
    if skewed:
        px = (hi.astype(np.uint16) << 8)[..., None]     # only the high byte is read
    if orientation in (2, 3):          # libtiff's RGBA reader mirrors tile by tile
        rgba_reader = not (bits == 16 and mode == "unchanged")
        cuts = list(range(0, w, tw)) + [w] if 322 in tags and rgba_reader else [0, w]
        px = np.concatenate([px[:, a:b][:, ::-1] for a, b in zip(cuts[:-1], cuts[1:])], axis=1)
    if orientation in (3, 4):
        px = px[::-1]
    return _to_mode(px, kind, photo, bits, tags, extra, mode)


def _skewed_gray16(block: np.ndarray, inside: int) -> np.ndarray:
    """The high bytes libtiff's RGBA reader takes from a [rows, tw] 16-bit
    grey block of which `inside` columns lie in the image: row r starts
    r * (tw + inside) bytes into the block in native (little-endian) order,
    not r * 2 * tw (the whole block when inside == tw)."""
    rows, tw = block.shape
    flat = block.astype("<u2").view(np.uint8).reshape(-1)
    starts = np.arange(rows)[:, None] * (tw + inside) + 2 * np.arange(inside)[None, :] + 1
    return flat[starts]


def _to_mode(px: np.ndarray, kind: str, photo: int, bits: int, tags: dict,
             extra: list, mode: str) -> np.ndarray:
    if kind == "gray":
        g = px[..., 0]
        if bits == 1:
            g = g * np.uint8(255)
        if photo == 0 and bits != 16:        # MinIsWhite, through the RGBA reader
            g = 255 - g
        if photo == 0 and bits == 16 and mode != "unchanged":
            g = 65535 - g
        if mode == "unchanged":
            return np.ascontiguousarray(g)
        g8 = (g >> 8).astype(np.uint8) if bits == 16 else g
        return np.repeat(g8[..., None], 3, axis=-1) if mode == "color" else g8
    if kind == "palette":
        cmap = np.asarray(tags[320], np.uint32).reshape(3, -1).T
        if cmap.max(initial=0) >= 256:
            cmap = cmap >> 8
        rgb = cmap.astype(np.uint8)[np.minimum(px[..., 0], len(cmap) - 1)]
        if mode == "unchanged" and bits == 1:        # cv2 reads 1 bit as grey
            return bgr_to_gray(rgb[..., ::-1])
    elif kind == "rgb" and bits == 16:
        if mode == "unchanged":
            return np.ascontiguousarray(px)
        rgb = ((px.astype(np.uint32) * 255 + 32767) // 65535).astype(np.uint8)
    else:
        rgb = px
        if kind == "rgba" and extra[:1] == [2]:          # unassociated -> premultiplied
            a = px[..., 3:].astype(np.uint32)
            rgb = np.concatenate(
                [((px[..., :3] * a + 127) // 255).astype(np.uint8), px[..., 3:]], axis=-1)
        if mode == "unchanged":
            return np.ascontiguousarray(rgb)
        rgb = rgb[..., :3]
    if mode == "gray":
        return bgr_to_gray(rgb[..., ::-1])
    return np.ascontiguousarray(rgb)
