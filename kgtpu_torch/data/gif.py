"""GIF decoding without cv2: NumPy only.  Returns what cv2 5.0's own GIF
reader (`grfmt_gif.cpp`) returns, in cv2's channel order (BGR / BGRA); see
`data/imread.py` for the port's order.  Only the first frame is read, as
cv2.imread reads it.

cv2's rules, each checked against it:

  * the whole block structure is walked (extensions and every frame's
    sub-blocks) up to the trailer; a file without one, or cut anywhere,
    fails the read;
  * "unchanged" has four channels when any Graphic Control Extension of
    the file sets the transparency flag (an animation PIL writes does),
    else three;
  * the canvas (the logical screen) starts as the global table's
    background colour, alpha 0 (black without a global table; a
    background index past the global table fails the read); the first
    frame's pixels are drawn on it with alpha 255, except those equal to
    its transparent index, which leave the canvas;
  * a frame that is empty or does not lie inside the canvas, or an index
    past the frame's colour table (local, else global), fails the read; a
    file with neither table reads index i as grey i, except 1 as white; a
    Graphic Control Extension whose block is not 4 bytes fails the read;
  * LZW (`_lzw`): codes of min size + 1 bits growing to 12, LSB first
    over the sub-blocks; a clear code resets the table; with a full table
    codes go on at 12 bits and add nothing; the end code resets the table
    too and ends decoding only when no byte is left; decoding stops at the
    first code after the frame is full, and a frame left short, a code
    past the table or a byte left unread fails the read;
  * interlaced frames store rows 0, 8, ...; 4, 12, ...; 2, 6, ...; 1, 3,
    ...;
  * "gray" is cv2.cvtColor(BGR2GRAY) of the colour canvas.
"""

from __future__ import annotations

import struct

import numpy as np

from kgtpu_torch.data.imread import UnreadableImage
from kgtpu_torch.data.pnm import cvt_gray


# the colours of a file with neither a global nor a local table: index i
# reads grey i, except 1, which reads white
_DEFAULT = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
_DEFAULT[1] = 255


def _sub_blocks(data: bytes, pos: int) -> tuple[bytes, int]:
    """The concatenated sub-blocks from `pos` and the position after their
    terminator."""
    parts = []
    n = len(data)
    while True:
        if pos >= n:
            raise UnreadableImage("GIF sub-blocks are cut short")
        size = data[pos]
        pos += 1
        if size == 0:
            return b"".join(parts), pos
        if pos + size > n:
            raise UnreadableImage("GIF sub-blocks are cut short")
        parts.append(data[pos:pos + size])
        pos += size


def _lzw(stream: bytes, min_size: int, count: int) -> np.ndarray:
    """The `count` indices of a frame's LZW stream (its sub-blocks joined),
    decoded as cv2's lzwDecode walks it: a byte is read whenever fewer bits
    than a code are left, and the codes in hand are decoded; the end code
    resets the table as the clear code does, and decoding goes on only if
    bytes are left to read; the first code read once the frame is full
    (whatever its value) or a code whose string would pass the frame's
    end stops it.  A frame left short, a code past the table, or a byte
    left unread fails the read."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    out = bytearray()
    table = [bytes([i & 255]) for i in range(clear)] + [b"", b""]
    width = min_size + 1
    prev = None
    pos = left = read = 0
    buf = stream + b"\0\0\0"
    done = False
    while read < len(stream) and not done:
        if left < width:
            read += 1
            left += 8
        while left >= width:
            at = pos >> 3
            code = (int.from_bytes(buf[at:at + 3], "little") >> (pos & 7)) & ((1 << width) - 1)
            pos += width
            left -= width
            if code in (clear, end):
                del table[end + 1:]
                width = min_size + 1
                prev = None
                if code == end:
                    break
                continue
            if len(out) == count:
                done = True
                break
            if prev is None:
                if code >= len(table):
                    raise UnreadableImage("GIF LZW code past the table")
                entry = table[code]
            elif code < len(table):
                entry = table[code]
                if len(table) < 4096:
                    table.append(prev + entry[:1])
            elif code == len(table) and len(table) < 4096:
                entry = prev + prev[:1]
                table.append(entry)
            else:
                raise UnreadableImage("GIF LZW code past the table")
            if len(out) + len(entry) > count:
                done = True
                break
            out += entry
            prev = entry
            if len(table) == (1 << width) and width < 12:
                width += 1
    if len(out) < count:
        raise UnreadableImage("GIF LZW data ends before the frame")
    if read < len(stream):
        raise UnreadableImage("GIF LZW data left after the frame")
    return np.frombuffer(bytes(out), np.uint8)


def _table(data: bytes, pos: int, flags: int) -> tuple[np.ndarray, int]:
    n = 2 << (flags & 7)
    if pos + 3 * n > len(data):
        raise UnreadableImage("GIF colour table is cut short")
    return np.frombuffer(data, np.uint8, 3 * n, pos).reshape(n, 3), pos + 3 * n


def decode_gif(data: bytes, mode: str) -> np.ndarray:
    if len(data) < 13:
        raise UnreadableImage("GIF header is cut short")
    w, h, flags, bg = struct.unpack("<HHBB", data[6:12])
    pos = 13
    gct = None
    if flags & 0x80:
        gct, pos = _table(data, pos, flags)
        if bg >= len(gct):
            raise UnreadableImage("GIF background index past the global table")
    if w == 0 or h == 0:
        raise UnreadableImage("GIF screen is empty")
    first = None
    alpha = False
    transparent = None
    while True:
        if pos >= len(data):
            raise UnreadableImage("GIF has no trailer")
        kind = data[pos]
        pos += 1
        if kind == 0x3B:
            break
        if kind == 0x21:
            if pos >= len(data):
                raise UnreadableImage("GIF extension is cut short")
            label = data[pos]
            if label == 0xF9 and data[pos + 1:pos + 2] != b"\x04":
                raise UnreadableImage("GIF graphic control block is not 4 bytes")
            body, pos = _sub_blocks(data, pos + 1)
            if label == 0xF9 and len(body) >= 4 and body[0] & 1:
                alpha = True
                if first is None:
                    transparent = body[3]
            continue
        if kind != 0x2C:
            raise UnreadableImage(f"GIF block 0x{kind:02x}")
        if pos + 9 > len(data):
            raise UnreadableImage("GIF image descriptor is cut short")
        left, top, fw, fh, lflags = struct.unpack("<HHHHB", data[pos:pos + 9])
        pos += 9
        lct = None
        if lflags & 0x80:
            lct, pos = _table(data, pos, lflags)
        if pos >= len(data):
            raise UnreadableImage("GIF image data is cut short")
        min_size = data[pos]
        stream, pos = _sub_blocks(data, pos + 1)
        if first is None:
            first = (left, top, fw, fh, lflags, lct, min_size, stream, transparent)
    if first is None:
        raise UnreadableImage("GIF has no image")
    left, top, fw, fh, lflags, lct, min_size, stream, transparent = first
    table = lct if lct is not None else gct if gct is not None else _DEFAULT
    if left + fw > w or top + fh > h or fw * fh == 0:
        raise UnreadableImage("GIF frame outside the screen or empty")
    if not 2 <= min_size <= 11:
        raise UnreadableImage("GIF LZW minimum code size out of range")
    idx = _lzw(stream, min_size, fw * fh).reshape(fh, fw)
    if lflags & 0x40:
        order = np.concatenate([np.arange(0, fh, 8), np.arange(4, fh, 8),
                                np.arange(2, fh, 4), np.arange(1, fh, 2)])
        rows = np.empty_like(idx)
        rows[order] = idx
        idx = rows
    if int(idx.max()) >= len(table):
        raise UnreadableImage("GIF index past the colour table")
    canvas = np.zeros((h, w, 4), np.uint8)
    if gct is not None:
        canvas[..., :3] = gct[bg, ::-1]
    region = canvas[top:top + fh, left:left + fw]
    drawn = idx != transparent if transparent is not None else np.ones(idx.shape, bool)
    region[drawn, :3] = table[idx[drawn], ::-1]
    region[drawn, 3] = 255
    if mode == "gray":
        return cvt_gray(canvas[..., :3])
    return canvas if mode == "unchanged" and alpha else canvas[..., :3]
