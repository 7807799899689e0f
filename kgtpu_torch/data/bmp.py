"""BMP decoding without cv2: NumPy only.  Returns what cv2 5.0's own BMP
reader (`grfmt_bmp.cpp`) returns in the read modes of `data/imread.py`.

Reads BITMAPINFOHEADER and its V2-V5 extensions (header size 36 to 124)
and the OS/2 BITMAPCOREHEADER (12 bytes): 1-, 4- and 8-bit palette images,
RLE8 and RLE4, 16-bit (555 and 565), 24-bit BGR and 32-bit BI_RGB or
BI_BITFIELDS, bottom-up (positive height) and top-down rows, each padded to
4 bytes.  cv2's rules, each checked against it:

  * the palette holds `biClrUsed` entries (all 2^bpp when 0); an index past
    them reads black.  A palette whose entries are all grey reads as one
    channel in "unchanged", a colour one as three;
  * 32-bit BI_RGB reads as BGR (the fourth byte dropped); 32-bit
    BI_BITFIELDS reads as BGRA in "unchanged": with a 40-byte header the
    bytes are taken as B, G, R, A whatever the masks say; with a header of
    56 bytes or more each channel is `(px & mask) >> shift` times the
    float32 255 / (mask >> shift), truncated, and a zero alpha mask reads
    255;
  * 16-bit pixels are 555 (BI_RGB, or BI_BITFIELDS with the masks 0x7C00,
    0x3E0, 0x1F) or 565 (masks 0xF800, 0x7E0, 0x1F), the masks read from
    the three words after the header (so a header longer than 40 bytes
    reads them from the palette or pixel bytes there); any other masks make
    cv2's read fail.  Each channel is its bits shifted to the top of the
    byte, the low bits zero (`icvCvt_BGR5552BGR_8u_C2C3R` and its 565
    twin);
  * RLE8 / RLE4 (`_rle`): runs and absolute stretches that would pass the
    end of the row make cv2's read fail, as does data that ends before the
    image is done; end of line, end of bitmap and delta fill the pixels
    they skip with palette entry 0, a delta moving dx + dy * width pixels
    on in raster order; in RLE8 a run that fills its row moves to the next
    one, and an end of line right after it is ignored;
  * the OS/2 header: 16-bit width and height (bottom-up), palette entries
    of 3 bytes, 2^bpp of them; 16-bit pixels fail; "unchanged" is always
    one channel (cv2's grey), whatever the depth or palette;
  * "gray" is cv2's fixed-point BGR->grey (weights 1868, 9617, 4899 over
    2^14, rounded), on the pixels or on the palette, except on that masked
    path, whose grey is a float32 sum, truncated (`_masked_gray`).
"""

from __future__ import annotations

import struct

import numpy as np

from kgtpu_torch.data.imread import UnreadableImage

BI_RGB, BI_RLE8, BI_RLE4, BI_BITFIELDS = 0, 1, 2, 3


def bgr_to_gray(bgr: np.ndarray) -> np.ndarray:
    """cv2's BGR->grey on uint8: (B*1868 + G*9617 + R*4899 + 2^13) >> 14."""
    b, g, r = (bgr[..., i].astype(np.int32) for i in range(3))
    return ((b * 1868 + g * 9617 + r * 4899 + (1 << 13)) >> 14).astype(np.uint8)


def _masked_gray(bgr: np.ndarray) -> np.ndarray:
    """The grey of cv2's masked 32-bit path: (R*0.299f + G*0.587f) + B*0.114f
    in float32, truncated (equal to cv2 on all 2^24 colours)."""
    b, g, r = (bgr[..., i].astype(np.float32) for i in range(3))
    y = (r * np.float32(0.299) + g * np.float32(0.587)) + b * np.float32(0.114)
    return y.astype(np.uint8)


def _masked(px: np.ndarray, mask: int) -> np.ndarray:
    """One channel of a BI_BITFIELDS pixel: (px & mask) >> shift times the
    float32 255 / (mask >> shift), truncated."""
    if not mask:
        return np.zeros(px.shape, np.uint8)
    shift = (mask & -mask).bit_length() - 1
    scale = np.float32(255) / np.float32(mask >> shift)
    v = ((px & np.uint32(mask)) >> np.uint32(shift)).astype(np.float32)
    return (v * scale).astype(np.uint8)


def _header(data: bytes) -> tuple:
    """(pixel offset, header size, width, height, bpp, compression, palette
    entries, bytes per palette entry)."""
    if len(data) < 26:
        raise UnreadableImage("BMP header is truncated")
    (offset,) = struct.unpack("<I", data[10:14])
    (size,) = struct.unpack("<I", data[14:18])
    if size == 12:
        w, h, _, bpp = struct.unpack("<HHHH", data[18:26])
        return offset, size, w, h, bpp, BI_RGB, 0, 3
    if size < 36 or len(data) < 50:
        raise UnreadableImage(f"BMP header of {size} bytes")
    w, h, _, bpp, comp, _, _, _, clrused = struct.unpack("<iiHHIIiiI", data[18:50])
    return offset, size, w, h, bpp, comp, clrused, 4


def _rle(data: bytes, pos: int, w: int, h: int, bpp: int) -> np.ndarray:
    """The palette indices of an RLE8 / RLE4 image, rows in file order, as
    cv2's decoder walks them (see the module docstring)."""
    idx = np.zeros(h * w, np.int64)
    x = y = 0
    flag = 0
    n = len(data)

    def fill(count: int, value: int) -> None:
        nonlocal x, y
        while True:
            end = min(x + count, w)
            count -= end - x
            idx[y * w + x:y * w + end] = value
            x = end
            if x >= w:
                x = 0
                y += 1
                if y >= h:
                    return
            if count <= 0:
                return

    while True:
        if pos + 2 > n:
            raise UnreadableImage("BMP RLE data ends before the image")
        run, code = data[pos], data[pos + 1]
        pos += 2
        if run:
            if x + run > w:
                raise UnreadableImage("BMP RLE run past the end of its row")
            if bpp == 8:
                prev = y
                fill(run, code)
                flag = y - prev
                if y >= h:
                    break
            else:
                pair = np.array([code >> 4, code & 15])
                idx[y * w + x:y * w + x + run] = np.resize(pair, run)
                x += run
        elif code > 2:
            if x + code > w:
                raise UnreadableImage("BMP RLE stretch past the end of its row")
            size = (code + 1) & ~1 if bpp == 8 else (((code + 1) >> 1) + 1) & ~1
            if pos + size > n:
                raise UnreadableImage("BMP RLE data ends before the image")
            raw = np.frombuffer(data, np.uint8, size, pos)
            pos += size
            vals = raw if bpp == 8 else np.stack([raw >> 4, raw & 15], -1).reshape(-1)
            idx[y * w + x:y * w + x + code] = vals[:code]
            x += code
            flag = 0
        else:
            dx, dy = w - x, h - y
            if bpp == 4 or code or not flag or x > 0:
                if code == 2:
                    if pos + 2 > n:
                        raise UnreadableImage("BMP RLE data ends before the image")
                    dx, dy = data[pos], data[pos + 1]
                    pos += 2
                count = dx + (dy * w if code else 0)
                if y >= h:
                    break
                fill(count, 0)
                if y >= h:
                    break
            flag = 0
            if y >= h:
                break
    return idx.reshape(h, w)


def decode_bmp(data: bytes, mode: str) -> np.ndarray:
    """The bytes of a BMP file as one of `imread.MODES`, in RGB(A) order."""
    offset, size, w, h, bpp, comp, clrused, entry = _header(data)
    os2 = size == 12
    bits16 = None
    if bpp == 16 and not os2:
        masks = struct.unpack("<III", data[14 + size:26 + size]) if len(data) >= 26 + size \
            else (0, 0, 0)
        bits16 = 555 if comp == BI_RGB or masks == (0x7C00, 0x3E0, 0x1F) else \
            565 if comp == BI_BITFIELDS and masks == (0xF800, 0x7E0, 0x1F) else None
        if comp not in (BI_RGB, BI_BITFIELDS) or bits16 is None:
            raise UnreadableImage(f"16-bit BMP with compression {comp}, masks {masks}")
    if w <= 0 or h == 0 or bpp not in (1, 4, 8, 16, 24, 32) or (os2 and bpp == 16) or not (
            comp == BI_RGB or comp == BI_BITFIELDS and bpp in (16, 32)
            or comp == BI_RLE8 and bpp == 8 or comp == BI_RLE4 and bpp == 4):
        raise UnreadableImage(f"BMP {bpp}-bit, compression {comp}, {w}x{h}")
    top_down, h = h < 0, abs(h)
    stride = (w * bpp + 31) // 32 * 4
    if comp in (BI_RLE8, BI_RLE4):
        rows = None
    else:
        if offset + stride * h > len(data):
            raise UnreadableImage("BMP pixel data is truncated")
        rows = np.frombuffer(data, np.uint8, stride * h, offset).reshape(h, stride)
    if bpp <= 8:
        n = clrused or (1 << bpp)
        if n > 256:
            raise UnreadableImage(f"BMP palette of {n} entries")
        pal = np.zeros((256, 4), np.uint8)
        at = 14 + size
        entries = np.frombuffer(data[at:at + entry * n], np.uint8)
        k = len(entries) // entry
        pal[:k, :entry] = entries[:k * entry].reshape(k, entry)
        pal = pal[:, :3]                                # B, G, R
        used = pal[:1 << bpp]
        gray_palette = os2 or bool(((used[:, 0] == used[:, 1]) & (used[:, 1] == used[:, 2])).all())
        if rows is None:
            idx = _rle(data, offset, w, h, bpp)
        elif bpp < 8:
            per = 8 // bpp
            shifts = (bpp * np.arange(per - 1, -1, -1)).astype(np.uint8)
            idx = ((rows[:, :, None] >> shifts) & ((1 << bpp) - 1)).reshape(h, -1)[:, :w]
        else:
            idx = rows[:, :w]
        if not top_down:
            idx = idx[::-1]
        if mode == "gray" or mode == "unchanged" and gray_palette:
            return np.ascontiguousarray(bgr_to_gray(pal)[idx])
        return np.ascontiguousarray(pal[idx][..., ::-1])
    if not top_down:
        rows = rows[::-1]
    bgra = None
    if bpp == 16:
        t = rows[:, :w * 2].reshape(h, w, 2).view("<u2")[..., 0].astype(np.int32)
        if bits16 == 555:
            bgr = np.stack([(t << 3) & 0xF8, (t >> 2) & 0xF8, (t >> 7) & 0xF8], -1)
        else:
            bgr = np.stack([(t << 3) & 0xF8, (t >> 3) & 0xFC, (t >> 8) & 0xF8], -1)
        bgr = bgr.astype(np.uint8)
    elif bpp == 24:
        bgr = rows[:, :w * 3].reshape(h, w, 3)
    else:
        quad = rows[:, :w * 4].reshape(h, w, 4)
        if comp == BI_BITFIELDS:
            if size >= 56:
                r, g, b, a = struct.unpack("<IIII", data[54:70])
                px = quad.view("<u4")[..., 0]
                bgra = np.stack([_masked(px, b), _masked(px, g), _masked(px, r),
                                 _masked(px, a) if a else np.full(px.shape, 255, np.uint8)],
                                axis=-1)
            else:
                bgra = quad
        bgr = quad[..., :3] if bgra is None else bgra[..., :3]
    if mode == "gray" or mode == "unchanged" and os2:
        return _masked_gray(bgr) if comp == BI_BITFIELDS and size >= 56 and bpp == 32 \
            else bgr_to_gray(bgr)
    if mode == "unchanged" and bgra is not None:
        return np.ascontiguousarray(bgra[..., [2, 1, 0, 3]])
    return np.ascontiguousarray(bgr[..., ::-1])
