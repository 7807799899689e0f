"""BMP decoding without cv2: NumPy only.  Returns what cv2 5.0's own BMP
reader (`grfmt_bmp.cpp`) returns in the read modes of `data/imread.py`.

Reads BITMAPINFOHEADER and its V2-V5 extensions (header size 40 to 124):
1-, 4- and 8-bit palette images, 24-bit BGR and 32-bit BI_RGB or
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
  * "gray" is cv2's fixed-point BGR->grey (weights 1868, 9617, 4899 over
    2^14, rounded), on the pixels or on the palette, except on that masked
    path, whose grey is a float32 sum, truncated (`_masked_gray`).

RLE4, RLE8, 16-bit and the OS/2 header raise `UnsupportedImage`.
"""

from __future__ import annotations

import struct

import numpy as np

from kgtpu_torch.data.imread import UnreadableImage, unsupported

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


def decode_bmp(data: bytes, mode: str) -> np.ndarray:
    """The bytes of a BMP file as one of `imread.MODES`, in RGB(A) order."""
    if len(data) < 54:
        raise UnreadableImage("BMP header is truncated")
    (offset,) = struct.unpack("<I", data[10:14])
    (size,) = struct.unpack("<I", data[14:18])
    if size < 40:
        raise unsupported(f"BMP with a {size}-byte (OS/2) header")
    w, h, _, bpp, comp, _, _, _, clrused = struct.unpack("<iiHHIIiiI", data[18:50])
    if comp in (BI_RLE8, BI_RLE4) or bpp == 16:
        raise unsupported(f"BMP {bpp}-bit with compression {comp}")
    if w <= 0 or h == 0 or bpp not in (1, 4, 8, 24, 32) or comp not in (
            BI_RGB, BI_BITFIELDS) or (comp == BI_BITFIELDS and bpp != 32):
        raise UnreadableImage(f"BMP {bpp}-bit, compression {comp}, {w}x{h}")
    top_down, h = h < 0, abs(h)
    stride = (w * bpp + 31) // 32 * 4
    pixels = np.frombuffer(data, np.uint8, stride * h, offset) if (
        offset + stride * h <= len(data)) else None
    if pixels is None:
        raise UnreadableImage("BMP pixel data is truncated")
    rows = pixels.reshape(h, stride)
    if not top_down:
        rows = rows[::-1]
    if bpp <= 8:
        n = clrused or (1 << bpp)
        if n > 256:
            raise UnreadableImage(f"BMP palette of {n} entries")
        pal = np.zeros((256, 4), np.uint8)
        at = 14 + size
        entries = np.frombuffer(data[at:at + 4 * n], np.uint8)
        pal[:len(entries) // 4] = entries[:len(entries) // 4 * 4].reshape(-1, 4)
        pal = pal[:, :3]                                # B, G, R
        used = pal[:1 << bpp]
        gray_palette = bool(((used[:, 0] == used[:, 1]) & (used[:, 1] == used[:, 2])).all())
        if bpp < 8:
            per = 8 // bpp
            shifts = (bpp * np.arange(per - 1, -1, -1)).astype(np.uint8)
            idx = ((rows[:, :, None] >> shifts) & ((1 << bpp) - 1)).reshape(h, -1)[:, :w]
        else:
            idx = rows[:, :w]
        if mode == "gray":
            return np.ascontiguousarray(bgr_to_gray(pal)[idx])
        bgr = pal[idx]
        if mode == "unchanged" and gray_palette:
            return np.ascontiguousarray(bgr[..., 0])
        return np.ascontiguousarray(bgr[..., ::-1])
    if bpp == 24:
        bgr = rows[:, :w * 3].reshape(h, w, 3)
        bgra = None
    else:
        quad = rows[:, :w * 4].reshape(h, w, 4)
        bgra = None
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
    if mode == "gray":
        return _masked_gray(bgr) if comp == BI_BITFIELDS and size >= 56 else bgr_to_gray(bgr)
    if mode == "unchanged" and bgra is not None:
        return np.ascontiguousarray(bgra[..., [2, 1, 0, 3]])
    return np.ascontiguousarray(bgr[..., ::-1])
