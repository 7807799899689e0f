"""Sun raster decoding without cv2: NumPy only.  Returns what cv2 5.0's own
reader (`grfmt_sunras.cpp`) returns, in cv2's channel order (BGR); see
`data/imread.py` for the port's order.

The 32-byte big-endian header gives width, height, depth, length, type,
map type and map length.  cv2's rules, each checked against it:

  * depth 1, 8, 24 or 32, a positive width and height, and type 0 (old)
    or 1 (standard); cv2 5.0 compares the byte-encoded (RLE, 2) and RGB
    (3) types against the decoder's image type, still unset when the
    header is read, so it reads neither (nor any other type);
  * no colour map (map type 0, length 0), or an RGB one (map type 1) of
    at most 3 * 2^depth bytes on a depth of 8 or less: length // 3
    entries stored as all reds, all greens, all blues; entries past them
    and indices past 2^depth read black.  A map whose first 2^depth
    entries are all grey reads as one channel in "unchanged";
  * rows are padded to 16 bits;
  * without a colour map, 1- and 8-bit images read through a grey ramp
    (0..255) in "color" and as zeros in "gray" and "unchanged" (cv2 fills
    that mode's grey table only from a colour map);
  * 24-bit pixels are stored B, G, R; 32-bit ones X, B, G, R;
  * "gray" is cv2's fixed-point BGR->grey, of the pixels or the map;
  * data that ends before the last row fails the read.
"""

from __future__ import annotations

import struct

import numpy as np

from kgtpu_torch.data.bmp import bgr_to_gray
from kgtpu_torch.data.imread import UnreadableImage


def decode_sunras(data: bytes, mode: str) -> np.ndarray:
    if len(data) < 32:
        raise UnreadableImage("Sun raster header is truncated")
    _, w, h, bpp, _, kind, maptype, maplen = struct.unpack(">8i", data[:32])
    if not (w > 0 and h > 0 and bpp in (1, 8, 24, 32) and kind in (0, 1)):
        raise UnreadableImage("Sun raster size, depth or type cv2 does not read")
    palette = np.zeros((256, 3), np.uint8)          # BGR
    if maptype == 0 and maplen == 0:
        colour = bpp > 8
    elif maptype == 1 and 0 < maplen <= (3 << bpp if bpp <= 8 else 0):
        if 32 + maplen > len(data):
            raise UnreadableImage("Sun raster colour map is truncated")
        n = maplen // 3
        cmap = np.frombuffer(data, np.uint8, 3 * n, 32).reshape(3, n)
        palette[:n] = cmap[::-1].T
        used = palette[:1 << bpp]
        colour = bool(np.any(used != used[:, :1]))
    else:
        raise UnreadableImage("Sun raster colour map cv2 does not read")
    pitch = ((w * bpp + 7) // 8 + 1) & -2
    pos = 32 + maplen
    if pos + pitch * h > len(data):
        raise UnreadableImage("Sun raster data is truncated")
    rows = np.frombuffer(data, np.uint8, pitch * h, pos).reshape(h, pitch)
    if bpp > 8:
        px = rows[:, :w * 3] if bpp == 24 else rows[:, :w * 4].reshape(h, w, 4)[..., 1:]
        px = px.reshape(h, w, 3)
        return bgr_to_gray(px) if mode == "gray" else px
    idx = np.unpackbits(rows, axis=1)[:, :w] if bpp == 1 else rows[:, :w]
    if maptype == 0:
        if mode != "color":
            return np.zeros((h, w), np.uint8)
        ramp = (np.arange(1 << bpp) * 255 // ((1 << bpp) - 1)).astype(np.uint8)
        return np.repeat(ramp[idx][..., None], 3, -1)
    if mode == "gray" or (mode == "unchanged" and not colour):
        return bgr_to_gray(palette)[idx]
    return palette[idx]
