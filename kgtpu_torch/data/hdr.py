"""Radiance HDR (RGBE) decoding without cv2: NumPy only.  Returns what cv2
5.0's reader (`grfmt_hdr.cpp` over Bruce Walter's `rgbe.cpp`) returns, in
cv2's channel order (BGR); see `data/imread.py` for the port's order.

cv2's rules, each checked against it:

  * the header is read line by line as `fgets` reads it (up to a LF, at
    most 127 bytes) up to a blank line; one of its lines must be exactly
    `FORMAT=32-bit_rle_rgbe` + LF (a CR before the LF, a trailing space or
    `32-bit_rle_xyze` alone fail the read); other lines are ignored;
  * the line after the blank one must match `sscanf("-Y %d +X %d")`: only
    the standard orientation is read (`+Y`, `-X` or `+X` first fail);
  * pixels: a width of 8 to 32767 takes the new-style run-length coding
    when a row starts with 2 2 and a byte below 128; the row's four
    channels are then coded one after the other in runs (a count above
    128 repeats the next byte count - 128 times) and literal stretches,
    and the two width bytes must equal the width.  A row that does not
    start so switches the rest of the image to flat 4-byte RGBE, which
    is also what any other width reads (an old-style run, 1 1 1 n, reads
    as a pixel);
  * a pixel with exponent e > 0 is (r, g, b) * 2^(e - 136) in float32,
    else 0; "unchanged" is that float32 image; "color" is
    round(saturate(255 * x)); "gray" is cv2.cvtColor(BGR2GRAY) of "color"
    (`pnm.cvt_gray`, not the fixed-point grey of the other readers);
  * data that ends early, a zero or overlong run, or a wrong row width
    fails the read.
"""

from __future__ import annotations

import re

import numpy as np

from kgtpu_torch.data.imread import UnreadableImage
from kgtpu_torch.data.pnm import cvt_gray, saturate_u8

_SIZE = re.compile(rb"-Y[ \t\n\v\f\r]*([+-]?[0-9]+)[ \t\n\v\f\r]*\+X[ \t\n\v\f\r]*([+-]?[0-9]+)")


def _fgets(data: bytes, pos: int) -> tuple[bytes, int]:
    if pos >= len(data):
        raise UnreadableImage("Radiance header is truncated")
    end = data.find(b"\n", pos, pos + 127)
    end = min(pos + 127, len(data)) if end < 0 else end + 1
    return data[pos:end], end


def _header(data: bytes) -> tuple[int, int, int]:
    pos, found = 0, False
    while True:
        line, pos = _fgets(data, pos)
        if line == b"FORMAT=32-bit_rle_rgbe\n":
            found = True
        elif line[:1] in (b"\n", b"\0"):
            break
    if not found:
        raise UnreadableImage("Radiance header has no FORMAT=32-bit_rle_rgbe")
    line, pos = _fgets(data, pos)
    m = _SIZE.match(line)
    if not m:
        raise UnreadableImage("Radiance size line is not -Y h +X w")
    h, w = int(m.group(1)), int(m.group(2))
    if w <= 0 or h <= 0:
        raise UnreadableImage("Radiance size out of range")
    return h, w, pos


def _rle_row(data: bytes, pos: int, w: int) -> tuple[np.ndarray, int]:
    """One new-style row after its 4-byte start: [w, 4] RGBE."""
    row = np.empty(4 * w, np.uint8)
    at, n = 0, len(data)
    for c in range(4):
        end = (c + 1) * w
        while at < end:
            if pos + 2 > n:
                raise UnreadableImage("Radiance data is truncated")
            count, v = data[pos], data[pos + 1]
            pos += 2
            if count > 128:
                count -= 128
                if count > end - at:
                    raise UnreadableImage("Radiance run passes the row")
                row[at:at + count] = v
                at += count
                continue
            if count == 0 or count > end - at:
                raise UnreadableImage("Radiance literal run is empty or too long")
            if pos + count - 1 > n:
                raise UnreadableImage("Radiance data is truncated")
            row[at] = v
            row[at + 1:at + count] = np.frombuffer(data, np.uint8, count - 1, pos)
            pos += count - 1
            at += count
    return row.reshape(4, w).T, pos


def decode_hdr(data: bytes, mode: str) -> np.ndarray:
    h, w, pos = _header(data)
    rgbe = np.empty((h * w, 4), np.uint8)
    done = 0
    if 8 <= w <= 0x7FFF:
        while done < h * w:
            if pos + 4 > len(data):
                raise UnreadableImage("Radiance data is truncated")
            start = data[pos:pos + 4]
            if start[0] != 2 or start[1] != 2 or start[2] & 0x80:
                break
            if (start[2] << 8 | start[3]) != w:
                raise UnreadableImage("Radiance row width differs from the image's")
            rgbe[done:done + w], pos = _rle_row(data, pos + 4, w)
            done += w
    rest = h * w - done
    if pos + 4 * rest > len(data):
        raise UnreadableImage("Radiance data is truncated")
    rgbe[done:] = np.frombuffer(data, np.uint8, 4 * rest, pos).reshape(rest, 4)
    e = rgbe[:, 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(np.float32(1), e - 136).astype(np.float32), np.float32(0))
    px = (rgbe[:, 2::-1].astype(np.float32) * scale[:, None]).reshape(h, w, 3)
    if mode == "unchanged":
        return px
    with np.errstate(over="ignore"):
        bgr = saturate_u8(px * np.float32(255))
    return cvt_gray(bgr) if mode == "gray" else bgr
