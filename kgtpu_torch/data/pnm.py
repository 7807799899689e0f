"""PNM (P1-P6), PAM (P7) and PFM decoding without cv2: NumPy only.  Returns
what cv2 5.0's own readers return, in cv2's channel order (BGR); see
`data/imread.py` for the port's order.

PNM follows `grfmt_pxm.cpp`:

  * the header is read number by number (`ReadNumber`): whitespace and
    `#` comments (to the next CR or LF) are skipped before a number, any
    other byte fails the read, a number ends at the first non-digit,
    which is consumed (so a `#` right after a number starts no comment),
    and a number past INT_MAX fails.  The samples start right after the
    byte that ended maxval (the height for P1 / P4);
  * maxval above 65535 fails; above 255 the samples are 16-bit (big
    endian in P5 / P6) and "color" / "gray" keep their high byte;
  * ASCII samples (P2 / P3) above maxval read as maxval and, at 8 bits,
    are scaled by i * 255 // maxval; binary samples (P5 / P6) are never
    scaled, whatever maxval is.  ASCII bits (P1) are read one digit at a
    time, a non-zero digit being black;
  * bits are black for 1 (P1 / P4), MSB first, rows padded to a byte;
  * "gray" of P3 / P6 is the fixed-point BGR->grey of the RGB samples;
  * a read past the end of the data fails, the ASCII number that ends
    the file too (its terminating byte is read).

PAM follows `grfmt_pam.cpp`: header lines of an identifier (at most 8
characters) and a value, `#` comment lines and blank lines, up to ENDHDR;
HEIGHT, WIDTH, DEPTH and MAXVAL each once; TUPLTYPE one of the names cv2
knows, exactly (case too), with the DEPTH it implies (1, 1, 2, 3, 4), else
the read fails.  Without one, DEPTH 1 with MAXVAL 1 is BLACKANDWHITE, DEPTH
1 or 3 below 256 GRAYSCALE or RGB, and anything else fails ("Can't
determine selected_fmt": cv2's own 16-bit RGB PAM too).  A file whose depth
and channels the read mode matches is copied as stored (an RGB file then
reads as if it were BGR); RGB converts with the fixed-point grey; other
layouts take their first channel(s) (`basic_conversion`, see there);
MAXVAL 1 reads the first ceil(w / 8) bytes of each row's w * DEPTH sample
bytes as packed bits, 1 white, in one channel or three (never in two or
four: "unchanged" of such a file fails).

PFM follows `grfmt_pfm.cpp`: `PF` (three channels, stored RGB) or `Pf`
(one), then exactly a LF, width, height and scale as whitespace-ended
words (`atoi` / `atof`), float32 rows bottom-up, little endian when the
scale is negative.  The samples are divided by |scale| and converted to
the mode's type with saturation and rounding (no x255: 2.98 reads 3; NaN
and values past int32 read 0);
when the mode's channel count differs from the file's, cv2's read fails
(its check that the decoder wrote into imread's own buffer).
"""

from __future__ import annotations

import re

import numpy as np

from kgtpu_torch.data.bmp import bgr_to_gray
from kgtpu_torch.data.imread import UnreadableImage

_INT_MAX = 2**31 - 1
_WS = b" \t\n\v\f\r"
# one ReadNumber: skipped whitespace / comments, the digits, the byte that
# ends them (consumed)
_NUMBER = re.compile(rb"(?:[ \t\n\v\f\r]|#[^\r\n]*[\r\n])*([0-9]+)(.)", re.S)
_BIT = re.compile(rb"(?:[ \t\n\v\f\r]|#[^\r\n]*[\r\n])*([0-9])", re.S)


def cvt_gray(bgr: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(BGR2GRAY) on uint8 BGR: (B*3735 + G*19235 + R*9798 +
    2^14) >> 15 (equal to it on all 2^24 colours), one off from
    the fixed-point `bmp.bgr_to_gray` on some."""
    b, g, r = (bgr[..., i].astype(np.int32) for i in range(3))
    return ((b * 3735 + g * 19235 + r * 9798 + (1 << 14)) >> 15).astype(np.uint8)


def _numbers(data: bytes, pos: int, count: int, one_digit: bool = False):
    """`count` consecutive ReadNumber results from `pos`, and the position
    after them."""
    if count == 0:
        return np.zeros(0, np.int64), pos
    pat = _BIT if one_digit else _NUMBER
    vals = []
    for m in pat.finditer(data, pos):
        if m.start() != pos:
            break
        pos = m.end()
        vals.append(m.group(1))
        if len(vals) == count:
            break
    if len(vals) < count:
        raise UnreadableImage("PNM samples are truncated or malformed")
    if max(len(v) for v in vals) > 9:
        if max(int(v) for v in vals) > _INT_MAX:
            raise UnreadableImage("PNM number is too large")
    return np.array([int(v) for v in vals], np.int64), pos


def _header_number(data: bytes, pos: int) -> tuple[int, int]:
    v, pos = _numbers(data, pos, 1)
    return int(v[0]), pos


def _bits(packed: np.ndarray, w: int) -> np.ndarray:
    return np.unpackbits(packed, axis=-1)[..., :w]


def decode_pnm(data: bytes, mode: str) -> np.ndarray:
    kind = data[1] - ord("0")
    bpp = {1: 1, 4: 1, 2: 8, 5: 8, 3: 24, 6: 24}[kind]
    binary = kind >= 4
    w, pos = _header_number(data, 2)
    h, pos = _header_number(data, pos)
    maxval = 1
    if bpp > 1:
        maxval, pos = _header_number(data, pos)
    if maxval > 65535 or w <= 0 or h <= 0 or maxval <= 0:
        raise UnreadableImage("PNM header out of range")
    nch = 3 if bpp == 24 else 1
    wide = maxval > 255
    if bpp == 1:
        if binary:
            pitch = (w + 7) // 8
            end = pos + pitch * h
            if end > len(data):
                raise UnreadableImage("PNM data is truncated")
            black = _bits(np.frombuffer(data, np.uint8, pitch * h, pos).reshape(h, pitch), w)
        else:
            black = (_numbers(data, pos, w * h, one_digit=True)[0] != 0).reshape(h, w)
        grey = np.where(black.astype(bool), 0, 255).astype(np.uint8)
        return np.repeat(grey[..., None], 3, -1) if mode == "color" else grey
    n = w * nch * h
    if binary:
        size = 2 if wide else 1
        if pos + n * size > len(data):
            raise UnreadableImage("PNM data is truncated")
        px = np.frombuffer(data, ">u2" if wide else np.uint8, n, pos).astype(
            np.uint16 if wide else np.uint8)
    else:
        px = np.minimum(_numbers(data, pos, n)[0], maxval)
        px = (px.astype(np.uint16) if wide else
              (px * 255 // maxval).astype(np.uint8))
    px = px.reshape(h, w, nch) if nch == 3 else px.reshape(h, w)
    if wide and mode != "unchanged":
        px = (px >> 8).astype(np.uint8)
    if nch == 1:
        return np.repeat(px[..., None], 3, -1) if mode == "color" else px
    return bgr_to_gray(px[..., ::-1]) if mode == "gray" else px[..., ::-1]


# --- PAM --------------------------------------------------------------------

_PAM_FIELDS = ("ENDHDR", "HEIGHT", "WIDTH", "DEPTH", "MAXVAL", "TUPLTYPE")
_PAM_FORMATS = ("", "BLACKANDWHITE", "GRAYSCALE", "GRAYSCALE_ALPHA", "RGB", "RGB_ALPHA")
_PAM_DEPTHS = (0, 1, 1, 2, 3, 4)


class _Stream:
    """cv2's RLByteStream over the file: a read past the end fails."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise UnreadableImage("unexpected end of the file")
        self.pos += 1
        return self.data[self.pos - 1]


def _pam_line(s: _Stream):
    """ReadPAMHeaderLine: (field or None, value), or a failed read."""
    code = s.byte()
    while chr(code) in " \t\n\v\f\r":
        code = s.byte()
    if code == ord("#"):
        while code not in (10, 13):
            code = s.byte()
        return None, b""
    ident = bytearray()
    for _ in range(8):
        if chr(code) in " \t\n\v\f\r":
            break
        ident.append(code)
        code = s.byte()
    if chr(code) not in " \t\n\v\f\r":
        raise UnreadableImage("PAM header identifier is too long")
    field = None
    for f in _PAM_FIELDS:
        if f.encode() == bytes(ident).upper():
            field = f
    if field is None:
        raise UnreadableImage(f"PAM header field {bytes(ident)!r}")
    if code in (10, 13):
        return field, b""
    code = s.byte()
    while chr(code) in " \t\n\v\f\r":
        code = s.byte()
    value = bytearray()
    for _ in range(255):
        if code in (10, 13):
            break
        value.append(code)
        code = s.byte()
    value = bytes(value).rstrip(_WS)
    if code not in (10, 13):
        raise UnreadableImage("PAM header value is too long")
    return field, value


def _pam_number(value: bytes) -> int:
    """ParseNumber: strtol over the whole value, which must be a number."""
    m = re.fullmatch(rb"[ \t\n\v\f\r]*([+-]?[0-9]+)", value)
    if not m:
        raise UnreadableImage(f"PAM header number {value!r}")
    return int(m.group(1))


def decode_pam(data: bytes, mode: str) -> np.ndarray:
    if data[2:3] not in (b"\n", b"\r"):
        raise UnreadableImage("PAM signature is not followed by a line break")
    s = _Stream(data, 3)
    got: dict = {}
    fmt = 0
    while True:
        field, value = _pam_line(s)
        if field is None:
            continue
        if field == "ENDHDR":
            break
        if field == "TUPLTYPE":
            names = [i for i, n in enumerate(_PAM_FORMATS) if n and n.encode() == value]
            if not names:
                raise UnreadableImage(f"PAM TUPLTYPE {value!r}")
            fmt = names[0]
            continue
        if field in got:
            raise UnreadableImage(f"PAM {field} given twice")
        got[field] = _pam_number(value)
        if field == "MAXVAL" and got[field] > 65535:
            raise UnreadableImage("PAM MAXVAL above 65535")
    if len(got) < 4:
        raise UnreadableImage("PAM header lacks a field")
    h, w, ch, maxval = got["HEIGHT"], got["WIDTH"], got["DEPTH"], got["MAXVAL"]
    if fmt and ch != _PAM_DEPTHS[fmt]:
        raise UnreadableImage(f"PAM {_PAM_FORMATS[fmt]} with DEPTH {ch}")
    if fmt == 0:
        if ch == 1 and maxval == 1:
            fmt = 1
        elif ch == 1 and maxval < 256:
            fmt = 2
        elif ch == 3 and maxval < 256:
            fmt = 4
        else:
            raise UnreadableImage("PAM without TUPLTYPE: can't determine selected_fmt")
    if not 1 <= ch <= 4 or w <= 0 or h <= 0:
        raise UnreadableImage("PAM size or depth out of range")
    target = {"color": 3, "gray": 1, "unchanged": ch}[mode]
    if maxval == 1:
        # bits, 1 white, MSB first, at the start of each row's w * DEPTH bytes
        if target not in (1, 3):
            raise UnreadableImage(f"PAM BLACKANDWHITE read into {target} channels")
        if s.pos + w * ch * h > len(data):
            raise UnreadableImage("PAM data is truncated")
        rows = np.frombuffer(data, np.uint8, w * ch * h, s.pos).reshape(h, w * ch)
        grey = _bits(rows[:, :-(-w // 8)], w) * np.uint8(255)
        return grey if target == 1 else np.repeat(grey[..., None], 3, -1)
    wide = maxval > 255
    n = h * w * ch
    if s.pos + n * (2 if wide else 1) > len(data):
        raise UnreadableImage("PAM data is truncated")
    px = np.frombuffer(data, ">u2" if wide else np.uint8, n, s.pos).reshape(h, w, ch)
    px = px.astype(np.uint16) if wide else px
    if mode != "unchanged" and wide:
        px = (px >> 8).astype(np.uint8)
    if target == ch:
        return px[..., 0] if ch == 1 else px
    if fmt == 4:
        return bgr_to_gray(px[..., ::-1])
    return _basic_conversion(px, target, fmt == 5)


def _basic_conversion(px: np.ndarray, target: int, rgb: bool) -> np.ndarray:
    """cv2's `basic_conversion` for GRAYSCALE_ALPHA and RGB_ALPHA: its loop
    steps a sample pointer by DEPTH but stops at the row's first `width`
    samples, so only the first ceil(w / DEPTH) pixels convert; in one
    channel each writes three bytes (the next pixels' places).  What the
    loop leaves is as cv2's allocation left it: zeros here."""
    h, w, ch = px.shape
    n = -(-w // ch)
    out = np.zeros((h, w * target), np.uint8)
    if target == 3:
        first = px[:, :n, 2::-1] if rgb else np.repeat(px[:, :n, :1], 3, -1)
        out[:, :3 * n] = first.reshape(h, 3 * n)
        return out.reshape(h, w, 3)
    spread = np.repeat(px[:, :n, 0], 3, axis=1)[:, :w]
    out[:, :spread.shape[1]] = spread
    return out


# --- PFM --------------------------------------------------------------------

def saturate_u8(f: np.ndarray) -> np.ndarray:
    """cv2's float32 -> uint8 `convertTo`: rounded half to even, saturated,
    and 0 for NaN and for anything that rounds outside int32 (the SIMD
    rounding's INT_MIN)."""
    r = np.rint(f.astype(np.float64))
    ok = np.isfinite(r) & (r >= -2.0**31) & (r < 2.0**31)
    return np.where(ok, np.clip(np.where(ok, r, 0), 0, 255), 0).astype(np.uint8)


def _pfm_word(s: _Stream) -> bytes:
    out = bytearray()
    for _ in range(2048):
        c = s.byte()
        if c >= 128:
            raise UnreadableImage("PFM header byte out of range")
        if chr(c) in " \t\n\v\f\r":
            break
        out.append(c)
    return bytes(out)


def _atoi(word: bytes) -> int:
    m = re.match(rb"[ \t\n\v\f\r]*([+-]?[0-9]+)", word)
    return int(m.group(1)) if m else 0


def _atof(word: bytes) -> float:
    m = re.match(rb"[ \t\n\v\f\r]*([+-]?(?:[0-9]+\.?[0-9]*|\.[0-9]+)(?:[eE][+-]?[0-9]+)?)", word)
    return float(m.group(1)) if m else 0.0


def decode_pfm(data: bytes, mode: str) -> np.ndarray:
    ch = 3 if data[1:2] == b"F" else 1
    if data[2:3] != b"\n":
        raise UnreadableImage("PFM signature is not followed by a line feed")
    s = _Stream(data, 3)
    w = _atoi(_pfm_word(s))
    h = _atoi(_pfm_word(s))
    scale = _atof(_pfm_word(s))
    if w <= 0 or h <= 0:
        raise UnreadableImage("PFM size out of range")
    target = {"color": 3, "gray": 1, "unchanged": ch}[mode]
    if target != ch or scale == 0.0:
        raise UnreadableImage("PFM read into another channel count")
    n = h * w * ch
    if s.pos + 4 * n > len(data):
        raise UnreadableImage("PFM data is truncated")
    px = np.frombuffer(data, ">f4" if scale >= 0 else "<f4", n, s.pos)
    px = px.astype(np.float32).reshape(h, w, ch)[::-1]
    px = px * np.float32(1.0 / abs(scale)) if abs(scale) != 1.0 else px
    if mode != "unchanged":
        px = saturate_u8(px)
    px = np.ascontiguousarray(px[..., ::-1])    # cv2's BGR
    return px[..., 0] if ch == 1 else px
