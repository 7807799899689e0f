"""WebP decoding without cv2 or libwebp: NumPy only.  Returns what cv2 5.0's
reader (`grfmt_webp.cpp` over libwebp 1.5: `WebPDecodeBGR(A)Into`, or
`WebPAnimDecoder` for an animation) returns, in cv2's channel order (BGR /
BGRA); see `data/imread.py` for the port's order.

The container (libwebp's `src/dec/webp_dec.c`): RIFF / WEBP, then a VP8
(lossy, `data/vp8.py`) or VP8L (lossless, `data/vp8l.py`) chunk, or a VP8X
header whose chunks (ICCP, EXIF, XMP, unknown ones; ALPH) come before the
image chunk.  cv2's rules, each checked against it:

  * the RIFF size must be at least 12 and at most the file's length - 8
    (a cut file fails); bytes past it are ignored; chunks are padded to
    even sizes; an image chunk's decoder reads all the data after its
    start (so a stream cut inside its chunk may read the padding byte and
    the chunks that follow); a VP8X chunk must be 10 bytes and its canvas must equal
    the image's size;
  * "unchanged" has four channels when the image has alpha: the VP8L
    header's bit of a simple lossless file, the VP8X flag of any other (an
    ALPH chunk without the flag is decoded and dropped), else three; "color" drops the alpha;
    "gray" is cv2.cvtColor(BGR2GRAY) of the colour image; the Orientation
    of a VP8X file's EXIF chunk (a TIFF header and IFD0) is applied in
    "color" and "gray", as cv2 applies it to JPEG and PNG;
  * ALPH (`_alpha`): a header byte of method (0 raw, 1 VP8L without its
    header, the green channel), filter (none, horizontal, vertical,
    gradient; `src/dsp/filters.c`'s unfilters) and pre-processing (read
    and ignored); reserved bits, an unknown method or too little raw data
    fail the read;
  * an animation (VP8X animation flag) reads through libwebp's animation
    decoder: its first frame (an ANMF chunk: offset, size and the frame's
    own ALPH + VP8 or VP8L) drawn on a transparent black canvas of the
    VP8X size.
"""

from __future__ import annotations

import struct

import numpy as np

from kgtpu_torch.data.imread import UnreadableImage, exif_orientation, orient
from kgtpu_torch.data.pnm import cvt_gray
from kgtpu_torch.data.vp8l import VP8LError, decode_vp8l, decode_vp8l_image, vp8l_header

ALPHA_FLAG, ANIMATION_FLAG = 0x10, 0x02


def _chunks(data: bytes, pos: int, end: int):
    """(fourcc, payload, the data from the payload to `end`) of each chunk
    from `pos`: libwebp hands an image chunk's decoder all the data left,
    so its last partition may read past the chunk."""
    while pos + 8 <= end:
        tag = data[pos:pos + 4]
        (size,) = struct.unpack("<I", data[pos + 4:pos + 8])
        if pos + 8 + size > end:
            raise UnreadableImage(f"WebP chunk {tag!r} is cut short")
        yield tag, data[pos + 8:pos + 8 + size], data[pos + 8:end]
        pos += 8 + size + (size & 1)


def _unfilter(a: np.ndarray, method: int) -> np.ndarray:
    """libwebp's alpha unfilters (`src/dsp/filters.c`): horizontal adds the
    left value (the first of each row the one above, of row 0 nothing);
    vertical adds the one above (row 0 as horizontal); gradient adds
    clip(left + above - above-left) (column 0 and row 0 as horizontal)."""
    a = a.astype(np.int32)
    h, w = a.shape
    out = np.zeros_like(a)
    out[0] = np.cumsum(a[0]) & 255
    for y in range(1, h):
        prev = out[y - 1]
        if method == 1:
            out[y] = (np.cumsum(a[y]) + prev[0]) & 255
        elif method == 2:
            out[y] = (prev + a[y]) & 255
        else:
            row = a[y].tolist()
            p = prev.tolist()
            left = p[0]
            r = [0] * w
            for x in range(w):
                if x:
                    g = left + p[x] - p[x - 1]
                    left = (row[x] + (0 if g < 0 else 255 if g > 255 else g)) & 255
                else:
                    left = (row[0] + p[0]) & 255
                r[x] = left
            out[y] = r
    return out.astype(np.uint8)


def _alpha(chunk: bytes, w: int, h: int) -> np.ndarray:
    if not chunk:
        raise UnreadableImage("WebP ALPH chunk is empty")
    head = chunk[0]
    method, filt, pre, rsrv = head & 3, (head >> 2) & 3, (head >> 4) & 3, head >> 6
    if method > 1 or pre > 1 or rsrv:
        raise UnreadableImage("WebP ALPH header cv2 does not read")
    if method == 0:
        if len(chunk) - 1 < w * h:
            raise UnreadableImage("WebP raw alpha is cut short")
        a = np.frombuffer(chunk, np.uint8, w * h, 1).reshape(h, w)
    else:
        try:
            a = ((decode_vp8l_image(chunk[1:], w, h) >> 8) & 255).astype(np.uint8)
        except VP8LError as e:
            raise UnreadableImage(str(e)) from None
    return _unfilter(a, filt) if filt else a


def _image(image: bytes, rest: bytes, lossless: bool, alph: bytes | None):
    """(BGRA [h, w, 4] uint8, has alpha) of one image chunk's payload
    `image`, decoded from `rest` (the payload and the data after it)."""
    if lossless:
        try:
            w, h, has_alpha = vp8l_header(image)
            argb = decode_vp8l(rest)
        except VP8LError as e:
            raise UnreadableImage(str(e)) from None
        return argb.view(np.uint8).reshape(h, w, 4), has_alpha
    from kgtpu_torch.data.vp8 import VP8Error, decode_vp8
    from kgtpu_torch.data.vp8_pixels import yuv_to_bgr
    try:
        frame = decode_vp8(rest, len(image))
    except VP8Error as e:
        raise UnreadableImage(str(e)) from None
    bgr = yuv_to_bgr(*frame)
    h, w = bgr.shape[:2]
    out = np.empty((h, w, 4), np.uint8)
    out[..., :3] = bgr
    out[..., 3] = 255 if alph is None else _alpha(alph, w, h)
    return out, alph is not None


def _image_size(image: bytes, lossless: bool) -> tuple[int, int]:
    if lossless:
        try:
            w, h, _ = vp8l_header(image)
        except VP8LError as e:
            raise UnreadableImage(str(e)) from None
        return w, h
    if len(image) < 10 or image[3:6] != b"\x9d\x01\x2a" or image[0] & 1:
        raise UnreadableImage("VP8 frame header")
    w, h = struct.unpack("<HH", image[6:10])
    return w & 0x3FFF, h & 0x3FFF


def _frame_chunks(chunks):
    """(ALPH payload or None, image payload, the data from it on, lossless)
    among `chunks`: the first image chunk and the first ALPH before it."""
    alph = None
    for tag, body, rest in chunks:
        if tag == b"ALPH" and alph is None:
            alph = body
        elif tag in (b"VP8 ", b"VP8L"):
            return (None if tag == b"VP8L" else alph), body, rest, tag == b"VP8L"
    raise UnreadableImage("WebP has no image chunk")


def _first_frame(data: bytes, pos: int, end: int, cw: int, ch: int) -> np.ndarray:
    """The first ANMF frame on a transparent canvas (libwebp's
    WebPAnimDecoder for a key frame)."""
    for tag, body, _ in _chunks(data, pos, end):
        if tag != b"ANMF":
            continue
        if len(body) < 16:
            raise UnreadableImage("WebP ANMF chunk is cut short")
        x = 2 * int.from_bytes(body[0:3], "little")
        y = 2 * int.from_bytes(body[3:6], "little")
        fw = 1 + int.from_bytes(body[6:9], "little")
        fh = 1 + int.from_bytes(body[9:12], "little")
        if x + fw > cw or y + fh > ch:
            raise UnreadableImage("WebP frame outside the canvas")
        alph, image, rest, lossless = _frame_chunks(_chunks(body, 16, len(body)))
        if _image_size(image, lossless) != (fw, fh):
            raise UnreadableImage("WebP frame size differs from its image's")
        px, _ = _image(image, rest, lossless, alph)
        canvas = np.zeros((ch, cw, 4), np.uint8)
        canvas[y:y + fh, x:x + fw] = px
        return canvas
    raise UnreadableImage("WebP animation has no frame")


def decode_webp(data: bytes, mode: str) -> np.ndarray:
    if len(data) < 12:
        raise UnreadableImage("WebP header is cut short")
    (riff,) = struct.unpack("<I", data[4:8])
    if riff < 12 or riff > len(data) - 8:
        raise UnreadableImage("WebP RIFF size out of range or file cut short")
    end = riff + 8
    first = data[12:16]
    if first == b"VP8X":
        (size,) = struct.unpack("<I", data[16:20])
        if size != 10 or end < 30:
            raise UnreadableImage("WebP VP8X chunk is not 10 bytes")
        flags = data[20]
        cw = 1 + int.from_bytes(data[24:27], "little")
        ch = 1 + int.from_bytes(data[27:30], "little")
        exif = next((body for tag, body, _ in _chunks(data, 30, end) if tag == b"EXIF"), b"")
        if flags & ANIMATION_FLAG:
            bgra = _first_frame(data, 30, end, cw, ch)
            has_alpha = bool(flags & ALPHA_FLAG)
        else:
            alph, image, rest, lossless = _frame_chunks(_chunks(data, 30, end))
            if _image_size(image, lossless) != (cw, ch):
                raise UnreadableImage("WebP canvas size differs from the image's")
            bgra, _ = _image(image, rest, lossless, alph)
            has_alpha = bool(flags & ALPHA_FLAG)
    else:
        exif = b""
        _, image, rest, lossless = _frame_chunks(_chunks(data, 12, end))
        bgra, has_alpha = _image(image, rest, lossless, None)
    if mode != "unchanged":
        bgra = orient(bgra, exif_orientation(exif))
    if mode == "gray":
        return cvt_gray(bgra[..., :3])
    if mode == "unchanged" and has_alpha:
        return bgra
    return np.ascontiguousarray(bgra[..., :3])
