"""`read_image`: the port's `cv2.imread`, for every format kgtpu's readers
read (PNG, JPEG, TIFF, BMP), with NumPy, zlib and struct only.

    read_image(path, "color")     = cv2.imread(IMREAD_COLOR) + BGR->RGB:
                                    [H, W, 3] uint8 RGB
    read_image(path, "gray")      = cv2.imread(IMREAD_GRAYSCALE): [H, W] uint8
    read_image(path, "unchanged") = cv2.imread(IMREAD_UNCHANGED): the stored
                                    samples ([H, W] grey, or colour in the
                                    file's order RGB / RGBA, where cv2 gives
                                    BGR / BGRA), uint8 or uint16

The codec is picked from the file's first bytes, as cv2 sniffs content, not
from its extension.  Each codec follows cv2 5.0 and the library cv2 hands it
to (libpng, libjpeg-turbo, libtiff, cv2's own BMP reader): see the module of
each.  EXIF orientation is applied as cv2 applies it: to JPEG and PNG in the
"color" and "gray" modes, never in "unchanged"; TIFF applies its own
Orientation tag in the decoder (see `data/tiff.py`).

A file cv2 cannot read (its imread returns None) raises `UnreadableImage`, a
FileNotFoundError as kgtpu's readers raise; a variant cv2 reads but the port
does not yet raises `UnsupportedImage`, a ValueError naming the ROADMAP item.
"""

from __future__ import annotations

import struct

import numpy as np

MODES = ("color", "gray", "unchanged")
QUEUED = "ROADMAP §1: image-format variants still to port"


class UnreadableImage(FileNotFoundError, ValueError):
    """A file cv2.imread cannot read either (it returns None for it)."""


class UnsupportedImage(ValueError):
    """A variant cv2.imread reads but the port does not yet."""


def unsupported(what: str) -> UnsupportedImage:
    return UnsupportedImage(f"{what} is not ported yet ({QUEUED})")


def exif_orientation(tiff: bytes) -> int:
    """The Orientation (tag 0x0112) of IFD0 of a TIFF-structured EXIF block,
    or 1.  As cv2's ExifReader does, the value is the first 16-bit word of
    the entry's value field, whatever type the entry declares; a block that
    does not start with a TIFF header has none."""
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    e = "<" if tiff[:2] == b"II" else ">"
    (ifd,) = struct.unpack(e + "I", tiff[4:8])
    if ifd + 2 > len(tiff):
        return 1
    (n,) = struct.unpack(e + "H", tiff[ifd:ifd + 2])
    for k in range(n):
        at = ifd + 2 + 12 * k
        if at + 12 > len(tiff):
            break
        tag, = struct.unpack(e + "H", tiff[at:at + 2])
        if tag == 0x0112:
            (v,) = struct.unpack(e + "H", tiff[at + 8:at + 10])
            return v
    return 1


def orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """`img` ([H, W] or [H, W, C]) as cv2's ApplyExifOrientation leaves it:
    2 mirrors, 3 turns 180 degrees, 4 flips, 5 transposes, 6 turns 90
    degrees clockwise, 7 transposes across the other diagonal, 8 turns 90
    degrees counter-clockwise; any other value leaves it."""
    if orientation in (5, 6, 7, 8):
        img = img.swapaxes(0, 1)
    flip = {2: (False, True), 3: (True, True), 4: (True, False), 6: (False, True),
            7: (True, True), 8: (True, False)}.get(orientation)
    if flip is not None:
        if flip[0]:
            img = img[::-1]
        if flip[1]:
            img = img[:, ::-1]
    return np.ascontiguousarray(img)


def check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"read mode {mode!r} is not one of {MODES}")


def read_image(path: str, mode: str = "color") -> np.ndarray:
    """Read an image file in one of MODES (see the module docstring)."""
    check_mode(mode)
    try:
        with open(path, "rb") as f:
            data = f.read()
    except IsADirectoryError:
        raise UnreadableImage(path) from None
    try:
        if data[:8] == b"\x89PNG\r\n\x1a\n":
            from kgtpu_torch.data.png import decode_png_mode
            return decode_png_mode(data, mode)
        if data[:3] == b"\xff\xd8\xff":
            from kgtpu_torch.data.jpeg import decode_jpeg
            return decode_jpeg(data, mode)
        if data[:4] in (b"II*\x00", b"MM\x00*"):
            from kgtpu_torch.data.tiff import decode_tiff
            return decode_tiff(data, mode)
        if data[:2] == b"BM":
            from kgtpu_torch.data.bmp import decode_bmp
            return decode_bmp(data, mode)
        raise UnreadableImage("not an image format cv2 reads (PNG, JPEG, TIFF or BMP)")
    except (UnreadableImage, UnsupportedImage) as e:
        raise type(e)(f"{path}: {e}") from None
