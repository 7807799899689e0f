"""`read_image`: the port's `cv2.imread`, for every format kgtpu's readers
read, with NumPy, zlib and struct only.

    read_image(path, "color")     = cv2.imread(IMREAD_COLOR) + BGR->RGB:
                                    [H, W, 3] uint8 RGB
    read_image(path, "gray")      = cv2.imread(IMREAD_GRAYSCALE): [H, W] uint8
    read_image(path, "unchanged") = cv2.imread(IMREAD_UNCHANGED): the stored
                                    samples ([H, W] grey, or colour in the
                                    file's order RGB / RGBA, where cv2 gives
                                    BGR / BGRA), uint8 or uint16, or
                                    float32 (PFM, Radiance HDR, float TIFF)

The codec is picked from the file's first bytes, as cv2 sniffs content, not
from its extension: PNG, JPEG, TIFF and BMP, and the other containers cv2
5.0 reads whatever the file is called (`_CONTAINER_DECODERS`: PNM / PAM /
PFM, Sun raster, Radiance HDR, GIF, WebP, JPEG 2000, AVIF).  Each codec
follows cv2 5.0 and the library cv2 hands it to (libpng, libjpeg-turbo,
libtiff, libwebp, OpenJPEG, libavif over libaom, cv2's own BMP, PxM, PAM,
PFM, Sun raster, HDR and GIF readers): see the module of each.  EXIF orientation is applied as cv2
applies it: to JPEG, PNG and WebP in the "color" and "gray" modes, never in
"unchanged"; TIFF applies its own Orientation tag in the decoder (see
`data/tiff.py`).

A file cv2 cannot read (its imread returns None) raises `UnreadableImage`, a
FileNotFoundError as kgtpu's readers raise, from the decoder that meets the
fault: a damaged or cut file too (each decoder checks what its library
checks; no other exception class is meant to escape).  A damaged file cv2
reads reads the same: what each library keeps of it (libjpeg's block
smoothing and fake EOI, libtiff's codecs keeping the rows they decoded,
its CCITT recovery).  A file cv2 reads and the port does not yet raises
`UnsupportedImage`, a ValueError naming the ROADMAP item that queues it: of
the variants (`QUEUED`) only 16- to 64-bit separate-plane TIFF in
"unchanged" (cv2's result not defined), a Group 3 CCITT strip whose data
ends before its last row (libtiff reads on past the end) and an AVIF whose
av1C promises more bits than its frame holds, in "unchanged" (cv2's result
not defined); of the containers (`CONTAINERS`) an AVIF frame that needs
an AV1 filter still queued (film grain; named in the message) or whose
size differs from its ispe (libavif rescales it).
JPEG 2000 is read whole as OpenJPEG 2.5.3 reads it for cv2: every Part 1
code-block style, HT code-blocks (Part 15) and Part 2's multi-component
markers (see `data/jpeg2000.py`); AVIF, its frames' deblocking, CDEF,
superres and loop restoration included, as libavif 1.4.2 over libaom
3.14.1 (see `data/avif.py`).
"""

from __future__ import annotations

import struct
from importlib import import_module

import numpy as np

MODES = ("color", "gray", "unchanged")
QUEUED = "ROADMAP §1: image-format variants still to port"
CONTAINERS = "ROADMAP §1: image containers beyond PNG, JPEG, TIFF and BMP"


class UnreadableImage(FileNotFoundError, ValueError):
    """A file cv2.imread cannot read either (it returns None for it)."""


class UnsupportedImage(ValueError):
    """A variant cv2.imread reads but the port does not yet."""


def unsupported(what: str, item: str = QUEUED) -> UnsupportedImage:
    return UnsupportedImage(f"{what} is not ported yet ({item})")


def _avif(data: bytes) -> bool:
    """An ISO-BMFF file that cv2's AVIF decoder takes: libavif parses its
    first 500 bytes (`avif.signature`)."""
    if data[4:8] != b"ftyp":
        return False
    from kgtpu_torch.data.avif import signature
    return signature(data)


def other_container(data: bytes) -> str | None:
    """The name of a container cv2 5.0 reads beyond PNG, JPEG, TIFF and BMP,
    by the signature its decoder's checkSignature accepts, or None."""
    ws = data[2:3] in (b" ", b"\t", b"\n", b"\v", b"\f", b"\r")
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WebP"
    if data[:12] == b"\0\0\0\x0cjP  \r\n\x87\n" or data[:4] == b"\xff\x4f\xff\x51":
        return "JPEG 2000"
    if data[:1] == b"P" and ws and data[1:2] in (b"1", b"2", b"3", b"4", b"5", b"6"):
        return "PNM"
    if data[:2] == b"P7" and ws:
        return "PAM"
    if data[:2] in (b"PF", b"Pf") and ws:
        return "PFM"
    if data[:4] == b"\x59\xa6\x6a\x95":
        return "Sun raster"
    if data[:6] == b"#?RGBE" or data[:10] == b"#?RADIANCE":
        return "Radiance HDR"
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return "GIF"
    if _avif(data):
        return "AVIF"
    return None


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


# The containers ported beyond PNG, JPEG, TIFF and BMP: each decoder returns
# cv2's Mat for the mode, in cv2's channel order (BGR / BGRA).
_CONTAINER_DECODERS = {
    "PNM": ("kgtpu_torch.data.pnm", "decode_pnm"),
    "PAM": ("kgtpu_torch.data.pnm", "decode_pam"),
    "PFM": ("kgtpu_torch.data.pnm", "decode_pfm"),
    "Sun raster": ("kgtpu_torch.data.sunras", "decode_sunras"),
    "Radiance HDR": ("kgtpu_torch.data.hdr", "decode_hdr"),
    "GIF": ("kgtpu_torch.data.gif", "decode_gif"),
    "WebP": ("kgtpu_torch.data.webp", "decode_webp"),
    "JPEG 2000": ("kgtpu_torch.data.jpeg2000", "decode_jpeg2000"),
    "AVIF": ("kgtpu_torch.data.avif", "decode_avif"),
}


def port_order(img: np.ndarray) -> np.ndarray:
    """cv2's BGR / BGRA in the port's RGB / RGBA (other layouts as they are)."""
    if img.ndim == 3 and img.shape[2] in (3, 4):
        img = img[..., [2, 1, 0, 3][:img.shape[2]]]
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
        kind = other_container(data)
        if kind in _CONTAINER_DECODERS:
            module, name = _CONTAINER_DECODERS[kind]
            return port_order(getattr(import_module(module), name)(data, mode))
        if kind is not None:
            raise unsupported(f"{kind} content", CONTAINERS)
        raise UnreadableImage("not an image format cv2 reads")
    except (UnreadableImage, UnsupportedImage) as e:
        raise type(e)(f"{path}: {e}") from None
