"""PNG reading and writing without cv2: zlib and NumPy only.

Reads PNG in every colour type (0 grey, 2 RGB, 3 palette, 4 grey + alpha,
6 RGBA) and bit depth (1, 2, 4, 8, 16), plain or Adam7-interlaced, with any
of the five row filters, and returns what the JAX package's reads return
(cv2 5.0, which hands PNG to libpng):

  * "color"     = cv2.imread(IMREAD_COLOR) + BGR->RGB: [H, W, 3] uint8 RGB;
    alpha dropped, grey and palette expanded (grey below 8 bits by bit
    replication), 16-bit samples cut to their high byte;
  * "gray"      = cv2.imread(IMREAD_GRAYSCALE): [H, W] uint8; colour
    converted with libpng's fixed-point weights (`_to_gray`);
  * "unchanged" = cv2.imread(IMREAD_UNCHANGED): grey as [H, W] uint8 or
    uint16 (the label maps; below 8 bits replicated to 8), colour in the
    file's channel order (RGB / RGBA, where cv2 gives BGR / BGRA); grey +
    alpha widened to RGBA, and a tRNS chunk on a palette or RGB image made
    an alpha channel, as cv2 does (a grey image's tRNS is ignored).

An eXIf chunk's Orientation turns the image in the "color" and "gray" modes
as cv2 turns it (`imread.orient`), wherever the chunk stands; the first one
counts.  `read_png` reads label PNGs; `imread.read_image` reads PNG through
`decode_png_mode`.

`write_png` writes grey, RGB or RGBA arrays of uint8 or uint16 (filter 0 on
every row), which cv2.imread(IMREAD_UNCHANGED) reads back unchanged.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from kgtpu_torch.data.imread import MODES, UnreadableImage, check_mode, exif_orientation, orient

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7 passes: (x0, y0, dx, dy)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
         (1, 0, 2, 2), (0, 1, 1, 2))


class PNGFormatError(UnreadableImage):
    """The file is not a PNG libpng reads (cv2.imread returns None for it)."""


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body, crc = data[pos + 8:pos + 8 + n], data[pos + 8 + n:pos + 12 + n]
        if len(crc) < 4 or zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise PNGFormatError(f"corrupt PNG chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise PNGFormatError("PNG ends without IEND")


def _unfilter(filtered: np.ndarray, height: int, width: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters: filtered [H, 1 + W * bpp] bytes (the filter
    type first on every row) -> [H, W, bpp] uint8.

    Pixel (r, x) depends on (r, x - 1), (r - 1, x) and (r - 1, x - 1), so
    every anti-diagonal r + x = d depends only on the two before it: the rows
    are skewed so that a diagonal is one column, and the loop runs over the
    H + W - 1 columns, vectorised down each."""
    ftype = filtered[:, 0]
    if int(ftype.max(initial=0)) > 4:
        raise PNGFormatError(f"unknown PNG row filter {int(ftype.max())}")
    f = filtered[:, 1:].reshape(height, width, bpp).astype(np.int16)
    skew = np.zeros((height, height + width, bpp), np.int16)
    rows = np.arange(height)[:, None]
    skew[rows, rows + np.arange(width)[None, :]] = f
    out = np.zeros((height + 1, height + width + 1, bpp), np.int16)
    t = ftype[:, None]
    sub, up, avg, paeth = t == 1, t == 2, t == 3, t == 4
    any_paeth = bool(paeth.any())
    for d in range(height + width - 1):
        a = out[1:, d]                       # left:     (r, x - 1)
        b = out[:-1, d]                      # up:       (r - 1, x)
        pred = np.where(sub, a, np.where(up, b, np.where(avg, (a + b) >> 1, 0)))
        if any_paeth:
            c = out[:-1, d - 1] if d else np.zeros_like(a)   # up-left
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            pp = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
            pred = np.where(paeth, pp, pred)
        out[1:, d + 1] = (skew[:, d] + pred) & 255
    res = out[1:, 1:]
    return res[rows, rows + np.arange(width)[None, :]].astype(np.uint8)


def _unpack(rows: np.ndarray, width: int, depth: int) -> np.ndarray:
    """[H, rowbytes] bytes of 1-, 2- or 4-bit samples -> [H, width] uint8."""
    per = 8 // depth
    shifts = (depth * np.arange(per - 1, -1, -1)).astype(np.uint8)
    v = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return v.reshape(len(rows), -1)[:, :width]


def _decode_pass(raw: np.ndarray, pos: int, height: int, width: int, ch: int,
                 depth: int) -> tuple[np.ndarray, int]:
    """One (sub-)image of `height` x `width` from the inflated stream at `pos`:
    ([height, width, ch] samples, the position after it)."""
    rowbytes = (width * ch * depth + 7) // 8
    n = height * (1 + rowbytes)
    if raw.size < pos + n:
        raise PNGFormatError("PNG image data is truncated")
    bpp = max(ch * depth // 8, 1)
    px = _unfilter(raw[pos:pos + n].reshape(height, -1), height, rowbytes // bpp, bpp)
    px = px.reshape(height, rowbytes)
    if depth < 8:
        px = _unpack(px, width, depth)
    elif depth == 16:
        px = (px[:, 0::2].astype(np.uint16) << 8) | px[:, 1::2]
    return px.reshape(height, width, ch), pos + n


def decode_png(data: bytes) -> dict:
    """The stored image: {"pixels": [H, W, C] uint8 or uint16 (palette
    indices for colour type 3; grey below 8 bits replicated to 8 bits),
    "color_type", "palette": [n, 3] uint8 or None, "alpha": palette alpha
    [n] or None, "key": the RGB tRNS colour or None, "orientation"}."""
    if data[:8] != SIGNATURE:
        raise PNGFormatError("not a PNG file")
    header, idat, palette, trns, exif = None, [], None, None, None
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            if len(body) != 13:
                raise PNGFormatError("PNG IHDR of a bad length")
            header = struct.unpack(">IIBBBBB", body)
            if max(header[:2]) > 1_000_000 or header[0] * header[1] > 1 << 30:
                raise PNGFormatError("PNG larger than libpng's limits or cv2 reads")
        elif kind == b"PLTE":
            if len(body) % 3:
                raise PNGFormatError("PNG PLTE of a bad length")
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"eXIf" and exif is None and body[:2] in (b"II", b"MM"):
            exif = body
    if header is None:
        raise PNGFormatError("PNG without IHDR")
    width, height, depth, ctype, _, _, interlace = header
    if depth not in _DEPTHS.get(ctype, ()) or interlace > 1 or (
            ctype == 3 and palette is None):
        raise PNGFormatError(f"invalid PNG: colour type {ctype}, bit depth {depth}, "
                             f"interlace {interlace}")
    ch = _CHANNELS[ctype]
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise PNGFormatError(f"corrupt PNG image data: {e}") from None
    if not interlace:
        px, _ = _decode_pass(raw, 0, height, width, ch, depth)
    else:
        px = np.zeros((height, width, ch), np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for x0, y0, dx, dy in ADAM7:
            h, w = (height - y0 + dy - 1) // dy, (width - x0 + dx - 1) // dx
            if h > 0 and w > 0:
                px[y0::dy, x0::dx], pos = _decode_pass(raw, pos, h, w, ch, depth)
    if ctype == 0 and depth < 8:
        px = px * np.uint8(255 // ((1 << depth) - 1))
    alpha = key = None
    if ctype == 3 and trns is not None:
        alpha = np.full(len(palette), 255, np.uint8)
        alpha[:len(trns)] = np.frombuffer(trns, np.uint8)[:len(palette)]
    if ctype == 2 and trns is not None and len(trns) >= 6:
        key = np.array(struct.unpack(">HHH", trns[:6]), px.dtype)
    return {"pixels": px, "color_type": ctype, "palette": palette, "alpha": alpha,
            "key": key, "orientation": exif_orientation(exif or b"")}


def _to8(px: np.ndarray) -> np.ndarray:
    return (px >> 8).astype(np.uint8) if px.dtype == np.uint16 else px


def _rgb(img: dict) -> np.ndarray:
    """[H, W, 3] in the stored depth: alpha dropped, grey and palette expanded."""
    px, ct = img["pixels"], img["color_type"]
    if ct == 3:
        return img["palette"][np.minimum(px[..., 0], len(img["palette"]) - 1)]
    if ct in (0, 4):
        return np.repeat(px[..., :1], 3, axis=-1)
    return px[..., :3]


def _to_gray(rgb: np.ndarray) -> np.ndarray:
    """RGB -> grey as cv2 gets it from libpng (`png_set_rgb_to_gray` with
    weights 0.299 and 0.587): 15-bit fixed-point weights 9797, 19234 and
    3737, applied in the stored depth; truncated at 8 bits, rounded at 16
    bits and then cut to the high byte.  Grey pixels (R = G = B) pass
    unchanged."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    y = r * 9797 + g * 19234 + b * 3737
    if rgb.dtype == np.uint16:
        y = (y + 16384) >> 15
    else:
        y = y >> 15
    y = np.where((r == g) & (g == b), r, y)
    return _to8(y.astype(rgb.dtype))


def to_mode(img: dict, mode: str) -> np.ndarray:
    """A decoded image as one of the read modes (see the module docstring)."""
    px, ct = img["pixels"], img["color_type"]
    if mode == "color":
        return np.ascontiguousarray(_to8(_rgb(img)))
    if mode == "gray":
        if ct in (0, 4):
            return np.ascontiguousarray(_to8(px[..., 0]))
        return _to_gray(_rgb(img))
    if mode == "unchanged":
        if ct == 0:
            return np.ascontiguousarray(px[..., 0])
        if ct == 2 and img["key"] is not None:   # the tRNS colour -> alpha 0
            opaque = (px != img["key"]).any(-1, keepdims=True)
            return np.concatenate(
                [px, (opaque * np.iinfo(px.dtype).max).astype(px.dtype)], axis=-1)
        if ct == 3:
            rgb = _rgb(img)
            return rgb if img["alpha"] is None else np.concatenate(
                [rgb, img["alpha"][px[..., :1]]], axis=-1)
        if ct == 4:                      # cv2 widens grey + alpha to 4 channels
            return np.concatenate([_rgb(img), px[..., 1:]], axis=-1)
        return np.ascontiguousarray(px)
    raise ValueError(f"read mode {mode!r} is not one of {MODES}")


def decode_png_mode(data: bytes, mode: str) -> np.ndarray:
    """The bytes of a PNG file as one of MODES, EXIF orientation applied
    where cv2 applies it."""
    img = decode_png(data)
    out = to_mode(img, mode)
    return out if mode == "unchanged" else orient(out, img["orientation"])


def read_png(path: str, mode: str = "color") -> np.ndarray:
    """Read a PNG file in one of MODES (see the module docstring)."""
    check_mode(mode)
    with open(path, "rb") as f:
        data = f.read()
    try:
        return decode_png_mode(data, mode)
    except PNGFormatError as e:
        raise PNGFormatError(f"{path}: {e}") from None


def write_png(path: str, img: np.ndarray) -> None:
    """Write [H, W] grey, [H, W, 3] RGB or [H, W, 4] RGBA, uint8 or uint16,
    as PNG to `path` (no filter on any row)."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG samples must be uint8 or uint16, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[-1] not in (1, 3, 4):
        raise ValueError(f"cannot write an image of shape {img.shape} as PNG")
    h, w, c = img.shape
    ctype = {1: 0, 3: 2, 4: 6}[c]
    depth = 8 * img.dtype.itemsize
    rows = np.ascontiguousarray(img.astype(img.dtype.newbyteorder(">"))).view(np.uint8)
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rows.reshape(h, -1)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    data = (SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)
