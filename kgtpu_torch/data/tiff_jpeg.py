"""JPEG-compressed TIFF (compression 7), as libtiff 4.7's `tif_jpeg.c` hands
each strip or tile to libjpeg and its RGBA reader reads the result:

  * each strip or tile is a JPEG stream of its own, read after the
    abbreviated table stream of the JPEGTables tag (347) where there is one;
  * with PhotometricInterpretation YCbCr and contiguous samples, the RGBA
    reader sets JPEGCOLORMODE_RGB: libjpeg takes the data as YCbCr, whatever
    its markers say, and converts it to RGB with its own upsampling (fancy,
    as cv2's JPEG reader has it) and tables, and the image is read as RGB;
    component 0 must have the YCbCrSubsampling factors (default 2x2) and
    the others 1x1, else libtiff refuses the strip;
  * any other photometric kind suppresses libjpeg's colour handling
    (JCS_UNKNOWN): the stored components come out as they are (sampling
    factors must be 1x1), and the RGBA reader converts them as for any
    other codec (grey, RGB, CMYK, ...);
  * in separate planes each strip or tile of each plane is a stream of one
    component (sampling 1x1), read as stored and put in its plane;
  * a stream larger than its strip or tile fails, except a last strip whose
    stream is taller than the rows left, which is cut; a smaller one is
    read as far as it goes, the rest zero; the sample precision must be 8.
"""

from __future__ import annotations

import numpy as np

from kgtpu_torch.data.imread import UnreadableImage


def _join(tables: bytes | None, stream: bytes) -> bytes:
    """The strip's stream after the tables' markers (their SOI kept, their
    EOI and the strip's SOI dropped), as libjpeg reads the two in turn."""
    if not tables:
        return stream
    t = tables[:-2] if tables[-2:] == b"\xff\xd9" else tables
    return t + (stream[2:] if stream[:2] == b"\xff\xd8" else stream)


def read_jpeg_tiff(d, data: bytes) -> np.ndarray:
    """The samples ([h, w, spp] uint8) of a JPEG-compressed TIFF (`tiff._Dir`
    d), every strip or tile decoded; a YCbCr image comes out as RGB and
    `d.photo` becomes RGB, as the RGBA reader reads it on."""
    from kgtpu_torch.data.jpeg import parse
    from kgtpu_torch.data.jpeg_pixels import _plane, _ycc_to_rgb, upsample
    if d.bits != 8:
        raise UnreadableImage(f"{d.bits}-bit JPEG TIFF")
    separate = d.planar == 2 and d.spp > 1
    ycc = d.photo == 6 and not separate
    if d.photo == 6 and separate and tuple(d.get(530)) != (1, 1):
        raise UnreadableImage("TIFF YCbCr in separate planes with subsampling (cv2 cannot "
                              "read it)")
    hs, vs = d.get(530)[:2] if ycc else (1, 1)
    tables = d.tags.get(347)
    px = np.zeros((d.h, d.w, d.spp), np.uint8)
    per_block = 1 if separate else d.spp
    for k in range(len(d.grid) * (d.spp if separate else 1)):
        p, (y, x) = divmod(k, len(d.grid))[0], d.grid[k % len(d.grid)]
        rows = d.th if d.tiled else min(d.th, d.h - y)
        stored = d.raw(data, k)
        if stored is None:
            raise UnreadableImage(f"TIFF strip / tile {k} runs past the end of the file")
        img = parse(_join(tables, stored))
        comps = img["components"]
        if img["lossless"] or len(comps) != per_block:
            raise UnreadableImage("improper JPEG component count in TIFF")
        if (comps[0].h, comps[0].v) != (hs, vs) or any((c.h, c.v) != (1, 1) for c in comps[1:]):
            raise UnreadableImage("improper JPEG sampling factors in TIFF")
        jw, jh = img["width"], img["height"]
        if not d.tiled and jw == d.tw and jh > rows and y + rows == d.h:
            jh = rows                       # libtiff cuts a too-tall last strip
        if jw > d.tw or jh > rows:
            raise UnreadableImage("JPEG strip / tile larger than expected")
        frame = {"width": img["width"], "height": img["height"], "hmax": hs, "vmax": vs}
        planes = [upsample(_plane(c, frame), c.h, c.v, hs, vs)[:img["height"], :jw]
                  for c in comps]
        block = _ycc_to_rgb(*planes) if ycc else np.stack(planes, -1).astype(np.uint8)
        px[y:y + jh, x:x + jw, p:p + block.shape[-1]] = block[:jh][:d.h - y, :d.w - x]
    if ycc:
        d.photo = 2                          # read on as RGB (JPEGCOLORMODE_RGB)
    return px
