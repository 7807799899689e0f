#!/usr/bin/env python
"""Make the image-format and dataset fixtures of the PyTorch port under
assets_torch/formats/, and kgtpu's references for them.

    python tools/make_torch_format_assets.py [--out assets_torch]
        [--only variants|variants2|containers|jpeg2000|jpeg2000_styles|jpeg2000_ht|avif|
                avif_folder]

Runs on the CPU where cv2, PIL, jax and kgtpu are installed (after
tools/make_torch_eval_assets.py, whose synthetic_hard images and flagship it
reads), and writes:

  formats/jpeg/<id>.jpg        the 16 synthetic_hard test images as baseline
                               JPEG: cv2, quality 95, 4:2:0, a restart
                               interval of 8 MCUs
  formats/mixed/               4 of them, cut to their central 256x256, each
                               as progressive JPEG (cv2), tiled TIFF with
                               deflate and predictor 2 (written here: PIL
                               ignores tile=), LZW strip TIFF (PIL), 16-bit
                               RGB TIFF (cv2, deflate) and 24-bit BMP (cv2)
  formats/coco_annotations.json  COCO annotations over formats/jpeg (file
                               names images/<id>.jpg): each instance of the
                               label maps as polygons (its outer contours), as
                               uncompressed RLE (every 5th instance) or as
                               compressed RLE (every 7th), plus one iscrowd
                               region and one RLE of half the image size
  formats/neural_cells/        a neural-cells tree of 10 ids: images/ as
                               deflate TIFF (256x256 cuts of 10 more images),
                               labels/<id>.png (uint16) for 8 ids, masks/<id>/
                               for the other 2 (PNG, BMP and TIFF masks and a
                               stray text file that no reader can read)
  kgtpu_reference_formats.npz  `decode_json`: for every fixture and read mode,
                               the sha256, shape and dtype of cv2.imread's
                               result in RGB order (kgtpu's reads);
                               `labels_<dtype>`, `counts_<dtype>` and
                               `metrics_json`: kgtpu's own float32 and
                               bfloat16 runs of the flagship over
                               formats/jpeg, as kgtpu_reference.npz holds
                               them for the PNGs; `datasets_json`: the sha256
                               of the image and label map of every sample of
                               kgtpu's coco and neural_cells readers, per
                               split, on the layouts `dataset_layout` builds.
  formats/variants/<id>.<ext>  the 16 synthetic_hard test images at 512x512,
                               each stored in one of the image-format
                               variants of `VARIANTS` (two or three of every
                               group: TIFF layouts, TIFF photometric kinds,
                               four-component and lossless JPEG, arithmetic
                               JPEG, JPEG in TIFF, BMP, CCITT), written with
                               PIL, cv2 and tools/variant_encoders.py; and
                               in kgtpu_reference_formats.npz
                               `variants_decode_json` (cv2's decode of each
                               in every mode: sha256, shape, dtype, or null
                               where cv2 returns None), `variants_kinds_json`
                               ({file: variant}), and kgtpu's own flagship
                               runs over the folder, `labels_variants_<dtype>`,
                               `counts_variants_<dtype>`, `variants_ids` and
                               `variants_metrics_json`.

  formats/containers/<id>.<ext>  the 16 synthetic_hard test images at
                               512x512, each in one of the containers of
                               `CONTAINERS` that cv2 5.0 reads beyond PNG,
                               JPEG, TIFF and BMP (PPM, PGM, PAM, PBM, Sun
                               raster, Radiance HDR, plain / interlaced /
                               animated / transparent GIF, lossless / lossy /
                               alpha / animated / simple-filter WebP), each
                               named with one of kgtpu's extensions (cv2 picks
                               the decoder by content); and the
                               `containers_*` / `*_containers_*` keys as for
                               the variants.

  formats/jpeg2000/<id>.<ext>  the first 8 synthetic_hard test images at
                               512x512, each in one JPEG 2000 kind of
                               `JPEG2000` (cv2's lossless default and two
                               of its rates; PIL's raw codestream with the
                               9/7 wavelet and three layers, tiles with
                               RPCL and precincts, PCRL with 32x32
                               code-blocks, 3 resolutions and no colour
                               transform, RGBA with CPRL and 7 resolutions,
                               16-bit grey with RLCP), named with kgtpu's
                               extensions; and the `jpeg2000_*` /
                               `*_jpeg2000_*` keys as for the variants.

  formats/jpeg2000_styles/<kind>.<ext>  decode-only JPEG 2000 files of
                               128x128 cuts of the synthetic_hard images in
                               the code-block styles of `JPEG2000_STYLES`
                               (BYPASS, RESET, TERMALL, VSC, PTERM, SEGSYM
                               alone, all six, lossless and 9/7 in three
                               layers, grey in several layers, 16-bit grey),
                               written by libopenjp2 through
                               tools/variant_encoders.jpeg2000_opj; and
                               `jpeg2000_styles_decode_json` /
                               `jpeg2000_styles_kinds_json` as for the
                               variants.  The lossless ones are checked to
                               decode (cv2) to the pixels written.

  formats/jpeg2000_ht/<kind>.<ext>  decode-only JPEG 2000 files of HT
                               code-blocks (Part 15), 128x128 cuts as above,
                               one per kind of `JPEG2000_HT` (RGB and grey
                               lossless, 9/7, 16-bit grey, RGBA, tiles with
                               precincts, 4x4 and 16x8 code-blocks with
                               RPCL, SigProp + MagRef, two layers with VSC)
                               and one with Part 2 MCT / MCC / MCO offsets,
                               written by tools/variant_encoders.jpeg2000_ht;
                               `jpeg2000_ht_decode_json` /
                               `jpeg2000_ht_kinds_json` as for the variants.
                               The lossless ones are checked to decode (cv2)
                               to the pixels written.

  formats/avif/<kind>.avif     decode-only AVIF files, 128x128 cuts of the
                               synthetic_hard images, one per kind of
                               `AVIF_KINDS` (written by `write_avif`: cv2's
                               lossless RGB, grey, RGBA, 10 and 12 bits; PIL's
                               lossy 4:2:0 at two qualities, one with
                               quantiser matrices, 4:2:2, 4:4:4 with aom's
                               in-loop filters off, screen content with
                               palettes, 2x2 tiles, 128x128 superblocks, an
                               image sequence; libaom's own encoder through
                               tools/variant_encoders.aom_encode: lossy
                               monochrome, intra block copy on a 128x768
                               strip (the copy needs 5 superblocks of 64 to
                               its left), a 2x2 grid; and kinds whose frames
                               need AV1's deblocking, or deblocking and CDEF
                               (`AVIF_FILTERS`): cv2's quality 90 and 80 and
                               10-bit quality 80, PIL's default, 4:2:2 with
                               CDEF and 128x128 superblocks with CDEF,
                               libaom's delta loop filter levels);
                               `avif_decode_json` /
                               `avif_kinds_json` as for the variants.  The
                               lossless ones are checked to decode (cv2) to
                               the pixels written.

  formats/avif_folder/<id><ext>  the first AVIF_FOLDER synthetic_hard
                               images at 512x512 as AVIF under kgtpu's
                               extensions (cv2's lossless and quality 80,
                               PIL's lossy 4:2:0 and 4:4:4 without in-loop
                               filters and its default), served by
                               `chip_smoke.py` [18](b); `avif_folder_*` and
                               `*_avif_folder_*` keys as for the variants.

`--only variants`, `--only containers`, `--only jpeg2000`, `--only
jpeg2000_styles`, `--only jpeg2000_ht`, `--only avif` or `--only
avif_folder` writes that folder alone and adds
its keys to the existing kgtpu_reference_formats.npz, keeping every other
array as it is.  The fixtures and the reference together
stay under 8 MiB (the variants under 8 MiB of their own, the containers and
the JPEG 2000 folder, each with their keys, under 6 MiB).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import struct
import sys
import tempfile
import zlib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
MODES = ("color", "gray", "unchanged")
MIXED_IDS = 4
NEURAL_IDS = 10
NEURAL_MASK_IDS = 2


def sha(a) -> str:
    import numpy as np
    a = np.ascontiguousarray(a)
    return hashlib.sha256(a.tobytes()).hexdigest()


def tiled_tiff(path: str, img, tile: int = 128) -> None:
    """An 8-bit RGB TIFF in tiles, deflate with predictor 2 (PIL cannot
    write tiles); cv2 reading it back is the check that it is valid."""
    import numpy as np
    h, w, c = img.shape
    blocks = []
    for y in range(0, h, tile):
        for x in range(0, w, tile):
            t = np.zeros((tile, tile, c), np.uint8)
            sub = img[y:y + tile, x:x + tile]
            t[:sub.shape[0], :sub.shape[1]] = sub
            d = t.astype(np.int16)
            d[:, 1:] = d[:, 1:] - t[:, :-1]
            blocks.append(zlib.compress((d & 255).astype(np.uint8).tobytes(), 9))
    data = bytearray(b"II*\0\0\0\0\0")
    offsets = []
    for b in blocks:
        offsets.append(len(data))
        data += b + b"\0" * (len(b) % 2)
    bits_at = len(data)
    data += struct.pack("<3H", 8, 8, 8) + b"\0\0"
    offs_at = len(data)
    data += struct.pack(f"<{len(blocks)}I", *offsets)
    cnts_at = len(data)
    data += struct.pack(f"<{len(blocks)}I", *[len(b) for b in blocks])
    tags = [(256, 4, 1, w), (257, 4, 1, h), (258, 3, 3, bits_at), (259, 3, 1, 8),
            (262, 3, 1, 2), (277, 3, 1, 3), (284, 3, 1, 1), (317, 3, 1, 2),
            (322, 3, 1, tile), (323, 3, 1, tile), (324, 4, len(blocks), offs_at),
            (325, 4, len(blocks), cnts_at)]
    ifd = len(data)
    data[4:8] = struct.pack("<I", ifd)
    data += struct.pack("<H", len(tags))
    for tag, typ, count, value in tags:
        if typ == 3 and count == 1:
            val = struct.pack("<HH", value, 0)
        else:                           # a LONG, or the offset of the values
            val = struct.pack("<I", value)
        data += struct.pack("<HHI", tag, typ, count) + val
    data += struct.pack("<I", 0)
    with open(path, "wb") as f:
        f.write(bytes(data))


def rle_encode(mask, compressed: bool):
    """COCO RLE of a bool mask: column-major runs, background first; the
    compressed form is pycocotools' string codec."""
    import numpy as np
    flat = mask.reshape(-1, order="F").astype(np.uint8)
    runs, cur, n = [], 0, 0
    for v in flat:
        if v == cur:
            n += 1
        else:
            runs.append(n)
            cur, n = v, 1
    runs.append(n)
    if not compressed:
        return runs
    out = []
    for i, x in enumerate(runs):
        if i > 2:
            x -= runs[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


def coco_annotations(labels: dict) -> dict:
    """annotations.json over formats/jpeg (see the module docstring)."""
    import cv2
    import numpy as np
    images, anns = [], []
    aid = 1
    for n, (iid, lab) in enumerate(sorted(labels.items())):
        h, w = lab.shape
        images.append({"id": n + 1, "file_name": f"images/{iid}.jpg", "height": h, "width": w})
        for k in range(1, int(lab.max()) + 1):
            m = lab == k
            if not m.any():
                continue
            if k % 7 == 0 or k % 5 == 0:
                seg = {"counts": rle_encode(m, compressed=k % 7 == 0), "size": [h, w]}
            else:
                cs, _ = cv2.findContours(m.astype(np.uint8), cv2.RETR_EXTERNAL,
                                         cv2.CHAIN_APPROX_SIMPLE)
                seg = [c.reshape(-1).astype(float).tolist() for c in cs if len(c) >= 3]
                if not seg:
                    continue
            anns.append({"id": aid, "image_id": n + 1, "category_id": 1, "iscrowd": 0,
                         "segmentation": seg})
            aid += 1
        if n == 0:        # a crowd region, which the readers skip
            anns.append({"id": aid, "image_id": 1, "category_id": 1, "iscrowd": 1,
                         "segmentation": [[0, 0, 60, 0, 60, 60, 0, 60]]})
            aid += 1
        if n == 1:        # an RLE of half the size: resized to the image, nearest
            half = np.zeros((h // 2, w // 2), bool)
            half[10:40, 20:70] = True
            anns.append({"id": aid, "image_id": 2, "category_id": 1, "iscrowd": 0,
                         "segmentation": {"counts": rle_encode(half, True),
                                          "size": [h // 2, w // 2]}})
            aid += 1
    return {"images": images, "annotations": anns,
            "categories": [{"id": 1, "name": "cell"}]}


def dataset_layout(formats: str, tmp: str, name: str) -> str:
    """The data_dir of the coco or neural_cells dataset built from the
    committed fixtures under `tmp` (coco: annotations.json and images/ with
    formats/jpeg's files; neural_cells: formats/neural_cells as it is)."""
    if name == "neural_cells":
        return os.path.join(formats, "neural_cells")
    root = os.path.join(tmp, "coco")
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    shutil.copy(os.path.join(formats, "coco_annotations.json"),
                os.path.join(root, "annotations.json"))
    for f in sorted(os.listdir(os.path.join(formats, "jpeg"))):
        shutil.copy(os.path.join(formats, "jpeg", f), os.path.join(root, "images", f))
    return root


def fixtures(formats: str) -> list[str]:
    """Every image fixture, relative to `formats`, in a fixed order."""
    out = []
    for sub in ("jpeg", "mixed", os.path.join("neural_cells", "images")):
        out += [os.path.join(sub, f) for f in sorted(os.listdir(os.path.join(formats, sub)))]
    masks = os.path.join(formats, "neural_cells", "masks")
    for d in sorted(os.listdir(masks)):
        out += [os.path.join("neural_cells", "masks", d, f)
                for f in sorted(os.listdir(os.path.join(masks, d))) if not f.endswith(".txt")]
    return out


# formats/variants: the variant of each of the 16 images, in id order, by group
VARIANTS = [
    ("tiff_planar_tiled", ".tif"), ("tiff_old_lzw", ".tif"),            # TIFF layouts
    ("tiff_ycbcr_2x2", ".tif"), ("tiff_cmyk", ".tif"),                  # photometric kinds
    ("jpeg_cmyk", ".jpg"), ("jpeg_ycck", ".jpg"), ("jpeg_lossless_rgb", ".jpg"),
    ("jpeg_arith", ".jpg"), ("jpeg_arith_progressive", ".jpg"),         # arithmetic
    ("tiff_jpeg_ycbcr", ".tif"), ("tiff_jpeg_pil", ".tif"),             # JPEG in TIFF
    ("bmp_rle8", ".bmp"), ("bmp_565", ".bmp"), ("bmp_os2", ".bmp"),     # BMP
    ("tiff_group4", ".tif"), ("tiff_group3_2d", ".tif"),                # CCITT
]


def write_variant(kind: str, rgb) -> bytes:
    """One 8-bit RGB image ([H, W, 3]) stored as the variant `kind`."""
    import io

    import cv2
    import numpy as np
    from PIL import Image, TiffImagePlugin

    from tools import variant_encoders as ve
    h, w, _ = rgb.shape
    bgr = np.ascontiguousarray(rgb[..., ::-1])

    def pil(img, fmt, **kw):
        buf = io.BytesIO()
        img.save(buf, fmt, **kw)
        return buf.getvalue()
    if kind == "tiff_planar_tiled":
        return ve.tiff_image(rgb, 2, planar=2, tile=(128, 128), compression=8, predictor=2)
    if kind == "tiff_old_lzw":
        return ve.tiff_image(rgb, 2, compression=-5, rows_per_strip=32)
    if kind == "tiff_ycbcr_2x2":
        f = rgb.astype(np.float64)
        y = 0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2]
        cb = 128 + (f[..., 2] - y) / 1.772
        cr = 128 + (f[..., 0] - y) / 1.402
        half = lambda v: v.reshape(h // 2, 2, w // 2, 2).mean((1, 3))  # noqa: E731
        q = lambda v: np.clip(np.rint(v), 0, 255).astype(np.uint8)  # noqa: E731
        return ve.tiff_ycbcr(q(y), q(half(cb)), q(half(cr)), 2, 2, rows_per_strip=16,
                             compression=5)
    if kind == "tiff_cmyk":
        cmyk = np.asarray(Image.fromarray(rgb).convert("CMYK"))
        return ve.tiff_image(cmyk, 5, compression=8, rows_per_strip=64)
    if kind in ("jpeg_cmyk", "jpeg_ycck"):
        data = pil(Image.fromarray(rgb).convert("CMYK"), "JPEG", quality=90)
        return data if kind == "jpeg_cmyk" else ve.jpeg_set_adobe(data, 2)
    if kind == "jpeg_lossless_rgb":
        return ve.jpeg_lossless([rgb[..., k] for k in range(3)], 1, ids=(82, 71, 66))
    if kind == "jpeg_arith":
        return ve.jpeg_arith(cv2.imencode(".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY, 85])[1]
                             .tobytes(), restart=64)
    if kind == "jpeg_arith_progressive":
        return ve.jpeg_arith(cv2.imencode(".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY, 85,
                                                        cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1]
                             .tobytes())
    if kind == "tiff_jpeg_ycbcr":
        def enc(block):
            return cv2.imencode(".jpg", np.ascontiguousarray(block[..., ::-1]), [
                cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420])[1].tobytes()
        return ve.tiff_jpeg(rgb, enc, 6, sampling=(2, 2), rows_per_strip=64)
    if kind == "tiff_jpeg_pil":
        return pil(Image.fromarray(rgb), "TIFF", compression="jpeg", quality=90)
    if kind == "bmp_rle8":
        p = Image.fromarray(rgb).quantize(64, dither=Image.Dither.NONE)
        pal = np.asarray(p.getpalette()[:3 * 64], np.uint8).reshape(-1, 3)[:, ::-1]
        return ve.bmp_file(ve.bmp_rle(np.asarray(p), 8), w, h, 8, 1, pal)
    if kind == "bmp_565":
        v = ((rgb[..., 0].astype(np.uint16) >> 3) << 11) | ((rgb[..., 1].astype(np.uint16) >> 2)
                                                             << 5) | (rgb[..., 2] >> 3)
        return ve.bmp_file(ve.bmp_rows(v.astype("<u2").view(np.uint8).reshape(h, -1)), w, h, 16,
                           3, masks=(0xF800, 0x7E0, 0x1F, 0))
    if kind == "bmp_os2":
        return ve.bmp_file(ve.bmp_rows(bgr.reshape(h, -1)), w, h, 24, header=12)
    if kind in ("tiff_group4", "tiff_group3_2d"):
        ti = TiffImagePlugin.ImageFileDirectory_v2()
        if kind == "tiff_group3_2d":
            ti[292] = 5
        grey = np.asarray(Image.fromarray(rgb).convert("L"))
        return pil(Image.fromarray(grey > 96), "TIFF", tiffinfo=ti,
                   compression="group4" if kind == "tiff_group4" else "group3")
    raise ValueError(kind)


# formats/variants2: the damaged files and the variants ported after the
# first variants folder, one of each a 512x512 image, in id order
VARIANTS2 = [
    ("jpeg_progressive_cut", ".jpg"), ("jpeg_arith_dc_only", ".jpg"),
    ("jpeg_bad_huffman_code", ".jpg"), ("tiff_lzw_flipped_byte", ".tif"),
    ("tiff_group3_damaged", ".tif"), ("tiff_group4_damaged", ".tif"), ("tiff_rlew", ".tif"),
    ("jpeg_lossless_subsampled", ".jpg"), ("tiff_grey_3_samples", ".tif"),
    ("tiff_palette_extra_sample", ".tif"), ("tiff_palette_without_colormap", ".tif"),
    ("tiff_unknown_codec", ".tif"), ("tiff_jpeg_planes", ".tif"), ("tiff_ycbcr_4x4", ".tif"),
    ("tiff_sgilog_logl", ".tif"), ("tiff_thunderscan", ".tif"),
]
# formats/variants2_extra: files only decoded (cv2 reads them in "unchanged"
# only, or not at all), 256x256 crops
VARIANTS2_EXTRA = [
    ("tiff_grey_10bit", ".tif"), ("tiff_grey_12bit", ".tif"), ("tiff_grey_14bit", ".tif"),
    ("tiff_rgb_12bit", ".tif"), ("png_cut_mid_file", ".png"), ("tiff_sgilog24_luv", ".tif"),
]


def _damaged_read(data: bytes, ext: str, tries) -> bytes:
    """The first damaged version of `data` (`tries` yields them) that cv2
    reads in "color" and the port reads too (not a queued case)."""
    import cv2
    import numpy as np

    from kgtpu_torch.data.imread import UnsupportedImage, read_image
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "damaged" + ext)
        for d in tries:
            with open(path, "wb") as f:
                f.write(d)
            if cv2.imread(path, cv2.IMREAD_COLOR) is None:
                continue
            try:
                read_image(path, "color")
            except UnsupportedImage:
                continue
            return d
    raise ValueError("no damaged version reads")


def write_variant2(kind: str, rgb) -> bytes:
    """One 8-bit RGB image ([H, W, 3]) stored as the variants2 kind."""
    import io

    import cv2
    import numpy as np
    from PIL import Image, TiffImagePlugin

    from tools import variant_encoders as ve
    h, w, _ = rgb.shape
    bgr = np.ascontiguousarray(rgb[..., ::-1])
    grey = np.asarray(Image.fromarray(rgb).convert("L"))
    rng = np.random.default_rng(sum(map(ord, kind)))

    def flips(data: bytes, start: int, end: int):
        for _ in range(200):
            b = bytearray(data)
            b[int(rng.integers(start, end))] ^= int(rng.integers(1, 256))
            yield bytes(b)
    if kind == "jpeg_progressive_cut":
        src = cv2.imencode(".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY, 90,
                                         cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()
        starts = [i for i in range(len(src) - 1) if src[i:i + 2] == b"\xff\xda"]
        return src[:starts[len(starts) * 3 // 10] + 400]
    if kind == "jpeg_arith_dc_only":
        src = cv2.imencode(".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY, 85,
                                         cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()
        return ve.jpeg_arith(ve.jpeg_keep_scans(src, {0}), progressive=True)
    if kind == "jpeg_bad_huffman_code":
        src = cv2.imencode(".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY, 90])[1].tobytes()
        at = src.index(b"\xff\xda") + 14 + (len(src) - src.index(b"\xff\xda")) // 3
        while src[at - 1] == 0xFF:
            at += 1
        return src[:at] + b"\xff\x00\xff\x00" + src[at:]
    if kind == "tiff_lzw_flipped_byte":
        src = cv2.imencode(".tif", bgr)[1].tobytes()
        from kgtpu_torch.data.tiff import _Dir
        d = _Dir(src)
        return _damaged_read(src, ".tif", flips(src, d.offsets[0] + d.counts[0] // 2,
                                                d.offsets[0] + d.counts[0]))

    def pil(img, fmt, **kw):
        buf = io.BytesIO()
        img.save(buf, fmt, **kw)
        return buf.getvalue()
    if kind in ("tiff_group3_damaged", "tiff_group4_damaged"):
        ti = TiffImagePlugin.ImageFileDirectory_v2()
        g3 = kind == "tiff_group3_damaged"
        if g3:
            ti[292] = 5
        src = pil(Image.fromarray(grey > 96), "TIFF", tiffinfo=ti,
                  compression="group3" if g3 else "group4")
        from kgtpu_torch.data.tiff import _Dir
        d = _Dir(src)
        return _damaged_read(src, ".tif", flips(src, d.offsets[0] + d.counts[0] // 3,
                                                d.offsets[0] + d.counts[0] * 2 // 3))
    if kind == "tiff_rlew":
        return ve.tiff_ccitt_rlew(grey > 96, 1, rows_per_strip=64)
    if kind == "jpeg_lossless_subsampled":
        import struct
        y = ve.jpeg_lossless([grey], 1, interleaved=False)
        c = ve.jpeg_lossless([np.ascontiguousarray(rgb[::2, ::2, k]) for k in (1, 2)], 1,
                             ids=[2, 3], interleaved=False)
        sof = b"\xff\xc3" + struct.pack(">HBHHB", 17, 8, h, w, 3) + bytes(
            [1, 0x22, 0, 2, 0x11, 0, 3, 0x11, 0])
        dht = y[y.index(b"\xff\xc4"):y.index(b"\xff\xda")]
        return (b"\xff\xd8" + sof + dht + y[y.index(b"\xff\xda"):-2] +
                c[c.index(b"\xff\xda"):-2] + b"\xff\xd9")
    if kind == "tiff_grey_3_samples":
        return ve.tiff_image(rgb.astype(np.uint16) * 257, 1, bits=16, compression=8,
                             rows_per_strip=64)
    if kind == "tiff_palette_extra_sample":
        p = Image.fromarray(rgb).quantize(256, dither=Image.Dither.NONE)
        pal = np.asarray(p.getpalette()[:768], np.uint16).reshape(-1, 3)
        pal = np.concatenate([pal, np.zeros((256 - len(pal), 3), np.uint16)]) * 257
        idx = np.stack([np.asarray(p), grey], -1)
        return ve.tiff_image(idx, 3, compression=8, rows_per_strip=64, extra=[0],
                             tags={320: (ve.SHORT, pal.T.reshape(-1).tolist())})
    if kind == "tiff_palette_without_colormap":
        return ve.tiff_image(grey.astype(np.uint16) * 257, 3, bits=16, compression=8,
                             rows_per_strip=64)
    if kind == "tiff_unknown_codec":
        t = {256: (ve.LONG, [w]), 257: (ve.LONG, [h]), 258: (ve.SHORT, [8] * 3),
             259: (ve.SHORT, [12345]), 262: (ve.SHORT, [2]), 277: (ve.SHORT, [3]),
             278: (ve.LONG, [h])}
        return ve.tiff_file([bytes(64)], t)
    if kind == "tiff_jpeg_planes":
        streams = [cv2.imencode(".jpg", np.ascontiguousarray(rgb[y:y + 128, :, k]),
                                [cv2.IMWRITE_JPEG_QUALITY, 90])[1].tobytes()
                   for k in range(3) for y in range(0, h, 128)]
        t = {256: (ve.LONG, [w]), 257: (ve.LONG, [h]), 258: (ve.SHORT, [8] * 3),
             259: (ve.SHORT, [7]), 262: (ve.SHORT, [2]), 277: (ve.SHORT, [3]),
             284: (ve.SHORT, [2]), 278: (ve.LONG, [128])}
        return ve.tiff_file(streams, t)
    if kind == "tiff_ycbcr_4x4":
        f = rgb.astype(np.float64)
        y = 0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2]
        cb = 128 + (f[..., 2] - y) / 1.772
        cr = 128 + (f[..., 0] - y) / 1.402
        quarter = lambda v: v.reshape(h // 4, 4, w // 4, 4).mean((1, 3))  # noqa: E731
        q = lambda v: np.clip(np.rint(v), 0, 255).astype(np.uint8)  # noqa: E731
        return ve.tiff_ycbcr(q(y), q(quarter(cb)), q(quarter(cr)), 4, 4, rows_per_strip=4,
                             compression=5)
    if kind == "tiff_sgilog_logl":
        yv = np.maximum(grey.astype(np.float64) / 255, 1e-4)
        words = np.clip(np.rint(256 * (np.log2(yv) + 64)), 1, 0x7FFF).astype(np.uint32)
        return ve.tiff_sgilog(words, True, 34676, rows_per_strip=64)
    if kind == "tiff_thunderscan":
        v = (grey >> 4).astype(np.uint8)
        cmap = [c * 4369 for c in range(16)] * 3
        return ve.tiff_thunderscan(v, 3, rng=rng, colormap=cmap, rows_per_strip=64)
    raise ValueError(kind)


def write_variant2_extra(kind: str, rgb) -> bytes:
    """One 256x256 crop of an RGB image stored as the decode-only kind."""
    import cv2
    import numpy as np

    from tools import variant_encoders as ve
    from tests.test_torch_format_variants import tiff_packed
    rgb = np.ascontiguousarray(rgb[128:384, 128:384])
    grey = cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY)
    if kind.startswith("tiff_grey_"):
        bits = int(kind.split("_")[2][:2])
        return tiff_packed((grey.astype(np.uint16) << (bits - 8))[..., None], bits, 1)
    if kind == "tiff_rgb_12bit":
        return tiff_packed(rgb.astype(np.uint16) << 4, 12, 2)
    if kind == "png_cut_mid_file":
        data = cv2.imencode(".png", rgb[..., ::-1])[1].tobytes()
        return data[:len(data) // 2]
    if kind == "tiff_sgilog24_luv":
        lv = (grey.astype(np.uint32) * 4 + 16) & 0x3FF
        cell = (np.arange(grey.size, dtype=np.uint32).reshape(grey.shape) * 37) % 16289
        return ve.tiff_sgilog(lv << 14 | cell, False, 34677, rows_per_strip=64, bits=8)
    raise ValueError(kind)


# formats/containers: the container of each of the 16 images, in id order,
# each under one of kgtpu's extensions (cv2 picks its decoder by content)
CONTAINERS = [
    ("ppm_p6", ".png"), ("pgm_p5", ".jpg"), ("pam_grayscale", ".tif"),   # PNM / PAM
    ("pbm_p4", ".bmp"), ("sun_palette", ".bmp"), ("hdr_rle", ".png"),   # Sun raster, HDR
    ("gif", ".png"), ("gif_interlaced", ".jpg"), ("gif_animated", ".tif"),
    ("gif_local_transparent", ".bmp"),
    ("webp_lossless", ".png"), ("webp_lossy_q90", ".jpg"), ("webp_lossy_q50", ".jpg"),
    ("webp_lossy_alpha", ".png"), ("webp_animated", ".tif"), ("webp_simple_filter", ".jpg"),
]


def write_container(kind: str, rgb) -> bytes:
    """One 8-bit RGB image ([H, W, 3]) stored in the container `kind`."""
    import io

    import cv2
    import numpy as np
    from PIL import Image

    from tools import variant_encoders as ve
    h, w, _ = rgb.shape
    grey = np.asarray(Image.fromarray(rgb).convert("L"))

    def pil(img, fmt, **kw):
        buf = io.BytesIO()
        img.save(buf, fmt, **kw)
        return buf.getvalue()

    def quantised(n):
        p = Image.fromarray(rgb).quantize(n, dither=Image.Dither.NONE)
        pal = np.asarray(p.getpalette()[:3 * n], np.uint8).reshape(-1, 3)
        return np.asarray(p), pal
    frames = [Image.fromarray(rgb), Image.fromarray(np.ascontiguousarray(rgb[::-1])),
              Image.fromarray(255 - rgb)]
    if kind == "ppm_p6":
        return cv2.imencode(".ppm", np.ascontiguousarray(rgb[..., ::-1]))[1].tobytes()
    if kind == "pgm_p5":
        return pil(Image.fromarray(grey), "PPM")
    if kind == "pam_grayscale":
        return ve.pam_file(grey, "GRAYSCALE", comment=b"# kgtpu container fixture\n")
    if kind == "pbm_p4":
        return ve.pbm_p4(grey < 96, comment=b"# threshold 96\n")
    if kind == "sun_palette":
        idx, pal = quantised(64)
        return ve.sun_raster(idx, 8, 1, palette=pal)
    if kind == "hdr_rle":
        return ve.hdr_file(ve.rgbe(rgb.astype(np.float64) / 255.0), "rle")
    if kind in ("gif", "gif_interlaced"):
        idx, pal = quantised(256)
        return ve.gif_file([{"idx": idx, "interlace": kind == "gif_interlaced"}], w, h, pal)
    if kind == "gif_animated":
        return pil(frames[0], "GIF", save_all=True, append_images=frames[1:], duration=100,
                   loop=0)
    if kind == "gif_local_transparent":
        idx, pal = quantised(128)
        rare = int(np.argmin(np.bincount(idx.reshape(-1), minlength=128)))
        return ve.gif_file([{"idx": idx, "palette": pal, "transparent": rare, "disposal": 1}],
                           w, h, pal[::-1], background=3)
    if kind == "webp_lossless":
        return pil(frames[0], "WEBP", lossless=True)
    if kind in ("webp_lossy_q90", "webp_lossy_q50"):
        return pil(frames[0], "WEBP", quality=int(kind[-2:]))
    if kind == "webp_lossy_alpha":
        alpha = (np.arange(w)[None, :] * 255 // max(w - 1, 1) + np.zeros((h, 1), int))
        return pil(Image.fromarray(np.dstack([rgb, alpha.astype(np.uint8)])), "WEBP", quality=80)
    if kind == "webp_animated":
        return pil(frames[0], "WEBP", save_all=True, append_images=frames[1:], duration=100,
                   quality=75)
    if kind == "webp_simple_filter":
        frame = dict(ve.webp_chunks(pil(frames[0], "WEBP", quality=75)))[b"VP8 "]
        return ve.webp_riff([(b"VP8 ", ve.vp8_rewrite(frame, filt={"simple": 1, "level": 24,
                                                                    "sharpness": 2}))])
    raise ValueError(kind)


# formats/jpeg2000: the JPEG 2000 kind of each of the first 8 images, in id
# order, under kgtpu's extensions (cv2 5.0 reads JPEG 2000 whatever the file
# is called).  A tile offset needs an image offset (XTOsiz <= XOsiz), which
# cv2 refuses, so the tiled kind has none (tests/test_torch_jpeg2000.py holds
# an offset file against cv2).
JPEG2000 = [
    ("cv2_lossless", ".png"), ("cv2_x1000_200", ".jpg"), ("cv2_x1000_50", ".tif"),
    ("pil_codestream_97_3layers", ".bmp"), ("pil_grey_tiles128_rpcl_precincts", ".png"),
    ("pil_pcrl_cblk32_res3_mct0", ".jpg"), ("pil_rgba_cprl_res7", ".tif"),
    ("pil_grey16_rlcp", ".bmp"),
]


def write_jpeg2000(kind: str, rgb) -> bytes:
    """One 8-bit RGB image ([H, W, 3]) as the JPEG 2000 kind `kind`: cv2's
    writer (OpenJPEG, lossless 5/3 and RCT by default, or at
    IMWRITE_JPEG2000_COMPRESSION_X1000) or PIL's (rates are compression
    ratios, one per quality layer)."""
    import io

    import cv2
    import numpy as np
    from PIL import Image

    def pil(img, **kw):
        buf = io.BytesIO()
        img.save(buf, "JPEG2000", **kw)
        return buf.getvalue()
    h, w, _ = rgb.shape
    grey = Image.fromarray(rgb).convert("L")
    if kind == "cv2_lossless":
        return cv2.imencode(".jp2", np.ascontiguousarray(rgb[..., ::-1]))[1].tobytes()
    if kind.startswith("cv2_x1000_"):
        q = int(kind.rsplit("_", 1)[1])
        return cv2.imencode(".jp2", np.ascontiguousarray(rgb[..., ::-1]),
                            [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, q])[1].tobytes()
    if kind == "pil_codestream_97_3layers":
        return pil(Image.fromarray(rgb), no_jp2=True, irreversible=True, quality_mode="rates",
                   quality_layers=[40, 20, 10])
    if kind == "pil_grey_tiles128_rpcl_precincts":
        return pil(grey, tile_size=(128, 128), progression="RPCL", precinct_size=(64, 64),
                   quality_mode="rates", quality_layers=[8])
    if kind == "pil_pcrl_cblk32_res3_mct0":
        return pil(Image.fromarray(rgb), progression="PCRL", codeblock_size=(32, 32),
                   num_resolutions=3, mct=0, quality_mode="rates", quality_layers=[16])
    if kind == "pil_rgba_cprl_res7":
        alpha = (np.arange(w)[None, :] * 255 // max(w - 1, 1) + np.zeros((h, 1), int))
        return pil(Image.fromarray(np.dstack([rgb, alpha.astype(np.uint8)])), progression="CPRL",
                   num_resolutions=7, quality_mode="rates", quality_layers=[16])
    if kind == "pil_grey16_rlcp":
        g16 = np.asarray(grey).astype(np.uint16) * 257
        return pil(Image.fromarray(g16), progression="RLCP", quality_mode="rates",
                   quality_layers=[8])
    raise ValueError(kind)


# (kind, extension, image index, jpeg2000_opj's options); "grey" cuts are the
# green channel, "grey16" it times 257
JPEG2000_STYLES = [
    ("bypass", ".jp2", 0, {"style": 0x01, "jp2": True}),
    ("reset", ".jp2", 1, {"style": 0x02, "jp2": True}),
    ("termall", ".jp2", 2, {"style": 0x04, "jp2": True}),
    ("vsc", ".jp2", 3, {"style": 0x08, "jp2": True}),
    ("pterm", ".jp2", 4, {"style": 0x10, "jp2": True}),
    ("segsym", ".jp2", 5, {"style": 0x20, "jp2": True}),
    ("all63_lossless", ".j2k", 6, {"style": 0x3F}),
    ("all63_97_3layers", ".jp2", 7, {"style": 0x3F, "irreversible": True,
                                      "layers": (40.0, 20.0, 10.0), "jp2": True}),
    ("grey_bypass_termall_layers_res4_cblk32", ".j2k", 8,
     {"style": 0x05, "layers": (30.0, 10.0, 0.0), "resolutions": 4, "cblk": (32, 32)}),
    ("grey16_all63_layers", ".j2k", 9, {"style": 0x3F, "prec": 16,
                                        "layers": (40.0, 10.0, 0.0)}),
]


def _part2_offsets() -> bytes:
    """MCT (int32 offsets 10, -20, 30), MCC naming it, MCO applying it."""
    import struct

    def seg(m, body):
        return struct.pack(">HH", m, len(body) + 2) + body
    return (seg(0xFF74, struct.pack(">HHHiii", 0, 1 | 2 << 8 | 1 << 10, 0, 10, -20, 30))
            + seg(0xFF75, struct.pack(">HBHHBH", 0, 1, 0, 1, 1, 3) + bytes(range(3))
                  + struct.pack(">H", 3) + bytes(range(3)) + bytes([1, 1, 0]))
            + seg(0xFF77, b"\1\1"))


# (kind, extension, image index, jpeg2000_ht's options); "grey" cuts are the
# green channel, "grey16" it times 257, "rgba" with a horizontal alpha ramp
JPEG2000_HT = [
    ("rgb_lossless", ".jp2", 0, {"jp2": True, "levels": 5}),
    ("grey_lossless", ".j2k", 1, {"levels": 5}),
    ("rgb_97", ".jp2", 2, {"irreversible": True, "step": 2.0, "jp2": True}),
    ("grey16_lossless", ".j2k", 3, {"levels": 4}),
    ("rgba_lossless", ".jp2", 4, {"jp2": True}),
    ("rgb_tiles64_precincts", ".j2k", 5, {"tiles": (64, 64), "levels": 3, "cblk": (16, 16),
                                          "precincts": [(4, 4), (4, 4), (5, 5), (5, 5)]}),
    ("rgb_cblk4x4", ".j2k", 6, {"cblk": (4, 4), "levels": 2}),
    ("grey_cblk16x8_rpcl", ".jp2", 7, {"cblk": (16, 8), "order": "RPCL", "jp2": True}),
    ("rgb_sigprop_magref", ".jp2", 8, {"refine": True, "jp2": True}),
    ("rgb_two_layers_vsc", ".j2k", 9, {"refine": True, "layers": 2, "style": 0x48}),
    ("rgb_part2_offsets", ".j2k", 0, {"part2": True}),
]


def make_jpeg2000_ht(out: str) -> int:
    """formats/jpeg2000_ht and its keys in kgtpu_reference_formats.npz
    (module docstring), the other keys kept."""
    import cv2
    import numpy as np

    from tools.variant_encoders import jpeg2000_ht
    src = os.path.join(out, "synthetic_hard", "images")
    fdir = os.path.join(out, "formats", "jpeg2000_ht")
    shutil.rmtree(fdir, ignore_errors=True)
    os.makedirs(fdir)
    ids = sorted(f[:-4] for f in os.listdir(src))
    kinds = {}
    for kind, ext, k, opts in JPEG2000_HT:
        rgb = cv2.imread(os.path.join(src, f"{ids[k]}.png"), cv2.IMREAD_COLOR)[..., ::-1]
        px = np.ascontiguousarray(rgb[192:320, 192:320])
        if kind.startswith("grey16"):
            px = px[..., 1].astype(np.uint16) * 257
        elif kind.startswith("grey"):
            px = px[..., 1]
        elif kind.startswith("rgba"):
            ramp = np.arange(128)[None, :] * 2 + np.zeros((128, 1), int)
            px = np.dstack([px, ramp.astype(np.uint8)])
        opts = dict(opts)
        if opts.pop("part2", False):
            opts["main_extra"] = _part2_offsets()
        rel = kind + ext
        data = jpeg2000_ht(px, **opts)
        with open(os.path.join(fdir, rel), "wb") as f:
            f.write(data)
        if "lossless" in kind:
            back = cv2.imread(os.path.join(fdir, rel), cv2.IMREAD_UNCHANGED)
            back = back[..., [2, 1, 0, 3][:back.shape[2]]] if back.ndim == 3 else back
            assert np.array_equal(back, px), f"{rel} does not decode to its pixels"
        kinds[rel] = kind
    decodes = cv2_decodes(fdir, sorted(kinds))
    path = os.path.join(out, "kgtpu_reference_formats.npz")
    with np.load(path) as ref:
        result = {k: ref[k] for k in ref.files if not k.startswith("jpeg2000_ht_")}
    result.update({"jpeg2000_ht_decode_json": np.array(json.dumps(decodes)),
                   "jpeg2000_ht_kinds_json": np.array(json.dumps(kinds))})
    np.savez_compressed(path, **result)
    size = sum(os.path.getsize(os.path.join(fdir, f)) for f in kinds)
    print(f"{len(kinds)} jpeg2000_ht files, {len(decodes)} decodes "
          f"({sum(d['sha256'] is None for d in decodes)} None), {size / 2**20:.3f} MiB")
    return 0


# (kind, image index, writer options); see `write_avif`
AVIF_KINDS = [
    ("rgb_lossless", 0, {}), ("grey_lossless", 1, {}), ("rgba_lossless", 2, {}),
    ("rgb_10bit_lossless", 3, {}), ("rgb_12bit_lossless", 4, {}),
    ("yuv420_q40", 5, {"quality": 40}),
    ("yuv420_q80_qm", 6, {"quality": 80, "qm": True}),
    ("yuv422_q60", 7, {"quality": 60, "subsampling": "4:2:2"}),
    ("yuv444_q70", 8, {"quality": 70, "subsampling": "4:4:4"}),
    ("mono_lossy", 9, {}), ("screen_palette", 10, {"quality": 60}),
    ("screen_intrabc", 11, {}), ("tiles_2x2", 12, {"quality": 70}),
    ("sb128", 13, {"quality": 70}), ("grid_2x2", 14, {}), ("sequence", 15, {"quality": 60}),
    # the in-loop filters AV1's encoders turn on: deblocking, CDEF
    ("cv2_q90", 0, {}), ("cv2_q80", 1, {}), ("pil_default", 2, {}),
    ("pil_422_cdef", 3, {"quality": 60, "subsampling": "4:2:2"}),
    ("cv2_10bit_q80", 4, {}), ("aom_delta_lf", 5, {}), ("pil_sb128_cdef", 6, {"quality": 30}),
    # loop restoration and superres: libaom's good-quality usage (aomenc's and
    # libavif's default outside all-intra), superres at a fixed denominator
    ("aom_lr_420", 14, {"cq-level": 10}), ("aom_lr_444", 15, {"cq-level": 30}),
    ("aom_lr_sb128", 9, {"cq-level": 30, "sb-size": 128}),
    ("aom_lr_tiles", 10, {"cq-level": 30, "tile-columns": 1, "tile-rows": 1}),
    ("aom_superres_12", 11, {"cq-level": 30, "enable-restoration": 0, "denom": 12}),
    ("aom_superres_16_lr", 12, {"cq-level": 30, "denom": 16}),
    ("aom_lr_10bit", 13, {"cq-level": 30, "bit_depth": 10}),
]
# the filters each filtered kind's frame needs (av1_obu.post_filters)
AVIF_FILTERS = {"cv2_q90": ["deblocking"], "cv2_q80": ["deblocking", "CDEF"],
                "pil_default": ["deblocking"], "pil_422_cdef": ["deblocking", "CDEF"],
                "cv2_10bit_q80": ["deblocking", "CDEF"], "aom_delta_lf": ["deblocking"],
                "pil_sb128_cdef": ["deblocking", "CDEF"], "pil_default_512": ["deblocking"],
                "cv2_q80_512": ["deblocking", "CDEF"],
                "aom_lr_420": ["deblocking", "loop restoration"],
                "aom_lr_444": ["deblocking", "CDEF", "loop restoration"],
                "aom_lr_sb128": ["deblocking", "CDEF", "loop restoration"],
                "aom_lr_tiles": ["deblocking", "CDEF", "loop restoration"],
                "aom_superres_12": ["deblocking", "CDEF", "superres"],
                "aom_superres_16_lr": ["deblocking", "CDEF", "loop restoration", "superres"],
                "aom_lr_10bit": ["deblocking", "CDEF", "loop restoration"],
                "aom_lr_512": ["deblocking", "CDEF", "loop restoration"]}
AVIF_FOLDER = [("lossless", ".png"), ("yuv420_q70", ".jpg"), ("aom_lr_512", ".tif"),
               ("yuv444_q85", ".bmp"), ("pil_default_512", ".png"), ("cv2_q80_512", ".tif")]
AVIF_FOLDER_OPTS = {"yuv420_q70": {"quality": 70}, "yuv444_q85": {"quality": 85,
                                                                   "subsampling": "4:4:4"},
                    "aom_lr_512": {"cq-level": 30}}


def write_avif(kind: str, rgb, opts: dict | None = None) -> bytes:
    """An AVIF of `rgb` ([H, W, 3] uint8) as `kind` (AVIF_KINDS or
    AVIF_FOLDER)."""
    import cv2
    import numpy as np

    from tools.variant_encoders import (AVIF_NO_FILTERS, aom_encode, avif_file, avif_grid,
                                        avif_pil)
    opts = opts or AVIF_FOLDER_OPTS.get(kind, {})
    bgr = np.ascontiguousarray(rgb[..., ::-1])
    if kind in ("cv2_q90", "cv2_q80", "cv2_q80_512"):
        q = 90 if kind == "cv2_q90" else 80
        return cv2.imencode(".avif", bgr, [cv2.IMWRITE_AVIF_QUALITY, q])[1].tobytes()
    if kind == "cv2_10bit_q80":
        px = (bgr.astype(np.uint16) << 2) | (bgr.astype(np.uint16) >> 6)
        return cv2.imencode(".avif", px, [cv2.IMWRITE_AVIF_QUALITY, 80,
                                          cv2.IMWRITE_AVIF_DEPTH, 10])[1].tobytes()
    if kind in ("pil_default", "pil_default_512"):
        return avif_pil(np.ascontiguousarray(rgb))
    if kind in ("pil_422_cdef", "pil_sb128_cdef"):
        adv = [("enable-cdef", "1")] + ([("sb-size", "128")] if kind == "pil_sb128_cdef" else [])
        return avif_pil(np.ascontiguousarray(rgb), quality=opts["quality"],
                        subsampling=opts.get("subsampling", "4:2:0"), advanced=adv)
    if kind == "aom_delta_lf":
        # libaom's all-intra usage codes delta loop filter levels (with delta q
        # in its mode 3) where a frame's quantiser is coarse enough
        yuv = [np.ascontiguousarray(rgb[..., k]) for k in (1, 0, 2)]
        yuv = yuv[:1] + [np.ascontiguousarray(p[::2, ::2]) for p in yuv[1:]]
        obus = aom_encode(yuv, "420", {"cq-level": 50, "enable-restoration": 0, "cpu-used": 6,
                                       "deltaq-mode": 3, "delta-lf-mode": 1}, usage=2)
        return avif_file(obus, rgb.shape[1], rgb.shape[0], ssx=1, ssy=1, profile=0,
                         cicp=(1, 13, 6, 1))
    if kind.startswith("aom_lr") or kind.startswith("aom_superres"):
        # libaom's good-quality usage turns loop restoration on by default
        opts = dict(opts)
        denom = opts.pop("denom", 0)
        depth = opts.pop("bit_depth", 8)
        fmt = "444" if kind == "aom_lr_444" else "420"
        px = rgb[..., [1, 0, 2]].astype(np.uint16 if depth > 8 else np.uint8) << (depth - 8)
        yuv = [np.ascontiguousarray(px[..., k]) for k in range(3)]
        if fmt == "420":
            yuv = yuv[:1] + [np.ascontiguousarray(p[::2, ::2]) for p in yuv[1:]]
        cfg = {96: 3}  # rc_end_usage AOM_Q: cq-level sets the quantiser
        if denom:
            cfg.update({76: 1, 80: denom, 84: denom})  # rc_superres_mode FIXED
        obus = aom_encode(yuv, fmt, {"cpu-used": 4, **opts}, usage=0, cfg_fields=cfg,
                          bit_depth=depth)
        sub = int(fmt == "420")
        return avif_file(obus, rgb.shape[1], rgb.shape[0], depth=depth, ssx=sub, ssy=sub,
                         profile=1 - sub, cicp=(1, 13, 0 if fmt == "444" else 6, 1))
    if kind == "lossless" or kind == "rgb_lossless":
        return cv2.imencode(".avif", bgr, [cv2.IMWRITE_AVIF_QUALITY, 100])[1].tobytes()
    if kind == "grey_lossless":
        return cv2.imencode(".avif", bgr[..., 1], [cv2.IMWRITE_AVIF_QUALITY, 100])[1].tobytes()
    if kind == "rgba_lossless":
        ramp = (np.arange(rgb.shape[1])[None, :] * 2 + np.zeros((rgb.shape[0], 1), int))
        bgra = np.dstack([bgr, ramp.astype(np.uint8)])
        return cv2.imencode(".avif", bgra, [cv2.IMWRITE_AVIF_QUALITY, 100])[1].tobytes()
    if kind.startswith("rgb_1") and kind.endswith("bit_lossless"):
        depth = int(kind[4:6])
        px = (bgr.astype(np.uint16) << (depth - 8)) | (bgr.astype(np.uint16) >> (16 - depth))
        return cv2.imencode(".avif", px, [cv2.IMWRITE_AVIF_QUALITY, 100,
                                          cv2.IMWRITE_AVIF_DEPTH, depth])[1].tobytes()
    if kind.startswith(("yuv", "tiles", "sb128", "screen_palette", "sequence")):
        kw = {"quality": opts.get("quality", 70),
              "subsampling": opts.get("subsampling", "4:2:0"), "speed": 6}
        adv = list(AVIF_NO_FILTERS)
        if opts.get("qm"):
            adv += [("enable-qm", "1"), ("qm-min", "5"), ("qm-max", "9")]
        if kind == "tiles_2x2":
            adv += [("tile-columns", "1"), ("tile-rows", "1")]
        if kind == "sb128":
            adv += [("sb-size", "128")]
        if kind == "screen_palette":
            adv += [("tune-content", "screen")]
        kw["advanced"] = adv
        if kind == "sequence":
            from PIL import Image
            kw["save_all"] = True
            kw["append_images"] = [Image.fromarray(np.ascontiguousarray(rgb[::-1]))]
        return avif_pil(np.ascontiguousarray(rgb), **kw)
    no_filters = {"enable-cdef": 0, "enable-restoration": 0, "loopfilter-control": 0}
    if kind == "mono_lossy":
        y = np.ascontiguousarray(rgb[..., 1])
        u = np.full(((y.shape[0] + 1) // 2, (y.shape[1] + 1) // 2), 128, np.uint8)
        obus = aom_encode([y, u, u], "420", {"cq-level": 30, **no_filters},
                          cfg_fields={208: 1})  # aom_codec_enc_cfg_t.monochrome
        return avif_file(obus, y.shape[1], y.shape[0], mono=True, ssx=1, ssy=1, profile=0,
                         cicp=(1, 13, 6, 1))
    if kind == "screen_intrabc":
        strip = np.concatenate([rgb, rgb[:, ::-1], rgb[::-1], rgb, rgb[:, ::-1], rgb[::-1]], 1)
        strip[:, 640:] = strip[:, 0:128]
        obus = aom_encode([strip[..., 1], strip[..., 0], strip[..., 2]], "444",
                          {"tune-content": "screen", "cq-level": 20, "cpu-used": 4,
                           "enable-cdef": 0, "enable-restoration": 0})
        return avif_file(obus, strip.shape[1], strip.shape[0], cicp=(1, 13, 0, 1))
    if kind == "grid_2x2":
        h, w = rgb.shape[0] // 2, rgb.shape[1] // 2
        tiles = [aom_encode([t[..., 1], t[..., 0], t[..., 2]], "444", {"lossless": 1})
                 for t in (rgb[:h, :w], rgb[:h, w:], rgb[h:, :w], rgb[h:, w:])]
        return avif_grid(tiles, 2, 2, w, h, 2 * w - 6, 2 * h - 10, cicp=(1, 13, 0, 1))
    raise ValueError(kind)


def make_avif(out: str) -> int:
    """formats/avif and its keys in kgtpu_reference_formats.npz (module
    docstring), the other keys kept."""
    import cv2
    import numpy as np
    src = os.path.join(out, "synthetic_hard", "images")
    fdir = os.path.join(out, "formats", "avif")
    shutil.rmtree(fdir, ignore_errors=True)
    os.makedirs(fdir)
    ids = sorted(f[:-4] for f in os.listdir(src))
    kinds = {}
    for kind, k, opts in AVIF_KINDS:
        rgb = cv2.imread(os.path.join(src, f"{ids[k]}.png"), cv2.IMREAD_COLOR)[..., ::-1]
        px = np.ascontiguousarray(rgb[192:320, 192:320])
        rel = kind + ".avif"
        with open(os.path.join(fdir, rel), "wb") as f:
            f.write(write_avif(kind, px, opts))
        if kind in ("rgb_lossless", "grey_lossless", "rgba_lossless"):
            back = cv2.imread(os.path.join(fdir, rel), cv2.IMREAD_UNCHANGED)
            want = px[..., ::-1] if kind == "rgb_lossless" else px[..., 1] \
                if kind == "grey_lossless" else back
            assert np.array_equal(back[..., :3] if back.ndim == 3 and back.shape[2] == 4
                                  else back, want if kind != "rgba_lossless"
                                  else px[..., ::-1]), f"{rel} does not decode to its pixels"
        kinds[rel] = kind
    decodes = cv2_decodes(fdir, sorted(kinds))
    path = os.path.join(out, "kgtpu_reference_formats.npz")
    with np.load(path) as ref:
        result = {k: ref[k] for k in ref.files if k not in ("avif_decode_json",
                                                            "avif_kinds_json")}
    result.update({"avif_decode_json": np.array(json.dumps(decodes)),
                   "avif_kinds_json": np.array(json.dumps(kinds))})
    np.savez_compressed(path, **result)
    size = sum(os.path.getsize(os.path.join(fdir, f)) for f in kinds)
    print(f"{len(kinds)} avif files, {len(decodes)} decodes "
          f"({sum(d['sha256'] is None for d in decodes)} None), {size / 2**20:.3f} MiB")
    return 0


def make_avif_folder(out: str) -> int:
    return make_folder(out, "avif_folder", AVIF_FOLDER, write_avif)


def make_jpeg2000_styles(out: str) -> int:
    """formats/jpeg2000_styles and its keys in kgtpu_reference_formats.npz
    (module docstring), the other keys kept."""
    import cv2
    import numpy as np

    from tools.variant_encoders import jpeg2000_opj
    src = os.path.join(out, "synthetic_hard", "images")
    fdir = os.path.join(out, "formats", "jpeg2000_styles")
    shutil.rmtree(fdir, ignore_errors=True)
    os.makedirs(fdir)
    ids = sorted(f[:-4] for f in os.listdir(src))
    kinds = {}
    for kind, ext, k, opts in JPEG2000_STYLES:
        rgb = cv2.imread(os.path.join(src, f"{ids[k]}.png"), cv2.IMREAD_COLOR)[..., ::-1]
        px = np.ascontiguousarray(rgb[192:320, 192:320])
        if kind.startswith("grey16"):
            px = px[..., 1].astype(np.uint16) * 257
        elif kind.startswith("grey"):
            px = px[..., 1]
        rel = kind + ext
        data = jpeg2000_opj(px, **opts)
        with open(os.path.join(fdir, rel), "wb") as f:
            f.write(data)
        if not opts.get("irreversible") and (opts.get("layers") or (0,))[-1] == 0:
            back = cv2.imread(os.path.join(fdir, rel), cv2.IMREAD_UNCHANGED)
            back = back[..., ::-1] if back.ndim == 3 else back
            assert np.array_equal(back, px), f"{rel} does not decode to its pixels"
        kinds[rel] = kind
    decodes = cv2_decodes(fdir, sorted(kinds))
    path = os.path.join(out, "kgtpu_reference_formats.npz")
    with np.load(path) as ref:
        result = {k: ref[k] for k in ref.files if not k.startswith("jpeg2000_styles_")}
    result.update({"jpeg2000_styles_decode_json": np.array(json.dumps(decodes)),
                   "jpeg2000_styles_kinds_json": np.array(json.dumps(kinds))})
    np.savez_compressed(path, **result)
    size = sum(os.path.getsize(os.path.join(fdir, f)) for f in kinds)
    print(f"{len(kinds)} jpeg2000_styles files, {len(decodes)} decodes "
          f"({sum(d['sha256'] is None for d in decodes)} None), {size / 2**20:.3f} MiB")
    return 0


def cv2_decodes(root: str, rels: list[str]) -> list[dict]:
    """cv2's decode of each file in every mode, in RGB order: sha256,
    shape and dtype, or None where cv2 returns None."""
    import cv2
    flags = {"color": cv2.IMREAD_COLOR, "gray": cv2.IMREAD_GRAYSCALE,
             "unchanged": cv2.IMREAD_UNCHANGED}
    out = []
    for rel in rels:
        for mode in MODES:
            img = cv2.imread(os.path.join(root, rel), flags[mode])
            if img is None:
                out.append({"path": rel, "mode": mode, "sha256": None, "shape": None,
                            "dtype": None})
                continue
            if img.ndim == 3:
                img = cv2.cvtColor(img, cv2.COLOR_BGRA2RGBA if img.shape[2] == 4
                                   else cv2.COLOR_BGR2RGB)
            out.append({"path": rel, "mode": mode, "sha256": sha(img),
                        "shape": list(img.shape), "dtype": str(img.dtype)})
    return out


def kgtpu_runs(folder_dir: str, gt: dict, source: str) -> dict:
    """kgtpu's own f32 and bf16 flagship runs over a folder (its ImageFolder,
    loader and infer function, as test.py serves it): {labels_<dtype>,
    counts_<dtype>, ids, metrics_json}."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from kgtpu import checkpoint, evaluate
    from kgtpu.config import Config
    from kgtpu.data.folder import ImageFolder
    from kgtpu.data.loader import _prepare_sample
    from kgtpu.infer import build_infer_fn
    from kgtpu.models import KGNet
    from tools.make_torch_eval_assets import BATCH, FLAGSHIP, _score
    import cv2
    params, extra = checkpoint.restore_bundle(FLAGSHIP, use_ema=True)
    stored = checkpoint.decode_config(extra)
    folder = ImageFolder(folder_dir)
    result = {"ids": np.array([folder[i]["id"] for i in range(len(folder))])}
    metrics = {"source": "tools/make_torch_format_assets.py", "jax": jax.__version__,
               "cv2": cv2.__version__, "weights": "runs/kg_hard1024/model_99 (EMA)",
               "data": source}
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(Config(), model=dataclasses.replace(
            stored.model, compute_dtype=dtype))
        infer = build_infer_fn(KGNet(cfg=cfg.model), cfg)
        rng = np.random.default_rng(0)
        labels, counts, recs = [], [], []
        for start in range(0, len(folder), BATCH):
            raws = [folder[i] for i in range(start, min(start + BATCH, len(folder)))]
            imgs = np.stack([_prepare_sample(r, cfg.data, augment=False, rng=rng,
                                             image_only=True)["image"] for r in raws])
            o = infer(params, jnp.asarray(imgs))
            for k, raw in enumerate(raws):
                lab = np.asarray(o["label_map"][k]).astype(np.uint16)
                valid = np.asarray(o["valid"][k])
                kept = np.asarray(o["scores"][k])[valid]
                labels.append(lab)
                counts.append(int(valid.sum()))
                scores = np.zeros(max(int(lab.max()), len(kept), 1), np.float32)
                scores[:len(kept)] = kept
                recs.append({"pred_label": lab.astype(np.int32), "scores": scores,
                             "gt_label": gt[raw["id"]].astype(np.int32)})
        metrics[dtype] = _score(evaluate, recs)
        result[f"labels_{dtype}"] = np.stack(labels)
        result[f"counts_{dtype}"] = np.array(counts, np.int32)
        print(source, dtype, counts, json.dumps(metrics[dtype]))
    result["metrics_json"] = np.array(json.dumps(metrics))
    return result


def make_folder(out: str, key: str, table: list, write) -> int:
    """formats/<key>: the 16 synthetic_hard images, the i-th stored as
    `table[i]` (kind, extension) by `write(kind, rgb)`, and the folder's
    keys in kgtpu_reference_formats.npz (`<key>_decode_json`,
    `<key>_kinds_json`, `<key>_ids`, `<key>_metrics_json`,
    `labels_<key>_<dtype>`, `counts_<key>_<dtype>`), the other keys kept."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import cv2
    import numpy as np
    src = os.path.join(out, "synthetic_hard")
    fdir = os.path.join(out, "formats", key)
    shutil.rmtree(fdir, ignore_errors=True)
    os.makedirs(fdir)
    ids = sorted(f[:-4] for f in os.listdir(os.path.join(src, "images")))
    gt = {i: cv2.imread(os.path.join(src, "labels", f"{i}.png"), cv2.IMREAD_UNCHANGED)
          for i in ids}
    kinds = {}
    for i, (kind, ext) in zip(ids, table):
        rgb = cv2.imread(os.path.join(src, "images", f"{i}.png"), cv2.IMREAD_COLOR)[..., ::-1]
        with open(os.path.join(fdir, i + ext), "wb") as f:
            f.write(write(kind, np.ascontiguousarray(rgb)))
        kinds[i + ext] = kind
    rels = sorted(kinds)
    decodes = cv2_decodes(fdir, rels)
    runs = kgtpu_runs(fdir, gt, f"assets_torch/formats/{key}")
    path = os.path.join(out, "kgtpu_reference_formats.npz")
    with np.load(path) as ref:
        result = {k: ref[k] for k in ref.files if not k.startswith(f"{key}_")
                  and f"_{key}_" not in k}
    result.update({f"{key}_decode_json": np.array(json.dumps(decodes)),
                   f"{key}_kinds_json": np.array(json.dumps(kinds)),
                   f"{key}_ids": runs["ids"],
                   f"{key}_metrics_json": runs["metrics_json"]})
    for dtype in ("bfloat16", "float32"):
        result[f"labels_{key}_{dtype}"] = runs[f"labels_{dtype}"]
        result[f"counts_{key}_{dtype}"] = runs[f"counts_{dtype}"]
    np.savez_compressed(path, **result)
    size = sum(os.path.getsize(os.path.join(fdir, f)) for f in rels)
    print(f"{len(rels)} {key} files, {len(decodes)} decodes "
          f"({sum(d['sha256'] is None for d in decodes)} None), {size / 2**20:.2f} MiB; "
          f"npz {os.path.getsize(path) / 2**20:.2f} MiB")
    return 0


def make_variants(out: str) -> int:
    return make_folder(out, "variants", VARIANTS, write_variant)


def make_variants2(out: str) -> int:
    """formats/variants2 (served and decoded) and formats/variants2_extra
    (decoded only): `variants2_*` and `variants2_extra_*` keys."""
    import cv2
    import numpy as np
    rc = make_folder(out, "variants2", VARIANTS2, write_variant2)
    src = os.path.join(out, "synthetic_hard")
    fdir = os.path.join(out, "formats", "variants2_extra")
    shutil.rmtree(fdir, ignore_errors=True)
    os.makedirs(fdir)
    ids = sorted(f[:-4] for f in os.listdir(os.path.join(src, "images")))
    kinds = {}
    for i, (kind, ext) in zip(ids, VARIANTS2_EXTRA):
        rgb = cv2.imread(os.path.join(src, "images", f"{i}.png"), cv2.IMREAD_COLOR)[..., ::-1]
        with open(os.path.join(fdir, i + ext), "wb") as f:
            f.write(write_variant2_extra(kind, np.ascontiguousarray(rgb)))
        kinds[i + ext] = kind
    decodes = cv2_decodes(fdir, sorted(kinds))
    path = os.path.join(out, "kgtpu_reference_formats.npz")
    with np.load(path) as ref:
        result = {k: ref[k] for k in ref.files if not k.startswith("variants2_extra_")}
    result.update({"variants2_extra_decode_json": np.array(json.dumps(decodes)),
                   "variants2_extra_kinds_json": np.array(json.dumps(kinds))})
    np.savez_compressed(path, **result)
    size = sum(os.path.getsize(os.path.join(fdir, f)) for f in kinds)
    print(f"{len(kinds)} variants2_extra files, {len(decodes)} decodes "
          f"({sum(d['sha256'] is None for d in decodes)} None), {size / 2**20:.2f} MiB")
    return rc


def make_containers(out: str) -> int:
    return make_folder(out, "containers", CONTAINERS, write_container)


def make_jpeg2000(out: str) -> int:
    return make_folder(out, "jpeg2000", JPEG2000, write_jpeg2000)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=os.path.join(ROOT, "assets_torch"))
    p.add_argument("--only", choices=["variants", "variants2", "containers", "jpeg2000",
                                       "jpeg2000_styles", "jpeg2000_ht", "avif",
                                       "avif_folder"], default=None)
    a = p.parse_args(argv)
    if a.only == "variants":
        return make_variants(a.out)
    if a.only == "variants2":
        return make_variants2(a.out)
    if a.only == "containers":
        return make_containers(a.out)
    if a.only == "jpeg2000":
        return make_jpeg2000(a.out)
    if a.only == "jpeg2000_styles":
        return make_jpeg2000_styles(a.out)
    if a.only == "jpeg2000_ht":
        return make_jpeg2000_ht(a.out)
    if a.only == "avif":
        return make_avif(a.out)
    if a.only == "avif_folder":
        return make_avif_folder(a.out)

    import jax
    jax.config.update("jax_platforms", "cpu")
    import cv2
    import numpy as np
    from PIL import Image

    from kgtpu.data.coco import CocoDataset
    from kgtpu.data.neural_cells import NeuralCells

    src = os.path.join(a.out, "synthetic_hard")
    formats = os.path.join(a.out, "formats")
    shutil.rmtree(formats, ignore_errors=True)
    for sub in ("jpeg", "mixed", "neural_cells/images", "neural_cells/labels"):
        os.makedirs(os.path.join(formats, sub))
    ids = sorted(f[:-4] for f in os.listdir(os.path.join(src, "images")))
    bgr = {i: cv2.imread(os.path.join(src, "images", f"{i}.png"), cv2.IMREAD_COLOR) for i in ids}
    gt = {i: cv2.imread(os.path.join(src, "labels", f"{i}.png"), cv2.IMREAD_UNCHANGED)
          for i in ids}

    for i in ids:
        cv2.imwrite(os.path.join(formats, "jpeg", f"{i}.jpg"), bgr[i],
                    [cv2.IMWRITE_JPEG_QUALITY, 95, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                     cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, cv2.IMWRITE_JPEG_RST_INTERVAL, 8])
    mixed = os.path.join(formats, "mixed")
    for i in ids[:MIXED_IDS]:
        cut = np.ascontiguousarray(bgr[i][128:384, 128:384])
        cv2.imwrite(os.path.join(mixed, f"{i}_progressive.jpg"), cut,
                    [cv2.IMWRITE_JPEG_QUALITY, 95, cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
        tiled_tiff(os.path.join(mixed, f"{i}_tiled.tif"), cut[..., ::-1])
        Image.fromarray(cut[..., ::-1]).save(os.path.join(mixed, f"{i}_lzw.tif"),
                                             compression="tiff_lzw")
        cv2.imwrite(os.path.join(mixed, f"{i}_rgb16.tif"), cut.astype(np.uint16) * 257 + 3,
                    [cv2.IMWRITE_TIFF_COMPRESSION, cv2.IMWRITE_TIFF_COMPRESSION_ADOBE_DEFLATE])
        cv2.imwrite(os.path.join(mixed, f"{i}.bmp"), cut)

    with open(os.path.join(formats, "coco_annotations.json"), "w") as f:
        json.dump(coco_annotations(gt), f, separators=(",", ":"))

    nc = os.path.join(formats, "neural_cells")
    for n, i in enumerate(ids[MIXED_IDS:MIXED_IDS + NEURAL_IDS]):
        cid = f"cell_{n:02d}"
        cut = np.ascontiguousarray(bgr[i][128:384, 128:384])
        lab = gt[i][128:384, 128:384]
        Image.fromarray(cut[..., ::-1]).save(os.path.join(nc, "images", f"{cid}.tif"),
                                             compression="tiff_adobe_deflate")
        if n < NEURAL_IDS - NEURAL_MASK_IDS:
            cv2.imwrite(os.path.join(nc, "labels", f"{cid}.png"), lab.astype(np.uint16))
            continue
        mdir = os.path.join(nc, "masks", cid)
        os.makedirs(mdir)
        for k, v in enumerate(v for v in np.unique(lab) if v):
            m = ((lab == v) * 255).astype(np.uint8)
            ext = (".png", ".bmp", ".tif")[k % 3]
            cv2.imwrite(os.path.join(mdir, f"m{k:02d}{ext}"), m)
        with open(os.path.join(mdir, "m05_notes.txt"), "w") as f:
            f.write("not an image: the readers skip it\n")

    # cv2's decodes, in RGB order, as kgtpu's readers see them
    decode = cv2_decodes(formats, fixtures(formats))
    runs = kgtpu_runs(os.path.join(formats, "jpeg"), gt, "assets_torch/formats/jpeg")
    result = {"decode_json": np.array(json.dumps(decode)), **runs}

    datasets = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, cls in (("coco", CocoDataset), ("neural_cells", NeuralCells)):
            root = dataset_layout(formats, tmp, name)
            for split in ("train", "val"):
                ds = cls(root, split=split)
                datasets[f"{name}/{split}"] = [
                    {"id": s["id"], "image": sha(s["image"]),
                     "label_map": sha(s["label_map"].astype(np.int32)),
                     "shape": list(s["label_map"].shape)}
                    for s in (ds[k] for k in range(len(ds)))]
    result["datasets_json"] = np.array(json.dumps(datasets))
    np.savez_compressed(os.path.join(a.out, "kgtpu_reference_formats.npz"), **result)
    total = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(formats)
                for f in fs) + os.path.getsize(os.path.join(a.out, "kgtpu_reference_formats.npz"))
    print(f"{len(decode)} decodes, datasets {[(k, len(v)) for k, v in datasets.items()]}, "
          f"{total / 2**20:.2f} MiB")
    return (make_variants(a.out) or make_variants2(a.out) or make_containers(a.out)
            or make_jpeg2000(a.out) or make_jpeg2000_styles(a.out) or make_jpeg2000_ht(a.out)
            or make_avif(a.out) or make_avif_folder(a.out))


if __name__ == "__main__":
    sys.exit(main())
