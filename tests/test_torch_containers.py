"""The port's PNM / PAM / PFM, Sun raster, Radiance HDR and GIF readers
(`kgtpu_torch/data/{pnm,sunras,hdr,gif}.py`) against cv2 5.0, which
kgtpu's readers call, and the committed container fixtures against cv2's
recorded decodes.

Each case is a small file (1-64 px, odd sides included) written by cv2,
PIL or `tools/variant_encoders.py` and named `.png`, as kgtpu would meet
it: cv2 picks the decoder by content.  Every case is read in all three
modes; where cv2 returns None the port must raise `UnreadableImage`.

Tolerance: none.  Every comparison is exact (dtype, shape and every value).
"""

import io
import json
import os

import cv2
import numpy as np
import pytest
from PIL import Image

from kgtpu_torch.data.imread import MODES, UnreadableImage, read_image
from tools import variant_encoders as ve

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CV = {"color": cv2.IMREAD_COLOR, "gray": cv2.IMREAD_GRAYSCALE,
       "unchanged": cv2.IMREAD_UNCHANGED}


def cv2_read(path, mode):
    """cv2.imread in the port's channel order (RGB / RGBA), or None."""
    img = cv2.imread(path, _CV[mode])
    if img is not None and img.ndim == 3 and img.shape[2] in (3, 4):
        img = img[..., [2, 1, 0, 3][:img.shape[2]]]
    return img


def check(tmp_path, data: bytes, modes=MODES) -> int:
    """The port reads `data` as cv2 does in `modes`; the number cv2 reads."""
    path = str(tmp_path / "image.png")
    with open(path, "wb") as f:
        f.write(data)
    read = 0
    for mode in modes:
        want = cv2_read(path, mode)
        if want is None:
            with pytest.raises(UnreadableImage):
                read_image(path, mode)
            continue
        got = read_image(path, mode)
        assert (got.dtype, got.shape) == (want.dtype, want.shape), mode
        np.testing.assert_array_equal(got, want, err_msg=mode)
        read += 1
    return read


def _rng(name: str):
    return np.random.default_rng(sum(map(ord, name)))


def _size(rng):
    return int(rng.integers(1, 64)), int(rng.integers(1, 64))


def _cv2(ext, img, params=()):
    return cv2.imencode(ext, img, list(params))[1].tobytes()


def _pil(img, fmt, **kw):
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()


def smooth(h, w, seed=0):
    """Gradients and a sine with a noisy band."""
    y, x = np.mgrid[:h, :w]
    a = np.stack([(x * 7 + y * 3) % 256, (x * y) % 256,
                  128 + 100 * np.sin(x / 5.0 + y / 7.0)], -1).astype(np.uint8)
    a[h // 3:h // 2] = np.random.default_rng(seed).integers(0, 256, a[h // 3:h // 2].shape)
    return a


# --- PNM -----------------------------------------------------------------------------

def _pnm_cases():
    def ascii_body(vals):
        return " ".join(map(str, vals)).encode() + b"\n"
    out = {}
    for name, ext, binary, kind in (("p6", ".ppm", 1, "rgb"), ("p5", ".pgm", 1, "grey"),
                                    ("p4", ".pbm", 1, "bits"), ("p3", ".ppm", 0, "rgb"),
                                    ("p2", ".pgm", 0, "grey"), ("p1", ".pbm", 0, "bits"),
                                    ("p6_16bit", ".ppm", 1, "rgb16"),
                                    ("p5_16bit_ascii", ".pgm", 0, "grey16")):
        rng = _rng(name)
        h, w = _size(rng)
        a = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        img = {"rgb": a, "grey": a[..., 0], "bits": (a[..., 0] > 127).astype(np.uint8) * 255,
               "rgb16": a.astype(np.uint16) * 257 + 3, "grey16": a[..., 1].astype(np.uint16) * 200}
        out[name] = _cv2(ext, img[kind], (cv2.IMWRITE_PXM_BINARY, binary))
    rng = _rng("pnm hand")
    v = rng.integers(0, 400, 60)
    out["p2_maxval100_comments"] = (b"P2 # a comment\n5\t#another\n4 100\r\n"
                                    + ascii_body(v[:20]))
    out["p3_maxval7_clipped"] = b"P3\n5 4\n7\n" + ascii_body(v % 11)
    out["p3_maxval1000"] = b"P3 5 4 1000 " + ascii_body(v)
    out["p5_maxval100_unscaled"] = b"P5\n7 3\n100\n" + bytes(range(0, 252, 12))
    out["p6_maxval300"] = b"P6 3 2 300\n" + bytes(rng.integers(0, 256, 36, dtype=np.uint8))
    out["p1_packed_digits"] = b"P1\n# bits\n7 2\n01101001011010\n"
    out["p4_comment"] = ve.pbm_p4(rng.random((9, 13)) < 0.5, comment=b"# hello\n")
    out["p2_ends_at_last_number"] = b"P2 2 2 255 1 2 3 4"
    out["p2_hash_after_number_refused"] = b"P2 2 2 255 1#c\n 2 3 4 "
    out["p5_truncated"] = b"P5 4 4 255\n" + bytes(10)
    out["p5_number_too_large"] = b"P5 4 99999999999 255\n" + bytes(16)
    out["p5_bad_header_byte"] = b"P5 4 x4 255\n" + bytes(16)
    out["p6_maxval_past_65535"] = b"P6 1 1 70000\n" + bytes(6)
    return out


# --- PAM ---------------------------------------------------------------------------------

def _pam_cases():
    out = {}
    for name, shape, dtype in (("pam_rgb_cv2", (3,), np.uint8), ("pam_grey_cv2", (), np.uint8),
                               ("pam_rgb16_cv2_refused", (3,), np.uint16)):
        rng = _rng(name)
        h, w = _size(rng)
        a = rng.integers(0, 256 if dtype == np.uint8 else 65536, (h, w) + shape).astype(dtype)
        out[name] = _cv2(".pam", a)
    rng = _rng("pam hand")
    g = rng.integers(0, 256, (7, 9), dtype=np.uint8)
    rgb = rng.integers(0, 256, (7, 9, 3), dtype=np.uint8)
    out["pam_grayscale_comment"] = ve.pam_file(g, "GRAYSCALE", comment=b"# note\n\n")
    out["pam_rgb_tupltype_maxval15"] = ve.pam_file(rgb % 16, "RGB", maxval=15)
    out["pam_rgb_16bit_tupltype"] = ve.pam_file(rgb.astype(np.uint16) * 250, "RGB", maxval=65535)
    out["pam_blackandwhite"] = ve.pam_file(np.packbits(g > 127, 1)[:, :2], "BLACKANDWHITE",
                                           maxval=1)
    out["pam_blackandwhite_wide"] = ve.pam_file(rng.integers(0, 256, (5, 19)), None, maxval=1)
    out["pam_no_tupltype_4ch"] = ve.pam_file(np.dstack([rgb, g]), None)
    out["pam_lowercase_tupltype"] = ve.pam_file(rgb, "rgb")
    out["pam_tupltype_depth_mismatch"] = ve.pam_file(g, "RGB")
    out["pam_truncated"] = ve.pam_file(rgb, "RGB")[:-5]
    return out


def _pam_alpha_cases():
    """GRAYSCALE_ALPHA and RGB_ALPHA: cv2 converts only the first
    ceil(w / depth) pixels of a row; "color" leaves the rest of the row as
    its allocation was, so only "gray" (at widths where the three bytes per
    pixel reach the row's end) and "unchanged" are compared."""
    rng = _rng("pam alpha")
    out = {}
    for w in (5, 9):
        out[f"pam_grayscale_alpha_w{w}"] = ve.pam_file(
            rng.integers(0, 256, (6, w, 2), dtype=np.uint8), "GRAYSCALE_ALPHA")
        out[f"pam_rgb_alpha_w{w}"] = ve.pam_file(
            rng.integers(0, 256, (6, w, 4), dtype=np.uint8), "RGB_ALPHA")
        out[f"pam_rgb_alpha16_w{w}"] = ve.pam_file(
            rng.integers(0, 65536, (6, w, 4)), "RGB_ALPHA", maxval=4000)
    return out


# --- PFM -------------------------------------------------------------------------------

def _pfm_cases():
    rng = _rng("pfm")
    out = {}
    for name, ch in (("pfm_colour_cv2", 3), ("pfm_grey_cv2", 1)):
        h, w = _size(rng)
        out[name] = _cv2(".pfm", (rng.random((h, w, ch)) * 300 - 20).astype(np.float32))
    special = np.array([300, 1e10, np.inf, np.nan, -np.inf, 2.5, 3.5, -0.4, 0.5, 1.5, 254.5,
                        2.1e9, 2.2e9, -3e9, 7], np.float32)
    out["pfm_grey_special_values"] = b"Pf\n5 3\n-1\n" + special.astype("<f4").tobytes()
    out["pfm_colour_big_endian"] = b"PF\n5\n1\n1.0\n" + (special * 1.5).astype(">f4").tobytes()
    out["pfm_grey_scale_3"] = b"Pf\n15 1\n-3.0\n" + special.astype("<f4").tobytes()
    out["pfm_space_not_newline"] = b"PF 5 1\n-1\n" + special.astype("<f4").tobytes()
    out["pfm_truncated"] = b"Pf\n5 3\n-1\n" + special[:10].astype("<f4").tobytes()
    return out


# --- Sun raster ------------------------------------------------------------------------

def _sun_cases():
    rng = _rng("sun")
    out = {}
    for depth in (1, 8, 24, 32):
        h, w = _size(rng)
        px = (rng.integers(0, 2, (h, w)) if depth == 1 else
              rng.integers(0, 256, (h, w) if depth == 8 else (h, w, depth // 8)))
        out[f"sun_{depth}"] = ve.sun_raster(px, depth, 1)
        out[f"sun_{depth}_old_type"] = ve.sun_raster(px, depth, 0)
        out[f"sun_{depth}_rle_refused"] = ve.sun_raster(px, depth, 2)
        out[f"sun_{depth}_rgb_type_refused"] = ve.sun_raster(px, depth, 3)
        if depth <= 8:
            n = 1 << depth
            out[f"sun_{depth}_colour_map"] = ve.sun_raster(px, depth, 1,
                                                          palette=rng.integers(0, 256, (n, 3)))
            out[f"sun_{depth}_grey_map"] = ve.sun_raster(
                px, depth, 1, palette=np.repeat(rng.integers(0, 256, (n, 1)), 3, 1))
    px = rng.integers(0, 256, (6, 7))
    out["sun_8_short_map"] = ve.sun_raster(px, 8, 1, palette=rng.integers(0, 256, (5, 3)))
    out["sun_24_with_map_refused"] = ve.sun_raster(rng.integers(0, 256, (6, 7, 3)), 24, 1,
                                                   palette=rng.integers(0, 256, (4, 3)))
    out["sun_cv2"] = _cv2(".ras", smooth(23, 17))
    out["sun_truncated"] = ve.sun_raster(px, 8, 1)[:-3]
    return out


# --- Radiance HDR ----------------------------------------------------------------------

def _hdr_cases():
    rng = _rng("hdr")
    out = {}
    for coding in ("flat", "rle", "old"):
        h, w = _size(rng)
        f = rng.random((h, w, 3)) * rng.choice([0.5, 2, 100])
        f[rng.random((h, w)) < 0.4] = f[0, 0]
        f[rng.random((h, w)) < 0.05] = 0
        data = ve.hdr_file(ve.rgbe(f), coding)
        # old-style runs read as pixels: the file then ends early unless
        # padded
        out[f"hdr_{coding}"] = data + (bytes(4 * h * w) if coding == "old" else b"")
    out["hdr_cv2"] = _cv2(".hdr", (rng.random((19, 27, 3)) * 3).astype(np.float32))
    px = ve.rgbe(rng.random((9, 12, 3)))
    out["hdr_header_lines"] = ve.hdr_file(px, "rle", header=b"#?RGBE\n# made here\nGAMMA=2.2\n"
                                          b"FORMAT=32-bit_rle_rgbe\nEXPOSURE=0.5\n")
    out["hdr_size_line_spacing"] = ve.hdr_file(px, "flat", size_line=b"-Y  9\t+X +12 junk\n")
    out["hdr_xyze_refused"] = ve.hdr_file(px, "flat", header=b"#?RADIANCE\n"
                                          b"FORMAT=32-bit_rle_xyze\n")
    out["hdr_plus_y_refused"] = ve.hdr_file(px, "flat", size_line=b"+Y 9 +X 12\n")
    out["hdr_format_crlf_refused"] = ve.hdr_file(px, "flat", header=b"#?RADIANCE\n"
                                                 b"FORMAT=32-bit_rle_rgbe\r\n")
    out["hdr_truncated"] = ve.hdr_file(px, "rle")[:-7]
    bad = bytearray(ve.hdr_file(px, "rle"))
    i = bad.index(bytes([2, 2, 0, 12]))
    bad[i + 3] = 13
    out["hdr_wrong_row_width_refused"] = bytes(bad)
    return out


# --- GIF -------------------------------------------------------------------------------

def _gif_cases():
    rng = _rng("gif")
    out = {}
    h, w = _size(rng)
    a = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    out["gif_pil"] = _pil(Image.fromarray(a), "GIF")
    out["gif_pil_interlaced"] = _pil(Image.fromarray(smooth(41, 23)), "GIF", interlace=True)
    frames = [Image.fromarray(a), Image.fromarray(a[::-1].copy()), Image.fromarray(255 - a)]
    out["gif_pil_animated"] = _pil(frames[0], "GIF", save_all=True, append_images=frames[1:],
                                   duration=50, loop=0, disposal=2)
    out["gif_pil_transparency"] = _pil(Image.fromarray(a).convert("P"), "GIF", transparency=3)
    pal = rng.integers(0, 256, (16, 3))
    idx = rng.integers(0, 16, (11, 14))
    idx[6:] = idx[6:, :1]
    out["gif_local_palette"] = ve.gif_file([{"idx": idx, "palette": pal[::-1]}], 14, 11, pal)
    out["gif_only_local_palette"] = ve.gif_file([{"idx": idx, "palette": pal}], 14, 11, None)
    out["gif_subframe_background"] = ve.gif_file([{"idx": idx[:5, :6], "left": 3, "top": 2}],
                                                 14, 11, pal, background=7)
    out["gif_subframe_transparent"] = ve.gif_file(
        [{"idx": idx[:5, :6], "left": 3, "top": 2, "transparent": 5}], 14, 11, pal, background=7)
    out["gif_transparent_in_second_frame"] = ve.gif_file(
        [{"idx": idx}, {"idx": idx, "transparent": 1}], 14, 11, pal)
    out["gif_interlaced_local"] = ve.gif_file(
        [{"idx": np.arange(13 * 5).reshape(13, 5) % 16, "interlace": True, "palette": pal}],
        5, 13, None)
    out["gif_no_colour_table"] = ve.gif_file([{"idx": idx}], 14, 11, None)
    out["gif_clear_codes"] = ve.gif_file([{"idx": idx, "clear_every": 7}], 14, 11, pal)
    big = rng.integers(0, 256, (64, 64))
    big[20:] = big[20:, :1]
    out["gif_full_table_256"] = ve.gif_file([{"idx": big}], 64, 64, rng.integers(0, 256, (256, 3)))
    out["gif_min_code_size_8"] = ve.gif_file([{"idx": idx, "min_size": 8}], 14, 11, pal)
    out["gif87a"] = ve.gif_file([{"idx": idx}], 14, 11, pal, version=b"GIF87a")
    good = ve.gif_file([{"idx": idx}], 14, 11, pal)
    out["gif_no_trailer"] = good[:-1]
    out["gif_truncated"] = good[:len(good) * 2 // 3]
    out["gif_background_past_table"] = ve.gif_file([{"idx": idx}], 14, 11, pal, background=200)
    out["gif_index_past_table"] = ve.gif_file([{"idx": idx + 6}], 14, 11, pal[:8])
    out["gif_frame_outside_screen"] = ve.gif_file([{"idx": idx, "left": 2}], 14, 11, pal)
    head = ve.gif_file([], 14, 11, pal)[:-1]
    lz = ve.gif_lzw(idx.astype(np.uint8).tobytes(), 4)
    frame = b"\x2c" + bytes(4) + (14).to_bytes(2, "little") + (11).to_bytes(2, "little") + b"\0\x04"
    out["gif_lzw_bytes_after_end_code_refused"] = head + frame + ve.gif_sub_blocks(lz + b"\0\0") + b";"
    out["gif_lzw_end_code_cut"] = head + frame + ve.gif_sub_blocks(lz[:-1]) + b";"
    out["gif_lzw_split_sub_blocks"] = (head + frame + bytes([3]) + lz[:3] + bytes([len(lz) - 3])
                                       + lz[3:] + b"\0;")
    out["gif_bad_lzw_code"] = head + (b"\x2c" + bytes(4) + (14).to_bytes(2, "little")
                                      + (11).to_bytes(2, "little") + b"\0\x04"
                                      + ve.gif_sub_blocks(b"\x10\xff\xff\xff") + b";")
    return out


CASES = {**_pnm_cases(), **_pam_cases(), **_pfm_cases(), **_sun_cases(), **_hdr_cases(),
         **_gif_cases()}
REFUSED = {k for k in CASES if any(s in k for s in ("refused", "truncated", "too_large", "bad_",
                                                     "past", "mismatch", "no_tupltype",
                                                     "lowercase", "no_trailer", "outside",
                                                     "after_end_code",
                                                     "space_not", "ends_at"))}


@pytest.mark.parametrize("name", sorted(CASES))
def test_container_reads_like_cv2(tmp_path, name):
    """Every case in every mode equals cv2's read, or raises
    UnreadableImage where cv2 returns None (the refusals: cv2 reads none
    of their modes, except PFM's channel-count refusal, one mode)."""
    read = check(tmp_path, CASES[name])
    if name in REFUSED:
        assert read == 0, "a case meant as a refusal was read"
    elif name.startswith("pfm"):
        assert read == 2, "PFM reads in its own channel count and 'unchanged'"
    else:
        assert read == 3


@pytest.mark.parametrize("name", sorted(_pam_alpha_cases()))
def test_pam_alpha_layouts_read_like_cv2(tmp_path, name):
    assert check(tmp_path, _pam_alpha_cases()[name], ("gray", "unchanged")) == 2


def test_committed_container_fixtures_decode_as_cv2_recorded():
    """The 16 files of assets_torch/formats/containers in every mode equal
    cv2's decode recorded in kgtpu_reference_formats.npz (sha256, shape,
    dtype), and cv2 here still decodes them so."""
    from tools.make_torch_format_assets import CONTAINERS, sha
    folder = os.path.join(ROOT, "assets_torch", "formats", "containers")
    with np.load(os.path.join(ROOT, "assets_torch", "kgtpu_reference_formats.npz")) as ref:
        decodes = json.loads(str(ref["containers_decode_json"]))
        kinds = json.loads(str(ref["containers_kinds_json"]))
    assert sorted(kinds.values()) == sorted(k for k, _ in CONTAINERS)
    assert {os.path.splitext(f)[1] for f in kinds} <= {".png", ".jpg", ".tif", ".bmp"}
    assert len(decodes) == 3 * len(kinds)
    for d in decodes:
        path = os.path.join(folder, d["path"])
        got = read_image(path, d["mode"])
        want = cv2_read(path, d["mode"])
        assert (sha(got), list(got.shape), str(got.dtype)) == (d["sha256"], d["shape"],
                                                               d["dtype"]), d
        np.testing.assert_array_equal(got, want)


def test_folder_and_neural_cells_read_containers_like_kgtpu(tmp_path):
    """kgtpu's folder and neural_cells readers (cv2) and the port's over a
    tree of container files under kgtpu's extensions, sample by sample
    (sha256 of every image and label map): images in every container,
    label maps as grey PFM (float, cast to int32 as kgtpu casts it), 16-bit
    PGM and PAM, masks as GIF, WebP and PBM read in grey."""
    import warnings

    from kgtpu.data.folder import ImageFolder as JaxImageFolder
    from kgtpu.data.neural_cells import NeuralCells as JaxNeuralCells
    from kgtpu_torch.data.folder import ImageFolder
    from kgtpu_torch.data.neural_cells import NeuralCells
    from test_torch_datasets import assert_same_samples
    h, w = 40, 52
    a = smooth(h, w, 5)
    files = {"ppm.png": _cv2(".ppm", a), "pgm.jpg": _cv2(".pgm", a[..., 1]),
             "pam.tif": _cv2(".pam", a), "sun.bmp": _cv2(".ras", a), "hdr.tiff": _cv2(".hdr", (
                 a / 255.0).astype(np.float32)), "gif.jpeg": _pil(Image.fromarray(a), "GIF"),
             "webp.png": _pil(Image.fromarray(a), "WEBP", quality=80),
             "webp_lossless.bmp": _pil(Image.fromarray(a), "WEBP", lossless=True)}
    folder = tmp_path / "folder"
    os.makedirs(folder / "sub")
    for n, (name, data) in enumerate(sorted(files.items())):
        with open(folder / ("sub" if n % 2 else ".") / name, "wb") as f:
            f.write(data)
    assert_same_samples(ImageFolder(str(folder)), JaxImageFolder(str(folder)))
    root = tmp_path / "cells"
    os.makedirs(root / "images")
    os.makedirs(root / "labels")
    for n, (name, data) in enumerate(sorted(files.items())):
        cid, ext = f"cell_{n:02d}", os.path.splitext(name)[1]
        with open(root / "images" / (cid + ext), "wb") as f:
            f.write(data)
        lab = np.zeros((h, w), np.uint16)
        lab[5:15, 5:20], lab[20:35, 25:50] = 1, 2 + n
        label = (b"Pf\n%d %d\n-1.0\n" % (w, h) + lab[::-1].astype("<f4").tobytes() if n % 4 == 0
                 else _cv2(".pgm", lab) if n % 4 == 1 else ve.pam_file(lab, "GRAYSCALE", 65535)
                 if n % 4 == 2 else None)
        if label is not None:
            with open(root / "labels" / f"{cid}.png", "wb") as f:
                f.write(label)
            continue
        os.makedirs(root / "masks" / cid)
        for k, v in enumerate(v for v in np.unique(lab) if v):
            m = (lab == v).astype(np.uint8) * 255
            data = (_pil(Image.fromarray(m), "GIF") if k == 0 else
                    _pil(Image.fromarray(m), "WEBP", lossless=True) if k == 1 else
                    ve.pbm_p4(m > 0))
            with open(root / "masks" / cid / f"m{k}.png", "wb") as f:
                f.write(data)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for split in ("train", "val"):
            ours, theirs = NeuralCells(str(root), split), JaxNeuralCells(str(root), split)
            assert ours.paths == theirs.paths
            if len(theirs):
                assert_same_samples(ours, theirs)
