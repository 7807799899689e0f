"""The port's WebP reader (`kgtpu_torch/data/{webp,vp8l,vp8,vp8_pixels}.py`)
against cv2 5.0 (libwebp 1.5 inside), which kgtpu's readers call.

Cases are small files (1-64 px, odd sides included, so macroblocks are
padded and fancy upsampling meets the odd edge) written by PIL or cv2, or
assembled by `tools/variant_encoders.py` where neither writes them: ALPH
chunks raw or VP8L-coded under each filter, VP8 frames whose first
partition is coded again with the simple loop filter, other sharpness and
filter deltas, quantiser deltas and segment quantisers and filter levels
(`vp8_rewrite`), animations whose first frame does not cover the canvas,
streams cut inside their chunk and bit flips.  Every case is named `.png`
and read in all three modes; where cv2 returns None the port must raise
`UnreadableImage`.

Tolerance: none.  Every comparison is exact (dtype, shape and every value).
"""

import io
import os

import cv2
import numpy as np
import pytest
from PIL import Image

from kgtpu_torch.data import vp8l
from kgtpu_torch.data.imread import MODES, UnreadableImage, read_image
from tools import variant_encoders as ve

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CV = {"color": cv2.IMREAD_COLOR, "gray": cv2.IMREAD_GRAYSCALE,
       "unchanged": cv2.IMREAD_UNCHANGED}


def check(tmp_path, data: bytes) -> int:
    """The port reads `data` as cv2 does in every mode; the modes cv2 reads."""
    path = str(tmp_path / "image.png")
    with open(path, "wb") as f:
        f.write(data)
    read = 0
    for mode in MODES:
        want = cv2.imread(path, _CV[mode])
        if want is None:
            with pytest.raises(UnreadableImage):
                read_image(path, mode)
            continue
        if want.ndim == 3:
            want = want[..., [2, 1, 0, 3][:want.shape[2]]]
        got = read_image(path, mode)
        assert (got.dtype, got.shape) == (want.dtype, want.shape), mode
        np.testing.assert_array_equal(got, want, err_msg=mode)
        read += 1
    return read


def smooth(h, w, seed=0):
    y, x = np.mgrid[:h, :w]
    a = np.stack([(x * 7 + y * 3) % 256, (x * y) % 256,
                  128 + 100 * np.sin(x / 5.0 + y / 7.0)], -1).astype(np.uint8)
    a[h // 3:h // 2] = np.random.default_rng(seed).integers(0, 256, a[h // 3:h // 2].shape)
    return a


def pil(img, **kw) -> bytes:
    buf = io.BytesIO()
    (img if isinstance(img, Image.Image) else Image.fromarray(img)).save(buf, "WEBP", **kw)
    return buf.getvalue()


def vp8l_payload(rgb) -> bytes:
    return dict(ve.webp_chunks(pil(rgb, lossless=True)))[b"VP8L"]


def vp8_frame(rgb, quality=75) -> bytes:
    return dict(ve.webp_chunks(pil(rgb, quality=quality)))[b"VP8 "]


# --- lossless -------------------------------------------------------------------------

def _lossless_cases():
    rng = np.random.default_rng(7)
    out = {}
    for ncol in (2, 3, 11, 200, 300):          # colour indexing: 8, 4, 2, 1 pixels a byte
        pal = rng.integers(0, 256, (ncol, 3), dtype=np.uint8)
        h, w = int(rng.integers(1, 64)), int(rng.integers(1, 64))
        out[f"vp8l_{ncol}_colours"] = pil(pal[rng.integers(0, ncol, (h, w))], lossless=True,
                                          method=6 if ncol == 300 else 4, quality=90)
    for method in (0, 3, 6):
        h, w = int(rng.integers(1, 64)), int(rng.integers(1, 64))
        out[f"vp8l_smooth_m{method}"] = pil(smooth(h, w, method), lossless=True, method=method)
        out[f"vp8l_noise_m{method}"] = pil(rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
                                           lossless=True, method=method)
    rgba = rng.integers(0, 256, (29, 37, 4), dtype=np.uint8)
    out["vp8l_rgba"] = pil(rgba, lossless=True)
    out["vp8l_rgba_exact"] = pil(rgba, lossless=True, exact=True)
    halves = smooth(48, 48, 3)
    halves[:, :24] = rng.integers(0, 256, halves[:, :24].shape)   # two statistics: meta codes
    out["vp8l_meta_codes"] = pil(halves, lossless=True, method=6, quality=100)
    # crops of a committed test image: between them the predictor picks all
    # 14 modes
    src = os.path.join(ROOT, "assets_torch", "synthetic_hard", "images")
    img = np.asarray(Image.open(os.path.join(src, sorted(os.listdir(src))[0])).convert("RGB"))
    for off in (100, 200):
        out[f"vp8l_crop_{off}"] = pil(img[off:off + 64, off:off + 63], lossless=True, method=6,
                                      quality=100)
    out["vp8l_cv2"] = cv2.imencode(".webp", smooth(33, 47), [cv2.IMWRITE_WEBP_QUALITY, 101])[1] \
        .tobytes()
    return out


LOSSLESS = _lossless_cases()


@pytest.mark.parametrize("name", sorted(LOSSLESS))
def test_lossless_reads_like_cv2(tmp_path, name):
    assert check(tmp_path, LOSSLESS[name]) == 3


def test_lossless_cases_cover_every_transform_cache_and_meta_codes(monkeypatch):
    """The lossless cases above reach each of the four transforms, colour
    indexing at every packing, the colour cache and meta prefix codes."""
    seen = {"transforms": set(), "bundles": set(), "cache": 0, "meta": 0, "modes": set()}
    decode, pixels = vp8l._decode_image, vp8l._pixels

    def spy_decode(br, xs, ys, level0, transforms=None):
        out = decode(br, xs, ys, level0, transforms)
        for t in transforms or ():
            seen["transforms"].add(t["kind"])
            if t["kind"] == vp8l.COLOR_INDEXING:
                seen["bundles"].add(t["bits"])
            if t["kind"] == vp8l.PREDICTOR:
                seen["modes"] |= set(((np.array(t["data"], np.uint32) >> 8) & 15).tolist())
        return out

    def spy_pixels(br, xsize, ysize, groups, meta, meta_bits, cache_bits):
        seen["cache"] += cache_bits > 0
        seen["meta"] += meta is not None
        return pixels(br, xsize, ysize, groups, meta, meta_bits, cache_bits)
    monkeypatch.setattr(vp8l, "_decode_image", spy_decode)
    monkeypatch.setattr(vp8l, "_pixels", spy_pixels)
    from kgtpu_torch.data.webp import decode_webp
    for data in LOSSLESS.values():
        decode_webp(data, "unchanged")
    assert seen["transforms"] == {0, 1, 2, 3}
    assert seen["bundles"] == {0, 1, 2, 3}
    assert seen["cache"] > 0 and seen["meta"] > 0
    assert seen["modes"] == set(range(14))


# --- lossy -------------------------------------------------------------------------------

@pytest.mark.parametrize("quality", range(0, 101, 5))
def test_lossy_quality_sweep_reads_like_cv2(tmp_path, quality):
    """Random and smooth images at odd sizes through PIL and cv2 (segments,
    skip flags, every intra mode, the normal loop filter)."""
    rng = np.random.default_rng(quality)
    h, w = 2 * int(rng.integers(0, 32)) + 1, 2 * int(rng.integers(0, 32)) + 1
    assert check(tmp_path, pil(rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
                               quality=quality, method=quality % 7)) == 3
    a = smooth(int(rng.integers(1, 64)), int(rng.integers(1, 64)), quality)
    assert check(tmp_path, cv2.imencode(".webp", a, [cv2.IMWRITE_WEBP_QUALITY, quality])[1]
                 .tobytes()) == 3


def _rewrites():
    return {
        "simple_filter": {"filt": {"simple": 1}},
        "simple_filter_sharp": {"filt": {"simple": 1, "level": 40, "sharpness": 3}},
        "simple_filter_deltas": {"filt": {"simple": 1, "level": 10, "ref": [-12, 0, 0, 0],
                                          "mode": [20, 0, 0, 0]}},
        "normal_filter_sharpness_6": {"filt": {"simple": 0, "level": 20, "sharpness": 6}},
        "normal_filter_deltas": {"filt": {"simple": 0, "level": 30, "ref": [5, 0, 0, 0],
                                          "mode": [-7, 0, 0, 0]}},
        "normal_filter_level_63": {"filt": {"simple": 0, "level": 63}},
        "no_filter": {"filt": {"level": 0}},
        "quant_deltas": {"quant": {"base": 60, "deltas": [-15, 7, 15, -8, 3]}},
        "segments_relative": {"segment": {"absolute": 0, "quant": [-20, 5, 30, 0],
                                          "filter": [10, -5, 0, 63]}},
        "segments_absolute": {"segment": {"absolute": 1, "quant": [0, 40, 127, 10],
                                          "filter": [0, 20, 40, 63]}},
    }


@pytest.mark.parametrize("name", sorted(_rewrites()))
def test_lossy_header_variants_read_like_cv2(tmp_path, name):
    """The simple and normal loop filters, sharpness, reference and mode
    filter deltas, quantiser deltas and segment quantisers / filter levels
    (relative and absolute), on one frame whose first partition is coded
    again with them."""
    rng = np.random.default_rng(len(name))
    a = smooth(37, 45, len(name))
    a[:12] = rng.integers(0, 256, a[:12].shape)
    frame = ve.vp8_rewrite(vp8_frame(a, 70), **_rewrites()[name])
    assert check(tmp_path, ve.webp_riff([(b"VP8 ", frame)])) == 3


# --- alpha, metadata, animation -----------------------------------------------------------

def _alpha_cases():
    rng = np.random.default_rng(11)
    h, w = 27, 35
    a = smooth(h, w, 2)
    alpha = rng.integers(0, 256, (h, w), dtype=np.uint8)
    alpha[h // 2:] = 200
    frame = vp8_frame(a)
    out = {}
    for comp in (0, 1):
        for filt in range(4):
            chunks = [ve.vp8x(w, h, 0x10), ve.alph_chunk(alpha, comp, filt, vp8l_payload),
                      (b"VP8 ", frame)]
            out[f"alph_{('raw', 'vp8l')[comp]}_filter{filt}"] = ve.webp_riff(chunks)
    out["alph_preprocessing"] = ve.webp_riff([ve.vp8x(w, h, 0x10),
                                              ve.alph_chunk(alpha, 0, 1, preprocessing=1),
                                              (b"VP8 ", frame)])
    out["alph_without_flag"] = ve.webp_riff([ve.vp8x(w, h, 0), ve.alph_chunk(alpha, 0, 0),
                                             (b"VP8 ", frame)])
    out["alph_flag_without_chunk"] = ve.webp_riff([ve.vp8x(w, h, 0x10), (b"VP8 ", frame)])
    out["alph_pil_rgba"] = pil(np.dstack([a, alpha]), quality=60, alpha_quality=70)
    out["alph_bad_preprocessing_refused"] = ve.webp_riff(
        [ve.vp8x(w, h, 0x10), ve.alph_chunk(alpha, 0, 1, preprocessing=2), (b"VP8 ", frame)])
    out["alph_raw_short_refused"] = ve.webp_riff(
        [ve.vp8x(w, h, 0x10), (b"ALPH", bytes(w * h - 1)), (b"VP8 ", frame)])
    return out


def _metadata_cases():
    a = smooth(13, 21, 4)
    out = {}
    for o in (1, 3, 6, 8):
        tiff = (b"MM\0*\0\0\0\x08\0\x01\x01\x12\0\x03\0\0\0\x01" + o.to_bytes(2, "big")
                + b"\0\0\0\0\0\0")
        out[f"exif_orientation_{o}_lossy"] = pil(a, quality=70, exif=tiff, icc_profile=b"\0" * 60,
                                                 xmp=b"<x:xmpmeta/>")
        out[f"exif_orientation_{o}_lossless"] = pil(a, lossless=True, exif=b"Exif\0\0" + tiff)
    return out


def _animation_cases():
    rng = np.random.default_rng(13)
    h, w = 23, 31
    frames = [Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)) for _ in range(3)]
    rgba = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    out = {"anim_lossless": pil(frames[0], save_all=True, append_images=frames[1:], duration=80,
                                lossless=True),
           "anim_lossy": pil(frames[0], save_all=True, append_images=frames[1:], duration=80,
                             quality=60),
           "anim_rgba": pil(Image.fromarray(rgba), save_all=True,
                            append_images=[Image.fromarray(rgba[::-1].copy())], duration=50)}
    # a first frame that does not cover the canvas, on its transparent black
    sub = vp8l_payload(np.asarray(frames[1])[:11, :13])
    anmf = ((4).to_bytes(3, "little") + (3).to_bytes(3, "little") + (12).to_bytes(3, "little")
            + (10).to_bytes(3, "little") + (80).to_bytes(3, "little") + b"\0"
            + b"VP8L" + len(sub).to_bytes(4, "little") + sub + b"\0" * (len(sub) & 1))
    for flags, name in ((0x12, "anim_offset_frame_alpha"), (0x02, "anim_offset_frame")):
        out[name] = ve.webp_riff([ve.vp8x(w, h, flags), (b"ANIM", bytes(6)), (b"ANMF", anmf)])
    return out


def _damaged_cases():
    rng = np.random.default_rng(17)
    a = rng.integers(0, 256, (29, 41, 3), dtype=np.uint8)
    a[:10] = a[:10].mean((0, 1)).astype(np.uint8)
    out = {}
    for tag, payload in ((b"VP8 ", vp8_frame(a, 80)), (b"VP8L", vp8l_payload(a))):
        name = tag.decode().strip().lower()
        for cut in (1, 3, 4, 9, len(payload) // 3, len(payload) - 12):
            out[f"{name}_cut_{cut}"] = ve.webp_riff([(tag, payload[:len(payload) - cut])])
        for k in range(6):
            bad = bytearray(payload)
            i = int(rng.integers(11, len(bad)))
            bad[i] ^= 1 << int(rng.integers(0, 8))
            out[f"{name}_bit_flip_{k}"] = ve.webp_riff([(tag, bytes(bad))])
        whole = ve.webp_riff([(tag, payload)])
        out[f"{name}_file_cut"] = whole[:len(whole) - 2]
    return out


OTHER = {**_alpha_cases(), **_metadata_cases(), **_animation_cases(), **_damaged_cases()}


@pytest.mark.parametrize("name", sorted(OTHER))
def test_webp_variants_read_like_cv2(tmp_path, name):
    """ALPH chunks, VP8X metadata and EXIF orientation, animations' first
    frames, and cut or damaged streams."""
    read = check(tmp_path, OTHER[name])
    if name.endswith("refused") or name.endswith("file_cut"):
        assert read == 0
    elif "cut" not in name and "flip" not in name:
        assert read == 3
