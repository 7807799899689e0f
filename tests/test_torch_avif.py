"""The port's AVIF reader (`kgtpu_torch/data/avif.py`, `avif_color.py` and
the AV1 intra decoder `av1_*.py`) against cv2 5.0, which kgtpu's readers
call (libavif 1.4.2 over libaom 3.14.1), and its parts against libaom's own
code (through `tools/av1_oracle.py`, ctypes, tests only).

Files are written at test time from seeded numpy content (32-96 px, odd
sides for every chroma layout) by cv2's writer (lossless at quality 100),
PIL's (libavif 1.3 over aom, lossy with aom's in-loop filters off), and
libaom's own encoder (`variant_encoders.aom_encode`: monochrome, intra
block copy, grids, filter intra, colour matrices, superres, film grain),
named `.png` as kgtpu would meet them; each is read in "color", "gray" and
"unchanged".  A frame that needs a filter still queued (film grain) raises
`UnsupportedImage` naming it; where cv2 returns None the port raises
`UnreadableImage`.  Deblocking and CDEF have their own file,
`test_torch_av1_filters.py`, and so have loop restoration and superres,
`test_torch_av1_restoration.py`.

Tolerance: none for every file read (dtype, shape and every value).  The
float reference of the transforms is held to within 2 per position (the
transforms round at every butterfly); libaom's C transforms exactly.
"""

import functools
import json
import os
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

from kgtpu_torch.data.av1_decode import PORTED
from kgtpu_torch.data.imread import MODES, UnreadableImage, UnsupportedImage, read_image
from tools import variant_encoders as ve

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CV = {"color": cv2.IMREAD_COLOR, "gray": cv2.IMREAD_GRAYSCALE,
       "unchanged": cv2.IMREAD_UNCHANGED}
NOF = ve.AVIF_NO_FILTERS
NOF_AOM = {"enable-cdef": 0, "enable-restoration": 0, "loopfilter-control": 0}


def cv2_read(path, mode):
    img = cv2.imread(path, _CV[mode])
    if img is not None and img.ndim == 3 and img.shape[2] in (3, 4):
        img = img[..., [2, 1, 0, 3][:img.shape[2]]]
    return img


def check(tmp_path, data: bytes) -> int:
    """The port reads `data` as cv2 does in every mode; the modes cv2 reads."""
    path = str(tmp_path / "image.png")
    with open(path, "wb") as f:
        f.write(data)
    read = 0
    for mode in MODES:
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


def _cv2_lossless(img, depth=8) -> bytes:
    return cv2.imencode(".avif", img, [cv2.IMWRITE_AVIF_QUALITY, 100,
                                       cv2.IMWRITE_AVIF_DEPTH, depth])[1].tobytes()


def _deep(img, depth):
    return (img.astype(np.uint16) << (depth - 8)) | (img.astype(np.uint16) >> (16 - depth))


def _aom(img, fmt="444", opts=None, cicp=(1, 13, 6, 1), **cfg) -> bytes:
    """libaom's encode of [H, W, 3] uint8 planes (Y, U, V as given) in an
    AVIF of our own container."""
    h, w = img.shape[:2]
    planes = [img[..., 0], img[..., 1], img[..., 2]]
    if fmt == "420":
        planes = [planes[0]] + [np.ascontiguousarray(p[::2, ::2]) for p in planes[1:]]
    obus = ve.aom_encode([np.ascontiguousarray(p) for p in planes], fmt, opts or {},
                         usage=cfg.get("usage", 2), cfg_fields=cfg.get("cfg_fields"))
    return ve.avif_file(obus, w, h, ssx=int(fmt == "420"), ssy=int(fmt == "420"),
                        profile=int(fmt == "444"), cicp=cicp)


def _cases() -> dict:
    c = {}
    for name, (h, w, ch, depth) in {
            "cv2_rgb": (37, 51, 3, 8), "cv2_grey": (33, 40, 1, 8), "cv2_rgba": (40, 33, 4, 8),
            "cv2_rgb10": (48, 36, 3, 10), "cv2_rgb12": (35, 47, 3, 12),
            "cv2_grey10": (32, 33, 1, 10), "cv2_grey12": (41, 32, 1, 12),
            "cv2_rgba10": (34, 38, 4, 10)}.items():
        def make(h=h, w=w, ch=ch, depth=depth, name=name):
            img = ve.avif_content(_rng(name), h, w, ch)
            img = img[..., 0] if ch == 1 else img
            return _cv2_lossless(img if depth == 8 else _deep(img, depth), depth)
        c[name] = make
    for sub in ("4:2:0", "4:2:2", "4:4:4"):
        for q, (h, w) in ((35, (33, 47)), (80, (64, 64)), (60, (45, 31))):
            def make(sub=sub, q=q, h=h, w=w):
                img = ve.avif_content(_rng(f"{sub}{q}"), h, w, 3, "smooth")
                return ve.avif_pil(img, quality=q, subsampling=sub, advanced=NOF)
            c[f"pil_{sub[2]}{sub[4]}_q{q}_{h}x{w}"] = make
    for ch, depth in ((3, 10), (3, 12), (4, 10), (4, 12)):
        # cv2's lossy deep AVIF (4:2:0; no in-loop filter at quality 98): the
        # 8-bit reads cut the planes first, or with alpha take libyuv's 16-bit
        # rows (bilinear chroma at 10 bits, nearest at 12)
        def make(ch=ch, depth=depth):
            img = ve.avif_content(_rng(f"lossy{ch}{depth}"), 40, 30, ch, "smooth")
            return cv2.imencode(".avif", _deep(img, depth), [
                cv2.IMWRITE_AVIF_QUALITY, 98, cv2.IMWRITE_AVIF_DEPTH, depth])[1].tobytes()
        c[f"cv2_{'rgba' if ch == 4 else 'rgb'}{depth}_q98"] = make
    c["cv2_q95"] = lambda: cv2.imencode(".avif", ve.avif_content(_rng("95"), 96, 80, 3),
                                        [cv2.IMWRITE_AVIF_QUALITY, 95])[1].tobytes()
    c["pil_L"] = lambda: ve.avif_pil(ve.avif_content(_rng("L"), 40, 36, 1)[..., 0],
                                     quality=50, advanced=NOF)
    c["pil_rgba"] = lambda: ve.avif_pil(ve.avif_content(_rng("A"), 38, 44, 4), quality=60,
                                        advanced=NOF)
    c["pil_qm"] = lambda: ve.avif_pil(ve.avif_content(_rng("qm"), 64, 48, 3, "smooth"),
                                      quality=70, advanced=NOF + [
                                          ("enable-qm", "1"), ("qm-min", "2"), ("qm-max", "8")])
    c["pil_tiles"] = lambda: ve.avif_pil(ve.avif_content(_rng("t"), 96, 160, 3), quality=60,
                                         advanced=NOF + [("tile-columns", "1"),
                                                         ("tile-rows", "1")])
    c["pil_sb128"] = lambda: ve.avif_pil(ve.avif_content(_rng("s"), 90, 70, 3, "smooth"),
                                         quality=60, advanced=NOF + [("sb-size", "128")])
    c["pil_screen_palette"] = lambda: ve.avif_pil(
        ve.avif_content(_rng("p"), 64, 80, 3, "screen"), quality=60,
        advanced=NOF + [("tune-content", "screen")])
    c["pil_screen_lossless"] = lambda: ve.avif_pil(
        ve.avif_content(_rng("pl"), 48, 64, 3, "screen"), quality=100,
        advanced=NOF + [("tune-content", "screen")])
    c["pil_sequence"] = lambda: ve.avif_pil(
        ve.avif_content(_rng("q"), 36, 44, 3), quality=60, advanced=NOF, save_all=True,
        append_images=[Image.fromarray(ve.avif_content(_rng("q2"), 36, 44, 3))])
    c["pil_sequence_rgba"] = lambda: ve.avif_pil(
        ve.avif_content(_rng("qa"), 30, 34, 4), quality=70, advanced=NOF, save_all=True,
        append_images=[Image.fromarray(ve.avif_content(_rng("qa2"), 30, 34, 4))])

    def mono():
        y = ve.avif_content(_rng("m"), 48, 40, 1, "smooth")[..., 0]
        u = np.full((24, 20), 128, np.uint8)
        obus = ve.aom_encode([y, u, u], "420", {"cq-level": 30, **NOF_AOM},
                             cfg_fields={208: 1})
        return ve.avif_file(obus, 40, 48, mono=True, ssx=1, ssy=1, profile=0)
    c["aom_mono"] = mono

    def strip():
        left = ve.avif_content(_rng("ibc"), 64, 384, 3, "screen")
        return np.concatenate([left, left], 1)
    c["aom_intrabc_lossless"] = lambda: _aom(
        strip(), "444", {"tune-content": "screen", "lossless": 1, "cpu-used": 4},
        cicp=(1, 13, 0, 1))
    c["aom_intrabc_lossy"] = lambda: _aom(
        strip(), "444", {"tune-content": "screen", "cq-level": 20, "cpu-used": 4,
                         "enable-cdef": 0, "enable-restoration": 0}, cicp=(1, 13, 0, 1))
    def mixed():
        img = ve.avif_content(np.random.default_rng(4), 128, 160, 3, "smooth")
        img[:, 144:] = ve.avif_content(np.random.default_rng(5), 128, 16, 3, "noise")
        return img
    # aom's good-quality usage: variance AQ (segmentation) and delta q / lf
    c["aom_segmentation"] = lambda: _aom(mixed(), "420", {"cq-level": 30, "aq-mode": 1,
                                                           "cpu-used": 6, **NOF_AOM}, usage=0)
    c["aom_delta_q_lf"] = lambda: _aom(mixed(), "420", {"cq-level": 30, "deltaq-mode": 3,
                                                         "delta-lf-mode": 1, "cpu-used": 6,
                                                         **NOF_AOM}, usage=0)
    c["aom_chroma_delta_q"] = lambda: _aom(mixed(), "420", {"cq-level": 30, "cpu-used": 6,
                                                             "enable-chroma-deltaq": 1,
                                                             **NOF_AOM})
    c["aom_filter_intra"] = lambda: _aom(ve.avif_content(_rng("fi"), 64, 96, 3, "smooth"),
                                         "444", {"cpu-used": 0, "cq-level": 30, **NOF_AOM})

    def grid(tile=64, in_idat=True):
        img = ve.avif_content(_rng("g"), 2 * tile, 2 * tile, 3, "smooth")
        tiles = [ve.aom_encode([np.ascontiguousarray(t[..., k]) for k in range(3)], "444",
                               {"cq-level": 20, **NOF_AOM})
                 for t in (img[:tile, :tile], img[:tile, tile:], img[tile:, :tile],
                           img[tile:, tile:])]
        return ve.avif_grid(tiles, 2, 2, tile, tile, 2 * tile - 5, 2 * tile - 11,
                            cicp=(1, 13, 0, 1), in_idat=in_idat)
    c["aom_grid"] = grid
    c["aom_grid_tiles_under_64"] = functools.partial(grid, 40)
    @functools.lru_cache(maxsize=1)
    def transform_obus():
        img = ve.avif_content(_rng("tr"), 40, 56, 3, "smooth")
        return ve.aom_encode([np.ascontiguousarray(img[..., k]) for k in (1, 0, 2)], "444",
                             {"lossless": 1})

    def transformed(box):
        return ve.avif_file(transform_obus(), 56, 40, cicp=(1, 13, 0, 1), extra=[(box, True)])
    # libavif parses irot / imir / clap and leaves them to the caller; cv2
    # applies none of them, so each reads as the untransformed image
    c["aom_irot"] = functools.partial(transformed, ve._box(b"irot", bytes([1])))
    c["aom_imir"] = functools.partial(transformed, ve._box(b"imir", bytes([1])))
    c["aom_clap"] = functools.partial(transformed, ve._box(b"clap", struct.pack(
        ">8I", 20, 1, 30, 1, 0, 1, 0, 1)))
    c["aom_unknown_essential"] = functools.partial(transformed, ve._box(b"zzzz", b"abcd"))
    for label, cicp in {"bt709_full": (1, 1, 1, 1), "bt709_limited": (1, 1, 1, 0),
                        "bt601_limited": (6, 6, 6, 0), "bt2020_full": (9, 16, 9, 1),
                        "ycgco": (2, 2, 8, 1), "fcc": (2, 2, 4, 1),
                        # libavif derives kr / kb from the primaries (by its
                        # libyuv matrix for BT.709, BT.601 and BT.2020 ones)
                        "chroma_derived_bt709": (1, 13, 12, 1),
                        "chroma_derived_bt470bg": (5, 13, 12, 0),
                        "chroma_derived_bt2020": (9, 13, 12, 1),
                        "chroma_derived_bt470m": (4, 13, 12, 1),
                        "chroma_derived_p3": (12, 13, 12, 0),
                        "chroma_derived_ebu3213": (22, 13, 12, 1),
                        "chroma_derived_unknown": (200, 13, 12, 1),
                        "mc15": (1, 13, 15, 1), "mc15_limited": (1, 13, 15, 0),
                        # cv2 returns None for these two
                        "reserved": (1, 13, 3, 1), "ycgco_limited": (2, 2, 8, 0)}.items():
        c[f"aom_matrix_{label}"] = functools.partial(
            _aom, ve.avif_content(_rng(label), 34, 46, 3, "smooth"), "420",
            {"cq-level": 25, **NOF_AOM}, cicp)
    c["aom_matrix_identity_limited"] = functools.partial(
        _aom, ve.avif_content(_rng("identity"), 34, 46, 3, "smooth"), "444",
        {"cq-level": 25, **NOF_AOM}, (1, 13, 0, 0))

    def mono_under_colour(depth, cicp):
        """A monochrome frame in an item whose av1C says 4:2:0 colour:
        libavif converts it as YUV 4:0:0 (grey)."""
        y = ve.avif_content(_rng(f"muc{depth}"), 40, 36, 1, "smooth")[..., 0]
        u = np.full((20, 18), 128, np.uint8)
        obus = ve.aom_encode([y, u, u], "420", {"cq-level": 30, **NOF_AOM},
                             cfg_fields={208: 1})
        return ve.avif_file(obus, 36, 40, depth=depth, ssx=1, ssy=1, profile=0, cicp=cicp)
    c["aom_mono_under_colour_header"] = functools.partial(mono_under_colour, 8, (1, 13, 6, 0))
    c["aom_mono_under_colour_header_identity"] = functools.partial(
        mono_under_colour, 8, (1, 13, 0, 1))
    return c


NOT_READ = ("aom_grid_tiles_under_64", "aom_unknown_essential", "aom_matrix_reserved",
            "aom_matrix_ycgco_limited")


CASES = _cases()


@functools.lru_cache(maxsize=None)
def case(name: str) -> bytes:
    return CASES[name]()


@pytest.mark.parametrize("name", sorted(CASES))
def test_avif_reads_like_cv2(tmp_path, name):
    """Every kind in every mode equals cv2's read (cv2 reads all three; a
    grid of tiles under 64 px, which MIAF forbids, an item with an
    essential property libavif does not know, the reserved matrix
    coefficients 3 and YCgCo at limited range, none)."""
    assert check(tmp_path, case(name)) == (0 if name in NOT_READ else 3)


def test_cases_reach_the_tools_they_name():
    """The screen, intra block copy, filter intra, tile, superblock and
    quantiser-matrix cases code what they are named for."""
    from kgtpu_torch.data import av1_block, avif
    from kgtpu_torch.data.av1_obu import parse_frame
    seen = {"pal": 0, "ibc": 0, "filt": 0}
    orig = av1_block.TileDecoder.palette_tokens

    def counting(self, blk):
        seen["pal"] += bool(blk.pal[0] or blk.pal[1])
        seen["ibc"] += bool(blk.is_inter)
        seen["filt"] += bool(self.use_filter_intra)
        return orig(self, blk)
    av1_block.TileDecoder.palette_tokens = counting
    try:
        got = {}
        for name in ("pil_screen_palette", "aom_intrabc_lossy", "aom_filter_intra"):
            before = dict(seen)
            avif.decode_avif(case(name), "unchanged")
            got[name] = {k: seen[k] - before[k] for k in seen}
    finally:
        av1_block.TileDecoder.palette_tokens = orig
    assert got["pil_screen_palette"]["pal"] > 0
    assert got["aom_intrabc_lossy"]["ibc"] > 0
    assert got["aom_filter_intra"]["filt"] > 0
    headers = {n: parse_frame(avif.parse(case(n))[0].obus) for n in
               ("pil_tiles", "pil_sb128", "pil_qm", "aom_intrabc_lossless", "aom_segmentation",
                "aom_delta_q_lf", "aom_chroma_delta_q")}
    assert headers["aom_segmentation"][1].seg_enabled
    assert headers["aom_delta_q_lf"][1].delta_q_present and \
        headers["aom_delta_q_lf"][1].delta_lf_present
    assert headers["aom_chroma_delta_q"][1].dq_u_ac
    assert headers["pil_tiles"][1].tile_cols * headers["pil_tiles"][1].tile_rows == 4
    assert headers["pil_sb128"][0].use_128
    assert headers["pil_qm"][1].using_qmatrix
    assert headers["aom_intrabc_lossless"][1].allow_intrabc


# --- refusals -------------------------------------------------------------------

# frames that need a filter that was or is queued (av1_decode.PORTED says which)
REFUSED = {
    "loop restoration": lambda: _aom(ve.avif_content(np.random.default_rng(30), 64, 64, 3,
                                                     "smooth"), "420",
                                     {"cq-level": 30, "enable-cdef": 0,
                                      "loopfilter-control": 0, "enable-restoration": 1}),
    "superres": lambda: _aom(ve.avif_content(_rng("sr"), 48, 64, 3, "smooth"), "444",
                             {"cq-level": 30}, cfg_fields={76: 1, 80: 12, 84: 12}),
    "film grain": lambda: _aom(ve.avif_content(_rng("fg"), 48, 64, 3, "smooth"), "444",
                               {"cq-level": 30, "film-grain-test": 1, **NOF_AOM}),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_post_filter_frames_raise_unsupported(tmp_path, name):
    """A frame that needs a filter still queued (film grain) is refused by
    name in every mode, where cv2 reads it; the frames that need loop
    restoration or superres, refused until those filters were ported, read
    as cv2 reads them (their own cases: test_torch_av1_restoration.py)."""
    path = str(tmp_path / "image.tif")
    with open(path, "wb") as f:
        f.write(REFUSED[name]())
    assert all(cv2.imread(path, flag) is not None for flag in _CV.values())
    if name in PORTED:
        from kgtpu_torch.data import avif
        from kgtpu_torch.data.av1_obu import parse_frame, post_filters
        data = REFUSED[name]()
        assert name in post_filters(parse_frame(avif.parse(data)[0].obus)[1])
        assert check(tmp_path, data) == 3
        return
    for mode in MODES:
        with pytest.raises(UnsupportedImage, match=name) as e:
            read_image(path, mode)
        assert "image containers beyond PNG" in str(e.value)


def _patch(data: bytes, tag: bytes, at: int, value: bytes) -> bytes:
    i = data.index(tag) + at
    return data[:i] + value + data[i + len(value):]


@functools.lru_cache(maxsize=1)
def _damaged() -> dict:
    base = case("pil_20_q35_33x47")
    i = base.index(b"mdat")
    return {
        "hdlr_predefined": _patch(base, b"hdlr", 8, b"\x01"),
        "hdlr_version": _patch(base, b"hdlr", 4, b"\x01"),
        "ispe_missing": _patch(base, b"ispe", 0, b"ispf"),
        "colr_reserved": _patch(base, b"nclx", 10, bytes([base[base.index(b"nclx") + 10] | 1])),
        "pixi_depth": _patch(base, b"pixi", 10, b"\xf0"),
        "cut_mdat": base[:i + 20],
        "tile_byte": base[:len(base) - 3] + bytes([base[-3] ^ 0x55]) + base[-2:],
        "iinf_count": _patch(base, b"iinf", 8, b"\x00\x05"),
        "matrix_10": _patch(base, b"nclx", 8, b"\x0a"),
        "not_ftyp_first": base[base.index(b"meta") - 4:],
        "ipma_index": _patch(base, b"ipma", 13, b"\x7f"),
        "grid_past_head": _grid_in_mdat(),
        "ispe_size": _patch(base, b"ispe", 8, struct.pack(">I", 60)),
        "ipma_essential_index_0": _patch(base, b"ipma", 11, b"\x80"),
        "track_hdlr_predefined": _second(case("pil_sequence"), b"hdlr", 8, b"\x01"),
        "alpha_track_width": _alpha_track_width(case("pil_sequence_rgba")),
    }


def _second(data: bytes, tag: bytes, at: int, value: bytes) -> bytes:
    """`value` written `at` bytes after the second `tag` (a track's box)."""
    i = data.index(tag, data.index(tag) + 4) + at
    return data[:i] + value + data[i + len(value):]


def _alpha_track_width(data: bytes) -> bytes:
    """The alpha track's tkhd width (16.16, 88 bytes into a version 1
    tkhd's body) made 240: libavif sizes the alpha image from it, and it no
    longer matches the colour track's."""
    i = data.rindex(b"tkhd")
    assert data[i + 4] == 1
    return data[:i + 92] + struct.pack(">I", 240 << 16) + data[i + 96:]


def _grid_in_mdat() -> bytes:
    """A grid whose ImageGrid lies past the file's first 500 bytes: cv2's
    signature check (libavif parsing those bytes) fails, imread returns
    None."""
    return CASES["aom_grid"](in_idat=False)


DAMAGED_NONE = ("hdlr_predefined", "hdlr_version", "ispe_missing", "colr_reserved",
                "pixi_depth", "cut_mdat", "iinf_count", "matrix_10", "not_ftyp_first",
                "ipma_index", "ipma_essential_index_0", "track_hdlr_predefined",
                "alpha_track_width")


@pytest.mark.parametrize("name", sorted(DAMAGED_NONE))
def test_damaged_headers_refused_where_cv2_refuses(tmp_path, name):
    """Each of libavif's checks (or cv2's conversion) that the file fails:
    cv2 reads none of its modes, the port raises UnreadableImage."""
    assert check(tmp_path, _damaged()[name]) == 0


def _seq_level(data: bytes, level: int) -> bytes:
    """`data` (an item whose sequence header is reduced, as libavif writes a
    still image's) with seq_level_idx `level`: bits 5-9 of the header's
    payload, after the temporal delimiter and the OBU header and size."""
    from kgtpu_torch.data import avif
    obus = avif.parse(data)[0].obus
    i = data.index(obus) + obus.index(b"\x0a") + 2
    assert (data[i] >> 3) & 1, "not a reduced sequence header"
    v = (int.from_bytes(data[i:i + 2], "big") & ~(0x1f << 6)) | (level << 6)
    return data[:i] + v.to_bytes(2, "big") + data[i + 2:]


@pytest.mark.parametrize("level", range(32))
def test_sequence_levels_as_cv2(tmp_path, level):
    """libaom refuses a seq_level_idx not yet defined (2.2, 2.3, 3.2, 3.3,
    4.2, 4.3, 7.0 and up but 31): cv2 reads none of its modes and the port
    raises UnreadableImage; the defined ones read as cv2 reads them (a
    fault `tools/probe_avif.py --damage --sequences` found: the port read
    every level)."""
    from kgtpu_torch.data.av1_obu import LEVELS_UNDEFINED
    want = 0 if level in LEVELS_UNDEFINED else 3
    assert check(tmp_path, _seq_level(case("pil_20_q35_33x47"), level)) == want


def test_ispe_other_than_the_frame_is_queued(tmp_path):
    """libavif rescales a frame whose size differs from ispe (libyuv's
    ScalePlane): cv2 reads it, the port queues it by name."""
    path = str(tmp_path / "image.png")
    with open(path, "wb") as f:
        f.write(_damaged()["ispe_size"])
    assert cv2.imread(path, cv2.IMREAD_COLOR) is not None
    with pytest.raises(UnsupportedImage, match="ispe"):
        read_image(path, "color")


def test_intra_block_copy_reads_past_the_frame_width(tmp_path):
    """A fault `tools/probe_avif.py` found, kept as a file (PIL's
    screen-content writer, 255x292 grey, 4:2:0, quality 14): an intra
    block copy whose source runs
    past the frame's width (292) into the decoded columns up to MiCols * 4
    (296). libaom reads them from the frame being decoded, without border
    extension; the port clamped to the width (160 luma samples off)."""
    with open(os.path.join(ROOT, "assets_torch", "formats", "avif_faults",
                           "intrabc_past_the_width.avif"), "rb") as f:
        assert check(tmp_path, f.read()) == 3


# damaged image sequences that tools/probe_avif.py --damage --sequences found
# (one a damage of the same kind from a targeted run), each a box of the
# alpha track or the meta renamed or resized: name -> channels cv2 reads
# (0: imread returns None)
DAMAGED_SEQUENCES = {
    # the alpha track's mdhd grew over its hdlr and minf's header: its stbl
    # now lies in mdia, where libavif does not look, so it has no samples
    # and is no alpha track (the port took it as one)
    "sequence_alpha_stbl_outside_minf": 3,
    # no auxi: libavif takes the auxl track as alpha (the port wanted one)
    "sequence_alpha_auxi_renamed": 4,
    # no stsz: the alpha track's samples do not lay out, libavif fails
    # (the port dropped the track and read the colour)
    "sequence_alpha_stsz_renamed": 0,
    # no av01 entry: no alpha track (the port failed)
    "sequence_alpha_entry_renamed": 3,
    # no av1C: libavif reads av1C only for the colour track (the port failed)
    "sequence_alpha_av1c_renamed": 4,
    # an avis file decodes its tracks: a pixi depth of 4 in the meta's
    # properties fails nothing (the port failed at parse)
    "sequence_meta_pixi_depth_4": 4,
    # but a pixi depth above 16 fails the parse, whichever item it is on
    # (the port read the tracks)
    "sequence_meta_pixi_depth_206": 0,
}


@pytest.mark.parametrize("name", sorted(DAMAGED_SEQUENCES))
def test_damaged_sequences_read_like_cv2(tmp_path, name):
    """Each file in every mode as cv2 reads it, or UnreadableImage where it
    returns None; each failed on the port before libavif's track rules
    (`avif._parse_trak`, `_parse_moov`) were followed."""
    with open(os.path.join(ROOT, "assets_torch", "formats", "avif_faults", name + ".avif"),
              "rb") as f:
        data = f.read()
    path = str(tmp_path / "image.png")
    with open(path, "wb") as f:
        f.write(data)
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert (0 if want is None else want.shape[2]) == DAMAGED_SEQUENCES[name]
    assert check(tmp_path, data) == (3 if DAMAGED_SEQUENCES[name] else 0)


def test_damaged_tile_data_as_cv2(tmp_path):
    """A changed byte in the tile data: read as cv2 reads it, or refused
    where libaom marks the tile corrupt."""
    check(tmp_path, _damaged()["tile_byte"])


def test_random_damage_as_cv2(tmp_path):
    """30 files damaged anywhere (tools/probe_avif.damage): each mode as cv2,
    or UnsupportedImage for a post-filter frame."""
    from tools.probe_avif import damage
    rng = np.random.default_rng(20)
    n = 0
    while n < 30:
        data, _ = ve.avif_random(rng, 48)
        if data is None:
            continue
        n += 1
        try:
            check(tmp_path, damage(data, rng))
        except UnsupportedImage:
            pass


def test_a_cut_grid_payload_is_not_avif_to_cv2(tmp_path):
    assert check(tmp_path, _damaged()["grid_past_head"]) == 0


# --- the parts ------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _oracle():
    from tools.av1_oracle import LibaomOracle
    return LibaomOracle()


@pytest.mark.parametrize("kind,n", [("idct", n) for n in range(2, 7)] +
                         [("iadst", n) for n in range(2, 5)] +
                         [("iidentity", n) for n in range(2, 6)])
def test_1d_transforms_match_libaom_and_a_float_reference(kind, n):
    """Each 1-D inverse transform equals libaom's C transform on random
    inputs, and the float transform within 2 (the DCT: X0 cos(pi/4) +
    sum X_m cos((2k+1) m pi / 2N); identity: the scale)."""
    from kgtpu_torch.data import av1_transform as T
    fn = {"idct": T.idct, "iadst": T.iadst, "iidentity": T.iidentity}[kind]
    rng = np.random.default_rng(n * 7 + len(kind))
    size = 1 << n
    for trial in range(40):
        x = rng.integers(-2000, 2000, size)
        got = [int(v[0]) for v in fn([np.array([int(v)]) for v in x], n)]
        assert got == _oracle().tx1d(kind, [int(v) for v in x]), (kind, n, trial)
        k = np.arange(size)
        if kind == "idct":
            ref = sum(x[m] * (np.cos(np.pi / 4) if m == 0 else 1.0) *
                      np.cos((2 * k + 1) * m * np.pi / (2 * size)) for m in range(size))
        elif kind == "iidentity":
            ref = x * {2: 2 ** 0.5, 3: 2, 4: 2 * 2 ** 0.5, 5: 4}[n]
        else:
            # the ADST's basis (section 7.13.2.6-9): sin(pi (2k + 1)(2m + 1) / 4N) * sqrt(2)
            # for 8 and 16 points, sin(pi (k + 1)(2m + 1) / (2N + 1)) * (4/3) sqrt(2/..)
            # for 4; checked through libaom above, the float check for DCT / identity
            continue
        assert np.abs(np.array(got) - ref).max() <= 2 + abs(ref).max() * 1e-3


@pytest.mark.parametrize("w,h", [(4, 4), (8, 8), (16, 16), (32, 32), (64, 64), (4, 8), (8, 4),
                                 (8, 16), (16, 8), (16, 32), (32, 16), (32, 64), (64, 32),
                                 (4, 16), (16, 4), (8, 32), (32, 8), (16, 64), (64, 16)])
def test_2d_inverse_transforms_match_libaom(w, h):
    """The 2-D process (rectangular scaling, row shift, clamps, flips) of
    every TX size and each type it allows equals libaom's
    av1_inv_txfm2d_add_WxH_c added to a random prediction, at 8 and 10
    bits; the lossless WHT equals av1_highbd_iwht4x4_16_add_c."""
    from kgtpu_torch.data import av1_transform as T
    rng = np.random.default_rng(w * 100 + h)
    lw, lh = w.bit_length() - 1, h.bit_length() - 1
    types = [0] if max(w, h) == 64 else [0, 9] if max(w, h) == 32 else \
        list(range(16)) if max(w, h) <= 16 else [0]
    for tt in types:
        for bd in (8, 10):
            c = np.zeros((h, w), np.int64)
            ch, cw = min(h, 32), min(w, 32)
            c[:ch, :cw] = rng.integers(-400, 400, (ch, cw)) * (rng.random((ch, cw)) < 0.3)
            pred = rng.integers(0, 1 << bd, (h, w))
            want = _oracle().inv_txfm2d_add(c, pred, tt, bd)
            got = np.clip(pred + T.inverse_transform(c, tt, lw, lh, bd, False), 0,
                          (1 << bd) - 1)
            np.testing.assert_array_equal(got, want, err_msg=f"type {tt} bd {bd}")
    if (w, h) == (4, 4):
        c = rng.integers(-100, 100, (4, 4)) * 4
        pred = rng.integers(0, 256, (4, 4))
        np.testing.assert_array_equal(
            np.clip(pred + T.inverse_transform(c, 0, 2, 2, 8, True), 0, 255),
            _oracle().iwht4x4_add(c, pred, 8))


def test_symbol_decoder_reads_libaoms_encoder():
    """A known symbol stream: symbols of random CDFs (2-16 symbols) and
    bools, written by libaom's od_ec encoder with the CDFs adapted as
    libaom's update_cdf adapts them, read back by SymbolReader exactly; the
    stream's padding passes the trailing-bits check."""
    import ctypes

    from kgtpu_torch.data.av1_symbol import SymbolReader, icdf
    o = _oracle()
    enc = ctypes.create_string_buffer(512)
    o.fn("od_ec_enc_init", ctypes.c_void_p, ctypes.c_uint32)(ctypes.addressof(enc), 1 << 16)
    put = o.fn("od_ec_encode_cdf_q15", ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
               ctypes.c_int)
    put_bool = o.fn("od_ec_encode_bool_q15", ctypes.c_void_p, ctypes.c_int, ctypes.c_uint)
    rng = np.random.default_rng(3)

    def adapt(cdf, s):  # libaom's update_cdf on [icdf..., counter]
        n = len(cdf) - 1
        rate = 3 + (cdf[n] > 15) + (cdf[n] > 31) + min(int(np.log2(n)), 2)
        for i in range(n - 1):
            cdf[i] = cdf[i] + ((32768 - cdf[i]) >> rate) if i < s else cdf[i] - (cdf[i] >> rate)
        cdf[n] += cdf[n] < 32

    cdfs, symbols = [], []
    for _ in range(12):
        n = int(rng.integers(2, 17))
        cuts = np.sort(rng.choice(np.arange(1, 32768), n - 1, replace=False))
        cdfs.append(icdf([int(v) for v in cuts] + [32768, 0]))
    enc_cdfs = [c[:] for c in cdfs]
    for _ in range(3000):
        if rng.random() < 0.2:
            b = int(rng.integers(0, 2))
            put_bool(ctypes.addressof(enc), b, 16384)
            symbols.append(("b", b))
            continue
        k = int(rng.integers(0, len(cdfs)))
        n = len(enc_cdfs[k]) - 1
        s = int(rng.integers(0, n))
        arr = (ctypes.c_uint16 * (n + 1))(*enc_cdfs[k])
        put(ctypes.addressof(enc), s, ctypes.addressof(arr), n)
        adapt(enc_cdfs[k], s)
        symbols.append((k, s))
    nbytes = ctypes.c_uint32(0)
    done = ctypes.CFUNCTYPE(ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p)(
        o.base + o.lib.syms["od_ec_enc_done"][0][0])
    ptr = done(ctypes.addressof(enc), ctypes.addressof(nbytes))
    data = ctypes.string_at(ptr, nbytes.value)
    o.fn("od_ec_enc_clear", ctypes.c_void_p)(ctypes.addressof(enc))
    rd = SymbolReader(data, 0, len(data))
    for k, s in symbols:
        got = rd.bool() if k == "b" else rd.symbol(cdfs[k])
        assert got == s
    assert not rd.overflowed()


def test_tables_are_the_tools_output(tmp_path):
    """kgtpu_torch/data/av1_tables.py is what tools/extract_av1_tables.py
    writes from cv2's libaom and libavif today (its checks pass), and its
    CDFs are in the specification's form."""
    from kgtpu_torch.data import av1_tables
    from tools.extract_av1_tables import main
    out = str(tmp_path / "t.py")
    assert main(["--out", out]) == 0
    with open(out) as f, open(av1_tables.__file__) as g:
        assert f.read() == g.read()

    def leaves(x):
        if x and isinstance(x[0], int):
            yield x
        else:
            for v in x:
                yield from leaves(v)
    for group in (av1_tables.CDF_MODE, av1_tables.CDF_MV, av1_tables.CDF_COEF):
        for v in group.values():
            for cdf in leaves(v):
                assert cdf[-1] == 0 and cdf[-2] == 32768
                assert all(a < b for a, b in zip(cdf[:-2], cdf[1:-1]))
    assert len(av1_tables.AC_QLOOKUP) == 3 and all(len(t) == 256 for t in av1_tables.AC_QLOOKUP)
    assert len(av1_tables.QM_RAW) == 15 * 2 * 3344


# --- fixtures, readers and the serving CLI ---------------------------------------

def test_committed_avif_fixtures_decode_as_cv2_recorded():
    """assets_torch/formats/avif (16 kinds, in "unchanged") and the 4:2:0
    file of formats/avif_folder (512x512, in "color") equal cv2's decode
    recorded in kgtpu_reference_formats.npz (sha256, shape, dtype); every
    mode of every file is checked on the card ([18] of chip_smoke.py), the
    modes themselves by the cases above."""
    from tools.make_torch_format_assets import AVIF_KINDS, sha
    with np.load(os.path.join(ROOT, "assets_torch", "kgtpu_reference_formats.npz")) as ref:
        decodes = json.loads(str(ref["avif_decode_json"]))
        kinds = json.loads(str(ref["avif_kinds_json"]))
        folder = json.loads(str(ref["avif_folder_decode_json"]))
    assert sorted(kinds.values()) == sorted(k for k, _, _ in AVIF_KINDS)
    lossless = [p for p, k in json.loads(str(np.load(os.path.join(
        ROOT, "assets_torch", "kgtpu_reference_formats.npz"))["avif_folder_kinds_json"])).items()
        if k != "yuv420_q70"]
    for sub, table in (("avif", decodes), ("avif_folder", folder)):
        for d in table:
            if d["mode"] != ("unchanged" if sub == "avif" else "color") or d["path"] in lossless:
                continue
            got = read_image(os.path.join(ROOT, "assets_torch", "formats", sub, d["path"]),
                             d["mode"])
            assert (sha(got), list(got.shape), str(got.dtype)) == (d["sha256"], d["shape"],
                                                                   d["dtype"]), d


def test_folder_and_neural_cells_read_avif_like_kgtpu(tmp_path):
    """kgtpu's folder and neural_cells readers (cv2) and the port's over
    AVIF files under .png / .tif / .jpg names, sample by sample."""
    import warnings

    from kgtpu.data.folder import ImageFolder as JaxImageFolder
    from kgtpu.data.neural_cells import NeuralCells as JaxNeuralCells
    from kgtpu_torch.data.folder import ImageFolder
    from kgtpu_torch.data.neural_cells import NeuralCells
    from test_torch_datasets import assert_same_samples
    h, w = 40, 52
    rng = _rng("folder")
    a = ve.avif_content(rng, h, w, 3, "smooth")
    files = {"lossless.png": _cv2_lossless(a), "lossy.tif": ve.avif_pil(
        a, quality=60, advanced=NOF), "grey.jpg": _cv2_lossless(a[..., 1]),
        "deep.tiff": _cv2_lossless(_deep(a, 10), 10)}
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
        cid = f"cell_{n:02d}"
        with open(root / "images" / (cid + os.path.splitext(name)[1]), "wb") as f:
            f.write(data)
        lab = np.zeros((h, w), np.uint16)
        lab[5:15, 5:20], lab[20:35, 25:50] = 1, 2 + n
        cv2.imwrite(str(root / "labels" / f"{cid}.png"), lab)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for split in ("train", "val"):
            ours, theirs = NeuralCells(str(root), split), JaxNeuralCells(str(root), split)
            assert ours.paths == theirs.paths
            if len(theirs):
                assert_same_samples(ours, theirs)


def test_cli_decode_workers_serves_as_serial_reads(tmp_path):
    """cli.test --decode_workers 2 over a folder of AVIF files writes the
    detections and label maps the serial reads give."""
    from kgtpu_torch.cli import test as test_cli
    folder = tmp_path / "imgs"
    os.makedirs(folder)
    for k in range(2):
        img = ve.avif_content(_rng(f"cli{k}"), 64, 64, 3, "smooth")
        with open(folder / f"im{k}.png", "wb") as f:
            f.write(_cv2_lossless(img) if k % 2 else ve.avif_pil(img, quality=70,
                                                                 advanced=NOF))
    outs = []
    for workers in (0, 2):
        save = tmp_path / f"out{workers}"
        assert test_cli.main(["--dataset", "folder", "--data_dir", str(folder), "--weights",
                              os.path.join(ROOT, "assets_torch", "flagship_ema"),
                              "--use_ema", "--input_size", "64", "--batch_size", "2",
                              "--compute_dtype", "float32", "--device", "cpu",
                              "--decode_workers", str(workers), "--save_dir", str(save)]) == 0
        with open(save / "detections.json") as f:
            outs.append(json.load(f)["images"])
        outs[-1].append(sorted(
            (p, open(save / p, "rb").read()) for p in os.listdir(save) if p.endswith(".png")))
    assert outs[0] == outs[1]
