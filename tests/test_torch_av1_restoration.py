"""The port's AV1 loop restoration (`kgtpu_torch/data/av1_restoration.py`) and
superres (`av1_superres.py`), with the restoration units the tiles read
(`av1_block.TileDecoder.read_lr`), against cv2 5.0 (libavif 1.4.2 over
libaom 3.14.1), which kgtpu's readers call, and against libaom's own C
functions (through `tools/av1_oracle.py`, ctypes, tests only).

Whole files: AVIF whose frames need loop restoration, superres or both,
written at test time from seeded numpy content (40-256 px, odd sides) by
libaom's own encoder (`variant_encoders.aom_encode`: its good-quality
usage, aomenc's default, at 8, 10 and 12 bits, superres at a fixed
denominator),
named `.png` as kgtpu would meet them, read in "color", "gray" and
"unchanged".  Between them they reach 4:2:0, 4:2:2 and 4:4:4, luma-only and
chroma restoration, Wiener, self-guided and unrestored units, switchable
planes, restoration units of 64, 128 and 256 samples, 128x128 superblocks, 2x2 tiles, odd
sizes, and the superres denominators 9, 12, 13 and 16 with and without
restoration (with deblocking and CDEF on), a downscaled width that libaom
keeps at 16 and a frame too narrow to downscale.  No encoder here halves a 4:2:0
chroma unit (lr_uv_shift): `variant_encoders.av1_lr_unit_rewrite` sets it
in the header of a frame small enough to keep one unit per plane; nor
does one write a switchable plane: `av1_lr_switchable_rewrite` codes a
frame's tile again with its Wiener / self-guided planes made switchable
(cv2 decodes it to the original's pixels).

The parts: the Wiener filter against av1_[highbd_]wiener_convolve_add_src_c,
the self-guided filter over all 16 parameter sets against
av1_apply_selfguided_restoration_c, the upscaler against
av1_[highbd_]convolve_horiz_rs_c and av1_upscale_normative_rows (tile
columns, chroma), at 8, 10 and 12 bits on seeded random samples; and the
unit and stripe geometry of a whole plane (units of 32 to 256 samples,
4:2:0 and 4:4:4, every unit type) against the specification's per-4x4
process (7.17's loop_restore_block and get_source_sample) run with libaom's
C filters.  Tolerance: none (every value, dtype and shape).
"""

import collections
import functools
import types

import cv2
import numpy as np
import pytest

from kgtpu_torch.data import av1_block, av1_restoration, av1_superres, avif
from kgtpu_torch.data.av1_obu import (RESTORE_NONE, RESTORE_SGRPROJ, RESTORE_SWITCHABLE,
                                      RESTORE_WIENER, parse_frame, post_filters)
from kgtpu_torch.data.imread import MODES, UnreadableImage, read_image
from tools import variant_encoders as ve

_CV = {"color": cv2.IMREAD_COLOR, "gray": cv2.IMREAD_GRAYSCALE,
       "unchanged": cv2.IMREAD_UNCHANGED}


def _aom(seed: int, h: int, w: int, fmt: str, opts: dict, denom: int = 0, bd: int = 8,
         style: str = "smooth", lr_units=None, switchable: bool = False) -> bytes:
    """libaom's good-quality encode (aomenc's default usage) of seeded
    content ("mixed": smooth left, noise right); `denom` a fixed superres
    denominator; `lr_units` (lr_unit_shift, lr_uv_shift) rewritten into
    the header after encoding, or (`switchable`) the restoring planes made
    switchable and the tile coded again."""
    rng = np.random.default_rng(seed)
    if style == "mixed":
        img = ve.avif_content(rng, h, w, 3, "smooth")
        img[:, w // 2:] = ve.avif_content(rng, h, w - w // 2, 3, "noise")
    else:
        img = ve.avif_content(rng, h, w, 3, style)
    img = img.astype(np.uint16 if bd > 8 else np.uint8) << (bd - 8)
    ssx, ssy = int(fmt != "444"), int(fmt == "420")
    planes = [np.ascontiguousarray(img[..., 0])] + \
        [np.ascontiguousarray(img[::1 + ssy, ::1 + ssx, k]) for k in (1, 2)]
    cfg = {76: 1, 80: denom, 84: denom} if denom else None  # rc_superres_mode FIXED
    obus = ve.aom_encode(planes, fmt, opts, usage=0, cfg_fields=cfg, bit_depth=bd)
    if lr_units:
        obus = ve.av1_lr_unit_rewrite(obus, *lr_units)
    if switchable:
        obus = ve.av1_lr_switchable_rewrite(obus)
    profile = 2 if bd == 12 or fmt == "422" else int(fmt == "444")
    return ve.avif_file(obus, w, h, depth=bd, ssx=ssx, ssy=ssy, profile=profile,
                        cicp=(1, 13, 6, 1))


def _small(lr_units):
    return _aom(3, 75, 93, "420", {"cq-level": 20, "cpu-used": 4}, lr_units=lr_units)


SMALL = {"filters": ["deblocking", "CDEF", "loop restoration"], "lr": [0, 0, 1], "use_128": 0}
# name: (writer, what its frame header must hold: post_filters, lr_type per
# plane (0 none, 1 Wiener, 2 self-guided, 3 switchable), unit sizes, ...)
FILES = {
    "good_420": (lambda: _aom(0, 121, 135, "420", {"cq-level": 25, "cpu-used": 0},
                              style="mixed"),
                 {"filters": ["deblocking", "CDEF", "loop restoration"], "lr": [2, 0, 2],
                  "sizes": [256] * 3}),
    "good_444": (lambda: _aom(1, 100, 118, "444", {"cq-level": 20, "cpu-used": 4}),
                 {"filters": ["loop restoration"], "lr": [1, 0, 1], "sizes": [128] * 3}),
    "good_422": (lambda: _aom(3, 70, 97, "422", {"cq-level": 20, "cpu-used": 4}),
                 {"filters": ["CDEF", "loop restoration"], "lr": [0, 0, 1]}),
    "good_sb128": (lambda: _aom(31, 64, 60, "420", {"cq-level": 20, "cpu-used": 4,
                                                    "sb-size": 128}),
                   {"filters": ["CDEF", "loop restoration"], "lr": [0, 1, 0], "use_128": 1,
                    "sizes": [128] * 3}),
    "good_tiles_2x2": (lambda: _aom(0, 72, 200, "420", {"cq-level": 20, "cpu-used": 4,
                                                        "tile-columns": 1, "tile-rows": 1}),
                       {"filters": ["CDEF", "loop restoration"], "lr": [1, 2, 0], "tiles": 4}),
    "good_odd_63x87": (lambda: _aom(1, 63, 87, "420", {"cq-level": 25, "cpu-used": 0},
                                    style="mixed"),
                       {"filters": ["deblocking", "CDEF", "loop restoration"], "lr": [2, 0, 0]}),
    "good_units_64_none": (lambda: _aom(0, 192, 256, "420", {"cq-level": 30, "cpu-used": 1},
                                        style="mixed"),
                           {"filters": ["CDEF", "loop restoration"], "lr": [0, 1, 1],
                            "sizes": [64] * 3}),
    # libaom writes no switchable frame: these are two of its frames with the
    # restoring planes made switchable and their tiles coded again
    "switchable_wiener_none": (lambda: _aom(0, 192, 256, "420", {"cq-level": 30,
                                                                 "cpu-used": 1},
                                            style="mixed", switchable=True),
                               {"filters": ["CDEF", "loop restoration"], "lr": [0, 3, 3],
                                "sizes": [64] * 3}),
    "switchable_self_guided": (lambda: _aom(0, 121, 135, "420", {"cq-level": 25,
                                                                 "cpu-used": 0},
                                            style="mixed", switchable=True),
                               {"filters": ["deblocking", "CDEF", "loop restoration"],
                                "lr": [3, 0, 3]}),
    "good_10bit": (lambda: _aom(0, 64, 90, "420", {"cq-level": 25, "cpu-used": 0}, bd=10,
                                style="mixed"),
                   {"filters": ["deblocking", "CDEF", "loop restoration"], "lr": [2, 2, 0],
                    "depth": 10}),
    "good_12bit_444": (lambda: _aom(26, 46, 52, "444", {"cq-level": 20, "cpu-used": 4}, bd=12),
                       {"filters": ["CDEF", "loop restoration"], "lr": [1, 1, 0],
                        "depth": 12}),
    "superres_9": (lambda: _aom(8, 48, 64, "420", {"cq-level": 20, "cpu-used": 4,
                                                   "enable-restoration": 0}, denom=9,
                                style="noise"),
                   {"filters": ["deblocking", "CDEF", "superres"], "denom": 9}),
    "superres_12_lr": (lambda: _aom(0, 51, 63, "420", {"cq-level": 40, "cpu-used": 1},
                                    denom=12, style="mixed"),
                       {"filters": ["deblocking", "CDEF", "loop restoration", "superres"],
                        "lr": [1, 1, 1], "denom": 12}),
    "superres_13": (lambda: _aom(1, 45, 57, "420", {"cq-level": 40, "cpu-used": 1,
                                                    "enable-restoration": 0}, denom=13,
                                 style="mixed"),
                    {"filters": ["deblocking", "CDEF", "superres"], "denom": 13}),
    "superres_16_lr_444": (lambda: _aom(0, 40, 62, "444", {"cq-level": 20, "cpu-used": 4},
                                        denom=16),
                           {"filters": ["loop restoration", "superres"], "lr": [1, 1, 1],
                            "denom": 16}),
    # libaom keeps FrameWidth at least 16 (or the upscaled width below 16,
    # which then is not upscaled at all)
    "superres_16_to_16_of_23": (lambda: _aom(3, 60, 23, "420", {"cq-level": 20, "cpu-used": 4},
                                             denom=16),
                                {"filters": ["CDEF", "loop restoration", "superres"],
                                 "lr": [1, 0, 1], "denom": 16, "width": 16}),
    "superres_11_unscaled_15": (lambda: _aom(3, 40, 15, "420", {"cq-level": 20, "cpu-used": 4},
                                             denom=11),
                                {"filters": [], "width": 15, "superres_bit": 1}),
    # a small file's header rewritten (one unit per plane at every size)
    "unit_64_uv_32": (lambda: _small((0, 1)), dict(SMALL, sizes=[64, 32, 32])),
    "unit_128_uv_64": (lambda: _small((1, 1)), dict(SMALL, sizes=[128, 64, 64])),
    "unit_256_uv_128": (lambda: _small((2, 1)), dict(SMALL, sizes=[256, 128, 128])),
}


@functools.lru_cache(maxsize=None)
def _file(name: str) -> bytes:
    return FILES[name][0]()


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
        assert got.dtype == want.dtype and got.shape == want.shape, (mode, got.shape, want.shape)
        assert np.array_equal(got, want), (mode, np.argwhere(got != want)[:5].tolist())
        read += 1
    return read


@pytest.mark.parametrize("name", sorted(FILES))
def test_restored_and_upscaled_files_read_as_cv2(tmp_path, name):
    """Each file's frame needs what its name says, and the port reads it as
    cv2 does in all three modes."""
    data = _file(name)
    seq, fh, _ = parse_frame(avif.parse(data)[0].obus)
    want = FILES[name][1]
    assert post_filters(fh) == want["filters"]
    assert fh.lr_type[:seq.num_planes] == want.get("lr", [0, 0, 0])
    assert fh.lr_unit_size == want.get("sizes", fh.lr_unit_size)
    assert fh.superres_denom == want.get("denom", 8)
    assert seq.bit_depth == want.get("depth", 8)
    assert seq.use_128 == want.get("use_128", seq.use_128)
    assert fh.tile_cols * fh.tile_rows == want.get("tiles", 1)
    assert fh.width == want.get("width", fh.width)
    assert fh.use_superres == want.get("superres_bit", fh.use_superres)
    assert check(tmp_path, data) == 3


def test_files_reach_each_unit_type():
    """The files' restoration units, as the tiles read them: Wiener and
    self-guided units in luma and chroma, unrestored units beside restored
    ones (chroma), each of the three in a switchable plane, and self-guided
    sets that run both radii, radius 2 only and radius 1 only."""
    seen = collections.Counter()
    orig = av1_block.TileDecoder.read_lr_unit

    def counting(self, p, ur, uc):
        orig(self, p, ur, uc)
        kind = int(self.fr.lr_types[p][ur, uc])
        seen[(p > 0, kind)] += 1
        if self.fh.lr_type[p] == RESTORE_SWITCHABLE:
            seen[("switchable", kind)] += 1
        if kind == RESTORE_SGRPROJ:
            r0, r1 = av1_restoration.SGR_PARAMS[int(self.fr.lr_sgr_set[p][ur, uc])][:2]
            seen[("radii", bool(r0), bool(r1))] += 1
    av1_block.TileDecoder.read_lr_unit = counting
    try:
        from kgtpu_torch.data.av1_decode import decode_av1
        for name in FILES:
            decode_av1(avif.parse(_file(name))[0].obus)
    finally:
        av1_block.TileDecoder.read_lr_unit = orig
    for key in ((False, RESTORE_WIENER), (True, RESTORE_WIENER), (False, RESTORE_SGRPROJ),
                (True, RESTORE_SGRPROJ), (True, RESTORE_NONE), ("radii", True, True),
                ("radii", True, False), ("radii", False, True), ("switchable", RESTORE_NONE),
                ("switchable", RESTORE_WIENER), ("switchable", RESTORE_SGRPROJ)):
        assert seen[key], (key, dict(seen))


# --- the parts against libaom's C -------------------------------------------------

@functools.lru_cache(maxsize=1)
def _oracle():
    from tools.av1_oracle import LibaomOracle
    return LibaomOracle()


def _samples(rng, shape, bd: int, flat: bool) -> np.ndarray:
    """Random samples, or (`flat`) samples a few steps around one value,
    where the self-guided filter's variance term runs near 0."""
    if flat:
        base = int(rng.integers(0, 1 << bd))
        return np.clip(base + rng.integers(-3, 4, shape), 0, (1 << bd) - 1)
    return rng.integers(0, 1 << bd, shape)


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_wiener_matches_libaom(bd):
    rng = np.random.default_rng(bd)
    o = _oracle()
    for k in range(40):
        h, w = (int(v) for v in rng.integers(1, 65, 2))
        src = _samples(rng, (h + 6, w + 6), bd, k % 4 == 0)
        hf, vf = ([int(rng.integers(lo, hi + 1)) for lo, hi in zip(av1_block.WIENER_TAPS_MIN,
                                                                    av1_block.WIENER_TAPS_MAX)]
                  for _ in range(2))
        if k % 5 == 0:  # the extremes of the coded ranges
            hf, vf = list(av1_block.WIENER_TAPS_MAX), list(av1_block.WIENER_TAPS_MIN)
        got = av1_restoration.wiener(src, av1_restoration.wiener_taps(hf),
                                     av1_restoration.wiener_taps(vf), bd)
        assert np.array_equal(got, o.wiener(src, hf, vf, bd)), (k, h, w, hf, vf)


@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("sgr_set", range(16))
def test_self_guided_matches_libaom(bd, sgr_set):
    rng = np.random.default_rng(100 * bd + sgr_set)
    o = _oracle()
    for k in range(6):
        h, w = (int(v) for v in rng.integers(1, 65, 2))
        src = _samples(rng, (h + 6, w + 6), bd, k % 3 == 0)
        xqd = [int(rng.integers(lo, hi + 1)) for lo, hi in zip(av1_block.SGRPROJ_XQD_MIN,
                                                                av1_block.SGRPROJ_XQD_MAX)]
        got = av1_restoration.self_guided(src, sgr_set, xqd, bd)
        assert np.array_equal(got, o.selfguided(src, sgr_set, xqd, bd)), (k, h, w, xqd)


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_upscaler_matches_libaom(bd):
    """A row through av1_convolve_horiz_rs_c (one tile column, edges padded
    as libaom pads them), and whole plane rows through
    av1_upscale_normative_rows with up to four tile columns, in luma and
    4:2:0 / 4:4:4 chroma, at every denominator."""
    rng = np.random.default_rng(bd)
    o = _oracle()
    for denom in range(9, 17):
        down = int(rng.integers(2, 200))
        up = (down * denom + 4) // 8
        rows = rng.integers(0, 1 << bd, (3, down))
        x0, step = av1_superres.steps(down, up)
        got = av1_superres.upscale_rows(rows, down, up, down - 1, bd)
        assert np.array_equal(got, o.convolve_horiz_rs(rows, up, x0, step, bd)), (denom, down)
        for plane, ssx in ((0, 0), (1, 1), (2, 0)):
            upscaled = int(rng.integers(24, 400))
            width = (upscaled * 8 + denom // 2) // denom
            mi_cols = 2 * ((width + 7) >> 3)
            sbs = (mi_cols + 15) >> 4
            cuts = sorted(rng.choice(np.arange(1, sbs), min(3, sbs - 1), replace=False).tolist()) \
                if sbs > 1 else []
            s = ssx if plane else 0
            rows = rng.integers(0, 1 << bd, (2, (mi_cols * 4) >> s))
            want = o.upscale_rows(rows, width, upscaled, denom, mi_cols, [0] + cuts + [sbs], 4,
                                  plane, ssx, bd)
            got = av1_superres.upscale_rows(rows, (width + s) >> s, (upscaled + s) >> s,
                                            ((mi_cols * 4) >> s) - 1, bd)
            assert np.array_equal(got, want), (denom, plane, ssx, width, upscaled, cuts)


def _spec_restore(fr, p: int, cdef: np.ndarray, deblocked: np.ndarray) -> np.ndarray:
    """7.17 as the specification writes it: every 4x4 of luma in turn
    (loop_restore_block), its unit, stripe and samples (get_source_sample)
    found one by one, filtered by libaom's C."""
    o = _oracle()
    fh = fr.fh
    sx, sy = (fr.ssx, fr.ssy) if p else (0, 0)
    plane_h, plane_w = cdef.shape
    size = fh.lr_unit_size[p]
    rows, cols = fr.lr_types[p].shape
    out = cdef.copy()
    for row in range((fh.height + 3) // 4):
        for col in range((fh.upscaled_width + 3) // 4):
            stripe = (row * 4 + 8) // 64
            start = (-8 + stripe * 64) >> sy
            end = start + (64 >> sy) - 1
            ur = min(rows - 1, ((row * 4 + 8) >> sy) // size)
            uc = min(cols - 1, ((col * 4) >> sx) // size)
            x, y = (col * 4) >> sx, (row * 4) >> sy
            w, h = min(4 >> sx, plane_w - x), min(4 >> sy, plane_h - y)

            def sample(xx, yy):
                xx, yy = min(max(xx, 0), plane_w - 1), min(max(yy, 0), plane_h - 1)
                if yy < start:
                    return deblocked[max(start - 2, yy), xx]
                if yy > end:
                    return deblocked[min(end + 2, yy), xx]
                return cdef[yy, xx]
            src = np.array([[sample(x + j, y + i) for j in range(-3, w + 3)]
                            for i in range(-3, h + 3)])
            kind = fr.lr_types[p][ur, uc]
            if kind == RESTORE_WIENER:
                vf, hf = fr.lr_wiener[p][ur, uc]
                out[y:y + h, x:x + w] = o.wiener(src, hf, vf, fr.bit_depth)
            elif kind == RESTORE_SGRPROJ:
                out[y:y + h, x:x + w] = o.selfguided(src, int(fr.lr_sgr_set[p][ur, uc]),
                                                     fr.lr_sgr_xqd[p][ur, uc], fr.bit_depth)
    return out


@pytest.mark.parametrize("layout,bd,height,width,size", [
    ("420", 8, 46, 34, 64), ("420", 10, 130, 78, 64), ("444", 12, 75, 41, 64),
    ("420", 8, 150, 66, 128), ("444", 8, 140, 66, 64)])
def test_plane_geometry_matches_the_specification(layout, bd, height, width, size):
    """Random units (every type, all 16 sets, coded-range taps) on random
    CDEF and deblocked planes, luma units of `size` (chroma's halved under
    4:2:0, as lr_uv_shift allows): the port's stripes equal the
    specification's per-4x4 process with libaom's filters, in luma and
    chroma; the stripe edges, the first stripe's 56 rows, the frame's top
    and bottom and the last unit taking the rest of the plane are all met."""
    rng = np.random.default_rng(height * width + bd)
    ss = 1 if layout == "420" else 0
    fh = types.SimpleNamespace(height=height, upscaled_width=width,
                               lr_unit_size=[size, size >> ss, size >> ss] if ss else [size] * 3,
                               lr_type=[3, 3, 3])
    fr = types.SimpleNamespace(fh=fh, ssx=ss, ssy=ss, bit_depth=bd, lr_types=[], lr_wiener=[],
                               lr_sgr_set=[], lr_sgr_xqd=[])
    for p in range(3):
        s = ss if p else 0
        shape = (av1_restoration.unit_count(fh.lr_unit_size[p], (height + s) >> s),
                 av1_restoration.unit_count(fh.lr_unit_size[p], (width + s) >> s))
        fr.lr_types.append(rng.integers(0, 3, shape))
        fr.lr_wiener.append(np.stack([rng.integers(lo, hi + 1, shape + (2,)) for lo, hi in zip(
            av1_block.WIENER_TAPS_MIN, av1_block.WIENER_TAPS_MAX)], -1))
        if p:
            fr.lr_wiener[p][..., 0] = 0
        fr.lr_sgr_set.append(rng.integers(0, 16, shape))
        fr.lr_sgr_xqd.append(np.stack([rng.integers(lo, hi + 1, shape) for lo, hi in zip(
            av1_block.SGRPROJ_XQD_MIN, av1_block.SGRPROJ_XQD_MAX)], -1))
    for p in range(3):
        s = ss if p else 0
        plane = ((height + s) >> s, (width + s) >> s)
        cdef = _samples(rng, plane, bd, False)
        deblocked = np.clip(cdef + rng.integers(-40, 41, plane), 0, (1 << bd) - 1)
        got = av1_restoration.restore_plane(fr, p, cdef, deblocked)
        want = _spec_restore(fr, p, cdef, deblocked)
        assert np.array_equal(got, want), (p, np.argwhere(got != want)[:5].tolist())


def test_unit_count_and_frame_without_restoration():
    """count_units_in_frame rounds to the nearest unit count, at least 1;
    a plane that does not restore passes its CDEF samples through."""
    assert [av1_restoration.unit_count(64, n) for n in (1, 63, 95, 96, 159, 160)] == \
        [1, 1, 1, 2, 2, 3]
    fh = types.SimpleNamespace(height=5, upscaled_width=7, lr_type=[RESTORE_NONE] * 3)
    fr = types.SimpleNamespace(fh=fh, ssx=1, ssy=1)
    planes = [np.arange(80).reshape(8, 10)] * 3
    out = av1_restoration.restore(fr, planes, planes)
    assert [o.shape for o in out] == [(5, 7), (3, 4), (3, 4)]
    assert np.array_equal(out[0], planes[0][:5, :7])
