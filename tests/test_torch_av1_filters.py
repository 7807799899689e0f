"""The port's AV1 in-loop filters, deblocking (`kgtpu_torch/data/av1_deblock.py`)
and CDEF (`av1_cdef.py`), against cv2 5.0 (libavif 1.4.2 over libaom
3.14.1), which kgtpu's readers call, and against libaom's own C functions
(through `tools/av1_oracle.py`, ctypes, tests only).

Whole files: lossy AVIF whose frames need deblocking, or deblocking and
CDEF, written at test time from seeded numpy content (33-130 px, odd sides)
by cv2's writer, PIL's (libavif 1.3 over aom) and libaom's own encoder
(`variant_encoders.aom_encode`), named `.png` as kgtpu would meet them, read
in "color", "gray" and "unchanged".  Between them they reach 4:2:0, 4:2:2,
4:4:4 and monochrome, 8, 10 and 12 bits, alpha, sharpness above 0, delta
loop filter levels (without delta_lf_multi: no writer here sets it),
128x128 superblocks with two CDEF strengths, 2x2 tiles, levels 0 to 63,
and every wide (flat-edge) filter at every depth.

The parts: the 4-, 6-, 8- and 14-tap edge filters with their masks at 8,
10 and 12 bits against aom_[highbd_]lpf_*_c, the direction search against
cdef_find_dir_c, the block filter against cdef_filter_{8,16}_{0..3}_c, on
seeded random samples.  Tolerance: none (every value, dtype and shape).
"""

import functools

import cv2
import numpy as np
import pytest

from kgtpu_torch.data import av1_cdef, av1_deblock
from kgtpu_torch.data.imread import MODES, read_image
from tools import variant_encoders as ve

_CV = {"color": cv2.IMREAD_COLOR, "gray": cv2.IMREAD_GRAYSCALE,
       "unchanged": cv2.IMREAD_UNCHANGED}


def _rng(name: str):
    return np.random.default_rng(sum(map(ord, name)))


def _smooth(name, h, w, c=3):
    return ve.avif_content(_rng(name), h, w, c, "smooth")


def _screen(name, h, w):
    return ve.avif_content(_rng(name + "screen"), h, w, 3, "screen")


def _deep(img, depth):
    return (img.astype(np.uint16) << (depth - 8)) | (img.astype(np.uint16) >> (16 - depth))


def _cv2(img, q, depth=8) -> bytes:
    return cv2.imencode(".avif", img, [cv2.IMWRITE_AVIF_QUALITY, q,
                                       cv2.IMWRITE_AVIF_DEPTH, depth])[1].tobytes()


def _mixed(h, w, noise_w):
    img = ve.avif_content(np.random.default_rng(4), h, w, 3, "smooth")
    img[:, w - noise_w:] = ve.avif_content(np.random.default_rng(5), h, noise_w, 3, "noise")
    return img


def _aom_420(img, opts, usage) -> bytes:
    h, w = img.shape[:2]
    planes = [np.ascontiguousarray(img[..., 0])] + \
        [np.ascontiguousarray(img[::2, ::2, k]) for k in (1, 2)]
    return ve.avif_file(ve.aom_encode(planes, "420", opts, usage=usage), w, h, ssx=1, ssy=1,
                        profile=0, cicp=(1, 13, 6, 1))


def _aom_mono() -> bytes:
    y = _smooth("m4", 57, 45, 1)[..., 0]
    u = np.full((29, 23), 128, np.uint8)
    obus = ve.aom_encode([y, u, u], "420", {"cq-level": 58, "enable-restoration": 0},
                         cfg_fields={208: 1})  # aom_codec_enc_cfg_t.monochrome
    return ve.avif_file(obus, 45, 57, mono=True, ssx=1, ssy=1, profile=0)


# name: (writer, what its frame header must hold)
FILTERED = {
    "pil_420_q60": (lambda: ve.avif_pil(_smooth("d", 48, 56), quality=60),
                    {"filters": ["deblocking"], "planes": (1, 1, 3)}),
    "pil_default": (lambda: ve.avif_pil(_smooth("pd", 45, 61)),
                    {"filters": ["deblocking"], "planes": (1, 1, 3)}),
    "cv2_q90": (lambda: _cv2(_smooth("90", 37, 51), 90), {"filters": ["deblocking"]}),
    "cv2_q80": (lambda: _cv2(_smooth("80", 64, 64), 80), {"filters": ["deblocking", "CDEF"]}),
    "cv2_q20_noise": (lambda: _cv2(ve.avif_content(_rng("q"), 70, 90, 3, "noise"), 20),
                      {"filters": ["deblocking", "CDEF"]}),
    "pil_q5_screen": (lambda: ve.avif_pil(ve.avif_content(_rng("r"), 70, 90, 3, "screen"),
                                          quality=5), {"filters": ["deblocking"]}),
    "pil_422_cdef": (lambda: ve.avif_pil(_smooth("a", 37, 53), quality=60, subsampling="4:2:2",
                                         advanced=[("enable-cdef", "1")]),
                     {"filters": ["deblocking", "CDEF"], "planes": (1, 0, 3)}),
    "pil_444": (lambda: ve.avif_pil(_smooth("b", 41, 35), quality=50, subsampling="4:4:4"),
                {"filters": ["deblocking"], "planes": (0, 0, 3)}),
    "cv2_grey_q80": (lambda: _cv2(_smooth("l", 33, 47)[..., 0], 80),
                     {"filters": ["deblocking", "CDEF"], "planes": (1, 1, 1)}),
    "aom_mono": (_aom_mono, {"filters": ["deblocking"], "planes": (1, 1, 1), "sb128": True}),
    "cv2_10bit_q80": (lambda: _cv2(_deep(_smooth("i", 40, 46), 10), 80, 10),
                      {"filters": ["deblocking", "CDEF"], "depth": 10}),
    "cv2_12bit_q80": (lambda: _cv2(_deep(_smooth("j", 40, 46), 12), 80, 12),
                      {"filters": ["deblocking", "CDEF"], "depth": 12}),
    "cv2_rgba10_q70": (lambda: _cv2(_deep(_smooth("k", 34, 38, 4), 10), 70, 10),
                       {"filters": ["deblocking", "CDEF"], "depth": 10}),
    # libaom's flat (wide) filters at 10 and 12 bits: coarse screen content
    "cv2_10bit_q5_screen": (lambda: _cv2(_deep(_screen("a", 64, 64), 10), 5, 10),
                            {"filters": ["deblocking", "CDEF"], "depth": 10}),
    "cv2_12bit_q5_screen": (lambda: _cv2(_deep(_screen("a", 64, 64), 12), 5, 12),
                            {"filters": ["deblocking", "CDEF"], "depth": 12}),
    "pil_sharpness_3": (lambda: ve.avif_pil(_smooth("h", 48, 56), quality=40,
                                            advanced=[("sharpness", "3")]),
                        {"filters": ["deblocking"], "sharpness": True}),
    "aom_delta_lf": (lambda: _aom_420(_mixed(64, 96, 32), {
        "cq-level": 40, "deltaq-mode": 3, "delta-lf-mode": 1, "enable-restoration": 0,
        "cpu-used": 6}, usage=2), {"filters": ["deblocking"], "delta_lf": True}),
    "pil_sb128_cdef": (lambda: ve.avif_pil(ve.avif_content(np.random.default_rng(130), 130, 100,
                                                           3, "noise"), quality=30,
                                           advanced=[("sb-size", "128"), ("enable-cdef", "1")]),
                       {"filters": ["deblocking", "CDEF"], "sb128": True, "cdef_bits": True}),
    "pil_tiles_cdef": (lambda: ve.avif_pil(_smooth("g", 96, 128), quality=30, advanced=[
        ("tile-columns", "1"), ("tile-rows", "1"), ("enable-cdef", "1")]),
                       {"filters": ["deblocking", "CDEF"], "tiles": 4}),
}


@functools.lru_cache(maxsize=None)
def filtered(name: str) -> bytes:
    return FILTERED[name][0]()


@pytest.mark.parametrize("name", sorted(FILTERED))
def test_filtered_frames_read_like_cv2(tmp_path, name):
    """Each file reads in every mode as cv2 reads it: dtype, shape and
    every value."""
    path = str(tmp_path / "image.png")
    with open(path, "wb") as f:
        f.write(filtered(name))
    for mode in MODES:
        want = cv2.imread(path, _CV[mode])
        assert want is not None, mode
        if want.ndim == 3:
            want = want[..., [2, 1, 0, 3][:want.shape[2]]]
        got = read_image(path, mode)
        assert (got.dtype, got.shape) == (want.dtype, want.shape), mode
        np.testing.assert_array_equal(got, want, err_msg=mode)


def test_filtered_cases_reach_what_they_are_named_for():
    """Each writer's frame needs the filters it is listed with and holds the
    layout, depth, sharpness, delta loop filter levels (nonzero ones),
    superblock size, CDEF strengths and tiles it is named for."""
    from kgtpu_torch.data import av1_decode, avif
    from kgtpu_torch.data.av1_obu import parse_frame, post_filters
    for name, (_, want) in FILTERED.items():
        seq, fh, _ = parse_frame(avif.parse(filtered(name))[0].obus)
        assert post_filters(fh) == want["filters"], name
        assert (seq.ssx, seq.ssy, seq.num_planes) == want.get("planes", (1, 1, 3)), name
        assert seq.bit_depth == want.get("depth", 8), name
        assert fh.lf_sharpness > 0 or not want.get("sharpness"), name
        assert bool(fh.delta_lf_present) == want.get("delta_lf", False), name
        assert not fh.delta_lf_multi, name
        assert bool(seq.use_128) == want.get("sb128", False), name
        assert (fh.cdef_bits > 0) == want.get("cdef_bits", False), name
        assert fh.tile_cols * fh.tile_rows == want.get("tiles", 1), name
    seen = {}
    orig = av1_decode.deblock
    av1_decode.deblock = lambda fr: (seen.setdefault("lf", fr.delta_lfs.copy()), orig(fr))
    try:
        av1_decode.decode_av1(avif.parse(filtered("aom_delta_lf"))[0].obus)
    finally:
        av1_decode.deblock = orig
    assert np.unique(seen["lf"][..., 0]).size > 1


def test_whole_files_reach_every_wide_filter():
    """Between them the files take each of 7.14.6.4's wide filters (the
    6-tap chroma, 8-tap and 14-tap luma filters of flat edges) at 8, 10 and
    12 bits, as well as the narrow one."""
    from kgtpu_torch.data import av1_decode, avif
    taken = set()

    class Recording(dict):
        def __getitem__(self, key):
            taken.add(key + (depth,))
            return dict.__getitem__(self, key)
    wide = av1_deblock.WIDE
    av1_deblock.WIDE = Recording(wide)
    try:
        for name in ("pil_q5_screen", "cv2_10bit_q5_screen", "cv2_12bit_q5_screen"):
            depth = FILTERED[name][1].get("depth", 8)
            av1_decode.decode_av1(avif.parse(filtered(name))[0].obus)
    finally:
        av1_deblock.WIDE = wide
    assert taken == {k + (d,) for k in wide for d in (8, 10, 12)}


def test_committed_fixtures_need_their_filters():
    """The filtered kinds of assets_torch/formats/avif and avif_folder
    (`make_torch_format_assets.AVIF_FILTERS`, which chip_smoke.py [18]
    decodes on the card's host) need the filters they are listed with; the
    delta loop filter kind codes delta levels and the 128x128 one its
    superblocks.  Their pixels are held to cv2's recorded hashes by
    test_torch_avif.py."""
    import json
    import os

    from kgtpu_torch.data import avif
    from kgtpu_torch.data.av1_obu import parse_frame, post_filters
    from tools.make_torch_format_assets import AVIF_FILTERS
    root = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "assets_torch")
    with np.load(os.path.join(root, "kgtpu_reference_formats.npz")) as ref:
        kinds = {os.path.join("avif", f): k
                 for f, k in json.loads(str(ref["avif_kinds_json"])).items()}
        kinds.update({os.path.join("avif_folder", f): k for f, k in
                      json.loads(str(ref["avif_folder_kinds_json"])).items()})
    seen = set()
    for rel, kind in kinds.items():
        if kind not in AVIF_FILTERS:
            continue
        with open(os.path.join(root, "formats", rel), "rb") as f:
            seq, fh, _ = parse_frame(avif.parse(f.read())[0].obus)
        assert post_filters(fh) == AVIF_FILTERS[kind], rel
        assert bool(fh.delta_lf_present) == (kind == "aom_delta_lf"), rel
        assert seq.use_128 or kind != "pil_sb128_cdef", rel
        seen.add(kind)
    assert seen == set(AVIF_FILTERS)


# --- the parts against libaom's C -------------------------------------------------

@functools.lru_cache(maxsize=1)
def _oracle():
    from tools.av1_oracle import LibaomOracle
    return LibaomOracle()


# libaom's filter length -> the port's (filter size, luma)
TAPS = {4: (4, True), 6: (8, False), 8: (8, True), 14: (16, True)}


@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("taps", sorted(TAPS))
@pytest.mark.parametrize("edge", ["horizontal", "vertical"])
def test_edge_filters_match_libaom(bd, taps, edge):
    """av1_deblock.filter_samples equals aom_[highbd_]lpf_{edge}_{taps}_c on
    200 edges of 4 lines: random levels and sharpness (their limits by
    av1_deblock.limits), samples around a random value with a spread from
    flat to rough, so every mask and filter path is taken."""
    o = _oracle()
    rng = np.random.default_rng(bd * 100 + taps + (edge == "vertical"))
    size, luma = TAPS[taps]
    lines, want, lims = [], [], []
    for _ in range(200):
        lvl = np.array([int(rng.integers(1, 64))])
        limit, blimit, thresh = (int(v[0]) for v in av1_deblock.limits(
            lvl, int(rng.integers(0, 8))))
        base = int(rng.integers(0, 1 << bd))
        spread = int(rng.choice([1, 2, 4, 16, 64])) << (bd - 8)
        x = np.clip(base + rng.integers(-spread, spread + 1, (4, 16)), 0, (1 << bd) - 1)
        out = o.lpf(edge, taps, x, blimit, limit, thresh, bd)
        np.testing.assert_array_equal(out[:, [0, 15]], x[:, [0, 15]])
        lines.append(x[:, 1:15])
        want.append(out[:, 1:15])
        lims.append(np.repeat([[limit, blimit, thresh]], 4, 0))
    lims = np.concatenate(lims)
    got = av1_deblock.filter_samples(np.concatenate(lines), size, luma, lims[:, 0], lims[:, 1],
                                     lims[:, 2], bd)
    np.testing.assert_array_equal(got, np.concatenate(want))
    assert (got != np.concatenate(lines)).any(axis=1).mean() > 0.2


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_cdef_direction_matches_libaom(bd):
    """av1_cdef.find_direction equals cdef_find_dir_c (direction and
    variance) on 300 blocks, a third of them nearly flat."""
    o = _oracle()
    rng = np.random.default_rng(bd)
    top = 1 << bd
    blocks = rng.integers(0, top, (300, 8, 8))
    blocks[::3] = np.clip(blocks[::3, :1, :1] + rng.integers(-3, 4, (100, 8, 8)), 0, top - 1)
    d, v = av1_cdef.find_direction(blocks, bd)
    want = [o.cdef_find_dir(b, bd - 8) for b in blocks]
    assert [(int(a), int(b)) for a, b in zip(d, v)] == want


@pytest.mark.parametrize("variant", [0, 1, 2, 3])
@pytest.mark.parametrize("bd", [8, 10, 12])
def test_cdef_block_filter_matches_libaom(variant, bd):
    """av1_cdef.filter_blocks equals cdef_filter_8_{variant}_c (8 bits) or
    cdef_filter_16_{variant}_c (10, 12 bits): 0 with primary and secondary
    taps, 1 primary, 2 secondary, 3 neither (a copy), on 8x8, 4x4 and 4x8
    blocks with random strengths, directions and damping and some border
    samples not available (CDEF_VERY_LARGE there, UNAVAILABLE here)."""
    from tools.av1_oracle import CDEF_VERY_LARGE
    o = _oracle()
    rng = np.random.default_rng(variant * 10 + bd)
    shift, top = bd - 8, 1 << bd
    for w, h in ((8, 8), (4, 4), (4, 8)):
        for t in range(40):
            src = rng.integers(0, top, (h + 4, w + 4))
            if t % 2:
                src = np.clip(src[2, 2] + rng.integers(-20 << shift, 21 << shift, src.shape),
                              0, top - 1)
            gone = rng.random(src.shape) < 0.15
            gone[2:-2, 2:-2] = False
            pri = int(rng.integers(1, 16)) << shift if variant in (0, 1) else 0
            sec = int(rng.choice([1, 2, 4])) << shift if variant in (0, 2) else 0
            d = int(rng.integers(0, 8))
            damping = int(rng.integers(2, 7)) + shift
            theirs = np.where(gone, CDEF_VERY_LARGE, src)
            want = o.cdef_filter(variant, theirs, w, h, pri, sec, d, damping, shift, bd > 8)
            ours = np.where(gone, av1_cdef.UNAVAILABLE, src)
            got = av1_cdef.filter_blocks(ours, np.array([0]), np.array([0]), w, h,
                                         np.array([pri]), np.array([sec]), damping,
                                         np.array([d]), shift)[0]
            np.testing.assert_array_equal(got, want, err_msg=f"{w}x{h} trial {t}")


def _levels_by_the_spec(fh, seg: int, delta_lf: list, plane: int, pas: int) -> int:
    """Sections 7.14.4-5 for one block, written out as the specification
    writes them."""
    i = pas if plane == 0 else plane + 1
    d = delta_lf[i if fh.delta_lf_multi else 0]
    lvl = max(0, min(63, d + fh.lf_level[i]))
    if fh.seg_enabled and fh.feature_enabled[seg][1 + i]:
        lvl = max(0, min(63, lvl + fh.feature_data[seg][1 + i]))
    if fh.lf_delta_enabled:
        lvl = max(0, min(63, lvl + fh.lf_ref_deltas[0] * (1 << (lvl >> 5))))
    return lvl


@pytest.mark.parametrize("multi", [0, 1])
def test_filter_levels_follow_the_specification(multi):
    """av1_deblock.levels over a frame of random segments, delta loop filter
    levels and segment features (alternate levels 1-4), with and without
    delta_lf_multi (which no writer here sets), equals 7.14.4-5 per block."""
    from types import SimpleNamespace
    rng = np.random.default_rng(multi)
    fh = SimpleNamespace(
        lf_level=[int(v) for v in rng.integers(0, 64, 4)], delta_lf_present=1,
        delta_lf_multi=multi, seg_enabled=1, lf_delta_enabled=1,
        lf_ref_deltas=[int(rng.integers(-63, 64))] + [0] * 7,
        feature_enabled=[[int(v) for v in rng.integers(0, 2, 8)] for _ in range(8)],
        feature_data=[[int(v) for v in rng.integers(-63, 64, 8)] for _ in range(8)])
    fr = SimpleNamespace(fh=fh, seg_ids=rng.integers(0, 8, (6, 10)).astype(np.int8),
                         delta_lfs=rng.integers(-63, 64, (6, 10, 4)).astype(np.int8))
    for plane in range(3):
        for pas in range(2):
            got = av1_deblock.levels(fr, plane, pas)
            want = [[_levels_by_the_spec(fh, int(fr.seg_ids[r, c]),
                                         [int(v) for v in fr.delta_lfs[r, c]], plane, pas)
                     for c in range(10)] for r in range(6)]
            np.testing.assert_array_equal(got, want)
