"""The port's JPEG 2000 HT code-blocks (Part 15, `data/j2k_ht.py`) and Part 2
multi-component markers (`data/j2k_part2.py`) against cv2 5.0 (OpenJPEG
2.5.3), which kgtpu's readers call.

OpenJPEG cannot write HT, so the files come from the test writer
`tools/variant_encoders.jpeg2000_ht` (`tools/j2k_ht_writer.py`), which
shares the port's VLC tables and tier-2 geometry: every comparison is with
cv2's decode, never with the writer's input.  Where the writer is lossless,
cv2's decode equals the input too, which checks the writer.  Covered: each
writer kind (RGB and grey lossless, 9/7, 16-bit grey, RGBA in a JP2, tiles
with precincts, code-blocks of 4x4 to 64x64, odd sizes, the cleanup pass
alone and with SigProp and MagRef, two quality layers, VSC and the other
style bits), more than one HT set and HT|mixed (both refused by cv2), each
malformed code-block OpenJPEG checks for, seeded random damage in the
code-block data, random files, the VLC tables' own checks, each Part 2
marker case (MCT / MCC / MCO offsets, resets, ignored and refused forms,
CBD), and the committed fixtures `chip_smoke.py` [17](d) decodes.

Files are written in tmp_path under a .png name (cv2 picks the decoder by
content) and held against cv2.imread in the three read modes.  Where cv2
returns None the port must raise `UnreadableImage` (a FileNotFoundError).

Tolerance: none.  Every comparison is exact (dtype, shape and every value).
"""

import json
import os
import struct

import cv2
import numpy as np
import pytest

from kgtpu_torch.data.imread import MODES, UnreadableImage, read_image
from tools import j2k_ht_writer as hw
from tools import variant_encoders as ve

_CV = {"color": cv2.IMREAD_COLOR, "gray": cv2.IMREAD_GRAYSCALE,
       "unchanged": cv2.IMREAD_UNCHANGED}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def check(path, mode):
    """The port's read of `path` equals cv2's (RGB order), or both refuse."""
    want = cv2.imread(path, _CV[mode])
    if want is None:
        with pytest.raises(UnreadableImage):
            read_image(path, mode)
        return None
    if want.ndim == 3:
        want = want[..., [2, 1, 0, 3][:want.shape[2]]]
    got = read_image(path, mode)
    assert (got.dtype, got.shape) == (want.dtype, want.shape), (path, mode)
    np.testing.assert_array_equal(got, want, err_msg=f"{path} {mode}")
    return want


def read_all(tmp_path, data: bytes) -> dict:
    """`check` in every mode: cv2's decode of each (None where it refuses)."""
    path = str(tmp_path / "image.png")
    with open(path, "wb") as f:
        f.write(data)
    return {mode: check(path, mode) for mode in MODES}


def smooth(h, w, c=3, seed=0):
    """Gradients and sines with a noisy band."""
    y, x = np.mgrid[:h, :w]
    a = np.stack([(x * 5 + y * 3) % 256, (x * y) % 256, 128 + 100 * np.sin(x / 5 + y / 7),
                  (x * 11 + 40) % 256], -1).astype(np.uint8)[..., :c]
    a[h // 3:h // 2] = np.random.default_rng(seed).integers(0, 256, a[h // 3:h // 2].shape)
    return a[..., 0] if c == 1 else a


def noise(h, w, c=3, seed=1):
    a = np.random.default_rng(seed).integers(0, 256, (h, w, c)).astype(np.uint8)
    return a[..., 0] if c == 1 else a


def grey16(h, w):
    return (smooth(h, w, 1).astype(np.uint16) * 257
            + np.random.default_rng(2).integers(0, 200, (h, w))).astype(np.uint16)


# kind -> (pixels, writer keywords, lossless)
KINDS = {
    "rgb_lossless": (lambda: smooth(40, 56), {}, True),
    "grey_lossless": (lambda: smooth(37, 29, 1), dict(cblk=(16, 16)), True),
    "irreversible_97": (lambda: smooth(40, 56), dict(irreversible=True, step=2.0), False),
    "grey16": (lambda: grey16(33, 45), {}, True),
    "grey16_97": (lambda: grey16(33, 45), dict(irreversible=True, step=16.0), False),
    "rgba_jp2": (lambda: smooth(30, 34, 4), dict(jp2=True), True),
    "grey_jp2": (lambda: smooth(21, 26, 1), dict(jp2=True), True),
    "tiles_precincts": (lambda: smooth(40, 56), dict(tiles=(16, 24), precincts=[(4, 4), (4, 4),
                                                                               (5, 5), (5, 5)],
                                                     cblk=(8, 8)), True),
    "rpcl_precincts": (lambda: noise(35, 43), dict(order="RPCL", cblk=(4, 4),
                                                   precincts=[(3, 3), (3, 3), (4, 4), (4, 4)]),
                       True),
    "cblk4x4": (lambda: smooth(40, 56), dict(cblk=(4, 4)), True),
    "cblk16x8": (lambda: noise(35, 43), dict(cblk=(16, 8)), True),
    "cblk32x32": (lambda: smooth(40, 56), dict(cblk=(32, 32)), True),
    "cblk64x64": (lambda: noise(70, 66), dict(cblk=(64, 64), levels=1), True),
    "odd_size": (lambda: noise(37, 29), dict(cblk=(8, 16), levels=4), True),
    "one_row": (lambda: smooth(1, 20), dict(levels=0), True),
    "one_column": (lambda: smooth(20, 1, 1), dict(levels=0), True),
    "levels5": (lambda: noise(35, 43), dict(levels=5, cblk=(4, 4)), True),
    "refine": (lambda: smooth(40, 56), dict(refine=True), False),
    "refine_noise_odd": (lambda: noise(29, 37), dict(refine=True, cblk=(16, 8)), False),
    "refine_97": (lambda: noise(35, 43), dict(refine=True, irreversible=True), False),
    "refine_vsc": (lambda: noise(35, 43), dict(refine=True, style=0x48), False),
    "refine_two_layers": (lambda: noise(35, 43), dict(refine=True, layers=2, cblk=(16, 16)),
                          False),
    "two_layers_termall": (lambda: noise(35, 43), dict(refine=True, layers=2, style=0x44),
                           False),
    "style_bits_7f": (lambda: noise(35, 43), dict(refine=True, style=0x7F), False),
}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_writer_kinds_read_like_cv2(tmp_path, kind):
    """Each kind of the test writer in every mode as cv2 reads it; where the
    writer is lossless, cv2 gives back its input."""
    make, kw, lossless = KINDS[kind]
    px = make()
    got = read_all(tmp_path, ve.jpeg2000_ht(px, **kw))
    assert got["unchanged"] is not None
    if lossless:
        np.testing.assert_array_equal(got["unchanged"], px)


@pytest.mark.parametrize("kw", [dict(sets=2), dict(sets=3, refine=True), dict(style=0xC0),
                                dict(style=0xC0, refine=True)],
                         ids=["two_sets", "three_sets_refined", "mixed", "mixed_refined"])
def test_refused_ht_forms_refuse_like_cv2(tmp_path, kw):
    """More than one HT set (over the 3 passes OpenJPEG decodes) and the
    mixed style (0x80 with HT): cv2 returns None, the port refuses."""
    got = read_all(tmp_path, ve.jpeg2000_ht(smooth(24, 32), **kw))
    assert all(v is None for v in got.values())


@pytest.mark.parametrize("kw", [dict(rsiz=0, cap=False), dict(rsiz=0xFFFF), dict(cap_body=b""),
                                dict(cap_body=struct.pack(">I", 0)),
                                dict(main_extra=hw._segment(0xFF59, b"\0\0"))],
                         ids=["no_ht_capability", "every_rsiz_bit", "empty_cap",
                              "cap_without_part15", "cpf"])
def test_capabilities_change_nothing_like_cv2(tmp_path, kw):
    """Rsiz's HT bit, the CAP marker and CPF: OpenJPEG decodes HT
    code-blocks whatever they say, and so does the port (lossless)."""
    px = smooth(24, 32)
    got = read_all(tmp_path, ve.jpeg2000_ht(px, **kw))
    np.testing.assert_array_equal(got["unchanged"], px)


def _first_block(f):
    done = []

    def tamper(v, mb, p, passes, segs, m):
        if done:
            return passes, segs, m
        done.append(1)
        return f(v, mb, p, passes, segs, m)
    return tamper


def _scup(val):
    def f(v, mb, p, passes, segs, m):
        c = bytearray(segs[0])
        c[-1], c[-2] = val >> 4, (c[-2] & 0xF0) | (val & 0xF)
        return passes, [bytes(c)] + segs[1:], m
    return f


def _mel_ff(v, mb, p, passes, segs, m):
    c = bytearray(segs[0])
    at = len(c) - ((c[-1] << 4) + (c[-2] & 0xF))
    c[at:at + 2] = b"\xff\x90"
    return passes, [bytes(c)] + segs[1:], m


def _outside(v, mb, p, passes, segs, m):
    wide = np.pad(v, ((0, 1), (0, 1)), constant_values=3)
    return passes, [hw.encode_cleanup(wide, p, m + 2)] + segs[1:], m


MALFORMED = {
    "second_segment_empty": (dict(refine=True), lambda v, mb, p, n, s, m: (3, [s[0], b""], m)),
    "more_than_3_passes": (dict(refine=True), lambda v, mb, p, n, s, m: (4, s, m)),
    "scup_below_2": (dict(), _scup(1)),
    "scup_above_lcup": (dict(), _scup(4000)),
    "scup_above_4079": (dict(), _scup(4080)),
    "uq_above_zero_planes": (dict(), lambda v, mb, p, n, s, m: (n, s, 0)),
    "significance_outside": (dict(cblk=(8, 8)), _outside),
    "zero_planes_equal_mb": (dict(), lambda v, mb, p, n, s, m: (3, [s[0], b"\x12\x34\x56"], m)),
    "zero_planes_above_mb": (dict(), lambda v, mb, p, n, s, m: (n, s, mb)),
    "mel_sequence": (dict(), _mel_ff),
    "cleanup_of_one_byte": (dict(), _first_block(lambda v, mb, p, n, s, m: (n, [s[0][:1]], m))),
    "roi_shift": (dict(main_extra=hw._segment(0xFF5E, b"\0\0\3")), None),
    "mb_over_30": (dict(irreversible=True, step=2.0 ** -20), None),
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_ht_blocks_read_like_cv2(tmp_path, case):
    """Each malformed code-block OpenJPEG checks for: read or refused (the
    whole tile fails) exactly as cv2 does."""
    kw, tamper = MALFORMED[case]
    read_all(tmp_path, ve.jpeg2000_ht(smooth(40, 56), tamper=tamper, **kw))


@pytest.mark.parametrize("seed", range(3))
def test_damaged_ht_data_reads_like_cv2(tmp_path, seed):
    """Random HT files with 1-3 bytes of their code-block data changed or
    flipped: every read as cv2 reads or refuses it."""
    rng = np.random.default_rng(700 + seed)
    done = 0
    while done < 12:
        data, _ = ve.jpeg2000_ht_random(rng, 40)
        if data is None:
            continue
        d = bytearray(data)
        i0 = data.index(b"\xff\x93") + 2
        for _ in range(int(rng.integers(1, 4))):
            j = int(rng.integers(i0, len(d) - 2))
            d[j] = int(rng.integers(0, 256)) if rng.random() < 0.5 else d[j] ^ (1 << int(
                rng.integers(0, 8)))
        read_all(tmp_path, bytes(d))
        done += 1


@pytest.mark.parametrize("seed", range(2))
def test_random_ht_files_read_like_cv2(tmp_path, seed):
    """`jpeg2000_ht_random`: random kinds, sizes, wavelets, code-blocks,
    tiles, precincts, progressions and passes, every mode as cv2."""
    rng = np.random.default_rng(900 + seed)
    read = 0
    for _ in range(10):
        data, _ = ve.jpeg2000_ht_random(rng, 40)
        if data is not None:
            read += sum(v is not None for v in read_all(tmp_path, data).values())
    assert read > 10


def test_vlc_tables_pass_their_checks():
    """The committed CxtVLC tables hold the checks `tools/extract_ht_tables.py`
    makes of the library's (lengths, aliases, patterns, context 0, prefix
    code), and they equal the library's where PIL bundles libopenjp2."""
    from kgtpu_torch.data.j2k_ht_tables import VLC_TBL0, VLC_TBL1
    from tools import extract_ht_tables as ex
    assert ex.check_table(list(VLC_TBL0)) is None
    assert ex.check_table(list(VLC_TBL1)) is None
    try:
        lib = ex.default_lib()
    except SystemExit:
        return
    assert ex.extract(lib) == (list(VLC_TBL0), list(VLC_TBL1))


def _seg(m, body):
    return struct.pack(">HH", m, len(body) + 2) + body


def _mct(idx, elem, vals, z=0, y=0):
    fmt = (">h", ">i", ">f", ">d")[elem]
    return _seg(0xFF74, struct.pack(">HHH", z, idx | 2 << 8 | elem << 10, y)
                + b"".join(struct.pack(fmt, v) for v in vals))


def _mcc(idx, n, deco=0, off=0, q=1, x=1):
    return _seg(0xFF75, struct.pack(">HBHH", 0, idx, 0, q) + bytes([x]) + struct.pack(">H", n)
                + bytes(range(n)) + struct.pack(">H", n) + bytes(range(n))
                + bytes([1, off, deco]))


def _mco(*idx):
    return _seg(0xFF77, bytes([len(idx)]) + bytes(idx))


def _cbd(*defs):
    return _seg(0xFF78, struct.pack(">H", len(defs)) + bytes(defs))


OFF = _mct(1, 1, [10, -20, 30])
PART2 = {
    "offsets": dict(main_extra=OFF + _mcc(1, 3, off=1) + _mco(1)),
    "offsets_97": dict(irreversible=True, main_extra=OFF + _mcc(1, 3, off=1) + _mco(1)),
    "offsets_in_tile_header": dict(tile_extra=OFF + _mcc(1, 3, off=1) + _mco(1)),
    "offsets_redefined_in_tile": dict(main_extra=OFF + _mcc(1, 3, off=1) + _mco(1),
                                      tile_extra=_mct(1, 1, [5, 6, 7]) + _mco(1)),
    "offsets_int16_unsigned": dict(main_extra=_mct(1, 0, [10, -20, 30]) + _mcc(1, 3, off=1)
                                   + _mco(1)),
    "offsets_float64_truncated": dict(main_extra=_mct(1, 3, [10.7, -20.2, 30.5])
                                      + _mcc(1, 3, off=1) + _mco(1)),
    "offsets_float_out_of_range": dict(main_extra=_mct(1, 2, [1e12, -1e12, float("nan")])
                                       + _mcc(1, 3, off=1) + _mco(1)),
    "offsets_int32_wrapping": dict(main_extra=_mct(1, 1, [2 ** 31 - 100, -2 ** 31, 0])
                                   + _mcc(1, 3, off=1) + _mco(1)),
    "offsets_int32_97": dict(irreversible=True, main_extra=_mct(1, 1, [2 ** 31 - 100, -2 ** 31, 0])
                             + _mcc(1, 3, off=1) + _mco(1)),
    "mco_before_its_records": dict(main_extra=_mco(1) + OFF + _mcc(1, 3, off=1)),
    "mco_of_no_stage": dict(main_extra=_seg(0xFF77, b"\0")),
    "mco_of_two_stages": dict(main_extra=OFF + _mcc(1, 3, off=1) + _mco(1, 1)),
    "mco_names_second_mcc": dict(main_extra=OFF + _mct(2, 1, [1, 2, 3]) + _mcc(1, 3, off=1)
                                 + _mcc(2, 3, off=2) + _mco(2)),
    "mct_redefined_after_mcc": dict(main_extra=OFF + _mcc(1, 3, off=1) + _mct(1, 1, [1, 2, 3])
                                    + _mco(1)),
    "mct_alone": dict(main_extra=OFF),
    "mct_zmct_set": dict(main_extra=_mct(1, 1, [1, 2, 3], z=1)),
    "decorrelation_checked_only": dict(main_extra=_mct(2, 2, [1, 0, 0, 0, 1, 0, 0, 0, 1])
                                       + _mcc(1, 3, deco=2) + _mco(1)),
    "mcc_of_two_collections": dict(main_extra=OFF + _mcc(1, 3, off=1, q=2) + _mco(1)),
    "mcc_not_array_based": dict(main_extra=OFF + _mcc(1, 3, off=1, x=5) + _mco(1)),
    "mcc_of_two_components": dict(main_extra=_mct(1, 1, [10, 20]) + _mcc(1, 2, off=1) + _mco(1)),
    "cbd_12_bits": dict(main_extra=_cbd(11, 11, 11)),
    "cbd_12_bits_97": dict(irreversible=True, main_extra=_cbd(11, 11, 11)),
    # refused by cv2
    "mct_cut_short": dict(main_extra=_seg(0xFF74, b"\0")),
    "mct_of_no_data": dict(main_extra=_seg(0xFF74, b"\0\0\0\x01\0\0") + _mco(1)),
    "mct_ymct_set": dict(main_extra=_mct(1, 1, [1, 2, 3], y=1) + _mcc(1, 3, off=1) + _mco(1)),
    "mcc_before_its_mct": dict(main_extra=_mcc(1, 3, off=1) + OFF + _mco(1)),
    "mcc_with_a_byte_over": dict(main_extra=OFF + _seg(0xFF75, _mcc(1, 3, off=1)[4:] + b"\0")
                                 + _mco(1)),
    "offsets_of_the_wrong_size": dict(main_extra=_mct(1, 1, [10, 20]) + _mcc(1, 3, off=1)
                                      + _mco(1)),
    "decorrelation_of_the_wrong_size": dict(main_extra=_mct(2, 2, [1, 0, 0])
                                            + _mcc(1, 3, deco=2) + _mco(1)),
    "mco_of_the_wrong_length": dict(main_extra=OFF + _mcc(1, 3, off=1)
                                    + _seg(0xFF77, b"\1\1\1")),
    "mco_empty": dict(main_extra=_seg(0xFF77, b"")),
    "cbd_signed": dict(main_extra=_cbd(0x87, 7, 7)),
    "cbd_of_two_components": dict(main_extra=_cbd(7, 7)),
    "cbd_in_a_tile_header": dict(tile_extra=_cbd(11, 11, 11)),
}


@pytest.mark.parametrize("case", sorted(PART2))
def test_part2_markers_read_like_cv2(tmp_path, case):
    """MCT / MCC / MCO / CBD segments spliced into an HT codestream: each
    read (with its DC level shifts, precision and clamp) or refused as cv2
    does."""
    read_all(tmp_path, ve.jpeg2000_ht(smooth(24, 32), **PART2[case]))


def test_part2_markers_in_a_part1_stream_read_like_cv2(tmp_path):
    """The same markers before the COD of a file cv2 wrote (Part 1): the
    offsets move the output as cv2 moves it."""
    cs = cv2.imencode(".jp2", smooth(64, 64))[1].tobytes()
    at = cs.index(b"\xff\x52")
    got = read_all(tmp_path, cs[:at] + OFF + _mcc(1, 3, off=1) + _mco(1) + cs[at:])
    assert got["unchanged"] is not None


def test_committed_ht_fixtures_match_cv2_hashes():
    """formats/jpeg2000_ht (the fixtures `chip_smoke.py` [17](d) decodes):
    every file in every mode against cv2's stored hashes."""
    from tools.make_torch_format_assets import sha
    ref = np.load(os.path.join(ROOT, "assets_torch", "kgtpu_reference_formats.npz"))
    decodes = json.loads(str(ref["jpeg2000_ht_decode_json"]))
    assert len(decodes) == 33
    for d in decodes:
        path = os.path.join(ROOT, "assets_torch", "formats", "jpeg2000_ht", d["path"])
        if d["sha256"] is None:
            with pytest.raises(UnreadableImage):
                read_image(path, d["mode"])
            continue
        got = read_image(path, d["mode"])
        assert (sha(got), list(got.shape), str(got.dtype)) == \
            (d["sha256"], d["shape"], d["dtype"]), d
