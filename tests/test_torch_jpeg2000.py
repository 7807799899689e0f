"""The port's JPEG 2000 reader (`data/jpeg2000.py`, `j2k_t2.py`, `j2k_t1.py`,
`j2k_dwt.py`) against cv2 5.0 (OpenJPEG 2.5.3), which kgtpu's readers call:
every kind of the committed fixtures at small sizes (cv2's lossless and
rated writes; PIL's raw codestream, 9/7 with quality layers, tiles, the five
progressions, precincts, code-block sizes, resolution counts, no colour
transform, grey, RGBA, grey + alpha and 16-bit), the JP2 colour boxes (sYCC,
ICC, unknown and refused spaces, palettes, channel definitions), precisions
and signs cv2 reads or refuses, RGN and POC markers put in a written
codestream and its packet headers moved into PPT or PPM markers, a tile
offset (which needs an image offset, which cv2 refuses), codestreams cut
short or with a byte flipped, damaged boxes and markers (one per rule of
OpenJPEG's reader), random damage anywhere, and a
seeded sweep of random files; the code-block styles (BYPASS, RESET,
TERMALL, VSC, PTERM, SEGSYM and their mixes, written by libopenjp2 through
`tools/variant_encoders.jpeg2000_opj`) and a Part 1 stream whose COD claims
HT (`tests/test_torch_jpeg2000_ht.py` holds the HT code-blocks).

Files are written in tmp_path by cv2, PIL and libopenjp2 under a .png name (cv2 picks
the decoder by content) and held against cv2.imread in the three read
modes.  Where cv2 returns None the port must raise `UnreadableImage` (a
FileNotFoundError).

Tolerance: none.  Every comparison is exact (dtype, shape and every value).
"""

import io
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

from kgtpu_torch.data.imread import MODES, UnreadableImage, read_image
from tools import variant_encoders as ve

_CV = {"color": cv2.IMREAD_COLOR, "gray": cv2.IMREAD_GRAYSCALE,
       "unchanged": cv2.IMREAD_UNCHANGED}


def check(path, mode):
    """The port's read of `path` equals cv2's (RGB order), or both refuse
    (cv2 returns None, or raises for a size over its limits)."""
    try:
        want = cv2.imread(path, _CV[mode])
    except cv2.error:
        want = None
    if want is None:
        with pytest.raises(UnreadableImage):
            read_image(path, mode)
        return False
    if want.ndim == 3:
        want = want[..., [2, 1, 0, 3][:want.shape[2]]]
    got = read_image(path, mode)
    assert (got.dtype, got.shape) == (want.dtype, want.shape), (path, mode)
    np.testing.assert_array_equal(got, want, err_msg=f"{path} {mode}")
    return True


def read_all(tmp_path, data: bytes) -> int:
    """`check` in every mode; the number of modes cv2 reads."""
    path = str(tmp_path / "image.png")
    with open(path, "wb") as f:
        f.write(data)
    return sum(check(path, mode) for mode in MODES)


def smooth(h, w, c=3, seed=0):
    """Gradients and sines (compress like photographs) with a noisy band."""
    y, x = np.mgrid[:h, :w]
    a = np.stack([(x * 5 + y * 3) % 256, (x * y) % 256, 128 + 100 * np.sin(x / 5 + y / 7),
                  (x * 11 + 40) % 256], -1).astype(np.uint8)[..., :c]
    a[h // 3:h // 2] = np.random.default_rng(seed).integers(0, 256, a[h // 3:h // 2].shape)
    return a


def pil(a, mode=None, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(a, mode).save(buf, "JPEG2000", **kw)
    return buf.getvalue()


def cv2_jp2(bgr, *params) -> bytes:
    return cv2.imencode(".jp2", bgr, list(params))[1].tobytes()


def box(typ: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + typ + body


def colr(enum: int) -> bytes:
    return b"\x01\0\0" + struct.pack(">I", enum)


def jp2(cs: bytes, colour: bytes | None, extra: bytes = b"") -> bytes:
    """A JP2 file around the raw codestream `cs`: its ihdr, a colr box of
    body `colour` (none when None) and `extra` boxes in jp2h."""
    x1, y1 = struct.unpack(">II", cs[8:16])
    (nc,) = struct.unpack(">H", cs[40:42])
    ihdr = box(b"ihdr", struct.pack(">IIHBBBB", y1, x1, nc, cs[42], 7, 0, 0))
    head = ihdr + (box(b"colr", colour) if colour is not None else b"") + extra
    return (b"\0\0\0\x0cjP  \r\n\x87\n" + box(b"ftyp", b"jp2 \0\0\0\0jp2 ")
            + box(b"jp2h", head) + box(b"jp2c", cs))


def siz_components(cs: bytes, precs, signed=None) -> bytes:
    """`cs` with SIZ's component precisions (and signs) replaced."""
    b = bytearray(cs)
    for k, p in enumerate(precs):
        b[42 + 3 * k] = (p - 1) | ((signed[k] if signed else 0) << 7)
    return bytes(b)


def pclr(entries, bits) -> bytes:
    body = struct.pack(">HB", *entries.shape) + bytes(bits)
    for row in entries:
        for v, b in zip(row, bits):
            body += int(v).to_bytes(((b & 0x7F) + 8) // 8, "big")
    return box(b"pclr", body)


def cmap(entries) -> bytes:
    return box(b"cmap", b"".join(struct.pack(">HBB", *e) for e in entries))


def cdef(entries) -> bytes:
    return box(b"cdef", struct.pack(">H", len(entries))
               + b"".join(struct.pack(">HHH", *e) for e in entries))


def after_cod(cs: bytes, segments: bytes) -> bytes:
    """`cs` with marker segments inserted after its main header's COD."""
    at = cs.index(b"\xff\x52")
    end = at + 2 + struct.unpack(">H", cs[at + 2:at + 4])[0]
    return cs[:end] + segments + cs[end:]


def rgn(comp: int, shift: int) -> bytes:
    return b"\xff\x5e" + struct.pack(">HBBB", 5, comp, 0, shift)


def poc(*entries) -> bytes:
    """(first resolution, first component, layer end, resolution end,
    component end, progression) per entry."""
    return b"\xff\x5f" + struct.pack(">H", 2 + 7 * len(entries)) + b"".join(
        struct.pack(">BBHBBB", *e) for e in entries)


def _kinds():
    a = smooth(40, 48)
    g = smooth(40, 48, 1)[..., 0]
    rgba = smooth(40, 48, 4)
    g16 = g.astype(np.uint16) * 256 + a[..., 1]
    rates = dict(quality_mode="rates", quality_layers=[12, 4])
    k = {
        "cv2_lossless": cv2_jp2(a),
        "cv2_x1000_200": cv2_jp2(a, cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, 200),
        "cv2_x1000_50": cv2_jp2(a, cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, 50),
        "cv2_grey": cv2_jp2(g),
        "cv2_grey16": cv2_jp2(g16),
        "cv2_rgb16": cv2_jp2(a.astype(np.uint16) * 200),
        "pil_default": pil(a),
        "pil_codestream": pil(a, no_jp2=True),
        "pil_97": pil(a, irreversible=True),
        "pil_97_3layers": pil(a, irreversible=True, quality_mode="rates",
                              quality_layers=[40, 20, 10]),
        "pil_97_db_layers": pil(a, irreversible=True, quality_mode="dB", quality_layers=[30, 40]),
        "pil_tiles": pil(a, tile_size=(16, 16), **rates),
        "pil_tiles_97": pil(a, tile_size=(32, 24), irreversible=True),
        "pil_tile_offset": pil(a, tile_size=(16, 16), tile_offset=(4, 4), offset=(4, 4)),
        "pil_rpcl": pil(a, progression="RPCL", **rates),
        "pil_pcrl": pil(a, progression="PCRL", **rates),
        "pil_cprl": pil(a, progression="CPRL", **rates),
        "pil_rlcp": pil(a, progression="RLCP", **rates),
        "pil_precincts": pil(a, precinct_size=(32, 32), **rates),
        "pil_precincts_rpcl": pil(a, precinct_size=(32, 32), progression="RPCL",
                                  tile_size=(32, 32)),
        "pil_cblk32": pil(smooth(64, 64), codeblock_size=(32, 32)),
        "pil_cblk16x64": pil(a, codeblock_size=(16, 64)),
        "pil_res3": pil(a, num_resolutions=3),
        "pil_res7": pil(smooth(64, 64), num_resolutions=7),
        "pil_mct0": pil(a, mct=0),
        "pil_mct0_97": pil(a, mct=0, irreversible=True),
        "pil_plt_comment": pil(a, plt=True, comment="kgtpu", **rates),
        "pil_grey": pil(g),
        "pil_grey_codestream": pil(g, no_jp2=True),
        "pil_rgba": pil(rgba),
        "pil_grey_alpha": pil(a[..., :2], "LA"),
        "pil_grey16": pil(g16),
        "pil_grey16_97": pil(g16, irreversible=True),
    }
    cs = pil(a, no_jp2=True)
    gcs = pil(g, no_jp2=True)
    rcs = pil(rgba, no_jp2=True)
    k.update({
        "jp2_srgb": jp2(cs, colr(16)),
        "jp2_sycc": jp2(pil(a, no_jp2=True, mct=0), colr(18)),
        "jp2_sycc_grey": jp2(gcs, colr(18)),
        "jp2_sycc_rgba": jp2(rcs, colr(18)),
        "jp2_sycc_12bit": jp2(siz_components(cs, [12] * 3), colr(18)),
        "jp2_grey_of_rgb": jp2(cs, colr(17)),
        "jp2_grey_of_rgba": jp2(rcs, colr(17)),
        "jp2_cmyk": jp2(cs, colr(12)),
        "jp2_esycc": jp2(cs, colr(24)),
        "jp2_unknown_enum": jp2(cs, colr(99)),
        "jp2_icc": jp2(cs, b"\x02\0\0" + bytes(128)),
        "jp2_icc_grey": jp2(gcs, b"\x02\0\0" + bytes(128)),
        "jp2_no_colr": jp2(cs, None),
        "prec_12": siz_components(cs, [12] * 3),
        "prec_9_grey": jp2(siz_components(gcs, [9]), colr(17)),
        "prec_mixed": siz_components(cs, [8, 12, 6]),
        "prec_6_mixed": siz_components(cs, [6, 6, 8]),
        "prec_7": siz_components(cs, [7] * 3),
        "prec_16_rgba": siz_components(rcs, [12, 8, 8, 16]),
        "signed": siz_components(cs, [8] * 3, [1, 0, 0]),
    })
    cs97 = pil(a, no_jp2=True, irreversible=True, quality_mode="rates", quality_layers=[10])
    k.update({                          # markers no writer here emits
        "rgn_shift_3": after_cod(cs, rgn(0, 3)),
        "rgn_shift_7_97": after_cod(cs97, rgn(1, 7)),
        "rgn_every_component": after_cod(cs, rgn(0, 2) + rgn(1, 4) + rgn(2, 5)),
        "poc_same_order": after_cod(cs, poc((0, 0, 1, 3, 3, 0), (3, 0, 1, 6, 3, 0))),
        "poc_components_apart": after_cod(cs, poc((0, 0, 1, 6, 1, 1), (0, 1, 1, 6, 3, 1))),
        "poc_other_order": after_cod(cs, poc((0, 0, 1, 6, 3, 2))),
        "ppt": ve.jpeg2000_packed_headers(cs, "ppt"),
        "ppm": ve.jpeg2000_packed_headers(cs, "ppm"),
        "ppt_tiles_layers": ve.jpeg2000_packed_headers(pil(a, no_jp2=True, tile_size=(16, 16),
                                                           **rates), "ppt"),
        "ppm_97_rpcl": ve.jpeg2000_packed_headers(
            pil(a, no_jp2=True, irreversible=True, progression="RPCL", precinct_size=(32, 32)),
            "ppm"),
    })
    rng = np.random.default_rng(1)
    idx = pil((g // 16).astype(np.uint8), no_jp2=True)
    ent = rng.integers(0, 256, (16, 3))
    three = cmap([(0, 1, 0), (0, 1, 1), (0, 1, 2)])
    k.update({
        "palette": jp2(idx, colr(16), pclr(ent, [7, 7, 7]) + three),
        "palette_short": jp2(idx, colr(16), pclr(ent[:10], [7, 7, 7]) + three),
        "palette_16bit_entries": jp2(idx, colr(16), pclr(rng.integers(0, 65536, (16, 3)),
                                                        [15, 15, 15]) + three),
        "palette_mixed_bits": jp2(idx, colr(16), pclr(ent % 32, [4, 7, 0x87]) + three),
        "palette_rgba": jp2(idx, colr(16), pclr(rng.integers(0, 256, (16, 4)), [7] * 4)
                            + cmap([(0, 1, c) for c in range(4)])),
        "palette_grey": jp2(idx, colr(17), pclr(ent[:, :1], [7]) + cmap([(0, 1, 0)])),
        "palette_without_cmap": jp2(idx, colr(16), pclr(ent, [7, 7, 7])),
        "palette_direct_channel": jp2(idx, colr(16), pclr(ent, [7, 7, 7])
                                      + cmap([(0, 1, 0), (0, 0, 0), (0, 1, 2)])),
        "palette_cmap_twice": jp2(idx, colr(16), pclr(ent, [7, 7, 7])
                                  + cmap([(0, 1, 0), (0, 1, 0), (0, 1, 2)])),
        "cdef_swap": jp2(cs, colr(16), cdef([(0, 0, 3), (1, 0, 2), (2, 0, 1)])),
        "cdef_alpha_first_rgb": jp2(cs, colr(16), cdef([(0, 1, 0), (1, 0, 1), (2, 0, 2)])),
        "cdef_incomplete": jp2(cs, colr(16), cdef([(0, 0, 2), (1, 0, 1)])),
        "cdef_rgba_alpha_first": jp2(rcs, colr(16), cdef([(0, 1, 0), (1, 0, 1), (2, 0, 2),
                                                          (3, 0, 3)])),
        "cdef_rgba_rotated": jp2(rcs, colr(16), cdef([(0, 0, 2), (1, 0, 3), (2, 0, 1),
                                                      (3, 2, 0)])),
    })
    return k


# kinds cv2 refuses in every mode (the port must too)
REFUSED = {"pil_tile_offset", "jp2_cmyk", "jp2_esycc", "prec_7", "signed", "cdef_incomplete",
           "palette_cmap_twice"}


@pytest.fixture(scope="module")
def kinds():
    return _kinds()


@pytest.mark.parametrize("name", sorted(_kinds()))
def test_kind_reads_like_cv2(tmp_path, kinds, name):
    """Each kind in "color", "gray" and "unchanged" equals cv2.imread (or
    raises UnreadableImage where it returns None)."""
    read = read_all(tmp_path, kinds[name])
    assert (read == 0) == (name in REFUSED), (name, read)


def _truncated_and_damaged():
    a = smooth(33, 41)
    bases = {"cv2": cv2_jp2(a),
             "layers": pil(a, quality_mode="rates", quality_layers=[40, 20, 10], no_jp2=True),
             "tiles_97": pil(a, tile_size=(16, 16), irreversible=True, no_jp2=True),
             "rpcl_precincts": pil(a, progression="RPCL", precinct_size=(32, 32))}
    rng = np.random.default_rng(5)
    out = {}
    for name, d in bases.items():
        n = len(d)
        for cut in (n - 1, n - 2, n - 10, n // 2, 150, 60):
            out[f"{name}_cut_{cut}"] = d[:cut]
        sod = d.index(b"\xff\x93") + 2
        for _ in range(6):
            b = bytearray(d)
            at = int(rng.integers(sod, n - 2))
            b[at] ^= int(rng.integers(1, 256))
            out[f"{name}_flip_{at}"] = bytes(b)
    return out


@pytest.mark.parametrize("base", ["cv2", "layers", "tiles_97", "rpcl_precincts"])
def test_truncated_and_damaged_like_cv2(tmp_path, base):
    """Codestreams cut short anywhere (cv2's OpenJPEG reads in strict mode:
    None) or with one byte of packet data flipped (decoded as OpenJPEG
    decodes it) read as cv2 reads them."""
    files = {k: v for k, v in _truncated_and_damaged().items() if k.startswith(base + "_")}
    read = sum(read_all(tmp_path, d) for d in files.values())
    cuts = sum(k.split("_")[-2] == "cut" for k in files)
    assert read >= 2 * (len(files) - cuts)


def _header_damage():
    """One file a rule of OpenJPEG's (or cv2's) reader, each a small edit
    of a written file."""
    a = smooth(24, 20)
    jp = pil(a)
    cs = pil(a, no_jp2=True)
    tiled = pil(a, no_jp2=True, tile_size=(16, 16))
    sot = cs.index(b"\xff\x90")
    cod = cs.index(b"\xff\x52")

    def at(data, i, value: bytes):
        return data[:i] + value + data[i + len(value):]
    jp2c = jp.index(b"jp2c") - 4
    ihdr = jp.index(b"ihdr") + 4
    colr = jp.index(b"colr") - 4
    return {
        "second_box_not_ftyp": at(jp, 16, b"ftyq"),
        "jp2h_without_ihdr": at(jp, ihdr - 4, b"ihdq"),
        "ihdr_zero_components": at(jp, ihdr + 8, b"\0\0"),
        "ihdr_other_size": at(jp, ihdr, struct.pack(">I", 25)),
        "colr_too_short": at(jp, colr, struct.pack(">I", 10)) [:colr + 10]
        + jp[colr + 10:],
        "jp2c_length_wrong": at(jp, jp2c, struct.pack(">I", 100)),
        "jp2c_length_1": at(jp, jp2c, struct.pack(">I", 1)),
        "siz_length_wrong": at(cs, 4, struct.pack(">H", 42)),
        "tiles_over_65535": at(cs, 24, struct.pack(">II", 1, 1)),
        "precision_32": siz_components(cs, [8, 32, 8]),
        "precision_17": siz_components(cs, [17, 8, 8]),
        "width_over_2_20": at(cs, 8, struct.pack(">I", (1 << 20) + 1)),
        "sot_length_wrong": at(cs, sot + 2, b"\0\x0b"),
        "tile_part_index_wrong": at(tiled, tiled.index(b"\xff\x90") + 10, b"\x01"),
        "cod_unknown_scod": at(cs, cod + 4, b"\x08"),
        "cod_mct_2": at(cs, cod + 8, b"\x02"),
        "cod_transform_2": at(cs, cod + 13, b"\x02"),
        "cod_mixed_ht": at(cs, cod + 12, b"\xc0"),
        "qcd_wrong_length": after_cod(cs, b"\xff\x5c\x00\x05\x22\x00\x00"),
        "unknown_marker_in_main_header": after_cod(cs, b"\xff\x30\x00\x04\x00\x00"),
        "plt_in_main_header": after_cod(cs, b"\xff\x58\x00\x04\x00\x00"),
        "sop_in_main_header": after_cod(cs, b"\xff\x91\x00\x04\x00\x00"),
        "crg_wrong_length": after_cod(cs, b"\xff\x63\x00\x04\x00\x00"),
        "crg": after_cod(cs, b"\xff\x63\x00\x0e" + bytes(12)),
        "unknown_marker_in_tile_part_header": at(cs, sot + 6, struct.pack(
            ">I", struct.unpack(">I", cs[sot + 6:sot + 10])[0] + 6))[:sot + 12]
        + b"\xff\x30\x00\x04ab" + cs[sot + 12:],
        "com_in_tile_part_header": at(cs, sot + 6, struct.pack(
            ">I", struct.unpack(">I", cs[sot + 6:sot + 10])[0] + 6))[:sot + 12]
        + b"\xff\x64\x00\x04ab" + cs[sot + 12:],
        "two_bytes_for_eoc": cs[:-2] + b"AB",
        "four_bytes_for_eoc": cs[:-2] + b"ABCD",
        "garbage_after_eoc": cs + b"xyz",
        "last_tile_missing": tiled[:[i for i in range(len(tiled) - 1)
                                     if tiled[i:i + 2] == b"\xff\x90"][-1]] + b"\xff\xd9",
    }


@pytest.mark.parametrize("name", sorted(_header_damage()))
def test_damaged_headers_like_cv2(tmp_path, name):
    """JP2 boxes and codestream markers OpenJPEG (strict mode) or cv2's
    size limits refuse, or read past: the port refuses or reads each as
    cv2 does, in every mode."""
    read_all(tmp_path, _header_damage()[name])


def _damaged(rng, bases, n):
    """n files, each a base with bytes changed, cut short, or a run
    replaced by random bytes."""
    for k in range(n):
        d = bytearray(bases[k % len(bases)])
        if k % 3 == 0:
            for _ in range(int(rng.integers(1, 4))):
                d[int(rng.integers(0, len(d)))] = int(rng.integers(0, 256))
        elif k % 3 == 1:
            d = d[:int(rng.integers(1, len(d)))]
        else:
            i = int(rng.integers(0, len(d)))
            run = rng.integers(0, 256, int(rng.integers(1, 20))).astype(np.uint8).tobytes()
            d = d[:i] + bytearray(run) + d[i + int(rng.integers(0, 20)):]
        yield bytes(d)


@pytest.mark.parametrize("seed", range(2))
def test_random_damage_like_cv2(tmp_path, seed):
    """60 files with random bytes changed, cut or replaced anywhere (boxes,
    headers, packets): read or refused as cv2 reads or refuses them."""
    a = smooth(24, 20)
    bases = [pil(a), pil(a, no_jp2=True), pil(a[..., 0]),
             pil(a, no_jp2=True, irreversible=True, tile_size=(16, 16)),
             pil(a, quality_mode="rates", quality_layers=[20, 5], progression="RPCL",
                 precinct_size=(32, 32)), cv2_jp2(np.tile(a, (2, 2, 1)))]
    for data in _damaged(np.random.default_rng(100 + seed), bases, 60):
        read_all(tmp_path, data)


@pytest.mark.parametrize("seed", range(4))
def test_random_files_read_like_cv2(tmp_path, seed):
    """25 random files per seed, 1-48 px, in every mode."""
    rng = np.random.default_rng(1000 + seed)
    read = 0
    for _ in range(25):
        data, _ = ve.jpeg2000_random(rng, 48)
        if data is not None:
            read += read_all(tmp_path, data)
    assert read > 25


def clean(h, w, c=3, prec=8):
    """Smooth content without noise: libopenjp2's encoder overruns its
    buffers on noise in TERMALL (and can corrupt its heap at 16 bits)."""
    y, x = np.mgrid[:h, :w]
    top = (1 << prec) - 1
    a = np.stack([(0.5 + 0.45 * np.sin(x * 0.3 * (k + 1) + y * 0.17 + k)) * top
                  for k in range(c)], -1).astype(np.uint16 if prec > 8 else np.uint8)
    return a[..., 0] if c == 1 else a


@pytest.mark.parametrize("style", [0x01, 0x02, 0x04, 0x08, 0x10, 0x20])
def test_unported_codeblock_styles_raise_unsupported(tmp_path, style):
    """(Named when the port refused these styles.)  A codestream whose
    code-block style is BYPASS, RESET, TERMALL, VSC, PTERM or SEGSYM, from
    libopenjp2's own encoder, RGB with the colour transform and grey in a
    JP2: read in every mode as cv2 reads it, and lossless."""
    rgb = clean(40, 56)
    assert read_all(tmp_path, ve.jpeg2000_opj(rgb, style=style)) == 3
    np.testing.assert_array_equal(read_image(str(tmp_path / "image.png"), "unchanged"), rgb)
    assert read_all(tmp_path, ve.jpeg2000_opj(rgb[..., 1], style=style, resolutions=3,
                                              cblk=(16, 8), jp2=True)) == 3


@pytest.mark.parametrize("case", ["all63", "all63_97_layers", "bypass_layers_cblk4",
                                  "grey16_all63", "termall_reset_rgba_no_mct"])
def test_codeblock_style_mixes_read_like_cv2(tmp_path, case):
    """Every style at once (63), the 9/7 wavelet in three quality layers,
    BYPASS over several lossless layers with 4x4 code-blocks, 16-bit grey
    and four components without the colour transform: exactly as cv2."""
    kw = {"all63": dict(style=63),
          "all63_97_layers": dict(style=63, irreversible=True, layers=(40.0, 20.0, 8.0)),
          "bypass_layers_cblk4": dict(style=0x01, layers=(30.0, 10.0, 0.0), cblk=(4, 4),
                                      resolutions=3),
          "grey16_all63": dict(style=63, prec=16, layers=(20.0, 0.0), jp2=True),
          "termall_reset_rgba_no_mct": dict(style=0x06, mct=False, jp2=True)}[case]
    px = clean(40, 56, 1 if case.startswith("grey") else 4 if "rgba" in case else 3,
               16 if case.startswith("grey16") else 8)
    assert read_all(tmp_path, ve.jpeg2000_opj(px, **kw)) >= 2


def test_committed_style_fixtures_read_like_cv2():
    """formats/jpeg2000_styles (the fixtures `chip_smoke.py` [17] decodes):
    every file in every mode against cv2's stored hashes."""
    import json
    import os

    from tools.make_torch_format_assets import sha
    root = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "assets_torch")
    ref = np.load(os.path.join(root, "kgtpu_reference_formats.npz"))
    decodes = json.loads(str(ref["jpeg2000_styles_decode_json"]))
    assert len(decodes) == 30
    for d in decodes:
        path = os.path.join(root, "formats", "jpeg2000_styles", d["path"])
        if d["sha256"] is None:
            with pytest.raises(UnreadableImage):
                read_image(path, d["mode"])
            continue
        got = read_image(path, d["mode"])
        assert (sha(got), list(got.shape), str(got.dtype)) == \
            (d["sha256"], d["shape"], d["dtype"]), d


@pytest.mark.parametrize("case", ["rct_res3", "ict_res3", "tiles_rct_res2", "tiles_ict_res3",
                                  "apart_with_mct", "apart_without_mct", "progression_7",
                                  "grey_res2"])
def test_poc_leaving_resolutions_out_reads_like_cv2(tmp_path, case):
    """POC entries that never reach the top resolutions (or name no
    progression, which runs no packet): OpenJPEG's `resno_decoded` stops
    lower, and cv2 returns the reduced image in the top-left corner, zeros
    elsewhere; components stopped at different resolutions refuse the
    colour transform.  (A damaged COM turned POC in the damage probe.)"""
    a = smooth(40, 48)
    kw = dict(no_jp2=True, irreversible="ict" in case)
    if case.startswith("tiles"):
        cs = pil(a, tile_size=(16, 16), num_resolutions=4, mct=1, **kw)
    elif case == "grey_res2":
        cs = pil(a[..., 0], num_resolutions=4, **kw)
    else:
        cs = pil(a, num_resolutions=6, mct=0 if case == "apart_without_mct" else 1, **kw)
    entries = {"rct_res3": [(0, 0, 1, 3, 3, 0)], "ict_res3": [(0, 0, 1, 3, 3, 0)],
               "tiles_rct_res2": [(0, 0, 1, 2, 3, 0)], "tiles_ict_res3": [(0, 0, 1, 3, 3, 1)],
               "apart_with_mct": [(0, 0, 1, 3, 3, 0), (3, 0, 1, 5, 1, 0)],
               "apart_without_mct": [(0, 0, 1, 3, 3, 0), (3, 0, 1, 5, 1, 0)],
               "progression_7": [(0, 0, 1, 3, 3, 7)], "grey_res2": [(0, 0, 1, 2, 1, 1)]}[case]
    read = read_all(tmp_path, after_cod(cs, poc(*entries)))
    assert read == {"apart_with_mct": 0, "grey_res2": 2}.get(case, 3)


@pytest.mark.parametrize("drop", [None, 0, 5, -1], ids=["every_eph", "first_missing",
                                                       "sixth_missing", "last_missing"])
def test_missing_eph_marker_refuses_like_cv2(tmp_path, drop):
    """COD asks for EPH markers: OpenJPEG fails the tile where a packet
    header is not followed by one (or two bytes are not left for it); the
    port read on.  (Found by `tools/probe_jpeg2000.py --damage`.)"""
    cs = pil(smooth(40, 48), no_jp2=True, num_resolutions=3, tile_size=(32, 32))
    got = read_all(tmp_path, ve.jpeg2000_eph(cs, drop))
    assert got == (3 if drop is None else 0)


def test_ht_style_on_a_part1_stream_reads_like_cv2(tmp_path):
    """(Named test_ht_codeblocks_raise_unsupported while the port queued HT.)
    A Part 1 codestream whose COD claims HT code-blocks (Part 15, style
    0x40): its MQ-coded blocks go to the HT decoder, as in OpenJPEG, and
    the port reads or refuses the file exactly as cv2 does, in every mode."""
    b = bytearray(ve.jpeg2000_opj(clean(24, 32), resolutions=3))
    at = b.index(b"\xff\x52") + 4 + 8            # Scod, SGcod, then NL, xcb, ycb, style
    assert b[at] == 0
    b[at] = 0x40
    read_all(tmp_path, bytes(b))
