#!/usr/bin/env python
"""Write `kgtpu_torch/data/av1_tables.py`: the AV1 default CDFs and the
other constant tables of the AV1 decoding process, read from the libaom
that cv2's wheel bundles (`opencv_python.libs/libaom-*.so.3.*`):

    python tools/extract_av1_tables.py [--lib PATH] [--out PATH]

Most tables are named arrays in the library's `.symtab` (read with a small
ELF reader).  The default mode CDFs are not: libaom's `av1_init_mode_probs`
fills a FRAME_CONTEXT from constants it keeps inside its own code, so the
tool calls that function through ctypes (its address from the symbol
table plus the load base of an exported function) on a buffer filled with
a marker, and walks the result field by field (`MODE_FIELDS`, libaom 3.x's
FRAME_CONTEXT order).  The walk is self-checking: every CDF of n symbols
must hold n strictly decreasing inverted values (AOM_ICDF, 32768 - x)
ending in 0, then the adaptation counter 0, then zero padding to the
field's width, and the walk must end exactly where the written bytes end.
The coefficient CDFs (`av1_default_*_cdfs`, four quantiser contexts) and
the motion-vector CDFs (`default_nmv_context`) are read by name and pass
the same check.  The CDFs are written in the specification's form
(cumulative, increasing, the last value 32768, then the counter 0).

Position tables (scans, the coefficient-context offsets, quantiser
matrices) are stored by libaom in column-major order (position = column *
height + row); they are transposed here to the specification's raster
order (row * width + column) and checked: each scan against the
construction of the specification's (zig-zag for squares, diagonals for
rectangles, rows and columns for the 1-D scans), the 2-D context offsets
against the specification's 5x5 rule.  The port never opens a library: it
reads the literals this tool writes.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import os
import struct
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from extract_ht_tables import sections  # noqa: E402

MARK = 0xABCD

# FRAME_CONTEXT after the coefficient CDFs: (name, array dims, symbols);
# None marks a field av1_init_mode_probs leaves alone (the MV contexts).
MODE_FIELDS = [
    ("newmv", (6,), 2), ("zeromv", (2,), 2), ("refmv", (6,), 2), ("drl", (3,), 2),
    ("inter_compound_mode", (8,), 8), ("compound_type", (22,), 2), ("wedge_idx", (22,), 16),
    ("interintra", (4,), 2), ("wedge_interintra", (22,), 2), ("interintra_mode", (4,), 4),
    ("motion_mode", (22,), 3), ("obmc", (22,), 2),
    ("palette_y_size", (7,), 7), ("palette_uv_size", (7,), 7),
    ("palette_y_color", (7, 5), 8), ("palette_uv_color", (7, 5), 8),
    ("palette_y_mode", (7, 3), 2), ("palette_uv_mode", (2,), 2),
    ("comp_inter", (5,), 2), ("single_ref", (3, 6), 2), ("comp_ref_type", (5,), 2),
    ("uni_comp_ref", (3, 3), 2), ("comp_ref", (3, 3), 2), ("comp_bwdref", (3, 2), 2),
    ("txfm_partition", (21,), 2), ("compound_index", (6,), 2), ("comp_group_idx", (6,), 2),
    ("skip_mode", (3,), 2), ("skip", (3,), 2), ("intra_inter", (4,), 2),
    (None, (286,), None),
    ("intrabc", (), 2), ("segment_pred", (3,), 2), ("segment_id", (3,), 8),
    ("use_filter_intra", (22,), 2), ("filter_intra_mode", (), 5),
    ("switchable_restore", (), 3), ("use_wiener", (), 2), ("use_sgrproj", (), 2),
    ("y_mode", (4,), 13), ("uv_mode", (2, 13), 14), ("partition", (20,), 10),
    ("interp_filter", (16,), 3), ("kf_y_mode", (5, 5), 13), ("angle_delta", (8,), 7),
    ("tx_depth", (4, 3), 3), ("delta_q", (), 4), ("delta_lf_multi", (4,), 4),
    ("delta_lf", (), 4), ("intra_tx_type", (3, 4, 13), 16), ("inter_tx_type", (4, 4), 16),
    ("cfl_sign", (), 8), ("cfl_alpha", (6,), 16),
]
# Symbols each entry really has (the rest of a field's width is padding).
PARTITION_SYMBOLS = [4] * 4 + [10] * 12 + [8] * 4
TX_DEPTH_SYMBOLS = [2, 3, 3, 3]
INTRA_TX_SYMBOLS = [1, 7, 5]  # sets 0 (unused), 1 (7 types), 2 (5 types)

COEF_FIELDS = [  # av1_default_<name>_cdfs: [4 q contexts] + dims, symbols
    ("txb_skip", (5, 13), 2), ("eob_extra", (5, 2, 9), 2), ("dc_sign", (2, 3), 2),
    ("eob_multi16", (2, 2), 5), ("eob_multi32", (2, 2), 6), ("eob_multi64", (2, 2), 7),
    ("eob_multi128", (2, 2), 8), ("eob_multi256", (2, 2), 9), ("eob_multi512", (2, 2), 10),
    ("eob_multi1024", (2, 2), 11), ("coeff_base_eob_multi", (5, 2, 4), 3),
    ("coeff_base_multi", (5, 2, 42), 4), ("coeff_lps_multi", (5, 2, 21), 4),
]
NMV_COMPONENT = [("classes", (), 11), ("class0_fp", (2,), 4), ("fp", (), 4), ("sign", (), 2),
                 ("class0_hp", (), 2), ("hp", (), 2), ("class0", (), 2), ("bits", (10,), 2)]

# TX sizes in libaom's order (TX_SIZES_ALL) as (width, height).
TX_SIZES = [(4, 4), (8, 8), (16, 16), (32, 32), (64, 64), (4, 8), (8, 4), (8, 16), (16, 8),
            (16, 32), (32, 16), (32, 64), (64, 32), (4, 16), (16, 4), (8, 32), (32, 8),
            (16, 64), (64, 16)]
ADJUSTED = {4: 3, 11: 3, 12: 3, 17: 9, 18: 10}


def default_lib(name: str = "libaom") -> str:
    import cv2
    libs = glob.glob(os.path.join(os.path.dirname(cv2.__file__), "..", "opencv_python.libs",
                                  f"{name}*.so*"))
    if not libs:
        raise SystemExit(f"no {name} next to cv2; pass --lib / --avif-lib")
    return libs[0]


LIBYUV = ("JPEG", "I601", "F709", "H709", "2020", "V2020")


def extract_libyuv(path: str) -> dict:
    """libyuv's kYuv*Constants (x86 layout: uint8 kUVToB[32], kUVToG[32],
    kUVToR[32], int16 kYToRgb[16], kYBiasToRgb[16]) as (ub, ug, vg, vr, yg,
    yb), from the libavif cv2 bundles (libyuv is linked into it)."""
    lib = Lib(path)
    out = {}
    for name in LIBYUV:
        a = lib.array(f"kYuv{name}Constants", np.uint8)
        if len(a) != 160:
            raise SystemExit(f"kYuv{name}Constants is not 160 bytes")
        i16 = a[96:].view(np.int16)
        k = (int(a[0]), int(a[32]), int(a[33]), int(a[65]), int(i16[0]), int(i16[16]))
        if a[1] or a[64] or not (0 < k[0] <= 128 and 0 < k[3] <= 128 and 16000 < k[4] < 20000):
            raise SystemExit(f"kYuv{name}Constants does not look like YuvConstants: {k}")
        out[name] = k
    return out


def extract_avif_kr_kb(path: str) -> tuple[dict, dict]:
    """libavif's kr / kb (avifCalcYUVCoefficients, called through ctypes on
    an empty avifImage whose colour primaries and matrix coefficients are
    set at their 1.x offsets 104 and 108): ({mc: (kr, kb)} for the matrix
    coefficients 0-255 but 12, {cp: (kr, kb)} for matrix coefficients 12,
    chroma-derived NCL, over the colour primaries 0-255); each as floats
    that are exactly the library's float32 values, and only where they
    differ from those of mc 2 / cp 2 (unspecified), which are also kept."""
    lib = Lib(path)
    dl = ctypes.CDLL(path)
    base = ctypes.cast(dl.avifImageCreateEmpty, ctypes.c_void_p).value - \
        lib.syms["avifImageCreateEmpty"][0][0]
    calc = ctypes.CFUNCTYPE(None, *[ctypes.c_void_p] * 4)(
        base + lib.syms["avifCalcYUVCoefficients"][0][0])
    dl.avifImageCreateEmpty.restype = ctypes.c_void_p
    dl.avifImageDestroy.argtypes = [ctypes.c_void_p]
    img = dl.avifImageCreateEmpty()
    r, g, b = ctypes.c_float(), ctypes.c_float(), ctypes.c_float()

    def krkb(cp: int, mc: int) -> tuple:
        ctypes.c_uint16.from_address(img + 104).value = cp
        ctypes.c_uint16.from_address(img + 108).value = mc
        calc(img, ctypes.addressof(r), ctypes.addressof(g), ctypes.addressof(b))
        return (r.value, b.value)
    try:
        by_mc = {mc: krkb(2, mc) for mc in range(256) if mc != 12}
        derived = {cp: krkb(cp, 12) for cp in range(256)}
    finally:
        dl.avifImageDestroy(img)
    if by_mc[1] != (float(np.float32(0.2126)), float(np.float32(0.0722))):
        raise SystemExit(f"avifCalcYUVCoefficients gives {by_mc[1]} for BT.709")
    return ({k: v for k, v in by_mc.items() if v != by_mc[2] or k == 2},
            {k: v for k, v in derived.items() if v != derived[2] or k == 2})


class Lib:
    def __init__(self, path: str):
        self.path = path
        self.elf = open(path, "rb").read()
        self.secs = sections(self.elf)
        _, so, ss = self.secs[".symtab"]
        _, sto, _ = self.secs[".strtab"]
        self.syms: dict = {}
        for k in range(0, ss, 24):
            nm, _, _, _, val, size = struct.unpack_from("<IBBHQQ", self.elf, so + k)
            end = self.elf.index(b"\0", sto + nm)
            self.syms.setdefault(self.elf[sto + nm:end].decode(), []).append((val, size))

    def array(self, name: str, dtype, k: int = 0) -> np.ndarray:
        if name not in self.syms:
            raise SystemExit(f"{name} is not in {os.path.basename(self.path)}'s symbol table")
        val, size = self.syms[name][k]
        for sec in (".rodata", ".data.rel.ro", ".data"):
            addr, off, sz = self.secs[sec]
            if addr <= val < addr + sz:
                return np.frombuffer(self.elf[off + val - addr:off + val - addr + size], dtype)
        raise SystemExit(f"{name} is not in a data section")

    def call_init_mode_probs(self) -> np.ndarray:
        lib = ctypes.CDLL(self.path)
        base = ctypes.cast(lib.aom_codec_version, ctypes.c_void_p).value - \
            self.syms["aom_codec_version"][0][0]
        fn = ctypes.CFUNCTYPE(None, ctypes.c_void_p)(base + self.syms["av1_init_mode_probs"][0][0])
        buf = (ctypes.c_uint16 * 16384)(*([MARK] * 16384))
        fn(ctypes.addressof(buf))
        return np.frombuffer(buf, np.uint16).astype(np.int64).copy()


def spec_cdf(icdf: np.ndarray, n: int, width: int, where: str) -> list:
    """One libaom CDF (width + 1 values, n symbols used) in the
    specification's form, checked."""
    e = [int(v) for v in icdf]
    if len(e) != width + 1:
        raise SystemExit(f"{where}: {len(e)} values for width {width}")
    if n == 1:  # an unused entry: all zero
        if any(e):
            raise SystemExit(f"{where}: unused entry is not zero")
        return [32768, 0]
    vals = e[:n]
    if vals[-1] != 0 or any(a <= b for a, b in zip(vals, vals[1:])) or vals[0] > 32768:
        raise SystemExit(f"{where}: not a decreasing inverted CDF ending in 0: {vals}")
    if any(e[n:]):
        raise SystemExit(f"{where}: counter or padding is not zero")
    return [32768 - v for v in vals] + [0]


def walk(values: np.ndarray, start: int, fields, where: str) -> tuple[dict, int]:
    out = {}
    pos = start
    for name, dims, n in fields:
        count = int(np.prod(dims)) if dims else 1
        if name is None:
            pos += dims[0]
            continue
        flat = []
        for k in range(count):
            syms = n
            if name == "partition":
                syms = PARTITION_SYMBOLS[k]
            elif name == "tx_depth":
                syms = TX_DEPTH_SYMBOLS[k // 3]
            elif name == "intra_tx_type":
                syms = INTRA_TX_SYMBOLS[k // (4 * 13)]
            elif name == "uv_mode":
                syms = 13 if k < 13 else 14
            elif name.startswith("palette_") and name.endswith("_color"):
                syms = k // 5 + 2
            elif name == "inter_tx_type":
                syms = [1, 16, 12, 2][k // 4]
            flat.append(spec_cdf(values[pos:pos + n + 1], syms, n, f"{where} {name}[{k}]"))
            pos += n + 1
        out[name] = nest(flat, dims)
    return out, pos


def nest(flat: list, dims: tuple):
    if not dims:
        return flat[0]
    step = len(flat) // dims[0]
    return [nest(flat[i * step:(i + 1) * step], dims[1:]) for i in range(dims[0])]


def extract_cdfs(lib: Lib) -> tuple[dict, dict]:
    fc = lib.call_init_mode_probs()
    written = np.nonzero(fc != MARK)[0]
    mode, end = walk(fc, 4045, MODE_FIELDS, "av1_init_mode_probs")
    if written.min() != 4045 or written.max() != end - 1:
        raise SystemExit(f"FRAME_CONTEXT walk ends at {end}, written "
                         f"{written.min()}-{written.max()}")
    nmv_raw = lib.array("default_nmv_context", np.uint16).astype(np.int64)
    nmv_fields = [("joints", (), 4)] + [(f"comp{c}_{n}", d, s) for c in range(2)
                                        for n, d, s in NMV_COMPONENT]
    nmv, end = walk(nmv_raw, 0, nmv_fields, "default_nmv_context")
    if end != len(nmv_raw):
        raise SystemExit("default_nmv_context size mismatch")
    mode["mv"] = nmv
    coef = {}
    for name, dims, n in COEF_FIELDS:
        raw = lib.array(f"av1_default_{name}_cdfs", np.uint16).astype(np.int64)
        per_q = len(raw) // 4
        if per_q != int(np.prod(dims)) * (n + 1):
            raise SystemExit(f"av1_default_{name}_cdfs: size {len(raw)}")
        coef[name] = [walk(raw, q * per_q, [(name, dims, n)], f"{name} q{q}")[0][name]
                      for q in range(4)]
    return mode, coef


def spec_order(table: np.ndarray, w: int, h: int) -> np.ndarray:
    """A libaom position table (column-major) as a raster one."""
    return np.asarray(table).reshape(w, h).T.reshape(-1)


def scan_to_raster(scan: np.ndarray, w: int, h: int) -> list:
    return [int((p % h) * w + p // h) for p in scan]


def construct_default_scan(w: int, h: int) -> list:
    """The specification's default scan: a zig-zag for squares, else
    anti-diagonals walked from the bottom left (wide) or the top right
    (tall) -- the direction libaom's tables follow."""
    out = []
    for d in range(w + h - 1):
        cells = [(r, d - r) for r in range(h) if 0 <= d - r < w]  # (row, col), row rising
        if w == h:
            if d % 2 == 0:
                cells = cells[::-1]
        elif w > h:
            cells = cells[::-1]
        out += [r * w + c for r, c in cells]
    return out


def extract_scans(lib: Lib) -> dict:
    scans = {}
    for t, (w, h) in enumerate(TX_SIZES):
        if w == 64 or h == 64:
            continue
        name = f"default_scan_{w}x{h}"
        raster = scan_to_raster(lib.array(name, np.int16), w, h)
        if sorted(raster) != list(range(w * h)):
            raise SystemExit(f"{name} is not a permutation")
        built = construct_default_scan(w, h)
        if raster != built:
            raise SystemExit(f"{name} differs from the construction: {raster[:12]} vs {built[:12]}")
        scans[(w, h)] = raster
        if w <= 16 and h <= 16:
            for kind in ("mrow", "mcol"):
                isc = lib.array(f"av1_{kind}_iscan_{w}x{h}", np.int16)
                order = np.argsort(isc)
                got = scan_to_raster(order, w, h)
                want = (list(range(w * h)) if kind == "mrow" else
                        [r * w + c for c in range(w) for r in range(h)])
                if got != want:
                    raise SystemExit(f"av1_{kind}_iscan_{w}x{h} is not a {kind[1:]} scan")
    return scans


def coeff_base_offset(w: int, h: int, r: int, c: int) -> int:
    """The specification's Coeff_Base_Ctx_Offset rule for position (r, c)."""
    if r == 0 and c == 0:
        return 0
    if w == h:
        return 1 if r + c == 1 else 6 if r + c <= 3 else 21
    if w > h:
        if c < 2:
            return 16
        return 6 if (r == 0 and c in (2, 3)) or (r == 1 and c == 2) else 21
    if r < 2:
        return 11
    return 6 if (r == 2 and c < 2) or (r == 3 and c == 0) else 21


def check_nz_offsets(lib: Lib) -> None:
    for name in lib.syms:
        if not name.startswith("av1_nz_map_ctx_offset_"):
            continue
        w, h = (int(v) for v in name.rsplit("_", 1)[1].split("x"))
        t = spec_order(lib.array(name, np.int8), min(w, 32), min(h, 32))
        ww = min(w, 32)
        for p, v in enumerate(t):
            if v != coeff_base_offset(w, h, min(p // ww, 4), min(p % ww, 4)):
                raise SystemExit(f"{name}[{p}] = {v} breaks the 5x5 rule")


def extract_qm(lib: Lib) -> bytes:
    """iwt_matrix_ref [15 levels][2 plane types][3344] in raster order per
    TX size (the sizes that are not adjusted, in TX_SIZES order)."""
    raw = lib.array("iwt_matrix_ref", np.uint8)
    if len(raw) != 15 * 2 * 3344:
        raise SystemExit("iwt_matrix_ref size")
    out = bytearray()
    for lvl in range(15):
        for pt in range(2):
            blk = raw[(lvl * 2 + pt) * 3344:(lvl * 2 + pt + 1) * 3344]
            at = 0
            for t, (w, h) in enumerate(TX_SIZES):
                if t in ADJUSTED:
                    continue
                out += bytes(spec_order(blk[at:at + w * h], w, h).astype(np.uint8))
                at += w * h
            assert at == 3344
    return bytes(out)


def extract(lib_path: str) -> dict:
    lib = Lib(lib_path)
    mode, coef = extract_cdfs(lib)
    check_nz_offsets(lib)
    q = {}
    for kind in ("dc", "ac"):
        for bd, suffix in ((8, ""), (10, "_10"), (12, "_12")):
            t = lib.array(f"{kind}_qlookup{suffix}_QTX", np.int16)
            if len(t) != 256 or any(np.diff(t.astype(int)) < 0):
                raise SystemExit(f"{kind}_qlookup{suffix}_QTX is not 256 rising values")
            q[(kind, bd)] = [int(v) for v in t]
    sw = lib.array("smooth_weights", np.uint8)
    if len(sw) != 124 or list(sw[:4]) != [255, 149, 85, 64]:
        raise SystemExit("smooth_weights")
    taps = lib.array("av1_filter_intra_taps", np.int8).reshape(5, 8, 8)
    if taps[:, :, 7].any():
        raise SystemExit("av1_filter_intra_taps: the eighth tap is not padding")
    ctx = lib.array("av1_palette_color_index_context_lookup", np.int32)
    sgr = lib.array("av1_sgr_params", np.int32).reshape(16, 4)  # {r[2], s[2]} per set
    if sgr[:, :2].max() > 2 or (sgr[:, 0] == 0).sum() + (sgr[:, 1] == 0).sum() != 6:
        raise SystemExit("av1_sgr_params: radii are not those of 16 sets, 6 with one off")
    upscale = lib.array("av1_resize_filter_normative", np.int16).reshape(64, 8)
    if (upscale.astype(int).sum(1) != 128).any() or list(upscale[0]) != [0, 0, 0, 128, 0, 0, 0, 0]:
        raise SystemExit("av1_resize_filter_normative: a phase's taps do not sum to 128")
    one_by_x = lib.array("av1_one_by_x", np.int32)
    x_by_xplus1 = lib.array("av1_x_by_xplus1", np.uint32)
    if len(one_by_x) != 25 or one_by_x[0] != 4096 or len(x_by_xplus1) != 256 or \
            x_by_xplus1[0] != 1 or x_by_xplus1[255] != 256 or any(np.diff(x_by_xplus1) < 0):
        raise SystemExit("av1_one_by_x / av1_x_by_xplus1")
    return dict(
        mode=mode, coef=coef, scans=extract_scans(lib), q=q, qm=extract_qm(lib),
        smooth=[int(v) for v in sw],
        derivative=[int(v) for v in lib.array("dr_intra_derivative", np.int16)],
        angle=[int(v) for v in lib.array("mode_to_angle_map", np.uint8)],
        taps=[[[int(v) for v in row[:7]] for row in mode_] for mode_ in taps],
        palette_ctx=[int(v) for v in ctx],
        sgr=[[int(v) for v in row] for row in sgr],
        upscale=[[int(v) for v in row] for row in upscale],
        one_by_x=[int(v) for v in one_by_x],
        x_by_xplus1=[int(v) for v in x_by_xplus1],
    )


def fmt(obj, indent: int = 4, width: int = 96) -> str:
    """A compact literal of nested lists of ints."""
    if len(repr(obj)) + indent + 2 <= width:
        return repr(obj)
    if isinstance(obj, list) and all(isinstance(v, int) for v in obj):
        rows, line = [], ""
        for v in obj:
            s = f"{v}, "
            if len(line) + len(s) + indent > width:
                rows.append(line.rstrip())
                line = ""
            line += s
        rows.append(line.rstrip())
        pad = " " * indent
        return "[\n" + "".join(f"{pad}{r}\n" for r in rows) + " " * (indent - 4) + "]"
    pad = " " * indent
    return "[\n" + "".join(f"{pad}{fmt(v, indent + 4, width)},\n" for v in obj) + \
        " " * (indent - 4) + "]"


HEADER = '''"""The constant tables of AV1 intra decoding, as libaom 3.14 holds them.
Written by `tools/extract_av1_tables.py` from the libaom cv2 bundles; do not
edit.  Section numbers are those of the AV1 Bitstream & Decoding Process
Specification (AOMedia, 2019, with errata).

CDFs are in the specification's form (section 4.10.11 / 8.2.6): a list of
the cumulative probabilities (x 32768) of the symbols, the last 32768,
followed by the adaptation counter 0.

    CDF_MODE           the default CDFs of section 9.3 (Default_*_Cdf) by
                       name: partition, kf_y_mode, uv_mode [cfl allowed][y
                       mode], angle_delta, intrabc, use_filter_intra,
                       filter_intra_mode, palette_y/uv_size, _color [size -
                       2][ctx], palette_y_mode, palette_uv_mode, cfl_sign,
                       cfl_alpha, tx_depth [cat][ctx], intra_tx_type [set]
                       [tx size][mode], segment_id, segment_pred, delta_q,
                       delta_lf(_multi), skip, mv (the intrabc vector's
                       CDFs), ... (the inter ones unused here)
    CDF_COEF           the coefficient CDFs of section 9.3 per quantiser
                       context (section 8.3.2 picks one by base_q_idx):
                       txb_skip, eob_extra, dc_sign, eob_multi16..1024,
                       coeff_base_eob_multi, coeff_base_multi, coeff_lps_multi
    DC_QLOOKUP,        Dc_Qlookup / Ac_Qlookup of section 7.12.2, by bit
    AC_QLOOKUP         depth (0: 8, 1: 10, 2: 12)
    QM_RAW             Quantizer_Matrix of section 7.12.3 (the inverse
                       weights libaom's dequantiser uses), as bytes: 15
                       levels x 2 plane types x 3344 values, each TX size
                       that is not adjusted in TX_SIZES_ALL order, in raster
                       order
    SCAN_DEFAULT       Default_Scan_WxH of section 7.12.3 (raster
                       positions), keyed by (width, height)
    SMOOTH_WEIGHTS     Sm_Weights_Tx_4x4 .. _64x64 of section 7.11.2.6, one
                       list
    DR_DERIVATIVE      Dr_Intra_Derivative of section 7.11.2.4
    MODE_TO_ANGLE      Mode_To_Angle of section 7.11.2
    FILTER_INTRA_TAPS  Filter_Intra_Taps [mode][8 positions][7 taps] of
                       section 7.11.2.3
    PALETTE_COLOR_CONTEXT  Palette_Color_Context of section 7.11.4 (by hash)
    SGR_PARAMS         Sgr_Params of section 7.17.3 in libaom's layout: per
                       set (r0, r1, s0, s1), a radius 0 meaning that pass is
                       off (s -1 there)
    UPSCALE_FILTER     Upscale_Filter of section 7.16: 64 phases x 8 taps
    ONE_BY_X           libaom's av1_one_by_x: round(4096 / n), n = 1 .. 25
    X_BY_XPLUS1        libaom's av1_x_by_xplus1: the self-guided filter's
                       a2 of section 7.17.3 by min(z, 255)
    LIBYUV_CONSTANTS   libyuv's YUV -> RGB constants (ub, ug, vg, vr, yg, yb)
                       by name (JPEG = BT.601 full range, I601 limited,
                       F709 / H709, V2020 / 2020), from the libavif cv2
                       bundles, for `avif_color.py`
    AVIF_KR_KB         libavif's (kr, kb) by matrix coefficients, where they
                       are not those of mc 2 (kept, the default), and
    AVIF_KR_KB_DERIVED for matrix coefficients 12 (chroma-derived NCL) by
                       colour primaries, where not those of cp 2 (kept):
                       float32 values, from avifCalcYUVCoefficients
"""

'''


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--lib", default=None)
    p.add_argument("--avif-lib", default=None)
    p.add_argument("--out", default=os.path.join(ROOT, "kgtpu_torch", "data", "av1_tables.py"))
    a = p.parse_args(argv)
    t = extract(a.lib or default_lib())
    yuv = extract_libyuv(a.avif_lib or default_lib("libavif"))
    parts = [HEADER]
    parts.append("CDF_MODE = {\n" + "".join(
        f"    {k!r}: {fmt(v, 8)},\n" for k, v in t["mode"].items() if k != "mv") + "}\n\n")
    parts.append("CDF_MV = {\n" + "".join(
        f"    {k!r}: {fmt(v, 8)},\n" for k, v in t["mode"]["mv"].items()) + "}\n\n")
    parts.append("CDF_COEF = {\n" + "".join(
        f"    {k!r}: {fmt(v, 8)},\n" for k, v in t["coef"].items()) + "}\n\n")
    for kind in ("dc", "ac"):
        table = fmt([t["q"][(kind, bd)] for bd in (8, 10, 12)])
        parts.append(f"{kind.upper()}_QLOOKUP = {table}\n\n")
    hexs = t["qm"].hex()
    parts.append("QM_RAW = bytes.fromhex(\n" + "".join(
        f'    "{hexs[i:i + 88]}"\n' for i in range(0, len(hexs), 88)) + ")\n\n")
    parts.append("SCAN_DEFAULT = {\n" + "".join(
        f"    {k!r}: {fmt(v, 8)},\n" for k, v in t["scans"].items()) + "}\n\n")
    parts.append(f"SMOOTH_WEIGHTS = {fmt(t['smooth'])}\n\n")
    parts.append(f"DR_DERIVATIVE = {fmt(t['derivative'])}\n\n")
    parts.append(f"MODE_TO_ANGLE = {t['angle']!r}\n\n")
    parts.append(f"FILTER_INTRA_TAPS = {fmt(t['taps'])}\n\n")
    parts.append(f"PALETTE_COLOR_CONTEXT = {t['palette_ctx']!r}\n\n")
    parts.append(f"SGR_PARAMS = {fmt(t['sgr'])}\n\n")
    parts.append(f"UPSCALE_FILTER = {fmt(t['upscale'])}\n\n")
    parts.append(f"ONE_BY_X = {fmt(t['one_by_x'])}\n\n")
    parts.append(f"X_BY_XPLUS1 = {fmt(t['x_by_xplus1'])}\n\n")
    parts.append("LIBYUV_CONSTANTS = {\n" + "".join(
        f"    {k!r}: {v!r},\n" for k, v in yuv.items()) + "}\n\n")
    by_mc, derived = extract_avif_kr_kb(a.avif_lib or default_lib("libavif"))
    for name, table in (("AVIF_KR_KB", by_mc), ("AVIF_KR_KB_DERIVED", derived)):
        parts.append(f"{name} = {{\n" + "".join(
            f"    {k!r}: {v!r},\n" for k, v in table.items()) + "}\n")
    with open(a.out, "w") as f:
        f.write("".join(parts))
    print(f"wrote {a.out} ({os.path.getsize(a.out)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
