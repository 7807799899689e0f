"""JPEG 2000 decoding without cv2 or OpenJPEG: NumPy only.  Returns what cv2
5.0's reader (`grfmt_jpeg2000_openjpeg.cpp`, `Jpeg2KOpjDecoder` over
OpenJPEG 2.5.3) returns, in cv2's channel order (BGR / BGRA); see
`data/imread.py` for the port's order.

The JP2 file (`jp2.c`): the signature box, then boxes up to the contiguous
codestream (jp2c); in jp2h the colour box (colr: method 1 with an
enumerated space; an ICC profile or any other method gives an "unknown"
space; only the first colr counts), a palette (pclr, 1-1024 entries) with
its component mapping (cmap, after pclr; a palette without one is
dropped) and channel definitions (cdef).  `opj_jp2_check_color`'s rules
hold (`_check_color`): the mapping names existing components and each
palette column once, cdef defines every channel, and a one-component
image whose mapping leaves a column unused maps column by column; then the
palette is applied and cdef's definitions, in turn, swap colour channels
into place (`_apply_jp2_color`).  A raw codestream (SOC then SIZ) has no
colour space either.

The codestream (`j2k.c`): SIZ, COD / COC, QCD / QCC (no quantisation,
scalar derived or expounded; guard bits), RGN (the max-shift ROI), POC,
PPM / PPT (packed packet headers), TLM / PLM / PLT / CRG / COM (skipped),
then tile-parts (SOT, their own COD / COC / QCD / QCC / RGN / POC / PPT,
SOD, data), then any marker (EOC).  OpenJPEG reads in strict mode for
cv2: a codestream cut anywhere (no two bytes after the last tile-part, a
tile-part or a code-block segment past the data) fails.  A tile's parts are joined and decoded by `data/j2k_t2.py`
(packets), `data/j2k_t1.py` (code-blocks) and `data/j2k_dwt.py`
(wavelets); then, as `tcd.c` does:

  * 5/3: each coefficient halved (C division), the reversible colour
    transform (g = y - ((u + v) >> 2), r = v + g, b = u + g) when COD asks
    for one and there are three components or more, plus 2^(prec - 1)
    (unsigned), clamped to the component's range;
  * 9/7: each coefficient times half the band's step size in float32 (the
    step (1 + mant / 2048) 2^(prec - expn) in double, then float32: no
    band gain, which the wavelet's 1.625732422 makes up), the irreversible
    colour transform in float32 (r = y + 1.402 v, g = y - 0.34413 u -
    0.71414 v, b = y + 1.772 u, each product rounded, no fused
    multiply-add), lrintf (half to even), the level shift and the clamp;
  * an ROI shift s: after tier-1, magnitudes of at least 2^s are shifted
    down by s.

cv2's rules, each checked against it:

  * the header must give 1 to 4 components, none of them signed;
    components must all be 1x1 subsampled and start at 0 (an image
    offset), or the read fails;
  * "unchanged" has the components' count of channels (two fail), 16 bits
    when a component has more than 8 bits of precision, else 8; "color"
    and "gray" are 8-bit with 3 and 1 channels; each sample is shifted
    right by (the largest precision - the output's bits), when positive,
    and cast;
  * sRGB, an unknown space (ICC, a raw codestream) and no colour box: BGR
    from the first three components (and the fourth as alpha in
    "unchanged"), grey as the first component when there are fewer than
    three, else cv2's fixed-point BGR->grey of the three; one or two
    components in "color" fail;
  * greyscale: the first component, as grey or three times;
  * sYCC: grey is the first component; BGR is cv2.cvtColor(YUV2BGR) of
    the first three (`_yuv_to_bgr`), also in "unchanged"; four components
    fail there; CMYK and e-sYCC fail; any other enumerated space is unknown;
  * no component of 8 bits or more, or one of more than 16 in "unchanged":
    the read fails; an image wider or taller than 2^20 or of more than 2^30
    pixels fails cv2's `validateInputImageSize` (which raises cv2.error
    out of imread; the port raises `UnreadableImage`).

Every code-block style of Part 1 is read, alone or mixed: BYPASS (raw
significance and refinement passes below the fourth bit-plane), RESET
(contexts reset after each pass), TERMALL (each pass its own segment), VSC
(stripe-causal contexts), PTERM (predictable termination, which OpenJPEG
does not check for cv2) and SEGSYM (segmentation symbols after each cleanup
pass); see `data/j2k_t1.py`.  HT code-blocks (Part 15, style 0x40, with any
other style bits but the mixed 0x80, which OpenJPEG refuses) are read as
OpenJPEG's `ht_dec.c` reads them, malformed ones refused where it stops
(`data/j2k_ht.py`; tier-2's HT segments in `data/j2k_t2.py`); Rsiz, CAP
and CPF change nothing.  Part 2's MCT / MCC / MCO (main or tile-part
headers) and CBD (main header) are read as `j2k.c` reads them: MCO's DC
level shifts and CBD's precisions reach the pixels, the custom matrices
never run (cv2 refuses a COD that asks for them); see `data/j2k_part2.py`.
Nothing of JPEG 2000 raises `UnsupportedImage`.
"""

from __future__ import annotations

import struct

import numpy as np

from kgtpu_torch.data import j2k_part2
from kgtpu_torch.data.imread import UnreadableImage
from kgtpu_torch.data.j2k_dwt import idwt
from kgtpu_torch.data.j2k_t1 import decode_blocks
from kgtpu_torch.data.j2k_t2 import ceildiv, read_packets, tile_component

JP2_SIGNATURE = b"\0\0\0\x0cjP  \r\n\x87\n"
SOC, SIZ, COD, COC, QCD, QCC, RGN, POC = 0xFF4F, 0xFF51, 0xFF52, 0xFF53, 0xFF5C, 0xFF5D, \
    0xFF5E, 0xFF5F
PPM, PPT, SOT, SOD, EOC = 0xFF60, 0xFF61, 0xFF90, 0xFF93, 0xFFD9
TLM, PLM, PLT, CRG, COM = 0xFF55, 0xFF57, 0xFF58, 0xFF63, 0xFF64
# The markers OpenJPEG knows (`j2k_memory_marker_handler_tab`) and where it
# takes them: the main header (after SIZ), a tile-part header, or both
# (SOP nowhere; SOD and EOC are not in the table).  CAP and CPF are
# skipped; MCT / MCC / MCO (both) and CBD (main only) carry Part 2's
# multi-component markers (`data/j2k_part2.py`).
PART2 = {j2k_part2.MCT, j2k_part2.MCC, j2k_part2.MCO}
MAIN_ONLY = {TLM, PLM, PPM, CRG, 0xFF50, 0xFF59, j2k_part2.CBD}
TILE_ONLY = {PLT, PPT}
BOTH = {COD, COC, RGN, QCD, QCC, POC, COM} | PART2
KNOWN = MAIN_ONLY | TILE_ONLY | BOTH | {SIZ, SOT, 0xFF91}
HT = 0x40                                # HT code-blocks (Part 15), `data/j2k_ht.py`
SRGB, GRAY, SYCC, UNKNOWN = "sRGB", "grey", "sYCC", "unknown"


def _boxes(data: bytes, pos: int, end: int):
    """(type, body) of each box from `pos`.  As `opj_jp2_read_boxhdr`: a
    length of 0 runs to the end, 1 has a 64-bit length (whose upper half
    must be 0); the codestream box runs to the end whatever its length."""
    while pos + 8 <= end:
        size, typ = struct.unpack(">I4s", data[pos:pos + 8])
        head = 8
        if size == 1:
            hi, size = struct.unpack(">II", data[pos + 8:pos + 16])
            if hi:
                raise UnreadableImage(f"JP2 box {typ!r} of a length over 2^32")
            head = 16
        elif size == 0:
            size = end - pos
        if typ == b"jp2c":
            yield typ, data[pos + head:end]
            return
        if size < head or pos + size > end:
            raise UnreadableImage(f"JP2 box {typ!r} of size {size} (its length is inconsistent)")
        yield typ, data[pos + head:pos + size]
        pos += size


def read_jp2(data: bytes) -> tuple[bytes, dict]:
    """The codestream of a JP2 file and its colour information, with the
    checks of `opj_jp2_read_header`: the file type box second, a jp2h with
    an ihdr of 1 to 16384 components before the codestream, a colr box of
    at least 3 bytes (7 for an enumerated space)."""
    color = {"space": UNKNOWN, "pclr": None, "cmap": None, "cdef": None, "ihdr": None}
    seen_colr = header = False
    for k, (typ, body) in enumerate(_boxes(data, 12, len(data))):
        if k == 0 and typ != b"ftyp":
            raise UnreadableImage("JP2 file whose second box is not the file type box")
        if typ == b"jp2h":
            header = True
            for t2, b2 in _boxes(body, 0, len(body)):
                if t2 == b"ihdr":
                    if len(b2) != 14:
                        raise UnreadableImage("JP2 ihdr box of a bad size")
                    h, w, nc = struct.unpack(">IIH", b2[:10])
                    if not 1 <= nc <= 16384:
                        raise UnreadableImage("JP2 ihdr with an invalid number of components")
                    color["ihdr"] = (w, h)
                elif t2 == b"colr" and not seen_colr:
                    if len(b2) < 3 or b2[0] == 1 and len(b2) < 7:
                        raise UnreadableImage("JP2 colr box of a bad size")
                    seen_colr = True
                    if b2[0] == 1:
                        (cs,) = struct.unpack(">I", b2[3:7])
                        color["space"] = {16: SRGB, 17: GRAY, 18: SYCC, 12: "CMYK",
                                          24: "e-sYCC"}.get(cs, UNKNOWN)
                elif t2 == b"pclr":
                    ne, npc = struct.unpack(">HB", b2[:3])
                    if not 0 < ne <= 1024 or npc == 0:
                        raise UnreadableImage("JP2 pclr box of no entries or columns")
                    bits = list(b2[3:3 + npc])
                    at, cols = 3 + npc, []
                    for _ in range(ne):
                        row = []
                        for b in bits:
                            nb = ((b & 0x7F) + 8) // 8
                            row.append(int.from_bytes(b2[at:at + nb], "big"))
                            at += nb
                        cols.append(row)
                    color["pclr"] = {"prec": [(b & 0x7F) + 1 for b in bits],
                                     "entries": np.array(cols, np.int64).reshape(ne, npc)}
                elif t2 == b"cmap":
                    if color["pclr"] is None:
                        raise UnreadableImage("JP2 cmap box before its pclr box")
                    color["cmap"] = [struct.unpack(">HBB", b2[k:k + 4])
                                     for k in range(0, len(b2) - 3, 4)]
                elif t2 == b"cdef":
                    (n,) = struct.unpack(">H", b2[:2])
                    color["cdef"] = [struct.unpack(">HHH", b2[2 + 6 * k:8 + 6 * k])
                                     for k in range(n)]
            if color["ihdr"] is None:
                raise UnreadableImage("JP2 header box without an ihdr box")
        elif typ == b"jp2c":
            if not header:
                raise UnreadableImage("JP2 codestream before its header box")
            return body, color
    raise UnreadableImage("JP2 file without a codestream box")


def _spcod(seg: bytes, i: int, prc: bool) -> dict:
    """SPcod / SPcoc from seg[i], which must end the segment
    (`opj_j2k_read_SPCod_SPCoc`'s checks)."""
    if i + 5 > len(seg):
        raise UnreadableImage("JPEG 2000 COD / COC is cut short")
    numres, cw, ch, sty, qmf = seg[i] + 1, seg[i + 1] + 2, seg[i + 2] + 2, seg[i + 3], seg[i + 4]
    if numres > 33 or cw > 10 or ch > 10 or cw + ch > 12:
        raise UnreadableImage("JPEG 2000 code-block or resolution count out of range")
    if qmf > 1 or sty & 0x80:
        raise UnreadableImage("JPEG 2000 transform or mixed-HT code-block style OpenJPEG "
                              "refuses")
    if len(seg) != i + 5 + (numres if prc else 0):
        raise UnreadableImage("JPEG 2000 COD / COC of the wrong length")
    if prc:
        ps = list(seg[i + 5:i + 5 + numres])
        if len(ps) < numres or any(r and (p & 15 == 0 or p >> 4 == 0) for r, p in enumerate(ps)):
            raise UnreadableImage("JPEG 2000 precinct sizes")
        pw, ph = [p & 15 for p in ps], [p >> 4 for p in ps]
    else:
        pw, ph = [15] * numres, [15] * numres
    return {"numres": numres, "cblkw": cw, "cblkh": ch, "style": sty, "qmfbid": qmf,
            "prcw": pw, "prch": ph}


def _sqcd(seg: bytes, i: int) -> dict:
    sq = seg[i]
    guard, style = sq >> 5, sq & 0x1F
    body = seg[i + 1:]
    if style == 1 and len(body) != 2 or style > 1 and len(body) % 2:
        raise UnreadableImage("JPEG 2000 QCD / QCC of the wrong length")
    if style == 0:
        steps = [(b >> 3, 0) for b in body]
    else:                               # OpenJPEG reads any other style as expounded
        vals = [struct.unpack(">H", body[k:k + 2])[0] for k in range(0, len(body) - 1, 2)]
        steps = [(v >> 11, v & 0x7FF) for v in vals]
        if style == 1:
            e0, m0 = steps[0]
            steps = [(e0, m0)] + [(max(e0 - (b - 1) // 3, 0), m0) for b in range(1, 97)]
    return {"guard": guard, "steps": steps}


def _check_lengths(m: int, seg: bytes) -> None:
    """OpenJPEG's checks of the length markers it otherwise ignores: TLM
    and PLM must hold their index (TLM entries that do not fill the
    segment only warn), and PLT's packet lengths (7 bits a byte, the top
    bit to continue) must end."""
    if m in (TLM, PLM, PLT) and not seg or m == PLT and seg[-1] & 0x80 and len(seg) > 1:
        raise UnreadableImage(f"JPEG 2000 marker {m:04x} OpenJPEG cannot read")


class Codestream:
    """The parsed codestream: the image size, the main header's defaults and
    each tile's parts."""

    def __init__(self, cs: bytes):
        if cs[:4] != b"\xff\x4f\xff\x51":
            raise UnreadableImage("JPEG 2000 codestream without SOC and SIZ")
        self.cs = cs
        (lsiz,) = struct.unpack(">H", cs[4:6])
        siz = cs[6:4 + lsiz]
        if len(siz) < 36:
            raise UnreadableImage("JPEG 2000 SIZ is cut short")
        (self.rsiz, self.X, self.Y, self.X0, self.Y0, self.TW, self.TH, self.TX0, self.TY0,
         nc) = struct.unpack(">HIIIIIIIIH", siz[:36])
        if nc == 0 or nc > 16384 or lsiz != 38 + 3 * nc or len(siz) < 36 + 3 * nc:
            raise UnreadableImage("JPEG 2000 SIZ component count or length")
        self.comps = [{"prec": (siz[36 + 3 * k] & 0x7F) + 1, "sgnd": siz[36 + 3 * k] >> 7,
                       "dx": siz[37 + 3 * k], "dy": siz[38 + 3 * k]} for k in range(nc)]
        if (self.X <= self.X0 or self.Y <= self.Y0 or self.TW == 0 or self.TH == 0
                or self.TX0 > self.X0 or self.TY0 > self.Y0
                or self.TX0 + self.TW <= self.X0 or self.TY0 + self.TH <= self.Y0
                or any(c["dx"] == 0 or c["dy"] == 0 or c["prec"] > 31 for c in self.comps)):
            raise UnreadableImage("JPEG 2000 SIZ out of range")
        self.ntx = ceildiv(self.X - self.TX0, self.TW)
        self.nty = ceildiv(self.Y - self.TY0, self.TH)
        if self.ntx * self.nty > 65535:
            raise UnreadableImage("JPEG 2000 of more than 65535 tiles")
        self.main = {"cod": None, "coc": {}, "qcd": None, "qcc": {}, "rgn": {}, "poc": [],
                     "ppm": [], "p2": j2k_part2.Part2([0 if c["sgnd"] else 1 << (c["prec"] - 1)
                                                      for c in self.comps])}
        self.tiles: dict[int, dict] = {}
        self.parts: list[int] = []              # the tile of each tile-part, in order
        self._markers(4 + lsiz)

    def _cnum(self, seg: bytes, i: int) -> tuple[int, int]:
        if len(self.comps) < 257:
            return seg[i], i + 1
        return struct.unpack(">H", seg[i:i + 2])[0], i + 2

    def _header_marker(self, m: int, seg: bytes, h: dict) -> None:
        if m == COD:
            if len(seg) < 5:
                raise UnreadableImage("JPEG 2000 COD is cut short")
            scod, order, layers, mct = seg[0], seg[1], struct.unpack(">H", seg[2:4])[0], seg[4]
            if order > 4 or layers == 0 or mct > 1 or scod & ~7:
                raise UnreadableImage("JPEG 2000 COD progression, layers or colour transform")
            h["cod"] = {"sop": scod & 2, "eph": scod & 4, "order": order, "layers": layers,
                        "mct": mct, "comp": _spcod(seg, 5, bool(scod & 1))}
            h["coc"] = {}
        elif m == COC:
            c, i = self._cnum(seg, 0)
            h["coc"][c] = _spcod(seg, i + 1, bool(seg[i] & 1))
        elif m == QCD:
            h["qcd"] = _sqcd(seg, 0)
            h["qcc"] = {}
        elif m == QCC:
            c, i = self._cnum(seg, 0)
            h["qcc"][c] = _sqcd(seg, i)
        elif m == RGN:
            c, i = self._cnum(seg, 0)
            if seg[i] != 0:
                raise UnreadableImage("JPEG 2000 RGN style")
            h["rgn"][c] = seg[i + 1]
        elif m == POC:
            wide = len(self.comps) >= 257
            n = 9 if wide else 7
            for k in range(0, len(seg) - n + 1, n):
                e = seg[k:k + n]
                if wide:
                    r0, c0, l1, r1, c1, p = struct.unpack(">BHHBHB", e)
                else:
                    r0, c0, l1, r1, c1, p = struct.unpack(">BBHBBB", e)
                h["poc"].append({"res0": r0, "comp0": c0, "lay1": l1, "res1": r1,
                                 "comp1": c1 or 256, "prog": p})
        elif m == PPM:
            h["ppm"].append((seg[0], seg[1:]))
        elif m == PPT:
            h["ppt"].append((seg[0], seg[1:]))

    def _next_known(self, pos: int, allowed: set) -> int:
        """`opj_j2k_read_unk`: after an unknown marker in the main header,
        step two bytes at a time to the next marker OpenJPEG knows; it must
        be one `allowed` where it stands."""
        cs, end = self.cs, len(self.cs)
        while pos + 2 <= end:
            (m,) = struct.unpack(">H", cs[pos:pos + 2])
            if m >= 0xFF00 and m in KNOWN:
                if m not in allowed:
                    raise UnreadableImage(f"JPEG 2000 marker {m:04x} out of its place")
                return pos
            pos += 2
        raise UnreadableImage("JPEG 2000 codestream ends after an unknown marker")

    def _markers(self, pos: int) -> None:
        """The main header's markers, then the tile-parts.  As OpenJPEG
        reads them: after each tile-part it reads the next two bytes, which
        must be there (strict mode); SOT goes on (or ends the codestream
        once every tile has its TNsot parts), EOC or two last bytes of
        anything end it, anything else fails."""
        cs, end = self.cs, len(self.cs)
        main = MAIN_ONLY | BOTH | {SOT}
        while True:
            if pos + 2 > end:
                raise UnreadableImage("JPEG 2000 codestream is cut short (no tile-part)")
            (m,) = struct.unpack(">H", cs[pos:pos + 2])
            if m < 0xFF00:
                raise UnreadableImage(f"JPEG 2000 marker expected, {m:04x} found")
            if m not in KNOWN:
                pos = self._next_known(pos + 2, main)
                continue
            if m not in main:
                raise UnreadableImage(f"JPEG 2000 marker {m:04x} in the main header")
            if m == SOT:
                break
            if pos + 4 > end:
                raise UnreadableImage("JPEG 2000 codestream is cut short")
            (length,) = struct.unpack(">H", cs[pos + 2:pos + 4])
            if length < 2 or pos + 2 + length > end:
                raise UnreadableImage(f"JPEG 2000 marker {m:04x} longer than the stream")
            if m in (COD, COC, QCD, QCC, RGN, POC, PPM):
                self._header_marker(m, cs[pos + 4:pos + 2 + length], self.main)
            if m == CRG and length - 2 != 4 * len(self.comps):
                raise UnreadableImage("JPEG 2000 CRG marker of a wrong length")
            _check_lengths(m, cs[pos + 4:pos + 2 + length])
            self._part2(m, cs[pos + 4:pos + 2 + length], self.main["p2"])
            pos += 2 + length
        while True:
            pos = self._tile_part(pos)
            if pos + 2 > end:
                raise UnreadableImage("JPEG 2000 codestream is cut short (no marker after its "
                                      "last tile-part)")
            if cs[pos:pos + 2] == b"\xff\xd9" or pos + 2 == end:
                return                          # EOC, or two last bytes of anything
            if cs[pos:pos + 2] == b"\xff\x90":
                if len(self.tiles) == self.ntx * self.nty and all(
                        len(t["data"]) == t["tnsot"] for t in self.tiles.values()):
                    return                      # every tile complete: OpenJPEG stops
                continue
            raise UnreadableImage("JPEG 2000 tile-part followed by neither SOT, EOC nor the "
                                  "end of the data")

    def _tile_part(self, pos: int) -> int:
        cs, end = self.cs, len(self.cs)
        if self.main["cod"] is None or self.main["qcd"] is None:
            raise UnreadableImage("JPEG 2000 main header without COD or QCD")
        if pos + 12 > end or cs[pos + 2:pos + 4] != b"\0\x0a":
            raise UnreadableImage("JPEG 2000 SOT of a wrong length")
        isot, psot, tpsot, tnsot = struct.unpack(">HIBB", cs[pos + 4:pos + 12])
        if isot >= self.ntx * self.nty:
            raise UnreadableImage("JPEG 2000 tile index out of range")
        if psot == 0:                  # to the end, but for the marker after it
            part_end = end - 2
        elif psot < 14 or pos + psot > end:
            raise UnreadableImage("JPEG 2000 tile-part length past the end of the data")
        else:
            part_end = pos + psot
        if isot not in self.tiles:
            self.tiles[isot] = {"cod": None, "coc": {}, "qcd": None, "qcc": {}, "rgn": {},
                                "poc": [], "ppt": [], "data": [], "p2": self.main["p2"].copy()}
        t = self.tiles[isot]
        if tpsot != len(t["data"]):
            raise UnreadableImage(f"JPEG 2000 tile-part {tpsot} of tile {isot} out of order")
        t["tnsot"] = tnsot or t.get("tnsot", 0)
        first = not t["data"] and t["cod"] is None
        tile = TILE_ONLY | BOTH | {SOD}
        p = pos + 12
        while True:
            if p + 2 > part_end:
                raise UnreadableImage("JPEG 2000 tile-part without SOD")
            (m,) = struct.unpack(">H", cs[p:p + 2])
            if m < 0xFF00:
                raise UnreadableImage(f"JPEG 2000 marker expected, {m:04x} found")
            if m not in tile:                   # OpenJPEG fails on any unknown one here
                raise UnreadableImage(f"JPEG 2000 marker {m:04x} in a tile-part header")
            if m == SOD:
                p += 2
                break
            if p + 4 > part_end:
                raise UnreadableImage("JPEG 2000 tile-part header is cut short")
            (length,) = struct.unpack(">H", cs[p + 2:p + 4])
            if length < 2 or p + 2 + length > part_end:
                raise UnreadableImage("JPEG 2000 marker longer than its tile-part")
            body = cs[p + 4:p + 2 + length]
            if m in (COD, COC, QCD, QCC, RGN) and first:
                self._header_marker(m, body, t)
            elif m in (POC, PPT):
                self._header_marker(m, body, t)
            _check_lengths(m, body)
            self._part2(m, body, t["p2"])
            p += 2 + length
        t["data"].append(cs[p:part_end])
        self.parts.append(isot)
        return part_end

    def _part2(self, m: int, seg: bytes, st: j2k_part2.Part2) -> None:
        if m == j2k_part2.MCT:
            j2k_part2.read_mct(st, seg)
        elif m == j2k_part2.MCC:
            j2k_part2.read_mcc(st, seg)
        elif m == j2k_part2.MCO:
            j2k_part2.read_mco(st, seg, len(self.comps))
        elif m == j2k_part2.CBD:
            j2k_part2.read_cbd(self.comps, seg)

    def params(self, t: dict, c: int) -> tuple[dict, dict, int]:
        """The coding, quantisation and ROI shift of component c in tile t."""
        m = self.main
        cod = t["coc"].get(c) or (t["cod"] or {}).get("comp") or m["coc"].get(c) \
            or m["cod"]["comp"]
        qcd = t["qcc"].get(c) or t["qcd"] or m["qcc"].get(c) or m["qcd"]
        return cod, qcd, t["rgn"].get(c, m["rgn"].get(c, 0))


def _ppm_headers(cs: Codestream) -> dict:
    """Packed headers of the main header, per tile, in tile-part order."""
    stream = b"".join(body for _, body in sorted(cs.main["ppm"], key=lambda z: z[0]))
    chunks, at = [], 0
    while at + 4 <= len(stream):
        (n,) = struct.unpack(">I", stream[at:at + 4])
        chunks.append(stream[at + 4:at + 4 + n])
        at += 4 + n
    out: dict = {}
    for k, tno in enumerate(cs.parts):
        out[tno] = out.get(tno, b"") + (chunks[k] if k < len(chunks) else b"")
    return out


def _tile_bounds(cs: Codestream, tno: int) -> tuple:
    p, q = tno % cs.ntx, tno // cs.ntx
    return (max(cs.TX0 + p * cs.TW, cs.X0), max(cs.TY0 + q * cs.TH, cs.Y0),
            min(cs.TX0 + (p + 1) * cs.TW, cs.X), min(cs.TY0 + (q + 1) * cs.TH, cs.Y))


def _stepsize(expn: int, mant: int, prec: int) -> np.float32:
    return np.float32((1.0 + mant / 2048.0) * 2.0 ** (prec - expn))


def tile_packets(cs: Codestream, tno: int, ppm: dict, spans: list | None = None):
    """Tier-2 of tile `tno`: its bounds, COD, components (resolutions,
    bands, precincts, code-blocks holding their data) and each component's
    highest resolution among its packets.  `ppm`: the main header's packed
    headers per tile; `spans` as `read_packets` takes it."""
    t = cs.tiles[tno]
    tb = _tile_bounds(cs, tno)
    cod = t["cod"] or cs.main["cod"]
    comps, styles = [], []
    for c in range(len(cs.comps)):
        cp, qp, _ = cs.params(t, c)
        comps.append(tile_component(*tb, cp, qp))
        styles.append(cp["style"])
    headers = None
    if t["ppt"]:
        headers = b"".join(body for _, body in sorted(t["ppt"], key=lambda z: z[0]))
    elif tno in ppm:
        headers = ppm[tno]
    resno = read_packets(b"".join(t["data"]), headers, comps, tb, cod, cod["layers"],
                         t["poc"] or cs.main["poc"], styles, spans)
    return tb, cod, comps, resno


def decode_codestream(cs: Codestream) -> list:
    """Every component of the image as int32 [h, w] (tiles never seen stay 0)."""
    ncomp = len(cs.comps)
    h, w = cs.Y - cs.Y0, cs.X - cs.X0
    planes = [np.zeros((h, w), np.int32) for _ in range(ncomp)]
    ppm = _ppm_headers(cs) if cs.main["ppm"] else {}
    tiles, blocks = [], []
    resno = [0] * ncomp               # OpenJPEG's resno_decoded, a running max over tiles
    for tno in sorted(cs.tiles):
        tb, cod, comps, got = tile_packets(cs, tno, ppm)
        resno = [max(a, b) for a, b in zip(resno, got)]
        for c in range(ncomp):
            cp, _, roi = cs.params(cs.tiles[tno], c)
            for res in comps[c]:
                for band in res.bands:
                    for prc in band.precincts:
                        for cb in prc["cblks"]:
                            ht = cp["style"] & HT
                            if not ht and cb.included and cb.numbps + roi >= 31:
                                raise UnreadableImage("JPEG 2000 code-block of 31 bit-planes "
                                                      "or more (OpenJPEG refuses it)")
                            if ht and roi:
                                raise UnreadableImage("JPEG 2000 HT code-blocks with an ROI "
                                                      "shift (OpenJPEG refuses them)")
                            if cb.passes:
                                blocks.append({"w": cb.x1 - cb.x0, "h": cb.y1 - cb.y0,
                                               "orient": band.orient, "passes": cb.passes,
                                               "numbps": cb.numbps + roi, "mb": cb.numbps,
                                               "Mb": band.numbps if cb.included else 0,
                                               "roi": roi, "style": cp["style"],
                                               "base": cb.at if cb.pieces == 1 else 0,
                                               "data": b"".join(cb.chunks),
                                               "segs": [(n, ln) for _, n, ln in cb.segs],
                                               "cb": cb})
        tiles.append((tno, tb, cod, comps,
                      [min(r, len(comps[c]) - 1) for c, r in enumerate(resno)]))
    coefs = decode_blocks(blocks)
    for b, coef in zip(blocks, coefs):
        b["cb"].coef = coef
    for tno, tb, cod, comps, rd in tiles:
        _reconstruct(cs, cs.tiles[tno], tb, cod, comps, rd, planes)
    return planes


def _reconstruct(cs: Codestream, t: dict, tb: tuple, cod: dict, comps: list, rd: list,
                 planes: list) -> None:
    """Dequantise, inverse-transform and write one tile.  A component whose
    packets stop below its top resolution (`rd`, a POC that leaves the top
    out) is reconstructed as OpenJPEG does: the wavelet up to that
    resolution, the colour transform (refused where the three components
    stop at different resolutions), the level shift and clamp over the
    reduced image, which lands at its reduced origin; the rest of the
    output stays 0."""
    tw, th = tb[2] - tb[0], tb[3] - tb[1]
    bufs, revs = [], []
    for c, res_list in enumerate(comps):
        cp, qp, roi = cs.params(t, c)
        rev = cp["qmfbid"] == 1
        prec = cs.comps[c]["prec"]
        buf = np.zeros((th, tw), np.int64 if rev else np.float32)
        for r, res in enumerate(res_list):
            prev = res_list[r - 1] if r else None
            for band in res.bands:
                ox = prev.x1 - prev.x0 if band.orient & 1 else 0
                oy = prev.y1 - prev.y0 if band.orient & 2 else 0
                half = np.float32(0.5) * _stepsize(band.expn, band.mant, prec)
                for prc in band.precincts:
                    for cb in prc["cblks"]:
                        if not cb.passes:
                            continue
                        v = cb.coef.astype(np.int64)
                        if roi:
                            mag = np.abs(v)
                            big = mag >= (1 << roi)
                            v = np.where(big, np.sign(v) * (mag >> roi), v)
                        x, y = cb.x0 - band.x0 + ox, cb.y0 - band.y0 + oy
                        if rev:
                            buf[y:y + v.shape[0], x:x + v.shape[1]] = np.sign(v) * (np.abs(v) >> 1)
                        else:
                            buf[y:y + v.shape[0], x:x + v.shape[1]] = \
                                v.astype(np.float32) * half
        sizes = [(res.x0, res.y0, res.x1, res.y1) for res in res_list[:rd[c] + 1]]
        bufs.append(idwt(buf, sizes, rev))
        revs.append(rev)
    out_res = [res_list[rd[c]] for c, res_list in enumerate(comps)]
    bufs = [b[:r.y1 - r.y0, :r.x1 - r.x0] for b, r in zip(bufs, out_res)]
    if cod["mct"] and len(bufs) >= 3:
        if rd[0] != rd[1] or rd[0] != rd[2] or bufs[0].size != bufs[1].size or \
                bufs[0].size != bufs[2].size:
            raise UnreadableImage("JPEG 2000 colour transform over components decoded to "
                                  "different resolutions (OpenJPEG refuses it)")
        y, u, v = bufs[0], bufs[1], bufs[2]
        if revs[0]:
            g = y - ((u + v) >> 2)
            bufs[0], bufs[1], bufs[2] = v + g, g, u + g
        else:
            r = y + v * np.float32(1.402)
            g = y - u * np.float32(0.34413) - v * np.float32(0.71414)
            b = y + u * np.float32(1.772)
            bufs[0], bufs[1], bufs[2] = r, g, b
    for c, buf in enumerate(bufs):
        res = out_res[c]
        comp = cs.comps[c]
        prec, sgnd = comp["prec"], comp["sgnd"]
        lo, hi = (-(1 << (prec - 1)), (1 << (prec - 1)) - 1) if sgnd else (0, (1 << prec) - 1)
        out = j2k_part2.level_shift(buf, t["p2"].dc[c], lo, hi)
        planes[c][res.y0 - cs.Y0:res.y1 - cs.Y0, res.x0 - cs.X0:res.x1 - cs.X0] = out


def _check_color(n: int, color: dict) -> None:
    """opj_jp2_check_color: a palette's mapping and the channel definitions
    must name components that exist, each palette column once; cdef must
    define every channel.  A one-component image whose mapping leaves a
    palette column unused is mapped column by column instead."""
    pclr, cmap = color["pclr"], color["cmap"]
    if pclr is not None and cmap is not None:
        npc = pclr["entries"].shape[1]
        cmap = cmap[:npc]
        if len(cmap) < npc or any(c >= n for c, _, _ in cmap):
            raise UnreadableImage("JP2 cmap names a missing component")
        used = [False] * npc
        for i, (_, mtyp, pcol) in enumerate(cmap):
            if mtyp not in (0, 1) or pcol >= npc or mtyp == 1 and pcol != i or \
                    mtyp == 0 and pcol != 0 or mtyp == 1 and used[pcol]:
                raise UnreadableImage("JP2 cmap is not a mapping OpenJPEG takes")
            used[pcol] = used[pcol] or mtyp == 1
        if any(not used[i] and cmap[i][1] != 0 for i in range(npc)):
            raise UnreadableImage("JP2 palette column without a mapping")
        if n == 1 and not all(used):
            cmap = [(c, 1, i) for i, (c, _, _) in enumerate(cmap)]
        color["cmap"] = cmap
    if color["cdef"]:
        nch = pclr["entries"].shape[1] if pclr is not None and cmap is not None else n
        for cn, _, asoc in color["cdef"]:
            if cn >= nch or asoc not in (0, 65535) and asoc - 1 >= nch:
                raise UnreadableImage("JP2 cdef names a missing channel")
        if not all(any(cn == k for cn, _, _ in color["cdef"]) for k in range(nch)):
            raise UnreadableImage("JP2 cdef does not define every channel")


def _apply_jp2_color(planes: list, precs: list, color: dict) -> tuple[list, list]:
    """opj_jp2_apply_pclr (each mapped channel takes its palette column's
    precision; indices are clamped to the palette) and opj_jp2_apply_cdef
    (for each definition in turn, a colour channel whose association names
    another channel swaps places with it, and later definitions follow the
    swap)."""
    pclr, cmap = color["pclr"], color["cmap"]
    if pclr is not None and cmap is not None:
        ent = pclr["entries"]
        new_p, new_prec = [], []
        for i, (c, mtyp, pcol) in enumerate(cmap):
            if mtyp == 0:
                new_p.append(planes[c])
            else:
                new_p.append(ent[np.clip(planes[c], 0, len(ent) - 1), pcol].astype(np.int32))
            new_prec.append(pclr["prec"][i])
        planes, precs = new_p, new_prec
    if color["cdef"]:
        planes, precs = list(planes), list(precs)
        info = [list(d) for d in color["cdef"]]
        for i, (cn, typ, asoc) in enumerate(info):
            if asoc in (0, 65535) or cn >= len(planes) or asoc - 1 >= len(planes):
                continue
            acn = asoc - 1
            if cn != acn and typ == 0:
                planes[cn], planes[acn] = planes[acn], planes[cn]
                precs[cn], precs[acn] = precs[acn], precs[cn]
                for d in info[i + 1:]:
                    if d[0] == cn:
                        d[0] = acn
                    elif d[0] == acn:
                        d[0] = cn
    return planes, precs


def _yuv_to_bgr(y: np.ndarray, u: np.ndarray, v: np.ndarray, depth: int) -> np.ndarray:
    """cv2.cvtColor(COLOR_YUV2BGR) in fixed point (`YCrCb2RGB_i`, 14 bits):
    b = y + 2.032 (u - d), g = y - 0.395 (u - d) - 0.581 (v - d), r = y +
    1.140 (v - d), d half the range, each term rounded, saturated."""
    d = 1 << (depth - 1)
    y, u, v = (c.astype(np.int64) for c in (y, u, v))
    u, v = u - d, v - d
    b = y + ((u * 33292 + 8192) >> 14)
    g = y + ((u * -6472 + v * -9519 + 8192) >> 14)
    r = y + ((v * 18678 + 8192) >> 14)
    dt = np.uint8 if depth == 8 else np.uint16
    return np.clip(np.stack([b, g, r], -1), 0, (1 << depth) - 1).astype(dt)


def _gray(b: np.ndarray, g: np.ndarray, r: np.ndarray) -> np.ndarray:
    from kgtpu_torch.data.pnm import cvt_gray
    return cvt_gray(np.stack([b, g, r], -1))


def decode_jpeg2000(data: bytes, mode: str) -> np.ndarray:
    """The bytes of a JP2 file or a raw codestream as cv2 returns them."""
    try:
        if data[:12] == JP2_SIGNATURE:
            cs_bytes, color = read_jp2(data)
        else:
            cs_bytes, color = data, {"space": UNKNOWN, "pclr": None, "cmap": None, "cdef": None,
                                     "ihdr": None}
        cs = Codestream(cs_bytes)
    except (struct.error, IndexError) as e:         # a box or marker cut short
        raise UnreadableImage(f"malformed JPEG 2000 header: {e}") from None
    w, h = cs.X - cs.X0, cs.Y - cs.Y0
    if color.get("ihdr") not in (None, (w, h)):
        raise UnreadableImage("JP2 ihdr and SIZ give different sizes")
    if w > 1 << 20 or h > 1 << 20 or w * h > 1 << 30:
        raise UnreadableImage(f"{w}x{h} JPEG 2000: larger than cv2 reads")
    n = len(cs.comps)
    if not 1 <= n <= 4:
        raise UnreadableImage(f"JPEG 2000 of {n} components (cv2 reads 1 to 4)")
    if any(c["sgnd"] for c in cs.comps):
        raise UnreadableImage("signed JPEG 2000 components (cv2 cannot read them)")
    maxprec = max(c["prec"] for c in cs.comps)
    if maxprec < 8 or maxprec > 16 and mode == "unchanged":
        raise UnreadableImage(f"JPEG 2000 of {maxprec}-bit components in {mode} mode (cv2 "
                              "cannot read it)")
    depth = 16 if mode == "unchanged" and maxprec > 8 else 8
    out_ch = {"color": 3, "gray": 1}.get(mode, n)
    if out_ch == 2:
        raise UnreadableImage("JPEG 2000 of two components in unchanged mode (cv2 cannot "
                              "read it)")
    if any(c["dx"] != 1 or c["dy"] != 1 for c in cs.comps) or cs.X0 or cs.Y0:
        raise UnreadableImage("JPEG 2000 with subsampled components or an image offset "
                              "(cv2 cannot read it)")
    planes = decode_codestream(cs)
    _check_color(n, color)
    planes, precs = _apply_jp2_color(planes, [c["prec"] for c in cs.comps], color)
    shift = max(maxprec - depth, 0)
    dt = np.uint8 if depth == 8 else np.uint16
    space = color["space"]
    cv = [(p.astype(np.int64) >> shift).astype(dt) for p in planes]
    inc = len(cv)
    if space in (SRGB, UNKNOWN):
        if out_ch == 1:
            if inc <= 2:
                return cv[0]
            return _gray(cv[2], cv[1], cv[0])
        if out_ch == 3 and inc >= 3:
            return np.stack([cv[2], cv[1], cv[0]], -1)
        if out_ch == 4 and inc >= 4:
            return np.stack([cv[2], cv[1], cv[0], cv[3]], -1)
        raise UnreadableImage(f"JPEG 2000 of {inc} components as {out_ch} channels (cv2 "
                              "cannot convert it)")
    if space == GRAY:
        if out_ch == 1:
            return cv[0]
        if out_ch == 3:
            return np.stack([cv[0]] * 3, -1)
        raise UnreadableImage(f"grey JPEG 2000 as {out_ch} channels (cv2 cannot convert it)")
    if space == SYCC:
        if out_ch == 1:
            return cv[0]
        if out_ch == 3 and inc >= 3:
            return _yuv_to_bgr(cv[0], cv[1], cv[2], depth)
        raise UnreadableImage(f"sYCC JPEG 2000 of {inc} components as {out_ch} channels (cv2 "
                              "cannot convert it)")
    raise UnreadableImage(f"JPEG 2000 colour space {space} (cv2 cannot convert it)")
