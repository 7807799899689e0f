"""JPEG decoding without cv2: markers and entropy decoding in pure Python,
the pixels in NumPy (`data/jpeg_pixels.py`).  Returns what cv2 5.0
(through libjpeg-turbo 3.1, with its defaults: ISLOW IDCT, fancy
upsampling) returns in the read modes of `data/imread.py`.

Reads 8-bit JPEG:

  * Huffman-coded DCT, baseline or extended sequential (SOF0, SOF1) and
    progressive (SOF2): DC first and refinement scans, AC first and
    refinement scans with end-of-band runs;
  * arithmetic-coded DCT, sequential (SOF9) and progressive (SOF10), with
    DAC conditioning (`data/jpeg_arith.py`, a port of `jdarith.c`);
  * lossless, Huffman-coded (SOF3): predictors 1-7, the point transform,
    restarts (`data/jpeg_lossless.py`, after `jdlhuff.c` / `jdlossls.c` /
    `jddiffct.c`);

interleaved and non-interleaved scans (a non-interleaved scan walks the
component's own block grid, not the MCU-padded one); restart intervals
(RSTn resets the DC predictions, the end-of-band run, the arithmetic
statistics and the lossless prediction, and the reader restarts on a
byte); 0xFF00 stuffing; any sampling factors.  Components, as libjpeg
names their colour space: one is grey; three are YCbCr unless an Adobe
APP14 marker says transform 0 without a JFIF APP0, or, with neither
marker, the component ids are 'R', 'G', 'B' or the frame is lossless;
four are CMYK unless an Adobe marker says a
transform other than 0, which makes them YCCK.

The bit reader looks 16 bits ahead: every Huffman table becomes a
65536-entry list that maps the next 16 bits to the code's length and
symbol and, where the code and its magnitude bits fit in those 16 bits, to
the decoded coefficient too (libjpeg's HUFF_LOOKAHEAD table, widened), so
a coefficient costs one lookup.

Lossless files whose components are sampled differently read with the box
upsampling libjpeg-turbo takes there (its fancy upsampling needs blocks
wider than one sample).  A progressive file whose scans leave any of the
first nine AC coefficients of a component incomplete (a scan missing or
cut, or a last scan with Al > 0) is block-smoothed as `jdcoefct.c` does it
(`jpeg_pixels.smooth`).

Damaged data reads as libjpeg-turbo 3.1 reads it: a Huffman code in no
table is warned of and read on (17 bits, symbol 0); a file that ends inside
a marker segment reads on in the 0xFF 0xD9 its source manager hands out
(`FAKE_EOI`); tables, frame and scan headers are checked as get_dht /
get_dqt (a table of 64 entries) / get_sof / get_sos / get_dri and
jpeg_make_d_derived_tbl check them, scans that name DC or AC table 0 or 1
of a sequential Huffman frame without one get the standard tables, an SOI
or a marker libjpeg does not know fails, and so does a marker code below
0xC0 left after a scan; a sequential scan of every component is output as
it decodes, so what follows it is not read.

cv2 returns None, so `UnreadableImage`: any precision but 8 bits (cv2
calls the 8-bit jpeg_read_scanlines, which refuses 12- and 16-bit data),
hierarchical frames (SOF5-7, SOF13-15), lossless arithmetic (SOF11), a
height left to a DNL marker, two components, and the colour conversions
libjpeg-turbo refuses in lossless mode (see `jpeg_pixels.to_pixels`; grey
from subsampled components too).  An
EXIF APP1 Orientation turns the image in the "color" and "gray" modes, as
cv2 does.
"""

from __future__ import annotations

import functools
import re
import struct

import numpy as np

from kgtpu_torch.data.imread import UnreadableImage, exif_orientation, orient

# zigzag index -> natural (row-major) index; 16 spare entries catch a run
# past the end of a corrupt block, as libjpeg's jpeg_natural_order does
ZIGZAG = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48,
          41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22,
          15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55,
          62, 63] + [63] * 16


# the natural positions of the DC and of zigzag coefficients 1-9: block
# smoothing needs them all nonzero in every component's table
_SMOOTH_Q = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24]


class Component:
    """One frame component: sampling factors, quantisation table and its
    coefficients, a flat list of 64 per block over a block grid padded to
    whole MCUs."""

    def __init__(self, cid: int, h: int, v: int, tq: int):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.quant = None            # latched at the component's first scan
        self.blocks_w = self.blocks_h = 0      # the component's own grid
        self.grid_w = self.grid_h = 0          # padded to whole MCUs
        self.coef: list[int] = []
        self.samples = None                    # lossless: [blocks_h, blocks_w] samples
        self.pt = 0                            # lossless: the scan's point transform
        self.coef_bits = [-1] * 64             # progressive: Al of each coefficient's last scan
        self.prev_coef_bits = [-1] * 64        # coef_bits before the component's last scan

    def coefficients(self) -> np.ndarray:
        """[grid_h, grid_w, 64] int32, natural order."""
        return np.asarray(self.coef, np.int32).reshape(self.grid_h, self.grid_w, 64)


# The tables libjpeg-turbo installs for a scan that names DC or AC table 0
# or 1 when the file defines none (`jstdhuff.c`, the tables of T.81 K.3).
STD_TABLES = {
    (0, 0): bytes.fromhex("00010501010101010100000000000000000102030405060708090a0b"),
    (0, 1): bytes.fromhex("00030101010101010101010000000000000102030405060708090a0b"),
    (1, 0): bytes.fromhex(
        "0002010303020403050504040000017d01020300041105122131410613516107227114328191a10823"
        "42b1c11552d1f02433627282090a161718191a25262728292a3435363738393a434445464748494a53"
        "5455565758595a636465666768696a737475767778797a838485868788898a92939495969798999aa2"
        "a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6"
        "e7e8e9eaf1f2f3f4f5f6f7f8f9fa"),
    (1, 1): bytes.fromhex(
        "00020102040403040705040400010277000102031104052131061241510761711322328108144291a1"
        "b1c109233352f0156272d10a162434e125f11718191a262728292a35363738393a434445464748494a"
        "535455565758595a636465666768696a737475767778797a82838485868788898a9293949596979899"
        "9aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5"
        "e6e7e8e9eaf2f3f4f5f6f7f8f9fa"),
}
# libjpeg's source manager, out of data, hands out 0xFF 0xD9 (a fake EOI)
# on every refill: a marker segment cut short reads on in these bytes
FAKE_EOI = b"\xff\xd9" * 32800


def table(spec: bytes | None, ac: bool, dc_max: int = 15) -> tuple[list, list]:
    """The lookups of a scan's table, checked as `jdhuff.c`'s
    jpeg_make_d_derived_tbl checks it when a scan starts: no table, more
    than 256 codes, a code length over-subscribed (or an all-ones code), or
    a DC symbol above `dc_max` (15; 16 in lossless frames) fail."""
    if spec is None:
        raise UnreadableImage("JPEG Huffman table missing")
    code = 0
    for length in range(1, 17):
        code += spec[length - 1]
        if code >= 1 << length:
            raise UnreadableImage("bogus JPEG Huffman table")
        code <<= 1
    if not ac and any(v > dc_max for v in spec[16:]):
        raise UnreadableImage("bogus JPEG Huffman table")
    return _tables(spec, ac)


@functools.lru_cache(maxsize=32)
def _tables(spec: bytes, ac: bool) -> tuple[list, list]:
    """(symbol lookup, coefficient lookup) of one Huffman table given as its
    16 code counts and values.  symbol[w] = (code length, symbol) for the
    next 16 bits w (length 0: no code starts there); coefficient[w] =
    (bits used, zero run or -1 at an end of block, value) where the code and
    its magnitude bits fit in w, else None."""
    counts, values = spec[:16], spec[16:]
    ln = np.zeros(65536, np.int64)
    sym = np.zeros(65536, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            start = code << (16 - length)
            ln[start:start + (1 << (16 - length))] = length
            sym[start:start + (1 << (16 - length))] = values[k]
            code += 1
            k += 1
        code <<= 1
    size = sym & 15 if ac else sym
    run = sym >> 4 if ac else np.zeros_like(sym)
    total = ln + size
    fits = (ln > 0) & (total <= 16)
    w = np.arange(65536)
    raw = (w >> np.clip(16 - total, 0, 16)) & ((1 << size) - 1)
    val = np.where(raw < (1 << np.maximum(size - 1, 0)), raw - (1 << size) + 1, raw)
    val = np.where(size == 0, 0, val)
    if ac:       # size 0: ZRL (run 15) skips 16, any other run ends the block
        run = np.where((size == 0) & (run != 15), -1, run)
    symbols = list(zip(ln.tolist(), sym.tolist()))
    coefs = [(t, r, v) if f else None
             for f, t, r, v in zip(fits.tolist(), total.tolist(), run.tolist(), val.tolist())]
    return symbols, coefs


def _windows(segment: bytes) -> list[int]:
    """Entropy-coded bytes (stuffing removed) -> for every byte, the 24 bits
    that start there; zero bits follow the end, as libjpeg supplies them
    (enough for the MCU that runs past the end, see the note below)."""
    b = np.frombuffer(segment + b"\0" * 8, np.uint8).astype(np.int64)
    w = (b[:-2] << 16) | (b[1:-1] << 8) | b[2:]
    return w.tolist() + [0] * 4096


# Out of data (libjpeg's insufficient_data): once decoding reads past an
# interval's data, every later MCU of the interval is left as it was (zero,
# so uniform grey, in a sequential scan).  The state carries into the next
# interval unless its RSTn marker was found: an interval left without data
# (None from `restart_data`) is skipped if the one before ran short, else
# its first MCU decodes from zero bits.

_STUFFED = re.compile(rb"\xff+\x00")


def _segments(data: bytes, pos: int) -> tuple[list, int]:
    """The entropy-coded data of a scan starting at `pos`, split at its
    restart markers and unstuffed: [(None, data before the first RSTn),
    (n, data after RSTn), ...] (n = -1 after a marker code below 0xC0, which
    libjpeg does not know), and the position of the marker that ends it.
    As libjpeg reads it: 0xFF 0x00 (after any run of 0xFF) is one 0xFF;
    0xFF bytes before a marker, or before the end of the file, are fill,
    not data."""
    segs, start, at, num = [], pos, pos, None
    n = len(data)
    while True:
        at = data.find(b"\xff", at)
        if at < 0:
            segs.append((num, _STUFFED.sub(b"\xff", data[start:])))
            return segs, n
        run = at
        while at + 1 < n and data[at + 1] == 0xFF:
            at += 1
        if at + 1 >= n:
            segs.append((num, _STUFFED.sub(b"\xff", data[start:run])))
            return segs, n
        m = data[at + 1]
        if m == 0x00:
            at += 2
        elif 0xD0 <= m <= 0xD7 or m < 0xC0:            # RSTn, or an invalid code
            segs.append((num, _STUFFED.sub(b"\xff", data[start:run])))
            num = m - 0xD0 if m >= 0xD0 else -1
            start = at = at + 2
        else:
            segs.append((num, _STUFFED.sub(b"\xff", data[start:run])))
            return segs, at


def restart_data(segs: list, intervals: int) -> list:
    """Each restart interval's data, as libjpeg's read_restart_marker and
    jpeg_resync_to_restart hand it out: RSTn with the expected n starts the
    next interval; RSTn one or two ahead, or the scan's end, leaves the
    interval without data (None) and is kept for the next; RSTn one or two
    behind, or an unknown code, is skipped with its data; any other RSTn is
    taken as expected."""
    return _restart_walk(segs, intervals)[0]


def unknown_marker_after(segs: list, intervals: int) -> bool:
    """Whether a marker code below 0xC0 follows the scan's last interval:
    libjpeg's read_markers meets it after the scan and fails (an RSTn
    there is passed over)."""
    j = _restart_walk(segs, intervals)[1]
    return any(m == -1 for m, _ in segs[j:])


def _restart_walk(segs: list, intervals: int) -> tuple[list, int]:
    out = [segs[0][1]]
    j, want = 1, 0
    while len(out) < intervals:
        while True:
            if j >= len(segs):
                out.append(None)
                break
            m = segs[j][0]
            if m == want:
                out.append(segs[j][1])
                j += 1
                break
            if m in ((want + 1) & 7, (want + 2) & 7):
                out.append(None)
                break
            if m < 0 or m in ((want - 1) & 7, (want - 2) & 7):
                j += 1
                continue
            out.append(segs[j][1])
            j += 1
            break
        want = (want + 1) & 7
    return out, j


def _bits(W: list[int], p: int, n: int) -> int:
    return ((W[p >> 3] << (p & 7)) & 0xFFFFFF) >> (24 - n) if n else 0


def _extend(v: int, n: int) -> int:
    return v - (1 << n) + 1 if n and v < (1 << (n - 1)) else v


def _decode(W: list[int], p: int, symbols: list) -> tuple[int, int]:
    """(symbol, position after it).  Bits that start no code are what
    libjpeg-turbo's jpeg_huff_decode warns of (JWRN_HUFF_BAD_CODE) and
    reads on after: 17 bits taken, symbol 0."""
    n, s = symbols[((W[p >> 3] << (p & 7)) >> 8) & 0xFFFF]
    if not n:
        return 0, p + 17
    return s, p + n


class _Scan:
    """The blocks of one scan in coding order, grouped by restart interval:
    for each MCU, (component index, flat coefficient offset) per block."""

    def __init__(self, comps: list[Component], scomps: list[int], frame: dict, restart: int):
        if len(scomps) == 1:
            c = comps[scomps[0]]
            mcus = [[(scomps[0], (by * c.grid_w + bx) * 64)]
                    for by in range(c.blocks_h) for bx in range(c.blocks_w)]
        else:
            mcus = []
            for my in range(frame["mcu_rows"]):
                for mx in range(frame["mcu_cols"]):
                    mcu = []
                    for ci in scomps:
                        c = comps[ci]
                        for v in range(c.v):
                            for h in range(c.h):
                                mcu.append((ci, ((my * c.v + v) * c.grid_w + mx * c.h + h) * 64))
                    mcus.append(mcu)
        step = restart or len(mcus) or 1
        self.intervals = [mcus[i:i + step] for i in range(0, len(mcus), step)]
        # the iMCU row of each MCU, and per interval the first MCU after
        # which the Huffman decoder is out of data (libjpeg's
        # insufficient_data; None: never)
        if len(scomps) == 1:
            c = comps[scomps[0]]
            self.imcu_row = [(by // c.v) for by in range(c.blocks_h) for _ in range(c.blocks_w)]
        else:
            self.imcu_row = [my for my in range(frame["mcu_rows"])
                             for _ in range(frame["mcu_cols"])]
        self.first_short = [None] * len(self.intervals)

    def last_good(self, before: int) -> int:
        """The last iMCU row after which the decoder still had data
        (`before` if none): block smoothing reads the rows below it with
        the coefficient precisions from before this scan."""
        short_after = np.zeros(len(self.imcu_row), bool)
        at = 0
        for interval, first in zip(self.intervals, self.first_short):
            if first is not None:
                short_after[at + first:at + len(interval)] = True
            at += len(interval)
        rows = np.asarray(self.imcu_row)
        starts = np.flatnonzero(np.append(True, rows[1:] != rows[:-1]))
        short_before = np.append(False, short_after[:-1])[starts]
        good = rows[starts][~short_before]
        return int(good.max()) if good.size else before


def _baseline(scan: _Scan, segs: list[bytes], comps, dc_tabs, ac_tabs) -> None:
    short = False
    for interval, seg in zip(scan.intervals, segs):
        short = short and seg is None
        W, limit = _windows(seg or b""), 8 * len(seg or b"")
        p = 0
        pred = [0] * len(comps)
        for mcu in interval:
            if short or p > limit:
                short = True
                break
            for ci, base in mcu:
                coef = comps[ci].coef
                dsym, dcoef = dc_tabs[ci]
                e = dcoef[((W[p >> 3] << (p & 7)) >> 8) & 0xFFFF]
                if e is not None:
                    p += e[0]
                    diff = e[2]
                else:
                    s, p = _decode(W, p, dsym)
                    diff = _extend(_bits(W, p, s), s)
                    p += s
                pred[ci] += diff
                coef[base] = pred[ci]
                asym, acoef = ac_tabs[ci]
                k = 1
                while k < 64:
                    e = acoef[((W[p >> 3] << (p & 7)) >> 8) & 0xFFFF]
                    if e is not None:
                        n, r, v = e
                        p += n
                    else:
                        rs, p = _decode(W, p, asym)
                        r, s = rs >> 4, rs & 15
                        if not s and r != 15:
                            r = -1
                        v = _extend(_bits(W, p, s), s)
                        p += s
                    if r < 0:
                        break
                    k += r
                    coef[base + ZIGZAG[k]] = v
                    k += 1
        short = short or p > limit


def _dc_first(scan, segs, comps, dc_tabs, al):
    short = False
    for i, (interval, seg) in enumerate(zip(scan.intervals, segs)):
        short = short and seg is None
        W, limit = _windows(seg or b""), 8 * len(seg or b"")
        p = 0
        pred = [0] * len(comps)
        for j, mcu in enumerate(interval):
            if short or p > limit:
                scan.first_short[i] = j - 1 if p > limit else j
                short = True
                break
            for ci, base in mcu:
                s, p = _decode(W, p, dc_tabs[ci][0])
                pred[ci] += _extend(_bits(W, p, s), s)
                p += s
                comps[ci].coef[base] = pred[ci] << al
        if not short and p > limit:
            scan.first_short[i] = len(interval) - 1
        short = short or p > limit


def _dc_refine(scan, segs, comps, al):
    bit = 1 << al
    short = False
    for i, (interval, seg) in enumerate(zip(scan.intervals, segs)):
        short = short and seg is None
        W, limit = _windows(seg or b""), 8 * len(seg or b"")
        p = 0
        for j, mcu in enumerate(interval):
            if short or p > limit:
                scan.first_short[i] = j - 1 if p > limit else j
                short = True
                break
            for ci, base in mcu:
                if (W[p >> 3] << (p & 7)) & 0x800000:
                    comps[ci].coef[base] |= bit
                p += 1
        if not short and p > limit:
            scan.first_short[i] = len(interval) - 1
        short = short or p > limit


def _ac_first(scan, segs, comp, tabs, ss, se, al):
    asym, acoef = tabs
    coef = comp.coef
    short = False
    for i, (interval, seg) in enumerate(zip(scan.intervals, segs)):
        short = short and seg is None
        W, limit = _windows(seg or b""), 8 * len(seg or b"")
        p = 0
        eobrun = 0
        for j, mcu in enumerate(interval):
            if short or p > limit:
                scan.first_short[i] = j - 1 if p > limit else j
                short = True
                break
            base = mcu[0][1]
            if eobrun:
                eobrun -= 1
                continue
            k = ss
            while k <= se:
                e = acoef[((W[p >> 3] << (p & 7)) >> 8) & 0xFFFF]
                if e is not None and e[1] >= 0:
                    n, r, v = e
                    p += n
                    k += r
                    coef[base + ZIGZAG[k]] = v << al
                    k += 1
                    continue
                rs, p = _decode(W, p, asym)
                r, s = rs >> 4, rs & 15
                if s:
                    k += r
                    coef[base + ZIGZAG[k]] = _extend(_bits(W, p, s), s) << al
                    p += s
                elif r == 15:
                    k += 15
                else:
                    eobrun = (1 << r) + _bits(W, p, r) - 1
                    p += r
                    break
                k += 1
        if not short and p > limit:
            scan.first_short[i] = len(interval) - 1
        short = short or p > limit


def _ac_refine(scan, segs, comp, tabs, ss, se, al):
    asym = tabs[0]
    coef = comp.coef
    p1, m1 = 1 << al, -1 << al
    short = False
    for i, (interval, seg) in enumerate(zip(scan.intervals, segs)):
        short = short and seg is None
        W, limit = _windows(seg or b""), 8 * len(seg or b"")
        p = 0
        eobrun = 0
        for j, mcu in enumerate(interval):
            if short or p > limit:
                scan.first_short[i] = j - 1 if p > limit else j
                short = True
                break
            base = mcu[0][1]
            k = ss
            if not eobrun:
                while k <= se:
                    rs, p = _decode(W, p, asym)
                    r, s = rs >> 4, rs & 15
                    if s:
                        s = p1 if (W[p >> 3] << (p & 7)) & 0x800000 else m1
                        p += 1
                    elif r != 15:
                        eobrun = (1 << r) + _bits(W, p, r)
                        p += r
                        break
                    while k <= se:
                        at = base + ZIGZAG[k]
                        c = coef[at]
                        if c:
                            if (W[p >> 3] << (p & 7)) & 0x800000 and not c & p1:
                                coef[at] = c + p1 if c >= 0 else c + m1
                            p += 1
                        else:
                            if r == 0:
                                break
                            r -= 1
                        k += 1
                    if s:
                        coef[base + ZIGZAG[k]] = s
                    k += 1
            if eobrun:
                while k <= se:
                    at = base + ZIGZAG[k]
                    c = coef[at]
                    if c:
                        if (W[p >> 3] << (p & 7)) & 0x800000 and not c & p1:
                            coef[at] = c + p1 if c >= 0 else c + m1
                        p += 1
                    k += 1
                eobrun -= 1
        if not short and p > limit:
            scan.first_short[i] = len(interval) - 1
        short = short or p > limit


def parse(data: bytes, mode: str | None = None) -> dict:
    """Decode the markers and entropy-coded data: {"width", "height",
    "components": [Component], "color": "ycc" | "rgb" | "gray",
    "orientation"}.  `mode`, the read mode, decides a refusal that
    depends on it."""
    data = data + FAKE_EOI
    pos, n = 2, len(data)
    qt: dict[int, np.ndarray] = {}
    huff: dict[tuple[int, int], bytes] = {}
    restart = 0
    frame = None
    comps: list[Component] = []
    jfif = adobe = False
    transform, orientation = None, 1
    cond: dict = {"L": {}, "U": {}, "K": {}}
    while True:
        # libjpeg's next_marker: junk before 0xFF is skipped, and so is
        # 0xFF 0x00 (after any run of 0xFF)
        while data[pos] != 0xFF:
            pos += 1
        while data[pos] == 0xFF:
            pos += 1
        m = data[pos]
        pos += 1
        if m == 0x00:
            continue
        if m == 0xD9:
            break
        if m == 0xD8:
            raise UnreadableImage("JPEG with a second SOI marker")
        if m == 0x01 or 0xD0 <= m <= 0xD7:
            continue
        if m in (0xC8, 0xDE, 0xDF) or m < 0xC0 or 0xF0 <= m <= 0xFD:
            raise UnreadableImage(f"JPEG marker 0x{m:02X} libjpeg does not know")
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        seg = data[pos + 2:pos + max(length, 2)]
        pos += max(length, 2)
        if m in (0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA):
            if frame is not None:
                raise UnreadableImage("JPEG with two frames")
            prec, hgt, wid, nf = struct.unpack(">BHHB", (seg + bytes(6))[:6])
            if hgt == 0 or wid == 0 or nf == 0:
                raise UnreadableImage("empty JPEG image (a height of 0 is left to a DNL "
                                      "marker, which libjpeg does not read)")
            if len(seg) != 6 + 3 * nf:
                raise UnreadableImage("JPEG SOF of a bad length")
            if max(hgt, wid) > 65500 or hgt * wid > 1 << 30:
                raise UnreadableImage("JPEG image larger than libjpeg or cv2 reads")
            if prec != 8:
                raise UnreadableImage(f"{prec}-bit JPEG (cv2 reads 8-bit samples only)")
            if nf not in (1, 3, 4):
                raise UnreadableImage(f"JPEG with {nf} components")
            for i in range(nf):
                cid, hv, tq = seg[6 + 3 * i:9 + 3 * i]
                comps.append(Component(cid, hv >> 4, hv & 15, tq))
                comps[-1].index = i
            if any(not 1 <= c.h <= 4 or not 1 <= c.v <= 4 for c in comps):
                raise UnreadableImage("JPEG sampling factor out of range")
            frame = _frame(wid, hgt, comps, progressive=m in (0xC2, 0xCA),
                           lossless=m == 0xC3)
            frame["arith"] = m in (0xC9, 0xCA)
        elif m in (0xC5, 0xC6, 0xC7, 0xCB, 0xCD, 0xCE, 0xCF):
            kind = "lossless arithmetic-coded" if m == 0xCB else "hierarchical"
            raise UnreadableImage(f"{kind} JPEG (SOF 0x{m:02X}; cv2 cannot read it)")
        elif m == 0xCC:
            for at in range(0, len(seg) - 1, 2):
                t, val = seg[at], seg[at + 1]
                if t >= 32:
                    raise UnreadableImage(f"JPEG DAC table {t}")
                if t >= 16:
                    cond["K"][t - 16] = val
                else:
                    if val & 15 > val >> 4:
                        raise UnreadableImage(f"JPEG DAC value {val}")
                    cond["L"][t], cond["U"][t] = val & 15, val >> 4
        elif m == 0xC4:                     # as get_dht checks it
            at = 0
            while len(seg) - at > 16:
                index = seg[at]
                cnt = sum(seg[at + 1:at + 17])
                if cnt > 256 or cnt > len(seg) - at - 17:
                    raise UnreadableImage("bogus JPEG Huffman table definition")
                spec = bytes(seg[at + 1:at + 17 + cnt])
                at += 17 + cnt
                kind, index = (1, index - 16) if index & 16 else (0, index)
                if index >= 4:
                    raise UnreadableImage(f"bogus JPEG DHT index {index}")
                huff[kind, index] = spec
            if at != len(seg):
                raise UnreadableImage("JPEG DHT of a bad length")
        elif m == 0xDB:                     # as get_dqt reads it
            at = 0
            while at < len(seg):
                pq, tq = seg[at] >> 4, seg[at] & 15
                at += 1
                if tq >= 4:
                    raise UnreadableImage(f"bogus JPEG DQT index {tq}")
                size = 128 if pq else 64
                if len(seg) - at < size:         # libjpeg-turbo 3.1 refuses a short table
                    raise UnreadableImage("JPEG DQT of a bad length")
                q = np.frombuffer(seg[at:at + size], ">u2" if pq else np.uint8).astype(np.int32)
                at += size
                nat = np.zeros(64, np.int32)
                nat[ZIGZAG[:64]] = q
                qt[tq] = nat
        elif m == 0xDD:
            if len(seg) != 2:
                raise UnreadableImage("JPEG DRI of a bad length")
            (restart,) = struct.unpack(">H", seg[:2])
        elif m == 0xDA:
            if frame is None:
                raise UnreadableImage("JPEG scan before its frame")
            if not frame["scans"] and not frame["progressive"] and not frame["lossless"]:
                for key, spec in STD_TABLES.items():        # jdhuff.c's std_huff_tables
                    huff.setdefault(key, spec)
            pos = _scan(data, pos, seg, frame, comps, qt, huff, restart, cond)
            if not frame["progressive"] and len(frame["scans"][0]["comps"]) == len(comps):
                # one scan of every component: libjpeg outputs it as it
                # decodes, and cv2 ignores what follows (jpeg_finish_decompress's
                # errors come after its result)
                break
        elif m == 0xE0 and seg[:5] == b"JFIF\0" and len(seg) >= 14:
            jfif = True
        elif m == 0xE1 and seg[:6] == b"Exif\0\0" and orientation == 1:
            orientation = exif_orientation(seg[6:])
        elif m == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe, transform = True, seg[11]
    if frame is None:
        raise UnreadableImage("JPEG without a frame")
    if any(c.quant is None for c in comps) and not frame["lossless"] or any(
            c.samples is None for c in comps) and frame["lossless"]:
        raise UnreadableImage("JPEG component without a scan")
    if frame["lossless"] and len({(c.h, c.v) for c in comps}) > 1 and mode == "gray":
        raise UnreadableImage("lossless JPEG with subsampled components in gray mode "
                              "(cv2 cannot read it)")
    smooth = None
    if frame["progressive"] and all(
            c.coef_bits[0] >= 0 and c.quant is not None and all(c.quant[_SMOOTH_Q]) for c in comps
    ) and any(any(c.coef_bits[1:10]) for c in comps):
        # jdcoefct.c's smoothing_ok: the Al of each coefficient's last scan
        # (-1: none yet), latched as the output pass starts, and the same
        # before the component's last scan, which the iMCU rows below
        # `last_good` take
        many = len(frame["scans"]) > 1
        smooth = {"last_good": frame["last_good"],
                  "bits": [(c.coef_bits[:10], c.coef_bits[:1] + (
                      c.prev_coef_bits[1:10] if many else [-1] * 9)) for c in comps]}
    ids = tuple(c.id for c in comps)
    if len(comps) == 1:
        color = "gray"
    elif len(comps) == 3:
        color = "ycc"
        if jfif:
            pass
        elif adobe:
            color = "rgb" if transform == 0 else "ycc"
        elif ids == (82, 71, 66) or frame["lossless"]:
            color = "rgb"
    else:
        color = "ycck" if adobe and transform != 0 else "cmyk"
    return {"width": frame["width"], "height": frame["height"], "components": comps,
            "color": color, "orientation": orientation, "lossless": frame["lossless"],
            "scans": frame["scans"], "arith": frame["arith"], "smooth": smooth}


def _frame(wid: int, hgt: int, comps: list[Component], progressive: bool,
           lossless: bool = False) -> dict:
    """Block grids (a block is one sample in a lossless frame)."""
    hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
    n = 1 if lossless else 8
    mcu_cols, mcu_rows = -(-wid // (n * hmax)), -(-hgt // (n * vmax))
    for c in comps:
        c.blocks_w = -(-wid * c.h // (n * hmax))
        c.blocks_h = -(-hgt * c.v // (n * vmax))
        c.grid_w, c.grid_h = mcu_cols * c.h, mcu_rows * c.v
        c.coef = [] if lossless else [0] * (c.grid_w * c.grid_h * 64)
    return {"width": wid, "height": hgt, "hmax": hmax, "vmax": vmax, "mcu_cols": mcu_cols,
            "mcu_rows": mcu_rows, "progressive": progressive, "lossless": lossless,
            "arith": False, "scans": [], "last_good": 0}


def _scan(data, pos, seg, frame, comps, qt, huff, restart, cond) -> int:
    ns = seg[0] if seg else 0
    if len(seg) != 2 * ns + 4 or not 1 <= ns <= 4:
        raise UnreadableImage("JPEG SOS of a bad length")
    scomps, dc_sel, ac_sel = [], {}, {}
    for i in range(ns):
        cid, tdta = seg[1 + 2 * i], seg[2 + 2 * i]
        if cid in [comps[ci].id for ci in scomps]:      # get_sos: a fake id
            cid = max(comps[ci].id for ci in scomps) + 1
        ci = next((k for k, c in enumerate(comps) if c.id == cid), None)
        if ci is None:
            raise UnreadableImage(f"JPEG scan names unknown component {cid}")
        scomps.append(ci)
        dc_sel[ci], ac_sel[ci] = tdta >> 4, tdta & 15
    for ci in scomps:
        if comps[ci].quant is None and not frame["lossless"]:
            if comps[ci].tq not in qt:
                raise UnreadableImage("JPEG quantisation table missing")
            comps[ci].quant = qt[comps[ci].tq]
    if ns > 1 and sum(comps[ci].h * comps[ci].v for ci in scomps) > 10:
        raise UnreadableImage("JPEG MCU of more than 10 blocks")
    ss, se, ahal = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns]
    ah, al = ahal >> 4, ahal & 15
    if frame["progressive"] and (ss == 0 and se != 0 or ss and (ss > se or se > 63 or ns != 1)
                                 or ah and al != ah - 1 or al > 13):
        raise UnreadableImage("bad progressive JPEG scan")
    frame["scans"].append({"comps": [comps[ci].id for ci in scomps], "ss": ss, "se": se,
                           "ah": ah, "al": al})
    marked, end = _segments(data, pos)
    if frame["lossless"]:
        from kgtpu_torch.data.jpeg_lossless import intervals
        n_int = intervals(comps, scomps, frame, restart)
    else:
        c = comps[scomps[0]]
        mcus = c.blocks_w * c.blocks_h if ns == 1 else frame["mcu_cols"] * frame["mcu_rows"]
        n_int = -(-mcus // restart) if restart else 1
    if (frame["progressive"] or ns < len(comps)) and unknown_marker_after(marked, n_int):
        raise UnreadableImage("JPEG marker libjpeg does not know after a scan")
    progressive = frame["progressive"]
    dc_tabs, ac_tabs = {}, {}
    if not frame["arith"]:
        for ci in scomps:       # the tables the scan's decoder builds, checked
            if frame["lossless"] or not progressive or ss == 0 and ah == 0:
                dc_tabs[ci] = table(huff.get((0, dc_sel[ci])), False,
                                    16 if frame["lossless"] else 15)
            if not frame["lossless"] and (not progressive or ss > 0):
                ac_tabs[ci] = table(huff.get((1, ac_sel[ci])), True)
    if frame["lossless"]:
        from kgtpu_torch.data.jpeg_lossless import decode_lossless_scan
        decode_lossless_scan(marked, comps, scomps, dc_tabs, frame, restart, ss, al)
        return end
    scan = _Scan(comps, scomps, frame, restart)
    # intervals left without data (None; see the note above `_STUFFED`);
    # arithmetic decoding reads zeros there
    segs = restart_data(marked, len(scan.intervals))
    if progressive:
        for ci in scomps:       # the state before this scan, for block smoothing
            c = comps[ci]
            c.prev_coef_bits = c.coef_bits[:] if len(frame["scans"]) > 1 else [0] * 64
            c.coef_bits[ss:se + 1] = [al] * (se + 1 - ss)
    if frame["arith"]:
        from kgtpu_torch.data.jpeg_arith import decode_scan
        decode_scan(scan, [g or b"" for g in segs], comps, scomps, dc_sel, ac_sel, cond,
                    progressive, ss, se, ah, al)
    elif not progressive:
        _baseline(scan, segs, comps, dc_tabs, ac_tabs)
    elif ss == 0:
        if ah:
            _dc_refine(scan, segs, comps, al)
        else:
            _dc_first(scan, segs, comps, dc_tabs, al)
    else:
        ci = scomps[0]
        (_ac_refine if ah else _ac_first)(scan, segs, comps[ci], ac_tabs[ci], ss, se, al)
    if progressive:
        frame["last_good"] = scan.last_good(frame["last_good"])
    return end


def decode_jpeg(data: bytes, mode: str) -> np.ndarray:
    """The bytes of a JPEG file as one of `imread.MODES`, in RGB order."""
    from kgtpu_torch.data.jpeg_pixels import to_pixels
    img = parse(data, mode)
    out = to_pixels(img, mode)
    return out if mode == "unchanged" else orient(out, img["orientation"])
