"""JPEG decoding without cv2: markers and Huffman entropy decoding in pure
Python, the pixels in NumPy (`data/jpeg_pixels.py`).  Returns what cv2 5.0
(through libjpeg-turbo 3.1, with its defaults: ISLOW IDCT, fancy
upsampling) returns in the read modes of `data/imread.py`.

Reads 8-bit Huffman-coded JPEG, baseline or extended sequential (SOF0,
SOF1) and progressive (SOF2): DC first and refinement scans, AC first and
refinement scans with end-of-band runs; interleaved and non-interleaved
scans (a non-interleaved scan walks the component's own block grid, not the
MCU-padded one); restart intervals (RSTn resets the DC predictions and the
end-of-band run, and the bit reader restarts on a byte); 0xFF00 stuffing;
any sampling factors.  One or three components: three are YCbCr unless an
Adobe APP14 marker says transform 0 without a JFIF APP0, or, with neither
marker, the component ids are 'R', 'G', 'B' (libjpeg's rules).

The bit reader looks 16 bits ahead: every Huffman table becomes a
65536-entry list that maps the next 16 bits to the code's length and
symbol and, where the code and its magnitude bits fit in those 16 bits, to
the decoded coefficient too (libjpeg's HUFF_LOOKAHEAD table, widened), so
a coefficient costs one lookup.

Arithmetic coding, 12-bit samples, lossless and hierarchical JPEG and
four-component (CMYK / YCCK) images raise `UnsupportedImage`.  An EXIF APP1
Orientation turns the image in the "color" and "gray" modes, as cv2 does.
"""

from __future__ import annotations

import functools
import struct

import numpy as np

from kgtpu_torch.data.imread import UnreadableImage, exif_orientation, orient, unsupported

# zigzag index -> natural (row-major) index; 16 spare entries catch a run
# past the end of a corrupt block, as libjpeg's jpeg_natural_order does
ZIGZAG = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48,
          41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22,
          15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55,
          62, 63] + [63] * 16


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

    def coefficients(self) -> np.ndarray:
        """[grid_h, grid_w, 64] int32, natural order."""
        return np.asarray(self.coef, np.int32).reshape(self.grid_h, self.grid_w, 64)


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
    that start there; zero bits follow the end, as libjpeg supplies them."""
    b = np.frombuffer(segment + b"\0" * 8, np.uint8).astype(np.int64)
    w = (b[:-2] << 16) | (b[1:-1] << 8) | b[2:]
    return w.tolist() + [0] * 64


def _segments(data: bytes, pos: int) -> tuple[list[bytes], int]:
    """The entropy-coded data of a scan starting at `pos`, split at its
    restart markers and unstuffed, and the position of the marker that
    ends it."""
    segs, start, at = [], pos, pos
    n = len(data)
    while True:
        at = data.find(b"\xff", at)
        if at < 0 or at + 1 >= n:
            segs.append(data[start:].replace(b"\xff\x00", b"\xff"))
            return segs, n
        m = data[at + 1]
        if m == 0x00:
            at += 2
        elif 0xD0 <= m <= 0xD7:
            segs.append(data[start:at].replace(b"\xff\x00", b"\xff"))
            start = at = at + 2
        elif m == 0xFF:                       # fill byte before a marker
            at += 1
        else:
            segs.append(data[start:at].replace(b"\xff\x00", b"\xff"))
            return segs, at


def _bits(W: list[int], p: int, n: int) -> int:
    return ((W[p >> 3] << (p & 7)) & 0xFFFFFF) >> (24 - n) if n else 0


def _extend(v: int, n: int) -> int:
    return v - (1 << n) + 1 if n and v < (1 << (n - 1)) else v


def _decode(W: list[int], p: int, symbols: list) -> tuple[int, int]:
    """(symbol, position after it)."""
    n, s = symbols[((W[p >> 3] << (p & 7)) >> 8) & 0xFFFF]
    if not n:
        raise UnreadableImage("corrupt JPEG data: bad Huffman code")
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


def _baseline(scan: _Scan, segs: list[bytes], comps, dc_tabs, ac_tabs) -> None:
    for interval, seg in zip(scan.intervals, segs):
        W = _windows(seg)
        p = 0
        pred = [0] * len(comps)
        for mcu in interval:
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


def _dc_first(scan, segs, comps, dc_tabs, al):
    for interval, seg in zip(scan.intervals, segs):
        W = _windows(seg)
        p = 0
        pred = [0] * len(comps)
        for mcu in interval:
            for ci, base in mcu:
                s, p = _decode(W, p, dc_tabs[ci][0])
                pred[ci] += _extend(_bits(W, p, s), s)
                p += s
                comps[ci].coef[base] = pred[ci] << al


def _dc_refine(scan, segs, comps, al):
    bit = 1 << al
    for interval, seg in zip(scan.intervals, segs):
        W = _windows(seg)
        p = 0
        for mcu in interval:
            for ci, base in mcu:
                if (W[p >> 3] << (p & 7)) & 0x800000:
                    comps[ci].coef[base] |= bit
                p += 1


def _ac_first(scan, segs, comp, tabs, ss, se, al):
    asym, acoef = tabs
    coef = comp.coef
    for interval, seg in zip(scan.intervals, segs):
        W = _windows(seg)
        p = 0
        eobrun = 0
        for mcu in interval:
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


def _ac_refine(scan, segs, comp, tabs, ss, se, al):
    asym = tabs[0]
    coef = comp.coef
    p1, m1 = 1 << al, -1 << al
    for interval, seg in zip(scan.intervals, segs):
        W = _windows(seg)
        p = 0
        eobrun = 0
        for mcu in interval:
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


def parse(data: bytes) -> dict:
    """Decode the markers and entropy-coded data: {"width", "height",
    "components": [Component], "color": "ycc" | "rgb" | "gray",
    "orientation"}."""
    pos, n = 2, len(data)
    qt: dict[int, np.ndarray] = {}
    dc: dict[int, tuple] = {}
    ac: dict[int, tuple] = {}
    restart = 0
    frame = None
    comps: list[Component] = []
    jfif = adobe = False
    transform, orientation = None, 1
    while pos < n:
        if data[pos] != 0xFF:
            pos += 1                        # libjpeg skips junk before a marker
            continue
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            break
        m = data[pos]
        pos += 1
        if m == 0xD9:
            break
        if m in (0xD8, 0x01) or 0xD0 <= m <= 0xD7:
            continue
        if pos + 2 > n:
            break
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        seg = data[pos + 2:pos + length]
        pos += length
        if m in (0xC0, 0xC1, 0xC2):
            if frame is not None:
                raise UnreadableImage("JPEG with two frames")
            prec, hgt, wid, nf = struct.unpack(">BHHB", seg[:6])
            if prec != 8:
                raise unsupported(f"{prec}-bit JPEG")
            if hgt == 0:
                raise unsupported("JPEG whose height is given by a DNL marker")
            if nf not in (1, 3):
                raise unsupported(f"JPEG with {nf} components (CMYK / YCCK)")
            if wid == 0:
                raise UnreadableImage("JPEG of width 0")
            for i in range(nf):
                cid, hv, tq = seg[6 + 3 * i:9 + 3 * i]
                comps.append(Component(cid, hv >> 4, hv & 15, tq))
            if any(not 1 <= c.h <= 4 or not 1 <= c.v <= 4 for c in comps):
                raise UnreadableImage("JPEG sampling factor out of range")
            frame = _frame(wid, hgt, comps, progressive=m == 0xC2)
        elif m in (0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF, 0xCC):
            kind = {0xC3: "lossless", 0xCC: "arithmetic-coded"}.get(
                m, "arithmetic-coded" if m >= 0xC9 else "hierarchical")
            raise unsupported(f"{kind} JPEG (SOF 0x{m:02X})")
        elif m == 0xC4:
            at = 0
            while at < len(seg):
                tc_th = seg[at]
                cnt = sum(seg[at + 1:at + 17])
                spec = bytes(seg[at + 1:at + 17 + cnt])
                (ac if tc_th >> 4 else dc)[tc_th & 15] = _tables(spec, bool(tc_th >> 4))
                at += 17 + cnt
        elif m == 0xDB:
            at = 0
            while at < len(seg):
                pq, tq = seg[at] >> 4, seg[at] & 15
                if pq:
                    q = np.frombuffer(seg[at + 1:at + 129], ">u2").astype(np.int32)
                    at += 129
                else:
                    q = np.frombuffer(seg[at + 1:at + 65], np.uint8).astype(np.int32)
                    at += 65
                nat = np.zeros(64, np.int32)
                nat[ZIGZAG[:64]] = q
                qt[tq] = nat
        elif m == 0xDD:
            (restart,) = struct.unpack(">H", seg[:2])
        elif m == 0xDA:
            if frame is None:
                raise UnreadableImage("JPEG scan before its frame")
            pos = _scan(data, pos, seg, frame, comps, qt, dc, ac, restart)
        elif m == 0xE0 and seg[:5] == b"JFIF\0":
            jfif = True
        elif m == 0xE1 and seg[:6] == b"Exif\0\0" and orientation == 1:
            orientation = exif_orientation(seg[6:])
        elif m == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe, transform = True, seg[11]
    if frame is None:
        raise UnreadableImage("JPEG without a frame")
    if any(c.quant is None for c in comps):
        raise UnreadableImage("JPEG component without a scan")
    color = "gray"
    if len(comps) == 3:
        ids = tuple(c.id for c in comps)
        color = "ycc"
        if not jfif and (adobe and transform == 0 or not adobe and ids == (82, 71, 66)):
            color = "rgb"
    return {"width": frame["width"], "height": frame["height"], "components": comps,
            "color": color, "orientation": orientation}


def _frame(wid: int, hgt: int, comps: list[Component], progressive: bool) -> dict:
    hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
    mcu_cols, mcu_rows = -(-wid // (8 * hmax)), -(-hgt // (8 * vmax))
    for c in comps:
        c.blocks_w = -(-wid * c.h // (8 * hmax))
        c.blocks_h = -(-hgt * c.v // (8 * vmax))
        c.grid_w, c.grid_h = mcu_cols * c.h, mcu_rows * c.v
        c.coef = [0] * (c.grid_w * c.grid_h * 64)
    return {"width": wid, "height": hgt, "hmax": hmax, "vmax": vmax, "mcu_cols": mcu_cols,
            "mcu_rows": mcu_rows, "progressive": progressive}


def _scan(data, pos, seg, frame, comps, qt, dc, ac, restart) -> int:
    ns = seg[0]
    ids = {c.id: i for i, c in enumerate(comps)}
    scomps, dc_tabs, ac_tabs = [], {}, {}
    for i in range(ns):
        cid, tdta = seg[1 + 2 * i], seg[2 + 2 * i]
        if cid not in ids:
            raise UnreadableImage(f"JPEG scan names unknown component {cid}")
        ci = ids[cid]
        scomps.append(ci)
        dc_tabs[ci] = dc.get(tdta >> 4)
        ac_tabs[ci] = ac.get(tdta & 15)
        if comps[ci].quant is None:
            if comps[ci].tq not in qt:
                raise UnreadableImage("JPEG quantisation table missing")
            comps[ci].quant = qt[comps[ci].tq]
    ss, se, ahal = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns]
    ah, al = ahal >> 4, ahal & 15
    segs, end = _segments(data, pos)
    scan = _Scan(comps, scomps, frame, restart)
    segs += [b""] * (len(scan.intervals) - len(segs))
    progressive = frame["progressive"]
    if not progressive:
        if any(dc_tabs[ci] is None or ac_tabs[ci] is None for ci in scomps):
            raise UnreadableImage("JPEG Huffman table missing")
        _baseline(scan, segs, comps, dc_tabs, ac_tabs)
    elif ss == 0:
        if se != 0:
            raise UnreadableImage("progressive JPEG scan mixes DC and AC")
        if ah:
            _dc_refine(scan, segs, comps, al)
        else:
            if any(dc_tabs[ci] is None for ci in scomps):
                raise UnreadableImage("JPEG Huffman table missing")
            _dc_first(scan, segs, comps, dc_tabs, al)
    else:
        if ns != 1 or se > 63 or ss > se:
            raise UnreadableImage("bad progressive JPEG AC scan")
        ci = scomps[0]
        if ac_tabs[ci] is None:
            raise UnreadableImage("JPEG Huffman table missing")
        (_ac_refine if ah else _ac_first)(scan, segs, comps[ci], ac_tabs[ci], ss, se, al)
    return end


def decode_jpeg(data: bytes, mode: str) -> np.ndarray:
    """The bytes of a JPEG file as one of `imread.MODES`, in RGB order."""
    from kgtpu_torch.data.jpeg_pixels import to_pixels
    img = parse(data)
    out = to_pixels(img, mode)
    return out if mode == "unchanged" else orient(out, img["orientation"])
