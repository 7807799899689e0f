"""Arithmetic-coded JPEG (SOF9 sequential, SOF10 progressive): a port of
libjpeg-turbo 3.1's `jdarith.c` (and the QM-coder table of `jaricom.c`),
decision by decision in pure Python.

  * The decoder (`Decoder`) keeps libjpeg's C and A registers and its bit
    counter: two bytes fill C at the start of each restart interval; 0xFF
    0x00 is a stuffed 0xFF; past the interval's data (a marker, or the end
    of the file) it feeds zero bytes, as libjpeg does, so a stream that
    ends early, or Huffman data read as arithmetic, still decodes.
  * Statistics: 64 DC bins and 256 AC bins per table, reset at the start
    of each scan (DC only in a DC-first scan, AC only in an AC scan) and
    at each restart, with the DC predictions and contexts; a fixed bin of
    probability 0.5 for signs and DC / AC refinements.
  * Conditioning (DAC): L and U per DC table (defaults 0 and 1), Kx per
    AC table (default 5).
  * A magnitude past 2^15 or a run past the end of the block ("spectral
    overflow") makes libjpeg stop decoding the rest of the interval, which
    keeps the coefficients it had; so does this port.
  * DC values wrap at 16 bits (`(last_dc + v) & 0xffff`, stored as a
    JCOEF) as libjpeg-turbo keeps them.
"""

from __future__ import annotations

from kgtpu_torch.data.jpeg import ZIGZAG

# jaricom.c: (Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS) by index
_QM = [
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080b, 18, 4, 0),
    (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0), (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0),
    (0x0036, 30, 9, 0), (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1), (0x3f25, 36, 16, 0),
    (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0), (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0cef, 43, 21, 0), (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01b1, 54, 28, 0),
    (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0), (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0),
    (0x0068, 62, 33, 0), (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0), (0x2ef1, 67, 40, 0),
    (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0), (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0),
    (0x1177, 73, 45, 0), (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0), (0x04de, 50, 52, 0),
    (0x040f, 50, 53, 0), (0x0363, 51, 54, 0), (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0),
    (0x01f8, 54, 57, 0), (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0), (0x008f, 61, 32, 0),
    (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0), (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0),
    (0x2fe8, 83, 69, 0), (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0), (0x119c, 74, 76, 0),
    (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0), (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0), (0x2516, 86, 71, 0),
    (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0), (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0),
    (0x3824, 99, 93, 0), (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0), (0x3c3d, 104, 100, 0),
    (0x375e, 99, 93, 0), (0x5231, 105, 102, 0), (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0),
    (0x415e, 103, 99, 0), (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1), (0x5522, 112, 109, 0),
    (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0)]
# per state byte (MPS in bit 7, index in bits 0-6): (Qe, state after LPS,
# state after MPS); an LPS at a Switch_MPS index flips the MPS
_QM += [_QM[-1]] * (128 - len(_QM))          # indices past 113 never occur
QE = [_QM[s & 0x7F][0] for s in range(256)]
AFTER_LPS = [(s & 0x80) ^ (_QM[s & 0x7F][1] | (_QM[s & 0x7F][3] << 7)) for s in range(256)]
AFTER_MPS = [(s & 0x80) ^ _QM[s & 0x7F][2] for s in range(256)]
FIXED = 113                    # the fixed probability-0.5 bin's state
DC_BINS, AC_BINS = 64, 256


class Overflow(Exception):
    """libjpeg's `ct = -1`: decoding of the interval stops."""


class Decoder:
    """jdarith.c's arith_decode over one restart interval's bytes (stuffing
    already removed), zeros fed past its end."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0
        self.c = self.a = 0
        self.ct = -16

    def decode(self, st: list, i: int) -> int:
        """The next decision in the bin st[i] (updated)."""
        a, c, ct = self.a, self.c, self.ct
        while a < 0x8000:
            ct -= 1
            if ct < 0:
                data = self.data
                if self.pos < len(data):
                    byte = data[self.pos]
                    self.pos += 1
                else:
                    byte = 0
                c = (c << 8) | byte
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:
                        a = 0x8000
            a <<= 1
        sv = st[i]
        qe = QE[sv]
        a -= qe
        temp = a << ct
        if c >= temp:
            c -= temp
            if a < qe:
                a = qe
                st[i] = AFTER_MPS[sv]
            else:
                a = qe
                st[i] = AFTER_LPS[sv]
                sv ^= 0x80
        elif a < 0x8000:
            if a < qe:
                st[i] = AFTER_LPS[sv]
                sv ^= 0x80
            else:
                st[i] = AFTER_MPS[sv]
        self.a, self.c, self.ct = a, c, ct
        return sv >> 7


def _dc_diff(dec: Decoder, st: list, ctx: int, lo: int, hi: int) -> tuple[int, int]:
    """Figures F.19-F.24: (difference, next context) of one DC value."""
    if not dec.decode(st, ctx):
        return 0, 0
    sign = dec.decode(st, ctx + 1)
    i = ctx + 2 + sign
    m = dec.decode(st, i)
    if m:
        i = 20
        while dec.decode(st, i):
            m <<= 1
            if m == 0x8000:
                raise Overflow
            i += 1
    if m < (1 << lo) >> 1:
        nctx = 0
    elif m > (1 << hi) >> 1:
        nctx = 12 + sign * 4
    else:
        nctx = 4 + sign * 4
    v = m
    i += 14
    m >>= 1
    while m:
        if dec.decode(st, i):
            v |= m
        m >>= 1
    v += 1
    return (-v if sign else v), nctx


def _ac_value(dec: Decoder, st: list, i: int, fixed: list, k: int, kx: int) -> int:
    """Figures F.21-F.24 for an AC coefficient whose bins start at st[i]."""
    sign = dec.decode(fixed, 0)
    i += 2
    m = dec.decode(st, i)
    if m and dec.decode(st, i):
        m <<= 1
        i = 189 if k <= kx else 217
        while dec.decode(st, i):
            m <<= 1
            if m == 0x8000:
                raise Overflow
            i += 1
    v = m
    i += 14
    m >>= 1
    while m:
        if dec.decode(st, i):
            v |= m
        m >>= 1
    v += 1
    return -v if sign else v


def _wrap(v: int) -> int:
    """A value stored in a JCOEF (int16)."""
    v &= 0xFFFF
    return v - 0x10000 if v & 0x8000 else v


def decode_scan(scan, segs: list[bytes], comps, scomps: list[int], dc_sel: dict,
                ac_sel: dict, cond: dict, progressive: bool, ss: int, se: int, ah: int,
                al: int) -> None:
    """Decode one arithmetic-coded scan into the components' coefficients.
    `dc_sel` / `ac_sel`: table number per component index; `cond`: the DAC
    conditioning {"L": {t: L}, "U": {t: U}, "K": {t: K}}."""
    dc_scan = not progressive or (ss == 0 and ah == 0)
    ac_scan = not progressive or ss != 0
    fixed = [FIXED]
    for interval, seg in zip(scan.intervals, segs):
        dec = Decoder(seg)
        dc_stats = {dc_sel[ci]: [0] * DC_BINS for ci in scomps} if dc_scan else {}
        ac_stats = {ac_sel[ci]: [0] * AC_BINS for ci in scomps} if ac_scan else {}
        last = {ci: 0 for ci in scomps}
        ctx = {ci: 0 for ci in scomps}
        try:
            for mcu in interval:
                if not progressive:
                    _sequential(dec, mcu, comps, dc_sel, ac_sel, dc_stats, ac_stats, last, ctx,
                                cond, fixed)
                elif ss == 0 and ah == 0:
                    for ci, base in mcu:
                        t = dc_sel[ci]
                        diff, ctx[ci] = _dc_diff(dec, dc_stats[t], ctx[ci], cond["L"].get(t, 0),
                                                 cond["U"].get(t, 1))
                        last[ci] = (last[ci] + diff) & 0xFFFF
                        comps[ci].coef[base] = _wrap(last[ci] << al)
                elif ss == 0:
                    for ci, base in mcu:
                        if dec.decode(fixed, 0):
                            comps[ci].coef[base] |= 1 << al
                elif ah == 0:
                    ci, base = mcu[0]
                    _ac_first(dec, comps[ci].coef, base, ac_stats[ac_sel[ci]], fixed, ss, se, al,
                              cond["K"].get(ac_sel[ci], 5))
                else:
                    ci, base = mcu[0]
                    _ac_refine(dec, comps[ci].coef, base, ac_stats[ac_sel[ci]], fixed, ss, se,
                               al)
        except Overflow:
            pass


def _sequential(dec, mcu, comps, dc_sel, ac_sel, dc_stats, ac_stats, last, ctx, cond,
                fixed) -> None:
    for ci, base in mcu:
        coef = comps[ci].coef
        t = dc_sel[ci]
        diff, ctx[ci] = _dc_diff(dec, dc_stats[t], ctx[ci], cond["L"].get(t, 0),
                                 cond["U"].get(t, 1))
        last[ci] = (last[ci] + diff) & 0xFFFF
        coef[base] = _wrap(last[ci])
        t = ac_sel[ci]
        st = ac_stats[t]
        kx = cond["K"].get(t, 5)
        k = 0
        while k < 63:
            i = 3 * k
            if dec.decode(st, i):
                break
            while True:
                k += 1
                if dec.decode(st, i + 1):
                    break
                i += 3
                if k >= 63:
                    raise Overflow
            coef[base + ZIGZAG[k]] = _wrap(_ac_value(dec, st, i, fixed, k, kx))


def _ac_first(dec, coef, base, st, fixed, ss, se, al, kx) -> None:
    k = ss
    while k <= se:
        i = 3 * (k - 1)
        if dec.decode(st, i):
            break
        while not dec.decode(st, i + 1):
            i += 3
            k += 1
            if k > se:
                raise Overflow
        coef[base + ZIGZAG[k]] = _wrap(_ac_value(dec, st, i, fixed, k, kx) << al)
        k += 1


def _ac_refine(dec, coef, base, st, fixed, ss, se, al) -> None:
    p1, m1 = 1 << al, -1 << al
    kex = se
    while kex > 0 and not coef[base + ZIGZAG[kex]]:
        kex -= 1
    k = ss
    while k <= se:
        i = 3 * (k - 1)
        if k > kex and dec.decode(st, i):
            break
        while True:
            at = base + ZIGZAG[k]
            c = coef[at]
            if c:
                if dec.decode(st, i + 2):
                    coef[at] = _wrap(c + (m1 if c < 0 else p1))
                break
            if dec.decode(st, i + 1):
                coef[at] = m1 if dec.decode(fixed, 0) else p1
                break
            i += 3
            k += 1
            if k > se:
                raise Overflow
        k += 1
