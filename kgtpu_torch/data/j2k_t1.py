"""JPEG 2000 tier-1 (EBCOT) as OpenJPEG 2.5.3 decodes it (`t1.c`, `mqc.c`,
`t1_generate_luts.c`), one code-block at a time in plain Python.

  * MQ decoder (`opj_mqc_decode_macro`): the 47-state table, 19 contexts
    (all in state 0, but the uniform context in 46, the run-length one in 3
    and zero-coding context 0 in 4), the 32-bit C register with A and CT;
    BYTEIN reads a byte after 0xFF as 7 bits one place higher and feeds
    0xFF forever at a marker (0xFF then a byte over 0x8F), as at the two
    0xFF bytes put after the data.
  * Passes: cleanup first, at bit-plane numbps, then significance
    propagation, magnitude refinement and cleanup at each lower one, for
    the code-block's number of passes and down to bit-plane 1; stripes of
    four rows, column by column.
  * Contexts: zero coding from the significance of the 8 neighbours (h, v
    and d counts; the HH band on d and h + v; the HL band with h and v
    swapped), sign coding from the significance and signs of the four
    direct neighbours (contexts 9-13 and the sign flip), refinement 14 (no
    significant neighbour), 15 (one) or 16 (refined before); the run-length
    mode for a column of four insignificant, unvisited samples with no
    significant neighbour in a full stripe: one decision in the run-length
    context, then two in the uniform one giving the first significant row.
  * Reconstruction (`opj_t1_dec_*pass_*`): with one = 1 << bit-plane, a
    sample turning significant takes +-(one + one / 2) and a refinement adds
    or takes one / 2 from its magnitude: the mid-point of the interval left,
    at twice the coefficient's scale.

One code-block at a time in Python, not in lockstep: a version that ran
all the code-blocks of an image together, their MQ states in NumPy arrays,
was slower on a lossless 512x512 RGB file, since at each scan position few
of its code-blocks had a decision to make, too few to pay for a NumPy
call's overhead.  `chip_smoke.py` [17] times this decoder per 512x512.
"""

from __future__ import annotations

import numpy as np

# The MQ coder's probability states (ISO 15444-1 Table C.2): Qe, NMPS,
# NLPS, SWITCH.
_QE = [0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401, 0x4801, 0x3801,
       0x3001, 0x2401, 0x1C01, 0x1601, 0x5601, 0x5401, 0x5101, 0x4801, 0x3801, 0x3401,
       0x3001, 0x2801, 0x2401, 0x2201, 0x1C01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101,
       0x0AC1, 0x09C1, 0x08A1, 0x0521, 0x0441, 0x02A1, 0x0221, 0x0141, 0x0111, 0x0085,
       0x0049, 0x0025, 0x0015, 0x0009, 0x0005, 0x0001, 0x5601]
_NMPS = [1, 2, 3, 4, 5, 38, 7, 8, 9, 10, 11, 12, 13, 29, 15, 16, 17, 18, 19, 20, 21, 22, 23,
         24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44,
         45, 45, 46]
_NLPS = [1, 6, 9, 12, 29, 33, 6, 14, 14, 14, 17, 18, 20, 21, 14, 14, 15, 16, 17, 18, 19, 19,
         20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40,
         41, 42, 43, 46]
_SWITCH = [1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1] + [0] * 32

# A state index s = 2 * state + mps; Qe of each, and NEXT[(s << 2) | 2 |
# lps_decided] the state after a renormalising decision.
QE = [_QE[s >> 1] for s in range(94)]
NEXT = [0] * (94 * 4)
for _s in range(94):
    _i, _m = _s >> 1, _s & 1
    NEXT[_s * 4 + 2] = 2 * _NMPS[_i] + _m
    NEXT[_s * 4 + 3] = 2 * _NLPS[_i] + (_m ^ _SWITCH[_i])

NCTX, CTX_RL, CTX_UNI = 19, 17, 18

# A sample's flags: significance of its NW N NE W E SW S SE neighbours,
# the signs of its N W E S neighbours, then its own state.
NW, N_, NE, W_, E_, SW, S_, SE = (1 << k for k in range(8))
NEG_N, NEG_W, NEG_E, NEG_S = (1 << k for k in range(8, 12))
SIG, PI, MU = 1 << 12, 1 << 13, 1 << 14


def _zc_lut() -> list:
    lut = [0] * (4 * 256)
    for orient in range(4):
        for f in range(256):
            h = bool(f & W_) + bool(f & E_)
            v = bool(f & N_) + bool(f & S_)
            d = bool(f & NW) + bool(f & NE) + bool(f & SW) + bool(f & SE)
            if orient == 1:
                h, v = v, h
            if orient != 3:
                if h == 0:
                    n = (0 if d == 0 else 1 if d == 1 else 2) if v == 0 else (3 if v == 1 else 4)
                elif h == 1:
                    n = (5 if d == 0 else 6) if v == 0 else 7
                else:
                    n = 8
            else:
                hv = h + v
                if d == 0:
                    n = 0 if hv == 0 else 1 if hv == 1 else 2
                elif d == 1:
                    n = 3 if hv == 0 else 4 if hv == 1 else 5
                elif d == 2:
                    n = 6 if hv == 0 else 7
                else:
                    n = 8
            lut[orient * 256 + f] = n
    return lut


ZC = _zc_lut()
_SC_TABLE = {(1, 1): (13, 0), (1, 0): (12, 0), (1, -1): (11, 0), (0, 1): (10, 0), (0, 0): (9, 0),
             (0, -1): (10, 1), (-1, 1): (11, 1), (-1, 0): (12, 1), (-1, -1): (13, 1)}
SC_CTX = [0] * 4096
SC_XOR = [0] * 4096
for _f in range(4096):
    def _c(sig, neg, f=_f):
        return 0 if not f & sig else (-1 if f & neg else 1)
    _h = max(-1, min(1, _c(W_, NEG_W) + _c(E_, NEG_E)))
    _v = max(-1, min(1, _c(N_, NEG_N) + _c(S_, NEG_S)))
    SC_CTX[_f], SC_XOR[_f] = _SC_TABLE[(_h, _v)]
_LAYOUTS: dict = {}


def _layout(w: int, h: int) -> dict:
    """Scan order of a w x h code-block on its padded grid (stride w + 2):
    raster indices in scan order, each index's scan rank (-1 off the
    block), the columns of the stripes (first rank, rows) and each index's
    column."""
    key = (w, h)
    if key in _LAYOUTS:
        return _LAYOUTS[key]
    W = w + 2
    scan, cols = [], []
    for y in range(0, h, 4):
        rows = min(4, h - y)
        for x in range(w):
            cols.append((len(scan), rows))
            scan += [(y + j + 1) * W + x + 1 for j in range(rows)]
    rank = [-1] * (W * (h + 2))
    for r, i in enumerate(scan):
        rank[i] = r
    col_of = [-1] * (W * (h + 2))
    for k, (r0, rows) in enumerate(cols):
        for j in range(rows):
            col_of[scan[r0 + j]] = k
    lay = {"scan_l": scan, "rank": rank, "cols": cols, "col_of": col_of}
    _LAYOUTS[key] = lay
    return lay


def decode_one(b: dict) -> np.ndarray:
    """Tier-1 of one code-block in plain Python.  Each codeword segment
    gets a fresh decoder over its own bytes and two 0xFF bytes: the MQ
    decoder with OpenJPEG's register (C, A, CT and the byte pointer), or,
    for BYPASS's raw segments, its raw bit reader.  The passes visit, in
    scan order, only the samples that can need a decision: the
    significance and cleanup passes the samples insignificant when the
    bit-plane starts (the cleanup pass by columns), the refinement pass the
    samples significant then."""
    w, h, orient = b["w"], b["h"], b["orient"] * 256
    style, data = b["style"], bytes(b["data"])
    bypass, reset, vsc, segsym = style & 0x01, style & 0x02, style & 0x08, style & 0x20
    lay = _layout(w, h)
    scan_l, cols, col_of = lay["scan_l"], lay["cols"], lay["col_of"]
    W = w + 2
    flags = [0] * (W * (h + 2))
    coef = [0] * (W * (h + 2))
    start = [0] * NCTX
    start[CTX_UNI], start[CTX_RL], start[0] = 2 * 46, 2 * 3, 2 * 4
    st = list(start)
    zc, sc_ctx, sc_xor, qe_t, nxt = ZC, SC_CTX, SC_XOR, QE, NEXT
    buf = b"\xff\xff"
    bp = c = ct = a = 0

    def init_mq(seg: bytes) -> None:
        """INITDEC over the segment and two 0xFF bytes."""
        nonlocal buf, bp, c, ct, a
        buf = seg + b"\xff\xff"
        bp = 0
        c = buf[0] << 16
        if buf[0] == 0xFF and buf[1] > 0x8F:
            c += 0xFF00
            ct = 8
        else:
            bp = 1
            c += buf[1] << (9 if buf[0] == 0xFF else 8)
            ct = 7 if buf[0] == 0xFF else 8
        c = (c << 7) & 0xFFFFFFFF
        ct -= 7
        a = 0x8000

    def init_raw(seg: bytes) -> None:
        nonlocal buf, bp, c, ct
        buf = seg + b"\xff\xff"
        bp = c = ct = 0

    def raw():
        """`opj_mqc_raw_decode`: the bits of each byte, MSB first; after
        0xFF a byte of 7 bits, or 1s forever at a marker."""
        nonlocal c, ct, bp
        if ct == 0:
            if c == 0xFF:
                if buf[bp] > 0x8F:
                    ct = 8
                else:
                    c = buf[bp]
                    bp += 1
                    ct = 7
            else:
                c = buf[bp]
                bp += 1
                ct = 8
        ct -= 1
        return (c >> ct) & 1

    def mq(cx):
        nonlocal a, c, ct, bp
        s = st[cx]
        qe = qe_t[s]
        a -= qe
        if (c >> 16) < qe:
            x = a >= qe
            a = qe
        else:
            c -= qe << 16
            if a & 0x8000:
                return s & 1
            x = a < qe
        st[cx] = nxt[(s << 2) | 2 | x]
        n = 16 - a.bit_length()                 # RENORMD's shifts
        if n <= ct:                             # no byte to read on the way
            a <<= n
            c = (c << n) & 0xFFFFFFFF
            ct -= n
            return (s & 1) ^ x
        while a < 0x8000:
            if ct == 0:
                if buf[bp] == 0xFF:
                    if buf[bp + 1] > 0x8F:
                        c += 0xFF00
                        ct = 8
                    else:
                        bp += 1
                        c += buf[bp] << 9
                        ct = 7
                else:
                    bp += 1
                    c += buf[bp] << 8
                    ct = 8
            a <<= 1
            c = (c << 1) & 0xFFFFFFFF
            ct -= 1
        return (s & 1) ^ x

    newsig: list = []
    # under VSC a stripe's first row does not tell the row above it
    # (`opj_t1_update_flags` leaves the word of the stripe above alone)
    quiet_north = set(range(W, W * (h + 1), 4 * W)) if vsc else ()

    def turn(i, neg, oph):
        """Sample i turns significant with sign neg: its neighbours learn."""
        f = flags
        north = i - i % W not in quiet_north
        if neg:
            coef[i] = -oph
            if north:
                f[i - W - 1] |= SE
                f[i - W] |= S_ | NEG_S
                f[i - W + 1] |= SW
            f[i - 1] |= E_ | NEG_E
            f[i + 1] |= W_ | NEG_W
            f[i + W - 1] |= NE
            f[i + W] |= N_ | NEG_N
            f[i + W + 1] |= NW
        else:
            coef[i] = oph
            if north:
                f[i - W - 1] |= SE
                f[i - W] |= S_
                f[i - W + 1] |= SW
            f[i - 1] |= E_
            f[i + 1] |= W_
            f[i + W - 1] |= NE
            f[i + W] |= N_
            f[i + W + 1] |= NW
        f[i] |= SIG
        newsig.append(i)

    sig: list = []                      # raster indices, in scan order
    insig = list(scan_l)
    rank = lay["rank"]
    top, mb = b["numbps"], b["mb"]
    k, at = 0, 0
    for nseg, length in b["segs"]:
        # BYPASS: significance and refinement passes below the fourth
        # bit-plane (of the code-block's Mb, the ROI shift aside) are raw
        is_raw = bypass and k % 3 and top - (k + 2) // 3 <= mb - 4
        (init_raw if is_raw else init_mq)(data[at:at + length])
        at += length
        for _ in range(nseg):
            bpl = top - (k + 2) // 3
            if bpl < 1:
                break
            one = 1 << bpl
            oph = one | (one >> 1)
            kind = k % 3
            if kind == 1:                                # significance propagation
                if newsig:                               # a new bit-plane: re-sort
                    sig = sorted(sig + newsig, key=rank.__getitem__)
                    newsig.clear()
                    insig = [i for i in insig if not flags[i] & SIG]
                if is_raw:
                    for i in insig:
                        f = flags[i]
                        if f & 0xFF and not f & (SIG | PI):
                            flags[i] = f | PI
                            if raw():
                                turn(i, raw(), oph)
                else:
                    for i in insig:
                        f = flags[i]
                        if f & 0xFF and not f & (SIG | PI):
                            flags[i] = f | PI
                            if mq(zc[orient + (f & 0xFF)]):
                                g = f & 0xFFF
                                turn(i, mq(sc_ctx[g]) ^ sc_xor[g], oph)
            elif kind == 2:                              # magnitude refinement
                half = one >> 1
                for i in sig:
                    f = flags[i]
                    if raw() if is_raw else mq(16 if f & MU else 15 if f & 0xFF else 14):
                        coef[i] += -half if coef[i] < 0 else half
                    else:
                        coef[i] += half if coef[i] < 0 else -half
                    flags[i] = f | MU
            else:                                        # cleanup
                if newsig and k:
                    insig = [i for i in insig if not flags[i] & SIG]
                todo = sorted({col_of[i] for i in insig if not flags[i] & (SIG | PI)})
                for col in todo:
                    r0, rows = cols[col]
                    i0 = scan_l[r0]
                    first = 0
                    if rows == 4 and not (flags[i0] | flags[i0 + W] | flags[i0 + 2 * W]
                                          | flags[i0 + 3 * W]) & (0xFF | SIG | PI):
                        if not mq(CTX_RL):
                            continue
                        r = mq(CTX_UNI) << 1
                        r |= mq(CTX_UNI)
                        i = i0 + r * W
                        g = flags[i] & 0xFFF
                        turn(i, mq(sc_ctx[g]) ^ sc_xor[g], oph)
                        first = r + 1
                    for j in range(first, rows):
                        i = i0 + j * W
                        f = flags[i]
                        if not f & (SIG | PI) and mq(zc[orient + (f & 0xFF)]):
                            g = f & 0xFFF
                            turn(i, mq(sc_ctx[g]) ^ sc_xor[g], oph)
                for i in insig:
                    flags[i] &= ~PI
                if segsym:                               # four symbols, not checked
                    for _ in range(4):
                        mq(CTX_UNI)
            if reset and not is_raw:
                st[:] = start
            k += 1
    return np.array(coef, np.int64).reshape(h + 2, W)[1:-1, 1:-1].astype(np.int32)


def decode_blocks(blocks: list) -> list:
    """Tier-1 of code-blocks given as dicts of w, h, orient (0 LL, 1 HL, 2
    LH, 3 HH), passes, numbps (the bit-plane of the first cleanup pass, ROI
    shift included), mb (numbps without the ROI shift), style (the
    code-block style byte), data and segs ((passes, bytes) of each codeword
    segment): returns each one's [h, w] int32 coefficients at twice their
    scale (OpenJPEG's data before it halves or scales them).  HT code-blocks
    (style 0x40) go to `data/j2k_ht.py`, which takes `Mb` (the band's
    bit-planes), `roi` and `base` (where the block's data starts, modulo
    4) as well."""
    from kgtpu_torch.data.j2k_ht import decode_ht
    return [decode_ht(b) if b["style"] & 0x40
            else decode_one(b) if b["passes"] and b["numbps"] >= 1
            else np.zeros((b["h"], b["w"]), np.int32) for b in blocks]
