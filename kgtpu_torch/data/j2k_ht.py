"""JPEG 2000 HT code-blocks (ITU-T T.814, Part 15) as OpenJPEG 2.5.3 decodes
them (`ht_dec.c`, `opj_t1_ht_decode_cblk`), one code-block at a time in
plain Python.

  * Checks, in OpenJPEG's order; each failure stops the tile (cv2 returns
    None): more than 3 passes in the first two codeword
    segments (a second segment of length 0 leaves the cleanup pass alone,
    with a warning); Mb over 30; more zero bit-planes than Mb (as many as
    Mb leave the cleanup pass alone); the cleanup segment's length Lcup
    (2 or more, within the data) and Scup (its last two bytes: 2 <= Scup
    <= min(Lcup, 4079)); a MEL stream whose first bytes hold 0xFF then a
    byte over 0x8F ("Incorrect MEL segment sequence"); u_q too large for
    the zero bit-planes; a VLC codeword that makes a sample outside the
    code-block significant.
  * Cleanup pass: quads of 2x2 samples, two at a time along each pair of
    rows.  Three streams share the segment: MagSgn forward from its start
    (after 0xFF a byte gives 7 bits; 0xFF past its end), MEL forward from
    Lcup - Scup (MSB first, after 0xFF 7 bits; the low nibble of byte Lcup
    - 2 read as 0xF; 0xFF past its end) and VLC backward from the high
    nibble of byte Lcup - 2 (LSB first; a byte whose low 7 bits are all
    ones after a byte over 0x8F gives 7 bits; zeros past its end).  A
    quad's context comes from the significance of its neighbours (the
    first row from the quad to its left, the others from the row above as
    well); context 0 spends a MEL event, and the VLC table entry gives
    the significance pattern, u_off and the exponent-MSB patterns; u_q
    comes from the UVLC (prefix 1, 01, 001, 000 for 1, 2, 3 + 1 bit, 5 +
    5 bits; in the first row a MEL event when both quads have u_off, and
    the single-bit second u after a first of 3 or more), plus kappa (1,
    or in the other rows, for a quad with two or more significant samples,
    the largest exponent above it less 1).  Each significant sample reads
    m = U_q - e_k bits of MagSgn: its sign, then the bits of mu - 1 below
    the implicit e_1 MSB.
  * SigProp and MagRef (the second segment: SigProp forward from its
    start, zeros past its end; MagRef backward from its end, as VLC),
    one stripe of 4 rows behind the cleanup: MagRef refines the cleanup's
    samples of each stripe once the stripe is decoded; SigProp, once the
    next stripe is, decodes for each group of 4 columns the significance
    of insignificant samples with a significant neighbour (8-connected;
    the stripe below only through its cleanup samples, none under VSC),
    then their signs.

Values as OpenJPEG keeps them, then as `j2k_t1.decode_one` returns them:
with p = numbps = Mb + 1 - zero bit-planes, a cleanup sample is mu * 2^p +
2^(p-1), a SigProp one 3 * 2^(p-2) and MagRef puts the bin's centre at 2^(p-2),
at twice the coefficient's scale, sign and magnitude in 32 bits (their C
arithmetic wraps as it does there), then two's complement.
"""

from __future__ import annotations

import numpy as np

from kgtpu_torch.data.imread import UnreadableImage
from kgtpu_torch.data.j2k_ht_tables import VLC_TBL0, VLC_TBL1

M32 = 0xFFFFFFFF
# MEL exponents of the 13 states (T.814 Table 2)
MEL_EXP = (0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5)
# UVLC prefixes by their 3 low bits (T.814 Table 3): prefix length, suffix
# length, prefix value
UVLC = tuple({0: (3, 5, 5), 4: (3, 1, 3)}.get(k, (1, 0, 1) if k & 1 else (2, 0, 2))
             for k in range(8))


def _resolve(d: bytes, nb: list, fill: int, extra: int) -> list:
    """Bytes `d` (in reading order, LSB first) of `nb` bits each as the C
    readers see them: each byte OR-ed in whole at its position, so the
    bits of a short byte above its count land on the next ones; then 32-bit
    words, LSB first, and `extra` words of `fill` bits."""
    words, acc, pos = [], 0, 0
    for v, n in zip(d, nb):
        acc |= v << pos
        pos += n
        if pos >= 32:
            words.append(acc & M32)
            acc >>= 32
            pos -= 32
    if pos:
        acc &= (1 << pos) - 1
        words.append((acc | (M32 ^ ((1 << pos) - 1))) if fill else acc)
    return words + [M32 if fill else 0] * extra


def _forward(data: bytes, fill_byte: int, extra: int) -> list:
    """`frwd_init` / `frwd_read`: bytes LSB first, after 0xFF a byte gives 7
    bits; `fill_byte` past the end."""
    d = bytes(data) + bytes([fill_byte]) * 8
    nb = [8] + [7 if v == 0xFF else 8 for v in d[:-1]]
    return _resolve(d, nb, fill_byte & 1, extra)


def _backward(data: bytes, prev0: int, extra: int) -> list:
    """`rev_read` / `rev_read_mrp`: bytes (already reversed) LSB first; a
    byte whose low 7 bits are ones, after one over 0x8F, gives 7 bits;
    zeros past the end.  `prev0` stands for the byte before the first."""
    d = bytes(data) + bytes(8)
    prev = bytes([prev0]) + d[:-1]
    nb = [7 if p > 0x8F and v & 0x7F == 0x7F else 8 for p, v in zip(prev, d)]
    return _resolve(d, nb, 0, extra)


class _Stream:
    """A bit stream read 32 bits at a time from `pos` (the C readers'
    fetch / advance; the bits they see past what they have read are never
    used, so the whole stream can be resolved up front)."""

    __slots__ = ("w", "pos")

    def __init__(self, words: list):
        self.w, self.pos = words, 0

    def fetch(self) -> int:
        k, s = self.pos >> 5, self.pos & 31
        return ((self.w[k] | (self.w[k + 1] << 32)) >> s) & M32


def _vlc_stream(seg: bytes, lcup: int, scup: int, extra: int) -> list:
    """`rev_init`: the high nibble of byte Lcup - 2 (3 bits when its low
    three are ones), then bytes Lcup - 3 down to Lcup - Scup."""
    d0 = seg[lcup - 2]
    nib = d0 >> 4
    body = bytes(reversed(seg[lcup - scup:lcup - 2])) + bytes(8)
    prev = bytes([d0 | 0xF]) + body[:-1]
    nb = [3 if nib & 7 == 7 else 4] + [7 if p > 0x8F and v & 0x7F == 0x7F else 8
                                        for p, v in zip(prev, body)]
    return _resolve(bytes([nib]) + body, nb, 0, extra)


class _Mel:
    """`mel_decode` / `mel_get_run`: runs of MEL events, MSB first from
    Lcup - Scup, Scup - 1 bytes (the last with its low nibble set), then
    0xFF; after 0xFF a byte gives its 7 low bits."""

    __slots__ = ("bits", "i", "k")

    def __init__(self, seg: bytes, lcup: int, scup: int):
        d = bytearray(seg[lcup - scup:lcup - 1])
        d[-1] |= 0xF
        out, prev = [], 0
        for b in d:
            out.extend((b >> s) & 1 for s in range(6 if prev == 0xFF else 7, -1, -1))
            prev = b
        self.bits, self.i, self.k = out, 0, 0

    def _bit(self) -> int:
        i = self.i
        self.i = i + 1
        return self.bits[i] if i < len(self.bits) else 1

    def run(self) -> int:
        e = MEL_EXP[self.k]
        if self._bit():
            self.k = min(self.k + 1, 12)
            return ((1 << e) - 1) << 1
        r = 0
        for _ in range(e):
            r = (r << 1) | self._bit()
        self.k = max(self.k - 1, 0)
        return (r << 1) + 1


def _mel_sequence_ok(seg: bytes, lcup: int, scup: int, base: int) -> bool:
    """`mel_init`'s check over the bytes it reads one at a time, 4 - (the
    MEL address mod 4) of them: no byte over 0x8F after 0xFF (the byte
    under its pointer, which stays on byte Lcup - 1 once the MEL's Scup - 1
    bytes are read)."""
    at = lcup - scup
    size = scup - 1
    unstuff = False
    for i in range(4 - ((base + at) & 3)):
        if unstuff and seg[at + min(i, size)] > 0x8F:     # the pointer stops at the end
            return False
        d = seg[at + i] if i < size else 0xFF
        if i == size - 1:
            d |= 0xF
        unstuff = d == 0xFF
    return True


def _uvlc(vlc: int, mode: int, initial: bool) -> tuple[int, int, int]:
    """`decode_init_uvlc` / `decode_noninit_uvlc`: (u_q0 + 1, u_q1 + 1,
    bits consumed); mode 4 is the first row's MEL event of 1."""
    if mode == 0:
        return 1, 1, 0
    if mode <= 2:
        pl, sl, pv = UVLC[vlc & 7]
        d = pv + ((vlc >> pl) & ((1 << sl) - 1))
        return (d + 1, 1, pl + sl) if mode == 1 else (1, d + 1, pl + sl)
    pl1, sl1, pv1 = UVLC[vlc & 7]
    vlc >>= pl1
    used = pl1
    if initial and mode == 3 and pl1 > 2:
        u1 = (vlc & 1) + 2
        vlc >>= 1
        d1 = pv1 + (vlc & ((1 << sl1) - 1))
        return d1 + 1, u1, used + 1 + sl1
    pl2, sl2, pv2 = UVLC[vlc & 7]
    vlc >>= pl2
    used += pl2
    d1 = pv1 + (vlc & ((1 << sl1) - 1))
    vlc >>= sl1
    d2 = pv2 + (vlc & ((1 << sl2) - 1))
    add = 3 if mode == 4 else 1
    return d1 + add, d2 + add, used + sl1 + sl2


def decode_ht(b: dict) -> np.ndarray:
    """One HT code-block (the dict `j2k_t1.decode_blocks` takes, with `Mb`
    the band's bit-planes and `base` the address of the block's data modulo
    4, for `mel_init`'s check; `jpeg2000.decode_codestream` refuses a tile
    of HT blocks with an ROI shift before) as [h, w] int32 at twice the
    coefficients' scale.  A block OpenJPEG stops at raises
    `UnreadableImage`: its tile fails."""
    w, h = b["w"], b["h"]
    mb = b["Mb"]
    out = np.zeros((h, w), np.int32)
    if mb == 0 or not b["segs"]:
        return out
    data = bytes(b["data"])
    segs = b["segs"]
    passes = segs[0][0] + (segs[1][0] if len(segs) > 1 else 0)
    len1 = segs[0][1] if passes > 0 else 0
    len2 = segs[1][1] if passes > 1 and len(segs) > 1 else 0
    if passes > 1 and len2 == 0:
        passes = 1
    if passes > 3:
        raise UnreadableImage(f"JPEG 2000 HT code-block of {passes} passes (OpenJPEG decodes 3 "
                        "at most)")
    if mb > 30:
        raise UnreadableImage("JPEG 2000 HT code-block of more than 30 bit-planes")
    zbp = mb + 1 - b["numbps"]
    if zbp > mb:
        raise UnreadableImage("JPEG 2000 HT code-block of more zero bit-planes than bit-planes")
    if zbp == mb:
        passes = min(passes, 1)
    if len1 < 2 or len1 > len(data) or len1 + len2 > len(data):
        raise UnreadableImage("JPEG 2000 HT code-block lengths")
    lcup = len1
    scup = (data[lcup - 1] << 4) + (data[lcup - 2] & 0xF)
    if scup < 2 or scup > lcup or scup > 4079:
        raise UnreadableImage("JPEG 2000 HT code-block Scup out of range")
    if not _mel_sequence_ok(data, lcup, scup, b["base"]):
        raise UnreadableImage("JPEG 2000 HT code-block MEL sequence")
    p = b["numbps"]
    dec = _cleanup(data, lcup, scup, w, h, p, zbp + 1, passes, len2,
                   bool(b["style"] & 0x08))
    v = np.array(dec, np.int64).reshape(h, w)
    mag = v & 0x7FFFFFFF
    out[:] = np.where(v & 0x80000000, -mag, mag)
    return out


def _cleanup(data, lcup, scup, w, h, p, zp1, passes, len2, causal) -> list:
    stride = w
    dec = [0] * (w * h)
    quads = (w + 1) // 2 + 2
    vlc = _Stream(_vlc_stream(data, lcup, scup, 4 * quads + 8))
    ms = _Stream(_forward(data[:lcup - scup], 0xFF, w * h + 8))
    mel = _Mel(data, lcup, scup)
    nwords = 132
    sigma1, sigma2 = [0] * nwords, [0] * nwords
    mbr1, mbr2 = [0] * nwords, [0] * nwords
    sp_s = mr_s = None
    if passes > 1:
        sp_s = _Stream(_forward(data[lcup:lcup + len2], 0, w * h // 8 + 16))
    if passes > 2:
        mr_s = _Stream(_backward(bytes(reversed(data[lcup:lcup + len2])), 0x90,
                                 w * h // 16 + 16))
    ls = [0] * (quads + 4)
    run = mel.run()
    tbl0, tbl1 = VLC_TBL0, VLC_TBL1

    def sample(q, n, u, at):
        """MagSgn of sample n of a quad (table entry q, U_q u) into dec[at]."""
        s = ms
        k, sh = s.pos >> 5, s.pos & 31
        val = ((s.w[k] | (s.w[k + 1] << 32)) >> sh) & M32
        m = u - ((q >> (12 + n)) & 1)
        s.pos += m
        v = val & (((1 << (m & 31)) - 1) & M32)
        v |= (((q >> (8 + n)) & 1) << (m & 31)) & M32
        v |= 1
        dec[at] = ((val & 1) << 31) | ((((v + 2) << ((p - 1) & 31)) & M32))
        return v

    # the initial pair of rows
    c_q = 0
    sip, sip_shift = 0, 0
    for x in range(0, w, 4):
        vv = vlc.fetch()
        q0 = tbl0[(c_q << 7) | (vv & 0x7F)]
        if c_q == 0:
            run -= 2
            if run != -1:
                q0 = 0
            if run < 0:
                run = mel.run()
        c_q = ((q0 & 0x10) >> 4) | ((q0 & 0xE0) >> 5)
        vlc.pos += q0 & 7
        vv >>= q0 & 7
        sigma1[sip] |= (((q0 & 0x30) >> 4) | ((q0 & 0xC0) >> 2)) << sip_shift
        q1 = 0
        if x + 2 < w:
            q1 = tbl0[(c_q << 7) | (vv & 0x7F)]
            if c_q == 0:
                run -= 2
                if run != -1:
                    q1 = 0
                if run < 0:
                    run = mel.run()
            c_q = ((q1 & 0x10) >> 4) | ((q1 & 0xE0) >> 5)
            vlc.pos += q1 & 7
            vv >>= q1 & 7
        sigma1[sip] |= ((q1 & 0x30) | ((q1 & 0xC0) << 2)) << (4 + sip_shift)
        if x & 7:
            sip += 1
        sip_shift ^= 0x10
        mode = ((q0 & 0x8) >> 3) | ((q1 & 0x8) >> 2)
        if mode == 3:
            run -= 2
            if run == -1:
                mode = 4
            if run < 0:
                run = mel.run()
        u0, u1, used = _uvlc(vv, mode, True)
        if u0 > zp1 or u1 > zp1:
            raise UnreadableImage("JPEG 2000 HT code-block: U_q above the zero bit-planes + 1")
        vlc.pos += used
        locs = 0xFF
        if x + 4 > w:
            locs >>= (x + 4 - w) << 1
        if h <= 1:
            locs &= 0x55
        if (((q0 & 0xF0) >> 4) | (q1 & 0xF0)) & ~locs & 0xFF:
            raise UnreadableImage("JPEG 2000 HT code-block: significant samples outside it")
        qi = x >> 1
        # first quad
        if q0 & 0x10:
            sample(q0, 0, u0, x)
        if q0 & 0x20:
            v = sample(q0, 1, u0, x + stride)
            t = ls[qi] & 0x7F
            e = v.bit_length()
            ls[qi] = 0x80 | (t if t > e else e)
        if q0 & 0x40:
            sample(q0, 2, u0, x + 1)
        ls[qi + 1] = 0
        if q0 & 0x80:
            v = sample(q0, 3, u0, x + 1 + stride)
            ls[qi + 1] = 0x80 | v.bit_length()
        # second quad
        if q1 & 0x10:
            sample(q1, 0, u1, x + 2)
        if q1 & 0x20:
            v = sample(q1, 1, u1, x + 2 + stride)
            t = ls[qi + 1] & 0x7F
            e = v.bit_length()
            ls[qi + 1] = 0x80 | (t if t > e else e)
        if q1 & 0x40:
            sample(q1, 2, u1, x + 3)
        ls[qi + 2] = 0
        if q1 & 0x80:
            v = sample(q1, 3, u1, x + 3 + stride)
            ls[qi + 2] = 0x80 | v.bit_length()

    y = 2
    while y < h:
        sip_shift ^= 0x2
        sip_shift &= 0xFFFFFFEF
        sig = sigma2 if y & 0x4 else sigma1
        sip = 0
        ls0 = ls[0]
        ls[0] = 0
        row = y * stride
        c_q = 0
        for x in range(0, w, 4):
            qi = x >> 1
            c_q |= ls0 >> 7
            c_q |= (ls[qi + 1] >> 5) & 0x4
            vv = vlc.fetch()
            q0 = tbl1[(c_q << 7) | (vv & 0x7F)]
            if c_q == 0:
                run -= 2
                if run != -1:
                    q0 = 0
                if run < 0:
                    run = mel.run()
            c_q = ((q0 & 0x40) >> 5) | ((q0 & 0x80) >> 6)
            vlc.pos += q0 & 7
            vv >>= q0 & 7
            sig[sip] |= (((q0 & 0x30) >> 4) | ((q0 & 0xC0) >> 2)) << sip_shift
            q1 = 0
            if x + 2 < w:
                c_q |= ls[qi + 1] >> 7
                c_q |= (ls[qi + 2] >> 5) & 0x4
                q1 = tbl1[(c_q << 7) | (vv & 0x7F)]
                if c_q == 0:
                    run -= 2
                    if run != -1:
                        q1 = 0
                    if run < 0:
                        run = mel.run()
                c_q = ((q1 & 0x40) >> 5) | ((q1 & 0x80) >> 6)
                vlc.pos += q1 & 7
                vv >>= q1 & 7
            sig[sip] |= ((q1 & 0x30) | ((q1 & 0xC0) << 2)) << (4 + sip_shift)
            if x & 7:
                sip += 1
            sip_shift ^= 0x10
            mode = ((q0 & 0x8) >> 3) | ((q1 & 0x8) >> 2)
            u0, u1, used = _uvlc(vv, mode, False)
            vlc.pos += used
            if (q0 & 0xF0) & ((q0 & 0xF0) - 1):
                e = max(ls0 & 0x7F, ls[qi + 1] & 0x7F)
                u0 += e - 2 if e > 2 else 0
            if (q1 & 0xF0) & ((q1 & 0xF0) - 1):
                e = max(ls[qi + 1] & 0x7F, ls[qi + 2] & 0x7F)
                u1 += e - 2 if e > 2 else 0
            if u0 > zp1 or u1 > zp1:
                raise UnreadableImage("JPEG 2000 HT code-block: U_q above the bit-planes + 1")
            ls0 = ls[qi + 2]
            ls[qi + 1] = ls[qi + 2] = 0
            locs = 0xFF
            if x + 4 > w:
                locs >>= (x + 4 - w) << 1
            if y + 2 > h:
                locs &= 0x55
            if (((q0 & 0xF0) >> 4) | (q1 & 0xF0)) & ~locs & 0xFF:
                raise UnreadableImage("JPEG 2000 HT code-block: significant samples outside it")
            at = row + x
            if q0 & 0x10:
                sample(q0, 0, u0, at)
            if q0 & 0x20:
                v = sample(q0, 1, u0, at + stride)
                t = ls[qi] & 0x7F
                e = v.bit_length()
                ls[qi] = 0x80 | (t if t > e else e)
            if q0 & 0x40:
                sample(q0, 2, u0, at + 1)
            if q0 & 0x80:
                v = sample(q0, 3, u0, at + 1 + stride)
                ls[qi + 1] = 0x80 | v.bit_length()
            if q1 & 0x10:
                sample(q1, 0, u1, at + 2)
            if q1 & 0x20:
                v = sample(q1, 1, u1, at + 2 + stride)
                t = ls[qi + 1] & 0x7F
                e = v.bit_length()
                ls[qi + 1] = 0x80 | (t if t > e else e)
            if q1 & 0x40:
                sample(q1, 2, u1, at + 3)
            if q1 & 0x80:
                v = sample(q1, 3, u1, at + 3 + stride)
                ls[qi + 2] = 0x80 | v.bit_length()
        y += 2
        if passes > 1 and y & 3 == 0:
            if passes > 2:
                _magref(dec, sigma1 if y & 0x4 else sigma2, (y - 4) * stride, w, stride, p,
                        mr_s)
            if y >= 4:
                _membership(sigma1 if y & 0x4 else sigma2, mbr1 if y & 0x4 else mbr2, w)
            if y >= 8:
                cur_sig, cur_mbr = (sigma2, mbr2) if y & 0x4 else (sigma1, mbr1)
                nxt_sig, nxt_mbr = (sigma1, mbr1) if y & 0x4 else (sigma2, mbr2)
                _from_next(cur_sig, cur_mbr, nxt_sig, w, causal)
                _sigprop(dec, cur_sig, cur_mbr, nxt_sig, nxt_mbr, (y - 8) * stride, w,
                         stride, p, sp_s, M32)
                for i in range(((w + 7) >> 3) + 1):
                    cur_sig[i] = 0
    if passes > 1:
        if passes > 2 and h & 3 in (1, 2):
            _magref(dec, sigma2 if h & 0x4 else sigma1, (h & ~3) * stride, w, stride, p, mr_s)
        if h & 3 in (1, 2):
            _membership(sigma2 if h & 0x4 else sigma1, mbr2 if h & 0x4 else mbr1, w)
        st = h - ((((h + 1) & 3) + 3) if h > 6 else h)
        for y in range(st, h, 4):
            pattern = {3: 0x77777777, 2: 0x33333333, 1: 0x11111111}.get(h - y, M32)
            cur_sig, cur_mbr = (sigma2, mbr2) if y & 0x4 else (sigma1, mbr1)
            nxt_sig, nxt_mbr = (sigma1, mbr1) if y & 0x4 else (sigma2, mbr2)
            if h - y > 4:
                _from_next(cur_sig, cur_mbr, nxt_sig, w, causal)
            _sigprop(dec, cur_sig, cur_mbr, nxt_sig, nxt_mbr, y * stride, w, stride, p, sp_s,
                     pattern)
    return dec


def _magref(dec, sig_arr, base, w, stride, p, s) -> None:
    """One stripe of MagRef: a bit per cleanup-significant sample, by
    columns of 8; 0 takes the bin's centre off, then the new centre."""
    half = (1 << ((p - 2) & 31)) & M32
    flip = (1 << ((p - 1) & 31)) & M32
    for g, i in enumerate(range(0, w, 8)):
        k, sh = s.pos >> 5, s.pos & 31
        cwd = ((s.w[k] | (s.w[k + 1] << 32)) >> sh) & M32
        sg = sig_arr[g]
        if sg:
            for j in range(8):
                col = (sg >> (4 * j)) & 0xF
                if not col:
                    continue
                for r in range(4):
                    if col >> r & 1:
                        at = base + r * stride + i + j
                        dec[at] = (dec[at] ^ (flip if not cwd & 1 else 0)) | half
                        cwd >>= 1
        s.pos += bin(sg).count("1")


def _membership(sig, mbr, w) -> None:
    """The samples of a stripe with a significant neighbour in it."""
    prev = 0
    for g in range((w + 7) >> 3):
        s0 = sig[g]
        m = s0 | (prev >> 28) | ((s0 << 4) & M32) | (s0 >> 4) | ((sig[g + 1] << 28) & M32)
        prev = s0
        z = m | ((m & 0x77777777) << 1) | ((m & 0xEEEEEEEE) >> 1)
        mbr[g] = z & ~s0 & M32


def _from_next(cur_sig, cur_mbr, nxt_sig, w, causal) -> None:
    """Membership from the next stripe's first row (not under VSC)."""
    prev = 0
    for g in range((w + 7) >> 3):
        n0 = nxt_sig[g]
        t = n0 | (prev >> 28) | ((n0 << 4) & M32) | (n0 >> 4) | ((nxt_sig[g + 1] << 28) & M32)
        prev = n0
        if not causal:
            cur_mbr[g] |= (t & 0x11111111) << 3
        cur_mbr[g] &= ~cur_sig[g] & M32


# significance spreading to the samples after one in the scan, by its row
_SPREAD = (0x32, 0x74, 0xE8, 0xC0)


def _sigprop(dec, cur_sig, cur_mbr, nxt_sig, nxt_mbr, base, w, stride, p, s, pattern) -> None:
    """SigProp over one stripe: per group of 4 columns, the significance
    of the members in scan order (each new one adds its later neighbours),
    then their signs; new significance spreads to the next 8 columns and to
    the next stripe's first row."""
    val = (3 << ((p - 2) & 31)) & M32
    for g, i in enumerate(range(0, w, 8)):
        mbr = cur_mbr[g] & pattern
        new_sig = 0
        if mbr:
            for n in (0, 4):
                k, sh = s.pos >> 5, s.pos & 31
                cwd = ((s.w[k] | (s.w[k + 1] << 32)) >> sh) & M32
                cnt = 0
                inv_sig = ~cur_sig[g] & pattern & M32
                end = n + 4 if n + 4 + i < w else w - i
                for j in range(n, end):
                    if not (mbr >> (4 * j)) & 0xF:
                        continue
                    for r in range(4):
                        bit = 1 << (4 * j + r)
                        if mbr & bit:
                            if cwd & 1:
                                new_sig |= bit
                                mbr |= ((_SPREAD[r] << (4 * j)) & M32) & inv_sig
                            cwd >>= 1
                            cnt += 1
                if new_sig & ((0xFFFF << (4 * n)) & M32):
                    for j in range(n, end):
                        if not (new_sig >> (4 * j)) & 0xF:
                            continue
                        for r in range(4):
                            if new_sig >> (4 * j + r) & 1:
                                at = base + r * stride + i + j
                                dec[at] |= ((cwd & 1) << 31) | val
                                cwd >>= 1
                                cnt += 1
                s.pos += cnt
                if n == 4:
                    t = new_sig >> 28
                    t |= ((t & 0xE) >> 1) | ((t & 7) << 1)
                    cur_mbr[g + 1] |= t & ~cur_sig[g + 1] & M32
        new_sig |= cur_sig[g]
        ux = (new_sig & 0x88888888) >> 3
        tx = ux | ((ux << 4) & M32) | (ux >> 4)
        if i > 0:
            nxt_mbr[g - 1] |= ((ux << 28) & M32) & ~nxt_sig[g - 1] & M32
        nxt_mbr[g] |= tx & ~nxt_sig[g] & M32
        nxt_mbr[g + 1] |= (ux >> 28) & ~nxt_sig[g + 1] & M32
