"""A JPEG 2000 writer of HT code-blocks (ITU-T T.814, Part 15), for tests:
OpenJPEG's encoder has none.  `tools/variant_encoders.jpeg2000_ht` is its
entry point; the port never imports this module.

It inverts the port's decoder (`kgtpu_torch/data/j2k_ht.py`) and shares its
CxtVLC tables and tier-2 geometry (`j2k_t2.tile_component`,
`packet_order`), so an error there can show only against cv2: the tests
compare every file's decode by the port with cv2's, never with the input.

  * Samples: the level shift, RCT (5/3) or ICT (9/7), a forward wavelet
    (vertical, then horizontal, at every level; exact integer 5/3, float
    9/7 with OpenJPEG's normalisation) and, for 9/7, a dead-zone quantiser
    with the step sizes asked for (QCD expounded); tiles must be a multiple
    of 2^levels so that every resolution starts even.
  * HT cleanup encoder per code-block at the cleanup plane p (OpenJPEG's
    numbps: coefficients keep their bits from p - 1 up): quads in pairs,
    the decoder's contexts and line state, MEL events (T.814's 13-state
    run coder), the shortest VLC codeword whose exponent-MSB pattern fits,
    the UVLC (the first row's MEL event and single-bit second u), MagSgn.
    With refinement, p is 2 and SigProp + MagRef code the last plane in
    the decoder's stripe order (samples outside SigProp's neighbourhood stay
    0, so the file is lossy).
  * Tier-2: one quality layer; packet headers with the inclusion and
    zero-bit-plane tag trees, the pass counts and HT's lengths (the cleanup
    segment, then the rest), bit-stuffed as `bio.c` reads them.
"""

from __future__ import annotations

import struct

import numpy as np

from kgtpu_torch.data.j2k_ht import MEL_EXP, _from_next, _membership, M32
from kgtpu_torch.data.j2k_ht_tables import VLC_TBL0, VLC_TBL1
from kgtpu_torch.data.j2k_t2 import ceildiv, packet_order, tile_component

CAP, SIZ, COD, QCD, SOT = 0xFF50, 0xFF51, 0xFF52, 0xFF5C, 0xFF90
ORDERS = {"LRCP": 0, "RLCP": 1, "RPCL": 2, "PCRL": 3, "CPRL": 4}


def _encode_table(tbl) -> dict:
    """(context, rho, u_off) -> [(length, codeword, e_k, e_1)], shortest
    first, from a decode table."""
    out: dict = {}
    seen = set()
    for i, e in enumerate(tbl):
        n = e & 7
        if not n:
            continue
        c, cwd = i >> 7, i & ((1 << n) - 1)
        if (c, cwd, n) in seen:
            continue
        seen.add((c, cwd, n))
        out.setdefault((c, (e >> 4) & 15, (e >> 3) & 1), []).append(
            (n, cwd, (e >> 12) & 15, (e >> 8) & 15))
    for v in out.values():
        v.sort()
    return out


ENC0, ENC1 = _encode_table(VLC_TBL0), _encode_table(VLC_TBL1)


class LsbWriter:
    """Bits LSB first into bytes, forward (MagSgn, SigProp: after 0xFF a
    byte of 7 bits) or in the reversed streams' rule (VLC, MagRef: after a
    byte over 0x8F, a byte whose 7 low bits would be ones takes 7)."""

    def __init__(self, rev: bool, prev: int = 0):
        self.rev, self.bits, self.prev = rev, [], prev

    def put(self, value: int, n: int) -> None:
        self.bits.extend((value >> k) & 1 for k in range(n))

    def flush(self, pad: int) -> bytes:
        bits, i, prev = self.bits, 0, self.prev
        out = bytearray()
        while i < len(bits):
            chunk = bits[i:i + 8] + [pad] * max(0, i + 8 - len(bits))
            if self.rev:
                if prev > 0x8F and all(chunk[:7]):
                    b, used = 0x7F, 7
                else:
                    b, used = sum(v << k for k, v in enumerate(chunk)), 8
            else:
                used = 7 if prev == 0xFF else 8
                b = sum(v << k for k, v in enumerate(chunk[:used]))
            out.append(b)
            prev = b
            i += used
        return bytes(out)


def msb_bytes(bits: list) -> bytes:
    """Bits MSB first into bytes, a byte after 0xFF holding 7 (the MEL's and
    the packet headers' stuffing), zeros to pad; a last 0xFF gets a 0 byte
    after it."""
    out, prev, i = bytearray(), 0, 0
    while i < len(bits):
        n = 7 if prev == 0xFF else 8
        chunk = bits[i:i + n] + [0] * max(0, i + n - len(bits))
        b = sum(v << (n - 1 - k) for k, v in enumerate(chunk))
        out.append(b)
        prev, i = b, i + n
    if out and out[-1] == 0xFF:
        out.append(0)
    return bytes(out)


class Mel:
    """T.814's MEL encoder: runs of 0 events, MSB first, bit-stuffed."""

    def __init__(self):
        self.k, self.run, self.bits = 0, 0, []

    def event(self, e: int) -> None:
        eb = MEL_EXP[self.k]
        if not e:
            self.run += 1
            if self.run == 1 << eb:
                self.bits.append(1)
                self.run = 0
                self.k = min(self.k + 1, 12)
        else:
            self.bits.append(0)
            self.bits.extend((self.run >> s) & 1 for s in range(eb - 1, -1, -1))
            self.run = 0
            self.k = max(self.k - 1, 0)

    def flush(self) -> bytes:
        if self.run:
            self.bits.append(1)
        return msb_bytes(self.bits)


def _uvlc_bits(u: int) -> tuple[int, int, int, int]:
    """(prefix, prefix length, suffix, suffix length) of u >= 1."""
    if u == 1:
        return 1, 1, 0, 0
    if u == 2:
        return 2, 2, 0, 0
    if u <= 4:
        return 4, 3, u - 3, 1
    if u <= 36:
        return 0, 3, u - 5, 5
    raise ValueError(f"u_q of {u}: past what OpenJPEG's UVLC decodes")


def encode_cleanup(q: np.ndarray, p: int, zp1: int) -> bytes:
    """The HT cleanup segment of a code-block's signed coefficients at
    plane p (mu = |q| >> (p - 1)); zp1 is the zero bit-planes + 1 (U_q's
    bound)."""
    h, w = q.shape
    mag = np.abs(q).astype(np.int64) >> (p - 1)
    neg = (q < 0).astype(np.int64)

    def at(y, x):
        return (int(mag[y, x]), int(neg[y, x])) if y < h and x < w else (0, 0)

    vlc, ms, mel = LsbWriter(True, 0x90), LsbWriter(False), Mel()
    ls = [0] * ((w + 1) // 2 + 4)
    for y in range(0, h, 2):
        initial = y == 0
        c_q = 0
        ls0 = ls[0]
        if not initial:
            ls[0] = 0
        for x in range(0, w, 4):
            qi = x >> 1
            quads = []
            for k in range(2 if x + 2 < w else 1):
                xx = x + 2 * k
                s = [at(y, xx), at(y + 1, xx), at(y, xx + 1), at(y + 1, xx + 1)]
                rho = sum(1 << n for n in range(4) if s[n][0])
                es = [(2 * (m - 1) + 1).bit_length() if m else 0 for m, _ in s]
                quads.append((s, rho, es))
            us, entries = [], []
            for k, (s, rho, es) in enumerate(quads):
                if not initial:
                    c_q |= (ls0 >> 7) if k == 0 else (ls[qi + 1] >> 7)
                    c_q |= (ls[qi + 1 + k] >> 5) & 0x4
                emax = max(es)
                kappa = 1
                if not initial and bin(rho).count("1") >= 2:
                    e = max(ls0 & 0x7F, ls[qi + 1] & 0x7F) if k == 0 else \
                        max(ls[qi + 1] & 0x7F, ls[qi + 2] & 0x7F)
                    kappa = max(1, e - 1)
                u_q = max(emax, kappa)
                u = u_q - kappa
                if rho and u_q > zp1:
                    raise ValueError("coefficients too large for the zero bit-planes")
                uoff = int(u > 0) if rho else 0
                entry = None
                if rho or c_q:
                    for n, cwd, ek, e1 in (ENC0 if initial else ENC1)[(c_q, rho, uoff)]:
                        ok = True
                        for j in range(4):
                            if rho >> j & 1:
                                m = u_q - (ek >> j & 1)
                                v = 2 * (s[j][0] - 1) + 1
                                if m < 1 or v >> m != (e1 >> j & 1):
                                    ok = False
                                    break
                        if ok:
                            entry = (n, cwd, ek, e1)
                            break
                    if entry is None:
                        raise ValueError(f"no VLC codeword for context {c_q}, rho {rho}")
                if c_q == 0:
                    mel.event(int(rho != 0))
                if entry is not None:
                    vlc.put(entry[1], entry[0])
                entries.append(entry)
                us.append((uoff, u, u_q))
                c_q = (((rho & 1) | (rho >> 1 & 1)) | ((rho >> 2 & 1) << 1) |
                       ((rho >> 3 & 1) << 2)) if initial else \
                    ((rho >> 2 & 1) << 1) | ((rho >> 3 & 1) << 1)
            if len(quads) == 1:
                us.append((0, 0, 0))
            (o0, u0, _), (o1, u1, _) = us
            if o0 and o1:
                if initial:
                    big = u0 > 2 and u1 > 2
                    mel.event(int(big))
                    if big:
                        p0, p0n, s0, s0n = _uvlc_bits(u0 - 2)
                        p1, p1n, s1, s1n = _uvlc_bits(u1 - 2)
                        vlc.put(p0, p0n), vlc.put(p1, p1n), vlc.put(s0, s0n), vlc.put(s1, s1n)
                    elif u0 > 2:
                        p0, p0n, s0, s0n = _uvlc_bits(u0)
                        vlc.put(p0, p0n), vlc.put(u1 - 1, 1), vlc.put(s0, s0n)
                    else:
                        p0, p0n, s0, s0n = _uvlc_bits(u0)
                        p1, p1n, s1, s1n = _uvlc_bits(u1)
                        vlc.put(p0, p0n), vlc.put(p1, p1n), vlc.put(s0, s0n), vlc.put(s1, s1n)
                else:
                    p0, p0n, s0, s0n = _uvlc_bits(u0)
                    p1, p1n, s1, s1n = _uvlc_bits(u1)
                    vlc.put(p0, p0n), vlc.put(p1, p1n), vlc.put(s0, s0n), vlc.put(s1, s1n)
            elif o0 or o1:
                pb, pn, sb, sn = _uvlc_bits(u0 if o0 else u1)
                vlc.put(pb, pn), vlc.put(sb, sn)
            if not initial:
                ls0 = ls[qi + 2]
                ls[qi + 1] = ls[qi + 2] = 0
            for k, ((s, rho, es), entry) in enumerate(zip(quads, entries)):
                u_q = us[k][2]
                for j in range(4):
                    if rho >> j & 1:
                        m = u_q - (entry[2] >> j & 1)
                        v = 2 * (s[j][0] - 1) + s[j][1]
                        ms.put(v & ((1 << m) - 1), m)
                col = qi + k
                if rho & 2:
                    t = ls[col] & 0x7F
                    ls[col] = 0x80 | max(t, es[1])
                if rho & 8:
                    ls[col + 1] = 0x80 | es[3]
                elif initial:
                    ls[col + 1] = 0
            if len(quads) == 1 and initial:
                ls[qi + 2] = 0
    msb = ms.flush(1)
    melb = mel.flush()
    vbits = vlc.bits
    # the first VLC "byte" is the high nibble of byte Lcup - 2
    if len(vbits) >= 3 and all(vbits[:3]):
        nib, used = 0x7, 3
    else:
        head = (vbits[:4] + [0] * 4)[:4]
        nib, used = sum(v << k for k, v in enumerate(head)), 4
    rest = LsbWriter(True, (nib << 4) | 0xF)
    rest.bits = vbits[used:]
    body = rest.flush(0)
    scup = len(melb) + len(body) + 2
    if scup > 4079:
        raise ValueError("MEL + VLC longer than 4079 bytes")
    return msb + melb + bytes(reversed(body)) + bytes([(nib << 4) | (scup & 0xF), scup >> 4])


def encode_refinement(q: np.ndarray, p: int, magref: bool, causal: bool = False) -> bytes:
    """SigProp (and MagRef) of the plane below the cleanup's, in the
    decoder's stripe order: one segment, SigProp forward from its start,
    MagRef backward from its end."""
    h, w = q.shape
    a = np.abs(q).astype(np.int64)
    cl = (a >> (p - 1)) > 0
    bit = (a >> (p - 2)) & 1
    neg = q < 0
    nstripes = ceildiv(h, 4)
    ng = (w + 7) // 8 + 2
    sig = [[0] * ng for _ in range(nstripes + 1)]
    for y in range(h):
        for x in range(w):
            if cl[y, x]:
                sig[y // 4][x // 8] |= 1 << (4 * (x % 8) + y % 4)
    sp, mr = LsbWriter(False), LsbWriter(True, 0x90)
    if magref:
        for s in range(nstripes):
            for g in range((w + 7) // 8):
                for j in range(8):
                    for r in range(4):
                        if sig[s][g] >> (4 * j + r) & 1:
                            mr.put(int(bit[4 * s + r, 8 * g + j]), 1)
    mbr = [[0] * ng for _ in range(nstripes + 1)]
    for s in range(nstripes):
        _membership(sig[s], mbr[s], w)
    for s in range(nstripes):
        rows = min(4, h - 4 * s)
        pattern = {3: 0x77777777, 2: 0x33333333, 1: 0x11111111}.get(rows, M32)
        if s + 1 < nstripes:
            _from_next(sig[s], mbr[s], sig[s + 1], w, causal)
        cur_sig, cur_mbr, nxt_sig, nxt_mbr = sig[s], mbr[s], sig[s + 1], mbr[s + 1]
        for g, i in enumerate(range(0, w, 8)):
            m = cur_mbr[g] & pattern
            new_sig = 0
            if m:
                for n in (0, 4):
                    inv = ~cur_sig[g] & pattern & M32
                    end = n + 4 if n + 4 + i < w else w - i
                    for j in range(n, end):
                        if not (m >> (4 * j)) & 0xF:
                            continue
                        for r in range(4):
                            b = 1 << (4 * j + r)
                            if m & b:
                                v = int(bit[4 * s + r, i + j])
                                sp.put(v, 1)
                                if v:
                                    new_sig |= b
                                    m |= ((((0x32, 0x74, 0xE8, 0xC0)[r]) << (4 * j)) & M32) & inv
                    for j in range(n, end):
                        for r in range(4):
                            if new_sig >> (4 * j + r) & 1:
                                sp.put(int(neg[4 * s + r, i + j]), 1)
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
    seg = sp.flush(0) + bytes(reversed(mr.flush(0)))
    return seg or b"\0"


class BitWriter:
    """Packet-header bits as `bio.c` reads them (`msb_bytes`)."""

    def __init__(self):
        self.bits: list[int] = []

    def put(self, v: int, n: int = 1) -> None:
        self.bits.extend((v >> (n - 1 - k)) & 1 for k in range(n))

    def flush(self) -> bytes:
        return msb_bytes(self.bits)


class TagTreeEncoder:
    """`tgt.c`'s encoder over the port's tree layout."""

    def __init__(self, w: int, h: int, values: list):
        from kgtpu_torch.data.j2k_t2 import TagTree
        t = TagTree(w, h)
        self.parent = t.parent
        n = len(self.parent)
        self.value = [1 << 30] * n
        for k, v in enumerate(values):
            self.value[k] = v
        for k in range(n):                         # a parent is the least of its children
            par = self.parent[k]
            while par >= 0:
                if self.value[k] < self.value[par]:
                    self.value[par] = self.value[k]
                k, par = par, self.parent[par]
        self.low = [0] * n
        self.known = [False] * n

    def encode(self, bw: BitWriter, leaf: int, threshold: int) -> None:
        stack, node = [], leaf
        while self.parent[node] >= 0:
            stack.append(node)
            node = self.parent[node]
        low = 0
        while True:
            if low > self.low[node]:
                self.low[node] = low
            else:
                low = self.low[node]
            while low < threshold:
                if low >= self.value[node]:
                    if not self.known[node]:
                        bw.put(1)
                        self.known[node] = True
                    break
                bw.put(0)
                low += 1
            self.low[node] = low
            if not stack:
                break
            node = stack.pop()


def _num_passes(bw: BitWriter, n: int) -> None:
    if n == 1:
        bw.put(0)
    elif n == 2:
        bw.put(0b10, 2)
    elif n <= 5:
        bw.put(0b11, 2), bw.put(n - 3, 2)
    elif n <= 36:
        bw.put(0b1111, 4), bw.put(n - 6, 5)
    else:
        bw.put(0b111111111, 9), bw.put(n - 37, 7)


def _f53(x: np.ndarray) -> np.ndarray:
    """Forward 5/3 along axis 1 of int64 rows starting at an even
    coordinate: [low | high]."""
    n = x.shape[1]
    if n == 1:
        return x.copy()
    ev, od = x[:, 0::2], x[:, 1::2]
    no, ne = od.shape[1], ev.shape[1]
    nxt = np.concatenate([ev[:, 1:], ev[:, -1:]], 1)[:, :no]
    d = od - np.floor_divide(ev[:, :no] + nxt, 2)
    dl = np.concatenate([d[:, :1], d], 1)[:, :ne]
    dr = np.concatenate([d, d[:, -1:]], 1)[:, :ne]
    return np.concatenate([ev + np.floor_divide(dl + dr + 2, 4), d], 1)


def _f97(x: np.ndarray) -> np.ndarray:
    n = x.shape[1]
    if n == 1:
        return x.copy()
    ev, od = x[:, 0::2].copy(), x[:, 1::2].copy()
    no, ne = od.shape[1], ev.shape[1]

    def nb_even():
        return ev[:, :no] + np.concatenate([ev[:, 1:], ev[:, -1:]], 1)[:, :no]

    def nb_odd():
        return (np.concatenate([od[:, :1], od], 1)[:, :ne]
                + np.concatenate([od, od[:, -1:]], 1)[:, :ne])

    od += -1.586134342059924 * nb_even()
    ev += -0.052980118572961 * nb_odd()
    od += 0.882911075530934 * nb_even()
    ev += 0.443506852043971 * nb_odd()
    k = 1.230174104914001
    return np.concatenate([ev / k, od * (k / 2)], 1)


def forward_dwt(a: np.ndarray, levels: int, rev: bool) -> np.ndarray:
    """OpenJPEG's tile layout of the subbands (resolution r's LL in the
    top-left corner of r + 1's)."""
    buf = a.astype(np.int64 if rev else np.float64).copy()
    f = _f53 if rev else _f97
    h, w = buf.shape
    for _ in range(levels):
        if h == 0 or w == 0:
            break
        region = buf[:h, :w]
        region[:] = f(np.ascontiguousarray(region.T)).T
        region[:] = f(region)
        h, w = ceildiv(h, 2), ceildiv(w, 2)
    return buf


def _stepsize(expn: int, mant: int, prec: int) -> float:
    return (1.0 + mant / 2048.0) * 2.0 ** (prec - expn)


def _segment(m: int, body: bytes) -> bytes:
    return struct.pack(">HH", m, len(body) + 2) + body


def codestream(px: np.ndarray, irreversible: bool = False, levels: int = 3,
               cblk: tuple = (64, 64), tiles: tuple | None = None,
               precincts: list | None = None, order: str = "LRCP",
               refine: bool = False, sets: int = 1, step: float = 1.0, mct: bool | None = None,
               style: int = 0x40, rsiz: int = 0x4000, cap: bool = True,
               cap_body: bytes | None = None, main_extra: bytes = b"",
               tile_extra: bytes = b"", layers: int = 1, tamper=None) -> bytes:
    """A raw codestream of `px` ([h, w] or [h, w, c], uint8 or uint16) with
    HT code-blocks (see `variant_encoders.jpeg2000_ht`)."""
    a = px if px.ndim == 3 else px[..., None]
    h, w, nc = a.shape
    prec = 16 if px.dtype == np.uint16 else 8
    x = a.astype(np.int64) - (1 << (prec - 1))
    planes = [x[..., c] for c in range(nc)]
    use_mct = (nc >= 3) if mct is None else mct
    if use_mct:
        r, g, b = planes[:3]
        if irreversible:
            rf, gf, bf = (v.astype(np.float64) for v in (r, g, b))
            planes[:3] = [0.299 * rf + 0.587 * gf + 0.114 * bf,
                          -0.16875 * rf - 0.33126 * gf + 0.5 * bf,
                          0.5 * rf - 0.41869 * gf - 0.08131 * bf]
        else:
            planes[:3] = [np.floor_divide(r + 2 * g + b, 4), b - g, r - g]
    tw, th = tiles or (w, h)
    if tiles and (tw % (1 << levels) or th % (1 << levels)):
        raise ValueError("tile sizes must be multiples of 2^levels")
    ntx, nty = ceildiv(w, tw), ceildiv(h, th)
    numres = levels + 1
    cw, ch = cblk[0].bit_length() - 1, cblk[1].bit_length() - 1
    if precincts:
        pw = [p[0] for p in precincts]
        ph = [p[1] for p in precincts]
    else:
        pw, ph = [15] * numres, [15] * numres
    cp = {"numres": numres, "cblkw": cw, "cblkh": ch, "prcw": pw, "prch": ph}
    # bands in resolution order: LL, then HL, LH, HH of each level
    gains = [0] + [g for _ in range(levels) for g in (1, 1, 2)]
    if irreversible:
        steps = []
        for k, gain in enumerate(gains):
            d = step * 2.0 ** (-(len(gains) - 1 - k) // 3 * 0.5)
            e = int(np.floor(np.log2(d)))
            mant = min(2047, int(round((d / 2.0 ** e - 1) * 2048)))
            steps.append((min(31, max(0, prec - e)), mant))
    else:
        steps = [(prec + gain + 1, 0) for gain in gains]
    guard = 4 if irreversible else 2
    qp = {"guard": guard, "steps": steps}
    p0 = 2 if refine else 1
    tile_data = []
    for tno in range(ntx * nty):
        tx0, ty0 = (tno % ntx) * tw, (tno // ntx) * th
        tx1, ty1 = min(tx0 + tw, w), min(ty0 + th, h)
        comps, blocks = [], {}
        for c in range(nc):
            res_list = tile_component(tx0, ty0, tx1, ty1, cp, qp)
            buf = forward_dwt(planes[c][ty0:ty1, tx0:tx1], levels, not irreversible)
            for r, res in enumerate(res_list):
                prev = res_list[r - 1] if r else None
                for band in res.bands:
                    ox = prev.x1 - prev.x0 if band.orient & 1 else 0
                    oy = prev.y1 - prev.y0 if band.orient & 2 else 0
                    delta = _stepsize(band.expn, band.mant, prec)
                    for prc in band.precincts:
                        for cb in prc["cblks"]:
                            yy, xx = cb.y0 - band.y0 + oy, cb.x0 - band.x0 + ox
                            v = buf[yy:yy + cb.y1 - cb.y0, xx:xx + cb.x1 - cb.x0]
                            if irreversible:
                                v = (np.sign(v) * np.floor(np.abs(v) / delta)).astype(np.int64)
                            blk = _block(v, band.numbps, p0, refine, sets, bool(style & 0x08))
                            if tamper is not None and blk is not None:
                                blk = tamper(v, band.numbps, p0, *blk)
                            blocks[id(cb)] = blk
            comps.append(res_list)
        tile_data.append(_packets(comps, blocks, (tx0, ty0, tx1, ty1), ORDERS[order], layers,
                                  style))
    scod = 1 if precincts else 0
    spcod = bytes([levels, cw - 2, ch - 2, style, 0 if irreversible else 1])
    if precincts:
        spcod += bytes(p[0] | p[1] << 4 for p in precincts)
    cod = bytes([scod, ORDERS[order]]) + struct.pack(">H", layers) + bytes([int(use_mct)]) + spcod
    if irreversible:
        qcd = bytes([guard << 5 | 2]) + b"".join(struct.pack(">H", e << 11 | m) for e, m in steps)
    else:
        qcd = bytes([guard << 5]) + bytes(e << 3 for e, _ in steps)
    siz = struct.pack(">HIIIIIIIIH", rsiz, w, h, 0, 0, tw, th, 0, 0, nc) + \
        b"".join(bytes([prec - 1, 1, 1]) for _ in range(nc))
    out = b"\xff\x4f" + _segment(SIZ, siz)
    if cap:
        out += _segment(CAP, cap_body if cap_body is not None else struct.pack(">IH", 1 << 17, 0))
    out += _segment(COD, cod) + _segment(QCD, qcd) + main_extra
    for tno, data in enumerate(tile_data):
        head = tile_extra + b"\xff\x93"
        psot = 12 + len(head) + len(data)
        out += struct.pack(">HHHIBB", SOT, 10, tno, psot, 0, 1) + head + data
    return out + b"\xff\xd9"


def _block(v: np.ndarray, mb: int, p: int, refine: bool, sets: int, causal: bool):
    """(passes, [segment bytes], missing MSBs) of a code-block, or None
    when the cleanup finds nothing significant.  The tag tree's missing
    MSBs M give numbps = Mb - M = p; OpenJPEG's zero bit-planes are M + 1
    and bound U_q by M + 2."""
    if not np.any(np.abs(v) >> (p - 1)):
        return None
    zbp = mb - p
    if zbp < 0:
        raise ValueError("cleanup plane above the band's bit-planes")
    segs = [encode_cleanup(v, p, zbp + 2)]
    passes = 1
    if refine:
        segs.append(encode_refinement(v, p, True, causal))
        passes = 3
    if sets > 1:                          # further HT sets: OpenJPEG stops at 3 passes
        rest = segs[1] if refine else b"\0"
        segs = [segs[0], rest + (segs[0] + rest) * (sets - 1)]
        passes = 3 * sets
    return passes, segs, zbp


def _packets(comps: list, blocks: dict, tile: tuple, order: int, layers: int,
             style: int) -> bytes:
    """The tile's packets.  With two layers, a refined block sends its
    cleanup pass in the first and the rest in the second, its lengths split
    as OpenJPEG's HT branch reads them (every byte in the last piece)."""
    from kgtpu_torch.data.j2k_t2 import _max_passes
    trees: dict = {}
    state: dict = {}                       # id(cb) -> [lblock, [[most, passes]...]]
    out = bytearray()
    for lay, r, c, p in packet_order(order, comps, tile, layers, []):
        res = comps[c][r]
        bw = BitWriter()
        body = bytearray()
        contrib = [(band, band.precincts[p]) for band in res.bands]

        def sends(blk):
            if not blk:
                return None
            passes, segs, _ = blk
            if layers == 1:
                return passes, segs
            if lay == 0:
                return 1, segs[:1]
            if lay == 1 and passes > 1:
                return passes - 1, [b"".join(segs[1:])]
            return None
        if not any(sends(blocks.get(id(cb))) for _, prc in contrib for cb in prc["cblks"]):
            out += b"\0"
            continue
        bw.put(1)
        for band, prc in contrib:
            cbs = prc["cblks"]
            if not cbs:
                continue
            key = id(prc)
            if key not in trees:
                incl = [0 if blocks.get(id(cb)) else layers for cb in cbs]
                zbp = [blocks[id(cb)][2] if blocks.get(id(cb)) else 0 for cb in cbs]
                trees[key] = (TagTreeEncoder(prc["cw"], prc["ch"], incl),
                              TagTreeEncoder(prc["cw"], prc["ch"], zbp))
            it, zt = trees[key]
            for k, cb in enumerate(cbs):
                blk = blocks.get(id(cb))
                now = sends(blk)
                if id(cb) in state:
                    bw.put(int(now is not None))
                else:
                    it.encode(bw, k, lay + 1)
                if now is None:
                    continue
                n, data = now
                if id(cb) not in state:
                    zt.encode(bw, k, 999)
                    state[id(cb)] = [3, []]
                lblock, segs = state[id(cb)]
                _num_passes(bw, n)
                # the pieces OpenJPEG's HT branch reads: the first segment takes
                # one pass, any later one all that are left
                counts, left = [], n
                if not segs or segs[-1][1] == segs[-1][0]:
                    segs.append([_max_passes(style, segs), 0])
                while left:
                    take = 1 if len(segs) == 1 else left
                    segs[-1][1] += take
                    counts.append(take)
                    left -= take
                    if left:
                        segs.append([_max_passes(style, segs), 0])
                lens = [0] * (len(counts) - len(data)) + [len(d) for d in data]
                if len(lens) > len(counts):
                    lens = lens[:len(counts) - 1] + [sum(lens[len(counts) - 1:])]
                inc = 0
                while any(v.bit_length() > lblock + inc + t.bit_length() - 1
                          for v, t in zip(lens, counts)):
                    inc += 1
                bw.put((1 << (inc + 1)) - 2, inc + 1)
                lblock += inc
                state[id(cb)][0] = lblock
                for v, t in zip(lens, counts):
                    bw.put(v, lblock + t.bit_length() - 1)
                body += b"".join(data)
        out += bw.flush() + body
    return bytes(out)


def jp2(cs: bytes, w: int, h: int, nc: int, prec: int, space: int) -> bytes:
    """A JP2 file around a codestream: signature, ftyp, jp2h (ihdr, colr
    with an enumerated space), jp2c."""
    def box(t: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body) + 8) + t + body
    ihdr = struct.pack(">IIHBBBB", h, w, nc, prec - 1, 7, 0, 0)
    colr = struct.pack(">BBBI", 1, 0, 0, space)
    return (b"\0\0\0\x0cjP  \r\n\x87\n" + box(b"ftyp", b"jp2 \0\0\0\0jp2 ")
            + box(b"jp2h", box(b"ihdr", ihdr) + box(b"colr", colr)) + box(b"jp2c", cs))
