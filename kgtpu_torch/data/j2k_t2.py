"""JPEG 2000 tier-2 as OpenJPEG 2.5.3 decodes it (`t2.c`, `pi.c`, `tgt.c`,
`bio.c`, the geometry of `tcd.c`): the resolutions, subbands, precincts and
code-blocks of a tile-component, the order of its packets, and each
packet's header and body.

  * Geometry (`opj_tcd_init_tile`): resolution r of NL has level NL - r and
    the bounds ceil(tile-component / 2^level); its precincts are 2^PPx x
    2^PPy cells anchored at 0, (2^(PPx-1) in the subbands of r > 0); its
    code-blocks 2^min(xcb, PPx or PPx - 1) cells anchored at 0, cut by the
    precinct and the subband.
  * Progressions (`opj_pi_next_lrcp` ... `_cprl`): LRCP, RLCP, RPCL, PCRL and
    CPRL, the position-driven ones stepping x and y over the tile by the
    smallest precinct size in the reference grid; POC markers each run one
    progression over their bounds (layers from 0; an entry whose
    progression is not one of the five runs none, as `opj_pi_next` gives
    up), and a packet seen once is not seen again.
  * Packet headers (`opj_t2_read_packet_header`): the first bit says
    whether the packet is empty; per code-block, inclusion (the tag tree
    at the first inclusion, one bit after), zero bit-planes (tag tree),
    the number of passes (1, 2, 3-5, 6-36, 37-164), Lblock increments and
    codeword lengths of Lblock + floor(log2(passes)) bits, one for each
    codeword segment the new passes reach (no length over 32 bits); a 0xFF
    byte is followed by 7 bits; the header ends byte-aligned, then, when
    COD asks for them, an EPH marker, which must be there (OpenJPEG fails
    the tile without it).  An SOP marker before a packet is skipped where
    more than 5 bytes are left (a missing one only warns), and packed
    headers (PPM, PPT) are read from their own stream.
  * Codeword segments (`opj_t2_init_seg`): a segment holds at most 109
    passes; with TERMALL (code-block style 0x04) one; with BYPASS (0x01)
    10 in the first, then 2 and 1 in turn (the raw significance and
    refinement passes, then the MQ cleanup pass).  A packet's passes fill
    the code-block's last segment (a new one once it is full), then open
    new ones.  HT code-blocks (0x40) keep those limits for when a segment
    is full, but a length covers one pass in the first segment and all the
    packet's passes left in any later one (`opj_t2_read_packet_header`'s
    HT branch), so a segment can hold more passes than its limit.

A code-block keeps its data as the concatenation of its contributions and
the length and number of passes of each segment: tier-1 decodes the
segments one after another, each with its own decoder, as OpenJPEG ends
each segment's data with its own 0xFF 0xFF.
"""

from __future__ import annotations

import numpy as np

from kgtpu_torch.data.imread import UnreadableImage


def ceildiv(a: int, b: int) -> int:
    return -(-a // b)


class Bits:
    """OpenJPEG's bit reader for packet headers (`bio.c`)."""

    def __init__(self, data: bytes, pos: int, end: int):
        self.data, self.pos, self.end = data, pos, end
        self.buf, self.ct = 0, 0

    def _bytein(self) -> None:
        self.buf = (self.buf << 8) & 0xFFFF
        self.ct = 7 if self.buf == 0xFF00 else 8
        if self.pos < self.end:
            self.buf |= self.data[self.pos]
            self.pos += 1

    def bit(self) -> int:
        if self.ct == 0:
            self._bytein()
        self.ct -= 1
        return (self.buf >> self.ct) & 1

    def read(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def align(self) -> None:
        self.ct = 0
        if (self.buf & 0xFF) == 0xFF:
            self._bytein()
            self.ct = 0


class TagTree:
    """`tgt.c`: a quad tree over a w x h grid of leaves, values found by
    comparisons against rising thresholds."""

    def __init__(self, w: int, h: int):
        self.parent: list[int] = []
        levels = []
        while True:
            levels.append((w, h))
            if w * h <= 1:
                break
            w, h = ceildiv(w, 2), ceildiv(h, 2)
        starts = np.cumsum([0] + [a * b for a, b in levels]).tolist()
        for lv, (lw, lh) in enumerate(levels):
            for j in range(lh):
                for i in range(lw):
                    if lv + 1 < len(levels):
                        pw = levels[lv + 1][0]
                        self.parent.append(starts[lv + 1] + (j // 2) * pw + i // 2)
                    else:
                        self.parent.append(-1)
        self.value = [999] * len(self.parent)
        self.low = [0] * len(self.parent)

    def decode(self, bio: Bits, leaf: int, threshold: int) -> bool:
        stack = []
        node = leaf
        while self.parent[node] >= 0:
            stack.append(node)
            node = self.parent[node]
        low = 0
        while True:
            if low > self.low[node]:
                self.low[node] = low
            else:
                low = self.low[node]
            while low < threshold and low < self.value[node]:
                if bio.bit():
                    self.value[node] = low
                else:
                    low += 1
            self.low[node] = low
            if not stack:
                break
            node = stack.pop()
        return self.value[node] < threshold


def _num_passes(bio: Bits) -> int:
    if not bio.bit():
        return 1
    if not bio.bit():
        return 2
    n = bio.read(2)
    if n != 3:
        return 3 + n
    n = bio.read(5)
    if n != 31:
        return 6 + n
    return 37 + bio.read(7)


class CodeBlock:
    __slots__ = ("x0", "y0", "x1", "y1", "chunks", "pieces", "at", "passes", "numbps",
                 "lblock", "included", "segs", "coef")

    def __init__(self, x0, y0, x1, y1):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.chunks: list[bytes] = []
        self.at = 0                          # where its first chunk starts in the tile's data
        self.pieces = 0                      # OpenJPEG's chunks: one per segment a packet reaches
        self.passes = 0
        self.numbps = 0
        self.lblock = 3
        self.included = False
        self.segs: list[list[int]] = []     # [most passes, passes, bytes] per segment


def _max_passes(style: int, segs: list) -> int:
    """`opj_t2_init_seg`: the passes the code-block's next segment holds."""
    if style & 0x04:
        return 1
    if style & 0x01:
        return 10 if not segs else 2 if segs[-1][0] in (1, 10) else 1
    return 109


class Band:
    """One subband of a resolution: orientation 0 (LL), 1 (HL), 2 (LH), 3
    (HH), bounds, numbps (Mb) and the step size's (expn, mant)."""

    def __init__(self, orient, x0, y0, x1, y1, expn, mant, numbps):
        self.orient = orient
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.expn, self.mant, self.numbps = expn, mant, numbps
        self.precincts: list[dict] = []


class Resolution:
    def __init__(self, x0, y0, x1, y1, pdx, pdy):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.pdx, self.pdy = pdx, pdy
        self.pw = 0 if x0 == x1 else ceildiv(x1, 1 << pdx) - (x0 >> pdx)
        self.ph = 0 if y0 == y1 else ceildiv(y1, 1 << pdy) - (y0 >> pdy)
        self.bands: list[Band] = []


def tile_component(tcx0, tcy0, tcx1, tcy1, cp: dict, qp: dict) -> list:
    """The resolutions of a tile-component (`opj_tcd_init_tile`) with their
    bands, precincts and code-blocks.  `cp`: numres, cblkw, cblkh (log2),
    prcw / prch per resolution; `qp`: guard bits and [(expn, mant)] per band
    in resolution order (scalar derived already expanded)."""
    numres = cp["numres"]
    out = []
    for r in range(numres):
        lev = numres - 1 - r
        rx0, ry0 = ceildiv(tcx0, 1 << lev), ceildiv(tcy0, 1 << lev)
        rx1, ry1 = ceildiv(tcx1, 1 << lev), ceildiv(tcy1, 1 << lev)
        pdx, pdy = cp["prcw"][r], cp["prch"][r]
        res = Resolution(rx0, ry0, rx1, ry1, pdx, pdy)
        px0, py0 = (rx0 >> pdx) << pdx, (ry0 >> pdy) << pdy
        if r == 0:
            cbg_x, cbg_y, cbg_w, cbg_h = px0, py0, pdx, pdy
            orients = [0]
        else:
            cbg_x, cbg_y, cbg_w, cbg_h = ceildiv(px0, 2), ceildiv(py0, 2), pdx - 1, pdy - 1
            orients = [1, 2, 3]
        cbw, cbh = min(cp["cblkw"], cbg_w), min(cp["cblkh"], cbg_h)
        for o in orients:
            if o == 0:
                bx0, by0 = ceildiv(tcx0, 1 << lev), ceildiv(tcy0, 1 << lev)
                bx1, by1 = ceildiv(tcx1, 1 << lev), ceildiv(tcy1, 1 << lev)
                qi = 0
            else:
                xb, yb = o & 1, o >> 1
                bx0 = ceildiv(tcx0 - (xb << lev), 1 << (lev + 1))
                by0 = ceildiv(tcy0 - (yb << lev), 1 << (lev + 1))
                bx1 = ceildiv(tcx1 - (xb << lev), 1 << (lev + 1))
                by1 = ceildiv(tcy1 - (yb << lev), 1 << (lev + 1))
                qi = 3 * (r - 1) + o
            expn, mant = qp["steps"][qi] if qi < len(qp["steps"]) else (0, 0)
            band = Band(o, bx0, by0, bx1, by1, expn, mant, expn + qp["guard"] - 1)
            for pno in range(res.pw * res.ph):
                sx = cbg_x + (pno % res.pw) * (1 << cbg_w)
                sy = cbg_y + (pno // res.pw) * (1 << cbg_h)
                x0, y0 = max(sx, bx0), max(sy, by0)
                x1, y1 = min(sx + (1 << cbg_w), bx1), min(sy + (1 << cbg_h), by1)
                prc = {"cblks": [], "cw": 0, "ch": 0}
                if x0 < x1 and y0 < y1:
                    tx, ty = (x0 >> cbw) << cbw, (y0 >> cbh) << cbh
                    cw = (ceildiv(x1, 1 << cbw) << cbw) - tx >> cbw
                    ch = (ceildiv(y1, 1 << cbh) << cbh) - ty >> cbh
                    prc["cw"], prc["ch"] = cw, ch
                    for k in range(cw * ch):
                        cx, cy = tx + (k % cw) * (1 << cbw), ty + (k // cw) * (1 << cbh)
                        prc["cblks"].append(CodeBlock(max(cx, x0), max(cy, y0),
                                                      min(cx + (1 << cbw), x1),
                                                      min(cy + (1 << cbh), y1)))
                    prc["incl"], prc["imsb"] = TagTree(cw, ch), TagTree(cw, ch)
                band.precincts.append(prc)
            res.bands.append(band)
        out.append(res)
    return out


def _position_packets(order, comps, tile, poc, done):
    """RPCL, PCRL and CPRL (`opj_pi_next_rpcl` / `_pcrl` / `_cprl`): every
    component has dx = dy = 1 here."""
    tx0, ty0, tx1, ty1 = tile
    r0, c0, l1, r1, c1 = poc
    dx = dy = 0
    for res_list in comps:
        n = len(res_list)
        for r, res in enumerate(res_list):
            sx, sy = 1 << (res.pdx + n - 1 - r), 1 << (res.pdy + n - 1 - r)
            dx = sx if not dx else min(dx, sx)
            dy = sy if not dy else min(dy, sy)

    def ys():
        y = ty0
        while y < ty1:
            yield y
            y += dy - y % dy

    def xs():
        x = tx0
        while x < tx1:
            yield x
            x += dx - x % dx

    def precinct(c, r, x, y):
        res_list = comps[c]
        if r >= len(res_list):
            return None
        res = res_list[r]
        lev = len(res_list) - 1 - r
        trx0, try0 = ceildiv(tx0, 1 << lev), ceildiv(ty0, 1 << lev)
        trx1, try1 = ceildiv(tx1, 1 << lev), ceildiv(ty1, 1 << lev)
        rpx, rpy = res.pdx + lev, res.pdy + lev
        if not (y % (1 << rpy) == 0 or (y == ty0 and (try0 << lev) % (1 << rpy))):
            return None
        if not (x % (1 << rpx) == 0 or (x == tx0 and (trx0 << lev) % (1 << rpx))):
            return None
        if res.pw == 0 or res.ph == 0 or trx0 == trx1 or try0 == try1:
            return None
        prci = (ceildiv(x, 1 << lev) >> res.pdx) - (trx0 >> res.pdx)
        prcj = (ceildiv(y, 1 << lev) >> res.pdy) - (try0 >> res.pdy)
        return prci + prcj * res.pw

    def emit(c, r, p):
        for lay in range(l1):
            key = (lay, r, c, p)
            if key not in done:
                done.add(key)
                yield key

    if order == 2:                                        # RPCL
        for r in range(r0, r1):
            for y in ys():
                for x in xs():
                    for c in range(c0, c1):
                        p = precinct(c, r, x, y)
                        if p is not None:
                            yield from emit(c, r, p)
    elif order == 3:                                      # PCRL
        for y in ys():
            for x in xs():
                for c in range(c0, c1):
                    for r in range(r0, r1):
                        p = precinct(c, r, x, y)
                        if p is not None:
                            yield from emit(c, r, p)
    else:                                                 # CPRL
        for c in range(c0, c1):
            for y in ys():
                for x in xs():
                    for r in range(r0, r1):
                        p = precinct(c, r, x, y)
                        if p is not None:
                            yield from emit(c, r, p)


def packet_order(order: int, comps: list, tile: tuple, layers: int, pocs: list):
    """(layer, resolution, component, precinct) of every packet of a tile,
    in the order of its progression (or of its POC entries)."""
    numc = len(comps)
    maxres = max(len(c) for c in comps)
    if pocs:
        runs = [(p["prog"], (p["res0"], p["comp0"], min(p["lay1"], layers),
                             min(p["res1"], maxres), min(p["comp1"], numc))) for p in pocs]
    else:
        runs = [(order, (0, 0, layers, maxres, numc))]
    done: set = set()
    for prog, poc in runs:
        if prog > 4:
            continue
        r0, c0, l1, r1, c1 = poc
        if prog in (0, 1):
            def nprec(c, r):
                return comps[c][r].pw * comps[c][r].ph if r < len(comps[c]) else 0
            if prog == 0:                                 # LRCP
                seq = ((lay, r, c, p) for lay in range(l1) for r in range(r0, r1)
                       for c in range(c0, c1) for p in range(nprec(c, r)))
            else:                                         # RLCP
                seq = ((lay, r, c, p) for r in range(r0, r1) for lay in range(l1)
                       for c in range(c0, c1) for p in range(nprec(c, r)))
            for key in seq:
                if key not in done:
                    done.add(key)
                    yield key
        else:
            yield from _position_packets(prog, comps, tile, poc, done)


def read_packets(data: bytes, headers: bytes | None, comps: list, tile: tuple, cod: dict,
                 layers: int, pocs: list, styles: list, spans: list | None = None) -> list:
    """Decode every packet of a tile's data (its tile-parts' bodies joined)
    into its code-blocks; packed headers (PPM / PPT) come from `headers`,
    each component's code-block style from `styles`.  Returns
    each component's highest resolution among the packets of its
    progression (OpenJPEG's `resno_decoded`; the packets after the data's
    end count, as OpenJPEG reads them as empty), 0 where none.
    The tile's packets end where its data ends; a segment past the end
    fails, as in OpenJPEG's strict mode.  `spans`, when given for data
    with its headers in it, receives each packet's (header start, header
    end, body end)."""
    pos, end = 0, len(data)
    hdr = headers if headers is not None else data
    hpos = 0
    resno = [0] * len(comps)
    ended = False
    for lay, r, c, p in packet_order(cod["order"], comps, tile, layers, pocs):
        resno[c] = max(resno[c], r)
        if ended:
            continue
        res = comps[c][r]
        style = styles[c]
        if headers is None:
            hpos = pos
        if cod["sop"] and headers is None and end - hpos > 5 and \
                data[hpos:hpos + 2] == b"\xff\x91":
            hpos += 6
        elif cod["sop"] and headers is not None and end - pos > 5 and \
                data[pos:pos + 2] == b"\xff\x91":
            pos += 6
        if hpos >= len(hdr):
            ended = True
            continue
        start = hpos
        bio = Bits(hdr, hpos, len(hdr))
        contrib = []
        if bio.bit():
            for band in res.bands:
                prc = band.precincts[p]
                for k, cb in enumerate(prc["cblks"]):
                    if not cb.included:
                        incl = prc["incl"].decode(bio, k, lay + 1)
                    else:
                        incl = bio.bit()
                    if not incl:
                        continue
                    if not cb.included:
                        i = 0
                        while not prc["imsb"].decode(bio, k, i):
                            i += 1
                        cb.numbps = band.numbps + 1 - i
                        cb.included = True
                    n = _num_passes(bio)
                    while bio.bit():
                        cb.lblock += 1
                    # a length for each codeword segment the passes reach
                    length, left, pieces = 0, n, 0
                    if not cb.segs or cb.segs[-1][1] == cb.segs[-1][0]:
                        cb.segs.append([_max_passes(style, cb.segs), 0, 0])
                    while left:
                        seg = cb.segs[-1]
                        if style & 0x40:        # HT: the first segment 1 pass, then the rest
                            take = 1 if len(cb.segs) == 1 else left
                        else:
                            take = min(seg[0] - seg[1], left)
                        bits = cb.lblock + take.bit_length() - 1
                        if bits > 32:
                            raise UnreadableImage("JPEG 2000 codeword length of over 32 bits")
                        piece = bio.read(bits)
                        length += piece
                        seg[1] += take
                        seg[2] += piece
                        left -= take
                        pieces += 1
                        if left:
                            cb.segs.append([_max_passes(style, cb.segs), 0, 0])
                    contrib.append((cb, n, length, pieces))
        bio.align()
        hpos = bio.pos
        if cod["eph"]:
            if len(hdr) - hpos <= 1 or hdr[hpos:hpos + 2] != b"\xff\x92":
                raise UnreadableImage("JPEG 2000 packet header without its EPH marker")
            hpos += 2
        if headers is None:
            pos = hpos
        for cb, n, length, pieces in contrib:
            if pos + length > end:
                raise UnreadableImage("JPEG 2000 code-block segment runs past the tile's data "
                                      "(OpenJPEG's strict mode refuses it)")
            if not cb.chunks:
                cb.at = pos
            cb.chunks.append(data[pos:pos + length])
            cb.pieces += pieces
            cb.passes += n
            pos += length
        if spans is not None:
            spans.append((start, hpos, pos))
        if pos >= end and headers is None:
            ended = True
    return resno
