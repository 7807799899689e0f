"""AV1 coefficient syntax and dequantisation (specification sections
5.11.39 and 7.12.3): all_zero, the end of block (eob_pt_*, eob_extra),
coeff_base_eob / coeff_base / coeff_br with the contexts of section 8.3.2,
dc_sign, the Golomb remainder, then the dequantiser (dc / ac lookups per
bit depth, quantiser matrices for 2-D transforms, the 64-point shift, the
24-bit mask and the clamp to the bit depth's range) and the inverse
transform added to the prediction.

Positions are raster positions (row * width + column) of the transform
block cut to 32x32 (section 7.12.3's adjusted size); `TxGeom` holds
everything that depends only on the TX size and the transform class.
"""

from __future__ import annotations

import numpy as np

from kgtpu_torch.data.av1_tables import QM_RAW, SCAN_DEFAULT
from kgtpu_torch.data.av1_transform import inverse_transform
from kgtpu_torch.data.imread import UnreadableImage

# TX sizes (libaom's TX_SIZES_ALL order) as (width, height).
TX_SIZES = [(4, 4), (8, 8), (16, 16), (32, 32), (64, 64), (4, 8), (8, 4), (8, 16), (16, 8),
            (16, 32), (32, 16), (32, 64), (64, 32), (4, 16), (16, 4), (8, 32), (32, 8),
            (16, 64), (64, 16)]
TX_INDEX = {wh: i for i, wh in enumerate(TX_SIZES)}
SQR = [TX_INDEX[(min(w, h),) * 2] for w, h in TX_SIZES]
SQR_UP = [TX_INDEX[(max(w, h),) * 2] for w, h in TX_SIZES]
TX_2D, TX_HORIZ, TX_VERT = 0, 1, 2
# tx type -> class (IDTX and the two-dimensional types are TX_CLASS_2D)
TX_CLASS = [TX_2D] * 10 + [TX_VERT, TX_HORIZ, TX_VERT, TX_HORIZ, TX_VERT, TX_HORIZ]
IDTX = 9


def _log2(v: int) -> int:
    return v.bit_length() - 1


def _qm_index() -> dict:
    at, out = 0, {}
    for t, (w, h) in enumerate(TX_SIZES):
        if max(w, h) == 64:
            continue
        out[t] = at
        at += w * h
    return out


_QM_AT = _qm_index()
_QM_CACHE: dict = {}


def qm_matrix(level: int, chroma: int, tx: int) -> list:
    """Quantizer_Matrix for a TX size (adjusted to 32), raster order."""
    key = (level, chroma, tx)
    if key not in _QM_CACHE:
        w, h = TX_SIZES[tx]
        t = TX_INDEX[(min(w, 32), min(h, 32))]
        base = (level * 2 + chroma) * 3344 + _QM_AT[t]
        _QM_CACHE[key] = list(QM_RAW[base:base + min(w, 32) * min(h, 32)])
    return _QM_CACHE[key]


def _base_offset(w: int, h: int, r: int, c: int) -> int:
    """Coeff_Base_Ctx_Offset[txSz][Min(r, 4)][Min(c, 4)] (section 9.3)."""
    r, c = min(r, 4), min(c, 4)
    if w == h:
        return 0 if r + c == 0 else 1 if r + c == 1 else 6 if r + c <= 3 else 21
    if w > h:
        if r == 0 and c == 0:
            return 0
        if c < 2:
            return 16
        return 6 if (r == 0 and c in (2, 3)) or (r == 1 and c == 2) else 21
    if r == 0 and c == 0:
        return 0
    if r < 2:
        return 11
    return 6 if (r == 2 and c < 2) or (r == 3 and c == 0) else 21


class TxGeom:
    """Per (TX size, transform class, scan kind): the scan, padded level
    positions, neighbour offsets and context offsets."""

    def __init__(self, tx: int, tx_class: int, scan_kind: str):
        w, h = TX_SIZES[tx]
        self.w, self.h = w, h
        aw, ah = min(w, 32), min(h, 32)
        self.aw, self.ah = aw, ah
        self.log2w, self.log2h = _log2(w), _log2(h)
        if scan_kind == "default":
            self.scan = SCAN_DEFAULT[(aw, ah)]
        elif scan_kind == "mrow":
            self.scan = list(range(aw * ah))
        else:
            self.scan = [r * aw + c for c in range(aw) for r in range(ah)]
        stride = aw + 4
        self.stride = stride
        self.size = (ah + 4) * stride
        self.pad = [(p // aw) * stride + p % aw for p in range(aw * ah)]
        if tx_class == TX_2D:
            nb = (1, stride, stride + 1, 2, 2 * stride)
            br = (1, stride, stride + 1)
        elif tx_class == TX_HORIZ:
            nb = (1, stride, 2, 3, 4)
            br = (1, stride, 2)
        else:
            nb = (1, stride, 2 * stride, 3 * stride, 4 * stride)
            br = (1, stride, 2 * stride)
        self.nb, self.br = nb, br
        off, bra = [], []
        for p in range(aw * ah):
            r, c = divmod(p, aw)
            if tx_class == TX_2D:
                off.append(_base_offset(w, h, r, c))
                bra.append(0 if p == 0 else 7 if (r < 2 and c < 2) else 14)
            else:
                idx = r if tx_class == TX_VERT else c
                off.append(26 + 5 * min(idx, 2))
                bra.append(0 if p == 0 else 7 if idx == 0 else 14)
        self.off, self.bra = off, bra
        n = aw * ah
        self.eob_ctx_limits = (n // 8, n // 4)
        self.eob_multi = min(self.log2w, 5) + min(self.log2h, 5) - 4
        pels = w * h
        self.dq_shift = (pels > 256) + (pels > 1024)


_GEOMS: dict = {}


def geom(tx: int, tx_type: int) -> TxGeom:
    w, h = TX_SIZES[tx]
    cls = TX_CLASS[tx_type]
    kind = {TX_2D: "default", TX_VERT: "mrow", TX_HORIZ: "mcol"}[cls]
    key = (tx, cls, kind)
    g = _GEOMS.get(key)
    if g is None:
        g = _GEOMS[key] = TxGeom(tx, cls, kind)
    return g


EOB_MULTI_NAMES = ("eob_multi16", "eob_multi32", "eob_multi64", "eob_multi128",
                   "eob_multi256", "eob_multi512", "eob_multi1024")


def read_coeffs(rd, cdf, tx: int, tx_type: int, ptype: int, dc_ctx: int) -> tuple:
    """The coeffs( ) syntax after all_zero was read as 0: returns (eob,
    levels as a dict position -> signed level, culLevel, dcCategory)."""
    g = geom(tx, tx_type)
    txsz_ctx = (SQR[tx] + SQR_UP[tx] + 1) >> 1
    symbol = rd.symbol
    cls_ctx = 0 if TX_CLASS[tx_type] == TX_2D else 1
    eob_pt = symbol(cdf[EOB_MULTI_NAMES[g.eob_multi]][ptype][cls_ctx]) + 1
    eob = eob_pt if eob_pt < 2 else (1 << (eob_pt - 2)) + 1
    shift = eob_pt - 3
    if shift >= 0:
        if symbol(cdf["eob_extra"][txsz_ctx][ptype][eob_pt - 3]):
            eob += 1 << shift
        for i in range(1, max(1, eob_pt - 2)):
            if rd.bool():
                eob += 1 << (max(0, eob_pt - 2) - 1 - i)
    scan = g.scan
    pad = g.pad
    lv = [0] * g.size
    n0, n1, n2, n3, n4 = g.nb
    b0, b1, b2 = g.br
    off = g.off
    bra = g.bra
    cb = cdf["coeff_base_multi"][txsz_ctx][ptype]
    cbr = cdf["coeff_lps_multi"][min(txsz_ctx, 3)][ptype]
    lim8, lim4 = g.eob_ctx_limits
    # the last coefficient
    c = eob - 1
    pos = scan[c]
    ctx = 0 if c == 0 else 1 if c <= lim8 else 2 if c <= lim4 else 3
    level = symbol(cdf["coeff_base_eob_multi"][txsz_ctx][ptype][ctx]) + 1
    levels = {}
    for c in range(eob - 1, -1, -1):
        pos = scan[c]
        p = pad[pos]
        if c != eob - 1:
            if pos == 0 and off[0] == 0:
                ctx = 0
            else:
                m = lv[p + n0]
                mag = (m if m < 3 else 3)
                m = lv[p + n1]
                mag += (m if m < 3 else 3)
                m = lv[p + n2]
                mag += (m if m < 3 else 3)
                m = lv[p + n3]
                mag += (m if m < 3 else 3)
                m = lv[p + n4]
                mag += (m if m < 3 else 3)
                ctx = (mag + 1) >> 1
                if ctx > 4:
                    ctx = 4
                ctx += off[pos]
            level = symbol(cb[ctx])
        if level > 2:
            mag = lv[p + b0] + lv[p + b1] + lv[p + b2]
            mag = (mag + 1) >> 1
            if mag > 6:
                mag = 6
            bcdf = cbr[mag + bra[pos]]
            for _ in range(4):
                k = symbol(bcdf)
                level += k
                if k < 3:
                    break
        lv[p] = level
        if level:
            levels[pos] = level
    cul = 0
    dc_cat = 0
    out = {}
    for c in range(eob):
        pos = scan[c]
        level = levels.get(pos)
        if not level:
            continue
        if c == 0:
            sign = symbol(cdf["dc_sign"][ptype][dc_ctx])
        else:
            sign = rd.bool()
        if level > 14:
            length = 0
            while True:
                length += 1
                if rd.bool():
                    break
                if length > 19:
                    raise UnreadableImage("AV1 Golomb length above 20 (corrupt tile)")
            x = 1
            for _ in range(length - 1):
                x = (x << 1) | rd.bool()
            level = x + 14
        if pos == 0:
            dc_cat = 1 if sign else 2
        level &= 0xFFFFF
        cul += level
        out[pos] = -level if sign else level
    return eob, out, min(63, cul), dc_cat


def _lossless(frame, x, y, levels: dict, dc_q: int, ac_q: int, bit_depth: int) -> None:
    """A lossless 4x4 block: dequantisation and the Walsh-Hadamard
    transform (7.13.2.10, rows with shift 2, then columns) on Python ints."""
    t = [0] * 16
    lim = 1 << (7 + bit_depth)
    for pos, lvl in levels.items():
        q = dc_q if pos == 0 else ac_q
        dq = ((lvl if lvl > 0 else -lvl) * q) & 0xFFFFFF
        if lvl < 0:
            dq = -dq
        t[pos] = -lim if dq < -lim else lim - 1 if dq > lim - 1 else dq
    for i in range(0, 16, 4):
        a, c, d, b = t[i] >> 2, t[i + 1] >> 2, t[i + 2] >> 2, t[i + 3] >> 2
        a += c
        d -= b
        e = (a - d) >> 1
        b = e - b
        c = e - c
        a -= b
        d += c
        t[i], t[i + 1], t[i + 2], t[i + 3] = a, b, c, d
    for j in range(4):
        a, c, d, b = t[j], t[4 + j], t[8 + j], t[12 + j]
        a += c
        d -= b
        e = (a - d) >> 1
        b = e - b
        c = e - c
        a -= b
        d += c
        t[j], t[4 + j], t[8 + j], t[12 + j] = a, b, c, d
    region = frame[y:y + 4, x:x + 4]
    np.clip(region + np.array(t, np.int64).reshape(4, 4), 0, (1 << bit_depth) - 1, out=region)


def reconstruct(frame: np.ndarray, x: int, y: int, tx: int, tx_type: int, levels: dict,
                dc_q: int, ac_q: int, qm: list | None, bit_depth: int, lossless: bool) -> None:
    """Dequantise (7.12.3) and add the inverse transform to frame[y:, x:]."""
    if lossless:
        _lossless(frame, x, y, levels, dc_q, ac_q, bit_depth)
        return
    g = geom(tx, tx_type)
    w, h = g.w, g.h
    aw = g.aw
    blk = np.zeros((h, w), np.int64)
    lim = 1 << (7 + bit_depth)
    shift = g.dq_shift
    for pos, lvl in levels.items():
        q = dc_q if pos == 0 else ac_q
        if qm is not None:
            q = (q * qm[pos] + 16) >> 5
        a = lvl if lvl > 0 else -lvl
        dq = ((a * q) & 0xFFFFFF) >> shift
        if lvl < 0:
            dq = -dq
        if dq < -lim:
            dq = -lim
        elif dq > lim - 1:
            dq = lim - 1
        blk[pos // aw, pos % aw] = dq
    res = inverse_transform(blk, tx_type, g.log2w, g.log2h, bit_depth, lossless)
    region = frame[y:y + h, x:x + w]
    np.clip(region + res, 0, (1 << bit_depth) - 1, out=region)
