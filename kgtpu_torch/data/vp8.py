"""The VP8 lossy bitstream (a WebP key frame) without libwebp: pure Python
and NumPy, following libwebp 1.5's `src/dec/vp8_dec.c`, `tree_dec.c`,
`quant_dec.c` and `src/utils/bit_reader*` (RFC 6386).

`decode_vp8(data)` parses a VP8 chunk's payload and hands its macroblocks
to `data/vp8_pixels.py`, which returns the frame's Y, U and V planes.

  * the frame header: a key frame of profile 0-3 that is shown, the first
    partition's size, the start code, 14-bit width and height (the scale
    bits are ignored);
  * the boolean decoder is libwebp's (`BoolDecoder`): the same split, the
    same normalisation and its sign reader, and its end of data: reading
    past a partition's end marks it, and a marked partition fails the
    decode;
  * the first partition: colour space and clamping bits (ignored), the
    segment header (quantiser and filter deltas, absolute or relative, and
    the segment map's probabilities), the filter header (simple or normal,
    level, sharpness, reference and mode deltas), the number of token
    partitions (1, 2, 4 or 8; row r reads partition r mod n), the
    quantisers (base and five deltas, `_quant`), the coefficient
    probability updates and the skip probability, then every macroblock's
    segment, skip flag and intra modes (16x16, or sixteen 4x4 modes
    coded in the context of the modes above and to the left, and the
    chroma mode);
  * the token partitions (`_residuals`): per macroblock the Y2 block of a
    16x16 macroblock (through the inverse WHT into the Y blocks' DC), 16 Y
    and 8 chroma blocks, each coefficient's token tree in the band and
    non-zero context of its neighbours, dequantised as read.
"""

from __future__ import annotations

import numpy as np

from kgtpu_torch.data import vp8_tables as T


class VP8Error(ValueError):
    """A VP8 frame libwebp refuses."""


# 7 ^ floor(log2(r)): the shift that brings a range r back to 128..255
_NORM = [0] + [7 ^ (r.bit_length() - 1) for r in range(1, 256)]
_ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
_CAT3456 = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
            (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# libwebp's 4x4 modes
B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU = range(10)


class BoolDecoder:
    """libwebp's VP8BitReader over one partition."""

    def __init__(self, data: bytes):
        self.buf = data
        self.pos = 0
        self.end = len(data)
        self.value = 0
        self.bits = -8
        self.range_ = 254
        self.eof = False

    def _load(self) -> None:
        if self.pos < self.end:
            self.value = (self.value << 8) | self.buf[self.pos]
            self.pos += 1
            self.bits += 8
        elif not self.eof:
            self.value <<= 8
            self.bits += 8
            self.eof = True
        else:
            self.bits = 0

    def bit(self, prob: int) -> int:
        if self.bits < 0:
            self._load()
        pos = self.bits
        split = (self.range_ * prob) >> 8
        if (self.value >> pos) > split:
            r = self.range_ - split
            self.value -= (split + 1) << pos
            b = 1
        else:
            r = split + 1
            b = 0
        shift = _NORM[r]
        self.range_ = (r << shift) - 1
        self.bits -= shift
        return b

    def signed(self, v: int) -> int:
        """VP8GetSigned: +-v by one even-odds bit, as libwebp reads it."""
        if self.bits < 0:
            self._load()
        pos = self.bits
        split = self.range_ >> 1
        self.bits -= 1
        if (self.value >> pos) > split:
            self.range_ = (self.range_ - 1) | 1
            self.value -= (split + 1) << pos
            return -v
        self.range_ |= 1
        return v

    def value_bits(self, n: int) -> int:
        v = 0
        for k in range(n - 1, -1, -1):
            v |= self.bit(0x80) << k
        return v

    def signed_value(self, n: int) -> int:
        v = self.value_bits(n)
        return -v if self.bit(0x80) else v


def _clip(v: int, m: int) -> int:
    return 0 if v < 0 else m if v > m else v


def _quant(br: BoolDecoder, seg: dict) -> list:
    """The dequantisation factors of each segment (libwebp's VP8ParseQuant):
    (y1 dc, y1 ac), (y2 dc, y2 ac), (uv dc, uv ac)."""
    base = br.value_bits(7)
    d = [br.signed_value(4) if br.bit(0x80) else 0 for _ in range(5)]
    dqy1_dc, dqy2_dc, dqy2_ac, dquv_dc, dquv_ac = d
    out = []
    for s in range(4):
        if seg["use"]:
            q = seg["quant"][s] + (0 if seg["absolute"] else base)
        elif s:
            out.append(out[0])
            continue
        else:
            q = base
        y2ac = (T.AC_TABLE[_clip(q + dqy2_ac, 127)] * 101581) >> 16
        out.append(((T.DC_TABLE[_clip(q + dqy1_dc, 127)], T.AC_TABLE[_clip(q, 127)]),
                    (T.DC_TABLE[_clip(q + dqy2_dc, 127)] * 2, max(y2ac, 8)),
                    (T.DC_TABLE[_clip(q + dquv_dc, 117)], T.AC_TABLE[_clip(q + dquv_ac, 127)])))
    return out


def _header(data: bytes, chunk_size: int):
    if len(data) < 10:
        raise VP8Error("VP8 frame header is cut short")
    bits = data[0] | data[1] << 8 | data[2] << 16
    key, profile, show, part0 = not bits & 1, (bits >> 1) & 7, (bits >> 4) & 1, bits >> 5
    if not key or profile > 3 or not show:
        raise VP8Error("VP8 frame is not a shown key frame")
    if data[3:6] != b"\x9d\x01\x2a":
        raise VP8Error("VP8 start code")
    w = (data[6] | data[7] << 8) & 0x3FFF
    h = (data[8] | data[9] << 8) & 0x3FFF
    if w == 0 or h == 0:
        raise VP8Error("VP8 frame is empty")
    if part0 >= chunk_size or 10 + part0 > len(data):
        raise VP8Error("VP8 first partition past the data")
    return w, h, part0


def _segment_header(br: BoolDecoder) -> dict:
    seg = {"use": br.bit(0x80), "update_map": 0, "absolute": 0,
           "quant": [0] * 4, "filter": [0] * 4, "proba": [255] * 3}
    if seg["use"]:
        seg["update_map"] = br.bit(0x80)
        if br.bit(0x80):
            seg["absolute"] = br.bit(0x80)
            seg["quant"] = [br.signed_value(7) if br.bit(0x80) else 0 for _ in range(4)]
            seg["filter"] = [br.signed_value(6) if br.bit(0x80) else 0 for _ in range(4)]
        if seg["update_map"]:
            seg["proba"] = [br.value_bits(8) if br.bit(0x80) else 255 for _ in range(3)]
    return seg


def _filter_header(br: BoolDecoder) -> dict:
    f = {"simple": br.bit(0x80), "level": br.value_bits(6), "sharpness": br.value_bits(3),
         "use_delta": br.bit(0x80), "ref": [0] * 4, "mode": [0] * 4}
    if f["use_delta"] and br.bit(0x80):
        for key in ("ref", "mode"):
            for i in range(4):
                if br.bit(0x80):
                    f[key][i] = br.signed_value(6)
    f["type"] = 0 if f["level"] == 0 else 1 if f["simple"] else 2
    return f


def filter_strengths(seg: dict, f: dict) -> list:
    """libwebp's PrecomputeFilterStrengths: [segment][is 4x4] ->
    (limit, inner level, hev threshold), limit 0 for none."""
    out = []
    for s in range(4):
        base = seg["filter"][s] + (0 if seg["absolute"] else f["level"]) if seg["use"] else f["level"]
        row = []
        for i4 in (0, 1):
            level = base
            if f["use_delta"]:
                level += f["ref"][0] + (f["mode"][0] if i4 else 0)
            level = _clip(level, 63)
            if level == 0:
                row.append((0, 0, 0))
                continue
            ilevel = level
            if f["sharpness"] > 0:
                ilevel >>= 2 if f["sharpness"] > 4 else 1
                ilevel = min(ilevel, 9 - f["sharpness"])
            ilevel = max(ilevel, 1)
            row.append((2 * level + ilevel, ilevel, 2 if level >= 40 else 1 if level >= 15 else 0))
        out.append(row)
    return out


def _probas(br: BoolDecoder) -> list:
    """[type][n in 0..16][ctx] -> the 11 node probabilities of n's band."""
    p = list(T.COEFFS_PROBA0)
    for i, u in enumerate(T.COEFFS_UPDATE_PROBA):
        if br.bit(u):
            p[i] = br.value_bits(8)
    bands = [[[p[((t * 8 + b) * 3 + c) * 11:((t * 8 + b) * 3 + c) * 11 + 11] for c in range(3)]
              for b in range(8)] for t in range(4)]
    return [[bands[t][_BANDS[n]] for n in range(17)] for t in range(4)]


def _modes(br: BoolDecoder, mbw: int, mbh: int, seg: dict, skip_p):
    """Every macroblock's (segment, skip, is 4x4, modes, chroma mode)."""
    top = [B_DC] * (4 * mbw)
    out = []
    bit = br.bit
    for _ in range(mbh):
        left = [B_DC] * 4
        for mx in range(mbw):
            segment = 0
            if seg["update_map"]:
                pr = seg["proba"]
                segment = bit(pr[1]) if not bit(pr[0]) else bit(pr[2]) + 2
            skip = bit(skip_p) if skip_p is not None else 0
            i4 = not bit(145)
            if not i4:
                ymode = (B_TM if bit(128) else B_HE) if bit(156) else (B_VE if bit(163) else B_DC)
                modes = [ymode]
                top[4 * mx:4 * mx + 4] = [ymode] * 4
                left = [ymode] * 4
            else:
                modes = [0] * 16
                for y in range(4):
                    ymode = left[y]
                    for x in range(4):
                        prob = T.BMODES_PROBA[(top[4 * mx + x] * 10 + ymode) * 9:][:9]
                        if not bit(prob[0]):
                            ymode = B_DC
                        elif not bit(prob[1]):
                            ymode = B_TM
                        elif not bit(prob[2]):
                            ymode = B_VE
                        elif not bit(prob[3]):
                            ymode = B_HE if not bit(prob[4]) else (B_RD if not bit(prob[5]) else B_VR)
                        elif not bit(prob[6]):
                            ymode = B_LD
                        elif not bit(prob[7]):
                            ymode = B_VL
                        else:
                            ymode = B_HD if not bit(prob[8]) else B_HU
                        top[4 * mx + x] = ymode
                        modes[4 * y + x] = ymode
                    left[y] = ymode
            uv = B_DC if not bit(142) else B_VE if not bit(114) else (B_TM if bit(183) else B_HE)
            out.append((segment, skip, i4, modes, uv))
    return out


def _large(br: BoolDecoder, p) -> int:
    bit = br.bit
    if not bit(p[3]):
        return 2 if not bit(p[4]) else 3 + bit(p[5])
    if not bit(p[6]):
        if not bit(p[7]):
            return 5 + bit(159)
        return 7 + 2 * bit(165) + bit(145)
    b1 = bit(p[8])
    cat = 2 * b1 + bit(p[9 + b1])
    v = 0
    for pr in _CAT3456[cat]:
        v += v + bit(pr)
    return v + 3 + (8 << cat)


def _coeffs(br: BoolDecoder, prob, ctx: int, dq, n: int, out: list, at: int) -> int:
    """libwebp's GetCoeffs: one block's tokens into out[at:at + 16]
    (dequantised, raster order); the index after the last non-zero one."""
    bit = br.bit
    p = prob[n][ctx]
    while n < 16:
        if not bit(p[0]):
            return n
        while not bit(p[1]):
            n += 1
            if n == 16:
                return 16
            p = prob[n][0]
        nxt = prob[n + 1]
        if not bit(p[2]):
            v = 1
            p = nxt[1]
        else:
            v = _large(br, p)
            p = nxt[2]
        out[at + _ZIGZAG[n]] = br.signed(v) * dq[n > 0]
        n += 1
    return 16


def _wht(dc: list, out: list) -> None:
    """libwebp's TransformWHT: the Y2 block into the 16 Y blocks' DC."""
    tmp = [0] * 16
    for i in range(4):
        a0, a1 = dc[i] + dc[12 + i], dc[4 + i] + dc[8 + i]
        a2, a3 = dc[4 + i] - dc[8 + i], dc[i] - dc[12 + i]
        tmp[i], tmp[8 + i], tmp[4 + i], tmp[12 + i] = a0 + a1, a0 - a1, a3 + a2, a3 - a2
    for i in range(4):
        d = tmp[4 * i] + 3
        a0, a1 = d + tmp[4 * i + 3], tmp[4 * i + 1] + tmp[4 * i + 2]
        a2, a3 = tmp[4 * i + 1] - tmp[4 * i + 2], d - tmp[4 * i + 3]
        base = 64 * i
        out[base], out[base + 16] = (a0 + a1) >> 3, (a3 + a2) >> 3
        out[base + 32], out[base + 48] = (a0 - a1) >> 3, (a3 - a2) >> 3


def _nz_code(nz: int, dc_nonzero: bool) -> int:
    return 3 if nz > 3 else 2 if nz > 1 else int(dc_nonzero)


def _residuals(br: BoolDecoder, bands, q, i4: bool, ctx: dict, mx: int) -> tuple[list, bool]:
    """libwebp's ParseResiduals for one macroblock: its 384 coefficients
    (16 Y blocks, then 4 U and 4 V) and whether any is non-zero."""
    out = [0] * 384
    top, left = ctx["nz"], ctx["left"]
    if not i4:
        dc = [0] * 16
        nz = _coeffs(br, bands[1], ctx["nz_dc"][mx] + ctx["left_dc"], q[1], 0, dc, 0)
        ctx["nz_dc"][mx] = ctx["left_dc"] = int(nz > 0)
        if nz > 1:
            _wht(dc, out)
        else:
            dc0 = (dc[0] + 3) >> 3
            for i in range(0, 256, 16):
                out[i] = dc0
        first, ac = 1, bands[0]
    else:
        first, ac = 0, bands[3]
    tnz, lnz = top[mx] & 0x0F, left & 0x0F
    nonzero = 0
    at = 0
    for _ in range(4):
        l_ = lnz & 1
        for _ in range(4):
            nz = _coeffs(br, ac, l_ + (tnz & 1), q[0], first, out, at)
            l_ = int(nz > first)
            tnz = (tnz >> 1) | (l_ << 7)
            nonzero |= _nz_code(nz, out[at] != 0)
            at += 16
        tnz >>= 4
        lnz = (lnz >> 1) | (l_ << 7)
    out_t, out_l = tnz, lnz >> 4
    for ch in (0, 2):
        tnz = top[mx] >> (4 + ch)
        lnz = left >> (4 + ch)
        for _ in range(2):
            l_ = lnz & 1
            for _ in range(2):
                nz = _coeffs(br, bands[2], l_ + (tnz & 1), q[2], 0, out, at)
                l_ = int(nz > 0)
                tnz = (tnz >> 1) | (l_ << 3)
                nonzero |= _nz_code(nz, out[at] != 0)
                at += 16
            tnz >>= 2
            lnz = (lnz >> 1) | (l_ << 5)
        out_t |= (tnz << 4) << ch
        out_l |= (lnz & 0xF0) << ch
    top[mx] = out_t
    ctx["left"] = out_l
    return out, bool(nonzero)


def decode_vp8(data: bytes, chunk_size: int | None = None):
    """A VP8 key frame -> (Y, U, V, width, height): the filtered planes of
    whole macroblocks (uint8) and the frame's size.  `data` runs to the
    end of the file's data (libwebp's last partition does), `chunk_size`
    is the VP8 chunk's size (the first partition must be shorter)."""
    from kgtpu_torch.data.vp8_pixels import reconstruct
    w, h, part0 = _header(data, len(data) if chunk_size is None else chunk_size)
    br = BoolDecoder(data[10:10 + part0])
    br.bit(0x80)                      # colour space
    br.bit(0x80)                      # clamping type
    seg = _segment_header(br)
    filt = _filter_header(br)
    nparts = 1 << br.value_bits(2)
    rest = data[10 + part0:]
    if len(rest) < 3 * (nparts - 1):
        raise VP8Error("VP8 partition sizes are cut short")
    parts, start, left_ = [], 3 * (nparts - 1), len(rest) - 3 * (nparts - 1)
    for p in range(nparts - 1):
        size = min(rest[3 * p] | rest[3 * p + 1] << 8 | rest[3 * p + 2] << 16, left_)
        parts.append(BoolDecoder(rest[start:start + size]))
        start += size
        left_ -= size
    if start >= len(rest):
        raise VP8Error("VP8 last partition is empty")
    parts.append(BoolDecoder(rest[start:]))
    quant = _quant(br, seg)
    br.bit(0x80)                      # refresh entropy probabilities (ignored)
    bands = _probas(br)
    skip_p = br.value_bits(8) if br.bit(0x80) else None
    mbw, mbh = (w + 15) >> 4, (h + 15) >> 4
    modes = _modes(br, mbw, mbh, seg, skip_p)
    if br.eof:
        raise VP8Error("VP8 first partition ends early")
    coeffs = np.zeros((mbh * mbw, 384), np.int32)
    inner = np.zeros(mbh * mbw, bool)
    ctx = {"nz": [0] * mbw, "nz_dc": [0] * mbw}
    for my in range(mbh):
        tb = parts[my & (nparts - 1)]
        ctx["left"] = ctx["left_dc"] = 0
        for mx in range(mbw):
            k = my * mbw + mx
            segment, skip, i4, _, _ = modes[k]
            if not skip:
                c, nonzero = _residuals(tb, bands, quant[segment], i4, ctx, mx)
                coeffs[k] = c
                skip = not nonzero
            else:
                ctx["nz"][mx] = 0
                ctx["left"] = 0
                if not i4:
                    ctx["nz_dc"][mx] = ctx["left_dc"] = 0
            inner[k] = i4 or not skip
            if tb.eof:
                raise VP8Error("VP8 token partition ends early")
    strengths = filter_strengths(seg, filt) if filt["type"] else None
    y, u, v = reconstruct(modes, coeffs, inner, strengths, filt["type"], mbw, mbh)
    return y, u, v, w, h
