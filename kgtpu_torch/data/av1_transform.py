"""AV1 inverse transforms (specification section 7.13): DCT 4-64, ADST 4 /
8 / 16 and their flipped forms, identity 4-32, and the lossless 4x4
Walsh-Hadamard transform, with the specification's intermediate rounding
and clamps.  Each 1-D transform works on a list of NumPy int64 vectors (one
vector a position, its entries the rows or columns transformed at once),
so a whole block's rows, then its columns, take one pass of Python steps.

`inverse_transform(coeffs, tx_type, log2w, log2h, bit_depth, lossless)`
maps a [h, w] block of dequantised coefficients (raster order; only the
top-left 32x32 of a 64-point size is ever non-zero) to its residual.
"""

from __future__ import annotations

import numpy as np

COS128 = [
    4096, 4095, 4091, 4085, 4076, 4065, 4052, 4036, 4017, 3996, 3973, 3948, 3920, 3889, 3857,
    3822, 3784, 3745, 3703, 3659, 3612, 3564, 3513, 3461, 3406, 3349, 3290, 3229, 3166, 3102,
    3035, 2967, 2896, 2824, 2751, 2675, 2598, 2520, 2440, 2359, 2276, 2191, 2106, 2019, 1931,
    1842, 1751, 1660, 1567, 1474, 1380, 1285, 1189, 1092, 995, 897, 799, 700, 601, 501, 401,
    301, 201, 101, 0,
]
SINPI = (0, 1321, 2482, 3344, 3803)

# Transform types (section 6.10.18) and what runs along each axis.
(DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, FLIPADST_DCT, DCT_FLIPADST, FLIPADST_FLIPADST,
 ADST_FLIPADST, FLIPADST_ADST, IDTX, V_DCT, H_DCT, V_ADST, H_ADST, V_FLIPADST,
 H_FLIPADST) = range(16)
_D, _A, _I = "dct", "adst", "identity"
# tx type -> (vertical (column) kind, horizontal (row) kind)
KINDS = {
    DCT_DCT: (_D, _D), ADST_DCT: (_A, _D), DCT_ADST: (_D, _A), ADST_ADST: (_A, _A),
    FLIPADST_DCT: (_A, _D), DCT_FLIPADST: (_D, _A), FLIPADST_FLIPADST: (_A, _A),
    ADST_FLIPADST: (_A, _A), FLIPADST_ADST: (_A, _A), IDTX: (_I, _I), V_DCT: (_D, _I),
    H_DCT: (_I, _D), V_ADST: (_A, _I), H_ADST: (_I, _A), V_FLIPADST: (_A, _I),
    H_FLIPADST: (_I, _A),
}
FLIP_UD = {FLIPADST_DCT, FLIPADST_ADST, V_FLIPADST, FLIPADST_FLIPADST}
FLIP_LR = {DCT_FLIPADST, ADST_FLIPADST, H_FLIPADST, FLIPADST_FLIPADST}
# Transform_Row_Shift by (log2w, log2h).
ROW_SHIFT = {(2, 2): 0, (3, 3): 1, (4, 4): 2, (5, 5): 2, (6, 6): 2, (2, 3): 0, (3, 2): 0,
             (3, 4): 1, (4, 3): 1, (4, 5): 1, (5, 4): 1, (5, 6): 1, (6, 5): 1, (2, 4): 1,
             (4, 2): 1, (3, 5): 2, (5, 3): 2, (4, 6): 2, (6, 4): 2}


def cos128(angle: int) -> int:
    a = angle & 255
    if a <= 64:
        return COS128[a]
    if a <= 128:
        return -COS128[128 - a]
    if a <= 192:
        return -COS128[a - 128]
    return COS128[256 - a]


def sin128(angle: int) -> int:
    return cos128(angle - 64)


def brev(bits: int, x: int) -> int:
    return int(format(x, f"0{bits}b")[::-1], 2) if bits else 0


def _r12(x):
    return (x + 2048) >> 12


def _dct_steps(n: int) -> list:
    """The steps of the inverse DCT process (section 7.13.2.3) for 2^n
    points: ("B", a, b, angle, flip) or ("H", a, b, flip)."""
    s: list = []
    B = lambda a, b, ang, f: s.append(("B", a, b, ang, f))  # noqa: E731
    H = lambda a, b, f: s.append(("H", a, b, f))  # noqa: E731
    if n == 6:
        for i in range(16):
            B(32 + i, 63 - i, 63 - 4 * brev(4, i), 0)
    if n >= 5:
        for i in range(8):
            B(16 + i, 31 - i, 6 + (brev(3, 7 - i) << 3), 0)
    if n == 6:
        for i in range(16):
            H(32 + i * 2, 33 + i * 2, i & 1)
    if n >= 4:
        for i in range(4):
            B(8 + i, 15 - i, 12 + (brev(2, 3 - i) << 4), 0)
    if n >= 5:
        for i in range(8):
            H(16 + 2 * i, 17 + 2 * i, i & 1)
    if n == 6:
        for i in range(4):
            for j in range(2):
                B(62 - i * 4 - j, 33 + i * 4 + j, 60 - 16 * brev(2, i) + 64 * j, 1)
    if n >= 3:
        for i in range(2):
            B(4 + i, 7 - i, 56 - 32 * i, 0)
    if n >= 4:
        for i in range(4):
            H(8 + 2 * i, 9 + 2 * i, i & 1)
    if n >= 5:
        for i in range(2):
            for j in range(2):
                B(30 - 4 * i - j, 17 + 4 * i + j, 24 + (j << 6) + ((1 - i) << 5), 1)
    if n == 6:
        for i in range(8):
            for j in range(2):
                H(32 + i * 4 + j, 35 + i * 4 - j, i & 1)
    for i in range(2):
        B(2 * i, 1 + 2 * i, 32 + 16 * i, 1 - i)
    if n >= 3:
        for i in range(2):
            H(4 + 2 * i, 5 + 2 * i, i)
    if n >= 5:
        for i in range(4):
            for j in range(2):
                H(16 + 4 * i + j, 19 + 4 * i - j, i & 1)
    if n == 6:
        for i in range(2):
            for j in range(4):
                B(61 - i * 8 - j, 34 + i * 8 + j, 56 - i * 32 + (j >> 1) * 64, 1)
    if n >= 4:
        for i in range(2):
            B(14 - i, 9 + i, 48 + 64 * i, 1)
    for i in range(2):
        H(i, 3 - i, 0)
    if n >= 3:
        B(6, 5, 32, 1)
    if n >= 5:
        for i in range(4):
            B(29 - i, 18 + i, 48 + 64 * (i >> 1), 1)
    if n >= 4:
        for i in range(2):
            for j in range(2):
                H(8 + 4 * i + j, 11 + 4 * i - j, i)
    if n == 6:
        for i in range(4):
            for j in range(4):
                H(32 + 8 * i + j, 39 + 8 * i - j, i & 1)
    if n >= 3:
        for i in range(4):
            H(i, 7 - i, 0)
    if n >= 4:
        for i in range(2):
            B(13 - i, 10 + i, 32, 1)
    if n >= 5:
        for i in range(2):
            for j in range(4):
                H(16 + i * 8 + j, 23 + i * 8 - j, i)
    if n == 6:
        for i in range(8):
            B(59 - i, 36 + i, 48 if i < 4 else 112, 1)
    if n >= 4:
        for i in range(8):
            H(i, 15 - i, 0)
    if n >= 5:
        for i in range(4):
            B(27 - i, 20 + i, 32, 1)
    if n == 6:
        for i in range(8):
            H(32 + i, 47 - i, 0)
            H(48 + i, 63 - i, 1)
    if n >= 5:
        for i in range(16):
            H(i, 31 - i, 0)
    if n == 6:
        for i in range(8):
            B(55 - i, 40 + i, 32, 1)
    if n == 6:
        for i in range(32):
            H(i, 63 - i, 0)
    return s


def _compiled(n: int) -> list:
    """The steps with each rotation's cosine and sine looked up: (a, b, c,
    s, flip) for B, (a, b) for H (flip folded into the order)."""
    out = []
    for st in _dct_steps(n):
        if st[0] == "B":
            out.append((st[1], st[2], cos128(st[3]), sin128(st[3]), st[4]))
        else:
            out.append((st[2], st[1]) if st[3] else (st[1], st[2]))
    return out


_DCT = {n: _compiled(n) for n in range(2, 7)}
_BREV = {n: [brev(n, i) for i in range(1 << n)] for n in range(2, 7)}


def idct(t: list, n: int) -> list:
    t = [t[i] for i in _BREV[n]]
    for st in _DCT[n]:
        if len(st) == 5:
            a, b, c, s, flip = st
            ta, tb = t[a], t[b]
            x = (ta * c - tb * s + 2048) >> 12
            y = (ta * s + tb * c + 2048) >> 12
            if flip:
                t[a], t[b] = y, x
            else:
                t[a], t[b] = x, y
        else:
            a, b = st
            ta, tb = t[a], t[b]
            t[a], t[b] = ta + tb, ta - tb
    return t


def iadst4(t: list) -> list:
    x0, x1, x2, x3 = t
    s0 = SINPI[1] * x0 + SINPI[4] * x2 + SINPI[2] * x3
    s1 = SINPI[2] * x0 - SINPI[1] * x2 - SINPI[4] * x3
    s3 = SINPI[3] * x1
    s2 = SINPI[3] * (x0 - x2 + x3)
    return [_r12(s0 + s3), _r12(s1 + s3), _r12(s2), _r12(s0 + s1 - s3)]


def _btf(w0, x0, w1, x1):
    return _r12(w0 * x0 + w1 * x1)


def _rot(x, i, j, a, neg=False):
    """libaom's ADST rotation pair: (x_i, x_j) by cos/sin of angle a; with
    `neg`, the mirrored form of the second half."""
    c, s = COS128[a], COS128[64 - a]
    if not neg:
        x[i], x[j] = _btf(c, x[i], s, x[j]), _btf(s, x[i], -c, x[j])
    else:
        x[i], x[j] = _btf(-s, x[i], c, x[j]), _btf(c, x[i], s, x[j])


def iadst(t: list, n: int) -> list:
    """The inverse ADST (sections 7.13.2.6-9): ADST4 from the sinpi
    products, ADST8 / ADST16 as input permutation, rotations, then stages of
    butterflies and rotations of each group's upper half, and the output
    permutation with alternate signs."""
    if n == 2:
        return iadst4(t)
    size = 1 << n
    x = [None] * size
    for k in range(size // 2):
        x[2 * k] = t[size - 1 - 2 * k]
        x[2 * k + 1] = t[2 * k]
    for k in range(size // 2):
        _rot(x, 2 * k, 2 * k + 1, (32 // size) * (1 + 4 * k))
    half = size // 2
    while half >= 2:
        for g in range(0, size, 2 * half):
            for i in range(g, g + half):
                x[i], x[i + half] = x[i] + x[i + half], x[i] - x[i + half]
        quarter = max(half // 4, 1)
        for g in range(0, size, 2 * half):
            for k in range(half // 2):
                i = g + half + 2 * k
                _rot(x, i, i + 1, (64 // half) * (1 + 4 * (k % quarter)) if half > 2 else 32,
                     neg=half > 2 and k >= quarter)
        half //= 2
    return [x[j] if i % 2 == 0 else -x[j] for i, j in enumerate(_ADST_OUT[n])]


_ADST_OUT = {
    3: [0, 4, 6, 2, 3, 7, 5, 1],
    4: [0, 8, 12, 4, 6, 14, 10, 2, 3, 11, 15, 7, 5, 13, 9, 1],
}


def iidentity(t: list, n: int) -> list:
    if n == 2:
        return [_r12(v * 5793) for v in t]
    if n == 3:
        return [v * 2 for v in t]
    if n == 4:
        return [_r12(v * 11586) for v in t]
    return [v * 4 for v in t]


def _wht(t: list, shift: int) -> list:
    a, c, d, b = (v >> shift for v in t)
    a = a + c
    d = d - b
    e = (a - d) >> 1
    b = e - b
    c = e - c
    a = a - b
    d = d + c
    return [a, b, c, d]


_ONE_D = {_D: idct, _A: iadst, _I: iidentity}


def inverse_transform(coeffs: np.ndarray, tx_type: int, log2w: int, log2h: int,
                      bit_depth: int, lossless: bool) -> np.ndarray:
    """The 2-D inverse transform process (section 7.13.3) of a [h, w] int64
    block, flips included: the residual to add to the prediction."""
    w, h = 1 << log2w, 1 << log2h
    if lossless:
        mid = np.stack(_wht([coeffs[:, j].astype(np.int64) for j in range(4)], 2), 1)
        return np.stack(_wht([mid[i] for i in range(4)], 0), 0)
    col_kind, row_kind = KINDS[tx_type]
    rows_n = min(h, 32)
    blk = coeffs[:rows_n].astype(np.int64)
    if abs(log2w - log2h) == 1:
        blk = _r12(blk * 2896)
    lim = 1 << (bit_depth + 7)
    blk = np.clip(blk, -lim, lim - 1)
    t = [blk[:, j] for j in range(w)]
    t = _ONE_D[row_kind](t, log2w)
    shift = ROW_SHIFT[(log2w, log2h)]
    mid = np.stack(t, 1)
    if shift:
        mid = (mid + (1 << (shift - 1))) >> shift
    if rows_n < h:
        mid = np.concatenate([mid, np.zeros((h - rows_n, w), np.int64)], 0)
    lim = 1 << (max(bit_depth + 6, 16) - 1)
    mid = np.clip(mid, -lim, lim - 1)
    t = [mid[i] for i in range(h)]
    t = _ONE_D[col_kind](t, log2h)
    res = (np.stack(t, 0) + 8) >> 4
    if tx_type in FLIP_UD:
        res = res[::-1]
    if tx_type in FLIP_LR:
        res = res[:, ::-1]
    return res
