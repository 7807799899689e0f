"""VP8 pixel reconstruction and WebP's YUV -> BGR, without libwebp: NumPy,
following libwebp 1.5's `src/dsp/dec.c` (transforms, intra predictors,
loop filters), `src/dec/frame_dec.c` (macroblock borders, filter order)
and `src/dsp/upsampling.c` / `yuv.h` (fancy upsampling, 14-bit fixed-point
colour conversion), each in its C form (libwebp keeps its SIMD paths
bit-exact with it).

  * `idct`: every 4x4 block's inverse DCT at once (TransformOne, whose
    residual is added to the prediction and clipped);
  * `reconstruct`: macroblocks in raster order: 16x16 (DC, TM, VE, HE)
    or sixteen 4x4 predictions (ten modes, each 4x4 block predicted from
    its reconstructed neighbours), chroma 8x8; a frame's top border reads
    127, its left border 129 (the top-left corner 127 on the first row,
    129 below), a 4x4 block on the right column reads the macroblock's
    top-right samples (the last pixel above repeated on the frame's right
    edge), DC prediction drops a missing border;
  * the loop filter over the finished frame (`_loop_filter`), macroblock by
    macroblock in raster order (left edge, inner vertical edges, top edge,
    inner horizontal edges), simple (luma only) or normal (luma and
    chroma, with high-edge-variance selection); macroblocks whose order
    does not matter (those of equal x + 2y) are filtered at once;
  * `yuv_to_bgr`: fancy upsampling of U and V (9-3-3-1 weights, the
    image's first and last rows and columns mirrored) and
    VP8YUVToR/G/B.
"""

from __future__ import annotations

import numpy as np


def idct(coeffs: np.ndarray) -> np.ndarray:
    """[..., 16] dequantised coefficients (raster order) -> [..., 4, 4]
    residuals, libwebp's TransformOne without the add: (v >> 3)."""
    c = coeffs.reshape(coeffs.shape[:-1] + (4, 4)).astype(np.int64)

    def mul1(a):
        return ((a * 20091) >> 16) + a

    def mul2(a):
        return (a * 35468) >> 16

    # vertical pass over each column: rows 0..3 of the input
    a = c[..., 0, :] + c[..., 2, :]
    b = c[..., 0, :] - c[..., 2, :]
    cc = mul2(c[..., 1, :]) - mul1(c[..., 3, :])
    d = mul1(c[..., 1, :]) + mul2(c[..., 3, :])
    tmp = np.stack([a + d, b + cc, b - cc, a - d], -2)       # [..., k, col]
    # horizontal pass: output row k from tmp[k, 0..3]
    dc = tmp[..., 0] + 4
    a = dc + tmp[..., 2]
    b = dc - tmp[..., 2]
    cc = mul2(tmp[..., 1]) - mul1(tmp[..., 3])
    d = mul1(tmp[..., 1]) + mul2(tmp[..., 3])
    out = np.stack([a + d, b + cc, b - cc, a - d], -1) >> 3
    return out.astype(np.int32)


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _avg2(a, b):
    return (a + b + 1) >> 1


def _clip8(v):
    return 0 if v < 0 else 255 if v > 255 else v


def _pred4(mode: int, X: int, t: list, lf: list) -> list:
    """libwebp's 4x4 predictors (DC, TM, VE, HE, RD, VR, LD, VL, HD, HU):
    16 values row-major from the top-left X, the eight pixels above t
    (A..H) and the four to the left lf (I..L)."""
    A, B, C, D, E, F, G, H = t
    I, J, K, L = lf
    if mode == 0:
        dc = (A + B + C + D + I + J + K + L + 4) >> 3
        return [dc] * 16
    if mode == 1:
        return [_clip8(t[x] + lf[y] - X) for y in range(4) for x in range(4)]
    if mode == 2:
        row = [_avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E)]
        return row * 4
    if mode == 3:
        v = [_avg3(X, I, J), _avg3(I, J, K), _avg3(J, K, L), _avg3(K, L, L)]
        return [v[y] for y in range(4) for _ in range(4)]
    if mode == 4:      # RD
        e = [_avg3(J, K, L), _avg3(I, J, K), _avg3(X, I, J), _avg3(A, X, I),
             _avg3(B, A, X), _avg3(C, B, A), _avg3(D, C, B)]
        return [e[3 - y + x] for y in range(4) for x in range(4)]
    if mode == 5:      # VR
        o = [0] * 16
        o[0] = o[9] = _avg2(X, A)
        o[1] = o[10] = _avg2(A, B)
        o[2] = o[11] = _avg2(B, C)
        o[3] = _avg2(C, D)
        o[12] = _avg3(K, J, I)
        o[8] = _avg3(J, I, X)
        o[4] = o[13] = _avg3(I, X, A)
        o[5] = o[14] = _avg3(X, A, B)
        o[6] = o[15] = _avg3(A, B, C)
        o[7] = _avg3(B, C, D)
        return o
    if mode == 6:      # LD
        e = [_avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E), _avg3(D, E, F),
             _avg3(E, F, G), _avg3(F, G, H), _avg3(G, H, H)]
        return [e[x + y] for y in range(4) for x in range(4)]
    if mode == 7:      # VL
        o = [0] * 16
        o[0] = _avg2(A, B)
        o[1] = o[8] = _avg2(B, C)
        o[2] = o[9] = _avg2(C, D)
        o[3] = o[10] = _avg2(D, E)
        o[4] = _avg3(A, B, C)
        o[5] = o[12] = _avg3(B, C, D)
        o[6] = o[13] = _avg3(C, D, E)
        o[7] = o[14] = _avg3(D, E, F)
        o[11] = _avg3(E, F, G)
        o[15] = _avg3(F, G, H)
        return o
    if mode == 8:      # HD
        o = [0] * 16
        o[0] = o[6] = _avg2(I, X)
        o[4] = o[10] = _avg2(J, I)
        o[8] = o[14] = _avg2(K, J)
        o[12] = _avg2(L, K)
        o[3] = _avg3(A, B, C)
        o[2] = _avg3(X, A, B)
        o[1] = o[7] = _avg3(I, X, A)
        o[5] = o[11] = _avg3(J, I, X)
        o[9] = o[15] = _avg3(K, J, I)
        o[13] = _avg3(L, K, J)
        return o
    o = [L] * 16       # HU
    o[0] = _avg2(I, J)
    o[2] = o[4] = _avg2(J, K)
    o[6] = o[8] = _avg2(K, L)
    o[1] = _avg3(I, J, K)
    o[3] = o[5] = _avg3(J, K, L)
    o[7] = o[9] = _avg3(K, L, L)
    return o


def _pred_block(mode: int, top: np.ndarray, left: np.ndarray, corner: int,
                size: int, has_top: bool, has_left: bool) -> np.ndarray:
    """libwebp's 16x16 / 8x8 predictors: DC (dropping a missing border),
    TM, VE, HE."""
    shift = 4 if size == 16 else 3
    if mode == 0:
        if has_top and has_left:
            dc = (int(top.sum()) + int(left.sum()) + size) >> (shift + 1)
        elif has_left:
            dc = (int(left.sum()) + (size >> 1)) >> shift
        elif has_top:
            dc = (int(top.sum()) + (size >> 1)) >> shift
        else:
            dc = 0x80
        return np.full((size, size), dc, np.int32)
    if mode == 1:
        return np.clip(top[None, :] + left[:, None] - corner, 0, 255)
    if mode == 2:
        return np.broadcast_to(top[None, :], (size, size))
    return np.broadcast_to(left[:, None], (size, size))


def _borders(plane: np.ndarray, x0: int, y0: int, size: int, extra: int):
    """The top row (with `extra` samples past it), left column and corner
    of the block at (x0, y0), with libwebp's frame borders."""
    w = plane.shape[1]
    if y0 == 0:
        top = np.full(size + extra, 127, np.int32)
        corner = 127
    else:
        row = plane[y0 - 1]
        top = np.empty(size + extra, np.int32)
        top[:size] = row[x0:x0 + size]
        if extra:
            top[size:] = row[x0 + size:x0 + size + extra] if x0 + size < w else row[x0 + size - 1]
        corner = 129 if x0 == 0 else int(row[x0 - 1])
    left = (np.full(size, 129, np.int32) if x0 == 0
            else plane[y0:y0 + size, x0 - 1].astype(np.int32))
    return top, left, corner


def reconstruct(modes, coeffs, inner, strengths, ftype: int, mbw: int, mbh: int):
    """The frame's Y, U, V planes ([16 mbh, 16 mbw] and [8 mbh, 8 mbw]
    uint8) from the macroblocks' modes and dequantised coefficients."""
    res = idct(coeffs.reshape(-1, 24, 16))
    Y = np.zeros((16 * mbh, 16 * mbw), np.int32)
    U = np.zeros((8 * mbh, 8 * mbw), np.int32)
    V = np.zeros((8 * mbh, 8 * mbw), np.int32)
    for my in range(mbh):
        for mx in range(mbw):
            k = my * mbw + mx
            _, _, i4, bmodes, uvmode = modes[k]
            x0, y0 = 16 * mx, 16 * my
            top, left, corner = _borders(Y, x0, y0, 16, 4)
            r = res[k]
            if i4:
                wb = [[0] * 21 for _ in range(17)]
                wb[0] = [corner] + top.tolist()
                for yy in range(16):
                    wb[yy + 1][0] = int(left[yy])
                tr = wb[0][17:21]
                for yy in (4, 8, 12):
                    wb[yy][17:21] = tr
                for n in range(16):
                    by, bx = 4 * (n >> 2), 4 * (n & 3)
                    above = wb[by]
                    t = above[bx + 1:bx + 9]
                    lf = [wb[by + 1][bx], wb[by + 2][bx], wb[by + 3][bx], wb[by + 4][bx]]
                    pred = _pred4(bmodes[n], above[bx], t, lf)
                    rr = r[n].reshape(-1).tolist()
                    for yy in range(4):
                        row = wb[by + 1 + yy]
                        for xx in range(4):
                            row[bx + 1 + xx] = _clip8(pred[4 * yy + xx] + rr[4 * yy + xx])
                Y[y0:y0 + 16, x0:x0 + 16] = [row[1:17] for row in wb[1:]]
            else:
                pred = _pred_block(bmodes[0], top[:16], left, corner, 16, y0 > 0, x0 > 0)
                blocks = r[:16].reshape(4, 4, 4, 4).transpose(0, 2, 1, 3).reshape(16, 16)
                Y[y0:y0 + 16, x0:x0 + 16] = np.clip(pred + blocks, 0, 255)
            cx, cy = 8 * mx, 8 * my
            for plane, first in ((U, 16), (V, 20)):
                top, left, corner = _borders(plane, cx, cy, 8, 0)
                pred = _pred_block(uvmode, top, left, corner, 8, cy > 0, cx > 0)
                blocks = r[first:first + 4].reshape(2, 2, 4, 4).transpose(0, 2, 1, 3).reshape(8, 8)
                plane[cy:cy + 8, cx:cx + 8] = np.clip(pred + blocks, 0, 255)
    if ftype:
        _loop_filter(Y, U, V, modes, inner, strengths, ftype, mbw, mbh)
    return Y.astype(np.uint8), U.astype(np.uint8), V.astype(np.uint8)


# --- loop filter -----------------------------------------------------------------

def _sclip1(v):
    return np.clip(v, -128, 127)


def _sclip2(v):
    return np.clip(v, -16, 15)


def _filter(flat: np.ndarray, q0: np.ndarray, step: int, thresh: np.ndarray,
            ithresh: np.ndarray | None, hev: np.ndarray | None, mb_edge: bool) -> None:
    """One edge pass at the flat positions `q0` (p across `step`): simple
    (ithresh None) or normal, libwebp's DoFilter2/4/6 and their masks."""
    if len(q0) == 0:
        return
    idx = q0[:, None] + step * np.arange(-4, 4)[None, :]
    P = flat[idx]
    p3, p2, p1, p0, q0v, q1, q2, q3 = (P[:, i] for i in range(8))
    t2 = 2 * thresh + 1
    mask = 4 * np.abs(p0 - q0v) + np.abs(p1 - q1) <= t2
    if ithresh is not None:
        it = ithresh
        mask &= ((np.abs(p3 - p2) <= it) & (np.abs(p2 - p1) <= it) & (np.abs(p1 - p0) <= it)
                 & (np.abs(q3 - q2) <= it) & (np.abs(q2 - q1) <= it) & (np.abs(q1 - q0v) <= it))
        is_hev = (np.abs(p1 - p0) > hev) | (np.abs(q1 - q0v) > hev)
    else:
        is_hev = np.ones(len(q0), bool)
    out = P.copy()
    # DoFilter2 (simple filter, or high edge variance)
    f2 = mask & is_hev
    a = 3 * (q0v - p0) + _sclip1(p1 - q1)
    a1 = _sclip2((a + 4) >> 3)
    a2 = _sclip2((a + 3) >> 3)
    out[f2, 3] = np.clip(p0 + a2, 0, 255)[f2]
    out[f2, 4] = np.clip(q0v - a1, 0, 255)[f2]
    fo = mask & ~is_hev
    if fo.any():
        if mb_edge:            # DoFilter6
            a = _sclip1(3 * (q0v - p0) + _sclip1(p1 - q1))
            a1 = (27 * a + 63) >> 7
            a2 = (18 * a + 63) >> 7
            a3 = (9 * a + 63) >> 7
            for col, v in ((1, p2 + a3), (2, p1 + a2), (3, p0 + a1),
                           (4, q0v - a1), (5, q1 - a2), (6, q2 - a3)):
                out[fo, col] = np.clip(v, 0, 255)[fo]
        else:                  # DoFilter4
            a = 3 * (q0v - p0)
            a1 = _sclip2((a + 4) >> 3)
            a2 = _sclip2((a + 3) >> 3)
            a3 = (a1 + 1) >> 1
            for col, v in ((2, p1 + a3), (3, p0 + a2), (4, q0v - a1), (5, q1 - a3)):
                out[fo, col] = np.clip(v, 0, 255)[fo]
    flat[idx] = out


def _loop_filter(Y, U, V, modes, inner, strengths, ftype, mbw, mbh) -> None:
    """libwebp's DoFilter for every macroblock, in an order equivalent to
    raster order: a macroblock reads and writes pixels of its left and top
    neighbours (and, through them, of the top-right one), so macroblocks
    of equal x + 2y are independent and are filtered together."""
    yf = Y.reshape(-1)
    ys = Y.shape[1]
    C = np.concatenate([U, V], 0)          # U above V: one flat chroma array
    cf = C.reshape(-1)
    cs = C.shape[1]
    voff = U.size
    mbs = np.arange(mbw * mbh)
    mxs, mys = mbs % mbw, mbs // mbw
    info = np.array([strengths[modes[k][0]][int(modes[k][2])] for k in mbs]).reshape(-1, 3)
    limit, ilevel, hev = info[:, 0], info[:, 1], info[:, 2]
    t = mxs + 2 * mys
    pos16 = np.arange(16)
    pos8 = np.arange(8)
    for step in range(int(t.max()) + 1):
        sel = np.flatnonzero((t == step) & (limit > 0))
        if len(sel) == 0:
            continue
        mx, my = mxs[sel], mys[sel]
        inn = inner[sel]
        lim, il, hv = limit[sel], ilevel[sel], hev[sel]

        def luma(cond, x_off, y_off, vertical_edge, add, mb_edge):
            s = cond
            if not s.any():
                return
            base = (16 * my[s] + y_off) * ys + 16 * mx[s] + x_off
            along = pos16 * (ys if vertical_edge else 1)
            q0 = (base[:, None] + along[None, :]).reshape(-1)
            rep = lambda a: np.repeat(a[s], 16)
            if ftype == 1:
                _filter(yf, q0, 1 if vertical_edge else ys, rep(lim + add), None, None, mb_edge)
            else:
                _filter(yf, q0, 1 if vertical_edge else ys, rep(lim + add), rep(il), rep(hv), mb_edge)

        def chroma(cond, x_off, y_off, vertical_edge, add, mb_edge):
            s = cond
            if not s.any() or ftype == 1:
                return
            base = (8 * my[s] + y_off) * cs + 8 * mx[s] + x_off
            base = np.concatenate([base, base + voff])
            along = pos8 * (cs if vertical_edge else 1)
            q0 = (base[:, None] + along[None, :]).reshape(-1)
            rep = lambda a: np.tile(np.repeat(a[s], 8), 2)
            _filter(cf, q0, 1 if vertical_edge else cs, rep(lim + add), rep(il), rep(hv), mb_edge)

        left = mx > 0
        luma(left, 0, 0, True, 4, True)
        chroma(left, 0, 0, True, 4, True)
        for off in (4, 8, 12):
            luma(inn, off, 0, True, 0, False)
        chroma(inn, 4, 0, True, 0, False)
        above = my > 0
        luma(above, 0, 0, False, 4, True)
        chroma(above, 0, 0, False, 4, True)
        for off in (4, 8, 12):
            luma(inn, 0, off, False, 0, False)
        chroma(inn, 0, 4, False, 0, False)
    U[...] = C[:U.shape[0]]
    V[...] = C[U.shape[0]:]


# --- colour ------------------------------------------------------------------------

def _upsample(P: np.ndarray, h: int, w: int) -> np.ndarray:
    """libwebp's fancy upsampler of one chroma plane to [h, w]."""
    P = P.astype(np.int32)
    ch = P.shape[0]
    r = np.arange(h)
    k = (r + 1) >> 1
    near = np.where(r == 0, 0, np.where(r & 1, k - 1, k))
    far = np.where(r == 0, 0, np.where(r & 1, np.minimum(k, ch - 1), k - 1))
    N, F = P[near], P[far]
    out = np.empty((h, w), np.int32)
    out[:, 0] = (3 * N[:, 0] + F[:, 0] + 2) >> 2
    c = np.arange(1, w)
    x = (c + 1) >> 1
    n = np.where(c & 1, x - 1, x)
    f = np.where(c & 1, x, x - 1)
    last = (w & 1) == 0
    cols = c[:-1] if last else c
    nn, ff = n[:len(cols)], f[:len(cols)]
    diag = (N[:, nn] + F[:, ff] + 3 * (N[:, ff] + F[:, nn]) + 8) >> 3
    out[:, cols] = (diag + N[:, nn]) >> 1
    if last and w > 1:
        j = (w - 1) >> 1
        out[:, w - 1] = (3 * N[:, j] + F[:, j] + 2) >> 2
    return out


def _clip_yuv(v: np.ndarray) -> np.ndarray:
    return np.where((v & ~16383) == 0, v >> 6, np.where(v < 0, 0, 255))


def yuv_to_bgr(Y: np.ndarray, U: np.ndarray, V: np.ndarray, w: int, h: int) -> np.ndarray:
    """[h, w, 3] uint8 BGR as WebPDecodeBGR gives it: fancy upsampling and
    VP8YUVToR/G/B (MultHi(v, c) = (v * c) >> 8, then a 6-bit shift)."""
    y = Y[:h, :w].astype(np.int32)
    uw, uh = (w + 1) // 2, (h + 1) // 2
    u = _upsample(U[:uh, :uw], h, w)
    v = _upsample(V[:uh, :uw], h, w)
    yy = (y * 19077) >> 8
    r = _clip_yuv(yy + ((v * 26149) >> 8) - 14234)
    g = _clip_yuv(yy - ((u * 6419) >> 8) - ((v * 13320) >> 8) + 8708)
    b = _clip_yuv(yy + ((u * 33050) >> 8) - 17685)
    return np.stack([b, g, r], -1).astype(np.uint8)
