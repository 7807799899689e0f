"""The pixels of a JPEG from its coefficients, as libjpeg-turbo makes them
with cv2's settings, in NumPy over all blocks at once: dequantisation and
the ISLOW inverse DCT (`jidctint.c`), the upsampling of subsampled
components (`jdsample.c`, fancy where libjpeg is) and the colour conversion
(`jdcolor.c`).

  * IDCT: 13-bit fixed-point constants, 2 extra bits kept between the column
    and the row pass, each pass rounded, as libjpeg-turbo's AVX2 ISLOW IDCT
    (`jidctint-avx2.asm`, which cv2's SIMD build runs) computes them: the
    dequantised coefficient and four of each pass's input sums wrap at 16
    bits; the column pass's results saturate at 16 bits, except in a block
    whose coefficient rows 1-7 are all zero, whose columns are their row-0
    values shifted left in 16 bits (wrapping); the output saturates to
    0..255.
    (The C code would keep them in 32 bits and wrap outputs past +-384
    through its range-limit table; valid data never gets there, corrupt
    data does.)
  * Upsampling of a component with h x v sampling under the frame's
    maximum: 2:1 across (and down) is libjpeg's "fancy" triangle filter,
    3/4 of the nearer sample and 1/4 of the further with biases 1 / 2
    (h2v1) or 8 / 7 over 16 with the neighbour rows weighted 3:1 (h2v2),
    and 1 / 2 down (h1v2); the samples past the component's own width and
    height repeat its last column and row, as libjpeg's context rows do.  A
    component at most 2 samples wide takes the box filter instead, as does
    every other integer ratio (`int_upsample`).  No merged upsampler: cv2
    leaves fancy upsampling on, which rules it out.
  * Colour: YCbCr -> RGB with libjpeg's 16-bit fixed-point tables; grey mode
    is the Y plane alone (no conversion), or, for an RGB-coded JPEG, libjpeg's
    fixed-point RGB -> Y.  Four components: cv2 asks libjpeg for CMYK (YCCK
    through `ycck_cmyk_convert`: the YCbCr -> RGB tables, each channel
    255 - it, clamped; K as stored) and converts it itself, taking the
    values as inverted (Adobe) CMYK: `icvCvt_CMYK2BGR_8u_C4C3R`'s
    c' = k - ((255 - c) k >> 8) for each of C, M, Y -> R, G, B, and for
    grey `icvCvt_CMYK2Gray_8u_C4C1R`, cv2's fixed-point grey of that
    colour.  "unchanged" of three or four components is the "color" result.
  * Lossless frames (`data/jpeg_lossless.py`) skip the IDCT: the samples are
    (value << Pt) & 255.  libjpeg-turbo allows no lossy colour conversion
    in lossless mode: grey reads only as grey, RGB only as colour, CMYK in
    every mode (cv2 converts it), YCbCr and YCCK not at all
    (`UnreadableImage`).
"""

from __future__ import annotations

import numpy as np

# jidctint.c's FIX(x) at CONST_BITS 13
_F = {"0_298631336": 2446, "0_390180644": 3196, "0_541196100": 4433,
      "0_765366865": 6270, "0_899976223": 7373, "1_175875602": 9633,
      "1_501321110": 12299, "1_847759065": 15137, "1_961570560": 16069,
      "2_053119869": 16819, "2_562915447": 20995, "3_072711026": 25172}
CONST_BITS, PASS1_BITS = 13, 2


def _wrap16(x: np.ndarray) -> np.ndarray:
    return ((x + 32768) & 0xFFFF) - 32768


def _idct_1d(d: list[np.ndarray]) -> list[np.ndarray]:
    """One pass of jpeg_idct_islow over 8 inputs (each an array), before the
    final descale, as the AVX2 code computes it: the sums d0 + d4, d0 - d4,
    d7 + d3 and d5 + d1 are taken in 16 bits (vpaddw / vpsubw, wrapping);
    every product and every other sum is exact (vpmaddwd, 32 bits)."""
    z2, z3 = d[2], d[6]
    z1 = (z2 + z3) * _F["0_541196100"]
    tmp2 = z1 - z3 * _F["1_847759065"]
    tmp3 = z1 + z2 * _F["0_765366865"]
    tmp0 = _wrap16(d[0] + d[4]) << CONST_BITS
    tmp1 = _wrap16(d[0] - d[4]) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = d[7], d[5], d[3], d[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, _wrap16(t0 + t2), _wrap16(t1 + t3)
    z5 = (z3 + z4) * _F["1_175875602"]
    t0 = t0 * _F["0_298631336"]
    t1 = t1 * _F["2_053119869"]
    t2 = t2 * _F["3_072711026"]
    t3 = t3 * _F["1_501321110"]
    z1 = z1 * -_F["0_899976223"]
    z2 = z2 * -_F["2_562915447"]
    z3 = z3 * -_F["1_961570560"] + z5
    z4 = z4 * -_F["0_390180644"] + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    return [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]


def idct_islow(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """[..., 64] coefficients (natural order) and a [64] quantisation table
    -> [..., 8, 8] uint8 samples, exactly as libjpeg-turbo's AVX2
    jsimd_idct_islow."""
    x = _wrap16(coef.astype(np.int64) * quant.astype(np.int64))      # vpmullw
    x = x.reshape(x.shape[:-1] + (8, 8))
    # pass 1: columns (row index = vertical frequency); packed with saturation
    cols = _idct_1d([x[..., k, :] for k in range(8)])
    half = 1 << (CONST_BITS - PASS1_BITS - 1)
    ws = np.clip(np.stack([(c + half) >> (CONST_BITS - PASS1_BITS) for c in cols], axis=-2),
                 -32768, 32767)
    # a block whose rows 1-7 of coefficients are all zero takes the shortcut:
    # each column is its row-0 value << PASS1_BITS, shifted in 16 bits
    flat = (coef.reshape(coef.shape[:-1] + (8, 8))[..., 1:, :] == 0).all(axis=(-2, -1))
    dc_rows = np.broadcast_to(_wrap16(x[..., :1, :] << PASS1_BITS), ws.shape)
    ws = np.where(flat[..., None, None], dc_rows, ws)
    # pass 2: rows
    rows = _idct_1d([ws[..., :, k] for k in range(8)])
    shift = CONST_BITS + PASS1_BITS + 3
    out = np.stack([(r + (1 << (shift - 1))) >> shift for r in rows], axis=-1)
    return np.clip(out + 128, 0, 255).astype(np.uint8)


# the natural positions of zigzag coefficients 1-9, which block smoothing
# estimates (jdcoefct.c's Q01_POS ... Q30_POS)
_SMOOTHED = (1, 8, 16, 9, 2, 3, 10, 17, 24)
# the 5x5 DC weights of each estimate (rows: two above to two below;
# columns: two left to two right), with DC interpolation (no AC known) and
# without, as decompress_smooth_data spells them out
_W_DC = {
    1: ((-1, -1, 0, 1, 1), (-3, 13, 0, -13, 3), (-3, 38, 0, -38, 3), (-3, 13, 0, -13, 3),
        (-1, -1, 0, 1, 1)),
    8: ((-1, -3, -3, -3, -1), (-1, 13, 38, 13, -1), (0, 0, 0, 0, 0), (1, -13, -38, -13, 1),
        (1, 3, 3, 3, 1)),
    16: ((0, 0, 1, 0, 0), (0, 2, 7, 2, 0), (0, -5, -14, -5, 0), (0, 2, 7, 2, 0),
         (0, 0, 1, 0, 0)),
    9: ((-1, 0, 0, 0, 1), (0, 9, 0, -9, 0), (0, 0, 0, 0, 0), (0, -9, 0, 9, 0),
        (1, 0, 0, 0, -1)),
    2: ((0, 0, 0, 0, 0), (0, 2, -5, 2, 0), (1, 7, -14, 7, 1), (0, 2, -5, 2, 0),
        (0, 0, 0, 0, 0)),
    3: ((0, 0, 0, 0, 0), (0, 1, 0, -1, 0), (0, 2, 0, -2, 0), (0, 1, 0, -1, 0),
        (0, 0, 0, 0, 0)),
    10: ((0, 0, 0, 0, 0), (0, 1, -3, 1, 0), (0, 0, 0, 0, 0), (0, -1, 3, -1, 0),
         (0, 0, 0, 0, 0)),
    17: ((0, 0, 0, 0, 0), (0, 1, 0, -1, 0), (0, -3, 0, 3, 0), (0, 1, 0, -1, 0),
         (0, 0, 0, 0, 0)),
    24: ((0, 0, 0, 0, 0), (0, 1, 2, 1, 0), (0, 0, 0, 0, 0), (0, -1, -2, -1, 0),
         (0, 0, 0, 0, 0)),
    0: ((-2, -6, -8, -6, -2), (-6, 6, 42, 6, -6), (-8, 42, 152, 42, -8), (-6, 6, 42, 6, -6),
        (-2, -6, -8, -6, -2)),
}
_W_AC = {
    1: ((0, 0, 0, 0, 0), (0, 0, 0, 0, 0), (-7, 50, 0, -50, 7), (0, 0, 0, 0, 0),
        (0, 0, 0, 0, 0)),
    8: ((0, 0, -7, 0, 0), (0, 0, 50, 0, 0), (0, 0, 0, 0, 0), (0, 0, -50, 0, 0),
        (0, 0, 7, 0, 0)),
    16: ((0, 0, -1, 0, 0), (0, 0, 13, 0, 0), (0, 0, -24, 0, 0), (0, 0, 13, 0, 0),
         (0, 0, -1, 0, 0)),
    9: ((0, -1, 0, 1, 0), (-1, 10, 0, -10, 1), (0, 0, 0, 0, 0), (1, -10, 0, 10, -1),
        (0, 1, 0, -1, 0)),
    2: ((0, 0, 0, 0, 0), (0, 0, 0, 0, 0), (-1, 13, -24, 13, -1), (0, 0, 0, 0, 0),
        (0, 0, 0, 0, 0)),
}


def _smooth_rows(n_rows: int, v: int, imcu_rows: int) -> np.ndarray:
    """[n_rows, 5]: the block rows decompress_smooth_data takes as two
    above, this, and two below each block row of a component, with its
    clamps, which count rows of the last iMCU row with that row's own
    height (so near the bottom a clamp can pick a padding row, or the
    row itself, where the true neighbour exists)."""
    last = imcu_rows - 1
    rem = n_rows % v or v
    out = np.empty((n_rows, 5), np.int64)
    for r in range(n_rows):
        big, b = divmod(r, v)
        br = rem if big == last else v
        ibr, ibrs = big * br + b, br * imcu_rows
        p = r - 1 if ibr > 0 else r
        pp = r - 2 if ibr > 1 else p
        n = r + 1 if ibr < ibrs - 1 else r
        nn = r + 2 if ibr < ibrs - 2 else n
        out[r] = (pp, p, r, n, nn)
    return out


def smooth(coef: np.ndarray, bits: list, quant: np.ndarray, v: int, imcu_rows: int,
           rows: int, cols: int) -> np.ndarray:
    """libjpeg-turbo 3.1's block smoothing (`jdcoefct.c`,
    decompress_smooth_data) of one component's [gh, gw, 64] coefficients
    (natural order; the first `rows` x `cols` blocks are the image's):
    where a coefficient of zigzag index 1-9 is still zero and not known
    exactly (`bits[k]`, the Al of its last scan, is not 0), it becomes an
    estimate from the 5x5 DC values around its block (edges clamped), cut
    to below 2^Al; with no AC coefficient known at all (bits 1-9 all -1) the
    DC is re-estimated too, and four more AC coefficients."""
    c16 = ((coef.astype(np.int64) + 32768) & 0xFFFF) - 32768
    dc = c16[..., 0]
    rr = _smooth_rows(rows, v, imcu_rows)
    cc = np.clip(np.arange(cols)[:, None] + np.arange(-2, 3)[None, :], 0, cols - 1)
    win = dc[rr[:, None, :, None], cc[None, :, None, :]]          # [rows, cols, 5, 5]
    change_dc = all(b == -1 for b in bits[1:10])
    weights = _W_DC if change_dc else _W_AC
    out = c16.copy()
    blk = out[:rows, :cols]
    q00 = int(quant[0])
    for k, pos in enumerate(_SMOOTHED + (0,), start=1):
        if pos not in weights:
            continue
        num = q00 * np.einsum("rcij,ij->rc", win, np.asarray(weights[pos], np.int64))
        q = int(quant[pos]) << 8
        pred = (np.abs(num) + (q >> 1)) // q
        if pos == 0:
            blk[..., 0] = ((np.where(num >= 0, pred, -pred) + 32768) & 0xFFFF) - 32768
            continue
        al = bits[k]
        if al > 0:
            pred = np.minimum(pred, (1 << al) - 1)
        pred = np.where(num >= 0, pred, -pred)
        pred = ((pred + 32768) & 0xFFFF) - 32768
        if al != 0:
            blk[..., pos] = np.where(blk[..., pos] == 0, pred, blk[..., pos])
    return out


def _plane(comp, frame: dict) -> np.ndarray:
    """A component's samples over its own downsampled size."""
    coef = comp.coefficients()
    if frame.get("smooth"):
        cur, prev = frame["smooth"]["bits"][comp.index]
        args = comp.quant, comp.v, frame["mcu_rows"], comp.blocks_h, comp.blocks_w
        coef, below = smooth(coef, cur, *args), smooth(coef, prev, *args)
        first = (frame["smooth"]["last_good"] + 1) * comp.v
        coef[first:] = below[first:]
    blocks = idct_islow(coef, comp.quant)                      # [gh, gw, 8, 8]
    gh, gw = blocks.shape[:2]
    plane = blocks.transpose(0, 2, 1, 3).reshape(gh * 8, gw * 8)
    dw = -(-frame["width"] * comp.h // frame["hmax"])
    dh = -(-frame["height"] * comp.v // frame["vmax"])
    return plane[:dh, :dw]


def _fancy_h(x: np.ndarray, b0: int, b1: int, shift: int, w3: int = 3) -> np.ndarray:
    """Double the width: out[2c] = (3 x[c] + x[c-1] + b0) >> shift,
    out[2c+1] = (3 x[c] + x[c+1] + b1) >> shift, edges repeated."""
    left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
    out = np.empty((x.shape[0], x.shape[1] * 2), np.int64)
    out[:, 0::2] = (w3 * x + left + b0) >> shift
    out[:, 1::2] = (w3 * x + right + b1) >> shift
    return out


def upsample(plane: np.ndarray, h: int, v: int, hmax: int, vmax: int,
             fancy: bool = True) -> np.ndarray:
    """One component's plane up to the frame's sampling, as libjpeg's
    upsampler for that ratio does it (uncropped).  `fancy` False: the box
    filter, which libjpeg-turbo takes in lossless frames (its blocks are one
    sample, so `jdsample.c` turns fancy upsampling off)."""
    x = plane.astype(np.int64)
    dw = x.shape[1]
    if (h, v) == (hmax, vmax):
        return x
    if not fancy:
        return np.repeat(np.repeat(x, vmax // v, axis=0), hmax // h, axis=1)
    if h * 2 == hmax and v == vmax and dw > 2:                     # h2v1 fancy
        return _fancy_h(x, 1, 2, 2)
    if h * 2 == hmax and v * 2 == vmax and dw > 2:                 # h2v2 fancy
        up = np.concatenate([x[:1], x[:-1]], axis=0)
        down = np.concatenate([x[1:], x[-1:]], axis=0)
        sums = np.empty((x.shape[0] * 2, dw), np.int64)
        sums[0::2] = 3 * x + up
        sums[1::2] = 3 * x + down
        return _fancy_h(sums, 8, 7, 4)
    if h == hmax and v * 2 == vmax:                                # h1v2 fancy
        return _fancy_h(x.T, 1, 2, 2).T
    if hmax % h or vmax % v:
        raise ValueError(f"JPEG sampling {h}x{v} under {hmax}x{vmax} is not integral")
    return np.repeat(np.repeat(x, vmax // v, axis=0), hmax // h, axis=1)  # box


def _ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert (SCALEBITS 16, round to nearest)."""
    cb, cr = cb - 128, cr - 128
    r = y + ((91881 * cr + 32768) >> 16)
    g = y + ((-22554 * cb + 32768 - 46802 * cr) >> 16)
    b = y + ((116130 * cb + 32768) >> 16)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def _rgb_to_y(r: np.ndarray, g: np.ndarray, b: np.ndarray) -> np.ndarray:
    """jdcolor.c's rgb_gray_convert."""
    return ((19595 * r + 38470 * g + 7471 * b + 32768) >> 16).astype(np.uint8)


def _cmyk_to_rgb(c, m, y, k) -> np.ndarray:
    """cv2's CMYK -> BGR on inverted CMYK, as RGB: v' = k - ((255 - v) k >> 8)."""
    return np.stack([k - (((255 - v) * k) >> 8) for v in (c, m, y)], -1).astype(np.uint8)


def _lossless_refusal(color: str, n: int, mode: str) -> None:
    """libjpeg-turbo's refusal of a colour conversion in lossless mode
    (cv2 asks for grey in "gray" mode and for BGR otherwise, or for CMYK
    from four components; "unchanged" of one component is grey)."""
    out = "cmyk" if n == 4 else "gray" if mode == "gray" or (n == 1 and mode == "unchanged") \
        else "rgb"
    if out != color:
        from kgtpu_torch.data.imread import UnreadableImage
        raise UnreadableImage(f"lossless JPEG of colour space {color} read as {out} (libjpeg "
                              "refuses a colour conversion in lossless mode)")


def to_pixels(img: dict, mode: str) -> np.ndarray:
    """A parsed JPEG (`jpeg.parse`) as one of `imread.MODES` ("unchanged" is
    "color" for three or four components and "gray" for one, as in cv2)."""
    comps = img["components"]
    hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
    frame = {"width": img["width"], "height": img["height"], "hmax": hmax, "vmax": vmax,
             "smooth": img.get("smooth"), "mcu_rows": -(-img["height"] // (8 * vmax))}
    w, h = img["width"], img["height"]
    color = img["color"]
    if img["lossless"]:
        _lossless_refusal(color, len(comps), mode)
    if mode == "unchanged":
        mode = "gray" if len(comps) == 1 else "color"
    used = comps[:1] if len(comps) == 1 or (mode == "gray" and color == "ycc") else comps
    planes = []
    for c in used:
        if img["lossless"]:
            plane = (c.samples << c.pt) & 255
        else:
            plane = _plane(c, frame)
        planes.append(upsample(plane, c.h, c.v, hmax, vmax, fancy=not img["lossless"])[:h, :w])
    if len(planes) == 1:
        y = planes[0].astype(np.uint8)
        return np.repeat(y[..., None], 3, axis=-1) if mode == "color" else y
    if len(planes) == 4:
        c, m, y, k = planes
        if color == "ycck":
            r, g, b = (v.astype(np.int64) for v in np.moveaxis(_ycc_to_rgb(c, m, y), -1, 0))
            c, m, y = 255 - r, 255 - g, 255 - b
        rgb = _cmyk_to_rgb(c, m, y, k.astype(np.int64))
        if mode == "gray":
            from kgtpu_torch.data.bmp import bgr_to_gray
            return bgr_to_gray(rgb[..., ::-1])
        return rgb
    if color == "rgb":
        if mode == "gray":
            return _rgb_to_y(*planes)
        return np.stack(planes, axis=-1).astype(np.uint8)
    return _ycc_to_rgb(*planes)
