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


def _plane(comp, frame: dict) -> np.ndarray:
    """A component's samples over its own downsampled size."""
    blocks = idct_islow(comp.coefficients(), comp.quant)       # [gh, gw, 8, 8]
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


def upsample(plane: np.ndarray, h: int, v: int, hmax: int, vmax: int) -> np.ndarray:
    """One component's plane up to the frame's sampling, as libjpeg's
    upsampler for that ratio does it (uncropped)."""
    x = plane.astype(np.int64)
    dw = x.shape[1]
    if (h, v) == (hmax, vmax):
        return x
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
    frame = {"width": img["width"], "height": img["height"], "hmax": hmax, "vmax": vmax}
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
        planes.append(upsample(plane, c.h, c.v, hmax, vmax)[:h, :w])
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
