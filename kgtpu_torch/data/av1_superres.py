"""AV1's super-resolution upscaling (specification section 7.16), as libaom
3.14's decoder applies it to a whole frame.

A frame coded with superres is decoded, deblocked and CDEF-filtered at its
downscaled width (FrameWidth); each plane is then widened row by row to
its upscaled width with the 8-tap, 64-phase Upscale_Filter.  Output column
x samples the downscaled row at position initialSubpelX + x * stepX (in
1/16384 of a sample), the taps clamped to the decoded area's last column
((MiCols * 4 >> subsampling) - 1; libaom pads the last tile column there),
each sum rounded by 7 bits and clipped to the bit depth.  libaom upscales
tile column by tile column, carrying the position from one to the next, so
its rows equal one pass over the whole row.

`upscale(plane, frame, p)` widens one plane; `av1_decode` runs it on the
CDEF frame and, where loop restoration reads them, on the deblocked rows.
Every row is done at once: the taps of all output columns are gathered in
one int64 array.
"""

from __future__ import annotations

import numpy as np

from kgtpu_torch.data.av1_tables import UPSCALE_FILTER

SCALE_BITS = 14
EXTRA_BITS = SCALE_BITS - 6
SCALE_MASK = (1 << SCALE_BITS) - 1
FILTER = np.array(UPSCALE_FILTER, np.int64)


def _cdiv(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def steps(down_w: int, up_w: int) -> tuple[int, int]:
    """(initialSubpelX, stepX) of 7.16 for a plane row of down_w samples
    widened to up_w (libaom's get_upscale_convolve_x0 and
    av1_get_upscale_convolve_step)."""
    step = ((down_w << SCALE_BITS) + up_w // 2) // up_w
    err = up_w * step - (down_w << SCALE_BITS)
    x0 = _cdiv(-((up_w - down_w) << (SCALE_BITS - 1)) + up_w // 2, up_w) + \
        (1 << (EXTRA_BITS - 1)) - _cdiv(err, 2)
    return x0 & SCALE_MASK, step


def upscale_rows(rows: np.ndarray, down_w: int, up_w: int, last_x: int,
                 bit_depth: int) -> np.ndarray:
    """7.16 on [H, >= last_x + 1] rows whose plane is down_w samples wide:
    the [H, up_w] upscaled rows (int64)."""
    x0, step = steps(down_w, up_w)
    pos = -(1 << SCALE_BITS) + x0 + np.arange(up_w, dtype=np.int64) * step
    phase = (pos & SCALE_MASK) >> EXTRA_BITS
    cols = np.clip((pos >> SCALE_BITS)[:, None] + np.arange(-3, 5), 0, last_x)
    taps = rows.astype(np.int64)[:, cols]  # [H, up_w, 8]
    total = np.einsum("hxk,xk->hx", taps, FILTER[phase])
    return np.clip((total + 64) >> 7, 0, (1 << bit_depth) - 1)


def upscale(plane: np.ndarray, fr, p: int) -> np.ndarray:
    """Plane `p` of a downscaled frame (`av1_decode.Frame`'s layout) widened
    to the frame's upscaled width: [Round2(FrameHeight, ssy),
    Round2(UpscaledWidth, ssx)] int64."""
    fh = fr.fh
    sx = fr.ssx if p else 0
    sy = fr.ssy if p else 0
    h = (fh.height + sy) >> sy
    return upscale_rows(plane[:h], (fh.width + sx) >> sx, (fh.upscaled_width + sx) >> sx,
                        ((fh.mi_cols * 4) >> sx) - 1, fr.bit_depth)
