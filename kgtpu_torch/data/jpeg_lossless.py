"""Lossless JPEG (SOF3, Huffman-coded), as libjpeg-turbo 3.1 decodes it:
`jdlhuff.c` for the differences, `jdlossls.c` for the prediction and the
point transform, `jddiffct.c` for restarts.

  * A difference is a DC-style Huffman symbol s (0-16) and s magnitude
    bits; s = 16 means 32768, with no bits.
  * Samples are undifferenced modulo 2^16 row by row.  The first row of the
    scan, and of each restart interval, predicts its first sample by
    2^(P - Pt - 1) and the others from the left; every later row predicts
    its first sample from above and the others with the scan's predictor:
    1 Ra, 2 Rb, 3 Rc, 4 Ra + Rb - Rc, 5 Ra + ((Rb - Rc) >> 1),
    6 Rb + ((Ra - Rc) >> 1), 7 (Ra + Rb) >> 1 (Ra left, Rb above, Rc above
    left; arithmetic shifts).
  * Restarts come in whole MCU rows: every restart_interval / MCUs-per-row
    rows, as jddiffct.c counts them.
  * Data that runs out (a marker, or the end of the file) reads as zero
    bits to the end of the MCU row; every later MCU row of the interval is
    left zero and predicted as a first row (`jdlhuff.c`'s
    insufficient_data), so it comes out as 2^(P - Pt - 1) << Pt; the state
    carries into an interval whose RSTn never came, as in `data/jpeg.py`.
  * The output sample is (value << Pt) cut to 8 bits.
An interleaved scan codes the samples of MCUs padded to the sampling
factors; the padding samples are decoded and not used.
"""

from __future__ import annotations

import numpy as np

from kgtpu_torch.data.imread import UnreadableImage
from kgtpu_torch.data.jpeg import _bits, _decode, _extend, _windows, restart_data


def _order(comps, scomps, frame) -> list[tuple[int, int, int]]:
    """(component index, row, column) of each sample in coding order."""
    if len(scomps) == 1:
        c = comps[scomps[0]]
        return [(scomps[0], r, x) for r in range(c.blocks_h) for x in range(c.blocks_w)]
    out = []
    for my in range(frame["mcu_rows"]):
        for mx in range(frame["mcu_cols"]):
            for ci in scomps:
                c = comps[ci]
                for v in range(c.v):
                    for h in range(c.h):
                        out.append((ci, my * c.v + v, mx * c.h + h))
    return out


def intervals(comps, scomps, frame, restart) -> int:
    """The number of restart intervals of a lossless scan."""
    single = len(scomps) == 1
    mcus_per_row = comps[scomps[0]].blocks_w if single else frame["mcu_cols"]
    rows = comps[scomps[0]].blocks_h if single else frame["mcu_rows"]
    per = max(restart // mcus_per_row, 1) if restart else rows
    return -(-rows // per)


def decode_lossless_scan(marked, comps, scomps, dc_tabs, frame, restart, predictor,
                         pt) -> None:
    """Decode one lossless scan (`marked`: `jpeg._segments`' data) into
    `comp.samples` ([blocks_h, blocks_w] int64, before the point transform)
    of each of its components."""
    if not 1 <= predictor <= 7 or pt >= 8:
        raise UnreadableImage(f"lossless JPEG predictor {predictor}, point transform {pt}")
    single = len(scomps) == 1
    mcus_per_row = comps[scomps[0]].blocks_w if single else frame["mcu_cols"]
    if restart % mcus_per_row:          # jddiffct.c: whole MCU rows only
        raise UnreadableImage(f"lossless JPEG restart interval {restart} is not a multiple "
                              f"of its {mcus_per_row} MCUs a row")
    per_mcu = 1 if single else sum(comps[ci].h * comps[ci].v for ci in scomps)
    order = _order(comps, scomps, frame)
    rows_per_interval = (restart // mcus_per_row) if restart else 0
    row_len = mcus_per_row * per_mcu
    interval = (rows_per_interval or 1) * row_len if restart else len(order)
    shape = {ci: (comps[ci].grid_h if not single else comps[ci].blocks_h,
                  comps[ci].grid_w if not single else comps[ci].blocks_w) for ci in scomps}
    diffs = {ci: np.zeros(shape[ci], np.int64) for ci in scomps}
    first = {ci: set() for ci in scomps}
    segs = restart_data(marked, -(-len(order) // interval))
    short = False
    for k, start in enumerate(range(0, len(order), interval)):
        seg = segs[k]                                  # None: left without data
        short = short and seg is None
        chunk = order[start:start + interval]
        W = _windows(seg or b"") + [0] * (4 * len(chunk))
        limit, p = 8 * len(seg or b""), 0
        for row in range(0, len(chunk), row_len):
            samples = chunk[row:row + row_len]
            if short or row == 0:
                # the interval's first MCU row, and every MCU row after the data
                # ran short (left zero), restart the prediction
                for ci, r, _ in samples:
                    first[ci].add(r)
            if short:
                continue
            for ci, r, x in samples:
                dsym, dcoef = dc_tabs[ci]
                e = dcoef[((W[p >> 3] << (p & 7)) >> 8) & 0xFFFF]
                if e is not None:
                    p += e[0]
                    diff = e[2]
                else:
                    s, p = _decode(W, p, dsym)
                    if s == 16:
                        diff = 32768
                    else:
                        diff = _extend(_bits(W, p, s), s)
                        p += s
                diffs[ci][r, x] = diff
            short = p > limit
    for ci in scomps:
        c = comps[ci]
        v = 1 if single else c.v
        rows = {r for r in first[ci] if r % v == 0}
        c.pt = pt
        c.samples = _undifference(diffs[ci][:c.blocks_h, :c.blocks_w], predictor, pt, rows)


def _undifference(d: np.ndarray, predictor: int, pt: int, first_rows: set) -> np.ndarray:
    h, w = d.shape
    out = np.zeros((h, w), np.int64)
    init = 1 << (8 - pt - 1)
    for r in range(h):
        row = d[r]
        if r in first_rows:
            row = row.copy()
            row[0] += init
            out[r] = np.cumsum(row) & 0xFFFF
            continue
        above = out[r - 1]
        if predictor == 1:
            row = row.copy()
            row[0] += above[0]
            out[r] = np.cumsum(row) & 0xFFFF
        elif predictor == 2:
            out[r] = (row + above) & 0xFFFF
        elif predictor == 3:
            out[r, 0] = (row[0] + above[0]) & 0xFFFF
            out[r, 1:] = (row[1:] + above[:-1]) & 0xFFFF
        else:
            rb = above.tolist()
            dv = row.tolist()
            ra = (dv[0] + rb[0]) & 0xFFFF
            res = [ra]
            for x in range(1, w):
                b, c = rb[x], rb[x - 1]
                if predictor == 4:
                    pred = ra + b - c
                elif predictor == 5:
                    pred = ra + ((b - c) >> 1)
                elif predictor == 6:
                    pred = b + ((ra - c) >> 1)
                else:
                    pred = (ra + b) >> 1
                ra = (dv[x] + pred) & 0xFFFF
                res.append(ra)
            out[r] = res
    return out
