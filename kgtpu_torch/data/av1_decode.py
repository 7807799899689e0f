"""AV1 intra frame decoding (specification section 7): the frame's state,
its tiles decoded one after another with their own CDF copies
(`av1_block.TileDecoder`, which also reads the loop restoration units),
then decode_frame_wrapup's post-filters in the specification's order:
deblocking (`av1_deblock`), CDEF (`av1_cdef`), superres (`av1_superres`:
the CDEF frame, and the deblocked frame where loop restoration reads it)
and loop restoration (`av1_restoration`), and the planes cut to the
frame's (upscaled) size.

`decode_av1(data)` takes the OBUs of one AVIF item and returns
(SequenceHeader, FrameHeader, planes): planes a list of [H, W] int32
arrays, Y then U, V (one plane for monochrome).  A frame that needs a
filter still queued (`av1_obu.post_filters`: film grain) raises
`UnsupportedImage` naming it, before its tiles are decoded.
"""

from __future__ import annotations

import numpy as np

from kgtpu_torch.data.av1_block import TileDecoder
from kgtpu_torch.data.av1_cdef import cdef
from kgtpu_torch.data.av1_deblock import deblock
from kgtpu_torch.data.av1_obu import RESTORE_NONE, parse_frame, post_filters
from kgtpu_torch.data.av1_restoration import restore, unit_count
from kgtpu_torch.data.av1_superres import upscale
from kgtpu_torch.data.av1_symbol import SymbolReader, icdf
from kgtpu_torch.data.av1_tables import CDF_COEF, CDF_MODE, CDF_MV
from kgtpu_torch.data.imread import CONTAINERS, unsupported

_TEMPLATE: dict = {}
# the post-filters decode_av1 applies, in this order
PORTED = ("deblocking", "CDEF", "superres", "loop restoration")


def _inverted(x):
    if x and isinstance(x[0], int):
        return icdf(x)
    return [_inverted(v) for v in x]


def _copy(x):
    if x and isinstance(x[0], int):
        return x[:]
    return [_copy(v) for v in x]


def _template(qctx: int) -> dict:
    if qctx not in _TEMPLATE:
        t = {k: _inverted(v) for k, v in CDF_MODE.items()}
        t.update({"mv_" + k if k == "joints" else k: _inverted(v) for k, v in CDF_MV.items()})
        t.update({k: _inverted(v[qctx]) for k, v in CDF_COEF.items()})
        _TEMPLATE[qctx] = t
    return _TEMPLATE[qctx]


class Frame:
    """The state one frame's tiles share: planes, the per-position block
    grid, transform sizes and types, and the coefficient contexts."""

    def __init__(self, seq, fh):
        self.seq, self.fh = seq, fh
        self.bit_depth = seq.bit_depth
        self.ssx, self.ssy = seq.ssx, seq.ssy
        rows = ((fh.mi_rows + 31) & ~31) + 32
        cols = ((fh.mi_cols + 31) & ~31) + 32
        self.planes = []
        for p in range(seq.num_planes):
            sx = self.ssx if p else 0
            sy = self.ssy if p else 0
            self.planes.append(np.zeros(((rows * 4) >> sy, (cols * 4) >> sx), np.int32))
        self.mi = [[None] * fh.mi_cols for _ in range(fh.mi_rows)]
        # what the in-loop filters read: per 4x4 of each plane its transform
        # size (LoopfilterTxSizes), per 4x4 of luma the segment, skip flag and
        # loop filter deltas, per 64x64 the CDEF index (-1: none read)
        self.lf_tx = [np.zeros((p.shape[0] >> 2, p.shape[1] >> 2), np.int8) for p in self.planes]
        self.seg_ids = np.zeros((fh.mi_rows, fh.mi_cols), np.int8)
        self.skips = np.zeros((fh.mi_rows, fh.mi_cols), bool)
        self.delta_lfs = np.zeros((fh.mi_rows, fh.mi_cols, 4), np.int8)
        self.cdef_idx = np.full((rows >> 4, cols >> 4), -1, np.int8)
        self.inter_tx = [[0] * cols for _ in range(rows)]
        self.tx_types = [[0] * cols for _ in range(rows)]
        self.above_level = [[0] * (cols + 32) for _ in range(3)]
        self.above_dc = [[0] * (cols + 32) for _ in range(3)]
        self.left_level = [[0] * (rows + 32) for _ in range(3)]
        self.left_dc = [[0] * (rows + 32) for _ in range(3)]
        # the loop restoration units of each plane (5.11.57-58; a plane that
        # does not restore keeps an empty grid): LrType, LrWiener [pass][tap],
        # LrSgrSet and LrSgrXqd
        self.lr_types, self.lr_wiener, self.lr_sgr_set, self.lr_sgr_xqd = [], [], [], []
        for p in range(seq.num_planes):
            sx = self.ssx if p else 0
            sy = self.ssy if p else 0
            shape = (0, 0)
            if fh.lr_type[p] != RESTORE_NONE:
                shape = (unit_count(fh.lr_unit_size[p], (fh.height + sy) >> sy),
                         unit_count(fh.lr_unit_size[p], (fh.upscaled_width + sx) >> sx))
            self.lr_types.append(np.zeros(shape, np.int8))
            self.lr_wiener.append(np.zeros(shape + (2, 3), np.int64))
            self.lr_sgr_set.append(np.zeros(shape, np.int64))
            self.lr_sgr_xqd.append(np.zeros(shape + (2,), np.int64))
        q = fh.base_q_idx
        self.qctx = 0 if q <= 20 else 1 if q <= 60 else 2 if q <= 120 else 3

    def new_cdfs(self) -> dict:
        return {k: _copy(v) for k, v in _template(self.qctx).items()}


def decode_av1(data: bytes):
    seq, fh, tiles = parse_frame(data)
    need = post_filters(fh)
    queued = [f for f in need if f not in PORTED]
    if queued:
        raise unsupported(f"AVIF whose AV1 frame needs {', '.join(queued)}", CONTAINERS)
    fr = Frame(seq, fh)
    for tile_row, tile_col, start, end in tiles:
        rd = SymbolReader(data, start, end, bool(fh.disable_cdf_update))
        TileDecoder(fr, tile_row, tile_col, rd).decode()
    if "deblocking" in need:
        deblock(fr)
    deblocked = planes = fr.planes
    if "CDEF" in need:
        planes = cdef(fr)
    restoring = "loop restoration" in need
    if "superres" in need:
        up_planes = [upscale(pl, fr, p) for p, pl in enumerate(planes)]
        if restoring and planes is not deblocked:
            deblocked = [upscale(pl, fr, p) for p, pl in enumerate(deblocked)]
        else:
            deblocked = up_planes
        planes = up_planes
    if restoring:
        planes = restore(fr, planes, deblocked)
    out = []
    for p, plane in enumerate(planes):
        sx = fr.ssx if p else 0
        sy = fr.ssy if p else 0
        out.append(plane[:(fh.height + sy) >> sy, :(fh.upscaled_width + sx) >> sx]
                   .astype(np.int32))
    return seq, fh, out
