"""AV1 intra-frame block syntax and reconstruction for one tile
(specification sections 5.11 and 7.10-7.13): partitions at 64x64 and
128x128 superblocks with the frame-edge rules, intra_frame_mode_info
(segment ids, skip, CDEF index, delta q / lf, y and uv modes with their
contexts, angle deltas, CfL alphas, palettes with their colour cache and
wavefront colour maps, filter intra), intra block copy (its spatial MV
stack, the default and rounded reference vectors, libaom's validity rules
and the bilinear copy from the frame being decoded), transform sizes
(fixed, selected or split for intra block copy) and types, then each
transform block's prediction, coefficients and residual; before each
superblock, the loop restoration units whose corner it holds (read_lr:
each unit's type, Wiener taps or self-guided set and projection, coded
against the tile's previous unit of its plane).

`TileDecoder(frame, tile_row, tile_col, reader).decode()` decodes one
tile into the frame's planes.  A fault libaom treats as a corrupt tile
raises `UnreadableImage`.
"""

from __future__ import annotations

import numpy as np

from kgtpu_torch.data import av1_coeffs as co
from kgtpu_torch.data.av1_intra import (DC_PRED, SMOOTH_H_PRED, SMOOTH_PRED, SMOOTH_V_PRED,
                                        UV_CFL_PRED, V_PRED, cfl_predict, is_directional,
                                        predict_intra)
from kgtpu_torch.data.av1_obu import (RESTORE_NONE, RESTORE_SGRPROJ, RESTORE_WIENER,
                                      SUPERRES_NUM, qindex)
from kgtpu_torch.data.av1_tables import (AC_QLOOKUP, DC_QLOOKUP, PALETTE_COLOR_CONTEXT,
                                         SGR_PARAMS)
from kgtpu_torch.data.imread import UnreadableImage

# Block sizes (section 6.10.4's order) as (width, height) in pixels.
BLOCKS = [(4, 4), (4, 8), (8, 4), (8, 8), (8, 16), (16, 8), (16, 16), (16, 32), (32, 16),
          (32, 32), (32, 64), (64, 32), (64, 64), (64, 128), (128, 64), (128, 128), (4, 16),
          (16, 4), (8, 32), (32, 8), (16, 64), (64, 16)]
BLOCK_INDEX = {wh: i for i, wh in enumerate(BLOCKS)}
BW = [w for w, _ in BLOCKS]
BH = [h for _, h in BLOCKS]
BW4 = [w >> 2 for w in BW]
BH4 = [h >> 2 for h in BH]
WLOG2 = [(w >> 2).bit_length() - 1 for w in BW]
HLOG2 = [(h >> 2).bit_length() - 1 for h in BH]
BLOCK_4X4, BLOCK_8X8, BLOCK_64X64, BLOCK_128X128 = 0, 3, 12, 15
(PARTITION_NONE, PARTITION_HORZ, PARTITION_VERT, PARTITION_SPLIT, PARTITION_HORZ_A,
 PARTITION_HORZ_B, PARTITION_VERT_A, PARTITION_VERT_B, PARTITION_HORZ_4,
 PARTITION_VERT_4) = range(10)
INTRA_MODE_CONTEXT = (0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0)
FILTER_INTRA_DIR = (DC_PRED, V_PRED, 2, 6, DC_PRED)  # to DC, V, H, D157, DC
TX = co.TX_SIZES
TXW = [w for w, _ in TX]
TXH = [h for _, h in TX]
TX_4X4 = 0
# Tx_Type_*_Inv_Set* (section 6.10.18) and the sets' members.
INTRA_INV = {1: (9, 0, 10, 11, 3, 1, 2), 2: (9, 0, 3, 1, 2)}
INTER_INV = {1: (9, 10, 11, 12, 13, 14, 15, 0, 1, 2, 4, 5, 3, 6, 7, 8),
             2: (9, 10, 11, 0, 1, 2, 4, 5, 3, 6, 7, 8), 3: (9, 0)}
MODE_TO_TXFM = (0, 1, 2, 0, 3, 1, 2, 2, 1, 3, 1, 2, 3, 0)
# the coded ranges and mid values of the Wiener taps (outermost first) and of
# the self-guided projection (section 5.11.58)
WIENER_TAPS_MIN, WIENER_TAPS_MAX, WIENER_TAPS_K = (-5, -23, -17), (10, 8, 46), (1, 2, 3)
WIENER_TAPS_MID = (3, -7, 15)
SGRPROJ_XQD_MIN, SGRPROJ_XQD_MAX, SGRPROJ_XQD_MID = (-96, -32), (31, 95), (-32, 31)
MV_BORDER = 128
INTRABC_DELAY_PIXELS = 256


def _subsize(w: int, h: int) -> int:
    return BLOCK_INDEX.get((w, h), -1)


def partition_subsize(p: int, b: int) -> int:
    s = BW[b]
    return {PARTITION_NONE: b, PARTITION_HORZ: _subsize(s, s // 2),
            PARTITION_VERT: _subsize(s // 2, s), PARTITION_SPLIT: _subsize(s // 2, s // 2),
            PARTITION_HORZ_A: _subsize(s, s // 2), PARTITION_HORZ_B: _subsize(s, s // 2),
            PARTITION_VERT_A: _subsize(s // 2, s), PARTITION_VERT_B: _subsize(s // 2, s),
            PARTITION_HORZ_4: _subsize(s, s // 4), PARTITION_VERT_4: _subsize(s // 4, s)}[p]


def plane_residual_size(b: int, ssx: int, ssy: int) -> int:
    """get_plane_residual_size / ss_size_lookup; -1 where invalid."""
    w, h = BLOCKS[b]
    if (w, h) != (4, 4) and ((ssx and not ssy and w < h) or (ssy and not ssx and w > h)):
        return -1
    return BLOCK_INDEX[(max(4, w >> ssx), max(4, h >> ssy))]


def max_tx_rect(b: int) -> int:
    return co.TX_INDEX[(min(BW[b], 64), min(BH[b], 64))]


def split_tx(t: int) -> int:
    w, h = TX[t]
    if w == h:
        return co.TX_INDEX[(w // 2, h // 2)] if w > 4 else t
    if w == 2 * h or h == 2 * w:
        m = min(w, h)
        return co.TX_INDEX[(m, m)]
    return co.TX_INDEX[(w // 2, h)] if w > h else co.TX_INDEX[(w, h // 2)]


def max_tx_depth(b: int) -> int:
    t, d = max_tx_rect(b), 0
    while t != TX_4X4:
        t = split_tx(t)
        d += 1
    return d


def uv_tx_size(b: int, ssx: int, ssy: int) -> int:
    """get_tx_size for a chroma plane."""
    uv = max_tx_rect(plane_residual_size(b, ssx, ssy))
    w, h = TX[uv]
    if w == 64 or h == 64:
        if w == 16:
            return co.TX_INDEX[(16, 32)]
        if h == 16:
            return co.TX_INDEX[(32, 16)]
        return co.TX_INDEX[(32, 32)]
    return uv


class Block:
    """What later blocks read of a decoded block (the specification's
    per-position arrays YModes, UVModes, IsInters, Skips, MiSizes, ...)."""
    __slots__ = ("size", "ymode", "uvmode", "skip", "is_inter", "seg", "pal", "pal_colors",
                 "mv", "tx")

    def __init__(self):
        self.pal = (0, 0)
        self.pal_colors = ((), ())
        self.mv = (0, 0)


class TileDecoder:
    def __init__(self, fr, tile_row: int, tile_col: int, reader):
        self.fr = fr
        self.s = fr.seq
        self.fh = fr.fh
        self.rd = reader
        self.cdf = fr.new_cdfs()
        fh = self.fh
        self.row_start = fh.mi_row_starts[tile_row]
        self.row_end = fh.mi_row_starts[tile_row + 1]
        self.col_start = fh.mi_col_starts[tile_col]
        self.col_end = fh.mi_col_starts[tile_col + 1]
        self.current_q = fh.base_q_idx
        self.delta_lf = [0, 0, 0, 0]
        self.sb4 = 32 if self.s.use_128 else 16
        self.sb_mask = self.sb4 - 1

    # ----------------------------------------------------------------- tile
    def decode(self) -> None:
        fr, s = self.fr, self.s
        np_ = s.num_planes
        for p in range(np_):
            sx = fr.ssx if p else 0
            lo, hi = self.col_start >> sx, (self.col_end >> sx) + 2
            fr.above_level[p][lo:hi] = [0] * (hi - lo)
            fr.above_dc[p][lo:hi] = [0] * (hi - lo)
        rd = self.rd
        self.ref_wiener = [[list(WIENER_TAPS_MID) for _ in range(2)] for _ in range(np_)]
        self.ref_sgr_xqd = [list(SGRPROJ_XQD_MID) for _ in range(np_)]
        sb = BLOCK_128X128 if s.use_128 else BLOCK_64X64
        lr = any(t != RESTORE_NONE for t in self.fh.lr_type) and not self.fh.allow_intrabc
        for r in range(self.row_start, self.row_end, self.sb4):
            for p in range(np_):
                fr.left_level[p] = [0] * len(fr.left_level[p])
                fr.left_dc[p] = [0] * len(fr.left_dc[p])
            for c in range(self.col_start, self.col_end, self.sb4):
                self.read_deltas = self.fh.delta_q_present
                self._clear_block_decoded(r, c)
                if lr:
                    self.read_lr(r, c, sb)
                self.decode_partition(r, c, sb)
                if rd.overflowed():
                    raise UnreadableImage("AV1 tile data ends early (corrupt tile)")
        if not rd.trailing_ok():
            raise UnreadableImage("AV1 tile padding is not a 1 then zeros (corrupt tile)")

    # ------------------------------------------------- loop restoration units
    def read_lr(self, r: int, c: int, b: int) -> None:
        """read_lr (5.11.57): the restoration units whose top-left corner
        lies in the superblock at (r, c), in each plane that restores."""
        fh, fr = self.fh, self.fr
        for p in range(self.s.num_planes):
            if fh.lr_type[p] == RESTORE_NONE:
                continue
            sx = fr.ssx if p else 0
            sy = fr.ssy if p else 0
            size = fh.lr_unit_size[p]
            rows, cols = fr.lr_types[p].shape
            row0 = (r * (4 >> sy) + size - 1) // size
            row1 = min(rows, ((r + BH4[b]) * (4 >> sy) + size - 1) // size)
            num = (4 >> sx) * fh.superres_denom
            den = size * SUPERRES_NUM
            col0 = (c * num + den - 1) // den
            col1 = min(cols, ((c + BW4[b]) * num + den - 1) // den)
            for ur in range(row0, row1):
                for uc in range(col0, col1):
                    self.read_lr_unit(p, ur, uc)

    def read_lr_unit(self, p: int, ur: int, uc: int) -> None:
        """read_lr_unit (5.11.58): the unit's type and its Wiener taps or
        self-guided set and projection, each coded against the tile's
        previous unit of the plane."""
        fr, rd = self.fr, self.rd
        frame_type = self.fh.lr_type[p]
        if frame_type == RESTORE_WIENER:
            kind = RESTORE_WIENER if rd.symbol(self.cdf["use_wiener"]) else RESTORE_NONE
        elif frame_type == RESTORE_SGRPROJ:
            kind = RESTORE_SGRPROJ if rd.symbol(self.cdf["use_sgrproj"]) else RESTORE_NONE
        else:
            kind = rd.symbol(self.cdf["switchable_restore"])
        fr.lr_types[p][ur, uc] = kind
        if kind == RESTORE_WIENER:
            for pas in range(2):
                ref = self.ref_wiener[p][pas]
                for j in range(1 if p else 0, 3):
                    ref[j] = _subexp_with_ref(rd, WIENER_TAPS_MIN[j], WIENER_TAPS_MAX[j] + 1,
                                              WIENER_TAPS_K[j], ref[j])
                fr.lr_wiener[p][ur, uc, pas] = ref if p == 0 else [0] + ref[1:]
        elif kind == RESTORE_SGRPROJ:
            st = rd.literal(4)
            fr.lr_sgr_set[p][ur, uc] = st
            ref = self.ref_sgr_xqd[p]
            for i in range(2):
                lo, hi = SGRPROJ_XQD_MIN[i], SGRPROJ_XQD_MAX[i]
                if SGR_PARAMS[st][i]:
                    ref[i] = _subexp_with_ref(rd, lo, hi + 1, 4, ref[i])
                else:
                    ref[i] = 0 if i == 0 else min(hi, max(lo, 128 - ref[0]))
            fr.lr_sgr_xqd[p][ur, uc] = ref

    def _clear_block_decoded(self, r: int, c: int) -> None:
        fr = self.fr
        self.decoded = []
        for p in range(self.s.num_planes):
            sx = fr.ssx if p else 0
            sy = fr.ssy if p else 0
            sbw = (self.col_end - c) >> sx
            sbh = (self.row_end - r) >> sy
            n_w = (self.sb4 >> sx) + 2
            n_h = (self.sb4 >> sy) + 2
            # index [y + 1][x + 1] for y, x from -1
            grid = [[0] * (n_w + 1) for _ in range(n_h + 1)]
            for x in range(-1, n_w):
                if x < sbw:
                    grid[0][x + 1] = 1
            for y in range(-1, n_h):
                if y < sbh:
                    grid[y + 1][0] = 1
            grid[(self.sb4 >> sy) + 1][0] = 0
            self.decoded.append(grid)

    def inside(self, r: int, c: int) -> bool:
        return self.col_start <= c < self.col_end and self.row_start <= r < self.row_end

    # ------------------------------------------------------------ partition
    def decode_partition(self, r: int, c: int, b: int) -> None:
        fh, fr = self.fh, self.fr
        if r >= fh.mi_rows or c >= fh.mi_cols:
            return
        avail_u = self.inside(r - 1, c)
        avail_l = self.inside(r, c - 1)
        n4 = BW4[b]
        half = n4 >> 1
        quarter = half >> 1
        has_rows = (r + half) < fh.mi_rows
        has_cols = (c + half) < fh.mi_cols
        if b < BLOCK_8X8:
            part = PARTITION_NONE
        else:
            bsl = WLOG2[b]
            above = avail_u and WLOG2[fr.mi[r - 1][c].size] < bsl
            left = avail_l and HLOG2[fr.mi[r][c - 1].size] < bsl
            ctx = left * 2 + above
            pcdf = self.cdf["partition"][(bsl - 1) * 4 + ctx]
            if has_rows and has_cols:
                part = self.rd.symbol(pcdf)
            elif has_cols or has_rows:
                p = self._gather(pcdf, b, vert_alike=has_cols)
                split = self.rd.symbol([p, 0, 0])
                part = PARTITION_SPLIT if split else (PARTITION_HORZ if has_cols else
                                                      PARTITION_VERT)
            else:
                part = PARTITION_SPLIT
        sub = partition_subsize(part, b)
        split = partition_subsize(PARTITION_SPLIT, b)
        db = self.decode_block
        if part == PARTITION_NONE:
            db(r, c, sub)
        elif part == PARTITION_HORZ:
            db(r, c, sub)
            if has_rows:
                db(r + half, c, sub)
        elif part == PARTITION_VERT:
            db(r, c, sub)
            if has_cols:
                db(r, c + half, sub)
        elif part == PARTITION_SPLIT:
            self.decode_partition(r, c, sub)
            self.decode_partition(r, c + half, sub)
            self.decode_partition(r + half, c, sub)
            self.decode_partition(r + half, c + half, sub)
        elif part == PARTITION_HORZ_A:
            db(r, c, split)
            db(r, c + half, split)
            db(r + half, c, sub)
        elif part == PARTITION_HORZ_B:
            db(r, c, sub)
            db(r + half, c, split)
            db(r + half, c + half, split)
        elif part == PARTITION_VERT_A:
            db(r, c, split)
            db(r + half, c, split)
            db(r, c + half, sub)
        elif part == PARTITION_VERT_B:
            db(r, c, sub)
            db(r, c + half, split)
            db(r + half, c + half, split)
        elif part == PARTITION_HORZ_4:
            for k in range(4):
                if k < 3 or r + quarter * 3 < fh.mi_rows:
                    db(r + quarter * k, c, sub)
        else:
            for k in range(4):
                if k < 3 or c + quarter * 3 < fh.mi_cols:
                    db(r, c + quarter * k, sub)

    @staticmethod
    def _gather(icdf: list, b: int, vert_alike: bool) -> int:
        """The probability (x 32768) of the split-like partitions that the
        one-symbol split_or_horz / split_or_vert reads (libaom's
        partition_gather_vert_alike / horz_alike)."""
        def prob(e):
            return (32768 if e == 0 else icdf[e - 1]) - icdf[e]
        if vert_alike:
            parts = [PARTITION_VERT, PARTITION_SPLIT, PARTITION_HORZ_A, PARTITION_VERT_A,
                     PARTITION_VERT_B]
            extra = PARTITION_VERT_4
        else:
            parts = [PARTITION_HORZ, PARTITION_SPLIT, PARTITION_HORZ_A, PARTITION_HORZ_B,
                     PARTITION_VERT_A]
            extra = PARTITION_HORZ_4
        if b != BLOCK_128X128:
            parts.append(extra)
        return sum(prob(e) for e in parts)

    # ---------------------------------------------------------------- block
    def decode_block(self, r: int, c: int, b: int) -> None:
        fr, fh, s = self.fr, self.fh, self.s
        if plane_residual_size(b, fr.ssx, fr.ssy) < 0 and s.num_planes > 1:
            raise UnreadableImage("AV1 block size invalid for the chroma subsampling")
        self.mi_row, self.mi_col, self.mi_size = r, c, b
        bw4, bh4 = BW4[b], BH4[b]
        if s.num_planes == 1:
            has_chroma = False
        elif bh4 == 1 and fr.ssy and (r & 1) == 0:
            has_chroma = False
        elif bw4 == 1 and fr.ssx and (c & 1) == 0:
            has_chroma = False
        else:
            has_chroma = True
        self.has_chroma = has_chroma
        self.avail_u = self.inside(r - 1, c)
        self.avail_l = self.inside(r, c - 1)
        self.avail_u_chroma = self.avail_l_chroma = False
        if has_chroma:
            self.avail_u_chroma = self.avail_u
            self.avail_l_chroma = self.avail_l
            if fr.ssy and bh4 == 1:
                self.avail_u_chroma = self.inside(r - 2, c)
            if fr.ssx and bw4 == 1:
                self.avail_l_chroma = self.inside(r, c - 2)
        blk = Block()
        blk.size = b
        self.blk = blk
        self.mode_info(blk)
        self.palette_tokens(blk)
        self.read_block_tx_size(blk)
        if blk.skip:
            self.reset_block_context(bw4, bh4)
        rows = fr.mi
        c1 = min(c + bw4, fh.mi_cols)
        r1 = min(r + bh4, fh.mi_rows)
        for y in range(r, r1):
            rows[y][c:c1] = [blk] * (c1 - c)
        fr.seg_ids[r:r1, c:c1] = blk.seg
        fr.skips[r:r1, c:c1] = blk.skip
        if fh.delta_lf_present:
            fr.delta_lfs[r:r1, c:c1] = self.delta_lf
        self.compute_prediction(blk)
        self.residual(blk)

    # ------------------------------------------------------------ mode info
    def mode_info(self, blk: Block) -> None:
        fh, s, rd, cdf = self.fh, self.s, self.rd, self.cdf
        r, c = self.mi_row, self.mi_col
        mi = self.fr.mi
        blk.seg = 0
        if fh.seg_id_pre_skip:
            self.intra_segment_id(blk, 0)
        blk.skip = 0
        if fh.seg_id_pre_skip and fh.seg_enabled and fh.feature_enabled[blk.seg][6]:
            blk.skip = 1
        else:
            ctx = 0
            if self.avail_u:
                ctx += mi[r - 1][c].skip
            if self.avail_l:
                ctx += mi[r][c - 1].skip
            blk.skip = rd.symbol(cdf["skip"][ctx])
        if not fh.seg_id_pre_skip:
            self.intra_segment_id(blk, blk.skip)
        self.lossless = fh.lossless[blk.seg]
        self.read_cdef(blk)
        self.read_delta_qindex(blk)
        self.read_delta_lf(blk)
        self.read_deltas = 0
        blk.is_inter = 0
        self.use_filter_intra = 0
        self.filter_intra_mode = -1
        self.angle_y = self.angle_uv = 0
        self.cfl_u = self.cfl_v = 0
        use_intrabc = rd.symbol(cdf["intrabc"]) if fh.allow_intrabc else 0
        if use_intrabc:
            blk.is_inter = 1
            blk.ymode = DC_PRED
            blk.uvmode = DC_PRED
            self.intrabc_mv(blk)
            return
        above = mi[r - 1][c].ymode if self.avail_u else DC_PRED
        left = mi[r][c - 1].ymode if self.avail_l else DC_PRED
        blk.ymode = rd.symbol(cdf["kf_y_mode"][INTRA_MODE_CONTEXT[above]]
                              [INTRA_MODE_CONTEXT[left]])
        b = self.mi_size
        if b >= BLOCK_8X8 and is_directional(blk.ymode):
            self.angle_y = rd.symbol(cdf["angle_delta"][blk.ymode - V_PRED]) - 3
        blk.uvmode = DC_PRED
        if self.has_chroma:
            if self.lossless and plane_residual_size(b, self.fr.ssx, self.fr.ssy) == BLOCK_4X4:
                cfl_allowed = 1
            elif not self.lossless and max(BW[b], BH[b]) <= 32:
                cfl_allowed = 1
            else:
                cfl_allowed = 0
            blk.uvmode = rd.symbol(cdf["uv_mode"][cfl_allowed][blk.ymode])
            if blk.uvmode == UV_CFL_PRED:
                self.read_cfl_alphas()
            if b >= BLOCK_8X8 and is_directional(blk.uvmode):
                self.angle_uv = rd.symbol(cdf["angle_delta"][blk.uvmode - V_PRED]) - 3
        if (b >= BLOCK_8X8 and BW[b] <= 64 and BH[b] <= 64
                and fh.allow_screen_content_tools):
            self.palette_mode_info(blk)
        if (s.enable_filter_intra and blk.ymode == DC_PRED and blk.pal[0] == 0
                and max(BW[b], BH[b]) <= 32):
            self.use_filter_intra = rd.symbol(cdf["use_filter_intra"][b])
            if self.use_filter_intra:
                self.filter_intra_mode = rd.symbol(cdf["filter_intra_mode"])

    def intra_segment_id(self, blk: Block, skip: int) -> None:
        fh = self.fh
        if not fh.seg_enabled:
            blk.seg = 0
            return
        r, c = self.mi_row, self.mi_col
        mi = self.fr.mi
        prev_ul = mi[r - 1][c - 1].seg if self.avail_u and self.avail_l else -1
        prev_u = mi[r - 1][c].seg if self.avail_u else -1
        prev_l = mi[r][c - 1].seg if self.avail_l else -1
        if prev_u == -1:
            pred = 0 if prev_l == -1 else prev_l
        elif prev_l == -1:
            pred = prev_u
        else:
            pred = prev_u if prev_ul == prev_u else prev_l
        if skip:
            blk.seg = pred
            return
        if prev_ul < 0:
            ctx = 0
        elif prev_ul == prev_u and prev_ul == prev_l:
            ctx = 2
        elif prev_ul == prev_u or prev_ul == prev_l or prev_u == prev_l:
            ctx = 1
        else:
            ctx = 0
        v = self.rd.symbol(self.cdf["segment_id"][ctx])
        mx = fh.last_active_seg_id + 1
        v = _neg_deinterleave(v, pred, mx)
        blk.seg = max(0, min(fh.last_active_seg_id, v))

    def read_cdef(self, blk: Block) -> None:
        fh = self.fh
        if blk.skip or fh.coded_lossless or not self.s.enable_cdef or fh.allow_intrabc:
            return
        idx = self.fr.cdef_idx
        r, c = self.mi_row >> 4, self.mi_col >> 4
        if idx[r, c] == -1:
            # every 64x64 the block covers (two or four for a 128-wide one)
            idx[r:r + max(1, BH4[self.mi_size] >> 4),
                c:c + max(1, BW4[self.mi_size] >> 4)] = self.rd.literal(fh.cdef_bits)

    def read_delta_qindex(self, blk: Block) -> None:
        sb = BLOCK_128X128 if self.s.use_128 else BLOCK_64X64
        if self.mi_size == sb and blk.skip:
            return
        if self.read_deltas:
            rd = self.rd
            a = rd.symbol(self.cdf["delta_q"])
            if a == 3:
                n = rd.literal(3) + 1
                a = rd.literal(n) + (1 << n) + 1
            if a:
                v = -a if rd.literal(1) else a
                self.current_q = max(1, min(255, self.current_q + (v << self.fh.delta_q_res)))

    def read_delta_lf(self, blk: Block) -> None:
        fh = self.fh
        sb = BLOCK_128X128 if self.s.use_128 else BLOCK_64X64
        if self.mi_size == sb and blk.skip:
            return
        if self.read_deltas and fh.delta_lf_present:
            rd = self.rd
            count = 1
            if fh.delta_lf_multi:
                count = 4 if self.s.num_planes > 1 else 2
            for i in range(count):
                cdf = self.cdf["delta_lf_multi"][i] if fh.delta_lf_multi else self.cdf["delta_lf"]
                a = rd.symbol(cdf)
                if a == 3:
                    n = rd.literal(3) + 1
                    a = rd.literal(n) + (1 << n) + 1
                if a:
                    v = -a if rd.literal(1) else a
                    self.delta_lf[i] = max(-63, min(63, self.delta_lf[i] + (v << fh.delta_lf_res)))

    def read_cfl_alphas(self) -> None:
        rd, cdf = self.rd, self.cdf
        signs = rd.symbol(cdf["cfl_sign"])
        su, sv = (signs + 1) // 3, (signs + 1) % 3
        self.cfl_u = self.cfl_v = 0
        if su:
            a = rd.symbol(cdf["cfl_alpha"][(su - 1) * 3 + sv]) + 1
            self.cfl_u = -a if su == 1 else a
        if sv:
            a = rd.symbol(cdf["cfl_alpha"][(sv - 1) * 3 + su]) + 1
            self.cfl_v = -a if sv == 1 else a

    # -------------------------------------------------------------- palette
    def palette_mode_info(self, blk: Block) -> None:
        rd, cdf, fr = self.rd, self.cdf, self.fr
        r, c, b = self.mi_row, self.mi_col, self.mi_size
        mi = fr.mi
        bd = fr.bit_depth
        bctx = WLOG2[b] + HLOG2[b] - 2
        ysize = uvsize = 0
        ycol, ucol, vcol = (), (), ()
        if blk.ymode == DC_PRED:
            ctx = 0
            if self.avail_u and mi[r - 1][c].pal[0] > 0:
                ctx += 1
            if self.avail_l and mi[r][c - 1].pal[0] > 0:
                ctx += 1
            if rd.symbol(cdf["palette_y_mode"][bctx][ctx]):
                ysize = rd.symbol(cdf["palette_y_size"][bctx]) + 2
                ycol = self._palette_colors(0, ysize, bd, delta_plus=1)
        if self.has_chroma and blk.uvmode == DC_PRED:
            if rd.symbol(cdf["palette_uv_mode"][1 if ysize > 0 else 0]):
                uvsize = rd.symbol(cdf["palette_uv_size"][bctx]) + 2
                ucol = self._palette_colors(1, uvsize, bd, delta_plus=0)
                if rd.literal(1):  # delta_encode_palette_colors_v
                    bits = bd - 4 + rd.literal(2)
                    maxv = 1 << bd
                    vc = [rd.literal(bd)]
                    for _ in range(1, uvsize):
                        d = rd.literal(bits)
                        if d and rd.literal(1):
                            d = -d
                        v = vc[-1] + d
                        if v < 0:
                            v += maxv
                        if v >= maxv:
                            v -= maxv
                        vc.append(min(max(v, 0), maxv - 1))
                    vcol = tuple(vc)
                else:
                    vcol = tuple(rd.literal(bd) for _ in range(uvsize))
        blk.pal = (ysize, uvsize)
        blk.pal_colors = (ycol, ucol)
        self.pal_v = vcol

    def _palette_colors(self, plane: int, n: int, bd: int, delta_plus: int) -> tuple:
        rd = self.rd
        cache = self._palette_cache(plane)
        cols = []
        for v in cache:
            if len(cols) >= n:
                break
            if rd.literal(1):
                cols.append(v)
        if len(cols) < n:
            lits = [rd.literal(bd)]
            if len(cols) + 1 < n:
                bits = bd - 3 + rd.literal(2)
                rng = (1 << bd) - lits[0] - delta_plus
                while len(cols) + len(lits) < n:
                    d = rd.literal(bits) + delta_plus
                    v = min(lits[-1] + d, (1 << bd) - 1)
                    rng -= v - lits[-1]
                    lits.append(v)
                    bits = min(bits, _ceil_log2(rng))
            cols += lits
        return tuple(sorted(cols))

    def _palette_cache(self, plane: int) -> list:
        r, c = self.mi_row, self.mi_col
        mi = self.fr.mi
        above = []
        if (r * 4) % 64 and self.avail_u:
            nb = mi[r - 1][c]
            above = list(nb.pal_colors[plane][:nb.pal[plane]])
        left = []
        if self.avail_l:
            nb = mi[r][c - 1]
            left = list(nb.pal_colors[plane][:nb.pal[plane]])
        out: list = []
        ai = li = 0
        while ai < len(above) and li < len(left):
            a, lv = above[ai], left[li]
            if lv < a:
                if not out or lv != out[-1]:
                    out.append(lv)
                li += 1
            else:
                if not out or a != out[-1]:
                    out.append(a)
                ai += 1
                if lv == a:
                    li += 1
        for v in above[ai:] + left[li:]:
            if not out or v != out[-1]:
                out.append(v)
        return out

    def palette_tokens(self, blk: Block) -> None:
        fh, fr = self.fh, self.fr
        b = self.mi_size
        bw, bh = BW[b], BH[b]
        on_h = min(bh, (fh.mi_rows - self.mi_row) * 4)
        on_w = min(bw, (fh.mi_cols - self.mi_col) * 4)
        self.color_map = [None, None]
        if blk.pal[0]:
            self.color_map[0] = self._color_map(blk.pal[0], bw, bh, on_w, on_h, "palette_y_color")
        if blk.pal[1]:
            bw >>= fr.ssx
            bh >>= fr.ssy
            on_w >>= fr.ssx
            on_h >>= fr.ssy
            if bw < 4:
                bw += 2
                on_w += 2
            if bh < 4:
                bh += 2
                on_h += 2
            self.color_map[1] = self._color_map(blk.pal[1], bw, bh, on_w, on_h,
                                                "palette_uv_color")

    def _color_map(self, n: int, bw: int, bh: int, on_w: int, on_h: int, name: str):
        rd = self.rd
        cdfs = self.cdf[name][n - 2]
        m = np.zeros((bh, bw), np.int64)
        rows = [[0] * on_w for _ in range(on_h)]
        rows[0][0] = _ns_literal(rd, n)
        for i in range(1, on_h + on_w - 1):
            for j in range(min(i, on_w - 1), max(0, i - on_h + 1) - 1, -1):
                rr = i - j
                scores = [0] * 8
                if j > 0:
                    scores[rows[rr][j - 1]] += 2
                if rr > 0 and j > 0:
                    scores[rows[rr - 1][j - 1]] += 1
                if rr > 0:
                    scores[rows[rr - 1][j]] += 2
                order = list(range(8))
                for k in range(3):
                    best, bi = scores[k], k
                    for q in range(k + 1, n):
                        if scores[q] > best:
                            best, bi = scores[q], q
                    if bi != k:
                        sc, oc = scores[bi], order[bi]
                        for q in range(bi, k, -1):
                            scores[q] = scores[q - 1]
                            order[q] = order[q - 1]
                        scores[k], order[k] = sc, oc
                hsh = scores[0] + 2 * scores[1] + 2 * scores[2]
                ctx = PALETTE_COLOR_CONTEXT[hsh]
                rows[rr][j] = order[rd.symbol(cdfs[ctx])]
        m[:on_h, :on_w] = np.array(rows, np.int64)
        if on_w < bw:
            m[:on_h, on_w:] = m[:on_h, on_w - 1:on_w]
        if on_h < bh:
            m[on_h:, :] = m[on_h - 1:on_h, :]
        return m

    # ---------------------------------------------------------- intra copy
    def intrabc_mv(self, blk: Block) -> None:
        stack = self._mv_stack()
        pred = stack[0] if stack else (0, 0)
        if pred == (0, 0):
            pred = stack[1] if len(stack) > 1 else (0, 0)
        if pred == (0, 0):
            sb4 = self.sb4
            if self.mi_row - sb4 < self.row_start:
                pred = (0, -(sb4 * 4 + INTRABC_DELAY_PIXELS) * 8)
            else:
                pred = (-(sb4 * 4 * 8), 0)
        if pred[0] & 7 or pred[1] & 7:
            raise UnreadableImage("AV1 intra block copy reference vector is not whole")
        pred = ((pred[0] >> 3) * 8, (pred[1] >> 3) * 8)
        rd, cdf = self.rd, self.cdf
        joint = rd.symbol(cdf["mv_joints"])
        d0 = self._mv_component(0) if joint in (2, 3) else 0
        d1 = self._mv_component(1) if joint in (1, 3) else 0
        mv = (pred[0] + d0, pred[1] + d1)
        if not self._dv_valid(mv):
            raise UnreadableImage("AV1 intra block copy vector is not valid (corrupt tile)")
        blk.mv = mv

    def _mv_component(self, comp: int) -> int:
        rd, cdf = self.rd, self.cdf
        pre = f"comp{comp}_"
        sign = rd.symbol(cdf[pre + "sign"])
        cls = rd.symbol(cdf[pre + "classes"])
        if cls == 0:
            bit = rd.symbol(cdf[pre + "class0"])
            mag = ((bit << 3) | (3 << 1) | 1) + 1
        else:
            d = 0
            for i in range(cls):
                d |= rd.symbol(cdf[pre + "bits"][i]) << i
            mag = (2 << (cls + 2)) + ((d << 3) | (3 << 1) | 1) + 1
        return -mag if sign else mag

    def _mv_stack(self) -> list:
        """The MV prediction process (7.10.2) of an intra block copy: the
        spatial candidates only (an intra frame has no temporal ones)."""
        fh = self.fh
        r, c, b = self.mi_row, self.mi_col, self.mi_size
        bw4, bh4 = BW4[b], BH4[b]
        mi = self.fr.mi
        mvs: list = []
        weights: list = []

        def add(mr, mc, weight):
            nb = mi[mr][mc]
            if not nb.is_inter:
                return
            cand = nb.mv
            if cand in mvs:
                weights[mvs.index(cand)] += weight
            elif len(mvs) < 8:
                mvs.append(cand)
                weights.append(weight)

        def scan_row(dr):
            end4 = min(bw4, fh.mi_cols - c, 16)
            dc = 0
            step16 = bw4 >= 16
            if abs(dr) > 1:
                dr += r & 1
                dc = 1 - (c & 1)
            i = 0
            while i < end4:
                mr, mc = r + dr, c + dc + i
                if not self.inside(mr, mc):
                    break
                ln = min(bw4, BW4[mi[mr][mc].size])
                if abs(dr) > 1:
                    ln = max(2, ln)
                if step16:
                    ln = max(4, ln)
                add(mr, mc, 2 * ln)
                i += ln

        def scan_col(dc):
            end4 = min(bh4, fh.mi_rows - r, 16)
            dr = 0
            step16 = bh4 >= 16
            if abs(dc) > 1:
                dr = 1 - (r & 1)
                dc += c & 1
            i = 0
            while i < end4:
                mr, mc = r + dr + i, c + dc
                if not self.inside(mr, mc):
                    break
                ln = min(bh4, BH4[mi[mr][mc].size])
                if abs(dc) > 1:
                    ln = max(2, ln)
                if step16:
                    ln = max(4, ln)
                add(mr, mc, 2 * ln)
                i += ln

        def scan_point(dr, dc):
            mr, mc = r + dr, c + dc
            if self.inside(mr, mc) and mi[mr][mc] is not None:
                add(mr, mc, 4)

        scan_row(-1)
        scan_col(-1)
        if max(bw4, bh4) <= 16:
            scan_point(-1, bw4)
        num_nearest = len(mvs)
        for k in range(num_nearest):
            weights[k] += 640
        scan_point(-1, -1)
        scan_row(-3)
        scan_col(-3)
        if bh4 > 1:
            scan_row(-5)
        if bw4 > 1:
            scan_col(-5)
        order = _stable_sort(weights, 0, num_nearest) + _stable_sort(weights, num_nearest,
                                                                     len(mvs))
        out = []
        for k in order:
            mv0, mv1 = mvs[k]
            top = -(r * 4 * 8)
            bottom = (fh.mi_rows - bh4 - r) * 4 * 8
            left = -(c * 4 * 8)
            right = (fh.mi_cols - bw4 - c) * 4 * 8
            mv0 = max(top - MV_BORDER - bh4 * 32, min(bottom + MV_BORDER + bh4 * 32, mv0))
            mv1 = max(left - MV_BORDER - bw4 * 32, min(right + MV_BORDER + bw4 * 32, mv1))
            out.append((mv0, mv1))
        return out

    def _dv_valid(self, mv: tuple) -> bool:
        """libaom's is_mv_valid and av1_is_dv_valid."""
        if not (-(1 << 14) < mv[0] < (1 << 14) and -(1 << 14) < mv[1] < (1 << 14)):
            return False
        r, c, b = self.mi_row, self.mi_col, self.mi_size
        bw, bh = BW[b], BH[b]
        if mv[0] & 7 or mv[1] & 7:
            return False
        top = r * 32 + mv[0]
        tile_top = self.row_start * 32
        left = c * 32 + mv[1]
        tile_left = self.col_start * 32
        bottom = (r * 4 + bh) * 8 + mv[0]
        right = (c * 4 + bw) * 8 + mv[1]
        if top < tile_top or left < tile_left:
            return False
        if bottom > self.row_end * 32 or right > self.col_end * 32:
            return False
        if self.has_chroma:
            if bw < 8 and self.fr.ssx and left < tile_left + 32:
                return False
            if bh < 8 and self.fr.ssy and top < tile_top + 32:
                return False
        log2 = 5 if self.s.use_128 else 4
        sb_size = (1 << log2) * 4
        active_row = r >> log2
        active_col64 = (c * 4) >> 6
        src_row = ((bottom >> 3) - 1) // sb_size
        src_col64 = ((right >> 3) - 1) >> 6
        per_row = ((self.col_end - self.col_start - 1) >> 4) + 1
        if src_row * per_row + src_col64 >= active_row * per_row + active_col64 - 4:
            return False
        gradient = 1 + 4 + (sb_size > 64)
        wf = gradient * (active_row - src_row)
        if src_row > active_row or src_col64 >= active_col64 - 4 + wf:
            return False
        return True

    # ------------------------------------------------------------- tx size
    def read_block_tx_size(self, blk: Block) -> None:
        fh, fr = self.fh, self.fr
        b = self.mi_size
        r, c = self.mi_row, self.mi_col
        bw4, bh4 = BW4[b], BH4[b]
        itx = fr.inter_tx
        if (fh.tx_mode_select and b > BLOCK_4X4 and blk.is_inter and not blk.skip
                and not self.lossless):
            mt = max_tx_rect(b)
            tw4, th4 = TXW[mt] >> 2, TXH[mt] >> 2
            for y in range(r, r + bh4, th4):
                for x in range(c, c + bw4, tw4):
                    self._var_tx(y, x, mt, 0)
            blk.tx = itx[r][c]
            return
        self.read_tx_size(blk, not blk.skip or not blk.is_inter)
        c1 = min(c + bw4, fh.mi_cols)
        for y in range(r, min(r + bh4, fh.mi_rows)):
            itx[y][c:c1] = [blk.tx] * (c1 - c)

    def read_tx_size(self, blk: Block, allow_select: bool) -> None:
        b = self.mi_size
        if self.lossless:
            blk.tx = TX_4X4
            return
        t = max_tx_rect(b)
        if b > BLOCK_4X4 and allow_select and self.fh.tx_mode_select:
            depth = max_tx_depth(b)
            r, c = self.mi_row, self.mi_col
            mi = self.fr.mi
            if self.avail_u:
                nb = mi[r - 1][c]
                aw = BW[nb.size] if nb.is_inter else self._above_tx_w(r, c)
            else:
                aw = 0
            if self.avail_l:
                nb = mi[r][c - 1]
                lh = BH[nb.size] if nb.is_inter else self._left_tx_h(r, c)
            else:
                lh = 0
            ctx = (aw >= TXW[t]) + (lh >= TXH[t])
            d = self.rd.symbol(self.cdf["tx_depth"][depth - 1][ctx])
            for _ in range(d):
                t = split_tx(t)
        blk.tx = t

    def _above_tx_w(self, row: int, col: int) -> int:
        if row == self.mi_row:
            if not self.avail_u:
                return 64
            nb = self.fr.mi[row - 1][col]
            if nb.skip and nb.is_inter:
                return BW[nb.size]
        return TXW[self.fr.inter_tx[row - 1][col]]

    def _left_tx_h(self, row: int, col: int) -> int:
        if col == self.mi_col:
            if not self.avail_l:
                return 64
            nb = self.fr.mi[row][col - 1]
            if nb.skip and nb.is_inter:
                return BH[nb.size]
        return TXH[self.fr.inter_tx[row][col - 1]]

    def _var_tx(self, row: int, col: int, t: int, depth: int) -> None:
        fh = self.fh
        if row >= fh.mi_rows or col >= fh.mi_cols:
            return
        if t == TX_4X4 or depth == 2:
            split = 0
        else:
            above = self._above_tx_w(row, col) < TXW[t]
            left = self._left_tx_h(row, col) < TXH[t]
            b = self.mi_size
            size = min(64, max(BW[b], BH[b]))
            max_sq = co.TX_INDEX[(size, size)]
            ctx = (co.SQR_UP[t] != max_sq) * 3 + (4 - max_sq) * 6 + above + left
            split = self.rd.symbol(self.cdf["txfm_partition"][ctx])
        w4, h4 = TXW[t] >> 2, TXH[t] >> 2
        if split:
            st = split_tx(t)
            sw, sh = TXW[st] >> 2, TXH[st] >> 2
            for i in range(0, h4, sh):
                for j in range(0, w4, sw):
                    self._var_tx(row + i, col + j, st, depth + 1)
        else:
            itx = self.fr.inter_tx
            c1 = min(col + w4, fh.mi_cols)
            for y in range(row, min(row + h4, fh.mi_rows)):
                itx[y][col:c1] = [t] * (c1 - col)

    def reset_block_context(self, bw4: int, bh4: int) -> None:
        fr = self.fr
        for p in range(1 + 2 * self.has_chroma):
            sx = fr.ssx if p else 0
            sy = fr.ssy if p else 0
            x0, x1 = self.mi_col >> sx, ((self.mi_col + bw4 - 1) >> sx) + 1
            y0, y1 = self.mi_row >> sy, ((self.mi_row + bh4 - 1) >> sy) + 1
            fr.above_level[p][x0:x1] = [0] * (x1 - x0)
            fr.above_dc[p][x0:x1] = [0] * (x1 - x0)
            fr.left_level[p][y0:y1] = [0] * (y1 - y0)
            fr.left_dc[p][y0:y1] = [0] * (y1 - y0)

    # ----------------------------------------------------------- prediction
    def compute_prediction(self, blk: Block) -> None:
        """The intra block copy's prediction (7.11.3 with the frame itself
        as the reference, BILINEAR filters, integer vectors)."""
        if not blk.is_inter:
            return
        fr = self.fr
        b = self.mi_size
        for p in range(1 + 2 * self.has_chroma):
            sx = fr.ssx if p else 0
            sy = fr.ssy if p else 0
            psz = plane_residual_size(b, sx, sy)
            w, h = BW[psz], BH[psz]
            x = (self.mi_col >> sx) * 4
            y = (self.mi_row >> sy) * 4
            frame = fr.planes[p]
            # libaom reads intra block copy sources straight from the frame
            # being decoded (no border extension): the decoded area runs to
            # MiCols / MiRows, past the frame's own width and height
            last_x = ((fr.fh.mi_cols * 4) >> sx) - 1
            last_y = ((fr.fh.mi_rows * 4) >> sy) - 1
            px = ((x << 4) + ((2 * blk.mv[1]) >> sx)) << 6
            py = ((y << 4) + ((2 * blk.mv[0]) >> sy)) << 6
            px += 32
            py += 32
            fx = (px >> 6) & 15
            fy = (py >> 6) & 15
            x0, y0 = px >> 10, py >> 10
            rows = np.clip(np.arange(y0 - 3, y0 + h + 5), 0, last_y)
            cols = np.clip(np.arange(x0, x0 + w + 1), 0, last_x)
            ref = frame[rows][:, cols].astype(np.int64)
            # horizontal bilinear (taps at positions 3 and 4), round 3 (5 at 12 bits)
            r0 = 5 if fr.bit_depth == 12 else 3
            r1 = 9 if fr.bit_depth == 12 else 11
            inter = ((128 - 8 * fx) * ref[:, :w] + 8 * fx * ref[:, 1:w + 1] +
                     (1 << (r0 - 1))) >> r0
            out = ((128 - 8 * fy) * inter[3:3 + h] + 8 * fy * inter[4:4 + h] +
                   (1 << (r1 - 1))) >> r1
            frame[y:y + h, x:x + w] = np.clip(out, 0, (1 << fr.bit_depth) - 1)

    # ------------------------------------------------------------- residual
    def residual(self, blk: Block) -> None:
        fr = self.fr
        b = self.mi_size
        wchunks = max(1, BW[b] >> 6)
        hchunks = max(1, BH[b] >> 6)
        for cy in range(hchunks):
            for cx in range(wchunks):
                row_c = self.mi_row + (cy << 4)
                col_c = self.mi_col + (cx << 4)
                for p in range(1 + 2 * self.has_chroma):
                    sx = fr.ssx if p else 0
                    sy = fr.ssy if p else 0
                    if self.lossless:
                        t = TX_4X4
                    elif p == 0:
                        t = blk.tx
                    else:
                        t = uv_tx_size(b, fr.ssx, fr.ssy)
                    step_x, step_y = TXW[t] >> 2, TXH[t] >> 2
                    psz = plane_residual_size(b, sx, sy)
                    n4w, n4h = BW4[psz], BH4[psz]
                    if blk.is_inter and not self.lossless and p == 0:
                        self._transform_tree(blk, col_c * 4, row_c * 4, min(n4w * 4, 64),
                                             min(n4h * 4, 64))
                        continue
                    bx = (self.mi_col >> sx) * 4
                    by = (self.mi_row >> sy) * 4
                    for y in range(0, min(n4h, 16 >> sy), step_y):
                        for x in range(0, min(n4w, 16 >> sx), step_x):
                            self.transform_block(blk, p, bx, by, t,
                                                 x + ((cx << 4) >> sx), y + ((cy << 4) >> sy))

    def _transform_tree(self, blk: Block, x: int, y: int, w: int, h: int) -> None:
        fh = self.fh
        if x >= fh.mi_cols * 4 or y >= fh.mi_rows * 4:
            return
        t = self.fr.inter_tx[y >> 2][x >> 2]
        if TXW[t] == w and TXH[t] == h:
            self.transform_block(blk, 0, x, y, t, 0, 0)
        elif w > h:
            self._transform_tree(blk, x, y, w // 2, h)
            self._transform_tree(blk, x + w // 2, y, w // 2, h)
        elif w < h:
            self._transform_tree(blk, x, y, w, h // 2)
            self._transform_tree(blk, x, y + h // 2, w, h // 2)
        else:
            for dy in (0, h // 2):
                for dx in (0, w // 2):
                    self._transform_tree(blk, x + dx, y + dy, w // 2, h // 2)

    def transform_block(self, blk: Block, plane: int, base_x: int, base_y: int, t: int,
                        x: int, y: int) -> None:
        fr, fh = self.fr, self.fh
        sx = fr.ssx if plane else 0
        sy = fr.ssy if plane else 0
        sx0 = base_x + 4 * x
        sy0 = base_y + 4 * y
        row = (sy0 << sy) >> 2
        col = (sx0 << sx) >> 2
        sbr = row & self.sb_mask
        sbc = col & self.sb_mask
        step_x, step_y = TXW[t] >> 2, TXH[t] >> 2
        max_x = (fh.mi_cols * 4) >> sx
        max_y = (fh.mi_rows * 4) >> sy
        if sx0 >= max_x or sy0 >= max_y:
            return
        frame = fr.planes[plane]
        w, h = TXW[t], TXH[t]
        fr.lf_tx[plane][sy0 >> 2:(sy0 >> 2) + step_y, sx0 >> 2:(sx0 >> 2) + step_x] = t
        if not blk.is_inter:
            if blk.pal[1 if plane else 0]:
                cols = blk.pal_colors[0] if plane == 0 else (blk.pal_colors[1] if plane == 1
                                                             else self.pal_v)
                cmap = self.color_map[1 if plane else 0]
                sub = cmap[y * 4:y * 4 + h, x * 4:x * 4 + w]
                frame[sy0:sy0 + h, sx0:sx0 + w] = np.array(cols, np.int64)[sub]
            else:
                is_cfl = plane > 0 and blk.uvmode == UV_CFL_PRED
                mode = blk.ymode if plane == 0 else (DC_PRED if is_cfl else blk.uvmode)
                grid = self.decoded[plane]
                gy = (sbr >> sy) + 1
                gx = (sbc >> sx) + 1
                have_left = (self.avail_l if plane == 0 else self.avail_l_chroma) or x > 0
                have_above = (self.avail_u if plane == 0 else self.avail_u_chroma) or y > 0
                pred = predict_intra(
                    frame, sx0, sy0, have_left, have_above,
                    bool(grid[gy - 1][gx + step_x]), bool(grid[gy + step_y][gx - 1]), mode,
                    co._log2(w), co._log2(h), max_x - 1, max_y - 1, fr.bit_depth,
                    self.angle_y if plane == 0 else self.angle_uv,
                    self.filter_intra_mode if plane == 0 and self.use_filter_intra else -1,
                    self.s.enable_intra_edge_filter,
                    lambda: self._filter_type(plane))
                if is_cfl:
                    pred = cfl_predict(pred, self._cfl_luma(sx0, sy0, w, h),
                                       self.cfl_u if plane == 1 else self.cfl_v,
                                       (1 << fr.bit_depth) - 1)
                frame[sy0:sy0 + h, sx0:sx0 + w] = pred
            if plane == 0:
                self.max_luma_w = sx0 + step_x * 4
                self.max_luma_h = sy0 + step_y * 4
        if not blk.skip:
            self._coeffs_and_recon(blk, plane, sx0, sy0, t, frame)
        grid = self.decoded[plane]
        for i in range(step_y):
            gr = grid[(sbr >> sy) + 1 + i] if (sbr >> sy) + 1 + i < len(grid) else None
            if gr is None:
                continue
            for j in range(step_x):
                k = (sbc >> sx) + 1 + j
                if k < len(gr):
                    gr[k] = 1

    def _cfl_luma(self, cx: int, cy: int, w: int, h: int) -> np.ndarray:
        fr = self.fr
        sx, sy = fr.ssx, fr.ssy
        luma = fr.planes[0]
        lx0, ly0 = cx << sx, cy << sy
        nx = max(1, min(w, ((self.max_luma_w - lx0) >> sx)))
        ny = max(1, min(h, ((self.max_luma_h - ly0) >> sy)))
        blk = luma[ly0:ly0 + (ny << sy), lx0:lx0 + (nx << sx)].astype(np.int64)
        if sx:
            blk = blk[:, 0::2] + blk[:, 1::2]
        if sy:
            blk = blk[0::2] + blk[1::2]
        blk = blk << (3 - sx - sy)
        if nx < w:
            blk = np.concatenate([blk, np.repeat(blk[:, -1:], w - nx, 1)], 1)
        if ny < h:
            blk = np.concatenate([blk, np.repeat(blk[-1:], h - ny, 0)], 0)
        return blk

    def _filter_type(self, plane: int) -> int:
        fr = self.fr
        r, c = self.mi_row, self.mi_col
        mi = fr.mi
        smooth = (SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED)

        def is_smooth(rr, cc):
            nb = mi[rr][cc]
            if plane == 0:
                return nb.ymode in smooth
            return nb.uvmode in smooth
        above = left = False
        if (self.avail_u if plane == 0 else self.avail_u_chroma):
            rr, cc = r - 1, c
            if plane > 0:
                if fr.ssx and not (c & 1):
                    cc += 1
                if fr.ssy and (r & 1):
                    rr -= 1
            above = is_smooth(rr, cc)
        if (self.avail_l if plane == 0 else self.avail_l_chroma):
            rr, cc = r, c - 1
            if plane > 0:
                if fr.ssx and (c & 1):
                    cc -= 1
                if fr.ssy and not (r & 1):
                    rr += 1
            left = is_smooth(rr, cc)
        return int(above or left)

    # --------------------------------------------------------- coefficients
    def _coeffs_and_recon(self, blk: Block, plane: int, x: int, y: int, t: int,
                          frame: np.ndarray) -> None:
        fr, fh = self.fr, self.fh
        sx = fr.ssx if plane else 0
        sy = fr.ssy if plane else 0
        x4, y4 = x >> 2, y >> 2
        w, h = TXW[t], TXH[t]
        w4, h4 = w >> 2, h >> 2
        max_x4 = fh.mi_cols >> sx
        max_y4 = fh.mi_rows >> sy
        al = fr.above_level[plane]
        ad = fr.above_dc[plane]
        ll = fr.left_level[plane]
        ld = fr.left_dc[plane]
        x1 = min(x4 + w4, max_x4)
        y1 = min(y4 + h4, max_y4)
        psz = plane_residual_size(self.mi_size, sx, sy)
        if plane == 0:
            if BW[psz] == w and BH[psz] == h:
                ctx = 0
            else:
                top = max(al[x4:x1], default=0)
                left = max(ll[y4:y1], default=0)
                top, left = min(top, 255), min(left, 255)
                if top == 0 and left == 0:
                    ctx = 1
                elif top == 0 or left == 0:
                    ctx = 2 + (max(top, left) > 3)
                elif max(top, left) <= 3:
                    ctx = 4
                elif min(top, left) <= 3:
                    ctx = 5
                else:
                    ctx = 6
        else:
            above = any(al[x4:x1]) or any(ad[x4:x1])
            left = any(ll[y4:y1]) or any(ld[y4:y1])
            ctx = 7 + above + left
            if BW[psz] * BH[psz] > w * h:
                ctx += 3
        txsz_ctx = (co.SQR[t] + co.SQR_UP[t] + 1) >> 1
        rd = self.rd
        all_zero = rd.symbol(self.cdf["txb_skip"][txsz_ctx][ctx])
        cul, dc_cat = 0, 0
        if all_zero:
            if plane == 0:
                self._set_tx_type(x4, y4, w4, h4, 0)
        else:
            if plane == 0:
                self._transform_type(blk, x4, y4, t)
            tx_type = self._compute_tx_type(blk, plane, t, x4, y4)
            near = ad[x4:x1] + ld[y4:y1]
            dcs = near.count(2) - near.count(1)
            dc_ctx = 1 if dcs < 0 else 2 if dcs > 0 else 0
            eob, levels, cul, dc_cat = co.read_coeffs(rd, self.cdf, t, tx_type, 1 if plane else 0,
                                                      dc_ctx)
            if eob > 0 and levels:
                q = qindex(fh, blk.seg, self.current_q, ignore_delta=False)
                bdi = (fr.bit_depth - 8) >> 1
                if plane == 0:
                    dcq = DC_QLOOKUP[bdi][_clip_q(q + fh.dq_y_dc)]
                    acq = AC_QLOOKUP[bdi][_clip_q(q)]
                elif plane == 1:
                    dcq = DC_QLOOKUP[bdi][_clip_q(q + fh.dq_u_dc)]
                    acq = AC_QLOOKUP[bdi][_clip_q(q + fh.dq_u_ac)]
                else:
                    dcq = DC_QLOOKUP[bdi][_clip_q(q + fh.dq_v_dc)]
                    acq = AC_QLOOKUP[bdi][_clip_q(q + fh.dq_v_ac)]
                qm = None
                lvl = fh.qm[plane]
                if fh.using_qmatrix and not self.lossless and lvl < 15 and tx_type < 9:
                    qm = co.qm_matrix(lvl, 1 if plane else 0, t)
                co.reconstruct(frame, x, y, t, tx_type, levels, dcq, acq, qm, fr.bit_depth,
                               self.lossless)
        end_x = x4 + w4
        end_y = y4 + h4
        al[x4:end_x] = [cul] * w4
        ad[x4:end_x] = [dc_cat] * w4
        ll[y4:end_y] = [cul] * h4
        ld[y4:end_y] = [dc_cat] * h4

    def _set_tx_type(self, x4: int, y4: int, w4: int, h4: int, tt: int) -> None:
        tt_rows = self.fr.tx_types
        for j in range(h4):
            if y4 + j < len(tt_rows):
                tt_rows[y4 + j][x4:x4 + w4] = [tt] * w4

    def _tx_set(self, blk: Block, t: int) -> int:
        sq, up = TX[co.SQR[t]][0], TX[co.SQR_UP[t]][0]
        if up > 32:
            return 0
        if blk.is_inter:
            if self.fh.reduced_tx_set or up == 32:
                return 3
            return 2 if sq == 16 else 1
        if up == 32:
            return 0
        if self.fh.reduced_tx_set or sq == 16:
            return 2
        return 1

    def _transform_type(self, blk: Block, x4: int, y4: int, t: int) -> None:
        fh = self.fh
        st = self._tx_set(blk, t)
        q = qindex(fh, blk.seg, fh.base_q_idx) if fh.seg_enabled else fh.base_q_idx
        tt = 0
        if st > 0 and q > 0:
            sq = co.SQR[t]
            if blk.is_inter:
                tt = INTER_INV[st][self.rd.symbol(self.cdf["inter_tx_type"][st][sq])]
            else:
                mode = FILTER_INTRA_DIR[self.filter_intra_mode] if self.use_filter_intra \
                    else blk.ymode
                tt = INTRA_INV[st][self.rd.symbol(self.cdf["intra_tx_type"][st][sq][mode])]
        self._set_tx_type(x4, y4, TXW[t] >> 2, TXH[t] >> 2, tt)

    def _compute_tx_type(self, blk: Block, plane: int, t: int, x4: int, y4: int) -> int:
        if self.lossless or TX[co.SQR_UP[t]][0] > 32:
            return 0
        st = self._tx_set(blk, t)
        if plane == 0:
            return self.fr.tx_types[y4][x4]
        if blk.is_inter:
            fr = self.fr
            lx = max(self.mi_col, x4 << fr.ssx)
            ly = max(self.mi_row, y4 << fr.ssy)
            tt = fr.tx_types[ly][lx]
        else:
            tt = MODE_TO_TXFM[blk.uvmode]
        return tt if _in_set(st, tt, blk.is_inter) else 0


def _in_set(st: int, tt: int, inter: int) -> bool:
    if st == 0:
        return tt == 0
    members = INTER_INV[st] if inter else INTRA_INV[st]
    return tt in members


def _clip_q(q: int) -> int:
    return 0 if q < 0 else 255 if q > 255 else q


def _ceil_log2(x: int) -> int:
    if x < 2:
        return 0
    i, p = 1, 2
    while p < x:
        i += 1
        p <<= 1
    return i


def _ns_literal(rd, n: int) -> int:
    w = n.bit_length()
    m = (1 << w) - n
    v = rd.literal(w - 1)
    if v < m:
        return v
    return (v << 1) - m + rd.literal(1)


def _subexp_with_ref(rd, low: int, high: int, k: int, ref: int) -> int:
    """decode_signed_subexp_with_ref_bool (5.11.59): a value in [low, high)
    coded as a sub-exponential code recentred on `ref`."""
    mx, r = high - low, ref - low
    i = mk = 0
    while True:
        b2 = k + i - 1 if i else k
        a = 1 << b2
        if mx <= mk + 3 * a:
            v = _ns_literal(rd, mx - mk) + mk
            break
        if not rd.literal(1):
            v = rd.literal(b2) + mk
            break
        i += 1
        mk += a
    if (r << 1) <= mx:
        x = _inverse_recenter(r, v)
    else:
        x = mx - 1 - _inverse_recenter(mx - 1 - r, v)
    return x + low


def _inverse_recenter(r: int, v: int) -> int:
    if v > 2 * r:
        return v
    return r - ((v + 1) >> 1) if v & 1 else r + (v >> 1)


def _neg_deinterleave(diff: int, ref: int, mx: int) -> int:
    if not ref:
        return diff
    if ref >= mx - 1:
        return mx - diff - 1
    if 2 * ref < mx:
        if diff <= 2 * ref:
            return ref + ((diff + 1) >> 1) if diff & 1 else ref - (diff >> 1)
        return diff
    if diff <= 2 * (mx - ref - 1):
        return ref + ((diff + 1) >> 1) if diff & 1 else ref - (diff >> 1)
    return mx - (diff + 1)


def _stable_sort(weights: list, start: int, end: int) -> list:
    """The stack's bubble sort (7.10.2.11) on [start, end): the order of
    the indices it leaves."""
    idx = list(range(start, end))
    w = [weights[i] for i in idx]
    while end > start:
        new_end = start
        for k in range(start + 1, end):
            if w[k - 1 - start] < w[k - start]:
                w[k - 1 - start], w[k - start] = w[k - start], w[k - 1 - start]
                idx[k - 1 - start], idx[k - start] = idx[k - start], idx[k - 1 - start]
                new_end = k
        end = new_end
    return idx
