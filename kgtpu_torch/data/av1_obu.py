"""AV1 OBUs and headers (specification sections 5.3-5.9 and 5.11.1-2):
OBU framing, the sequence header, the uncompressed header of a KEY_FRAME
or INTRA_ONLY frame and the tile group headers, read as libaom 3.14 reads
them; what libaom rejects raises `UnreadableImage` (cv2's imread returns
None for such a file).

`parse_frame(data)` walks a temporal unit of OBUs (the payload of an AVIF
item) to the first shown frame and returns (SequenceHeader, FrameHeader,
tiles), each tile (tile row, tile column, start, end) in `data`.
`post_filters(fh)` names the in-loop and output filters the frame needs;
`av1_decode` applies deblocking, CDEF, superres and loop restoration and
refuses a frame that names film grain.
"""

from __future__ import annotations

from kgtpu_torch.data.imread import UnreadableImage

(OBU_SEQUENCE_HEADER, OBU_TEMPORAL_DELIMITER, OBU_FRAME_HEADER, OBU_TILE_GROUP,
 OBU_METADATA, OBU_FRAME, OBU_REDUNDANT_FRAME_HEADER, OBU_TILE_LIST) = range(1, 9)
OBU_PADDING = 15
KEY_FRAME, INTER_FRAME, INTRA_ONLY_FRAME, SWITCH_FRAME = range(4)
SELECT = 2
SEG_FEATURE_BITS = (8, 6, 6, 6, 6, 3, 0, 0)
SEG_FEATURE_SIGNED = (1, 1, 1, 1, 1, 0, 0, 0)
SEG_FEATURE_MAX = (255, 63, 63, 63, 63, 7, 0, 0)
RESTORE_NONE, RESTORE_WIENER, RESTORE_SGRPROJ, RESTORE_SWITCHABLE = range(4)
REMAP_LR_TYPE = (0, 3, 1, 2)  # lr_type -> FrameRestorationType (NONE, SWITCHABLE, WIENER, SGRPROJ)
SUPERRES_NUM = 8
LEVELS_UNDEFINED = frozenset((2, 3, 6, 7, 10, 11) + tuple(range(20, 31)))
LF_REF_DELTAS = (1, 0, 0, 0, -1, 0, -1, -1)  # INTRA_FRAME, LAST_FRAME .. ALTREF_FRAME


class Bits:
    """The f(n) / su(n) / ns(n) / le(n) / leb128() / uvlc() descriptors of
    section 4.10 over data[start:end]."""

    def __init__(self, data: bytes, start: int = 0, end: int | None = None):
        self.data = data
        self.pos = start * 8
        self.end = (len(data) if end is None else end) * 8

    def f(self, n: int) -> int:
        if self.pos + n > self.end:
            raise UnreadableImage("AV1 header runs past its OBU")
        x = 0
        for _ in range(n):
            x = (x << 1) | ((self.data[self.pos >> 3] >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return x

    def su(self, n: int) -> int:
        v = self.f(n)
        return v - (1 << n) if v & (1 << (n - 1)) else v

    def ns(self, n: int) -> int:
        w = n.bit_length()
        m = (1 << w) - n
        v = self.f(w - 1)
        if v < m:
            return v
        return (v << 1) - m + self.f(1)

    def le(self, n: int) -> int:
        return sum(self.f(8) << (8 * i) for i in range(n))

    def uvlc(self) -> int:
        zeros = 0
        while not self.f(1):
            zeros += 1
            if zeros >= 32:
                return (1 << 32) - 1
        return self.f(zeros) + (1 << zeros) - 1

    def byte_alignment(self) -> None:
        while self.pos & 7:
            if self.f(1):
                raise UnreadableImage("AV1 byte_alignment bits are not zero")

    def byte_pos(self) -> int:
        return self.pos >> 3


def leb128(data: bytes, pos: int) -> tuple[int, int]:
    value = 0
    for i in range(8):
        if pos >= len(data):
            raise UnreadableImage("AV1 OBU size runs past the data")
        b = data[pos]
        pos += 1
        value |= (b & 0x7F) << (7 * i)
        if not b & 0x80:
            return value, pos
    raise UnreadableImage("AV1 leb128 longer than 8 bytes")


class SequenceHeader:
    pass


class FrameHeader:
    pass


def _trailing_bits(b: Bits, end_byte: int) -> None:
    """trailing_bits: a 1 then zeros to the end of the OBU (libaom's
    av1_check_trailing_bits)."""
    bits_left = end_byte * 8 - b.pos
    if bits_left <= 0 or bits_left > 8 * (end_byte - (b.pos >> 3)):
        raise UnreadableImage("AV1 OBU has no trailing bits")
    if b.f(1) != 1:
        raise UnreadableImage("AV1 trailing bits do not start with 1")
    while b.pos < end_byte * 8:
        if b.f(1):
            raise UnreadableImage("AV1 trailing bits are not zero")


def _level(b: Bits) -> int:
    """seq_level_idx; libaom refuses the levels not yet defined (2.2, 2.3,
    3.2, 3.3, 4.2, 4.3 and 7.0 up; 31 is the unconstrained level)."""
    lvl = b.f(5)
    if lvl in LEVELS_UNDEFINED:
        raise UnreadableImage(f"AV1 seq_level_idx {lvl} is not yet defined")
    return lvl


def parse_sequence_header(data: bytes, start: int, end: int) -> SequenceHeader:
    b = Bits(data, start, end)
    s = SequenceHeader()
    s.profile = b.f(3)
    if s.profile > 2:
        raise UnreadableImage("AV1 seq_profile above 2")
    s.still_picture = b.f(1)
    s.reduced = b.f(1)
    if s.reduced and not s.still_picture:
        raise UnreadableImage("AV1 reduced still picture header without still_picture")
    s.decoder_model_info_present = 0
    s.equal_picture_interval = 0
    s.op_idc = [0]
    s.decoder_model_present = [0]
    if s.reduced:
        s.level = [_level(b)]
    else:
        timing = b.f(1)
        if timing:
            b.f(32)
            b.f(32)
            s.equal_picture_interval = b.f(1)
            if s.equal_picture_interval:
                if b.uvlc() == (1 << 32) - 1:
                    raise UnreadableImage("AV1 num_ticks_per_picture out of range")
            s.decoder_model_info_present = b.f(1)
            if s.decoder_model_info_present:
                s.buffer_delay_length = b.f(5) + 1
                b.f(32)
                s.buffer_removal_time_length = b.f(5) + 1
                s.frame_presentation_time_length = b.f(5) + 1
        initial_display_delay_present = b.f(1)
        count = b.f(5) + 1
        s.op_idc, s.level, s.decoder_model_present = [], [], []
        for _ in range(count):
            s.op_idc.append(b.f(12))
            lvl = _level(b)
            s.level.append(lvl)
            if lvl > 7:
                b.f(1)
            present = 0
            if s.decoder_model_info_present:
                present = b.f(1)
                if present:
                    b.f(s.buffer_delay_length)
                    b.f(s.buffer_delay_length)
                    b.f(1)
            s.decoder_model_present.append(present)
            if initial_display_delay_present:
                if b.f(1):
                    b.f(4)
    wbits = b.f(4) + 1
    hbits = b.f(4) + 1
    s.max_width = b.f(wbits) + 1
    s.max_height = b.f(hbits) + 1
    s.wbits, s.hbits = wbits, hbits
    s.frame_id_numbers_present = 0 if s.reduced else b.f(1)
    if s.frame_id_numbers_present:
        s.delta_frame_id_length = b.f(4) + 2
        s.frame_id_length = b.f(3) + 1 + s.delta_frame_id_length
    s.use_128 = b.f(1)
    s.enable_filter_intra = b.f(1)
    s.enable_intra_edge_filter = b.f(1)
    s.enable_order_hint = 0
    s.order_hint_bits = 0
    s.force_screen_content_tools = SELECT
    s.force_integer_mv = SELECT
    if not s.reduced:
        b.f(1)  # enable_interintra_compound
        b.f(1)  # enable_masked_compound
        b.f(1)  # enable_warped_motion
        b.f(1)  # enable_dual_filter
        s.enable_order_hint = b.f(1)
        if s.enable_order_hint:
            b.f(1)  # enable_jnt_comp
            b.f(1)  # enable_ref_frame_mvs
        if b.f(1):  # seq_choose_screen_content_tools
            s.force_screen_content_tools = SELECT
        else:
            s.force_screen_content_tools = b.f(1)
        if s.force_screen_content_tools > 0:
            if b.f(1):  # seq_choose_integer_mv
                s.force_integer_mv = SELECT
            else:
                s.force_integer_mv = b.f(1)
        else:
            s.force_integer_mv = SELECT
        if s.enable_order_hint:
            s.order_hint_bits = b.f(3) + 1
    s.enable_superres = b.f(1)
    s.enable_cdef = b.f(1)
    s.enable_restoration = b.f(1)
    # color_config
    high = b.f(1)
    if s.profile == 2 and high:
        s.bit_depth = 12 if b.f(1) else 10
    else:
        s.bit_depth = 10 if high else 8
    s.mono = 0 if s.profile == 1 else b.f(1)
    s.num_planes = 1 if s.mono else 3
    if b.f(1):
        s.cp, s.tc, s.mc = b.f(8), b.f(8), b.f(8)
    else:
        s.cp = s.tc = s.mc = 2
    s.separate_uv_delta_q = 0
    s.chroma_sample_position = 0
    if s.mono:
        s.color_range = b.f(1)
        s.ssx = s.ssy = 1
    elif s.cp == 1 and s.tc == 13 and s.mc == 0:
        s.color_range = 1
        s.ssx = s.ssy = 0
        if s.profile != 1 and not (s.profile == 2 and s.bit_depth == 12):
            raise UnreadableImage("AV1 sRGB colour needs 4:4:4, which this profile lacks")
    else:
        s.color_range = b.f(1)
        if s.profile == 0:
            s.ssx = s.ssy = 1
        elif s.profile == 1:
            s.ssx = s.ssy = 0
        elif s.bit_depth == 12:
            s.ssx = b.f(1)
            s.ssy = b.f(1) if s.ssx else 0
        else:
            s.ssx, s.ssy = 1, 0
        if s.ssx and s.ssy:
            s.chroma_sample_position = b.f(2)
    if not s.mono:
        s.separate_uv_delta_q = b.f(1)
    s.film_grain_params_present = b.f(1)
    _trailing_bits(b, end)
    return s


def _tile_log2(blk: int, target: int) -> int:
    k = 0
    while (blk << k) < target:
        k += 1
    return k


def _delta_q(b: Bits) -> int:
    return b.su(7) if b.f(1) else 0


def parse_frame_header(b: Bits, s: SequenceHeader, temporal_id: int = 0,
                       spatial_id: int = 0) -> FrameHeader:
    fh = FrameHeader()
    if s.reduced:
        fh.show_existing_frame = 0
        fh.frame_type = KEY_FRAME
        fh.show_frame = 1
        fh.showable_frame = 0
        fh.error_resilient = 1
    else:
        fh.show_existing_frame = b.f(1)
        if fh.show_existing_frame:
            raise UnreadableImage("AV1 show_existing_frame with no frame decoded")
        fh.frame_type = b.f(2)
        fh.show_frame = b.f(1)
        if fh.show_frame and s.decoder_model_info_present and not s.equal_picture_interval:
            b.f(s.frame_presentation_time_length)
        fh.showable_frame = fh.frame_type != KEY_FRAME if fh.show_frame else b.f(1)
        if fh.frame_type == SWITCH_FRAME or (fh.frame_type == KEY_FRAME and fh.show_frame):
            fh.error_resilient = 1
        else:
            fh.error_resilient = b.f(1)
    if fh.frame_type not in (KEY_FRAME, INTRA_ONLY_FRAME):
        raise UnreadableImage("AV1 first frame is not an intra frame")
    fh.disable_cdf_update = b.f(1)
    if s.force_screen_content_tools == SELECT:
        fh.allow_screen_content_tools = b.f(1)
    else:
        fh.allow_screen_content_tools = s.force_screen_content_tools
    if fh.allow_screen_content_tools and s.force_integer_mv == SELECT:
        b.f(1)  # force_integer_mv (1 for intra frames whatever it says)
    if s.frame_id_numbers_present:
        b.f(s.frame_id_length)
    if fh.frame_type == SWITCH_FRAME:
        override = 1
    elif s.reduced:
        override = 0
    else:
        override = b.f(1)
    b.f(s.order_hint_bits)
    if s.decoder_model_info_present:
        if b.f(1):  # buffer_removal_time_present_flag
            for op, idc in enumerate(s.op_idc):
                if s.decoder_model_present[op]:
                    in_t = (idc >> temporal_id) & 1
                    in_s = (idc >> (spatial_id + 8)) & 1
                    if idc == 0 or (in_t and in_s):
                        b.f(s.buffer_removal_time_length)
    if not (fh.frame_type == KEY_FRAME and fh.show_frame):
        refresh = b.f(8)
        if fh.frame_type == INTRA_ONLY_FRAME and refresh == 0xFF:
            raise UnreadableImage("AV1 intra-only frame refreshes every reference")
        if refresh != 0xFF and fh.error_resilient and s.enable_order_hint:
            for _ in range(8):
                b.f(s.order_hint_bits)
    # frame_size, superres_params, render_size
    if override:
        fh.width = b.f(s.wbits) + 1
        fh.height = b.f(s.hbits) + 1
        if fh.width > s.max_width or fh.height > s.max_height:
            raise UnreadableImage("AV1 frame larger than the sequence's maximum")
    else:
        fh.width, fh.height = s.max_width, s.max_height
    fh.use_superres = b.f(1) if s.enable_superres else 0
    fh.upscaled_width = fh.width
    fh.superres_denom = SUPERRES_NUM
    if fh.use_superres:
        denom = b.f(3) + 9
        # libaom's av1_calculate_scaled_superres_size keeps FrameWidth at
        # least 16 (or the upscaled width, where that is less); a frame it
        # leaves at its upscaled width is not upscaled (av1_superres_scaled),
        # and its restoration units are laid out unscaled: denominator 8
        fh.width = max((fh.upscaled_width * SUPERRES_NUM + denom // 2) // denom,
                       min(16, fh.upscaled_width))
        if fh.width != fh.upscaled_width:
            fh.superres_denom = denom
    if b.f(1):  # render_and_frame_size_different
        b.f(16)
        b.f(16)
    fh.mi_cols = 2 * ((fh.width + 7) >> 3)
    fh.mi_rows = 2 * ((fh.height + 7) >> 3)
    fh.allow_intrabc = 0
    if fh.allow_screen_content_tools and fh.upscaled_width == fh.width:
        fh.allow_intrabc = b.f(1)
    if s.reduced or fh.disable_cdf_update:
        fh.disable_frame_end_update_cdf = 1
    else:
        fh.disable_frame_end_update_cdf = b.f(1)
    _tile_info(b, s, fh)
    # quantization_params
    fh.base_q_idx = b.f(8)
    fh.dq_y_dc = _delta_q(b)
    fh.dq_u_dc = fh.dq_u_ac = fh.dq_v_dc = fh.dq_v_ac = 0
    if s.num_planes > 1:
        diff_uv = b.f(1) if s.separate_uv_delta_q else 0
        fh.dq_u_dc = _delta_q(b)
        fh.dq_u_ac = _delta_q(b)
        if diff_uv:
            fh.dq_v_dc = _delta_q(b)
            fh.dq_v_ac = _delta_q(b)
        else:
            fh.dq_v_dc, fh.dq_v_ac = fh.dq_u_dc, fh.dq_u_ac
    fh.using_qmatrix = b.f(1)
    fh.qm = (15, 15, 15)
    if fh.using_qmatrix:
        qm_y = b.f(4)
        qm_u = b.f(4)
        qm_v = b.f(4) if s.separate_uv_delta_q else qm_u
        fh.qm = (qm_y, qm_u, qm_v)
    # segmentation_params
    fh.seg_enabled = b.f(1)
    fh.feature_enabled = [[0] * 8 for _ in range(8)]
    fh.feature_data = [[0] * 8 for _ in range(8)]
    if fh.seg_enabled:
        for i in range(8):
            for j in range(8):
                if b.f(1):
                    fh.feature_enabled[i][j] = 1
                    lim = SEG_FEATURE_MAX[j]
                    if SEG_FEATURE_SIGNED[j]:
                        v = max(-lim, min(lim, b.su(1 + SEG_FEATURE_BITS[j])))
                    else:
                        v = max(0, min(lim, b.f(SEG_FEATURE_BITS[j])))
                    fh.feature_data[i][j] = v
    fh.seg_id_pre_skip = 0
    fh.last_active_seg_id = 0
    for i in range(8):
        for j in range(8):
            if fh.feature_enabled[i][j]:
                fh.last_active_seg_id = i
                if j >= 5:
                    fh.seg_id_pre_skip = 1
    # delta_q_params / delta_lf_params
    fh.delta_q_present = b.f(1) if fh.base_q_idx > 0 else 0
    fh.delta_q_res = b.f(2) if fh.delta_q_present else 0
    fh.delta_lf_present = fh.delta_lf_res = fh.delta_lf_multi = 0
    if fh.delta_q_present:
        if not fh.allow_intrabc:
            fh.delta_lf_present = b.f(1)
        if fh.delta_lf_present:
            fh.delta_lf_res = b.f(2)
            fh.delta_lf_multi = b.f(1)
    fh.lossless = []
    for seg in range(8):
        q = qindex(fh, seg, fh.base_q_idx)
        fh.lossless.append(q == 0 and not (fh.dq_y_dc or fh.dq_u_dc or fh.dq_u_ac or
                                           fh.dq_v_dc or fh.dq_v_ac))
    fh.coded_lossless = all(fh.lossless)
    fh.all_lossless = fh.coded_lossless and fh.width == fh.upscaled_width
    # loop_filter_params (the deltas' defaults are setup_past_independence's)
    fh.lf_level = [0, 0, 0, 0]
    fh.lf_sharpness = 0
    fh.lf_delta_enabled = 0
    fh.lf_ref_deltas = list(LF_REF_DELTAS)
    fh.lf_mode_deltas = [0, 0]
    if not (fh.coded_lossless or fh.allow_intrabc):
        fh.lf_level[0] = b.f(6)
        fh.lf_level[1] = b.f(6)
        if s.num_planes > 1 and (fh.lf_level[0] or fh.lf_level[1]):
            fh.lf_level[2] = b.f(6)
            fh.lf_level[3] = b.f(6)
        fh.lf_sharpness = b.f(3)
        fh.lf_delta_enabled = b.f(1)
        if fh.lf_delta_enabled and b.f(1):  # loop_filter_delta_update
            for deltas in (fh.lf_ref_deltas, fh.lf_mode_deltas):
                for i in range(len(deltas)):
                    if b.f(1):
                        deltas[i] = b.su(7)
    # cdef_params: each strength (y primary, y secondary, uv primary, uv
    # secondary), a coded secondary 3 meaning 4
    fh.cdef_bits = 0
    fh.cdef_damping = 3
    fh.cdef_strengths = []
    if not (fh.coded_lossless or fh.allow_intrabc or not s.enable_cdef):
        fh.cdef_damping = b.f(2) + 3
        fh.cdef_bits = b.f(2)
        for _ in range(1 << fh.cdef_bits):
            ys = [b.f(4), b.f(2)]
            uvs = [b.f(4), b.f(2)] if s.num_planes > 1 else [0, 0]
            fh.cdef_strengths.append([v + (v == 3) if k % 2 else v
                                      for k, v in enumerate(ys + uvs)])
    # lr_params: each plane's FrameRestorationType and LoopRestorationSize
    fh.lr_type = [RESTORE_NONE] * 3
    fh.lr_unit_size = [64] * 3
    if not (fh.all_lossless or fh.allow_intrabc or not s.enable_restoration):
        uses_lr = uses_chroma = False
        for p in range(s.num_planes):
            fh.lr_type[p] = REMAP_LR_TYPE[b.f(2)]
            if fh.lr_type[p] != RESTORE_NONE:
                uses_lr = True
                uses_chroma = uses_chroma or p > 0
        if uses_lr:
            if s.use_128:
                shift = 1 + b.f(1)
            else:
                shift = b.f(1)
                if shift:
                    shift += b.f(1)  # lr_unit_extra_shift
            uv_shift = b.f(1) if s.ssx and s.ssy and uses_chroma else 0
            luma = 64 << shift
            fh.lr_unit_size = [luma, luma >> uv_shift, luma >> uv_shift]
    # read_tx_mode
    if fh.coded_lossless:
        fh.tx_mode_select = 0
        fh.only_4x4 = 1
    else:
        fh.only_4x4 = 0
        fh.tx_mode_select = b.f(1)
    fh.reduced_tx_set = b.f(1)
    # film_grain_params
    fh.apply_grain = 0
    if s.film_grain_params_present and (fh.show_frame or fh.showable_frame):
        fh.apply_grain = b.f(1)
        if fh.apply_grain:
            _film_grain(b, s, fh)
    return fh


def _film_grain(b: Bits, s: SequenceHeader, fh: FrameHeader) -> None:
    """The rest of film_grain_params (section 5.9.30), read past: the
    frame is refused, but its tiles follow."""
    b.f(16)  # grain_seed
    if fh.frame_type == INTER_FRAME and not b.f(1):
        b.f(3)
        return
    ny = b.f(4)
    for _ in range(ny):
        b.f(16)
    from_luma = 0 if s.mono else b.f(1)
    ncb = ncr = 0
    if not (s.mono or from_luma or (s.ssx == 1 and s.ssy == 1 and ny == 0)):
        ncb = b.f(4)
        for _ in range(ncb):
            b.f(16)
        ncr = b.f(4)
        for _ in range(ncr):
            b.f(16)
    b.f(2)  # grain_scaling_minus_8
    lag = b.f(2)
    npos = 2 * lag * (lag + 1)
    nchroma = npos + 1 if ny else npos
    if ny:
        for _ in range(npos):
            b.f(8)
    if from_luma or ncb:
        for _ in range(nchroma):
            b.f(8)
    if from_luma or ncr:
        for _ in range(nchroma):
            b.f(8)
    b.f(2)  # ar_coeff_shift_minus_6
    b.f(2)  # grain_scale_shift
    if ncb:
        b.f(8)
        b.f(8)
        b.f(9)
    if ncr:
        b.f(8)
        b.f(8)
        b.f(9)
    b.f(1)  # overlap_flag
    b.f(1)  # clip_to_restricted_range


def _tile_info(b: Bits, s: SequenceHeader, fh: FrameHeader) -> None:
    sb_shift = 5 if s.use_128 else 4
    sb_cols = (fh.mi_cols + (1 << sb_shift) - 1) >> sb_shift
    sb_rows = (fh.mi_rows + (1 << sb_shift) - 1) >> sb_shift
    sb_size = sb_shift + 2
    max_tile_width_sb = 4096 >> sb_size
    max_tile_area_sb = (4096 * 2304) >> (2 * sb_size)
    min_log2_cols = _tile_log2(max_tile_width_sb, sb_cols)
    max_log2_cols = _tile_log2(1, min(sb_cols, 64))
    max_log2_rows = _tile_log2(1, min(sb_rows, 64))
    min_log2_tiles = max(min_log2_cols, _tile_log2(max_tile_area_sb, sb_rows * sb_cols))
    cols, rows = [], []
    if b.f(1):  # uniform_tile_spacing_flag
        cols_log2 = min_log2_cols
        while cols_log2 < max_log2_cols and b.f(1):
            cols_log2 += 1
        w = (sb_cols + (1 << cols_log2) - 1) >> cols_log2
        cols = [x << sb_shift for x in range(0, sb_cols, w)]
        rows_log2 = max(min_log2_tiles - cols_log2, 0)
        while rows_log2 < max_log2_rows and b.f(1):
            rows_log2 += 1
        h = (sb_rows + (1 << rows_log2) - 1) >> rows_log2
        rows = [y << sb_shift for y in range(0, sb_rows, h)]
    else:
        widest = 0
        start = 0
        while start < sb_cols:
            cols.append(start << sb_shift)
            size = b.ns(min(sb_cols - start, max_tile_width_sb)) + 1
            widest = max(widest, size)
            start += size
        cols_log2 = _tile_log2(1, len(cols))
        area = (sb_rows * sb_cols) >> (min_log2_tiles + 1) if min_log2_tiles > 0 \
            else sb_rows * sb_cols
        max_h = max(area // widest, 1)
        start = 0
        while start < sb_rows:
            rows.append(start << sb_shift)
            start += b.ns(min(sb_rows - start, max_h)) + 1
        rows_log2 = _tile_log2(1, len(rows))
    if len(cols) > 64 or len(rows) > 64:
        raise UnreadableImage("AV1 tile count above 64")
    fh.mi_col_starts = cols + [fh.mi_cols]
    fh.mi_row_starts = rows + [fh.mi_rows]
    fh.tile_cols, fh.tile_rows = len(cols), len(rows)
    fh.tile_cols_log2, fh.tile_rows_log2 = cols_log2, rows_log2
    fh.tile_size_bytes = 4
    if cols_log2 or rows_log2:
        b.f(cols_log2 + rows_log2)  # context_update_tile_id
        fh.tile_size_bytes = b.f(2) + 1


def qindex(fh: FrameHeader, seg: int, current: int, ignore_delta: bool = True) -> int:
    """get_qindex (section 7.12.2)."""
    if fh.seg_enabled and fh.feature_enabled[seg][0]:
        base = current if (not ignore_delta and fh.delta_q_present) else fh.base_q_idx
        return max(0, min(255, base + fh.feature_data[seg][0]))
    if not ignore_delta and fh.delta_q_present:
        return current
    return fh.base_q_idx


def post_filters(fh: FrameHeader) -> list[str]:
    """The in-loop and output filters this frame needs, by name, in the
    order of the specification's syntax (`av1_decode.PORTED` runs superres
    before loop restoration, as decode_frame_wrapup does; film grain is
    the one still queued)."""
    out = []
    if not (fh.coded_lossless or fh.allow_intrabc) and (fh.lf_level[0] or fh.lf_level[1]):
        out.append("deblocking")
    if any(any(st) for st in fh.cdef_strengths):
        out.append("CDEF")
    if any(t != RESTORE_NONE for t in fh.lr_type):
        out.append("loop restoration")
    if fh.width != fh.upscaled_width:
        out.append("superres")
    if fh.apply_grain:
        out.append("film grain")
    return out


def _tile_group(data: bytes, start: int, end: int, fh: FrameHeader, tiles: list) -> bool:
    """One tile group's tiles appended to `tiles`; True when it holds the
    frame's last tile."""
    b = Bits(data, start, end)
    num = fh.tile_cols * fh.tile_rows
    flag = b.f(1) if num > 1 else 0
    if num == 1 or not flag:
        tg_start, tg_end = 0, num - 1
    else:
        bits = fh.tile_cols_log2 + fh.tile_rows_log2
        tg_start, tg_end = b.f(bits), b.f(bits)
    b.byte_alignment()
    if tg_start != len(tiles) or tg_end < tg_start or tg_end >= num:
        raise UnreadableImage("AV1 tile group out of order")
    pos = b.byte_pos()
    for t in range(tg_start, tg_end + 1):
        if t == tg_end:
            size = end - pos
        else:
            if pos + fh.tile_size_bytes > end:
                raise UnreadableImage("AV1 tile size runs past the tile group")
            size = int.from_bytes(data[pos:pos + fh.tile_size_bytes], "little") + 1
            pos += fh.tile_size_bytes
        if size <= 0 or pos + size > end:
            raise UnreadableImage("AV1 tile data runs past the tile group")
        tiles.append((t // fh.tile_cols, t % fh.tile_cols, pos, pos + size))
        pos += size
    return tg_end == num - 1


def _obu_at(data: bytes, pos: int) -> tuple[int, int, int]:
    """(type, payload start, end) of the OBU at `pos`."""
    h = data[pos]
    if h & 0x80:
        raise UnreadableImage("AV1 OBU forbidden bit set")
    pos += 1 + ((h >> 2) & 1)
    if pos > len(data):
        raise UnreadableImage("AV1 OBU extension past the data")
    if (h >> 1) & 1:
        size, pos = leb128(data, pos)
    else:
        size = len(data) - pos
    if pos + size > len(data):
        raise UnreadableImage("AV1 OBU runs past the data")
    return (h >> 3) & 15, pos, pos + size


def _rest(data: bytes, pos: int) -> None:
    """What follows the first frame: libaom's decoder skips zero bytes and
    decodes the rest as the next temporal unit, failing the whole call where
    that fails; a further frame is not decoded here (refused)."""
    while pos < len(data) and data[pos] == 0:
        pos += 1
    while pos < len(data):
        typ, start, end = _obu_at(data, pos)
        if typ in (OBU_FRAME_HEADER, OBU_FRAME, OBU_TILE_GROUP):
            raise UnreadableImage("AV1 data holds a second frame")
        if typ == OBU_SEQUENCE_HEADER:
            parse_sequence_header(data, start, end)
        pos = end


def parse_frame(data: bytes):
    """(sequence header, frame header, tiles) of the first frame in `data`,
    a sequence of OBUs (each with its size field, as AVIF stores them)."""
    pos = 0
    seq = None
    fh = None
    tiles: list = []
    while pos < len(data):
        h = data[pos]
        if h & 0x80:
            raise UnreadableImage("AV1 OBU forbidden bit set")
        typ = (h >> 3) & 15
        ext = (h >> 2) & 1
        has_size = (h >> 1) & 1
        pos += 1
        tid = sid = 0
        if ext:
            if pos >= len(data):
                raise UnreadableImage("AV1 OBU extension past the data")
            tid, sid = data[pos] >> 5, (data[pos] >> 3) & 3
            pos += 1
        if has_size:
            size, pos = leb128(data, pos)
        else:
            size = len(data) - pos
        end = pos + size
        if end > len(data):
            raise UnreadableImage("AV1 OBU runs past the data")
        if typ == OBU_SEQUENCE_HEADER:
            seq = parse_sequence_header(data, pos, end)
        elif typ in (OBU_FRAME_HEADER, OBU_FRAME, OBU_REDUNDANT_FRAME_HEADER):
            if seq is None:
                raise UnreadableImage("AV1 frame before a sequence header")
            if fh is None:
                if typ == OBU_REDUNDANT_FRAME_HEADER:
                    raise UnreadableImage("AV1 redundant frame header first")
                b = Bits(data, pos, end)
                fh = parse_frame_header(b, seq, tid, sid)
                if typ == OBU_FRAME:
                    b.byte_alignment()
                    if _tile_group(data, b.byte_pos(), end, fh, tiles):
                        _rest(data, end)
                        return seq, fh, tiles
                else:
                    _trailing_bits(b, end)
        elif typ == OBU_TILE_GROUP:
            if fh is None:
                raise UnreadableImage("AV1 tile group before a frame header")
            if _tile_group(data, pos, end, fh, tiles):
                _rest(data, end)
                return seq, fh, tiles
        elif typ in (OBU_TILE_LIST,) or typ == 0 or 9 <= typ <= 14:
            pass
        pos = end
    raise UnreadableImage("AV1 data holds no complete frame")
