"""AV1 OBUs and headers (specification sections 5.3-5.9 and 5.11.1-5.12):
the OBU framing, the sequence header (the reduced still-picture form and the
full form) and the uncompressed header of one shown intra frame, with its
tile info, quantization, segmentation, delta q and lf, loop filter, CDEF and
loop-restoration parameters.

What a still AVIF page does not need is refused by name: bit depths of 10
and 12, superres, film grain, ``show_existing_frame``, inter frames and a
second frame. ``strict`` parsing checks what libaom checks (OpenCV's
decoder): trailing and alignment bits, the forbidden bit, the size field,
the payloads of the OBUs it skips; dav1d (PIL's) checks less
(:func:`_check_skipped`).
"""

from __future__ import annotations

from typing import List, Optional

__all__ = ["BitReader", "SequenceHeader", "FrameHeader", "parse_obus", "Frame"]

OBU_SEQUENCE_HEADER, OBU_TEMPORAL_DELIMITER, OBU_FRAME_HEADER = 1, 2, 3
OBU_TILE_GROUP, OBU_METADATA, OBU_FRAME = 4, 5, 6
OBU_REDUNDANT_FRAME_HEADER, OBU_TILE_LIST, OBU_PADDING = 7, 8, 15
KEY_FRAME, INTER_FRAME, INTRA_ONLY_FRAME, SWITCH_FRAME = 0, 1, 2, 3
SELECT = 2  # SELECT_SCREEN_CONTENT_TOOLS / SELECT_INTEGER_MV
RESTORE_NONE, RESTORE_WIENER, RESTORE_SGRPROJ, RESTORE_SWITCHABLE = 0, 1, 2, 3
_REMAP_LR_TYPE = (RESTORE_NONE, RESTORE_SWITCHABLE, RESTORE_WIENER, RESTORE_SGRPROJ)
SEG_FEATURE_BITS = (8, 6, 6, 6, 6, 3, 0, 0)
SEG_FEATURE_SIGNED = (1, 1, 1, 1, 1, 0, 0, 0)
SEG_FEATURE_MAX = (255, 63, 63, 63, 63, 7, 0, 0)
SEG_LVL_ALT_Q, SEG_LVL_REF_FRAME, SEG_LVL_SKIP = 0, 5, 6


class BitReader:
    """MSB-first bits of ``data[start:end]`` (the ``f(n)`` descriptor);
    ``strict``: libaom's checks of the alignment and trailing bits, which
    dav1d skips."""

    def __init__(self, data: bytes, start: int = 0, end: Optional[int] = None,
                 strict: bool = True):
        self.data = data
        self.bit = start * 8
        self.end = (len(data) if end is None else end) * 8
        self.strict = strict

    def f(self, n: int) -> int:
        if self.bit + n > self.end:
            raise ValueError("AV1 header runs past its OBU")
        x = 0
        for _ in range(n):
            x = (x << 1) | (self.data[self.bit >> 3] >> (7 - (self.bit & 7)) & 1)
            self.bit += 1
        return x

    def su(self, n: int) -> int:
        v = self.f(n)
        if v & (1 << (n - 1)):
            v -= 1 << n
        return v

    def ns(self, n: int) -> int:
        w = n.bit_length()
        m = (1 << w) - n
        v = self.f(w - 1)
        if v < m:
            return v
        return (v << 1) - m + self.f(1)

    def uvlc(self) -> int:
        zeros = 0
        while not self.f(1):
            zeros += 1
            if zeros >= 32:
                raise ValueError("AV1 uvlc of 32 leading zeros")
        return self.f(zeros) + (1 << zeros) - 1

    def byte_alignment(self):
        while self.bit & 7:
            if self.f(1) and self.strict:
                raise ValueError("AV1 byte_alignment() is not all 0 bits")

    def trailing_bits(self):
        """trailing_bits(): a 1 then 0s to the byte boundary, and the OBU's
        later bytes all 0 (libaom's padding check); dav1d reads one bit."""
        if not self.strict:
            self.f(1)
            return
        n = 8 - (self.bit & 7)
        if self.f(n) != 1 << (n - 1):
            raise ValueError("AV1 trailing bits are not a 1 and then 0s")
        if any(self.data[self.bit >> 3:self.end >> 3]):
            raise ValueError("AV1 OBU padding of non-zero bytes")

    @property
    def byte_pos(self) -> int:
        return self.bit >> 3


def _leb128(data: bytes, pos: int):
    value = 0
    for i in range(8):
        if pos >= len(data):
            raise ValueError("AV1 OBU size runs past the data")
        b = data[pos]
        pos += 1
        value |= (b & 0x7F) << (7 * i)
        if not b & 0x80:
            return value, pos
    raise ValueError("AV1 OBU size of more than 8 bytes")


class SequenceHeader:
    pass


# libaom's is_valid_seq_level_idx: the levels AV1 defines, and 31 (no limit)
_LEVELS = frozenset((0, 1, 4, 5, 8, 9, 12, 13, 14, 15, 16, 17, 18, 19, 31))


def _level(idx: int, strict: bool) -> int:
    if strict and idx not in _LEVELS:  # dav1d takes any
        raise ValueError(f"AV1 seq_level_idx {idx} is not a defined level")
    return idx


def parse_sequence_header(r: BitReader) -> SequenceHeader:
    s = SequenceHeader()
    s.profile = r.f(3)
    if s.profile > 2:
        raise ValueError(f"AV1 seq_profile {s.profile}")
    s.still_picture = r.f(1)
    s.reduced = r.f(1)
    if s.reduced and not s.still_picture:
        raise ValueError("AV1 reduced still-picture header without still_picture")
    s.decoder_model_info_present = 0
    s.equal_picture_interval = 0
    s.operating_point_idc = [0]
    s.decoder_model_present = [0]
    if s.reduced:
        _level(r.f(5), r.strict)
    else:
        timing_info_present = r.f(1)
        if timing_info_present:
            r.f(32)
            r.f(32)
            s.equal_picture_interval = r.f(1)
            if s.equal_picture_interval:
                r.uvlc()
            s.decoder_model_info_present = r.f(1)
            if s.decoder_model_info_present:
                s.buffer_delay_length = r.f(5) + 1
                r.f(32)
                s.buffer_removal_time_length = r.f(5) + 1
                s.frame_presentation_time_length = r.f(5) + 1
        initial_display_delay_present = r.f(1)
        count = r.f(5) + 1
        s.operating_point_idc = []
        s.decoder_model_present = []
        for _ in range(count):
            s.operating_point_idc.append(r.f(12))
            level = _level(r.f(5), r.strict)
            if level > 7:
                r.f(1)
            present = 0
            if s.decoder_model_info_present:
                present = r.f(1)
                if present:
                    r.f(s.buffer_delay_length)
                    r.f(s.buffer_delay_length)
                    r.f(1)
            s.decoder_model_present.append(present)
            if initial_display_delay_present and r.f(1):
                r.f(4)
    wbits = r.f(4) + 1
    hbits = r.f(4) + 1
    s.frame_width_bits, s.frame_height_bits = wbits, hbits
    s.max_width = r.f(wbits) + 1
    s.max_height = r.f(hbits) + 1
    s.frame_id_numbers_present = 0 if s.reduced else r.f(1)
    if s.frame_id_numbers_present:
        s.delta_frame_id_length = r.f(4) + 2
        s.frame_id_length = r.f(3) + 1 + s.delta_frame_id_length
    s.use_128 = r.f(1)
    s.enable_filter_intra = r.f(1)
    s.enable_intra_edge_filter = r.f(1)
    s.force_screen_content_tools = SELECT
    s.force_integer_mv = SELECT
    s.order_hint_bits = 0
    s.enable_warped_motion = 0
    if not s.reduced:
        r.f(1)  # enable_interintra_compound
        r.f(1)  # enable_masked_compound
        s.enable_warped_motion = r.f(1)
        r.f(1)  # enable_dual_filter
        enable_order_hint = r.f(1)
        if enable_order_hint:
            r.f(1)  # enable_jnt_comp
            r.f(1)  # enable_ref_frame_mvs
        if r.f(1):  # seq_choose_screen_content_tools
            s.force_screen_content_tools = SELECT
        else:
            s.force_screen_content_tools = r.f(1)
        if s.force_screen_content_tools > 0:
            if r.f(1):  # seq_choose_integer_mv
                s.force_integer_mv = SELECT
            else:
                s.force_integer_mv = r.f(1)
        else:
            s.force_integer_mv = SELECT
        if enable_order_hint:
            s.order_hint_bits = r.f(3) + 1
    s.enable_superres = r.f(1)
    s.enable_cdef = r.f(1)
    s.enable_restoration = r.f(1)
    # color_config
    high_bitdepth = r.f(1)
    if s.profile == 2 and high_bitdepth:
        s.bit_depth = 12 if r.f(1) else 10
    else:
        s.bit_depth = 10 if high_bitdepth else 8
    s.mono = 0 if s.profile == 1 else r.f(1)
    s.num_planes = 1 if s.mono else 3
    if r.f(1):
        s.color_primaries, s.transfer, s.matrix = r.f(8), r.f(8), r.f(8)
    else:
        s.color_primaries, s.transfer, s.matrix = 2, 2, 2
    s.chroma_sample_position = 0
    if s.mono:
        s.color_range = r.f(1)
        s.ss_x = s.ss_y = 1
        s.separate_uv_delta_q = 0
    else:
        if s.color_primaries == 1 and s.transfer == 13 and s.matrix == 0:
            s.color_range = 1
            s.ss_x = s.ss_y = 0
        else:
            s.color_range = r.f(1)
            if s.profile == 0:
                s.ss_x = s.ss_y = 1
            elif s.profile == 1:
                s.ss_x = s.ss_y = 0
            elif s.bit_depth == 12:
                s.ss_x = r.f(1)
                s.ss_y = r.f(1) if s.ss_x else 0
            else:
                s.ss_x, s.ss_y = 1, 0
            if s.ss_x and s.ss_y:
                s.chroma_sample_position = r.f(2)
        s.separate_uv_delta_q = r.f(1)
    s.film_grain_params_present = r.f(1)
    r.trailing_bits()
    if s.bit_depth != 8:
        raise ValueError(f"{s.bit_depth}-bit AV1: not read (8-bit only)")
    return s


class FrameHeader:
    def qindex(self, segment: int, current: int) -> int:
        """get_qindex: the segment's ALT_Q feature on ``current``."""
        if self.feature_enabled[segment][SEG_LVL_ALT_Q]:
            return max(0, min(255, current + self.feature_data[segment][SEG_LVL_ALT_Q]))
        return current


def _tile_log2(blk: int, target: int) -> int:
    k = 0
    while (blk << k) < target:
        k += 1
    return k


def _delta_q(r: BitReader) -> int:
    return r.su(7) if r.f(1) else 0


def parse_frame_header(r: BitReader, s: SequenceHeader, temporal_id: int = 0,
                       spatial_id: int = 0) -> FrameHeader:
    h = FrameHeader()
    if s.reduced:
        h.frame_type = KEY_FRAME
        h.show_frame = 1
        h.showable_frame = 0
        h.error_resilient = 1
    else:
        if r.f(1):
            raise ValueError("AV1 show_existing_frame: not read")
        h.frame_type = r.f(2)
        if h.frame_type not in (KEY_FRAME, INTRA_ONLY_FRAME):
            raise ValueError("AV1 inter frame: not read (still images only)")
        h.show_frame = r.f(1)
        if not h.show_frame:
            raise ValueError("AV1 frame that is not shown: not read")
        if s.decoder_model_info_present and not s.equal_picture_interval:
            r.f(s.frame_presentation_time_length)
        h.showable_frame = int(h.frame_type != KEY_FRAME)
        if h.frame_type == KEY_FRAME:
            h.error_resilient = 1
        else:
            h.error_resilient = r.f(1)
    h.disable_cdf_update = r.f(1)
    if s.force_screen_content_tools == SELECT:
        h.allow_screen_content_tools = r.f(1)
    else:
        h.allow_screen_content_tools = s.force_screen_content_tools
    if h.allow_screen_content_tools and s.force_integer_mv == SELECT:
        r.f(1)  # force_integer_mv: intra frames use integer vectors anyway
    if s.frame_id_numbers_present:
        r.f(s.frame_id_length)
    frame_size_override = 0 if s.reduced else r.f(1)
    r.f(s.order_hint_bits)
    if s.decoder_model_info_present:
        if r.f(1):  # buffer_removal_time_present_flag
            for op, idc in enumerate(s.operating_point_idc):
                if s.decoder_model_present[op]:
                    in_t = (idc >> temporal_id) & 1
                    in_s = (idc >> (spatial_id + 8)) & 1
                    if idc == 0 or (in_t and in_s):
                        r.f(s.buffer_removal_time_length)
    refresh = 0xFF if h.frame_type == KEY_FRAME else r.f(8)
    if h.frame_type == INTRA_ONLY_FRAME and refresh == 0xFF:
        raise ValueError("AV1 intra-only frame refreshing every reference")
    if refresh != 0xFF and h.error_resilient and s.order_hint_bits:
        for _ in range(8):
            r.f(s.order_hint_bits)
    # frame_size, superres_params, render_size
    if frame_size_override:
        h.width = r.f(s.frame_width_bits) + 1
        h.height = r.f(s.frame_height_bits) + 1
    else:
        h.width, h.height = s.max_width, s.max_height
    if s.enable_superres and r.f(1):
        raise ValueError("AV1 superres: not read")
    h.mi_cols = 2 * ((h.width + 7) >> 3)
    h.mi_rows = 2 * ((h.height + 7) >> 3)
    if r.f(1):  # render_and_frame_size_different
        r.f(16)
        r.f(16)
    h.allow_intrabc = r.f(1) if h.allow_screen_content_tools else 0
    if s.reduced or h.disable_cdf_update:
        h.disable_frame_end_update_cdf = 1
    else:
        h.disable_frame_end_update_cdf = r.f(1)
    _tile_info(r, s, h)
    # quantization_params
    h.base_q_idx = r.f(8)
    h.delta_q_y_dc = _delta_q(r)
    h.delta_q_u_dc = h.delta_q_u_ac = h.delta_q_v_dc = h.delta_q_v_ac = 0
    if s.num_planes > 1:
        diff_uv_delta = r.f(1) if s.separate_uv_delta_q else 0
        h.delta_q_u_dc = _delta_q(r)
        h.delta_q_u_ac = _delta_q(r)
        if diff_uv_delta:
            h.delta_q_v_dc = _delta_q(r)
            h.delta_q_v_ac = _delta_q(r)
        else:
            h.delta_q_v_dc, h.delta_q_v_ac = h.delta_q_u_dc, h.delta_q_u_ac
    h.using_qmatrix = r.f(1)
    h.qm_y = h.qm_u = h.qm_v = 15
    if h.using_qmatrix:
        h.qm_y = r.f(4)
        h.qm_u = r.f(4)
        h.qm_v = r.f(4) if s.separate_uv_delta_q else h.qm_u
    # segmentation_params
    h.segmentation_enabled = r.f(1)
    h.feature_enabled = [[0] * 8 for _ in range(8)]
    h.feature_data = [[0] * 8 for _ in range(8)]
    if h.segmentation_enabled:
        for i in range(8):
            for j in range(8):
                if r.f(1):
                    h.feature_enabled[i][j] = 1
                    bits, limit = SEG_FEATURE_BITS[j], SEG_FEATURE_MAX[j]
                    if SEG_FEATURE_SIGNED[j]:
                        v = max(-limit, min(limit, r.su(1 + bits)))
                    else:
                        v = max(0, min(limit, r.f(bits)))
                    h.feature_data[i][j] = v
    h.seg_id_pre_skip = 0
    h.last_active_seg_id = 0
    for i in range(8):
        for j in range(8):
            if h.feature_enabled[i][j]:
                h.last_active_seg_id = i
                if j >= SEG_LVL_REF_FRAME:
                    h.seg_id_pre_skip = 1
    # delta_q_params, delta_lf_params
    h.delta_q_present = r.f(1) if h.base_q_idx > 0 else 0
    h.delta_q_res = r.f(2) if h.delta_q_present else 0
    h.delta_lf_present = h.delta_lf_res = h.delta_lf_multi = 0
    if h.delta_q_present:
        if not h.allow_intrabc:
            h.delta_lf_present = r.f(1)
        if h.delta_lf_present:
            h.delta_lf_res = r.f(2)
            h.delta_lf_multi = r.f(1)
    h.lossless = []
    for seg in range(8):
        q = h.qindex(seg, h.base_q_idx)
        h.lossless.append(q == 0 and h.delta_q_y_dc == 0 and h.delta_q_u_ac == 0
                          and h.delta_q_u_dc == 0 and h.delta_q_v_ac == 0
                          and h.delta_q_v_dc == 0)
    h.coded_lossless = all(h.lossless)
    h.all_lossless = h.coded_lossless
    # loop_filter_params
    h.lf_level = [0, 0, 0, 0]
    h.lf_sharpness = 0
    h.lf_ref_deltas = [1, 0, 0, 0, -1, 0, -1, -1]
    h.lf_mode_deltas = [0, 0]
    h.lf_delta_enabled = 1
    if not (h.coded_lossless or h.allow_intrabc):
        h.lf_level[0] = r.f(6)
        h.lf_level[1] = r.f(6)
        if s.num_planes > 1 and (h.lf_level[0] or h.lf_level[1]):
            h.lf_level[2] = r.f(6)
            h.lf_level[3] = r.f(6)
        h.lf_sharpness = r.f(3)
        h.lf_delta_enabled = r.f(1)
        if h.lf_delta_enabled and r.f(1):  # loop_filter_delta_update
            for i in range(8):
                if r.f(1):
                    h.lf_ref_deltas[i] = r.su(7)
            for i in range(2):
                if r.f(1):
                    h.lf_mode_deltas[i] = r.su(7)
    # cdef_params
    h.cdef_damping = 3
    h.cdef_bits = 0
    h.cdef_y_pri, h.cdef_y_sec, h.cdef_uv_pri, h.cdef_uv_sec = [0], [0], [0], [0]
    h.enable_cdef = bool(s.enable_cdef and not h.coded_lossless and not h.allow_intrabc)
    if h.enable_cdef:
        h.cdef_damping = r.f(2) + 3
        h.cdef_bits = r.f(2)
        n = 1 << h.cdef_bits
        h.cdef_y_pri, h.cdef_y_sec, h.cdef_uv_pri, h.cdef_uv_sec = [], [], [], []
        for _ in range(n):
            h.cdef_y_pri.append(r.f(4))
            sec = r.f(2)
            h.cdef_y_sec.append(sec + (sec == 3))
            if s.num_planes > 1:
                h.cdef_uv_pri.append(r.f(4))
                sec = r.f(2)
                h.cdef_uv_sec.append(sec + (sec == 3))
            else:
                h.cdef_uv_pri.append(0)
                h.cdef_uv_sec.append(0)
    # lr_params
    h.lr_type = [RESTORE_NONE] * 3
    h.lr_size = [256, 256, 256]
    h.uses_lr = 0
    if not (h.all_lossless or h.allow_intrabc or not s.enable_restoration):
        uses_chroma = 0
        for i in range(s.num_planes):
            h.lr_type[i] = _REMAP_LR_TYPE[r.f(2)]
            if h.lr_type[i] != RESTORE_NONE:
                h.uses_lr = 1
                if i:
                    uses_chroma = 1
        if h.uses_lr:
            if s.use_128:
                shift = r.f(1) + 1
            else:
                shift = r.f(1)
                if shift:
                    shift += r.f(1)
            h.lr_size[0] = 256 >> (2 - shift)
            uv_shift = r.f(1) if (s.ss_x and s.ss_y and uses_chroma) else 0
            h.lr_size[1] = h.lr_size[2] = h.lr_size[0] >> uv_shift
    # read_tx_mode
    h.tx_mode_select = 0 if h.coded_lossless else r.f(1)
    # frame_reference_mode, skip_mode_params: intra frames have none
    if not (h.error_resilient or not s.enable_warped_motion) and h.frame_type not in (
            KEY_FRAME, INTRA_ONLY_FRAME):
        r.f(1)
    h.reduced_tx_set = r.f(1)
    # film_grain_params
    if s.film_grain_params_present and (h.show_frame or h.showable_frame):
        if r.f(1):
            raise ValueError("AV1 film grain: not read")
    return h


def _tile_info(r: BitReader, s: SequenceHeader, h: FrameHeader) -> None:
    sb_shift = 5 if s.use_128 else 4
    sb_cols = (h.mi_cols + (1 << sb_shift) - 1) >> sb_shift
    sb_rows = (h.mi_rows + (1 << sb_shift) - 1) >> sb_shift
    sb_size = sb_shift + 2
    max_tile_width_sb = 4096 >> sb_size
    max_tile_area_sb = (4096 * 2304) >> (2 * sb_size)
    min_log2_cols = _tile_log2(max_tile_width_sb, sb_cols)
    max_log2_cols = _tile_log2(1, min(sb_cols, 64))
    max_log2_rows = _tile_log2(1, min(sb_rows, 64))
    min_log2_tiles = max(min_log2_cols, _tile_log2(max_tile_area_sb, sb_rows * sb_cols))
    col_starts: List[int] = []
    row_starts: List[int] = []
    if r.f(1):  # uniform_tile_spacing_flag
        cols_log2 = min_log2_cols
        while cols_log2 < max_log2_cols and r.f(1):
            cols_log2 += 1
        w = (sb_cols + (1 << cols_log2) - 1) >> cols_log2
        col_starts = [sb << sb_shift for sb in range(0, sb_cols, w)]
        rows_log2 = max(min_log2_tiles - cols_log2, 0)
        while rows_log2 < max_log2_rows and r.f(1):
            rows_log2 += 1
        hh = (sb_rows + (1 << rows_log2) - 1) >> rows_log2
        row_starts = [sb << sb_shift for sb in range(0, sb_rows, hh)]
    else:
        widest = 0
        start = 0
        while start < sb_cols:
            col_starts.append(start << sb_shift)
            size = r.ns(min(sb_cols - start, max_tile_width_sb)) + 1
            widest = max(widest, size)
            start += size
        cols_log2 = _tile_log2(1, len(col_starts))
        if min_log2_tiles > 0:
            area = (sb_rows * sb_cols) >> (min_log2_tiles + 1)
        else:
            area = sb_rows * sb_cols
        max_h = max(area // widest, 1)
        start = 0
        while start < sb_rows:
            row_starts.append(start << sb_shift)
            start += r.ns(min(sb_rows - start, max_h)) + 1
        rows_log2 = _tile_log2(1, len(row_starts))
    h.tile_col_starts = col_starts + [h.mi_cols]
    h.tile_row_starts = row_starts + [h.mi_rows]
    h.tile_cols, h.tile_rows = len(col_starts), len(row_starts)
    h.tile_cols_log2, h.tile_rows_log2 = cols_log2, rows_log2
    h.tile_size_bytes = 4
    if cols_log2 > 0 or rows_log2 > 0:
        r.f(rows_log2 + cols_log2)  # context_update_tile_id: for later frames only
        h.tile_size_bytes = r.f(2) + 1


class Frame:
    """One frame's headers and its tile data: ``tiles`` is a list of
    (tile_row, tile_col, data, start, end)."""

    def __init__(self, seq, hdr):
        self.seq = seq
        self.hdr = hdr
        self.tiles = []


def _tile_group(data: bytes, start: int, end: int, frame: Frame, strict: bool) -> bool:
    h = frame.hdr
    r = BitReader(data, start, end, strict)
    n = h.tile_cols * h.tile_rows
    first, last = 0, n - 1
    if n > 1 and r.f(1):
        bits = h.tile_cols_log2 + h.tile_rows_log2
        first, last = r.f(bits), r.f(bits)
    r.byte_alignment()
    pos = r.byte_pos
    if first != len(frame.tiles):
        raise ValueError("AV1 tile groups out of order")
    for num in range(first, last + 1):
        if num == last:
            size = end - pos
        else:
            if pos + h.tile_size_bytes > end:
                raise ValueError("AV1 tile size runs past its OBU")
            size = int.from_bytes(data[pos:pos + h.tile_size_bytes], "little") + 1
            pos += h.tile_size_bytes
        if size <= 0 or pos + size > end:
            raise ValueError("AV1 tile runs past its OBU")
        frame.tiles.append((num // h.tile_cols, num % h.tile_cols, data, pos, pos + size))
        pos += size
    return last == n - 1


def _ends_in_80(body: bytes) -> bool:
    """The last non-zero byte of ``body`` is 0x80 (libaom's trailing bits
    of a byte-aligned payload)."""
    return body.rstrip(b"\0").endswith(b"\x80")


def _check_skipped(kind: int, body: bytes, strict: bool) -> None:
    """What each decoder checks of an OBU it does not decode (probed against
    libaom under OpenCV, ``strict``, and dav1d under PIL). dav1d: a
    metadata OBU's leb128 type, and the fields and one trailing bit of the
    HDR light-level (4 bytes) and mastering (24 bytes) types. libaom: a
    temporal delimiter of zero bytes only; padding, where there is any,
    ending in 0x80 then 0s; a reserved type not all 0s; the two HDR types'
    fields then 0x80 as their last non-zero byte; T.35 a country code then
    0x80 as the last non-zero byte; a reserved metadata type something not
    0 after its type."""
    if kind == OBU_METADATA:
        if not body:
            raise ValueError("AV1 metadata OBU of no bytes")
        try:
            mtype, at = _leb128(body, 0)
        except ValueError:
            raise ValueError("AV1 metadata type runs past its OBU") from None
        rest = body[at:]
        fields = {1: 4, 2: 24}.get(mtype)
        if not strict:
            if fields is not None and len(rest) <= fields:
                raise ValueError(f"AV1 metadata of type {mtype} cut short")
        elif fields is not None:
            if not _ends_in_80(rest[fields:]):
                raise ValueError(f"AV1 metadata of type {mtype} without its trailing bits")
        elif mtype == 4:
            country = 2 if rest[:1] == b"\xff" else 1
            if not (_ends_in_80(rest) and len(rest.rstrip(b"\0")) > country):
                raise ValueError("AV1 ITU-T T.35 metadata without its payload and trailing bits")
        elif mtype in (3, 5):
            raise ValueError(f"AV1 {('scalability', 'timecode')[mtype == 5]} metadata in a "
                             "still image: not read")
        elif not any(rest):
            raise ValueError(f"AV1 metadata of reserved type {mtype} and no payload")
    elif not strict:
        return
    elif kind == OBU_TEMPORAL_DELIMITER:
        if any(body):
            raise ValueError("AV1 temporal delimiter with a payload")
    elif kind == OBU_PADDING:
        if body and not _ends_in_80(body):
            raise ValueError("AV1 padding OBU whose last non-zero byte is not 0x80")
    elif kind == OBU_TILE_LIST:
        raise ValueError("AV1 tile list OBU outside large-scale tile decoding")
    elif body and not any(body):
        raise ValueError(f"AV1 OBU of reserved type {kind} holding only 0s")


def parse_obus(data: bytes, strict: bool = True) -> Frame:
    """The OBUs of an AVIF item: one sequence header and one shown intra
    frame; what follows the frame must be padding or metadata. ``strict``:
    libaom's bit checks (:class:`BitReader`), else dav1d's."""
    pos = 0
    seq = None
    frame = None
    done = False
    while pos < len(data):
        was_done = done
        b = data[pos]
        if b & 0x80 and strict:  # dav1d ignores it
            raise ValueError("AV1 OBU forbidden bit set")
        kind = (b >> 3) & 15
        ext = (b >> 2) & 1
        has_size = (b >> 1) & 1
        if not has_size and strict:
            raise ValueError("AV1 OBU without its size field")
        pos += 1
        temporal_id = spatial_id = 0
        if ext:
            if pos >= len(data):
                raise ValueError("AV1 OBU extension header runs past the data")
            temporal_id, spatial_id = data[pos] >> 5, (data[pos] >> 3) & 3
            pos += 1
        if has_size:
            size, pos = _leb128(data, pos)
        else:
            size = len(data) - pos
        end = pos + size
        if end > len(data):
            raise ValueError("AV1 OBU runs past the data")
        if kind == OBU_SEQUENCE_HEADER:  # a repeated one is parsed, the first kept
            again = parse_sequence_header(BitReader(data, pos, end, strict))
            seq = seq or again
        elif kind == OBU_REDUNDANT_FRAME_HEADER:
            if done:
                raise ValueError("AV1 redundant frame header after its frame")
        elif kind in (OBU_FRAME_HEADER, OBU_FRAME):
            if done:
                raise ValueError("AV1 stream of more than one frame: not read")
            if frame is not None:
                raise ValueError("AV1 frame header before the last frame's tiles")
            if seq is None:
                raise ValueError("AV1 frame before its sequence header")
            r = BitReader(data, pos, end, strict)
            frame = Frame(seq, parse_frame_header(r, seq, temporal_id, spatial_id))
            if kind == OBU_FRAME:
                r.byte_alignment()
                done = _tile_group(data, r.byte_pos, end, frame, strict)
            else:
                r.trailing_bits()
        elif kind == OBU_TILE_GROUP:
            if frame is None or done:
                raise ValueError("AV1 tile group without its frame header")
            done = _tile_group(data, pos, end, frame, strict)
        else:
            _check_skipped(kind, data[pos:end], strict)
        pos = end
        if strict and done and not was_done:  # libaom skips zero bytes after a frame
            while pos < len(data) and not data[pos]:
                pos += 1
    if seq is None:
        raise ValueError("AV1 payload without a sequence header")
    if frame is None or not done:
        raise ValueError("AV1 payload without a whole frame")
    return frame
