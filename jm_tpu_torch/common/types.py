"""Slice types, the SPS / PPS parameter sets and the slice header as
plain dataclasses (lcommon/inc/parsetcommon.h seq_parameter_set_rbsp_t,
pic_parameter_set_rbsp_t; ldecod/inc/global.h Slice).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field


class SliceType(enum.IntEnum):
    P = 0
    B = 1
    I = 2
    SP = 3
    SI = 4


class ChromaFormat(enum.IntEnum):
    YUV400 = 0
    YUV420 = 1
    YUV422 = 2
    YUV444 = 3


# subsampling factors (width_shift, height_shift) per chroma format
CHROMA_SHIFT = {
    ChromaFormat.YUV400: (0, 0),
    ChromaFormat.YUV420: (1, 1),
    ChromaFormat.YUV422: (1, 0),
    ChromaFormat.YUV444: (0, 0),
}


@dataclass
class SPS:
    profile_idc: int = 66
    constraint_set_flags: int = 0
    level_idc: int = 40
    seq_parameter_set_id: int = 0
    chroma_format_idc: int = 1
    separate_colour_plane_flag: int = 0
    bit_depth_luma_minus8: int = 0
    bit_depth_chroma_minus8: int = 0
    qpprime_y_zero_transform_bypass_flag: int = 0
    seq_scaling_matrix_present_flag: int = 0
    # 12 lists x 64 entries (first 6 are 4x4 using 16); flat per spec order
    scaling_list_4x4: list = field(default_factory=list)
    scaling_list_8x8: list = field(default_factory=list)
    log2_max_frame_num_minus4: int = 0
    pic_order_cnt_type: int = 0
    log2_max_pic_order_cnt_lsb_minus4: int = 0
    delta_pic_order_always_zero_flag: int = 0
    offset_for_non_ref_pic: int = 0
    offset_for_top_to_bottom_field: int = 0
    offset_for_ref_frame: list = field(default_factory=list)
    max_num_ref_frames: int = 1
    gaps_in_frame_num_value_allowed_flag: int = 0
    pic_width_in_mbs_minus1: int = 10
    pic_height_in_map_units_minus1: int = 8
    frame_mbs_only_flag: int = 1
    mb_adaptive_frame_field_flag: int = 0
    direct_8x8_inference_flag: int = 1
    frame_cropping_flag: int = 0
    frame_crop_left_offset: int = 0
    frame_crop_right_offset: int = 0
    frame_crop_top_offset: int = 0
    frame_crop_bottom_offset: int = 0
    vui_parameters_present_flag: int = 0
    vui: dict | None = None

    # -- derived -----------------------------------------------------------

    @property
    def pic_width_in_mbs(self) -> int:
        return self.pic_width_in_mbs_minus1 + 1

    @property
    def frame_height_in_mbs(self) -> int:
        return (2 - self.frame_mbs_only_flag) * (self.pic_height_in_map_units_minus1 + 1)

    @property
    def width(self) -> int:
        return self.pic_width_in_mbs * 16

    @property
    def height(self) -> int:
        return self.frame_height_in_mbs * 16

    @property
    def chroma_format(self) -> ChromaFormat:
        return ChromaFormat(self.chroma_format_idc)

    @property
    def bit_depth_luma(self) -> int:
        return 8 + self.bit_depth_luma_minus8

    @property
    def bit_depth_chroma(self) -> int:
        return 8 + self.bit_depth_chroma_minus8

    @property
    def max_frame_num(self) -> int:
        return 1 << (self.log2_max_frame_num_minus4 + 4)

    @property
    def max_poc_lsb(self) -> int:
        return 1 << (self.log2_max_pic_order_cnt_lsb_minus4 + 4)


@dataclass
class PPS:
    pic_parameter_set_id: int = 0
    seq_parameter_set_id: int = 0
    entropy_coding_mode_flag: int = 0
    bottom_field_pic_order_in_frame_present_flag: int = 0
    num_slice_groups_minus1: int = 0
    slice_group_map_type: int = 0
    run_length_minus1: list = field(default_factory=list)
    top_left: list = field(default_factory=list)
    bottom_right: list = field(default_factory=list)
    slice_group_change_direction_flag: int = 0
    slice_group_change_rate_minus1: int = 0
    pic_size_in_map_units_minus1: int = 0
    slice_group_id: list = field(default_factory=list)
    num_ref_idx_l0_default_active_minus1: int = 0
    num_ref_idx_l1_default_active_minus1: int = 0
    weighted_pred_flag: int = 0
    weighted_bipred_idc: int = 0
    pic_init_qp_minus26: int = 0
    pic_init_qs_minus26: int = 0
    chroma_qp_index_offset: int = 0
    deblocking_filter_control_present_flag: int = 0
    constrained_intra_pred_flag: int = 0
    redundant_pic_cnt_present_flag: int = 0
    # FRExt extensions
    transform_8x8_mode_flag: int = 0
    pic_scaling_matrix_present_flag: int = 0
    scaling_list_4x4: list = field(default_factory=list)
    scaling_list_8x8: list = field(default_factory=list)
    second_chroma_qp_index_offset: int | None = None

    @property
    def cb_qp_offset(self) -> int:
        return self.chroma_qp_index_offset

    @property
    def cr_qp_offset(self) -> int:
        off = self.second_chroma_qp_index_offset
        return self.chroma_qp_index_offset if off is None else off


@dataclass
class RefPicListMod:
    """One ref_pic_list_modification command."""
    op: int            # modification_of_pic_nums_idc (0, 1: short-term
                       # diff, 2: long-term)
    value: int         # abs_diff_pic_num_minus1 or long_term_pic_num


@dataclass
class MMCOOp:
    """One memory_management_control_operation (spec 7.3.3.3): value1 is
    difference_of_pic_nums_minus1 (ops 1, 3), long_term_pic_num (2),
    max_long_term_frame_idx_plus1 (4) or long_term_frame_idx (6); value2
    the long_term_frame_idx of op 3."""
    op: int
    value1: int = 0
    value2: int = 0


@dataclass
class SliceHeader:
    first_mb_in_slice: int = 0
    slice_type: SliceType = SliceType.I
    slice_type_all: bool = True   # slice_type value was >=5 (all slices same type)
    pic_parameter_set_id: int = 0
    frame_num: int = 0
    field_pic_flag: int = 0
    bottom_field_flag: int = 0
    idr_pic_id: int = 0
    pic_order_cnt_lsb: int = 0
    delta_pic_order_cnt_bottom: int = 0
    delta_pic_order_cnt: tuple = (0, 0)
    redundant_pic_cnt: int = 0
    direct_spatial_mv_pred_flag: int = 0
    num_ref_idx_active_override_flag: int = 0
    num_ref_idx_l0_active_minus1: int = 0
    num_ref_idx_l1_active_minus1: int = 0
    ref_pic_list_mod_l0: list = field(default_factory=list)
    ref_pic_list_mod_l1: list = field(default_factory=list)
    # pred_weight_table (spec 7.3.3.2), set only when the PPS asks for it:
    # one {"luma": (w, o), "chroma": [[w, o], [w, o]]} entry per active
    # reference of each list
    luma_log2_weight_denom: int = 0
    chroma_log2_weight_denom: int = 0
    wp_l0: list = field(default_factory=list)
    wp_l1: list = field(default_factory=list)
    no_output_of_prior_pics_flag: int = 0
    long_term_reference_flag: int = 0
    adaptive_ref_pic_marking_mode_flag: int = 0
    mmco_ops: list = field(default_factory=list)
    cabac_init_idc: int = 0
    slice_qp_delta: int = 0
    # SP slices (spec 7.3.3): sp_for_switch_flag and slice_qs_delta
    sp_for_switch_flag: int = 0
    slice_qs_delta: int = 0
    disable_deblocking_filter_idc: int = 0
    slice_alpha_c0_offset_div2: int = 0
    slice_beta_offset_div2: int = 0
    slice_group_change_cycle: int = 0
    # context (not syntax): nal info this header came from
    nal_ref_idc: int = 0
    is_idr: bool = False

    def qp(self, pps: PPS) -> int:
        return 26 + pps.pic_init_qp_minus26 + self.slice_qp_delta

    def qs(self, pps: PPS) -> int:
        """The switching QP QSY of an SP slice (spec 7.4.3)."""
        return 26 + pps.pic_init_qs_minus26 + self.slice_qs_delta
