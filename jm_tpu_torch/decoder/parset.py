"""SPS / PPS / subset SPS parsing (spec 7.3.2.1 / 7.3.2.2 / H.7.3.2.1.4),
twin of jm_tpu/decoder/parset.py (ldecod/src/parset.c InterpretSPS:61,
InterpretPPS:389, Scaling_List, ReadVUI:284).

The VUI and its HRD parameters are read into ``SPS.vui``, jm_tpu's
dict (ReadVUI, ReadHRDParameters), which the SEI pic_timing parse reads.
The SPS and PPS scaling lists are read with the spec's fall-back rules
(Table 7-2): rule A in the SPS (an absent list 0 / 3 / 6 / 7 takes the
default list, any other the list before it of its kind), rule B in a PPS
of an SPS with scaling matrices (an absent list 0 / 3 / 6 / 7 takes the
SPS's), and a first delta that gives 0 selects the default list
(useDefaultScalingMatrixFlag). Lists are kept in zig-zag order. An SPS
whose FRExt read fails or is implausible is read again without the FRExt
block, as jm_tpu does for JM 19.0's MVC writer (its base-view SPS says
profile 100 but omits the block).
"""

from __future__ import annotations

from ..bitstream.bitreader import BitReader
from ..common.types import PPS, SPS

# the default scaling lists, zig-zag order (spec Tables 7-3 / 7-4)
DEFAULT_4x4_INTRA = [6, 13, 13, 20, 20, 20, 28, 28, 28, 28, 32, 32, 32, 37,
                     37, 42]
DEFAULT_4x4_INTER = [10, 14, 14, 20, 20, 20, 24, 24, 24, 24, 27, 27, 27, 30,
                     30, 34]
DEFAULT_8x8_INTRA = [
    6, 10, 10, 13, 11, 13, 16, 16, 16, 16, 18, 18, 18, 18, 18, 23,
    23, 23, 23, 23, 23, 25, 25, 25, 25, 25, 25, 25, 27, 27, 27, 27,
    27, 27, 27, 27, 29, 29, 29, 29, 29, 29, 29, 31, 31, 31, 31, 31,
    31, 33, 33, 33, 33, 33, 36, 36, 36, 36, 38, 38, 38, 40, 40, 42,
]
DEFAULT_8x8_INTER = [
    9, 13, 13, 15, 13, 15, 17, 17, 17, 17, 19, 19, 19, 19, 19, 21,
    21, 21, 21, 21, 21, 22, 22, 22, 22, 22, 22, 22, 24, 24, 24, 24,
    24, 24, 24, 24, 25, 25, 25, 25, 25, 25, 25, 27, 27, 27, 27, 27,
    27, 28, 28, 28, 28, 28, 30, 30, 30, 30, 32, 32, 32, 33, 33, 35,
]
FLAT_16 = [16] * 16
FLAT_64 = [16] * 64

# fall-back rule A: an absent list 0 / 3 (4x4) or 6 / 7 (8x8) of the SPS
# takes the default list
_SPS_FALLBACK_4 = {0: DEFAULT_4x4_INTRA, 3: DEFAULT_4x4_INTER}
_SPS_FALLBACK_8 = {0: DEFAULT_8x8_INTRA, 1: DEFAULT_8x8_INTER}

# profiles whose SPS carries chroma_format_idc .. seq_scaling_matrix
_FREXT_PROFILES = (100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139, 134,
                   135)


def _sps_sane(s: SPS) -> bool:
    """Spec bounds (7.4.2.1.1), which a read of the FRExt block that the
    SPS does not carry breaks (jm_tpu/decoder/parset.py _sps_sane)."""
    return (s.chroma_format_idc <= 3
            and s.bit_depth_luma_minus8 <= 6
            and s.bit_depth_chroma_minus8 <= 6
            and s.log2_max_frame_num_minus4 <= 12
            and (s.pic_order_cnt_type != 0
                 or s.log2_max_pic_order_cnt_lsb_minus4 <= 12)
            and s.pic_order_cnt_type <= 2
            and s.max_num_ref_frames <= 32)


def parse_sps(rbsp: bytes) -> SPS:
    try:
        s = _parse_sps_data(BitReader(rbsp))
        sane = _sps_sane(s)
    except (EOFError, ValueError):
        sane = False
    if not sane:
        s = _parse_sps_data(BitReader(rbsp), skip_frext=True)
    return s


def parse_subset_sps(rbsp: bytes) -> SPS:
    """Subset SPS (NAL type 15, spec 7.3.2.1.3) of the MVC profiles:
    seq_parameter_set_data + bit_equal_to_one + sps_mvc_extension
    (H.7.3.2.1.4). Returns an SPS whose ``mvc`` holds the extension.

    JM 19.0's encoder gates the FRExt chroma block on is_FREXT_profile
    (lencod/src/parset.c:693), which leaves out profiles 118 / 128, while
    its decoder reads it (ldecod/src/parset.c:128). The spec layout is
    read first; when it is implausible or bit_equal_to_one fails, the
    layout without the FRExt block is read."""
    def read(skip_frext):
        br = BitReader(rbsp)
        sp = _parse_sps_data(br, skip_frext=skip_frext)
        if not _sps_sane(sp):
            raise ValueError("implausible subset SPS fields")
        if br.flag() != 1:                     # bit_equal_to_one
            raise ValueError("bit_equal_to_one != 1")
        n_views = br.ue() + 1
        mvc = {"view_id": [br.ue() for _ in range(n_views)],
               "anchor_l0": [[]], "anchor_l1": [[]],
               "non_anchor_l0": [[]], "non_anchor_l1": [[]]}
        for _ in range(1, n_views):
            mvc["anchor_l0"].append([br.ue() for _ in range(br.ue())])
            mvc["anchor_l1"].append([br.ue() for _ in range(br.ue())])
        for _ in range(1, n_views):
            mvc["non_anchor_l0"].append([br.ue() for _ in range(br.ue())])
            mvc["non_anchor_l1"].append([br.ue() for _ in range(br.ue())])
        for _ in range(br.ue() + 1):
            br.u(8)                            # level_idc
            for _ in range(br.ue() + 1):       # applicable ops
                br.u(3)
                for _ in range(br.ue() + 1):
                    br.ue()                    # target view ids
                br.ue()                        # num_views_minus1
        sp.mvc = mvc
        return sp
    try:
        return read(skip_frext=False)
    except (EOFError, ValueError):
        return read(skip_frext=True)


def _read_scaling_list(br: BitReader, size: int):
    """scaling_list() (spec 7.3.2.1.1.1): (the list, zig-zag order;
    useDefaultScalingMatrixFlag)."""
    last = nxt = 8
    out = []
    use_default = False
    for j in range(size):
        if nxt:
            nxt = (last + br.se() + 256) % 256
            use_default = use_default or (j == 0 and nxt == 0)
        last = nxt or last
        out.append(last)
    return out, use_default


def _read_all_scaling_lists(br: BitReader, n_lists: int, fallback_4x4,
                            fallback_8x8):
    """The scaling-list loop of an SPS or PPS (jm_tpu/decoder/parset.py
    _read_all_scaling_lists): fallback_* give the lists an absent list
    0 / 3 / 6 / 7 takes (rule A: the defaults; rule B: the SPS's); any
    other absent list takes the list before it of its kind. Returns
    (six 4x4 lists, n_lists - 6 8x8 lists)."""
    l4 = [None] * 6
    l8 = [None] * (n_lists - 6)
    for i in range(n_lists):
        present = br.flag()
        if i < 6:
            if present:
                lst, use_def = _read_scaling_list(br, 16)
                l4[i] = list(DEFAULT_4x4_INTRA if i < 3
                             else DEFAULT_4x4_INTER) if use_def else lst
            else:
                l4[i] = list(fallback_4x4[i] if i in (0, 3) else l4[i - 1])
        else:
            k = i - 6
            if present:
                lst, use_def = _read_scaling_list(br, 64)
                l8[k] = list(DEFAULT_8x8_INTRA if k % 2 == 0
                             else DEFAULT_8x8_INTER) if use_def else lst
            else:
                l8[k] = list(fallback_8x8[k] if k < 2 else l8[k - 2])
    return l4, l8


def _parse_sps_data(br: BitReader, skip_frext: bool = False) -> SPS:
    s = SPS()
    s.profile_idc = br.u(8)
    s.constraint_set_flags = br.u(8)
    s.level_idc = br.u(8)
    s.seq_parameter_set_id = br.ue()
    if not skip_frext and s.profile_idc in _FREXT_PROFILES:
        s.chroma_format_idc = br.ue()
        if s.chroma_format_idc == 3:
            s.separate_colour_plane_flag = br.flag()
        s.bit_depth_luma_minus8 = br.ue()
        s.bit_depth_chroma_minus8 = br.ue()
        s.qpprime_y_zero_transform_bypass_flag = br.flag()
        s.seq_scaling_matrix_present_flag = br.flag()
        if s.seq_scaling_matrix_present_flag:
            s.scaling_list_4x4, s.scaling_list_8x8 = _read_all_scaling_lists(
                br, 12 if s.chroma_format_idc == 3 else 8, _SPS_FALLBACK_4,
                _SPS_FALLBACK_8)
    if not s.scaling_list_4x4:
        s.scaling_list_4x4 = [list(FLAT_16) for _ in range(6)]
        s.scaling_list_8x8 = [list(FLAT_64) for _ in range(6)]
    s.log2_max_frame_num_minus4 = br.ue()
    s.pic_order_cnt_type = br.ue()
    if s.pic_order_cnt_type == 0:
        s.log2_max_pic_order_cnt_lsb_minus4 = br.ue()
    elif s.pic_order_cnt_type == 1:
        s.delta_pic_order_always_zero_flag = br.flag()
        s.offset_for_non_ref_pic = br.se()
        s.offset_for_top_to_bottom_field = br.se()
        n = br.ue()
        s.offset_for_ref_frame = [br.se() for _ in range(n)]
    s.max_num_ref_frames = br.ue()
    s.gaps_in_frame_num_value_allowed_flag = br.flag()
    s.pic_width_in_mbs_minus1 = br.ue()
    s.pic_height_in_map_units_minus1 = br.ue()
    s.frame_mbs_only_flag = br.flag()
    if not s.frame_mbs_only_flag:
        s.mb_adaptive_frame_field_flag = br.flag()
    s.direct_8x8_inference_flag = br.flag()
    s.frame_cropping_flag = br.flag()
    if s.frame_cropping_flag:
        s.frame_crop_left_offset = br.ue()
        s.frame_crop_right_offset = br.ue()
        s.frame_crop_top_offset = br.ue()
        s.frame_crop_bottom_offset = br.ue()
    s.vui_parameters_present_flag = br.flag()
    if s.vui_parameters_present_flag:
        s.vui = _parse_vui(br)
    return s


def _parse_hrd(br: BitReader) -> dict:
    """hrd_parameters() (spec E.1.2), as jm_tpu reads it."""
    hrd = {}
    cpb_cnt = br.ue() + 1
    hrd["cpb_cnt"] = cpb_cnt
    hrd["bit_rate_scale"] = br.u(4)
    hrd["cpb_size_scale"] = br.u(4)
    hrd["cpb"] = [
        (br.ue(), br.ue(), br.flag()) for _ in range(cpb_cnt)
    ]
    hrd["initial_cpb_removal_delay_length"] = br.u(5) + 1
    hrd["cpb_removal_delay_length"] = br.u(5) + 1
    hrd["dpb_output_delay_length"] = br.u(5) + 1
    hrd["time_offset_length"] = br.u(5)
    return hrd


def _parse_vui(br: BitReader) -> dict:
    """vui_parameters() (spec E.1.1) into jm_tpu's dict (SPS.vui), which
    the SEI pic_timing parse reads."""
    v = {}
    if br.flag():  # aspect_ratio_info_present
        idc = br.u(8)
        v["aspect_ratio_idc"] = idc
        if idc == 255:  # Extended_SAR
            v["sar_width"] = br.u(16)
            v["sar_height"] = br.u(16)
    if br.flag():  # overscan_info_present
        v["overscan_appropriate"] = br.flag()
    if br.flag():  # video_signal_type_present
        v["video_format"] = br.u(3)
        v["video_full_range"] = br.flag()
        if br.flag():  # colour_description_present
            v["colour_primaries"] = br.u(8)
            v["transfer_characteristics"] = br.u(8)
            v["matrix_coefficients"] = br.u(8)
    if br.flag():  # chroma_loc_info_present
        v["chroma_sample_loc_type_top"] = br.ue()
        v["chroma_sample_loc_type_bottom"] = br.ue()
    if br.flag():  # timing_info_present
        v["num_units_in_tick"] = br.u(32)
        v["time_scale"] = br.u(32)
        v["fixed_frame_rate"] = br.flag()
    nal_hrd = br.flag()
    if nal_hrd:
        v["nal_hrd"] = _parse_hrd(br)
    vcl_hrd = br.flag()
    if vcl_hrd:
        v["vcl_hrd"] = _parse_hrd(br)
    if nal_hrd or vcl_hrd:
        v["low_delay_hrd"] = br.flag()
    v["pic_struct_present"] = br.flag()
    if br.flag():  # bitstream_restriction
        v["motion_vectors_over_pic_boundaries"] = br.flag()
        v["max_bytes_per_pic_denom"] = br.ue()
        v["max_bits_per_mb_denom"] = br.ue()
        v["log2_max_mv_length_horizontal"] = br.ue()
        v["log2_max_mv_length_vertical"] = br.ue()
        v["max_num_reorder_frames"] = br.ue()
        v["max_dec_frame_buffering"] = br.ue()
    return v


def parse_pps(rbsp: bytes, sps_map: dict[int, SPS]) -> PPS:
    br = BitReader(rbsp)
    p = PPS()
    p.pic_parameter_set_id = br.ue()
    p.seq_parameter_set_id = br.ue()
    sps = sps_map[p.seq_parameter_set_id]
    p.entropy_coding_mode_flag = br.flag()
    p.bottom_field_pic_order_in_frame_present_flag = br.flag()
    p.num_slice_groups_minus1 = br.ue()
    if p.num_slice_groups_minus1 > 0:
        # slice group maps are read so the rest of the PPS parses; a slice
        # that uses them raises (decoder/header.check_scope)
        p.slice_group_map_type = br.ue()
        n = p.num_slice_groups_minus1
        if p.slice_group_map_type == 0:
            p.run_length_minus1 = [br.ue() for _ in range(n + 1)]
        elif p.slice_group_map_type == 2:
            for _ in range(n):
                p.top_left.append(br.ue())
                p.bottom_right.append(br.ue())
        elif p.slice_group_map_type in (3, 4, 5):
            p.slice_group_change_direction_flag = br.flag()
            p.slice_group_change_rate_minus1 = br.ue()
        elif p.slice_group_map_type == 6:
            p.pic_size_in_map_units_minus1 = br.ue()
            nbits = max(1, n.bit_length())
            p.slice_group_id = [
                br.u(nbits) for _ in range(p.pic_size_in_map_units_minus1 + 1)
            ]
    p.num_ref_idx_l0_default_active_minus1 = br.ue()
    p.num_ref_idx_l1_default_active_minus1 = br.ue()
    p.weighted_pred_flag = br.flag()
    p.weighted_bipred_idc = br.u(2)
    p.pic_init_qp_minus26 = br.se()
    p.pic_init_qs_minus26 = br.se()
    p.chroma_qp_index_offset = br.se()
    p.deblocking_filter_control_present_flag = br.flag()
    p.constrained_intra_pred_flag = br.flag()
    p.redundant_pic_cnt_present_flag = br.flag()
    p.scaling_list_4x4 = [list(x) for x in sps.scaling_list_4x4]
    p.scaling_list_8x8 = [list(x) for x in sps.scaling_list_8x8]
    if br.more_rbsp_data():
        p.transform_8x8_mode_flag = br.flag()
        p.pic_scaling_matrix_present_flag = br.flag()
        if p.pic_scaling_matrix_present_flag:
            n = 6 + (2 if sps.chroma_format_idc != 3 else 6) \
                * p.transform_8x8_mode_flag
            if sps.seq_scaling_matrix_present_flag:
                # rule B: an absent list 0 / 3 / 6 / 7 takes the SPS's
                fb4 = {0: p.scaling_list_4x4[0], 3: p.scaling_list_4x4[3]}
                fb8 = {0: p.scaling_list_8x8[0], 1: p.scaling_list_8x8[1]}
            else:
                fb4, fb8 = _SPS_FALLBACK_4, _SPS_FALLBACK_8
            p.scaling_list_4x4, l8 = _read_all_scaling_lists(br, n, fb4, fb8)
            for k, lst in enumerate(l8):
                p.scaling_list_8x8[k] = lst
        p.second_chroma_qp_index_offset = br.se()
    return p
