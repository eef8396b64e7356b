"""Bitstream syntax writers for the encoder's slice: SPS/PPS (spec
7.3.2), the I/P/B frame slice header (7.3.3) and the CAVLC macroblock
layer (7.3.5) serialized from PictureData (the CABAC one is
syntax_cabac.py).

Covers what the 4:2:0 encoder emits: Baseline, Extended, Main or High
SPS/PPS (High: the 8x8 transform flag and the SPS / PPS scaling lists),
with VUI, POC type 0, 1 or 2, FMO slice
groups of map types 0-6 and redundant_pic_cnt; slices of any MB address
list (several per picture, in slice-group order), with
ref_pic_list_modification, dec_ref_pic_marking (long-term IDR, MMCO) and
redundant_pic_cnt, whole or as three data partitions
(``serialize_slice_dp``); I_NxN (4x4), I_16x16 and I_PCM macroblocks; P
macroblocks with 16x16/16x8/8x16/8x8 partitions, P_8x8's sub-macroblocks
of 8x8, 8x4, 4x8 or 4x4, and each partition's ref_idx as te(v) when
several references are active; with the 8x8 transform,
transform_size_8x8_flag (absent below 8x8) and each 8x8 block as four
interleaved 4x4 blocks; B macroblocks as the B coder decides them (B_Skip,
B_Direct_16x16, 16x16 list 0 / list 1 / bi-predicted, intra), one
reference per list, whose slices only the Python MBWriter writes (as in
jm_tpu; native.routes["b"]["serialize"]). Serialization is a pure
function of the decided PictureData (lencod/src/macroblock.c
write_{i,p,b}_slice_MB_layer order).
"""

from __future__ import annotations

import copy

import numpy as np

from .. import native as N
from ..bitstream.bitwriter import BitWriter
from ..common.picture import CBP_MAP_CHROMA, MB_INTER, MB_IPCM
from ..common.predict_ctx import CODE2RASTER, PredCtx
from ..common.types import SliceType
from ..decoder.b_slice import PD_BI, PD_L0, PD_L1
from .cavlc_write import write_residual_block
from .me import SUB_PARTS
from .qmatrix import write_scaling_list
from .wp_est import CHROMA_DENOM, LUMA_DENOM

# B mb_type of a 16x16 partition by prediction direction
B_MBTYPE_16x16 = {PD_L0: 1, PD_L1: 2, PD_BI: 3}

# inverse of spec Table 9-4: cbp -> codeNum
CBP_INV_CHROMA_INTRA = {int(cbp): i for i, (cbp, _) in enumerate(CBP_MAP_CHROMA)}
CBP_INV_CHROMA_INTER = {int(cbp): i for i, (_, cbp) in enumerate(CBP_MAP_CHROMA)}


def _write_scaling_lists(bw: BitWriter, scaling, n_lists: int) -> None:
    """The scaling-list loop of an SPS or PPS (spec 7.3.2.1.1 / 7.3.2.2);
    scaling: (scaling_list_present_flag of each list, the zig-zag
    lists)."""
    present, lists = scaling
    for i in range(n_lists):
        p = present[i] if i < len(present) else 0
        bw.flag(1 if p else 0)
        if p:
            write_scaling_list(bw, lists[i], 16 if i < 6 else 64)


def write_sps(sps, scaling=None) -> bytes:
    """Seq_parameter_set_rbsp for a Baseline, Extended, Main, High (4:2:0)
    or High 4:2:2 (profile 122, chroma_format_idc 2) stream of 8 bits,
    frame-coded or, with frame_mbs_only_flag 0, with field pictures
    (mb_adaptive_frame_field_flag written), with POC type 0, 1 or 2 and
    the VUI of ``sps.vui``;
    scaling: the lists a High SPS with seq_scaling_matrix_present_flag
    transmits, as _write_scaling_lists takes them (lencod parset.c
    GenerateSeq_parameter_set_rbsp; jm_tpu/encoder/syntax.py
    _write_sps_data)."""
    if sps.profile_idc in (110, 244, 44, 118, 128) \
            or sps.chroma_format_idc != (2 if sps.profile_idc == 122
                                         else 1) \
            or sps.pic_order_cnt_type not in (0, 1, 2):
        raise ValueError("write_sps covers Baseline / Extended / Main / "
                         "High 4:2:0 and High 4:2:2 with "
                         "pic_order_cnt_type 0, 1 or 2")
    bw = BitWriter()
    _write_sps_data(bw, sps, scaling)
    bw.rbsp_trailing_bits()
    return bw.get_bytes()


def write_subset_sps(sps, scaling=None) -> bytes:
    """Subset SPS of Stereo High (NAL 15, spec 7.3.2.1.3 + H.7.3.2.1.4
    sps_mvc_extension; jm_tpu/encoder/syntax.py write_subset_sps) for
    views 0 and 1: the base SPS's data at profile 128 in the spec's
    layout (JM 19.0's writer leaves the FRExt block out,
    decoder/parset.parse_subset_sps), then view 0 as view 1's one list-0
    reference, anchor and non-anchor, one level and one operation
    point."""
    sub = copy.copy(sps)
    sub.profile_idc = 128                     # Stereo High
    bw = BitWriter()
    _write_sps_data(bw, sub, scaling)
    bw.flag(1)                                # bit_equal_to_one
    bw.ue(1)                                  # num_views_minus1
    bw.ue(0)                                  # view_id[0]
    bw.ue(1)                                  # view_id[1]
    for _ in range(2):                        # anchor, then non-anchor
        bw.ue(1)                              # num_..._refs_l0
        bw.ue(0)                              # ... -> view 0
        bw.ue(0)                              # num_..._refs_l1
    bw.ue(0)                                  # num_level_values_signalled-1
    bw.u(sps.level_idc, 8)
    bw.ue(0)                                  # num_applicable_ops_minus1
    bw.u(0, 3)                                # op temporal_id
    bw.ue(0)                                  # num_target_views_minus1
    bw.ue(1)                                  # target view id
    bw.ue(1)                                  # op num_views_minus1
    bw.flag(0)                                # mvc_vui_parameters_present
    bw.flag(0)                                # additional_extension2_flag
    bw.rbsp_trailing_bits()
    return bw.get_bytes()


def _write_sps_data(bw: BitWriter, sps, scaling) -> None:
    """seq_parameter_set_data (spec 7.3.2.1.1), the FRExt block for
    profiles 100, 122 and 128."""
    bw.u(sps.profile_idc, 8)
    bw.u(sps.constraint_set_flags, 8)
    bw.u(sps.level_idc, 8)
    bw.ue(sps.seq_parameter_set_id)
    if sps.profile_idc in (100, 122, 128):
        bw.ue(sps.chroma_format_idc)
        bw.ue(sps.bit_depth_luma_minus8)
        bw.ue(sps.bit_depth_chroma_minus8)
        bw.flag(sps.qpprime_y_zero_transform_bypass_flag)
        if sps.seq_scaling_matrix_present_flag and scaling:
            bw.flag(1)
            _write_scaling_lists(bw, scaling, 8)
        else:
            bw.flag(0)                    # seq_scaling_matrix_present_flag
    bw.ue(sps.log2_max_frame_num_minus4)
    bw.ue(sps.pic_order_cnt_type)
    if sps.pic_order_cnt_type == 0:
        bw.ue(sps.log2_max_pic_order_cnt_lsb_minus4)
    elif sps.pic_order_cnt_type == 1:
        # spec 7.3.2.1.1 expected-POC-cycle syntax
        bw.flag(sps.delta_pic_order_always_zero_flag)
        bw.se(sps.offset_for_non_ref_pic)
        bw.se(sps.offset_for_top_to_bottom_field)
        bw.ue(len(sps.offset_for_ref_frame))
        for off in sps.offset_for_ref_frame:
            bw.se(off)
    bw.ue(sps.max_num_ref_frames)
    bw.flag(sps.gaps_in_frame_num_value_allowed_flag)
    bw.ue(sps.pic_width_in_mbs_minus1)
    bw.ue(sps.pic_height_in_map_units_minus1)
    bw.flag(sps.frame_mbs_only_flag)
    if not sps.frame_mbs_only_flag:
        bw.flag(sps.mb_adaptive_frame_field_flag)
    bw.flag(sps.direct_8x8_inference_flag)
    bw.flag(sps.frame_cropping_flag)
    if sps.frame_cropping_flag:
        bw.ue(sps.frame_crop_left_offset)
        bw.ue(sps.frame_crop_right_offset)
        bw.ue(sps.frame_crop_top_offset)
        bw.ue(sps.frame_crop_bottom_offset)
    if sps.vui:
        bw.flag(1)                             # vui_parameters_present
        _write_vui(bw, sps.vui)
    else:
        bw.flag(0)


def _write_vui(bw: BitWriter, v: dict) -> None:
    """Vui_parameters (spec E.1.1) of a dict with the keys of the
    decoder's VUI parse; lencod parset.c GenerateVUI_parameters_rbsp:1048
    field order (jm_tpu/encoder/syntax.py _write_vui)."""
    if "aspect_ratio_idc" in v:
        bw.flag(1)
        bw.u(v["aspect_ratio_idc"], 8)
        if v["aspect_ratio_idc"] == 255:
            bw.u(v["sar_width"], 16)
            bw.u(v["sar_height"], 16)
    else:
        bw.flag(0)
    if "overscan_appropriate" in v:
        bw.flag(1)
        bw.flag(v["overscan_appropriate"])
    else:
        bw.flag(0)
    if "video_format" in v:
        bw.flag(1)
        bw.u(v["video_format"], 3)
        bw.flag(v.get("video_full_range", 0))
        if "colour_primaries" in v:
            bw.flag(1)
            bw.u(v["colour_primaries"], 8)
            bw.u(v["transfer_characteristics"], 8)
            bw.u(v["matrix_coefficients"], 8)
        else:
            bw.flag(0)
    else:
        bw.flag(0)
    if "chroma_sample_loc_type_top" in v:
        bw.flag(1)
        bw.ue(v["chroma_sample_loc_type_top"])
        bw.ue(v["chroma_sample_loc_type_bottom"])
    else:
        bw.flag(0)
    if "num_units_in_tick" in v:
        bw.flag(1)
        bw.u(v["num_units_in_tick"], 32)
        bw.u(v["time_scale"], 32)
        bw.flag(v.get("fixed_frame_rate", 1))
    else:
        bw.flag(0)

    def hrd(h):
        bw.ue(h["cpb_cnt"] - 1)
        bw.u(h["bit_rate_scale"], 4)
        bw.u(h["cpb_size_scale"], 4)
        for br_v, cpb_v, cbr_v in h["cpb"]:
            bw.ue(br_v)
            bw.ue(cpb_v)
            bw.flag(cbr_v)
        bw.u(h["initial_cpb_removal_delay_length"] - 1, 5)
        bw.u(h["cpb_removal_delay_length"] - 1, 5)
        bw.u(h["dpb_output_delay_length"] - 1, 5)
        bw.u(h["time_offset_length"], 5)

    for key in ("nal_hrd", "vcl_hrd"):
        if key in v:
            bw.flag(1)
            hrd(v[key])
        else:
            bw.flag(0)
    if "nal_hrd" in v or "vcl_hrd" in v:
        bw.flag(v.get("low_delay_hrd", 0))
    bw.flag(v.get("pic_struct_present", 0))
    if "max_dec_frame_buffering" in v:
        bw.flag(1)
        bw.flag(v.get("motion_vectors_over_pic_boundaries", 1))
        bw.ue(v.get("max_bytes_per_pic_denom", 0))
        bw.ue(v.get("max_bits_per_mb_denom", 0))
        bw.ue(v.get("log2_max_mv_length_horizontal", 16))
        bw.ue(v.get("log2_max_mv_length_vertical", 16))
        bw.ue(v.get("max_num_reorder_frames", 0))
        bw.ue(v["max_dec_frame_buffering"])
    else:
        bw.flag(0)


def write_pps(pps, scaling=None) -> bytes:
    """Pic_parameter_set_rbsp with FMO slice groups of map types 0-6 and,
    with the 8x8 transform or scaling lists, the High extension:
    transform_8x8_mode_flag, the lists (scaling: as write_sps takes them,
    for a PPS with pic_scaling_matrix_present_flag) and
    second_chroma_qp_index_offset (lencod parset.c
    GeneratePic_parameter_set_rbsp; jm_tpu/encoder/syntax.py
    write_pps)."""
    bw = BitWriter()
    bw.ue(pps.pic_parameter_set_id)
    bw.ue(pps.seq_parameter_set_id)
    bw.flag(pps.entropy_coding_mode_flag)
    bw.flag(pps.bottom_field_pic_order_in_frame_present_flag)
    bw.ue(pps.num_slice_groups_minus1)
    if pps.num_slice_groups_minus1 > 0:
        # slice-group syntax (spec 7.3.2.2; lencod/src/parset.c:877)
        t = pps.slice_group_map_type
        bw.ue(t)
        if t == 0:
            for r in pps.run_length_minus1:
                bw.ue(r)
        elif t == 2:
            for tl, br_ in zip(pps.top_left, pps.bottom_right):
                bw.ue(tl)
                bw.ue(br_)
        elif t in (3, 4, 5):
            bw.flag(pps.slice_group_change_direction_flag)
            bw.ue(pps.slice_group_change_rate_minus1)
        elif t == 6:
            ids = pps.slice_group_id
            bw.ue(len(ids) - 1)
            nbits = max(1, pps.num_slice_groups_minus1.bit_length())
            for g in ids:
                bw.u(g, nbits)
    bw.ue(pps.num_ref_idx_l0_default_active_minus1)
    bw.ue(pps.num_ref_idx_l1_default_active_minus1)
    bw.flag(pps.weighted_pred_flag)
    bw.u(pps.weighted_bipred_idc, 2)
    bw.se(pps.pic_init_qp_minus26)
    bw.se(pps.pic_init_qs_minus26)
    bw.se(pps.chroma_qp_index_offset)
    bw.flag(pps.deblocking_filter_control_present_flag)
    bw.flag(pps.constrained_intra_pred_flag)
    bw.flag(pps.redundant_pic_cnt_present_flag)
    lists = pps.pic_scaling_matrix_present_flag and scaling
    if pps.transform_8x8_mode_flag or lists:
        bw.flag(pps.transform_8x8_mode_flag)
        bw.flag(1 if lists else 0)
        if lists:
            _write_scaling_lists(bw, scaling,
                                 6 + 2 * pps.transform_8x8_mode_flag)
        bw.se(pps.cr_qp_offset)           # second_chroma_qp_index_offset
    bw.rbsp_trailing_bits()
    return bw.get_bytes()


def _write_pred_weight_table(bw: BitWriter, slice_type: SliceType, wp_l0,
                             wp_l1, num_l0: int, num_l1: int) -> None:
    """Spec 7.3.3.2 at denominator 5 (encoder/wp_est.py), 4:2:0: a flag
    and the weight and offset of each component whose entry is not the
    default (jm_tpu/encoder/syntax.py _write_pred_weight_table; lencod
    header.c pred_weight_table)."""
    bw.ue(LUMA_DENOM)
    bw.ue(CHROMA_DENOM)
    dl, dc = 1 << LUMA_DENOM, 1 << CHROMA_DENOM
    lists = ((wp_l0, num_l0), (wp_l1, num_l1)) \
        if slice_type == SliceType.B else ((wp_l0, num_l0),)
    for table, nref in lists:
        for r in range(nref):
            e = table[r] if r < len(table) else {
                "luma": (dl, 0), "chroma": ((dc, 0), (dc, 0))}
            lw, lo = e["luma"]
            bw.flag(1 if (lw, lo) != (dl, 0) else 0)
            if (lw, lo) != (dl, 0):
                bw.se(lw)
                bw.se(lo)
            cws = [tuple(c) for c in e["chroma"]]
            nondefault = any(c != (dc, 0) for c in cws)
            bw.flag(1 if nondefault else 0)
            if nondefault:
                for cw, co in cws:
                    bw.se(cw)
                    bw.se(co)


def write_slice_header(bw: BitWriter, sps, pps, *, slice_type: SliceType,
                       frame_num: int, idr: bool, idr_pic_id: int = 0,
                       qp: int, first_mb: int = 0, poc_lsb: int = 0,
                       num_ref_idx_l0: int = 1, cabac_init_idc: int = 0,
                       slice_group_change_cycle: int = 0,
                       is_ref: bool = True, long_term_flag: int = 0,
                       mmco_ops=None, ref_mod_l0=None,
                       redundant_pic_cnt: int = 0, num_ref_idx_l1: int = 1,
                       ref_mod_l1=None, wp_l0=None, wp_l1=None,
                       field_pic: int = 0, bottom_field: int = 0,
                       qs: int = 0) -> None:
    """Spec 7.3.3 slice header of an I, P, SP or B slice of a frame picture,
    or under an SPS without frame_mbs_only_flag of a field picture
    (field_pic 1, bottom_field its parity; lencod/src/header.c:116
    SliceHeader): pic_order_cnt_lsb for POC
    type 0 only, redundant_pic_cnt when the PPS has the flag; for B
    direct_spatial_mv_pred_flag 1 and the list-1 active count;
    ref_mod_l0 / ref_mod_l1 the (modification_of_pic_nums_idc, value)
    commands of each list (idc 4 / 5 an MVC view-1 slice's inter-view
    ones), dec_ref_pic_marking for reference slices only
    (is_ref): the IDR's long_term_flag, else the MMCO commands mmco_ops
    ((op, value1[, value2]) tuples) or the sliding window;
    cabac_init_idc for P and B slices of a CABAC PPS,
    slice_group_change_cycle for FMO map types 3-5; the pred_weight_table
    of wp_l0 / wp_l1 (each active reference's {"luma": (w, o), "chroma":
    ((w, o), (w, o))}, a missing entry the default) in a P slice of a PPS
    with weighted_pred_flag and a B slice of one with weighted_bipred_idc
    1. An SP slice is written as a P slice, with sp_for_switch_flag 0 (as
    jm_tpu/encoder/syntax.py:389-392 writes it) and the slice_qs_delta of
    the switching QP qs after slice_qp_delta."""
    bw.ue(first_mb)
    bw.ue(int(slice_type) + 5)      # all slices in picture share the type
    bw.ue(pps.pic_parameter_set_id)
    bw.u(frame_num, sps.log2_max_frame_num_minus4 + 4)
    if not sps.frame_mbs_only_flag:
        bw.flag(field_pic)
        if field_pic:
            bw.flag(bottom_field)
    if idr:
        bw.ue(idr_pic_id)
    if sps.pic_order_cnt_type == 0:
        bw.u(poc_lsb, sps.log2_max_pic_order_cnt_lsb_minus4 + 4)
    if pps.redundant_pic_cnt_present_flag:
        bw.ue(redundant_pic_cnt)
    is_b = slice_type == SliceType.B
    if is_b:
        bw.flag(1)                  # direct_spatial_mv_pred_flag
    p_like = slice_type in (SliceType.P, SliceType.SP)
    if p_like or is_b:
        override = ((num_ref_idx_l0 - 1) !=
                    pps.num_ref_idx_l0_default_active_minus1)
        if is_b:
            override = override or ((num_ref_idx_l1 - 1) !=
                                    pps.num_ref_idx_l1_default_active_minus1)
        bw.flag(1 if override else 0)
        if override:
            bw.ue(num_ref_idx_l0 - 1)
            if is_b:
                bw.ue(num_ref_idx_l1 - 1)
        # ref_pic_list_modification (spec 7.3.3.1)
        for mods in (ref_mod_l0, ref_mod_l1) if is_b else (ref_mod_l0,):
            bw.flag(1 if mods else 0)
            if mods:
                for idc, val in mods:
                    bw.ue(idc)
                    bw.ue(val)
                bw.ue(3)
    if (pps.weighted_pred_flag and p_like) or \
            (pps.weighted_bipred_idc == 1 and is_b):
        _write_pred_weight_table(bw, slice_type, wp_l0 or [], wp_l1 or [],
                                 num_ref_idx_l0, num_ref_idx_l1)
    if is_ref:
        if idr:
            bw.flag(0)              # no_output_of_prior_pics
            bw.flag(long_term_flag)
        elif mmco_ops:
            # dec_ref_pic_marking, adaptive mode (spec 7.3.3.3; lencod
            # header.c dec_ref_pic_marking:373)
            bw.flag(1)
            for op in mmco_ops:
                bw.ue(op[0])
                if op[0] in (1, 2, 3, 4, 6):
                    bw.ue(op[1])
                if op[0] == 3:
                    bw.ue(op[2])
            bw.ue(0)                # end of the commands
        else:
            bw.flag(0)              # adaptive_ref_pic_marking_mode_flag
    if pps.entropy_coding_mode_flag and slice_type != SliceType.I:
        bw.ue(cabac_init_idc)
    bw.se(qp - 26 - pps.pic_init_qp_minus26)
    if slice_type == SliceType.SP:
        bw.flag(0)                  # sp_for_switch_flag
        bw.se(qs - 26 - pps.pic_init_qs_minus26)
    if pps.deblocking_filter_control_present_flag:
        # the encoder only raises the control flag to switch the loop
        # filter OFF (LoopFilterDisable; lencod header.c DeblockFilter)
        bw.ue(1)
    if pps.num_slice_groups_minus1 > 0 and \
            pps.slice_group_map_type in (3, 4, 5):
        units = sps.pic_width_in_mbs * sps.frame_height_in_mbs
        rate = pps.slice_group_change_rate_minus1 + 1
        # JM: len = Ceil(units / rate), CeilLog2(len + 1) bits (lencod
        # header.c:243, ldecod header.c:326-332)
        max_cycle = -(-units // rate)
        nbits = max(1, max_cycle.bit_length())
        bw.u(slice_group_change_cycle, nbits)


class MBWriter:
    """Serializes decided macroblocks of one slice in the order given.
    With data partitions (bw_b / bw_c set) the residual of intra MBs goes
    to partition B and of inter MBs to partition C (lencod header.c:37
    assignSE2partition_DP); everything else stays in bw (partition A)."""

    # P partitions per mb_type: (bx, by, bw, bh) in 4x4-block units
    PARTS = {0: [(0, 0, 4, 4)],
             1: [(0, 0, 4, 2), (0, 2, 4, 2)],
             2: [(0, 0, 2, 4), (2, 0, 2, 4)],
             3: [(0, 0, 2, 2), (2, 0, 2, 2), (0, 2, 2, 2), (2, 2, 2, 2)]}

    def __init__(self, bw: BitWriter, pic, sps, pps, slice_qp: int):
        self.bw = bw
        self.pic = pic
        self.sps = sps
        self.pps = pps
        self.pctx = PredCtx(pic)
        self.qp = slice_qp          # running QP for delta coding
        self.skip_run = 0
        self.bw_b = None
        self.bw_c = None

    # ---- residual ---------------------------------------------------------

    def _res_bw(self, addr: int) -> BitWriter:
        if self.bw_b is None:
            return self.bw
        return self.bw_b if self.pic.mb_class[addr] != MB_INTER else self.bw_c

    def _write_luma_residual(self, addr: int, cbp: int, is_i16: bool) -> None:
        pic, bw = self.pic, self._res_bw(addr)
        if is_i16:
            nc = self.pctx.nc_luma(addr, 0)
            write_residual_block(bw, pic.luma_dc[addr], nc, 16)
        for blk8 in range(4):
            if not (cbp & (1 << blk8)):
                continue
            for sub in range(4):
                blk = int(CODE2RASTER[blk8 * 4 + sub])
                nc = self.pctx.nc_luma(addr, blk)
                if is_i16:
                    write_residual_block(bw, pic.luma_coef[addr, blk, 1:], nc, 15)
                else:
                    write_residual_block(bw, pic.luma_coef[addr, blk], nc, 16)

    def _write_luma_residual_8x8(self, addr: int, cbp: int) -> None:
        """Each coded 8x8 as four interleaved 4x4 blocks: 4x4 block sub
        holds every fourth level of the 8x8 scan from sub (the inverse of
        decoder/mb_parse.py _read_luma_residual_8x8)."""
        pic, bw = self.pic, self._res_bw(addr)
        for blk8 in range(4):
            if not (cbp & (1 << blk8)):
                continue
            by0, bx0 = (blk8 // 2) * 2, (blk8 % 2) * 2
            for sub in range(4):
                blk = (by0 + sub // 2) * 4 + bx0 + sub % 2
                write_residual_block(bw, pic.luma_coef8[addr, blk8, sub::4],
                                     self.pctx.nc_luma(addr, blk), 16)

    def _write_inter_residual(self, addr: int, allow8: bool = True) -> None:
        """coded_block_pattern, transform_size_8x8_flag (with the PPS's
        8x8 transform, coded luma and no partition below 8x8),
        mb_qp_delta and the residual of an inter MB."""
        pic, bw = self.pic, self.bw
        cbp = int(pic.cbp[addr])
        bw.ue(CBP_INV_CHROMA_INTER[cbp])
        if self.pps.transform_8x8_mode_flag and cbp & 15 and allow8:
            bw.flag(1 if pic.transform8x8[addr] else 0)
        if cbp:
            self._write_qp_delta(addr)
        if pic.transform8x8[addr]:
            self._write_luma_residual_8x8(addr, cbp & 15)
        else:
            self._write_luma_residual(addr, cbp & 15, is_i16=False)
        self._write_chroma_residual(addr, cbp)

    def _write_chroma_residual(self, addr: int, cbp: int) -> None:
        """The chroma DC (2x2 with nC -1, or 2x4 with nC -2 at 4:2:2),
        then 2 n_crows AC blocks per component."""
        pic, bw = self.pic, self._res_bw(addr)
        cbp_chroma = cbp >> 4
        n_dc = 2 * pic.n_crows
        if cbp_chroma & 3:
            for comp in range(2):
                write_residual_block(bw, pic.chroma_dc[addr, comp],
                                     -1 if n_dc == 4 else -2, n_dc)
        if cbp_chroma & 2:
            for comp in range(2):
                for blk in range(n_dc):
                    nc = self.pctx.nc_chroma(addr, comp, blk)
                    write_residual_block(
                        bw, pic.chroma_coef[addr, comp, blk, 1:], nc, 15)

    def _write_qp_delta(self, addr: int) -> None:
        dq = int(self.pic.qp[addr]) - self.qp
        if dq > 25:
            dq -= 52
        elif dq < -26:
            dq += 52
        self.bw.se(dq)
        self.qp = int(self.pic.qp[addr])

    # ---- intra ------------------------------------------------------------

    def _write_intra_mb(self, addr: int, base: int) -> None:
        """base: the mb_type offset of the intra types in the slice (0 I,
        5 P, 23 B)."""
        pic, bw = self.pic, self.bw
        if pic.mb_class[addr] == MB_IPCM:    # I_PCM: aligned raw samples
            bw.ue(base + 25)
            bw.align_zero()                  # pcm_alignment_zero_bit
            for v in pic.ipcm_luma[addr].ravel():
                bw.u(int(v), 8)
            for v in pic.ipcm_chroma[addr].ravel():
                bw.u(int(v), 8)
            return
        if pic.mb_class[addr] == 1:          # I_NxN (4x4)
            bw.ue(base + 0)
            if self.pps.transform_8x8_mode_flag:
                bw.flag(0)                   # transform_size_8x8_flag
            for code_idx in range(16):
                blk = int(CODE2RASTER[code_idx])
                mode = int(pic.i4_modes[addr, blk])
                pred = self.pctx.pred_intra4_mode(addr, blk)
                if mode == pred:
                    bw.flag(1)
                else:
                    bw.flag(0)
                    rem = mode if mode < pred else mode - 1
                    bw.u(rem, 3)
            bw.ue(int(pic.chroma_mode[addr]))
            cbp = int(pic.cbp[addr])
            bw.ue(CBP_INV_CHROMA_INTRA[cbp])
            if cbp:
                self._write_qp_delta(addr)
            self._write_luma_residual(addr, cbp & 15, is_i16=False)
            self._write_chroma_residual(addr, cbp)
        elif pic.mb_class[addr] == 2:         # I_16x16
            cbp = int(pic.cbp[addr])
            cbp_luma_flag = 1 if (cbp & 15) else 0
            k = 1 + int(pic.i16_mode[addr]) + ((cbp >> 4) << 2) + cbp_luma_flag * 12
            bw.ue(base + k)
            bw.ue(int(pic.chroma_mode[addr]))
            self._write_qp_delta(addr)
            self._write_luma_residual(addr, cbp & 15, is_i16=True)
            self._write_chroma_residual(addr, cbp)
        else:
            raise ValueError(f"MB {addr}: unsupported intra class "
                             f"{int(pic.mb_class[addr])}")

    # ---- inter (P: 16x16/16x8/8x16/8x8 with its sub-macroblocks) ---------

    def _write_p_inter_mb(self, addr: int, num_ref: int) -> None:
        """mb_type, the ref_idx of each partition as te(v) when more than
        one reference is active, with P_8x8 the sub_mb_types first and
        each sub-partition's mvd (spec 7.3.5.1-2), then the residual."""
        pic, bw = self.pic, self.bw
        mode = max(int(pic.inter_mode[addr]), 0)
        bw.ue(mode)
        if mode == 3:
            for q in range(4):
                bw.ue(int(pic.sub_mode[addr, q]))
            if num_ref > 1:
                for q in range(4):
                    bw.te(int(pic.ref_idx[addr, q]), num_ref - 1)
            parts = [((q % 2) * 2 + sx, (q // 2) * 2 + sy, sw, sh)
                     for q in range(4)
                     for (sx, sy, sw, sh) in SUB_PARTS[int(pic.sub_mode[addr,
                                                                        q])]]
        else:
            parts = self.PARTS[mode]
            if num_ref > 1:
                for (bx, by, _bw, _bh) in parts:
                    bw.te(int(pic.ref_idx[addr, (by // 2) * 2 + bx // 2]),
                          num_ref - 1)
        for (bx, by, bw_, bh_) in parts:
            ref = int(pic.ref_idx[addr, (by // 2) * 2 + bx // 2])
            pred = self.pctx.mv_pred(addr, bx, by, bw_, bh_, ref)
            mv = pic.mv[addr, by * 4 + bx]
            bw.se(int(mv[0] - pred[0]))
            bw.se(int(mv[1] - pred[1]))
        self._write_inter_residual(
            addr, allow8=mode != 3 or not pic.sub_mode[addr].any())

    def _write_b_inter_mb(self, addr: int) -> None:
        """B_Direct_16x16, or a 16x16 partition of list 0, list 1 or both
        with one reference each (jm_tpu syntax.py _write_b_inter_mb)."""
        pic, bw = self.pic, self.bw
        if pic.b_direct[addr]:
            bw.ue(0)
        else:
            pd = int(pic.pdir[addr, 0])
            bw.ue(B_MBTYPE_16x16[pd])
            for lst, use in enumerate(((PD_L0, PD_BI), (PD_L1, PD_BI))):
                if pd not in use:
                    continue
                ref = int((pic.ref_idx if lst == 0 else
                           pic.ref_idx_l1)[addr, 0])
                pred = self.pctx.mv_pred(addr, 0, 0, 4, 4, ref, lst)
                mv = (pic.mv if lst == 0 else pic.mv_l1)[addr, 0]
                bw.se(int(mv[0] - pred[0]))
                bw.se(int(mv[1] - pred[1]))
        self._write_inter_residual(addr)

    # ---- MB dispatch -------------------------------------------------------

    def write_mb(self, addr: int, slice_type: SliceType,
                 num_ref: int = 1) -> None:
        """MB addr of a slice of slice_type with num_ref active list-0
        references (a P slice's; a B slice's lists hold one each)."""
        pic, bw = self.pic, self.bw
        if slice_type == SliceType.I:
            self._write_intra_mb(addr, 0)
            return
        if pic.skip[addr]:
            self.skip_run += 1
            return
        bw.ue(self.skip_run)
        self.skip_run = 0
        is_b = slice_type == SliceType.B
        if pic.mb_class[addr] != MB_INTER:
            self._write_intra_mb(addr, 23 if is_b else 5)
        elif is_b:
            self._write_b_inter_mb(addr)
        else:
            self._write_p_inter_mb(addr, num_ref)

    def finish(self, slice_type: SliceType) -> None:
        if slice_type != SliceType.I and self.skip_run > 0:
            self.bw.ue(self.skip_run)
            self.skip_run = 0


def serialize_slice(pic, sps, pps, *, slice_type: SliceType, frame_num: int,
                    idr: bool, qp: int, poc_lsb: int = 0, idr_pic_id: int = 0,
                    num_ref_idx_l0: int = 1, mb_addrs=None,
                    native: bool = True, **header) -> bytes:
    """Serialize one slice; mb_addrs: its MB addresses in decode order
    (default: the whole picture in raster order); header: the further
    keywords of write_slice_header (slice_group_change_cycle, marking,
    list modification, redundant_pic_cnt, the list-1 keywords of a B
    slice). Returns the RBSP. The MB layer of an I, P or SP slice (an SP
    slice's is a P slice's; counted in native.routes["sp"]["serialize"]
    too) goes
    through the native cavlc_slice_data (jm_tpu_torch/native,
    jm_enc.cpp) unless a MB of the slice is I_PCM or the caller asks for
    the Python MBWriter (native=False); native.routes["serialize"] counts
    the route taken. A B slice takes the Python MBWriter, counted in
    native.routes["b"]["serialize"]."""
    addrs = np.ascontiguousarray(
        np.arange(pic.n_mbs) if mb_addrs is None else mb_addrs, np.int32)
    bw = BitWriter()
    write_slice_header(bw, sps, pps, slice_type=slice_type,
                       frame_num=frame_num, idr=idr, idr_pic_id=idr_pic_id,
                       qp=qp, first_mb=int(addrs[0]), poc_lsb=poc_lsb,
                       num_ref_idx_l0=num_ref_idx_l0, **header)
    if slice_type == SliceType.SP:
        N.routes["sp"]["serialize"] += 1
    if slice_type == SliceType.B:
        N.routes["b"]["serialize"] += 1
    elif native and not (pic.mb_class[addrs] == MB_IPCM).any():
        N.routes["serialize"]["native"] += 1
        return _native_slice_data(bw, pic, pps, slice_type, qp,
                                  num_ref_idx_l0, addrs)
    else:
        N.routes["serialize"]["python"] += 1
    w = MBWriter(bw, pic, sps, pps, qp)
    for addr in addrs:
        w.write_mb(int(addr), slice_type, num_ref_idx_l0)
    w.finish(slice_type)
    bw.rbsp_trailing_bits()
    return bw.get_bytes()


def serialize_slice_dp(pic, sps, pps, *, slice_type: SliceType,
                       slice_id: int, qp: int, num_ref_idx_l0: int = 1,
                       mb_addrs=None, **header) -> list:
    """Serialize one slice as three data partitions (jm_tpu/encoder/
    syntax.py serialize_slice_dp; lencod header.c Partition_BC_Header:596):
    A holds the slice header (header: the keywords of write_slice_header;
    an SP slice counts in native.routes["sp"]["serialize"] too),
    slice_id and the MB headers, MVDs and CBPs; B the residual of the
    intra MBs and C of the inter MBs, each after its slice_id. Returns
    the three RBSPs, b"" for a partition that received no residual. The
    MB layer is the Python MBWriter (the native serializer has no
    partitions); native.routes["dp"]["serialize"] counts the slices."""
    addrs = [int(a) for a in (range(pic.n_mbs) if mb_addrs is None
                              else mb_addrs)]
    N.routes["dp"]["serialize"] += 1
    if slice_type == SliceType.SP:
        N.routes["sp"]["serialize"] += 1
    bw = BitWriter()
    write_slice_header(bw, sps, pps, slice_type=slice_type, qp=qp,
                       first_mb=addrs[0], num_ref_idx_l0=num_ref_idx_l0,
                       **header)
    bw.ue(slice_id)
    bwb, bwc = BitWriter(), BitWriter()
    bwb.ue(slice_id)
    bwc.ue(slice_id)
    id_bits = bwb.bitpos
    w = MBWriter(bw, pic, sps, pps, qp)
    w.bw_b, w.bw_c = bwb, bwc
    for addr in addrs:
        w.write_mb(addr, slice_type, num_ref_idx_l0)
    w.finish(slice_type)
    out = []
    for b in (bw, bwb, bwc):
        if b is not bw and b.bitpos <= id_bits:
            out.append(b"")
        else:
            b.rbsp_trailing_bits()
            out.append(b.get_bytes())
    return out


def _native_slice_data(bw: BitWriter, pic, pps, slice_type: SliceType,
                       qp: int, num_ref: int, addrs: np.ndarray) -> bytes:
    """The slice's MB layer and trailing bits appended by the native
    serializer to the header in ``bw`` (handed over as its bytes and
    its pending bits); returns the RBSP (jm_tpu/encoder/syntax.py
    _native_slice_data)."""
    c = np.ascontiguousarray
    pic_dict = {
        "mb_class": c(pic.mb_class, np.int8),
        "skip": c(pic.skip, np.uint8),
        "inter_mode": c(pic.inter_mode, np.int8),
        "sub_mode": c(pic.sub_mode, np.int8),
        "ref_idx": c(pic.ref_idx, np.int8),
        "mv": c(pic.mv, np.int32),
        "cbp": c(pic.cbp, np.int32),
        "qp": c(pic.qp, np.int32),
        "slice_id": c(pic.slice_id, np.int32),
        "i4_modes": c(pic.i4_modes, np.int8),
        "i16_mode": c(pic.i16_mode, np.int8),
        "chroma_mode": c(pic.chroma_mode, np.int8),
        "luma_coef": c(pic.luma_coef, np.int32),
        "luma_dc": c(pic.luma_dc, np.int32),
        "luma_coef8": c(pic.luma_coef8, np.int32),
        "transform8x8": c(pic.transform8x8, np.uint8),
        "luma_nnz": c(pic.luma_nnz, np.int32),
        "chroma_dc": c(pic.chroma_dc, np.int32),
        "chroma_coef": c(pic.chroma_coef, np.int32),
        "chroma_nnz": c(pic.chroma_nnz, np.int32),
        "mb_w": pic.mb_w,
        "crows": pic.n_crows,
    }
    return N.load().cavlc_slice_data(
        bytes(bw.buf), bw.acc, bw.nacc, pic_dict, addrs,
        0 if slice_type in (SliceType.P, SliceType.SP) else 2, int(num_ref),
        int(pps.transform_8x8_mode_flag), int(qp))
