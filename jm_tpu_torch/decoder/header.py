"""Slice header parsing (spec 7.3.3), POC derivation (spec 8.2.1) and the
decoder's scope check; twin of jm_tpu/decoder/header.py for frame
pictures of I, P and B slices, CAVLC or CABAC, and the field pictures of
PAFF streams (field_pic_flag, bottom_field_flag) of CAVLC I and P slices
at 4:2:0 and 8 bits (ldecod/src/header.c
FirstPartOfSliceHeader:76, RestOfSliceHeader:113,
ref_pic_list_reordering:350, decode_poc:720).

The header carries what the reference-management layer reads: the
redundant_pic_cnt, ref_pic_list_modification with short-term (idc 0, 1),
long-term (idc 2) and MVC inter-view (idc 4, 5) commands (an MVC slice
extension, NAL 20, whose non_idr_flag is 0 takes the IDR form of the
header), and dec_ref_pic_marking (an IDR's
long_term_reference_flag, MMCO ops 1-6; ldecod header.c
dec_ref_pic_marking:635). What the decoder does not cover raises
NotImplementedError naming the construct, before the slice's picture is
decoded: ``check_scope`` for what the SPS / PPS declare, ``check_field``
for MBAFF frames and what field pictures do not cover, the header parse
for SI slices and a field's list modification (a field's MMCO
raises when its picture is finished, as in jm_tpu). An SP slice (the
Extended profile's switching pictures) reads as a P slice, with
sp_for_switch_flag and slice_qs_delta after slice_qp_delta; an SI slice
raises, as jm_tpu parses none. A B slice adds direct_spatial_mv_pred_flag,
num_ref_idx_l1_active_minus1 and the list-1 modification commands; a P
slice of a PPS with weighted_pred_flag, and a B slice of one with
weighted_bipred_idc 1, the pred_weight_table (spec 7.3.3.2).
"""

from __future__ import annotations

from ..bitstream.bitreader import BitReader
from ..bitstream.nal import NalUnit, NalUnitType
from ..common.types import (MMCOOp, PPS, SPS, RefPicListMod, SliceHeader,
                            SliceType)


def check_scope(sps: SPS, pps: PPS,
                slice_type: SliceType = SliceType.I) -> None:
    """Raise NotImplementedError naming every construct of this SPS / PPS
    pair, for a slice of slice_type, that the decoder does not cover.
    constrained_intra_pred_flag is read in an I slice, where every
    neighbour is intra and the flag changes nothing; a P, B or SP slice
    under it raises (jm_tpu ignores the flag there, against spec
    8.3.1.2)."""
    out = []
    if sps.chroma_format_idc not in (1, 2):
        out.append(f"chroma_format_idc {sps.chroma_format_idc} "
                   "(4:2:0 and 4:2:2 only)")
    if sps.bit_depth_luma_minus8 > 6 or sps.bit_depth_chroma_minus8 > 6:
        out.append("bit depth above 14 (no conforming profile)")
    if pps.constrained_intra_pred_flag and slice_type != SliceType.I:
        out.append("constrained intra prediction in a "
                   f"{slice_type.name} slice")
    if out:
        raise NotImplementedError("out of scope: " + ", ".join(out))


def check_field(h: SliceHeader, sps: SPS, pps: PPS) -> None:
    """Raise NotImplementedError naming what this slice's picture
    structure needs and the decoder does not cover: MBAFF frames (an SPS
    with mb_adaptive_frame_field_flag, as in jm_tpu), and of field
    pictures CABAC and B slices (as in jm_tpu) and the 8x8 transform,
    whose field scan jm_tpu does not apply (jm_tpu/decoder/recon.py:231
    inverse-scans 8x8 blocks with the frame zig-zag; spec 8.5.7). Field
    pictures at 4:2:2 and at 9 to 14 bits are decoded."""
    if sps.mb_adaptive_frame_field_flag and not h.field_pic_flag:
        raise NotImplementedError("out of scope: MBAFF frames "
                                  "(mb_adaptive_frame_field_flag)")
    if not h.field_pic_flag:
        return
    out = []
    if pps.entropy_coding_mode_flag:
        out.append("CABAC field pictures")
    if h.slice_type == SliceType.B:
        out.append("B field pictures")
    if pps.transform_8x8_mode_flag:
        out.append("field pictures with the 8x8 transform (8x8 field "
                   "scan)")
    if out:
        raise NotImplementedError("out of scope: " + ", ".join(out))


def parse_slice_header(nal: NalUnit, sps_map: dict[int, SPS],
                       pps_map: dict[int, PPS]) -> tuple[SliceHeader, BitReader]:
    """Parse a slice header; returns (header, reader positioned at slice data)."""
    br = BitReader(nal.rbsp)
    h = SliceHeader()
    h.nal_ref_idc = nal.nal_ref_idc
    # an MVC slice extension with non_idr_flag 0 carries the IDR form of
    # the header (idr_pic_id, the IDR dec_ref_pic_marking; ldecod
    # header.c:651)
    h.is_idr = (nal.nal_unit_type == NalUnitType.IDR
                or (nal.nal_unit_type == NalUnitType.SLICE_EXT
                    and nal.mvc_ext is not None
                    and nal.mvc_ext["non_idr_flag"] == 0))

    h.first_mb_in_slice = br.ue()
    st = br.ue()
    h.slice_type_all = st >= 5
    h.slice_type = SliceType(st % 5)
    st = h.slice_type
    if st == SliceType.SI:
        # jm_tpu parses no SI slice either (jm_tpu/decoder/mb_parse.py:700)
        raise NotImplementedError("out of scope: SI slices")
    h.pic_parameter_set_id = br.ue()
    pps = pps_map[h.pic_parameter_set_id]
    sps = sps_map[pps.seq_parameter_set_id]
    check_scope(sps, pps, st)

    h.frame_num = br.u(sps.log2_max_frame_num_minus4 + 4)
    if not sps.frame_mbs_only_flag:
        h.field_pic_flag = br.flag()
        if h.field_pic_flag:
            h.bottom_field_flag = br.flag()
    check_field(h, sps, pps)
    frame_pic = not h.field_pic_flag
    if h.is_idr:
        h.idr_pic_id = br.ue()
    if sps.pic_order_cnt_type == 0:
        h.pic_order_cnt_lsb = br.u(sps.log2_max_pic_order_cnt_lsb_minus4 + 4)
        if pps.bottom_field_pic_order_in_frame_present_flag and frame_pic:
            h.delta_pic_order_cnt_bottom = br.se()
    elif sps.pic_order_cnt_type == 1 and not sps.delta_pic_order_always_zero_flag:
        d0 = br.se()
        d1 = 0
        if pps.bottom_field_pic_order_in_frame_present_flag and frame_pic:
            d1 = br.se()
        h.delta_pic_order_cnt = (d0, d1)
    if pps.redundant_pic_cnt_present_flag:
        h.redundant_pic_cnt = br.ue()

    if st == SliceType.B:
        h.direct_spatial_mv_pred_flag = br.flag()
    h.num_ref_idx_l0_active_minus1 = pps.num_ref_idx_l0_default_active_minus1
    h.num_ref_idx_l1_active_minus1 = pps.num_ref_idx_l1_default_active_minus1
    inter = st in (SliceType.P, SliceType.SP, SliceType.B)
    if inter:
        h.num_ref_idx_active_override_flag = br.flag()
        if h.num_ref_idx_active_override_flag:
            h.num_ref_idx_l0_active_minus1 = br.ue()
            if st == SliceType.B:
                h.num_ref_idx_l1_active_minus1 = br.ue()
        if br.flag():  # ref_pic_list_modification_flag_l0 (7.3.3.1)
            h.ref_pic_list_mod_l0 = _read_rplm(br)
            if h.field_pic_flag:
                # field PicNums count fields (spec 8.2.4.3): not covered,
                # as in jm_tpu (decoder.py:226-229)
                raise NotImplementedError(
                    "out of scope: field ref_pic_list_modification")
    if st == SliceType.B and br.flag():     # ..._flag_l1
        h.ref_pic_list_mod_l1 = _read_rplm(br)

    # pred_weight_table (7.3.3.2)
    if (pps.weighted_pred_flag and st in (SliceType.P, SliceType.SP)) or (
            pps.weighted_bipred_idc == 1 and st == SliceType.B):
        _read_pred_weight_table(br, h)

    # dec_ref_pic_marking (7.3.3.3)
    if nal.nal_ref_idc != 0:
        if h.is_idr:
            h.no_output_of_prior_pics_flag = br.flag()
            h.long_term_reference_flag = br.flag()
        else:
            h.adaptive_ref_pic_marking_mode_flag = br.flag()
            if h.adaptive_ref_pic_marking_mode_flag:
                h.mmco_ops = _read_mmco(br)

    if pps.entropy_coding_mode_flag and st != SliceType.I:
        h.cabac_init_idc = br.ue()
        if h.cabac_init_idc > 2:
            raise ValueError(f"cabac_init_idc {h.cabac_init_idc} out of range")
    h.slice_qp_delta = br.se()
    if st == SliceType.SP:
        h.sp_for_switch_flag = br.flag()
        h.slice_qs_delta = br.se()
    if pps.deblocking_filter_control_present_flag:
        h.disable_deblocking_filter_idc = br.ue()
        if h.disable_deblocking_filter_idc != 1:
            h.slice_alpha_c0_offset_div2 = br.se()
            h.slice_beta_offset_div2 = br.se()
    if pps.num_slice_groups_minus1 > 0 and \
            pps.slice_group_map_type in (3, 4, 5):
        units = sps.pic_width_in_mbs * sps.frame_height_in_mbs
        rate = pps.slice_group_change_rate_minus1 + 1
        # JM ldecod header.c:326-332: len = Ceil(units / rate), then
        # CeilLog2(len + 1) bits
        max_cycle = -(-units // rate)
        h.slice_group_change_cycle = br.u(max(1, max_cycle.bit_length()))
    return h, br


def _read_rplm(br: BitReader) -> list[RefPicListMod]:
    """The commands up to idc 3: short-term (0, 1), long-term (2) and, in
    an MVC view-1 slice, inter-view (4, 5: abs_diff_view_idx_minus1)."""
    out = []
    while True:
        idc = br.ue()
        if idc == 3:
            break
        if idc > 5:
            raise ValueError(f"ref_pic_list_modification idc {idc}")
        out.append(RefPicListMod(idc, br.ue()))
        if len(out) > 64:
            raise ValueError("runaway ref_pic_list_modification")
    return out


def _read_pred_weight_table(br: BitReader, h: SliceHeader) -> None:
    """The weights and offsets of every active reference of list 0 (and
    list 1 of a B slice), num_ref_idx_lX_active_minus1 + 1 entries after
    the slice's override; an entry without its flag takes the default
    weight 1 << denom and offset 0 (4:2:0: chroma always present)."""
    h.luma_log2_weight_denom = br.ue()
    h.chroma_log2_weight_denom = br.ue()
    for lst, nref in ((0, h.num_ref_idx_l0_active_minus1 + 1),
                      (1, h.num_ref_idx_l1_active_minus1 + 1)):
        if lst == 1 and h.slice_type != SliceType.B:
            break
        table = []
        for _ in range(nref):
            lw, lo = 1 << h.luma_log2_weight_denom, 0
            if br.flag():           # luma_weight_flag
                lw, lo = br.se(), br.se()
            cw = [[1 << h.chroma_log2_weight_denom, 0] for _ in range(2)]
            if br.flag():           # chroma_weight_flag
                for j in range(2):
                    cw[j] = [br.se(), br.se()]
            table.append({"luma": (lw, lo), "chroma": cw})
        if lst == 0:
            h.wp_l0 = table
        else:
            h.wp_l1 = table


def _read_mmco(br: BitReader) -> list[MMCOOp]:
    """The memory_management_control_operation commands up to op 0."""
    ops = []
    while True:
        op = br.ue()
        if op == 0:
            break
        if op > 6 or len(ops) >= 66:
            raise ValueError(f"invalid MMCO command list (op {op})")
        m = MMCOOp(op)
        if op in (1, 2, 3, 4, 6):
            m.value1 = br.ue()
        if op == 3:
            m.value2 = br.ue()
        ops.append(m)
    return ops


class PocContext:
    """POC derivation state machine (spec 8.2.1) of frame and field
    pictures (a field's POC is computed as a frame's, as jm_tpu does)."""

    def __init__(self) -> None:
        self.msb = 0
        self.prev_lsb = 0
        self.prev_frame_num = 0
        self.prev_frame_num_offset = 0

    def compute(self, h: SliceHeader, sps: SPS) -> int:
        """Returns the frame POC (TopFieldOrderCnt for types 0 and 2, the
        smaller of top and bottom for type 1)."""
        if sps.pic_order_cnt_type == 0:
            max_lsb = sps.max_poc_lsb
            if h.is_idr:
                self.msb, self.prev_lsb = 0, 0
            lsb = h.pic_order_cnt_lsb
            if lsb < self.prev_lsb and (self.prev_lsb - lsb) >= max_lsb // 2:
                msb = self.msb + max_lsb
            elif lsb > self.prev_lsb and (lsb - self.prev_lsb) > max_lsb // 2:
                msb = self.msb - max_lsb
            else:
                msb = self.msb
            if h.nal_ref_idc:  # only reference pictures update prev
                self.msb, self.prev_lsb = msb, lsb
            return msb + lsb
        if h.is_idr:
            fno = 0
        elif self.prev_frame_num > h.frame_num:
            fno = self.prev_frame_num_offset + sps.max_frame_num
        else:
            fno = self.prev_frame_num_offset
        self.prev_frame_num = h.frame_num
        self.prev_frame_num_offset = fno
        if sps.pic_order_cnt_type == 2:
            return 2 * (fno + h.frame_num) - (0 if h.nal_ref_idc else 1)
        # pic_order_cnt_type 1 (spec 8.2.1.2)
        ncyc = len(sps.offset_for_ref_frame)
        abs_fn = (fno + h.frame_num) if ncyc else 0
        if h.nal_ref_idc == 0 and abs_fn > 0:
            abs_fn -= 1
        if abs_fn > 0:
            cyc, in_cyc = divmod(abs_fn - 1, ncyc)
            expected = cyc * sum(sps.offset_for_ref_frame) + \
                sum(sps.offset_for_ref_frame[:in_cyc + 1])
        else:
            expected = 0
        if h.nal_ref_idc == 0:
            expected += sps.offset_for_non_ref_pic
        top = expected + h.delta_pic_order_cnt[0]
        bottom = (top + sps.offset_for_top_to_bottom_field
                  + h.delta_pic_order_cnt[1])
        return min(top, bottom)
