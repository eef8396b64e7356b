"""SEI message writers, the encoder side of decoder/sei.py; twin of
jm_tpu/encoder/sei_write.py (lencod/src/sei.c InitSEIMessages:89,
recovery point :2468, ComposeSparePictureMessage, user data :2550,
frame packing :2998). Each writer returns (payload type, payload) for
one message; build_sei_rbsp applies the spec D.1 / 7.3.2.3.1 framing
(0xFF-escaped type and size bytes, then the rbsp trailing bits).
"""

from __future__ import annotations

from ..bitstream.bitwriter import BitWriter
from ..decoder import sei as S


def _payload(bw: BitWriter) -> bytes:
    """SEI payloads are byte-aligned with their own trailing bits when not
    already aligned (spec D.1 sei_payload)."""
    if not bw.byte_aligned():
        bw.u(1, 1)
        bw.align_zero()
    return bytes(bw.buf)


def recovery_point(recovery_frame_cnt: int, exact_match: bool = True,
                   broken_link: bool = False,
                   changing_slice_group_idc: int = 0) -> tuple[int, bytes]:
    bw = BitWriter()
    bw.ue(recovery_frame_cnt)
    bw.flag(exact_match)
    bw.flag(broken_link)
    bw.u(changing_slice_group_idc, 2)
    return S.RECOVERY_POINT, _payload(bw)


def user_data_unregistered(data: bytes,
                           uuid: bytes = b"jm_tpu-sei-userdata!"[:16]
                           ) -> tuple[int, bytes]:
    assert len(uuid) == 16
    return S.USER_DATA_UNREGISTERED, uuid + data


def user_data_registered_itu_t_t35(country_code: int,
                                   data: bytes) -> tuple[int, bytes]:
    return S.USER_DATA_REGISTERED_ITU_T_T35, bytes([country_code]) + data


def scene_info(scene_id: int, transition_type: int = 0,
               second_scene_id: int | None = None) -> tuple[int, bytes]:
    bw = BitWriter()
    bw.flag(1)                   # scene_info_present_flag
    bw.ue(scene_id)
    bw.ue(transition_type)
    if transition_type > 3:
        bw.ue(second_scene_id or 0)
    return S.SCENE_INFO, _payload(bw)


def pan_scan_rect(rect_id: int, rects: list[tuple[int, int, int, int]],
                  repetition_period: int = 0) -> tuple[int, bytes]:
    bw = BitWriter()
    bw.ue(rect_id)
    bw.flag(0)                   # cancel
    bw.ue(len(rects) - 1)
    for l, r, t, b in rects:
        bw.se(l); bw.se(r); bw.se(t); bw.se(b)
    bw.ue(repetition_period)
    return S.PAN_SCAN_RECT, _payload(bw)


def frame_packing_arrangement(arr_id: int, arr_type: int,
                              current_frame_is_frame0: bool = True,
                              content_interpretation_type: int = 1
                              ) -> tuple[int, bytes]:
    """Stereo packing signalling (lencod/src/sei.c frame packing; type 3 =
    side-by-side, 4 = top-bottom, 5 = temporal interleave)."""
    bw = BitWriter()
    bw.ue(arr_id)
    bw.flag(0)                   # cancel
    bw.u(arr_type, 7)
    bw.flag(0)                   # quincunx
    bw.u(content_interpretation_type, 6)
    bw.flag(0)                   # spatial_flipping
    bw.flag(0)                   # frame0_flipped
    bw.flag(0)                   # field_views
    bw.flag(current_frame_is_frame0)
    bw.flag(0)                   # frame_packing_arrangement_reserved_byte...
    # frame0_grid_position/frame1_grid_position omitted (quincunx=0 and
    # type>2 use the inferred 0 positions per spec D.2.25)
    return S.FRAME_PACKING_ARRANGEMENT, _payload(bw)


def tone_mapping(tone_map_id: int = 0, cancel: bool = False,
                 repetition_period: int = 0,
                 coded_data_bit_depth: int = 8, sei_bit_depth: int = 8,
                 model_id: int = 0, min_value: int = 0,
                 max_value: int = 255, sigmoid_midpoint: int = 128,
                 sigmoid_width: int = 64,
                 start_of_coded_interval=None,
                 coded_pivot_value=None, sei_pivot_value=None):
    """Tone-mapping info SEI writer (spec D.1.24; reference
    lencod/src/sei.c FinalizeToneMapping:1876 field order). Models:
    0 linear-with-clipping, 1 sigmoid, 2 user table, 3 piecewise
    linear (pivot lists EXCLUDE the implicit 0 entry, like the
    reference's config file)."""
    bw = BitWriter()
    bw.ue(tone_map_id)
    bw.flag(1 if cancel else 0)
    if not cancel:
        bw.ue(repetition_period)
        bw.u(coded_data_bit_depth, 8)
        bw.u(sei_bit_depth, 8)
        bw.ue(model_id)
        cbits = ((coded_data_bit_depth + 7) >> 3) << 3
        sbits = ((sei_bit_depth + 7) >> 3) << 3
        if model_id == 0:
            bw.u(min_value, 32)
            bw.u(max_value, 32)
        elif model_id == 1:
            bw.u(sigmoid_midpoint, 32)
            bw.u(sigmoid_width, 32)
        elif model_id == 2:
            for v in start_of_coded_interval:
                bw.u(v, cbits)
        elif model_id == 3:
            bw.u(len(coded_pivot_value), 16)
            for c, p in zip(coded_pivot_value, sei_pivot_value):
                bw.u(c, cbits)
                bw.u(p, sbits)
    return S.TONE_MAPPING, _payload(bw)


def spare_pic(target_frame_num: int, spare_maps: list,
              mb_count: int) -> tuple[int, bytes]:
    """Spare picture SEI (spec D.1.8; lencod/src/sei.c
    ComposeSparePictureMessage:408): spare_maps is a list of
    (delta_spare_frame_num, unit_map-or-None); unit_map None means
    spare_area_idc=0 (every MB of that picture is a spare), an array of
    mb_count 0/1 flags writes spare_area_idc=1 unit maps."""
    bw = BitWriter()
    bw.ue(target_frame_num)
    bw.flag(0)                       # spare_field_flag (frame pictures)
    bw.ue(len(spare_maps) - 1)       # num_spare_pics_minus1
    for delta, unit_map in spare_maps:
        bw.ue(delta)
        if unit_map is None:
            bw.ue(0)                 # spare_area_idc: whole picture
        else:
            assert len(unit_map) == mb_count
            bw.ue(1)
            for b in unit_map:
                bw.flag(int(b))
    return S.SPARE_PIC, _payload(bw)


def sub_seq_info(layer_num: int, sub_seq_id: int,
                 first_ref_pic: bool = False,
                 leading_non_ref_pic: bool = False,
                 last_pic: bool = False,
                 sub_seq_frame_num: int | None = None) -> tuple[int, bytes]:
    """Sub-sequence information SEI (spec D.1.11; lencod sei.c
    InitSubseqInfo:104, triggered by NumFramesInELSubSeq)."""
    bw = BitWriter()
    bw.ue(layer_num)
    bw.ue(sub_seq_id)
    bw.flag(1 if first_ref_pic else 0)
    bw.flag(1 if leading_non_ref_pic else 0)
    bw.flag(1 if last_pic else 0)
    bw.flag(0 if sub_seq_frame_num is None else 1)
    if sub_seq_frame_num is not None:
        bw.ue(sub_seq_frame_num)
    return S.SUB_SEQ_INFO, _payload(bw)


def dec_ref_pic_marking_repetition(original_idr: bool,
                                   original_frame_num: int,
                                   frame_mbs_only: bool = True,
                                   long_term_reference_flag: int = 0,
                                   mmco_ops=None) -> tuple[int, bytes]:
    """Dec-ref-pic-marking repetition SEI (spec D.1.9): repeats the
    marking of an earlier picture for error resilience (lencod sei.c
    DRPM repetition)."""
    bw = BitWriter()
    bw.flag(1 if original_idr else 0)
    bw.ue(original_frame_num)
    if not frame_mbs_only:
        bw.flag(0)                   # original_field_pic_flag
    # dec_ref_pic_marking() (7.3.3.3)
    if original_idr:
        bw.flag(0)                   # no_output_of_prior_pics_flag
        bw.flag(long_term_reference_flag)
    elif mmco_ops:
        bw.flag(1)
        for op, val in mmco_ops:
            bw.ue(op)
            if op in (1, 2, 3, 4, 6):
                bw.ue(val)
            if op == 3:
                raise NotImplementedError("MMCO 3 repetition")
        bw.ue(0)
    else:
        bw.flag(0)
    return S.DEC_REF_PIC_MARKING_REPETITION, _payload(bw)


def buffering_period(sps, initial_cpb_removal_delay: int,
                     initial_cpb_removal_delay_offset: int = 0
                     ) -> tuple[int, bytes]:
    """Requires SPS VUI with HRD parameters (field widths come from the
    hrd initial_cpb_removal_delay_length)."""
    bw = BitWriter()
    bw.ue(0)                     # seq_parameter_set_id
    vui = sps.vui or {}
    for hrd in (vui.get("nal_hrd"), vui.get("vcl_hrd")):
        if not hrd:
            continue
        bits = hrd["initial_cpb_removal_delay_length"]
        for _ in range(hrd["cpb_cnt"]):
            bw.u(initial_cpb_removal_delay, bits)
            bw.u(initial_cpb_removal_delay_offset, bits)
    return S.BUFFERING_PERIOD, _payload(bw)


def pic_timing(sps, cpb_removal_delay: int,
               dpb_output_delay: int) -> tuple[int, bytes]:
    bw = BitWriter()
    vui = sps.vui or {}
    hrd = vui.get("nal_hrd") or vui.get("vcl_hrd")
    if hrd:
        bw.u(cpb_removal_delay, hrd["cpb_removal_delay_length"])
        bw.u(dpb_output_delay, hrd["dpb_output_delay_length"])
    if vui.get("pic_struct_present"):
        bw.u(0, 4)               # pic_struct: frame
        bw.flag(0)               # clock_timestamp_flag
    return S.PIC_TIMING, _payload(bw)


def build_sei_rbsp(messages: list[tuple[int, bytes]]) -> bytes:
    """Frame messages into one SEI RBSP (spec 7.3.2.3.1: ff-escaped
    payload type/size, then rbsp_trailing_bits)."""
    out = bytearray()
    for ptype, payload in messages:
        t = ptype
        while t >= 255:
            out.append(0xFF)
            t -= 255
        out.append(t)
        s = len(payload)
        while s >= 255:
            out.append(0xFF)
            s -= 255
        out.append(s)
        out += payload
    out.append(0x80)             # rbsp stop bit + alignment
    return bytes(out)
