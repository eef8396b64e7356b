"""SEI (supplemental enhancement information) parsing; twin of
jm_tpu/decoder/sei.py (ldecod/src/sei.c InterpretSEIMessage:116): the
payload-type / size ff-escape framing and the structured decode of
buffering period (sei.c:1591), picture timing (sei.c:1670), recovery
point (sei.c:902), pan-scan (sei.c:841), user data (sei.c:746 / 795),
scene info (sei.c:654), frame packing (sei.c:1879), tone mapping, spare
picture, sub-sequence info and dec_ref_pic_marking repetition. Unknown
types keep their raw payload; a malformed payload keeps its raw bytes
and no fields. ``build_tone_map_lut`` / ``tone_map_frame`` apply a
tone-mapping message to decoded planes.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..bitstream.bitreader import PyBitReader as BitReader


# payload type codes (spec D.1 / ldecod/inc/sei.h SEI_type)
BUFFERING_PERIOD = 0
PIC_TIMING = 1
PAN_SCAN_RECT = 2
FILLER_PAYLOAD = 3
USER_DATA_REGISTERED_ITU_T_T35 = 4
USER_DATA_UNREGISTERED = 5
RECOVERY_POINT = 6
DEC_REF_PIC_MARKING_REPETITION = 7
SPARE_PIC = 8
SCENE_INFO = 9
SUB_SEQ_INFO = 10
FULL_FRAME_FREEZE = 13
FULL_FRAME_FREEZE_RELEASE = 14
FULL_FRAME_SNAPSHOT = 15
STEREO_VIDEO_INFO = 21
TONE_MAPPING = 23
FRAME_PACKING_ARRANGEMENT = 45


@dataclass
class SEIMessage:
    payload_type: int
    payload: bytes
    fields: dict = field(default_factory=dict)


def _parse_buffering_period(br: BitReader, sps) -> dict:
    out = {"seq_parameter_set_id": br.ue()}
    if sps is None or sps.vui is None:
        return out
    vui = sps.vui
    for key, hrd in (("nal", vui.get("nal_hrd")), ("vcl", vui.get("vcl_hrd"))):
        if not hrd:
            continue
        n = hrd["cpb_cnt"]
        bits = hrd["initial_cpb_removal_delay_length"]
        out[key] = [(br.u(bits), br.u(bits)) for _ in range(n)]
    return out


def _parse_pic_timing(br: BitReader, sps) -> dict:
    out = {}
    vui = sps.vui if (sps is not None and sps.vui is not None) else {}
    hrd = vui.get("nal_hrd") or vui.get("vcl_hrd")
    if hrd:
        out["cpb_removal_delay"] = br.u(hrd["cpb_removal_delay_length"])
        out["dpb_output_delay"] = br.u(hrd["dpb_output_delay_length"])
    if vui.get("pic_struct_present"):
        ps = br.u(4)
        out["pic_struct"] = ps
        num_clock_ts = (1, 1, 1, 2, 2, 3, 3, 2, 3)[ps] if ps <= 8 else 0
        ts = []
        for _ in range(num_clock_ts):
            if br.flag():            # clock_timestamp_flag
                t = {"ct_type": br.u(2), "nuit_field_based": br.flag(),
                     "counting_type": br.u(5)}
                full = br.flag()
                t["discontinuity"] = br.flag()
                t["cnt_dropped"] = br.flag()
                t["n_frames"] = br.u(8)
                if full:
                    t["seconds"] = br.u(6)
                    t["minutes"] = br.u(6)
                    t["hours"] = br.u(5)
                else:
                    if br.flag():
                        t["seconds"] = br.u(6)
                        if br.flag():
                            t["minutes"] = br.u(6)
                            if br.flag():
                                t["hours"] = br.u(5)
                ts.append(t)
        out["timestamps"] = ts
    return out


def _parse_recovery_point(br: BitReader) -> dict:
    return {"recovery_frame_cnt": br.ue(),
            "exact_match_flag": br.flag(),
            "broken_link_flag": br.flag(),
            "changing_slice_group_idc": br.u(2)}


def _parse_pan_scan(br: BitReader) -> dict:
    out = {"pan_scan_rect_id": br.ue()}
    cancel = br.flag()
    out["cancel"] = cancel
    if not cancel:
        n = br.ue() + 1
        out["rects"] = [(br.se(), br.se(), br.se(), br.se())
                        for _ in range(n)]
        out["repetition_period"] = br.ue()
    return out


def _parse_scene_info(br: BitReader) -> dict:
    out = {}
    if br.flag():
        out["scene_id"] = br.ue()
        out["scene_transition_type"] = br.ue()
        if out["scene_transition_type"] > 3:
            out["second_scene_id"] = br.ue()
    return out


def _parse_frame_packing(br: BitReader) -> dict:
    out = {"id": br.ue(), "cancel": br.flag()}
    if not out["cancel"]:
        out["type"] = br.u(7)
        out["quincunx"] = br.flag()
        out["content_interpretation_type"] = br.u(6)
        out["spatial_flipping"] = br.flag()
        out["frame0_flipped"] = br.flag()
        out["field_views"] = br.flag()
        out["current_frame_is_frame0"] = br.flag()
    return out


def _parse_tone_mapping(br: BitReader) -> dict:
    """Tone-mapping info SEI (spec D.1.24; ldecod/src/sei.c
    interpret_tone_mapping:1989)."""
    out = {"tone_map_id": br.ue(), "cancel": br.flag()}
    if out["cancel"]:
        return out
    out["repetition_period"] = br.ue()
    out["coded_data_bit_depth"] = br.u(8)
    out["sei_bit_depth"] = br.u(8)
    out["model_id"] = br.ue()
    cbits = ((out["coded_data_bit_depth"] + 7) >> 3) << 3
    sbits = ((out["sei_bit_depth"] + 7) >> 3) << 3
    m = out["model_id"]
    if m == 0:
        out["min_value"] = br.u(32)
        out["max_value"] = br.u(32)
    elif m == 1:
        out["sigmoid_midpoint"] = br.u(32)
        out["sigmoid_width"] = br.u(32)
    elif m == 2:
        out["start_of_coded_interval"] = [
            br.u(cbits) for _ in range(1 << out["sei_bit_depth"])]
    elif m == 3:
        npv = br.u(16)
        out["num_pivots"] = npv
        cp, sp = [0], [0]
        for _ in range(npv):
            cp.append(br.u(cbits))
            sp.append(br.u(sbits))
        out["coded_pivot_value"] = cp
        out["sei_pivot_value"] = sp
    return out


def build_tone_map_lut(f: dict):
    """Build the output look-up table from parsed tone-mapping fields —
    the decoder-side application half (ldecod/src/sei.c LUT generation
    :2091-2133, applied by output.c tone_map:490)."""
    import math

    import numpy as np
    max_coded = 1 << f["coded_data_bit_depth"]
    max_out = 1 << f["sei_bit_depth"]
    lut = np.zeros(max_coded, np.int64)
    m = f["model_id"]
    if m == 0:
        mn, mx = f["min_value"], f["max_value"]
        i = np.arange(max_coded)
        lut = np.where(i <= mn, 0,
                       np.where(i >= mx, max_out - 1,
                                (i - mn) * (max_out - 1) // max(1, mx - mn)))
    elif m == 1:
        mid, wid = f["sigmoid_midpoint"], f["sigmoid_width"]
        for i in range(max_coded):
            lut[i] = int((max_out - 1)
                         / (1.0 + math.exp(-6 * (i - mid) / wid)) + 0.5)
    elif m == 2:
        starts = f["start_of_coded_interval"] + [max_coded]
        for j in range(max_out - 1):
            lut[starts[j]:starts[j + 1]] = j
        lut[starts[max_out - 1]:] = max_out - 1
    elif m == 3:
        cp = f["coded_pivot_value"] + [max_coded - 1]
        sp = f["sei_pivot_value"] + [max_out - 1]
        for j in range(f["num_pivots"] + 1):
            if cp[j + 1] == cp[j]:
                continue
            slope = (sp[j + 1] - sp[j]) / (cp[j + 1] - cp[j])
            for i in range(cp[j], cp[j + 1] + 1):
                lut[i] = sp[j] + int((i - cp[j]) * slope)
    dt = np.uint16 if f["sei_bit_depth"] > 8 else np.uint8
    return lut.astype(dt)


def tone_map_frame(frame, lut):
    """Apply a tone-mapping LUT to a decoded frame's planes (ldecod
    output.c:490 tone_map on Y, U, V). Returns new (Y, U, V)."""
    import numpy as np
    return (lut[np.asarray(frame.Y)], lut[np.asarray(frame.U)],
            lut[np.asarray(frame.V)])


def _parse_spare_pic(br: BitReader, mb_count: int | None) -> dict:
    """Spare picture (D.1.8): target frame + per-spare-pic MB unit maps
    (area idc 0 = whole picture, 1 = explicit unit map)."""
    f = {"target_frame_num": br.ue(), "spare_field_flag": br.flag()}
    n = br.ue() + 1
    pics = []
    for _ in range(n):
        e = {"delta_spare_frame_num": br.ue()}
        idc = br.ue()
        e["spare_area_idc"] = idc
        if idc == 1 and mb_count:
            e["unit_map"] = [br.flag() for _ in range(mb_count)]
        elif idc == 2 and mb_count:
            runs, total = [], 0
            while total < mb_count:
                r = br.ue()
                runs.append(r)
                total += r
            e["zero_runs"] = runs
        pics.append(e)
    f["spare_pics"] = pics
    return f


def _parse_sub_seq_info(br: BitReader) -> dict:
    f = {"sub_seq_layer_num": br.ue(), "sub_seq_id": br.ue(),
         "first_ref_pic_flag": br.flag(),
         "leading_non_ref_pic_flag": br.flag(),
         "last_pic_flag": br.flag()}
    if br.flag():
        f["sub_seq_frame_num"] = br.ue()
    return f


def _parse_drpm_repetition(br: BitReader, frame_mbs_only: bool) -> dict:
    f = {"original_idr_flag": br.flag(),
         "original_frame_num": br.ue()}
    if not frame_mbs_only:
        f["original_field_pic_flag"] = br.flag()
        if f["original_field_pic_flag"]:
            f["original_bottom_field_flag"] = br.flag()
    if f["original_idr_flag"]:
        f["no_output_of_prior_pics_flag"] = br.flag()
        f["long_term_reference_flag"] = br.flag()
    else:
        f["adaptive_ref_pic_marking_mode_flag"] = br.flag()
        ops = []
        if f["adaptive_ref_pic_marking_mode_flag"]:
            while True:
                op = br.ue()
                if op == 0:
                    break
                val = br.ue() if op in (1, 2, 3, 4, 6) else None
                if op == 3:
                    val = (val, br.ue())
                ops.append((op, val))
        f["mmco_ops"] = ops
    return f


def parse_sei_rbsp(rbsp: bytes, sps=None) -> list[SEIMessage]:
    """Split one SEI RBSP into messages (spec 7.3.2.3.1 framing: 0xFF-
    escaped type and size bytes; trailing rbsp stop bit)."""
    out = []
    pos = 0
    n = len(rbsp)
    while pos < n and rbsp[pos] != 0x80:
        ptype = 0
        while pos < n and rbsp[pos] == 0xFF:
            ptype += 255
            pos += 1
        if pos >= n:
            break
        ptype += rbsp[pos]
        pos += 1
        size = 0
        while pos < n and rbsp[pos] == 0xFF:
            size += 255
            pos += 1
        if pos >= n:
            break
        size += rbsp[pos]
        pos += 1
        payload = rbsp[pos:pos + size]
        pos += size
        msg = SEIMessage(ptype, payload)
        try:
            br = BitReader(payload)
            if ptype == BUFFERING_PERIOD:
                msg.fields = _parse_buffering_period(br, sps)
            elif ptype == PIC_TIMING:
                msg.fields = _parse_pic_timing(br, sps)
            elif ptype == RECOVERY_POINT:
                msg.fields = _parse_recovery_point(br)
            elif ptype == PAN_SCAN_RECT:
                msg.fields = _parse_pan_scan(br)
            elif ptype == SCENE_INFO:
                msg.fields = _parse_scene_info(br)
            elif ptype == FRAME_PACKING_ARRANGEMENT:
                msg.fields = _parse_frame_packing(br)
            elif ptype == TONE_MAPPING:
                msg.fields = _parse_tone_mapping(br)
            elif ptype == SPARE_PIC:
                mbs = None
                if sps is not None:
                    mbs = (sps.pic_width_in_mbs
                           * sps.frame_height_in_mbs)
                msg.fields = _parse_spare_pic(br, mbs)
            elif ptype == SUB_SEQ_INFO:
                msg.fields = _parse_sub_seq_info(br)
            elif ptype == DEC_REF_PIC_MARKING_REPETITION:
                msg.fields = _parse_drpm_repetition(
                    br, bool(sps.frame_mbs_only_flag) if sps else True)
            elif ptype == USER_DATA_UNREGISTERED:
                msg.fields = {"uuid": payload[:16].hex(),
                              "data": payload[16:]}
            elif ptype == USER_DATA_REGISTERED_ITU_T_T35:
                msg.fields = {"country_code": payload[0] if payload else 0,
                              "data": payload[1:]}
        except (EOFError, IndexError):
            pass  # malformed payload: keep raw bytes only
        out.append(msg)
    return out
