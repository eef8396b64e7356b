"""Streams of the tests of the port's host tools (tests/test_torch_tools_
*.py): seeded clips of tests/test_pipe_stream.py at 64x48 encoded by
jm_tpu's Encoder (its host coders), and a stream whose SPS carries a
full VUI with a NAL HRD and pic_struct_present_flag, with buffering
period and pic_timing SEI, all written by jm_tpu's writers."""

from pathlib import Path

from jm_tpu.bitstream.nal import annexb_bytes, split_annexb
from jm_tpu.decoder.parset import parse_sps
from jm_tpu.encoder import sei_write
from jm_tpu.encoder.encoder import Encoder, EncoderConfig
from jm_tpu.encoder.syntax import write_sps

from test_pipe_stream import make_frames

GOLDEN = Path(__file__).parent / "golden"
W, H = 64, 48

# jm_tpu EncoderConfig options of each CAVLC case: an I P P stream, the
# SPS's VUI (enable_vui), long-term references marked through MMCO, MMCO
# 1 (poc_mem_mgmt) and forced I_PCM MBs
CASES = {
    "ipp": dict(n=3),
    "vui": dict(n=3, enable_vui=True),
    "long_term": dict(n=4, long_term_period=2),
    "mmco": dict(n=4, poc_mem_mgmt=1),
    "ipcm": dict(n=2, enable_ipcm=2),
}

# a VUI with every part that changes the parse: Extended_SAR, the video
# signal type with its colour description, the chroma sample location,
# timing, a NAL HRD of two CPB specifications, pic_struct_present_flag
# and the bitstream restriction
FULL_VUI = {
    "aspect_ratio_idc": 255, "sar_width": 4, "sar_height": 3,
    "overscan_appropriate": 1,
    "video_format": 5, "video_full_range": 1,
    "colour_primaries": 1, "transfer_characteristics": 1,
    "matrix_coefficients": 1,
    "chroma_sample_loc_type_top": 1, "chroma_sample_loc_type_bottom": 2,
    "num_units_in_tick": 1001, "time_scale": 60000, "fixed_frame_rate": 1,
    "nal_hrd": {"cpb_cnt": 2, "bit_rate_scale": 1, "cpb_size_scale": 2,
                "cpb": [(1999, 3999, 0), (2999, 5999, 1)],
                "initial_cpb_removal_delay_length": 20,
                "cpb_removal_delay_length": 18,
                "dpb_output_delay_length": 7, "time_offset_length": 24},
    "low_delay_hrd": 0,
    "pic_struct_present": 1,
    "motion_vectors_over_pic_boundaries": 1, "max_bytes_per_pic_denom": 2,
    "max_bits_per_mb_denom": 1, "log2_max_mv_length_horizontal": 11,
    "log2_max_mv_length_vertical": 9, "max_num_reorder_frames": 0,
    "max_dec_frame_buffering": 1,
}


def jm_stream(n: int, w: int = W, h: int = H, qp: int = 30, **kw) -> bytes:
    """n seeded frames through jm_tpu's Encoder (host coders)."""
    enc = Encoder(EncoderConfig(width=w, height=h, qp=qp, **kw))
    data = b"".join(enc.encode_frame(*f) for f in make_frames(w, h, n))
    return data + enc.flush()


def case_stream(name: str) -> bytes:
    return jm_stream(**CASES[name])


def hrd_stream(n: int = 2) -> bytes:
    """jm_tpu's I P stream with its SPS written again with FULL_VUI, and
    before each picture an SEI NAL unit: a buffering period and a
    pic_timing before the IDR, a pic_timing before the P picture (the
    cpb_removal_delay / dpb_output_delay widths and pic_struct of the
    pic_timing are the VUI's)."""
    out, sps, k = [], None, 0
    for nal in split_annexb(jm_stream(n)):
        t = int(nal.nal_unit_type)
        rbsp = nal.rbsp
        if t == 7:
            sps = parse_sps(rbsp)
            sps.vui = FULL_VUI
            sps.vui_parameters_present_flag = 1
            rbsp = write_sps(sps)
        elif t in (1, 5):
            msgs = [sei_write.pic_timing(sps, 2 * k, 3 + k)]
            if t == 5:
                msgs.insert(0, sei_write.buffering_period(sps, 90000, 1200))
            out.append(annexb_bytes(0, 6, sei_write.build_sei_rbsp(msgs)))
            k += 1
        out.append(annexb_bytes(nal.nal_ref_idc, t, rbsp))
    return b"".join(out)
