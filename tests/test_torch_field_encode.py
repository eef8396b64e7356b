"""The port's encoder with pic_interlace=1 (every frame coded as a top
and a bottom field picture) against jm_tpu's field coding on the CPU,
exactly: on torch_streams.motion_clip at 64x64 (fields of 4 x 2 MBs),
QP 30, through encode_frame (and encode_stream in one case), each case
of a configuration that jm_tpu's field coder covers gives
- the same bytes and the same recon of every field (each field's
  deblocked planes, its parity, POC and type);
- a stream that the port's H264Decoder and jm_tpu's decode to the woven
  recon of each frame;
with the SPS geometry of a field stream (frame_mbs_only_flag 0, map
units of field MB rows), jm_tpu's refusals (NotImplementedError, the
same type) and the options that jm_tpu's field coder reads nowhere
(qp_p, rd_picture_decision, intra_mb_refresh, the user-data SEI,
ref_reorder, poc_mem_mgmt: the bytes of the case without them)."""

import numpy as np
import pytest

from jm_tpu.decoder.decoder import H264Decoder as JaxDecoder
from jm_tpu.encoder.encoder import Encoder as JaxEncoder
from jm_tpu.encoder.encoder import EncoderConfig as JaxConfig
from jm_tpu_torch.bitstream.nal import NalUnitType, split_annexb
from jm_tpu_torch.decoder.decoder import H264Decoder
from jm_tpu_torch.decoder.header import parse_slice_header
from jm_tpu_torch.decoder.parset import parse_pps, parse_sps
from jm_tpu_torch.encoder.encoder import Encoder, EncoderConfig

from torch_streams import motion_clip, one_torch_thread, option_run  # noqa: F401

CASES = {
    # name: (EncoderConfig keywords, frames, through encode_stream)
    "num_ref1": ({}, 3, False),
    "num_ref2": ({"num_ref": 2}, 3, False),
    "intra_period3": ({"intra_period": 3}, 4, True),
    "epzs": ({"search_mode": 3, "num_ref": 2}, 3, False),
    "rdo1": ({"rdo": 1}, 3, False),
}


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(name):
        if name not in cache:
            kw, n, stream = CASES[name]
            cache[name] = option_run(dict(pic_interlace=1, **kw),
                                     motion_clip(n, 64, 64), stream=stream)
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(CASES))
def test_field_stream_matches_jm(name, runs, one_torch_thread):
    frames, jm_pay, jm_res, enc, pay = runs(name)
    assert len(pay) == len(frames)
    for i, (a, b) in enumerate(zip(pay, jm_pay)):
        assert a == b, f"frame {i} payload"
    assert len(enc.results) == len(jm_res) == 2 * len(frames)
    for r, j in zip(enc.results, jm_res):
        assert (r["disp"], r["type"], r["parity"], r["bits"]) == \
            (j["disp"], j["type"], j["parity"], j["bits"])
        assert r["frame"].poc == j["frame"].poc
        for p in "YUV":
            assert np.array_equal(getattr(r["frame"], p),
                                  getattr(j["frame"], p)), (r["disp"], p)
    types = [r["type"] for r in enc.results]
    assert types[:2] == ["I", "P"] and set(types[2:]) == (
        {"I", "P"} if name == "intra_period3" else {"P"})


def _woven(results):
    out = []
    for top, bot in zip(results[0::2], results[1::2]):
        planes = []
        for p in "YUV":
            t, b = getattr(top["frame"], p), getattr(bot["frame"], p)
            w = np.empty((2 * t.shape[0], t.shape[1]), np.uint8)
            w[0::2], w[1::2] = t, b
            planes.append(w)
        out.append(planes)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_field_stream_decodes_to_recon(name, runs, one_torch_thread):
    """The port's decoder and jm_tpu's give the woven recon of every
    frame."""
    frames, _, _, enc, pay = runs(name)
    data = b"".join(pay)
    want = _woven(enc.results)
    for dec in (H264Decoder(device="cpu"), JaxDecoder(device_recon=False)):
        got = dec.decode_annexb(data)
        assert len(got) == len(frames)
        for f, w in zip(got, want):
            for p, plane in zip("YUV", w):
                assert np.array_equal(np.asarray(getattr(f, p)), plane), p


def test_field_stream_geometry(runs):
    """SPS: frame_mbs_only_flag 0 without MBAFF, the frame's width and
    its height in field MB rows (map units); every slice a field picture,
    top then bottom, POC 2 disp + parity since the IDR, the bottom field
    of an IDR frame a P field predicting from its top field."""
    _, _, _, enc, pay = runs("intra_period3")
    data = b"".join(pay)
    sps_map, pps_map, seen = {}, {}, []
    for nal in split_annexb(data):
        if nal.nal_unit_type == NalUnitType.SPS:
            sps = parse_sps(nal.rbsp)
            sps_map[sps.seq_parameter_set_id] = sps
            assert sps.frame_mbs_only_flag == 0
            assert sps.mb_adaptive_frame_field_flag == 0
            assert (sps.pic_width_in_mbs, sps.pic_height_in_map_units_minus1,
                    sps.frame_height_in_mbs) == (4, 1, 4)
        elif nal.nal_unit_type == NalUnitType.PPS:
            pps = parse_pps(nal.rbsp, sps_map)
            pps_map[pps.pic_parameter_set_id] = pps
        elif nal.nal_unit_type in (NalUnitType.SLICE, NalUnitType.IDR):
            h, _ = parse_slice_header(nal, sps_map, pps_map)
            seen.append((h.field_pic_flag, h.bottom_field_flag, h.is_idr,
                         h.slice_type.name, h.frame_num, h.pic_order_cnt_lsb,
                         h.num_ref_idx_l0_active_minus1 + 1))
    # num_ref 1: one frame unit stays; a top field predicts from both
    # fields of the frame before, a bottom field from its top field
    assert seen == [
        (1, 0, True, "I", 0, 0, 1), (1, 1, False, "P", 0, 1, 1),
        (1, 0, False, "P", 1, 2, 2), (1, 1, False, "P", 1, 3, 1),
        (1, 0, False, "P", 2, 4, 2), (1, 1, False, "P", 2, 5, 1),
        (1, 0, True, "I", 0, 0, 1), (1, 1, False, "P", 0, 1, 1)]
    assert [r["parity"] for r in enc.results] == [0, 1] * 4
    assert enc.mb_h == 2 and enc.sps.max_num_ref_frames == 1


REFUSED = {
    "num_b": {"num_b": 1},
    "cabac": {"entropy": "cabac"},
    "yuv422": {"chroma_format": 2},
    "data_partition": {"data_partition": 1},
    "slice_mode": {"slice_mode": 1, "slice_argument": 4},
    "fmo": {"num_slice_groups": 2},
    "weighted_pred": {"weighted_pred": 1},
    "rate_control": {"rc_enable": True, "rc_bitrate": 100000.0},
    "transform8x8": {"transform8x8": True},
    "rdoq": {"rdoq": 1},
    "long_term": {"long_term_period": 2},
    "poc_type": {"poc_type": 2},
    "height_not_32": {"height": 48},
    "redundant": {"redundant_period": 1},
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_field_refusals_match_jm(name):
    kw = dict(width=64, height=64, qp=30, pic_interlace=1)
    kw.update(REFUSED[name])
    with pytest.raises(NotImplementedError):
        JaxEncoder(JaxConfig(**kw))
    with pytest.raises(NotImplementedError,
                       match="pic_interlace|redundant_period"):
        Encoder(EncoderConfig(**kw), device="cpu")


@pytest.mark.parametrize("value", [2, -1, True])
def test_pic_interlace_values(value):
    with pytest.raises(ValueError, match="pic_interlace"):
        Encoder(EncoderConfig(width=64, height=64, pic_interlace=value),
                device="cpu")


IGNORED = {
    "qp_p": ({"qp_p": 36}, "num_ref1"),
    "rd_picture_decision": ({"rd_picture_decision": True}, "num_ref1"),
    "intra_mb_refresh": ({"intra_mb_refresh": 3}, "num_ref1"),
    "sei_user_data": ({"sei_user_data": b"field"}, "num_ref1"),
    "ref_reorder_poc_mem_mgmt": ({"ref_reorder": 1, "poc_mem_mgmt": 1},
                                 "num_ref2"),
}


@pytest.mark.parametrize("name", list(IGNORED))
def test_ignored_options_are_pinned(name, runs, one_torch_thread):
    """Options jm_tpu's field coder reads nowhere (_encode_field codes
    every field at qp, without the trial or redundant coders, a refresh
    set, an SEI, list modification or MMCO): both encoders give the bytes
    of the case without them."""
    kw, base = IGNORED[name]
    frames, jm_pay, _, _, pay = option_run(
        dict(pic_interlace=1, **kw, **CASES[base][0]),
        motion_clip(3, 64, 64))
    want = runs(base)[4]
    assert pay == jm_pay == want


@pytest.mark.parametrize("qp", [24, 36])
def test_native_intra4x4_coder_field_scan(qp, monkeypatch):
    """IntraPicture of a field (parity 0: the field scan) with the native
    encode_i4_mb against IntraMBCoder's Python loop: every PictureData
    array and the recon planes equal, and the levels differ from a frame
    coding's order (the scan acts)."""
    from jm_tpu_torch.common.tables import chroma_qp
    from jm_tpu_torch.encoder import encoder as port_encoder
    from jm_tpu_torch.encoder.intra_host import IntraPicture
    Y, U, V = motion_clip(1, 64, 64, seed=qp)[0]
    args = ((Y[::2], U[::2], V[::2]), qp, chroma_qp(qp, 0),
            port_encoder.lambda_me(qp), port_encoder.lambda_mode4(qp),
            [list(range(8))])
    got = IntraPicture(*args, parity=0)
    frame = IntraPicture(*args)
    monkeypatch.setattr(IntraPicture, "native_i4", False)
    want = IntraPicture(*args, parity=0)
    assert (got.pic.mb_class == 1).sum() >= 2
    for k in ("mb_class", "i4_modes", "i16_mode", "cbp", "luma_coef",
              "luma_dc", "luma_nnz", "chroma_mode", "chroma_dc",
              "chroma_coef", "chroma_nnz"):
        assert np.array_equal(getattr(got.pic, k), getattr(want.pic, k)), k
    for a, b in zip(got.rec, want.rec):
        assert np.array_equal(a, b)
    assert np.array_equal(got.rec[0], frame.rec[0])
    assert not np.array_equal(got.pic.luma_coef, frame.pic.luma_coef)
