"""The port's smaller units of the multi-slice, FMO, rate-control and POC
paths against jm_tpu's, exact (the tolerance is zero):
- ratectl.RateControl against jm_tpu.ratectl.RateControl on seeded
  sequences of init_gop / pict_qp / update calls: every QP and the model
  state after each update;
- encoder/intra_host.IntraPicture on one multi-slice I picture against
  jm_tpu's host _FrameEncoder: every PictureData array and the recon;
- write_sps for POC types 0, 1 and 2, write_pps for FMO map types 0-6 and
  the slice header (first_mb, POC by type, slice_group_change_cycle);
- common/fmo.py's slice-group maps and successor arrays;
- the search range's boundary: the device P step raises above 16 and
  the host coders' full search above 32, at the same picture in both
  packages; everything else encodes, with jm_tpu's bytes."""

import dataclasses

import numpy as np
import pytest

from jm_tpu import ratectl as jm_rc
from jm_tpu.bitstream.bitwriter import BitWriter as JBitWriter
from jm_tpu.common import fmo as jm_fmo
from jm_tpu.common.types import PPS as JPPS
from jm_tpu.common.types import SPS as JSPS
from jm_tpu.common.types import SliceType as JSliceType
from jm_tpu.encoder import syntax as jm_syntax
from jm_tpu.encoder.encoder import Encoder as JaxEncoder
from jm_tpu.encoder.encoder import EncoderConfig as JaxConfig
from jm_tpu.encoder.encoder import _FrameEncoder
from jm_tpu_torch import ratectl
from jm_tpu_torch.bitstream.bitwriter import BitWriter
from jm_tpu_torch.common import fmo
from jm_tpu_torch.common.picture import PictureData
from jm_tpu_torch.common.tables import chroma_qp
from jm_tpu_torch.common.types import PPS, SPS, SliceType
from jm_tpu_torch.encoder import syntax
from jm_tpu_torch.encoder.encoder import (Encoder, EncoderConfig, lambda_me,
                                          lambda_mode4)
from jm_tpu_torch.encoder.intra_host import IntraPicture

from test_pipe_stream import make_frames
from torch_streams import one_torch_thread  # noqa: F401

# ---- rate control --------------------------------------------------------

RC_CASES = {
    # (bit rate, frame rate, width, height, initial QP, intra period,
    #  pictures, B pictures per anchor)
    "qcif_64k": (64000.0, 15.0, 176, 144, 0, 0, 40, 0),
    "cif_1m_gop12": (1e6, 30.0, 352, 288, 0, 12, 40, 0),
    "1080p_8m_qp30": (8e6, 30.0, 1920, 1088, 30, 0, 40, 0),
    "cif_b2": (5e5, 25.0, 352, 288, 0, 9, 30, 2),
}
MODEL = ("x1", "x2", "mad_c1", "mad_c2", "window", "mad_window",
         "remaining_bits", "buffer_fullness", "target", "p_qp")


@pytest.mark.parametrize("case", list(RC_CASES))
def test_rate_control_matches_jm(case):
    br, fr, w, h, qp0, ip, n, nb = RC_CASES[case]
    ours = ratectl.RateControl(br, fr, w, h, num_b=nb, initial_qp=qp0)
    theirs = jm_rc.RateControl(br, fr, w, h, num_b=nb, initial_qp=qp0)
    rng = np.random.default_rng(len(case))
    mad = 4.0
    qps = []
    for i in range(n):
        types = ["I" if i == 0 or (ip and i % ip == 0) else "P"]
        types += ["B"] * (nb if i else 0)
        for t in types:
            if t == "I":
                gop = ip if ip else 32
                ours.init_gop(gop - 1, gop * nb)
                theirs.init_gop(gop - 1, gop * nb)
            q = ours.pict_qp(t)
            assert q == theirs.pict_qp(t), f"picture {i} {t}"
            qps.append(q)
            mad = max(0.5, mad * float(rng.uniform(0.8, 1.25)))
            bits = int(br / fr * rng.uniform(0.3, 2.5)
                       * 2.0 ** ((26 - q) / 6))
            hdr = int(rng.integers(0, 200))
            ours.update(t, q, bits, mad, hdr)
            theirs.update(t, q, bits, mad, hdr)
            for k in MODEL:
                assert getattr(ours, k) == getattr(theirs, k), (i, t, k)
    assert len(set(qps)) > 3          # the model moved the QP


def test_qstep_maps_match_jm():
    for q in range(52):
        assert ratectl.qp2qstep(q) == jm_rc.qp2qstep(q)
    for s in np.geomspace(0.3, 300.0, 997):
        assert ratectl.qstep2qp(float(s)) == jm_rc.qstep2qp(float(s))


# ---- the host intra encoder -----------------------------------------------

INTRA_CASES = {
    "slices_of_7": (dict(slice_mode=1, slice_argument=7), 30, 0),
    "fmo_t1_qp24": (dict(num_slice_groups=2, slice_group_map_type=1), 24, 1),
    "fmo_t2_slices_qp36": (dict(num_slice_groups=3, slice_group_map_type=2,
                                sg_top_left=(7, 14),
                                sg_bottom_right=(20, 27), slice_mode=1,
                                slice_argument=5), 36, 2),
}
PIC_FIELDS = [k for k, v in vars(PictureData(1, 1)).items()
              if isinstance(v, np.ndarray)]


@pytest.mark.parametrize("case", list(INTRA_CASES))
def test_intra_host_matches_jm(case):
    kw, qp, seed = INTRA_CASES[case]
    Y, U, V = make_frames(96, 80, 1, seed=seed)[0]
    Y[:, :40] = Y[:, :40] // 32 + 100     # flat MBs, where I16 wins
    jenc = JaxEncoder(JaxConfig(width=96, height=80, qp=qp, **kw))
    assert len(jenc.slice_plan) > 1
    fe = _FrameEncoder(jenc, JSliceType.I, Y, U, V)
    want = fe.encode()
    got = IntraPicture((Y, U, V), qp, chroma_qp(qp, 0), lambda_me(qp),
                       lambda_mode4(qp), jenc.slice_plan)
    for k in PIC_FIELDS:
        assert np.array_equal(getattr(got.pic, k), getattr(want, k)), k
    # I4 MBs, and I16 on the flat MBs where its neighbours are in the
    # slice (the FMO groups here leave it none)
    classes = set(np.unique(got.pic.mb_class))
    assert 1 in classes and (2 in classes or "fmo" in case)
    for ours, theirs in zip(got.rec, (fe.recY, fe.recU, fe.recV)):
        assert np.array_equal(ours, theirs)


# ---- parameter sets and slice headers --------------------------------------

def _pair(cls_ours, cls_theirs, **kw):
    return cls_ours(**kw), cls_theirs(**kw)


@pytest.mark.parametrize("poc_type", [0, 1, 2])
def test_write_sps_matches_jm(poc_type):
    kw = dict(profile_idc=66, level_idc=40, log2_max_frame_num_minus4=4,
              pic_order_cnt_type=poc_type,
              delta_pic_order_always_zero_flag=int(poc_type == 1),
              offset_for_ref_frame=[2] if poc_type == 1 else [],
              log2_max_pic_order_cnt_lsb_minus4=4, max_num_ref_frames=1,
              pic_width_in_mbs_minus1=119, pic_height_in_map_units_minus1=67,
              frame_mbs_only_flag=1, direct_8x8_inference_flag=1)
    ours, theirs = _pair(SPS, JSPS, **kw)
    assert syntax.write_sps(ours) == jm_syntax.write_sps(theirs)


FMO_PPS = {
    0: dict(num_slice_groups_minus1=2, run_length_minus1=[3, 1, 5]),
    1: dict(num_slice_groups_minus1=3),
    2: dict(num_slice_groups_minus1=2, top_left=[7, 14],
            bottom_right=[20, 27]),
    3: dict(num_slice_groups_minus1=1, slice_group_change_direction_flag=1,
            slice_group_change_rate_minus1=2),
    4: dict(num_slice_groups_minus1=1, slice_group_change_rate_minus1=6),
    5: dict(num_slice_groups_minus1=1, slice_group_change_direction_flag=1),
    6: dict(num_slice_groups_minus1=4,
            slice_group_id=[i % 5 for i in range(30)]),
}


def _sps_pair():
    kw = dict(profile_idc=66, pic_width_in_mbs_minus1=5,
              pic_height_in_map_units_minus1=4)
    return _pair(SPS, JSPS, **kw)


@pytest.mark.parametrize("map_type", list(FMO_PPS))
def test_write_pps_matches_jm(map_type):
    ours, theirs = _pair(PPS, JPPS, slice_group_map_type=map_type,
                         **FMO_PPS[map_type])
    assert syntax.write_pps(ours) == jm_syntax.write_pps(theirs)


@pytest.mark.parametrize("map_type,poc_type,stype,cycle", [
    (1, 0, "I", 0), (3, 1, "P", 4), (4, 2, "I", 5), (5, 0, "P", 30)])
def test_slice_header_matches_jm(map_type, poc_type, stype, cycle):
    sps, jsps = _sps_pair()
    sps.pic_order_cnt_type = jsps.pic_order_cnt_type = poc_type
    pps, jpps = _pair(PPS, JPPS, slice_group_map_type=map_type,
                      **FMO_PPS[map_type])
    kw = dict(frame_num=3, idr=stype == "I", idr_pic_id=2, qp=31,
              first_mb=17, poc_lsb=6, slice_group_change_cycle=cycle)
    bw, jbw = BitWriter(), JBitWriter()
    syntax.write_slice_header(bw, sps, pps,
                              slice_type=SliceType[stype], **kw)
    jm_syntax.write_slice_header(jbw, jsps, jpps,
                                 slice_type=JSliceType[stype], **kw)
    bw.rbsp_trailing_bits()
    jbw.rbsp_trailing_bits()
    assert bw.get_bytes() == jbw.get_bytes()


# ---- slice-group maps -----------------------------------------------------

@pytest.mark.parametrize("map_type", list(FMO_PPS))
def test_fmo_maps_match_jm(map_type):
    sps, jsps = _sps_pair()
    for d in (0, 1):
        kw = dict(FMO_PPS[map_type])
        if map_type in (3, 4, 5):
            kw["slice_group_change_direction_flag"] = d
        pps, jpps = _pair(PPS, JPPS, slice_group_map_type=map_type, **kw)
        for cycle in (0, 1, 4, 11, 40):
            got = fmo.mb_to_slice_group_map(pps, sps, cycle)
            want = jm_fmo.mb_to_slice_group_map(jpps, jsps, cycle)
            assert np.array_equal(got, want)
            assert np.array_equal(fmo.next_mb_arrays(got),
                                  jm_fmo.next_mb_arrays(want))


def test_parameter_set_fields_match_jm():
    """The port's SPS / PPS carry every field jm_tpu's writers read for
    POC types 1 / 2 and FMO."""
    for ours, theirs in ((SPS, JSPS), (PPS, JPPS)):
        names = {f.name for f in dataclasses.fields(ours)}
        assert names <= {f.name for f in dataclasses.fields(theirs)}
    assert {"offset_for_ref_frame", "delta_pic_order_always_zero_flag",
            "offset_for_non_ref_pic"} <= {f.name
                                          for f in dataclasses.fields(SPS)}


# ---- search range ----------------------------------------------------------

def _range_run(enc, frames, entry: str):
    """(payload, pictures coded, ValueError message or None) of frames
    through entry (encode_stream, or encode_frame per frame), then
    flush."""
    out = []
    try:
        if entry == "encode_stream":
            out = list(enc.encode_stream(frames))
        else:
            for f in frames:
                out.append(enc.encode_frame(*f))
        out.append(enc.flush())
    except ValueError as e:
        return None, len(enc.results), str(e)
    return b"".join(out), len(enc.results), None


# (pipeline, search_range, other fields, entry, raises at the first P)
RANGE_CASES = [
    ("host", 24, {}, "encode_frame", False),
    ("host", 32, {}, "encode_frame", False),
    ("device", 17, {"device_rd": True}, "encode_stream", True),
    ("device", 17, {"device_rd": True}, "encode_frame", True),
    ("device", 24, {"device_rd": False}, "encode_stream", True),
    ("device", 24, {"device_rd": False}, "encode_frame", True),
    ("host", 32, {"num_b": 1}, "encode_frame", False),
    ("host", 32, {"sub8x8": True}, "encode_frame", False),
    ("host", 32, {"search_mode": 1}, "encode_frame", False),
    ("host", 32, {"search_mode": 3, "hme": True}, "encode_frame", False),
    ("host", 48, {}, "encode_frame", True),
    ("host", 48, {"search_mode": 1}, "encode_frame", True),
    ("host", 48, {"search_mode": 3}, "encode_frame", False),
    ("host", 48, {"intra_period": 1}, "encode_frame", False),
    ("device", 24, {"sub8x8": True, "device_rd": False}, "encode_frame",
     False),
    ("device", 24, {"num_ref": 2, "device_rd": False}, "encode_frame", True),
]


@pytest.mark.parametrize(
    "pipeline,sr,kw,entry,raises", RANGE_CASES,
    ids=[f"{p}-{sr}-{'-'.join(kw) or 'plain'}-{e}"
         for p, sr, kw, e, _ in RANGE_CASES])
def test_search_range_above_16_raises_in_both(pipeline, sr, kw, entry,
                                              raises):
    """The device P step raises above 16 ("exceeds plane padding", from
    band_geometry: jm_tpu's pipe admits up to 24, its per-frame step
    any), the host coders above 32 (jm_tpu's full search fails to
    reshape; the port names the padding), each at the first P picture;
    intra-only streams and device-route streams whose P pictures all go
    to the host coders (sub8x8) encode, with jm_tpu's bytes. With
    num_ref 2 the first P picture has one active reference and takes
    the device step."""
    frames = make_frames(32, 32, 3)
    cfg = dict(width=32, height=32, pipeline=pipeline, search_range=sr,
               **kw)
    jm = _range_run(JaxEncoder(JaxConfig(**cfg)), frames, entry)
    port = _range_run(Encoder(EncoderConfig(**cfg), device="cpu"), frames,
                      entry)
    assert (jm[2] is not None, port[2] is not None) == (raises, raises)
    assert port[:2] == jm[:2]
    if raises:
        assert jm[1] == 1            # the IDR, then the first P raised
        want = "plane padding" if pipeline == "device" else "reshape"
        assert want in jm[2] and "padding" in port[2]
        if pipeline == "device":
            assert port[2] == jm[2]
