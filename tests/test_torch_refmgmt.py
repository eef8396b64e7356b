"""The port's reference management, redundant pictures and SEI against
jm_tpu's, on the CPU (the codec is integer-exact: the tolerance is
zero):
- decoder/dpb.py: MMCO ops 1-6, long-term IDRs and the sliding window
  driven on both DPBs with the same seeded command sequences leave equal
  marking and equal list0 (with long-term reordering) after every
  picture;
- the slice headers of the port's long-term / MMCO / redundant streams
  parse field by field as jm_tpu's parser reads them;
- redundant codings: discarded when their primary is present, decoded
  in its place when it is dropped, as jm_tpu's decoder does;
- decoder/sei.py and encoder/sei_write.py: every message type written by
  the port, byte-identical to jm_tpu's writer, parses as jm_tpu's
  parse_sei_rbsp does; the tone-map LUTs equal; sei.264's messages land
  in H264Decoder.sei_messages as in jm_tpu's."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from jm_tpu.bitstream.nal import split_annexb as jm_split
from jm_tpu.common.types import MMCOOp as JMMCOOp
from jm_tpu.common.types import RefPicListMod as JRefPicListMod
from jm_tpu.decoder import sei as JS
from jm_tpu.decoder.decoder import H264Decoder as JaxDecoder
from jm_tpu.decoder.dpb import DPB as JDPB
from jm_tpu.decoder.dpb import Frame as JFrame
from jm_tpu.decoder.header import parse_slice_header as jm_slice_header
from jm_tpu.decoder.parset import parse_pps as jm_pps
from jm_tpu.decoder.parset import parse_sps as jm_sps
from jm_tpu.encoder import sei_write as JW
from jm_tpu_torch.bitstream.nal import split_annexb
from jm_tpu_torch.common.types import SPS, MMCOOp, RefPicListMod, SliceHeader
from jm_tpu_torch.decoder import sei as S
from jm_tpu_torch.decoder.decoder import H264Decoder
from jm_tpu_torch.decoder.dpb import DPB, Frame
from jm_tpu_torch.decoder.header import parse_slice_header
from jm_tpu_torch.decoder.parset import parse_pps, parse_sps
from jm_tpu_torch.encoder import sei_write as W
from jm_tpu_torch.encoder.encoder import Encoder, EncoderConfig

from test_pipe_stream import make_frames

GOLDEN = Path(__file__).parent / "golden"
WW, HH, QP, N = 96, 80, 30, 6


# ---- the DPB ---------------------------------------------------------------

def _marking(frames):
    return sorted((f.frame_num, f.poc, bool(f.is_long_term),
                   f.long_term_frame_idx) for f in frames)


def _commands(rng, dpb, frame_num, max_fn):
    """A seeded MMCO command list that names pictures of the DPB."""
    ops = []
    short = [f for f in dpb.frames if not f.is_long_term]
    long = [f for f in dpb.frames if f.is_long_term]
    for _ in range(int(rng.integers(1, 3))):
        op = int(rng.integers(1, 7))
        if op in (1, 3) and short:
            f = short[int(rng.integers(0, len(short)))]
            diff = (frame_num - f.frame_num) % max_fn - 1
            if op == 1:
                ops.append((1, diff, 0))
            else:
                ops.append((3, diff, int(rng.integers(0, 3))))
        elif op == 2 and long:
            ops.append((2, long[0].long_term_frame_idx, 0))
        elif op == 4:
            ops.append((4, int(rng.integers(0, 4)), 0))
        elif op == 5 and rng.random() < 0.3:
            ops.append((5, 0, 0))
        elif op == 6:
            ops.append((6, int(rng.integers(0, 3)), 0))
    return ops



@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU encodes and decodes are many small tensor ops,
    which more threads only slow down beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.mark.parametrize("seed", range(4))
def test_mmco_marking_matches_jm(seed):
    """Both DPBs take the same pictures and commands (MMCO ops 1-6, the
    sliding window, long-term IDRs, non-reference pictures); after each
    picture their marking and list0 are equal, and so is list0 after a
    long-term modification command."""
    rng = np.random.default_rng(seed)
    sps = SPS(log2_max_frame_num_minus4=0, max_num_ref_frames=4)
    ours, theirs = DPB(sps), JDPB(sps)
    fn, seen = 0, set()
    for i in range(80):
        idr = i % 29 == 0
        fn = 0 if idr else (fn + 1) % sps.max_frame_num
        is_ref = idr or rng.random() < 0.85
        ops = None if idr or rng.random() < 0.4 else \
            _commands(rng, ours, fn, sps.max_frame_num)
        lt_flag = int(idr and rng.random() < 0.5)
        seen.update(o[0] for o in ops or ())
        kw = dict(poc=2 * i, frame_num=fn, is_ref=is_ref)
        ours.store(Frame(state=None, **kw),
                   mmco_ops=[MMCOOp(*o) for o in ops] if ops else None,
                   idr=idr, long_term_flag=lt_flag)
        theirs.store(JFrame(Y=None, U=None, V=None, **kw),
                     mmco_ops=[JMMCOOp(*o) for o in ops] if ops else None,
                     idr=idr, long_term_flag=lt_flag)
        assert _marking(ours.frames) == _marking(theirs.frames), i
        nxt = (fn + 1) % sps.max_frame_num
        lst, jlst = ours.ref_list_p(nxt), theirs.ref_list_p(nxt)
        assert [f.poc for f in lst] == [f.poc for f in jlst]
        lt = [f for f in lst if f.is_long_term]
        if lt:
            mods = [(2, lt[-1].long_term_frame_idx)]
            got = ours.reorder_list(lst, [RefPicListMod(*m) for m in mods],
                                    nxt, len(lst))
            want = theirs.reorder_list(
                jlst, [JRefPicListMod(*m) for m in mods], nxt, len(jlst))
            assert [f.poc for f in got] == [f.poc for f in want]
    assert seen == {1, 2, 3, 4, 5, 6}


# ---- the port's streams ----------------------------------------------------

_STREAMS = {}


def port_stream(**kw):
    """The port's encode_frame stream of a configuration (cached) and its
    encoder."""
    key = tuple(sorted(kw.items()))
    if key not in _STREAMS:
        enc = Encoder(EncoderConfig(width=WW, height=HH, qp=QP, **kw),
                      device="cpu")
        payloads = [enc.encode_frame(*f) for f in make_frames(WW, HH, N)]
        _STREAMS[key] = (enc, payloads)
    return _STREAMS[key]


def _mmco_tuples(h):
    return [(m.op, m.value1, m.value2) for m in h.mmco_ops]


@pytest.mark.parametrize("kw", [
    dict(long_term_period=2, poc_mem_mgmt=1),
    dict(redundant_period=2, poc_mem_mgmt=1),
    dict(data_partition=1, long_term_period=3)], ids=str)
def test_slice_headers_match_jm(kw):
    """Every slice header of the stream (IDR long-term flag, MMCO,
    redundant_pic_cnt, partition A) parses as jm_tpu's parser reads it,
    and the marking it carries is there."""
    _enc, payloads = port_stream(**kw)
    data = b"".join(payloads)
    sm, pm, jsm, jpm = {}, {}, {}, {}
    names = [f.name for f in dataclasses.fields(SliceHeader)]
    marks = set()
    for u, ju in zip(split_annexb(data), jm_split(data)):
        if u.nal_unit_type == 7:
            s = parse_sps(u.rbsp)
            sm[s.seq_parameter_set_id] = s
            jsm[s.seq_parameter_set_id] = jm_sps(ju.rbsp)
        elif u.nal_unit_type == 8:
            p = parse_pps(u.rbsp, sm)
            pm[p.pic_parameter_set_id] = p
            jpm[p.pic_parameter_set_id] = jm_pps(ju.rbsp, jsm)
        elif u.nal_unit_type in (1, 2, 5):
            (h, br), (jh, jbr) = parse_slice_header(u, sm, pm), \
                jm_slice_header(ju, jsm, jpm)
            for k in names:
                if k == "mmco_ops":
                    assert _mmco_tuples(h) == _mmco_tuples(jh)
                elif k == "ref_pic_list_mod_l0":
                    assert [(m.op, m.value) for m in h.ref_pic_list_mod_l0] \
                        == [(m.op, m.value) for m in jh.ref_pic_list_mod_l0]
                else:
                    assert getattr(h, k) == getattr(jh, k), k
            assert br.pos == jbr.pos
            marks.update(o[0] for o in _mmco_tuples(h))
            marks.add(("lt", h.long_term_reference_flag))
            marks.add(("rpc", h.redundant_pic_cnt))
    if kw.get("long_term_period"):
        assert ("lt", 1) in marks and 6 in marks and 4 in marks
    if kw.get("redundant_period"):
        assert ("rpc", 1) in marks and 1 in marks


def _equal(frames_a, frames_b):
    assert len(frames_a) == len(frames_b)
    for i, (a, b) in enumerate(zip(frames_a, frames_b)):
        assert a.poc == b.poc
        for p in "YUV":
            assert np.array_equal(getattr(a, p), getattr(b, p)), (i, p)


class _Planes:
    def __init__(self, pic, poc):
        self.Y, self.U, self.V, self.poc = pic.Y, pic.U, pic.V, poc


def test_redundant_discarded_when_primary_present():
    enc, payloads = port_stream(redundant_period=2, poc_mem_mgmt=1)
    dec = H264Decoder(device="cpu")
    out = dec.decode_annexb(b"".join(payloads))
    _equal(out, [_Planes(r["frame"], 2 * i)
                 for i, r in enumerate(enc.results)])
    assert len(dec.pictures) == N


@pytest.mark.parametrize("drop", [2, 4])
def test_redundant_decoded_when_primary_lost(drop):
    """The primary slice of picture drop is removed: both decoders
    decode its redundant coding instead, to the same planes."""
    _enc, payloads = port_stream(redundant_period=2, poc_mem_mgmt=1)
    units = payloads[drop].split(b"\x00\x00\x00\x01")[1:]
    assert [u[0] for u in units] == [0x61, 0x01]    # primary, redundant
    lossy = b"".join(payloads[:drop]) + b"\x00\x00\x00\x01" + units[1] \
        + b"".join(payloads[drop + 1:])
    out = H264Decoder(device="cpu").decode_annexb(lossy)
    _equal(out, JaxDecoder().decode_annexb(lossy))
    assert len(out) == N
    # the redundant coding, at a coarser QP, differs from the primary
    enc, _payloads = port_stream(redundant_period=2, poc_mem_mgmt=1)
    assert not np.array_equal(out[drop].Y, enc.results[drop]["frame"].Y)


# ---- SEI -------------------------------------------------------------------

TONE_MAPS = [
    dict(model_id=0, min_value=16, max_value=235),
    dict(model_id=1, sigmoid_midpoint=128, sigmoid_width=64),
    dict(model_id=2,
         start_of_coded_interval=[min(i * 2, 255) for i in range(256)]),
    dict(model_id=3, coded_pivot_value=[64, 128, 255],
         sei_pivot_value=[32, 200, 255]),
]


def _messages(M, sps):
    """One message of every writer of the module M (a sei_write)."""
    return [
        M.recovery_point(3, exact_match=False, broken_link=True),
        M.user_data_unregistered(b"payload-data", uuid=bytes(range(16))),
        M.user_data_unregistered(bytes(300)),
        M.user_data_registered_itu_t_t35(0xB5, b"t35!"),
        M.scene_info(7, transition_type=2),
        M.scene_info(3, transition_type=5, second_scene_id=9),
        M.pan_scan_rect(1, [(-8, 8, -4, 4), (0, 16, 0, 9)],
                        repetition_period=2),
        M.frame_packing_arrangement(0, 3),
        *[M.tone_mapping(**kw) for kw in TONE_MAPS],
        M.tone_mapping(cancel=True),
        M.spare_pic(5, [(0, None), (1, [1, 0] * 15)], 30),
        M.sub_seq_info(1, 4, first_ref_pic=True, sub_seq_frame_num=2),
        M.dec_ref_pic_marking_repetition(True, 0,
                                         long_term_reference_flag=1),
        M.dec_ref_pic_marking_repetition(False, 7, mmco_ops=[(1, 2),
                                                             (6, 0)]),
        M.buffering_period(sps, 9000, 100),
        M.pic_timing(sps, 2, 4),
    ]


def _hrd_sps(cls):
    sps = cls(pic_width_in_mbs_minus1=5, pic_height_in_map_units_minus1=4)
    hrd = {"cpb_cnt": 2, "initial_cpb_removal_delay_length": 24,
           "cpb_removal_delay_length": 20, "dpb_output_delay_length": 18}
    sps.vui = {"nal_hrd": hrd, "pic_struct_present": 1}
    return sps


def test_sei_writers_and_parser_match_jm():
    from jm_tpu.common.types import SPS as JSPS
    sps, jsps = _hrd_sps(SPS), _hrd_sps(JSPS)
    msgs, jmsgs = _messages(W, sps), _messages(JW, jsps)
    assert msgs == jmsgs
    rbsp = W.build_sei_rbsp(msgs)
    assert rbsp == JW.build_sei_rbsp(jmsgs)
    got, want = S.parse_sei_rbsp(rbsp, sps), JS.parse_sei_rbsp(rbsp, jsps)
    assert len(got) == len(want) == len(msgs)
    for g, w in zip(got, want):
        assert (g.payload_type, g.payload, g.fields) == \
            (w.payload_type, w.payload, w.fields)
        assert g.fields or g.payload_type == S.USER_DATA_UNREGISTERED
    tone = [g.fields for g in got if g.payload_type == S.TONE_MAPPING
            and not g.fields["cancel"]]
    assert len(tone) == len(TONE_MAPS)
    for f in tone:
        assert np.array_equal(S.build_tone_map_lut(f),
                              JS.build_tone_map_lut(f))


@pytest.mark.parametrize("rbsp", [b"\x06\x20\x01", b"\x01\x04\xff",
                                  b"\xff\xff\x05\x02ab\x80"])
def test_malformed_sei_parses_like_jm(rbsp):
    got, want = S.parse_sei_rbsp(rbsp), JS.parse_sei_rbsp(rbsp)
    assert [(m.payload_type, m.payload, m.fields) for m in got] == \
        [(m.payload_type, m.payload, m.fields) for m in want]


def test_sei_golden_messages():
    data = (GOLDEN / "sei.264").read_bytes()
    dec, jdec = H264Decoder(device="cpu"), JaxDecoder()
    _equal(dec.decode_annexb(data), jdec.decode_annexb(data))
    assert [(m.payload_type, m.payload, m.fields)
            for m in dec.sei_messages] == \
        [(m.payload_type, m.payload, m.fields) for m in jdec.sei_messages]
    assert any(b"tpu codec sei test" in m.fields.get("data", b"")
               for m in dec.sei_messages)


def test_encoder_sei_user_data():
    """The port's IDRs carry the user data, which its decoder returns,
    and its SPS the VUI timing (read by jm_tpu's parser: the port's
    skips the VUI)."""
    enc = Encoder(EncoderConfig(width=WW, height=HH, qp=QP, intra_period=2,
                                sei_user_data=b"marker#1",
                                enable_vui=True), device="cpu")
    data = b"".join(enc.encode_stream(make_frames(WW, HH, 3)))
    dec = H264Decoder(device="cpu")
    dec.decode_annexb(data)
    uds = [m.fields["data"] for m in dec.sei_messages
           if m.payload_type == S.USER_DATA_UNREGISTERED]
    assert uds == [b"marker#1", b"marker#1"]
    sps = jm_sps(next(u.rbsp for u in jm_split(data) if u.nal_unit_type == 7))
    assert sps.vui["num_units_in_tick"] == 1000
    assert sps.vui["time_scale"] == 60000
