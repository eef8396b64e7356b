"""MVC stereo (two views, Annex H: Stereo High) in the port's Encoder
against jm_tpu's on the CPU, exactly. The stereo pair is the seeded
synthetic clip as view 0 and the same frames shifted 8 luma / 4 chroma
columns as view 1 (as jm_tpu's tests/test_mvc.py builds it), at 64x48,
QP 30, through encode_frame(..., view1=) and flush:
- (a) IPPP on the host pipeline with intra_period 2: two anchor access
  units (view 1 predicts from view 0 alone) and two non-anchor ones
  (view 0, then view 1's references, behind the inter-view command);
- (b) one B picture between the anchors, CABAC, two references and
  view1_qp_offset 3: view-1 B pictures from the view-1 companions of
  the view-0 anchors;
- (c) view 0's P pictures on the device route (pipeline="device",
  md_low in both packages), view 1's on the host coders;
each gives jm_tpu's bytes, its recon of every view-0 picture and of
view 1's references, and view-1 pictures equal to jm_tpu's decode of
its own stream. Pinned: view-1 P pictures code at qp + view1_qp_offset
whatever qp_p says, and view-1 B slices carry no inter-view reference
(ROADMAP Queue 3); the refusals: num_views outside 1 / 2 (ValueError),
redundant pictures or field coding with two views (NotImplementedError
in both packages), and a frame without its view-1 planes, also through
encode_stream (ValueError in both)."""

import numpy as np
import pytest

from jm_tpu.decoder.decoder import H264Decoder as JaxDecoder
from jm_tpu.encoder.encoder import Encoder as JaxEncoder
from jm_tpu.encoder.encoder import EncoderConfig as JaxConfig
from jm_tpu_torch.bitstream.nal import NalUnitType, split_annexb
from jm_tpu_torch.decoder.header import parse_slice_header
from jm_tpu_torch.decoder.parset import parse_pps, parse_subset_sps
from jm_tpu_torch.encoder.encoder import Encoder, EncoderConfig

from test_pipe_stream import make_frames
from torch_streams import one_torch_thread  # noqa: F401

W, H, QP = 64, 48, 30
CASES = {
    # name: (EncoderConfig keywords of both packages, frames)
    "ippp_host": (dict(intra_period=2, pipeline="host"), 4),
    "b_cabac": (dict(num_b=1, entropy="cabac", num_ref=2,
                     view1_qp_offset=3, pipeline="host"), 5),
    "device": (dict(pipeline="device", device_rd=False), 3),
}


def stereo_pair(n: int, w: int = W, h: int = H):
    """The seeded clip (view 0) and its copy shifted 8 luma / 4 chroma
    columns (view 1)."""
    left = make_frames(w, h, n)
    right = [(np.roll(Y, -8, axis=1), np.roll(U, -4, axis=1),
              np.roll(V, -4, axis=1)) for Y, U, V in left]
    return left, right


def encode(enc, left, right) -> bytes:
    out = b"".join(enc.encode_frame(*f, view1=g)
                   for f, g in zip(left, right))
    return out + enc.flush()


def run_both(kw: dict, n: int, w: int = W, h: int = H):
    left, right = stereo_pair(n, w, h)
    jenc = JaxEncoder(JaxConfig(width=w, height=h, qp=QP, num_views=2,
                                **kw))
    enc = Encoder(EncoderConfig(width=w, height=h, qp=QP, num_views=2, **kw),
                  device="cpu")
    return jenc, encode(jenc, left, right), enc, encode(enc, left, right)


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = run_both(*CASES[name])
        return cache[name]
    return get


def _planes(f):
    return (f.Y, f.U, f.V)


@pytest.mark.parametrize("case", CASES)
def test_stream_is_jm_tpus(runs, case):
    _, want, _, got = runs(case)
    assert got == want
    types = {n.nal_unit_type for n in split_annexb(got)}
    assert {NalUnitType.PREFIX, NalUnitType.SUBSET_SPS,
            NalUnitType.SLICE_EXT} <= types


@pytest.mark.parametrize("case", CASES)
def test_recon_is_jm_tpus(runs, case):
    jenc, want, enc, _ = runs(case)
    by_disp = lambda r: r["disp"]                      # noqa: E731
    for jr, r in zip(sorted(jenc.results, key=by_disp),
                     sorted(enc.results, key=by_disp)):
        assert jr["disp"] == r["disp"] and jr["type"] == r["type"]
        for a, b in zip(_planes(jr["frame"]), _planes(r["frame"])):
            assert np.array_equal(a, b), r["disp"]
    # view 1: jm_tpu keeps its reference pictures; every view-1 picture
    # equals jm_tpu's decode of its own stream, in decode order
    assert len(enc.refs_v1) == len(jenc.refs_v1) > 0
    for jf, f in zip(jenc.refs_v1, enc.refs_v1):
        assert jf.poc == f.poc
        for a, b in zip(_planes(jf), _planes(f)):
            assert np.array_equal(a, b)
    dec1 = [f for f in JaxDecoder().decode_annexb(want) if f.view_id == 1]
    assert len(dec1) == len(enc.results_v1) == CASES[case][1]
    for d, r in zip(dec1, enc.results_v1):
        assert d.poc == r["frame"].poc
        for a, b in zip(_planes(d), _planes(r["frame"])):
            assert np.array_equal(a, b), r["disp"]


def _view1_headers(stream):
    nals = split_annexb(stream)
    subset = {s.seq_parameter_set_id: s for s in
              (parse_subset_sps(n.rbsp) for n in nals
               if n.nal_unit_type == NalUnitType.SUBSET_SPS)}
    pps = {}
    for n in nals:
        if n.nal_unit_type == NalUnitType.PPS:
            p = parse_pps(n.rbsp, subset)
            pps[p.pic_parameter_set_id] = p
    return [parse_slice_header(n, subset, pps)[0] for n in nals
            if n.nal_unit_type == NalUnitType.SLICE_EXT]


def test_view1_b_has_no_inter_view_reference(runs):
    """A view-1 B slice has one active reference per list and no
    inter-view command, so neither list reaches the view-0 picture that
    the decoder appends (jm_tpu's choice, inter_view_flag 0)."""
    hdrs = _view1_headers(runs("b_cabac")[3])
    bs = [h for h in hdrs if h.slice_type.name == "B"]
    assert bs
    for h in bs:
        assert h.num_ref_idx_l0_active_minus1 == 0
        assert h.num_ref_idx_l1_active_minus1 == 0
        assert all(m.op < 4 for m in h.ref_pic_list_mod_l0
                   + h.ref_pic_list_mod_l1)
    ps = [h for h in hdrs if h.slice_type.name == "P" and not h.is_idr]
    assert ps and all(h.ref_pic_list_mod_l0[0].op == 5 for h in ps)


def test_view1_p_ignores_qp_p():
    """View-1 P pictures code at qp + view1_qp_offset: jm_tpu's
    _emit_view1 gets no picture QP from the anchor path, so qp_p does
    not reach them (ROADMAP Queue 3); the port keeps the bytes."""
    jenc, want, enc, got = run_both(dict(qp_p=36, view1_qp_offset=2,
                                         pipeline="host"), 3, 32, 32)
    assert got == want
    assert [r["qp"] for r in enc.results] == [QP, 36, 36]
    assert [r["qp"] for r in enc.results_v1] == [QP + 2] * 3
    hdrs = _view1_headers(got)
    assert [h.slice_qp_delta for h in hdrs] == [QP + 2 - 26] * 3


@pytest.mark.parametrize("kw,exc", [
    (dict(num_views=2, redundant_period=2), NotImplementedError),
    (dict(num_views=2, pic_interlace=1, height=64), NotImplementedError),
])
def test_refusals_are_jm_tpus(kw, exc):
    kw = dict(dict(width=64, height=48), **kw)
    with pytest.raises(exc):
        JaxEncoder(JaxConfig(**kw))
    with pytest.raises(exc, match="redundant|pic_interlace"):
        Encoder(EncoderConfig(**kw), device="cpu")


@pytest.mark.parametrize("views", [0, 3, True])
def test_num_views_range(views):
    with pytest.raises(ValueError, match="num_views"):
        Encoder(EncoderConfig(width=64, height=48, num_views=views),
                device="cpu")


@pytest.mark.parametrize("call", ["encode_frame", "encode_stream"])
def test_view1_planes_required(call):
    """Without view1 a two-view encoder raises ValueError; encode_stream
    takes encode_frame (no pipe with two views), as jm_tpu's does."""
    frames = make_frames(32, 32, 2)
    for enc in (JaxEncoder(JaxConfig(width=32, height=32, num_views=2,
                                     pipeline="device")),
                Encoder(EncoderConfig(width=32, height=32, num_views=2),
                        device="cpu")):
        with pytest.raises(ValueError, match="view1"):
            if call == "encode_frame":
                enc.encode_frame(*frames[0])
            else:
                enc.encode_stream(frames)
