"""Basic-unit rate control and the explicit sequence coder of the
port's Encoder against jm_tpu's, on the CPU, exactly.

Basic units (rc_basic_unit: the QP of each unit of that many MBs of a P
picture moves with the bits spent, ratectl.BasicUnitRC, counted by
encoder/rdo.count_mb_bits): the controller step by step, the bit count
MB by MB, and streams (CAVLC, CABAC whose MBs are counted in CAVLC bits
as in jm_tpu, slices, several references with sub-8x8 partitions, the
device pipeline whose first P picture, without a target, stays on the
device route) at 96x80 on tests/test_pipe_stream.make_frames: payloads
byte for byte, recon, both decoders' pictures. jm_tpu's fault, copied:
pic.qp holds the unit's QP also on MBs that send no mb_qp_delta (P_Skip,
inter MBs without coefficients), which a decoder gives the QP of the MB
before them (spec 7.4.5), so the encoder deblocks their edges with QPs
the decoder never sees; at 112x96, QP 28, 20 kbit/s, units of 7 MBs, 6
frames, the decoders' pictures differ from the recon, and the port keeps
jm_tpu's stream and recon.

The explicit sequence coder (encoder/gop.py encode_explicit_seq): the
script of tests/test_explicit_seq.py parsed as jm_tpu parses it, its
refusals, and its schedule (a reference B, an IDR per cycle) encoded
with num_ref=2 against jm_tpu's."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from jm_tpu import ratectl as JRC
from jm_tpu.decoder.decoder import H264Decoder as JaxDecoder
from jm_tpu.encoder import gop as JG
from jm_tpu.encoder.encoder import Encoder as JaxEncoder
from jm_tpu.encoder.encoder import EncoderConfig as JaxConfig
from jm_tpu.encoder.rdo import count_mb_bits as jax_count_mb_bits
from jm_tpu_torch import ratectl as RC
from jm_tpu_torch.common.types import SliceType
from jm_tpu_torch.decoder.decoder import H264Decoder
from jm_tpu_torch.encoder import gop as G
from jm_tpu_torch.encoder.encoder import Encoder, EncoderConfig
from jm_tpu_torch.encoder.rdo import count_mb_bits
from jm_tpu_torch.ops import enc as E

import test_explicit_seq as T
import torch_streams as S
from test_pipe_stream import make_frames
from torch_streams import one_torch_thread  # noqa: F401

RC_KW = dict(rc_enable=True, rc_bitrate=40000.0, rc_basic_unit=3)
CASES = {
    "cavlc": (dict(RC_KW), "host"),
    "cabac": (dict(RC_KW, entropy="cabac"), "host"),
    "slices": (dict(RC_KW, rc_basic_unit=5, slice_mode=1, slice_argument=8),
               "host"),
    "num_ref2_sub8x8": (dict(RC_KW, num_ref=2, sub8x8=True), "host"),
    "device": (dict(RC_KW, device_rd=True), "device"),
}
_RUNS = {}


def _run(case):
    if case not in _RUNS:
        cfg, pipeline = CASES[case]
        _RUNS[case] = S.option_run(cfg, make_frames(S.W, S.H, 4), pipeline)
    return _RUNS[case]


@pytest.mark.parametrize("case", list(CASES))
def test_basic_unit_payloads_match_jm(case):
    S.check_byte_identical(_run(case))


@pytest.mark.parametrize("case", list(CASES))
def test_basic_unit_decodes_like_jm(case):
    """The port's decoder gives jm_tpu's decoder's pictures (the recon,
    where no MB hits the QP fault)."""
    data = b"".join(_run(case)[4])
    got = H264Decoder(device="cpu").decode_annexb(data)
    want = JaxDecoder().decode_annexb(data)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        for plane in "YUV":
            assert np.array_equal(getattr(a, plane), getattr(b, plane))


@pytest.mark.parametrize("case", list(CASES))
def test_basic_units_move_the_qp(case):
    """The P pictures with a target are coded in basic units, with MBs
    of several QPs; the first P picture (no target yet) is not."""
    enc = _run(case)[3]
    assert "mb_qps" not in enc.results[1]
    assert any(len(r["mb_qps"]) > 1 for r in enc.results if "mb_qps" in r)


@pytest.mark.parametrize("target,n_mbs,bu", [(900, 30, 3), (5000, 99, 11),
                                             (40, 30, 1), (0, 30, 6)])
def test_basic_unit_rc_matches_jm(target, n_mbs, bu):
    """ratectl.BasicUnitRC against jm_tpu's, MB by MB, on seeded MB bit
    counts."""
    rng = np.random.default_rng(target + bu)
    a = RC.BasicUnitRC(30, target, n_mbs, bu)
    b = JRC.BasicUnitRC(30, target, n_mbs, bu)
    for _ in range(n_mbs):
        assert a.mb_qp() == b.mb_qp()
        bits = int(rng.integers(0, 3 * max(target, 30) // n_mbs + 2))
        a.report(bits)
        b.report(bits)
        assert (a.qp, a.spent, a.done) == (b.qp, b.spent, b.done)


def test_count_mb_bits_matches_jm():
    """encoder/rdo.count_mb_bits of every MB of a P picture with
    sub-8x8 partitions and two references, at several running QPs,
    against jm_tpu's."""
    enc = S.option_run(dict(num_ref=2, sub8x8=True),
                       S.motion_clip(3))[3]
    refs = enc.refs[:2]
    frame = S.motion_clip(4)[3]
    from jm_tpu_torch.encoder.encoder import lambda_me, lambda_mode4
    from jm_tpu_torch.encoder.p_host import PPicture
    src = torch.from_numpy(frame[0])
    sads = [E.full_search_sad_quad(src, r.state[0][0], 6, 5, 16).numpy()
            for r in refs]
    blk4 = [E.full_search_sad_blk4(src, r.state[0][0], 6, 5, 16).numpy()
            for r in refs]
    pic = PPicture(frame, 30, 30, lambda_me(30), lambda_mode4(30),
                   [r.host_ref() for r in refs], sads, [list(range(30))], 16,
                   blk4=blk4, sub8x8=True).pic
    pic.qp[:] = np.arange(30) % 5 + 28
    fe = SimpleNamespace(pic=pic, enc=SimpleNamespace(
        sps=enc.sps, pps=enc.pps, num_ref_active=2))
    for qp in (26, 30):
        fe.qp = qp
        for addr in range(30):
            assert count_mb_bits(pic, enc.sps, enc.pps, qp, addr,
                                 SliceType.P, 2) == \
                jax_count_mb_bits(fe, addr, SliceType.P)


def test_basic_unit_qp_fault_is_copied():
    """jm_tpu's basic-unit QP fault, copied: the port's stream and recon
    equal jm_tpu's; both decoders give the same pictures, which differ
    from the recon; the MBs whose pic.qp is not the QP a decoder derives
    (they send no mb_qp_delta) are counted."""
    frames = make_frames(112, 96, 6)
    cfg = dict(width=112, height=96, qp=28, rc_enable=True,
               rc_bitrate=20000.0, rc_basic_unit=7)
    jenc = JaxEncoder(JaxConfig(**cfg))
    want = [jenc.encode_frame(*f) for f in frames]
    enc = Encoder(EncoderConfig(pipeline="host", **cfg), device="cpu")
    got = [enc.encode_frame(*f) for f in frames]
    assert got == want
    S.same_recon(enc.results, jenc.results)
    data = b"".join(got)
    dec = H264Decoder(device="cpu").decode_annexb(data)
    jdec = JaxDecoder().decode_annexb(data)
    differ = 0
    for a, b, r in zip(dec, jdec, enc.results):
        for plane in "YUV":
            assert np.array_equal(getattr(a, plane), getattr(b, plane))
        differ += not np.array_equal(a.Y, r["frame"].Y)
    assert differ > 0
    assert sum(r.get("qp_unsent", 0) for r in enc.results) > 0


SCRIPT = T.SCRIPT


def test_parse_explicit_seq_matches_jm():
    assert G.parse_explicit_seq_file(SCRIPT) == [
        G.SeqEntry(**vars(e)) for e in JG.parse_explicit_seq_file(SCRIPT)]


@pytest.mark.parametrize("text", [
    "Sequence { Frame { SeqNumber : 0\nSliceType : P\n} }",
    "Sequence { Frame { SeqNumber : 0\nSliceType : I\nReference : 0\n} }",
    "Sequence { FrameCount : 1 }",
    "Sequence { Frame { SliceType : I\n} }",
])
def test_explicit_seq_refusals_match_jm(text):
    with pytest.raises(ValueError) as want:
        JG.parse_explicit_seq_file(text)
    with pytest.raises(ValueError) as got:
        G.parse_explicit_seq_file(text)
    assert str(got.value) == str(want.value)


def test_explicit_seq_b_without_later_reference_raises():
    entries = G.parse_explicit_seq_file(
        "Sequence { Frame { SeqNumber : 0\nSliceType : I\nIDRPicture : 1\n"
        "} Frame { SeqNumber : 1\nSliceType : B\n} }")
    enc = Encoder(EncoderConfig(width=112, height=96, num_b=1), device="cpu")
    with pytest.raises(ValueError, match="both sides"):
        G.encode_explicit_seq(enc, T._frames(2), entries)


@pytest.fixture(scope="module")
def explicit_run():
    frames = T._frames(10)
    cfg = dict(width=112, height=96, qp=30, num_b=1, num_ref=2)
    jenc = JaxEncoder(JaxConfig(**cfg))
    want = JG.encode_explicit_seq(jenc, frames,
                                  JG.parse_explicit_seq_file(SCRIPT))
    enc = Encoder(EncoderConfig(pipeline="host", **cfg), device="cpu")
    got = G.encode_explicit_seq(enc, frames, G.parse_explicit_seq_file(SCRIPT))
    return want, jenc, got, enc


def test_explicit_seq_payloads_match_jm(explicit_run):
    want, jenc, got, enc = explicit_run
    assert got == want
    assert [r["type"] for r in sorted(enc.results,
                                      key=lambda r: r["disp"])] == \
        list("IBPBP") * 2
    S.same_recon(enc.results, jenc.results)


def test_explicit_seq_decodes_like_jm(explicit_run):
    """Both decoders give the recon, in decode order."""
    _, _, got, enc = explicit_run
    data = b"".join(got)
    for dec in (H264Decoder(device="cpu"), JaxDecoder()):
        out = dec.decode_annexb(data)
        assert len(out) == len(enc.results) == 10
        for frame, r in zip(out, enc.results):
            for plane in "YUV":
                assert np.array_equal(getattr(frame, plane),
                                      getattr(r["frame"], plane))
