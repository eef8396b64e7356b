"""The port's weighted prediction in the encoder against jm_tpu's, on
the CPU (the codec is integer-exact: every tolerance is zero):
- encoder/wp_est.py's three estimates and build_wp_params against
  jm_tpu's, on the references of a coded fade;
- the quadrant integer search table (ops/enc.full_search_sad_quad)
  against jm_tpu's per-4x4 table summed over each quadrant;
- one P picture of the serial host P coder (encoder/p_host.PPicture)
  against jm_tpu's _FrameEncoder: every MB's decision, motion, levels
  and the recon;
- whole streams: Encoder(weighted_pred=1) with each estimate and beside
  the port's other options, through encode_stream and encode_frame,
  against jm_tpu's Encoder(pipeline="device"): the Annex-B bytes, every
  picture's deblocked recon, and the port's decode of the stream.
The weighted B cases are in tests/test_torch_bframes.py."""

import numpy as np
import pytest
import torch

from jm_tpu.encoder import me as JME
from jm_tpu.encoder import wp_est as JW
from jm_tpu.encoder.encoder import Encoder as JaxEncoder
from jm_tpu.encoder.encoder import EncoderConfig as JaxConfig
from jm_tpu_torch.common.tables import chroma_qp
from jm_tpu_torch.common.types import SliceType
from jm_tpu_torch.decoder.decoder import H264Decoder
from jm_tpu_torch.encoder import wp_est as W
from jm_tpu_torch.encoder.encoder import (Encoder, EncoderConfig, lambda_me,
                                          lambda_mode4)
from jm_tpu_torch.encoder.p_host import PPicture
from jm_tpu_torch.ops import enc as E

from test_pipe_stream import make_frames
from torch_streams import fade

WD, HT, QP = 64, 48, 28
# case: (frames, encoder keywords), each with weighted_pred=1
CASES = {
    "dc_ratio": (5, {}),
    "lms": (5, dict(wp_method=1)),
    "iter_mc": (4, dict(wp_iter_mc=2)),
    "mcprec": (4, dict(wp_method=1, wp_mcprec=1)),
    "cabac": (5, dict(entropy="cabac", cabac_adapt_init=True)),
    "slices_mbs": (4, dict(slice_mode=1, slice_argument=5)),
    "slices_bytes_mcprec": (4, dict(slice_mode=2, slice_argument=60,
                                    wp_mcprec=1)),
    "intra_refresh": (4, dict(intra_mb_refresh=3)),
    "qp_p": (4, dict(qp_p=32, device_rd=False)),
    "rate_control": (5, dict(rc_enable=True, rc_bitrate=150000.0,
                             wp_mcprec=1)),
    "long_term_mmco": (7, dict(long_term_period=2, intra_period=3,
                               poc_mem_mgmt=1, ref_reorder=1)),
    "data_partition": (4, dict(data_partition=1)),
    "data_partition_fmo": (4, dict(data_partition=1, num_slice_groups=2)),
    "no_loop_filter": (4, dict(deblock=False, entropy="cabac")),
    "redundant": (4, dict(redundant_period=2)),
    "poc2_vui_sei": (4, dict(poc_type=2, enable_vui=True,
                             sei_user_data=b"wp")),
}


def _clip(n, seed=5):
    return fade(make_frames(WD, HT, n, seed=seed))


@pytest.fixture(scope="module")
def runs():
    """Per case, computed once: (jm_tpu's payloads and results, the
    port's payloads and results through encode_frame + flush, and its
    payloads through encode_stream + flush)."""
    cache = {}

    def get(case):
        if case not in cache:
            n, kw = CASES[case]
            kw = {"weighted_pred": 1, **kw}
            frames = _clip(n)
            jkw = {"device_rd": True, **kw}
            jenc = JaxEncoder(JaxConfig(width=WD, height=HT, qp=QP,
                                        pipeline="device", **jkw))
            want = [jenc.encode_frame(*f) for f in frames] + [jenc.flush()]
            cfg = EncoderConfig(width=WD, height=HT, qp=QP, **kw)
            enc = Encoder(cfg, device="cpu")
            got = [enc.encode_frame(*f) for f in frames] + [enc.flush()]
            enc2 = Encoder(cfg, device="cpu")
            assert not enc2._pipe_ok()
            stream = enc2.encode_stream(frames) + [enc2.flush()]
            cache[case] = (want, jenc.results, got, enc.results, stream)
        return cache[case]

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield get
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", list(CASES))
def test_wp_stream_bytes_match_jm(case, runs):
    want, _jres, got, res, stream = runs(case)
    assert got == want
    assert stream == want
    # every P picture wrote its table; the fade makes the estimated ones
    # nontrivial (wp_mcprec may ship the default table)
    tables = [r["wp_l0"] for r in res if r["type"] == "P"]
    assert tables
    if not CASES[case][1].get("wp_mcprec"):
        assert any(W.is_nontrivial(t) for t in tables)


@pytest.mark.parametrize("case", list(CASES))
def test_wp_stream_recon_matches_jm(case, runs):
    _want, jres, _got, res, _stream = runs(case)
    assert len(res) == len(jres)
    for a, b in zip(res, jres):
        assert (a["disp"], a["type"], a["qp"]) == (b["disp"], b["type"],
                                                   b["qp"])
        for plane in "YUV":
            assert np.array_equal(getattr(a["frame"], plane),
                                  getattr(b["frame"], plane)), \
                f"picture {a['disp']} ({a['type']}) plane {plane}"


@pytest.mark.parametrize("case", list(CASES))
def test_wp_stream_decodes_to_the_recon(case, runs):
    _want, _jres, got, res, _stream = runs(case)
    out = H264Decoder(device="cpu").decode_annexb(b"".join(got))
    assert len(out) == len(res)
    for f, r in zip(out, res):
        assert f.poc == r["frame"].poc
        for plane in "YUV":
            assert np.array_equal(getattr(f, plane),
                                  getattr(r["frame"], plane))


@pytest.fixture(scope="module")
def two_pictures():
    """A fade's IDR and first P picture coded by both encoders with
    weighted_pred=1: (the frames, jm_tpu's encoder, the port's encoder
    after the IDR only)."""
    frames = _clip(2, seed=9)
    jenc = JaxEncoder(JaxConfig(width=WD, height=HT, qp=QP,
                                pipeline="device", device_rd=True,
                                weighted_pred=1))
    for f in frames:
        jenc.encode_frame(*f)
    enc = Encoder(EncoderConfig(width=WD, height=HT, qp=QP, weighted_pred=1),
                  device="cpu")
    enc.encode_frame(*frames[0])
    return frames, jenc, enc


@pytest.mark.parametrize("est", ["explicit", "lms", "lms_offset",
                                 "mc_iter"])
def test_estimates_match_jm(est, two_pictures):
    """The tables of every estimate, and the WPParams built from them,
    field by field against jm_tpu's, on the port's IDR (its recon is
    jm_tpu's) and the P picture's source."""
    frames, jenc, enc = two_pictures
    ref = enc.refs[0]
    jref = jenc.results[0]["frame"]
    fn, kw = {"explicit": ("estimate_explicit", {}),
              "lms": ("estimate_lms", {}),
              "lms_offset": ("estimate_lms", {"select_offset": 1}),
              "mc_iter": ("estimate_mc_iter", {"iters": 2})}[est]
    got = getattr(W, fn)(*frames[1], [ref], **kw)
    want = getattr(JW, fn)(*frames[1], [jref], **kw)
    assert got == want
    assert W.is_nontrivial(got) == JW.is_nontrivial(want)
    wp = W.build_wp_params(SliceType.P, enc.pps, [ref], [], 2, wp_l0=got)
    jwp = JW.build_wp_params(SliceType.P, jenc.pps, [jref], [], 2,
                             wp_l0=want)
    for k in ("mode", "luma_denom", "chroma_denom", "weight", "offset",
              "wbp_w0", "wbp_w1"):
        assert np.array_equal(getattr(wp, k), getattr(jwp, k)), k


@pytest.mark.parametrize("sr", [1, 4, 16])
def test_quadrant_sad_table_matches_jm(sr):
    rng = np.random.default_rng(sr)
    mb_w, mb_h = 3, 2
    Y = rng.integers(0, 256, (16 * mb_h, 16 * mb_w), dtype=np.uint8)
    R = rng.integers(0, 256, (16 * mb_h, 16 * mb_w), dtype=np.uint8)
    pad = np.pad(R, E.PAD, mode="edge")
    got = E.full_search_sad_quad(torch.from_numpy(Y), torch.from_numpy(pad),
                                 mb_w, mb_h, sr).numpy()
    b4 = JME.full_search_blk4_sads(Y, pad, mb_w, mb_h, sr, E.PAD)
    assert np.array_equal(got, b4[:, :, JME.QUAD_BLKS].sum(axis=3))
    assert np.array_equal(
        E.full_search_sad16(torch.from_numpy(Y), torch.from_numpy(pad),
                            mb_w, mb_h, sr).numpy(), b4.sum(axis=2))


@pytest.mark.parametrize("field", ["mb_class", "inter_mode", "skip", "mv",
                                   "ref_idx", "cbp", "i16_mode",
                                   "chroma_mode", "luma_coef", "luma_dc",
                                   "luma_nnz", "chroma_dc", "chroma_coef",
                                   "chroma_nnz", "qp", "slice_id"])
def test_host_p_coder_matches_jm(field, two_pictures):
    """One P picture of the host P coder (the quadrant table made on the
    device, the weights of the DC-ratio table) against the picture of
    jm_tpu's _FrameEncoder, field by field, and its undeblocked recon."""
    frames, jenc, enc = two_pictures
    ref = enc.refs[0]
    table = W.estimate_explicit(*frames[1], [ref])
    wp = W.build_wp_params(SliceType.P, enc.pps, [ref], [], 2, wp_l0=table)
    sads = E.full_search_sad_quad(torch.from_numpy(frames[1][0]),
                                  ref.state[0][0], enc.mb_w, enc.mb_h,
                                  16).numpy()
    c = PPicture(frames[1], QP, chroma_qp(QP, 0), lambda_me(QP),
                 lambda_mode4(QP), [ref.host_ref()], [sads],
                 [list(range(enc.mb_w * enc.mb_h))], 16, (), wp)
    fe = jenc._last_fe
    assert np.array_equal(getattr(c.pic, field), getattr(fe.pic, field))
    for plane in ("recY", "recU", "recV"):
        assert np.array_equal(getattr(c, plane), getattr(fe, plane))
    assert sum(c.mix.values()) == enc.mb_w * enc.mb_h
