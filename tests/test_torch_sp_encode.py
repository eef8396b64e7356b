"""SP switching pictures in the port's encoder (sp_periodicity, qp_sp,
qp_sp2) against jm_tpu's on the CPU, exactly: at 64x48, QP 30, five
frames (I P SP P SP with sp_periodicity 2, QP 30 / QS 32 in the SP
pictures), through encode_frame and flush, each configuration that
jm_tpu codes with SP gives (the device route's cases, whose P pictures
are coded on the device and SP pictures on the host P coder, are in
tests/test_torch_encoder.py and test_torch_fallback.py, which compile
jm_tpu's device step anyway)
- the same bytes and the same recon of every picture;
- a stream that the port's H264Decoder and jm_tpu's decode to the recon
  (under CABAC: one both decoders refuse, as jm_tpu's writer codes an SP
  slice's MBs with its I-slice branch; ROADMAP Queue 3);
and the port's copies of jm_tpu's SP level decision and recon
(encoder/residual_np.py sp_*) give jm_tpu's levels and samples on seeded
random blocks at QP / QS pairs over 0..51. Profile 88 is written even
with the 8x8 transform or CABAC (as jm_tpu does), and SP with field
coding raises NotImplementedError in both packages."""

import numpy as np
import pytest

from jm_tpu.decoder.decoder import H264Decoder as JaxDecoder
from jm_tpu.encoder import residual_np as JRN
from jm_tpu.encoder.encoder import EncoderConfig as JaxConfig
from jm_tpu.encoder.encoder import Encoder as JaxEncoder
from jm_tpu_torch import native as N
from jm_tpu_torch.bitstream.nal import NalUnitType, split_annexb
from jm_tpu_torch.decoder.decoder import H264Decoder
from jm_tpu_torch.decoder.parset import parse_pps, parse_sps
from jm_tpu_torch.encoder import residual_np as RN
from jm_tpu_torch.encoder.encoder import Encoder, EncoderConfig

from test_pipe_stream import make_frames
from torch_streams import one_torch_thread, option_run  # noqa: F401

SP = dict(sp_periodicity=2, qp_sp=30, qp_sp2=32)
CASES = {
    # name: (EncoderConfig keywords, pipeline)
    "plain": ({}, "host"),
    "num_b": ({"num_b": 1}, "host"),
    "rdo": ({"rdo": 1}, "host"),
    "weighted_pred": ({"weighted_pred": 1}, "host"),
    "num_ref2": ({"num_ref": 2}, "host"),
    "transform8x8": ({"transform8x8": True}, "host"),
    "data_partition": ({"data_partition": 1}, "host"),
    "rc_enable": ({"rc_enable": True, "rc_bitrate": 60000.0}, "host"),
    "cabac": ({"entropy": "cabac", "cabac_adapt_init": True}, "host"),
}


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(name):
        if name not in cache:
            kw, pipeline = CASES[name]
            N.reset_routes()
            run = option_run(dict(SP, **kw), make_frames(64, 48, 5),
                             pipeline)
            cache[name] = run + ({k: dict(v) for k, v in N.routes.items()},)
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(CASES))
def test_sp_stream_matches_jm(name, runs, one_torch_thread):
    frames, jm_pay, jm_res, enc, pay, routes = runs(name)
    assert len(pay) == len(frames)
    for i, (a, b) in enumerate(zip(pay, jm_pay)):
        assert a == b, f"frame {i} payload"
    assert [(r["disp"], r["type"]) for r in enc.results] == \
        [(r["disp"], r["type"]) for r in jm_res]
    for r, j in zip(enc.results, jm_res):
        for p in "YUV":
            assert np.array_equal(getattr(r["frame"], p),
                                  getattr(j["frame"], p)), (r["disp"], p)
    anchors = [r for r in enc.results if r["type"] != "B"]
    assert [bool(r.get("sp")) for r in anchors] == \
        [False, False, True, False, True][:len(anchors)]
    if CASES[name][0].get("entropy") != "cabac":
        # every SP slice takes the P slice's serializer, counted under sp
        assert routes["sp"]["serialize"] == sum(
            bool(r.get("sp")) for r in enc.results)


@pytest.mark.parametrize("name", [n for n in CASES if n != "cabac"])
def test_sp_stream_decodes_to_recon(name, runs, one_torch_thread):
    """Both decoders decode the stream to the recon, in decode order."""
    _frames, _jp, _jr, enc, pay, _routes = runs(name)
    data = b"".join(pay)
    for dec in (H264Decoder(device="cpu"), JaxDecoder()):
        out = dec.decode_annexb(data)
        assert len(out) == len(enc.results)
        for f, r in zip(out, enc.results):
            for p in "YUV":
                assert np.array_equal(getattr(f, p), getattr(r["frame"], p))


def test_cabac_sp_is_refused_by_both_decoders(runs):
    """The copied fault: jm_tpu writes CABAC SP slices (their MBs through
    the I-slice branch of its writer) under profile 88, and neither its
    decoder nor the port's reads them."""
    data = b"".join(runs("cabac")[4])
    with pytest.raises(NotImplementedError, match="SP slices under CABAC"):
        H264Decoder(device="cpu").decode_annexb(data)
    with pytest.raises(NotImplementedError):
        JaxDecoder().decode_annexb(data)


@pytest.mark.parametrize("name,t8", [("plain", 0), ("transform8x8", 1),
                                      ("cabac", 0)])
def test_profile_88(name, t8, runs):
    """SP pictures make the stream Extended (profile_idc 88), also with
    the 8x8 transform in its PPS or CABAC, as jm_tpu writes them."""
    units = list(split_annexb(runs(name)[4][0]))
    sps = parse_sps(units[0].rbsp)
    assert units[0].nal_unit_type == NalUnitType.SPS
    assert sps.profile_idc == 88
    pps = parse_pps(units[1].rbsp, {sps.seq_parameter_set_id: sps})
    assert pps.transform_8x8_mode_flag == t8


def test_sp_with_fields_raises():
    kw = dict(width=64, height=64, pic_interlace=1, **SP)
    with pytest.raises(NotImplementedError):
        JaxEncoder(JaxConfig(**kw))
    with pytest.raises(NotImplementedError, match="SP pictures"):
        Encoder(EncoderConfig(**kw), device="cpu")


@pytest.mark.parametrize("kw", [{"sp_periodicity": -1}, {"qp_sp": 52},
                                {"qp_sp2": -1}])
def test_sp_config_out_of_range_raises(kw):
    with pytest.raises(ValueError, match=next(iter(kw))):
        Encoder(EncoderConfig(**kw), device="cpu")


def test_config_fields_are_jm_tpus():
    ours = set(EncoderConfig.__dataclass_fields__)
    theirs = set(JaxConfig.__dataclass_fields__)
    assert ours == theirs and len(ours) == 80
    for f in ("sp_periodicity", "qp_sp", "qp_sp2"):
        assert getattr(EncoderConfig(), f) == getattr(JaxConfig(), f)


# ---- the level decision and recon (residual_np sp_*) ---------------------

QPS = [(0, 0), (12, 30), (28, 28), (30, 32), (40, 17), (51, 51), (51, 3)]


@pytest.mark.parametrize("qp,qs", QPS)
def test_sp_luma_matches_jm(qp, qs):
    rng = np.random.default_rng(qp * 64 + qs)
    lam = 0.85 * 2.0 ** ((qp - 12) / 3.0) * 4.0
    orig = rng.integers(0, 256, (24, 4, 4))
    pred = np.clip(orig + rng.integers(-40, 41, (24, 4, 4)), 0, 255)
    lev, P = RN.sp_luma_levels_mb(orig, pred, qp, qs, lam, native=False)
    for k in range(24):
        jlev, jP = JRN.sp_luma_levels(orig[k], pred[k], qp, qs, lam)
        assert np.array_equal(lev[k], jlev) and np.array_equal(P[k], jP)
        assert np.array_equal(RN.sp_luma_recon(P[k], lev[k], qp, qs),
                              JRN.sp_luma_recon(jP, jlev, qp, qs))
    il = rng.integers(-5000, 5001, (24, 4, 4))
    assert np.array_equal(RN.sp_requant_4x4(il, qs),
                          JRN.sp_requant_4x4(il, qs))


@pytest.mark.parametrize("qp,qs", QPS)
def test_sp_chroma_matches_jm(qp, qs):
    rng = np.random.default_rng(1000 + qp * 64 + qs)
    lam = 0.85 * 2.0 ** ((qp - 12) / 3.0) * 4.0
    for _ in range(8):
        orig = rng.integers(0, 256, (8, 8))
        pred = np.clip(orig + rng.integers(-30, 31, (8, 8)), 0, 255)
        got = RN.sp_chroma_levels(orig, pred, qp, qs, lam,
                                  native=False)
        want = JRN.sp_chroma_levels(orig, pred, qp, qs, lam)
        for a, b in zip(got, want):
            assert np.array_equal(a, b)
        dc, ac, P, mp1 = got
        assert np.array_equal(RN.sp_chroma_recon(P, mp1, dc, ac, qp, qs),
                              JRN.sp_chroma_recon(P, mp1, dc, ac, qp, qs))


@pytest.mark.parametrize("qp,qs", QPS)
def test_native_sp_levels_match_python(qp, qs):
    """The native SP level decision (jm_enc.cpp sp_levels) against its
    Python twin (residual_np.sp_quant_coeffs), luma 4x4 blocks and both
    chroma kinds (the 2x2 DC with the c2x2 rate, the AC)."""
    rng = np.random.default_rng(2000 + qp * 64 + qs)
    lam = 0.85 * 2.0 ** ((qp - 12) / 3.0) * 4.0
    ob = rng.integers(0, 256, (48, 4, 4))
    pb = np.clip(ob + rng.integers(-60, 61, (48, 4, 4)), 0, 255)
    got = RN.sp_luma_levels_mb(ob, pb, qp, qs, lam, native=True)
    want = RN.sp_luma_levels_mb(ob, pb, qp, qs, lam, native=False)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert got[0].any() or qp == 51        # QP 51 codes no level here
    for _ in range(8):
        o8 = rng.integers(0, 256, (8, 8))
        p8 = np.clip(o8 + rng.integers(-60, 61, (8, 8)), 0, 255)
        got = RN.sp_chroma_levels(o8, p8, qp, qs, lam, native=True)
        want = RN.sp_chroma_levels(o8, p8, qp, qs, lam, native=False)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_native_sp_coder_matches_python(monkeypatch):
    """A stream whose SP pictures take the Python level decision
    (PPicture.native_sp False) has the bytes of the native one."""
    from jm_tpu_torch.encoder.p_host import PPicture
    frames = make_frames(64, 48, 3, seed=5)
    out = []
    for native in (True, False):
        monkeypatch.setattr(PPicture, "native_sp", native)
        enc = Encoder(EncoderConfig(width=64, height=48, pipeline="host",
                                    **SP), device="cpu")
        out.append([enc.encode_frame(*f) for f in frames])
    assert out[0] == out[1]
