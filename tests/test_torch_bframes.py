"""The port's encoder with B pictures against jm_tpu's, on the CPU:
Encoder(device="cpu") and jm_tpu's Encoder(pipeline="device") encode the
same seeded 64x48 clips frame by frame (encode_frame, then flush); the
Annex-B bytes of every call must be identical, every coded picture's
deblocked recon equal (the codec is integer-exact: the tolerance is
zero), and the port's decoder must decode the stream to the recon.

Cases: num_b 1 and 2 in CAVLC and CABAC, the dyadic pyramid, an explicit
GOP string, qp_b, rate control, open-GOP I anchors with the recovery
point SEI and CRA marking, and the port's other options beside B
pictures (slices of both modes, md_low, data partitioning, long-term
anchors with POC-based MMCO and list reordering, intra refresh with the
loop filter off); weighted bi-prediction, explicit and implicit, on a
fade (the wp_ cases: IbP, a pyramid and a GOP string, CAVLC and CABAC,
with weighted P anchors, the LMS estimate, slices, data partitions and
a long-term anchor). Configurations jm_tpu refuses with B pictures, and
weighted_bipred values outside 0..2, raise at construction."""

import numpy as np
import pytest
import torch

from jm_tpu.encoder.encoder import Encoder as JaxEncoder
from jm_tpu.encoder.encoder import EncoderConfig as JaxConfig
from jm_tpu_torch.decoder.decoder import H264Decoder
from jm_tpu_torch.encoder.encoder import Encoder, EncoderConfig

from test_pipe_stream import make_frames
from torch_streams import fade

W, H, QP = 64, 48, 28
# case: (frames, encoder keywords)
CASES = {
    "b1_cavlc": (5, dict(num_b=1)),
    "b1_cabac": (5, dict(num_b=1, entropy="cabac")),
    "b2_cavlc": (7, dict(num_b=2)),
    "b2_cabac": (7, dict(num_b=2, entropy="cabac", cabac_adapt_init=True)),
    "pyramid": (9, dict(num_b=3, hierarchical=1)),
    "explicit_gop": (9, dict(num_b=3, explicit_gop="b2r0b0e1b1e1")),
    "qp_b": (5, dict(num_b=1, qp_b=34)),
    "rate_control": (7, dict(num_b=1, rc_enable=True, rc_bitrate=200000.0)),
    "open_gop_cra": (9, dict(num_b=1, intra_period=3, sei_recovery_point=True,
                             mmco_policy="cra")),
    "slices_bytes_cabac": (7, dict(num_b=3, hierarchical=1, slice_mode=2,
                                   slice_argument=50, entropy="cabac")),
    "slices_md_low": (7, dict(num_b=2, slice_mode=1, slice_argument=5,
                              device_rd=False)),
    "data_partition": (7, dict(num_b=2, data_partition=1)),
    "long_term_mmco": (11, dict(num_b=3, hierarchical=1, long_term_period=2,
                                intra_period=2, poc_mem_mgmt=1,
                                ref_reorder=1, mmco_policy="cra")),
    "refresh_no_filter": (5, dict(num_b=1, intra_mb_refresh=2,
                                  deblock=False, entropy="cabac")),
    # weighted bi-prediction, on a fade
    "wp_explicit": (5, dict(num_b=1, weighted_bipred=1)),
    "wp_explicit_p_cabac": (5, dict(num_b=1, weighted_bipred=1,
                                    weighted_pred=1, entropy="cabac",
                                    cabac_adapt_init=True)),
    "wp_implicit_pyramid": (9, dict(num_b=3, hierarchical=1,
                                    weighted_bipred=2)),
    "wp_implicit_gop_p": (9, dict(num_b=3, explicit_gop="b2r0b0e1b1e1",
                                  weighted_bipred=2, weighted_pred=1)),
    "wp_lms_slices": (7, dict(num_b=2, weighted_bipred=1, wp_method=1,
                              slice_mode=2, slice_argument=60)),
    "wp_data_partition": (7, dict(num_b=2, weighted_bipred=1,
                                  weighted_pred=1, data_partition=1)),
    "wp_implicit_long_term": (11, dict(num_b=3, hierarchical=1,
                                       long_term_period=2, intra_period=2,
                                       poc_mem_mgmt=1, ref_reorder=1,
                                       weighted_bipred=2,
                                       weighted_pred=1)),
}


def _encode(enc, frames):
    return [enc.encode_frame(*f) for f in frames] + [enc.flush()]


@pytest.fixture(scope="module")
def runs():
    """Per case, computed once: (jm_tpu payloads, jm_tpu results, port
    payloads, port results)."""
    cache = {}

    def get(case):
        if case not in cache:
            n, kw = CASES[case]
            frames = make_frames(W, H, n, seed=n)
            if case.startswith("wp_"):
                frames = fade(frames)
            # jm_tpu's device path defaults to md_low, the port's to RD
            jkw = {"device_rd": True, **kw}
            jenc = JaxEncoder(JaxConfig(width=W, height=H, qp=QP,
                                        pipeline="device", **jkw))
            want = _encode(jenc, frames)
            enc = Encoder(EncoderConfig(width=W, height=H, qp=QP, **kw),
                          device="cpu")
            cache[case] = (want, jenc.results, _encode(enc, frames),
                           enc.results)
        return cache[case]

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield get
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", list(CASES))
def test_b_stream_bytes_match_jm(case, runs):
    want, jres, got, res = runs(case)
    assert [len(p) for p in got] == [len(p) for p in want]
    assert got == want
    assert [r["type"] for r in res] == [r["type"] for r in jres]
    assert "B" in [r["type"] for r in res]


@pytest.mark.parametrize("case", list(CASES))
def test_b_stream_recon_matches_jm(case, runs):
    _want, jres, _got, res = runs(case)
    assert len(res) == len(jres)
    for a, b in zip(res, jres):
        assert (a["disp"], a["type"], a["qp"]) == (b["disp"], b["type"],
                                                   b["qp"])
        for plane in "YUV":
            assert np.array_equal(getattr(a["frame"], plane),
                                  getattr(b["frame"], plane)), \
                f"picture {a['disp']} ({a['type']}) plane {plane}"


@pytest.mark.parametrize("case", list(CASES))
def test_b_stream_decodes_to_the_recon(case, runs):
    _want, _jres, got, res = runs(case)
    out = H264Decoder(device="cpu").decode_annexb(b"".join(got))
    # decode order is the coding order of results; the frames carry POC
    assert len(out) == len(res)
    for f, r in zip(out, res):
        assert f.poc == r["frame"].poc
        for plane in "YUV":
            assert np.array_equal(getattr(f, plane),
                                  getattr(r["frame"], plane))


@pytest.mark.parametrize("kw,exc,field", [
    (dict(poc_type=1), ValueError, "poc_type"),
    (dict(poc_type=2), ValueError, "poc_type"),
    (dict(num_slice_groups=2), ValueError, "num_slice_groups"),
    (dict(redundant_period=2), NotImplementedError, "redundant"),
    (dict(num_b=2, explicit_gop="b0r0"), ValueError, "explicit_gop"),
])
def test_jm_refusals_with_b_raise(kw, exc, field):
    """What jm_tpu refuses with B pictures, the port refuses too."""
    kw = {"num_b": 1, **kw}
    with pytest.raises(exc):
        JaxEncoder(JaxConfig(width=W, height=H, pipeline="device", **kw))
    with pytest.raises(exc, match=field):
        Encoder(EncoderConfig(width=W, height=H, **kw), device="cpu")


@pytest.mark.parametrize("kw", [dict(weighted_bipred=3),
                                dict(num_b=1, weighted_bipred=-1)])
def test_weighted_bipred_raises(kw):
    """weighted_bipred is 0, 1 (explicit) or 2 (implicit)."""
    with pytest.raises(ValueError, match="weighted_bipred"):
        Encoder(EncoderConfig(width=W, height=H, **kw), device="cpu")


def test_b_streams_leave_the_pipe():
    """encode_stream with B pictures takes encode_frame for every frame
    and leaves the last held-back frames to flush, as jm_tpu's."""
    frames = make_frames(W, H, 4, seed=1)
    enc = Encoder(EncoderConfig(width=W, height=H, qp=QP, num_b=2),
                  device="cpu")
    assert not enc._pipe_ok()
    payloads = enc.encode_stream(frames)
    assert [bool(p) for p in payloads] == [True, False, False, True]
    assert [r["type"] for r in enc.results] == ["I", "P", "B", "B"]
    assert enc.flush() == b""
