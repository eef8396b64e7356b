"""The port's encoder (jm_tpu_torch.encoder.Encoder, device="cpu") with
device_rd against jm_tpu's Encoder(pipeline="device") on the
tests/torch_streams.py clips (96x80, QP 30): the Annex-B payloads are
byte-identical and the deblocked reconstructions equal, also on the scene
cuts, whose frames 2 and 3 fall back to the per-frame path and whose next
frames are dispatched again; every stream decodes with jm_tpu's and the
port's H264Decoder to the port's reconstruction. The host-serializer path
(packer overflow) and intra_mb_refresh must give the same bytes, and so
must rdoq and rd_picture_decision on the device route."""

import pytest

import torch_resilience as R
import torch_streams as S

RD = True


@pytest.fixture(scope="module")
def jax_runs():
    """Both encoders' streams per clip (jm_tpu's compiled once)."""
    return S.runs(RD)


@pytest.mark.parametrize("clip", list(S.CLIPS))
def test_payloads_byte_identical(jax_runs, clip):
    S.check_byte_identical(jax_runs[clip])


@pytest.mark.parametrize("clip", list(S.CLIPS))
def test_fallbacks(jax_runs, clip):
    S.check_fallbacks(jax_runs[clip], clip)


@pytest.mark.parametrize("clip", list(S.CLIPS))
def test_stream_decodes_to_port_recon(jax_runs, clip):
    S.check_decodes(jax_runs[clip])


def test_host_serializer_path_on_overflow(jax_runs):
    """A word budget too small for any P slice sends every P frame
    through the host serializer; the bytes must not change."""
    frames, want, _, _, _ = jax_runs["ippp"]
    enc = S.port_encoder(RD)
    enc.max_words = 4
    assert enc.encode_stream(frames) == want
    assert enc.ovf == [1, 2, 3, 4]


def test_intra_mb_refresh_matches():
    S.check_intra_refresh(RD)


@pytest.mark.parametrize("case", R.pipe_cases(True))
def test_resilience_case_on_the_pipe(case):
    """The device RD cases of tests/torch_resilience.py whose encode_stream
    stays on the pipe (redundant pictures, POC-based MMCO, SEI and VUI
    leave it in neither package): byte-identical payloads, equal recon,
    both decodes equal to the recon, no redundant coding written, as
    jm_tpu's pipe writes none. Their encode_frame route is in
    tests/test_torch_resilience.py."""
    R.check_all(R.CASES[case], "stream")


# the RD options on the device route (rdoq leaves the pipe but not the
# device route; rd_picture_decision codes each picture three times on
# it), after test_intra_mb_refresh_matches has compiled jm_tpu's
# per-frame device step in this process
_TRELLIS = dict(rdoq=1, rdoq_dc=1, rdoq_cr=1, rdoq_dc_cr=1)
RD_CASES = {"rdoq_refresh": dict(_TRELLIS, intra_mb_refresh=6),
            "rdpd_intra": dict(rd_picture_decision=True, intra_period=2,
                               rdoq=1)}
_RD_RUNS = {}


def _rd_run(case):
    if case not in _RD_RUNS:
        frames = S.make_frames(S.W, S.H, 3, seed=4)
        _RD_RUNS[case] = S.option_run(dict(RD_CASES[case], device_rd=RD),
                                      frames, pipeline="device",
                                      stream=True)
    return _RD_RUNS[case]


@pytest.mark.parametrize("case", list(RD_CASES))
def test_rd_options_on_the_device_route_match(case):
    S.check_byte_identical(_rd_run(case))


@pytest.mark.parametrize("case", list(RD_CASES))
def test_rd_options_on_the_device_route_decode(case):
    S.check_decodes(_rd_run(case))


@pytest.mark.parametrize("case", list(RD_CASES))
def test_rd_options_on_the_device_route_act(case):
    """Off the pipe, on the device route: with rdoq the trellis codes the
    forced intra MBs of the P pictures (their bytes change, the device I
    picture's do not); with rd_picture_decision each picture after the
    first records its three codings and ships the one of least J."""
    frames, _want, _res, enc, got = _rd_run(case)
    assert enc.fallbacks == []
    for r in enc.results:
        assert r["type"] == "I" or ("intra_mbs" in r and "mix" not in r)
    if case == "rdoq_refresh":
        plain = S.Encoder(S.EncoderConfig(
            width=S.W, height=S.H, qp=S.QP, device_rd=RD,
            intra_mb_refresh=6), device="cpu").encode_stream(frames)
        assert plain[0] == got[0] and plain[1:] != got[1:]
    else:
        for r in enc.results[1:]:
            trials = r["trials"]
            assert [t["qp"] for t in trials] == [S.QP, S.QP - 1, S.QP + 1]
            assert r["qp"] == min(trials, key=lambda t: t["j"])["qp"]


# SP pictures on the device route: the P pictures coded on the device,
# the SP picture by the host P coder, as in jm_tpu (after
# test_intra_mb_refresh_matches has compiled jm_tpu's device step here)
_SP_RUN = []


def _sp_run():
    if not _SP_RUN:
        _SP_RUN.append(S.option_run(
            dict(sp_periodicity=2, qp_sp=30, qp_sp2=32, device_rd=RD),
            S.make_frames(S.W, S.H, 3, seed=4), pipeline="device",
            stream=True))
    return _SP_RUN[0]


def test_sp_on_the_device_route_matches():
    S.check_byte_identical(_sp_run())
    assert [bool(r.get("sp")) for r in _sp_run()[3].results] == \
        [False, False, True]


def test_sp_on_the_device_route_decodes():
    S.check_decodes(_sp_run())
