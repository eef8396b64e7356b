"""The port's encoder with md_low (device_rd=False) against jm_tpu's
Encoder(pipeline="device") on the CPU, exactly (tests/torch_streams.py
clips, 96x80, QP 30): the IPPP, periodic-IDR and scene-cut streams are
byte-identical with equal deblocked recon, the scene cuts fall back to
the per-frame path (device encode reused, host intra re-encode, mixed
deblock) and dispatch the next frame again, and every stream decodes
with both decoders to the port's recon; encode_frame frame by frame,
intra_mb_refresh=6, and a scene cut with a packer word budget too small
(fallback and the overflow host serializer in one stream)."""

import pytest

import torch_resilience as R
import torch_streams as S

RD = False


@pytest.fixture(scope="module")
def runs():
    return S.runs(RD)


@pytest.mark.parametrize("clip", list(S.CLIPS))
def test_md_low_stream_byte_identical(runs, clip):
    S.check_byte_identical(runs[clip])


@pytest.mark.parametrize("clip", list(S.CLIPS))
def test_md_low_fallbacks(runs, clip):
    S.check_fallbacks(runs[clip], clip)


@pytest.mark.parametrize("clip", list(S.CLIPS))
def test_md_low_stream_decodes_to_port_recon(runs, clip):
    S.check_decodes(runs[clip])


def test_encode_frame_per_frame_matches():
    """encode_frame on the 5-frame scene cut: every P frame takes the
    per-frame path, with intra MBs (frames 2, 3) and without."""
    frames = S.clip_frames("cut5")
    jenc = S.jax_encoder(RD)
    enc = S.port_encoder(RD)
    for i, f in enumerate(frames):
        assert enc.encode_frame(*f) == jenc.encode_frame(*f), f"frame {i}"
    assert enc.flush() == jenc.flush() == b""
    S.same_recon(enc.results, jenc.results)
    intra = [r.get("intra_mbs") for r in enc.results]
    assert intra[0] is None and intra[1] == 0 and intra[2] > 0


def test_intra_mb_refresh_matches():
    S.check_intra_refresh(RD)


def test_scene_cut_with_overflowing_packer(runs):
    """A word budget too small for any P slice: frames 1 and 4 go to the
    host serializer, frames 2 and 3 fall back; the bytes do not change."""
    frames, want, _, _, _ = runs["cut5"]
    enc = S.port_encoder(RD)
    enc.max_words = 4
    assert enc.encode_stream(frames) == want
    assert enc.fallbacks == S.CUT_FALLBACKS and enc.ovf == [1, 4]


@pytest.mark.parametrize("case", R.pipe_cases(False))
def test_resilience_case_on_the_pipe(case):
    """The md_low cases of tests/torch_resilience.py whose encode_stream
    stays on the pipe (redundant pictures, POC-based MMCO, SEI and VUI
    leave it in neither package): byte-identical payloads, equal recon,
    both decodes equal to the recon, no redundant coding written, as
    jm_tpu's pipe writes none. Their encode_frame route is in
    tests/test_torch_resilience.py."""
    R.check_all(R.CASES[case], "stream")


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
