"""The port's encoder (jm_tpu_torch.encoder.Encoder, device="cpu") with
device_rd against jm_tpu's Encoder(pipeline="device") on the
tests/torch_streams.py clips (96x80, QP 30): the Annex-B payloads are
byte-identical and the deblocked reconstructions equal, also on the scene
cuts, whose frames 2 and 3 fall back to the per-frame path and whose next
frames are dispatched again; every stream decodes with jm_tpu's and the
port's H264Decoder to the port's reconstruction. The host-serializer path
(packer overflow) and intra_mb_refresh must give the same bytes."""

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
