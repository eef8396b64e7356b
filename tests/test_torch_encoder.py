"""The port's encoder (jm_tpu_torch.encoder.Encoder, device="cpu")
against jm_tpu's pipelined encoder on the tests/test_pipe_stream.py
clips (96x80, QP 30, device_rd): the Annex-B payloads are byte-identical,
the deblocked reconstructions equal, and the port's stream decodes with
jm_tpu's H264Decoder to the port's reconstruction. The host-serializer
path (packer overflow) must give the same bytes."""

import numpy as np
import pytest

from jm_tpu.decoder.decoder import H264Decoder
from jm_tpu.encoder.encoder import Encoder as JaxEncoder
from jm_tpu.encoder.encoder import EncoderConfig as JaxConfig
from jm_tpu_torch.encoder.encoder import Encoder, EncoderConfig

from test_pipe_stream import make_frames

W, H, QP = 96, 80, 30
CLIPS = {"ippp": (5, 0), "idr_every_3": (6, 3)}   # (frames, intra_period)


@pytest.fixture(scope="module")
def jax_runs():
    """jm_tpu's payloads and results per clip (computed once)."""
    runs = {}
    for name, (nframes, ip) in CLIPS.items():
        frames = make_frames(W, H, nframes)
        enc = JaxEncoder(JaxConfig(width=W, height=H, qp=QP,
                                   pipeline="device", intra_period=ip,
                                   device_rd=True))
        runs[name] = (frames, enc.encode_stream(frames), enc.results)
    return runs


def _port(ip, frames, max_words=None):
    enc = Encoder(EncoderConfig(width=W, height=H, qp=QP, intra_period=ip),
                  device="cpu")
    if max_words is not None:
        enc.max_words = max_words
    return enc, enc.encode_stream(frames)


@pytest.mark.parametrize("clip", list(CLIPS))
def test_payloads_byte_identical(jax_runs, clip):
    frames, want, want_res = jax_runs[clip]
    enc, got = _port(CLIPS[clip][1], frames)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"frame {i} payload differs"
    assert [r["type"] for r in enc.results] == \
        [r["type"] for r in want_res]
    for a, b in zip(enc.results, want_res):
        for plane in "YUV":
            assert np.array_equal(getattr(a["frame"], plane),
                                  getattr(b["frame"], plane))


@pytest.mark.parametrize("clip", list(CLIPS))
def test_stream_decodes_to_port_recon(jax_runs, clip):
    frames = jax_runs[clip][0]
    enc, payloads = _port(CLIPS[clip][1], frames)
    dec = H264Decoder().decode_annexb(b"".join(payloads))
    assert len(dec) == len(frames)
    for got, res in zip(dec, sorted(enc.results, key=lambda r: r["disp"])):
        for plane in "YUV":
            assert np.array_equal(getattr(got, plane),
                                  getattr(res["frame"], plane))


def test_host_serializer_path_on_overflow(jax_runs):
    """A word budget too small for any P slice sends every P frame
    through the host serializer; the bytes must not change."""
    frames, want, _ = jax_runs["ippp"]
    _enc, got = _port(0, frames, max_words=4)
    assert got == want
