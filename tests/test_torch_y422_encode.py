"""The port's 4:2:2 encode (EncoderConfig(chroma_format=2), High 4:2:2)
against jm_tpu's on the CPU, exactly (the codec is integer-exact: the
tolerance is zero): on the clip and the cases of tests/test_y422_encode.py
(intra only, IPP, CABAC, CABAC with a B picture, rdo 1, slices of MBs),
with the 8x8 transform and scaling matrices, and with explicit weighted
P (two references) and implicit weighted B, at 64x48 for 3 frames,
the port's encode_stream (with flush) on pipeline="host" and "device"
(every 4:2:2 picture is host-coded on both, as in jm_tpu) against jm_tpu's
encode_stream: the payload bytes, the deblocked recon of every picture,
and the port's CPU decode of the stream against that recon. Also: the
native CAVLC serializer at crows 4 against the Python MBWriter on every
slice of a 4:2:2 stream (with slices and a noisy clip, so that chroma AC
and Intra4x4 are coded); the I_PCM pair that jm_tpu writes and no
decoder of either package reads (ROADMAP Queue 3); the refusals of the
configuration."""

import copy

import numpy as np
import pytest

from jm_tpu.encoder.encoder import Encoder as JEncoder
from jm_tpu.encoder.encoder import EncoderConfig as JEncoderConfig
from jm_tpu_torch import native as N
from jm_tpu_torch.decoder.decoder import H264Decoder
from jm_tpu_torch.encoder import encoder as port_encoder
from jm_tpu_torch.encoder.encoder import Encoder, EncoderConfig
from jm_tpu_torch.encoder.syntax import serialize_slice

from test_y422_encode import _seq422
from torch_streams import one_torch_thread  # noqa: F401

W, H, N_FRAMES = 64, 48, 3

CASES = {
    "intra": dict(intra_period=1),
    "ipp": dict(),
    "cabac": dict(entropy="cabac"),
    "cabac_b": dict(entropy="cabac", num_b=1),
    "rdo1": dict(rdo=1),
    "slices": dict(slice_mode=1, slice_argument=5),
    "t8_sm": dict(transform8x8=True, scaling_matrix=3),
    "cabac_b_t8_sm": dict(entropy="cabac", num_b=1, transform8x8=True,
                          scaling_matrix=1, qp=24),
    # weighted prediction: the decoder's weighted 4:2:2 device stages
    "wp_p": dict(weighted_pred=1, num_ref=2),
    "wp_b": dict(entropy="cabac", num_b=1, weighted_bipred=2),
}


def _frames():
    return _seq422(N_FRAMES, W, H)


def _stream(enc, frames):
    out = b"".join(enc.encode_stream(frames))
    return out + enc.flush()


def _recon(enc):
    return [tuple(np.asarray(getattr(r["frame"], p)) for p in "YUV")
            for r in sorted(enc.results, key=lambda r: r["disp"])]


@pytest.mark.parametrize("case", sorted(CASES))
def test_y422_stream_matches_jm(case):
    kw = dict(CASES[case])
    qp = kw.pop("qp", 29)
    frames = _frames()
    jm = JEncoder(JEncoderConfig(width=W, height=H, qp=qp, chroma_format=2,
                                 **kw))
    want = _stream(jm, frames)
    assert jm.sps.profile_idc == 122
    want_rec = _recon(jm)
    for pipeline in ("host", "device"):
        enc = Encoder(EncoderConfig(width=W, height=H, qp=qp,
                                    chroma_format=2, pipeline=pipeline,
                                    **kw), device="cpu")
        got = _stream(enc, frames)
        assert enc.sps.profile_idc == 122
        assert got == want, pipeline
        rec = _recon(enc)
        assert len(rec) == len(want_rec) == N_FRAMES
        for i, (a, b) in enumerate(zip(rec, want_rec)):
            for p, x, y in zip("YUV", a, b):
                assert np.array_equal(x, y), f"{pipeline} frame {i} {p}"
    # the two routes wrote the same bytes: one decode of them
    dec = sorted(H264Decoder(device="cpu").decode_annexb(got),
                 key=lambda f: f.poc)
    assert len(dec) == N_FRAMES and dec[0].U.shape == (H, W // 2)
    for i, (f, r) in enumerate(zip(dec, rec)):
        for p, y in zip("YUV", r):
            assert np.array_equal(getattr(f, p), y), f"decode {i} {p}"


def test_native_serializer_at_422(monkeypatch):
    """Every CAVLC I / P slice of a 4:2:2 stream goes through the native
    serializer (native.routes), whose bytes equal the Python MBWriter's
    on the same PictureData."""
    rng = np.random.default_rng(5)
    frames = [tuple(np.clip(p.astype(int) + rng.integers(-24, 25, p.shape),
                            0, 255).astype(np.uint8) for p in f)
              for f in _frames()]
    calls = []

    def spy(pic, sps, pps, **kw):
        calls.append((copy.deepcopy(pic), sps, pps, kw))
        return serialize_slice(pic, sps, pps, **kw)

    monkeypatch.setattr(port_encoder, "serialize_slice", spy)
    enc = Encoder(EncoderConfig(width=W, height=H, qp=22, chroma_format=2,
                                slice_mode=1, slice_argument=6),
                  device="cpu")
    N.reset_routes()
    _stream(enc, frames)
    assert N.routes["serialize"] == {"native": len(calls), "python": 0}
    assert len(calls) == 2 * N_FRAMES
    ac = 0
    for pic, sps, pps, kw in calls:
        assert pic.n_crows == 4
        ac += int((pic.chroma_coef != 0).sum())
        assert serialize_slice(pic, sps, pps, **kw) == \
            serialize_slice(pic, sps, pps, **kw, native=False)
    assert ac > 0


def test_ipcm_pair_is_copied():
    """enable_ipcm 2 at 4:2:2: the port writes jm_tpu's I_PCM bytes and
    recon (18555 bytes for the clip at 64x48), and the port's decoder
    raises on them as jm_tpu's does (ROADMAP Queue 3: a reference fault
    copied, not repaired)."""
    frames = _frames()
    kw = dict(width=W, height=H, qp=29, chroma_format=2, enable_ipcm=2)
    jm = JEncoder(JEncoderConfig(**kw))
    want = b"".join(jm.encode_frame(*f) for f in frames)
    enc = Encoder(EncoderConfig(**kw), device="cpu")
    got = b"".join(enc.encode_frame(*f) for f in frames)
    assert got == want and len(got) == 18555
    for a, b in zip(_recon(enc), _recon(jm)):
        for x, y in zip(a, b):
            assert np.array_equal(x, y)
    assert enc.results[0]["mb_classes"]["ipcm"] == 12
    with pytest.raises(NotImplementedError, match="I_PCM"):
        H264Decoder(device="cpu").decode_annexb(got)


@pytest.mark.parametrize("kw,exc,match", [
    (dict(chroma_format=0), ValueError, "chroma_format"),
    (dict(chroma_format=3), ValueError, "chroma_format"),
    (dict(chroma_format=True), ValueError, "chroma_format"),
    (dict(chroma_format=2, num_slice_groups=2), ValueError, "profile 122"),
    (dict(chroma_format=2, pic_interlace=1), NotImplementedError,
     "pic_interlace"),
])
def test_refusals(kw, exc, match):
    """What jm_tpu refuses at 4:2:2 the port refuses when it is built:
    chroma formats other than 1 and 2, FMO in profile 122, and field
    coding (NotImplementedError, as jm_tpu's field coder raises)."""
    with pytest.raises(exc, match=match):
        Encoder(EncoderConfig(width=W, height=H, **kw), device="cpu")


def test_frame_planes_are_checked():
    enc = Encoder(EncoderConfig(width=W, height=H, chroma_format=2),
                  device="cpu")
    Y, U, V = _frames()[0]
    with pytest.raises(ValueError, match="4:2:2"):
        enc.encode_stream([(Y, U[::2], V[::2])])
