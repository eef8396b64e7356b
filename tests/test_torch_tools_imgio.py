"""The port's image I/O (jm_tpu_torch/tools/imgio.py) against jm_tpu's on
the CPU: every function on seeded inputs gives jm_tpu's arrays, a TIFF
round trip (RGB and gray) in tmp_path, files written by one package read
by the other, and the case of tests/test_imgio.py::
test_tiff_sequence_encode through the port's Encoder (host pipeline,
jm_tpu's default) and H264Decoder on the CPU: the bytes are jm_tpu's."""

import numpy as np
import pytest

from jm_tpu.decoder.decoder import H264Decoder as JDecoder
from jm_tpu.encoder.encoder import Encoder as JEncoder
from jm_tpu.encoder.encoder import EncoderConfig as JEncoderConfig
from jm_tpu.tools import imgio as jio
from jm_tpu_torch.decoder.decoder import H264Decoder
from jm_tpu_torch.encoder.encoder import Encoder, EncoderConfig
from jm_tpu_torch.tools import imgio


def _same(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("shape", [(48, 64, 3), (32, 40)],
                         ids=["rgb", "gray"])
def test_tiff_round_trip_and_cross_read(tmp_path, shape):
    img = np.random.default_rng(0).integers(0, 256, shape, np.uint8)
    ours, theirs = tmp_path / "a.tif", tmp_path / "b.tif"
    imgio.write_tiff(str(ours), img)
    jio.write_tiff(str(theirs), img)
    assert ours.read_bytes() == theirs.read_bytes()
    _same(imgio.read_tiff(str(ours)), img)
    _same(imgio.read_tiff(str(theirs)), jio.read_tiff(str(ours)))


def test_colour_conversions_match_jm():
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, (64, 48, 3), np.uint8)
    yuv = imgio.rgb_to_yuv420(rgb)
    _same(yuv, jio.rgb_to_yuv420(rgb))
    _same(imgio.yuv420_to_rgb(*yuv), jio.yuv420_to_rgb(*yuv))


@pytest.mark.parametrize("out", [(128, 96), (32, 24), (48, 64)])
def test_resize_matches_jm(out):
    rng = np.random.default_rng(2)
    Y = rng.integers(0, 256, (48, 64), np.uint8)
    U, V = Y[::2, ::2].copy(), Y[1::2, ::2].copy()
    _same(imgio.resize_plane(Y, *out), jio.resize_plane(Y, *out))
    _same(imgio.resize_yuv420(Y, U, V, *out),
          jio.resize_yuv420(Y, U, V, *out))


def _tiff_frames(d):
    for i in range(3):
        base = np.zeros((48, 64, 3), np.uint8)
        base[:, :, 0] = (np.mgrid[0:48, 0:64][1] * 3 + i * 10) % 256
        base[:, :, 1] = 128
        base[:, :, 2] = 64
        imgio.write_tiff(str(d / f"f{i:03d}.tif"), base)
    gray = np.random.default_rng(3).integers(0, 256, (48, 64), np.uint8)
    imgio.write_tiff(str(d / "g000.tif"), gray)


def test_tiff_sequence_encode(tmp_path):
    """TIFF sequence -> the port's encoder and decoder, as jm_tpu's."""
    _tiff_frames(tmp_path)
    frames = imgio.read_tiff_sequence(str(tmp_path / "f%03d.tif"), 3)
    _same(tuple(frames), tuple(jio.read_tiff_sequence(
        str(tmp_path / "f%03d.tif"), 3)))
    _same(tuple(imgio.read_tiff_sequence(str(tmp_path / "g%03d.tif"), 1)),
          tuple(jio.read_tiff_sequence(str(tmp_path / "g%03d.tif"), 1)))
    enc = Encoder(EncoderConfig(width=64, height=48, qp=30,
                                pipeline="host"), device="cpu")
    jenc = JEncoder(JEncoderConfig(width=64, height=48, qp=30))
    out = b"".join(enc.encode_frame(Y, U, V) for Y, U, V in frames)
    jout = b"".join(jenc.encode_frame(Y, U, V) for Y, U, V in frames)
    assert out == jout
    dec = H264Decoder(device="cpu").decode_annexb(out)
    jdec = JDecoder().decode_annexb(jout)
    assert len(dec) == len(jdec) == 3
    for a, b in zip(dec, jdec):
        for p in "YUV":
            assert np.array_equal(getattr(a, p), getattr(b, p))
