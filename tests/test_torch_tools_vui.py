"""The port's VUI / HRD parse (decoder/parset.py _parse_vui /
_parse_hrd, into SPS.vui) against jm_tpu's on the CPU, exactly:
- an SPS written by jm_tpu's writer with every part of the VUI that
  changes the parse (Extended_SAR, the video signal type, timing, a NAL
  HRD of two CPB specifications, pic_struct_present_flag), in a stream
  with buffering period and pic_timing SEI: both packages' parse_sps
  give equal vui dicts, and both decoders the same sei_messages and
  frames;
- the enable_vui SPS of each package's Encoder."""

import numpy as np
import pytest

from jm_tpu.bitstream.nal import split_annexb as jm_split
from jm_tpu.decoder.decoder import H264Decoder as JDecoder
from jm_tpu.decoder.parset import parse_sps as jm_parse_sps
from jm_tpu_torch.bitstream.nal import split_annexb
from jm_tpu_torch.decoder.decoder import H264Decoder
from jm_tpu_torch.decoder.parset import parse_sps
from jm_tpu_torch.encoder.encoder import Encoder, EncoderConfig

from test_pipe_stream import make_frames
from torch_tools_streams import FULL_VUI, W, H, hrd_stream, jm_stream


def _sps_rbsps(data):
    return [u.rbsp for u in split_annexb(data) if u.nal_unit_type == 7]


def _port_vui_stream():
    enc = Encoder(EncoderConfig(width=W, height=H, qp=30, enable_vui=True),
                  device="cpu")
    return b"".join(enc.encode_stream(make_frames(W, H, 1)))


@pytest.fixture(scope="module")
def hrd():
    return hrd_stream()


def test_full_vui_parse_matches_jm(hrd):
    (rbsp,) = _sps_rbsps(hrd)
    (jrbsp,) = [u.rbsp for u in jm_split(hrd) if u.nal_unit_type == 7]
    assert rbsp == jrbsp
    vui = parse_sps(rbsp).vui
    assert vui == jm_parse_sps(rbsp).vui == FULL_VUI
    assert vui["nal_hrd"]["cpb"] == [(1999, 3999, 0), (2999, 5999, 1)]


def test_hrd_sei_messages_match_jm(hrd):
    dec, jdec = H264Decoder(device="cpu"), JDecoder()
    frames, jframes = dec.decode_annexb(hrd), jdec.decode_annexb(hrd)
    assert len(frames) == len(jframes) == 2
    for a, b in zip(frames, jframes):
        for p in "YUV":
            assert np.array_equal(getattr(a, p), getattr(b, p))
    got = [(m.payload_type, m.payload, m.fields) for m in dec.sei_messages]
    want = [(m.payload_type, m.payload, m.fields)
            for m in jdec.sei_messages]
    assert got == want
    # the pic_timing fields the HRD and pic_struct_present_flag bring
    timing = [f for t, _, f in got if t == 1]
    assert timing == [
        {"cpb_removal_delay": 0, "dpb_output_delay": 3, "pic_struct": 0,
         "timestamps": []},
        {"cpb_removal_delay": 2, "dpb_output_delay": 4, "pic_struct": 0,
         "timestamps": []}]
    (bp,) = [f for t, _, f in got if t == 0]
    assert bp["nal"] == [(90000, 1200), (90000, 1200)]


@pytest.mark.parametrize("package", ["port", "jm_tpu"])
def test_enable_vui_sps_matches_jm(package):
    data = (_port_vui_stream() if package == "port"
            else jm_stream(1, enable_vui=True))
    (rbsp,) = _sps_rbsps(data)
    vui = parse_sps(rbsp).vui
    assert vui is not None and "num_units_in_tick" in vui
    assert vui == jm_parse_sps(rbsp).vui
