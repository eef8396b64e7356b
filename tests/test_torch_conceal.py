"""Error concealment in the port's decoder (H264Decoder(conceal_mode=1 /
2)) against jm_tpu's H264Decoder(conceal_mode=...) on the CPU, exactly:
the cases of tests/test_conceal.py and test_conceal_mb.py on streams of
the port's encoder (a panning texture, QP 26), NAL units dropped or cut
with the port's own splitter. Each lossy stream decodes, in both modes,
to jm_tpu's frames (POC, Y, U, V; the tolerance is zero) with jm_tpu's
concealed_count:
- a P picture lost (a frame_num gap): the frame copy (mode 1) or the
  motion copy (mode 2) of the closest reference, and the P pictures
  after it predicted from the concealed frame;
- a gap of one picture in eight, at the POC interpolated between its
  neighbours;
- a picture's only slice cut mid-payload: dropped, the whole frame
  concealed;
- a slice of a P picture (inter concealment by side match), of the IDR
  (spatial concealment) and of a later picture dropped from a stream of
  three slices per picture, and a slice whose payload is replaced mid-MB
  (the corrupt slice's MBs concealed, the later pictures decoded on);
and without concealment a gap is not noticed (a frame short, as in
jm_tpu) while a dropped slice raises ValueError."""

import numpy as np
import pytest

from jm_tpu.decoder.decoder import H264Decoder as JaxDecoder
from jm_tpu_torch.bitstream.nal import annexb_bytes, split_annexb
from jm_tpu_torch.decoder.decoder import H264Decoder
from jm_tpu_torch.encoder.encoder import Encoder, EncoderConfig

from torch_streams import one_torch_thread  # noqa: F401


def _moving(n, w, h):
    """Smooth content panning by (3, 2) pixels a frame (tests/
    test_conceal.py _moving_sequence)."""
    yy, xx = np.mgrid[0:h + 32, 0:w + 32]
    base = (128 + 60 * np.sin(xx / 7.0) * np.cos(yy / 9.0)
            + 30 * np.sin((xx + yy) / 13.0)).astype(np.uint8)
    return [(base[i * 2:i * 2 + h, i * 3:i * 3 + w].copy(),
             np.full((h // 2, w // 2), 100 + i, np.uint8),
             np.full((h // 2, w // 2), 140 - i, np.uint8))
            for i in range(n)]


def _encode(n, w=64, h=48, **kw):
    enc = Encoder(EncoderConfig(width=w, height=h, qp=26, pipeline="host",
                                **kw), device="cpu")
    return list(split_annexb(b"".join(enc.encode_frame(*f)
                                      for f in _moving(n, w, h))))


def _join(units):
    return b"".join(annexb_bytes(u.nal_ref_idc, u.nal_unit_type, u.rbsp)
                    for u in units)


def _vcl(units):
    return [i for i, u in enumerate(units) if u.nal_unit_type in (1, 5)]


def _streams():
    """name -> the lossy Annex-B bytes."""
    out = {}
    one = _encode(6)                 # SPS, PPS, IDR, P1..P5
    out["lost_p"] = _join(one[:4] + one[5:])
    eight = _encode(8)
    out["gap_poc"] = _join(eight[:5] + eight[6:])
    out["cut_slice"] = _join(one[:4]) + _join(one[4:5])[:16] + \
        _join(one[5:])
    multi = _encode(5, 96, 80, slice_mode=1, slice_argument=10)
    vcl = _vcl(multi)                # three slices per picture
    for name, k in (("lost_p_slice", 4), ("lost_idr_slice", 1),
                    ("lost_last_slice", 14)):
        out[name] = _join([u for i, u in enumerate(multi) if i != vcl[k]])
    raw = _join(multi[vcl[7]:vcl[7] + 1])
    out["corrupt_slice"] = _join(multi[:vcl[7]]) + \
        raw[:len(raw) // 2] + bytes([255] * 8) + _join(multi[vcl[7] + 1:])
    return out


STREAMS = ["lost_p", "gap_poc", "cut_slice", "lost_p_slice",
           "lost_idr_slice", "lost_last_slice", "corrupt_slice"]


@pytest.fixture(scope="module")
def streams():
    return _streams()


@pytest.mark.parametrize("mode", [1, 2])
@pytest.mark.parametrize("name", STREAMS)
def test_concealment_matches_jm(name, mode, streams, one_torch_thread):
    data = streams[name]
    dec = H264Decoder(device="cpu", conceal_mode=mode)
    out = dec.decode_annexb(data)
    jdec = JaxDecoder(conceal_mode=mode)
    want = jdec.decode_annexb(data)
    assert [f.poc for f in out] == [f.poc for f in want]
    for i, (a, b) in enumerate(zip(out, want)):
        for p in "YUV":
            assert np.array_equal(getattr(a, p), getattr(b, p)), (i, p)
    assert dec.concealed_count == jdec.concealed_count > 0
    if name == "gap_poc":
        assert sorted(f.poc for f in out) == list(range(0, 16, 2))
    if name in ("lost_p", "gap_poc", "cut_slice"):
        assert dec.concealed_count == 1       # one whole frame
    else:
        assert dec.concealed_count >= 10      # a slice's MBs


def test_strict_mode(streams):
    """conceal_mode 0: a frame_num gap goes unnoticed (a frame short, as
    in jm_tpu), a dropped slice raises ValueError."""
    out = H264Decoder(device="cpu").decode_annexb(streams["lost_p"])
    assert len(out) == len(JaxDecoder().decode_annexb(streams["lost_p"])) \
        == 5
    with pytest.raises(ValueError, match="slice data missing"):
        H264Decoder(device="cpu").decode_annexb(streams["lost_p_slice"])
    with pytest.raises(ValueError):
        H264Decoder(conceal_mode=3)
