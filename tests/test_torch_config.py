"""The port's JM config layer and its numpy host tools against jm_tpu's,
exactly, on the CPU:
- cfg texts (comments, quoted strings, '=' glued to names or values,
  aliases, unknown names, -p overrides) give the same tokens, the same
  EncoderParams / DecoderParams and the same errors (limits, unsupported
  JM features);
- ``to_encoder_config()`` gives the port's EncoderConfig equal to
  jm_tpu's field by field, pipeline "host" and device_rd False included
  (jm_tpu's config layer leaves both at jm_tpu's defaults, which are not
  the port's), for stereo (NumberOfViews 2), CABAC with B pictures, rate
  control, slice groups from a SliceGroupConfigFileName, scaling and
  offset matrices from their files, and SP / data partitioning;
- metrics.psnr / ssim / ms_ssim, tools/input.read_frames (planar 8- and
  16-bit, packed UYVY / YUY2 / YVYU, V210), the RTP dump container
  (bitstream/rtp.py: the dump of a stream, its packets, the Annex-B
  stream back, the lost-packet count of split_rtp) and the leaky-bucket
  parameters (encoder/leaky_bucket.py) give jm_tpu's values and bytes."""

import dataclasses
import struct

import numpy as np
import pytest

from jm_tpu import config as jconfig
from jm_tpu import metrics as jmetrics
from jm_tpu.bitstream import rtp as jrtp
from jm_tpu.encoder import leaky_bucket as jlb
from jm_tpu.tools import input as jinput
from jm_tpu_torch import config, metrics
from jm_tpu_torch.bitstream import rtp
from jm_tpu_torch.encoder import leaky_bucket as lb
from jm_tpu_torch.encoder.encoder import EncoderConfig
from jm_tpu_torch.tools import input as tinput

from test_pipe_stream import make_frames

TEXTS = {
    "basic": '''
# comment line
InputFile             = "foreman, with spaces.yuv"  # trailing
QPISlice=28
SearchRange =12
FramesToBeEncoded = 3
''',
    "stereo": '''
InputFile = "left.yuv"
SourceWidth = 352
SourceHeight = 288
NumberOfViews = 2
View1ConfigFile = "view1.cfg"
MVCInterViewReorder = 1
ProfileIDC = 128
QPISlice = 30
QPPSlice = 32
IntraPeriod = 4
''',
    "cabac_b": '''
SymbolMode = 1
ContextInitMethod = 1
NumberBFrames = 1
QPBSlice = 33
NumberReferenceFrames = 2
Transform8x8Mode = 1
DistortionMS_SSIM = 1
LoopFilterDisable = 0
UnknownName = 7
''',
    "rc": '''
RateControlEnable = 1
Bitrate = 60000
InitialQP = 30
BasicUnit = 4
RCMinQPPSlice = 10
FrameRate = 25.0
''',
    "sp_dp": '''
ProfileIDC = 88
SPPicturePeriodicity = 2
QPSPSlice = 30
QPSP2Slice = 32
PartitionMode = 1
NumberLeakyBuckets = 4
OutFileMode = 1
''',
}


def _vars(p):
    return dataclasses.asdict(p)


@pytest.mark.parametrize("name", TEXTS)
def test_cfg_text_parses_as_jm_tpus(name):
    text = TEXTS[name]
    assert config.tokenize_cfg(text) == jconfig.tokenize_cfg(text)
    kv = config.parse_cfg_text(text)
    assert kv == jconfig.parse_cfg_text(text)
    p, q = config.EncoderParams(), jconfig.EncoderParams()
    p.apply(kv)
    q.apply(kv)
    assert _vars(p) == _vars(q)
    p.validate()
    q.validate()


def test_load_params_precedence(tmp_path):
    a, b = tmp_path / "a.cfg", tmp_path / "b.cfg"
    a.write_text(TEXTS["stereo"])
    b.write_text("QPISlice = 26\nIntraPeriod = 2\n")
    args = (str(a), (str(b),), ("QPPSlice=35", 'OutputFile="x.264"'))
    assert _vars(config.load_params(config.EncoderParams, *args)) == \
        _vars(jconfig.load_params(jconfig.EncoderParams, *args))
    d = tmp_path / "d.cfg"
    d.write_text("InputFile = s.264\nOutputFile = o.yuv\nConcealMode = 2\n"
                 "Silent = 1\n")
    assert _vars(config.load_params(config.DecoderParams, str(d))) == \
        _vars(jconfig.load_params(jconfig.DecoderParams, str(d)))


@pytest.mark.parametrize("kv,exc", [
    ({"QPISlice": "60"}, ValueError),
    ({"SearchRange": "abc"}, ValueError),
    ({"UseHPFilter": "0", "FrameSkip": "2"}, "unsupported"),
    ({"ReferenceReorder": "2"}, NotImplementedError),
])
def test_errors_are_jm_tpus(kv, exc):
    for mod in (config, jconfig):
        p = mod.EncoderParams()
        want = mod.UnsupportedParamError if exc == "unsupported" else exc
        with pytest.raises(want):
            p.apply(kv)
            p.validate()


def _files(tmp_path):
    sg = tmp_path / "sg.cfg"
    sg.write_text("0\n1 # group of MB 1\n1\n0\n" * 3)
    qm = tmp_path / "q_matrix.cfg"
    qm.write_text("INTRA4X4_LUMA = " + ",".join(str(8 + i) for i in range(16))
                  + "\nINTER8X8_LUMA = " + " ".join(["20"] * 64) + "\n")
    qo = tmp_path / "q_offset.cfg"
    qo.write_text("INTER4X4_LUMA_INTERP = " + ",".join(["100"] * 16) + "\n")
    return {
        "fmo": f'''
SourceWidth = 64
SourceHeight = 48
num_slice_groups_minus1 = 1
slice_group_map_type = 6
SliceGroupConfigFileName = "{sg}"
''',
        "qmatrix": f'''
ProfileIDC = 100
Transform8x8Mode = 1
ScalingMatrixPresentFlag = 3
QmatrixFile = "{qm}"
ScalingListPresentFlag0 = 1
ScalingListPresentFlag7 = 2
OffsetMatrixPresentFlag = 1
QOffsetMatrixFile = "{qo}"
AdaptiveRounding = 1
AdaptRndPeriod = 8
''',
    }


@pytest.mark.parametrize("name", list(TEXTS) + ["fmo", "qmatrix"])
def test_to_encoder_config_is_jm_tpus(tmp_path, name):
    text = TEXTS.get(name) or _files(tmp_path)[name]
    kv = config.parse_cfg_text(text)
    p, q = config.EncoderParams(), jconfig.EncoderParams()
    p.apply(kv)
    q.apply(kv)
    got, want = p.to_encoder_config(), q.to_encoder_config()
    assert isinstance(got, EncoderConfig)
    assert got.pipeline == "host" and got.device_rd is False
    for f in EncoderConfig.__dataclass_fields__:
        a, b = getattr(got, f), getattr(want, f)
        if f == "offset_matrix" and a:
            assert all(np.array_equal(x, y) for x, y in zip(a, b))
        else:
            assert a == b, f
    if name == "stereo":
        assert got.num_views == 2


def test_metrics_are_jm_tpus():
    rng = np.random.default_rng(11)
    a = rng.integers(0, 256, (48, 64)).astype(np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-6, 7, a.shape), 0,
                255).astype(np.uint8)
    assert metrics.psnr(a, b) == jmetrics.psnr(a, b)
    assert metrics.psnr(a, a) == jmetrics.psnr(a, a)
    for ov in (8, 4):
        assert metrics.ssim(a, b, overlap=ov) == jmetrics.ssim(a, b,
                                                               overlap=ov)
    big = np.kron(a, np.ones((4, 4), np.uint8))
    bigb = np.kron(b, np.ones((4, 4), np.uint8))
    assert metrics.ms_ssim(big, bigb) == jmetrics.ms_ssim(big, bigb)


@pytest.mark.parametrize("fmt", ["planar420", "planar422", "planar16",
                                 "uyvy", "yuy2", "yvyu", "v210"])
def test_read_frames_is_jm_tpus(tmp_path, fmt):
    rng = np.random.default_rng(3)
    w, h, n = 48, 32, 2
    kw = {"planar420": dict(), "planar422": dict(chroma_format=2),
          "planar16": dict(bit_depth=10),
          "uyvy": dict(chroma_format=2, pixel_format=tinput.PF_UYVY),
          "yuy2": dict(chroma_format=2, pixel_format=tinput.PF_YUY2),
          "yvyu": dict(chroma_format=2, pixel_format=tinput.PF_YVYU),
          "v210": dict(chroma_format=2, pixel_format=tinput.PF_V210)}[fmt]
    path = tmp_path / "src.yuv"
    path.write_bytes(rng.integers(0, 256, 3 * w * h * n, np.uint8)
                     .tobytes())
    got = tinput.read_frames(str(path), w, h, n, start=0, **kw)
    want = jinput.read_frames(str(path), w, h, n, start=0, **kw)
    assert len(got) == len(want) > 0
    for f, g in zip(got, want):
        for x, y in zip(f, g):
            assert x.dtype == y.dtype and np.array_equal(x, y)


def _stream() -> bytes:
    from jm_tpu_torch.encoder.encoder import Encoder
    enc = Encoder(EncoderConfig(width=32, height=32, pipeline="host",
                                slice_mode=1, slice_argument=2),
                  device="cpu")
    return b"".join(enc.encode_frame(*f) for f in make_frames(32, 32, 3))


def test_rtp_is_jm_tpus():
    ann = _stream()
    dump = rtp.annexb_to_rtp(ann)
    assert dump == jrtp.annexb_to_rtp(ann)
    assert rtp.rtp_to_annexb(dump) == jrtp.rtp_to_annexb(dump)
    pkts = rtp.read_rtp_dump(dump)
    assert [dataclasses.astuple(p) for p in pkts] == \
        [dataclasses.astuple(p) for p in jrtp.read_rtp_dump(dump)]
    kept = bytearray()
    for i, p in enumerate(pkts):
        if i in (3, 5):
            continue
        pkt = rtp.compose_packet(p)
        kept += struct.pack("<Ii", len(pkt), p.timestamp) + pkt
    got = rtp.split_rtp(bytes(kept))
    want = jrtp.split_rtp(bytes(kept))
    assert [(u.nal_unit_type, u.rbsp, u.lost_before) for u in got] == \
        [(u.nal_unit_type, u.rbsp, u.lost_before) for u in want]
    assert sum(u.lost_before for u in got) == 2
    w = rtp.RtpDumpWriter()
    jw = jrtp.RtpDumpWriter()
    for k, wr in enumerate((w, jw)):
        for tr in (0, 1, 3, 2, 255, 0):
            wr.update_timestamp(tr)
            wr.write_nalu(3, 5, b"\x88\x00\x00\x01\x42", marker=1)
    assert w.getvalue() == jw.getvalue()


def test_leaky_bucket_is_jm_tpus(tmp_path):
    rng = np.random.default_rng(9)
    bits = [int(b) for b in rng.integers(2000, 40000, 17)]
    for kw in (dict(n_buckets=1), dict(n_buckets=8),
               dict(rates=[50000, 120000, 400000])):
        got = lb.calc_buffer(bits, 25.0, **kw)
        assert got == jlb.calc_buffer(bits, 25.0, **kw)
    a, b = tmp_path / "a.cfg", tmp_path / "b.cfg"
    lb.write_buffer(str(a), got)
    jlb.write_buffer(str(b), got)
    assert a.read_bytes() == b.read_bytes()
    assert lb.read_buffer(str(a)) == got
