"""The port's decoder (jm_tpu_torch/decoder) against jm_tpu's on the CPU,
byte for byte (the codec is integer-exact: the tolerance is zero):
- SPS, PPS and slice headers of the in-scope goldens, field by field
  (and of the weighted prediction goldens wp_p, wp_bi and wp_both, whose
  decode tests/test_torch_wp.py holds);
- the in-scope goldens (CAVLC, FMO slice groups of map types 1, 3, 5
  and 6, data partitioning (dp1; cif_dp with MMCO), cabac_pp: JM
  lencod's CABAC I/P/P with two references, and the B goldens: cavlc_b,
  main3, main9, main9t (temporal direct), poc1b (POC type 1), cif_main)
  against jm_tpu's H264Decoder(device_recon=True) and against JM
  ldecod's output (_rec.yuv, in POC order);
- jm_tpu encoder streams (IPPP, periodic IDR, a scene cut whose P
  pictures carry intra MBs, several slices and references with POC
  type 2, POC type 1 with intra refresh MBs, I_PCM), CAVLC and CABAC,
  against jm_tpu's decode and the encoder's reconstruction;
- the port's own encoder streams, CAVLC and CABAC;
- jm_tpu's parse through convert.picture_from_numpy and the port's
  reconstruction and deblock;
- out-of-scope streams raise NotImplementedError naming the construct, a
  picture with uncoded MBs ValueError (strict mode, as in jm_tpu), and a
  CUDA request without a card raises. The SP goldens are held in
  tests/test_torch_sp_decode.py."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from jm_tpu.bitstream.nal import split_annexb as jm_split
from jm_tpu.common.types import SliceHeader as JSliceHeader
from jm_tpu.decoder import decoder as jm_decoder
from jm_tpu.decoder.header import PocContext as JPocContext
from jm_tpu.decoder.header import parse_slice_header as jm_slice_header
from jm_tpu.decoder.parset import parse_pps as jm_pps
from jm_tpu.decoder.parset import parse_sps as jm_sps
from jm_tpu.encoder.encoder import Encoder as JEncoder
from jm_tpu.encoder.encoder import EncoderConfig as JEncoderConfig
from jm_tpu_torch.bitstream.nal import split_annexb
from jm_tpu_torch.common.types import SPS, SliceHeader, SliceType
from jm_tpu_torch.convert import picture_from_numpy
from jm_tpu_torch.decoder import decoder as port_decoder
from jm_tpu_torch.decoder.decoder import H264Decoder, decode_file
from jm_tpu_torch.decoder.header import PocContext, parse_slice_header
from jm_tpu_torch.decoder.parset import parse_pps, parse_sps
from jm_tpu_torch.encoder.encoder import Encoder, EncoderConfig

from test_pipe_stream import make_frames

GOLDEN = Path(__file__).parent / "golden"
B_GOLDENS = ["cavlc_b", "main3", "main9", "main9t", "poc1b", "cif_main"]
IN_SCOPE = ["i1", "ipp3", "qp20", "qp36", "cabac_pp", "sei", "fmo_t1",
            "fmo_t3", "fmo_t5d1", "fmo_t6", "cif_fmo", "dp1",
            "cif_dp"] + B_GOLDENS
# goldens without JM ldecod's output in the repository (sei.264, cif_fmo
# .264: FMO at CIF, cif_dp.264: data partitions and MMCO at CIF,
# cif_main.264: CABAC I/P/B at CIF), held against jm_tpu's decode only
NO_LDECOD_REC = {"sei", "cif_fmo", "cif_dp", "cif_main"}
WP_GOLDENS = ["wp_p", "wp_bi", "wp_both"]


def _fields(obj, names):
    out = {}
    for k in names:
        v = getattr(obj, k)
        if k.startswith("ref_pic_list_mod_l"):
            v = [(m.op, m.value) for m in v]
        elif k == "mmco_ops":
            v = [(m.op, m.value1, m.value2) for m in v]
        out[k] = int(v) if isinstance(v, bool) else v
    return out


@pytest.mark.parametrize("name", IN_SCOPE + WP_GOLDENS)
def test_headers_match_jm(name):
    data = (GOLDEN / f"{name}.264").read_bytes()
    units, jm_units = split_annexb(data), jm_split(data)
    assert [(u.nal_unit_type, u.nal_ref_idc, u.rbsp) for u in units] == \
        [(int(u.nal_unit_type), u.nal_ref_idc, u.rbsp) for u in jm_units]
    sps_f = [f.name for f in dataclasses.fields(SPS) if f.name != "vui"]
    hdr_f = [f.name for f in dataclasses.fields(SliceHeader)]
    assert set(hdr_f) <= {f.name for f in dataclasses.fields(JSliceHeader)}
    sm, pm, jsm, jpm = {}, {}, {}, {}
    n_slices = 0
    for u, ju in zip(units, jm_units):
        if u.nal_unit_type == 7:
            s, js = parse_sps(u.rbsp), jm_sps(ju.rbsp)
            assert _fields(s, sps_f) == _fields(js, sps_f)
            sm[s.seq_parameter_set_id] = s
            jsm[js.seq_parameter_set_id] = js
        elif u.nal_unit_type == 8:
            p, jp = parse_pps(u.rbsp, sm), jm_pps(ju.rbsp, jsm)
            assert dataclasses.asdict(p) == dataclasses.asdict(jp)
            pm[p.pic_parameter_set_id] = p
            jpm[jp.pic_parameter_set_id] = jp
        elif u.nal_unit_type in (1, 2, 5):
            (h, br), (jh, jbr) = parse_slice_header(u, sm, pm), \
                jm_slice_header(ju, jsm, jpm)
            assert _fields(h, hdr_f) == _fields(jh, hdr_f)
            assert br.pos == jbr.pos
            n_slices += 1
    assert n_slices >= 1


def _equal(frames_a, frames_b):
    assert len(frames_a) == len(frames_b)
    for i, (a, b) in enumerate(zip(frames_a, frames_b)):
        for p in "YUV":
            assert np.array_equal(getattr(a, p), getattr(b, p)), \
                f"frame {i} plane {p} differs"


def _equal_yuv(frames, path):
    rec = np.fromfile(path, np.uint8)
    cat = np.concatenate([np.concatenate([f.Y.ravel(), f.U.ravel(),
                                          f.V.ravel()]) for f in frames])
    assert cat.size == rec.size
    assert np.array_equal(cat, rec)


@pytest.fixture
def one_torch_thread():
    """The port's CPU decode runs many small tensor ops, which more
    threads only slow down (cif_fmo: 30 CIF pictures take several times
    as long with 8 threads as with 1)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", IN_SCOPE)
def test_golden_decodes_like_jm_and_ldecod(name, one_torch_thread):
    data = (GOLDEN / f"{name}.264").read_bytes()
    dec = H264Decoder(device="cpu")
    out = dec.decode_annexb(data)
    _equal(out, jm_decoder.H264Decoder(device_recon=True).decode_annexb(data))
    if name not in NO_LDECOD_REC:
        # ldecod writes in output order: the B streams' is the POC order
        _equal_yuv(sorted(out, key=lambda f: f.poc) if name in B_GOLDENS
                   else out, GOLDEN / f"{name}_rec.yuv")
    assert [p["path"] for p in dec.pictures][0] == "intra"
    assert {p["path"] for p in dec.pictures[1:]} <= {"inter", "mixed"}


def test_decode_file_on_cpu():
    out = decode_file(str(GOLDEN / "qp36.264"), device="cpu")
    _equal_yuv(out, GOLDEN / "qp36_rec.yuv")


# jm_tpu encoder streams at 96x80: (frames kwargs, encoder kwargs, a path
# the port's decode must take)
JM_STREAMS = {
    "ippp": ({"n": 5}, {}, "inter"),
    "periodic_idr": ({"n": 6}, {"intra_period": 3}, "inter"),
    "scene_cut": ({"n": 4, "noise_at": 2}, {}, "mixed"),
    "slices_refs_poc2": ({"n": 5, "seed": 3},
                         {"slice_mode": 1, "slice_argument": 7, "num_ref": 3,
                          "poc_type": 2, "sub8x8": True}, "inter"),
    "poc1_intra_refresh": ({"n": 4, "seed": 4},
                           {"poc_type": 1, "intra_mb_refresh": 3,
                            "num_ref": 2}, "mixed"),
    "ipcm": ({"n": 3, "seed": 5}, {"enable_ipcm": 2}, "intra"),
}


def _check_jm_stream(name, entropy):
    fkw, ekw, path = JM_STREAMS[name]
    frames = make_frames(96, 80, **fkw)
    enc = JEncoder(JEncoderConfig(width=96, height=80, qp=30,
                                  entropy=entropy, **ekw))
    data = b"".join(enc.encode_frame(*f) for f in frames)
    dec = H264Decoder(device="cpu")
    out = dec.decode_annexb(data)
    _equal(out, jm_decoder.H264Decoder(device_recon=True).decode_annexb(data))
    _equal(out, [r["frame"] for r in sorted(enc.results,
                                            key=lambda r: r["disp"])])
    assert path in [p["path"] for p in dec.pictures]


@pytest.mark.parametrize("name", list(JM_STREAMS))
def test_jm_encoder_stream(name):
    _check_jm_stream(name, "cavlc")


@pytest.mark.parametrize("name", list(JM_STREAMS))
def test_jm_encoder_cabac_stream(name):
    _check_jm_stream(name, "cabac")


def _check_port_stream(**kw):
    frames = make_frames(96, 80, 4, seed=11)
    enc = Encoder(EncoderConfig(width=96, height=80, qp=28, **kw),
                  device="cpu")
    data = b"".join(enc.encode_stream(frames))
    dec = H264Decoder(device="cpu")
    out = dec.decode_annexb(data)
    _equal(out, [r["frame"] for r in enc.results])
    assert [p["path"] for p in dec.pictures] == ["intra"] + ["inter"] * 3


def test_port_encoder_stream():
    _check_port_stream()


def test_port_encoder_cabac_stream():
    _check_port_stream(entropy="cabac", cabac_adapt_init=True)


def test_picture_from_numpy_through_port_recon():
    """jm_tpu's parse of each picture, converted, goes through the port's
    reconstruction and deblock to the same planes."""
    data = (GOLDEN / "ipp3.264").read_bytes()
    jm_pics = []

    class Capture(jm_decoder.H264Decoder):
        def _finish_picture(self):
            if self._cur is not None:
                jm_pics.append(self._cur["pic"])
            super()._finish_picture()

    want = Capture(device_recon=True).decode_annexb(data)

    class FromJm(port_decoder.H264Decoder):
        def _finish_picture(self):
            if self._cur is not None:
                self._cur["pic"] = picture_from_numpy(jm_pics.pop(0))
            super()._finish_picture()

    _equal(FromJm(device="cpu").decode_annexb(data), want)
    assert not jm_pics


def _as_svc(data: bytes) -> bytes:
    """The stream with the svc_extension_flag of every NAL 20 set."""
    out = bytearray(data)
    i = out.find(b"\x00\x00\x01")
    while i >= 0:
        if out[i + 3] & 0x1F == 20:
            out[i + 4] |= 0x80
        i = out.find(b"\x00\x00\x01", i + 3)
    return bytes(out)


@pytest.mark.parametrize("name,construct", [
    ("mbaff1", "MBAFF"),
    ("cif_paff_adaptive", "adaptive PAFF"),
    ("stereo_jm", "SVC"),
])
def test_out_of_scope_raises(name, construct):
    """MBAFF, adaptive PAFF and SVC raise naming the construct. The MVC
    golden decodes (tests/test_torch_mvc_decode.py); its view-1 slices
    marked as SVC slice extensions raise."""
    data = (GOLDEN / f"{name}.264").read_bytes()
    if name == "stereo_jm":
        data = _as_svc(data)
    with pytest.raises(NotImplementedError, match=construct):
        H264Decoder(device="cpu").decode_annexb(data)


def test_mvc_nal_raises():
    """MVC NAL units are read: a subset SPS cut short raises ValueError
    (a truncated NAL unit), as any parameter set does; a prefix NAL unit
    alone is skipped."""
    data = (GOLDEN / "i1.264").read_bytes()
    with pytest.raises(ValueError, match="truncated"):
        H264Decoder(device="cpu").decode_annexb(
            data + b"\x00\x00\x00\x01\x6f\x42")
    prefix = b"\x00\x00\x00\x01\x6e\x40\x00\x07"
    got = H264Decoder(device="cpu").decode_annexb(prefix + data)
    want = H264Decoder(device="cpu").decode_annexb(data)
    assert len(got) == len(want) > 0
    assert all(np.array_equal(a.Y, b.Y) for a, b in zip(got, want))


def _constrained_intra_stream(n_frames, entropy):
    frames = make_frames(96, 80, n_frames)
    enc = Encoder(EncoderConfig(width=96, height=80, qp=28,
                                entropy=entropy), device="cpu")
    enc.pps.constrained_intra_pred_flag = 1
    return b"".join(enc.encode_stream(frames))


def test_constrained_intra_pred_raises():
    """A PPS with constrained_intra_pred_flag set over I slices alone,
    CAVLC and CABAC: every neighbour is intra, the flag changes nothing,
    and the port decodes jm_tpu's frames (the P slice's refusal is
    test_constrained_intra_pred_p_slice_raises)."""
    for entropy in ("cavlc", "cabac"):
        data = _constrained_intra_stream(1, entropy)
        dec = H264Decoder(device="cpu")
        out = dec.decode_annexb(data)
        assert dec.pps_map[0].constrained_intra_pred_flag == 1
        assert len(out) == 1
        _equal(out, jm_decoder.H264Decoder(device_recon=True)
               .decode_annexb(data))


def test_constrained_intra_pred_p_slice_raises():
    """Under constrained_intra_pred_flag a P slice's intra MBs may not
    predict from inter neighbours (spec 8.3.1.2), which the port's recon
    ignores, so the decoder names the flag at the P slice."""
    data = _constrained_intra_stream(2, "cavlc")
    with pytest.raises(NotImplementedError,
                       match="constrained intra prediction in a P slice"):
        H264Decoder(device="cpu").decode_annexb(data)


def test_missing_slice_raises():
    """A picture whose MBs are not all coded raises ValueError without
    concealment (conceal_mode 0), as jm_tpu's decoder does."""
    frames = make_frames(96, 80, 1)
    enc = JEncoder(JEncoderConfig(width=96, height=80, qp=30, slice_mode=1,
                                  slice_argument=10))
    units = enc.encode_frame(*frames[0]).split(b"\x00\x00\x00\x01")
    # drop the picture's last slice NAL unit
    data = b"".join(b"\x00\x00\x00\x01" + u for u in units[1:-1])
    with pytest.raises(ValueError, match="slice data missing"):
        H264Decoder(device="cpu").decode_annexb(data)
    with pytest.raises(ValueError, match="slice data missing"):
        jm_decoder.H264Decoder().decode_annexb(data)


def test_cuda_request_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        H264Decoder()
    with pytest.raises(RuntimeError, match="CUDA"):
        decode_file(str(GOLDEN / "i1.264"))
    with pytest.raises(ValueError, match="device"):
        H264Decoder(device="meta")


@pytest.mark.parametrize("poc_type", [1, 2])
def test_poc_types_match_jm(poc_type):
    """POC types 1 and 2 over a frame_num sequence that wraps, with
    reference and non-reference pictures, against jm_tpu's PocContext."""
    rng = np.random.default_rng(poc_type)
    sps = SPS(pic_order_cnt_type=poc_type, log2_max_frame_num_minus4=0,
              offset_for_non_ref_pic=-3, offset_for_top_to_bottom_field=1,
              offset_for_ref_frame=[2, 4, 6])
    ours, theirs = PocContext(), JPocContext()
    fn = 0
    for i in range(60):
        idr = i % 23 == 0
        fn = 0 if idr else (fn + 1) % 16
        ref = int(rng.integers(0, 2)) or idr
        kw = dict(frame_num=fn, is_idr=idr, nal_ref_idc=ref,
                  delta_pic_order_cnt=(int(rng.integers(-2, 3)), 0),
                  slice_type=SliceType.P)
        h, jh = SliceHeader(**kw), JSliceHeader(**kw)
        assert ours.compute(h, sps) == theirs.compute(jh, sps)
