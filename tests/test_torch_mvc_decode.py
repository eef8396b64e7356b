"""MVC stereo (Annex H) in the port's H264Decoder against jm_tpu's on the
CPU, exactly:
- tests/golden/stereo_jm.264, JM lencod's own two-view stream (320x240,
  I / P / B, its subset SPS in JM 19.0's layout without the FRExt
  block), decodes to jm_tpu's frames (view_id and POC included), to both
  sha256 of JM's recon, and to jm_tpu's ``stats``;
- the port's two-view streams of the cases of
  tests/test_torch_mvc_encode.py (anchors, inter-view commands, view-1 B
  pictures, CABAC) decode to jm_tpu's decode and to the encoder's recon;
- parse_subset_sps reads both layouts as jm_tpu's does (the spec's, as
  both encoders write it, and JM's);
- reorder_list's inter-view commands (idc 4 / 5) move the appended
  view-0 picture to the command's index, and without it raise;
- the prefix NAL units change no frame (an SVC slice extension raises
  NotImplementedError naming SVC: tests/test_torch_decoder.py
  test_out_of_scope_raises[stereo_jm])."""

import hashlib
from pathlib import Path

import numpy as np
import pytest

from jm_tpu.decoder import parset as jparset
from jm_tpu.decoder.decoder import H264Decoder as JaxDecoder
from jm_tpu.encoder.syntax import write_subset_sps as jax_write_subset_sps
from jm_tpu_torch.bitstream.nal import NalUnitType, rbsp_to_ebsp, split_annexb
from jm_tpu_torch.common.types import SPS, RefPicListMod
from jm_tpu_torch.decoder.decoder import H264Decoder
from jm_tpu_torch.decoder.dpb import DPB, Frame
from jm_tpu_torch.decoder.parset import parse_subset_sps
from jm_tpu_torch.encoder.encoder import Encoder, EncoderConfig
from jm_tpu_torch.encoder.syntax import write_subset_sps

from test_torch_mvc_encode import CASES, H, QP, W, encode, stereo_pair
from torch_streams import one_torch_thread  # noqa: F401

GOLDEN = Path(__file__).parent / "golden"
# sha256 of JM lencod's recon of each view (tests/test_mvc.py)
GOLDEN_V0 = "926b27db8b24cef65eb908831cdbaa65897d7f7642b0f000d12a0bfd6b524780"
GOLDEN_V1 = "93415fed2650ed80a41030a74f54b67c0a3d15cf2cad7f5cf4061d9d3c3759f7"


def _same(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert (a.view_id, a.poc) == (b.view_id, b.poc)
        for p, q in zip((a.Y, a.U, a.V), (b.Y, b.U, b.V)):
            assert p.dtype == q.dtype and np.array_equal(p, q)


@pytest.fixture(scope="module")
def golden():
    """stereo_jm.264, and the port's decoder after decoding it with its
    frames."""
    data = (GOLDEN / "stereo_jm.264").read_bytes()
    dec = H264Decoder(device="cpu")
    return data, dec, dec.decode_annexb(data)


def test_stereo_jm_golden(golden):
    data, dec, got = golden
    jdec = JaxDecoder(device_recon=True)
    _same(got, jdec.decode_annexb(data))
    assert dec.stats == jdec.stats
    for view, sha in ((0, GOLDEN_V0), (1, GOLDEN_V1)):
        fr = sorted((f for f in got if f.view_id == view),
                    key=lambda f: f.poc)
        blob = b"".join(f.Y.tobytes() + f.U.tobytes() + f.V.tobytes()
                        for f in fr)
        assert hashlib.sha256(blob).hexdigest() == sha, f"view {view}"


@pytest.mark.parametrize("case", CASES)
def test_port_streams_decode_as_jm_tpus(case):
    """The port's streams (byte-identical to jm_tpu's,
    tests/test_torch_mvc_encode.py) through both decoders; the view-1
    frames equal the encoder's recon."""
    kw, n = CASES[case]
    left, right = stereo_pair(n)
    enc = Encoder(EncoderConfig(width=W, height=H, qp=QP, num_views=2,
                                **kw), device="cpu")
    stream = encode(enc, left, right)
    got = H264Decoder(device="cpu").decode_annexb(stream)
    _same(got, JaxDecoder().decode_annexb(stream))
    view1 = [f for f in got if f.view_id == 1]
    for f, r in zip(view1, enc.results_v1):
        assert np.array_equal(f.Y, r["frame"].Y)
        assert np.array_equal(f.V, r["frame"].V)


def _jm_subset_rbsp() -> bytes:
    data = (GOLDEN / "stereo_jm.264").read_bytes()
    return next(n.rbsp for n in split_annexb(data)
                if n.nal_unit_type == NalUnitType.SUBSET_SPS)


@pytest.mark.parametrize("layout", ["spec", "jm19"])
def test_parse_subset_sps_is_jm_tpus(layout):
    if layout == "spec":
        sps = SPS(profile_idc=100, level_idc=30, pic_width_in_mbs_minus1=10,
                  pic_height_in_map_units_minus1=8, max_num_ref_frames=2)
        rbsp = write_subset_sps(sps)
        assert rbsp == jax_write_subset_sps(sps)
    else:
        rbsp = _jm_subset_rbsp()
    got, want = parse_subset_sps(rbsp), jparset.parse_subset_sps(rbsp)
    assert got.profile_idc == 128 and got.mvc == want.mvc
    assert got.mvc["view_id"] == [0, 1]
    for f in ("chroma_format_idc", "pic_width_in_mbs_minus1",
              "pic_height_in_map_units_minus1", "max_num_ref_frames",
              "log2_max_frame_num_minus4", "pic_order_cnt_type",
              "frame_mbs_only_flag", "direct_8x8_inference_flag"):
        assert getattr(got, f) == getattr(want, f), f


def _frames(dpb, n):
    out = []
    for k in range(n):
        f = Frame(poc=2 * k, frame_num=k, state=())
        dpb.store(f)
        out.append(f)
    return out


@pytest.mark.parametrize("idc", [4, 5])
@pytest.mark.parametrize("at", [0, 1])
def test_reorder_list_inter_view(idc, at):
    """H.8.2.2.3 with one dependent view: an inter-view command moves the
    appended view-0 picture to the command's index; the temporal ones
    keep their order behind it."""
    sps = SPS(max_num_ref_frames=3)
    dpb = DPB(sps, uid0=1 << 24)
    temporal = _frames(dpb, 3)
    iv = Frame(poc=6, frame_num=3, state=(), uid=7)
    base = dpb.ref_list_p(3) + [iv]
    mods = [RefPicListMod(0, 0)] if at else []
    mods.append(RefPicListMod(idc, 0))
    got = dpb.reorder_list(base, mods, 3, 4, inter_view=iv)
    assert got[at] is iv
    assert [f for f in got if f is not iv] == \
        [f for f in reversed(temporal)]
    with pytest.raises(ValueError, match="inter-view"):
        dpb.reorder_list(dpb.ref_list_p(3), mods, 3, 3)


def test_prefix_nal_is_skipped(golden):
    """The prefix NAL units (14) of a base view change no frame: the base
    view without them decodes the same."""
    data, _, frames = golden
    base = b"".join(b"\x00\x00\x00\x01" + bytes([(n.nal_ref_idc << 5)
                                                 | n.nal_unit_type])
                    + rbsp_to_ebsp(n.rbsp) for n in split_annexb(data)
                    if n.nal_unit_type in (1, 5, 7, 8))
    _same(H264Decoder(device="cpu").decode_annexb(base),
          [f for f in frames if f.view_id == 0])
