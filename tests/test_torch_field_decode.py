"""The port's decoder on PAFF field pictures against jm_tpu's on the CPU,
exactly (the codec is integer-exact: the tolerance is zero):
- JM's goldens field2 (I P P field pictures, four reference frames: lists
  of up to 8 fields, parities alternating), field1 and fieldcab (CAVLC
  and CABAC frame pictures under an SPS that allows fields, cropped from
  160 to 144 rows in units of 4): the
  port's frames against jm_tpu's H264Decoder and JM ldecod's output
  (_rec.yuv, in POC order); each field's parse field by field; jm_tpu's
  parse of every picture through the port's reconstruction and deblock;
- the stages a field adds: compute_bs(field=True) (a vertical MV limit
  of 2, bS 3 on horizontal MB edges next to intra MBs) against jm_tpu's
  compute_bs of a field PictureData; decode_residuals and
  ops/dec.p_dec_residuals with the field scan against jm_tpu's
  decode_residuals of a parsed field; the device inter recon of P fields
  that predict from reference fields of the other parity against
  jm_tpu's host Reconstructor; the cropping of a frame whose SPS allows
  fields (CropUnitY times 2);
- field pictures above 8 bits (the port encoder's field stream under a
  High 10 SPS, at 14 bits, at 9 bits with the slice QPs moved, lossless
  at 10 bits) and at 4:2:2 (the port's 4:2:2 host coders' pictures
  re-framed as fields, torch_streams.reframed_fields; 8 and 10 bits),
  each decoded equal to jm_tpu's, field by field in the parse; a 4:2:2
  P field predicting from the other parity, whose chroma takes no
  offset (with the 4:2:0 one forced, it would differ);
- what stays out of scope raises NotImplementedError naming it, on
  streams made from the port encoder's own field stream: CABAC and B
  field pictures, field list modification and field MMCO (as jm_tpu
  does) and field pictures with the 8x8 transform;
- the CIF golden cif_field (60 field pictures) decodes to the sha256 of
  ldecod's output that tests/test_cif_conformance.py records."""

import hashlib
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from jm_tpu.decoder import decoder as jm_decoder
from jm_tpu.decoder import recon as jm_recon
from jm_tpu.decoder.recon import decode_residuals as jm_decode_residuals
from jm_tpu.ops.deblock import compute_bs as jm_compute_bs
from jm_tpu_torch.bitstream.nal import (NalUnitType, annexb_bytes,
                                        split_annexb)
from jm_tpu_torch.common.types import SPS, SliceType
from jm_tpu_torch.convert import picture_from_numpy, qpc_tables
from jm_tpu_torch.decoder import decoder as port_decoder
from jm_tpu_torch.decoder.decoder import H264Decoder, _crop_output
from jm_tpu_torch.decoder.parset import parse_pps, parse_sps
from jm_tpu_torch.decoder.recon import build_inv_scale, decode_residuals
from jm_tpu_torch.encoder.syntax import (write_pps,
                                         write_sps)
from jm_tpu_torch.ops import dec
from jm_tpu_torch.ops.deblock import compute_bs

from test_deblock_jax import random_pic
from torch_streams import field_stream as make_field_stream
from torch_streams import one_torch_thread  # noqa: F401
from torch_streams import host_fields, reheaded, rewritten_slice

GOLDEN = Path(__file__).parent / "golden"
GOLDENS = {"field1": 6, "field2": 12, "fieldcab": 6}
PIC_FIELDS = ("mb_class", "skip", "i4_modes", "i16_mode", "chroma_mode",
              "cbp", "qp", "slice_id", "luma_coef", "luma_dc", "chroma_dc",
              "chroma_coef", "luma_nnz", "chroma_nnz", "mv", "ref_idx",
              "ref_pic_id")


class JmCapture(jm_decoder.H264Decoder):
    """jm_tpu's decoder keeping each picture's parsed PictureData and
    the host Reconstructor's planes (before the deblock)."""

    def __init__(self):
        super().__init__(device_recon=False)
        self.pics, self.recon = [], []

    def _finish_picture(self):
        if self._cur is not None and self._cur["headers"]:
            self.pics.append(self._cur["pic"])
        run = jm_recon.Reconstructor.run

        def keep(rec, seed=None):
            out = run(rec, seed)
            self.recon.append(tuple(np.array(p) for p in out))
            return out

        with mock.patch.object(jm_recon.Reconstructor, "run", keep):
            super()._finish_picture()


class PortCapture(port_decoder.H264Decoder):
    """The port's decoder keeping each picture's parsed PictureData and
    its device inter recon (the MBs outside the inter mask zero)."""

    def __init__(self):
        super().__init__(device="cpu")
        self.pics, self.inter = [], {}

    def _finish_picture(self):
        if self._cur is not None:
            self.pics.append(self._cur["pic"])
        super()._finish_picture()

    def _inter_recon(self, pic, *args):
        out = super()._inter_recon(pic, *args)
        self.inter[len(self.pics) - 1] = tuple(p.numpy() for p in out)
        return out


def frames_equal(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.poc == b.poc
        for p in "YUV":
            assert np.array_equal(getattr(a, p), getattr(b, p)), \
                f"frame {i} plane {p}"


@pytest.fixture(scope="module")
def golden_runs():
    cache = {}

    def get(name):
        if name not in cache:
            data = (GOLDEN / f"{name}.264").read_bytes()
            port, jm = PortCapture(), JmCapture()
            cache[name] = (data, port, port.decode_annexb(data), jm,
                           jm.decode_annexb(data))
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(GOLDENS))
def test_field_golden_decodes_like_jm_and_ldecod(name, golden_runs,
                                                 one_torch_thread):
    data, port, frames, jm, jm_frames = golden_runs(name)
    frames_equal(frames, jm_frames)
    n = GOLDENS[name]
    assert len(frames) == n and frames[0].Y.shape == (144, 176)
    want = np.fromfile(GOLDEN / f"{name}_rec.yuv", np.uint8).reshape(n, -1)
    for i, f in enumerate(sorted(frames, key=lambda f: f.poc)):
        got = np.concatenate([f.Y.ravel(), f.U.ravel(), f.V.ravel()])
        assert np.array_equal(got, want[i]), f"frame {i}"
    # field2 codes every frame as two fields, field1 and fieldcab as one
    # frame picture of 10 MB rows
    fields = [(p.field_mode, p.mb_h) for p in port.pics]
    assert fields == ([(True, 5)] * 2 * n if name == "field2"
                      else [(False, 10)] * n)


def test_field_parse_matches_jm(golden_runs):
    _, port, _, jm, _ = golden_runs("field2")
    assert len(port.pics) == len(jm.pics) == 24
    for i, (p, j) in enumerate(zip(port.pics, jm.pics)):
        assert (p.mb_w, p.mb_h) == (11, 5) and p.field_mode == j.field_mode
        for k in PIC_FIELDS[:-1]:
            assert np.array_equal(getattr(p, k), getattr(j, k)), \
                f"picture {i} field {k}"
    # the P fields predict from more than two reference fields
    assert max(int(p.ref_idx.max()) for p in port.pics) >= 2


@pytest.mark.parametrize("name", list(GOLDENS))
def test_field_recon_from_jm_parse(name, golden_runs, one_torch_thread):
    """jm_tpu's parse of every picture through the port's reconstruction
    and deblock gives jm_tpu's frames."""
    data, _, _, jm, jm_frames = golden_runs(name)
    pics = list(jm.pics)

    class FromJm(port_decoder.H264Decoder):
        def _finish_picture(self):
            if self._cur is not None:
                self._cur["pic"] = picture_from_numpy(pics.pop(0))
            super()._finish_picture()

    frames_equal(FromJm(device="cpu").decode_annexb(data), jm_frames)
    assert not pics


def test_opposite_parity_p_fields_match_jm_reconstructor(golden_runs):
    """The device inter recon of field2's P fields (ops/dec.inter_recon_p
    with each reference field's chroma offset) equals jm_tpu's host
    Reconstructor on every inter MB; the fields predict from references
    of both parities."""
    _, port, _, jm, _ = golden_runs("field2")
    checked = opposite = 0
    for i, pic in enumerate(port.pics):
        if i not in port.inter:
            continue
        inter = pic.mb_class == 0
        mby, mbx = np.divmod(np.flatnonzero(inter), pic.mb_w)
        for plane, got, want in zip("YUV", port.inter[i], jm.recon[i]):
            s = 16 if plane == "Y" else 8
            for y, x in zip(mby, mbx):
                blk = np.s_[y * s:(y + 1) * s, x * s:(x + 1) * s]
                assert np.array_equal(got[blk], want[blk]), \
                    f"picture {i} {plane} MB ({y}, {x})"
        # list0 alternates parities from the field's own: odd ref_idx are
        # fields of the other parity
        opposite += int((pic.ref_idx[inter] % 2 == 1).sum())
        checked += 1
    assert checked >= 8 and opposite > 0


@pytest.mark.parametrize("field", [True, False])
def test_compute_bs_field_rules(field):
    """compute_bs(field=True) against jm_tpu's compute_bs of a field
    PictureData, and of a frame one: intra MBs, and MVs near the limits
    (vertical differences of 2 and 3 quarter samples give bS 1 in a
    field, 0 in a frame)."""
    rng = np.random.default_rng(11)
    jpic = random_pic(rng, 7, 5, intra_frac=0.25, multi_ref=True)
    jpic.mv[:] = rng.integers(-3, 4, jpic.mv.shape)
    jpic.mv[jpic.mb_class != 0] = 0
    jpic.luma_nnz[rng.random(jpic.luma_nnz.shape) < 0.7] = 0
    jpic.field_mode = field
    want = jm_compute_bs(jpic, 7, 5)
    pic = picture_from_numpy(jpic)
    assert pic.field_mode == field
    t = torch.as_tensor
    got = compute_bs(t(pic.mb_class), t(pic.luma_nnz),
                     t(pic.transform8x8.astype(np.int32)), t(pic.mv),
                     t(pic.mv_l1), t(pic.ref_pic_id), t(pic.ref_pic_id_l1),
                     7, 5, field=field)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)
    # horizontal MB edges next to an intra MB: bS 3 in a field, 4 in a
    # frame
    assert set(np.unique(want[1][4::4])) >= {3 if field else 4}
    assert (4 if field else 3) not in set(np.unique(want[1][4::4]))
    jpic.field_mode = not field
    other = jm_compute_bs(jpic, 7, 5)
    assert (other[0] != want[0]).any()          # the MV limit acts


def test_field_scan_residuals_match_jm(golden_runs):
    """decode_residuals (every MB) and ops/dec.p_dec_residuals(field=True)
    (the inter MBs, inter lists) of each parsed field of field2 against
    jm_tpu's decode_residuals of the same field."""
    _, port, _, jm, _ = golden_runs("field2")
    pps, jpps = port.pps_map[0], jm.pps_map[0]
    t = torch.as_tensor
    tab4 = build_inv_scale(pps)
    qcb, qcr = qpc_tables(pps)
    n_inter = 0
    for pic, jpic in zip(port.pics, jm.pics):
        assert pic.field_mode and jpic.field_mode
        want_l, want_c = jm_decode_residuals(jpic, jpps)
        got_l, got_c = decode_residuals(pic, pps)
        assert np.array_equal(got_l, want_l)
        assert np.array_equal(got_c, want_c)
        inter = pic.mb_class == 0
        dl, dc = dec.p_dec_residuals(
            t(pic.luma_coef), t(pic.chroma_dc), t(pic.chroma_coef),
            t(pic.qp), *(t(tab4[i]) for i in (3, 4, 5)), qcb, qcr,
            mb_w=pic.mb_w, mb_h=pic.mb_h, field=True)
        assert np.array_equal(dl.numpy()[inter], want_l[inter])
        assert np.array_equal(dc.numpy()[inter], want_c[inter])
        n_inter += int(inter.sum())
    assert n_inter > 50


@pytest.mark.parametrize("top,bottom,left,right", [
    (0, 4, 0, 0), (2, 3, 1, 2)])
def test_crop_output_field_sps(top, bottom, left, right):
    """An SPS without frame_mbs_only_flag crops in units of 4 rows at
    4:2:0 (CropUnitY = 2 (2 - frame_mbs_only_flag)), as jm_tpu's
    _crop_output."""
    sps = SPS(frame_mbs_only_flag=0, frame_cropping_flag=1,
              frame_crop_top_offset=top, frame_crop_bottom_offset=bottom,
              frame_crop_left_offset=left, frame_crop_right_offset=right,
              pic_width_in_mbs_minus1=10, pic_height_in_map_units_minus1=4)
    rng = np.random.default_rng(2)
    planes = (rng.integers(0, 256, (160, 176), np.uint8),
              rng.integers(0, 256, (80, 88), np.uint8),
              rng.integers(0, 256, (80, 88), np.uint8))
    got = _crop_output(sps, *planes)
    want = jm_decoder._crop_output(sps, *planes)
    assert got[0].shape == (160 - 4 * (top + bottom), 176 - 2 * (left + right))
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_cif_field_matches_the_recorded_sha256(one_torch_thread):
    frames = sorted(H264Decoder(device="cpu").decode_annexb(
        (GOLDEN / "cif_field.264").read_bytes()), key=lambda f: f.poc)
    assert len(frames) == 30
    sha = hashlib.sha256(b"".join(f.Y.tobytes() + f.U.tobytes()
                                  + f.V.tobytes() for f in frames))
    assert sha.hexdigest() == ("2e476073972f719518765fd4a58b4a46c01335472864"
                               "d9da58bbb8332462fa10")


# ---- field pictures at 4:2:2 and at 9-14 bits ------------------------------

@pytest.fixture(scope="module")
def field_stream():
    """The port encoder's field stream of 2 frames at 32x32 (an IDR top
    field, then P fields)."""
    return make_field_stream(2, 32, 32)


@pytest.fixture(scope="module")
def y422_stream():
    """A 4:2:2 field stream of 2 frames at 32x32: 4 pictures of the port's
    4:2:2 host coders re-framed as fields (torch_streams.host_fields)."""
    return host_fields(4, 32, 32)


def _lossless10(_fs):
    """A 10-bit field stream whose MBs are all lossless: the port's field
    coder at QP 0 under a profile-244 SPS with the bypass flag, every
    slice QP moved to -12 (QP'Y 0)."""
    return reheaded(make_field_stream(2, 32, 32, qp=0), 244, 10, bypass=1,
                    init_qp_shift=-12)


FIELD_STREAMS = {
    # name: (the stream from field_stream / y422_stream, bit depth)
    "bits14": (lambda fs, ys: reheaded(fs, 244, 14), 14),
    "bits9_qp_shift": (lambda fs, ys: reheaded(fs, 110, 9,
                                               init_qp_shift=-20), 9),
    "lossless10": (lambda fs, ys: _lossless10(fs), 10),
    "y422_10bit": (lambda fs, ys: reheaded(ys, 122, 10), 10),
}


def _decode_like_jm(data):
    """The port's and jm_tpu's decode of data, held equal (POC, Y, U, V);
    returns the port's capture and frames."""
    port, jm = PortCapture(), JmCapture()
    frames = port.decode_annexb(data)
    frames_equal(frames, jm.decode_annexb(data))
    assert len(frames) == 2 and all(p.field_mode for p in port.pics)
    return port, frames


@pytest.mark.parametrize("name", list(FIELD_STREAMS))
def test_field_streams_decode_like_jm(name, field_stream, y422_stream,
                                      one_torch_thread):
    """Field pictures above 8 bits (High 10 and High 4:4:4 Predictive at
    4:2:0, lossless MBs included) and at 4:2:2 10 bits, each field's
    parse field by field and its frames equal to jm_tpu's."""
    make, bd = FIELD_STREAMS[name]
    port, frames = _decode_like_jm(make(field_stream, y422_stream))
    jm = JmCapture()
    jm.decode_annexb(make(field_stream, y422_stream))
    for i, (p, j) in enumerate(zip(port.pics, jm.pics)):
        for k in PIC_FIELDS[:-1]:
            assert np.array_equal(getattr(p, k), getattr(j, k)), (i, k)
    assert frames[0].Y.dtype == np.uint16
    assert int(max(f.Y.max() for f in frames)) >= 1 << (bd - 1)
    if name == "lossless10":
        assert all((p.qp == -12).all() for p in port.pics)
    if name.startswith("y422"):
        assert frames[0].U.shape == (32, 16)
        assert [p.mb_h for p in port.pics] == [1] * 4


def test_422_field_has_no_opposite_parity_chroma_offset(y422_stream,
                                                        monkeypatch):
    """The bottom field of frame 0 predicts from the top field, of the
    other parity: at 4:2:2 its chroma vectors take no offset (spec
    8.4.1.4; jm_tpu/decoder/recon.py:603-612 applies -2 / +2 at 4:2:0
    only). Its device inter recon equals jm_tpu's host Reconstructor on
    every inter MB (16 x 16 luma, 8 x 16 chroma); with the 4:2:0 offset
    forced, the chroma would differ."""
    port, jm = PortCapture(), JmCapture()
    port.decode_annexb(y422_stream)
    jm.decode_annexb(y422_stream)
    pic = port.pics[1]
    inter = pic.mb_class == 0
    assert inter.any() and pic.field_mode and pic.n_crows == 4
    for plane, got, want in zip("YUV", port.inter[1], jm.recon[1]):
        assert got.shape == want.shape == (16, 32 if plane == "Y" else 16)
        w = 16 if plane == "Y" else 8
        for x in np.flatnonzero(inter):
            assert np.array_equal(got[:, x * w:(x + 1) * w],
                                  want[:, x * w:(x + 1) * w]), (plane, x)
    # the same recon with the opposite-parity offset of a 4:2:0 bottom field
    real = dec.inter_recon_p

    def offset(*a, chroma_dy=None, **kw):
        return real(*a, chroma_dy=torch.full((a[4].shape[0],), 2), **kw)

    forced = PortCapture()
    monkeypatch.setattr(port_decoder.D, "inter_recon_p", offset)
    forced.decode_annexb(y422_stream)
    assert np.array_equal(forced.inter[1][0], port.inter[1][0])
    assert not all(np.array_equal(a, b) for a, b in
                   zip(forced.inter[1][1:], port.inter[1][1:]))


# ---- what stays out of scope ----------------------------------------------

def _rewrite(data, *, sps=None, pps=None, slice_at=None, **header):
    """The stream with its SPS / PPS changed by sps(SPS) / pps(PPS), and
    the slice_at-th slice's header written again with the keywords
    header changed (its slice data kept bit for bit)."""
    out, sps_map, pps_map, k = [], {}, {}, 0
    for nal in split_annexb(data):
        rbsp = nal.rbsp
        t = nal.nal_unit_type
        if t == NalUnitType.SPS:
            s = parse_sps(rbsp)
            sps_map[s.seq_parameter_set_id] = s
            if sps is not None:
                sps(s)
                rbsp = write_sps(s)
        elif t == NalUnitType.PPS:
            p = parse_pps(rbsp, sps_map)
            pps_map[p.pic_parameter_set_id] = p
            if pps is not None:
                pps(p)
                rbsp = write_pps(p)
        elif t in (NalUnitType.SLICE, NalUnitType.IDR):
            if k == slice_at:
                rbsp = rewritten_slice(nal, sps_map, pps_map, **header)
            k += 1
        out.append(annexb_bytes(nal.nal_ref_idc, t, rbsp))
    return b"".join(out)


def test_rewrite_keeps_the_stream(field_stream):
    """The rewriting helper with no change gives a stream that decodes
    to the same frames (so that each refusal below is the construct's)."""
    again = _rewrite(field_stream, slice_at=2)
    frames_equal(H264Decoder(device="cpu").decode_annexb(again),
                 H264Decoder(device="cpu").decode_annexb(field_stream))


def _t8(p):
    p.transform_8x8_mode_flag = 1


REFUSALS = {
    "cabac": (dict(pps=lambda p: setattr(p, "entropy_coding_mode_flag", 1)),
              "CABAC field pictures"),
    "b_field": (dict(slice_at=1, slice_type=SliceType.B), "B field pictures"),
    "list_modification": (dict(slice_at=2, ref_mod_l0=((0, 0),)),
                          "field ref_pic_list_modification"),
    "mmco": (dict(slice_at=1, mmco_ops=((1, 0),)), "field MMCO"),
    "transform8x8": (dict(pps=_t8), "field pictures with the 8x8 transform"),
}


@pytest.mark.parametrize("case", list(REFUSALS) + ["high10", "yuv422"])
def test_field_refusals(case, field_stream, y422_stream, one_torch_thread):
    """What jm_tpu does not decode in a field picture raises
    NotImplementedError naming it. Field pictures above 8 bits and at
    4:2:2, refused until the port covered them, decode to jm_tpu's frames
    (cases high10: the field stream under a High 10 SPS; yuv422: a 4:2:2
    stream re-framed as fields, since the 4:2:0 data under a 4:2:2 SPS
    makes jm_tpu raise IndexError too)."""
    if case == "high10":
        _, frames = _decode_like_jm(reheaded(field_stream, 110, 10))
        assert frames[0].Y.dtype == np.uint16
        return
    if case == "yuv422":
        _, frames = _decode_like_jm(y422_stream)
        assert frames[0].U.shape == (32, 16)
        return
    kw, match = REFUSALS[case]
    with pytest.raises(NotImplementedError, match=match):
        H264Decoder(device="cpu").decode_annexb(_rewrite(field_stream, **kw))
