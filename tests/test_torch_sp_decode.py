"""SP switching pictures in the port's decoder against jm_tpu's on the
CPU, exactly (the tolerance is zero everywhere):
- the SP slice headers of the goldens sp1 (QCIF, 9 pictures, 2 SP) and
  cif_sp (CIF, 30 pictures, 5 SP), field by field;
- ops/dec.sp_recon against jm_tpu's host Reconstructor._sp_luma /
  _sp_chroma on seeded random predictions and levels, at every QP and QS
  of 0..51, with sp_for_switch_flag 0 and 1;
- ops/deblock.compute_bs(sp_slice=) against jm_tpu's host compute_bs
  (jm_tpu/ops/deblock.py) on seeded random pictures, and on such bS the
  plain deblock, and the kernels' phase schedule emulated with its tile
  steps, against jm_tpu's host deblock_picture;
- sp1 decoded whole equal to JM ldecod's sp1_rec.yuv and to jm_tpu's
  decode, its SP slices parsed natively (as P slices, then marked) to
  the Python parser's arrays, and jm_tpu's parse of each picture through
  convert.picture_from_numpy and the port's reconstruction;
- cif_sp equal to the sha256 of ldecod's output;
- an SI slice (written by the port's header writer) and SP slices under
  CABAC raise NotImplementedError naming them, as in jm_tpu."""

import dataclasses
import hashlib
from pathlib import Path

import numpy as np
import pytest
import torch

from jm_tpu.bitstream.nal import split_annexb as jm_split
from jm_tpu.decoder import decoder as jm_decoder
from jm_tpu.decoder.header import parse_slice_header as jm_slice_header
from jm_tpu.decoder.mb_parse import PictureData as JPicture
from jm_tpu.decoder.parset import parse_pps as jm_pps
from jm_tpu.decoder.parset import parse_sps as jm_sps
from jm_tpu.decoder.recon import Reconstructor as JReconstructor
from jm_tpu.ops.deblock import compute_bs as jm_compute_bs
from jm_tpu_torch import native as N
from jm_tpu_torch.bitstream.bitwriter import BitWriter
from jm_tpu_torch.bitstream.nal import NalUnitType, annexb_bytes, split_annexb
from jm_tpu_torch.common.tables import chroma_qp
from jm_tpu_torch.common.types import SliceHeader, SliceType
from jm_tpu_torch.convert import picture_from_numpy
from jm_tpu_torch.decoder import decoder as port_decoder
from jm_tpu_torch.decoder import mb_parse
from jm_tpu_torch.decoder.decoder import H264Decoder
from jm_tpu_torch.decoder.header import parse_slice_header
from jm_tpu_torch.decoder.parset import parse_pps, parse_sps
from jm_tpu_torch.encoder.encoder import Encoder, EncoderConfig
from jm_tpu_torch.encoder.syntax import write_slice_header
from jm_tpu_torch.ops import dec as D
from jm_tpu_torch.ops.deblock import compute_bs

from test_pipe_stream import make_frames
from torch_streams import one_torch_thread  # noqa: F401

GOLDEN = Path(__file__).parent / "golden"
# sha256 of JM ldecod's output of cif_sp.264 (tests/test_cif_conformance.py)
CIF_SP_SHA = ("a60dbb7782e35716463637f8360c6643b301c5b62564f7c02243"
              "591eb32d75f3")


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _yuv(frames):
    return b"".join(f.Y.tobytes() + f.U.tobytes() + f.V.tobytes()
                    for f in frames)


@pytest.mark.parametrize("name", ["sp1", "cif_sp"])
def test_sp_headers_match_jm(name):
    data = (GOLDEN / f"{name}.264").read_bytes()
    hdr_f = [f.name for f in dataclasses.fields(SliceHeader)
             if f.name not in ("ref_pic_list_mod_l0", "ref_pic_list_mod_l1",
                               "mmco_ops")]
    sm, pm, jsm, jpm = {}, {}, {}, {}
    types = []
    for u, ju in zip(split_annexb(data), jm_split(data)):
        if u.nal_unit_type == 7:
            s, js = parse_sps(u.rbsp), jm_sps(ju.rbsp)
            sm[s.seq_parameter_set_id], jsm[js.seq_parameter_set_id] = s, js
        elif u.nal_unit_type == 8:
            p, jp = parse_pps(u.rbsp, sm), jm_pps(ju.rbsp, jsm)
            pm[p.pic_parameter_set_id], jpm[jp.pic_parameter_set_id] = p, jp
        elif u.nal_unit_type in (1, 5):
            (h, br), (jh, jbr) = parse_slice_header(u, sm, pm), \
                jm_slice_header(ju, jsm, jpm)
            for k in hdr_f:
                assert getattr(h, k) == getattr(jh, k), k
            assert br.pos == jbr.pos
            assert h.qs(pm[h.pic_parameter_set_id]) == \
                jh.qs(jpm[jh.pic_parameter_set_id])
            types.append(h.slice_type)
    assert SliceType.SP in types and SliceType.SI not in types


@pytest.mark.parametrize("switch", [0, 1])
def test_sp_recon_matches_jm(switch):
    """Every (QP, QS) of 0..51 on one MB each: 52 x 52 MBs, half of them
    SP, against jm_tpu's per-MB _sp_luma / _sp_chroma."""
    rng = np.random.default_rng(7 + switch)
    mb_w, mb_h = 52, 52
    n = mb_w * mb_h
    jp = JPicture(mb_w, mb_h)
    qp, qs = np.meshgrid(np.arange(52), np.arange(52), indexing="ij")
    jp.qp[:] = qp.ravel()
    jp.sp_qs[:] = qs.ravel()
    jp.sp_switch[:] = bool(switch)
    sparse = rng.random(jp.luma_coef.shape) < 0.3
    jp.luma_coef[:] = rng.integers(-40, 41, jp.luma_coef.shape) * sparse
    jp.chroma_dc[:] = rng.integers(-60, 61, jp.chroma_dc.shape)
    cc = rng.integers(-40, 41, jp.chroma_coef.shape) * \
        (rng.random(jp.chroma_coef.shape) < 0.3)
    cc[..., 0] = 0
    jp.chroma_coef[:] = cc
    Y = rng.integers(0, 256, (16 * mb_h, 16 * mb_w)).astype(np.uint8)
    U = rng.integers(0, 256, (8 * mb_h, 8 * mb_w)).astype(np.uint8)
    V = rng.integers(0, 256, (8 * mb_h, 8 * mb_w)).astype(np.uint8)
    idx = np.flatnonzero(rng.random(n) < 0.5)
    rec = JReconstructor.__new__(JReconstructor)
    rec.pic = jp
    wy, wu, wv = Y.copy(), U.copy(), V.copy()
    for a in idx:
        y, x = (a // mb_w) * 16, (a % mb_w) * 16
        wy[y:y + 16, x:x + 16] = rec._sp_luma(
            a, Y[y:y + 16, x:x + 16].astype(np.int64))
        cu, cv = rec._sp_chroma(
            a, U[y // 2:y // 2 + 8, x // 2:x // 2 + 8].astype(np.int64),
            V[y // 2:y // 2 + 8, x // 2:x // 2 + 8].astype(np.int64))
        wu[y // 2:y // 2 + 8, x // 2:x // 2 + 8] = cu
        wv[y // 2:y // 2 + 8, x // 2:x // 2 + 8] = cv
    got = D.sp_recon(_t(Y), _t(U), _t(V), _t(idx.astype(np.int64)),
                     _t(jp.luma_coef), _t(jp.chroma_dc), _t(jp.chroma_coef),
                     _t(jp.qp), _t(jp.sp_qs), _t(jp.sp_switch), mb_w=mb_w)
    for g, w in zip(got, (wy, wu, wv)):
        assert np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("seed,field", [(1, False), (2, False), (3, True)])
def test_compute_bs_sp_matches_jm(seed, field):
    rng = np.random.default_rng(seed)
    mb_w, mb_h = 7, 5
    n = mb_w * mb_h
    jp = JPicture(mb_w, mb_h)
    jp.field_mode = field
    jp.mb_class[:] = np.where(rng.random(n) < 0.2, 1, 0)
    jp.luma_nnz[:] = rng.integers(0, 3, (n, 16)) * (rng.random((n, 16)) < .3)
    jp.transform8x8[:] = rng.random(n) < 0.2
    jp.mv[:] = rng.integers(-6, 7, (n, 16, 2))
    jp.ref_pic_id[:] = rng.integers(0, 2, (n, 4))
    jp.sp_slice[:] = rng.random(n) < 0.5
    want = jm_compute_bs(jp, mb_w, mb_h)
    got = compute_bs(_t(jp.mb_class), _t(jp.luma_nnz),
                     _t(jp.transform8x8.astype(np.int32)), _t(jp.mv),
                     _t(jp.mv_l1), _t(jp.ref_pic_id), _t(jp.ref_pic_id_l1),
                     mb_w, mb_h, field=field, sp_slice=_t(jp.sp_slice))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)
    # every edge of an SP MB but the picture's border is filtered
    spq = np.repeat(np.repeat(jp.sp_slice.reshape(mb_h, mb_w), 4, 0), 4, 1)
    assert (got[0].numpy()[:, 1:][spq[:, 1:]] >= 3).all()
    assert (got[1].numpy()[1:][spq[1:]] >= 3).all()


def test_sp1_decodes_like_ldecod_and_jm(one_torch_thread):
    data = (GOLDEN / "sp1.264").read_bytes()
    N.reset_routes()
    dec = H264Decoder(device="cpu")
    out = dec.decode_annexb(data)
    assert _yuv(out) == (GOLDEN / "sp1_rec.yuv").read_bytes()
    want = jm_decoder.H264Decoder().decode_annexb(data)
    assert _yuv(out) == _yuv(want)
    assert N.routes["sp"]["parse"] == 2
    assert N.routes["parse"]["native"] == 9
    assert [p["type"] for p in dec.pictures].count("SP") == 2


def test_sp_native_parse_equals_python(monkeypatch):
    """The native parser reads an SP slice as a P slice; the MBs it fills,
    then marked, equal the Python parser's."""
    data = (GOLDEN / "sp1.264").read_bytes()
    pics = {}

    def capture(key):
        class Capture(port_decoder.H264Decoder):
            def _finish_picture(self):
                if self._cur is not None:
                    pics.setdefault(key, []).append(self._cur["pic"])
                super()._finish_picture()
        return Capture(device="cpu")

    capture("native").decode_annexb(data)
    monkeypatch.setattr(mb_parse.MBParser, "_parse_native",
                        lambda self: False)
    capture("python").decode_annexb(data)
    for a, b in zip(pics["native"], pics["python"]):
        for k, v in vars(a).items():
            if isinstance(v, np.ndarray):
                assert np.array_equal(v, getattr(b, k)), k
    assert sum(p.sp_mb.any() for p in pics["native"]) == 2


def test_jm_parse_through_port_recon(one_torch_thread):
    """jm_tpu's parse of sp1 (its SP marks included) through
    picture_from_numpy and the port's reconstruction and deblock."""
    data = (GOLDEN / "sp1.264").read_bytes()
    jm_pics = []

    class Capture(jm_decoder.H264Decoder):
        def _finish_picture(self):
            if self._cur is not None:
                jm_pics.append(self._cur["pic"])
            super()._finish_picture()

    want = Capture().decode_annexb(data)

    class FromJm(port_decoder.H264Decoder):
        def _finish_picture(self):
            if self._cur is not None:
                self._cur["pic"] = picture_from_numpy(jm_pics.pop(0))
            super()._finish_picture()

    assert _yuv(FromJm(device="cpu").decode_annexb(data)) == _yuv(want)
    assert not jm_pics


def test_cif_sp_matches_ldecod_sha256(one_torch_thread):
    data = (GOLDEN / "cif_sp.264").read_bytes()
    out = H264Decoder(device="cpu").decode_annexb(data)
    assert len(out) == 30
    assert hashlib.sha256(_yuv(out)).hexdigest() == CIF_SP_SHA


def test_si_slice_raises():
    """An SI slice (slice_type 4, written by the port's header writer
    under sp1's parameter sets) raises naming SI, as jm_tpu parses none
    (jm_tpu/decoder/mb_parse.py:700)."""
    units = list(split_annexb((GOLDEN / "sp1.264").read_bytes()))
    sps = parse_sps(units[0].rbsp)
    pps = parse_pps(units[1].rbsp, {sps.seq_parameter_set_id: sps})
    bw = BitWriter()
    write_slice_header(bw, sps, pps, slice_type=SliceType.SI, frame_num=0,
                       idr=True, qp=28)
    bw.rbsp_trailing_bits()
    data = b"".join(annexb_bytes(u.nal_ref_idc, u.nal_unit_type, u.rbsp)
                    for u in units[:2]) + \
        annexb_bytes(3, NalUnitType.IDR, bw.get_bytes())
    with pytest.raises(NotImplementedError, match="SI slices"):
        H264Decoder(device="cpu").decode_annexb(data)


def test_cabac_sp_raises():
    """SP slices under CABAC (the port's encoder writes them as jm_tpu's
    does) raise in both decoders."""
    enc = Encoder(EncoderConfig(width=32, height=32, entropy="cabac",
                                sp_periodicity=1, pipeline="host"),
                  device="cpu")
    data = b"".join(enc.encode_frame(*f) for f in make_frames(32, 32, 2))
    with pytest.raises(NotImplementedError, match="SP slices under CABAC"):
        H264Decoder(device="cpu").decode_annexb(data)
    with pytest.raises(NotImplementedError):
        jm_decoder.H264Decoder().decode_annexb(data)


@pytest.mark.parametrize("seed,frac", [(20, 1.0), (21, 0.5)])
def test_sp_deblock_matches_jm_and_kernel_schedule(seed, frac):
    """On the bS of SP MBs (all, or half of them; every edge filtered
    there) the plain deblock equals jm_tpu's host deblock_picture, and so
    does every order of the kernels' phases that their rule admits
    (tests/test_torch_deblock.py's emulation with the plain tile steps):
    the plain twins that skip bS-0 MBs stay equal to K1 / K2's data flow."""
    from jm_tpu.ops.deblock import deblock_picture
    from jm_tpu_torch.ops.deblock import deblock_plain
    from test_deblock_jax import random_pic, slice_params
    from test_torch_deblock import _emulate, _phase_order
    mb_w, mb_h = 6, 4
    rng = np.random.default_rng(seed)
    pic = random_pic(rng, mb_w, mb_h)
    pic.sp_slice[:] = rng.random(pic.n_mbs) < frac
    sp = slice_params(pic)
    planes = tuple(rng.integers(0, 256, s, np.uint8) // 20 + 100
                   for s in ((64, 96), (32, 48), (32, 48)))
    qpc = np.array([chroma_qp(q, 0) for q in range(52)], np.int32)
    per_mb = (pic.qp.astype(np.int32), sp["disable_idc"], sp["alpha_off"],
              sp["beta_off"], sp["slice_id"],
              pic.transform8x8.astype(np.int32))
    bs = compute_bs(_t(pic.mb_class), _t(pic.luma_nnz),
                    _t(pic.transform8x8.astype(np.int32)), _t(pic.mv),
                    _t(pic.mv_l1), _t(pic.ref_pic_id), _t(pic.ref_pic_id_l1),
                    mb_w, mb_h, sp_slice=_t(pic.sp_slice))
    plain = [g.numpy() for g in deblock_plain(
        *(_t(p) for p in planes), *bs, *(_t(a) for a in per_mb), _t(qpc),
        _t(qpc), mb_w=mb_w, mb_h=mb_h)]
    want = [p.copy() for p in planes]
    deblock_picture(*want, pic, mb_w, mb_h, pic.qp, sp)
    for g, w in zip(plain, want):
        assert np.array_equal(g, w)
    assert not np.array_equal(plain[0], planes[0])
    args = (planes, [b.numpy() for b in bs], per_mb, qpc, qpc, mb_w, mb_h)
    for order in (_phase_order(mb_w, mb_h),
                  _phase_order(mb_w, mb_h, np.random.default_rng(seed))):
        for g, p in zip(_emulate(*args, order), plain):
            assert np.array_equal(g, p)
