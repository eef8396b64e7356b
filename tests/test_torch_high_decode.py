"""The port's High-profile decoder against jm_tpu's on the CPU, exactly
(the codec is integer-exact: the tolerance is zero):
- the goldens high8x8 (CABAC), high8x8c (CAVLC) and high8x8sm (scaling
  matrices, CABAC), QCIF I/P/B with the 8x8 transform and Intra8x8: the
  port's decode against JM ldecod's output (_rec.yuv, in POC order); the
  decode on the native parse and intra recon against the decode on the
  Python twins (every PictureData array, every frame) and against
  jm_tpu's (the parsed arrays, the frames), with the route of every
  slice counted; the SPS, PPS and slice headers field by field;
- the scaling-list fall-back rules A and B and the default-list flag on
  hand-made SPS / PPS bits, against jm_tpu's parse and the spec's
  tables;
- the 8x8 residual decode: decoder/recon.decode_residuals (intra and
  inter MBs) and the device stage ops/dec.p_dec_residuals (inter MBs)
  with the 8x8 transform and scaling lists, against jm_tpu's numpy
  decode_residuals on seeded levels;
- Intra8x8 prediction (the 9 modes under every availability) against
  jm_tpu's predict_i8."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from jm_tpu.bitstream.nal import split_annexb as jm_split
from jm_tpu.common.types import PPS as JPPS
from jm_tpu.decoder.header import parse_slice_header as jm_slice_header
from jm_tpu.decoder.mb_parse import PictureData as JPictureData
from jm_tpu.decoder.parset import parse_pps as jm_pps
from jm_tpu.decoder.parset import parse_sps as jm_sps
from jm_tpu.decoder.recon import decode_residuals as jm_decode_residuals
from jm_tpu.ops.intra import predict_i8 as jm_predict_i8
from jm_tpu_torch.bitstream.bitwriter import BitWriter
from jm_tpu_torch.bitstream.nal import split_annexb
from jm_tpu_torch.common.picture import PictureData
from jm_tpu_torch.common.types import PPS, SPS, SliceHeader
from jm_tpu_torch.convert import qpc_tables
from jm_tpu_torch.decoder import parset as P
from jm_tpu_torch.decoder.header import parse_slice_header
from jm_tpu_torch.decoder.intra_pred import predict_i8
from jm_tpu_torch.decoder.recon import (build_inv_scale, build_inv_scale8,
                                        decode_residuals)
from jm_tpu_torch.ops import dec

from test_torch_native import _Capture, _check_decode
from torch_streams import one_torch_thread  # noqa: F401

GOLDEN = Path(__file__).parent / "golden"
HIGH = ["high8x8", "high8x8c", "high8x8sm"]


def _yuv_frames(frames):
    return np.concatenate([np.concatenate([f.Y.ravel(), f.U.ravel(),
                                           f.V.ravel()]) for f in frames])


@pytest.mark.parametrize("name", HIGH)
def test_high_golden_decodes_like_ldecod(name):
    data = (GOLDEN / f"{name}.264").read_bytes()
    dec_ = _Capture()
    out = dec_.decode_annexb(data)
    want = np.fromfile(GOLDEN / f"{name}_rec.yuv", np.uint8)
    got = _yuv_frames(sorted(out, key=lambda f: f.poc))
    assert got.size == want.size and np.array_equal(got, want)
    # the goldens hold Intra8x8 MBs and 8x8 inter MBs
    for cls in (0, 1):
        assert sum(int(((p.mb_class == cls) & p.transform8x8).sum())
                   for p in dec_.pics) > 0


@pytest.mark.parametrize("name", HIGH)
def test_high_golden_native_parse_and_recon(name, monkeypatch):
    """The decode on the native CAVLC 8x8 parse and the native Intra8x8
    recon against the decode on the Python parsers and walk and against
    jm_tpu's (test_torch_native._check_decode); every CAVLC I / P slice
    takes the native parser, every B slice the Python one."""
    data = (GOLDEN / f"{name}.264").read_bytes()
    routes = _check_decode(data, monkeypatch)
    n_slices = sum(u.nal_unit_type in (1, 5) for u in split_annexb(data))
    assert routes["recon"]["native"] >= 1 and routes["recon"]["python"] == 0
    if routes["cabac"]["native"]:               # a CABAC stream
        assert routes["cabac"]["native"] == n_slices
    else:
        assert routes["parse"]["python"] == routes["parse"]["rerun"] == 0
        assert routes["parse"]["native"] >= 2
        assert routes["parse"]["native"] + routes["b"]["parse"] == n_slices


@pytest.mark.parametrize("name", HIGH)
def test_high_headers_match_jm(name):
    data = (GOLDEN / f"{name}.264").read_bytes()
    sps_f = [f.name for f in dataclasses.fields(SPS) if f.name != "vui"]
    hdr_f = [f.name for f in dataclasses.fields(SliceHeader)
             if not f.name.startswith(("ref_pic_list_mod", "mmco"))]
    sm, pm, jsm, jpm = {}, {}, {}, {}
    for u, ju in zip(split_annexb(data), jm_split(data)):
        if u.nal_unit_type == 7:
            s, js = P.parse_sps(u.rbsp), jm_sps(ju.rbsp)
            assert {k: getattr(s, k) for k in sps_f} == \
                {k: getattr(js, k) for k in sps_f}
            sm[0], jsm[0] = s, js
        elif u.nal_unit_type == 8:
            p, jp = P.parse_pps(u.rbsp, sm), jm_pps(ju.rbsp, jsm)
            assert dataclasses.asdict(p) == dataclasses.asdict(jp)
            pm[p.pic_parameter_set_id] = p
            jpm[jp.pic_parameter_set_id] = jp
        elif u.nal_unit_type in (1, 5):
            (h, br), (jh, jbr) = parse_slice_header(u, sm, pm), \
                jm_slice_header(ju, jsm, jpm)
            assert {k: getattr(h, k) for k in hdr_f} == \
                {k: getattr(jh, k) for k in hdr_f}
            assert br.pos == jbr.pos
    assert pm[0].transform_8x8_mode_flag == 1


# ---- scaling lists -----------------------------------------------------

def _scaling_list(bw, lst):
    """scaling_list() bits of a zig-zag list; a list starting with 0
    selects the default list and ends there."""
    last = 8
    for v in lst:
        d = (v - last) % 256
        bw.se(d - 256 if d > 127 else d)
        if v == 0:
            return
        last = v


def _lists(bw, lists, n):
    for i in range(n):
        bw.flag(lists.get(i) is not None)
        if lists.get(i) is not None:
            _scaling_list(bw, lists[i])


def _sps_bits(lists):
    """A High 4:2:0 SPS with seq_scaling_matrix_present_flag and the given
    lists (index -> zig-zag list; absent otherwise), or without a matrix
    when lists is None."""
    bw = BitWriter()
    bw.u(100, 8)
    bw.u(0, 8)
    bw.u(30, 8)
    for v in (0, 1, 0, 0):          # sps id, chroma_format_idc, bit depths
        bw.ue(v)
    bw.flag(0)                      # qpprime_y_zero_transform_bypass
    bw.flag(lists is not None)
    if lists is not None:
        _lists(bw, lists, 8)
    for v in (0, 0, 0, 1):          # frame_num / POC bits, POC type, refs
        bw.ue(v)
    bw.flag(0)
    bw.ue(1)
    bw.ue(1)
    for v in (1, 1, 0, 0):          # frame_mbs_only, direct_8x8, crop, vui
        bw.flag(v)
    bw.rbsp_trailing_bits()
    return bw.get_bytes()


def _pps_bits(lists, t8=1):
    bw = BitWriter()
    for v in (0, 0):
        bw.ue(v)
    bw.flag(0)
    bw.flag(0)
    for v in (0, 0, 0):
        bw.ue(v)
    bw.flag(0)
    bw.u(0, 2)
    for v in (0, 0, 0):
        bw.se(v)
    for v in (0, 0, 0):
        bw.flag(v)
    bw.flag(t8)
    bw.flag(lists is not None)
    if lists is not None:
        _lists(bw, lists, 6 + 2 * t8)
    bw.se(0)
    bw.rbsp_trailing_bits()
    return bw.get_bytes()


_RNG = np.random.default_rng(21)
R16 = [[int(v) for v in _RNG.integers(1, 256, 16)] for _ in range(4)]
R64 = [[int(v) for v in _RNG.integers(1, 256, 64)] for _ in range(3)]
D4I, D4P = P.DEFAULT_4x4_INTRA, P.DEFAULT_4x4_INTER
D8I, D8P = P.DEFAULT_8x8_INTRA, P.DEFAULT_8x8_INTER

# (SPS lists or None, PPS lists or None, the resolved PPS 4x4 lists, the
# resolved PPS 8x8 lists 0 / 1)
FALLBACK_CASES = {
    # rule A: every absent SPS list falls to a default or to the list
    # before it of its kind
    "sps_all_absent": ({}, None, [D4I] * 3 + [D4P] * 3, [D8I, D8P]),
    "sps_chain": ({0: R16[0], 4: R16[1], 6: [0]}, None,
                  [R16[0]] * 3 + [D4P, R16[1], R16[1]], [D8I, D8P]),
    "sps_use_default": ({0: [0], 3: R16[2], 7: R64[0]}, None,
                        [D4I] * 3 + [R16[2]] * 3, [D8I, R64[0]]),
    # rule B: an absent PPS list 0 / 3 / 6 / 7 takes the SPS's
    "pps_rule_b": ({0: R16[0], 3: R16[1], 6: R64[0], 7: R64[1]},
                   {1: R16[2], 4: [0], 7: R64[2]},
                   [R16[0], R16[2], R16[2], R16[1], D4P, D4P],
                   [R64[0], R64[2]]),
    # a PPS of an SPS without a matrix falls back by rule A
    "pps_rule_a": (None, {2: R16[3], 6: R64[1]},
                   [D4I, D4I, R16[3], D4P, D4P, D4P], [R64[1], D8P]),
}


@pytest.mark.parametrize("case", list(FALLBACK_CASES))
def test_scaling_list_fallback(case):
    sps_l, pps_l, want4, want8 = FALLBACK_CASES[case]
    sps_rbsp, pps_rbsp = _sps_bits(sps_l), _pps_bits(pps_l)
    s, js = P.parse_sps(sps_rbsp), jm_sps(sps_rbsp)
    assert s.seq_scaling_matrix_present_flag == int(sps_l is not None)
    assert s.scaling_list_4x4 == js.scaling_list_4x4
    assert s.scaling_list_8x8 == js.scaling_list_8x8
    p, jp = P.parse_pps(pps_rbsp, {0: s}), jm_pps(pps_rbsp, {0: js})
    assert dataclasses.asdict(p) == dataclasses.asdict(jp)
    assert p.scaling_list_4x4 == [list(x) for x in want4]
    assert p.scaling_list_8x8[:2] == [list(x) for x in want8]


# ---- the 8x8 residual decode --------------------------------------------

MB_W, MB_H = 4, 3
N_MB = MB_W * MB_H


def _random_pps(rng, flat: bool):
    """A port PPS and its jm_tpu twin with flat or seeded scaling lists
    (zig-zag order) and seeded chroma offsets."""
    l4 = [[16] * 16 if flat else [int(v) for v in rng.integers(1, 256, 16)]
          for _ in range(6)]
    l8 = [[16] * 64 if flat else [int(v) for v in rng.integers(1, 256, 64)]
          for _ in range(6)]
    cb, cr = (int(v) for v in rng.integers(-6, 7, 2))
    kw = dict(chroma_qp_index_offset=cb, second_chroma_qp_index_offset=cr,
              transform_8x8_mode_flag=1, scaling_list_4x4=l4,
              scaling_list_8x8=l8)
    return PPS(**kw), JPPS(**kw)


def _random_picture(rng, lev_max: int, intra_frac: float):
    """Seeded levels of a picture whose MBs are inter or I_NxN, about half
    with the 8x8 transform; the same arrays in a port and a jm_tpu
    PictureData."""
    pics = PictureData(MB_W, MB_H), JPictureData(MB_W, MB_H)
    n = N_MB
    intra = rng.random(n) < intra_frac
    t8 = rng.random(n) < 0.5
    t8[:2] = (True, False)
    vals = {
        "mb_class": np.where(intra, 1, 0).astype(np.int8),
        "transform8x8": t8,
        "qp": rng.integers(0, 52, n).astype(np.int32),
        "luma_coef": rng.integers(-lev_max, lev_max + 1, (n, 16, 16)),
        "luma_coef8": rng.integers(-lev_max, lev_max + 1, (n, 4, 64)),
        "chroma_dc": rng.integers(-lev_max, lev_max + 1, (n, 2, 4)),
        "chroma_coef": rng.integers(-lev_max, lev_max + 1, (n, 2, 4, 16)),
    }
    vals["qp"][:2] = (0, 51)
    for k in ("luma_coef", "luma_coef8"):
        vals[k] = vals[k] * (rng.random(vals[k].shape) < 0.3)
    vals["chroma_coef"][..., 0] = 0
    for pic in pics:
        for k, v in vals.items():
            getattr(pic, k)[:] = v
    return pics


@pytest.mark.parametrize("seed,lev_max,flat", [
    (0, 8, True), (1, 200, False), (2, 2 ** 12, False), (3, 30, True)])
def test_decode_residuals_8x8_matches_jm(seed, lev_max, flat):
    rng = np.random.default_rng(seed)
    pps, jpps = _random_pps(rng, flat)
    pic, jpic = _random_picture(rng, lev_max, 0.4)
    got = decode_residuals(pic, pps)
    want = jm_decode_residuals(jpic, jpps)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed,lev_max,flat", [
    (0, 8, True), (1, 200, False), (2, 2000, True), (3, 30, False)])
def test_p_dec_residuals_8x8_matches_jm(seed, lev_max, flat):
    """The device stage on every inter MB of a picture with 8x8 MBs, at
    levels whose 4x4 dequant fits the int32 of the device's 4x4 path (as
    in a conformant stream; the 8x8 path is int64)."""
    rng = np.random.default_rng(seed)
    pps, jpps = _random_pps(rng, flat)
    pic, jpic = _random_picture(rng, lev_max, 0.0)
    want_l, want_c = jm_decode_residuals(jpic, jpps)
    tab4 = build_inv_scale(pps)
    qcb, qcr = qpc_tables(pps)
    t = torch.as_tensor
    res_l, res_c = dec.p_dec_residuals(
        t(pic.luma_coef), t(pic.chroma_dc), t(pic.chroma_coef), t(pic.qp),
        *(t(tab4[i]) for i in (3, 4, 5)), qcb, qcr, mb_w=MB_W, mb_h=MB_H,
        luma_coef8=t(pic.luma_coef8), transform8x8=t(pic.transform8x8),
        tab8=t(build_inv_scale8(pps)[1]))
    assert res_l.dtype == res_c.dtype == torch.int32
    np.testing.assert_array_equal(res_l.numpy(), want_l)
    np.testing.assert_array_equal(res_c.numpy(), want_c)


@pytest.mark.parametrize("avail", range(8))
def test_predict_i8_matches_jm(avail):
    """The 9 modes (those the availability allows) on seeded samples."""
    rng = np.random.default_rng(avail)
    at, al, ac = bool(avail & 1), bool(avail & 2), bool(avail & 4)
    for _ in range(4):
        top = rng.integers(0, 256, 16).astype(np.int32)
        left = rng.integers(0, 256, 8).astype(np.int32)
        corner = int(rng.integers(0, 256))
        modes = [2] + ([0, 3, 7] if at else []) + ([1, 8] if al else []) \
            + ([4, 5, 6] if at and al and ac else [])
        for m in modes:
            np.testing.assert_array_equal(
                predict_i8(m, top, left, corner, at, al, ac),
                jm_predict_i8(m, top, left, corner, at, al, ac))
