"""The port's 4:2:2 decode (High 4:2:2, chroma_format_idc 2) against
jm_tpu's on the CPU, exactly (the codec is integer-exact: the tolerance
is zero):
- the goldens y422 (CABAC I/P/B with the 8x8 transform) and y422c (CAVLC
  IPP): the port's decode against JM ldecod's output (_rec.yuv, in POC
  order) and against jm_tpu's; every picture's parse field by field, its
  planes before the deblock (the port's device inter recon, ops/dec at
  crows 4, with the host intra fill, against jm_tpu's host
  Reconstructor, which reconstructs every 4:2:2 picture) and the plain
  deblock of jm_tpu's pre-deblock planes against its deblock_picture;
  the CAVLC I / P slices take the Python parser, counted under
  native.routes["yuv422"];
- cif_422 (30 CIF frames, CABAC I/P/B, 8x8 transform, scaling lists)
  against the sha256 of ldecod's output that tests/test_cif_conformance.py
  records;
- the residual stage (decoder/recon.decode_residuals and ops/dec
  .p_dec_residuals: the 2x4 chroma DC at QPc + 3) against jm_tpu's numpy
  decode_residuals on seeded levels;
- the 4:2:2 chroma deblock (ops/deblock.deblock_chroma_plain at 16 lines
  per MB, the plain twin of K2-422) against jm_tpu/ops/deblock
  .deblock_picture (numpy, force_numpy=True) on random pictures with 8x8
  MBs, disable_deblocking_filter_idc 0 / 1 / 2 and filter offsets; and
  K2-422's row-progress schedule emulated MB by MB and phase by phase
  with the plain tile steps at 16 chroma lines (the kernel runs only on
  the card: chip_smoke.py holds it against the twin);
- what stays out of scope raises: an I_PCM MB of a 4:2:2 picture (as in
  jm_tpu, whose encoder writes such MBs: tests/test_torch_y422_encode.py)
  and chroma_format_idc 0 and 3."""

import hashlib
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from jm_tpu.common.tables import chroma_qp
from jm_tpu.decoder import decoder as jm_decoder
from jm_tpu.decoder.mb_parse import PictureData as JPictureData
from jm_tpu.decoder.recon import decode_residuals as jm_decode_residuals
from jm_tpu.ops.deblock import compute_bs as jm_compute_bs
from jm_tpu.ops.deblock import deblock_picture as jm_deblock_picture
from jm_tpu_torch import native as N
from jm_tpu_torch.bitstream.bitwriter import BitWriter
from jm_tpu_torch.bitstream.nal import NalUnitType, annexb_bytes
from jm_tpu_torch.common.types import PPS, SliceType
from jm_tpu_torch.convert import picture_from_numpy, qpc_tables
from jm_tpu_torch.decoder import decoder as port_decoder
from jm_tpu_torch.decoder.decoder import H264Decoder
from jm_tpu_torch.decoder.recon import build_inv_scale, decode_residuals
from jm_tpu_torch.encoder.syntax import write_pps
from jm_tpu_torch.ops import dec
from jm_tpu_torch.ops.deblock import (MbParams, chroma_horizontal,
                                      chroma_vertical, deblock_chroma_plain)

from test_deblock_jax import random_pic, slice_params
from test_torch_deblock import _mb_order, _phase_order
from torch_streams import one_torch_thread  # noqa: F401

GOLDEN = Path(__file__).parent / "golden"
GOLDENS = ["y422", "y422c"]
# tests/test_cif_conformance.py VECTORS["cif_422"]
CIF_422_SHA = ("1b12ba64b1981f0edb4705ee4d3daf4bdde030e0877fb77b5dc0"
               "64198d75d2a3")
PIC_FIELDS = ("mb_class", "skip", "transform8x8", "i4_modes", "i16_mode",
              "chroma_mode", "cbp", "qp", "luma_coef", "luma_dc",
              "luma_coef8", "chroma_dc", "chroma_coef", "luma_nnz",
              "chroma_nnz", "mv", "ref_idx", "mv_l1", "ref_idx_l1", "pdir")


def _yuv(frames):
    return np.concatenate([np.concatenate([f.Y.ravel(), f.U.ravel(),
                                           f.V.ravel()]) for f in frames])


class _JmCapture(jm_decoder.H264Decoder):
    def __init__(self):
        super().__init__(device_recon=True)
        self.recs = []

    def _finish_picture(self):
        cur = self._cur
        if cur is not None and cur["headers"]:
            self.recs.append({"pic": cur["pic"]})
        super()._finish_picture()


class _PortCapture(port_decoder.H264Decoder):
    def __init__(self):
        super().__init__(device="cpu")
        self.recs = []

    def _finish_picture(self):
        if self._cur is not None:
            self.recs.append({"pic": self._cur["pic"],
                              "type": self._cur["hdr0"].slice_type})
        super()._finish_picture()


@pytest.fixture(scope="module")
def goldens():
    """Per golden: (jm_tpu's frames, its pictures with the planes before
    and after deblock_picture, the port's frames, its pictures with the
    planes before the deblock and the deblock's arguments, the routes of
    the port's decode)."""
    cache = {}

    def get(name):
        if name in cache:
            return cache[name]
        data = (GOLDEN / f"{name}.264").read_bytes()
        jm = _JmCapture()

        def spy(Y, U, V, *a, **k):
            jm.recs[-1]["pre"] = (Y.copy(), U.copy(), V.copy())
            jm_deblock_picture(Y, U, V, *a, **k)
            jm.recs[-1]["post"] = (Y.copy(), U.copy(), V.copy())

        with mock.patch.object(jm_decoder, "deblock_picture", spy):
            jm_frames = jm.decode_annexb(data)
        port = _PortCapture()
        orig = port_decoder.deblock

        def port_spy(Y, U, V, *a, **k):
            port.recs[-1]["pre"] = tuple(p.numpy().copy() for p in (Y, U, V))
            port.recs[-1]["args"] = (a, k)
            return orig(Y, U, V, *a, **k)

        N.reset_routes()
        with mock.patch.object(port_decoder, "deblock", port_spy):
            frames = port.decode_annexb(data)
        routes = {k: dict(v) for k, v in N.routes.items()}
        assert len(jm.recs) == len(port.recs)
        cache[name] = (jm_frames, jm.recs, frames, port.recs, routes)
        return cache[name]

    return get


@pytest.mark.parametrize("name", GOLDENS)
def test_golden_decodes_like_ldecod_and_jm(name, goldens):
    jm_frames, _, frames, recs, routes = goldens(name)
    assert frames[0].U.shape == (144, 88)
    want = np.fromfile(GOLDEN / f"{name}_rec.yuv", np.uint8)
    got = _yuv(sorted(frames, key=lambda f: f.poc))
    assert got.size == want.size and np.array_equal(got, want)
    assert len(frames) == len(jm_frames)
    for i, (a, b) in enumerate(zip(frames, jm_frames)):
        assert a.poc == b.poc
        for p in "YUV":
            assert np.array_equal(getattr(a, p), getattr(b, p)), \
                f"frame {i} plane {p}"
    n_cavlc_ip = sum(r["type"] != SliceType.B for r in recs) \
        if name == "y422c" else 0
    assert routes["yuv422"]["parse"] == n_cavlc_ip
    assert routes["parse"] == {"native": 0, "python": 0, "rerun": 0}


@pytest.mark.parametrize("name", GOLDENS)
def test_golden_parse_and_recon_match_jm(name, goldens):
    """Every picture's parsed state field by field, its planes before the
    deblock (device inter recon at crows 4 with the host intra fill
    against jm_tpu's host Reconstructor) and the plain deblock of jm_tpu's
    pre-deblock planes against deblock_picture; P and B pictures with
    inter MBs are among them."""
    _, jm_recs, _, port_recs, _ = goldens(name)
    kinds = set()
    for i, (j, p) in enumerate(zip(jm_recs, port_recs)):
        for k in PIC_FIELDS:
            assert np.array_equal(getattr(p["pic"], k),
                                  getattr(j["pic"], k)), \
                f"picture {i} field {k}"
        for k, plane in enumerate("YUV"):
            assert np.array_equal(p["pre"][k], j["pre"][k]), \
                f"picture {i} plane {plane} before the deblock"
        (bs_v, bs_h, *rest), kw = p["args"]
        jp = j["pic"]
        want_v, want_h = jm_compute_bs(jp, jp.mb_w, jp.mb_h)
        assert np.array_equal(bs_v.numpy(), want_v)
        assert np.array_equal(bs_h.numpy(), want_h)
        out = port_decoder.deblock(
            *(torch.from_numpy(x) for x in j["pre"]), bs_v, bs_h, *rest,
            **kw)
        for k, plane in enumerate("YUV"):
            assert np.array_equal(out[k].numpy(), j["post"][k]), \
                f"picture {i} plane {plane} after the deblock"
        kinds.add((p["type"], bool((p["pic"].mb_class == 0).any())))
    assert (SliceType.P, True) in kinds


def test_cif_422_matches_the_recorded_sha256():
    """30 CIF 4:2:2 frames (CABAC I/P/B, 8x8 transform, scaling lists):
    the sha256 of the port's output equals that of ldecod's."""
    data = (GOLDEN / "cif_422.264").read_bytes()
    frames = sorted(H264Decoder(device="cpu").decode_annexb(data),
                    key=lambda f: f.poc)
    assert len(frames) == 30
    out = b"".join(f.Y.tobytes() + f.U.tobytes() + f.V.tobytes()
                   for f in frames)
    assert len(out) == 6082560
    assert hashlib.sha256(out).hexdigest() == CIF_422_SHA


# ---- the residual stage -------------------------------------------------

def _levels(seed, mb_w=3, mb_h=2):
    """jm_tpu's 4:2:2 PictureData with seeded levels (inter and intra MBs,
    every QP range) and the same state as the port's."""
    rng = np.random.default_rng(seed)
    jp = JPictureData(mb_w, mb_h, chroma_format_idc=2)
    n = jp.n_mbs
    jp.mb_class[:] = rng.integers(0, 2, n)
    jp.qp[:] = rng.integers(0, 52, n)
    jp.luma_coef[:] = rng.integers(-6, 7, (n, 16, 16)) \
        * (rng.random((n, 16, 16)) < 0.3)
    jp.chroma_dc[:] = rng.integers(-40, 41, (n, 2, 8))
    jp.chroma_coef[:] = rng.integers(-6, 7, (n, 2, 8, 16)) \
        * (rng.random((n, 2, 8, 16)) < 0.3)
    jp.chroma_coef[..., 0] = 0
    return jp, picture_from_numpy(jp)


@pytest.mark.parametrize("seed,offsets", [(0, (0, 0)), (1, (-3, 5)),
                                          (2, (4, -2))])
def test_residuals_match_jm(seed, offsets):
    """decode_residuals (host) and ops/dec.p_dec_residuals (the device
    stage, inter lists) at crows 4 against jm_tpu's numpy twin, flat
    (seed 0) or with seeded scaling lists."""
    jp, pp = _levels(seed)
    pps = PPS(chroma_qp_index_offset=offsets[0],
              second_chroma_qp_index_offset=offsets[1])
    rng = np.random.default_rng(seed + 10)
    pps.scaling_list_4x4 = [[16] * 16 if seed == 0 else
                            rng.integers(4, 64, 16).tolist()
                            for _ in range(6)]
    pps.scaling_list_8x8 = [[16] * 64 for _ in range(6)]
    want_l, want_c = jm_decode_residuals(jp, pps)
    got_l, got_c = decode_residuals(pp, pps)
    assert got_c.shape == (jp.n_mbs, 2, 8, 4, 4)
    assert np.array_equal(got_l, want_l) and np.array_equal(got_c, want_c)
    jp.mb_class[:] = 0                      # the device stage: inter MBs
    want_l, want_c = jm_decode_residuals(jp, pps)
    tab = build_inv_scale(pps)
    t = torch.from_numpy
    res_l, res_c = dec.p_dec_residuals(
        t(pp.luma_coef), t(pp.chroma_dc), t(pp.chroma_coef), t(pp.qp),
        *(t(tab[i]) for i in (3, 4, 5)), *qpc_tables(pps),
        mb_w=pp.mb_w, mb_h=pp.mb_h)
    assert np.array_equal(res_l.numpy(), want_l)
    assert np.array_equal(res_c.numpy(), want_c)


# ---- the 4:2:2 chroma deblock and K2-422's schedule -----------------------

CHROMA_CASES = [
    (5, 4, 0, {"t8_frac": 0.5}, {}),
    (5, 4, 1, {"intra_frac": 1.0, "t8_frac": 0.6}, {}),
    (5, 4, 2, {"multi_ref": True}, {"disable": 2, "a_off": 2, "b_off": -1}),
    (4, 3, 3, {"t8_frac": 0.4}, {"disable": 1}),
    (5, 4, 4, {"intra_frac": 0.0}, {"a_off": -3, "b_off": 4}),
    (1, 3, 5, {}, {}),
    (4, 1, 6, {"t8_frac": 0.5}, {}),
]


def _chroma_case(mb_w, mb_h, seed, kw, skw):
    """A random 4:2:2 picture for jm_tpu (n_crows 4), low-amplitude
    chroma so that the filters fire, the bS from jm_tpu's compute_bs, and
    the port's arguments."""
    rng = np.random.default_rng(seed)
    pic = random_pic(rng, mb_w, mb_h, **kw)
    pic.n_crows = 4
    if skw.get("disable") == 2:
        pic.slice_id[pic.n_mbs // 2:] = 1
    sp = slice_params(pic, **skw)
    H, W = 16 * mb_h, 16 * mb_w
    planes = [rng.integers(0, 256, (H, W), np.uint8)] + [
        (rng.integers(0, 256, (H, W // 2), np.uint8) // 20 + 100)
        .astype(np.uint8) for _ in range(2)]
    bs = jm_compute_bs(pic, mb_w, mb_h)
    qpc = np.array([chroma_qp(q, 0) for q in range(52)], np.int32)
    per_mb = (pic.qp.astype(np.int32), sp["disable_idc"], sp["alpha_off"],
              sp["beta_off"], sp["slice_id"],
              pic.transform8x8.astype(np.int32))
    return pic, sp, planes, bs, per_mb, qpc


@pytest.mark.parametrize("mb_w,mb_h,seed,kw,skw", CHROMA_CASES)
def test_chroma_twin_matches_jm_deblock_picture(mb_w, mb_h, seed, kw, skw):
    pic, sp, planes, bs, per_mb, qpc = _chroma_case(mb_w, mb_h, seed, kw,
                                                    skw)
    want = [p.copy() for p in planes]
    jm_deblock_picture(*want, pic, mb_w, mb_h, pic.qp, sp, force_numpy=True)
    t = torch.from_numpy
    got = deblock_chroma_plain(
        t(planes[1]), t(planes[2]), t(bs[0].astype(np.int8)),
        t(bs[1].astype(np.int8)), *(t(a) for a in per_mb), t(qpc), t(qpc),
        mb_w=mb_w, mb_h=mb_h)
    for g, w, p in zip(got, want[1:], planes[1:]):
        assert np.array_equal(g.numpy(), w)
    if skw.get("disable") != 1:
        assert not np.array_equal(want[1], planes[1])


SENTINEL = -1


def _emulate_chroma(planes, bs, per_mb, qpc, mb_w, mb_h, steps):
    """K2-422's data flow, one step at a time (tests/test_torch_deblock.py
    _emulate at 16 chroma lines per MB): a step filters one MB's vertical
    edges ("v"), horizontal edges ("h") or both ("mb") on a tile of the MB
    and the 4 samples left of and above it, the interior from the input
    planes ("h": from the output), the fringes from the output planes,
    which start as SENTINEL; asserts that no step read a SENTINEL."""
    src = [torch.from_numpy(p).to(torch.int32) for p in planes]
    out = [torch.zeros((16 * mb_h + 4, 8 * mb_w + 4), dtype=torch.int32)
           for _ in range(2)]
    for o in out:
        o[4:, 4:] = SENTINEL
    mp = MbParams(*(torch.from_numpy(a) for a in per_mb), mb_w, mb_h)
    bs_v, bs_h = (torch.from_numpy(np.array(b, np.int8)) for b in bs)
    tab = torch.from_numpy(qpc)
    for kind, b, c in steps:
        ln, bv, bh = mp.lanes(torch.tensor([b]), torch.tensor([c]),
                              bs_v, bs_h)
        tiles = []
        for o, p in zip(out, src):
            y, x = 16 * b, 8 * c
            tile = torch.zeros((20, 12), dtype=torch.int32)
            if kind != "h":
                tile[4:, :4] = o[y + 4:y + 20, x:x + 4]
            if kind != "v":
                tile[:4, 4:] = o[y:y + 4, x + 4:x + 12]
            tile[4:, 4:] = o[y + 4:y + 20, x + 4:x + 12] if kind == "h" \
                else p[y:y + 16, x:x + 8]
            assert not (tile == SENTINEL).any(), f"{kind} ({b}, {c})"
            tiles.append(tile)
        ct = torch.stack(tiles)[None]
        if kind != "h":
            chroma_vertical(ct, ln, bv, tab, tab)
        if kind != "v":
            chroma_horizontal(ct, ln, bh, tab, tab)
        for o, tile in zip(out, ct[0]):
            y, x = 16 * b, 8 * c
            if kind != "h":
                o[y + 4:y + 20, x:x + 4] = tile[4:, :4]
            if kind != "v":
                o[y:y + 4, x + 4:x + 12] = tile[:4, 4:]
            o[y + 4:y + 20, x + 4:x + 12] = tile[4:, 4:]
    assert not any((o == SENTINEL).any() for o in out)
    return [o[4:, 4:].to(torch.uint8).numpy() for o in out]


SCHEDULE_CASES = [c for c in CHROMA_CASES if c[0] >= 2 and c[1] >= 2]


@pytest.mark.parametrize("mb_w,mb_h,seed,kw,skw", SCHEDULE_CASES)
def test_k2_422_schedule_matches_wavefront(mb_w, mb_h, seed, kw, skw):
    """Every order of whole MBs that progress[b-1] >= min(c + 2, mb_w)
    admits, and every order of K2-422's phases (vertical edges of (b, c)
    after (b, c-1); horizontal edges once MB (b-1, c) is final, its right
    fringe rewritten by (b-1, c+1)'s left edge), gives the plain twin's
    planes at 16 chroma lines per MB; counting an MB final before that
    rewrite admits an order that gives other planes."""
    _, _, planes, bs, per_mb, qpc = _chroma_case(mb_w, mb_h, seed, kw, skw)
    t = torch.from_numpy
    plain = [g.numpy() for g in deblock_chroma_plain(
        t(planes[1]), t(planes[2]), t(bs[0].astype(np.int8)),
        t(bs[1].astype(np.int8)), *(t(a) for a in per_mb), t(qpc), t(qpc),
        mb_w=mb_w, mb_h=mb_h)]
    args = (planes[1:], bs, per_mb, qpc, mb_w, mb_h)
    rng = np.random.default_rng(seed)
    orders = [_mb_order(mb_w, mb_h, 2), _mb_order(mb_w, mb_h, 2, rng),
              _phase_order(mb_w, mb_h), _phase_order(mb_w, mb_h, rng),
              _phase_order(mb_w, mb_h, rng)]
    for order in orders:
        for g, p in zip(_emulate_chroma(*args, order), plain):
            assert np.array_equal(g, p)
    if skw.get("disable") != 1:
        early = _emulate_chroma(*args, _phase_order(mb_w, mb_h,
                                                    fringe=False))
        assert any(not np.array_equal(g, p) for g, p in zip(early, plain))


# ---- out of scope -------------------------------------------------------

def test_ipcm_at_422_raises():
    """An I_PCM MB of a 4:2:2 picture raises, in both parsers, as in
    jm_tpu (its encoder writes them; ROADMAP Queue 3)."""
    from jm_tpu.encoder.encoder import Encoder as JEncoder
    from jm_tpu.encoder.encoder import EncoderConfig as JEncoderConfig
    from test_y422_encode import _seq422
    for entropy in ("cavlc", "cabac"):
        enc = JEncoder(JEncoderConfig(width=32, height=32, qp=29,
                                      chroma_format=2, enable_ipcm=2,
                                      entropy=entropy))
        data = enc.encode_frame(*_seq422(1, 32, 32)[0])
        with pytest.raises(NotImplementedError, match="I_PCM at "
                           "chroma_format_idc 2"):
            H264Decoder(device="cpu").decode_annexb(data)


@pytest.mark.parametrize("cfi", [0, 3])
def test_other_chroma_formats_raise(cfi):
    """A hand-made High 4:4:4 / 4:0:0 SPS (profile 244 / 100) and its
    PPS: the first slice header names the chroma format."""
    sps_bits = BitWriter()
    sps_bits.u(244 if cfi == 3 else 100, 8)
    sps_bits.u(0, 8)
    sps_bits.u(30, 8)
    sps_bits.ue(0)                      # seq_parameter_set_id
    sps_bits.ue(cfi)
    if cfi == 3:
        sps_bits.flag(0)                # separate_colour_plane_flag
    sps_bits.ue(0)                      # bit_depth_luma_minus8
    sps_bits.ue(0)                      # bit_depth_chroma_minus8
    sps_bits.flag(0)                    # qpprime_y_zero_transform_bypass
    sps_bits.flag(0)                    # seq_scaling_matrix_present_flag
    for v in (0, 0, 4, 1):              # log2_max_frame_num_minus4, POC
        sps_bits.ue(v)                  # type 0 and its lsb, 1 reference
    sps_bits.flag(0)                    # gaps_in_frame_num_value_allowed
    sps_bits.ue(1)                      # 2 MBs wide
    sps_bits.ue(1)                      # 2 MBs high
    sps_bits.flag(1)                    # frame_mbs_only_flag
    sps_bits.flag(1)                    # direct_8x8_inference_flag
    sps_bits.flag(0)                    # frame_cropping_flag
    sps_bits.flag(0)                    # vui_parameters_present_flag
    sps_bits.rbsp_trailing_bits()
    sl = BitWriter()
    sl.ue(0)                            # first_mb_in_slice
    sl.ue(7)                            # slice_type I
    sl.ue(0)                            # pic_parameter_set_id
    sl.rbsp_trailing_bits()
    data = (annexb_bytes(3, NalUnitType.SPS, sps_bits.get_bytes())
            + annexb_bytes(3, NalUnitType.PPS, write_pps(PPS()))
            + annexb_bytes(3, NalUnitType.IDR, sl.get_bytes()))
    with pytest.raises(NotImplementedError,
                       match=f"chroma_format_idc {cfi}"):
        H264Decoder(device="cpu").decode_annexb(data)
