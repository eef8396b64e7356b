"""The port's decoder above 8 bits (High 10, and 9- to 14-bit samples
under a High 4:4:4 Predictive SPS at 4:2:0) against jm_tpu's on the CPU,
exactly (the codec is integer-exact: the tolerance is zero):
- JM's goldens hi10c (CAVLC I P P P P P) and hi10 (CABAC I P B B P B, two
  references): the port's decode against jm_tpu's H264Decoder(
  device_recon=True) and JM ldecod's output (_rec.yuv, uint16, in POC
  order); each picture's parse field by field, and jm_tpu's parse
  through the port's reconstruction and deblock (the FromJm pattern);
- the port encoder's streams under a re-headed SPS
  (torch_streams.reheaded): High 10 at 96x80 (CAVLC and CABAC), 10-bit
  4:2:2 (profile 122), and 14 bits with every slice QP moved below 0
  (CAVLC: under CABAC the slice QP also sets the contexts; with
  basic-unit rate control, so that mb_qp_delta moves the QP), and the
  port's field stream at 10 bits with every slice QP below 0 (field
  pictures take the native parser and QpBdOffsetY as frames do),
  decoded equal in both packages; the native CAVLC parser at 10 and 14
  bits, on frames and on fields, against the Python parser;
- decoder/recon.decode_residuals and ops/dec.p_dec_residuals against
  jm_tpu's decode_residuals(bd=, lossless=) on seeded levels at bit
  depths 8, 10 and 14 with QPs from -QpBdOffsetY to 51;
- the plain deblock twins against jm_tpu's deblock_picture(bd=) at 10
  and 14 bits with negative QPY and chroma QP offsets, at 4:2:0 and
  4:2:2; the >8-bit kernels' row-progress schedule emulated with the
  plain tile steps (as tests/test_torch_deblock.py does at 8 bits);
- what stays out of scope raises."""

from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from jm_tpu.common.types import PPS as JPPS
from jm_tpu.decoder import decoder as jm_decoder
from jm_tpu.decoder.mb_parse import PictureData as JPictureData
from jm_tpu.decoder.recon import decode_residuals as jm_decode_residuals
from jm_tpu.ops.deblock import compute_bs as jm_compute_bs
from jm_tpu.ops.deblock import deblock_picture as jm_deblock_picture
from jm_tpu_torch import native as N
from jm_tpu_torch.common.picture import PictureData
from jm_tpu_torch.common.types import PPS, SPS
from jm_tpu_torch.convert import picture_from_numpy, qpc_tables
from jm_tpu_torch.decoder import decoder as port_decoder
from jm_tpu_torch.decoder import mb_parse
from jm_tpu_torch.decoder.decoder import H264Decoder
from jm_tpu_torch.decoder.header import check_scope
from jm_tpu_torch.decoder.recon import (build_inv_scale, build_inv_scale8,
                                        decode_residuals)
from jm_tpu_torch.encoder.encoder import Encoder, EncoderConfig
from jm_tpu_torch.ops import dec
from jm_tpu_torch.ops.deblock import (MbParams, chroma_horizontal,
                                      chroma_vertical, deblock_plain,
                                      luma_horizontal, luma_vertical)

from test_deblock_jax import random_pic, slice_params
from test_pipe_stream import make_frames
from test_torch_deblock import _mb_order, _phase_order
from torch_streams import one_torch_thread, reheaded  # noqa: F401

GOLDEN = Path(__file__).parent / "golden"
HI10 = ["hi10c", "hi10"]
PIC_FIELDS = ("mb_class", "skip", "transform8x8", "i4_modes", "i16_mode",
              "chroma_mode", "cbp", "qp", "luma_coef", "luma_dc",
              "luma_coef8", "chroma_dc", "chroma_coef", "luma_nnz",
              "chroma_nnz", "mv", "ref_idx", "mv_l1", "ref_idx_l1", "pdir")


class JmCapture(jm_decoder.H264Decoder):
    """jm_tpu's decoder keeping each picture's parsed PictureData."""

    def __init__(self):
        super().__init__(device_recon=True)
        self.pics = []

    def _finish_picture(self):
        if self._cur is not None and self._cur["headers"]:
            self.pics.append(self._cur["pic"])
        super()._finish_picture()


class PortCapture(port_decoder.H264Decoder):
    """The port's decoder keeping each picture's parsed PictureData."""

    def __init__(self):
        super().__init__(device="cpu")
        self.pics = []

    def _finish_picture(self):
        if self._cur is not None:
            self.pics.append(self._cur["pic"])
        super()._finish_picture()


def frames_equal(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.poc == b.poc
        for p in "YUV":
            x, y = getattr(a, p), getattr(b, p)
            assert x.dtype == y.dtype, f"frame {i} plane {p} dtype"
            assert np.array_equal(x, y), f"frame {i} plane {p}"


def parses_equal(port_pics, jm_pics):
    assert len(port_pics) == len(jm_pics)
    for i, (p, j) in enumerate(zip(port_pics, jm_pics)):
        for k in PIC_FIELDS:
            assert np.array_equal(getattr(p, k), getattr(j, k)), \
                f"picture {i} field {k}"
        assert sorted(p.ipcm_luma) == sorted(j.ipcm_luma)


def decode_both(data):
    """(port decoder, its frames, jm_tpu decoder, its frames)."""
    port, jm = PortCapture(), JmCapture()
    return port, port.decode_annexb(data), jm, jm.decode_annexb(data)


def from_jm(data, jm_pics):
    """The stream decoded by the port with every picture's parse replaced
    by jm_tpu's (convert.picture_from_numpy)."""
    pics = list(jm_pics)

    class FromJm(port_decoder.H264Decoder):
        def _finish_picture(self):
            if self._cur is not None:
                self._cur["pic"] = picture_from_numpy(pics.pop(0))
            super()._finish_picture()

    out = FromJm(device="cpu").decode_annexb(data)
    assert not pics
    return out


@pytest.fixture(scope="module")
def hi10_runs():
    cache = {}

    def get(name):
        if name not in cache:
            data = (GOLDEN / f"{name}.264").read_bytes()
            N.reset_routes()
            port, frames, jm, jm_frames = decode_both(data)
            routes = {k: dict(v) for k, v in N.routes.items()}
            cache[name] = (data, port, frames, jm, jm_frames, routes)
        return cache[name]

    return get


@pytest.mark.parametrize("name", HI10)
def test_hi10_golden_decodes_like_jm_and_ldecod(name, hi10_runs,
                                                one_torch_thread):
    data, port, frames, jm, jm_frames, routes = hi10_runs(name)
    assert frames[0].Y.dtype == np.uint16 and frames[0].U.shape == (72, 88)
    frames_equal(frames, jm_frames)
    want = np.fromfile(GOLDEN / f"{name}_rec.yuv", np.uint16)
    got = np.concatenate([np.concatenate([f.Y.ravel(), f.U.ravel(),
                                          f.V.ravel()])
                          for f in sorted(frames, key=lambda f: f.poc)])
    assert got.size == want.size and np.array_equal(got, want)
    if name == "hi10c":
        # every CAVLC slice on the native parser; the intra recon on the
        # Python walk (the native one is 8-bit)
        assert routes["parse"] == {"native": 6, "python": 0, "rerun": 0}
        assert routes["recon"]["native"] == 0
        assert routes["recon"]["python"] >= 1


@pytest.mark.parametrize("name", HI10)
def test_hi10_parse_matches_jm(name, hi10_runs):
    _, port, _, jm, _, _ = hi10_runs(name)
    parses_equal(port.pics, jm.pics)
    assert {int(q) for p in port.pics for q in np.unique(p.qp)} >= {30}


@pytest.mark.parametrize("name", HI10)
def test_hi10_recon_from_jm_parse(name, hi10_runs, one_torch_thread):
    """jm_tpu's parse of every picture through the port's reconstruction
    and deblock gives jm_tpu's frames."""
    data, _, _, jm, jm_frames, _ = hi10_runs(name)
    frames_equal(from_jm(data, jm.pics), jm_frames)


# ---- streams of the port's encoder under a re-headed SPS -----------------

def _port_stream(n=4, size=(96, 80), **kw):
    w, h = size
    frames = make_frames(w, h, n, seed=15)
    if kw.get("chroma_format") == 2:
        # 4:2:2 chroma: the even and odd columns of each luma row
        frames = [(Y, Y[:, ::2].copy(), Y[:, 1::2].copy())
                  for Y, _, _ in frames]
    enc = Encoder(EncoderConfig(width=w, height=h, qp=28, **kw),
                  device="cpu")
    if kw.get("pipeline") == "host" or kw.get("chroma_format") == 2 \
            or kw.get("pic_interlace"):
        payloads = [enc.encode_frame(*f) for f in frames]
        payloads[-1] += enc.flush()
    else:
        payloads = enc.encode_stream(frames)
    return b"".join(payloads)


def _cpu_frames(frames):
    return [(f[0], f[1], f[2]) for f in frames]


STREAMS = {
    # name: (encoder keywords, re-head: profile, bit depth, QP shift)
    "high10_cavlc": ({}, (110, 10, 0)),
    "high10_cabac": ({"entropy": "cabac"}, (110, 10, 0)),
    "bits14_negative_qp": (dict(pipeline="host", rc_enable=True,
                                rc_bitrate=40000.0, rc_basic_unit=3),
                           (244, 14, -40)),
    "yuv422_10bit": (dict(chroma_format=2), (122, 10, 0)),
    # field pictures (the port's field coder, 96x64: fields of 2 MB rows)
    # at QP 28 - 36 = -8
    "field10_negative_qp": (dict(pic_interlace=1, size=(96, 64)),
                            (110, 10, -36)),
}


@pytest.fixture(scope="module")
def stream_runs():
    cache = {}

    def get(name):
        if name not in cache:
            kw, (profile, bd, shift) = STREAMS[name]
            data = reheaded(_port_stream(**kw), profile, bd,
                            init_qp_shift=shift)
            N.reset_routes()
            port, frames, jm, jm_frames = decode_both(data)
            routes = {k: dict(v) for k, v in N.routes.items()}
            cache[name] = (data, port, frames, jm, jm_frames, routes)
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(STREAMS))
def test_reheaded_stream_decodes_like_jm(name, stream_runs,
                                         one_torch_thread):
    data, port, frames, jm, jm_frames, routes = stream_runs(name)
    frames_equal(frames, jm_frames)
    parses_equal(port.pics, jm.pics)
    bd = STREAMS[name][1][1]
    assert frames[0].Y.dtype == np.uint16
    assert int(frames[0].Y.max()) >= 1 << (bd - 2)
    qps = np.concatenate([p.qp for p in port.pics])
    if STREAMS[name][1][2]:
        # every QP below 0
        assert qps.max() < 0
    if name == "bits14_negative_qp":
        assert len(np.unique(qps)) > 2      # several per picture (basic units)
    if name.endswith(("cavlc", "negative_qp")):
        # every slice on the native parser, the fields' too (the field
        # scan is the residual decode's)
        assert routes["parse"]["native"] == len(port.pics)
    if name.startswith("field"):
        assert len(port.pics) == 2 * len(frames)
        assert all(p.field_mode for p in port.pics)
    if name == "yuv422_10bit":
        assert frames[0].U.shape == (80, 48)
        assert routes["yuv422"]["parse"] == len(frames)


@pytest.mark.parametrize("name", ["high10_cavlc", "bits14_negative_qp",
                                  "field10_negative_qp"])
def test_native_parser_matches_python_above_8_bits(name, stream_runs,
                                                   monkeypatch):
    """The native CAVLC parser (its QP wrap over [-QpBdOffsetY, 51])
    against the Python parser on the re-headed streams: every parsed
    array and every frame."""
    data, port, frames, _, _, _ = stream_runs(name)
    monkeypatch.setattr(mb_parse.MBParser, "_parse_native",
                        lambda self: False)
    py = PortCapture()
    frames_equal(py.decode_annexb(data), frames)
    parses_equal(py.pics, port.pics)


def test_qp_delta_wraps_as_jm():
    """apply_qp_delta against jm_tpu's wrap (mb_parse.py:347-354) at every
    bit depth over the whole QP and delta range, and its range check."""
    for bd in range(8, 15):
        sps = SPS(bit_depth_luma_minus8=bd - 8)
        off = 6 * (bd - 8)
        for qp in range(-off, 52):
            for dq in range(-(27 + off // 2), 27 + off // 2):
                want = ((qp + dq + 52 + 2 * off) % (52 + off)) - off
                assert mb_parse.apply_qp_delta(qp, dq, sps) == want
        with pytest.raises(ValueError, match="mb_qp_delta"):
            mb_parse.apply_qp_delta(0, 27 + off // 2, sps)


@pytest.mark.parametrize("bd", [8, 10, 14])
def test_pcm_samples_take_bit_depth_bits(bd):
    """An I_PCM MB's 384 samples are bit_depth bits each (spec 7.3.5), in
    both parsers (mb_parse.read_pcm_samples; jm_tpu's CABAC parser reads
    8, ROADMAP Queue 3): uint8 at 8 bits, else uint16; the reader ends
    right after them."""
    from jm_tpu_torch.bitstream.bitreader import BitReader
    from jm_tpu_torch.bitstream.bitwriter import BitWriter
    rng = np.random.default_rng(bd)
    luma = rng.integers(0, 1 << bd, 256)
    chroma = rng.integers(0, 1 << bd, 128)
    bw = BitWriter()
    for v in np.concatenate([luma, chroma, [5]]):
        bw.u(int(v), bd)
    bw.rbsp_trailing_bits()
    br = BitReader(bw.get_bytes())
    got_l, got_c = mb_parse.read_pcm_samples(
        br, SPS(bit_depth_luma_minus8=bd - 8,
                bit_depth_chroma_minus8=bd - 8))
    assert got_l.dtype == (np.uint8 if bd == 8 else np.uint16)
    assert np.array_equal(got_l, luma.reshape(16, 16))
    assert np.array_equal(got_c, chroma.reshape(2, 8, 8))
    assert br.u(bd) == 5


# ---- residual decode --------------------------------------------------------

def _pps_pair(rng):
    cb, cr = (int(v) for v in rng.integers(-12, 13, 2))
    l4 = [[int(v) for v in rng.integers(4, 64, 16)] for _ in range(6)]
    l8 = [[int(v) for v in rng.integers(4, 64, 64)] for _ in range(6)]
    kw = dict(chroma_qp_index_offset=cb, second_chroma_qp_index_offset=cr,
              transform_8x8_mode_flag=1, scaling_list_4x4=l4,
              scaling_list_8x8=l8)
    return PPS(**kw), JPPS(**kw)


def _residual_picture(rng, bd, crows, intra_frac):
    """Seeded levels of a 5x4-MB picture (inter, I_NxN with and without
    the 8x8 transform, I16) with QPY from -QpBdOffsetY to 51, the same
    arrays in a port and a jm_tpu PictureData; and the lossless mask of
    a bypass SPS (QP'Y 0)."""
    mb_w, mb_h = 5, 4
    cf = 2 if crows == 4 else 1
    pics = PictureData(mb_w, mb_h, cf), JPictureData(mb_w, mb_h, cf)
    n = mb_w * mb_h
    off = 6 * (bd - 8)
    cls = np.where(rng.random(n) < intra_frac,
                   rng.integers(1, 3, n), 0).astype(np.int8)
    qp = rng.integers(-off, 52, n).astype(np.int32)
    qp[:3] = (-off, -off, 51)
    vals = {
        "mb_class": cls,
        "transform8x8": (rng.random(n) < 0.4) & (cls != 2),
        "qp": qp,
        "luma_coef": rng.integers(-60, 61, (n, 16, 16)),
        "luma_dc": rng.integers(-60, 61, (n, 16)),
        "luma_coef8": rng.integers(-60, 61, (n, 4, 64)),
        "chroma_dc": rng.integers(-60, 61, (n, 2, 2 * crows)),
        "chroma_coef": rng.integers(-60, 61, (n, 2, 2 * crows, 16)),
    }
    for k in ("luma_coef", "luma_coef8", "chroma_coef"):
        vals[k] = vals[k] * (rng.random(vals[k].shape) < 0.3)
    vals["chroma_coef"][..., 0] = 0
    vals["luma_coef"][cls == 2, :, 0] = 0
    for pic in pics:
        for k, v in vals.items():
            getattr(pic, k)[:] = v
    return pics, qp + off == 0


RES_CASES = [(bd, crows, seed) for bd in (8, 10, 14) for crows in (2, 4)
             for seed in (0, 1)]


@pytest.mark.parametrize("bd,crows,seed", RES_CASES)
def test_decode_residuals_matches_jm(bd, crows, seed):
    rng = np.random.default_rng(seed + 10 * bd + crows)
    pps, jpps = _pps_pair(rng)
    (pic, jpic), ll = _residual_picture(rng, bd, crows, 0.5)
    assert ll.any() and not ll.all()
    for mask in (None, ll):
        got = decode_residuals(pic, pps, (bd, bd), mask)
        want = jm_decode_residuals(jpic, jpps, bd=(bd, bd), lossless=mask)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("bd,crows,seed", RES_CASES)
def test_p_dec_residuals_matches_jm(bd, crows, seed):
    """The device stage on a picture of inter MBs (the inter lists), with
    and without the lossless mask, against jm_tpu's host decode."""
    rng = np.random.default_rng(seed + 10 * bd + crows + 100)
    pps, jpps = _pps_pair(rng)
    (pic, jpic), ll = _residual_picture(rng, bd, crows, 0.0)
    tab4 = build_inv_scale(pps)
    assert tab4.shape == (6, 88, 4, 4)
    qcb, qcr = qpc_tables(pps, bd=(bd, bd))
    assert qcb.shape == (52 + 6 * (bd - 8),)
    t = torch.as_tensor
    for mask in (None, ll):
        want_l, want_c = jm_decode_residuals(jpic, jpps, bd=(bd, bd),
                                             lossless=mask)
        res_l, res_c = dec.p_dec_residuals(
            t(pic.luma_coef), t(pic.chroma_dc), t(pic.chroma_coef),
            t(pic.qp), *(t(tab4[i]) for i in (3, 4, 5)), qcb, qcr,
            mb_w=pic.mb_w, mb_h=pic.mb_h, luma_coef8=t(pic.luma_coef8),
            transform8x8=t(pic.transform8x8),
            tab8=t(build_inv_scale8(pps)[1]), bd=(bd, bd),
            lossless=None if mask is None else t(mask))
        assert res_l.dtype == res_c.dtype == torch.int32
        np.testing.assert_array_equal(res_l.numpy(), want_l)
        np.testing.assert_array_equal(res_c.numpy(), want_c)


# ---- the deblock twins ------------------------------------------------------

class _Offsets:
    """The chroma QP offsets convert.qpc_tables reads of a PPS."""

    def __init__(self, cb, cr):
        self.cb_qp_offset, self.cr_qp_offset = cb, cr


def _deblock_case(mb_w, mb_h, seed, bd, crows, kw, skw):
    """A random picture (jm_tpu's test_deblock_jax.random_pic) at bit depth
    bd: QPY from -QpBdOffsetY to 51, chroma offsets, samples 0 ..
    (1 << bd) - 1 with a low-amplitude region so that the filters fire.
    Returns (jm_tpu picture, slice params, planes, bS, per-MB, offsets)."""
    rng = np.random.default_rng(seed)
    pic = random_pic(rng, mb_w, mb_h, **kw)
    pic.n_crows = crows
    off = 6 * (bd - 8)
    pic.qp[:] = rng.integers(-off, 52, pic.n_mbs)
    if skw.get("disable") == 2:
        pic.slice_id[pic.n_mbs // 2:] = 1
    sp = slice_params(pic, **skw)
    cb, cr = (int(v) for v in rng.integers(-12, 13, 2))
    sp["cb_qp_off"][:] = cb
    sp["cr_qp_off"][:] = cr
    H, W = 16 * mb_h, 16 * mb_w
    s = bd - 8
    planes = []
    for h, w in ((H, W), (4 * crows * mb_h, W // 2), (4 * crows * mb_h,
                                                      W // 2)):
        p = rng.integers(0, 1 << bd, (h, w))
        r = 3 * h // 4
        p[:r] = (((p[:r] >> s) // 20 + 100) << s) | (p[:r] & ((1 << s) - 1))
        planes.append(p.astype(np.uint16))
    bs = jm_compute_bs(pic, mb_w, mb_h)
    per_mb = (pic.qp.astype(np.int32), sp["disable_idc"], sp["alpha_off"],
              sp["beta_off"], sp["slice_id"],
              pic.transform8x8.astype(np.int32))
    return pic, sp, planes, bs, per_mb, _Offsets(cb, cr)


DEBLOCK_CASES = [
    (6, 4, 0, {}, {}),
    (6, 4, 1, {"multi_ref": True, "t8_frac": 0.4}, {"a_off": 3,
                                                    "b_off": 2}),
    (5, 4, 2, {"intra_frac": 0.8}, {"disable": 2, "a_off": 6,
                                    "b_off": 6}),
    (1, 4, 3, {}, {"a_off": 4}),
    (6, 1, 4, {"t8_frac": 0.5}, {"b_off": -3}),
]


@pytest.mark.parametrize("bd", [10, 14])
@pytest.mark.parametrize("crows", [2, 4])
@pytest.mark.parametrize("mb_w,mb_h,seed,kw,skw", DEBLOCK_CASES)
def test_deblock_twins_match_jm(mb_w, mb_h, seed, kw, skw, crows, bd):
    pic, sp, planes, bs, per_mb, offs = _deblock_case(
        mb_w, mb_h, seed + 7 * bd, bd, crows, kw, skw)
    want = [p.copy() for p in planes]
    jm_deblock_picture(*want, pic, mb_w, mb_h, pic.qp, sp,
                       force_numpy=True, bd=(bd, bd))
    t = torch.from_numpy
    qcb, qcr = qpc_tables(offs, bd=(bd, bd))
    got = deblock_plain(
        *(t(p.view(np.int16)) for p in planes), t(bs[0].astype(np.int8)),
        t(bs[1].astype(np.int8)), *(t(a) for a in per_mb), qcb, qcr,
        mb_w=mb_w, mb_h=mb_h, bd=(bd, bd))
    for g, w, p, name in zip(got, want, planes, "YUV"):
        assert g.dtype == torch.int16
        assert np.array_equal(g.numpy().view(np.uint16), w), name
    if seed < 3:
        assert not np.array_equal(want[0], planes[0])


def _emulate(planes, bs, per_mb, tabs, mb_w, mb_h, crows, bd, steps):
    """The >8-bit kernels' data flow one step at a time, as
    tests/test_torch_deblock.py _emulate at 8 bits: luma, and Cb / Cr of
    4 crows lines per MB; a step filters one MB's vertical ("v"),
    horizontal ("h") or all ("mb") edges on a tile of the MB and the 4
    samples left of and above it, the interior from the input planes
    ("h": from the output), the fringes from the output planes, which
    start as SENTINEL; asserts that no step read one."""
    sentinel = -1
    ch = 4 * crows
    dims = ((16, 16), (ch, 8), (ch, 8))
    src = [torch.from_numpy(p.astype(np.int32)) for p in planes]
    out = [torch.zeros((h * mb_h + 4, w * mb_w + 4), dtype=torch.int32)
           for h, w in dims]
    for o in out:
        o[4:, 4:] = sentinel
    mp = MbParams(*(torch.from_numpy(a) for a in per_mb), mb_w, mb_h)
    bs_v, bs_h = (torch.from_numpy(np.array(b, np.int8)) for b in bs)
    for kind, b, c in steps:
        ln, bv, bh = mp.lanes(torch.tensor([b]), torch.tensor([c]),
                              bs_v, bs_h)
        tiles = []
        for o, p, (h, w) in zip(out, src, dims):
            y, x = h * b, w * c
            tile = torch.zeros((h + 4, w + 4), dtype=torch.int32)
            if kind != "h":
                tile[4:, :4] = o[y + 4:y + h + 4, x:x + 4]
            if kind != "v":
                tile[:4, 4:] = o[y:y + 4, x + 4:x + w + 4]
            tile[4:, 4:] = o[y + 4:y + h + 4, x + 4:x + w + 4] \
                if kind == "h" else p[y:y + h, x:x + w]
            assert not (tile == sentinel).any(), f"{kind} ({b}, {c})"
            tiles.append(tile)
        ty, ct = tiles[0][None], torch.stack(tiles[1:])[None]
        if kind != "h":
            luma_vertical(ty, ln, bv, bd)
            chroma_vertical(ct, ln, bv, *tabs, bd)
        if kind != "v":
            luma_horizontal(ty, ln, bh, bd)
            chroma_horizontal(ct, ln, bh, *tabs, bd)
        for o, tile, (h, w) in zip(out, (ty[0], ct[0, 0], ct[0, 1]), dims):
            y, x = h * b, w * c
            if kind != "h":
                o[y + 4:y + h + 4, x:x + 4] = tile[4:, :4]
            if kind != "v":
                o[y:y + 4, x + 4:x + w + 4] = tile[:4, 4:]
            o[y + 4:y + h + 4, x + 4:x + w + 4] = tile[4:, 4:]
    assert not any((o == sentinel).any() for o in out)
    return [o[4:, 4:].numpy().astype(np.uint16) for o in out]


@pytest.mark.parametrize("crows", [2, 4])
@pytest.mark.parametrize("mb_w,mb_h,seed,kw,skw", [
    c for c in DEBLOCK_CASES if c[0] >= 2 and c[1] >= 2])
def test_hbd_kernel_schedule_matches_wavefront(mb_w, mb_h, seed, kw, skw,
                                               crows):
    """K1-HBD with K2-HBD (crows 2) or K2-422-HBD (crows 4) at 10 bits:
    every order of whole MBs that progress[b-1] >= min(c + 2, mb_w)
    admits, and every order of the kernels' phases, gives the plain
    twins' planes; counting an MB final before the next MB's left edge
    rewrote its right fringe admits an order that gives other planes
    (tests/test_torch_y422_decode.py test_k2_422_schedule_matches_wavefront
    at 16 bits)."""
    bd = 10
    _, _, planes, bs, per_mb, offs = _deblock_case(mb_w, mb_h, seed + 70,
                                                   bd, crows, kw, skw)
    tabs = qpc_tables(offs, bd=(bd, bd))
    t = torch.from_numpy
    plain = [g.numpy().view(np.uint16) for g in deblock_plain(
        *(t(p.view(np.int16)) for p in planes), t(bs[0].astype(np.int8)),
        t(bs[1].astype(np.int8)), *(t(a) for a in per_mb), *tabs,
        mb_w=mb_w, mb_h=mb_h, bd=(bd, bd))]
    assert not np.array_equal(plain[0], planes[0])
    args = (planes, bs, per_mb, tabs, mb_w, mb_h, crows, bd)
    rng = np.random.default_rng(seed)
    for order in (_mb_order(mb_w, mb_h, 2), _mb_order(mb_w, mb_h, 2, rng),
                  _phase_order(mb_w, mb_h), _phase_order(mb_w, mb_h, rng)):
        for g, p in zip(_emulate(*args, order), plain):
            assert np.array_equal(g, p)
    early = _emulate(*args, _phase_order(mb_w, mb_h, fringe=False))
    assert any(not np.array_equal(g, p) for g, p in zip(early, plain))


def test_decoder_deblock_gets_the_bit_depth(hi10_runs):
    """The decoder hands deblock int16 planes, QPc tables of 52 +
    QpBdOffsetY entries and bd: the dtype that picks the >8-bit kernels
    on the card (kernels.deblock_luma / deblock_chroma)."""
    data = hi10_runs("hi10c")[0]
    seen = []
    orig = port_decoder.deblock

    def spy(Y, U, V, *a, **k):
        seen.append((Y.dtype, U.dtype, a[-2].shape[0], k["bd"]))
        return orig(Y, U, V, *a, **k)

    with mock.patch.object(port_decoder, "deblock", spy):
        H264Decoder(device="cpu").decode_annexb(data)
    assert seen and all(s == (torch.int16, torch.int16, 64, (10, 10))
                        for s in seen)


# ---- out of scope -----------------------------------------------------------

@pytest.mark.parametrize("field,value,construct", [
    ("bit_depth_luma_minus8", 7, "bit depth"),
    ("bit_depth_chroma_minus8", 9, "bit depth"),
    ("chroma_format_idc", 3, "chroma_format_idc 3"),
    ("chroma_format_idc", 0, "chroma_format_idc 0"),
])
def test_out_of_scope_sps_raises(field, value, construct):
    """Bit depths above 14 (no conforming profile; jm_tpu decoder.py:171)
    and 4:4:4 / 4:0:0 still raise, where 9-14 bits and the bypass flag
    are admitted."""
    sps = SPS(profile_idc=244, bit_depth_luma_minus8=6,
              bit_depth_chroma_minus8=6,
              qpprime_y_zero_transform_bypass_flag=1)
    check_scope(sps, PPS())
    setattr(sps, field, value)
    with pytest.raises(NotImplementedError, match=construct):
        check_scope(sps, PPS())
