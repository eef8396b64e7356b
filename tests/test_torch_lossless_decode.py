"""The port's decoder on lossless streams (qpprime_y_zero_transform_bypass_
flag: the macroblocks of QP'Y 0 take the transform bypass, their levels
are the residual, and intra prediction of modes vertical and horizontal
accumulates it: spec 8.5.15) against jm_tpu's on the CPU, exactly:
- JM's goldens lossless (CAVLC) and lossless_cabac (CABAC), profile 244,
  I P P with every MB at QP 0, intra MBs in the P pictures: the port's
  decode against jm_tpu's H264Decoder(device_recon=True) and the sha256
  that chip_smoke.py's phase 42 checks on the card; each picture's parse
  field by field, and jm_tpu's parse through the port's reconstruction
  (the FromJm pattern);
- QP-0 streams of the port's encoder (CAVLC and CABAC on the device
  route, CABAC on the host pipeline, and 4:2:2 CAVLC and CABAC from the
  host coders) under a profile-244 SPS with the bypass flag
  (torch_streams.reheaded), decoded equal in both packages, with Intra
  4x4 and chroma DPCM and lossless inter MBs (the device residual's
  bypass) among their MBs;
- the lossless intra recon of every DPCM mode (Intra 4x4 / 8x8 / 16x16
  vertical and horizontal, chroma horizontal and vertical), which the
  encoder's streams do not all reach, on seeded pictures at 8, 10 and
  14 bits, and at 4:2:2 (8x16 chroma blocks), against jm_tpu's host
  Reconstructor;
- the deblocking of a lossless MB beside a lossy one, which both
  packages filter (ROADMAP Queue 3)."""

import hashlib
from pathlib import Path

import numpy as np
import pytest
import torch

from jm_tpu.common.types import PPS as JPPS
from jm_tpu.common.types import SPS as JSPS
from jm_tpu.decoder.mb_parse import PictureData as JPictureData
from jm_tpu.decoder.recon import Reconstructor as JReconstructor
from jm_tpu.ops.deblock import compute_bs as jm_compute_bs
from jm_tpu.ops.deblock import deblock_picture as jm_deblock_picture
from jm_tpu_torch import native as N
from jm_tpu_torch.common.picture import MB_I4, MB_I16, MB_INTER, PictureData
from jm_tpu_torch.common.types import PPS
from jm_tpu_torch.convert import qpc_tables
from jm_tpu_torch.decoder.recon import Reconstructor
from jm_tpu_torch.encoder.encoder import Encoder, EncoderConfig
from jm_tpu_torch.ops.deblock import deblock_plain

from test_deblock_jax import random_pic, slice_params
from test_pipe_stream import make_frames
from test_torch_hbd_decode import (_Offsets, decode_both, frames_equal,
                                   from_jm, parses_equal)
from torch_streams import one_torch_thread, reheaded  # noqa: F401

GOLDEN = Path(__file__).parent / "golden"
LOSSLESS = ["lossless", "lossless_cabac"]
# sha256 of the goldens' frames (Y, U, V of each in POC order, uint8), as
# jm_tpu decodes them: both code the same source frames, which a lossless
# decode gives back (chip_smoke.py LOSSLESS_SHA256)
SHA256 = "b721aed52a9ba57916b9d22a1e84faca4d706ae69513e98a033e1f3e5a288479"


def _sha(frames):
    return hashlib.sha256(b"".join(
        f.Y.tobytes() + f.U.tobytes() + f.V.tobytes()
        for f in sorted(frames, key=lambda f: f.poc))).hexdigest()


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(name):
        if name not in cache:
            if name in LOSSLESS:
                data = (GOLDEN / f"{name}.264").read_bytes()
            else:
                data = reheaded(_qp0_stream(**QP0[name]), 244, 8, bypass=1)
            N.reset_routes()
            port, frames, jm, jm_frames = decode_both(data)
            routes = {k: dict(v) for k, v in N.routes.items()}
            cache[name] = (data, port, frames, jm, jm_frames, routes)
        return cache[name]

    return get


@pytest.mark.parametrize("name", LOSSLESS)
def test_lossless_golden_decodes_like_jm(name, runs, one_torch_thread):
    data, port, frames, jm, jm_frames, routes = runs(name)
    frames_equal(frames, jm_frames)
    assert frames[0].Y.dtype == np.uint8 and len(frames) == 3
    assert _sha(frames) == _sha(jm_frames) == SHA256
    # every MB lossless; intra MBs in the P pictures too
    assert all((p.qp == 0).all() for p in port.pics)
    assert all((p.mb_class != MB_INTER).any() for p in port.pics)
    # the lossless intra recon is the Python walk's (the native one has no
    # DPCM); CAVLC slices take the native parser
    assert routes["recon"] == {"native": 0, "python": 3}
    if name == "lossless":
        assert routes["parse"]["native"] == 3


@pytest.mark.parametrize("name", LOSSLESS)
def test_lossless_parse_matches_jm(name, runs):
    _, port, _, jm, _, _ = runs(name)
    parses_equal(port.pics, jm.pics)


@pytest.mark.parametrize("name", LOSSLESS)
def test_lossless_recon_from_jm_parse(name, runs, one_torch_thread):
    data, _, _, jm, jm_frames, _ = runs(name)
    frames_equal(from_jm(data, jm.pics), jm_frames)


# ---- QP-0 streams of the port's encoder, re-headed lossless --------------

QP0 = {
    "qp0_cavlc": {},
    "qp0_cabac": {"entropy": "cabac"},
    "qp0_host": {"pipeline": "host", "entropy": "cabac"},
    "qp0_422_cavlc": {"pipeline": "host", "chroma_format": 2},
    "qp0_422_cabac": {"pipeline": "host", "chroma_format": 2,
                      "entropy": "cabac"},
}


def _qp0_stream(**kw):
    frames = make_frames(96, 80, 3, seed=21, noise_at=2)
    if kw.get("chroma_format") == 2:
        frames = [(Y, Y[:, ::2].copy(), Y[:, 1::2].copy())
                  for Y, _, _ in frames]
    enc = Encoder(EncoderConfig(width=96, height=80, qp=0, **kw),
                  device="cpu")
    if kw.get("pipeline") == "host":
        payloads = [enc.encode_frame(*f) for f in frames]
        payloads[-1] += enc.flush()
    else:
        payloads = enc.encode_stream(frames)
    return b"".join(payloads)


def _dpcm_blocks(pics):
    """How many intra blocks of each kind predict vertically or
    horizontally (the DPCM of a lossless MB), and the inter MBs."""
    n = {"i4": 0, "i8": 0, "i16": 0, "chroma": 0, "inter": 0}
    for p in pics:
        i4 = p.mb_class == MB_I4
        modes = p.i4_modes[i4 & ~p.transform8x8]
        n["i4"] += int(((modes == 0) | (modes == 1)).sum())
        modes8 = p.i4_modes[i4 & p.transform8x8][:, [0, 2, 8, 10]]
        n["i8"] += int(((modes8 == 0) | (modes8 == 1)).sum())
        n["i16"] += int(np.isin(p.i16_mode[p.mb_class == MB_I16],
                                (0, 1)).sum())
        intra = (p.mb_class == MB_I4) | (p.mb_class == MB_I16)
        n["chroma"] += int(np.isin(p.chroma_mode[intra], (1, 2)).sum())
        n["inter"] += int((p.mb_class == MB_INTER).sum())
    return n


@pytest.mark.parametrize("name", list(QP0))
def test_qp0_stream_lossless_decodes_like_jm(name, runs, one_torch_thread):
    data, port, frames, jm, jm_frames, _ = runs(name)
    frames_equal(frames, jm_frames)
    parses_equal(port.pics, jm.pics)
    n = _dpcm_blocks(port.pics)
    assert n["i4"] > 0 and n["chroma"] > 0 and n["inter"] > 0


def _intra_picture(rng, bd, chroma_format=1):
    """A seeded all-intra 5x4-MB picture at QP'Y 0 (QPY -QpBdOffsetY)
    whose MBs are Intra 4x4, 8x8 and 16x16 in every prediction mode the
    neighbours admit (vertical and horizontal among them, in luma and
    chroma), with seeded levels; the same arrays in a port and a jm_tpu
    PictureData of chroma_format (1: 4:2:0, 2: 4:2:2, n_crows 4)."""
    mb_w, mb_h = 5, 4
    pics = (PictureData(mb_w, mb_h, chroma_format),
            JPictureData(mb_w, mb_h, chroma_format))
    nc = 2 * pics[0].n_crows                   # chroma 4x4 blocks a plane
    n = mb_w * mb_h
    cls = np.where(np.arange(n) % 3 == 2, MB_I16, MB_I4).astype(np.int8)
    t8 = (cls == MB_I4) & (np.arange(n) % 3 == 1)
    i4 = np.zeros((n, 16), np.int8)
    i16 = np.full(n, -1, np.int8)
    cm = np.zeros(n, np.int8)
    for a in range(n):
        mx, my = a % mb_w, a // mb_w
        for blk in range(16):
            gx, gy = 4 * mx + blk % 4, 4 * my + blk // 4
            if gx and gy:
                i4[a, blk] = rng.integers(0, 9)
            else:
                i4[a, blk] = 2 if not (gx or gy) else (1 if gx else 0)
        if t8[a]:
            for q in (0, 2, 8, 10):             # one mode an 8x8
                i4[a, [q, q + 1, q + 4, q + 5]] = i4[a, q]
        full = [m for m in range(4) if (m != 0 or my) and (m != 1 or mx)
                and (m != 3 or (mx and my))]
        i16[a] = rng.choice(full) if cls[a] == MB_I16 else -1
        cm[a] = rng.choice([m for m in range(4) if (m != 1 or mx)
                            and (m != 2 or my) and (m != 3 or (mx and my))])
    vals = {
        "mb_class": cls, "transform8x8": t8, "i4_modes": i4,
        "i16_mode": i16, "chroma_mode": cm, "slice_id": np.zeros(n),
        "qp": np.full(n, -6 * (bd - 8)),
        "luma_coef": rng.integers(-40, 41, (n, 16, 16)),
        "luma_dc": rng.integers(-40, 41, (n, 16)),
        "luma_coef8": rng.integers(-40, 41, (n, 4, 64)),
        "chroma_dc": rng.integers(-40, 41, (n, 2, nc)),
        "chroma_coef": rng.integers(-40, 41, (n, 2, nc, 16)),
    }
    vals["chroma_coef"][..., 0] = 0
    vals["luma_coef"][cls == MB_I16, :, 0] = 0
    for pic in pics:
        for k, v in vals.items():
            getattr(pic, k)[:] = v
    return pics


@pytest.mark.parametrize("bd", [8, 10, 14])
def test_lossless_intra_recon_matches_jm(bd):
    """The Python walk's lossless intra recon (the DPCM of Intra 4x4, 8x8
    and 16x16 vertical / horizontal and chroma horizontal / vertical,
    the raw DC, the other modes on the raw residual) against jm_tpu's
    host Reconstructor, at 8, 10 and 14 bits."""
    rng = np.random.default_rng(bd)
    pic, jpic = _intra_picture(rng, bd)
    sps = JSPS(bit_depth_luma_minus8=bd - 8, bit_depth_chroma_minus8=bd - 8,
               qpprime_y_zero_transform_bypass_flag=1)
    flat = dict(scaling_list_4x4=[[16] * 16 for _ in range(6)],
                scaling_list_8x8=[[16] * 64 for _ in range(6)])
    want = JReconstructor(jpic, sps, JPPS(**flat), []).run()
    got = Reconstructor(pic, PPS(**flat), (bd, bd), bypass=True).run()
    n = _dpcm_blocks([pic])
    assert n["i4"] and n["i8"] and n["i16"] and n["chroma"]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert np.array_equal(g, w)


def test_lossless_intra_recon_422_matches_jm():
    """The same at 4:2:2 (n_crows 4: the chroma DPCM over 8x16 blocks and
    the 2x4 chroma DC, whose placement the port copies from jm_tpu,
    ADVICE.md), at 8 bits."""
    rng = np.random.default_rng(422)
    pic, jpic = _intra_picture(rng, 8, chroma_format=2)
    assert pic.n_crows == jpic.n_crows == 4
    sps = JSPS(chroma_format_idc=2, qpprime_y_zero_transform_bypass_flag=1)
    flat = dict(scaling_list_4x4=[[16] * 16 for _ in range(6)],
                scaling_list_8x8=[[16] * 64 for _ in range(6)])
    want = JReconstructor(jpic, sps, JPPS(**flat), []).run()
    got = Reconstructor(pic, PPS(**flat), (8, 8), bypass=True).run()
    n = _dpcm_blocks([pic])
    assert n["i4"] and n["i8"] and n["i16"] and n["chroma"]
    assert got[1].shape == (64, 40)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert np.array_equal(g, w)


def test_lossless_mb_deblocked_as_jm():
    """A lossless MB (QP'Y 0) beside lossy ones: spec 8.7.2 keeps its
    samples as they are (p'i = pi where qpprime_y_zero_transform_bypass_
    flag is 1 and QP'Y of the MB containing p0 is 0), but jm_tpu's
    deblock_picture has no such term and filters them, and the port's
    twins (and kernels) do the same for parity (ROADMAP Queue 3): the
    planes are equal and samples of the lossless MBs changed."""
    rng = np.random.default_rng(5)
    mb_w, mb_h = 6, 4
    pic = random_pic(rng, mb_w, mb_h, intra_frac=0.5)
    lossless = rng.random(pic.n_mbs) < 0.5
    pic.qp[:] = np.where(lossless, 0, 40)
    sp = slice_params(pic)
    planes = [(rng.integers(0, 256, s) // 20 + 100).astype(np.uint8)
              for s in ((64, 96), (32, 48), (32, 48))]
    want = [p.copy() for p in planes]
    jm_deblock_picture(*want, pic, mb_w, mb_h, pic.qp, sp, force_numpy=True)
    bs = jm_compute_bs(pic, mb_w, mb_h)
    t = torch.from_numpy
    got = deblock_plain(
        *(t(p) for p in planes), t(bs[0].astype(np.int8)),
        t(bs[1].astype(np.int8)), t(pic.qp.astype(np.int32)),
        *(t(sp[k]) for k in ("disable_idc", "alpha_off", "beta_off",
                             "slice_id")),
        t(pic.transform8x8.astype(np.int32)), *qpc_tables(_Offsets(0, 0)),
        mb_w=mb_w, mb_h=mb_h)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)
    ll = np.repeat(np.repeat(lossless.reshape(mb_h, mb_w), 16, 0), 16, 1)
    assert (want[0] != planes[0])[ll].any()
