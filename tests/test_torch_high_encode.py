"""The port's High-profile encoder against jm_tpu's on the CPU, exactly
(the codec is integer-exact: the tolerance is zero):
- encoder/qmatrix.QuantCtx (scaling matrices, explicit offsets, adaptive
  rounding with its refresh period, snapshot and commit) against jm_tpu's
  on seeded blocks, for I, P and B pictures;
- the 8x8 forward transform, quant, scan, recon and coefficient cost of
  encoder/residual_np.py against jm_tpu's;
- the High SPS / PPS (the 8x8 transform flag, the SPS and PPS scaling
  lists) against jm_tpu's writers;
- streams of the 96x80 QP 30 clip of tests/test_pipe_stream.py (3
  frames, encode_frame and flush): the 8x8 transform, with CABAC, with
  scaling matrices 1 / 2 / 3 (the spec's default lists with the default
  offsets and adaptive rounding, seeded lists with CABAC and B pictures,
  and lists sent in the SPS, the PPS or both), adaptive rounding, B
  pictures, and the 8x8 transform and custom quant under pipeline="device"
  (whose pictures jm_tpu codes on the host all the same): the payloads
  byte for byte, the reconstructed pictures, and the port's decode of each
  stream equal to the recon; and a reference fault the port copies (a list
  the PPS leaves to its fall-back is quantized with the configured list);
- jm_tpu's refusals: FMO in profile 100, scaling matrices with data
  partitioning; and the 8x8 transform with data partitioning, which the
  port refuses (jm_tpu writes such a stream's 8x8 residual into the
  wrong partition)."""

import numpy as np
import pytest

from jm_tpu.decoder.decoder import H264Decoder as JaxDecoder
from jm_tpu.encoder import qmatrix as jm_qmatrix
from jm_tpu.encoder import residual_np as jm_rn
from jm_tpu.encoder.encoder import Encoder as JaxEncoder
from jm_tpu.encoder.encoder import EncoderConfig as JaxConfig
from jm_tpu.encoder.syntax import write_pps as jm_write_pps
from jm_tpu.encoder.syntax import write_sps as jm_write_sps
from jm_tpu_torch.decoder.decoder import H264Decoder
from jm_tpu_torch.decoder.parset import (DEFAULT_4x4_INTER, DEFAULT_4x4_INTRA,
                                         DEFAULT_8x8_INTER, DEFAULT_8x8_INTRA)
from jm_tpu_torch.encoder import qmatrix
from jm_tpu_torch.encoder import residual_np as rn
from jm_tpu_torch.encoder.encoder import Encoder, EncoderConfig
from jm_tpu_torch.encoder.syntax import write_pps, write_sps

import torch_streams as S
from torch_streams import one_torch_thread  # noqa: F401

W, H, QP = S.W, S.H, S.QP
_RNG = np.random.default_rng(7)
LISTS4 = tuple(tuple(int(v) for v in _RNG.integers(4, 64, 16))
               for _ in range(6))
LISTS8 = tuple(tuple(int(v) for v in _RNG.integers(4, 64, 64))
               for _ in range(2))
DEF4 = tuple(tuple(qmatrix.from_zigzag4(DEFAULT_4x4_INTRA if i < 3
                                        else DEFAULT_4x4_INTER))
             for i in range(6))
DEF8 = (tuple(qmatrix.from_zigzag8(DEFAULT_8x8_INTRA)),
        tuple(qmatrix.from_zigzag8(DEFAULT_8x8_INTER)))
OFFSETS = tuple(tuple(tuple(int(v) for v in row) for row in m)
                for m in qmatrix.default_offsets())


# ---- QuantCtx -------------------------------------------------------------

@pytest.mark.parametrize("kind,ar,lists", [
    ("I", 0, False), ("P", 4, False), ("P", 4, True), ("B", 2, True),
    ("I", 6, True)])
def test_quant_ctx_matches_jm(kind, ar, lists):
    rng = np.random.default_rng(len(kind) + ar + lists)
    l4 = [list(x) for x in (LISTS4 if lists else [[16] * 16] * 6)]
    l8 = [list(x) for x in (LISTS8 if lists else [[16] * 64] * 2)]
    off = qmatrix.default_offsets()
    joff = tuple(a.copy() for a in off)
    q = qmatrix.QuantCtx(l4, l8, kind, off_state=off, ar_weight=ar)
    jq = jm_qmatrix.QuantCtx(l4, l8, kind, off_state=joff, ar_weight=ar)
    for tab in ((q.inv4, jq.inv4), (q.inv8, jq.inv8),
                (q.scale4, jq.scale4), (q.scale8, jq.scale8)):
        np.testing.assert_array_equal(*tab)
    for mb in range(12):
        q.maybe_refresh(mb, 3)
        jq.maybe_refresh(mb, 3)
        snap, jsnap = q.ar_snapshot(), jq.ar_snapshot()
        for _ in range(3):
            qp = int(rng.integers(0, 52))
            intra, plane = bool(rng.integers(2)), int(rng.integers(3))
            w4 = rng.integers(-3000, 3000, (16, 4, 4))
            w8 = rng.integers(-6000, 6000, (4, 8, 8))
            dc = rng.integers(-9000, 9000, (4, 4))
            np.testing.assert_array_equal(q.quant_4x4(w4, qp, plane, intra),
                                          jq.quant_4x4(w4, qp, plane, intra))
            np.testing.assert_array_equal(q.quant_dc(dc, qp, plane, intra),
                                          jq.quant_dc(dc, qp, plane, intra))
            np.testing.assert_array_equal(q.quant_8x8(w8, qp, intra),
                                          jq.quant_8x8(w8, qp, intra))
        if mb % 4 == 1:             # a discarded trial
            q.ar_restore(snap)
            jq.ar_restore(jsnap)
        q.ar_commit_mb()
        jq.ar_commit_mb()
        np.testing.assert_array_equal(off[0], joff[0])
        np.testing.assert_array_equal(off[1], joff[1])
    if ar:
        assert not np.array_equal(off[0], qmatrix.default_offsets()[0])


def test_zigzag_helpers_and_default_offsets_match_jm():
    r16, r64 = list(range(16)), list(range(64))
    assert qmatrix.to_zigzag4(r16) == jm_qmatrix.to_zigzag4(r16)
    assert qmatrix.to_zigzag8(r64) == jm_qmatrix.to_zigzag8(r64)
    assert qmatrix.from_zigzag4(r16) == jm_qmatrix.from_zigzag4(r16)
    assert qmatrix.from_zigzag8(r64) == jm_qmatrix.from_zigzag8(r64)
    for a, b in zip(qmatrix.default_offsets(), jm_qmatrix.default_offsets()):
        np.testing.assert_array_equal(a, b)


# ---- 8x8 residual ----------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_residual_8x8_matches_jm(seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-255, 256, (4, 8, 8))
    pred = rng.integers(0, 256, (4, 8, 8))
    w = rn.np_forward8x8(x)
    np.testing.assert_array_equal(w, jm_rn.np_forward8x8(x))
    for qp in (0, 17, 35, 36, 51):
        for intra in (True, False):
            lev = rn.np_quant_8x8(w, qp, intra)
            np.testing.assert_array_equal(lev,
                                          jm_rn.np_quant_8x8(w, qp, intra))
        scan = rn.to_scan8(lev)
        np.testing.assert_array_equal(scan, jm_rn.to_scan8(lev))
        tab = qmatrix.QuantCtx(list(LISTS4), list(LISTS8), "P").inv_tab8(False)
        for t in (None, tab):
            np.testing.assert_array_equal(
                rn.recon_luma_8x8(pred, scan, qp, tab=t),
                jm_rn.recon_luma_8x8(pred, scan, qp, tab=t))
        for q in range(4):
            assert rn.coeff_cost_scan(scan[q], tab=rn.COEFF_COST8) == \
                jm_rn.coeff_cost_scan(scan[q], tab=jm_rn.COEFF_COST8)


# ---- parameter sets ---------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(transform8x8=True),
    dict(scaling_matrix=1, scaling_lists4=LISTS4),
    dict(scaling_matrix=2, transform8x8=True, scaling_lists4=LISTS4,
         scaling_lists8=LISTS8),
    dict(scaling_matrix=3, transform8x8=True, scaling_lists8=LISTS8,
         scaling_present=(1, 2, 3, 0, 1, 2, 3, 0)),
    dict(scaling_matrix=3, scaling_present=(2, 2, 1), entropy="cabac"),
    dict(adaptive_rounding=True, offset_matrix=OFFSETS),
])
def test_high_parameter_sets_match_jm(kw):
    enc = Encoder(EncoderConfig(width=W, height=H, qp=QP, **kw),
                  device="cpu")
    jenc = JaxEncoder(JaxConfig(width=W, height=H, qp=QP, **kw))
    assert enc.sps.profile_idc == jenc.sps.profile_idc
    assert write_sps(enc.sps, enc.sps_scaling) == jm_write_sps(jenc.sps)
    assert write_pps(enc.pps, enc.pps_scaling) == jm_write_pps(jenc.pps)
    assert enc.quant_custom == jenc.quant_custom


# ---- streams ---------------------------------------------------------------

CASES = {
    "t8": dict(transform8x8=True),
    "t8_cabac": dict(transform8x8=True, entropy="cabac"),
    "t8_sm1": dict(transform8x8=True, scaling_matrix=1),
    "sm2": dict(scaling_matrix=2),
    "t8_ar": dict(transform8x8=True, adaptive_rounding=True),
    "t8_b": dict(transform8x8=True, num_b=1),
    "sm3_defaults_offsets_ar": dict(
        scaling_matrix=3, scaling_lists4=DEF4, scaling_lists8=DEF8,
        offset_matrix=OFFSETS, adaptive_rounding=True, adapt_rnd_period=5,
        transform8x8=True),
    "sm3_lists_cabac_b": dict(
        scaling_matrix=3, scaling_lists4=LISTS4, scaling_lists8=LISTS8,
        transform8x8=True, entropy="cabac", num_b=1),
    "sm3_present_sps_only": dict(
        scaling_matrix=3, scaling_lists4=LISTS4, scaling_lists8=LISTS8,
        scaling_present=(1, 2, 3, 3, 2, 3, 3, 1), transform8x8=True),
    "t8_sm2_device": dict(transform8x8=True, scaling_matrix=2,
                          pipeline="device"),
}
_RUNS = {}


def _run(case):
    """A case's 3 frames, encoded once per process (torch_streams.
    frame_run; pipeline "host" unless the case names one)."""
    if case not in _RUNS:
        cfg = dict(CASES[case])
        _RUNS[case] = S.frame_run(cfg, 3, cfg.pop("pipeline", "host"))
    return _RUNS[case]


@pytest.mark.parametrize("case", list(CASES))
def test_high_payloads_match_jm(case):
    S.check_frame_run_payloads(_run(case))
    assert _run(case)[2].sps.profile_idc == 100


@pytest.mark.parametrize("case", list(CASES))
def test_high_recon_matches_jm(case):
    S.check_frame_run_recon(_run(case))


@pytest.mark.parametrize("case", list(CASES))
def test_high_stream_decodes_to_recon(case):
    S.check_frame_run_decodes(_run(case))


def test_scaling_present_fallback_fault_is_copied():
    """A reference fault copied for byte parity: a list that
    scaling_present sends in the SPS only, while the PPS carries lists,
    takes its PPS fall-back (rule B: the PPS list before it of its kind)
    in every decoder, but jm_tpu quantizes it with the configured list.
    Here inter Cb (list 4): the stream is jm_tpu's byte for byte and
    both decoders decode it alike, to chroma other than the encoders'
    recon."""
    cfg = dict(scaling_matrix=3, scaling_lists4=LISTS4,
               scaling_lists8=LISTS8, transform8x8=True,
               scaling_present=(1, 2, 3, 3, 1, 3, 3, 3))
    want, _, enc, got = S.frame_run(cfg, 3)
    data = b"".join(got)
    assert data == b"".join(want)
    out = H264Decoder(device="cpu").decode_annexb(data)
    jm_out = JaxDecoder().decode_annexb(data)
    for a, b, r in zip(out, jm_out, enc.results):
        for p in "YUV":
            assert np.array_equal(getattr(a, p), getattr(b, p))
        assert np.array_equal(a.Y, r["frame"].Y)
    assert not np.array_equal(out[1].U, enc.results[1]["frame"].U)


def test_t8_picks_the_8x8_transform():
    """The clip's P pictures code some inter MBs with the 8x8 transform,
    in the recon's PictureData as in the stream."""
    _, _, enc, got = _run("t8")
    dec = H264Decoder(device="cpu")
    pics = []
    finish = dec._finish_picture

    def capture():
        if dec._cur is not None:
            pics.append(dec._cur["pic"])
        finish()

    dec._finish_picture = capture
    dec.decode_annexb(b"".join(got))
    assert sum(int(p.transform8x8.sum()) for p in pics[1:]) > 0
    assert not pics[0].transform8x8.any()       # no Intra8x8 is coded


# ---- refusals ----------------------------------------------------------------

@pytest.mark.parametrize("kw,exc,field", [
    (dict(transform8x8=True, num_slice_groups=2), ValueError,
     "num_slice_groups"),
    (dict(scaling_matrix=1, num_slice_groups=2), ValueError,
     "num_slice_groups"),
    (dict(scaling_matrix=1, data_partition=1), ValueError, "scaling_matrix"),
    (dict(transform8x8=True, data_partition=1), NotImplementedError,
     "transform8x8"),
])
def test_high_refusals(kw, exc, field):
    with pytest.raises(exc, match=field):
        Encoder(EncoderConfig(width=W, height=H, **kw), device="cpu")
