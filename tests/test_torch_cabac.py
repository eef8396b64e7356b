"""The port's CABAC (jm_tpu_torch decoder/cabac.py, mb_parse_cabac.py,
encoder/cabac_write.py, syntax_cabac.py and Encoder(entropy="cabac"))
against jm_tpu's on the CPU, exactly (the tolerance is zero):
(a) the context initialization of I slices and P models 0-2 at every QP;
(b) a seeded mix of decision / bypass / terminate bins: the port's
    arithmetic encoder writes jm_tpu's bytes, and both engines decode them
    back;
(c) slices serialized from the PictureData of a jm_tpu CABAC encode (an
    I slice; a P slice with intra MBs under cabac_init_idc 0, 1 and 2) are
    jm_tpu's bytes and parse, in both decoders, to the same PictureData;
(d) the port's Encoder(entropy="cabac") is byte-identical to jm_tpu's
    Encoder(pipeline="device", entropy="cabac") with equal recon on the
    tests/torch_streams.py clips, and its streams decode with both
    decoders to the encoder's recon;
(e) the CABAC recon equals the CAVLC recon of the same clip and config
    (the entropy coder changes no decision)."""

import copy

import numpy as np
import pytest

import torch_streams as S
from jm_tpu.bitstream.bitreader import BitReader as JBitReader
from jm_tpu.bitstream.bitwriter import BitWriter as JBitWriter
from jm_tpu.decoder import cabac as jm_cabac
from jm_tpu.decoder import decoder as jm_decoder
from jm_tpu.encoder import cabac_write as jm_cabac_write
from jm_tpu.encoder import syntax_cabac as jm_syntax_cabac
from jm_tpu.encoder.encoder import Encoder as JaxEncoder
from jm_tpu.encoder.encoder import EncoderConfig as JaxConfig
from jm_tpu_torch.bitstream.bitreader import BitReader, PyBitReader
from jm_tpu_torch.bitstream.bitwriter import BitWriter
from jm_tpu_torch.bitstream.nal import NalUnitType, annexb_bytes
from jm_tpu_torch.common.types import SliceType
from jm_tpu_torch.convert import _PICTURE_FIELDS, picture_from_numpy
from jm_tpu_torch.decoder import decoder as port_decoder
from jm_tpu_torch.decoder.cabac import (CabacContexts, CabacEngine,
                                        PyCabacEngine)
from jm_tpu_torch.encoder.cabac_write import CabacEncoder
from jm_tpu_torch.encoder.syntax_cabac import serialize_slice_cabac

GROUPS = ("mb_type", "b8_type", "mv_res", "ref_no", "delta_qp", "mb_aff",
          "transform_size", "ipr", "cipr", "cbp", "bcbp", "map", "last",
          "one", "abs")


@pytest.mark.parametrize("model", ["I", 0, 1, 2])
def test_contexts_match_jm(model):
    for qp in range(52):
        args = (True, 0, qp) if model == "I" else (False, model, qp)
        ours, theirs = CabacContexts(*args), jm_cabac.CabacContexts(*args)
        for g in GROUPS:
            a, b = getattr(ours, g), getattr(theirs, g)
            assert a.dtype == b.dtype and np.array_equal(a, b), (qp, g)


def _random_bins(seed, n=4000):
    """(kind, context, bin) triples: decisions on 12 contexts with skewed
    probabilities, bypass bins and non-final terminate bins, then the
    final terminate."""
    rng = np.random.default_rng(seed)
    p_one = rng.random(12)
    out = []
    for _ in range(n):
        r = rng.random()
        if r < 0.75:
            c = int(rng.integers(12))
            out.append(("d", c, int(rng.random() < p_one[c])))
        elif r < 0.98:
            out.append(("b", 0, int(rng.integers(2))))
        else:
            out.append(("t", 0, 0))
    out.append(("t", 0, 1))
    return out


def _contexts(seed):
    rng = np.random.default_rng(seed + 100)
    return np.stack([rng.integers(0, 63, 12), rng.integers(0, 2, 12)],
                    1).astype(np.int32)


def _encode(enc_cls, bw, bins, ctx):
    eng = enc_cls(bw)
    for kind, c, b in bins:
        if kind == "d":
            eng.decision(ctx, c, b)
        elif kind == "b":
            eng.bypass(b)
        else:
            eng.terminate(b)
    bw.align_zero()
    return bw.get_bytes(), eng.bins


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_arithmetic_coder_matches_jm(seed):
    bins = _random_bins(seed)
    ours, n_ours = _encode(CabacEncoder, BitWriter(), bins, _contexts(seed))
    theirs, n_theirs = _encode(jm_cabac_write.CabacEncoder, JBitWriter(),
                               bins, _contexts(seed))
    assert ours == theirs and n_ours == n_theirs == len(bins)
    for eng in (CabacEngine(BitReader(ours)),
                PyCabacEngine(PyBitReader(ours)),
                jm_cabac.PyCabacEngine(JBitReader(ours))):
        ctx = _contexts(seed)
        got = []
        for kind, c, _b in bins:
            got.append(eng.decision(ctx, c) if kind == "d" else
                       eng.bypass() if kind == "b" else eng.terminate())
        assert got == [b for _k, _c, b in bins]


class CaptureEncoder(JaxEncoder):
    """jm_tpu's encoder keeping a copy of each picture's PictureData and
    slice arguments as they reach its CABAC serializer."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.captured = []

    def _serialize_cabac_best_init(self, pic, stype, **kw):
        self.captured.append((copy.deepcopy(pic), dict(kw)))
        return super()._serialize_cabac_best_init(pic, stype, **kw)


# clip -> (device_rd, extra config); jm_tpu compiles one P step per tier
CABAC_RUNS = {"ippp": (True, {}), "cut4": (False, {}),
              "idr_every_3": (False, {"cabac_adapt_init": True}),
              "refresh6": (True, {"intra_mb_refresh": 6})}


def _frames(clip):
    if clip == "refresh6":
        return S.make_frames(S.W, S.H, 5, seed=4)
    return S.clip_frames(clip)


@pytest.fixture(scope="module")
def cabac_runs():
    """Per clip: (frames, jm_tpu payloads, jm_tpu encoder, port encoder,
    port payloads)."""
    out = {}
    for clip, (rd, kw) in CABAC_RUNS.items():
        frames = _frames(clip)
        ip = S.CLIPS.get(clip, (0, 0))[1]
        jenc = CaptureEncoder(JaxConfig(
            width=S.W, height=S.H, qp=S.QP, pipeline="device",
            intra_period=ip, device_rd=rd, entropy="cabac", **kw))
        want = jenc.encode_stream(frames)
        enc = S.Encoder(S.EncoderConfig(
            width=S.W, height=S.H, qp=S.QP, device_rd=rd, intra_period=ip,
            entropy="cabac", **kw), device="cpu")
        out[clip] = (frames, want, jenc, enc, enc.encode_stream(frames))
    return out


@pytest.mark.parametrize("clip", list(CABAC_RUNS))
def test_cabac_stream_byte_identical(cabac_runs, clip):
    frames, want, jenc, enc, got = cabac_runs[clip]
    assert len(got) == len(want) == len(frames)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"frame {i} payload differs"
    S.same_recon(enc.results, jenc.results)
    assert enc.sps.profile_idc == 77 and enc.pps.entropy_coding_mode_flag
    for r in enc.results:
        assert ("cabac_init_idc" in r) == (r["type"] == "P")
    if clip == "cut4":
        assert [r.get("intra_mbs", 0) > 0 for r in enc.results] == \
            [False, False, True, True]
    if clip == "refresh6":
        assert all(r["intra_mbs"] >= 6 for r in enc.results[1:])


@pytest.mark.parametrize("clip", list(CABAC_RUNS))
def test_cabac_stream_decodes_to_port_recon(cabac_runs, clip):
    frames, want, _, enc, got = cabac_runs[clip]
    S.check_decodes((frames, want, None, enc, got))


@pytest.mark.parametrize("clip", list(CABAC_RUNS))
def test_cabac_recon_equals_cavlc_recon(cabac_runs, clip):
    frames, _, _, enc, _ = cabac_runs[clip]
    rd, kw = CABAC_RUNS[clip]
    kw = {k: v for k, v in kw.items() if k != "cabac_adapt_init"}
    cavlc = S.Encoder(S.EncoderConfig(
        width=S.W, height=S.H, qp=S.QP, device_rd=rd,
        intra_period=S.CLIPS.get(clip, (0, 0))[1], **kw), device="cpu")
    cavlc.encode_stream(frames)
    S.same_recon(enc.results, cavlc.results)


def _parsed_pictures(decoder_cls, data, **kw):
    """The PictureData of every picture a decoder parses from data."""
    pics = []

    class Capture(decoder_cls):
        def _finish_picture(self):
            if self._cur is not None:
                pics.append(self._cur["pic"])
            super()._finish_picture()

    Capture(**kw).decode_annexb(data)
    return pics


@pytest.mark.parametrize("slice_kind,idc", [("I", 0), ("P", 0), ("P", 1),
                                            ("P", 2)])
def test_slice_serializer_matches_jm_and_parses(cabac_runs, slice_kind,
                                                idc):
    """The scene cut's IDR, or its frame 3 (a P slice with intra and
    inter MBs) under context model idc: the port's slice is jm_tpu's, and
    the stream ending in it parses to the same PictureData in both
    decoders."""
    _, want, jenc, _, _ = cabac_runs["cut4"]
    k = 0 if slice_kind == "I" else 3
    jpic, kw = jenc.captured[k]
    assert (jpic.n_mbs, int(kw["slice_type"])) == \
        (S.W * S.H // 256, int(SliceType[slice_kind]))
    if slice_kind == "P":
        assert (jpic.mb_class != 0).any() and (jpic.mb_class == 0).any()
    args = dict(slice_type=SliceType(int(kw["slice_type"])),
                frame_num=kw["frame_num"], idr=kw["idr"], qp=kw["qp"],
                poc_lsb=kw["poc_lsb"], idr_pic_id=kw["idr_pic_id"],
                num_ref_idx_l0=kw["num_ref_idx_l0"], cabac_init_idc=idc)
    ours = serialize_slice_cabac(picture_from_numpy(jpic), jenc.sps,
                                 jenc.pps, **args)
    theirs = jm_syntax_cabac.serialize_slice_cabac(
        copy.deepcopy(jpic), jenc.sps, jenc.pps,
        **dict(args, slice_type=kw["slice_type"]))
    assert ours == theirs
    idr_at = want[0].index(b"\x00\x00\x00\x01\x65")
    if slice_kind == "I":
        data = want[0][:idr_at] + annexb_bytes(3, NalUnitType.IDR, ours)
    else:
        data = b"".join(want[:k]) + annexb_bytes(3, NalUnitType.SLICE, ours)
    port_pic = _parsed_pictures(port_decoder.H264Decoder, data,
                                device="cpu")[-1]
    jm_pic = _parsed_pictures(jm_decoder.H264Decoder, data,
                              device_recon=True)[-1]
    for name in _PICTURE_FIELDS:
        if name in ("ref_pic_id", "ref_pic_id_l1"):
            continue          # uids of each decoder's own DPB
        assert np.array_equal(getattr(port_pic, name),
                              getattr(jm_pic, name)), name
    # and the parse gives back what was serialized
    for name in ("mb_class", "skip", "cbp", "qp", "i16_mode", "luma_coef",
                 "luma_dc", "chroma_dc", "chroma_coef", "mv"):
        assert np.array_equal(getattr(port_pic, name),
                              getattr(jpic, name)), name
