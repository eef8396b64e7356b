"""The port's host C++ runtime (jm_tpu_torch/native) against its Python
twins and against jm_tpu's runtime, on the CPU, exactly:
- BitReader and the EBSP <-> RBSP escapes on seeded buffers;
- CabacEngine on seeded bytes under the I model and the three P models;
- the CAVLC slice serializer on the port encoder's pictures (IDR, packer
  overflow and scene-cut fallback frames);
- the CAVLC slice parser and the intra recon, through whole decodes of
  JM goldens and of the port encoder's stream, with every PictureData
  field and every plane held equal;
- the encoder's native Intra4x4 MB coder (encode_i4_mb) against the
  Python loop of encoder/p_intra.py, through whole host intra pictures
  at 4:2:0 and 4:2:2, several slices and QPs;
- the host motion search's native integer arg-min (int_search),
  fractional refinement (subpel_refine), block motion compensation
  (mc_blk) and the searchers' quadrant SADs (quad_sad) against their
  numpy twins (encoder/me.py, encoder/me_epzs.py) on seeded blocks,
  planes and tables, and the host P and B coders' streams with and
  without them;
- the counted Python route of an I_PCM MB, and a failing build that
  raises."""

import copy
import sys
from functools import partial
from pathlib import Path

import numpy as np
import pytest

import jm_tpu.native as jm_native
from jm_tpu.bitstream import nal as jm_nal
from jm_tpu.bitstream.bitreader import BitReader as JBitReader
from jm_tpu.decoder import cabac as jm_cabac
from jm_tpu.decoder import decoder as jm_decoder
from jm_tpu.encoder.encoder import Encoder as JEncoder
from jm_tpu.encoder.encoder import EncoderConfig as JEncoderConfig
from jm_tpu_torch import native as N
from jm_tpu_torch.bitstream import nal
from jm_tpu_torch.bitstream.bitreader import BitReader, PyBitReader
from jm_tpu_torch.bitstream.bitwriter import BitWriter
from jm_tpu_torch.common.picture import MB_IPCM
from jm_tpu_torch.common.types import SliceType
from jm_tpu_torch.decoder import decoder as port_decoder
from jm_tpu_torch.decoder import header as port_header
from jm_tpu_torch.decoder import parset as port_parset
from jm_tpu_torch.decoder.cabac import (CabacContexts, CabacEngine,
                                        PyCabacEngine)
from jm_tpu_torch.decoder.mb_parse import MBParser
from jm_tpu_torch.decoder.mb_parse_cabac import MBParserCABAC
from jm_tpu_torch.decoder.recon import Reconstructor
from jm_tpu_torch.common.tables import chroma_qp
from jm_tpu_torch.encoder import encoder as port_encoder
from jm_tpu_torch.encoder import me as port_me
from jm_tpu_torch.encoder.b_host import InterMBCoder
from jm_tpu_torch.encoder.me_epzs import EPZSearcher
from jm_tpu_torch.encoder.intra_host import IntraPicture
from jm_tpu_torch.ops.consts import PAD
from jm_tpu_torch.encoder.syntax import serialize_slice, write_slice_header

sys.path.insert(0, str(Path(__file__).parent))
import torch_streams as S  # noqa: E402
from test_pipe_stream import make_frames  # noqa: E402

GOLDEN = Path(__file__).parent / "golden"
# the arrays the CAVLC parser fills (native/jm_dec.cpp parse_slice_cavlc)
PARSED = ("mb_class", "skip", "transform8x8", "i4_modes", "i16_mode",
          "chroma_mode", "cbp", "qp", "slice_id", "luma_coef", "luma_dc",
          "chroma_dc", "chroma_coef", "luma_coef8", "luma_nnz",
          "chroma_nnz", "mv", "ref_idx", "sub_mode")


def _rand_bytes(rng, n, p_zero):
    b = rng.integers(0, 256, n).astype(np.uint8)
    b[rng.random(n) < p_zero] = 0
    return b.tobytes()


def _apply(br, op, arg):
    """One reader call; returns (result or exception type, pos after)."""
    try:
        out = getattr(br, op)(*arg)
    except (EOFError, ValueError) as e:
        out = type(e)
    return out, br.pos


@pytest.mark.parametrize("seed", range(4))
def test_bitreader_fuzz(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        data = _rand_bytes(rng, int(rng.integers(1, 40)), 0.5)
        readers = (BitReader(data), PyBitReader(data), JBitReader(data))
        assert readers[0].data == readers[1].data == data
        assert readers[0].nbits == readers[1].nbits == 8 * len(data)
        for _ in range(200):
            op = rng.choice(["u", "ue", "se", "te", "peek", "peek_pad",
                             "zeros_until_one", "more_rbsp_data", "flag",
                             "align", "pos"])
            if op == "pos":
                p = int(rng.integers(0, 8 * len(data) + 1))
                for br in readers:
                    br.pos = p
                continue
            arg = ()
            if op in ("u", "peek", "peek_pad"):
                arg = (int(rng.integers(0, 33)),)
            elif op == "te":
                arg = (int(rng.integers(1, 4)),)
            got = [_apply(br, op, arg) for br in readers]
            assert got[0] == got[1] == got[2], (op, arg, got)


@pytest.mark.parametrize("seed", range(3))
def test_ebsp_rbsp_escapes(seed):
    rng = np.random.default_rng(seed)
    for _ in range(200):
        n = int(rng.integers(0, 64))
        raw = rng.choice(np.array([0, 0, 0, 1, 2, 3, 3, 0x80, 0xFF],
                                  np.uint8), n).tobytes()
        ebsp = nal.rbsp_to_ebsp(raw)
        assert ebsp == nal.py_rbsp_to_ebsp(raw) == jm_nal.rbsp_to_ebsp(raw)
        assert nal.ebsp_to_rbsp(ebsp) == raw
        # any buffer, escaped or not, strips the same
        assert nal.ebsp_to_rbsp(raw) == nal.py_ebsp_to_rbsp(raw) \
            == jm_nal.ebsp_to_rbsp(raw)


def _cabac_run(eng, ctxs, rng_ops):
    """A seeded sequence of the engine's calls on the contexts; returns
    every result with the engine state after it, up to the end of the
    bytes or a terminate bin of 1 (the end of a slice)."""
    out = []
    groups = [ctxs.mb_type[1], ctxs.mv_res[1], ctxs.abs[5], ctxs.cipr,
              ctxs.delta_qp, ctxs.map[5]]
    for op, g, a, b, m in rng_ops:
        ctx = groups[g % len(groups)]
        n = len(ctx)
        try:
            if op == 0:
                v = eng.decision(ctx, a % n)
            elif op == 1:
                v = eng.bypass()
            elif op == 2:
                v = eng.unary(ctx, a % n, b % n)
            elif op == 3:
                v = eng.unary_max(ctx, a % n, b % n, m)
            elif op == 4:
                v = eng.exp_golomb_eq_prob(m % 4)
            elif op == 5:
                v = eng.ueg0_level(ctx, a % n)
            elif op == 6:
                v = eng.ueg3_mv(ctxs.mv_res[1], 5 * (a % 2))
            else:
                v = eng.terminate()
        except EOFError:
            out.append("eof")
            break
        out.append((v, eng.rng, eng.offset, eng.br.pos))
        if op == 7 and v:
            break
    return out


@pytest.mark.parametrize("model", ["I", 0, 1, 2])
def test_cabac_engine_bins(model):
    rng = np.random.default_rng(7 if model == "I" else model)
    n_calls = 0
    for _ in range(6):
        data = _rand_bytes(rng, 400, 0.2)
        qp = int(rng.integers(0, 52))
        ops = [(int(rng.choice(8, p=[.56, .155, .06, .06, .04, .06, .06,
                                       .005])),
                *(int(x) for x in rng.integers(0, 64, 3)),)
               for _ in range(600)]
        ops = [(o, g, a, b, b % 5) for o, g, a, b in ops]
        ctxs = CabacContexts(model == "I", 0 if model == "I" else model, qp)
        runs, states = [], []
        for make in (lambda: CabacEngine(BitReader(data)),
                     lambda: PyCabacEngine(PyBitReader(data)),
                     lambda: jm_cabac.PyCabacEngine(JBitReader(data))):
            c = copy.deepcopy(ctxs)
            runs.append(_cabac_run(make(), c, ops))
            states.append(np.concatenate([a.ravel() for a in vars(c)
                                          .values()]))
        assert runs[0] == runs[1] == runs[2]
        n_calls += len(runs[0])
        assert np.array_equal(states[0], states[1])
        assert np.array_equal(states[0], states[2])
    assert n_calls > 1000


def test_native_cabac_engine_refuses_another_reader():
    """The port's engine takes only the port's native reader: a jm_tpu
    reader (another module's type) or the Python twin raises."""
    data = bytes(range(1, 40))
    with pytest.raises(TypeError, match="jm_torch_native.BitReader"):
        CabacEngine(JBitReader(data))
    with pytest.raises(TypeError):
        CabacEngine(PyBitReader(data))


# ---- the encoder's serializer ---------------------------------------------

@pytest.fixture(scope="module")
def port_stream():
    """The port encoder's scene-cut clip with a word budget too small for
    any P slice: the IDR, packer-overflow frames 1 and 4 and fallback
    frames 2 and 3 are all serialized on the host. Returns (stream,
    [(PictureData, serialize kwargs)], routes of the encode)."""
    pics = []

    def spy(pic, sps, pps, **kw):
        pics.append((copy.deepcopy(pic), sps, pps, kw))
        return serialize_slice(pic, sps, pps, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(port_encoder, "serialize_slice", spy)
    try:
        enc = S.port_encoder(True, "cut5")
        enc.max_words = 4
        N.reset_routes()
        payloads = enc.encode_stream(S.clip_frames("cut5"))
        routes = copy.deepcopy(N.routes)
    finally:
        mp.undo()
    assert enc.ovf == [1, 4] and enc.fallbacks == S.CUT_FALLBACKS
    return b"".join(payloads), pics, routes


def test_serializer_bytes(port_stream):
    _, pics, routes = port_stream
    assert routes["serialize"] == {"native": 5, "python": 0}
    assert [kw["slice_type"] for _, _, _, kw in pics] == \
        [SliceType.I] + [SliceType.P] * 4
    assert jm_native.available
    for pic, sps, pps, kw in pics:
        got = serialize_slice(pic, sps, pps, **kw)
        assert got == serialize_slice(pic, sps, pps, **kw, native=False)
        # jm_tpu's runtime on the same arrays after the same header, over
        # the slice's MB addresses (the whole picture here)
        hdr = {k: v for k, v in kw.items() if k != "mb_addrs"}
        addrs = np.ascontiguousarray(kw["mb_addrs"], np.int32)
        assert np.array_equal(addrs, np.arange(pic.n_mbs))
        bw = BitWriter()
        write_slice_header(bw, sps, pps, first_mb=int(addrs[0]), **hdr)
        d = {k: np.ascontiguousarray(getattr(pic, k)) for k in (
            "mb_class", "inter_mode", "sub_mode", "ref_idx", "mv", "cbp",
            "qp", "slice_id", "i4_modes", "i16_mode", "chroma_mode",
            "luma_coef", "luma_dc", "luma_coef8", "luma_nnz", "chroma_dc",
            "chroma_coef", "chroma_nnz")}
        d.update(skip=pic.skip.astype(np.uint8),
                 transform8x8=pic.transform8x8.astype(np.uint8),
                 mb_w=pic.mb_w, crows=pic.n_crows)
        want = jm_native.cavlc_slice_data(
            bytes(bw.buf), bw.acc, bw.nacc, d, addrs,
            0 if kw["slice_type"] == SliceType.P else 2, 1, 0, kw["qp"])
        assert got == want


def test_serializer_checks_array_sizes(port_stream):
    """The native serializer refuses an array of the wrong byte size."""
    pic, sps, pps, kw = port_stream[1][0]
    pic = copy.deepcopy(pic)
    pic.luma_coef8 = np.zeros((pic.n_mbs, 4, 16), np.int32)
    with pytest.raises(ValueError, match="'luma_coef8'"):
        serialize_slice(pic, sps, pps, **kw)


# ---- the decoder's parser and intra recon ----------------------------------

def _python_twins(mp):
    """Patch the decoder onto the Python twins: reader, escapes, parsers,
    intra recon."""
    mp.setattr(port_header, "BitReader", PyBitReader)
    mp.setattr(port_parset, "BitReader", PyBitReader)
    mp.setattr(nal, "ebsp_to_rbsp", nal.py_ebsp_to_rbsp)
    mp.setattr(port_decoder, "MBParser", partial(MBParser, native=False))
    mp.setattr(port_decoder, "MBParserCABAC",
               partial(MBParserCABAC, native=False))
    run = Reconstructor.run

    def run_python(self, seed=None):
        return run(self, seed, native=False)

    mp.setattr(Reconstructor, "run", run_python)


class _Capture(port_decoder.H264Decoder):
    def __init__(self):
        super().__init__(device="cpu")
        self.pics = []

    def _finish_picture(self):
        if self._cur is not None:
            self.pics.append(self._cur["pic"])
        super()._finish_picture()


class _JmCapture(jm_decoder.H264Decoder):
    def __init__(self):
        super().__init__()
        self.pics = []

    def _finish_picture(self):
        if self._cur is not None:
            self.pics.append(self._cur["pic"])
        super()._finish_picture()


def _arrays(pic):
    return {k: v for k, v in vars(pic).items() if isinstance(v, np.ndarray)}


def _check_decode(data, monkeypatch):
    """The port's decode on the native runtime against its decode on the
    Python twins (every PictureData array, the I_PCM samples, the
    frames) and against jm_tpu's (the parsed arrays, the frames).
    Returns the native decode's routes."""
    N.reset_routes()
    nat = _Capture()
    out = nat.decode_annexb(data)
    routes = copy.deepcopy(N.routes)
    with monkeypatch.context() as mp:
        _python_twins(mp)
        N.reset_routes()
        twin = _Capture()
        out_py = twin.decode_annexb(data)
        assert N.routes["parse"]["native"] == N.routes["recon"]["native"] \
            == N.routes["cabac"]["native"] == 0
    jm = _JmCapture()
    out_jm = jm.decode_annexb(data)
    assert len(out) == len(out_py) == len(out_jm) == len(nat.pics)
    for a, b, c in zip(out, out_py, out_jm):
        for p in "YUV":
            assert np.array_equal(getattr(a, p), getattr(b, p))
            assert np.array_equal(getattr(a, p), getattr(c, p))
    for i, (a, b, c) in enumerate(zip(nat.pics, twin.pics, jm.pics)):
        fa, fb = _arrays(a), _arrays(b)
        assert fa.keys() == fb.keys()
        for k in fa:
            assert np.array_equal(fa[k], fb[k]), f"picture {i}: {k}"
        for k in PARSED:
            assert np.array_equal(fa[k], np.asarray(getattr(c, k))), \
                f"picture {i}: {k} differs from jm_tpu's"
        assert a.ipcm_luma.keys() == b.ipcm_luma.keys()
        for k in a.ipcm_luma:
            assert np.array_equal(a.ipcm_luma[k], b.ipcm_luma[k])
            assert np.array_equal(a.ipcm_chroma[k], b.ipcm_chroma[k])
    return routes


@pytest.mark.parametrize("name", ["i1", "ipp3", "qp20", "qp36"])
def test_parse_and_recon_goldens(name, monkeypatch):
    data = (GOLDEN / f"{name}.264").read_bytes()
    routes = _check_decode(data, monkeypatch)
    n_slices = sum(u.nal_unit_type in (1, 5) for u in nal.split_annexb(data))
    assert routes["parse"] == {"native": n_slices, "python": 0, "rerun": 0}
    assert routes["recon"]["python"] == 0 and routes["recon"]["native"] >= 1


def test_parse_and_recon_port_stream(port_stream, monkeypatch):
    """IDR, all-inter P pictures and the fallback frames' mixed ones."""
    data = port_stream[0]
    dec = port_decoder.H264Decoder(device="cpu")
    dec.decode_annexb(data)
    assert [p["path"] for p in dec.pictures] == \
        ["intra", "inter", "mixed", "mixed", "inter"]
    routes = _check_decode(data, monkeypatch)
    assert routes["parse"] == {"native": 5, "python": 0, "rerun": 0}
    assert routes["recon"] == {"native": 3, "python": 0}


def test_intra_recon_planes(port_stream):
    """Reconstructor.run native against the Python walk on the IDR and
    on a fallback frame's mixed picture (inter MBs from a seed)."""
    data = port_stream[0]
    dec = _Capture()
    frames = dec.decode_annexb(data)
    rng = np.random.default_rng(3)
    for idx in (0, 2):
        pic, pps = dec.pics[idx], dec.pps_map[0]
        seed = None
        if idx:
            f = frames[idx]
            seed = [rng.integers(0, 256, p.shape, np.uint8)
                    for p in (f.Y, f.U, f.V)]
        want = Reconstructor(pic, pps).run(seed, native=False)
        got = Reconstructor(pic, pps).run(seed)
        for a, b in zip(got, want):
            assert np.array_equal(a, b)


def test_ipcm_takes_the_counted_python_route(monkeypatch):
    """An I_PCM MB: the C parser stops and the Python parser reads the
    slice again (parse "rerun"), the picture's intra recon is the Python
    walk, and the serializer routes the picture to the Python MBWriter,
    which writes the slice jm_tpu wrote."""
    frames = make_frames(96, 80, 3, seed=5)
    enc = JEncoder(JEncoderConfig(width=96, height=80, qp=30,
                                  enable_ipcm=2))
    data = b"".join(enc.encode_frame(*f) for f in frames)
    routes = _check_decode(data, monkeypatch)
    assert routes["parse"]["rerun"] >= 1
    assert routes["recon"]["python"] >= 1
    dec = _Capture()
    dec.decode_annexb(data)
    pic = next(p for p in dec.pics if (p.mb_class == MB_IPCM).any())
    sps, pps = dec.sps_map[0], dec.pps_map[0]
    N.reset_routes()
    rbsp = serialize_slice(pic, sps, pps, slice_type=SliceType.I,
                           frame_num=0, idr=True, qp=30)
    assert N.routes["serialize"] == {"native": 0, "python": 1}
    assert nal.annexb_bytes(3, nal.NalUnitType.IDR, rbsp) in data


@pytest.mark.parametrize("fmt,qp,n_slices", [(1, 28, 1), (2, 12, 2),
                                             (1, 40, 3), (2, 30, 1)])
def test_native_intra4x4_coder(fmt, qp, n_slices, monkeypatch):
    """IntraPicture with the native encode_i4_mb against the same picture
    with IntraMBCoder's Python loop: every PictureData array of the
    coding and the recon planes equal."""
    rng = np.random.default_rng(qp)
    h, w = 64, 96
    Y = rng.integers(0, 256, (h, w)).astype(np.int32)
    Y = ((Y + np.roll(Y, 1, 0) + np.roll(Y, 1, 1)) // 3).astype(np.uint8)
    U, V = ((Y[:, ::2], Y[:, 1::2]) if fmt == 2
            else (Y[::2, ::2], Y[1::2, ::2]))
    n = (w // 16) * (h // 16)
    plan = [list(range(k * n // n_slices, (k + 1) * n // n_slices))
            for k in range(n_slices)]
    args = ((Y, U.copy(), V.copy()), qp, chroma_qp(qp, 0),
            port_encoder.lambda_me(qp), port_encoder.lambda_mode4(qp), plan)
    got = IntraPicture(*args)
    monkeypatch.setattr(IntraPicture, "native_i4", False)
    want = IntraPicture(*args)
    assert (got.pic.mb_class == 1).sum() > n // 2
    for k in ("mb_class", "i4_modes", "i16_mode", "cbp", "luma_coef",
              "luma_dc", "luma_nnz", "chroma_mode", "chroma_dc",
              "chroma_coef", "chroma_nnz"):
        assert np.array_equal(getattr(got.pic, k), getattr(want.pic, k)), k
    for a, b in zip(got.rec, want.rec):
        assert np.array_equal(a, b)


# (block width, height) of every partition and sub-partition
_ME_BLOCKS = ((16, 16), (16, 8), (8, 16), (8, 8), (8, 4), (4, 8), (4, 4))


@pytest.mark.parametrize("bw,bh", _ME_BLOCKS)
def test_native_subpel_refine(bw, bh):
    """jm_enc.cpp subpel_refine against encoder/me.py subpel_refine: the
    same quarter-pel MV and cost, by SATD and by SAD, from integer and
    from quarter-pel starts, with MVs that reach past the padding (the
    clamped fetch), on flat and on noisy planes, and on a block whose
    rows are a field's (every other row of its frame)."""
    rng = np.random.default_rng(bw * 17 + bh)
    w, h = 48, 32
    mod = N.load()
    for trial in range(60):
        planes = rng.integers(0, 256, (4, h + 2 * PAD, w + 2 * PAD),
                              dtype=np.uint8)
        if trial % 3 == 0:
            planes = (planes // 16 + 100).astype(np.uint8)
        frame = rng.integers(0, 256, (2 * h, w), dtype=np.uint8)
        orig = frame[trial % 2::2] if trial % 4 < 2 else frame[:h]
        px = int(rng.integers(0, (w - bw) // 4 + 1)) * 4
        py = int(rng.integers(0, (h - bh) // 4 + 1)) * 4
        blk = orig[py:py + bh, px:px + bw]
        span = 60 if trial % 5 == 0 else 6
        mv = rng.integers(-span, span + 1, 2).astype(np.int32)
        pred = rng.integers(-4 * span, 4 * span + 1, 2).astype(np.int32)
        lam, extra = int(rng.integers(1, 90)), int(rng.integers(0, 3))
        satd, qpel = bool(trial % 2), trial % 3 == 1
        want = port_me.subpel_refine(blk, planes, px, py, mv, w, h, pred,
                                     lam, extra_bits=extra, use_satd=satd,
                                     qpel_start=qpel)
        got = mod.subpel_refine(blk, planes,
                                (px, py, int(mv[0]), int(mv[1]), w, h,
                                 int(pred[0]), int(pred[1]), extra,
                                 int(satd), int(qpel)), lam)
        assert got == (int(want[0][0]), int(want[0][1]), int(want[1]))


@pytest.mark.parametrize("kind", ["quad", "blk4", "sad16", "int64"])
def test_native_int_search(kind):
    """jm_enc.cpp int_search against the numpy arg-min of encoder/me.py
    (int_rate_tab + spiral_rank_tab + best_int_mv_tiebreak), through
    InterMBCoder._int_mv with native_me on and off: the same integer MV
    for the quadrant (int32), 4x4 (int16) and 16x16 (int32, 1-D) tables
    and an int64 sum of quadrants, at several search ranges, with flat
    tables (every displacement tied) and predictors halfway between
    integer positions (Python's rounding to even)."""
    rng = np.random.default_rng(len(kind))
    coder = InterMBCoder()
    for trial in range(80):
        coder.sr = (16, 8, 3, 1, 0)[trial % 5]
        coder.lam = int(rng.integers(1, 90))
        side = 2 * coder.sr + 1
        if kind == "quad":
            table = rng.integers(0, 3000, (side * side, 4)).astype(np.int32)
            cols = tuple(sorted(rng.choice(4, int(rng.integers(1, 5)),
                                           replace=False).tolist()))
        elif kind == "blk4":
            table = rng.integers(0, 3000, (side * side, 16)).astype(np.int16)
            cols = sorted(rng.choice(16, 4, replace=False).tolist())
        elif kind == "sad16":
            table = rng.integers(0, 20000, side * side).astype(np.int32)
            cols = ()
        else:
            table = rng.integers(0, 3000, (side * side, 4)).astype(np.int64)
            cols = (0, 1, 2, 3)
        if trial % 7 == 0:
            table[:] = table.flat[0]
        pred = rng.integers(-300, 301, 2).astype(np.int32)
        if trial % 4 == 0:
            pred = (pred // 4 * 4 + 2).astype(np.int32)
        coder.native_me = False
        want = coder._int_mv(table, cols, pred)
        coder.native_me = True
        assert np.array_equal(coder._int_mv(table, cols, pred), want)


@pytest.mark.parametrize("crows", [2, 4])
def test_native_mc_blk(crows):
    """jm_enc.cpp mc_blk against me.mc_luma_block and me.mc_chroma_block:
    equal 4x4 luma and 2x2 (4:2:0) or 2x4 (4:2:2) chroma predictions at
    every fractional position, near and past the padded border."""
    rng = np.random.default_rng(crows)
    w, h = 48, 32
    cw, ch = w // 2, h * crows // 4
    mod = N.load()
    for trial in range(200):
        planes = rng.integers(0, 256, (4, h + 2 * PAD, w + 2 * PAD),
                              dtype=np.uint8)
        pu, pv = rng.integers(0, 256, (2, ch + 2 * PAD, cw + 2 * PAD),
                              dtype=np.uint8)
        span = 300 if trial % 3 == 0 else 20
        x4, y4 = (int(v) for v in rng.integers(-span, 4 * w + span, 2))
        cx8, cy8 = (int(v) for v in rng.integers(-span, 8 * cw + span, 2))
        got = (np.empty((4, 4), np.int32), np.empty((crows, 2), np.int32),
               np.empty((crows, 2), np.int32))
        mod.mc_blk(planes, pu, pv, (x4, y4, 4, 4, w, h, cx8, cy8, 2, crows,
                                    cw, ch), *got)
        want = (port_me.mc_luma_block(planes, x4, y4, 4, 4, w, h),
                port_me.mc_chroma_block(pu, cx8, cy8, 2, crows, cw, ch),
                port_me.mc_chroma_block(pv, cx8, cy8, 2, crows, cw, ch))
        for a, b in zip(got, want):
            assert np.array_equal(a, b)


def test_native_quad_sad():
    """jm_enc.cpp quad_sad against the searchers' numpy quadrant SADs
    (EPZSearcher._qsad with native False) at every displacement of a
    small window, for MBs at the picture's corners and inside."""
    rng = np.random.default_rng(5)
    w, h, sr = 48, 32, 4

    class Ref:
        Y = rng.integers(0, 256, (h, w), dtype=np.uint8)
        luma_planes = rng.integers(0, 256, (4, h + 2 * PAD, w + 2 * PAD),
                                   dtype=np.uint8)
        motion = None

    origY = rng.integers(0, 256, (h, w), dtype=np.uint8)
    nat = EPZSearcher(origY, [Ref()], w // 16, h // 16, sr, 4,
                      np.zeros((6, 16, 2), np.int32), use_hme=False)
    twin = EPZSearcher(origY, [Ref()], w // 16, h // 16, sr, 4,
                       np.zeros((6, 16, 2), np.int32), use_hme=False)
    twin.native = False
    for addr in range(6):
        for dy in range(-sr, sr + 1):
            for dx in range(-sr, sr + 1):
                assert tuple(int(v) for v in twin._qsad(addr, 0, dx, dy)) \
                    == nat._qsad(addr, 0, dx, dy)


@pytest.mark.parametrize("kw", [dict(num_ref=2, sub8x8=True),
                                dict(num_b=1, entropy="cabac"),
                                dict(num_ref=2, search_mode=3)],
                         ids=["p_sub8x8", "b", "p_epzs"])
def test_native_me_streams(kw, monkeypatch):
    """The host pipeline's P coder (two references, sub-8x8; two
    references under EPZS) and B coder with the native motion search and
    compensation against the same encode with their numpy twins
    (InterMBCoder.native_me and EPZSearcher.native False): equal bytes
    and recon."""
    frames = S.motion_clip(3, 64, 48)

    def encode():
        enc = port_encoder.Encoder(port_encoder.EncoderConfig(
            width=64, height=48, qp=30, pipeline="host", **kw),
            device="cpu")
        return enc.encode_stream(frames), enc.results

    got, got_res = encode()
    monkeypatch.setattr(InterMBCoder, "native_me", False)
    monkeypatch.setattr(EPZSearcher, "native", False)
    want, want_res = encode()
    assert got == want
    for a, b in zip(got_res, want_res):
        for plane in "YUV":
            assert np.array_equal(getattr(a["frame"], plane),
                                  getattr(b["frame"], plane))


def test_failed_build_raises(tmp_path):
    """A compiler that fails: the build raises with its standard error,
    and leaves no module behind."""
    cxx = tmp_path / "failing-cxx"
    cxx.write_text("#!/bin/sh\necho 'error: no compiler here' >&2\nexit 1\n")
    cxx.chmod(0o755)
    out = tmp_path / "build"
    with pytest.raises(N.NativeBuildError, match="no compiler here"):
        N.build(build_dir=out, cxx=str(cxx))
    assert [p.name for p in out.iterdir()] == ["lock"]
    with pytest.raises(N.NativeBuildError, match="cannot run"):
        N.build(build_dir=out, cxx=str(tmp_path / "missing"))
