"""The port's B-slice modules against jm_tpu's on the CPU, exactly (the
codec is integer-exact: the tolerance is zero):
- direct prediction: decoder/b_slice.py's prepare_direct_params +
  spatial_direct_quadrant, temporal_direct_quadrant and compute_mvscale
  against jm_tpu/decoder/b_slice.py on random neighbourhoods and
  co-located motion (inputs from a numpy seed), and ref_lists_b;
- the B goldens (cavlc_b, main3, main9, main9t, poc1b): every B picture's
  reconstruction before the deblock (ops/dec.inter_recon_b plus the host
  intra fill) against jm_tpu's host Reconstructor, its boundary
  strengths (ops/deblock.compute_bs) against jm_tpu's host compute_bs
  and the plain deblock against deblock_picture, and for cavlc_b (CAVLC)
  and main9 (CABAC) every picture's parsed PictureData field by field;
- the B coder's motion search: the device SAD table
  (ops/enc.full_search_sad16) against full_search_blk4_sads(...).sum(2),
  the downloaded reference planes against interp.make_luma_planes, and
  the host block fetch, rate / tie-break tables and quarter-pel
  refinement (encoder/me.py) against jm_tpu's."""

from pathlib import Path
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch

from jm_tpu.decoder import b_slice as JB
from jm_tpu.decoder import decoder as jm_decoder
from jm_tpu.decoder.mb_parse import PictureData as JPictureData
from jm_tpu.common.predict_ctx import PredCtx as JPredCtx
from jm_tpu.encoder import me as JME
from jm_tpu.ops import interp as JI
from jm_tpu.ops.deblock import compute_bs as jm_compute_bs
from jm_tpu_torch.common.picture import PictureData
from jm_tpu_torch.common.predict_ctx import PredCtx
from jm_tpu_torch.common.types import SliceType
from jm_tpu_torch.decoder import b_slice as B
from jm_tpu_torch.decoder import decoder as port_decoder
from jm_tpu_torch.encoder import me as ME
from jm_tpu_torch.ops.deblock import compute_bs, deblock
from jm_tpu_torch.ops.enc import full_search_sad16, prep_ref

GOLDEN = Path(__file__).parent / "golden"
B_GOLDENS = ["cavlc_b", "main3", "main9", "main9t", "poc1b"]
MOTION = ("mv", "ref_idx", "mv_l1", "ref_idx_l1")


# ---- direct prediction and lists --------------------------------------

def _random_pictures(rng, mb_w=5, mb_h=4):
    """The same random neighbourhood motion in jm_tpu's and the port's
    PictureData (two slices, some intra MBs)."""
    n = mb_w * mb_h
    jp, pp = JPictureData(mb_w, mb_h), PictureData(mb_w, mb_h)
    vals = {
        "mv": rng.integers(-40, 41, (n, 16, 2)).astype(np.int32),
        "mv_l1": rng.integers(-40, 41, (n, 16, 2)).astype(np.int32),
        "ref_idx": rng.integers(-1, 3, (n, 4)).astype(np.int8),
        "ref_idx_l1": rng.integers(-1, 3, (n, 4)).astype(np.int8),
        "slice_id": (np.arange(n) >= n // 2 + int(rng.integers(0, 3)))
        .astype(np.int32),
    }
    for p in (jp, pp):
        for k, v in vals.items():
            getattr(p, k)[...] = v
    return jp, pp


def _col(module, rng, mb_w=5, mb_h=4, lt=False):
    n = mb_w * mb_h
    return module.ColMotion(
        rng.integers(-6, 7, (n, 16, 2)).astype(np.int32),
        rng.integers(-1, 2, (n, 4)).astype(np.int8),
        rng.integers(-6, 7, (n, 16, 2)).astype(np.int32),
        rng.integers(-1, 2, (n, 4)).astype(np.int8), mb_w, lt,
        rng.integers(0, 3, (n, 4)).astype(np.int64),
        rng.integers(0, 3, (n, 4)).astype(np.int64))


def _same_col(col, module):
    return module.ColMotion(col.mv0, col.ref0_q, col.mv1, col.ref1_q,
                            col.mb_w, col.is_long_term, col.refpic0_q,
                            col.refpic1_q)


def _same_motion(jp, pp, addr):
    for k in MOTION + ("pdir",):
        assert np.array_equal(getattr(pp, k)[addr], getattr(jp, k)[addr]), k


@pytest.mark.parametrize("seed", range(4))
def test_spatial_direct_matches_jm(seed):
    rng = np.random.default_rng(seed)
    for lt in (False, True):
        jp, pp = _random_pictures(rng)
        jcol = _col(JB, rng, lt=lt)
        pcol = _same_col(jcol, B)
        jctx, pctx = JPredCtx(jp), PredCtx(pp)
        for addr in range(jp.n_mbs):
            jd = JB.prepare_direct_params(jctx, addr)
            pd = B.prepare_direct_params(pctx, addr)
            assert jd[:2] == pd[:2]
            assert np.array_equal(jd[2], pd[2]) and \
                np.array_equal(jd[3], pd[3])
            for q in range(4):
                JB.spatial_direct_quadrant(jp, addr, q, *jd, jcol)
                B.spatial_direct_quadrant(pp, addr, q, *pd, pcol)
            _same_motion(jp, pp, addr)


@pytest.mark.parametrize("seed", range(3))
def test_temporal_direct_matches_jm(seed):
    rng = np.random.default_rng(100 + seed)
    frames = [SimpleNamespace(poc=int(p), uid=u, is_long_term=bool(u == 2))
              for u, p in enumerate(rng.choice(np.arange(-8, 24, 2), 3,
                                               replace=False))]
    cur_poc, col_poc = int(rng.integers(0, 8)), int(rng.integers(8, 30))
    scale = JB.compute_mvscale(cur_poc, frames, col_poc)
    assert B.compute_mvscale(cur_poc, frames, col_poc) == scale
    uid_to_idx = {f.uid: i for i, f in enumerate(frames)}
    lt = [f.is_long_term for f in frames]
    jp, pp = _random_pictures(rng)
    jcol = _col(JB, rng)
    pcol = _same_col(jcol, B)
    for addr in range(jp.n_mbs):
        for q in range(4):
            JB.temporal_direct_quadrant(jp, addr, q, jcol, uid_to_idx, lt,
                                        scale)
            B.temporal_direct_quadrant(pp, addr, q, pcol, uid_to_idx, lt,
                                       scale)
        _same_motion(jp, pp, addr)


def test_compute_mvscale_matches_jm():
    rng = np.random.default_rng(7)
    for _ in range(200):
        frames = [SimpleNamespace(poc=int(p))
                  for p in rng.integers(-300, 300, 4)]
        cur, col = (int(v) for v in rng.integers(-300, 300, 2))
        assert B.compute_mvscale(cur, frames, col) == \
            JB.compute_mvscale(cur, frames, col)


def test_ref_lists_b_match_jm():
    rng = np.random.default_rng(8)
    for _ in range(200):
        k = int(rng.integers(1, 7))
        frames = [SimpleNamespace(poc=int(p), is_long_term=bool(lt),
                                  long_term_frame_idx=int(i))
                  for p, lt, i in zip(rng.choice(np.arange(-20, 40, 2), k,
                                                 replace=False),
                                      rng.integers(0, 4, k) == 0,
                                      rng.permutation(k))]
        cur = int(rng.integers(-20, 40))
        got, want = B.ref_lists_b(frames, cur), JB.ref_lists_b(frames, cur)
        assert [[id(f) for f in lst] for lst in got] == \
            [[id(f) for f in lst] for lst in want]


# ---- the B goldens: recon, bS and deblock, parsed state ----------------

class _JmCapture(jm_decoder.H264Decoder):
    """jm_tpu's decoder, keeping each picture's PictureData and slice type
    and, for the pictures it deblocks on the host, the planes before and
    after deblock_picture."""

    def __init__(self):
        super().__init__(device_recon=True)
        self.recs = []

    def _finish_picture(self):
        cur = self._cur
        if cur is not None and cur["headers"]:
            self.recs.append({"pic": cur["pic"],
                              "type": int(cur["headers"][0][0].slice_type)})
        super()._finish_picture()


class _PortCapture(port_decoder.H264Decoder):
    """The port's decoder, keeping each picture's PictureData and slice
    type, its planes before the deblock and the deblock's arguments."""

    def __init__(self):
        super().__init__(device="cpu")
        self.recs = []

    def _finish_picture(self):
        if self._cur is not None:
            self.recs.append({"pic": self._cur["pic"],
                              "type": int(self._cur["hdr0"].slice_type)})
        super()._finish_picture()


@pytest.fixture(scope="module")
def goldens():
    cache = {}

    def get(name):
        if name not in cache:
            data = (GOLDEN / f"{name}.264").read_bytes()
            jm = _JmCapture()
            orig = jm_decoder.deblock_picture

            def spy(Y, U, V, *a, **k):
                jm.recs[-1]["pre"] = (Y.copy(), U.copy(), V.copy())
                orig(Y, U, V, *a, **k)
                jm.recs[-1]["post"] = (Y.copy(), U.copy(), V.copy())

            with mock.patch.object(jm_decoder, "deblock_picture", spy):
                jm.decode_annexb(data)
            port = _PortCapture()
            orig_port = port_decoder.deblock

            def port_spy(Y, U, V, *a, **k):
                port.recs[-1]["pre"] = tuple(p.numpy().copy()
                                             for p in (Y, U, V))
                port.recs[-1]["args"] = (a, k)
                return orig_port(Y, U, V, *a, **k)

            with mock.patch.object(port_decoder, "deblock", port_spy):
                port.decode_annexb(data)
            assert len(jm.recs) == len(port.recs)
            cache[name] = (jm.recs, port.recs)
        return cache[name]

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield get
    torch.set_num_threads(n)


def _b_pictures(recs):
    jm_recs, port_recs = recs
    out = [(j, p) for j, p in zip(jm_recs, port_recs)
           if p["type"] == int(SliceType.B)]
    assert out and all(j["type"] == p["type"] for j, p in out)
    return out


@pytest.mark.parametrize("name", B_GOLDENS)
def test_b_recon_matches_host_reconstructor(name, goldens):
    """Pre-deblock planes of every B picture: the port's device B recon
    (with the host intra fill) equals jm_tpu's host Reconstructor."""
    for i, (j, p) in enumerate(_b_pictures(goldens(name))):
        for k, plane in enumerate("YUV"):
            assert np.array_equal(p["pre"][k], j["pre"][k]), \
                f"B picture {i} plane {plane}"


@pytest.mark.parametrize("name", B_GOLDENS)
def test_b_bs_and_deblock_match_host(name, goldens):
    """On jm_tpu's parsed B pictures: the port's compute_bs equals
    jm_tpu's host compute_bs, and the plain deblock of jm_tpu's pre-deblock
    planes with them equals deblock_picture's output."""
    for i, (j, p) in enumerate(_b_pictures(goldens(name))):
        jp = j["pic"]
        t = {k: torch.as_tensor(np.ascontiguousarray(getattr(jp, k)))
             for k in ("mb_class", "luma_nnz", "transform8x8", "mv", "mv_l1",
                       "ref_pic_id", "ref_pic_id_l1")}
        bs_v, bs_h = compute_bs(
            t["mb_class"], t["luma_nnz"], t["transform8x8"].to(torch.int32),
            t["mv"], t["mv_l1"], t["ref_pic_id"], t["ref_pic_id_l1"],
            jp.mb_w, jp.mb_h)
        want_v, want_h = jm_compute_bs(jp, jp.mb_w, jp.mb_h)
        assert np.array_equal(bs_v.numpy(), want_v), f"B picture {i} bs_v"
        assert np.array_equal(bs_h.numpy(), want_h), f"B picture {i} bs_h"
        (_bv, _bh, *rest), kw = p["args"]
        out = deblock(*(torch.from_numpy(x) for x in j["pre"]), bs_v, bs_h,
                      *rest, **kw)
        for k, plane in enumerate("YUV"):
            assert np.array_equal(out[k].numpy(), j["post"][k]), \
                f"B picture {i} plane {plane}"


PIC_FIELDS = MOTION + ("pdir", "b_direct", "b8_direct", "skip", "mb_class",
                       "cbp", "qp", "luma_coef", "chroma_dc", "chroma_coef",
                       "luma_nnz", "ref_pic_id", "ref_pic_id_l1")


@pytest.mark.parametrize("name", ["cavlc_b", "main9"])
def test_parsed_picture_data_matches_jm(name, goldens):
    """Every picture's parse (CAVLC cavlc_b, CABAC main9), field by field,
    B motion included. The decoders' reference uids count alike (every
    picture takes one), so ref_pic_id compares directly."""
    jm_recs, port_recs = goldens(name)
    for i, (j, p) in enumerate(zip(jm_recs, port_recs)):
        for k in PIC_FIELDS:
            assert np.array_equal(getattr(p["pic"], k),
                                  getattr(j["pic"], k)), \
                f"picture {i} ({SliceType(p['type']).name}) field {k}"


# ---- the B coder's motion search --------------------------------------

def _planes(rng, h, w):
    Y = rng.integers(0, 256, (h, w), dtype=np.uint8)
    U = rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8)
    V = rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8)
    return Y, U, V


@pytest.mark.parametrize("h,w,sr", [(48, 64, 16), (32, 48, 5), (16, 32, 1)])
def test_sad16_table_matches_jm(h, w, sr):
    rng = np.random.default_rng(h + sr)
    cur, ref = _planes(rng, h, w)[0], _planes(rng, h, w)[0]
    planes = JI.make_luma_planes(ref)
    want = JME.full_search_blk4_sads(cur, planes[0], w // 16, h // 16, sr,
                                     JI.PAD).sum(axis=2)
    st = prep_ref(*(torch.from_numpy(p) for p in (ref,) + _planes(
        rng, h, w)[1:]))
    got = full_search_sad16(torch.from_numpy(cur), st[0][0], w // 16,
                            h // 16, sr)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_downloaded_reference_state_matches_interp():
    """The B coder fetches from the downloaded device state: the same
    samples as jm_tpu's make_luma_planes and pad_plane."""
    rng = np.random.default_rng(3)
    Y, U, V = _planes(rng, 48, 64)
    planes, padU, padV = (t.numpy() for t in prep_ref(
        *(torch.from_numpy(p) for p in (Y, U, V))))
    for k, want in enumerate(JI.make_luma_planes(Y)):
        assert np.array_equal(planes[k], want)
    assert np.array_equal(padU, JI.pad_plane(U))
    assert np.array_equal(padV, JI.pad_plane(V))


def test_block_fetch_and_refine_match_jm():
    rng = np.random.default_rng(4)
    h, w = 48, 64
    Y, U, _V = _planes(rng, h, w)
    cur = _planes(rng, h, w)[0]
    jplanes = JI.make_luma_planes(Y)
    planes = np.stack(jplanes)
    padU = JI.pad_plane(U)
    for _ in range(300):
        bw, bh = (int(v) for v in rng.choice([2, 4, 8, 16], 2))
        x4, y4 = (int(v) for v in rng.integers(-200, 320, 2))
        assert np.array_equal(ME.mc_luma_block(planes, x4, y4, bw, bh, w, h),
                              JI.mc_luma_block(jplanes, x4, y4, bw, bh, w, h))
        x8, y8 = (int(v) for v in rng.integers(-400, 600, 2))
        assert np.array_equal(
            ME.mc_chroma_block(padU, x8, y8, 2, 2, w // 2, h // 2),
            JI.mc_chroma_block(padU, x8, y8, 2, 2, w // 2, h // 2))
    for _ in range(40):
        pred = rng.integers(-70, 71, 2).astype(np.int32)
        sr, lam = int(rng.integers(1, 17)), int(rng.integers(1, 30))
        assert np.array_equal(ME.int_rate_tab(pred, sr, lam),
                              JME.int_rate_tab(pred, sr, lam))
        rank = ME.spiral_rank_tab(pred, sr)
        assert np.array_equal(rank, JME.spiral_rank_tab(pred, sr))
        costs = rng.integers(0, 40, (2 * sr + 1) ** 2)
        assert np.array_equal(ME.best_int_mv_tiebreak(costs, rank, sr),
                              JME.best_int_mv_tiebreak(costs, rank, sr))
        px, py = int(rng.integers(0, 4)) * 16, int(rng.integers(0, 3)) * 16
        imv = rng.integers(-sr, sr + 1, 2).astype(np.int32)
        blk = cur[py:py + 16, px:px + 16]
        got = ME.subpel_refine(blk, planes, px, py, imv, w, h, pred, lam)
        want = JME.subpel_refine(blk, jplanes, px, py, imv, w, h, pred, lam,
                                 use_satd=True)
        assert np.array_equal(got[0], want[0]) and got[1] == want[1]
        assert ME.mv_bits(*pred) == JME.mv_bits(*pred)
