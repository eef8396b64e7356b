"""The port's weighted prediction in the decoder against jm_tpu's, on
the CPU (the codec is integer-exact: every tolerance is zero):
- decoder/wp.WPParams, explicit and implicit, field by field against
  jm_tpu's on the slices of the goldens wp_p (explicit P), wp_bi
  (implicit B, with B_Direct blocks and five references per list) and
  wp_both (explicit P and B), with the lists each decoder built;
- the weighted device stages ops/dec.inter_recon_p / inter_recon_b
  (with decoder/wp.block_tables) against jm_tpu's host WPParams.uni /
  .bi applied per 4x4 block, on seeded random motion, residuals and
  per-slice tables (several slices, logWD 0 and 7, negative weights and
  offsets, entries missing from a table, long-term references);
- the three goldens decoded equal to jm_tpu's H264Decoder and to JM
  ldecod's _rec.yuv (also cases of tests/test_torch_decoder.py), through
  the weighted device recon.
Without weighted prediction the stages give what they gave before (the
other decoder tests)."""

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from jm_tpu.common.types import PPS as JPPS
from jm_tpu.common.types import SliceHeader as JSliceHeader
from jm_tpu.common.types import SliceType as JSliceType
from jm_tpu.decoder import decoder as jm_decoder
from jm_tpu.decoder import wp as jm_wp
from jm_tpu_torch.common.picture import PictureData
from jm_tpu_torch.common.types import PPS, SliceHeader, SliceType
from jm_tpu_torch.decoder.decoder import H264Decoder
from jm_tpu_torch.decoder.wp import WPParams, block_tables
from jm_tpu_torch.ops import dec as D

GOLDEN = Path(__file__).parent / "golden"
WP_GOLDENS = ["wp_p", "wp_bi", "wp_both"]
FIELDS = ("mode", "luma_denom", "chroma_denom", "weight", "offset",
          "wbp_w0", "wbp_w1")


class _Recording(H264Decoder):
    """The port's decoder, keeping each picture's per-slice WPParams."""

    def __init__(self):
        super().__init__(device="cpu")
        self.wps = []

    def _finish_picture(self):
        if self._cur is not None:
            self.wps.append(list(self._cur["wps"]))
        super()._finish_picture()


@pytest.fixture(scope="module")
def decoded():
    """Per golden: the port's frames and per-picture WPParams, jm_tpu's
    frames and per-picture WPParams (jm_tpu builds one per picture)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    real = jm_wp.WPParams
    for name in WP_GOLDENS:
        data = (GOLDEN / f"{name}.264").read_bytes()
        dec = _Recording()
        frames = dec.decode_annexb(data)
        jm_wps = []

        class Rec(real):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                jm_wps.append(self)

        jm_wp.WPParams = Rec
        try:
            jm_frames = jm_decoder.H264Decoder(
                device_recon=True).decode_annexb(data)
        finally:
            jm_wp.WPParams = real
        out[name] = (frames, dec, jm_frames, jm_wps)
    torch.set_num_threads(n)
    return out


@pytest.mark.parametrize("name", WP_GOLDENS)
def test_golden_tables_match_jm(name, decoded):
    _frames, dec, _jm_frames, jm_wps = decoded[name]
    assert len(dec.wps) == len(jm_wps)
    modes = set()
    for wps, jwp in zip(dec.wps, jm_wps):
        # jm_tpu applies its first slice's tables to the whole picture;
        # the goldens' pictures are one slice each
        assert len(wps) == 1
        for k in FIELDS:
            if jwp.mode == 0 and k != "mode":
                continue
            assert np.array_equal(getattr(wps[0], k), getattr(jwp, k)), k
        modes.add(jwp.mode)
    assert modes == {"wp_p": {0, 1}, "wp_bi": {0, 2},
                     "wp_both": {0, 1}}[name]


@pytest.mark.parametrize("name", WP_GOLDENS)
def test_golden_decodes_like_jm_and_ldecod(name, decoded):
    frames, dec, jm_frames, _ = decoded[name]
    assert len(frames) == len(jm_frames) == 9
    for a, b in zip(frames, jm_frames):
        for p in "YUV":
            assert np.array_equal(getattr(a, p), getattr(b, p))
    rec = np.fromfile(GOLDEN / f"{name}_rec.yuv", np.uint8)
    cat = np.concatenate([np.concatenate([f.Y.ravel(), f.U.ravel(),
                                          f.V.ravel()])
                          for f in sorted(frames, key=lambda f: f.poc)])
    assert np.array_equal(cat, rec)
    assert {p["path"] for p in dec.pictures[1:]} <= {"inter", "mixed"}


# ---- the weighted device stages on random motion -------------------------

MB_W, MB_H, NREF = 4, 3, 3


def _table(rng, nent, denom):
    """A random explicit table of nent entries (weights and offsets of
    both signs; some entries at the default)."""
    out = []
    for _ in range(nent):
        if rng.random() < 0.25:
            e = {"luma": (1 << denom, 0),
                 "chroma": [[1 << denom, 0], [1 << denom, 0]]}
        else:
            e = {"luma": (int(rng.integers(-128, 128)),
                          int(rng.integers(-128, 128))),
                 "chroma": [[int(rng.integers(-128, 128)),
                             int(rng.integers(-128, 128))]
                            for _ in range(2)]}
        out.append(e)
    return out


# (luma, chroma) logWD of each of a picture's three slices
DENOMS = ((0, 7), (7, 0), (5, 3))


def _slice_params(rng, mode, slice_type, refs0, refs1, cur_poc, denoms):
    """(the port's WPParams, jm_tpu's WPParams) of one slice."""
    tabs = (_table(rng, len(refs0) - int(rng.integers(0, 2)), denoms[0]),
            _table(rng, len(refs1), denoms[0]))
    for t in tabs:            # chroma entries at the chroma denominator
        for e in t:
            if e["chroma"] == [[1 << denoms[0], 0]] * 2:
                e["chroma"] = [[1 << denoms[1], 0], [1 << denoms[1], 0]]
    kw = dict(luma_log2_weight_denom=denoms[0],
              chroma_log2_weight_denom=denoms[1], wp_l0=tabs[0],
              wp_l1=tabs[1] if slice_type == "B" else [])
    hdr = SliceHeader(slice_type=SliceType[slice_type], **kw)
    jhdr = JSliceHeader(slice_type=JSliceType[slice_type], **kw)
    pkw = (dict(weighted_pred_flag=1) if slice_type == "P"
           else dict(weighted_bipred_idc=mode))
    wp = WPParams(hdr, PPS(**pkw), refs0, refs1, cur_poc)
    jwp = jm_wp.WPParams(jhdr, JPPS(**pkw), refs0, refs1, cur_poc)
    for k in FIELDS:
        assert np.array_equal(getattr(wp, k), getattr(jwp, k)), k
    return wp, jwp


def _random_picture(rng, slice_type):
    n = MB_W * MB_H
    pic = PictureData(MB_W, MB_H)
    pic.slice_id[:] = np.sort(rng.integers(0, 3, n))
    pic.mv[:] = rng.integers(-40, 41, (n, 16, 2))
    pic.mv_l1[:] = rng.integers(-40, 41, (n, 16, 2))
    pic.ref_idx[:] = rng.integers(0, NREF, (n, 4))
    pic.ref_idx_l1[:] = rng.integers(0, NREF, (n, 4))
    if slice_type == "B":
        pic.pdir[:] = rng.integers(0, 3, (n, 4))
        pic.ref_idx[pic.pdir == 1] = -1
        pic.ref_idx_l1[pic.pdir == 0] = -1
    else:
        pic.pdir[:] = 0
        pic.ref_idx_l1[:] = -1
    return pic


def _reference(pic, jwps, p0, c0, p1, c1):
    """The weighted predictions as jm_tpu's host recon makes them:
    WPParams.uni / .bi of each 4x4 block's slice."""
    pred = np.zeros(p0.shape, np.int64)
    cpred = np.zeros(c0.shape, np.int64)
    for addr in range(pic.n_mbs):
        wp = jwps[pic.slice_id[addr]]
        for blk in range(16):
            q = (blk // 8) * 2 + (blk % 4) // 2
            pd = int(pic.pdir[addr, q])
            r0, r1 = int(pic.ref_idx[addr, q]), int(pic.ref_idx_l1[addr, q])
            for comp in range(3):
                a = p0[addr, blk] if comp == 0 else c0[addr, blk, comp - 1]
                if pd == 2:
                    b = p1[addr, blk] if comp == 0 \
                        else c1[addr, blk, comp - 1]
                    v = wp.bi(a, b, r0, r1, comp)
                elif pd == 1:
                    b = p1[addr, blk] if comp == 0 \
                        else c1[addr, blk, comp - 1]
                    v = wp.uni(b, 1, r1, comp)
                else:
                    v = wp.uni(a, 0, r0, comp)
                if comp == 0:
                    pred[addr, blk] = v
                else:
                    cpred[addr, blk, comp - 1] = v
    return torch.from_numpy(pred).to(torch.int32), \
        torch.from_numpy(cpred).to(torch.int32)


@pytest.mark.parametrize("kind,seed", [("P", 0), ("P", 1), ("B1", 2),
                                       ("B1", 3), ("B2", 4), ("B2", 5)])
def test_weighted_stage_matches_jm_host(kind, seed):
    """P (explicit), B1 (explicit) and B2 (implicit, with long-term and
    equal-POC references) pictures of three slices, each slice with its
    own tables and list orders, against jm_tpu's per-block WPParams."""
    rng = np.random.default_rng(seed)
    st = "P" if kind == "P" else "B"
    mode = 1 if kind != "B2" else 2
    pic = _random_picture(rng, st)
    n = pic.n_mbs
    h, w = 16 * MB_H, 16 * MB_W
    pad = D.PAD
    stack = torch.from_numpy(rng.integers(
        0, 256, (NREF, 4, h + 2 * pad, w + 2 * pad), dtype=np.uint8))
    cu = torch.from_numpy(rng.integers(
        0, 256, (NREF, h // 2 + 2 * pad, w // 2 + 2 * pad), dtype=np.uint8))
    cv = torch.from_numpy(rng.integers(
        0, 256, (NREF, h // 2 + 2 * pad, w // 2 + 2 * pad), dtype=np.uint8))
    wps, jwps = [], []
    for denoms in DENOMS:
        # each slice: its own list (POCs, long-term marks) and tables
        refs0 = [SimpleNamespace(poc=int(p), is_long_term=bool(lt))
                 for p, lt in zip(rng.permutation([-6, -4, -2])[:NREF],
                                  rng.random(NREF) < 0.2)]
        refs1 = [SimpleNamespace(poc=int(p), is_long_term=False)
                 for p in rng.permutation([4, 2, -4])[:NREF]]
        a, b = _slice_params(rng, mode, st, refs0, refs1, 0, denoms)
        wps.append(a)
        jwps.append(b)
    tabs = tuple(torch.from_numpy(t) for t in block_tables(wps, pic))
    mv, mv1 = torch.from_numpy(pic.mv), torch.from_numpy(pic.mv_l1)
    r0 = torch.from_numpy(pic.ref_idx.astype(np.int32))
    r1 = torch.from_numpy(pic.ref_idx_l1.astype(np.int32))
    res_l = torch.from_numpy(rng.integers(-60, 61, (n, 16, 4, 4),
                                          dtype=np.int32))
    res_c = torch.from_numpy(rng.integers(-60, 61, (n, 2, 4, 4, 4),
                                          dtype=np.int32))
    mask = torch.from_numpy(rng.random(n) < 0.9)
    kw = dict(mb_w=MB_W, mb_h=MB_H)
    p0, c0 = D._mc_pred(mv, r0, stack, cu, cv, **kw)
    p1, c1 = D._mc_pred(mv1, r1, stack, cu, cv, **kw)
    want = D._recon(*_reference(pic, jwps, p0.numpy(), c0.numpy(),
                                p1.numpy(), c1.numpy()),
                    res_l, res_c, mask, **kw)
    if st == "P":
        got = D.inter_recon_p(mv, r0, res_l, res_c, stack, cu, cv, mask,
                              wp=tabs, **kw)
    else:
        got = D.inter_recon_b(mv, mv1, r0, r1,
                              torch.from_numpy(pic.pdir.astype(np.int32)),
                              res_l, res_c, stack, cu, cv, mask, wp=tabs,
                              **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("st", ["P", "B"])
def test_identity_tables_give_the_default_prediction(st):
    """Slices without weighted prediction get identity tables: the
    weighted stage then equals the unweighted one, bi average included."""
    rng = np.random.default_rng(7)
    pic = _random_picture(rng, st)
    n = pic.n_mbs
    h, w = 16 * MB_H, 16 * MB_W
    pad = D.PAD
    stack = torch.from_numpy(rng.integers(
        0, 256, (NREF, 4, h + 2 * pad, w + 2 * pad), dtype=np.uint8))
    cu = torch.from_numpy(rng.integers(
        0, 256, (NREF, h // 2 + 2 * pad, w // 2 + 2 * pad), dtype=np.uint8))
    off = SimpleNamespace(mode=0)
    tabs = tuple(torch.from_numpy(t) for t in block_tables([off] * 3, pic))
    args = (torch.from_numpy(pic.mv), torch.from_numpy(pic.mv_l1),
            torch.from_numpy(pic.ref_idx.astype(np.int32)),
            torch.from_numpy(pic.ref_idx_l1.astype(np.int32)),
            torch.from_numpy(pic.pdir.astype(np.int32)))
    res_l = torch.zeros((n, 16, 4, 4), dtype=torch.int32)
    res_c = torch.zeros((n, 2, 4, 4, 4), dtype=torch.int32)
    mask = torch.ones(n, dtype=torch.bool)
    kw = dict(mb_w=MB_W, mb_h=MB_H)
    if st == "P":
        a = D.inter_recon_p(args[0], args[2], res_l, res_c, stack, cu, cu,
                            mask, wp=tabs, **kw)
        b = D.inter_recon_p(args[0], args[2], res_l, res_c, stack, cu, cu,
                            mask, **kw)
    else:
        a = D.inter_recon_b(*args, res_l, res_c, stack, cu, cu, mask,
                            wp=tabs, **kw)
        b = D.inter_recon_b(*args, res_l, res_c, stack, cu, cu, mask, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
