"""EPZS integer-pel motion search with HME pyramid predictors, the
port's numpy copy of jm_tpu/encoder/me_epzs.py (hme_sweep, EPZSearcher;
lencod me_epzs.c / me_epzs_common.c and me_hme.c:68). The host P coder
(encoder/p_host.py) and the B coder (encoder/b_host.py) search with it
when EncoderConfig.search_mode is 3, and with its UMHex subclasses
(encoder/me_umhex.py) when it is 1 or 2, in place of the device's full
search tables.

Per partition: a predictor set (the median, zero, the left / top /
top-right MBs' motion, the co-located motion of the reference scaled by
its distance, the HME MV, the reference-0 winner scaled), each costed as
SAD + lambda * mvd bits; the adaptive stop criterion of the neighbours'
best costs; then the extended diamond and small diamond until no point
improves. The SADs are memoized per (MB, reference), so that the
partition modes of a MB share them (computed by the native runtime,
EPZSearcher.native). The HME level is one float32 sweep
over the box-averaged planes. The copy is statement for statement:
EPZS's memo, stop criterion and float32 means must make jm_tpu's
choices.

A reference is any object with ``luma_planes`` (its quarter-pel planes,
the integer plane first, PAD samples of replicated border), ``motion``
(the coded picture's motion tuple, mv first, or None) and ``Y`` (its
deblocked luma): the encoder's Picture.
"""

from __future__ import annotations

import numpy as np

from .. import native as N
from ..ops.consts import PAD
from .me import mv_bits

# blocktype indexing follows the reference BLOCK_PARENT comment
# {skip,16x16,16x8,8x16,8x8,8x4,4x8,4x4} (me_epzs_common.c:33)
MIN_THRES_BASE = (0, 64, 32, 32, 16, 8, 8, 4)
MED_THRES_BASE = (0, 192, 96, 96, 48, 24, 24, 12)
MAX_THRES_BASE = (0, 768, 384, 384, 192, 96, 96, 48)
# configfile.h defaults: EPZSMinThresScale=0, EPZSMedThresScale=1,
# EPZSMaxThresScale=2 (configfile.h:429-431)
MIN_SCALE, MED_SCALE, MAX_SCALE = 0, 1, 2

# small diamond + extended points (EPZSPattern=2 "Extended Diamond" is
# the reference default, configfile.h:417)
_SDIAMOND = ((0, -1), (-1, 0), (1, 0), (0, 1))
_EDIAMOND = ((0, -2), (-2, 0), (2, 0), (0, 2),
             (-1, -1), (1, -1), (-1, 1), (1, 1))

_QUAD_OFF = ((0, 0), (8, 0), (0, 8), (8, 8))  # (dx, dy) of each 8x8 quadrant


def _blocktype(quads) -> int:
    if len(quads) == 4:
        return 1
    if len(quads) == 2:
        return 2 if quads in ((0, 1), (2, 3)) else 3
    return 4


def hme_sweep(orig: np.ndarray, ref: np.ndarray, mb_w: int, mb_h: int,
              sr: int, levels: int = 2) -> np.ndarray:
    """Hierarchical ME pyramid level (me_hme.c:68) as one batched sweep.

    Downsamples orig/ref by 2**levels (box mean), full-searches every
    downscaled MB block (16>>levels square) in a +-(sr>>levels + 2)
    window with tensor shifts, and returns (n_mbs, 2) integer MVs at
    FULL resolution scale. The reference's per-level refinement loop
    collapses into one vectorized displacement sweep per level.
    """
    f = 1 << levels
    bs = 16 >> levels
    h, w = mb_h * 16, mb_w * 16
    o = orig[:h, :w].astype(np.float32).reshape(
        mb_h * (16 // f), f, mb_w * (16 // f), f).mean(axis=(1, 3))
    rf = ref[:h, :w].astype(np.float32).reshape(
        mb_h * (16 // f), f, mb_w * (16 // f), f).mean(axis=(1, 3))
    srl = max(2, sr >> levels)
    pad = srl + 1
    rp = np.pad(rf, pad, mode="edge")
    n = mb_w * mb_h
    ob = o.reshape(mb_h, bs, mb_w, bs).transpose(0, 2, 1, 3).reshape(n, bs, bs)
    best = np.full(n, np.inf, np.float32)
    bmv = np.zeros((n, 2), np.int32)
    hh, ww = o.shape
    for dy in range(-srl, srl + 1):
        for dx in range(-srl, srl + 1):
            s = rp[pad + dy: pad + dy + hh, pad + dx: pad + dx + ww]
            sb = s.reshape(mb_h, bs, mb_w, bs).transpose(0, 2, 1, 3) \
                  .reshape(n, bs, bs)
            sad = np.abs(ob - sb).sum(axis=(1, 2))
            # mild zero-bias like the reference's mv-cost at the pyramid
            sad += 0.5 * (abs(dx) + abs(dy))
            m = sad < best
            best[m] = sad[m]
            bmv[m] = (dx, dy)
    return bmv * f


class EPZSearcher:
    """Per-frame EPZS integer-pel searcher over one reference list.

    One instance per (frame, list); `search` is called per (MB, ref,
    partition). Spatial predictors read the committed motion field
    `pic_mv` in raster order (left/top/top-right are final by the time a
    MB is searched — same availability contract as the reference's
    p_Vid->all_mv). Temporal predictors come from each reference frame's
    stored coding motion (`Frame.motion`), HME predictors from
    `hme_sweep`. ``native``: the quadrant SADs by the native runtime
    (jm_enc.cpp quad_sad); False: their numpy twin, the same sums.
    """

    native = True

    def __init__(self, origY: np.ndarray, refs: list, mb_w: int, mb_h: int,
                 sr: int, lam: int, pic_mv: np.ndarray,
                 use_hme: bool = True, temporal: bool = True):
        self.mb_w, self.mb_h, self.sr, self.lam = mb_w, mb_h, sr, lam
        self.refs = refs
        self.pic_mv = pic_mv
        n = mb_w * mb_h
        h, w = mb_h * 16, mb_w * 16
        self.orig_quads = origY[:h, :w].reshape(
            mb_h, 2, 8, mb_w, 2, 8).transpose(0, 3, 1, 4, 2, 5) \
            .reshape(n, 4, 8, 8).astype(np.int32)
        self.ref_pads = [f.luma_planes[0] for f in refs]
        self.temporal = [f.motion[0] if (temporal and f.motion is not None)
                         else None for f in refs]
        self.hme = [hme_sweep(origY, f.Y, mb_w, mb_h, sr) if use_hme
                    else None for f in refs]
        # prevSad store for the stop criterion (EPZSDetermineStopCriterion
        # reads the A/B/C neighbors' best costs)
        self.prev_sad = {bt: np.full((len(refs), n), np.iinfo(np.int64).max,
                                     np.int64) for bt in (1, 2, 3, 4)}
        self.n_evals = 0  # instrumentation (speed tests)
        # per-(addr, ref) cache of quadrant SADs at evaluated displacements
        # — the partition-mode loop probes the same positions for every
        # partition of the MB, the analog of me_fullfast's table reuse,
        # but only at EPZS-visited points
        self._cache_key = (-1, -1)
        self._cache: dict = {}

    # -- quadrant SADs (4,) at integer displacement (dx, dy), memoized
    def _qsad(self, addr: int, r: int, dx: int, dy: int) -> np.ndarray:
        if (addr, r) != self._cache_key:
            self._cache_key = (addr, r)
            self._cache = {}
        v = self._cache.get((dx, dy))
        if v is not None:
            return v
        rp = self.ref_pads[r]
        x = PAD + (addr % self.mb_w) * 16 + dx
        y = PAD + (addr // self.mb_w) * 16 + dy
        if (self.native and 0 <= x <= rp.shape[1] - 16
                and 0 <= y <= rp.shape[0] - 16):
            v = N.load().quad_sad(self.orig_quads[addr], rp, x, y)
        else:
            win = rp[y:y + 16, x:x + 16].astype(np.int32)
            # a window beyond the padding (search_range > PAD) is sliced
            # as jm_tpu slices it: wrapped, or cut short and refused
            if win.shape != (16, 16):
                raise ValueError(f"search range {self.sr}: the window at "
                                 f"({dx}, {dy}) exceeds the plane padding "
                                 f"{PAD}")
            # quadrant order matches _QUAD_OFF: q0 TL, q1 TR, q2 BL, q3 BR
            w4 = win.reshape(2, 8, 2, 8).transpose(0, 2, 1, 3).reshape(4, 8, 8)
            v = np.abs(self.orig_quads[addr] - w4).sum(axis=(1, 2))
        self._cache[(dx, dy)] = v
        self.n_evals += 1
        return v

    def _sad(self, addr: int, r: int, quads, dx: int, dy: int) -> int:
        v = self._qsad(addr, r, dx, dy)
        return int(sum(int(v[q]) for q in quads))

    def _predictors(self, addr: int, r: int, pred_mv, seed=None) -> list:
        """Candidate integer MVs: median, zero, spatial A/B/C, temporal
        colocated (distance-scaled, the EPZS motion-memory scaling of
        me_epzs_common.c EPZSSpatialMemPredictors), HME, and the ref-0
        search result scaled to this reference's distance."""
        mb_w = self.mb_w
        cands = [(int(round(pred_mv[0] / 4.0)), int(round(pred_mv[1] / 4.0))),
                 (0, 0)]
        mbx, mby = addr % mb_w, addr // mb_w
        mv = self.pic_mv
        if mbx > 0:                       # A: left MB, right quadrants
            cands.append(tuple(mv[addr - 1, 1] // 4))
        if mby > 0:                       # B: top MB, bottom quadrants
            cands.append(tuple(mv[addr - mb_w, 2] // 4))
            if mbx + 1 < mb_w:            # C: top-right MB
                cands.append(tuple(mv[addr - mb_w + 1, 2] // 4))
        tmp = self.temporal[0] if self.temporal else None
        if tmp is not None:               # colocated MVs scaled by distance
            for q in (0, 3):
                cands.append(tuple((r + 1) * tmp[addr, q] // 4))
        hme = self.hme[r]
        if hme is not None:
            cands.append(tuple(hme[addr]))
        if seed is not None:              # ref-0 winner scaled to ref r
            cands.append(((r + 1) * int(seed[0]), (r + 1) * int(seed[1])))
        sr = self.sr
        out, seen = [], set()
        for (cx, cy) in cands:
            c = (max(-sr, min(sr, int(cx))), max(-sr, min(sr, int(cy))))
            if c not in seen:
                seen.add(c)
                out.append(c)
        return out

    def _stop_criterion(self, addr: int, r: int, bt: int) -> int:
        """EPZSDetermineStopCriterion (me_epzs_common.c:1873) with the
        default threshold scales."""
        mb_w = self.mb_w
        ps = self.prev_sad[bt][r]
        big = np.iinfo(np.int64).max
        mbx, mby = addr % mb_w, addr // mb_w
        sa = ps[addr - 1] if mbx > 0 else big
        sb = ps[addr - mb_w] if mby > 0 else big
        sc = ps[addr - mb_w + 1] if (mby > 0 and mbx + 1 < mb_w) else big
        lam_dist = self.lam
        med = MED_SCALE * MED_THRES_BASE[bt]
        mn = MIN_SCALE * MIN_THRES_BASE[bt]
        mx = MAX_SCALE * MAX_THRES_BASE[bt]
        stop = min(sa, sb, sc)
        stop = max(stop, mn)
        stop = min(stop, mx + lam_dist)
        stop = (8 * max(med + lam_dist, stop) + med) >> 3
        return stop + lam_dist

    def search(self, addr: int, r: int, quads, pred_mv,
               seed=None) -> np.ndarray:
        """Integer-pel EPZS for one partition; returns mv (2,) int32.

        Cost = SAD + lambda * bits(mvd) (the reference's mcost), so
        predictors are favoured exactly as in mv_search.c.
        """
        sr, lam = self.sr, self.lam
        bt = _blocktype(tuple(quads))

        def mcost(dx, dy):
            return (self._sad(addr, r, quads, dx, dy)
                    + lam * mv_bits(4 * dx - int(pred_mv[0]),
                                    4 * dy - int(pred_mv[1])))

        best_mv, best_c = None, None
        for (dx, dy) in self._predictors(addr, r, pred_mv, seed):
            c = mcost(dx, dy)
            if best_c is None or c < best_c:
                best_mv, best_c = (dx, dy), c

        stop = self._stop_criterion(addr, r, bt)
        if best_c >= stop:
            # pattern refinement: extended diamond until converged, then
            # a final small-diamond polish (EPZSPattern=2 default)
            tried = {best_mv}
            for pattern in (_EDIAMOND, _SDIAMOND):
                improved = True
                iters = 0
                while improved and iters < 2 * sr:
                    improved = False
                    iters += 1
                    cx, cy = best_mv
                    for (ox, oy) in pattern:
                        mvc = (cx + ox, cy + oy)
                        if (mvc in tried or abs(mvc[0]) > sr
                                or abs(mvc[1]) > sr):
                            continue
                        tried.add(mvc)
                        c = mcost(*mvc)
                        if c < best_c:
                            best_mv, best_c = mvc, c
                            improved = True
        if bt in self.prev_sad:
            self.prev_sad[bt][r, addr] = best_c
        return np.array(best_mv, np.int32)
