"""The serial host P macroblock coder of the port: twin of
jm_tpu/encoder/encoder.py _FrameEncoder._encode_p_mb (:2706-2878) in its
full-search branch, with _commit_inter_p (:3019-3113) and its
_code_luma_inter, for 4:2:0 frame pictures with one reference, no
sub-8x8 partitions, no RD tier and no I_PCM, flat quant or the custom
quant of encoder/qmatrix.QuantCtx, the 4x4 or the adaptive 8x8
transform. jm_tpu codes every P picture this way whose pipeline is
"host", or whose coding its device path does not cover (weighted
prediction, custom quant, the 8x8 transform), and so does the port.

Per MB, in slice order:
  - an MB of the intra refresh set is coded Intra16x16 with its chroma;
  - else, for each partition mode (16x16, 16x8, 8x16, 8x8) and each of
    its partitions: the MV predictor (seeing the mode's earlier
    partitions, committed provisionally), the integer MV of least SAD +
    lambda-weighted mvd bits over the quadrant SAD table made on the
    device (ops/enc.full_search_sad_quad) with the spiral tie-break, then
    the half- / quarter-pel SATD refinement on the unweighted reference;
    the mode of least total cost (lambda times its mb_type bits added);
  - P_Skip's prediction, weighted, replaces it when its SAD is not above
    it; Intra16x16 replaces both when its SAD + 2 lambda_mode4 is below;
then the prediction of each 4x4 block (quarter-pel luma, eighth-pel
chroma), weighted by the slice's explicit table (decoder/wp.WPParams),
the inter residual and the recon (encoder/b_host.InterMBCoder). As in
jm_tpu, the motion search ignores the weights: only the skip cost and
the coded prediction are weighted.
"""

from __future__ import annotations

import time

import numpy as np

from ..common.picture import MB_INTER
from . import me as ME
from .b_host import HostRef, InterMBCoder

# partition mode -> [(bx, by, bw, bh, quadrants)] in 4x4-block units
PART_TABLE = {
    0: [(0, 0, 4, 4, (0, 1, 2, 3))],
    1: [(0, 0, 4, 2, (0, 1)), (0, 2, 4, 2, (2, 3))],
    2: [(0, 0, 2, 4, (0, 2)), (2, 0, 2, 4, (1, 3))],
    3: [(0, 0, 2, 2, (0,)), (2, 0, 2, 2, (1,)),
        (0, 2, 2, 2, (2,)), (2, 2, 2, 2, (3,))],
}
# the rate term of each mode in the decision, in lambdas
MODE_BITS = {0: 1, 1: 3, 2: 3, 3: 5 + 4}
_MIX = ("skip", "p16x16", "p16x8", "p8x16", "p8x8", "i16", "t8")


class PPicture(InterMBCoder):
    """One P picture coded MB by MB on the host: ``pic`` (PictureData)
    and the undeblocked recon planes recY / recU / recV (numpy uint8).
    ``mix`` counts the MBs by decision (skip, p16x16, p16x8, p8x16,
    p8x8, i16: intra, forced or chosen; t8: the inter MBs coded with the
    8x8 transform); ``part_s`` the wall seconds of
    the MB loop's parts: the partition-mode search, the skip candidate,
    the intra evaluation and coding, the inter commit."""

    def __init__(self, orig, qp: int, qpc: int, lam: int, lam4: int,
                 ref: HostRef, sads, slices, sr: int, forced=(), wp=None,
                 transform8x8=False, qctx=None, ar_period: int = 0):
        """orig: the source (Y, U, V) uint8 planes; lam / lam4:
        lambda_me and lambda_mode4 of qp; ref: list0[0]; sads: the
        (N, (2 sr + 1)^2, 4) quadrant integer search table against it;
        slices: the slice plan, MB address lists in decode order; forced:
        the MBs of the intra refresh; wp: the slice's weighted prediction
        (decoder/wp.WPParams) or None; transform8x8, qctx, ar_period: the
        adaptive 8x8 transform and the custom quant (InterMBCoder,
        IntraMBCoder)."""
        self._init_picture(orig, qp, qpc)
        self.lam, self.lam4, self.wp = lam, lam4, wp
        self.transform8x8 = transform8x8
        self.qctx, self.ar_period = qctx, ar_period
        self.ref, self.sads, self.sr = ref, sads, sr
        self.forced = set(forced)
        self.h, self.w = self.origY.shape
        self.recY = np.zeros_like(self.origY)
        self.recU = np.zeros_like(self.origU)
        self.recV = np.zeros_like(self.origV)
        self.mix = dict.fromkeys(_MIX, 0)
        self.part_s = dict.fromkeys(("search", "skip", "intra", "commit"),
                                    0.0)
        self._code_slices(slices, qp, self._encode_p_mb)

    def _intra16(self, addr, origY_mb, mode16, pred16) -> None:
        pic = self.pic
        pic.ref_idx[addr] = -1
        cbp_luma = self._encode_i16(addr, origY_mb, mode16, pred16)
        pic.cbp[addr] = (self._encode_chroma_intra(addr) << 4) | cbp_luma
        self.mix["i16"] += 1

    def _encode_p_mb(self, addr: int) -> None:
        pic, lam, sr = self.pic, self.lam, self.sr
        px, py = (addr % self.mb_w) * 16, (addr // self.mb_w) * 16
        origY_mb = self._mb_orig(addr)[0]
        t0 = time.perf_counter()
        if addr in self.forced:            # intra refresh
            self._intra16(addr, origY_mb, *self._eval_i16(addr,
                                                          origY_mb)[1:])
            self.part_s["intra"] += time.perf_counter() - t0
            return
        o = origY_mb.astype(np.int32)

        # the partition modes over the quadrant table; each partition's
        # predictor sees the mode's earlier partitions (provisional
        # commits), as the reference's PartitionMotionSearch
        candidates = {}
        for mode, parts in PART_TABLE.items():
            total = lam * MODE_BITS[mode]
            commit = []
            pic.mv[addr] = 0
            pic.ref_idx[addr] = -1
            for (bx, by, bw, bh, quads) in parts:
                blk = self.origY[py + by * 4:py + by * 4 + bh * 4,
                                 px + bx * 4:px + bx * 4 + bw * 4]
                pred = self.pctx.mv_pred(addr, bx, by, bw, bh, 0)
                csum = (self.sads[addr][:, list(quads)]
                        .sum(axis=1, dtype=np.int64)
                        + ME.int_rate_tab(pred, sr, lam))
                imv0 = ME.best_int_mv_tiebreak(
                    csum, ME.spiral_rank_tab(pred, sr), sr)
                qmv, cost = ME.subpel_refine(
                    blk, self.ref.planes, px + bx * 4, py + by * 4, imv0,
                    self.w, self.h, pred, lam)
                total += cost
                commit.append((bx, by, bw, bh, quads, qmv))
                for yy in range(by, by + bh):
                    for xx in range(bx, bx + bw):
                        pic.mv[addr, yy * 4 + xx] = qmv
                for q in quads:
                    pic.ref_idx[addr, q] = 0
            candidates[mode] = (total, commit)
        pic.mv[addr] = 0
        pic.ref_idx[addr] = -1
        t1 = time.perf_counter()
        self.part_s["search"] += t1 - t0
        skip_mv = self.pctx.skip_mv(addr)
        best_mode = min(candidates, key=lambda m: candidates[m][0])
        cost_inter, commit = candidates[best_mode]

        # the skip candidate: 16x16, reference 0, the predicted MV, no bits
        skip_pred = ME.mc_luma_block(
            self.ref.planes, px * 4 + int(skip_mv[0]),
            py * 4 + int(skip_mv[1]), 16, 16, self.w, self.h)
        if self.wp is not None:
            skip_pred = self.wp.uni(skip_pred, 0, 0, 0)
        cost_skip = int(np.abs(o - skip_pred).sum())
        if cost_skip <= cost_inter:
            best_mode, cost_inter = 0, cost_skip
            commit = [(0, 0, 4, 4, (0, 1, 2, 3), skip_mv.copy())]
        t2 = time.perf_counter()
        self.part_s["skip"] += t2 - t1

        # the intra-16 fallback (scene changes, uncovered areas)
        cost16, mode16, pred16 = self._eval_i16(addr, origY_mb)
        if cost16 + 2 * self.lam4 < cost_inter:
            self._intra16(addr, origY_mb, mode16, pred16)
            self.part_s["intra"] += time.perf_counter() - t2
            return
        t3 = time.perf_counter()
        self.part_s["intra"] += t3 - t2
        self._commit_inter(addr, best_mode, commit, skip_mv, o)
        self.part_s["commit"] += time.perf_counter() - t3

    def _commit_inter(self, addr, mode, commit, skip_mv, o) -> None:
        """Commit the chosen motion, predict (weighted), code the
        residual; P_Skip when the 16x16 coding is the skip coding."""
        pic = self.pic
        px, py = (addr % self.mb_w) * 16, (addr // self.mb_w) * 16
        pic.mb_class[addr] = MB_INTER
        pic.inter_mode[addr] = mode
        for (bx, by, bw, bh, quads, qmv) in commit:
            for yy in range(by, by + bh):
                for xx in range(bx, bx + bw):
                    pic.mv[addr, yy * 4 + xx] = qmv
            for q in quads:
                pic.ref_idx[addr, q] = 0
                pic.ref_pic_id[addr, q] = self.ref.uid
                pic.pdir[addr, q] = 0
        pred_y = np.zeros((16, 16), np.int64)
        pred_u = np.zeros((8, 8), np.int64)
        pred_v = np.zeros((8, 8), np.int64)
        for blk in range(16):
            by, bx = divmod(blk, 4)
            p = self._mc_blk(self.ref, px, py, bx, by, pic.mv[addr, blk])
            if self.wp is not None:
                p = [self.wp.uni(b, 0, 0, c) for c, b in enumerate(p)]
            pred_y[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = p[0]
            pred_u[by * 2:by * 2 + 2, bx * 2:bx * 2 + 2] = p[1]
            pred_v[by * 2:by * 2 + 2, bx * 2:bx * 2 + 2] = p[2]
        self._commit_inter_residual(addr, o, pred_y, pred_u, pred_v)
        if (mode == 0 and pic.cbp[addr] == 0
                and (pic.mv[addr, 0] == skip_mv).all()):
            pic.skip[addr] = True
        self.mix["skip" if pic.skip[addr] else _MIX[1 + mode]] += 1
        self.mix["t8"] += int(pic.transform8x8[addr])
